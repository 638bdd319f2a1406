#!/usr/bin/env python3
"""Which ops of an xLSTM decode step round a row differently in a batch of
2 than in a batch of 4, on one GPU.

Builds xlstm-350m at its published widths (bf16, seed 0), then for each op
of the mLSTM and sLSTM decode steps (the projections, the conv, the gate
projections, the readout ``q @ C``, the normaliser ``q · n``, the sLSTM
recurrence ``h @ r``, the norms, the unembedding) and for whole layers
(apply and backfill, their output and every cache leaf), compares rows 2:4
of a 4-row call with a 2-row call on the same rows, bit for bit.  Prints
one JSON object {op: equal}.  A False is why the major layout steps the
ssm family per cohort in every branch (``core/exec.py:_dispatch``).

Run from the root of a checkout: ``python3
scripts/probe_xlstm_batch_rounding.py``.  Needs one CUDA card.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ops import rmsnorm_fused  # noqa: E402
from repro_torch.models import blocks, nn, xlstm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_xlstm_batch_rounding: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("xlstm-350m")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    d, d_inner, h, p = cfg.d_model, *xlstm.mlstm_dims(cfg)
    report = {}

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def same(name, f):
        """f(lo, hi) -> (hi - lo, ...) for rows lo:hi: rows 2:4 of the
        4-row call against the 2-row call."""
        report[name] = bool(torch.equal(f(0, 4)[2:4], f(2, 4)))

    mp = nn.tree_index(params["segments"][0][0], 0)["mlstm"]
    sp = nn.tree_index(params["segments"][0][1], 0)["slstm"]
    x = rand(4, 1, d, dtype=bf)
    c = rand(4, d_inner, dtype=bf)
    win = rand(4, xlstm.CONV_W, d_inner)
    q, n = rand(4, h, p), rand(4, h, p)
    C = rand(4, h, p, p)
    hid = rand(4, d_inner, dtype=bf)
    hh = rand(4, cfg.n_heads, d // cfg.n_heads)
    up = rand(4, 1, (4 * d) // 3, dtype=bf)
    r32 = sp["r"].float()
    same("up_proj", lambda lo, hi: x[lo:hi, 0] @ mp["up_proj"])
    same("wq", lambda lo, hi: c[lo:hi] @ mp["wq"])
    same("w_i (f32)", lambda lo, hi: c[lo:hi].float() @ mp["w_i"].float())
    same("conv taps sum", lambda lo, hi: (win[lo:hi]
                                          * mp["conv_w"].float()).sum(1))
    same("readout q @ C", lambda lo, hi: (q[lo:hi, :, None, :]
                                          @ C[lo:hi])[:, :, 0])
    same("normaliser q . n", lambda lo, hi: (q[lo:hi] * n[lo:hi]).sum(-1))
    same("out norm (plain)", lambda lo, hi: xlstm.rmsnorm(
        hid[lo:hi], mp["out_norm_w"].to(bf), cfg.norm_eps))
    same("down_proj", lambda lo, hi: hid[lo:hi] @ mp["down_proj"])
    same("sLSTM h @ r", lambda lo, hi: (
        hh[lo:hi].transpose(0, 1)[None] @ r32).transpose(1, 2))
    same("w_in", lambda lo, hi: x[lo:hi, 0] @ sp["w_in"])
    same("w_up", lambda lo, hi: x[lo:hi] @ sp["w_up"])
    same("w_dn", lambda lo, hi: up[lo:hi] @ sp["w_dn"])
    same("lm_head", lambda lo, hi: x[lo:hi, 0] @ params["lm_head"])
    same("pre-norm (kernel)", lambda lo, hi: rmsnorm_fused(
        x[lo:hi], mp["norm"]["w"], eps=cfg.norm_eps))
    ctx = {"mode": "decode"}
    for kind, pi in (("mlstm", 0), ("slstm", 1)):
        stp = nn.tree_index(params["segments"][0][pi], 0)
        cache = nn.tree_map(lambda t: t[0].clone(),
                            model.init_cache(4, 1)["segments"][0][pi])
        for t in nn.tree_leaves(cache):
            t.copy_(rand(*t.shape).abs().mul(0.5).to(t.dtype))
        hx = rand(4, 1, d, dtype=bf)
        block = blocks.BLOCKS[kind]

        def layer(lo, hi, fn, out):
            cc = nn.tree_map(lambda t: t[lo:hi].clone(), cache)
            y = fn(cfg, stp, hx[lo:hi], ctx, cc)
            if out:
                return y[0]
            return torch.cat([t.reshape(hi - lo, -1).float()
                              for t in nn.tree_leaves(cc)], dim=1)

        same(f"{kind} layer output",
             lambda lo, hi: layer(lo, hi, block.apply, True))
        same(f"{kind} layer cache",
             lambda lo, hi: layer(lo, hi, block.apply, False))
        same(f"{kind} backfill cache", lambda lo, hi: layer(
            lo, hi, lambda *a: (block.backfill(*a),), False))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "equal": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
