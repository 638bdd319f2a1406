"""The redesigned attention kernels' arithmetic, pinned on the CPU.

Neither kernel runs here (no card), so their arithmetic is emulated in
plain torch and held against the JAX package's Pallas kernels (in
interpret mode, as ``tests/test_kernels.py`` runs them) on the same numpy
inputs:

- ``decode_attention``'s split-KV: ``ref.ref_decode_attention_split``
  (per-chunk partials, empty chunks skipped, the fixed-order merge) against
  ``repro.kernels.ops.decode_attention_cache`` and the plain
  ``ref.ref_decode_attention``, at 1e-5 in f32 (the three sum in other
  orders; the error is a few f32 ulps);
- ``flash_attention``'s wgmma route: bf16 Q K^T accumulated in f32, the f32
  online softmax over 64-key tiles (the kernel takes it in base 2 with
  exp2f, a few f32 ulps from torch.exp, far below the bf16 bound), P
  rounded to bf16 before P V, against
  ``repro.kernels.ops.flash_attention_bshd`` on the same bf16 inputs,
  within ``chip_smoke.py``'s bf16 tolerance (2e-2 abs, 1e-2 rel);
- the wrapper's choice of flash route, which depends only on the dtype,
  hd, the causal flag and the views' alignment, so CPU tensors show it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as dattn
from repro_torch.kernels import flash_attention as fattn
from repro_torch.kernels import ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_TOL = (2e-2, 1e-2)   # chip_smoke.TOL["bfloat16"]


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _ring(t, W):
    s = np.arange(W)
    return np.where(s <= t, t - ((t - s) % W), -1).astype(np.int32)


# ---------------------------------------------------------------------------
# decode attention: the split-KV emulator
# ---------------------------------------------------------------------------

# (t, window, chunk, live, kpos form); W = 64
DECODE_CASES = {
    "chunk_not_dividing_W": (150, 0, 24, [1, 1, 1], "lane"),
    "partly_filled_ring_empty_chunks": (20, 0, 16, [1, 1, 1], "lane"),
    "window_over_the_wrap": (150, 24, 16, [1, 1, 1], "lane"),
    "per_slot_kpos": (90, 16, 32, [1, 1, 1], "per_slot"),
    "live_slot_without_visible_key": (40, 0, 16, [1, 1, 1], "empty_slot"),
    "dead_slots": (150, 0, 16, [0, 1, 0], "lane"),
}


def _decode_inputs(t, form, seed=5):
    rng = np.random.default_rng(seed)
    B, H, KV, hd, W = 3, 4, 2, 32, 64
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    kpos = _ring(t, W)
    if form != "lane":
        kpos = np.stack([np.maximum(kpos - 3 * b, -1) for b in range(B)])
        if form == "empty_slot":
            kpos[1] = -1
    return q, kc, vc, kpos.astype(np.int32)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_split_emulator_matches_pallas_and_plain(case):
    t, window, chunk, live, form = DECODE_CASES[case]
    q, kc, vc, kpos = _decode_inputs(t, form)
    lv = np.array(live, bool)
    want = np.asarray(jops.decode_attention_cache(
        jnp.asarray(q[:, None]), jnp.asarray(kc), jnp.asarray(vc), t,
        jnp.asarray(kpos), window=window, live=jnp.asarray(lv)))[:, 0]
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, kc, vc, kpos))
    tl = torch.from_numpy(lv)
    got = ref.ref_decode_attention_split(tq, tk, tv, t, tp, tl,
                                         window=window, chunk=chunk)
    plain = ref.ref_decode_attention(tq, tk, tv, t, tp, window=window,
                                     live=tl)
    assert got.shape == q.shape
    _close(got, want)
    _close(got, plain)
    assert not got[~tl].any()     # dead rows: exact zeros


def test_split_emulator_skips_empty_chunks_exactly():
    """A chunk with no visible key adds exp(-1e30 - M) * 0 = 0 to the
    merge: at a partly filled ring the result is the same whether the
    empty chunks are there or the cache is cut to its visible prefix."""
    t, W = 20, 64
    q, kc, vc, kpos = _decode_inputs(t, "lane")
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, kc, vc, kpos))
    full = ref.ref_decode_attention_split(tq, tk, tv, t, tp, chunk=16)
    cut = ref.ref_decode_attention_split(tq, tk[:, :32], tv[:, :32], t,
                                         tp[:32], chunk=16)
    assert torch.equal(full, cut)


def test_split_emulator_repeats_its_bits():
    t, window, chunk, live, form = DECODE_CASES["per_slot_kpos"]
    q, kc, vc, kpos = _decode_inputs(t, form)
    args = [torch.from_numpy(x) for x in (q, kc, vc)]
    runs = [ref.ref_decode_attention_split(
        *args, t, torch.from_numpy(kpos), torch.tensor(live, dtype=bool),
        window=window, chunk=chunk) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("W", [1, 31, 32, 64, 100, 500, 512, 513, 4096])
def test_split_plan_covers_W_in_at_most_16_chunks(W):
    chunk, n = dattn.split_plan(W)
    assert chunk % dattn.TILE == 0 and 1 <= n <= dattn.MAX_SPLITS
    assert (n - 1) * chunk < W <= n * chunk
    if W <= 512:     # the serving path's W = 512: 16 chunks of 32 keys
        assert chunk == dattn.TILE


def test_split_emulator_at_the_kernels_plan_matches_plain():
    """The emulator at the split the wrapper picks for the serving W."""
    rng = np.random.default_rng(11)
    B, H, KV, hd, W, t = 2, 16, 2, 128, 512, 700
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, H, hd), (B, W, KV, hd), (B, W, KV, hd)))
    kpos = torch.from_numpy(_ring(t, W))
    chunk, _ = dattn.split_plan(W)
    _close(ref.ref_decode_attention_split(q, kc, vc, t, kpos, chunk=chunk),
           ref.ref_decode_attention(q, kc, vc, t, kpos))


# ---------------------------------------------------------------------------
# flash attention: the wgmma route's bf16 arithmetic
# ---------------------------------------------------------------------------

def emulate_wgmma_flash(q, k, v, *, causal=True, window=0, tile=64,
                        round_p=True):
    """The wgmma route's arithmetic on (B, H, S, hd) bf16 q and (B, KV, S,
    hd) k, v: per 64-row query tile, the key tiles of the causal/window
    band in order; S = Q K^T of bf16 values summed in f32, scaled, masked
    to -1e30; the f32 online softmax (the row sum over f32 P); P rounded
    to bf16 (``round_p``) before O += P V in f32; out = acc / max(l,
    1e-30), in q's dtype."""
    B, H, S, hd = q.shape
    qpk = H // k.shape[1]
    kk = k.float().repeat_interleave(qpk, 1)
    vv = v.float().repeat_interleave(qpk, 1)
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(S)
    out = torch.empty(B, H, S, hd)
    for q0 in range(0, S, tile):
        qt = q[:, :, q0:q0 + tile].float()
        m = torch.full((B, H, tile), -1e30)
        l = torch.zeros(B, H, tile)
        acc = torch.zeros(B, H, tile, hd)
        first = q0 - window + 1
        lo = first // tile if window and first > 0 else 0
        hi = q0 // tile + 1 if causal else S // tile
        for kt in range(lo, hi):
            k0 = kt * tile
            s = (qt @ kk[:, :, k0:k0 + tile].transpose(-1, -2)) * scale
            qp, kp = pos[q0:q0 + tile, None], pos[None, k0:k0 + tile]
            ok = torch.ones(tile, tile, dtype=torch.bool)
            if causal:
                ok &= kp <= qp
            if window:
                ok &= kp > qp - window
            s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            if round_p:
                p = p.bfloat16().float()
            acc = acc * corr[..., None] + p @ vv[:, :, k0:k0 + tile]
            m = m_new
        out[:, :, q0:q0 + tile] = acc / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("window", [0, 64])
def test_wgmma_flash_numerics_within_bf16_tolerance(S, window):
    """The wgmma route rounds P to bf16 before the second product where
    the JAX kernel keeps f32; on the same bf16 inputs the two stay within
    chip_smoke.py's bf16 tolerance.  Observed (seed 7, B 1, H 4 / KV 2, hd
    64, at every S and window here): max abs error 0.0078125, one bf16
    ulp at |out| in [1, 2), 0.018 inside the bound at its tightest."""
    rng = np.random.default_rng(7)
    B, H, KV, hd = 1, 4, 2, 64
    q, k, v = (jnp.asarray(rng.standard_normal((B, S, n, hd)), jnp.bfloat16)
               for n in (H, KV, KV))
    want = np.asarray(jops.flash_attention_bshd(
        q, k, v, causal=True, window=window).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(x.astype(jnp.float32)).copy())
                  .bfloat16().transpose(1, 2) for x in (q, k, v))
    got = emulate_wgmma_flash(tq, tk, tv, window=window).transpose(1, 2)
    _close(got.float(), want, *BF16_TOL)
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -7


@pytest.mark.parametrize("window", [0, 64])
def test_wgmma_flash_tiling_is_exact_without_the_rounding(window):
    """With P kept in f32 the emulated tiles (the band's skips, the masks,
    the online softmax) give the plain version's f32 result: P's rounding
    is the route's only departure from it."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 256, 32))
                                .astype(np.float32)) for n in (4, 2, 2))
    got = emulate_wgmma_flash(q, k, v, window=window, round_p=False)
    _close(got, ref.ref_flash_attention(q, k, v, window=window))


# ---------------------------------------------------------------------------
# flash attention: the route picked before the launch
# ---------------------------------------------------------------------------

def _model_views(dtype, B=2, S=128, H=4, KV=2, hd=128):
    """q, k, v as the model hands them over: (B, S, heads, hd) tensors
    seen as (B, heads, S, hd)."""
    return [torch.zeros(B, S, n, hd, dtype=dtype).transpose(1, 2)
            for n in (H, KV, KV)]


# the wgmma route takes causal attention at the model's hd = 128 in bf16 /
# fp16; f32, hd = 64 and non-causal calls take the CUDA-core route
@pytest.mark.parametrize("dtype,hd,causal,want", [
    (torch.bfloat16, 128, True, "wgmma"),
    (torch.float16, 128, True, "wgmma"),
    (torch.float32, 128, True, "cuda_core"),
    (torch.bfloat16, 64, True, "cuda_core"),
    (torch.bfloat16, 128, False, "cuda_core")])
def test_flash_route_follows_the_dtype(dtype, hd, causal, want):
    assert fattn.route(*_model_views(dtype, hd=hd), causal) == want


def test_flash_route_refuses_views_tma_cannot_address():
    q, k, v = _model_views(torch.bfloat16)
    # one element off a 16-byte boundary: the base is not addressable
    off = torch.zeros(2, 128, 4, 129, dtype=torch.bfloat16)[..., 1:]
    assert fattn.route(off.transpose(1, 2), k, v) == "cuda_core"
    # a row stride of 130 elements (260 bytes) is not a multiple of 16
    pitch = torch.zeros(2, 128, 2, 130, dtype=torch.bfloat16)[..., :128]
    assert fattn.route(q, pitch.transpose(1, 2), v) == "cuda_core"
    # a dim of length 1 is never stepped: its stride does not matter
    one = torch.zeros(1, 128, 2, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert fattn.route(q[:1], one, one) == "wgmma"


def test_flash_route_counters_reset_with_the_launch_count():
    from repro_torch import kernels
    fn = fattn.flash_attention
    fn.launches_by_route["wgmma"] += 3
    fn.launches += 3
    kernels.reset_launch_counts()
    assert fn.launches == 0
    assert fn.launches_by_route == dict.fromkeys(fattn.ROUTES, 0)
    # CPU tensors take the plain version: no route launches
    q, k, v = _model_views(torch.float32)
    fn(q, k, v)
    assert fn.launches_by_route == dict.fromkeys(fattn.ROUTES, 0)
