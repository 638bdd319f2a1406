"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs (``np.random.default_rng``) go through the reference
wrapper in ``repro.kernels.ops`` (the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them on the CPU) and through the port's
``repro_torch.kernels.ops`` on CPU tensors (each kernel's plain version).

Tolerances, all f32: 1e-5 absolute and relative for normalised
activations, attention outputs and confidences (the two sides sum in other
orders; the error is a few f32 ulps); integers (argmax, exit index, streak,
telemetry code, answered) exactly.  On a CUDA card the ``cuda``-marked
test runs every kernel against its plain version at the serving shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import layers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = RTOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 256), (2, 3, 256), (1, 2048)])
def test_rmsnorm_fused_matches_reference(shape):
    rng = _rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jops.rmsnorm_fused(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    got = ops.rmsnorm_fused(torch.from_numpy(x), torch.from_numpy(w),
                            eps=1e-5)
    assert got.shape == shape and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_norm_apply_both_routes_match_reference(use_kernels):
    rng = _rng(2)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b")).replace(
        use_kernels=use_kernels)
    cfg = reduced(get_config("qwen2.5-3b")).replace(use_kernels=use_kernels)
    want = jlayers.norm_apply({"w": jnp.asarray(w)}, jcfg, jnp.asarray(x))
    got = layers.norm_apply({"w": torch.from_numpy(w)}, cfg,
                            torch.from_numpy(x))
    _close(got, want)


def test_norm_routes_round_differently_in_bf16():
    """The kernel route scales by w in f32 before its one cast; the plain
    route casts first — the port keeps both, each as its reference does."""
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    w = torch.from_numpy((1 + 0.3 * rng.standard_normal(256))
                         .astype(np.float32))
    xb = x.to(torch.bfloat16)
    kernel = ops.rmsnorm_fused(xb, w)
    plain = layers.rmsnorm(xb, w.to(torch.bfloat16))
    want_k = jops.rmsnorm_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    want_p = jlayers.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16))
    assert not torch.equal(kernel, plain)
    np.testing.assert_array_equal(kernel.float().numpy(),
                                  np.asarray(want_k, np.float32))
    _close(plain.float(), np.asarray(want_p, np.float32), atol=1e-2,
           rtol=1e-2)


# ---------------------------------------------------------------------------
# exit_update
# ---------------------------------------------------------------------------

V_ODD = 5000          # not a multiple of 128; 3 reference vocab tiles


def _exit_inputs(seed=4, B=5, V=V_ODD):
    rng = _rng(seed)
    x = rng.standard_normal((B, V)).astype(np.float32)
    x[1, 77] += 12.0                              # confident (δ ~ 1)
    x[2, 10] = x[2, 4500] = x[2].max() + 9.0      # tie across vocab tiles
    x[3, 4999] += 7.5                             # max in the ragged tile
    carry = (np.array([False, False, False, True, False]),
             np.array([7, 7, 7, 7, 7], np.int32),
             np.array([0, 0, 0, 1, 0], np.int32),
             np.array([0.1, 0.2, 0.3, 0.4, 0.5], np.float32),
             np.array([0, 1, 2, 3, 1], np.int32),
             np.array([0.5, 0.25, 0.5, 0.5, 0.75], np.float32),
             np.array([True, True, False, True, True]))
    return x, carry


@pytest.mark.parametrize("m", [0, 2])
@pytest.mark.parametrize("patience_k", [0, 2])
@pytest.mark.parametrize("ema_decay", [0.0, 0.8])
@pytest.mark.parametrize("tel_bins", [0, 32])
def test_exit_update_fused_matches_reference(m, patience_k, ema_decay,
                                             tel_bins):
    x, carry = _exit_inputs()
    kw = dict(threshold=0.4, m=m, n_components=3, patience_k=patience_k,
              ema_decay=ema_decay, tel_bins=tel_bins)
    # the gate must not sit on a rounding edge: every δ is 1e-3 away
    _, delta = ref.ref_confidence(torch.from_numpy(x))
    assert float((delta - 0.4).abs().min()) > 1e-3
    want = jops.exit_update_fused(jnp.asarray(x),
                                  *(jnp.asarray(c) for c in carry), **kw)
    got = ops.exit_update_fused(torch.from_numpy(x),
                                *(torch.from_numpy(c) for c in carry), **kw)
    assert len(got) == len(want) == (7 if tel_bins else 6)
    names = ("answered", "pred", "exit", "conf", "streak", "ema", "tcode")
    for name, g, w in zip(names, got, want):
        if name in ("conf", "ema"):
            assert g.dtype == torch.float32, name
            _close(g, w)
        else:
            assert g.dtype == (torch.bool if name == "answered"
                               else torch.int32), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    # the tie across tiles resolves to the first index
    if m == 0 and not patience_k:
        assert int(got[1][2]) == 10


def test_exit_update_threshold_is_runtime_data():
    """One kernel serves every threshold: the gate moves with the argument
    (the reference folds a float threshold statically; here it is always a
    runtime argument)."""
    x, carry = _exit_inputs()
    t = torch.from_numpy(x)
    c = [torch.from_numpy(a) for a in carry]
    opened = [ops.exit_update_fused(t, *c, threshold=th, m=0,
                                    n_components=3)[0].tolist()
              for th in (0.0, 0.4, 1.1)]
    assert opened[0] == [True] * 5
    assert opened[2] == [False, False, False, True, False]
    assert opened[1] != opened[0] and opened[1] != opened[2]


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,window,live,per_slot", [
    (40, 0, [1, 1, 1], False),          # partly filled ring
    (150, 0, [1, 0, 1], False),         # ring wrap (t >= W), a dead slot
    (150, 24, [0, 1, 1], False),        # sliding window over the wrap
    (90, 16, [1, 1, 0], True),          # per-slot (B, W) position rings
    (20, 0, None, False),               # live=None: every slot live
])
def test_decode_attention_cache_matches_reference(t, window, live,
                                                  per_slot):
    rng = _rng(5)
    B, H, KV, hd, W = 3, 4, 2, 32, 64
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    s = np.arange(W)
    ring = np.where(s <= t, t - ((t - s) % W), -1).astype(np.int32)
    kpos = (np.stack([np.maximum(ring - 3 * b, -1) for b in range(B)])
            .astype(np.int32) if per_slot else ring)
    lv = None if live is None else np.array(live, bool)
    want = jops.decode_attention_cache(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), t,
        jnp.asarray(kpos), window=window,
        live=None if lv is None else jnp.asarray(lv))
    got = ops.decode_attention_cache(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), t,
        torch.from_numpy(kpos), window=window,
        live=None if lv is None else torch.from_numpy(lv))
    assert got.shape == (B, 1, H, hd)
    _close(got, want)
    if lv is not None:
        assert not got[~torch.from_numpy(lv)].any()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_bshd_matches_reference(S, window):
    rng = _rng(6)
    B, H, KV, hd = 2, 4, 2, 64
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    want = jops.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window)
    got = ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   window=window)
    assert got.shape == (B, S, H, hd)
    _close(got, want)


# ---------------------------------------------------------------------------
# on the card: every kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.utils import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
def test_confidence_ranges_and_launches_on_card(cuda_device):
    """The kernel's column ranges at the plan's cluster size equal the
    Python mirror's, and one call is one device launch (torch.profiler),
    of the cluster kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import confidence
    for V in (1, 10, 100, 1024, 1025, 8193, 16000, 32000, 64000, 151933,
              151936):
        C = confidence.plan(V)
        assert confidence.device_ranges(V, C) == confidence.ranges(V, C), V
    x = torch.randn(4, 151936, device=cuda_device).to(torch.bfloat16)
    confidence.confidence(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        confidence.confidence(x)
        torch.cuda.synchronize()
    kern = [(e.key, e.count) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and e.count > 0 and "Activity Buffer" not in e.key]
    assert len(kern) == 1 and kern[0][1] == 1, kern
    assert "conf_cluster_kernel" in kern[0][0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 151936), (70000, 10)])
def test_confidence_replays_in_a_cuda_graph(cuda_device, shape):
    """The kernel keeps nothing between calls: captured in a CUDA graph,
    it replays on 3 new inputs copied into the captured buffer with the
    eager call's bits."""
    from repro_torch.kernels import confidence
    g = torch.Generator(device=cuda_device).manual_seed(1)
    static = torch.randn(shape, generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    confidence.confidence(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = confidence.confidence(static)
    for _ in range(3):
        new = torch.randn(shape, generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        static.copy_(new)
        graph.replay()
        eager = confidence.confidence(new)
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0])
        assert torch.equal(out[1], eager[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype):
    """bf16 outputs may differ by one bf16 ulp (2**-8 relative) where two
    f32 results straddle a rounding edge; f32 by summation order."""
    from repro_torch.kernels import (decode_attention, exit_update,
                                     flash_attention, rmsnorm)
    atol, rtol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-4)
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    # rmsnorm: the model width takes the warp route in either dtype; a
    # width that is not a whole number of 16-byte chunks, and 32 chunks a
    # lane in f32, the block route
    rn = rmsnorm.rmsnorm
    rmsnorm.reset_launches()
    for R, d in ((1024, 2048), (4, 2048), (4, 2052), (4, 4096)):
        x, w = rand(R, d), 1 + 0.1 * rand(d).float()
        torch.testing.assert_close(rn(x, w), ref.ref_rmsnorm(x, w),
                                   atol=atol, rtol=rtol)
    block = 1 if dtype == torch.bfloat16 else 2
    assert rn.launches_by_route == {"warp": 4 - block, "block": block}
    # flash: bf16 takes the wgmma route, f32 the CUDA-core one, and so do
    # bf16 views one element off 16-byte alignment
    fa = flash_attention.flash_attention
    flash_attention.reset_launches()
    q, k, v = rand(4, 16, 256, 128), rand(4, 2, 256, 128), \
        rand(4, 2, 256, 128)
    for window in (0, 64):
        torch.testing.assert_close(
            fa(q, k, v, window=window),
            ref.ref_flash_attention(q, k, v, window=window),
            atol=atol, rtol=rtol)
    route = "wgmma" if dtype == torch.bfloat16 else "cuda_core"
    assert fa.launches_by_route[route] == fa.launches == 2
    q, k, v = (rand(4, 128, n, 129)[..., 1:].transpose(1, 2)
               for n in (16, 2, 2))
    torch.testing.assert_close(fa(q, k, v), ref.ref_flash_attention(q, k, v),
                               atol=atol, rtol=rtol)
    assert fa.launches_by_route["cuda_core"] == (1 if route == "wgmma"
                                                 else 3)
    # non-causal attention and hd = 64 take the CUDA-core route in any type
    q, k, v = rand(4, 16, 128, 128), rand(4, 2, 128, 128), \
        rand(4, 2, 128, 128)
    torch.testing.assert_close(
        fa(q, k, v, causal=False),
        ref.ref_flash_attention(q, k, v, causal=False), atol=atol, rtol=rtol)
    q, k, v = rand(4, 16, 128, 64), rand(4, 2, 128, 64), rand(4, 2, 128, 64)
    torch.testing.assert_close(fa(q, k, v), ref.ref_flash_attention(q, k, v),
                               atol=atol, rtol=rtol)
    assert fa.launches_by_route["cuda_core"] == (3 if route == "wgmma"
                                                 else 5)
    # decode (split-KV): the serving shape with a dead slot; W = 500 (a
    # short last chunk); a partly filled ring (empty chunks) with a slot
    # that sees no key; every slot dead.  A run repeats its bits.
    da = decode_attention.decode_attention
    for W, t, live_l, empty_slot in ((512, 700, [1, 0, 1, 1], False),
                                     (500, 700, [1, 1, 1, 1], False),
                                     (512, 100, [1, 1, 1, 1], True),
                                     (512, 700, [0, 0, 0, 0], False)):
        qd, kc, vc = rand(4, 16, 128), rand(4, W, 2, 128), rand(4, W, 2, 128)
        kpos = torch.arange(W, device=cuda_device, dtype=torch.int32)
        kpos = torch.where(kpos <= t, t - (t - kpos) % W, -1).int()
        if empty_slot:
            kpos = kpos.repeat(4, 1)
            kpos[3] = -1
        live = torch.tensor(live_l, dtype=torch.bool, device=cuda_device)
        got = da(qd, kc, vc, t, kpos, live)
        torch.testing.assert_close(
            got, ref.ref_decode_attention(qd, kc, vc, t, kpos, live=live),
            atol=atol, rtol=rtol)
        assert not got[~live].any()
        assert torch.equal(got, da(qd, kc, vc, t, kpos, live))
    logits = rand(4, 151936)
    carry = (torch.zeros(4, dtype=torch.bool, device=cuda_device),
             torch.zeros(4, dtype=torch.int32, device=cuda_device),
             torch.zeros(4, dtype=torch.int32, device=cuda_device),
             torch.zeros(4, device=cuda_device),
             torch.zeros(4, dtype=torch.int32, device=cuda_device),
             torch.zeros(4, device=cuda_device),
             torch.ones(4, dtype=torch.bool, device=cuda_device))
    kw = dict(threshold=0.5, m=0, n_components=3, ema_decay=0.8)
    got = exit_update.exit_update(logits, *carry, **kw)
    want = ref.ref_exit_update(logits, *carry, **kw)
    for i in (0, 1, 2, 4):
        assert torch.equal(got[i], want[i])
    for i in (3, 5):
        torch.testing.assert_close(got[i], want[i], atol=0, rtol=1e-5)
    # exit_update's vocab split at B = 1 and 16, a tie straddling the first
    # CTA tile boundary (the first index wins), a second call's bits alike
    for B in (1, 16):
        lg = rand(B, 151936)
        lg[-1, 4095] = lg[-1, 4096] = lg[-1].max() + 15.0
        cb = tuple(c[:1].expand(B).contiguous() for c in carry)
        kw_last = dict(kw, m=2)
        got = exit_update.exit_update(lg, *cb, **kw_last)
        want = ref.ref_exit_update(lg, *cb, **kw_last)
        assert int(got[1][-1]) == 4095
        for i in (0, 1, 2, 4):
            assert torch.equal(got[i], want[i])
        torch.testing.assert_close(got[3], want[3], atol=0, rtol=1e-5)
        again = exit_update.exit_update(lg, *cb, **kw_last)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    from repro_torch.kernels import cohort_cache, confidence, megakernel
    idx, conf = confidence.confidence(logits)
    want_i, want_c = ref.ref_confidence(logits)
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(conf, want_c, atol=0, rtol=1e-5)
    # confidence's cluster split through the caller's entry: at every
    # shape, with V making the plan pick each cluster size (1000 and 10: a
    # lane group a row; 8000: C = 1; 16000 .. 151936: C = 2 .. 16), ties
    # straddling CTA 0's range end and across the first and last ranges
    # take the first index; more rows than grid.y's 65535; same bits twice
    shapes = ((1, 151936), (4, 151936), (8, 151936), (16, 151936),
              (64, 151936), (4, 151933), (70000, 10), (4, 1000), (4, 8000),
              (4, 16000), (4, 32000), (4, 64000))
    assert {confidence.plan(V) for _, V in shapes} == {1, 2, 4, 8, 16}
    for B, V in shapes:
        lg = torch.randn(B, V, generator=g, device=cuda_device)
        e = confidence.ranges(V, confidence.plan(V))[0][1]
        straddle = [e - 1, e] if e < V else [V - 2, V - 1]
        top = lg.amax(-1, keepdim=True) + 15.0
        lg[1::4, straddle] = top[1::4].expand(-1, 2)
        lg[2::4, [1, V - 1]] = top[2::4].expand(-1, 2)
        lg = lg.to(dtype)
        want_i, want_c = ref.ref_confidence(lg)
        assert want_i[1::4].eq(straddle[0]).all()
        assert want_i[2::4].eq(1).all()
        idx, conf = confidence.confidence(lg)
        assert torch.equal(idx, want_i), (B, V)
        torch.testing.assert_close(conf, want_c, atol=0, rtol=1e-5)
        again = confidence.confidence(lg)
        assert torch.equal(again[0], idx) and torch.equal(again[1], conf)
    # logits of large magnitude (a CI-RESNET(18) head trained at too high
    # a learning rate reaches |z| ~ 5e3): the row max is subtracted before
    # the exponent is scaled, so δ keeps its 1e-5 relative bound there too
    # — against δ in float64: the plain version forms m - logsumexp in
    # f32, which itself loses up to ulp(m) / 2 of the exponent (~1e-4 of
    # δ at |m| ~ 3e3)
    for scale in (1e2, 1e3):
        lg = (torch.randn(256, 10, generator=g, device=cuda_device)
              * scale).to(dtype)
        exact = torch.softmax(lg.double(), -1).amax(-1)
        idx, conf = confidence.confidence(lg)
        assert torch.equal(idx, ref.ref_confidence(lg)[0]), scale
        torch.testing.assert_close(conf.double(), exact, atol=0, rtol=1e-5)
    # the megakernel at the full head width, at the last component (every
    # live row answers); a confident row, a dead row.  bf16 takes the tc
    # route at B = 1 .. 16, f32 the CUDA-core one; two calls repeat their
    # bits; every row dead passes every carry through
    mk = megakernel.exit_head_update
    megakernel.reset_launches()
    w = 1 + 0.1 * rand(2048).float()
    head = rand(2048, 151936) * 0.02
    batches = (1, 2, 4, 8, 16) if dtype == torch.bfloat16 else (4,)
    for B in batches:
        h = rand(B, 2048)
        hc = head.clone()
        hc[:, 77] = ref.ref_rmsnorm(h[-1:], w)[0] * 0.05
        cb = tuple(c[:1].expand(B).contiguous() for c in carry)
        live = torch.arange(B, device=cuda_device) % 4 != 2
        kw.update(live=live, m=2)
        got = mk(h, w, hc, *cb, **kw)
        want = ref.ref_exit_head_update(h, w, hc, *cb, **kw)
        assert int(got[1][-1]) == int(want[1][-1]) == 77
        for i in (0, 2, 4):
            assert torch.equal(got[i], want[i])
        torch.testing.assert_close(got[3], want[3], atol=0,
                                   rtol=2e-2 if dtype == torch.bfloat16
                                   else 1e-4)
        assert all(torch.equal(a, b)
                   for a, b in zip(got, mk(h, w, hc, *cb, **kw)))
        dead = mk(h, w, hc, *cb, **dict(kw, live=torch.zeros_like(live)))
        assert all(torch.equal(o, c.to(o.dtype)) for o, c in zip(dead, cb))
        del hc
    route = "tc" if dtype == torch.bfloat16 else "cuda_core"
    assert mk.launches_by_route[route] == mk.launches == 3 * len(batches)
    # a vocab not a multiple of 8 columns takes the CUDA-core route
    h = rand(4, 2048)
    hu = head[:, :151933]
    kw.update(live=None)
    got = mk(h, w, hu, *carry, **kw)
    want = ref.ref_exit_head_update(h, w, hu, *carry, **kw)
    for i in (0, 2, 4):
        assert torch.equal(got[i], want[i])
    assert mk.launches_by_route["cuda_core"] == (1 if route == "tc" else 4)
    del head, hu
    # tc off the serving shapes: fp16, and a width that is not a multiple
    # of the 64-row stage (the last stage's box reads past d)
    for dt, B, d, V in ((torch.float16, 4, 2048, 20000),
                        (torch.bfloat16, 3, 1000, 1000)):
        if dtype != torch.bfloat16:
            break
        h = torch.randn(B, d, generator=g, device=cuda_device).to(dt)
        wd = 1 + 0.1 * torch.randn(d, generator=g, device=cuda_device)
        hd = (0.02 * torch.randn(d, V, generator=g,
                                 device=cuda_device)).to(dt)
        hd[:, 77] = (ref.ref_rmsnorm(h[-1:], wd)[0].float() * 0.05).to(dt)
        cb = tuple(c[:1].expand(B).contiguous() for c in carry)
        assert megakernel.route(h, hd) == "tc"
        got = mk(h, wd, hd, *cb, **kw)
        want = ref.ref_exit_head_update(h, wd, hd, *cb, **kw)
        assert int(got[1][-1]) == int(want[1][-1]) == 77
        for i in (0, 2, 4):
            assert torch.equal(got[i], want[i])
        torch.testing.assert_close(got[3], want[3], atol=0, rtol=2e-2)
    dst = [rand(12, 4, 512, 2, 128), rand(12, 4, 512, 2, 128)]
    src = [rand(12, 2, 512, 2, 128), rand(12, 2, 512, 2, 128)]
    want = [d.clone() for d in dst]
    for wd, sd in zip(want, src):
        wd[:, 2:4] = sd
    cohort_cache.cohort_scatter_tree(dst, src, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(dst, want))
    # the slot route (select mode): cohort 1's rows of ring slot 37, the
    # slot read from device memory
    slot = torch.tensor(37, device=cuda_device)
    rows = [rand(12, 2, 1, 2, 128), rand(12, 2, 1, 2, 128)]
    for wd, sd in zip(want, rows):
        ref.ref_cohort_scatter_slot(wd, sd, 1, 2, slot)
    cohort_cache.cohort_scatter_tree(dst, rows, 1, 2, slot=slot)
    assert all(torch.equal(a, b) for a, b in zip(dst, want))
    # the paged gather of a layer slice of a stacked store, k and v in one
    # launch; trash and duplicate ids in the table
    ks, vs = rand(3, 769, 16, 2, 128), rand(3, 769, 16, 2, 128)
    table = torch.randint(1, 769, (4, 32), generator=g, device=cuda_device,
                          dtype=torch.int32)
    table[1] = 0
    table[2, 5:9] = table[0, 5]
    gk, gv = ops.paged_gather_kv(ks[1], vs[1], table)
    assert torch.equal(gk, ref.ref_paged_gather(ks[1], table))
    assert torch.equal(gv, ref.ref_paged_gather(vs[1], table))
    assert torch.equal(ops.paged_gather(ks[2], table),
                       ref.ref_paged_gather(ks[2], table))
    # decode attention's paged route reads the same stores through the
    # table: bit for bit the dense route over the gathered views
    assert decode_attention.route(ks[1], vs[1], table) == "paged"
    qd = rand(4, 16, 128)
    kpos = torch.arange(512, device=cuda_device, dtype=torch.int32)
    kpos = torch.where(kpos <= 700, 700 - (700 - kpos) % 512, -1).int()
    decode_attention.reset_launches()
    got = da(qd, ks[1], vs[1], 700, kpos, table=table)
    assert torch.equal(got, da(qd, gk, gv, 700, kpos))
    assert da.launches_by_route == {"dense": 1, "paged": 1}
