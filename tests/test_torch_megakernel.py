"""The port's slice-2 kernels against the JAX package's: the exit-head
megakernel, the fused confidence kernel and the cohort scatter.

The same numpy inputs (``np.random.default_rng``) go through the reference
kernels (``repro.kernels``, Pallas in interpret mode as
``tests/test_exit_kernels.py`` runs them on the CPU) and through the port's
wrappers on CPU tensors (each kernel's plain version).  The spec is
``tests/test_exit_kernels.py:183-290``.

Tolerances: f32 confidences and EMAs 1e-5 relative (sums in other
orders).  bf16: the head product rounds each logit to bf16 on both sides
but sums in another order, so a logit may land one bf16 ulp apart; the
confidence then moves by up to ~1 % (rtol 2e-2), and the argmax may flip
only on a row whose top two logits lie within 2 bf16 ulps — such rows are
excluded from the prediction (and telemetry code) check.  The threshold
is picked 1e-3 away from every confidence, so no gate sits on a rounding
edge.  Integers (answered, exit index, streak, telemetry code) and the
cohort scatter's bytes exactly; within the port, the megakernel route
equals the unfused route bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cohort_cache import cohort_scatter as jax_cohort_scatter
from repro.kernels.confidence import confidence as jax_confidence
from repro.kernels.megakernel import exit_head_update as jax_exit_head
from repro_torch.core.policy import ExitDecider
from repro_torch.kernels import ops, ref

NAMES = ("answered", "pred", "exit", "conf", "streak", "ema", "tcode")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _head_inputs(seed, B, d, V, n):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((d, V))).astype(np.float32)
    carry = (rng.integers(0, 2, B).astype(bool),
             rng.integers(0, V, B).astype(np.int32),
             rng.integers(0, n, B).astype(np.int32),
             rng.random(B).astype(np.float32),
             rng.integers(0, 3, B).astype(np.int32),
             rng.random(B).astype(np.float32),
             rng.integers(0, 2, B).astype(bool))
    return h, w, head, carry


def _live(pattern, B):
    return {"all": np.ones(B, bool), "none": np.zeros(B, bool),
            "mixed": np.arange(B) % 3 != 1}[pattern]


def _bf16_ulp(x):
    return np.abs(x) * 2.0 ** -7


def _threshold(delta):
    """The first candidate threshold 1e-3 away from every confidence."""
    return next(t for t in (0.2, 0.22, 0.18, 0.25, 0.15)
                if np.min(np.abs(delta - t)) > 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,d,V", [(8, 64, 300), (5, 32, 2500)])
@pytest.mark.parametrize("m,k,decay,bins", [
    (0, 0, 0.0, 0),        # stateless mid-scan component
    (1, 2, 0.0, 16),       # patience@2 rewrite, telemetry code
    (2, 0, 0.8, 0),        # final component + EMA fold
])
@pytest.mark.parametrize("live_pat", ["all", "none", "mixed"])
def test_exit_head_fused_matches_reference(dtype, B, d, V, m, k, decay, bins,
                                           live_pat):
    """V is never a multiple of the reference's 128-column tile; live
    patterns all / none / mixed (dead rows pass every carry through)."""
    h, w, head, carry = _head_inputs(B * V + m, B, d, V, 3)
    live = _live(live_pat, B)
    jh = jnp.asarray(h, JDT[dtype])
    jhead = jnp.asarray(head, JDT[dtype])
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(TDT[dtype])
    thead = torch.from_numpy(np.array(jhead.astype(jnp.float32))).to(
        TDT[dtype])
    # the plain logits: the gate's margin and the rows on a bf16 tie
    lg = (ref.ref_rmsnorm(th, torch.from_numpy(w)) @ thead).float().numpy()
    top2 = -np.sort(-lg, axis=1)[:, :2]
    delta = ref.ref_confidence(torch.from_numpy(lg))[1].numpy()
    kw = dict(threshold=_threshold(delta), m=m, n_components=3,
              patience_k=k, ema_decay=decay, tel_bins=bins)
    want = jax_exit_head(jh, jnp.asarray(w), jhead,
                         *(jnp.asarray(c) for c in carry),
                         live=jnp.asarray(live), bt=4, vt=128, **kw)
    got = ops.exit_head_fused(th, torch.from_numpy(w), thead,
                              *(torch.from_numpy(c) for c in carry),
                              live=torch.from_numpy(live), **kw)
    assert len(got) == len(want) == (7 if bins else 6)
    ties = (top2[:, 0] - top2[:, 1] <= 2 * _bf16_ulp(top2[:, 0])
            if dtype == "bfloat16" else np.zeros(B, bool))
    assert ties.sum() <= B // 4
    rtol = 2e-2 if dtype == "bfloat16" else 1e-5
    for name, g, x in zip(NAMES, got, want):
        x = np.asarray(x)
        if name in ("pred", "tcode"):
            np.testing.assert_array_equal(g.numpy()[~ties], x[~ties],
                                          err_msg=name)
        elif name in ("conf", "ema"):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), x, rtol=rtol, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy().astype(x.dtype), x,
                                          err_msg=name)
    # dead rows pass every carry through unchanged
    for g, c in zip(got[:6], carry):
        np.testing.assert_array_equal(g.numpy()[~live], c[~live])
    if bins:
        assert not got[6].numpy()[~live].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,decay", [(0, 0, 0.0), (1, 2, 0.0),
                                       (2, 0, 0.8)])
def test_megakernel_route_equals_unfused_route_bit_for_bit(dtype, m, k,
                                                           decay):
    """On the CPU the megakernel's plain version is the unfused route's
    arithmetic (kernel-route rmsnorm, the head product in the model dtype,
    the exit update): identical bits on every live row."""
    B, d, V = 6, 64, 700
    h, w, head, carry = _head_inputs(40 + m, B, d, V, 3)
    th = torch.from_numpy(h).to(TDT[dtype])
    thead = torch.from_numpy(head).to(TDT[dtype])
    tw = torch.from_numpy(w)
    tc = [torch.from_numpy(c) for c in carry]
    kw = dict(threshold=0.2, m=m, n_components=3, patience_k=k,
              ema_decay=decay)
    fused = ops.exit_head_fused(th, tw, thead, *tc, **kw)
    unfused = ops.exit_update_fused(ops.rmsnorm_fused(th, tw) @ thead, *tc,
                                    **kw)
    for name, a, b in zip(NAMES, fused, unfused):
        assert torch.equal(a, b), name


def test_scan_hidden_matches_scan_logits():
    """ExitDecider.scan_hidden (megakernel route) == exit-head product +
    scan_logits (fused exit-update route) across a full scan, bitwise —
    and scan_hidden refuses a decider without the fused scan."""
    n_m, B, d, V = 3, 8, 64, 512
    ths = (0.04, 0.04, 0.0)
    dec = ExitDecider("patience@2", thresholds=ths, use_kernels=True)
    assert dec.fused_scan
    rng = np.random.default_rng(12)
    hs = [torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
          for _ in range(n_m)]
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d))
                         .astype(np.float32))
    head = torch.from_numpy((0.3 * rng.standard_normal((d, V)))
                            .astype(np.float32))
    ca = cb = None
    for m in range(n_m):
        ca = dec.scan_logits(m, n_m, ops.rmsnorm_fused(hs[m], w) @ head, ths,
                             ca)
        cb = dec.scan_hidden(m, n_m, hs[m], w, head, ths, cb)
    for key in ("answered", "pred", "exit", "conf", "streak"):
        assert torch.equal(ca[key], cb[key]), key
    with pytest.raises(ValueError, match="fused-scan"):
        ExitDecider("softmax_max", thresholds=ths).scan_hidden(
            0, n_m, hs[0], w, head, ths)


# ---------------------------------------------------------------------------
# confidence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,V", [(4, 5000), (3, 2048), (1, 130)])
def test_softmax_confidence_fused_matches_reference(dtype, B, V):
    rng = np.random.default_rng(B + V)
    x = rng.standard_normal((B, V)).astype(np.float32) * 2
    x[0, V // 3] += 9.0                            # a confident row
    jx = jnp.asarray(x, JDT[dtype])
    want_i, want_c = jax_confidence(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TDT[dtype])
    got_i, got_c = ops.softmax_confidence_fused(tx)
    assert got_i.dtype == torch.int32 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-7)
    # the ops adapter keeps leading dims, as the reference's does
    i3, c3 = ops.softmax_confidence_fused(tx.reshape(B, 1, V))
    assert i3.shape == c3.shape == (B, 1)


def test_confidence_tie_across_reference_tiles_picks_first_index():
    """A tie between columns in two of the reference's vocab tiles
    (vt = 2048): both packages answer with the first index."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    x[1, 10] = x[1, 3000] = x[1].max() + 5.0
    want_i, want_c = jops.softmax_confidence_fused(jnp.asarray(x))
    got_i, got_c = ops.softmax_confidence_fused(torch.from_numpy(x))
    assert int(np.asarray(want_i)[1]) == int(got_i[1]) == 10
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5)


# ---------------------------------------------------------------------------
# cohort scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,C", [((3, 8, 16, 2, 8), 4), ((2, 6, 5), 3),
                                     ((4, 8), 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.bool_])
def test_cohort_scatter_matches_at_set(shape, C, dtype):
    rng = np.random.default_rng(14)
    L, B = shape[0], shape[1]
    Bc = B // C
    dst = (rng.standard_normal(shape) > 0).astype(dtype)
    jdst = jnp.asarray(dst)
    tdst = torch.from_numpy(dst.copy())
    for c in range(C):
        src = (rng.standard_normal((L, Bc) + shape[2:]) > 0.3).astype(dtype)
        jdst = jax_cohort_scatter(jdst, jnp.asarray(src), c, C,
                                  interpret=True)
        want = np.asarray(dst.copy())
        want[:, c * Bc:(c + 1) * Bc] = src
        dst = want
        got = ops.cohort_scatter(tdst, torch.from_numpy(src), c, C)
        assert got is tdst                      # in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdst))
        np.testing.assert_array_equal(got.numpy(), want)


def test_cohort_scatter_tree_chain_equals_concat():
    """Chaining one tree scatter per cohort rebuilds exactly the concat of
    the per-cohort parts, on every leaf of a cache tree."""
    rng = np.random.default_rng(15)
    L, B, C = 2, 8, 4
    Bc = B // C
    parts = [[rng.standard_normal((L, Bc, 4, 8)).astype(np.float32),
              rng.standard_normal((L, Bc, 3)) > 0] for _ in range(C)]
    cur = {"k": torch.zeros(L, B, 4, 8), "m": torch.zeros(L, B, 3,
                                                          dtype=torch.bool)}
    jcur = [jnp.zeros((L, B, 4, 8)), jnp.zeros((L, B, 3), bool)]
    for c in range(C):
        out = ops.cohort_scatter_tree(
            cur, {"k": torch.from_numpy(parts[c][0]),
                  "m": torch.from_numpy(parts[c][1])}, c, C)
        assert out is cur
        jcur = [jax_cohort_scatter(jcur[i], jnp.asarray(parts[c][i]), c, C,
                                   interpret=True) for i in range(2)]
    for i, key in enumerate(("k", "m")):
        want = np.concatenate([p[i] for p in parts], axis=1)
        np.testing.assert_array_equal(cur[key].numpy(), want)
        np.testing.assert_array_equal(cur[key].numpy(), np.asarray(jcur[i]))


@pytest.mark.parametrize("shape,C,slot", [((3, 8, 16, 2, 8), 4, 5),
                                          ((2, 6, 4, 3), 3, 3),
                                          ((4, 2, 7, 1), 2, 0)])
def test_cohort_scatter_slot_route_matches_at_set(shape, C, slot):
    """The slot route lands cohort c's rows of one ring slot: the JAX
    cohort scatter of the slot's (L, B, ...) plane, every other slot
    untouched."""
    rng = np.random.default_rng(16)
    L, B = shape[0], shape[1]
    Bc = B // C
    dst = rng.standard_normal(shape).astype(np.float32)
    tdst = torch.from_numpy(dst.copy())
    jplane = jnp.asarray(dst[:, :, slot])
    for c in range(C):
        src = rng.standard_normal((L, Bc, 1) + shape[3:]).astype(np.float32)
        jplane = jax_cohort_scatter(jplane, jnp.asarray(src[:, :, 0]), c, C,
                                    interpret=True)
        out = ops.cohort_scatter_tree([tdst], [torch.from_numpy(src)], c, C,
                                      slot=torch.tensor(slot))
        assert out[0] is tdst                   # in place
    got = tdst.numpy()
    np.testing.assert_array_equal(got[:, :, slot], np.asarray(jplane))
    others = [w for w in range(shape[2]) if w != slot]
    np.testing.assert_array_equal(got[:, :, others], dst[:, :, others])


def test_cohort_scatter_rejects_mismatched_leaves():
    with pytest.raises(ValueError):
        ops.cohort_scatter_tree([torch.zeros(2, 4)], [], 0, 2)
