"""The redesigned exit-head megakernel and rmsnorm, pinned on the CPU.

Neither kernel runs here (no card), so their arithmetic is emulated in
plain torch and held against the JAX package's Pallas kernels (in
interpret mode, as ``tests/test_torch_megakernel.py`` runs them) on the
same numpy inputs:

- the megakernel's ``tc`` route: ``ref.ref_exit_head_update_tc`` (the
  warp-per-row norm — past 16 16-byte chunks a lane, at d 4104 and
  deepseek-coder-33b's 7168, the block route's order — rounded to bf16,
  the head product summed in f32 over
  k16 steps, logits rounded to bf16, one partial per CTA over
  ``megakernel.plan``'s vocab ranges, merged in CTA order) against
  ``repro.kernels.ops.exit_head_fused``.  Tolerances: the integers
  (answered, exit index, streak) exactly; the prediction exactly except on
  rows whose plain top two logits lie within 2 bf16 ulps (a logit may
  land one bf16 ulp apart: the sums run in another order); confidences
  and EMAs within ``chip_smoke.MEGA_TOL`` (2e-2 relative in bf16);
- the vocab split ``megakernel.plan``: contiguous, tile-aligned,
  disjoint, ordered ranges covering [0, V), with more CTAs than tiles too;
- the routes both wrappers pick before a launch, which depend only on the
  dtypes, shapes and alignment, so CPU views show them;
- rmsnorm's ``warp`` route: ``ref.ref_rmsnorm_warp`` (each lane's sum of
  squares in load order, a xor tree over the lanes) against
  ``repro.kernels.ops.rmsnorm_fused``: bf16 within one bf16 ulp (the two
  sums differ in order and f32 rounding, which may move a product across
  a bf16 rounding edge), f32 within 1e-6 relative (a few f32 ulps); and
  its ``block`` route, ``ref.ref_rmsnorm_block`` (256 threads' strided
  sums, each warp's xor tree, warp 0 over the 8 warp sums), the same way
  (the tc route's prologue past the warp route has this order; the card
  holds it bit for bit against the block kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import megakernel, ref, rmsnorm

MEGA_TOL = 2e-2            # chip_smoke.MEGA_TOL["bfloat16"]
TIE_WINDOW = 2.0 ** -6     # chip_smoke.TIE_WINDOW["bfloat16"]: 2 bf16 ulps
NAMES = ("answered", "pred", "exit", "conf", "streak", "ema", "tcode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """numpy f32 -> (the bf16 jax array, the same values as a torch bf16
    tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


# ---------------------------------------------------------------------------
# the megakernel's tc route: the emulator against the JAX kernel
# ---------------------------------------------------------------------------

# name -> (m, patience_k, ema_decay, tel_bins, live pattern, n_ctas); three
# components, so m = 2 is the last
TC_CASES = {
    "mid_patience_dead_rows": (0, 2, 0.0, 16, "mixed", 7),
    "last_ema_more_ctas_than_tiles": (2, 0, 0.8, 0, "all", 132),
    "first_plain_one_cta": (0, 0, 0.0, 0, "all", 1),
    "last_patience_dead_rows": (2, 2, 0.5, 0, "mixed", 3),
}


@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_emulator_matches_jax_megakernel(B, case):
    """d = 128 (8 k16 steps); V = 700, not a multiple of the 64-column
    tile (the last tile is partial)."""
    _tc_case(B, case, 128)


@pytest.mark.parametrize("d", [4104, 7168])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_emulator_matches_jax_megakernel_wide(B, case, d):
    """Past the warp route: d 4104 (a whole number of 16-byte chunks,
    not of 64-element K chunks) and deepseek-coder-33b's 7168, where the
    tc prologue normalises in the block route's order; V = 700."""
    _tc_case(B, case, d)


def _tc_case(B, case, d):
    m, k, decay, bins, live_pat, n_ctas = TC_CASES[case]
    V, n_m = 700, 3
    rng = np.random.default_rng(1000 * B + len(case) + d - 128)
    h = rng.standard_normal((B, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    # logits of the same spread at every width
    head = (0.3 * (128 / d) ** 0.5
            * rng.standard_normal((d, V))).astype(np.float32)
    carry = (rng.integers(0, 2, B).astype(bool),
             rng.integers(0, V, B).astype(np.int32),
             rng.integers(0, n_m, B).astype(np.int32),
             rng.random(B).astype(np.float32),
             rng.integers(0, 3, B).astype(np.int32),
             rng.random(B).astype(np.float32),
             rng.integers(0, 2, B).astype(bool))
    live = (np.ones(B, bool) if live_pat == "all"
            else np.arange(B) % 3 != 1)
    jh, th = _bf16(h)
    jhead, thead = _bf16(head)
    tw = torch.from_numpy(w)
    lg = (ref.ref_rmsnorm(th, tw) @ thead).float().numpy()
    top2 = -np.sort(-lg, axis=1)[:, :2]
    ties = top2[:, 0] - top2[:, 1] <= TIE_WINDOW * np.abs(top2[:, 0])
    delta = ref.ref_confidence(torch.from_numpy(lg))[1].numpy()
    threshold = next(t for t in (0.2, 0.22, 0.18, 0.25, 0.15)
                     if np.min(np.abs(delta - t)) > 1e-3)
    kw = dict(threshold=threshold, m=m, n_components=n_m, patience_k=k,
              ema_decay=decay, tel_bins=bins)
    want = jops.exit_head_fused(jh, jnp.asarray(w), jhead,
                                *(jnp.asarray(c) for c in carry),
                                live=jnp.asarray(live), **kw)
    got = ref.ref_exit_head_update_tc(
        th, tw, thead, *(torch.from_numpy(c) for c in carry),
        live=torch.from_numpy(live), n_ctas=n_ctas, **kw)
    assert len(got) == len(want) == (7 if bins else 6)
    for name, g, x in zip(NAMES, got, want):
        x = np.asarray(x)
        if name in ("pred", "tcode"):
            np.testing.assert_array_equal(g.numpy()[~ties], x[~ties],
                                          err_msg=name)
        elif name in ("conf", "ema"):
            np.testing.assert_allclose(g.numpy(), x, rtol=MEGA_TOL,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy().astype(x.dtype), x,
                                          err_msg=name)
    for g, c in zip(got[:6], carry):           # dead rows pass through
        np.testing.assert_array_equal(g.numpy()[~live], c[~live])


def test_tc_emulator_first_argmax_across_ctas():
    """A row whose maximum appears in two CTAs' ranges answers the lower
    column; the CTA merge keeps the whole row's Σexp (1e-5: 1000 terms
    summed in another order than the plain softmax's)."""
    d, V = 64, 1000
    h = torch.zeros(2, d)
    h[:, 3] = 1.0
    head = torch.zeros(d, V)
    head[3, 10] = head[3, 900] = 4.0           # CTAs 0 and 6 of 7
    head[3, 500] = 2.0
    xb, hb = h.bfloat16(), head.bfloat16()
    i32 = dict(dtype=torch.int32)
    carry = (torch.zeros(2, dtype=torch.bool), torch.zeros(2, **i32),
             torch.zeros(2, **i32), torch.zeros(2), torch.zeros(2, **i32),
             torch.zeros(2), torch.ones(2, dtype=torch.bool))
    kw = dict(threshold=0.0, m=2, n_components=3)
    got = ref.ref_exit_head_update_tc(xb, torch.ones(d), hb, *carry,
                                      n_ctas=7, **kw)
    want = ref.ref_exit_head_update(xb, torch.ones(d), hb, *carry, **kw)
    assert got[1].tolist() == want[1].tolist() == [10, 10]
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the vocab split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [64, 1000, 151936])
@pytest.mark.parametrize("n_ctas", [1, 7, 132])
def test_plan_covers_the_vocab_in_tile_aligned_ranges(V, n_ctas):
    ranges = megakernel.plan(V, n_ctas)
    assert len(ranges) == n_ctas
    n_tiles = -(-V // megakernel.TC_COLS)
    pos = 0
    for start, stop in ranges:
        assert start == pos and start <= stop <= V
        # an empty range past the last tile sits at V
        assert start % megakernel.TC_COLS == 0 or start == stop == V
        assert stop == V or stop % megakernel.TC_COLS == 0
        pos = stop
    assert pos == V
    sizes = [-(-(b - a) // megakernel.TC_COLS) for a, b in ranges]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == n_tiles
    if n_ctas > n_tiles:
        assert sum(a == b for a, b in ranges) == n_ctas - n_tiles


# ---------------------------------------------------------------------------
# the routes, chosen before the launch
# ---------------------------------------------------------------------------

def _head(V, dtype=torch.bfloat16, d=256):
    return torch.zeros(d, V, dtype=dtype)


MK_ROUTES = {
    "aligned_bf16": (torch.zeros(4, 256, dtype=torch.bfloat16), _head(1024),
                     "tc"),
    "aligned_fp16_b16": (torch.zeros(16, 256, dtype=torch.float16),
                         _head(1024, torch.float16), "tc"),
    "f32": (torch.zeros(4, 256), _head(1024, torch.float32), "cuda_core"),
    "vocab_not_multiple_of_8": (torch.zeros(4, 256, dtype=torch.bfloat16),
                                _head(1024)[:, :1020], "cuda_core"),
    "b17": (torch.zeros(17, 256, dtype=torch.bfloat16), _head(1024),
            "cuda_core"),
    "head_base_off_16_bytes": (torch.zeros(4, 256, dtype=torch.bfloat16),
                               _head(1032)[:, 4:], "cuda_core"),
    "h_rows_off_16_bytes": (torch.zeros(4, 260, dtype=torch.bfloat16)
                            [:, 4:], _head(1024), "cuda_core"),
    # deepseek-coder-33b's exit head: a 7-stage ring beside 112 KB of rows
    "deepseek_b4_d7168": (torch.zeros(4, 7168, dtype=torch.bfloat16),
                          _head(32256, d=7168), "tc"),
    "deepseek_b8_d7168": (torch.zeros(8, 7168, dtype=torch.bfloat16),
                          _head(32256, d=7168), "tc"),
    # 9-16 rows of 7168 take 224 KB of shared memory alone: no ring fits
    "deepseek_b16_d7168": (torch.zeros(16, 7168, dtype=torch.bfloat16),
                           _head(32256, d=7168), "cuda_core"),
    # 16 rows of 4096 leave room for 6 stages
    "b16_d4096": (torch.zeros(16, 4096, dtype=torch.bfloat16),
                  _head(1024, d=4096), "tc"),
}


@pytest.mark.parametrize("case", list(MK_ROUTES))
def test_megakernel_route(case):
    h, head, want = MK_ROUTES[case]
    assert megakernel.route(h, head) == want


def test_megakernel_route_follows_the_norm_weights():
    """Weights the warp-per-row norm cannot read (bf16 beside f16 rows)
    no longer move the call off the tc route: its prologue, like the
    CUDA-core route's, then takes the block route's arithmetic, as the
    unfused rmsnorm would on the same rows and weights."""
    h = torch.zeros(4, 256, dtype=torch.float16)
    head = _head(1024, torch.float16)
    for w, norm in ((torch.ones(256), "warp"),
                    (torch.ones(256, dtype=torch.bfloat16), "block")):
        assert megakernel.route(h, head) == "tc"
        assert rmsnorm.route(h, w) == norm


@pytest.mark.parametrize("B,d,stages", [
    (4, 2048, 8), (16, 2048, 8), (8, 4096, 8), (16, 3072, 8),
    (16, 4096, 6), (1, 7168, 7), (8, 7168, 7), (9, 7168, 0),
    (8, 10368, 4), (8, 10432, 0)])
def test_tc_ring_depth(B, d, stages):
    """8 stages wherever they fit beside the rows (every launch the route
    took before it went past d 4096 keeps its depth), else as many as fit
    under the 227 KB cap, and 0 — not on tc — below 4."""
    assert megakernel.tc_stages(B, d) == stages
    cap = megakernel._MAX_SMEM
    if stages:
        assert megakernel._tc_smem_bytes(B, d, stages) <= cap
        assert stages == 8 or megakernel._tc_smem_bytes(B, d,
                                                        stages + 1) > cap
    else:
        assert megakernel._tc_smem_bytes(B, d, 4) > cap


NORM_ROUTES = {
    "bf16_2048": (torch.zeros(4, 2048, dtype=torch.bfloat16),
                  torch.ones(2048), "warp"),
    "bf16_4096_w_bf16": (torch.zeros(4, 4096, dtype=torch.bfloat16),
                         torch.ones(4096, dtype=torch.bfloat16), "warp"),
    "f32_2048": (torch.zeros(1024, 2048), torch.ones(2048), "warp"),
    "f32_4096": (torch.zeros(4, 4096), torch.ones(4096), "block"),
    "bf16_8192": (torch.zeros(4, 8192, dtype=torch.bfloat16),
                  torch.ones(8192), "block"),
    "bf16_d_not_16_bytes": (torch.zeros(4, 2052, dtype=torch.bfloat16),
                            torch.ones(2052), "block"),
    "f32_rows_w_bf16": (torch.zeros(4, 2048),
                        torch.ones(2048, dtype=torch.bfloat16), "block"),
    "w_off_16_bytes": (torch.zeros(4, 2048, dtype=torch.bfloat16),
                       torch.ones(2049)[1:], "block"),
}


@pytest.mark.parametrize("case", list(NORM_ROUTES))
def test_rmsnorm_route(case):
    x, w, want = NORM_ROUTES[case]
    assert rmsnorm.route(x, w) == want


# ---------------------------------------------------------------------------
# rmsnorm's warp route: the emulator against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 4, 37])
@pytest.mark.parametrize("d", [64, 2048])
def test_warp_rmsnorm_emulator_matches_jax_kernel(dtype, R, d):
    _norm_case(ref.ref_rmsnorm_warp, dtype, R, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("d", [300, 4104, 7168])
def test_block_rmsnorm_emulator_matches_jax_kernel(dtype, R, d):
    """The block route's order at widths past the warp route (4104,
    deepseek-coder-33b's 7168) and one under a thread's second element
    (300)."""
    _norm_case(ref.ref_rmsnorm_block, dtype, R, d)


def _norm_case(emulator, dtype, R, d):
    rng = np.random.default_rng(R * d)
    x = (3 * rng.standard_normal((R, d))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    if dtype == "bfloat16":
        jx, tx = _bf16(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jops.rmsnorm_fused(jx, jnp.asarray(w), eps=1e-5),
                      np.float32)
    got = emulator(tx, torch.from_numpy(w), 1e-5)
    assert got.dtype == tx.dtype and got.shape == (R, d)
    got = got.float().numpy()
    if dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
