"""The split exit update and decode attention's paged route, pinned on the
CPU.

Neither kernel runs here (no card), so their arithmetic is emulated in
plain torch (``repro_torch.kernels.ref``) and held against the plain
versions and the JAX package's Pallas kernels (in interpret mode, as
``tests/test_kernels.py`` runs them) on the same numpy inputs:

- ``exit_update``'s vocab split: ``ref.ref_exit_update_split`` (one
  (max, Σexp, first-argmax) partial per 4096-column tile, merged in tile
  order) against ``ref.ref_exit_update`` — integers (answered, prediction,
  exit index, streak, telemetry code) bit for bit — and against
  ``repro.kernels.ops.exit_update_fused``: integers exactly, confidences
  and EMAs within 1e-5 relative (f32 sums in other orders; the threshold
  lies 1e-3 away from every confidence, so no gate sits on a rounding
  edge, and no confidence lies within 1e-4 of a telemetry bin's edge);
- ``decode_attention``'s ``paged`` route: ``ref.ref_decode_attention_split``
  reading K/V through the block table against the same emulator over
  ``ref.ref_paged_gather``'s view — bit for bit, which is the dense ≡ paged
  contract the kernel keeps — and both against the JAX chain
  ``paged_gather`` + ``decode_attention_cache`` within 1e-5 (f32 sums in
  other orders);
- the route choice (``decode_attention.route``), which depends only on the
  block size and the stores' alignment, so CPU tensors show it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.paged_gather import paged_gather as jax_paged_gather
from repro_torch.kernels import decode_attention as dattn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.exit_update import TILE  # the kernel's vocab tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_TOL = 1e-5
NAMES = ("answered", "pred", "exit", "conf", "streak", "ema", "tcode")

# ---------------------------------------------------------------------------
# exit_update: the vocab split
# ---------------------------------------------------------------------------

V = 3 * TILE + 388        # three whole tiles and a partial fourth


def _exit_inputs(B, seed=7):
    """Rows by role (cycled over B): a confident row, a tie straddling
    the first tile boundary, a tie inside one tile, the maximum in the
    last (partial) tile, and plain noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, V)).astype(np.float32)
    for b in range(B):
        role = b % 5
        top = x[b].max()
        if role == 0:
            x[b, 77] += 14.0
        elif role == 1:
            x[b, TILE - 1] = x[b, TILE] = top + 9.0
        elif role == 2:
            x[b, 2 * TILE + 10] = x[b, 2 * TILE + 20] = top + 9.0
        elif role == 3:
            x[b, V - 5] = top + 8.0
    carry = (rng.integers(0, 2, B).astype(bool),
             rng.integers(0, V, B).astype(np.int32),
             rng.integers(0, 3, B).astype(np.int32),
             rng.random(B).astype(np.float32),
             rng.integers(0, 3, B).astype(np.int32),
             rng.random(B).astype(np.float32),
             rng.integers(0, 2, B).astype(bool))
    return x, carry


def _want_argmax(x):
    return x.argmax(-1)       # numpy: the first index of the maximum


EXIT_CASES = {   # (m, patience_k, ema_decay, tel_bins)
    "gate": (0, 0, 0.0, 0),
    "final_component": (2, 0, 0.0, 0),
    "patience_2": (1, 2, 0.0, 0),
    "ema_fold": (0, 0, 0.8, 0),
    "telemetry_bins": (0, 0, 0.0, 32),
    "all": (2, 2, 0.8, 32),
}


@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("case", list(EXIT_CASES))
def test_split_exit_update_matches_plain_and_pallas(B, case):
    m, pk, decay, bins = EXIT_CASES[case]
    x, carry = _exit_inputs(B)
    tx = torch.from_numpy(x)
    _, delta = ref.ref_confidence(tx)
    th = 0.4
    assert float((delta - th).abs().min()) > 1e-3
    if bins:
        edge = (delta * bins) - torch.round(delta * bins)
        assert float(edge.abs().min()) > 1e-4
    kw = dict(threshold=th, m=m, n_components=3, patience_k=pk,
              ema_decay=decay, tel_bins=bins)
    tc = [torch.from_numpy(c) for c in carry]
    got = ref.ref_exit_update_split(tx, *tc, **kw)
    plain = ref.ref_exit_update(tx, *tc, **kw)
    want = jops.exit_update_fused(jnp.asarray(x),
                                  *(jnp.asarray(c) for c in carry), **kw)
    assert len(got) == len(plain) == len(want) == (7 if bins else 6)
    for name, g, p, w in zip(NAMES, got, plain, want):
        if name in ("conf", "ema"):
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=F32_TOL,
                                       atol=0, err_msg=name)
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=F32_TOL, atol=0, err_msg=name)
        else:
            assert torch.equal(g, p), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


def test_split_confidence_takes_the_first_index_of_a_tie():
    """The raw predictions (telemetry codes at one bin carry them) are
    the first index of each row's maximum: across the tile boundary
    (4095, not 4096), inside a tile, and in the partial last tile."""
    x, carry = _exit_inputs(5)
    tc = [torch.from_numpy(c) for c in carry]
    got = ref.ref_exit_update_split(torch.from_numpy(x), *tc, threshold=0.4,
                                    m=2, n_components=3, tel_bins=1)
    raw = got[6].numpy()       # pred * 1 + bin 0
    np.testing.assert_array_equal(raw, _want_argmax(x))
    assert list(raw[1:4]) == [TILE - 1, 2 * TILE + 10, V - 5]


@pytest.mark.parametrize("tile", [TILE, 1000, 64])
def test_split_exit_update_ints_do_not_depend_on_the_tile(tile):
    """Any tiling gives the plain version's integers: the first-index
    rule holds across partials whatever the tile boundaries."""
    x, carry = _exit_inputs(16, seed=9)
    tc = [torch.from_numpy(c) for c in carry]
    kw = dict(threshold=0.4, m=0, n_components=3, patience_k=2,
              tel_bins=16)
    got = ref.ref_exit_update_split(torch.from_numpy(x), *tc, tile=tile,
                                    **kw)
    plain = ref.ref_exit_update(torch.from_numpy(x), *tc, **kw)
    for name, g, p in zip(NAMES, got, plain):
        if name not in ("conf", "ema"):
            assert torch.equal(g, p), name


# ---------------------------------------------------------------------------
# decode attention: the paged route
# ---------------------------------------------------------------------------

NB, BS, KV, HD, H, NBLK = 12, 8, 2, 32, 4, 8       # W = 64
W = BS * NBLK
# block 0 is the trash block: slot 1's tail is uncovered (trash), slot 2
# reads one block twice, slot 3 is all trash (a dead or empty slot)
TABLE = np.array([[3, 7, 1, 9, 11, 4, 6, 10],
                  [2, 5, 8, 0, 0, 0, 0, 0],
                  [6, 6, 3, 2, 9, 1, 11, 5],
                  [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)


def _ring(t):
    s = np.arange(W)
    return np.where(s <= t, t - ((t - s) % W), -1).astype(np.int32)


# (t, window, live, empty slot): W = 64, chunk 16 (2 blocks a chunk)
PAGED_CASES = {
    "t_below_W": (40, 0, [1, 1, 1, 1], None),
    "t_at_least_W": (150, 0, [1, 1, 1, 1], None),
    "window": (150, 24, [1, 1, 1, 1], None),
    "dead_slot": (150, 0, [1, 1, 1, 0], None),
    "live_row_without_a_visible_key": (40, 0, [1, 1, 1, 1], 3),
}


def _paged_inputs(t, empty, seed=5):
    """q (B, H, hd); a layer slice [1] of stacked (2, NB, bs, KV, hd) k
    and v stores; per-slot (B, W) kpos rings (slot b lags b positions)."""
    rng = np.random.default_rng(seed)
    B = TABLE.shape[0]
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    ks = rng.standard_normal((2, NB, BS, KV, HD)).astype(np.float32)
    vs = rng.standard_normal((2, NB, BS, KV, HD)).astype(np.float32)
    kpos = np.stack([np.maximum(_ring(t) - b, -1) for b in range(B)])
    if empty is not None:
        kpos[empty] = -1
    return q, ks, vs, kpos.astype(np.int32)


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_split_emulator_matches_gathered_view_and_pallas(case):
    t, window, live, empty = PAGED_CASES[case]
    q, ks, vs, kpos = _paged_inputs(t, empty)
    tq, tks, tvs, tp, tt = (torch.from_numpy(x)
                            for x in (q, ks, vs, kpos, TABLE))
    tl = torch.tensor(live, dtype=torch.bool)
    k, v = tks[1], tvs[1]              # a layer slice of a stacked store
    chunk = 16
    paged = ref.ref_decode_attention_split(tq, k, v, t, tp, tl,
                                           window=window, chunk=chunk,
                                           table=tt)
    dense = ref.ref_decode_attention_split(
        tq, ref.ref_paged_gather(k, tt), ref.ref_paged_gather(v, tt), t, tp,
        tl, window=window, chunk=chunk)
    assert torch.equal(paged, dense)       # the same bits, no gather
    jt = jnp.asarray(TABLE)
    jk = jax_paged_gather(jnp.asarray(ks[1]), jt, interpret=True)
    jv = jax_paged_gather(jnp.asarray(vs[1]), jt, interpret=True)
    want = np.asarray(jops.decode_attention_cache(
        jnp.asarray(q[:, None]), jk, jv, t, jnp.asarray(kpos),
        window=window, live=jnp.asarray(np.array(live, bool))))[:, 0]
    np.testing.assert_allclose(paged.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)
    assert not paged[~tl].any()            # dead rows: exact zeros
    if empty is not None:                  # the mean of V over all W rows,
        mean = ref.ref_paged_gather(v, tt)[empty].mean(0)   # trash included
        np.testing.assert_allclose(
            paged[empty].numpy(),
            mean.repeat_interleave(H // KV, 0).numpy(), atol=F32_TOL,
            rtol=F32_TOL)


def test_paged_split_emulator_at_the_kernels_plan():
    """At the serving split (W = 512: 16 chunks of 32 keys, two blocks of
    16 a chunk) the paged read equals the gathered one bit for bit."""
    rng = np.random.default_rng(13)
    B, nblk, bs, t = 2, 32, 16, 700
    q = torch.from_numpy(rng.standard_normal((B, 16, 128))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((70, bs, 2, 128))
                             .astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.integers(0, 70, (B, nblk))
                             .astype(np.int32))
    kpos = torch.from_numpy(np.stack([np.maximum(
        np.where(np.arange(512) <= t, t - ((t - np.arange(512)) % 512), -1)
        - b, -1) for b in range(B)]).astype(np.int32))
    chunk, _ = dattn.split_plan(nblk * bs)
    paged = ref.ref_decode_attention_split(q, k, v, t, kpos, chunk=chunk,
                                           table=table)
    dense = ref.ref_decode_attention_split(
        q, ref.ref_paged_gather(k, table), ref.ref_paged_gather(v, table), t,
        kpos, chunk=chunk)
    assert torch.equal(paged, dense)
    plain = ref.ref_decode_attention(q, ref.ref_paged_gather(k, table),
                                     ref.ref_paged_gather(v, table), t, kpos)
    np.testing.assert_allclose(paged.numpy(), plain.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("bs,dtype,offset,want", [
    (16, torch.bfloat16, 0, "paged"),     # the serving store
    (8, torch.float32, 0, "paged"),
    (32, torch.bfloat16, 0, "paged"),
    (64, torch.bfloat16, 0, "dense"),     # does not divide the 32-key tile
    (12, torch.bfloat16, 0, "dense"),     # not a power of two
    (16, torch.bfloat16, 1, "dense"),     # rows one element off 16 bytes
])
def test_paged_route_follows_block_size_and_alignment(bs, dtype, offset,
                                                      want):
    store = torch.zeros((2, 5, bs, 2, 128 + offset), dtype=dtype)
    k = store[1, ..., offset:]             # a layer slice, maybe unaligned
    table = torch.zeros((4, 2), dtype=torch.int32)
    assert dattn.route(k, k, table) == want
    assert dattn.route(k, k) == "dense"     # no table: (B, W, KV, hd) caches


@pytest.mark.parametrize("bs", [8, 64])
def test_ops_gathers_only_stores_the_paged_route_does_not_take(bs,
                                                               monkeypatch):
    """``ops.decode_attention_cache`` hands foldable stores to the paged
    route (no gather) and gathers the rest; either way on the CPU the
    result is the plain attention over the gathered views, bit for bit."""
    rng = np.random.default_rng(3)
    B, nblk, t = 3, 64 // bs, 50
    k, v = (torch.from_numpy(rng.standard_normal((7, bs, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, 1, 4, 32))
                         .astype(np.float32))
    table = torch.from_numpy(rng.integers(0, 7, (B, nblk)).astype(np.int32))
    kpos = torch.from_numpy(np.stack([np.maximum(_ring(t) - b, -1)
                                      for b in range(B)]))
    gathers = []
    real = ops.paged_gather_kv
    monkeypatch.setattr(ops, "paged_gather_kv",
                        lambda *a: gathers.append(1) or real(*a))
    got = ops.decode_attention_cache(q, k, v, t, kpos, table=table)
    want = ref.ref_decode_attention(q[:, 0], ref.ref_paged_gather(k, table),
                                    ref.ref_paged_gather(v, table), t, kpos)
    assert torch.equal(got[:, 0], want)
    assert len(gathers) == (0 if bs == 8 else 1)
    assert dattn.decode_attention.launches == 0
    assert dattn.decode_attention.launches_by_route == dict.fromkeys(
        dattn.ROUTES, 0)
