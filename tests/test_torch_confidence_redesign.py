"""The confidence kernel's cluster split, pinned on the CPU.

The kernel (``csrc/confidence.cu``) does not run here (no card), so its
arithmetic is emulated in plain torch: ``ref.ref_confidence_cluster(x, C)``
cuts each row into the C column ranges of ``confidence.ranges(V, C)`` (one
per CTA of the row's cluster), reduces each to a (max, Σexp, first-argmax)
partial and merges the partials in rank order, as the cluster's rank 0
does.  It is held, on the same numpy inputs (``np.random.default_rng``),
against the JAX package's Pallas kernel ``repro.kernels.confidence.
confidence`` in interpret mode (as ``tests/test_kernels.py`` runs it) and
against the port's plain version ``ref.ref_confidence``.

Tolerances, all f32: argmaxes exactly; the emulator's δ within 1e-6
relative of the exact δ (numpy float64 on the same f32 logits; it is
~3e-7 off at V = 151936), and within 2e-6 of the JAX kernel's: that one
sums its 2048-column tiles one after another in f32 and is itself up to
9.2e-7 off the exact δ at V = 151936 (1.1e-6 from the emulator's).
``ref_confidence`` computes δ as exp(m − lse), and lse rounds to f32 at
its own magnitude, so against it δ agrees within 1e-6 plus 2**-23 |lse|
relative (~2e-6 at V = 151936).

The cases: B in {1, 4, 17}; V = 151936 (qwen2.5's vocabulary), 151933
(not a whole number of 16-byte chunks), 10 and 100 (the paper's image
heads); every cluster size C in {1, 2, 4, 8, 16}; rows by role: a tie
straddling the edge of CTA 0's range, a tie across the first and last
ranges, a tie inside one range, a confident row, a row of equal logits
(δ = 1/V) and noise; ranges left empty when V < 8 C.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.confidence import confidence as jax_confidence
from repro_torch.kernels import ref
from repro_torch.kernels.confidence import (CTA_COLS, MAX_CLUSTER, UNIT,
                                            GROUP_COLS, plan, ranges)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads
    and would slow the other workers' timed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXACT_RTOL = 1e-6
JAX_RTOL = 2e-6
CLUSTERS = (1, 2, 4, 8, 16)
VOCABS = (151936, 151936 - 3, 10, 100)
ROLES = ("straddle", "across", "inside", "confident", "equal", "noise")


def _tie_columns(V, C):
    """(straddle, across, inside) tie columns for the split of V over C:
    the two columns either side of the end of CTA 0's range (the row's
    last two when C = 1 or CTA 0 holds the row), column 1 and the row's
    last (ranges 0 and the last non-empty one), columns 1 and 3 (range
    0)."""
    e = ranges(V, C)[0][1]
    straddle = (e - 1, e) if e < V else (V - 2, V - 1)
    return straddle, (1, V - 1), (1, 3)


@functools.lru_cache(maxsize=None)
def _case(B, V, C, seed=0):
    """The logits (numpy f32) and the JAX kernel's (argmax, δ) on them."""
    rng = np.random.default_rng(seed + 7 * B + V)
    x = rng.standard_normal((B, V)).astype(np.float32)
    straddle, across, inside = _tie_columns(V, C)
    for b in range(B):
        role = ROLES[b % len(ROLES)]
        top = x[b].max() + 9.0
        if role == "straddle":
            x[b, list(straddle)] = top
        elif role == "across":
            x[b, list(across)] = top
        elif role == "inside":
            x[b, list(inside)] = top
        elif role == "confident":
            x[b, V // 3] += 14.0
        elif role == "equal":
            x[b] = 0.5
    idx, delta = jax_confidence(jnp.asarray(x), interpret=True)
    return x, np.asarray(idx), np.asarray(delta)


def _first_argmax(x):
    return np.argmax(x, axis=-1).astype(np.int32)


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("B", [1, 4, 17])
def test_cluster_split_matches_jax_and_plain(B, V, C):
    x, j_idx, j_delta = _case(B, V, C)
    tx = torch.from_numpy(x)
    idx, delta = ref.ref_confidence_cluster(tx, C)
    p_idx, p_delta = ref.ref_confidence(tx)
    assert idx.dtype == torch.int32 and delta.dtype == torch.float32
    assert idx.shape == delta.shape == (B,)
    want = _first_argmax(x)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(j_idx, want)
    assert torch.equal(idx, p_idx)
    x64 = x.astype(np.float64)
    m = x64.max(-1)
    s = np.exp(x64 - m[:, None]).sum(-1)
    np.testing.assert_allclose(delta.numpy(), 1.0 / s, rtol=EXACT_RTOL,
                               atol=0)
    np.testing.assert_allclose(delta.numpy(), j_delta, rtol=JAX_RTOL, atol=0)
    err = np.abs(delta.numpy() / p_delta.numpy() - 1.0)
    assert (err <= EXACT_RTOL + 2.0 ** -23 * np.abs(m + np.log(s))).all(), \
        err.max()


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("C", CLUSTERS)
def test_ties_take_the_first_index_across_cta_ranges(C, V):
    """Every tie resolves to its first column, inside one CTA's range,
    across two ranges and straddling a range edge; a row of equal logits
    gives argmax 0 and δ = 1/V."""
    x, j_idx, j_delta = _case(len(ROLES), V, C)
    idx, delta = ref.ref_confidence_cluster(torch.from_numpy(x), C)
    straddle, across, inside = _tie_columns(V, C)
    got = dict(zip(ROLES, idx.tolist()))
    assert got["straddle"] == straddle[0]
    assert got["across"] == across[0] and got["inside"] == inside[0]
    assert got["equal"] == 0
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    d_equal = delta[ROLES.index("equal")]
    assert float(d_equal) == pytest.approx(1.0 / V, rel=EXACT_RTOL)
    assert float(j_delta[ROLES.index("equal")]) == pytest.approx(
        1.0 / V, rel=EXACT_RTOL)
    if C > 1 and V > UNIT:
        r0 = ranges(V, C)[0]
        assert r0[0] <= straddle[0] < r0[1] <= straddle[1]


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("V", [1, 7, 8, 10, 100, 127, 4096, 151933, 151936])
def test_ranges_cut_the_row_in_aligned_units(V, C):
    """C contiguous, disjoint ranges covering [0, V) in rank order; every
    start a multiple of 8 columns (16-byte aligned in bf16 and f32); sizes
    within one unit of each other but for the row's ragged end; empty
    ranges ([V, V)) only at the end, and exactly when the row has fewer
    8-column units than C."""
    rs = ranges(V, C)
    assert len(rs) == C
    assert rs[0][0] == 0 and rs[-1][1] == V
    for (a0, a1), (b0, b1) in zip(rs, rs[1:]):
        assert a1 == b0
    for c0, c1 in rs:
        assert c0 <= c1 and (c0 % UNIT == 0 or c0 == c1 == V)
    units = -(-V // UNIT)
    sizes = [-(-(c1 - c0) // UNIT) for c0, c1 in rs]
    assert max(sizes) - min(sizes) <= 1
    empty = [c0 == c1 for c0, c1 in rs]
    assert sum(empty) == max(0, C - units)
    assert empty == sorted(empty)
    assert (sum(empty) > 0) == (units < C)


def test_plan_picks_a_cluster_from_the_vocabulary():
    """C = 1 for rows of at most GROUP_COLS columns (a lane group a row);
    else the smallest power of two up to MAX_CLUSTER that leaves a CTA at
    most CTA_COLS columns; never smaller for a longer row."""
    for V in (1, 10, 100, GROUP_COLS):
        assert plan(V) == 1
    prev = 1
    for V in (GROUP_COLS + 1, 4096, 8192, 8193, 32000, 65536, 151933, 151936,
              256000, 10 ** 7):
        C = plan(V)
        assert C in (1, 2, 4, 8, 16) and C >= prev
        assert C == MAX_CLUSTER or -(-V // C) <= CTA_COLS
        assert C == 1 or -(-V // (C // 2)) > CTA_COLS
        prev = C
    assert plan(151936) == MAX_CLUSTER
