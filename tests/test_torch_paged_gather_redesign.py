"""The redesigned paged gather (bulk copies by the copy engine), pinned on
the CPU.

The kernel does not run here (no card), so its unit order is emulated in
plain torch (``ref.ref_paged_gather_bulk``: the blocks of the units
(store, slot, ring block) cut into ``paged_gather.boxes`` copies of at
most 16 KB, the boxes split over persistent CTAs by
``paged_gather.plan``, the source read at the store's block stride) and
held bit for bit against the plain version and the JAX package's Pallas
kernel (interpret mode, as
``tests/test_torch_paged.py::test_paged_gather_matches_pallas`` runs it)
on the same numpy inputs, at block sizes 16 and 64 in bf16 and f32: a
gather is a copy, so every comparison is exact.  The tables hold trash
ids, duplicate ids and an all-trash row; the stores are layer slices of
stacked stores, one of them with a block stride past its block size.
The wrapper's refusal of a store the bulk copy cannot read (16-byte
alignment) is checked here too: it comes before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_gather import paged_gather as jax_paged_gather
from repro_torch.kernels import build
from repro_torch.kernels import paged_gather as pg
from repro_torch.kernels import ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs in parallel workers
    on a few cores, where these small ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(rng, B, nblk, NB):
    t = rng.integers(1, NB, (B, nblk)).astype(np.int32)
    t[1, nblk // 2:] = 0                 # an uncovered ring range: trash
    t[B - 1] = 0                         # a dead slot: all trash
    t[0, :2] = t[0, nblk - 1]            # duplicate ids
    return t


# (block size, kv heads, head dim): 16 and 64 positions a block; the
# 64-position f32 block (64 KB at kv 2, hd 128) takes four boxes
SHAPES = {"bs16": (16, 2, 32), "bs64": (64, 2, 128)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("n_ctas", [1, 5, 132])
def test_bulk_emulator_matches_plain_and_pallas(shape, dtype, n_ctas):
    bs, kv, hd = SHAPES[shape]
    B, nblk, NB = 3, 4, 9
    rng = np.random.default_rng(bs * 7 + n_ctas)
    stacked = rng.standard_normal((2, NB, bs, kv, hd)).astype(np.float32)
    table = _table(rng, B, nblk, NB)
    tdt = getattr(torch, dtype)
    ts = torch.from_numpy(stacked).to(tdt)
    k, v = ts[1], (ts[0] + 1).contiguous()     # a layer slice; another
    ttable = torch.from_numpy(table)
    got_k, got_v = ref.ref_paged_gather_bulk([k, v], ttable, n_ctas)
    (one,) = ref.ref_paged_gather_bulk([v], ttable, n_ctas)
    for got, store in ((got_k, k), (got_v, v), (one, v)):
        assert got.shape == (B, nblk * bs, kv, hd) and got.dtype == tdt
        assert torch.equal(got, ref.ref_paged_gather(store, ttable))
        want = jax_paged_gather(
            jnp.asarray(store.float().numpy()).astype(dtype),
            jnp.asarray(table), interpret=True)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got_k[B - 1], k[0].expand(nblk, -1, -1, -1)
                       .reshape(nblk * bs, kv, hd))


def test_bulk_emulator_reads_the_block_stride():
    """A store whose blocks lie two block sizes apart (every other block of
    an interleaved (NB, 2, bs, kv, hd) buffer) is read where it lies."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(
        rng.standard_normal((6, 2, 16, 1, 64)).astype(np.float32))
    store = buf[:, 1]
    assert store.stride(0) == 2 * store[0].numel()
    table = torch.from_numpy(_table(rng, 3, 5, 6))
    (got,) = ref.ref_paged_gather_bulk([store], table, 4)
    assert torch.equal(got, ref.ref_paged_gather(store.contiguous(), table))


@pytest.mark.parametrize("n_items,n_ctas", [(1, 1), (10, 3), (256, 132),
                                            (2048, 132), (5, 132)])
def test_plan_covers_the_items_in_order(n_items, n_ctas):
    ranges = pg.plan(n_items, n_ctas)
    assert len(ranges) == n_ctas
    pos = 0
    for start, stop in ranges:
        assert start == pos and start <= stop
        pos = stop
    assert pos == n_items
    sizes = [b - a for a, b in ranges]
    assert max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("block_bytes,n_boxes", [
    (8192, 1),         # bs 16, kv 2, hd 128, bf16: the serving block
    (16384, 1),        # one whole box
    (32768, 2),        # bs 64 bf16: two boxes
    (65536, 4),        # bs 64 f32
    (16400, 2)])       # a 16-byte tail box
def test_boxes_split_a_block(block_bytes, n_boxes):
    bx = pg.boxes(block_bytes)
    assert len(bx) == n_boxes
    assert bx[0][0] == 0 and sum(size for _, size in bx) == block_bytes
    for (o1, s1), (o2, _) in zip(bx, bx[1:]):
        assert o1 + s1 == o2
    assert all(0 < size <= pg.BOX and size % 16 == 0 and off % 16 == 0
               for off, size in bx)


UNALIGNED = {
    # a base 8 bytes off a 16-byte boundary
    "base": lambda: torch.zeros(4 * 16 * 2 * 64 + 4, dtype=torch.bfloat16)
    [4:].view(4, 16, 2, 64),
    # 30-byte blocks (bs 3, kv 1, hd 5 in bf16)
    "block_size": lambda: torch.zeros((4, 3, 1, 5), dtype=torch.bfloat16),
    # 16-byte blocks 40 bytes apart
    "block_stride": lambda: torch.zeros(40).as_strided((4, 1, 1, 4),
                                                       (10, 4, 4, 1)),
}


@pytest.mark.parametrize("case", list(UNALIGNED))
def test_wrapper_refuses_an_unaligned_store(case, monkeypatch):
    """The bulk copy moves 16-byte aligned bytes only: such a store is
    refused before the launch, never copied another way, alone or as the
    second store of a k/v pair; the launch count stays.  The device check
    (the launch's first step) is passed over here, so CPU tensors reach
    the refusal."""
    monkeypatch.setattr(build, "require_cuda", lambda what, *t: None)
    store = UNALIGNED[case]()
    assert not pg.aligned(store)
    table = torch.ones((2, 3), dtype=torch.int32)
    before = pg.paged_gather.launches
    for stores in ([store], [torch.zeros_like(store), store]):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pg._gather(stores, table)
    assert pg.paged_gather.launches == before


def test_aligned_stores_pass_the_check():
    """The serving stores and a layer slice of a stacked store are
    aligned; the CPU wrappers take the plain version."""
    for shape in ((769, 16, 2, 128), (193, 64, 2, 128), (9, 8, 2, 16)):
        store = torch.zeros((2,) + shape, dtype=torch.bfloat16)[1]
        assert pg.aligned(store)
    table = torch.tensor([[1, 0], [2, 2]], dtype=torch.int32)
    store = torch.arange(3 * 16 * 2 * 8, dtype=torch.float32).view(
        3, 16, 2, 8)
    assert torch.equal(pg.paged_gather(store, table),
                       ref.ref_paged_gather(store, table))
