"""Free-list block pool for the paged KV cache.

A copy of the JAX package's ``serving/paged/pool.py`` (pure Python; the
port keeps its own so that it imports nothing of that package).

One :class:`BlockPool` owns the physical block ID space of a serving
engine's shared stores — blocks are fungible across lanes, slots and
cascade components (the SHARK-Engine ``BlockCache`` shape: a flat free
list, claim/release, no per-consumer partitions).  Block 0 is the
reserved *trash block*: dead slots' block-table entries point at it so
their (masked, never-read) decode writes land somewhere harmless instead
of corrupting a reallocated block.

The pool is host-side bookkeeping only — allocation never touches the
device.  What makes it cascade-aware is the accounting split on release:
blocks that backed components *deeper than the slot's observed exit
depth* count as ``reclaimed_by_exit`` (the cascade never computed those
components for this slot; their blocks only mirrored backfill state),
the rest as ``reclaimed_at_retire``.  Reclamation happens at the first
host sync after a slot finishes — the chunk boundary — NOT at the next
whole-lane re-prefill (DESIGN.md, "In-chunk reclamation").
"""
from __future__ import annotations

from typing import List, Optional

TRASH_BLOCK = 0


class BlockPool:
    """Flat free list over ``num_blocks`` fixed-size KV blocks.

    ``block_size`` is ring positions per block; ``block_bytes`` (set by the
    PagedCascadeCache) prices one block across every component's k/v planes so
    ``peak_cache_bytes`` in :meth:`stats` is an honest HBM figure.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 block_bytes: int = 0):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.block_bytes = int(block_bytes)
        # LIFO free list, block 0 (trash) never enters it
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self.used = 0
        self.peak_used = 0
        self.reclaimed_by_exit = 0
        self.reclaimed_at_retire = 0
        # soft admission cap for cross-engine block donation: a tier can
        # lower one pool's cap and raise another's without moving physical
        # stores (they can't move — each engine's device buffers are its
        # own).  None = the physical limit.  Only ADMISSION honors the
        # cap; blocks already allocated above a newly lowered cap stay
        # valid and drain naturally at retire.
        self.soft_cap: Optional[int] = None
        # per-chunk reclamation window (engine calls begin_chunk per
        # dispatch; end_chunk returns blocks freed since)
        self._chunk_mark = 0
        self.chunk_reclaims: List[int] = []

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _cap_free(self) -> int:
        """Blocks an allocation may still claim under the soft cap."""
        if self.soft_cap is None:
            return len(self._free)
        return min(len(self._free), max(0, self.soft_cap - self.used))

    def set_soft_cap(self, cap: Optional[int]):
        """Donate/reclaim capacity: cap usable blocks at ``cap`` (None
        lifts the cap).  The trash block is outside the budget; caps above
        the physical allocatable count are clamped, never an error —
        donation is advisory, the free list stays authoritative."""
        if cap is None:
            self.soft_cap = None
            return
        cap = int(cap)
        if cap < 0:
            raise ValueError(f"soft_cap must be >= 0, got {cap}")
        self.soft_cap = min(cap, self.num_blocks - 1)

    def can_alloc(self, n: int) -> bool:
        return n <= self._cap_free()

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` blocks, or None (no partial grants — the caller
        backpressures admission instead of corrupting a half-covered
        slot)."""
        if n > self._cap_free():
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.used += n
        self.peak_used = max(self.peak_used, self.used)
        return ids

    def free(self, ids: List[int], by_exit: bool = False):
        for b in ids:
            if b == TRASH_BLOCK:
                raise ValueError("attempt to free the trash block")
            self._free.append(b)
        self.used -= len(ids)
        if by_exit:
            self.reclaimed_by_exit += len(ids)
        else:
            self.reclaimed_at_retire += len(ids)

    # -- per-chunk reclamation telemetry --------------------------------
    def begin_chunk(self):
        self._chunk_mark = self.reclaimed_by_exit + self.reclaimed_at_retire

    def end_chunk(self) -> int:
        freed = (self.reclaimed_by_exit + self.reclaimed_at_retire
                 - self._chunk_mark)
        self.chunk_reclaims.append(freed)
        return freed

    def reset_window(self):
        """Clear the per-chunk reclaim window (engine ``reset_metrics``).
        ``peak_used`` and the lifetime reclaim counters survive: peak
        occupancy is high-water capacity accounting, the same split that
        keeps ``compile_seconds`` out of the decode window."""
        self.chunk_reclaims.clear()
        self._chunk_mark = self.reclaimed_by_exit + self.reclaimed_at_retire

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "block_bytes": self.block_bytes,
            "blocks_free": self.free_blocks,
            "blocks_used": self.used,
            "peak_blocks_used": self.peak_used,
            "soft_cap": self.soft_cap,
            "reclaimed_by_exit": self.reclaimed_by_exit,
            "reclaimed_at_retire": self.reclaimed_at_retire,
            "blocks_reclaimed_per_chunk": list(self.chunk_reclaims[-32:]),
            "peak_cache_bytes": self.peak_used * self.block_bytes,
        }
