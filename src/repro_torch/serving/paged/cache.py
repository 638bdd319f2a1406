"""Paged cascade KV cache: shared block stores + per-(component, slot)
block tables.

The counterpart of the JAX package's ``serving/paged/cache.py``.  The
dense layout keeps one worst-case ``(B, W)`` slab per lane; the paged
layout replaces the slab's attention k/v leaves with SHARED stores shaped
``(n_layers, num_blocks, block_size, kv_heads, head_dim)`` on the engine's
device, addressed through per-slot block tables (one row per cascade
component) carried in :class:`repro_torch.core.exec.DecodeState`:

::

    DecodeState.block_tables          (K components, B slots, W/bs)  int32
        |                                        .-------------------.
        | table[m, b, j] = physical block id --> | store[:, id]      |
        |   (0 = trash: slot b owns no block     |  (n, bs, kv, hd)  |
        |    for ring range j of component m)    '-------------------'

Ring position ``p`` of slot ``b`` lives at ``(table[m, b, p // bs],
p % bs)``.  One :class:`~repro_torch.serving.paged.pool.BlockPool` free
list serves the whole engine, so memory freed by one lane's exits admits
the next request on any lane.  Coherence is by masking, not zeroing: each
slot carries its own ``(B, W)`` kpos row, and ring positions a slot never
wrote are masked out of its attention, so freed blocks rebind with no
device traffic at all.

Where the reference threads the stores through donated jit calls and
adopts them back after each, the port writes them in place: every lane
composes its cache from the same store tensors and keeps only its own
kpos ring (:meth:`PagedCascadeCache.lane_cache`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import nn
from repro_torch.serving.paged.pool import TRASH_BLOCK, BlockPool


def _stage_is_kv(stage_cache) -> bool:
    """A stage cache shaped like one the paged layout can address: exactly
    {'k', 'v'} leaves of shape (n_layers, B, W, kv_heads, head_dim)."""
    if not isinstance(stage_cache, dict):
        return False
    if set(stage_cache.keys()) != {"k", "v"}:
        return False
    return all(v.dim() == 5 for v in stage_cache.values())


def _stage_kinds(model, si, stages):
    """``model.leaf_kinds`` of segment ``si`` split into each stage's
    entries."""
    kinds = iter(model.leaf_kinds(si, stages))
    return [[next(kinds) for _ in nn.tree_leaves(stage)] for stage in stages]


class PagedCascadeCache:
    """Builds and books the paged layout for one serving engine: the
    shared device stores, the host block-table mirrors per lane, and the
    per-(lane, slot, component) allocation map the release accounting
    reads.  All methods are host-side; the only device work is copying a
    lane's ``(K, B, nblk)`` table to the device when its rows changed."""

    def __init__(self, model, cfg, lane_batch: int, n_lanes: int,
                 cache_len: int):
        pc = cfg.paged_cache
        self.cfg = cfg
        self.device = model.device
        self.lane_batch = lane_batch
        self.n_lanes = n_lanes
        self.W = model.cache_capacity(cache_len)
        self.block_size = pc.block_size
        if self.W % self.block_size:
            raise ValueError(
                f"paged_cache.block_size={pc.block_size} must divide the "
                f"cache capacity W={self.W} (cache_len={cache_len}, "
                f"attn_window={cfg.attn_window})")
        if cfg.n_experts:
            raise ValueError(
                "cache_layout='paged' does not support MoE configs: expert "
                "capacity couples batch rows, so a dead slot's trash-block "
                "garbage becomes observable in live rows and breaks the "
                "dense-ablation bit-identity contract")
        self.nblk = self.W // self.block_size
        self.K = cfg.cascade.n_components

        # the stores mirror init_cache's (segments x stages) structure with
        # the (B, W) slab dims of every k/v ring leaf replaced by
        # (num_blocks, block_size); any other cache kind (a Mamba2 layer's
        # ssm state and conv window, an xattn layer's read-only cross K/V
        # over T memory rows, ...) has no ring to page — reject rather
        # than keep a dense slab next to the paged one.  The template is
        # shapes only (meta tensors)
        template = model.init_cache(lane_batch, cache_len, device="meta")
        for si, stages in enumerate(template["segments"]):
            kinds = None
            for pi, stage in enumerate(stages):
                what = (list(stage) if isinstance(stage, dict)
                        else type(stage).__name__)
                if not _stage_is_kv(stage):
                    raise ValueError(
                        f"cache_layout='paged' needs every cache leaf to be "
                        f"an attention k/v ring; segment {si} of family "
                        f"{cfg.family!r} has a non-attention cache stage "
                        f"({what}). Use cache_layout='dense' for this "
                        f"config.")
                # a ring stage by the model's leaf kinds, not by its keys:
                # an xattn layer's k/v are read-only, T memory rows long
                kinds = kinds or _stage_kinds(model, si, stages)
                if kinds[pi] != ["ring"] * len(kinds[pi]):
                    what_kind = ("read-only" if set(kinds[pi]) == {"read"}
                                 else "/".join(kinds[pi]))
                    raise ValueError(
                        f"cache_layout='paged' cannot page a {what_kind} "
                        f"cache stage: segment {si} of family "
                        f"{cfg.family!r} has a stage ({what}) whose leaves "
                        f"a decode step does not write at a ring slot "
                        f"({stage['k'].shape[2]} rows, written at prefill "
                        f"and only read after), which a {self.W}-row "
                        f"paged ring cannot hold. Use cache_layout='dense' "
                        f"for this config.")

        dense_equiv = n_lanes * lane_batch * self.K * self.nblk
        num_blocks = pc.num_blocks or (dense_equiv + 1)
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2, got {num_blocks}")

        # one block id occupies its planes in every segment's stores, so a
        # block is priced across all of them (as the reference prices it)
        bytes_per_block = 0
        segs = []
        for stages in template["segments"]:
            built = []
            for stage in stages:
                n, _B, _W, kv, hd = stage["k"].shape
                dtype = stage["k"].dtype
                shape = (n, num_blocks, self.block_size, kv, hd)
                built.append({
                    "k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device),
                })
                bytes_per_block += (2 * n * self.block_size * kv * hd
                                    * stage["k"].element_size())
            segs.append(built)
        self.segments = segs
        self.pool = BlockPool(num_blocks, self.block_size,
                              block_bytes=bytes_per_block)
        # the dense ablation's always-resident footprint, for stats()
        self.dense_slab_bytes = dense_equiv * bytes_per_block

        # host mirrors: per-lane (K, B, nblk) tables, all rows at trash
        self._tables = [np.zeros((self.K, lane_batch, self.nblk), np.int32)
                        for _ in range(n_lanes)]
        self._dev_tables: List[Optional[torch.Tensor]] = [None] * n_lanes
        # (lane, slot) -> {segment: {ring_block_index: physical id}}
        self._allocs: Dict[Tuple[int, int], Dict[int, Dict[int, int]]] = {}

    # ------------------------------------------------------------------
    # coverage planning
    # ------------------------------------------------------------------
    def coverage(self, start: int, stop: int) -> List[int]:
        """Ring-block indices backing positions [start, stop) — clipped to
        the last W positions (earlier ones are overwritten by the ring
        before they could be read)."""
        lo = max(start, stop - self.W, 0)
        if lo >= stop:
            return []
        ps = np.arange(lo, stop)
        return sorted(set(((ps % self.W) // self.block_size).tolist()))

    def blocks_needed(self, start: int, stop: int) -> int:
        """Pool blocks a slot spanning positions [start, stop) claims, over
        all K components."""
        return len(self.coverage(start, stop)) * self.K

    def fits_ever(self, start: int, stop: int) -> bool:
        return self.blocks_needed(start, stop) <= self.pool.num_blocks - 1

    def can_admit(self, n_blocks: int) -> bool:
        return self.pool.can_alloc(n_blocks)

    # ------------------------------------------------------------------
    # slot lifecycle
    # ------------------------------------------------------------------
    def alloc_slot(self, lane: int, slot: int, start: int,
                   stop: int) -> bool:
        """Bind fresh blocks covering positions [start, stop) for every
        component of (lane, slot).  All-or-nothing: on pool exhaustion
        nothing is claimed and the caller backpressures admission."""
        assert (lane, slot) not in self._allocs, \
            f"slot ({lane}, {slot}) admitted twice"
        js = self.coverage(start, stop)
        ids = self.pool.alloc(len(js) * self.K)
        if ids is None:
            return False
        table = self._tables[lane]
        per_seg: Dict[int, Dict[int, int]] = {}
        it = iter(ids)
        for m in range(self.K):
            per_seg[m] = {j: next(it) for j in js}
            for j, b in per_seg[m].items():
                table[m, slot, j] = b
        self._allocs[(lane, slot)] = per_seg
        self._dev_tables[lane] = None
        return True

    def release_slot(self, lane: int, slot: int,
                     max_exit_depth: Optional[int] = None):
        """Return (lane, slot)'s blocks to the pool.  Components deeper
        than the slot's observed max exit depth count as
        ``reclaimed_by_exit``, the rest as ``reclaimed_at_retire``.  Table
        rows repoint at the trash block so the dead slot's masked writes
        stay harmless."""
        per_seg = self._allocs.pop((lane, slot), None)
        if per_seg is None:
            return
        if max_exit_depth is None:
            max_exit_depth = self.K - 1
        table = self._tables[lane]
        for m, blocks in per_seg.items():
            if blocks:
                self.pool.free(list(blocks.values()),
                               by_exit=m > max_exit_depth)
            for j in blocks:
                table[m, slot, j] = TRASH_BLOCK
        self._dev_tables[lane] = None

    def slot_blocks(self, lane: int, slot: int) -> int:
        per_seg = self._allocs.get((lane, slot))
        if not per_seg:
            return 0
        return sum(len(b) for b in per_seg.values())

    # ------------------------------------------------------------------
    # device views
    # ------------------------------------------------------------------
    def device_tables(self, lane: int) -> torch.Tensor:
        """The lane's (K, B, nblk) int32 tables on the device, copied
        again only after its rows changed."""
        if self._dev_tables[lane] is None:
            # a copy, never a view of the host mirror (which changes)
            self._dev_tables[lane] = torch.tensor(self._tables[lane],
                                                  device=self.device)
        return self._dev_tables[lane]

    def lane_cache(self, kpos: torch.Tensor) -> dict:
        """A lane's cache: its private per-slot kpos ring over the
        engine-shared stores."""
        return {"kpos": kpos, "segments": self.segments}

    def fresh_kpos(self) -> torch.Tensor:
        return torch.full((self.lane_batch, self.W), -1, dtype=torch.int32,
                          device=self.device)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        out = self.pool.stats()
        out.update({
            "cache_layout": "paged",
            "nblk_per_slot": self.nblk,
            "dense_slab_bytes": self.dense_slab_bytes,
        })
        return out
