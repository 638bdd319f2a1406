"""Skip-aware paged KV cache for the cascade serving engine.

``BlockPool`` owns the physical block free list; ``PagedCascadeCache``
builds the shared stores and per-lane block tables and books the per-slot
allocations.
"""
from repro_torch.serving.paged.cache import PagedCascadeCache
from repro_torch.serving.paged.pool import TRASH_BLOCK, BlockPool

__all__ = ["BlockPool", "PagedCascadeCache", "TRASH_BLOCK"]
