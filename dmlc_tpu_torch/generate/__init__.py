"""Generation: continuous batching over a paged KV cache.

- ``kvcache``  — page pool, free-list allocator, per-slot page tables
- ``engine``   — fixed-shape decode/prefill over the paged cache
- ``slots``    — step-level slot scheduler (join/leave between steps)
- ``worker``   — ``job.generate`` RPC surface + chunk-poll token streaming
"""

from dmlc_tpu_torch.generate.kvcache import PageAllocator, PagedKVCache, PagePoolExhausted

__all__ = ["PageAllocator", "PagedKVCache", "PagePoolExhausted"]
