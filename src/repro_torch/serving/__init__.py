"""Continuous batching over a slot-recycled paged KV cache: ``paged_cache``
owns the storage, ``decode`` the math, ``engine`` the loop."""
from repro_torch.serving.paged_cache import (PagedCacheSpec, PageAllocator,
                                             init_pages)
from repro_torch.serving.decode import (ATTN_IMPLS, paged_attention_decode,
                                        paged_decode_step)
from repro_torch.serving.engine import (Request, ServeReport,
                                        ContinuousServer, poisson_trace,
                                        sample_requests, static_serve_trace)

__all__ = [
    "PagedCacheSpec", "PageAllocator", "init_pages",
    "ATTN_IMPLS", "paged_attention_decode", "paged_decode_step",
    "Request", "ServeReport", "ContinuousServer",
    "poisson_trace", "sample_requests", "static_serve_trace",
]
