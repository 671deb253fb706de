"""Serving on the port: the decode/prefill engine for the dense, moe, ssm
and hybrid families, the paged KV allocator and the continuous-batching
scheduler.

Still to port (ROADMAP A6): ``batching`` (``ContinuousBatcher``,
``ServePlane``), ``slots`` and ``result_tokens``; ``cache_pspecs`` waits
for the multi-rank ``Comm`` (A7)."""
from .engine import DecodeCache, init_cache, make_prefill_step, \
    make_serve_step
from .kv_cache import PagedKVAllocator
from .scheduler import Request, ResultDrain, ServeScheduler, ServeTransport

__all__ = ["DecodeCache", "init_cache", "make_serve_step",
           "make_prefill_step", "PagedKVAllocator", "Request",
           "ResultDrain", "ServeScheduler", "ServeTransport"]
