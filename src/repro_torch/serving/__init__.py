"""Serving on the port: the decode/prefill engine for every family (the
vlm and audio ones with a cross-KV cache from ``precompute_cross_kv``),
the paged KV allocator, the continuous-batching
scheduler, and serving on the comm core (``ContinuousBatcher``,
``ServePlane``, ``TokenClient``) with each tick's tokens on the engine's
device.  On a mesh (``spmd_map``) the engine runs the reference's
tensor-parallel, ``joint_kv`` and ``tp2d`` decode, the cache cut by
``cache_pspecs``."""
from .engine import DecodeCache, cache_pspecs, init_cache, \
    make_prefill_step, make_serve_step
from .kv_cache import PagedKVAllocator
from .scheduler import Request, ResultDrain, ServeScheduler, ServeTransport
from .result_tokens import (ResultTokens, SlotData, decode_token_row,
                            encode_token_row)
from .slots import SERVING_ATTRS, SlotAllocator
from .batching import (ContinuousBatcher, ServePlane, SyntheticModel,
                       TokenClient)

__all__ = ["DecodeCache", "init_cache", "make_serve_step",
           "make_prefill_step", "cache_pspecs", "PagedKVAllocator", "Request",
           "ResultDrain", "ServeScheduler", "ServeTransport",
           "ResultTokens", "SlotData", "encode_token_row",
           "decode_token_row", "SERVING_ATTRS", "SlotAllocator",
           "ContinuousBatcher", "ServePlane", "SyntheticModel",
           "TokenClient"]
