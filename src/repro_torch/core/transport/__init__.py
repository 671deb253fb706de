"""Pluggable transport backends behind the Fabric surface (DESIGN.md §14).

One ABC (:class:`Transport`), three backends selected through the
``fabric_backend`` attr:

========  =====================  ==========================================
backend   processes              mechanism
========  =====================  ==========================================
sim       one (deterministic)    in-process bounded deques, latency model
shm       one host, N processes  SPSC shared-memory rings in ``/dev/shm``
socket    cross-host fallback    Unix-domain stream sockets, codec frames
========  =====================  ==========================================

Backends register lazily: importing this package never touches mmap or
socket machinery until a backend is actually constructed.

The frames ``shm`` and ``socket`` carry are the reference's, byte for
byte (:mod:`.codec`).  A CUDA payload crosses to the host once a frame
when it is encoded; ``sim`` passes tensors through untouched.
"""
from .base import (FABRIC_ATTRS, Transport, backend_class, make_transport,
                   register_backend)
from .chaos import (CHAOS_ATTRS, ChaosConfig, ChaosTransport,
                    maybe_wrap_chaos)
from .codec import CodecError, decode_msg, encode_msg, frame_bytes
from .wire import (PACKED_KINDS, PackedBurst, WireKind, WireMsg, msg_weight,
                   to_card, to_host)

__all__ = [
    "FABRIC_ATTRS",
    "Transport",
    "backend_class",
    "make_transport",
    "register_backend",
    "CHAOS_ATTRS",
    "ChaosConfig",
    "ChaosTransport",
    "maybe_wrap_chaos",
    "CodecError",
    "decode_msg",
    "encode_msg",
    "frame_bytes",
    "PACKED_KINDS",
    "PackedBurst",
    "WireKind",
    "WireMsg",
    "msg_weight",
    "to_card",
    "to_host",
]


def _load_sim():
    from .sim import Fabric
    return Fabric


def _load_shm():
    from .shm import ShmTransport
    return ShmTransport


def _load_socket():
    from .socket import SocketTransport
    return SocketTransport


register_backend("sim", _load_sim)
register_backend("shm", _load_shm)
register_backend("socket", _load_socket)
