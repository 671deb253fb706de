"""Pluggable transport backends behind the Fabric surface (DESIGN.md §14).

One ABC (:class:`Transport`) and, in this port so far, one backend:

========  =====================  ==========================================
backend   processes              mechanism
========  =====================  ==========================================
sim       one (deterministic)    in-process bounded deques, latency model
========  =====================  ==========================================

The reference's ``shm`` and ``socket`` backends, the chaos wrapper and
the binary codec are not ported yet: selecting them raises
:class:`~repro_torch.core.attrs.AttrError` at cluster construction (see
:mod:`repro_torch.core.runtime`).  Backends register lazily, as in the
reference.
"""
from .base import (FABRIC_ATTRS, Transport, backend_class, make_transport,
                   register_backend)
from .wire import PACKED_KINDS, PackedBurst, WireKind, WireMsg, msg_weight

__all__ = [
    "FABRIC_ATTRS",
    "Transport",
    "backend_class",
    "make_transport",
    "register_backend",
    "PACKED_KINDS",
    "PackedBurst",
    "WireKind",
    "WireMsg",
    "msg_weight",
]


def _load_sim():
    from .sim import Fabric
    return Fabric


register_backend("sim", _load_sim)
