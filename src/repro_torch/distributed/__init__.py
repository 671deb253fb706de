"""Distributed layer of the port.  So far only the single-device
``Comm`` (``local_comm()``); the multi-rank ``Comm`` on
``torch.distributed``, the pipeline and the resilience features are
still to port (ROADMAP A4, A6)."""
from .comm import Comm, local_comm

__all__ = ["Comm", "local_comm"]
