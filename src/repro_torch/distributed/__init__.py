"""Distributed layer of the port.  So far only the single-device
``Comm`` (``local_comm()``); the multi-rank ``Comm`` on
``torch.distributed``, the pipeline and the resilience features are
still to port (ROADMAP A7, A9)."""
from .comm import Comm, local_comm

__all__ = ["Comm", "local_comm"]
