"""Communication protocols (paper §4.3) — inject / buffer-copy / zero-copy.

"For the send-receive and active message operations, depending on the
message size, LCI adopts three different communication protocols: inject,
buffer-copy, and zero-copy.  For put/get operations, LCI directly
translates them into the corresponding low-level network operations."

* ``INJECT``    — tiny payloads ride the descriptor itself (no packet, no
  handshake); completes immediately at the source (``done``).
* ``BUFCOPY``   — the payload is copied into a fixed-size pre-registered
  packet (pool ``get``; ``retry`` on exhaustion), sent eagerly, and the
  packet returns to the pool on source completion.
* ``ZEROCOPY``  — rendezvous: an RTS descriptor travels first; the target
  matches it (recv posted / AM buffer allocated) and replies CTS; the
  payload then moves directly between registered buffers (no copy).

The host runtime uses this module literally.
"""
from __future__ import annotations

import dataclasses
import enum

from .modes import CommConfig


class Protocol(enum.Enum):
    INJECT = "inject"
    BUFCOPY = "bufcopy"
    ZEROCOPY = "zerocopy"


def select_protocol(size_bytes: int, config: CommConfig) -> Protocol:
    """Size-driven protocol selection (thresholds live on CommConfig)."""
    if size_bytes <= config.inject_max_bytes:
        return Protocol.INJECT
    if size_bytes <= config.bufcopy_max_bytes:
        return Protocol.BUFCOPY
    return Protocol.ZEROCOPY


@dataclasses.dataclass
class ProtocolStats:
    """Telemetry: how many messages/bytes took each path (benchmarks read
    this to report the protocol mix per run)."""

    inject_msgs: int = 0
    inject_bytes: int = 0
    bufcopy_msgs: int = 0
    bufcopy_bytes: int = 0
    zerocopy_msgs: int = 0
    zerocopy_bytes: int = 0
    handshakes: int = 0          # RTS/CTS round trips
    retries: int = 0             # back-pressure events surfaced to clients

    def record(self, proto: Protocol, size: int) -> None:
        if proto == Protocol.INJECT:
            self.inject_msgs += 1
            self.inject_bytes += size
        elif proto == Protocol.BUFCOPY:
            self.bufcopy_msgs += 1
            self.bufcopy_bytes += size
        else:
            self.zerocopy_msgs += 1
            self.zerocopy_bytes += size

    def record_many(self, proto: Protocol, n_msgs: int, n_bytes: int) -> None:
        """Burst telemetry: one counter bump for a whole doorbell."""
        if proto == Protocol.INJECT:
            self.inject_msgs += n_msgs
            self.inject_bytes += n_bytes
        elif proto == Protocol.BUFCOPY:
            self.bufcopy_msgs += n_msgs
            self.bufcopy_bytes += n_bytes
        else:
            self.zerocopy_msgs += n_msgs
            self.zerocopy_bytes += n_bytes

    @property
    def total_msgs(self) -> int:
        return self.inject_msgs + self.bufcopy_msgs + self.zerocopy_msgs

    @property
    def total_bytes(self) -> int:
        return self.inject_bytes + self.bufcopy_bytes + self.zerocopy_bytes
