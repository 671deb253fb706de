"""Communication execution modes — the paper's evaluation axes.

The paper compares (§5.2):

* *process-based*      — one process per core (the classic MPI mode)
* *thread, shared*     — all threads share one set of comm resources
* *thread, dedicated*  — one device (NIC resource set) per thread

The port keeps the reference's three modes and their names, so a config
means the same thing to both packages:

* ``BSP``            — monolithic blocking collectives (the "MPI
  baseline"); one channel.
* ``LCI_SHARED``     — asynchronous posting on a single shared channel.
* ``LCI_DEDICATED``  — ``n_channels`` independent streams.

The in-graph collectives (:mod:`.collectives`) read these modes; the
host runtime reads ``n_channels`` for its pool lanes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from . import attrs as _attrs


class CommMode(enum.Enum):
    BSP = "bsp"                    # paper baseline: MPI-like bulk synchronous
    LCI_SHARED = "lci_shared"      # async, shared single channel
    LCI_DEDICATED = "lci_dedicated"  # async, dedicated per-stream channels

    @property
    def is_lci(self) -> bool:
        return self is not CommMode.BSP


# CommConfig field -> canonical attribute name (the thin-view mapping).
# The field spellings (inject_max_bytes, ...) are the deprecation shim:
# every historical call site keeps working, but the stored values, their
# defaults, and REPRO_ATTR_* overridability all come from the registry.
_FIELD_TO_ATTR = {
    "mode": "mode",
    "n_channels": "n_channels",
    "inject_max_bytes": "eager_max_bytes",
    "bufcopy_max_bytes": "rdv_threshold",
    "matching_buckets": "matching_buckets",
    "packets_per_lane": "packets_per_lane",
    "packet_bytes": "packet_bytes",
    "wire_bf16": "wire_bf16",
}


@dataclasses.dataclass(frozen=True)
class CommConfig(_attrs.AttrResource):
    """Per-step communication configuration — a thin view over resolved
    attributes (DESIGN.md §12).

    Every field defaults to ``None`` = "resolve through the attribute
    chain" (library default, then ``REPRO_ATTR_*``); an explicitly passed
    field is a runtime-level override.  After construction all fields are
    concrete, so existing reads (``config.inject_max_bytes``) are
    untouched, and ``get_attr``/``attrs`` expose the same values under
    their canonical attribute names with provenance.

    ``n_channels`` is the resource-replication knob (paper: #devices).
    """

    mode: Optional[CommMode] = None
    n_channels: Optional[int] = None
    # protocol thresholds, bytes (paper §4.3: inject / buffer-copy /
    # zero-copy); attr names: eager_max_bytes / rdv_threshold
    inject_max_bytes: Optional[int] = None
    bufcopy_max_bytes: Optional[int] = None
    # matching-engine defaults (paper §4.1.3: 65536 buckets by default)
    matching_buckets: Optional[int] = None
    # packet pool
    packets_per_lane: Optional[int] = None
    packet_bytes: Optional[int] = None
    # ring wire format: cast reduce-ring accumulators to bf16 per hop
    # (local accumulation stays fp32).  ~1.5-2x fewer scatter bytes at
    # ~sqrt(hops)*2^-9 relative rounding noise — a §Perf (cell 3) knob.
    wire_bf16: Optional[bool] = None

    def __post_init__(self):
        explicit = {}
        for field, attr in _FIELD_TO_ATTR.items():
            value = getattr(self, field)
            if value is not None:
                if field == "mode":
                    value = parse_mode(value) if isinstance(value, str) \
                        else value
                    value = value.value
                explicit[attr] = value
        resolved = _attrs.resolve(list(_FIELD_TO_ATTR.values()),
                                  runtime=explicit)
        self._init_attrs(resolved)
        for field, attr in _FIELD_TO_ATTR.items():
            value = resolved[attr]
            if field == "mode":
                value = CommMode(value)
            object.__setattr__(self, field, value)

    def explicit_attrs(self) -> dict:
        """The fields this config was *explicitly* constructed with, as
        {attr name: value} — the runtime-level layer a Runtime feeds back
        into per-resource resolution."""
        return {attr: self._resolved_attrs[attr]
                for attr in _FIELD_TO_ATTR.values()
                if self._resolved_attrs.source(attr) == "runtime"}

    def resolved_channels(self) -> int:
        if self.mode == CommMode.BSP:
            return 1
        if self.mode == CommMode.LCI_SHARED:
            return 1
        return max(1, self.n_channels)


def parse_mode(name: str) -> CommMode:
    try:
        return CommMode(name)
    except ValueError as e:
        raise ValueError(
            f"unknown comm mode {name!r}; pick from "
            f"{[m.value for m in CommMode]}") from e
