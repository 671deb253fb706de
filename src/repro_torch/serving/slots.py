"""Slot + paged-KV admission for the continuous-batching engine.

The mirror of :mod:`repro.serving.slots` on the port's attrs (host
bookkeeping only; nothing here touches a device).

A request occupies one *decode slot* (a row of the JetStream-style slot
array) plus a page table of fixed-size KV pages drawn from the packet
pool underneath
:class:`~repro_torch.serving.kv_cache.PagedKVAllocator`.  Both
geometries — page size, slot count, total pages, eviction policy — are
ordinary attributes resolved through the four-layer chain
(``kv_page_tokens`` / ``kv_slots`` / ``kv_pages`` / ``kv_evict``,
DESIGN.md §12), so a bad knob fails at alloc time naming the attribute,
and a live allocator answers ``get_attr`` for everything it runs with.

Admission is the paper's ternary contract: ``done`` (slot + pages
reserved), ``retry(RETRY_NOSLOT)`` (exhausted — the engine parks the
request in its backlog queue), never blocking.  Under
``kv_evict="preempt_longest"`` exhaustion instead preempts the active
request with the largest footprint: its pages free, its generated-token
count survives, and its stream resumes after re-prefill — continuous
batching's recompute-style preemption without ever duplicating a token.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

from ..core import attrs as _attrs
from ..core.status import ErrorCode, Status, done, retry
from .kv_cache import PagedKVAllocator

#: the serving attr set (satellite of DESIGN.md §12's registry table)
SERVING_ATTRS = ("kv_page_tokens", "kv_slots", "kv_pages", "kv_evict",
                 "prefill_chunk", "drain_workers", "max_batch")

#: the subset the slot allocator itself resolves
SLOT_ATTRS = ("kv_page_tokens", "kv_slots", "kv_pages", "kv_evict")


class SlotAllocator(_attrs.AttrResource):
    """Decode-slot + KV-page admission with the unified attr surface."""

    def __init__(self, *, runtime_layer=None,
                 resolved: Optional[_attrs.ResolvedAttrs] = None,
                 **overrides):
        if resolved is None:
            resolved = _attrs.resolve(SLOT_ATTRS, runtime=runtime_layer,
                                      overrides=overrides)
        elif overrides:
            resolved = resolved.merged(_attrs.resolve(
                tuple(overrides), overrides=overrides))
        self.page_tokens: int = resolved["kv_page_tokens"]
        self.n_slots: int = resolved["kv_slots"]
        self.n_pages: int = resolved["kv_pages"] or 8 * self.n_slots
        self.evict_policy: str = resolved["kv_evict"]
        self.pages = PagedKVAllocator(self.n_pages, self.page_tokens)
        self._free_slots: collections.deque = collections.deque(
            range(self.n_slots))
        self.slot_of: Dict[int, int] = {}          # rid -> slot
        self.tokens_of: Dict[int, int] = {}        # rid -> reserved tokens
        self.admissions = 0
        self.rejections = 0
        self.preemptions = 0
        self._init_attrs(resolved.subset(SLOT_ATTRS))
        self._export_attr("free_slots", lambda: len(self._free_slots))
        self._export_attr("active_slots", lambda: len(self.slot_of))
        self._export_attr("free_pages", lambda: self.pages.free_pages)
        self._export_attr("occupancy", self.occupancy)

    def occupancy(self) -> float:
        """Fraction of decode slots currently held by a request."""
        return len(self.slot_of) / self.n_slots

    def admit(self, rid: int, total_tokens: int) -> Status:
        """Reserve a slot and pages covering ``total_tokens`` positions;
        all-or-nothing.  ``done(slot)`` or ``retry(RETRY_NOSLOT)``."""
        if rid in self.slot_of:
            raise ValueError(f"request {rid} already holds slot "
                             f"{self.slot_of[rid]}")
        if not self._free_slots:
            self.rejections += 1
            return retry(ErrorCode.RETRY_NOSLOT)
        st = self.pages.admit(rid, total_tokens)
        if st.is_retry():
            self.rejections += 1
            return st
        slot = self._free_slots.popleft()
        self.slot_of[rid] = slot
        self.tokens_of[rid] = total_tokens
        self.admissions += 1
        return done(slot)

    def extend(self, rid: int, new_len: int) -> Status:
        """Grow a resident request's page table to ``new_len`` tokens."""
        st = self.pages.extend(rid, new_len)
        if st.is_done():
            self.tokens_of[rid] = max(self.tokens_of.get(rid, 0), new_len)
        return st

    def release(self, rid: int) -> None:
        slot = self.slot_of.pop(rid, None)
        self.tokens_of.pop(rid, None)
        if slot is not None:
            self._free_slots.append(slot)
        self.pages.release(rid)

    def victim(self) -> Optional[int]:
        """Pick the preemption victim under ``kv_evict=preempt_longest``:
        the resident request with the largest reserved footprint."""
        if self.evict_policy != "preempt_longest" or not self.slot_of:
            return None
        return max(self.tokens_of, key=self.tokens_of.get)

    def counters(self) -> dict:
        return {"admissions": self.admissions,
                "rejections": self.rejections,
                "preemptions": self.preemptions,
                "active_slots": len(self.slot_of),
                "free_pages": self.pages.free_pages}
