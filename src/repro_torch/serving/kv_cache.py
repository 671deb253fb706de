"""Paged KV-cache allocation — the packet pool applied to serving memory.

The mirror of :mod:`repro.serving.kv_cache`, on the port's host packet
pool.  The decode cache (:mod:`repro_torch.serving.engine`) is a dense ring of
slots; *which requests own which slots* is managed host-side by this
allocator, which is literally an LCI packet pool: pages are fixed-size
pre-registered buffers, ``get`` is nonblocking and returns ``retry`` under
exhaustion (the scheduler then parks the request in the backlog queue),
``put`` returns pages on request completion, and per-lane deques with
steal-half keep multi-engine allocation contention-free.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.packet_pool import HostPacketPool
from ..core.status import ErrorCode, Status, done, retry


@dataclasses.dataclass
class PageTable:
    """Per-request page list (block table): logical position -> page id."""
    request_id: int
    pages: List[int]
    page_size: int

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def slot_of(self, position: int) -> Tuple[int, int]:
        return self.pages[position // self.page_size], \
            position % self.page_size


class PagedKVAllocator:
    """Allocate cache pages to requests out of a packet pool."""

    def __init__(self, n_pages: int, page_size: int, n_lanes: int = 1):
        per_lane = max(1, n_pages // n_lanes)
        self.pool = HostPacketPool(n_lanes=n_lanes,
                                   packets_per_lane=per_lane,
                                   packet_bytes=0)
        self.page_size = page_size
        self.tables: Dict[int, PageTable] = {}

    def admit(self, request_id: int, prompt_len: int, lane: int = 0
              ) -> Status:
        """Reserve pages for a prompt; all-or-nothing (retry on shortage)."""
        need = -(-prompt_len // self.page_size)
        got: List[int] = []
        for _ in range(need):
            pid, st = self.pool.get(lane)
            if st.is_retry():
                for p in got:                       # roll back
                    self.pool.put(lane, p)
                return retry(ErrorCode.RETRY_NOSLOT)
            got.append(pid)
        self.tables[request_id] = PageTable(request_id, got, self.page_size)
        return done(got)

    def extend(self, request_id: int, new_len: int, lane: int = 0
               ) -> Status:
        """Grow a request's table to cover ``new_len`` positions."""
        table = self.tables[request_id]
        while table.capacity < new_len:
            pid, st = self.pool.get(lane)
            if st.is_retry():
                return retry(ErrorCode.RETRY_NOSLOT)
            table.pages.append(pid)
        return done()

    def release(self, request_id: int, lane: int = 0) -> None:
        table = self.tables.pop(request_id, None)
        if table:
            for p in table.pages:
                self.pool.put(lane, p)

    @property
    def free_pages(self) -> int:
        return self.pool.free_packets()
