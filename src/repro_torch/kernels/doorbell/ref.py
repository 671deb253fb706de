"""Plain PyTorch versions of the doorbell stage-copy (DESIGN.md §13).

The counterparts of ``repro/kernels/doorbell/ref.py`` and of the
reference's ``pool_get_copy_n``: the CPU path runs them, and the tests
and ``chip_smoke.py`` hold the CUDA kernel against them.  On the card
the main path uses them for nothing.
"""
from __future__ import annotations

import torch

from ...core.packet_pool import SlotPool, pool_get_copy_n


def wire_rows(payloads: torch.Tensor, wire_bf16: bool) -> tuple:
    """``(cast, row_bytes)`` for a ``(k, e)`` doorbell: whether the rows
    are cast f32 -> bf16 on the wire, and the wire bytes per row."""
    cast = wire_bf16 and payloads.dtype == torch.float32
    e = payloads.shape[1]
    return cast, e * (2 if cast else payloads.element_size())


def rows_to_bytes(rows: torch.Tensor) -> torch.Tensor:
    """(k, e) any-dtype -> (k, e * itemsize) uint8 wire rows (a view)."""
    return rows.contiguous().view(torch.uint8).reshape(rows.shape[0], -1)


def stage_copy_ref(payloads: torch.Tensor, *, wire_bf16: bool = False
                   ) -> torch.Tensor:
    """(k, e) payloads -> (k, row_bytes) packed uint8 wire image, a fresh
    tensor (a snapshot: the source stays reusable).

    Mirrors the host data plane's ``pack_payloads`` math: the staging
    copy IS the dtype normalization, and ``wire_bf16`` folds the f32 ->
    bf16 wire compression (round to nearest even) into that same copy;
    non-f32 bursts ship uncompressed, exactly like the host path.
    """
    if wire_bf16 and payloads.dtype == torch.float32:
        return rows_to_bytes(payloads.to(torch.bfloat16))
    return rows_to_bytes(payloads).clone()


def stage_copy_rows_ref(rows, *, wire_bf16: bool = False) -> torch.Tensor:
    """K tensors of one dtype and shape -> the ``(K, row_bytes)`` uint8
    wire image that :func:`stage_copy_ref` makes of them stacked."""
    return stage_copy_ref(torch.stack(list(rows)).reshape(len(rows), -1),
                          wire_bf16=wire_bf16)


def stage_copy_push_ref(pool: SlotPool, buf: torch.Tensor, lane,
                        payloads: torch.Tensor, steal_seed, *,
                        wire_bf16: bool = False):
    """Stage the doorbell, pop up to k packet slots and scatter the wire
    rows into ``buf[ids]`` (zero-padded; ``buf`` written in place).
    Returns ``(pool', buf, ids, got, status)`` with
    :func:`repro_torch.core.packet_pool.pool_get_copy_n`'s contract."""
    rows = stage_copy_ref(payloads, wire_bf16=wire_bf16)
    return pool_get_copy_n(pool, buf, lane, rows, steal_seed)
