"""ResultTokens — one decode step's output as a single packed array.

The mirror of :mod:`repro.serving.result_tokens` on the engine's device.
JetStream's observation (SNIPPETS.md §1) is that per-slot result objects
are the wrong shape for a serving engine: the hot loop wants *one* array
holding tokens, validity, and lengths side by side — and, here, because
one contiguous array is what the burst data plane stages into a fused
doorbell: on the card the doorbell's rows are gathered by the doorbell
kernel (:func:`repro_torch.kernels.doorbell.stage_copy_rows`) in one
launch.

Layout: ``data`` is ``(n_slots, 5)`` int32, a tensor on the engine's
device, with column ranges addressed by index tuples, so consumers never
hard-code offsets::

    tokens_idx  = (0, 1)   token generated for the slot this step
    valid_idx   = (1, 2)   1 when the slot was active this step
    length_idx  = (2, 3)   tokens generated so far (seq + 1)
    rid / done  = cols 3,4 request id, end-of-stream flag

The wire side slices the packed array into uniform 16-byte rows
(``[rid, seq, token, done]`` little-endian int32) — a burst of them is
exactly the uniform eager run the fused-doorbell path packs into one
``PackedBurst``.  Token values never cross to the host on the server:
:meth:`ResultTokens.pack` scatters them on the device and
:meth:`ResultTokens.wire_rows` builds the wire image there with one
gather, steered by the host lists ``pack`` was given.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

#: columns of the packed array
TOKEN_COL, VALID_COL, LENGTH_COL, RID_COL, DONE_COL = range(5)
N_COLS = 5
#: the default column ranges
TOKENS_IDX, VALID_IDX, LENGTH_IDX = ((c, c + 1) for c in (
    TOKEN_COL, VALID_COL, LENGTH_COL))

#: one wire row: [rid, seq, token, done] as int32 -> 16 bytes, uniform
ROW_WORDS = 4
ROW_BYTES = ROW_WORDS * 4

#: the packed array's columns in wire order (the seq word is the length
#: column less one)
_WIRE_COLS = (RID_COL, LENGTH_COL, TOKEN_COL, DONE_COL)
#: pack()'s host rows: the packed columns, then the slot, the token's
#: place in the decode step's output and the wire image's gather index
_SLOT, _SOURCE = N_COLS, N_COLS + 1
_WIRE = slice(N_COLS + 2, N_COLS + 2 + ROW_WORDS)
_HOST_COLS = N_COLS + 2 + ROW_WORDS


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` without blocking the host:
    on the card the bytes go through pinned memory in a copy that does
    not wait for the stream (a pageable copy would synchronise)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class SlotData:
    """Per-slot view into a :class:`ResultTokens` (JetStream's shape)."""
    tokens: torch.Tensor
    valid: torch.Tensor
    lengths: torch.Tensor


class ResultTokens:
    """The packed per-step result array with named column ranges.

    The constructor takes host data (numpy, lists), as the reference's
    does: the array is a CPU tensor.  :meth:`pack` builds it on the decode
    step's device."""

    def __init__(self, data,
                 tokens_idx: Tuple[int, int] = TOKENS_IDX,
                 valid_idx: Tuple[int, int] = VALID_IDX,
                 length_idx: Tuple[int, int] = LENGTH_IDX):
        host = np.asarray(data)
        if host.ndim != 2 or host.shape[1] != N_COLS:
            raise ValueError(f"ResultTokens expects (n_slots, {N_COLS}) "
                             f"int32, got {host.shape}")
        host = host.astype(np.int32)
        slots = np.flatnonzero(host[:, VALID_COL])
        self._init(torch.from_numpy(host), list(map(int, slots)),
                   list(map(int, host[slots, RID_COL])),
                   torch.from_numpy(slots[:, None] * N_COLS
                                    + np.asarray(_WIRE_COLS)),
                   tokens_idx, valid_idx, length_idx)

    def _init(self, data: torch.Tensor, slots: List[int], rids: List[int],
              wire_index: torch.Tensor,
              tokens_idx: Tuple[int, int] = TOKENS_IDX,
              valid_idx: Tuple[int, int] = VALID_IDX,
              length_idx: Tuple[int, int] = LENGTH_IDX) -> None:
        self.data = data
        self.tokens_idx = tokens_idx
        self.valid_idx = valid_idx
        self.length_idx = length_idx
        # the valid slots (ascending), their rids and the wire image's
        # gather index: host data, so wire_rows reads nothing back
        self._slots, self._rids, self._wire_index = slots, rids, wire_index

    @classmethod
    def pack(cls, slots: List[int], rids: List[int], tokens,
             lengths: List[int], dones: List[int],
             n_slots: int) -> "ResultTokens":
        """Build the packed array from the decode step's per-slot results
        (inactive slots stay zero / invalid) on the device of ``tokens``
        (the decode step's tensor; host ints make a CPU tensor).  The
        tokens never leave that device; everything else is host data and
        crosses to it in one copy that does not block the host."""
        tokens = torch.as_tensor(tokens)
        dev = tokens.device
        order = sorted(range(len(slots)), key=slots.__getitem__)
        # one host row per valid slot, in ascending slot order (the order
        # active_slots gives): the packed columns, the slot, where the
        # slot's token lies in ``tokens``, and the wire image's gather
        # index -- one copy to the device carries all of it
        host = np.zeros((len(order), _HOST_COLS), np.int64)
        for i, j in enumerate(order):
            host[i, VALID_COL] = 1
            host[i, LENGTH_COL] = lengths[j]
            host[i, RID_COL] = rids[j]
            host[i, DONE_COL] = dones[j]
            host[i, _SLOT] = slots[j]
            host[i, _SOURCE] = j
            host[i, _WIRE] = np.asarray(_WIRE_COLS) + slots[j] * N_COLS
        rows = to_device(host, dev)
        values = rows[:, :N_COLS].to(torch.int32)
        if order:
            values[:, TOKEN_COL] = tokens.reshape(-1)[rows[:, _SOURCE]]
        data = torch.zeros((n_slots, N_COLS), dtype=torch.int32, device=dev)
        data[rows[:, _SLOT]] = values
        out = cls.__new__(cls)
        out._init(data, [slots[j] for j in order], [rids[j] for j in order],
                  rows[:, _WIRE])
        return out

    @property
    def n_slots(self) -> int:
        return self.data.shape[0]

    def get_result_at_slot(self, slot: int) -> SlotData:
        row = self.data[slot]
        return SlotData(tokens=row[self.tokens_idx[0]:self.tokens_idx[1]],
                        valid=row[self.valid_idx[0]:self.valid_idx[1]],
                        lengths=row[self.length_idx[0]:self.length_idx[1]])

    def active_slots(self) -> np.ndarray:
        """The valid slots, ascending (host data)."""
        return np.asarray(self._slots, np.int64)

    def wire_rows(self) -> List[Tuple[int, torch.Tensor]]:
        """Slice the packed array into per-client uniform wire rows:
        ``[(rid, 16-byte row)]`` for every valid slot, ready for one
        ``post_am_many`` burst (uniform size -> fused doorbell).

        The ``(n_active, 4)`` wire image ``[rid, seq, token, done]`` is
        built on the array's device by one gather, and each row is a
        16-byte uint8 view of it.  The rids and slots are host lists."""
        if not self._slots:
            return []
        wire = torch.take(self.data, self._wire_index)
        wire[:, 1] -= 1                            # length -> seq
        return list(zip(self._rids, wire.view(torch.uint8)))


def encode_token_row(rid, seq, token, done):
    """One token message payload: uniform 16 bytes so a burst of them
    rides the fused-doorbell path.  Host ints give a numpy row, as the
    reference's; where any field is a tensor the row is a uint8 tensor on
    that tensor's device, built there without reading it back."""
    fields = (rid, seq, token, done)
    on = next((f for f in fields if isinstance(f, torch.Tensor)), None)
    if on is None:
        return np.array(fields, np.int32).view(np.uint8)
    row = to_device(np.array([0 if isinstance(f, torch.Tensor) else f
                              for f in fields], np.int32), on.device)
    for i, f in enumerate(fields):
        if isinstance(f, torch.Tensor):
            row[i] = f.reshape(())
    return row.view(torch.uint8)


def decode_token_row(buf) -> Tuple[int, int, int, int]:
    """Inverse of :func:`encode_token_row`: ``(rid, seq, token, done)``.
    ``buf`` may be numpy, bytes, or a CPU or CUDA tensor (one copy to the
    host)."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().contiguous().view(torch.uint8).cpu().numpy()
    words = np.frombuffer(bytes(buf), np.int32)
    if words.size != ROW_WORDS:
        raise ValueError(f"token row must be {ROW_BYTES} bytes, got "
                         f"{words.size * 4}")
    return int(words[0]), int(words[1]), int(words[2]), int(words[3])
