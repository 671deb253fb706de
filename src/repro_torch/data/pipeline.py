"""Deterministic, step-indexed data pipelines.

Fault-tolerance contract (DESIGN.md §7): a batch is a pure function of
``(seed, step)`` — restoring a checkpoint at step k and replaying
reproduces bit-identical batches, so checkpoint/restart never skips or
repeats data.  The batches are drawn with ``np.random.default_rng``
exactly as the reference (``repro.data.pipeline``) draws them, so the
port's batches equal the reference's bit for bit; ``get_batch`` then
hands them over as int32 tensors on the card unless asked for the CPU.
The file-backed pipeline reads from a flat binary token file through
``np.memmap`` (no copies until slicing).

Batch layout is seq-major ``(S, B)`` to match the model stack's local
view.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.runtime import resolve_device


def _on(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@dataclasses.dataclass
class SyntheticPipeline:
    """Markov-ish synthetic tokens — enough structure for loss to drop."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    n_motifs: int = 32
    motif_len: int = 8

    def __post_init__(self):
        # a FIXED motif table (function of seed only): successive batches
        # share structure, so a model actually learns across steps
        rng = np.random.default_rng(self.seed)
        self._motifs = rng.integers(
            0, self.vocab, size=(self.n_motifs, self.motif_len),
            dtype=np.int32)

    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ (step + 1))
        b, s = self.global_batch, self.seq_len
        ml = self.motif_len
        idx = rng.integers(0, self.n_motifs,
                           size=(b, (s + ml) // ml + 1), dtype=np.int32)
        seqs = self._motifs[idx].reshape(b, -1)[:, :s + 1]
        tokens = seqs[:, :-1].T.copy()            # (S, B)
        labels = seqs[:, 1:].T.copy()
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def get_batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` as int32 tensors on ``device`` (default
        the card)."""
        return _on(self._host_batch(step), device)


@dataclasses.dataclass
class TokenFilePipeline:
    """Flat binary token file (uint16/uint32), step-indexed windows."""

    path: str
    vocab: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        n = len(self._data)
        self._n_windows = (n - 1) // self.seq_len
        if self._n_windows < self.global_batch:
            raise ValueError(f"token file too small: {n} tokens for "
                             f"{self.global_batch}x{self.seq_len}")

    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        rows = rng.integers(0, self._n_windows, size=self.global_batch)
        tok = np.stack([self._data[r * self.seq_len:
                                   r * self.seq_len + self.seq_len + 1]
                        for r in rows]).astype(np.int32)
        tok = np.minimum(tok, self.vocab - 1)
        return {"tokens": tok[:, :-1].T.copy(),
                "labels": tok[:, 1:].T.copy()}

    def get_batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` as int32 tensors on ``device`` (default
        the card)."""
        return _on(self._host_batch(step), device)


def stub_image_embeds(n_tokens: int, batch: int, d_model: int,
                      step: int = 0, seed: int = 1) -> np.ndarray:
    """VLM frontend stub: precomputed patch embeddings (ti, B, d)."""
    rng = np.random.default_rng((seed << 32) ^ step)
    return rng.standard_normal((n_tokens, batch, d_model)).astype(np.float32)


def stub_frames(n_frames: int, batch: int, d_model: int,
                step: int = 0, seed: int = 2) -> np.ndarray:
    """Audio frontend stub: precomputed frame embeddings (t, B, d)."""
    rng = np.random.default_rng((seed << 32) ^ step)
    return rng.standard_normal((n_frames, batch, d_model)).astype(np.float32)
