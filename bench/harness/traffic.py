"""The one traffic generator: a mix's data file in, the calls of a run out.

Two kinds of mix, named by the file's ``kind``:

- ``prefill``: a closed loop of prefill calls.  The file's ``block``
  lists shapes ``(batch, seq)`` with a count each; every block of calls
  holds exactly those counts, in an order drawn from the seed, so every
  seed gives the same work in another order.
- ``train``: a closed loop of training steps on ``batch`` x ``seq``
  tokens, a new batch each step.

Token ids are drawn on the run's device, call by call, from a generator
seeded by the run's seed and the call's index: ``uniform`` over the
vocabulary, or ``zipf``: each row a document whose tokens follow a Zipf
law of exponent ``ZIPF_EXPONENT`` over the row's own permutation of the
vocabulary (``rank * a + c mod V``, a coprime to V).  Nothing is copied
from the host inside a run's loop.
"""
from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Tuple

import torch

from . import seeds

#: the exponent of the ``zipf`` token law
ZIPF_EXPONENT = 1.0


def resolve(traffic: Dict[str, Any], smoke: bool = False) -> Dict[str, Any]:
    """The mix's parameters (``smoke`` applied over them)."""
    out = dict(traffic)
    if smoke:
        out.update(traffic.get("smoke", {}))
    return out


class Tokens:
    """Token ids of a mix's ``tokens`` rule over ``vocab`` on ``device``."""

    def __init__(self, rule: Dict[str, Any], vocab: int, device):
        self.dist = rule.get("dist", "uniform")
        self.vocab = vocab
        self.device = torch.device(device)
        if self.dist == "zipf":
            ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                                 device=self.device)
            cdf = torch.cumsum(ranks ** -ZIPF_EXPONENT, 0)
            self.cdf = cdf / cdf[-1]
            self.coprime = torch.tensor(
                [m for m in range(1, vocab) if math.gcd(m, vocab) == 1],
                dtype=torch.int64, device=self.device)
        elif self.dist != "uniform":
            raise ValueError(f"unknown token distribution {self.dist!r}")

    def draw(self, seed: int, shape: Tuple[int, int]) -> torch.Tensor:
        """(rows, cols) int64 ids; each column a row of the batch."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.dist == "uniform":
            return torch.randint(0, self.vocab, shape, generator=gen,
                                 device=self.device)
        s, b = shape
        u = torch.rand(shape, generator=gen, device=self.device,
                       dtype=torch.float64)
        rank = torch.searchsorted(self.cdf, u).clamp_(max=self.vocab - 1)
        # drawn on the device: a copy from the host would wait for the
        # work already queued there
        a = self.coprime[torch.randint(0, len(self.coprime), (b,),
                                       generator=gen, device=self.device)]
        c = torch.randint(0, self.vocab, (b,), generator=gen,
                          device=self.device)
        return (rank * a + c) % self.vocab


class PrefillPlan:
    """Call ``i`` of a prefill mix: its shape and its tokens (s, b)."""

    def __init__(self, traffic: Dict[str, Any], vocab: int, seed: int,
                 device):
        self.block: List[Tuple[int, int]] = [
            (int(e["batch"]), int(e["seq"]))
            for e in traffic["block"] for _ in range(int(e["count"]))]
        self.seed = seed
        self.tokens = Tokens(traffic.get("tokens", {}), vocab, device)
        self._orders: Dict[int, List[Tuple[int, int]]] = {}

    def shapes(self) -> List[Tuple[int, int]]:
        """The distinct shapes, largest seq first."""
        return sorted(set(self.block), key=lambda bs: (-bs[1], bs[0]))

    def shape(self, i: int) -> Tuple[int, int]:
        blk, j = divmod(i, len(self.block))
        order = self._orders.get(blk)
        if order is None:
            order = list(self.block)
            random.Random(seeds.derive(self.seed, "order", blk)).shuffle(
                order)
            self._orders[blk] = order
        return order[j]

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        b, s = self.shape(i)
        return {"tokens": self.tokens.draw(seeds.derive(self.seed, "call", i),
                                           (s, b))}

    def warm_batch(self, shape: Tuple[int, int], k: int
                   ) -> Dict[str, torch.Tensor]:
        """Tokens of the ``k``-th warm-up call of ``shape``: never a call
        of the window."""
        b, s = shape
        return {"tokens": self.tokens.draw(
            seeds.derive(self.seed, "warm", b, s, k), (s, b))}


class TrainPlan:
    """Step ``i`` of a training mix: tokens and next-token labels (s, b)."""

    def __init__(self, traffic: Dict[str, Any], vocab: int, seed: int,
                 device):
        self.b, self.s = int(traffic["batch"]), int(traffic["seq"])
        self.seed = seed
        self.tokens = Tokens(traffic.get("tokens", {}), vocab, device)

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        rows = self.tokens.draw(seeds.derive(self.seed, "step", i),
                                (self.s + 1, self.b))
        return {"tokens": rows[:-1], "labels": rows[1:]}


def plan(traffic: Dict[str, Any], vocab: int, seed: int, device):
    kind = traffic["kind"]
    if kind == "prefill":
        return PrefillPlan(traffic, vocab, seed, device)
    if kind == "train":
        return TrainPlan(traffic, vocab, seed, device)
    raise ValueError(f"unknown traffic kind {kind!r}")
