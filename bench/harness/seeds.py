"""Seeds of the run's parts, each derived from ``--seed`` and a label."""
from __future__ import annotations

import hashlib


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for ``labels`` under the run's ``seed`` (any whole
    number, negative or beyond 64 bits too)."""
    text = ":".join([str(int(seed)), *map(str, labels)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
