"""The port's kernel calls in a traced stretch, each costed by the yardstick.

While a :class:`KernelCalls` is active, every call of the port's kernel
wrappers (``repro_torch.kernels.<name>.ops.<name>``) goes through a
recorder that notes the call's shapes and hands it on unchanged.  The
recorder is put in the wrapper's place wherever a module of the program
holds it, and the wrappers are put back when the stretch ends.  The work
of each call comes from :mod:`.counts`; for ``moe_gmm`` the filled rows
are summed on the device and read once the stretch is over.  A call the
yardstick cannot cost (``None``) leaves its kernel's work unread.
"""
from __future__ import annotations

import importlib
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import counts

#: layer -> (module, function) of the wrapper the program calls
WRAPPERS = {
    "rmsnorm": ("repro_torch.kernels.rmsnorm.ops", "rmsnorm"),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops",
                        "flash_attention"),
    "moe_gmm": ("repro_torch.kernels.moe_gmm.ops", "moe_gmm"),
    "ssd_scan": ("repro_torch.kernels.ssd_scan.ops", "ssd_scan"),
}


def _rmsnorm(x, w=None, **_):
    d = x.shape[-1]
    return counts.rmsnorm_cost(x.numel() // d, d, x.element_size(),
                               w.element_size() if w is not None else 0)


def _flash(q, k, v, *, causal=True, window=0, q_offset=0, **_):
    sq, b, hq, dh = q.shape                         # seq-major
    skv, _, hkv, _ = k.shape
    if window:
        return None                     # windowed attention: not costed
    return counts.flash_attention_cost(b, hq, hkv, sq, skv, dh,
                                       q.element_size(), causal=causal,
                                       q_offset=q_offset)


def _moe(x, w1, w2, act="swiglu", rows=None, **_):
    e, cap, d = x.shape
    f = w2.shape[1]
    if rows is None:
        filled, busy = e * cap, e
    else:
        filled = rows.sum()                         # device tensors
        busy = (rows > 0).sum()
    return ("moe", filled, busy, d, f, x.element_size(),
            act in ("swiglu", "geglu"))


def _ssd(x, dt, a_log, b, c, d_skip, **_):
    s, bs, h, p = x.shape                           # seq-major
    g, n = b.shape[2], b.shape[3]
    return counts.ssd_scan_cost(bs, h, s, p, g, n, x.element_size(),
                                b.element_size())


COSTS: Dict[str, Callable] = {"rmsnorm": _rmsnorm,
                              "flash_attention": _flash,
                              "moe_gmm": _moe, "ssd_scan": _ssd}


class _Recorder:
    """Stands in for a wrapper: notes each call's cost, then calls it.
    Attributes are the wrapper's own (its launch counters)."""

    def __init__(self, orig: Callable, cost: Callable, sink: list):
        object.__setattr__(self, "_orig", orig)
        object.__setattr__(self, "_cost", cost)
        object.__setattr__(self, "_sink", sink)

    def __call__(self, *args, **kwargs):
        tc = args[0].dtype in (torch.bfloat16, torch.float16)
        self._sink.append((self._cost(*args, **kwargs), tc))
        return self._orig(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._orig, name)

    def __setattr__(self, name, value):
        setattr(self._orig, name, value)


class KernelCalls:
    """Records the port's kernel calls while active (a context manager)."""

    def __init__(self):
        self.raw: Dict[str, List[Tuple[Any, bool]]] = {k: [] for k in WRAPPERS}
        self._patched: List[Tuple[Any, str, Any]] = []

    def __enter__(self) -> "KernelCalls":
        for layer, (mod_name, fn) in WRAPPERS.items():
            orig = getattr(importlib.import_module(mod_name), fn)
            rec = _Recorder(orig, COSTS[layer], self.raw[layer])
            for name, mod in list(sys.modules.items()):
                if not (name == "repro_torch" or
                        name.startswith("repro_torch.")) or mod is None:
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, attr, rec)
                        self._patched.append((mod, attr, orig))
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, orig in self._patched:
            setattr(mod, attr, orig)
        self._patched.clear()

    def work(self, layer: str) -> Optional[List[Tuple[float, float, bool]]]:
        """(flops, bytes, on tensor cores) of each recorded call (read
        after the stretch's synchronize); None where a call was not
        costed."""
        out = []
        for c, tc in self.raw[layer]:
            if c is None:
                return None
            if c and c[0] == "moe":
                _, filled, busy, d, f, elem, gated = c
                filled, busy = int(filled), int(busy)
                c = counts.moe_gmm_cost(filled, busy, d, f, elem, gated)
            out.append((c[0], c[1], tc))
        return out
