"""The Objectified Flexible Function (OFF) idiom (paper §3.1), in Python.

LCI's C++ OFF lets callers set optional arguments in any order::

    post_send_x(rank, buf, size, tag, comp).device(device)();
    post_send_x(...).matching_policy(rank_only).device(device)();

Python has kwargs, but the OFF idiom buys three things we keep:

1. *Incremental refinement* — an OFF object is a value; a client can build a
   partially-configured op, hand it around, and finish it elsewhere.
2. *Validation at set-time* — unknown options fail at the ``.option()`` call
   site, not deep inside the runtime.
3. *Uniform introspection* — benchmarks/tests can enumerate the option set.

The C++ version is generated from a DSL by a Python script; here the
decorator plays that role: it manufactures the ``<name>_x`` builder class
from the wrapped function's signature.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable


class OffBuilder:
    """Callable builder: ``off(positional...).opt(v).opt2(v)()``."""

    __slots__ = ("_fn", "_sig", "_args", "_opts", "_allowed")

    def __init__(self, fn: Callable, sig: inspect.Signature,
                 allowed: dict[str, inspect.Parameter], args: tuple):
        self._fn = fn
        self._sig = sig                # computed once, at decoration time
        self._args = args
        self._opts: dict[str, Any] = {}
        self._allowed = allowed

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._allowed:
            raise TypeError(
                f"{self._fn.__name__}_x has no optional argument {name!r}; "
                f"valid options: {sorted(self._allowed)}")

        def setter(value):
            self._opts[name] = value
            return self

        return setter

    def options(self) -> dict[str, Any]:
        """Introspection: currently-set optional arguments."""
        return dict(self._opts)

    def is_set(self, name: str) -> bool:
        """True if ``name`` is already bound — via ``.name(v)`` or
        positionally.  Lets a holder of a deferred op (e.g. a completion
        graph owning a comm node) check an option is still free to set."""
        if name in self._opts:
            return True
        try:
            bound = self._sig.bind_partial(*self._args)
        except TypeError:
            return False
        return name in bound.arguments

    def get(self, name: str, default: Any = None) -> Any:
        """Current bound value of an argument (positional or option)."""
        if name in self._opts:
            return self._opts[name]
        try:
            bound = self._sig.bind_partial(*self._args)
        except TypeError:
            return default
        return bound.arguments.get(name, default)

    def set(self, name: str, value: Any) -> "OffBuilder":
        """Bind ``name`` even if it was already given positionally (the
        attribute sugar would collide with the positional slot)."""
        if name not in self._allowed:
            raise TypeError(
                f"{self._fn.__name__}_x has no optional argument {name!r}; "
                f"valid options: {sorted(self._allowed)}")
        params = list(self._sig.parameters)
        idx = params.index(name)
        if idx < len(self._args):
            self._args = self._args[:idx] + (value,) + self._args[idx + 1:]
        else:
            self._opts[name] = value
        return self

    def __call__(self):
        return self._fn(*self._args, **self._opts)

    def batch(self, collector=None):
        """Defer this op into a :class:`~repro_torch.core.post.PostBatch`
        doorbell instead of firing it now::

            b = post_send_x(rt, peer, buf).endpoint(ep).batch()
            post_send_x(rt, peer, buf2).endpoint(ep).batch(b)
            statuses = b.flush()          # one coalesced doorbell

        With no argument a fresh batch is created; passing an existing
        batch appends to it.  Returns the batch (for further adds /
        ``flush``).  Only ``post_*`` operations can ride a doorbell —
        anything else fails at ``flush`` time."""
        if collector is None:
            from .post import PostBatch   # late: post.py imports this module
            collector = PostBatch()
        return collector.add(self)


def off(fn: Callable) -> Callable:
    """Decorator: attach an OFF variant as ``fn.x`` (the ``_x`` suffix).

    Positional-or-keyword params without defaults are the positional
    arguments; everything with a default becomes a settable option.
    """
    sig = inspect.signature(fn)
    optional = {
        name: p for name, p in sig.parameters.items()
        if p.default is not inspect.Parameter.empty
        or p.kind == inspect.Parameter.KEYWORD_ONLY
    }

    def make_builder(*args) -> OffBuilder:
        return OffBuilder(fn, sig, optional, args)

    make_builder.__name__ = fn.__name__ + "_x"
    make_builder.__doc__ = (f"OFF variant of {fn.__name__}: set optional "
                            f"arguments in any order, then call with ().")
    fn.x = make_builder  # type: ignore[attr-defined]
    return fn
