"""Hand-written Hopper kernels of the port, one package each.

Each ``<name>/`` package holds ``ref.py`` (the plain PyTorch version)
and ``ops.py`` (the wrapper: the kernel for CUDA tensors, the plain
version for CPU tensors); CUDA sources live in ``repro_torch/csrc`` and
are built by :mod:`._build` at first use.  :func:`count_launch` is where
every wrapper counts its launches.

Training: a wrapper called on CUDA tensors of which one requires a
gradient runs the kernel inside a ``torch.autograd.Function`` whose
backward is the autograd of the kernel's plain version, recomputed from
the saved inputs (:func:`plain_vjp`): the counterpart of the reference,
whose JAX AD differentiates plain ``jnp``.  The backward launches no
kernel.  With no input requiring a gradient the wrapper is the plain
kernel call, with nothing saved.
"""
import threading

import torch


def count_launch(fn, n: int = 1) -> None:
    """Count ``n`` launches of ``fn``'s kernel where the wrapper launches
    it: ``fn.launches``, and ``fn.launches_by_thread`` by the launching
    thread's name (``spmd_map``'s rank threads are ``spmd-rank<r>``)."""
    fn.launches += n
    by = fn.launches_by_thread
    name = threading.current_thread().name
    by[name] = by.get(name, 0) + n


def grad_wanted(*tensors) -> bool:
    """Whether a wrapper call must record a backward: grad mode on and
    one of ``tensors`` requiring a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, wanted, cotangents):
    """The gradients of ``plain(*inputs)`` (the kernel's plain version)
    with respect to the inputs flagged in ``wanted``, recomputed from the
    inputs and pulled back from ``cotangents`` (one a output, None for an
    output with no gradient).  Returns one entry an input, None where not
    wanted."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(w))
              if isinstance(t, torch.Tensor) else t
              for t, w in zip(inputs, wanted)]
        outs = plain(*xs)
        if not isinstance(outs, tuple):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, cotangents)
                 if g is not None and o.requires_grad]
        srcs = [x for x, w in zip(xs, wanted) if w]
        got = torch.autograd.grad(
            [o for o, _ in pairs], srcs, [g for _, g in pairs],
            allow_unused=True) if pairs and srcs else [None] * len(srcs)
    it = iter(got)
    return [next(it) if w else None for w in wanted]
