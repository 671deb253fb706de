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

Costs: every wrapper records each call's work exactly once, whatever the
device, with :func:`record_cost` (its formula: the FLOPs and bytes the
hand-written kernel does on the card), into every cost counter active on
the calling thread (:mod:`repro_torch.launch.costs`, found on the
thread's dispatch-mode stack, which autograd carries to its worker
threads).  On the CPU a wrapper runs its plain version inside
:func:`cost_paused`, so the plain version's own matmuls are not counted
a second time.  On the meta device a wrapper returns outputs of the
kernel's shapes, dtypes and strides (and allocates the kernel's scratch
there) and runs nothing: the dry run's third device, not a fallback.
"""
import contextlib
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


def cost_sinks() -> list:
    """The cost sinks active on this thread, innermost last: the cost
    counters, and a remat segment's liveness tracker
    (:mod:`repro_torch.distributed.spmd_autograd`), which reads a
    kernel call's inputs from its record."""
    if not torch._C._len_torch_dispatch_stack():
        return []
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m for m in _get_current_dispatch_mode_stack()
            if getattr(m, "cost_sink", False)]


def record_cost(name: str, flops: float, nbytes: float,
                launches: int = 1, reads=()) -> None:
    """Record ``launches`` launches of kernel ``name`` doing ``flops`` and
    moving ``nbytes`` in all, reading the tensors ``reads`` (None
    skipped), into every active cost counter."""
    for sink in cost_sinks():
        sink.kernel(name, flops, nbytes, launches,
                    [t for t in reads if t is not None])


@contextlib.contextmanager
def cost_paused():
    """Count no matmul inside the block (a plain version standing in for
    a kernel whose formula was recorded); memory is still tracked."""
    sinks = cost_sinks()
    for s in sinks:
        s.paused += 1
    try:
        yield
    finally:
        for s in sinks:
            s.paused -= 1


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (None skipped), each counted whole."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def grad_wanted(*tensors) -> bool:
    """Whether a wrapper call must record a backward: grad mode on and
    one of ``tensors`` requiring a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def apply(fn, *args):
    """``fn.apply(*args)`` (an ``autograd.Function``) as a torch function,
    so the torch-function modes active on the thread see its tensor
    arguments (the training tape's junctions:
    :mod:`repro_torch.distributed.spmd_autograd`)."""
    tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
    if torch.overrides.has_torch_function(tensors):
        return torch.overrides.handle_torch_function(apply, tensors, fn,
                                                     *args)
    return fn.apply(*args)


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
