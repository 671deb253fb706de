"""Training at tp > 1 on a (data 2, model 4) mesh of rank threads: the
thread guard, planted faults that the gradient check must catch, and a
reference fault the port does not copy (the cases and helpers of
``test_torch_train_tp.py``).

* the thread guard: during a training step of planA and ssm (remat on)
  every collective call of every ``LciAxis`` runs on its
  ``spmd-rank<r>`` thread, holding the baton, outside any autograd node
  (on the CPU a backward node runs on the calling thread, so only the
  node check tells the tape from a collective inside an
  ``autograd.Function``'s backward, which would run on the card's
  autograd device thread);
* planted faults: ``psum_model``'s transpose swapped for the identity
  (ssm), and ``ag_matmul``'s dropping the reduce-scatter's sum (planA),
  each fail the gradient check (1.13 and 1.03 of a leaf's largest
  element);
* with whisper's heads replicated (Plan B) the reference's encoder gives
  every rank's queries the positions of rank 0's frames; the port's
  forward matches the local oracle, the reference's under ``shard_map``
  does not.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.comm import local_comm as r_local_comm
from repro.models.common import ModelConfig as RConfig

import repro_torch.distributed.comm as comm_mod
from repro_torch.core import collectives as C
from repro_torch.core.axis import LciAxis
from repro_torch.core.modes import CommMode
from repro_torch.distributed import Mesh, P, spmd_map
from repro_torch.models.registry import build_model, params_from_numpy
from test_torch_tp import pspec_tree
from test_torch_train_tp import (CONFIGS, _case, _grad_distance,  # noqa
                                 _port_grads, mesh, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


# ---------------------------------------------------------------------------
# the thread guard
# ---------------------------------------------------------------------------

class _OwnedLock:
    """A lock that knows its holder (the mesh's baton, for the guard)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.owner = None

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            self.owner = threading.get_ident()
        return got

    def release(self):
        self.owner = None
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


ENTRY_POINTS = ("ppermute_start", "all_gather", "psum", "pmax",
                "psum_scatter", "all_to_all_n")


@pytest.mark.parametrize("name", ["planA", "ssm"])
def test_collectives_run_on_rank_threads(name, monkeypatch):
    """Every call of an ``LciAxis`` collective during a (2, 4) training
    step (forward, the tape's transposes and remat recomputes, grad
    sync) runs on an ``spmd-rank<r>`` thread, holding the mesh's baton,
    with no autograd node running."""
    calls = []

    def spy(fn):
        def wrapped(self, *a, **kw):
            calls.append((threading.current_thread().name,
                          self.baton.owner == threading.get_ident(),
                          torch._C._current_autograd_node() is None))
            return fn(self, *a, **kw)
        return wrapped
    for ep in ENTRY_POINTS:
        monkeypatch.setattr(LciAxis, ep, spy(getattr(LciAxis, ep)))
    with Mesh((2, 4), ("data", "model"), device="cpu") as mesh:
        mesh.baton = _OwnedLock()
        loss, grads, _ = _port_grads(name, CommMode.LCI_DEDICATED, mesh)
    assert len(calls) > 100
    assert all(t.startswith("spmd-rank") for t, _, _ in calls)
    assert all(held for _, held, _ in calls)
    assert all(free for _, _, free in calls)
    assert _grad_distance(name, grads) <= 2e-4


# ---------------------------------------------------------------------------
# planted faults: the gradient check fails for a wrong transpose
# ---------------------------------------------------------------------------

def _psum_identity(ax, ins, g):
    return [g]


def _ag_matmul_no_sum(ax, cfg, ins, g, chunks):
    """``ag_matmul``'s transpose without the reverse ring's sum: this
    rank's rows of its own ``g @ wᵀ``."""
    x, w = ins
    rows = x.shape[0]
    dx = torch.matmul(g, w.t())[ax.index * rows:(ax.index + 1) * rows]
    _, dw = C.all_gather_matmul_t(x, w, g, chunks, ax, cfg)
    return [dx.to(x.dtype), dw]


@pytest.mark.parametrize("name,target,fault", [
    ("ssm", "_psum_t", _psum_identity),
    ("planA", "_ag_matmul_t", _ag_matmul_no_sum),
], ids=["ssm-psum_model-identity", "planA-ag_matmul-no-sum"])
def test_wrong_transpose_fails_the_check(mesh, monkeypatch, name, target,
                                         fault):
    """With a wrong transpose planted, the synced gradients miss the
    oracle by far more than the check's 2e-4 (ssm: 1.13 of a leaf's
    largest element; planA: 1.03), while the loss is unchanged."""
    monkeypatch.setattr(comm_mod, target, fault)
    loss, grads, _ = _port_grads(name, CommMode.LCI_DEDICATED, mesh)
    assert abs(float(loss) - _case(name)[4]) <= 1e-4
    assert _grad_distance(name, grads) > 100 * 2e-4


# ---------------------------------------------------------------------------
# a fault of the reference the port does not copy
# ---------------------------------------------------------------------------

def test_plan_b_encoder_queries_at_their_positions(mesh, tmp_path):
    """whisper-planB at (2, 4): the port's distributed forward gives the
    reference's local forward (1e-4; 1.3e-4 at most), while the
    reference's own under ``shard_map`` (``tests/helpers/
    torch_tp_ref.py``, 8 fake devices) misses it by 3.0: its ``_encode``
    passes ``q_offset=0`` into Plan B, whose queries are each rank's own
    frames, so RoPE gives rank
    r's queries positions 0..t_local-1 instead of r t_local onwards
    (ROADMAP §C)."""
    import repro.models.lm as r_lm
    pcfg, host, batch, bspec, _, _ = _case("whisper-planB")
    ext = {"frames": batch["frames"]}
    model = build_model(pcfg, device="cpu")
    _, specs = model.init(0)
    x, _ = spmd_map(lambda c, p, t, e: model.forward(
        p, {"tokens": t, **e}, c), mesh,
        (pspec_tree(specs), P("model", "data"),
         {"frames": bspec["frames"]}),
        (P(None, "data"), P()))(
        params_from_numpy(pcfg, host, device="cpu"),
        torch.from_numpy(batch["tokens"]),
        {k: torch.from_numpy(v) for k, v in ext.items()})
    rcfg = RConfig(name="whisper-planB", dtype=jnp.float32,
                   **CONFIGS["whisper-planB"])
    want, _ = r_lm.forward(jax.tree_util.tree_map(jnp.asarray, host),
                           {"tokens": jnp.asarray(batch["tokens"]),
                            "frames": jnp.asarray(batch["frames"])},
                           rcfg, r_local_comm(), remat=False)
    want = np.asarray(want)
    np.testing.assert_allclose(x.numpy(), want, atol=1e-4, rtol=1e-4)

    data = {f"c/{k}": v for k, v in _flat(host).items()}
    data.update({"c/tokens": batch["tokens"], "c/frames": batch["frames"]})
    np.savez(tmp_path / "in.npz", **data)
    (tmp_path / "cases.json").write_text(json.dumps(
        {"c": CONFIGS["whisper-planB"]}))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, os.path.join(HELPERS, "torch_tp_ref.py"),
         "forward", str(tmp_path / "in.npz"), str(tmp_path / "cases.json"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        timeout=600, env=env)
    assert r.returncode == 0 and "HELPER-OK" in r.stdout, r.stderr
    ref_tp = np.load(tmp_path / "out.npz")["c/lci_dedicated/x"]
    assert np.abs(ref_tp - want).max() > 100 * 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out
