"""Each ``Comm`` transpose sends what JAX's AD of the reference's ring
sends, and gives its cotangents.

Every case runs a ``Comm`` method and its backward through the tape
(:mod:`repro_torch.distributed.spmd_autograd`) on ``LciAxis`` rank
threads under :class:`~repro_torch.launch.costs.CostCounter`, with the
messages of every outermost axis call logged (kind, dtype, bytes, ring
direction), and holds them against the reference: its ``Comm`` method
under ``shard_map`` pulled back with ``jax.vjp``, counted by
``repro.launch.costs.count_costs`` and walked for its collectives
(``tests/helpers/torch_costs_ref.py transposes``, a child on 4 fake
devices that runs while the port's cases run):

* ``ag_matmul``, ``matmul_rs``, ``ag_seq``, ``rs_seq``, ``a2a`` and the
  FSDP ``weight`` gather at P = 2 and 4, ``LCI_SHARED`` and
  ``LCI_DEDICATED``, float32 and bf16, with and without ``wire_bf16``:
  the collectives' bytes by kind, ppermute bytes and steps by direction
  and the multiset of messages equal; the cotangents within 1e-5 of the
  largest (float32) or, in bf16, within twice the reference's own
  distance from its float32 run on the same inputs (at least one bf16
  step, 2^-8, of the largest);
* a remat segment ``x + matmul_rs(gelu(ag_matmul(x, w1)), w2)`` against
  the reference's ``jax.checkpoint``: the recompute runs the
  ``ag_matmul`` ring (its transpose reads the chunks) and not the
  ``matmul_rs`` ring (its output only reaches the segment's output);
* the loss chunk (``lm_head_loss`` checkpointed with ``keep=True``)
  against the reference's un-rematerialized one: its ``pmax`` and
  ``psum`` s run once.

Inputs come from numpy with a seed; bf16 cases use the same values
rounded to bf16.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.axis import LciAxis
from repro_torch.core.modes import CommConfig, CommMode
from repro_torch.distributed import Mesh, spmd_map
from repro_torch.distributed.spmd_autograd import Tape, checkpoint
from repro_torch.distributed.spmd_map import PER_RANK
from repro_torch.launch.costs import CostCounter
from repro_torch.models.layers import lm_head_loss

HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

METHODS = ("ag_matmul", "matmul_rs", "ag_seq", "rs_seq", "a2a", "weight")
MODES = ("lci_shared", "lci_dedicated")
PS = (2, 4)
S, B, K, N = 4, 2, 6, 8


def _case_id(method, p, mode, dtype, wire):
    return f"{method}-p{p}-{mode}-{dtype}" + ("-wire" if wire else "")


CASES = [(m, p, mode, dt, wire) for m in METHODS for p in PS
         for mode in MODES for dt in ("float32", "bfloat16")
         for wire in (False, True)]
CASES += [(m, p, mode, "float32", False) for m in ("segment", "loss")
          for p in PS for mode in MODES]


def _inputs(method, p, rng):
    """The rank-stacked inputs of ``method`` at ``p`` ranks and the
    ranks' cotangents, float32 values exact in bf16."""
    def r(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    if method == "ag_matmul":
        return [r(p, S, B, K), r(p, K, N // p)], r(p, S * p, B, N // p)
    if method == "matmul_rs":
        return [r(p, S * p, B, K), r(p, K, N)], r(p, S, B, N)
    if method == "ag_seq":
        return [r(p, S, B, K)], r(p, S * p, B, K)
    if method == "rs_seq":
        return [r(p, S * p, B, K)], r(p, S, B, K)
    if method == "a2a":
        return [r(p, 8, 4, K)], r(p, 8 // p, 4 * p, K)
    if method == "weight":
        return [r(p, K, N // p)], r(p, K, N)
    if method == "segment":
        return [r(p, S, B, K), r(p, K, N // p), r(p, N // p, K)], \
            r(p, S, B, K)
    if method == "loss":                 # x and labels alike on each rank
        v_local = 5
        x = np.broadcast_to(r(1, S * p, B, K), (p, S * p, B, K)).copy()
        labels = np.broadcast_to(
            rng.integers(0, v_local * p - 3, (1, S * p, B)),
            (p, S * p, B)).astype(np.float32).copy()
        return [x, r(p, v_local, K), labels], np.ones((p,), np.float32)
    raise ValueError(method)


def _all_inputs():
    rng = np.random.default_rng(2028)
    out = {}
    for m in METHODS + ("segment", "loss"):
        for p in PS:
            xs, ct = _inputs(m, p, rng)
            for i, x in enumerate(xs):
                out[f"{m}/{p}/{i}"] = x
            out[f"{m}/{p}/ct"] = ct
    return out


INPUTS = _all_inputs()


# ---------------------------------------------------------------------------
# the reference, in a child while the port's cases run
# ---------------------------------------------------------------------------

class _Reference:
    def __init__(self, tmp):
        np.savez(tmp / "in.npz", **INPUTS)
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({
            "inputs": str(tmp / "in.npz"),
            "cases": [[_case_id(*c)] + list(c) for c in CASES]}))
        self.out = str(tmp / "out")
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HELPERS, "torch_costs_ref.py"),
             "transposes", str(spec), self.out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._got = None

    def result(self):
        if self._got is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "HELPER-OK" in out, err
            self._got = (json.loads(open(self.out + ".json").read()),
                         dict(np.load(self.out + ".npz")))
        return self._got


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("transposes_ref"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


# ---------------------------------------------------------------------------
# the port: the tape on rank threads, counted and logged
# ---------------------------------------------------------------------------

_log = threading.local()
#: the axis calls logged, and the kind each is a message of
LOGGED = {"ppermute_start": "ppermute", "all_gather": "all_gather",
          "psum": "psum", "pmax": "pmax", "psum_scatter": "reduce_scatter",
          "all_to_all_n": "all_to_all"}


@pytest.fixture
def logged(monkeypatch):
    """Each outermost ``LciAxis`` call of a rank thread appends its
    messages to that thread's ``_log.messages``."""
    for name, kind in LOGGED.items():
        monkeypatch.setattr(LciAxis, name, _logging(getattr(LciAxis, name),
                                                    kind))


def _logging(method, kind):
    def call(self, x, *args, **kwargs):
        depth = getattr(_log, "depth", 0)
        if depth == 0 and hasattr(_log, "messages"):
            xs = x if kind == "all_to_all" else [x]
            way = ""
            if kind == "ppermute":
                perm = args[0] if args else kwargs["perm"]
                src, dst = perm[0]
                n = max(max(q) for q in perm) + 1
                way = "fwd" if dst == (src + 1) % n else "bwd"
            _log.messages.extend(
                [kind, str(t.dtype).replace("torch.", ""),
                 t.numel() * t.element_size(), way] for t in xs)
        _log.depth = depth + 1
        try:
            return method(self, x, *args, **kwargs)
        finally:
            _log.depth = depth
    return call


def _method(comm, method, remat=True):
    if method == "ag_matmul":
        return comm.ag_matmul
    if method == "matmul_rs":
        return comm.matmul_rs
    if method == "ag_seq":
        return comm.ag_seq
    if method == "rs_seq":
        return comm.rs_seq
    if method == "a2a":
        return lambda x: comm.a2a(x, split_axis=0, concat_axis=1)
    if method == "weight":
        return lambda w: comm.weight(w, fsdp_axis=1)
    if method == "segment":
        def seg(x, w1, w2):
            h = F.gelu(comm.ag_matmul(x, w1), approximate="tanh")
            return x + comm.matmul_rs(h, w2)
        return (lambda *a: checkpoint(seg, *a)) if remat else seg

    def loss(x, emb, labels):
        return lm_head_loss(x, emb, labels.long(), comm,
                            real_vocab=emb.shape[0] * comm.tp - 3)[0]
    return lambda x, emb, labels: checkpoint(loss, x, emb, labels,
                                             keep=True)


def _port(method, p, mode, dtype, wire, remat=True):
    """(cotangents [rank-stacked float32], costs of rank 0, messages of
    rank 0)."""
    n_in = sum(1 for k in INPUTS if k.startswith(f"{method}/{p}/")
               and k[-1].isdigit())
    dt = getattr(torch, dtype)
    xs = [torch.from_numpy(INPUTS[f"{method}/{p}/{i}"]) for i in
          range(n_in)]
    xs = [x if method == "loss" and i == 2 else x.to(dt)
          for i, x in enumerate(xs)]
    ct = torch.from_numpy(INPUTS[f"{method}/{p}/ct"])
    n_diff = 2 if method == "loss" else n_in

    def rank(comm, *a):
        ins, c = list(a[:-1]), a[-1]
        _log.messages = []
        try:
            with CostCounter() as counter:
                leaves = [t.clone().requires_grad_() for t in ins[:n_diff]]
                tape = Tape()
                with tape.recording():
                    y = _method(comm, method, remat)(*leaves,
                                                     *ins[n_diff:])
                tape.backward([y], [c.to(y.dtype)])
            return ([t.grad.float() for t in leaves],
                    counter.costs.as_dict(), sorted(_log.messages))
        finally:
            del _log.messages

    shape = (p, 1) if method == "weight" else (1, p)
    with Mesh(shape, ("data", "model"), device="cpu") as mesh:
        got = spmd_map(rank, mesh, (PER_RANK,) * (n_in + 1), PER_RANK,
                       config=CommConfig(mode=CommMode(mode),
                                         wire_bf16=wire))(
            *[list(x) for x in xs], list(ct))
    grads = [torch.stack([g[0][i] for g in got]).numpy()
             for i in range(n_diff)]
    return grads, got[0][1], got[0][2]


DIRS = ("ppermute_fwd_bytes", "ppermute_bwd_bytes", "ppermute_fwd_steps",
        "ppermute_bwd_steps")


def _check_counts(costs, msgs, ref):
    r = ref["costs"]
    assert costs["coll_bytes_by_kind"] == r["coll_bytes_by_kind"]
    assert {k: costs[k] for k in DIRS} == {k: r[k] for k in DIRS}
    assert msgs == [list(m) for m in ref["messages"]]


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in METHODS],
                         ids=lambda c: _case_id(*c))
def test_transpose_sends_the_references_messages(case, reference, logged):
    """Messages, bytes, dtypes and directions equal the reference's AD;
    the cotangents its (see the module docstring)."""
    method, p, mode, dtype, wire = case
    cid = _case_id(*case)
    grads, costs, msgs = _port(*case)
    info, ref = reference.result()
    _check_counts(costs, msgs, info[cid])
    if method == "ag_matmul":            # no second gather of x
        assert not any(m[0] == "all_gather" for m in msgs)
        assert sum(m[0] == "ppermute" for m in msgs) == 2 * (p - 1)
    for i, g in enumerate(grads):
        want = ref[f"{cid}/{i}"]
        scale = float(np.abs(want).max())
        err = float(np.abs(g - want).max())
        if dtype == "float32":
            assert err <= 1e-5 * scale, (cid, i, err)
        else:
            own = float(np.abs(want - ref[f"{cid}/f32/{i}"]).max())
            assert err <= max(2 * own, 2.0 ** -8 * scale), (cid, i, err, own)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "segment"],
                         ids=lambda c: _case_id(*c))
def test_recompute_leaves_out_the_unread_ring(case, reference, logged):
    """A remat segment's recompute runs the ``ag_matmul`` ring and not the
    closing ``matmul_rs`` ring: its messages are the plain run's plus one
    ``ag_matmul`` forward ring, and equal ``jax.checkpoint``'s."""
    method, p, mode, dtype, wire = case
    cid = _case_id(*case)
    grads, costs, msgs = _port(*case)
    _, _, plain = _port(*case, remat=False)
    info, ref = reference.result()
    _check_counts(costs, msgs, info[cid])
    extra = list(msgs)
    for m in plain:
        extra.remove(m)
    shard = S * B * K * 4
    assert extra == [["ppermute", "float32", shard, "fwd"]] * (p - 1) or \
        sorted(extra) == sorted(
            [["ppermute", "float32", shard, "fwd"]] * (p // 2)
            + [["ppermute", "float32", shard, "bwd"]] * (p - 1 - p // 2))
    for i, g in enumerate(grads):
        want = ref[f"{cid}/{i}"]
        assert float(np.abs(g - want).max()) <= 1e-5 * float(
            np.abs(want).max())


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "loss"],
                         ids=lambda c: _case_id(*c))
def test_loss_chunk_recompute_sends_nothing(case, reference, logged):
    """The checkpointed loss chunk (``keep=True``) sends one ``pmax`` and
    two ``psum`` s, as the reference's un-rematerialized chunk does, and
    gives its cotangents."""
    method, p, mode, dtype, wire = case
    cid = _case_id(*case)
    grads, costs, msgs = _port(*case)
    info, ref = reference.result()
    _check_counts(costs, msgs, info[cid])
    assert [m[0] for m in msgs].count("pmax") == 1
    assert [m[0] for m in msgs].count("psum") == 2
    for i, g in enumerate(grads):
        want = ref[f"{cid}/{i}"]
        assert float(np.abs(g - want).max()) <= 1e-5 * float(
            np.abs(want).max())
