"""The port's tensor-parallel model and serving paths held against the
reference under ``shard_map`` on a (data 2, model 4) mesh.

Params and tokens are drawn with numpy (the reference's helpers draw with
``jax.random``) and fed to both packages: the reference runs on 8 fake
devices (``tests/helpers/torch_tp_ref.py``, three child processes side
by side), the port on 8 rank threads of ``LocalCluster(8, device="cpu")``
through ``spmd_map`` (``LciAxis``), every param cut by its spec's
``pspec()`` (tp over ``model``, FSDP over ``data``).

* ``forward`` of ``dist_equivalence.py``'s configs — dense Plan A
  (heads and kv sharded), Plan A with the kv heads replicated, Plan B
  with sliding windows, moe, ssm, hybrid, vlm (image embeddings at
  (None, "data", None), the gates drawn nonzero) and whisper (frames at
  ("model", "data", None)) — in BSP and LCI_DEDICATED: the hidden states
  at the float32 tolerance of ``test_torch_models.py`` (1e-4) and the
  aux terms at 1e-5 (the gradient half of that helper is
  ``test_torch_train_tp.py``'s);
* ``tp2d_decode.py``'s four configs (dense, gqa-par, ssm, moe), the
  dense config at batch 1 (``joint_kv``), and the vlm and whisper
  configs above with their cross-KV computed at one rank and cut by
  ``cache_pspecs``: teacher-forced greedy tokens of the classic and the
  tp2d decode equal the reference's under ``shard_map``, and each agrees
  with the local oracle on more than 0.95 of them;
* the ``Comm`` methods on the mesh in every mode (bitwise where no sum is
  taken, 1e-5 otherwise) and ``get_attr`` / ``attrs`` against the
  reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.modes import CommConfig, CommMode
from repro_torch.core.progress import EndpointSpec
from repro_torch.distributed import Comm, Mesh, P, spmd_map
from repro_torch.distributed import local_comm
from repro_torch.models import lm as lm_mod
from repro_torch.models.blocks import tp_plan
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.serving import cache_pspecs, init_cache, make_serve_step
from repro_torch.serving.engine import precompute_cross_kv

HELPERS = os.path.join(os.path.dirname(__file__), "helpers")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MODES = (CommMode.BSP, CommMode.LCI_DEDICATED)

#: dist_equivalence.py's ported configs (ModelConfig fields, float32)
FORWARD = {
    "planA": dict(family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=4, d_ff=128, vocab=256, tp_target=4),
    "planA-kvrep": dict(family="dense", n_layers=2, d_model=64, n_heads=8,
                        n_kv_heads=2, d_ff=128, vocab=256, tp_target=4,
                        head_dim=16),
    "planB-swa": dict(family="dense", n_layers=2, d_model=64, n_heads=3,
                      n_kv_heads=3, d_ff=128, vocab=256, tp_target=4,
                      head_dim=16, sliding_window=8,
                      swa_every_nth_global=2),
    "moe": dict(family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=96, vocab=256, n_experts=8, top_k=2,
                tp_target=4, capacity_factor=8.0, shared_expert_ff=64),
    "ssm": dict(family="ssm", n_layers=2, d_model=64, n_heads=0,
                n_kv_heads=0, d_ff=0, vocab=256, ssm_state=16,
                ssm_headdim=16, ssm_chunk=8, tp_target=4),
    "hybrid": dict(family="hybrid", n_layers=2, d_model=64, n_heads=5,
                   n_kv_heads=5, d_ff=128, vocab=256, ssm_state=8,
                   ssm_headdim=16, ssm_chunk=8, tp_target=4, head_dim=16),
    "vlm": dict(family="vlm", n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=128, vocab=256, cross_attn_every=2,
                tp_target=4),
    "whisper": dict(family="audio", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=4, d_ff=128, vocab=256, norm="layernorm",
                    mlp="gelu", encoder_layers=2, tp_target=4,
                    tie_embeddings=True),
}
#: a vlm or audio case's frontend stub: (batch key, rows, batch spec)
EXTRAS = {"vlm": ("image_embeds", 8, P(None, "data", None)),
          "audio": ("frames", 16, P("model", "data", None))}

#: tp2d_decode.py's configs, and the dense one at batch 1 (joint_kv)
DECODE = {
    "dense": (dict(family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=4, d_ff=128, vocab=256, tp_target=4), 4),
    "gqa-par": (dict(family="dense", n_layers=2, d_model=64, n_heads=8,
                     n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                     norm="layernorm", parallel_block=True,
                     tie_embeddings=True, tp_target=4), 4),
    "ssm": (dict(family="ssm", n_layers=2, d_model=64, n_heads=0,
                 n_kv_heads=0, d_ff=0, vocab=256, ssm_state=16,
                 ssm_headdim=16, ssm_chunk=8, tp_target=4), 4),
    "moe": (dict(family="moe", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=4, d_ff=96, vocab=256, n_experts=8, top_k=2,
                 tp_target=4, capacity_factor=8.0, shared_expert_ff=64), 4),
    "dense-b1": (dict(family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=128, vocab=256, tp_target=4), 1),
    "vlm": (FORWARD["vlm"], 4),
    "whisper": (FORWARD["whisper"], 4),
}
S_DECODE = 16


def pconfig(name: str, fields: dict) -> ModelConfig:
    return ModelConfig(name=name, dtype=torch.float32, **fields)


def draw_params(cfg: ModelConfig, seed: int):
    """(params, specs): the port's param tree with every drawn weight
    replaced by a numpy normal draw (σ = 1/sqrt(fan-in)); the ones and
    zeros of norms and SSM vectors are kept, but a vlm config's gates
    (zero at init: the cross layers would add nothing) are drawn, |tanh|
    0.3-0.7."""
    params, specs = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(seed)

    def draw(t, spec):
        stacked = spec.stacked
        if t.ndim - int(stacked) < 2:
            return t.numpy()
        fan_in = t.shape[-2]
        return (rng.standard_normal(tuple(t.shape)) /
                np.sqrt(fan_in)).astype(np.float32)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return draw(node, spec)
    out = walk(params, specs)
    if "cross_layers" in out:
        for k in ("gate_attn", "gate_mlp"):
            n = out["cross_layers"][k].shape[0]
            out["cross_layers"][k] = (rng.uniform(0.3, 0.9, n) * rng.choice(
                [-1, 1], n)).astype(np.float32)
    return out, specs


def draw_extras(fields: dict, batch: int, seed: int) -> dict:
    """A vlm or audio case's frontend stub, numpy float32 (rows, batch,
    d); nothing for the other families."""
    if fields["family"] not in EXTRAS:
        return {}
    key, rows, _ = EXTRAS[fields["family"]]
    return {key: np.random.default_rng(seed).standard_normal(
        (rows, batch, fields["d_model"])).astype(np.float32)}


def extra_specs(extras: dict) -> dict:
    return {k: next(sp for key, _, sp in EXTRAS.values() if key == k)
            for k in extras}


def flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def pspec_tree(specs):
    if isinstance(specs, dict):
        return {k: pspec_tree(v) for k, v in specs.items()}
    return specs.pspec()


def comm_inputs():
    rng = np.random.default_rng(7)
    return {"comm/x": rng.standard_normal((64, 12)).astype(np.float32),
            "comm/w": rng.standard_normal((12, 6)).astype(np.float32),
            "comm/wk": rng.standard_normal((12, 6)).astype(np.float32)}


@pytest.fixture(scope="module")
def tp_data(tmp_path_factory):
    """Inputs for both packages, and the reference's outputs (the three
    helpers run side by side, while the port's side runs)."""
    tmp = tmp_path_factory.mktemp("tp")
    data, cases = {}, {}
    for i, (name, fields) in enumerate(FORWARD.items()):
        params, specs = draw_params(pconfig(name, fields), 10 + i)
        tok = np.random.default_rng(30 + i).integers(
            0, fields["vocab"], size=(32, 4)).astype(np.int32)
        data.update(flatten(params, "f-" + name))
        data["f-" + name + "/tokens"] = tok
        data.update(flatten(draw_extras(fields, 4, 90 + i), "f-" + name))
        cases["f-" + name] = fields
    dcases = {}
    for i, (name, (fields, batch)) in enumerate(DECODE.items()):
        params, specs = draw_params(pconfig(name, fields), 50 + i)
        tok = np.random.default_rng(70 + i).integers(
            0, fields["vocab"], size=(S_DECODE, batch)).astype(np.int32)
        data.update(flatten(params, "d-" + name))
        data["d-" + name + "/tokens"] = tok
        data.update(flatten(draw_extras(fields, batch, 95 + i),
                            "d-" + name))
        dcases["d-" + name] = fields
    data.update(comm_inputs())
    np.savez(tmp / "in.npz", **data)
    json.dump(cases, open(tmp / "forward.json", "w"))
    json.dump(dcases, open(tmp / "decode.json", "w"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {}
    for kind, cfile in (("forward", "forward.json"),
                        ("decode", "decode.json"), ("comm", "forward.json")):
        procs[kind] = subprocess.Popen(
            [sys.executable, os.path.join(HELPERS, "torch_tp_ref.py"),
             kind, str(tmp / "in.npz"), str(tmp / cfile),
             str(tmp / f"{kind}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    ref = _Results(procs, tmp)
    yield data, ref
    ref.close()


class _Results:
    """The helpers' outputs, each waited for when first read, so the
    port's side of the tests runs while the reference computes."""

    def __init__(self, procs, tmp):
        self.procs, self.tmp, self.got = procs, tmp, {}

    def __getitem__(self, kind):
        if kind not in self.got:
            stdout, stderr = self.procs[kind].communicate(timeout=900)
            assert self.procs[kind].returncode == 0 and \
                "HELPER-OK" in stdout, stderr
            self.got[kind] = dict(np.load(self.tmp / f"{kind}.npz"))
        return self.got[kind]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _is_input(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in ("tokens", "image_embeds", "frames")


def _extras(data, prefix) -> dict:
    return {k: torch.from_numpy(data[f"{prefix}/{k}"])
            for k in ("image_embeds", "frames") if f"{prefix}/{k}" in data}


def _params(data, prefix, specs):
    tree = {}
    for k, v in data.items():
        if k.startswith(prefix + "/") and not _is_input(k):
            node = tree
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(np.array(v))
    return tree


@pytest.fixture(scope="module")
def mesh():
    with Mesh((2, 4), ("data", "model"), device="cpu") as m:
        yield m


def _forward_rank(cfg):
    def fn(comm, params, tokens, extras):
        x, aux = build_model(cfg, device="cpu").forward(
            params, {"tokens": tokens, **extras}, comm)
        return x, {k: v.reshape(1) for k, v in aux.items()}
    return fn


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_matches_reference(tp_data, mesh, name, mode):
    data, ref = tp_data
    cfg = pconfig(name, FORWARD[name])
    _, specs = build_model(cfg, device="cpu").init(0)
    params = _params(data, "f-" + name, specs)
    tokens = torch.from_numpy(data["f-" + name + "/tokens"])
    extras = _extras(data, "f-" + name)
    x, aux = spmd_map(_forward_rank(cfg), mesh,
                      (pspec_tree(specs), P("model", "data"),
                       extra_specs(extras)),
                      (P(None, "data"), P(("data", "model"))),
                      config=CommConfig(mode=mode))(params, tokens, extras)
    want = ref["forward"][f"f-{name}/{mode.value}/x"]
    np.testing.assert_allclose(x.numpy(), want, atol=1e-4, rtol=1e-4)
    for k, v in aux.items():
        np.testing.assert_allclose(
            v.numpy(), ref["forward"][f"f-{name}/{mode.value}/{k}"],
            atol=1e-5, rtol=1e-5, err_msg=k)


def _decode_rank(cfg, S, batch, tp2d):
    def fn(comm, params, cache, tokens):
        serve = make_serve_step(cfg, comm, joint_kv=batch == 1, tp2d=tp2d)
        preds = []
        for i in range(S):
            nxt, cache = serve(params, cache, tokens[i])
            preds.append(nxt)
        return torch.stack(preds)
    return fn


def _fresh_cache(cfg, params, extras, S, batch):
    """A zeroed cache; a vlm or audio case's holds the cross-KV computed
    at one rank (of the image embeddings, or of the encoder's memory)."""
    if not extras:
        return init_cache(cfg, S, batch, device="cpu")
    if cfg.is_encdec:
        mem = lm_mod._encode(params, extras, cfg, local_comm(),
                             tp_plan(cfg, 1), remat=False)
    else:
        mem = extras["image_embeds"]
    cache = init_cache(cfg, S, batch, n_memory=mem.shape[0], device="cpu")
    cache.cross_k, cache.cross_v = precompute_cross_kv(params, mem, cfg)
    return cache


def _local_decode(cfg, params, tokens, extras):
    serve = make_serve_step(cfg)
    cache = _fresh_cache(cfg, params, extras, tokens.shape[0],
                         tokens.shape[1])
    preds = []
    for i in range(tokens.shape[0]):
        nxt, cache = serve(params, cache, tokens[i])
        preds.append(nxt)
    return torch.stack(preds).numpy()


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_classic_and_tp2d_match_reference(tp_data, mesh, name):
    data, ref = tp_data
    fields, batch = DECODE[name]
    cfg = pconfig(name, fields)
    _, specs = build_model(cfg, device="cpu").init(0)
    params = _params(data, "d-" + name, specs)
    tokens = torch.from_numpy(data["d-" + name + "/tokens"])
    extras = _extras(data, "d-" + name)
    oracle = _local_decode(cfg, params, tokens, extras)
    got = {}
    for tp2d in (False, True):
        cspecs = cache_pspecs(cfg, batch=batch, tp2d=tp2d)
        tok_spec = P(None, "data") if (batch > 1 and not tp2d) else P()
        cache = _fresh_cache(cfg, params, extras, S_DECODE, batch)
        got["tp2d" if tp2d else "classic"] = spmd_map(
            _decode_rank(cfg, S_DECODE, batch, tp2d), mesh,
            (pspec_tree(specs), cspecs, tok_spec), tok_spec,
            config=CommConfig(mode=CommMode.LCI_DEDICATED))(
            params, cache, tokens).numpy()
    np.testing.assert_array_equal(oracle, ref["decode"][f"d-{name}/oracle"])
    for kind, toks in got.items():
        np.testing.assert_array_equal(toks, ref["decode"][f"d-{name}/{kind}"],
                                      err_msg=kind)
        assert (toks == oracle).mean() > 0.95, (kind, (toks == oracle).mean())


def _comm_rank(comm, x, w, wk):
    i64 = torch.float32
    r = {
        "tp": torch.full((1,), comm.tp, dtype=i64),
        "dp": torch.full((1,), comm.dp, dtype=i64),
        "model_index": torch.full((1,), comm.model_index(), dtype=i64),
        "data_index": torch.full((1,), comm.data_index(), dtype=i64),
        "ag_matmul": comm.ag_matmul(x, w), "matmul_rs": comm.matmul_rs(x, wk),
        "matmul_ar": comm.matmul_ar(x, wk), "ag_seq": comm.ag_seq(x),
        "rs_seq": comm.rs_seq(x), "psum_model": comm.psum_model(x),
        "psum_model_ge": comm.psum_model_ge(x),
        "pmax_model": comm.pmax_model(x),
        "a2a": comm.a2a(x.reshape(4, -1, x.shape[-1]), split_axis=0,
                        concat_axis=1),
        "weight": comm.weight(wk, fsdp_axis=1),
        "psum_data": comm.psum_data(x), "ag_data": comm.ag_data(x, axis=1),
        "pmean_data": comm.pmean_data(x), "psum_all": comm.psum_all(x),
        "pmean_all": comm.pmean_all(x),
        "barrier": comm.barrier().reshape(1).float(),
    }
    return {k: v if k in ("tp", "dp", "model_index", "data_index",
                          "barrier") else v[None] for k, v in r.items()}


_EXACT = {"tp", "dp", "model_index", "data_index", "ag_seq", "pmax_model",
          "a2a", "weight", "ag_data", "barrier"}


@pytest.mark.parametrize("mode", list(CommMode), ids=[m.value for m in
                                                      CommMode])
def test_comm_methods_match_reference(tp_data, mesh, mode):
    data, ref = tp_data
    x, w, wk = (torch.from_numpy(data[k]) for k in ("comm/x", "comm/w",
                                                      "comm/wk"))
    got = spmd_map(_comm_rank, mesh, (P(("data", "model")), P(), P()),
                   P(("data", "model")), config=CommConfig(mode=mode)
                   )(x, w, wk)
    for k, v in got.items():
        want = ref["comm"][f"{mode.value}/{k}"]
        if k in _EXACT:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", list(CommMode), ids=[m.value for m in
                                                      CommMode])
def test_get_attr_and_attrs_match_reference(tp_data, mode):
    _, ref = tp_data
    for ep in (None, EndpointSpec(n_devices=3, progress="dedicated"),
               EndpointSpec(n_devices=2, progress="shared")):
        c = Comm(CommConfig(mode=mode, n_channels=5))
        if ep is not None:
            c = c.with_endpoint(ep)
        got = {"attrs": {k: str(v) for k, v in c.attrs.items()},
               "get": {n: str(c.get_attr(n)) for n in
                       ("mode", "n_channels", "tp", "dp", "wire_bf16",
                        "inject_max_bytes")},
               "mode": c.cfg.mode.value,
               "channels": c.cfg.resolved_channels()}
        key = f"attrs/{mode.value}/{None if ep is None else ep.progress}"
        want = json.loads(ref["comm"][key].tobytes().decode())
        assert got == want, key


def test_params_from_numpy_cuts_each_ranks_shard(tp_data, mesh):
    """``params_from_numpy(..., specs=, mesh=, rank=)`` hands each rank
    exactly the shard ``spmd_map`` cuts from the full tree."""
    from repro_torch.distributed import shard
    from repro_torch.models.registry import params_from_numpy
    data, _ = tp_data
    cfg = pconfig("moe", FORWARD["moe"])
    _, specs = build_model(cfg, device="cpu").init(0)
    full = _params(data, "f-moe", specs)
    tree = {k: (v.numpy() if not isinstance(v, dict)
                else {kk: vv.numpy() for kk, vv in v.items()})
            for k, v in full.items()}
    for rank in range(mesh.size):
        got = params_from_numpy(cfg, tree, "cpu", specs=specs, mesh=mesh,
                                rank=rank)
        for k, spec in specs["layers"].items():
            want = shard(full["layers"][k], spec.pspec(), mesh, rank)
            assert torch.equal(got["layers"][k], want), (rank, k)
        assert torch.equal(got["emb"], shard(full["emb"],
                                             specs["emb"].pspec(), mesh,
                                             rank))


def test_unbound_devices_default_to_the_card(tmp_path):
    """A Comm with no axis bound puts its barrier token on the card unless
    asked for another device, and ``DistAxis`` / ``dist_axes`` bind the
    card unless given ``device="cpu"``: without a card they raise."""
    import torch.distributed as dist
    from repro_torch.core.axis import DistAxis
    from repro_torch.core.status import FatalError
    from repro_torch.distributed import dist_axes, local_comm
    tok = local_comm().barrier(device="cpu")
    assert tok.device.type == "cpu" and int(tok) == 1
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            world_size=1, rank=0)
    try:
        assert DistAxis([0], device="cpu").device == torch.device("cpu")
        assert dist_axes((1,), ("x",), device="cpu")["x"].device.type == \
            "cpu"
        if torch.cuda.is_available():
            assert local_comm().barrier().is_cuda
            assert DistAxis([0]).device.type == "cuda"
        else:
            with pytest.raises(FatalError):
                local_comm().barrier()
            with pytest.raises(FatalError):
                DistAxis([0])
            with pytest.raises(FatalError):
                dist_axes((1,), ("x",))
    finally:
        dist.destroy_process_group()
