"""Elastic scaling: reshard a running job onto a different mesh.

The mechanism (DESIGN.md §7): checkpoints store *global* arrays with a
manifest; :func:`reshard_state` cuts them for each rank of the NEW
:class:`~repro_torch.distributed.Mesh` by their ``PartitionSpec``s
(``spmd_map.shard``).  The launcher flow on a node failure / resize:

    1. watchdog flags dead hosts (distributed.straggler.HostWatchdog)
    2. survivors agree on the new mesh (next divisor-compatible shape)
    3. restore_resharded(ckpt, tree, new_specs, new_mesh)
    4. data pipeline replays from manifest["next_step"] — bit-exact

``compatible_meshes`` enumerates legal (data, model) shapes for a config
(the model axis must divide every TP-sharded dim).
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

from ..models.common import ModelConfig, shard_decisions
from .spmd_map import shard, tree_map2


def compatible_meshes(cfg: ModelConfig, n_devices: int
                      ) -> List[Tuple[int, int]]:
    """All (data, model) shapes on n_devices this config can run under."""
    dec = shard_decisions(cfg)
    out = []
    for model in range(1, n_devices + 1):
        if n_devices % model:
            continue
        data = n_devices // model
        if dec["attn"] and model > 1 and cfg.n_heads % model:
            continue
        if dec["ssm"] and model > 1 and cfg.ssm_heads % model:
            continue
        if cfg.n_experts and model > 1 and cfg.n_experts % model:
            continue
        if cfg.padded_vocab % model:
            continue
        out.append((data, model))
    return out


def reshard_state(state: Any, specs: Any, mesh) -> List[Any]:
    """One tree per rank of ``mesh``: each leaf moved to the mesh's
    device and cut by its spec (``specs`` mirrors ``state`` or is one
    spec for a whole subtree; a leaf whose spec is ``None`` is shared by
    every rank as it is)."""
    placed = tree_map2(lambda t, _spec: t.to(mesh.device), state, specs)
    return [tree_map2(lambda t, spec: shard(t, spec, mesh, rank), placed,
                      specs)
            for rank in range(mesh.size)]


def shrink_mesh(old_shape: Tuple[int, ...], dead_fraction: float,
                cfg: Optional[ModelConfig] = None
                ) -> Tuple[int, ...]:
    """Pick the largest compatible mesh after losing ``dead_fraction``.

    Without ``cfg`` the model axis is kept and DP shrinks (every DP
    width is legal).  With ``cfg`` the answer must divide the model's
    sharded dims, so we snap to the largest shape ``compatible_meshes``
    allows on any device count <= the survivor count — including moving
    work off the model axis when the old width no longer fits.
    """
    n_old = math.prod(old_shape)
    target = int(n_old * (1 - dead_fraction))
    if cfg is None:
        # keep the model axis, shrink data (DP is the elastic axis)
        model = old_shape[-1]
        data = max(1, target // model)
        return (data, model)
    old_model = old_shape[-1]
    best: Optional[Tuple[int, int]] = None
    best_key = None
    for n in range(max(1, target), 0, -1):
        for data, model in compatible_meshes(cfg, n):
            # prefer more total devices, then keeping the old model
            # width (cheapest re-shard), then wider DP
            key = (data * model, model == old_model, data)
            if best_key is None or key > best_key:
                best, best_key = (data, model), key
        if best is not None:
            break                    # n is scanned largest-first
    if best is None:
        raise ValueError(
            f"shrink_mesh: no mesh on <= {target} device(s) is compatible "
            f"with this config (model axis must divide heads/experts/"
            f"vocab); survivors cannot host the model")
    return best
