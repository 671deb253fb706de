"""The configuration as the program takes it, and its weights from the seed.

The sizes come from the configuration's file under ``bench/configs``
(``model``, and ``smoke`` over it for the CPU tests), never from the
program's own config modules.  The program is asked only for the layout
of its parameters (keys, shapes, dtypes, on the meta device); the
weights are drawn here, on the run's device from one generator seeded by
the run's seed, one call a stacked leaf, in the dtype they are served in.
The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

from . import seeds


def model_fields(config: Dict[str, Any], smoke: bool = False
                 ) -> Dict[str, Any]:
    """The configuration's model fields (``smoke`` applied over them)."""
    fields = dict(config["model"])
    if smoke:
        fields.update(config.get("smoke", {}))
    return fields


def program_config(config: Dict[str, Any], smoke: bool = False):
    """The program's ``ModelConfig`` for this configuration."""
    from repro_torch.models.common import ModelConfig
    name = config["name"] + ("-smoke" if smoke else "")
    return ModelConfig(name=name, dtype=getattr(torch, config["dtype"]),
                       **model_fields(config, smoke))


def leaves(tree: Dict[str, Any], prefix: str = ""
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of a nested dict, in key order."""
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v


#: the projections that write into the residual stream
RESIDUAL_OUT = ("wo", "w_out", "ssm_w_out", "we_out")


def _draw(key: str, shape, dtype, gen, device, init: Dict[str, Any],
          layers: int) -> torch.Tensor:
    """One leaf: the rule for its kind of parameter (the configuration's
    ``init``: ``matrix`` ``"normal"`` N(0, s²) or ``"uniform"`` U(-s, s),
    s = ``std`` where given, else 1/sqrt(fan_in), the fan-in the stacked
    leaf's second-last dim (``"uniform"`` is PyTorch's Linear default);
    ``residual_rescale``: the projections into the residual stream over
    sqrt(layers), Mamba's ``rescale_prenorm_residual``)."""
    if "norm" in key or key.endswith("d_skip"):
        return torch.ones(shape, dtype=dtype, device=device)
    if key.endswith("a_log"):              # A = -U(1, 16)
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return torch.log1p(15.0 * u).to(dtype)
    if key.endswith("dt_bias"):            # softplus^-1(dt), dt log-uniform
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if key in ("emb", "lm_head"):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(0.02)
    scale = init.get("std") or 1.0 / math.sqrt(shape[-2])   # fan-in
    if key in RESIDUAL_OUT and init.get("residual_rescale"):
        scale /= math.sqrt(layers)
    if init.get("matrix", "normal") == "uniform":
        t = torch.rand(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(2.0 * scale).sub_(scale)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(scale)


def make_weights(cfg, seed: int, device, init: Dict[str, Any] = None
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, specs): the program's parameter layout, filled from
    ``seed`` on ``device`` by the configuration's ``init`` rules."""
    init = init or {}
    from repro_torch.models.lm import init_params
    layout, specs = init_params(cfg, torch.Generator(), device="meta")
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "weights"))

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            else:
                out[k] = _draw(k, tuple(v.shape), v.dtype, gen, device, init,
                               cfg.n_layers)
        return out
    return fill(layout), specs
