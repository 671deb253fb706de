"""Model configuration and parameter-spec plumbing (PyTorch port).

The mirror of :mod:`repro.models.common`: one :class:`ModelConfig` covers
all ten architectures (family-specific fields are zero/empty when
unused), and :class:`ParamSpec` records per parameter which logical axis
is tensor-parallel and which is FSDP, with the reference's layout
decisions; ``ParamSpec.pspec`` turns it into the partition spec
``spmd_map`` cuts a full param by.

``dtype`` is a ``torch.dtype`` (default ``torch.bfloat16``).  The
:class:`ParamFactory` draws from an explicit ``torch.Generator`` with the
reference's truncated normal (±2σ, σ = ``scale / sqrt(shape[0])``) and
the reference's shapes; the numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


def _round_up(x: int, to: int) -> int:
    return ((x + to - 1) // to) * to


def shard_decisions(cfg: "ModelConfig") -> dict:
    """What is TP-sharded at ``cfg.tp_target``: read by the initializers
    (specs) and the TP plan alike, so the two never disagree."""
    t = cfg.tp_target
    attn = cfg.n_heads > 0 and cfg.n_heads % t == 0
    kv = attn and cfg.n_kv_heads % t == 0
    ssm = cfg.ssm_state > 0 and (cfg.ssm_heads % t == 0)
    return {"attn": attn, "kv": kv, "ssm": ssm}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # norms / MLP / block structure
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np
    mlp: str = "swiglu"              # swiglu | geglu | gelu | relu2
    parallel_block: bool = False     # attention & FFN in parallel (Cohere)
    tie_embeddings: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # attention pattern
    sliding_window: int = 0          # 0 = full attention everywhere
    swa_every_nth_global: int = 0    # e.g. 6 => layers 5,11,... global (5:1)
    global_layers: Tuple[int, ...] = ()   # explicit global layers (hymba)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv_kernel: int = 4
    ssm_groups: int = 1

    # VLM / enc-dec frontends
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    encoder_layers: int = 0
    n_audio_frames: int = 0

    # numerics
    dtype: Any = torch.bfloat16

    # the model-axis width the parameter layout targets
    tp_target: int = 16
    fsdp_params: bool = True
    tp_mlp: bool = True

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128; padded logit slots are
        masked to -1e30."""
        return _round_up(self.vocab, 128)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def n_cross_layers(self) -> int:
        """Cross-attention layers: a vlm config's gated layers (one every
        ``cross_attn_every``), every decoder layer of an enc-dec config,
        else 0."""
        if self.family == "vlm":
            return self.n_layers // self.cross_attn_every
        return self.n_layers if self.is_encdec else 0

    def uses_subquadratic_attention(self) -> bool:
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    def layer_is_global(self, i: int) -> bool:
        """Does layer ``i`` use full (global) attention?"""
        if self.sliding_window == 0:
            return True
        if i in self.global_layers:
            return True
        if self.swa_every_nth_global:
            return (i + 1) % self.swa_every_nth_global == 0
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, dh = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        per_layer = 0
        if self.family != "ssm":
            per_layer += d * (nq * dh) + 2 * d * (nkv * dh) + (nq * dh) * d
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_d_inner
            per_layer += d * (2 * di + 2 * self.ssm_groups * self.ssm_state
                              + self.ssm_heads)
            per_layer += di * d + self.ssm_conv_kernel * di + 2 * self.ssm_heads
        if self.n_experts:
            ff_mult = 3 if self.mlp == "swiglu" else 2
            per_layer += self.n_experts * ff_mult * d * self.d_ff
            per_layer += d * self.n_experts                    # router
            if self.shared_expert_ff:
                per_layer += ff_mult * d * self.shared_expert_ff
        elif self.d_ff:
            ff_mult = 3 if self.mlp == "swiglu" else 2
            per_layer += ff_mult * d * self.d_ff
        per_layer += 2 * d                                     # norms
        n_cross = self.n_cross_layers if self.cross_attn_every else 0
        cross = n_cross * (2 * d * (nq * dh) + 2 * d * (nkv * dh))
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * per_layer                  # (approx)
        return (self.n_layers * per_layer + cross + emb + enc + d)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        ff_mult = 3 if self.mlp == "swiglu" else 2
        expert = ff_mult * self.d_model * self.d_ff
        return (self.param_count()
                - self.n_layers * (self.n_experts - self.top_k) * expert)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Layout metadata for one parameter (per-layer shape, pre-stacking):
    ``tp_axis`` is the dim sharded over ``model``, ``fsdp_axis`` the dim
    sharded over ``data`` at rest, ``stacked`` marks (L, ...) params."""
    tp_axis: Optional[int] = None
    fsdp_axis: Optional[int] = None
    stacked: bool = True

    def pspec(self, *, model_axis="model", data_axis="data",
              stacked: Optional[bool] = None, ndim: Optional[int] = None):
        """The :class:`~repro_torch.distributed.spmd_map.PartitionSpec`
        ``spmd_map`` cuts this param by (the reference's
        ``ParamSpec.pspec``, read the same way)."""
        from ..distributed.spmd_map import PartitionSpec as P
        st = self.stacked if stacked is None else stacked
        off = 1 if st else 0
        set_axes = [a for a in (self.tp_axis, self.fsdp_axis)
                    if a is not None]
        if not set_axes:
            return P()                       # fully replicated, any rank
        n = ndim if ndim is not None else 1 + max(set_axes)
        dims: list = [None] * (n + off)
        if self.tp_axis is not None:
            dims[self.tp_axis + off] = model_axis
        if self.fsdp_axis is not None:
            dims[self.fsdp_axis + off] = data_axis
        return P(*dims)


def truncated_normal_init(gen: torch.Generator, shape, scale: float, dtype,
                          device) -> torch.Tensor:
    stddev = scale / math.sqrt(shape[0] if len(shape) > 1 else 1.0)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


class ParamFactory:
    """Init-time helper that records a ParamSpec for every created param.
    Draws from ``gen`` on ``gen.device``, or allocates on ``device`` when
    given (``"meta"``: shapes and dtypes only, nothing drawn)."""

    def __init__(self, gen: torch.Generator, dtype, fsdp: bool = True,
                 device=None):
        self.gen = gen
        self.device = torch.device(device) if device is not None \
            else gen.device
        self.dtype = dtype
        self.fsdp = fsdp
        self.specs: Dict[str, ParamSpec] = {}

    def dense(self, name: str, shape: Tuple[int, ...], *,
              tp_axis: Optional[int], fsdp_axis: Optional[int],
              stacked: bool = True, scale: float = 1.0) -> torch.Tensor:
        if not self.fsdp:
            fsdp_axis = None
        self.specs[name] = ParamSpec(tp_axis, fsdp_axis, stacked)
        return truncated_normal_init(self.gen, shape, scale, self.dtype,
                                     self.device)

    def zeros(self, name: str, shape: Tuple[int, ...], *,
              tp_axis: Optional[int] = None,
              fsdp_axis: Optional[int] = None, stacked: bool = True,
              dtype=None) -> torch.Tensor:
        self.specs[name] = ParamSpec(tp_axis, fsdp_axis, stacked)
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, name: str, shape: Tuple[int, ...], *,
             tp_axis: Optional[int] = None,
             fsdp_axis: Optional[int] = None, stacked: bool = True,
             dtype=None) -> torch.Tensor:
        self.specs[name] = ParamSpec(tp_axis, fsdp_axis, stacked)
        return torch.ones(shape, dtype=dtype or self.dtype,
                          device=self.device)
