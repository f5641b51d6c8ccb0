"""Shared model primitives: configs, param descriptors, norms, RoPE, activations.

Counterpart of ``repro.models.common``. Parameters are described by
``AxSpec`` descriptor trees (shape + logical axis names + init), which lets
the same tree be

  * materialized (``init_params``) — on a device, from a
    ``torch.Generator``; on the ``meta`` device it allocates nothing (the
    counterpart of the reference's ``abstract_params``).

Parameter trees are plain nested dicts and tuples of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves_with_path, tree_map

# ---------------------------------------------------------------------------
# Param descriptors
# ---------------------------------------------------------------------------


class AxSpec(NamedTuple):
    """Descriptor for a single parameter tensor.

    ``axes`` holds one *logical* axis name per dim (e.g. "d_model",
    "heads"), kept so the descriptor reads as the reference's does.
    """

    shape: tuple
    axes: tuple
    init: str = "normal"  # normal | zeros | ones | embed | small
    dtype: torch.dtype = torch.bfloat16
    scale: Optional[float] = None  # stddev override for "normal"


def is_axspec(x) -> bool:
    return isinstance(x, AxSpec)


def tree_map_spec(fn: Callable[[AxSpec], Any], tree):
    return tree_map(fn, tree, is_leaf=is_axspec)


def spec_leaves(spec_tree):
    return [s for _, s in tree_leaves_with_path(spec_tree, is_axspec)]


def param_count(spec_tree) -> int:
    return sum(int(math.prod(s.shape)) for s in spec_leaves(spec_tree))


def param_bytes(spec_tree) -> int:
    return sum(int(math.prod(s.shape)) * s.dtype.itemsize
               for s in spec_leaves(spec_tree))


def init_params(spec_tree, generator: torch.Generator, device="cuda"):
    """Materialize a descriptor tree into tensors on ``device``.

    Draws come from ``generator`` on the generator's own device, in tree
    order, and are then moved: one seed and one generator device give the
    same weights wherever they land. A CUDA generator draws on the card,
    which a full-width model needs (billions of values); a CPU generator
    gives the same weights on every device. On the ``meta`` device
    nothing is drawn or allocated.
    """
    device = torch.device(device)

    def one(s: AxSpec):
        if device.type == "meta":
            return torch.empty(s.shape, dtype=s.dtype, device=device)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
        if s.init == "embed":
            std = s.scale if s.scale is not None else 0.02
        if s.init == "small":
            std = 0.006
        x = torch.randn(s.shape, generator=generator,
                        dtype=torch.float32, device=generator.device) * std
        return x.to(device=device, dtype=s.dtype)

    return tree_map_spec(one, spec_tree)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


class LayerSpec(NamedTuple):
    mixer: str  # "attn" | "attn_local" | "ssm"
    mlp: str    # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None  # grok-style gating cap


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = (LayerSpec("attn", "dense"),)
    act: str = "silu"
    gated_mlp: bool = True           # SwiGLU-style; False -> classic 2-matrix MLP
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None     # sliding window for "attn_local" layers
    rope_theta: float = 1e4
    pos: str = "rope"                # rope | learned | none
    max_position: int = 524_288 + 8  # learned-pos table size (shape-cell driven)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    sandwich_norms: bool = False     # gemma2 pre+post block norms
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: bool = False
    n_enc_layers: int = 0
    enc_d_model: int = 0             # encoder width (whisper: same as d_model)
    input_mode: str = "tokens"       # tokens | embeddings (stubbed frontends)
    tie_embeddings: bool = False
    emb_scale: bool = False          # gemma-style sqrt(d_model) embedding scaling
    bidirectional: bool = False      # encoder-only models (paper's DistilBERT)
    num_labels: Optional[int] = None  # classifier head (sentiment case study)

    # ---- derived -----------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by pattern "
            f"period {self.period}")
        return self.n_layers // self.period

    @property
    def q_per_kv(self) -> int:
        return max(self.n_heads // max(self.n_kv_heads, 1), 1)

    def has_mixer(self, kind: str) -> bool:
        return any(s.mixer.startswith(kind) for s in self.pattern)

    @property
    def attention_free(self) -> bool:
        return not self.has_mixer("attn")

    @property
    def subquadratic(self) -> bool:
        """True if long-context (500k) decode/prefill is architecturally sane."""
        n_attn = sum(1 for s in self.pattern if s.mixer.startswith("attn"))
        return n_attn == 0 or (self.family == "hybrid")

    def param_count_analytic(self) -> int:
        """6·N·D roofline numerator helper: total parameter count."""
        from repro_torch.models import model_zoo  # local import to avoid cycle
        return param_count(model_zoo.build(self).param_specs)

    def active_param_count_analytic(self) -> int:
        from repro_torch.models import model_zoo
        return model_zoo.build(self).active_param_count


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs orthogonal to the architecture (perf-iteration levers).

    Field for field the reference's. ``attn_impl="pallas"`` selects the
    hand-written kernel (``kernels/flash_attention``); ``"xla"`` the plain
    torch path (``models.attention._attend_dense``).
    """

    attn_impl: str = "xla"        # xla | pallas | seq_shard (decode only)
    moe_impl: str = "auto"        # auto | einsum | scatter | ragged
    seq_parallel: bool = False    # Megatron-SP: residual stream sharded
                                  # along seq over "model" (train/prefill)
    remat: str = "none"           # none | dots | full
    microbatch: Optional[int] = None  # grad-accum microbatch size (train)
    scan_layers: bool = True      # scan over layer groups vs python unroll
    cache_pad: int = 128          # decode cache slack past prefill length
    grad_compression: str = "none"  # none | bf16 | int8 (cross-pod all-reduce)
    donate_cache: bool = True
    kv_dtype: str = "bf16"        # bf16 | int8 (per-token-scaled KV cache)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def act_fn(name: str) -> Callable:
    return {
        "silu": F.silu,
        "gelu": F.gelu,  # exact (erf) GELU
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def norm_spec(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": AxSpec((d,), ("d_model",), "zeros", torch.float32)}
    return {
        "scale": AxSpec((d,), ("d_model",), "ones", torch.float32),
        "bias": AxSpec((d,), ("d_model",), "zeros", torch.float32),
    }


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, dim: int, device=None):
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, ignore_id: int = -100):
    """Mean CE over non-ignored tokens; logits (..., V) fp32-accumulated."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long().clamp_min(0)[..., None]
                        ).squeeze(-1)
    nll = lse - gold
    mask = (labels != ignore_id).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
