"""Kimi-Linear decoder (``model_type`` ``kimi_linear``, e.g.
Kimi-Linear-48B-A3B) as a sentence encoder: the decoder, its final
RMSNorm, then masked mean pooling and L2 normalization. There is no LM
head.

The layers follow the published model ("Kimi Linear: An Expressive,
Efficient Attention Architecture", arXiv:2510.26692, and the checkpoint's
``config.json``): the token mixer of layer i (1-based, as
``linear_attn_config`` lists them) is Kimi Delta Attention where i is in
``kda_layers`` and latent attention without RoPE where it is in
``full_attn_layers``; the MLP is a dense SwiGLU in the first
``first_k_dense_replace`` layers and a mixture of experts after them.

- Kimi Delta Attention (``KimiDeltaAttention``), per head of
  ``head_dim`` (d_k = d_v): q, k, v = SiLU(conv(W x)), each conv a causal
  depthwise convolution of ``short_conv_kernel_size`` with no bias;
  beta = sigmoid(W_b x) a head; the per-channel log-decay
  g = -exp(A_log[h]) softplus(W_fb W_fa x + dt_bias); the gated delta rule
  of ``ops/kda.py`` (q and k L2-normalised there); then
  out = W_o [RMSNorm(o_h) * sigmoid(W_gb W_ga x + b_g)_h]_h, the norm over
  each head's d_v with one weight shared by the heads. The six projections
  that read the layer's input run as one product over their weights side
  by side (one bf16 copy of the input, one gradient of it).
- Latent attention, the router (``noaux_tc`` over sigmoid scores, the
  chosen scores renormalised, ``moe_renormalize``), the expert layer
  (``ExpertShare``: one expert-parallel rank's share, ``experts_held``),
  the shared experts, SwiGLU and the RMSNorms are ``models/deepseek_v3.py``'s,
  given the DeepSeek-V3 arch of the same widths (``KimiLinearArch.deepseek``).
  ``mla_use_nope``: the attention core takes the tables of no rotation
  (``nope_tables``), with the published softmax scale
  (qk_nope + qk_rope)^-1/2.

Precision as ``models/deepseek_v3.py``: fp32 master weights, every
projection, convolution and expert product in ``compute_dtype`` (bf16);
the residual stream, every norm, the decay, beta, the gate, the delta
rule and the router in fp32.

Spans (utils/metrics.py), nested under whatever span the caller holds:
``kda`` (each delta-rule layer's input norm, with the previous layer's MLP
output added in it, and its token mixer), inside it ``kda.core`` (from the
convolutions' q, k, v and the decay and beta to o before ``o_norm``),
``mla`` for the latent-attention layers and the expert layers' ``moe.*``.
Counters: ``kda.core_calls`` (the core's forward calls) and
``kda.kernel_calls`` (those that launched its kernel, on a card) beside
``models/deepseek_v3.py``'s.

Weights are one ``.npz`` in the checkpoint's parameter names, with its
``config.json`` beside it (``experts_held`` added for a share).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kda import kda
from ..utils.metrics import metrics
from . import deepseek_v3 as dv
from .bert import mean_pool_normalize

MODEL_TYPE = "kimi_linear"

# config.json keys of the architecture, as the published file names them
_CONFIG_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
    "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
    "qk_rope_head_dim", "v_head_dim", "num_experts", "num_experts_per_token",
    "num_shared_experts", "routed_scaling_factor", "moe_renormalize", "first_k_dense_replace",
    "moe_layer_freq", "rms_norm_eps",
)
# linear_attn_config's keys -> the arch's fields
_LINEAR_KEYS = {"kda_layers": "kda_layers", "full_attn_layers": "full_attn_layers",
                "head_dim": "kda_head_dim", "num_heads": "kda_num_heads",
                "short_conv_kernel_size": "short_conv_kernel_size"}
# the only value of each of these keys that this module implements
_IMPLEMENTED = {"model_type": MODEL_TYPE, "q_lora_rank": None, "hidden_act": "silu",
                "moe_router_activation_func": "sigmoid", "num_expert_group": 1,
                "topk_group": 1, "mla_use_nope": True, "rope_scaling": None}


@dataclass(frozen=True)
class KimiLinearArch:
    """The published widths (defaults: Kimi-Linear-48B-A3B's ``config.json``)
    and the experts this process holds. Layer lists are 1-based."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 256  # the router's width
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    rms_norm_eps: float = 1e-5
    kda_layers: Tuple[int, ...] = tuple(i for i in range(1, 28) if i % 4 and i != 27)
    full_attn_layers: Tuple[int, ...] = (4, 8, 12, 16, 20, 24, 27)
    kda_head_dim: int = 128
    kda_num_heads: int = 32
    short_conv_kernel_size: int = 4
    experts_held: Tuple[int, ...] = ()  # () holds every expert
    compute_dtype: torch.dtype = torch.bfloat16  # the weights are fp32 masters

    @property
    def held(self) -> Tuple[int, ...]:
        return self.experts_held or tuple(range(self.num_experts))

    def is_kda(self, layer: int) -> bool:
        """Whether 0-based ``layer`` is a delta-rule layer."""
        return layer + 1 in self.kda_layers

    def deepseek(self) -> dv.DeepseekV3Arch:
        """The DeepSeek-V3 arch of the parts the two share: the latent
        attention, the router, the experts, the dense MLP and the norms."""
        return dv.DeepseekV3Arch(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads, kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim, qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, n_routed_experts=self.num_experts,
            num_experts_per_tok=self.num_experts_per_token,
            n_shared_experts=self.num_shared_experts,
            routed_scaling_factor=self.routed_scaling_factor,
            norm_topk_prob=self.moe_renormalize, first_k_dense_replace=self.first_k_dense_replace,
            moe_layer_freq=self.moe_layer_freq, rms_norm_eps=self.rms_norm_eps,
            experts_held=self.experts_held, compute_dtype=self.compute_dtype)

    @classmethod
    def from_config(cls, config: Dict, **overrides) -> "KimiLinearArch":
        """The arch of an HF-style ``config.json``; what this module does not
        implement raises ``ValueError``. ``linear_attn_config``'s lists may
        run past ``num_hidden_layers`` (a cut depth takes its first layers)."""
        for key, want in _IMPLEMENTED.items():
            got = config.get(key, None if key == "model_type" else want)
            if got != want:
                raise ValueError(f"{MODEL_TYPE} config: {key}={got!r} is not implemented "
                                 f"(only {want!r})")
        kw = {k: config[k] for k in _CONFIG_KEYS if k in config}
        linear = config.get("linear_attn_config") or {}
        kw.update({field: linear[k] for k, field in _LINEAR_KEYS.items() if k in linear})
        for field in ("kda_layers", "full_attn_layers"):
            if field in kw:
                kw[field] = tuple(int(i) for i in kw[field])
        held = config.get("experts_held")
        if held is not None:
            kw["experts_held"] = tuple(int(e) for e in held)
        arch = cls(**kw, **overrides)
        for i in range(1, arch.num_hidden_layers + 1):
            if (i in arch.kda_layers) == (i in arch.full_attn_layers):
                raise ValueError(f"{MODEL_TYPE} config: layer {i} is in "
                                 f"{'both' if i in arch.kda_layers else 'neither'} of "
                                 "kda_layers and full_attn_layers")
        if any(not 0 <= e < arch.num_experts for e in arch.held) \
                or len(set(arch.held)) != len(arch.held):
            raise ValueError(f"experts_held {arch.held} outside the router's "
                             f"{arch.num_experts} experts, or repeated")
        return arch

    def to_config(self) -> Dict:
        """The ``config.json`` that ``from_config`` reads back."""
        out = dict(_IMPLEMENTED)
        out.update({k: getattr(self, k) for k in _CONFIG_KEYS})
        out["linear_attn_config"] = {k: (list(getattr(self, field))
                                         if isinstance(getattr(self, field), tuple)
                                         else getattr(self, field))
                                     for k, field in _LINEAR_KEYS.items()}
        out["experts_held"] = list(self.held)
        return out


class ShortConvolution(nn.Conv1d):
    """A causal depthwise convolution with no bias, then SiLU, on (B, S, C),
    in the compute dtype over fp32 weights (C, 1, kernel)."""

    def __init__(self, channels: int, arch: KimiLinearArch):
        super().__init__(channels, channels, arch.short_conv_kernel_size, groups=channels,
                         bias=False, dtype=torch.float32)
        self.compute_dtype = arch.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.pad(x.transpose(1, 2).to(dt), (self.kernel_size[0] - 1, 0))
        return F.silu(F.conv1d(x, self.weight.to(dt), groups=self.groups)).transpose(1, 2)


class GatedRMSNorm(nn.Module):
    """weight * RMSNorm(o) * sigmoid(gate) over the last dimension (a head),
    in fp32."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, dtype=torch.float32))
        self.eps = eps

    def forward(self, o: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        o = o.float()
        normed = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * normed * torch.sigmoid(gate.float())


class KimiDeltaAttention(nn.Module):
    """The delta-rule token mixer (the published module's parameter names)."""

    def __init__(self, arch: KimiLinearArch):
        super().__init__()
        a, h = arch, arch.hidden_size
        d, nh = a.kda_head_dim, a.kda_num_heads
        width = d * nh
        self.arch = arch
        self.q_proj = dv.Linear(h, width, a)
        self.k_proj = dv.Linear(h, width, a)
        self.v_proj = dv.Linear(h, width, a)
        self.q_conv1d = ShortConvolution(width, a)
        self.k_conv1d = ShortConvolution(width, a)
        self.v_conv1d = ShortConvolution(width, a)
        self.f_a_proj = dv.Linear(h, d, a)
        self.f_b_proj = dv.Linear(d, width, a)
        self.dt_bias = nn.Parameter(torch.zeros(width, dtype=torch.float32))
        self.A_log = nn.Parameter(torch.zeros(nh, dtype=torch.float32))
        self.b_proj = dv.Linear(h, nh, a)
        self.g_a_proj = dv.Linear(h, d, a)
        self.g_b_proj = dv.Linear(d, width, a, bias=True)
        self.o_norm = GatedRMSNorm(d, a.rms_norm_eps)
        self.o_proj = dv.Linear(width, h, a)
        self.inputs = (a.compute_dtype,)  # the six input projections' one copy

    def forward(self, x: torch.Tensor, cos=None, sin=None) -> torch.Tensor:
        """``x`` (B, S, H) in the compute dtype -> (B, S, H). The tables are
        the latent attention's: the delta rule takes no positions. The
        rule's inputs (convolutions, decay, beta) and its gated output norm
        run under non-reentrant checkpoints: the backward recomputes them
        from the projections' output, which is kept, rather than keep their
        fp32 intermediates. The rule itself keeps its inputs (and, on a card,
        its states at the chunk boundaries; ops/kda.py)."""
        dt = self.arch.compute_dtype
        projs = (self.q_proj, self.k_proj, self.v_proj, self.f_a_proj, self.b_proj,
                 self.g_a_proj)
        weight = torch.cat([p.weight.to(dt) for p in projs])
        q, k, v, f, b, g = F.linear(x.to(dt), weight).split([p.out_features for p in projs], -1)
        q, k, v, decay, beta = checkpoint(self.rule_inputs, q, k, v, f, b, use_reentrant=False)
        with metrics.span("kda.core"):
            o = kda(q, k, v, decay, beta)
        return self.o_proj(checkpoint(self.gated_norm, o, g, use_reentrant=False))

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.unflatten(-1, (self.arch.kda_num_heads, self.arch.kda_head_dim))

    def rule_inputs(self, q, k, v, f, b):
        """The projections' q, k, v and the decay's and beta's -> q, k, v
        (B, S, heads, d) after the convolutions, the log-decay
        -exp(A_log) softplus(f_b(f) + dt_bias) and beta = sigmoid(b), fp32."""
        heads = self.heads
        decay = -torch.exp(self.A_log)[:, None] * F.softplus(
            heads(self.f_b_proj(f).float() + self.dt_bias))
        return (heads(self.q_conv1d(q)), heads(self.k_conv1d(k)), heads(self.v_conv1d(v)),
                decay, torch.sigmoid(b.float()))

    def gated_norm(self, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """o (B, S, heads, d) fp32 and g_a's output -> o_proj's input."""
        return self.o_norm(o, self.heads(self.g_b_proj(g))).flatten(-2)


class KimiLinearModel(dv.DeepseekV3Model):
    """Token ids -> the final RMSNorm's output, (B, S, H) fp32."""

    def __init__(self, arch: KimiLinearArch):
        shared = arch.deepseek()
        super().__init__(shared, [
            dv.DecoderLayer(shared, i, KimiDeltaAttention(arch), span="kda") if arch.is_kda(i)
            else dv.DecoderLayer(shared, i) for i in range(arch.num_hidden_layers)])

    def tables(self, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return dv.nope_tables(seq, self.arch.qk_rope_head_dim, device)


class SentenceKimiLinear(nn.Module):
    """The decoder + masked mean pooling + L2 normalize; the call of
    ``models/bert.py SentenceBert`` (token types are ignored)."""

    def __init__(self, arch: KimiLinearArch):
        super().__init__()
        self.arch = arch
        self.model = KimiLinearModel(arch)

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        return mean_pool_normalize(self.model(input_ids), attention_mask)


# ------------------------------------------------------------------ weights


def weight_names(arch: KimiLinearArch) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of a checkpoint of ``arch``: the
    parameters and the correction biases, held experts only."""
    with torch.device("meta"):
        model = SentenceKimiLinear(arch)
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def init_params(arch: KimiLinearArch, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded weights in the checkpoint's names: projections and
    convolutions std 1/sqrt(fan_in), the embedding std 1/sqrt(hidden), norms
    1, biases 0; each delta-rule layer's A_log = log U(1, 16) a head and
    dt_bias the inverse softplus of exp U(log 1e-3, log 0.1) (the
    flash-linear-attention library's init)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in weight_names(arch).items():
        if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("bias") and not name.endswith("dt_bias"):
            out[name] = np.zeros(shape, np.float32)  # g_b_proj's, the correction biases
        elif name.endswith("A_log"):
            out[name] = np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
        elif name.endswith("dt_bias"):
            out[name] = inverse_softplus(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape)))
        else:
            std = 1.0 / math.sqrt(int(np.prod(shape[1:])))  # (out, in), (C, 1, kernel)
            out[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return out


def inverse_softplus(dt: np.ndarray) -> np.ndarray:
    """x with softplus(x) = dt: dt + log(-expm1(-dt))."""
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def load_weights(path: str, arch: KimiLinearArch) -> Dict[str, np.ndarray]:
    """The tensors ``arch`` holds, read from a checkpoint ``.npz``."""
    return dv.load_weights(path, arch, weight_names(arch))


save_weights = dv.save_weights  # the .npz and the arch's config.json beside it


def kda_core_calls() -> int:
    """Forward calls of the delta-rule core so far (ops/kda.py)."""
    return int(metrics.counters("kda.").get("kda.core_calls", 0))


def kda_kernel_calls() -> int:
    """Forward calls of the delta-rule core that launched its kernel (on a
    card) so far."""
    return int(metrics.counters("kda.").get("kda.kernel_calls", 0))
