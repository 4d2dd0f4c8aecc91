"""Xing4.0 decoder (``model_type`` ``xing4_0``, e.g. Xing4.0-29B-A4B) as a
sentence encoder: the decoder, its final RMSNorm, then masked mean pooling
and L2 normalization. There is no LM head, and so no multi-token
prediction module (``num_nextn_predict_layers`` is not built).

The block is ``models/deepseek_v3.py``'s (latent attention with q-LoRA and
YaRN tables, the dense SwiGLU, the ``noaux_tc`` router, the expert layer
of one expert-parallel rank's share, the shared expert, RMSNorm), given
the arch of this module, a subclass of ``DeepseekV3Arch``. Its residual
path is changed: manifold-constrained hyper-connections ("mHC:
Manifold-Constrained Hyper-Connections", arXiv:2512.24880, on
"Hyper-Connections", arXiv:2409.19606). Each token carries n =
``hc_mult`` residual streams X (n, C) in fp32; each sublayer F (the
attention, the MLP) has its own phi (n^2 + 2n, nC), b and alpha (3):

    x' = vec(X) rsqrt(mean(vec(X)^2) + rms_norm_eps)     m = phi x'
    H_pre  = sigmoid(alpha_0 m[0:n] + b[0:n])
    H_post = 2 sigmoid(alpha_1 m[n:2n] + b[n:2n])
    H_res  = Sinkhorn(exp(clamp(alpha_2 mat(m[2n:]) + b[2n:], clamp_min, clamp_max)))
    h = H_pre X;   y = F(RMSNorm(h));   X <- H_res X + H_post^T y

Sinkhorn is ``hc_sinkhorn_iters`` steps, each dividing the rows by their
sums and then the columns by theirs, every sum plus ``hc_eps``. The stream
starts as the token embedding repeated n times; after the last layer the
streams are summed and pass the final RMSNorm.

Precision: fp32 master weights; every projection and expert product in
``compute_dtype`` (bf16); the streams, their norm, phi's product (fp32
inputs and sums: m's logits reach the clamp at +-30, where a bf16 m would
be off by up to 0.06 before the exponential), m, the H maps, the Sinkhorn
loop and the stream products in fp32.

Recomputation: every layer but the last ``KEPT_LAYERS`` runs whole under
one non-reentrant ``torch.utils.checkpoint``, which keeps only the layer's
input stream; the backward runs the layer again. The recomputation runs inside
``metrics.quiet()`` (it opens no span and adds to no counter) and replays
the forward's host reads (``deepseek_v3.HostReads``): the expert layer's
counts are read from the device once a layer a forward, as in
``models/deepseek_v3.py``.

Spans (utils/metrics.py), nested under whatever span the caller holds:
``mhc`` (each sublayer's ``pre`` and ``post``, and the final sum of the
streams), inside it ``mhc.sinkhorn`` (the exponential and the loop);
``mla`` (each layer's input norm and attention), and the expert layers'
``moe.*``. Counters: ``mhc.calls`` (forward ``pre`` calls) beside
``models/deepseek_v3.py``'s.

Weights are one ``.npz`` in the published names of the DeepSeek-V3 block
and ``model.layers.{i}.hc_attn.fn`` / ``.base`` / ``.scale`` (and
``hc_mlp``) for phi, b and alpha, with the checkpoint's ``config.json``
beside it (``experts_held`` added for a share).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.metrics import metrics
from . import deepseek_v3 as dv
from .bert import mean_pool_normalize

MODEL_TYPE = "xing4_0"

_HC_KEYS = ("hc_mult", "hc_sinkhorn_iters", "hc_eps", "mhc_h_res_clamp_min",
            "mhc_h_res_clamp_max")
# the last layers that keep their activations for the backward, the others
# recomputed in it. Xing4.0-29B-A4B's six-layer cell at batch 256 (48 + 96 +
# 48 tokens) on an 80-GB H100: all six recomputed peak at 54 GB; the last
# kept, 59-61 GB and 4% more samples a second; two kept, 72 GB (PERF.md
# section 4)
KEPT_LAYERS = 1


@contextlib.contextmanager
def _quiet_replay(reads: dv.HostReads):
    with metrics.quiet(), reads.replay():
        yield


def _recompute_contexts():
    """A checkpoint's contexts: its forward recording its host reads, its
    recomputation quiet and replaying them."""
    reads = dv.HostReads()
    return reads.record(), _quiet_replay(reads)


def _recomputed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_recompute_contexts)


@dataclass(frozen=True)
class Xing4Arch(dv.DeepseekV3Arch):
    """The published widths (defaults: Xing4.0-29B-A4B's ``config.json``),
    the hyper-connections' settings and the experts this process holds."""

    vocab_size: int = 131072
    hidden_size: int = 3584
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    n_routed_experts: int = 64
    num_experts_per_tok: int = 4
    n_shared_experts: int = 1
    routed_scaling_factor: float = 2.0
    first_k_dense_replace: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 262144
    q_lora_rank: Optional[int] = 768
    rope_scaling: Optional[dv.YaRN] = dv.YaRN(factor=64, original_max_position_embeddings=4096,
                                              beta_fast=32, beta_slow=1, mscale=1,
                                              mscale_all_dim=1)
    hc_mult: int = 4
    hc_sinkhorn_iters: int = 20
    hc_eps: float = 1e-6
    mhc_h_res_clamp_min: float = -30.0
    mhc_h_res_clamp_max: float = 30.0

    config_keys: ClassVar[Tuple[str, ...]] = dv.DeepseekV3Arch.config_keys + _HC_KEYS
    implemented: ClassVar[Dict] = dict(dv.DeepseekV3Arch.implemented, model_type=MODEL_TYPE)

    @property
    def mixes(self) -> int:
        """m's width: n^2 + 2n."""
        return self.hc_mult * (self.hc_mult + 2)

    @classmethod
    def from_config(cls, config: Dict, **overrides) -> "Xing4Arch":
        arch = super().from_config(config, **overrides)
        if arch.hc_mult < 1 or arch.hc_sinkhorn_iters < 1 or arch.hc_eps < 0 \
                or not arch.mhc_h_res_clamp_min < arch.mhc_h_res_clamp_max:
            raise ValueError(f"{MODEL_TYPE} config: hc_mult {arch.hc_mult}, hc_sinkhorn_iters "
                             f"{arch.hc_sinkhorn_iters}, hc_eps {arch.hc_eps}, clamp "
                             f"[{arch.mhc_h_res_clamp_min}, {arch.mhc_h_res_clamp_max}] "
                             "are not implemented")
        return arch


def sinkhorn(logits: torch.Tensor, iters: int, eps: float) -> torch.Tensor:
    """exp(logits) (..., n, n), then ``iters`` steps each dividing the rows
    by their sums and then the columns by theirs, every sum plus ``eps``."""
    m = torch.exp(logits)
    for _ in range(iters):
        m = m / (m.sum(-1, keepdim=True) + eps)
        m = m / (m.sum(-2, keepdim=True) + eps)
    return m


class HyperConnection(nn.Module):
    """One sublayer's mixing: phi (``fn``, (n^2 + 2n, nC) as a projection's
    weight), b (``base``) and alpha (``scale``: pre, post, res)."""

    def __init__(self, arch: Xing4Arch):
        super().__init__()
        self.arch = arch
        n, c = arch.hc_mult, arch.hidden_size
        self.fn = nn.Parameter(torch.empty(arch.mixes, n * c, dtype=torch.float32))
        nn.init.normal_(self.fn, std=1.0 / math.sqrt(n * c))
        self.base = nn.Parameter(torch.zeros(arch.mixes, dtype=torch.float32))
        self.scale = nn.Parameter(torch.ones(3, dtype=torch.float32))

    def maps(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """X (..., n, C) fp32 -> H_pre (..., n), H_post (..., n), H_res (..., n, n)."""
        a, n = self.arch, self.arch.hc_mult
        flat = x.flatten(-2)
        rstd = torch.rsqrt(torch.linalg.vector_norm(flat, dim=-1, keepdim=True).square()
                           / flat.shape[-1] + a.rms_norm_eps)
        m = F.linear(flat, self.fn) * rstd
        alpha, b = self.scale, self.base
        pre = torch.sigmoid(alpha[0] * m[..., :n] + b[:n])
        post = 2.0 * torch.sigmoid(alpha[1] * m[..., n:2 * n] + b[n:2 * n])
        res = (alpha[2] * m[..., 2 * n:] + b[2 * n:]).clamp(
            a.mhc_h_res_clamp_min, a.mhc_h_res_clamp_max).unflatten(-1, (n, n))
        with metrics.span("mhc.sinkhorn"):
            res = sinkhorn(res, a.hc_sinkhorn_iters, a.hc_eps)
        return pre, post, res

    def pre(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """X (..., n, C) fp32 -> h = H_pre X (..., C) fp32 and what ``post``
        takes (H_post, H_res)."""
        metrics.count("mhc.calls", 1)
        pre, post, res = self.maps(x)
        return torch.matmul(pre.unsqueeze(-2), x).squeeze(-2), (post, res)

    @staticmethod
    def post(x: torch.Tensor, y: torch.Tensor,
             maps: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """H_res X + H_post^T y: X (..., n, C) fp32, the sublayer's output y
        (..., C) in any dtype -> the new stream, fp32."""
        post, res = maps
        n, c = x.shape[-2:]
        outer = post.unsqueeze(-1) * y.unsqueeze(-2)  # fp32
        return torch.baddbmm(outer.reshape(-1, n, c), res.reshape(-1, n, n),
                             x.reshape(-1, n, c)).view(x.shape)


class Xing4DecoderLayer(nn.Module):
    """``hc_attn`` -> ``input_layernorm`` -> ``self_attn`` (latent attention),
    then ``hc_mlp`` -> ``post_attention_layernorm`` -> ``mlp`` (SwiGLU in the
    dense layers, the expert layer after them). The norms take h with no
    branch: the stream update is ``post``."""

    def __init__(self, arch: Xing4Arch, layer: int, recompute: bool = True):
        super().__init__()
        h, eps = arch.hidden_size, arch.rms_norm_eps
        self.recompute = recompute
        self.hc_attn = HyperConnection(arch)
        self.self_attn = dv.LatentAttention(arch)
        self.hc_mlp = HyperConnection(arch)
        self.mlp = (dv.ExpertShare(arch, layer) if arch.is_moe(layer)
                    else dv.SwiGLU(arch, arch.intermediate_size))
        self.input_layernorm = dv.RMSNorm(h, eps)
        self.post_attention_layernorm = dv.RMSNorm(h, eps)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """The stream X (B, S, n, C) fp32 -> the stream after the layer,
        recomputed in the backward where ``recompute``."""
        if self.recompute:
            return _recomputed(self.layer, x, cos, sin)
        return self.layer(x, cos, sin)

    def layer(self, x, cos, sin):
        with metrics.span("mhc"):
            h, maps = self.hc_attn.pre(x)
        with metrics.span("mla"):
            _, h = self.input_layernorm(h, None, self.self_attn.inputs)
            y = self.self_attn(*h, cos, sin)
        with metrics.span("mhc"):
            x = self.hc_attn.post(x, y, maps)
        with metrics.span("mhc"):
            h, maps = self.hc_mlp.pre(x)
        return self.feed_forward(x, h, maps)

    def feed_forward(self, x, h, maps):
        """The MLP sublayer from its mixing's h and maps."""
        _, h = self.post_attention_layernorm(h, None, self.mlp.inputs)
        y = self.mlp(*h)
        with metrics.span("mhc"):
            return self.hc_mlp.post(x, y, maps)


class Xing4Model(nn.Module):
    """Token ids -> the final RMSNorm's output, (B, S, H) fp32."""

    def __init__(self, arch: Xing4Arch):
        super().__init__()
        self.arch = arch
        self.embed_tokens = nn.Embedding(arch.vocab_size, arch.hidden_size, dtype=torch.float32)
        n = arch.num_hidden_layers
        self.layers = nn.ModuleList(Xing4DecoderLayer(arch, i, recompute=i < n - KEPT_LAYERS)
                                    for i in range(n))
        self.norm = dv.RMSNorm(arch.hidden_size, arch.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        a = self.arch
        cos, sin = dv.rope_tables(input_ids.shape[1], a.qk_rope_head_dim, a.rope_theta,
                                  input_ids.device, a.rope_scaling)
        e = self.embed_tokens(input_ids)
        x = e.unsqueeze(-2).expand(*e.shape[:-1], a.hc_mult, a.hidden_size)
        for layer in self.layers:
            x = layer(x, cos, sin)
        with metrics.span("mhc"):
            x = x.sum(-2)
        return self.norm(x)[1][0]


class SentenceXing4(nn.Module):
    """The decoder + masked mean pooling + L2 normalize; the call of
    ``models/bert.py SentenceBert`` (token types are ignored)."""

    def __init__(self, arch: Xing4Arch):
        super().__init__()
        self.arch = arch
        self.model = Xing4Model(arch)

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        return mean_pool_normalize(self.model(input_ids), attention_mask)


# ------------------------------------------------------------------ weights


def weight_names(arch: Xing4Arch) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of a checkpoint of ``arch``: the
    parameters and the correction biases, held experts only."""
    with torch.device("meta"):
        model = SentenceXing4(arch)
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def init_params(arch: Xing4Arch, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded weights in the checkpoint's names: ``models/deepseek_v3.py``'s
    (projections and phi std 1/sqrt(fan_in), the embedding std
    1/sqrt(hidden), norms 1, correction biases 0), and for each mixing b
    normal (std 1) and alpha 1 + 0.2 normal: H_pre, H_post and H_res differ
    between streams, between sublayers and between tokens."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in weight_names(arch).items():
        if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("e_score_correction_bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith(".base"):
            out[name] = rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith(".scale"):
            out[name] = (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        else:
            std = 1.0 / math.sqrt(shape[1])  # (out, in); the embedding's (vocab, hidden)
            out[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return out


def load_weights(path: str, arch: Xing4Arch) -> Dict[str, np.ndarray]:
    """The tensors ``arch`` holds, read from a checkpoint ``.npz``."""
    return dv.load_weights(path, arch, weight_names(arch))


save_weights = dv.save_weights  # the .npz and the arch's config.json beside it


def mhc_calls() -> int:
    """Forward calls of the hyper-connections' ``pre`` so far."""
    return int(metrics.counters("mhc.").get("mhc.calls", 0))
