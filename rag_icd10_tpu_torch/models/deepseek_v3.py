"""DeepSeek-V3-family decoder (``model_type`` ``deepseek_v3``, e.g.
Moonlight-16B-A3B) as a sentence encoder: the decoder, its final RMSNorm,
then masked mean pooling and L2 normalization. There is no LM head.

The block follows the published modelling code (``modeling_deepseek.py``
of the DeepSeek-V3 checkpoints):

- Multi-head latent attention without q-LoRA: ``q_proj`` to heads of
  ``qk_nope_head_dim + qk_rope_head_dim``; ``kv_a_proj_with_mqa`` to the
  ``kv_lora_rank`` latent and one ``k_pe`` shared by every head;
  ``kv_a_layernorm`` (RMSNorm) on the latent; ``kv_b_proj`` to each head's
  k_nope and v; ``o_proj``. RoPE on the rope dimensions, pairs interleaved
  as the modelling code de-interleaves them; softmax scale
  ``(qk_nope + qk_rope) ** -0.5`` (no ``rope_scaling``). The mask is
  causal; padding is on the right, so no valid position sees a pad. The
  core between the projections (RoPE, logits, softmax, P.V) is
  ``ops/mla_attention.py``: a hand-written kernel on the card, its plain
  version on the CPU.
- SwiGLU (``silu``) feed-forward: dense in the first
  ``first_k_dense_replace`` layers, mixture of experts after them.
- The router (``noaux_tc``): sigmoid scores over all ``n_routed_experts``
  from fp32 inputs and weights; ``e_score_correction_bias`` (a buffer, no
  gradient) is added only to choose the top ``num_experts_per_tok``; the
  chosen scores are normalised to sum to 1 (``norm_topk_prob``) and scaled
  by ``routed_scaling_factor``. Only ``n_group = topk_group = 1`` is
  implemented (group-limited selection is then the plain top-k).
- The expert layer holds the experts ``experts_held`` (one expert-parallel
  rank's share; all by default). It routes every token over all experts
  and computes only what its own experts give, for the token slots routed
  to them: there is no capacity limit and no token is dropped. What the
  absent experts would add is left out here, as the rank's partial sum
  before the expert-parallel exchange. The shared experts run on every
  token.

Precision, as ``BertArch(param_dtype=float32)`` trains: fp32 master
weights, every projection and expert product in ``compute_dtype`` (bf16);
the residual stream, RMSNorm, RoPE, attention logits and softmax, the
router and the pooling in fp32.

Spans (utils/metrics.py), nested under whatever span the caller holds:
``mla`` (each layer's attention), ``moe.route`` (router, top-k, weights,
dispatch order), ``moe.experts`` (gather, the held experts' products,
combine), ``moe.shared``. Counters, added on the device with no host read:
``moe.held_slots.<layer>`` (token slots routed to each held expert) and
``moe.routed_slots.<layer>`` (slots routed anywhere: tokens x top-k).

Weights are one ``.npz`` in the published checkpoint's parameter names
(``model.layers.{i}.mlp.experts.{j}.gate_proj.weight``, ...), with the
checkpoint's ``config.json`` beside it (``experts_held`` added for a share).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mla_attention import mla_attention
from ..utils.metrics import metrics
from .bert import mean_pool_normalize

MODEL_TYPE = "deepseek_v3"

# config.json keys of the architecture, as the published files name them
_CONFIG_KEYS = (
    "vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
    "num_hidden_layers", "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
    "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "num_experts_per_tok",
    "n_shared_experts", "routed_scaling_factor", "norm_topk_prob", "first_k_dense_replace",
    "moe_layer_freq", "rms_norm_eps", "rope_theta", "max_position_embeddings",
)
# the only value of each of these keys that this module implements
_IMPLEMENTED = {"model_type": MODEL_TYPE, "q_lora_rank": None, "hidden_act": "silu",
                "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
                "topk_group": 1, "attention_bias": False, "rope_scaling": None}


@dataclass(frozen=True)
class DeepseekV3Arch:
    """The published widths (defaults: Moonlight-16B-A3B's ``config.json``)
    and the experts this process holds."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64  # the router's width
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    experts_held: Tuple[int, ...] = ()  # () holds every expert
    compute_dtype: torch.dtype = torch.bfloat16  # the weights are fp32 masters

    @property
    def held(self) -> Tuple[int, ...]:
        return self.experts_held or tuple(range(self.n_routed_experts))

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @classmethod
    def from_config(cls, config: Dict, **overrides) -> "DeepseekV3Arch":
        """The arch of an HF-style ``config.json``; what this module does not
        implement raises ``ValueError``."""
        for key, want in _IMPLEMENTED.items():
            got = config.get(key, None if key == "model_type" else want)
            if got != want:
                raise ValueError(f"{MODEL_TYPE} config: {key}={got!r} is not implemented "
                                 f"(only {want!r})")
        kw = {k: config[k] for k in _CONFIG_KEYS if k in config}
        held = config.get("experts_held")
        if held is not None:
            kw["experts_held"] = tuple(int(e) for e in held)
        arch = cls(**kw, **overrides)
        if any(not 0 <= e < arch.n_routed_experts for e in arch.held) \
                or len(set(arch.held)) != len(arch.held):
            raise ValueError(f"experts_held {arch.held} outside the router's "
                             f"{arch.n_routed_experts} experts, or repeated")
        return arch

    def to_config(self) -> Dict:
        """The ``config.json`` that ``from_config`` reads back."""
        out = dict(_IMPLEMENTED)
        out.update({k: getattr(self, k) for k in _CONFIG_KEYS})
        out["experts_held"] = list(self.held)
        return out


class Linear(nn.Linear):
    """A bias-free projection with fp32 weights, computed in
    ``arch.compute_dtype`` (input and weight cast to it)."""

    def __init__(self, n_in: int, n_out: int, arch: DeepseekV3Arch):
        super().__init__(n_in, n_out, bias=False, dtype=torch.float32)
        self.compute_dtype = arch.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


class RMSNorm(nn.Module):
    """fp32 in, fp32 out, fp32 weight."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, dtype=torch.float32))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


def rope_tables(seq: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (seq, dim) in fp32: frequencies theta^(-2i/dim),
    repeated over both halves as the modelling code lays them out."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


class LatentAttention(nn.Module):
    """MLA without q-LoRA (the published module's parameter names)."""

    def __init__(self, arch: DeepseekV3Arch):
        super().__init__()
        a, h = arch, arch.hidden_size
        self.arch = arch
        self.q_proj = Linear(h, a.num_attention_heads * a.qk_head_dim, a)
        self.kv_a_proj_with_mqa = Linear(h, a.kv_lora_rank + a.qk_rope_head_dim, a)
        self.kv_a_layernorm = RMSNorm(a.kv_lora_rank, a.rms_norm_eps)
        self.kv_b_proj = Linear(a.kv_lora_rank,
                                a.num_attention_heads * (a.qk_nope_head_dim + a.v_head_dim), a)
        self.o_proj = Linear(a.num_attention_heads * a.v_head_dim, h, a)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        a = self.arch
        q = self.q_proj(x)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([a.kv_lora_rank, a.qk_rope_head_dim],
                                                         dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent))
        return self.o_proj(mla_attention(q, kv, k_pe, cos, sin, a.num_attention_heads))


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)) in the compute dtype."""

    def __init__(self, arch: DeepseekV3Arch, width: int):
        super().__init__()
        h = arch.hidden_size
        self.gate_proj = Linear(h, width, arch)
        self.up_proj = Linear(h, width, arch)
        self.down_proj = Linear(width, h, arch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """``noaux_tc`` top-k over sigmoid scores, in fp32 (the published
    ``MoEGate``)."""

    def __init__(self, arch: DeepseekV3Arch):
        super().__init__()
        self.arch = arch
        self.weight = nn.Parameter(torch.empty(arch.n_routed_experts, arch.hidden_size,
                                               dtype=torch.float32))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(arch.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(arch.n_routed_experts, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, H) -> the chosen experts (T, k) and their weights (T, k), fp32."""
        a = self.arch
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        choice = scores.detach() + self.e_score_correction_bias  # selection only
        idx = torch.topk(choice, a.num_experts_per_tok, dim=-1, sorted=False).indices
        w = scores.gather(1, idx)
        if a.num_experts_per_tok > 1 and a.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * a.routed_scaling_factor


class ExpertShare(nn.Module):
    """The mixture-of-experts layer as one expert-parallel rank holds it:
    the router over every expert, the experts ``arch.held`` (named by their
    global index), the shared experts. Returns the held experts' part of
    the routed sum plus the shared experts, (B, S, H) fp32."""

    def __init__(self, arch: DeepseekV3Arch, layer: int):
        super().__init__()
        self.arch, self.layer = arch, layer
        self.gate = Router(arch)
        self.experts = nn.ModuleDict({str(e): SwiGLU(arch, arch.moe_intermediate_size)
                                      for e in arch.held})
        self.shared_experts = SwiGLU(arch, arch.moe_intermediate_size * arch.n_shared_experts)
        # global expert -> its index among the held ones; len(held) where not held
        local = torch.full((arch.n_routed_experts,), len(arch.held), dtype=torch.long)
        local[list(arch.held)] = torch.arange(len(arch.held))
        self.register_buffer("local_index", local, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, n_held, k = self.arch, len(self.arch.held), self.arch.num_experts_per_tok
        shape = x.shape
        t = x.reshape(-1, shape[-1])
        with metrics.span("moe.route"):
            idx, w = self.gate(t)
            local = self.local_index[idx.reshape(-1)]  # (T * k,) slots
            order = torch.argsort(local, stable=True)  # the held experts' slots first, by expert
            counts = torch.bincount(local, minlength=n_held + 1)[:n_held]
            metrics.count(f"moe.held_slots.{self.layer}", counts)
            metrics.count(f"moe.routed_slots.{self.layer}", idx.numel())
            sizes = counts.tolist()  # the one host read of a layer's forward
            mine = order[:sum(sizes)]
            token, weight = mine // k, w.reshape(-1)[mine]
        with metrics.span("moe.experts"):
            xs = t[token].to(a.compute_dtype).split(sizes)
            ys = torch.cat([self.experts[str(e)](part) for e, part in zip(a.held, xs)])
            routed = t.new_zeros(t.shape).index_add_(0, token, ys.float() * weight[:, None])
        with metrics.span("moe.shared"):
            out = routed + self.shared_experts(t).float()
        return out.view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, arch: DeepseekV3Arch, layer: int):
        super().__init__()
        h, eps = arch.hidden_size, arch.rms_norm_eps
        self.self_attn = LatentAttention(arch)
        self.mlp = (ExpertShare(arch, layer) if arch.is_moe(layer)
                    else SwiGLU(arch, arch.intermediate_size))
        self.input_layernorm = RMSNorm(h, eps)
        self.post_attention_layernorm = RMSNorm(h, eps)

    def forward(self, x, cos, sin) -> torch.Tensor:
        with metrics.span("mla"):
            x = x + self.self_attn(self.input_layernorm(x), cos, sin).float()
        return x + self.mlp(self.post_attention_layernorm(x)).float()


class DeepseekV3Model(nn.Module):
    """Token ids -> the final RMSNorm's output, (B, S, H) fp32."""

    def __init__(self, arch: DeepseekV3Arch):
        super().__init__()
        self.arch = arch
        self.embed_tokens = nn.Embedding(arch.vocab_size, arch.hidden_size,
                                         dtype=torch.float32)
        self.layers = nn.ModuleList(DecoderLayer(arch, i) for i in range(arch.num_hidden_layers))
        self.norm = RMSNorm(arch.hidden_size, arch.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        a, s = self.arch, input_ids.shape[1]
        dev = input_ids.device
        cos, sin = rope_tables(s, a.qk_rope_head_dim, a.rope_theta, dev)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)


class SentenceDeepseekV3(nn.Module):
    """The decoder + masked mean pooling + L2 normalize; the call of
    ``models/bert.py SentenceBert`` (token types are ignored)."""

    def __init__(self, arch: DeepseekV3Arch):
        super().__init__()
        self.arch = arch
        self.model = DeepseekV3Model(arch)

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        return mean_pool_normalize(self.model(input_ids), attention_mask)


# ------------------------------------------------------------------ weights


def weight_names(arch: DeepseekV3Arch) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of a checkpoint of ``arch``: the
    parameters and the correction biases, held experts only."""
    with torch.device("meta"):
        model = SentenceDeepseekV3(arch)
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def init_params(arch: DeepseekV3Arch, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded weights in the checkpoint's names: projections std
    1/sqrt(fan_in), the embedding std 1/sqrt(hidden), norms 1, correction
    biases 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in weight_names(arch).items():
        if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("e_score_correction_bias"):
            out[name] = np.zeros(shape, np.float32)
        else:
            std = 1.0 / math.sqrt(shape[1])  # (out, in); the embedding's (vocab, hidden)
            out[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return out


def load_weights(path: str, arch: DeepseekV3Arch) -> Dict[str, np.ndarray]:
    """The tensors ``arch`` holds, read from a checkpoint ``.npz`` in the
    published names (others, such as absent experts, are not read)."""
    shapes = weight_names(arch)
    with np.load(path) as flat:
        missing = [n for n in shapes if n not in flat.files]
        if missing:
            raise ValueError(f"{path}: {len(missing)} tensors of the model missing, "
                             f"e.g. {missing[:3]}")
        out = {n: flat[n] for n in shapes}
    for n, shape in shapes.items():
        if out[n].shape != shape:
            raise ValueError(f"{path}: {n} has shape {out[n].shape}, the arch {shape}")
    return out


def save_weights(params: Dict[str, np.ndarray], arch: DeepseekV3Arch, path: str) -> None:
    """``params`` (the model's named tensors) as ``path`` (.npz), with the
    arch's ``config.json`` beside it."""
    np.savez(path, **params)
    (Path(path).parent / "config.json").write_text(json.dumps(arch.to_config(), indent=1))


# ------------------------------------ the --log-every fields (models/family.py)


def moe_load(before: Dict[str, np.ndarray], after: Dict[str, np.ndarray]) -> Tuple[float, float]:
    """Between two ``metrics.counters("moe.")``: the percent of the routed
    token slots that went to the experts held here, and the max over the
    mean of the slots each held expert took, averaged over the layers;
    nan where no slot was routed."""
    def delta(key):
        return after[key] - before.get(key, 0)

    held = [k for k in after if k.startswith("moe.held_slots.")]
    routed = sum(float(delta("moe.routed_slots." + k.rsplit(".", 1)[1])) for k in held)
    took = [delta(k).astype(np.float64) for k in held]
    if not routed or not any(t.sum() for t in took):
        return float("nan"), float("nan")
    share = 100.0 * sum(float(t.sum()) for t in took) / routed
    return share, float(np.mean([t.max() / t.mean() for t in took if t.sum()]))


def mla_kernel_calls() -> int:
    """Forward calls of the latent-attention kernel so far (ops/mla_attention.py)."""
    return int(metrics.counters("mla.").get("mla.kernel_calls", 0))

