"""Plain fp32 reference of a DeepSeek-V3-family decoder as a sentence
encoder, for the port's tests (tests/test_torch_deepseek_v3.py,
tests/test_torch_cuda_deepseek_v3.py). Written from the published
description (the DeepSeek-V3 report and the checkpoints' ``config.json``
and ``modeling_deepseek.py``), in plain ``torch`` and fp32; it imports
nothing of the port and no JAX. Call ``no_tf32()`` before using it on a
card, so that every product is IEEE fp32.

Weights ``w`` are a checkpoint's tensors in the published names (linear
weights (out, in)), the correction biases among them; ``cfg`` is the
checkpoint's ``config.json`` as a dict (``experts_held``: the experts
this share holds; all where absent).

Departures from the published model, each deliberate:

- No LM head: the final RMSNorm's output is mean-pooled over the valid
  positions and L2-normalised (the sentence encoder).
- RoPE rotates pairs (x[2i], x[2i+1]) written as complex numbers, and lays
  the result out as [real parts, imaginary parts]: the layout the
  modelling code's de-interleave and ``rotate_half`` give.
- The mask is causal only: with padding on the right, no valid position
  attends to a pad, and pad positions are left out of the pooling.
- An expert-parallel share: the routed sum runs over the held experts
  only; what the others would add is left out (the share before the
  exchange). The shared experts run on every token.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x, theta):
    """(..., S, d) -> each pair (x[2i], x[2i+1]) at position p rotated by
    p * theta^(-2i/d), as [real parts, imaginary parts]."""
    s, d = x.shape[-2], x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    angle = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freq[None, :]
    turn = torch.polar(torch.ones_like(angle), angle).to(torch.complex64)
    z = torch.complex(x[..., 0::2], x[..., 1::2]) * turn
    return torch.cat([z.real, z.imag], dim=-1)


def swiglu(w, p, x):
    gate = x @ w[p + "gate_proj.weight"].T
    up = x @ w[p + "up_proj.weight"].T
    return (F.silu(gate) * up) @ w[p + "down_proj.weight"].T


def attention(w, p, x, cfg):
    b, s, _ = x.shape
    nh, nope, rdim, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = (x @ w[p + "q_proj.weight"].T).view(b, s, nh, nope + rdim).transpose(1, 2)
    kv_a = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    latent = rms_norm(kv_a[..., :rank], w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = kv_a[..., rank:][:, None]  # (B, 1, S, rope): one for every head
    kv = (latent @ w[p + "kv_b_proj.weight"].T).view(b, s, nh, nope + vd).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
    k = torch.cat([kv[..., :nope],
                   rope(k_pe, cfg["rope_theta"]).expand(b, nh, s, rdim)], dim=-1)
    scores = q @ k.transpose(-1, -2) / math.sqrt(nope + rdim)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = (probs @ kv[..., nope:]).transpose(1, 2).reshape(b, s, nh * vd)
    return ctx @ w[p + "o_proj.weight"].T


def route(w, p, x, cfg):
    """(T, H) -> (chosen experts (T, k), their weights (T, k))."""
    scores = torch.sigmoid(x @ w[p + "gate.weight"].T)
    bias = w[p + "gate.e_score_correction_bias"].detach()
    idx = torch.topk(scores.detach() + bias, cfg["num_experts_per_tok"], dim=-1).indices
    weight = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return idx, weight * cfg["routed_scaling_factor"]


def experts_part(w, p, x, cfg, held: Iterable[int]):
    """The held experts' part of the routed sum, (T, H)."""
    idx, weight = route(w, p, x, cfg)
    out = torch.zeros_like(x)
    for e in held:
        hit = idx == e
        rows = hit.any(-1).nonzero().squeeze(1)
        we = (weight * hit).sum(-1)[rows]
        out = out.index_add(0, rows, we[:, None] * swiglu(w, f"{p}experts.{e}.", x[rows]))
    return out


def moe(w, p, x, cfg, held: Optional[Iterable[int]] = None):
    """A mixture-of-experts layer on (T, H): the held experts' part (every
    expert where ``held`` is None) plus the shared experts."""
    held = range(cfg["n_routed_experts"]) if held is None else held
    return experts_part(w, p, x, cfg, held) + swiglu(w, p + "shared_experts.", x)


def is_moe(cfg, layer: int) -> bool:
    return layer >= cfg["first_k_dense_replace"] and layer % cfg["moe_layer_freq"] == 0


def hidden(w: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, S) ids -> the final RMSNorm's output (B, S, H)."""
    eps = cfg["rms_norm_eps"]
    held = cfg.get("experts_held")
    x = w["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        x = x + attention(w, p + "self_attn.", rms_norm(x, w[p + "input_layernorm.weight"], eps),
                          cfg)
        h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        if is_moe(cfg, i):
            x = x + moe(w, p + "mlp.", h.reshape(-1, h.shape[-1]), cfg, held).view(h.shape)
        else:
            x = x + swiglu(w, p + "mlp.", h)
    return rms_norm(x, w["model.norm.weight"], eps)


def encode(w: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor,
           cfg: Dict) -> torch.Tensor:
    """(B, S) ids and mask -> (B, H) unit sentence embeddings."""
    m = mask.to(torch.float32)[:, :, None]
    mean = (hidden(w, ids, cfg) * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp(min=1e-12)
