"""Plain fp32 reference of a Kimi-Linear decoder as a sentence encoder, for
the port's tests (tests/test_torch_kimi_linear.py,
tests/test_torch_cuda_kimi_linear.py). Written from the published
description (arXiv:2510.26692, the checkpoint's ``config.json``, and the
flash-linear-attention library's ``KimiDeltaAttention`` layer and its
``naive_recurrent_kda``), in plain ``torch`` and fp32; it imports nothing
of the port and no JAX. Call ``no_tf32()`` before using it on a card.

The delta rule is the token-by-token recurrence, the definition:

    S <- Diag(exp g_t) S;   S <- S + beta_t k_t (v_t - S^T k_t)^T;   o_t = S^T q_t

with q and k L2-normalised (x * rsqrt(sum x^2 + 1e-6)) and q scaled by
d_k^-1/2. Weights ``w`` are a checkpoint's tensors in the published names
(linear weights (out, in), the short convolutions (C, 1, kernel)); ``cfg``
is the checkpoint's ``config.json`` as a dict. The latent attention, the
router, the experts and the norms are tests/reference_deepseek_v3.py's,
given the DeepSeek-V3 names of the same settings (``deepseek_cfg``).

Departures from the published model, each deliberate: no LM head (the
sentence encoder: mean pool over the valid positions, L2 normalise); the
latent attention takes no rotation (``mla_use_nope``); a causal mask only
(padding on the right); the routed sum over the held experts alone
(``experts_held``), as one expert-parallel rank computes it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

import reference_deepseek_v3 as dsv3
from reference_deepseek_v3 import no_tf32, rms_norm, swiglu  # noqa: F401 (no_tf32: callers')


def deepseek_cfg(cfg: Dict) -> Dict:
    """``cfg`` under the DeepSeek-V3 names of the router's and experts'
    settings, for tests/reference_deepseek_v3.py's router and experts."""
    out = dict(cfg, n_routed_experts=cfg["num_experts"],
               num_experts_per_tok=cfg["num_experts_per_token"],
               n_shared_experts=cfg["num_shared_experts"], norm_topk_prob=cfg["moe_renormalize"])
    return out


def is_kda(cfg: Dict, layer: int) -> bool:
    """Whether 0-based ``layer`` is a delta-rule layer (the lists are 1-based)."""
    return layer + 1 in cfg["linear_attn_config"]["kda_layers"]


def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def delta_rule(q, k, v, g, beta):
    """q, k, g (B, S, H, d_k), v (B, S, H, d_v), beta (B, S, H) -> o (B, S,
    H, d_v): the token loop."""
    b, s, h, dk = q.shape
    q, k = l2norm(q) * dk ** -0.5, l2norm(k)
    state = q.new_zeros(b, h, dk, v.shape[-1])
    out = []
    for t in range(s):
        state = state * torch.exp(g[:, t])[..., None]
        erase = torch.einsum("bhk,bhkv->bhv", k[:, t], state)
        u = beta[:, t, :, None] * (v[:, t] - erase)
        state = state + k[:, t, :, :, None] * u[:, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return torch.stack(out, 1)


def short_conv(x, weight):
    """SiLU of the causal depthwise convolution of (B, S, C) by (C, 1, K)."""
    s, width = x.shape[1], weight.shape[-1]
    padded = F.pad(x, (0, 0, width - 1, 0))
    return F.silu(sum(padded[:, i:i + s] * weight[:, 0, i] for i in range(width)))


def kda(w, p, x, cfg):
    b, s, _ = x.shape
    lin = cfg["linear_attn_config"]
    nh, d = lin["num_heads"], lin["head_dim"]

    def proj(name, y):
        return y @ w[p + name + ".weight"].T

    def heads(t):
        return t.reshape(b, s, nh, d)

    q = heads(short_conv(proj("q_proj", x), w[p + "q_conv1d.weight"]))
    k = heads(short_conv(proj("k_proj", x), w[p + "k_conv1d.weight"]))
    v = heads(short_conv(proj("v_proj", x), w[p + "v_conv1d.weight"]))
    g = -torch.exp(w[p + "A_log"])[:, None] * F.softplus(
        heads(proj("f_b_proj", proj("f_a_proj", x)) + w[p + "dt_bias"]))
    beta = torch.sigmoid(proj("b_proj", x))
    o = delta_rule(q, k, v, g, beta)
    gate = heads(proj("g_b_proj", proj("g_a_proj", x)) + w[p + "g_b_proj.bias"])
    o = rms_norm(o, w[p + "o_norm.weight"], cfg["rms_norm_eps"]) * torch.sigmoid(gate)
    return proj("o_proj", o.reshape(b, s, nh * d))


def attention(w, p, x, cfg):
    """Latent attention without rotation: the rope dimensions as they come."""
    b, s, _ = x.shape
    nh, nope, rdim, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = (x @ w[p + "q_proj.weight"].T).view(b, s, nh, nope + rdim).transpose(1, 2)
    kv_a = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    latent = rms_norm(kv_a[..., :rank], w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_pe = kv_a[..., rank:][:, None]  # (B, 1, S, rope): one for every head
    kv = (latent @ w[p + "kv_b_proj.weight"].T).view(b, s, nh, nope + vd).transpose(1, 2)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, nh, s, rdim)], dim=-1)
    scores = q @ k.transpose(-1, -2) / math.sqrt(nope + rdim)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = (probs @ kv[..., nope:]).transpose(1, 2).reshape(b, s, nh * vd)
    return ctx @ w[p + "o_proj.weight"].T


def hidden(w: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, S) ids -> the final RMSNorm's output (B, S, H)."""
    eps, shared = cfg["rms_norm_eps"], deepseek_cfg(cfg)
    held = cfg.get("experts_held")
    x = w["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        mixer = kda if is_kda(cfg, i) else attention
        x = x + mixer(w, p + "self_attn.", rms_norm(x, w[p + "input_layernorm.weight"], eps), cfg)
        h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        if dsv3.is_moe(shared, i):
            x = x + dsv3.moe(w, p + "mlp.", h.reshape(-1, h.shape[-1]), shared,
                             held).view(h.shape)
        else:
            x = x + swiglu(w, p + "mlp.", h)
    return rms_norm(x, w["model.norm.weight"], eps)


def encode(w: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor,
           cfg: Dict) -> torch.Tensor:
    """(B, S) ids and mask -> (B, H) unit sentence embeddings."""
    m = mask.to(torch.float32)[:, :, None]
    mean = (hidden(w, ids, cfg) * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp(min=1e-12)
