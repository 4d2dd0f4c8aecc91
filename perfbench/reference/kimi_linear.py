"""Plain Kimi-Linear decoder (Kimi-Linear-48B-A3B) as a sentence encoder in
fp32: the decoder, its final RMSNorm, masked mean pooling and L2
normalisation; one expert-parallel rank's share of each expert layer.

Written from the published description ("Kimi Linear: An Expressive,
Efficient Attention Architecture", arXiv:2510.26692; the checkpoint's
``config.json``; the flash-linear-attention library's ``KimiDeltaAttention``
layer, whose ``naive_recurrent_kda`` defines the rule). Weights are the
benchmark's leaves in the checkpoint's names (linear weights (out, in),
the short convolutions (C, 1, kernel)); the routers' correction biases
come apart (``bias``). TF32 is switched off by the caller, so every
product is IEEE fp32; ``rnd`` rounds every projection's and product's
inputs (``reference/lowp.py``), but not the delta rule's own state.

A delta-rule layer, per head of d = ``head_dim``: q, k, v = SiLU(causal
depthwise conv of W x), q and k L2-normalised (eps 1e-6), q scaled by
d^-1/2; beta = sigmoid(W_b x); g = -exp(A_log) softplus(W_fb W_fa x +
dt_bias); the token loop

    S <- Diag(exp g_t) S;   S <- S + beta_t k_t (v_t - S^T k_t)^T;   o_t = S^T q_t

from S = 0; out = W_o [RMSNorm(o_h) * sigmoid(W_gb W_ga x + b_g)]_h. The
latent attention, the router, the experts and the norms are
``reference/deepseek_v3.py``'s, the attention without rotation
(``mla_use_nope``).

Departures from the published model, each deliberate: no LM head (the
sentence encoder); a causal mask only (padding is on the right); the
routed sum over the held experts alone (``experts_held``).

The rows run in blocks, each under ``torch.utils.checkpoint`` (not
reentrant), and the token loop in segments of ``STEPS`` tokens, each under
its own: only a block's activations and a segment's states live at once,
and the backward recomputes them. That is exact: every token's routing is
its own, and the loop computes the same operations again.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .deepseek_v3 import _mm, _moe, _rms, _swiglu

BLOCK_ROWS = 64
STEPS = 16  # tokens of the loop a checkpointed segment


def deepseek_cfg(cfg: Dict) -> Dict:
    """The router's and experts' settings under reference/deepseek_v3.py's
    names."""
    return dict(cfg, num_experts_per_tok=cfg["num_experts_per_token"],
                norm_topk_prob=cfg["moe_renormalize"])


def _l2(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def _segment(state, q, k, v, g, beta):
    out = []
    for t in range(q.shape[1]):
        state = state * torch.exp(g[:, t])[..., None]
        erase = torch.einsum("bhk,bhkv->bhv", k[:, t], state)
        u = beta[:, t, :, None] * (v[:, t] - erase)
        state = state + k[:, t, :, :, None] * u[:, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return state, torch.stack(out, 1)


def delta_rule(q, k, v, g, beta):
    """q, k, g (B, S, H, d), v (B, S, H, d_v), beta (B, S, H) -> o: the token
    loop from a zero state, in checkpointed segments."""
    b, s, h, d = q.shape
    q, k = _l2(q) * d ** -0.5, _l2(k)
    state = q.new_zeros(b, h, d, v.shape[-1])
    outs = []
    for t in range(0, s, STEPS):
        part = slice(t, t + STEPS)
        state, o = checkpoint(_segment, state, q[:, part], k[:, part], v[:, part], g[:, part],
                              beta[:, part], use_reentrant=False)
        outs.append(o)
    return torch.cat(outs, 1)


def _short_conv(x, weight):
    """SiLU of the causal depthwise convolution of (B, S, C) by (C, 1, K)."""
    s, width = x.shape[1], weight.shape[-1]
    padded = F.pad(x, (0, 0, width - 1, 0))
    return F.silu(sum(padded[:, i:i + s] * weight[:, 0, i] for i in range(width)))


def _kda(w, p, x, cfg, rnd):
    b, s, _ = x.shape
    lin = cfg["linear_attn_config"]
    nh, d = lin["num_heads"], lin["head_dim"]

    def proj(name, y):
        return _mm(y, w[p + name + ".weight"].T, rnd)

    def heads(t):
        return t.reshape(b, s, nh, d)

    q = heads(_short_conv(proj("q_proj", x), w[p + "q_conv1d.weight"]))
    k = heads(_short_conv(proj("k_proj", x), w[p + "k_conv1d.weight"]))
    v = heads(_short_conv(proj("v_proj", x), w[p + "v_conv1d.weight"]))
    g = -torch.exp(w[p + "A_log"])[:, None] * F.softplus(
        heads(proj("f_b_proj", proj("f_a_proj", x)) + w[p + "dt_bias"]))
    beta = torch.sigmoid(proj("b_proj", x))
    o = delta_rule(q, k, v, g, beta)
    gate = heads(proj("g_b_proj", proj("g_a_proj", x)) + w[p + "g_b_proj.bias"])
    o = _rms(o, w[p + "o_norm.weight"], cfg["rms_norm_eps"]) * torch.sigmoid(gate)
    return proj("o_proj", o.reshape(b, s, nh * d))


def _attention(w, p, x, cfg, rnd):
    """Latent attention without rotation."""
    b, s, _ = x.shape
    nh, nope, rdim, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = _mm(x, w[p + "q_proj.weight"].T, rnd).view(b, s, nh, nope + rdim).transpose(1, 2)
    kv_a = _mm(x, w[p + "kv_a_proj_with_mqa.weight"].T, rnd)
    latent = _rms(kv_a[..., :rank], w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = _mm(latent, w[p + "kv_b_proj.weight"].T, rnd).view(b, s, nh, nope + vd).transpose(1, 2)
    k_pe = kv_a[..., rank:][:, None]  # one for every head
    k = torch.cat([kv[..., :nope], k_pe.expand(b, nh, s, rdim)], dim=-1)
    scores = _mm(q, k.transpose(-1, -2), rnd) / math.sqrt(nope + rdim)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = _mm(probs, kv[..., nope:], rnd).transpose(1, 2).reshape(b, s, nh * vd)
    return _mm(ctx, w[p + "o_proj.weight"].T, rnd)


def _encode_rows(w, bias, ids, mask, cfg, rnd):
    eps, shared = cfg["rms_norm_eps"], deepseek_cfg(cfg)
    kda_layers = cfg["linear_attn_config"]["kda_layers"]
    x = w["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        mixer = _kda if i + 1 in kda_layers else _attention
        x = x + mixer(w, p + "self_attn.", _rms(x, w[p + "input_layernorm.weight"], eps), cfg, rnd)
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0:
            flat = h.reshape(-1, h.shape[-1])
            x = x + _moe(w, p + "mlp.", bias[p + "mlp.gate.e_score_correction_bias"], flat,
                         shared, rnd).view(h.shape)
        else:
            x = x + _swiglu(w, p + "mlp.", h, rnd)
    x = _rms(x, w["model.norm.weight"], eps)
    m = mask.to(torch.float32)[:, :, None]
    mean = (x * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp(min=1e-12)


def encode_tokens(w: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor, cfg: Dict,
                  bias: Dict[str, torch.Tensor], rnd: Optional[Callable] = None) -> torch.Tensor:
    """(B, S) token ids and mask -> (B, H) unit sentence embeddings.
    ``cfg`` holds the published keys and ``experts_held``; ``bias`` the
    correction biases by their names."""
    return torch.cat([
        checkpoint(_encode_rows, w, bias, ids[r:r + BLOCK_ROWS], mask[r:r + BLOCK_ROWS], cfg,
                   rnd, use_reentrant=False)
        for r in range(0, ids.shape[0], BLOCK_ROWS)])
