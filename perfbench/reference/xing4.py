"""Plain Xing4.0 decoder (Xing4.0-29B-A4B) as a sentence encoder in fp32:
the decoder, the sum of its residual streams, its final RMSNorm, masked
mean pooling and L2 normalisation; one expert-parallel rank's share of
each expert layer.

Written from the published description (the checkpoint's ``config.json``;
the DeepSeek-V3 block of ``modeling_deepseek.py`` with q-LoRA, its YaRN
rotary tables and softmax scale; "mHC: Manifold-Constrained
Hyper-Connections", arXiv:2512.24880, on "Hyper-Connections",
arXiv:2409.19606). Weights are the benchmark's leaves in the published
names (linear weights (out, in); each sublayer's phi ``hc_*.fn`` (24,
4 x hidden), b ``hc_*.base``, alpha ``hc_*.scale``); the routers'
correction biases come apart (``bias``). TF32 is switched off by the
caller, so every product is IEEE fp32; ``rnd`` rounds every projection's
and attention product's inputs (``reference/lowp.py``), but neither phi's
product nor the streams' mixing, which the configuration keeps in fp32.

Each token carries n = ``hc_mult`` streams X (n, C). A sublayer F:

    x' = vec(X) / sqrt(mean(vec(X)^2) + rms_norm_eps);  m = x' phi^T
    H_pre = sigmoid(alpha_0 m[:n] + b[:n]);  H_post = 2 sigmoid(alpha_1 m[n:2n] + b[n:2n])
    H_res = Sinkhorn(exp(clamp(alpha_2 mat(m[2n:]) + b[2n:], clamp_min, clamp_max)))
    X <- H_res X + H_post^T F(RMSNorm(H_pre X))

with ``hc_sinkhorn_iters`` steps of the rows, then the columns, divided by
their sums plus ``hc_eps``. The streams start as the embedding n times
over and are summed before the final RMSNorm. YaRN: each rotary frequency
theta^(-2i/d) blended with it over ``factor`` by the linear ramp between
the correction dimensions of ``beta_fast`` and ``beta_slow``; the tables
scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim); the
softmax scale (qk_nope + qk_rope)^-1/2 mscale(factor, mscale_all_dim)^2,
mscale(s, m) = 0.1 m ln s + 1.

Departures from the published model, each deliberate: no LM head and no
multi-token prediction module (the sentence encoder); a causal mask only
(padding is on the right); the routed sum over the held experts alone
(``experts_held``).

The rows run in blocks, each under ``torch.utils.checkpoint`` (not
reentrant): only a block's activations live at once, and the backward
recomputes them. That is exact, since every token's routing is its own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .deepseek_v3 import _mm, _moe, _rms, _swiglu

BLOCK_ROWS = 32


def _mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _inv_freq(cfg, device):
    d, theta, rs = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), cfg.get("rope_scaling")
    base = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
    if rs is None:
        return base

    def correction_dim(rotations):
        return d * math.log(rs["original_max_position_embeddings"]
                            / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), d - 1)
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    ramp = ((i - low) / (high - low if high > low else 0.001)).clamp(0, 1)
    return base / rs["factor"] * ramp + base * (1 - ramp)


def _rope(x, cfg):
    rs = cfg.get("rope_scaling")
    scale = 1.0 if rs is None else (_mscale(rs["factor"], rs["mscale"])
                                    / _mscale(rs["factor"], rs["mscale_all_dim"]))
    angle = torch.arange(x.shape[-2], dtype=torch.float64, device=x.device)[:, None] \
        * _inv_freq(cfg, x.device)[None, :]
    turn = (torch.polar(torch.ones_like(angle), angle) * scale).to(torch.complex64)
    z = torch.complex(x[..., 0::2], x[..., 1::2]) * turn
    return torch.cat([z.real, z.imag], dim=-1)


def _softmax_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim"):
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _attention(w, p, x, cfg, rnd):
    """Latent attention with q-LoRA and the YaRN tables and scale."""
    b, s, _ = x.shape
    nh, nope, rdim, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q_a = _rms(_mm(x, w[p + "q_a_proj.weight"].T, rnd), w[p + "q_a_layernorm.weight"], eps)
    q = _mm(q_a, w[p + "q_b_proj.weight"].T, rnd).view(b, s, nh, nope + rdim).transpose(1, 2)
    kv_a = _mm(x, w[p + "kv_a_proj_with_mqa.weight"].T, rnd)
    latent = _rms(kv_a[..., :rank], w[p + "kv_a_layernorm.weight"], eps)
    kv = _mm(latent, w[p + "kv_b_proj.weight"].T, rnd).view(b, s, nh, nope + vd).transpose(1, 2)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cfg)], dim=-1)
    k_pe = _rope(kv_a[..., rank:][:, None], cfg)  # one for every head
    k = torch.cat([kv[..., :nope], k_pe.expand(b, nh, s, rdim)], dim=-1)
    scores = _mm(q, k.transpose(-1, -2), rnd) * _softmax_scale(cfg)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = _mm(probs, kv[..., nope:], rnd).transpose(1, 2).reshape(b, s, nh * vd)
    return _mm(ctx, w[p + "o_proj.weight"].T, rnd)


def _sinkhorn(logits, cfg):
    h = torch.exp(logits)
    for _ in range(cfg["hc_sinkhorn_iters"]):
        h = h / (h.sum(-1, keepdim=True) + cfg["hc_eps"])
        h = h / (h.sum(-2, keepdim=True) + cfg["hc_eps"])
    return h


def _sublayer(w, p, streams, cfg, rnd, fn, norm):
    """The sublayer ``fn`` on the streams (B, S, n, C) through the
    hyper-connection ``p`` and the RMSNorm weight ``norm``."""
    n = cfg["hc_mult"]
    flat = streams.reshape(*streams.shape[:-2], -1)
    flat = flat / torch.sqrt(flat.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    m = flat @ w[p + "fn"].T  # fp32 in the configuration: not rounded by ``rnd``
    alpha, b = w[p + "scale"], w[p + "base"]
    pre = torch.sigmoid(alpha[0] * m[..., :n] + b[:n])
    post = 2 * torch.sigmoid(alpha[1] * m[..., n:2 * n] + b[n:2 * n])
    logits = (alpha[2] * m[..., 2 * n:] + b[2 * n:]).reshape(*m.shape[:-1], n, n)
    res = _sinkhorn(logits.clamp(cfg["mhc_h_res_clamp_min"], cfg["mhc_h_res_clamp_max"]), cfg)
    h = torch.einsum("...j,...jc->...c", pre, streams)
    y = fn(_rms(h, w[norm], cfg["rms_norm_eps"]))
    return torch.einsum("...ij,...jc->...ic", res, streams) + post[..., :, None] * y[..., None, :]


def _encode_rows(w, bias, ids, mask, cfg, rnd):
    e = w["model.embed_tokens.weight"][ids]
    x = e[..., None, :].expand(*e.shape[:-1], cfg["hc_mult"], e.shape[-1])
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."

        def mlp(h, p=p, i=i):
            if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0:
                flat = h.reshape(-1, h.shape[-1])
                return _moe(w, p + "mlp.", bias[p + "mlp.gate.e_score_correction_bias"], flat,
                            cfg, rnd).view(h.shape)
            return _swiglu(w, p + "mlp.", h, rnd)

        x = _sublayer(w, p + "hc_attn.", x, cfg, rnd,
                      lambda h, p=p: _attention(w, p + "self_attn.", h, cfg, rnd),
                      p + "input_layernorm.weight")
        x = _sublayer(w, p + "hc_mlp.", x, cfg, rnd, mlp, p + "post_attention_layernorm.weight")
    x = _rms(x.sum(-2), w["model.norm.weight"], cfg["rms_norm_eps"])
    m = mask.to(torch.float32)[:, :, None]
    mean = (x * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp(min=1e-12)


def encode_tokens(w: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor, cfg: Dict,
                  bias: Dict[str, torch.Tensor], rnd: Optional[Callable] = None) -> torch.Tensor:
    """(B, S) token ids and mask -> (B, H) unit sentence embeddings.
    ``cfg`` holds the published keys and ``experts_held``; ``bias`` the
    correction biases by their published names."""
    return torch.cat([
        checkpoint(_encode_rows, w, bias, ids[r:r + BLOCK_ROWS], mask[r:r + BLOCK_ROWS], cfg,
                   rnd, use_reentrant=False)
        for r in range(0, ids.shape[0], BLOCK_ROWS)])
