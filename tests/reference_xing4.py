"""Plain fp32 reference of a Xing4.0 decoder as a sentence encoder, for the
port's tests (tests/test_torch_xing4.py, tests/test_torch_cuda_xing4.py).
Written from the published description (the checkpoint's ``config.json``;
the DeepSeek-V3 block of tests/reference_deepseek_v3.py with q-LoRA and
the modelling code's YaRN rotary tables and softmax scale; the residual
streams of "mHC: Manifold-Constrained Hyper-Connections", arXiv:2512.24880,
on "Hyper-Connections", arXiv:2409.19606), in plain ``torch`` and fp32; it
imports nothing of the port and no JAX. Call ``no_tf32()`` before using it
on a card.

Each token carries n = ``hc_mult`` streams X (n, C). Each sublayer F (the
attention, the MLP) reads and writes them through its own phi
(``hc_*.fn``, (n^2 + 2n, nC)), b (``hc_*.base``) and alpha
(``hc_*.scale``):

    x' = vec(X) / sqrt(mean(vec(X)^2) + rms_norm_eps);  m = x' phi^T
    H_pre = sigmoid(alpha_0 m[:n] + b[:n]);  H_post = 2 sigmoid(alpha_1 m[n:2n] + b[n:2n])
    H_res = Sinkhorn(exp(clamp(alpha_2 mat(m[2n:]) + b[2n:], clamp_min, clamp_max)))
    X <- H_res X + H_post^T F(RMSNorm(H_pre X))

Sinkhorn: ``hc_sinkhorn_iters`` times, the rows divided by their sums,
then the columns by theirs, every sum plus ``hc_eps``. The streams start
as the embedding, n times, and are summed before the final RMSNorm.

Departures from the published model, each deliberate: no LM head and no
multi-token prediction module (the sentence encoder: mean pool over the
valid positions, L2 normalise); a causal mask only (padding on the right);
the routed sum over the held experts alone (``experts_held``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

import reference_deepseek_v3 as dsv3
from reference_deepseek_v3 import no_tf32, rms_norm, swiglu  # noqa: F401 (no_tf32: callers')


def yarn_mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(cfg: Dict, device=None) -> torch.Tensor:
    """The rotary frequencies (rope / 2,) in float64: theta^(-2i/d), and
    with YaRN that blended with itself over ``factor`` by the linear ramp
    between the correction dimensions of beta_fast and beta_slow."""
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


def table_scale(cfg: Dict) -> float:
    rs = cfg.get("rope_scaling")
    if rs is None:
        return 1.0
    return yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])


def softmax_scale(cfg: Dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim"):
        scale *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope(x, cfg):
    """(..., S, d) -> each pair (x[2i], x[2i+1]) at position p rotated by p
    inv_freq[i] and scaled by the table scale, as [real parts, imaginary
    parts]."""
    s = x.shape[-2]
    angle = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv_freq(
        cfg, x.device)[None, :]
    turn = (torch.polar(torch.ones_like(angle), angle) * table_scale(cfg)).to(torch.complex64)
    z = torch.complex(x[..., 0::2], x[..., 1::2]) * turn
    return torch.cat([z.real, z.imag], dim=-1)


def attention(w, p, x, cfg):
    """Latent attention with q-LoRA (where ``q_lora_rank`` is set)."""
    b, s, _ = x.shape
    nh, nope, rdim, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    if cfg.get("q_lora_rank"):
        q_a = rms_norm(x @ w[p + "q_a_proj.weight"].T, w[p + "q_a_layernorm.weight"], eps)
        q = q_a @ w[p + "q_b_proj.weight"].T
    else:
        q = x @ w[p + "q_proj.weight"].T
    q = q.view(b, s, nh, nope + rdim).transpose(1, 2)
    kv_a = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    latent = rms_norm(kv_a[..., :rank], w[p + "kv_a_layernorm.weight"], eps)
    k_pe = kv_a[..., rank:][:, None]  # (B, 1, S, rope): one for every head
    kv = (latent @ w[p + "kv_b_proj.weight"].T).view(b, s, nh, nope + vd).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg)], dim=-1)
    k = torch.cat([kv[..., :nope], rope(k_pe, cfg).expand(b, nh, s, rdim)], dim=-1)
    scores = q @ k.transpose(-1, -2) * softmax_scale(cfg)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = (probs @ kv[..., nope:]).transpose(1, 2).reshape(b, s, nh * vd)
    return ctx @ w[p + "o_proj.weight"].T


def sinkhorn(logits, cfg):
    h = torch.exp(logits)
    for _ in range(cfg["hc_sinkhorn_iters"]):
        h = h / (h.sum(-1, keepdim=True) + cfg["hc_eps"])
        h = h / (h.sum(-2, keepdim=True) + cfg["hc_eps"])
    return h


def mixing(w, p, streams, cfg):
    """X (..., n, C) -> H_pre (..., n), H_post (..., n), H_res (..., n, n)."""
    n = cfg["hc_mult"]
    flat = streams.reshape(*streams.shape[:-2], -1)
    flat = flat / torch.sqrt(flat.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    m = flat @ w[p + "fn"].T
    alpha, b = w[p + "scale"], w[p + "base"]
    pre = torch.sigmoid(alpha[0] * m[..., :n] + b[:n])
    post = 2 * torch.sigmoid(alpha[1] * m[..., n:2 * n] + b[n:2 * n])
    logits = (alpha[2] * m[..., 2 * n:] + b[2 * n:]).reshape(*m.shape[:-1], n, n)
    logits = logits.clamp(cfg["mhc_h_res_clamp_min"], cfg["mhc_h_res_clamp_max"])
    return pre, post, sinkhorn(logits, cfg)


def sublayer(w, p, streams, cfg, fn, norm):
    """One sublayer ``fn`` on the streams through hyper-connection ``p``
    (``...hc_attn.``) and RMSNorm weight ``norm``."""
    pre, post, res = mixing(w, p, streams, cfg)
    h = torch.einsum("...j,...jc->...c", pre, streams)
    y = fn(rms_norm(h, w[norm], cfg["rms_norm_eps"]))
    return torch.einsum("...ij,...jc->...ic", res, streams) + post[..., :, None] * y[..., None, :]


def hidden(w: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, S) ids -> the final RMSNorm's output (B, S, H)."""
    held = cfg.get("experts_held")
    e = w["model.embed_tokens.weight"][ids]
    x = e[..., None, :].expand(*e.shape[:-1], cfg["hc_mult"], e.shape[-1])
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."

        def mlp(h, p=p, i=i):
            if dsv3.is_moe(cfg, i):
                return dsv3.moe(w, p + "mlp.", h.reshape(-1, h.shape[-1]), cfg,
                                held).view(h.shape)
            return swiglu(w, p + "mlp.", h)

        x = sublayer(w, p + "hc_attn.", x, cfg,
                     lambda h, p=p: attention(w, p + "self_attn.", h, cfg),
                     p + "input_layernorm.weight")
        x = sublayer(w, p + "hc_mlp.", x, cfg, mlp, p + "post_attention_layernorm.weight")
    return rms_norm(x.sum(-2), w["model.norm.weight"], cfg["rms_norm_eps"])


def encode(w: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor,
           cfg: Dict) -> torch.Tensor:
    """(B, S) ids and mask -> (B, H) unit sentence embeddings."""
    m = mask.to(torch.float32)[:, :, None]
    mean = (hidden(w, ids, cfg) * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp(min=1e-12)
