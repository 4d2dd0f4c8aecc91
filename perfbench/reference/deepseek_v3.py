"""Plain DeepSeek-V3-family decoder (Moonlight-16B-A3B) as a sentence
encoder in fp32: the decoder, its final RMSNorm, masked mean pooling and
L2 normalisation; one expert-parallel rank's share of each expert layer.

Written from the published description (the checkpoint's ``config.json``
and ``modeling_deepseek.py``). Weights are the benchmark's leaves in the
published names (linear weights (out, in)); the routers' correction
biases come apart (``bias``), since they change only which experts are
chosen and take no gradient. TF32 is switched off by the caller
(``reference/bert.py no_tf32``), so every product is IEEE fp32; ``rnd``
rounds every matrix product's inputs (``reference/lowp.py``).

Departures from the published model, each deliberate: no LM head (the
sentence encoder); RoPE written as complex rotations of the pairs
(x[2i], x[2i+1]), laid out as [real, imaginary] as the modelling code's
de-interleave gives; a causal mask only (padding is on the right); the
routed sum over the held experts alone (``experts_held``): what the
others would add is left out, in the program and here alike.

The rows run in blocks, each under ``torch.utils.checkpoint`` (not
reentrant): only a block's activations live at once, and the backward
recomputes them. That is exact, since every token's routing is its own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BLOCK_ROWS = 32


def _mm(a: torch.Tensor, b: torch.Tensor, rnd: Optional[Callable]) -> torch.Tensor:
    if rnd is not None and a.numel():  # an expert that took no token has nothing to round
        a, b = rnd(a), rnd(b)
    return a @ b


def _rms(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rope(x, theta):
    s, d = x.shape[-2], x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    angle = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freq[None, :]
    turn = torch.polar(torch.ones_like(angle), angle).to(torch.complex64)
    z = torch.complex(x[..., 0::2], x[..., 1::2]) * turn
    return torch.cat([z.real, z.imag], dim=-1)


def _swiglu(w, p, x, rnd):
    gate = _mm(x, w[p + "gate_proj.weight"].T, rnd)
    up = _mm(x, w[p + "up_proj.weight"].T, rnd)
    return _mm(F.silu(gate) * up, w[p + "down_proj.weight"].T, rnd)


def _attention(w, p, x, cfg, rnd):
    b, s, _ = x.shape
    nh, nope, rdim, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = _mm(x, w[p + "q_proj.weight"].T, rnd).view(b, s, nh, nope + rdim).transpose(1, 2)
    kv_a = _mm(x, w[p + "kv_a_proj_with_mqa.weight"].T, rnd)
    latent = _rms(kv_a[..., :rank], w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = _mm(latent, w[p + "kv_b_proj.weight"].T, rnd).view(b, s, nh, nope + vd).transpose(1, 2)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
    k_pe = _rope(kv_a[..., rank:][:, None], cfg["rope_theta"])  # one for every head
    k = torch.cat([kv[..., :nope], k_pe.expand(b, nh, s, rdim)], dim=-1)
    scores = _mm(q, k.transpose(-1, -2), rnd) / math.sqrt(nope + rdim)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = _mm(probs, kv[..., nope:], rnd).transpose(1, 2).reshape(b, s, nh * vd)
    return _mm(ctx, w[p + "o_proj.weight"].T, rnd)


def _moe(w, p, bias, x, cfg, rnd):
    """The held experts' part of the routed sum plus the shared experts, on
    (T, H): sigmoid scores over every expert from fp32, the correction bias
    in the choice only, the chosen scores normalised and scaled."""
    scores = torch.sigmoid(_mm(x, w[p + "gate.weight"].T, rnd))
    idx = torch.topk(scores.detach() + bias, cfg["num_experts_per_tok"], dim=-1).indices
    weight = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in cfg["experts_held"]:
        hit = idx == e
        rows = hit.any(-1).nonzero().squeeze(1)
        we = (weight * hit).sum(-1)[rows]
        out = out.index_add(0, rows, we[:, None] * _swiglu(w, f"{p}experts.{e}.", x[rows], rnd))
    return out + _swiglu(w, p + "shared_experts.", x, rnd)


def _encode_rows(w, bias, ids, mask, cfg, rnd):
    eps = cfg["rms_norm_eps"]
    x = w["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        x = x + _attention(w, p + "self_attn.", _rms(x, w[p + "input_layernorm.weight"], eps),
                           cfg, rnd)
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0:
            flat = h.reshape(-1, h.shape[-1])
            x = x + _moe(w, p + "mlp.", bias[p + "mlp.gate.e_score_correction_bias"], flat,
                         cfg, rnd).view(h.shape)
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
    correction biases by their published names."""
    return torch.cat([
        checkpoint(_encode_rows, w, bias, ids[r:r + BLOCK_ROWS], mask[r:r + BLOCK_ROWS], cfg,
                   rnd, use_reentrant=False)
        for r in range(0, ids.shape[0], BLOCK_ROWS)])
