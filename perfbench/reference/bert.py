"""Plain BERT-base sentence encoder in fp32 (post-LayerNorm BERT, masked
mean pooling, L2 normalisation), as text2vec-base-chinese is published.

Weights are the benchmark's leaves (``gen/weights.py`` names, Dense
kernels (in, out)). TF32 is switched off, so every product is IEEE fp32.
``rnd`` rounds every matrix product's inputs (``reference/lowp.py``):
the control in a precision below the configuration's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mm(a: torch.Tensor, b: torch.Tensor, rnd: Optional[Callable]) -> torch.Tensor:
    if rnd is not None:
        a, b = rnd(a), rnd(b)
    return a @ b


def encode_tokens(w: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor,
                  heads: int, eps: float = 1e-12, rnd: Optional[Callable] = None) -> torch.Tensor:
    """(B, S) token ids and mask -> (B, H) unit sentence embeddings."""
    b, s = ids.shape
    h = w["word"].shape[1]
    hd = h // heads
    x = w["word"][ids] + w["pos"][:s][None] + w["type"][0][None, None]
    x = F.layer_norm(x, (h,), w["emb_ln.g"], w["emb_ln.b"], eps)
    bias = (1.0 - mask.to(torch.float32))[:, None, None, :] * torch.finfo(torch.float32).min
    n_layers = sum(1 for k in w if k.endswith(".q.w"))
    for i in range(n_layers):
        p = f"l{i}."

        def dense(t, name):
            return _mm(t, w[p + name + ".w"], rnd) + w[p + name + ".b"]

        def split(t):
            return t.view(b, s, heads, hd).transpose(1, 2)

        q, k, v = (split(dense(x, n)) for n in ("q", "k", "v"))
        scores = _mm(q, k.transpose(-1, -2), rnd) / math.sqrt(hd) + bias
        ctx = _mm(torch.softmax(scores, dim=-1), v, rnd)
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        x = F.layer_norm(x + dense(ctx, "o"), (h,), w[p + "attn_ln.g"], w[p + "attn_ln.b"], eps)
        ffn = dense(F.gelu(dense(x, "ffn_in"), approximate="none"), "ffn_out")
        x = F.layer_norm(x + ffn, (h,), w[p + "out_ln.g"], w[p + "out_ln.b"], eps)
    m = mask.to(torch.float32)[:, :, None]
    mean = (x * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True).clamp(min=1e-12)
