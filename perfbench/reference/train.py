"""Plain fine-tuning reference: bidirectional in-batch-negatives InfoNCE
with hard negatives, duplicate-title masking and the served level weights
in the logits (the sentence-transformers MultipleNegativesRankingLoss
family, as the reference system's recipe states it), and AdamW (optax
``adamw``: betas 0.9/0.999, eps 1e-8, decoupled weight decay 0.01 on every
leaf) under optax's warmup-cosine schedule. fp32 throughout, TF32 off;
``rnd`` rounds the matrix products' inputs for the control. The encoder
and its leaves are the configuration's family's (``families/``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

TEMPERATURE = 0.05
MASK_VALUE = -1e9


def schedule(count: int, peak: float, warmup: int, decay: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay) at
    ``count``, in fp32 as optax computes it."""
    f32 = np.float32
    if count < warmup:
        return float((f32(0) - f32(peak)) * (f32(1) - f32(count) / f32(warmup)) + f32(peak))
    t = min(f32(count - warmup), f32(decay - warmup))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay - warmup), dtype=f32))
    return float(f32(peak) * cos)


def loss_fn(w, batch: Dict[str, torch.Tensor], encode: Callable, rnd=None) -> torch.Tensor:
    """The masked, weighted InfoNCE of one triplet batch; ``encode(w, ids,
    mask, rnd=)`` gives the (B, H) unit sentence embeddings."""
    za = encode(w, batch["a_ids"], batch["a_mask"], rnd=rnd)
    zb = encode(w, batch["b_ids"], batch["b_mask"], rnd=rnd)
    zh = encode(w, batch["h_ids"], batch["h_mask"], rnd=rnd)

    def mm(a, b):
        return (a @ b) if rnd is None else (rnd(a) @ rnd(b))

    ga, gb, gh = batch["group_a"], batch["group_b"], batch["h_group"]
    n = za.shape[0]
    pos = mm(za, zb.T) * batch["w_b"][None, :] / TEMPERATURE
    same = ((ga[:, None] == ga[None, :]) | (gb[:, None] == gb[None, :])
            | (ga[:, None] == gb[None, :]) | (gb[:, None] == ga[None, :]))
    off = ~torch.eye(n, dtype=torch.bool, device=za.device)
    pos = pos.masked_fill(same & off, MASK_VALUE)
    hn = mm(za, zh.T) * batch["w_h"][None, :] / TEMPERATURE
    hn = hn.masked_fill((gh[None, :] == ga[:, None]) | (gh[None, :] == gb[:, None]), MASK_VALUE)
    labels = torch.arange(n, device=za.device)
    return 0.5 * (F.cross_entropy(torch.cat([pos, hn], 1), labels)
                  + F.cross_entropy(pos.T, labels))


def to_device(batch: Dict[str, np.ndarray], device, rows: Optional[slice] = None) -> Dict:
    out = {}
    for key, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if rows is not None and key.endswith(("_ids", "_mask")):
            t = t[rows]
        out[key] = t.to(device, torch.float32 if key.startswith("w_") else torch.long)
    return out


def run_steps(w0: Dict[str, torch.Tensor], batches: List[Dict[str, np.ndarray]], loss: Callable,
              peak_lr: float, warmup: int, decay: int, weight_decay: float = 0.01,
              rnd: Optional[Callable] = None, moments=None, start: int = 0) -> Dict:
    """AdamW steps from ``w0`` over ``batches`` under ``loss(w, batch,
    rnd)`` (the family's loss of one batch), the first of them the
    optimizer's step ``start`` (its moments ``moments`` = (m, v), else
    zeros). Returns each step's loss, each leaf's gradient norm at the
    first step and its change's norm after the last."""
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: (moments[0][k].clone() if moments else torch.zeros_like(v)) for k, v in w.items()}
    v2 = {k: (moments[1][k].clone() if moments else torch.zeros_like(v)) for k, v in w.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad0 = [], {}
    device = next(iter(w0.values())).device
    for i, batch in enumerate(batches):
        t = start + i
        value = loss(w, to_device(batch, device), rnd)
        grads = torch.autograd.grad(value, list(w.values()))
        losses.append(float(value.detach()))
        lr = schedule(t, peak_lr, warmup, decay)
        with torch.no_grad():
            for (k, p), g in zip(w.items(), grads):
                if i == 0:
                    grad0[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** (t + 1))
                vhat = v2[k] / (1 - b2 ** (t + 1))
                p.sub_(lr * (mhat / (vhat.sqrt() + eps) + weight_decay * p))
        del grads, value
    change = {k: float(torch.linalg.vector_norm(w[k].detach() - w0[k])) for k in w}
    return {"losses": losses, "grad0": grad0, "change": change}
