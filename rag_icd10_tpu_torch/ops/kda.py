"""The gated delta rule of Kimi Delta Attention (models/kimi_linear.py
``KimiDeltaAttention``): from the short convolutions' q, k, v, the
per-channel log-decay g and the write strength beta to each head's
output o, before the gated output norm.

Per head, with q and k L2-normalised (x * rsqrt(sum x^2 + 1e-6)), q
scaled by d_k^-1/2, and a state S of d_k x d_v starting at 0:

    S <- Diag(exp g_t) S;   S <- S + beta_t k_t (v_t - S^T k_t)^T;   o_t = S^T q_t

This token loop (the flash-linear-attention library's
``naive_recurrent_kda``) is the definition. It is no implementation:
autograd would keep a state at every position. ``kda`` computes the same
in chunks of up to ``CHUNK`` tokens, the WY form with fine-grained
decay. Within a chunk, with Gamma_t the sum of g up to and including t
(from the chunk's start, so never positive):

- A_tj = sum_c k_tc k_jc exp(Gamma_tc - Gamma_jc) for j < t, and
  P_tj the same with q_t for j <= t;
- U solves (I + Diag(beta) A) U = Diag(beta) (V - (k exp Gamma) S0), a unit
  lower-triangular solve: U's rows are the values written, u_t =
  beta_t (v_t - (Diag(exp g_t) S_{t-1})^T k_t);
- O = (q exp Gamma) S0 + P U, and the next chunk's state
  S = Diag(exp Gamma_last) S0 + (k exp(Gamma_last - Gamma))^T U.

The trap is the decay. Written as exp(Gamma_t) exp(-Gamma_j), a pair's
weight overflows fp32 once a chunk's summed decay passes about 88 nats,
which a head decaying a few nats a token reaches inside one chunk. So
every exponent here is a difference Gamma_t - Gamma_j with j <= t, or a
difference to a block boundary that lies between t and j: A and P are
built over blocks of 16, then 4, then 1 tokens (``SUB``), each row block's
pairs with the earlier blocks as one product whose two factors are
scaled to the row block's first boundary, exp(Gamma_t - Gamma_r) and
exp(Gamma_r - Gamma_j), both at most 1. A decay that underflows gives 0,
never inf or nan. One level would do (blocks of 16, each block's own
pairs with the exact per-channel weights exp(Gamma_t - Gamma_j)), but
those weights are 16 x 16 x d_k numbers a block, which autograd keeps for
the backward: counted at the Kimi cell's shapes, the backward's
recomputation of one call would keep 18.7 GB (512 rows of 48) and 21.5 GB
(256 of 96) in place of 11.3 and 14.0, on a cell whose peak is 71-73 of
the card's 80 GB. The blocks of 4 and 1 keep only per-row factors.

Everything is fp32 (the L2 norms, the decay sums, the products, the
solve, the state); bf16 inputs are exact in fp32. Padding is on the
right and the rule is causal, so no valid position sees a pad: there is
no mask. The same code runs on the CPU and on the card. The core runs
under non-reentrant ``torch.utils.checkpoint`` wherever a gradient is
wanted: the products and the solve are recomputed in the backward, as
the library's kernels recompute them, rather than kept (about two dozen
fp32 copies of k a call). Each call adds 1 to the counter
``kda.core_calls`` (utils/metrics.py), never its recomputation.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils.metrics import metrics

CHUNK = 48  # tokens a chunk: the size of the triangular solve
SUB = (16, 4, 1)  # the block sizes a chunk's pairs are built over
L2_EPS = 1e-6


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        beta: torch.Tensor) -> torch.Tensor:
    """q, k (B, S, H, d_k) and v (B, S, H, d_v) in any float type, g
    (B, S, H, d_k) the log-decay (never positive) and beta (B, S, H), both
    fp32 -> o (B, S, H, d_v) fp32."""
    metrics.count("kda.core_calls", 1)
    args = (q, k, v, g, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return checkpoint(_chunked, *args, use_reentrant=False)
    return _chunked(*args)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def _sizes(chunk: int) -> Sequence[int]:
    return (chunk,) + tuple(s for s in SUB if s < chunk)


def _pairs(x2: torch.Tensor, k: torch.Tensor, gam: torch.Tensor,
           sizes: Sequence[int]) -> torch.Tensor:
    """Over blocks of ``sizes[0]`` positions: x2 (..., L, 2, D) (each row's q
    and k), k and gam (..., L, D). Returns (..., L, 2, L): for j < i, sum_c
    x2[i, :, c] k[j, c] exp(gam[i, c] - gam[j, c]); 0 for j >= i. The blocks
    are taken apart with ``unbind`` (one gradient buffer a tensor in the
    backward, where slices would each fill one of the whole size)."""
    n_rows = x2.shape[-3]
    if len(sizes) == 1:
        return x2.new_zeros(*x2.shape[:-1], n_rows)
    sub = sizes[1]
    n = n_rows // sub
    xs = x2.unflatten(-3, (n, sub))
    ks, gs = k.unflatten(-2, (n, sub)), gam.unflatten(-2, (n, sub))
    inner = _pairs(xs, ks, gs, sizes[1:]).unbind(-4)  # each block's own pairs
    xs, ks, gs = xs.unbind(-4), ks.unbind(-3), gs.unbind(-3)
    rows = []
    for m in range(n):
        parts = []
        if m:  # the pairs with the earlier blocks, scaled to the boundary before block m
            ref = gs[m - 1][..., -1:, :]
            a = xs[m] * torch.exp(gs[m] - ref).unsqueeze(-2)  # (..., sub, 2, D)
            b = torch.cat(ks[:m], -2) * torch.exp(ref - torch.cat(gs[:m], -2))  # (..., m sub, D)
            if sub == 1:  # a row against each earlier position: products too small for a GEMM
                parts.append((a.unsqueeze(-2) * b[..., None, None, :, :]).sum(-1))
            else:
                parts.append((a.flatten(-3, -2) @ b.transpose(-1, -2)).unflatten(-2, (sub, 2)))
        parts.append(inner[m])
        if m < n - 1:
            parts.append(x2.new_zeros(*x2.shape[:-3], sub, 2, n_rows - (m + 1) * sub))
        rows.append(torch.cat(parts, -1))
    return torch.cat(rows, -3)


def _chunked(q, k, v, g, beta):
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(CHUNK, -(-s // SUB[0]) * SUB[0])
    n = -(-s // c)
    pad = n * c - s

    def chunks(x):
        """(B, S, H, ...) -> (B, H, n, c, ...) fp32, right-padded with 0."""
        x = x.float()
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        x = x.unflatten(1, (n, c))
        return x.permute(0, 3, 1, 2, *range(4, x.dim())).contiguous()

    q = chunks(_l2(q.float()) * dk ** -0.5)
    k = chunks(_l2(k.float()))
    v, beta = chunks(v), chunks(beta)
    gam = chunks(g).cumsum(-2)  # (B, H, n, c, dk), from each chunk's start
    strict_q, strict_k = _pairs(torch.stack([q, k], -2), k, gam, _sizes(c)).unbind(-2)
    p = strict_q + torch.diag_embed((q * k).sum(-1))  # j <= t
    a = beta[..., None] * strict_k  # Diag(beta) A, j < t
    rhs = v
    if n > 1:  # the values' part of the incoming state: W = T (k exp Gamma)
        rhs = torch.cat([v, k * torch.exp(gam)], -1)
    solved = torch.linalg.solve_triangular(a, beta[..., None] * rhs, upper=False,
                                           unitriangular=True)
    u_all, w_all = (solved, solved) if n == 1 else solved.split([dv, dk], -1)
    outs, state = [], None
    for q_i, k_i, gam_i, p_i, u, w in zip(*(t.unbind(2) for t in (q, k, gam, p, u_all, w_all))):
        if state is None:
            o = p_i @ u
        else:
            u = u - w @ state
            o = (q_i * torch.exp(gam_i)) @ state + p_i @ u
        outs.append(o)
        if len(outs) < n:
            last = gam_i[..., -1:, :]  # (B, H, 1, dk)
            carried = (k_i * torch.exp(last - gam_i)).transpose(-1, -2) @ u
            state = carried if state is None else torch.exp(last).transpose(-1, -2) * state \
                + carried
    o = torch.stack(outs, 2).flatten(2, 3)[:, :, :s]  # (B, H, S, dv)
    return o.transpose(1, 2)
