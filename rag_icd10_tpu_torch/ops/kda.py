"""The gated delta rule of Kimi Delta Attention (models/kimi_linear.py
``KimiDeltaAttention``): from the short convolutions' q, k, v, the
per-channel log-decay g and the write strength beta to each head's
output o, before the gated output norm.

Per head, with q and k L2-normalised (x * rsqrt(sum x^2 + 1e-6)), q
scaled by d_k^-1/2, and a state S of d_k x d_v starting at 0:

    S <- Diag(exp g_t) S;   S <- S + beta_t k_t (v_t - S^T k_t)^T;   o_t = S^T q_t

This token loop (the flash-linear-attention library's
``naive_recurrent_kda``) is the definition. It is no implementation:
autograd would keep a state at every position. Both versions below
compute the same in chunks of up to ``CHUNK`` tokens, the WY form with
fine-grained decay. Within a chunk, with Gamma_t the sum of g up to and
including t (from the chunk's start, so never positive):

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
difference to a position that lies between t and j, never positive: a
decay that underflows gives 0, never inf or nan.

- ``kda_reference``: the plain version, torch operations. The CPU path,
  and what the kernels are held against on the card. A and P are built over
  blocks of 16, then 4, then 1 tokens (``SUB``), each row block's pairs
  with the earlier blocks as one product whose two factors are scaled to
  the row block's first boundary, exp(Gamma_t - Gamma_r) and
  exp(Gamma_r - Gamma_j), both at most 1. One level would do (blocks of 16,
  each block's own pairs with the exact per-channel weights
  exp(Gamma_t - Gamma_j)), but those weights are 16 x 16 x d_k numbers a
  block, which autograd keeps for the backward: counted at the Kimi cell's
  shapes, the backward's recomputation of one call would keep 18.7 GB (512
  rows of 48) and 21.5 GB (256 of 96) in place of 11.3 and 14.0. The blocks
  of 4 and 1 keep only per-row factors. It runs under non-reentrant
  ``torch.utils.checkpoint`` wherever a gradient is wanted: the products and
  the solve are recomputed in the backward rather than kept (about two
  dozen fp32 copies of k a call).
- ``kda``: on a CPU tensor the plain version; on a CUDA tensor the
  hand-written kernels of ``csrc/kda.cu`` (``kda_fwd``, ``kda_bwd``), bound
  as a ``torch.autograd.Function``, or a ``ValueError`` for what they do
  not take (``check_kernel_inputs``): d_k = d_v = 128, any S >= 1, q, k, v
  in bf16 or fp32 (one type), g and beta in fp32. The forward reads the
  inputs in place through their strides and writes o; it saves each row's
  state at every chunk boundary (none at S <= 48) beside the inputs, and
  the backward recomputes each chunk's products on chip from them: no
  checkpoint, nothing run twice. ``kda.launches`` counts kernel launches
  (one a forward, one a backward), and every forward call adds 1 to the
  counter ``kda.kernel_calls`` (utils/metrics.py).

Everything is fp32 (the L2 norms, the decay sums, the products, the
solve, the state); bf16 inputs are exact in fp32. Padding is on the
right and the rule is causal, so no valid position sees a pad: there is
no mask. Each call of ``kda`` adds 1 to the counter ``kda.core_calls``,
on either path, never for a recomputation. The kernels are built by
``ops/cuda_build.py`` at the first call, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils.metrics import metrics
from . import cuda_build

CHUNK = 48  # tokens a chunk: the size of the triangular solve
SUB = (16, 4, 1)  # the plain version's block sizes for a chunk's pairs
L2_EPS = 1e-6
HEAD = 128  # the kernels' d_k and d_v: Kimi-Linear's published head_dim

_launch_lock = threading.Lock()


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        beta: torch.Tensor) -> torch.Tensor:
    """q, k (B, S, H, d_k) and v (B, S, H, d_v) in any float type, g
    (B, S, H, d_k) the log-decay (never positive) and beta (B, S, H), both
    fp32 -> o (B, S, H, d_v) fp32: the plain version on a CPU tensor, the
    kernels on a CUDA one (``ValueError`` for what they do not take)."""
    metrics.count("kda.core_calls", 1)
    if q.device.type == "cpu":
        return kda_reference(q, k, v, g, beta)
    check_kernel_inputs(q, k, v, g, beta)
    args = (q, k, v, g, beta)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return _KDA.apply(*args, save)


kda.launches = 0


def kda_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """The plain version of ``kda``, under its checkpoint where a gradient
    is wanted."""
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


# ------------------------------------------------------------------ kernels


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        beta: torch.Tensor) -> None:
    """Raise ``ValueError`` for what the kernels do not take: q, k, v and g
    of one shape (B, S, H, 128), beta (B, S, H), q, k and v bf16 or fp32 (one
    type), g and beta fp32, all on one device, at least one position."""
    if q.dim() != 4 or q.shape[-1] != HEAD:
        raise ValueError(f"the delta-rule kernels take (B, S, H, {HEAD}) inputs; got q "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), ("g", g)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not q's shape {tuple(q.shape)}")
    if beta.shape != q.shape[:3]:
        raise ValueError(f"beta {tuple(beta.shape)} is not (B, S, H) = {tuple(q.shape[:3])}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the delta-rule kernels take bf16 or fp32 q, k, v of one type; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if g.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"the delta-rule kernels take fp32 g and beta; got {g.dtype}, "
                         f"{beta.dtype}")
    if len({t.device for t in (q, k, v, g, beta)}) > 1:
        raise ValueError("the delta-rule kernels need the inputs on one device; got "
                         f"{[str(t.device) for t in (q, k, v, g, beta)]}")
    if q.numel() == 0:
        raise ValueError(f"the delta-rule kernels need at least one position; got "
                         f"{tuple(q.shape)}")


def chunks(s: int) -> int:
    """The kernels' chunks of ``CHUNK`` tokens at sequence length ``s``."""
    return -(-s // CHUNK)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.load("kda").kda_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(kind: int, q, k, v, g, beta, o=None, states=None, dout=None, dq=None, dk=None,
            dv=None, dg=None, dbeta=None, dstate=None) -> None:
    """One forward (kind 0) or backward (1) of the kernels for q's type;
    the inputs through their strides, every output contiguous."""
    b, s, h, _ = q.shape
    strides = [*q.stride(), *k.stride(), *v.stride(), *g.stride(), *beta.stride()]
    packed = (ctypes.c_longlong * len(strides))(*strides)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = _kernel()(
            kind, int(q.dtype == torch.bfloat16), *map(ptr, (q, k, v, g, beta)),
            ctypes.addressof(packed), *map(ptr, (o, states, dout, dq, dk, dv, dg, dbeta, dstate)),
            b, s, h, HEAD ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"kda kernel ({'backward' if kind else 'forward'}) launch failed: "
                           f"CUDA error {err}")


class _KDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g, beta, save):
        b, s, h, d = q.shape
        o = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
        n = chunks(s)
        states = None
        if save and n > 1:  # the state entering each chunk past the first, for the backward
            states = torch.empty((b * h, n - 1, d, d), dtype=torch.float32, device=q.device)
        _launch(0, q, k, v, g, beta, o=o, states=states)
        with _launch_lock:
            kda.launches += 1
        metrics.count("kda.kernel_calls", 1)
        ctx.save_for_backward(q, k, v, g, beta, states)
        ctx.set_materialize_grads(False)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        if d_out is None:
            return None, None, None, None, None, None
        q, k, v, g, beta, states = ctx.saved_tensors
        b, s, h, d = q.shape
        d_out = d_out.float().contiguous()
        dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                      for _ in range(3))
        dg = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
        dbeta = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
        dstate = None
        if chunks(s) > 1:  # dS carried between chunks, one state a (row, head)
            dstate = torch.empty((b * h, d, d), dtype=torch.float32, device=q.device)
        _launch(1, q, k, v, g, beta, states=states, dout=d_out, dq=dq, dk=dk, dv=dv, dg=dg,
                dbeta=dbeta, dstate=dstate)
        with _launch_lock:
            kda.launches += 1
        return dq, dk, dv, dg, dbeta, None
