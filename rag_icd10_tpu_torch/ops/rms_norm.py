"""The residual add and RMSNorm of the decoder block (models/deepseek_v3.py):
``x_new = x + branch.float()`` and ``y = weight * (x_new * rsqrt(mean(x_new²)
+ eps))``, with ``y`` handed to each of its consumers in the dtype that
consumer computes in.

- ``add_rms_norm_reference``: the plain version, the model's old inline
  chain (the add, the norm, then each consumer's cast). The CPU path, and
  what the kernels are held against.
- ``add_rms_norm``: on a CPU tensor the plain version; on a CUDA tensor the
  hand-written kernels of ``csrc/rms_norm.cu`` (``rms_norm_fwd``,
  ``rms_norm_bwd``, ``rms_norm_dw``), bound as a ``torch.autograd.Function``,
  or a ``ValueError`` for what they do not take. ``add_rms_norm.launches``
  counts kernel launches (one a forward, two a backward), and every forward
  call adds 1 to the counter ``norm.kernel_calls`` (utils/metrics.py).

The kernels write ``x_new`` (fp32) where there is a branch, one fp32 ``y``
that every fp32 consumer shares (autograd adds their gradients in fp32, as
it does the plain chain's), one bf16 ``y`` for each bf16 consumer, and one
fp32 ``rstd`` a row for the backward. A bf16 consumer's gradient thus
reaches the backward kernel on its own and the sum is taken there in fp32,
as autograd sums the gradients of the plain chain's casts; one bf16 ``y``
shared by two consumers would add their gradients in bf16. They take
widths 2048, 2304 and 3584 (Moonlight's, Kimi-Linear's and Xing4.0's hidden
sizes), 512 (the kv rank of all three) and 768 (Xing4.0's q rank), fp32 ``x`` with a bf16 or fp32 branch or none, bf16
``x`` with none, and an fp32 output and up to two bf16 ones. The source's note says what bounds them (the bytes)
and what their design does about it. Built by ``ops/cuda_build.py`` at the
first call, never at import.
"""

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import torch

from ..utils.metrics import metrics
from . import cuda_build

_launch_lock = threading.Lock()

WIDTHS = (2048, 2304, 3584, 512, 768)  # the widths the kernels are built for
THREADS = 256  # a block's threads, each holding 8 elements of a row


def add_rms_norm_reference(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                           eps: float, out: Sequence[torch.dtype]
                           ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The plain version: ``x_new = x + branch.float()`` (``x`` itself where
    ``branch`` is None) and the norm of ``x_new`` in fp32, cast to each dtype
    of ``out`` (one entry per consumer). Returns ``(x_new, ys)``."""
    if branch is not None:
        x = x + branch.float()
    h = x.float()
    y = weight * (h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps))
    return x, tuple(y.to(dt) for dt in out)


def add_rms_norm(x: torch.Tensor, branch: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float, out: Sequence[torch.dtype] = (torch.float32,)
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``add_rms_norm_reference``'s ``(x_new, ys)``: its plain version on a
    CPU tensor, the kernels on a CUDA one (``ValueError`` for what they do
    not take)."""
    if x.device.type == "cpu":
        return add_rms_norm_reference(x, branch, weight, eps, out)
    f32, n_bf16 = _check_kernel_inputs(x, branch, weight, out)
    res = list(_AddRMSNorm.apply(x, branch, weight, float(eps), f32, n_bf16))
    x_new = x if branch is None else res.pop(0)
    y32 = res.pop(0) if f32 else None
    return x_new, tuple(y32 if dt == torch.float32 else res.pop(0) for dt in out)


add_rms_norm.launches = 0


# ------------------------------------------------------------------ kernels


def _check_kernel_inputs(x, branch, weight, out) -> Tuple[bool, int]:
    """Raise ``ValueError`` for what the kernels do not take; whether an fp32
    y is asked for, and how many bf16 ones."""
    width = x.shape[-1] if x.dim() else 0
    if width not in WIDTHS:
        raise ValueError(f"the RMSNorm kernels take widths {WIDTHS}; got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the RMSNorm kernels take fp32 or bf16 x; got {x.dtype}")
    if branch is not None:
        if x.dtype != torch.float32 or branch.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the RMSNorm kernels add a bf16 or fp32 branch to fp32 x; got "
                             f"{branch.dtype} to {x.dtype}")
        if branch.shape != x.shape:
            raise ValueError(f"branch {tuple(branch.shape)} is not x's shape {tuple(x.shape)}")
    if weight.dtype != torch.float32 or tuple(weight.shape) != (width,):
        raise ValueError(f"weight must be fp32 ({width},); got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    out = tuple(out)
    if not out or any(dt not in (torch.float32, torch.bfloat16) for dt in out) \
            or out.count(torch.bfloat16) > 2:
        raise ValueError(f"the RMSNorm kernels write an fp32 y and up to two bf16 ones; "
                         f"asked for {out}")
    tensors = [t for t in (x, branch, weight) if t is not None]
    if any(t.device.type != "cuda" for t in tensors) or len({t.device for t in tensors}) > 1:
        raise ValueError("the RMSNorm kernels need CUDA tensors on one device; "
                         f"got {[str(t.device) for t in tensors]}")
    if x.numel() == 0:
        raise ValueError(f"the RMSNorm kernels need at least one row; got {tuple(x.shape)}")
    return torch.float32 in out, out.count(torch.bfloat16)


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between the rows of ``t`` taken as (rows, width), where
    its rows are contiguous, evenly spaced and 16-byte aligned (the kernels'
    16-byte accesses); else None."""
    width, sizes, strides = t.shape[-1], t.shape[:-1], t.stride()[:-1]
    if t.stride(-1) != 1:
        return None
    ld = strides[-1] if sizes else width
    for i in range(len(sizes) - 1):
        if sizes[i + 1] > 1 and strides[i] != strides[i + 1] * sizes[i + 1]:
            return None
    if ld < width or (ld * t.element_size()) % 16 or t.data_ptr() % 16:
        return None
    return ld


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load("rms_norm")
    fn = lib.rms_norm_launch
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                               ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.rms_norm_wave.argtypes = [ctypes.c_int] * 3
    lib.rms_norm_wave.restype = ctypes.c_int
    return fn, lib.rms_norm_wave


@functools.lru_cache(maxsize=None)
def _wave(device: int, width: int, x_bf16: bool, branch_bf16: bool) -> int:
    """Backward blocks that card ``device`` runs at once."""
    with torch.cuda.device(device):
        n = _kernel()[1](width, int(x_bf16), int(branch_bf16))
    if n < 1:
        raise RuntimeError(f"rms_norm occupancy query failed: CUDA error {-n}")
    return n


def _launch(kind: int, x, ldx, branch_dtype, weight, eps, branch=None, xnew=None, y32=None,
            yb=(), rstd=None, gxnew=None, gy32=None, gyb=(), dx=None, dbranch=None, partial=None,
            dw=None) -> None:
    """One forward (kind 0) or backward (1) of the kernels built for x's
    width and type and the branch's type (bf16 where there is none)."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    yb, gyb = list(yb) + [None] * (2 - len(yb)), list(gyb) + [None] * (2 - len(gyb))
    width = x.shape[-1]
    with torch.cuda.device(x.device):
        err = _kernel()[0](
            kind, width, int(x.dtype == torch.bfloat16),
            int(branch_dtype != torch.float32), ptr(x), ldx, ptr(branch),
            ptr(weight), ptr(xnew), ptr(y32), *map(ptr, yb), ptr(rstd), ptr(gxnew), ptr(gy32),
            *map(ptr, gyb), ptr(dx), ptr(dbranch), ptr(partial),
            0 if partial is None else partial.shape[0], ptr(dw), x.numel() // width, eps,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rms_norm kernel ({'backward' if kind else 'forward'}) launch failed: "
                           f"CUDA error {err}")


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, branch, weight, eps, f32, n_bf16):
        ldx = _row_stride(x)
        if ldx is None:
            x = x.contiguous()
            ldx = x.shape[-1]
        if branch is not None:
            branch = branch.contiguous()
        weight = weight.contiguous()
        empty = lambda dt: torch.empty(x.shape, dtype=dt, device=x.device)  # noqa: E731
        x_new = None if branch is None else empty(torch.float32)
        y32 = empty(torch.float32) if f32 else None
        yb = [empty(torch.bfloat16) for _ in range(n_bf16)]
        rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        branch_dtype = None if branch is None else branch.dtype
        _launch(0, x, ldx, branch_dtype, weight, eps, branch=branch, xnew=x_new, y32=y32, yb=yb,
                rstd=rstd)
        with _launch_lock:
            add_rms_norm.launches += 1
        metrics.count("norm.kernel_calls", 1)
        ctx.set_materialize_grads(False)
        if branch is None:
            ctx.save_for_backward(x, rstd, weight)
        else:  # the backward reads the row it normed, at x_new's stride
            ctx.save_for_backward(x_new, rstd, weight)
            ldx = x.shape[-1]
        ctx.ldx, ctx.eps, ctx.f32, ctx.n_bf16 = ldx, eps, f32, n_bf16
        ctx.branch_dtype = branch_dtype
        return tuple(t for t in (x_new, y32, *yb) if t is not None)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        saved, rstd, weight = ctx.saved_tensors
        grads = [None if g is None else g.contiguous() for g in grads]
        gxnew = None if ctx.branch_dtype is None else grads.pop(0)
        gy32 = grads.pop(0) if ctx.f32 else None
        width = saved.shape[-1]
        dx = torch.empty(saved.shape, dtype=saved.dtype, device=saved.device)
        dbranch = (None if ctx.branch_dtype is None else
                   torch.empty(saved.shape, dtype=ctx.branch_dtype, device=saved.device))
        rows = saved.numel() // width
        per_block = max(1, THREADS // (width // 8))  # a wider row takes a block of its own
        parts = min(-(-rows // per_block),
                    _wave(saved.device.index, width, saved.dtype == torch.bfloat16,
                          ctx.branch_dtype != torch.float32))
        partial = torch.empty((parts, width), dtype=torch.float32, device=saved.device)
        dw = torch.empty(width, dtype=torch.float32, device=saved.device)
        # the saved row stands in for x: x_new's type, at its stride
        _launch(1, saved, ctx.ldx, ctx.branch_dtype, weight, ctx.eps, rstd=rstd, gxnew=gxnew,
                gy32=gy32, gyb=grads, dx=dx, dbranch=dbranch, partial=partial, dw=dw)
        with _launch_lock:
            add_rms_norm.launches += 2
        return dx, dbranch, dw, None, None, None
