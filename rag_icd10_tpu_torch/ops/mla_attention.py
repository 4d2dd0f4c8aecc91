"""The attention core of multi-head latent attention (models/deepseek_v3.py
``LatentAttention``): from the projections' outputs to the context that
``o_proj`` reads. RoPE on the rope dimensions, logits over the nope and
rope dimensions, the causal mask, the softmax and the product with v.

- ``mla_attention_reference``: the plain PyTorch version, the model's
  original inline code. The CPU path, and what the kernels are held against.
- ``mla_attention``: on a CPU tensor the plain version; on a CUDA tensor
  the hand-written kernels of ``csrc/mla_attention.cu`` (``mla_attn_fwd``,
  ``mla_attn_bwd_dq``, ``mla_attn_bwd_dkv``), bound as a
  ``torch.autograd.Function``, or a ``ValueError`` for what they do not
  take. ``mla_attention.launches`` counts kernel launches (one a forward,
  two a backward), and every forward call adds 1 to the counter
  ``mla.kernel_calls`` (utils/metrics.py).

The kernels replace no kernel of the JAX package, which has no MLA; the
source's note says what bounds them (the bytes: 0.14 ms a forward call at
the Moonlight cell's shapes, against 0.01 ms of bf16 tensor-core time) and
what their design does about it: each input read once a block in place
through its strides, the rope pairs rotated in shared memory, every S x S
tile kept in registers, tensor-core products with fp32 sums, and every
rounding point of the plain chain kept (P normalised before its one bf16
rounding; delta from fp32 P and dP; dS's products as a bf16 hi/lo pair).
They take Moonlight's widths (128 nope + 64 rope, v 128) in bf16, and in
fp32 (IEEE products, for the tests' fp32 model). The forward's block holds
48 or 96 queries and its key block as many keys (``key_block``): at S <= 96
(the main path) one block reads a (batch, head) once and its second pass
over the keys reuses the first's logits in registers; past 96 both passes
walk 96-key blocks and the logits are computed twice. Built by
``ops/cuda_build.py`` at the first call, never at import.
"""

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

from ..utils.metrics import metrics
from . import cuda_build

_launch_lock = threading.Lock()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on (..., seq, dim) with interleaved pairs: (x[2i], x[2i+1])
    are de-interleaved into the halves, then rotated by rotate_half."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def _dims(q: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor,
          heads: int) -> Tuple[int, int, int]:
    """(nope, rope, v) head dimensions of q (B, S, heads x (nope + rope)),
    kv (B, S, heads x (nope + v)) and k_pe (B, S, rope)."""
    rope = k_pe.shape[-1]
    if q.shape[-1] % heads or kv.shape[-1] % heads:
        raise ValueError(f"q {tuple(q.shape)} or kv {tuple(kv.shape)} is not {heads} heads wide")
    nope = q.shape[-1] // heads - rope
    vd = kv.shape[-1] // heads - nope
    if nope <= 0 or vd <= 0 or rope % 2 or q.shape[:2] != kv.shape[:2] \
            or q.shape[:2] != k_pe.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, kv {tuple(kv.shape)} and k_pe "
                         f"{tuple(k_pe.shape)} are no MLA layout of {heads} heads")
    return nope, rope, vd


def mla_attention_reference(q: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor, heads: int,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: q (B, S, heads x (nope + rope)), kv (B, S, heads x
    (nope + v)) and k_pe (B, S, rope), all in the compute type; cos and sin
    (S, rope) fp32 (``rope_tables``); the softmax scale ``scale``, where it
    is not (nope + rope)^-1/2. Returns the context (B, S, heads x v)."""
    b, s, _ = q.shape
    nh = heads
    nope, rope, vd = _dims(q, kv, k_pe, heads)
    dt = q.dtype
    causal = torch.full((s, s), torch.finfo(torch.float32).min, device=q.device).triu(1)
    q = q.view(b, s, nh, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    kv = kv.view(b, s, nh, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = apply_rope(q_pe.float(), cos, sin).to(dt)
    k_pe = apply_rope(k_pe.float()[:, None], cos, sin).to(dt)  # one k_pe for every head
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, nh, s, rope)], dim=-1)
    # bf16 x bf16 products are exact in fp32: the logits carry fp32 accumulation
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(nope + rope) if scale is None else scores * scale
    probs = torch.softmax(scores + causal, dim=-1).to(dt)
    ctx = torch.matmul(probs, v)  # (B, heads, S, v)
    return ctx.transpose(1, 2).reshape(b, s, nh * vd)


def mla_attention(q: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, heads: int,
                  scale: Optional[float] = None) -> torch.Tensor:
    """The context (B, S, heads x v) of ``mla_attention_reference``'s
    inputs: its plain version on a CPU tensor, the kernels on a CUDA one
    (``ValueError`` for what they do not take). The kernels take the scale
    as a launch argument."""
    if q.device.type == "cpu":
        return mla_attention_reference(q, kv, k_pe, cos, sin, heads, scale)
    return _MLAAttention.apply(q, kv, k_pe, cos, sin, heads,
                               (NOPE + ROPE) ** -0.5 if scale is None else scale)


mla_attention.launches = 0


# ------------------------------------------------------------------ kernels

NOPE, ROPE, VD = 128, 64, 128  # the widths the kernels are built for
_KINDS = {"fwd": 0, "dq": 1, "dkv": 2}


def key_block(s: int) -> int:
    """The forward's query and key block at sequence length ``s``: the
    smallest of 48 and 96 that holds every key (one load of the keys, their
    logits computed once), 96 past that."""
    return 48 if s <= 48 else 96


def _check_kernel_inputs(q, kv, k_pe, cos, sin, heads) -> Tuple[int, int, int]:
    """Raise ``ValueError`` for what the kernels do not take; the dims."""
    if q.dtype not in (torch.bfloat16, torch.float32) or kv.dtype != q.dtype \
            or k_pe.dtype != q.dtype:
        raise ValueError(f"the MLA kernels take bf16 or fp32 q, kv, k_pe; got "
                         f"{q.dtype}, {kv.dtype}, {k_pe.dtype}")
    nope, rope, vd = _dims(q, kv, k_pe, heads)
    if (nope, rope, vd) != (NOPE, ROPE, VD):
        raise ValueError(f"the MLA kernels take nope {NOPE}, rope {ROPE}, v {VD}; got "
                         f"nope {nope}, rope {rope}, v {vd}")
    s = q.shape[1]
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] < s or t.shape[1] < rope // 2:
            raise ValueError(f"cos and sin must be fp32 (S, rope) tables; got "
                             f"{t.dtype} {tuple(t.shape)} for S = {s}")
    tensors = (q, kv, k_pe, cos, sin)
    if any(t.device.type != "cuda" for t in tensors) or len({t.device for t in tensors}) > 1:
        raise ValueError("the MLA kernels need CUDA tensors on one device; "
                         f"got {[str(t.device) for t in tensors]}")
    return nope, rope, vd


def _aligned(t: torch.Tensor, *strides: int) -> bool:
    """16-byte aligned data and strides (the kernels' 16-byte loads)."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % per == 0 for st in strides)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.load("mla_attention").mla_attn_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(kind: str, q, kv, k_pe, cos, sin, heads, scale, d_out=None, out=None, lse=None,
            delta=None, dq=None, dkv=None, dkpe=None) -> None:
    b, s, _ = q.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = _kernel()(
            _KINDS[kind], int(q.dtype == torch.float32), key_block(s),
            *(ptr(t) for t in (q, kv, k_pe, cos, sin, d_out, out, lse, delta, dq, dkv, dkpe)),
            b, s, heads, k_pe.stride(0), k_pe.stride(1), cos.stride(0), scale,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mla_attention kernel ({kind}) launch failed: CUDA error {err}")


class _MLAAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, k_pe, cos, sin, heads, scale):
        vd = _check_kernel_inputs(q, kv, k_pe, cos, sin, heads)[2]
        q, kv = q.contiguous(), kv.contiguous()
        cos, sin = cos.contiguous(), sin.contiguous()
        if k_pe.stride(-1) != 1 or not _aligned(k_pe, k_pe.stride(0), k_pe.stride(1)):
            k_pe = k_pe.contiguous()
        b, s, _ = q.shape
        out = torch.empty((b, s, heads * vd), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * heads, s), dtype=torch.float32, device=q.device)
        _launch("fwd", q, kv, k_pe, cos, sin, heads, scale, out=out, lse=lse)
        with _launch_lock:
            mla_attention.launches += 1
        metrics.count("mla.kernel_calls", 1)
        ctx.save_for_backward(q, kv, k_pe, cos, sin, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        q, kv, k_pe, cos, sin, lse = ctx.saved_tensors
        heads = ctx.heads
        d_out = d_out.contiguous()
        b, s, _ = q.shape
        dq, dkv = torch.empty_like(q), torch.empty_like(kv)
        dkpe = torch.empty((b, s, heads, ROPE), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse)
        args = (q, kv, k_pe, cos, sin, heads, ctx.scale)
        _launch("dq", *args, d_out=d_out, lse=lse, delta=delta, dq=dq)
        _launch("dkv", *args, d_out=d_out, lse=lse, delta=delta, dkv=dkv, dkpe=dkpe)
        with _launch_lock:
            mla_attention.launches += 2
        return dq, dkv, dkpe.sum(2).to(k_pe.dtype), None, None, None, None
