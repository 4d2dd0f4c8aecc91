"""Certificate constants of the certified search methods.

Counterpart of the constants in rag_icd10_tpu/ops/rerank.py. Only what
the ``chunkstream`` method needs is here; ``chunk_select_search`` and
``bf16_rerank_search`` (the ``fast`` method) are not ported yet.

Each epsilon bounds |computed dot - exact dot| <= eps * ||q|| * ||c|| for
the arithmetic the port actually runs on Hopper, with u = 2^-24 the unit
roundoff of fp32 and d <= 1024:

- Any fp32 sum of d products, in any order, errs by at most about
  (d + 1) * u * sum|q_i c_i| <= (d + 1) * u * ||q|| * ||c|| (the standard
  bound; the sequential fmaf order of the port's kernels is one such
  order, cuBLAS's is another).
- bf16 round-to-nearest (``__float2bfloat16_rn``, ``Tensor.to(bfloat16)``)
  errs by at most 2^-9 relative per element.
"""

from __future__ import annotations

import torch

# One bf16 pass: q and c each rounded to bf16 (2 * 2^-9), the cross term
# (2^-18), and fp32 accumulation of d <= 1024 products ((d + 1) * u, about
# 6.1e-5; a tensor-core accumulator that truncates instead of rounding
# doubles that to 1.2e-4): 3.91e-3 + 1.2e-4 < 4.2e-3.
EPS_BF16_DOT = 4.2e-3

# The JAX package's Precision.HIGH scan (bf16x3) has no PyTorch spelling:
# torch.set_float32_matmul_precision("high") is single-pass TF32 on CUDA
# (relative error about 2^-11), far outside this bound. The port's
# "xla_high" chunkstream engine therefore runs IEEE fp32 (TF32 off). This
# is the JAX package's widening and the floor of ``eps_high_dot``.
EPS_HIGH_DOT = 8.0e-5


def eps_high_dot(d: int) -> float:
    """The ``xla_high`` widening for D = d, per unit of ||q|| * ||c||. Its
    pass 1 is an IEEE fp32 dot of the folded row, (d + 1) u away from the
    real value, and the exact re-score it is compared with is another fp32
    dot, (d + 1) u away again: 2 (d + 1) u in all (u = 2^-24), 9.2e-5 at
    d = 768, 1.83e-4 at d = 1536. Floored at EPS_HIGH_DOT, which covers it
    up to d = 670. A 3xTF32 pass (the ``fast`` method) will need its own
    term."""
    return max(EPS_HIGH_DOT, 2 * (d + 1) * 2.0 ** -24)


def bf16_scan_bound(
    q_norms: torch.Tensor, w_max: float, c_norm_max: float = 1.0
) -> torch.Tensor:
    """Per-query upper bound on |bf16 weighted score - exact weighted
    score| for any corpus row: w_max * eps * ||q|| * max||c||."""
    return (EPS_BF16_DOT * w_max * c_norm_max) * q_norms
