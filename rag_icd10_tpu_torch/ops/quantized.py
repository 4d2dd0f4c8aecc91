"""The one symmetric per-row int8 quantization law.

Counterpart of ``quantize_rows`` in rag_icd10_tpu/ops/quantized.py, which
every int8 consumer of the JAX package shares (int8 residency, the sketch
screen, the chunk-store build). The chunkstream certificate measures its
build-time residual against exactly this law, so both spellings here
agree with the JAX package's bit for bit: absmax / 127 per row, scale 1
for an all-zero row, round half to even, clip to +-127.

The int8 search paths (``int8_search``, the int8 residency tier) are not
ported yet.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def quantize_rows(x: Array) -> Tuple[Array, Array]:
    """Symmetric per-row int8 quantization: x ~= q * scale[:, None].

    A numpy array gives numpy (q int8, scale fp32); a tensor gives
    tensors on its device. Divisions are elementwise IEEE fp32 divisions
    in both spellings: on CUDA, PyTorch turns a division by a Python
    scalar into a multiplication by its reciprocal, which rounds
    differently, so the torch spelling divides by a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        absmax = x.abs().amax(dim=1)
        scale = torch.where(
            absmax > 0, absmax / torch.full_like(absmax, 127.0),
            torch.ones_like(absmax),
        )
        q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
        return q.to(torch.int8), scale
    x = np.asarray(x, np.float32)
    absmax = np.abs(x).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale
