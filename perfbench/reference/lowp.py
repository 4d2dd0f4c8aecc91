"""Rounding to the precision below the configuration's own (bf16), for the
control: the reference with its matrix-product inputs rounded to fp8."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn


class _Rounded(torch.autograd.Function):
    """The rounded value forward, the gradient passed straight through:
    a product's inputs are rounded, and nothing more is kept for the
    backward than the product keeps."""

    @staticmethod
    def forward(ctx, x, fn):
        with torch.no_grad():
            return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> float8 e4m3 with one per-tensor scale -> fp32."""
    return _Rounded.apply(x, _fp8)
