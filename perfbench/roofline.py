"""Peaks of the card and the operations and bytes of the cells' work.

Counted from the inputs (each text's non-padding tokens under the frozen
tokenizer), never from shapes the program chose, so that they read the
same work whatever computes it.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit:
989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor
cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Dict, Sequence

H100_SXM = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def encoder_flops(token_counts: Sequence[int], cfg: Dict) -> float:
    """Forward FLOPs of BERT over texts of ``token_counts`` non-padding
    tokens ([CLS] and [SEP] included): per token and layer the four
    attention projections and the two FFN products, and per (query, key)
    pair the score and value products."""
    h, inter, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    per_token = 2 * (4 * h * h + 2 * h * inter)
    return float(sum(layers * (n * per_token + 4 * n * n * h) for n in token_counts))


def train_step_flops(a_tokens: Sequence[int], b_tokens: Sequence[int],
                     h_tokens: Sequence[int], cfg: Dict) -> float:
    """One triplet step: three times the forward of anchors, positives and
    hard negatives (forward and backward), and the loss's two (B, B)
    similarity products, also three times."""
    fwd = sum(encoder_flops(t, cfg) for t in (a_tokens, b_tokens, h_tokens))
    rows = len(a_tokens)
    loss = 2 * 2.0 * rows * rows * cfg["hidden_size"]
    return 3.0 * (fwd + loss)
