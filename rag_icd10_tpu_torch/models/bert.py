"""BERT-base sentence encoder as PyTorch modules.

Counterpart of rag_icd10_tpu/models/bert.py, numerically the same recipe:
a post-LayerNorm BERT (text2vec-base-chinese: 12 layers, 768 hidden, 12
heads) with masked mean pooling and L2 normalization on top
(reference: services/embedding_service.py:47-104).

- Dense layers run in ``compute_dtype`` (bf16 by default): inputs and
  weights in that dtype, fp32 accumulation inside the matmul. Their
  weights are stored in ``param_dtype``: by default the compute dtype
  (serving), fp32 for training (flax's ``param_dtype=float32``), where
  ``forward`` casts them to the compute dtype, so that the optimizer
  updates fp32 master weights (AdamW on bf16 weights would drop every
  update below about 2^-8 of a weight).
- Attention logits are computed from the compute-dtype q and k widened to
  fp32 (bf16 x bf16 products are exact in fp32), so they carry the JAX
  einsum's ``preferred_element_type=float32``; softmax is fp32, and the
  probabilities return to the compute dtype for the value product.
- LayerNorm (eps 1e-12), exact erf GELU, pooling and the final L2
  normalize run in fp32.
- Padding never contributes: the attention mask becomes an additive bias
  of ``finfo(float32).min``.

The forward is plain PyTorch (the JAX package leaves it to XLA): no
hand-written kernel is involved here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BertArch:
    vocab_size: int = 21128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: Optional[torch.dtype] = None  # Dense weights; None: compute_dtype

    @property
    def dense_param_dtype(self) -> torch.dtype:
        return self.param_dtype or self.compute_dtype


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``arch.compute_dtype`` with weights stored
    in ``arch.dense_param_dtype``; inputs, weights and bias are cast to the
    compute dtype (flax ``Dense(dtype=compute_dtype,
    param_dtype=...)``). Where the two dtypes agree the casts are no-ops."""

    def __init__(self, n_in: int, n_out: int, arch: BertArch):
        super().__init__(n_in, n_out, dtype=arch.dense_param_dtype)
        self.compute_dtype = arch.compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BertSelfAttention(nn.Module):
    def __init__(self, arch: BertArch):
        super().__init__()
        self.arch = arch
        h = arch.hidden_size
        self.query = Dense(h, h, arch)
        self.key = Dense(h, h, arch)
        self.value = Dense(h, h, arch)
        self.out = Dense(h, h, arch)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        a = self.arch
        head_dim = a.hidden_size // a.num_heads
        b, s, _ = hidden.shape

        def split(x):  # (B, S, H) -> (B, heads, S, head_dim)
            return x.view(b, s, a.num_heads, head_dim).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(head_dim)
        scores = scores + attn_bias  # (B, 1, 1, S) additive mask
        probs = torch.softmax(scores, dim=-1).to(a.compute_dtype)
        ctx = torch.matmul(probs, v)
        ctx = ctx.transpose(1, 2).reshape(b, s, a.hidden_size)
        return self.out(ctx)


class BertLayer(nn.Module):
    def __init__(self, arch: BertArch):
        super().__init__()
        h, eps = arch.hidden_size, arch.layer_norm_eps
        self.attention = BertSelfAttention(arch)
        self.attention_ln = nn.LayerNorm(h, eps=eps)
        self.intermediate = Dense(h, arch.intermediate_size, arch)
        self.output = Dense(arch.intermediate_size, h, arch)
        self.output_ln = nn.LayerNorm(h, eps=eps)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        attn_out = self.attention(hidden, attn_bias)
        hidden = self.attention_ln(hidden + attn_out.float())
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        out = self.output(inter)
        return self.output_ln(hidden + out.float())


class BertEncoder(nn.Module):
    """Token ids -> token-level hidden states (fp32)."""

    def __init__(self, arch: BertArch):
        super().__init__()
        h = arch.hidden_size
        self.word_embeddings = nn.Embedding(arch.vocab_size, h)
        self.position_embeddings = nn.Embedding(arch.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(arch.type_vocab_size, h)
        self.embeddings_ln = nn.LayerNorm(h, eps=arch.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(arch) for _ in range(arch.num_layers))

    def forward(self, input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        s = input_ids.shape[1]
        pos_ids = torch.arange(s, device=input_ids.device)[None, :]
        hidden = self.embeddings_ln(
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        attn_bias = (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min
        attn_bias = attn_bias[:, None, None, :]
        for layer in self.layers:
            hidden = layer(hidden, attn_bias)
        return hidden.float()


class SentenceBert(nn.Module):
    """BERT + masked mean pooling + L2 normalize -> sentence embeddings."""

    def __init__(self, arch: BertArch):
        super().__init__()
        self.arch = arch
        self.bert = BertEncoder(arch)

    def forward(self, input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        hidden = self.bert(input_ids, attention_mask, token_type_ids)
        mask = attention_mask.float()[:, :, None]
        summed = torch.sum(hidden * mask, dim=1)
        counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
        mean = summed / counts
        norm = torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), min=1e-12)
        return mean / norm


def init_params(arch: BertArch, seed: int = 0) -> Dict:
    """Deterministic random init (used when no converted weights exist),
    made with numpy and returned in the JAX package's parameter-tree
    layout, so it loads through ``convert_hf.params_from_jax`` and saves
    with ``convert_hf.save_params`` like converted weights. Dense kernels
    are (in, out) with std 1/sqrt(in), embeddings std 1/sqrt(hidden),
    LayerNorm scale 1 and every bias 0."""
    rng = np.random.default_rng(seed)
    h, inter = arch.hidden_size, arch.intermediate_size

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), 1.0 / math.sqrt(n_in)),
                "bias": np.zeros((n_out,), np.float32)}

    def ln():
        return {"scale": np.ones((h,), np.float32), "bias": np.zeros((h,), np.float32)}

    emb_std = 1.0 / math.sqrt(h)
    bert: Dict = {
        "word_embeddings": {"embedding": normal((arch.vocab_size, h), emb_std)},
        "position_embeddings": {
            "embedding": normal((arch.max_position_embeddings, h), emb_std)
        },
        "token_type_embeddings": {"embedding": normal((arch.type_vocab_size, h), emb_std)},
        "embeddings_ln": ln(),
    }
    for i in range(arch.num_layers):
        bert[f"layer_{i}"] = {
            "attention": {name: dense(h, h) for name in ("query", "key", "value", "out")},
            "attention_ln": ln(),
            "intermediate": dense(h, inter),
            "output": dense(inter, h),
            "output_ln": ln(),
        }
    return {"bert": bert}
