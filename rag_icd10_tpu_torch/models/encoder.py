"""Batched sentence encoder — the EmbeddingService replacement.

Counterpart of rag_icd10_tpu/models/encoder.py with the same surface
(reference: services/embedding_service.py:75-149): ``encode_single``,
``encode_batch``, ``encode_query``, ``encode_icd_record``,
``get_model_info``, ``test_embedding`` — L2-normalized vectors; E5-style
"query: "/"passage: " prefixes only for e5-family models; 512-token cap.

- Texts are tokenized to (rows, seq) shapes from the same small bucket
  grid as the JAX package (rows -> power of two, seq -> length bucket),
  so both packages see the same padded batches.
- One forward encodes a whole batch; weights live on the device once.
- ``encode_queries_device`` returns the embeddings as a tensor on the
  encoder's device, which ``VectorStore.search_dispatch`` takes without a
  host round trip (the serving hot path).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import EncoderConfig
from ..utils.device import resolve_device
from .bert import BertArch, SentenceBert, init_params
from .convert_hf import load_params, params_from_jax
from .tokenizer import WordPieceTokenizer


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class TextEncoder:
    """PyTorch BERT sentence encoder with length/batch bucketing.

    ``params`` is a parameter tree in the JAX package's layout (see
    ``convert_hf``); without it the weights come from
    ``config.weights_path`` or a seeded random init. Runs on ``cuda``
    unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        tokenizer: Optional[WordPieceTokenizer] = None,
        params: Optional[Dict] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or EncoderConfig()
        cfg = self.config

        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif cfg.vocab_path:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(cfg.vocab_path)
        else:
            # corpus-independent deterministic fallback: built lazily from
            # first encodes would break determinism, so default to a vocab
            # over the configured corpus when available.
            from ..config import get_config
            from ..data.corpus import load_corpus

            corpus = load_corpus(get_config().data_path)
            self.tokenizer = WordPieceTokenizer.from_corpus(
                corpus.titles + corpus.semantic_texts
            )

        self.arch = BertArch(
            vocab_size=max(cfg.vocab_size, self.tokenizer.vocab_size),
            hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers,
            num_heads=cfg.num_heads,
            intermediate_size=cfg.intermediate_size,
            max_position_embeddings=cfg.max_position_embeddings,
            type_vocab_size=cfg.type_vocab_size,
            layer_norm_eps=cfg.layer_norm_eps,
            compute_dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        )
        if params is None:
            params = (
                load_params(cfg.weights_path)
                if cfg.weights_path
                else init_params(self.arch, seed=seed)
            )
        with torch.device(self.device):
            self.model = SentenceBert(self.arch)
        self.model.load_state_dict(params_from_jax(params))
        self.model.eval()
        self._num_encodes = 0

    # ----------------------------------------------------------- internals

    def _prefixed(self, texts: Sequence[str], kind: str) -> List[str]:
        """E5 prefixes only for e5-family models (reference:
        embedding_service.py:68-73,117-120); text2vec ignores prefixes."""
        if not self.config.is_e5:
            return list(texts)
        prefix = (
            self.config.query_prefix if kind == "query" else self.config.passage_prefix
        )
        return [t if t.startswith(prefix) else prefix + t for t in texts]

    @torch.inference_mode()
    def _forward(self, texts: Sequence[str]) -> torch.Tensor:
        """(len(texts), dim) fp32 embeddings on the encoder's device."""
        cfg = self.config
        ids, mask, types = self.tokenizer.encode_batch(
            texts,
            max_length=cfg.max_length,
            buckets=cfg.length_buckets,
            pad_batch_to=_next_pow2(len(texts)),
        )

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device, torch.long)

        out = self.model(dev(ids), dev(mask), dev(types))
        self._num_encodes += len(texts)
        return out[: len(texts)].float()

    # ------------------------------------------------------------- public

    @property
    def dim(self) -> int:
        return self.config.hidden_size

    def encode_batch_device(
        self,
        texts: Sequence[str],
        kind: str = "query",
        batch_size: Optional[int] = None,
    ) -> torch.Tensor:
        """Encode many texts -> (n, dim) fp32 tensor on the encoder's
        device, L2-normalized. ``batch_size`` bounds a single forward
        (default 256 — the reference uses 32, embedding_service.py:27)."""
        if len(texts) == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        texts = self._prefixed(texts, kind)
        step = batch_size or 256
        outs = [self._forward(texts[i : i + step]) for i in range(0, len(texts), step)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def encode_batch(
        self, texts: Sequence[str], kind: str = "passage", batch_size: Optional[int] = None
    ) -> np.ndarray:
        """Like ``encode_batch_device`` but returns a host (n, dim) float32
        array."""
        return self.encode_batch_device(texts, kind, batch_size).cpu().numpy()

    def encode_queries_device(self, texts: Sequence[str]) -> torch.Tensor:
        return self.encode_batch_device(texts, kind="query")

    def encode_single(self, text: str) -> np.ndarray:
        return self.encode_batch([text], kind="passage")[0]

    def encode_query(self, text: str) -> np.ndarray:
        return self.encode_batch([text], kind="query")[0]

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode_batch(texts, kind="query")

    def encode_icd_record(self, record) -> np.ndarray:
        """Embed an ICD record's preferred_zh title (reference:
        embedding_service.py:106-115)."""
        title = record.preferred_zh if hasattr(record, "preferred_zh") else str(record)
        return self.encode_batch([title], kind="passage")[0]

    def get_model_info(self) -> Dict:
        device = str(self.device)
        if self.device.type == "cuda":
            device = f"{device} ({torch.cuda.get_device_name(self.device)})"
        return {
            "model_name": self.config.model_name,
            "embedding_dimension": self.dim,
            "max_seq_length": self.config.max_length,
            "device": device,
            "dtype": self.config.dtype,
            "vocab_size": self.tokenizer.vocab_size,
            "num_layers": self.arch.num_layers,
            "texts_encoded": self._num_encodes,
        }

    def test_embedding(self) -> bool:
        """Runtime self-check (reference: embedding_service.py:135-149)."""
        try:
            vec = self.encode_single("测试文本")
            return vec.shape == (self.dim,) and bool(
                np.isfinite(vec).all() and abs(np.linalg.norm(vec) - 1.0) < 1e-3
            )
        except Exception:
            return False
