"""PyTorch token-classification NER model (model mode of MedicalNERService).

Counterpart of rag_icd10_tpu/pipeline/ner_model.py. The reference runs an
HF token-classification pipeline (lixin12345/chinese-medical-ner) with
aggregation_strategy="simple" (reference: services/medical_ner_service.py
:68-101, :177-229). Here the same architecture — the port's BERT encoder
(models/bert.py ``BertEncoder``, per-token hidden states) + an fp32
per-token linear head — runs in PyTorch over converted weights.

Weight source: a directory holding ``params.npz`` + ``config.json`` +
``vocab.txt``, written by ``tools/convert_weights.py --ner`` (from a local
HF checkpoint) or by the JAX package's tools; both packages read the same
files. Without weights the service falls back to rule mode upstream.

``predict`` keeps the JAX package's host code as it stands (character
tokens with source offsets, the caps at ``max_position_embeddings``,
power-of-two padding, HF "simple" aggregation: argmax per token, strip
B-/I- prefixes, merge adjacent tokens sharing an entity label, score =
mean softmax probability over the span); only the forward pass and the
softmax are PyTorch. flax ``nn.Embed`` clamps an out-of-range id
silently, where ``nn.Embedding`` raises (a device-side assert on CUDA):
both position caps stay, and a vocabulary larger than the embedding table
is refused at load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.bert import BertArch, BertEncoder
from ..models.convert_hf import (
    arch_from_config,
    convert_state_dict,
    load_params,
    load_torch_state_dict,
    params_from_jax,
    save_params,
)
from ..models.tokenizer import WordPieceTokenizer, basic_tokenize
from ..utils.device import resolve_device


class TokenClassifier(nn.Module):
    """BERT token-level hidden states (fp32) + an fp32 linear head ->
    per-token logits. Parameter names follow ``params_from_jax`` (``bert.*``,
    ``classifier.*``)."""

    def __init__(self, arch: BertArch, num_labels: int):
        super().__init__()
        self.arch = arch
        self.bert = BertEncoder(arch)
        self.classifier = nn.Linear(arch.hidden_size, num_labels, dtype=torch.float32)

    def forward(self, input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        return self.classifier(self.bert(input_ids, attention_mask, token_type_ids))


def build_token_classifier(arch: BertArch, num_labels: int) -> TokenClassifier:
    """The BERT + per-token linear head module (the JAX package's single
    definition shared by inference and training)."""
    return TokenClassifier(arch, num_labels)


class TorchTokenClassifier:
    """BERT + token-classification head with span aggregation. Runs on
    ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        arch: BertArch,
        params: Dict,
        id2label: Dict[int, str],
        tokenizer: WordPieceTokenizer = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.arch = arch
        self.id2label = {int(k): v for k, v in id2label.items()}
        self.tokenizer = tokenizer
        if tokenizer is not None and tokenizer.vocab_size > arch.vocab_size:
            raise ValueError(
                f"vocab.txt holds {tokenizer.vocab_size} tokens, the embedding "
                f"table {arch.vocab_size}: ids past the table cannot be looked up"
            )
        with torch.device(self.device):
            self.model = build_token_classifier(arch, num_labels=len(self.id2label))
        self.model.load_state_dict(params_from_jax(params))
        self.model.eval()
        self.forwards = 0  # forward passes run (one per predict with tokens)

    # ------------------------------------------------------------ loading

    @classmethod
    def from_weights(
        cls,
        weights_dir: str,
        device: Union[str, torch.device] = "cuda",
        compute_dtype=torch.bfloat16,
    ) -> "TorchTokenClassifier":
        """Load from a converted checkpoint dir: params.npz + config.json +
        vocab.txt (produced by tools/convert_weights.py --ner). Dense layers
        run in ``compute_dtype``, bf16 as in the JAX package."""
        d = Path(weights_dir)
        config = json.loads((d / "config.json").read_text())
        arch = arch_from_config(config, compute_dtype)
        params = load_params(str(d / "params.npz"))
        tokenizer = WordPieceTokenizer.from_vocab_file(str(d / "vocab.txt"))
        return cls(arch, params, config["id2label"], tokenizer, device=device)

    # ---------------------------------------------------------- inference

    def encode(self, text: str, max_length: int = 512):
        """text -> (tokens, offsets, ids (1, pad), mask (1, pad)) as int32
        arrays: per-CHARACTER WordPiece tokens with their source offsets,
        [CLS] ... [SEP], padded to a power of two; None when the text has
        no tokens."""
        # never index positions the checkpoint wasn't trained for:
        # nn.Embedding would raise (a device-side assert on CUDA)
        max_length = min(max_length, self.arch.max_position_embeddings)
        tokens: List[str] = []
        offsets: List[Tuple[int, int]] = []
        pos = 0
        for tok in basic_tokenize(text):
            for piece in self.tokenizer.wordpiece(tok):
                raw = piece[2:] if piece.startswith("##") else piece
                start = text.find(raw, pos) if raw != "[UNK]" else pos
                if start < 0:
                    start = pos
                tokens.append(piece)
                offsets.append((start, start + max(len(raw), 1)))
                pos = start + len(raw) if raw != "[UNK]" else pos + 1
        if not tokens:
            return None
        tokens = tokens[: max_length - 2]
        offsets = offsets[: max_length - 2]
        ids = (
            [self.tokenizer.cls_id]
            + [self.tokenizer.vocab.get(t, self.tokenizer.unk_id) for t in tokens]
            + [self.tokenizer.sep_id]
        )
        seq = len(ids)
        pad_to = 1
        while pad_to < seq:
            pad_to *= 2
        # pow2 padding must not exceed the trained position table either
        pad_to = min(pad_to, self.arch.max_position_embeddings)
        arr = np.full((1, pad_to), self.tokenizer.pad_id, dtype=np.int32)
        arr[0, :seq] = ids
        mask = np.zeros((1, pad_to), dtype=np.int32)
        mask[0, :seq] = 1
        return tokens, offsets, arr, mask

    @torch.inference_mode()
    def probabilities(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(B, S) int ids and mask -> (B, S, labels) fp32 softmax
        probabilities on the host (token types 0)."""

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a)).to(self.device, torch.long)

        ids_t = dev(ids)
        logits = self.model(ids_t, dev(mask), torch.zeros_like(ids_t))
        self.forwards += 1
        return torch.softmax(logits, dim=-1).cpu().numpy()

    def predict(
        self, text: str, max_length: int = 512
    ) -> List[Tuple[str, str, float, int, int]]:
        """-> [(span_text, label, score, start, end)] using HF 'simple'
        aggregation over per-CHARACTER tokens (Chinese WordPiece)."""
        if not text or self.tokenizer is None:
            return []
        encoded = self.encode(text, max_length)
        if encoded is None:
            return []
        tokens, offsets, arr, mask = encoded
        probs = self.probabilities(arr, mask)
        probs = probs[0, 1 : 1 + len(tokens)]  # strip CLS, PAD, SEP

        label_ids = probs.argmax(axis=-1)
        scores = probs.max(axis=-1)

        # 'simple' aggregation: merge adjacent tokens with same entity label
        spans: List[Tuple[str, str, float, int, int]] = []
        cur_label, cur_start, cur_end, cur_scores = None, 0, 0, []
        for i, (lid, sc) in enumerate(zip(label_ids, scores)):
            raw = self.id2label.get(int(lid), "O")
            entity = raw.split("-", 1)[-1] if raw != "O" else None
            begins = raw.startswith("B-")
            if entity is None:
                if cur_label is not None:
                    spans.append(
                        (
                            text[cur_start:cur_end],
                            cur_label,
                            float(np.mean(cur_scores)),
                            cur_start,
                            cur_end,
                        )
                    )
                    cur_label = None
                continue
            if cur_label == entity and not begins:
                cur_end = offsets[i][1]
                cur_scores.append(sc)
            else:
                if cur_label is not None:
                    spans.append(
                        (
                            text[cur_start:cur_end],
                            cur_label,
                            float(np.mean(cur_scores)),
                            cur_start,
                            cur_end,
                        )
                    )
                cur_label = entity
                cur_start, cur_end = offsets[i]
                cur_scores = [sc]
        if cur_label is not None:
            spans.append(
                (
                    text[cur_start:cur_end],
                    cur_label,
                    float(np.mean(cur_scores)),
                    cur_start,
                    cur_end,
                )
            )
        return spans


def convert_hf_token_classifier(model_dir: str, out_dir: str) -> None:
    """Convert an HF BertForTokenClassification checkpoint directory into
    the weights format (params.npz + config.json + vocab.txt)."""
    import shutil

    d, out = Path(model_dir), Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    config = json.loads((d / "config.json").read_text())
    sd = load_torch_state_dict(str(d))
    params = convert_state_dict(sd, arch_from_config(config))
    if "classifier.weight" not in sd:
        raise ValueError("no classifier head found in state dict")
    params["classifier"] = {
        "kernel": np.asarray(sd["classifier.weight"], dtype=np.float32).T,
        "bias": np.asarray(sd["classifier.bias"], dtype=np.float32),
    }
    save_params(params, str(out / "params.npz"))
    (out / "config.json").write_text(json.dumps(config))
    shutil.copy(d / "vocab.txt", out / "vocab.txt")
