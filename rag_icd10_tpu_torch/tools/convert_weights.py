"""Convert HF checkpoints into the weights format both packages read.

Encoder (sentence embedder):
    python -m rag_icd10_tpu_torch.tools.convert_weights \
        --model-dir /path/to/text2vec-base-chinese --out db/encoder
    -> writes db/encoder/params.npz + vocab.txt; point
       EMBEDDING_WEIGHTS_PATH / EMBEDDING_VOCAB_PATH at them.

Token-classification NER model:
    python -m rag_icd10_tpu_torch.tools.convert_weights \
        --model-dir /path/to/chinese-medical-ner --out db/ner --ner
    -> writes params.npz + config.json + vocab.txt; point
       NER_WEIGHTS_PATH at the directory.

Works entirely offline from a local directory holding pytorch_model.bin /
model.safetensors + config.json + vocab.txt (the reference downloads these
at runtime through sentence-transformers/HF hub,
services/embedding_service.py:47-66). Counterpart of
rag_icd10_tpu/tools/convert_weights.py; ``--verify`` runs the converted
encoder on ``--device`` (cuda unless "cpu" is passed).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path


def convert_encoder(model_dir: str, out_dir: str) -> None:
    from ..models.convert_hf import arch_from_config, convert_model_dir, save_params

    d, out = Path(model_dir), Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    config = json.loads((d / "config.json").read_text())
    params = convert_model_dir(str(d), arch_from_config(config))
    save_params(params, str(out / "params.npz"))
    shutil.copy(d / "vocab.txt", out / "vocab.txt")
    (out / "config.json").write_text(json.dumps(config))
    print(f"encoder converted -> {out}/params.npz")
    print(f"export EMBEDDING_WEIGHTS_PATH={out}/params.npz")
    print(f"export EMBEDDING_VOCAB_PATH={out}/vocab.txt")


VERIFY_TEXTS = (
    "急性胃肠炎",
    "高血压病3级，2型糖尿病",
    "疑似急性心肌梗死",
    "慢性阻塞性肺疾病急性加重期伴呼吸衰竭",
)


def verify_encoder_parity(
    model_dir: str,
    out_dir: str,
    texts=VERIFY_TEXTS,
    min_cos: float = 0.999,
    device: str = "cuda",
) -> float:
    """End-to-end parity proof: run the HF torch model (tokenize ->
    forward -> mean-pool -> L2-normalize, exactly the reference's
    sentence-transformers path, embedding_service.py:75-104) and OUR
    converted encoder (own WordPiece tokenizer + forward, fp32) on the
    same texts; require cosine >= ``min_cos`` per text.

    Covers the full chain including tokenization, so pointing it at a
    real text2vec-base-chinese directory proves drop-in parity."""
    import numpy as np
    import torch
    import transformers

    from ..config import EncoderConfig
    from ..models.encoder import TextEncoder
    from ..models.tokenizer import WordPieceTokenizer

    d, out = Path(model_dir), Path(out_dir)
    config = json.loads((d / "config.json").read_text())

    hf_tok = transformers.BertTokenizerFast(str(d / "vocab.txt"))
    hf_model = transformers.BertModel.from_pretrained(str(d)).eval()
    enc_batch = hf_tok(
        list(texts), padding=True, truncation=True, max_length=512,
        return_tensors="pt",
    )
    with torch.no_grad():
        hidden = hf_model(**enc_batch).last_hidden_state.numpy()
    m = enc_batch["attention_mask"].numpy()[:, :, None].astype(np.float32)
    pooled = (hidden * m).sum(1) / m.sum(1)
    hf_sent = pooled / np.linalg.norm(pooled, axis=1, keepdims=True)

    cfg = EncoderConfig(
        model_name="converted",
        hidden_size=config.get("hidden_size", 768),
        num_layers=config.get("num_hidden_layers", 12),
        num_heads=config.get("num_attention_heads", 12),
        intermediate_size=config.get("intermediate_size", 3072),
        vocab_size=config.get("vocab_size", 21128),
        max_position_embeddings=config.get("max_position_embeddings", 512),
        dtype="float32",
        weights_path=str(out / "params.npz"),
        vocab_path=str(out / "vocab.txt"),
    )
    ours = TextEncoder(
        cfg,
        tokenizer=WordPieceTokenizer.from_vocab_file(str(out / "vocab.txt")),
        device=device,
    ).encode_queries(list(texts))
    cos = np.sum(np.asarray(ours) * hf_sent, axis=1)
    for t, c in zip(texts, cos):
        print(f"parity cos={c:.6f}  {t}")
    worst = float(cos.min())
    if worst < min_cos:
        raise SystemExit(
            f"PARITY FAILURE: min cosine {worst:.6f} < {min_cos} — the "
            "converted encoder does NOT reproduce the HF forward"
        )
    print(f"parity OK: min cosine {worst:.6f} >= {min_cos}")
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument(
        "--ner", action="store_true", help="convert a token-classification model"
    )
    parser.add_argument(
        "--verify", action="store_true",
        help="after converting, prove cosine>=0.999 parity vs the HF "
        "torch forward on sample texts (tokenization included)",
    )
    parser.add_argument(
        "--device", default="cuda", help="device of the --verify forward (cuda or cpu)"
    )
    args = parser.parse_args(argv)
    if args.ner:
        from ..pipeline.ner_model import convert_hf_token_classifier

        convert_hf_token_classifier(args.model_dir, args.out)
        print(f"NER model converted -> {args.out}")
        print(f"export NER_WEIGHTS_PATH={args.out}")
    else:
        convert_encoder(args.model_dir, args.out)
        if args.verify:
            verify_encoder_parity(args.model_dir, args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
