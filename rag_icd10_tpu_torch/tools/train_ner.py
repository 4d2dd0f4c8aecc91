"""Train the model-mode NER token classifier offline (no external data).

Counterpart of rag_icd10_tpu/tools/train_ner.py, with its CLI, its
training data and its output directory. The reference's model mode
downloads lixin12345/chinese-medical-ner at runtime
(services/medical_ner_service.py:26-31); with zero egress there are no
real weights, so model mode degrades to rules. This tool makes model
mode FUNCTIONAL offline by distillation: synthetic clinical sentences
are composed from templates whose slots carry exact span labels by
construction — disease slots sample corpus titles, symptom/anatomy/drug
slots sample vocabularies mirroring the rule tables (pipeline/ner.py
RULE_PATTERNS) and the drug shapes (diagnosis_entity_filter.py:36-43) —
and a compact BERT token classifier trains on BIO tags over them.

The host code (templates, ``compose``, ``encode_example``, ``make_batch``,
``span_f1``, the title filter, the vocabulary and the order of the
seeded draws) is the JAX tool's, so both tools train on the same batches
and score the same 150 held-out sentences. The model is
pipeline/ner_model.py ``build_token_classifier``, the definition the
loader uses, with fp32 parameters under bf16 compute (as flax keeps
them), initialized from numpy (``models/bert.py init_params`` with a
classifier head), and trained by the JAX tool's step: masked mean token
cross-entropy over fp32 logits, AdamW with weight decay 0.01 under
optax's warmup-cosine schedule (parallel/train.py ``make_optimizer``).
Flax's initial draws cannot be reproduced without JAX, so the two tools
start from different weights.

The label names (Disease/Symptom/BodyParts/Drug) are chosen so
ENTITY_TYPE_MAPPING (pipeline/ner.py) maps them onto the standard types,
and the saved directory (params.npz + config.json with id2label +
vocab.txt) is what ``TorchTokenClassifier.from_weights`` and the JAX
package's loader read — so

    python -m rag_icd10_tpu_torch.tools.train_ner --out db/ner
    export NER_WEIGHTS_PATH=db/ner

turns model mode on end to end. Runs on ``cuda`` unless
``main(..., device="cpu")``; the card is acquired under the device guard
(utils/device_guard.py). The JAX tool's persistent XLA compile cache
(utils/compile_cache.py) has no module here: the only compiled work of
the port, its CUDA kernels, persists across processes in the hashed
build directory of ``ops/cuda_build.py`` (``build/torch_kernels/``), and
this tool's step compiles nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger("rag_icd10_tpu_torch.train_ner")

LABELS = (
    "O",
    "B-Disease", "I-Disease",
    "B-Symptom", "I-Symptom",
    "B-BodyParts", "I-BodyParts",
    "B-Drug", "I-Drug",
)

SYMPTOMS = (
    "头痛", "发热", "腹泻", "咳嗽", "心悸", "气促", "恶心", "呕吐", "腹胀",
    "水肿", "胸闷", "乏力", "头晕", "失眠", "便血", "咯血", "腹痛", "胸痛",
    "关节痛", "持续发热", "反复腹泻", "阵发性咳嗽", "突发性头晕", "皮肤瘙痒",
    "食欲不振", "体重下降", "夜间盗汗", "大量出血",
)
ANATOMY = (
    "心脏", "肝脏", "肺部", "肾脏", "胃部", "腰椎", "颈椎", "甲状腺",
    "乳腺", "冠状动脉", "子宫", "卵巢", "前列腺", "左肺", "右肾",
    "双侧乳腺", "胸椎", "主动脉", "脑部", "脊柱",
)
DRUGS = (
    "阿莫西林", "青霉素", "头孢拉定", "阿司匹林", "胰岛素", "二甲双胍",
    "硝苯地平", "氯吡格雷", "阿托伐他汀", "布洛芬", "奥美拉唑",
    "阿莫西林胶囊", "阿司匹林片", "胰岛素注射液", "红霉素软膏", "庆大霉素",
)

# (template, slot types) — {d}=disease {s}=symptom {a}=anatomy {g}=drug
TEMPLATES = (
    "患者诊断为{d}",
    "{d}，伴{s}",
    "{s}三天，考虑{d}",
    "{a}不适，{s}，诊断{d}",
    "{d}，给予{g}治疗",
    "患者{s}，服用{g}后缓解",
    "{a}检查提示{d}",
    "{d}术后，{s}",
    "既往{d}，现{s}加重",
    "{d}",
    "排除{d}，随访观察",
    "{a}疼痛，口服{g}",
    # silver shapes the RULES cannot label: corpus titles without
    # disease-suffix cues under uncertainty markers and clinical
    # connectives — the rule regexes only fire on suffix patterns
    # (pipeline/ner.py RULE_PATTERNS), so spans like 疑似{心功能Ⅲ级} or
    # {X}伴{Y} compounds are invisible to them by construction
    "疑似{d}",
    "{d}待查",
    "{d}？",
    "不排除{d}",
    "{d}伴{d}",
    "{d}并发{d}",
    "考虑{d}可能",
    "{d}，{d}术后",
)

SLOT_LABEL = {"d": "Disease", "s": "Symptom", "a": "BodyParts", "g": "Drug"}


def compose(template: str, rng, titles: Sequence[str]):
    """-> (segments, labels): segments are text pieces; labels[i] is the
    entity type of segment i or None for filler text."""
    segments: List[str] = []
    labels: List[str] = []
    rest = template
    while rest:
        i = rest.find("{")
        if i < 0:
            segments.append(rest)
            labels.append(None)
            break
        if i > 0:
            segments.append(rest[:i])
            labels.append(None)
        slot = rest[i + 1]
        pool = {
            "d": titles, "s": SYMPTOMS, "a": ANATOMY, "g": DRUGS,
        }[slot]
        segments.append(pool[int(rng.integers(0, len(pool)))])
        labels.append(SLOT_LABEL[slot])
        rest = rest[i + 3 :]
    return segments, labels


def encode_example(tok, segments, seg_labels, label_to_id, max_len: int):
    """Tokenize segment-wise so BIO tags align with tokens exactly."""
    ids: List[int] = [tok.cls_id]
    tags: List[int] = [label_to_id["O"]]
    from ..models.tokenizer import basic_tokenize

    for seg, lab in zip(segments, seg_labels):
        first = True
        for t in basic_tokenize(seg):
            for piece in tok.wordpiece(t):
                if len(ids) >= max_len - 1:
                    break
                ids.append(tok.vocab.get(piece, tok.unk_id))
                if lab is None:
                    tags.append(label_to_id["O"])
                else:
                    tags.append(
                        label_to_id[("B-" if first else "I-") + lab]
                    )
                    first = False
    ids.append(tok.sep_id)
    tags.append(label_to_id["O"])
    return ids, tags


def make_batch(tok, examples, label_to_id, max_len: int):
    rows = len(examples)
    ids = np.full((rows, max_len), tok.pad_id, np.int32)
    mask = np.zeros((rows, max_len), np.int32)
    tags = np.zeros((rows, max_len), np.int32)
    for r, (segments, seg_labels) in enumerate(examples):
        i, t = encode_example(tok, segments, seg_labels, label_to_id, max_len)
        ids[r, : len(i)] = i
        mask[r, : len(i)] = 1
        tags[r, : len(t)] = t
    return ids, mask, tags


def span_f1(pred_spans, gold_spans) -> Tuple[float, float, float]:
    pred, gold = set(pred_spans), set(gold_spans)
    if not pred and not gold:
        return 1.0, 1.0, 1.0
    tp = len(pred & gold)
    p = tp / len(pred) if pred else 0.0
    r = tp / len(gold) if gold else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f


def draw_examples(rng, titles: Sequence[str], n: int):
    """``n`` composed examples as the tool draws them from ``rng``: one
    template draw, then its slots, per example."""
    return [
        compose(TEMPLATES[int(rng.integers(0, len(TEMPLATES)))], rng, titles)
        for _ in range(n)
    ]


def disease_titles(corpus) -> List[str]:
    """The disease slot pool (the JAX tool's filter): corpus titles of
    2-14 characters with no diagnosis separator and no bracket."""
    from ..pipeline.textproc import SEPARATOR_RE

    brackets = set("（）()[]")
    return [
        t
        for t in corpus.titles
        if 2 <= len(t) <= 14
        and SEPARATOR_RE.search(t) is None
        and not (brackets & set(t))
    ]


def build_vocab(titles: Sequence[str]):
    """The classifier's vocabulary: every character of the titles, the
    slot vocabularies and the templates' filler text."""
    from ..models.tokenizer import WordPieceTokenizer

    vocab_texts = list(titles) + list(SYMPTOMS) + list(ANATOMY) + list(DRUGS)
    vocab_texts += ["".join(TEMPLATES)]
    return WordPieceTokenizer.from_corpus(vocab_texts)


def ner_arch(vocab_size: int, hidden: int, layers: int, seq: int):
    """The JAX tool's classifier shape (bf16 compute) for these flags."""
    from ..models.bert import BertArch

    return BertArch(
        vocab_size=vocab_size,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=max(hidden // 64, 2),
        intermediate_size=hidden * 4,
        max_position_embeddings=max(seq, 64),
    )


def init_ner_state(arch, schedule, seed: int = 0, params: Optional[Dict] = None,
                   device: Union[str, torch.device] = "cuda"):
    """A ``parallel/train.py TrainState`` over the token classifier with
    fp32 parameters (bf16 weights under AdamW drop most updates) on
    ``device``: from ``params`` (a JAX-layout tree with a ``classifier``
    head) or from ``init_params(arch, seed, num_labels)``."""
    from ..models.bert import init_params
    from ..models.convert_hf import params_from_jax
    from ..parallel.train import TrainState, make_optimizer
    from ..pipeline.ner_model import build_token_classifier
    from ..utils.device import resolve_device

    if params is None:
        params = init_params(arch, seed=seed, num_labels=len(LABELS))
    with torch.device(resolve_device(device)):
        model = build_token_classifier(
            dataclasses.replace(arch, param_dtype=torch.float32), num_labels=len(LABELS))
    model.load_state_dict(params_from_jax(params))
    model.train()
    return TrainState(model, *make_optimizer(model, schedule, weight_decay=0.01))


def ner_train_step(state, ids, mask, tags):
    """One AdamW update of ``state`` in place on a (B, S) batch of
    ``make_batch`` arrays (the JAX tool's ``loss_fn`` and ``train_step``,
    token types all 0) -> (loss, acc): the masked mean token cross-entropy
    over the fp32 logits and the masked token accuracy, both 0-d tensors on
    the state's device: reading them back is the caller's sync. The batch
    reaches a card in one copy from pinned memory that does not wait for
    the card, so the host composes the next batch while the step runs."""
    from ..parallel.train import apply_update

    dev = state.device
    batch = torch.from_numpy(np.stack([ids, mask, tags]).astype(np.int64))
    if dev.type == "cuda":
        batch = batch.pin_memory().to(dev, non_blocking=True)
    ids_t, mask_t, tags_t = batch
    logits = state.model(ids_t, mask_t, torch.zeros_like(ids_t))
    ce = F.cross_entropy(logits.flatten(0, 1), tags_t.flatten(), reduction="none")
    m = mask_t.flatten().float()
    denom = m.sum().clamp(min=1.0)
    loss = (ce * m).sum() / denom
    acc = ((logits.argmax(-1).flatten() == tags_t.flatten()).float() * m).sum() / denom
    loss.backward()
    apply_update(state)
    return loss.detach(), acc.detach()


def run_span_eval(args, titles, out: Path,
                  device: Union[str, torch.device] = "cuda") -> int:
    """Held-out span eval: model vs RULES, standard-type space.

    The comparison that matters for serving: both modes through the full
    MedicalNERService (type mapping included), on the same sentences —
    including the marker/connective shapes the rule regexes cannot label
    by construction — both on ``device``. Written to <out>/eval.json so
    the model-beats-rules claim has an artifact. Returns 1 when the
    freshly saved weights do not load; a device error raises.
    """
    import os

    from ..config import NERConfig
    from ..pipeline.ner import MedicalNERService

    os.environ["NER_WEIGHTS_PATH"] = str(out)
    model_svc = MedicalNERService(NERConfig(use_model=True), device=device)
    rule_svc = MedicalNERService(NERConfig(use_model=False), device=device)
    if not model_svc.use_model:
        logger.error("freshly saved weights failed to load from %s", out)
        return 1
    std_of = {"Disease": "disease", "Symptom": "symptom",
              "BodyParts": "anatomy", "Drug": "drug"}
    types = set(std_of.values())

    def svc_spans(svc, text):
        ents = svc.extract_medical_entities(text, filter_drugs=False)
        return [
            (e["text"], etype)
            for etype in types
            for e in ents.get(etype, [])
        ]

    eval_rng = np.random.default_rng(args.seed + 999)
    scores = {"model": [], "rules": []}
    for segments, seg_labels in draw_examples(eval_rng, titles, 150):
        text = "".join(segments)
        gold = [
            (seg, std_of[lab])
            for seg, lab in zip(segments, seg_labels)
            if lab is not None
        ]
        scores["model"].append(span_f1(svc_spans(model_svc, text), gold))
        scores["rules"].append(span_f1(svc_spans(rule_svc, text), gold))
    report = {}
    for mode, triples in scores.items():
        arr = np.asarray(triples)
        report[mode] = {
            "precision": round(float(arr[:, 0].mean()), 4),
            "recall": round(float(arr[:, 1].mean()), 4),
            "f1": round(float(arr[:, 2].mean()), 4),
        }
        logger.info(
            "held-out span eval (%s, 150 sentences, standard types): "
            "P=%.3f R=%.3f F1=%.3f",
            mode, report[mode]["precision"], report[mode]["recall"],
            report[mode]["f1"],
        )
    report["note"] = (
        "gold = template construction (corpus-title disease slots incl. "
        "marker/connective shapes); spans compared in standard-type space "
        "through the full MedicalNERService for both modes"
    )
    (out / "eval.json").write_text(json.dumps(report, ensure_ascii=False, indent=1))
    print(f"export NER_WEIGHTS_PATH={out}")
    return 0


def main(argv=None, device: Union[str, torch.device] = "cuda") -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--layers", type=int, default=4)
    parser.add_argument("--out", default="db/ner")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument(
        "--eval-only", action="store_true",
        help="skip training; run the model-vs-rules span eval against the "
        "weights already saved under --out (writes <out>/eval.json)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from ..config import get_config
    from ..data.corpus import load_corpus
    from ..models.convert_hf import save_params
    from ..parallel.train import warmup_cosine_decay_schedule
    from ..utils.device_guard import acquire_device

    dev = acquire_device(device, what="NER training")
    cfg = get_config()
    corpus = load_corpus(cfg.data_path)
    titles = disease_titles(corpus)
    logger.info("disease slot pool: %d corpus titles", len(titles))

    if args.eval_only:
        return run_span_eval(args, titles, Path(args.out), device=dev)

    tok = build_vocab(titles)
    label_to_id = {l: i for i, l in enumerate(LABELS)}
    arch = ner_arch(tok.vocab_size, args.hidden, args.layers, args.seq)
    schedule = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        decay_steps=args.steps,
    )
    state = init_ner_state(arch, schedule, seed=args.seed, device=dev)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        examples = draw_examples(rng, titles, args.batch)
        ids, mask, tags = make_batch(tok, examples, label_to_id, args.seq)
        loss, acc = ner_train_step(state, ids, mask, tags)
        if (step + 1) % args.log_every == 0 or step == 0:
            logger.info(
                "step %d/%d loss=%.4f token_acc=%.4f (%.1f steps/s)",
                step + 1, args.steps, float(loss), float(acc),
                (step + 1) / (time.time() - t0),
            )

    # ---- save in the TorchTokenClassifier.from_weights layout -----------
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    save_params(state.params(), str(out / "params.npz"))
    tok.save_vocab(str(out / "vocab.txt"))
    config = {
        "vocab_size": arch.vocab_size,
        "hidden_size": arch.hidden_size,
        "num_hidden_layers": arch.num_layers,
        "num_attention_heads": arch.num_heads,
        "intermediate_size": arch.intermediate_size,
        "max_position_embeddings": arch.max_position_embeddings,
        "id2label": {str(i): l for i, l in enumerate(LABELS)},
        "trained_by": "rag_icd10_tpu_torch.tools.train_ner (rule-NER distillation)",
    }
    (out / "config.json").write_text(json.dumps(config, ensure_ascii=False))

    return run_span_eval(args, titles, out, device=dev)


if __name__ == "__main__":
    sys.exit(main())
