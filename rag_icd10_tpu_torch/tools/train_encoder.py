"""Contrastive fine-tuning of the sentence encoder on corpus-derived pairs.

Counterpart of rag_icd10_tpu/tools/train_encoder.py, with its CLI, its
training data and its checkpoint layout (``params.npz``, ``vocab.txt``,
``opt_state.npz`` with ``__step__`` and the optax leaves ``leaf_i``), so a
checkpoint of either package resumes in the other. Training examples
come from the ICD corpus itself (no external data needed):

- (title, semantic_text) — a record's title should embed close to its
  enriched semantic text (the stored vector)
- (child title, parent semantic_text) — hierarchy neighbors pull together
- sibling HARD NEGATIVES — codes under the same parent are the actually
  confusable class; each anchor trains against a same-parent title
- duplicate-title masking — ~5.5k records share a title with another
  record; the masked InfoNCE (parallel/train.py contrastive_loss_masked)
  never presents an identical-title row as a negative
- TRAIN-class query augmentation (data/augment.py): train-half synonyms,
  parenthetical strip, char dropout — eval-class transforms are withheld
  for the retrieval eval harness

Objective: bidirectional in-batch-negatives InfoNCE with hard negatives
(sentence-transformers MultipleNegativesRankingLoss family), AdamW on fp32
parameters with bf16 compute under optax's warmup-cosine schedule
(parallel/train.py). Runs on ``cuda`` unless ``main(..., device="cpu")``,
acquiring the card under the device guard (utils/device_guard.py); the
JAX tool's compile cache maps to the kernel build directory that
``ops/cuda_build.py`` keeps across processes.

Usage:
    python -m rag_icd10_tpu_torch.tools.train_encoder \
        --steps 16000 --batch 256 --out db/trained
    export EMBEDDING_WEIGHTS_PATH=db/trained/params.npz
    python -m rag_icd10_tpu_torch.tools.build_database --rebuild

Single-device by default; --dp N --tp M runs over a (dp, tp) mesh
(parallel/train.py): data parallel over dp, Megatron tensor parallel over
tp (parallel/tensor_parallel.py). --tp alone builds no mesh, as in the
JAX tool.

The encoder is BERT unless a ``config.json`` beside --init-from names
``model_type`` ``deepseek_v3``: the encoder is then that decoder
(models/deepseek_v3.py: e.g. one expert-parallel rank's share of
Moonlight-16B-A3B), single-device, warm-started from the checkpoint's
``.npz`` in the published parameter names, and saved the same way with its
``config.json`` (``opt_state.npz`` follows its parameter order). It is not
served, so --eval-gate refuses it.

Each step records spans in the port's registry (utils/metrics.py), with
the step number as their id: ``train.draw`` (in ``draw_batch``:
``train.draw.sample``, ``train.draw.tokenize``) and ``train.step`` (in
parallel/train.py: ``train.step.forward``, ``.backward``, ``.update``).
The --log-every line prints the interval's mean draw, step and wait (the
step's self time: the host blocked on the device) from them, and the share
of the tokenizer's piece lookups that hit its memo over the interval; for
a mixture-of-experts encoder, also the share of the routed token slots its
held experts took and their max/mean load, and the latent-attention
kernel's forward calls a step (``metrics.counters``; 0 where the plain
version ran, on the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger("rag_icd10_tpu_torch.train")


@dataclass
class Example:
    anchor: str
    positive: str
    ga: int  # title id of the anchor's source title
    gb: int  # title id of the record behind the positive
    sib_titles: Tuple[str, ...]  # same-parent distinct titles (hard negs)
    cousin_titles: Tuple[str, ...]  # same-grandparent, different parent
    augment: bool  # parent-pairs keep the exact child title
    pos_weight: float = 1.0  # served level weight of the positive's record
    anc_titles: Tuple[str, ...] = ()  # ancestor titles (parent, gparent)


def title_weight_map(corpus, level_weights=(1.2, 1.0, 0.8)) -> Dict[str, float]:
    """Title -> the MAX served level weight over rows bearing that title.

    Used to weight hard-negative columns under --weighted-loss: a title
    appearing at several levels is scored at its most advantaged weight
    (the adversarial case the gold row must beat at serving)."""
    w = corpus.level_weights(level_weights)
    out: Dict[str, float] = {}
    for t, wi in zip(corpus.titles, w):
        prev = out.get(t)
        if prev is None or wi > prev:
            out[t] = float(wi)
    return out


def build_examples(
    corpus,
    level_weights=(1.2, 1.0, 0.8),
    parent_pairs: bool = True,
) -> Tuple[List[Example], Dict[str, int]]:
    """Corpus -> training examples + the title->id interning map.

    Hard negatives come from the hierarchy: SIBLINGS (same parent — the
    most confusable class), COUSINS (same grandparent, different
    parent — confusable one ring out, e.g. neighboring category blocks),
    and ANCESTORS (the parent/grandparent titles themselves — the class
    the served ×1.2/1.0/0.8 level weights ADVANTAGE over the gold row;
    scripts/analyze_misses.py measured 97% of exact-tier raw recall@1
    misses as exactly this inversion, gold_l3 under top_l2/l1).

    ``parent_pairs=False`` drops the (child title -> parent semantic)
    positive pairs: those pull a child query TOWARD its ancestor, the
    opposite of what the weighted-loss inversion fix needs; the ablation
    must be a flag, not an edit.
    """
    title_ids: Dict[str, int] = {}

    def tid(t: str) -> int:
        return title_ids.setdefault(t, len(title_ids))

    c2i = corpus.code_to_idx
    kids = defaultdict(list)
    for i, p in enumerate(corpus.parent_codes):
        if p:
            kids[p].append(i)

    examples: List[Example] = []
    titles = corpus.titles
    row_w = corpus.level_weights(level_weights)
    for i in range(len(corpus)):
        t = titles[i]
        parent = corpus.parent_codes[i]
        sibs = tuple(
            titles[j] for j in kids.get(parent, ()) if titles[j] != t
        )
        cousins: Tuple[str, ...] = ()
        ancestors: Tuple[str, ...] = ()
        pi = c2i.get(parent)
        if pi is not None:
            gparent = corpus.parent_codes[pi]
            cousins = tuple(
                titles[j]
                for uncle in kids.get(gparent, ())
                if corpus.codes[uncle] != parent
                for j in kids.get(corpus.codes[uncle], ())[:3]
                if titles[j] != t
            )[:12]
            gi = c2i.get(gparent)
            ancestors = tuple(
                dict.fromkeys(
                    titles[j]
                    for j in (pi, gi)
                    if j is not None and titles[j] != t
                )
            )
        examples.append(
            Example(
                t, corpus.semantic_texts[i], tid(t), tid(t), sibs,
                cousins, True, float(row_w[i]), ancestors,
            )
        )
        if parent_pairs and pi is not None and titles[pi] != t:
            examples.append(
                Example(
                    t, corpus.semantic_texts[pi], tid(t), tid(titles[pi]),
                    sibs, cousins, False, float(row_w[pi]), ancestors,
                )
            )
    return examples, title_ids


def make_pairs(corpus) -> List[Tuple[str, str]]:
    """Legacy plain-pair builder (title<->semantic, child<->parent)."""
    pairs: List[Tuple[str, str]] = []
    title_of = {}
    for code, title in zip(corpus.codes, corpus.titles):
        title_of[code] = title
    for title, semantic in zip(corpus.titles, corpus.semantic_texts):
        pairs.append((title, semantic))
    for code, title, parent in zip(corpus.codes, corpus.titles, corpus.parent_codes):
        parent_title = title_of.get(parent)
        if parent_title and parent_title != title:
            pairs.append((title, parent_title))
    return pairs


def draw_batch(
    examples: List[Example],
    idx,
    corpus_titles: List[str],
    title_ids: Dict[str, int],
    rng,
    tok,
    seq_a: int,
    seq_b: int,
    augment_prob: float,
    marker_prob: float = 0.0,
    cousin_frac: float = 0.3,
    ancestor_frac: float = 0.0,
    title_weights: Dict[str, float] = None,
):
    """Materialize one triplet batch; augmentation and hard-negative
    sampling are fresh each draw (new perturbations every epoch).

    marker_prob wraps the (possibly augmented) anchor in one of the
    reference's uncertainty markers — composable with other transforms
    the way real queries compose them ("疑似心梗"). cousin_frac is the
    chance a cousin (same-grandparent) title replaces the sibling hard
    negative; 0 disables cousins entirely (the r2 recipe — the gate
    data suggests the r3-added transforms trade paraphrase transfer
    for uncertainty robustness, EVAL_GATE_r04.json, so the ablation
    must be runnable from the CLI).

    ancestor_frac is the chance the hard negative is an ANCESTOR title
    (parent/grandparent) instead — the class the served level weights
    advantage over the gold row (the weight-inversion miss class,
    scripts/analyze_misses.py). title_weights (from title_weight_map)
    switches on the weighted loss: batches carry per-column served
    weights and the train step ranks by w·cos exactly as search will.
    """
    from ..data.augment import augment_train, wrap_uncertainty
    from ..parallel.train import make_triplet_batch
    from ..utils.metrics import metrics

    texts_a, texts_b, texts_h = [], [], []
    ga, gb, gh = [], [], []
    w_b, w_h = [], []
    with metrics.span("train.draw.sample"):
        for i in idx:
            e = examples[i]
            a = e.anchor
            if e.augment and rng.random() < augment_prob:
                v = augment_train(a, rng)
                if v:
                    a = v
            if rng.random() < marker_prob:
                a = wrap_uncertainty(a, rng)
            # hard negative ladder: ancestor (ancestor_frac) > cousin
            # (cousin_frac) > sibling; missing pools fall through
            pool = e.sib_titles
            if (ancestor_frac > 0 and e.anc_titles
                    and rng.random() < ancestor_frac):
                pool = e.anc_titles
            elif (cousin_frac > 0 and e.cousin_titles
                    and (not pool or rng.random() < cousin_frac)):
                pool = e.cousin_titles
            if pool:
                h = pool[int(rng.integers(0, len(pool)))]
            else:
                # random title; the loss masks it if it happens to collide
                h = corpus_titles[int(rng.integers(0, len(corpus_titles)))]
            texts_a.append(a)
            texts_b.append(e.positive)
            texts_h.append(h)
            ga.append(e.ga)
            gb.append(e.gb)
            gh.append(title_ids.setdefault(h, len(title_ids)))
            if title_weights is not None:
                w_b.append(e.pos_weight)
                w_h.append(title_weights.get(h, 1.0))
    with metrics.span("train.draw.tokenize"):
        return make_triplet_batch(
            tok, texts_a, texts_b, texts_h, ga, gb, gh,
            seq_a=seq_a, seq_b=seq_b, pad_rows=len(idx),
            w_b=w_b if title_weights is not None else None,
            w_h=w_h if title_weights is not None else None,
        )


STEP_PHASES = ("train.step.forward", "train.step.backward", "train.step.update")


def interval_split_ms(registry, since_ns: int) -> Tuple[float, float, float]:
    """Mean ``train.draw``, ``train.step`` and step self time (the host
    blocked on the device, plus the loop's own Python) in ms, over the
    steps whose spans start at or after ``since_ns``; nan where the
    registry holds none."""
    from ..utils.metrics import self_ns

    def mean(xs):
        return float(np.mean(xs)) / 1e6 if xs else float("nan")

    draws = registry.spans("train.draw", since_ns) or []
    steps = registry.spans("train.step", since_ns) or []
    kids = [c for name in STEP_PHASES for c in registry.spans(name, since_ns) or []]
    return (mean([s.end_ns - s.start_ns for s in draws]),
            mean([s.end_ns - s.start_ns for s in steps]),
            mean([self_ns(s, kids) for s in steps]))


def memo_hit_pct(before: Dict[str, int], after: Dict[str, int]) -> float:
    """Percent of the tokenizer's piece lookups between two ``memo_stats``
    that hit its memo; nan where there were none."""
    hits = after["hits"] - before["hits"]
    looked = hits + after["misses"] - before["misses"]
    return 100.0 * hits / looked if looked else float("nan")


def moe_load(before: Dict[str, np.ndarray], after: Dict[str, np.ndarray]) -> Tuple[float, float]:
    """Between two ``metrics.counters("moe.")``: the percent of the routed
    token slots that went to the experts held here, and the max over the
    mean of the slots each held expert took, averaged over the layers;
    nan where no slot was routed."""
    def delta(key):
        return after[key] - before.get(key, 0)

    held = [k for k in after if k.startswith("moe.held_slots.")]
    routed = sum(float(delta("moe.routed_slots." + k.rsplit(".", 1)[1])) for k in held)
    took = [delta(k).astype(np.float64) for k in held]
    if not routed or not any(t.sum() for t in took):
        return float("nan"), float("nan")
    share = 100.0 * sum(float(t.sum()) for t in took) / routed
    return share, float(np.mean([t.max() / t.mean() for t in took if t.sum()]))


def mla_kernel_calls() -> int:
    """Forward calls of the latent-attention kernel so far (ops/mla_attention.py)."""
    from ..utils.metrics import metrics

    return int(metrics.counters("mla.").get("mla.kernel_calls", 0))


def select_vocab(explicit_vocab, init_from, build_fresh):
    """Tokenizer vocab for a training run.

    A RESUME must tokenize exactly like the original run: the augmentation
    charset is part of vocab construction, so any later edit to the
    synonym table would shift token ids under the checkpoint's frozen
    embedding rows — silently corrupting the warm start. Preference
    order: explicitly configured vocab file, the vocab.txt saved next to
    the --init-from checkpoint, then a fresh corpus+charset build.
    """
    from ..models.tokenizer import WordPieceTokenizer

    if explicit_vocab and Path(explicit_vocab).exists():
        return WordPieceTokenizer.from_vocab_file(str(explicit_vocab))
    if init_from:
        init_vocab = Path(init_from).parent / "vocab.txt"
        if init_vocab.exists():
            logger.info("resume: adopting checkpoint vocab %s", init_vocab)
            return WordPieceTokenizer.from_vocab_file(str(init_vocab))
    return build_fresh()


def main(argv=None, device: Union[str, torch.device] = "cuda") -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=16000)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seq-a", type=int, default=48,
                        help="anchor/hard-negative (title) sequence length")
    parser.add_argument("--seq-b", type=int, default=96,
                        help="positive (semantic_text, p99~94 chars) length")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--augment-prob", type=float, default=0.4)
    parser.add_argument(
        "--cousin-frac", type=float, default=0.3,
        help="fraction of hard-negative draws that use a cousin title "
        "instead of a sibling; 0 = r2 recipe (siblings only). With "
        "--augment-prob 0 --marker-prob 0 this reproduces the r2 "
        "training data exactly (ablation for the paraphrase-vs-"
        "uncertainty trade seen in EVAL_GATE_r04.json)",
    )
    parser.add_argument(
        "--marker-prob", type=float, default=0.25,
        help="probability of wrapping an anchor in one of the reference's "
        "uncertainty markers (composable with --augment-prob transforms)",
    )
    parser.add_argument(
        "--weighted-loss", action="store_true",
        help="fold the served level weights (store config ×1.2/1.0/0.8) "
        "into the InfoNCE logits: candidates are ranked by w·cos exactly "
        "as the fused weighted search ranks them, so the gold row must "
        "open the full weight-ratio margin over level-advantaged rivals "
        "(97%% of exact-tier raw recall@1 misses are such inversions — "
        "scripts/analyze_misses.py)",
    )
    parser.add_argument(
        "--ancestor-frac", type=float, default=0.0,
        help="fraction of hard-negative draws that use an ANCESTOR title "
        "(parent/grandparent — the weight-advantaged rival class) "
        "instead of the sibling/cousin ladder",
    )
    parser.add_argument(
        "--no-parent-pairs", action="store_true",
        help="drop the (child title -> parent semantic_text) positive "
        "pairs, which pull a child query toward the exact rival class "
        "the weighted loss must demote",
    )
    parser.add_argument("--out", default="db/trained")
    parser.add_argument(
        "--init-from", default=None,
        help="warm-start params from a params.npz checkpoint (resume "
        "from the last --save-every checkpoint instead of restarting); a "
        "sibling opt_state.npz is adopted too (full resume: Adam moments "
        "+ schedule step). Checkpoints of the JAX package load as well",
    )
    parser.add_argument(
        "--params-only", action="store_true",
        help="with --init-from: adopt the donor's params but NOT its "
        "opt_state — for warm-starting a NEW recipe/schedule from a "
        "finished run (a full resume would drive the new schedule from "
        "the donor's step count: lr≈0, or zero steps when donor step "
        ">= --steps)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--dp", type=int, default=0,
        help="mesh dp (0 = single device): data parallel over this "
        "process's devices, or every rank's once torch.distributed is "
        "initialized (parallel/multihost.initialize)",
    )
    parser.add_argument(
        "--tp", type=int, default=1,
        help="mesh tp, with --dp: Megatron tensor parallel over tp shards "
        "(several on one device are logical shards)",
    )
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--save-every", type=int, default=2000,
                        help="checkpoint params every N steps (0 = end only)")
    parser.add_argument(
        "--keep-every", type=int, default=4000,
        help="retain a tagged copy params_step{N}.npz every N steps so a "
        "regression can be bisected post-hoc (round-3 lesson: the rolling "
        "checkpoint alone cannot tell 6k steps from 48k)",
    )
    parser.add_argument(
        "--plain-pairs", action="store_true",
        help="legacy objective: unmasked pairs, no hard negatives",
    )
    parser.add_argument(
        "--eval-gate", default=None, metavar="BASELINE",
        help="after training, embed the corpus with the new weights, run "
        "the tiered retrieval eval (raw + pipeline) in-process, and only "
        "BLESS the weights if paraphrase pipeline top-1 >= BASELINE "
        "(a float, or a path to an incumbent EVAL json to read the score "
        "from). Writes <out>/eval_gate.json; exits 3 when below baseline "
        "(weights stay on disk, marked blessed=false).",
    )
    parser.add_argument(
        "--gate-metric", choices=("paraphrase", "blend"),
        default="paraphrase",
        help="what --eval-gate compares: paraphrase pipeline top-1 (the "
        "historical bar) or the 4-tier blend (mean of exact/paraphrase/"
        "uncertainty pipeline top-1 + multi sub-top-1) — use blend when "
        "a candidate trades tiers (EVAL_GATE_r04.json)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from ..config import get_config
    from ..data.corpus import load_corpus
    from ..models import deepseek_v3
    from ..models.bert import BertArch
    from ..models.convert_hf import load_params, save_params
    from ..models.tokenizer import WordPieceTokenizer
    from ..parallel.train import (
        init_train_state,
        make_pair_batch,
        make_sharded_train_step,
        make_train_step,
        warmup_cosine_decay_schedule,
    )
    from ..utils.device_guard import acquire_device
    from ..utils.metrics import metrics

    # the architecture is the one the starting checkpoint's config.json
    # names; BERT where there is none (or it names BERT)
    decoder = deepseek_v3.arch_beside(args.init_from) if args.init_from else None
    if decoder is not None and args.eval_gate is not None:
        parser.error(f"--eval-gate embeds the corpus with the served BERT encoder; "
                     f"a {deepseek_v3.MODEL_TYPE} encoder is not served")
    dev = acquire_device(device, what="encoder training")
    cfg = get_config()
    corpus = load_corpus(cfg.data_path)
    if args.plain_pairs:
        pairs = make_pairs(corpus)
        logger.info("built %d plain pairs from %d records", len(pairs), len(corpus))
    else:
        examples, title_ids = build_examples(
            corpus,
            level_weights=cfg.store.level_weights,
            parent_pairs=not args.no_parent_pairs,
        )
        logger.info(
            "built %d examples (%d distinct titles) from %d records%s",
            len(examples), len(title_ids), len(corpus),
            " (parent pairs dropped)" if args.no_parent_pairs else "",
        )
    title_weights = (
        title_weight_map(corpus, cfg.store.level_weights)
        if args.weighted_loss else None
    )
    if title_weights is not None:
        logger.info(
            "weighted loss ON: logits rank by served w·cos "
            "(level weights %s)", cfg.store.level_weights,
        )

    # vocab must cover the augmentation charset (synonym variants, marker
    # chars) or augmented anchors degrade to [UNK]; resumes adopt the
    # checkpoint's own vocab — see select_vocab
    from ..data.augment import augmentation_charset_texts

    tok = select_vocab(
        cfg.encoder.vocab_path,
        args.init_from,
        lambda: WordPieceTokenizer.from_corpus(
            corpus.titles + corpus.semantic_texts
            + augmentation_charset_texts()
        ),
    )

    enc_cfg = cfg.encoder
    params = None
    if decoder is not None:
        if tok.vocab_size > decoder.vocab_size:
            raise ValueError(f"the vocabulary has {tok.vocab_size} ids, the checkpoint's "
                             f"embedding {decoder.vocab_size} rows")
        arch = decoder
        logger.info("warm-starting a %s (%d layers, experts held %s of %d) from %s",
                    deepseek_v3.MODEL_TYPE, arch.num_hidden_layers, list(arch.held),
                    arch.n_routed_experts, args.init_from)
        params = deepseek_v3.load_weights(args.init_from, arch)
    else:
        arch = BertArch(
            vocab_size=max(enc_cfg.vocab_size, tok.vocab_size),
            hidden_size=enc_cfg.hidden_size,
            num_layers=enc_cfg.num_layers,
            num_heads=enc_cfg.num_heads,
            intermediate_size=enc_cfg.intermediate_size,
            max_position_embeddings=enc_cfg.max_position_embeddings,
        )
        if args.init_from:
            logger.info("warm-starting params from %s", args.init_from)
            params = load_params(args.init_from)
    schedule = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        decay_steps=args.steps,
    )
    mesh = None
    if args.dp:
        from ..parallel.mesh import make_mesh
        from ..parallel.multihost import local_devices

        mesh = make_mesh(dp=args.dp, tp=args.tp, devices=local_devices(dev.type))
    # keep the warmup-cosine schedule, --seed AND any warm-started state on
    # the dp path too: every replica starts from them
    state = init_train_state(
        arch, mesh=mesh, seed=args.seed, schedule=schedule, params=params, device=dev,
    )
    start_step = 0
    if args.init_from:
        # a full resume restores the optimizer too: Adam moments AND the
        # step count that drives the cosine schedule — a params-only warm
        # start restarts both
        opt_path = Path(args.init_from).parent / "opt_state.npz"
        if args.params_only:
            # cross-RECIPE warm start: adopting the donor's opt_state
            # would drive the new schedule from the donor's step count
            # (lr ~ 0 when the donor finished its own run) or skip
            # training entirely when donor step >= --steps
            logger.info("--params-only: donor optimizer state ignored")
        elif opt_path.exists():
            flat = np.load(str(opt_path))
            n_leaves = sum(1 for key in flat.files if key.startswith("leaf_"))
            if n_leaves == 2 * state.num_leaves + 2:
                state.load_opt_state([flat[f"leaf_{i}"] for i in range(n_leaves)])
                start_step = int(flat["__step__"]) if "__step__" in flat.files else 0
                logger.info(
                    "restored optimizer state (step %d) from %s",
                    start_step, opt_path,
                )
            else:
                logger.warning(
                    "opt_state.npz leaf count mismatch — fresh optimizer"
                )
        if start_step >= args.steps:
            # intended when an eval gate follows (the recovery chain
            # gate-evals a finished checkpoint this way); anything else
            # is almost certainly a mis-set --steps or a cross-recipe
            # warm start that wanted --params-only
            logger.warning(
                "checkpoint already at step %d >= --steps %d: ZERO "
                "training steps will run — the donor weights are "
                "re-saved%s. For a cross-recipe warm start pass "
                "--params-only.",
                start_step, args.steps,
                " and eval-gated" if args.eval_gate else "",
            )
    run_step = make_sharded_train_step(mesh) if mesh is not None else make_train_step()
    writer = mesh is None or mesh.rank == 0  # replicas are identical: one writes

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def save_checkpoint(state, step=None):
        # under tp across ranks the gathers are collectives: every rank
        # gathers, rank 0 writes
        params = state.params()
        leaves = state.opt_state_leaves() if step is not None else None
        if not writer:
            return
        if decoder is not None:
            deepseek_v3.save_weights(params, arch, str(out / "params.npz"))
        else:
            save_params(params, str(out / "params.npz"))
        tok.save_vocab(str(out / "vocab.txt"))
        if step is not None:
            np.savez(
                str(out / "opt_state.npz"),
                __step__=np.int64(step),
                **{f"leaf_{i}": v for i, v in enumerate(leaves)},
            )
        if (step is not None and args.keep_every
                and step % args.keep_every == 0):
            shutil.copyfile(
                str(out / "params.npz"), str(out / f"params_step{step}.npz")
            )

    rng = np.random.default_rng(args.seed)
    n_examples = len(pairs) if args.plain_pairs else len(examples)
    order = rng.permutation(n_examples)
    cursor = 0
    # deterministic fast-forward of the data order on resume (the rng
    # draws inside draw_batch differ run-to-run, but the epoch boundary
    # accounting stays clean)
    for _ in range(start_step):
        if cursor + args.batch <= n_examples:
            cursor += args.batch
        else:
            tail = n_examples - cursor
            order = rng.permutation(n_examples)
            cursor = args.batch - tail
    t0 = time.time()
    t_log = time.time_ns()
    memo_log = tok.memo_stats()
    moe_log = metrics.counters("moe.")
    mla_log, step_log = (mla_kernel_calls() if decoder is not None else 0), start_step
    losses = []
    for step in range(start_step, args.steps):
        # epoch-clean cursor: consume the tail of the old permutation and
        # top up from a fresh one (no skipped tail / double-sampled head)
        if cursor + args.batch <= n_examples:
            idx = order[cursor : cursor + args.batch]
            cursor += args.batch
        else:
            tail = order[cursor:]
            order = rng.permutation(n_examples)
            cursor = args.batch - len(tail)
            idx = np.concatenate([tail, order[:cursor]])
        with metrics.span("train.draw", id=step):
            if args.plain_pairs:
                batch_pairs = [pairs[i] for i in idx]
                batch = make_pair_batch(
                    tok,
                    [a for a, _ in batch_pairs],
                    [b for _, b in batch_pairs],
                    max_length=args.seq_b,
                    pad_rows=args.batch,
                )
            else:
                batch = draw_batch(
                    examples, idx, corpus.titles, title_ids, rng, tok,
                    args.seq_a, args.seq_b, args.augment_prob,
                    args.marker_prob, args.cousin_frac,
                    args.ancestor_frac, title_weights,
                )
        with metrics.span("train.step", id=step):
            m = run_step(state, batch)
            losses.append(float(m["loss"]))
        if (step + 1) % args.log_every == 0 or step == start_step:
            rate = (step + 1 - start_step) / (time.time() - t0)
            draw_ms, step_ms, wait_ms = interval_split_ms(metrics, t_log)
            t_log = time.time_ns()
            memo = tok.memo_stats()
            line = ("step %d/%d loss=%.4f acc=%.3f (%.2f steps/s; draw %.1f ms, "
                    "step %.1f ms, wait %.1f ms; piece memo %.1f%% hits)")
            values = [step + 1, args.steps, float(m["loss"]), float(m["accuracy"]), rate,
                      draw_ms, step_ms, wait_ms, memo_hit_pct(memo_log, memo)]
            if decoder is not None:  # reads the expert counters off the device
                moe, mla_calls = metrics.counters("moe."), mla_kernel_calls()
                line += ("; experts held %.1f%% of slots, load max/mean %.2f; "
                         "MLA kernel %.1f calls a step")
                values += [*moe_load(moe_log, moe), (mla_calls - mla_log) / (step + 1 - step_log)]
                moe_log, mla_log, step_log = moe, mla_calls, step + 1
            logger.info(line, *values)
            memo_log = memo
        if args.save_every and (step + 1) % args.save_every == 0:
            save_checkpoint(state, step + 1)
            logger.info("checkpoint saved at step %d -> %s", step + 1, out)

    save_checkpoint(state, args.steps)
    final_loss = (
        float(np.mean(losses[-args.log_every:])) if losses else float("nan")
    )
    logger.info("saved trained params -> %s/params.npz (final loss %.4f "
                "over %d steps)", out, final_loss, len(losses))
    if decoder is None:
        print(f"export EMBEDDING_WEIGHTS_PATH={out}/params.npz")
        print(f"export EMBEDDING_VOCAB_PATH={out}/vocab.txt")
    if args.eval_gate is not None:
        blessed = run_eval_gate(
            state.params(), tok, corpus, out, args.eval_gate, cfg,
            metric=args.gate_metric, device=dev,
        )
        return 0 if blessed else 3
    return 0


def gate_metric_value(tiers: Dict, metric: str) -> float:
    """Extract the gate's scalar from a tier report.

    "paraphrase" = paraphrase pipeline top-1 (the historical bar).
    "blend" = unweighted mean of the four tier headline scores
    (exact/paraphrase/uncertainty pipeline top-1 + multi-diagnosis
    sub-diagnosis top-1) — EVAL_GATE_r04.json showed a candidate losing
    the paraphrase bar while beating the incumbent on two other tiers;
    a blend lets a round decide that trade explicitly.
    """
    if metric == "paraphrase":
        return float(tiers["paraphrase"]["pipeline_top1"])
    if metric == "blend":
        return float(np.mean([
            tiers["exact_title"]["pipeline_top1"],
            tiers["paraphrase"]["pipeline_top1"],
            tiers["uncertainty"]["pipeline_top1"],
            tiers["multi_diagnosis"]["sub_diagnosis_top1"],
        ]))
    raise ValueError(f"unknown gate metric {metric!r}")


def run_eval_gate(params, tok, corpus, out: Path, baseline_arg: str,
                  cfg, metric: str = "paraphrase",
                  device: Union[str, torch.device] = "cuda") -> bool:
    """Post-training quality gate (round-3 lesson: ~5 h of chip time
    shipped an unevaluated regression because nothing forced an eval).

    Embeds the corpus with the freshly trained weights (``params``, a
    JAX-layout tree), builds an in-memory store + the full matcher on
    ``device``, runs the tiered retrieval eval (its searches take the
    store's default method: K1 on the card), and compares the gate metric
    against the incumbent. The result lands in <out>/eval_gate.json with a
    blessed flag; callers must not pair a store with unblessed weights."""
    from ..config import NERConfig
    from ..eval.retrieval import build_eval_set, evaluate
    from ..index.vector_store import VectorStore
    from ..models.encoder import TextEncoder
    from ..pipeline.ner import MedicalNERService
    from ..pipeline.orchestrator import MultiDiagnosisService
    from ..pipeline.textproc import DiagnosisTextProcessor
    from ..tools.build_database import embed_sorted

    baseline = None
    if baseline_arg:
        try:
            baseline = float(baseline_arg)
        except ValueError:
            with open(baseline_arg) as f:
                incumbent = json.load(f)
            baseline = gate_metric_value(incumbent["tiers"], metric)
    logger.info("eval gate: embedding %d semantic texts with the trained "
                "weights (baseline %.4f)", len(corpus), baseline or -1.0)
    encoder = TextEncoder(cfg.encoder, tokenizer=tok, params=params, device=device)
    vectors = embed_sorted(encoder, corpus.semantic_texts)
    store = VectorStore(dim=encoder.dim, config=cfg.store, device=device)
    store.insert_records(list(corpus.records()), vectors)
    ner = MedicalNERService(NERConfig(use_model=False), device=device)
    matcher = MultiDiagnosisService(
        encoder=encoder, store=store, ner_service=ner,
        text_processor=DiagnosisTextProcessor(
            use_enhanced_processing=True, ner_service=ner),
    )
    tiers = build_eval_set(corpus)
    report = evaluate(encoder, store, matcher=matcher, tiers=tiers)
    candidate = gate_metric_value(report["tiers"], metric)
    blessed = baseline is None or candidate >= baseline
    gate = {
        "tiers": report["tiers"],
        "gate_metric": ("paraphrase.pipeline_top1" if metric == "paraphrase"
                        else "blend(4-tier mean)"),
        "candidate": candidate,
        "baseline": baseline,
        "blessed": blessed,
    }
    with open(out / "eval_gate.json", "w") as f:
        json.dump(gate, f, ensure_ascii=False, indent=1)
    logger.info(
        "eval gate: %s %.4f vs baseline %s -> %s",
        gate["gate_metric"], candidate, baseline,
        "BLESSED" if blessed else "REJECTED",
    )
    return blessed


if __name__ == "__main__":
    sys.exit(main())
