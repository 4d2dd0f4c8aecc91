"""Retrieval-quality eval CLI over the port's Engine.

Counterpart of rag_icd10_tpu/tools/eval_retrieval.py: builds the tiered
eval set from the corpus (eval/retrieval.py), runs raw retrieval and
full-pipeline scoring against the CURRENT store/encoder pairing (the
<db>.encoder.json sidecar decides the weights, exactly as serving does),
and writes a JSON report. Runs on ``cuda`` unless ``main(...,
device="cpu")``; the JAX tool's TPU device watchdog has no counterpart.

    python -m rag_icd10_tpu_torch.tools.eval_retrieval --out EVAL.json
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Union

import torch

logger = logging.getLogger("rag_icd10_tpu_torch.eval")


def main(argv=None, device: Union[str, torch.device] = "cuda") -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="EVAL.json")
    parser.add_argument("--top-k", type=int, default=10)
    parser.add_argument("--n-exact", type=int, default=400)
    parser.add_argument("--n-paraphrase", type=int, default=400)
    parser.add_argument("--n-uncertainty", type=int, default=300)
    parser.add_argument("--n-multi", type=int, default=150)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--no-pipeline", action="store_true",
                        help="raw retrieval only (skip matcher tiers)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from ..eval.retrieval import (
        build_eval_set,
        evaluate,
        run_canonical,
        save_report,
    )
    from ..runtime import Engine

    engine = Engine(device=device)
    engine.init_encoder()
    store = engine.init_store()
    if not store.num_entities:
        logger.error("no persisted store — run tools/build_database first")
        return 1
    matcher = None if args.no_pipeline else engine.init_matcher()

    tiers = build_eval_set(
        store.corpus,
        n_exact=args.n_exact,
        n_paraphrase=args.n_paraphrase,
        n_uncertainty=args.n_uncertainty,
        n_multi=args.n_multi,
        seed=args.seed,
    )
    for t in tiers:
        logger.info("tier %s: %d cases", t.name, len(t.cases))
    report = evaluate(
        engine.encoder, store, matcher=matcher, tiers=tiers, top_k=args.top_k
    )
    report["encoder"] = engine.encoder.get_model_info()
    if matcher is not None:
        logger.info("running canonical reference texts...")
        report["canonical"] = run_canonical(matcher)
    save_report(report, args.out)
    logger.info("report -> %s", args.out)
    print(json.dumps(report["tiers"], ensure_ascii=False, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
