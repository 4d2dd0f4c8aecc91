"""Interactive demo CLI — query the engine from the terminal.

    python -m rag_icd10_tpu_torch.demo "急性胃肠炎，高血压病3级" [--top-k 5]
    python -m rag_icd10_tpu_torch.demo            # interactive loop

The engine equivalent of the reference services' module-level main()
smoke runners (SURVEY.md §4).
"""

from __future__ import annotations

import argparse
import sys


def render(result: dict) -> None:
    print(f"\n原文: {result['original_text']}")
    print(f"提取诊断: {'、'.join(result['extracted_diagnoses']) or '(无)'}")
    for m in result["matches"]:
        print(f"\n◆ {m.diagnosis_text}  "
              f"(置信度 {m.match_confidence:.2f} · {m.confidence_level})")
        for i, c in enumerate(m.candidates, 1):
            print(f"  {i}. {c.code:<12} {c.title}  [{c.score:.3f}]")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("text", nargs="?", default=None)
    parser.add_argument("--top-k", type=int, default=5)
    args = parser.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from .runtime import Engine

    engine = Engine()
    engine.startup(warmup=False)
    matcher = engine.init_matcher()

    if args.text:
        render(matcher.match_multiple_diagnoses(args.text, top_k=args.top_k))
        return 0
    print("输入诊断文本（空行退出）:")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            break
        render(matcher.match_multiple_diagnoses(line, top_k=args.top_k))
    return 0


if __name__ == "__main__":
    sys.exit(main())
