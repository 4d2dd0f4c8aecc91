"""Run one cell of the benchmark and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the repository root. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, last, ``checks``: each number compared
with the plain reference beside its limit. The same numbers close
standard error. Without enough CUDA devices, or where the program or a
file of the benchmark is missing, it exits non-zero and prints no result.
"""

from __future__ import annotations

T_START_NS = None


def main(argv=None) -> int:
    import argparse
    import importlib
    import json
    import os
    import sys
    from pathlib import Path

    from . import bench

    parser = argparse.ArgumentParser(description="Run one benchmark cell.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    root = Path.cwd()
    bench_file = root / "BENCHMARK.json"
    if not bench_file.exists():
        print("BENCHMARK.json not found in the working directory", file=sys.stderr)
        return 2
    spec = bench.load_json(bench_file)
    try:
        cell = bench.Cell.find(spec, args.workload)
    except StopIteration:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    # caches inside the checkout at fixed paths; the program's kernels
    # build into build/torch_kernels/ (ops/cuda_build.py)
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "perfbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "perfbench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    try:
        importlib.import_module("rag_icd10_tpu_torch")
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2

    driver = importlib.import_module(f"perfbench.drivers.{cell.config['driver']}")
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         t_start_ns=T_START_NS or bench.process_start_ns(), device="cuda")
    bad = bench.forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package are loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    metrics = cell.per_layer if args.trace else cell.end_to_end
    line = bench.json_safe(bench.result_line(outcome, metrics, bool(args.trace)))
    for note in outcome.notes:
        print(note, flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    from .bench import process_start_ns

    T_START_NS = process_start_ns()
    sys.exit(main())
