"""Readings that the limits of ``limits/<config>.json`` are set from.

    python3 -m perfbench.calibrate --workload <name> --seeds 1 2 3 ... --seconds 10

For each seed, in one process: the cell's set-up and its window, then the
numbers ``correct`` compares, read against the fp32 reference for the
program (the lower reading), for the control (the reference put in the
program's place one precision below the configuration's: fp8 matrix
products for the bf16 step) and for planted faults (half of each batch
left out; a step that leaves its state unchanged, which reads 1 by the
measure and needs no run). One JSON line a seed. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch


def _free(device):
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def train_seed(cell, seed, seconds, device):
    from .drivers import train
    from .reference.lowp import fp8

    cfg = cell.config
    tr, inp, _ = train.train_window(cell, seed, seconds, False, device)
    w0, port_name = inp["w0"], tr.port_name
    faults, batches, _ = train.rebuild(cell, tr, inp["corpus"])
    ref = train.reference_runs(cfg, tr, w0, batches, device)
    _free(device)

    def as_program(r):
        """A reference run in the program's place."""
        out = {}
        for part in ("start", "window"):
            x = r[part]
            out[part] = {"losses": x["losses"],
                         "grad0": {port_name(k)[0]: v for k, v in x["grad0"].items()},
                         "change": {port_name(k)[0]: v for k, v in x["change"].items()}}
        return out

    def read(p):
        start = train.compare(p["start"]["losses"], p["start"]["grad0"], p["start"]["change"],
                              ref["start"], w0, port_name)
        window = train.compare(p["window"]["losses"], p["window"]["grad0"],
                               p["window"]["change"], ref["window"], w0, port_name)
        return dict(start, **{f"window_{k}": v for k, v in window.items()})

    out = {"seed": seed, "draw_faults": faults, "snap_step": tr.snap_step,
           "window_steps": tr.window_steps, "program": train.numbers(tr, w0, ref)}
    for name, kw in (("control", {"rnd": fp8}), ("fault_half_batch", {"half": True})):
        out[name] = read(as_program(train.reference_runs(cfg, tr, w0, batches, device, **kw)))
        _free(device)
    out["fault_unchanged"] = {"change_gap": 1.0, "window_change_gap": 1.0}
    del tr, inp
    _free(device)
    return out


def main(argv=None) -> int:
    from . import bench

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    cell = bench.Cell.find(bench.load_json(Path.cwd() / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t = time.time()
        out = train_seed(cell, seed, args.seconds, "cuda")
        out["seconds"] = time.time() - t
        out["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
