"""What every cell's run shares: the benchmark file, the cell's files,
the result line, and the checks a run must pass whatever its cell."""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_icd10_tpu")


def process_start_ns() -> int:
    """Wall-clock time at which this process started (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time_ns() - int(max(age, 0.0) * 1e9)
    except (OSError, ValueError, IndexError):
        return time.time_ns()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``rag_icd10_tpu_torch`` is not ``rag_icd10_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @classmethod
    def find(cls, bench: Dict, name: str, root: Path = HERE) -> "Cell":
        entry = next(w for w in bench["workloads"] if w["name"] == name)
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        repo = root.parent
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moves = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
        return cls(
            name=name, entry=entry,
            config=load_json(repo / conf["file"]),
            traffic=load_json(root / "traffic" / f"{entry['traffic']}.json"),
            limits=load_json(root / "limits" / f"{entry['config']}.json"),
            end_to_end=e2e, per_layer=layer,
        )


@dataclass
class Outcome:
    """What a driver hands back: the readers' data, the counts, the
    numbers compared with their limits, and the device."""

    data: Dict[str, Any]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    device: Dict[str, Any]
    breakdown: Optional[Dict] = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in self.checks.values())


def read_metric(name: str, data: Dict, root: Path = HERE) -> Optional[float]:
    """The metric's file ``metrics/<name>.json`` names its reader
    (``readers/<reader>.py``) and the reader's parameters. A reader that
    finds nothing returns None."""
    spec = load_json(root / "metrics" / f"{name}.json")
    reader = importlib.import_module(f"perfbench.readers.{spec['reader']}")
    return reader.read(data, spec)


def result_line(outcome: Outcome, metrics: List[Dict], trace: bool) -> Dict:
    values: Dict[str, Dict] = {}
    for m in metrics:
        try:
            v = read_metric(m["name"], outcome.data)
        except (KeyError, ValueError, ZeroDivisionError, FileNotFoundError) as e:
            print(f"metric {m['name']}: not read ({type(e).__name__}: {e})", file=sys.stderr)
            v = None
        if v is None:
            print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
            continue
        values[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": values,
        "device": outcome.device,
    }
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in outcome.checks.items()}
    return line


def json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    return x
