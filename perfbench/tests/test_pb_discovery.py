"""A configuration, traffic mix, metric file or model family dropped into a
copy of the benchmark is found by its name, without an edit to any other
file."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import bench
from perfbench.tests.pb_tiny import ROOT, benchmark


def test_new_files_are_found(tmp_path):
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb, ignore=shutil.ignore_patterns("__pycache__"))
    b = benchmark()
    cfg = bench.load_json(pb / "configs" / "text2vec-finetune.json")
    (pb / "configs" / "text2vec-finetune-long.json").write_text(
        json.dumps(dict(cfg, name="x", train=dict(cfg["train"], seq_b=128))))
    tr = bench.load_json(pb / "traffic" / "b256.json")
    (pb / "traffic" / "b128.json").write_text(
        json.dumps(dict(tr, argv=["--steps", "16000", "--batch", "128"])))
    shutil.copy(pb / "limits" / "text2vec-finetune.json",
                pb / "limits" / "text2vec-finetune-long.json")
    (pb / "metrics" / "steps_per_s.json").write_text(
        json.dumps({"reader": "rate", "count": "window_steps", "seconds": "window_s"}))
    b["configs"].append({"name": "text2vec-finetune-long", "source": "x",
                         "file": "perfbench/configs/text2vec-finetune-long.json", "reduced": [],
                         "why": "x"})
    b["workloads"].append({"name": "text2vec-finetune-long.b128",
                           "config": "text2vec-finetune-long", "traffic": "b128", "chips": 1,
                           "why": "x"})
    b["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["text2vec-finetune-long.b128"]})
    cell = bench.Cell.find(b, "text2vec-finetune-long.b128", root=pb)
    assert cell.traffic["argv"][3] == "128" and cell.config["train"]["seq_b"] == 128
    assert {m["name"] for m in cell.end_to_end} == {"steps_per_s", "setup_s"}
    assert cell.per_layer == []
    assert bench.read_metric("steps_per_s", {"window_steps": 50, "window_s": 10.0},
                             root=pb) == 5.0


TOY_FAMILY = '''"""A family that hands every call to BERT's and notes which it got."""
from . import bert

CALLS = set()


def _noted(name):
    def call(*a, **kw):
        CALLS.add(name)
        return getattr(bert, name)(*a, **kw)
    return call


start_leaves, hand_over, program_config, port_name, loss, step_flops = map(
    _noted, ("start_leaves", "hand_over", "program_config", "port_name", "loss", "step_flops"))
'''

TOY_RUN = r"""
import json, time
from perfbench import families
from perfbench.drivers import train
from perfbench.tests.pb_tiny import tiny_cell
cell = tiny_cell("toy-encoder.b256")
out = train.run(cell, 2**31 + 5, 1.0, False, time.time_ns(), device="cpu")
fam = families.of(cell.config)
print(json.dumps({"file": fam.__file__, "calls": sorted(fam.CALLS), "correct": out.correct}))
"""


def test_new_family_is_found_and_dispatched(tmp_path):
    """A configuration whose ``model_type`` names a family module dropped
    into a copy of the benchmark is held to its own published file, and a
    run of its narrowed cell goes through that module for everything
    specific to the model: only new files, none edited."""
    from perfbench.tests.test_pb_files import cut_faults

    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb, ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "families" / "toy_bert.py").write_text(TOY_FAMILY)
    for part in ("configs", "published"):
        src = bench.load_json(pb / part / "text2vec-finetune.json")
        (pb / part / "toy-encoder.json").write_text(json.dumps(dict(src, model_type="toy-bert")))
    shutil.copy(pb / "limits" / "text2vec-finetune.json", pb / "limits" / "toy-encoder.json")
    b = benchmark()
    conf = dict(b["configs"][0], name="toy-encoder", file="perfbench/configs/toy-encoder.json")
    b["configs"].append(conf)
    b["workloads"].append(dict(b["workloads"][0], name="toy-encoder.b256", config="toy-encoder"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("toy-encoder.b256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    assert cut_faults(conf, tmp_path) == []

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert Path(got["file"]) == pb / "families" / "toy_bert.py"
    assert got["calls"] == sorted(["start_leaves", "hand_over", "program_config", "port_name",
                                   "loss", "step_flops"])
    assert got["correct"]
