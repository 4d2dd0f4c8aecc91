"""A configuration, traffic mix or metric file dropped into a copy of the
benchmark is found by its name, without an edit to any other file."""

import json
import shutil

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
