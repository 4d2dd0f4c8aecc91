"""Narrowed cells for the harness's CPU tests: the cells' own traffic and
limits over a two-layer, 64-wide BERT and a 1,840-row table."""

from __future__ import annotations

import copy
from pathlib import Path

from perfbench import bench

ROOT = Path(__file__).resolve().parents[2]
TRAIN = "text2vec-finetune.b256"


def benchmark() -> dict:
    return bench.load_json(ROOT / "BENCHMARK.json")


def tiny_cell(name: str = TRAIN) -> bench.Cell:
    cell = bench.Cell.find(benchmark(), name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
    cfg["store"].update(level_counts=[300, 600, 900], combo_rows=40)
    cell.config = cfg
    tr = copy.deepcopy(cell.traffic)
    tr["argv"] = ["--steps", "16000", "--batch", "32", "--weighted-loss", "--save-every", "0"]
    cell.traffic = tr
    return cell
