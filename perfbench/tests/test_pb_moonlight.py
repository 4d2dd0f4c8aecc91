"""The Moonlight cell narrowed for the CPU: a 64-wide DeepSeek-V3 decoder
(2 heads of 16 + 8 rope dimensions, 16 for v, a kv rank of 32), the
dense layer and 2 expert layers, a router over 16 experts choosing 3, of
which this rank holds 4 (4 expert-parallel chips), 2 shared experts, the
cell's own traffic and limits over a 1,840-row table. Sound, it comes out
correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault the cell can have. Its FLOPs against a hand
count, its reference loading nothing of the program, and the counter
reader."""

import copy
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import bench, families
from perfbench.drivers import train
from perfbench.readers import program_span
from perfbench.tests.pb_tiny import ROOT, benchmark

CELL = "moonlight-16b-a3b-finetune.b256"
SEED = 2**31 + 99
NARROW = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
              num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32,
              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4,
              ep_chips=4, num_experts_per_tok=3)


def tiny_moonlight_cell() -> bench.Cell:
    cell = bench.Cell.find(benchmark(), CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(NARROW)
    cfg["store"].update(level_counts=[300, 600, 900], combo_rows=40)
    cell.config = cfg
    tr = copy.deepcopy(cell.traffic)
    tr["argv"] = ["--steps", "16000", "--batch", "32", "--weighted-loss", "--save-every", "0"]
    cell.traffic = tr
    return cell


def _train(plant=None, trace=False):
    torch.set_num_threads(2)
    return train.run(tiny_moonlight_cell(), SEED, 1.0, trace, time.time_ns(), device="cpu",
                     plant=plant)


def _failed(outcome):
    return sorted(k for k, c in outcome.checks.items() if not c["value"] <= c["limit"])


def _step_plant(wrong):
    def plant(where, x):
        return (lambda state, batch: wrong(x, state, batch)) if where == "step" else x
    return plant


def _unchanged(real, state, batch):
    keep = [p.detach().clone() for p in state.model.parameters()]
    m = real(state, batch)
    with torch.no_grad():
        for p, k in zip(state.model.parameters(), keep):
            p.copy_(k)
    return m


def _half(real, state, batch):
    return real(state, {k: np.asarray(v)[: np.asarray(v).shape[0] // 2] for k, v in batch.items()})


def _no_correction_bias(real, state, batch):
    """The program chooses experts without its correction biases."""
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            if name.endswith("e_score_correction_bias"):
                buf.zero_()
    return real(state, batch)


def _no_shared_experts(real, state, batch):
    for layer in state.model.model.layers:
        shared = getattr(layer.mlp, "shared_experts", None)
        if shared is not None:
            shared.forward = lambda x: torch.zeros_like(x, dtype=torch.bfloat16)
    return real(state, batch)


def _altered_draw(where, x):
    if where == "draw":
        x = dict(x)
        x["h_ids"] = np.roll(np.asarray(x["h_ids"]), 1, axis=0)
    return x


def test_sound_run_is_correct():
    out = _train()
    assert out.correct, out.checks
    assert out.attempted >= 1
    assert {"loss_gap", "grad_gap", "window_change_gap", "draw_faults"} <= set(out.checks)


@pytest.mark.parametrize("plant", [
    _step_plant(_half), _step_plant(_unchanged), _altered_draw,
    _step_plant(_no_correction_bias), _step_plant(_no_shared_experts)],
    ids=["half_batch", "unchanged", "drawn_row_altered", "correction_bias_ignored",
         "shared_experts_left_out"])
def test_each_fault_is_caught(plant):
    out = _train(plant)
    assert not out.correct and _failed(out), out.checks


def test_traced_run_reads_the_expert_counters():
    from rag_icd10_tpu_torch.utils.metrics import metrics

    metrics.reset()
    cell = tiny_moonlight_cell()
    out = train.run(cell, SEED, 1.0, True, time.time_ns(), device="cpu")
    line = bench.result_line(out, cell.per_layer, True)
    load = line["metrics"]["moe_load_imbalance.train"]["value"]
    held = metrics.counters("moe.held_slots.")
    assert sorted(held) == ["moe.held_slots.1", "moe.held_slots.2"]
    assert all(v.shape == (4,) for v in held.values())
    expect = np.mean([v.max() / v.mean() for v in held.values()])
    assert load == pytest.approx(expect) and load >= 1.0


def test_imbalance_reader_reads_none_without_counters(monkeypatch):
    class Parent:  # the registry before it kept counters
        def spans(self, *a):
            return []

    monkeypatch.setattr(program_span, "registry", lambda: Parent())
    assert bench.read_metric("moe_load_imbalance.train", {}) is None

    class Counting(Parent):
        def counters(self, prefix=""):
            return {"moe.held_slots.1": np.array([1, 3]), "moe.held_slots.2": np.array([2, 2])}

    monkeypatch.setattr(program_span, "registry", lambda: Counting())
    assert bench.read_metric("moe_load_imbalance.train", {}) == pytest.approx((1.5 + 1.0) / 2)


def test_step_flops_by_hand():
    cfg = tiny_moonlight_cell().config
    fam = families.of(cfg)
    h, nh = 64, 2
    mla = 2 * (h * nh * 24 + h * (32 + 8) + 32 * nh * (16 + 16) + nh * 16 * h)
    dense = 6 * h * 128
    expert = 6 * h * 32
    moe = 2 * h * 16 + 2 * expert + (3 * 4 / 16) * expert

    def text(n):
        pairs = n * (n + 1) // 2
        return 3 * (n * mla + 2 * nh * (24 + 16) * pairs) + n * (dense + 2 * moe)

    a, b = [5, 12], [30, 7]
    want = 3 * (text(5) + text(12) + text(30) + text(7) + text(5) + text(12) + 4 * 2 * 2 * h)
    assert fam.step_flops(a, b, a, cfg) == pytest.approx(want)


def test_published_widths_flops():
    """At the cell's own widths: about 470 MFLOP a position forward at a
    48-token text, the new mechanisms most of them."""
    cfg = bench.Cell.find(benchmark(), CELL).config
    fam = families.of(cfg)
    per = fam.text_flops(48, cfg) / 48
    assert 4.4e8 < per < 4.9e8
    dense_share = 6 * 2048 * 11264 / per
    assert 0.25 < dense_share < 0.35  # the rest is MLA and the expert layers


REF = r"""
import sys
import perfbench.reference.deepseek_v3, perfbench.families.deepseek_v3
print("PROG", sorted(m for m in sys.modules if m.split(".")[0] == "rag_icd10_tpu_torch"))
"""


def test_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REF], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PROG []" in out.stdout


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    """The control (the reference in the program's place, fp8 products)
    and the half-batch fault at the cell's own size on the card: each
    comes out not correct under the cell's limits, the program correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import calibrate

    b = benchmark()
    cell = bench.Cell.find(b, CELL)
    out = calibrate.train_seed(cell, SEED, float(b["run_seconds"]), "cuda")
    lim = cell.limits
    for reading in ("control", "fault_half_batch", "fault_unchanged"):
        assert any(v > lim[k] for k, v in out[reading].items() if k in lim), reading
    assert all(v <= lim[k] for k, v in out["program"].items() if k in lim), out["program"]
