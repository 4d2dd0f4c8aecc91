"""Whole runs of the narrowed cell on the CPU, past the look for a card:
sound, it comes out correct; with the timed path broken underneath,
``correct`` comes out false, once for each fault the cell can have: a
step that leaves its state unchanged, half of the batch left out (from
the start, or only from the window's later steps on), and a drawn row
altered where it is produced."""

import time

import numpy as np
import pytest
import torch

from perfbench.drivers import train
from perfbench.tests.pb_tiny import TRAIN, tiny_cell

SEED = 2**31 + 99


def _train(plant=None):
    return train.run(tiny_cell(), SEED, 1.0, False, time.time_ns(), device="cpu", plant=plant)


def _failed(outcome):
    return sorted(k for k, c in outcome.checks.items() if not c["value"] <= c["limit"])


def _step_plant(wrong, after=0):
    """A planted fault in the step, from its ``after``-th call on."""
    def plant(where, x):
        if where != "step":
            return x
        calls = [0]

        def step(state, batch):
            calls[0] += 1
            return wrong(x, state, batch) if calls[0] > after else x(state, batch)
        return step
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


def test_sound_training_run_is_correct():
    out = _train()
    assert out.correct, out.checks
    assert out.attempted >= 1
    assert {"loss_gap", "window_loss_gap", "window_change_gap", "draw_faults"} <= set(out.checks)


def test_step_leaving_state_unchanged_is_caught():
    out = _train(_step_plant(_unchanged))
    assert not out.correct and {"change_gap", "window_change_gap"} <= set(_failed(out))


def test_half_batch_is_caught():
    out = _train(_step_plant(_half))
    assert not out.correct and {"loss_gap", "grad_gap"} & set(_failed(out))


@pytest.mark.parametrize("wrong", [_half, _unchanged], ids=["half_batch", "unchanged"])
def test_fault_only_in_the_window_is_caught(wrong):
    """A step that goes wrong only after its first calls (as one captured
    or compiled after some calls would): the start reads sound, the
    window's steps do not."""
    out = _train(_step_plant(wrong, after=5))
    failed = _failed(out)
    assert not out.correct and failed and all(k.startswith("window_") for k in failed), failed


def _roll(key):
    def change(b):
        b[key] = np.roll(np.asarray(b[key]), 1, axis=0)
    return change


def _cut(b):
    """The positive of row 0 one piece short, ending in [SEP] as a cut
    text does."""
    ids, mask = np.asarray(b["b_ids"]).copy(), np.asarray(b["b_mask"]).copy()
    n = int(mask[0].sum())
    ids[0, n - 2], ids[0, n - 1], mask[0, n - 1] = ids[0, n - 1], 0, 0
    b["b_ids"], b["b_mask"] = ids, mask


def _regroup(b):
    g = np.asarray(b["group_a"]).copy()
    g[0] = g[0] + 100000
    b["group_a"] = g


def _reweight(b):
    w = np.asarray(b["w_b"]).copy()
    w[0] = 1.0 if w[0] != 1.0 else 1.2
    b["w_b"] = w


@pytest.mark.parametrize("change", [_roll("h_ids"), _roll("b_ids"), _cut, _regroup,
                                    _reweight],
                         ids=["hard_negative", "positive", "cut_short", "group", "weight"])
def test_altered_draw_is_caught(change):
    def plant(where, x):
        if where == "draw":
            x = dict(x)
            change(x)
        return x
    out = _train(plant)
    assert not out.correct and "draw_faults" in _failed(out)


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    """The control (the reference in the program's place, fp8 products)
    and the half-batch fault, at the cell's own size on the card: each
    comes out not correct under the cell's limits, the program correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import bench, calibrate
    from perfbench.tests.pb_tiny import benchmark

    b = benchmark()
    cell = bench.Cell.find(b, TRAIN)
    out = calibrate.train_seed(cell, SEED, float(b["run_seconds"]), "cuda")
    lim = cell.limits
    for reading in ("control", "fault_half_batch", "fault_unchanged"):
        assert any(v > lim[k] for k, v in out[reading].items() if k in lim), reading
    assert all(v <= lim[k] for k, v in out["program"].items() if k in lim)
