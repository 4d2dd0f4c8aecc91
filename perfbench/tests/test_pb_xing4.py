"""The Xing4.0 cell narrowed for the CPU: a 64-wide decoder of the cell's
six layers (2 dense, 4 expert layers), latent attention of 2 heads of 16 +
8 rope dimensions with the cell's YaRN scaling, 16 for v, a q and a kv rank
of 32, the cell's 4 residual streams and 20 Sinkhorn steps, a router over
16 experts choosing 4, of which this rank holds 4 (4 expert-parallel
chips), one shared expert, the cell's own traffic and limits over a
1,840-row table. Sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have: among them H_res replaced by the identity, and a row softmax in the
Sinkhorn loop's place. Its FLOPs against a hand count, and its reference
loading nothing of the program.

The narrowed cell takes the cell's limits but for the two loss gaps, which
it takes ``NARROW_LOSS`` times wider. A 64-wide decoder answers bf16
rounding far more strongly than the cell's: sound narrowed runs read loss
gaps of 7.0e-4 to 8.4e-3 and window loss gaps of 1.8e-3 to 0.013 on the
CPU (five seeds), where the cell reads 7.4e-5 to 4.6e-4 and 8.9e-5 to
7.6e-4 on the card. Of the
faults, half the batch reads loss gaps of 0.21 and 0.15; H_res the
identity 0.061 and the row softmax 0.027, each caught by the change gap
too (0.48, 0.74); the unchanged step is caught by the change gaps (1)
and the altered row by the draw."""

import copy
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from perfbench import bench, families
from perfbench.drivers import train
from perfbench.tests.pb_tiny import ROOT, benchmark
from perfbench.tests.test_pb_moonlight import (_altered_draw, _failed, _half, _step_plant,
                                               _unchanged)

CELL = "xing4-29b-a4b-finetune.b256"
SEED = 2**31 + 27
NARROW = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
              num_attention_heads=2, num_key_value_heads=2, kv_lora_rank=32, q_lora_rank=32,
              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=4,
              ep_chips=4, num_experts_per_tok=4)
NARROW_LOSS = 15  # the two loss gaps' limits, times the cell's (the module's note)


def tiny_xing_cell() -> bench.Cell:
    cell = bench.Cell.find(benchmark(), CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(NARROW)
    cfg["store"].update(level_counts=[300, 600, 900], combo_rows=40)
    cell.config = cfg
    tr = copy.deepcopy(cell.traffic)
    tr["argv"] = ["--steps", "16000", "--batch", "32", "--weighted-loss", "--save-every", "0"]
    cell.traffic = tr
    cell.limits = dict(cell.limits, **{k: NARROW_LOSS * cell.limits[k]
                                       for k in ("loss_gap", "window_loss_gap")})
    return cell


def _train(plant=None):
    torch.set_num_threads(2)
    return train.run(tiny_xing_cell(), SEED, 1.0, False, time.time_ns(), device="cpu",
                     plant=plant)


def _with_sinkhorn(fn):
    """A step that runs the program with ``fn`` in place of its Sinkhorn loop."""
    from rag_icd10_tpu_torch.models import xing4 as xg

    def wrong(real, state, batch):
        with mock.patch.object(xg, "sinkhorn", fn):
            return real(state, batch)
    return _step_plant(wrong)


def _identity(logits, iters, eps):
    return torch.eye(logits.shape[-1]).expand(logits.shape)


def _row_softmax(logits, iters, eps):
    return torch.softmax(logits, -1)


def test_sound_run_is_correct():
    out = _train()
    assert out.correct, out.checks
    assert out.attempted >= 1
    assert {"loss_gap", "window_loss_gap", "window_change_gap", "draw_faults"} <= set(out.checks)


@pytest.mark.parametrize("plant", [
    _step_plant(_half), _step_plant(_unchanged), _altered_draw, _with_sinkhorn(_identity),
    _with_sinkhorn(_row_softmax)],
    ids=["half_batch", "unchanged", "drawn_row_altered", "h_res_identity", "sinkhorn_dropped"])
def test_each_fault_is_caught(plant):
    out = _train(plant)
    assert not out.correct and _failed(out), out.checks


def test_step_flops_by_hand():
    cfg = tiny_xing_cell().config
    fam = families.of(cfg)
    h, nh, q_rank, kv_rank = 64, 2, 32, 32
    mla = 2 * (h * q_rank + q_rank * nh * 24 + h * (kv_rank + 8) + kv_rank * nh * (16 + 16)
               + nh * 16 * h)
    mhc = 2 * 4 * h * (24 + 1 + 4 + 1)  # phi's product, H_pre X, H_res X, H_post y
    dense = 6 * h * 128
    expert = 6 * h * 32
    moe = 2 * h * 16 + expert + (4 * 4 / 16) * expert

    def text(n):
        pairs = n * (n + 1) // 2
        return 6 * (n * (mla + 2 * mhc) + 2 * nh * (24 + 16) * pairs) + n * (2 * dense + 4 * moe)

    a, b = [5, 12], [30, 7]
    want = 3 * (text(5) + text(12) + text(30) + text(7) + text(5) + text(12) + 4 * 2 * 2 * h)
    assert fam.step_flops(a, b, a, cfg) == pytest.approx(want)


def test_published_widths_flops():
    """At the cell's own widths: about 880 MFLOP a position forward at a
    48-token text; the dense layers' SwiGLU the largest part, the mixing a
    small share of the FLOPs (its cost is bytes, not FLOPs)."""
    cfg = bench.Cell.find(benchmark(), CELL).config
    fam = families.of(cfg)
    per = fam.text_flops(48, cfg) / 48
    assert 8.5e8 < per < 9.3e8
    assert 0.4 < 2 * 6 * 3584 * 9216 / per < 0.5
    assert 0.005 < 12 * fam.mhc_flops(cfg) / per < 0.02


REF = r"""
import sys
import perfbench.reference.xing4, perfbench.families.xing4_0
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
