"""The Kimi-Linear cell narrowed for the CPU: a 64-wide decoder of the
cell's five layers (delta rule, delta rule, delta rule, latent attention,
delta rule; delta-rule layers of 4 heads of 16, latent attention of 2
heads of 16 + 8 rope dimensions, 16 for v, a kv rank of 32), a router over
16 experts choosing 4, of which this rank holds 4 (4 expert-parallel
chips), one shared expert, the cell's own traffic over a 1,840-row table.
Sound, it comes out correct; with the timed path broken underneath,
``correct`` comes out false, once for each fault the cell can have: among
them the delta rule with its decay ignored, and without its erase term
(plain linear attention). Its FLOPs against a hand count, and its
reference loading nothing of the program.

The narrowed cell takes the cell's limits but for the two loss gaps, which
it takes ``NARROW_LOSS`` times wider. A 64-wide decoder answers bf16
rounding far more strongly than the cell's: at 16 dimensions a head the
delta rule's output is large against the gated output norm's eps, and the
norm turns a head's output whole where o's sum cancels near zero
(tests/test_torch_kimi_linear.py's note): sound narrowed runs read loss gaps of
0.022-0.025 and window loss gaps of 0.016-0.030 on the CPU, where the
cell reads 2e-4 to 1.1e-3 and 2.4e-4 to 1.3e-3 on the card. The faults
read 0.088-0.42 (loss) in the narrowed cell, the erase term dropped the
least."""

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

CELL = "kimi-linear-48b-a3b-finetune.b256"
SEED = 2**31 + 77
NARROW = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
              num_attention_heads=2, num_key_value_heads=2, kv_lora_rank=32,
              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, num_experts=4, ep_chips=4,
              num_experts_per_token=4)
LINEAR = dict(head_dim=16, num_heads=4)
NARROW_LOSS = 15  # the two loss gaps' limits, times the cell's (the module's note)


def tiny_kimi_cell() -> bench.Cell:
    cell = bench.Cell.find(benchmark(), CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(NARROW)
    cfg["linear_attn_config"].update(LINEAR)
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
    return train.run(tiny_kimi_cell(), SEED, 1.0, False, time.time_ns(), device="cpu",
                     plant=plant)


def _with_rule(rule):
    """A step that runs the program with ``rule`` in place of its delta rule."""
    from rag_icd10_tpu_torch.models import kimi_linear as kl

    def wrong(real, state, batch):
        with mock.patch.object(kl, "kda", rule):
            return real(state, batch)
    return _step_plant(wrong)


def _no_decay(q, k, v, g, beta):
    from rag_icd10_tpu_torch.ops.kda import kda
    return kda(q, k, v, torch.zeros_like(g), beta)


def _no_erase(q, k, v, g, beta):
    """Linear attention with the decay and beta: S <- Diag(exp g) S + beta k
    v^T, the write without the delta rule's erase of what k held."""
    d = q.shape[-1]
    q, k, v = (t.float() for t in (q, k, v))
    q = q * torch.rsqrt(q.pow(2).sum(-1, keepdim=True) + 1e-6) * d ** -0.5
    k = k * torch.rsqrt(k.pow(2).sum(-1, keepdim=True) + 1e-6)
    state = q.new_zeros(q.shape[0], q.shape[2], d, v.shape[-1])
    out = []
    for t in range(q.shape[1]):
        state = state * torch.exp(g[:, t])[..., None] \
            + k[:, t, :, :, None] * (beta[:, t, :, None] * v[:, t])[:, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return torch.stack(out, 1)


def test_sound_run_is_correct():
    out = _train()
    assert out.correct, out.checks
    assert out.attempted >= 1
    assert {"loss_gap", "window_loss_gap", "window_change_gap", "draw_faults"} <= set(out.checks)


@pytest.mark.parametrize("plant", [
    _step_plant(_half), _step_plant(_unchanged), _altered_draw, _with_rule(_no_decay),
    _with_rule(_no_erase)],
    ids=["half_batch", "unchanged", "drawn_row_altered", "decay_ignored", "erase_dropped"])
def test_each_fault_is_caught(plant):
    out = _train(plant)
    assert not out.correct and _failed(out), out.checks


def test_step_flops_by_hand():
    cfg = tiny_kimi_cell().config
    fam = families.of(cfg)
    h, nh, d, heads, width = 64, 2, 16, 4, 64
    kda = 2 * (h * (3 * width + 2 * d + heads) + 2 * d * width + width * h) \
        + 2 * 3 * width * 4 + 7 * d * d * heads
    mla = 2 * (h * nh * 24 + h * (32 + 8) + 32 * nh * (16 + 16) + nh * 16 * h)
    dense = 6 * h * 128
    expert = 6 * h * 32
    moe = 2 * h * 16 + expert + (4 * 4 / 16) * expert

    def text(n):
        pairs = n * (n + 1) // 2
        return n * (4 * kda + mla + dense + 4 * moe) + 2 * nh * (24 + 16) * pairs

    a, b = [5, 12], [30, 7]
    want = 3 * (text(5) + text(12) + text(30) + text(7) + text(5) + text(12) + 4 * 2 * 2 * h)
    assert fam.step_flops(a, b, a, cfg) == pytest.approx(want)


def test_published_widths_flops():
    """At the cell's own widths: about 600 MFLOP a position forward at a
    48-token text, over half of it in the four delta-rule layers, whose
    recurrence is a small share of them."""
    cfg = bench.Cell.find(benchmark(), CELL).config
    fam = families.of(cfg)
    per = fam.text_flops(48, cfg) / 48
    assert 5.7e8 < per < 6.3e8
    one_layer = dict(cfg, num_hidden_layers=1)  # the dense delta-rule layer alone
    kda = fam.text_flops(48, one_layer) / 48 - 6 * 2304 * 9216
    assert 0.5 < 4 * kda / per < 0.6
    assert 7 * 128 * 128 * 32 / kda < 0.05


REF = r"""
import sys
import perfbench.reference.kimi_linear, perfbench.families.kimi_linear
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
