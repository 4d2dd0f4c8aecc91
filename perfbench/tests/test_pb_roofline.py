"""Operation counts against hand reckonings at the cell's shapes; no share
can pass 100%."""

import pytest

from perfbench import bench
from perfbench.roofline import H100_SXM, encoder_flops, train_step_flops
from perfbench.tests.pb_tiny import ROOT

CFG = bench.load_json(ROOT / "perfbench" / "configs" / "text2vec-finetune.json")


def test_encoder_flops_by_hand():
    # one 10-token text: 12 layers x (10 x 2 x (4 x 768^2 + 2 x 768 x 3072) + 4 x 100 x 768)
    per_layer = 10 * 2 * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * 100 * 768
    assert encoder_flops([10], CFG) == 12 * per_layer
    assert encoder_flops([10, 10], CFG) == 2 * 12 * per_layer


def test_train_step_flops_by_hand():
    a = [20] * 256
    b = [60] * 256
    f = train_step_flops(a, b, a, CFG)
    fwd = encoder_flops(a, CFG) * 2 + encoder_flops(b, CFG)
    assert f == pytest.approx(3 * (fwd + 4 * 256 * 256 * 768))
    assert 5e12 < f < 25.4e12  # under the padded 25.4 TFLOP of the (48, 96, 48) step


@pytest.mark.parametrize("rows", [1, 8, 64, 256])
def test_shares_cannot_pass_100(rows):
    # a step at exactly the bf16 peak reads 100%
    flops = train_step_flops([12] * rows, [40] * rows, [12] * rows, CFG)
    mfu = bench.read_metric("train_mfu", {
        "window_flops": flops, "window_s": flops / H100_SXM["bf16_flops"],
        "peak_flops": H100_SXM["bf16_flops"]})
    assert mfu == pytest.approx(100.0)
