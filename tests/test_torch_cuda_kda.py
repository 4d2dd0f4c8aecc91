"""The gated delta rule's kernels (ops/kda.py ``kda``, ops/csrc/kda.cu) on a
card, against the plain version (``kda_reference``) on the same card with
TF32 off. These tests need an NVIDIA GPU; they carry the ``gpu`` marker and
skip elsewhere. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_kda.py -m gpu --noconftest -q

Every case holds the output and the gradients of all five inputs (q, k, v,
g, beta) under one random weighting of o, with 32 heads of 128 whose
log-decays reach 10 nats a token in the fastest head (a chunk of 48 passes
88 nats, where exp(Gamma_t) exp(-Gamma_j) would overflow fp32), and every
output and gradient finite. Limits, over the largest magnitude of each
tensor on the plain side:

- fp32 results (o, and the gradients of fp32 inputs): 2e-5 for o and 1e-4
  for the gradients, the CPU tests' limits of the plain version against the
  token loop in fp64 (tests/test_torch_kimi_linear.py), which both versions
  meet: they sum the same products in other orders (cuBLAS against each
  thread's fixed order), and the decays are exponentials of differences of
  cumulative sums;
- bf16 gradients (q, k, v in bf16, as the Kimi cell feeds them): 2^-7, one
  bf16 rounding step of the largest element: both sides compute the
  gradient in fp32 and round it to bf16 once, and two fp32 values within
  1e-6 of each other can round one step apart.

A gradient's largest magnitude is taken as at least 1e-3 of the largest of
the five (as the CPU tests do): at S = 1 the decay takes no gradient, and
the two sides' round-off there is no scale of its own.

The cases: the cell's two shapes (512 rows of 48, 256 of 96) with bf16 q, k,
v in the convolutions' layout (token stride 1); fp32 inputs at 4 x 48 and 2
x 96; ragged lengths 1, 31, 50 and 97 (a partial last chunk, and 97 three
chunks). Beside them: the launches and counters of a call, repeatability to
the bit, and the ValueError for what the kernels do not take on a card.
"""

import pytest
import torch

from rag_icd10_tpu_torch.ops import kda as kda_op
from rag_icd10_tpu_torch.utils.metrics import metrics

pytestmark = pytest.mark.gpu

HEADS, D = 32, 128
O_LIMIT, GRAD_LIMIT, BF16_GRAD_LIMIT = 2e-5, 1e-4, 2 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, rows, s, dtype, conv_layout, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def x():
        if conv_layout:  # (B, H x D, S) transposed, as the short convolutions give
            t = torch.randn(rows, HEADS * D, s, generator=gen, device=device)
            return t.to(dtype).transpose(1, 2).unflatten(-1, (HEADS, D))
        return torch.randn(rows, s, HEADS, D, generator=gen, device=device).to(dtype)

    q, k, v = x(), x(), x()
    g = -torch.rand(rows, s, HEADS, D, generator=gen, device=device) * torch.logspace(
        -2, 1, HEADS, device=device)[:, None]  # slow heads to 10 nats a token
    beta = torch.rand(rows, s, HEADS, generator=gen, device=device)
    return q, k, v, g, beta


def _gap(a, b, floor=0.0) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), floor, 1e-30)


def _compare(device, rows, s, dtype=torch.float32, conv_layout=False, seed=0):
    inputs = _inputs(device, rows, s, dtype, conv_layout, seed)
    ours = [t.detach().clone().requires_grad_(True) for t in inputs]
    theirs = [t.detach().clone().requires_grad_(True) for t in inputs]
    if conv_layout:  # the clones keep the layout the kernels read in place
        assert ours[0].stride()[1] == 1
    o = kda_op.kda(*ours)
    o_ref = kda_op.kda_reference(*theirs)
    weight = torch.randn(o.shape, generator=torch.Generator(device=device).manual_seed(seed + 1),
                         device=device)
    (o * weight).sum().backward()
    (o_ref * weight).sum().backward()
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and o.shape == o_ref.shape
    assert torch.isfinite(o).all()
    gaps = {"o": _gap(o, o_ref)}
    largest = max(float(t.grad.abs().max()) for t in theirs)
    for name, a, b in zip(("q", "k", "v", "g", "beta"), ours, theirs):
        assert a.grad.dtype == a.dtype and a.grad.shape == a.shape
        assert torch.isfinite(a.grad).all(), name
        gaps[name] = _gap(a.grad, b.grad, 1e-3 * largest)
    print(f"kda {rows}x{s} {dtype} {'conv layout' if conv_layout else ''}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
    assert gaps["o"] <= O_LIMIT
    for name in ("q", "k", "v"):
        assert gaps[name] <= (BF16_GRAD_LIMIT if dtype == torch.bfloat16 else GRAD_LIMIT), name
    assert gaps["g"] <= GRAD_LIMIT and gaps["beta"] <= GRAD_LIMIT


@pytest.mark.parametrize("rows,s", [(512, 48), (256, 96)])
def test_the_cells_shapes_in_bf16_as_the_convolutions_give_them(cuda, rows, s):
    _compare(cuda, rows, s, torch.bfloat16, conv_layout=True, seed=rows)


@pytest.mark.parametrize("rows,s", [(4, 48), (2, 96)])
def test_fp32_inputs(cuda, rows, s):
    _compare(cuda, rows, s, seed=s)


@pytest.mark.parametrize("s", [1, 31, 50, 97])
def test_ragged_lengths(cuda, s):
    _compare(cuda, 2, s, seed=s)


def test_a_call_launches_once_each_way_and_counts(cuda):
    inputs = [t.detach().requires_grad_(True)
              for t in _inputs(cuda, 2, 96, torch.bfloat16, True, 3)]
    before = dict(metrics.counters("kda."))
    launches = kda_op.kda.launches
    o = kda_op.kda(*inputs)
    assert kda_op.kda.launches == launches + 1
    o.sum().backward()
    torch.cuda.synchronize()
    assert kda_op.kda.launches == launches + 2
    after = metrics.counters("kda.")
    for key in ("kda.core_calls", "kda.kernel_calls"):
        assert after.get(key, 0) - before.get(key, 0) == 1, key
    with torch.no_grad():  # no gradient wanted: no states saved, one launch
        kda_op.kda(*inputs)
    assert kda_op.kda.launches == launches + 3


def test_a_call_repeats_to_the_bit(cuda):
    inputs = _inputs(cuda, 8, 97, torch.bfloat16, True, 5)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        o = kda_op.kda(*leaves)
        o.square().sum().backward()
        runs.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_what_the_kernels_do_not_take_raises_on_a_card(cuda):
    q, k, v, g, beta = _inputs(cuda, 1, 8, torch.float32, False, 0)
    with pytest.raises(ValueError):
        kda_op.kda(q.half(), k.half(), v.half(), g, beta)
    with pytest.raises(ValueError):
        kda_op.kda(q[..., :64], k[..., :64], v[..., :64], g[..., :64], beta)
    with pytest.raises(ValueError):
        kda_op.kda(q, k, v, g.cpu(), beta)
