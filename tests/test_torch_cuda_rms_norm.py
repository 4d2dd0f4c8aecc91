"""The residual add + RMSNorm kernels (ops/csrc/rms_norm.cu: rms_norm_fwd,
rms_norm_bwd, rms_norm_dw, bound by ops/rms_norm.py) on a card, against
their plain version run on the same card from the same inputs. These tests
need an NVIDIA GPU; they carry the ``gpu`` marker and skip elsewhere. The
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_rms_norm.py -m gpu --noconftest -q

The Moonlight cell's sites at its row count (T = 24,576 positions a call:
512 rows of 48, 256 of 96): hidden (2048 wide) with a bf16 branch (the
attention's or the dense MLP's output) or an fp32 one (an expert layer's),
or none (layer 0's input); the latent (512 wide, kv_a_layernorm) read in
place as the first 512 of 576 bf16 columns; outputs as the consumers take
them (two bf16 copies for q_proj and kv_a_proj_with_mqa or gate_proj and
up_proj; fp32 for an expert layer's router, gather and shared experts, or
the pooling); the most a site may ask for (one fp32 output and two bf16);
and the tests' fp32 model. The Kimi cell's seven sites at its hidden width,
2304 (a block of 288 threads a row), named by the layer that reads them:
layer 1's input (the embedding, no branch; one bf16 copy for the delta
rule's six projections), its dense MLP's input (the delta rule's bf16
output added; two bf16), layer 2's input (the dense MLP's bf16 output
added; one bf16), each expert layer's input (a bf16 branch; fp32 out),
the delta rule's input after an expert layer (an fp32 branch; one bf16),
the latent attention's input after one (an fp32 branch; two bf16), and
the final norm (an fp32 branch; fp32 out). The Xing4.0 cell's sites, with
no branch (its stream update is the hyper-connection's): each sublayer's
input h at 3584 (a block of 448 threads a row) with two bf16 copies (the
attention's, the dense MLP's) or fp32 (an expert layer's, the final
norm), and q_a_layernorm at 768 (two rows a block of 192 threads), bf16
in and out (and fp32, the tests' fp32 model). Inputs are seeded normals,
weights near 1.

Tolerances, each with its reason (max |difference| over max |plain|):

- x_new: bit for bit (one fp32 add, as the plain chain's).
- fp32 y and rstd: 2e-6. The sum of squares in another order (fp32, 2048
  terms) and rsqrtf against torch's rsqrt: a few fp32 ulps.
- fp32 gradients of x: 2e-5; of the weight: 2e-5 (a sum over 24,576 rows
  in another order).
- bf16 y, and the bf16 gradient of the branch (or of a bf16 x): 2^-7. Both
  sides round an fp32 value to bf16 once; where the kernel's fp32 value
  differs from the plain one by a few ulps, the rounding can land on the
  neighbouring bf16 value, one bf16 step (at most 2^-7 of the largest
  element).
"""

import pytest
import torch

from rag_icd10_tpu_torch.ops import rms_norm
from rag_icd10_tpu_torch.utils.metrics import metrics

pytestmark = pytest.mark.gpu

BF, F32 = torch.bfloat16, torch.float32
T_ROWS = (512, 48)  # one call's positions: 24,576
LATENT, ROPE = 512, 64

SITES = {  # name: (width, x dtype, branch dtype, outputs, x read in place from a wider row)
    "hidden_bf16_branch": (2048, F32, BF, (BF, BF), False),
    "hidden_after_experts": (2048, F32, F32, (BF, BF), False),
    "final_norm": (2048, F32, BF, (F32,), False),  # and each expert layer's input
    "layer0_input": (2048, F32, None, (BF, BF), False),
    "latent": (LATENT, BF, None, (BF,), True),
    "fp32_hidden": (2048, F32, F32, (F32, F32), False),
    "fp32_latent": (LATENT, F32, None, (F32,), True),
    "fp32_and_two_bf16": (2048, F32, F32, (F32, BF, BF), False),
} | {f"kimi_{name}": site for name, site in {  # the Kimi cell's, at 2304
    "embedding": (2304, F32, None, (BF,), False),
    "dense_mlp_input": (2304, F32, BF, (BF, BF), False),
    "after_dense_mlp": (2304, F32, BF, (BF,), False),
    "expert_input": (2304, F32, BF, (F32,), False),
    "delta_rule_after_experts": (2304, F32, F32, (BF,), False),
    "mla_after_experts": (2304, F32, F32, (BF, BF), False),
    "final_norm": (2304, F32, F32, (F32,), False),
}.items()} | {f"xing_{name}": site for name, site in {  # the Xing4.0 cell's, at 3584 and 768
    "sublayer_input": (3584, F32, None, (BF, BF), False),
    "expert_input": (3584, F32, None, (F32,), False),
    "q_a_layernorm": (768, BF, None, (BF,), False),
    "fp32_q_a_layernorm": (768, F32, None, (F32,), False),
}.items()}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(site, dev, seed=0, rows=T_ROWS):
    width, x_dt, b_dt, out, in_place = SITES[site]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    wide = normal(*rows, width + ROPE if in_place else width).to(x_dt)
    branch = None if b_dt is None else normal(*rows, width).to(b_dt)
    weight = 1.0 + 0.1 * normal(width)
    dys = [normal(*rows, width).to(dt) for dt in out]
    d_xnew = normal(*rows, width)
    return wide, branch, weight, out, dys, d_xnew


def _run(fn, wide, branch, weight, out, dys, d_xnew):
    """fn's x_new and outputs, and the gradients of x, the branch and the
    weight for the outputs' gradients dys (and d_xnew, where x_new is new)."""
    width = weight.shape[0]
    wide = wide.detach().clone().requires_grad_(True)
    x = wide[..., :width] if wide.shape[-1] != width else wide
    w = weight.detach().clone().requires_grad_(True)
    b = None if branch is None else branch.detach().clone().requires_grad_(True)
    x_new, ys = fn(x, b, w, 1e-5, out)
    assert [y.dtype for y in ys] == list(out)
    loss = sum((y.float() * dy.float()).sum() for y, dy in zip(ys, dys))
    if b is not None:
        loss = loss + (x_new * d_xnew).sum()
    loss.backward()
    found = {"x_new": x_new.detach(), "dx": wide.grad[..., :width], "dw": w.grad}
    found.update({f"y{i}": y.detach() for i, y in enumerate(ys)})
    if b is not None:
        found["dbranch"] = b.grad
    if wide.shape[-1] != width:
        assert not wide.grad[..., width:].any()
    return found


def _max_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _tolerance(name, t) -> float:
    if name == "x_new":
        return 0.0
    if t.dtype == BF:
        return 2 ** -7
    return 2e-6 if name.startswith("y") else 2e-5


@pytest.mark.parametrize("site", list(SITES))
def test_kernel_against_plain_version(cuda, site):
    args = _inputs(site, cuda, seed=len(site))
    got = _run(rms_norm.add_rms_norm, *args)
    want = _run(rms_norm.add_rms_norm_reference, *args)
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        gap = _max_rel(got[name], want[name])
        print(f"{site} {name}: kernel vs plain {gap:.3g}")
        assert gap <= _tolerance(name, got[name]), name


@pytest.mark.parametrize("width", [2048, 2304, 3584, LATENT, 768])
def test_rstd_is_the_plain_reciprocal_root(cuda, width):
    """The forward's rstd (one fp32 value a row, saved for the backward)."""
    x = torch.randn(*T_ROWS, width, device=cuda)
    weight = torch.ones(width, device=cuda)
    rstd = torch.empty(T_ROWS, device=cuda)
    y = torch.empty_like(x)
    rms_norm._launch(0, x, width, None, weight, 1e-5, y32=y, rstd=rstd)
    want = torch.rsqrt(x.pow(2).mean(-1) + 1e-5)
    assert _max_rel(rstd, want) <= 2e-6
    assert _max_rel(y, x * want[..., None]) <= 2e-6


def test_two_bf16_consumers_gradients_add_in_fp32(cuda):
    """q_proj's and kv_a_proj_with_mqa's gradients (bf16 each) reach the
    backward apart and add there in fp32: 1 + 2^-9 in fp32, where a bf16
    sum would round it to 1. The weight's gradient (the sum over rows of g
    n) shows which sum was taken."""
    rows, width = (4, 16), 2048
    x = torch.randn(*rows, width, device=cuda)
    weight = torch.ones(width, device=cuda, requires_grad=True)
    _, (q_in, kv_in) = rms_norm.add_rms_norm(x, None, weight, 1e-5, (BF, BF))
    dy_q = torch.ones(*rows, width, device=cuda, dtype=BF)
    dy_kv = torch.full((*rows, width), 2.0 ** -9, device=cuda, dtype=BF)
    ((q_in.float() * dy_q.float()).sum() + (kv_in.float() * dy_kv.float()).sum()).backward()
    n = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5)
    fp32_sum = (n * (dy_q.float() + dy_kv.float())).sum((0, 1))
    bf16_sum = (n * (dy_q + dy_kv).float()).sum((0, 1))
    assert float((dy_q + dy_kv).float().max()) == 1.0  # the bf16 sum loses 2^-9
    assert _max_rel(weight.grad, fp32_sum) <= 2e-5
    assert _max_rel(weight.grad, bf16_sum) > 1e-3


def test_gradients_repeat_bit_for_bit(cuda):
    """No atomics: two backwards give the same bits."""
    args = _inputs("fp32_and_two_bf16", cuda, seed=7)
    first, second = _run(rms_norm.add_rms_norm, *args), _run(rms_norm.add_rms_norm, *args)
    for name in first:
        assert torch.equal(first[name], second[name]), name


def test_fp32_consumers_share_one_output(cuda):
    """Every fp32 consumer gets the one fp32 y (autograd adds their
    gradients in fp32); each bf16 consumer its own copy."""
    x = torch.randn(8, 2048, device=cuda)
    weight = torch.ones(2048, device=cuda)
    _, ys = rms_norm.add_rms_norm(x, None, weight, 1e-5, (F32, BF, F32, BF))
    assert ys[0] is ys[2] and ys[1] is not ys[3] and torch.equal(ys[1], ys[3])


@pytest.mark.parametrize("bad, match", [
    (dict(width=1024), "widths"),
    (dict(x_dtype=BF), "branch to fp32 x"),
    (dict(out=(BF, BF, BF)), "up to two bf16"),
    (dict(weight_device="cpu"), "CUDA tensors on one device"),
])
def test_kernel_path_refuses_what_it_does_not_take(cuda, bad, match):
    width = bad.get("width", 2048)
    x = torch.randn(4, width, device=cuda).to(bad.get("x_dtype", F32))
    branch = torch.randn(4, width, device=cuda, dtype=BF)
    weight = torch.ones(width, device=bad.get("weight_device", cuda))
    with pytest.raises(ValueError, match=match):
        rms_norm.add_rms_norm(x, branch, weight, 1e-5, bad.get("out", (BF,)))


def test_launch_counters_move(cuda):
    """A forward launches one kernel, a backward two; ``norm.kernel_calls``
    counts the forward calls; the plain version launches none."""
    args = _inputs("hidden_bf16_branch", cuda, seed=9, rows=(4, 48))

    def reading():
        return (rms_norm.add_rms_norm.launches,
                int(metrics.counters("norm.").get("norm.kernel_calls", 0)))

    before = reading()
    _run(rms_norm.add_rms_norm, *args)
    with torch.no_grad():
        rms_norm.add_rms_norm(args[0], args[1], args[2], 1e-5, args[3])
    after = reading()
    assert [a - b for a, b in zip(after, before)] == [4, 2]
    _run(rms_norm.add_rms_norm_reference, *args)
    assert reading() == after
