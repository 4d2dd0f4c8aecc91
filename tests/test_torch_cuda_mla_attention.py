"""The latent-attention kernels (ops/csrc/mla_attention.cu: mla_attn_fwd,
mla_attn_bwd_dq, mla_attn_bwd_dkv, bound by ops/mla_attention.py) on a card, against their plain
version run on the same card from the same inputs. These tests need an
NVIDIA GPU; they carry the ``gpu`` marker and skip elsewhere. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_mla_attention.py -m gpu --noconftest -q

Moonlight-16B-A3B's widths (16 heads, 128 nope + 64 rope dimensions, v
128, k_pe the last 64 columns of a 576-wide kv_a output, read through its
strides), at the main path's shapes (512 rows of 48 positions, 256 of 96)
and at ragged lengths: 37 (a partial block of rows and keys), 130 and 257
(past the 96 keys one block holds: both passes walk the key blocks, and dkv
several query blocks). Inputs are seeded normals, so logits are of order 1.

Tolerances, each with its reason:

- bf16 compute, kernel against the plain version (max |difference| over
  max |plain|): the context within 2^-7. Both round P to bf16 once and the
  context once; they sum in other orders and take exp differently, which
  moves a value across a bf16 rounding step (2^-8 relative) now and then.
  Gradients within 2^-6: the plain chain rounds dP, each head's dk_pe and
  the rope parts of dq and dk_pe to bf16 on the way, each a step of 2^-8
  of the value it rounds, and dk_pe sums 16 such heads; the kernel rounds
  each gradient once.
- bf16, both against an fp32 truth (the plain version on the same inputs
  widened to fp32, TF32 off), as relative L2 errors: the kernel's at most
  1.1 times the plain version's. The kernel keeps every rounding point of
  the plain chain and adds none, so it is no less accurate; the margin
  covers the statistical scatter of equal rounding points over ~10^5-10^7
  values.
- fp32 compute (IEEE products on both sides): within 1e-5 of max |plain|:
  fp32 sums of 192- and up-to-257-term products in two orders.
- Xing4.0's attention (32 heads, the YaRN tables and the softmax scale
  192^-1/2 (0.1 ln 64 + 1)^2 as a launch argument) at the main shapes:
  the limits of the bf16 case above, for the same reasons; and the scale
  reaches both sides, which read otherwise by far at the default scale.
"""

import pytest
import torch

from rag_icd10_tpu_torch.models.deepseek_v3 import YaRN, rope_tables
from rag_icd10_tpu_torch.ops import mla_attention as mla
from rag_icd10_tpu_torch.utils.metrics import metrics

pytestmark = pytest.mark.gpu

HEADS, NOPE, ROPE, VD, LORA, THETA = 16, 128, 64, 128, 512, 50000.0
MAIN = [(512, 48), (256, 96)]  # (rows, positions): anchors + hard negatives, positives
RAGGED = [(3, 37), (3, 130), (2, 257)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 products in IEEE
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, s, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q = normal(b, s, HEADS * (NOPE + ROPE))
    kv = normal(b, s, HEADS * (NOPE + VD))
    kv_a = normal(b, s, LORA + ROPE)  # k_pe is its last ROPE columns
    d_out = normal(b, s, HEADS * VD)
    cos, sin = rope_tables(s, ROPE, THETA, dev)
    return q, kv, kv_a, cos, sin, d_out


def _run(fn, q, kv, kv_a, cos, sin, d_out):
    """fn's context and the gradients of q, kv and k_pe (and of the rest
    of kv_a, which must stay 0) for the upstream gradient d_out."""
    q, kv, kv_a = (t.detach().clone().requires_grad_(True) for t in (q, kv, kv_a))
    out = fn(q, kv, kv_a[..., LORA:], cos, sin, HEADS)
    out.backward(d_out)
    assert not kv_a.grad[..., :LORA].any()
    return {"out": out.detach(), "dq": q.grad, "dkv": kv.grad, "dk_pe": kv_a.grad[..., LORA:]}


def _max_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _l2_rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("b, s", MAIN + RAGGED)
def test_bf16_kernel_against_plain_version(cuda, b, s):
    args = _inputs(b, s, torch.bfloat16, cuda, seed=s)
    got = _run(mla.mla_attention, *args)
    want = _run(mla.mla_attention_reference, *args)
    wide = [t.float() for t in args]
    truth = _run(mla.mla_attention_reference, *wide)
    for name in got:
        assert got[name].dtype == torch.bfloat16 and got[name].shape == want[name].shape
        gap = _max_rel(got[name], want[name])
        kernel_err, plain_err = _l2_rel(got[name], truth[name]), _l2_rel(want[name], truth[name])
        print(f"B {b} S {s} {name}: kernel vs plain {gap:.3g}; vs fp32 kernel {kernel_err:.3g}, "
              f"plain {plain_err:.3g}")
        assert gap <= (2 ** -7 if name == "out" else 2 ** -6), name
        assert kernel_err <= 1.1 * plain_err, name


@pytest.mark.parametrize("b, s", [(4, 48), (3, 130)])
def test_fp32_kernel_against_plain_version(cuda, b, s):
    args = _inputs(b, s, torch.float32, cuda, seed=s + 1)
    got = _run(mla.mla_attention, *args)
    want = _run(mla.mla_attention_reference, *args)
    for name in got:
        assert _max_rel(got[name], want[name]) <= 1e-5, name


def test_gradients_repeat_bit_for_bit(cuda):
    """No atomics: two runs give the same bits."""
    args = _inputs(3, 130, torch.bfloat16, cuda, seed=7)
    first, second = _run(mla.mla_attention, *args), _run(mla.mla_attention, *args)
    for name in first:
        assert torch.equal(first[name], second[name]), name


def test_launch_counters_move(cuda):
    """A forward launches one kernel, a backward two; ``mla.kernel_calls``
    counts the forward calls."""
    args = _inputs(2, 48, torch.bfloat16, cuda, seed=9)
    before = (mla.mla_attention.launches, int(metrics.counters("mla.").get("mla.kernel_calls", 0)))
    _run(mla.mla_attention, *args)
    with torch.no_grad():
        mla.mla_attention(*args[:2], args[2][..., LORA:], *args[3:5], HEADS)
    after = (mla.mla_attention.launches, int(metrics.counters("mla.").get("mla.kernel_calls", 0)))
    assert [a - b for a, b in zip(after, before)] == [4, 2]
    # the plain version launches none of them
    _run(mla.mla_attention_reference, *args)
    assert mla.mla_attention.launches == after[0]


@pytest.mark.parametrize("b, s", MAIN)
def test_yarn_scale_and_tables_at_32_heads(cuda, b, s):
    heads = 32
    yarn = YaRN(factor=64, original_max_position_embeddings=4096, beta_fast=32, beta_slow=1,
                mscale=1, mscale_all_dim=1)
    scale = (NOPE + ROPE) ** -0.5 * yarn.softmax_factor
    gen = torch.Generator(device=cuda).manual_seed(b)
    q = torch.randn(b, s, heads * (NOPE + ROPE), generator=gen, device=cuda)
    kv = torch.randn(b, s, heads * (NOPE + VD), generator=gen, device=cuda)
    kv_a = torch.randn(b, s, LORA + ROPE, generator=gen, device=cuda)
    d_out = torch.randn(b, s, heads * VD, generator=gen, device=cuda)
    cos, sin = rope_tables(s, ROPE, 10000.0, cuda, yarn)

    def run(fn, scale):
        leaves = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, kv, kv_a)]
        out = fn(leaves[0], leaves[1], leaves[2][..., LORA:], cos, sin, heads, scale)
        (out.float() * d_out).sum().backward()
        return [out, leaves[0].grad, leaves[1].grad, leaves[2].grad[..., LORA:]]

    got, want = run(mla.mla_attention, scale), run(mla.mla_attention_reference, scale)
    gaps = [_max_rel(a, b) for a, b in zip(got, want)]
    default = run(mla.mla_attention_reference, None)
    moved = _max_rel(default[0], want[0])
    print(f"MLA kernels, 32 heads, YaRN, {b}x{s}: context, dq, dkv, dk_pe {gaps}; "
          f"the default scale moves the context by {moved:.3g}")
    assert gaps[0] <= 2 ** -7 and max(gaps[1:]) <= 2 ** -6
    assert moved > 0.1
