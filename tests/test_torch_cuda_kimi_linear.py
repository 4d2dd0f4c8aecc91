"""The Kimi-Linear encoder (models/kimi_linear.py) and its parts on a card,
at Kimi-Linear-48B-A3B's published widths (hidden 2,304; delta-rule layers
of 32 heads of 128; latent attention of 32 heads; 256 experts routed over,
0-7 held). These tests need an NVIDIA GPU; they carry the ``gpu`` marker
and skip elsewhere. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_kimi_linear.py -m gpu --noconftest -q

- The delta rule (ops/kda.py, on a card its kernels M3) at 32 heads of 128
  against the token loop (tests/reference_kimi_linear.py, TF32 off) for 4
  rows of 48 and 2 of 96, fp32 in both: outputs within 1e-4 of their
  largest and gradients within 1e-3 of theirs (sums of 128- to 256-term
  products in another order, and the decays as exponents of cumulative
  sums). tests/test_torch_cuda_kda.py holds the kernels against the plain
  version.
- The latent-attention kernels (M1) at 32 heads with the tables of no
  rotation, against their plain version on the same card, bf16: the
  context within 2^-7 and gradients within 2^-6 of their largest, the
  limits of tests/test_torch_cuda_mla_attention.py, whose note gives the
  reasons; and the plain version with those tables is attention without
  rotation (fp32, within 1e-5: the pairs' de-interleave permutes q's and
  k's rope dimensions alike).
- A model of one delta-rule and one latent-attention expert layer, fp32
  compute (TF32 off on both sides), 8 right-padded rows of 48, against the
  reference: each row's embedding within 1e-4 (L2) and every leaf's
  gradient within 1e-3 of its norm (of a thousandth of the median leaf's).
- The same model in bf16 at the cell's shape (512 rows of 48, 256 of 96),
  kernels (M1, M2 at 2304 and 512) against the plain chains of
  ops/mla_attention.py and ops/rms_norm.py on the same card, routers held
  to the plain run's choices: embeddings within 1e-2 (L2), the loss within
  1e-4 of the sum of its terms' magnitudes, every leaf's gradient within
  0.025 of the larger of its norm and the median leaf's: about 3.4 times
  the widest of two runs on an H100 (0.00295, 2.67e-5, 0.0075; the two
  sides round in bf16 at other points of the chain, and the experts'
  index_add_ sums in another order each run); the plain side runs the
  delta rule's plain version too (ops/kda.py kda_reference); the add +
  RMSNorm kernel called 12 times (2 calls x (5 hidden-width sites + 1
  latent)), the MLA kernel twice, the delta rule twice, each call through
  its kernel (M3: one launch a forward, one a backward).
"""

import numpy as np
import pytest
import torch

import reference_kimi_linear as ref
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import kimi_linear as kl
from rag_icd10_tpu_torch.ops import kda as kda_op
from rag_icd10_tpu_torch.ops import mla_attention as mla
from rag_icd10_tpu_torch.ops import rms_norm
from rag_icd10_tpu_torch.utils.metrics import metrics

pytestmark = pytest.mark.gpu

HEADS, D = 32, 128
KIMI = dict(
    model_type="kimi_linear", vocab_size=21128, hidden_size=2304, intermediate_size=9216,
    moe_intermediate_size=1024, num_hidden_layers=2, num_attention_heads=32, kv_lora_rank=512,
    q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=256, num_experts_per_token=8, num_shared_experts=1, routed_scaling_factor=2.446,
    moe_renormalize=True, moe_router_activation_func="sigmoid", num_expert_group=1,
    topk_group=1, first_k_dense_replace=0, moe_layer_freq=1, rms_norm_eps=1e-5,
    mla_use_nope=True, experts_held=list(range(8)),
    linear_attn_config=dict(kda_layers=[1], full_attn_layers=[2], head_dim=128, num_heads=32,
                            short_conv_kernel_size=4))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref.no_tf32()
    return torch.device("cuda")


def _max_rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("rows,s", [(4, 48), (2, 96)])
def test_delta_rule_at_published_heads(cuda, rows, s):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(rows, s, HEADS, D, generator=gen, device=cuda) for _ in range(3))
    g = -torch.rand(rows, s, HEADS, D, generator=gen, device=cuda) * torch.logspace(
        -2, 1, HEADS, device=cuda)[:, None]  # slow heads to 10 nats a token
    beta = torch.rand(rows, s, HEADS, generator=gen, device=cuda)
    ours = [t.clone().requires_grad_(True) for t in (q, k, v, g, beta)]
    theirs = [t.clone().requires_grad_(True) for t in (q, k, v, g, beta)]
    o, o_ref = kda_op.kda(*ours), ref.delta_rule(*theirs)
    weight = torch.randn(o.shape, generator=gen, device=cuda)
    (o * weight).sum().backward()
    (o_ref * weight).sum().backward()
    print(f"delta rule {rows}x{s}: output {_max_rel(o, o_ref):.3g}, gradients "
          + ", ".join(f"{_max_rel(a.grad, b.grad):.3g}" for a, b in zip(ours, theirs)))
    assert _max_rel(o, o_ref) <= 1e-4
    for name, a, b in zip("qkvgb", ours, theirs):
        assert _max_rel(a.grad, b.grad) <= 1e-3, name


@pytest.mark.parametrize("rows,s", [(512, 48), (256, 96)])
def test_mla_kernels_at_32_heads_without_rotation(cuda, rows, s):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    q = torch.randn(rows, s, HEADS * 192, generator=gen, device=cuda)
    kv = torch.randn(rows, s, HEADS * 256, generator=gen, device=cuda)
    k_pe = torch.randn(rows, s, 576, generator=gen, device=cuda)[..., 512:]
    cos, sin = dv.nope_tables(s, 64, cuda)
    d_out = torch.randn(rows, s, HEADS * 128, generator=gen, device=cuda)

    def run(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (q, kv, k_pe)]
        out = fn(*leaves, cos, sin, HEADS)
        (out.float() * d_out).sum().backward()
        return [out] + [t.grad for t in leaves]

    got = run(mla.mla_attention, torch.bfloat16)
    want = run(mla.mla_attention_reference, torch.bfloat16)
    gaps = [_max_rel(a, b) for a, b in zip(got, want)]
    print(f"MLA kernels, no rotation, {rows}x{s}: context, dq, dkv, dk_pe {gaps}")
    assert gaps[0] <= 2 ** -7 and max(gaps[1:]) <= 2 ** -6

    # the tables of no rotation are attention on the rope dimensions as they come
    small = [t[:2].clone() for t in (q, kv, k_pe)]
    plain = mla.mla_attention_reference(*small, cos, sin, HEADS)
    qh = small[0].view(2, s, HEADS, 192).transpose(1, 2)
    kvh = small[1].view(2, s, HEADS, 256).transpose(1, 2)
    k = torch.cat([kvh[..., :128], small[2][:, None].expand(2, HEADS, s, 64)], -1)
    scores = qh @ k.transpose(-1, -2) / 192 ** 0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=cuda).triu(1)
    probs = torch.softmax(scores.masked_fill(causal, float("-inf")), -1)
    direct = (probs @ kvh[..., 128:]).transpose(1, 2).reshape(2, s, HEADS * 128)
    assert _max_rel(plain, direct) <= 1e-5


def _model(compute, device, seed=3):
    arch = kl.KimiLinearArch.from_config(KIMI, compute_dtype=compute)
    params = kl.init_params(arch, seed)
    rng = np.random.default_rng(seed)
    for k in params:
        if k.endswith("e_score_correction_bias"):
            params[k] = rng.normal(0.0, 0.1, params[k].shape).astype(np.float32)
    with torch.device(device):
        model = kl.SentenceKimiLinear(arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return arch, params, model


def test_forward_and_backward_against_the_reference_in_fp32(cuda):
    arch, params, model = _model(torch.float32, cuda)
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(1, arch.vocab_size, (8, 48), generator=gen).to(cuda)
    mask = torch.ones(8, 48, dtype=torch.long, device=cuda)
    for r, n in enumerate((48, 40, 31, 20, 12, 7, 3, 48)):
        mask[r, n:] = 0
        ids[r, n:] = 0
    target = torch.randn(8, arch.hidden_size, generator=gen).to(cuda)
    z = model(ids, mask)
    (z * target).sum().backward()
    z = z.detach()
    w = {k: torch.from_numpy(v).to(cuda).requires_grad_(not k.endswith("correction_bias"))
         for k, v in params.items()}
    zr = ref.encode(w, ids, mask, KIMI)
    names = [k for k in w if w[k].requires_grad]
    grads_r = dict(zip(names, torch.autograd.grad((zr * target).sum(), [w[k] for k in names])))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(grads_r)
    norms = {k: float(g.norm()) for k, g in grads_r.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    gaps = {k: float((grads[k] - grads_r[k]).norm()) / max(norms[k], floor) for k in names}
    worst = max(gaps, key=gaps.get)
    emb = float(torch.linalg.vector_norm(z - zr.detach(), dim=-1).max())
    print(f"fp32 against the reference: embeddings {emb:.3g}, widest gradient gap "
          f"{gaps[worst]:.3g} ({worst})")
    assert emb < 1e-4 and gaps[worst] < 1e-3


def test_kimi_shaped_step_against_the_plain_chains(cuda, monkeypatch):
    arch, _, model = _model(torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    calls = [torch.randint(1, arch.vocab_size, (b, s), generator=gen, device=cuda)
             for b, s in ((512, 48), (256, 96))]
    targets = [torch.randn(ids.shape[0], arch.hidden_size, generator=gen, device=cuda)
               for ids in calls]

    def step():
        model.zero_grad(set_to_none=True)
        zs = [model(ids, torch.ones_like(ids)) for ids in calls]
        terms = torch.cat([(z * t).sum(-1) for z, t in zip(zs, targets)])
        terms.sum().backward()
        return terms.detach(), torch.cat(zs).detach(), {
            n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}

    picks, forward = [], dv.Router.forward

    def record(self, x):
        out = forward(self, x)
        picks.append(out[0])
        return out

    def replay(self, x):
        idx = picks.pop(0)
        scores = torch.sigmoid(torch.nn.functional.linear(x.float(), self.weight.float()))
        w = scores.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.arch.routed_scaling_factor

    with monkeypatch.context() as m:
        m.setattr(dv, "add_rms_norm", rms_norm.add_rms_norm_reference)
        m.setattr(dv, "mla_attention", mla.mla_attention_reference)
        m.setattr(kl, "kda", kda_op.kda_reference)
        m.setattr(dv.Router, "forward", record)
        terms_p, z_p, grads_p = step()

    def reading():
        c = metrics.counters()
        return [int(c.get(k, 0)) for k in ("norm.kernel_calls", "mla.kernel_calls",
                                           "kda.core_calls", "kda.kernel_calls")]

    before, launches = reading(), kda_op.kda.launches
    with monkeypatch.context() as m:
        m.setattr(dv.Router, "forward", replay)
        terms_k, z_k, grads_k = step()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(reading(), before)] == [12, 2, 2, 2]
    assert kda_op.kda.launches - launches == 4
    assert not picks
    norms = {k: float(g.norm()) for k, g in grads_p.items()}
    med = float(np.median(list(norms.values())))
    gaps = {k: float((grads_k[k] - grads_p[k]).norm()) / max(norms[k], med) for k in grads_p}
    worst = max(gaps, key=gaps.get)
    emb_err = float(torch.linalg.vector_norm(z_k - z_p, dim=-1).max())
    loss_gap = abs(float(terms_k.sum() - terms_p.sum())) / float(terms_p.abs().sum())
    print(f"Kimi-shaped step, kernels vs plain chains: embeddings {emb_err:.3g}, loss "
          f"{loss_gap:.3g}, widest gradient gap {gaps[worst]:.3g} ({worst}); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    assert emb_err < 1e-2 and loss_gap < 1e-4 and gaps[worst] < 0.025
