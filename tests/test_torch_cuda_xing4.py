"""The Xing4.0 encoder (models/xing4.py) on a card, at Xing4.0-29B-A4B's
published widths (hidden 3,584; 4 residual streams mixed by 20 Sinkhorn
steps; latent attention of 32 heads with a q rank of 768 and the YaRN
tables and scale; the dense SwiGLU 9,216 wide; 64 experts routed over, 0-7
held, one shared expert). These tests need an NVIDIA GPU; they carry the
``gpu`` marker and skip elsewhere. The file imports neither JAX nor the
JAX package:

    python -m pytest tests/test_torch_cuda_xing4.py -m gpu --noconftest -q

- A model of one dense and one expert layer, fp32 compute (TF32 off on
  both sides), 8 right-padded rows of 48, against the reference
  (tests/reference_xing4.py): each row's embedding within 1e-4 (L2) and
  every leaf's gradient within 1e-3 of its norm (of a thousandth of the
  median leaf's): fp32 sums of up to 14,336 terms in other orders.
- The same model in bf16 at the cell's shape (512 rows of 48, 256 of 96),
  kernels (M1 with the YaRN scale, M2 at 3584, 768 and 512) against the
  plain chains of ops/mla_attention.py and ops/rms_norm.py on the same
  card, routers held to the plain run's choices: embeddings within 1e-2
  (L2), the loss within 3e-4 of the sum of its terms' magnitudes, every
  leaf's gradient within 0.025 of the larger of its norm and the median
  leaf's: 2.5 times or more the readings of an H100 (0.0037, 1.4e-5 to
  1.03e-4, 0.0099-0.0100; the two sides round in bf16 at other points of
  the chain, and the experts' index_add_ sums in another order each run).
  The routers take the plain run's choices (tests/deepseek_v3_routing.py
  ``recorded`` and ``replayed``). The add + RMSNorm
  kernel is called 18 times (2 calls x (2 sublayer norms + 2 q_a + 2 kv_a
  + the final norm, no branch at any)), the MLA kernel 4 times, the
  hyper-connections' pre 8 times; the backward's recomputation counts none.
"""

import numpy as np
import pytest
import torch

import reference_xing4 as ref
from deepseek_v3_routing import recorded, replayed
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import xing4 as xg
from rag_icd10_tpu_torch.ops import mla_attention as mla
from rag_icd10_tpu_torch.ops import rms_norm
from rag_icd10_tpu_torch.utils.metrics import metrics

pytestmark = pytest.mark.gpu

XING = dict(
    model_type="xing4_0", vocab_size=21128, hidden_size=3584, intermediate_size=9216,
    moe_intermediate_size=1024, num_hidden_layers=2, num_attention_heads=32, kv_lora_rank=512,
    q_lora_rank=768, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_routed_experts=64, num_experts_per_tok=4, n_shared_experts=1, routed_scaling_factor=2.0,
    norm_topk_prob=True, scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
    topk_group=1, first_k_dense_replace=1, moe_layer_freq=1, rms_norm_eps=1e-6,
    rope_theta=10000, max_position_embeddings=262144, experts_held=list(range(8)),
    rope_scaling=dict(type="yarn", factor=64, original_max_position_embeddings=4096,
                      beta_fast=32, beta_slow=1, mscale=1, mscale_all_dim=1),
    hc_mult=4, hc_sinkhorn_iters=20, hc_eps=1e-6, mhc_h_res_clamp_min=-30,
    mhc_h_res_clamp_max=30)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref.no_tf32()
    return torch.device("cuda")


def _model(compute, device, seed=3):
    arch = xg.Xing4Arch.from_config(XING, compute_dtype=compute)
    params = xg.init_params(arch, seed)
    rng = np.random.default_rng(seed)
    for k in params:
        if k.endswith("e_score_correction_bias"):
            params[k] = rng.normal(0.0, 0.1, params[k].shape).astype(np.float32)
    with torch.device(device):
        model = xg.SentenceXing4(arch)
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
    zr = ref.encode(w, ids, mask, XING)
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


def test_xing_shaped_step_against_the_plain_chains(cuda, monkeypatch):
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

    with monkeypatch.context() as m:
        m.setattr(dv, "add_rms_norm", rms_norm.add_rms_norm_reference)
        m.setattr(dv, "mla_attention", mla.mla_attention_reference)
        with recorded() as picks:
            terms_p, z_p, grads_p = step()

    def reading():
        c = metrics.counters()
        return [int(c.get(k, 0)) for k in ("norm.kernel_calls", "mla.kernel_calls", "mhc.calls")]

    before = reading()
    torch.cuda.reset_peak_memory_stats()
    with replayed(picks):
        terms_k, z_k, grads_k = step()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(reading(), before)] == [18, 4, 8]
    norms = {k: float(g.norm()) for k, g in grads_p.items()}
    med = float(np.median(list(norms.values())))
    gaps = {k: float((grads_k[k] - grads_p[k]).norm()) / max(norms[k], med) for k in grads_p}
    worst = max(gaps, key=gaps.get)
    emb_err = float(torch.linalg.vector_norm(z_k - z_p, dim=-1).max())
    loss_gap = abs(float(terms_k.sum() - terms_p.sum())) / float(terms_p.abs().sum())
    print(f"Xing-shaped step, kernels vs plain chains: embeddings {emb_err:.3g}, loss "
          f"{loss_gap:.3g}, widest gradient gap {gaps[worst]:.3g} ({worst}); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    assert emb_err < 1e-2 and loss_gap < 3e-4 and gaps[worst] < 0.025
