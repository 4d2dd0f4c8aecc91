"""The DeepSeek-V3-family encoder (models/deepseek_v3.py) on a card, at the
published widths of Moonlight-16B-A3B cut to one expert-parallel rank's
share (the dense layer and 4 expert layers; experts 0-7 of the router's
64 held; 21,128 vocabulary rows), against the plain fp32 reference
(tests/reference_deepseek_v3.py, TF32 off). These tests need an NVIDIA
GPU; they carry the ``gpu`` marker and skip elsewhere. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_deepseek_v3.py -m gpu --noconftest -q

One forward and backward of 8 right-padded rows of 48 positions, the
loss a fixed random projection of the embeddings:

- fp32 compute (TF32 off on both sides): each row's embedding within 1e-4
  (L2) and every leaf's gradient within 1e-3 of its norm (of a thousandth
  of the median leaf's, for an expert that took no token): cuBLAS sums in
  another order than the reference; a routing choice that flipped on such
  a difference would show far above these.
- bf16 compute over fp32 masters, as the model trains, the program's
  routers held to the reference's choices (tests/deepseek_v3_routing.py):
  each row's embedding within 5e-2 (L2), every leaf's gradient within 0.1
  of the larger of its norm and the median leaf's: bf16 rounds each
  product's inputs to 2^-8, over five layers forward and back. Left free,
  a token whose sixth and seventh expert scores lie within that rounding
  goes to another expert than in fp32, and with 8 rows an expert takes a
  few dozen tokens: one such token moves its gradient by several percent.

And one step of the Moonlight cell's shape (512 rows of 48 positions, 256
of 96), bf16, against the same model with the plain add + RMSNorm chain
(ops/rms_norm.py add_rms_norm_reference) on the same card, its routers held
to the plain run's choices: each row's embedding within 5e-2 (L2) and every
leaf's gradient within 0.1, as above; the loss within 1e-2 of the sum of
its terms' magnitudes (the CPU tests' bf16 loss tolerance); and the add +
RMSNorm kernel called 32 times (2 calls x (11 hidden-width sites + 5
latent)).
"""

import contextlib

import numpy as np
import pytest
import torch

import reference_deepseek_v3 as ref
from deepseek_v3_routing import held_to_reference
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.ops import rms_norm
from rag_icd10_tpu_torch.utils.metrics import metrics

pytestmark = pytest.mark.gpu

MOONLIGHT = dict(
    model_type="deepseek_v3", vocab_size=21128, hidden_size=2048, intermediate_size=11264,
    moe_intermediate_size=1408, num_hidden_layers=5, num_attention_heads=16, kv_lora_rank=512,
    q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
    routed_scaling_factor=2.446, norm_topk_prob=True, first_k_dense_replace=1,
    moe_layer_freq=1, rms_norm_eps=1e-5, rope_theta=50000, max_position_embeddings=8192,
    scoring_func="sigmoid", topk_method="noaux_tc", n_group=1, topk_group=1,
    experts_held=list(range(8)))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref.no_tf32()
    return torch.device("cuda")


def _params(arch, seed=3):
    params = dv.init_params(arch, seed)
    rng = np.random.default_rng(seed)
    for k in params:
        if k.endswith("e_score_correction_bias"):
            params[k] = rng.normal(0.0, 0.1, params[k].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_and_backward_at_published_widths(cuda, compute):
    arch = dv.DeepseekV3Arch.from_config(MOONLIGHT, compute_dtype=getattr(torch, compute))
    params = _params(arch)
    with torch.device(cuda):
        model = dv.SentenceDeepseekV3(arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(1, arch.vocab_size, (8, 48), generator=gen).to(cuda)
    mask = torch.ones(8, 48, dtype=torch.long, device=cuda)
    for r, n in enumerate((48, 40, 31, 20, 12, 7, 3, 48)):
        mask[r, n:] = 0
        ids[r, n:] = 0
    target = torch.randn(8, arch.hidden_size, generator=gen).to(cuda)

    w = {k: torch.from_numpy(v).to(cuda).requires_grad_(not k.endswith("bias"))
         for k, v in params.items()}
    hold = (held_to_reference(w, [ids], MOONLIGHT) if compute == "bfloat16"
            else contextlib.nullcontext())
    with hold:
        z = model(ids, mask)
    loss = (z * target).sum()
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}

    zr = ref.encode(w, ids, mask, MOONLIGHT)
    loss_r = (zr * target).sum()
    names = [k for k in w if not k.endswith("bias")]
    grads_r = dict(zip(names, torch.autograd.grad(loss_r, [w[k] for k in names])))
    assert set(grads) == set(grads_r)

    emb_err = float(torch.linalg.vector_norm(z - zr, dim=-1).max().detach())
    norms = {k: float(g.norm()) for k, g in grads_r.items()}
    med = float(np.median(list(norms.values())))
    tight = compute == "float32"
    floor = 1e-3 * med if tight else med
    gaps = {k: float((grads[k] - grads_r[k]).norm()) / max(norms[k], floor) for k in names}
    worst = max(gaps, key=gaps.get)
    print(f"{compute}: embeddings {emb_err:.3g}, loss {float(loss.detach()):.6g} vs {float(loss_r.detach()):.6g}, "
          f"widest gradient gap {gaps[worst]:.3g} ({worst})")
    if tight:
        assert emb_err < 1e-4 and gaps[worst] < 1e-3
    else:
        assert emb_err < 5e-2 and gaps[worst] < 0.1


def test_moonlight_shaped_step_against_the_plain_chain(cuda, monkeypatch):
    arch = dv.DeepseekV3Arch.from_config(MOONLIGHT, compute_dtype=torch.bfloat16)
    with torch.device(cuda):
        model = dv.SentenceDeepseekV3(arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _params(arch).items()})
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
        m.setattr(dv.Router, "forward", record)
        terms_p, z_p, grads_p = step()
    before = int(metrics.counters("norm.").get("norm.kernel_calls", 0))
    with monkeypatch.context() as m:
        m.setattr(dv.Router, "forward", replay)
        terms_k, z_k, grads_k = step()
    torch.cuda.synchronize()
    assert int(metrics.counters("norm.").get("norm.kernel_calls", 0)) - before == 32
    assert not picks
    norms = {k: float(g.norm()) for k, g in grads_p.items()}
    med = float(np.median(list(norms.values())))
    gaps = {k: float((grads_k[k] - grads_p[k]).norm()) / max(norms[k], med) for k in grads_p}
    worst = max(gaps, key=gaps.get)
    emb_err = float(torch.linalg.vector_norm(z_k - z_p, dim=-1).max())
    loss_gap = abs(float(terms_k.sum() - terms_p.sum())) / float(terms_p.abs().sum())
    print(f"Moonlight-shaped step, kernel vs plain chain: embeddings {emb_err:.3g}, loss "
          f"{loss_gap:.3g}, widest gradient gap {gaps[worst]:.3g} ({worst})")
    assert emb_err < 5e-2 and loss_gap < 1e-2 and gaps[worst] < 0.1
