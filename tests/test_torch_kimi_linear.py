"""The Kimi-Linear sentence encoder (models/kimi_linear.py) and its gated
delta rule (ops/kda.py) on the CPU, against the plain fp32 reference
(tests/reference_kimi_linear.py, the token-by-token recurrence) at a small
size: 64 wide, delta-rule layers of 4 heads of 16 with convolutions of 4,
latent attention of 4 heads (16 nope + 8 rope dimensions, 16 for v, a kv
rank of 32), the published layer lists cut to 5 layers (the dense
delta-rule layer, two more, the latent-attention layer, one more), 16
experts routed over with top 4, one shared expert, seeded weights with
non-zero correction biases. No JAX.

Tolerances, each with its reason:

- The delta rule alone, fp32 against the recurrence in float64: outputs
  within 2e-5 of their largest and gradients within 1e-4 of theirs. The
  chunks sum the same terms in another order, with the decays as
  exponents of cumulative sums (fp32: a relative error of about 1e-7 of
  the largest sum, which decays of tens of nats a token make 1e-5 of a
  weight that is then below 1e-20).
- The model, fp32 compute: each row's embedding within 1e-5 (L2), the
  loss within 1e-5 relative: sums in another order, nothing else. Every
  leaf's gradient within 1e-3 of its norm (of a thousandth of the median
  leaf's): the first layer's decay projection's gradient answers relative
  noise of 2^-24 in the weights (fp32's round-off) by 2e-4 at this width
  and init (see the bf16 note), so sums in another order move it by as
  much; every other leaf reads under 1e-5.
- bf16 compute over fp32 masters (as the model trains), the program's
  routers held to the reference's choices (tests/deepseek_v3_routing.py):
  the widest row embedding's gap (L2) within 0.08, the loss's within 3e-2
  (relative) and the widest leaf gradient's within 0.25 (over the larger
  of its norm and the median leaf's): about twice the widest of seeds 1-4
  (0.036-0.041, 2.4e-4 to 1.4e-2, 0.094-0.124). bf16 rounds each
  product's inputs to 2^-8, and at 64 wide the rounding reaches every
  embedding; the delta rule itself runs in fp32 in both. The test's
  ``v_proj`` is scaled by 1/8 (``V_SCALE``): at 16 dimensions a head the
  rule's output o is about 8 times what it is at the published 128 (q is
  scaled by d^-1/2 and q.k of unit vectors shrinks as d^-1/2), which puts
  o's mean square well above the gated output norm's eps. There the norm
  divides o by its own size, and where o's sum cancels near zero, bf16's
  rounding turns a head's output whole: unscaled, the bf16 program read
  embedding gaps of 0.05-0.11 and gradient gaps of 0.26-0.92 on seeds 1-4,
  and rounding the weights alone to bf16 0.07-0.14 and 0.14-1.02. Scaled,
  o's mean square lies near the eps, as at the published width.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

import reference_kimi_linear as ref
from deepseek_v3_routing import held_to_reference
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import family as model_family
from rag_icd10_tpu_torch.models import kimi_linear as kl
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.ops import kda as kda_op
from rag_icd10_tpu_torch.parallel import train as ptrain
from rag_icd10_tpu_torch.tools import train_encoder as ttool
from rag_icd10_tpu_torch.utils.metrics import metrics

torch.set_num_threads(2)  # the suite runs several test processes at once

PUBLISHED_LISTS = dict(  # Kimi-Linear-48B-A3B's linear_attn_config, the lists as published
    full_attn_layers=[4, 8, 12, 16, 20, 24, 27],
    kda_layers=[1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26])
SMALL = dict(
    model_type="kimi_linear", vocab_size=300, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=32, num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=4,
    kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    num_experts=16, num_experts_per_token=4, num_shared_experts=1, routed_scaling_factor=2.446,
    moe_renormalize=True, moe_router_activation_func="sigmoid", num_expert_group=1,
    topk_group=1, use_grouped_topk=True, first_k_dense_replace=1, moe_layer_freq=1,
    rms_norm_eps=1e-5, mla_use_nope=True, hidden_act="silu", rope_theta=10000,
    linear_attn_config=dict(PUBLISHED_LISTS, head_dim=16, num_heads=4, short_conv_kernel_size=4))
MOE_LAYER = "model.layers.1.mlp."
V_SCALE = 1 / 8  # v_proj's init scale: o at the published head width's size (the module's note)


def _arch(compute="float32", **kw):
    return kl.KimiLinearArch.from_config(dict(SMALL, **kw), compute_dtype=getattr(torch, compute))


def _params(arch, seed=1):
    """Seeded weights; correction biases std 0.1, norm scales and the
    output gate's bias away from their inits, so that none reads as a
    no-op; ``v_proj`` scaled by ``V_SCALE``."""
    params = kl.init_params(arch, seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if k.endswith("v_proj.weight"):
            params[k] = v * np.float32(V_SCALE)
        elif k.endswith("e_score_correction_bias") or k.endswith("g_b_proj.bias"):
            params[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("norm.weight"):
            params[k] = (1.0 + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
    return params


def _model(arch, params):
    model = kl.SentenceKimiLinear(arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _tensors(params, grad=True):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad and not k.endswith("correction_bias"))
            for k, v in params.items()}


def _rows(n, s, seed, lengths=None):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, SMALL["vocab_size"], (n, s), generator=gen)
    lengths = lengths or [int(x) for x in torch.randint(2, s + 1, (n,), generator=gen)]
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).long()
    return ids * mask, mask


def _row_err(a, b):
    return float(torch.linalg.vector_norm(a.detach() - b.detach(), dim=-1).max())


TOL = {"float32": dict(emb=1e-5, loss=1e-5, grad=1e-3, floor=1e-3),
       "bfloat16": dict(emb=0.08, loss=3e-2, grad=0.25, floor=1.0)}


@pytest.fixture(autouse=True)
def fresh_counters():
    metrics.reset()


# ------------------------------------------------------- the delta rule alone


def _rule_inputs(s, seed, fastest=3.0, b=2, h=3, d=8):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=gen) for _ in range(3))
    g = -fastest * torch.rand(b, s, h, d, generator=gen)
    beta = torch.rand(b, s, h, generator=gen)
    return q, k, v, g, beta


@pytest.mark.parametrize("s", [1, 15, 16, 17, 48, 96, 130])
def test_chunked_rule_is_the_recurrence(s):
    """Outputs and every input's gradient, at lengths around the blocks of
    16 and the chunks of 48 (a partial last chunk at 130)."""
    inputs = _rule_inputs(s, seed=s)
    ours = [t.clone().requires_grad_(True) for t in inputs]
    theirs = [t.double().requires_grad_(True) for t in inputs]
    o, o_ref = kda_op.kda(*ours), ref.delta_rule(*theirs)
    weight = torch.randn(o.shape, generator=torch.Generator().manual_seed(1))
    (o * weight).sum().backward()
    (o_ref * weight.double()).sum().backward()
    assert o.dtype == torch.float32 and o.shape == o_ref.shape
    o, o_ref = o.detach().double(), o_ref.detach()
    assert float((o - o_ref).abs().max()) <= 2e-5 * float(o_ref.abs().max())
    largest = max(float(t.grad.abs().max()) for t in theirs)
    for name, a, b in zip("qkvgb", ours, theirs):  # at S = 1 the decay takes no gradient
        scale = max(float(b.grad.abs().max()), 1e-3 * largest)
        assert float((a.grad.double() - b.grad).abs().max()) <= 1e-4 * scale, name


def test_decays_of_tens_of_nats_a_token_stay_finite():
    """The overflow trap: log-decays down to -50 a token sum past 88 nats
    within two tokens, and to thousands within a chunk. Factored as
    exp(Gamma_t) exp(-Gamma_j) the weights would overflow fp32; the rule
    gives finite outputs and gradients that match the recurrence."""
    inputs = _rule_inputs(96, seed=5, fastest=50.0)
    ours = [t.clone().requires_grad_(True) for t in inputs]
    theirs = [t.double().requires_grad_(True) for t in inputs]
    o, o_ref = kda_op.kda(*ours), ref.delta_rule(*theirs)
    o.sum().backward()
    o_ref.sum().backward()
    o, o_ref = o.detach(), o_ref.detach()
    assert torch.isfinite(o).all()
    assert float((o.double() - o_ref).abs().max()) <= 2e-5 * float(o_ref.abs().max())
    for a, b in zip(ours, theirs):
        assert torch.isfinite(a.grad).all()
        assert float((a.grad.double() - b.grad).abs().max()) <= 1e-4 * float(b.grad.abs().max())


def test_the_core_counts_its_calls_and_is_recomputed_in_the_backward():
    """One ``kda.core_calls`` a forward call, none for the backward's
    recomputation; with a gradient wanted, the core keeps only its inputs."""
    inputs = [t.requires_grad_(True) for t in _rule_inputs(48, seed=2)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        o = kda_op.kda(*inputs)
    assert all(any(t is x for x in inputs) for t in saved)  # the checkpoint keeps its inputs
    o.sum().backward()
    assert metrics.counters("kda.")["kda.core_calls"] == 1
    with torch.no_grad():
        kda_op.kda(*inputs)
    assert metrics.counters("kda.")["kda.core_calls"] == 2


def test_on_a_cpu_tensor_kda_is_the_plain_version():
    """The CPU path: ``kda_reference`` to the bit, output and gradients; no
    kernel launched or counted."""
    inputs = _rule_inputs(50, seed=3)
    ours = [t.clone().requires_grad_(True) for t in inputs]
    theirs = [t.clone().requires_grad_(True) for t in inputs]
    launches = kda_op.kda.launches
    o, o_ref = kda_op.kda(*ours), kda_op.kda_reference(*theirs)
    o.square().sum().backward()
    o_ref.square().sum().backward()
    assert torch.equal(o, o_ref)
    for a, b in zip(ours, theirs):
        assert torch.equal(a.grad, b.grad)
    assert kda_op.kda.launches == launches
    assert metrics.counters("kda.").get("kda.kernel_calls", 0) == 0


def _kernel_inputs(**change):
    """Inputs the kernels take (on any device), with ``change`` applied:
    q, k, v (1, 5, 2, 128) bf16, g and beta fp32."""
    gen = torch.Generator().manual_seed(0)
    shape = change.pop("shape", (1, 5, 2, 128))
    t = {name: torch.randn(*shape, generator=gen).to(torch.bfloat16) for name in "qkv"}
    t["g"] = -torch.rand(*shape, generator=gen)
    t["beta"] = torch.rand(*shape[:3], generator=gen)
    for name, fn in change.items():
        t[name] = fn(t[name])
    return [t[name] for name in ("q", "k", "v", "g", "beta")]


@pytest.mark.parametrize("what,change", [
    ("head width 64", dict(shape=(1, 5, 2, 64))),
    ("fp16 q, k, v", {n: (lambda x: x.half()) for n in "qkv"}),
    ("fp16 q alone", dict(q=lambda x: x.half())),
    ("bf16 g", dict(g=lambda x: x.bfloat16())),
    ("bf16 beta", dict(beta=lambda x: x.bfloat16())),
    ("k of another length", dict(k=lambda x: x[:, :4])),
    ("g of other heads", dict(g=lambda x: x[:, :, :1])),
    ("beta with a channel axis", dict(beta=lambda x: x[..., None])),
    ("three axes", {n: (lambda x: x[0]) for n in "qkvg"}),
    ("no positions", dict(shape=(1, 0, 2, 128))),
])
def test_the_kernel_input_check_refuses_what_the_kernels_do_not_take(what, change):
    with pytest.raises(ValueError):
        kda_op.check_kernel_inputs(*_kernel_inputs(**change))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_input_check_takes_the_kernels_inputs(dtype):
    q, k, v, g, beta = _kernel_inputs()
    kda_op.check_kernel_inputs(q.to(dtype), k.to(dtype), v.to(dtype), g, beta)
    # the short convolutions' layout (token stride 1) is read in place
    conv = torch.randn(1, 256, 5).to(dtype).transpose(1, 2).unflatten(-1, (2, 128))
    kda_op.check_kernel_inputs(conv, conv, conv, g, beta)
    assert kda_op.chunks(1) == 1 and kda_op.chunks(48) == 1 and kda_op.chunks(97) == 3


# ------------------------------------------------------------------ the model


def _reference_routing(w, calls, compute):
    return (held_to_reference(w, calls, ref.deepseek_cfg(SMALL), hidden=_ref_hidden)
            if compute == "bfloat16" else contextlib.nullcontext([]))


def _ref_hidden(w, ids, cfg):
    return ref.hidden(w, ids, SMALL)


def _triplets(seed=3, n=6):
    a_ids, a_mask = _rows(n, 12, seed)
    b_ids, b_mask = _rows(n, 24, seed + 1)
    h_ids, h_mask = _rows(n, 12, seed + 2)
    zeros = torch.zeros_like
    rng = np.random.default_rng(seed)
    return {"a_ids": a_ids, "a_mask": a_mask, "a_types": zeros(a_ids),
            "b_ids": b_ids, "b_mask": b_mask, "b_types": zeros(b_ids),
            "h_ids": h_ids, "h_mask": h_mask, "h_types": zeros(h_ids),
            "group_a": torch.arange(n), "group_b": torch.arange(n),
            "h_group": torch.arange(n) + n,
            "w_b": torch.from_numpy(rng.choice([0.8, 1.0, 1.2], n).astype(np.float32)),
            "w_h": torch.from_numpy(rng.choice([0.8, 1.0, 1.2], n).astype(np.float32))}


def _ref_loss(w, batch):
    """The weighted, masked InfoNCE written out plainly (temperature 0.05),
    and the embeddings (anchors, positives, hard negatives)."""
    n = batch["a_ids"].shape[0]
    zah = ref.encode(w, *(torch.cat([batch[f"a_{k}"], batch[f"h_{k}"]]) for k in ("ids", "mask")),
                     SMALL)
    za, zh = zah[:n], zah[n:]
    zb = ref.encode(w, batch["b_ids"], batch["b_mask"], SMALL)
    ga, gb, gh = batch["group_a"], batch["group_b"], batch["h_group"]
    pos = (za @ zb.T) * batch["w_b"][None, :] / 0.05
    same = ((ga[:, None] == ga[None, :]) | (gb[:, None] == gb[None, :])
            | (ga[:, None] == gb[None, :]) | (gb[:, None] == ga[None, :]))
    pos = pos.masked_fill(same & ~torch.eye(n, dtype=torch.bool), -1e9)
    hn = (za @ zh.T) * batch["w_h"][None, :] / 0.05
    hn = hn.masked_fill((gh[None, :] == ga[:, None]) | (gh[None, :] == gb[:, None]), -1e9)
    labels = torch.arange(n)
    ce = torch.nn.functional.cross_entropy
    return 0.5 * (ce(torch.cat([pos, hn], 1), labels) + ce(pos.T, labels)), torch.cat([za, zb, zh])


def _reference_step(params, batch, floor):
    """The reference's weights, and its embeddings, loss and every leaf's
    gradient of one step, with ``floor`` (the share of the median leaf's
    gradient norm a leaf's gap is taken over, at the least)."""
    w = _tensors(params)
    leaves = [k for k, v in w.items() if v.requires_grad]
    loss_r, z_r = _ref_loss(w, batch)
    grads_r = dict(zip(leaves, torch.autograd.grad(loss_r, [w[k] for k in leaves])))
    return w, (z_r.detach(), float(loss_r.detach()), grads_r, floor)


def _gaps(compute, params, batch, w, want):
    """The program's step in ``compute`` from ``params`` against the
    reference's (``_reference_step``): the widest row embedding's L2 gap,
    the loss's relative gap, and each leaf's gradient gap over the larger of
    its norm and the floor."""
    z_r, loss_r, grads_r, floor = want
    model = _model(_arch(compute), params)
    calls = [torch.cat([batch["a_ids"], batch["h_ids"]]), batch["b_ids"]]
    with _reference_routing(w, calls, compute):
        za, zb, zh = ptrain._embed(model, batch)
    loss, _ = ptrain._loss(batch, za, zb, zh, 0.05)
    loss.backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(grads_r)  # the correction biases are no parameters
    norms = {k: float(g.norm()) for k, g in grads_r.items()}
    least = floor * float(np.median(list(norms.values())))
    gaps = {k: float(((torch.zeros_like(p) if p.grad is None else p.grad) - grads_r[k]).norm())
            / max(norms[k], least) for k, p in grads.items()}
    return (_row_err(torch.cat([za, zb, zh]), z_r),
            abs(float(loss.detach()) - loss_r) / loss_r, gaps)


def _matches_reference(compute):
    tol = TOL[compute]
    params, batch = _params(_arch()), _triplets()
    w, want = _reference_step(params, batch, tol["floor"])
    assert any(k.endswith("A_log") for k in want[2])
    assert any(k.endswith("conv1d.weight") for k in want[2])
    emb, loss, grads = _gaps(compute, params, batch, w, want)
    worst = max(grads, key=grads.get)
    assert emb < tol["emb"] and loss < tol["loss"] and grads[worst] < tol["grad"], \
        (emb, loss, worst, grads[worst])


def test_embeddings_loss_and_every_gradient_match_reference_in_fp32():
    _matches_reference("float32")


def test_embeddings_loss_and_every_gradient_match_reference_in_bf16():
    """Within the bf16 limits (the module's note)."""
    _matches_reference("bfloat16")


def test_expert_shares_add_up_to_the_whole_layer():
    """Four ranks of four experts each: the parts their Kimi expert layers
    give, with the shared expert (which every rank computes alike) counted
    once, add up to the uncut reference layer."""
    params = _params(_arch())
    w = _tensors(params, grad=False)
    shared_cfg = ref.deepseek_cfg(SMALL)
    x = torch.randn(40, SMALL["hidden_size"], generator=torch.Generator().manual_seed(4))
    shared = ref.swiglu(w, MOE_LAYER + "shared_experts.", x)
    total = shared.clone()
    for rank in range(4):
        held = list(range(4 * rank, 4 * rank + 4))
        layer = dv.ExpertShare(_arch(experts_held=held).deepseek(), 10 + rank)
        layer.load_state_dict({k[len(MOE_LAYER):]: torch.from_numpy(v) for k, v in params.items()
                               if k.startswith(MOE_LAYER)
                               and (".experts." not in k or int(k.split(".")[5]) in held)})
        total += layer(x[None])[0].detach() - shared
    whole = ref.dsv3.moe(w, MOE_LAYER, x, shared_cfg)
    assert float((total - whole).abs().max()) < 1e-5
    assert float((whole - shared).abs().max()) > 0.1 * float(shared.abs().max())


def test_right_padding_changes_no_valid_row():
    """Within 1e-5: the wider rows are chunked otherwise (one chunk of 48
    against one of 16), and a row alone takes other batched products, so
    the rule sums in another order."""
    arch = _arch()
    model = _model(arch, _params(arch))
    ids, mask = _rows(5, 14, seed=7, lengths=[14, 9, 5, 12, 2])
    z = model(ids, mask)
    wide_ids = torch.cat([ids, torch.randint(1, 300, (5, 26))], 1)  # pads hold any id
    wide_mask = torch.cat([mask, torch.zeros(5, 26, dtype=torch.long)], 1)
    assert _row_err(model(wide_ids, wide_mask), z) < 1e-5
    for r in (1, 4):  # a row's embedding is its own: alone or among others
        assert _row_err(model(ids[r:r + 1], mask[r:r + 1]), z[r:r + 1]) < 1e-5


def test_the_published_layer_lists_at_a_cut_depth():
    """The lists are 1-based and run past the cut: 5 layers are delta rule,
    delta rule, delta rule, latent attention, delta rule; the first dense,
    the rest expert layers; each under its own span."""
    arch = _arch()
    model = kl.SentenceKimiLinear(arch)
    mixers = [type(layer.self_attn).__name__ for layer in model.model.layers]
    assert mixers == ["KimiDeltaAttention"] * 3 + ["LatentAttention", "KimiDeltaAttention"]
    assert [type(layer.mlp).__name__ for layer in model.model.layers] == \
        ["SwiGLU"] + ["ExpertShare"] * 4
    assert [layer.span for layer in model.model.layers] == ["kda"] * 3 + ["mla", "kda"]
    deep = _arch(num_hidden_layers=9)
    assert [deep.is_kda(i) for i in range(9)] == [True] * 3 + [False] + [True] * 3 + [False, True]
    with pytest.raises(ValueError, match="layer 5 is in neither"):
        _arch(linear_attn_config=dict(SMALL["linear_attn_config"], kda_layers=[1, 2, 3]))
    with pytest.raises(ValueError, match="layer 4 is in both"):
        _arch(linear_attn_config=dict(SMALL["linear_attn_config"], kda_layers=[1, 2, 3, 4, 5]))


def test_config_round_trip_and_what_is_not_implemented():
    arch = _arch(experts_held=[3, 7])
    back = kl.KimiLinearArch.from_config(json.loads(json.dumps(arch.to_config())))
    assert back == dataclasses.replace(arch, compute_dtype=torch.bfloat16)
    assert back.held == (3, 7) and back.num_experts == 16
    for bad in ({"mla_use_nope": False}, {"moe_router_activation_func": "softmax"},
                {"num_expert_group": 8}, {"q_lora_rank": 1536}, {"experts_held": [16]}):
        with pytest.raises(ValueError):
            kl.KimiLinearArch.from_config(dict(SMALL, **bad))


def test_the_step_reads_no_counter(monkeypatch):
    """The expert layers count their slots on the device and read their
    counts once a layer; the model reads no other value on the host (each
    read waits for the device), and the step reads no counter."""
    arch = _arch("bfloat16")
    state = ptrain.init_train_state(arch, params=_params(arch), device="cpu", learning_rate=1e-3)
    batch = _triplets()
    reads, inside = [], []
    real_forward = state.model.forward

    def forward(*a, **kw):
        inside.append(True)
        try:
            return real_forward(*a, **kw)
        finally:
            inside.pop()

    def counted(name, real):
        def read(self, *a, **kw):
            if inside:
                reads.append(name)
            return real(self, *a, **kw)
        return read

    def refuse(*a, **kw):
        raise AssertionError("counters read inside the step")

    monkeypatch.setattr(state.model, "forward", forward)
    monkeypatch.setattr(metrics, "counters", refuse)
    for name in ("tolist", "item", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, counted(name, getattr(torch.Tensor, name)))
    ptrain.make_train_step()(state, batch)
    monkeypatch.undo()
    assert reads == ["tolist"] * 8  # 4 expert layers x 2 model calls
    after = metrics.counters()
    assert after["kda.core_calls"] == 8  # 4 delta-rule layers x 2 model calls
    assert after.get("kda.kernel_calls", 0) == 0  # the CPU path: the plain version
    tokens = sum(int(np.prod(batch[f"{r}_ids"].shape)) for r in "abh")
    for layer in (1, 2, 3, 4):
        assert after[f"moe.routed_slots.{layer}"] == 4 * tokens


# --------------------------------------------------------- the CLI end to end


@pytest.fixture
def decoder_cli(tmp_path, monkeypatch):
    """A 300-row synthetic CSV and a small kimi_linear checkpoint (experts
    4-7 of 16 held) with config.json and vocab.txt beside it."""
    corpus = synthetic_corpus(300, seed=3)
    csv = tmp_path / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    base = tconfig.Config()
    cfg = dataclasses.replace(
        base, data_path=str(csv),
        encoder=dataclasses.replace(base.encoder, weights_path=None, vocab_path=None),
        store=dataclasses.replace(base.store, db_path=str(tmp_path / "db" / "s")))
    monkeypatch.setattr(tconfig, "get_config", lambda: cfg)
    tok = WordPieceTokenizer.from_corpus(corpus.titles + corpus.semantic_texts)
    arch = _arch(vocab_size=tok.vocab_size + 5, experts_held=[4, 5, 6, 7])
    init = tmp_path / "init"
    init.mkdir()
    tok.save_vocab(str(init / "vocab.txt"))
    params = _params(arch)
    kl.save_weights(params, arch, str(init / "params.npz"))
    return tmp_path, arch, params


ARGS = ["--batch", "8", "--seq-a", "12", "--seq-b", "24", "--log-every", "1",
        "--weighted-loss"]


def test_cli_trains_a_kimi_decoder_saves_and_reloads(decoder_cli, caplog):
    tmp, arch, start = decoder_cli
    out = tmp / "run"
    with caplog.at_level("INFO", logger="rag_icd10_tpu_torch.train"):
        rc = ttool.main(ARGS + ["--steps", "2", "--init-from", str(tmp / "init" / "params.npz"),
                                "--params-only", "--out", str(out), "--save-every", "0"],
                        device="cpu")
    assert rc == 0
    family, config = model_family.beside(str(out / "params.npz"))
    assert family.model_type == "kimi_linear" and config["linear_attn_config"]["num_heads"] == 4
    again = family.arch(config, None, 0)
    assert again == dataclasses.replace(arch, compute_dtype=torch.bfloat16)
    saved = kl.load_weights(str(out / "params.npz"), again)
    assert set(saved) == set(start)
    for k, v in start.items():
        if k.endswith("e_score_correction_bias"):  # selection only: never trained
            np.testing.assert_array_equal(saved[k], v)
    assert not np.array_equal(saved["model.layers.0.self_attn.A_log"],
                              start["model.layers.0.self_attn.A_log"])
    state = ptrain.init_train_state(again, params=saved, device="cpu")
    for k, v in state.params().items():
        np.testing.assert_array_equal(v, saved[k])
    lines = [r for r in caplog.records if str(r.msg).startswith("step %d/%d loss=")]
    assert len(lines) == 2
    for r in lines:
        text = r.getMessage()
        assert "KDA core 8.0 calls a step, kernel 0.0" in text and "experts held" in text
        assert "MLA kernel 0.0 calls a step" in text and "norm kernel 0.0 calls a step" in text
