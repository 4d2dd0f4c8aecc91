"""The Xing4.0 sentence encoder (models/xing4.py) on the CPU, against the
plain fp32 reference (tests/reference_xing4.py) at a small size: 64 wide,
latent attention of 4 heads (16 nope + 8 rope dimensions, 16 for v, a q
rank and a kv rank of 32) with the published YaRN scaling, 4 residual
streams mixed by 20 Sinkhorn steps, 2 dense layers and 4 expert layers, 16
experts routed over with top 4, one shared expert, seeded weights with
non-zero correction biases. No JAX.

Tolerances, each with its reason:

- fp32 compute: each row's embedding within 1e-5 (L2), the loss within
  1e-5 relative, every leaf's gradient within 1e-3 of the larger of its
  norm and a thousandth of the median leaf's: the same operations summed
  in other orders (phi's product as one matrix product over the flat
  streams, the norm of the streams as a vector norm) and nothing else.
- bf16 compute over fp32 masters (as the model trains), the program's
  routers held to the reference's choices (tests/deepseek_v3_routing.py):
  the widest row embedding's gap (L2) within 0.075, the loss's within
  5e-3 (relative), the widest leaf gradient's within 0.15 over the larger
  of its norm and the median leaf's: the widest of seeds 1-4 read
  0.020-0.032, 7.0e-4 to 4.2e-3 and 0.066-0.078. bf16 rounds each
  projection's inputs to 2^-8; phi's product, the streams, the H maps and
  the Sinkhorn loop are fp32 in both.
- H_res: doubly stochastic. The loop ends on the columns, so each column
  sums to s / (s + hc_eps) with s within rounding of 1: within 1e-6 of
  1 - hc_eps. The rows within 1e-2 after 20 steps at these weights: the
  loop converges slowly for a token whose logits spread over several
  nats (the widest row sum's gap 4.6e-3 on the test's 64 tokens).
- The planted faults (H_res the identity; a row softmax in the Sinkhorn
  loop's place; H_post without its factor 2; the four streams held equal,
  one stream's worth) each move the fp32 embeddings by 0.31-0.72: over
  twice the bf16 limit, and 10^4 times the fp32 one.
"""

import contextlib
import dataclasses
import json
import math
from unittest import mock

import numpy as np
import pytest
import torch

import reference_deepseek_v3 as ref_dsv3
import reference_xing4 as ref
from deepseek_v3_routing import held_to_reference
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import family as model_family
from rag_icd10_tpu_torch.models import xing4 as xg
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.parallel import train as ptrain
from rag_icd10_tpu_torch.tools import train_encoder as ttool
from rag_icd10_tpu_torch.utils.metrics import metrics

torch.set_num_threads(2)  # the suite runs several test processes at once

YARN = dict(type="yarn", factor=64, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=1, mscale_all_dim=1)  # Xing4.0-29B-A4B's rope_scaling
SMALL = dict(
    model_type="xing4_0", vocab_size=300, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=32, num_hidden_layers=6, num_attention_heads=4, num_key_value_heads=4,
    kv_lora_rank=32, q_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1, routed_scaling_factor=2.0,
    norm_topk_prob=True, scoring_func="sigmoid", topk_method="noaux_tc", n_group=1,
    topk_group=1, first_k_dense_replace=2, moe_layer_freq=1, rms_norm_eps=1e-6,
    rope_theta=10000, max_position_embeddings=262144, rope_scaling=YARN, hidden_act="silu",
    attention_bias=False, hc_mult=4, hc_sinkhorn_iters=20, hc_eps=1e-6,
    mhc_h_res_clamp_min=-30, mhc_h_res_clamp_max=30, num_nextn_predict_layers=1)
MOE_LAYER = "model.layers.2."


def _arch(compute="float32", **kw):
    return xg.Xing4Arch.from_config(dict(SMALL, **kw), compute_dtype=getattr(torch, compute))


def _params(arch, seed=1):
    """Seeded weights; correction biases std 0.1 and RMSNorm scales near 1,
    so that neither reads as a no-op."""
    params = xg.init_params(arch, seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if k.endswith("e_score_correction_bias"):
            params[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("norm.weight"):
            params[k] = (1.0 + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
    return params


def _model(arch, params):
    model = xg.SentenceXing4(arch)
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
       "bfloat16": dict(emb=0.075, loss=5e-3, grad=0.15, floor=1.0)}


@pytest.fixture(autouse=True)
def fresh_counters():
    metrics.reset()


# ------------------------------------------------------------------ the model


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


def _reference_routing(w, batch, compute):
    calls = [torch.cat([batch["a_ids"], batch["h_ids"]]), batch["b_ids"]]
    return (held_to_reference(w, calls, SMALL, hidden=ref.hidden)
            if compute == "bfloat16" else contextlib.nullcontext([]))


def _gaps(compute, params, batch, w, want):
    """The program's step in ``compute`` from ``params`` against the
    reference's (``_reference_step``): the widest row embedding's L2 gap,
    the loss's relative gap, and each leaf's gradient gap over the larger of
    its norm and the floor."""
    z_r, loss_r, grads_r, floor = want
    model = _model(_arch(compute), params)
    with _reference_routing(w, batch, compute):  # the backward's recomputation routes too
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


def _matches_reference(compute, seed=1):
    tol = TOL[compute]
    params, batch = _params(_arch(), seed), _triplets()
    w, want = _reference_step(params, batch, tol["floor"])
    assert any(k.endswith("hc_mlp.fn") for k in want[2])
    assert any(k.endswith("q_a_layernorm.weight") for k in want[2])
    emb, loss, grads = _gaps(compute, params, batch, w, want)
    worst = max(grads, key=grads.get)
    assert emb < tol["emb"] and loss < tol["loss"] and grads[worst] < tol["grad"], \
        (emb, loss, worst, grads[worst])
    return emb, loss, grads[worst]


def test_embeddings_loss_and_every_gradient_match_reference_in_fp32():
    _matches_reference("float32")


def test_embeddings_loss_and_every_gradient_match_reference_in_bf16():
    """Within the bf16 limits (the module's note)."""
    _matches_reference("bfloat16")


def _embed_gap(params, ids, mask):
    """The widest row gap of the program's fp32 embeddings from the reference's."""
    with torch.no_grad():
        z = _model(_arch(), params)(ids, mask)
        z_ref = ref.encode(_tensors(params, grad=False), ids, mask, SMALL)
    return _row_err(z, z_ref)


def _identity(logits, iters, eps):
    return torch.eye(logits.shape[-1]).expand(logits.shape)


def _row_softmax(logits, iters, eps):
    return torch.softmax(logits, -1)


def _half_post(self, x):
    pre, post, res = REAL_MAPS(self, x)
    return pre, post / 2, res


def _one_stream(x, y, maps):
    out = REAL_POST(x, y, maps)
    return out.mean(-2, keepdim=True).expand_as(out)


REAL_MAPS, REAL_POST = xg.HyperConnection.maps, xg.HyperConnection.post


@pytest.mark.parametrize("fault", [
    mock.patch.object(xg, "sinkhorn", _identity),
    mock.patch.object(xg, "sinkhorn", _row_softmax),
    mock.patch.object(xg.HyperConnection, "maps", _half_post),
    mock.patch.object(xg.HyperConnection, "post", staticmethod(_one_stream))],
    ids=["h_res_identity", "sinkhorn_dropped", "h_post_without_2", "one_stream"])
def test_each_planted_fault_fails_the_comparison(fault):
    params = _params(_arch())
    ids, mask = _rows(6, 16, seed=11)
    assert _embed_gap(params, ids, mask) < TOL["float32"]["emb"]
    with fault:
        gap = _embed_gap(params, ids, mask)
    assert gap > 2 * TOL["bfloat16"]["emb"], gap


def test_h_res_is_doubly_stochastic():
    """Every token's H_res at every sublayer of the test's model."""
    arch = _arch()
    model = _model(arch, _params(arch))
    ids, mask = _rows(4, 16, seed=5)
    found, real = [], xg.sinkhorn

    def keep(logits, iters, eps):
        found.append(real(logits, iters, eps))
        return found[-1]

    with mock.patch.object(xg, "sinkhorn", keep), torch.no_grad():
        model(ids, mask)
    assert len(found) == 2 * arch.num_hidden_layers
    for h in found:
        assert float((h.sum(-2) - (1 - arch.hc_eps)).abs().max()) <= 1e-6
        assert float((h.sum(-1) - 1).abs().max()) <= 1e-2
        assert float(h.min()) >= 0
        # far from the identity and from uniform: the loop and the product both show
        assert float((h - torch.eye(4)).abs().amax((-2, -1)).min()) > 0.05
        assert float((h - 0.25).abs().amax((-2, -1)).min()) > 0.05


def test_yarn_tables_and_scale_follow_the_formula():
    """Xing4.0's rope_scaling at the rope width 64 and theta 10,000, written
    out: correction dimensions floor(64 ln(4096 / (32 2 pi)) / (2 ln 1e4)) =
    10 and ceil(64 ln(4096 / (2 pi)) / (2 ln 1e4)) = 23; a linear ramp
    between them from theta^(-2i/64) (i <= 10) to it over 64 (i >= 23);
    tables scaled by mscale(64, 1) / mscale(64, 1) = 1; the softmax scale
    192^-1/2 (0.1 ln 64 + 1)^2."""
    yarn = dv.YaRN.from_config(YARN)
    d, theta = 64, 10000.0
    low = math.floor(d * math.log(4096 / (32 * 2 * math.pi)) / (2 * math.log(theta)))
    high = math.ceil(d * math.log(4096 / (1 * 2 * math.pi)) / (2 * math.log(theta)))
    assert (low, high) == (10, 23)
    want = []
    for i in range(d // 2):
        base = theta ** (-2 * i / d)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(base * (1 - ramp) + base / 64 * ramp)
    want = torch.tensor(want, dtype=torch.float64)
    got = yarn.inv_freq(d, theta, "cpu").double()
    assert float(((got - want) / want).abs().max()) < 1e-6
    cos, sin = dv.rope_tables(96, d, theta, "cpu", yarn)
    angle = torch.arange(96, dtype=torch.float64)[:, None] * want[None, :]
    angle = torch.cat([angle, angle], -1)
    assert float((cos.double() - angle.cos()).abs().max()) < 2e-5  # fp32 angles up to 95 rad
    assert float((sin.double() - angle.sin()).abs().max()) < 2e-5
    assert yarn.table_scale == 1.0
    arch = xg.Xing4Arch()
    assert arch.softmax_scale == pytest.approx(192 ** -0.5 * (0.1 * math.log(64) + 1) ** 2,
                                               rel=1e-12)
    assert arch.softmax_scale == pytest.approx(ref.softmax_scale(dict(
        SMALL, qk_nope_head_dim=128, qk_rope_head_dim=64)), rel=1e-12)
    # the reference's own frequencies, the same formula
    small = dict(SMALL, qk_rope_head_dim=d)
    assert float(((ref.inv_freq(small) - want) / want).abs().max()) < 1e-12
    # no scaling: no change to the tables or the scale
    assert dv.DeepseekV3Arch().softmax_scale is None


def test_expert_shares_add_up_to_the_whole_layer():
    """Four ranks of four experts each, at one MLP sublayer with its
    hyper-connection: the parts the ranks' layers give, with H_res X and
    the shared expert (which every rank computes alike) counted once, add
    up to the uncut reference sublayer."""
    params = _params(_arch())
    w = _tensors(params, grad=False)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(1, 40, 4, SMALL["hidden_size"], generator=gen)
    prefix = MOE_LAYER + "hc_mlp."
    norm = MOE_LAYER + "post_attention_layernorm.weight"
    _, post, res = ref.mixing(w, prefix, x, SMALL)

    def shared_only(h):
        return ref.swiglu(w, MOE_LAYER + "mlp.shared_experts.", h)

    common = ref.sublayer(w, prefix, x, SMALL, shared_only, norm)  # H_res X + H_post shared
    total = common.clone()
    for rank in range(4):
        held = list(range(4 * rank, 4 * rank + 4))
        arch = _arch(experts_held=held)
        layer = xg.Xing4DecoderLayer(arch, 2)
        layer.load_state_dict({k[len(MOE_LAYER):]: torch.from_numpy(v) for k, v in params.items()
                               if k.startswith(MOE_LAYER)
                               and (".experts." not in k or int(k.split(".")[5]) in held)})
        with torch.no_grad():
            h, maps = layer.hc_mlp.pre(x)
            total += layer.feed_forward(x, h, maps) - common
    whole = ref.sublayer(w, prefix, x, SMALL,
                         lambda h: ref_dsv3.moe(w, MOE_LAYER + "mlp.", h.reshape(-1, h.shape[-1]),
                                                SMALL).view(h.shape), norm)
    assert float((total - whole).abs().max()) < 1e-4
    assert float((whole - common).abs().max()) > 0.1 * float(common.abs().max())


def test_right_padding_changes_no_valid_row():
    arch = _arch()
    model = _model(arch, _params(arch))
    ids, mask = _rows(5, 14, seed=7, lengths=[14, 9, 5, 12, 2])
    with torch.no_grad():
        z = model(ids, mask)
        wide_ids = torch.cat([ids, torch.randint(1, 300, (5, 26))], 1)  # pads hold any id
        wide_mask = torch.cat([mask, torch.zeros(5, 26, dtype=torch.long)], 1)
        assert _row_err(model(wide_ids, wide_mask), z) < 1e-5
        for r in (1, 4):  # a row's embedding is its own: alone or among others
            assert _row_err(model(ids[r:r + 1], mask[r:r + 1]), z[r:r + 1]) < 1e-5


def test_layout_and_parameter_names():
    """2 dense layers then 4 expert layers; each sublayer its own mixing,
    q-LoRA under the published names, no q_proj."""
    arch = _arch()
    names = xg.weight_names(arch)
    model = xg.SentenceXing4(arch)
    assert [type(layer.mlp).__name__ for layer in model.model.layers] == \
        ["SwiGLU"] * 2 + ["ExpertShare"] * 4
    for i in range(6):
        p = f"model.layers.{i}."
        assert names[p + "hc_attn.fn"] == names[p + "hc_mlp.fn"] == (24, 4 * 64)
        assert names[p + "hc_attn.base"] == (24,) and names[p + "hc_attn.scale"] == (3,)
        assert names[p + "self_attn.q_a_proj.weight"] == (32, 64)
        assert names[p + "self_attn.q_a_layernorm.weight"] == (32,)
        assert names[p + "self_attn.q_b_proj.weight"] == (4 * 24, 32)
        assert p + "self_attn.q_proj.weight" not in names
    params = xg.init_params(arch, seed=2)
    bases = [params[f"model.layers.{i}.hc_{s}.base"] for i in range(6) for s in ("attn", "mlp")]
    assert len({b.tobytes() for b in bases}) == 12 and all(b.std() > 0.3 for b in bases)


def test_config_round_trip_and_what_is_not_implemented():
    arch = _arch(experts_held=[3, 7])
    back = xg.Xing4Arch.from_config(json.loads(json.dumps(arch.to_config())))
    assert back == dataclasses.replace(arch, compute_dtype=torch.bfloat16)
    assert back.held == (3, 7) and back.hc_mult == 4 and back.q_lora_rank == 32
    assert back.rope_scaling == dv.YaRN.from_config(YARN)
    assert model_family.of_arch(back).model_type == "xing4_0"
    for bad in ({"hc_mult": 0}, {"hc_sinkhorn_iters": 0},
                {"mhc_h_res_clamp_min": 30, "mhc_h_res_clamp_max": -30},
                {"rope_scaling": dict(YARN, type="dynamic")}, {"n_group": 8},
                {"scoring_func": "softmax"}, {"experts_held": [16]}, {"model_type": "deepseek_v3"}):
        with pytest.raises(ValueError):
            xg.Xing4Arch.from_config(dict(SMALL, **bad))


def test_recomputation_opens_no_span_and_counts_nothing():
    """A step's forward counts 12 ``pre`` calls a model call and opens one
    ``mhc`` span for each ``pre`` and ``post`` and the final sum, 6 ``mla``
    and 12 ``mhc.sinkhorn``; the backward, which recomputes every layer,
    adds none; its gradients are those of the same model run without
    recomputation."""
    arch = _arch()
    params = _params(arch)
    ids, mask = _rows(3, 10, seed=8)
    model = _model(arch, params)
    z = model(ids, mask)
    counts = {name: len(metrics.spans(name)) for name in ("mhc", "mhc.sinkhorn", "mla")}
    assert counts == {"mhc": 25, "mhc.sinkhorn": 12, "mla": 6}
    assert all(s.parent == "mhc" for s in metrics.spans("mhc.sinkhorn"))
    assert not any(s.parent == "mla" for s in metrics.spans("mhc"))
    z.square().sum().backward()
    assert {name: len(metrics.spans(name)) for name in counts} == counts
    assert metrics.counters("mhc.")["mhc.calls"] == 12
    plain = _model(arch, params)
    with mock.patch.object(xg, "_recomputed", lambda fn, *args: fn(*args)):
        plain(ids, mask).square().sum().backward()
    for (name, a), b in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_the_step_reads_no_counter_and_each_expert_layer_reads_its_counts_once(monkeypatch):
    arch = _arch("bfloat16")
    state = ptrain.init_train_state(arch, params=_params(arch), device="cpu", learning_rate=1e-3)
    batch = _triplets()
    reads = []
    real_tolist = torch.Tensor.tolist

    def tolist(self, *a, **kw):
        reads.append("tolist")
        return real_tolist(self, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("counters read inside the step")

    monkeypatch.setattr(metrics, "counters", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    ptrain.make_train_step()(state, batch)
    monkeypatch.undo()
    assert reads == ["tolist"] * 8  # 4 expert layers x 2 model calls; recomputed ones replay
    after = metrics.counters()
    assert after["mhc.calls"] == 24  # 6 layers x 2 sublayers x 2 model calls
    assert after.get("mla.kernel_calls", 0) == 0  # the CPU path: the plain versions


# --------------------------------------------------------- the CLI end to end


@pytest.fixture
def decoder_cli(tmp_path, monkeypatch):
    """A 300-row synthetic CSV and a small xing4_0 checkpoint (experts 4-7
    of 16 held) with config.json and vocab.txt beside it."""
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
    xg.save_weights(params, arch, str(init / "params.npz"))
    return tmp_path, arch, params


ARGS = ["--batch", "8", "--seq-a", "12", "--seq-b", "24", "--log-every", "1",
        "--weighted-loss"]


def test_cli_trains_a_xing4_decoder_saves_and_reloads(decoder_cli, caplog):
    tmp, arch, start = decoder_cli
    out = tmp / "run"
    with caplog.at_level("INFO", logger="rag_icd10_tpu_torch.train"):
        rc = ttool.main(ARGS + ["--steps", "2", "--init-from", str(tmp / "init" / "params.npz"),
                                "--params-only", "--out", str(out), "--save-every", "0"],
                        device="cpu")
    assert rc == 0
    family, config = model_family.beside(str(out / "params.npz"))
    assert family.model_type == "xing4_0" and config["hc_mult"] == 4
    again = family.arch(config, None, 0)
    assert again == dataclasses.replace(arch, compute_dtype=torch.bfloat16)
    saved = xg.load_weights(str(out / "params.npz"), again)
    assert set(saved) == set(start)
    for k, v in start.items():
        if k.endswith("e_score_correction_bias"):  # selection only: never trained
            np.testing.assert_array_equal(saved[k], v)
    for k in ("model.layers.0.hc_attn.fn", "model.layers.5.hc_mlp.scale"):
        assert not np.array_equal(saved[k], start[k]), k
    state = ptrain.init_train_state(again, params=saved, device="cpu")
    for k, v in state.params().items():
        np.testing.assert_array_equal(v, saved[k])
    lines = [r for r in caplog.records if str(r.msg).startswith("step %d/%d loss=")]
    assert len(lines) == 2
    for r in lines:
        text = r.getMessage()
        assert "mHC 24.0 calls a step" in text and "experts held" in text
        assert "MLA kernel 0.0 calls a step" in text and "norm kernel 0.0 calls a step" in text
