"""The DeepSeek-V3-family sentence encoder (models/deepseek_v3.py) on the
CPU, against the plain fp32 reference (tests/reference_deepseek_v3.py) at
a small size: 64 wide, 2 heads of 16 + 8 rope dimensions and 16 for v, a
kv rank of 32, a dense layer and 2 expert layers, 16 experts routed over
with top 3, 2 shared experts, seeded weights with non-zero correction
biases. No JAX.

Tolerances, each with its reason:

- fp32 compute: each row's embedding within 1e-5 (L2), the loss within
  1e-5 relative, every leaf's gradient within 1e-4 of its norm (of a
  thousandth of the median leaf's, for an expert that took no token).
  The program sums in another order than the reference (attention as
  batched products, the experts over a sorted gather); nothing else
  differs.
- bf16 compute over fp32 masters (as the model trains), the program's
  routers held to the reference's choices (tests/deepseek_v3_routing.py): each
  row's embedding within 2e-2 (L2), the loss within 1e-2 relative, every
  leaf's gradient within 0.1 of the larger of its norm and the median
  leaf's: bf16 rounds each product's inputs to 2^-8, and a gradient's path
  runs through a dozen products forward and back (seeds 1-6 read at most
  3.1e-3 and 0.045). Left free, a bf16 router chooses otherwise than the fp32
  one only for a token whose k-th and (k+1)-th biased scores lie within
  bf16's rounding of each other (``test_bf16_routes_otherwise_only_near_a_tie``):
  such a token moves to another expert whole, which no rounding tolerance
  describes.
"""

import contextlib
import dataclasses
import json
import math
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import reference_deepseek_v3 as ref
from deepseek_v3_routing import held_to_reference
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import family as model_family
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.ops import mla_attention as mla
from rag_icd10_tpu_torch.ops import rms_norm
from rag_icd10_tpu_torch.parallel import train as ptrain
from rag_icd10_tpu_torch.parallel.mesh import make_mesh
from rag_icd10_tpu_torch.tools import train_encoder as ttool
from rag_icd10_tpu_torch.utils.metrics import metrics

torch.set_num_threads(2)  # the suite runs several test processes at once

SMALL = dict(
    model_type="deepseek_v3", vocab_size=300, hidden_size=64, intermediate_size=128,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32,
    q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    n_routed_experts=16, num_experts_per_tok=3, n_shared_experts=2, routed_scaling_factor=2.446,
    norm_topk_prob=True, first_k_dense_replace=1, moe_layer_freq=1, rms_norm_eps=1e-5,
    rope_theta=50000, max_position_embeddings=64, scoring_func="sigmoid",
    topk_method="noaux_tc", n_group=1, topk_group=1)
MOE_LAYER = "model.layers.1.mlp."
YARN = dict(type="yarn", factor=64, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=1, mscale_all_dim=1)


def _arch(compute="float32", **kw):
    return dv.DeepseekV3Arch.from_config(dict(SMALL, **kw),
                                         compute_dtype=getattr(torch, compute))


def _params(arch, seed=1):
    """Seeded weights; correction biases std 0.1 and RMSNorm scales near 1,
    so that neither reads as a no-op."""
    params = dv.init_params(arch, seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in params.items():
        if k.endswith("e_score_correction_bias"):
            params[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif v.ndim == 1:
            params[k] = (1.0 + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
    return params


def _model(arch, params):
    model = dv.SentenceDeepseekV3(arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _tensors(params, grad=True):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad and not k.endswith("bias"))
            for k, v in params.items()}


def _rows(n, s, seed, lengths=None):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, SMALL["vocab_size"], (n, s), generator=gen)
    lengths = lengths or [int(x) for x in torch.randint(2, s + 1, (n,), generator=gen)]
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).long()
    return ids * mask, mask


def _row_err(a, b):
    return float(torch.linalg.vector_norm(a.detach() - b.detach(), dim=-1).max())


TOL = {"float32": dict(emb=1e-5, loss=1e-5, grad=1e-4, floor=1e-3),
       "bfloat16": dict(emb=2e-2, loss=1e-2, grad=0.1, floor=1.0)}


@pytest.fixture(autouse=True)
def fresh_counters():
    """Models of other shares count under the same names: start each test
    from an empty registry."""
    metrics.reset()


def _reference_routing(w, calls, compute):
    return held_to_reference(w, calls, SMALL) if compute == "bfloat16" else \
        contextlib.nullcontext([])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_embeddings_match_reference(compute):
    arch = _arch(compute)
    params = _params(arch)
    ids, mask = _rows(12, 20, seed=2)
    w = _tensors(params, grad=False)
    with _reference_routing(w, [ids], compute):
        got = _model(arch, params)(ids, mask, torch.zeros_like(ids))
    want = ref.encode(w, ids, mask, SMALL)
    assert _row_err(got, want) < TOL[compute]["emb"]
    assert torch.allclose(got.norm(dim=-1), torch.ones(12), atol=1e-5)


def test_bf16_routes_otherwise_only_near_a_tie():
    """Free, the bf16 program chooses the reference's experts for nearly
    every token; in the first expert layer, whose inputs differ from the
    reference's by rounding alone, otherwise only where the reference's
    k-th and (k+1)-th biased scores lie within 1e-2 (bf16's 2^-8 of a logit
    near 1 moves a sigmoid score by about 1e-3, after two layers' rounding).
    A later layer's choice can move further: a token that went to another
    expert, or one before it in its row, reaches that layer changed."""
    arch = _arch("bfloat16")
    params = _params(arch)
    ids, mask = _rows(12, 20, seed=2)
    w = _tensors(params, grad=False)
    model = _model(arch, params)
    mine, theirs, gaps = [], [], []
    forward, route = dv.Router.forward, ref.route

    def keep(self, x):
        out = forward(self, x)
        mine.append(out[0])
        return out

    def keep_ref(w_, p, x, cfg):
        out = route(w_, p, x, cfg)
        theirs.append(out[0])
        choice = torch.sigmoid(x @ w_[p + "gate.weight"].T) + w_[p + "gate.e_score_correction_bias"]
        top = choice.topk(cfg["num_experts_per_tok"] + 1, dim=-1).values
        gaps.append(top[:, -2] - top[:, -1])
        return out

    with torch.no_grad(), mock.patch.object(dv.Router, "forward", keep), \
            mock.patch.object(ref, "route", keep_ref):
        model(ids, mask)
        ref.hidden(w, ids, SMALL)
    valid = mask.reshape(-1).bool()  # pads route too, and see only what comes before them
    moved = torch.cat([(a.sort(-1).values != b.sort(-1).values).any(-1)[valid]
                       for a, b in zip(mine, theirs)])
    assert float(moved.float().mean()) < 0.1
    first = (mine[0].sort(-1).values != theirs[0].sort(-1).values).any(-1)[valid]
    assert bool((gaps[0][valid][first] < 1e-2).all()), gaps[0][valid][first]


def _triplets(seed=3, n=8):
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


def _calls(batch):
    """The ids of the program's model calls in a step: anchors and hard
    negatives stacked, then positives (parallel/train.py ``_embed``)."""
    return [torch.cat([batch["a_ids"], batch["h_ids"]]), batch["b_ids"]]


def _ref_loss(w, batch):
    """The weighted, masked InfoNCE written out plainly (temperature 0.05,
    masked logits -1e9, both directions)."""
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
    return 0.5 * (ce(torch.cat([pos, hn], 1), labels) + ce(pos.T, labels))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_reference(compute):
    arch, tol = _arch(compute), TOL[compute]
    params = _params(arch)
    model = _model(arch, params)
    batch = _triplets()
    w = _tensors(params)
    with _reference_routing(w, _calls(batch), compute):
        za, zb, zh = ptrain._embed(model, batch)
    loss, _ = ptrain._loss(batch, za, zb, zh, 0.05)
    loss.backward()
    leaves = [k for k, v in w.items() if v.requires_grad]
    loss_r = _ref_loss(w, batch)
    grads_r = dict(zip(leaves, torch.autograd.grad(loss_r, [w[k] for k in leaves])))
    grads = dict(model.named_parameters())
    assert set(grads) == set(leaves)  # the correction biases are no parameters
    assert abs(float(loss.detach()) - float(loss_r.detach())) < tol["loss"] * float(loss_r.detach())
    norms = {k: float(g.norm()) for k, g in grads_r.items()}
    floor = tol["floor"] * float(np.median(list(norms.values())))
    for k in leaves:
        g = grads[k].grad
        g = torch.zeros_like(grads[k]) if g is None else g
        assert float((g - grads_r[k]).norm()) < tol["grad"] * max(norms[k], floor), k


def test_expert_shares_add_up_to_the_whole_layer():
    """Four ranks of four experts each: the parts their layers give, with
    the shared experts (which every rank computes alike) counted once,
    add up to the uncut reference layer."""
    params = _params(_arch())
    w = _tensors(params, grad=False)
    x = torch.randn(40, SMALL["hidden_size"], generator=torch.Generator().manual_seed(4))
    shared = ref.swiglu(w, MOE_LAYER + "shared_experts.", x)
    total = shared.clone()
    for rank in range(4):
        held = list(range(4 * rank, 4 * rank + 4))
        arch = _arch(experts_held=held)
        layer = dv.ExpertShare(arch, 10 + rank)  # its own counters
        prefix = MOE_LAYER
        layer.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in
                               params.items() if k.startswith(prefix)
                               and (".experts." not in k or int(k.split(".")[5]) in held)})
        total += layer(x[None])[0] - shared
    whole = ref.moe(w, MOE_LAYER, x, SMALL)
    assert float((total - whole).abs().max()) < 1e-5
    routed = whole - shared
    assert float(routed.abs().max()) > 0.1 * float(shared.abs().max())  # not a share of nothing


def test_correction_bias_chooses_but_never_weighs():
    arch = _arch()
    router = dv.Router(arch)
    x = torch.randn(64, arch.hidden_size, generator=torch.Generator().manual_seed(5))
    idx0, w0 = router(x)
    bias = torch.randn(arch.n_routed_experts, generator=torch.Generator().manual_seed(6))
    router.e_score_correction_bias.copy_(bias)
    idx1, w1 = router(x)
    assert (idx0.sort(-1).values != idx1.sort(-1).values).any(dim=-1).sum() > 10
    # the weights are the sigmoid scores of the chosen experts, bias-free
    scores = torch.sigmoid(x @ router.weight.T)
    for idx, w in ((idx0, w0), (idx1, w1)):
        chosen = scores.gather(1, idx)
        assert torch.allclose(w, arch.routed_scaling_factor * chosen / chosen.sum(-1, keepdim=True),
                              atol=1e-6)
    assert "e_score_correction_bias" not in dict(router.named_parameters())
    assert "e_score_correction_bias" in router.state_dict()
    w1.sum().backward()
    assert router.e_score_correction_bias.grad is None and router.weight.grad is not None


def test_right_padding_changes_no_valid_row():
    arch = _arch()
    model = _model(arch, _params(arch))
    ids, mask = _rows(6, 14, seed=7, lengths=[14, 9, 5, 12, 2, 7])
    z = model(ids, mask)
    wide_ids = torch.cat([ids, torch.randint(1, 300, (6, 10))], 1)  # pads hold any id
    wide_mask = torch.cat([mask, torch.zeros(6, 10, dtype=torch.long)], 1)
    assert _row_err(model(wide_ids, wide_mask), z) < 1e-6
    # and a row's embedding is its own: alone or among others
    for r in (1, 4):
        assert _row_err(model(ids[r:r + 1], mask[r:r + 1]), z[r:r + 1]) < 1e-6


def test_a_mesh_is_refused():
    mesh = make_mesh(dp=1, tp=1, devices=["cpu"], distributed=False)
    with pytest.raises(ValueError, match="one device"):
        ptrain.init_train_state(_arch(), mesh=mesh, device="cpu")


def test_config_round_trip_and_what_is_not_implemented():
    arch = _arch(experts_held=[3, 7])
    back = dv.DeepseekV3Arch.from_config(json.loads(json.dumps(arch.to_config())))
    assert back.held == (3, 7) and back.n_routed_experts == 16
    lora = dict(SMALL, q_lora_rank=24, rope_scaling=dict(YARN))
    arch = dv.DeepseekV3Arch.from_config(lora)
    assert arch.q_lora_rank == 24 and arch.rope_scaling.factor == 64
    again = dv.DeepseekV3Arch.from_config(json.loads(json.dumps(arch.to_config())))
    assert (again.q_lora_rank, again.rope_scaling) == (arch.q_lora_rank, arch.rope_scaling)
    for bad in ({"q_lora_rank": 0}, {"rope_scaling": {"type": "linear", "factor": 4.0}},
                {"rope_scaling": dict(YARN, attention_factor=1.0)}, {"n_group": 8},
                {"topk_method": "greedy"}, {"experts_held": [16]}):
        with pytest.raises(ValueError):
            dv.DeepseekV3Arch.from_config(dict(SMALL, **bad))


def test_the_step_reads_no_counter(monkeypatch):
    """The expert layers count their slots on the device; the training
    step reads no counter (a read would wait for the device)."""
    arch = _arch("bfloat16")
    state = ptrain.init_train_state(arch, params=_params(arch), device="cpu", learning_rate=1e-3)
    before = metrics.counters("moe.")

    def refuse(*a, **kw):
        raise AssertionError("counters read inside the step")

    monkeypatch.setattr(metrics, "counters", refuse)
    batch = _triplets()
    ptrain.make_train_step()(state, batch)
    monkeypatch.undo()
    held = metrics._counters["moe.held_slots.1"]
    assert isinstance(held, torch.Tensor) and held.device.type == "cpu"
    after = metrics.counters("moe.")
    tokens = sum(int(np.prod(batch[f"{r}_ids"].shape)) for r in "abh")
    for layer in (1, 2):
        routed = after[f"moe.routed_slots.{layer}"] - before.get(f"moe.routed_slots.{layer}", 0)
        assert routed == 3 * tokens
        took = after[f"moe.held_slots.{layer}"] - before.get(f"moe.held_slots.{layer}", 0)
        assert took.shape == (16,) and took.sum() == 3 * tokens  # every expert held


# --------------------------------------------------------- the CLI end to end


@pytest.fixture
def decoder_cli(tmp_path, monkeypatch):
    """A 300-row synthetic CSV and a small deepseek_v3 checkpoint (experts
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
    dv.save_weights(params, arch, str(init / "params.npz"))
    return tmp_path, arch, params


ARGS = ["--batch", "8", "--seq-a", "12", "--seq-b", "24", "--log-every", "1",
        "--weighted-loss"]


def test_cli_trains_a_decoder_saves_and_reloads(decoder_cli):
    tmp, arch, start = decoder_cli
    out = tmp / "run"
    rc = ttool.main(ARGS + ["--steps", "3", "--init-from", str(tmp / "init" / "params.npz"),
                            "--params-only", "--out", str(out), "--save-every", "0"],
                    device="cpu")
    assert rc == 0
    assert {"params.npz", "config.json", "vocab.txt", "opt_state.npz"} <= {
        p.name for p in out.iterdir()}
    family, config = model_family.beside(str(out / "params.npz"))
    again = family.arch(config, None, 0)
    assert again == dataclasses.replace(arch, compute_dtype=torch.bfloat16)
    saved = dv.load_weights(str(out / "params.npz"), again)
    assert set(saved) == set(start)
    for k, v in start.items():
        if k.endswith("e_score_correction_bias"):  # selection only: never trained
            np.testing.assert_array_equal(saved[k], v)
    assert any(not np.array_equal(saved[k], start[k]) for k in start if ".experts.5." in k)
    # reloads to the same parameters, and a full resume adopts the moments
    state = ptrain.init_train_state(again, params=saved, device="cpu")
    for k, v in state.params().items():
        np.testing.assert_array_equal(v, saved[k])
    flat = np.load(out / "opt_state.npz")
    assert int(flat["__step__"]) == 3
    assert len([k for k in flat.files if k.startswith("leaf_")]) == 2 * state.num_leaves + 2
    res = tmp / "resumed"
    rc = ttool.main(ARGS + ["--steps", "5", "--init-from", str(out / "params.npz"),
                            "--out", str(res), "--save-every", "0"], device="cpu")
    assert rc == 0 and int(np.load(res / "opt_state.npz")["leaf_0"]) == 5


def test_cli_log_line_reads_the_experts_and_the_kernel(decoder_cli, caplog):
    """The --log-every line of a decoder carries its own fields after the
    BERT line's: the held experts' share and load, and the latent-attention
    and add + RMSNorm kernels' calls a step (0 on the CPU, where the plain
    versions run)."""
    tmp, _, _ = decoder_cli
    with caplog.at_level("INFO", logger="rag_icd10_tpu_torch.train"):
        rc = ttool.main(ARGS + ["--steps", "2", "--init-from", str(tmp / "init" / "params.npz"),
                                "--params-only", "--out", str(tmp / "run"),
                                "--save-every", "0"], device="cpu")
    assert rc == 0
    lines = [r for r in caplog.records if str(r.msg).startswith("step %d/%d loss=")]
    assert len(lines) == 2
    for r in lines:
        text = r.getMessage()
        assert "piece memo" in text and "experts held" in text and "load max/mean" in text
        assert "MLA kernel 0.0 calls a step" in text and "norm kernel 0.0 calls a step" in text
        share, load, calls, norm_calls = r.args[-4:]
        assert 0 < share < 100 and load >= 1 and calls == 0  # 4 of 16 experts held
        assert norm_calls == 0


def test_cli_refuses_a_vocabulary_wider_than_the_embedding(decoder_cli):
    tmp, arch, params = decoder_cli
    narrow = dataclasses.replace(arch, vocab_size=arch.vocab_size - 6)
    params["model.embed_tokens.weight"] = params["model.embed_tokens.weight"][:-6]
    init = tmp / "narrow"
    init.mkdir()
    (init / "vocab.txt").write_text((tmp / "init" / "vocab.txt").read_text(encoding="utf-8"),
                                    encoding="utf-8")
    dv.save_weights(params, narrow, str(init / "params.npz"))
    with pytest.raises(ValueError, match=f"{arch.vocab_size - 5} ids"):
        ttool.main(ARGS + ["--steps", "1", "--init-from", str(init / "params.npz"),
                           "--out", str(tmp / "x")], device="cpu")


def test_cli_eval_gate_refuses_a_decoder(decoder_cli):
    tmp, _, _ = decoder_cli
    with pytest.raises(SystemExit) as exc:
        ttool.main(ARGS + ["--steps", "1", "--init-from", str(tmp / "init" / "params.npz"),
                           "--out", str(tmp / "x"), "--eval-gate", "0.0"], device="cpu")
    assert exc.value.code == 2


def test_rope_is_the_published_rotation():
    """apply_rope against the modelling code's form written out: the pairs
    de-interleaved, then x * cos + rotate_half(x) * sin."""
    x = torch.randn(2, 3, 5, 8)
    cos, sin = dv.rope_tables(5, 8, 50000.0, "cpu")
    d = x.view(2, 3, 5, 4, 2).transpose(4, 3).reshape(2, 3, 5, 8)
    rotate_half = torch.cat([-d[..., 4:], d[..., :4]], dim=-1)
    assert torch.allclose(mla.apply_rope(x, cos, sin), d * cos + rotate_half * sin)
    inv = 1.0 / 50000.0 ** (torch.arange(0, 8, 2).float() / 8)
    assert torch.allclose(cos[3, :4], torch.cos(3 * inv)) and math.isclose(float(sin[0, 0]), 0.0)


# --------------------------------------- the attention core (ops/mla_attention.py)


def _old_rms_norm(norm, x):
    """``RMSNorm.forward`` as it was written before the residual add and the
    consumers' casts moved into ops/rms_norm.py: fp32 in, fp32 out."""
    x = x.float()
    return norm.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + norm.eps))


def _old_latent_attention(attn, x, cos, sin, causal):
    """``LatentAttention.forward`` as it was written inline before the core
    moved to ops/mla_attention.py, kept verbatim as the plain version's
    yardstick."""
    a = attn.arch
    b, s, _ = x.shape
    nh, nope, rope, vd = (a.num_attention_heads, a.qk_nope_head_dim, a.qk_rope_head_dim,
                          a.v_head_dim)
    dt = a.compute_dtype
    q = attn.q_proj(x).view(b, s, nh, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    latent, k_pe = attn.kv_a_proj_with_mqa(x).split([a.kv_lora_rank, rope], dim=-1)
    kv = attn.kv_b_proj(_old_rms_norm(attn.kv_a_layernorm, latent))
    kv = kv.view(b, s, nh, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = mla.apply_rope(q_pe.float(), cos, sin).to(dt)
    k_pe = mla.apply_rope(k_pe.float()[:, None], cos, sin).to(dt)  # one k_pe for every head
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, nh, s, rope)], dim=-1)
    # bf16 x bf16 products are exact in fp32: the logits carry fp32 accumulation
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(nope + rope)
    probs = torch.softmax(scores + causal, dim=-1).to(dt)
    ctx = torch.matmul(probs, v)  # (B, heads, S, v)
    return attn.o_proj(ctx.transpose(1, 2).reshape(b, s, nh * vd))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_plain_attention_core_is_the_old_inline_code_bit_for_bit(compute):
    """The model's attention through ops/mla_attention.py on the CPU gives
    the old inline code's output and every gradient (parameters and input)
    bit for bit."""
    arch = _arch(compute)
    model = _model(arch, _params(arch))
    attn = model.model.layers[1].self_attn
    s = 11
    x = torch.randn(3, s, arch.hidden_size, generator=torch.Generator().manual_seed(8))
    cos, sin = dv.rope_tables(s, arch.qk_rope_head_dim, arch.rope_theta, "cpu")
    causal = torch.full((s, s), torch.finfo(torch.float32).min).triu(1)
    target = torch.randn(3, s, arch.hidden_size, generator=torch.Generator().manual_seed(9))
    runs = []
    for fn in (lambda xx: attn(xx, xx, cos, sin),  # both projections read the one input
               lambda xx: _old_latent_attention(attn, xx, cos, sin, causal)):
        attn.zero_grad()
        xx = x.clone().requires_grad_(True)
        out = fn(xx)
        (out.float() * target).sum().backward()
        grads = {n: p.grad.clone() for n, p in attn.named_parameters()}
        runs.append((out.detach(), xx.grad, grads))
    (new, dx_new, g_new), (old, dx_old, g_old) = runs
    assert new.dtype == getattr(torch, compute)
    assert torch.equal(new, old) and torch.equal(dx_new, dx_old)
    assert set(g_new) == set(g_old) and len(g_new) == 5
    for n in g_new:
        assert torch.equal(g_new[n], g_old[n]), n


def test_wrapper_takes_the_plain_path_for_cpu_tensors(monkeypatch):
    """On CPU tensors every layer's attention core is the plain version:
    no kernel launch, no ``mla.kernel_calls``."""
    arch = _arch("bfloat16")
    model = _model(arch, _params(arch))
    calls = []
    plain = mla.mla_attention_reference

    def counted(*a, **kw):
        calls.append(a[0].device.type)
        return plain(*a, **kw)

    monkeypatch.setattr(mla, "mla_attention_reference", counted)
    launches = mla.mla_attention.launches
    ids, mask = _rows(4, 9, seed=10)
    model(ids, mask).sum().backward()
    assert calls == ["cpu"] * arch.num_hidden_layers
    assert mla.mla_attention.launches == launches
    assert "mla.kernel_calls" not in metrics.counters("mla.")


def _meta_inputs(b=2, s=5, heads=2, nope=128, rope=64, vd=128, dtype=torch.bfloat16):
    with torch.device("meta"):
        return (torch.empty(b, s, heads * (nope + rope), dtype=dtype),
                torch.empty(b, s, heads * (nope + vd), dtype=dtype),
                torch.empty(b, s, rope, dtype=dtype),
                torch.empty(s, rope, dtype=torch.float32),
                torch.empty(s, rope, dtype=torch.float32), heads)


@pytest.mark.parametrize("bad, match", [
    (dict(), "CUDA tensors"),  # a layout the kernels take, on no card
    (dict(rope=8), "got nope 128, rope 8,"),
    (dict(nope=24), "got nope 24,"),
    (dict(vd=48), "v 48$"),
    (dict(dtype=torch.float16), "bf16 or fp32"),
])
def test_kernel_path_refuses_what_it_does_not_take(bad, match):
    """Off the CPU the wrapper launches the kernels or raises: no fallback
    to the plain version."""
    with pytest.raises(ValueError, match=match):
        mla.mla_attention(*_meta_inputs(**bad))


# ------------------------------------- the residual add + RMSNorm (ops/rms_norm.py)


def _old_hidden(model, ids):
    """``DeepseekV3Model.forward`` as it was written before the residual adds
    moved into the norms, with the old norm and attention written out above:
    the plain path's yardstick."""
    m = model.model
    a, s = m.arch, ids.shape[1]
    cos, sin = dv.rope_tables(s, a.qk_rope_head_dim, a.rope_theta, "cpu")
    causal = torch.full((s, s), torch.finfo(torch.float32).min).triu(1)
    x = m.embed_tokens(ids)
    for layer in m.layers:
        h = _old_rms_norm(layer.input_layernorm, x)
        x = x + _old_latent_attention(layer.self_attn, h, cos, sin, causal).float()
        x = x + layer.mlp(_old_rms_norm(layer.post_attention_layernorm, x)).float()
    return _old_rms_norm(m.norm, x)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_plain_norms_are_the_old_inline_chain_bit_for_bit(compute):
    """The decoder with its residual adds in the norms, on the CPU, gives the
    old inline chain's hidden states and every parameter's gradient bit for
    bit: the same operations at the same rounding points."""
    arch = _arch(compute)
    model = _model(arch, _params(arch))
    ids, _ = _rows(3, 10, seed=12)
    target = torch.randn(3, 10, arch.hidden_size, generator=torch.Generator().manual_seed(13))
    runs = []
    for fn in (lambda: model.model(ids), lambda: _old_hidden(model, ids)):
        model.zero_grad()
        out = fn()
        (out * target).sum().backward()
        runs.append((out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                    if p.grad is not None}))
    (new, g_new), (old, g_old) = runs
    assert new.dtype == torch.float32 and torch.equal(new, old)
    assert set(g_new) == set(g_old) and any(".experts." in n for n in g_new)
    for n in g_new:
        assert torch.equal(g_new[n], g_old[n]), n


def _old_site(x, branch, weight, eps, out):
    """One site as the old chain wrote it: the residual add, the norm, then
    each consumer's cast of the fp32 output."""
    if branch is not None:
        x = x + branch.float()
    y = _old_rms_norm(SimpleNamespace(weight=weight, eps=eps), x)
    return x, tuple(y.to(dt) for dt in out)


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("x_dtype, branch_dtype, out", [
    (F32, BF, (BF, BF)),  # a hidden site: attention's or the dense MLP's inputs
    (F32, F32, (F32, BF, BF)),  # the most a site may ask for: one fp32 output, two bf16
    (F32, BF, (F32,)),  # an expert layer's inputs; the final norm after a dense layer
    (F32, None, (BF, BF)),  # layer 0's input norm
    (BF, None, (BF,)),  # kv_a_layernorm on the bf16 latent
    (F32, None, (F32, F32)),  # the fp32 model
    (F32, F32, (BF, BF)),  # the attention's inputs after an expert layer
])
def test_plain_site_is_the_old_chain_bit_for_bit(x_dtype, branch_dtype, out):
    """``add_rms_norm_reference`` against the old chain at one site: x_new,
    each consumer's copy, and the gradients of x, the branch and the weight
    for every output's gradient (the consumers' casts' gradients added in
    fp32 in both)."""
    gen = torch.Generator().manual_seed(14)
    x0 = torch.randn(4, 6, 64, generator=gen).to(x_dtype)
    b0 = None if branch_dtype is None else torch.randn(4, 6, 64, generator=gen).to(branch_dtype)
    w0 = 1.0 + 0.1 * torch.randn(64, generator=gen)
    dys = [torch.randn(4, 6, 64, generator=gen).to(dt) for dt in out]
    dx_new = torch.randn(4, 6, 64, generator=gen)
    runs = []
    for fn in (rms_norm.add_rms_norm_reference, _old_site):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        b = None if b0 is None else b0.clone().requires_grad_(True)
        x_new, ys = fn(x, b, w, 1e-5, out)
        loss = sum((y.float() * dy.float()).sum() for y, dy in zip(ys, dys))
        if b is not None:
            loss = loss + (x_new * dx_new).sum()
        loss.backward()
        runs.append([x_new.detach(), *(y.detach() for y in ys), x.grad, w.grad]
                    + ([] if b is None else [b.grad]))
    for got, want in zip(*runs):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert [y.dtype for y in runs[0][1:1 + len(out)]] == list(out)


def test_norm_wrapper_takes_the_plain_path_for_cpu_tensors(monkeypatch):
    """On CPU tensors every norm of the model is the plain version: 16 calls
    in a 3-layer model (3 input norms, 3 post-attention, 3 latent, the
    final), no kernel launch, no ``norm.kernel_calls``."""
    arch = _arch("bfloat16")
    model = _model(arch, _params(arch))
    calls = []
    plain = rms_norm.add_rms_norm_reference

    def counted(x, branch, weight, eps, out):
        calls.append((x.shape[-1], branch is not None, tuple(out)))
        return plain(x, branch, weight, eps, out)

    monkeypatch.setattr(rms_norm, "add_rms_norm_reference", counted)
    launches = rms_norm.add_rms_norm.launches
    ids, mask = _rows(4, 9, seed=15)
    model(ids, mask).sum().backward()
    bf = torch.bfloat16
    hidden = [c for c in calls if c[0] == arch.hidden_size]
    assert len(calls) == 10 and len(hidden) == 7
    assert hidden[0] == (64, False, (bf, bf))  # layer 0's input: no branch
    assert hidden[1] == (64, True, (bf, bf))  # the dense MLP's gate and up
    assert hidden[3] == (64, True, (torch.float32,))  # router, gather, shared experts
    assert hidden[4] == (64, True, (bf, bf))  # after an expert layer: the attention's inputs
    assert hidden[-1] == (64, True, (torch.float32,))  # the final norm, for the pooling
    assert [c for c in calls if c[0] == arch.kv_lora_rank] == [(32, False, (bf,))] * 3
    assert rms_norm.add_rms_norm.launches == launches
    assert "norm.kernel_calls" not in metrics.counters("norm.")


def _meta_site(width=2048, x_dtype=torch.float32, branch_dtype=torch.bfloat16,
               weight_shape=None, rows=5):
    with torch.device("meta"):
        x = torch.empty(rows, width, dtype=x_dtype)
        branch = None if branch_dtype is None else torch.empty(rows, width, dtype=branch_dtype)
        return x, branch, torch.empty(weight_shape or (width,), dtype=torch.float32)


@pytest.mark.parametrize("site, out, match", [
    (dict(), (torch.bfloat16,), "CUDA tensors"),  # a site the kernels take, on no card
    (dict(width=1024), (torch.bfloat16,), "widths"),
    (dict(x_dtype=torch.float16, branch_dtype=None), (torch.float32,), "fp32 or bf16 x"),
    (dict(x_dtype=torch.bfloat16), (torch.bfloat16,), "branch to fp32 x"),
    (dict(branch_dtype=torch.float16), (torch.bfloat16,), "branch to fp32 x"),
    (dict(weight_shape=(512,)), (torch.bfloat16,), "weight must be fp32"),
    (dict(), (torch.bfloat16,) * 3, "up to two bf16"),
    (dict(), (torch.float16,), "up to two bf16"),
    (dict(), (), "up to two bf16"),
    (dict(rows=0), (torch.bfloat16,), "CUDA tensors"),
])
def test_norm_kernel_path_refuses_what_it_does_not_take(site, out, match):
    """Off the CPU the wrapper launches the kernels or raises: no fallback
    to the plain version."""
    x, branch, weight = _meta_site(**site)
    with pytest.raises(ValueError, match=match):
        rms_norm.add_rms_norm(x, branch, weight, 1e-5, out)


def test_row_stride_reads_views_in_place():
    """The kernels read x through its row stride where its rows are
    contiguous, evenly spaced and 16-byte aligned (the latent: the first 512
    of kv_a_proj_with_mqa's 576 columns), and take a copy otherwise."""
    kv_a = torch.zeros(3, 7, 576, dtype=torch.bfloat16)
    latent, _ = kv_a.split([512, 64], dim=-1)
    assert rms_norm._row_stride(latent) == 576
    assert rms_norm._row_stride(torch.zeros(3, 7, 2048)) == 2048
    assert rms_norm._row_stride(torch.zeros(2048)) == 2048
    assert rms_norm._row_stride(torch.zeros(7, 3, 512).transpose(0, 1)) is None  # rows uneven
    assert rms_norm._row_stride(torch.zeros(4, 512)[:, ::1].t()) is None  # columns strided
    assert rms_norm._row_stride(torch.zeros(3, 516, dtype=torch.bfloat16)[:, 4:]) is None  # 8 B off
    assert rms_norm._row_stride(torch.zeros(2, 1, 512)[:, :, :]) == 512  # a size-1 dim
