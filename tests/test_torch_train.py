"""Encoder training: the port's parallel/train.py, the checkpoint carry in
models/convert_hf.py and tools/train_encoder.py against the JAX package,
on the same numpy inputs (made from seeds), on the CPU.

Tolerances, stated before the comparison:

- Losses (plain, masked, hard negatives, weighted): 1e-5. Both sides
  compute the same fp32 products and log-softmax over at most 2B columns.
- A 2-layer, 64-wide BERT with fp32 compute, one and three steps of
  ``optax.adamw(warmup_cosine)`` against ``AdamW`` + ``LambdaLR`` at a
  peak lr of 1e-3 (the first step runs at lr 0, as optax's does): the
  loss of every step within 1e-5, the Adam moments within 1e-4 and every
  parameter within 1e-4, except the attention key biases. Their gradient is zero in exact arithmetic
  (a key bias shifts every score of a query alike, and softmax ignores a
  shift), so each side's is rounding noise of about 1e-9 that Adam
  normalizes to an update of up to the learning rate, of either sign.
  They are held to the most those updates can move them apart, 2·Σ lr_t,
  and the JAX gradient is checked to be that noise (below 1e-6).
- bf16 compute (fp32 parameters): the first step's loss within 1e-3 (a
  bf16 product carries 2^-9 relative rounding, the temperature 0.05
  scales the logits' error by 20, and the loss averages it over rows:
  measured 2.7e-4), the loss over four steps within 2e-2 (each side's
  Adam turns the gradients' bf16 rounding into different sign choices
  where a gradient is near zero). Its parameters must stay fp32 and move
  by less than half a bf16 step in some elements, which bf16 weights
  would drop; at lr 1e-4, weights stored in bf16 keep fewer than half
  the updates the fp32 masters keep.
- The optimizer-state carry: JAX's Adam moments after three updates
  within 1e-6 of the port's on entry (a copy), one more update on both
  sides as above, and the carry back within 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_icd10_tpu.data.corpus import ICDCorpus as JCorpus
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.bert import init_params as jinit
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_icd10_tpu.parallel import train as jtrain
from rag_icd10_tpu.parallel.mesh import _spec_for_path as j_spec_for_path
from rag_icd10_tpu.tools import train_encoder as jtool
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import ICDCorpus, synthetic_corpus
from rag_icd10_tpu_torch.models.bert import BertArch, init_params
from rag_icd10_tpu_torch.models.convert_hf import (
    load_params,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    save_params,
)
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.parallel import (
    init_train_state,
    make_mesh,
    param_shardings,
)
from rag_icd10_tpu_torch.parallel import train as ttrain
from rag_icd10_tpu_torch.parallel.mesh import _spec_for_path, batch_sharding, replicated
from rag_icd10_tpu_torch.tools import train_encoder as ttool

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL_LOSS = 1e-5
TOL_PARAM = 1e-4
TOL_BF16_FIRST = 1e-3
TOL_BF16_LATER = 2e-2
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=32)
LR = 1e-3


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ losses


def _loss_inputs(seed, b=8, h=16):
    rng = np.random.default_rng(seed)
    za, zb, zh = (_unit(rng, (b, h)) for _ in range(3))
    # title ids with collisions: anchors 0/1 share a title, positive 3
    # shares anchor 5's, hard negative 2 is anchor 2's own title
    ga = np.arange(b, dtype=np.int32)
    ga[1] = 0
    gb = np.arange(b, 2 * b, dtype=np.int32)
    gb[3] = ga[5]
    hg = np.arange(2 * b, 3 * b, dtype=np.int32)
    hg[2] = ga[2]
    w_b = rng.choice([0.8, 1.0, 1.2], b).astype(np.float32)
    w_h = rng.choice([0.8, 1.0, 1.2], b).astype(np.float32)
    return za, zb, zh, ga, gb, hg, w_b, w_h


@pytest.mark.parametrize("case", ["plain", "masked", "hard_negatives", "weighted",
                                  "weighted_hard_negatives"])
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(case, seed):
    za, zb, zh, ga, gb, hg, w_b, w_h = _loss_inputs(seed)
    if case == "plain":
        want = jtrain.contrastive_loss(za, zb, 0.05)
        got = ttrain.contrastive_loss(_t(za), _t(zb), 0.05)
    else:
        hn = case.endswith("hard_negatives")
        weighted = case.startswith("weighted")
        jargs = (za, zb, ga, gb, zh if hn else None, hg if hn else None, 0.05)
        targs = tuple(None if a is None else _t(a) for a in jargs[:6]) + (0.05,)
        jw = dict(w_b=w_b, w_h=w_h if hn else None) if weighted else {}
        tw = {k: None if v is None else _t(v) for k, v in jw.items()}
        want = jtrain.contrastive_loss_masked(*jargs, **jw)
        got = ttrain.contrastive_loss_masked(*targs, **tw)
    assert abs(float(got[0]) - float(want[0])) <= TOL_LOSS
    assert float(got[1]) == float(want[1])


def test_fully_masked_hard_negative_row_stays_finite():
    """Every hard-negative column of row 0 collides with its titles: the
    -1e9 mask (after the temperature, not -inf) keeps the loss finite and
    equal to JAX's."""
    za, zb, zh, ga, gb, hg, _, _ = _loss_inputs(3)
    hg[:] = ga[0]
    want = jtrain.contrastive_loss_masked(za, zb, ga, gb, zh, hg, 0.05)
    got = ttrain.contrastive_loss_masked(*map(_t, (za, zb, ga, gb, zh, hg)), 0.05)
    assert np.isfinite(float(got[0]))
    assert abs(float(got[0]) - float(want[0])) <= TOL_LOSS


def test_contrastive_loss_perfect_alignment():
    z = torch.eye(4, 8)
    loss, acc = ttrain.contrastive_loss(z, z, temperature=0.05)
    assert float(acc) == 1.0 and float(loss) < 0.01


class TestWeightedLoss:
    """The JAX package's weight-inversion cases (tests/test_parallel.py
    TestWeightedLoss) on the port's loss."""

    def _rows(self):
        za = np.array([[1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
        zb = np.array([[0.9, np.sqrt(1 - 0.81), 0, 0], [0.8, 0, 0, 0.6]], np.float32)
        return za, zb, np.array([0, 1], np.int32), np.array([2, 3], np.int32)

    def test_unweighted_ranks_raw_cosine(self):
        _, acc = ttrain.contrastive_loss_masked(*map(_t, self._rows()))
        assert float(acc) == 1.0

    def test_weight_folding_exposes_inversion(self):
        rows = tuple(map(_t, self._rows()))
        w_b = torch.tensor([0.8, 1.2])
        loss_w, acc = ttrain.contrastive_loss_masked(*rows, w_b=w_b)
        assert float(acc) == 0.5
        loss_u, _ = ttrain.contrastive_loss_masked(*rows)
        assert float(loss_w) > float(loss_u)

    def test_weighted_hard_negative_column(self):
        za, _, ga, gb = self._rows()
        zb = np.array([[0.9, np.sqrt(1 - 0.81), 0, 0], [0, 0, 0.8, 0.6]], np.float32)
        zh = np.array([[0.8, 0, 0.6, 0], [0, 1, 0, 0]], np.float32)
        hg = np.array([4, 5], np.int32)
        args = tuple(map(_t, (za, zb, ga, gb, zh, hg)))
        _, acc_u = ttrain.contrastive_loss_masked(*args)
        assert float(acc_u) == 1.0
        _, acc_w = ttrain.contrastive_loss_masked(
            *args, w_b=torch.tensor([0.8, 1.2]), w_h=torch.tensor([1.2, 1.0]))
        assert float(acc_w) == 0.5


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("warmup,decay", [(1, 2), (3, 20), (100, 16000), (5, 6)])
def test_warmup_cosine_schedule_matches_optax(warmup, decay):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup_steps=warmup,
                                              decay_steps=decay)
    got = ttrain.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, decay)
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, decay // 2, decay - 1, decay,
                     decay + 7})
    for c in counts:
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0  # the first update runs at lr 0, as optax's


def test_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup_steps=1, decay_steps=1)
    with pytest.raises(ValueError, match="positive decay_steps"):
        ttrain.warmup_cosine_decay_schedule(0.0, 1e-4, 1, 1)


# ------------------------------------------------------------------- steps


def _batch(seed, b=8, objective="triplets"):
    """Token batches with padding (the last 3 positions masked)."""
    r = np.random.default_rng(seed)

    def side(seq):
        ids = r.integers(1, 128, size=(b, seq)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[:, seq - 3:] = 0
        return ids, mask, np.zeros_like(ids)

    batch = {}
    sides = (("a", 16), ("b", 24)) + ((("h", 16),) if objective != "pairs" else ())
    for name, seq in sides:
        batch[f"{name}_ids"], batch[f"{name}_mask"], batch[f"{name}_types"] = side(seq)
    if objective != "pairs":
        batch.update(
            group_a=np.arange(b, dtype=np.int32),
            group_b=np.arange(b, 2 * b, dtype=np.int32),
            h_group=np.arange(2 * b, 3 * b, dtype=np.int32),
        )
    if objective == "weighted":
        batch.update(w_b=r.choice([0.8, 1.0, 1.2], b).astype(np.float32),
                     w_h=r.choice([0.8, 1.0, 1.2], b).astype(np.float32))
    return batch


def _archs(bf16=False):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    return JArch(**TINY, compute_dtype=jdt), BertArch(**TINY, compute_dtype=tdt)


def _jax_run(jarch, params, batch, steps, warmup=1, decay=10, opt_state=None, start=0):
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=warmup,
                                                  decay_steps=decay)
    opt = optax.adamw(schedule, weight_decay=0.01)
    state = opt.init(params) if opt_state is None else opt_state
    step = jax.jit(jtrain.make_train_step(jarch, opt))
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    lrs = [float(schedule(start + i)) for i in range(steps)]
    return jax.device_get(params), state, losses, lrs


def _assert_params_close(got, want, lrs, tol=TOL_PARAM):
    bound = 2 * sum(lrs) * (1 + 0.01) + tol
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        err = float(np.max(np.abs(np.asarray(w) - np.asarray(g))))
        limit = bound if "['key']['bias']" in name else tol
        assert err <= limit, (name, err, limit)


def test_key_bias_gradient_is_rounding_noise():
    """The premise of the key-bias allowance: its JAX gradient is zero but
    for rounding."""
    jarch, _ = _archs()
    params = jinit(jarch, seed=0)
    model = jtrain.SentenceBert(jarch)
    batch = _batch(0)

    def loss_fn(p):
        za = model.apply({"params": p}, batch["a_ids"], batch["a_mask"], batch["a_types"])
        zb = model.apply({"params": p}, batch["b_ids"], batch["b_mask"], batch["b_types"])
        return jtrain.contrastive_loss(za, zb)[0]

    grads = jax.grad(loss_fn)(params)["bert"]
    for i in range(TINY["num_layers"]):
        layer = grads[f"layer_{i}"]["attention"]
        assert float(jnp.max(jnp.abs(layer["key"]["bias"]))) < 1e-6
        assert float(jnp.max(jnp.abs(layer["query"]["bias"]))) > 1e-4


@pytest.mark.parametrize("objective", ["pairs", "triplets", "weighted"])
@pytest.mark.parametrize("steps", [1, 3])
def test_fp32_steps_match_optax(objective, steps):
    """One and three steps of the port's AdamW + LambdaLR against
    optax.adamw(warmup_cosine): the first runs at lr 0 under the warmup
    (only the moments move), the next two at the schedule's rates."""
    jarch, tarch = _archs()
    params = jax.device_get(jinit(jarch, seed=0))
    batch = _batch(1, objective=objective)
    jparams, jstate, jlosses, lrs = _jax_run(jarch, params, batch, steps)
    state = init_train_state(
        tarch, params=params, device="cpu",
        schedule=ttrain.warmup_cosine_decay_schedule(0.0, LR, 1, 10))
    step = ttrain.make_train_step()
    tlosses = [float(step(state, batch)["loss"]) for _ in range(steps)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=TOL_LOSS)
    assert state.step == steps and lrs[0] == 0.0
    _assert_params_close(state.params(), jparams, lrs)
    got, want = state.opt_state_leaves(), jax.tree_util.tree_leaves(jstate)
    assert int(got[0]) == int(want[0]) == steps
    for g, w in zip(got[1:-1], want[1:-1]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL_PARAM)


def test_bf16_compute_keeps_fp32_master_weights():
    jarch, tarch = _archs(bf16=True)
    params = jax.device_get(jinit(jarch, seed=0))
    batch = _batch(2, objective="weighted")
    jparams, _, jlosses, _ = _jax_run(jarch, params, batch, 4)
    state = init_train_state(
        tarch, params=params, device="cpu",
        schedule=ttrain.warmup_cosine_decay_schedule(0.0, LR, 1, 10))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    step = ttrain.make_train_step()
    tlosses = [float(step(state, batch)["loss"]) for _ in range(4)]
    assert abs(tlosses[0] - jlosses[0]) <= TOL_BF16_FIRST
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=TOL_BF16_LATER)
    assert tlosses[-1] < tlosses[0]

    def sub_bf16_moves(new):
        """Elements that moved, but by less than their bf16 value resolves."""
        count = 0
        for a, c in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(new)):
            a, c = torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(c))
            count += int(((a != c) & (a.bfloat16() == c.bfloat16())).sum())
        return count

    assert sub_bf16_moves(state.params()) > 0
    assert sub_bf16_moves(jparams) > 0

    # At the CLI's learning rate, 1e-4, weights stored in bf16 (the serving
    # layout) drop most updates: after 4 steps far fewer of their Dense
    # elements changed, rounded to bf16, than of the fp32 masters.
    from rag_icd10_tpu_torch.models.bert import SentenceBert

    schedule = ttrain.warmup_cosine_decay_schedule(0.0, 1e-4, 1, 10)
    fp32 = init_train_state(tarch, params=params, device="cpu", schedule=schedule)
    model = SentenceBert(tarch)
    model.load_state_dict(params_from_jax(params))
    bf16 = ttrain.TrainState(model, *ttrain.make_optimizer(model, schedule))
    assert model.bert.layers[0].output.weight.dtype == torch.bfloat16
    for _ in range(4):
        step(fp32, batch)
        step(bf16, batch)

    def dense_moved(tree):
        start, end = params_from_jax(params), params_from_jax(tree)
        return sum(int((start[k].bfloat16() != end[k].bfloat16()).sum()) for k in start
                   if ".layers." in k and k.endswith(".weight") and "_ln" not in k)

    assert dense_moved(bf16.params()) < dense_moved(fp32.params()) / 2


def test_serving_layout_keeps_bf16_weights():
    """BertArch's default stores Dense weights in the compute dtype, as
    serving did before training was ported; fp32 parameters give the
    same forward to the bit, since the cast happens in the forward."""
    from rag_icd10_tpu_torch.models.bert import SentenceBert

    arch = BertArch(**TINY)
    params = params_from_jax(init_params(arch, seed=4))
    serve, train = SentenceBert(arch), SentenceBert(dataclasses.replace(
        arch, param_dtype=torch.float32))
    serve.load_state_dict(params)
    train.load_state_dict(params)
    assert serve.bert.layers[0].attention.query.weight.dtype == torch.bfloat16
    assert train.bert.layers[0].attention.query.weight.dtype == torch.float32
    assert serve.bert.word_embeddings.weight.dtype == torch.float32
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(4).items() if k.startswith("a_")}
    with torch.no_grad():
        assert torch.equal(serve(batch["a_ids"], batch["a_mask"], batch["a_types"]),
                           train(batch["a_ids"], batch["a_mask"], batch["a_types"]))


@pytest.mark.parametrize("bad", ["no_groups", "no_h_group"])
def test_hard_negatives_need_group_ids(bad):
    _, tarch = _archs()
    state = init_train_state(tarch, device="cpu")
    batch = _batch(0)
    if bad == "no_groups":
        for key in ("group_a", "group_b", "h_group"):
            batch.pop(key)
        match = "require group_a"
    else:
        batch.pop("h_group")
        match = "without h_group"
    with pytest.raises(ValueError, match=match):
        ttrain.make_train_step()(state, batch)


# -------------------------------------------------------- checkpoint carry


def test_params_to_jax_inverts_params_from_jax():
    arch = BertArch(**TINY)
    tree = init_params(arch, seed=5)
    back = params_to_jax(params_from_jax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert b.dtype == np.float32 and np.array_equal(a, b)
    # with a token classifier's head too
    tree["classifier"] = {"kernel": np.ones((64, 9), np.float32),
                          "bias": np.arange(9, dtype=np.float32)}
    back = params_to_jax(params_from_jax(tree))
    assert np.array_equal(back["classifier"]["kernel"], tree["classifier"]["kernel"])


def test_fresh_optimizer_leaves_have_optax_layout():
    jarch, tarch = _archs()
    params = jax.device_get(jinit(jarch, seed=0))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, 1, 10), weight_decay=0.01)
    want = jax.tree_util.tree_leaves(opt.init(params))
    state = init_train_state(tarch, params=params, device="cpu")
    got = state.opt_state_leaves()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w) and np.array_equal(g, np.asarray(w))
    assert len(opt_state_to_jax(state.optimizer, state.model)) == len(want)
    # a constant learning rate's state has no schedule count; it loads too
    constant = jax.tree_util.tree_leaves(optax.adamw(LR, weight_decay=0.01).init(params))
    assert len(opt_state_from_jax(constant, state.model)) == len(list(state.model.parameters()))


@pytest.mark.parametrize("objective", ["pairs", "weighted"])
def test_optimizer_state_carries_both_ways(objective):
    """Three updates in JAX, carried into the port; one more update in both
    packages; the port's state carried back."""
    jarch, tarch = _archs()
    params0 = jax.device_get(jinit(jarch, seed=0))
    batch = _batch(6, objective=objective)
    jparams3, jstate3, _, lrs3 = _jax_run(jarch, params0, batch, 3)
    leaves3 = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate3)]
    state = init_train_state(
        tarch, params=jparams3, opt_state=leaves3, device="cpu",
        schedule=ttrain.warmup_cosine_decay_schedule(0.0, LR, 1, 10))
    assert state.step == 3
    next_lr = float(optax.warmup_cosine_decay_schedule(0.0, LR, 1, 10)(3))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(next_lr, rel=1e-6)
    for g, w in zip(state.opt_state_leaves(), leaves3):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    jparams4, jstate4, jloss, lrs4 = _jax_run(jarch, jparams3, batch, 1, opt_state=jstate3,
                                             start=3)
    tloss = float(ttrain.make_train_step()(state, batch)["loss"])
    assert abs(tloss - jloss[0]) <= TOL_LOSS
    _assert_params_close(state.params(), jparams4, lrs4)
    back = state.opt_state_leaves()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate4)]
    assert int(back[0]) == int(want[0]) == 4 and int(back[-1]) == int(want[-1]) == 4
    for g, w in zip(back[1:-1], want[1:-1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_PARAM)
    # and the JAX optimizer resumes from the carried-back leaves
    treedef = jax.tree_util.tree_structure(jstate4)
    jax.tree_util.tree_unflatten(treedef, back)


def test_opt_state_from_jax_refuses_a_wrong_leaf_count():
    _, tarch = _archs()
    state = init_train_state(tarch, device="cpu")
    leaves = state.opt_state_leaves()
    with pytest.raises(ValueError, match="optimizer leaves"):
        opt_state_from_jax(leaves[:-2], state.model)


# -------------------------------------------------------------- mesh rules


def test_partition_rules_match_jax():
    arch = BertArch(**TINY)
    specs = param_shardings(None, init_params(arch, seed=0))
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, tuple))[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        assert spec == tuple(j_spec_for_path(name)), name
    assert specs["bert"]["layer_0"]["attention"]["query"]["kernel"] == (None, "tp")
    assert specs["bert"]["layer_0"]["attention"]["out"]["kernel"] == ("tp", None)
    assert _spec_for_path("something/else") == ()
    assert batch_sharding(None) == ("dp",) and replicated(None) == ()


def test_sharded_step_in_one_process_equals_the_plain_step():
    """dp = 2 logical shards of one CPU: one replica takes both row blocks,
    so the step is the plain step, to the bit."""
    _, tarch = _archs()
    mesh = make_mesh(n_devices=2, dp=2, tp=1, devices=["cpu", "cpu"], distributed=False)
    sharded = init_train_state(tarch, mesh=mesh, schedule=LR)
    plain = init_train_state(tarch, device="cpu", schedule=LR)
    batch = _batch(7, objective="weighted")
    step_s, step_p = ttrain.make_sharded_train_step(mesh), ttrain.make_train_step()
    for _ in range(2):
        ls, lp = step_s(sharded, batch)["loss"], step_p(plain, batch)["loss"]
        assert float(ls) == float(lp)
    for a, b in zip(sharded.model.parameters(), plain.model.parameters()):
        assert torch.equal(a, b)


def test_sharded_init_keeps_warm_started_state():
    """--dp --init-from must resume from the checkpoint (JAX
    test_sharded_init_keeps_warm_started_state): the dp state starts from
    the given parameters and optimizer leaves, not a fresh seed."""
    _, tarch = _archs()
    host = init_params(tarch, seed=123)
    fresh = init_params(tarch, seed=0)
    warm = init_train_state(tarch, device="cpu", params=host, schedule=LR)
    ttrain.make_train_step()(warm, _batch(8))
    leaves = warm.opt_state_leaves()
    mesh = make_mesh(n_devices=1, dp=1, tp=1, devices=["cpu"], distributed=False)
    state = init_train_state(tarch, mesh=mesh, seed=0, schedule=LR,
                             params=warm.params(), opt_state=leaves)
    assert any(not np.allclose(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(host), jax.tree_util.tree_leaves(fresh)))
    for got, want in zip(jax.tree_util.tree_leaves(state.params()),
                         jax.tree_util.tree_leaves(warm.params())):
        np.testing.assert_array_equal(got, want)
    assert state.step == 1
    m = ttrain.make_sharded_train_step(mesh)(state, _batch(8))
    assert np.isfinite(float(m["loss"]))


# --------------------------------------------------- tools/train_encoder.py


def _three_rows(mod):
    return mod.from_rows([
        {"code": "A00", "disease": "霍乱"},
        {"code": "A00.0", "disease": "古典霍乱"},
        {"code": "A00.001", "disease": "某种霍乱"},
    ])


def test_make_pairs_matches_jax():
    pairs = ttool.make_pairs(_three_rows(ICDCorpus))
    assert pairs == jtool.make_pairs(_three_rows(JCorpus))
    assert ("古典霍乱", "霍乱") in pairs and len(pairs) == 5
    dup = ICDCorpus.from_rows([{"code": "B00", "disease": "同名"},
                               {"code": "B00.1", "disease": "同名"}])
    assert ("同名", "同名") not in ttool.make_pairs(dup)


@pytest.mark.parametrize("parent_pairs", [True, False])
def test_build_examples_matches_jax(parent_pairs):
    corpus, jcorpus = synthetic_corpus(300, seed=9), None
    from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic

    jcorpus = jsynthetic(300, seed=9)
    got, got_ids = ttool.build_examples(corpus, parent_pairs=parent_pairs)
    want, want_ids = jtool.build_examples(jcorpus, parent_pairs=parent_pairs)
    assert got_ids == want_ids
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert ttool.title_weight_map(corpus) == jtool.title_weight_map(jcorpus)


def test_weighted_loss_data():
    examples, _ = ttool.build_examples(_three_rows(ICDCorpus))
    c = _three_rows(ICDCorpus)
    by_pair = {(e.anchor, e.positive): e.pos_weight for e in examples}
    assert by_pair[("霍乱", c.semantic_texts[0])] == pytest.approx(1.2)
    assert by_pair[("某种霍乱", c.semantic_texts[2])] == pytest.approx(0.8)
    assert by_pair[("某种霍乱", c.semantic_texts[1])] == pytest.approx(1.0)
    leaf = [e for e in examples if e.anchor == "某种霍乱"][0]
    assert set(leaf.anc_titles) == {"古典霍乱", "霍乱"}
    assert len(ttool.build_examples(c, parent_pairs=False)[0]) == 3
    dup = ICDCorpus.from_rows([{"code": "B00", "disease": "同名"},
                               {"code": "B00.1", "disease": "同名"}])
    assert ttool.title_weight_map(dup)["同名"] == pytest.approx(1.2)


@pytest.mark.parametrize("kw", [
    dict(augment_prob=0.4, marker_prob=0.25, cousin_frac=0.3),
    dict(augment_prob=0.0, marker_prob=0.0, cousin_frac=0.0, ancestor_frac=1.0,
         weighted=True),
    dict(augment_prob=0.9, marker_prob=0.5, cousin_frac=0.3, ancestor_frac=0.3,
         weighted=True),
])
def test_draw_batch_matches_jax(kw):
    """The same rng draws the same triplets, tokens, title ids and weights."""
    from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic

    kw = dict(kw)
    weighted = kw.pop("weighted", False)
    corpus, jcorpus = synthetic_corpus(200, seed=4), jsynthetic(200, seed=4)
    texts = list(corpus.titles) + list(corpus.semantic_texts)
    out = []
    for tool, c, tok in ((ttool, corpus, WordPieceTokenizer.from_corpus(texts)),
                         (jtool, jcorpus, JTok.from_corpus(texts))):
        examples, title_ids = tool.build_examples(c)
        tw = tool.title_weight_map(c) if weighted else None
        idx = np.random.default_rng(1).permutation(len(examples))[:32]
        batch = tool.draw_batch(examples, idx, c.titles, title_ids,
                                np.random.default_rng(2), tok, 16, 32,
                                title_weights=tw, **kw)
        out.append((batch, title_ids))
    (got, got_ids), (want, want_ids) = out
    assert got_ids == want_ids and set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_cousin_frac_zero_never_draws_cousins():
    ex = ttool.Example(anchor="霍乱", positive="霍乱 | ICD-10: A00", ga=0, gb=0,
                       sib_titles=(), cousin_titles=("副霍乱",), augment=False)
    tok = WordPieceTokenizer.from_corpus(["霍乱", "副霍乱", "霍乱 | ICD-10: A00", "胃炎", "肠炎"])
    for frac, drawn in ((0.0, False), (0.3, True)):
        title_ids = {}
        ttool.draw_batch([ex], np.zeros(8, dtype=int), ["胃炎", "肠炎"], title_ids,
                         np.random.default_rng(0), tok, seq_a=16, seq_b=24,
                         augment_prob=0.0, marker_prob=0.0, cousin_frac=frac)
        assert ("副霍乱" in title_ids) == drawn


def test_select_vocab(tmp_path):
    ck_tok = WordPieceTokenizer.from_corpus(["霍乱", "肺炎"])
    (tmp_path / "ck").mkdir()
    ck_tok.save_vocab(str(tmp_path / "ck" / "vocab.txt"))
    fresh = WordPieceTokenizer.from_corpus(["霍乱", "肺炎", "新字"])
    tok = ttool.select_vocab(None, str(tmp_path / "ck" / "params.npz"), lambda: fresh)
    assert tok.vocab_size == ck_tok.vocab_size and tok.encode("霍乱") == ck_tok.encode("霍乱")
    explicit = WordPieceTokenizer.from_corpus(["甲"])
    explicit.save_vocab(str(tmp_path / "explicit.txt"))
    tok = ttool.select_vocab(str(tmp_path / "explicit.txt"),
                             str(tmp_path / "ck" / "params.npz"), lambda: fresh)
    assert tok.vocab_size == explicit.vocab_size
    (tmp_path / "none").mkdir()
    assert ttool.select_vocab(None, str(tmp_path / "none" / "params.npz"),
                              lambda: fresh) is fresh


# --------------------------------------------------------- the CLI end to end


@pytest.fixture
def tiny_cli(tmp_path, monkeypatch):
    """A 2-layer, 32-wide encoder config over a 300-row synthetic CSV."""
    corpus = synthetic_corpus(300, seed=3)
    csv = tmp_path / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    base = tconfig.Config()
    cfg = dataclasses.replace(
        base, data_path=str(csv),
        encoder=tconfig.EncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                      intermediate_size=64, weights_path=None,
                                      vocab_path=None, dtype="float32"),
        store=dataclasses.replace(base.store, db_path=str(tmp_path / "db" / "s")),
    )
    monkeypatch.setattr(tconfig, "get_config", lambda: cfg)
    return tmp_path


ARGS = ["--batch", "16", "--seq-a", "16", "--seq-b", "32", "--log-every", "1"]


def test_cli_trains_checkpoints_and_resumes(tiny_cli):
    out = tiny_cli / "run"
    rc = ttool.main(ARGS + ["--steps", "4", "--weighted-loss", "--out", str(out),
                            "--save-every", "2", "--keep-every", "2"], device="cpu")
    assert rc == 0
    names = {p.name for p in out.iterdir()}
    assert {"params.npz", "vocab.txt", "opt_state.npz", "params_step2.npz",
            "params_step4.npz"} <= names
    flat = np.load(out / "opt_state.npz")
    assert int(flat["__step__"]) == 4
    n_leaves = sum(1 for k in flat.files if k.startswith("leaf_"))
    assert n_leaves == 2 * (5 + 16 * 2) + 2  # count, mu, nu, schedule count
    assert int(flat["leaf_0"]) == 4 and int(flat[f"leaf_{n_leaves - 1}"]) == 4
    # a full resume continues from step 4; --params-only restarts the schedule
    for extra, first_step in (([], 5), (["--params-only"], 1)):
        res = tiny_cli / f"resume{first_step}"
        rc = ttool.main(ARGS + ["--steps", "6", "--out", str(res), "--save-every", "1",
                                "--keep-every", "1", "--init-from", str(out / "params.npz")]
                        + extra, device="cpu")
        assert rc == 0
        kept = sorted(p.name for p in res.glob("params_step*.npz"))
        assert kept == [f"params_step{i}.npz" for i in range(first_step, 7)]


def test_cli_resumes_a_jax_checkpoint(tiny_cli):
    """A checkpoint in the JAX tool's layout (flax parameter tree, optax
    leaves of adamw(warmup_cosine), __step__) resumes in the port."""
    out = tiny_cli / "run"
    assert ttool.main(ARGS + ["--steps", "2", "--out", str(out)], device="cpu") == 0
    tok = WordPieceTokenizer.from_vocab_file(str(out / "vocab.txt"))
    jarch = JArch(vocab_size=max(21128, tok.vocab_size), hidden_size=32, num_layers=2,
                  num_heads=2, intermediate_size=64)
    params = jax.device_get(jinit(jarch, seed=1))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-4, 1, 6), weight_decay=0.01)
    leaves = jax.tree_util.tree_leaves(opt.init(params))
    leaves[0] = np.asarray(3, np.int32)
    leaves[-1] = np.asarray(3, np.int32)
    jdir = tiny_cli / "jax"
    jdir.mkdir()
    save_params(jax.tree_util.tree_map(np.asarray, params), str(jdir / "params.npz"))
    tok.save_vocab(str(jdir / "vocab.txt"))
    np.savez(str(jdir / "opt_state.npz"), __step__=np.int64(3),
             **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})
    res = tiny_cli / "resumed"
    assert ttool.main(ARGS + ["--steps", "5", "--out", str(res),
                              "--init-from", str(jdir / "params.npz")], device="cpu") == 0
    assert int(np.load(res / "opt_state.npz")["leaf_0"]) == 5
    # and the port's checkpoint loads in the JAX layout
    back = load_params(str(res / "params.npz"))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(back)[0]]
    assert paths == [jax.tree_util.keystr(p)
                     for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


def test_cli_eval_gate_blesses_and_rejects(tiny_cli):
    out = tiny_cli / "gate"
    rc = ttool.main(ARGS + ["--steps", "2", "--out", str(out), "--eval-gate", "0.0"],
                    device="cpu")
    gate = json.loads((out / "eval_gate.json").read_text())
    assert rc == 0 and gate["blessed"] is True and gate["baseline"] == 0.0
    assert set(gate) == {"tiers", "gate_metric", "candidate", "baseline", "blessed"}
    rc = ttool.main(ARGS + ["--steps", "2", "--out", str(out), "--eval-gate", "1.01",
                            "--init-from", str(out / "params.npz")], device="cpu")
    assert rc == 3
    assert json.loads((out / "eval_gate.json").read_text())["blessed"] is False


def test_cli_asks_for_the_card_by_default(tiny_cli):
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttool.main(ARGS + ["--steps", "1", "--out", str(tiny_cli / "x")])
