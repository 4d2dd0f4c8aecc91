"""Megatron tensor parallelism of the encoder's training step: the port's
parallel/tensor_parallel.py, parallel/train.py at tp > 1 and the CLI's
``--tp``, against the JAX package's sharded step on the 8 virtual CPU
devices that tests/conftest.py forces, and against the port's own tp = 1
step, on the same numpy inputs (made from seeds), on the CPU. The port's
side runs on logical tp shards of the CPU.

Shapes: (dp = 2, tp = 4) on the 4-head, 64-wide TINY arch, whose heads
divide over tp (each shard runs its own head), and (dp = 1, tp = 8) on a
12-head, 96-wide arch, where they do not (q, k and v are gathered).

Tolerances, stated before the comparison:

- Against the JAX sharded step, fp32 compute, three steps of
  ``optax.adamw(warmup_cosine)`` at a peak lr of 1e-3 (the first at lr 0):
  each step's loss within 1e-5, every parameter within 1e-4 but the
  attention key biases. Their gradient is zero in exact arithmetic, so
  each side's is rounding noise that Adam turns into updates of up to the
  learning rate, of either sign: they are held to 2·Σ lr_t
  (tests/test_torch_train.py gives the reason). The same holds, less
  strongly, for an element whose gradient nearly cancels: at (1, 8),
  weighted, one word-embedding element ends 3.4e-5 apart between the JAX
  package's own sharded and single-device steps, and 7.0e-5 from the
  port's, so the parameters take tests/test_torch_train.py's 1e-4, not
  1e-5; every other element is within about 1e-6.
- Against the port's tp = 1 step: the same bounds at fp32 (the TP step
  sums the same products in other groupings; that element ends 2.9e-5
  apart); at bf16 compute each step's loss within 2e-2 (each shard's
  partial product is rounded to bf16 on its own; the bound of
  chip_smoke.py's train phase).
- The CLI at (dp = 1, tp = 2) on a world-size-1 gloo group: its
  checkpoint resumed for two more steps at tp = 1 in either package and at
  tp = 2 in the port, at fp32 compute: every parameter within 1e-4 but
  the key biases (2·Σ lr + 1e-4): the bound of tests/test_torch_train.py's
  port-against-optax steps.
"""

import dataclasses
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from rag_icd10_tpu import config as jconfig
from rag_icd10_tpu.models import bert as jbert
from rag_icd10_tpu.parallel import mesh as jmesh
from rag_icd10_tpu.parallel import train as jtrain
from rag_icd10_tpu.tools import train_encoder as jtool
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.models import bert as tbert
from rag_icd10_tpu_torch.models.bert import BertArch, init_params
from rag_icd10_tpu_torch.models.convert_hf import load_params
from rag_icd10_tpu_torch.parallel import (
    TensorParallelBert,
    init_train_state,
    make_mesh,
    multihost,
    opt_state_shardings,
)
from rag_icd10_tpu_torch.parallel import tensor_parallel as tp_mod
from rag_icd10_tpu_torch.parallel import train as ttrain
from rag_icd10_tpu_torch.tools import train_encoder as ttool

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL_LOSS = 1e-5
TOL_PARAM = 1e-4
TOL_BF16 = 2e-2
TOL_CLI = 1e-4
LR = 1e-3
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=32)
HEADS12 = dict(vocab_size=128, hidden_size=96, num_layers=2, num_heads=12,
               intermediate_size=192, max_position_embeddings=32)
SHAPES = {"dp2_tp4": (TINY, 2, 4), "dp1_tp8": (HEADS12, 1, 8)}
OBJECTIVES = ("pairs", "triplets", "weighted")


def _batch(seed, b=8, objective="triplets"):
    """Token batches with padding (the last 3 positions masked)."""
    r = np.random.default_rng(seed)
    batch = {}
    sides = (("a", 16), ("b", 24)) + ((("h", 16),) if objective != "pairs" else ())
    for name, seq in sides:
        ids = r.integers(1, 128, size=(b, seq)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[:, seq - 3:] = 0
        batch.update({f"{name}_ids": ids, f"{name}_mask": mask,
                      f"{name}_types": np.zeros_like(ids)})
    if objective != "pairs":
        batch.update(group_a=np.arange(b, dtype=np.int32),
                     group_b=np.arange(b, 2 * b, dtype=np.int32),
                     h_group=np.arange(2 * b, 3 * b, dtype=np.int32))
    if objective == "weighted":
        batch.update(w_b=r.choice([0.8, 1.0, 1.2], b).astype(np.float32),
                     w_h=r.choice([0.8, 1.0, 1.2], b).astype(np.float32))
    return batch


def _schedule():
    return ttrain.warmup_cosine_decay_schedule(0.0, LR, 1, 10)


def _tp_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp), distributed=False)


def _port_run(arch, params, batches, dp=1, tp=1):
    """Steps of the port at (dp, tp) logical CPU shards (tp = 1 without a
    mesh); returns the state and each step's loss."""
    if tp == 1:
        state, step = init_train_state(arch, device="cpu", params=params,
                                       schedule=_schedule()), ttrain.make_train_step()
    else:
        mesh = _tp_mesh(dp, tp)
        state = init_train_state(arch, mesh=mesh, params=params, schedule=_schedule())
        step = ttrain.make_sharded_train_step(mesh)
    return state, [float(step(state, b)["loss"]) for b in batches]


def _assert_params_close(got, want, lrs, tol):
    bound = 2 * sum(lrs) * (1 + 0.01) + tol
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        err = float(np.max(np.abs(np.asarray(w) - np.asarray(g))))
        limit = bound if "['key']['bias']" in name else tol
        assert err <= limit, (name, err, limit)


# ------------------------------------------- the port's step against JAX's


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tp_step_matches_the_jax_sharded_step(shape, objective):
    dims, dp, tp = SHAPES[shape]
    jarch = jbert.BertArch(**dims, compute_dtype=jnp.float32)
    params = jax.device_get(jbert.init_params(jarch, seed=0))
    batches = [_batch(i, objective=objective) for i in range(3)]

    mesh = jmesh.make_mesh(n_devices=8, dp=dp, tp=tp)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=1, decay_steps=10)
    jparams, jopt, opt = jtrain.init_train_state(
        jarch, mesh=mesh, params=params,
        optimizer=optax.adamw(schedule, weight_decay=0.01))
    jstep = jtrain.make_sharded_train_step(jarch, mesh, opt)
    rows = jmesh.batch_sharding(mesh)
    jlosses = []
    for b in batches:
        jparams, jopt, m = jstep(jparams, jopt, {k: jax.device_put(v, rows)
                                                 for k, v in b.items()})
        jlosses.append(float(m["loss"]))

    state, tlosses = _port_run(BertArch(**dims, compute_dtype=torch.float32), params,
                               batches, dp, tp)
    assert isinstance(state.model, TensorParallelBert) and state.step == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=TOL_LOSS)
    _assert_params_close(state.params(), jax.device_get(jparams),
                         [float(schedule(i)) for i in range(3)], TOL_PARAM)
    got = state.opt_state_leaves()
    want = jax.tree_util.tree_leaves(jax.device_get(jopt))
    assert len(got) == len(want) and int(got[0]) == int(want[0]) == 3


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tp_step_matches_the_port_tp1_step(shape, objective, dtype):
    dims, dp, tp = SHAPES[shape]
    arch = BertArch(**dims, compute_dtype=torch.float32 if dtype == "fp32" else torch.bfloat16)
    params = init_params(arch, seed=1)
    batches = [_batch(10 + i, objective=objective) for i in range(3)]
    sharded, tp_losses = _port_run(arch, params, batches, dp, tp)
    single, losses = _port_run(arch, params, batches)
    if dtype == "bf16":
        np.testing.assert_allclose(tp_losses, losses, rtol=0, atol=TOL_BF16)
        return
    np.testing.assert_allclose(tp_losses, losses, rtol=0, atol=TOL_LOSS)
    _assert_params_close(sharded.params(), single.params(),
                         [_schedule()(i) for i in range(3)], TOL_PARAM)
    for g, w in zip(sharded.opt_state_leaves(), single.opt_state_leaves()):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_PARAM)


def test_split_and_join_invert_each_other():
    tree = init_params(BertArch(**HEADS12), seed=2)
    shards = tp_mod.split_params(tree, 8)
    assert shards[3]["bert"]["word_embeddings"]["embedding"].shape == (16, 96)
    assert shards[3]["bert"]["layer_1"]["attention"]["out"]["kernel"].shape == (12, 96)
    assert shards[3]["bert"]["layer_1"]["intermediate"]["bias"].shape == (24,)
    assert shards[3]["bert"]["layer_1"]["output_ln"]["scale"].shape == (96,)
    back = tp_mod.join_params(shards)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and np.array_equal(a, b)


# ------------------------------------------------------- optimizer layout


def test_opt_state_shardings_match_jax():
    jarch = jbert.BertArch(**TINY)
    params = jax.device_get(jbert.init_params(jarch, seed=0))
    mesh = jmesh.make_mesh(n_devices=8, dp=2, tp=4)
    for opt in (optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, 1, 10)),
                optax.adamw(LR)):
        opt_state = opt.init(params)
        want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
            jtrain.opt_state_shardings(mesh, params, opt_state))]
        leaves = jax.tree_util.tree_leaves(opt_state)
        got = opt_state_shardings(_tp_mesh(2, 4), params, leaves)
        assert got == want and len(got) == len(leaves)
        assert ("tp", None) in got and (None, "tp") in got and ("tp",) in got


def test_tp_warm_start_keeps_the_given_state():
    """--dp --tp --init-from must resume from the checkpoint (JAX
    test_sharded_init_keeps_warm_started_state at (2, 4)): the TP state
    starts from the given parameters and optimizer leaves."""
    arch = BertArch(**TINY, compute_dtype=torch.float32)
    host, fresh = init_params(arch, seed=123), init_params(arch, seed=0)
    warm = init_train_state(arch, device="cpu", params=host, schedule=LR)
    ttrain.contrastive_train_step(warm, _batch(8))
    params, leaves = warm.params(), warm.opt_state_leaves()
    mesh = _tp_mesh(2, 4)
    state = init_train_state(arch, mesh=mesh, seed=0, schedule=LR, params=params,
                             opt_state=leaves)
    assert any(not np.allclose(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(host), jax.tree_util.tree_leaves(fresh)))
    for got, want in zip(jax.tree_util.tree_leaves(state.params()),
                         jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(state.opt_state_leaves(), leaves):
        np.testing.assert_array_equal(got, want)
    assert state.step == 1 and state.optimizer.param_groups[0]["lr"] == LR
    assert np.isfinite(float(ttrain.make_sharded_train_step(mesh)(state, _batch(8))["loss"]))


# ------------------------------------------------------------- refusals


@pytest.mark.parametrize("width,leaf,named", [
    (dict(vocab_size=130), "bert/word_embeddings/embedding", "word_embeddings/embedding"),
    (dict(hidden_size=66, num_heads=2), "bert/layer_0/attention/query/kernel",
     "attention/(query|key|value)/"),
    (dict(intermediate_size=130), "bert/layer_0/intermediate/kernel", "intermediate/"),
])
def test_a_width_tp_does_not_divide_is_refused(width, leaf, named):
    """As jax.device_put refuses the same leaf at tp = 4; the error names
    the first such parameter of the tree."""
    dims = {**TINY, **width}
    jtree = jax.device_get(jbert.init_params(jbert.BertArch(**dims), seed=0))
    x = functools.reduce(lambda node, key: node[key], leaf.split("/"), jtree)
    spec = jmesh._spec_for_path(leaf)
    with pytest.raises(ValueError):
        jax.device_put(x, NamedSharding(jmesh.make_mesh(n_devices=8, dp=2, tp=4), spec))
    arch = BertArch(**dims)
    with pytest.raises(ValueError, match=named):
        init_train_state(arch, mesh=_tp_mesh(2, 4), params=init_params(arch, seed=0))
    with pytest.raises(ValueError, match=named):
        tp_mod.split_params(init_params(arch, seed=0), 4)


def test_an_out_of_range_token_id_fails_as_at_tp1():
    arch = BertArch(**TINY, compute_dtype=torch.float32)
    batch = _batch(3)
    batch["a_ids"][2, 4] = TINY["vocab_size"]
    single = init_train_state(arch, device="cpu", schedule=LR)
    with pytest.raises(IndexError):
        ttrain.make_train_step()(single, batch)
    mesh = _tp_mesh(2, 4)
    sharded = init_train_state(arch, mesh=mesh, schedule=LR)
    with pytest.raises(IndexError, match="out of range"):
        ttrain.make_sharded_train_step(mesh)(sharded, batch)


def test_a_tp_that_does_not_divide_the_heads_is_run():
    """12 heads at tp = 8 (BERT-base's at the JAX package's default tp on
    eight devices): 1.5 heads a shard, the gather path."""
    arch = BertArch(**HEADS12)
    assert arch.num_heads % 8
    state, losses = _port_run(arch, init_params(arch, seed=0), [_batch(0)], 1, 8)
    assert len(state.model.shards) == 8 and np.isfinite(losses).all()


# ------------------------------------------------- the CLI and checkpoints


@pytest.fixture
def tiny_cli(tmp_path, monkeypatch):
    """Both tools over one 300-row synthetic CSV, a 2-layer, 32-wide
    encoder, fp32 compute."""
    corpus = synthetic_corpus(300, seed=3)
    csv = tmp_path / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    dims = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                weights_path=None, vocab_path=None)
    tbase, jbase = tconfig.Config(), jconfig.Config()
    tcfg = dataclasses.replace(tbase, data_path=str(csv),
                               encoder=tconfig.EncoderConfig(**dims),
                               store=dataclasses.replace(tbase.store, db_path=str(tmp_path / "s")))
    jcfg = dataclasses.replace(jbase, data_path=str(csv),
                               encoder=jconfig.EncoderConfig(**dims),
                               store=dataclasses.replace(jbase.store, db_path=str(tmp_path / "j")))
    monkeypatch.setattr(tconfig, "get_config", lambda: tcfg)
    monkeypatch.setattr(jconfig, "get_config", lambda: jcfg)
    monkeypatch.setattr(tbert, "BertArch", functools.partial(BertArch,
                                                             compute_dtype=torch.float32))
    monkeypatch.setattr(jbert, "BertArch", functools.partial(jbert.BertArch,
                                                             compute_dtype=jnp.float32))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       jax.config.jax_compilation_cache_dir or str(tmp_path / "jax_cache"))
    return tmp_path


ARGS = ["--batch", "8", "--seq-a", "16", "--seq-b", "32", "--log-every", "1",
        "--save-every", "1", "--keep-every", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tp2_cli(argv):
    """The port's CLI with --dp 1 --tp 2 over two logical CPU devices of a
    world-size-1 gloo group."""
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, local_device_count=2,
                         device="cpu", timeout_s=60)
    try:
        return ttool.main(ARGS + ["--dp", "1", "--tp", "2"] + argv, device="cpu")
    finally:
        multihost.shutdown()


def test_cli_tp_checkpoint_resumes_in_both_packages(tiny_cli):
    """Two steps of the port's CLI at tp = 2 write the one checkpoint
    format; resumed for two more steps at tp = 1 in the JAX tool and in
    the port, and at tp = 2 in the port, the three agree; the JAX tool's
    checkpoint resumes in the port at tp = 2."""
    ck = tiny_cli / "tp2"
    assert _tp2_cli(["--steps", "2", "--out", str(ck)]) == 0
    flat = np.load(ck / "opt_state.npz")
    assert int(flat["__step__"]) == 2 and int(flat["leaf_0"]) == 2
    resume = ["--steps", "4", "--init-from", str(ck / "params.npz")]
    runs = {"jax": jtool.main(ARGS + resume + ["--out", str(tiny_cli / "jax")]),
            "tp1": ttool.main(ARGS + resume + ["--out", str(tiny_cli / "tp1")], device="cpu"),
            "tp2": _tp2_cli(resume + ["--out", str(tiny_cli / "tp2_resumed")])}
    assert runs == {"jax": 0, "tp1": 0, "tp2": 0}
    out = {name: tiny_cli / (name if name != "tp2" else "tp2_resumed") for name in runs}
    for name, path in out.items():  # each restored step 2 and ran steps 3 and 4
        kept = sorted(p.name for p in path.glob("params_step*.npz"))
        assert kept == ["params_step3.npz", "params_step4.npz"], (name, kept)
        assert int(np.load(path / "opt_state.npz")["leaf_0"]) == 4
    schedule = ttrain.warmup_cosine_decay_schedule(0.0, 1e-4, 1, 4)
    lrs = [schedule(2), schedule(3)]
    want = load_params(str(out["tp2"] / "params.npz"))
    for name in ("jax", "tp1"):
        _assert_params_close(load_params(str(out[name] / "params.npz")), want, lrs, TOL_CLI)
    # and the JAX tool's checkpoint resumes in the port at tp = 2
    back = tiny_cli / "from_jax"
    assert _tp2_cli(["--steps", "5", "--init-from", str(out["jax"] / "params.npz"),
                     "--out", str(back)]) == 0
    assert sorted(p.name for p in back.glob("params_step*.npz")) == ["params_step5.npz"]


@pytest.mark.parametrize("heads,hidden", [(12, 96), (3, 48)])
def test_a_world_size_one_group_step_equals_the_local_step(heads, hidden):
    """At (1, 2) on a world-size-1 gloo group the tp reductions run through
    the autograd Functions' collectives (12 heads: copy and reduce; 3
    heads, which do not divide over 2: gather too); the step equals the
    local one (plain sums) to the bit."""
    arch = BertArch(**{**HEADS12, "num_heads": heads, "hidden_size": hidden},
                    compute_dtype=torch.float32)
    params, batches = init_params(arch, seed=4), [_batch(20 + i) for i in range(2)]
    local, want = _port_run(arch, params, batches, 1, 2)
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, local_device_count=2,
                         device="cpu", timeout_s=60)
    try:
        mesh = make_mesh(dp=1, tp=2)
        assert mesh.group is not None
        state = init_train_state(arch, mesh=mesh, params=params, schedule=_schedule())
        assert state.model.group is not None
        step = ttrain.make_sharded_train_step(mesh)
        got = [float(step(state, b)["loss"]) for b in batches]
        assert got == want
        for a, b in zip(state.model.parameters(), local.model.parameters()):
            assert torch.equal(a, b)
    finally:
        multihost.shutdown()


def test_train_layout_of_one_process():
    """One process holds every cell: all dp and tp indices, no process
    groups; its cells must share one device."""
    from rag_icd10_tpu_torch.parallel import train_layout

    layout = train_layout(_tp_mesh(2, 4))
    assert (layout.dp_indices, layout.tp_indices, layout.n_dp, layout.n_tp) == (
        (0, 1), (0, 1, 2, 3), 2, 4)
    assert layout.device == torch.device("cpu") and layout.tp_group is layout.dp_group is None
    mixed = make_mesh(dp=1, tp=2, devices=["cpu", "meta"], distributed=False)
    with pytest.raises(ValueError, match="one device"):
        init_train_state(BertArch(**TINY), mesh=mixed)
