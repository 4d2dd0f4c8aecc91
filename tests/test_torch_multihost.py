"""Two-process dry run of the port's distributed search: two gloo
processes join through ``parallel.multihost.initialize`` (tcp rendezvous
on a free port, 60 s timeout) and hold 4 logical CPU shards each, one
8-shard mesh across the process boundary. Each runs the real paths:
``global_device_put`` + ``global_sum`` (one ``all_reduce``) and a
corpus-sharded search whose per-rank merges meet in one ``all_gather``.

Then the data-parallel training step: a (dp = 2, tp = 1) mesh with one
CPU device a rank; each rank embeds its half of a batch of 8 (with hard
negatives and level weights), and the step must equal the single-process
step over all 8 rows, which each rank also runs on its own: the loss of
both steps within 1e-5, and every parameter after them within 1e-5 but
the attention key biases, whose gradient is zero in exact arithmetic and
whose Adam updates are rounding noise of either sign (held to 2·Σ lr, as
in tests/test_torch_train.py). That shows the in-batch negatives stay
global. A dp state started from given parameters and optimizer leaves
keeps them (the warm start of ``--dp --init-from``).

Two more runs train with Megatron TP (``tp`` > 1), each rank holding the
same whole batch and checked against the one-process tp = 1 step that
it also runs (the same bounds): (dp = 2 across 2 processes, tp = 4
logical CPU shards inside each, the layout of tests/multihost_worker.py),
and (dp = 2, tp = 2) over 4 processes with one CPU each, whose tp and dp
process groups carry the ``copy``, ``reduce`` and ``gather`` autograd
Functions. Each runs a 4-head arch (the heads divide over tp) and a
3-head one (they do not: q, k, v are gathered), checks that the
replicated parameters' gradients are equal to the bit on every rank of a
tp group, and that a TP state started from given parameters and
optimizer leaves keeps them.

The worker is this file run as a script, so it imports no JAX (it
asserts so). The parent checks that both ranks print the same lines:
``global_sum`` = 2016.0, a search result equal to numpy's argsort in
every fp32 method the shards serve, and to the one-shard int8 law (values
bit for bit) in both int8 methods, and the training checks. The
counterpart of tests/test_multihost.py.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(nproc: int, mode: str):
    """Start ``nproc`` workers in ``mode`` (120 s each) and return each
    rank's CHECK lines, which must agree."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, f"127.0.0.1:{port}", str(nproc), str(i), mode],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
    checks = [[line for line in out.splitlines() if line.startswith("CHECK")] for out in outs]
    assert all(c == checks[0] for c in checks), checks  # every rank computed the same
    return checks


def test_two_process_gloo_dryrun():
    checks = _run_ranks(2, "search")
    assert checks[0][0] == "CHECK mesh {'shard': 8} ranks [0, 0, 0, 0, 1, 1, 1, 1]"
    assert checks[0][1] == "CHECK sum 2016.0"  # sum(arange(64))
    searches = [line for line in checks[0] if line.startswith("CHECK search")]
    assert len(searches) == 7, searches
    assert all(line.endswith(" True") for line in searches), searches
    train = [line for line in checks[0] if line.startswith("CHECK train")]
    assert train == ["CHECK train dp mesh {'dp': 2, 'tp': 1} ranks [0, 1]",
                     "CHECK train sharded step equals the one-process step True",
                     "CHECK train warm start kept True"], checks[0]


def _worker(coordinator: str, nproc: int, rank: int) -> int:
    sys.path.insert(0, str(REPO))
    import torch

    from rag_icd10_tpu_torch.parallel import ShardedFlatSearcher, make_mesh
    from rag_icd10_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(coordinator, nproc, rank, local_device_count=4, device="cpu",
                         timeout_s=60)
    try:
        mesh = make_mesh(axis_names=("shard",))  # every rank's 4 CPU shards
        print(f"CHECK mesh {mesh.shape} ranks {mesh.ranks.tolist()}", flush=True)
        parts = multihost.global_device_put(np.arange(64, dtype=np.float32), mesh, "shard")
        assert sum(p is not None for p in parts) == 4
        print(f"CHECK sum {multihost.global_sum(parts, mesh)}", flush=True)

        rng = np.random.default_rng(7)  # the same data in every process
        n, d, k = 1024, 32, 5
        corpus = rng.standard_normal((n, d)).astype(np.float32)
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
        weights = np.ones(n, np.float32)
        q = rng.standard_normal((2, d)).astype(np.float32)
        eidx = np.argsort(-(q @ corpus.T), axis=1)[:, :k]
        # the int8 law over one local shard: the sharded merge equals it
        one = make_mesh(axis_names=("shard",), devices=["cpu"], distributed=False)
        ref_v, ref_i = ShardedFlatSearcher(corpus, weights, one, "shard", "int8").search(
            q, k, method="exact")
        for store_dtype, methods in (("fp32", ("auto", "exact", "fast", "chunkstream",
                                                "approx")),
                                     ("int8", ("exact", "chunkstream"))):
            searcher = ShardedFlatSearcher(corpus, weights, mesh, axis="shard",
                                           store_dtype=store_dtype)
            assert len(searcher.shards) == 4
            for method in methods:
                vals, idx = searcher.search(q, k, method=method)
                ok = np.array_equal(idx, eidx) if store_dtype == "fp32" else (
                    np.array_equal(vals, ref_v)
                    and all(set(a) == set(b) for a, b in zip(idx, ref_i)))
                print(f"CHECK search {store_dtype} {method} {idx[0].tolist()} {ok}",
                      flush=True)
        _train_checks(mesh)
        assert "jax" not in sys.modules and not any(
            m == "rag_icd10_tpu" or m.startswith("rag_icd10_tpu.") for m in sys.modules)
    finally:
        multihost.shutdown()
    return 0


def _train_batch(b: int = 8):
    """The same whole batch on every rank: hard negatives, level weights."""
    r = np.random.default_rng(0)
    batch = {}
    for name, seq in (("a", 16), ("b", 24), ("h", 16)):
        ids = r.integers(1, 128, size=(b, seq)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[:, seq - 3:] = 0
        batch.update({f"{name}_ids": ids, f"{name}_mask": mask,
                      f"{name}_types": np.zeros_like(ids)})
    batch.update(group_a=np.arange(b, dtype=np.int32),
                 group_b=np.arange(b, 2 * b, dtype=np.int32),
                 h_group=np.arange(2 * b, 3 * b, dtype=np.int32),
                 w_b=r.choice([0.8, 1.0, 1.2], b).astype(np.float32),
                 w_h=r.choice([0.8, 1.0, 1.2], b).astype(np.float32))
    return batch


def _train_checks(search_mesh) -> None:
    import torch

    from rag_icd10_tpu_torch.models.bert import BertArch, init_params
    from rag_icd10_tpu_torch.parallel import init_train_state, make_mesh
    from rag_icd10_tpu_torch.parallel.train import make_sharded_train_step, make_train_step

    arch = BertArch(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_position_embeddings=32,
                    compute_dtype=torch.float32)
    mesh = make_mesh(dp=2, tp=1, devices=["cpu"])  # one device a rank, joined
    print(f"CHECK train dp mesh {mesh.shape} ranks {mesh.ranks.ravel().tolist()}", flush=True)
    batch, lr = _train_batch(), 1e-3
    params = init_params(arch, seed=3)
    sharded = init_train_state(arch, mesh=mesh, schedule=lr, params=params)
    single = init_train_state(arch, device="cpu", schedule=lr, params=params)
    step_s, step_1 = make_sharded_train_step(mesh), make_train_step()
    ok = True
    for _ in range(2):
        ls, l1 = float(step_s(sharded, batch)["loss"]), float(step_1(single, batch)["loss"])
        ok &= abs(ls - l1) <= 1e-5
    for (name, a), c in zip(sharded.model.named_parameters(), single.model.parameters()):
        limit = 2 * 2 * lr * 1.01 if name.endswith("attention.key.bias") else 1e-5
        ok &= float((a - c).abs().max()) <= limit
    print(f"CHECK train sharded step equals the one-process step {ok}", flush=True)
    warm = init_train_state(arch, mesh=mesh, schedule=lr, params=single.params(),
                            opt_state=single.opt_state_leaves())
    kept = warm.step == 2 and all(torch.equal(a, c) for a, c in zip(
        warm.model.parameters(), single.model.parameters()))
    print(f"CHECK train warm start kept {kept}", flush=True)


TP_CHECKS = ["sharded step equals the one-process step True",
             "replicated gradients equal over the tp group True",
             "warm start kept True"]


def _tp_expected(mesh: str, ranks: str):
    return ([f"CHECK tp mesh {mesh} ranks {ranks}"]
            + [f"CHECK tp heads {h} {c}" for h in (4, 3) for c in TP_CHECKS])


def test_two_process_dp_with_logical_tp():
    """dp = 2 across the process boundary, tp = 4 logical shards inside
    each process (the tp groups hold one rank each)."""
    checks = _run_ranks(2, "tp")
    assert checks[0] == _tp_expected("{'dp': 2, 'tp': 4}", "[0, 0, 0, 0, 1, 1, 1, 1]")


def test_four_process_dp_tp_groups():
    """(dp = 2, tp = 2) over 4 processes with one CPU each: tp groups
    {0, 1} and {2, 3}, dp groups {0, 2} and {1, 3}."""
    checks = _run_ranks(4, "tp")
    assert checks[0] == _tp_expected("{'dp': 2, 'tp': 2}", "[0, 1, 2, 3]")


def _tp_worker(coordinator: str, nproc: int, rank: int) -> int:
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from rag_icd10_tpu_torch.models.bert import BertArch, init_params
    from rag_icd10_tpu_torch.parallel import init_train_state, make_mesh, multihost, train_layout
    from rag_icd10_tpu_torch.parallel.train import make_sharded_train_step, make_train_step

    torch.set_num_threads(1)
    local = 4 if nproc == 2 else 1
    multihost.initialize(coordinator, nproc, rank, local_device_count=local, device="cpu",
                         timeout_s=60)
    try:
        mesh = make_mesh(dp=2, tp=8 // nproc)
        layout = train_layout(mesh)
        print(f"CHECK tp mesh {mesh.shape} ranks {mesh.ranks.ravel().tolist()}", flush=True)
        batch = _train_batch()
        lr = 1e-3
        for heads, hidden in ((4, 64), (3, 48)):
            arch = BertArch(vocab_size=128, hidden_size=hidden, num_layers=2, num_heads=heads,
                            intermediate_size=128, max_position_embeddings=32,
                            compute_dtype=torch.float32)
            params = init_params(arch, seed=3)
            sharded = init_train_state(arch, mesh=mesh, schedule=lr, params=params)
            single = init_train_state(arch, device="cpu", schedule=lr, params=params)
            step_s, step_1 = make_sharded_train_step(mesh), make_train_step()
            grads = {}
            hooks = [p.register_post_accumulate_grad_hook(
                lambda p, path=path: grads.__setitem__(path, p.grad.detach().clone()))
                for path, p in sharded.model.replicated.items()]
            ok = True
            for _ in range(2):
                ls, l1 = float(step_s(sharded, batch)["loss"]), float(step_1(single, batch)["loss"])
                ok &= abs(ls - l1) <= 1e-5
                for h in hooks:  # the first step's gradients, before the dp sum
                    h.remove()
                hooks = []
            ok &= _params_close(sharded.params(), single.params(), 2 * 2 * lr * 1.01)
            print(f"CHECK tp heads {heads} {TP_CHECKS[0].rsplit(' ', 1)[0]} {ok}", flush=True)
            flat = torch.cat([grads[path].reshape(-1) for path in sorted(grads)])
            same = True
            if layout.tp_group is not None:
                parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(layout.tp_group))]
                dist.all_gather(parts, flat, group=layout.tp_group)
                same = all(torch.equal(part, flat) for part in parts)
            print(f"CHECK tp heads {heads} {TP_CHECKS[1].rsplit(' ', 1)[0]} {same}", flush=True)
            leaves = single.opt_state_leaves()
            warm = init_train_state(arch, mesh=mesh, schedule=lr, params=single.params(),
                                    opt_state=leaves)
            kept = warm.step == 2 and _params_close(warm.params(), single.params(), 0.0, 0.0) and all(
                np.array_equal(a, b) for a, b in zip(warm.opt_state_leaves(), leaves))
            print(f"CHECK tp heads {heads} {TP_CHECKS[2].rsplit(' ', 1)[0]} {kept}", flush=True)
        assert "jax" not in sys.modules and not any(
            m == "rag_icd10_tpu" or m.startswith("rag_icd10_tpu.") for m in sys.modules)
    finally:
        multihost.shutdown()
    return 0


def _params_close(got, want, key_bias_limit: float, tol: float = 1e-5, path: str = "") -> bool:
    """Every leaf of two JAX-layout trees within ``tol`` (0: equal), the
    attention key biases within ``key_bias_limit``."""
    ok = True
    for name, node in want.items():
        where = f"{path}/{name}"
        if isinstance(node, dict):
            ok &= _params_close(got[name], node, key_bias_limit, tol, where)
        else:
            limit = key_bias_limit if where.endswith("attention/key/bias") else tol
            ok &= float(np.abs(np.asarray(got[name]) - node).max()) <= limit
    return ok


if __name__ == "__main__":
    mode = sys.argv[4] if len(sys.argv) > 4 else "search"
    run = _worker if mode == "search" else _tp_worker
    sys.exit(run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
