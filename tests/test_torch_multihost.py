"""Two-process dry run of the port's distributed search: two gloo
processes join through ``parallel.multihost.initialize`` (tcp rendezvous
on a free port, 60 s timeout) and hold 4 logical CPU shards each, one
8-shard mesh across the process boundary. Each runs the real paths:
``global_device_put`` + ``global_sum`` (one ``all_reduce``) and a
corpus-sharded search whose per-rank merges meet in one ``all_gather``.

The worker is this file run as a script, so it imports no JAX (it
asserts so). The parent checks that both ranks print the same lines:
``global_sum`` = 2016.0 and a search result equal to numpy's argsort in
every fp32 method the shards serve, and to the one-shard int8 law (values
bit for bit) in both int8 methods. The counterpart of
tests/test_multihost.py.
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


def test_two_process_gloo_dryrun():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, f"127.0.0.1:{port}", "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
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
    assert checks[0] == checks[1], checks  # both ranks computed the same results
    assert checks[0][0] == "CHECK mesh {'shard': 8} ranks [0, 0, 0, 0, 1, 1, 1, 1]"
    assert checks[0][1] == "CHECK sum 2016.0"  # sum(arange(64))
    searches = checks[0][2:]
    assert len(searches) == 7, searches
    assert all(line.endswith(" True") for line in searches), searches


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
        assert "jax" not in sys.modules and not any(
            m == "rag_icd10_tpu" or m.startswith("rag_icd10_tpu.") for m in sys.modules)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
