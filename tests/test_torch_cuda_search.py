"""The search methods that launch K1 and K2 on new paths, and the int8
product, against their plain versions on a card.

These tests need an NVIDIA GPU and nvcc; they carry the ``gpu`` marker
and skip elsewhere. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_search.py -m gpu --noconftest -q

- ``chunk_select_search`` in each scan precision (K1: IEEE fp32 for
  "highest" and "high", the bf16 corpus on "mma" for "bf16") against
  ``chunk_select_search_reference`` (the same selection over K1's plain
  version): values within 5e-5 (fp32 sums of D products in two orders,
  tests/test_torch_cuda_kernels.py's tolerance), the same ids up to ties
  within it, and the same certificates away from the bound.
- ``bf16_rerank_search`` (K2 with ``exact=False``) at top_k 50 with the
  orchestrator's over-fetch (k = 100, m = 200 > 128, so the ranges run at
  depth 128) against ``bf16_rerank_search_reference``: the re-rank is
  IEEE fp32 on both sides, so the values agree within 5e-5.
- ``int8_matmul`` / ``int8_search`` on the card (``torch._int_mm``)
  against the CPU's int32 matmul: accumulators bit for bit, and the
  elementwise epilogue bit for bit too.
- Corpus-sharded search (``parallel/``) over 1, 2, 4 and 8 logical shards
  on ``cuda:0``: each fp32 method's merged top-k against the single-device
  ``fused_search`` (values within 5e-5, ids up to ties), with the kernel
  launches per search counted (K2 once per shard for ``auto``, K1 and K5
  per ``chunkstream`` shard, K1 per ``fast`` and ``exact`` shard); int8
  shards against ``int8_search`` bit for bit; the sharded store against
  the unsharded one; and an NCCL process group of world size 1 whose
  merge equals the local one.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.ops import chunk_stream, fused_score
from rag_icd10_tpu_torch.ops.flat_topk import pad_corpus
from rag_icd10_tpu_torch.ops.fused_score import (
    fused_search,
    fused_weighted_scores,
    streaming_candidates,
)
from rag_icd10_tpu_torch.ops.quantized import (
    int8_matmul,
    int8_scores,
    int8_search,
    int8_search_device_rerank,
    quantize_rows,
)
from rag_icd10_tpu_torch.ops.rerank import (
    bf16_rerank_search,
    bf16_rerank_search_reference,
    chunk_select_search,
    chunk_select_search_reference,
)

TOL = 5e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(b, n_real, d, seed, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((n_real, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    w = np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n_real)]
    cp, wp, m = pad_corpus(c, w, multiple=1024)
    return [torch.from_numpy(x).to(dev) for x in (q, cp, wp, m)]


def _same_up_to_ties(got_v, got_i, want_v, want_i, what):
    """Values within TOL; an id in one result and not the other scores
    within TOL of the k-th (a tie at the boundary)."""
    assert torch.allclose(got_v, want_v, atol=TOL, rtol=0), what
    for gv, gi, wv, wi in zip(got_v, got_i, want_v, want_i):
        g, w = dict(zip(gi.tolist(), gv.tolist())), dict(zip(wi.tolist(), wv.tolist()))
        for j in g.keys() ^ w.keys():
            assert abs(g.get(j, w.get(j)) - float(wv[-1])) <= TOL, (what, j)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("b,k", [(2, 20), (8, 10), (17, 50), (64, 100)])
def test_chunk_select_matches_plain(cuda, precision, b, k):
    q, c, w, m = _problem(b, 40474 if b <= 8 else 9000, 768, seed=b, dev=cuda)
    scan = c.to(torch.bfloat16) if precision == "bf16" else c
    kwargs = dict(k=k, corpus_f32=c, scan_precision=precision, guarantee=False)
    before = fused_weighted_scores.launches
    got_v, got_i, got_c = chunk_select_search(q, scan, w, m, **kwargs)
    assert fused_weighted_scores.launches == before + 1  # the scan ran on K1
    want_v, want_i, want_c = chunk_select_search_reference(q, scan, w, m, **kwargs)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int32 and tuple(got_v.shape) == (b, k)
    _same_up_to_ties(got_v, got_i, want_v, want_i, precision)
    assert torch.equal(got_c, want_c)
    if b <= 8 and precision != "bf16":  # 320 chunks, mc = max(4k, k + 30)
        assert bool(got_c.all())  # random rows certify without a margin to beat
    assert int(got_i.max()) < c.shape[0] and bool(torch.isfinite(got_v).all())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_chunk_select_ties_redo_exactly(cuda, precision):
    """Near-identical rows de-certify the "high" and "bf16" margins, and
    guarantee=True redoes the batch on the exact K1 path; "highest" fetches
    all 16 chunks (mc = 40), and its k-th (k <= 16) never falls below the
    smallest chunk maximum, so it certifies and is exact as it stands."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal(128).astype(np.float32)
    base /= np.linalg.norm(base)
    rows = base + 1e-8 * rng.standard_normal((2048, 128)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    cp, wp, mp = pad_corpus(rows, np.ones(2048, np.float32), multiple=1024)
    c, w, m = (torch.from_numpy(x).to(cuda) for x in (cp, wp, mp))
    q = torch.from_numpy(base[None, :]).to(cuda)
    scan = c.to(torch.bfloat16) if precision == "bf16" else c
    vals, _, cert = chunk_select_search(
        q, scan, w, m, k=10, corpus_f32=c, scan_precision=precision)
    exact = torch.topk(q @ c.T, 10, dim=1).values
    assert bool(cert.all()) if precision == "highest" else not bool(cert.any())
    assert torch.allclose(vals, exact, atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 8, 64])
def test_bf16_rerank_top50_overfetch_matches_plain(cuda, b):
    q, c, w, m = _problem(b, 40474, 768, seed=100 + b, dev=cuda)
    c16 = c.to(torch.bfloat16)
    before = streaming_candidates.launches
    got_v, got_i, got_c = bf16_rerank_search(q, c16, c, w, m, k=100, guarantee=False)
    assert streaming_candidates.launches == before + 1  # K2 ran
    want_v, want_i, want_c = bf16_rerank_search_reference(
        q, c16, c, w, m, k=100, guarantee=False)
    torch.cuda.synchronize()
    _same_up_to_ties(got_v, got_i, want_v, want_i, f"bf16 rerank B={b}")
    assert torch.equal(got_c, want_c)
    exact = torch.topk(fused_weighted_scores(q, c, w, m), 100, dim=1).values
    certified = got_c.nonzero().flatten()
    assert torch.allclose(got_v[certified], exact[certified], atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 17, 64])
@pytest.mark.parametrize("n,d", [(4096, 768), (1000, 100)])
def test_int8_product_bit_equal_to_cpu(cuda, b, n, d):
    """torch._int_mm takes B > 16 and multiples of 8: B, D (100) and N
    (1000 is one) pad with zeros, which add nothing to an integer sum."""
    rng = np.random.default_rng(b + n)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q, rows = q / q.norm(dim=1, keepdim=True), rows / rows.norm(dim=1, keepdim=True)
    qi, _ = quantize_rows(q)
    ci, cs = quantize_rows(rows)
    before = int8_matmul.launches
    got = int8_matmul(qi.to(cuda), ci.to(cuda))
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n)
    assert torch.equal(got.cpu(), int8_matmul(qi, ci))
    w = torch.from_numpy(np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n)])
    mask = torch.zeros(n)
    args_cpu = (q, ci, cs, w, mask)
    args_gpu = tuple(t.to(cuda) for t in args_cpu)
    assert torch.equal(int8_scores(*args_gpu).cpu(), int8_scores(*args_cpu))
    k = min(10, n)
    gv, _ = int8_search(*args_gpu, k=k)
    cv, _ = int8_search(*args_cpu, k=k)
    assert torch.equal(gv.cpu(), cv)
    rv, _ = int8_search_device_rerank(*args_gpu, k=k)
    pv, _ = int8_search_device_rerank(*args_cpu, k=k)
    assert torch.allclose(rv.cpu(), pv, atol=TOL, rtol=0)


def _launches():
    return (fused_score.fused_weighted_scores.launches,
            fused_score.streaming_candidates.launches,
            chunk_stream.gather_rescore.launches)


def _sharded_problem(b, n_real, d, seed, dev):
    rng = np.random.default_rng(seed)
    c = torch.randn((n_real, d), generator=torch.Generator().manual_seed(seed))
    c = (c / c.norm(dim=1, keepdim=True)).to(dev)
    w = torch.from_numpy(np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n_real)])
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return (q / q.norm(dim=1, keepdim=True)).to(dev), c, w.to(dev)


# (K1, K2, K5) launches per shard of one search, before any redo
SHARD_LAUNCHES = {"auto": (0, 1, 0), "streaming": (0, 1, 0), "exact": (1, 0, 0),
                  "approx": (1, 0, 0), "fast": (1, 0, 0), "chunkstream": (1, 0, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(SHARD_LAUNCHES))
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("b,k", [(8, 20), (64, 100)])
def test_sharded_search_matches_single_device(cuda, method, n_shards, b, k):
    """Each shard launches its method's kernels once; a redone batch adds
    one K1 scan (chunkstream's counted by the searcher, streaming's by
    ``streaming_topk.redos``, fast's at most one per shard)."""
    from rag_icd10_tpu_torch.parallel import ShardedFlatSearcher, make_mesh

    q, c, w = _sharded_problem(b, 40474, 768, n_shards + b, cuda)
    mesh = make_mesh(axis_names=("shard",), devices=[cuda] * n_shards)
    searcher = ShardedFlatSearcher(c, w, mesh, axis="shard")
    cp = torch.nn.functional.pad(c, (0, 0, 0, searcher.n_padded - c.shape[0]))
    wp = torch.nn.functional.pad(w, (0, searcher.n_padded - c.shape[0]))
    mp = torch.zeros_like(wp)
    mp[c.shape[0]:] = -1e30
    want_v, want_i = fused_search(q, cp, wp, mp, k)
    before = _launches()
    redos = searcher.redos + fused_score.streaming_topk.redos
    got_v, got_i = searcher.search_device(q, k, method=method)
    torch.cuda.synchronize()
    k1, k2, k5 = (a - b0 for a, b0 in zip(_launches(), before))
    redone = searcher.redos + fused_score.streaming_topk.redos - redos
    e1, e2, e5 = (x * n_shards for x in SHARD_LAUNCHES[method])
    assert (k2, k5) == (e2, e5), (method, k2, k5)
    if method == "fast":
        assert e1 <= k1 <= 2 * e1
    else:
        assert k1 == e1 + redone, (method, k1, redone)
    assert int(got_i.max()) < 40474
    _same_up_to_ties(got_v, got_i.long(), want_v, want_i.long(), (method, n_shards))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["exact", "chunkstream"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_int8_equals_int8_search(cuda, method, n_shards):
    from rag_icd10_tpu_torch.parallel import ShardedFlatSearcher, make_mesh

    q, c, w = _sharded_problem(16, 40960, 768, 3, cuda)
    searcher = ShardedFlatSearcher(c, w, make_mesh(axis_names=("shard",),
                                                   devices=[cuda] * n_shards),
                                   axis="shard", store_dtype="int8")
    c8, cs = quantize_rows(c)
    want_v, want_i = int8_search(q, c8, cs, w, torch.zeros_like(w), k=20)
    got_v, got_i = searcher.search_device(q, 20, method=method)
    assert torch.equal(got_v, want_v)
    for a, b in zip(got_i.tolist(), want_i.tolist()):
        assert set(a) == set(b)


@pytest.mark.gpu
@pytest.mark.parametrize("device_dtype", ["float32", "int8"])
def test_sharded_store_on_card_serves_the_unsharded_hits(cuda, device_dtype):
    from rag_icd10_tpu_torch.config import StoreConfig
    from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
    from rag_icd10_tpu_torch.index.vector_store import VectorStore
    from rag_icd10_tpu_torch.parallel import make_mesh

    n, d = 5000, 768
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    records = list(synthetic_corpus(n, seed=5).records())
    stores = {}
    for sharded in ("on", "off"):
        cfg = StoreConfig(sharded=sharded, device_dtype=device_dtype, int8_rerank="host")
        store = VectorStore(dim=d, config=cfg, device=cuda, mesh=make_mesh(
            axis_names=("shard",), devices=[cuda] * 4))
        store.insert_records(records, vecs)
        store.load_collection()
        stores[sharded] = store
    assert stores["on"].get_memory_usage()["sharded"]
    assert not stores["off"].get_memory_usage()["sharded"]
    q = torch.from_numpy(vecs[:8] + 0.05 * rng.standard_normal((8, d)).astype(np.float32))
    q = (q / q.norm(dim=1, keepdim=True)).to(cuda)
    for method in (None, "chunkstream"):
        got = stores["on"].search(q, 20, method=method)
        want = stores["off"].search(q, 20, method=method if device_dtype == "float32" else None)
        for g, e in zip(got, want):
            gv = torch.tensor([h.score for h in g])
            ev = torch.tensor([h.score for h in e])
            assert torch.allclose(gv, ev, atol=TOL, rtol=0), method


@pytest.mark.gpu
def test_nccl_world_size_one_merge_equals_local(cuda):
    import socket

    from rag_icd10_tpu_torch.parallel import ShardedFlatSearcher, make_mesh, multihost

    q, c, w = _sharded_problem(8, 40474, 768, 9, cuda)
    local = ShardedFlatSearcher(c, w, make_mesh(axis_names=("shard",), devices=[cuda] * 4,
                                                distributed=False), axis="shard")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, local_device_count=1, device="cuda",
                         timeout_s=60)
    try:
        mesh = make_mesh(axis_names=("shard",), devices=[cuda] * 4)
        assert mesh.group is not None
        dist_search = ShardedFlatSearcher(c, w, mesh, axis="shard")
        for method in ("auto", "chunkstream"):
            gv, gi = dist_search.search_device(q, 20, method=method)
            lv, li = local.search_device(q, 20, method=method)
            assert torch.equal(gv.cpu(), lv.cpu())
            for a, b in zip(gi.tolist(), li.tolist()):
                assert set(a) == set(b)
        parts = multihost.global_device_put(torch.arange(64.0, device=cuda), mesh, "shard")
        assert multihost.global_sum(parts, mesh) == 2016.0
    finally:
        multihost.shutdown()
