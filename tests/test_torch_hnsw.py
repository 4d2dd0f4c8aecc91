"""The HNSW graph: the port's ctypes wrapper (index/hnsw_index.py) and the
store's graph path against the JAX package's, on the CPU.

Both wrappers bind the same source, native/hnsw/hnsw.cpp, built with the
same flags (native/hnsw/Makefile's); the port builds it into its own
build directory. A serial build (fewer than 2048 rows) from the same seed
is deterministic, so the two graphs answer with the same ids, and with
IPs within 1e-6 (the same code; only the build's binary differs). The
store's weighted over-fetch and bf16 re-rank follow the JAX store: the
same hits, scores within 1e-5. The graph file round-trips through either
package's ``save``/``load``.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import HNSWConfig as JHNSWConfig
from rag_icd10_tpu.config import StoreConfig as JStoreConfig
from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic
from rag_icd10_tpu.index.hnsw_index import HNSWIndex as JHNSWIndex
from rag_icd10_tpu.index.vector_store import VectorStore as JStore
from rag_icd10_tpu_torch.config import HNSWConfig, StoreConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.index import hnsw_index
from rag_icd10_tpu_torch.index.hnsw_index import HNSWIndex
from rag_icd10_tpu_torch.index.vector_store import VectorStore

torch.set_num_threads(2)  # the suite runs several test processes at once


def clustered(n, d, n_centers=50, seed=0, spread=0.3):
    """tests/test_hnsw.py's geometry."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).standard_normal((n_centers, d)).astype(np.float32)
    v = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal(
        (n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _hits_equal(got, want, tol=1e-5):
    for g, w in zip(got, want):
        assert [h.id for h in g] == [h.id for h in w]
        np.testing.assert_allclose([h.score for h in g], [h.score for h in w], atol=tol)
        np.testing.assert_allclose(
            [h.original_score for h in g], [h.original_score for h in w], atol=tol)


def test_library_built_in_the_ports_build_directory():
    hnsw_index.load_library()
    path = hnsw_index.library_path()
    assert path.exists() and path.parent == hnsw_index.BUILD_DIR
    assert path.parent.name == "torch_kernels" and "native" not in path.parts
    # the name follows the source and the flags: a new source rebuilds
    assert path.name.startswith("libhnsw-") and path.suffix == ".so"


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
def test_graph_matches_jax_graph(vec_dtype):
    vecs = clustered(1500, 64)
    q = clustered(20, 64, seed=7)
    got, want = HNSWIndex(64, M=16, ef_construction=100, vec_dtype=vec_dtype), JHNSWIndex(
        64, M=16, ef_construction=100, vec_dtype=vec_dtype)
    got.add(vecs)
    want.add(vecs)
    assert len(got) == len(want) == 1500 and got.vec_dtype == vec_dtype
    gi, gids = got.search(q, 10, ef_search=64)
    wi, wids = want.search(q, 10, ef_search=64)
    np.testing.assert_array_equal(gids, wids)
    np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6)
    exact = np.argsort(-(q @ vecs.T), axis=1)[:, :10]
    recall = np.mean([len(set(gids[i]) & set(exact[i])) / 10 for i in range(20)])
    assert recall >= 0.95


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_graph_file_loads_in_the_other_package(tmp_path, writer):
    vecs = clustered(800, 32, seed=3)
    cls, other = (JHNSWIndex, HNSWIndex) if writer == "jax" else (HNSWIndex, JHNSWIndex)
    idx = cls(32, M=8, ef_construction=64)
    idx.add(vecs)
    path = str(tmp_path / "g.hnsw")
    idx.save(path)
    back = other.load(path)
    assert len(back) == 800 and back.dim == 32
    a = idx.search(vecs[:5], 5, ef_search=32)
    b = back.search(vecs[:5], 5, ef_search=32)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_corrupt_file_fails_cleanly(tmp_path):
    bad = tmp_path / "bad.hnsw"
    bad.write_bytes(b"not a graph")
    with pytest.raises(IOError, match="hnsw_load failed"):
        HNSWIndex.load(str(bad))


def _stores(n=1200, d=64, seed=5, vec_dtype="bfloat16", **cfg):
    vecs = clustered(n, d, seed=seed)
    jstore = JStore(dim=d, config=JStoreConfig(pad_multiple=128, **cfg),
                    hnsw_config=JHNSWConfig(vec_dtype=vec_dtype))
    jstore.insert_records(list(jsynthetic(n, seed=seed).records()), vecs)
    tstore = VectorStore(dim=d, config=StoreConfig(pad_multiple=128, **cfg),
                         hnsw_config=HNSWConfig(vec_dtype=vec_dtype), device="cpu")
    tstore.insert_records(list(synthetic_corpus(n, seed=seed).records()), vecs)
    return jstore, tstore, vecs


@pytest.mark.parametrize("vec_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["method", "index_type"])
def test_store_graph_path_matches_jax(vec_dtype, route):
    """``method="hnsw"`` on a flat store and ``INDEX_TYPE=HNSW``: the
    weighted over-fetch (and, on a bf16 graph, the exact re-rank) give the
    JAX store's hits."""
    cfg = {"index_type": "HNSW"} if route == "index_type" else {}
    jstore, tstore, vecs = _stores(vec_dtype=vec_dtype, **cfg)
    q = vecs[:6] + 0.02
    method = "hnsw" if route == "method" else None
    for top_k in (1, 5, 20):
        _hits_equal(tstore.search(q, top_k, method=method),
                    jstore.search(q, top_k, method=method))
    # a served score is exact for its row: raw IP x level weight
    w = tstore.corpus.level_weights(tstore.config.level_weights)
    for row, qi in zip(tstore.search(q, 5, method=method), q):
        for h in row:
            assert abs(h.score - float(vecs[h.id] @ qi) * w[h.id]) <= 1e-5
    assert not tstore.is_loaded or route == "method"  # the graph needs no residency


def test_per_request_ef_search_and_memory_stats():
    _, tstore, vecs = _stores(n=600)
    a = tstore.search(vecs[:3], 5, method="hnsw", ef_search=16)
    b = tstore.search(vecs[:3], 5, method="hnsw", ef_search=128)
    assert all(len(r) == 5 for r in a + b)
    assert tstore._hnsw is not None and len(tstore._hnsw) == 600
    assert tstore._hnsw.memory_bytes() > 0


def test_graph_persists_with_the_store(tmp_path):
    """save() writes <path>.hnsw; load() reads it back without a rebuild,
    and the JAX store loads the same files."""
    jstore, tstore, vecs = _stores(index_type="HNSW")
    before = tstore.search(vecs[:3], 5)  # builds the graph lazily
    base = str(tmp_path / "s")
    tstore.save(base)
    assert (tmp_path / "s.hnsw").exists()
    back = VectorStore.load(base, config=StoreConfig(pad_multiple=128, index_type="HNSW"),
                            device="cpu")
    assert back._hnsw is not None and len(back._hnsw) == 1200
    graph = back._hnsw
    _hits_equal(back.search(vecs[:3], 5), before)
    assert back._hnsw is graph  # served from the loaded graph, not rebuilt
    jback = JStore.load(base, config=JStoreConfig(pad_multiple=128, index_type="HNSW"))
    assert jback._hnsw is not None
    _hits_equal(jback.search(vecs[:3], 5), before)


def test_corrupt_graph_file_is_rebuilt_on_demand(tmp_path):
    _, tstore, vecs = _stores(n=400)
    base = str(tmp_path / "s")
    tstore.save(base)
    (tmp_path / "s.hnsw").write_bytes(b"garbage")
    back = VectorStore.load(base, config=StoreConfig(pad_multiple=128), device="cpu")
    assert back._hnsw is None
    assert len(back.search(vecs[:2], 5, method="hnsw")[0]) == 5
    assert back._hnsw is not None


def test_append_drops_the_stale_graph():
    _, tstore, vecs = _stores(n=500)
    tstore.search(vecs[:1], 5, method="hnsw")
    extra = clustered(3, 64, seed=11)
    tstore.insert_records(list(synthetic_corpus(503, seed=5).records())[500:], extra)
    assert tstore._hnsw is None
    hits = {h.id: h for h in tstore.search(extra[:1], 5, method="hnsw")[0]}
    assert 500 in hits and abs(hits[500].original_score - 1.0) <= 1e-5
