"""Vector-store parity: the port's VectorStore (device="cpu", so the
scoring kernel's plain version) against the JAX package's VectorStore on
the same synthetic corpus and vectors.

Hits must name the same codes up to ties, with scores within 1e-5 (IEEE
fp32 on both sides; sums over D=128 in different orders). A store saved
by either package must load in the other. Methods the port does not
serve yet must raise instead of silently serving another method.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import StoreConfig as JStoreConfig
from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic
from rag_icd10_tpu.index.vector_store import VectorStore as JStore
from rag_icd10_tpu_torch.config import StoreConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.index.vector_store import VectorStore

DIM = 128
N = 600


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def stores():
    vecs = _vectors(N, 0)
    jstore = JStore(dim=DIM, config=JStoreConfig())
    jstore.insert_records(list(jsynthetic(N).records()), vecs)
    tstore = VectorStore(dim=DIM, config=StoreConfig(), device="cpu")
    tstore.insert_records(list(synthetic_corpus(N).records()), vecs)
    return jstore, tstore


def _assert_same_hits(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        np.testing.assert_allclose(
            [h.score for h in g_row], [h.score for h in w_row], atol=1e-5
        )
        np.testing.assert_allclose(
            [h.original_score for h in g_row],
            [h.original_score for h in w_row], atol=1e-5,
        )
        g_codes = {h.code for h in g_row}
        w_codes = {h.code for h in w_row}
        kth = w_row[-1].score
        for h in g_row + w_row:
            if h.code in g_codes ^ w_codes:  # differs only on a tie at the k-th
                assert abs(h.score - kth) <= 1e-5, h.code


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("top_k", [1, 5, 50])
def test_search_matches_jax_store(stores, method, top_k):
    jstore, tstore = stores
    q = _vectors(12, top_k)
    want = jstore.search(q, top_k=top_k, method=method)
    got = tstore.search(q, top_k=top_k, method=method)
    _assert_same_hits(got, want)
    # a torch tensor takes the device chain and gives the same hits
    got_t = tstore.search_dispatch(torch.from_numpy(q), top_k, method=method)
    _assert_same_hits(got_t.finalize(), want)


def test_bf16_residency_close_to_jax(stores):
    vecs = _vectors(N, 0)
    jstore = JStore(dim=DIM, config=JStoreConfig(device_dtype="bfloat16"))
    jstore.insert_records(list(jsynthetic(N).records()), vecs)
    tstore = VectorStore(
        dim=DIM, config=StoreConfig(device_dtype="bfloat16"), device="cpu"
    )
    tstore.insert_records(list(synthetic_corpus(N).records()), vecs)
    q = _vectors(4, 9)
    for g_row, w_row in zip(tstore.search(q, 10), jstore.search(q, 10)):
        np.testing.assert_allclose(
            [h.score for h in g_row], [h.score for h in w_row], atol=2e-2
        )
    assert tstore.get_memory_usage()["device_vector_bytes"] == N * DIM * 2


def test_exact_title_and_semantic_similarities(stores):
    jstore, tstore = stores
    title = tstore.corpus.titles[7]
    q = _vectors(1, 3)[0]
    got = [h.to_dict() for h in tstore.exact_title_hits(title, q)]
    want = [h.to_dict() for h in jstore.exact_title_hits(title, q)]
    assert got == want and got
    ids = np.array([[0, 5, 9], [1, 2, 3]])
    qs = _vectors(2, 4)
    np.testing.assert_array_equal(
        tstore.semantic_similarities(qs, ids), jstore.semantic_similarities(qs, ids)
    )


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_saved_by_one_package_loads_in_the_other(stores, tmp_path, writer):
    jstore, tstore = stores
    base = str(tmp_path / "store")
    (jstore if writer == "jax" else tstore).save(base)
    reader = (
        VectorStore.load(base, config=StoreConfig(), device="cpu")
        if writer == "jax"
        else JStore.load(base, config=JStoreConfig())
    )
    original = tstore if writer == "jax" else jstore
    assert reader.num_entities == N and reader.dim == DIM
    np.testing.assert_array_equal(reader._vectors, original._vectors)
    assert reader.corpus.codes == original.corpus.codes
    assert reader.corpus.titles == original.corpus.titles
    q = _vectors(3, 11)
    _assert_same_hits(reader.search(q, 5), original.search(q, 5))


@pytest.mark.parametrize(
    "method", ["fast", "streaming", "chunkstream", "sketch", "hnsw"]
)
def test_unported_methods_raise(stores, method):
    _, tstore = stores
    with pytest.raises(ValueError, match="not yet ported"):
        tstore.search(_vectors(1, 0), 5, method=method)


@pytest.mark.parametrize(
    "config",
    [
        StoreConfig(device_dtype="int8"),
        StoreConfig(device_dtype="host"),
        StoreConfig(sharded="on"),
        StoreConfig(index_type="HNSW"),
    ],
    ids=["int8", "host", "sharded", "hnsw-index"],
)
def test_unported_residency_raises(config):
    store = VectorStore(dim=DIM, config=config, device="cpu")
    store.insert_records(list(synthetic_corpus(20).records()), _vectors(20, 1))
    with pytest.raises(ValueError, match="not yet ported"):
        store.search(_vectors(1, 0), 5)


def test_lifecycle_and_stats(stores):
    _, tstore = stores
    assert tstore.health_check()["status"] == "healthy"
    assert tstore.test_connection()
    stats = tstore.get_collection_stats()
    assert stats["num_entities"] == N and stats["loaded"]
    assert tstore.get_memory_usage()["device_vector_bytes"] == N * DIM * 4
    tstore.release_collection()
    assert not tstore.is_loaded
    assert len(tstore.search(_vectors(2, 0), 3)) == 2  # reloads on demand
    assert tstore.is_loaded
    empty = VectorStore(dim=DIM, device="cpu")
    assert empty.search(_vectors(2, 0), 3) == [[], []]


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorStore(dim=DIM)
