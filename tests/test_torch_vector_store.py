"""Vector-store parity: the port's VectorStore (device="cpu", so the
scoring kernel's plain version) against the JAX package's VectorStore on
the same synthetic corpus and vectors.

Hits must name the same codes up to ties, with scores within 1e-5 (IEEE
fp32 on both sides; sums over D=128 in different orders). A store saved
by either package must load in the other. ``sharded="on"`` over the
CPU's one device serves unsharded, as the JAX store does on one chip
(tests/test_torch_parallel.py covers the sharded store).

Every search method and residency is served: "fast"/"chunk" (certified,
exact), "sketch" and "hnsw" (the same basis and graph as the JAX store's,
so the same selection; exact scores), int8 residency with both
``INT8_RERANK`` values and host residency; each gives the JAX store's
hits at the same tolerance.

The certified methods ("streaming", "chunkstream") must give the exact
method's hits: off the TPU the JAX store serves "streaming" by its exact
scan and "chunkstream" by its XLA engines, so the JAX side is exact too.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import StoreConfig as JStoreConfig
from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic
from rag_icd10_tpu.index.vector_store import VectorStore as JStore
from rag_icd10_tpu_torch.config import StoreConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.index.vector_store import CHUNKSTREAM_SCANS, VectorStore
from rag_icd10_tpu_torch.ops.fused_score import range_rows, slot_count

torch.set_num_threads(2)  # the suite runs several test processes at once

DIM = 128
N = 600


def _vectors(n, seed, dim=DIM):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, dim)).astype(np.float32)
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


@pytest.mark.parametrize("method", ["exact", "approx", "streaming", "chunkstream"])
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


@pytest.mark.parametrize("method", ["fast", "sketch", "hnsw"])
def test_unported_methods_raise(stores, method):
    """These methods raised "not yet ported" until the port's third slice;
    now they are served and give the JAX store's hits."""
    jstore, tstore = stores
    q = _vectors(6, 21)
    for top_k in (1, 5):
        _assert_same_hits(
            tstore.search(q, top_k, method=method), jstore.search(q, top_k, method=method)
        )


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
    """int8 and host residency and the HNSW index type, which raised until
    the port's third slice, and ``sharded="on"``, which raised until its
    fifth, are served and give the JAX store's hits (``on`` over the CPU's
    one device unsharded)."""
    store = VectorStore(dim=DIM, config=config, device="cpu")
    store.insert_records(list(synthetic_corpus(20).records()), _vectors(20, 1))
    if config.sharded == "on":
        store.load_collection()
        assert store._sharded is None and not store.get_memory_usage()["sharded"]
    jstore = JStore(dim=DIM, config=JStoreConfig(
        device_dtype=config.device_dtype, index_type=config.index_type))
    jstore.insert_records(list(jsynthetic(20).records()), _vectors(20, 1))
    q = _vectors(3, 0)
    _assert_same_hits(store.search(q, 5), jstore.search(q, 5))


N_T, DIM_T = 3000, 64  # 24 chunks of 128 rows: "fast" selects among them

TIERS = {
    "fast": ({}, "fast"),
    "chunk": ({}, "chunk"),
    "fast-over-bf16": ({"device_dtype": "bfloat16"}, "fast"),
    "sketch": ({}, "sketch"),
    "hnsw": ({}, "hnsw"),
    "hnsw-index": ({"index_type": "HNSW"}, None),
    "int8-device": ({"device_dtype": "int8", "int8_rerank": "device"}, None),
    "int8-device-approx": ({"device_dtype": "int8", "int8_rerank": "device"}, "approx"),
    "int8-host": ({"device_dtype": "int8", "int8_rerank": "host"}, None),
    "host": ({"device_dtype": "host"}, None),
    "host-hnsw": ({"device_dtype": "host"}, "hnsw"),
}


@pytest.fixture(scope="module")
def tier_data():
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((40, DIM_T)).astype(np.float32)
    vecs = centers[rng.integers(0, 40, N_T)] + 0.4 * rng.standard_normal(
        (N_T, DIM_T)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    q = vecs[rng.integers(0, N_T, 7)] + 0.05 * rng.standard_normal((7, DIM_T)).astype(np.float32)
    return vecs, q


@pytest.mark.parametrize("tier", list(TIERS))
def test_every_method_and_residency_matches_jax_store(tier_data, tier):
    """Each method and residency of the third slice through both stores
    on the same clustered rows: the JAX store's hits (codes up to ties,
    scores within 1e-5), and, where the tier scores in exact fp32 (all but
    bf16 residency and the int8 device re-rank), the exact scores of its
    rows; the memory accounting agrees."""
    vecs, q = tier_data
    cfg, method = TIERS[tier]
    jstore = JStore(dim=DIM_T, config=JStoreConfig(pad_multiple=128, **cfg))
    jstore.insert_records(list(jsynthetic(N_T, seed=4).records()), vecs)
    tstore = VectorStore(dim=DIM_T, config=StoreConfig(pad_multiple=128, **cfg), device="cpu")
    tstore.insert_records(list(synthetic_corpus(N_T, seed=4).records()), vecs)
    for top_k in (5, 20):
        got = tstore.search(q, top_k, method=method)
        _assert_same_hits(got, jstore.search(q, top_k, method=method))
        if cfg.get("device_dtype") != "bfloat16" and cfg.get("int8_rerank") != "device":
            w = tstore.corpus.level_weights(tstore.config.level_weights)
            for row, qi in zip(got, q):
                for h in row:
                    assert abs(h.score - float(vecs[h.id] @ qi) * w[h.id]) <= 1e-5
    tm, jm = tstore.get_memory_usage(), jstore.get_memory_usage()
    assert tm["device_vector_bytes"] == jm["device_vector_bytes"]
    cert = tstore.get_collection_stats()["certificate"]
    if method in ("fast", "chunk") and not cfg:
        assert cert["queries"] == 14 and cert["certified"] == 14 and cert["redos"] == 0


def test_host_tier_refuses_exact_methods():
    store = VectorStore(dim=DIM, config=StoreConfig(device_dtype="host"), device="cpu")
    store.insert_records(list(synthetic_corpus(40).records()), _vectors(40, 1))
    for method in ("exact", "fast", "streaming", "chunkstream"):
        with pytest.raises(ValueError, match="host tier"):
            store.search(_vectors(2, 0), 5, method=method)
    assert len(store.search(_vectors(2, 0), 5)[0]) == 5  # its default: the sketch
    assert store._sketch is not None and store._dev is None
    store.release_collection()
    assert store._sketch is None


def test_int8_residency_refuses_chunkstream_and_unknown():
    store = VectorStore(dim=DIM, config=StoreConfig(device_dtype="int8"), device="cpu")
    store.insert_records(list(synthetic_corpus(40).records()), _vectors(40, 1))
    with pytest.raises(ValueError, match="fp32 device residency"):
        store.search(_vectors(2, 0), 5, method="chunkstream")
    with pytest.raises(ValueError, match="unknown search method"):
        store.search(_vectors(2, 0), 5, method="bogus")
    bad = VectorStore(dim=DIM, config=StoreConfig(device_dtype="float16"), device="cpu")
    bad.insert_records(list(synthetic_corpus(40).records()), _vectors(40, 1))
    with pytest.raises(ValueError, match="STORE_DEVICE_DTYPE"):
        bad.search(_vectors(1, 0), 5)


def test_fast_uncertified_batch_redone_in_finalize():
    """Near-ties across more chunks than "fast" fetches de-certify (its 2
    eps margin); finalize() redoes the batch on the exact path and counts
    it."""
    n, k = 6000, 5
    vecs = _vectors(n, 2, DIM_CS)
    store = VectorStore(dim=DIM_CS, config=StoreConfig(pad_multiple=128), device="cpu")
    store.insert_records(list(synthetic_corpus(n, seed=2).records()), vecs)
    target = vecs[0].copy()
    w = store.corpus.level_weights(store.config.level_weights)
    for i in range(46):  # a near-tie in each of 46 chunks; fast fetches 35
        row = 128 * i + 5
        store._vectors[row] = target * (2.0 - 1e-7 * i) / w[row]
    q = target[None, :]
    exact = store.search(q, k, method="exact")
    got = store.search(q, k, method="fast")
    cert = store.get_collection_stats()["certificate"]
    assert cert == {"queries": 1, "certified": 0, "redos": 1}
    _assert_same_hits(got, exact)


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


# ----------------------------------------------- certified methods, served

N_CS, DIM_CS = 4000, 64  # 32 chunks of 128 rows: mc = 21 < 32 at top_k 5


def _cs_stores(scan="pallas", n=N_CS, seed=2):
    vecs = _vectors(n, seed, DIM_CS)
    jstore = JStore(dim=DIM_CS, config=JStoreConfig(pad_multiple=128, chunkstream_scan=scan))
    jstore.insert_records(list(jsynthetic(n, seed=seed).records()), vecs)
    tstore = VectorStore(
        dim=DIM_CS, config=StoreConfig(pad_multiple=128, chunkstream_scan=scan), device="cpu"
    )
    tstore.insert_records(list(synthetic_corpus(n, seed=seed).records()), vecs)
    return jstore, tstore, vecs


@pytest.mark.parametrize("scan", list(CHUNKSTREAM_SCANS))
def test_chunkstream_scan_knob_matches_jax_and_exact(scan):
    """Every CHUNKSTREAM_SCAN value serves the exact top-k, as
    tests/test_chunkstream_served.py pins for the JAX store, and keeps its
    stored scan dtype on the CPU."""
    jstore, tstore, vecs = _cs_stores(scan)
    q = vecs[10:14] + 0.01
    got = tstore.search(q, 5, method="chunkstream")
    _assert_same_hits(got, jstore.search(q, 5, method="chunkstream"))
    exact = tstore.search(q, 5, method="exact")
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in exact]
    _, dtype = CHUNKSTREAM_SCANS[scan]
    assert tstore._chunkstore.scan_dtype == jstore._chunkstore.scan_dtype == dtype
    assert (tstore._chunkstore.resid_max > 0.0) == (dtype != "fp32")
    stats = tstore.get_collection_stats()["certificate"]
    assert stats["queries"] == 4 and stats["certified"] == 4 and stats["redos"] == 0


def test_streaming_matches_jax_and_exact():
    jstore, tstore, vecs = _cs_stores()
    q = vecs[20:28] + 0.01
    for top_k in (5, 20):
        got = tstore.search(q, top_k, method="streaming")
        _assert_same_hits(got, jstore.search(q, top_k, method="streaming"))
        _assert_same_hits(got, tstore.search(q, top_k, method="exact"))


def test_chunkstream_requires_fp32_residency():
    store = VectorStore(dim=DIM, config=StoreConfig(device_dtype="bfloat16"), device="cpu")
    store.insert_records(list(synthetic_corpus(40).records()), _vectors(40, 1))
    with pytest.raises(ValueError, match="fp32 device residency"):
        store.search(_vectors(2, 0), 5, method="chunkstream")
    assert len(store.search(_vectors(2, 0), 5, method="streaming")[0]) == 5
    bad = VectorStore(dim=DIM, config=StoreConfig(chunkstream_scan="bogus"), device="cpu")
    bad.insert_records(list(synthetic_corpus(40).records()), _vectors(40, 1))
    with pytest.raises(ValueError, match="CHUNKSTREAM_SCAN"):
        bad.search(_vectors(2, 0), 5, method="chunkstream")


def test_chunkstore_rebuilt_after_append_and_release():
    _, tstore, vecs = _cs_stores("pallas_int8", n=1000)
    tstore.search(vecs[:2], 5, method="chunkstream")
    built = tstore._chunkstore
    assert built is not None and built.n_real == 1000
    usage = tstore.get_memory_usage()["chunkstore_device_bytes"]
    assert usage >= built.folded.numel() + built.scales.numel() * 4
    new = _vectors(300, 9, DIM_CS)
    records = list(synthetic_corpus(1300, seed=2).records())[1000:]
    tstore.insert_records(records, new)
    assert tstore._chunkstore is None  # covered only the old rows
    hits = tstore.search(new[:3], 1, method="chunkstream")
    assert [r[0].id for r in hits] == [1000, 1001, 1002]
    assert tstore._chunkstore.n_real == 1300
    tstore.release_collection()
    assert tstore._chunkstore is None
    assert tstore.get_memory_usage()["chunkstore_device_bytes"] == 0


@pytest.mark.parametrize("method", ["streaming", "chunkstream"])
def test_uncertified_batch_redone_in_finalize(method):
    """8 of the top-16 in adjacent rows of one streaming range (weighted
    scores 10 .. 3), and the other 8 among 40 near-ties scoring 2.0 -
    2e-6 i, one in each of 40 chunks. Streaming keeps each range's top-16,
    so the cluster certifies with no redo. Chunkstream fetches 32 chunks,
    fewer than the 40, so its bound (the 32nd chunk max + eps, eps >=
    1e-4 > 24 * 2e-6) exceeds the 16th value: it de-certifies and
    finalize redoes the batch on the exact path. Both give the exact
    hits."""
    n, k = 6000, 16
    _, tstore, vecs = _cs_stores(n=n)
    target = vecs[0].copy()
    w = tstore.corpus.level_weights(tstore.config.level_weights)
    tstore.load_collection()
    n_dev = tstore._dev["corpus"].shape[0]
    assert range_rows(n_dev, slot_count(1, n_dev, k)) >= 28  # rows 20..27 share range 0
    for rank in range(8):
        row = 20 + rank
        tstore._vectors[row] = target * (10.0 - rank) / w[row]
    for i in range(40):  # one near-tie in each of 40 chunks
        row = 128 * i + 5
        tstore._vectors[row] = target * (2.0 - 2e-6 * i) / w[row]
    tstore.release_collection()
    q = target[None, :]
    exact = tstore.search(q, k, method="exact")
    before = dict(tstore.get_collection_stats()["certificate"])
    got = tstore.search(q, k, method=method)
    after = tstore.get_collection_stats()["certificate"]
    redone = method == "chunkstream"
    assert after["redos"] == before["redos"] + redone
    assert after["certified"] == before["certified"] + (not redone)
    _assert_same_hits(got, exact)
