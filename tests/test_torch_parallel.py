"""Corpus-sharded search: the port's parallel/ package and sharded
VectorStore against the JAX package's on the conftest's 8-device CPU mesh.

The port runs the same numpy inputs over logical CPU shards (one CPU
named once per shard), so each shard runs its kernels' plain versions
(K1, K2, K5 on the card). Tolerances:

- fp32 methods (exact, fast, streaming, auto, chunkstream): values within
  1e-5 of the JAX searcher's (IEEE fp32 on both sides, sums of D products
  in different orders), the same id sets up to ties at the k-th value.
- approx: JAX's ``approx_max_k`` and the port's exact selection, recall
  >= 0.9 against the exact top-k (the port's is 1.0).
- int8 exact/chunkstream: the JAX searcher reproduces the single-device
  int8 law exactly, and so does the port, with the one-step allowance of
  tests/test_torch_quantized.py: the JAX package spells the query scale
  ``q_absmax / 127.0`` inside ``jit``, where XLA may multiply by the
  reciprocal, so a query's scale may sit one ulp away and an int8 value
  one step away. Queries quantized alike give values within 1e-5; the
  others within 2e-3 (127 * q_scale * c_scale * w), with ids equal up to
  near-ties inside that allowance.
- F3: ``STORE_SHARDED=on`` with a one-shard mesh serves the ``off`` hits
  from one device (it raised before the port's fifth slice), and
  ``auto`` never shards on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import StoreConfig as JStoreConfig
from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic
from rag_icd10_tpu.index.vector_store import VectorStore as JStore
from rag_icd10_tpu.parallel.mesh import make_mesh as jmake_mesh
from rag_icd10_tpu.parallel.search import ShardedFlatSearcher as JSearcher
from rag_icd10_tpu_torch.config import StoreConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.ops import quantized as tq
from rag_icd10_tpu_torch.parallel import Mesh, ShardedFlatSearcher, make_mesh
from rag_icd10_tpu_torch.parallel.multihost import global_device_put, global_sum

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL = 1e-5
NEAR_TIE = 2e-3
FP32_METHODS = ("exact", "fast", "streaming", "auto", "chunkstream")


def _problem(n, d, b, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    w = np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n)]
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return c, w, q


def _tmesh(n):
    return make_mesh(n_devices=n, dp=n, tp=1, devices=["cpu"] * n)


def _jmesh(n):
    return jmake_mesh(n_devices=n, dp=n, tp=1)


def _same_up_to_ties(got_v, got_i, want_v, want_i, tol=TOL, what=""):
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=tol, err_msg=what)
    for row in range(want_v.shape[0]):
        g = dict(zip(got_i[row].tolist(), got_v[row].tolist()))
        w = dict(zip(want_i[row].tolist(), want_v[row].tolist()))
        for j in g.keys() ^ w.keys():  # differs only at a tie with the k-th
            assert abs(g.get(j, w.get(j)) - want_v[row, -1]) <= tol, (what, row, j)


_SEARCHERS = {}


def _searchers(n_shards, d, n=1536, store_dtype="fp32", seed=2):
    """(port searcher, JAX searcher, queries, corpus, weights), cached so
    the JAX programs compile once per shape."""
    key = (n_shards, d, n, store_dtype, seed)
    if key not in _SEARCHERS:
        c, w, q = _problem(n, d, 4, seed)
        _SEARCHERS[key] = (
            ShardedFlatSearcher(c, w, _tmesh(n_shards), axis="dp", store_dtype=store_dtype),
            JSearcher(c, w, _jmesh(n_shards), axis="dp", store_dtype=store_dtype),
            q, c, w,
        )
    return _SEARCHERS[key]


# ------------------------------------------------------------------ mesh


def test_make_mesh_shapes_and_logical_shards():
    mesh = make_mesh(n_devices=8, dp=2, tp=4, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "tp": 4} == dict(jmake_mesh(8, dp=2, tp=4).shape)
    assert mesh.group is None and mesh.rank == 0 and (mesh.ranks == 0).all()
    # shards along dp sit at index 0 of tp
    assert [dev.type for _, dev in mesh.axis_devices("dp")] == ["cpu", "cpu"]
    flat = make_mesh(axis_names=("shard",), devices=["cpu"] * 3)
    assert flat.shape == {"shard": 3} and isinstance(flat, Mesh)
    with pytest.raises(ValueError, match="dp=3 x tp=2"):
        make_mesh(dp=3, tp=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="n_devices=9"):
        make_mesh(n_devices=9, devices=["cpu"] * 8)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
def test_make_mesh_default_split_matches_jax(n):
    """tp = min(8, n) halved until it divides n, dp = n // tp: the JAX
    package's rule (checked on the numbers, the JAX mesh holds 8)."""
    tp = min(8, n)
    while n % tp:
        tp //= 2
    assert make_mesh(devices=["cpu"] * n).shape == {"dp": n // tp, "tp": tp}
    if n <= 8:
        assert make_mesh(devices=["cpu"] * n).shape == dict(jmake_mesh(n).shape)


def test_make_mesh_default_needs_a_card():
    """The default devices are the local CUDA cards: without one it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_global_device_put_and_sum_in_one_process():
    mesh = _tmesh(8)
    parts = global_device_put(np.arange(64, dtype=np.float32), mesh, "dp")
    assert [tuple(p.shape) for p in parts] == [(8,)] * 8
    assert global_sum(parts, mesh) == 2016.0  # sum(arange(64))
    with pytest.raises(ValueError, match="do not split"):
        global_device_put(np.zeros(10, np.float32), mesh, "dp")


# --------------------------------------------------------------- searcher


@pytest.mark.parametrize("method", FP32_METHODS)
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_fp32_methods_match_jax_searcher(method, n_shards):
    ts, js, q, c, w = _searchers(n_shards, 64)
    k = 10
    tv, ti = ts.search(q, k, method=method)
    jv, ji = js.search(q, k, method=method)
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and tv.shape == (4, k)
    _same_up_to_ties(tv, ti, jv, ji, what=method)
    # and against numpy's exact weighted top-k
    e = (q @ c.T) * w
    eidx = np.argsort(-e, axis=1)[:, :k]
    _same_up_to_ties(tv, ti, np.take_along_axis(e, eidx, 1), eidx, what=method)


@pytest.mark.parametrize("method", ["exact", "auto", "chunkstream", "fast"])
def test_fp32_methods_match_jax_searcher_at_d768(method):
    ts, js, q, _, _ = _searchers(8, 768, n=2048, seed=7)
    tv, ti = ts.search(q, 20, method=method)
    jv, ji = js.search(q, 20, method=method)
    _same_up_to_ties(tv, ti, jv, ji, what=method)


@pytest.mark.parametrize("k", [1, 129])
def test_k_edges_match_jax_searcher(k):
    """k = 1, and k above STREAMING_K_MAX (auto takes K1's scan)."""
    ts, js, q, _, _ = _searchers(8, 64)
    for method in ("auto", "exact"):
        tv, ti = ts.search(q, k, method=method)
        jv, ji = js.search(q, k, method=method)
        _same_up_to_ties(tv, ti, jv, ji, what=f"{method} k={k}")


def test_k_above_shard_rows_is_exact():
    """k above a shard's rows: each shard keeps all of its rows and the
    merge is the exact top-k (the JAX searcher's ``lax.top_k`` refuses a
    k above the shard's rows)."""
    ts, js, q, c, w = _searchers(8, 64)  # 1536 rows: 8 shards of 256 rows
    with pytest.raises(ValueError, match="no larger than"):
        js.search(q, 300, method="exact")
    e = (q @ c.T) * w
    eidx = np.argsort(-e, axis=1)[:, :300]
    for method in ("auto", "exact", "chunkstream", "fast"):
        tv, ti = ts.search(q, 300, method=method)
        _same_up_to_ties(tv, ti, np.take_along_axis(e, eidx, 1), eidx, what=method)
    with pytest.raises(ValueError, match="k=3000"):
        ts.search(q, 3000)  # beyond the 2048 padded rows


def test_approx_recall():
    ts, _, q, c, w = _searchers(8, 64)
    k = 10
    _, ti = ts.search(q, k, method="approx")
    eidx = np.argsort(-(q @ c.T) * w, axis=1)[:, :k]
    for row_i, row_e in zip(ti, eidx):
        assert len(set(row_i) & set(row_e)) >= int(0.9 * k)


@pytest.mark.parametrize("store_dtype", ["fp32", "int8"])
def test_padding_not_returned(store_dtype):
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((777, 64)).astype(np.float32)
    weights = np.ones(777, dtype=np.float32)
    ts = ShardedFlatSearcher(corpus, weights, _tmesh(8), axis="dp", store_dtype=store_dtype)
    assert ts.n_padded == 1024 and ts.shard_rows == 128
    q = rng.standard_normal((2, 64)).astype(np.float32)
    for method in (("exact", "chunkstream") if store_dtype == "int8"
                   else ("exact", "auto", "fast", "chunkstream", "approx")):
        _, idx = ts.search(q, 20, method=method)
        assert idx.max() < 777, method


@pytest.mark.parametrize("store_dtype,method", [("fp32", "hnsw"), ("fp32", "sketch"),
                                                ("int8", "fast"), ("int8", "streaming")])
def test_unsupported_methods_raise_the_jax_message(store_dtype, method):
    ts, js, q, _, _ = _searchers(8, 64, store_dtype=store_dtype)
    with pytest.raises(ValueError) as want:
        js.search(q, 5, method=method)
    with pytest.raises(ValueError) as got:
        ts.search(q, 5, method=method)
    assert str(got.value) == str(want.value)


def test_chunkstream_redoes_an_uncertified_batch_exactly():
    """Near-duplicate rows put the k-th value within the certificate's
    epsilon of the mc-th chunk maximum: each shard's batch fails its
    certificate, redoes its exact scan (counted) and the merge is exact."""
    rng = np.random.default_rng(11)
    n, d, k = 8192, 64, 10  # 2 shards of 32 chunks: mc = 26 < 32
    base = rng.standard_normal(d).astype(np.float32)
    c = base + 1e-6 * rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    w = np.ones(n, np.float32)
    q = (base + 0.1 * rng.standard_normal((3, d))).astype(np.float32)
    ts = ShardedFlatSearcher(c, w, _tmesh(2), axis="dp")
    tv, ti = ts.search(q, k, method="chunkstream")
    assert ts.redos == 2
    e = (q @ c.T) * w
    eidx = np.argsort(-e, axis=1)[:, :k]
    np.testing.assert_allclose(tv, np.take_along_axis(e, eidx, 1), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.take_along_axis(e, ti, 1), tv, rtol=0, atol=TOL)
    # a well separated batch certifies and redoes nothing
    ts2, _, q2, _, _ = _searchers(2, 64)
    before = ts2.redos
    ts2.search(q2, k, method="chunkstream")
    assert ts2.redos == before


# ------------------------------------------------------------------- int8


def _jax_query_quant(q):
    q_absmax = jnp.max(jnp.abs(q), axis=1)
    q_scale = jnp.where(q_absmax > 0, q_absmax / 127.0, 1.0)
    return jnp.clip(jnp.round(q / q_scale[:, None]), -127, 127).astype(jnp.int8), q_scale


def _alike(q):
    """Rows the two packages quantize alike."""
    ti, ts = tq.quantize_rows(torch.from_numpy(q))
    ji, js = jax.jit(_jax_query_quant)(q)
    return (ti.numpy() == np.asarray(ji)).all(axis=1) & (ts.numpy() == np.asarray(js))


@pytest.mark.parametrize("method", ["exact", "chunkstream", "auto"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_int8_matches_jax_law(method, n_shards):
    ts, js, q, _, _ = _searchers(n_shards, 64, n=2048, store_dtype="int8", seed=5)
    assert ts.n_padded == 2048  # no padding at this size
    tv, ti = ts.search(q, 10, method=method)
    jv, ji = js.search(q, 10, method=method)
    for row, same in enumerate(_alike(q)):
        _same_up_to_ties(tv[row:row + 1], ti[row:row + 1], jv[row:row + 1],
                         ji[row:row + 1], tol=TOL if same else NEAR_TIE, what=method)


def test_int8_chunkstream_equals_int8_exact():
    """The integer law is exact: chunkstream's merge is exact's, bit for
    bit (values; ids up to exact ties)."""
    ts, _, q, _, _ = _searchers(8, 64, n=2048, store_dtype="int8", seed=5)
    ev, ei = ts.search(q, 10, method="exact")
    cv, ci = ts.search(q, 10, method="chunkstream")
    np.testing.assert_array_equal(cv, ev)
    for a, b in zip(ci, ei):
        assert set(a) == set(b)
    assert ts.redos == 0


def test_int8_recall_vs_fp32_truth():
    c, w, q = _problem(2048, 64, 4, 6)
    ts = ShardedFlatSearcher(c, w, _tmesh(8), axis="dp", store_dtype="int8")
    _, idx = ts.search(q, 10, method="chunkstream")
    eidx = np.argsort(-(q @ c.T) * w, axis=1)[:, :10]
    assert np.mean([len(set(i) & set(e)) / 10 for i, e in zip(idx, eidx)]) >= 0.9


# ------------------------------------------------------------------ store


def _stores(n=640, d=64, seed=21, mesh_shards=8, **cfg):
    """The port's store over ``mesh_shards`` logical CPU shards and the
    JAX store on the conftest mesh, over the same rows."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    tstore = VectorStore(
        dim=d, config=StoreConfig(pad_multiple=128, **cfg), device="cpu",
        mesh=make_mesh(axis_names=("shard",), devices=["cpu"] * mesh_shards),
    )
    tstore.insert_records(list(synthetic_corpus(n, seed=seed).records()), vecs)
    jstore = JStore(dim=d, config=JStoreConfig(pad_multiple=128, **cfg))
    jstore.insert_records(list(jsynthetic(n, seed=seed).records()), vecs)
    return tstore, jstore, vecs


def _assert_same_hits(got, want, tol=TOL):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        np.testing.assert_allclose([h.score for h in g_row], [h.score for h in w_row],
                                   rtol=0, atol=tol)
        kth = w_row[-1].score
        g_codes, w_codes = {h.code for h in g_row}, {h.code for h in w_row}
        for h in g_row + w_row:
            if h.code in g_codes ^ w_codes:
                assert abs(h.score - kth) <= tol, h.code


@pytest.mark.parametrize("method", [None, "exact", "streaming", "fast", "chunkstream"])
def test_sharded_store_matches_jax_sharded_store(method):
    tstore, jstore, vecs = _stores(sharded="on")
    assert tstore.load_collection() and jstore.load_collection()
    assert tstore._sharded is not None and tstore._dev is None
    assert tstore._sharded.mesh.shape == {"shard": 8}
    q = vecs[:5]
    _assert_same_hits(tstore.search(q, top_k=10, method=method),
                      jstore.search(q, top_k=10, method=method))
    # a torch query tensor serves the same hits
    _assert_same_hits(tstore.search(torch.from_numpy(q), top_k=10, method=method),
                      jstore.search(q, top_k=10, method=method))
    mem = tstore.get_memory_usage()
    assert mem["sharded"] and mem["sharded"] == jstore.get_memory_usage()["sharded"]
    # the shards' fp32 rows, 640 padded to 1024 over 8 shards
    assert mem["device_vector_bytes"] == 1024 * 64 * 4


def test_sharded_store_refuses_what_shards_do_not_serve():
    tstore, jstore, vecs = _stores(sharded="on")
    for store in (tstore, jstore):
        with pytest.raises(ValueError, match="not available on a sharded store"):
            store.search(vecs[:1], top_k=3, method="sketch")
    # hnsw runs on the host graph, sharded or not
    assert len(tstore.search(vecs[:1], top_k=3, method="hnsw")[0]) == 3


def test_release_reload_cycle():
    tstore, _, vecs = _stores(n=256, sharded="on")
    tstore.load_collection()
    assert tstore._sharded is not None
    tstore.release_collection()
    assert tstore._sharded is None and not tstore.is_loaded
    hits = tstore.search(vecs[:1], top_k=3)  # reloads on demand
    assert len(hits[0]) == 3 and tstore._sharded is not None
    tstore.insert_records(list(synthetic_corpus(4, seed=99).records()), vecs[:4])
    assert tstore._sharded is None  # the shards are stale after an insert


def test_off_mode_keeps_single_device():
    tstore, jstore, vecs = _stores(n=128, d=32, sharded="off")
    tstore.load_collection()
    jstore.load_collection()
    assert tstore._sharded is None and tstore._dev is not None
    assert jstore._sharded is None


@pytest.mark.parametrize("method", [None, "exact", "chunkstream", "fast"])
def test_f3_on_with_one_shard_serves_the_off_hits(method):
    """F3: the JAX store shards under "on" only with more than one
    device; the port raised ValueError instead (HTTP 400). With a
    one-shard mesh, "on" now serves from the one device, as "off"."""
    on, _, vecs = _stores(sharded="on", mesh_shards=1)
    off, _, _ = _stores(sharded="off")
    assert on.load_collection()
    assert on._sharded is None and on._dev is not None
    assert not on.get_memory_usage()["sharded"]
    q = vecs[:6]
    _assert_same_hits(on.search(q, 10, method=method), off.search(q, 10, method=method), tol=0)


def test_f3_default_mesh_on_the_cpu_is_one_shard():
    """Without a mesh, "on" builds one over the store's devices: on the
    CPU that is one device, so it serves unsharded too."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    store = VectorStore(dim=32, config=StoreConfig(pad_multiple=128, sharded="on"),
                        device="cpu")
    store.insert_records(list(synthetic_corpus(300, seed=3).records()), vecs)
    assert store.load_collection() and store._sharded is None
    assert store._shard_mesh().shape == {"shard": 1}


def test_f3_auto_never_shards_on_the_cpu():
    """"auto" counts CUDA cards, not shards: a CPU store with an
    8-shard mesh stays on one device."""
    tstore, _, vecs = _stores(sharded="auto")
    assert tstore.load_collection() and tstore._sharded is None
    assert len(tstore.search(vecs[:2], 5)[0]) == 5


def test_bf16_configuration_falls_back_to_fp32_shards():
    tstore, jstore, vecs = _stores(sharded="on", device_dtype="bfloat16")
    tstore.load_collection()
    assert tstore._sharded.store_dtype == "fp32"
    _assert_same_hits(tstore.search(vecs[:4], 10), jstore.search(vecs[:4], 10))


def test_sharded_int8_serves_exact_scores():
    """int8 shards select, the host re-ranks the merged over-fetch against
    the fp32 rows: served scores are exact, selection recall >= 0.9, and
    the JAX store's hits; a configured fp32-kernel default is served by
    the int8 scan, an explicit override raises "int8-sharded"."""
    n, d, k = 1024, 64, 5
    tstore, jstore, vecs = _stores(n=n, d=d, seed=23, sharded="on", device_dtype="int8")
    assert tstore.load_collection()
    assert tstore._sharded.store_dtype == "int8"
    # int8 rows and one fp32 factor per row, 1024 rows over 8 shards
    assert tstore.get_memory_usage()["device_vector_bytes"] == 1024 * (64 + 4)
    rng = np.random.default_rng(23)
    q = vecs[:6] + 0.05 * rng.standard_normal((6, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    hits = tstore.search(q, top_k=k)
    weighted = (q @ vecs.T) * tstore.corpus.level_weights()[None, :]
    recalls = []
    for i, row in enumerate(hits):
        assert len(row) == k
        for h in row:
            np.testing.assert_allclose(h.score, weighted[i, h.id], rtol=1e-5, atol=1e-6)
        expect = set(np.argsort(-weighted[i])[:k].tolist())
        recalls.append(len(expect & {h.id for h in row}) / k)
    assert np.mean(recalls) >= 0.9, recalls
    _assert_same_hits(hits, jstore.search(q, top_k=k), tol=NEAR_TIE)
    for store in (tstore, jstore):
        configured = store.config
        store.config = dataclasses.replace(configured, search_method="fast")
        assert len(store.search(q[:1], top_k=3)[0]) == 3  # the default: int8 scan
        store.config = configured
        assert len(store.search(q[:1], top_k=3, method="chunkstream")[0]) == 3
        with pytest.raises(ValueError, match="int8-sharded"):
            store.search(q[:1], top_k=3, method="fast")


# ------------------------------------------------------------------ F4


def _warmup_engine(store, methods=None):
    """An Engine over ``store`` with the default WARMUP_SEARCH_METHODS, or
    ``methods``."""
    from rag_icd10_tpu_torch.config import Config
    from rag_icd10_tpu_torch.runtime import Engine

    config = Config()
    assert config.api.warmup_methods == "fast,streaming"
    if methods is not None:
        config = dataclasses.replace(
            config, api=dataclasses.replace(config.api, warmup_methods=methods))
    engine = Engine(config=config, device="cpu")
    engine.store = store
    return engine


def _two_shard_store(device_dtype):
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    store = VectorStore(
        dim=32, config=StoreConfig(pad_multiple=128, sharded="on", device_dtype=device_dtype),
        device="cpu",
        mesh=make_mesh(axis_names=("shard",), devices=["cpu", "cpu"], distributed=False),
    )
    store.insert_records(list(synthetic_corpus(300, seed=5).records()), vecs)
    return store, vecs


def test_f4_warmup_skips_what_int8_shards_refuse(caplog):
    """F4: the default warmup list (fast, streaming) over an int8-sharded
    store raised "not available on an int8-sharded store", so the server
    did not start where the JAX server does. The methods the shards
    refuse are now skipped with a log line; those they serve still run."""
    store, vecs = _two_shard_store("int8")
    engine = _warmup_engine(store)
    with caplog.at_level("INFO", logger="rag_icd10_tpu_torch"):
        engine._warmup_extra_methods([1, 2])
    assert store._sharded is not None and store._sharded.store_dtype == "int8"
    for method in ("fast", "streaming"):
        assert f"skipping method={method} (a int8-sharded store" in caplog.text
        with pytest.raises(ValueError, match="int8-sharded"):
            store.search(vecs[:1], top_k=3, method=method)
    engine = _warmup_engine(store, "exact,chunkstream,approx,sketch")
    caplog.clear()
    with caplog.at_level("INFO", logger="rag_icd10_tpu_torch"):
        engine._warmup_extra_methods([1])
    assert "warmup(exact) done" in caplog.text and "warmup(chunkstream) done" in caplog.text
    assert "skipping method=approx" in caplog.text and "skipping method=sketch" in caplog.text


def test_f4_warmup_skips_sketch_over_fp32_shards(caplog):
    store, _ = _two_shard_store("float32")
    engine = _warmup_engine(store, "fast,streaming,sketch,chunkstream")
    with caplog.at_level("INFO", logger="rag_icd10_tpu_torch"):
        engine._warmup_extra_methods([1, 2])
    assert store._sharded is not None and store._sharded.store_dtype == "fp32"
    assert "skipping method=sketch (a fp32-sharded store" in caplog.text
    for method in ("fast", "streaming", "chunkstream"):
        assert f"warmup({method}) done" in caplog.text


def test_f4_warmup_still_raises_other_failures():
    """Only the methods a store refuses by design are skipped: any other
    failure of the warmup propagates, as the port's rule has it."""
    store, _ = _two_shard_store("int8")
    engine = _warmup_engine(store, "fast,exact")
    store.load_collection()

    def broken(*args, **kwargs):
        raise RuntimeError("scan failed")

    store._sharded.search = broken
    with pytest.raises(RuntimeError, match="scan failed"):
        engine._warmup_extra_methods([1])
