"""The ``chunkstream`` method's ops: the port's ops/chunk_stream.py and
ops/quantized.py (kernel wrappers computing their plain versions on the
CPU) against the JAX package's, whose Pallas kernels run in interpret
mode, on the same numpy inputs.

Tolerances, each with its reason:
- ``quantize_rows``: bit for bit. The chunkstream certificate measures
  its residual against exactly this law.
- ``bound_scale`` and ``resid_max``: rtol 1e-6 and 1e-4. Both are square
  roots of fp32 sums of D squares, summed in different orders by XLA and
  by PyTorch; a residual is a small difference of close numbers.
- Stored rows (fp32 folded rows, bf16 rows, int8 values): bit for bit.
  int8 scales: bit for bit with ``quantize_rows`` of the folded rows, and
  within 1 ulp (rtol 2.4e-7) of the JAX store's: XLA compiles the JAX
  build's ``absmax / 127`` under jit as a multiplication by the
  reciprocal, one ulp off its own law in a few percent of rows. Each
  side measures its residual on the scales it stores, so both
  certificates stay sound.
- Chunk maxima and raw re-scores: atol 1e-5. IEEE fp32 (bf16 and int8:
  bf16(q) times exactly widened values, products exact in fp32) summed
  in different orders over D = 128 products of unit vectors.
- Search values: atol 1e-5, ids equal (the exact top-k of random data
  has no ties).

The layout of the scanned corpus differs on purpose: the JAX package
stores it transposed (``corpus_t``, (D, N)), the port row-major
(``folded``, (N, D)); the tests compare what the layout does not change.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops import chunk_stream as jcs
from rag_icd10_tpu.ops.quantized import quantize_rows as jquantize
from rag_icd10_tpu_torch.ops import chunk_stream as tcs
from rag_icd10_tpu_torch.ops.fused_score import fused_search
from rag_icd10_tpu_torch.ops.quantized import quantize_rows
from rag_icd10_tpu_torch.ops.rerank import EPS_HIGH_DOT

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL = 1e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def make_problem(n=3000, d=128, b=8, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    w = rng.choice([0.8, 1.0, 1.2], n).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return vecs, w, q


def brute(q, vecs, w, k):
    expected = (q @ vecs.T) * w[None, :]
    eidx = np.argsort(-expected, axis=1)[:, :k]
    return np.take_along_axis(expected, eidx, axis=1), eidx


def _stores(vecs, w, scan_dtype, tile_cap=512):
    jstore = jcs.ChunkStore.build(vecs, w, batch_hint=8, tile_cap=tile_cap, scan_dtype=scan_dtype)
    tstore = tcs.ChunkStore.build(vecs, w, tile_cap=tile_cap, scan_dtype=scan_dtype, device="cpu")
    return jstore, tstore


def _dequant_rows(store):
    """A store's scanned rows as fp32 (N, D), whatever its layout."""
    if isinstance(store, tcs.ChunkStore):
        rows = store.folded.to(torch.float32)
        if store.scales is not None:
            rows = rows * store.scales[:, None]
        return rows.numpy()
    rows = np.asarray(store.corpus_t.astype(jnp.float32)).T
    if store.scales is not None:
        rows = rows * np.asarray(store.scales)[:, None]
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((300, 96)) * rng.uniform(0.01, 5, (300, 1))).astype(np.float32)
    x[7] = 0.0  # zero guard
    x[8, :5] = [0.5, -0.5, 1.5, 127.0, -127.0]  # half-way cases round to even
    q, s = quantize_rows(x)
    jq, js = jquantize(x)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    tq, ts = quantize_rows(t(x))
    jq2, js2 = jquantize(jnp.asarray(x), xp=jnp)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js2))


@pytest.mark.parametrize("scan_dtype", ["fp32", "bf16", "int8"])
def test_build_matches_jax(scan_dtype):
    vecs, w, _ = make_problem(n=1000, d=64, seed=5)
    jstore, tstore = _stores(vecs, w, scan_dtype)
    assert tstore.n_real == jstore.n_real == 1000
    assert tstore.scan_dtype == jstore.scan_dtype == scan_dtype
    assert tstore.folded.shape == jstore.corpus_t.shape[::-1]
    np.testing.assert_allclose(tstore.bound_scale, jstore.bound_scale, rtol=1e-6)
    np.testing.assert_allclose(tstore.resid_max, jstore.resid_max, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(tstore.corpus.numpy(), np.asarray(jstore.corpus))
    np.testing.assert_array_equal(tstore.weights.numpy(), np.asarray(jstore.weights))
    np.testing.assert_array_equal(tstore.mask.numpy(), np.asarray(jstore.mask))
    if scan_dtype == "int8":
        np.testing.assert_array_equal(tstore.folded.numpy(), np.asarray(jstore.corpus_t).T)
        folded = np.asarray(jstore.corpus) * np.asarray(jstore.weights)[:, None]
        np.testing.assert_array_equal(tstore.scales.numpy(), jquantize(folded)[1])
        np.testing.assert_allclose(
            tstore.scales.numpy(), np.asarray(jstore.scales), rtol=2.4e-7, atol=0
        )
        np.testing.assert_allclose(
            _dequant_rows(tstore), _dequant_rows(jstore), rtol=2.4e-7, atol=0
        )
    else:
        np.testing.assert_array_equal(_dequant_rows(tstore), _dequant_rows(jstore))
        assert tstore.scales is None and jstore.scales is None


def test_build_device_shares_padded_rows():
    vecs, w, _ = make_problem(n=1000, d=64, seed=6)
    padded = torch.zeros((1024, 64))
    padded[:1000] = t(vecs)
    wp = torch.zeros(1024)
    wp[:1000] = t(w)
    store = tcs.build_device(padded, wp, tile_cap=512, n_real=1000)
    assert store.corpus.data_ptr() == padded.data_ptr()  # no copy
    assert store.n_real == 1000 and bool((store.mask[1000:] < -1e29).all())
    _, ref = _stores(vecs, w, "fp32")
    np.testing.assert_array_equal(store.folded.numpy(), ref.folded.numpy())


def _jax_chunk_maxima(q, jstore):
    tile_n = jcs.transposed_tile_n(
        q.shape[0], jstore.corpus_t.shape[1], q.shape[1],
        itemsize=jstore.corpus_t.dtype.itemsize,
    )
    return np.asarray(jcs.chunk_maxima_transposed(
        jnp.asarray(q), jstore.corpus_t, tile_n, scales=jstore.scales, interpret=True,
    ))


@pytest.mark.parametrize("scan_dtype", ["fp32", "bf16", "int8"])
def test_chunk_maxima_matches_jax(scan_dtype):
    vecs, w, q = make_problem(n=2048, d=128, seed=7)
    jstore, tstore = _stores(vecs, w, scan_dtype)
    want = _jax_chunk_maxima(q, jstore)
    got = tcs.chunk_maxima(t(q), tstore.folded, tstore.scales)
    assert got.shape == (8, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    np.testing.assert_allclose(
        tcs.chunk_maxima_reference(t(q), tstore.folded, tstore.scales).numpy(), want, atol=TOL
    )


@pytest.mark.parametrize("b", [8, 5, 13])
def test_gather_rescore_matches_jax(b):
    """B need not be a multiple of 8 in the port; the JAX kernel takes
    QB = 8 queries a step, so its side is padded and sliced."""
    vecs, _, q = make_problem(n=2048, d=64, b=b, seed=b)
    rng = np.random.default_rng(b)
    ids = rng.integers(0, 16, (b, 6)).astype(np.int32)
    b8 = -(-b // 8) * 8
    qp = np.zeros((b8, 64), np.float32)
    qp[:b] = q
    ip = np.zeros((b8, 6), np.int32)
    ip[:b] = ids
    want = np.asarray(jcs.gather_rescore(
        jnp.asarray(qp), jnp.asarray(vecs), jnp.asarray(ip), mc=6, interpret=True,
    ))[:b]
    got = tcs.gather_rescore(t(q), t(vecs), t(ids))
    assert got.shape == (b, 6 * 128)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.fixture(scope="module")
def problem():
    return make_problem(n=3000, d=128, b=8, seed=0)


@pytest.fixture(scope="module")
def small_problem():
    """2048 rows = 16 chunks; with mc = 6 the certificate decides."""
    return make_problem(n=2048, d=64, b=8, seed=4)


ENGINES = [
    ("fp32", "pallas"), ("fp32", "xla"), ("fp32", "xla_high"),
    ("bf16", "pallas"), ("bf16", "xla"), ("bf16", "bf16"),
    ("int8", "pallas"), ("int8", "xla"), ("int8", "int8"),
]


@pytest.mark.parametrize("scan_dtype,scan", ENGINES)
def test_search_matches_jax(small_problem, scan_dtype, scan):
    vecs, w, q = small_problem
    jstore, tstore = _stores(vecs, w, scan_dtype)
    jvals, jidx, jcert = map(
        np.asarray, jcs.search(jstore, q, k=10, mc=6, scan=scan, interpret=True)
    )
    vals, idx, cert = tcs.search(tstore, t(q), k=10, mc=6, scan=scan)
    assert idx.dtype == torch.int32 and cert.dtype == torch.bool
    np.testing.assert_allclose(vals.numpy(), jvals, atol=TOL)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(cert.numpy(), jcert)
    evals, eidx = brute(q, vecs, w, 10)
    for row in np.flatnonzero(cert.numpy()):
        np.testing.assert_array_equal(idx[row].numpy(), eidx[row])


def test_negative_score_regime(problem):
    """All-negative scores: padding rows (folded zeros score 0 in pass 1)
    must not leak into results, and the mask keeps the certificate sound."""
    vecs, w, q = problem
    _, tstore = _stores(vecs, w, "fp32")
    vals, idx, cert = tcs.search(tstore, t(-q), k=10)
    _, eidx = brute(-q, vecs, w, 10)
    np.testing.assert_array_equal(idx.numpy(), eidx)
    assert bool(cert.all()) and int(idx.max()) < len(vecs)


def test_tiny_mc_decertifies_not_wrong(problem):
    vecs, w, q = problem
    _, tstore = _stores(vecs, w, "fp32")
    _, idx, cert = tcs.search(tstore, t(q), k=10, mc=1)
    _, eidx = brute(q, vecs, w, 10)
    wrong = [r for r in range(8) if not np.array_equal(idx[r].numpy(), eidx[r])]
    assert wrong  # one chunk cannot hold every query's top-10
    assert not bool(cert[wrong].any())
    # with the guarantee the batch is redone on the exact path
    before = tcs.chunk_stream_search.redos
    vals, idx, _ = tcs.search(tstore, t(q), k=10, mc=1, guarantee=True)
    assert tcs.chunk_stream_search.redos == before + 1
    np.testing.assert_array_equal(idx.numpy(), eidx)


def test_all_chunks_fetched_certifies():
    vecs, w, q = make_problem(n=500, d=64, b=8, seed=11)
    _, tstore = _stores(vecs, w, "fp32", tile_cap=128)
    nc = tstore.corpus.shape[0] // 128
    _, idx, cert = tcs.search(tstore, t(q), k=10, mc=nc)
    assert bool(cert.all())
    np.testing.assert_array_equal(idx.numpy(), brute(q, vecs, w, 10)[1])


@pytest.mark.parametrize("b", [1, 2, 3, 8, 9, 16, 17, 32, 33, 64, 65, 256])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_chunk_max_plan_table(b, dtype):
    """One path per (B, dtype) at D = 768: "stream" up to the dtype's
    threshold (16 for fp32, 2 for bf16, none for int8) and on either side
    of it, then "mma" (16- to 128-query tiles) for bf16 and int8, "simt"
    for fp32."""
    plan = tcs.chunk_max_plan(b, 40960, 768, dtype, sm_count=132)
    assert plan == tcs.chunk_max_plan(b, 40960, 768, tcs._SCAN_DTYPES[dtype], 132)
    if b <= {"fp32": 16, "bf16": 2, "int8": 0}[dtype]:
        assert (plan.path, plan.blocks, plan.tile_rows) == ("stream", 264, 0)
    elif dtype == "fp32":
        assert (plan.path, plan.blocks, plan.tile_rows) == ("simt", 0, 0)
    else:
        assert plan.path == "mma"
        assert plan.tile_rows == (16 if b <= 16 else 32 if b <= 32 else 64 if b <= 64 else 128)


@pytest.mark.parametrize("b,d,dtype,path,blocks", [
    (16, 768, "fp32", "stream", 264),    # 112 KB a block: 2 per SM
    (8, 1536, "fp32", "stream", 264),
    (16, 1024, "fp32", "stream", 132),   # 128 KB: 1 per SM
    (16, 2608, "fp32", "stream", 132),   # 227 KB, the most a block may take
    (16, 2616, "fp32", "simt", 0),       # the query block does not fit
    (2, 20864, "bf16", "stream", 132),
    (2, 20872, "bf16", "mma", 0),
    (1, 768, "int8", "mma", 0),
])
def test_stream_plan_fits_shared_memory(b, d, dtype, path, blocks):
    """"stream" keeps 2 blocks per SM where two blocks' rings and fp32
    query blocks fit in an SM, 1 where only one fits, and hands a D whose
    query block exceeds a block's shared memory to the large-batch path,
    so every D the wrapper accepts has a path."""
    plan = tcs.chunk_max_plan(b, 40960, d, dtype, sm_count=132)
    assert (plan.path, plan.blocks) == (path, blocks)
    if path == "stream":
        assert tcs.STREAM_RING_BYTES + b * d * 4 <= tcs.BLOCK_SMEM_BYTES


@pytest.mark.parametrize("n,blocks,cut", [
    (40960, 264, 192),   # the main shape: 1,280 groups, ranges of 4 or 5
    (33152, 264, 198),   # 259 chunks, 1,036 groups: ranges of 3 or 4
    (1024, 32, 8),       # fewer groups than 2 per SM: one group per block
    (1 << 20, 264, 192),
])
def test_stream_row_ranges(n, blocks, cut):
    """The "stream" split covers N exactly with ranges of whole 32-row
    groups that differ by at most one group; a chunk is cut where a range
    starts inside it, and only there."""
    plan = tcs.chunk_max_plan(2, n, 768, "bf16", sm_count=132)
    assert plan.path == "stream" and plan.blocks == blocks
    ranges = plan.row_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [e - s for s, e in ranges]
    assert all(s % tcs.STREAM_GROUP == 0 and s > 0 for s in sizes)
    assert max(sizes) - min(sizes) <= tcs.STREAM_GROUP
    owners = {}
    for i, (s, e) in enumerate(ranges):
        for chunk in range(s // 128, (e - 1) // 128 + 1):
            owners.setdefault(chunk, set()).add(i)
    assert sorted(owners) == list(range(n // 128))  # every chunk gets rows
    cut_chunks = {c for c, o in owners.items() if len(o) > 1}
    assert cut_chunks == {s // 128 for s, _ in ranges[1:] if s % 128}
    assert len(cut_chunks) == cut


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, 2, 3, 8, 9, 16, 17])
def test_certificate_eps_follows_the_plan(dtype, b):
    """The tensor-core epsilon exactly where the plan says "mma"; today's
    epsilon on every other path and on the plain version."""
    torch_dtype = tcs._SCAN_DTYPES[dtype]
    path = tcs.chunk_max_plan(b, 40960, 768, dtype, sm_count=132).path
    resid, bscale = 0.01, 1.2
    eps = tcs.certificate_eps(torch_dtype, "pallas", path, resid, bscale, 768)
    tensor_cores = dtype != "fp32" and b > tcs.STREAM_MAX_B[torch_dtype]
    assert (path == "mma") == tensor_cores
    dot = tcs.eps_tc_dot(768) if tensor_cores else tcs.EPS_FP32_DOT
    if dtype == "fp32":
        assert eps == dot * bscale
    else:
        assert eps == resid + (tcs.EPS_BF16_VEC + dot) * bscale
    plain = tcs.certificate_eps(torch_dtype, "pallas", None, resid, bscale, 768)
    assert plain == tcs.certificate_eps(torch_dtype, "pallas", "stream", resid, bscale, 768)
    assert (eps > plain) == tensor_cores


@pytest.mark.parametrize("d", [8, 72, 80, 768, 1024, 1536, 4096])
def test_eps_tc_dot_covers_truncating_accumulation(d):
    """The tensor-core term covers ceil(d / 4) truncating steps of 4
    products (6 * 2^-23 each) plus pass 2's rounding, (d + 1) * 2^-24; it
    exceeds two round-to-nearest fp32 sums and grows with d."""
    eps = tcs.eps_tc_dot(d)
    assert eps >= -(-d // 4) * 6 * 2.0 ** -23 + (d + 1) * 2.0 ** -24
    assert eps > 2 * (d + 1) * 2.0 ** -24
    assert tcs.eps_tc_dot(d + 16) > eps
    if d == 768:
        assert eps > tcs.EPS_FP32_DOT


@pytest.mark.parametrize("d", [64, 768, 1536, 4096])
def test_fp32_and_high_terms_grow_with_d(d):
    """The fp32 and xla_high terms cover two round-to-nearest fp32 dots of
    d products, 2 (d + 1) 2^-24, at every d; they keep the JAX package's
    constants as floors (1e-4 up to d = 768, 8e-5 up to 670), and
    certificate_eps passes d through to them."""
    two_sums = 2 * (d + 1) * 2.0 ** -24
    fp32, high = tcs.eps_fp32_dot(d), tcs.eps_high_dot(d)
    assert fp32 >= two_sums and high >= two_sums
    assert fp32 >= tcs.EPS_FP32_DOT and high >= EPS_HIGH_DOT
    assert (fp32 == tcs.EPS_FP32_DOT) == (d <= 768)
    assert (high == EPS_HIGH_DOT) == (d <= 670)
    resid, bscale = 0.01, 1.2
    assert tcs.certificate_eps(torch.float32, "pallas", "stream", resid, bscale, d) == fp32 * bscale
    assert tcs.certificate_eps(torch.float32, "xla", None, resid, bscale, d) == fp32 * bscale
    assert tcs.certificate_eps(torch.float32, "xla_high", None, resid, bscale, d) == high * bscale
    assert tcs.certificate_eps(torch.bfloat16, "pallas", "stream", resid, bscale, d) == (
        resid + (tcs.EPS_BF16_VEC + fp32) * bscale)


@pytest.mark.parametrize("scan", ["pallas", "xla", "xla_high"])
def test_search_at_d1536_certifies_and_is_exact(scan):
    """D = 1536 over an fp32 store: the certificate, widened for d, still
    certifies every query with mc = 26 of 32 chunks, and the result is
    the exact top-k."""
    vecs, w, q = make_problem(n=4096, d=1536, b=8, seed=15)
    _, tstore = _stores(vecs, w, "fp32")
    vals, idx, cert = tcs.search(tstore, t(q), k=10, scan=scan)
    assert bool(cert.all())
    evals, eidx = brute(q, vecs, w, 10)
    np.testing.assert_array_equal(idx.numpy(), eidx)
    np.testing.assert_allclose(vals.numpy(), evals, atol=TOL)
    fvals, fidx = fused_search(t(q), tstore.corpus, tstore.weights, tstore.mask, k=10)
    np.testing.assert_array_equal(idx.numpy(), fidx.numpy())
    np.testing.assert_allclose(vals.numpy(), fvals.numpy(), atol=TOL)


@pytest.mark.parametrize("path", [None, "stream", "mma"])
def test_search_passes_pass1_path_to_certificate(small_problem, monkeypatch, path):
    """chunk_stream_search decides pass 1's plan once, launches it, and
    takes its epsilon from it: on the CPU no kernel runs (None); the plan
    is stubbed to show that a CUDA run's "mma" reaches the certificate."""
    vecs, w, q = small_problem
    _, tstore = _stores(vecs, w, "bf16")
    seen, launched = [], []
    real_eps, real_maxima = tcs.certificate_eps, tcs.chunk_maxima

    def spy_eps(dtype, scan, p, resid_max, bound_scale, d):
        seen.append((p, d))
        return real_eps(dtype, scan, p, resid_max, bound_scale, d)

    def spy_maxima(queries, folded, scales=None, plan=None):
        launched.append(plan)
        return real_maxima(queries, folded, scales, plan)

    monkeypatch.setattr(tcs, "certificate_eps", spy_eps)
    monkeypatch.setattr(tcs, "chunk_maxima", spy_maxima)
    plan = None if path is None else tcs.ChunkMaxPlan(path, tstore.folded.shape[0])
    calls = []
    monkeypatch.setattr(tcs, "_pass1_plan", lambda *args: calls.append(1) or plan)
    tcs.search(tstore, t(q), k=10, mc=6)
    assert seen == [(path, q.shape[1])]
    assert launched == [plan] and len(calls) == 1


def test_bad_inputs_and_no_launch_on_cpu(problem):
    vecs, w, q = problem
    _, tstore = _stores(vecs, w, "bf16")
    with pytest.raises(ValueError):
        tcs.search(tstore, t(q), k=5, scan="xla_high")  # needs an fp32 store
    with pytest.raises(ValueError):
        tcs.search(tstore, t(q), k=5, scan="int8")  # needs an int8 store
    with pytest.raises(ValueError):
        tcs.search(tstore, t(q), k=5, scan="bogus")
    with pytest.raises(ValueError):
        tcs.chunk_maxima(t(q), quantize_rows(t(vecs[:1024]))[0])  # no scales
    with pytest.raises(ValueError):
        tcs.gather_rescore(t(q), t(vecs[:1000]), torch.zeros((8, 2), dtype=torch.int32))
    assert tcs.chunk_maxima.launches == tcs.chunk_maxima.launches_int8 == 0
    assert tcs.gather_rescore.launches == 0


@pytest.mark.parametrize("b", [1, 2, 3, 8, 15, 16, 17, 63, 64, 256])
@pytest.mark.parametrize("k", [10, 20, 100])
@pytest.mark.parametrize("nc", [320, 8192])
def test_rescore_plan_table(b, k, nc):
    """K5's plan at the served corpus shape and at 1M rows (D = 768):
    "grouped" exactly where B*mc pairs
    save RESCORE_GROUPED_MIN_SAVED reads of the distinct chunks uniform
    random ids would hit; "pairs" elsewhere."""
    mc = max(2 * k, k + 16)
    plan = tcs.rescore_plan(b, mc, nc, 768, sm_count=132)
    saved = b * mc - tcs.expected_chunks(b * mc, nc)
    if saved >= tcs.RESCORE_GROUPED_MIN_SAVED:
        assert plan == tcs.RescorePlan("grouped")
    else:
        assert plan == tcs.RescorePlan("pairs", group_rows=tcs.pairs_group_rows(b * mc, 132))


@pytest.mark.parametrize("pairs,nc", [(1, 1), (5, 1), (80, 320), (6656, 8192), (51200, 320)])
def test_expected_chunks_matches_random_ids(pairs, nc):
    """The plan's estimate of the distinct chunks B*mc pairs read is the
    mean over uniform random ids (within 3% over 200 draws)."""
    rng = np.random.default_rng(pairs)
    seen = np.mean([len(np.unique(rng.integers(0, nc, pairs))) for _ in range(200)])
    assert tcs.expected_chunks(pairs, nc) == pytest.approx(seen, rel=0.03)


def test_rescore_plan_at_the_served_shapes():
    """The main path's batch (B = 2, k = 20) and a small batch over 1M
    rows re-read almost no chunk: "pairs"; 16 queries of k = 100 over the
    served corpus share most chunks: "grouped"."""
    assert tcs.rescore_plan(2, 40, 320, 768, 132) == tcs.RescorePlan("pairs", group_rows=32)
    assert tcs.rescore_plan(64, 26, 8192, 768, 132).path == "pairs"
    assert tcs.rescore_plan(16, 200, 320, 768, 132).path == "grouped"


@pytest.mark.parametrize("b,mc,rows", [
    (2, 40, 32),   # the main shape: 80 pairs x 4 groups = 320 blocks
    (8, 26, 32),
    (1, 40, 16),   # 160 blocks of 32 rows would not give 2 per SM; 320 of 16
    (1, 26, 8),    # 104 and 208 would not; 416 of 8
    (1, 1, 8),     # 16 blocks: the smallest group is the most there is
])
def test_pairs_plan_fills_the_card(b, mc, rows):
    """"pairs" takes the largest group of a chunk's rows per block that
    still gives RESCORE_BLOCKS_PER_SM blocks per SM, down to 8 rows."""
    plan = tcs.rescore_plan(b, mc, 320, 768, sm_count=132)
    assert (plan.path, plan.group_rows) == ("pairs", rows)
    blocks = b * mc * 128 // rows
    assert blocks >= tcs.RESCORE_BLOCKS_PER_SM * 132 or rows == 8


@pytest.mark.parametrize("d,path", [(41728, "pairs"), (41732, "grouped")])
def test_pairs_plan_fits_shared_memory(d, path):
    """A "pairs" block holds its warps' rings (8 warps x 4 stages x 2 KB
    for 32 rows) and the fp32 query row; a D whose row does not fit goes
    to "grouped", which streams D in slices, so every D has a path."""
    plan = tcs.rescore_plan(2, 40, 320, d, sm_count=132)
    assert plan.path == path
    if path == "pairs":
        assert tcs._pairs_smem(plan.group_rows, d) <= tcs.BLOCK_SMEM_BYTES


def _tiles(ids, nc, qt):
    """The tiles the kernel's counting sort makes: ceil(n_c / QT) for each
    chunk c of n_c pairs (ids outside [0, nc) are not grouped)."""
    ids = ids[(ids >= 0) & (ids < nc)]
    counts = np.bincount(ids, minlength=nc)
    return int(np.sum(-(-counts // qt)))


@pytest.mark.parametrize("pairs,nc", [
    (1, 1), (7, 320), (80, 320), (320, 320), (321, 320), (400, 3),
    (6656, 8192), (51200, 320), (51200, 8192), (51200, 20000),
])
def test_tile_bound_covers_worst_case(pairs, nc):
    """The grid of "grouped" covers every tile list: the most tiles P
    pairs over nc chunks make is m + floor((P - m) / QT), m = min(nc, P)
    (every pair in its own chunk, the rest in whole tiles, each chunk one
    partial tile), within ceil(P / QT) + m; random ids stay inside too."""
    qt = tcs.RESCORE_TILE_ROWS
    bound = tcs.tile_bound(pairs, nc)
    m = min(nc, pairs)
    worst = np.concatenate([np.arange(m), np.zeros(pairs - m, np.int64)])
    assert _tiles(worst, nc, qt) == m + (pairs - m) // qt <= bound
    assert bound == -(-pairs // qt) + m
    rng = np.random.default_rng(pairs)
    for ids in (rng.integers(0, nc, pairs), rng.integers(-2, nc + 2, pairs),
                np.full(pairs, nc - 1)):
        assert _tiles(ids, nc, qt) <= bound


def test_gather_rescore_out_of_range_is_nan_on_cpu():
    """On the CPU any plan computes the plain version: an id outside
    [0, N/128) scores NaN, the others their rows' fp32 dots."""
    vecs, _, q = make_problem(n=1024, d=64, b=3, seed=2)
    ids = np.array([[0, 8, -1], [7, 7, 3], [100, 2, 0]], np.int32)
    bad = (ids < 0) | (ids >= 8)
    want = np.einsum("bd,bird->bir", q, vecs.reshape(8, 128, 64)[np.where(bad, 0, ids)])
    for plan in (None, tcs.RescorePlan("pairs", group_rows=32), tcs.RescorePlan("grouped")):
        got = tcs.gather_rescore(t(q), t(vecs), t(ids), plan=plan).view(3, 3, 128).numpy()
        assert np.isnan(got[bad]).all()
        np.testing.assert_allclose(got[~bad], want[~bad], atol=TOL)
    assert tcs.gather_rescore.launches == 0
