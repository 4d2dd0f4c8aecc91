"""The hand-written CUDA kernels (K1-K5) against their plain versions, on
a card.

These tests need an NVIDIA GPU and nvcc; they carry the ``gpu`` marker
and skip elsewhere. The file imports neither JAX nor the JAX package, so
it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest -q

Tolerance 5e-5: the kernels sum D products sequentially in fp32 (fmaf),
the plain versions in cuBLAS's order; for unit vectors at D = 768 the
worst-case difference of two fp32 sums is below that. Order statistics
(a range's candidates and bound, a chunk's maximum) move by no more than
the scores they are taken from, so they share the tolerance. The "mma"
paths of the chunk maxima and of K1 (a bf16 corpus) sum exact bf16
products on the tensor cores; on random unit vectors their accumulation
errs far below 5e-5 (the worst case, eps_tc_dot, has tests of its own).
At D = 1536 the worst case of two fp32 sums, 2 (d + 1) 2^-24 = 1.8e-4, is
above 5e-5, but random unit vectors err far below it, as at D = 768.
"""

import functools

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.ops import chunk_stream
from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
from rag_icd10_tpu_torch.ops.fused_score import (
    ScorePlan,
    fused_score_plan,
    fused_search,
    fused_weighted_scores,
    range_rows,
    slot_count,
    slot_depth,
    sm_count,
    streaming_candidates,
    streaming_candidates_reference,
    streaming_topk,
)
from rag_icd10_tpu_torch.ops.quantized import quantize_rows

TOL = 5e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(b, n, d, seed, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    w = np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n)]
    m = np.zeros(n, np.float32)
    m[-7:] = -1e30  # padding rows
    return [torch.from_numpy(x).to(dev) for x in (q, c, w, m)]


# ragged shapes on purpose: B not a power of two, N not a tile multiple,
# D with a tail shorter than the kernel's 32-wide step
SHAPES = [(3, 1000, 72), (8, 4096, 768), (40, 2500, 128), (130, 3000, 768)]
MODES = [(torch.float32, True), (torch.float32, False), (torch.bfloat16, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("corpus_dtype,exact", MODES)
def test_fused_score_matches_plain(cuda, b, n, d, corpus_dtype, exact):
    q, c, w, m = _problem(b, n, d, seed=b, dev=cuda)
    c = c.to(corpus_dtype)
    before = fused_weighted_scores.launches
    got = fused_weighted_scores(q, c, w, m, exact=exact)
    torch.cuda.synchronize()
    assert fused_weighted_scores.launches == before + 1
    want = weighted_scores_reference(q, c, w, m, exact=exact)
    real = slice(0, n - 7)
    err = (got[:, real] - want[:, real]).abs().max().item()
    assert err <= 5e-5, err
    assert bool((got[:, n - 7:] < -1e29).all())


@pytest.mark.gpu
def test_fused_search_topk_matches_plain(cuda):
    q, c, w, m = _problem(8, 40960, 768, seed=0, dev=cuda)
    vals, idx = fused_search(q, c, w, m, k=10)
    want = weighted_scores_reference(q, c, w, m)
    wvals, widx = torch.topk(want, 10, dim=1)
    torch.testing.assert_close(vals, wvals, atol=5e-5, rtol=0)
    # ids equal up to ties: each returned id scores the value it claims
    picked = torch.gather(want, 1, idx.long())
    torch.testing.assert_close(picked, vals, atol=5e-5, rtol=0)


K1_B = [1, 2, 4, 8, 16, 17, 64, 256]
K1_D = [72, 768, 1536]
K1_N = [1000, 2500, 40960]  # ragged (not whole 32- or 128-row tiles), served


@functools.cache
def _k1_data(n, d):
    """256 queries and an (n, d) corpus on the card, made once per shape;
    a test takes the first B queries."""
    return tuple(_problem(256, n, d, seed=n + d, dev=torch.device("cuda")))


def _k1_check(q, c, w, m, exact, plan=None):
    """One K1 call (the plan's path, or ``plan`` forced) against the plain
    version; the padding rows stay masked and the counter moves once."""
    n = c.shape[0]
    before = fused_weighted_scores.launches
    got = fused_weighted_scores(q, c, w, m, exact=exact, plan=plan)
    torch.cuda.synchronize()
    assert fused_weighted_scores.launches == before + 1
    want = weighted_scores_reference(q, c, w, m, exact=exact)
    assert got.shape == want.shape == (q.shape[0], n)
    torch.testing.assert_close(got[:, : n - 7], want[:, : n - 7], atol=TOL, rtol=0)
    assert bool((got[:, n - 7:] < -1e29).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", K1_N)
@pytest.mark.parametrize("d", K1_D)
@pytest.mark.parametrize("b", K1_B)
@pytest.mark.parametrize("corpus_dtype,exact", MODES)
def test_k1_planned_paths_match_plain(cuda, corpus_dtype, exact, b, d, n):
    """The plan's path at every B, D and N: "stream" (fp32, B <= 16; N
    not a whole number of 32-row groups), "tile" (fp32 above), "mma"
    (bf16 corpus; N not a whole number of 128-row tiles, D = 72 a tail
    inside a 32-column stage)."""
    q, c, w, m = _k1_data(n, d)
    q, c = q[:b].contiguous(), c.to(corpus_dtype)
    plan = fused_score_plan(b, n, d, corpus_dtype, exact, sm_count(cuda.index or 0))
    if corpus_dtype == torch.bfloat16:
        assert plan.path == "mma"
    else:
        assert plan.path == ("stream" if b <= 16 else "tile")
    _k1_check(q, c, w, m, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("n", K1_N)
@pytest.mark.parametrize("d", K1_D)
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("exact", [True, False])
def test_k1_tile_forced_below_threshold(cuda, exact, b, d, n):
    """"tile" forced where the plan takes "stream" (the threshold rows of
    chip_smoke.py time both)."""
    q, c, w, m = _k1_data(n, d)
    _k1_check(q[:b].contiguous(), c, w, m, exact, plan=ScorePlan("tile", not exact))


@pytest.mark.gpu
@pytest.mark.parametrize("n", K1_N)
@pytest.mark.parametrize("b", [2, 16])
@pytest.mark.parametrize("blocks", [1, 7])
def test_k1_stream_forced_block_counts(cuda, blocks, b, n):
    """"stream" with fewer blocks than the plan's: one block walks every
    group, 7 blocks take uneven ranges (the last group ragged)."""
    q, c, w, m = _k1_data(n, 768)
    _k1_check(q[:b].contiguous(), c, w, m, True, plan=ScorePlan("stream", False, blocks=blocks))


@pytest.mark.gpu
def test_k1_rejects_plans_it_cannot_run(cuda):
    """No fallback: a plan the kernel cannot run raises, and nothing
    launches."""
    q, c, w, m = _k1_data(1000, 72)
    q17 = q[:17].contiguous()
    before = fused_weighted_scores.launches
    bad = [
        (q17, c, True, ScorePlan("stream", False, blocks=8)),  # B above 16
        (q17[:2], c.bfloat16(), True, ScorePlan("stream", True, blocks=8)),  # bf16 corpus
        (q17[:2], c, False, ScorePlan("mma", True, tile_rows=16)),  # fp32 corpus
        (q17[:2], c, True, ScorePlan("stream", False, blocks=0)),
        (q17[:2], c, True, ScorePlan("stream", False, blocks=33)),  # 32 groups
        (q17[:2], c.bfloat16(), True, ScorePlan("mma", True, tile_rows=8)),
    ]
    for qq, cc, exact, plan in bad:
        with pytest.raises(RuntimeError):
            fused_weighted_scores(qq, cc, w, m, exact=exact, plan=plan)
    with pytest.raises(ValueError):  # the plan's arithmetic is not the call's
        fused_weighted_scores(q17, c, w, m, plan=ScorePlan("tile", True))
    assert fused_weighted_scores.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 17, 256])
@pytest.mark.parametrize("corpus_dtype", [torch.float32, torch.bfloat16])
def test_k1_topk_through_fused_search(cuda, b, corpus_dtype):
    """The top-k of every path through fused_search equals the plain
    top-k up to ties, and never picks a padding row."""
    q, c, w, m = _k1_data(40960, 768)
    q, c = q[:b].contiguous(), c.to(corpus_dtype)
    vals, idx = fused_search(q, c, w, m, k=20)
    want = weighted_scores_reference(q, c, w, m)
    torch.testing.assert_close(vals, torch.topk(want, 20, dim=1).values, atol=TOL, rtol=0)
    torch.testing.assert_close(torch.gather(want, 1, idx.long()), vals, atol=TOL, rtol=0)
    assert int(idx.max()) < 40960 - 7


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 64, 256])
@pytest.mark.parametrize("d", [768, 1536])
def test_k1_mma_within_tensor_core_eps(cuda, b, d):
    """K1's "mma" scores lie within eps_tc_dot(d) * ||q|| * ||c|| * max w
    of the fp64 scores of the same bf16 inputs: the tensor-core
    accumulator may truncate."""
    q, c, w, m = _k1_data(40960, d)
    q, c = q[:b].contiguous(), c.bfloat16()
    got = fused_weighted_scores(q, c, w, m)
    q64, c64 = q.bfloat16().double(), c.double()
    want = (q64 @ c64.T) * w.double()
    scale = q64.norm(dim=1, keepdim=True) * c64.norm(dim=1).max() * w.max().double()
    real = slice(0, 40960 - 7)
    err = ((got.double() - want)[:, real].abs() / scale).max().item()
    assert err <= chunk_stream.eps_tc_dot(d), err


@pytest.mark.gpu
def test_fused_score_rejects_bad_inputs(cuda):
    q, c, w, m = _problem(4, 256, 64, seed=1, dev=cuda)
    with pytest.raises(TypeError):
        fused_weighted_scores(q, c.half(), w, m)
    with pytest.raises(ValueError):
        fused_weighted_scores(q, c.t().contiguous().t(), w, m)
    with pytest.raises(ValueError):
        fused_weighted_scores(q.cpu(), c, w, m)


def _check_range_candidates(q, c, w, m, S, slots, exact, dev):
    """K2 against its plain version, and the range contract row by row."""
    b, n = q.shape[0], c.shape[0]
    before = streaming_candidates.launches
    vals, ids, bounds = streaming_candidates(q, c, w, m, S, slots, exact=exact)
    torch.cuda.synchronize()
    assert streaming_candidates.launches == before + 1
    pv, _, pb = streaming_candidates_reference(q, c, w, m, S, slots, exact=exact)
    assert vals.shape == pv.shape == (b, slots * S) and bounds.shape == (b, slots)
    # each range's sorted candidates and its bound are order statistics
    torch.testing.assert_close(vals, pv, atol=TOL, rtol=0)
    torch.testing.assert_close(bounds, pb, atol=TOL, rtol=0)
    # every candidate id is a row of its range and scores its value
    r = range_rows(n, slots)
    scores = weighted_scores_reference(q, c, w, m, exact=exact)
    real = ids >= 0
    range_of_col = torch.arange(slots * S, device=dev) // S
    assert bool((ids[real].long() // r == range_of_col.expand_as(ids)[real]).all())
    picked = torch.gather(scores, 1, ids.clamp(min=0).long())
    assert (picked[real] - vals[real]).abs().max().item() <= TOL
    # the contract: no row outside the candidates beats its range's bound
    outside = torch.ones((b, n + 1), dtype=torch.bool, device=dev)
    outside.scatter_(1, torch.where(real, ids, n).long(), False)
    outside = outside[:, :n]
    row_bound = bounds[:, torch.arange(n, device=dev) // r]
    assert bool((scores[outside] <= row_bound[outside] + TOL).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", SHAPES)
@pytest.mark.parametrize("corpus_dtype,exact", MODES)
@pytest.mark.parametrize("k,slots", [(1, 7), (20, 0), (128, 5)])
def test_slot_stream_matches_plain(cuda, b, n, d, corpus_dtype, exact, k, slots):
    """Depth S = k: 1, 20 and 128 (4 list entries per lane). slots=0 takes
    slot_count's ranges; 7 ranges over 1,000 rows leave 3 empty; B = 3
    and 8 run 8 queries per block, B = 40 and 130 run 32 (ragged)."""
    q, c, w, m = _problem(b, n, d, seed=b + k, dev=cuda)
    c = c.to(corpus_dtype)
    _check_range_candidates(q, c, w, m, k, slots or slot_count(b, n, k), exact, cuda)


@pytest.mark.gpu
def test_slot_stream_main_shape(cuda):
    """The main path's shape: B = 2, N = 40,960, D = 768, k = 20 (320
    ranges of one tile); the top-k certifies and equals the exact one."""
    q, c, w, m = _problem(2, 40960, 768, seed=20, dev=cuda)
    slots = slot_count(2, 40960, 20)
    assert slots == 320
    _check_range_candidates(q, c, w, m, 20, slots, True, cuda)
    vals, idx, certified = streaming_topk(q, c, w, m, 20, guarantee=False)
    want = weighted_scores_reference(q, c, w, m)
    torch.testing.assert_close(vals, torch.topk(want, 20, dim=1).values, atol=TOL, rtol=0)
    torch.testing.assert_close(torch.gather(want, 1, idx.long()), vals, atol=TOL, rtol=0)
    assert bool(certified.all())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 100])
def test_streaming_topk_is_exact(cuda, k):
    q, c, w, m = _problem(64, 40960, 768, seed=k, dev=cuda)
    vals, idx, certified = streaming_topk(q, c, w, m, k)
    want = weighted_scores_reference(q, c, w, m)
    wvals, _ = torch.topk(want, k, dim=1)
    torch.testing.assert_close(vals, wvals, atol=TOL, rtol=0)
    picked = torch.gather(want, 1, idx.long())
    torch.testing.assert_close(picked, vals, atol=TOL, rtol=0)
    assert certified.dtype == torch.bool and tuple(certified.shape) == (64,)
    assert bool(certified.all())  # depth k certifies by construction


@pytest.mark.gpu
def test_slot_collision_decertifies_and_stays_exact(cuda):
    q, c, w, m = _problem(8, 4096, 128, seed=5, dev=cuda)
    t = q[0] / q[0].norm()
    k = 16
    for rank in range(8):  # 8 > slot_depth(16) = 5 top rows in one range
        c[40 + rank] = t * (10.0 - rank)
    q[:] = t
    m.zero_()
    before = streaming_topk.redos
    vals, idx, certified = streaming_topk(q, c, w, m, k, depth=slot_depth(k))
    assert not bool(certified.all()) and streaming_topk.redos == before + 1
    wvals, _ = torch.topk(weighted_scores_reference(q, c, w, m), k, dim=1)
    torch.testing.assert_close(vals, wvals, atol=TOL, rtol=0)
    # at the default depth S = k the same data certifies, with no redo
    vals, idx, certified = streaming_topk(q, c, w, m, k)
    assert bool(certified.all()) and streaming_topk.redos == before + 1
    torch.testing.assert_close(vals, wvals, atol=TOL, rtol=0)


def _chunk_problem(b, n, d, seed, dev):
    q, c, w, _ = _problem(b, n, d, seed, dev)
    return q, c * w[:, None]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(3, 1024, 80), (8, 4096, 768), (40, 2560, 128), (130, 3072, 768)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_chunk_max_matches_plain(cuda, b, n, d, dtype):
    q, f = _chunk_problem(b, n, d, seed=b, dev=cuda)
    scales = None
    if dtype == "bf16":
        f = f.to(torch.bfloat16)
    elif dtype == "int8":
        f, scales = quantize_rows(f)
    counter = "launches_int8" if dtype == "int8" else "launches"
    before = getattr(chunk_stream.chunk_maxima, counter)
    got = chunk_stream.chunk_maxima(q, f, scales)
    torch.cuda.synchronize()
    assert getattr(chunk_stream.chunk_maxima, counter) == before + 1
    want = chunk_stream.chunk_maxima_reference(q, f, scales)
    assert got.shape == (b, n // 128)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def _store(f, dtype):
    """Folded fp32 rows as a store of ``dtype``: (rows, scales or None)."""
    if dtype == "bf16":
        return f.to(torch.bfloat16), None
    if dtype == "int8":
        return quantize_rows(f)
    return f, None


def _launch_checked(q, f, scales, dtype, dev):
    """One chunk_maxima call: the plan's path, each launch counter moved
    as it should (once for the store's kernel, not at all for the other)."""
    plan = chunk_stream.chunk_max_plan(
        q.shape[0], *f.shape, f.dtype, torch.cuda.get_device_properties(dev).multi_processor_count
    )
    counter, other = ("launches_int8", "launches") if dtype == "int8" else ("launches", "launches_int8")
    before = (getattr(chunk_stream.chunk_maxima, counter), getattr(chunk_stream.chunk_maxima, other))
    got = chunk_stream.chunk_maxima(q, f, scales)
    torch.cuda.synchronize()
    after = (getattr(chunk_stream.chunk_maxima, counter), getattr(chunk_stream.chunk_maxima, other))
    assert after == (before[0] + 1, before[1])
    return plan, got


# N = 20,608 rows: 161 chunks, 644 groups of 32 rows over 264 "stream"
# blocks, so the row ranges (2 or 3 groups) cut most chunks
CUT_N = 20608


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 17, 32, 64, 100, 256])
@pytest.mark.parametrize("d", [80, 768])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_chunk_max_paths_match_plain(cuda, b, d, dtype):
    """Every path x store against the plain version: "stream" up to
    the store's threshold (16 fp32, 2 bf16, none for int8; chunks cut
    between blocks merged by atomics), "mma" (bf16, int8) and "simt"
    (fp32) above;
    D = 80 leaves a D tail in the slices; the last 50 rows are zero, as a
    store's padding is, so the last chunk is partly padded."""
    q, f = _chunk_problem(b, CUT_N, d, seed=b + d, dev=cuda)
    f[-50:] = 0.0
    f, scales = _store(f, dtype)
    plan, got = _launch_checked(q, f, scales, dtype, cuda)
    limit = chunk_stream.STREAM_MAX_B[f.dtype]
    expected = "stream" if b <= limit else ("simt" if dtype == "fp32" else "mma")
    assert plan.path == expected
    if plan.path == "stream":
        assert any(s % 128 for s, _ in plan.row_ranges())  # chunks are cut
    want = chunk_stream.chunk_maxima_reference(q, f, scales)
    assert got.shape == (b, CUT_N // 128)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 16, 17, 64])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_chunk_max_all_negative_scores(cuda, b, dtype):
    """Every score negative: the atomic merge of cut chunks must keep the
    largest negative value (0xFF fill, unsigned view) on every path."""
    q, f = _chunk_problem(b, CUT_N, 768, seed=b, dev=cuda)
    q, f = q.abs(), -f.abs()
    f, scales = _store(f, dtype)
    _, got = _launch_checked(q, f, scales, dtype, cuda)
    want = chunk_stream.chunk_maxima_reference(q, f, scales)
    assert bool((want < 0).all())
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


@pytest.mark.gpu
def test_chunk_max_main_shape(cuda):
    """The main path's shape: B = 2, N = 40,960, D = 768, fp32, on the
    "stream" path over 2 blocks per SM."""
    q, f = _chunk_problem(2, 40960, 768, seed=2, dev=cuda)
    plan, got = _launch_checked(q, f, None, "fp32", cuda)
    assert plan.path == "stream" and plan.blocks == min(
        2 * torch.cuda.get_device_properties(cuda).multi_processor_count, 40960 // 32)
    torch.testing.assert_close(got, chunk_stream.chunk_maxima_reference(q, f), atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,dtype,path", [
    (2, 1536, "fp32", "stream"),    # 2 blocks per SM
    (16, 1536, "fp32", "stream"),   # 160 KB a block: 1 per SM
    (16, 2624, "fp32", "simt"),     # the query block does not fit: "simt"
    (17, 1536, "fp32", "simt"),
    (2, 1536, "bf16", "stream"),
    (64, 1536, "bf16", "mma"),
    (2, 1536, "int8", "mma"),
    (256, 1536, "int8", "mma"),
])
def test_chunk_max_wide_rows(cuda, b, d, dtype, path):
    """D above 1024 on every path: "stream" with one block per SM where
    two do not fit, the large-batch path where the query block exceeds a
    block's shared memory, and "mma" with its epsilon computed from D."""
    q, f = _chunk_problem(b, CUT_N, d, seed=b + d, dev=cuda)
    f, scales = _store(f, dtype)
    plan, got = _launch_checked(q, f, scales, dtype, cuda)
    assert plan.path == path
    torch.testing.assert_close(
        got, chunk_stream.chunk_maxima_reference(q, f, scales), atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 256])
@pytest.mark.parametrize("d", [768, 1536])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_mma_chunk_max_within_tensor_core_eps(cuda, b, d, dtype):
    """Soundness of eps_tc_dot(d): the "mma" maxima lie within it of the
    fp64 chunk maxima of the same inputs (bf16(q), the stored rows, the
    scales), per unit of ||bf16(q)|| * max ||stored row||."""
    q, f = _chunk_problem(b, 40960, d, seed=b, dev=cuda)
    f, scales = _store(f, dtype)
    plan, got = _launch_checked(q, f, scales, dtype, cuda)
    assert plan.path == "mma"
    q64 = q.to(torch.bfloat16).double()
    rows = f.double() * (scales.double()[:, None] if scales is not None else 1.0)
    want = (q64 @ rows.T).view(b, -1, 128).amax(dim=2)
    scale = q64.norm(dim=1, keepdim=True) * rows.norm(dim=1).max()
    err = ((got.double() - want).abs() / scale).max().item()
    assert err <= chunk_stream.eps_tc_dot(d), err


K5_PLANS = [
    chunk_stream.RescorePlan("pairs", group_rows=32),
    chunk_stream.RescorePlan("pairs", group_rows=16),
    chunk_stream.RescorePlan("pairs", group_rows=8),
    chunk_stream.RescorePlan("grouped"),
]
K5_NC = 300  # chunks of the test corpus: 38,400 rows


@functools.cache
def _k5_corpus(nc, d):
    gen = torch.Generator(device="cuda").manual_seed(d)
    c = torch.randn((nc * 128, d), generator=gen, device="cuda")
    return c / c.norm(dim=1, keepdim=True)


def _k5_queries(b, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, d), generator=gen, device="cuda")
    return q / q.norm(dim=1, keepdim=True)


def _k5_check(q, c, ids, plan):
    """K5 on ``plan`` against the plain version (8 queries at a time, so
    the plain gather stays small), NaN where the plain version has NaN;
    one counted launch."""
    before = chunk_stream.gather_rescore.launches
    got = chunk_stream.gather_rescore(q, c, ids, plan=plan)
    torch.cuda.synchronize()
    assert chunk_stream.gather_rescore.launches == before + 1
    want = torch.cat([chunk_stream.gather_rescore_reference(q[i : i + 8], c, ids[i : i + 8])
                      for i in range(0, q.shape[0], 8)])
    torch.testing.assert_close(got, want, atol=TOL, rtol=0, equal_nan=True)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("plan", K5_PLANS, ids=lambda p: f"{p.path}{p.group_rows or ''}")
@pytest.mark.parametrize("mc", [1, 26, 200])
@pytest.mark.parametrize("d", [72, 768, 1536])
@pytest.mark.parametrize("b", [1, 3, 17, 64, 130, 256])
def test_gather_rescore_matches_plain(cuda, b, d, mc, plan):
    """Both K5 paths, forced, against the plain version: D with a tail
    shorter than a 32-column slice (72), the served width and twice it;
    random ids, so chunks repeat within and across queries."""
    c = _k5_corpus(K5_NC, d)
    gen = torch.Generator(device=cuda).manual_seed(b * mc)
    ids = torch.randint(0, K5_NC, (b, mc), device=cuda, dtype=torch.int32, generator=gen)
    _k5_check(_k5_queries(b, d, seed=b), c, ids, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", K5_PLANS, ids=lambda p: f"{p.path}{p.group_rows or ''}")
@pytest.mark.parametrize("case", ["duplicates", "same_chunks", "large_nc", "out_of_range"])
def test_gather_rescore_cases(cuda, case, plan):
    """duplicates: ids repeat within a query's row; same_chunks: every
    query selects the same 200 chunks (the most pairs a chunk can have,
    several tiles each); large_nc: more chunks than the sort's shared
    histogram holds (global atomics); out_of_range: ids below 0 and at or
    past N/128 give NaN for their 128 scores, the rest stay exact."""
    b, mc, d, nc = 130, 26, 768, K5_NC
    gen = torch.Generator(device=cuda).manual_seed(7)
    if case == "duplicates":
        ids = torch.randint(0, 4, (b, mc), device=cuda, dtype=torch.int32, generator=gen)
    elif case == "same_chunks":
        mc = 200
        ids = torch.randperm(nc, device=cuda, generator=gen)[:mc].to(torch.int32).repeat(b, 1)
    elif case == "large_nc":
        d, nc = 8, chunk_stream.RESCORE_LOCAL_CHUNKS + 1000
        ids = torch.randint(0, nc, (b, mc), device=cuda, dtype=torch.int32, generator=gen)
    else:
        ids = torch.randint(-3, nc + 3, (b, mc), device=cuda, dtype=torch.int32, generator=gen)
        ids[0, :3] = torch.tensor([-1, nc, 2**31 - 1], dtype=torch.int32)
    got = _k5_check(_k5_queries(b, d, seed=3), _k5_corpus(nc, d), ids, plan)
    bad = ((ids < 0) | (ids >= nc))[:, :, None].expand(b, mc, 128).reshape(b, -1)
    assert bool(torch.isnan(got[bad]).all()) and bool(torch.isfinite(got[~bad]).all())
    if case == "out_of_range":
        assert bool(bad.any())


@pytest.mark.gpu
def test_gather_rescore_rejects_plans_it_cannot_run(cuda):
    """A path the wrapper does not know raises before the launch; a group
    size the kernel was not built for, or a query row too wide for
    "pairs"' shared memory, is refused by the entry point, and raises."""
    q, c = _k5_queries(4, 64, seed=1), _k5_corpus(8, 64)
    ids = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    before = chunk_stream.gather_rescore.launches
    with pytest.raises(ValueError):
        chunk_stream.gather_rescore(q, c, ids, plan=chunk_stream.RescorePlan("tile"))
    with pytest.raises(RuntimeError):
        chunk_stream.gather_rescore(q, c, ids, plan=chunk_stream.RescorePlan("pairs", group_rows=12))
    wide = 60000  # 240 KB of query row
    with pytest.raises(RuntimeError):
        chunk_stream.gather_rescore(
            _k5_queries(1, wide, seed=1), _k5_corpus(1, wide),
            torch.zeros((1, 1), dtype=torch.int32, device=cuda),
            plan=chunk_stream.RescorePlan("pairs", group_rows=8))
    assert chunk_stream.gather_rescore.launches == before
    # the plan sends that width to "grouped", which streams D in slices
    _k5_check(_k5_queries(1, wide, seed=1), _k5_corpus(1, wide),
              torch.zeros((1, 1), dtype=torch.int32, device=cuda), None)


@pytest.mark.gpu
def test_chunk_stream_search_exact_on_card(cuda):
    _, c, w, _ = _problem(16, 40000, 768, seed=3, dev=cuda)
    q = c[:16] + 0.01
    q = q / q.norm(dim=1, keepdim=True)
    for scan_dtype in ("fp32", "bf16", "int8"):
        store = chunk_stream.build_device(c, w, scan_dtype=scan_dtype)
        vals, idx, _ = chunk_stream.search(store, q, k=10, guarantee=True)
        want = weighted_scores_reference(q, store.corpus, store.weights, store.mask)
        wvals, _ = torch.topk(want, 10, dim=1)
        torch.testing.assert_close(vals, wvals, atol=TOL, rtol=0)
        assert int(idx.max()) < 40000


@pytest.mark.gpu
def test_k2_to_k5_reject_bad_inputs(cuda):
    q, c, w, m = _problem(4, 1024, 64, seed=1, dev=cuda)
    with pytest.raises(ValueError):
        streaming_candidates(q, c, w, m, S=4, slots=0)
    with pytest.raises(ValueError):
        streaming_candidates(q, c, w, m, S=129, slots=8)
    with pytest.raises(ValueError):
        streaming_candidates(q.cpu(), c, w, m, S=4, slots=8)
    with pytest.raises(ValueError):
        chunk_stream.chunk_maxima(q, quantize_rows(c)[0])  # int8 without scales
    with pytest.raises(ValueError):
        chunk_stream.chunk_maxima(q, c[:1000])  # not whole chunks
    with pytest.raises(TypeError):
        chunk_stream.gather_rescore(q, c.bfloat16(), torch.zeros((4, 2), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        chunk_stream.gather_rescore(q, c, torch.zeros((3, 2), dtype=torch.int32, device=cuda))
    # an id outside the corpus scores NaN instead of reading out of bounds
    bad = torch.tensor([[0, 8]] * 4, dtype=torch.int32, device=cuda)
    out = chunk_stream.gather_rescore(q, c, bad)
    assert bool(torch.isnan(out[:, 128:]).all()) and bool(torch.isfinite(out[:, :128]).all())
