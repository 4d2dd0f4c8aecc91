"""The ``streaming`` method's ops: the port's ``streaming_topk`` (K2's plain
version on the CPU) against the JAX package's ``streaming_topk`` in
interpret mode, on the same numpy inputs.

Tolerances: atol 1e-5 plus rtol 1e-6. The inputs are unnormalized
standard-normal vectors, as in tests/test_streaming_topk.py, so scores
reach about 50; IEEE fp32 on both sides, summed in different orders over
D = 128 products, differs by a few ulps of the score (1e-6 relative).
bf16 corpora take the same tolerance: both sides round q to bf16, and
the bf16 x bf16 products are exact in fp32, leaving only the sum order.
Ids are compared as sets up to ties at the k-th value.

The port's slot layout is its own: G contiguous row ranges
(``slot_count``, ``range_rows``), each keeping its own top-k by default,
where the TPU kernel keeps a top-``slot_depth(k)`` per lane slot (row mod
128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops import pallas_score as jps
from rag_icd10_tpu_torch.ops import fused_score
from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
from rag_icd10_tpu_torch.ops.fused_score import (
    fused_search,
    range_rows,
    slot_count,
    slot_depth,
    streaming_candidates,
    streaming_topk,
)

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL, RTOL = 1e-5, 1e-6


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _problem(b=8, n=4096, d=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.choice([0.8, 1.0, 1.2], n).astype(np.float32)
    m = np.zeros(n, np.float32)
    return q, c, w, m


def _jax_streaming(q, c, w, m, k, tile_n=2048):
    vals, idx = jps.streaming_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(w), jnp.asarray(m),
        k=k, tile_n=tile_n, interpret=True,
    )
    return np.asarray(vals), np.asarray(idx)


def _assert_same_topk(vals, idx, jvals, jidx, scores):
    np.testing.assert_allclose(vals, jvals, atol=TOL, rtol=RTOL)
    for row in range(idx.shape[0]):
        kth = jvals[row, -1]
        for j in set(idx[row].tolist()) ^ set(jidx[row].tolist()):
            assert abs(scores[row, j] - kth) <= TOL + RTOL * abs(kth), (row, j)


@pytest.mark.parametrize("k", [1, 5, 10, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_topk_matches_jax(k, dtype):
    q, c, w, m = _problem(seed=k)
    jc = jnp.asarray(c).astype(dtype)
    jvals, jidx = _jax_streaming(q, jc, w, m, k)
    tc = t(c).to(getattr(torch, dtype))
    vals, idx, certified = streaming_topk(t(q), tc, t(w), t(m), k)
    assert idx.dtype == torch.int32 and tuple(vals.shape) == (8, k)
    assert bool(certified.all())  # random data certifies
    scores = weighted_scores_reference(t(q), tc, t(w), t(m)).numpy()
    _assert_same_topk(vals.numpy(), idx.numpy(), jvals, jidx, scores)


def _collide(c, q, rows):
    """Plant the global top rows of every query at ``rows``, best first."""
    target = q[0] / np.linalg.norm(q[0])
    for rank, row in enumerate(rows):
        c[row] = target * (10.0 - rank)
    q[:] = target


@pytest.mark.parametrize("depth", ["slot_depth", "default"])
def test_slot_collision_decertifies_and_stays_exact(depth):
    """8 of the top-16 in adjacent rows of one range, as sibling ICD codes
    lie. At the JAX package's depth slot_depth(16) = 5 the range's state
    provably misses some, so the certificate must fail and ``guarantee``
    must still give the exact top-k with one redo. At the default depth
    S = k the same data certifies with no redo."""
    q, c, w, m = _problem(b=8, n=4096, d=128, seed=99)
    c *= 0.01
    w[:] = 1.0
    k = 16
    S = slot_depth(k) if depth == "slot_depth" else 0
    assert slot_depth(k) < 8 and range_rows(4096, slot_count(8, 4096, k)) >= 8 + 40
    _collide(c, q, [40 + i for i in range(8)])
    before = streaming_topk.redos
    _, _, cert = streaming_topk(t(q), t(c), t(w), t(m), k, guarantee=False, depth=S)
    assert bool(cert.any()) == (depth == "default")
    vals, idx, cert = streaming_topk(t(q), t(c), t(w), t(m), k, depth=S)
    if depth == "default":
        assert bool(cert.all()) and streaming_topk.redos == before
    else:
        assert not bool(cert.any()) and streaming_topk.redos == before + 1
    jvals, jidx = _jax_streaming(q, c, w, m, k)
    scores = (q @ c.T) * w
    _assert_same_topk(vals.numpy(), idx.numpy(), jvals, jidx, scores)


def test_jax_lane_collision_certifies():
    """tests/test_streaming_topk.py's collision (8 top rows 128 apart, all
    in one of the TPU's lane slots) falls into 8 ranges of the port's
    layout: it certifies even at the JAX depth, with no redo."""
    q, c, w, m = _problem(b=8, n=4096, d=128, seed=99)
    c *= 0.01
    w[:] = 1.0
    k = 16
    _collide(c, q, [3 + 128 * i for i in range(8)])
    before = streaming_topk.redos
    vals, idx, cert = streaming_topk(t(q), t(c), t(w), t(m), k, depth=slot_depth(k))
    assert bool(cert.all()) and streaming_topk.redos == before
    jvals, jidx = _jax_streaming(q, c, w, m, k)
    _assert_same_topk(vals.numpy(), idx.numpy(), jvals, jidx, (q @ c.T) * w)


def test_padding_mask_respected():
    q, c, w, m = _problem(n=2048, seed=7)
    m[1500:] = -1e9
    _, idx, _ = streaming_topk(t(q), t(c), t(w), t(m), 10)
    _, jidx = _jax_streaming(q, c, w, m, 10)
    assert int(idx.max()) < 1500 and int(jidx.max()) < 1500


@pytest.mark.parametrize("k", [1, 5, 16, 32, 64, 100, 128])
def test_slot_depth_matches_jax(k):
    assert slot_depth(k) == jps.slot_depth(k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("S,slots", [(4, 8), (5, 7), (16, 24), (128, 24)])
def test_candidate_contract(seed, S, slots):
    """Every candidate is a row of its own range scoring its value, and
    every row outside the candidates scores at most its range's bound.
    N = 3000 is ragged (24 tiles, the last of 56 rows); 7 ranges of 4
    tiles leave the 7th empty; at S = 128 every range is no longer than S,
    so nothing is evicted and every bound is -inf."""
    q, c, w, m = _problem(b=4, n=3000, d=64, seed=seed)
    n = c.shape[0]
    vals, ids, bounds = streaming_candidates(t(q), t(c), t(w), t(m), S, slots)
    assert tuple(vals.shape) == (4, slots * S) and tuple(bounds.shape) == (4, slots)
    r = range_rows(n, slots)
    assert r % 128 == 0 and slots * r >= n
    scores = (q @ c.T) * w
    for row in range(4):
        got = ids[row].numpy()
        real = got >= 0
        assert (got[real] // r == (np.arange(slots * S) // S)[real]).all()
        np.testing.assert_allclose(
            scores[row, got[real]], vals[row].numpy()[real], atol=TOL, rtol=RTOL
        )
        v = vals[row].numpy().reshape(slots, S)
        assert (v[:, :-1] >= v[:, 1:]).all()  # descending within a range
        for g in range(slots):  # a range keeps min(S, its rows) candidates
            assert real.reshape(slots, S)[g].sum() == min(S, max(0, min(n, (g + 1) * r) - g * r))
        outside = np.setdiff1d(np.arange(n), got[real])
        slack = TOL + RTOL * np.abs(scores[row, outside])
        assert (scores[row, outside] <= bounds[row].numpy()[outside // r] + slack).all()
    if S >= r:
        assert bool(torch.isneginf(bounds).all())


def test_fused_search_streaming_and_large_k():
    q, c, w, m = _problem(n=2048, seed=11)
    jvals, jidx = _jax_streaming(q, c, w, m, 8)  # what JAX's route runs
    scores = (q @ c.T) * w
    vals, idx = fused_search(t(q), t(c), t(w), t(m), k=8, method="streaming")
    _assert_same_topk(vals.numpy(), idx.numpy(), jvals, jidx, scores)
    # k > 128 takes the materialized path, as in the JAX package
    before = fused_search.streaming_over_k_max
    vals, idx = fused_search(t(q), t(c), t(w), t(m), k=200, method="streaming")
    assert fused_search.streaming_over_k_max == before + 1
    want = -np.sort(-scores, axis=1)[:, :200]
    np.testing.assert_allclose(vals.numpy(), want, atol=TOL, rtol=RTOL)
    with pytest.raises(ValueError):
        streaming_topk(t(q), t(c), t(w), t(m), k=200)


@pytest.mark.parametrize(
    "b,n,k,t,g",
    [  # the table of the picker: (B, N, k) -> t tiles per range, G ranges
        (2, 40960, 20, 1, 320),  # the main path's shape
        (8, 40960, 100, 4, 80),
        (256, 40960, 10, 9, 36),  # 32 queries per block: 8 x 36 = 288 blocks
        (8, 1 << 20, 10, 31, 265),
        (64, 40960, 100, 4, 80),
        (1, 512, 5, 1, 4),
        (300, 40960, 128, 12, 27),  # 10 query tiles x 27 = 270 blocks
    ],
)
def test_slot_count_rules(b, n, k, t, g):
    assert slot_count(b, n, k) == g
    assert range_rows(n, g) == 128 * t
    tiles = -(-n // 128)
    m_tiles = -(-b // fused_score.stream_tile_rows(b))
    assert fused_score.stream_tile_rows(b) == (8 if b <= 16 else 32)
    # two waves unless a smaller range was forced by the candidate rule
    two_waves = m_tiles * g >= fused_score._STREAM_BLOCKS
    assert two_waves or t == 1 or g * k <= n // 4
    # the candidates stay within a quarter of the corpus
    assert g * k <= n // 4 or g == 1
    # the largest t for two waves: one more tile per range falls short
    if two_waves and g * k <= n // 4:
        assert m_tiles * -(-tiles // (t + 1)) < fused_score._STREAM_BLOCKS


def test_depth_and_range_arguments_checked():
    q, c, w, m = _problem(n=1024, seed=5)
    for S, slots in [(0, 8), (129, 8), (4, 0)]:
        with pytest.raises(ValueError):
            streaming_candidates(t(q), t(c), t(w), t(m), S, slots)
    with pytest.raises(ValueError):  # 2 ranges of depth 4 hold 8 < 10
        streaming_topk(t(q), t(c), t(w), t(m), 10, slots=2, depth=4)
    vals, _, cert = streaming_topk(t(q), t(c), t(w), t(m), 10, slots=1)
    want = -np.sort(-((q @ c.T) * w), axis=1)[:, :10]  # one range is the flat scan
    np.testing.assert_allclose(vals.numpy(), want, atol=TOL, rtol=RTOL)
    assert bool(cert.all())


def test_no_launch_on_cpu():
    q, c, w, m = _problem(n=1024, seed=3)
    streaming_topk(t(q), t(c), t(w), t(m), 10)
    fused_search(t(q), t(c), t(w), t(m), k=5, method="streaming")
    assert streaming_candidates.launches == 0
