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

The port's slot layout is its own: P slots (``slot_count``), slot p
holding rows p, p + P, ... The TPU's 128 lane slots are the case P = 128.
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


@pytest.mark.parametrize("layout", ["jax", "port"])
def test_slot_collision_decertifies_and_stays_exact(layout):
    """More than S of the top-k in one slot: the slot's state provably
    misses some, so the certificate must fail, and ``guarantee`` must
    still give the exact top-k. "jax" is tests/test_streaming_topk.py's
    case (8 rows in one 128-stride lane slot, run with the TPU layout
    P = 128); "port" builds the collision for the port's default P."""
    q, c, w, m = _problem(b=8, n=4096, d=128, seed=99)
    c *= 0.01
    w[:] = 1.0
    k = 16
    assert slot_depth(k) < 8
    slots = 128 if layout == "jax" else slot_count(8, 4096, k)
    _collide(c, q, [3 + slots * i for i in range(8)])
    before = streaming_topk.redos
    _, _, cert = streaming_topk(t(q), t(c), t(w), t(m), k, guarantee=False, slots=slots)
    assert not bool(cert.any())
    vals, idx, cert = streaming_topk(t(q), t(c), t(w), t(m), k, slots=slots)
    assert not bool(cert.any()) and streaming_topk.redos == before + 1
    jvals, jidx = _jax_streaming(q, c, w, m, k)
    scores = (q @ c.T) * w
    _assert_same_topk(vals.numpy(), idx.numpy(), jvals, jidx, scores)


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
@pytest.mark.parametrize("S,slots", [(4, 128), (5, 256), (16, 128)])
def test_candidate_contract(seed, S, slots):
    """Every row outside the candidates scores at most its slot's bound,
    and every candidate is a row of its own slot scoring its value."""
    q, c, w, m = _problem(b=4, n=3000, d=64, seed=seed)
    vals, ids, bounds = streaming_candidates(t(q), t(c), t(w), t(m), S, slots)
    assert tuple(vals.shape) == (4, slots * S) and tuple(bounds.shape) == (4, slots)
    scores = (q @ c.T) * w
    n = c.shape[0]
    for row in range(4):
        got = ids[row].numpy()
        real = got >= 0
        assert (got[real] % slots == (np.arange(slots * S) % slots)[real]).all()
        np.testing.assert_allclose(
            scores[row, got[real]], vals[row].numpy()[real], atol=TOL, rtol=RTOL
        )
        outside = np.setdiff1d(np.arange(n), got[real])
        slack = TOL + RTOL * np.abs(scores[row, outside])
        assert (scores[row, outside] <= bounds[row].numpy()[outside % slots] + slack).all()


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


def test_slot_count_rules():
    for b, n, k in [(8, 40960, 10), (256, 40960, 10), (8, 1 << 20, 100), (1, 512, 5)]:
        p = slot_count(b, n, k)
        assert p % 128 == 0
        assert p == 128 or p * slot_depth(k) <= n // 2
        assert -(-b // 8) * p // 128 <= fused_score._STREAM_BLOCKS or p == 128


def test_no_launch_on_cpu():
    q, c, w, m = _problem(n=1024, seed=3)
    streaming_topk(t(q), t(c), t(w), t(m), 10)
    fused_search(t(q), t(c), t(w), t(m), k=5, method="streaming")
    assert streaming_candidates.launches == 0
