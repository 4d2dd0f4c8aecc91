"""Scoring-kernel module parity: rag_icd10_tpu_torch.ops against the JAX
package's ops on the same numpy inputs.

On the CPU the port's ``fused_weighted_scores`` computes its plain
version (the CUDA kernel cannot run here); the JAX side runs its Pallas
kernel in interpret mode exactly as tests/test_flat_search.py does.
Tolerances: fp32 atol 1e-5 (IEEE fp32 on both sides, sums in different
orders over D <= 128 unit-vector products); bf16 corpus atol/rtol 2e-2.

The kernel itself runs only on a card: tests/test_torch_cuda_kernels.py.
"""

import sys
import threading
from unittest import mock

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops.flat_topk import flat_search_jax
from rag_icd10_tpu.ops.flat_topk import pad_corpus as pad_corpus_jax
from rag_icd10_tpu.ops.pallas_score import fused_weighted_scores as fused_jax
from rag_icd10_tpu_torch.ops import chunk_stream, flat_topk
from rag_icd10_tpu_torch.ops.fused_score import (
    ScorePlan,
    fused_score_plan,
    fused_search,
    fused_weighted_scores,
)

torch.set_num_threads(2)  # the suite runs several test processes at once


def make_problem(b=8, n=4096, d=128, seed=0, n_real=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    n_real = n_real or n
    c = rng.standard_normal((n_real, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    levels = rng.integers(1, 4, size=n_real)
    w = np.array([1.2, 1.0, 0.8], dtype=np.float32)[levels - 1]
    return q, c, w


def jax_interpret(q, cp, wp, m, tile_n):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", interp):
        return np.asarray(
            fused_jax.__wrapped__(
                jnp.asarray(q), jnp.asarray(cp), jnp.asarray(wp),
                jnp.asarray(m), tile_n=tile_n,
            )
        )


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_pad_corpus_matches_jax():
    _, c, w = make_problem(n_real=1000)
    for got, want in zip(flat_topk.pad_corpus(c, w), pad_corpus_jax(c, w)):
        np.testing.assert_array_equal(got, want)


def test_fp32_matches_pallas_interpret():
    q, c, w = make_problem(b=8, n=2048, d=128)
    cp, wp, m = flat_topk.pad_corpus(c, w, multiple=512)
    want = jax_interpret(q, cp, wp, m, tile_n=512)
    got = fused_weighted_scores(t(q), t(cp), t(wp), t(m)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bf16_corpus_matches_pallas_interpret():
    q, c, w = make_problem(b=8, n=1024, d=128)
    cp, wp, m = flat_topk.pad_corpus(c, w, multiple=512)
    want = jax_interpret(
        q.astype(jnp.bfloat16), cp.astype(jnp.bfloat16), wp, m, tile_n=512
    )
    got = fused_weighted_scores(
        t(q), t(cp).to(torch.bfloat16), t(wp), t(m)
    ).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_inexact_mode_rounds_inputs_to_bf16():
    """exact=False is one bf16 pass: both operands bf16-rounded, fp32 sums."""
    q, c, w = make_problem(b=4, n=512, d=64, seed=2)
    cp, wp, m = flat_topk.pad_corpus(c, w, multiple=512)
    rq = t(q).to(torch.bfloat16).float().numpy()
    rc = t(cp).to(torch.bfloat16).float().numpy()
    want = (rq.astype(np.float64) @ rc.astype(np.float64).T) * wp + m
    got = fused_weighted_scores(t(q), t(cp), t(wp), t(m), exact=False).numpy()
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-5)


def test_padding_mask():
    q, c, w = make_problem(b=8, n_real=1000)
    cp, wp, m = flat_topk.pad_corpus(c, w, multiple=1024)
    scores = fused_weighted_scores(t(q), t(cp), t(wp), t(m)).numpy()
    assert (scores[:, 1000:] < -1e29).all()
    assert (scores[:, :1000] > -2.0).all()
    vals, idx = fused_search(t(q), t(cp), t(wp), t(m), k=50)
    assert int(idx.max()) < 1000 and float(vals.min()) > -1e29


def _assert_same_topk(vals, idx, jvals, jidx, scores):
    """Values within 1e-5 and index sets equal up to ties: an index that
    differs must carry the same score as the one it replaces."""
    np.testing.assert_allclose(vals, jvals, atol=1e-5)
    for row in range(idx.shape[0]):
        a, b = set(idx[row].tolist()), set(jidx[row].tolist())
        for j in a ^ b:
            kth = jvals[row, -1]
            assert abs(scores[row, j] - kth) <= 1e-5, (row, j)


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_search_matches_flat_search_jax(method, k):
    q, c, w = make_problem(b=16, n_real=3000, d=128, seed=k)
    cp, wp, m = flat_topk.pad_corpus(c, w, multiple=1024)
    jvals, jidx = flat_search_jax(q, cp, wp, m, k=k, method=method)
    jvals, jidx = np.asarray(jvals), np.asarray(jidx)
    scores = (q @ c.T) * w[None, :]
    for fn in (fused_search, flat_topk.flat_search):
        vals, idx = fn(t(q), t(cp), t(wp), t(m), k=k, method=method)
        assert idx.dtype == torch.int32 and tuple(vals.shape) == (16, k)
        _assert_same_topk(vals.numpy(), idx.numpy(), jvals, jidx, scores)


def test_no_launch_on_cpu():
    q, c, w = make_problem(b=8, n=1024, d=64)
    cp, wp, m = flat_topk.pad_corpus(c, w)
    before = fused_weighted_scores.launches
    fused_search(t(q), t(cp), t(wp), t(m), k=5)
    fused_weighted_scores(t(q), t(cp), t(wp), t(m), exact=False)
    assert fused_weighted_scores.launches == before == 0


def test_unported_and_bad_inputs_raise():
    q, c, w = make_problem(b=8, n=1024, d=64)
    cp, wp, m = flat_topk.pad_corpus(c, w)
    with pytest.raises(ValueError, match="use exact, approx or streaming"):
        fused_search(t(q), t(cp), t(wp), t(m), k=5, method="bogus")
    with pytest.raises(ValueError):
        fused_weighted_scores(t(q[:, :32]), t(cp), t(wp), t(m))
    with pytest.raises(ValueError):
        fused_weighted_scores(t(q), t(cp), t(wp[:-1]), t(m))


@pytest.mark.parametrize("b", [1, 2, 16, 17, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
def test_fused_score_plan_routing(b, dtype, exact):
    """One K1 path per (B, dtype) at the served shape: a bf16 corpus takes
    "mma" at every B (16- to 128-query tiles, one bf16 pass); an fp32
    corpus "stream" up to 16 queries (2 blocks on each of 132 SMs) and
    "tile" above, in either mode."""
    plan = fused_score_plan(b, 40960, 768, dtype, exact, sm_count=132)
    if dtype == torch.bfloat16:
        tile = 16 if b <= 16 else 32 if b <= 32 else 64 if b <= 64 else 128
        assert plan == ScorePlan("mma", True, tile_rows=tile)
    elif b <= 16:
        assert plan == ScorePlan("stream", not exact, blocks=264)
    else:
        assert plan == ScorePlan("tile", not exact)


@pytest.mark.parametrize("b,n,d,path,blocks", [
    (16, 40960, 768, "stream", 264),   # 112 KB a block: 2 per SM
    (2, 40960, 1536, "stream", 264),
    (16, 40960, 1536, "stream", 132),  # 160 KB a block: 1 per SM
    (16, 40960, 2608, "stream", 132),  # 227 KB, the most a block may take
    (16, 40960, 2616, "tile", 0),      # the query block does not fit
    (1, 1000, 72, "stream", 32),       # ragged N: ceil(1000 / 32) groups
    (8, 2500, 1536, "stream", 79),
])
def test_fused_score_plan_fits_shared_memory(b, n, d, path, blocks):
    """"stream" keeps 2 blocks per SM where two blocks' rings and fp32
    query blocks fit in an SM, 1 where only one fits, never more blocks
    than 32-row groups (the last one ragged), and sends a D whose query
    block exceeds a block's shared memory to "tile"."""
    plan = fused_score_plan(b, n, d, torch.float32, True, sm_count=132)
    assert (plan.path, plan.blocks) == (path, blocks)


def test_fused_score_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        fused_score_plan(2, 40960, 768, torch.int8, True, sm_count=132)


@pytest.mark.parametrize("flag", [True, False])
def test_plain_versions_leave_the_tf32_flag(flag):
    """The plain versions turn TF32 off only around their own matmul and
    restore the process's setting, also when the guard nests."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = flag
    try:
        q, c, w = make_problem(b=4, n=1024, d=64)
        q, c, w = t(q), t(c), t(w)
        flat_topk.weighted_scores_reference(q, c, w)
        flat_topk.weighted_scores_reference(q, c, w, exact=False)
        flat_topk.weighted_scores_reference(q, c.to(torch.bfloat16), w)
        chunk_stream.chunk_maxima_reference(q, c * w[:, None])
        ids = torch.tensor([[0, 3]] * 4, dtype=torch.int32)
        chunk_stream.gather_rescore_reference(q, c, ids)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        with flat_topk.ieee_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            with flat_topk.ieee_fp32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_ieee_fp32_guard_under_threads():
    """Threads that overlap inside the guard never see TF32 back on (a
    plain save and restore per call would turn it on under another
    thread's matmul), and the flag is restored after the last leaves."""
    saved_flag, saved_switch = torch.backends.cuda.matmul.allow_tf32, sys.getswitchinterval()
    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    seen_on = []
    start = threading.Barrier(16)

    def work():
        start.wait(timeout=60)
        for _ in range(2000):
            with flat_topk.ieee_fp32():
                if torch.backends.cuda.matmul.allow_tf32:
                    seen_on.append(1)

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert not seen_on
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        sys.setswitchinterval(saved_switch)
        torch.backends.cuda.matmul.allow_tf32 = saved_flag
