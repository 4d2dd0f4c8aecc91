"""Scoring-kernel module parity: rag_icd10_tpu_torch.ops against the JAX
package's ops on the same numpy inputs.

On the CPU the port's ``fused_weighted_scores`` computes its plain
version (the CUDA kernel cannot run here); the JAX side runs its Pallas
kernel in interpret mode exactly as tests/test_flat_search.py does.
Tolerances: fp32 atol 1e-5 (IEEE fp32 on both sides, sums in different
orders over D <= 128 unit-vector products); bf16 corpus atol/rtol 2e-2.

The kernel itself runs only on a card: tests/test_torch_cuda_kernels.py.
"""

from unittest import mock

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops.flat_topk import flat_search_jax
from rag_icd10_tpu.ops.flat_topk import pad_corpus as pad_corpus_jax
from rag_icd10_tpu.ops.pallas_score import fused_weighted_scores as fused_jax
from rag_icd10_tpu_torch.ops import flat_topk
from rag_icd10_tpu_torch.ops.fused_score import fused_search, fused_weighted_scores

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
