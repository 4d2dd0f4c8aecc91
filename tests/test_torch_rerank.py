"""Certified search from a cheap scan + re-rank: the port's ops/rerank.py
against the JAX package's, on the CPU.

Seeded numpy inputs go through ``chunk_select_search`` and
``bf16_rerank_search`` of both packages in one process, following
tests/test_rerank.py. On the CPU the port's scans compute the kernels'
plain versions (K1's for the chunk select, K2's range layout for the
bf16 re-rank) and the JAX package's its XLA spellings (its "high" scan is
plain fp32 off the TPU), so:

- values agree within 1e-5 (fp32 sums of D = 128 products in different
  orders, and the same IEEE fp32 re-rank);
- index sets agree up to ties within that tolerance at the k-th;
- certificates agree (the random problems certify, the adversarial ones
  de-certify on both sides), and ``guarantee=True`` gives the exact
  result either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops import rerank as jrerank
from rag_icd10_tpu.ops.flat_topk import pad_corpus, topk_reference
from rag_icd10_tpu_torch.ops import rerank
from rag_icd10_tpu_torch.ops.fused_score import slot_count

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL = 1e-5


def make_problem(b=8, n_real=3000, d=128, seed=0, multiple=1024):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((n_real, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    levels = rng.integers(1, 4, size=n_real)
    w = np.array([1.2, 1.0, 0.8], dtype=np.float32)[levels - 1]
    cp, wp, m = pad_corpus(c, w, multiple=multiple)
    expected = (q @ c.T) * w[None, :]
    return q, c, w, cp, wp, m, expected


def near_identical(seed, noise, n_real=2048, d=128):
    """One query and rows within ``noise`` of it: every score within a
    hair of every other."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32)
    base /= np.linalg.norm(base)
    c = base[None, :] + noise * rng.standard_normal((n_real, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    cp, wp, m = pad_corpus(c, np.ones(n_real, np.float32), multiple=1024)
    q = base[None, :].copy()
    return q, c, cp, wp, m, q @ c.T


def T(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def assert_same_up_to_ties(got_v, got_i, want_v, want_i, tol=TOL):
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=tol)
    for gv, gi, wv, wi in zip(got_v, got_i, want_v, want_i):
        g, w = dict(zip(gi.tolist(), gv.tolist())), dict(zip(wi.tolist(), wv.tolist()))
        for j in g.keys() ^ w.keys():  # differs only on a tie at the k-th
            assert abs(g.get(j, w.get(j)) - wv[-1]) <= tol, j


def test_constants_match_jax():
    assert rerank.EPS_BF16_DOT == jrerank.EPS_BF16_DOT
    assert rerank.EPS_HIGH_DOT == jrerank.EPS_HIGH_DOT


@pytest.mark.parametrize("d", [64, 768, 1024, 1536, 4096])
def test_eps_bf16_dot_covers_tensor_core_accumulation(d):
    """eps_bf16_dot(d) is the JAX constant up to d = 1024 and grows past
    it by the operand rounding, chunk_stream.eps_tc_dot's accumulation
    model and the re-rank's own fp32 rounding."""
    from rag_icd10_tpu_torch.ops.chunk_stream import eps_tc_dot

    eps = rerank.eps_bf16_dot(d)
    assert eps >= rerank.EPS_BF16_DOT
    assert (eps == rerank.EPS_BF16_DOT) == (d <= 1024)
    operands = 2 * 2.0 ** -9 + 2.0 ** -18
    assert eps >= operands + eps_tc_dot(d) - (d + 2) * 2.0 ** -24 + (d + 1) * 2.0 ** -24


@pytest.mark.parametrize("d", [128, 768, 1536])
def test_bf16_bound_is_sound(d):
    """Measured |bf16 dot - fp32 dot| for random unit vectors sits below
    eps_bf16_dot(d), and within 20x of it."""
    rng = np.random.default_rng(11 + d)
    q = T(rng.standard_normal((16, d)).astype(np.float32))
    c = T(rng.standard_normal((2048, d)).astype(np.float32))
    q = q / q.norm(dim=1, keepdim=True)
    c = c / c.norm(dim=1, keepdim=True)
    exact = (q.double() @ c.double().T)
    approx = (q.bfloat16().float() @ c.bfloat16().float().T).double()
    err = float((approx - exact).abs().max())
    assert err < rerank.eps_bf16_dot(d) < max(err, 1e-4) * 20


class TestChunkSelectParity:
    @pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
    @pytest.mark.parametrize("b,k,seed", [(8, 10, 0), (3, 1, 5), (5, 50, 7)])
    def test_matches_jax(self, precision, b, k, seed):
        q, c, w, cp, wp, m, expected = make_problem(b=b, seed=seed)
        if precision == "bf16":
            jscan, tscan = jnp.asarray(cp).astype(jnp.bfloat16), T(cp, torch.bfloat16)
        else:
            jscan, tscan = cp, T(cp)
        jv, ji, jc = jrerank.chunk_select_search(
            q, jscan, wp, m, k=k, corpus_f32=jnp.asarray(cp),
            scan_precision=precision, guarantee=False,
        )
        tv, ti, tc = rerank.chunk_select_search(
            T(q), tscan, T(wp), T(m), k=k, corpus_f32=T(cp),
            scan_precision=precision, guarantee=False,
        )
        assert ti.dtype == torch.int32 and tuple(tv.shape) == (b, k)
        assert_same_up_to_ties(tv, ti, jv, ji)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert bool(tc.all())  # spread data certifies
        evals, _ = topk_reference(expected, k)
        np.testing.assert_allclose(tv.numpy(), evals, rtol=0, atol=TOL)

    @pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
    def test_reference_is_the_wrapper_on_cpu(self, precision):
        q, c, w, cp, wp, m, _ = make_problem(seed=3)
        scan = T(cp, torch.bfloat16) if precision == "bf16" else T(cp)
        args = (T(q), scan, T(wp), T(m))
        kw = dict(k=10, corpus_f32=T(cp), scan_precision=precision)
        for got, want in zip(rerank.chunk_select_search(*args, **kw),
                             rerank.chunk_select_search_reference(*args, **kw)):
            assert torch.equal(got, want)

    @pytest.mark.parametrize("precision,noise", [("bf16", 1e-7), ("high", 1e-8)])
    def test_ties_decertify_and_fall_back_exactly(self, precision, noise):
        """Near-identical rows: the bf16 and 2 eps HIGH margins refuse on
        both sides; guarantee=True still returns the exact values."""
        q, c, cp, wp, m, expected = near_identical(9 if precision == "bf16" else 13, noise)
        jscan = jnp.asarray(cp).astype(jnp.bfloat16) if precision == "bf16" else cp
        tscan = T(cp, torch.bfloat16) if precision == "bf16" else T(cp)
        jv, _, jc = jrerank.chunk_select_search(
            q, jscan, wp, m, k=10, corpus_f32=jnp.asarray(cp), scan_precision=precision)
        tv, _, tc = rerank.chunk_select_search(
            T(q), tscan, T(wp), T(m), k=10, corpus_f32=T(cp), scan_precision=precision)
        assert not bool(tc.any()) and not np.asarray(jc).any()
        evals, _ = topk_reference(expected, 10)
        np.testing.assert_allclose(tv.numpy(), evals, rtol=0, atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)

    def test_padding_never_selected(self):
        q, c, w, cp, wp, m, _ = make_problem(n_real=1100, multiple=1024)
        _, idx, _ = rerank.chunk_select_search(T(q), T(cp), T(wp), T(m), k=10)
        assert int(idx.max()) < 1100

    def test_refuses_what_it_cannot_scan(self):
        q, c, w, cp, wp, m, _ = make_problem(n_real=1000, multiple=1000)
        with pytest.raises(ValueError, match="multiple of chunk"):
            rerank.chunk_select_search(T(q), T(cp), T(wp), T(m), k=5)
        q, c, w, cp, wp, m, _ = make_problem()
        with pytest.raises(ValueError, match="scan_precision"):
            rerank.chunk_select_search(T(q), T(cp), T(wp), T(m), k=5, scan_precision="tf32")
        with pytest.raises(ValueError, match="corpus_f32"):
            rerank.chunk_select_search(
                T(q), T(cp, torch.bfloat16), T(wp), T(m), k=5, scan_precision="bf16")
        with pytest.raises(ValueError, match="fp32 corpus"):
            rerank.chunk_select_search(
                T(q), T(cp, torch.bfloat16), T(wp), T(m), k=5, scan_precision="high")


class TestBf16RerankParity:
    @pytest.mark.parametrize("jax_scan", ["xla", "pallas"])
    def test_matches_jax(self, jax_scan):
        """The JAX package's XLA scan and its slot kernel (interpret mode)
        against the port's range layout: the same exact re-ranked top-k."""
        q, c, w, cp, wp, m, expected = make_problem()
        jv, ji, jc = jrerank.bf16_rerank_search(
            q, jnp.asarray(cp).astype(jnp.bfloat16), cp, wp, m, k=10,
            scan=jax_scan, tile_n=1024, interpret=jax_scan == "pallas",
        )
        tv, ti, tc = rerank.bf16_rerank_search(
            T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m), k=10)
        assert_same_up_to_ties(tv, ti, jv, ji)
        assert bool(tc.all()) and np.asarray(jc).all()
        evals, _ = topk_reference(expected, 10)
        np.testing.assert_allclose(tv.numpy(), evals, rtol=0, atol=TOL)

    def test_overfetch_past_the_kernel_depth(self):
        """top_k 50 with the orchestrator's over-fetch: k = 100, m = 200.
        K2 keeps at most 128 per range, so the ranges run at depth 128
        and together hold the 200; the result is JAX's."""
        q, c, w, cp, wp, m, expected = make_problem(b=4, n_real=6000, seed=2)
        n = cp.shape[0]
        assert slot_count(4, n, 128) * 128 >= 200
        jv, ji, _ = jrerank.bf16_rerank_search(
            q, jnp.asarray(cp).astype(jnp.bfloat16), cp, wp, m, k=100, scan="xla")
        tv, ti, tc = rerank.bf16_rerank_search(
            T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m), k=100)
        assert_same_up_to_ties(tv, ti, jv, ji)
        evals, _ = topk_reference(expected, 100)
        np.testing.assert_allclose(tv.numpy(), evals, rtol=0, atol=TOL)

    def test_reference_is_the_wrapper_on_cpu(self):
        q, c, w, cp, wp, m, _ = make_problem(seed=4)
        args = (T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m))
        for got, want in zip(rerank.bf16_rerank_search(*args, k=20),
                             rerank.bf16_rerank_search_reference(*args, k=20)):
            assert torch.equal(got, want)

    def test_adversarial_ties_decertify(self):
        q, c, cp, wp, m, expected = near_identical(3, 1e-6)
        jv, _, jc = jrerank.bf16_rerank_search(
            q, jnp.asarray(cp).astype(jnp.bfloat16), cp, wp, m, k=10)
        tv, _, tc = rerank.bf16_rerank_search(
            T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m), k=10)
        assert not bool(tc.any()) and not np.asarray(jc).any()
        evals, _ = topk_reference(expected, 10)
        np.testing.assert_allclose(tv.numpy(), evals, rtol=0, atol=TOL)
        _, _, raw = rerank.bf16_rerank_search(
            T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m), k=10, guarantee=False)
        assert not bool(raw.any())

    def test_full_fetch_certifies(self):
        q, c, w, cp, wp, m, expected = make_problem(n_real=500, multiple=512)
        tv, _, tc = rerank.bf16_rerank_search(
            T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m), k=5, m=cp.shape[0])
        assert bool(tc.all())
        np.testing.assert_allclose(tv.numpy(), topk_reference(expected, 5)[0], atol=TOL)

    def test_k_above_kernel_depth_raises(self):
        q, c, w, cp, wp, m, _ = make_problem()
        with pytest.raises(ValueError, match="1 <= k <= 128"):
            rerank.bf16_rerank_search(
                T(q), T(cp, torch.bfloat16), T(cp), T(wp), T(m), k=129)

    def test_empty_candidates_never_returned(self):
        """A range with fewer rows than its depth pads its candidates
        with id -1; the re-rank scores them -inf instead of re-scoring
        row 0 under a clamped id."""
        q = T(np.eye(4, dtype=np.float32)[:1])
        rows = T(np.eye(4, dtype=np.float32))
        sidx = torch.tensor([[3, -1, 2, -1]], dtype=torch.int32)
        vals, idx = rerank._exact_rerank(q, rows, torch.ones(4), torch.zeros(4), sidx, 4)
        assert idx[0, :2].tolist() == [3, 2] or idx[0, :2].tolist() == [2, 3]
        assert torch.isneginf(vals[0, 2:]).all() and (idx[0, 2:] == -1).all()
