"""The int8 residency tier: the port's ops/quantized.py against the JAX
package's, on the CPU.

- The int32 accumulators are exact integers: given the same int8
  operands, the port's product (an int32 matmul on the CPU) equals
  ``jax.lax.dot_general(..., preferred_element_type=int32)`` bit for bit.
- The query quantization follows ``quantize_rows``'s IEEE law. The JAX
  package spells the query scale ``q_absmax / 127.0`` inside ``jit``,
  where XLA may multiply by the reciprocal: scales within 1 ulp, int8
  values within 1, and identical where the scales are.
- ``int8_search`` and ``int8_search_device_rerank``: values within 1e-5
  for queries quantized alike (the same integers through the same fp32
  epilogue association; the device re-rank sums D = 64 fp32 products in
  two orders), and index sets equal up to near-ties: an id in one result
  only scores within the tolerance of the k-th. A query whose int8 values
  differ by one in an element moves its scores by at most
  127 * q_scale * c_scale * w (about 1e-3 here), the near-tie allowance.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops import quantized as jq
from rag_icd10_tpu.ops.flat_topk import pad_corpus
from rag_icd10_tpu_torch.ops import quantized as tq

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL = 1e-5
NEAR_TIE = 2e-3


def _problem(b, n_real, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((n_real, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    w = np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n_real)]
    cp, wp, m = pad_corpus(c, w, multiple=128)
    c8, cs = jq.quantize_rows(cp)
    return q, cp, c8, cs, wp, m


@partial(jax.jit)
def _jax_query_quant(q):
    """int8_search's query quantization, as the JAX package writes it."""
    q_absmax = jnp.max(jnp.abs(q), axis=1)
    q_scale = jnp.where(q_absmax > 0, q_absmax / 127.0, 1.0)
    q_i8 = jnp.clip(jnp.round(q / q_scale[:, None]), -127, 127).astype(jnp.int8)
    return q_i8, q_scale


def _same_rows(q):
    """Rows the two packages quantize alike."""
    ti, ts = tq.quantize_rows(torch.from_numpy(q))
    ji, js = _jax_query_quant(q)
    return (ti.numpy() == np.asarray(ji)).all(axis=1) & (ts.numpy() == np.asarray(js))


def _assert_close_up_to_ties(got_v, got_i, want_v, want_i, alike):
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    for row, same in enumerate(alike):
        tol = TOL if same else NEAR_TIE
        np.testing.assert_allclose(got_v[row], want_v[row], rtol=0, atol=tol)
        g = dict(zip(got_i[row].tolist(), got_v[row].tolist()))
        w = dict(zip(want_i[row].tolist(), want_v[row].tolist()))
        for j in g.keys() ^ w.keys():
            assert abs(g.get(j, w.get(j)) - want_v[row, -1]) <= tol, (row, j)


@pytest.mark.parametrize("b", [1, 5, 17, 64])
@pytest.mark.parametrize("d", [64, 100])
def test_accumulators_bit_equal_to_jax(b, d):
    rng = np.random.default_rng(b * d)
    a8, _ = jq.quantize_rows(rng.standard_normal((b, d)).astype(np.float32))
    c8, _ = jq.quantize_rows(rng.standard_normal((300, d)).astype(np.float32))
    want = jax.lax.dot_general(
        a8, c8, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    got = tq.int8_matmul(torch.from_numpy(a8), torch.from_numpy(c8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_query_quantization_within_one_ulp_of_jax():
    q = np.random.default_rng(3).standard_normal((512, 64)).astype(np.float32)
    q[7] = 0.0  # an all-zero row takes scale 1
    ti, ts = tq.quantize_rows(torch.from_numpy(q))
    ji, js = _jax_query_quant(q)
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    assert ts[7] == 1.0 and int(ti[7].abs().max()) == 0
    diff = np.abs(ti.numpy().astype(np.int32) - np.asarray(ji).astype(np.int32))
    assert diff.max() <= 1
    same = ts.numpy() == np.asarray(js)
    assert (diff[same] == 0).all()  # the same scale gives the same integers


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("b,k,seed", [(8, 10, 0), (3, 1, 1), (17, 40, 2)])
def test_int8_search_matches_jax(method, b, k, seed):
    q, cp, c8, cs, wp, m = _problem(b, 1500, 64, seed)
    jv, ji = jq.int8_search(q, c8, cs, wp, m, k=k, method=method)
    args = [torch.from_numpy(x) for x in (q, c8, cs, wp, m)]
    tv, ti = tq.int8_search(*args, k=k, method=method)
    assert ti.dtype == torch.int32 and tuple(tv.shape) == (b, k)
    _assert_close_up_to_ties(tv, ti, jv, ji, _same_rows(q))
    assert int(ti.max()) < 1500  # padding rows never win


@pytest.mark.parametrize("b,k,seed", [(8, 10, 3), (4, 25, 4)])
def test_device_rerank_matches_jax(b, k, seed):
    q, cp, c8, cs, wp, m = _problem(b, 2000, 64, seed)
    jv, ji = jq.int8_search_device_rerank(q, c8, cs, wp, m, k=k)
    args = [torch.from_numpy(x) for x in (q, c8, cs, wp, m)]
    tv, ti = tq.int8_search_device_rerank(*args, k=k)
    _assert_close_up_to_ties(tv, ti, jv, ji, _same_rows(q))
    # the re-rank scores the full-precision query against the dequantized
    # rows: within the rows' own quantization error of the fp32 scores
    exact = (q @ cp[ti.numpy()].transpose(0, 2, 1)).diagonal(axis1=0, axis2=1).T
    exact = exact * wp[ti.numpy()]
    np.testing.assert_allclose(tv.numpy(), exact, rtol=0, atol=1e-2)


def test_scores_keep_the_jax_association():
    """acc * q_scale * (scale * w) + mask, in that order: bit for bit the
    numpy spelling of the same association."""
    q, cp, c8, cs, wp, m = _problem(6, 700, 64, 5)
    args = [torch.from_numpy(x) for x in (q, c8, cs, wp, m)]
    got = tq.int8_scores(*args).numpy()
    qi, qs = tq.quantize_rows(q)
    acc = (qi.astype(np.int64) @ c8.astype(np.int64).T).astype(np.float32)
    want = acc * qs[:, None] * (cs * wp)[None, :] + m[None, :]
    np.testing.assert_array_equal(got, want)


def test_int8_matmul_refuses_what_it_does_not_take():
    a = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8 operands"):
        tq.int8_matmul(a.float(), a)
    with pytest.raises(ValueError, match="inner dimensions"):
        tq.int8_matmul(a, torch.zeros((3, 16), dtype=torch.int8))
    with pytest.raises(ValueError, match="method"):
        tq.int8_search(torch.zeros((1, 8)), a, torch.ones(2), torch.ones(2),
                       torch.zeros(2), k=1, method="fast")


@pytest.mark.parametrize("shape,to", [((3, 100), (24, 104)), ((24, 104), (24, 104))])
def test_pad_to_adds_zeros_only(shape, to):
    """The card's product pads B to >= 24 and D, N to multiples of 8 with
    zeros (``_pad_to``); a padded product cut back is the unpadded one."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    p = tq._pad_to(a, *to)
    assert tuple(p.shape) == to and torch.equal(p[: shape[0], : shape[1]], a)
    assert int(p.abs().sum()) == int(a.abs().sum())
    b = torch.from_numpy(rng.integers(-127, 128, (40, shape[1])).astype(np.int8))
    full = tq.int8_matmul(p, tq._pad_to(b, 40, to[1]))[: shape[0]]
    assert torch.equal(full, tq.int8_matmul(a, b))
