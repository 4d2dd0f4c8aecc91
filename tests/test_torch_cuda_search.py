"""The search methods that launch K1 and K2 on new paths, and the int8
product, against their plain versions on a card.

These tests need an NVIDIA GPU and nvcc; they carry the ``gpu`` marker
and skip elsewhere. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_search.py -m gpu --noconftest -q

- ``chunk_select_search`` in each scan precision (K1: IEEE fp32 for
  "highest" and "high", the bf16 corpus on "mma" for "bf16") against
  ``chunk_select_search_reference`` (the same selection over K1's plain
  version): values within 5e-5 (fp32 sums of D products in two orders,
  tests/test_torch_cuda_kernels.py's tolerance), the same ids up to ties
  within it, and the same certificates away from the bound.
- ``bf16_rerank_search`` (K2 with ``exact=False``) at top_k 50 with the
  orchestrator's over-fetch (k = 100, m = 200 > 128, so the ranges run at
  depth 128) against ``bf16_rerank_search_reference``: the re-rank is
  IEEE fp32 on both sides, so the values agree within 5e-5.
- ``int8_matmul`` / ``int8_search`` on the card (``torch._int_mm``)
  against the CPU's int32 matmul: accumulators bit for bit, and the
  elementwise epilogue bit for bit too.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.ops.flat_topk import pad_corpus
from rag_icd10_tpu_torch.ops.fused_score import (
    fused_weighted_scores,
    streaming_candidates,
)
from rag_icd10_tpu_torch.ops.quantized import (
    int8_matmul,
    int8_scores,
    int8_search,
    int8_search_device_rerank,
    quantize_rows,
)
from rag_icd10_tpu_torch.ops.rerank import (
    bf16_rerank_search,
    bf16_rerank_search_reference,
    chunk_select_search,
    chunk_select_search_reference,
)

TOL = 5e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(b, n_real, d, seed, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((n_real, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    w = np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n_real)]
    cp, wp, m = pad_corpus(c, w, multiple=1024)
    return [torch.from_numpy(x).to(dev) for x in (q, cp, wp, m)]


def _same_up_to_ties(got_v, got_i, want_v, want_i, what):
    """Values within TOL; an id in one result and not the other scores
    within TOL of the k-th (a tie at the boundary)."""
    assert torch.allclose(got_v, want_v, atol=TOL, rtol=0), what
    for gv, gi, wv, wi in zip(got_v, got_i, want_v, want_i):
        g, w = dict(zip(gi.tolist(), gv.tolist())), dict(zip(wi.tolist(), wv.tolist()))
        for j in g.keys() ^ w.keys():
            assert abs(g.get(j, w.get(j)) - float(wv[-1])) <= TOL, (what, j)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("b,k", [(2, 20), (8, 10), (17, 50), (64, 100)])
def test_chunk_select_matches_plain(cuda, precision, b, k):
    q, c, w, m = _problem(b, 40474 if b <= 8 else 9000, 768, seed=b, dev=cuda)
    scan = c.to(torch.bfloat16) if precision == "bf16" else c
    kwargs = dict(k=k, corpus_f32=c, scan_precision=precision, guarantee=False)
    before = fused_weighted_scores.launches
    got_v, got_i, got_c = chunk_select_search(q, scan, w, m, **kwargs)
    assert fused_weighted_scores.launches == before + 1  # the scan ran on K1
    want_v, want_i, want_c = chunk_select_search_reference(q, scan, w, m, **kwargs)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int32 and tuple(got_v.shape) == (b, k)
    _same_up_to_ties(got_v, got_i, want_v, want_i, precision)
    assert torch.equal(got_c, want_c)
    if b <= 8 and precision != "bf16":  # 320 chunks, mc = max(4k, k + 30)
        assert bool(got_c.all())  # random rows certify without a margin to beat
    assert int(got_i.max()) < c.shape[0] and bool(torch.isfinite(got_v).all())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_chunk_select_ties_redo_exactly(cuda, precision):
    """Near-identical rows de-certify the "high" and "bf16" margins, and
    guarantee=True redoes the batch on the exact K1 path; "highest" fetches
    all 16 chunks (mc = 40), and its k-th (k <= 16) never falls below the
    smallest chunk maximum, so it certifies and is exact as it stands."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal(128).astype(np.float32)
    base /= np.linalg.norm(base)
    rows = base + 1e-8 * rng.standard_normal((2048, 128)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    cp, wp, mp = pad_corpus(rows, np.ones(2048, np.float32), multiple=1024)
    c, w, m = (torch.from_numpy(x).to(cuda) for x in (cp, wp, mp))
    q = torch.from_numpy(base[None, :]).to(cuda)
    scan = c.to(torch.bfloat16) if precision == "bf16" else c
    vals, _, cert = chunk_select_search(
        q, scan, w, m, k=10, corpus_f32=c, scan_precision=precision)
    exact = torch.topk(q @ c.T, 10, dim=1).values
    assert bool(cert.all()) if precision == "highest" else not bool(cert.any())
    assert torch.allclose(vals, exact, atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [2, 8, 64])
def test_bf16_rerank_top50_overfetch_matches_plain(cuda, b):
    q, c, w, m = _problem(b, 40474, 768, seed=100 + b, dev=cuda)
    c16 = c.to(torch.bfloat16)
    before = streaming_candidates.launches
    got_v, got_i, got_c = bf16_rerank_search(q, c16, c, w, m, k=100, guarantee=False)
    assert streaming_candidates.launches == before + 1  # K2 ran
    want_v, want_i, want_c = bf16_rerank_search_reference(
        q, c16, c, w, m, k=100, guarantee=False)
    torch.cuda.synchronize()
    _same_up_to_ties(got_v, got_i, want_v, want_i, f"bf16 rerank B={b}")
    assert torch.equal(got_c, want_c)
    exact = torch.topk(fused_weighted_scores(q, c, w, m), 100, dim=1).values
    certified = got_c.nonzero().flatten()
    assert torch.allclose(got_v[certified], exact[certified], atol=TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 17, 64])
@pytest.mark.parametrize("n,d", [(4096, 768), (1000, 100)])
def test_int8_product_bit_equal_to_cpu(cuda, b, n, d):
    """torch._int_mm takes B > 16 and multiples of 8: B, D (100) and N
    (1000 is one) pad with zeros, which add nothing to an integer sum."""
    rng = np.random.default_rng(b + n)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q, rows = q / q.norm(dim=1, keepdim=True), rows / rows.norm(dim=1, keepdim=True)
    qi, _ = quantize_rows(q)
    ci, cs = quantize_rows(rows)
    before = int8_matmul.launches
    got = int8_matmul(qi.to(cuda), ci.to(cuda))
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n)
    assert torch.equal(got.cpu(), int8_matmul(qi, ci))
    w = torch.from_numpy(np.array([1.2, 1.0, 0.8], np.float32)[rng.integers(0, 3, n)])
    mask = torch.zeros(n)
    args_cpu = (q, ci, cs, w, mask)
    args_gpu = tuple(t.to(cuda) for t in args_cpu)
    assert torch.equal(int8_scores(*args_gpu).cpu(), int8_scores(*args_cpu))
    k = min(10, n)
    gv, _ = int8_search(*args_gpu, k=k)
    cv, _ = int8_search(*args_cpu, k=k)
    assert torch.equal(gv.cpu(), cv)
    rv, _ = int8_search_device_rerank(*args_gpu, k=k)
    pv, _ = int8_search_device_rerank(*args_cpu, k=k)
    assert torch.allclose(rv.cpu(), pv, atol=TOL, rtol=0)
