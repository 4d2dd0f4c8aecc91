"""The hand-written CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and nvcc; they carry the ``gpu`` marker
and skip elsewhere. The file imports neither JAX nor the JAX package, so
it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda_kernels.py -m gpu --noconftest -q

Tolerance 5e-5: the kernel sums D products sequentially in fp32 (fmaf),
the plain version in cuBLAS's order; for unit vectors at D = 768 the
worst-case difference of two fp32 sums is below that.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
from rag_icd10_tpu_torch.ops.fused_score import fused_search, fused_weighted_scores


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


@pytest.mark.gpu
def test_fused_score_rejects_bad_inputs(cuda):
    q, c, w, m = _problem(4, 256, 64, seed=1, dev=cuda)
    with pytest.raises(TypeError):
        fused_weighted_scores(q, c.half(), w, m)
    with pytest.raises(ValueError):
        fused_weighted_scores(q, c.t().contiguous().t(), w, m)
    with pytest.raises(ValueError):
        fused_weighted_scores(q.cpu(), c, w, m)
