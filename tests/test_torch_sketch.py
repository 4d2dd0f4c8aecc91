"""The host capacity tier's screen: the port's ops/sketch.py against the
JAX package's, on the CPU.

- ``fit_projection`` is the same numpy code: the basis is bit-equal.
- ``build_sketch`` projects on the store's device with torch (IEEE fp32)
  where the JAX package projects with numpy: the projected values can
  differ in the last bits, so a sketch entry may land one int8 step
  away where a value sits on a rounding boundary. Tolerance: |diff| <= 1
  in at most 0.1% of entries, scales within 1e-5 relative.
- The screen selects approximately on both sides: candidate sets overlap
  >= 0.98 (tests/test_sketch.py's bound for its own chunked screen).
- The chunked screen equals the one-scan screen bit for bit in its
  values (the same integers through the same epilogue), ids up to ties.
- The host re-rank returns exact fp32 scores of the returned rows (within
  1e-5 of numpy's) and, over the same candidates, JAX's hits.
"""

import numpy as np
import pytest
import torch

from rag_icd10_tpu.ops import sketch as jsk
from rag_icd10_tpu_torch.ops import sketch as tsk

torch.set_num_threads(2)  # the suite runs several test processes at once


def clustered(n, d, n_clusters=64, seed=0, b=8):
    """tests/test_sketch.py's geometry: unit centers + sigma-0.5 noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    v = centers[rng.integers(0, n_clusters, n)] + (
        0.5 * rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    w = np.array([0.8, 1.0, 1.2], np.float32)[rng.integers(0, 3, n)]
    q = centers[rng.integers(0, n_clusters, b)] + (
        0.5 * rng.standard_normal((b, d)).astype(np.float32) / np.sqrt(d)
    )
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return v, w, q


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.mean([len(set(ra) & set(rb)) / len(ra) for ra, rb in zip(a, b)])


@pytest.mark.parametrize("kind", ["pca", "random"])
def test_projection_bit_equal_to_jax(kind):
    v = clustered(2048, 128)[0]
    np.testing.assert_array_equal(
        tsk.fit_projection(v, 32, kind=kind), jsk.fit_projection(v, 32, kind=kind)
    )
    with pytest.raises(ValueError, match="projection kind"):
        tsk.fit_projection(v, 16, kind="umap")


@pytest.mark.parametrize("kind,d_sketch", [("pca", 32), ("random", 48)])
def test_build_matches_jax(kind, d_sketch):
    v, w, _ = clustered(3000, 96, seed=1)
    j = jsk.build_sketch(v, w, d_sketch=d_sketch, kind=kind, pad_multiple=128)
    t = tsk.build_sketch(v, w, d_sketch=d_sketch, kind=kind, pad_multiple=128, device="cpu")
    np.testing.assert_array_equal(t.proj, j.proj)
    assert (t.n_real, t.d_sketch, t.screen_chunk) == (j.n_real, j.d_sketch, j.screen_chunk)
    assert t.device_bytes == j.device_bytes == 3072 * (d_sketch + 12)
    diff = np.abs(t.sketch_q.numpy().astype(np.int32) - np.asarray(j.sketch_q).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(t.sketch_scale.numpy(), np.asarray(j.sketch_scale), rtol=1e-5)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))


def test_tensor_rows_build_the_sketch_of_host_rows():
    """A corpus made on the device (a tensor) builds the same screen as
    the same rows handed over from the host."""
    v, w, _ = clustered(2000, 64, seed=2)
    a = tsk.build_sketch(v, w, d_sketch=16, pad_multiple=128, device="cpu")
    b = tsk.build_sketch(torch.from_numpy(v), torch.from_numpy(w), d_sketch=16,
                         pad_multiple=128)
    np.testing.assert_array_equal(a.proj, b.proj)
    assert torch.equal(a.sketch_q, b.sketch_q) and torch.equal(a.sketch_scale, b.sketch_scale)


def test_screen_matches_jax():
    v, w, q = clustered(4096, 128, seed=3)
    j = jsk.build_sketch(v, w, d_sketch=32, pad_multiple=128)
    t = tsk.build_sketch(v, w, d_sketch=32, pad_multiple=128, device="cpu")
    got = tsk.sketch_screen(t, q, 64)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 64)
    assert _overlap(got, jsk.sketch_screen(j, q, 64)) >= 0.98


@pytest.mark.parametrize("m", [64, 1024])
def test_chunked_screen_equals_one_scan(m):
    """screen_chunk > 0 (here 512 rows, below and above m) merges a
    running top-m: the values equal the one-scan screen's bit for bit,
    and the JAX package's chunked screen picks the same candidates."""
    v, w, q = clustered(4096, 96, seed=5)
    flat = tsk.build_sketch(v, w, d_sketch=32, kind="random", pad_multiple=128,
                            screen_chunk=0, device="cpu")
    chunked = tsk.build_sketch(v, w, d_sketch=32, kind="random", pad_multiple=128,
                               screen_chunk=512, proj=flat.proj, device="cpu")
    assert chunked.screen_chunk == 512 and chunked.sketch_q.shape[0] % 512 == 0
    fv, fi = tsk.sketch_screen_scores(flat, q, m)
    cv, ci = tsk.sketch_screen_scores(chunked, q, m)
    assert torch.equal(fv, cv)
    for vals, a, b in zip(cv, fi, ci):
        for j in set(a.tolist()) ^ set(b.tolist()):  # only ties at the m-th
            assert int((vals == vals[-1]).sum()) > 1, j
    jchunked = jsk.build_sketch(v, w, d_sketch=32, kind="random", pad_multiple=128,
                                screen_chunk=512, proj=flat.proj)
    assert _overlap(ci, jsk.sketch_screen(jchunked, q, m)) >= 0.98


def test_auto_screen_chunk():
    v, w, _ = clustered(512, 32, seed=8)
    small = tsk.build_sketch(v, w, d_sketch=16, kind="random", pad_multiple=128, device="cpu")
    assert small.screen_chunk == 0  # one scan below 2^20 rows


def test_host_rerank_matches_jax_and_scores_exactly():
    v, w, q = clustered(4096, 128, seed=6)
    j = jsk.build_sketch(v, w, d_sketch=32, pad_multiple=128)
    t = tsk.build_sketch(v, w, d_sketch=32, pad_multiple=128, device="cpu")
    tv, ti = tsk.sketch_search_host_rerank(t, v, w, q, k=10)
    jv, ji = jsk.sketch_search_host_rerank(j, v, w, q, k=10)
    gt = (q @ v.T) * w[None, :]
    np.testing.assert_allclose(tv, np.take_along_axis(gt, ti, axis=1), rtol=0, atol=1e-5)
    assert ti.max() < t.n_real and ti.dtype == np.int32
    # the same 80 candidates re-rank to the same hits; the screens may
    # differ by a near-tie at the 80th
    assert _overlap(ti, ji) >= 0.98
    same = [set(a) == set(b) for a, b in zip(ti, ji)]
    np.testing.assert_allclose(tv[same], np.asarray(jv)[same], rtol=0, atol=1e-5)
    # queries handed over as tensors give the same hits
    tv2, ti2 = tsk.sketch_search_host_rerank(t, v, w, torch.from_numpy(q), k=10)
    np.testing.assert_array_equal(ti2, ti)


def test_fetch_floors_at_k():
    v, w, q = clustered(1024, 64, seed=7)
    t = tsk.build_sketch(v, w, d_sketch=16, pad_multiple=128, device="cpu")
    vals, idx = tsk.sketch_search_host_rerank(t, v, w, q, k=16, m=4)
    assert idx.shape == (8, 16) and np.isfinite(vals).all()


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    v, w, _ = clustered(256, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsk.build_sketch(v, w, d_sketch=8, pad_multiple=128)
