"""Beyond-device-memory capacity tier: an int8 sketch screen on the device
and the full-width rows in host RAM.

Counterpart of rag_icd10_tpu/ops/sketch.py:

- each corpus row is projected to ``d_sketch`` dims (PCA basis fit on a
  corpus sample, or a seeded orthonormal JL map) and quantized to int8
  with one fp32 scale per row, so the device holds
  ``N x (d_sketch + 12)`` bytes (sketch + scale + weight + mask);
- a query projects on the device and int8-scans the sketch
  (``quantized.int8_search``, the int8 tier's product) for the top-``m``
  candidates;
- only those ``m`` candidate ROWS are gathered from the host-resident
  fp32 matrix and re-ranked exactly (fp32 weighted inner product).

Contract: candidate SELECTION is approximate (screen recall is measured,
not asserted); returned SCORES are exact fp32 weighted scores of the true
rows, the HNSW path's contract. Served with STORE_DEVICE_DTYPE=host (the
host matrix is the only full-width copy) or per request with
``method="sketch"`` on any resident store.

The projection basis is numpy, copied from the JAX package, so both fit
the same basis bit for bit; projection, quantization and screen are
tensors on the store's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .flat_topk import ieee_fp32
from .quantized import int8_matmul, int8_search, quantize_rows
from ..utils.device import resolve_device

Rows = Union[np.ndarray, torch.Tensor]


def fit_projection(
    vectors: np.ndarray,
    d_sketch: int,
    kind: str = "pca",
    seed: int = 0,
    sample: int = 65536,
) -> np.ndarray:
    """Fit a (D, d_sketch) orthonormal projection on the host.

    kind="pca": top right-singular vectors of an (up to ``sample``-row,
    evenly strided) corpus sample — uncentered, because the metric is
    inner product and centering would shift scores. Concentrates the
    screen's 8 bits on the directions the corpus actually uses.
    kind="random": QR-orthonormalized gaussian (JL map) — data-free,
    used when rows stream past once (synthetic benches).
    """
    n, d = vectors.shape
    d_sketch = min(d_sketch, d)
    if kind == "random":
        rng = np.random.default_rng(seed)
        g = rng.standard_normal((d, d_sketch)).astype(np.float32)
        q, _ = np.linalg.qr(g)
        return np.ascontiguousarray(q[:, :d_sketch], dtype=np.float32)
    if kind != "pca":
        raise ValueError(f"unknown sketch projection kind {kind!r}")
    step = max(1, n // max(1, min(sample, n)))
    sub = np.asarray(vectors[::step][:sample], dtype=np.float32)
    # right-singular vectors of the sample row space
    _, _, vt = np.linalg.svd(sub, full_matrices=False)
    basis = vt[:d_sketch].T  # (D, d_sketch)
    if basis.shape[1] < d_sketch:  # degenerate sample rank < d_sketch
        pad = np.zeros((d, d_sketch - basis.shape[1]), dtype=np.float32)
        basis = np.concatenate([basis, pad], axis=1)
    return np.ascontiguousarray(basis, dtype=np.float32)


@dataclass
class SketchStore:
    """Device-resident screen state. ``proj`` is also kept on the host so
    a rebuilt store can check its pairing without a device copy."""

    proj: np.ndarray  # (D, d_sketch) fp32 host copy
    proj_dev: torch.Tensor  # same, on the device
    sketch_q: torch.Tensor  # (N_pad, d_sketch) int8
    sketch_scale: torch.Tensor  # (N_pad,) fp32
    weights: torch.Tensor  # (N_pad,) fp32
    mask: torch.Tensor  # (N_pad,) additive fp32 (0 real / -1e30 pad)
    n_real: int
    d_sketch: int
    # rows per screen step: 0 = one (B, N) int8 scan (fine up to ~1M
    # rows); > 0 = a loop over row chunks with an exact running top-m
    # merge, so the screen's transient is (B, chunk), not (B, N): the
    # (B, N) int32 + fp32 pair is ~2 GB per M rows at B = 256
    screen_chunk: int = 0

    @property
    def device_bytes(self) -> int:
        return int(self.sketch_q.shape[0]) * (self.d_sketch + 12)


def _pca_sample(vectors: Rows, sample: int) -> np.ndarray:
    """``fit_projection``'s strided sample of a host or device matrix, on
    the host (the sample of a sample is itself)."""
    n = vectors.shape[0]
    step = max(1, n // max(1, min(sample, n)))
    sub = vectors[::step][:sample]
    if isinstance(sub, torch.Tensor):
        sub = sub.to(torch.float32).cpu().numpy()
    return np.asarray(sub, dtype=np.float32)


def build_sketch(
    vectors: Rows,
    weights: Rows,
    d_sketch: int = 128,
    kind: str = "pca",
    seed: int = 0,
    pad_multiple: int = 1024,
    proj: Optional[np.ndarray] = None,
    chunk_rows: int = 1_048_576,
    screen_chunk: int = -1,
    device: Union[str, torch.device, None] = None,
) -> SketchStore:
    """Project + quantize the corpus on ``device`` (default: the rows'
    device for a tensor, else ``cuda``), ``chunk_rows`` rows at a time so
    the (N, d_sketch) fp32 intermediate never materializes whole, and
    keep the screen there. ``vectors`` is a host array or a tensor (a
    corpus made on the card never visits the host). ``proj`` overrides
    the fit (pairing a prebuilt basis).

    ``screen_chunk``: rows per search-time screen step; -1 picks 65536
    from 2^20 rows on (where a (B, N) screen would dominate device
    memory), else 0 (one scan). When chunked, padding rounds up to a
    multiple of the chunk, so every step is a whole chunk.
    """
    if device is None:
        device = vectors.device if isinstance(vectors, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    n, d = vectors.shape
    if proj is None:
        src = _pca_sample(vectors, 65536) if kind == "pca" else vectors
        proj = fit_projection(src, d_sketch, kind=kind, seed=seed)
    d_sketch = proj.shape[1]
    if screen_chunk < 0:
        screen_chunk = 65536 if n >= (1 << 20) else 0
    granule = math.lcm(pad_multiple, screen_chunk) if screen_chunk else pad_multiple
    n_pad = ((n + granule - 1) // granule) * granule
    proj_dev = torch.from_numpy(np.ascontiguousarray(proj, np.float32)).to(dev)
    q8 = torch.zeros((n_pad, d_sketch), dtype=torch.int8, device=dev)
    scale = torch.ones((n_pad,), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        rows = torch.as_tensor(vectors[lo:hi]).to(dev, torch.float32)
        with ieee_fp32():
            s = rows @ proj_dev
        q8[lo:hi], scale[lo:hi] = quantize_rows(s)
    wp = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    wp[:n] = torch.as_tensor(weights).to(dev, torch.float32)
    mask = torch.full((n_pad,), -1e30, dtype=torch.float32, device=dev)
    mask[:n] = 0.0
    return SketchStore(
        proj=proj, proj_dev=proj_dev, sketch_q=q8, sketch_scale=scale,
        weights=wp, mask=mask, n_real=n, d_sketch=d_sketch,
        screen_chunk=screen_chunk,
    )


def _screen_chunked(store: SketchStore, z: torch.Tensor, m: int):
    """The int8 screen over row chunks with an exact running top-m merge:
    the same query quantization, product and epilogue as ``int8_search``,
    so every score equals the one-scan screen's bit for bit; after each
    step the running set is the true top-m of the rows scanned so far
    (concatenate + top-k refines it monotonically)."""
    b = z.shape[0]
    chunk = int(store.screen_chunk)
    q_i8, q_scale = quantize_rows(z)
    sw = store.sketch_scale * store.weights
    vals = torch.full((b, m), float("-inf"), device=z.device)
    idx = torch.zeros((b, m), dtype=torch.int32, device=z.device)
    kc = min(m, chunk)
    for c0 in range(0, store.sketch_q.shape[0], chunk):
        c1 = c0 + chunk
        acc = int8_matmul(q_i8, store.sketch_q[c0:c1])
        s = acc.to(torch.float32) * q_scale[:, None] * sw[None, c0:c1] + store.mask[None, c0:c1]
        v, i = torch.topk(s, kc, dim=1)
        vals, sel = torch.topk(torch.cat([vals, v], dim=1), m, dim=1)
        idx = torch.gather(torch.cat([idx, i.to(torch.int32) + c0], dim=1), 1, sel)
    return vals, idx


def sketch_screen_scores(
    store: SketchStore, queries: Rows, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device screen: project the (B, D) queries onto the sketch basis
    (IEEE fp32) and int8-scan for the top-m screen (scores (B, m) fp32,
    indices (B, m) int32), on the store's device. Takes host or device
    queries. ``screen_chunk`` > 0 takes the chunked scan."""
    m = min(m, store.n_real)
    q = torch.as_tensor(queries).to(store.proj_dev.device, torch.float32)
    with ieee_fp32():
        z = q @ store.proj_dev
    if store.screen_chunk:
        return _screen_chunked(store, z, m)
    return int8_search(
        z, store.sketch_q, store.sketch_scale, store.weights, store.mask, k=m
    )


def sketch_screen(store: SketchStore, queries: Rows, m: int) -> torch.Tensor:
    """The top-m candidate indices (B, m) of ``sketch_screen_scores``."""
    return sketch_screen_scores(store, queries, m)[1]


def sketch_search_host_rerank(
    store: SketchStore,
    host_vectors: np.ndarray,
    host_weights: np.ndarray,
    queries: Rows,
    k: int,
    m: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full capacity-tier search: device screen → host gather of the m
    candidate rows → exact fp32 weighted re-rank. Returns (vals, idx)
    of shape (B, k); scores are exact fp32 — only selection can miss
    (screen recall, measured per corpus geometry).

    ``m`` defaults to max(8k, 64): the screen over-fetch that buys
    recall back from the 8-bit, d_sketch-dim selection.
    """
    if m <= 0:
        m = max(8 * k, 64)
    # an operator-configured fetch (SKETCH_FETCH) below k would silently
    # truncate results to m rows — the fetch must at least cover k
    m = max(m, k)
    m = min(m, store.n_real)
    idx_m = sketch_screen(store, queries, m).cpu().numpy()  # (B, m)
    if isinstance(queries, torch.Tensor):
        queries = queries.cpu().numpy()
    q = np.asarray(queries, dtype=np.float32)
    safe = np.clip(idx_m, 0, store.n_real - 1)
    cand = host_vectors[safe]  # (B, m, D) host gather
    exact = np.einsum("bd,bmd->bm", q, cand) * host_weights[safe]
    exact = np.where((idx_m >= 0) & (idx_m < store.n_real), exact, -np.inf)
    k = min(k, m)
    order = np.argsort(-exact, axis=1)[:, :k]
    vals = np.take_along_axis(exact, order, axis=1)
    idx = np.take_along_axis(safe, order, axis=1)
    return vals.astype(np.float32), idx.astype(np.int32)
