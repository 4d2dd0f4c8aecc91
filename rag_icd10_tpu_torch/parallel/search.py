"""Corpus-sharded flat search over a device mesh.

Counterpart of rag_icd10_tpu/parallel/search.py, method by method and
with its error messages word for word (the API turns them into 400s).
The corpus rows shard along one mesh axis: each shard scans its rows with
the port's kernels, keeps its top-k, and the (B, k) candidates merge
into the global top-k, so k * n_shards values cross between devices
instead of N.

Per shard, for an fp32 store:

- ``auto``/``streaming``: K2 (``fused_score.streaming_topk``,
  ``guarantee=True``) for k <= STREAMING_K_MAX, else K1 through
  ``fused_search``. ``exact`` and ``approx``: K1 and ``torch.topk``
  (exact selection: PyTorch has no ``approx_max_k``; JAX asks a recall of
  0.99 of its approximate selection, this one has 1.0).
- ``fast``/``chunk``: ``rerank.chunk_select_search`` over K1's IEEE fp32
  scan (the port's Precision.HIGH), certified, exact fallback inside.
- ``chunkstream``: pass 1 is K1 in IEEE fp32 (``Q·Cᵀ × w + mask``), the
  128-row chunk maxima and the top ``mc = min(max(2k, k + 16), nc)``
  chunks; pass 2 is K5 (``chunk_stream.gather_rescore``) over the shard's
  raw fp32 rows, then the gathered weights and mask. Certified when the
  k-th value beats the mc-th chunk maximum by ``eps_fp32_dot(d) ·
  bound_scale · ||q||`` (pass 1 and pass 2 are two fp32 roundings of the
  same dot); fetching every chunk certifies. JAX redoes an uncertified
  batch inside the program (``lax.cond``); here the shards' certificates
  are read with one host sync, and each shard that failed redoes its
  exact K1 scan, counted in ``redos``. K3 stays off this path: it needs
  the transposed, weight-folded chunk store, which a shard does not keep.

For an int8 store (``store_dtype="int8"``, the capacity tier) each shard
holds ``quantize_rows``'s int8 rows and scales; the queries quantize by
the same law (IEEE division) and each shard's scores are
``int8_matmul`` (``torch._int_mm``) accumulators through the JAX
package's fp32 epilogue. ``exact`` takes their top-k; ``chunkstream``
selects chunks on their maxima and re-scores the selected rows. The int32
sums are exact, so the re-score equals pass 1's scores bit for bit: it
reads them back instead of multiplying again, and the certificate needs
no epsilon (parallel/search.py:321-327).

Merge: local ids become global ids (``shard * shard_rows``); in one
process the shards' (B, k) pairs are copied to the first local shard's
device, concatenated in shard order and reduced by one ``torch.topk``;
across processes each rank merges its own shards, ``all_gather``s its
(B, k) values and ids (NCCL or gloo) and every rank computes the same
final merge. In one process, shard i lives on mesh device i and its
kernels launch under ``torch.cuda.device`` of it.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.chunk_stream import CHUNK, eps_fp32_dot, gather_rescore
from ..ops.flat_topk import pad_corpus
from ..ops.fused_score import (
    STREAMING_K_MAX,
    fused_search,
    fused_weighted_scores,
    streaming_topk,
)
from ..ops.quantized import int8_matmul, quantize_rows
from ..ops.rerank import chunk_select_search
from .multihost import collective_device, global_device_put

FP32_METHODS = ("auto", "exact", "streaming", "fast", "chunk", "chunkstream", "approx")
INT8_METHODS = ("exact", "chunkstream")


@dataclass
class _Shard:
    """One shard's rows on its device. fp32 stores keep ``corpus``; int8
    stores ``corpus_q`` and ``colw`` (per-row scale x weight)."""

    index: int
    device: torch.device
    weights: torch.Tensor
    mask: torch.Tensor
    corpus: Optional[torch.Tensor] = None
    corpus_q: Optional[torch.Tensor] = None
    colw: Optional[torch.Tensor] = None
    bound_scale: float = 1.0  # w_max * max row norm of this shard (``fast``)


def _pad_rows(corpus, weights, multiple: int):
    """``flat_topk.pad_corpus`` for a numpy corpus; for a tensor the same
    padding where it lies, without a copy when the rows already fit."""
    if not isinstance(corpus, torch.Tensor):
        return pad_corpus(corpus, weights, multiple=multiple)
    n = corpus.shape[0]
    n_pad = -(-n // multiple) * multiple
    c = corpus.to(torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32, device=c.device)
    mask = torch.zeros(n_pad, dtype=torch.float32, device=c.device)
    mask[n:] = -1e30
    if n_pad != n:
        c = torch.nn.functional.pad(c, (0, 0, 0, n_pad - n))
        w = torch.nn.functional.pad(w, (0, n_pad - n))
    return c.contiguous(), w.contiguous(), mask


def _max_norm(rows) -> float:
    if isinstance(rows, torch.Tensor):
        return float(torch.sqrt((rows * rows).sum(dim=1).max())) if rows.numel() else 0.0
    return float(np.sqrt(np.einsum("nd,nd->n", rows, rows).max())) if rows.size else 0.0


class ShardedFlatSearcher:
    """Flat scan with the corpus row dimension sharded over a mesh axis.

    ``corpus`` (N, D) and ``weights`` (N,) are numpy arrays or tensors,
    the same whole arrays in every process; each process keeps only the
    shards its devices own. ``store_dtype`` is "fp32" or "int8"."""

    def __init__(self, corpus, weights, mesh, axis: str = "dp", store_dtype: str = "fp32"):
        if store_dtype not in ("fp32", "int8"):
            raise ValueError(f"store_dtype={store_dtype!r}: fp32 or int8")
        self.mesh = mesh
        self.axis = axis
        self.store_dtype = store_dtype
        if not isinstance(corpus, torch.Tensor):
            corpus = np.asarray(corpus, np.float32)
            weights = np.asarray(weights, np.float32)
        n_shards = mesh.shape[axis]
        # K5 gathers whole 128-row chunks, so each shard is a multiple of
        # 128 rows (the JAX package's CPU tile; its 2048-row TPU tile is a
        # VMEM budget the kernels here do not have)
        cp, wp, mask = _pad_rows(corpus, weights, CHUNK * n_shards)
        self.n_padded = cp.shape[0]
        self.shard_rows = self.n_padded // n_shards
        # certificate scale of the chunkstream method: the global w_max *
        # max row norm (parallel/search.py:73-76)
        w_max = float(weights.max()) if corpus.shape[0] else 1.0
        self._bound_scale = _max_norm(corpus) * w_max or 1.0
        parts = {"weights": global_device_put(wp, mesh, axis),
                 "mask": global_device_put(mask, mesh, axis)}
        if store_dtype == "int8":
            # the one quantization law; padding rows are zeros -> scale 1
            cq, cscale = quantize_rows(cp)
            parts["corpus_q"] = global_device_put(cq, mesh, axis)
            parts["colw"] = global_device_put(cscale * wp, mesh, axis)
        else:
            parts["corpus"] = global_device_put(cp, mesh, axis)
        self.shards: List[_Shard] = []
        for i, (_, dev) in enumerate(mesh.axis_devices(axis)):
            if parts["weights"][i] is None:
                continue  # another rank's shard
            sh = _Shard(i, dev, **{key: p[i] for key, p in parts.items()})
            if sh.corpus is not None:
                sh.bound_scale = float(sh.weights.max()) * _max_norm(sh.corpus) or 1.0
            self.shards.append(sh)
        self.redos = 0  # shard batches redone on the exact scan (chunkstream)
        self._lock = threading.Lock()

    @property
    def device_bytes(self) -> int:
        """Bytes of this process's shard rows on their devices: fp32 rows,
        or int8 rows plus one fp32 factor per row (padding included)."""
        total = 0
        for sh in self.shards:
            rows = sh.corpus if sh.corpus is not None else sh.corpus_q
            total += rows.numel() * rows.element_size()
            if sh.colw is not None:
                total += sh.colw.numel() * 4
        return total

    # ------------------------------------------------------------ search

    def search(self, queries, k: int, method: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) queries -> (values (B, k), global indices (B, k)) numpy.

        ``method`` selects the per-shard kernel (module docstring);
        unknown methods raise ValueError so callers can surface a 400
        instead of silently falling back."""
        vals, idx = self.search_device(queries, k, method)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_device(self, queries, k: int, method: str = "auto"):
        """``search`` leaving the merged (values, int32 ids) on the merge
        device."""
        if method in (None, ""):
            method = "auto"
        if self.store_dtype == "int8":
            if method == "auto":
                method = "exact"
            if method not in INT8_METHODS:
                raise ValueError(
                    f"search method {method!r} is not available on an "
                    "int8-sharded store (supported: exact, chunkstream)"
                )
        elif method not in FP32_METHODS:
            raise ValueError(
                f"search method {method!r} is not available on a sharded "
                "store (supported: exact, streaming, fast, chunkstream, "
                "approx)"
            )
        if not 1 <= k <= self.n_padded:
            raise ValueError(f"k={k}: 1 <= k <= {self.n_padded} rows")
        if isinstance(queries, torch.Tensor):
            q = queries.to(torch.float32)
            q = q if q.ndim == 2 else q[None, :]
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32)))
        ks = min(k, self.shard_rows)
        per_device = {}
        results = []
        for sh in self.shards:
            if sh.device not in per_device:
                per_device[sh.device] = self._prepare(q, sh.device)
            with _on(sh.device):
                if self.store_dtype == "int8":
                    results.append(self._shard_int8(sh, per_device[sh.device], ks, method))
                else:
                    results.append(self._shard_fp32(sh, per_device[sh.device], ks, method))
        results = self._check_certificates(results, per_device, ks)
        return self._merge(results, q.shape[0], k)

    def _prepare(self, q: torch.Tensor, dev: torch.device):
        """The queries on a shard device: fp32, or int8 with their scales."""
        qd = q.to(dev)
        return quantize_rows(qd) if self.store_dtype == "int8" else qd

    def _shard_fp32(self, sh: _Shard, q: torch.Tensor, k: int, method: str):
        """(values, local ids, certified or None) of one fp32 shard."""
        c, w, m = sh.corpus, sh.weights, sh.mask
        if method in ("auto", "streaming") and k <= STREAMING_K_MAX:
            vals, idx, _ = streaming_topk(q, c, w, m, k, guarantee=True)
            return vals, idx, None
        if method in ("fast", "chunk"):
            vals, idx, _ = chunk_select_search(
                q, c, w, m, k, scan_precision="high", guarantee=True,
                bound_scale=sh.bound_scale,
            )
            return vals, idx, None
        if method == "chunkstream":
            return self._chunkstream_fp32(sh, q, k)
        vals, idx = fused_search(q, c, w, m, k, method="approx" if method == "approx" else "exact")
        return vals, idx, None

    def _chunkstream_fp32(self, sh: _Shard, q: torch.Tensor, k: int):
        b, d = q.shape
        c, w, m = sh.corpus, sh.weights, sh.mask
        nc = c.shape[0] // CHUNK
        mc = min(max(2 * k, k + 16), nc)
        s = fused_weighted_scores(q, c, w, m)  # K1, IEEE fp32
        cvals, cidx = torch.topk(s.view(b, nc, CHUNK).amax(dim=2), mc, dim=1)
        raw = gather_rescore(q, c, cidx.to(torch.int32))  # K5
        li = cidx.long()
        scores = (raw * w.view(nc, CHUNK)[li].reshape(b, mc * CHUNK)
                  + m.view(nc, CHUNK)[li].reshape(b, mc * CHUNK))
        vals, idx = _top_of_chunks(scores, li, k)
        if mc >= nc:
            # every chunk of this shard was re-scored exactly
            return vals, idx, torch.ones(b, dtype=torch.bool, device=c.device)
        eps = eps_fp32_dot(d) * self._bound_scale * torch.sqrt((q * q).sum(dim=1))
        return vals, idx, vals[:, k - 1] >= cvals[:, mc - 1] + eps

    def _shard_int8(self, sh: _Shard, q8, k: int, method: str):
        q_i8, q_scale = q8
        b = q_i8.shape[0]
        s = (int8_matmul(q_i8, sh.corpus_q).to(torch.float32) * q_scale[:, None]
             * sh.colw[None, :] + sh.mask[None, :])
        if method != "chunkstream":
            vals, idx = torch.topk(s, k, dim=1)
            return vals, idx.to(torch.int32), None
        nc = s.shape[1] // CHUNK
        mc = min(max(2 * k, k + 16), nc)
        s3 = s.view(b, nc, CHUNK)
        cvals, cidx = torch.topk(s3.amax(dim=2), mc, dim=1)
        # pass 2: the selected chunks' exact integer scores through the
        # same fp32 epilogue are pass 1's, bit for bit
        blocks = torch.gather(s3, 1, cidx[:, :, None].expand(b, mc, CHUNK))
        vals, idx = _top_of_chunks(blocks.reshape(b, mc * CHUNK), cidx, k)
        if mc >= nc:
            return vals, idx, torch.ones(b, dtype=torch.bool, device=s.device)
        return vals, idx, vals[:, k - 1] >= cvals[:, mc - 1]

    def _check_certificates(self, results, per_device, k: int):
        """Read every shard's chunkstream certificate with one host sync
        and redo each uncertified shard on its exact scan."""
        pending = [i for i, (_, _, cert) in enumerate(results) if cert is not None]
        if not pending:
            return [(v, i) for v, i, _ in results]
        dev0 = results[pending[0]][2].device
        ok = torch.stack([results[i][2].all().to(dev0) for i in pending]).cpu().tolist()
        out = [(v, i) for v, i, _ in results]
        for j, good in zip(pending, ok):
            if good:
                continue
            sh = self.shards[j]
            with self._lock:
                self.redos += 1
            with _on(sh.device):
                if self.store_dtype == "int8":
                    vals, idx, _ = self._shard_int8(sh, per_device[sh.device], k, "exact")
                else:
                    vals, idx = fused_search(per_device[sh.device], sh.corpus, sh.weights,
                                             sh.mask, k)
            out[j] = (vals, idx)
        return out

    def _merge(self, results, b: int, k: int):
        """Global top-k of every shard's (B, k) candidates."""
        dev = self.shards[0].device if self.shards else collective_device(self.mesh)
        vals = [v.to(dev) for v, _ in results]
        ids = [(i.to(torch.int64) + sh.index * self.shard_rows).to(dev)
               for (_, i), sh in zip(results, self.shards)]
        vals, ids = _top_k(vals, ids, b, k, dev)
        if self.mesh.group is not None:
            cdev = collective_device(self.mesh)
            world = dist.get_world_size(self.mesh.group)
            v_all = [torch.empty((b, k), dtype=torch.float32, device=cdev) for _ in range(world)]
            i_all = [torch.empty((b, k), dtype=torch.int64, device=cdev) for _ in range(world)]
            dist.all_gather(v_all, vals.to(cdev).contiguous(), group=self.mesh.group)
            dist.all_gather(i_all, ids.to(cdev).contiguous(), group=self.mesh.group)
            vals, ids = _top_k(v_all, i_all, b, k, cdev)
        return vals, ids.to(torch.int32)


def _on(dev: torch.device):
    """Launch on ``dev``'s current stream (a no-op context on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _top_of_chunks(scores: torch.Tensor, chunk_ids: torch.Tensor, k: int):
    """Top-k of (B, mc * 128) scores of the chunks ``chunk_ids`` (B, mc),
    as (values, row ids int32)."""
    b, mc = chunk_ids.shape
    vals, sel = torch.topk(scores, k, dim=1)
    cols = (chunk_ids.long()[:, :, None] * CHUNK
            + torch.arange(CHUNK, device=scores.device)).reshape(b, mc * CHUNK)
    return vals, torch.gather(cols, 1, sel).to(torch.int32)


def _top_k(vals: List[torch.Tensor], ids: List[torch.Tensor], b: int, k: int,
           dev: torch.device):
    """Top-k of the candidates concatenated in order, padded with
    (-inf, -1) to k columns where there are fewer."""
    v = torch.cat(vals, dim=1) if vals else torch.empty((b, 0), device=dev)
    i = torch.cat(ids, dim=1) if ids else torch.empty((b, 0), dtype=torch.int64, device=dev)
    if v.shape[1] < k:
        v = torch.nn.functional.pad(v, (0, k - v.shape[1]), value=float("-inf"))
        i = torch.nn.functional.pad(i, (0, k - i.shape[1]), value=-1)
    top, pos = torch.topk(v, k, dim=1)
    return top, torch.gather(i, 1, pos)
