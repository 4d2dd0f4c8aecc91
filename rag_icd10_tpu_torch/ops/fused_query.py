"""Fused query path: tokenized text -> embeddings -> weighted scores ->
top-k as ONE CUDA graph replay per shape bucket.

Counterpart of rag_icd10_tpu/ops/fused_query.py, where the whole chain
is one jitted XLA executable per (rows, seq, k) bucket. The Hopper
spelling of "one executable per shape" is a ``torch.cuda.CUDAGraph`` per
key (rows, seq bucket, k, method, corpus dtype): the BERT forward (its
~700 small launches), K1 ``fused_weighted_scores`` (exact, approx) or K2
``streaming_candidates`` (streaming, k <= 128) and ``torch.topk`` are
captured once and replayed. A query is then one host->device copy of the
token ids, one replay and one device->host copy of a packed result.

- ``supports`` keeps the JAX engine's rules on the port's attributes: the
  native encoder (model, tokenizer), a device-resident fp32 or bf16
  ``corpus`` (not int8, not host residency), a FLAT index, and encoder
  and store on one device.
- Rows pad to 8, doubling; sequences to the encoder's length buckets; k is
  the caller's (the orchestrator passes the store's k bucket). The
  embeddings are cast to the corpus dtype (JAX :83): an fp32 corpus runs
  K1 "stream"/"tile", a bf16 corpus K1 "mma".
- ``streaming`` is captured with ``guarantee=False`` (its certificate
  check is a host sync); the ``certified`` flags come back with the
  results, and a batch with an uncertified query is redone eagerly on the
  exact path and counted (``stats()["redos"]``). At the default depth
  S = k the certificate holds by construction.
- The kernels' launch counters are Python counters: they move when a
  graph is captured, not when it is replayed. The engine takes the
  capture's counts back and adds each replay's itself.
- Graphs share one memory pool. A replay may overwrite memory of another
  graph's outputs; replays are serialized under the engine's lock and
  each reads its outputs back before the lock is released.
- Capture runs the key once eagerly on the engine's own stream first
  (the kernels' ``nvcc`` build, cuBLAS handles, allocator growth), then
  captures on that stream in "thread_local" mode, so other threads'
  device work (NER forwards on the host pool) neither breaks nor joins
  it. A capture that fails raises: the engine never falls back to the
  eager path on the card.
- On the CPU (``device="cpu"``, the tests) the same chain runs eagerly
  with the kernels' plain versions.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .fused_score import (
    STREAMING_K_MAX,
    add_launch_counts,
    fused_search,
    streaming_topk,
)


def replay_launches(k: int, method: str) -> Tuple[int, int, int]:
    """(K1, K2, streaming above k max) launches of one query of the fused
    chain: K1 for exact and approx, K2 for streaming up to
    STREAMING_K_MAX, K1 for streaming above it (the materialized path)."""
    if method != "streaming":
        return (1, 0, 0)
    return (0, 1, 0) if k <= STREAMING_K_MAX else (1, 0, 1)


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: torch.Tensor  # (3, rows, seq) int64: ids, mask, types
    out: torch.Tensor  # packed: emb, vals, idx (fp32 bits), [certified]
    emb: torch.Tensor  # (rows, D) fp32 embeddings, for a redo


class FusedQueryEngine:
    """Binds an encoder's model and tokenizer with a store's device arrays."""

    def __init__(self, encoder, store):
        self.encoder = encoder
        self.store = store
        self.device = store.device
        self._lock = threading.Lock()
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None  # one graph memory pool for every key
        self._stream = None  # the engine's own warm-up and capture stream
        self._bound = ()  # weak references to the device arrays the graphs read
        self._stats = {
            "graphs": 0, "capture_s": 0.0, "replays": 0, "eager": 0,
            "queries": 0, "streaming_queries": 0, "certified": 0, "redos": 0,
        }

    @staticmethod
    def supports(encoder, store) -> bool:
        dev = getattr(store, "_dev", None)
        return (
            hasattr(encoder, "model")
            and hasattr(encoder, "tokenizer")
            and hasattr(encoder, "_prefixed")
            and dev is not None
            and "corpus" in dev  # fp32/bf16 residency (int8 has its own path)
            and store.config.index_type.upper() == "FLAT"
            and getattr(encoder, "device", None) == getattr(store, "device", None)
        )

    def stats(self) -> Dict:
        with self._lock:
            return dict(self._stats)

    # ---------------------------------------------------------- the chain

    def _compute(self, inputs: torch.Tensor, k: int, method: str, dev: Dict):
        """(3, rows, seq) token ids, mask, types -> (emb (rows, D) fp32,
        vals (rows, k) fp32, idx (rows, k) int32, certified (rows,) bool or
        None)."""
        emb = self.encoder.model(inputs[0], inputs[1], inputs[2])
        corpus, weights, mask = dev["corpus"], dev["weights"], dev["mask"]
        q = emb.to(corpus.dtype)
        if method == "streaming" and k <= STREAMING_K_MAX:
            vals, idx, cert = streaming_topk(q, corpus, weights, mask, k, guarantee=False)
            return emb, vals, idx, cert
        vals, idx = fused_search(q, corpus, weights, mask, k, method=method)
        return emb, vals, idx, None

    def _capture(self, key: tuple, dev: Dict) -> _Graph:
        rows, seq, k, method, _ = key
        t0 = time.perf_counter()
        inputs = torch.zeros((3, rows, seq), dtype=torch.long, device=self.device)
        inputs[1, :, 0] = 1  # one real token per row during the warm-up
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream), torch.inference_mode():
            self._compute(inputs, k, method, dev)
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
            graph, pool=self._pool, stream=self._stream,
            capture_error_mode="thread_local",
        ):
            emb, vals, idx, cert = self._compute(inputs, k, method, dev)
            parts = [emb.reshape(-1), vals.reshape(-1), idx.view(torch.float32).reshape(-1)]
            if cert is not None:
                parts.append(cert.to(torch.float32))
            out = torch.cat(parts)
        k1, k2, over = replay_launches(k, method)
        add_launch_counts(-k1, -k2, -over)  # captured, not launched
        entry = _Graph(graph, inputs, out, emb)
        self._graphs[key] = entry
        self._stats["graphs"] += 1
        self._stats["capture_s"] += time.perf_counter() - t0
        return entry

    def _run_graph(self, arrays: np.ndarray, k: int, method: str, dev: Dict):
        rows, seq = arrays.shape[1:]
        corpus = dev["corpus"]
        key = (rows, seq, k, method, corpus.dtype)
        entry = self._graphs.get(key) or self._capture(key, dev)
        entry.inputs.copy_(torch.from_numpy(arrays))
        entry.graph.replay()
        add_launch_counts(*replay_launches(k, method))
        self._stats["replays"] += 1
        packed = entry.out.cpu().numpy()  # the one read back
        d = entry.emb.shape[1]
        cuts = np.cumsum([rows * d, rows * k, rows * k])
        emb = packed[: cuts[0]].reshape(rows, d)
        vals = packed[cuts[0] : cuts[1]].reshape(rows, k)
        idx = packed[cuts[1] : cuts[2]].view(np.int32).reshape(rows, k)
        cert = packed[cuts[2] :] > 0.5 if cuts[2] < packed.size else None
        return emb, vals, idx, cert, entry.emb

    def _run_eager(self, arrays: np.ndarray, k: int, method: str, dev: Dict):
        inputs = torch.from_numpy(arrays).to(self.device)
        with torch.inference_mode():
            emb, vals, idx, cert = self._compute(inputs, k, method, dev)
        self._stats["eager"] += 1
        host = None if cert is None else cert.cpu().numpy()
        return emb.cpu().numpy(), vals.cpu().numpy(), idx.cpu().numpy(), host, emb

    # ------------------------------------------------------------- public

    def tokenize(self, texts) -> np.ndarray:
        """texts -> (3, rows, seq) int64 ids, mask and types: "query"
        prefixes, rows padded to 8 and doubling, seq to the encoder's
        length bucket."""
        enc = self.encoder
        cfg = enc.config
        texts = enc._prefixed(list(texts), "query")
        pad_rows = 8
        while pad_rows < len(texts):
            pad_rows *= 2
        ids, mask, types = enc.tokenizer.encode_batch(
            texts,
            max_length=cfg.max_length,
            buckets=cfg.length_buckets,
            pad_batch_to=pad_rows,
        )
        return np.stack([ids, mask, types]).astype(np.int64)

    def query(
        self, texts, k: int, method: str = "exact"
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """texts -> (embeddings (B, D), values (B, k), indices (B, k)).

        One host->device copy of the token ids, one replay (on the card),
        one device->host copy. Shapes are bucketed like the separate
        paths. ``method`` other than approx or streaming selects exactly,
        as the JAX engine's top-k does."""
        arrays = self.tokenize(texts)
        method = method if method in ("approx", "streaming") else "exact"
        n = len(texts)
        with self._lock:
            dev = self._device_arrays()
            run = self._run_graph if self.device.type == "cuda" else self._run_eager
            emb, vals, idx, cert, emb_dev = run(arrays, k, method, dev)
            self._stats["queries"] += n
            if cert is not None:
                certified = int(cert[:n].sum())
                self._stats["streaming_queries"] += n
                self._stats["certified"] += certified
                if certified < n:
                    vals, idx = self._redo(emb_dev, k, dev)
        return emb[:n].astype(np.float32, copy=False), vals[:n], idx[:n]

    def _device_arrays(self) -> Dict:
        """The store's device arrays; graphs captured over an earlier set
        (a release and reload, a new insert) are dropped."""
        dev = self.store._dev
        if dev is None or "corpus" not in dev:
            raise RuntimeError(
                "the store's corpus is not resident on the device: the fused "
                "engine needs fp32 or bf16 residency (load_collection)"
            )
        names = ("corpus", "weights", "mask")
        if not self._bound or any(ref() is not dev[n] for ref, n in zip(self._bound, names)):
            # weak: a released store frees its arrays; the graphs that
            # read them are never replayed again
            self._graphs.clear()
            self._bound = tuple(weakref.ref(dev[n]) for n in names)
        return dev

    def _redo(self, emb: torch.Tensor, k: int, dev: Dict):
        """An uncertified streaming batch, exactly: K1 and ``torch.topk``
        over the replay's embeddings, eagerly."""
        self._stats["redos"] += 1
        corpus = dev["corpus"]
        with torch.inference_mode():
            vals, idx = fused_search(
                emb.to(corpus.dtype), corpus, dev["weights"], dev["mask"], k
            )
        return vals.cpu().numpy(), idx.cpu().numpy()

