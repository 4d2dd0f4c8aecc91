"""Device-resident vector store — the Milvus-Lite replacement.

Counterpart of rag_icd10_tpu/index/vector_store.py. API parity with the
reference MilvusService (services/milvus_service.py): ``insert_records``
(:208), ``search`` (:271, level-weighted + re-sorted),
``load_collection``/``release_collection`` (:343,:411),
``clear_collection``, ``get_collection_stats``, ``get_memory_usage``
(:497, bytes = n*dim*4), ``health_check`` (:524), ``test_connection``
(:373).

- The collection is a padded (N, D) matrix resident on the device (fp32,
  bfloat16 or int8 with per-row scales; with ``device_dtype="host"`` only
  an int8 sketch screen is on the device) plus host-side metadata
  columns; persistence is the JAX package's .npz + JSON sidecars (and
  ``<path>.hnsw`` for a built graph), byte for byte the same layout, so a
  store saved by either package loads in the other.
- ``search`` takes a BATCH of query vectors and issues ONE scoring-kernel
  launch plus ``torch.topk`` (ops/fused_score.py); the level weights
  x{1.2, 1.0, 0.8} (milvus_service.py:550-558) are fused into the
  kernel's epilogue. A corpus on a CUDA device goes through the
  hand-written kernels; a corpus on the CPU through their plain versions.
- Served methods: "exact" and "approx" (both exact top-k); "fast" and
  "chunk" (certified chunk select over K1, ops/rerank.py; fp32
  residency, the flat path over the others); "streaming" (in-kernel
  range top-k, ops/fused_score.py ``streaming_topk``); "chunkstream"
  (chunk-select over a ``CHUNKSTREAM_SCAN`` pass 1 and an exact fp32
  pass 2, ops/chunk_stream.py; fp32 residency only); "sketch" (device
  int8 screen + host exact re-rank, ops/sketch.py) and "hnsw" (the host
  C++ graph, index/hnsw_index.py), whose selection is approximate and
  whose scores are exact. The certified methods return a per-query
  certificate with their top-k; ``finalize`` reads it and redoes an
  uncertified batch on the exact path. int8 residency selects with the
  int8 product and re-ranks on the device or the host (``INT8_RERANK``).
- Corpus sharding (``STORE_SHARDED``, the JAX store's ``_use_sharded``):
  ``off`` never shards; ``on`` shards when the store's mesh has more than
  one shard; ``auto`` when the store is on ``cuda`` and more than one
  card is attached. The mesh is ``VectorStore(mesh=...)`` or
  ``parallel.make_mesh`` over the store's devices (every local card, or
  every rank's under ``torch.distributed``); a mesh of logical shards
  runs them all on one device. A sharded store serves through
  ``parallel/search.py ShardedFlatSearcher`` along the mesh's first axis,
  in fp32 shards (a bf16 configuration too, as in JAX) or int8 shards
  with a host fp32 re-rank.
- No shape bucketing: PyTorch runs eagerly and the kernel masks ragged
  edges, so queries go in at their own batch size and top-k at k. The
  approximate tiers over-fetch from the JAX store's k grid
  (``_bucket_k``), so both fetch the same candidates.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import StoreConfig
from ..data.corpus import ICDCorpus, ICDRecord
from ..ops import chunk_stream
from ..ops.flat_topk import pad_corpus
from ..ops.fused_score import STREAMING_K_MAX, fused_search, streaming_topk
from ..ops.quantized import int8_search, int8_search_device_rerank, quantize_rows
from ..ops.rerank import chunk_select_search, eps_bf16_dot
from ..ops.sketch import build_sketch, sketch_search_host_rerank
from ..utils.device import resolve_device

SERVED_METHODS = (
    "exact", "approx", "fast", "chunk", "streaming", "chunkstream", "sketch", "hnsw",
)
RESIDENCIES = ("float32", "bfloat16", "int8", "host")
#: the JAX store's k grid (its jit shape buckets); the approximate tiers
#: over-fetch from it so both stores fetch the same candidates, and the
#: fused engine (ops/fused_query.py) captures one graph per bucket
_K_BUCKETS = (8, 16, 32, 64, 128)
#: CHUNKSTREAM_SCAN grammar, engine[_dtype] -> (chunk_stream scan engine,
#: stored scan dtype). The pallas* values run the chunk-max kernels over an
#: fp32, bf16 or int8 store; xla, xla_high, bf16 and int8 are the JAX
#: package's plain-XLA engines, plain torch here. On a CPU store every
#: engine computes its plain version over the store's dtype.
CHUNKSTREAM_SCANS = {
    "pallas": ("pallas", "fp32"),
    "pallas_bf16": ("pallas", "bf16"),
    "pallas_int8": ("pallas", "int8"),
    "xla": ("xla", "fp32"),
    "xla_high": ("xla_high", "fp32"),
    "bf16": ("bf16", "bf16"),
    "int8": ("int8", "int8"),
}


def _bucket_k(k: int) -> int:
    """The smallest k of the JAX store's grid that holds k (its largest
    above 128)."""
    return next((g for g in _K_BUCKETS if k <= g), _K_BUCKETS[-1])


@dataclass
class SearchHit:
    """One search result row (fields per reference schema,
    milvus_service.py:174-186 + weighted score semantics :292-316)."""

    id: int
    code: str
    preferred_zh: str
    score: float  # level-weighted score (may exceed raw cosine)
    original_score: float  # raw IP/cosine before level weighting
    level: int
    parent_code: str
    category_path: str
    semantic_text: str
    main_code: str = ""
    secondary_code: str = ""
    has_complication: bool = False

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "code": self.code,
            "preferred_zh": self.preferred_zh,
            "score": self.score,
            "original_score": self.original_score,
            "level": self.level,
            "parent_code": self.parent_code,
            "category_path": self.category_path,
            "semantic_text": self.semantic_text,
            "main_code": self.main_code,
            "secondary_code": self.secondary_code,
            "has_complication": self.has_complication,
        }


class PendingSearch:
    """A dispatched-but-unmaterialized search.

    ``search_dispatch`` returns one of these after enqueueing the device
    work WITHOUT waiting for it; ``finalize()`` blocks (copies the top-k
    tensors to the host and builds SearchHit rows). Splitting the two lets
    the serving layer dispatch batch n+1's encode+search while batch n's
    results are still in flight (api/batching.py has the pipeline
    story)."""

    __slots__ = ("_finalize", "_hits")

    def __init__(self, finalize=None, hits=None):
        self._finalize = finalize
        self._hits = hits

    def finalize(self) -> List[List["SearchHit"]]:
        if self._hits is None:
            self._hits = self._finalize()
            self._finalize = None  # free captured device tensors
        return self._hits


class VectorStore:
    """Batched flat-scan vector store over an ICD corpus. Runs on ``cuda``
    unless ``device="cpu"`` is passed."""

    #: search() accepts torch query tensors and keeps them on the device
    accepts_device_queries = True

    def __init__(
        self,
        dim: int,
        config: Optional[StoreConfig] = None,
        hnsw_config=None,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        from ..config import HNSWConfig

        self.device = resolve_device(device)
        self._mesh = mesh  # parallel.Mesh; None: make_mesh() over self.device's type
        self.config = config or StoreConfig()
        self.hnsw_config = hnsw_config or HNSWConfig()
        self.dim = dim
        self.corpus: Optional[ICDCorpus] = None
        self._vectors: Optional[np.ndarray] = None  # host (N, D) fp32
        self._title_rows: Optional[Dict[str, List[int]]] = None
        # device-resident state (set by load_collection)
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._sharded = None  # parallel.ShardedFlatSearcher (corpus sharded)
        self._semantic_vectors: Optional[np.ndarray] = None
        self._hnsw = None  # native graph index (index_type == "HNSW")
        self._bound_scale = None  # w_max * max row norm (method="fast")
        self._max_row_norm = None  # unweighted max row norm (bf16 graph bound)
        self._chunkstore = None  # ops/chunk_stream state (method="chunkstream")
        self._sketch = None  # ops/sketch screen (method="sketch" / host tier)
        self._loaded = False
        self._searches = 0
        # queries of the certified methods (streaming, chunkstream, fast),
        # those certified, and batches
        # redone on the exact path in finalize()
        self._cert = {"queries": 0, "certified": 0, "redos": 0}
        # finalize() runs on the serving host pool, so with depth-2
        # pipelining two batches can bump the stats counters concurrently
        self._searches_lock = threading.Lock()
        self._created_at = time.time()

    # ------------------------------------------------------------ insert

    def insert_records(
        self,
        records: Sequence[ICDRecord],
        vectors: np.ndarray,
        semantic_vectors: Optional[np.ndarray] = None,
    ) -> int:
        """Append records + their embeddings. Returns inserted count.

        ``semantic_vectors`` optionally carries embeddings of each record's
        ``semantic_text`` — kept resident so the rescoring stack never
        re-embeds candidates (the reference re-embeds 2x per candidate,
        hierarchical_similarity_service.py:387-409).
        """
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape != (len(records), self.dim):
            raise ValueError(
                f"vectors {vectors.shape} != ({len(records)}, {self.dim})"
            )
        new = ICDCorpus(list(records))
        if self.corpus is None:
            self.corpus = new
            self._vectors = vectors.copy()
            if semantic_vectors is not None:
                self._semantic_vectors = np.asarray(
                    semantic_vectors, dtype=np.float32
                ).copy()
        else:
            old, self.corpus = self.corpus, ICDCorpus([])
            self.corpus.codes = old.codes + new.codes
            self.corpus.titles = old.titles + new.titles
            self.corpus.main_codes = old.main_codes + new.main_codes
            self.corpus.secondary_codes = old.secondary_codes + new.secondary_codes
            self.corpus.has_complication = np.concatenate(
                [old.has_complication, new.has_complication]
            )
            self.corpus.levels = np.concatenate([old.levels, new.levels])
            self.corpus.parent_codes = old.parent_codes + new.parent_codes
            self.corpus.category_paths = old.category_paths + new.category_paths
            self.corpus.semantic_texts = old.semantic_texts + new.semantic_texts
            self.corpus._code_to_idx = None
            n_old = self._vectors.shape[0]
            self._vectors = np.concatenate([self._vectors, vectors], axis=0)
            if semantic_vectors is not None:
                add = np.asarray(semantic_vectors, np.float32)
                if self._semantic_vectors is None:
                    # semantic vectors arriving only now: backfill earlier
                    # rows with their record embeddings so the matrix stays
                    # row-parallel
                    self._semantic_vectors = np.concatenate(
                        [self._vectors[:n_old], add]
                    )
                else:
                    self._semantic_vectors = np.concatenate(
                        [self._semantic_vectors, add]
                    )
            elif self._semantic_vectors is not None:
                # keep row-parallel; fall back to the record embeddings
                # when no semantic_text embeddings were given
                self._semantic_vectors = np.concatenate(
                    [self._semantic_vectors, vectors]
                )
        self._loaded = False  # device state is stale
        self._dev = None
        self._sharded = None
        # the graph, the certificate scale and the screens cover only the
        # old rows; drop them so save() cannot persist a stale graph
        self._hnsw = None
        self._bound_scale = None
        self._max_row_norm = None
        self._chunkstore = None
        self._sketch = None
        self._title_rows = None  # exact-title map misses the new rows
        return len(records)

    # ------------------------------------------------- exact-title lookup

    def exact_title_hits(
        self, title: str, query_vec: np.ndarray, max_rows: int = 3
    ) -> List[SearchHit]:
        """Rows whose title is verbatim ``title``, scored against
        ``query_vec`` with the standard weighted-score convention.

        The rescoring stack's exact-match floor (hierarchy.py, 1.5) can
        only fire on a FETCHED candidate; short generic titles at level 3
        (weight 0.8) can be buried below the over-fetch horizon by x1.2
        level-weighted near-duplicates. The orchestrator injects these
        rows into the candidate set so a verbatim-title query always
        reaches its own row."""
        if self.corpus is None or self._vectors is None:
            return []
        if self._title_rows is None:
            rows: Dict[str, List[int]] = {}
            for j, t in enumerate(self.corpus.titles):
                rows.setdefault(t.strip(), []).append(j)
            self._title_rows = rows
        idxs = self._title_rows.get(title.strip(), ())
        weights = self.corpus.level_weights(self.config.level_weights)
        q = np.asarray(query_vec, dtype=np.float32).reshape(-1)
        hits = []
        for j in idxs[:max_rows]:
            raw = float(self._vectors[j] @ q)
            w = float(weights[j]) or 1.0
            hits.append(self._hit(j, score=raw * w, original_score=raw))
        return hits

    def _hit(self, j: int, score: float, original_score: float) -> SearchHit:
        c = self.corpus
        return SearchHit(
            id=j,
            code=c.codes[j],
            preferred_zh=c.titles[j],
            score=score,
            original_score=original_score,
            level=int(c.levels[j]),
            parent_code=c.parent_codes[j],
            category_path=c.category_paths[j],
            semantic_text=c.semantic_texts[j],
            main_code=c.main_codes[j],
            secondary_code=c.secondary_codes[j],
            has_complication=bool(c.has_complication[j]),
        )

    # ----------------------------------------------------------- lifecycle

    @property
    def num_entities(self) -> int:
        return 0 if self.corpus is None else len(self.corpus)

    def _use_sharded(self) -> bool:
        """Corpus sharding policy (the JAX store's ``_use_sharded``): "off"
        never, "on" when the mesh has more than one shard, "auto" (or any
        other value) when the store is on ``cuda`` and more than one card
        is attached. One card therefore serves from one device under "on"
        and "auto" alike, as the JAX store does on one chip."""
        mode = (self.config.sharded or "auto").lower()
        if mode == "off":
            return False
        if mode == "on":
            return self._shard_mesh().devices.shape[0] > 1
        return self.device.type == "cuda" and torch.cuda.device_count() > 1

    def _shard_mesh(self):
        if self._mesh is None:
            from ..parallel.mesh import make_mesh
            from ..parallel.multihost import local_devices

            self._mesh = make_mesh(
                axis_names=("shard",), devices=local_devices(self.device.type)
            )
        return self._mesh

    def load_collection(self) -> bool:
        """Pad + transfer the corpus matrix, level weights and padding mask
        to the device (reference analog: milvus_service.py:343), in the
        configured residency: fp32, bf16, int8 rows with per-row scales,
        or (``host``) only the sketch screen, the full-width rows staying
        in host memory. A sharded store (``_use_sharded``) spreads the rows
        over its mesh instead: int8 shards for int8 residency, fp32 shards
        otherwise (parallel/search.py)."""
        if self._vectors is None or self.corpus is None:
            return False
        dtype = self.config.device_dtype
        if dtype not in RESIDENCIES:
            raise ValueError(
                f"STORE_DEVICE_DTYPE={dtype!r}: one of {', '.join(RESIDENCIES)}"
            )
        if dtype == "host":
            # capacity tier (ops/sketch.py): the only device residency is
            # the d_sketch-dim int8 screen (~d_sketch + 12 bytes/row); the
            # full-width matrix stays in host memory and serves candidate
            # rows to the exact re-rank
            self._ensure_sketch()
            self._dev = None
            self._loaded = True
            return True
        weights = self.corpus.level_weights(self.config.level_weights)
        if self._use_sharded():
            from ..parallel.search import ShardedFlatSearcher

            mesh = self._shard_mesh()
            self._sharded = ShardedFlatSearcher(
                self._vectors, weights, mesh, axis=mesh.axis_names[0],
                store_dtype="int8" if dtype == "int8" else "fp32",
            )
            self._dev = None  # single-device residency replaced by shards
            self._loaded = True
            return True
        cp, wp, m = pad_corpus(
            self._vectors, weights, multiple=self.config.pad_multiple
        )
        # certificate scale of the "fast" method: w_max * max row norm
        # bounds any row's scan-error contribution
        norms_sq = np.einsum("nd,nd->n", self._vectors, self._vectors)
        self._max_row_norm = (
            float(np.sqrt(float(np.max(norms_sq)))) if norms_sq.size else 1.0
        )
        self._bound_scale = float(
            (np.max(weights) if weights.size else 1.0) * self._max_row_norm
        )
        dev = {
            "weights": torch.from_numpy(wp).to(self.device),
            "mask": torch.from_numpy(m).to(self.device),
        }
        corpus = torch.from_numpy(cp).to(self.device)
        if dtype == "int8":
            # symmetric per-row quantization (ops/quantized.py): a quarter
            # of the fp32 bytes, plus one fp32 scale per row
            dev["corpus_q"], dev["scale"] = quantize_rows(corpus)
        else:
            dev["corpus"] = corpus.to(torch.bfloat16) if dtype == "bfloat16" else corpus
        self._dev = dev
        self._loaded = True
        return True

    def release_collection(self) -> bool:
        """Drop device tensors (reference analog: milvus_service.py:411)."""
        self._dev = None
        self._sharded = None
        self._chunkstore = None
        self._sketch = None
        self._loaded = False
        return True

    def _chunkstream_scan(self):
        scan = self.config.chunkstream_scan
        if scan not in CHUNKSTREAM_SCANS:
            raise ValueError(
                f"CHUNKSTREAM_SCAN={scan!r}: one of {', '.join(CHUNKSTREAM_SCANS)}"
            )
        return CHUNKSTREAM_SCANS[scan]

    def _ensure_chunkstore(self) -> "chunk_stream.ChunkStore":
        """Lazily build the chunk-select state (weight-folded rows in the
        scan dtype, ops/chunk_stream.py) the first time method="chunkstream"
        is requested, from the resident fp32 corpus. The raw rows are the
        resident corpus itself when its padding is already a multiple of
        the chunk store's (the default ``pad_multiple``); the residency cost
        is then one more (N_pad, D) matrix in the scan dtype (fp32 = the
        corpus again, bf16 half, int8 a quarter plus scales)."""
        if self._chunkstore is None:
            _, scan_dtype = self._chunkstream_scan()
            self._chunkstore = chunk_stream.build_device(
                self._dev["corpus"], self._dev["weights"],
                scan_dtype=scan_dtype, n_real=self.num_entities,
            )
        return self._chunkstore

    def _ensure_sketch(self):
        """Lazily build the device sketch screen (ops/sketch.py): the
        residency of STORE_DEVICE_DTYPE=host, or an on-demand path when
        method="sketch" is requested on a resident store."""
        if self._sketch is None:
            weights = self.corpus.level_weights(self.config.level_weights)
            self._sketch = build_sketch(
                self._vectors, weights,
                d_sketch=self.config.sketch_dim,
                kind=self.config.sketch_proj,
                pad_multiple=self.config.pad_multiple,
                device=self.device,
            )
        return self._sketch

    def clear_collection(self) -> bool:
        self.release_collection()
        self.corpus = None
        self._vectors = None
        self._semantic_vectors = None
        return True

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def get_collection_load_state(self) -> Dict:
        """Reference analog: milvus_service.py get_collection_load_state."""
        return {
            "loaded": self._loaded,
            "num_entities": self.num_entities,
            "collection_name": self.config.collection_name,
        }

    # ------------------------------------------------------------- search

    def search(
        self,
        query_vectors: Union[np.ndarray, torch.Tensor],
        top_k: int = 5,
        method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> List[List[SearchHit]]:
        """Batched blocking search — dispatch + finalize in one call."""
        return self.search_dispatch(
            query_vectors, top_k, method=method, ef_search=ef_search
        ).finalize()

    def search_dispatch(
        self,
        query_vectors: Union[np.ndarray, torch.Tensor],
        top_k: int = 5,
        method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> PendingSearch:
        """Batched search: (B, D) query vectors -> per-query top_k hits,
        level-weighted and sorted desc (reference: milvus_service.py:271-316,
        which handles one query; here B queries cost one kernel launch).

        The device paths enqueue their kernels and ``torch.topk`` without
        waiting and return a PendingSearch whose ``finalize()`` reads the
        certificate of "fast", "streaming" and "chunkstream" (redoing an
        uncertified batch on the exact path), copies the results to the
        host and builds the hits. The host-side paths (HNSW, the sketch
        re-rank, the int8 host re-rank) compute eagerly and finalize()
        hands the rows back.

        ``method`` is a per-request override of the configured default;
        "streaming" with k > 128 takes the materialized exact path, as in
        the JAX package; "fast"/"chunk" take the flat path over a residency
        other than fp32. ``ef_search`` is the HNSW beam width. A
        host-resident store serves its default, "sketch" and "hnsw", and
        refuses an explicit method that promises full-precision residency.
        Query tensors stay on the device; host arrays are copied up once."""
        requested = method  # the host tier refuses explicit exact methods
        method = method or self.config.search_method
        on_device = isinstance(query_vectors, torch.Tensor)
        if on_device:
            q = query_vectors if query_vectors.ndim == 2 else query_vectors[None, :]
        else:
            q = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        if self.num_entities == 0:
            return PendingSearch(hits=[[] for _ in range(q.shape[0])])
        if method not in SERVED_METHODS:
            raise ValueError(f"unknown search method {method!r}")
        k_eff = min(max(top_k, 1), self.num_entities)
        b = q.shape[0]
        if self.config.index_type.upper() == "HNSW" or method == "hnsw":
            # the graph runs on the host; no device residency needed
            return PendingSearch(
                hits=self._search_hnsw(self._host(q), k_eff, ef_search=ef_search)
            )
        if not self._loaded and not self.load_collection():
            return PendingSearch(hits=[[] for _ in range(b)])
        if self._sharded is not None:
            return self._search_sharded(q, k_eff, method, requested)
        if method == "sketch" or self.config.device_dtype == "host":
            # capacity tier: device int8 sketch screen + host-row exact fp32
            # re-rank; selection approximate, scores exact (HNSW contract)
            if self.config.device_dtype == "host" and requested not in (
                None, "sketch", "hnsw",
            ):
                raise ValueError(
                    f"method={requested!r} promises full-precision "
                    "residency the host tier does not keep; host-resident "
                    "stores serve method='sketch' (or 'hnsw')"
                )
            vals, idx = sketch_search_host_rerank(
                self._ensure_sketch(), self._vectors, self._host_weights(), q,
                k=k_eff, m=self.config.sketch_fetch or 0,
            )
            self._count(b)
            return PendingSearch(hits=self.build_hits(vals, idx))
        if method == "chunkstream" and self.config.device_dtype != "float32":
            raise ValueError(
                "chunkstream requires fp32 device residency "
                "(STORE_DEVICE_DTYPE=float32)"
            )
        q = q.to(self.device, torch.float32) if on_device else torch.from_numpy(q).to(self.device)
        if "corpus_q" in self._dev:
            return self._search_int8(q, k_eff, method)
        corpus, weights, mask = (self._dev[key] for key in ("corpus", "weights", "mask"))
        cert = None  # set by the certified methods; read in finalize()
        if method == "chunkstream":
            engine, _ = self._chunkstream_scan()
            vals, idx, cert = chunk_stream.search(
                self._ensure_chunkstore(), q, k=k_eff, scan=engine
            )
        elif method in ("fast", "chunk") and corpus.dtype == torch.float32:
            # certified chunk select over K1's IEEE fp32 scan (the port's
            # Precision.HIGH, ops/rerank.py); an uncertified batch is redone
            # on the exact path in finalize()
            vals, idx, cert = chunk_select_search(
                q, corpus, weights, mask, k=k_eff, scan_precision="high",
                guarantee=False, bound_scale=self._bound_scale,
            )
        elif method == "streaming" and k_eff <= STREAMING_K_MAX:
            vals, idx, cert = streaming_topk(
                q, corpus, weights, mask, k=k_eff, guarantee=False
            )
        else:
            flat = method if method in ("approx", "streaming") else "exact"
            vals, idx = fused_search(q, corpus, weights, mask, k=k_eff, method=flat)

        def _finalize():
            v, i = vals, idx
            if cert is not None:
                certified = int(cert.sum())
                with self._searches_lock:
                    self._cert["queries"] += b
                    self._cert["certified"] += certified
                    self._cert["redos"] += certified < b
                if certified < b:
                    # near-ties at the candidate boundary: redo the whole
                    # batch on the exact path (the certified methods'
                    # host-mediated exactness contract)
                    v, i = fused_search(q, corpus, weights, mask, k=k_eff)
            return self._materialize(v, i)

        return PendingSearch(finalize=_finalize)

    def _search_sharded(self, q, k: int, method: str, requested) -> PendingSearch:
        """The per-request method, honored per shard (``hnsw`` was served
        above; a method the shards do not serve, ``sketch`` too, raises
        for the API's 400). ``exact`` runs the shards' ``auto``
        (K2 up to k = 128). int8 shards select a merged over-fetch of m =
        max(min(_bucket_k(4k), shard rows, N), k) candidates that the host
        re-ranks in exact fp32 (the single-device int8 host contract); a
        configured fp32-kernel default the int8 shards do not serve takes
        their exact scan, an explicit one raises. Padding ids are dropped
        by ``build_hits``."""
        sharded = self._sharded
        smethod = "auto" if method == "exact" else method
        b = q.shape[0]
        if sharded.store_dtype == "int8":
            if smethod not in ("auto", "exact", "chunkstream") and requested is None:
                smethod = "exact"
            m = max(min(_bucket_k(4 * k), sharded.shard_rows, self.num_entities), k)
            _, cand = sharded.search(q, k=m, method=smethod)
            cand = np.where(cand < self.num_entities, cand, -1)
            vals, idx = self._host_rerank(self._host(q), cand, k)
        else:
            vals, idx = sharded.search(q, k=k, method=smethod)
        self._count(b)
        return PendingSearch(hits=self.build_hits(vals, idx))

    def _search_int8(self, q: torch.Tensor, k: int, method: str) -> PendingSearch:
        """int8 residency: int8 selection (ops/quantized.py), then a
        re-rank where INT8_RERANK says: "device" with the full-precision
        query against the dequantized rows (the int8 matrix is the only
        corpus-sized array), "host" in exact fp32 against the host rows
        (the fp32 path's hits). Over-fetch from the JAX store's k grid."""
        dev = self._dev
        args = (q, dev["corpus_q"], dev["scale"], dev["weights"], dev["mask"])
        select = "approx" if method == "approx" else "exact"
        kg = _bucket_k(k)
        if self.config.int8_rerank == "device":
            vals, idx = int8_search_device_rerank(
                *args, k=k, m=max(4 * kg, kg + 16), method=select
            )
            return PendingSearch(finalize=lambda: self._materialize(vals, idx))
        _, cand = int8_search(*args, k=min(4 * kg, self.num_entities), method=select)
        vals, idx = self._host_rerank(self._host(q), cand.cpu().numpy(), k)
        self._count(q.shape[0])
        return PendingSearch(hits=self.build_hits(vals, idx))

    def _materialize(self, vals: torch.Tensor, idx: torch.Tensor) -> List[List[SearchHit]]:
        hits = self.build_hits(vals.cpu().numpy(), idx.cpu().numpy())
        self._count(len(hits))
        return hits

    @staticmethod
    def _host(q) -> np.ndarray:
        if isinstance(q, torch.Tensor):
            return q.detach().to(torch.float32).cpu().numpy()
        return np.asarray(q, dtype=np.float32)

    def _host_weights(self) -> np.ndarray:
        return self.corpus.level_weights(self.config.level_weights)

    def _count(self, b: int) -> None:
        with self._searches_lock:
            self._searches += b

    def _host_rerank(self, q: np.ndarray, cand: np.ndarray, k: int):
        """Exact fp32 weighted scores of the (B, m) candidate rows from the
        host matrix, and their top-k (the int8 tier's host re-rank)."""
        safe = np.clip(cand, 0, self.num_entities - 1)
        exact = np.einsum("bd,bkd->bk", q, self._vectors[safe]) * self._host_weights()[safe]
        exact = np.where(cand >= 0, exact, -np.inf)
        order = np.argsort(-exact, axis=1)[:, :k]
        return np.take_along_axis(exact, order, axis=1), np.take_along_axis(cand, order, axis=1)

    def build_hits(
        self, vals: np.ndarray, idx: np.ndarray
    ) -> List[List[SearchHit]]:
        """Materialize SearchHit rows from (values, indices) arrays."""
        weights = self.corpus.level_weights(self.config.level_weights)
        n = self.num_entities
        out: List[List[SearchHit]] = []
        for row_vals, row_idx in zip(np.asarray(vals), np.asarray(idx)):
            hits = []
            for val, j in zip(row_vals, row_idx):
                j = int(j)
                if j < 0 or j >= n:  # padding rows
                    continue
                w = float(weights[j]) or 1.0
                hits.append(self._hit(j, score=float(val), original_score=float(val) / w))
            out.append(hits)
        return out

    # ------------------------------------------------------------- HNSW

    def build_hnsw(self, M: Optional[int] = None, ef_construction: Optional[int] = None):
        """Build (or return) the native C++ graph index over the corpus —
        the path for corpora beyond brute force. Search applies the same
        level-weight x resort post-pass the flat path fuses on the device."""
        if self._hnsw is not None and len(self._hnsw) == self.num_entities:
            return self._hnsw
        from .hnsw_index import HNSWIndex

        idx = HNSWIndex(
            dim=self.dim,
            M=M or self.hnsw_config.M,
            ef_construction=ef_construction or self.hnsw_config.ef_construction,
            vec_dtype=getattr(self.hnsw_config, "vec_dtype", "float32"),
        )
        idx.add(self._vectors)
        idx.compact()  # drop build-time allocation slack
        self._hnsw = idx
        return idx

    def _search_hnsw(
        self, q: np.ndarray, k_eff: int, ef_search: Optional[int] = None
    ) -> List[List[SearchHit]]:
        """Graph search with weighted-semantics parity: the flat path ranks
        by level-WEIGHTED score, but the graph traverses raw IP, so a x1.2
        level-1 row can sit below the raw-IP top-k yet inside the weighted
        top-k. The graph over-fetches (starting at 2k, the factor the
        orchestrator uses before rescoring, multi_diagnosis_service.py:153)
        and then checks a bound per query: any unfetched row has raw IP <=
        the last fetched raw IP, hence weighted score <= last_raw x max
        weight; if the k-th weighted score already beats that bound, the
        weighted top-k is complete relative to the graph's raw ordering.
        Queries failing the bound refetch with doubled k.

        bf16 graphs (HNSW_VEC_DTYPE=bfloat16: half the graph memory)
        return bf16-rounded IPs: the fetched candidates re-rank EXACTLY
        against the host fp32 matrix, and the completeness bound widens by
        the bf16 dot error (``eps_bf16_dot``), so rounding can never hide
        an unfetched winner among the rows the traversal visited.

        Both bounds are relative to the graph's raw ordering: a row the
        greedy descent never reached is outside their reach, which is
        inherent to HNSW (approximate even at fp32). Callers needing
        exactness use the flat methods, which are certificate-backed."""
        idx = self.build_hnsw()
        weights = self._host_weights()
        max_w = float(np.max(self.config.level_weights))
        min_w = float(np.min(self.config.level_weights))
        n = self.num_entities
        is_bf16 = getattr(idx, "vec_dtype", "float32") == "bfloat16"
        if is_bf16:
            q_norms = np.linalg.norm(q, axis=1)
            # the unweighted max row norm (dividing _bound_scale by max_w
            # would underestimate it where the largest weight present is
            # below the configured one)
            c_norm_max = (
                self._max_row_norm
                if self._max_row_norm
                else float(np.linalg.norm(self._vectors, axis=1).max())
            )
            eps_rows = (eps_bf16_dot(self.dim) * c_norm_max) * q_norms  # (B,)
        k_fetch = min(2 * k_eff, n)
        while True:
            ef = max(ef_search or self.hnsw_config.ef_search, k_fetch)
            ips, ids = idx.search(q, k_fetch, ef)
            valid = ids >= 0
            if is_bf16:
                # exact fp32 re-rank of the fetched candidate rows
                safe = np.clip(ids, 0, n - 1)
                ips = np.where(
                    valid, np.einsum("bd,bkd->bk", q, self._vectors[safe]), ips
                ).astype(np.float32)
            if k_fetch >= n:
                break
            w_rows = np.where(valid, weights[np.clip(ids, 0, n - 1)], 0.0)
            weighted = np.where(valid, ips * w_rows, -np.inf)
            kth_weighted = -np.sort(-weighted, axis=1)[:, k_eff - 1]
            last_raw = np.where(valid, ips, np.inf).min(axis=1)
            if is_bf16:
                # unfetched rows are ordered by bf16 IP; their TRUE IP can
                # exceed the last fetched TRUE IP by twice the bf16 dot error
                last_raw = last_raw + 2.0 * eps_rows
            # an unfetched row's weighted score is bounded by last_raw *
            # max_w when last_raw >= 0, by last_raw * MIN_w when negative
            bound = np.where(last_raw >= 0, last_raw * max_w, last_raw * min_w)
            if np.all(kth_weighted >= bound - 1e-6):
                break
            k_fetch = min(2 * k_fetch, n)
        self._count(q.shape[0])
        out: List[List[SearchHit]] = []
        for row_ips, row_ids in zip(ips, ids):
            hits = [
                self._hit(int(j), score=float(ip) * (float(weights[j]) or 1.0),
                          original_score=float(ip))
                for ip, j in zip(row_ips, row_ids) if j >= 0
            ]
            hits.sort(key=lambda h: h.score, reverse=True)
            out.append(hits[:k_eff])
        return out

    def semantic_similarities(
        self, query_vectors: np.ndarray, candidate_ids: np.ndarray
    ) -> np.ndarray:
        """Cosine(query, semantic_text embedding) for candidate rows — a
        host gather + dot replacing the reference's 2-forwards-per-
        candidate re-embedding (hierarchical_similarity_service.py:387-409).

        query_vectors: (B, D); candidate_ids: (B, K) -> (B, K) fp32.
        """
        src = (
            self._semantic_vectors
            if self._semantic_vectors is not None
            else self._vectors
        )
        if src is None:
            return np.zeros(candidate_ids.shape, dtype=np.float32)
        q = np.atleast_2d(np.asarray(query_vectors, np.float32))
        cand = src[np.asarray(candidate_ids, np.int64)]  # (B, K, D)
        return np.einsum("bd,bkd->bk", q, cand).astype(np.float32)

    # ------------------------------------------------------------ stats

    def get_collection_stats(self) -> Dict:
        """Reference analog: milvus_service.py:457-496."""
        return {
            "collection_name": self.config.collection_name,
            "num_entities": self.num_entities,
            "dim": self.dim,
            "index_type": self.config.index_type,
            "metric_type": self.config.metric_type,
            "search_method": self.config.search_method,
            "index_params": {
                "M": self.hnsw_config.M,
                "ef_construction": self.hnsw_config.ef_construction,
                "ef_search": self.hnsw_config.ef_search,
            },
            "loaded": self._loaded,
            "searches_served": self._searches,
            "certificate": dict(self._cert),
            "memory": self.get_memory_usage(),
        }

    def get_memory_usage(self) -> Dict:
        """Estimate = n·dim·4 bytes (formula parity: milvus_service.py:515);
        ``device_vector_bytes`` is the residency cost under the configured
        dtype (bf16 halves it, int8 quarters it plus per-row scales, the
        host tier keeps only the sketch screen, a sharded store sums its
        shards' rows, padding included); ``chunkstore_device_bytes`` is
        what a built chunk store adds on top (its scan matrix and scales,
        and its raw rows where they are not the resident corpus itself)."""
        vector_bytes = self.num_entities * self.dim * 4
        dtype = self.config.device_dtype
        per_elem = {"float32": 4, "bfloat16": 2, "int8": 1}.get(dtype, 4)
        device_bytes = self.num_entities * self.dim * per_elem
        if dtype == "int8":
            device_bytes += self.num_entities * 4  # per-row scales
        if self._sharded is not None:
            device_bytes = self._sharded.device_bytes  # summed over the shards
        if dtype == "host":
            device_bytes = (
                self._sketch.device_bytes
                if self._sketch is not None
                else self.num_entities * (self.config.sketch_dim + 12)
            )
        cs, chunk_bytes = self._chunkstore, 0
        if cs is not None:
            chunk_bytes = cs.device_bytes
            if self._dev is None or cs.corpus.data_ptr() != self._dev["corpus"].data_ptr():
                chunk_bytes += cs.corpus.numel() * 4
        return {
            "num_entities": self.num_entities,
            "dim": self.dim,
            "estimated_vector_memory_bytes": vector_bytes,
            "estimated_vector_memory_mb": round(vector_bytes / 1024 / 1024, 2),
            "device_vector_bytes": device_bytes,
            "device_vector_mb": round(device_bytes / 1024 / 1024, 2),
            "device_resident": self._loaded,
            "device_dtype": self.config.device_dtype,
            "chunkstore_device_bytes": chunk_bytes,
            "sharded": self._sharded is not None,
        }

    def _device_reachable(self) -> bool:
        return self.device.type == "cpu" or torch.cuda.is_available()

    def health_check(self) -> Dict:
        """Reference analog: milvus_service.py:524-549."""
        status = "healthy"
        checks = {
            "has_data": self.num_entities > 0,
            "device_loaded": self._loaded,
            "device_reachable": self._device_reachable(),
        }
        if not all(checks.values()):
            status = "degraded" if checks["has_data"] else "unhealthy"
        return {"status": status, "checks": checks, "num_entities": self.num_entities}

    def test_connection(self) -> bool:
        return self._device_reachable()

    # ------------------------------------------------------------- persist

    def save(self, path: Optional[str] = None) -> str:
        """Persist vectors (.npz) + metadata (.meta.json) + manifest, and a
        built graph (.hnsw): the JAX package's on-disk layout."""
        base = Path(path or self.config.db_path)
        base.parent.mkdir(parents=True, exist_ok=True)
        arrays = {"vectors": self._vectors}
        if self._semantic_vectors is not None:
            arrays["semantic_vectors"] = self._semantic_vectors
        np.savez(str(base) + ".npz", **arrays)
        self.corpus.to_json(str(base) + ".meta.json")
        if self._hnsw is not None:
            self._hnsw.save(str(base) + ".hnsw")
        manifest = {
            "collection_name": self.config.collection_name,
            "dim": self.dim,
            "num_entities": self.num_entities,
            "index_type": self.config.index_type,
            "metric_type": self.config.metric_type,
            "created_at": self._created_at,
            "saved_at": time.time(),
        }
        Path(str(base) + ".manifest.json").write_text(json.dumps(manifest))
        return str(base)

    @classmethod
    def load(
        cls,
        path: str,
        config: Optional[StoreConfig] = None,
        hnsw_config=None,
        device: Union[str, torch.device] = "cuda",
    ) -> "VectorStore":
        """Load a store saved by either package, with its persisted HNSW
        graph (``<path>.hnsw``) where there is one. A graph file that does
        not load (``OSError``) is left to be rebuilt on demand."""
        manifest = json.loads(Path(path + ".manifest.json").read_text())
        store = cls(
            dim=manifest["dim"], config=config, hnsw_config=hnsw_config,
            device=device,
        )
        data = np.load(path + ".npz")
        store._vectors = data["vectors"]
        if "semantic_vectors" in data:
            store._semantic_vectors = data["semantic_vectors"]
        store.corpus = ICDCorpus.from_json(path + ".meta.json")
        hnsw_path = Path(path + ".hnsw")
        if hnsw_path.exists():
            from .hnsw_index import HNSWIndex

            try:
                store._hnsw = HNSWIndex.load(str(hnsw_path))
            except OSError:
                store._hnsw = None  # rebuilt lazily on demand
        return store

    @staticmethod
    def exists(path: str) -> bool:
        return Path(path + ".npz").exists() and Path(path + ".meta.json").exists()
