"""Device-resident vector store — the Milvus-Lite replacement, flat paths.

Counterpart of rag_icd10_tpu/index/vector_store.py. API parity with the
reference MilvusService (services/milvus_service.py): ``insert_records``
(:208), ``search`` (:271, level-weighted + re-sorted),
``load_collection``/``release_collection`` (:343,:411),
``clear_collection``, ``get_collection_stats``, ``get_memory_usage``
(:497, bytes = n*dim*4), ``health_check`` (:524), ``test_connection``
(:373).

- The collection is a padded (N, D) matrix resident on the device (fp32
  or bfloat16) plus host-side metadata columns; persistence is the JAX
  package's .npz + JSON sidecars, byte for byte the same layout, so a
  store saved by either package loads in the other.
- ``search`` takes a BATCH of query vectors and issues ONE scoring-kernel
  launch plus ``torch.topk`` (ops/fused_score.py); the level weights
  x{1.2, 1.0, 0.8} (milvus_service.py:550-558) are fused into the
  kernel's epilogue. A corpus on a CUDA device goes through the
  hand-written kernels; a corpus on the CPU through their plain versions.
- Served methods: "exact" and "approx" (both exact top-k); "streaming"
  (in-kernel slot top-k, ops/fused_score.py ``streaming_topk``); and
  "chunkstream" (chunk-select over a ``CHUNKSTREAM_SCAN`` pass 1 and an
  exact fp32 pass 2, ops/chunk_stream.py; fp32 residency only). The two
  certified methods return a per-query certificate with their top-k;
  ``finalize`` reads it and redoes an uncertified batch on the exact
  path, so every served method is exact. "fast", "sketch", "hnsw", the
  HNSW index type, int8 and host residency, and ``sharded="on"`` raise
  ``ValueError`` ("not yet ported"), which the API maps to HTTP 400.
  ``sharded="auto"`` means one device.
- No shape bucketing: PyTorch runs eagerly and the kernel masks ragged
  edges, so queries go in at their own batch size and top-k at k.
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
from ..utils.device import resolve_device

SERVED_METHODS = ("exact", "approx", "streaming", "chunkstream")
UNPORTED_METHODS = ("fast", "chunk", "sketch", "hnsw")
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


def _not_ported(what: str) -> ValueError:
    return ValueError(
        f"{what} not yet ported to rag_icd10_tpu_torch "
        f"(served search methods: {', '.join(SERVED_METHODS)})"
    )


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
    ):
        from ..config import HNSWConfig

        self.device = resolve_device(device)
        self.config = config or StoreConfig()
        self.hnsw_config = hnsw_config or HNSWConfig()
        self.dim = dim
        self.corpus: Optional[ICDCorpus] = None
        self._vectors: Optional[np.ndarray] = None  # host (N, D) fp32
        self._title_rows: Optional[Dict[str, List[int]]] = None
        # device-resident state (set by load_collection)
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._semantic_vectors: Optional[np.ndarray] = None
        self._chunkstore = None  # ops/chunk_stream state (method="chunkstream")
        self._loaded = False
        self._searches = 0
        # queries of the certified methods, those certified, and batches
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
        self._chunkstore = None  # covers only the old rows
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

    def load_collection(self) -> bool:
        """Pad + transfer the corpus matrix, level weights and padding mask
        to the device (reference analog: milvus_service.py:343)."""
        if self._vectors is None or self.corpus is None:
            return False
        dtype = self.config.device_dtype
        if dtype not in ("float32", "bfloat16"):
            raise _not_ported(f"STORE_DEVICE_DTYPE={dtype!r} residency")
        if (self.config.sharded or "auto").lower() == "on":
            raise _not_ported("STORE_SHARDED=on (multi-device corpus sharding)")
        weights = self.corpus.level_weights(self.config.level_weights)
        cp, wp, m = pad_corpus(
            self._vectors, weights, multiple=self.config.pad_multiple
        )
        corpus = torch.from_numpy(cp).to(self.device)
        if dtype == "bfloat16":
            corpus = corpus.to(torch.bfloat16)
        self._dev = {
            "corpus": corpus,
            "weights": torch.from_numpy(wp).to(self.device),
            "mask": torch.from_numpy(m).to(self.device),
        }
        self._loaded = True
        return True

    def release_collection(self) -> bool:
        """Drop device tensors (reference analog: milvus_service.py:411)."""
        self._dev = None
        self._chunkstore = None
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

        Enqueues the method's kernels and ``torch.topk`` without waiting
        and returns a PendingSearch whose ``finalize()`` reads the
        certificate of "streaming" and "chunkstream" (redoing an
        uncertified batch on the exact path), copies the results to the
        host and builds the hits. ``method`` is a per-request override of
        the configured default; "streaming" with k > 128 takes the
        materialized exact path, as in the JAX package. ``ef_search``
        belongs to the unported HNSW path and is accepted for signature
        parity. Query tensors stay on the device; host arrays are copied
        up once."""
        method = method or self.config.search_method
        on_device = isinstance(query_vectors, torch.Tensor)
        if on_device:
            q = query_vectors if query_vectors.ndim == 2 else query_vectors[None, :]
        else:
            q = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        if self.num_entities == 0:
            return PendingSearch(hits=[[] for _ in range(q.shape[0])])
        if self.config.index_type.upper() == "HNSW":
            raise _not_ported("INDEX_TYPE=HNSW")
        if method in UNPORTED_METHODS:
            raise _not_ported(f"search method {method!r}")
        if method not in SERVED_METHODS:
            raise ValueError(f"unknown search method {method!r}")
        k_eff = min(max(top_k, 1), self.num_entities)
        if not self._loaded and not self.load_collection():
            return PendingSearch(hits=[[] for _ in range(q.shape[0])])
        dev = self._dev
        corpus, weights, mask = dev["corpus"], dev["weights"], dev["mask"]
        q = q.to(corpus.device, torch.float32) if on_device else torch.from_numpy(q).to(corpus.device)
        cert = None  # set by the certified methods; read in finalize()
        if method == "chunkstream":
            if corpus.dtype != torch.float32:
                raise ValueError(
                    "chunkstream requires fp32 device residency "
                    "(STORE_DEVICE_DTYPE=float32)"
                )
            engine, _ = self._chunkstream_scan()
            vals, idx, cert = chunk_stream.search(
                self._ensure_chunkstore(), q, k=k_eff, scan=engine
            )
        elif method == "streaming" and k_eff <= STREAMING_K_MAX:
            vals, idx, cert = streaming_topk(
                q, corpus, weights, mask, k=k_eff, guarantee=False
            )
        else:
            vals, idx = fused_search(q, corpus, weights, mask, k=k_eff, method=method)
        b = q.shape[0]

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
            hits = self.build_hits(v.cpu().numpy(), i.cpu().numpy())
            with self._searches_lock:
                self._searches += b
            return hits

        return PendingSearch(finalize=_finalize)

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
        dtype (bf16 halves it); ``chunkstore_device_bytes`` is what a built
        chunk store adds on top (its scan matrix and scales, and its raw
        rows where they are not the resident corpus itself)."""
        vector_bytes = self.num_entities * self.dim * 4
        per_elem = {"float32": 4, "bfloat16": 2}.get(self.config.device_dtype, 4)
        device_bytes = self.num_entities * self.dim * per_elem
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
            "sharded": False,
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
        """Persist vectors (.npz) + metadata (.meta.json) + manifest, the
        JAX package's on-disk layout."""
        base = Path(path or self.config.db_path)
        base.parent.mkdir(parents=True, exist_ok=True)
        arrays = {"vectors": self._vectors}
        if self._semantic_vectors is not None:
            arrays["semantic_vectors"] = self._semantic_vectors
        np.savez(str(base) + ".npz", **arrays)
        self.corpus.to_json(str(base) + ".meta.json")
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
        """Load a store saved by either package. A persisted HNSW graph
        (``<path>.hnsw``) is left on disk: the graph path is not yet
        ported, and the flat methods do not need it."""
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
        return store

    @staticmethod
    def exists(path: str) -> bool:
        return Path(path + ".npz").exists() and Path(path + ".meta.json").exists()
