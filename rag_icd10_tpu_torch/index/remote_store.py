"""Remote vector-store client: share one device-resident corpus from
another host.

Counterpart of rag_icd10_tpu/index/remote_store.py (the same client; the
peer is the port's API server). Reference parity: ``MILVUS_MODE=server``
connects the reference to a remote Milvus over gRPC
(services/milvus_service.py:57-118). In this framework the API server IS
the store server — its corpus lives in device memory — so a second host
sets ``STORE_MODE=remote`` + ``STORE_SERVER_URL=http://host:8005`` and
gets a VectorStore-compatible
client that forwards vector search (and the rescoring stack's
semantic-similarity gathers) over HTTP to the serving host's
``/vector_search`` / ``/semantic_similarities`` endpoints.

Corpus METADATA (codes, titles, hierarchy — a few MB) loads from the
local CSV so the host-side rescoring/confidence stack works unchanged;
only the vector math crosses the wire. Documented divergence from the
reference's remote mode: ingestion stays on the serving host
(tools/build_database there) — a remote ``insert_records`` raises
instead of silently mutating a store other clients share.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .vector_store import SearchHit


class RemoteStoreError(RuntimeError):
    pass


class RemoteVectorStore:
    """VectorStore-surface client over a peer API server."""

    accepts_device_queries = False

    def __init__(self, url: str, corpus=None, timeout: float = 30.0):
        import httpx

        self.url = url.rstrip("/")
        self.corpus = corpus  # local ICDCorpus metadata (may be None)
        self._client = httpx.Client(base_url=self.url, timeout=timeout)
        self._num_entities: Optional[int] = None
        self._dim: Optional[int] = None

    # ------------------------------------------------------------ lifecycle

    @property
    def is_loaded(self) -> bool:
        return True  # residency is the serving host's concern

    def load_collection(self) -> bool:
        """No-op: a client must not flip residency for every other
        client sharing the serving host; use /resource/* on the server
        itself for lifecycle control."""
        return self.health_check().get("healthy", False)

    def release_collection(self) -> None:
        return None

    @property
    def num_entities(self) -> int:
        if not self._num_entities:
            # no negative caching: a client that boots during the serving
            # host's 60-90s init must recover once the peer is healthy
            self._refresh_health()
        return self._num_entities or 0

    @property
    def dim(self) -> int:
        if self._dim is None:
            stats = self.get_collection_stats()
            self._dim = int(stats.get("dim", 0))
        return self._dim or 0

    def _refresh_health(self) -> None:
        h = self.health_check()
        if h.get("healthy"):
            self._num_entities = int(h.get("total_records", 0))

    # -------------------------------------------------------------- search

    def search(
        self,
        query_vectors: np.ndarray,
        top_k: int = 5,
        method: Optional[str] = None,
        ef_search: Optional[int] = None,
    ) -> List[List[SearchHit]]:
        q = np.atleast_2d(np.asarray(query_vectors, dtype=np.float32))
        payload = {"vectors": q.tolist(), "top_k": int(top_k)}
        if method:
            payload["search_method"] = method
        if ef_search:
            payload["ef_search"] = int(ef_search)
        r = self._client.post("/vector_search", json=payload)
        if r.status_code != 200:
            raise RemoteStoreError(
                f"remote search failed ({r.status_code}): {r.text[:200]}"
            )
        rows = r.json()["rows"]
        return [
            [SearchHit(**hit) for hit in row]
            for row in rows
        ]

    def semantic_similarities(
        self, query_vectors: np.ndarray, candidate_ids: np.ndarray
    ) -> np.ndarray:
        payload = {
            "query_vectors": np.asarray(
                query_vectors, np.float32
            ).tolist(),
            "candidate_ids": np.asarray(candidate_ids, np.int64).tolist(),
        }
        r = self._client.post("/semantic_similarities", json=payload)
        if r.status_code != 200:
            raise RemoteStoreError(
                f"remote semantic_similarities failed ({r.status_code})"
            )
        return np.asarray(r.json()["sims"], dtype=np.float32)

    # --------------------------------------------------------------- stats

    def test_connection(self) -> bool:
        return self.health_check().get("healthy", False)

    def health_check(self) -> dict:
        try:
            r = self._client.get("/health")
            j = r.json()
            return {
                "healthy": r.status_code == 200
                and j.get("status") == "healthy",
                "total_records": j.get("total_records", 0),
                "remote": self.url,
            }
        except Exception as e:
            return {"healthy": False, "error": str(e), "remote": self.url}

    def get_collection_stats(self) -> dict:
        r = self._client.get("/stats")
        if r.status_code != 200:
            raise RemoteStoreError(f"remote stats failed ({r.status_code})")
        stats = r.json().get("milvus", {})  # /stats nests store stats there
        stats["mode"] = "remote"
        stats["remote_url"] = self.url
        return stats

    def get_memory_usage(self) -> dict:
        stats = self.get_collection_stats()
        return stats.get("memory", {"mode": "remote"})

    # -------------------------------------------------------------- ingest

    def insert_records(self, records, vectors, semantic_vectors=None) -> int:
        raise RemoteStoreError(
            "remote stores are read-only from clients — run "
            "tools/build_database on the serving host (its store is "
            "shared by every connected client)"
        )

    def close(self) -> None:
        try:
            self._client.close()
        except Exception:
            pass
