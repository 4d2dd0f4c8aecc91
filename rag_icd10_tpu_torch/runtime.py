"""Engine: the service container wiring encoder, store and pipeline.

Counterpart of rag_icd10_tpu/runtime.py. Replaces the reference's
module-level singletons + lifespan init (reference: main.py:25-28,31-105
— Embedding -> Milvus -> LLM -> MultiDiagnosis, with non-fatal LLM test).
Initialization order, the ``<db>.encoder.json`` pairing and the
degradation ladder are preserved; construction is explicit instead of
global. Encoder and store run on ``device`` (``cuda`` unless the caller
passes ``"cpu"``).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional, Union

import torch

from .config import Config, get_config
from .data.corpus import load_corpus
from .index.vector_store import VectorStore
from .models.encoder import TextEncoder
from .models.tokenizer import WordPieceTokenizer
from .pipeline.llm import LLMService
from .pipeline.ner import MedicalNERService
from .pipeline.orchestrator import MultiDiagnosisService
from .pipeline.textproc import DiagnosisTextProcessor
from .utils.device import resolve_device

logger = logging.getLogger("rag_icd10_tpu_torch")


class Engine:
    """Lazily-wired service graph with the reference's init order."""

    def __init__(
        self,
        config: Optional[Config] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or get_config()
        self.encoder: Optional[TextEncoder] = None
        self.store: Optional[VectorStore] = None
        self.llm: Optional[LLMService] = None
        self.ner: Optional[MedicalNERService] = None
        self.matcher: Optional[MultiDiagnosisService] = None
        self.started_at = time.time()
        self.llm_status: dict = {}

    # ------------------------------------------------------- constructors

    def _encoder_sidecar(self) -> dict:
        """The database build records which encoder produced the persisted
        store (<db>.encoder.json); serving defaults to those weights so
        queries and corpus vectors can never silently mismatch."""
        import json

        path = Path(str(self.config.store.db_path) + ".encoder.json")
        if path.exists():
            try:
                sidecar = json.loads(path.read_text())
                # older sidecars may hold relative paths; resolve them
                # against the store's parent directory's parent (repo root
                # convention: db/... lives next to the store)
                for key in ("weights_path", "vocab_path"):
                    p = sidecar.get(key)
                    if p and not Path(p).is_absolute() and not Path(p).exists():
                        candidate = path.parent.parent / p
                        if candidate.exists():
                            sidecar[key] = str(candidate)
                return sidecar
            except (OSError, json.JSONDecodeError):
                pass
        return {}

    def _tokenizer(self) -> WordPieceTokenizer:
        cfg = self.config
        vocab_path = (
            cfg.encoder.vocab_path
            or self._encoder_sidecar().get("vocab_path")
            or str(Path(cfg.store.db_path).with_suffix("")) + ".vocab.txt"
        )
        if Path(vocab_path).exists():
            return WordPieceTokenizer.from_vocab_file(vocab_path)
        corpus = load_corpus(cfg.data_path)
        tok = WordPieceTokenizer.from_corpus(corpus.titles + corpus.semantic_texts)
        try:
            tok.save_vocab(vocab_path)
        except OSError:
            pass
        return tok

    def init_encoder(self) -> TextEncoder:
        if self.encoder is None:
            cfg = self.config.encoder
            sidecar = self._encoder_sidecar()
            if not cfg.weights_path and sidecar.get("weights_path"):
                if Path(sidecar["weights_path"]).exists():
                    import dataclasses

                    logger.info(
                        "using store's encoder weights: %s", sidecar["weights_path"]
                    )
                    cfg = dataclasses.replace(
                        cfg, weights_path=sidecar["weights_path"]
                    )
                else:
                    logger.warning(
                        "store was built with weights %s which no longer "
                        "exist — queries may mismatch the corpus vectors",
                        sidecar["weights_path"],
                    )
            logger.info("initializing encoder (%s)", cfg.model_name)
            self.encoder = TextEncoder(
                cfg, tokenizer=self._tokenizer(), device=self.device
            )
        return self.encoder

    def init_store(self, load: bool = True) -> VectorStore:
        if self.store is None:
            cfg = self.config.store
            if cfg.mode in ("remote", "server") and cfg.server_url:
                # share a peer API server's device-resident corpus
                # (reference: MILVUS_MODE=server, milvus_service.py:57-118)
                from .index.remote_store import RemoteVectorStore

                logger.info("remote store mode -> %s", cfg.server_url)
                # corpus=None (NOT load_corpus's synthetic fallback: fake
                # titles would poison the terminology cache) when the real
                # CSV is absent: remote hits carry all metadata and
                # corpus-wide features degrade cleanly
                corpus = None
                if self.config.data_path and Path(self.config.data_path).exists():
                    corpus = load_corpus(self.config.data_path)
                else:
                    logger.warning(
                        "no local corpus CSV — remote hits carry all "
                        "metadata; terminology features degrade gracefully"
                    )
                self.store = RemoteVectorStore(cfg.server_url, corpus=corpus)
                return self.store
            base = self.config.store.db_path
            if VectorStore.exists(base):
                logger.info("loading persisted store from %s", base)
                self.store = VectorStore.load(
                    base, config=self.config.store, hnsw_config=self.config.hnsw,
                    device=self.device,
                )
            else:
                logger.warning("no persisted store at %s — empty collection", base)
                self.store = VectorStore(
                    dim=self.config.encoder.hidden_size,
                    config=self.config.store,
                    hnsw_config=self.config.hnsw,
                    device=self.device,
                )
            if load and self.store.num_entities:
                self.store.load_collection()
        return self.store

    def init_llm(self) -> LLMService:
        if self.llm is None:
            self.llm = LLMService(self.config.llm)
        return self.llm

    def init_matcher(self) -> MultiDiagnosisService:
        if self.matcher is None:
            encoder = self.init_encoder()
            store = self.init_store()
            self.ner = MedicalNERService(self.config.ner, device=self.device)
            self.matcher = MultiDiagnosisService(
                encoder=encoder,
                store=store,
                ner_service=self.ner,
                text_processor=DiagnosisTextProcessor(
                    encoder=encoder,
                    use_enhanced_processing=self.config.pipeline.use_enhanced_text_processing,
                    ner_service=self.ner,
                ),
                overfetch=self.config.pipeline.overfetch,
            )
        return self.matcher

    def startup(self, test_llm: bool = False, warmup: bool = True) -> None:
        """Full init in the reference's order; LLM test is non-fatal
        (main.py:69-89)."""
        self.init_encoder()
        self.init_store()
        self.init_llm()
        if test_llm:
            try:
                self.llm_status = self.llm.test_connection()
            except Exception as e:
                self.llm_status = {"connected": False, "error": str(e)}
        self.init_matcher()
        if warmup and self.store.num_entities:
            self.warmup()

    def warmup(self) -> None:
        """Run the serving shapes once (encoder buckets, search batch
        sizes) before the first user request: the first launches pay
        cuBLAS handle creation, allocator growth and the kernel library's
        load. Covers every power-of-two coalesced-batch bucket the batcher
        can produce up to max_batch, for both common top_k values; under
        FUSED_QUERY=1 that captures the fused engine's graphs for those
        buckets, so no request pays for a capture. A failure here is a
        failure of the serving path and propagates."""
        t0 = time.time()
        logger.info("warmup: running serving shapes...")
        for text in ("急性胃肠炎", "急性胃肠炎，高血压病3级，2型糖尿病"):
            for top_k in (5, 10):
                self.matcher.match_many_texts([text], top_k=top_k)
        seeds = ["急性胃肠炎", "高血压病3级", "疑似肺部感染", "2型糖尿病",
                 "慢性阻塞性肺疾病急性加重，冠状动脉粥样硬化性心脏病"]
        size, max_rows = 2, max(self.config.api.max_batch, 8)
        sizes = []
        while size <= max_rows:
            sizes.append(size)
            size *= 2
        # multi-diagnosis seeds can push flat sub-diagnosis rows one
        # pow2 bucket past max_batch — cover it too
        sizes.append(max_rows * 2)
        for size in sizes:
            batch = (seeds * ((size // len(seeds)) + 1))[:size]
            for top_k in (5, 10):
                self.matcher.match_many_texts(batch, top_k=top_k)
        fused = self.matcher._fused
        if fused is not None:  # FUSED_QUERY=1: the warmup captured its graphs
            stats = fused.stats()
            logger.info(
                "warmup: fused query captured %d CUDA graphs in %.1fs",
                stats["graphs"], stats["capture_s"],
            )
        self._warmup_extra_methods([1] + sizes)
        logger.info("warmup done in %.0fs", time.time() - t0)

    def _warmup_extra_methods(self, sizes) -> None:
        """Run the opt-in per-request search methods
        (WARMUP_SEARCH_METHODS, default "fast,streaming") once per batch
        size: their first launches load the kernel libraries, chunkstream's
        builds the chunk store, sketch's the screen; "hnsw" builds the
        graph. Drives ``store.search`` directly with random unit vectors.
        A host-resident store serves only sketch and hnsw: the others are
        skipped with a log line, and sketch is warmed where the list has
        neither; chunkstream is skipped likewise over a residency other
        than fp32, which refuses it. A sharded store serves ``hnsw`` and
        what its shards serve (``parallel.search.INT8_METHODS`` or
        ``FP32_METHODS``): the other methods are skipped likewise. Any
        other failure propagates."""
        import numpy as np

        from .index.vector_store import SERVED_METHODS
        from .parallel.search import FP32_METHODS, INT8_METHODS

        methods = [
            m.strip().lower()
            for m in self.config.api.warmup_methods.split(",")
            if m.strip()
        ]
        if not methods or not isinstance(self.store, VectorStore):
            return  # no store, or a remote one: its serving host warms itself
        if not self.store.num_entities:
            return
        overfetch = self.config.pipeline.overfetch
        rng = np.random.default_rng(0)
        host_tier = self.store.config.device_dtype == "host"
        if not self.store.is_loaded:
            self.store.load_collection()
        sharded = self.store._sharded
        shard_methods = None if sharded is None else (
            INT8_METHODS if sharded.store_dtype == "int8" else FP32_METHODS)
        if host_tier and not any(m in ("sketch", "hnsw") for m in methods):
            methods.append("sketch")
        for method in methods:
            if method not in SERVED_METHODS:
                logger.warning("unknown WARMUP_SEARCH_METHODS entry: %s", method)
                continue
            if host_tier and method not in ("sketch", "hnsw"):
                logger.info(
                    "warmup: skipping method=%s (host-tier store serves "
                    "sketch/hnsw only)", method,
                )
                continue
            if shard_methods is not None:
                if method != "hnsw" and method not in shard_methods:
                    logger.info(
                        "warmup: skipping method=%s (a %s-sharded store serves "
                        "%s and hnsw)", method, sharded.store_dtype,
                        ", ".join(shard_methods),
                    )
                    continue
            elif method == "chunkstream" and self.store.config.device_dtype != "float32":
                logger.info(
                    "warmup: skipping method=chunkstream (it needs fp32 "
                    "residency, the store holds %s)", self.store.config.device_dtype,
                )
                continue
            t0 = time.time()
            if method == "hnsw":
                self.store.build_hnsw()
            else:
                for size in sizes:
                    q = rng.standard_normal((size, self.store.dim)).astype(np.float32)
                    q /= np.linalg.norm(q, axis=1, keepdims=True)
                    for top_k in (5, 10):
                        self.store.search(q, top_k * overfetch, method=method)
            logger.info("warmup(%s) done in %.0fs", method, time.time() - t0)

    def shutdown(self) -> None:
        """Cleanup (reference: main.py:118-226): release device memory,
        close clients."""
        if self.store is not None:
            self.store.release_collection()
        if self.llm is not None:
            self.llm.close()
