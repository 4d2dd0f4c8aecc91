"""Offline database builder: CSV -> hierarchy -> embeddings -> store.

Counterpart of rag_icd10_tpu/tools/build_database.py, with its CLI and
its on-disk output: the store's ``.npz``, the JSON sidecars,
``<db>.vocab.txt``, the ``<db>.encoder.json`` pairing sidecar and, with
``--hnsw``, ``<db>.hnsw``, byte for byte the JAX package's layout, so a
store built by either package loads in the other.

Behavioral spec (reference: tools/build_database.py):
- CLI: --input, --rebuild, --verify-only (:344-348), plus --hnsw
- records embed their ``semantic_text`` with the QUERY prefix path
  (:219-222)
- a batch that fails to embed becomes zero vectors (:228-233), logged and
  counted in ``embed_sorted.failed_batches``; a failure of the card or
  the CUDA runtime raises instead (``utils.device.reraise_device_error``):
  zero vectors from a broken device would be served as a store
- ends with a verification search for "急性胃肠炎" top-5 (:262-295)

Records are length-sorted before batching, so each batch pads to a short
length bucket, and re-scattered to corpus order. The builder runs on
``cuda`` unless ``DatabaseBuilder(device="cpu")``. ``main`` acquires the
card under the device guard (utils/device_guard.py); the JAX tool's
compile cache maps to the kernel build directory that
``ops/cuda_build.py`` keeps across processes.

    python -m rag_icd10_tpu_torch.tools.build_database --input <csv> --rebuild
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..config import Config, get_config
from ..data.corpus import ICDCorpus, synthetic_corpus
from ..index.vector_store import VectorStore
from ..models.encoder import TextEncoder
from ..models.tokenizer import WordPieceTokenizer
from ..utils.device import reraise_device_error, resolve_device

logger = logging.getLogger("rag_icd10_tpu_torch.build")

VERIFY_QUERY = "急性胃肠炎"


def embed_sorted(encoder: TextEncoder, texts, batch_size: int = 512) -> np.ndarray:
    """Length-sorted batched embedding; output rows match input order."""
    order = np.argsort([len(t) for t in texts], kind="stable")
    sorted_texts = [texts[i] for i in order]
    out = np.zeros((len(texts), encoder.dim), dtype=np.float32)
    done = 0
    t0 = time.time()
    for i in range(0, len(sorted_texts), batch_size):
        chunk = sorted_texts[i : i + batch_size]
        try:
            vecs = encoder.encode_batch(chunk, kind="query")
        except Exception as e:
            reraise_device_error(e)
            logger.error("embed batch failed (%s); using zero vectors", e)
            embed_sorted.failed_batches += 1
            vecs = np.zeros((len(chunk), encoder.dim), dtype=np.float32)
        out[order[i : i + len(chunk)]] = vecs
        done += len(chunk)
        if done % (batch_size * 8) == 0 or done == len(texts):
            rate = done / max(time.time() - t0, 1e-9)
            logger.info("embedded %d/%d (%.0f texts/s)", done, len(texts), rate)
    return out


embed_sorted.failed_batches = 0


class DatabaseBuilder:
    """Builds, appends to and verifies the store at ``config.store.db_path``
    on ``device``."""

    def __init__(self, config: Optional[Config] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or get_config()
        self.device = resolve_device(device)
        self.encoder: Optional[TextEncoder] = None

    def _init_encoder(self, corpus: ICDCorpus) -> TextEncoder:
        if self.encoder is not None:
            return self.encoder
        cfg = self.config
        vocab_path = str(Path(cfg.store.db_path).with_suffix("")) + ".vocab.txt"
        if cfg.encoder.vocab_path and Path(cfg.encoder.vocab_path).exists():
            tok = WordPieceTokenizer.from_vocab_file(cfg.encoder.vocab_path)
        elif Path(vocab_path).exists():
            tok = WordPieceTokenizer.from_vocab_file(vocab_path)
        else:
            logger.info("building tokenizer vocab from corpus")
            # include the augmentation charset so query-side synonym
            # variants and uncertainty-marker chars never hit [UNK]
            from ..data.augment import augmentation_charset_texts

            tok = WordPieceTokenizer.from_corpus(
                corpus.titles + corpus.semantic_texts + augmentation_charset_texts()
            )
            Path(vocab_path).parent.mkdir(parents=True, exist_ok=True)
            tok.save_vocab(vocab_path)
        self.encoder = TextEncoder(cfg.encoder, tokenizer=tok, device=self.device)
        return self.encoder

    def _store(self, **kw) -> VectorStore:
        return VectorStore(config=self.config.store, hnsw_config=self.config.hnsw,
                           device=self.device, **kw)

    def _load_store(self, base: str) -> VectorStore:
        return VectorStore.load(base, config=self.config.store,
                                hnsw_config=self.config.hnsw, device=self.device)

    def build_full_database(
        self, input_file: Optional[str] = None, rebuild: bool = False
    ) -> bool:
        cfg = self.config
        base = cfg.store.db_path
        if VectorStore.exists(base) and not rebuild:
            # incremental mode (reference tools/build_database.py:297-310);
            # only rows whose (code, title) is not stored yet are appended,
            # so repeated no-flag builds are idempotent
            return self.append_to_database(input_file)

        path = input_file or cfg.data_path
        if path and Path(path).exists():
            logger.info("loading corpus from %s", path)
            corpus = ICDCorpus.from_csv(path)
        else:
            logger.warning("no corpus CSV found — building synthetic corpus")
            corpus = synthetic_corpus(2048)
        logger.info("corpus stats: %s", corpus.hierarchy_stats())

        encoder = self._init_encoder(corpus)
        logger.info("embedding %d semantic texts", len(corpus))
        vectors = embed_sorted(encoder, corpus.semantic_texts)

        store = self._store(dim=encoder.dim)
        store.insert_records(list(corpus.records()), vectors)
        store.save(base)
        # record which encoder produced these vectors so serving can't
        # silently pair the store with mismatched weights

        def _abs(p):
            return str(Path(p).resolve()) if p else p

        encoder_sidecar = {
            "weights_path": _abs(cfg.encoder.weights_path),
            "vocab_path": _abs(
                cfg.encoder.vocab_path or str(Path(base).with_suffix("")) + ".vocab.txt"
            ),
            "model_name": cfg.encoder.model_name,
        }
        Path(str(base) + ".encoder.json").write_text(json.dumps(encoder_sidecar))
        logger.info("store persisted to %s", base)
        store.load_collection()
        return self.verify_database(store=store, encoder=encoder)

    def append_to_database(self, input_file: Optional[str] = None) -> bool:
        """Incremental build: append CSV rows not already in the store
        (reference tools/build_database.py:297-310). A persisted HNSW graph
        no longer covers the rows and is removed; rebuild it with
        ``--hnsw``."""
        cfg = self.config
        base = cfg.store.db_path
        store = self._load_store(base)

        path = input_file or cfg.data_path
        if not (path and Path(path).exists()):
            logger.info("store exists and no input CSV found — verification only")
            return self.verify_database(store=store)
        corpus = ICDCorpus.from_csv(path)
        existing = set(zip(store.corpus.codes, store.corpus.titles))
        new_records = [
            r for r in corpus.records() if (r.code, r.preferred_zh) not in existing
        ]
        if not new_records:
            logger.info("store already contains all %d CSV rows", len(corpus))
            return self.verify_database(store=store)

        # the appended rows MUST be embedded by the encoder that built the
        # store: adopt the sidecar's weights/vocab as serving does
        # (runtime.py), or the new rows would be silently unretrievable
        sidecar_path = Path(str(base) + ".encoder.json")
        if sidecar_path.exists():
            sidecar = json.loads(sidecar_path.read_text())
            want = sidecar.get("weights_path")
            have = (
                str(Path(cfg.encoder.weights_path).resolve())
                if cfg.encoder.weights_path else None
            )
            if want != have:
                if want and Path(want).exists():
                    logger.info(
                        "adopting the store's encoder weights from the sidecar: %s", want
                    )
                    enc_cfg = dataclasses.replace(
                        cfg.encoder, weights_path=want,
                        vocab_path=sidecar.get("vocab_path") or cfg.encoder.vocab_path,
                    )
                    self.config = dataclasses.replace(cfg, encoder=enc_cfg)
                    self.encoder = None  # rebuild with the sidecar pairing
                    cfg = self.config
                elif want:
                    logger.warning(
                        "store sidecar points at missing weights %s — appended "
                        "vectors may be inconsistent; set EMBEDDING_WEIGHTS_PATH "
                        "to the store's weights or --rebuild", want,
                    )
        encoder = self._init_encoder(store.corpus)
        logger.info(
            "appending %d new records (of %d CSV rows) to %d existing",
            len(new_records), len(corpus), store.num_entities,
        )
        vectors = embed_sorted(encoder, [r.semantic_text for r in new_records])
        store.insert_records(new_records, vectors)
        store.save(base)
        stale_graph = Path(str(base) + ".hnsw")
        if stale_graph.exists():
            logger.info("removing stale HNSW graph %s (rebuild with --hnsw)", stale_graph)
            stale_graph.unlink()
        store.load_collection()
        return self.verify_database(store=store, encoder=encoder)

    def verify_database(
        self,
        store: Optional[VectorStore] = None,
        encoder: Optional[TextEncoder] = None,
    ) -> bool:
        """Known-answer search check (reference :262-295)."""
        cfg = self.config
        if store is None:
            if not VectorStore.exists(cfg.store.db_path):
                logger.error("no store to verify at %s", cfg.store.db_path)
                return False
            store = self._load_store(cfg.store.db_path)
        if encoder is None:
            encoder = self._init_encoder(store.corpus)
        qv = encoder.encode_query(VERIFY_QUERY)
        hits = store.search(qv, top_k=5)[0]
        if not hits:
            logger.error("verification search returned no results")
            return False
        logger.info("verification search '%s' top-5:", VERIFY_QUERY)
        for h in hits:
            logger.info("  %.4f %s %s", h.score, h.code, h.preferred_zh)
        stats = store.get_collection_stats()
        logger.info("collection: %s entities, %s MB est.",
                    stats["num_entities"], stats["memory"]["estimated_vector_memory_mb"])
        return True

    def build_hnsw(self) -> str:
        """Build the HNSW graph over the saved store and persist it as
        ``<db>.hnsw`` (``--hnsw``), so ``search_method=hnsw`` is warm at
        serve time."""
        base = str(self.config.store.db_path)
        store = self._load_store(base)
        t0 = time.time()
        logger.info("building HNSW graph (M=%d efc=%d)...",
                    self.config.hnsw.M, self.config.hnsw.ef_construction)
        store.build_hnsw().save(base + ".hnsw")
        logger.info("HNSW graph persisted in %.0fs -> %s.hnsw", time.time() - t0, base)
        return base + ".hnsw"


def main(argv=None, device: Union[str, torch.device] = "cuda") -> int:
    parser = argparse.ArgumentParser(description="Build the ICD-10 vector store")
    parser.add_argument("--input", help="input CSV (code,disease)", default=None)
    parser.add_argument("--rebuild", action="store_true", help="drop and rebuild the store")
    parser.add_argument(
        "--verify-only", action="store_true", help="only run the verification search"
    )
    parser.add_argument(
        "--hnsw", action="store_true",
        help="also build and persist the HNSW graph next to the store, so "
        "per-request search_method=hnsw is warm at serve time instead of "
        "paying a minutes-long lazy build on the first request",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from ..utils.device_guard import acquire_device

    builder = DatabaseBuilder(device=acquire_device(device, what="database build"))
    if args.verify_only:
        ok = builder.verify_database()
    else:
        ok = builder.build_full_database(args.input, rebuild=args.rebuild)
    if ok and args.hnsw:
        builder.build_hnsw()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
