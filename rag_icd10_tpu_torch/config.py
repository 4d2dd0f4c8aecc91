"""Typed configuration for the whole framework.

Replaces the reference's scattered `os.getenv` dicts (reference:
services/embedding_service.py:22-31, services/milvus_service.py:21-37,
services/llm_service.py:20-47, services/medical_ner_service.py:26-31,
services/diagnosis_entity_filter.py:61-70) with one frozen dataclass tree,
while honoring the same environment variable names (reference: env.example).

A tiny `.env` loader stands in for python-dotenv (not available here).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader: KEY=VALUE lines, '#' comments, no interpolation."""
    p = Path(path)
    if not p.exists():
        return
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        os.environ.setdefault(key, value)


def _env(name: str, default: str) -> str:
    return os.getenv(name, default)


def _env_bool(name: str, default: bool) -> bool:
    raw = os.getenv(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    return int(raw) if raw not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name)
    return float(raw) if raw not in (None, "") else default


def _effective_cpu_count() -> int:
    """Cores this process may actually run on.

    os.cpu_count() reports visible hardware cores and ignores cgroup /
    affinity limits, so a container pinned to 1 core on a big machine
    would default PIPELINE_DEPTH=2 — the exact configuration
    SERVING_r04.json measured as a 2x QPS loss with a 12.5 s p95."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


# Default corpus location: a user-supplied CSV with columns code,disease.
# (The reference ships data/ICD_10v601.csv, 40,474 valid records.)
_DEFAULT_DATA_CANDIDATES = ("./data/ICD_10v601.csv",)


def default_icd_csv_path() -> Optional[str]:
    for cand in _DEFAULT_DATA_CANDIDATES:
        if Path(cand).exists():
            return cand
    return None


@dataclass(frozen=True)
class EncoderConfig:
    """Sentence encoder config (reference: services/embedding_service.py:22-31)."""

    model_name: str = field(
        default_factory=lambda: _env(
            "EMBEDDING_MODEL_NAME", "shibing624/text2vec-base-chinese"
        )
    )
    # Reference hardcodes batch_size=32, max_length=512
    # (embedding_service.py:27-28). On TPU we bucket sequence lengths to avoid
    # recompilation storms; 512 stays the hard cap.
    batch_size: int = 32
    max_length: int = 512
    length_buckets: tuple = (32, 64, 128, 256, 512)
    # E5-style prefixes (reference: embedding_service.py:68-73,117-120).
    # Only applied for e5-family models; text2vec ignores prefixes.
    query_prefix: str = "query: "
    passage_prefix: str = "passage: "
    # Model architecture (text2vec-base-chinese == BERT-base, 768-d).
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 21128  # bert-base-chinese vocab
    type_vocab_size: int = 2
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    # TPU numerics: bf16 activations, fp32 accumulation/normalization.
    dtype: str = "bfloat16"
    # Optional path to converted weights (msgpack/npz). None => deterministic
    # random init (useful for tests/benchmarks without HF assets).
    weights_path: Optional[str] = field(
        default_factory=lambda: os.getenv("EMBEDDING_WEIGHTS_PATH") or None
    )
    vocab_path: Optional[str] = field(
        default_factory=lambda: os.getenv("EMBEDDING_VOCAB_PATH") or None
    )

    @property
    def is_e5(self) -> bool:
        return "e5" in self.model_name.lower()


@dataclass(frozen=True)
class StoreConfig:
    """Vector store config (reference: services/milvus_service.py:21-37).

    Milvus-Lite is replaced by an HBM-resident matrix + host metadata columns,
    persisted as npz + JSON sidecar. Env names kept for drop-in compat.
    """

    collection_name: str = field(
        default_factory=lambda: _env("MILVUS_COLLECTION_NAME", "icd10")
    )
    db_path: str = field(
        default_factory=lambda: _env("MILVUS_DB_PATH", "./db/icd10_store")
    )
    # FLAT + IP are what the reference actually builds
    # (milvus_service.py:33-34,190-194); HNSW supported as a second path.
    index_type: str = field(default_factory=lambda: _env("INDEX_TYPE", "FLAT"))
    metric_type: str = "IP"
    # top-k method on the flat path: "exact" (lax.top_k), "approx"
    # (lax.approx_max_k — ~4x faster selection at recall ~1.0 for k<=16),
    # "fast" (certified chunk-select over a bf16x3 scan — ~1.5x "exact"
    # at batch 256; uncertified batches redo exactly, ops/rerank.py),
    # "streaming" (exact in-kernel top-k, k<=128: the (B, N) score
    # matrix never reaches HBM), or "chunkstream" (streaming
    # chunk-select v2, ops/chunk_stream.py — the huge-corpus path:
    # certified chunk selection over a CHUNKSTREAM_SCAN-dtype pass 1 +
    # exact fp32 block re-score; measured ≥2x the materialized scan at
    # 1M rows)
    search_method: str = field(
        default_factory=lambda: _env("SEARCH_METHOD", "exact")
    )
    # device residency dtype for the corpus matrix: float32 (exact),
    # bfloat16 (half the HBM, ~3e-3 relative score error), int8
    # (quarter the HBM, per-row scales, int8 MXU; ~1e-2 error,
    # recall@10 >= 0.99 — ops/quantized.py), or "host" (beyond-HBM
    # capacity tier, ops/sketch.py: only a SKETCH_DIM-dim int8 screen is
    # device-resident at ~SKETCH_DIM+12 bytes/row; the fp32 matrix stays
    # in host RAM and serves candidate rows to an exact re-rank —
    # selection approximate, scores exact, the HNSW contract)
    device_dtype: str = field(
        default_factory=lambda: _env("STORE_DEVICE_DTYPE", "float32")
    )
    # capacity-tier screen knobs (device_dtype="host" or per-request
    # method="sketch"): projection width, basis ("pca" fit on a corpus
    # sample — concentrates the 8 bits on directions the corpus uses —
    # or data-free "random" JL), and screen over-fetch m (0 = auto
    # max(8k, 64))
    sketch_dim: int = field(default_factory=lambda: _env_int("SKETCH_DIM", 128))
    sketch_proj: str = field(default_factory=lambda: _env("SKETCH_PROJ", "pca"))
    sketch_fetch: int = field(
        default_factory=lambda: _env_int("SKETCH_FETCH", 0)
    )
    # pass-1 scan for the "chunkstream" search method, grammar
    # engine[_dtype] (ops/chunk_stream.py): "pallas" — the streaming
    # kernel, (B, N) provably never reaches HBM, measured fastest on
    # v5e at EVERY dtype (config 6 r4: fp32 1.8-2.0x the materialized
    # scan, bf16 2.2x, int8 2.3x); "pallas_bf16" / "pallas_int8" run it
    # over a half/quarter-residency store (measured-residual
    # certificates); "xla" / "xla_high" — XLA dot + fused chunk-max over
    # fp32; "bf16" / "int8" — the XLA engine over the reduced stores.
    # Off-TPU the pallas engines fall back to XLA, keeping the store
    # dtype.
    chunkstream_scan: str = field(
        default_factory=lambda: _env("CHUNKSTREAM_SCAN", "pallas")
    )
    # int8 re-rank location: "device" (default) re-ranks the int8 scan's
    # candidates ON DEVICE with the full-precision query against the
    # dequantized rows — the int8 matrix is the only corpus-sized array
    # anywhere in the search path (true 1/4-memory serving); "host"
    # re-ranks against the host fp32 matrix for bit-exact parity with
    # the fp32 path at the cost of a host gather + einsum per batch.
    int8_rerank: str = field(
        default_factory=lambda: _env("INT8_RERANK", "device")
    )
    # corpus-dimension sharding over the store's mesh (parallel/search.py):
    # "auto" = shard when >1 CUDA card is attached; "on" = shard when the
    # mesh has >1 shard; "off" never. Per-shard scan + one merge of k
    # candidates per shard — the 100M-row scaling path.
    sharded: str = field(default_factory=lambda: _env("STORE_SHARDED", "auto"))
    # store mode (reference parity: MILVUS_MODE=server connects to a
    # remote Milvus, milvus_service.py:57-118): "local" serves this
    # host's device-resident store; "remote" forwards vector search to a
    # peer API server (STORE_SERVER_URL) that shares ITS device corpus.
    mode: str = field(
        default_factory=lambda: _env(
            "STORE_MODE",
            "remote" if _env("MILVUS_MODE", "") == "server" else "local",
        )
    )
    server_url: str = field(
        default_factory=lambda: _env(
            "STORE_SERVER_URL",
            (
                f"http://{_env('MILVUS_HOST', '')}:{_env('MILVUS_PORT', '8005')}"
                if _env("MILVUS_HOST", "")
                else ""
            ),
        )
    )
    # Level weights applied at search time and re-sorted
    # (milvus_service.py:292-316,550-558).
    level_weights: tuple = (1.2, 1.0, 0.8)  # levels 1,2,3
    # Corpus rows are padded to a multiple of this for TPU tiling.
    pad_multiple: int = 1024


@dataclass(frozen=True)
class HNSWConfig:
    """HNSW graph index (native C++ path; reference docs claim HNSW at
    README.md:47 though the code builds FLAT). Env-tunable like the
    reference's Milvus index params (README_MILVUS_CONFIG.md); ef_search
    can additionally be overridden per request via the API."""

    M: int = field(default_factory=lambda: _env_int("HNSW_M", 16))
    ef_construction: int = field(
        default_factory=lambda: _env_int("HNSW_EF_CONSTRUCTION", 200)
    )
    ef_search: int = field(default_factory=lambda: _env_int("HNSW_EF_SEARCH", 64))
    # in-graph vector storage: "bfloat16" (default) halves graph memory —
    # graph ≤ flat fp32 at the same corpus — and the store's hnsw path
    # re-ranks candidates against its fp32 matrix so returned scores stay
    # exact; "float32" keeps raw graph IPs exact in-graph.
    vec_dtype: str = field(
        default_factory=lambda: _env("HNSW_VEC_DTYPE", "bfloat16")
    )


@dataclass(frozen=True)
class LLMProviderConfig:
    name: str = "deepseek"
    api_key: str = ""
    base_url: str = "https://api.deepseek.com/v1"
    model: str = "deepseek-chat"


@dataclass(frozen=True)
class LLMConfig:
    """LLM standardization client (reference: services/llm_service.py:20-47).

    temperature 0.1 / max_tokens 2048 hardcoded (llm_service.py:29-30);
    120 s client timeout (llm_service.py:58)."""

    provider: str = field(default_factory=lambda: _env("LLM_PROVIDER", "deepseek"))
    temperature: float = 0.1
    max_tokens: int = 2048
    timeout_s: float = 120.0
    test_timeout_s: float = 90.0

    @staticmethod
    def providers() -> dict:
        return {
            "deepseek": LLMProviderConfig(
                name="deepseek",
                api_key=_env("DEEPSEEK_API_KEY", ""),
                base_url=_env("DEEPSEEK_BASE_URL", "https://api.deepseek.com/v1"),
                model=_env("DEEPSEEK_MODEL", "deepseek-chat"),
            ),
            "openai": LLMProviderConfig(
                name="openai",
                api_key=_env("OPENAI_API_KEY", ""),
                base_url=_env("OPENAI_BASE_URL", "https://api.openai.com/v1"),
                model=_env("OPENAI_MODEL", "gpt-3.5-turbo"),
            ),
            "local": LLMProviderConfig(
                name="local",
                api_key=_env("LOCAL_API_KEY", "not-required"),
                base_url=_env("LOCAL_BASE_URL", "http://localhost:8000/v1"),
                model=_env("LOCAL_MODEL", "local-medical-model"),
            ),
        }


@dataclass(frozen=True)
class NERConfig:
    """Medical NER config (reference: services/medical_ner_service.py:26-31)."""

    model_name: str = field(
        default_factory=lambda: _env("MEDICAL_NER_MODEL", "lixin12345/chinese-medical-ner")
    )
    use_model: bool = field(
        default_factory=lambda: _env_bool("USE_MEDICAL_NER_MODEL", True)
    )
    min_confidence: float = field(
        default_factory=lambda: _env_float("MEDICAL_NER_MIN_CONFIDENCE", 0.5)
    )


@dataclass(frozen=True)
class FilterConfig:
    """Diagnosis entity filter config (reference:
    services/diagnosis_entity_filter.py:61-70)."""

    strict_mode: bool = field(
        default_factory=lambda: _env_bool("DIAGNOSIS_FILTER_STRICT_MODE", False)
    )
    keep_drug_diseases: bool = field(
        default_factory=lambda: _env_bool("KEEP_DRUG_DISEASES", True)
    )
    keep_lab_indicators: bool = field(
        default_factory=lambda: _env_bool("KEEP_LAB_INDICATORS", True)
    )
    context_window: int = field(
        default_factory=lambda: _env_int("FILTER_CONTEXT_WINDOW", 20)
    )
    confidence_threshold: float = field(
        default_factory=lambda: _env_float("FILTER_CONFIDENCE_THRESHOLD", 0.6)
    )
    enable_context_analysis: bool = field(
        default_factory=lambda: _env_bool("ENABLE_CONTEXT_ANALYSIS", True)
    )


@dataclass(frozen=True)
class PipelineConfig:
    """Orchestration knobs (reference: services/multi_diagnosis_service.py,
    tools/text_processor.py:36-39)."""

    use_enhanced_text_processing: bool = field(
        default_factory=lambda: _env_bool("USE_ENHANCED_TEXT_PROCESSING", True)
    )
    # Over-fetch factor before rescoring (multi_diagnosis_service.py:153).
    overfetch: int = 2
    # top_k bounds from the API contract (models/icd_models.py:135-138).
    max_top_k: int = 50
    # Static padding bucket for #diagnoses per request (XLA static shapes).
    max_diagnoses: int = 16
    # Per-diagnosis rescoring thread pool: 0 = auto (cpu_count-1 capped at
    # 8; sequential on single-core hosts), 1 = force sequential, N = N
    # workers. The rescoring stack is embarrassingly parallel per
    # diagnosis; on a multi-core serving host this removes the reference's
    # sequential hot-loop bottleneck (multi_diagnosis_service.py:98-103).
    rescore_workers: int = field(
        default_factory=lambda: _env_int("RESCORE_WORKERS", 0)
    )


@dataclass(frozen=True)
class APIConfig:
    host: str = field(default_factory=lambda: _env("API_HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: _env_int("API_PORT", 8005))
    log_level: str = field(default_factory=lambda: _env("API_LOG_LEVEL", "info"))
    ui_host: str = field(default_factory=lambda: _env("GRADIO_HOST", "0.0.0.0"))
    ui_port: int = field(default_factory=lambda: _env_int("GRADIO_PORT", 7860))
    # Request-coalescing window for batching concurrent queries into one
    # device call (new capability; the reference is strictly sequential).
    batch_window_ms: float = field(
        default_factory=lambda: _env_float("BATCH_WINDOW_MS", 2.0)
    )
    max_batch: int = field(default_factory=lambda: _env_int("MAX_BATCH", 64))
    # Overload/shutdown policy for the batcher (SURVEY §5 failure detection):
    # bound the wait queue (503 beyond it), cap per-request wall time (504),
    # and drain in-flight work briefly on shutdown.
    max_queue: int = field(default_factory=lambda: _env_int("MAX_QUEUE", 256))
    request_timeout_s: float = field(
        default_factory=lambda: _env_float("REQUEST_TIMEOUT_S", 90.0)
    )
    drain_timeout_s: float = field(
        default_factory=lambda: _env_float("DRAIN_TIMEOUT_S", 10.0)
    )
    # host-stage pipelining depth: how many coalesced batches may be in
    # flight at once (2 = batch n's host rescoring overlaps batch n+1's
    # device work; 1 = strictly serial monolithic path). Default is
    # core-count-adaptive: the SERVING_r04.json A/B measured depth 2 at
    # 36-42 QPS vs depth 1's 81 QPS @64 clients on a 1-core host — with
    # no spare core the host stages cannot overlap the device stage, so
    # extra depth only adds queueing (p95 12.5 s vs 1.9 s). Set
    # PIPELINE_DEPTH explicitly to override.
    pipeline_depth: int = field(
        default_factory=lambda: _env_int(
            "PIPELINE_DEPTH", 2 if _effective_cpu_count() > 1 else 1
        )
    )
    # Extra per-request search methods to pre-compile at startup
    # (comma-separated: "streaming", "chunkstream", "hnsw", "approx",
    # "fast"). Defaults
    # to the cheap set so a fresh server never 504s on a documented
    # knob's first use; "hnsw" stays opt-in because its warmup builds
    # the graph (minutes) unless a persisted graph exists.
    warmup_methods: str = field(
        default_factory=lambda: _env("WARMUP_SEARCH_METHODS", "fast,streaming")
    )


@dataclass(frozen=True)
class Config:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    hnsw: HNSWConfig = field(default_factory=HNSWConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    ner: NERConfig = field(default_factory=NERConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    api: APIConfig = field(default_factory=APIConfig)
    data_path: Optional[str] = field(
        default_factory=lambda: os.getenv("ICD_DATA_PATH") or default_icd_csv_path()
    )
    debug: bool = field(default_factory=lambda: _env_bool("DEBUG", False))
    log_level: str = field(default_factory=lambda: _env("LOG_LEVEL", "INFO"))


def get_config() -> Config:
    """Build a Config snapshot from the current environment (.env honored)."""
    load_dotenv()
    return Config()
