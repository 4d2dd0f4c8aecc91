"""HTTP API service (aiohttp) — reference-compatible endpoint surface.

Counterpart of rag_icd10_tpu/api/app.py, serving the PyTorch/CUDA
engine. Run it with ``python -m rag_icd10_tpu_torch.api.app`` (needs a
CUDA device; ``APIServer(device="cpu")`` serves from the CPU).

Endpoints (reference: main.py:250-748): ``/``, ``/health``, ``/query``,
``/standardize``, ``/embed``, ``/entities``, ``/stats``, ``/llm/switch``,
``/llm/test``, ``/resource/status``, ``/resource/release``,
``/resource/reload`` — same request/response contracts (api/schemas.py).

Implementation differences:
- aiohttp instead of FastAPI/uvicorn (not available in this environment);
  pydantic still validates all payloads so 422-style errors are preserved
  (mapped to 400 with detail).
- /query and /standardize go through the RequestBatcher: concurrent
  requests coalesce into one device batch.
- CORS * (reference: main.py:238-244); rotating file log logs/api.log,
  50 MB (reference: main.py:247, loguru -> stdlib RotatingFileHandler).
- Also serves the web UI at /ui (api/static/).
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import logging.handlers
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
from aiohttp import web
from pydantic import ValidationError

from ..config import Config, get_config
from ..runtime import Engine
from .batching import BatcherOverloaded, BatcherTimeout, RequestBatcher
from .schemas import (
    Candidate,
    DiagnosisMatch,
    EmbeddingRequest,
    EmbeddingResponse,
    HealthCheckResponse,
    QueryRequest,
    QueryResponse,
    StandardizeRequest,
    StandardizeResponse,
    convert_numpy_types,
)

logger = logging.getLogger("rag_icd10_tpu_torch.api")

STATIC_DIR = Path(__file__).parent / "static"


def setup_logging(config: Config) -> None:
    Path("logs").mkdir(exist_ok=True)
    handler = logging.handlers.RotatingFileHandler(
        "logs/api.log", maxBytes=50 * 1024 * 1024, backupCount=3, encoding="utf-8"
    )
    handler.setFormatter(
        logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    )
    root = logging.getLogger("rag_icd10_tpu_torch")
    root.setLevel(getattr(logging, config.log_level.upper(), logging.INFO))
    root.addHandler(handler)
    root.addHandler(logging.StreamHandler())


def json_response(payload: Any, status: int = 200) -> web.Response:
    return web.json_response(
        convert_numpy_types(payload), status=status, dumps=lambda o: json.dumps(o, ensure_ascii=False)
    )


def error_response(detail: str, status: int) -> web.Response:
    return json_response({"detail": detail}, status=status)


def match_to_schema(match) -> DiagnosisMatch:
    return DiagnosisMatch(
        diagnosis_text=match.diagnosis_text,
        candidates=[
            Candidate(
                code=c.code,
                title=c.title,
                score=max(float(c.score), 0.0),
                level=c.level,
                parent_code=c.parent_code,
                enhanced_score=c.enhanced_score,
                original_score=c.original_score,
                similarity_factors=(
                    c.similarity_factors.to_dict() if c.similarity_factors else None
                ),
            )
            for c in match.candidates
        ],
        match_confidence=min(max(float(match.match_confidence), 0.0), 1.0),
        confidence_metrics=(
            match.confidence_metrics.to_dict() if match.confidence_metrics else None
        ),
        confidence_factors=(
            match.confidence_factors.to_dict() if match.confidence_factors else None
        ),
        confidence_level=match.confidence_level or None,
    )


class APIServer:
    def __init__(self, config: Config = None, engine: Engine = None, device="cuda"):
        self.config = config or get_config()
        self.engine = engine or Engine(self.config, device=device)
        self.batcher: RequestBatcher = None
        self.app = web.Application(middlewares=[self._cors_middleware])
        self._routes()

    # ------------------------------------------------------------- setup

    @web.middleware
    async def _cors_middleware(self, request, handler):
        if request.method == "OPTIONS":
            resp = web.Response()
        else:
            try:
                resp = await handler(request)
            except web.HTTPException as e:
                resp = e
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
        resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
        return resp

    def _routes(self) -> None:
        app = self.app
        app.router.add_get("/", self.root)
        app.router.add_get("/health", self.health)
        app.router.add_post("/query", self.query)
        app.router.add_post("/standardize", self.standardize)
        app.router.add_post("/vector_search", self.vector_search)
        app.router.add_post("/semantic_similarities", self.semantic_similarities)
        app.router.add_post("/embed", self.embed)
        app.router.add_post("/entities", self.entities)
        app.router.add_get("/stats", self.stats)
        app.router.add_post("/llm/switch", self.llm_switch)
        app.router.add_get("/llm/test", self.llm_test)
        app.router.add_get("/resource/status", self.resource_status)
        app.router.add_post("/resource/release", self.resource_release)
        app.router.add_post("/resource/reload", self.resource_reload)
        app.router.add_post("/profiler/start", self.profiler_start)
        app.router.add_post("/profiler/stop", self.profiler_stop)
        app.router.add_get("/docs", self.docs)
        app.router.add_get("/openapi.json", self.openapi)
        if STATIC_DIR.exists():
            app.router.add_get("/ui", self.ui_index)
            app.router.add_static("/ui/", str(STATIC_DIR))
        app.on_startup.append(self._on_startup)
        app.on_cleanup.append(self._on_cleanup)

    async def _on_startup(self, app) -> None:
        loop = asyncio.get_event_loop()
        await loop.run_in_executor(None, self.engine.startup)
        matcher = self.engine.matcher
        self.batcher = RequestBatcher(
            matcher.match_many_texts,
            window_ms=self.config.api.batch_window_ms,
            max_batch=self.config.api.max_batch,
            max_queue=self.config.api.max_queue,
            request_timeout_s=self.config.api.request_timeout_s,
            drain_timeout_s=self.config.api.drain_timeout_s,
            max_inflight=self.config.api.pipeline_depth,
        )
        self.batcher.start()
        logger.info("API ready on %s:%s", self.config.api.host, self.config.api.port)

    async def _on_cleanup(self, app) -> None:
        if self.batcher:
            await self.batcher.stop()
        self.engine.shutdown()

    # ----------------------------------------------------------- handlers

    async def root(self, request) -> web.Response:
        return json_response(
            {
                "message": "ICD-10 诊断标准化API (PyTorch/CUDA)",
                "version": "1.0.0",
                "docs": "/docs",
                "health": "/health",
            }
        )

    async def health(self, request) -> web.Response:
        try:
            encoder_loaded = self.engine.encoder is not None
            store = self.engine.store
            connected = bool(store and store.test_connection())
            total = store.num_entities if store else 0
            status = "healthy" if (encoder_loaded and connected and total) else "unhealthy"
            payload = HealthCheckResponse(
                status=status,
                milvus_connected=connected,
                embedding_model_loaded=encoder_loaded,
                total_records=total,
            )
            return json_response(payload.model_dump())
        except Exception as e:
            return error_response(f"健康检查失败: {e}", 500)

    async def query(self, request) -> web.Response:
        try:
            req = QueryRequest(**await request.json())
        except (ValidationError, json.JSONDecodeError, TypeError) as e:
            return error_response(f"请求无效: {e}", 400)
        if self.batcher is None:
            return error_response("服务未就绪", 503)
        try:
            result = await self.batcher.submit(
                req.text, req.top_k,
                search_method=req.search_method, ef_search=req.ef_search,
            )
            matches = [match_to_schema(m) for m in result["matches"]]
            all_candidates = [c for m in matches for c in m.candidates]
            all_candidates.sort(key=lambda c: c.score, reverse=True)
            response = QueryResponse(
                candidates=all_candidates[: req.top_k],
                is_multi_diagnosis=len(result["extracted_diagnoses"]) > 1,
                extracted_diagnoses=result["extracted_diagnoses"],
                diagnosis_matches=matches,
                processing_metadata={
                    "processing_mode": result.get("processing_mode", "enhanced"),
                    "extraction_metadata": result.get("extraction_metadata", {}),
                    "total_diagnoses": len(result["extracted_diagnoses"]),
                    "total_candidates": result["total_matches"],
                },
            )
            return json_response(response.model_dump())
        except BatcherOverloaded as e:
            return error_response(f"服务过载: {e}", 503)
        except BatcherTimeout as e:
            return error_response(f"查询超时: {e}", 504)
        except ValueError as e:
            # a search method or residency this package does not serve
            return error_response(f"请求无效: {e}", 400)
        except Exception as e:
            logger.exception("query failed")
            return error_response(f"查询失败: {e}", 500)

    async def _run_on_device_thread(self, fn):
        """Run device work on the batcher's single device thread so store-
        server requests serialize with /query batches (jit-cache friendly,
        and a SIGTERM mid-compile can't wedge the default executor —
        batching.py documents why that thread is abandonable). Falls back
        to a default-executor run only before the batcher exists."""
        loop = asyncio.get_event_loop()
        executor = self.batcher._executor if self.batcher else None
        return await loop.run_in_executor(executor, fn)

    async def vector_search(self, request) -> web.Response:
        """Store-server endpoint (reference parity: remote Milvus mode,
        milvus_service.py:57-118): raw vector search against THIS host's
        device-resident corpus, for RemoteVectorStore clients on other
        hosts (STORE_MODE=remote). Device work runs off the event loop."""
        try:
            body = await request.json()
            vectors = np.asarray(body["vectors"], dtype=np.float32)
            top_k = int(body.get("top_k", 5))
            method = body.get("search_method")
            ef = body.get("ef_search")
            if vectors.ndim != 2 or not (1 <= top_k <= 512):
                raise ValueError("vectors must be (B, D); 1 <= top_k <= 512")
            # unauthenticated endpoint on the shared store host: an
            # unbounded B would be padded up and drive an O(B_pad x N)
            # device scan (memory blowup) that stalls every /query client
            max_b = self.config.api.max_batch * 4
            if vectors.shape[0] > max_b:
                raise ValueError(f"batch too large (max {max_b})")
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            return error_response(f"请求无效: {e}", 400)
        store = self.engine.store
        if store is None or not store.num_entities:
            return error_response("向量库未就绪", 503)
        if vectors.shape[1] != store.dim:
            return error_response(
                f"vectors must be (B, {store.dim})", 400
            )
        try:
            rows = await self._run_on_device_thread(
                lambda: store.search(
                    vectors, top_k, method=method, ef_search=ef
                ),
            )
            return json_response(
                {"rows": [[h.to_dict() for h in row] for row in rows]}
            )
        except ValueError as e:
            return error_response(f"请求无效: {e}", 400)
        except Exception as e:
            logger.exception("vector_search failed")
            return error_response(f"检索失败: {e}", 500)

    async def semantic_similarities(self, request) -> web.Response:
        """Companion store-server endpoint: the rescoring stack's
        cosine(query, semantic_text) gather for remote clients."""
        try:
            body = await request.json()
            qv = np.asarray(body["query_vectors"], dtype=np.float32)
            ids = np.asarray(body["candidate_ids"], dtype=np.int64)
            max_b = self.config.api.max_batch * 4
            if qv.ndim != 2 or qv.shape[0] > max_b:
                raise ValueError(
                    f"query_vectors must be (B, D) with B <= {max_b}"
                )
            if ids.ndim != 2 or ids.shape[0] != qv.shape[0] \
                    or ids.size > 64 * 1024:
                raise ValueError(
                    "candidate_ids must be (B, K), B matching "
                    "query_vectors, <= 65536 ids total"
                )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            return error_response(f"请求无效: {e}", 400)
        store = self.engine.store
        if store is None or not store.num_entities:
            return error_response("向量库未就绪", 503)
        if qv.shape[1] != store.dim:
            return error_response(
                f"query_vectors must be (B, {store.dim})", 400
            )
        # bounds-check BEFORE fancy indexing: a negative id would wrap to
        # the end of the matrix and return a plausible-but-wrong value
        if ids.size and (
            int(ids.min()) < 0 or int(ids.max()) >= store.num_entities
        ):
            return error_response(
                f"candidate_ids out of range [0, {store.num_entities})", 400
            )
        try:
            sims = await self._run_on_device_thread(
                lambda: store.semantic_similarities(qv, ids)
            )
            return json_response({"sims": np.asarray(sims).tolist()})
        except Exception as e:
            logger.exception("semantic_similarities failed")
            return error_response(f"相似度计算失败: {e}", 500)

    async def standardize(self, request) -> web.Response:
        try:
            req = StandardizeRequest(**await request.json())
        except (ValidationError, json.JSONDecodeError, TypeError) as e:
            return error_response(f"请求无效: {e}", 400)
        if self.batcher is None or self.engine.llm is None:
            return error_response("服务未就绪", 503)
        try:
            result = await self.batcher.submit(req.text, req.top_k)
            matches = result["matches"]
            extracted = result["extracted_diagnoses"]
            all_candidates = [c for m in matches for c in m.candidates]
            all_candidates.sort(key=lambda c: c.score, reverse=True)
            all_candidates = all_candidates[: req.top_k]
            if not all_candidates:
                return json_response(StandardizeResponse(results=[]).model_dump())

            loop = asyncio.get_event_loop()
            llm = self.engine.llm
            if len(extracted) > 1:
                # per-diagnosis LLM calls are independent HTTP requests —
                # issue them concurrently (the reference loops them
                # sequentially, main.py:416-452)
                cands_per_match = [
                    [
                        {"code": c.code, "title": c.title, "score": float(c.score)}
                        for c in m.candidates
                    ]
                    for m in matches
                ]
                llm_tasks = [
                    loop.run_in_executor(
                        None, llm.standardize_diagnosis, m.diagnosis_text,
                        cands, req.llm_provider,
                    )
                    for m, cands in zip(matches, cands_per_match)
                ]
                llm_results_all = await asyncio.gather(*llm_tasks)
                groups = [
                    {
                        "diagnosis_text": m.diagnosis_text,
                        "match_confidence": m.match_confidence,
                        "confidence_level": m.confidence_level,
                        "standardized_results": llm_results,
                        "candidates": cands,
                    }
                    for m, cands, llm_results in zip(
                        matches, cands_per_match, llm_results_all
                    )
                ]
                results = [
                    {
                        "is_multi_diagnosis": True,
                        "extracted_diagnoses": extracted,
                        "standardization_groups": groups,
                        "total_diagnoses": len(extracted),
                    }
                ]
            else:
                cands = [
                    {"code": c.code, "title": c.title, "score": float(c.score)}
                    for c in all_candidates
                ]
                llm_results = await loop.run_in_executor(
                    None, llm.standardize_diagnosis, req.text, cands, req.llm_provider
                )
                results = [
                    {
                        "is_multi_diagnosis": False,
                        "standardized_results": llm_results,
                        "candidates": cands,
                    }
                ]
            return json_response(StandardizeResponse(results=results).model_dump())
        except BatcherOverloaded as e:
            return error_response(f"服务过载: {e}", 503)
        except BatcherTimeout as e:
            return error_response(f"标准化超时: {e}", 504)
        except Exception as e:
            logger.exception("standardize failed")
            return error_response(f"标准化失败: {e}", 500)

    async def embed(self, request) -> web.Response:
        try:
            req = EmbeddingRequest(**await request.json())
        except (ValidationError, json.JSONDecodeError, TypeError) as e:
            return error_response(f"请求无效: {e}", 400)
        if self.engine.encoder is None:
            return error_response("向量化服务未就绪", 503)
        try:
            loop = asyncio.get_event_loop()
            vecs = await loop.run_in_executor(
                None, self.engine.encoder.encode_batch, req.texts
            )
            info = self.engine.encoder.get_model_info()
            payload = EmbeddingResponse(
                embeddings=[v.tolist() for v in vecs], model=info["model_name"]
            )
            return json_response(payload.model_dump())
        except Exception as e:
            return error_response(f"向量化失败: {e}", 500)

    async def entities(self, request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return error_response("请求无效", 400)
        text = body.get("text", "")
        if not text:
            return error_response("文本不能为空", 400)
        if self.engine.matcher is None:
            return error_response("多诊断服务未就绪", 503)
        try:
            ner = self.engine.matcher.ner_service
            filter_drugs = body.get("filter_drugs", True)
            loop = asyncio.get_event_loop()
            ents = await loop.run_in_executor(
                None, lambda: ner.extract_medical_entities(text, filter_drugs)
            )
            summary = await loop.run_in_executor(None, ner.get_entity_summary, text)
            return json_response({**summary, "entities": ents})
        except Exception as e:
            return error_response(f"实体提取失败: {e}", 500)

    async def stats(self, request) -> web.Response:
        try:
            stats: Dict[str, Any] = {}
            if self.engine.store is not None:
                stats["milvus"] = self.engine.store.get_collection_stats()
            if self.engine.encoder is not None:
                stats["embedding"] = self.engine.encoder.get_model_info()
            if self.engine.llm is not None:
                stats["llm"] = self.engine.llm.get_provider_info()
            if self.batcher is not None:
                stats["batching"] = self.batcher.stats()
            from ..utils.metrics import metrics, profiler

            if self.engine.ner is not None:
                # model extractions and fallbacks to rules
                stats["ner"] = self.engine.ner.stats()
            fused = getattr(self.engine.matcher, "_fused", None)
            if fused is not None:  # FUSED_QUERY=1: graphs, replays, redos
                stats["fused_query"] = fused.stats()
            stats["stage_latency"] = metrics.snapshot()
            tok = getattr(self.engine.encoder, "tokenizer", None)
            if tok is not None:  # the query tokenizer's piece memo
                stats["tokenizer_memo"] = tok.memo_stats()
            stats["profiler_active"] = profiler.active
            stats["uptime_s"] = round(time.time() - self.engine.started_at, 1)
            return json_response(stats)
        except Exception as e:
            return error_response(f"获取统计信息失败: {e}", 500)

    async def llm_switch(self, request) -> web.Response:
        provider = request.query.get("provider", "")
        if not provider:
            try:
                body = await request.json()
                provider = body.get("provider", "")
            except json.JSONDecodeError:
                pass
        if self.engine.llm is None:
            return error_response("LLM服务未就绪", 503)
        if self.engine.llm.switch_provider(provider):
            return json_response(
                {"message": f"成功切换到 {provider}", "current_provider": provider}
            )
        return error_response(f"切换到 {provider} 失败", 400)

    async def llm_test(self, request) -> web.Response:
        if self.engine.llm is None:
            return error_response("LLM服务未就绪", 503)
        loop = asyncio.get_event_loop()
        result = await loop.run_in_executor(None, self.engine.llm.test_connection)
        return json_response(result)

    async def resource_status(self, request) -> web.Response:
        status: Dict[str, Any] = {}
        if self.engine.store is not None:
            status["milvus"] = self.engine.store.health_check()
        else:
            status["milvus"] = {"healthy": False, "message": "服务未初始化"}
        if self.engine.encoder is not None:
            info = self.engine.encoder.get_model_info()
            status["embedding"] = {
                "loaded": True,
                "model_name": info["model_name"],
                "device": info["device"],
            }
        else:
            status["embedding"] = {"loaded": False, "message": "服务未初始化"}
        if self.engine.llm is not None:
            status["llm"] = self.engine.llm.get_provider_info()
        else:
            status["llm"] = {"connected": False, "message": "服务未初始化"}
        if self.engine.matcher is not None:
            status["multi_diagnosis"] = {
                "initialized": True,
                "ner_service": "MedicalNERService",
                "hierarchical_similarity": "HierarchicalSimilarityService",
                "confidence_service": "MultiDimensionalConfidenceService",
                "text_processor": "DiagnosisTextProcessor",
            }
        else:
            status["multi_diagnosis"] = {"initialized": False}
        return json_response(status)

    async def resource_release(self, request) -> web.Response:
        try:
            results: Dict[str, Any] = {}
            if self.engine.store is not None:
                results["milvus_collection"] = self.engine.store.release_collection()
            collected = gc.collect()
            results["garbage_collection"] = {"collected_objects": collected}
            return json_response({"status": "success", "results": results})
        except Exception as e:
            return error_response(f"释放资源失败: {e}", 500)

    async def resource_reload(self, request) -> web.Response:
        if self.engine.store is None:
            return error_response("存储服务未就绪", 503)
        try:
            released = self.engine.store.release_collection()
            loop = asyncio.get_event_loop()
            loaded = await loop.run_in_executor(
                None, self.engine.store.load_collection
            )
            if not loaded:
                return error_response("集合重新加载失败", 500)
            return json_response(
                {
                    "status": "success",
                    "message": "集合重新加载成功",
                    "release_result": released,
                    "load_state": {"loaded": self.engine.store.is_loaded},
                    "memory_usage": self.engine.store.get_memory_usage(),
                }
            )
        except Exception as e:
            return error_response(f"重新加载集合失败: {e}", 500)

    async def docs(self, request) -> web.Response:
        from .docs import docs_html

        return web.Response(text=docs_html(), content_type="text/html")

    async def openapi(self, request) -> web.Response:
        from .docs import openapi_spec

        return json_response(openapi_spec())

    async def profiler_start(self, request) -> web.Response:
        from ..utils.metrics import profiler

        try:
            return json_response(profiler.start())
        except Exception as e:
            return error_response(f"profiler启动失败: {e}", 500)

    async def profiler_stop(self, request) -> web.Response:
        from ..utils.metrics import profiler

        try:
            return json_response(profiler.stop())
        except Exception as e:
            return error_response(f"profiler停止失败: {e}", 500)

    async def ui_index(self, request) -> web.Response:
        index = STATIC_DIR / "index.html"
        if index.exists():
            return web.FileResponse(index)
        return error_response("UI not built", 404)

    # --------------------------------------------------------------- run

    def run(self) -> None:
        setup_logging(self.config)
        web.run_app(
            self.app, host=self.config.api.host, port=self.config.api.port,
            print=None,
        )


def main() -> None:
    from ..utils.device_guard import acquire_device

    # bound device acquisition: a card that never answers would otherwise
    # hang the server before it binds its port, which supervisors misread
    # as a slow warmup (utils/device_guard.py)
    APIServer(device=acquire_device("cuda", what="serving startup")).run()


if __name__ == "__main__":
    main()
