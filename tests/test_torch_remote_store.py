"""STORE_MODE=remote against the port's API server, on the CPU.

A second host's pipeline runs against a peer API server's
device-resident corpus (reference: MILVUS_MODE=server,
services/milvus_service.py:57-118). The port's API server, over the
port's store, answers ``/vector_search`` and ``/semantic_similarities``;
the port's ``RemoteVectorStore`` (a copy of the JAX package's client)
and the JAX package's own client, both pointed at it, must return the
serving host's local results: the same ids and codes, scores within
1e-6 relative (JSON round trip of fp32 values), as
tests/test_remote_store.py holds the JAX pair. ``Engine`` with
``STORE_MODE=remote`` builds the port's client.
"""

import asyncio
import socket
import threading

import numpy as np
import pytest
import torch

import test_api
from test_orchestrator import CORPUS_ROWS, MockEncoder

from rag_icd10_tpu.index.remote_store import RemoteVectorStore as JRemoteVectorStore
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.api.app import APIServer
from rag_icd10_tpu_torch.data.corpus import ICDCorpus
from rag_icd10_tpu_torch.index.remote_store import RemoteStoreError, RemoteVectorStore
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.pipeline.orchestrator import MultiDiagnosisService
from rag_icd10_tpu_torch.pipeline.textproc import DiagnosisTextProcessor
from rag_icd10_tpu_torch.runtime import Engine

torch.set_num_threads(2)  # the suite runs several test processes at once


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _engine() -> Engine:
    """tests/test_api.py's make_engine with the port's store and pipeline."""
    corpus = ICDCorpus.from_rows(CORPUS_ROWS)
    enc = MockEncoder()
    store = VectorStore(dim=64, config=tconfig.StoreConfig(pad_multiple=128), device="cpu")
    store.insert_records(list(corpus.records()), enc.encode_queries(corpus.semantic_texts))
    ner = MedicalNERService(tconfig.NERConfig(use_model=False))
    engine = Engine.__new__(Engine)
    engine.config = tconfig.Config()
    engine.encoder, engine.store, engine.ner = enc, store, ner
    engine.llm = test_api.MockLLM()
    engine.matcher = MultiDiagnosisService(
        encoder=enc, store=store, ner_service=ner,
        text_processor=DiagnosisTextProcessor(use_enhanced_processing=True, ner_service=ner),
    )
    engine.started_at = 0.0
    engine.llm_status = {}
    engine.startup = lambda test_llm=False: None
    engine.shutdown = lambda: None
    return engine


@pytest.fixture(scope="module")
def server():
    """The port's API server on a real socket in a background thread (the
    clients are synchronous httpx)."""
    engine = _engine()
    port = _free_port()
    loop = asyncio.new_event_loop()
    started = threading.Event()
    box = {}

    def run():
        asyncio.set_event_loop(loop)

        async def start():
            from aiohttp import web

            api = APIServer(config=tconfig.Config(), engine=engine)
            box["runner"] = runner = web.AppRunner(api.app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", port).start()
            started.set()

        loop.run_until_complete(start())
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(30)
    yield f"http://127.0.0.1:{port}", engine
    asyncio.run_coroutine_threadsafe(box["runner"].cleanup(), loop).result(timeout=30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("client", ["torch", "jax"])
@pytest.mark.parametrize("method", [None, "fast", "sketch", "hnsw"])
def test_search_parity_with_local(server, client, method):
    url, engine = server
    cls = RemoteVectorStore if client == "torch" else JRemoteVectorStore
    remote = cls(url, corpus=engine.store.corpus)
    try:
        q = engine.encoder.encode_queries(["急性胃肠炎", "高血压病3级"])
        local = engine.store.search(q, top_k=5, method=method)
        got = remote.search(q, top_k=5, method=method)
        assert len(got) == len(local)
        for a, b in zip(local, got):
            assert [h.id for h in a] == [h.id for h in b]
            assert [h.code for h in a] == [h.code for h in b]
            np.testing.assert_allclose(
                [h.score for h in a], [h.score for h in b], rtol=1e-6)
    finally:
        remote.close()


def test_semantic_similarities_parity(server):
    url, engine = server
    remote = RemoteVectorStore(url)
    try:
        q = engine.encoder.encode_queries(["急性胃肠炎"])
        ids = np.array([[0, 1, 2]])
        np.testing.assert_allclose(
            remote.semantic_similarities(q, ids),
            engine.store.semantic_similarities(q, ids), rtol=1e-6)
    finally:
        remote.close()


def test_health_stats_and_readonly(server):
    url, engine = server
    remote = RemoteVectorStore(url)
    try:
        assert remote.test_connection() and remote.is_loaded
        assert remote.num_entities == engine.store.num_entities
        assert remote.dim == 64
        stats = remote.get_collection_stats()
        assert stats["mode"] == "remote" and stats["remote_url"] == url
        assert stats["num_entities"] == engine.store.num_entities
        assert remote.get_memory_usage()["device_dtype"] == "float32"
        with pytest.raises(RemoteStoreError, match="read-only"):
            remote.insert_records([], np.zeros((0, 64), np.float32))
    finally:
        remote.close()


def test_unreachable_peer_reports_unhealthy():
    remote = RemoteVectorStore(f"http://127.0.0.1:{_free_port()}", timeout=2.0)
    try:
        health = remote.health_check()
        assert not health["healthy"] and "error" in health
        assert remote.num_entities == 0
    finally:
        remote.close()


def test_full_pipeline_over_remote_store(server):
    """A second host's matcher (local encoder + the port's REMOTE store)
    gives the serving host's candidates."""
    url, engine = server
    remote = RemoteVectorStore(url, corpus=engine.store.corpus)
    ner = MedicalNERService(tconfig.NERConfig(use_model=False))
    matcher = MultiDiagnosisService(
        encoder=engine.encoder, store=remote, ner_service=ner,
        text_processor=DiagnosisTextProcessor(use_enhanced_processing=True, ner_service=ner),
    )
    try:
        text = "急性胃肠炎，高血压病3级"
        got = matcher.match_multiple_diagnoses(text, top_k=3)
        want = engine.matcher.match_multiple_diagnoses(text, top_k=3)
        assert got["extracted_diagnoses"] == want["extracted_diagnoses"]
        for a, b in zip(want["matches"], got["matches"]):
            assert [c.code for c in a.candidates] == [c.code for c in b.candidates]
    finally:
        remote.close()


def test_engine_remote_mode_builds_the_ports_client(server):
    url, engine = server
    teng = Engine(
        tconfig.Config(store=tconfig.StoreConfig(mode="remote", server_url=url),
                       data_path=None),
        device="cpu",
    )
    store = teng.init_store()
    try:
        assert isinstance(store, RemoteVectorStore) and store.corpus is None
        q = engine.encoder.encode_queries(["慢性肝炎"])
        assert [h.id for h in store.search(q, 5)[0]] == [
            h.id for h in engine.store.search(q, 5)[0]]
        teng._warmup_extra_methods([1, 2])  # the peer warms its own methods
    finally:
        store.close()


def test_bad_requests_400(server):
    import httpx

    url, _ = server
    assert httpx.post(f"{url}/vector_search", json={"top_k": 5}).status_code == 400
    r = httpx.post(f"{url}/vector_search", json={"vectors": [[0.0] * 64], "top_k": 9999})
    assert r.status_code == 400
    r = httpx.post(f"{url}/vector_search",
                   json={"vectors": [[0.0] * 64], "top_k": 5, "search_method": "bogus"})
    assert r.status_code == 400
