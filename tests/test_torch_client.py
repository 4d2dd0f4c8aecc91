"""The port's Python API client (rag_icd10_tpu_torch/client.py) against the
port's in-process server (mirrors tests/test_client.py): the same method
surface and error taxonomy, and the same answers as the JAX package's
client reading the same server. The engine is tests/test_api.py's
MockEncoder engine built with the port's store and pipeline."""

import asyncio

import pytest
from aiohttp.test_utils import TestServer
from test_torch_slice import _mock_engine

from rag_icd10_tpu.client import APIClient as JAPIClient
from rag_icd10_tpu_torch.api.app import APIServer
from rag_icd10_tpu_torch.client import APIClient, APIClientError
from rag_icd10_tpu_torch.config import Config


@pytest.fixture()
def live_server():
    loop = asyncio.new_event_loop()

    async def _start():
        server = APIServer(config=Config(), engine=_mock_engine())
        ts = TestServer(server.app)
        await ts.start_server()
        return ts

    ts = loop.run_until_complete(_start())
    yield f"http://{ts.host}:{ts.port}", loop, ts
    loop.run_until_complete(ts.close())
    loop.close()


def test_health_and_query(live_server):
    url, loop, _ = live_server

    def run():
        client = APIClient(base_url=url)
        health = client.check_health()
        assert health["status"] == "healthy"
        result = client.query_diagnosis("急性胃肠炎，高血压", top_k=3)
        assert result["is_multi_diagnosis"] is True
        ents = client.extract_entities("急性胃肠炎")
        assert "entities" in ents
        emb = client.embed(["急性胃肠炎"])
        assert len(emb["embeddings"][0]) == 64
        stats = client.get_stats()
        assert "milvus" in stats
        # rule mode asked for (use_model=False): no fallback counted
        assert stats["ner"]["rule_fallbacks"] == 0 and "fused_query" not in stats
        client.close()

    loop.run_until_complete(loop.run_in_executor(None, run))


def test_same_answers_as_jax_client(live_server):
    url, loop, _ = live_server

    def run():
        port, jax_client = APIClient(base_url=url), JAPIClient(base_url=url)
        for text in ("急性胃肠炎，高血压", "慢性肝炎"):
            got = port.query_diagnosis(text, top_k=3)
            want = jax_client.query_diagnosis(text, top_k=3)
            assert got["candidates"] == want["candidates"]
            assert got["extracted_diagnoses"] == want["extracted_diagnoses"]
        assert port.extract_entities("急性胃肠炎") == jax_client.extract_entities("急性胃肠炎")
        port.close()
        jax_client.close()

    loop.run_until_complete(loop.run_in_executor(None, run))


def test_http_error_taxonomy(live_server):
    url, loop, _ = live_server

    def run():
        client = APIClient(base_url=url)
        with pytest.raises(APIClientError) as ei:
            client.query_diagnosis("", top_k=3)
        assert ei.value.kind == "http" and ei.value.status == 400
        client.close()

    loop.run_until_complete(loop.run_in_executor(None, run))


def test_connection_error():
    client = APIClient(base_url="http://localhost:59999", timeout=2.0)
    with pytest.raises(APIClientError) as ei:
        client.check_health()
    assert ei.value.kind in ("connection", "timeout")
    client.close()
