"""The port's standalone UI launcher (rag_icd10_tpu_torch/ui_app.py):
index serving and API proxying (mirrors tests/test_ui_app.py), over the
port's own static page, and through to the port's API server."""

import asyncio

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from test_torch_slice import _mock_engine

from rag_icd10_tpu_torch.api.app import APIServer
from rag_icd10_tpu_torch.config import Config
from rag_icd10_tpu_torch.ui_app import API_PATHS, STATIC_DIR, build_app, find_free_port


@pytest.fixture()
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def test_find_free_port_returns_int():
    port = find_free_port(45000)
    assert 45000 <= port < 45020


def test_serves_the_ports_static_page():
    assert STATIC_DIR.parent.parent.name == "rag_icd10_tpu_torch"
    assert (STATIC_DIR / "index.html").exists()


def test_ui_serves_index_and_proxies(loop):
    async def run():
        # stub API backend
        api = web.Application()

        async def health(request):
            return web.json_response({"status": "healthy", "total_records": 1})

        async def query(request):
            body = await request.json()
            return web.json_response({"echo": body["text"]})

        api.router.add_get("/health", health)
        api.router.add_post("/query", query)
        api_server = TestServer(api)
        await api_server.start_server()

        ui = build_app(f"http://{api_server.host}:{api_server.port}")
        client = TestClient(TestServer(ui))
        await client.start_server()

        resp = await client.get("/")
        assert resp.status == 200
        assert "ICD-10" in await resp.text()

        resp = await client.get("/health")
        assert (await resp.json())["status"] == "healthy"

        resp = await client.post("/query", json={"text": "肺炎", "top_k": 2})
        assert (await resp.json())["echo"] == "肺炎"

        await client.close()
        await api_server.close()

    loop.run_until_complete(run())


def test_ui_proxies_the_ports_server(loop):
    """Every proxied path reaches the port's APIServer."""

    async def run():
        api_server = TestServer(APIServer(config=Config(), engine=_mock_engine()).app)
        await api_server.start_server()
        client = TestClient(TestServer(build_app(
            f"http://{api_server.host}:{api_server.port}")))
        await client.start_server()
        resp = await client.post("/query", json={"text": "急性胃肠炎", "top_k": 3})
        assert resp.status == 200 and (await resp.json())["candidates"]
        for path in API_PATHS:
            if path in ("/health", "/stats"):
                resp = await client.get(path)
                assert resp.status == 200, path
        await client.close()
        await api_server.close()

    loop.run_until_complete(run())
