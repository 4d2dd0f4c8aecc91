"""Standalone web UI launcher — the gradio_app.py equivalent.

The reference serves a Gradio Blocks app on port 7860 that talks to the
API over HTTP only (reference: gradio_app.py:226-232, ui/api_client.py).
Gradio is not available in this environment, so this launcher serves the
same 3-tab UI (api/static/) as a separate process on GRADIO_PORT,
proxying API calls to API_PORT — preserving the reference's two-process
topology (UI <-HTTP-> API). Port auto-discovery from the configured port
mirrors gradio_app.py:33-46.
"""

from __future__ import annotations

import logging
import socket
from pathlib import Path

from aiohttp import ClientSession, web

from .config import get_config

logger = logging.getLogger("rag_icd10_tpu_torch.ui")

STATIC_DIR = Path(__file__).parent / "api" / "static"
API_PATHS = (
    "/health", "/query", "/standardize", "/embed", "/entities", "/stats",
)


def find_free_port(start: int, tries: int = 20) -> int:
    """Port auto-discovery (reference: gradio_app.py:33-46)."""
    for port in range(start, start + tries):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            if s.connect_ex(("127.0.0.1", port)) != 0:
                return port
    return start


def build_app(api_base: str) -> web.Application:
    app = web.Application()

    async def index(request):
        return web.FileResponse(STATIC_DIR / "index.html")

    async def proxy(request):
        url = api_base + request.path
        async with ClientSession() as session:
            data = await request.read()
            async with session.request(
                request.method, url, data=data or None,
                headers={"Content-Type": "application/json"},
            ) as resp:
                body = await resp.read()
                return web.Response(
                    body=body, status=resp.status,
                    content_type=resp.content_type,
                )

    app.router.add_get("/", index)
    for path in API_PATHS:
        app.router.add_route("*", path, proxy)
    app.router.add_static("/static/", str(STATIC_DIR))
    return app


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    cfg = get_config()
    api_base = f"http://127.0.0.1:{cfg.api.port}"
    port = find_free_port(cfg.api.ui_port)
    app = build_app(api_base)
    logger.info("UI on http://%s:%s (API at %s)", cfg.api.ui_host, port, api_base)
    # SIGINT/SIGTERM handled by aiohttp's run_app (reference registers its
    # own handlers, gradio_app.py:238-244)
    web.run_app(app, host=cfg.api.ui_host, port=port, print=None)


if __name__ == "__main__":
    main()
