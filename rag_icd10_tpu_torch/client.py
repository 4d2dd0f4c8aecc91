"""Python API client — programmatic access to the service.

Parity with the reference's requests wrapper (reference: ui/api_client.py):
same method surface (``query_diagnosis``, ``standardize_diagnosis``,
``extract_entities``, ``check_health``), the same error taxonomy
(connection / timeout / HTTP status), and a module-level singleton
(:164). Base URL default http://localhost:8005 (:21).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import httpx


class APIClientError(Exception):
    def __init__(self, message: str, kind: str = "unknown", status: Optional[int] = None):
        super().__init__(message)
        self.kind = kind  # connection | timeout | http | unknown
        self.status = status


class APIClient:
    """Synchronous HTTP client for the ICD-10 API."""

    def __init__(self, base_url: Optional[str] = None, timeout: float = 30.0):
        self.base_url = (
            base_url
            or os.getenv("ICD_API_URL")
            or f"http://localhost:{os.getenv('API_PORT', '8005')}"
        ).rstrip("/")
        self.timeout = timeout
        self._http = httpx.Client(timeout=timeout)

    # ------------------------------------------------------------ plumbing

    def _request(
        self,
        method: str,
        path: str,
        payload: Optional[Dict] = None,
        timeout: Optional[float] = None,
    ) -> Dict[str, Any]:
        url = f"{self.base_url}{path}"
        try:
            resp = self._http.request(
                method, url, json=payload, timeout=timeout or self.timeout
            )
        except httpx.ConnectError as e:
            raise APIClientError(f"无法连接到API服务 ({url}): {e}", "connection")
        except httpx.TimeoutException as e:
            raise APIClientError(f"请求超时 ({url}): {e}", "timeout")
        if resp.status_code >= 400:
            try:
                detail = resp.json().get("detail", resp.text)
            except json.JSONDecodeError:
                detail = resp.text
            raise APIClientError(
                f"HTTP {resp.status_code}: {detail}", "http", resp.status_code
            )
        return resp.json()

    # ------------------------------------------------------------- public

    def check_health(self) -> Dict[str, Any]:
        return self._request("GET", "/health")

    def query_diagnosis(
        self,
        text: str,
        top_k: int = 5,
        search_method: str = None,
        ef_search: int = None,
    ) -> Dict[str, Any]:
        """POST /query (reference: ui/api_client.py:107-133; the reference
        also sends an `enhanced_processing` flag the server ignores —
        dropped here). ``search_method`` (exact/approx/fast/streaming/hnsw) and
        ``ef_search`` are per-request index-knob overrides."""
        payload: Dict[str, Any] = {"text": text, "top_k": top_k}
        if search_method is not None:
            payload["search_method"] = search_method
        if ef_search is not None:
            payload["ef_search"] = ef_search
        return self._request("POST", "/query", payload)

    def standardize_diagnosis(
        self, text: str, top_k: int = 10, llm_provider: str = "deepseek"
    ) -> Dict[str, Any]:
        """POST /standardize with the reference's 60 s timeout
        (ui/api_client.py:135-162)."""
        return self._request(
            "POST",
            "/standardize",
            {"text": text, "top_k": top_k, "llm_provider": llm_provider},
            timeout=60.0,
        )

    def extract_entities(self, text: str, filter_drugs: bool = True) -> Dict[str, Any]:
        return self._request(
            "POST", "/entities", {"text": text, "filter_drugs": filter_drugs}
        )

    def embed(self, texts) -> Dict[str, Any]:
        return self._request("POST", "/embed", {"texts": list(texts)})

    def get_stats(self) -> Dict[str, Any]:
        return self._request("GET", "/stats")

    def close(self) -> None:
        self._http.close()


# module-level singleton (reference: ui/api_client.py:164)
api_client = APIClient()
