"""API documentation: /openapi.json + a self-contained /docs page.

The reference gets these for free from FastAPI (main.py advertises
"docs": "/docs"); aiohttp has no equivalent, so the OpenAPI 3.0 spec is
generated from the pydantic models and the docs page is rendered without
any CDN assets (zero-egress friendly).
"""

from __future__ import annotations

import json
from typing import Any, Dict

from .schemas import (
    EmbeddingRequest,
    EmbeddingResponse,
    HealthCheckResponse,
    QueryRequest,
    QueryResponse,
    StandardizeRequest,
    StandardizeResponse,
)

_ENDPOINTS = [
    ("get", "/", "根路径", None, None),
    ("get", "/health", "健康检查", None, HealthCheckResponse),
    ("post", "/query", "多诊断向量搜索", QueryRequest, QueryResponse),
    ("post", "/standardize", "LLM诊断标准化", StandardizeRequest, StandardizeResponse),
    ("post", "/embed", "文本向量化", EmbeddingRequest, EmbeddingResponse),
    ("post", "/entities", "医学实体提取 {text, filter_drugs}", None, None),
    ("get", "/stats", "系统统计（含per-stage延迟）", None, None),
    ("post", "/llm/switch", "切换LLM提供商 (?provider=)", None, None),
    ("get", "/llm/test", "测试LLM连接", None, None),
    ("get", "/resource/status", "资源状态", None, None),
    ("post", "/resource/release", "释放设备内存", None, None),
    ("post", "/resource/reload", "重新加载集合", None, None),
    ("post", "/profiler/start", "开始torch profiler跟踪", None, None),
    ("post", "/profiler/stop", "停止torch profiler跟踪", None, None),
]


def openapi_spec() -> Dict[str, Any]:
    schemas: Dict[str, Any] = {}
    paths: Dict[str, Any] = {}
    for method, path, summary, req, resp in _ENDPOINTS:
        op: Dict[str, Any] = {"summary": summary, "responses": {"200": {"description": "OK"}}}
        if req is not None:
            schemas[req.__name__] = req.model_json_schema(
                ref_template="#/components/schemas/{model}"
            )
            op["requestBody"] = {
                "content": {
                    "application/json": {
                        "schema": {"$ref": f"#/components/schemas/{req.__name__}"}
                    }
                }
            }
        if resp is not None:
            schemas[resp.__name__] = resp.model_json_schema(
                ref_template="#/components/schemas/{model}"
            )
            op["responses"]["200"] = {
                "description": "OK",
                "content": {
                    "application/json": {
                        "schema": {"$ref": f"#/components/schemas/{resp.__name__}"}
                    }
                },
            }
        paths.setdefault(path, {})[method] = op
    # hoist nested $defs into components
    for name, schema in list(schemas.items()):
        for dname, dschema in schema.pop("$defs", {}).items():
            schemas.setdefault(dname, dschema)
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "ICD-10 诊断标准化API (PyTorch/CUDA)",
            "version": "1.0.0",
        },
        "paths": paths,
        "components": {"schemas": schemas},
    }


def docs_html() -> str:
    spec = openapi_spec()
    rows = []
    for path, methods in spec["paths"].items():
        for method, op in methods.items():
            body = ""
            if "requestBody" in op:
                ref = op["requestBody"]["content"]["application/json"]["schema"]["$ref"]
                name = ref.rsplit("/", 1)[-1]
                props = spec["components"]["schemas"].get(name, {}).get("properties", {})
                body = ", ".join(props.keys())
            rows.append(
                f"<tr><td><code>{method.upper()}</code></td>"
                f"<td><code>{path}</code></td><td>{op['summary']}</td>"
                f"<td><code>{body}</code></td></tr>"
            )
    return f"""<!DOCTYPE html>
<html lang="zh-CN"><head><meta charset="utf-8">
<title>API 文档 — ICD-10 PyTorch/CUDA</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 40px; color: #0f172a; }}
table {{ border-collapse: collapse; width: 100%; }}
th, td {{ border: 1px solid #e2e8f0; padding: 8px 12px; text-align: left; font-size: 14px; }}
th {{ background: #f1f5f9; }}
code {{ background: #f1f5f9; padding: 1px 5px; border-radius: 4px; }}
</style></head><body>
<h1>ICD-10 诊断标准化 API（PyTorch/CUDA）</h1>
<p>机器可读规范: <a href="/openapi.json">/openapi.json</a> · Web UI: <a href="/ui">/ui</a></p>
<table><tr><th>方法</th><th>路径</th><th>说明</th><th>请求字段</th></tr>
{''.join(rows)}
</table></body></html>"""
