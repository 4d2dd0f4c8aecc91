"""LLM standardization client (OpenAI-compatible chat API over httpx).

Behavioral spec (reference: services/llm_service.py):
- 3 switchable providers deepseek/openai/local (:20-47); per-call temporary
  provider switch restored afterwards (:123-127,:179-181)
- Chinese standardization prompt listing <=10 candidates with scores
  (:81-118), strict-JSON response contract
  {"results":[{diagnosis, code, title, confidence}]}
- fenced ```json block extraction (:155-172); on any parse/call failure
  falls back to the top candidate with confidence capped at 0.95
  (:183-195)
- temperature 0.1, max_tokens 2048 (:29-30); test_connection with 90 s
  timeout and error-type classification timeout/auth/endpoint/unknown
  (:256-309); get_provider_info (:311)

Implementation difference: the openai SDK is not available in this
environment, so this client speaks the OpenAI chat/completions REST
protocol directly through httpx — same wire format, fewer layers.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ..config import LLMConfig, LLMProviderConfig

SYSTEM_PROMPT = "你是一个专业的ICD-10医学编码专家，能够准确识别和标准化医学诊断。"

PROMPT_HEADER = (
    "您是一名 ICD-10 医学标准化助理，根据输入的诊断内容，识别其中可能包含的多个诊断，"
    "并为每个诊断匹配最适合的 ICD-10 code。\n\n用户输入：\"{input_text}\"\n\n候选码值：\n"
)

PROMPT_FOOTER = """
请按以下格式返回结果：
```json
{
  "results": [
    {
      "diagnosis": "识别出的诊断名称",
      "code": "匹配的ICD-10编码",
      "title": "标准诊断名称",
      "confidence": 0.85
    }
  ]
}
```

注意事项：
1. 只返回JSON格式，不要包含其他文本
2. confidence取值范围0.0-1.0
3. 如果输入包含多个诊断，请分别识别和匹配
4. 优先选择相似度分数高的候选编码
"""


def build_standardize_prompt(input_text: str, candidates: List[Dict]) -> str:
    prompt = PROMPT_HEADER.format(input_text=input_text)
    for cand in candidates[:10]:
        prompt += (
            f"({cand.get('score', 0):.2f}) "
            f"{cand.get('code', '')}: {cand.get('title', '')}\n"
        )
    return prompt + PROMPT_FOOTER


def extract_json_block(content: str) -> str:
    """Pull the fenced ```json block if present, else the raw content."""
    if "```json" in content:
        start = content.find("```json") + 7
        end = content.find("```", start)
        return content[start:end].strip()
    return content.strip()


class LLMService:
    """OpenAI-compatible chat client with provider switching + fallbacks."""

    def __init__(self, config: Optional[LLMConfig] = None):
        self.config = config or LLMConfig()
        self.providers: Dict[str, LLMProviderConfig] = LLMConfig.providers()
        self.provider = (
            self.config.provider if self.config.provider in self.providers else "deepseek"
        )
        self._client = None  # lazy httpx.Client

    # ------------------------------------------------------------ plumbing

    def _http(self):
        if self._client is None:
            import httpx

            self._client = httpx.Client(timeout=self.config.timeout_s)
        return self._client

    def _chat(
        self,
        messages: List[Dict[str, str]],
        max_tokens: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> Dict[str, Any]:
        """POST /chat/completions in the OpenAI wire format."""
        pc = self.providers[self.provider]
        url = pc.base_url.rstrip("/") + "/chat/completions"
        payload = {
            "model": pc.model,
            "messages": messages,
            "max_tokens": max_tokens or self.config.max_tokens,
            "temperature": self.config.temperature,
        }
        headers = {"Authorization": f"Bearer {pc.api_key}"} if pc.api_key else {}
        resp = self._http().post(
            url, json=payload, headers=headers, timeout=timeout or self.config.timeout_s
        )
        resp.raise_for_status()
        return resp.json()

    # ------------------------------------------------------------- public

    def switch_provider(self, provider: str) -> bool:
        if provider not in self.providers:
            return False
        self.provider = provider
        return True

    def standardize_diagnosis(
        self,
        input_text: str,
        candidates: List[Dict[str, Any]],
        provider: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        original = self.provider
        if provider and provider != self.provider:
            self.switch_provider(provider)
        try:
            prompt = build_standardize_prompt(input_text, candidates)
            data = self._chat(
                [
                    {"role": "system", "content": SYSTEM_PROMPT},
                    {"role": "user", "content": prompt},
                ]
            )
            content = data["choices"][0]["message"]["content"].strip()
            try:
                result = json.loads(extract_json_block(content))
                return result.get("results", [])
            except (json.JSONDecodeError, AttributeError):
                return self._fallback_result(input_text, candidates)
        except Exception:
            return self._fallback_result(input_text, candidates)
        finally:
            if provider and provider != original:
                self.switch_provider(original)

    @staticmethod
    def _fallback_result(
        input_text: str, candidates: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Top-candidate fallback, confidence capped 0.95 (:183-195)."""
        if not candidates:
            return []
        best = candidates[0]
        return [
            {
                "diagnosis": input_text,
                "code": best.get("code", ""),
                "title": best.get("title", ""),
                "confidence": min(best.get("score", 0), 0.95),
            }
        ]

    def generate_response(
        self, prompt: str, provider: Optional[str] = None
    ) -> Dict[str, Any]:
        original = self.provider
        if provider and provider != self.provider:
            self.switch_provider(provider)
        try:
            data = self._chat([{"role": "user", "content": prompt}])
            usage = data.get("usage", {})
            return {
                "content": data["choices"][0]["message"]["content"].strip(),
                "provider": self.provider,
                "model": self.providers[self.provider].model,
                "usage": {
                    "prompt_tokens": usage.get("prompt_tokens", 0),
                    "completion_tokens": usage.get("completion_tokens", 0),
                    "total_tokens": usage.get("total_tokens", 0),
                },
            }
        except Exception as e:
            return {"error": str(e), "provider": self.provider}
        finally:
            if provider and provider != original:
                self.switch_provider(original)

    def test_connection(self) -> Dict[str, Any]:
        start = time.time()
        try:
            data = self._chat(
                [{"role": "user", "content": "你好"}],
                max_tokens=10,
                timeout=self.config.test_timeout_s,
            )
            return {
                "connected": True,
                "provider": self.provider,
                "model": self.providers[self.provider].model,
                "response": data["choices"][0]["message"]["content"],
                "duration": time.time() - start,
            }
        except Exception as e:
            msg = str(e)
            if "timeout" in msg.lower() or "timed out" in msg.lower():
                error_type = "timeout"
            elif "authentication" in msg.lower() or "401" in msg:
                error_type = "auth"
            elif "404" in msg:
                error_type = "endpoint"
            else:
                error_type = "unknown"
            return {
                "connected": False,
                "provider": self.provider,
                "error": msg,
                "error_type": error_type,
                "duration": time.time() - start,
            }

    def get_provider_info(self) -> Dict[str, Any]:
        pc = self.providers[self.provider]
        return {
            "current_provider": self.provider,
            "model": pc.model,
            "base_url": pc.base_url,
            "max_tokens": self.config.max_tokens,
            "temperature": self.config.temperature,
            "available_providers": list(self.providers),
        }

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
