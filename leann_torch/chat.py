"""LLM layer for RAG chat.

Counterpart of the JAX package's ``chat.py``; the one change is that the
local ``transformers`` model (:class:`HFChat`) runs on the port's
``device=`` (default ``"cuda"``, raising without CUDA). Parity with the
reference chat stack (leann-core/src/leann/chat.py:413-854):
``LLMInterface.ask()`` with Ollama / HuggingFace / OpenAI / Gemini / Simulated
providers behind a ``get_llm`` factory. Network providers require
reachability; the HF provider loads local checkpoints only (zero-egress).
``SimulatedChat`` doubles as the deterministic fake for tests, exactly like
the reference uses it (chat.py:807-813, tests/test_document_rag.py:23).
"""

from __future__ import annotations

import logging
import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class LLMInterface(ABC):
    @abstractmethod
    def ask(self, prompt: str, system: Optional[str] = None, **kwargs) -> str: ...


# ---------------------------------------------------------------------------
# Model validation + fuzzy suggestions (reference chat.py:20-250)
# ---------------------------------------------------------------------------


def list_local_ollama_models(host: str = "http://localhost:11434", timeout: float = 5) -> list:
    """Names of models installed in the local Ollama; [] when unreachable
    (validation then degrades to assume-exists, like the reference's remote
    check does on scrape failure, chat.py:88-92)."""
    import json
    import urllib.request

    try:
        with urllib.request.urlopen(f"{host}/api/tags", timeout=timeout) as r:
            data = json.loads(r.read())
        return [m.get("name", "") for m in data.get("models", [])]
    except Exception:
        return []


def suggest_similar_models(query: str, available: list, n: int = 3) -> list:
    """Layered fuzzy match (reference search_ollama_models_fuzzy,
    chat.py:96-170): exact -> prefix -> substring -> version-stripped base
    name -> difflib close matches."""
    import difflib

    q = query.lower()
    out: list = []

    def add(models):
        for m in models:
            if m not in out:
                out.append(m)

    add(m for m in available if m.lower() == q)
    add(m for m in available if m.lower().startswith(q))
    add(m for m in available if q in m.lower())
    base = q.split(":")[0]
    add(m for m in available if m.lower().split(":")[0] == base)
    add(difflib.get_close_matches(q, [m for m in available if m not in out], n=n, cutoff=0.3))
    return out[:n]


def validate_ollama_chat_model(model: str, host: str = "http://localhost:11434") -> str:
    """Resolve ``model`` against the local Ollama library (exact or
    version-tagged). Unknown names raise with a pull hint and fuzzy
    suggestions; an unreachable server validates permissively (the error
    surfaces on first ask with full context)."""
    available = list_local_ollama_models(host)
    if not available:
        return model
    for name in available:
        if model == name or model == name.split(":")[0]:
            return name
    sugg = suggest_similar_models(model, available)
    hint = f" Did you mean: {', '.join(sugg)}?" if sugg else ""
    raise ValueError(
        f"Ollama model {model!r} not found locally. Install it with `ollama pull {model}`.{hint}"
    )


# Curated suggestions when an HF checkpoint can't be found — parity with the
# reference's offline fallback list (chat.py:106-120)
POPULAR_HF_MODELS = [
    "Qwen/Qwen3-0.6B", "Qwen/Qwen2.5-1.5B-Instruct", "meta-llama/Llama-3.2-1B-Instruct",
    "microsoft/Phi-3-mini-4k-instruct", "google/gemma-2-2b-it", "mistralai/Mistral-7B-Instruct-v0.3",
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0", "HuggingFaceTB/SmolLM2-1.7B-Instruct",
]


def validate_hf_model(model: str) -> str:
    """A usable HF chat model is a local directory or a checkpoint already in
    the HF cache (this image has zero egress — nothing can be downloaded).
    Raises with fuzzy suggestions from the curated list otherwise."""
    if os.path.isdir(model):
        return model
    cache = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    cached = os.path.join(cache, "hub", "models--" + model.replace("/", "--"))
    if os.path.isdir(cached):
        return model
    sugg = suggest_similar_models(model, POPULAR_HF_MODELS)
    hint = f" Similar known models: {', '.join(sugg)}." if sugg else ""
    raise ValueError(
        f"HF model {model!r} is neither a local path nor in the HF cache "
        f"(no network egress to download it).{hint}"
    )


class SimulatedChat(LLMInterface):
    """Deterministic canned responses; echoes a slice of retrieved context so
    RAG tests can assert the context actually reached the LLM."""

    def ask(self, prompt: str, system: Optional[str] = None, **kwargs) -> str:
        context = ""
        if "Context:" in prompt:
            context = prompt.split("Context:", 1)[1].split("Question:", 1)[0].strip()
        head = context[:200].replace("\n", " ")
        return f"[simulated] Based on the retrieved context: {head}"


class OllamaChat(LLMInterface):
    def __init__(self, model: str = "llama3.2:1b", host: str = "http://localhost:11434",
                 thinking_budget: Optional[str] = None):
        self.model, self.host = model, host
        # reasoning-effort mapping for gpt-oss / deepseek-r1 families
        # (reference chat.py:493-514)
        self.thinking_budget = thinking_budget

    def ask(self, prompt: str, system: Optional[str] = None, **kwargs) -> str:
        import json
        import urllib.request

        payload: Dict[str, Any] = {"model": self.model, "prompt": prompt, "stream": False}
        if system:
            payload["system"] = system
        if self.thinking_budget and any(f in self.model for f in ("gpt-oss", "deepseek-r1")):
            payload["options"] = {"reasoning_effort": self.thinking_budget}
        req = urllib.request.Request(
            f"{self.host}/api/generate", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read()).get("response", "")


class OpenAIChat(LLMInterface):
    def __init__(self, model: str = "gpt-4o-mini", thinking_budget: Optional[str] = None):
        from openai import OpenAI

        self.client = OpenAI(api_key=os.environ.get("OPENAI_API_KEY"))
        self.model = model
        self.thinking_budget = thinking_budget

    def ask(self, prompt: str, system: Optional[str] = None, max_tokens: int = 1024, **kwargs) -> str:
        messages = ([{"role": "system", "content": system}] if system else []) + [
            {"role": "user", "content": prompt}
        ]
        params: Dict[str, Any] = {"model": self.model, "messages": messages}
        # o-series parameter shape (reference chat.py:768-790)
        if self.model.startswith(("o1", "o3", "o4")):
            params["max_completion_tokens"] = max_tokens
            if self.thinking_budget:
                params["reasoning_effort"] = self.thinking_budget
        else:
            params["max_tokens"] = max_tokens
        resp = self.client.chat.completions.create(**params)
        return resp.choices[0].message.content or ""


class GeminiChat(LLMInterface):
    def __init__(self, model: str = "gemini-2.0-flash"):
        from google import genai

        self.client = genai.Client(api_key=os.environ.get("GEMINI_API_KEY"))
        self.model = model

    def ask(self, prompt: str, system: Optional[str] = None, **kwargs) -> str:
        full = f"{system}\n\n{prompt}" if system else prompt
        resp = self.client.models.generate_content(model=self.model, contents=full)
        return resp.text or ""


class HFChat(LLMInterface):
    """A local transformers checkpoint, on ``device`` (no CPU fallback)."""

    def __init__(self, model: str, max_new_tokens: int = 256, device: str = "cuda"):
        import torch

        from .device import resolve_device

        self.device = resolve_device(device)
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model, local_files_only=True)
        self.model = AutoModelForCausalLM.from_pretrained(
            model, local_files_only=True, torch_dtype=torch.float32).to(self.device)
        self.max_new_tokens = max_new_tokens

    def ask(self, prompt: str, system: Optional[str] = None, **kwargs) -> str:
        messages = ([{"role": "system", "content": system}] if system else []) + [
            {"role": "user", "content": prompt}
        ]
        # qwen-style no-think toggle parity (chat.py:617-680)
        text = self.tokenizer.apply_chat_template(messages, tokenize=False, add_generation_prompt=True)
        inputs = self.tokenizer(text, return_tensors="pt").to(self.device)
        out = self.model.generate(**inputs, max_new_tokens=self.max_new_tokens, do_sample=False)
        return self.tokenizer.decode(out[0][inputs["input_ids"].shape[1]:], skip_special_tokens=True)


def get_llm(config: Dict[str, Any], device: str = "cuda") -> LLMInterface:
    """Factory (reference chat.py:816-854). ``config = {"type": ..., "model": ..., ...}``;
    ``device`` is where an ``hf`` model runs."""
    llm_type = (config.get("type") or "simulated").lower()
    model = config.get("model")
    validate = config.get("validate", True)
    if llm_type == "simulated":
        return SimulatedChat()
    if llm_type == "ollama":
        host = config.get("host", "http://localhost:11434")
        m = model or "llama3.2:1b"
        if validate:
            m = validate_ollama_chat_model(m, host=host)
        return OllamaChat(model=m, host=host, thinking_budget=config.get("thinking_budget"))
    if llm_type == "openai":
        return OpenAIChat(model=model or "gpt-4o-mini", thinking_budget=config.get("thinking_budget"))
    if llm_type == "gemini":
        return GeminiChat(model=model or "gemini-2.0-flash")
    if llm_type == "hf":
        m = model or "Qwen/Qwen3-0.6B"
        if validate:
            m = validate_hf_model(m)
        return HFChat(model=m, device=device)
    raise ValueError(f"Unknown LLM type {llm_type!r}")
