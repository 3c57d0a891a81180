"""Embedding computation dispatch.

Counterpart of the JAX package's ``embeddings/compute.py``, with these modes:

* the in-process encoder (``tpu``, the mode name every index's meta.json
  carries for "in-process encoder", and its aliases
  ``sentence-transformers``, ``mlx``, ``hf``, ``jax``) — ``encoder.py`` on
  the given device;
* ``simulated`` — deterministic bag-of-hashed-words embeddings, no model;
* ``openai`` / ``ollama`` / ``gemini`` — HTTP-backed modes (the reference's
  embedding_compute.py:356-869). They need their server (or package and
  key) and raise a clear error otherwise; none falls back to the in-process
  encoder. ``openai`` and ``google.genai`` are imported inside their modes.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

IN_PROCESS_MODES = {"tpu", "jax", "sentence-transformers", "mlx", "hf"}


def compute_embeddings(
    texts: Sequence[str],
    model_name: str,
    mode: str = "tpu",
    batch_size: int = 128,
    is_build: bool = False,
    max_length: Optional[int] = None,
    device: str = "cuda",
    **kwargs,
) -> np.ndarray:
    """Embed ``texts`` -> float32 [N, D] (host)."""
    texts = list(texts)
    if not texts:
        raise ValueError("compute_embeddings called with no texts")
    mode = (mode or "tpu").lower()
    if mode in IN_PROCESS_MODES:
        from .encoder import get_encoder

        emb = get_encoder(model_name, max_length=max_length, device=device).encode(texts, batch_size=batch_size)
    elif mode == "simulated":
        emb = simulated_embeddings(texts, model_name=model_name, **{k: v for k, v in kwargs.items() if k == "dim"})
    elif mode == "openai":
        emb = _openai_embeddings(texts, model_name, batch_size=min(batch_size, 500))
    elif mode == "ollama":
        emb = _ollama_embeddings(texts, model_name, **kwargs)
    elif mode == "gemini":
        emb = _gemini_embeddings(texts, model_name)
    else:
        raise ValueError(f"Unknown embedding mode {mode!r}")
    if not np.isfinite(emb).all():
        raise ValueError("Embeddings contain NaN/Inf")
    return np.ascontiguousarray(emb, dtype=np.float32)


def simulated_embeddings(texts: Sequence[str], model_name: str = "simulated", dim: int = 64) -> np.ndarray:
    """Deterministic, dependency-free embeddings: average of per-token random
    vectors (seeded by token hash), L2-normalized."""
    from .tokenizer import HashTokenizer, stable_hash

    tok = HashTokenizer(vocab_size=1 << 30, max_length=8192)
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        words = tok.tokenize_words(t)
        if not words:
            words = ["<empty>"]
        acc = np.zeros(dim, dtype=np.float64)
        for w in words:
            rng = np.random.default_rng(stable_hash(w) % (2**63))
            acc += rng.standard_normal(dim)
        v = acc / len(words)
        out[i] = v / max(np.linalg.norm(v), 1e-12)
    return out


# ---------------------------------------------------------------------------
# HTTP modes (network-gated)
# ---------------------------------------------------------------------------


_openai_client = None


def _openai_embeddings(texts: List[str], model_name: str, batch_size: int = 0) -> np.ndarray:
    """OpenAI embeddings with the reference's guardrails (embedding_compute.py:356-432):
    empty-text validation, API-key check, cached client, and batch size chosen
    by average text length (800, dropping to 500 for long texts to stay under
    the token limit)."""
    import os

    global _openai_client
    invalid = sum(1 for t in texts if not isinstance(t, str) or not t.strip())
    if invalid:
        raise ValueError(
            f"Found {invalid} empty/invalid text(s); filter before calling the OpenAI mode"
        )
    if not os.environ.get("OPENAI_API_KEY"):
        raise RuntimeError("OPENAI_API_KEY environment variable not set")
    try:
        from openai import OpenAI
    except ImportError as e:
        raise RuntimeError("openai python package not available") from e
    if _openai_client is None:
        _openai_client = OpenAI(api_key=os.environ.get("OPENAI_API_KEY"))
    if not batch_size:
        avg_len = sum(len(t) for t in texts) / len(texts)
        batch_size = 500 if avg_len > 300 else 800
    out = []
    for s in range(0, len(texts), batch_size):
        resp = _openai_client.embeddings.create(model=model_name, input=texts[s : s + batch_size])
        out.extend(d.embedding for d in resp.data)
    return np.asarray(out, dtype=np.float32)


def _http_json(url: str, payload=None, timeout: float = 30):
    import json
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def validate_ollama_model(model_name: str, host: str = "http://localhost:11434",
                          timeout: float = 5) -> str:
    """Check the Ollama server is reachable and ``model_name`` exists locally
    (exact or version-tagged match); returns the resolved (tagged) name.
    Unknown models raise with a pull hint + the locally available embedding
    models — parity with embedding_compute.py:541-637."""
    import urllib.error

    try:
        _http_json(f"{host}/api/version", timeout=timeout)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"Could not connect to Ollama at {host}: {e}. "
            "Start it with `ollama serve` (https://ollama.com/download)."
        ) from e
    tags = _http_json(f"{host}/api/tags", timeout=timeout)
    names = [m.get("name", "") for m in tags.get("models", [])]
    for name in names:
        if model_name == name or model_name == name.split(":")[0]:
            return name
    emb_models = [n for n in names
                  if any(p in n.split(":")[0] for p in ("embed", "bge", "minilm", "e5"))]
    hint = f" Locally available embedding models: {', '.join(emb_models)}." if emb_models else ""
    raise RuntimeError(
        f"Model {model_name!r} not found in local Ollama. "
        f"Install it with `ollama pull {model_name}`.{hint}"
    )


def _ollama_embeddings(
    texts: List[str],
    model_name: str,
    host: str = "http://localhost:11434",
    max_retries: int = 3,
    validate: bool = True,
    timeout: float = 30,
    **_,
) -> np.ndarray:
    """Ollama embeddings with the reference's robustness behaviors
    (embedding_compute.py:640-789): 8000-char truncation, per-text retries,
    zero-vector fill for texts that fail after retries (error only when ALL
    fail), dimension-consistency validation, and L2 normalization with a
    zero-norm guard."""
    if validate:
        model_name = validate_ollama_model(model_name, host=host)
    out: List[Optional[list]] = []
    n_failed = 0
    for i, t in enumerate(texts):
        # the reference truncates to 8000 chars for ollama (embedding_compute.py:663-664)
        payload = {"model": model_name, "prompt": t[:8000]}
        emb = None
        for _attempt in range(max_retries):
            try:
                resp = _http_json(f"{host}/api/embeddings", payload, timeout=timeout)
                emb = resp.get("embedding")
                if not isinstance(emb, list) or not emb:
                    raise ValueError(f"invalid embedding payload for text {i}")
                break
            except Exception as e:  # noqa: BLE001 — retry any transport/payload error
                emb = None
                logger.debug("ollama embed attempt failed for text %d: %s", i, e)
        if emb is None:
            n_failed += 1
            logger.warning("ollama: no embedding for text %d after %d retries", i, max_retries)
        out.append(emb)
    if n_failed == len(texts):
        raise RuntimeError("Failed to compute any Ollama embeddings")
    if n_failed:
        logger.warning("ollama: zero-filling %d/%d failed embeddings", n_failed, len(texts))
    dim = len(next(e for e in out if e is not None))
    if any(e is not None and len(e) != dim for e in out):
        raise RuntimeError("Ollama returned inconsistent embedding dimensions")
    emb = np.asarray([e if e is not None else [0.0] * dim for e in out], dtype=np.float32)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def _gemini_embeddings(texts: List[str], model_name: str) -> np.ndarray:
    import os

    try:
        from google import genai
    except ImportError as e:
        raise RuntimeError("google-genai package not available") from e
    client = genai.Client(api_key=os.environ.get("GEMINI_API_KEY"))
    resp = client.models.embed_content(model=model_name, contents=list(texts))
    return np.asarray([e.values for e in resp.embeddings], dtype=np.float32)
