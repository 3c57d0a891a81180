"""Embedding computation dispatch.

Counterpart of the JAX package's ``embeddings/compute.py``, with two modes:

* the in-process encoder (``tpu``, the mode name every index's meta.json
  carries for "in-process encoder", and its aliases
  ``sentence-transformers``, ``mlx``, ``hf``, ``jax``) — ``encoder.py`` on
  the given device;
* ``simulated`` — deterministic bag-of-hashed-words embeddings, no model.

The HTTP modes (openai / ollama / gemini) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

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
    elif mode in ("openai", "ollama", "gemini"):
        raise NotImplementedError(f"embedding mode {mode!r} is not ported to leann_torch yet")
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
