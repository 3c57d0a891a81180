"""Transformer text encoder in PyTorch (the recompute engine).

Counterpart of the JAX package's ``embeddings/encoder.py``: the same model
registry, the same seeded weights (drawn through ``seeded.py``, a numpy
re-implementation of jax.random's threefry), the same forward numerics and
the same length/batch bucketing, so an index built by either package is
searched with identical embeddings by the other.

Numerics, each kept on purpose:
  * the matrix products take bf16-rounded operands and accumulate in f32
    (operands are rounded to bf16, widened back and multiplied in f32, which
    is what ``preferred_element_type=f32`` on bf16 inputs computes);
  * LayerNorm eps is 1e-6, the prenorm arch uses tanh-GELU, the bert arch
    erf-GELU;
  * attention is written out, masked with ``finfo(float32).min``, with the
    softmax and the mean pooling in f32.

Parameters are a plain dict of tensors with the JAX package's tree layout,
so :func:`params_from_jax` is a leaf-by-leaf conversion.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import seeded
from .tokenizer import get_tokenizer, stable_hash

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class EncoderConfig:
    name: str = "hash-minilm"
    vocab_size: int = 32768
    dim: int = 384
    n_layers: int = 6
    n_heads: int = 6
    mlp_dim: int = 1536
    max_len: int = 256
    arch: str = "prenorm"  # "prenorm" (seeded) | "bert" (HF post-LN weights)
    normalize: bool = True  # L2-normalize pooled output (cosine-ready)
    center: bool = False  # subtract the model's mean output direction (hash-*)
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# hash-* models are seeded random transformers; `center` subtracts the
# model's mean output over a seeded probe set so their outputs have the
# geometry of trained sentence encoders (random pairs otherwise sit at cos
# ~0.7 and every margin collapses into ties).
MODEL_REGISTRY: Dict[str, EncoderConfig] = {
    "hash-tiny": EncoderConfig("hash-tiny", vocab_size=2048, dim=64, n_layers=2, n_heads=2, mlp_dim=128, max_len=128, center=True),
    "hash-minilm": EncoderConfig("hash-minilm", center=True),
    "hash-contriever": EncoderConfig(
        "hash-contriever", dim=768, n_layers=12, n_heads=12, mlp_dim=3072, normalize=False, center=True
    ),
}
_ALIASES = {
    "sentence-transformers/all-MiniLM-L6-v2": "hash-minilm",
    "all-MiniLM-L6-v2": "hash-minilm",
    "facebook/contriever-msmarco": "hash-contriever",
    "facebook/contriever": "hash-contriever",
}


def resolve_config(model_name: str) -> EncoderConfig:
    name = _ALIASES.get(model_name, model_name)
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if not os.path.isdir(model_name):
        logger.warning("unknown embedding model %r; using hash-minilm architecture", model_name)
    return replace(MODEL_REGISTRY["hash-minilm"], name=model_name)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _dense_init(key, d_in, d_out, std=0.02):
    kw = seeded.split(key)[0]
    return {
        "w": seeded.normal(kw, (d_in, d_out)) * np.float32(std),
        "b": np.zeros((d_out,), np.float32),
    }


def _ln_init(dim):
    return {"scale": np.ones((dim,), np.float32), "bias": np.zeros((dim,), np.float32)}


def init_params(cfg: EncoderConfig) -> Dict:
    """Deterministic params from the model name, as numpy f32 leaves; the
    same draws as the JAX package's ``init_params``."""
    key = seeded.prng_key(stable_hash(cfg.name) % (2**31))
    keys = seeded.split(key, 2 + cfg.n_layers)
    d, f = cfg.dim, cfg.mlp_dim
    params = {
        "tok_emb": seeded.normal(keys[0], (cfg.vocab_size, d)) * np.float32(0.02),
        "pos_emb": seeded.normal(keys[1], (cfg.max_len, d)) * np.float32(0.02),
        "emb_ln": _ln_init(d),
        "final_ln": _ln_init(d),
        "layers": [],
    }
    # residual-branch output projections scaled down for stable depth
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    for i in range(cfg.n_layers):
        k = seeded.split(keys[2 + i], 6)
        params["layers"].append(
            {
                "ln1": _ln_init(d),
                "ln2": _ln_init(d),
                "q": _dense_init(k[0], d, d),
                "k": _dense_init(k[1], d, d),
                "v": _dense_init(k[2], d, d),
                "o": _dense_init(k[3], d, d, std=out_std),
                "fc1": _dense_init(k[4], d, f),
                "fc2": _dense_init(k[5], f, d, std=out_std),
            }
        )
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_to_torch(tree, device: "str | torch.device" = "cuda") -> Dict:
    """numpy/array-like leaves -> f32 tensors on ``device`` (same tree)."""
    dev = torch.device(device)
    return _tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), tree)


def params_from_jax(tree, device: "str | torch.device" = "cuda") -> Dict:
    """A JAX-package param tree (leaves given as numpy arrays) -> this
    package's params. The layouts are the same: dense weights are [in, out]
    and every leaf keeps its name."""
    return params_to_torch(tree, resolve_device(device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype`` and widen back: the operand a bf16 product sees."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _layer_norm(x, p, eps=1e-6):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x, p, dtype):
    return _round(x, dtype) @ _round(p["w"], dtype) + p["b"]


def _attention(x, mask, layer, cfg: EncoderConfig, dtype):
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = _dense(x, layer["q"], dtype).reshape(B, T, H, hd).transpose(1, 2)  # [B, H, T, hd]
    k = _dense(x, layer["k"], dtype).reshape(B, T, H, hd).transpose(1, 2)
    v = _dense(x, layer["v"], dtype).reshape(B, T, H, hd).transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)  # [B, H, T, S] f32
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(~(mask[:, None, None, :] > 0), neg)
    probs = torch.softmax(scores, dim=-1)
    ctx = _round(probs, dtype) @ _round(v, dtype)  # [B, H, T, hd]
    return _dense(ctx.transpose(1, 2).reshape(B, T, D), layer["o"], dtype)


def encode_tokens(params: Dict, ids: torch.Tensor, mask: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """(params, ids[B,T] int, mask[B,T] int) -> pooled embeddings [B, D] f32."""
    dtype = _DTYPES[cfg.compute_dtype]
    B, T = ids.shape
    ids = ids.long()  # token stores keep u16 rows; widen before the gather
    x = params["tok_emb"][ids] + params["pos_emb"][:T][None, :, :]
    # HF BERT checkpoints use exact (erf) gelu; the seeded prenorm models tanh
    gelu = "tanh" if cfg.arch == "prenorm" else "none"
    if cfg.arch == "bert":
        x = _layer_norm(x, params["emb_ln"])
    for layer in params["layers"]:
        if cfg.arch == "prenorm":
            x = x + _attention(_layer_norm(x, layer["ln1"]), mask, layer, cfg, dtype)
            h = _dense(_layer_norm(x, layer["ln2"]), layer["fc1"], dtype)
            x = x + _dense(torch.nn.functional.gelu(h, approximate=gelu), layer["fc2"], dtype)
        else:  # bert post-LN
            x = _layer_norm(x + _attention(x, mask, layer, cfg, dtype), layer["ln1"])
            h = _dense(x, layer["fc1"], dtype)
            x = _layer_norm(x + _dense(torch.nn.functional.gelu(h, approximate=gelu), layer["fc2"], dtype),
                            layer["ln2"])
    if cfg.arch == "prenorm":
        x = _layer_norm(x, params["final_ln"])
    # masked mean pooling in f32 (sentence-transformers-style)
    m = mask.float()[:, :, None]
    pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    if cfg.center and "out_center" in params:
        pooled = pooled - params["out_center"]
        if "out_pc" in params:
            pc = params["out_pc"]  # [D, k] corpus-calibrated top directions
            pooled = pooled - (pooled @ pc) @ pc.T
    if cfg.normalize:
        pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return pooled


# ---------------------------------------------------------------------------
# High-level encoder object
# ---------------------------------------------------------------------------


def _round_up_pow2(n: int, lo: int, hi: int) -> int:
    v = lo
    while v < n and v < hi:
        v *= 2
    return min(v, hi)


def _compute_out_center(params: Dict, cfg: EncoderConfig) -> torch.Tensor:
    """Mean pooled output over a seeded probe set — the model's anisotropy
    direction. The probe ids are the JAX package's (same threefry draws)."""
    key = seeded.prng_key(stable_hash(cfg.name + "/center") % (2**31))
    t = min(32, cfg.max_len)
    dev = params["tok_emb"].device
    ids = torch.as_tensor(seeded.randint(key, (256, t), 0, cfg.vocab_size)).to(dev)
    mask = torch.ones((256, t), dtype=torch.int32, device=dev)
    raw_cfg = replace(cfg, center=False, normalize=False)
    with torch.no_grad():
        return encode_tokens(params, ids, mask, raw_cfg).mean(dim=0)


class TorchEncoder:
    """Batched text encoder with the JAX package's length/batch bucketing."""

    def __init__(self, model_name: str, max_length: Optional[int] = None, device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.cfg = resolve_config(model_name)
        if max_length is not None and max_length != self.cfg.max_len:
            self.cfg = replace(self.cfg, max_len=max_length)
        self.model_name = model_name
        if os.path.isdir(model_name):
            raise NotImplementedError(
                "local HF checkpoints are not ported to leann_torch yet (ROADMAP.md, left for later #7)")
        self.params = params_to_torch(init_params(self.cfg), self.device)
        if self.cfg.center:
            self.params["out_center"] = _compute_out_center(self.params, self.cfg)
        self.tokenizer = get_tokenizer(model_name, vocab_size=self.cfg.vocab_size, max_length=self.cfg.max_len)

    def apply_calibration(self, calib: Dict[str, np.ndarray]) -> None:
        self.params = dict(self.params)
        for k in ("out_center", "out_pc"):
            self.params[k] = torch.from_numpy(np.array(calib[k], np.float32)).to(self.device)

    def with_calibration(self, calib: Dict[str, np.ndarray]) -> "TorchEncoder":
        """A calibrated COPY sharing weights; the process-wide cache stays
        pristine."""
        import copy

        enc = copy.copy(self)
        enc.apply_calibration(calib)
        return enc

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def tokenize(self, texts: Sequence[str], max_length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        return self.tokenizer.encode_batch(texts, max_length or self.cfg.max_len)

    def encode(self, texts: Sequence[str], batch_size: int = 128) -> np.ndarray:
        """Encode texts -> [N, D] float32 (host), bucketing T to a power of
        two >= 16 and B to a power of two >= 8. The output stays on the
        device until the end, so the host tokenizes the next batch while the
        device encodes this one."""
        out = torch.empty((len(texts), self.cfg.dim), dtype=torch.float32, device=self.device)
        for start in range(0, len(texts), batch_size):
            chunk = texts[start : start + batch_size]
            ids, mask = self.tokenize(chunk)
            real = int(mask.sum(axis=1).max()) if len(chunk) else 0
            T = _round_up_pow2(max(real, 1), 16, self.cfg.max_len)
            ids, mask = ids[:, :T], mask[:, :T]
            B = _round_up_pow2(len(chunk), 8, batch_size)
            if B > len(chunk):
                pad = B - len(chunk)
                ids = np.concatenate([ids, np.zeros((pad, T), np.int32)])
                mask = np.concatenate([mask, np.zeros((pad, T), np.int32)])
                mask[len(chunk):, 0] = 1  # avoid 0/0 in pooling
            with torch.no_grad():
                emb = encode_tokens(self.params, torch.from_numpy(ids).to(self.device),
                                    torch.from_numpy(mask).to(self.device), self.cfg)
            out[start : start + len(chunk)] = emb[: len(chunk)]
        return out.cpu().numpy()


_ENCODER_CACHE: Dict[Tuple[str, Optional[int], str], TorchEncoder] = {}


def get_encoder(model_name: str, max_length: Optional[int] = None,
                device: "str | torch.device" = "cuda") -> TorchEncoder:
    dev = resolve_device(device)
    key = (model_name, max_length, str(dev))
    if key not in _ENCODER_CACHE:
        _ENCODER_CACHE[key] = TorchEncoder(model_name, max_length=max_length, device=dev)
    return _ENCODER_CACHE[key]
