"""Transformer text encoder in PyTorch (the recompute engine).

Counterpart of the JAX package's ``embeddings/encoder.py``: the same model
registry, the same seeded weights (drawn through ``seeded.py``, a numpy
re-implementation of jax.random's threefry), the same forward numerics and
the same length/batch bucketing, so an index built by either package is
searched with identical embeddings by the other.

Numerics, each kept on purpose:
  * the matrix products take bf16-rounded operands and accumulate in f32,
    which is what ``preferred_element_type=f32`` on bf16 inputs computes;
    the attention scores (f32 q and k, as in the JAX package) and every
    product at ``compute_dtype="float32"`` take their operands in full. All
    go through :func:`~leann_torch.device.matmul`, so no precision flag of
    the caller's changes them;
  * LayerNorm eps is 1e-6, the prenorm arch uses tanh-GELU, the bert arch
    erf-GELU;
  * attention is written out, masked with ``finfo(float32).min``, with the
    softmax and the mean pooling in f32.

Parameters are a plain dict of tensors with the JAX package's tree layout,
so :func:`params_from_jax` is a leaf-by-leaf conversion.

A local BERT-family checkpoint directory loads through
:func:`load_hf_weights`, which reads ``config.json`` and the weights
(``model.safetensors`` parsed here, or ``pytorch_model.bin`` through
``torch.load``) without ``transformers`` or ``safetensors``;
:func:`save_hf_weights` writes one that ``transformers`` loads. Such an
encoder is calibrated on the corpus it indexes (:meth:`TorchEncoder.calibrate`).
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import matmul, resolve_device
from ..parallel.mesh import psum
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
    """numpy/array-like or tensor leaves -> f32 tensors on ``device`` (same
    tree)."""
    dev = torch.device(device)

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(dev, torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return _tree_map(leaf, tree)


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
    """The operand a product at ``dtype`` sees: x rounded to bf16 (or f16,
    widened back to f32, which bf16 products do not take), or x itself at
    float32."""
    if dtype == torch.float32:
        return x
    return x.to(dtype) if dtype == torch.bfloat16 else x.to(dtype).float()


def _layer_norm(x, p, eps=1e-6):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _project(x, w, dtype):
    return matmul(_round(x, dtype), _round(w, dtype))


def _dense(x, p, dtype):
    return _project(x, p["w"], dtype) + p["b"]


def _attention(x, mask, layer, cfg: EncoderConfig, dtype):
    """Multi-head self-attention of x [B, T, D] over ``cfg.n_heads`` heads
    of ``cfg.head_dim``, projected back by ``layer["o"]["w"]`` without its
    bias (a tensor-parallel shard passes its own heads: the q / k / v
    columns and o rows it holds)."""
    B, T = x.shape[:2]
    H, hd = cfg.n_heads, cfg.head_dim
    q = _dense(x, layer["q"], dtype).reshape(B, T, H, hd).transpose(1, 2)  # [B, H, T, hd]
    k = _dense(x, layer["k"], dtype).reshape(B, T, H, hd).transpose(1, 2)
    v = _dense(x, layer["v"], dtype).reshape(B, T, H, hd).transpose(1, 2)
    scores = matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)  # [B, H, T, S] f32
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(~(mask[:, None, None, :] > 0), neg)
    probs = torch.softmax(scores, dim=-1)
    ctx = matmul(_round(probs, dtype), _round(v, dtype))  # [B, H, T, hd]
    return _project(ctx.transpose(1, 2).reshape(B, T, H * hd), layer["o"]["w"], dtype)


def encode_tokens(params: Dict, ids: torch.Tensor, mask: torch.Tensor, cfg: EncoderConfig,
                  tp: Optional[Sequence[Tuple[Dict, torch.device]]] = None) -> torch.Tensor:
    """(params, ids[B,T] int, mask[B,T] int) -> pooled embeddings [B, D] f32.

    ``tp``: each layer's attention heads and MLP columns split over
    tensor-parallel shards, as (shard j's params, its device) pairs
    (``parallel/train.py``): shard j computes its heads' attention and its
    slice of the MLP, and the shards' partial o / fc2 projections are summed
    (``parallel/mesh.psum``) on the device of ``params``, where the
    residual stream, the LayerNorms and the pooling run. None: one shard,
    ``params`` itself."""
    dtype = _DTYPES[cfg.compute_dtype]
    B, T = ids.shape
    ids = ids.long()  # token stores keep u16 rows; widen before the gather
    x = params["tok_emb"][ids] + params["pos_emb"][:T][None, :, :]
    dev = x.device
    shards = [(params, mask)] if tp is None else [(p, mask.to(d)) for p, d in tp]
    shard_cfg = cfg if tp is None else replace(cfg, n_heads=cfg.n_heads // len(tp), dim=cfg.dim // len(tp))
    # HF BERT checkpoints use exact (erf) gelu; the seeded prenorm models tanh
    gelu = "tanh" if cfg.arch == "prenorm" else "none"

    def attention(x, i):
        parts = [_attention(x.to(m.device), m, p["layers"][i], shard_cfg, dtype) for p, m in shards]
        return psum(parts, dev) + params["layers"][i]["o"]["b"]

    def mlp(x, i):
        parts = []
        for p, m in shards:
            h = _dense(x.to(m.device), p["layers"][i]["fc1"], dtype)
            parts.append(_project(torch.nn.functional.gelu(h, approximate=gelu), p["layers"][i]["fc2"]["w"], dtype))
        return psum(parts, dev) + params["layers"][i]["fc2"]["b"]

    if cfg.arch == "bert":
        x = _layer_norm(x, params["emb_ln"])
    for i, layer in enumerate(params["layers"]):
        if cfg.arch == "prenorm":
            x = x + attention(_layer_norm(x, layer["ln1"]), i)
            x = x + mlp(_layer_norm(x, layer["ln2"]), i)
        else:  # bert post-LN
            x = _layer_norm(x + attention(x, i), layer["ln1"])
            x = _layer_norm(x + mlp(x, i), layer["ln2"])
    if cfg.arch == "prenorm":
        x = _layer_norm(x, params["final_ln"])
    # masked mean pooling in f32 (sentence-transformers-style)
    m = mask.float()[:, :, None]
    pooled = (x.float() * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    if cfg.center and "out_center" in params:
        pooled = pooled - params["out_center"]
        if "out_pc" in params:
            pc = params["out_pc"]  # [D, k] corpus-calibrated top directions
            pooled = pooled - matmul(matmul(pooled, pc), pc.T)
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
    """Batched text encoder with the JAX package's length/batch bucketing.

    ``model_name`` is a registry name (seeded weights) or a local BERT-family
    checkpoint directory (:func:`load_hf_weights`; a directory that cannot be
    read warns and falls back to seeded weights, as in the JAX package).
    ``params=`` supplies the weights instead."""

    def __init__(self, model_name: str, max_length: Optional[int] = None, device: "str | torch.device" = "cuda",
                 params: Optional[Dict] = None):
        self.device = resolve_device(device)
        self.cfg = resolve_config(model_name)
        if max_length is not None and max_length != self.cfg.max_len:
            self.cfg = replace(self.cfg, max_len=max_length)
        self.model_name = model_name
        self.loaded_hf = False  # set by _load_or_init on a local-checkpoint load
        if params is not None:
            self.params = params_to_torch(params, self.device)
            # the tokenizer's id space comes from the supplied embedding
            # table, not the name-resolved placeholder config
            rows = int(self.params["tok_emb"].shape[0]) if "tok_emb" in self.params else self.cfg.vocab_size
            if rows != self.cfg.vocab_size:
                self.cfg = replace(self.cfg, vocab_size=rows)
        else:
            self.params = self._load_or_init(model_name)
        # after the load: a checkpoint's config replaces the placeholder's
        # vocab size, which the hash tokenizer's ids must stay under
        self.tokenizer = get_tokenizer(model_name, vocab_size=self.cfg.vocab_size, max_length=self.cfg.max_len)

    def _load_or_init(self, model_name: str) -> Dict:
        if os.path.isdir(model_name):
            try:
                tree, cfg = load_hf_weights(model_name)
            except Exception as e:  # the JAX package's rule: warn, then seeded weights
                logger.warning("could not load HF weights from %s (%s); seeded init", model_name, e)
            else:
                self.cfg = replace(cfg, max_len=self.cfg.max_len)
                params = params_to_torch(tree, self.device)
                if self.cfg.center:
                    params["out_center"] = _compute_out_center(params, self.cfg)
                self.loaded_hf = True
                logger.info("loaded local HF weights from %s", model_name)
                return params
        params = params_to_torch(init_params(self.cfg), self.device)
        if self.cfg.center:
            params["out_center"] = _compute_out_center(params, self.cfg)
        return params

    @property
    def needs_corpus_calibration(self) -> bool:
        """A loaded checkpoint is calibrated on the corpus it indexes: the
        seeded-probe center of the hash-* models does not fit a real
        checkpoint's text distribution, and the mean alone leaves
        BERT-family outputs near-collinear."""
        return self.loaded_hf and self.cfg.center

    @torch.no_grad()
    def calibrate(self, texts: Sequence[str], n_components: int = 8) -> Dict[str, np.ndarray]:
        """Corpus calibration, as the JAX package's: the mean and the top
        principal directions of the RAW pooled outputs (no centering, no
        normalization) of the first 256 texts, tokenized at the full
        ``max_len`` in batches of 128, with the SVD in float64 on the host
        (all-but-the-top, Mu & Viswanath 2018). Sets them on this encoder
        and returns ``{out_center, out_pc}`` for ``<prefix>.calib.npz``."""
        sample = list(texts[:256])
        raw_cfg = replace(self.cfg, center=False, normalize=False)
        out = []
        for s in range(0, len(sample), 128):
            ids, mask = self.tokenize(sample[s : s + 128])
            out.append(encode_tokens(self.params, torch.from_numpy(ids).to(self.device),
                                     torch.from_numpy(mask).to(self.device), raw_cfg).cpu().numpy())
        pooled = np.concatenate(out).astype(np.float64)
        mean = pooled.mean(axis=0)
        k = max(0, min(n_components, pooled.shape[0] - 1, self.cfg.dim - 1))
        _, svals, vt = np.linalg.svd(pooled - mean, full_matrices=False)
        calib = {"out_center": mean.astype(np.float32),
                 "out_pc": np.ascontiguousarray(vt[:k].T).astype(np.float32)}  # [D, k]
        self.apply_calibration(calib)
        logger.info("corpus calibration: %d samples, removed the mean + %d PCs (top sv %.2f / residual %.2f)",
                    len(sample), k, float(svals[0]) if k else 0.0,
                    float(svals[k:].mean()) if k < len(svals) else 0.0)
        return calib

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

    @torch.no_grad()
    def encode_token_batch(self, ids, mask) -> torch.Tensor:
        """Token rows ids [B, T] and mask [B, T] (numpy or tensors) -> pooled
        embeddings f32 [B, D] on the encoder's device (the JAX package's
        returns a host array)."""
        return encode_tokens(self.params, torch.as_tensor(ids).to(self.device),
                             torch.as_tensor(mask).to(self.device), self.cfg)

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
            out[start : start + len(chunk)] = self.encode_token_batch(ids, mask)[: len(chunk)]
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Local HF BERT checkpoints
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}
_ST_SKIPPED = ("I64", "I32", "I16", "I8", "U64", "U32", "U16", "U8", "BOOL")


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: f32 array}, parsed here: an 8-byte
    little-endian header length, a JSON header of ``dtype`` / ``shape`` /
    ``data_offsets`` per tensor (``__metadata__`` skipped), then the data.
    F32, F16 and BF16 tensors are widened to f32; integer and boolean ones
    (buffers such as ``embeddings.position_ids``; no weight is one) are
    skipped; another dtype raises."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = int(raw[:8].view("<u8")[0])
    header = json.loads(bytes(raw[8 : 8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] in _ST_SKIPPED:
            continue
        dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}; F32, F16 and BF16 are read")
        lo, hi = info["data_offsets"]
        a = raw[base + lo : base + hi].view(np.dtype(dt).newbyteorder("<")).reshape(info["shape"])
        if info["dtype"] == "BF16":  # the high half of an f32
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = np.array(a, np.float32)
    return out


def write_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """{name: array} -> a ``.safetensors`` file of F32 tensors (contiguous
    data in the header's order, the header padded with spaces to 8 bytes,
    ``__metadata__`` {"format": "pt"}), written whole and renamed into
    place."""
    header: Dict[str, object] = {"__metadata__": {"format": "pt"}}
    arrays, off = [], 0
    for name, a in tensors.items():
        a = np.ascontiguousarray(a, dtype="<f4")
        header[name] = {"dtype": "F32", "shape": list(a.shape), "data_offsets": [off, off + a.nbytes]}
        arrays.append(a)
        off += a.nbytes
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hb += b" " * (-len(hb) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(np.uint64(len(hb)).astype("<u8").tobytes())
        f.write(hb)
        for a in arrays:
            f.write(a.tobytes())
    os.replace(tmp, path)


# the base model's key prefix in a checkpoint saved from a head
# (``base_model_prefix``), by ``model_type``; ``bert.`` for any other type
_BASE_PREFIX = {"roberta": "roberta.", "xlm-roberta": "roberta.", "camembert": "roberta.", "electra": "electra."}


def _read_state_dict(path: str, model_type: str = "bert") -> Dict[str, np.ndarray]:
    """A checkpoint directory's weights -> {base model key: f32 array}, as
    ``AutoModel`` reads them: in a checkpoint saved from a head
    (``BertForMaskedLM``, ``RobertaForMaskedLM``) the base model's prefix is
    stripped (``bert.``; ``roberta.`` for ``roberta``, ``xlm-roberta`` and
    ``camembert``; ``electra.`` for ``electra``) and the head's own tensors
    (``lm_head.*``, ``cls.*``, ``discriminator_predictions.*``,
    ``generator_*``) are dropped; the pooler, which masked-mean pooling never
    reads, is dropped too; LayerNorm's old ``gamma`` / ``beta`` names are
    renamed. An ELECTRA whose ``embedding_size`` differs from its hidden size
    (an ``embeddings_project`` between them) raises: the encoder has no such
    projection, and the JAX package's loader cannot run one either."""
    st = os.path.join(path, "model.safetensors")
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st):
        sd = read_safetensors(st)
    elif os.path.exists(bin_path):
        sd = {k: v.detach().to(torch.float32).numpy()
              for k, v in torch.load(bin_path, map_location="cpu", weights_only=True).items()
              if isinstance(v, torch.Tensor) and v.is_floating_point()}
    else:
        raise FileNotFoundError(f"{path} holds neither model.safetensors nor pytorch_model.bin")
    prefix = _BASE_PREFIX.get(model_type, "bert.")
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if any(k.startswith("embeddings_project.") for k in sd):
        raise ValueError(f"{path}: an ELECTRA checkpoint with embeddings_project (embedding_size != hidden_size); "
                         "the encoder has no projection between the embeddings and the first layer")
    out = {}
    for k, v in sd.items():
        if k.startswith("pooler."):
            continue
        if k.endswith(".gamma"):
            k = k[: -len("gamma")] + "weight"
        elif k.endswith(".beta"):
            k = k[: -len("beta")] + "bias"
        out[k] = v
    return out


def load_hf_weights(path: str) -> Tuple[Dict, EncoderConfig]:
    """A local HF BERT-family checkpoint directory -> (param tree of numpy f32
    leaves, config). The same tree as the JAX package's loader: the same
    leaf names, dense weights transposed to [in, out], ``token_type`` row 0
    folded into ``tok_emb``, ``pos_emb`` cut to the config's ``max_len``
    (``max_position_embeddings``, at most 512), an identity ``final_ln``
    (unused by the bert arch)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = EncoderConfig(
        name=path,
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        mlp_dim=hf["intermediate_size"],
        max_len=min(hf.get("max_position_embeddings", 512), 512),
        arch="bert",
        normalize=True,
        center=True,  # all-but-the-top for checkpoints too (calibrate)
    )
    sd = _read_state_dict(path, hf.get("model_type", "bert"))

    def dense(prefix):
        return {"w": np.ascontiguousarray(sd[prefix + ".weight"].T), "b": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    tok = sd["embeddings.word_embeddings.weight"]
    if "embeddings.token_type_embeddings.weight" in sd:
        tok = tok + sd["embeddings.token_type_embeddings.weight"][0][None, :]
    params = {
        "tok_emb": tok,
        "pos_emb": np.ascontiguousarray(sd["embeddings.position_embeddings.weight"][: cfg.max_len]),
        "emb_ln": ln("embeddings.LayerNorm"),
        "final_ln": _ln_init(cfg.dim),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}"
        params["layers"].append({
            "q": dense(f"{p}.attention.self.query"),
            "k": dense(f"{p}.attention.self.key"),
            "v": dense(f"{p}.attention.self.value"),
            "o": dense(f"{p}.attention.output.dense"),
            "ln1": ln(f"{p}.attention.output.LayerNorm"),
            "fc1": dense(f"{p}.intermediate.dense"),
            "fc2": dense(f"{p}.output.dense"),
            "ln2": ln(f"{p}.output.LayerNorm"),
        })
    return params, cfg


_HF_NAMES = (("q", "attention.self.query"), ("k", "attention.self.key"), ("v", "attention.self.value"),
             ("o", "attention.output.dense"), ("fc1", "intermediate.dense"), ("fc2", "output.dense"))
_HF_LN_NAMES = (("ln1", "attention.output.LayerNorm"), ("ln2", "output.LayerNorm"))


def save_hf_weights(params: Dict, cfg: EncoderConfig, path: str) -> None:
    """Write a param tree as a local HF BERT checkpoint (``config.json`` with
    ``BertConfig``'s fields and ``model.safetensors`` with ``BertModel``'s
    key names), the inverse of :func:`load_hf_weights`: the token-type rows
    are zero (the loader folds row 0 into ``tok_emb``) and the pooler, which
    masked-mean pooling never reads, is seeded. Leaves may be numpy arrays or
    tensors. ``transformers`` is not needed."""
    def a(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    os.makedirs(path, exist_ok=True)
    d = cfg.dim
    n_pos = int(a(params["pos_emb"]).shape[0])
    sd = {
        "embeddings.word_embeddings.weight": a(params["tok_emb"]),
        "embeddings.position_embeddings.weight": a(params["pos_emb"]),
        "embeddings.token_type_embeddings.weight": np.zeros((2, d), np.float32),
        "embeddings.LayerNorm.weight": a(params["emb_ln"]["scale"]),
        "embeddings.LayerNorm.bias": a(params["emb_ln"]["bias"]),
    }
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}"
        for ours, theirs in _HF_NAMES:
            sd[f"{p}.{theirs}.weight"] = a(layer[ours]["w"]).T
            sd[f"{p}.{theirs}.bias"] = a(layer[ours]["b"])
        for ours, theirs in _HF_LN_NAMES:
            sd[f"{p}.{theirs}.weight"] = a(layer[ours]["scale"])
            sd[f"{p}.{theirs}.bias"] = a(layer[ours]["bias"])
    sd["pooler.dense.weight"] = np.random.default_rng(0).standard_normal((d, d)).astype(np.float32) * 0.02
    sd["pooler.dense.bias"] = np.zeros((d,), np.float32)
    config = {
        "architectures": ["BertModel"],
        "attention_probs_dropout_prob": 0.0,
        "classifier_dropout": None,
        "hidden_act": "gelu",
        "hidden_dropout_prob": 0.0,
        "hidden_size": d,
        "initializer_range": 0.02,
        "intermediate_size": cfg.mlp_dim,
        "layer_norm_eps": 1e-12,
        "max_position_embeddings": n_pos,
        "model_type": "bert",
        "num_attention_heads": cfg.n_heads,
        "num_hidden_layers": len(params["layers"]),
        "pad_token_id": 0,
        "position_embedding_type": "absolute",
        "torch_dtype": "float32",
        "type_vocab_size": 2,
        "use_cache": True,
        "vocab_size": int(sd["embeddings.word_embeddings.weight"].shape[0]),
    }
    write_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)


_ENCODER_CACHE: Dict[Tuple[str, Optional[int], str], TorchEncoder] = {}


def get_encoder(model_name: str, max_length: Optional[int] = None,
                device: "str | torch.device" = "cuda") -> TorchEncoder:
    dev = resolve_device(device)
    key = (model_name, max_length, str(dev))
    if key not in _ENCODER_CACHE:
        _ENCODER_CACHE[key] = TorchEncoder(model_name, max_length=max_length, device=dev)
    return _ENCODER_CACHE[key]
