"""Compact on-disk encodings for index artifacts.

A copy of the JAX package's ``storage.py`` (the two packages write the same
index); only ``derive_token_cache`` differs, taking this package's encoder
on a given device. The encodings:

* **neighbors** — rows are neighbor *sets* (traversal gathers whole rows, the
  -1 padding is masked), so each row is sorted ascending, delta-encoded, and
  the four little-endian byte planes are deflated separately. A uniform
  random R=32 graph at N=2.1M compresses to ~1.8 B/edge (near the entropy
  floor of sorted-uniform deltas, ~2.2 B) vs 4 B raw i32.
* **ids** — the default positional id list ("0".."N-1") collapses to
  ``{"format": "seq", "n": N}`` (22 MB of JSON at 2.1M → 30 bytes).
* **partition** — after the LDG contiguity relayout the assignment is a step
  function; store per-partition counts, not i32[N].
* **tokens** — the token matrix is a deterministic function of
  passages.jsonl + the tokenizer, so it is a *cache*, not index state: it
  lives in ``<prefix>.tokens.cache.np[yz]`` (excluded from all-in index
  accounting) and is re-derived at load when absent.

Everything is format-versioned by key presence: readers accept both the
packed and the legacy raw forms, so pre-existing indexes keep working.
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# raw token stores above this go to .npy (memmapped at load) instead of npz
RAW_TOKEN_STORE_BYTES = 1 << 30


# --------------------------------------------------------------------------
# neighbor rows: sorted-delta byte-plane deflate
# --------------------------------------------------------------------------

def pack_neighbors(nbr: np.ndarray, level: int = 6) -> dict:
    """[N, R] i32 neighbor rows (−1 padded) → npz-payload dict.

    Rows are SORTED (they are sets to every consumer: beam expansion, LDG
    partitioning, insert repair all mask the padding and ignore order), the
    padding is re-mapped to N (keeps deltas small and is unambiguous: real
    ids are < N), rows are delta-encoded, and the i32 byte planes are
    deflated separately (the high planes of small deltas are almost all
    zeros, which deflate removes entirely).
    """
    n, r = nbr.shape
    s = np.sort(np.where(nbr >= 0, nbr, n).astype(np.int32), axis=1)
    d = np.empty_like(s)
    d[:, 0] = s[:, 0]
    d[:, 1:] = s[:, 1:] - s[:, :-1]
    planes = np.ascontiguousarray(d.view(np.uint8).reshape(n, r, 4).transpose(2, 0, 1))
    comp = zlib.compress(planes.tobytes(), level)
    return {
        "neighbors_packed": np.frombuffer(comp, np.uint8),
        "neighbors_n": np.int64(n),
        "neighbors_r": np.int64(r),
    }


def unpack_neighbors(z) -> np.ndarray:
    """Inverse of :func:`pack_neighbors` from an npz (or dict); falls back to
    the legacy raw ``neighbors`` key. Returns i32[N, R], −1 padded, rows
    sorted ascending."""
    if "neighbors_packed" not in z:
        return np.asarray(z["neighbors"])
    n = int(z["neighbors_n"])
    r = int(z["neighbors_r"])
    raw = zlib.decompress(np.asarray(z["neighbors_packed"]).tobytes())
    planes = np.frombuffer(raw, np.uint8).reshape(4, n, r)
    d = np.ascontiguousarray(planes.transpose(1, 2, 0)).view(np.int32).reshape(n, r)
    s = np.cumsum(d, axis=1, dtype=np.int32)
    return np.where(s >= n, -1, s)


# --------------------------------------------------------------------------
# id list
# --------------------------------------------------------------------------

def save_ids(index_path: str, ids: List[str]) -> None:
    ids = list(ids)
    n = len(ids)
    seq = all(x == str(i) for i, x in enumerate(ids))
    perm = None
    if not seq and n:
        # permutation-of-seq (the locality relabel reorders rows of a
        # positional-id corpus): store the i32 array, not 10M JSON strings
        # (~90 MB at 10M vs 40 MB npy; a permutation is ~log2(N!) bits —
        # near-incompressible — so npy is the right container)
        try:
            arr = np.fromiter((int(x) for x in ids), np.int64, count=n)
            if arr.min() == 0 and arr.max() == n - 1 and \
                    np.array_equal(np.sort(arr), np.arange(n)):
                perm = arr.astype(np.int32)
        except ValueError:
            perm = None
    pnpy = f"{index_path}.ids.perm.npy"
    with open(f"{index_path}.ids.json", "w") as f:
        if seq:
            json.dump({"format": "seq", "n": n}, f)
        elif perm is not None:
            np.save(pnpy, perm)
            json.dump({"format": "perm", "n": n}, f)
        else:
            json.dump(ids, f)
    if perm is None and os.path.exists(pnpy):
        os.remove(pnpy)  # stale sidecar from a pre-relabel artifact


def load_ids(index_path: str) -> List[str]:
    path = f"{index_path}.ids.json"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        if data.get("format") == "seq":
            return [str(i) for i in range(int(data["n"]))]
        if data.get("format") == "perm":
            arr = np.load(f"{index_path}.ids.perm.npy")
            return [str(int(i)) for i in arr]
        raise ValueError(f"unknown ids format in {path}: {data.get('format')!r}")
    return data


# --------------------------------------------------------------------------
# partition assignment
# --------------------------------------------------------------------------

def save_partition(index_path: str, assign: np.ndarray) -> None:
    """Save a device-shard assignment. After the contiguity relayout the
    assignment is non-decreasing — store per-partition counts (a few ints).
    A non-sorted assignment (no relayout ran) falls back to the raw array."""
    assign = np.asarray(assign)
    if assign.size == 0 or np.all(assign[1:] >= assign[:-1]):
        n_parts = int(assign[-1]) + 1 if assign.size else 0
        counts = np.bincount(assign, minlength=n_parts).astype(np.int64)
        np.savez(f"{index_path}.partition.npz", counts=counts)
        legacy = f"{index_path}.partition.npy"
        if os.path.exists(legacy):
            os.remove(legacy)
    else:
        np.save(f"{index_path}.partition.npy", assign.astype(np.int32))


def load_partition(index_path: str, n: Optional[int] = None) -> Optional[np.ndarray]:
    """→ i32[N] assignment, or None when no partition artifact exists."""
    pz = f"{index_path}.partition.npz"
    if os.path.exists(pz):
        counts = np.load(pz)["counts"]
        return np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    py = f"{index_path}.partition.npy"
    if os.path.exists(py):
        return np.load(py).astype(np.int32)
    return None


# --------------------------------------------------------------------------
# token-store cache
# --------------------------------------------------------------------------

def token_cache_paths(index_path: str) -> dict:
    return {
        "raw": f"{index_path}.tokens.cache.npy",
        "raw_len": f"{index_path}.lengths.cache.npy",
        "npz": f"{index_path}.tokens.cache.npz",
        # at-rest archive (chunked zlib, ~0.47x measured on the 10M tier):
        # cold form for the disk-bounded 60M build lifecycle; inflated back
        # to the raw memmap on first load
        "archive": f"{index_path}.tokens.cache.zchunk.npz",
        # legacy (pre-cache) names, still readable
        "legacy_raw": f"{index_path}.tokens.npy",
        "legacy_raw_len": f"{index_path}.lengths.npy",
        "legacy_npz": f"{index_path}.tokens.npz",
    }


def drop_resume_keys(index_path: str, stores=("passages", "tokens.cache")) -> None:
    """Remove the build's resume sidecars (``<store>.done.json``) of
    ``stores`` before they are rewritten: by the build, or outside it (an
    insert appends to both, a relabel or a relayout moves the token rows;
    the passages are found by id and stay right). A later build on the
    same texts then rewrites them instead of keeping rows cut short,
    appended or in another order."""
    for store in stores:
        path = f"{index_path}.{store}.done.json"
        if os.path.exists(path):
            os.remove(path)


def archive_token_cache(index_path: str, level: int = 6,
                        chunk_rows: int = 1 << 17, remove_raw: bool = True) -> dict:
    """Compress a raw token store to its at-rest archive (~0.47x, measured
    zlib6 on the 10M tier) and optionally delete the raw npy — the disk-
    lifecycle tool for 60M-scale builds, where the 7.7 GB token store is not
    needed until serving. Chunked frames so inflation streams at fixed
    memory. -> {raw_bytes, archive_bytes}."""
    p = token_cache_paths(index_path)
    if not os.path.exists(p["raw"]):
        raise FileNotFoundError(f"no raw token store at {p['raw']}")
    tok = np.load(p["raw"], mmap_mode="r")
    frames = {
        "shape": np.asarray(tok.shape, np.int64),
        "dtype": np.frombuffer(str(tok.dtype).encode(), np.uint8),
        "chunk_rows": np.int64(chunk_rows),
        "lengths": np.load(p["raw_len"]).astype(np.int32),
    }
    for ci, s in enumerate(range(0, tok.shape[0], chunk_rows)):
        frames[f"c{ci:06d}"] = np.frombuffer(
            zlib.compress(np.ascontiguousarray(tok[s : s + chunk_rows]).tobytes(), level),
            np.uint8)
    tmp = p["archive"] + ".tmp.npz"
    np.savez(tmp, **frames)
    os.replace(tmp, p["archive"])
    raw_bytes = tok.nbytes
    del tok
    if remove_raw:
        os.remove(p["raw"])
        os.remove(p["raw_len"])
    out = {"raw_bytes": raw_bytes, "archive_bytes": os.path.getsize(p["archive"])}
    logger.info("token cache archived: %.2f -> %.2f GB",
                raw_bytes / 2**30, out["archive_bytes"] / 2**30)
    return out


def _inflate_token_archive(index_path: str) -> bool:
    """Archive -> raw npy + lengths (one-time at first load). True if done."""
    p = token_cache_paths(index_path)
    if not os.path.exists(p["archive"]):
        return False
    z = np.load(p["archive"])
    shape = tuple(int(x) for x in z["shape"])
    dtype = np.dtype(bytes(z["dtype"]).decode())
    chunk_rows = int(z["chunk_rows"])
    out = np.lib.format.open_memmap(p["raw"] + ".tmp", mode="w+",
                                    dtype=dtype, shape=shape)
    for ci, s in enumerate(range(0, shape[0], chunk_rows)):
        rows = min(chunk_rows, shape[0] - s)
        buf = zlib.decompress(np.asarray(z[f"c{ci:06d}"]).tobytes())
        out[s : s + rows] = np.frombuffer(buf, dtype).reshape(rows, shape[1])
    out.flush()
    del out
    os.replace(p["raw"] + ".tmp", p["raw"])
    np.save(p["raw_len"], np.asarray(z["lengths"], np.int32))
    logger.info("token archive inflated to raw store: %s rows", shape[0])
    return True


def write_token_cache(index_path: str, tok: np.ndarray, lengths: np.ndarray) -> None:
    p = token_cache_paths(index_path)
    if tok.nbytes > RAW_TOKEN_STORE_BYTES:
        # raw .npy above ~1 GB: np.load(mmap_mode='r') maps it instantly and
        # the host-deferred rerank gather touches only needed pages — an npz
        # would decompress the whole store (7.7 GB at 60M) on every searcher
        # construction
        np.save(p["raw"], tok)
        np.save(p["raw_len"], np.asarray(lengths, np.int32))
    else:
        np.savez_compressed(p["npz"], tokens=tok, lengths=np.asarray(lengths, np.int32))


def load_token_cache(index_path: str) -> "Tuple[np.ndarray, np.ndarray] | None":
    """Load the token matrix from cache or legacy store → (tokens, lengths),
    or None when neither exists. Raw stores come back memmapped."""
    p = token_cache_paths(index_path)
    if not os.path.exists(p["raw"]) and os.path.exists(p["archive"]):
        _inflate_token_archive(index_path)  # cold archive -> raw, one-time
    if os.path.exists(p["raw"]):
        return np.load(p["raw"], mmap_mode="r"), np.load(p["raw_len"]).astype(np.int32)
    if os.path.exists(p["npz"]):
        z = np.load(p["npz"])
        return z["tokens"], z["lengths"].astype(np.int32)
    if os.path.exists(p["legacy_raw"]):
        return np.load(p["legacy_raw"], mmap_mode="r"), np.load(p["legacy_raw_len"]).astype(np.int32)
    if os.path.exists(p["legacy_npz"]):
        z = np.load(p["legacy_npz"])
        return z["tokens"], z["lengths"].astype(np.int32)
    return None


def tokenize_corpus(texts: List[str], enc) -> "Tuple[np.ndarray, np.ndarray]":
    """Blockwise tokenize → (tok [N, T] u16|i32, lengths i32[N]). Sliced so
    the i32 ids+mask transient stays a few MB at any N (a one-shot tokenize
    of 20M × 64 holds ~10 GB)."""
    dtype = np.uint16 if enc.cfg.vocab_size <= 65535 else np.int32
    n = len(texts)
    step = 1 << 20
    tok = None
    lengths = np.empty((n,), np.int32)
    for s in range(0, n, step):
        ids_arr, mask = enc.tokenize(texts[s : s + step])
        if tok is None:
            tok = np.empty((n, ids_arr.shape[1]), dtype)
        tok[s : s + step] = ids_arr
        lengths[s : s + step] = mask.sum(axis=1)
    return tok, lengths


def derive_token_cache(index_path: str, embedding_model: str, max_length: int,
                       device: str = "cuda") -> "Tuple[np.ndarray, np.ndarray] | None":
    """Regenerate the token cache from passages.jsonl (tokens are derivable
    index state — the reason they are excluded from all-in accounting). Texts
    are read in graph-row order (id_list order; relayout permutes ids, not
    the passage file). Returns None when there are no passages to derive
    from."""
    from .embeddings.encoder import get_encoder

    ids = load_ids(index_path)
    jsonl = f"{index_path}.passages.jsonl"
    if not ids or not os.path.exists(jsonl):
        return None
    by_id = {}
    with open(jsonl, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                by_id[str(rec["id"])] = rec.get("text", "")
    try:
        texts = [by_id[i] for i in ids]
    except KeyError as e:
        logger.warning("token-cache derivation failed: passage %s missing", e)
        return None
    if not any(texts):
        return None
    enc = get_encoder(embedding_model, max_length=max_length, device=device)
    tok, lengths = tokenize_corpus(texts, enc)
    write_token_cache(index_path, tok, lengths)
    logger.info("token cache derived from passages: %s rows x %s", *tok.shape)
    return load_token_cache(index_path)


# --------------------------------------------------------------------------
# all-in accounting
# --------------------------------------------------------------------------

def index_all_in_bytes(prefix: str) -> int:
    """Sum of every artifact needed to SEARCH this index: backend npz (graph
    + PQ), partition, ids, meta. Excludes the passage text (.passages.* —
    any system needs the text to return results) and derivable caches
    (.cache.* — regenerated from the passages at load)."""
    d, base = os.path.dirname(prefix) or ".", os.path.basename(prefix)
    total = 0
    for f in os.listdir(d):
        if f.startswith(base) and ".passages." not in f and ".cache." not in f:
            total += os.path.getsize(os.path.join(d, f))
    return total
