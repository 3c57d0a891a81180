"""High-level API: LeannBuilder / LeannSearcher / PassageManager.

Counterpart of the JAX package's ``api.py``, writing and reading the same
on-disk index per prefix ``<dir>/<name>.leann``:
  ``<prefix>.meta.json``        build params, model, metric, flags
  ``<prefix>.passages.jsonl``   one {"id", "text", "metadata"} per line
  ``<prefix>.passages.idx``     pickled {id: byte_offset}
  ``<prefix>.tokens.cache.np*`` token ids/lengths of recompute indexes (a
                                derivable cache, see storage.py)
  backend payloads              e.g. ``<prefix>.diskann.npz``

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
CUDA is absent unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import pickle
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .device import resolve_device
from .embeddings.compute import IN_PROCESS_MODES, compute_embeddings
from .interface import LeannBackendSearcherInterface
from .metadata_filter import MetadataFilterEngine
from .registry import get_backend, register_project_directory
from .storage import drop_resume_keys, load_ids, load_token_cache, save_ids, tokenize_corpus, write_token_cache

logger = logging.getLogger(__name__)

INDEX_FORMAT_VERSION = 2

# Models whose embeddings are unit-norm; cosine is forced for them.
_NORMALIZED_MODEL_MARKERS = ("text-embedding", "voyage", "cohere", "minilm", "all-MiniLM", "hash-minilm", "hash-tiny")


def _is_normalized_model(model_name: str, mode: str) -> bool:
    low = model_name.lower()
    return any(m.lower() in low for m in _NORMALIZED_MODEL_MARKERS) or mode == "openai"


@dataclass
class SearchResult:
    id: str
    score: float
    text: str
    metadata: Dict[str, Any] = field(default_factory=dict)


class PassageManager:
    """Offset-indexed access to one or more passage jsonl shards; paths are
    resolved relative to the meta.json location so indexes are portable.

    With ``use_native`` (the default) each source's lookups go through the
    native store (``runtime/passage_store.py``, which raises if it cannot be
    built); an id it lacks, or a line whose id is another, is read through
    the offset map, as an id appended by ``update_index`` after the store's
    ``.cidx`` was written. Where the ``.cidx`` is missing or stale and the
    directory takes no new file, the source is read through the offset map
    alone, with a warning."""

    def __init__(self, passage_sources: List[Dict[str, Any]], meta_dir: "str | None" = None,
                 use_native: bool = True):
        self._sources: List[Dict[str, Any]] = []
        self._offsets: List[Dict[str, int]] = []
        self._id_to_source: Dict[str, int] = {}
        self._native: List[Any] = []  # per source: NativePassageStore, or None without use_native
        self.filter_engine = MetadataFilterEngine()
        for src in passage_sources:
            path = self._resolve(src["path"], meta_dir)
            idx_path = self._resolve(src.get("index_path", path.replace(".jsonl", ".idx")), meta_dir)
            with open(idx_path, "rb") as f:
                offsets = pickle.load(f)
            si = len(self._sources)
            self._sources.append({**src, "path": path})
            self._offsets.append(offsets)
            native = None
            if use_native:
                from .runtime.passage_store import NativePassageStore, OffsetIndexUnwritable

                try:
                    native = NativePassageStore(path)
                except OffsetIndexUnwritable as e:
                    logger.warning("%s: passages are read through the offset map", e)
            self._native.append(native)
            for pid in offsets:
                self._id_to_source[pid] = si

    @staticmethod
    def _resolve(path: str, meta_dir: "str | None") -> str:
        if os.path.exists(path):
            return path
        if meta_dir:
            cand = os.path.join(meta_dir, os.path.basename(path))
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f"passage file not found: {path}")

    def __len__(self) -> int:
        return len(self._id_to_source)

    def __contains__(self, pid: str) -> bool:
        return pid in self._id_to_source

    def ids(self) -> List[str]:
        return list(self._id_to_source)

    def get_passage(self, pid: str) -> Dict[str, Any]:
        si = self._id_to_source.get(pid)
        if si is None:
            raise KeyError(f"passage id {pid!r} not found")
        native = self._native[si]
        if native is not None:
            p = native.get(pid)
            if p is not None and str(p.get("id")) == pid:
                return p
        offset = self._offsets[si][pid]
        with open(self._sources[si]["path"], "rb") as f:
            f.seek(offset)
            return json.loads(f.readline().decode("utf-8"))

    def iter_passages(self):
        for src, offsets in zip(self._sources, self._offsets):
            with open(src["path"], "rb") as f:
                for pid in offsets:
                    f.seek(offsets[pid])
                    yield json.loads(f.readline().decode("utf-8"))

    def filter_search_results(self, results, filters):
        return self.filter_engine.apply_filters(results, filters)


def _rows_sha1(*columns: List[Any]) -> str:
    """Content key of the resume skips: a hash over every row of each column
    (ids, texts, metadata), in order, each column serialized in one call
    (host work well under the write it skips). The sidecars keep it under
    ``rows_sha1``, a field the JAX package's first-and-last keys lack, so
    either package rewrites over the other's sidecar."""
    h = hashlib.sha1()
    for col in columns:
        h.update(json.dumps(col, ensure_ascii=False).encode("utf-8"))
    return h.hexdigest()


def _passages_key(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The passage store's resume key: the row count and every row's id,
    text and metadata."""
    return {"count": len(chunks), "rows_sha1": _rows_sha1([c["id"] for c in chunks], [c["text"] for c in chunks],
                                                          [c.get("metadata", {}) for c in chunks])}


def _read_sidecar(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


@contextlib.contextmanager
def _replacing(path: str):
    """A binary file written at a temporary name beside ``path`` and renamed
    over it once complete. A store that mmapped the old jsonl (the native
    passage store of an open searcher) keeps the old file; a rewrite in
    place could leave it mapped past the end of a shorter one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            yield f
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _write_passages(chunks: List[Dict[str, Any]], prefix: str) -> Dict[str, Any]:
    passages_path = f"{prefix}.passages.jsonl"
    idx_path = f"{prefix}.passages.idx"
    done_path = f"{prefix}.passages.done.json"
    src = {"type": "jsonl", "path": passages_path, "index_path": idx_path, "count": len(chunks)}
    # resume skip: the .done sidecar is written only after both files are
    # complete and keys on every row (_passages_key)
    key = _passages_key(chunks) if chunks else None
    if key and os.path.exists(passages_path) and os.path.exists(idx_path) and _read_sidecar(done_path) == key:
        logger.info("passages store up to date (%d rows): skipping rewrite", len(chunks))
        return src
    drop_resume_keys(prefix, ("passages",))  # a rewrite cut short leaves no key over a mix of old and new rows
    offsets: Dict[str, int] = {}
    with _replacing(passages_path) as f:
        for c in chunks:
            offsets[c["id"]] = f.tell()
            f.write(json.dumps({"id": c["id"], "text": c["text"], "metadata": c.get("metadata", {})},
                               ensure_ascii=False).encode("utf-8"))
            f.write(b"\n")
    with _replacing(idx_path) as f:
        pickle.dump(offsets, f)
    if key:
        with open(done_path, "w") as f:
            json.dump(key, f)
    return src


class LeannBuilder:
    def __init__(
        self,
        backend_name: str = "hnsw",
        embedding_model: str = "hash-minilm",
        embedding_mode: str = "tpu",
        dimensions: Optional[int] = None,
        distance_metric: Optional[str] = None,
        is_compact: bool = True,
        is_recompute: bool = True,
        max_length: int = 256,
        num_threads: int = 0,  # parity kwarg
        device: str = "cuda",
        **backend_kwargs,
    ):
        self.device = resolve_device(device)
        self.backend_name = backend_name
        self.embedding_model = embedding_model
        self.embedding_mode = embedding_mode
        self.dimensions = dimensions
        self.max_length = max_length
        self.backend_kwargs = backend_kwargs
        # without recompute the index must retain embeddings
        if not is_recompute and is_compact:
            logger.info("is_recompute=False forces is_compact=False (embeddings must be stored)")
            is_compact = False
        self.is_compact = is_compact
        self.is_recompute = is_recompute
        if distance_metric is None:
            distance_metric = "cosine" if _is_normalized_model(embedding_model, embedding_mode) else "mips"
        self.distance_metric = distance_metric.lower()
        if self.distance_metric not in ("l2", "mips", "cosine"):
            raise ValueError(f"distance_metric must be l2|mips|cosine, got {distance_metric!r}")
        self.chunks: List[Dict[str, Any]] = []
        self.phase_seconds: Dict[str, float] = {}  # wall time of each build phase

    def add_text(self, text: str, metadata: Optional[Dict[str, Any]] = None, id: Optional[str] = None) -> None:
        if id is None:
            id = str(len(self.chunks))
        self.chunks.append({"id": id, "text": text, "metadata": metadata or {}})

    @classmethod
    def from_index(cls, index_path: str, device: str = "cuda") -> "LeannBuilder":
        """A builder configured from an existing index's meta.json, for
        incremental updates: add_text() the new chunks, then update_index()."""
        with open(f"{index_path}.meta.json") as f:
            meta = json.load(f)
        return cls(
            backend_name=meta["backend_name"],
            embedding_model=meta["embedding_model"],
            embedding_mode=meta.get("embedding_mode", "tpu"),
            dimensions=meta.get("dimensions"),
            distance_metric=meta.get("distance_metric"),
            is_compact=meta.get("is_compact", True),
            is_recompute=meta.get("is_recompute", True),
            max_length=meta.get("max_length", 256),
            device=device,
            **meta.get("backend_kwargs", {}),
        )

    # -- build -------------------------------------------------------------

    def _embed(self, texts: List[str], is_build: bool = True) -> np.ndarray:
        return compute_embeddings(
            texts,
            self.embedding_model,
            mode=self.embedding_mode,
            is_build=is_build,
            batch_size=4096 if is_build else 128,
            max_length=self.max_length,
            device=self.device,
            **({"dim": self.dimensions} if (self.dimensions and self.embedding_mode == "simulated") else {}),
        )

    def build_index(self, index_path: str) -> None:
        t0 = time.time()
        chunks = [c for c in self.chunks if c["text"] and c["text"].strip()]
        if not chunks:
            raise ValueError("No non-empty chunks to index")
        if len(chunks) != len(self.chunks):
            logger.warning("dropped %d empty chunks", len(self.chunks) - len(chunks))
        factory = get_backend(self.backend_name)  # an unknown backend raises before any work
        prefix = str(index_path)
        Path(prefix).parent.mkdir(parents=True, exist_ok=True)
        times = self.phase_seconds
        times.clear()

        texts = [c["text"] for c in chunks]
        t = time.time()
        self._maybe_calibrate(texts, prefix)
        times["calibrate"] = time.time() - t
        t = time.time()
        embeddings = self._embed(texts)
        times["embed"] = time.time() - t
        self.dimensions = int(embeddings.shape[1])
        t = time.time()
        source = _write_passages(chunks, prefix)
        times["passages"] = time.time() - t
        t = time.time()
        self._maybe_write_tokens(texts, prefix)
        times["tokens"] = time.time() - t
        ids = [c["id"] for c in chunks]
        t = time.time()
        self._backend_build(factory, embeddings, ids, prefix)
        times["backend"] = time.time() - t
        self._write_meta(prefix, [source], n=len(chunks))
        times["total"] = time.time() - t0
        logger.info("built index %s (%d chunks) in %.2fs", prefix, len(chunks), times["total"])

    def update_index(self, index_path: str, insert_batch_size: int = 256) -> None:
        """Insert this builder's chunks into an existing index without a
        rebuild: batched Vamana insertion (``ops/insert.py``) of
        ``insert_batch_size`` chunks at a time, after the passages, ids and
        token rows are appended; the meta last. Open searchers must be
        created again to see the new chunks. ``phase_seconds`` holds the
        wall time of each phase."""
        t0 = time.time()
        times = self.phase_seconds
        times.clear()
        prefix = str(index_path)
        with open(f"{prefix}.meta.json") as f:
            meta = json.load(f)
        if meta["backend_name"] != self.backend_name:
            raise ValueError(f"index is {meta['backend_name']!r}, builder is {self.backend_name!r}")
        if meta["embedding_model"] != self.embedding_model:
            raise ValueError("embedding_model mismatch with existing index")
        factory = get_backend(self.backend_name)
        insert = getattr(factory, "insert", None)
        if insert is None:
            raise NotImplementedError(
                f"backend {self.backend_name!r} does not support incremental insert "
                "(diskann's partition-contiguous relabeling requires a rebuild)"
            )
        chunks = [c for c in self.chunks if c["text"] and c["text"].strip()]
        if not chunks:
            raise ValueError("No non-empty chunks to insert")
        n_old = int(meta.get("num_chunks", 0))
        with open(f"{prefix}.passages.idx", "rb") as f:
            offsets: Dict[str, int] = pickle.load(f)
        # add_text's positional ids ("0", "1", ...) continue after the
        # index's rows; an explicit id already in the index raises
        for i, c in enumerate(chunks):
            if c["id"].isdigit() and int(c["id"]) < n_old:
                chunks[i] = {**c, "id": str(n_old + i)}
            elif c["id"] in offsets:
                raise ValueError(f"duplicate id {c['id']!r} already in index")
        texts = [c["text"] for c in chunks]

        t = time.time()
        calib_path = f"{prefix}.calib.npz"
        if os.path.exists(calib_path) and self.embedding_mode in IN_PROCESS_MODES:
            # the new chunks are embedded as the index's were: with its
            # corpus calibration (a fresh process's encoder lacks it)
            from .embeddings.encoder import get_encoder

            with np.load(calib_path) as z:
                get_encoder(self.embedding_model, max_length=self.max_length, device=self.device).apply_calibration(
                    {"out_center": z["out_center"], "out_pc": z["out_pc"]})
        embeddings = self._embed(texts)
        if self.distance_metric == "cosine":
            embeddings = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
        times["embed"] = time.time() - t
        # 1. passages, offsets and ids, before the graph: a compact index
        # re-encodes the new rows from their tokens. Rows appended: a build
        # on the old texts rewrites both stores
        t = time.time()
        drop_resume_keys(prefix)
        with open(f"{prefix}.passages.jsonl", "ab") as f:
            for c in chunks:
                offsets[c["id"]] = f.tell()
                f.write(json.dumps({"id": c["id"], "text": c["text"], "metadata": c.get("metadata", {})},
                                   ensure_ascii=False).encode("utf-8"))
                f.write(b"\n")
        with _replacing(f"{prefix}.passages.idx") as f:
            pickle.dump(offsets, f)
        if os.path.exists(f"{prefix}.ids.json"):
            save_ids(prefix, load_ids(prefix) + [c["id"] for c in chunks])
        times["passages"] = time.time() - t
        # 2. token rows, cut to the store's T
        t = time.time()
        old = load_token_cache(prefix)
        if old is not None:
            from .embeddings.encoder import get_encoder

            enc = get_encoder(self.embedding_model, max_length=meta.get("max_length", self.max_length),
                              device=self.device)
            old_tok, old_len = old
            new_tok, new_mask = enc.tokenize(texts)
            t_old = old_tok.shape[1]
            lengths = np.minimum(new_mask.sum(axis=1), t_old).astype(np.int32)
            all_tok = np.concatenate([old_tok, new_tok[:, :t_old].astype(old_tok.dtype)])
            all_len = np.concatenate([old_len, lengths])
            for stale in (f"{prefix}.tokens.npy", f"{prefix}.lengths.npy", f"{prefix}.tokens.npz"):
                if os.path.exists(stale):
                    os.remove(stale)  # a legacy store, superseded by the cache
            write_token_cache(prefix, all_tok, all_len)
        times["tokens"] = time.time() - t
        # 3. the graph, in batches
        t = time.time()
        for s in range(0, len(chunks), insert_batch_size):
            insert(prefix, embeddings[s : s + insert_batch_size], device=self.device)
        times["insert"] = time.time() - t
        # 4. meta
        meta["num_chunks"] = n_old + len(chunks)
        if meta.get("passage_sources"):
            meta["passage_sources"][0]["count"] = meta["num_chunks"]
        with open(f"{prefix}.meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        times["total"] = time.time() - t0
        logger.info("updated index %s: +%d chunks (%d total) in %.2fs",
                    prefix, len(chunks), meta["num_chunks"], times["total"])

    def build_index_from_embeddings(self, index_path: str, ids: Sequence[str], embeddings: np.ndarray,
                                    texts: Optional[Sequence[str]] = None) -> None:
        """Build from precomputed (ids, [N, D] embeddings). Without
        ``texts`` the passages hold empty text and recompute and compact
        storage are turned off (there is nothing to re-encode).

        With ``distance_metric="cosine"`` the array may be normalized IN
        PLACE (no second copy at scale). f16 input stays f16 into the
        index; every product on the card casts its block anyway."""
        if embeddings.dtype != np.float16:
            embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        else:
            embeddings = np.ascontiguousarray(embeddings)
        if len(ids) != embeddings.shape[0]:
            raise ValueError("ids/embeddings length mismatch")
        factory = get_backend(self.backend_name)
        self.dimensions = int(embeddings.shape[1])
        prefix = str(index_path)
        Path(prefix).parent.mkdir(parents=True, exist_ok=True)
        self.phase_seconds.clear()
        has_text = texts is not None
        if not has_text:
            texts = ["" for _ in ids]
            if self.is_recompute:
                logger.info("no texts supplied: disabling recompute, storing embeddings")
                self.is_recompute = False
                self.is_compact = False
        chunks = [{"id": str(i), "text": t, "metadata": {}} for i, t in zip(ids, texts)]
        t = time.time()
        source = _write_passages(chunks, prefix)
        self.phase_seconds["passages"] = time.time() - t
        if has_text:
            t = time.time()
            self._maybe_write_tokens(list(texts), prefix)
            self.phase_seconds["tokens"] = time.time() - t
        self._backend_build(factory, embeddings, [str(i) for i in ids], prefix)
        self._write_meta(prefix, [source], n=len(ids))

    def _maybe_calibrate(self, texts: List[str], prefix: str) -> None:
        """Corpus calibration of a loaded checkpoint's encoder
        (:meth:`TorchEncoder.calibrate`), saved as ``<prefix>.calib.npz`` for
        the searchers. It sets the calibration on the cached encoder that
        ``_embed`` then uses: the same name, ``max_length`` and device.
        hash-* models keep their seeded probe center, and a calibration an
        earlier build left at this prefix is removed (the searchers would
        apply it)."""
        calib_path = f"{prefix}.calib.npz"
        if self.embedding_mode in IN_PROCESS_MODES:
            from .embeddings.encoder import get_encoder

            enc = get_encoder(self.embedding_model, max_length=self.max_length, device=self.device)
            if enc.needs_corpus_calibration:
                np.savez(calib_path, **enc.calibrate(texts))
                return
        if os.path.exists(calib_path):
            os.remove(calib_path)

    def _maybe_write_tokens(self, texts: List[str], prefix: str) -> None:
        """Tokenize passages for on-device recompute (u16 when the vocab
        allows), written as a derivable ``.cache.`` artifact."""
        if not (self.is_recompute and self.embedding_mode in IN_PROCESS_MODES):
            return
        if not texts:
            return
        done_path = f"{prefix}.tokens.cache.done.json"
        want = {"count": len(texts), "model": self.embedding_model,
                "max_length": self.max_length, "rows_sha1": _rows_sha1(texts)}
        if _read_sidecar(done_path) == want:  # resume skip: the same model over every same text
            logger.info("token cache up to date (%d rows): skipping rewrite", len(texts))
            return
        drop_resume_keys(prefix, ("tokens.cache",))
        from .embeddings.encoder import get_encoder

        enc = get_encoder(self.embedding_model, max_length=self.max_length, device=self.device)
        tok, lengths = tokenize_corpus(texts, enc)
        write_token_cache(prefix, tok, lengths)
        with open(done_path, "w") as f:
            json.dump(want, f)

    @staticmethod
    def _is_unit_norm(embeddings: np.ndarray, tol: float = 3e-3) -> bool:
        step = max(1, embeddings.shape[0] // 1024)
        sn = np.linalg.norm(np.asarray(embeddings[::step], dtype=np.float32), axis=1)
        return bool(np.abs(sn - 1.0).max() <= tol)

    def _backend_build(self, factory, embeddings: np.ndarray, ids: List[str], prefix: str) -> None:
        if self.distance_metric == "cosine" and not self._is_unit_norm(embeddings):
            if not embeddings.flags.writeable:
                embeddings = embeddings.copy()
            if embeddings.dtype == np.float16:
                # f32 arithmetic per block, cast back in place: f16 norm sums
                # lose ~2 digits, and a whole f32 copy undoes the f16 store
                blk = 1 << 20
                for s in range(0, embeddings.shape[0], blk):
                    b32 = embeddings[s : s + blk].astype(np.float32)
                    nb = np.linalg.norm(b32, axis=1, keepdims=True)
                    embeddings[s : s + blk] = (b32 / np.maximum(nb, 1e-12)).astype(np.float16)
            else:
                norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
                np.divide(embeddings, np.maximum(norms, 1e-12), out=embeddings)
        builder = factory.builder(
            distance_metric=self.distance_metric,
            is_compact=self.is_compact,
            is_recompute=self.is_recompute,
            device=self.device,
            **self.backend_kwargs,
        )
        builder.build(embeddings, ids, prefix)
        for name, sec in getattr(builder, "phase_seconds", {}).items():
            self.phase_seconds[f"backend/{name}"] = sec

    def _write_meta(self, prefix: str, sources: List[Dict[str, Any]], n: int) -> None:
        meta = {
            "version": INDEX_FORMAT_VERSION,
            "backend_name": self.backend_name,
            "embedding_model": self.embedding_model,
            "embedding_mode": self.embedding_mode,
            "dimensions": self.dimensions,
            "distance_metric": self.distance_metric,
            "is_compact": self.is_compact,
            "is_pruned": self.is_compact,  # compact == embeddings pruned
            "is_recompute": self.is_recompute,
            "max_length": self.max_length,
            "num_chunks": n,
            "backend_kwargs": self.backend_kwargs,
            "passage_sources": sources,
        }
        with open(f"{prefix}.meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        try:
            register_project_directory(Path(prefix).resolve().parent)
        except OSError:
            pass


class LeannSearcher:
    def __init__(self, index_path: str, enable_warmup: bool = False, device: str = "cuda", **backend_kwargs):
        self.device = resolve_device(device)
        prefix = str(index_path)
        meta_path = f"{prefix}.meta.json"
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"index meta not found: {meta_path}")
        with open(meta_path) as f:
            self.meta = json.load(f)
        self.index_path = prefix
        self.backend_name = self.meta["backend_name"]
        self.embedding_model = self.meta["embedding_model"]
        self.embedding_mode = self.meta.get("embedding_mode", "tpu")
        self.distance_metric = self.meta.get("distance_metric", "mips")
        self.passage_manager = PassageManager(self.meta["passage_sources"], meta_dir=str(Path(prefix).parent))
        # build-time kwargs overridden per searcher
        merged = {**self.meta.get("backend_kwargs", {}), **backend_kwargs}
        factory = get_backend(self.backend_name)
        self.backend: LeannBackendSearcherInterface = factory.searcher(
            prefix, meta=self.meta, device=self.device, **merged)
        if enable_warmup:
            self.search("warmup", top_k=1)

    def search(
        self,
        query: "str | np.ndarray",
        top_k: int = 5,
        complexity: int = 64,
        beam_width: int = 1,
        prune_ratio: "float | None" = None,
        recompute_embeddings: Optional[bool] = None,
        pruning_strategy: str = "global",
        metadata_filters: Optional[Dict[str, Dict[str, Any]]] = None,
        batch_size: int = 0,
        zmq_port: Optional[int] = None,  # parity kwarg; no server exists here
        **kwargs,
    ) -> List[SearchResult]:
        t0 = time.time()
        n = self.meta.get("num_chunks", len(self.passage_manager))
        top_k = max(1, min(top_k, n))
        if recompute_embeddings is None:
            recompute_embeddings = bool(self.meta.get("is_recompute", False))
        search_params = dict(
            complexity=complexity,
            beam_width=beam_width,
            prune_ratio=prune_ratio,
            recompute_embeddings=recompute_embeddings,
            pruning_strategy=pruning_strategy,
            batch_size=batch_size,
            **kwargs,
        )
        is_text = isinstance(query, str) or (
            isinstance(query, (list, tuple)) and query and isinstance(query[0], str)
        )
        single = isinstance(query, str)
        search_text = getattr(self.backend, "search_text", None)
        if is_text and search_text is not None and self.embedding_mode in IN_PROCESS_MODES:
            out = search_text(query, top_k, **search_params)  # encode on the device, then search
        else:
            if single:
                q = self.backend.compute_query_embedding(query)
            elif is_text:
                get_enc = getattr(self.backend, "get_encoder", None)
                if get_enc is not None and self.embedding_mode in IN_PROCESS_MODES:
                    q = get_enc().encode(list(query))  # index-calibrated encoder
                else:
                    q = compute_embeddings(list(query), self.embedding_model, mode=self.embedding_mode,
                                           max_length=self.meta.get("max_length", 256), device=self.device)
            else:
                q = np.ascontiguousarray(query, dtype=np.float32)
                if q.ndim == 1:
                    q = q[None, :]
                single = q.shape[0] == 1
            if self.distance_metric == "cosine":
                q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            out = self.backend.search(q, top_k, **search_params)
        labels, distances = np.asarray(out["labels"]), np.asarray(out["distances"])

        def enrich(row_labels, row_dists) -> List[SearchResult]:
            results: List[SearchResult] = []
            id_list = getattr(self.backend, "id_list", None)
            for lbl, dist in zip(row_labels.tolist(), row_dists.tolist()):
                if lbl < 0:
                    continue
                pid = id_list[lbl] if id_list is not None else str(lbl)
                try:
                    p = self.passage_manager.get_passage(pid)
                except KeyError:
                    continue
                results.append(SearchResult(id=pid, score=float(dist), text=p.get("text", ""),
                                            metadata=p.get("metadata", {})))
            if metadata_filters:
                keep = self.passage_manager.filter_search_results(
                    [{"id": r.id, "text": r.text, "metadata": r.metadata} for r in results],
                    metadata_filters,
                )
                keep_ids = {k["id"] for k in keep}
                results = [r for r in results if r.id in keep_ids]
            return results

        all_results = [enrich(labels[i], distances[i]) for i in range(labels.shape[0])]
        logger.info("search(%r top_k=%d) -> %d row(s) in %.3fs",
                    (query[:40] if isinstance(query, str) else f"<{labels.shape[0]} queries>"),
                    top_k, len(all_results), time.time() - t0)
        return all_results[0] if single else all_results

    def cleanup(self) -> None:
        cleanup = getattr(self.backend, "cleanup", None)
        if cleanup:
            cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
        return False


class LeannChat:
    """RAG chat loop (reference api.py:826-930): the searcher's top passages
    as the context of one prompt to the LLM. The searcher and an ``hf``
    model run on ``device`` (default ``"cuda"``, raising without CUDA)."""

    PROMPT_TEMPLATE = (
        "You are a helpful assistant. Use the following retrieved context to answer the question.\n\n"
        "Context:\n{context}\n\nQuestion: {question}\n\nAnswer:"
    )

    def __init__(self, index_path: str, llm_config: Optional[Dict[str, Any]] = None,
                 searcher: Optional[LeannSearcher] = None, system_prompt: Optional[str] = None,
                 device: str = "cuda", **searcher_kwargs):
        from .chat import get_llm

        self.device = resolve_device(device)
        self.searcher = searcher or LeannSearcher(index_path, device=self.device, **searcher_kwargs)
        self._owns_searcher = searcher is None
        self.llm = get_llm(llm_config or {"type": "simulated"}, device=self.device)
        self.system_prompt = system_prompt

    def ask(self, question: str, top_k: int = 5, llm_kwargs: Optional[Dict[str, Any]] = None, **search_kwargs) -> str:
        results = self.searcher.search(question, top_k=top_k, **search_kwargs)
        context = "\n\n".join(r.text for r in results)
        prompt = self.PROMPT_TEMPLATE.format(context=context, question=question)
        return self.llm.ask(prompt, system=self.system_prompt, **(llm_kwargs or {}))

    def start_interactive(self) -> None:  # pragma: no cover - REPL
        print("LEANN chat. Type 'quit' to exit.")
        while True:
            try:
                q = input("You: ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if q.lower() in ("quit", "exit", ""):
                break
            print("Assistant:", self.ask(q))

    def cleanup(self) -> None:
        if self._owns_searcher:
            self.searcher.cleanup()
