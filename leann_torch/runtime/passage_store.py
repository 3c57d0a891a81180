"""ctypes binding of the native passage store (``csrc/passage_store.cpp``).

Counterpart of the JAX package's ``runtime/passage_store.py``: id -> passage
lookups over an mmap'd jsonl through a binary offset index
(``<prefix>.passages.cidx``, the same format in both packages). The library
is built with the host compiler at first use (``ops/cuda_build.py``); a
failed build or load raises.

A ``.cidx`` older than its jsonl is written again when the store opens:
a rebuild into the same prefix rewrites the jsonl, and the old offsets
would point into the middle of other lines. The builders replace the jsonl
by a rename, never in place, so a store that is open keeps its mapping of
the old file.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Any, Dict, Optional

from ..ops import cuda_build


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("passage_store")
    lib.ps_build_index.restype = ctypes.c_longlong
    lib.ps_build_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ps_open.restype = ctypes.c_void_p
    lib.ps_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ps_count.restype = ctypes.c_longlong
    lib.ps_count.argtypes = [ctypes.c_void_p]
    lib.ps_get.restype = ctypes.c_uint64
    lib.ps_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.ps_close.restype = None
    lib.ps_close.argtypes = [ctypes.c_void_p]
    return lib


class OffsetIndexUnwritable(OSError):
    """The ``.cidx`` is missing or stale and cannot be written beside its
    jsonl (a read-only index directory)."""


def build_offset_index(jsonl_path: str, cidx_path: str) -> int:
    """One pass over ``jsonl_path`` -> ``cidx_path`` (written whole, then
    renamed into place) -> the passage count. Raises
    :class:`OffsetIndexUnwritable` when the directory takes no new file."""
    tmp = f"{cidx_path}.{os.getpid()}.tmp"
    lib = _lib()
    try:
        open(tmp, "wb").close()
    except OSError as e:
        raise OffsetIndexUnwritable(f"cannot write {cidx_path}: {e}") from e
    count = int(lib.ps_build_index(os.fsencode(jsonl_path), os.fsencode(tmp)))
    if count < 0:
        os.unlink(tmp)
        raise OSError(f"could not index {jsonl_path}")
    os.replace(tmp, cidx_path)
    return count


class NativePassageStore:
    """Zero-copy id -> passage lookups over an mmap'd jsonl."""

    def __init__(self, jsonl_path: str, cidx_path: Optional[str] = None):
        self._handle = None
        self._lib = _lib()
        cidx_path = cidx_path or jsonl_path.replace(".jsonl", ".cidx")
        if not os.path.exists(cidx_path) or os.stat(cidx_path).st_mtime_ns < os.stat(jsonl_path).st_mtime_ns:
            build_offset_index(jsonl_path, cidx_path)
        self._handle = self._lib.ps_open(os.fsencode(jsonl_path), os.fsencode(cidx_path))
        if not self._handle:
            raise OSError(f"could not open the passage store {jsonl_path} ({cidx_path})")

    def __len__(self) -> int:
        return int(self._lib.ps_count(self._handle))

    def get_raw(self, pid: str) -> Optional[bytes]:
        ptr = ctypes.c_char_p()
        n = self._lib.ps_get(self._handle, pid.encode("utf-8"), ctypes.byref(ptr))
        return None if n == 0 else ctypes.string_at(ptr, n)

    def get(self, pid: str) -> Optional[Dict[str, Any]]:
        raw = self.get_raw(pid)
        return json.loads(raw) if raw is not None else None

    def close(self) -> None:
        if self._handle:
            self._lib.ps_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
