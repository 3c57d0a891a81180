"""ctypes binding of the native ASCII hash tokenizer (``csrc/hash_tokenizer.cpp``).

Counterpart of the JAX package's ``runtime/fast_tokenizer.py``. The library
is built with the host compiler at first use (``ops/cuda_build.py``) and
gives exactly the Python :class:`~leann_torch.embeddings.tokenizer.HashTokenizer`'s
ids on ASCII text; non-ASCII texts stay on the Python path. There is no
quiet fallback: a failed build or load raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from ..ops import cuda_build


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("hash_tokenizer")
    lib.tok_encode_batch_ascii.restype = None
    lib.tok_encode_batch_ascii.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def encode_batch_ascii(texts: Sequence[str], max_length: int, vocab_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize ASCII ``texts`` natively -> (ids [N, L] i32, mask [N, L] i32).
    Raises ``ValueError`` on a non-ASCII text."""
    if max_length < 2 or vocab_size <= 4:
        raise ValueError(f"max_length must be >= 2 and vocab_size > 4, got {max_length}, {vocab_size}")
    n = len(texts)
    enc = [t.encode("ascii") for t in texts]  # raises on a non-ASCII text
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    buf = b"".join(enc)
    ids = np.zeros((n, max_length), np.int32)
    lens = np.zeros(n, np.int32)
    _lib().tok_encode_batch_ascii(buf, offsets.ctypes.data, n, max_length, vocab_size,
                                  ids.ctypes.data, lens.ctypes.data)
    mask = (np.arange(max_length)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask
