"""Counter-based threefry2x32 in numpy, drawing the same numbers as jax.random.

The hash-* encoders are seeded random transformers: their weights are a pure
function of the model name, drawn with jax.random's threefry2x32 generator
(partitionable form, the default since jax 0.5). torch's generators cannot
reproduce those draws, and an index built by one package can only be searched
by the other when both hold the same weights. This module re-implements the
handful of jax.random entry points that ``init_params`` and
``_compute_out_center`` use:

* ``prng_key(seed)``         == ``jax.random.PRNGKey(seed)`` (raw u32[2] key)
* ``split(key, num)``        == ``jax.random.split`` (u32[num, 2])
* ``bits(key, shape)``       == ``jax.random.bits`` (u32)
* ``normal(key, shape)``     == ``jax.random.normal`` (f32)
* ``randint(key, shape, lo, hi)`` == ``jax.random.randint`` (i32)

``prng_key``, ``split``, ``bits`` and ``randint`` are bit-exact. ``normal``
is ``sqrt(2) * erfinv(u)`` on the same uniform ``u``, with erfinv as the
float32 polynomial XLA uses; numpy's log1p and operation order differ from
XLA's in the last bits, so values agree to about 1e-6 (most are bit-equal).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


_CHUNK = 1 << 16  # elements hashed per pass: keeps the working set in cache


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (5 key injections), elementwise over
    the counter words ``x1``/``x2``."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    shape = np.broadcast(x1, x2).shape
    a = np.ascontiguousarray(np.broadcast_to(x1, shape), np.uint32).reshape(-1)
    b = np.ascontiguousarray(np.broadcast_to(x2, shape), np.uint32).reshape(-1)
    o0 = np.empty(a.size, np.uint32)
    o1 = np.empty(a.size, np.uint32)
    tmp = np.empty(min(a.size, _CHUNK), np.uint32)
    for s in range(0, a.size, _CHUNK):
        x = o0[s : s + _CHUNK]
        y = o1[s : s + _CHUNK]
        t = tmp[: x.size]
        np.add(a[s : s + _CHUNK], ks[0], out=x)
        np.add(b[s : s + _CHUNK], ks[1], out=y)
        for i in range(5):
            for r in _ROT[i % 2]:
                np.add(x, y, out=x)
                np.left_shift(y, np.uint32(r), out=t)
                np.right_shift(y, np.uint32(32 - r), out=y)
                np.bitwise_or(y, t, out=y)
                np.bitwise_xor(y, x, out=y)
            np.add(x, ks[(i + 1) % 3], out=x)
            np.add(y, ks[(i + 2) % 3] + np.uint32(i + 1), out=y)
    return o0.reshape(shape), o1.reshape(shape)


def _iota_2x32(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """64-bit row-major iota over ``shape`` as (hi, lo) u32 words."""
    n = math.prod(shape)
    if n <= 1 << 32:
        return np.zeros(shape, np.uint32), np.arange(n, dtype=np.uint32).reshape(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def prng_key(seed: int) -> np.ndarray:
    """Raw key of a non-negative seed below 2**63: [seed >> 32, seed & 0xffffffff]."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """u32 random bits, partitionable form: hash of the element's flat index."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """f32 uniform in [minval, maxval): 23 random mantissa bits under exponent 0."""
    b = bits(key, shape)
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)


# Giles' single-precision erfinv polynomials, the form XLA lowers erf_inv to
_ERFINV_W_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_W_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for i in range(1, len(_ERFINV_W_LT5)):
        p = np.where(lt, _ERFINV_W_LT5[i], _ERFINV_W_GE5[i]) + p * w
    return (p * x).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0).reshape(-1)
    out = np.empty_like(u)
    for s in range(0, u.size, _CHUNK):
        out[s : s + _CHUNK] = np.float32(math.sqrt(2.0)) * _erfinv_f32(u[s : s + _CHUNK])
    return out.reshape(tuple(shape))


def randint(key: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """i32 in [minval, maxval): two 32-bit draws folded modulo the span, as
    jax does to shrink the modulo bias."""
    k = split(key, 2)
    higher, lower = bits(k[0], shape), bits(k[1], shape)
    span = np.uint32(max(maxval - minval, 1))
    mult = np.uint32((1 << 16) % int(span))
    mult = np.uint32((int(mult) * int(mult)) % int(span))
    with np.errstate(over="ignore"):
        off = (higher % span) * mult + (lower % span)
    off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
