"""Counter-based threefry2x32 in numpy (and torch, on the card), drawing the same numbers as jax.random.

The hash-* encoders are seeded random transformers: their weights are a pure
function of the model name, drawn with jax.random's threefry2x32 generator
(partitionable form, the default since jax 0.5). torch's generators cannot
reproduce those draws, and an index built by one package can only be searched
by the other when both hold the same weights. NN-descent (``ops/graph.py``)
draws its candidate stream the same way, so that both packages join the same
candidates and either resumes the other's state. This module re-implements
the jax.random entry points they use, as numpy arrays:

* ``prng_key(seed)``         == ``jax.random.PRNGKey(seed)`` (raw u32[2] key)
* ``key(seed)``              == ``jax.random.key(seed)``'s key data
* ``split(key, num)``        == ``jax.random.split`` (u32[num, 2])
* ``fold_in(key, data)``     == ``jax.random.fold_in`` (of each ``data``)
* ``bits(key, shape)``       == ``jax.random.bits`` (u32)
* ``normal(key, shape)``     == ``jax.random.normal`` (f32)
* ``randint(key, shape, lo, hi)`` == ``jax.random.randint`` (i32)
* ``permutation(key, n)``    == ``jax.random.permutation`` of ``range(n)``

and, as int64 tensors on any device, ``randint_range`` (a flat slice of one
``randint`` draw, so a draw larger than the card's memory is taken slice by
slice) and ``randint_many`` (one draw per key). On the card these hash with
``threefry2x32_device``, the same rounds on int64 tensors.
All but ``normal`` are bit-exact. ``normal`` is ``sqrt(2) * erfinv(u)`` on
the same uniform ``u``, with erfinv as the float32 polynomial XLA uses;
numpy's log1p and operation order differ from XLA's in the last bits, so
values agree to about 1e-6 (most are bit-equal).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_M = 0xFFFFFFFF
_CHUNK = 1 << 16  # elements hashed per pass on the host: keeps the working set in cache
# counters hashed per pass on the card: bounds the int64 words and their
# temporaries (~40 B a counter)
_DEVICE_CHUNK = 1 << 22


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


def threefry2x32_device(k1, k2, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` for the card, in place on the counter words
    ``x`` / ``y`` (int64 tensors holding u32 values) -> (x, y). The key
    words are ints or int64 tensors broadcastable to them."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    t = torch.empty_like(y)
    x.add_(k1).bitwise_and_(_M)
    y.add_(k2).bitwise_and_(_M)
    for i in range(5):
        for r in _ROT[i % 2]:
            x.add_(y).bitwise_and_(_M)
            torch.bitwise_left_shift(y, r, out=t).bitwise_and_(_M)
            y.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x)
        x.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        y.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M)
    return x, y


def _iota_range(start: int, stop: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota start..stop-1 as (hi, lo) u32 words."""
    if stop <= 1 << 32:
        return np.zeros(stop - start, np.uint32), np.arange(start, stop, dtype=np.uint32)
    idx = np.arange(start, stop, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(_M)).astype(np.uint32)


def _iota_2x32(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """64-bit row-major iota over ``shape`` as (hi, lo) u32 words."""
    hi, lo = _iota_range(0, math.prod(shape))
    return hi.reshape(shape), lo.reshape(shape)


def _bits_range(key, start: int, stop: int, device: torch.device) -> torch.Tensor:
    """``bits(key, shape)``'s flat elements start..stop-1 as int64 on the
    card, :data:`_DEVICE_CHUNK` counters at a time."""
    k1, k2 = int(key[0]), int(key[1])
    out = torch.empty(stop - start, dtype=torch.int64, device=device)
    for s in range(start, stop, _DEVICE_CHUNK):
        e = min(s + _DEVICE_CHUNK, stop)
        idx = torch.arange(s, e, dtype=torch.int64, device=device)
        x, y = threefry2x32_device(k1, k2, idx >> 32, idx.bitwise_and_(_M))
        out[s - start : e - start] = x.bitwise_xor_(y)
    return out


def _fold(higher, lower, span: int):
    """jax's randint offset from two 32-bit draws (u32 numpy arrays or
    int64 tensors): ``(higher % span) * m + lower % span`` modulo ``span``,
    where jax takes the multiplier ``2^32 mod span`` as ``(2^16 mod
    span)^2`` squared in u32 (so it wraps to 0 for spans above 2^16). The
    sum never leaves 32 bits."""
    m = (1 << 16) % span
    m = (m * m) % (1 << 32) % span
    return ((higher % span) * m + lower % span) % span


def randint_range(key, start: int, stop: int, minval: int, maxval: int,
                  device: "str | torch.device" = "cpu") -> torch.Tensor:
    """The flat elements start..stop-1 of ``jax.random.randint(key, shape,
    minval, maxval)`` (any shape of more than ``stop`` elements) -> int64
    [stop - start] on ``device``. An element's draw hashes its flat index,
    so any split of a draw into ranges gives the same numbers. The host
    hashes in numpy (one thread: torch's would oversubscribe the cores of
    a host running several processes); the card hashes
    :data:`_DEVICE_CHUNK` counters at a time."""
    dev = torch.device(device)
    if dev.type != "cpu":
        return _randint_range_device(key, start, stop, minval, maxval, dev)
    kh, kl = split(key, 2)
    words = [np.bitwise_xor(*threefry2x32(k[0], k[1], *_iota_range(start, stop))) for k in (kh, kl)]
    return torch.from_numpy(_fold(*words, max(maxval - minval, 1)).astype(np.int64) + minval)


def _randint_range_device(key, start: int, stop: int, minval: int, maxval: int, dev: torch.device) -> torch.Tensor:
    span = max(maxval - minval, 1)
    kh, kl = split(key, 2)
    out = torch.empty(stop - start, dtype=torch.int64, device=dev)
    for s in range(start, stop, _DEVICE_CHUNK):
        e = min(s + _DEVICE_CHUNK, stop)
        out[s - start : e - start] = _fold(_bits_range(kh, s, e, dev), _bits_range(kl, s, e, dev), span) + minval
    return out


def randint_many(keys: np.ndarray, count: int, minval: int, maxval: int,
                 device: "str | torch.device" = "cpu") -> torch.Tensor:
    """``randint_range(key, 0, count, ...)`` for each key of ``keys``
    (u32[B, 2]) -> int64 [B, count]; on the card in one pass (a few
    blocks' draws at a time)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.stack([randint_range(k, 0, count, minval, maxval) for k in keys])
    return _randint_many_device(keys, count, minval, maxval, dev)


def _randint_many_device(keys: np.ndarray, count: int, minval: int, maxval: int, dev: torch.device) -> torch.Tensor:
    span = max(maxval - minval, 1)
    kt = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)).to(dev)
    b = kt.shape[0]
    idx = torch.arange(2, dtype=torch.int64, device=dev).expand(b, 2)
    # split(key, 2) of every key: the counters (0, 0) and (0, 1)
    s1, s2 = threefry2x32_device(kt[:, 0:1], kt[:, 1:2], torch.zeros_like(idx), idx.clone())
    words = []
    for j in (0, 1):
        idx = torch.arange(count, dtype=torch.int64, device=dev).expand(b, count)
        x, y = threefry2x32_device(s1[:, j : j + 1], s2[:, j : j + 1], torch.zeros_like(idx), idx.clone())
        words.append(x.bitwise_xor_(y))
    return _fold(words[0], words[1], span) + minval


def prng_key(seed: int) -> np.ndarray:
    """Raw key of a non-negative seed below 2**63: [seed >> 32, seed & 0xffffffff]."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def key(seed: int) -> np.ndarray:
    """The data of ``jax.random.key(seed)``, a typed key of the default
    threefry2x32 implementation: the raw key of ``seed``."""
    return prng_key(seed)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: the key hashes the counter pair (0, data) ->
    u32[2], or u32[len(data), 2] for an array of ``data``."""
    d = (np.asarray(data, np.int64) & _M).astype(np.uint32).reshape(-1)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros_like(d), d)
    out = np.stack([b1, b2], axis=-1)
    return out if np.ndim(data) else out[0]


def bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """u32 random bits, partitionable form: hash of the element's flat index."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` for an int ``n``: ``ceil(3 ln n /
    ln(2^32 - 1))`` rounds, each splitting the key and sorting stably by 32
    random bits per element -> i32[n]."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        x = x[np.argsort(bits(sub, (n,)), kind="stable")]
    return x


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
    """i32 in [minval, maxval): :func:`randint_range` over the whole shape."""
    shape = tuple(shape)
    return randint_range(key, 0, math.prod(shape), minval, maxval).numpy().astype(np.int32).reshape(shape)
