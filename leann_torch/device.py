"""Device selection shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``. There is no
fallback: a caller who wants the CPU asks for it, and a CUDA request on a
machine without CUDA raises instead of silently running elsewhere.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def f32_matmuls():
    """Full-f32 products (no TF32) inside the block, the caller's setting
    restored after it. Search distances and the build's prune and PQ
    distances are held against an f32 oracle; TF32 would flip near-ties.
    Usable as a decorator."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
