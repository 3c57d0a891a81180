"""Device selection shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``. There is no
fallback: a caller who wants the CPU asks for it, and a CUDA request on a
machine without CUDA raises instead of silently running elsewhere.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


# torch's matmul precision is one flag for the whole process, so the scopes
# of all threads are counted together: the first to enter saves the
# caller's setting, the last to leave restores it
_F32_LOCK = threading.Lock()
_F32_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def f32_matmuls():
    """Full-f32 products (no TF32) inside the block, the caller's setting
    restored after it, also after an exception. Search distances and the
    build's prune and PQ distances are held against an f32 oracle; TF32
    would flip near-ties. Scopes entered from several threads at once (a
    ``BatchedSearcher`` worker beside a direct search) keep full f32 until
    the last one leaves; the flag is process-wide, so another thread's own
    products that overlap a scope run in full f32 too. Usable as a
    decorator."""
    with _F32_LOCK:
        if _F32_STATE["depth"] == 0:
            _F32_STATE["saved"] = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
        _F32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_STATE["depth"] -= 1
            if _F32_STATE["depth"] == 0:
                torch.set_float32_matmul_precision(_F32_STATE["saved"])
