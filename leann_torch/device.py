"""Device selection, the card's memory and the products every entry point
of the port shares.

Entry points take ``device=`` and default to ``"cuda"``. There is no
fallback: a caller who wants the CPU asks for it, and a CUDA request on a
machine without CUDA raises instead of silently running elsewhere.

No module of the port sets torch's float32 matmul precision or its TF32 /
reduced-precision flags: they are process-wide, and a caller's thread owns
them. Products whose value must not depend on them go through
:func:`matmul`.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def card_memory(dev: "str | torch.device") -> Tuple[int, int]:
    """(free, total) bytes of the card ``dev``: the port's one memory query.
    ``free`` is what ``mem_get_info`` reports free plus what this process's caching
    allocator holds unused (it hands that out again); other processes'
    memory counts as used. The build's modes read ``total`` only, so an
    index built twice from the same inputs is the same index whoever else
    is on the card; ``free`` sizes chunks whose size does not change a
    result, and is checked by :func:`require_room`."""
    dev = torch.device(dev)
    free, total = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free + cached), int(total)


def require_room(dev: "str | torch.device", need: int, what: str, other: "str | None") -> None:
    """Raise unless the card ``dev`` has ``need`` bytes free for ``what``,
    the mode that its total memory chose. No mode changes because another
    process holds memory: the message names the free and total bytes and
    ``other``, what selects the other mode, or says that nothing does
    (``other`` None). No check off the card."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return
    free, total = card_memory(dev)
    if need > free:
        how = f"or select the other mode with {other}" if other else "no variable selects another mode"
        raise RuntimeError(
            f"{what} needs {need:,} bytes on {dev}, which has {free:,} free of {total:,}: other processes "
            f"hold the rest. The mode follows the card's total memory, not what is free: free the card; {how}")


def bf16_parts(x: torch.Tensor) -> List[torch.Tensor]:
    """An f32 tensor -> [hi, mid, lo], bf16 tensors whose sum is ``x`` for
    every normal value (8 + 8 + 8 significant bits cover f32's 24); a bf16
    tensor is its own single part."""
    if x.dtype == torch.bfloat16:
        return [x]
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return [hi, mid, (r - mid.float()).to(torch.bfloat16)]


def _mm_parts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N], or a [S, M, K] @ b [S, K, N]; each operand f32
    or bf16 -> f32, computed so that no setting of torch's precision flags
    changes it.

    On cuda: the leading cross products of the operands' parts (part indices
    summing to at most 2: six for two f32 operands, three for one f32 and
    one bf16, one for two bf16) summed in f32 by one bf16 GEMM with f32
    output over the parts laid side by side along K, which those flags do
    not reach. The smallest products come first: the GEMM adds along K in
    order, so the large hi x hi terms do not swallow them.

    On the CPU, which has no bf16 x bf16 -> f32 product: two bf16 operands
    multiply as f32 (exact under every setting, which may only reorder the
    sums); otherwise the product is taken in f64, which no flag reaches, and
    rounded to f32 (three parts side by side would cost the CPU six f32
    products and their copies)."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.device.type != "cuda":
        if a.dtype == b.dtype == torch.bfloat16:
            return mm(a.float(), b.float())
        return mm(a.double(), b.double()).float()
    pa, pb = bf16_parts(a), bf16_parts(b)
    pairs = sorted(((i, j) for i in range(len(pa)) for j in range(len(pb)) if i + j <= 2),
                   key=lambda ij: -(ij[0] + ij[1]))
    a_cat = torch.cat([pa[i] for i, _ in pairs], dim=-1) if len(pairs) > 1 else pa[0]
    b_cat = torch.cat([pb[j] for _, j in pairs], dim=-2) if len(pairs) > 1 else pb[0]
    return mm(a_cat, b_cat, out_dtype=torch.float32)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_parts(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_parts(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm_parts(a.transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` -> f32, the same whatever torch's float32 matmul precision
    or TF32 / bf16-reduction flags are set to. An f32 operand is taken in
    full (on the card as three bf16 parts, within about 2^-22 of the f64
    product relative to |a| @ |b|; on the CPU in f64); a bf16 operand is
    exact as it is, so a product of two bf16 operands is one bf16 product
    with f32 sums. Shapes: ``a [..., M, K]`` with ``b [K, N]``, or ``a [...,
    M, K]`` with ``b [..., K, N]`` of the same leading dims. Differentiable
    (the gradients are products of the same kind)."""
    if b.dim() == 2:
        lead = a.shape[:-1]
        return _Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(*lead, b.shape[-1])
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul: leading dims differ, {tuple(a.shape)} @ {tuple(b.shape)}")
    lead = a.shape[:-2]
    out = _Matmul.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    return out.reshape(*lead, *out.shape[-2:])
