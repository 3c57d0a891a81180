"""leann_torch and torch's process-wide precision flags (CPU).

The port sets none of them: torch's float32 matmul precision and its TF32 /
reduced-precision switches are one setting for the whole process, owned by
the caller. Products whose value must not depend on them go through
``leann_torch.device.matmul``: on the card it splits each f32 operand into
three bf16-exact parts, whose products no setting changes; on the CPU it
takes such a product in f64. The split's arithmetic is held here in f64,
and on the card by tests/test_torch_gpu.py.
"""

import threading

import numpy as np
import pytest
import torch

import leann_torch
from leann_torch import BatchedSearcher, LeannSearcher
from leann_torch.device import bf16_parts, matmul

CHUNKS = [f"passage {i} about topic {i % 7} with words w{i % 13} and w{i % 5}" for i in range(60)]
QUERIES = [f"topic {i % 7} with words w{i % 13}" for i in range(0, 60, 6)]
KW = dict(top_k=2, complexity=8, beam_width=2)
BUILD_KW = {"diskann": dict(graph_degree=8, num_partitions=1), "hnsw": dict(M=4, efConstruction=16)}


def _build(backend, prefix):
    b = leann_torch.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=32, device="cpu",
                                 **BUILD_KW[backend])
    for c in CHUNKS:
        b.add_text(c)
    b.build_index(prefix)


def _from_threads(bs, queries, n_threads=4):
    out = [None] * len(queries)

    def worker(w):
        for i in range(w, len(queries), n_threads):
            out[i] = bs.search(queries[i], timeout=120, **KW)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in out)
    return out


@pytest.mark.parametrize("backend", ["diskann", "hnsw"])
def test_no_precision_setter_is_called(backend, tmp_path, monkeypatch):
    """Every setter of torch's precision flags raises while a build, a
    search, an update (hnsw) and a BatchedSearcher serving 4 threads run."""

    def refuse(*a, **kw):
        raise AssertionError("a precision flag was set")

    names = [n for n in dir(torch._C) if n.startswith("_set")
             and any(k in n.lower() for k in ("tf32", "precision", "reduced", "reduction"))]
    assert "_set_float32_matmul_precision" in names and "_set_cublas_allow_tf32" in names
    for n in names:
        monkeypatch.setattr(torch._C, n, refuse)
    monkeypatch.setattr(torch, "set_float32_matmul_precision", refuse)
    with pytest.raises(AssertionError, match="precision flag"):
        torch.backends.cuda.matmul.allow_tf32 = True

    prefix = str(tmp_path / "idx.leann")
    _build(backend, prefix)
    direct = LeannSearcher(prefix, device="cpu").search(QUERIES, **KW)
    assert len(direct) == len(QUERIES)
    if backend == "hnsw":
        u = leann_torch.LeannBuilder.from_index(prefix, device="cpu")
        for i in range(8):
            u.add_text(f"new passage {i} about topic {i % 7}")
        u.update_index(prefix)
    with BatchedSearcher(prefix, max_batch=4, max_wait_ms=1.0, device="cpu") as bs:
        batched = _from_threads(bs, QUERIES)
    assert all(len(r) == KW["top_k"] for r in batched)


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_split_product_is_f32_under_every_setting(precision):
    """Each part is bf16-exact and the parts sum to the operand; the six
    leading cross products of the parts are within 2^-22 |a| @ |b| of the
    f64 product; and ``matmul`` is within that bound for f32 x f32, f32 x
    bf16 and batched operands, whatever the caller set."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((48, 384)).astype(np.float32) * 3)
    b = torch.from_numpy(rng.standard_normal((384, 40)).astype(np.float32))
    pa, pb = bf16_parts(a), bf16_parts(b)
    for parts, whole in ((pa, a), (pb, b)):
        assert len(parts) == 3 and all(p.dtype == torch.bfloat16 for p in parts)
        assert torch.equal(sum(p.double() for p in parts), whole.double())
    six = sum(pa[i].double() @ pb[j].double() for i in range(3) for j in range(3) if i + j <= 2)
    exact = a.double() @ b.double()
    assert bool(((six - exact).abs() <= 2.0 ** -22 * (a.double().abs() @ b.double().abs())).all())
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        cases = [(a, b), (a, b.to(torch.bfloat16)), (a.reshape(4, 12, 384), b),
                 (a.reshape(4, 12, 384), b.flip(0).reshape(4, 96, 40).repeat(1, 4, 1))]
        for x, y in cases:
            got = matmul(x, y)
            assert got.dtype == torch.float32
            ref = x.double() @ y.double()
            bound = 2.0 ** -22 * (x.double().abs() @ y.double().abs())
            assert bool(((got.double() - ref).abs() <= bound).all()), (tuple(x.shape), y.dtype)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)


def test_split_product_gradients_are_f32():
    """The product's gradients are products of the same kind: within f32
    rounding of the plain f64 gradients."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    (matmul(a, b) * g).sum().backward()
    ga = g.double() @ b.detach().double().T
    gb = a.detach().double().T @ g.double()
    np.testing.assert_allclose(a.grad.double().numpy(), ga.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b.grad.double().numpy(), gb.numpy(), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def hnsw_index(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("precision") / "idx.leann")
    _build("hnsw", prefix)
    return prefix


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_callers_setting_survives_searches_and_a_failed_batch(hnsw_index, precision, monkeypatch):
    """A caller's setting is the same after a direct search, after batches,
    and after a batch that raised; the batcher's worker sees it too (it is
    the process's one setting, and nothing changes it)."""
    from leann_torch.backends import common as backend

    seen = []
    orig = backend.beam_search_text_batch_packed

    def spy(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return orig(*a, **kw)

    monkeypatch.setattr(backend, "beam_search_text_batch_packed", spy)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        direct = LeannSearcher(hnsw_index, device="cpu")
        want = direct.search(QUERIES[:4], **KW)
        assert torch.get_float32_matmul_precision() == precision
        with BatchedSearcher(direct, max_batch=4, max_wait_ms=1.0) as bs:
            got = _from_threads(bs, QUERIES[:4])
            assert torch.get_float32_matmul_precision() == precision
            with pytest.raises(Exception):
                bs.search("anything", timeout=120, top_k=2, pruning_strategy="not-a-strategy")
            assert torch.get_float32_matmul_precision() == precision
            bs.search(QUERIES[0], timeout=120, **KW)
        assert torch.get_float32_matmul_precision() == precision
        assert seen and all(p == precision for p in seen)
        assert len(got) == len(want) == 4
    finally:
        torch.set_float32_matmul_precision(prev)
