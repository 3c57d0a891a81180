"""The CUDA kernels of leann_torch against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it also runs on a machine without JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from leann_torch.ops.distance import pad_features
from leann_torch.ops.flat_topk import flat_topk
from leann_torch.ops.knn_panel import knn_panel, panel_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    torch.set_float32_matmul_precision("highest")  # the plain versions' products in full f32
    return torch.device("cuda")


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a.tolist(), b.tolist())])


@pytest.mark.parametrize("metric,k,d", [("l2", 3, 384), ("cosine", 64, 384), ("mips", 17, 33)])
def test_flat_topk_matches_plain(cuda, metric, k, d):
    rng = np.random.default_rng(3)
    e = torch.from_numpy(rng.standard_normal((5000, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((70, d)).astype(np.float32))
    if metric == "cosine":
        e, q = e / e.norm(dim=1, keepdim=True), q / q.norm(dim=1, keepdim=True)
    ebf, en = e.to(torch.bfloat16), e.square().sum(1)
    # the kernel takes features padded to a multiple of 16; the plain version any width
    ids, dists = flat_topk(pad_features(q).to(cuda), pad_features(ebf).to(cuda), en.to(cuda), 4900, k, metric)
    pi, pd = flat_topk(q, ebf, en, 4900, k, metric)  # CPU tensors: the plain version
    assert _overlap(ids.cpu().numpy(), pi.numpy()) >= 0.95
    np.testing.assert_allclose(dists.cpu().numpy(), pd.numpy(), rtol=1e-2, atol=1e-2)
    assert (ids.cpu().numpy() < 4900).all() and (ids.cpu().numpy() >= 0).all()


@pytest.mark.parametrize("d,n_real", [(384, 3000), (385, 2900)])
def test_knn_panel_matches_plain(cuda, d, n_real):
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal((3000, d)).astype(np.float32))
    ebf, norms = panel_inputs(emb)
    ids, dists = knn_panel(ebf.to(cuda), norms.to(cuda), 64, q_start=100, q_count=1000, n_real=n_real)
    pi, pd = knn_panel(ebf, norms, 64, q_start=100, q_count=1000, n_real=n_real)
    ids = ids.cpu().numpy()
    assert _overlap(ids, pi.numpy()) >= 0.98
    assert not (ids == (np.arange(1000) + 100)[:, None]).any()
    assert ((ids >= 0) & (ids < n_real)).all()
    np.testing.assert_allclose(dists.cpu().numpy(), pd.numpy(), rtol=1e-4, atol=1e-2)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    e = torch.randn(100, 32, device=cuda)
    q = torch.randn(4, 32, device=cuda)
    with pytest.raises(TypeError):
        flat_topk(q, e, e.square().sum(1), 100, 3, "l2")  # corpus must be bf16
    with pytest.raises(ValueError):
        flat_topk(q, e.bfloat16(), e.square().sum(1), 100, 65, "l2")  # k > 64
    with pytest.raises(ValueError):
        flat_topk(q.cpu(), e.bfloat16(), e.square().sum(1), 100, 3, "l2")  # mixed devices
    with pytest.raises(ValueError):
        flat_topk(q[:, :31].contiguous(), e[:, :31].bfloat16().contiguous(), None, 100, 3, "mips")  # D % 16
    with pytest.raises(ValueError):
        knn_panel(e[:, :31].bfloat16().contiguous(), e.square().sum(1), 8)  # unpadded D
    ebf, norms = panel_inputs(e)
    with pytest.raises(ValueError):
        knn_panel(ebf, norms, 65)
    with pytest.raises(ValueError):
        knn_panel(ebf, norms, 8, q_start=90, q_count=20)
