"""leann_torch's contrastive trainer on a (dp, tp) mesh against the JAX
package's on the same numpy-seeded params and batches: the port's mesh of 8
CPU shards against the JAX package's 8 virtual CPU devices
(tests/conftest.py). Three steps on a (2, 4) mesh: losses within 1e-5 (f32)
of the port's one-device trainer's (1e-3 at bf16) and, for each arch in
f32, of the JAX trainer's on its (2, 4) mesh (the packages round bf16 at
other places); param_specs the JAX package's tree; the joined tree
save_hf_weights writes."""

import dataclasses

import numpy as np
import pytest
import torch

from leann_torch.embeddings import encoder as te
from leann_torch.parallel import mesh as tm
from leann_torch.parallel import train as tt
from leann_tpu.embeddings import encoder as je
from leann_tpu.parallel import mesh as jm
from leann_tpu.parallel import train as jt

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that a worker beside others does
    not wait on thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_BERT = te.EncoderConfig(name="tiny-bert", vocab_size=120, dim=32, n_layers=2, n_heads=4, mlp_dim=64,
                             max_len=64, arch="bert")
# hash-tiny with 4 heads, so that tp = 4 holds whole heads
ARCHS = {"prenorm": dataclasses.replace(te.MODEL_REGISTRY["hash-tiny"], n_heads=4), "bert": TINY_BERT}


def _batch(cfg, seed=0, b=16, tq=16, td=32):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, cfg.vocab_size, (b, tq)).astype(np.int32)
    d = rng.integers(0, cfg.vocab_size, (b, td)).astype(np.int32)
    qm = (np.arange(tq)[None, :] < rng.integers(3, tq + 1, b)[:, None]).astype(np.int32)
    dm = (np.arange(td)[None, :] < rng.integers(3, td + 1, b)[:, None]).astype(np.int32)
    return q, qm, d, dm


def test_param_specs_match_jax():
    cfg = ARCHS["bert"]
    want = jt.param_specs(je.EncoderConfig(**dataclasses.asdict(cfg)))
    got = tt.param_specs(cfg)
    assert got.keys() == want.keys() and len(got["layers"]) == len(want["layers"]) == cfg.n_layers
    for key in ("tok_emb", "pos_emb"):
        assert got[key] == tuple(want[key])
    for name in ("emb_ln", "final_ln"):
        assert {k: tuple(v) for k, v in want[name].items()} == got[name]
    for lg, lw in zip(got["layers"], want["layers"]):
        assert {m: {k: tuple(v) for k, v in leaf.items()} for m, leaf in lw.items()} == lg


@pytest.mark.parametrize("arch,dtype,tol", [("prenorm", "float32", 1e-5), ("bert", "float32", 1e-5),
                                            ("prenorm", "bfloat16", 1e-3)])
def test_trainer_mesh_losses_match(arch, dtype, tol):
    cfg = dataclasses.replace(ARCHS[arch], compute_dtype=dtype)
    batch = _batch(cfg)
    one = tt.ContrastiveTrainer(cfg, learning_rate=1e-4, device="cpu")
    mesh = tt.ContrastiveTrainer(cfg, tm.make_mesh([("dp", 2), ("tp", 4)], CPU8), 1e-4)
    l_one = [one.train_step(*batch) for _ in range(3)]
    l_mesh = [mesh.train_step(*batch) for _ in range(3)]
    np.testing.assert_allclose(l_mesh, l_one, rtol=tol)
    if dtype == "float32":  # the packages round bf16 at other places: held at f32
        jtr = jt.ContrastiveTrainer(je.EncoderConfig(**dataclasses.asdict(cfg)),
                                    jm.make_mesh([("dp", 2), ("tp", 4)]), 1e-4)
        l_jax = [jtr.train_step(*batch) for _ in range(3)]
        np.testing.assert_allclose(l_mesh, l_jax, rtol=tol)
    assert l_mesh[-1] < l_mesh[0]
    # the whole tree, split leaves joined: what save_hf_weights takes
    whole = mesh.params
    for name in ("q", "o", "fc1", "fc2"):
        assert whole["layers"][0][name]["w"].shape == one.params["layers"][0][name]["w"].shape
        np.testing.assert_allclose(whole["layers"][0][name]["w"].numpy(),
                                   one.params["layers"][0][name]["w"].detach().numpy(), atol=1e-5 if tol < 1e-4 else 1e-3)
    parts = mesh._tree["layers"][0]["q"]["w"]
    assert isinstance(parts, tt.Split) and [p.shape for p in parts.parts] == [(cfg.dim, cfg.dim // 4)] * 4


def test_trainer_mesh_checks_its_layout(tmp_path):
    with pytest.raises(ValueError, match="tp=4 must divide the heads"):
        tt.ContrastiveTrainer(te.MODEL_REGISTRY["hash-tiny"], tm.make_mesh([("dp", 2), ("tp", 4)], CPU8))
    tr = tt.ContrastiveTrainer(TINY_BERT, tm.make_mesh([("dp", 4), ("tp", 2)], CPU8))
    with pytest.raises(ValueError, match="does not split over dp=4"):
        tr.train_step(*_batch(TINY_BERT, b=6))
    tr.train_step(*_batch(TINY_BERT, b=8))
    te.save_hf_weights(tr.params, TINY_BERT, str(tmp_path))
    loaded, _ = te.load_hf_weights(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(loaded["layers"][1]["fc1"]["w"]),
                                  tr.params["layers"][1]["fc1"]["w"].numpy())
