"""leann_torch's contrastive trainer (CPU) against the JAX package's.

The same seeded params and batches go through the port's ``info_nce_loss``
(autograd) and ``jax.value_and_grad`` of the JAX package's, at
``compute_dtype`` float32 and bfloat16, for the prenorm arch (hash-tiny,
tanh GELU) and a tiny BERT (post-LN, erf GELU); five trainer steps are held
against the JAX ``ContrastiveTrainer`` on a 1 x 1 mesh; and the fine-tuning
path (trainer -> ``save_hf_weights`` -> an index from the directory) is run
across the packages.

Tolerances, each from the arithmetic:
  * gradients, relative norm error per leaf: 1e-5 at f32 (both packages sum
    in f32 in another order), 2e-2 at bf16 (each cast rounds the cotangent
    to bf16, in both packages, at different points of the sum);
  * five AdamW steps at f32: losses within 1e-5 relative, dense weights
    within 5e-4 (Adam's update takes a gradient's sign where it is ~0, so
    a few entries move by up to lr); at bf16 the elementwise params do not
    agree (Adam normalises the rounding noise of tiny gradients): losses
    within 1e-3, and probe embeddings of the trained encoders with cosine
    >= 0.999.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from leann_torch.embeddings import encoder as te
from leann_torch.parallel import train as tt
from leann_tpu.embeddings import encoder as je
from leann_tpu.parallel import train as jt

TINY_BERT = te.EncoderConfig(name="tiny-bert", vocab_size=120, dim=32, n_layers=2, n_heads=4, mlp_dim=64,
                             max_len=64, arch="bert")
ARCHS = {"prenorm": te.MODEL_REGISTRY["hash-tiny"], "bert": TINY_BERT}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread, so that a worker
    beside others does not wait on thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, dtype):
    return dataclasses.replace(ARCHS[arch], compute_dtype=dtype)


def _jcfg(cfg):
    return je.EncoderConfig(**dataclasses.asdict(cfg))


def _batch(cfg, seed=0, b=16, tq=16, td=32):
    """Query and passage ids with part-masked rows (every row keeps >= 3
    tokens)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, cfg.vocab_size, (b, tq)).astype(np.int32)
    d = rng.integers(0, cfg.vocab_size, (b, td)).astype(np.int32)
    qm = (np.arange(tq)[None, :] < rng.integers(3, tq + 1, b)[:, None]).astype(np.int32)
    dm = (np.arange(td)[None, :] < rng.integers(3, td + 1, b)[:, None]).astype(np.int32)
    return q, qm, d, dm


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))


def _probe(cfg, params_t, params_j):
    """Both packages' normalized embeddings of a seeded probe batch."""
    ids, mask, _, _ = _batch(cfg, seed=7, b=8)
    et = te.encode_tokens(te.params_to_torch(params_t, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    ej = je.encode_tokens(params_j, jnp.asarray(ids), jnp.asarray(mask), _jcfg(cfg))
    return et.numpy().astype(np.float64), np.asarray(ej, np.float64)


@pytest.mark.parametrize("arch", ["prenorm", "bert"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_gradients_match_jax(arch, dtype, tol):
    cfg = _cfg(arch, dtype)
    tree = te.init_params(cfg)
    batch = _batch(cfg)
    params = tt._trainable(tree, torch.device("cpu"))
    loss_t = tt.info_nce_loss(params, *[torch.from_numpy(x) for x in batch], cfg)
    loss_t.backward()
    loss_j, grads_j = jax.jit(jax.value_and_grad(jt.info_nce_loss), static_argnums=5)(
        jax.tree.map(jnp.asarray, tree), *[jnp.asarray(x) for x in batch], _jcfg(cfg))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= tol * abs(float(loss_j))
    gt = _flat(params)
    gj = _flat(grads_j)
    assert gt.keys() == gj.keys()
    errs = {}
    for name, leaf in gt.items():
        want = _np(gj[name])
        got = _np(leaf.grad) if leaf.grad is not None else np.zeros_like(want)
        scale = np.linalg.norm(want)
        if scale == 0.0:  # a leaf the forward does not read: zero in both
            assert not got.any(), name
            continue
        if name.endswith("/k/b"):
            # exactly zero: a key bias shifts every score of a row alike,
            # and softmax ignores that, so both packages give rounding noise
            assert np.linalg.norm(got) <= 1e-3 * np.linalg.norm(_np(gj[name[:-1] + "w"])), name
            continue
        errs[name] = np.linalg.norm(got - want) / scale
    assert errs and max(errs.values()) <= tol, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("arch", ["prenorm", "bert"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_five_steps_match_jax_trainer(arch, dtype):
    cfg = _cfg(arch, dtype)
    tree = te.init_params(cfg)
    ours = tt.ContrastiveTrainer(cfg, learning_rate=1e-3, params=tree, device="cpu")
    theirs = jt.ContrastiveTrainer(_jcfg(cfg), _mesh(), learning_rate=1e-3, params=tree)
    lt, lj = [], []
    for step in range(5):
        batch = _batch(cfg, seed=step)
        lt.append(ours.train_step(*batch))
        lj.append(theirs.train_step(*batch))
    lt, lj = np.array(lt), np.array(lj)
    assert np.isfinite(lt).all()
    pt, pj = _flat(ours.params), _flat(jax.device_get(theirs.params))
    if dtype == "float32":
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        for name in pt:
            if name.endswith("/w"):
                np.testing.assert_allclose(_np(pt[name]), _np(pj[name]), rtol=0, atol=5e-4, err_msg=name)
    else:
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3)
        et, ej = _probe(cfg, ours.params, jax.device_get(theirs.params))
        cos = (et * ej).sum(1) / (np.linalg.norm(et, axis=1) * np.linalg.norm(ej, axis=1))
        assert cos.min() >= 0.999, cos
    # the weights moved: the steps trained
    assert np.abs(_np(pt["/layers/0/q/w"]) - tree["layers"][0]["q"]["w"]).max() > 1e-4


def test_loss_decreases(tiny_corpus):
    """The JAX package's trainer case (tests/test_parallel.py), on one
    device: 8 steps on prefix -> text pairs of the tiny corpus."""
    enc = te.TorchEncoder("hash-tiny", max_length=16, device="cpu")
    trainer = tt.ContrastiveTrainer(enc.cfg, learning_rate=1e-3, device="cpu")
    texts = [t for t, _ in tiny_corpus][:8]
    queries = [" ".join(t.split()[:4]) for t in texts]
    q_ids, q_mask = enc.tokenize(queries, 16)
    d_ids, d_mask = enc.tokenize(texts, 16)
    losses = [trainer.train_step(q_ids, q_mask, d_ids, d_mask) for _ in range(8)]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_trainer_does_not_write_into_the_callers_tensors():
    cfg = _cfg("prenorm", "float32")
    params = te.params_to_torch(te.init_params(cfg), "cpu")
    before = params["layers"][0]["q"]["w"].clone()
    trainer = tt.ContrastiveTrainer(cfg, learning_rate=1e-3, params=params, device="cpu")
    trainer.train_step(*_batch(cfg))
    assert torch.equal(params["layers"][0]["q"]["w"], before)
    assert not torch.equal(trainer.params["layers"][0]["q"]["w"], before)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A tiny BERT checkpoint directory with no tokenizer files (both
    packages then tokenize with the hash tokenizer at its vocab)."""
    path = str(tmp_path_factory.mktemp("train") / "tiny-bert")
    te.save_hf_weights(te.init_params(TINY_BERT), TINY_BERT, path)
    return path


def test_trainer_fine_tunes_loaded_params(tiny_ckpt):
    """The JAX package's case (tests/test_hf_weights.py): ContrastiveTrainer
    (params=load_hf_weights(dir)) runs a step with a finite loss, moves the
    weights and drops the calibration leaves."""
    params, cfg = te.load_hf_weights(tiny_ckpt)
    params["out_center"] = np.zeros(cfg.dim, np.float32)
    tr = tt.ContrastiveTrainer(cfg, learning_rate=1e-3, params=params, device="cpu")
    assert set(tr.params) == set(tt.TRAINED_KEYS)
    before = tr.params["layers"][0]["q"]["w"].detach().clone()
    rng = np.random.default_rng(0)
    q_ids = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    d_ids = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    ones = np.ones((8, 16), np.int32)
    assert np.isfinite(tr.train_step(q_ids, ones, d_ids, ones))
    assert not torch.equal(before, tr.params["layers"][0]["q"]["w"])


def _fine_tuned(src, dst):
    """A few steps on a loaded checkpoint, written to ``dst``."""
    params, cfg = te.load_hf_weights(src)
    tr = tt.ContrastiveTrainer(cfg, learning_rate=1e-3, params=params, device="cpu")
    for step in range(3):
        tr.train_step(*_batch(cfg, seed=step))
    te.save_hf_weights(tr.params, cfg, dst)
    return tr, cfg


def test_save_then_load_gives_the_trained_tree(tiny_ckpt, tmp_path):
    tr, cfg = _fine_tuned(tiny_ckpt, str(tmp_path / "tuned"))
    loaded, cfg2 = te.load_hf_weights(str(tmp_path / "tuned"))
    assert (cfg2.dim, cfg2.n_layers, cfg2.n_heads, cfg2.mlp_dim, cfg2.vocab_size, cfg2.arch) == (
        cfg.dim, cfg.n_layers, cfg.n_heads, cfg.mlp_dim, cfg.vocab_size, cfg.arch)
    want = _flat(tr.params)
    got = _flat(loaded)
    for name, leaf in want.items():
        if name.startswith("/final_ln"):  # unused by bert; the loader gives identity
            continue
        np.testing.assert_array_equal(got[name], leaf.detach().numpy(), err_msg=name)


def test_jax_index_from_a_port_trained_checkpoint(tiny_ckpt, tmp_path):
    """The port fine-tunes and writes the checkpoint; the JAX package builds
    an index from the directory; both packages search it with the same
    labels."""
    import leann_torch
    import leann_tpu

    ckpt = str(tmp_path / "tuned")
    _fine_tuned(tiny_ckpt, ckpt)
    chunks = [f"passage {i} on topic {i % 7} with words w{i % 13} and w{i % 5} here" for i in range(60)]
    queries = [f"topic {i % 7} with words w{i % 13}" for i in range(0, 60, 6)]
    te._ENCODER_CACHE.clear()
    je._ENCODER_CACHE.clear()
    prefix = str(tmp_path / "idx.leann")
    b = leann_tpu.LeannBuilder(backend_name="diskann", embedding_model=ckpt, max_length=32, graph_degree=8,
                               num_partitions=1)
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)
    assert je.get_encoder(ckpt, max_length=32).loaded_hf  # the trained weights, not a seeded fallback
    assert os.path.exists(prefix + ".calib.npz")
    te._ENCODER_CACHE.clear()
    je._ENCODER_CACHE.clear()
    search = dict(top_k=3, complexity=16, beam_width=2)
    got = leann_torch.LeannSearcher(prefix, device="cpu").search(queries, **search)
    want = leann_tpu.LeannSearcher(prefix).search(queries, **search)
    labels_t = [[r.id for r in row] for row in got]
    labels_j = [[r.id for r in row] for row in want]
    assert np.mean([a == b for a, b in zip(labels_t, labels_j)]) >= 0.9
