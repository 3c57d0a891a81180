"""leann_torch's encoder against the JAX package's on the same weights (CPU)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leann_torch.embeddings import encoder as te
from leann_tpu.embeddings import encoder as je


@pytest.fixture(scope="module")
def tiny():
    enc = je.JaxEncoder("hash-tiny")
    tree = jax.tree_util.tree_map(np.asarray, enc.params)
    return enc, tree


def _batch(seed, b=16, t=32, vocab=2048):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, (b, t)).astype(np.int32)
    lens = rng.integers(3, t + 1, b)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_encode_tokens_matches(tiny, dtype, atol):
    enc, tree = tiny
    ids, mask = _batch(0)
    cfg_j = replace(enc.cfg, compute_dtype=dtype)
    cfg_t = replace(te.MODEL_REGISTRY["hash-tiny"], compute_dtype=dtype)
    want = np.asarray(je.encode_tokens(enc.params, jnp.asarray(ids), jnp.asarray(mask), cfg_j))
    params = te.params_from_jax(tree, device="cpu")
    got = te.encode_tokens(params, torch.as_tensor(ids), torch.as_tensor(mask), cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_encode_tokens_bert_arch_and_u16_ids(tiny):
    enc, tree = tiny
    ids, mask = _batch(1)
    cfg = replace(enc.cfg, arch="bert", compute_dtype="float32")
    want = np.asarray(je.encode_tokens(enc.params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    params = te.params_from_jax(tree, device="cpu")
    cfg_t = replace(te.MODEL_REGISTRY["hash-tiny"], arch="bert", compute_dtype="float32")
    # token stores hold u16 rows; the forward widens them before the gather
    got = te.encode_tokens(params, torch.from_numpy(ids.astype(np.uint16)), torch.as_tensor(mask), cfg_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_params_from_jax_round_trip(tiny):
    _, tree = tiny
    params = te.params_from_jax(tree, device="cpu")
    back = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    flat_a, def_a = jax.tree_util.tree_flatten(tree)
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert np.array_equal(a, b)


def test_encode_bucketing_matches_jax_encoder():
    texts = [f"passage number {i} about " + " ".join(["topic"] * (i % 9)) for i in range(21)]
    want = je.JaxEncoder("hash-tiny").encode(texts, batch_size=16)
    got = te.TorchEncoder("hash-tiny", device="cpu").encode(texts, batch_size=16)
    assert got.shape == want.shape == (21, 64)
    # own seeded weights on each side (no carry-over), bf16 forward
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device="):
        te.TorchEncoder("hash-tiny")
    with pytest.raises(RuntimeError, match="device="):
        te.get_encoder("hash-tiny")
