"""leann_torch's threefry against jax.random, and the seeded encoder
weights it draws against the JAX package's (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from leann_torch.embeddings import seeded


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**31 - 1])
def test_key_split_bits_exact(seed):
    key = jax.random.PRNGKey(seed)
    kn = seeded.prng_key(seed)
    assert np.array_equal(np.asarray(key), kn)
    assert np.array_equal(np.asarray(jax.random.split(key, 8)), seeded.split(kn, 8))
    assert np.array_equal(np.asarray(jax.random.bits(key, (3, 1000))), seeded.bits(kn, (3, 1000)))


@pytest.mark.parametrize("hi", [32768, 2048, 1000])
def test_randint_exact(hi):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.randint(key, (256, 32), 0, hi, dtype=jnp.int32))
    assert np.array_equal(want, seeded.randint(seeded.prng_key(11), (256, 32), 0, hi))


def test_normal_close():
    # erfinv is the same f32 polynomial as XLA's; numpy's log1p differs in
    # the last bits, hence a tolerance rather than equality
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.normal(key, (4096, 96), jnp.float32))
    got = seeded.normal(seeded.prng_key(5), (4096, 96))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def test_init_params_hash_tiny_all_leaves():
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    cfg_j = je.MODEL_REGISTRY["hash-tiny"]
    want = dict(_leaves(je.init_params(cfg_j)))
    got = dict(_leaves(te.init_params(te.MODEL_REGISTRY["hash-tiny"])))
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6, err_msg=name)


def test_init_params_hash_minilm_tok_emb_and_layer0():
    from leann_torch.embeddings import encoder as te
    from leann_tpu.embeddings import encoder as je

    want = je.init_params(je.MODEL_REGISTRY["hash-minilm"])
    got = te.init_params(te.MODEL_REGISTRY["hash-minilm"])
    np.testing.assert_allclose(got["tok_emb"], np.asarray(want["tok_emb"]), rtol=0, atol=1e-6)
    for name, w in _leaves(want["layers"][0]):
        g = dict(_leaves(got["layers"][0]))[name]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


def test_out_center_close():
    from leann_torch.embeddings.encoder import TorchEncoder
    from leann_tpu.embeddings.encoder import JaxEncoder

    want = np.asarray(JaxEncoder("hash-tiny").params["out_center"])
    got = TorchEncoder("hash-tiny", device="cpu").params["out_center"].numpy()
    # same probe ids (bit-exact randint) through bf16 forwards of two
    # frameworks; the mean over 256 probes averages the rounding away
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
