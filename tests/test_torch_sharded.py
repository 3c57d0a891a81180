"""The column-sharded exact k-NN of leann_torch (ops/graph.py
exact_knn_sharded, exact_knn_rows, and kernel B2's external-query entry and
running-state merge through their plain versions on the CPU) against the
JAX package's and against the port's one-pass exact_knn, on the same
numpy-seeded inputs."""

import json

import numpy as np
import pytest
import torch

from leann_torch.ops import graph as tg
from leann_torch.ops import knn_panel as kp
from leann_tpu.ops import graph as jg


def _unit(seed, n, d):
    emb = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _paths_seen(monkeypatch):
    """Record which query path each (chunk x shard) pass took."""
    seen = []
    orig = tg._exact_knn_shard_device

    def spy(*a, **kw):
        seen.append(a[-1])  # q_in_shard
        return orig(*a, **kw)

    monkeypatch.setattr(tg, "_exact_knn_shard_device", spy)
    return seen


def test_sharded_matches_jax_and_one_pass(monkeypatch):
    n, d, k = 5000, 32, 8
    emb = _unit(0, n, d)
    one_i, one_d = tg.exact_knn(emb, k, device="cpu")
    seen = _paths_seen(monkeypatch)
    # 2048-row shards: 3 of them; 512-row chunks: some lie inside the slab
    # being swept (sliced from it), the others are uploaded
    got_i, got_d = tg.exact_knn_sharded(emb, k, qchunk=512, shard_bytes=2048 * 2 * d, device="cpu")
    assert len(seen) == 3 * 10 and any(seen) and not all(seen)
    assert (got_i == one_i).all()
    assert np.abs(got_d - one_d).max() < 1e-4
    ref_i, ref_d = jg.exact_knn_sharded(emb, k, query_block=256, tile=512, qchunk=1024,
                                        shard_bytes=512 * 2 * d, approx_recall=1.0)
    assert (got_i == ref_i).all()
    assert np.abs(got_d - ref_d).max() < 1e-4


def test_f16_host_matrix():
    """An f16 host matrix (the large-build input) lands within cast noise of
    the f32 answer, as in the JAX package's own test."""
    n, d, k = 3000, 32, 8
    emb = _unit(1, n, d)
    i1, _ = tg.exact_knn(emb, k, device="cpu")
    i2, _ = tg.exact_knn_sharded(emb.astype(np.float16), k, qchunk=1024, shard_bytes=512 * 2 * d, device="cpu")
    assert (i1 == i2).mean() > 0.9


def _dying(monkeypatch, after):
    calls = {"n": 0}
    orig = tg._exact_knn_shard_device

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] > after:
            raise RuntimeError("simulated crash")
        return orig(*a, **kw)

    monkeypatch.setattr(tg, "_exact_knn_shard_device", boom)
    return orig


@pytest.mark.parametrize("where", ["between_shards", "mid_shard"])
def test_resume_after_a_crash(tmp_path, monkeypatch, where):
    """A run killed between shards resumes at the first unfinished shard; one
    killed inside shard 0, with a checkpoint after every chunk, resumes at
    the last durable chunk (the depth-1 pipeline writes chunk i back only
    once chunk i + 1 is launched, so a crash on the third pass leaves one
    chunk durable). Both give the uninterrupted answer and remove their
    state at the end."""
    n, d, k = 4000, 16, 6
    emb = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    kw = dict(qchunk=1024, shard_bytes=1024 * 2 * d, device="cpu")  # 4 shards x 4 chunks
    full_i, full_d = tg.exact_knn_sharded(emb, k, **kw)
    if where == "mid_shard":
        monkeypatch.setattr(tg, "QCKPT_SECS", 0.0)
    orig = _dying(monkeypatch, 6 if where == "between_shards" else 2)
    with pytest.raises(RuntimeError, match="simulated"):
        tg.exact_knn_sharded(emb, k, checkpoint_dir=str(tmp_path), **kw)
    meta = json.load(open(tmp_path / "exknn_state.json"))
    if where == "between_shards":
        assert meta["shards_done"] >= 1
    else:
        assert meta["shards_done"] == 0 and meta["qchunks_done"] == 1
    calls = {"n": 0}

    def count(*a, **kwargs):
        calls["n"] += 1
        return orig(*a, **kwargs)

    monkeypatch.setattr(tg, "_exact_knn_shard_device", count)
    got_i, got_d = tg.exact_knn_sharded(emb, k, checkpoint_dir=str(tmp_path), **kw)
    if where == "mid_shard":
        assert calls["n"] == 15  # 16 passes, one durable
    assert (got_i == full_i).all()
    assert np.abs(got_d - full_d).max() < 1e-4
    assert not (tmp_path / "exknn_state.json").exists()
    assert not (tmp_path / "exknn_state_d.npy").exists()


@pytest.mark.parametrize("geometry", ["same", "other"])
def test_resume_a_state_the_jax_package_wrote(tmp_path, monkeypatch, caplog, geometry):
    """A JAX run killed after its first shard leaves its running state; the
    port resumes it where shard_bytes and qchunk give the same geometry
    (only the unfinished shards run) and otherwise discards it with a
    warning and starts over. Both give the uninterrupted answer."""
    n, d, k = 4000, 16, 6
    emb = _unit(6, n, d)
    full_i, full_d = tg.exact_knn(emb, k, device="cpu")
    calls = {"jax": 0, "port": 0}
    orig_j = jg._exact_knn_shard_device

    def dying(*a, **kw):
        calls["jax"] += 1
        if calls["jax"] > 6:  # 4 chunks a shard: inside the second shard
            raise RuntimeError("simulated crash")
        return orig_j(*a, **kw)

    monkeypatch.setattr(jg, "_exact_knn_shard_device", dying)
    with pytest.raises(RuntimeError, match="simulated"):
        jg.exact_knn_sharded(emb, k, query_block=256, tile=512, qchunk=1024, shard_bytes=1024 * 2 * d,
                             approx_recall=1.0, checkpoint_dir=str(tmp_path))
    meta = json.load(open(tmp_path / "exknn_state.json"))
    assert meta["shards_done"] == 1 and meta["rows_per_shard"] == 1024 and meta["qchunk"] == 1024
    orig_t = tg._exact_knn_shard_device

    def count(*a, **kw):
        calls["port"] += 1
        return orig_t(*a, **kw)

    monkeypatch.setattr(tg, "_exact_knn_shard_device", count)
    qchunk = 1024 if geometry == "same" else 512
    with caplog.at_level("WARNING", logger=tg.logger.name):
        got_i, got_d = tg.exact_knn_sharded(emb, k, qchunk=qchunk, shard_bytes=1024 * 2 * d,
                                            checkpoint_dir=str(tmp_path), device="cpu")
    discarded = any("discarding the state" in r.getMessage() for r in caplog.records)
    if geometry == "same":
        assert calls["port"] == 3 * 4 and not discarded
    else:
        assert calls["port"] == 4 * 8 and discarded
    assert (got_i == full_i).all()
    assert np.abs(got_d - full_d).max() < 1e-4
    assert not (tmp_path / "exknn_state.json").exists()


@pytest.mark.parametrize("include_self", [False, True])
def test_exact_knn_rows_matches_full_pass_and_jax(include_self):
    n, d, k = 3000, 32, 8
    emb = _unit(3, n, d)
    rows = np.sort(np.random.default_rng(4).choice(n, 64, replace=False))
    got_i, got_d = tg.exact_knn_rows(emb, rows, k, shard_bytes=512 * 2 * d, include_self=include_self,
                                     device="cpu")
    ref_i, ref_d = jg.exact_knn_rows(emb, rows, k, shard_bytes=512 * 2 * d, tile=512, include_self=include_self)
    assert (got_i == ref_i).all()
    assert np.abs(got_d - ref_d).max() < 1e-4
    if include_self:
        assert (got_i[:, 0] == rows).all()
    else:
        full_i, full_d = tg.exact_knn(emb, k, device="cpu")
        assert (got_i == full_i[rows]).all()
        assert np.abs(got_d - full_d[rows]).max() < 1e-4


def test_ext_entry_plain_version_ids_and_self():
    """knn_panel_ext on a slab of the corpus returns global ids, never a
    query's own row, and equals knn_panel on the same rows when the slab is
    the whole corpus."""
    emb = torch.from_numpy(np.random.default_rng(5).standard_normal((600, 40)).astype(np.float32))
    ebf, norms = kp.panel_inputs(emb)
    whole = kp.knn_panel(ebf, norms, 12, q_start=100, q_count=200)
    ext = kp.knn_panel_ext(ebf[100:300], norms[100:300], ebf, norms, 12, col_id0=0, q_id0=100)
    assert torch.equal(whole[0], ext[0]) and torch.equal(whole[1], ext[1])
    # a slab of columns 256 .. 511: ids come out global, self excluded
    ids, dists = kp.knn_panel_ext(ebf[250:270], norms[250:270], ebf[256:512], norms[256:512], 5, col_id0=256,
                                  q_id0=250)
    assert ((ids >= 256) & (ids < 512)).all()
    assert not (ids == torch.arange(250, 270)[:, None]).any()


@pytest.mark.parametrize("k", [4, 100, 300])
def test_running_state_merge_plain(k):
    """topk_merge over [S, 2, k] equals lax.top_k over the concatenation
    (the JAX package's merge), empty (-1) entries last."""
    rng = np.random.default_rng(k)
    s = 20
    vals = np.sort(rng.random((s, 2, k)).astype(np.float32), axis=2)
    ids = rng.permutation(s * 2 * k).reshape(s, 2, k).astype(np.int32)
    vals[:, 0, k // 2 :] = 3.4e38
    ids[:, 0, k // 2 :] = -1
    got_i, got_d = kp.topk_merge(torch.from_numpy(vals), torch.from_numpy(ids))
    cat_v = np.concatenate([vals[:, 0], vals[:, 1]], axis=1)
    cat_i = np.concatenate([ids[:, 0], ids[:, 1]], axis=1)
    order = np.argsort(cat_v, axis=1, kind="stable")[:, :k]
    assert np.array_equal(got_d.numpy(), np.take_along_axis(cat_v, order, 1))
    assert np.array_equal(got_i.numpy(), np.take_along_axis(cat_i, order, 1))
