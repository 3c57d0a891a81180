"""The build's environment overrides in leann_torch (ops/graph.py
env_override: LEANN_EXACT_SHARD_BYTES, LEANN_EXACT_QCHUNK,
LEANN_EXACT_QCKPT_SECS, LEANN_PRUNE_EBF_MAX_BYTES, the JAX package's names),
and a sharded k-NN state the port wrote, resumed by the JAX package's
exact_knn_sharded (CPU, numpy-seeded inputs)."""

import json

import numpy as np
import pytest

from leann_torch.ops import graph as tg
from leann_tpu.ops import graph as jg


def _unit(seed, n, d):
    emb = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _clustered(seed, n, d, n_c=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_c, d)).astype(np.float32) * 3
    return centers[rng.integers(0, n_c, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.7


def _dying(monkeypatch, module, after):
    """``module._exact_knn_shard_device`` raising from its ``after + 1``-th
    call; -> the real function."""
    calls = {"n": 0}
    orig = module._exact_knn_shard_device

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] > after:
            raise RuntimeError("simulated crash")
        return orig(*a, **kw)

    monkeypatch.setattr(module, "_exact_knn_shard_device", boom)
    return orig


def _counting(monkeypatch, module, orig):
    calls = {"n": 0}

    def count(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(module, "_exact_knn_shard_device", count)
    return calls


def test_env_override_reads_at_call_time(monkeypatch):
    monkeypatch.delenv("LEANN_EXACT_QCHUNK", raising=False)
    assert tg.env_override("LEANN_EXACT_QCHUNK", tg.EXACT_QCHUNK) == tg.EXACT_QCHUNK
    monkeypatch.setenv("LEANN_EXACT_QCHUNK", "512")
    assert tg.env_override("LEANN_EXACT_QCHUNK", tg.EXACT_QCHUNK) == 512
    monkeypatch.setenv("LEANN_EXACT_QCKPT_SECS", "2.5")
    got = tg.env_override("LEANN_EXACT_QCKPT_SECS", tg.QCKPT_SECS)
    assert got == 2.5 and isinstance(got, float)
    monkeypatch.setenv("LEANN_PRUNE_EBF_MAX_BYTES", "12345")
    assert tg.prune_ebf_max_bytes("cpu") == 12345
    monkeypatch.delenv("LEANN_PRUNE_EBF_MAX_BYTES")
    assert tg.prune_ebf_max_bytes("cpu") == 1 << 62  # the CPU's default: no cap


@pytest.mark.parametrize("shard_rows,qchunk", [(1024, 1024), (2048, 512)])
def test_shard_bytes_and_qchunk_from_the_environment(tmp_path, monkeypatch, shard_rows, qchunk):
    """With neither passed, the variables set the geometry: the state of a
    run killed two passes into its second shard records them, the resumed
    run makes only the passes left, and it gives the uninterrupted
    answer."""
    n, d, k = 4000, 16, 6
    emb = _unit(3, n, d)
    full_i, full_d = tg.exact_knn(emb, k, device="cpu")
    monkeypatch.setenv("LEANN_EXACT_SHARD_BYTES", str(shard_rows * 2 * d))
    monkeypatch.setenv("LEANN_EXACT_QCHUNK", str(qchunk))
    chunks, shards = -(-n // qchunk), -(-n // shard_rows)
    orig = _dying(monkeypatch, tg, chunks + 2)
    with pytest.raises(RuntimeError, match="simulated"):
        tg.exact_knn_sharded(emb, k, checkpoint_dir=str(tmp_path), device="cpu")
    meta = json.load(open(tmp_path / "exknn_state.json"))
    assert (meta["rows_per_shard"], meta["qchunk"], meta["shards_done"]) == (shard_rows, qchunk, 1)
    calls = _counting(monkeypatch, tg, orig)
    got_i, got_d = tg.exact_knn_sharded(emb, k, checkpoint_dir=str(tmp_path), device="cpu")
    assert calls["n"] == (shards - 1) * chunks
    assert (got_i == full_i).all() and np.abs(got_d - full_d).max() < 1e-4


@pytest.mark.parametrize("secs,durable", [("0", 1), ("3600", 0)])
def test_checkpoint_cadence_from_the_environment(tmp_path, monkeypatch, secs, durable):
    """LEANN_EXACT_QCKPT_SECS=0 checkpoints after every chunk: a run killed
    on its third pass inside shard 0 leaves one durable chunk (the depth-1
    pipeline writes chunk i back once chunk i + 1 is launched); at an hour
    it leaves none and the file is not there."""
    n, d, k = 4000, 16, 6
    emb = _unit(4, n, d)
    monkeypatch.setenv("LEANN_EXACT_QCKPT_SECS", secs)
    _dying(monkeypatch, tg, 2)
    with pytest.raises(RuntimeError, match="simulated"):
        tg.exact_knn_sharded(emb, k, qchunk=1024, shard_bytes=1024 * 2 * d, checkpoint_dir=str(tmp_path),
                             device="cpu")
    meta_path = tmp_path / "exknn_state.json"
    if durable:
        meta = json.load(open(meta_path))
        assert (meta["shards_done"], meta["qchunks_done"]) == (0, durable)
    else:
        assert not meta_path.exists()


def test_prune_cap_from_the_environment(monkeypatch):
    """LEANN_PRUNE_EBF_MAX_BYTES=1 sends build_graph on the CPU (no cap by
    default) through the PQ-mode prune, with the graph of the path forced
    by patching both caps (test_torch_build_resume.py's); unset, the
    prune keeps the bf16 matrix."""
    emb = _clustered(1, 1500, 32)
    pq_runs = []
    real = tg._prune_pq_mode
    monkeypatch.setattr(tg, "_prune_pq_mode", lambda *a, **kw: (pq_runs.append(1), real(*a, **kw))[1])
    monkeypatch.delenv("LEANN_PRUNE_EBF_MAX_BYTES", raising=False)
    plain, _ = tg.build_graph(emb, r=8, device="cpu")
    assert pq_runs == []
    monkeypatch.setenv("LEANN_PRUNE_EBF_MAX_BYTES", "1")
    by_env, med_env = tg.build_graph(emb, r=8, device="cpu")
    assert pq_runs == [1]
    monkeypatch.delenv("LEANN_PRUNE_EBF_MAX_BYTES")
    monkeypatch.setattr(tg, "exact_knn_max_n", lambda d, k, device: 500)
    monkeypatch.setattr(tg, "prune_ebf_max_bytes", lambda device: 1)
    forced, med_forced = tg.build_graph(emb, r=8, device="cpu")
    assert pq_runs == [1, 1]
    assert np.array_equal(by_env, forced) and med_env == med_forced
    assert not np.array_equal(by_env, plain)


def test_resume_a_state_the_port_wrote_in_jax(tmp_path, monkeypatch):
    """A port run killed inside its second shard leaves its running state at
    the JAX package's padded row count; the JAX package's exact_knn_sharded
    at the same geometry (query_block 256, tile 512) resumes it, runs only
    the three unfinished shards' four chunks each, and gives the
    uninterrupted answer."""
    n, d, k = 4000, 16, 6
    emb = _unit(6, n, d)
    full_i, full_d = tg.exact_knn(emb, k, device="cpu")
    kw = dict(query_block=256, qchunk=1024, shard_bytes=1024 * 2 * d)
    _dying(monkeypatch, tg, 6)  # 4 chunks a shard: inside the second shard
    with pytest.raises(RuntimeError, match="simulated"):
        tg.exact_knn_sharded(emb, k, checkpoint_dir=str(tmp_path), device="cpu", **kw)
    meta = json.load(open(tmp_path / "exknn_state.json"))
    assert (meta["shards_done"], meta["qchunks_done"], meta["rows_per_shard"], meta["qchunk"]) == (1, 0, 1024, 1024)
    state = np.load(tmp_path / "exknn_state_i.npy", mmap_mode="r")
    assert state.shape == (jg._bucket_rows(n, 256), k) == (4096, k)
    assert (state[n:] == -1).all()
    calls = _counting(monkeypatch, jg, jg._exact_knn_shard_device)
    got_i, got_d = jg.exact_knn_sharded(emb, k, tile=512, approx_recall=1.0, checkpoint_dir=str(tmp_path), **kw)
    assert calls["n"] == 3 * 4
    assert (got_i == full_i).all()
    assert np.abs(got_d - full_d).max() < 1e-4
    assert not (tmp_path / "exknn_state.json").exists()
