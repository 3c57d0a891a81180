"""The port's slices end to end on the CPU: LeannBuilder -> LeannSearcher on
the diskann and hnsw tiers, recall against the flat oracle, and the index
interchange with the JAX package in both directions (no weight carry-over:
each package draws its own seeded hash-tiny weights)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

KW = dict(top_k=3, complexity=32, beam_width=4)


def _build(pkg, backend, chunks, prefix):
    kwargs = {"device": "cpu"} if pkg.__name__ == "leann_torch" else {}
    # diskann at one partition on both sides (the JAX package's default is one
    # per device: 8 on the tests' CPU mesh); partitioned builds are compared
    # in test_torch_partition.py
    kwargs.update({"hnsw": {"M": 16}, "diskann": {"graph_degree": 16, "num_partitions": 1}}.get(backend, {}))
    b = pkg.LeannBuilder(backend_name=backend, embedding_model="hash-tiny", max_length=64, **kwargs)
    for c in chunks:
        b.add_text(c)
    b.build_index(prefix)


def _ids(results):
    return [[r.id for r in row] for row in results]


def _recall(pred, truth):
    return float(np.mean([len(set(p) & set(t)) / len(t) for p, t in zip(pred, truth)]))


@pytest.fixture(scope="module", params=["diskann", "hnsw"])
def indexes(request, tmp_path_factory):
    import leann_torch
    import leann_tpu
    from scale_500k import synth_corpus

    backend = request.param
    rng = np.random.default_rng(0)
    chunks = synth_corpus(600, rng)
    q_idx = rng.choice(len(chunks), 48, replace=False)
    queries = [" ".join(chunks[i].split()[:12]) for i in q_idx]
    d = tmp_path_factory.mktemp(f"slice_{backend}")
    paths = {"torch": str(d / "t.leann"), "jax": str(d / "j.leann"), "flat": str(d / "f.leann"),
             "backend": backend}
    _build(leann_torch, backend, chunks, paths["torch"])
    _build(leann_tpu, backend, chunks, paths["jax"])
    _build(leann_torch, "flat", chunks, paths["flat"])
    truth = _ids(leann_torch.LeannSearcher(paths["flat"], device="cpu").search(queries, top_k=3))
    return paths, queries, truth


def test_slice_recall_on_cpu(indexes):
    import leann_torch

    paths, queries, truth = indexes
    got = _ids(leann_torch.LeannSearcher(paths["torch"], device="cpu").search(queries, **KW))
    assert all(len(r) == 3 for r in got)
    assert _recall(got, truth) >= 0.9


def test_same_on_disk_layout(indexes):
    import json

    paths, _, _ = indexes
    mt = json.load(open(paths["torch"] + ".meta.json"))
    mj = json.load(open(paths["jax"] + ".meta.json"))
    assert set(mt) == set(mj)
    for key in ("backend_name", "embedding_model", "embedding_mode", "dimensions", "distance_metric",
                "is_compact", "is_recompute", "max_length", "num_chunks", "version"):
        assert mt[key] == mj[key], key
    assert mt["backend_kwargs"] == mj["backend_kwargs"]
    suffix = f".{paths['backend']}.npz"
    zt = np.load(paths["torch"] + suffix)
    zj = np.load(paths["jax"] + suffix)
    assert set(zt.files) == set(zj.files)
    for f in zt.files:  # the deflated graph's length follows its content
        assert zt[f].dtype == zj[f].dtype and (zt[f].shape == zj[f].shape or f == "neighbors_packed"), f
    if paths["backend"] == "hnsw":
        assert (zt["entries"] == zj["entries"]).all() and int(zt["medoid"]) == int(zj["medoid"])
    if paths["backend"] == "diskann":  # one partition each: the relayout is the identity on both sides
        from leann_torch.storage import load_ids

        assert (zt["entries"] == zj["entries"]).all() and int(zt["medoid"]) == int(zj["medoid"])
        assert load_ids(paths["torch"]) == load_ids(paths["jax"])
        pt, pj = np.load(paths["torch"] + ".partition.npz"), np.load(paths["jax"] + ".partition.npz")
        assert pt["counts"].tolist() == pj["counts"].tolist() == [mt["num_chunks"]]
    for suffix in (".entries.cache.npy", ".tokens.cache.npz", ".ids.json", ".passages.jsonl"):
        assert Path(paths["torch"] + suffix).exists() and Path(paths["jax"] + suffix).exists()


@pytest.mark.parametrize("built_by,searched_by", [("jax", "torch"), ("torch", "jax")])
def test_index_interchange(indexes, built_by, searched_by):
    import leann_torch
    import leann_tpu

    paths, queries, truth = indexes
    native_pkg, native_kw = (leann_torch, {"device": "cpu"}) if built_by == "torch" else (leann_tpu, {})
    other_pkg, other_kw = (leann_torch, {"device": "cpu"}) if searched_by == "torch" else (leann_tpu, {})
    native = _ids(native_pkg.LeannSearcher(paths[built_by], **native_kw).search(queries, **KW))
    other = _ids(other_pkg.LeannSearcher(paths[built_by], **other_kw).search(queries, **KW))
    assert np.mean([set(a) == set(b) for a, b in zip(native, other)]) >= 0.9
    assert abs(_recall(native, truth) - _recall(other, truth)) <= 0.05


def test_default_device_raises_without_cuda(tmp_path):
    import leann_torch

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    for ctor in (lambda: leann_torch.LeannBuilder(backend_name="diskann"), lambda: leann_torch.LeannBuilder(),
                 lambda: leann_torch.LeannSearcher(str(tmp_path / "none.leann"))):
        with pytest.raises(RuntimeError, match="device="):
            ctor()


def test_search_runs_full_f32_and_leaves_the_callers_setting(indexes, monkeypatch):
    """The search's products run in full f32 (no TF32), and neither the
    searcher nor device resolution changes the caller's own matmul setting."""
    import leann_torch
    from leann_torch.backends import common as backend

    seen = []
    for name in ("beam_search_batch_packed", "beam_search_text_batch_packed"):
        orig = getattr(backend, name)

        def spy(*a, _orig=orig, **kw):
            seen.append(torch.get_float32_matmul_precision())
            return _orig(*a, **kw)

        monkeypatch.setattr(backend, name, spy)
    paths, queries, _ = indexes
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        leann_torch.LeannSearcher(paths["torch"], device="cpu").search(queries[:4], **KW)
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_default_backend_is_hnsw(tmp_path):
    import json

    import leann_torch

    b = leann_torch.LeannBuilder(embedding_model="hash-tiny", max_length=32, M=4, efConstruction=16, device="cpu")
    for i in range(40):
        b.add_text(f"passage {i} about topic {i % 5}")
    b.build_index(str(tmp_path / "d.leann"))
    meta = json.load(open(tmp_path / "d.leann.meta.json"))
    assert meta["backend_name"] == "hnsw" and meta["backend_kwargs"] == {"M": 4, "efConstruction": 16}
    assert (tmp_path / "d.leann.hnsw.npz").exists()
    assert {"backend/knn", "backend/prune", "backend/persist"} <= set(b.phase_seconds)


def test_unported_backend_raises():
    """Every backend of the JAX package is registered; what the port still
    lacks of the graph backends raises naming its ROADMAP.md item. The hnsw
    and flat inserts are ported (diskann has none, as in the JAX package)."""
    from leann_torch.registry import get_backend, get_registered_backends

    assert get_registered_backends() == ["diskann", "flat", "hnsw"]
    hnsw = get_backend("hnsw")
    assert [hasattr(get_backend(b), "insert") for b in ("diskann", "flat", "hnsw")] == [False, True, True]
    with pytest.raises(FileNotFoundError):
        hnsw.insert("no-such-index.leann", np.zeros((1, 8), np.float32), device="cpu")
    for backend in ("hnsw", "diskann"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, left for later #10"):
            get_backend(backend).builder(build_sharded=True, device="cpu")
    # LDG partitioning is ported: the builder takes a partition count
    assert get_backend("diskann").builder(num_partitions=4, device="cpu").num_partitions == 4
    # the checkpointed build is ported: the builder takes its directory
    assert hnsw.builder(build_checkpoint_dir="ckpt", device="cpu").build_checkpoint_dir == "ckpt"


def test_import_pulls_in_no_jax():
    code = ("import sys, leann_torch, leann_torch.backends.diskann, leann_torch.backends.flat, "
            "leann_torch.backends.hnsw, leann_torch.repack, leann_torch.backends.diskann.partition; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'leann_tpu'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_or_leann_tpu_in_port_sources():
    """No import of jax or of the JAX package, and no dotted module path into
    it (a string handed to importlib). Slash paths such as
    ``leann_tpu/ops/pallas_topk.py`` stay allowed: the kernels name the TPU
    kernel they replace by file."""
    import re

    banned = re.compile(r"^\s*(import|from)\s+(jax|leann_tpu)\b|\bleann_tpu\.|\bimport_module\(\s*['\"]jax",
                        re.MULTILINE)
    files = [p for p in (REPO / "leann_torch").rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for p in files:
        m = banned.search(p.read_text())
        assert m is None, f"{p.relative_to(REPO)}: {m.group(0)!r}"
