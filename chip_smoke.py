#!/usr/bin/env python3
"""Smoke run of leann_torch on one NVIDIA GPU: kernels, parity, main path.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure exits non-zero before the
final line):
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions; builds both CUDA kernels with nvcc (build/leann_torch/) and
     prints ptxas's registers / spills and, from `cuobjdump -sass`, how many
     wgmma (HGMMA) and TMA load (UTMALDG) instructions each library holds.
  2. flat top-k kernel (csrc/flat_topk.cu) against its plain PyTorch version
     on the card: q f32[64, 384] against a bf16[100000, 384] corpus,
     k in {3, 5, 10, 16, 64, 128, 256}, metrics l2 and cosine (id overlap >=
     0.95, distances within rtol 1e-2). Above k = 64 the kernel keeps its
     lists in shared memory (64-row blocks).
  3. k-NN panel kernel (csrc/knn_panel.cu) against its plain version: every
     row of a 100000 x 384 corpus at k = 64 (the diskann build's launch) and
     k = 128 (the HNSW build's: M = 32, efConstruction = 128), and 1024 rows
     of a 385-wide corpus whose last 1000 rows are padding at k = 64 (id
     overlap >= 0.98, no self match, no padding row).
     Phases 2-3 time each kernel and each library call as device time: the
     summed time of the CUDA kernels one call launches, from torch.profiler
     over 10 calls (`kernel_ms`, `library_ms`); `call_ms` is the wall time of
     the wrapper between CUDA events, host work included. Two launches at
     the main path's shape must give bit-identical ids and distances.
  4. main path: 100,000 synthetic chunks -> LeannBuilder(diskann,
     hash-minilm, max_length=128, graph_degree=32).build_index, a flat index
     over the same chunks as the exact oracle, then 64 queries through
     LeannSearcher.search (top_k=3, complexity=128, beam_width=4), once to
     warm and once timed. Fails if recall@3 < 0.80 or if either kernel was
     not launched on this path.
  5. HNSW path, the default backend: LeannBuilder(hash-minilm,
     max_length=128) with M = 32, efConstruction = 128, cosine, compact,
     recompute, over the same 100,000 chunks; the same 64 queries through
     LeannSearcher.search (top_k=3, complexity=64, beam_width=8, prune_ratio
     left to the auto-prune at N >= 50,000), once to warm and once timed,
     scored against phase 4's flat oracle; mean hops and exact distances
     per query from one more batch through ops/beam_search. Fails if
     recall@3 < 0.80 or if the k-NN panel kernel was not launched.
  6. the kernels line: per kernel and path its launches on that path (each
     path's counts set to 0 just before it and read just after), its device
     time and call time, its plain version's and a library call's time at
     that path's shapes, and its bound on the card.
The script uses only the wrappers' public calls and the build module, so a
copy of it also times an older tree of the repo the same way.
The last line is {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def synth_corpus(n, rng):
    """Hierarchical topical corpus (themes > subtopics > sibling groups):
    siblings share a 20-word core, so each query has a few clearly relevant
    chunks, as in real RAG data. Same draws as benchmarks/scale_500k.py."""
    vocab = np.array([f"w{i}" for i in range(50000)])
    n_topics = max(64, n // 48)
    n_themes = max(8, n_topics // 16)
    theme_words = rng.integers(0, len(vocab), size=(n_themes, 600))
    theme_of_topic = rng.integers(0, n_themes, size=n_topics)
    topic_words = np.take_along_axis(
        theme_words[theme_of_topic], rng.integers(0, 600, size=(n_topics, 100)), axis=1
    )
    chunks = []
    gid = 0
    while len(chunks) < n:
        t = int(rng.integers(0, n_topics))
        core = np.concatenate([
            vocab[topic_words[t, rng.integers(0, 100, 12)]],
            vocab[theme_words[theme_of_topic[t], rng.integers(0, 600, 4)]],
            np.array([f"g{gid}a", f"g{gid}b", f"g{gid}c", f"g{gid}d"]),
        ])
        for _ in range(int(rng.integers(2, 5))):
            if len(chunks) >= n:
                break
            i = len(chunks)
            extra = np.concatenate([
                vocab[topic_words[t, rng.integers(0, 100, 6)]],
                vocab[rng.integers(0, len(vocab), 2)],
                np.array([f"d{i}x", f"d{i}y"]),
            ])
            words = np.concatenate([core, extra])
            rng.shuffle(words)
            chunks.append(" ".join(words))
        gid += 1
    return chunks


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean wall time of ``fn`` between CUDA events over ``reps`` calls after
    one warm-up: the host's work in the call included."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0) if us is None else us


def device_ms(torch, fn, reps: int = 10):
    """Summed device time of the CUDA kernels ``fn`` launches, per call, and
    the same by kernel name: torch.profiler over ``reps`` calls after one
    warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and _device_us(e) > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + _device_us(e) / 1e3 / reps
    if not by_kernel:
        fail("torch.profiler recorded no device time")
    parts = {}  # names shortened for printing only; kernels that share a prefix add up
    for key, ms in by_kernel.items():
        parts[key[:60]] = parts.get(key[:60], 0.0) + ms
    return sum(by_kernel.values()), parts


def sass_counts(path, opcodes=("HGMMA", "UTMALDG")):
    """How often each opcode occurs in a library's SASS (`cuobjdump -sass`),
    or None where the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(path)], capture_output=True, text=True, timeout=120).stdout
    ops = []
    for line in out.splitlines():  # "/*0080*/  [@P0] OPCODE.MODS operands ;"
        tok = line.split()
        if len(tok) > 2 and tok[0].startswith("/*") and tok[0].endswith("*/"):
            ops.append(tok[2] if tok[1].startswith("@") else tok[1])
    return {op: sum(o.split(".")[0] == op for o in ops) for op in opcodes}


def bound(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def overlap(a, b) -> float:
    a, b = a.cpu().numpy().tolist(), b.cpu().numpy().tolist()
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def phase_flat_topk(torch, dev, rng):
    from leann_torch.ops.distance import flat_search
    from leann_torch.ops.flat_topk import flat_topk

    b, n, d = 64, 100_000, 384
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    e32 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    qc = q / q.norm(dim=1, keepdim=True)
    e32c = e32 / e32.norm(dim=1, keepdim=True)
    main = None
    for metric in ("l2", "cosine"):
        qm, em = (q, e32) if metric == "l2" else (qc, e32c)
        e = em.to(torch.bfloat16).contiguous()
        en = em.square().sum(1).contiguous()
        for k in (3, 5, 10, 16, 64, 128, 256):  # 3: the oracle's; 5: search's default top_k
            ik, dk = flat_topk(qm, e, en, n, k, metric)
            ip, dp = flat_search(e, qm, n, k, metric, en=en)
            torch.cuda.synchronize()
            ov = overlap(ik, ip)
            rel = float(((dk - dp).abs() / dp.abs().clamp_min(1e-6)).max())
            err = float((dk - dp).abs().max())
            ok = ov >= 0.95 and torch.allclose(dk, dp, rtol=1e-2, atol=1e-2) and int(ik.max()) < n
            ik2, dk2 = flat_topk(qm, e, en, n, k, metric)
            same = bool(torch.equal(ik, ik2) and torch.equal(dk, dk2))  # deterministic
            qb = qm.to(torch.bfloat16)

            def kernel():
                return flat_topk(qm, e, en, n, k, metric)

            (k_ms, k_parts), c_ms = device_ms(torch, kernel), cuda_ms(torch, kernel)
            p_ms = cuda_ms(torch, lambda: flat_search(e, qm, n, k, metric, en=en), reps=3)
            if metric == "l2":
                lib = lambda: torch.topk(2.0 * (qb @ e.T).float() - en, k)  # noqa: E731
            else:
                lib = lambda: torch.topk(qb @ e.T, k)  # noqa: E731
            l_ms = device_ms(torch, lib)[0]
            n_bytes = n * d * 2 + b * d * 4 + (n * 4 if metric == "l2" else 0) + b * k * 8
            b_ms, b_by = bound(n_bytes, 2.0 * b * n * d)
            row = {"phase": "flat_topk", "metric": metric, "k": k, "shape": [b, n, d], "overlap": ov,
                   "max_rel_err": rel, "max_abs_err": err, "deterministic": same, "kernel_ms": k_ms,
                   "kernel_parts_ms": k_parts, "call_ms": c_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "ok": bool(ok and same)}
            emit(row)
            if not ok:
                fail(f"flat_topk disagrees with its plain version: {row}")
            if not same:
                fail(f"flat_topk gave different results in two launches: {row}")
            if metric == "cosine" and k == 3:  # the oracle's own call on the main path
                main = row
    return main


def phase_knn_panel(torch, dev, rng):
    """-> {k: row} of the full-corpus launches (k = 64: diskann, 128: hnsw)."""
    from leann_torch.ops.knn_panel import knn_panel, knn_panel_plain, panel_inputs

    n = 100_000
    main = {}
    for d, q_start, q_count, n_real, k in ((384, 0, n, n, 64), (385, 4096, 1024, n - 1000, 64),
                                           (384, 0, n, n, 128)):
        emb = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        emb = emb / emb.norm(dim=1, keepdim=True)
        ebf, norms = panel_inputs(emb)
        ik, dk = knn_panel(ebf, norms, k, q_start, q_count, n_real)

        def plain():
            return knn_panel_plain(ebf, norms, k, q_start, q_count, n_real)

        ip, dp = plain()
        torch.cuda.synchronize()
        ov = overlap(ik, ip)
        err = float((dk - dp).abs().max())
        self_hits = int((ik == (torch.arange(q_count, device=dev) + q_start)[:, None]).sum())
        pad_hits = int((ik >= n_real).sum())
        ok = ov >= 0.98 and self_hits == 0 and pad_hits == 0 and int((ik < 0).sum()) == 0
        ik2, dk2 = knn_panel(ebf, norms, k, q_start, q_count, n_real)
        same = bool(torch.equal(ik, ik2) and torch.equal(dk, dk2))  # deterministic
        del ik2, dk2

        def kernel():
            return knn_panel(ebf, norms, k, q_start, q_count, n_real)

        (k_ms, k_parts), c_ms = device_ms(torch, kernel), cuda_ms(torch, kernel, reps=3 if q_count > 4096 else 10)
        p_ms = cuda_ms(torch, plain, reps=1)

        def lib():  # one matmul + topk over the same [q_count, n] panel, in 1024-row blocks
            for s in range(q_start, q_start + q_count, 1024):
                qq = ebf[s : s + 1024]
                torch.topk(2.0 * (qq @ ebf[:n_real].T).float() - norms[:n_real], k)

        l_ms = device_ms(torch, lib)[0]
        n_bytes = n * d * 2 + n * 4 + q_count * k * 8
        b_ms, b_by = bound(n_bytes, 2.0 * q_count * n_real * d)
        row = {"phase": "knn_panel", "shape": [q_count, n, d], "n_real": n_real, "k": k, "overlap": ov,
               "max_abs_err": err, "self_hits": self_hits, "pad_hits": pad_hits, "deterministic": same,
               "kernel_ms": k_ms, "kernel_parts_ms": k_parts, "call_ms": c_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b_ms,
               "bound_by": b_by, "ok": bool(ok and same)}
        emit(row)
        if not ok:
            fail(f"knn_panel disagrees with its plain version: {row}")
        if not same:
            fail(f"knn_panel gave different results in two launches: {row}")
        if q_count == n:  # a build's own launch: all rows, D = 384
            main[k] = row
        del emb, ebf, norms, ik, dk, ip, dp
        torch.cuda.empty_cache()
    return main


def search_profile(torch, run) -> dict:
    """One extra search batch under torch.profiler: wall time, the summed
    device time of its kernels (one stream, so their busy time), the idle
    share, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):  # host ops: their kernels are listed apart
            continue
        dev_us = _device_us(evt)
        if dev_us > 0:
            kernels.append((dev_us / 1e3, evt.count, evt.key[:80]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
            "n_kernel_launches": sum(k[1] for k in kernels),
            "top_kernels": [{"ms": ms, "count": n, "name": name} for ms, n, name in kernels[:10]]}


def phase_main_path(torch, workdir: str):
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.ops.knn_panel import knn_panel
    from leann_torch.storage import index_all_in_bytes

    rng = np.random.default_rng(0)
    t0 = time.time()
    chunks = synth_corpus(100_000, rng)
    q_idx = rng.choice(len(chunks), 64, replace=False)
    queries = [" ".join(chunks[i].split()[:12]) for i in q_idx]
    corpus_s = time.time() - t0

    flat_topk.launches = 0
    knn_panel.launches = 0
    prefix = os.path.join(workdir, "s100k.leann")
    oracle_prefix = os.path.join(workdir, "s100k_flat.leann")
    builder = LeannBuilder(backend_name="diskann", embedding_model="hash-minilm", max_length=128,
                           graph_degree=32)
    for c in chunks:
        builder.add_text(c)
    builder.build_index(prefix)
    build_phases = dict(builder.phase_seconds)
    oracle = LeannBuilder(backend_name="flat", embedding_model="hash-minilm", max_length=128)
    for c in chunks:
        oracle.add_text(c)
    oracle.build_index(oracle_prefix)

    searcher = LeannSearcher(prefix)
    kw = dict(top_k=3, complexity=128, beam_width=4)
    searcher.search(queries, **kw)  # warm
    torch.cuda.synchronize()
    t = time.time()
    got = searcher.search(queries, **kw)
    torch.cuda.synchronize()
    search_s = time.time() - t
    truth = LeannSearcher(oracle_prefix).search(queries, top_k=3)
    launches = {"flat_topk": flat_topk.launches, "knn_panel": knn_panel.launches}
    profile = search_profile(torch, lambda: searcher.search(queries, **kw))

    if len(got) != 64 or any(len(r) != 3 or not all(np.isfinite(x.score) for x in r) for r in got):
        fail("diskann search did not return 3 finite results for each of 64 queries")
    if len(truth) != 64 or any(len(r) != 3 for r in truth):
        fail("flat oracle did not return 3 results for each query")
    recall = float(np.mean([len({x.id for x in a} & {x.id for x in b}) / 3 for a, b in zip(got, truth)]))
    row = {"phase": "main_path", "n_chunks": len(chunks), "model": "hash-minilm", "backend": "diskann",
           "corpus_s": corpus_s, "build_s": build_phases, "flat_build_s": dict(oracle.phase_seconds),
           "recall_at_3": recall, "search_ms_per_query": search_s * 1e3 / len(queries),
           "all_in_bytes": index_all_in_bytes(prefix), "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    emit({"phase": "search_profile", **profile})
    if recall < 0.80:
        fail(f"recall@3 {recall:.4f} below the 0.80 sanity floor")
    for name, cnt in launches.items():
        if cnt < 1:
            fail(f"kernel {name} was not launched on the main path")
    return launches, (chunks, queries, truth)


def phase_hnsw_path(torch, workdir: str, chunks, queries, truth):
    """The default backend over phase 4's chunks, scored against its oracle."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.device import f32_matmuls
    from leann_torch.ops.beam_search import beam_search_text_batch
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.ops.knn_panel import knn_panel
    from leann_torch.storage import index_all_in_bytes

    prefix = os.path.join(workdir, "s100k_hnsw.leann")
    torch.cuda.reset_peak_memory_stats()
    flat_topk.launches = 0
    knn_panel.launches = 0
    builder = LeannBuilder(embedding_model="hash-minilm", max_length=128)  # hnsw: M = 32, efConstruction = 128
    for c in chunks:
        builder.add_text(c)
    builder.build_index(prefix)
    build_phases = dict(builder.phase_seconds)

    searcher = LeannSearcher(prefix)
    kw = dict(top_k=3, complexity=64, beam_width=8)  # prune_ratio=None: the auto-prune applies at N >= 50,000
    searcher.search(queries, **kw)  # warm
    torch.cuda.synchronize()
    t = time.time()
    got = searcher.search(queries, **kw)
    torch.cuda.synchronize()
    search_s = time.time() - t
    launches = {"flat_topk": flat_topk.launches, "knn_panel": knn_panel.launches}
    profile = search_profile(torch, lambda: searcher.search(queries, **kw))

    # hops and exact distances per query: the same batch once more through
    # the search program, which returns them per lane
    be = searcher.backend
    with f32_matmuls():
        cfg, params = be._make_cfg(3, complexity=64, beam_width=8)
        q_ids, q_mask = be._encoder().tokenize(queries)
        dev = be.device
        _, _, steps, n_exact = beam_search_text_batch(torch.from_numpy(q_ids).to(dev),
                                                      torch.from_numpy(q_mask).to(dev), be._graph_data(), cfg,
                                                      params)

    if len(got) != 64 or any(len(r) != 3 or not all(np.isfinite(x.score) for x in r) for r in got):
        fail("hnsw search did not return 3 finite results for each of 64 queries")
    recall = float(np.mean([len({x.id for x in a} & {x.id for x in b}) / 3 for a, b in zip(got, truth)]))
    row = {"phase": "hnsw_path", "n_chunks": len(chunks), "model": "hash-minilm", "backend": "hnsw",
           "M": 32, "efConstruction": 128, "knn_k": 128, "prune_keep": cfg.prune_keep,
           "traversal": cfg.traversal, "build_s": build_phases, "recall_at_3": recall,
           "search_ms_per_query": search_s * 1e3 / len(queries),
           "mean_steps": float(steps.float().mean()), "mean_n_exact": float(n_exact.float().mean()),
           "all_in_bytes": index_all_in_bytes(prefix), "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    emit({"phase": "hnsw_search_profile", **profile})
    if recall < 0.80:
        fail(f"hnsw recall@3 {recall:.4f} below the 0.80 sanity floor")
    if launches["knn_panel"] < 1:
        fail("kernel knn_panel was not launched on the hnsw path")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (REPO / "leann_torch" / "__init__.py").exists():
        fail(f"leann_torch is not beside {Path(__file__).name}: run from a checkout of the repo")
    sys.path.insert(0, str(REPO))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    print(card, flush=True)

    from leann_torch.ops import cuda_build

    build_s = cuda_build.build(["flat_topk", "knn_panel"])
    sass = {name: sass_counts(cuda_build._lib_path(name)) for name in ("flat_topk", "knn_panel")}
    emit({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s,
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                    for k, v in cuda_build.BUILD_LOGS.items()},
          "sass": sass})
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")  # the plain versions' products in full f32
    rng = np.random.default_rng(1234)
    flat_row = phase_flat_topk(torch, dev, rng)
    knn_rows = phase_knn_panel(torch, dev, rng)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as workdir:
        launches = {}
        launches["diskann"], oracle = phase_main_path(torch, workdir)
        launches["hnsw"] = phase_hnsw_path(torch, workdir, *oracle)

    kernels = []
    for name, path, row, src, replaces in (
        ("flat_topk", "diskann", flat_row, "leann_torch/csrc/flat_topk.cu", "leann_tpu/ops/pallas_topk.py:32"),
        ("knn_panel", "diskann", knn_rows[64], "leann_torch/csrc/knn_panel.cu", "leann_tpu/ops/pallas_knn.py:45"),
        ("knn_panel", "hnsw", knn_rows[128], "leann_torch/csrc/knn_panel.cu", "leann_tpu/ops/pallas_knn.py:45"),
    ):
        kernels.append({"name": name, "path": path, "k": row["k"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[path][name],
                        "launches_by_path": {p: c[name] for p, c in launches.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "call_ms": row["call_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "sass": sass[name]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
