#!/usr/bin/env python3
"""Smoke run of leann_torch on one NVIDIA GPU: kernels, parity, main path.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure exits non-zero before the
final line):
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions; builds both CUDA kernels with nvcc and the LDG partitioner
     with the host compiler (build/leann_torch/, all at once) and prints
     ptxas's registers / spills and, from `cuobjdump -sass`, how many wgmma
     (HGMMA) and TMA load (UTMALDG) instructions each kernel library holds.
  2. flat top-k kernel (csrc/flat_topk.cu) against its plain PyTorch version
     on the card: q f32[64, 384] against a bf16[100000, 384] corpus,
     k in {3, 5, 10, 16, 64, 128, 256, 257, 512}, metrics l2 and cosine (id
     overlap >= 0.95, distances within rtol 1e-2; above k = 256 id overlap
     1.0 and errors <= 1e-5, absolute for cosine, relative for l2). Above
     k = 64 the kernel keeps its lists in shared memory (64-row blocks),
     above k = 256 in device memory.
  3. k-NN panel kernel (csrc/knn_panel.cu) against its plain version: every
     row of a 100000 x 384 corpus at k = 64 (the diskann build's launch),
     k = 128 (the HNSW build's: M = 32, efConstruction = 128), k = 257 and
     512 (the HNSW build's at M = 64, efConstruction = 512), and 1024 rows
     of a 385-wide corpus whose last 1000 rows are padding at k = 64 (id
     overlap >= 0.98, no self match, no padding row; above k = 256 id
     overlap >= 0.99999 and max abs error <= 1e-5).
     Phases 2-3 time each kernel and each library call as device time: the
     summed time of the CUDA kernels one call launches, from torch.profiler
     over 10 calls (`kernel_ms`, `library_ms`); each kernel's records must
     number a multiple of the calls, else the profile is taken again, and
     the run fails after three. `call_ms` is the wall time of the wrapper
     between CUDA events, host work included. Two launches at the main
     path's shape must give bit-identical ids and distances.
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
  6. beyond the card's memory, the k-NN: 1,048,576 seeded unit vectors at
     D = 384, k = 64: exact_knn in one card-resident pass against
     exact_knn_sharded with 4 column shards of 262,144 rows and query chunks
     of 131,072 (each chunk is sliced from its own shard's slab and uploaded
     for the others): ids and distances identical; then exact_knn_rows on
     1,024 sampled rows against the first pass's rows and against the plain
     version, at k = 64 and at k = 512. The regime past the card starts near
     30M rows at this width; the phase runs the same code at 1M with the
     shard budget passed in (an exact pass at 30M is O(N^2), about an hour).
  7. beyond the card's memory, the path: phase 4's chunks through
     LeannBuilder(diskann, build_checkpoint_dir=...) with exact_knn_max_n
     and prune_ebf_max_bytes set low, so that the sharded k-NN (4 shards)
     and the PQ-mode prune run (as the JAX package's tests force them):
     ckpt_knn.npy identical to phase 4's exact_knn candidates, recall@3
     against phase 4's oracle (floor 0.80); a second build_index with the
     same directory resumes (k-NN and prune phases under 1 s, the same
     graph); a flat search at top_k = 512 through LeannSearcher; then phase
     4's index with token_residency="host" against the device-resident
     search (same labels, distances within 1e-5), and adaptive search on
     the diskann and hnsw indexes against the plain searches (same labels):
     at adaptive_steps=8, and at a cap inside the uncapped run's per-lane
     step counts (its median), so that some lanes keep their first pass's
     results and the others run again; ms per query and escalated lanes
     for each.
  8. the index lifecycle, on phase 4 and 5's corpus and queries: (a) 256
     new chunks inserted by LeannBuilder.from_index -> update_index
     (insert_batch_size=128: two batches) into a copy of phase 5's hnsw
     index and of phase 4's flat oracle; the updated flat index against a
     flat index built whole over the 100,256 chunks (same labels, scores
     within 1e-6) on the 64 old queries and 64 new ones (12-word prefixes
     of inserted chunks), and hnsw recall@3 on both sets against the
     updated oracle (floor 0.80); update seconds, rows repaired, the entry
     pool and all-in bytes before and after. (b) phase 4's chunk embeddings
     (compute_embeddings) through build_index_from_embeddings with diskann
     at phase 4's settings and num_partitions=4: k-NN candidates identical
     to phase 4's, recall@3 (floor 0.80), partition counts summing to N,
     LDG seconds and edge locality; then repack_index and unrelabel_index
     on a copy (the partitioned index refuses the unrelabel, as in the JAX
     package; the copy is set to one partition first): recall@3 within
     0.01. (c) the same embeddings as f16 with no texts through
     build_index_from_embeddings on hnsw: f16 embeddings in the npz,
     is_recompute false, recall@3 through the stored traversal (floor
     0.80). Each path's kernels (B1 on the updated oracle, B2 at k = 64 and
     128 on these embeddings) are checked against their plain versions and
     timed.
  9. the kernels line: per kernel, path and k its launches on that path
     (each path's counts set to 0 just before it and read just after), its
     device time and call time, its plain version's and a library call's
     time at that path's shapes, and its bound on the card.
The script uses only the wrappers' public calls and the build module, so a
copy of it also times an older tree of the repo the same way.
The last line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
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


# seconds of idle time before a profile's calls: grown when a profile loses
# records, and kept for the next
_PROFILE_PAD = [0.0]


def device_ms(torch, fn, reps: int = 10, attempts: int = 4):
    """Summed device time of the CUDA kernels ``fn`` launches, per call, and
    the same by kernel name: torch.profiler over ``reps`` calls after one
    warm-up -> (ms, ms by kernel, {attempts, pad_s}). Every call launches the same
    kernels, so each kernel's count of records must be a multiple of
    ``reps``. The profiler can lose the records of the first kernels of a
    profile, more often late in a long process: every loss seen so far was
    at the start of the window (the first kept record a fraction of a
    millisecond after the first launch, the last one ending well inside the
    window). A profile that lost records is printed, with the offsets of its
    kernels from the host events around them, and taken again after twice
    the idle time before its calls; after ``attempts`` the run fails: no
    other clock stands in for device time."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        pad = _PROFILE_PAD[0]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_kernel, counts = {}, {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA") and _device_us(e) > 0:
                by_kernel[e.key] = by_kernel.get(e.key, 0.0) + _device_us(e) / 1e3 / reps
                counts[e.key[:60]] = counts.get(e.key[:60], 0) + e.count
        if by_kernel and all(c % reps == 0 for c in counts.values()):
            parts = {}  # names shortened for printing only; kernels that share a prefix add up
            for key, ms in by_kernel.items():
                parts[key[:60]] = parts.get(key[:60], 0.0) + ms
            return sum(by_kernel.values()), parts, {"attempts": attempt, "pad_s": pad}
        evts = prof.events()
        launches = [e.time_range for e in evts if "LaunchKernel" in e.name]
        syncs = [e.time_range for e in evts if "Synchronize" in e.name]
        kernels = [e.time_range for e in evts if str(e.device_type).endswith("CUDA")]
        emit({"phase": "profiler_lost_records", "attempt": attempt, "pad_s": pad, "reps": reps, "records": counts,
              "launch_records": len(launches),
              "first_kernel_after_first_launch_ms": (min(k.start for k in kernels) - launches[0].start) / 1e3
              if kernels and launches else None,
              "last_kernel_end_after_sync_end_ms": (max(k.end for k in kernels) - syncs[-1].end) / 1e3
              if kernels and syncs else None})
        _PROFILE_PAD[0] = max(0.5, 2 * pad)
    fail(f"torch.profiler lost kernel records in {attempts} profiles of {reps} calls: {counts}")


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
    main = {}
    for metric in ("l2", "cosine"):
        qm, em = (q, e32) if metric == "l2" else (qc, e32c)
        e = em.to(torch.bfloat16).contiguous()
        en = em.square().sum(1).contiguous()
        # 3: the oracle's; 5: search's default top_k; above 256 the lists in device memory
        for k in (3, 5, 10, 16, 64, 128, 256, 257, 512):
            ik, dk = flat_topk(qm, e, en, n, k, metric)
            ip, dp = flat_search(e, qm, n, k, metric, en=en)
            torch.cuda.synchronize()
            ov = overlap(ik, ip)
            rel = float(((dk - dp).abs() / dp.abs().clamp_min(1e-6)).max())
            err = float((dk - dp).abs().max())
            ok = ov >= 0.95 and torch.allclose(dk, dp, rtol=1e-2, atol=1e-2) and int(ik.max()) < n
            if k > 256:  # the device-memory instance is held tighter
                ok = ok and ov == 1.0 and (err if metric == "cosine" else rel) <= 1e-5
            ik2, dk2 = flat_topk(qm, e, en, n, k, metric)
            same = bool(torch.equal(ik, ik2) and torch.equal(dk, dk2))  # deterministic
            qb = qm.to(torch.bfloat16)

            def kernel():
                return flat_topk(qm, e, en, n, k, metric)

            (k_ms, k_parts, k_att), c_ms = device_ms(torch, kernel), cuda_ms(torch, kernel)
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
                   "kernel_parts_ms": k_parts, "profile": k_att, "call_ms": c_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "ok": bool(ok and same)}
            emit(row)
            if not ok:
                fail(f"flat_topk disagrees with its plain version: {row}")
            if not same:
                fail(f"flat_topk gave different results in two launches: {row}")
            if metric == "cosine" and k in (3, 512):  # the oracle's calls: top-3 on the main path, top-512
                main[k] = row
    return main


def phase_knn_panel(torch, dev, rng):
    """-> {k: row} of the full-corpus launches (k = 64: diskann, 128: hnsw)."""
    from leann_torch.ops.knn_panel import knn_panel, knn_panel_plain, panel_inputs

    n = 100_000
    main = {}
    for d, q_start, q_count, n_real, k in ((384, 0, n, n, 64), (385, 4096, 1024, n - 1000, 64),
                                           (384, 0, n, n, 128), (384, 0, n, n, 257), (384, 0, n, n, 512)):
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
        if k > 256:  # the device-memory instance is held tighter
            ok = ok and ov >= 0.99999 and err <= 1e-5
        ik2, dk2 = knn_panel(ebf, norms, k, q_start, q_count, n_real)
        same = bool(torch.equal(ik, ik2) and torch.equal(dk, dk2))  # deterministic
        del ik2, dk2

        def kernel():
            return knn_panel(ebf, norms, k, q_start, q_count, n_real)

        k_ms, k_parts, k_att = device_ms(torch, kernel, reps=3 if k > 256 else 10)
        c_ms = cuda_ms(torch, kernel, reps=3 if q_count > 4096 else 10)
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
               "kernel_ms": k_ms, "kernel_parts_ms": k_parts, "profile": k_att, "call_ms": c_ms,
               "plain_ms": p_ms,
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
    from leann_torch.ops import graph
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
    knn_seen = {}
    real_exact_knn = graph.exact_knn

    def recording_exact_knn(*a, **kw):  # keeps the build's candidates for phase 7; launches nothing itself
        knn_seen["ids"], dists = real_exact_knn(*a, **kw)
        return knn_seen["ids"], dists

    graph.exact_knn = recording_exact_knn
    try:
        builder.build_index(prefix)
    finally:
        graph.exact_knn = real_exact_knn
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
    main = {"chunks": chunks, "queries": queries, "truth": truth, "prefix": prefix, "oracle": oracle_prefix,
            "knn_ids": knn_seen["ids"], "recall": recall, "kw": kw}
    return launches, main


def phase_hnsw_path(torch, workdir: str, main):
    """The default backend over phase 4's chunks, scored against its oracle."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.device import f32_matmuls
    from leann_torch.ops.beam_search import beam_search_text_batch
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.ops.knn_panel import knn_panel
    from leann_torch.storage import index_all_in_bytes

    chunks, queries, truth = main["chunks"], main["queries"], main["truth"]
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
    main.update(hnsw_prefix=prefix, hnsw_kw=kw, hnsw_recall=recall)
    return launches


def timed_once(torch, fn):
    """-> (``fn()``, its wall time in ms between CUDA events): one call, so
    a plain version that takes seconds at a path's full shape is both the
    check's reference and its timed run."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def timed_row(torch, kernel, p_ms: float, lib, n_bytes: float, flops: float, reps: int = 3) -> dict:
    """A kernel's device and call time, beside its plain version's time
    ``p_ms`` on the same inputs, a library call's time, and its bound on the
    card."""
    k_ms, k_parts, k_att = device_ms(torch, kernel, reps=reps)
    c_ms = cuda_ms(torch, kernel, reps=reps)
    l_ms = device_ms(torch, lib, reps=reps)[0]
    b_ms, b_by = bound(n_bytes, flops)
    return {"kernel_ms": k_ms, "kernel_parts_ms": k_parts, "profile": k_att, "call_ms": c_ms,
            "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def ext_row(torch, kp, q, qn, c, cn, k, col_id0, q_id0, reps: int = 3) -> dict:
    """knn_panel_ext at one (query rows x column slab) shape: checked against
    its plain version on every query row, and timed."""
    s_rows, d = q.shape
    m = c.shape[0]
    ik, dk = kp.knn_panel_ext(q, qn, c, cn, k, m, col_id0, q_id0)
    (ip, dp), p_ms = timed_once(torch, lambda: kp.knn_panel_ext_plain(q, qn, c, cn, k, m, col_id0, q_id0))
    ov = overlap(ik, ip)
    err = float((dk - dp).abs().max())
    del ip, dp

    def lib():  # one matmul + topk per 1024 query rows over the slab
        for s in range(0, s_rows, 1024):
            torch.topk(2.0 * (q[s : s + 1024] @ c.T).float() - cn, k)

    row = timed_row(torch, lambda: kp.knn_panel_ext(q, qn, c, cn, k, m, col_id0, q_id0), p_ms, lib,
                    s_rows * (d * 2 + 4) + m * (d * 2 + 4) + s_rows * k * 8, 2.0 * s_rows * m * d, reps)
    return {"shape": [s_rows, m, d], "k": k, "overlap": ov, "max_abs_err": err, **row}


def merge_row(torch, kp, vals, ids) -> dict:
    """topk_merge of [S, L, k] lists: checked against its plain version
    (identical), and timed."""
    s_rows, lists, k = vals.shape
    ik, dk = kp.topk_merge(vals, ids)
    ip, dp = kp.topk_merge_plain(vals, ids)
    torch.cuda.synchronize()
    same = bool(torch.equal(ik, ip) and torch.equal(dk, dp))
    row = timed_row(torch, lambda: kp.topk_merge(vals, ids), cuda_ms(torch, lambda: kp.topk_merge_plain(vals, ids), 3),
                    lambda: torch.topk(vals.reshape(s_rows, lists * k), k, largest=False),
                    s_rows * lists * k * 8 + s_rows * k * 8, 0.0, reps=10)
    return {"shape": [s_rows, lists, k], "k": k, "identical": same,
            "max_abs_err": float((dk - dp).abs().max()), **row}


def _counts(counters) -> dict:
    return {c.__name__: c.launches for c in counters}


def _reset(counters) -> None:
    for c in counters:
        c.launches = 0


def phase_beyond_card_knn(torch, dev, seed: int, n: int = 1 << 20, rows_per_shard: int = 1 << 18,
                          qchunk: int = 1 << 17, n_sampled: int = 1024):
    """Phase 6 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch.ops import graph
    from leann_torch.ops import knn_panel as kp

    d, k = 384, 64
    counters = (kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    rng = np.random.default_rng(seed)
    t = time.time()
    emb = rng.standard_normal((n, d), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    data_s = time.time() - t
    launches = {}

    _reset(counters)
    torch.cuda.synchronize()
    t = time.time()
    i1, d1 = graph.exact_knn(emb, k)
    one_s = time.time() - t
    launches["beyond_card_knn/one_pass"] = _counts(counters)
    _reset(counters)
    t = time.time()
    i2, d2 = graph.exact_knn_sharded(emb, k, qchunk=qchunk, shard_bytes=rows_per_shard * 2 * d)
    sharded_s = time.time() - t
    launches["beyond_card_knn/sharded"] = _counts(counters)
    identical = bool(np.array_equal(i1, i2) and np.array_equal(d1, d2))
    del i2, d2

    rows = np.sort(rng.choice(n, n_sampled, replace=False))
    rows_t = torch.from_numpy(rows).to(dev)
    ebf, norms = kp.upload_panel_inputs(emb, dev)  # the plain version's operands
    sampled = {}
    for kk in (64, 512):
        _reset(counters)
        t = time.time()
        ri, rd = graph.exact_knn_rows(emb, rows, kk, shard_bytes=rows_per_shard * 2 * d)
        secs = time.time() - t
        launches[f"beyond_card_knn/rows_k{kk}"] = _counts(counters)
        pi, pd = kp.knn_panel_ext_plain(ebf[rows_t], norms[rows_t], ebf, norms, kk + 1, n)
        pi, pd = pi.cpu().numpy(), pd.cpu().numpy()
        order = np.argsort(pi == rows[:, None], axis=1, kind="stable")[:, :kk]  # the row itself last
        pi, pd = np.take_along_axis(pi, order, 1), np.take_along_axis(pd, order, 1)
        ov = float(np.mean([len(set(a) & set(b)) / kk for a, b in zip(ri.tolist(), pi.tolist())]))
        sampled[kk] = {"s": secs, "overlap_plain": ov, "max_abs_err_plain": float(np.abs(rd - pd).max())}
        if kk == k:
            sampled[kk]["identical_to_one_pass"] = bool(np.array_equal(ri, i1[rows]) and np.array_equal(rd, d1[rows]))
        del pi, pd
    torch.cuda.empty_cache()

    # each kernel at this phase's shapes, for the kernels line
    kr = {}
    q_count = min(graph.KNN_ROWS_PER_LAUNCH, n)
    (ip, dp), p_ms = timed_once(torch, lambda: kp.knn_panel_plain(ebf, norms, k, 0, q_count, n))
    ov = overlap(torch.from_numpy(i1[:q_count]), ip)
    err = float(np.abs(d1[:q_count] - dp.cpu().numpy()).max())
    del ip, dp

    def lib_one():
        for s in range(0, q_count, 1024):
            torch.topk(2.0 * (ebf[s : s + 1024] @ ebf.T).float() - norms, k)

    kr[("knn_panel", "beyond_card_knn/one_pass")] = {
        "shape": [q_count, n, d], "k": k, "overlap": ov, "max_abs_err": err,
        **timed_row(torch, lambda: kp.knn_panel(ebf, norms, k, 0, q_count), p_ms, lib_one,
                    n * (d * 2 + 4) + q_count * k * 8, 2.0 * q_count * n * d, reps=1)}
    slab = slice(rows_per_shard, 2 * rows_per_shard)
    q, qn = ebf[:qchunk].clone(), norms[:qchunk].clone()  # a chunk uploaded apart from the slab
    c, cn = ebf[slab], norms[slab]
    kr[("knn_panel_ext", "beyond_card_knn/sharded")] = ext_row(torch, kp, q, qn, c, cn, k, rows_per_shard, 0,
                                                               reps=2)
    run = kp.knn_panel_ext(q, qn, ebf[:rows_per_shard], norms[:rows_per_shard], k, rows_per_shard, 0, 0)
    new = kp.knn_panel_ext(q, qn, c, cn, k, rows_per_shard, rows_per_shard, 0)
    kr[("topk_merge", "beyond_card_knn/sharded")] = merge_row(
        torch, kp, torch.stack([run[1], new[1]], 1), torch.stack([run[0], new[0]], 1))
    del q, qn, run, new
    qs, qsn = ebf[rows_t], norms[rows_t]
    c0, cn0 = ebf[:rows_per_shard], norms[:rows_per_shard]
    for kk in (64, 512):
        path = f"beyond_card_knn/rows_k{kk}"
        kr[("knn_panel_ext", path)] = ext_row(torch, kp, qs, qsn, c0, cn0, kk + 1, 0, -1)
        a = kp.knn_panel_ext(qs, qsn, c0, cn0, kk + 1, rows_per_shard, 0, -1)
        b = kp.knn_panel_ext(qs, qsn, c, cn, kk + 1, rows_per_shard, rows_per_shard, -1)
        kr[("topk_merge", path)] = merge_row(torch, kp, torch.stack([a[1], b[1]], 1), torch.stack([a[0], b[0]], 1))
    del ebf, norms, qs, qsn, c, cn, c0, cn0
    torch.cuda.empty_cache()

    row = {"phase": "beyond_card_knn", "n": n, "d": d, "k": k, "data_s": data_s,
           "one_pass_s": one_s, "sharded_s": sharded_s, "sharded_over_one_pass": sharded_s / one_s,
           "n_shards": -(-n // rows_per_shard), "rows_per_shard": rows_per_shard, "qchunk": qchunk,
           "identical": identical, "launches": launches, "sampled_rows": len(rows), "sampled": sampled,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()},
           "reduced": "N = 1,048,576 with the shard budget passed in (4 shards of 262,144 rows): the regime "
                      "past the card's memory starts near 30M rows at D = 384, and an exact O(N^2) pass "
                      "there takes about an hour"}
    emit(row)
    if not identical:
        fail("exact_knn_sharded differs from the one-pass exact_knn")
    if not sampled[k]["identical_to_one_pass"]:
        fail("exact_knn_rows differs from the one-pass exact_knn on the sampled rows")
    # against the plain version on 1,024 rows (65,536 or more ids): at most a
    # few near-tie flips, and sorted distances within 1e-5
    for kk, r in sampled.items():
        if r["overlap_plain"] < 0.9999 or r["max_abs_err_plain"] > 1e-5:
            fail(f"exact_knn_rows at k = {kk} disagrees with the plain version: {r}")
    for (name, path), r in kr.items():
        if r.get("identical") is False or r.get("overlap", 1.0) < 0.9999 or r["max_abs_err"] > 1e-5:
            fail(f"{name} on {path} disagrees with its plain version: {r}")
    for path, cnt in launches.items():
        want = ("knn_panel",) if path.endswith("one_pass") else ("knn_panel_ext", "topk_merge")
        if any(cnt[w] < 1 for w in want):
            fail(f"a kernel of {path} was not launched: {cnt}")
    return kr, launches


def _labels_scores(results):
    return [[r.id for r in row] for row in results], np.array([[r.score for r in row] for row in results])


def _timed_search(torch, searcher, queries, **kw):
    searcher.search(queries, **kw)  # warm
    torch.cuda.synchronize()
    t = time.time()
    got = searcher.search(queries, **kw)
    torch.cuda.synchronize()
    return got, (time.time() - t) * 1e3 / len(queries)


def phase_beyond_card_path(torch, dev, workdir: str, main: dict, seed: int, max_n: int = 50_000,
                           shard_rows: int = 32_768, qchunk: int = 16_384):
    """Phase 7 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.ops import beam_search, graph
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.storage import unpack_neighbors

    chunks, queries, truth, kw = main["chunks"], main["queries"], main["truth"], main["kw"]
    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches = {}
    # past both caps at 100K rows: the sharded k-NN (4 shards, 7 chunks each)
    # and the PQ-mode prune, as the JAX package's own tests force them
    forced = {"exact_knn_max_n": max_n, "prune_ebf_max_bytes": 1, "EXACT_SHARD_BYTES": shard_rows * 2 * 384,
              "EXACT_QCHUNK": qchunk}
    saved = {name: getattr(graph, name) for name in forced}
    graph.exact_knn_max_n = lambda d, k, device: forced["exact_knn_max_n"]
    graph.prune_ebf_max_bytes = lambda device: forced["prune_ebf_max_bytes"]
    graph.EXACT_SHARD_BYTES, graph.EXACT_QCHUNK = forced["EXACT_SHARD_BYTES"], forced["EXACT_QCHUNK"]
    ckdir = os.path.join(workdir, "build_ckpt")
    builds = []
    try:
        for name in ("s100k_ck.leann", "s100k_ck_resumed.leann"):
            _reset(counters)
            b = LeannBuilder(backend_name="diskann", embedding_model="hash-minilm", max_length=128,
                             graph_degree=32, build_checkpoint_dir=ckdir)
            for c in chunks:
                b.add_text(c)
            prefix = os.path.join(workdir, name)
            b.build_index(prefix)
            builds.append({"prefix": prefix, "build_s": dict(b.phase_seconds), "launches": _counts(counters),
                           "ckpt_files": sorted(os.listdir(ckdir))})
            if len(builds) == 1:
                knn_ckpt = np.load(os.path.join(ckdir, "ckpt_knn.npy"))
                launches["beyond_card_path"] = builds[0]["launches"]
    finally:
        for name, v in saved.items():
            setattr(graph, name, v)
    restored = {name: getattr(graph, name) is saved[name] for name in forced}
    knn_identical = bool(np.array_equal(knn_ckpt, main["knn_ids"]))
    graphs = [unpack_neighbors(np.load(b["prefix"] + ".diskann.npz")) for b in builds]
    graph_identical = bool(np.array_equal(graphs[0], graphs[1]))
    resumed = builds[1]["build_s"]

    searcher = LeannSearcher(builds[0]["prefix"])
    got, ms_q = _timed_search(torch, searcher, queries, **kw)
    recall = float(np.mean([len({x.id for x in a} & {x.id for x in b}) / 3 for a, b in zip(got, truth)]))

    # a flat search at top_k = 512 through the entry point: B1's device-memory lists
    _reset(counters)
    flat = LeannSearcher(main["oracle"])
    deep, flat_ms_q = _timed_search(torch, flat, queries, top_k=512)
    launches["flat_top512"] = _counts(counters)
    flat_heads_agree = all(len(a) == 512 and [x.id for x in a[:3]] == [x.id for x in b]
                           for a, b in zip(deep, truth))

    # the token store in host RAM, the rerank deferred to host-gathered rows
    dev_s = LeannSearcher(main["prefix"])
    host_s = LeannSearcher(main["prefix"], token_residency="host")
    on_host = host_s.backend.tokens_host is not None and host_s.backend.tokens is None
    res_dev, dev_ms_q = _timed_search(torch, dev_s, queries, **kw)
    res_host, host_ms_q = _timed_search(torch, host_s, queries, **kw)
    (ld, sd), (lh, sh) = _labels_scores(res_dev), _labels_scores(res_host)
    host_same = ld == lh
    host_err = float(np.abs(sd - sh).max())

    # adaptive search on both graph backends: at adaptive_steps = 8, where
    # every lane may reach the cap, and at a cap inside the uncapped run's
    # per-lane step counts, where some lanes converge under it (their first
    # pass's results are kept) and the others run again
    runs = []  # (step budget, per-lane steps) of every batch search
    real_full = beam_search.beam_search_batch_packed_full

    def recording_full(q, g, cfg, enc_params=None):
        out = real_full(q, g, cfg, enc_params)
        runs.append((cfg.max_steps, beam_search.unpack_results_full(out)[2]))
        return out

    def adaptive_run(s_obj, kw_b, cap, plain):
        runs.clear()
        res, ms_q = _timed_search(torch, s_obj, queries, adaptive_steps=cap, **kw_b)
        first = [st for budget, st in runs if budget == cap][-1]  # the timed search's first pass
        return {"cap": cap, "same_labels": _labels_scores(res)[0] == plain, "ms_per_query": ms_q,
                "escalated_lanes": int((first >= cap).sum()), "lanes": int(first.shape[0])}

    adaptive = {}
    beam_search.beam_search_batch_packed_full = recording_full
    try:
        for backend, s_obj, kw_b, plain in (("diskann", dev_s, kw, ld),
                                            ("hnsw", LeannSearcher(main["hnsw_prefix"]), main["hnsw_kw"], None)):
            if plain is None:
                res_plain, plain_ms_q = _timed_search(torch, s_obj, queries, **kw_b)
                plain = _labels_scores(res_plain)[0]
            else:
                plain_ms_q = dev_ms_q
            runs.clear()
            s_obj.search(queries, adaptive_steps=1 << 30, **kw_b)  # past the budget: one uncapped run
            budget, steps = runs[-1]
            inside = [int(v) for v in np.unique(steps) if steps.min() < v < budget]
            if not inside:
                fail(f"{backend}: every lane took {steps.min()} steps: no cap splits the batch")
            med = int(np.median(steps))
            split_cap = med if steps.min() < med < budget else inside[0]
            adaptive[backend] = {"plain_ms_per_query": plain_ms_q, "budget": int(budget),
                                 "steps_min_median_max": [int(steps.min()), med, int(steps.max())],
                                 "cap_8": adaptive_run(s_obj, kw_b, 8, plain),
                                 "cap_split": adaptive_run(s_obj, kw_b, split_cap, plain)}
    finally:
        beam_search.beam_search_batch_packed_full = real_full

    # the kernels of this path at its shapes (seeded unit rows of the same widths)
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((2 * shard_rows, 384), dtype=np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    ebf, norms = kp.upload_panel_inputs(e, dev)
    kr = {}
    m = shard_rows
    q, qn = ebf[m : m + qchunk].clone(), norms[m : m + qchunk].clone()  # a chunk of the second shard
    kr[("knn_panel_ext", "beyond_card_path")] = ext_row(torch, kp, q, qn, ebf[:m], norms[:m], 64, 0, m)
    a = kp.knn_panel_ext(q, qn, ebf[:m], norms[:m], 64, m, 0, m)
    b = kp.knn_panel_ext(q, qn, ebf[m:], norms[m:], 64, m, m, m)
    kr[("topk_merge", "beyond_card_path")] = merge_row(torch, kp, torch.stack([a[1], b[1]], 1),
                                                       torch.stack([a[0], b[0]], 1))
    del ebf, norms, q, qn, a, b
    torch.cuda.empty_cache()

    row = {"phase": "beyond_card_path", "n_chunks": len(chunks), "backend": "diskann",
           "forced": forced, "restored": restored, "builds": builds, "knn_ckpt_identical": knn_identical,
           "graph_identical_on_resume": graph_identical, "recall_at_3": recall,
           "phase4_recall_at_3": main["recall"], "search_ms_per_query": ms_q,
           "flat_top512": {"ms_per_query": flat_ms_q, "heads_agree": flat_heads_agree},
           "host_tokens": {"on_host": on_host, "same_labels": host_same, "max_score_diff": host_err,
                           "ms_per_query": host_ms_q, "device_ms_per_query": dev_ms_q},
           "adaptive": adaptive, "launches": launches,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()}}
    emit(row)
    if not all(restored.values()):
        fail("the forced thresholds were not restored")
    if not knn_identical:
        fail("ckpt_knn.npy of the sharded build differs from phase 4's exact_knn candidates")
    if "ckpt_prune_codes.npy" not in builds[0]["ckpt_files"]:
        fail("the PQ-mode prune did not run")
    if not graph_identical or resumed["backend/knn"] >= 1.0 or resumed["backend/prune"] >= 1.0:
        fail(f"the second build did not resume: {resumed}")
    if builds[1]["launches"]["knn_panel_ext"] or builds[1]["launches"]["knn_panel"]:
        fail(f"the resumed build ran the k-NN again: {builds[1]['launches']}")
    if recall < 0.80:
        fail(f"recall@3 {recall:.4f} of the sharded / PQ-pruned build below the 0.80 sanity floor")
    if not flat_heads_agree:
        fail("the flat top-512 search disagrees with the top-3 oracle")
    if not (on_host and host_same and host_err <= 1e-5):
        fail("the host-resident token store does not give the device-resident search's answer")
    for backend, a in adaptive.items():
        if not (a["cap_8"]["same_labels"] and a["cap_split"]["same_labels"]):
            fail(f"adaptive search changed the labels on {backend}: {a}")
        if not 0 < a["cap_split"]["escalated_lanes"] < a["cap_split"]["lanes"]:
            fail(f"the split cap did not both keep and escalate lanes on {backend}: {a}")
    for (name, path), r in kr.items():
        if r.get("identical") is False or r.get("overlap", 1.0) < 0.9999 or r["max_abs_err"] > 1e-5:
            fail(f"{name} on {path} disagrees with its plain version: {r}")
    for path, names in (("beyond_card_path", ("knn_panel_ext", "topk_merge")), ("flat_top512", ("flat_topk",))):
        if any(launches[path][w] < 1 for w in names):
            fail(f"a kernel of {path} was not launched: {launches[path]}")
    return kr, launches


def _copy_index(src_prefix: str, dst_dir: str) -> str:
    """A copy of an index in ``dst_dir``, its meta pointing at the copy's
    passages (meta.json holds the paths the build wrote)."""
    os.makedirs(dst_dir, exist_ok=True)
    src_dir, base = os.path.split(src_prefix)
    for f in os.listdir(src_dir):
        if f.startswith(base + "."):
            shutil.copy(os.path.join(src_dir, f), dst_dir)
    prefix = os.path.join(dst_dir, base)
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    for src in meta["passage_sources"]:
        src.update(path=prefix + ".passages.jsonl", index_path=prefix + ".passages.idx")
    with open(prefix + ".meta.json", "w") as f:
        json.dump(meta, f)
    return prefix


def _recall(got, truth) -> float:
    return float(np.mean([len({x.id for x in a} & {x.id for x in b}) / 3 for a, b in zip(got, truth)]))


def panel_row(torch, kp, ebf, norms, k: int) -> dict:
    """knn_panel over every row of a build's corpus at its k: checked against
    its plain version, and timed."""
    n = ebf.shape[0]
    ik, dk = kp.knn_panel(ebf, norms, k)
    (ip, dp), p_ms = timed_once(torch, lambda: kp.knn_panel_plain(ebf, norms, k, 0, n, n))
    ov = overlap(ik, ip)
    err = float((dk - dp).abs().max())
    self_hits = int((ik == torch.arange(n, device=ik.device)[:, None]).sum())
    del ik, dk, ip, dp

    def lib():  # one matmul + topk per 1024 query rows
        for s in range(0, n, 1024):
            torch.topk(2.0 * (ebf[s : s + 1024] @ ebf.T).float() - norms, k)

    d = ebf.shape[1]
    row = timed_row(torch, lambda: kp.knn_panel(ebf, norms, k), p_ms, lib, n * (d * 2 + 4) + n * k * 8,
                    2.0 * n * n * d)
    return {"shape": [n, n, d], "k": k, "overlap": ov, "max_abs_err": err, "self_hits": self_hits, **row}


def phase_lifecycle(torch, dev, workdir: str, main: dict):
    """Phase 8 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.backends.diskann.partition import edge_locality
    from leann_torch.embeddings.compute import compute_embeddings
    from leann_torch.ops import graph
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.distance import flat_search, pad_features
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.repack import repack_index, unrelabel_index
    from leann_torch.storage import index_all_in_bytes, load_partition, save_partition, unpack_neighbors

    chunks, queries, truth, kw = main["chunks"], main["queries"], main["truth"], main["kw"]
    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches = {}
    n = len(chunks)

    # (a) insert: 256 new chunks into copies of phase 5's hnsw index and of
    # phase 4's flat oracle, in two batches of 128 (the second discovery
    # searches a graph the first one grew)
    new = synth_corpus(256, np.random.default_rng(8))
    new_queries = [" ".join(new[i].split()[:12]) for i in np.random.default_rng(8).choice(256, 64, replace=False)]
    hnsw = _copy_index(main["hnsw_prefix"], os.path.join(workdir, "lc_hnsw"))
    rows_before = unpack_neighbors(np.load(hnsw + ".hnsw.npz"))
    pool_before = int(np.load(hnsw + ".hnsw.npz")["entries"].shape[0])
    bytes_before = index_all_in_bytes(hnsw)
    _reset(counters)
    u = LeannBuilder.from_index(hnsw, device=dev)
    for c in new:
        u.add_text(c)
    torch.cuda.synchronize()
    t = time.time()
    u.update_index(hnsw, insert_batch_size=128)
    torch.cuda.synchronize()
    hnsw_update_s = time.time() - t
    launches["hnsw_update"] = _counts(counters)
    z = np.load(hnsw + ".hnsw.npz")
    rows_after = unpack_neighbors(z)
    repaired = sum(set(a) != set(b) for a, b in zip(rows_before.tolist(), rows_after[:n].tolist()))
    hnsw_stats = {"update_s": hnsw_update_s, "s_per_chunk": hnsw_update_s / len(new),
                  "phase_s": dict(u.phase_seconds), "rows_repaired": int(repaired),
                  "entry_pool": [pool_before, int(z["entries"].shape[0])],
                  "all_in_bytes": [bytes_before, index_all_in_bytes(hnsw)], "n_after": int(rows_after.shape[0])}

    flat = _copy_index(main["oracle"], os.path.join(workdir, "lc_flat"))
    _reset(counters)
    u = LeannBuilder.from_index(flat, device=dev)
    for c in new:
        u.add_text(c)
    t = time.time()
    u.update_index(flat)
    flat_update_s = time.time() - t
    fs = LeannSearcher(flat, device=dev)
    flat_res = [fs.search(qs, top_k=3) for qs in (queries, new_queries)]
    launches["flat_update"] = _counts(counters)
    whole = os.path.join(workdir, "lc_flat_whole.leann")
    b = LeannBuilder(backend_name="flat", embedding_model="hash-minilm", max_length=128, device=dev)
    for c in chunks + new:
        b.add_text(c)
    b.build_index(whole)
    whole_build = dict(b.phase_seconds)
    ws = LeannSearcher(whole, device=dev)
    whole_res = [ws.search(qs, top_k=3) for qs in (queries, new_queries)]
    flat_same = all(_labels_scores(a)[0] == _labels_scores(w)[0] for a, w in zip(flat_res, whole_res))
    flat_err = max(float(np.abs(_labels_scores(a)[1] - _labels_scores(w)[1]).max())
                   for a, w in zip(flat_res, whole_res))
    hs = LeannSearcher(hnsw, device=dev)
    hnsw_recall = {name: _recall(hs.search(qs, **main["hnsw_kw"]), fr)
                   for name, qs, fr in (("old", queries, flat_res[0]), ("new", new_queries, flat_res[1]))}

    # (b) from embeddings, partitioned: phase 4's chunk embeddings through
    # build_index_from_embeddings with diskann at phase 4's settings and 4
    # LDG partitions
    t = time.time()
    emb = compute_embeddings(chunks, "hash-minilm", is_build=True, batch_size=4096, max_length=128, device=dev)
    embed_s = time.time() - t
    ids = [str(i) for i in range(n)]
    knn_seen = {}
    real_exact_knn = graph.exact_knn

    def recording_exact_knn(*a, **k):  # launches nothing itself
        knn_seen["ids"], dists = real_exact_knn(*a, **k)
        return knn_seen["ids"], dists

    part = os.path.join(workdir, "lc_parts.leann")
    _reset(counters)
    graph.exact_knn = recording_exact_knn
    try:
        b = LeannBuilder(backend_name="diskann", embedding_model="hash-minilm", max_length=128, graph_degree=32,
                         num_partitions=4, device=dev)
        b.build_index_from_embeddings(part, ids, emb.copy(), texts=chunks)
    finally:
        graph.exact_knn = real_exact_knn
    launches["from_embeddings_diskann"] = _counts(counters)
    part_build = dict(b.phase_seconds)
    knn_same = bool(np.array_equal(knn_seen["ids"], main["knn_ids"]))
    counts = np.load(part + ".partition.npz")["counts"].tolist()
    locality = edge_locality(unpack_neighbors(np.load(part + ".diskann.npz")), load_partition(part))
    part_recall = _recall(LeannSearcher(part, device=dev).search(queries, **kw), truth)
    # repack and unrelabel on a copy. unrelabel_index refuses a
    # multi-partition index (as the JAX package's does); the copy's
    # partition file is set to one part, what a one-card search reads
    copy = _copy_index(part, os.path.join(workdir, "lc_parts_copy"))
    repack = repack_index(copy)
    try:
        unrelabel_index(copy)
        refused = False
    except ValueError:
        refused = True
    save_partition(copy, np.zeros(n, np.int32))
    t = time.time()
    unrel = unrelabel_index(copy)
    unrel_s = time.time() - t
    from leann_torch.storage import load_ids

    unrel_seq = load_ids(copy) == ids
    unrel_recall = _recall(LeannSearcher(copy, device=dev).search(queries, **kw), truth)

    # (c) f16 embeddings, no texts, hnsw (the default backend)
    f16 = os.path.join(workdir, "lc_f16.leann")
    _reset(counters)
    b = LeannBuilder(embedding_model="hash-minilm", max_length=128, device=dev)  # hnsw: M = 32, efConstruction = 128
    b.build_index_from_embeddings(f16, ids, emb.astype(np.float16), texts=None)
    launches["from_embeddings_hnsw_f16"] = _counts(counters)
    f16_build = dict(b.phase_seconds)
    f16_dtype = str(np.load(f16 + ".hnsw.npz")["embeddings"].dtype)
    with open(f16 + ".meta.json") as f:
        f16_meta = json.load(f)
    f16_recall = _recall(LeannSearcher(f16, device=dev).search(queries, **main["hnsw_kw"]), truth)

    # the kernels of these paths at their shapes, on their inputs
    kr = {}
    be = fs.backend
    q = be.get_encoder().encode(queries)
    q = pad_features(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(dev))
    n_flat = be.n
    ik, dk = flat_topk(q, be._emb, be._en, n_flat, 3, "cosine")
    (ip, dp), p_ms = timed_once(torch, lambda: flat_search(be._emb, q, n_flat, 3, "cosine", en=be._en))
    qb = q.to(torch.bfloat16)
    d_pad = be._emb.shape[1]
    kr[("flat_topk", "flat_update")] = {
        "shape": [q.shape[0], n_flat, d_pad], "k": 3, "overlap": overlap(ik, ip),
        "max_abs_err": float((dk - dp).abs().max()),
        **timed_row(torch, lambda: flat_topk(q, be._emb, be._en, n_flat, 3, "cosine"), p_ms,
                    lambda: torch.topk(qb @ be._emb.T, 3), n_flat * d_pad * 2 + q.shape[0] * d_pad * 4
                    + q.shape[0] * 3 * 8, 2.0 * q.shape[0] * n_flat * d_pad, reps=10)}
    for path, arr, k in (("from_embeddings_diskann", emb, 64), ("from_embeddings_hnsw_f16", emb.astype(np.float16), 128)):
        ebf, norms = kp.upload_panel_inputs(arr, dev)
        kr[("knn_panel", path)] = panel_row(torch, kp, ebf, norms, k)
        del ebf, norms
        torch.cuda.empty_cache()

    row = {"phase": "lifecycle", "n_chunks": n, "n_inserted": len(new), "insert_batch_size": 128,
           "hnsw_update": hnsw_stats, "hnsw_recall_at_3": hnsw_recall,
           "flat_update": {"update_s": flat_update_s, "same_labels": flat_same, "max_score_diff": flat_err,
                           "whole_build_s": whole_build},
           "from_embeddings_diskann": {"embed_s": embed_s, "build_s": part_build, "knn_identical": knn_same,
                                       "partition_counts": counts, "edge_locality": locality,
                                       "recall_at_3": part_recall, "phase4_recall_at_3": main["recall"],
                                       "repack": repack, "unrelabel_refused_while_partitioned": refused,
                                       "unrelabel_s": unrel_s, "unrelabel_ids_sequential": unrel_seq,
                                       "unrelabel_recall_at_3": unrel_recall,
                                       "unrelabel_edge_locality_64k": unrel.get("edge_locality_64k")},
           "from_embeddings_hnsw_f16": {"build_s": f16_build, "embeddings_dtype": f16_dtype,
                                        "is_recompute": f16_meta["is_recompute"], "recall_at_3": f16_recall},
           "launches": launches,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()}}
    emit(row)
    if not (flat_same and flat_err <= 1e-6):
        fail("the updated flat index and the whole rebuild disagree")
    if min(hnsw_recall.values()) < 0.80:
        fail(f"hnsw recall@3 after the insert below the 0.80 sanity floor: {hnsw_recall}")
    if rows_after.shape[0] != n + len(new) or repaired == 0:
        fail(f"the hnsw update did not insert the chunks: {hnsw_stats}")
    if not knn_same:
        fail("the from-embeddings k-NN candidates differ from phase 4's")
    if part_recall < 0.80 or sum(counts) != n or len(counts) != 4:
        fail(f"the partitioned from-embeddings build is off: recall {part_recall}, counts {counts}")
    if not (refused and unrel_seq and abs(unrel_recall - part_recall) <= 0.01):
        fail(f"the unrelabel is off: refused {refused}, sequential {unrel_seq}, recall {unrel_recall}")
    if f16_dtype != "float16" or f16_meta["is_recompute"] or f16_recall < 0.80:
        fail(f"the f16 no-text build is off: {f16_dtype}, {f16_meta['is_recompute']}, recall {f16_recall}")
    for (name, path), r in kr.items():
        if r["overlap"] < 0.999 or r["max_abs_err"] > 1e-5 or r.get("self_hits", 0):
            fail(f"{name} on {path} disagrees with its plain version: {r}")
    for path, name in (("flat_update", "flat_topk"), ("from_embeddings_diskann", "knn_panel"),
                       ("from_embeddings_hnsw_f16", "knn_panel")):
        if launches[path][name] < 1:
            fail(f"kernel {name} was not launched on {path}: {launches[path]}")
    return kr, launches


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

    build_s = cuda_build.build(["flat_topk", "knn_panel", "ldg_partition"])
    sass = {name: sass_counts(cuda_build._lib_path(name)) for name in ("flat_topk", "knn_panel")}
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln or "entry" in ln]
             for k, v in cuda_build.BUILD_LOGS.items()}
    spills = [ln for lines in ptxas.values() for ln in lines
              if any(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))]
    emit({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": build_s, "ptxas": ptxas, "sass": sass})
    if spills:
        fail(f"ptxas reports spills: {spills}")
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")  # the plain versions' products in full f32
    rng = np.random.default_rng(1234)
    flat_rows = phase_flat_topk(torch, dev, rng)
    knn_rows = phase_knn_panel(torch, dev, rng)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as workdir:
        launches = {}
        launches["diskann"], main_state = phase_main_path(torch, workdir)
        launches["hnsw"] = phase_hnsw_path(torch, workdir, main_state)
        rows6, launches6 = phase_beyond_card_knn(torch, dev, seed=6)
        rows7, launches7 = phase_beyond_card_path(torch, dev, workdir, main_state, seed=7)
        rows8, launches8 = phase_lifecycle(torch, dev, workdir, main_state)
    for more in (launches6, launches7, launches8):
        launches.update(more)

    b1 = ("leann_torch/csrc/flat_topk.cu", "leann_tpu/ops/pallas_topk.py:32", "flat_topk")
    b2 = ("leann_torch/csrc/knn_panel.cu", "leann_tpu/ops/pallas_knn.py:45", "knn_panel")
    rows = [("flat_topk", "diskann", flat_rows[3], b1), ("knn_panel", "diskann", knn_rows[64], b2),
            ("knn_panel", "hnsw", knn_rows[128], b2), ("flat_topk", "flat_top512", flat_rows[512], b1)]
    rows += [(name, path, r, b1 if name == "flat_topk" else b2)
             for (name, path), r in list(rows6.items()) + list(rows7.items()) + list(rows8.items())]
    kernels = []
    for name, path, row, (src, replaces, lib) in rows:
        kernels.append({"name": name, "path": path, "k": row["k"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[path][name],
                        "launches_by_path": {p: c.get(name, 0) for p, c in launches.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                        "ms_source": "torch.profiler device time", "call_ms": row["call_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "sass": sass[lib]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
