#!/usr/bin/env python3
"""Smoke run of leann_torch on one NVIDIA GPU: kernels, parity, main path.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure exits non-zero before the
final line):
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions; builds both CUDA kernels with nvcc and the LDG partitioner,
     the hash tokenizer and the passage store with the host compiler
     (build/leann_torch/, all at once) and prints
     ptxas's registers / spills and, from `cuobjdump -sass`, how many wgmma
     (HGMMA) and TMA load (UTMALDG) instructions each kernel library holds.
  2. flat top-k kernel (csrc/flat_topk.cu) against its plain PyTorch version
     on the card: q f32[64, 384] against a bf16[100000, 384] corpus,
     k in {3, 5, 10, 16, 64, 128, 256, 257, 512}, metrics l2 and cosine (id
     overlap >= 0.95, distances within rtol 1e-2; above k = 256 id overlap
     1.0 and errors <= 1e-5, absolute for cosine, relative for l2). Above
     k = 64 each row appends its survivors to a buffer and folds it into a
     sorted list in batches (topk_common.cuh BufRows).
  3. k-NN panel kernel (csrc/knn_panel.cu) against its plain version: every
     row of a 100000 x 384 corpus at k = 64 (the diskann build's launch),
     k = 128 (the HNSW build's: M = 32, efConstruction = 128), k = 257 and
     512 (the HNSW build's at M = 64, efConstruction = 512), and 1024 rows
     of a 385-wide corpus whose last 1000 rows are padding at k = 64 (id
     overlap >= 0.98, no self match, no padding row; above k = 256 id
     overlap >= 0.99999 and max abs error <= 1e-5).
     Phases 2-3 check every case and time the kernel and a library call
     at some (phase 2: cosine at k = 3, 5, 128, 256, 512, l2 at k = 3; phase 3:
     the full-corpus launches at k = 64, 128 and 512) as device time: the
     summed time of the CUDA kernels one call launches, from torch.profiler
     over 10 calls (3 above k = 256, and 3 of each call at the instances no
     path launches: B1 k = 256, B2 k = 512) after 2 untimed ones (`kernel_ms`,
     `library_ms`; `kernel_parts_ms` by kernel, the tile kernel against the
     merge); each
     kernel's records must number a multiple of the calls, else the profile
     is taken again, and after five the time is the call's wall time between
     CUDA events, named so in `ms_source` / `library_ms_source`. `call_ms`
     is the wall time of the wrapper between CUDA events, host work
     included. Two launches at the main
     path's shape must give bit-identical ids and distances. Untimed, at
     k = 128 and 512, both kernels on a corpus in which every column beats
     every column before it for the rows taken (integer-valued rows, exact
     distances: the buffers fill and fold at every tile), ids and distances
     identical to the plain versions'; and on a corpus of duplicated rows,
     whose ties straddle the folds, every upper twin after its lower one.
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
     set low and LEANN_PRUNE_EBF_MAX_BYTES=1, LEANN_EXACT_SHARD_BYTES and
     LEANN_EXACT_QCHUNK in the environment (restored after), so that the
     sharded k-NN (4 shards) and the PQ-mode prune run (as the JAX
     package's tests force them):
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
  8. the index lifecycle, on phase 4 and 5's corpus and queries: (a) 128
     new chunks inserted by LeannBuilder.from_index -> update_index
     (insert_batch_size=64: two batches) into a copy of phase 5's hnsw
     index and of phase 4's flat oracle; the updated flat index against a
     flat index built whole over the 100,128 chunks (same labels, scores
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
  9. a real checkpoint, served: a checkpoint directory at the widths of
     all-MiniLM-L6-v2's published config.json (vocab 30,522, hidden 384, 6
     layers, 12 heads, MLP 1,536, 512 positions; seeded weights written by
     the port's save_hf_weights, an uncased WordPiece vocab.txt that covers
     the corpus) drives LeannBuilder(embedding_model=<dir>) over phase 4's
     chunks: a diskann build at phase 4's settings and a flat oracle, each
     loading the weights and the WordPiece and calibrating on the corpus
     (<prefix>.calib.npz, equal in both). Fails unless the checkpoint
     loaded, no corpus token is [UNK], the diskann build launched the k-NN
     panel kernel once at k = 64 and the oracle flat_topk once at k = 3,
     recall@3 of the 64 queries >= 0.80, the same queries from 8 threads
     through BatchedSearcher(max_batch=16, max_wait_ms=2) give the direct
     search's labels (a differing label is printed with its score gap, and
     only gaps under 1e-5 pass), the native hash tokenizer gives the Python
     path's ids on all 100,000 chunks and the native passage store the
     offset map's texts on 10,000 lookups (both paths timed), the
     WordPiece read from a tokenizer.json of the same vocab (as
     BertTokenizerFast saves it) gives the vocab.txt route's ids on all
     chunks (both routes timed), and both kernels agree with their plain
     versions on this path's inputs.
 10. fine-tuning, then an index from the trained checkpoint: first the
     searches' independence of the caller's precision flag (phase 4's
     diskann and phase 5's hnsw searches under "highest", then under "high",
     which allows TF32: identical labels and scores; "high" read back after
     a BatchedSearcher batch); then ContrastiveTrainer on phase 9's
     checkpoint, 50 steps of 256 (12-word prefix -> chunk) pairs at lr 1e-4
     (queries T = 32, chunks T = 128, through the checkpoint's WordPiece;
     the 64 eval chunks left out): the loss at the first and last step (it
     must fall), warm ms per step, tokens per second, peak memory, one
     profiled step's top device ops and idle share; save_hf_weights, then a
     diskann index (phase 4's settings, calibrating) and a flat oracle from
     that directory: one knn_panel launch at k = 64, one flat_topk launch,
     each held against its plain version, recall@3 >= 0.80 against the
     trained oracle, and hit@3 of each query's source chunk before and after
     training (printed, not checked).
 11. the user surface, with LEANN_HOME and the current directory in the
     run's temporary directory: a document folder generated from the seed
     (1,500 .md / .txt files of synth_corpus prose, one PDF whose text is a
     Flate stream, 400 Python modules and 100 each of .ts, .go and .java
     files; a .gitignore listing build/ and ignored/, which hold a marker
     word each, as does a hidden .private/; ~47,000 chunks).
     (a) leann_torch.cli.main(["build", "folder", "--docs", DIR,
     "--use-ast-chunking"]) at every other default (hnsw, hash-minilm,
     max_length 256, M = 32, efConstruction = 128, compact, recompute), then
     the same with --backend flat into folder-oracle: one knn_panel launch
     at k = 128 in the hnsw build, no marker word in any passage, the PDF's
     text in one. (b) 64 queries (12-word prefixes of chunks) through
     LeannSearcher at the CLI's search defaults (top_k 5, complexity 64,
     beam_width 8): recall@5 against the oracle >= 0.80, ms per query warm.
     (c) `search ... --non-interactive` for 4 queries prints the searcher's
     top-5 texts in order; `ask ... --llm simulated` the top passages' head.
     (d) `python -m leann_torch.mcp --device cuda` as a subprocess:
     initialize, tools/list, two leann_search calls and leann_list, each
     timed; the first search's top result equals the in-process top-1, the
     list names both indexes. (e) a loopback fake Ollama (http.server in a
     thread on 127.0.0.1:11434, the mode's default host; deterministic
     384-wide vectors): `build folder-http --embedding-mode ollama
     --backend flat` over the 200 .ts and .go files; its search launches
     flat_topk and gives the labels and scores of flat_topk over the same
     vectors computed directly. (f) `remove folder-http --force`; `list`
     no longer names it. Both kernels are held against their plain
     versions on this path's inputs (k-NN at k = 128, the oracle's and the
     HTTP index's top-5).
 12. checkpoints whose tokenizer is not WordPiece, read by the port's own
     tokenizer.json reader. (a) a checkpoint directory at the widths of
     intfloat/multilingual-e5-small's published config.json (BertModel,
     vocab 250,037, hidden 384, 12 layers, 12 heads, MLP 1,536, 512
     positions, type vocab 2; seeded weights written by the port's
     save_hf_weights) with an XLM-R tokenizer.json the script writes (a
     Unigram of 250,037 pieces, the corpus's pieces at ids 65,536 and up;
     in the published order a Precompiled charsmap of nmt_nfkc-style rules
     then Replace(" {2,}", " "); Metaspace "▁"; the template "<s> $A
     </s>"): phase 4's 100,000 chunks and 64 queries through
     indexes_from_dir (diskann at phase 4's settings and a flat oracle, both
     calibrating). Fails unless the checkpoint loaded with that tokenizer,
     the token store is int32 and holds ids above 65,535, no corpus token is
     <unk>, the diskann build launched the k-NN panel kernel once at k = 64
     and the oracle flat_topk once at k = 3, each agreeing with its plain
     version on this path's inputs, recall@3 >= 0.80, and the normalizer
     maps "Ａ ﬁ e\u0301" to "A fi é". Prints the tokenizer's seconds on the
     100,000 chunks (a fresh reader) and on 10,000 non-ASCII texts (chunks'
     words between accented, decomposed, CJK, Arabic, Devanagari, Cyrillic,
     Hangul, emoji and fullwidth fragments; another fresh reader), the
     build's phase seconds and ms per query. (b) the same at
     sentence-transformers/all-distilroberta-v1's widths (RoBERTa, vocab
     50,265, hidden 768, 6 layers, 12 heads, MLP 3,072, 514 positions, pad
     id 1; the weights under the roberta. prefix beside an lm_head, as a
     RobertaForMaskedLM saves them) with a byte-level BPE tokenizer.json and
     RobertaProcessing, over the first 20,000 chunks and 64 queries from
     them: the same checks, with a uint16 token store.
 13. the RAG apps and examples (leann_torch/apps, leann_torch/examples),
     with HOME and the current directory in the run's temporary directory,
     over fixtures written from the seed at what one person holds: 5,000
     Apple Mail .emlx messages in two accounts under ~/Library/Mail/V10
     (2-6 paragraphs each, one in ten multipart with an HTML part), Chrome
     History databases of 30,000 urls rows under ~/.config/google-chrome
     (Default, Profile 1), a WeChat message database of 60 Chat_<md5>
     tables of 500 messages turned into an export directory by the port's
     wechat_exporter.export_db, the checkout's own leann_torch/ and
     leann_tpu/ (copied), the first 400 of phase 11's files by sorted path
     (copied into a folder of their own, so the walk's order does not pick
     them), and a book of
     40 "Chapter N" sections of ~75 paragraphs. Each app runs through its
     run() at its defaults (hnsw, hash-minilm, max_length 256, M = 32,
     efConstruction 128; top 5, complexity 64, beam 8; --llm simulated
     --query q), finding the mail and the browser history by discovery;
     basic_demo and spoiler_free_book_rag --up-to-chapter 3 run on the book
     (the latter asked a chapter-2 paragraph). Fails unless each build
     launched the k-NN panel kernel once at k = 128 (held against its plain
     version on that build's inputs), a second run() over the existing
     index neither builds nor launches it, the chat's prompt holds
     LeannSearcher(prefix, device="cuda").search(q, top_k=5, ...)'s texts
     in order (first and second run), a flat oracle over email's chunks
     (built as the app builds with --backend flat) and its search of 64
     queries (12-word prefixes of chunks) launch flat_topk once at k = 5,
     agreeing with its plain version, email recall@5 against it at the
     apps' complexity 64 is >= EMAIL_RECALL_FLOOR (0.60: the JAX package's
     lowest over seven row orders of this mail, 0.634, less 0.03),
     basic_demo prints 3 results and an answer, and no spoiler result
     comes from a chapter above 3.
     Prints per app the items, chunks, load + chunk
     seconds, build phase seconds, all-in bytes and ms per query (16
     queries, 64 on email's index), and times two kernel rows in one
     profile window: email's k-NN panel and its oracle's flat_topk.
 14. the parallel layer (leann_torch/parallel) on the one card, as a mesh
     of 4 gp shards of it: (a) sharded_build_graph over phase 4's matrix
     (its 100,000 unit rows) at diskann's R = 32, C = 64: each of the 4 x 4 ring steps
     one launch of the k-NN kernel's external entry and one of its merge
     (counted), ring_knn's ids equal to phase 4's exact_knn on >= 0.9999 of
     entries, recall@3 of the sharded graph (phase 4's codes, tokens and
     entries, its 64 queries) within 0.02 of phase 4's graph's; shard 1's
     step against shard 0's tile and its merge held against the plain
     versions; (b) ShardedSearcher over phase 4's index, its device tensors
     sliced into the shards: the pq traversal's label sets equal to the
     one-card search's on >= 0.99 of rows, recall@3 at the searcher's
     defaults within 0.02 of the one-card search's, ms per query of the
     64-query batch, and a serving_mesh(2, 2) search equal to the gp = 2
     search; (c) the normal entry points at gp = the card count:
     LeannBuilder(hnsw, build_sharded=True) over the first 20,000 chunks,
     LeannSearcher(sharded=True) against the unsharded searcher (recall@3
     against a flat oracle within 0.02; sharded="auto" unsharded on one
     card), its ring step held against the plain versions; (d)
     ContrastiveTrainer on a (dp 2, tp 2) mesh against the one-device
     trainer at hash-minilm's widths, 10 steps of 64 pairs from the same
     seeded params: in f32 the losses within 1e-3 relative at every step,
     in bf16 (4 steps) within 1e-3 at the first and 2e-3 at the others
     (Adam turns rounding noise into other updates); ms per step of each.
 15. checkpoints whose only tokenizer files are the slow ones transformers
     converts, read by the port's own converters. (a) a checkpoint
     directory at the widths of almanach/camembert-base's published
     config.json (CamemBERT, vocab 32,005, hidden 768, 12 layers, 12 heads,
     MLP 3,072, 514 positions, one token type, pad id 1; seeded weights
     under the roberta. prefix beside an lm_head, as a CamembertForMaskedLM
     saves them) whose only tokenizer file is a sentencepiece.bpe.model
     the script writes in protobuf's wire format (a Unigram of 32,000
     pieces with fairseq's head, the nmt_nfkc-style charsmap of phase 12,
     pieces that cover the corpus's words) beside a tokenizer_config.json
     naming CamembertTokenizer: the first 20,000 of phase 4's chunks and 64
     queries through indexes_from_dir, with phase 12's checks (the
     checkpoint loaded, no <unk>, one B2 launch at k = 64 and one B1, each
     against its plain version, recall@3 >= 0.80) and the port's
     SpmTokenizer as the reader. (b) host only, on the same 20,000 chunks:
     the pipeline the port made of the .model written as a tokenizer.json
     twin gives the same ids and masks; phase 12's distilroberta
     vocabulary and merges written as vocab.json + merges.txt give the ids
     and masks of their tokenizer.json (these check that the card's Python
     runs the converters as the CPU tests do; the references are the CPU
     tests').
 16. the approximate k-NN past the card and the locality relabel (plain
     torch: the JAX package computes them outside Pallas). (a) spill
     (ops/graph.py spill_knn_streamed: k-means cells, exact k-NN inside
     windows of the cell order, lists merged over 2 probes) over phase 6's
     1,048,576 rows at k = 64, in 4 chunks of 2^19 expanded rows, its
     candidate recall@64 against phase 6's one-pass exact lists. (b) phase
     4's embeddings (kept by phase 8) through build_index_from_embeddings
     with diskann at phase 4's settings and the k-NN cap lowered to 50,000
     (as phase 7 lowers it), under LEANN_KNN_MODE=spill, then into the same
     prefix under =descent (NN-descent from the cluster bootstrap; the
     passages and token store stay): no k-NN kernel launched, candidate
     recall@64 against phase 4's B2 lists, step seconds, descent's rounds
     and improved fraction per round, recall@3 of phase 4's queries against
     its oracle (B1), >= 0.80 for descent, and whether the card's free
     memory sent the prune to PQ-decoded rows or the token store to host
     RAM. (c) the locality relabel (repack.relabel_index with no order:
     k-means cells over the stored geometry, here PQ codes decoded) of a
     copy of phase 4's index, and `repack <phase 11's index> --relabel
     --device cuda` through the CLI's main (what `python -m leann_torch.cli`
     runs; in this process, as phase 11 runs the CLI): bytes and edge
     locality before and after, the 64 queries' ids of each index unchanged
     (against phase 4's and phase 11's searches), unrelabel_index restoring
     every array. Fails on any of these. One process on the card
     throughout.
 17. the kernels line: per kernel, path and k its launches on that path
     (each path's counts set to 0 just before it and read just after), its
     device time and call time, its plain version's and a library call's
     time at that path's shapes, and its bound on the card.
The script uses only the wrappers' public calls and the build module, so a
copy of it also times an older tree of the repo the same way.
The last line is {"ok": true, "device": {...}}.
"""

import base64
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
# the diskann searches of phases 4, 7 and 9 (bench.py:128's settings)
SEARCH_KW = dict(top_k=3, complexity=128, beam_width=4)


_T0 = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the run's seconds so far."""
    print(json.dumps({**obj, "run_s": time.time() - _T0} if "phase" in obj else obj), flush=True)


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
# records, up to PROFILE_PAD_MAX_S, and kept for the next. Losses were seen
# at pads of 4-32 s as well, and a pad that doubled to 64 s took a run past
# its time limit, so the pad stops at 4 s (at 1 or 2 s, 10 or 6 of 84
# profiles were given up in one run each, at 4 s none). A lost profile has
# no device records at all, or the first of them missing, not records
# outside its range: the device's annotation of a range starts 0.26-0.93 ms
# after the host's, and a warm-up step of the profiler's schedule before the
# calls lost as many (PERF.md §6).
_PROFILE_PAD = [0.0]
PROFILE_PAD_MAX_S = 4.0
_TIMED = "chip_smoke_timed_calls"
PROFILE_UNTIMED_CALLS = 2


def device_ms_many(torch, fns, attempts: int = 5):
    """Summed device time of the CUDA kernels each function launches, per
    call, and the same by kernel name, for ``fns`` = [(fn, reps), ...] in
    one torch.profiler window -> [(ms, ms by kernel, {attempts, pad_s,
    source})]. In the window, after the idle pad, each function in turn
    makes ``PROFILE_UNTIMED_CALLS`` untimed calls, then its ``reps`` timed
    ones in a marked range of its own; only the kernels that start inside a
    function's range, 5 ms either side, are summed for it. (One window for a
    kernel and its library call halves the pads, the smoke's largest cost.) Every
    call launches the same kernels, so each kernel's count of records there
    must be a multiple of ``reps``, and the range must hold a kernel record
    for each kernel launch the host recorded in it (a library call of many
    launches can lose some and keep the multiples). The profiler can lose
    the records of the first kernels of a profile, more often late in a
    long process (every loss seen was at the start of the window, and some
    profiles came back empty): the untimed calls take such a loss. A
    profile that lost records
    is printed, with the offsets of its kernels from the host events around
    them, and the window is taken again after twice the idle time before its
    calls (at most ``PROFILE_PAD_MAX_S``) for the functions still without
    one. No incomplete profile is used: after ``attempts`` a function's
    time is its call's wall time between CUDA events (:func:`cuda_ms`, host
    work in the call included), and the source says so ("cuda events");
    every row and the kernels line carry the source of both the kernel's
    and the library call's time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: list = [None] * len(fns)
    for attempt in range(1, attempts + 1):
        todo = [i for i, o in enumerate(out) if o is None]
        if not todo:
            break
        pad = _PROFILE_PAD[0]
        for i in todo:
            fns[i][0]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            time.sleep(pad)
            for i in todo:
                fn, reps = fns[i]
                for _ in range(PROFILE_UNTIMED_CALLS):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.01)  # the untimed calls' kernels end well before the range
                with record_function(f"{_TIMED}_{i}"):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                time.sleep(0.01)  # and the next function's begin well after it
        evts = prof.events()
        cuda = [e for e in evts if str(e.device_type).endswith("CUDA") and not e.name.startswith(_TIMED)]
        for i in todo:
            reps = fns[i][1]
            marks = [e.time_range for e in evts if e.name == f"{_TIMED}_{i}" and str(e.device_type).endswith("CPU")]
            # us: half the gaps around the range (device and host clocks differ by up to ~1 ms)
            lo, hi = (marks[0].start - 5e3, marks[0].end + 5e3) if marks else (float("inf"), float("inf"))
            timed = [e for e in cuda if lo <= e.time_range.start <= hi]
            launches = [e.time_range for e in evts if "LaunchKernel" in e.name and lo <= e.time_range.start <= hi]
            by_kernel, counts, n_kernels = {}, {}, 0
            for e in timed:
                if _device_us(e) > 0:
                    by_kernel[e.name] = by_kernel.get(e.name, 0.0) + _device_us(e) / 1e3 / reps
                    counts[e.name[:60]] = counts.get(e.name[:60], 0) + 1
                    n_kernels += not e.name.startswith(("Memset", "Memcpy"))
            if by_kernel and all(c % reps == 0 for c in counts.values()) and n_kernels >= len(launches):
                parts = {}  # names shortened for printing only; kernels that share a prefix add up
                for key, ms in by_kernel.items():
                    parts[key[:60]] = parts.get(key[:60], 0.0) + ms
                out[i] = (sum(by_kernel.values()), parts,
                          {"attempts": attempt, "pad_s": pad, "source": "torch.profiler", "window_fns": len(todo)})
                continue
            syncs = [e.time_range for e in evts if "Synchronize" in e.name]
            kernels = [e.time_range for e in timed]
            emit({"phase": "profiler_lost_records", "attempt": attempt, "pad_s": pad, "fn": i, "reps": reps,
                  "records": counts, "marked": bool(marks), "launch_records": len(launches),
                  "kernel_records": n_kernels,
                  "first_kernel_after_first_launch_ms": (min(k.start for k in kernels) - launches[0].start) / 1e3
                  if kernels and launches else None,
                  "last_kernel_end_after_sync_end_ms": (max(k.end for k in kernels) - syncs[-1].end) / 1e3
                  if kernels and syncs else None})
        if any(out[i] is None for i in todo):
            _PROFILE_PAD[0] = min(PROFILE_PAD_MAX_S, max(0.5, 2 * pad))
    return [o if o is not None else _gave_up(torch, fn, reps, attempts, _PROFILE_PAD[0])
            for (fn, reps), o in zip(fns, out)]


def _gave_up(torch, fn, reps: int, attempts: int, pad: float):
    emit({"phase": "profiler_gave_up", "attempts": attempts, "reps": reps})
    return cuda_ms(torch, fn, reps), {}, {"attempts": attempts, "pad_s": pad, "source": "cuda events"}


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
    """Mean over rows of |set(a_row) & set(b_row)| / len(a_row), on a's
    device: each distinct id of b's row looked up in a's sorted row (as
    Python sets, a million rows of 64 took many seconds)."""
    import torch

    a = torch.sort(a.long(), dim=1).values
    b = torch.sort(b.long().to(a.device), dim=1).values
    first = torch.ones_like(b, dtype=torch.bool)
    first[:, 1:] = b[:, 1:] != b[:, :-1]
    found = (a.gather(1, torch.searchsorted(a, b).clamp_max(a.shape[1] - 1)) == b) & first
    return float((found.sum(1).double() / a.shape[1]).mean())


# the kernel sizes phases 2 and 3 time (each size is checked); the others were
# cut to make room for phases 12 and 13 (PERF.md §4)
TIMED_FLAT_K = (3, 5, 128, 256, 512)
TIMED_PANEL_K = (64, 128, 512)
# instances no path of the smoke launches, timed over fewer calls to make
# room for phase 16 (PERF.md §4): B1 at k = 256, B2 at k = 512
UNLAUNCHED_FLAT_K, UNLAUNCHED_PANEL_K, UNLAUNCHED_REPS = (256,), (512,), 3
# the list lengths the order checks of phases 2 and 3 drive (k > 64: BufRows)
ORDER_CHECK_K = (128, 512)


def ladder_rows(torch, dev, n: int, d: int = 384):
    """f32 [n, d] rows whose entries (integers 0..255, exact in bf16) sum
    to the row's index, each entry nondecreasing along the rows: for a
    query of positive weights every row scores above the rows before it,
    and the l2 distance from a later row falls row by row up to it. Every
    product and (below ~2^24) every distance is an exact integer in f32."""
    i = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
    j = torch.arange(d, device=dev, dtype=torch.float32)[None, :]
    return (i - 255.0 * j).clamp(0.0, 255.0)


def lower_twin_first(torch, ids, dists, half: int, own=None) -> bool:
    """Rows i and i + half of the corpus are equal: each row's list is sorted
    by (distance, id), and wherever an upper twin is returned its lower twin
    is too (so before it, at the same distance), unless the lower one is the
    query's own row ``own``."""
    ids = ids.long()
    ordered = (dists[:, 1:] > dists[:, :-1]) | ((dists[:, 1:] == dists[:, :-1]) & (ids[:, 1:] > ids[:, :-1]))
    twin = ids - half
    need = ids >= half
    if own is not None:
        need &= twin != own[:, None]
    srt = torch.sort(ids, dim=1).values
    found = srt.gather(1, torch.searchsorted(srt, twin.clamp_min(0)).clamp_max(ids.shape[1] - 1)) == twin
    return bool(ordered.all()) and bool((found | ~need).all())


def order_checks(torch, dev, rng, kernel: str) -> None:
    """Phases 2-3, untimed: the kernel at ORDER_CHECK_K where every column
    beats the bar (ladder_rows) against its plain version (identical ids and
    distances), and over duplicated rows (lower_twin_first)."""
    from leann_torch.ops.distance import flat_search
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.ops.knn_panel import knn_panel, knn_panel_plain, panel_inputs

    for k in ORDER_CHECK_K:
        if kernel == "flat_topk":
            e = ladder_rows(torch, dev, 65_536).to(torch.bfloat16).contiguous()
            q = torch.ones((64, 384), device=dev)
            q[:, 0] = torch.arange(64, device=dev, dtype=torch.float32) % 4 + 1
            got, want = flat_topk(q, e, None, e.shape[0], k, "mips"), flat_search(e, q, e.shape[0], k, "mips")
            half = 10_000
            x = torch.from_numpy(rng.standard_normal((half, 384)).astype(np.float32)).to(dev)
            x = torch.cat([x, x]) / x.norm(dim=1).repeat(2)[:, None]
            qd = torch.from_numpy(rng.standard_normal((64, 384)).astype(np.float32)).to(dev)
            ti, td = flat_topk(qd / qd.norm(dim=1, keepdim=True), x.to(torch.bfloat16).contiguous(), None, 2 * half, k,
                               "cosine")
            twins = lower_twin_first(torch, ti, td, half)
        else:
            ebf, norms = panel_inputs(ladder_rows(torch, dev, 16_384))
            args = (ebf, norms, k, 16_384 - 1000, 1000, 16_384)
            got, want = knn_panel(*args), knn_panel_plain(*args)
            half = 10_000
            x = torch.from_numpy(rng.standard_normal((half, 384)).astype(np.float32)).to(dev)
            xb, xn = panel_inputs(torch.cat([x, x]))
            ti, td = knn_panel(xb, xn, k)
            twins = lower_twin_first(torch, ti, td, half, own=torch.arange(2 * half, device=dev))
            twins = twins and bool((ti[:half, 0].long() == torch.arange(half, device=dev) + half).all())
        torch.cuda.synchronize()
        same = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        row = {"phase": kernel, "case": "order", "k": k, "every_column_beats_the_bar_identical": same,
               "duplicates_lower_twin_first": twins, "ok": same and twins}
        emit(row)
        if not row["ok"]:
            fail(f"{kernel} at k = {k} breaks the list order: {row}")


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
        # 3: the oracle's; 5: search's default top_k; above 64 buffered lists
        for k in (3, 5, 10, 16, 64, 128, 256, 257, 512):
            ik, dk = flat_topk(qm, e, en, n, k, metric)
            ip, dp = flat_search(e, qm, n, k, metric, en=en)
            torch.cuda.synchronize()
            ov = overlap(ik, ip)
            rel = float(((dk - dp).abs() / dp.abs().clamp_min(1e-6)).max())
            err = float((dk - dp).abs().max())
            ok = ov >= 0.95 and torch.allclose(dk, dp, rtol=1e-2, atol=1e-2) and int(ik.max()) < n
            if k > 256:  # the longest lists are held tighter
                ok = ok and ov == 1.0 and (err if metric == "cosine" else rel) <= 1e-5
            ik2, dk2 = flat_topk(qm, e, en, n, k, metric)
            same = bool(torch.equal(ik, ik2) and torch.equal(dk, dk2))  # deterministic
            row = {"phase": "flat_topk", "metric": metric, "k": k, "shape": [b, n, d], "overlap": ov,
                   "max_rel_err": rel, "max_abs_err": err, "deterministic": same, "ok": bool(ok and same)}
            # every (metric, k) is checked; timed are the oracle's k (3), search's
            # default top_k (5), the buffered lists at k2 = 128, 256 and 512,
            # l2 at k = 3 only (the profiles are the run's largest cost)
            if k == 3 or (metric == "cosine" and k in TIMED_FLAT_K):
                qb = qm.to(torch.bfloat16)

                def kernel():
                    return flat_topk(qm, e, en, n, k, metric)

                if metric == "l2":
                    lib = lambda: torch.topk(2.0 * (qb @ e.T).float() - en, k)  # noqa: E731
                else:
                    lib = lambda: torch.topk(qb @ e.T, k)  # noqa: E731
                reps = UNLAUNCHED_REPS if k in UNLAUNCHED_FLAT_K else 10
                (k_ms, k_parts, k_att), (l_ms, _, l_att) = device_ms_many(torch, [(kernel, reps), (lib, reps)])
                c_ms = cuda_ms(torch, kernel, reps=reps)
                p_ms = cuda_ms(torch, lambda: flat_search(e, qm, n, k, metric, en=en), reps=3)
                n_bytes = n * d * 2 + b * d * 4 + (n * 4 if metric == "l2" else 0) + b * k * 8
                b_ms, b_by = bound(n_bytes, 2.0 * b * n * d)
                row.update(kernel_ms=k_ms, kernel_parts_ms=k_parts, profile=k_att, call_ms=c_ms, plain_ms=p_ms,
                           library_ms=l_ms, library_profile=l_att, bound_ms=b_ms, bound_by=b_by)
            emit(row)
            if not ok:
                fail(f"flat_topk disagrees with its plain version: {row}")
            if not same:
                fail(f"flat_topk gave different results in two launches: {row}")
            if metric == "cosine" and k in (3, 512):  # the oracle's calls: top-3 on the main path, top-512
                main[k] = row
    order_checks(torch, dev, rng, "flat_topk")
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
        if k > 256:  # the longest lists are held tighter
            ok = ok and ov >= 0.99999 and err <= 1e-5
        ik2, dk2 = knn_panel(ebf, norms, k, q_start, q_count, n_real)
        same = bool(torch.equal(ik, ik2) and torch.equal(dk, dk2))  # deterministic
        del ik2, dk2
        row = {"phase": "knn_panel", "shape": [q_count, n, d], "n_real": n_real, "k": k, "overlap": ov,
               "max_abs_err": err, "self_hits": self_hits, "pad_hits": pad_hits, "deterministic": same,
               "ok": bool(ok and same)}
        # every case is checked; timed are the builds' own launches (k = 64:
        # diskann, 128: hnsw at its defaults, 512: hnsw at M = 64, efC = 512)
        if q_count == n and k in TIMED_PANEL_K:

            def kernel():
                return knn_panel(ebf, norms, k, q_start, q_count, n_real)

            def lib():  # one matmul + topk over the same [q_count, n] panel, in 1024-row blocks
                for s in range(q_start, q_start + q_count, 1024):
                    qq = ebf[s : s + 1024]
                    torch.topk(2.0 * (qq @ ebf[:n_real].T).float() - norms[:n_real], k)

            (k_ms, k_parts, k_att), (l_ms, _, l_att) = device_ms_many(
                torch, [(kernel, 3 if k > 256 else 10), (lib, UNLAUNCHED_REPS if k in UNLAUNCHED_PANEL_K else 10)])
            c_ms = cuda_ms(torch, kernel, reps=3 if q_count > 4096 else 10)
            p_ms = cuda_ms(torch, plain, reps=1)
            n_bytes = n * d * 2 + n * 4 + q_count * k * 8
            b_ms, b_by = bound(n_bytes, 2.0 * q_count * n_real * d)
            row.update(kernel_ms=k_ms, kernel_parts_ms=k_parts, profile=k_att, call_ms=c_ms, plain_ms=p_ms,
                       library_ms=l_ms, library_profile=l_att, bound_ms=b_ms, bound_by=b_by)
        emit(row)
        if not ok:
            fail(f"knn_panel disagrees with its plain version: {row}")
        if not same:
            fail(f"knn_panel gave different results in two launches: {row}")
        if q_count == n:  # a build's own launch: all rows, D = 384
            main[k] = row
        del emb, ebf, norms, ik, dk, ip, dp
        torch.cuda.empty_cache()
    order_checks(torch, dev, rng, "knn_panel")
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

    t0 = time.time()
    rng = np.random.default_rng(0)
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
        knn_seen["graph_data"] = a[0]  # and the matrix it ran on (cosine: the unit rows), for phase 14
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
    kw = SEARCH_KW
    got, ms_q = _timed_search(torch, searcher, queries, **kw)
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
           "recall_at_3": recall, "search_ms_per_query": ms_q,
           "all_in_bytes": index_all_in_bytes(prefix), "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    emit({"phase": "search_profile", **profile})
    if recall < 0.80:
        fail(f"recall@3 {recall:.4f} below the 0.80 sanity floor")
    for name, cnt in launches.items():
        if cnt < 1:
            fail(f"kernel {name} was not launched on the main path")
    main = {"chunks": chunks, "queries": queries, "q_idx": q_idx, "truth": truth, "prefix": prefix,
            "oracle": oracle_prefix, "knn_ids": knn_seen["ids"], "graph_data": knn_seen["graph_data"],
            "recall": recall, "kw": kw, "got": got,
            "search_ms_per_query": ms_q}
    return launches, main


def phase_hnsw_path(torch, workdir: str, main):
    """The default backend over phase 4's chunks, scored against its oracle."""
    from leann_torch import LeannBuilder, LeannSearcher
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
    got, ms_q = _timed_search(torch, searcher, queries, **kw)
    launches = {"flat_topk": flat_topk.launches, "knn_panel": knn_panel.launches}
    profile = search_profile(torch, lambda: searcher.search(queries, **kw))

    # hops and exact distances per query: the same batch once more through
    # the search program, which returns them per lane
    be = searcher.backend
    cfg, params = be._make_cfg(3, complexity=64, beam_width=8)
    q_ids, q_mask = be._encoder().tokenize(queries)
    dev = be.device
    _, _, steps, n_exact = beam_search_text_batch(torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_mask).to(dev),
                                                  be._graph_data(), cfg, params)

    if len(got) != 64 or any(len(r) != 3 or not all(np.isfinite(x.score) for x in r) for r in got):
        fail("hnsw search did not return 3 finite results for each of 64 queries")
    recall = float(np.mean([len({x.id for x in a} & {x.id for x in b}) / 3 for a, b in zip(got, truth)]))
    row = {"phase": "hnsw_path", "n_chunks": len(chunks), "model": "hash-minilm", "backend": "hnsw",
           "M": 32, "efConstruction": 128, "knn_k": 128, "prune_keep": cfg.prune_keep,
           "traversal": cfg.traversal, "build_s": build_phases, "recall_at_3": recall,
           "search_ms_per_query": ms_q,
           "mean_steps": float(steps.float().mean()), "mean_n_exact": float(n_exact.float().mean()),
           "all_in_bytes": index_all_in_bytes(prefix), "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    emit({"phase": "hnsw_search_profile", **profile})
    if recall < 0.80:
        fail(f"hnsw recall@3 {recall:.4f} below the 0.80 sanity floor")
    if launches["knn_panel"] < 1:
        fail("kernel knn_panel was not launched on the hnsw path")
    main.update(hnsw_prefix=prefix, hnsw_kw=kw, hnsw_recall=recall, hnsw_got=got,
                hnsw_search_ms_per_query=ms_q)
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


def timed_rows(torch, specs) -> list:
    """For each (kernel, p_ms, lib, n_bytes, flops, reps) in ``specs``: the
    kernel's device and call time, beside its plain version's time ``p_ms``
    on the same inputs, a library call's time, and its bound on the card.
    Every kernel and library call of ``specs`` shares one profile window."""
    prof = device_ms_many(torch, [(f, reps) for kernel, _, lib, _, _, reps in specs for f in (kernel, lib)])
    rows = []
    for j, (kernel, p_ms, _, n_bytes, flops, reps) in enumerate(specs):
        (k_ms, k_parts, k_att), (l_ms, _, l_att) = prof[2 * j], prof[2 * j + 1]
        b_ms, b_by = bound(n_bytes, flops)
        rows.append({"kernel_ms": k_ms, "kernel_parts_ms": k_parts, "profile": k_att,
                     "call_ms": cuda_ms(torch, kernel, reps=reps), "plain_ms": p_ms, "library_ms": l_ms,
                     "library_profile": l_att, "bound_ms": b_ms, "bound_by": b_by})
    return rows


def one_window(torch, checked: dict) -> dict:
    """{key: (row, spec)} of checks -> {key: row with its times}, every
    spec timed in one profile window (one idle pad for all)."""
    keys = list(checked)
    times = timed_rows(torch, [checked[key][1] for key in keys])
    return {key: {**checked[key][0], **t} for key, t in zip(keys, times)}


def ext_check(torch, kp, q, qn, c, cn, k, col_id0, q_id0, reps: int = 3, d: int = 0):
    """knn_panel_ext at one (query rows x column slab) shape, checked against
    its plain version on every query row (one call of it timed) -> (row,
    the spec :func:`timed_rows` times it by). ``d``: the rows' width before
    the zero-padding to a multiple of 16, which the bound counts (0: the
    padded width)."""
    s_rows = q.shape[0]
    d = d or q.shape[1]
    m = c.shape[0]
    ik, dk = kp.knn_panel_ext(q, qn, c, cn, k, m, col_id0, q_id0)
    (ip, dp), p_ms = timed_once(torch, lambda: kp.knn_panel_ext_plain(q, qn, c, cn, k, m, col_id0, q_id0))
    ov = overlap(ik, ip)
    err = float((dk - dp).abs().max())
    del ip, dp

    def lib():  # one matmul + topk per 1024 query rows over the slab
        for s in range(0, s_rows, 1024):
            torch.topk(2.0 * (q[s : s + 1024] @ c.T).float() - cn, k)

    spec = (lambda: kp.knn_panel_ext(q, qn, c, cn, k, m, col_id0, q_id0), p_ms, lib,
            s_rows * (d * 2 + 4) + m * (d * 2 + 4) + s_rows * k * 8, 2.0 * s_rows * m * d, reps)
    return {"shape": [s_rows, m, d], "k": k, "overlap": ov, "max_abs_err": err}, spec


def merge_check(torch, kp, vals, ids):
    """topk_merge of [S, L, k] lists, checked against its plain version
    (identical) -> (row, the spec :func:`timed_rows` times it by)."""
    s_rows, lists, k = vals.shape
    ik, dk = kp.topk_merge(vals, ids)
    ip, dp = kp.topk_merge_plain(vals, ids)
    torch.cuda.synchronize()
    same = bool(torch.equal(ik, ip) and torch.equal(dk, dp))
    spec = (lambda: kp.topk_merge(vals, ids), cuda_ms(torch, lambda: kp.topk_merge_plain(vals, ids), 3),
            lambda: torch.topk(vals.reshape(s_rows, lists * k), k, largest=False),
            s_rows * lists * k * 8 + s_rows * k * 8, 0.0, 10)
    return {"shape": [s_rows, lists, k], "k": k, "identical": same, "max_abs_err": float((dk - dp).abs().max())}, spec


def _counts(counters) -> dict:
    return {c.__name__: c.launches for c in counters}


def _reset(counters) -> None:
    for c in counters:
        c.launches = 0


def phase_beyond_card_knn(torch, dev, seed: int, n: int = 1 << 20, rows_per_shard: int = 1 << 18,
                          qchunk: int = 1 << 17, n_sampled: int = 1024, keep: "dict | None" = None):
    """Phase 6 -> (kernel rows by (kernel, path), launches by path). ``keep``
    receives the rows and their one-pass exact ids (phase 16 scores spill
    against them)."""
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

    # each kernel at this phase's shapes, for the kernels line, all timed in
    # one profile window
    checked = {}
    q_count = min(graph.KNN_ROWS_PER_LAUNCH, n)
    (ip, dp), p_ms = timed_once(torch, lambda: kp.knn_panel_plain(ebf, norms, k, 0, q_count, n))
    ov = overlap(torch.from_numpy(i1[:q_count]), ip)
    err = float(np.abs(d1[:q_count] - dp.cpu().numpy()).max())
    del ip, dp

    def lib_one():
        for s in range(0, q_count, 1024):
            torch.topk(2.0 * (ebf[s : s + 1024] @ ebf.T).float() - norms, k)

    checked[("knn_panel", "beyond_card_knn/one_pass")] = (
        {"shape": [q_count, n, d], "k": k, "overlap": ov, "max_abs_err": err},
        (lambda: kp.knn_panel(ebf, norms, k, 0, q_count), p_ms, lib_one, n * (d * 2 + 4) + q_count * k * 8,
         2.0 * q_count * n * d, 1))
    slab = slice(rows_per_shard, 2 * rows_per_shard)
    q, qn = ebf[:qchunk].clone(), norms[:qchunk].clone()  # a chunk uploaded apart from the slab
    c, cn = ebf[slab], norms[slab]
    checked[("knn_panel_ext", "beyond_card_knn/sharded")] = ext_check(torch, kp, q, qn, c, cn, k, rows_per_shard,
                                                                      0, reps=2)
    run = kp.knn_panel_ext(q, qn, ebf[:rows_per_shard], norms[:rows_per_shard], k, rows_per_shard, 0, 0)
    new = kp.knn_panel_ext(q, qn, c, cn, k, rows_per_shard, rows_per_shard, 0)
    checked[("topk_merge", "beyond_card_knn/sharded")] = merge_check(
        torch, kp, torch.stack([run[1], new[1]], 1), torch.stack([run[0], new[0]], 1))
    qs, qsn = ebf[rows_t], norms[rows_t]
    c0, cn0 = ebf[:rows_per_shard], norms[:rows_per_shard]
    for kk in (64, 512):
        path = f"beyond_card_knn/rows_k{kk}"
        checked[("knn_panel_ext", path)] = ext_check(torch, kp, qs, qsn, c0, cn0, kk + 1, 0, -1)
        a = kp.knn_panel_ext(qs, qsn, c0, cn0, kk + 1, rows_per_shard, 0, -1)
        b = kp.knn_panel_ext(qs, qsn, c, cn, kk + 1, rows_per_shard, rows_per_shard, -1)
        checked[("topk_merge", path)] = merge_check(torch, kp, torch.stack([a[1], b[1]], 1),
                                                    torch.stack([a[0], b[0]], 1))
    kr = one_window(torch, checked)
    del checked, ebf, norms, q, qn, run, new, qs, qsn, c, cn, c0, cn0
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
    if keep is not None:
        keep.update(emb=emb, ids=i1)
    return kr, launches


def _labels_scores(results):
    return [[r.id for r in row] for row in results], np.array([[r.score for r in row] for row in results])


def _timed_search(torch, searcher, queries, warm: int = 0, **kw):
    """-> (the results of one timed search of ``queries``, ms per query),
    after a warm search of the first ``warm`` of them (0: all)."""
    searcher.search(queries[:warm] if warm else queries, **kw)
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
    # and the PQ-mode prune, as the JAX package's own tests force them; the
    # prune cap, the shard bytes and the chunk through the build's
    # environment variables, the k-NN cap (which has none) by assignment
    forced = {"exact_knn_max_n": max_n, "LEANN_PRUNE_EBF_MAX_BYTES": "1",
              "LEANN_EXACT_SHARD_BYTES": str(shard_rows * 2 * 384), "LEANN_EXACT_QCHUNK": str(qchunk)}
    saved = {"exact_knn_max_n": graph.exact_knn_max_n, **{name: os.environ.get(name) for name in forced if
                                                         name.startswith("LEANN_")}}
    graph.exact_knn_max_n = lambda d, k, device: forced["exact_knn_max_n"]
    os.environ.update({name: v for name, v in forced.items() if name.startswith("LEANN_")})
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
        graph.exact_knn_max_n = saved["exact_knn_max_n"]
        for name, v in saved.items():
            if name.startswith("LEANN_") and v is None:
                os.environ.pop(name, None)
            elif name.startswith("LEANN_"):
                os.environ[name] = v
    restored = {name: (os.environ.get(name) == v if name.startswith("LEANN_") else graph.exact_knn_max_n is v)
                for name, v in saved.items()}
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
    m = shard_rows
    q, qn = ebf[m : m + qchunk].clone(), norms[m : m + qchunk].clone()  # a chunk of the second shard
    a = kp.knn_panel_ext(q, qn, ebf[:m], norms[:m], 64, m, 0, m)
    b = kp.knn_panel_ext(q, qn, ebf[m:], norms[m:], 64, m, m, m)
    kr = one_window(torch, {
        ("knn_panel_ext", "beyond_card_path"): ext_check(torch, kp, q, qn, ebf[:m], norms[:m], 64, 0, m),
        ("topk_merge", "beyond_card_path"): merge_check(torch, kp, torch.stack([a[1], b[1]], 1),
                                                        torch.stack([a[0], b[0]], 1))})
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


def _recall(got, truth, k: int = 3) -> float:
    return float(np.mean([len({x.id for x in a} & {x.id for x in b}) / k for a, b in zip(got, truth)]))


def panel_check(torch, kp, ebf, norms, k: int, d: int):
    """knn_panel over every row of a build's corpus at its k, checked against
    its plain version (one call of it timed) -> (row, the spec
    :func:`timed_rows` times it by). ``d`` is the rows' width before the
    zero-padding to a multiple of 16, the width the bound counts."""
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

    spec = (lambda: kp.knn_panel(ebf, norms, k), p_ms, lib, n * (d * 2 + 4) + n * k * 8, 2.0 * n * n * d, 3)
    return {"shape": [n, n, d], "padded_d": ebf.shape[1], "k": k, "overlap": ov, "max_abs_err": err,
            "self_hits": self_hits}, spec


# phase 8's insert: two batches (256 chunks in two of 128 until phase 14
# came)
LIFECYCLE_NEW_CHUNKS, LIFECYCLE_BATCH = 128, 64


def phase_lifecycle(torch, dev, workdir: str, main: dict):
    """Phase 8 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.backends.diskann.partition import edge_locality
    from leann_torch.embeddings.compute import compute_embeddings
    from leann_torch.ops import graph
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.repack import repack_index, unrelabel_index
    from leann_torch.storage import index_all_in_bytes, load_partition, save_partition, unpack_neighbors

    chunks, queries, truth, kw = main["chunks"], main["queries"], main["truth"], main["kw"]
    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches = {}
    n = len(chunks)

    # (a) insert: new chunks into copies of phase 5's hnsw index and of
    # phase 4's flat oracle, in two batches (the second discovery searches a
    # graph the first one grew)
    new = synth_corpus(LIFECYCLE_NEW_CHUNKS, np.random.default_rng(8))
    new_queries = [" ".join(new[i].split()[:12])
                   for i in np.random.default_rng(8).choice(LIFECYCLE_NEW_CHUNKS, 64, replace=False)]
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
    u.update_index(hnsw, insert_batch_size=LIFECYCLE_BATCH)
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
    main["emb"] = emb  # phase 16 builds from them again
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

    # the kernels of these paths at their shapes, on their inputs, in one profile window
    ebf_d, norms_d = kp.upload_panel_inputs(emb, dev)
    ebf_h, norms_h = kp.upload_panel_inputs(emb.astype(np.float16), dev)
    kr = one_window(torch, {
        ("flat_topk", "flat_update"): oracle_check(torch, dev, fs, queries),
        ("knn_panel", "from_embeddings_diskann"): panel_check(torch, kp, ebf_d, norms_d, 64, emb.shape[1]),
        ("knn_panel", "from_embeddings_hnsw_f16"): panel_check(torch, kp, ebf_h, norms_h, 128, emb.shape[1])})
    del ebf_d, norms_d, ebf_h, norms_h
    torch.cuda.empty_cache()

    row = {"phase": "lifecycle", "n_chunks": n, "n_inserted": len(new), "insert_batch_size": LIFECYCLE_BATCH,
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


# all-MiniLM-L6-v2's published config.json: its widths, 12 heads, 512 positions
MINILM_L6 = dict(vocab_size=30522, dim=384, n_layers=6, n_heads=12, mlp_dim=1536, max_len=512)


def minilm_checkpoint(path: str) -> dict:
    """A checkpoint directory at all-MiniLM-L6-v2's widths: seeded weights
    (``init_params`` at that config) written by the port's
    ``save_hf_weights``, an uncased WordPiece ``vocab.txt`` of 30,522 lines
    and its ``tokenizer_config.json``. The vocab holds the special tokens,
    every letter and digit whole and as a ``##`` piece, the two-digit
    ``##`` pieces, the corpus words w0..w19999 whole, and ``[unusedN]``, so
    each ``synth_corpus`` word is covered (w20000 and up, g* and d* words as
    a stem and ``##`` continuations) and no token is ``[UNK]``."""
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te

    cfg = replace(te.EncoderConfig(), name="minilm-l6-seeded", arch="bert", **MINILM_L6)
    te.save_hf_weights(te.init_params(cfg), cfg, path)
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars + ["##" + c for c in chars]
    vocab += [f"##{i:02d}" for i in range(100)] + [f"w{i}" for i in range(20_000)]
    vocab += [f"[unused{i}]" for i in range(MINILM_L6["vocab_size"] - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "tokenizer_class": "BertTokenizer", "model_max_length": 512}, f)
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def indexes_from_dir(torch, workdir: str, model_dir: str, tag: str, chunks, queries, counters, launches) -> dict:
    """A diskann index at phase 4's settings and a flat oracle, each built
    from a checkpoint directory (each loads the weights and calibrates on
    the corpus), the oracle's top-3 of the queries, and each path's kernel
    launches in ``launches[f"{tag}_diskann"]`` / ``[f"{tag}_oracle"]`` (its
    counts set to 0 just before it). -> {prefix, builder, oracle_prefix,
    oracle, oracle_searcher, truth, emb, k}: the build's k-NN operands."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.ops import graph

    out = {"prefix": os.path.join(workdir, f"{tag}_diskann.leann"),
           "oracle_prefix": os.path.join(workdir, f"{tag}_flat.leann")}
    real_exact_knn = graph.exact_knn

    def recording_exact_knn(emb, k, *a, **kw):  # keeps the build's embeddings and k; launches nothing itself
        out["emb"], out["k"] = emb, k
        return real_exact_knn(emb, k, *a, **kw)

    _reset(counters)
    builder = LeannBuilder(backend_name="diskann", embedding_model=model_dir, max_length=128, graph_degree=32)
    for c in chunks:
        builder.add_text(c)
    graph.exact_knn = recording_exact_knn
    try:
        torch.cuda.synchronize()
        builder.build_index(out["prefix"])
        torch.cuda.synchronize()
    finally:
        graph.exact_knn = real_exact_knn
    launches[f"{tag}_diskann"] = _counts(counters)
    _reset(counters)
    oracle = LeannBuilder(backend_name="flat", embedding_model=model_dir, max_length=128)
    for c in chunks:
        oracle.add_text(c)
    oracle.build_index(out["oracle_prefix"])
    out["oracle_searcher"] = LeannSearcher(out["oracle_prefix"])
    out["truth"] = out["oracle_searcher"].search(queries, top_k=3)
    torch.cuda.synchronize()
    launches[f"{tag}_oracle"] = _counts(counters)
    out.update(builder=builder, oracle=oracle)
    return out


def phase_checkpoint(torch, dev, workdir: str, chunks, queries):
    """Phase 9 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch import BatchedSearcher, LeannSearcher
    from leann_torch.api import PassageManager
    from leann_torch.embeddings.encoder import get_encoder
    from leann_torch.embeddings.tokenizer import HashTokenizer, HFTokenizer, bert_pipeline
    from leann_torch.embeddings.tokenizer_json import JsonTokenizer, read_config
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.storage import index_all_in_bytes, load_token_cache

    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches = {}
    ckpt = os.path.join(workdir, "minilm-l6-seeded")
    t = time.time()
    hf_config = minilm_checkpoint(ckpt)
    write_s = time.time() - t

    # the diskann build and the flat oracle from the directory
    built = indexes_from_dir(torch, workdir, ckpt, "checkpoint", chunks, queries, counters, launches)
    prefix, oracle_prefix, oracle_searcher, truth = (built[k] for k in (
        "prefix", "oracle_prefix", "oracle_searcher", "truth"))
    build_phases = dict(built["builder"].phase_seconds)
    enc = get_encoder(ckpt, max_length=128, device=dev)
    tok, tok_lengths = load_token_cache(prefix)
    unk_share = float((tok == enc.tokenizer.unk_id).mean()) if isinstance(enc.tokenizer, HFTokenizer) else None
    calib = {name: np.load(p + ".calib.npz") for name, p in (("diskann", prefix), ("flat", oracle_prefix))
             if os.path.exists(p + ".calib.npz")}
    calib_diff = (max(float(np.abs(calib["diskann"][k] - calib["flat"][k]).max()) for k in ("out_center", "out_pc"))
                  if len(calib) == 2 else None)

    # the searches: direct, then the same queries from 8 threads through the batcher
    searcher = LeannSearcher(prefix)
    got, ms_q = _timed_search(torch, searcher, queries, **SEARCH_KW)
    recall = _recall(got, truth)
    labels, scores = _labels_scores(got)

    def through_batcher(bs):
        out = [None] * len(queries)

        def worker(w):
            for i in range(w, len(queries), 8):
                out[i] = bs.search(queries[i], timeout=600, **SEARCH_KW)

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads) or any(o is None for o in out):
            fail("the batcher did not answer every query")
        return out

    with BatchedSearcher(searcher, max_batch=16, max_wait_ms=2) as bs:
        through_batcher(bs)  # warm: the batches' shapes
        b0, q0 = bs.batches_run, bs.queries_run
        torch.cuda.synchronize()
        t = time.time()
        batched = through_batcher(bs)
        torch.cuda.synchronize()
        batcher_ms_q = (time.time() - t) * 1e3 / len(queries)
        n_batches, n_q = bs.batches_run - b0, bs.queries_run - q0
    b_labels, b_scores = _labels_scores(batched)
    differing = []
    for i, (a, b) in enumerate(zip(labels, b_labels)):
        if a != b:
            differing.append({"query": i, "direct": a, "batched": b,
                              "score_gap": float(np.abs(scores[i] - b_scores[i]).max())})

    # the host runtime against the Python paths: the hash tokenizer, the
    # WordPiece, the passage store
    hash_tok = HashTokenizer(vocab_size=32768, max_length=128)
    (n_ids, n_mask), native_s = _timed(lambda: hash_tok.encode_batch(chunks))
    (p_ids, p_mask), python_s = _timed(lambda: hash_tok.encode_batch_python(chunks))
    tokens_equal = bool(np.array_equal(n_ids, p_ids) and np.array_equal(n_mask, p_mask))
    del n_ids, n_mask, p_ids, p_mask
    (wp_ids, _), wordpiece_s = _timed(lambda: HFTokenizer(ckpt, max_length=128).encode_batch(chunks))
    # the same WordPiece from a tokenizer.json (as BertTokenizerFast saves it) in a directory of its own
    json_dir = os.path.join(workdir, "minilm-l6-tokenizer-json")
    os.makedirs(json_dir, exist_ok=True)
    with open(os.path.join(ckpt, "vocab.txt"), encoding="utf-8") as f:
        vocab_lines = [ln.rstrip("\n") for ln in f]
    shutil.copy(os.path.join(ckpt, "tokenizer_config.json"), json_dir)
    with open(os.path.join(json_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(bert_pipeline(vocab_lines, read_config(ckpt)), f)
    (tj_ids, _), tokenizer_json_s = _timed(lambda: JsonTokenizer(json_dir, max_length=128).encode_batch(chunks))
    routes_equal = bool(np.array_equal(wp_ids, tj_ids))
    del wp_ids, tj_ids
    with open(prefix + ".meta.json") as f:
        sources = json.load(f)["passage_sources"]
    native_pm, (plain_pm, _) = PassageManager(sources), _timed(lambda: PassageManager(sources, use_native=False))
    pids = [str(i) for i in np.random.default_rng(9).choice(len(chunks), min(10_000, len(chunks)), replace=False)]
    native_texts, native_lookup_s = _timed(lambda: [native_pm.get_passage(p)["text"] for p in pids])
    plain_texts, plain_lookup_s = _timed(lambda: [plain_pm.get_passage(p)["text"] for p in pids])
    passages_equal = native_texts == plain_texts == [chunks[int(p)] for p in pids]

    # each kernel at this path's shapes, on its inputs
    ebf, norms = kp.upload_panel_inputs(built["emb"], dev)
    kr = one_window(torch, {
        ("knn_panel", "checkpoint_diskann"): panel_check(torch, kp, ebf, norms, built["k"], built["emb"].shape[1]),
        ("flat_topk", "checkpoint_oracle"): oracle_check(torch, dev, oracle_searcher, queries)})
    del ebf, norms
    torch.cuda.empty_cache()

    row = {"phase": "checkpoint", "n_chunks": len(chunks), "model": "all-MiniLM-L6-v2 widths, seeded weights",
           "hf_config": {k: hf_config[k] for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                                   "num_attention_heads", "intermediate_size",
                                                   "max_position_embeddings")},
           "write_checkpoint_s": write_s, "loaded_hf": enc.loaded_hf, "tokenizer": type(enc.tokenizer).__name__,
           "unk_share": unk_share, "mean_tokens": float(tok_lengths.mean()),
           "calib_files": sorted(calib), "calib_max_diff": calib_diff,
           "build_s": build_phases, "flat_build_s": dict(built["oracle"].phase_seconds), "knn_k": built["k"],
           "recall_at_3": recall, "search_ms_per_query": ms_q, "search_kw": SEARCH_KW,
           "batcher": {"max_batch": 16, "max_wait_ms": 2, "threads": 8, "ms_per_query": batcher_ms_q,
                       "batches_run": n_batches, "mean_batch": n_q / max(n_batches, 1),
                       "labels_differing": differing},
           "hash_tokenizer": {"texts": len(chunks), "native_s": native_s, "python_s": python_s,
                              "equal": tokens_equal},
           "wordpiece_s": wordpiece_s, "wordpiece_tokenizer_json_s": tokenizer_json_s,
           "wordpiece_routes_equal": routes_equal,
           "passages": {"lookups": len(pids), "native_s": native_lookup_s, "offset_map_s": plain_lookup_s,
                        "equal": passages_equal},
           "all_in_bytes": index_all_in_bytes(prefix), "launches": launches,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()}}
    emit(row)
    if not (enc.loaded_hf and isinstance(enc.tokenizer, HFTokenizer)):
        fail(f"the checkpoint did not load as one: loaded_hf {enc.loaded_hf}, {type(enc.tokenizer).__name__}")
    if unk_share != 0.0:
        fail(f"[UNK] share {unk_share} on the corpus")
    if not routes_equal:
        fail("the WordPiece from tokenizer.json gave other ids than the one from vocab.txt")
    if calib_diff is None or calib_diff > 1e-6:
        fail(f"the two builds' .calib.npz are missing or differ: {sorted(calib)}, max diff {calib_diff}")
    if launches["checkpoint_diskann"]["knn_panel"] != 1 or built["k"] != 64:
        fail(f"the diskann build did not launch knn_panel once at k = 64: {launches}, k {built['k']}")
    if launches["checkpoint_oracle"]["flat_topk"] != 1:
        fail(f"the oracle did not launch flat_topk once: {launches}")
    if recall < 0.80:
        fail(f"checkpoint recall@3 {recall:.4f} below the 0.80 sanity floor")
    if any(d["score_gap"] >= 1e-5 for d in differing):
        fail(f"the batcher's labels differ from the direct search's beyond near-ties: {differing}")
    if not (tokens_equal and passages_equal):
        fail(f"native and Python paths disagree: tokens {tokens_equal}, passages {passages_equal}")
    check_rows(kr)
    return kr, launches, {"ckpt": ckpt, "got": got, "truth": truth}


def check_rows(kr) -> None:
    for (name, path), r in kr.items():
        if r["overlap"] < 0.999 or r["max_abs_err"] > 1e-5 or r.get("self_hits", 0):
            fail(f"{name} on {path} disagrees with its plain version: {r}")


def oracle_check(torch, dev, oracle_searcher, queries, k: int = 3, q=None):
    """flat_topk at k over a flat index's rows, with the index's query
    vectors (``q``, else the index's encoder on ``queries``), checked
    against its plain version -> (row, the spec :func:`timed_rows` times
    it by)."""
    from leann_torch.ops.distance import flat_search, pad_features
    from leann_torch.ops.flat_topk import flat_topk

    be = oracle_searcher.backend
    metric = be.metric
    if q is None:
        q = be.get_encoder().encode(queries)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = q.shape[1]  # the width before the zero-padding: the bound counts this
    q = pad_features(torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev))
    n_flat = be.n
    ik, dk = flat_topk(q, be._emb, be._en, n_flat, k, metric)
    (ip, dp), p_ms = timed_once(torch, lambda: flat_search(be._emb, q, n_flat, k, metric, en=be._en))
    qb = q.to(torch.bfloat16)
    spec = (lambda: flat_topk(q, be._emb, be._en, n_flat, k, metric), p_ms, lambda: torch.topk(qb @ be._emb.T, k),
            n_flat * d * 2 + q.shape[0] * d * 4 + q.shape[0] * k * 8, 2.0 * q.shape[0] * n_flat * d, 10)
    return {"shape": [q.shape[0], n_flat, d], "padded_d": be._emb.shape[1], "k": k, "metric": metric,
            "overlap": overlap(ik, ip), "max_abs_err": float((dk - dp).abs().max())}, spec

# phase 10: benchmarks/train_encoder.py:65-67's batch and learning rate; its
# 800 steps cut to 50 for the smoke's time (200 until phase 12 came, 100
# until phase 14)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR = 50, 256, 1e-4
TRAIN_Q_LEN, TRAIN_D_LEN = 32, 128


def _hits(results, q_idx) -> float:
    """Share of the queries whose source chunk is among their results."""
    return float(np.mean([str(int(i)) in {r.id for r in row} for i, row in zip(q_idx, results)]))


def phase_repair(torch, main: dict) -> dict:
    """The searches read no precision flag: phase 4's diskann and phase 5's
    hnsw searches under "highest" and then under a caller's "high" (TF32
    products allowed) give identical labels and scores, and a caller who set
    "high" reads "high" after a BatchedSearcher batch."""
    from leann_torch import BatchedSearcher, LeannSearcher

    queries = main["queries"]
    paths = {}
    prev = torch.get_float32_matmul_precision()
    try:
        for name, prefix, kw, first in (("diskann", main["prefix"], main["kw"], main["got"]),
                                        ("hnsw", main["hnsw_prefix"], main["hnsw_kw"], main["hnsw_got"])):
            searcher = LeannSearcher(prefix)
            res = {}
            for precision in ("highest", "high"):
                torch.set_float32_matmul_precision(precision)
                got, ms = _timed_search(torch, searcher, queries, **kw)
                res[precision] = (_labels_scores(got), ms)
            (la, sa), (lb, sb) = res["highest"][0], res["high"][0]
            paths[name] = {"identical": bool(la == lb and np.array_equal(sa, sb)),
                           "labels_differing": int(sum(a != b for a, b in zip(la, lb))),
                           "max_score_diff": float(np.abs(sa - sb).max()),
                           "same_as_first_run": _labels_scores(first)[0] == la,
                           "ms_per_query_highest": res["highest"][1], "ms_per_query_high": res["high"][1]}
        torch.set_float32_matmul_precision("high")
        with BatchedSearcher(LeannSearcher(main["prefix"]), max_batch=16, max_wait_ms=2) as bs:
            bs.search(queries[0], timeout=600, **main["kw"])
        after_batch = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    row = {"phase": "precision_repair", "paths": paths, "setting_after_batch": after_batch}
    emit(row)
    if not all(p["identical"] for p in paths.values()):
        fail(f"a search under a caller's 'high' differs from the same search under 'highest': {paths}")
    if after_batch != "high":
        fail(f"the caller's 'high' read {after_batch!r} after a BatchedSearcher batch")
    return row


def phase_train(torch, dev, workdir: str, main: dict, ckpt_state: dict):
    """Phase 10 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch import LeannSearcher
    from leann_torch.embeddings.encoder import load_hf_weights, save_hf_weights
    from leann_torch.embeddings.tokenizer import HFTokenizer
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.parallel.train import ContrastiveTrainer
    from leann_torch.storage import index_all_in_bytes

    chunks, queries, q_idx = main["chunks"], main["queries"], main["q_idx"]
    ckpt = ckpt_state["ckpt"]
    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches = {}

    # the pairs: (12-word prefix -> chunk), the 64 eval chunks left out
    rng = np.random.default_rng(10)
    picks = rng.choice(np.setdiff1d(np.arange(len(chunks)), q_idx), TRAIN_STEPS * TRAIN_BATCH, replace=False)
    tok = HFTokenizer(ckpt, max_length=TRAIN_D_LEN)
    t = time.time()
    q_ids, q_mask = tok.encode_batch([" ".join(chunks[i].split()[:12]) for i in picks], TRAIN_Q_LEN)
    d_ids, d_mask = tok.encode_batch([chunks[i] for i in picks], TRAIN_D_LEN)
    tokenize_s = time.time() - t

    def batch(step):
        sl = slice(step * TRAIN_BATCH, (step + 1) * TRAIN_BATCH)
        return q_ids[sl], q_mask[sl], d_ids[sl], d_mask[sl]

    params, cfg = load_hf_weights(ckpt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    trainer = ContrastiveTrainer(cfg, learning_rate=TRAIN_LR, params=params, device=dev)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(TRAIN_STEPS - 1):
        t = time.time()
        losses.append(trainer.train_step(*batch(step)))  # a float: the step has ended on the card
        step_s.append(time.time() - t)
    profile = search_profile(torch, lambda: losses.append(trainer.train_step(*batch(TRAIN_STEPS - 1))))
    train_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches["train"] = _counts(counters)
    warm = range(5, TRAIN_STEPS - 1)
    warm_s = sum(step_s[i] for i in warm)
    real_tokens = sum(int(q_mask[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH].sum())
                      + int(d_mask[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH].sum()) for i in warm)

    tuned = os.path.join(workdir, "minilm-l6-tuned")
    t = time.time()
    save_hf_weights(trainer.params, cfg, tuned)
    save_s = time.time() - t
    for f in ("vocab.txt", "tokenizer_config.json"):
        shutil.copy(os.path.join(ckpt, f), tuned)
    del trainer, params
    torch.cuda.empty_cache()

    # the diskann index (phase 4's settings) and the flat oracle from the trained directory
    built = indexes_from_dir(torch, workdir, tuned, "trained", chunks, queries, counters, launches)
    truth = built["truth"]
    got, ms_q = _timed_search(torch, LeannSearcher(built["prefix"]), queries, **SEARCH_KW)
    recall = _recall(got, truth)

    ebf, norms = kp.upload_panel_inputs(built["emb"], dev)
    kr = one_window(torch, {
        ("knn_panel", "trained_diskann"): panel_check(torch, kp, ebf, norms, built["k"], built["emb"].shape[1]),
        ("flat_topk", "trained_oracle"): oracle_check(torch, dev, built["oracle_searcher"], queries)})
    del ebf, norms
    torch.cuda.empty_cache()

    row = {"phase": "train", "model": "all-MiniLM-L6-v2 widths, phase 9's seeded checkpoint",
           "pairs": len(picks), "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
           "q_len": TRAIN_Q_LEN, "d_len": TRAIN_D_LEN, "tokenize_s": tokenize_s,
           "loss_first": losses[0], "loss_last": losses[-1], "loss_every_20": losses[::20],
           "train_s": train_s, "warm_ms_per_step": warm_s * 1e3 / len(warm),
           "first_step_ms": step_s[0] * 1e3,
           "tokens_per_s_real": real_tokens / warm_s,
           "tokens_per_s_padded": len(warm) * TRAIN_BATCH * (TRAIN_Q_LEN + TRAIN_D_LEN) / warm_s,
           "peak_mem_gb": peak_gb, "save_checkpoint_s": save_s,
           "build_s": dict(built["builder"].phase_seconds), "flat_build_s": dict(built["oracle"].phase_seconds),
           "knn_k": built["k"], "recall_at_3": recall, "search_ms_per_query": ms_q,
           "hit_at_3": {"before": {"diskann": _hits(ckpt_state["got"], q_idx),
                                   "oracle": _hits(ckpt_state["truth"], q_idx)},
                        "after": {"diskann": _hits(got, q_idx), "oracle": _hits(truth, q_idx)}},
           "all_in_bytes": index_all_in_bytes(built["prefix"]), "launches": launches,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()},
           "reduced": f"800 steps (benchmarks/train_encoder.py) cut to {TRAIN_STEPS} for the smoke's time"}
    emit(row)
    emit({"phase": "train_step_profile", **profile})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"the training loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches["trained_diskann"]["knn_panel"] != 1 or built["k"] != 64:
        fail(f"the trained checkpoint's build did not launch knn_panel once at k = 64: {launches}, k {built['k']}")
    if launches["trained_oracle"]["flat_topk"] != 1:
        fail(f"the trained checkpoint's oracle did not launch flat_topk once: {launches}")
    if recall < 0.80:
        fail(f"trained-checkpoint recall@3 {recall:.4f} below the 0.80 sanity floor")
    check_rows(kr)
    return kr, launches


# phase 11: a generated document folder (a user's notes and a mid-size code
# repository) through the port's command line, MCP server and HTTP mode
SURFACE_SIZES = dict(n_prose=1500, n_py=400, n_brace=100)
# words that only ignored or hidden files hold: no passage may contain one
SURFACE_MARKERS = {"build/": "zqbuildmarker", ".private/": "zqprivatemarker", "ignored/": "zqignoredmarker"}
PDF_PHRASE = "zqpdfphrase quarterly planning memo"
# the CLI's search defaults (leann_torch/cli.py: --top-k 5 --complexity 64 --beam-width 8)
CLI_SEARCH_KW = dict(top_k=5, complexity=64, beam_width=8)


def write_flate_pdf(path, lines) -> None:
    """A one-page PDF whose text is one FlateDecode content stream of Tj
    operators, the form the loaders' built-in reader parses."""
    import zlib

    ops = ["BT", "/F1 11 Tf", "72 760 Td"]
    for ln in lines:
        esc = ln.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
        ops += [f"({esc}) Tj", "0 -14 Td"]
    ops.append("ET")
    stream = zlib.compress("\n".join(ops).encode("latin-1"))
    while stream.endswith((b"\r", b"\n")):  # the reader strips line ends before inflating
        ops.append("")
        stream = zlib.compress("\n".join(ops).encode("latin-1"))
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>", b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
            b"/Resources << /Font << /F1 4 0 R >> >> /Contents 5 0 R >>",
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
            b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(stream) + stream + b"\nendstream"]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    out += b"".join(b"%010d 00000 n \n" % off for off in offsets)
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (len(objs) + 1, xref)
    with open(path, "wb") as f:
        f.write(bytes(out))


def _py_module(rng, words, i: int) -> str:
    """A Python module: a docstring, imports, functions with docstrings and
    bodies, and a class with methods."""
    def w(n):
        return " ".join(rng.choice(words, n))

    def ident():
        return "_".join(rng.choice(words, 2))

    lines = [f'"""Module m{i}: {w(12)}."""', "", "import math", "import os", "",
             f"LIMIT_{i} = {int(rng.integers(8, 512))}", ""]
    for _ in range(int(rng.integers(10, 18))):
        args = [ident() for _ in range(3)]
        v = ident()
        lines += [f"def {ident()}({', '.join(args)}):", f'    """{w(int(rng.integers(8, 20)))}."""',
                  f"    {v} = {args[0]} * {int(rng.integers(2, 9))} + {args[1]}",
                  f"    if {v} > LIMIT_{i}:", f"        # {w(6)}", f"        return math.sqrt({v}) - {args[2]}",
                  f"    for _ in range({int(rng.integers(2, 6))}):", f"        {v} = {v} // 2 + len(os.sep)",
                  f"    return {v}", "", ""]
    lines += [f"class {ident().title().replace('_', '')}:", f'    """{w(16)}."""', "",
              "    def __init__(self, size):", "        self.size = size", ""]
    for _ in range(int(rng.integers(4, 10))):
        lines += [f"    def {ident()}(self, value):", f'        """{w(10)}."""',
                  f"        return self.size * value + {int(rng.integers(1, 99))}", ""]
    return "\n".join(lines) + "\n"


def _brace_file(rng, words, lang: str, i: int) -> str:
    """A TypeScript, Go or Java file with balanced braces: functions or
    methods with comments and string literals that hold braces."""
    def w(n):
        return " ".join(rng.choice(words, n))

    def ident():
        return "".join(x.title() for x in rng.choice(words, 2))

    n_fn = int(rng.integers(12, 24))
    if lang == "ts":
        out = [f"// module t{i}: {w(10)}", f'import {{ {ident()} }} from "./{ident()}";', ""]
        for _ in range(n_fn):
            out += [f"export function f{ident()}(a: number, b: number): number {{", f"  // {w(8)}",
                    f"  const x = a * {int(rng.integers(2, 9))} + b;", "  if (x > 10) {", "    return x - b;", "  }",
                    f"  return `{w(3)} ${{x}} }}`.length;", "}", ""]
        out += [f"export class C{ident()} {{", "  private v = 0;"]
        out += [f"  m{ident()}(a: number): number {{ return this.v + a; /* {w(4)} */ }}" for _ in range(6)]
        out += ["}", ""]
    elif lang == "go":
        out = [f"// Package p{i}: {w(10)}", f"package p{i}", "", 'import "fmt"', ""]
        for _ in range(n_fn):
            out += [f"func F{ident()}(a int, b int) int {{", f"\t// {w(8)}", f"\tx := a*{int(rng.integers(2, 9))} + b",
                    "\tif x > 10 {", "\t\treturn x - b", "\t}", f'\tfmt.Println("{w(3)} {{")', "\treturn x", "}", ""]
        out += [f"type S{ident()} struct {{", "\tV int", "}", ""]
    else:
        out = [f"package com.example.p{i};", "", f"/** {w(12)} */", f"public class C{i}{ident()} {{",
               "    private int v = 0;", ""]
        for _ in range(n_fn):
            out += [f"    public int m{ident()}(int a, int b) {{", f"        // {w(8)}",
                    f"        int x = a * {int(rng.integers(2, 9))} + b;", "        if (x > 10) {",
                    "            return x - b;", "        }", f'        String s = "{w(3)} }}";',
                    "        return x + s.length();", "    }", ""]
        out += ["}", ""]
    return "\n".join(out) + "\n"


def make_document_folder(root: str, seed: int, n_prose: int, n_py: int, n_brace: int) -> dict:
    """A folder a user would index, from ``seed``: ``notes/`` holds
    ``n_prose`` .md / .txt files of prose (``synth_corpus`` sentences, ~125
    a file, in paragraphs under headings) and one PDF; ``repo/`` holds
    ``n_py`` Python modules and ``n_brace`` each of .ts, .go and .java
    files. A ``.gitignore`` lists ``build/`` and ``ignored/``; those and a
    hidden ``.private/`` hold one marker word each (``SURFACE_MARKERS``). ->
    {"prose_files", "code_files", "sentences", "words"}."""
    rng = np.random.default_rng(seed)
    per_file = rng.integers(100, 151, size=n_prose)
    sentences = synth_corpus(int(per_file.sum()), rng)
    words = np.array(sorted({x for s in sentences[:2000] for x in s.split() if x.startswith("w")}))
    notes = os.path.join(root, "notes")
    at = 0
    for i, n in enumerate(per_file.tolist()):
        d = os.path.join(notes, f"topic{i % 32:02d}")
        os.makedirs(d, exist_ok=True)
        body, paras = sentences[at:at + n], []
        at += n
        for p in range(0, n, 6):
            paras.append(" ".join(s + "." for s in body[p:p + 6]))
        ext = ".md" if i % 2 == 0 else ".txt"
        head = f"# Notes {i}: {' '.join(body[0].split()[:4])}\n\n" if ext == ".md" else ""
        with open(os.path.join(d, f"note{i:04d}{ext}"), "w") as f:
            f.write(head + "\n\n".join(paras) + "\n")
    write_flate_pdf(os.path.join(notes, "memo.pdf"),
                    [PDF_PHRASE] + [" ".join(rng.choice(words, 10)) + "." for _ in range(30)])
    repo = os.path.join(root, "repo")
    for sub, ext, n in (("src", ".py", n_py), ("web", ".ts", n_brace), ("svc", ".go", n_brace),
                        ("java", ".java", n_brace)):
        for i in range(n):
            d = os.path.join(repo, sub, f"pkg{i % 16:02d}")
            os.makedirs(d, exist_ok=True)
            text = _py_module(rng, words, i) if ext == ".py" else _brace_file(rng, words, ext[1:], i)
            with open(os.path.join(d, f"m{i:04d}{ext}"), "w") as f:
                f.write(text)
    with open(os.path.join(root, ".gitignore"), "w") as f:
        f.write("build/\nignored/\n")
    for d, marker in SURFACE_MARKERS.items():
        os.makedirs(os.path.join(root, d), exist_ok=True)
        with open(os.path.join(root, d, "notes.md"), "w") as f:
            f.write(f"# {marker}\n\n{marker} {' '.join(rng.choice(words, 20))}.\n")
    return {"prose_files": n_prose, "code_files": n_py + 3 * n_brace, "sentences": len(sentences),
            "words": int(sum(len(s.split()) for s in sentences))}


class FakeOllama:
    """A loopback stand-in for an Ollama server (stdlib ``http.server`` in a
    thread on 127.0.0.1): ``/api/version``, ``/api/tags`` naming ``MODEL``,
    and ``/api/embeddings`` answering each prompt with ``vector(prompt)``, a
    deterministic ``DIM``-wide vector seeded by the prompt's CRC-32."""

    MODEL, DIM = "nomic-embed-text:latest", 384

    def __init__(self, port: int = 0):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        fake = self
        self.calls = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/api/version":
                    self._json(200, {"version": "0.0-fake"})
                elif self.path == "/api/tags":
                    self._json(200, {"models": [{"name": FakeOllama.MODEL}]})
                else:
                    self._json(404, {})

            def do_POST(self):
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                fake.calls += 1
                self._json(200, {"embedding": FakeOllama.vector(req.get("prompt", ""))})

        self.server = HTTPServer(("127.0.0.1", port), Handler)
        self.host = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @classmethod
    def vector(cls, prompt: str) -> list:
        import zlib

        return np.random.default_rng(zlib.crc32(prompt.encode())).standard_normal(cls.DIM).tolist()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _cli(args) -> "tuple[int, str]":
    """``leann_torch.cli.main(args)`` in this process -> (exit code, stdout)."""
    import contextlib
    import io

    from leann_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


_RESULT_HEAD = re.compile(r"^\[(\d+)\] \(score (-?[0-9.]+)\) ", re.MULTILINE)


def parse_search_output(out: str) -> list:
    """The CLI's ``search --non-interactive`` lines -> [(score, text)]."""
    heads = list(_RESULT_HEAD.finditer(out))
    return [(float(m.group(2)), out[m.end():heads[j + 1].start() if j + 1 < len(heads) else len(out)].rstrip("\n"))
            for j, m in enumerate(heads)]


def _mcp_session(cwd: str, env: dict, requests: list, limit_s: float = 600) -> list:
    """``python -m leann_torch.mcp --device cuda`` as a subprocess: each
    request written to its stdin and its answer read before the next ->
    [(answer, wall seconds)] for each request with an id (a notification
    gets no answer). The server is closed (stdin) and waited for; one that
    outlives ``limit_s`` in all is killed, and the session fails."""
    err_path = os.path.join(cwd, "mcp.stderr")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "leann_torch.mcp", "--device", "cuda"], cwd=cwd, env=env,
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True)
    watchdog = threading.Timer(limit_s, proc.kill)
    watchdog.start()
    out = []
    try:
        for req in requests:
            t = time.time()
            proc.stdin.write(json.dumps(req) + "\n")
            proc.stdin.flush()
            if "id" not in req:  # a notification: no answer
                continue
            line = proc.stdout.readline()
            if not line:
                with open(err_path) as f:
                    fail(f"the MCP server gave no answer to {req['method']}: {f.read()[-2000:]}")
            out.append((json.loads(line), time.time() - t))
        proc.stdin.close()
        proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return out


def phase_surface(torch, dev, workdir: str, keep: "dict | None" = None):
    """Phase 11 -> (kernel rows by (kernel, path), launches by path).
    ``keep`` receives the CLI index's prefix and the 64 queries (phase 16
    relabels the index)."""
    from leann_torch import LeannSearcher, api
    from leann_torch.ops import graph
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.distance import pad_features
    from leann_torch.ops.flat_topk import flat_topk

    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches, seen = {}, {}
    root = os.path.join(workdir, "surface")
    docs, project, home = (os.path.join(root, d) for d in ("docs", "project", "home"))
    os.makedirs(project)
    t = time.time()
    folder = make_document_folder(docs, seed=11, **SURFACE_SIZES)
    folder["generate_s"] = time.time() - t
    prev_cwd, prev_home = os.getcwd(), os.environ.get("LEANN_HOME")
    real_build, real_exact_knn = api.LeannBuilder.build_index, graph.exact_knn

    def recording_build(self, index_path):  # the build's start and its builder; launches nothing itself
        seen.setdefault("build_start", []).append(time.time())
        seen.setdefault("builders", []).append(self)
        return real_build(self, index_path)

    def recording_exact_knn(emb, k, *a, **kw):  # the k-NN's operands; launches nothing itself
        seen["emb"], seen["k"] = emb, k
        return real_exact_knn(emb, k, *a, **kw)

    def index_prefix(name):
        return os.path.join(project, ".leann", "indexes", name, "documents.leann")

    def passages_of(name):
        with open(index_prefix(name) + ".passages.jsonl") as f:
            return [json.loads(line)["text"] for line in f]

    fake = None
    os.chdir(project)
    os.environ["LEANN_HOME"] = home
    try:
        # (a) the CLI's build at every other default, then a flat oracle over the same folder
        api.LeannBuilder.build_index, graph.exact_knn = recording_build, recording_exact_knn
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.time()
        rc, out = _cli(["build", "folder", "--docs", docs, "--use-ast-chunking"])
        torch.cuda.synchronize()
        cli_build_s = time.time() - t0
        if rc != 0:
            fail(f"leann_torch.cli build folder exited {rc}: {out[-2000:]}")
        launches["surface_build"] = _counts(counters)
        rc, out = _cli(["build", "folder-oracle", "--docs", docs, "--use-ast-chunking", "--backend", "flat"])
        if rc != 0:
            fail(f"leann_torch.cli build folder-oracle exited {rc}: {out[-2000:]}")
        passages = passages_of("folder")
        leaked = {m: sum(m in p for p in passages) for m in SURFACE_MARKERS.values()}

        # (b) 64 queries (12-word prefixes of chunks) at the CLI's search defaults, against the oracle
        rng = np.random.default_rng(12)
        # picked from the texts in sorted order: the walk's order of the
        # folder's directories, and so the chunks' ids, is the file system's
        by_text = sorted(passages)
        queries = [" ".join(by_text[i].split()[:12]) for i in rng.choice(len(passages), 64, replace=False)]
        oracle_searcher = LeannSearcher(index_prefix("folder-oracle"))
        truth = oracle_searcher.search(queries, top_k=5)
        searcher = LeannSearcher(index_prefix("folder"))
        got, ms_q = _timed_search(torch, searcher, queries, **CLI_SEARCH_KW)
        recall = _recall(got, truth, k=5)

        # (c) the CLI's search and ask, each against the searcher's own results
        cli_search = []
        for q in queries[:4]:
            want = searcher.search(q, **CLI_SEARCH_KW)
            (rc, out), s = _timed(lambda: _cli(["search", "folder", q, "--non-interactive"]))
            printed = parse_search_output(out)
            cli_search.append({"rc": rc, "s": s, "results": len(printed),
                               "texts_equal": [p[1] for p in printed] == [r.text.rstrip("\n") for r in want],
                               "max_score_diff": max((abs(p[0] - r.score) for p, r in zip(printed, want)),
                                                     default=None)})
        context = "\n\n".join(r.text for r in searcher.search(queries[0], top_k=5, complexity=64))
        (rc, out), ask_s = _timed(lambda: _cli(["ask", "folder", queries[0], "--llm", "simulated"]))
        ask = {"rc": rc, "s": ask_s, "head_printed": context[:200].replace("\n", " ") in out}
        torch.cuda.synchronize()
        launches["surface"] = _counts(counters)

        # (d) the MCP server as a subprocess: a fresh process, its CLI calls fresh processes too
        env = dict(os.environ, LEANN_HOME=home, PYTHONPATH=str(REPO))
        top1 = searcher.search(queries[1], **CLI_SEARCH_KW)[0].text
        calls = _mcp_session(project, env, [
            {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
            *({"jsonrpc": "2.0", "id": 3 + j, "method": "tools/call",
               "params": {"name": "leann_search", "arguments": {"index_name": "folder", "query": queries[1 + j]}}}
              for j in range(2)),
            {"jsonrpc": "2.0", "id": 5, "method": "tools/call", "params": {"name": "leann_list", "arguments": {}}},
        ])
        texts = [c[0].get("result", {}).get("content", [{}])[0].get("text", "") for c in calls]
        mcp_first = parse_search_output(texts[2])
        mcp = {"server": calls[0][0].get("result", {}).get("serverInfo", {}).get("name"),
               "tools": sorted(t["name"] for t in calls[1][0].get("result", {}).get("tools", [])),
               "call_s": {name: c[1] for name, c in zip(("initialize", "tools/list", "leann_search_1",
                                                         "leann_search_2", "leann_list"), calls)},
               "top1_equal": bool(mcp_first) and mcp_first[0][1] == top1.rstrip("\n"),
               "second_results": len(parse_search_output(texts[3])),
               "list_names": [n for n in ("folder", "folder-oracle") if f"{n} " in texts[4]]}

        # (e) the ollama mode against a loopback fake on the mode's default host
        fake = FakeOllama(port=11434)
        http_docs = [os.path.join(docs, "repo", "web"), os.path.join(docs, "repo", "svc")]
        _reset(counters)
        (rc, out), http_build_s = _timed(lambda: _cli(["build", "folder-http", "--docs", *http_docs,
                                                       "--embedding-mode", "ollama",
                                                       "--embedding-model", "nomic-embed-text",
                                                       "--backend", "flat"]))
        if rc != 0:
            fail(f"leann_torch.cli build folder-http exited {rc}: {out[-2000:]}")
        http_passages = passages_of("folder-http")
        by_text = sorted(http_passages)
        hq = [" ".join(by_text[i].split()[:12]) for i in rng.choice(len(http_passages), 64, replace=False)]
        http_searcher = LeannSearcher(index_prefix("folder-http"))
        http_got, http_ms_q = _timed_search(torch, http_searcher, hq, top_k=5)
        torch.cuda.synchronize()
        launches["http"] = _counts(counters)
        http_calls = fake.calls

        def direct(texts):  # the fake's vectors, normalized as the ollama mode does
            e = np.asarray([FakeOllama.vector(t[:8000]) for t in texts], dtype=np.float32)
            return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)

        e, hqv = direct(http_passages), direct(hq)
        ebf = pad_features(torch.from_numpy(e).to(dev).to(torch.bfloat16)).contiguous()
        en = torch.from_numpy(e).to(dev).square().sum(dim=1).contiguous()
        d_ids, d_dists = flat_topk(pad_features(torch.from_numpy(hqv).to(dev)), ebf, en, len(e), 5, "mips")
        h_labels, h_scores = _labels_scores(http_got)
        http = {"files": sum(len(fs) for d in http_docs for _, _, fs in os.walk(d)), "chunks": len(http_passages),
                "build_s": http_build_s, "phase_seconds": dict(seen["builders"][2].phase_seconds),
                "embedding_requests": http_calls, "ms_per_query": http_ms_q,
                "metric": http_searcher.distance_metric,
                "labels_equal": h_labels == [[str(i) for i in row] for row in d_ids.cpu().tolist()],
                "scores_equal": bool(np.array_equal(h_scores, d_dists.cpu().numpy()))}
        fake.close()
        fake = None

        # (f) remove the HTTP-mode index; list no longer names it
        rc_rm, _ = _cli(["remove", "folder-http", "--force"])
        rc_ls, listed = _cli(["list"])
        removed = rc_rm == 0 and rc_ls == 0 and "folder-http" not in listed and "folder " in listed
    finally:
        api.LeannBuilder.build_index, graph.exact_knn = real_build, real_exact_knn
        if fake is not None:
            fake.close()
        os.chdir(prev_cwd)
        if prev_home is None:
            os.environ.pop("LEANN_HOME", None)
        else:
            os.environ["LEANN_HOME"] = prev_home

    # each kernel at this path's shapes, on its inputs
    ebf_k, norms = kp.upload_panel_inputs(seen["emb"], dev)
    kr = one_window(torch, {
        ("knn_panel", "surface"): panel_check(torch, kp, ebf_k, norms, seen["k"], seen["emb"].shape[1]),
        ("flat_topk", "surface"): oracle_check(torch, dev, oracle_searcher, queries, k=5),
        ("flat_topk", "http"): oracle_check(torch, dev, http_searcher, hq, k=5, q=hqv)})
    del ebf_k, norms
    torch.cuda.empty_cache()

    if keep is not None:  # with its results at the CLI's search defaults
        keep.update(prefix=index_prefix("folder"), queries=queries, ids=[[r.id for r in row] for row in got])
    hnsw_builder, oracle_builder = seen["builders"][:2]
    row = {"phase": "surface", "folder": folder, "chunks": len(passages), "load_chunk_s":
           seen["build_start"][0] - t0, "cli_build_s": cli_build_s, "build_s": dict(hnsw_builder.phase_seconds),
           "oracle_build_s": dict(oracle_builder.phase_seconds), "knn_k": seen["k"],
           "markers_in_passages": leaked, "pdf_passages": sum(PDF_PHRASE in p for p in passages),
           "same_passages_as_oracle": passages == passages_of("folder-oracle"),
           "recall_at_5": recall, "search_ms_per_query": ms_q, "search_kw": CLI_SEARCH_KW,
           "cli_search": cli_search, "ask": ask, "mcp": mcp, "http": http, "removed_and_unlisted": removed,
           "launches": launches,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()}}
    emit(row)
    if launches["surface_build"]["knn_panel"] != 1 or seen["k"] != 128:
        fail(f"the CLI's hnsw build did not launch knn_panel once at k = 128: {launches}, k {seen.get('k')}")
    if launches["surface"]["flat_topk"] < 1 or launches["http"]["flat_topk"] < 1:
        fail(f"flat_topk was not launched on the oracle's or the HTTP index's searches: {launches}")
    if any(leaked.values()) or not row["pdf_passages"] or not row["same_passages_as_oracle"]:
        fail(f"the folder's passages: markers {leaked}, PDF passages {row['pdf_passages']}, "
             f"the oracle's the same {row['same_passages_as_oracle']}")
    if recall < 0.80:
        fail(f"surface recall@5 {recall:.4f} below the 0.80 sanity floor")
    if not all(c["rc"] == 0 and c["results"] == 5 and c["texts_equal"] and c["max_score_diff"] < 1e-3
               for c in cli_search) or not (ask["rc"] == 0 and ask["head_printed"]):
        fail(f"the CLI's search or ask disagrees with the searcher: {cli_search}, {ask}")
    if not (mcp["server"] == "leann-torch-mcp" and mcp["tools"] == ["leann_list", "leann_search"]
            and mcp["top1_equal"] and mcp["second_results"] == 5
            and mcp["list_names"] == ["folder", "folder-oracle"]):
        fail(f"the MCP session: {mcp}")
    if not (http["labels_equal"] and http["scores_equal"]):
        fail(f"the ollama-mode index disagrees with a flat search over the same vectors: {http}")
    if not removed:
        fail(f"remove folder-http or list: {listed[-2000:]}")
    check_rows(kr)
    return kr, launches


# phase 12: checkpoints whose tokenizer is not WordPiece. intfloat/multilingual-e5-small's
# published config.json (BertModel; XLM-R's SentencePiece Unigram tokenizer) and
# sentence-transformers/all-distilroberta-v1's (RobertaModel; byte-level BPE)
E5_SMALL = dict(vocab_size=250037, dim=384, n_layers=12, n_heads=12, mlp_dim=1536, max_len=512)
DISTILROBERTA = dict(vocab_size=50265, dim=768, n_layers=6, n_heads=12, mlp_dim=3072, max_len=514)
BPE_CHUNKS = 20_000  # (b) runs over the first 20,000 of phase 4's chunks
NONASCII_TEXTS = 10_000  # each family's tokenizer is also timed on this many non-ASCII texts
XLMR_SPECIALS = ["<s>", "<pad>", "</s>", "<unk>"]


def _seeded_tree(cfg, seed: int) -> dict:
    """Seeded weights at ``cfg``: ``init_params``' layers, a token table of
    numpy normals (std 0.02; ``init_params`` draws it through a threefry in
    numpy, ~6 s at 250,037 x 384)."""
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te

    tree = te.init_params(replace(cfg, vocab_size=8))
    rng = np.random.default_rng(seed)
    tree["tok_emb"] = rng.standard_normal((cfg.vocab_size, cfg.dim), dtype=np.float32) * np.float32(0.02)
    return tree


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def _added(content: str, tid: int, **kw) -> dict:
    return {"id": tid, "content": content, "single_word": False, "lstrip": kw.get("lstrip", False), "rstrip": False,
            "normalized": False, "special": True}


def darts_blob(rules: dict) -> bytes:
    """A SentencePiece ``precompiled_charsmap``: u32 LE trie size, a
    darts-clone double array over the rules' UTF-8 keys (a leaf's value: its
    replacement's offset), then the NUL-terminated replacements."""
    import struct

    strings, values = b"", {}
    for key, rep in rules.items():
        values[key.encode()] = len(strings)
        strings += rep.encode() + b"\0"
    root: dict = {}
    for key, v in values.items():
        node = root
        for c in key:
            node = node.setdefault(c, {})
        node[None] = v
    units, used, bases = {0: 0}, {0}, set()
    todo, lo = collections.deque([(root, 0)]), 1
    while todo:  # breadth first; each base is sought from a little below the last one
        node, pos = todo.popleft()
        labels = ([0] if None in node else []) + sorted(c for c in node if c is not None)
        base = lo
        while base in bases or any(base ^ c in used for c in labels):
            base += 1
        lo = max(1, base - 256)
        bases.add(base)
        used.update(base ^ c for c in labels)
        units[pos] = units.get(pos, 0) | ((pos ^ base) << 10) | ((None in node) << 8)
        if None in node:
            units[base] = node[None] | (1 << 31)
        for c in sorted(c for c in node if c is not None):
            units[base ^ c] = c
            todo.append((node[c], base ^ c))
    # whole 256-unit blocks: a lookup of any byte from any base stays inside
    arr = [units.get(i, 0) for i in range(((max(max(units), max(bases)) >> 8) + 1) << 8)]
    trie = struct.pack(f"<{len(arr)}I", *arr)
    return struct.pack("<I", len(trie)) + trie + strings


# the blocks whose NFKC forms the stand-in charsmap holds: Latin-1 to Greek,
# general punctuation to number forms, enclosed alphanumerics, CJK symbols and
# compatibility, presentation forms, half- and fullwidth forms
NFKC_BLOCKS = ((0x00A0, 0x03FF), (0x2000, 0x218F), (0x2460, 0x24FF), (0x3000, 0x303F), (0x3300, 0x33FF),
               (0xFB00, 0xFB4F), (0xFF00, 0xFFEF))


def nmt_nfkc_rules() -> dict:
    """Rules in the manner of SentencePiece's nmt_nfkc charsmap: the Nmt
    controls dropped and its spaces made a space, each code point of
    ``NFKC_BLOCKS`` whose NFKC form differs mapped to it, and each Latin
    vowel (and c, n, y) with a combining grave, acute, circumflex, tilde or
    diaeresis mapped to its precomposed letter."""
    import unicodedata

    rules = {chr(c): "" for c in (*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F)}
    rules.update({chr(c): " " for c in (0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029,
                                        0xFEFF)})
    for lo, hi in NFKC_BLOCKS:
        for c in range(lo, hi + 1):
            ch = chr(c)
            if ch not in rules and unicodedata.normalize("NFKC", ch) != ch:
                rules[ch] = unicodedata.normalize("NFKC", ch)
    for base in "AEIOUCNYaeioucny":
        for mark in "\u0300\u0301\u0302\u0303\u0308":
            comp = unicodedata.normalize("NFC", base + mark)
            if len(comp) == 1:
                rules[base + mark] = comp
    return rules


# a non-ASCII sample for the tokenizers' timing: precomposed and decomposed
# accents, CJK, Arabic, Devanagari, Cyrillic, emoji ZWJ sequences and skin
# tones, fullwidth forms, ligatures, NBSP
NONASCII_FRAGMENTS = ["Café naïve façade", "Cafe\u0301 nai\u0308ve", "中文测试，这是一个句子。", "مرحبا بالعالم",
                      "नमस्ते दुनिया", "Привет мир", "👩\u200d💻 👍🏽 🇩🇪", "ＡＢＣ ﬁ ① ｶﾞ", "straße\xa0über", "한국어 문장"]


def nonascii_sample(chunks, n: int) -> list:
    """``n`` texts: a chunk's first 16 words with three fragments between them."""
    rng = np.random.default_rng(15)
    out = []
    for i in range(n):
        words = chunks[i].split()[:16]
        for f in rng.choice(len(NONASCII_FRAGMENTS), 3, replace=False):
            words.insert(int(rng.integers(0, len(words) + 1)), NONASCII_FRAGMENTS[int(f)])
        out.append(" ".join(words))
    return out


def xlmr_tokenizer_files(path: str, vocab_size: int) -> dict:
    """XLM-R's tokenizer pipeline in its published order (the
    SentencePiece charsmap as ``Precompiled``, here :func:`nmt_nfkc_rules`,
    then Replace(" {2,}", " "); Metaspace "▁" always; the template
    "<s> $A </s>"), with a Unigram model
    of ``vocab_size`` pieces: the four special tokens, the pieces that cover
    ``synth_corpus`` words (▁w0..▁w49999 whole at ids 65,536 and up; ▁g, ▁d,
    digits and digit pairs, letters), seeded filler pieces no corpus word
    reaches, and <mask> last. -> {pieces by id range}."""
    small = ["▁", "▁g", "▁d"] + [f"{i:02d}" for i in range(100)] + [str(i) for i in range(10)]
    small += list("abcdefghijklmnopqrstuvwxyz")
    scores = {"▁": -10.0, "▁g": -9.0, "▁d": -9.0}
    vocab = [[p, 0.0] for p in XLMR_SPECIALS] + [[p, scores.get(p, -10.0 if len(p) == 2 else -11.0)] for p in small]
    vocab += [[f"▁f{i}", -12.0] for i in range(65536 - len(vocab))]
    word0 = len(vocab)
    vocab += [[f"▁w{i}", -8.0] for i in range(50_000)]
    vocab += [[f"▁f{i}", -12.0] for i in range(65536, 65536 + vocab_size - 1 - len(vocab))]
    vocab.append(["<mask>", 0.0])
    assert len(vocab) == vocab_size
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [_added(p, i) for i, p in enumerate(XLMR_SPECIALS)] + [
            _added("<mask>", vocab_size - 1, lstrip=True)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(darts_blob(nmt_nfkc_rules())).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "pair": [], "special_tokens": {"<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                                                          "</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False},
    }
    _write_json(os.path.join(path, "tokenizer.json"), spec)
    _write_json(os.path.join(path, "tokenizer_config.json"), {
        "tokenizer_class": "XLMRobertaTokenizer", "model_max_length": 512, "bos_token": "<s>", "eos_token": "</s>",
        "sep_token": "</s>", "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
        "mask_token": {"__type": "AddedToken", "content": "<mask>", "lstrip": True, "rstrip": False, "normalized": False,
                       "single_word": False, "special": True}})
    return {"pieces": len(vocab), "corpus_words_from": word0}


def roberta_tokenizer_files(path: str, vocab_size: int) -> dict:
    """RoBERTa's byte-level BPE pipeline (ByteLevel without the prefix
    space, RobertaProcessing) with a vocab of ``vocab_size``: the four
    special tokens, the 256 byte characters, seeded fillers, the merged
    tokens of the merges below at the top of the id range, <mask> last. The
    merges: Ġ + w / g / d and every digit pair (the GPT-2 split puts a
    word's digits in a pre-token of their own: a corpus word is 3-4
    tokens)."""
    bytes_chars = [chr(c) for c in range(ord("!"), ord("~") + 1)] + [chr(c) for c in range(0xA1, 0xAD)]
    bytes_chars += [chr(c) for c in range(0xAE, 0x100)]
    bytes_chars += [chr(256 + i) for i in range(256 - len(bytes_chars))]
    digits = [str(i) for i in range(10)]
    merges = [["Ġ", c] for c in "wgd"] + [[a, b] for a in digits for b in digits]
    merged = [a + b for a, b in merges]
    vocab = XLMR_SPECIALS + bytes_chars
    vocab += [f"Ġf{i}" for i in range(vocab_size - 1 - len(merged) - len(vocab))] + merged + ["<mask>"]
    assert len(vocab) == len(set(vocab)) == vocab_size
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [_added(p, i) for i, p in enumerate(XLMR_SPECIALS)] + [
            _added("<mask>", vocab_size - 1, lstrip=True)],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True},
        "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0], "trim_offsets": True,
                           "add_prefix_space": False},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": {p: i for i, p in enumerate(vocab)}, "merges": merges},
    }
    _write_json(os.path.join(path, "tokenizer.json"), spec)
    _write_json(os.path.join(path, "tokenizer_config.json"), {
        "tokenizer_class": "RobertaTokenizer", "add_prefix_space": False, "model_max_length": 512,
        "bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>", "unk_token": "<unk>",
        "pad_token": "<pad>", "mask_token": "<mask>"})
    return {"vocab": len(vocab), "merges": len(merges)}


def e5_small_checkpoint(path: str) -> dict:
    """A checkpoint directory at multilingual-e5-small's widths: seeded
    weights written by the port's ``save_hf_weights`` and an XLM-R
    tokenizer (:func:`xlmr_tokenizer_files`)."""
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te

    cfg = replace(te.EncoderConfig(), name="e5-small-seeded", arch="bert", **E5_SMALL)
    te.save_hf_weights(_seeded_tree(cfg, 12), cfg, path)
    info = xlmr_tokenizer_files(path, E5_SMALL["vocab_size"])
    with open(os.path.join(path, "config.json")) as f:
        return {**json.load(f), "tokenizer": info}


def roberta_masked_lm(path: str, widths: dict, name: str, seed: int, **config) -> dict:
    """Seeded weights at ``widths`` as a RoBERTa-type ``*ForMaskedLM``
    saves them: the encoder's keys under ``roberta.``, an ``lm_head``, one
    token type, pad id 1, LayerNorm eps 1e-5 (the port's writer, the keys
    renamed; the tree from ``seed``, the head from ``seed + 1``); ``config``
    updates ``config.json``. -> the config."""
    from dataclasses import replace

    from leann_torch.embeddings import encoder as te

    cfg = replace(te.EncoderConfig(), name=name, arch="bert", **widths)
    te.save_hf_weights(_seeded_tree(cfg, seed), cfg, path)
    st = os.path.join(path, "model.safetensors")
    sd = {"roberta." + k: v for k, v in te.read_safetensors(st).items() if not k.startswith("pooler.")}
    sd["roberta.embeddings.token_type_embeddings.weight"] = sd["roberta.embeddings.token_type_embeddings.weight"][:1]
    rng, d = np.random.default_rng(seed + 1), widths["dim"]
    sd["lm_head.dense.weight"] = rng.standard_normal((d, d), dtype=np.float32) * np.float32(0.02)
    sd["lm_head.dense.bias"] = np.zeros(d, np.float32)
    sd["lm_head.layer_norm.weight"], sd["lm_head.layer_norm.bias"] = np.ones(d, np.float32), np.zeros(d, np.float32)
    sd["lm_head.bias"] = np.zeros(widths["vocab_size"], np.float32)
    te.write_safetensors(sd, st)
    with open(os.path.join(path, "config.json")) as f:
        out = json.load(f)
    out.update(type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5, **config)
    _write_json(os.path.join(path, "config.json"), out)
    return out


def distilroberta_checkpoint(path: str) -> dict:
    """A checkpoint directory at all-distilroberta-v1's widths as a
    ``RobertaForMaskedLM`` saves it (:func:`roberta_masked_lm`: 514
    positions) with a byte-level BPE tokenizer
    (:func:`roberta_tokenizer_files`)."""
    config = roberta_masked_lm(path, DISTILROBERTA, "distilroberta-seeded", 13, architectures=["RobertaForMaskedLM"],
                               model_type="roberta", bos_token_id=0, eos_token_id=2)
    return {**config, "tokenizer": roberta_tokenizer_files(path, DISTILROBERTA["vocab_size"])}


def _family_path(torch, dev, workdir: str, tag: str, write_checkpoint, chunks, queries, counters, launches) -> dict:
    """One checkpoint family of phase 12 or 15: the directory written, diskann
    and a flat oracle from it (:func:`indexes_from_dir`), the checks' inputs
    and the searches. -> {row, kernel rows, failures}."""
    from leann_torch import LeannSearcher
    from leann_torch.embeddings.encoder import get_encoder
    from leann_torch.embeddings.tokenizer_json import JsonTokenizer
    from leann_torch.ops import knn_panel as kp
    from leann_torch.storage import index_all_in_bytes, load_token_cache

    ckpt = os.path.join(workdir, tag)
    os.makedirs(ckpt, exist_ok=True)
    hf_config, write_s = _timed(lambda: write_checkpoint(ckpt))
    # the tokenizer alone, cold (a fresh reader: no word memoised), on the corpus;
    # the encoder the builds then take from the cache holds this reader
    enc = get_encoder(ckpt, max_length=128, device=dev)
    (tok_ids, _), tokenize_s = _timed(lambda: enc.tokenizer.encode_batch(chunks))
    del tok_ids
    # a fresh reader on the non-ASCII sample: the grapheme, Unicode and byte paths
    sample = nonascii_sample(chunks, NONASCII_TEXTS)
    (s_ids, s_mask), nonascii_s = _timed(lambda: type(enc.tokenizer)(ckpt, max_length=128).encode_batch(sample))
    s_real = s_ids[s_mask.astype(bool)]
    nonascii = {"texts": len(sample), "chars": sum(map(len, sample)), "s": nonascii_s,
                "unk_share": float((s_real == enc.tokenizer.unk_id).mean()),
                "normalized": enc.tokenizer.normalizer("Ａ ﬁ e\u0301") if enc.tokenizer.normalizer else None}
    del s_ids, s_mask, s_real
    built = indexes_from_dir(torch, workdir, ckpt, tag, chunks, queries, counters, launches)
    tok, tok_lengths = load_token_cache(built["prefix"])
    is_json = isinstance(enc.tokenizer, JsonTokenizer)
    real = np.arange(tok.shape[1])[None, :] < tok_lengths[:, None]
    unk = int((np.asarray(tok)[real] == enc.tokenizer.unk_id).sum()) if is_json else None
    searcher = LeannSearcher(built["prefix"])
    got, ms_q = _timed_search(torch, searcher, queries, **SEARCH_KW)
    recall = _recall(got, built["truth"])
    ebf, norms = kp.upload_panel_inputs(built["emb"], dev)
    kr = one_window(torch, {
        ("knn_panel", f"{tag}_diskann"): panel_check(torch, kp, ebf, norms, built["k"], built["emb"].shape[1]),
        ("flat_topk", f"{tag}_oracle"): oracle_check(torch, dev, built["oracle_searcher"], queries)})
    del ebf, norms
    torch.cuda.empty_cache()
    row = {"model": tag, "n_chunks": len(chunks),
           "hf_config": {k: hf_config.get(k) for k in ("model_type", "vocab_size", "hidden_size", "num_hidden_layers",
                                                       "num_attention_heads", "intermediate_size",
                                                       "max_position_embeddings", "type_vocab_size", "pad_token_id")},
           "tokenizer_files": hf_config["tokenizer"], "write_checkpoint_s": write_s,
           "loaded_hf": enc.loaded_hf, "tokenizer": type(enc.tokenizer).__name__,
           "tokenizer_class": getattr(enc.tokenizer, "tokenizer_class", None), "tokenize_s": tokenize_s,
           "tokenize_nonascii": nonascii,
           "token_store_dtype": str(tok.dtype), "max_token_id": int(np.asarray(tok).max()),
           "unk_tokens": unk, "pad_id": getattr(enc.tokenizer, "pad_id", None),
           "mean_tokens": float(tok_lengths.mean()),
           "build_s": dict(built["builder"].phase_seconds), "flat_build_s": dict(built["oracle"].phase_seconds),
           "knn_k": built["k"], "recall_at_3": recall, "search_ms_per_query": ms_q, "search_kw": SEARCH_KW,
           "all_in_bytes": index_all_in_bytes(built["prefix"]),
           "launches": {p: launches[p] for p in (f"{tag}_diskann", f"{tag}_oracle")},
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()}}
    failures = []
    if not (enc.loaded_hf and is_json):
        failures.append(f"{tag}: the checkpoint did not load as one: loaded_hf {enc.loaded_hf}, "
                        f"{type(enc.tokenizer).__name__}")
    if nonascii["normalized"] not in (None, "A fi é"):
        failures.append(f"{tag}: the normalizer gave {nonascii['normalized']!r} for 'Ａ ﬁ e\u0301', not 'A fi é'")
    if unk != 0:
        failures.append(f"{tag}: {unk} corpus tokens are <unk>")
    if launches[f"{tag}_diskann"]["knn_panel"] != 1 or built["k"] != 64:
        failures.append(f"{tag}: the diskann build did not launch knn_panel once at k = 64: {launches}")
    if launches[f"{tag}_oracle"]["flat_topk"] != 1:
        failures.append(f"{tag}: the oracle did not launch flat_topk once: {launches}")
    if recall < 0.80:
        failures.append(f"{tag}: recall@3 {recall:.4f} below the 0.80 sanity floor")
    return {"row": row, "kr": kr, "failures": failures, "tok": tok}


def phase_multilingual(torch, dev, workdir: str, chunks, queries):
    """Phase 12 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk

    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches, kr = {}, {}
    t0 = time.time()
    a = _family_path(torch, dev, workdir, "e5", e5_small_checkpoint, chunks, queries, counters, launches)
    a["row"]["model"] = "multilingual-e5-small widths, seeded weights, XLM-R Unigram tokenizer.json"
    a["row"]["phase_s"] = time.time() - t0
    int32 = a["tok"].dtype == np.int32 and a["row"]["max_token_id"] > 65535
    a["row"]["int32_store_above_65535"] = bool(int32)
    del a["tok"]
    emit({"phase": "multilingual", **a["row"]})
    t0 = time.time()
    sub = chunks[:BPE_CHUNKS]
    sub_queries = [" ".join(sub[i].split()[:12]) for i in np.random.default_rng(12).choice(len(sub), 64, replace=False)]
    b = _family_path(torch, dev, workdir, "distilroberta", distilroberta_checkpoint, sub, sub_queries, counters,
                     launches)
    b["row"]["model"] = "all-distilroberta-v1 widths, seeded weights under roberta., byte-level BPE tokenizer.json"
    b["row"]["phase_s"] = time.time() - t0
    u16 = b["tok"].dtype == np.uint16
    del b["tok"]
    emit({"phase": "multilingual_bpe", **b["row"]})
    failures = a["failures"] + b["failures"]
    if not int32:
        failures.append(f"the e5 token store is {a['row']['token_store_dtype']} with ids up to "
                        f"{a['row']['max_token_id']}: not int32 above 65,535")
    if not u16:
        failures.append(f"the distilroberta token store is {b['row']['token_store_dtype']}, not uint16")
    if failures:
        fail("; ".join(failures))
    kr.update(a["kr"])
    kr.update(b["kr"])
    check_rows(kr)
    return kr, launches


# phase 13: the RAG apps and examples over what one person holds. Each fixture
# is written from the seed in the layout its app discovers or reads.
APPS_SIZES = dict(emails=5000, history_rows=30_000, wechat_chats=60, wechat_per_chat=500,
                  book_chapters=40, book_paras=75, document_files=400)
SENTENCES_PER_PARAGRAPH = 4
MAIL_ACCOUNTS = ("8F3C1A2E-0B6D-4C7E-9A51-3D2F6B7C8E90", "1D4E7A9B-2C5F-4E8A-B3D6-7F9A0C1E2B34")
EMLX_PLIST = (b'<?xml version="1.0" encoding="UTF-8"?>\n<!DOCTYPE plist PUBLIC "-//Apple//DTD PLIST 1.0//EN" '
              b'"http://www.apple.com/DTDs/PropertyList-1.0.dtd">\n<plist version="1.0">\n<dict>\n'
              b'\t<key>date-received</key>\n\t<integer>%d</integer>\n\t<key>flags</key>\n'
              b'\t<integer>8590195713</integer>\n</dict>\n</plist>\n')
CHROME_URLS = ("CREATE TABLE urls(id INTEGER PRIMARY KEY AUTOINCREMENT, url LONGVARCHAR, title LONGVARCHAR, "
               "visit_count INTEGER DEFAULT 0 NOT NULL, typed_count INTEGER DEFAULT 0 NOT NULL, "
               "last_visit_time INTEGER NOT NULL, hidden INTEGER DEFAULT 0 NOT NULL)")
CHROME_PROFILES = ("Default", "Profile 1")


def write_emlx(path: str, message: bytes, received: int) -> None:
    """Apple Mail's .emlx: the message's byte count on a line, the RFC-822
    message, then a plist of its flags."""
    with open(path, "wb") as f:
        f.write(b"%-10d\n" % len(message) + message + EMLX_PLIST % received)


def _paragraphs(sentences, at: int, n: int) -> list:
    per = SENTENCES_PER_PARAGRAPH
    return [" ".join(s + "." for s in sentences[at + j * per: at + (j + 1) * per]) for j in range(n)]


def rfc822_message(i: int, seed: int, paras: list, when, html: bool) -> bytes:
    """Message ``i``: headers, then the paragraphs as text/plain, and with
    ``html`` a multipart/alternative of that and an HTML part."""
    import email.utils

    head = (f"From: Sender {i % 97} <sender{i % 97}@example.com>\r\nTo: me{i % 2}@example.org\r\n"
            f"Subject: {' '.join(paras[0].split()[:6])}\r\nDate: {email.utils.format_datetime(when)}\r\n"
            f"Message-ID: <{i}.{seed}@example.com>\r\nMIME-Version: 1.0\r\n")
    plain = ('Content-Type: text/plain; charset="us-ascii"\r\nContent-Transfer-Encoding: 7bit\r\n\r\n'
             + "\r\n\r\n".join(paras) + "\r\n")
    if not html:
        return (head + plain).encode()
    b = f"==alt{i}.{seed}=="
    markup = "<html><body>" + "".join(f"<p>{p}</p>" for p in paras) + "</body></html>"
    return (head + f'Content-Type: multipart/alternative; boundary="{b}"\r\n\r\n--{b}\r\n' + plain
            + f'--{b}\r\nContent-Type: text/html; charset="us-ascii"\r\nContent-Transfer-Encoding: 7bit\r\n\r\n'
            + markup + f"\r\n--{b}--\r\n").encode()


def _sentences(sentences, n: int, rng) -> list:
    """The first ``n`` of ``sentences``, else ``synth_corpus(n, rng)``."""
    if sentences is None:
        return synth_corpus(n, rng)
    if len(sentences) < n:
        raise ValueError(f"{n} sentences needed, {len(sentences)} given")
    return sentences[:n]


def write_mail_folder(home: str, n: int, seed: int, sentences=None) -> dict:
    """``n`` .emlx messages from ``seed`` in two Apple Mail accounts under
    ``home/Library/Mail/V10/<account>/INBOX.mbox/<uuid>/Data/Messages/``,
    alternating: bodies of 2-6 paragraphs of ``synth_corpus`` sentences (or
    of ``sentences``), one message in ten multipart with an HTML
    alternative. -> {"emails", "multipart", "paragraphs", "dirs",
    "sentences"}."""
    from datetime import datetime, timedelta, timezone

    rng = np.random.default_rng(seed)
    n_par = rng.integers(2, 7, size=n)
    sentences = _sentences(sentences, int(n_par.sum()) * SENTENCES_PER_PARAGRAPH, rng)
    dirs = []
    for acct in MAIL_ACCOUNTS:
        box = "-".join(rng.bytes(k).hex().upper() for k in (4, 2, 2, 2, 6))
        dirs.append(os.path.join(home, "Library", "Mail", "V10", acct, "INBOX.mbox", box, "Data", "Messages"))
        os.makedirs(dirs[-1])
    t0 = datetime(2024, 1, 8, 9, 0, tzinfo=timezone.utc)
    at = 0
    for i in range(n):
        paras = _paragraphs(sentences, at, int(n_par[i]))
        at += int(n_par[i]) * SENTENCES_PER_PARAGRAPH
        when = t0 + timedelta(minutes=37 * i)
        write_emlx(os.path.join(dirs[i % 2], f"{i + 1}.emlx"), rfc822_message(i, seed, paras, when, i % 10 == 0),
                   int(when.timestamp()))
    return {"emails": n, "multipart": (n + 9) // 10, "paragraphs": int(n_par.sum()), "dirs": dirs,
            "sentences": sentences}


def write_chrome_history(home: str, n_rows: int, seed: int, sentences=None) -> dict:
    """Chrome ``History`` databases (its ``urls`` table) under
    ``home/.config/google-chrome/{Default,Profile 1}/`` with ``n_rows``
    rows in all (3 : 2): titles of 5-12 words of ``synth_corpus`` sentences
    (or of ``sentences``), URLs on 400 hosts. -> {"rows", "dbs",
    "sentences"}."""
    import sqlite3

    rng = np.random.default_rng(seed)
    sentences = _sentences(sentences, n_rows, rng)
    title_len = rng.integers(5, 13, size=n_rows)
    host = rng.integers(0, 400, size=n_rows)
    visits = rng.integers(1, 40, size=n_rows)
    split = {CHROME_PROFILES[0]: n_rows * 3 // 5, CHROME_PROFILES[1]: n_rows - n_rows * 3 // 5}
    dbs, at = [], 0
    for prof, n in split.items():
        d = os.path.join(home, ".config", "google-chrome", prof)
        os.makedirs(d)
        rows = []
        for i in range(at, at + n):
            words = sentences[i].split()
            rows.append((f"https://site{host[i]}.example.com/{'/'.join(words[12:15])}",
                         " ".join(words[: title_len[i]]), int(visits[i]), 0,
                         13_350_000_000_000_000 + i * 61_000_000, 0))
        at += n
        dbs.append(os.path.join(d, "History"))
        conn = sqlite3.connect(dbs[-1])
        try:
            conn.execute(CHROME_URLS)
            conn.executemany("INSERT INTO urls(url, title, visit_count, typed_count, last_visit_time, hidden) "
                             "VALUES (?, ?, ?, ?, ?, ?)", rows)
            conn.commit()
        finally:
            conn.close()
    return {"rows": n_rows, "dbs": dbs, "sentences": sentences}


def write_wechat_db(path: str, n_chats: int, per_chat: int, seed: int, sentences=None) -> dict:
    """A decrypted WeChat message database: ``n_chats`` ``Chat_<md5>``
    tables of ``per_chat`` messages (4-20 words of ``synth_corpus``
    sentences, or of ``sentences``; one in 20 with an emoticon tag, one in
    50 an image's XML). -> {"chats", "messages", "sentences"}."""
    import hashlib
    import sqlite3

    rng = np.random.default_rng(seed)
    sentences = _sentences(sentences, n_chats * per_chat, rng)
    length = rng.integers(4, 21, size=n_chats * per_chat)
    incoming = rng.integers(0, 2, size=n_chats * per_chat)
    conn = sqlite3.connect(path)
    try:
        for c in range(n_chats):
            table = "Chat_" + hashlib.md5(f"wxid_contact{c:03d}".encode()).hexdigest()
            conn.execute(f'CREATE TABLE "{table}" (mesLocalID INTEGER PRIMARY KEY, msgCreateTime INTEGER, '
                         "mesDes INTEGER, msgContent TEXT, messageType INTEGER)")
            rows = []
            for j in range(per_chat):
                i = c * per_chat + j
                text, kind = " ".join(sentences[i].split()[: length[i]]), 1
                if j % 50 == 7:
                    text, kind = f'<msg><img cdnurl="https://wx.example.com/{c}/{j}" aeskey="k{j}"/></msg>', 3
                elif j % 20 == 3:
                    text += " [Smile]"
                rows.append((j + 1, 1_704_700_000 + c * 86_400 + j * 45, int(incoming[i]), text, kind))
            conn.executemany(f'INSERT INTO "{table}" VALUES (?, ?, ?, ?, ?)', rows)
        conn.commit()
    finally:
        conn.close()
    return {"chats": n_chats, "messages": n_chats * per_chat, "sentences": sentences}


def write_book(path: str, n_chapters: int, paras_per_chapter: int, seed: int, sentences=None) -> dict:
    """A plain-text book: a title, then ``Chapter N`` headings, each over
    ``paras_per_chapter`` paragraphs of ``synth_corpus`` sentences (or of
    ``sentences``; each paragraph over 120 characters), split by blank
    lines. -> {"chapters", "paragraphs": [(chapter, text)]}."""
    rng = np.random.default_rng(seed)
    n = n_chapters * paras_per_chapter
    sentences = _sentences(sentences, n * SENTENCES_PER_PARAGRAPH, rng)
    paras = _paragraphs(sentences, 0, n)
    parts = ["A GENERATED NOVEL\n\nIn forty chapters\n"]
    for ch in range(n_chapters):
        parts.append(f"Chapter {ch + 1}\n\n" + "\n\n".join(paras[ch * paras_per_chapter:(ch + 1) * paras_per_chapter]))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n\n".join(parts) + "\n")
    return {"chapters": n_chapters, "paragraphs": [(i // paras_per_chapter + 1, p) for i, p in enumerate(paras)]}


APP_SEARCH_KW = dict(top_k=5, complexity=64, beam_width=8, prune_ratio=0.0)  # the apps' search defaults
APP_QUERIES = 16  # ms per query on each app's index
EMAIL_QUERIES = 64  # and on email's, scored against its oracle
APP_WARM_QUERIES = 8  # each timed search after a warm one of this many
# email recall@5 at the apps' complexity 64. tests/email_recall_witness.py (on
# a CPU, this mail's 14,937 chunks) gives the JAX package's hnsw 0.700 in the
# order the reader's directory walk took there, and 0.634-0.731 over six
# other row orders (the port 0.641-0.734, within 0.01 of it in each order):
# the walk's order differs between file systems, so the floor is the JAX
# package's lowest, 0.634, less 0.03 for the 64 queries' sampling
EMAIL_RECALL_FLOOR = 0.60


def _items(name: str, passages: list) -> int:
    """Source items behind an app's passages: messages, history rows,
    conversations, files."""
    md = [p["metadata"] for p in passages]
    if name == "email":
        return len({(m["subject"], m["from"], m["date"]) for m in md})
    if name == "wechat":
        return len({m["contact"] for m in md})
    if name in ("code", "document"):
        return len({m["file_path"] for m in md})
    return len(passages)


def phase_apps(torch, dev, workdir: str, docs: str, sentences: list):
    """Phase 13 over phase 11's folder ``docs``, the fixtures' text drawn
    from ``sentences`` (phase 4's chunks) -> (kernel rows by (kernel, path),
    launches by path)."""
    import contextlib
    import io

    from leann_torch import LeannChat, LeannSearcher, api, chat
    from leann_torch.apps.browser_rag import BrowserRAG
    from leann_torch.apps.code_rag import CodeRAG
    from leann_torch.apps.document_rag import DocumentRAG
    from leann_torch.apps.email_rag import EmailRAG
    from leann_torch.apps.wechat_exporter import export_db
    from leann_torch.apps.wechat_rag import WeChatRAG
    from leann_torch.examples import basic_demo, spoiler_free_book_rag
    from leann_torch.ops import graph
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.storage import index_all_in_bytes

    t_phase = time.time()
    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches, checks, specs = {}, {}, {}
    root = os.path.join(workdir, "apps")
    home = os.path.join(root, "home")
    t = time.time()
    mail = write_mail_folder(home, APPS_SIZES["emails"], seed=13, sentences=sentences)
    hist = write_chrome_history(home, APPS_SIZES["history_rows"], seed=14, sentences=sentences[-30_000:])
    wx = write_wechat_db(os.path.join(root, "msg_0.db"), APPS_SIZES["wechat_chats"], APPS_SIZES["wechat_per_chat"],
                         seed=15, sentences=sentences[-60_000:])
    book_path = os.path.join(root, "book.txt")
    book = write_book(book_path, APPS_SIZES["book_chapters"], APPS_SIZES["book_paras"], seed=16,
                      sentences=sentences[-12_000:])
    code = os.path.join(root, "code")
    for pkg in ("leann_torch", "leann_tpu"):  # the checkout's own code
        shutil.copytree(REPO / pkg, os.path.join(code, pkg), ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    documents = os.path.join(root, "documents")  # a fixed 400 of phase 11's files: the first by sorted path
    readable = sorted(os.path.relpath(os.path.join(d, f), docs) for d, _, files in os.walk(docs) for f in files
                      if not f.startswith(".") and os.path.relpath(d, docs).split(os.sep)[0] in ("notes", "repo"))
    for rel in readable[:APPS_SIZES["document_files"]]:
        os.makedirs(os.path.dirname(os.path.join(documents, rel)), exist_ok=True)
        shutil.copyfile(os.path.join(docs, rel), os.path.join(documents, rel))
    export = os.path.join(root, "wechat_export")
    os.makedirs(export)
    conversations = export_db(os.path.join(root, "msg_0.db"), export)
    fixtures = {"generate_s": time.time() - t, "emails": mail["emails"], "multipart": mail["multipart"],
                "history_rows": hist["rows"], "wechat_messages": wx["messages"], "wechat_conversations": conversations,
                "book_chapters": book["chapters"], "book_paragraphs": len(book["paragraphs"]),
                "document_files": len(readable[:APPS_SIZES["document_files"]])}

    seen = {"builds": [], "knn": [], "prompts": []}
    real_build, real_exact_knn, real_ask = api.LeannBuilder.build_index, graph.exact_knn, chat.SimulatedChat.ask

    def recording_build(self, index_path):  # the build's start and its builder; launches nothing itself
        seen["builds"].append((time.time(), self))
        return real_build(self, index_path)

    def recording_exact_knn(emb, k, *a, **kw):  # the k-NN's operands; launches nothing itself
        seen["knn"].append((emb, k))
        return real_exact_knn(emb, k, *a, **kw)

    def recording_ask(self, prompt, system=None, **kw):  # the prompt the chat sent
        seen["prompts"].append(prompt)
        return real_ask(self, prompt, system=system, **kw)

    def drive(path: str, fn):
        """``fn()`` with the counts set to 0 just before and read just after
        -> (its stdout, wall seconds, start time, its result)."""
        for v in seen.values():
            v.clear()
        out = io.StringIO()
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            result = fn()
        torch.cuda.synchronize()
        launches[path] = _counts(counters)
        return out.getvalue(), time.time() - t0, t0, result

    def passages_of(prefix):
        with open(prefix + ".passages.jsonl") as f:
            return [json.loads(line) for line in f]

    def context_equal(prefix, q, **kw) -> bool:
        """The chat's prompt holds the searcher's top texts, in order."""
        want = LeannSearcher(prefix, device="cuda").search(q, **kw)
        prompt = LeannChat.PROMPT_TEMPLATE.format(context="\n\n".join(r.text for r in want), question=q)
        return bool(want) and seen["prompts"] == [prompt]

    def check_build(path: str):
        """B2 of this build's one k-NN, against its plain version on its
        inputs -> the spec :func:`timed_rows` would time it by."""
        if len(seen["knn"]) != 1:
            fail(f"{path}: {len(seen['knn'])} k-NN passes where the build makes one")
        emb, k = seen["knn"][0]
        ebf, norms = kp.upload_panel_inputs(emb, dev)
        checks[("knn_panel", path)], spec = panel_check(torch, kp, ebf, norms, k, emb.shape[1])
        return spec

    apps = [("email", EmailRAG, []), ("browser", BrowserRAG, []), ("wechat", WeChatRAG, ["--export-dir", export]),
            ("code", CodeRAG, ["--repo-dir", code]), ("document", DocumentRAG, ["--data-dir", documents])]
    first_q = {"email": mail["sentences"][0], "browser": hist["sentences"][0], "wechat": wx["sentences"][1],
               "code": "def exact_knn_sharded checkpoint resume", "document": "notes planning memo"}
    rows = {}
    prev_cwd, prev_home = os.getcwd(), os.environ.get("HOME")
    os.chdir(root)
    os.environ["HOME"] = home
    api.LeannBuilder.build_index, graph.exact_knn, chat.SimulatedChat.ask = (recording_build, recording_exact_knn,
                                                                           recording_ask)
    try:
        for name, cls, argv in apps:
            q = " ".join(first_q[name].split()[:12])
            prefix = os.path.join(root, f"{name}_index", "documents.leann")
            argv = [*argv, "--index-dir", os.path.dirname(prefix), "--llm", "simulated", "--query", q]
            out, wall, t0, _ = drive(f"apps_{name}", lambda: cls().run(argv))
            builds, knn = len(seen["builds"]), [k for _, k in seen["knn"]]
            load_chunk_s = seen["builds"][0][0] - t0 if builds else None
            build_s = dict(seen["builds"][0][1].phase_seconds) if builds else {}
            ctx = context_equal(prefix, q, **APP_SEARCH_KW)
            spec = check_build(f"apps_{name}")
            if name == "email":
                specs[("knn_panel", "apps_email")] = spec
            out2, wall2, _, _ = drive(f"apps_{name}_again", lambda: cls().run(argv))
            passages = passages_of(prefix)
            by_text = sorted(p["text"] for p in passages)
            rng = np.random.default_rng(len(name))
            n_q = EMAIL_QUERIES if name == "email" else APP_QUERIES
            queries = [" ".join(by_text[i].split()[:12])
                       for i in rng.choice(len(by_text), min(n_q, len(by_text)), replace=False)]
            got, ms_q = _timed_search(torch, LeannSearcher(prefix), queries, warm=APP_WARM_QUERIES, **APP_SEARCH_KW)
            rows[name] = {"items": _items(name, passages), "chunks": len(passages), "load_chunk_s": load_chunk_s,
                          "run_s": wall, "build_s": build_s, "all_in_bytes": index_all_in_bytes(prefix),
                          "ms_per_query": ms_q, "queries": len(queries), "builds": builds, "knn_k": knn,
                          "context_equal": ctx, "again": {"run_s": wall2, "builds": len(seen["builds"]),
                                                          "skipped": "skipping build" in out2,
                                                          "context_equal": context_equal(prefix, q, **APP_SEARCH_KW)},
                          "answer": out.strip().splitlines()[-1][:120] if out.strip() else ""}
            if name == "email":  # the exact oracle over the same chunks, built as the app builds with --backend flat
                o_prefix = os.path.join(root, "email_oracle", "documents.leann")

                def oracle_truth():
                    ob = api.LeannBuilder(backend_name="flat", embedding_model="hash-minilm", max_length=256)
                    for p in passages:
                        ob.add_text(p["text"], metadata=p["metadata"])
                    ob.build_index(o_prefix)
                    return LeannSearcher(o_prefix).search(queries, top_k=5)

                _, o_wall, _, truth = drive("apps_email_oracle", oracle_truth)
                oracle = LeannSearcher(o_prefix)
                rows[name].update(recall_at_5=_recall(got, truth, k=5), oracle_build_s=o_wall,
                                  oracle_same_passages=passages == passages_of(o_prefix))
                o_row, o_spec = oracle_check(torch, dev, oracle, queries, k=5)
                checks[("flat_topk", "apps_email_oracle")] = o_row
                specs[("flat_topk", "apps_email_oracle")] = o_spec

        # the examples over a generated book
        for name, mod, extra in (("basic_demo", basic_demo, []),
                                 ("spoiler", spoiler_free_book_rag,
                                  ["--up-to-chapter", "3", "--query",
                                   next(p for ch, p in book["paragraphs"] if ch == 2)])):
            argv = ["--book", book_path, "--index-dir", os.path.join(root, f"{name}_index"), *extra]
            out, wall, t0, _ = drive(f"apps_{name}", lambda: mod.main(argv))
            knn = [k for _, k in seen["knn"]]
            builds = len(seen["builds"])
            build_s = dict(seen["builds"][0][1].phase_seconds) if builds else {}
            check_build(f"apps_{name}")
            out2, wall2, _, _ = drive(f"apps_{name}_again", lambda: mod.main(argv))
            lines = out.splitlines()
            rows[name] = {"run_s": wall, "builds": builds, "knn_k": knn, "build_s": build_s,
                          "again": {"run_s": wall2, "builds": len(seen["builds"])},
                          "results": sum(ln.startswith("[") for ln in lines) if name == "basic_demo"
                          else [int(ln.split("[ch.")[1].split("]")[0]) for ln in lines if ln.startswith("  [ch.")],
                          "answered": any(ln.startswith("A: [simulated]") for ln in lines)}
    finally:
        api.LeannBuilder.build_index, graph.exact_knn, chat.SimulatedChat.ask = real_build, real_exact_knn, real_ask
        os.chdir(prev_cwd)
        if prev_home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = prev_home

    # two timed rows in one profile window: email's B2 and its oracle's B1
    kr = one_window(torch, {key: (checks[key], specs[key]) for key in specs})
    del specs
    emit({"phase": "apps", "fixtures": fixtures, "apps": rows, "launches": launches,
          "checks": {f"{name}@{path}": r for (name, path), r in checks.items()},
          "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                      for (name, path), r in kr.items()},
          "phase_s": time.time() - t_phase})
    for name, r in rows.items():
        if launches[f"apps_{name}"]["knn_panel"] != 1 or r["knn_k"] != [128] or r["builds"] != 1:
            fail(f"the {name} build did not launch knn_panel once at k = 128: {launches[f'apps_{name}']}, {r}")
        if r["again"]["builds"] or launches[f"apps_{name}_again"]["knn_panel"]:
            fail(f"the second {name} run built again: {r['again']}, {launches[f'apps_{name}_again']}")
        if "context_equal" in r and not (r["context_equal"] and r["again"]["context_equal"] and r["again"]["skipped"]):
            fail(f"the {name} app's answer context is not the searcher's top 5: {r}")
    if launches["apps_email_oracle"]["flat_topk"] != 1 or launches["apps_email_oracle"]["knn_panel"]:
        fail(f"the email oracle's build and search did not launch flat_topk once: {launches['apps_email_oracle']}")
    if rows["email"]["recall_at_5"] < EMAIL_RECALL_FLOOR or not rows["email"]["oracle_same_passages"]:
        fail(f"email recall@5 {rows['email']['recall_at_5']:.4f} at the apps' complexity 64 below the "
             f"{EMAIL_RECALL_FLOOR} floor, or other passages")
    if rows["basic_demo"]["results"] != 3 or not rows["basic_demo"]["answered"]:
        fail(f"basic_demo: {rows['basic_demo']}")
    sf = rows["spoiler"]["results"]
    if not sf or max(sf) > 3 or not rows["spoiler"]["answered"]:
        fail(f"spoiler_free_book_rag at --up-to-chapter 3 gave chapters {sf}")
    check_rows(checks)
    return kr, launches


# phase 14: the parallel layer on one card, as 4 gp shards of it (a mesh
# may hold one device several times), over phase 4's chunks and index
PARALLEL_SHARDS = 4
PARALLEL_ENTRY_CHUNKS = 20_000  # the normal entry points' hnsw build, at gp = the card count
PARALLEL_ENTRY_KW = dict(top_k=3, complexity=32, beam_width=4)
PARALLEL_TRAIN_STEPS, PARALLEL_TRAIN_BATCH = 10, 64
PARALLEL_BF16_STEPS = 4
# the (2, 2) trainer's loss against the one-device trainer's, relative: f32
# at every step; bf16 at its first step (the forward alone), then, after
# updates, at twice the largest difference the card gave in runs of this
# phase (3.9e-4, 1.0e-3, 5.4e-4 at steps 2-4; bf16 rounding Adam turns
# into other updates: 9.3e-3 by step 10)
PARALLEL_LOSS_RTOL, PARALLEL_BF16_LATER_RTOL = 1e-3, 2e-3


def _label_sets(labels, id_list) -> list:
    return [{id_list[i] for i in row if i >= 0} for row in np.asarray(labels).tolist()]


def _recall_sets(got: list, truth) -> float:
    return float(np.mean([len(g & {r.id for r in t}) / len(t) for g, t in zip(got, truth)]))


def phase_parallel(torch, dev, workdir: str, main: dict):
    """Phase 14 -> (kernel rows by (kernel, path), launches by path)."""
    import dataclasses

    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.embeddings.encoder import MODEL_REGISTRY, get_encoder, init_params
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.beam_search import beam_search_batch
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.parallel import sharded_build as sb
    from leann_torch.parallel.mesh import graph_mesh, make_mesh, serving_mesh
    from leann_torch.parallel.sharded_search import ShardedSearcher
    from leann_torch.parallel.train import ContrastiveTrainer

    t_phase = t_part = time.time()
    parts_s = {}
    chunks, queries, truth = main["chunks"], main["queries"], main["truth"]
    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches, checked = {}, {}
    gp = PARALLEL_SHARDS
    mesh = graph_mesh(gp, [dev] * gp)
    rings = []
    real_ring = sb._ring_knn_placed

    def recording_ring(ebf, norms, s, k, devs):  # keeps each ring's operands and lists; launches nothing itself
        out = real_ring(ebf, norms, s, k, devs)
        rings.append(dict(ebf=list(ebf), norms=list(norms), s=s, k=k, out=out))
        return out

    def ring_step_checks(ring, me: int, owner: int, d: int, path: str) -> None:
        """Shard ``me``'s launch against the tile of ``owner`` and its merge
        into the running lists, held against the plain versions."""
        ebf, norms, s, k = ring["ebf"], ring["norms"], ring["s"], ring["k"]
        checked[("knn_panel_ext", path)] = ext_check(torch, kp, ebf[me], norms[me], ebf[owner], norms[owner], k,
                                                     owner * s, me * s, d=d)
        new_i, new_d = kp.knn_panel_ext(ebf[me], norms[me], ebf[owner], norms[owner], k, ebf[owner].shape[0],
                                        owner * s, me * s)
        if owner == me:  # the ring's first step merges into empty lists
            run_i, run_d = torch.full_like(new_i, -1), torch.full_like(new_d, 3.4e38)
        else:
            run_i, run_d = kp.knn_panel_ext(ebf[me], norms[me], ebf[me], norms[me], k, ebf[me].shape[0], me * s,
                                            me * s)
        checked[("topk_merge", path)] = merge_check(torch, kp, torch.stack([run_d, new_d], 1),
                                                    torch.stack([run_i, new_i], 1))

    # (a) the sharded build over phase 4's matrix (the unit rows) at diskann's
    # candidate width (R = 32, C = 64), against phase 4's one-card build
    emb = main.pop("graph_data")
    build_s = {}
    sb._ring_knn_placed = recording_ring
    try:
        _reset(counters)
        torch.cuda.synchronize()
        t = time.time()
        graph_sh, medoid_sh = sb.sharded_build_graph(emb, mesh, r=32, candidate_factor=2, phase_seconds=build_s)
        build_wall = time.time() - t
        launches["parallel/sharded_build"] = _counts(counters)
        ring = rings.pop()
        ring_ids = torch.cat([i for i, _ in ring["out"]]).cpu().numpy()
        del ring["out"]
        ring_step_checks(ring, 1, 0, emb.shape[1], "parallel/sharded_build")
        del ring

        be = LeannSearcher(main["prefix"]).backend  # phase 4's diskann index on the card
        kw = {k: v for k, v in main["kw"].items() if k != "top_k"}
        cfg, params = be._make_cfg(3, need_encoder=True, **kw)
        _, qp = be._encode_text(queries, cfg, params)
        g1 = be._graph_data()
        g_sh = g1._replace(neighbors=torch.from_numpy(graph_sh.astype(np.int64)).to(dev))
        n_rows = be.n  # the index's rows are sorted sets, padded with N (storage.pack_neighbors)
        recall_graph = {name: _recall_sets(_label_sets(beam_search_batch(qp, g, cfg, params)[0].cpu(), be.id_list),
                                           truth) for name, g in (("one_card", g1), ("sharded_build", g_sh))}
        build_row = {"n": int(emb.shape[0]), "d": int(emb.shape[1]), "gp": gp, "k": 64, "build_s": build_s,
                     "build_wall_s": build_wall, "ring_ids_equal_exact_knn": float(np.mean(ring_ids == main["knn_ids"])),
                     "graph_rows_equal_one_card": float((np.sort(np.where(graph_sh >= 0, graph_sh, n_rows), axis=1)
                                                         == be.neighbors.cpu().numpy()).all(axis=1).mean()),
                     "medoid": [medoid_sh, int(np.load(main["prefix"] + ".diskann.npz")["medoid"])],
                     "recall_at_3": recall_graph}
        del emb, g_sh, graph_sh, ring_ids

        parts_s["build"] = time.time() - t_part
        t_part = time.time()
        # (b) the sharded searcher over phase 4's index: its device tensors
        # sliced into gp shards, so the card holds the index once
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        index = dict(entries=be.entries, tokens=be.tokens, lengths=be.lengths, codes=be.codes,
                     codebooks=be.codebooks, entry_emb=be.entry_emb)
        ss = ShardedSearcher(mesh, be.neighbors, **index)
        placed_bytes = torch.cuda.memory_allocated() - mem0
        cfg_pq = dataclasses.replace(cfg, rerank=0)
        l_pq, _ = ss.search(qp, cfg_pq, params)
        l1_pq = beam_search_batch(qp, g1, cfg_pq, params)[0].cpu().numpy()
        ss.search(qp, cfg, params)  # warm
        torch.cuda.synchronize()
        t = time.time()
        l_sh, _ = ss.search(qp, cfg, params)
        sharded_ms = (time.time() - t) * 1e3 / len(queries)
        beam_search_batch(qp, g1, cfg, params)  # warm
        torch.cuda.synchronize()
        t = time.time()
        l_one = beam_search_batch(qp, g1, cfg, params)[0].cpu().numpy()
        one_ms = (time.time() - t) * 1e3 / len(queries)
        l_gp2, _ = ShardedSearcher(graph_mesh(2, [dev] * 2), be.neighbors, **index).search(qp, cfg_pq, params)
        l_dp2, _ = ShardedSearcher(serving_mesh(2, 2, [dev] * 4), be.neighbors, **index).search(qp, cfg_pq, params)
        search_row = {"gp": gp, "queries": len(queries), "placed_bytes": placed_bytes,
                      "pq_label_sets_equal_one_card": float(np.mean([set(a) == set(b) for a, b in
                                                                     zip(l_pq.tolist(), l1_pq.tolist())])),
                      "recall_at_3": {"sharded": _recall_sets(_label_sets(l_sh, be.id_list), truth),
                                      "one_card": _recall_sets(_label_sets(l_one, be.id_list), truth)},
                      "ms_per_query": {"sharded": sharded_ms, "one_card": one_ms},
                      "serving_dp2_gp2_rows_equal_gp2": int((l_gp2 == l_dp2).all(axis=1).sum())}
        del ss, be, g1, index
        torch.cuda.empty_cache()

        parts_s["search"] = time.time() - t_part
        t_part = time.time()
        # (c) the normal entry points at gp = the card count: hnsw built with
        # build_sharded=True over the first 20,000 chunks, searched by a
        # sharded and an unsharded LeannSearcher against a flat oracle
        sub = chunks[:PARALLEL_ENTRY_CHUNKS]
        sub_q = [" ".join(sub[i].split()[:12]) for i in np.random.default_rng(14).choice(len(sub), 64, replace=False)]
        prefix = os.path.join(workdir, "par_hnsw.leann")
        _reset(counters)
        b = LeannBuilder(embedding_model="hash-minilm", max_length=128, build_sharded=True)
        for c in sub:
            b.add_text(c)
        b.build_index(prefix)
        launches["parallel/build_sharded_hnsw"] = _counts(counters)
        ring = rings.pop()
        del ring["out"]
        ring_step_checks(ring, 0, 0, ring["ebf"][0].shape[1], "parallel/build_sharded_hnsw")
        del ring
    finally:
        sb._ring_knn_placed = real_ring
    oracle = LeannBuilder(backend_name="flat", embedding_model="hash-minilm", max_length=128)
    for c in sub:
        oracle.add_text(c)
    oracle_prefix = os.path.join(workdir, "par_flat.leann")
    oracle.build_index(oracle_prefix)
    sub_truth = LeannSearcher(oracle_prefix).search(sub_q, top_k=3)
    s_sh = LeannSearcher(prefix, sharded=True)
    got_sh, entry_ms_sh = _timed_search(torch, s_sh, sub_q, **PARALLEL_ENTRY_KW)
    got_one, entry_ms_one = _timed_search(torch, LeannSearcher(prefix), sub_q, **PARALLEL_ENTRY_KW)
    entry_row = {"chunks": len(sub), "card_count": torch.cuda.device_count(), "gp": s_sh.backend._sharded.gp,
                 "build_s": dict(b.phase_seconds),
                 "recall_at_3": {"sharded": _recall(got_sh, sub_truth), "unsharded": _recall(got_one, sub_truth)},
                 "ms_per_query": {"sharded": entry_ms_sh, "unsharded": entry_ms_one},
                 "auto_unsharded": LeannSearcher(prefix, sharded="auto").backend._sharded is None}
    del s_sh

    parts_s["entry_points"] = time.time() - t_part
    t_part = time.time()
    # (d) the trainer on a (dp, tp) = (2, 2) mesh of the card against the
    # one-device trainer, from the same seeded params over the same batches:
    # in f32, where the mesh's split sums are all that differs (checked),
    # and in bf16, the model's own products, where Adam turns each side's
    # rounding into other updates (its later steps held to a wider limit)
    enc = get_encoder("hash-minilm", max_length=TRAIN_D_LEN, device=dev)
    picks = np.random.default_rng(15).choice(len(chunks), PARALLEL_TRAIN_STEPS * PARALLEL_TRAIN_BATCH, replace=False)
    q_ids, q_mask = enc.tokenize([" ".join(chunks[i].split()[:12]) for i in picks], TRAIN_Q_LEN)
    d_ids, d_mask = enc.tokenize([chunks[i] for i in picks], TRAIN_D_LEN)
    train_row = {"model": "hash-minilm", "steps": PARALLEL_TRAIN_STEPS, "batch": PARALLEL_TRAIN_BATCH,
                 "lr": TRAIN_LR, "q_len": TRAIN_Q_LEN, "d_len": TRAIN_D_LEN}
    for dtype in ("float32", "bfloat16"):
        cfg_t = dataclasses.replace(MODEL_REGISTRY["hash-minilm"], compute_dtype=dtype)
        tree = init_params(cfg_t)
        losses, step_ms = {}, {}
        trainers = {"one_device": lambda: ContrastiveTrainer(cfg_t, learning_rate=TRAIN_LR, params=tree, device=dev),
                    "mesh_dp2_tp2": lambda: ContrastiveTrainer(cfg_t, make_mesh([("dp", 2), ("tp", 2)], [dev] * 4),
                                                               TRAIN_LR, params=tree)}
        for name, make in trainers.items():
            tr = make()
            losses[name], secs = [], []
            for step in range(PARALLEL_TRAIN_STEPS if dtype == "float32" else PARALLEL_BF16_STEPS):
                sl = slice(step * PARALLEL_TRAIN_BATCH, (step + 1) * PARALLEL_TRAIN_BATCH)
                t = time.time()
                losses[name].append(tr.train_step(q_ids[sl], q_mask[sl], d_ids[sl], d_mask[sl]))  # ends on the card
                secs.append(time.time() - t)
            step_ms[name] = float(np.mean(secs[2:])) * 1e3
            del tr
        torch.cuda.empty_cache()
        rel = np.abs(np.array(losses["mesh_dp2_tp2"]) - losses["one_device"]) / np.abs(losses["one_device"])
        train_row[dtype] = {"losses": losses, "rel_loss_diff": rel.tolist(), "warm_ms_per_step": step_ms,
                            "finite": bool(np.isfinite(losses["mesh_dp2_tp2"]).all())}

    parts_s["trainer"] = time.time() - t_part
    t_part = time.time()
    kr = one_window(torch, checked)
    parts_s["kernel_rows"] = time.time() - t_part
    row = {"phase": "parallel", "mesh": f"{gp} gp shards of one card", "sharded_build": build_row,
           "sharded_search": search_row, "entry_points": entry_row, "trainer": train_row, "launches": launches,
           "phase_s": time.time() - t_phase, "parts_s": parts_s,
           "kernels": {f"{name}@{path}": {key: v for key, v in r.items() if key != "kernel_parts_ms"}
                       for (name, path), r in kr.items()},
           "reduced": "one card: the gp shards share it, so no number here is a multi-card one"}
    emit(row)
    want = gp * gp
    got = launches["parallel/sharded_build"]
    if got["knn_panel_ext"] != want or got["topk_merge"] != want or got["knn_panel"]:
        fail(f"the sharded build over {gp} shards did not launch {want} ring steps and {want} merges: {got}")
    if build_row["ring_ids_equal_exact_knn"] < 0.9999:
        fail(f"ring_knn's ids differ from phase 4's exact_knn: {build_row['ring_ids_equal_exact_knn']}")
    if abs(recall_graph["sharded_build"] - recall_graph["one_card"]) > 0.02:
        fail(f"the sharded graph's recall@3 is off the one-card graph's: {recall_graph}")
    if search_row["pq_label_sets_equal_one_card"] < 0.99:
        fail(f"the sharded pq traversal differs from the one-card search: {search_row}")
    if abs(search_row["recall_at_3"]["sharded"] - search_row["recall_at_3"]["one_card"]) > 0.02:
        fail(f"the sharded search's recall@3 is off the one-card search's: {search_row}")
    if search_row["serving_dp2_gp2_rows_equal_gp2"] != len(queries):
        fail(f"the (dp 2, gp 2) search differs from the gp 2 search: {search_row}")
    cards = torch.cuda.device_count()
    got = launches["parallel/build_sharded_hnsw"]
    if entry_row["gp"] != cards or got["knn_panel_ext"] != cards * cards or got["topk_merge"] != cards * cards:
        fail(f"build_sharded / sharded=True did not run over one shard per card: {entry_row}, {got}")
    if abs(entry_row["recall_at_3"]["sharded"] - entry_row["recall_at_3"]["unsharded"]) > 0.02:
        fail(f"the sharded LeannSearcher's recall@3 is off the unsharded one's: {entry_row}")
    if cards == 1 and not entry_row["auto_unsharded"]:
        fail("sharded='auto' sharded a searcher on a one-card machine")
    f32, bf16 = train_row["float32"], train_row["bfloat16"]
    if not (f32["finite"] and bf16["finite"] and max(f32["rel_loss_diff"]) <= PARALLEL_LOSS_RTOL
            and bf16["rel_loss_diff"][0] <= PARALLEL_LOSS_RTOL
            and max(bf16["rel_loss_diff"][1:]) <= PARALLEL_BF16_LATER_RTOL):
        fail(f"the (2, 2) mesh trainer's losses are off the one-device trainer's: {train_row}")
    for (name, path), r in kr.items():
        if r.get("identical") is False or r.get("overlap", 1.0) < 0.9999 or r["max_abs_err"] > 1e-5:
            fail(f"{name} on {path} disagrees with its plain version: {r}")
    return kr, launches


# phase 15: checkpoints whose only tokenizer files are the slow ones
# transformers converts, read by the port's own converters
CAMEMBERT = dict(vocab_size=32005, dim=768, n_layers=12, n_heads=12, mlp_dim=3072, max_len=514)
CAMEMBERT_HEAD = 5  # CamembertConverter's pieces before the model's pieces[1:]; <mask> comes after them


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_field(num: int, wire: int, payload: bytes) -> bytes:
    """A protobuf field: its key, then a varint (wire 0), 4 bytes (wire 5)
    or a length and the bytes (wire 2)."""
    key = _pb_varint(num << 3 | wire)
    return key + (_pb_varint(len(payload)) + payload if wire == 2 else payload)


def spm_model_bytes(pieces, charsmap: bytes = b"", model_type: int = 1, add_dummy_prefix: bool = True) -> bytes:
    """A SentencePiece ``ModelProto`` in protobuf's wire format, written by
    hand (the card's machine has no protobuf): ``pieces`` as (piece, score,
    type) (field 1: piece 1, score 2 as a float, type 3), the trainer spec
    (field 2: model_type 3, vocab_size 4, unk_id 40 = 0) and the normalizer
    spec (field 3: name 1, precompiled_charsmap 2, add_dummy_prefix 3)."""
    import struct

    out = bytearray()
    for piece, score, typ in pieces:
        body = (_pb_field(1, 2, piece.encode("utf-8")) + _pb_field(2, 5, struct.pack("<f", score))
                + _pb_field(3, 0, _pb_varint(typ)))
        out += _pb_field(1, 2, body)
    out += _pb_field(2, 2, _pb_field(3, 0, _pb_varint(model_type)) + _pb_field(4, 0, _pb_varint(len(pieces)))
                     + _pb_field(40, 0, _pb_varint(0)))
    out += _pb_field(3, 2, _pb_field(1, 2, b"nmt_nfkc" if charsmap else b"identity") + _pb_field(2, 2, charsmap)
                     + _pb_field(3, 0, _pb_varint(int(add_dummy_prefix))))
    return bytes(out)


def camembert_pieces(n_pieces: int) -> list:
    """The (piece, score, type) of phase 15's SentencePiece Unigram of
    ``n_pieces`` pieces, with fairseq's head: <unk> unknown, <s> and </s>
    control; the pieces that cover ``synth_corpus`` words: ▁w0..▁w19999
    whole, ▁w, ▁g, ▁d, digits and digit pairs, letters; seeded fillers no
    corpus word reaches."""
    small = ["▁", "▁w", "▁g", "▁d"] + [f"{i:02d}" for i in range(100)] + [str(i) for i in range(10)]
    small += list("abcdefghijklmnopqrstuvwxyz")
    scores = {"▁": -10.0, "▁w": -9.5, "▁g": -9.0, "▁d": -9.0}
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(p, scores.get(p, -10.0 if len(p) == 2 else -11.0), 1) for p in small]
    pieces += [(f"▁w{i}", -8.0, 1) for i in range(min(20_000, n_pieces - len(pieces)))]
    return pieces + [(f"▁f{i}", -12.0, 1) for i in range(n_pieces - len(pieces))]


def camembert_tokenizer_files(path: str, n_pieces: int) -> dict:
    """CamemBERT's tokenizer as its checkpoints ship it: only
    ``sentencepiece.bpe.model`` (:func:`camembert_pieces` with the
    :func:`nmt_nfkc_rules` charsmap) and a ``tokenizer_config.json`` naming
    ``CamembertTokenizer``. -> {pieces, whole words}."""
    pieces = camembert_pieces(n_pieces)
    with open(os.path.join(path, "sentencepiece.bpe.model"), "wb") as f:
        f.write(spm_model_bytes(pieces, darts_blob(nmt_nfkc_rules())))
    _write_json(os.path.join(path, "tokenizer_config.json"), {"tokenizer_class": "CamembertTokenizer",
                                                              "model_max_length": 512})
    return {"pieces": len(pieces), "whole_words": sum(p.startswith("▁w") and p[2:].isdigit() for p, _, _ in pieces)}


def camembert_tokenizer_json(path: str, n_pieces: int) -> None:
    """The ``tokenizer.json`` that ``transformers``' ``CamembertConverter``
    makes of :func:`camembert_tokenizer_files`' model, written out here:
    the vocab <s>NOTUSED, <pad>, </s>NOTUSED, <unk>, <unk>NOTUSED (-100),
    then the pieces after <unk>, then <mask>; unknown id 3; the charsmap as
    ``Precompiled``, Strip(right), Replace(" {2,}", "▁"); Metaspace "▁"
    always; the template "<s> $A </s>" with CamemBERT's ids (4 + the piece's
    id: 5 and 6); the head and control pieces as special added tokens."""
    pieces = camembert_pieces(n_pieces)
    head = [["<s>NOTUSED", 0.0], ["<pad>", 0.0], ["</s>NOTUSED", 0.0], ["<unk>", 0.0], ["<unk>NOTUSED", -100.0]]
    vocab = head + [[p, score] for p, score, _ in pieces[1:]] + [["<mask>", 0.0]]
    specials = [(p, i) for i, (p, _) in enumerate(head)] + [
        (p, CAMEMBERT_HEAD - 1 + i) for i, (p, _, typ) in enumerate(pieces) if typ == 3]
    meta = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
    _write_json(os.path.join(path, "tokenizer.json"), {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [_added(p, i) for p, i in specials] + [_added("<mask>", len(vocab) - 1, lstrip=True)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(darts_blob(nmt_nfkc_rules())).decode()},
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]},
        "pre_tokenizer": meta,
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "pair": [], "special_tokens": {"<s>": {"id": "<s>", "ids": [5], "tokens": ["<s>"]},
                                                          "</s>": {"id": "</s>", "ids": [6], "tokens": ["</s>"]}}},
        "decoder": meta,
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False},
    })
    _write_json(os.path.join(path, "tokenizer_config.json"), {"tokenizer_class": "CamembertTokenizer"})


def camembert_checkpoint(path: str, widths: "dict | None" = None) -> dict:
    """A checkpoint directory at almanach/camembert-base's widths (or
    ``widths``) as a ``CamembertForMaskedLM`` saves it
    (:func:`roberta_masked_lm`) whose only tokenizer file is
    ``sentencepiece.bpe.model`` (:func:`camembert_tokenizer_files`)."""
    widths = widths or CAMEMBERT
    config = roberta_masked_lm(path, widths, "camembert-seeded", 15, architectures=["CamembertForMaskedLM"],
                               model_type="camembert", bos_token_id=5, eos_token_id=6)
    return {**config, "tokenizer": camembert_tokenizer_files(path, widths["vocab_size"] - CAMEMBERT_HEAD)}


def _same_ids(a, b) -> bool:
    return bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))


def tokenizer_twins(workdir: str, model_dir: str, texts, n_pieces: int) -> dict:
    """Phase 15(b), host only: (1) ``model_dir``'s sentencepiece model of
    ``n_pieces`` pieces beside the ``tokenizer.json`` that
    ``CamembertConverter`` makes of it, written out by
    :func:`camembert_tokenizer_json` (tier-1 holds that file to the
    converter's); (2) phase 12's distilroberta vocabulary and merges written
    as ``vocab.json`` + ``merges.txt`` beside their ``tokenizer.json`` twin.
    Each pair's ids and masks on ``texts`` at max_length 128. -> {pair:
    equal, seconds}."""
    from leann_torch.embeddings import tokenizer as tt
    from leann_torch.embeddings.tokenizer_json import JsonTokenizer

    out = {}
    spm = tt.get_tokenizer(model_dir, max_length=128)
    twin = os.path.join(workdir, "camembert_json_twin")
    os.makedirs(twin, exist_ok=True)
    camembert_tokenizer_json(twin, n_pieces)
    (a, a_s), (b, b_s) = _timed(lambda: spm.encode_batch(texts)), _timed(
        lambda: JsonTokenizer(twin, max_length=128).encode_batch(texts))
    out["spm_vs_tokenizer_json"] = {"equal": _same_ids(a, b), "model_s": a_s, "json_s": b_s}
    json_dir, files_dir = os.path.join(workdir, "roberta_json"), os.path.join(workdir, "roberta_files")
    for d in (json_dir, files_dir):
        os.makedirs(d, exist_ok=True)
    roberta_tokenizer_files(json_dir, DISTILROBERTA["vocab_size"])
    with open(os.path.join(json_dir, "tokenizer.json"), encoding="utf-8") as f:
        model = json.load(f)["model"]
    _write_json(os.path.join(files_dir, "vocab.json"), model["vocab"])
    with open(os.path.join(files_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in model["merges"]))
    shutil.copy(os.path.join(json_dir, "tokenizer_config.json"), files_dir)
    files = tt.get_tokenizer(files_dir, max_length=128)
    (a, a_s), (b, b_s) = _timed(lambda: files.encode_batch(texts)), _timed(
        lambda: JsonTokenizer(json_dir, max_length=128).encode_batch(texts))
    out["bpe_files_vs_tokenizer_json"] = {"equal": _same_ids(a, b), "reader": type(files).__name__, "files_s": a_s,
                                          "json_s": b_s}
    return out


def phase_tokenizer_files(torch, dev, workdir: str, chunks):
    """Phase 15 -> (kernel rows by (kernel, path), launches by path)."""
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk

    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    launches = {}
    t0 = time.time()
    sub = chunks[:BPE_CHUNKS]
    queries = [" ".join(sub[i].split()[:12]) for i in np.random.default_rng(15).choice(len(sub), 64, replace=False)]
    a = _family_path(torch, dev, workdir, "camembert", camembert_checkpoint, sub, queries, counters, launches)
    del a["tok"]
    ckpt = os.path.join(workdir, "camembert")
    n_pieces = CAMEMBERT["vocab_size"] - CAMEMBERT_HEAD
    twins, twins_s = _timed(lambda: tokenizer_twins(workdir, ckpt, sub, n_pieces))
    row = {**a["row"], "model": "camembert-base widths, seeded weights under roberta., sentencepiece.bpe.model only",
           "tokenizer_files": sorted(f for f in os.listdir(ckpt) if f not in ("config.json", "model.safetensors")),
           "twins": twins, "twins_s": twins_s, "phase_s": time.time() - t0}
    emit({"phase": "tokenizer_files", **row})
    failures = a["failures"]
    if row["tokenizer"] != "SpmTokenizer" or row["tokenizer_files"] != ["sentencepiece.bpe.model",
                                                                         "tokenizer_config.json"]:
        failures.append(f"camembert: not the port's sentencepiece reader over a .model-only directory: "
                        f"{row['tokenizer']}, {row['tokenizer_files']}")
    for name, t in twins.items():
        if not t["equal"]:
            failures.append(f"{name}: the ids or masks differ on the {len(sub)} chunks")
    if twins["bpe_files_vs_tokenizer_json"]["reader"] != "BpeFilesTokenizer":
        failures.append(f"vocab.json + merges.txt went to {twins['bpe_files_vs_tokenizer_json']['reader']}")
    if failures:
        fail("; ".join(failures))
    check_rows(a["kr"])
    return a["kr"], launches


# phase 16: the approximate k-NN past the card and the locality relabel
APPROX_FORCED_MAX_N = 50_000  # the k-NN cap forced under phase 4's 100K rows, as phase 7 forces it
SPILL_CHUNK_ROWS = 1 << 19  # 2 probes of 1,048,576 rows: 4 chunks


def _index_arrays(prefix: str) -> dict:
    """Every array of an index's .npz / .npy files (caches included) and its ids."""
    d, base = os.path.split(prefix)
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith(base + ".") and f.endswith((".npz", ".npy")):
            z = np.load(os.path.join(d, f))
            out.update({f"{f}:{k}": z[k] for k in z.files} if f.endswith(".npz") else {f: z})
    with open(prefix + ".ids.json") as f:
        out["ids"] = f.read()
    return out


def _same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k] == b[k] if k == "ids" else (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])) for k in a)


def _backend_npz(prefix: str) -> str:
    return f"{prefix}.diskann.npz" if os.path.exists(prefix + ".diskann.npz") else f"{prefix}.hnsw.npz"


def _relabel_check(torch, prefix: str, ids, queries, kw: dict, relabel) -> dict:
    """One relabel of the index at ``prefix``, checked: the v2 format first
    (so the arrays compared are the relabel's alone), every array, the
    bytes and the edge locality; ``relabel()`` timed; the queries' ids
    after it (the searcher maps rows to ids) against ``ids``, an earlier
    search's, the rows moved, bytes and locality after; then
    unrelabel_index, and the arrays and bytes it restored."""
    from leann_torch import LeannSearcher
    from leann_torch.ops.relabel import edge_locality
    from leann_torch.repack import repack_index, unrelabel_index
    from leann_torch.storage import index_all_in_bytes, load_ids, unpack_neighbors

    t = time.time()
    repack_index(prefix)
    arrays, n_bytes = _index_arrays(prefix), index_all_in_bytes(prefix)
    locality = edge_locality(unpack_neighbors(np.load(_backend_npz(prefix))))
    steps = {"before": time.time() - t}
    torch.cuda.synchronize()
    t = time.time()
    out = relabel()
    torch.cuda.synchronize()
    relabel_s = time.time() - t
    t = time.time()
    order = np.array(load_ids(prefix), np.int64)
    got = [[r.id for r in row] for row in LeannSearcher(prefix).search(queries, **kw)]
    steps["search"] = time.time() - t
    row = {"relabel_s": relabel_s, "n": int(order.shape[0]),
           "moved_rows": int((order != np.arange(order.shape[0])).sum()),
           "bytes": [n_bytes, index_all_in_bytes(prefix)],
           "edge_locality_64k": [locality, edge_locality(unpack_neighbors(np.load(_backend_npz(prefix))))],
           "same_results": got == ids, "differing_queries": sum(a != b for a, b in zip(got, ids))}
    t = time.time()
    unrelabel_index(prefix)
    row["unrelabel_s"] = time.time() - t
    row.update(arrays_restored=_same_arrays(_index_arrays(prefix), arrays),
               bytes_restored=index_all_in_bytes(prefix) == n_bytes, checks_s={**steps, "after": time.time() - t})
    if isinstance(out, str):
        row["cli_stdout"] = out.strip()[-200:]
    return row


def _spill_1m(torch, dev, spill_data: dict, counters) -> dict:
    """Phase 16 (a): spill over phase 6's 1,048,576 rows at 2 probes, in
    chunks of 2^19 expanded rows, scored against phase 6's exact lists."""
    from leann_torch.ops import graph

    emb, exact = spill_data.pop("emb"), spill_data.pop("ids")
    k = exact.shape[1]
    _reset(counters)
    torch.cuda.synchronize()
    t = time.time()
    ids, _ = graph.spill_knn_streamed(emb, k, chunk_rows=SPILL_CHUNK_ROWS, device=dev)
    torch.cuda.synchronize()
    return {"n": int(emb.shape[0]), "k": k, "n_probe": 2, "chunk_rows": SPILL_CHUNK_ROWS,
            "chunks": -(-2 * emb.shape[0] // SPILL_CHUNK_ROWS), "s": time.time() - t,
            "candidate_recall_at_64": overlap(torch.from_numpy(exact).to(dev), torch.from_numpy(ids).to(dev)),
            "self_listed": int((ids == np.arange(emb.shape[0])[:, None]).sum()), "kernel_launches": _counts(counters)}


def _approx_build(torch, dev, workdir: str, main: dict, counters, mode: str) -> dict:
    """Phase 16 (b), one mode: diskann over phase 4's embeddings through
    build_index_from_embeddings past a lowered card cap under
    LEANN_KNN_MODE=``mode``, into one prefix for both modes (each build
    keeps the passages and token store it finds there): its candidates
    against phase 4's B2 lists, its step seconds, descent's rounds and
    improved fraction per round, recall@3 of phase 4's queries against its
    oracle, and the two choices the card's free memory makes on this path
    (the prune against PQ-decoded rows, the token store in host RAM)."""
    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.ops import graph

    name = {"spill": "spill_knn_streamed", "descent": "nn_descent"}[mode]
    real = {n: getattr(graph, n) for n in (name, "_nn_descent_iter", "prune_ebf_max_bytes")}
    real_cap = graph.exact_knn_max_n
    saved_mode = os.environ.get("LEANN_KNN_MODE")
    seen = {"rounds": [], "prune_cap": []}

    def recording(*a, **kw):  # the pass's lists and seconds; launches nothing itself
        torch.cuda.synchronize()
        t0 = time.time()
        out = real[name](*a, **kw)
        torch.cuda.synchronize()
        seen["knn_s"], seen["ids"] = time.time() - t0, out[0]
        return out

    def one_round(*a, **kw):  # one call a round with the state on the card: its improved fraction
        out = real["_nn_descent_iter"](*a, **kw)
        seen["rounds"].append(out[2] / (a[5] * out[0].shape[1]))  # changed / (n_real k)
        return out

    def prune_cap(device):
        seen["prune_cap"].append(real["prune_ebf_max_bytes"](device))
        return seen["prune_cap"][-1]

    graph.exact_knn_max_n = lambda d, k, device: APPROX_FORCED_MAX_N
    setattr(graph, name, recording)
    graph._nn_descent_iter, graph.prune_ebf_max_bytes = one_round, prune_cap
    os.environ["LEANN_KNN_MODE"] = mode
    try:
        _reset(counters)
        prefix = os.path.join(workdir, "approx.leann")
        b = LeannBuilder(backend_name="diskann", embedding_model="hash-minilm", max_length=128, graph_degree=32,
                         device=dev)
        t = time.time()
        b.build_index_from_embeddings(prefix, [str(i) for i in range(len(main["chunks"]))], main["emb"].copy(),
                                      texts=main["chunks"])
        build_wall = time.time() - t
        launches = _counts(counters)
    finally:
        graph.exact_knn_max_n = real_cap
        for n, f in real.items():
            setattr(graph, n, f)
        if saved_mode is None:
            os.environ.pop("LEANN_KNN_MODE", None)
        else:
            os.environ["LEANN_KNN_MODE"] = saved_mode
    searcher = LeannSearcher(prefix, device=dev)
    got = searcher.search(main["queries"], **main["kw"])
    emb_bytes = main["emb"].shape[0] * main["emb"].shape[1] * 2
    row = {"build_wall_s": build_wall, "build_s": dict(b.phase_seconds), "knn_call_s": seen["knn_s"],
           "candidate_recall_at_64": overlap(torch.from_numpy(main["knn_ids"]).to(dev),
                                             torch.from_numpy(np.asarray(seen["ids"])).to(dev)),
           "recall_at_3": _recall(got, main["truth"]), "phase4_recall_at_3": main["recall"],
           "prune_pq_mode": any(emb_bytes > c for c in seen["prune_cap"]),
           "tokens_on_host": searcher.backend.tokens_host is not None, "kernel_launches": launches}
    if mode == "descent":
        row.update(rounds=len(seen["rounds"]), improved_fraction_per_round=seen["rounds"])
    return row


def phase_approx_knn(torch, dev, workdir: str, main: dict, spill_data: dict):
    """Phase 16 -> its row: (a) :func:`_spill_1m`, (b) :func:`_approx_build`
    under spill, then under descent, (c) the locality relabel, each undone
    by unrelabel_index (:func:`_relabel_check`): of a copy of phase 4's
    index through relabel_index with no order, and of phase 11's CLI index
    through the CLI's ``repack --relabel --device cuda`` (its ``main``, what
    ``python -m leann_torch.cli`` runs, in this process as phase 11 runs
    the CLI). One process on the card throughout."""
    from leann_torch.ops import knn_panel as kp
    from leann_torch.ops.flat_topk import flat_topk
    from leann_torch.repack import relabel_index

    counters = (flat_topk, kp.knn_panel, kp.knn_panel_ext, kp.topk_merge)
    t_phase = time.time()
    marks = {}

    def mark(name):  # the phase's seconds at the end of each part
        marks[name] = time.time() - t_phase

    spill = _spill_1m(torch, dev, spill_data, counters)
    mark("spill_1m")
    # phase 4's passage store and token cache under the builds' prefix: the
    # builder finds them up to date (the same chunks, ids and model) and
    # keeps them, as the second build keeps the first's
    src_dir, base = os.path.split(main["prefix"])
    for f in os.listdir(src_dir):
        if f.startswith((base + ".passages.", base + ".tokens.cache")):
            shutil.copy(os.path.join(src_dir, f), os.path.join(workdir, "approx.leann" + f[len(base):]))
    builds = {}
    for mode in ("spill", "descent"):
        builds[mode] = _approx_build(torch, dev, workdir, main, counters, mode)
        mark(f"build_{mode}")
    surface = main["surface"]
    copy = _copy_index(main["prefix"], os.path.join(workdir, "relabel_copy"))
    # against the ids phase 4's and phase 11's searches of the same indexes gave
    relabels = {"diskann_copy": _relabel_check(torch, copy, [[r.id for r in row] for row in main["got"]],
                                               main["queries"], main["kw"], lambda: relabel_index(copy, device=dev))}
    mark("relabel_copy")

    def cli_relabel():
        rc, out = _cli(["repack", surface["prefix"], "--relabel", "--device", "cuda"])
        if rc != 0:
            fail(f"repack --relabel of phase 11's index exited {rc}: {out[-1500:]}")
        return out

    relabels["cli_hnsw"] = _relabel_check(torch, surface["prefix"], surface["ids"], surface["queries"],
                                          CLI_SEARCH_KW, cli_relabel)
    mark("relabel_cli")

    row = {"phase": "approx_knn", "spill_1m": spill, "builds_100k": builds,
           "forced": {"exact_knn_max_n": APPROX_FORCED_MAX_N}, "relabel": relabels,
           "phase_s": time.time() - t_phase, "marks_s": marks,
           "reduced": "1,048,576 rows (spill) and 100,000 (the builds) stand in for the 10M+ regime the modes are "
                      "for; the card cap is lowered to reach them"}
    emit(row)
    if spill["self_listed"] or spill["chunks"] < 2:
        fail(f"spill over 1M rows: {spill}")
    for mode, bd in builds.items():
        if bd["kernel_launches"]["knn_panel"] or bd["kernel_launches"]["knn_panel_ext"]:
            fail(f"the {mode} build ran the exact k-NN: {bd['kernel_launches']}")
    if builds["descent"]["recall_at_3"] < 0.80 or builds["descent"]["rounds"] < 1:
        fail(f"the descent build's recall@3 {builds['descent']['recall_at_3']:.4f} is below the 0.80 sanity floor")
    for name, r in relabels.items():
        if not (r["same_results"] and r["arrays_restored"] and r["bytes_restored"] and r["moved_rows"] > 0):
            fail(f"the relabel of {name}: {r}")
    return row


def _timed(fn):
    """-> (``fn()``, its wall seconds on the host's clock)."""
    t = time.time()
    out = fn()
    return out, time.time() - t


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

    build_s = cuda_build.build(["flat_topk", "knn_panel", "ldg_partition", "hash_tokenizer", "passage_store"])
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
    rows, launches = [], {}
    b1 = ("leann_torch/csrc/flat_topk.cu", "leann_tpu/ops/pallas_topk.py:32", "flat_topk")
    b2 = ("leann_torch/csrc/knn_panel.cu", "leann_tpu/ops/pallas_knn.py:45", "knn_panel")
    flat_rows = phase_flat_topk(torch, dev, rng)
    knn_rows = phase_knn_panel(torch, dev, rng)
    rows += [("flat_topk", "diskann", flat_rows[3], b1), ("knn_panel", "diskann", knn_rows[64], b2),
             ("knn_panel", "hnsw", knn_rows[128], b2), ("flat_topk", "flat_top512", flat_rows[512], b1)]
    with tempfile.TemporaryDirectory(dir=REPO / "build") as workdir:
        launches["diskann"], main_state = phase_main_path(torch, workdir)
        launches["hnsw"] = phase_hnsw_path(torch, workdir, main_state)
        spill_data, main_state["surface"] = {}, {}
        more = [phase_beyond_card_knn(torch, dev, seed=6, keep=spill_data),
                phase_beyond_card_path(torch, dev, workdir, main_state, seed=7),
                phase_lifecycle(torch, dev, workdir, main_state)]
        *ckpt_rows, ckpt_state = phase_checkpoint(torch, dev, workdir, main_state["chunks"], main_state["queries"])
        more.append(tuple(ckpt_rows))
        phase_repair(torch, main_state)
        more.append(phase_train(torch, dev, workdir, main_state, ckpt_state))
        more.append(phase_surface(torch, dev, workdir, keep=main_state["surface"]))
        more.append(phase_multilingual(torch, dev, workdir, main_state["chunks"], main_state["queries"]))
        more.append(phase_apps(torch, dev, workdir, os.path.join(workdir, "surface", "docs"), main_state["chunks"]))
        more.append(phase_parallel(torch, dev, workdir, main_state))
        more.append(phase_tokenizer_files(torch, dev, workdir, main_state["chunks"]))
        phase_approx_knn(torch, dev, workdir, main_state, spill_data)
    for kr, more_launches in more:
        launches.update(more_launches)
        rows += [(name, path, r, b1 if name == "flat_topk" else b2) for (name, path), r in kr.items()]
    kernels = []
    for name, path, row, (src, replaces, lib) in rows:
        kernels.append({"name": name, "path": path, "k": row["k"], "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[path][name],
                        "launches_by_path": {p: c.get(name, 0) for p, c in launches.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                        "ms_source": row["profile"]["source"], "call_ms": row["call_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "library_ms_source": row["library_profile"]["source"],
                        "sass": sass[lib]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
