"""Email recall@5 of both packages' EmailRAG on the smoke's mail fixture, on
the CPU: is the hnsw app's recall at complexity 64 the port's or the
algorithm's?

    JAX_PLATFORMS=cpu python tests/email_recall_witness.py --emails 5000 \\
        --workdir /tmp/email_witness [--recompute-queries 8]

Writes ``chip_smoke.write_mail_folder``'s .emlx messages (``--emails`` of
them, seed 13, sentences from ``synth_corpus(100_000, default_rng(0))``, as
phase 13 of ``chip_smoke.py`` writes them), then runs each package's
``EmailRAG.run()`` at the apps' defaults but ``--no-recompute --no-compact``
(the same graph and entry pool, the embeddings stored, so that the search
reads them instead of re-encoding every neighbour of every hop, which on a
CPU takes hours). The flat oracle is built by the port from the port index's
stored embeddings; the 64 queries are phase 13's (12-word prefixes of chunks
drawn with ``default_rng(5)``). Prints one JSON line: per package recall@5
at complexity 64 (and 128, 256) against the oracle, the overlap of the two
packages' top 5, and the largest difference of their stored embeddings.
With ``--recompute-queries Q`` the port also builds the default (recompute,
compact) index and holds its top 5 on the first Q queries against the
stored traversal's (the recompute search re-encodes, so keep Q and
``--emails`` small). With ``--orders K`` each package also builds its
graph over its stored embeddings in K seeded row orders (the order the
reader's directory walk gives differs between file systems) and prints its
recall@5 at complexity 64 in each. Not a pytest test: it takes tens of minutes at 5,000
emails.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import chip_smoke as cs  # noqa: E402

KW = dict(top_k=5, beam_width=8, prune_ratio=0.0)  # the apps' search defaults, complexity aside
STORED = ["--no-recompute", "--no-compact", "--llm", "simulated"]


def passages_of(prefix: str) -> list:
    with open(prefix + ".passages.jsonl") as f:
        return [json.loads(line) for line in f]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--emails", type=int, default=5000)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--recompute-queries", type=int, default=0)
    ap.add_argument("--orders", type=int, default=0)
    a = ap.parse_args()
    home = os.path.join(a.workdir, "home")
    sentences = cs.synth_corpus(100_000, np.random.default_rng(0))
    if not os.path.isdir(home):  # a rerun reuses the fixture, and the apps their indexes
        cs.write_mail_folder(home, a.emails, seed=13, sentences=sentences)
    os.environ["HOME"] = home
    q0 = " ".join(sentences[0].split()[:12])
    res: dict = {"emails": a.emails}

    from leann_torch import LeannBuilder, LeannSearcher
    from leann_torch.apps.email_rag import EmailRAG as PortEmailRAG

    port = os.path.join(a.workdir, "port", "documents.leann")
    t = time.time()
    PortEmailRAG().run(["--index-dir", os.path.dirname(port), *STORED, "--query", q0, "--device", "cpu"])
    res["port_run_s"] = time.time() - t
    passages = passages_of(port)
    by_text = sorted(p["text"] for p in passages)
    rng = np.random.default_rng(len("email"))  # phase 13's draw
    queries = [" ".join(by_text[i].split()[:12]) for i in rng.choice(len(by_text), min(64, len(by_text)),
                                                                      replace=False)]
    z = np.load(port + ".hnsw.npz")
    emb = np.array(z["embeddings"], dtype=np.float32)
    oracle = os.path.join(a.workdir, "oracle", "documents.leann")
    ob = LeannBuilder(backend_name="flat", embedding_model="hash-minilm", max_length=256, device="cpu")
    ob.build_index_from_embeddings(oracle, [p["id"] for p in passages], emb.copy(), [p["text"] for p in passages])
    truth = LeannSearcher(oracle, device="cpu").search(queries, top_k=5)
    ps = LeannSearcher(port, device="cpu")
    port_got = {c: ps.search(queries, complexity=c, **KW) for c in (64, 128, 256)}
    res["chunks"] = len(passages)
    res.update({f"port_recall_at_5_c{c}": cs._recall(g, truth, k=5) for c, g in port_got.items()})
    print(json.dumps(res), flush=True)

    sys.path.insert(0, str(REPO / "apps"))
    from apps.email_rag import EmailRAG as JaxEmailRAG
    from leann_tpu import LeannSearcher as JaxSearcher

    jax = os.path.join(a.workdir, "jax", "documents.leann")
    # the JAX app's get_event_loop() raises after the port's asyncio.run() in this thread
    asyncio.set_event_loop(asyncio.new_event_loop())
    argv, t = sys.argv, time.time()
    sys.argv = ["email_rag", "--index-dir", os.path.dirname(jax), *STORED, "--query", q0]
    try:
        JaxEmailRAG().run()
    finally:
        sys.argv = argv
    res["jax_run_s"] = time.time() - t
    res["same_passages"] = passages_of(jax) == passages
    res["stored_max_abs_diff"] = float(np.abs(np.load(jax + ".hnsw.npz")["embeddings"].astype(np.float32)
                                              - emb).max())
    js = JaxSearcher(jax)
    for c in (64, 128, 256):
        got = js.search(queries, complexity=c, **KW)
        res[f"jax_recall_at_5_c{c}"] = cs._recall(got, truth, k=5)
        res[f"port_jax_overlap_c{c}"] = cs._recall(port_got[c], got, k=5)
    print(json.dumps(res), flush=True)

    if a.orders:  # each package's graph over its stored embeddings in other row orders
        from leann_tpu import LeannBuilder as JaxBuilder

        ids = np.array([p["id"] for p in passages])
        for pkg, builder, searcher, stored, extra in (
                ("jax", JaxBuilder, JaxSearcher, jax, {}), ("port", LeannBuilder, LeannSearcher, port,
                                                            {"device": "cpu"})):
            e = np.load(stored + ".hnsw.npz")["embeddings"].astype(np.float32)
            got = []
            for seed in range(a.orders):
                perm = np.random.default_rng(seed).permutation(len(ids))
                prefix = os.path.join(a.workdir, f"{pkg}_order{seed}", "documents.leann")
                b = builder(backend_name="hnsw", embedding_model="hash-minilm", max_length=256, M=32,
                            efConstruction=128, is_compact=False, is_recompute=False, **extra)
                b.build_index_from_embeddings(prefix, list(ids[perm]), e[perm].copy())
                got.append(cs._recall(searcher(prefix, **extra).search(queries, complexity=64, **KW), truth, k=5))
            res[f"{pkg}_recall_at_5_c64_orders"] = got
            print(json.dumps(res), flush=True)

    if a.recompute_queries:
        default = os.path.join(a.workdir, "port_default", "documents.leann")
        PortEmailRAG().run(["--index-dir", os.path.dirname(default), "--llm", "simulated", "--query", q0,
                            "--device", "cpu"])
        qs = queries[: a.recompute_queries]
        got = LeannSearcher(default, device="cpu").search(qs, complexity=64, **KW)
        res["recompute_vs_stored_overlap_c64"] = cs._recall(got, port_got[64][: len(qs)], k=5)
        res["recompute_queries"] = len(qs)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
