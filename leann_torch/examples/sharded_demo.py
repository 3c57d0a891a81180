"""The mesh demo on leann_torch (the JAX package's ``examples/sharded_demo.py``):
builds a graph over a book's paragraphs with the gp-mesh build, shards the
graph, PQ codes and token rows over the mesh, and runs the distributed
recompute search.

    python -m leann_torch.examples.sharded_demo --book BOOK.txt [--shards 4] [--device cuda]

``--shards`` 0 (the default) puts one shard on each card; N lays N shards
over the cards, several to a card where there are fewer (or N shards of the
CPU with ``--device cpu``). The book is a plain-text file, such as Project
Gutenberg's Pride and Prejudice; without it the demo exits with a message.
"""

import argparse
import os
from typing import List, Optional

import numpy as np

from leann_torch.device import resolve_device
from leann_torch.embeddings.encoder import get_encoder
from leann_torch.examples.basic_demo import NO_BOOK
from leann_torch.ops.beam_search import BeamConfig
from leann_torch.ops.pq import encode_pq_blocked, train_pq
from leann_torch.parallel.mesh import graph_mesh, shard_devices
from leann_torch.parallel.sharded_build import sharded_build_graph
from leann_torch.parallel.sharded_search import ShardedSearcher


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="sharded build and distributed recompute search over a book")
    ap.add_argument("--book", default=None, help="a plain-text book (paragraphs split by blank lines)")
    ap.add_argument("--shards", type=int, default=0, help="gp shards (default 0: one per card)")
    ap.add_argument("--device", default="cuda",
                    help="default cuda; without CUDA the demo exits unless given --device cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    if not args.book or not os.path.isfile(args.book):
        raise SystemExit("error: " + NO_BOOK.format(path=args.book))
    mesh = graph_mesh(devices=shard_devices(dev, args.shards))
    print(f"mesh: {mesh}")
    text = open(args.book, encoding="utf-8").read()
    paras = [p.strip().replace("\n", " ") for p in text.split("\n\n") if len(p.strip()) > 120][:400]

    enc = get_encoder("hash-minilm", max_length=128, device=dev)
    emb = enc.encode(paras)
    toks, mask = enc.tokenize(paras, 128)
    lengths = mask.sum(axis=1).astype(np.int32)
    graph, _ = sharded_build_graph(emb, mesh, r=16)
    cb = train_pq(emb, device=dev)
    codes = encode_pq_blocked(emb, cb, device=dev)

    searcher = ShardedSearcher(mesh, graph, entries=np.arange(0, len(paras), 4, dtype=np.int32),
                               tokens=toks, lengths=lengths, codes=codes, codebooks=cb)
    cfg = BeamConfig(metric="cosine", k=3, complexity=32, beam=4, max_steps=32, traversal="recompute",
                     enc_cfg=enc.cfg, normalize=True)
    q = enc.encode(["What does Mr. Darcy say about pride?"])
    labels, dists = searcher.search(q, cfg, enc_params=enc.params)
    print(f"top results (distributed recompute over {mesh.size} shards):")
    for lbl, d in zip(labels[0], dists[0]):
        if lbl >= 0:
            print(f"  [{d:.3f}] {paras[lbl][:110]}")


if __name__ == "__main__":
    main()
