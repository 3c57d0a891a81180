"""``leann`` command-line interface of the port: ``python -m leann_torch.cli``.

Counterpart of the JAX package's ``cli.py``, with the same subcommands,
options, defaults and index layout. Subcommand parity with the reference CLI
(cli.py:74-292):

  build <name> --docs DIR...   chunk + embed + build an index
  search <name> <query>        search an index
  ask <name>                   RAG chat (ollama/openai/gemini/hf/simulated)
  list                         list indexes across registered projects
  remove <name>                delete an index (interactive unless --force)
  repack <name>                repack an index into the compact v2 format

Every subcommand takes ``--device`` (default ``cuda``), checked before any
work: the builder, searcher and chat run there, and without CUDA a command
exits non-zero unless it is given ``--device cpu``. ``repack --relabel``
runs the locality relabel's k-means there too.

Index layout parity (cli.py:48-67): ``.leann/indexes/<name>/documents.leann``
inside the current project, the JAX package's layout, so either package's
CLI finds the other's index in the current directory by name. ``list``,
``search`` and the rest also find indexes through the port's own registry
(``~/.leann_torch/projects.json``, or ``$LEANN_HOME``; the JAX package keeps
``~/.leann_tpu``). The builders of both packages record each index's own
directory there; the JAX package's CLI never looks inside such an entry,
so its ``list`` finds nothing outside the project. The port's CLI reads
it, and so finds, under a shared ``$LEANN_HOME``, the JAX package's builds
as well.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from typing import List, Optional

logger = logging.getLogger(__name__)

INDEX_DIR_NAME = ".leann"


def index_prefix(project_dir: str, name: str) -> str:
    return os.path.join(project_dir, INDEX_DIR_NAME, "indexes", name, "documents.leann")


def _registered_candidates(d: str, name: str) -> List[str]:
    """Where index ``name`` may sit under a registered directory ``d``: a
    project (``.leann/indexes/<name>``), a parent of index directories, or
    the index's own directory, which is what the builders record."""
    cands = [index_prefix(d, name), os.path.join(d, name, "documents.leann")]
    if os.path.basename(os.path.normpath(d)) == name:
        cands.append(os.path.join(d, "documents.leann"))
    return cands


def find_index(name: str) -> Optional[str]:
    """Current project first, then registered projects."""
    from .registry import load_project_directories

    local = index_prefix(os.getcwd(), name)
    if os.path.exists(local + ".meta.json"):
        return local
    for d in load_project_directories():
        for cand in _registered_candidates(d, name):
            if os.path.exists(cand + ".meta.json"):
                return cand
    return None


def _all_indexes() -> List[dict]:
    import json

    from .registry import load_project_directories

    seen = set()
    found = []
    roots = [os.getcwd()] + load_project_directories()
    for root in roots:
        cands = []
        for base in (os.path.join(root, INDEX_DIR_NAME, "indexes"), root):
            if os.path.isdir(base):
                cands += [(child, os.path.join(base, child, "documents.leann")) for child in sorted(os.listdir(base))]
        cands.append((os.path.basename(os.path.normpath(root)), os.path.join(root, "documents.leann")))
        for name, prefix in cands:
            meta = prefix + ".meta.json"
            key = os.path.realpath(prefix)
            if os.path.exists(meta) and key not in seen:
                seen.add(key)
                with open(meta) as f:
                    m = json.load(f)
                found.append({"name": name, "prefix": prefix, "meta": m})
    return found


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m leann_torch.cli",
                                description="Low-storage vector index + RAG on an NVIDIA GPU (PyTorch/CUDA)")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="the device of the builder, searcher and chat (default cuda; without CUDA "
                          "every command exits non-zero unless given --device cpu)")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="build an index from documents", parents=[dev])
    b.add_argument("index_name")
    b.add_argument("--docs", nargs="+", required=True, help="files or directories to index")
    b.add_argument("--backend", default="hnsw", choices=["hnsw", "diskann", "flat"])
    b.add_argument("--embedding-model", default="hash-minilm")
    b.add_argument("--embedding-mode", default="tpu",
                   choices=["tpu", "sentence-transformers", "openai", "ollama", "gemini", "mlx", "simulated"])
    b.add_argument("--force", "-f", action="store_true", help="rebuild even if the index exists")
    # chunking knobs (doc + code; cli.py:53-55)
    b.add_argument("--doc-chunk-size", type=int, default=256)
    b.add_argument("--doc-chunk-overlap", type=int, default=128)
    b.add_argument("--code-chunk-size", type=int, default=512)
    b.add_argument("--code-chunk-overlap", type=int, default=64)
    b.add_argument("--use-ast-chunking", action="store_true")
    b.add_argument("--ast-chunk-size", type=int, default=0,
                   help="AST chunk size (0 = use --code-chunk-size)")
    b.add_argument("--ast-chunk-overlap", type=int, default=-1,
                   help="AST chunk overlap (-1 = use --code-chunk-overlap)")
    b.add_argument("--ast-fallback-traditional", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fall back to traditional chunking when AST parse fails "
                        "(--no-ast-fallback-traditional raises instead)")
    b.add_argument("--file-types", nargs="+", default=None)
    b.add_argument("--include-hidden", action="store_true")
    b.add_argument("--no-gitignore", action="store_true")
    b.add_argument("--max-file-size-mb", type=float, default=10.0)
    b.add_argument("--max-items", type=int, default=-1)
    # index knobs
    b.add_argument("--graph-degree", "-M", type=int, default=32)
    b.add_argument("--complexity", type=int, default=128, help="build candidate budget (efConstruction)")
    b.add_argument("--distance-metric", default=None, choices=[None, "l2", "mips", "cosine"])
    b.add_argument("--compact", action=argparse.BooleanOptionalAction, default=True,
                   help="prune the embedding matrix (graph+text only)")
    b.add_argument("--recompute", action=argparse.BooleanOptionalAction, default=True,
                   help="recompute embeddings at query time")
    b.add_argument("--max-length", type=int, default=256, help="token cap per chunk")
    b.add_argument("--num-threads", type=int, default=0)
    b.add_argument("--build-checkpoint-dir", default="",
                   help="persist build phases (KNN, prune) here and resume a "
                        "killed multi-hour build at the last finished phase")
    b.add_argument("--reverse-candidates", type=int, default=0,
                   help="feed the prune up to this many reverse-KNN candidates "
                        "per node (bidirectional-edge quality lever for "
                        "spill-KNN builds at 10M+ chunks)")

    s = sub.add_parser("search", help="search an index", parents=[dev])
    s.add_argument("index_name")
    s.add_argument("query")
    s.add_argument("--top-k", type=int, default=5)
    s.add_argument("--complexity", type=int, default=64)
    s.add_argument("--beam-width", type=int, default=8)
    # default None = backend auto (hnsw applies the PQ screen when unpruned
    # recompute would cold-compile for >15 min); pass 0.0 for truly unpruned
    s.add_argument("--prune-ratio", type=float, default=None)
    s.add_argument("--recompute-embeddings", action=argparse.BooleanOptionalAction, default=None)
    s.add_argument("--pruning-strategy", default="global", choices=["global", "local", "proportional"])
    s.add_argument("--adaptive-steps", type=int, default=0,
                   help="two-phase batched search: first-pass step cap (0 = off; keep pow2)")
    s.add_argument("--token-residency", default="auto", choices=["auto", "device", "host"],
                   help="diskann token store placement (host = beyond-HBM deferred rerank)")
    s.add_argument("--non-interactive", action="store_true", help="plain stdout (for MCP/scripts)")

    a = sub.add_parser("ask", help="RAG chat over an index", parents=[dev])
    a.add_argument("index_name")
    a.add_argument("query", nargs="?", default=None, help="single question (omit for interactive)")
    a.add_argument("--llm", default="simulated", choices=["ollama", "openai", "gemini", "hf", "simulated"])
    a.add_argument("--model", default=None)
    a.add_argument("--host", default="http://localhost:11434")
    a.add_argument("--top-k", type=int, default=5)
    a.add_argument("--complexity", type=int, default=64)
    a.add_argument("--thinking-budget", default=None, choices=[None, "low", "medium", "high"])
    a.add_argument("--interactive", "-i", action="store_true")

    sub.add_parser("list", help="list indexes across registered projects", parents=[dev])

    r = sub.add_parser("remove", help="remove an index", parents=[dev])
    r.add_argument("index_name")
    r.add_argument("--force", "-f", action="store_true")

    rp = sub.add_parser("repack", help="repack an index into the compact v2 storage format", parents=[dev])
    rp.add_argument("index_name", help="index name or a literal path prefix ending in .leann")
    rp.add_argument("--relabel", action="store_true",
                    help="locality-relabel node ids after repacking (shrinks the packed graph where "
                         "neighbors cluster; single-partition indexes only; k-means on --device)")
    rp.add_argument("--cells", type=int, default=0,
                    help="relabel cell count (0 = auto)")
    return p


def cmd_build(args) -> int:
    from .api import LeannBuilder
    from .chunking import create_text_chunks
    from .loaders import load_documents

    prefix = index_prefix(os.getcwd(), args.index_name)
    if os.path.exists(prefix + ".meta.json") and not args.force:
        print(f"Index '{args.index_name}' already exists; use --force to rebuild.")
        return 0
    docs = []
    for d in args.docs:
        docs.extend(load_documents(
            d, file_types=args.file_types, include_hidden=args.include_hidden,
            use_gitignore=not args.no_gitignore, max_file_size_mb=args.max_file_size_mb,
            max_items=args.max_items,
        ))
    if not docs:
        print("No documents found.", file=sys.stderr)
        return 1
    chunks = create_text_chunks(
        docs, chunk_size=args.doc_chunk_size, chunk_overlap=args.doc_chunk_overlap,
        use_ast_chunking=args.use_ast_chunking,
        ast_chunk_size=args.ast_chunk_size or args.code_chunk_size,
        ast_chunk_overlap=(args.ast_chunk_overlap if args.ast_chunk_overlap >= 0
                           else args.code_chunk_overlap),
        ast_fallback_traditional=args.ast_fallback_traditional,
    )
    print(f"Loaded {len(docs)} documents -> {len(chunks)} chunks")
    bk = {}
    if args.backend == "hnsw":
        bk = {"M": args.graph_degree, "efConstruction": args.complexity}
    elif args.backend == "diskann":
        bk = {"graph_degree": args.graph_degree, "complexity": args.complexity}
    builder = LeannBuilder(
        backend_name=args.backend,
        embedding_model=args.embedding_model,
        embedding_mode=args.embedding_mode,
        distance_metric=args.distance_metric,
        is_compact=args.compact,
        is_recompute=args.recompute,
        max_length=args.max_length,
        build_checkpoint_dir=args.build_checkpoint_dir,
        reverse_candidates=args.reverse_candidates,
        device=args.device,
        **bk,
    )
    for c in chunks:
        builder.add_text(c["text"], metadata=c.get("metadata", {}))
    builder.build_index(prefix)
    print(f"Built index '{args.index_name}' at {prefix} ({len(chunks)} chunks)")
    return 0


def cmd_search(args) -> int:
    from .api import LeannSearcher

    prefix = find_index(args.index_name)
    if prefix is None:
        print(f"Index '{args.index_name}' not found. Try 'leann list'.", file=sys.stderr)
        return 1
    with LeannSearcher(prefix, token_residency=args.token_residency, device=args.device) as s:
        results = s.search(
            args.query, top_k=args.top_k, complexity=args.complexity, beam_width=args.beam_width,
            prune_ratio=args.prune_ratio, recompute_embeddings=args.recompute_embeddings,
            pruning_strategy=args.pruning_strategy, adaptive_steps=args.adaptive_steps,
        )
    for i, r in enumerate(results):
        if args.non_interactive:
            print(f"[{i + 1}] (score {r.score:.4f}) {r.text}")
        else:
            src = r.metadata.get("file_name", r.id)
            print(f"\033[36m[{i + 1}]\033[0m score={r.score:.4f} source={src}\n    {r.text[:300]}")
    return 0


def cmd_ask(args) -> int:
    from .api import LeannChat

    prefix = find_index(args.index_name)
    if prefix is None:
        print(f"Index '{args.index_name}' not found.", file=sys.stderr)
        return 1
    llm_config = {"type": args.llm, "model": args.model, "host": args.host,
                  "thinking_budget": args.thinking_budget}
    chat = LeannChat(prefix, llm_config=llm_config, device=args.device)
    if args.interactive or args.query is None:
        chat.start_interactive()
    else:
        print(chat.ask(args.query, top_k=args.top_k, complexity=args.complexity))
    chat.cleanup()
    return 0


def cmd_list(args) -> int:
    items = _all_indexes()
    if not items:
        print("No indexes found.")
        return 0
    for it in items:
        m = it["meta"]
        print(f"{it['name']:24s} backend={m['backend_name']:8s} chunks={m.get('num_chunks', '?'):<8} "
              f"model={m.get('embedding_model')} ({it['prefix']})")
    return 0


def cmd_remove(args) -> int:
    prefix = find_index(args.index_name)
    if prefix is None:
        print(f"Index '{args.index_name}' not found.", file=sys.stderr)
        return 1
    index_dir = os.path.dirname(prefix)
    if not args.force:
        resp = input(f"Remove index at {index_dir}? [y/N] ").strip().lower()
        if resp != "y":
            print("Aborted.")
            return 1
    shutil.rmtree(index_dir)
    print(f"Removed {index_dir}")
    return 0


def cmd_repack(args) -> int:
    from .repack import repack_index

    prefix = args.index_name if args.index_name.endswith(".leann") else find_index(args.index_name)
    if prefix is None or not os.path.exists(f"{prefix}.meta.json"):
        print(f"Index '{args.index_name}' not found.", file=sys.stderr)
        return 1
    rep = repack_index(prefix)
    if getattr(args, "relabel", False):
        from .repack import relabel_index

        try:
            rep2 = relabel_index(prefix, n_cells=args.cells, device=args.device)
        except ValueError as e:  # a multi-partition index, or one without geometry
            print(f"error: {e}", file=sys.stderr)
            return 1
        rep = {"before_bytes": rep["before_bytes"],
               "after_bytes": rep2["after_bytes"],
               "steps": rep["steps"] + rep2["steps"]}
    print(f"{rep['before_bytes'] / 1e6:.1f} -> {rep['after_bytes'] / 1e6:.1f} MB "
          f"({len(rep['steps'])} artifacts repacked)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=os.environ.get("LEANN_LOG_LEVEL", "WARNING"))
    args = build_parser().parse_args(argv)
    from .device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    handlers = {"build": cmd_build, "search": cmd_search, "ask": cmd_ask,
                "list": cmd_list, "remove": cmd_remove, "repack": cmd_repack}
    return handlers[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
