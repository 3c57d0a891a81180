"""Repack an existing index into the compact v2 storage format, and undo a
locality relabel.

Counterpart of the JAX package's ``repack.py``, on the same on-disk index:

  * :func:`repack_index` packs raw neighbor rows (sorted-delta deflate),
    moves an l2 / cosine entry pool to its derivable sidecar, collapses
    sequential id lists, turns step-function partition assignments into
    counts and moves legacy token stores to their ``.cache.`` names. Search
    results are unchanged: neighbor rows are sets to every consumer.
  * :func:`relabel_index` renumbers the rows of a single-partition index in
    a given order and permutes every per-row artifact with them (graph rows
    and values, codes, embeddings, entries, medoid, ids in the ``perm``
    format, token caches). Deriving a locality order from the geometry
    (``order=None``) is not ported: it rests on the k-means that ROADMAP.md
    lists under "Not to port", and it measured as a net loss.
  * :func:`unrelabel_index` puts a relabeled index back in the order its
    stored id permutation gives.

CLI: ``python -m leann_torch.repack <prefix> [--unrelabel]``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import numpy as np

from .backends.common import not_ported
from .storage import (
    index_all_in_bytes,
    load_ids,
    load_partition,
    pack_neighbors,
    save_ids,
    save_partition,
    token_cache_paths,
    unpack_neighbors,
)

logger = logging.getLogger(__name__)


def repack_index(prefix: str) -> dict:
    """Repack all artifacts of ``prefix`` in place -> {"before_bytes",
    "after_bytes", "steps": [...]}."""
    before = index_all_in_bytes(prefix)
    steps = []

    # backend npz: pack raw neighbor rows; an l2 / cosine entry pool goes to
    # its derivable sidecar (mips pools live in the augmented build space
    # and stay in the npz)
    for backend in ("diskann", "hnsw"):
        path = f"{prefix}.{backend}.npz"
        if not os.path.exists(path):
            continue
        z = dict(np.load(path, allow_pickle=False))
        changed = False
        if "neighbors" in z:
            nbr = z.pop("neighbors")
            z.update(pack_neighbors(np.asarray(nbr)))
            changed = True
            steps.append(f"{backend}: packed neighbors {nbr.shape}")
        if "entry_emb" in z and str(z.get("metric", "")) in ("l2", "cosine"):
            ee = np.asarray(z.pop("entry_emb"), np.float16)
            np.save(f"{prefix}.entries.cache.npy", ee)
            changed = True
            steps.append(f"{backend}: entry pool {ee.shape} -> derivable cache")
        if changed:
            tmp = path + ".tmp.npz"  # savez appends .npz to bare names
            np.savez(tmp, **z)
            os.replace(tmp, path)

    ids_path = f"{prefix}.ids.json"
    if os.path.exists(ids_path):
        with open(ids_path) as f:
            data = json.load(f)
        if isinstance(data, list):
            save_ids(prefix, data)
            steps.append(f"ids: {len(data)} entries -> {'seq' if load_ids(prefix) == data else 'list'}")

    part_npy = f"{prefix}.partition.npy"
    if os.path.exists(part_npy):
        assign = np.load(part_npy)
        save_partition(prefix, assign)  # removes the .npy when counts suffice
        if not os.path.exists(part_npy):
            steps.append(f"partition: {assign.shape[0]} rows -> counts")

    # legacy token store -> cache name (same bytes, outside the accounting)
    p = token_cache_paths(prefix)
    for src, dst in ((p["legacy_raw"], p["raw"]), (p["legacy_raw_len"], p["raw_len"]),
                     (p["legacy_npz"], p["npz"])):
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.move(src, dst)
            steps.append(f"tokens: {os.path.basename(src)} -> cache")

    after = index_all_in_bytes(prefix)
    logger.info("repacked %s: %.1f -> %.1f MB (%s)", prefix, before / 1e6, after / 1e6,
                "; ".join(steps) or "nothing to do")
    return {"before_bytes": before, "after_bytes": after, "steps": steps}


def edge_locality(neighbors: np.ndarray, window: int = 1 << 16) -> float:
    """Fraction of real edges whose |dst - src| < window: the quantity the
    sorted-delta packer's size tracks."""
    n = neighbors.shape[0]
    src = np.repeat(np.arange(n, dtype=np.int64), neighbors.shape[1])
    dst = neighbors.reshape(-1).astype(np.int64)
    valid = dst >= 0
    if not valid.any():
        return 0.0
    return float((np.abs(dst[valid] - src[valid]) < window).mean())


def relabel_index(prefix: str, n_cells: int = 0, order: "np.ndarray | None" = None) -> dict:
    """Renumber the rows of a single-partition index in place: new row j
    holds old row ``order[j]``. Permutes every per-row artifact (graph rows
    and values, codes, embeddings, entries, medoid, token caches) and stores
    the id permutation in the ``perm`` format; search results are the same
    up to the id mapping, which the searcher resolves through the ids list.
    ``order=None`` (a locality order from the geometry, ``n_cells`` cells)
    is not ported and raises."""
    if order is None:
        raise not_ported("relabel_index(order=None), the locality order from _kmeans_full",
                         "ROADMAP.md, Not to port: _kmeans_full and the locality relabel")
    path = backend = None
    for b in ("diskann", "hnsw"):
        cand = f"{prefix}.{b}.npz"
        if os.path.exists(cand):
            path, backend = cand, b
            break
    if path is None:
        raise FileNotFoundError(f"no backend npz for {prefix}")
    z = dict(np.load(path, allow_pickle=False))
    nbr = unpack_neighbors(z)
    n = nbr.shape[0]
    part = load_partition(prefix, n)
    if part is not None and part.size and int(part.max()) > 0:
        raise ValueError(
            "relabel would break the LDG partition-contiguity relayout of a "
            "multi-partition index; re-run the build with relabeling instead")
    before = index_all_in_bytes(prefix)
    loc_before = edge_locality(nbr)
    order = np.asarray(order, np.int64)
    if order.shape != (n,):
        raise ValueError(f"explicit order has shape {order.shape}, want ({n},)")
    if np.array_equal(order, np.arange(n)):
        return {"before_bytes": before, "after_bytes": before,
                "steps": ["relabel: corpus too small, identity order"]}
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)

    nbr2 = np.where(nbr >= 0, new_of_old[np.clip(nbr, 0, n - 1)], -1)[order].astype(np.int32)
    for k in ("neighbors", "neighbors_packed", "neighbors_n", "neighbors_r"):
        z.pop(k, None)
    z.update(pack_neighbors(nbr2))
    if "codes" in z:
        z["codes"] = np.asarray(z["codes"])[order]
    if "embeddings" in z:
        z["embeddings"] = np.asarray(z["embeddings"])[order]
    if "entries" in z:  # entry_emb rows stay aligned: same nodes, same positions
        z["entries"] = new_of_old[np.asarray(z["entries"])].astype(np.int32)
    if "medoid" in z:
        z["medoid"] = np.int32(new_of_old[int(z["medoid"])])
    tmp = path + ".tmp.npz"
    np.savez(tmp, **z)
    os.replace(tmp, path)

    old_ids = load_ids(prefix)
    if old_ids:
        save_ids(prefix, [old_ids[int(i)] for i in order])

    # token caches in the new row order (a raw store block by block)
    p = token_cache_paths(prefix)
    if os.path.exists(p["raw"]):
        tok = np.load(p["raw"], mmap_mode="r")
        out = np.lib.format.open_memmap(p["raw"] + ".tmp", mode="w+", dtype=tok.dtype, shape=tok.shape)
        step = 1 << 19
        for s in range(0, n, step):
            out[s : s + step] = tok[order[s : s + step]]
        out.flush()
        del out, tok
        os.replace(p["raw"] + ".tmp", p["raw"])
        np.save(p["raw_len"], np.load(p["raw_len"])[order])
    elif os.path.exists(p["npz"]):
        zc = np.load(p["npz"])
        np.savez_compressed(p["npz"], tokens=zc["tokens"][order], lengths=zc["lengths"][order])

    after = index_all_in_bytes(prefix)
    loc_after = edge_locality(nbr2)
    rep = {"before_bytes": before, "after_bytes": after,
           "edge_locality_64k": {"before": round(loc_before, 4), "after": round(loc_after, 4)},
           "steps": [f"{backend}: locality relabel, {n} rows"]}
    logger.info("relabel %s: %.1f -> %.1f MB, locality %.3f -> %.3f", prefix,
                before / 1e6, after / 1e6, loc_before, loc_after)
    return rep


def unrelabel_index(prefix: str) -> dict:
    """Invert a relabel through the stored id permutation (ids.perm.npy):
    every artifact goes back to the original row order, the ids become
    sequential again and the perm sidecar goes."""
    perm_path = f"{prefix}.ids.perm.npy"
    if not os.path.exists(perm_path):
        raise FileNotFoundError(f"no {perm_path}: index is not relabeled")
    perm = np.load(perm_path).astype(np.int64)  # ids[j] == str(perm[j])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return relabel_index(prefix, order=inv)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("prefix", help="index prefix (path up to .leann)")
    ap.add_argument("--unrelabel", action="store_true",
                    help="invert a previous relabel through the stored id permutation")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rep = repack_index(args.prefix)
    if args.unrelabel:
        rep2 = unrelabel_index(args.prefix)
        rep = {"before_bytes": rep["before_bytes"], "after_bytes": rep2["after_bytes"],
               "edge_locality_64k": rep2.get("edge_locality_64k"), "steps": rep["steps"] + rep2["steps"]}
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
