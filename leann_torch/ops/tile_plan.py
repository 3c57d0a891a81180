"""Launch plan of the two top-k kernels (``csrc/topk_common.cuh``).

Both kernels run one core: a block takes query rows and a range of corpus
columns, walks the range in 128-column tiles whose 64-feature boxes a
producer warp streams by TMA into a ring of shared-memory stages, and keeps
each row's running top-k.

The lists, by k (the header note of ``topk_common.cuh`` has the design):

* k <= 64: in registers, one survivor inserted at a time;
* k > 64: buffered. Each row keeps a sorted list of ``k2`` entries, the
  power of two >= k (:func:`list_len`), whose entry k - 1 is the bar, and a
  buffer in shared memory to which the epilogue appends the survivors of
  the bar in parallel; a warp folds a full buffer into the list (bitonic
  sort and merge). The lists lie in a ``[rows, splits, k2]`` scratch in
  device memory (:func:`list_entries`).

Shared memory per block, fixed by the instance (each held to the card's
227 KB by ``static_assert`` there): 133,184 B for the register instances at
every D; 198,720 B for the buffered one (4 stages, 64-entry buffers).
Every instance takes 128 query rows a block (two consumer warpgroups of
64).

What bounds a launch: the k-NN build's products (operations) at any k where
the survivors are few; the flat search's corpus read (bytes) up to k = 64,
and above it the lists that each column split fills from empty. Columns are
split only when the row blocks leave the card short of work, into one wave
of blocks, and no split is narrower than its list (:func:`split_min_tiles`).
No k is refused but k < 1. This module decides the grid with pure
functions, so the CPU tests reach it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

BLOCK_ROWS = 128     # query rows per block: one wgmma M of 64 per consumer warpgroup
TILE_COLS = 128      # corpus rows per tile (one wgmma N)
REG_MAX_K = 64       # lists in registers: two slots per lane of a warp
MIN_LIST_LEN = 128   # the shortest buffered list (k2 >= the buffers' 128 entries)
MERGE_WARPS = 8      # warps of a merge block
MERGE_SMEM_MAX_K2 = 2048  # the merge's lists in shared memory up to this k2, else in a scratch


@dataclass(frozen=True)
class LaunchPlan:
    row_blocks: int  # blocks along the query rows (grid.y)
    col_splits: int  # blocks along the corpus columns (grid.x); > 1 adds a merge launch


def list_len(k: int) -> int:
    """k2: the length of a buffered list (k > 64), the power of two >= k and
    >= ``MIN_LIST_LEN``."""
    k2 = MIN_LIST_LEN
    while k2 < k:
        k2 *= 2
    return k2


def check_k(k: int, who: str) -> None:
    """Raise where the kernels take no list of ``k`` entries: k < 1."""
    if k < 1:
        raise ValueError(f"{who}: k={k} must be at least 1")


def split_columns(n_cols: int, splits: int, split: int):
    """Columns [lo, hi) of one split: the splits share the 128-column tiles
    as evenly as whole tiles allow (the kernel's own formula)."""
    tiles = -(-n_cols // TILE_COLS)
    lo, hi = split * tiles // splits, (split + 1) * tiles // splits
    return lo * TILE_COLS, min(n_cols, hi * TILE_COLS)


def split_min_tiles(k: int) -> int:
    """Fewest tiles a column split takes: two, and above k = 64 at least k
    columns, since every split fills a list of k from empty and hands the
    merge k entries, which a narrower split would pad with empty ones."""
    return max(2, -(-k // TILE_COLS)) if k > REG_MAX_K else 2


def _col_splits(row_blocks: int, n_tiles: int, sms: int, k: int) -> int:
    """Split the columns only when the row blocks leave the card short of
    work (fewer than 2 x SMs), and then into one wave of blocks: every
    split refills its lists from empty, so more splits cost more list work
    and a longer merge. At least :func:`split_min_tiles` tiles per split."""
    if row_blocks >= 2 * sms:
        return 1
    return max(1, min(n_tiles // split_min_tiles(k), sms // row_blocks))


@lru_cache(maxsize=256)
def plan_launch(rows: int, n_cols: int, k: int, d: int, sms: int) -> LaunchPlan:
    """rows query rows against corpus columns [0, n_cols), top-k over d
    features (a multiple of 16) on a card with ``sms`` multiprocessors."""
    if rows < 1 or n_cols < 0 or sms < 1:
        raise ValueError(f"plan_launch: rows={rows}, n_cols={n_cols}, sms={sms}")
    check_k(k, "plan_launch")
    if d < 1 or d % 16:
        raise ValueError(f"plan_launch: D={d} must be a positive multiple of 16")
    row_blocks = -(-rows // BLOCK_ROWS)
    n_tiles = max(1, -(-n_cols // TILE_COLS))
    return LaunchPlan(row_blocks, _col_splits(row_blocks, n_tiles, sms, k))


def list_entries(plan: LaunchPlan, rows: int, k: int) -> int:
    """Entries of the [rows, splits, k2] list scratch a launch at k > 64
    needs (its lists are buffered), else 0."""
    return rows * plan.col_splits * list_len(k) if k > REG_MAX_K else 0


def merge_entries(rows: int, k: int) -> int:
    """Entries of the [rows, MERGE_WARPS, k2] scratch the merge of ``rows``
    rows needs: its lists outgrow shared memory above ``MERGE_SMEM_MAX_K2``."""
    if k <= REG_MAX_K or list_len(k) <= MERGE_SMEM_MAX_K2:
        return 0
    return rows * MERGE_WARPS * list_len(k)


def scratch(entries: int, dev):
    """(values f32, ids i32) of ``entries`` entries on ``dev``, or (None,
    None) for none: what the kernels write and read there needs no
    initial value."""
    if entries == 0:
        return None, None
    return (torch.empty((entries,), dtype=torch.float32, device=dev),
            torch.empty((entries,), dtype=torch.int32, device=dev))


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def multiprocessors(device) -> int:
    """SM count of a CUDA device, read once per device."""
    dev = torch.device(device)
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
