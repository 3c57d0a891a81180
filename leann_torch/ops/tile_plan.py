"""Launch plan of the two top-k kernels (``csrc/topk_common.cuh``).

Both kernels run one core: a block takes 128 query rows (64 per consumer
warpgroup) and a range of corpus columns, walks the range in 128-column
tiles whose 64-feature boxes a producer warp streams by TMA into a ring of
shared-memory stages, and keeps each row's running top-k in registers.
Above k = 64 the lists move to shared memory and a block takes 64 query
rows (one consumer warpgroup); above k = 256 they move to device memory
(the block's slice of its output) and the block takes 128 rows again. The
block's shared memory is fixed at compile time per instance, whatever D and
k (``kSmemBytes`` and ``kWideSmemBytes``, held to the card's limit by
``static_assert``s there). No k is refused but k < 1.
This module decides the grid with pure functions, so the CPU tests reach it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

BLOCK_ROWS = 128     # query rows per block: one wgmma M of 64 per consumer warpgroup
WIDE_BLOCK_ROWS = 64  # REG_MAX_K < k <= SMEM_MAX_K: one consumer warpgroup, lists in shared memory
TILE_COLS = 128      # corpus rows per tile (one wgmma N)
REG_MAX_K = 64       # lists in registers: two slots per lane of a warp
SMEM_MAX_K = 256     # lists in shared memory; above, in device memory (128-row blocks)


@dataclass(frozen=True)
class LaunchPlan:
    row_blocks: int  # blocks along the query rows (grid.y)
    col_splits: int  # blocks along the corpus columns (grid.x); > 1 adds a merge launch
    block_rows: int = BLOCK_ROWS  # query rows per block


def block_rows(k: int) -> int:
    """Query rows per block of the instance that serves ``k``."""
    return WIDE_BLOCK_ROWS if REG_MAX_K < k <= SMEM_MAX_K else BLOCK_ROWS


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


def _col_splits(row_blocks: int, n_tiles: int, sms: int) -> int:
    """Split the columns only when the row blocks leave the card short of
    work (fewer than 2 x SMs), and then into one wave of blocks: every
    split refills its lists from empty, so more splits cost more inserts.
    At least two tiles per split."""
    if row_blocks >= 2 * sms:
        return 1
    return max(1, min(n_tiles // 2, sms // row_blocks))


@lru_cache(maxsize=256)
def plan_launch(rows: int, n_cols: int, k: int, d: int, sms: int) -> LaunchPlan:
    """rows query rows against corpus columns [0, n_cols), top-k over d
    features (a multiple of 16) on a card with ``sms`` multiprocessors."""
    if rows < 1 or n_cols < 0 or sms < 1:
        raise ValueError(f"plan_launch: rows={rows}, n_cols={n_cols}, sms={sms}")
    check_k(k, "plan_launch")
    if d < 1 or d % 16:
        raise ValueError(f"plan_launch: D={d} must be a positive multiple of 16")
    bm = block_rows(k)
    row_blocks = -(-rows // bm)
    n_tiles = max(1, -(-n_cols // TILE_COLS))
    return LaunchPlan(row_blocks, _col_splits(row_blocks, n_tiles, sms), bm)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def multiprocessors(device) -> int:
    """SM count of a CUDA device, read once per device."""
    dev = torch.device(device)
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
