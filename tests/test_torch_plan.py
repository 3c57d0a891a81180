"""Launch plan of leann_torch's two top-k kernels (ops/tile_plan.py): the
grid covers every query row and every corpus column once, fills the card
where the columns allow, and no width or k the port supports is refused."""

import math
import re
from pathlib import Path

import pytest

from leann_torch.ops import tile_plan as tp


def _ranges(plan, n_cols):
    return [tp.split_columns(n_cols, plan.col_splits, s) for s in range(plan.col_splits)]


@pytest.mark.parametrize("k", [64, 65, 128, 256, 257, 512, 4096])
@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("rows,n_cols", [(1, 5000), (64, 100_000), (65, 4900), (130, 4999), (1000, 2900),
                                         (1024, 99_000), (17_000, 100_000), (100_000, 100_000), (3, 100),
                                         (5, 0)])
def test_plan_covers_rows_and_columns_once(rows, n_cols, sms, k):
    plan = tp.plan_launch(rows, n_cols, k, 384, sms)
    assert plan.block_rows == (tp.WIDE_BLOCK_ROWS if 64 < k <= 256 else tp.BLOCK_ROWS)
    assert (plan.row_blocks - 1) * plan.block_rows < rows <= plan.row_blocks * plan.block_rows
    assert all(lo % tp.TILE_COLS == 0 for lo, _ in _ranges(plan, n_cols))  # splits start on a tile
    spans = _ranges(plan, n_cols)
    covered = [c for lo, hi in spans for c in range(lo, hi)]
    assert covered == list(range(n_cols))  # each column once, in order
    assert all(hi > lo for lo, hi in spans) or n_cols == 0  # no empty split
    n_tiles = max(1, math.ceil(n_cols / tp.TILE_COLS))
    blocks = plan.row_blocks * plan.col_splits
    if plan.row_blocks < sms and n_tiles // 2 >= sms // plan.row_blocks:
        # the card is filled by one wave: no SM left that a whole row of splits could take
        assert sms - plan.row_blocks < blocks <= sms
    if plan.col_splits > 1:
        assert blocks <= sms and n_tiles // plan.col_splits >= 2  # one wave, two tiles per split
    if plan.row_blocks >= 2 * sms:
        assert plan.col_splits == 1  # enough row blocks: no merge launch


def test_main_path_shapes():
    oracle = tp.plan_launch(64, 100_000, 3, 384, 132)  # B1: the flat oracle's batch
    assert (oracle.row_blocks, oracle.col_splits) == (1, 132)
    build = tp.plan_launch(100_000, 100_000, 64, 384, 132)  # B2: the diskann build's k-NN
    assert (build.row_blocks, build.col_splits) == (782, 1)
    # B2 at a user's few thousand chunks: one wave of splits, not more,
    # since every split refills its lists from empty
    small = tp.plan_launch(1024, 99_000, 64, 400, 132)
    assert (small.row_blocks, small.col_splits) == (8, 16)
    # B2 at the HNSW build's own call (M = 32, efConstruction = 128: C = 128):
    # 64-row blocks with lists in shared memory, enough of them for no split
    hnsw = tp.plan_launch(100_000, 100_000, 128, 384, 132)
    assert (hnsw.row_blocks, hnsw.col_splits, hnsw.block_rows) == (1563, 1, 64)


@pytest.mark.parametrize("k", [257, 512, 4096])
def test_plan_past_the_shared_memory_lists(k):
    # above k = 256 the lists live in device memory and the block takes the
    # register instances' 128 rows again: the HNSW build at M = 64,
    # efConstruction = 512 (C = 512), a flat search with top_k > 256, and a
    # column shard of the sharded k-NN
    build = tp.plan_launch(100_000, 100_000, k, 384, 132)
    assert (build.row_blocks, build.col_splits, build.block_rows) == (782, 1, 128)
    oracle = tp.plan_launch(64, 100_000, k, 384, 132)
    assert (oracle.row_blocks, oracle.col_splits) == (1, 132)
    chunk = tp.plan_launch(1024, 262_144, k, 384, 132)  # a query chunk against one column slab
    assert (chunk.row_blocks, chunk.col_splits) == (8, 16)
    assert tp.block_rows(k) == tp.BLOCK_ROWS


_CORE = Path(tp.__file__).resolve().parent.parent / "csrc" / "topk_common.cuh"


@pytest.mark.parametrize("k", [1, 2, 3, 16, 32, 63, 64, 65, 128, 256, 257, 1000])
def test_shared_memory_fits_every_width(k):
    # the block's shared memory does not depend on D or k: the ring of
    # stages (and for 64 < k <= 256 the lists at their largest k) is
    # resident, and the kernel's source holds each instance's figure to the
    # card's 227 KB at compile time; above k = 256 the lists are in device
    # memory
    src = _CORE.read_text()
    for name in ("kSmemBytes", "kWideSmemBytes"):
        assert re.search(rf"static_assert\({name} <= 227 \* 1024", src)
        assert not re.search(rf"constexpr size_t {name}\s*=[^;]*\b(d|k|kb)\b", src)
    for d in range(16, 785, 16):  # every padded width up to hash-contriever's 784 plans
        plan = tp.plan_launch(100, 5000, k, d, 132)
        assert plan.row_blocks == -(-100 // plan.block_rows) and plan.col_splits > 1


def test_plan_rejects_what_no_block_takes():
    with pytest.raises(ValueError):
        tp.plan_launch(0, 100, 3, 384, 132)
    with pytest.raises(ValueError):
        tp.plan_launch(10, 100, 0, 384, 132)  # an empty list
    with pytest.raises(ValueError):
        tp.plan_launch(10, 100, 3, 385, 132)  # features not padded to 16
