"""The launch plan of leann_torch's top-k kernels above k = 64
(ops/tile_plan.py, CPU): the buffered lists' scratch, the column splits at
the main path's shapes (B1's 64 queries x 100K, B2's builds at 14,937,
20,000, 47,368 and 100K rows), the k bound between instances, the scratch
the wrappers allocate, and the constants the kernel's source shares with the
planner."""

import re
from pathlib import Path

import pytest
import torch

from leann_torch.ops import tile_plan as tp

_CORE = Path(tp.__file__).resolve().parent.parent / "csrc" / "topk_common.cuh"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpp_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _CORE.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("k,k2", [(65, 128), (96, 128), (128, 128), (129, 256), (200, 256), (256, 256),
                                  (257, 512), (512, 512), (513, 1024), (3000, 4096)])
def test_list_length_is_the_power_of_two_at_or_above_k(k, k2):
    assert tp.list_len(k) == k2


@pytest.mark.parametrize("k", [1, 3, 16, 63, 64])
def test_up_to_64_the_lists_stay_in_registers(k):
    # no list scratch: the lists live in registers
    plan = tp.plan_launch(100_000, 100_000, k, 384, 132)
    assert plan.row_blocks == 782
    assert tp.list_entries(plan, 100_000, k) == 0 and tp.merge_entries(64, k) == 0


@pytest.mark.parametrize("k", [65, 96, 128, 129, 200, 256, 257, 512, 1000, 4096])
def test_above_64_every_k_takes_a_buffered_instance(k):
    # one buffered instance, its lists in a [rows, splits, k2] scratch in
    # device memory; it takes 128 query rows a block like the others
    plan = tp.plan_launch(100_000, 100_000, k, 384, 132)
    assert (plan.row_blocks, plan.col_splits) == (782, 1)
    assert tp.list_entries(plan, 100_000, k) == 100_000 * tp.list_len(k)


@pytest.mark.parametrize("k", [65, 128, 256, 257, 512])
def test_b1_fills_the_card_with_splits_no_narrower_than_k(k):
    # the flat oracle's 64 queries against 100K rows: one row block and one
    # wave of column splits, each at least k columns wide
    plan = tp.plan_launch(64, 100_000, k, 384, 132)
    assert (plan.row_blocks, plan.col_splits) == (1, 132)
    lo, hi = tp.split_columns(100_000, plan.col_splits, 0)
    assert hi - lo >= k


@pytest.mark.parametrize("k,splits", [(1000, 97), (3000, 32), (4096, 24)])
def test_b1_at_a_large_top_k_takes_fewer_splits(k, splits):
    plan = tp.plan_launch(64, 100_000, k, 384, 132)
    assert plan.col_splits == splits
    assert all(hi - lo >= k for lo, hi in (tp.split_columns(100_000, splits, s) for s in range(splits)))


@pytest.mark.parametrize("rows", [14_937, 20_000, 47_368, 100_000])
@pytest.mark.parametrize("k", [128, 512])
def test_b2_builds_run_unsplit(rows, k):
    # the apps' (14,937 email chunks), the sharded entry's (20,000), the
    # CLI's (47,368) and phase 3's (100K) hnsw builds at C = 128 (and 512):
    # row blocks alone, no merge launch
    plan = tp.plan_launch(rows, rows, k, 384, 132)
    assert plan.col_splits == 1
    assert plan.row_blocks == -(-rows // tp.BLOCK_ROWS)
    assert tp.merge_entries(rows, k) == 0  # the merge's lists fit shared memory up to k2 = 2048


@pytest.mark.parametrize("k", [65, 513])
def test_exact_knn_rows_splits_its_chunk(k):
    # exact_knn_rows' 1,024 sampled rows against a 262,144-row column slab
    plan = tp.plan_launch(1024, 262_144, k, 384, 132)
    assert (plan.row_blocks, plan.col_splits) == (8, 16)


@pytest.mark.parametrize("k", [65, 128, 257, 512, 3000])
def test_scratch_the_wrappers_allocate(k):
    plan = tp.plan_launch(64, 100_000, k, 384, 132)
    assert tp.list_entries(plan, 64, k) == 64 * plan.col_splits * tp.list_len(k)
    assert tp.merge_entries(64, k) == (64 * tp.MERGE_WARPS * tp.list_len(k) if tp.list_len(k) > 2048 else 0)
    v, i = tp.scratch(tp.merge_entries(64, k), "cpu")
    assert (v is None) == (tp.merge_entries(64, k) == 0)
    if v is not None:
        assert v.dtype == torch.float32 and i.dtype == torch.int32 and v.numel() == i.numel()


def test_planner_and_kernel_share_their_constants():
    assert _cpp_int("kRegMaxK") == tp.REG_MAX_K
    assert _cpp_int("kMinListLen") == tp.MIN_LIST_LEN
    assert _cpp_int("kMergeSmemMaxK2") == tp.MERGE_SMEM_MAX_K2
    assert _cpp_int("kBM") == tp.BLOCK_ROWS and _cpp_int("kBN") == tp.TILE_COLS
    src = _CORE.read_text()
    assert re.search(r"kMergeWarps = kMergeThreads / 32", src) and _cpp_int("kMergeThreads") // 32 == tp.MERGE_WARPS


def test_the_per_candidate_inserts_are_gone():
    # one list design above k = 64: the buffered select, with one flush
    # routine for the tile kernel's lists and the merges'
    src = _CORE.read_text()
    for gone in ("slist_insert", "glist_insert", "SmemRows", "GmemRows", "topk_merge_wide", "topk_merge_gmem"):
        assert gone not in src
    assert len(re.findall(r"__device__ __forceinline__ void fold_buffer\(", src)) == 1
