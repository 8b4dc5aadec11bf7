"""The rank-n update kernel's launch plan, on the CPU.

`kernels/rank_update/ops.py` keeps the Sigma kernel's choice of square
block tile (`rank_plan`) and its map from a block of the grid to the tile
of Sigma's upper triangle it computes (`triangle_tile`) in plain Python;
the kernel's launcher applies the same rule, and `tests/test_torch_gpu.py`
holds the launcher's choice to `rank_plan` and runs the kernel on every
tile the plan can choose. These tests check the plan itself: every upper
tile of every task has exactly one block, every row of c exactly one
owner, the grid fits the card and the tile follows the rule.
"""
from __future__ import annotations

import re
from pathlib import Path

import pytest

from repro_torch.kernels.rank_update import ops as rank_ops
from repro_torch.kernels.rank_update.ops import (
    RANK_TILES, rank_plan, triangle_tile,
)

H100_SMS = 132
SMEM_PER_BLOCK = 232448        # 227 KB, the opt-in limit of one block
SOURCE = (Path(rank_ops.__file__).resolve().parents[1] / "csrc"
          / "rank_update.cu")
P_VALUES = (1, 7, 128, 129, 1000, 1024, 8192)


def _grid(m: int, p: int, tile: int) -> list[tuple[int, int, int]]:
    tiles = -(-p // tile)
    return [triangle_tile(b, tiles)
            for b in range(m * tiles * (tiles + 1) // 2)]


@pytest.mark.parametrize("tile", [bt for bt, _ in RANK_TILES])
@pytest.mark.parametrize("p", P_VALUES)
def test_triangle_map_is_a_bijection_onto_the_upper_tiles(p, tile):
    m = 2
    tiles = -(-p // tile)
    got = _grid(m, p, tile)
    want = {(t, i, j) for t in range(m) for i in range(tiles)
            for j in range(i, tiles)}
    assert len(got) == len(set(got)) == len(want)
    assert set(got) == want


@pytest.mark.parametrize("tile", [bt for bt, _ in RANK_TILES])
@pytest.mark.parametrize("p", P_VALUES)
def test_each_row_of_c_has_one_owner(p, tile):
    """The diagonal blocks (t, I, I) write c's rows I*BT .. (I+1)*BT - 1
    below p: between them every row of every task once."""
    m = 3
    owners = [0] * (m * p)
    for t, i, j in _grid(m, p, tile):
        if i == j:
            for row in range(i * tile, min(p, (i + 1) * tile)):
                owners[t * p + row] += 1
    assert owners == [1] * (m * p)


@pytest.mark.parametrize("sms", [H100_SMS, 8])
@pytest.mark.parametrize("m, p", [(16, 1024), (8, 256), (3, 1000),
                                  (2, 129), (1, 7), (64, 8192)])
def test_rank_plan_follows_its_rule_and_fits_a_block(m, p, sms):
    pl = rank_plan(m, p, sms)
    rt = dict(RANK_TILES)[pl.tile]
    assert pl.tiles == -(-p // pl.tile)
    assert (pl.tiles - 1) * pl.tile < p <= pl.tiles * pl.tile
    assert pl.blocks == m * pl.tiles * (pl.tiles + 1) // 2 < 2**31
    assert pl.threads == (pl.tile // rt) ** 2 and pl.threads % 32 == 0
    assert pl.smem_bytes <= SMEM_PER_BLOCK
    assert pl.smem_bytes >= 4 * pl.tile * pl.tile     # the staged tile
    # the larger tile where its triangle grid has a block for every SM
    (large, _), (small, _) = RANK_TILES
    t = -(-p // large)
    assert (pl.tile == large) == (m * t * (t + 1) // 2 >= sms)
    assert pl.tile in (large, small)


def test_rank_plan_picks_the_expected_tiles():
    """The fits' shape (16, 512, 1024) keeps 128-tiles: 576 blocks. The
    streaming ingest's (8, 1024, 256) gives 24 blocks of 128 for 132 SMs,
    so it drops to 32-tiles: 288 blocks; so does (3, 500, 1000), 108
    blocks of 128. On a card of 8 SMs both take 128-tiles."""
    main = rank_plan(16, 1024, H100_SMS)
    assert (main.tile, main.blocks, main.threads) == (128, 576, 256)
    ingest = rank_plan(8, 256, H100_SMS)
    assert (ingest.tile, ingest.blocks, ingest.threads) == (32, 288, 64)
    assert rank_plan(3, 1000, H100_SMS).tile == 32
    assert rank_plan(4, 2048, H100_SMS).tile == 128
    assert rank_plan(16, 1024, 8).tile == rank_plan(8, 256, 8).tile == 128
    # the card tests' shapes reach every tile
    shapes = [(16, 1024), (8, 256), (3, 1000), (2, 129)]
    assert {rank_plan(m, p, H100_SMS).tile for m, p in shapes} == \
        {bt for bt, _ in RANK_TILES}


def test_the_kernel_source_has_the_plans_constants():
    """The launcher's tiles (PLAN_TILES, the register tiles of
    launch_plan, BK and STAGES) are the ones `rank_plan` copies."""
    src = SOURCE.read_text()
    tiles = re.search(r"PLAN_TILES\[2\] = \{(.*?)\}", src).group(1)
    assert tuple(int(v) for v in tiles.split(",")) == \
        tuple(bt for bt, _ in RANK_TILES)
    launched = re.findall(r"launch_tile<(\d+), (\d+),", src)
    assert tuple((int(a), int(b)) for a, b in launched) == RANK_TILES
    assert int(re.search(r"constexpr int BK = (\d+);", src).group(1)) == \
        rank_ops.RANK_BK
    assert int(re.search(r"constexpr int STAGES = (\d+);", src).group(1)) \
        == rank_ops.RANK_STAGES
