"""Wrappers of the rank-n update kernels (`kernels/csrc/rank_update.cu`).

`rank_update` is the fused kernel (Sigma and c in one launch), the path
of `sufficient_stats`; `rank_update_unfused` is the two-dispatch pair
(Sigma alone, then c alone), the fused kernel's yardstick. `use_kernel`
follows `kernels/common.py`: the CUDA kernels for CUDA tensors, the plain
version (`ref.py`) for CPU tensors.

`rank_plan` is the Sigma kernel's choice of square block tile and
`triangle_tile` its map from a block to the tile of Sigma's upper
triangle it computes, plain Python so that the CPU tests check them; the
kernel's launcher applies the same rule (`rank_update_plan` in the .cu
returns its choice).

`block=` overrides the rule with an entry of RANK_TILES, `(128, 8)` or
`(32, 4)` (the tile's side and its threads' register tiles'), or None
for the rule's tile. On CUDA tensors the Sigma kernel launches exactly
that tile; the plain version ignores it. Every tile gives the same bits.
Anything else raises ValueError on every path, the CPU's too, the JAX
package's TPU tilings (`128`, `(bp, bn)`) included.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LAUNCHES, check_f32, resolve_use_kernel,
)
from repro_torch.kernels.rank_update.ref import rank_update_ref

# the tiled entries take the plan last (-1: the rule's tile)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p, ctypes.c_int]
_SIGMA_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p, ctypes.c_int]
_C_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3

# the Sigma kernel's square tiles, larger first, each with the side of its
# threads' register tiles (PLAN_TILES and launch_plan in the .cu), and its
# ring: samples per stage and stages (BK, STAGES)
RANK_TILES = ((128, 8), (32, 4))
RANK_BK = 16
RANK_STAGES = 4


class RankPlan(NamedTuple):
    tile: int            # BT: the block's output tile is BT x BT
    tiles: int           # T = ceil(p / BT) tiles a side
    blocks: int          # m * T * (T + 1) / 2: the upper tiles of m tasks
    threads: int         # (BT / RT)^2, one RT x RT register tile each
    smem_bytes: int      # the ring, or the staged output tile if larger


def _triangle(p: int, tile: int) -> int:
    tiles = -(-p // tile)
    return tiles * (tiles + 1) // 2


def rank_plan(m: int, p: int, sms: int) -> RankPlan:
    """Block tile of the Sigma kernel for (m, p) on a card with `sms`
    SMs: the larger of RANK_TILES where its triangle grid has at least
    one block per SM, else the smaller. The samples n do not enter: no
    split-K, so every tile gives the same bits."""
    (tile, rt), small = RANK_TILES
    if m * _triangle(p, tile) < sms:
        tile, rt = small
    ring = RANK_STAGES * (2 * RANK_BK * tile + RANK_BK)
    return RankPlan(tile, -(-p // tile), m * _triangle(p, tile),
                    (tile // rt) ** 2, 4 * max(ring, tile * tile))


def triangle_tile(block: int, tiles: int) -> tuple[int, int, int]:
    """(t, I, J), I <= J: the task and tile of Sigma that block `block`
    of the kernel's grid computes, T = `tiles` tiles a side; row I of the
    triangle holds T - I tiles. Block (t, I, I) also writes c's rows of
    tile I."""
    per_task = tiles * (tiles + 1) // 2
    t, u = divmod(block, per_task)
    i = 0
    while u >= tiles - i:
        u -= tiles - i
        i += 1
    return t, i, i + u


def kernel_rank_plan(m: int, p: int,
                     device: torch.device) -> tuple[int, int, int]:
    """(tile, blocks, SMs) as the kernel's launcher chooses them on
    `device`."""
    fn = _build.function("rank_update", "rank_update_plan", _PLAN_ARGTYPES)
    tile, blocks, sms = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    _build.call(fn, m, p, index, ctypes.byref(tile), ctypes.byref(blocks),
                ctypes.byref(sms))
    return tile.value, blocks.value, sms.value


def check_block(name: str, block) -> int:
    """The launcher's `plan` for `block`: -1 for None (the rule), else the
    index of `block` in RANK_TILES. Raises ValueError for anything else."""
    if block is None:
        return -1
    entry = tuple(block) if isinstance(block, (list, tuple)) else block
    if entry in RANK_TILES and all(type(b) is int for b in entry):
        return RANK_TILES.index(entry)
    raise ValueError(f"{name}: block={block!r} is not an entry of "
                     f"RANK_TILES (tile, register tile) {RANK_TILES}, nor "
                     f"None for the rule's tile")


def _checked(name: str, Xs: torch.Tensor, ys: torch.Tensor,
             weights: torch.Tensor | None,
             use_kernel: bool | None) -> bool:
    """Check the operands (Xs (m, n, p); ys and optional weights (m, n);
    float32) and return whether the kernel runs."""
    if Xs.ndim != 3:
        raise ValueError(f"{name}: Xs must be (m, n, p), got "
                         f"{tuple(Xs.shape)}")
    m, n, p = Xs.shape
    args = {"Xs": Xs, "ys": ys}
    if weights is not None:
        args["weights"] = weights
    for arg, t in args.items():
        if arg != "Xs" and tuple(t.shape) != (m, n):
            raise ValueError(f"{name}: {arg} must be {(m, n)}, got "
                             f"{tuple(t.shape)}")
    check_f32(name, **args)
    if not resolve_use_kernel(name, use_kernel, *args.values()):
        return False
    if min(m, n, p) == 0:
        raise ValueError(f"{name}: empty shape {(m, n, p)}")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def _outputs(Xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m, _, p = Xs.shape
    return (torch.empty((m, p, p), dtype=torch.float32, device=Xs.device),
            torch.empty((m, p), dtype=torch.float32, device=Xs.device))


def rank_update(Xs: torch.Tensor, ys: torch.Tensor,
                weights: torch.Tensor | None = None, *,
                use_kernel: bool | None = None, block=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigma_t = X_t' W_t X_t / n and c_t = X_t' W_t y_t / n for all m
    tasks. Xs (m, n, p); ys and optional weights (m, n); float32;
    `block` an entry of RANK_TILES or None for the rule's tile. Returns
    (Sigmas (m, p, p), cs (m, p))."""
    plan = check_block("rank_update", block)
    if not _checked("rank_update", Xs, ys, weights, use_kernel):
        return rank_update_ref(Xs, ys, weights)
    Sigmas, cs = _outputs(Xs)
    launch(Xs, ys, weights, Sigmas, cs, plan)
    return Sigmas, cs


def rank_update_unfused(Xs: torch.Tensor, ys: torch.Tensor,
                        weights: torch.Tensor | None = None, *,
                        use_kernel: bool | None = None, block=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`rank_update` in two launches, Sigma alone and then c alone, as
    the reference's two-dispatch baseline computes it: X is read twice.
    Same arguments and result as `rank_update`; `block` is Sigma's
    tile."""
    plan = check_block("rank_update_unfused", block)
    if not _checked("rank_update_unfused", Xs, ys, weights, use_kernel):
        return rank_update_ref(Xs, ys, weights)
    Sigmas, cs = _outputs(Xs)
    launch_sigma(Xs, weights, Sigmas, plan)
    launch_c(Xs, ys, weights, cs)
    return Sigmas, cs


def _wptr(weights: torch.Tensor | None):
    return None if weights is None else weights.data_ptr()


# The launchers below take what the wrappers pass (float32, contiguous,
# one CUDA device; Xs (m, n, p), ys and weights (m, n), Sigmas (m, p, p),
# cs (m, p); `plan` as `check_block` returns it, which the launcher
# refuses out of range) and check nothing: a timing loop calls them to
# time a kernel alone.

def launch(Xs: torch.Tensor, ys: torch.Tensor, weights: torch.Tensor | None,
           Sigmas: torch.Tensor, cs: torch.Tensor, plan: int = -1) -> None:
    """Launch the fused kernel into Sigmas and cs."""
    m, n, p = Xs.shape
    fn = _build.function("rank_update", "rank_update_f32", _ARGTYPES)
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(), _wptr(weights),
                Sigmas.data_ptr(), cs.data_ptr(), m, n, p,
                Xs.device.index, _build.stream(Xs.device), plan)
    LAUNCHES["rank_update"] += 1


def launch_sigma(Xs: torch.Tensor, weights: torch.Tensor | None,
                 Sigmas: torch.Tensor, plan: int = -1) -> None:
    """Launch the unfused pair's Sigma-only kernel into Sigmas."""
    m, n, p = Xs.shape
    fn = _build.function("rank_update", "rank_update_sigma_f32",
                         _SIGMA_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), _wptr(weights), Sigmas.data_ptr(), m, n,
                p, Xs.device.index, _build.stream(Xs.device), plan)
    LAUNCHES["rank_update_sigma"] += 1


def launch_c(Xs: torch.Tensor, ys: torch.Tensor, weights: torch.Tensor | None,
             cs: torch.Tensor) -> None:
    """Launch the unfused pair's c-only kernel into cs."""
    m, n, p = Xs.shape
    fn = _build.function("rank_update", "rank_update_c_f32", _C_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(), _wptr(weights),
                cs.data_ptr(), m, n, p, Xs.device.index,
                _build.stream(Xs.device))
    LAUNCHES["rank_update_c"] += 1
