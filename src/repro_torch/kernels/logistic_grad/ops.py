"""Wrappers of the logistic-gradient kernels (`kernels/csrc/logistic_grad.cu`).

`logistic_grad` is the fused kernel: the whole gradient in one launch.
`logistic_grad_unfused` is its two-kernel twin (the forward product and
its residual, then the back-projection), the yardstick the fusion is
measured against. `use_kernel` follows `kernels/common.py`: the CUDA
kernels for CUDA tensors, the plain versions (`ref.py`) for CPU tensors.

`plan` chooses the fused kernel's launch shape (cluster size, chunks of
the sample axis, where a block keeps its row slices) from the card's SM
count and shared-memory limit, `unfused_plan` the two unfused kernels'
from the SM count; they are plain Python, so the CPU tests check them
(the .cu applies the same rules, and `logistic_grad_plan` and
`logistic_unfused_plan` return its choices).

`block=` overrides a rule: for `logistic_grad` a cluster size, 1, 2, 4
or 8 and at most what `cluster_max` allows for p (the rule's chunks and
mode then follow for that size); for `logistic_grad_unfused` a
`(rows_per_warp, warps_per_row, cols)` triple, the first two an entry of
UNFUSED_Z_PLANS and `cols` one of UNFUSED_COLS; None for the rule's
plan. On CUDA tensors the kernels launch exactly that plan; the plain
versions ignore it. The plans differ in the order of their sums, so the
gradients differ in the last bits (each within the kernels' 1e-5 bar).
Anything else raises ValueError on every path, the CPU's too, the JAX
package's TPU tilings (`128`, `(bn, bp)`) included.

The fused kernel's ticket counters stay on the device between calls (the
kernel leaves them at zero), one buffer a device, grown when a launch
needs more: a call issues one kernel and no fill. Launches that share a
device therefore run one at a time, as on one stream.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LAUNCHES, check_f32, resolve_use_kernel,
)
from repro_torch.kernels.logistic_grad.ref import (
    logistic_backproject_ref, logistic_grad_ref, logistic_residual_ref,
)

# the fused kernel's plan (the constants of the same names in the .cu)
THREADS = 256                # threads of a block
CLUSTER_MAX = 8              # blocks of a cluster, a portable size
V_MAX = 4                    # a thread's vectors of a row slice in registers
GROUP_VECS = 4               # rows x vectors of a register group
GROUP_STAGES = 3             # groups in the register kernel's ring
STAGES = 3                   # row slices in the ring kernel's ring
BLOCKS_PER_SM = 2            # blocks the plan gives every SM, at least
SOLO_BLOCKS_PER_SM = 4       # what chunks aim at where the cluster is 1
TAIL_BYTES = 512 * 1024      # partial slices a tail block adds, at most
_STATIC_SMEM = 512           # the kernels' static shared memory, rounded up
MODES = ("registers", "ring", "twice")    # Mode in the .cu, in order

# the unfused pair: the blocks per SM its plan asks for, the warps of a
# block, the forward kernel's (rows per warp, warps per row) and the
# back-projection's column slices in floats, first choice first
# (UNFUSED_BLOCKS_PER_SM, WARPS, Z_PLANS, UNFUSED_COLS in the .cu)
UNFUSED_BLOCKS_PER_SM = 2
UNFUSED_WARPS = 8
UNFUSED_Z_PLANS = ((2, 1), (1, 1), (1, 2), (1, 4), (1, 8))
UNFUSED_COLS = (128, 64, 32)

# the launch entries take the plan last (-1: the rule's)
_GRAD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                          ctypes.c_longlong, ctypes.c_void_p] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.c_int]
_PLAN_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
_UNFUSED_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p, ctypes.c_int]
_UNFUSED_PLAN_ARGTYPES = [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_int)] * 4
_DEVICE: dict[int, tuple[int, int]] = {}
_COUNTERS: dict[int, torch.Tensor] = {}


class Plan(NamedTuple):
    chunks: int          # clusters per task, each a run of consecutive samples
    rows_per_chunk: int
    cluster: int         # C: blocks of a cluster, one column slice each
    mode: str            # where a block keeps its row slices (MODES)
    vecs: int            # a thread's vectors of a row slice
    smem_bytes: int      # dynamic shared memory of a block: its ring, or 0


def _chunks(m: int, n: int, cluster: int, slice_floats: int,
            want: int) -> tuple[int, int]:
    """(chunks, rows a chunk): enough chunks for `want` blocks, no more
    partial slices a tail block than TAIL_BYTES, no empty chunk."""
    chunks = max(1, min(-(-want // (m * cluster)),
                        TAIL_BYTES // (4 * slice_floats), n))
    rows = -(-n // chunks)
    return -(-n // rows), rows


def cluster_max(p: int, vec: bool | None = None) -> int:
    """The largest cluster the fused kernel takes for rows of p floats: a
    power of two, at most CLUSTER_MAX, and no slice under THREADS
    vectors (`cluster_max` in the .cu)."""
    pv = -(-p // (4 if p % 4 == 0 and vec is not False else 1))
    cmax = 1
    while cmax * 2 <= CLUSTER_MAX and cmax * 2 * THREADS <= pv:
        cmax *= 2
    return cmax


def plan(m: int, n: int, p: int, sms: int, smem_optin: int,
         vec: bool | None = None, cluster: int | None = None) -> Plan:
    """Launch shape of the fused kernel for (m, n, p) on a card with `sms`
    SMs and `smem_optin` bytes of shared memory per block. The kernel
    takes float4 vectors where p % 4 == 0 and its pointers are 16-byte
    aligned; `vec=False` plans for unaligned pointers. `cluster` forces
    the cluster size (one `check_cluster` allows), with this rule's
    chunks and mode for it.

    Cluster: the smallest C of 1, 2, 4, 8 (and no slice under THREADS
    vectors) whose row slice of ceil(p / C) floats a thread holds in at
    most V_MAX vectors of registers and whose grid of m * chunks * C
    blocks gives BLOCKS_PER_SM blocks an SM; else the largest allowed.
    Chunks: enough for that many blocks (SOLO_BLOCKS_PER_SM an SM where
    C = 1, whose blocks do not wait on each other), but no more partial
    slices a tail block than TAIL_BYTES and no empty chunk. Mode: "registers"
    where b's and the accumulator's slices fit in registers (vecs 3 runs
    as 4), the rows GROUP_VECS / vecs at a time through a shared-memory
    ring of GROUP_STAGES groups; else "ring", STAGES row slices with b's
    and the accumulator's slices in shared memory, where they fit in the
    per-block limit; else "twice", X read from global memory twice."""
    width = 4 if p % 4 == 0 and vec is not False else 1
    pv = -(-p // width)
    want = BLOCKS_PER_SM * sms
    solo = SOLO_BLOCKS_PER_SM * sms
    cmax = cluster_max(p, vec)
    forced = cluster is not None
    cluster = cluster if forced else cmax
    c = 1
    while not forced and c <= cmax:
        sv = -(-pv // c)
        chunks, _ = _chunks(m, n, c, sv * width, solo if c == 1 else want)
        if -(-sv // THREADS) <= V_MAX and m * chunks * c >= want:
            cluster = c
            break
        c *= 2
    sv = -(-pv // cluster)
    chunks, rows = _chunks(m, n, cluster, sv * width,
                           solo if cluster == 1 else want)
    vecs = -(-sv // THREADS)
    ring = (STAGES + 2) * sv * width * 4 + STAGES * 4
    if vecs <= V_MAX:
        vecs = 4 if vecs == 3 else vecs
        staged = GROUP_STAGES * (GROUP_VECS // vecs)     # rows in the ring
        return Plan(chunks, rows, cluster, "registers", vecs,
                    staged * sv * width * 4 + staged * 4)
    if ring + _STATIC_SMEM <= smem_optin:
        return Plan(chunks, rows, cluster, "ring", vecs, ring)
    return Plan(chunks, rows, cluster, "twice", vecs, 0)


def check_cluster(name: str, p: int, block) -> int:
    """The fused launcher's `plan` for `block`: -1 for None (the rule),
    else the cluster size `block`, which must be 1, 2, 4 or 8 and at most
    `cluster_max(p)`. Raises ValueError for anything else."""
    if block is None:
        return -1
    sizes = tuple(c for c in (1, 2, 4, 8) if c <= cluster_max(p))
    if type(block) is int and block in sizes:
        return block
    raise ValueError(f"{name}: block={block!r} is not a cluster size the "
                     f"fused kernel takes at p = {p} {sizes} (1, 2, 4, 8 up "
                     f"to cluster_max), nor None for the rule's plan")


def check_unfused_block(name: str, block) -> int:
    """The unfused launcher's `plan` for `block`: -1 for None (the rule),
    else z * len(UNFUSED_COLS) + c for `block` = (*UNFUSED_Z_PLANS[z],
    UNFUSED_COLS[c]). Raises ValueError for anything else."""
    if block is None:
        return -1
    entry = tuple(block) if isinstance(block, (list, tuple)) else block
    if isinstance(entry, tuple) and len(entry) == 3 \
            and all(type(b) is int for b in entry) \
            and entry[:2] in UNFUSED_Z_PLANS and entry[2] in UNFUSED_COLS:
        return (UNFUSED_Z_PLANS.index(entry[:2]) * len(UNFUSED_COLS)
                + UNFUSED_COLS.index(entry[2]))
    raise ValueError(f"{name}: block={block!r} is not (rows_per_warp, "
                     f"warps_per_row, cols) with the first two an entry of "
                     f"UNFUSED_Z_PLANS {UNFUSED_Z_PLANS} and cols one of "
                     f"UNFUSED_COLS {UNFUSED_COLS}, nor None for the "
                     f"rule's plan")


def kernel_plan(m: int, n: int, p: int, vec: bool,
                device: torch.device) -> tuple[Plan, int]:
    """The fused kernel's plan as its launcher chooses it on `device`, and
    the SM count it saw."""
    fn = _build.function("logistic_grad", "logistic_grad_plan",
                         _PLAN_ARGTYPES)
    out = (ctypes.c_int * 7)()
    _build.call(fn, m, n, p, int(vec), _index(device), out)
    return _plan_of(out), out[6]


def _plan_of(v) -> Plan:
    return Plan(v[0], v[1], v[2], MODES[v[3]], v[4], v[5])


class UnfusedPlan(NamedTuple):
    rows_per_warp: int   # forward kernel: sample rows a warp takes
    warps_per_row: int   # forward kernel: warps that share a sample row
    rows_per_block: int  # UNFUSED_WARPS * rows_per_warp / warps_per_row
    z_blocks: int        # m * ceil(n / rows_per_block)
    cols: int            # back-projection: floats of p per block
    bp_blocks: int       # m * ceil(p / cols)


def unfused_plan(m: int, n: int, p: int, sms: int) -> UnfusedPlan:
    """Launch shapes of the unfused pair for (m, n, p) on a card with
    `sms` SMs, each grid aiming at UNFUSED_BLOCKS_PER_SM blocks an SM.
    The forward kernel takes the first (rows per warp, warps per row) of
    UNFUSED_Z_PLANS whose grid reaches it (the most rows a block first);
    the back-projection the widest column slice of UNFUSED_COLS that
    does, with all n samples in the block. Where none does, the last of
    each."""
    want = UNFUSED_BLOCKS_PER_SM * sms

    def rows_per_block(zp):
        return UNFUSED_WARPS * zp[0] // zp[1]

    rpw, wpr = next((zp for zp in UNFUSED_Z_PLANS
                     if m * -(-n // rows_per_block(zp)) >= want),
                    UNFUSED_Z_PLANS[-1])
    rows = rows_per_block((rpw, wpr))
    cols = next((c for c in UNFUSED_COLS if m * -(-p // c) >= want),
                UNFUSED_COLS[-1])
    return UnfusedPlan(rpw, wpr, rows, m * -(-n // rows), cols,
                       m * -(-p // cols))


def kernel_unfused_plan(m: int, n: int, p: int,
                        device: torch.device) -> tuple[int, int, int, int]:
    """(rows per warp, warps per row, floats per column slice, SMs) as
    the unfused kernels' launcher chooses them on `device`."""
    fn = _build.function("logistic_grad", "logistic_unfused_plan",
                         _UNFUSED_PLAN_ARGTYPES)
    out = [ctypes.c_int(0) for _ in range(4)]
    _build.call(fn, m, n, p, _index(device), *(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _device_limits(device: torch.device) -> tuple[int, int]:
    """(SMs, opt-in shared memory per block) of a CUDA device."""
    index = _index(device)
    limits = _DEVICE.get(index)
    if limits is None:
        props = torch.cuda.get_device_properties(index)
        limits = _DEVICE[index] = (props.multi_processor_count,
                                   props.shared_memory_per_block_optin)
    return limits


def _check(name: str, Xs: torch.Tensor, ys: torch.Tensor,
           B: torch.Tensor, use_kernel: bool | None) -> bool:
    """Check a call's operands; return whether it launches the kernel."""
    if Xs.ndim != 3:
        raise ValueError(f"{name}: Xs must be (m, n, p), got "
                         f"{tuple(Xs.shape)}")
    m, n, p = Xs.shape
    for arg, t, shape in (("ys", ys, (m, n)), ("B", B, (m, p))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
    check_f32(name, Xs=Xs, ys=ys, B=B)
    if not resolve_use_kernel(name, use_kernel, Xs, ys, B):
        return False
    if min(m, n, p) == 0:
        raise ValueError(f"{name}: empty shape {(m, n, p)}")
    if not all(t.is_contiguous() for t in (Xs, ys, B)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def vectorized(Xs: torch.Tensor, B: torch.Tensor) -> bool:
    """Whether the fused kernel takes float4 vectors for these operands
    (p % 4 == 0 and 16-byte aligned; its outputs come from the allocator,
    which aligns them)."""
    return Xs.shape[-1] % 4 == 0 and Xs.data_ptr() % 16 == 0 \
        and B.data_ptr() % 16 == 0


def ticket_counters(device: torch.device, size: int) -> torch.Tensor:
    """At least `size` zeroed int32 ticket counters on `device`, kept
    between calls: the kernel leaves them at zero. Grown (one fill) only
    when a launch needs more; under CUDA graph capture a buffer of the
    graph's own."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(size, dtype=torch.int32, device=device)
    index = _index(device)
    buf = _COUNTERS.get(index)
    if buf is None or buf.numel() < size:
        buf = _COUNTERS[index] = torch.zeros(size, dtype=torch.int32,
                                             device=device)
    return buf


def logistic_grad(Xs: torch.Tensor, ys: torch.Tensor, B: torch.Tensor, *,
                  use_kernel: bool | None = None, block=None) -> torch.Tensor:
    """All-tasks logistic gradient -X_t'(y_t sigmoid(-y_t X_t b_t))/n.
    Xs (m, n, p), ys (m, n) in {-1, +1}, B (m, p); float32; `block` a
    cluster size (`check_cluster`) or None for the rule's plan. Returns
    (m, p). One launch of the fused kernel on CUDA tensors, and no
    other."""
    cluster = check_cluster("logistic_grad", Xs.shape[-1], block)
    if not _check("logistic_grad", Xs, ys, B, use_kernel):
        return logistic_grad_ref(Xs, ys, B)
    m, n, p = Xs.shape
    pl = plan(m, n, p, *_device_limits(Xs.device), vec=vectorized(Xs, B),
              cluster=None if cluster < 0 else cluster)
    G = torch.empty((m, p), dtype=torch.float32, device=Xs.device)
    work = torch.empty((m, pl.chunks, p), dtype=torch.float32,
                       device=Xs.device)
    launch(Xs, ys, B, G, work, ticket_counters(Xs.device, m * pl.cluster),
           cluster)
    return G


def launch(Xs: torch.Tensor, ys: torch.Tensor, B: torch.Tensor,
           G: torch.Tensor, work: torch.Tensor, counters: torch.Tensor,
           cluster: int = -1) -> Plan:
    """Launch the fused kernel into the given outputs, with no checks: the
    operands are what `logistic_grad` passes (float32, contiguous, one
    CUDA device; Xs (m, n, p), ys (m, n), B and G (m, p), work at least
    m * chunks * p floats, counters at least m * cluster int32 zeros, for
    `plan`'s chunks and cluster; `cluster` -1 for the rule's, else the
    size to force). The launcher applies the plan itself and raises where
    work or counters fall short or the cluster is not one it takes. The
    kernel leaves the counters at zero, so a timing loop reuses them.
    Returns the plan launched."""
    m, n, p = Xs.shape
    fn = _build.function("logistic_grad", "logistic_grad_f32", _GRAD_ARGTYPES)
    ran = (ctypes.c_int * 6)()
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(), B.data_ptr(),
                work.data_ptr(), work.numel(), counters.data_ptr(),
                counters.numel(), G.data_ptr(), m, n, p, _index(Xs.device),
                _build.stream(Xs.device), ran, cluster)
    LAUNCHES["logistic_grad"] += 1
    return _plan_of(ran)


def logistic_grad_unfused(Xs: torch.Tensor, ys: torch.Tensor,
                          B: torch.Tensor, *, use_kernel: bool | None = None,
                          block=None) -> torch.Tensor:
    """The same gradient in two kernels: the residual r = y sigmoid(-y X
    b), then -X' r / n. The fused kernel's baseline; X is read twice and
    r passes through device memory. `block` is a (rows_per_warp,
    warps_per_row, cols) plan (`check_unfused_block`) or None for the
    rule's."""
    plan_index = check_unfused_block("logistic_grad_unfused", block)
    if not _check("logistic_grad_unfused", Xs, ys, B, use_kernel):
        return logistic_backproject_ref(Xs, logistic_residual_ref(Xs, ys, B))
    m, n, p = Xs.shape
    z = torch.empty((m, n), dtype=torch.float32, device=Xs.device)
    G = torch.empty((m, p), dtype=torch.float32, device=Xs.device)
    launch_unfused(Xs, ys, B, z, G, plan_index)
    return G


def launch_unfused(Xs: torch.Tensor, ys: torch.Tensor, B: torch.Tensor,
                   z: torch.Tensor, G: torch.Tensor,
                   plan_index: int = -1) -> None:
    """Both unfused kernels into the given outputs, with no checks: the
    operands are what `logistic_grad_unfused` passes. `z` (m, n) is the
    vector between them: it receives the residual r = y sigmoid(-y X b),
    which the second kernel reads to write G (m, p). One host call
    launches the two kernels on the current stream, each with its launch
    shape from `unfused_plan`'s rule, or from `plan_index` as
    `check_unfused_block` returns it."""
    m, n, p = Xs.shape
    fn = _build.function("logistic_grad", "logistic_unfused_f32",
                         _UNFUSED_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(), B.data_ptr(), z.data_ptr(),
                G.data_ptr(), m, n, p, Xs.device.index,
                _build.stream(Xs.device), plan_index)
    LAUNCHES["logistic_z"] += 1
    LAUNCHES["logistic_backproject"] += 1
