// One fused FISTA iteration for m tasks, both outputs from one launch:
//
//     x' = soft(z - eta_t (Sigma_t z - c_t), eta_t lam_t)
//     z' = x' + theta (x' - x)
//
// Replaces `fista_step_batched_pallas` (src/repro/kernels/ista_step/
// kernel.py, body `_fista_batched_kernel`). Sigma is (m, p, p); z, x, c and
// both outputs are (m, p, r), row-major; eta and lam are per task (m,);
// theta is one float32 scalar computed on the host. The momentum is taken
// in f32 on the already-rounded x', as in the TPU kernel's epilogue. The
// outputs must not alias z or x: every block reads all of z.
//
// The same kernels with the compile-time flag MOMENTUM = false are the
// plain ISTA step, x' = soft(beta - eta_t (Sigma_t beta - c_t), eta_t lam_t)
// with no x input and no z' output. They replace `ista_step_batched_pallas`
// (body `_ista_batched_kernel`, per-task eta and lam) and, launched with
// m = 1, `ista_step_pallas` (body `_ista_kernel`, scalar eta and lam): the
// two TPU bodies share the epilogue computed here. Without the x read and
// the z' write the step moves two (m, p, r) arrays fewer; at r = 1 it is
// still bound by Sigma's bytes and at r = p by the operations.
//
// Two code paths for the two shapes of the DSML main path, each with a C
// entry with momentum (fista_step_*) and one without (ista_step_*); the
// wrapper chooses by r.
//
// * r == 1 (the m local lassos, `ista_solve`): a batched matrix-vector
//   product, bound by bytes. At (m, p) = (16, 1024) Sigma is 67 MB, more
//   than the 50 MB L2, so it streams from HBM on every iteration: 20 us at
//   3.35 TB/s against 33.5 MFLOP of work; at m = 1 Sigma_t (4 MB) stays in
//   L2 across `ista_solve`'s steps and the launch is the cost. Design: each
//   output row is one warp's FMA chains; lane l reads z_t and the row at
//   float4 q = l, l + 32, ... (scalars where p % 4 != 0 or a pointer is
//   not 16-byte aligned), a shuffle tree adds the lanes, and a lane
//   applies the epilogue. A warp takes 1, 2 or 4 rows at once and a block
//   2, 4 or 8 warps: `gemv_plan` takes the largest that still gives every
//   SM four blocks, else the smallest: 2 rows x 8 warps, 1024 blocks, at
//   m = 16 (faster there than 4 x 8 in 512 blocks); 1 row x 2 warps,
//   512 blocks, at m = 1 (4 x 8 left 100 of the 132 SMs idle); 4 x 8 from
//   m = 17, as for the lambda grid's 128 tasks. Whatever the plan, a
//   row's chains and their order are the same, so every plan gives the
//   same bits. Each lane issues the loads of 8 float4 (2 steps of 4 rows,
//   4 of 2, or 8 of one) before their FMAs: 128 bytes a lane, about 160 KB
//   in flight per SM at m = 16, where 3.35 TB/s at about 0.8 us of latency
//   needs some 20 KB. z_t is read through L1 (4 KB at p = 1024, shared by
//   the SM's warps) and Sigma's loads skip L1, so that they do not evict
//   it; no shared memory and no barrier. The epilogue's operands are
//   loaded before the loop.
//
// * r == 1 over a lambda grid (`solve_lasso_grid`: k values of lambda for
//   each of m tasks, k m problems in the layout (k, m, p)): the k problems
//   of a task share Sigma_t, and their iterates z, x and c_t are small
//   (6.4 KB a task at p = 200, k = 8). So the bound is Sigma's bytes read
//   once a step: 164 MB at (m, p) = (1024, 200), 49 us at 3.35 TB/s, where
//   running the k m problems as r == 1 problems on Sigma tiled k times
//   read 1.31 GB. Design (`fista_gemv_kernel_lams`): the r == 1 kernel's
//   blocks, warps and Sigma loads, with 8 chains a row, one per lambda,
//   against z_{j, t} read through L1 (Sigma's loads skip it); a launch
//   takes the lambdas in passes of 8, reading Sigma_t ceil(k / 8) times,
//   and a pass of fewer runs its last lambda again in the spare chains.
//   One lambda (k == 1) is the r == 1 kernel's problem and takes its
//   launch. The 8 ROWS sums of a warp are added across its lanes by
//   `tree_scatter`, the same tree as the r == 1 kernel's in 31 shuffles
//   where 8 ROWS trees take 40 ROWS (160 at 4 rows), and lane l ends
//   with one sum and applies its epilogue. Every chain and every addition
//   is the r == 1
//   kernel's for that problem, so the outputs have the bits of the tiled
//   solve. That alone reached 93 % of the bound at (16, 4096, k 8) but
//   35 % at the paper's p = 200, where a warp's rows take one round of
//   loads: short rows (p <= 256) take `fista_gemv_kernel_lams_staged`,
//   whose warps each stream several groups of rows, loading one while
//   they compute the last, with the pass's iterates in shared memory;
//   72 % of the bound at (1024, 200, k 8) (H100 80GB HBM3, 700 W).
//
// * r > 1 (the debias solve, r = p, c = I): a batched matrix product. At
//   (m, p) = (16, 1024) it is bound by operations: one step is 2 m p^3 =
//   34.4 GFLOP of f32 FMA, 0.51 ms at 67 TFLOP/s f32, and its bytes
//   (about 400 MB) take 0.12 ms. At the paper's p = 200 over 1024 tasks
//   the two meet: 16.4 GFLOP take 0.245 ms and Sigma with four (m, p, r)
//   arrays (819 MB) 0.2445 ms, c a sixth array (0.293 ms with it). Full
//   f32 rules out the TF32 tensor cores, so the kernel is an SGEMM on the
//   CUDA cores that keeps the FMA pipes fed while the arrays stream.
//   - Each block tile has its ring: STAGES shared-memory stages, each BK
//     deep in k, filled by 16-byte `cp.async.cg` (4-byte `cp.async.ca`
//     where p or r is not a multiple of 4 or an operand is not 16-byte
//     aligned), with the loads of the next STAGES - 1 stages in flight
//     while a stage's FMAs run; one barrier per stage. A thread that has
//     no copy left in a stage's last round (125 threads do not divide its
//     copies) skips it.
//   - Each thread owns an 8 x 8 register tile made of 4-wide groups: rows
//     4 ty + {0..3} and BM/2 + 4 ty + {0..3}, columns 4 tx + {0..3} and
//     BN/2 + 4 tx + {0..3}. Sigma's tile stays row-major in shared memory
//     (i-major, as cp.async copies it) and a thread reads four k values of
//     a row as one float4; z's tile is k-major and a thread reads four
//     columns as one float4. That is 4 LDS.128 per 64 FMA. The 16-byte
//     chunks of a Sigma row are XOR-swizzled by row / 4, so the rows that
//     the warp's threads read at once fall in distinct banks.
//   - The tiles (PLAN_TILES): 128 x 64 (128 threads) and 64 x 64 (64
//     threads), 16 deep in k, 4 stages; and 40 x 200 (125 threads), 8 deep,
//     6 stages, which covers p = r = 200 exactly, k included, in 5 blocks
//     a task, where 128 x 64 covered it as 256 x 256 (61 % of the outputs
//     real) and padded k to 208. `gemm_plan` takes, of the tiles whose grid
//     gives every SM a block, the one of least padded area, the first on a
//     tie; where none does, 64 x 64. 40 x 200, wider than tall, counts
//     only where the r columns fit in one of its blocks: at (16, 1000,
//     1000) its 8-deep stages took 0.973 ms against 128 x 64's 0.871
//     (H100 80GB HBM3, 700 W), though it pads 4.6 % less. So p = 200 from
//     27 tasks takes 40 x 200; p = r = 1024 takes 128 x 64 at m = 16 (2048
//     blocks, three resident per SM at 168 registers a thread; faster on
//     the H100 than 128 x 128, of which one block of 8 warps fits an SM)
//     and 64 x 64 at m = 1 (256 blocks, where 128 x 64 leaves SMs idle);
//     p = 256 takes 128 x 64, which covers it exactly, and p = 300 64 x 64
//     (0.570 ms at m = 300 against 128 x 64's 0.618). `ops.py` keeps a
//     copy of the rule and of PLAN_TILES for its tests; `fista_gemm_plan`
//     and `fista_gemm_tiles` return these. At
//     (1024, 200, 200) the step took 0.586 ms against 0.785 with 128 x 64
//     (H100 80GB HBM3, 700 W): 40 x 200 ran faster than 200 x 40, whose
//     epilogue writes 160-byte pieces of rows (0.632), and 8 deep in 6
//     stages faster than 16 deep in 3 (0.606) or 4 (0.702).
//   - No split-K: every output is one FMA chain over k = 0 .. p - 1 in
//     order from 0, as in the first version of this kernel, so the result
//     is the same bits whatever tile is chosen, and deterministic.
//   What holds it back: at p = 1024 it reaches about 58 % of the f32 peak
//   at m = 16, where cuBLAS's `bmm` reaches 75 % (`chip_smoke.py` phase
//   5); the loop's instructions are nearly all FFMA, so the rest is issue
//   stalls that the compiled loop does not hide (latency with 12 warps a
//   SM, register bank conflicts; not measured: the card's profilers do
//   not run where it was built). At p = 200 the bytes and the FMAs take
//   about as long as each other and overlap only in part: the step with
//   no FMAs took 0.43 ms (2.3 TB/s), the one without the epilogue's reads
//   0.54, the whole 0.59 to 0.61 (bmm(Sigma, Z) alone 0.59). Prefetching
//   the epilogue's c, z, x into L2 during the last k-stages, streaming
//   them through the ring behind the k-stages, and persistent blocks
//   that load the next tile while the last one finishes were all slower.
//   The gradient step, soft threshold and momentum run in the epilogue on
//   the accumulator registers, four columns at a time where r % 4 == 0.
//
// Every edge is masked, so any p and r work (zero-filled past p and r;
// zeros add nothing to the FMA chain). The epilogue rounds each operation
// on its own (__fmul_rn, no FMA contraction), as the plain PyTorch version
// does.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Sigma's rows are read once per launch: their loads skip L1 (they still
// go through L2), so that they do not push z_t, which every warp of the
// SM reads, out of it.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// The proximal step of one output, x' = soft(z - eta (acc - c), tau), and
// the momentum z' = x' + theta (x' - x), each operation rounded on its own.
__device__ __forceinline__ float prox(float acc, float c, float z, float eta,
                                      float tau) {
  const float v = __fsub_rn(z, __fmul_rn(eta, __fsub_rn(acc, c)));
  const float mag = fmaxf(__fsub_rn(fabsf(v), tau), 0.f);
  return v > 0.f ? mag : (v < 0.f ? -mag : 0.f);
}

__device__ __forceinline__ float momentum(float xv, float x, float theta) {
  return __fadd_rn(xv, __fmul_rn(theta, __fsub_rn(xv, x)));
}

// Output element o of task t: x' into xn[o] and, with MOMENTUM, z' into
// zn[o] (x read from xp[o]). Without MOMENTUM xp and zn are never touched.
template <bool MOMENTUM>
__device__ __forceinline__ void epilogue(float acc, float c, float z,
                                         const float* __restrict__ xp,
                                         float eta, float tau, float theta,
                                         float* __restrict__ xn,
                                         float* __restrict__ zn, size_t o) {
  const float xv = prox(acc, c, z, eta, tau);
  xn[o] = xv;
  if constexpr (MOMENTUM) zn[o] = momentum(xv, xp[o], theta);
}

// ---- r == 1: batched GEMV ---------------------------------------------------

constexpr int GV_MAX_THREADS = 256;
constexpr int GV_LOADS = 8;          // float4 (or float) loads a lane has in
                                     // flight: GV_LOADS / ROWS steps ahead

// The launch plans, first choice first (GV_PLANS in ops.py agrees): rows
// per warp and warps per block. `gemv_plan` takes the first whose grid
// gives every SM GV_BLOCKS_PER_SM blocks, else the last.
constexpr int GV_PLANS[][2] = {{4, 8}, {2, 8}, {1, 8}, {1, 4}, {1, 2}};
constexpr int GV_NPLANS = sizeof(GV_PLANS) / sizeof(GV_PLANS[0]);
constexpr int GV_BLOCKS_PER_SM = 4;

// s + <a, b>, four FMAs in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Each warp owns ROWS consecutive rows of Sigma_t; the block is blockDim.x
// / 32 such warps and shares nothing, so no barrier. Lane l reads z_t and
// the rows at float4 q = l, l + 32, ... (floats where !VEC) and runs one
// FMA chain per row in that order; the loads of GV_LOADS / ROWS steps are
// issued before their FMAs. A shuffle tree ends each row (every lane ends
// with the same sum) and lane rr applies the epilogue of row rr, whose c,
// z, x, eta and lam it loaded before the loop.
template <int ROWS, bool VEC, bool MOMENTUM>
__global__ void __launch_bounds__(GV_MAX_THREADS)
fista_gemv_kernel(const float* __restrict__ Sig, const float* __restrict__ Z,
                  const float* __restrict__ Xp, const float* __restrict__ C,
                  const float* __restrict__ eta, const float* __restrict__ lam,
                  float theta, float* __restrict__ Xn, float* __restrict__ Zn,
                  int p) {
  constexpr int U = GV_LOADS / ROWS;   // steps whose loads go out together
  constexpr int W = VEC ? 4 : 1;
  using V = typename std::conditional<VEC, float4, float>::type;
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * ROWS;
  if (row0 >= p) return;                      // whole warps only
  const int nrows = min(ROWS, p - row0);
  const V* zv = reinterpret_cast<const V*>(Z + (size_t)t * p);
  const V* rows[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
    rows[rr] = reinterpret_cast<const V*>(
        Sig + ((size_t)t * p + row0 + min(rr, nrows - 1)) * p);

  // the epilogue's operands, early: lane rr holds row rr's
  const size_t o = (size_t)t * p + row0 + min(lane, nrows - 1);
  float c_o = 0.f, z_o = 0.f, x_o = 0.f, e = 0.f, l = 0.f;
  if (lane < nrows) {
    c_o = C[o];
    z_o = Z[o];
    if constexpr (MOMENTUM) x_o = Xp[o];
    e = eta[t];
    l = lam[t];
  }

  const int pv = p / W;
  float acc[ROWS] = {};
  int q = lane;
  for (; q + 32 * (U - 1) < pv; q += 32 * U) {
    V a[U][ROWS], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      b[u] = zv[q + 32 * u];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
        a[u][rr] = ld_stream(rows[rr] + q + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        if constexpr (VEC) acc[rr] = dot4(a[u][rr], b[u], acc[rr]);
        else acc[rr] = fmaf(a[u][rr], b[u], acc[rr]);
      }
  }
  for (; q < pv; q += 32) {
    const V b = zv[q];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      if constexpr (VEC) acc[rr] = dot4(ld_stream(rows[rr] + q), b, acc[rr]);
      else acc[rr] = fmaf(ld_stream(rows[rr] + q), b, acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], off);

  if (lane < nrows) {
    float a = acc[0];
#pragma unroll
    for (int rr = 1; rr < ROWS; ++rr)
      if (lane == rr) a = acc[rr];
    const float xv = prox(a, c_o, z_o, e, __fmul_rn(e, l));
    Xn[o] = xv;
    if constexpr (MOMENTUM) Zn[o] = momentum(xv, x_o, theta);
  }
}

// ---- r == 1 over a lambda grid: k problems a task share its Sigma ---------

constexpr int GV_LAMS = 8;           // chains a row: lambdas a pass

// The xor tree above over NV sums at once (NV a power of two up to 32):
// each step halves the sums a lane keeps and sends the other half to its
// partner, so lane l ends with sum l / (32 / NV) and then finishes it as
// the tree does. Every addition has the operands the tree gives it (at the
// step of offset `off` both lanes add a[l] and a[l ^ off]), so the sums
// have the tree's bits, in 31 shuffles where NV trees take 5 NV.
template <int H, int OFF, int NV>
__device__ __forceinline__ void scatter_steps(float (&v)[NV], int lane) {
  if constexpr (H >= 1) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    scatter_steps<H / 2, OFF / 2>(v, lane);
  }
}

template <int NV>
__device__ __forceinline__ float tree_scatter(float (&v)[NV], int lane) {
  scatter_steps<NV / 2, 16>(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = 16 / NV; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The FISTA step of a lambda grid: problem j * m + t is task t at lam[j],
// with Sigma_t, c_t and eta_t its task's (m, p, p), (m, p) and (m,) and z,
// x, x', z' (k, m, p). Each warp streams its ROWS rows of Sigma_t once a
// pass, as `fista_gemv_kernel` does, and runs K = GV_LAMS chains a row,
// one per lambda of the pass, against z_{j, t} read through L1; a pass
// takes K of the k lambdas, so Sigma_t is read ceil(k / K) times, and a
// pass of fewer runs its last lambda again in the spare chains (k >= 2:
// one lambda takes the r == 1 kernel). Every (row, j)
// chain is the r == 1 kernel's chain for problem j * m + t, in its order,
// and `tree_scatter` adds the lanes in its tree's order, so every output
// has the bits of the r == 1 kernel on Sigma, c and eta tiled k times.
// Lane l ends with chain i = l / (32 / (K ROWS)), (j, rr) = (i / ROWS,
// i % ROWS), and applies its epilogue. Rows of more than 64 float4 (p >
// 256), or of floats (p not a multiple of 4), take this kernel; the
// others the next.
template <int ROWS, bool VEC>
__global__ void __launch_bounds__(GV_MAX_THREADS, 2)
fista_gemv_kernel_lams(const float* __restrict__ Sig,
                       const float* __restrict__ Z,
                       const float* __restrict__ Xp,
                       const float* __restrict__ C,
                       const float* __restrict__ eta,
                       const float* __restrict__ lam, float theta,
                       float* __restrict__ Xn, float* __restrict__ Zn, int m,
                       int p, int k) {
  // steps a batch: one row a warp takes half the r == 1 kernel's, since
  // its K chains' iterates are loaded too
  constexpr int U = GV_LOADS / (ROWS > 1 ? ROWS : 2);
  constexpr int W = VEC ? 4 : 1;
  constexpr int K = GV_LAMS, NV = K * ROWS;
  constexpr int SPREAD = 32 / NV;     // lanes that end with each chain
  using V = typename std::conditional<VEC, float4, float>::type;
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * ROWS;
  if (row0 >= p) return;                      // whole warps only
  const int nrows = min(ROWS, p - row0);
  const V* rows[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
    rows[rr] = reinterpret_cast<const V*>(
        Sig + ((size_t)t * p + row0 + min(rr, nrows - 1)) * p);
  const size_t plane = (size_t)m * p;         // one lambda's iterates
  const size_t task = (size_t)t * p;
  const int iv = lane / SPREAD, jv = iv / ROWS, rv = iv % ROWS;
  const bool owner = lane % SPREAD == 0 && rv < nrows;
  const float c_o = owner ? C[task + row0 + rv] : 0.f;
  const float e = eta[t];
  const int pv = p / W;

  for (int j0 = 0; j0 < k; j0 += K) {
    const int nj = min(K, k - j0);
    // z_{j0 + j, t} at zt[j * zstride]; a pass short of K lambdas runs
    // its last one again in the chains past nj
    const V* zt = reinterpret_cast<const V*>(Z + j0 * plane + task);
    const size_t zstride = plane / W;
    // the epilogue's operands, early
    const bool writes = owner && jv < nj;
    const size_t o = (j0 + min(jv, nj - 1)) * plane + task + row0 + rv;
    float z_o = 0.f, x_o = 0.f, l = 0.f;
    if (writes) {
      z_o = Z[o];
      x_o = Xp[o];
      l = lam[j0 + jv];
    }

    // U steps a lane at once, each only where it lies inside the row, so
    // that a short row (p = 200: two steps a lane) is one round of loads
    float acc[NV] = {};               // chain j * ROWS + rr
    for (int q = lane; q < pv; q += 32 * U) {
      V a[U][ROWS];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (q + 32 * u < pv)
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
            a[u][rr] = ld_stream(rows[rr] + q + 32 * u);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (q + 32 * u < pv)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const V b = zt[min(j, nj - 1) * zstride + q + 32 * u];
#pragma unroll
            for (int rr = 0; rr < ROWS; ++rr) {
              float& s = acc[j * ROWS + rr];
              if constexpr (VEC) s = dot4(a[u][rr], b, s);
              else s = fmaf(a[u][rr], b, s);
            }
          }
    }

    const float sum = tree_scatter<NV>(acc, lane);
    if (writes) {
      const float xv = prox(sum, c_o, z_o, e, __fmul_rn(e, l));
      Xn[o] = xv;
      Zn[o] = momentum(xv, x_o, theta);
    }
  }
}

// The rows of one group of the short-row kernel below, at STEPS steps a
// lane, and the epilogue's operands of the output its lane owns
template <int ROWS, int STEPS>
struct GridRows {
  float4 a[STEPS][ROWS];
  float c, z, x;
};

// Group rows row0 .. row0 + ROWS of Sigma_t into d, and where lane owns an
// output row0 + rv of the pass, that output's c, z and x
template <int ROWS, int STEPS>
__device__ __forceinline__ void grid_load(GridRows<ROWS, STEPS>& d,
                                          const float* __restrict__ St,
                                          int row0, int p, int pv, int lane,
                                          bool own, int rv,
                                          const float* __restrict__ C,
                                          const float* __restrict__ Z,
                                          const float* __restrict__ Xp,
                                          size_t task, size_t out) {
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const float4* row = reinterpret_cast<const float4*>(
        St + (size_t)min(row0 + rr, p - 1) * p);
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      if (lane + 32 * s < pv) d.a[s][rr] = ld_stream(row + lane + 32 * s);
  }
  if (own && row0 + rv < p) {
    d.c = C[task + row0 + rv];
    d.z = Z[out + row0 + rv];
    d.x = Xp[out + row0 + rv];
  }
}

// The K ROWS chains of a group against the pass's iterates in shared
// memory, the tree, and the epilogue of the output the lane owns
template <int ROWS, int STEPS>
__device__ __forceinline__ void grid_rows(const GridRows<ROWS, STEPS>& d,
                                          const float4 (*zs)[32 * STEPS],
                                          int row0, int p, int pv, int lane,
                                          bool own, int rv, float e,
                                          float tau, float theta,
                                          float* __restrict__ Xn,
                                          float* __restrict__ Zn,
                                          size_t out) {
  constexpr int K = GV_LAMS, NV = K * ROWS;
  float acc[NV] = {};                 // chain j * ROWS + rr
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    if (lane + 32 * s < pv)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float4 b = zs[j][lane + 32 * s];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          acc[j * ROWS + rr] = dot4(d.a[s][rr], b, acc[j * ROWS + rr]);
      }
  const float sum = tree_scatter<NV>(acc, lane);
  if (own && row0 + rv < p) {
    const float xv = prox(sum, d.c, d.z, e, tau);
    Xn[out + row0 + rv] = xv;
    Zn[out + row0 + rv] = momentum(xv, d.x, theta);
  }
}

// The same step where a row is at most STEPS float4 a lane (p <= 256, a
// multiple of 4). There a warp is done with its rows after one round of
// loads and a short burst of FMAs, and the kernel above, one round a
// warp, reached 35 % of the bound at p = 200, k = 8 (93 % at p = 4096).
// So each warp takes G turns of ROWS rows of Sigma_t (turn g: rows
// base + (g warps + w) ROWS; past p a warp computes clamped rows and
// writes nothing, so that every warp of a block takes the same turns),
// loading a turn's Sigma while it computes the one before, and the pass's
// K iterates of the task (K p floats) are copied into shared memory once,
// where the chains read them. The chains, the tree and so the bits are
// the kernel's above.
template <int ROWS, int STEPS>
__global__ void __launch_bounds__(GV_MAX_THREADS, 2)
fista_gemv_kernel_lams_staged(const float* __restrict__ Sig,
                              const float* __restrict__ Z,
                              const float* __restrict__ Xp,
                              const float* __restrict__ C,
                              const float* __restrict__ eta,
                              const float* __restrict__ lam, float theta,
                              float* __restrict__ Xn, float* __restrict__ Zn,
                              int m, int p, int k, int G) {
  constexpr int K = GV_LAMS, NV = K * ROWS;
  constexpr int SPREAD = 32 / NV;     // lanes that end with each chain
  __shared__ float4 zs[K][32 * STEPS];  // z_{j0 + j, t} of the pass
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int span = blockDim.x / 32 * ROWS;    // rows of a turn of the block
  const int base = blockIdx.x * G * span;
  const int first = base + threadIdx.x / 32 * ROWS;
  const int turns = min(G, (p - base + span - 1) / span);
  const int pv = p / 4;
  const size_t plane = (size_t)m * p;         // one lambda's iterates
  const size_t task = (size_t)t * p;
  const float* St = Sig + task * p;
  const int iv = lane / SPREAD, jv = iv / ROWS, rv = iv % ROWS;
  const float e = eta[t];

  for (int j0 = 0; j0 < k; j0 += K) {
    const int nj = min(K, k - j0);
    const bool own = lane % SPREAD == 0 && jv < nj;
    const float tau = own ? __fmul_rn(e, lam[j0 + jv]) : 0.f;
    const size_t out = (j0 + min(jv, nj - 1)) * plane + task;
    // a pass short of K lambdas runs its last one again in the chains
    // past nj
    const float4* zt = reinterpret_cast<const float4*>(Z + j0 * plane + task);
    __syncthreads();                  // the last pass's reads of zs are done
#pragma unroll
    for (int j = 0; j < K; ++j)
      for (int i = threadIdx.x; i < pv; i += blockDim.x)
        zs[j][i] = zt[min(j, nj - 1) * (plane / 4) + i];
    __syncthreads();

    GridRows<ROWS, STEPS> A, B;
    grid_load(A, St, first, p, pv, lane, own, rv, C, Z, Xp, task, out);
    for (int g = 0; g < turns; g += 2) {
      const int r0 = first + g * span, r1 = r0 + span, r2 = r1 + span;
      if (g + 1 < turns)
        grid_load(B, St, r1, p, pv, lane, own, rv, C, Z, Xp, task, out);
      grid_rows(A, zs, r0, p, pv, lane, own, rv, e, tau, theta, Xn, Zn, out);
      if (g + 2 < turns)
        grid_load(A, St, r2, p, pv, lane, own, rv, C, Z, Xp, task, out);
      if (g + 1 < turns)
        grid_rows(B, zs, r1, p, pv, lane, own, rv, e, tau, theta, Xn, Zn,
                  out);
    }
  }
}

// ---- r > 1: batched SGEMM ---------------------------------------------------

constexpr int TILE = 8;            // register tile per thread, TILE x TILE

// A block tile BM x BN, and its ring: STAGES shared-memory stages, each BK
// deep in k
template <int BM, int BN, int BK, int STAGES>
struct GemmTile {
  static_assert(BM % TILE == 0 && BN % TILE == 0,
                "a tile is whole 8 x 8 register tiles");
  static_assert(BK == 8 || BK == 16, "a row of a stage is 2 or 4 float4");
  static constexpr int TX = BN / TILE;          // threads along j
  static constexpr int TY = BM / TILE;          // threads along i
  static constexpr int THREADS = TX * TY;
  static constexpr int A_FLOATS = BM * BK;      // Sigma[i0 + i, k0 + k]
  static constexpr int B_FLOATS = BK * BN;      // z[k0 + k, j0 + j]
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (VEC) or 4 bytes from global to shared memory, asynchronously;
// zeros where `in` is false (src-size 0, the source is not read)
template <bool VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  if constexpr (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Where Sigma's (i, k) of a stage lives: row i holds BK floats as BK / 4
// 16-byte chunks, chunk k / 4 stored at position (k / 4) ^ (i / 4) modulo
// BK / 4
template <int BK>
__device__ __forceinline__ int a_index(int i, int k) {
  return i * BK + ((((k >> 2) ^ (i >> 2)) & (BK / 4 - 1)) << 2) + (k & 3);
}

// One stage: Sigma[i0 .. i0 + BM, k0 .. k0 + BK) and z[k0 .. k0 + BK,
// j0 .. j0 + BN) of task t into As / Bs, zero past p and r. Copy c of
// COPIES goes to thread c % THREADS; where THREADS does not divide COPIES
// (a 40 x 200 tile has 125 threads) the last round is guarded.
template <int BM, int BN, int BK, int STAGES, bool VEC>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* __restrict__ St,
                                           const float* __restrict__ Zt,
                                           int i0, int j0, int k0, int p,
                                           int r, int tid) {
  using G = GemmTile<BM, BN, BK, STAGES>;
  constexpr int W = VEC ? 4 : 1;                // floats per copy
  constexpr int A_COPIES = G::A_FLOATS / W, B_COPIES = G::B_FLOATS / W;
#pragma unroll
  for (int l = 0; l < (A_COPIES + G::THREADS - 1) / G::THREADS; ++l) {
    const int c = tid + l * G::THREADS;
    if (A_COPIES % G::THREADS != 0 && c >= A_COPIES) break;
    const int i = c * W / BK, k = c * W % BK;
    const bool in = i0 + i < p && k0 + k < p;
    cp_async<VEC>(As + a_index<BK>(i, k),
                  in ? St + (size_t)(i0 + i) * p + k0 + k : St, in);
  }
#pragma unroll
  for (int l = 0; l < (B_COPIES + G::THREADS - 1) / G::THREADS; ++l) {
    const int c = tid + l * G::THREADS;
    if (B_COPIES % G::THREADS != 0 && c >= B_COPIES) break;
    const int k = c * W / BN, j = c * W % BN;
    const bool in = k0 + k < p && j0 + j < r;
    cp_async<VEC>(Bs + c * W, in ? Zt + (size_t)(k0 + k) * r + j0 + j : Zt,
                  in);
  }
}

template <int BM, int BN, int BK, int STAGES, bool VEC, bool MOMENTUM>
__global__ void __launch_bounds__(GemmTile<BM, BN, BK, STAGES>::THREADS)
fista_gemm_kernel(const float* __restrict__ Sig, const float* __restrict__ Z,
                  const float* __restrict__ Xp, const float* __restrict__ C,
                  const float* __restrict__ eta, const float* __restrict__ lam,
                  float theta, float* __restrict__ Xn, float* __restrict__ Zn,
                  int p, int r) {
  using G = GemmTile<BM, BN, BK, STAGES>;
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.z;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const float* St = Sig + (size_t)t * p * p;
  const float* Zt = Z + (size_t)t * p * r;

  const int tid = threadIdx.x;
  const int tx = tid % G::TX;
  const int ty = tid / G::TX;
  float acc[TILE][TILE] = {};

  const int kts = (p + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kts) {
      float* As = smem + s * G::STAGE_FLOATS;
      load_stage<BM, BN, BK, STAGES, VEC>(As, As + G::A_FLOATS, St, Zt, i0,
                                          j0, s * BK, p, r, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<STAGES - 2>();     // this stage's copies have landed
    __syncthreads();                 // and every thread is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < kts) {
      float* As = smem + (next % STAGES) * G::STAGE_FLOATS;
      load_stage<BM, BN, BK, STAGES, VEC>(As, As + G::A_FLOATS, St, Zt, i0,
                                          j0, next * BK, p, r, tid);
    }
    cp_async_commit();

    const float* As = smem + (kt % STAGES) * G::STAGE_FLOATS;
    const float* Bs = As + G::A_FLOATS;
#pragma unroll
    for (int kc = 0; kc < BK / 4; ++kc) {
      // rows 4 ty + q and BM/2 + 4 ty + q, k = 4 kc .. 4 kc + 3
      float4 a[TILE];
#pragma unroll
      for (int q = 0; q < TILE; ++q) {
        const int i = (q < 4 ? 0 : BM / 2) + 4 * ty + (q & 3);
        a[q] = *reinterpret_cast<const float4*>(As + a_index<BK>(i, 4 * kc));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (4 * kc + kk) * BN + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
        const float b[TILE] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int q = 0; q < TILE; ++q) {
          const float av = kk == 0 ? a[q].x : kk == 1 ? a[q].y
                         : kk == 2 ? a[q].z : a[q].w;
#pragma unroll
          for (int s = 0; s < TILE; ++s) acc[q][s] = fmaf(av, b[s], acc[q][s]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float e = eta[t];
  const float tau = __fmul_rn(e, lam[t]);
#pragma unroll
  for (int q = 0; q < TILE; ++q) {
    const int i = i0 + (q < 4 ? 0 : BM / 2) + 4 * ty + (q & 3);
    if (i >= p) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * (BN / 2) + 4 * tx;
      const size_t o = ((size_t)t * p + i) * r + j;
      if constexpr (VEC) {
        if (j >= r) continue;                    // r % 4 == 0: all four in
        const float4 c4 = *reinterpret_cast<const float4*>(C + o);
        const float4 z4 = *reinterpret_cast<const float4*>(Z + o);
        float4 x4;
        x4.x = prox(acc[q][4 * h], c4.x, z4.x, e, tau);
        x4.y = prox(acc[q][4 * h + 1], c4.y, z4.y, e, tau);
        x4.z = prox(acc[q][4 * h + 2], c4.z, z4.z, e, tau);
        x4.w = prox(acc[q][4 * h + 3], c4.w, z4.w, e, tau);
        *reinterpret_cast<float4*>(Xn + o) = x4;
        if constexpr (MOMENTUM) {
          const float4 p4 = *reinterpret_cast<const float4*>(Xp + o);
          *reinterpret_cast<float4*>(Zn + o) = make_float4(
              momentum(x4.x, p4.x, theta), momentum(x4.y, p4.y, theta),
              momentum(x4.z, p4.z, theta), momentum(x4.w, p4.w, theta));
        }
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (j + s < r)
            epilogue<MOMENTUM>(acc[q][4 * h + s], C[o + s], Z[o + s], Xp, e, tau, theta,
                               Xn, Zn, o + s);
      }
    }
  }
}

// The block tiles, larger blocks first (GEMM_TILES in ops.py is the same
// table; `fista_gemm_tiles` below lets a card test hold them equal):
// {bm, bn, bk, stages}. 40 x 200 covers the paper's p = r = 200 with no
// padding, k included.
constexpr int PLAN_TILES[][4] = {
    {128, 64, 16, 4}, {40, 200, 8, 6}, {64, 64, 16, 4}};
constexpr int N_TILES = sizeof(PLAN_TILES) / sizeof(PLAN_TILES[0]);

// The block tile for (m, p, r) on a card with `sms` SMs, an index into
// PLAN_TILES (`gemm_plan` in ops.py is the same rule): of the tiles whose
// grid gives every SM a block, the one of least padded area
// ceil(p / bm) bm x ceil(r / bn) bn, the first on a tie; where none does,
// the last, the smallest block. A short-row tile (bn > bm) counts only
// where the r columns fit in one of its blocks.
int gemm_plan(int m, int p, int r, int sms) {
  int best = N_TILES - 1;
  long long best_area = -1;
  for (int i = 0; i < N_TILES; ++i) {
    const long long rows = (p + PLAN_TILES[i][0] - 1) / PLAN_TILES[i][0];
    const long long cols = (r + PLAN_TILES[i][1] - 1) / PLAN_TILES[i][1];
    if (m * rows * cols < sms) continue;
    if (PLAN_TILES[i][1] > PLAN_TILES[i][0] && cols > 1) continue;
    const long long area = rows * PLAN_TILES[i][0] * cols * PLAN_TILES[i][1];
    if (best_area < 0 || area < best_area) {
      best = i;
      best_area = area;
    }
  }
  return best;
}

int device_sms(int device) {
  static int sms[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (sms[device] == 0)
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                           device);
  return sms[device];
}

template <int BM, int BN, int BK, int STAGES, bool VEC, bool MOMENTUM>
cudaError_t launch_tile(const float* const* in, float theta, float* Xn,
                        float* Zn, int m, int p, int r, cudaStream_t s) {
  using G = GemmTile<BM, BN, BK, STAGES>;
  auto kernel = fista_gemm_kernel<BM, BN, BK, STAGES, VEC, MOMENTUM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + BN - 1) / BN, (p + BM - 1) / BM, m);
  kernel<<<grid, G::THREADS, G::SMEM, s>>>(in[0], in[1], in[2], in[3], in[4],
                                           in[5], theta, Xn, Zn, p, r);
  return cudaGetLastError();
}

// The instance of PLAN_TILES[tile], tile >= I
template <bool VEC, bool MOMENTUM, int I = 0>
cudaError_t launch_plan(int tile, const float* const* in, float theta,
                        float* Xn, float* Zn, int m, int p, int r,
                        cudaStream_t s) {
  if constexpr (I + 1 < N_TILES)
    if (tile != I)
      return launch_plan<VEC, MOMENTUM, I + 1>(tile, in, theta, Xn, Zn, m, p,
                                               r, s);
  return launch_tile<PLAN_TILES[I][0], PLAN_TILES[I][1], PLAN_TILES[I][2],
                     PLAN_TILES[I][3], VEC, MOMENTUM>(in, theta, Xn, Zn, m, p,
                                                      r, s);
}

// The GEMV's plan for (m, p) on a card with `sms` SMs: an index into
// GV_PLANS (`gemv_plan` in ops.py is the same rule).
int gemv_plan(int m, int p, int sms) {
  for (int i = 0; i < GV_NPLANS; ++i) {
    const int rows_per_block = GV_PLANS[i][0] * GV_PLANS[i][1];
    const long long blocks =
        (long long)m * ((p + rows_per_block - 1) / rows_per_block);
    if (blocks >= (long long)GV_BLOCKS_PER_SM * sms) return i;
  }
  return GV_NPLANS - 1;
}

template <int ROWS, bool MOMENTUM>
void launch_gemv_rows(bool vec, int warps, const float* const* in,
                      float theta, float* Xn, float* Zn, int m, int p,
                      cudaStream_t s) {
  const int rows_per_block = ROWS * warps;
  const dim3 grid((p + rows_per_block - 1) / rows_per_block, m);
  if (vec)
    fista_gemv_kernel<ROWS, true, MOMENTUM><<<grid, 32 * warps, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], theta, Xn, Zn, p);
  else
    fista_gemv_kernel<ROWS, false, MOMENTUM><<<grid, 32 * warps, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], theta, Xn, Zn, p);
}

// `forced` is an index into GV_PLANS, or -1 for `gemv_plan`'s choice.
template <bool MOMENTUM>
int launch_gemv(const void* Sig, const void* Z, const void* Xp,
                const void* C, const void* eta, const void* lam, float theta,
                void* Xn, void* Zn, int m, int p, int device, void* stream,
                int forced) {
  if (forced < -1 || forced >= GV_NPLANS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int plan = forced < 0 ? gemv_plan(m, p, sms) : forced;
  const int rows = GV_PLANS[plan][0], warps = GV_PLANS[plan][1];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(Sig) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Z) % 16 == 0;
  const float* in[6] = {
      static_cast<const float*>(Sig), static_cast<const float*>(Z),
      static_cast<const float*>(Xp), static_cast<const float*>(C),
      static_cast<const float*>(eta), static_cast<const float*>(lam)};
  float* xn = static_cast<float*>(Xn);
  float* zn = static_cast<float*>(Zn);
  if (rows == 4)
    launch_gemv_rows<4, MOMENTUM>(vec, warps, in, theta, xn, zn, m, p, s);
  else if (rows == 2)
    launch_gemv_rows<2, MOMENTUM>(vec, warps, in, theta, xn, zn, m, p, s);
  else
    launch_gemv_rows<1, MOMENTUM>(vec, warps, in, theta, xn, zn, m, p, s);
  return static_cast<int>(cudaGetLastError());
}

// Turns of the short-row kernel's warps: as many as still leave the grid
// GV_BLOCKS_PER_SM blocks an SM (one block a task at most)
int grid_turns(int m, int p, int rows, int warps, int sms) {
  const int turns = (p + rows * warps - 1) / (rows * warps);
  for (int g = turns; g > 1; --g)
    if ((long long)m * ((turns + g - 1) / g) >=
        (long long)GV_BLOCKS_PER_SM * sms)
      return g;
  return 1;
}

template <int ROWS>
void launch_lams_rows(bool vec, int warps, const float* const* in,
                      float theta, float* Xn, float* Zn, int m, int p, int k,
                      int sms, cudaStream_t s) {
  if (vec && p <= 4 * 64) {           // a row is at most 2 float4 a lane
    const int G = grid_turns(m, p, ROWS, warps, sms);
    const dim3 grid((p + ROWS * warps * G - 1) / (ROWS * warps * G), m);
    auto kernel = p <= 4 * 32 ? fista_gemv_kernel_lams_staged<ROWS, 1>
                              : fista_gemv_kernel_lams_staged<ROWS, 2>;
    kernel<<<grid, 32 * warps, 0, s>>>(in[0], in[1], in[2], in[3], in[4],
                                       in[5], theta, Xn, Zn, m, p, k, G);
    return;
  }
  const dim3 grid((p + ROWS * warps - 1) / (ROWS * warps), m);
  if (vec)
    fista_gemv_kernel_lams<ROWS, true><<<grid, 32 * warps, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], theta, Xn, Zn, m, p, k);
  else
    fista_gemv_kernel_lams<ROWS, false><<<grid, 32 * warps, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], theta, Xn, Zn, m, p, k);
}

// `forced` is an index into GV_PLANS, or -1 for `gemv_plan`'s choice at
// (m, p): rows a warp and warps a block, as for the r == 1 kernel. k >= 2:
// one lambda is the r == 1 kernel's problem (`launch_gemv`).
int launch_gemv_grid(const void* Sig, const void* Z, const void* Xp,
                     const void* C, const void* eta, const void* lam,
                     float theta, void* Xn, void* Zn, int m, int p, int k,
                     int device, void* stream, int forced) {
  if (forced < -1 || forced >= GV_NPLANS || k < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int plan = forced < 0 ? gemv_plan(m, p, sms) : forced;
  const int rows = GV_PLANS[plan][0], warps = GV_PLANS[plan][1];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(Sig) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Z) % 16 == 0;
  const float* in[6] = {
      static_cast<const float*>(Sig), static_cast<const float*>(Z),
      static_cast<const float*>(Xp), static_cast<const float*>(C),
      static_cast<const float*>(eta), static_cast<const float*>(lam)};
  float* xn = static_cast<float*>(Xn);
  float* zn = static_cast<float*>(Zn);
  if (rows == 4)
    launch_lams_rows<4>(vec, warps, in, theta, xn, zn, m, p, k, sms, s);
  else if (rows == 2)
    launch_lams_rows<2>(vec, warps, in, theta, xn, zn, m, p, k, sms, s);
  else
    launch_lams_rows<1>(vec, warps, in, theta, xn, zn, m, p, k, sms, s);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// `forced` is an index into PLAN_TILES, or -1 for `gemm_plan`'s choice.
template <bool MOMENTUM>
int launch_gemm(const void* Sig, const void* Z, const void* Xp,
                const void* C, const void* eta, const void* lam, float theta,
                void* Xn, void* Zn, int m, int p, int r, int device,
                void* stream, int forced) {
  if (forced < -1 || forced >= N_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tile = forced < 0 ? gemm_plan(m, p, r, sms) : forced;
  // 16-byte copies need every row of Sigma and z, and every operand, on a
  // 16-byte boundary
  const bool vec = p % 4 == 0 && r % 4 == 0 && aligned16(Sig) &&
                   aligned16(Z) && aligned16(C) && aligned16(Xn) &&
                   (!MOMENTUM || (aligned16(Xp) && aligned16(Zn)));
  const float* in[6] = {
      static_cast<const float*>(Sig), static_cast<const float*>(Z),
      static_cast<const float*>(Xp), static_cast<const float*>(C),
      static_cast<const float*>(eta), static_cast<const float*>(lam)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xn = static_cast<float*>(Xn);
  float* zn = static_cast<float*>(Zn);
  return static_cast<int>(
      vec ? launch_plan<true, MOMENTUM>(tile, in, theta, xn, zn, m, p, r, s)
          : launch_plan<false, MOMENTUM>(tile, in, theta, xn, zn, m, p, r,
                                         s));
}

}  // namespace

// Every launch entry takes `plan` last: -1 for the launch plan its rule
// chooses, else the plan to launch (an index into GV_PLANS for the GEMV,
// into PLAN_TILES for the SGEMM); an index out of range returns
// cudaErrorInvalidValue and launches nothing. Every plan gives the same
// bits.

// Sigma (m, p, p); z, x, c (m, p); eta, lam (m,) -> x', z' (m, p).
extern "C" int fista_step_gemv_f32(const void* Sig, const void* Z,
                                   const void* Xp, const void* C,
                                   const void* eta, const void* lam,
                                   float theta, void* Xn, void* Zn, int m,
                                   int p, int device, void* stream,
                                   int plan) {
  return launch_gemv<true>(Sig, Z, Xp, C, eta, lam, theta, Xn, Zn, m, p,
                           device, stream, plan);
}

// The lambda grid's step, Sigma shared by k >= 2 problems a task: Sigma
// (m, p, p); z, x (k, m, p); c (m, p); eta (m,); lam (k,) -> x', z'
// (k, m, p).
extern "C" int fista_step_gemv_grid_f32(const void* Sig, const void* Z,
                                        const void* Xp, const void* C,
                                        const void* eta, const void* lam,
                                        float theta, void* Xn, void* Zn,
                                        int m, int p, int k, int device,
                                        void* stream, int plan) {
  return launch_gemv_grid(Sig, Z, Xp, C, eta, lam, theta, Xn, Zn, m, p, k,
                          device, stream, plan);
}

// Sigma (m, p, p); z, x, c (m, p, r); eta, lam (m,) -> x', z' (m, p, r).
extern "C" int fista_step_gemm_f32(const void* Sig, const void* Z,
                                   const void* Xp, const void* C,
                                   const void* eta, const void* lam,
                                   float theta, void* Xn, void* Zn, int m,
                                   int p, int r, int device, void* stream,
                                   int plan) {
  return launch_gemm<true>(Sig, Z, Xp, C, eta, lam, theta, Xn, Zn, m, p, r,
                           device, stream, plan);
}

// The ISTA step: Sigma (m, p, p); beta, c (m, p); eta, lam (m,) -> beta'
// (m, p), which must not alias beta.
extern "C" int ista_step_gemv_f32(const void* Sig, const void* B,
                                  const void* C, const void* eta,
                                  const void* lam, void* Out, int m, int p,
                                  int device, void* stream, int plan) {
  return launch_gemv<false>(Sig, B, nullptr, C, eta, lam, 0.f, Out, nullptr,
                            m, p, device, stream, plan);
}

// The ISTA step: Sigma (m, p, p); beta, c (m, p, r); eta, lam (m,) ->
// beta' (m, p, r), which must not alias beta.
extern "C" int ista_step_gemm_f32(const void* Sig, const void* B,
                                  const void* C, const void* eta,
                                  const void* lam, void* Out, int m, int p,
                                  int r, int device, void* stream,
                                  int plan) {
  return launch_gemm<false>(Sig, B, nullptr, C, eta, lam, 0.f, Out, nullptr,
                            m, p, r, device, stream, plan);
}

// The SGEMM's block tile for (m, p, r) on `device`: *bm, *bn and the SM
// count the rule saw, so that a test can hold `ops.gemm_plan` to it.
extern "C" int fista_gemm_plan(int m, int p, int r, int device, int* bm,
                               int* bn, int* sms) {
  *sms = device_sms(device);
  if (*sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tile = gemm_plan(m, p, r, *sms);
  *bm = PLAN_TILES[tile][0];
  *bn = PLAN_TILES[tile][1];
  return 0;
}

// The SGEMM's tile table, PLAN_TILES: its first `cap` rows of
// {bm, bn, bk, stages} into `out`, and the number of rows.
extern "C" int fista_gemm_tiles(int* out, int cap) {
  for (int i = 0; i < N_TILES && i < cap; ++i)
    for (int j = 0; j < 4; ++j) out[4 * i + j] = PLAN_TILES[i][j];
  return N_TILES;
}

// The GEMV's plan for (m, p) on `device`: rows per warp, warps per block
// and the SM count the rule saw, so that a test can hold `ops.gemv_plan`
// to it.
extern "C" int fista_gemv_plan(int m, int p, int device, int* rows,
                               int* warps, int* sms) {
  *sms = device_sms(device);
  if (*sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int plan = gemv_plan(m, p, *sms);
  *rows = GV_PLANS[plan][0];
  *warps = GV_PLANS[plan][1];
  return 0;
}
