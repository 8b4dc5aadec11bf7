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
// * r > 1 (the debias solve, r = p, c = I): a batched matrix product, bound
//   by operations. At (m, p) = (16, 1024) one step is 2 m p^3 = 34.4 GFLOP
//   of f32 FMA, 0.51 ms at 67 TFLOP/s f32; the bytes (about 400 MB) take
//   0.12 ms. Full f32 rules out the TF32 tensor cores, so the kernel is an
//   SGEMM on the CUDA cores and what bounds it is the FMA issue rate: the
//   design keeps the FMA pipes fed.
//   - A ring of STAGES = 4 shared-memory stages, each 16 deep in k, filled
//     by 16-byte `cp.async.cg` (4-byte `cp.async.ca` where p or r is not a
//     multiple of 4 or an operand is not 16-byte aligned), with the loads
//     of the next three stages in flight while a stage's FMAs run; one
//     barrier per stage.
//   - Each thread owns an 8 x 8 register tile made of 4-wide groups: rows
//     4 ty + {0..3} and BM/2 + 4 ty + {0..3}, columns 4 tx + {0..3} and
//     BN/2 + 4 tx + {0..3}. Sigma's tile stays row-major in shared memory
//     (i-major, as cp.async copies it) and a thread reads four k values of
//     a row as one float4; z's tile is k-major and a thread reads four
//     columns as one float4. That is 4 LDS.128 per 64 FMA. The 16-byte
//     chunks of a Sigma row are XOR-swizzled by (row / 4) % 4, so the rows
//     that the warp's threads read at once fall in distinct banks.
//   - The block tile is chosen per launch by `gemm_plan`: 128 x 64 (128
//     threads) where m * tiles gives at least one block per SM, else
//     64 x 64 (64 threads). At m = 16, p = r = 1024 that is 2048 blocks of
//     128 x 64, three resident per SM (168 registers a thread); on the
//     H100 that ran faster than 128 x 128 tiles, of which one block of 8
//     warps fits an SM. At m = 1 it is 256 blocks of 64 x 64, where
//     128 x 128 left more than half of the 132 SMs idle. `ops.py` keeps a
//     copy of the rule for its tests; `fista_gemm_plan` returns this one.
//   - No split-K: every output is one FMA chain over k = 0 .. p - 1 in
//     order from 0, as in the first version of this kernel, so the result
//     is the same bits whatever tile is chosen, and deterministic.
//   What holds it back: it reaches about 58 % of the f32 peak at m = 16,
//   where cuBLAS's `bmm` reaches 75 % (`chip_smoke.py` phase 5); the
//   loop's instructions are nearly all FFMA, so the rest is issue stalls
//   that the compiled loop does not hide (latency with 12 warps a SM,
//   register bank conflicts; not measured: the card's profilers do not
//   run where it was built).
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

// ---- r > 1: batched SGEMM ---------------------------------------------------

constexpr int BK = 16;             // contraction depth per stage
constexpr int STAGES = 4;          // shared-memory ring
constexpr int TILE = 8;            // register tile per thread, TILE x TILE

template <int BM, int BN>
struct GemmTile {
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

// Where Sigma's (i, k) of a stage lives: row i holds BK floats as four
// 16-byte chunks, chunk k / 4 stored at position (k / 4) ^ ((i / 4) % 4)
__device__ __forceinline__ int a_index(int i, int k) {
  return i * BK + ((((k >> 2) ^ (i >> 2)) & 3) << 2) + (k & 3);
}

// One stage: Sigma[i0 .. i0 + BM, k0 .. k0 + BK) and z[k0 .. k0 + BK,
// j0 .. j0 + BN) of task t into As / Bs, zero past p and r
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* __restrict__ St,
                                           const float* __restrict__ Zt,
                                           int i0, int j0, int k0, int p,
                                           int r, int tid) {
  using G = GemmTile<BM, BN>;
  constexpr int W = VEC ? 4 : 1;                // floats per copy
#pragma unroll
  for (int l = 0; l < G::A_FLOATS / W / G::THREADS; ++l) {
    const int idx = (tid + l * G::THREADS) * W;
    const int i = idx / BK, k = idx % BK;
    const bool in = i0 + i < p && k0 + k < p;
    cp_async<VEC>(As + a_index(i, k),
                  in ? St + (size_t)(i0 + i) * p + k0 + k : St, in);
  }
#pragma unroll
  for (int l = 0; l < G::B_FLOATS / W / G::THREADS; ++l) {
    const int idx = (tid + l * G::THREADS) * W;
    const int k = idx / BN, j = idx % BN;
    const bool in = k0 + k < p && j0 + j < r;
    cp_async<VEC>(Bs + idx, in ? Zt + (size_t)(k0 + k) * r + j0 + j : Zt,
                  in);
  }
}

template <int BM, int BN, bool VEC, bool MOMENTUM>
__global__ void __launch_bounds__(GemmTile<BM, BN>::THREADS)
fista_gemm_kernel(const float* __restrict__ Sig, const float* __restrict__ Z,
                  const float* __restrict__ Xp, const float* __restrict__ C,
                  const float* __restrict__ eta, const float* __restrict__ lam,
                  float theta, float* __restrict__ Xn, float* __restrict__ Zn,
                  int p, int r) {
  using G = GemmTile<BM, BN>;
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
      load_stage<BM, BN, VEC>(As, As + G::A_FLOATS, St, Zt, i0, j0, s * BK,
                              p, r, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < kts; ++kt) {
    cp_async_wait<STAGES - 2>();     // this stage's copies have landed
    __syncthreads();                 // and every thread is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < kts) {
      float* As = smem + (next % STAGES) * G::STAGE_FLOATS;
      load_stage<BM, BN, VEC>(As, As + G::A_FLOATS, St, Zt, i0, j0,
                              next * BK, p, r, tid);
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
        a[q] = *reinterpret_cast<const float4*>(As + a_index(i, 4 * kc));
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

// The block tile for (m, p, r) on a card with `sms` SMs (`gemm_plan` in
// ops.py is the same rule): the larger tile where its grid has at least
// one block per SM, else the smaller. Returns 0 for 128 x 64, 1 for
// 64 x 64.
constexpr int PLAN_TILES[2][2] = {{128, 64}, {64, 64}};

int gemm_plan(int m, int p, int r, int sms) {
  const long long blocks = (long long)m *
                           ((p + PLAN_TILES[0][0] - 1) / PLAN_TILES[0][0]) *
                           ((r + PLAN_TILES[0][1] - 1) / PLAN_TILES[0][1]);
  return blocks >= sms ? 0 : 1;
}

int device_sms(int device) {
  static int sms[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (sms[device] == 0)
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                           device);
  return sms[device];
}

template <int BM, int BN, bool VEC, bool MOMENTUM>
cudaError_t launch_tile(const float* const* in, float theta, float* Xn,
                        float* Zn, int m, int p, int r, cudaStream_t s) {
  using G = GemmTile<BM, BN>;
  auto kernel = fista_gemm_kernel<BM, BN, VEC, MOMENTUM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + BN - 1) / BN, (p + BM - 1) / BM, m);
  kernel<<<grid, G::THREADS, G::SMEM, s>>>(in[0], in[1], in[2], in[3], in[4],
                                           in[5], theta, Xn, Zn, p, r);
  return cudaGetLastError();
}

template <bool VEC, bool MOMENTUM>
cudaError_t launch_plan(int tile, const float* const* in, float theta,
                        float* Xn, float* Zn, int m, int p, int r,
                        cudaStream_t s) {
  return tile == 0 ? launch_tile<128, 64, VEC, MOMENTUM>(in, theta, Xn, Zn,
                                                         m, p, r, s)
                   : launch_tile<64, 64, VEC, MOMENTUM>(in, theta, Xn, Zn, m,
                                                        p, r, s);
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

template <bool MOMENTUM>
int launch_gemv(const void* Sig, const void* Z, const void* Xp,
                const void* C, const void* eta, const void* lam, float theta,
                void* Xn, void* Zn, int m, int p, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int plan = gemv_plan(m, p, sms);
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

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool MOMENTUM>
int launch_gemm(const void* Sig, const void* Z, const void* Xp,
                const void* C, const void* eta, const void* lam, float theta,
                void* Xn, void* Zn, int m, int p, int r, int device,
                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tile = gemm_plan(m, p, r, sms);
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

// Sigma (m, p, p); z, x, c (m, p); eta, lam (m,) -> x', z' (m, p).
extern "C" int fista_step_gemv_f32(const void* Sig, const void* Z,
                                   const void* Xp, const void* C,
                                   const void* eta, const void* lam,
                                   float theta, void* Xn, void* Zn, int m,
                                   int p, int device, void* stream) {
  return launch_gemv<true>(Sig, Z, Xp, C, eta, lam, theta, Xn, Zn, m, p,
                           device, stream);
}

// Sigma (m, p, p); z, x, c (m, p, r); eta, lam (m,) -> x', z' (m, p, r).
extern "C" int fista_step_gemm_f32(const void* Sig, const void* Z,
                                   const void* Xp, const void* C,
                                   const void* eta, const void* lam,
                                   float theta, void* Xn, void* Zn, int m,
                                   int p, int r, int device, void* stream) {
  return launch_gemm<true>(Sig, Z, Xp, C, eta, lam, theta, Xn, Zn, m, p, r,
                           device, stream);
}

// The ISTA step: Sigma (m, p, p); beta, c (m, p); eta, lam (m,) -> beta'
// (m, p), which must not alias beta.
extern "C" int ista_step_gemv_f32(const void* Sig, const void* B,
                                  const void* C, const void* eta,
                                  const void* lam, void* Out, int m, int p,
                                  int device, void* stream) {
  return launch_gemv<false>(Sig, B, nullptr, C, eta, lam, 0.f, Out, nullptr,
                            m, p, device, stream);
}

// The ISTA step: Sigma (m, p, p); beta, c (m, p, r); eta, lam (m,) ->
// beta' (m, p, r), which must not alias beta.
extern "C" int ista_step_gemm_f32(const void* Sig, const void* B,
                                  const void* C, const void* eta,
                                  const void* lam, void* Out, int m, int p,
                                  int r, int device, void* stream) {
  return launch_gemm<false>(Sig, B, nullptr, C, eta, lam, 0.f, Out, nullptr,
                            m, p, r, device, stream);
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
