// Fused rank-n sufficient-statistics update for m tasks, in one launch:
//
//     Sigma_t = X_t' W_t X_t / n      (p, p)
//     c_t     = X_t' W_t y_t / n      (p,)
//
// Replaces `rank_update_pallas` (src/repro/kernels/rank_update/kernel.py,
// body `_rank_update_kernel`). X is (m, n, p) row-major, y and the optional
// weights w are (m, n). `w == nullptr` selects the unweighted
// specialization (no W stream, no multiply). The divisor is n, not sum(w).
//
// What bounds it on the H100: operations. Sigma is symmetric, so the least
// work at (m, n, p) = (16, 512, 1024) is its upper triangle and c,
// m n p (p + 1) + 2 m n p = 8.6 GFLOP: 0.13 ms at 67 TFLOP/s f32 against
// 0.03 ms for the 33.5 MB in and 67 MB out. The f32 parity bar (1e-5)
// rules out TF32 tensor cores, so every product is an FP32 FMA on the CUDA
// cores, and the design keeps the FMA pipes fed and computes no more than
// the upper tiles.
//
// Design (it replaces a first version that computed every output tile,
// 2 m n p^2 = 17.2 GFLOP, from scalar loads with two barriers per 8
// samples):
// - Only the upper tiles. The output is cut into square BT x BT tiles; one
//   block computes each tile (I, J) with I <= J of each task (the linear
//   block index maps to (t, I, J), row by row of the triangle). At
//   p = 1024 and BT = 128 that is 36 tiles a task in place of 64:
//   9.7 GFLOP. An off-diagonal tile writes its accumulators to
//   Sigma[I, J] and their transpose to Sigma[J, I]; a diagonal tile
//   computes its whole square and writes the mirror of its upper half, so
//   Sigma comes out exactly symmetric. Both stores go through shared
//   memory (the ring is free after the main loop): the tile is staged
//   with its 16-byte chunks XOR-swizzled by (row / 4) % 8, so the row
//   reads of the direct store and the column reads of the transposed one
//   both fall in distinct banks, and both stores are coalesced rows of
//   16-byte writes (4-byte where p % 4 != 0).
// - Both operands are X in its stored (sample, feature) layout: each
//   stage holds X[k0 .. k0 + BK, i0 .. i0 + BT) and X[k0 .. k0 + BK,
//   j0 .. j0 + BT), k-major, and a thread reads 4 features of one sample
//   as one float4 (no swizzle needed). An unweighted diagonal tile loads
//   one of them.
// - A ring of STAGES = 4 stages, BK = 16 samples each, filled by 16-byte
//   `cp.async.cg` (4-byte `cp.async.ca` where p % 4 != 0 or X is not
//   16-byte aligned), the next three stages in flight while a stage's FMAs
//   run; one barrier per stage.
// - Each thread owns an RT x RT register tile of float4 groups: rows
//   g SPAN + 4 ty + {0..3}, columns g SPAN + 4 tx + {0..3}, SPAN = BT / (RT
//   / 4). RT = 8 is 4 LDS.128 per 64 FMA.
// - Weights: the row operand is __fmul_rn(x_ki, w_k), rounded before its
//   FMA. cp.async cannot scale in flight, so after a stage lands each
//   thread scales the row-tile floats it copied itself, before the stage's
//   barrier: one multiply per float per block, not one per float per
//   thread as on the register fragments. A weighted diagonal tile loads
//   its column tile too, unscaled. The unweighted specialization has no
//   W stream.
// - c on the diagonal blocks: block (I, I) extends its sample loop by the
//   y column (one more FMA per row per sample on the tx == 0 threads), so
//   each row of c has one writer, with no atomics.
// - The tile is chosen per launch by `rank_plan` (`ops.py` keeps a copy of
//   the rule for its tests; `rank_update_plan` returns this one): 128 x 128
//   (RT = 8, 256 threads, two blocks an SM) where the triangle grid has a
//   block for every SM, else 32 x 32 (RT = 4, 64 threads). At
//   (16, 512, 1024) that is 576 blocks of 128; at the streaming ingest's
//   (8, 1024, 256), 128-tiles would give 24 blocks for 132 SMs, so it
//   runs 288 of 32. A 64 x 64 tile (RT = 8, 64 threads) lost to one of
//   the two at every shape measured, so it is not built.
// - No split-K: every output is one FMA chain over k = 0 .. n - 1 in order
//   from 0, then divided by n, as in the first version. fmaf(a, b, acc)
//   equals fmaf(b, a, acc), so unweighted Sigma and c, and weighted c and
//   the upper triangle, are the first version's bits; its weighted lower
//   triangle, (w x_kj) x_ki, is now the mirror (w x_ki) x_kj. Every tile
//   size gives the same bits.
// Every edge is masked (zero-filled past n and p), so any n and p work.
//
// The two-dispatch version, `rank_update_unfused_pallas` (same file, bodies
// `_sigma_only_kernel` and `_c_only_kernel`), is the reference's yardstick
// for the fused kernel; it streams X twice. Its Sigma-only launch is the
// tiled kernel below with the c column switched off (WITH_C = false), so
// its Sigma is bitwise the fused kernel's. Its c-only launch is
// `rank_c_kernel`: c = X'Wy/n is a matrix-vector product bound by X's
// bytes (33.5 MB at (16, 512, 1024): 0.010 ms at 3.35 TB/s). Each block
// owns 128 features of one task: a warp reads a 512-byte row segment (one
// float4 per lane where p % 4 == 0), the 8 warps take every 8th sample,
// four samples in flight per warp, and the warps' partial sums meet in
// shared memory in warp order. No atomics, so the result is the same bits
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;             // samples per stage
constexpr int STAGES = 4;          // shared-memory ring

template <int BT, int RT>
struct RankTile {
  static constexpr int TPS = BT / RT;           // threads per side
  static constexpr int THREADS = TPS * TPS;
  // two 8-warp blocks of the large tile an SM (at most 128 registers a
  // thread) ran faster than one
  static constexpr int MIN_BLOCKS = BT == 128 ? 2 : 1;
  static constexpr int SPAN = BT / (RT / 4);    // rows between float4 groups
  static constexpr int CHUNKS = BT / 4;         // 16-byte chunks in a row
  static constexpr int X_FLOATS = BK * BT;      // X[k0 + k, f0 + f], k-major
  static constexpr int STAGE_FLOATS = 2 * X_FLOATS + BK;   // and y
  static constexpr int RING = STAGES * STAGE_FLOATS;
  static constexpr int FLOATS = RING > BT * BT ? RING : BT * BT;
  static constexpr int SMEM = FLOATS * (int)sizeof(float);
  static_assert(CHUNKS % 8 == 0, "the staging swizzle needs 8 chunks a row");
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

// Where the staged output tile keeps (row r, chunk c4): chunk c4 of row r
// at position c4 ^ ((r / 4) % 8)
template <int BT>
__device__ __forceinline__ int stage_index(int r, int c4) {
  return r * BT + ((c4 ^ ((r >> 2) & 7)) << 2);
}

// Tile (I, J), I <= J, of the triangle of T x T tiles that upper block u
// (0 <= u < T (T + 1) / 2) computes: row I of the triangle holds T - I
// tiles
__device__ __forceinline__ void triangle_tile(int u, int T, int& I, int& J) {
  I = 0;
  while (u >= T - I) {
    u -= T - I;
    ++I;
  }
  J = I + u;
}

// X[k0 .. k0 + BK, f0 .. f0 + BT) of one task into Xs (k-major), zero past
// n and p. A thread copies 4 neighbouring floats of a row per step: one
// 16-byte copy (VEC) or four 4-byte ones.
template <int BT, int RT, bool VEC>
__device__ __forceinline__ void load_x(float* Xs, const float* __restrict__ Xt,
                                       int f0, int k0, int n, int p,
                                       int tid) {
  using G = RankTile<BT, RT>;
#pragma unroll
  for (int l = 0; l < G::X_FLOATS / 4 / G::THREADS; ++l) {
    const int idx = (tid + l * G::THREADS) * 4;
    const int k = idx / BT, f = f0 + idx % BT;
    const bool kin = k0 + k < n;
    const float* row = Xt + (size_t)(k0 + k) * p;
    if constexpr (VEC) {
      const bool in = kin && f < p;             // p % 4 == 0: all four in
      cp_async<true>(Xs + idx, in ? row + f : Xt, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = kin && f + e < p;
        cp_async<false>(Xs + idx + e, in ? row + f + e : Xt, in);
      }
    }
  }
}

// One stage: X's two column tiles (one on an unweighted diagonal tile,
// whose two operands are the same), and y where c is computed
template <int BT, int RT, bool VEC, bool WEIGHTED>
__device__ __forceinline__ void load_stage(
    float* st, const float* __restrict__ Xt, const float* __restrict__ yt,
    int i0, int j0, bool diag, bool with_c, int k0, int n, int p, int tid) {
  using G = RankTile<BT, RT>;
  load_x<BT, RT, VEC>(st, Xt, i0, k0, n, p, tid);
  if (WEIGHTED || !diag)
    load_x<BT, RT, VEC>(st + G::X_FLOATS, Xt, j0, k0, n, p, tid);
  if (with_c && tid < BK) {
    const bool in = k0 + tid < n;
    cp_async<false>(st + 2 * G::X_FLOATS + tid, in ? yt + k0 + tid : yt, in);
  }
}

// The weights, on the floats of a landed row tile that this thread copied
// itself (its own copies are complete after cp.async.wait_group, and the
// barrier that follows publishes the products): x <- x w_k, rounded as
// __fmul_rn. Rows past n stay zero.
template <int BT, int RT>
__device__ __forceinline__ void weigh_own(float* Xs,
                                          const float* __restrict__ wt,
                                          int k0, int n, int tid) {
  using G = RankTile<BT, RT>;
  constexpr int L = G::X_FLOATS / 4 / G::THREADS;
  float wk[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int k = (tid + l * G::THREADS) * 4 / BT;
    wk[l] = k0 + k < n ? __ldg(wt + k0 + k) : 0.f;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float4* x = reinterpret_cast<float4*>(Xs + (tid + l * G::THREADS) * 4);
    const float4 v = *x;
    *x = make_float4(__fmul_rn(v.x, wk[l]), __fmul_rn(v.y, wk[l]),
                     __fmul_rn(v.z, wk[l]), __fmul_rn(v.w, wk[l]));
  }
}

template <int BT, int RT, bool VEC, bool WEIGHTED, bool WITH_C>
__global__ void __launch_bounds__(RankTile<BT, RT>::THREADS,
                                  RankTile<BT, RT>::MIN_BLOCKS)
rank_update_kernel(const float* __restrict__ X, const float* __restrict__ y,
                   const float* __restrict__ w, float* __restrict__ Sigma,
                   float* __restrict__ c, int n, int p) {
  using G = RankTile<BT, RT>;
  extern __shared__ __align__(16) float smem[];
  const int T = (p + BT - 1) / BT;
  const int per_task = T * (T + 1) / 2;
  const int t = blockIdx.x / per_task;
  int I, J;
  triangle_tile(blockIdx.x % per_task, T, I, J);
  const int i0 = I * BT, j0 = J * BT;
  const bool diag = I == J;
  const bool with_c = WITH_C && diag;
  const float* Xt = X + (size_t)t * n * p;
  const float* yt = WITH_C ? y + (size_t)t * n : nullptr;
  const float* wt = WEIGHTED ? w + (size_t)t * n : nullptr;

  const int tid = threadIdx.x;
  const int tx = tid % G::TPS;
  const int ty = tid / G::TPS;
  float acc[RT][RT] = {};
  float cacc[RT] = {};

  const int kts = (n + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kts)
      load_stage<BT, RT, VEC, WEIGHTED>(smem + s * G::STAGE_FLOATS, Xt, yt,
                                        i0, j0, diag, with_c, s * BK, n, p,
                                        tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < kts; ++kt) {
    float* Xi = smem + (kt % STAGES) * G::STAGE_FLOATS;
    cp_async_wait<STAGES - 2>();     // this stage's copies have landed
    if constexpr (WEIGHTED) weigh_own<BT, RT>(Xi, wt, kt * BK, n, tid);
    __syncthreads();                 // and every thread is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < kts)
      load_stage<BT, RT, VEC, WEIGHTED>(
          smem + (next % STAGES) * G::STAGE_FLOATS, Xt, yt, i0, j0, diag,
          with_c, next * BK, n, p, tid);
    cp_async_commit();

    const float* Xj = diag && !WEIGHTED ? Xi : Xi + G::X_FLOATS;
    const float* ys = Xi + 2 * G::X_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RT], b[RT];
#pragma unroll
      for (int g = 0; g < RT / 4; ++g) {
        const float4 av = *reinterpret_cast<const float4*>(
            Xi + kk * BT + g * G::SPAN + 4 * ty);
        const float4 bv = *reinterpret_cast<const float4*>(
            Xj + kk * BT + g * G::SPAN + 4 * tx);
        a[4 * g] = av.x, a[4 * g + 1] = av.y, a[4 * g + 2] = av.z,
        a[4 * g + 3] = av.w;
        b[4 * g] = bv.x, b[4 * g + 1] = bv.y, b[4 * g + 2] = bv.z,
        b[4 * g + 3] = bv.w;
      }
#pragma unroll
      for (int q = 0; q < RT; ++q)
#pragma unroll
        for (int s = 0; s < RT; ++s) acc[q][s] = fmaf(a[q], b[s], acc[q][s]);
      if (with_c && tx == 0) {
        const float yk = ys[kk];
#pragma unroll
        for (int q = 0; q < RT; ++q) cacc[q] = fmaf(a[q], yk, cacc[q]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: stage the tile

  const float fn = (float)n;
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int r = (q / 4) * G::SPAN + 4 * ty + (q & 3);
#pragma unroll
    for (int g = 0; g < RT / 4; ++g)
      *reinterpret_cast<float4*>(
          smem + stage_index<BT>(r, (g * G::SPAN) / 4 + tx)) =
          make_float4(acc[q][4 * g] / fn, acc[q][4 * g + 1] / fn,
                      acc[q][4 * g + 2] / fn, acc[q][4 * g + 3] / fn);
    if (with_c && tx == 0 && i0 + r < p)
      c[(size_t)t * p + i0 + r] = cacc[q] / fn;
  }
  __syncthreads();

  float* St = Sigma + (size_t)t * p * p;
  // rows of tile (I, J) as staged; on a diagonal tile the chunks above the
  // diagonal as staged, the one across it mirrored element by element, and
  // those below it left to the transposed store
  for (int idx = tid; idx < BT * G::CHUNKS; idx += G::THREADS) {
    const int r = idx / G::CHUNKS, c4 = idx % G::CHUNKS;
    const int i = i0 + r, j = j0 + 4 * c4;
    if (i >= p || j >= p || (diag && c4 < r / 4)) continue;
    float4 v = *reinterpret_cast<const float4*>(smem + stage_index<BT>(r, c4));
    if (diag && c4 == r / 4) {
      float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c4 + u < r)
          e[u] = smem[stage_index<BT>(4 * c4 + u, c4) + (r & 3)];
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    float* out = St + (size_t)i * p + j;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(out) = v;     // p % 4 == 0: all four in
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + u < p) out[u] = e[u];
    }
  }
  // the transpose: 4 x 4 blocks of tile (I, J) into Sigma[J, I]; on a
  // diagonal tile only those strictly below its diagonal
  for (int idx = tid; idx < G::CHUNKS * G::CHUNKS; idx += G::THREADS) {
    const int ig = idx % G::CHUNKS, jg = idx / G::CHUNKS;
    const int i = i0 + 4 * ig;
    if (i >= p || j0 + 4 * jg >= p || (diag && jg <= ig)) continue;
    float4 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = *reinterpret_cast<const float4*>(
          smem + stage_index<BT>(4 * ig + e, jg));
    const float col[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x},
                             {v[0].y, v[1].y, v[2].y, v[3].y},
                             {v[0].z, v[1].z, v[2].z, v[3].z},
                             {v[0].w, v[1].w, v[2].w, v[3].w}};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 4 * jg + u;
      if (j >= p) continue;
      float* out = St + (size_t)j * p + i;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(out) =
            make_float4(col[u][0], col[u][1], col[u][2], col[u][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i + e < p) out[e] = col[u][e];
      }
    }
  }
}

// ---- c alone: X'Wy/n ------------------------------------------------------

constexpr int CW = 8;              // warps per block, each its own samples
constexpr int CTILE = 128;         // features per block: 4 per lane
constexpr int CUNROLL = 4;         // samples in flight per warp

template <bool WEIGHTED, bool VEC>
__global__ void __launch_bounds__(32 * CW)
rank_c_kernel(const float* __restrict__ X, const float* __restrict__ y,
              const float* __restrict__ w, float* __restrict__ c, int n,
              int p) {
  const int t = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f0 = blockIdx.x * CTILE + 4 * lane;    // this lane's 4 features
  const float* Xt = X + (size_t)t * n * p;
  const float* yt = y + (size_t)t * n;
  const float* wt = WEIGHTED ? w + (size_t)t * n : nullptr;

  float acc[4] = {};
  for (int k0 = warp; k0 < n; k0 += CW * CUNROLL) {
    float xv[CUNROLL][4];
    float yv[CUNROLL];
    float wv[CUNROLL];
#pragma unroll
    for (int u = 0; u < CUNROLL; ++u) {
      const int k = k0 + u * CW;
      const bool kin = k < n;
      yv[u] = kin ? yt[k] : 0.f;
      wv[u] = (WEIGHTED && kin) ? wt[k] : 1.f;
      const float* row = Xt + (size_t)k * p;
      if (VEC) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kin && f0 < p) a = *reinterpret_cast<const float4*>(row + f0);
        xv[u][0] = a.x;
        xv[u][1] = a.y;
        xv[u][2] = a.z;
        xv[u][3] = a.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[u][q] = (kin && f0 + q < p) ? row[f0 + q] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < CUNROLL; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // the fused kernel's rounding: (w x) rounded, then one FMA with y
        const float a = WEIGHTED ? __fmul_rn(xv[u][q], wv[u]) : xv[u][q];
        acc[q] = fmaf(a, yv[u], acc[q]);
      }
  }

  __shared__ float part[CW][CTILE];
#pragma unroll
  for (int q = 0; q < 4; ++q) part[warp][4 * lane + q] = acc[q];
  __syncthreads();
  const int i = blockIdx.x * CTILE + threadIdx.x;
  if (threadIdx.x < CTILE && i < p) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < CW; ++q) sum += part[q][threadIdx.x];
    c[(size_t)t * p + i] = sum / (float)n;
  }
}

// The block tile for (m, p) on a card with `sms` SMs (`rank_plan` in
// ops.py is the same rule): 128 x 128 where its triangle grid,
// m T (T + 1) / 2 blocks with T = ceil(p / 128), has at least one block
// per SM, else 32 x 32. Returns the index into PLAN_TILES.
constexpr int PLAN_TILES[2] = {128, 32};

long long triangle_blocks(int m, int p, int bt) {
  const long long T = (p + bt - 1) / bt;
  return (long long)m * T * (T + 1) / 2;
}

int rank_plan(int m, int p, int sms) {
  return triangle_blocks(m, p, PLAN_TILES[0]) >= sms ? 0 : 1;
}

int device_sms(int device) {
  static int sms[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (sms[device] == 0)
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                           device);
  return sms[device];
}

template <int BT, int RT, bool VEC, bool WITH_C>
cudaError_t launch_tile(const float* X, const float* y, const float* w,
                        float* Sigma, float* c, int m, int n, int p,
                        cudaStream_t s) {
  using G = RankTile<BT, RT>;
  auto kernel = w != nullptr ? rank_update_kernel<BT, RT, VEC, true, WITH_C>
                             : rank_update_kernel<BT, RT, VEC, false, WITH_C>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = triangle_blocks(m, p, BT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, G::THREADS, G::SMEM, s>>>(X, y, w, Sigma, c, n,
                                                       p);
  return cudaGetLastError();
}

template <bool VEC, bool WITH_C>
cudaError_t launch_plan(int tile, const float* X, const float* y,
                        const float* w, float* Sigma, float* c, int m, int n,
                        int p, cudaStream_t s) {
  return tile == 0
             ? launch_tile<128, 8, VEC, WITH_C>(X, y, w, Sigma, c, m, n, p, s)
             : launch_tile<32, 4, VEC, WITH_C>(X, y, w, Sigma, c, m, n, p, s);
}

// `forced` is an index into PLAN_TILES, or -1 for `rank_plan`'s choice.
template <bool WITH_C>
int launch_tiled(const void* X, const void* y, const void* w, void* Sigma,
                 void* c, int m, int n, int p, int device, void* stream,
                 int forced) {
  if (forced < -1 || forced >= 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tile = forced < 0 ? rank_plan(m, p, sms) : forced;
  // 16-byte copies and stores need every row of X and Sigma on a 16-byte
  // boundary
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Sigma) % 16 == 0;
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  float* Sf = static_cast<float*>(Sigma);
  float* cf = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_plan<true, WITH_C>(tile, Xf, yf, wf, Sf, cf, m, n, p, s)
          : launch_plan<false, WITH_C>(tile, Xf, yf, wf, Sf, cf, m, n, p, s));
}

}  // namespace

// The two tiled entries take `plan` last: -1 for `rank_plan`'s tile, else
// the index into PLAN_TILES of the tile to launch (out of range:
// cudaErrorInvalidValue, nothing launched). Every tile gives the same bits.

// X (m, n, p), y (m, n), w (m, n) or null -> Sigma (m, p, p), c (m, p).
// All float32, contiguous, on the device of `stream`.
extern "C" int rank_update_f32(const void* X, const void* y, const void* w,
                               void* Sigma, void* c, int m, int n, int p,
                               int device, void* stream, int plan) {
  return launch_tiled<true>(X, y, w, Sigma, c, m, n, p, device, stream,
                            plan);
}

// The unfused pair's first dispatch: X (m, n, p), w (m, n) or null ->
// Sigma (m, p, p).
extern "C" int rank_update_sigma_f32(const void* X, const void* w,
                                     void* Sigma, int m, int n, int p,
                                     int device, void* stream, int plan) {
  return launch_tiled<false>(X, nullptr, w, Sigma, nullptr, m, n, p, device,
                             stream, plan);
}

// The unfused pair's second dispatch: X (m, n, p), y (m, n), w (m, n) or
// null -> c (m, p).
extern "C" int rank_update_c_f32(const void* X, const void* y, const void* w,
                                 void* c, int m, int n, int p, int device,
                                 void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((p + CTILE - 1) / CTILE, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  float* cf = static_cast<float*>(c);
  if (wf != nullptr) {
    if (vec)
      rank_c_kernel<true, true><<<grid, 32 * CW, 0, s>>>(Xf, yf, wf, cf, n, p);
    else
      rank_c_kernel<true, false><<<grid, 32 * CW, 0, s>>>(Xf, yf, wf, cf, n, p);
  } else {
    if (vec)
      rank_c_kernel<false, true><<<grid, 32 * CW, 0, s>>>(Xf, yf, wf, cf, n, p);
    else
      rank_c_kernel<false, false><<<grid, 32 * CW, 0, s>>>(Xf, yf, wf, cf, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused kernel's block tile for (m, p) on `device`: *tile (BT), *blocks
// and the SM count the rule saw, so that a test can hold `ops.rank_plan` to
// it.
extern "C" int rank_update_plan(int m, int p, int device, int* tile,
                                int* blocks, int* sms) {
  *sms = device_sms(device);
  if (*sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int index = rank_plan(m, p, *sms);
  *tile = PLAN_TILES[index];
  *blocks = static_cast<int>(triangle_blocks(m, p, *tile));
  return 0;
}
