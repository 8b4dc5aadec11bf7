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
// 0.03 ms for the 33.5 MB in and 67 MB out. This kernel computes every
// output tile, 2 m n p^2 = 17.2 GFLOP, twice that least work; computing
// only the upper tiles and mirroring them would halve it. The f32 parity
// bar (1e-5) rules out TF32 tensor cores, so every product is an FP32 FMA
// on the CUDA cores.
//
// Design. A shared-memory tiled SGEMM of A' B with A = W X and B = X, both
// read in their stored (sample, feature) layout, so every tile load is
// coalesced along the feature axis and needs no transpose. Each block owns
// one 128 x 128 output tile of one task; 256 threads hold an 8 x 8 register
// tile each (rows ty + 16 a, columns tx + 16 b: conflict-free shared reads,
// coalesced stores) and step over the samples 8 at a time. The TPU kernel
// carried its accumulators across a sequential sample axis of its grid;
// here the whole sample contraction is a loop inside the block, since
// blocks run in parallel and in no order. c needs the same weighted X
// tiles: the blocks of the first column of output tiles extend their loop
// by the y column (one more FMA per row per sample on 16 threads), so each
// c row has exactly one writer, with no atomics and no second pass over X.
// Every edge is masked, so any n and p work.
//
// The two-dispatch version, `rank_update_unfused_pallas` (same file, bodies
// `_sigma_only_kernel` and `_c_only_kernel`), is the reference's yardstick
// for the fused kernel; it streams X twice. Its Sigma-only launch is the
// tiled kernel below with the c column switched off (WITH_C = false). Its
// c-only launch is `rank_c_kernel`: c = X'Wy/n is a matrix-vector product
// bound by X's bytes (33.5 MB at (16, 512, 1024): 0.010 ms at 3.35 TB/s).
// Each block owns 128 features of one task: a warp reads a 512-byte row
// segment (one float4 per lane where p % 4 == 0), the 8 warps take every
// 8th sample, four samples in flight per warp, and the warps' partial sums
// meet in shared memory in warp order. No atomics, so the result is the
// same bits every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // output rows (feature i) per block
constexpr int BN = 128;            // output columns (feature j) per block
constexpr int BK = 8;              // samples per step
constexpr int TX = 16;             // threads along j
constexpr int TY = 16;             // threads along i
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;        // rows per thread
constexpr int RN = BN / TX;        // columns per thread
constexpr int LOADS = BK * BM / THREADS;

template <bool WEIGHTED, bool WITH_C>
__global__ void __launch_bounds__(THREADS)
rank_update_kernel(const float* __restrict__ X, const float* __restrict__ y,
                   const float* __restrict__ w, float* __restrict__ Sigma,
                   float* __restrict__ c, int n, int p) {
  const int t = blockIdx.z;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const bool with_c = WITH_C && blockIdx.x == 0;
  const float* Xt = X + (size_t)t * n * p;
  const float* yt = WITH_C ? y + (size_t)t * n : nullptr;
  const float* wt = WEIGHTED ? w + (size_t)t * n : nullptr;

  __shared__ float As[BK][BM];     // (w X)[k0 + kk, i0 + ii]
  __shared__ float Bs[BK][BN];     // X[k0 + kk, j0 + jj]
  __shared__ float ys[BK];         // y[k0 + kk]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[RM][RN] = {};
  float cacc[RM] = {};

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + THREADS * l;
      const int kk = idx / BM;
      const int col = idx % BM;
      const int k = k0 + kk;
      const int i = i0 + col;
      const int j = j0 + col;
      const bool kin = k < n;
      float a = (kin && i < p) ? Xt[(size_t)k * p + i] : 0.f;
      if (WEIGHTED && kin) a = a * wt[k];
      As[kk][col] = a;
      Bs[kk][col] = (kin && j < p) ? Xt[(size_t)k * p + j] : 0.f;
    }
    if (with_c && tid < BK) {
      const int k = k0 + tid;
      ys[tid] = k < n ? yt[k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = As[kk][ty + TY * r];
#pragma unroll
      for (int s = 0; s < RN; ++s) b[s] = Bs[kk][tx + TX * s];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int s = 0; s < RN; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
      if (with_c && tx == 0) {
        const float yk = ys[kk];
#pragma unroll
        for (int r = 0; r < RM; ++r) cacc[r] = fmaf(a[r], yk, cacc[r]);
      }
    }
    __syncthreads();
  }

  const float fn = (float)n;
  float* St = Sigma + (size_t)t * p * p;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + ty + TY * r;
    if (i >= p) continue;
#pragma unroll
    for (int s = 0; s < RN; ++s) {
      const int j = j0 + tx + TX * s;
      if (j < p) St[(size_t)i * p + j] = acc[r][s] / fn;
    }
    if (with_c && tx == 0) c[(size_t)t * p + i] = cacc[r] / fn;
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

template <bool WITH_C>
int launch_tiled(const void* X, const void* y, const void* w, void* Sigma,
                 void* c, int m, int n, int p, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((p + BN - 1) / BN, (p + BM - 1) / BM, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  float* Sf = static_cast<float*>(Sigma);
  float* cf = static_cast<float*>(c);
  if (wf != nullptr)
    rank_update_kernel<true, WITH_C>
        <<<grid, THREADS, 0, s>>>(Xf, yf, wf, Sf, cf, n, p);
  else
    rank_update_kernel<false, WITH_C>
        <<<grid, THREADS, 0, s>>>(Xf, yf, wf, Sf, cf, n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (m, n, p), y (m, n), w (m, n) or null -> Sigma (m, p, p), c (m, p).
// All float32, contiguous, on the device of `stream`.
extern "C" int rank_update_f32(const void* X, const void* y, const void* w,
                               void* Sigma, void* c, int m, int n, int p,
                               int device, void* stream) {
  return launch_tiled<true>(X, y, w, Sigma, c, m, n, p, device, stream);
}

// The unfused pair's first dispatch: X (m, n, p), w (m, n) or null ->
// Sigma (m, p, p).
extern "C" int rank_update_sigma_f32(const void* X, const void* w,
                                     void* Sigma, int m, int n, int p,
                                     int device, void* stream) {
  return launch_tiled<false>(X, nullptr, w, Sigma, nullptr, m, n, p, device,
                             stream);
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
