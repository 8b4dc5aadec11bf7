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
// * r == 1 (the m local lassos): a batched matrix-vector product, bound by
//   bytes. At (m, p) = (16, 1024) Sigma is 67 MB, more than the 50 MB L2,
//   so it streams from HBM on every iteration: 20 us at 3.35 TB/s against
//   33.5 MFLOP of work. Design: one warp per row, four rows per warp in
//   flight at once; each Sigma row is read once, coalesced, as float4 where
//   p % 4 == 0 (scalar otherwise); z_t is staged in shared memory in 16 KB
//   chunks and read by all eight warps of the block; a shuffle reduction
//   ends each row and lane 0 applies the epilogue.
//
// * r > 1 (the debias solve, r = p, c = I): a batched matrix product, bound
//   by operations. At (m, p) = (16, 1024) one step is 2 m p^3 = 34.4 GFLOP
//   of f32 FMA, 0.51 ms at 67 TFLOP/s f32; the bytes (about 400 MB) take
//   0.12 ms. The f32 parity bar rules out TF32 tensor cores. Design: a
//   shared-memory tiled SGEMM, 128 x 128 output tile per block, 8-deep
//   k-steps, an 8 x 8 register tile per thread (rows ty + 16 a, columns
//   tx + 16 b: conflict-free shared reads and coalesced epilogue accesses).
//   Sigma's tile is transposed into shared memory on load (rows padded by 4
//   floats against bank conflicts); z's tile is loaded as stored. The
//   gradient step, soft threshold and momentum run in the epilogue on the
//   accumulator registers.
//
// Every edge is masked, so any p and r work. The epilogue rounds each
// operation on its own (__fmul_rn, no FMA contraction), as the plain
// PyTorch version does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Output element o of task t: x' into xn[o] and, with MOMENTUM, z' into
// zn[o] (x read from xp[o]). Without MOMENTUM xp and zn are never touched.
template <bool MOMENTUM>
__device__ __forceinline__ void epilogue(float acc, float c, float z,
                                         const float* __restrict__ xp,
                                         float eta, float tau, float theta,
                                         float* __restrict__ xn,
                                         float* __restrict__ zn, size_t o) {
  const float v = __fsub_rn(z, __fmul_rn(eta, __fsub_rn(acc, c)));
  const float mag = fmaxf(__fsub_rn(fabsf(v), tau), 0.f);
  const float xv = v > 0.f ? mag : (v < 0.f ? -mag : 0.f);
  xn[o] = xv;
  if constexpr (MOMENTUM)
    zn[o] = __fadd_rn(xv, __fmul_rn(theta, __fsub_rn(xv, xp[o])));
}

// ---- r == 1: batched GEMV ---------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = 32 * GV_WARPS;
constexpr int GV_ROWS = 4;           // rows per warp, streamed together
constexpr int GV_CHUNK = 4096;       // floats of z_t staged per pass (16 KB)

template <bool VEC, bool MOMENTUM>
__global__ void __launch_bounds__(GV_THREADS)
fista_gemv_kernel(const float* __restrict__ Sig, const float* __restrict__ Z,
                  const float* __restrict__ Xp, const float* __restrict__ C,
                  const float* __restrict__ eta, const float* __restrict__ lam,
                  float theta, float* __restrict__ Xn, float* __restrict__ Zn,
                  int p) {
  const int t = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * GV_WARPS + warp) * GV_ROWS;
  const int nrows = min(GV_ROWS, p - row0);   // <= 0 past the last row
  const float* St = Sig + (size_t)t * p * p;
  const float* Zt = Z + (size_t)t * p;

  __shared__ __align__(16) float zs[GV_CHUNK];
  float acc[GV_ROWS] = {};

  for (int kc = 0; kc < p; kc += GV_CHUNK) {
    const int len = min(GV_CHUNK, p - kc);
    __syncthreads();
    for (int q = threadIdx.x; q < len; q += GV_THREADS) zs[q] = Zt[kc + q];
    __syncthreads();
    if (VEC) {
      const float4* z4 = reinterpret_cast<const float4*>(zs);
      for (int q = lane; q < len / 4; q += 32) {
        const float4 b = z4[q];
#pragma unroll
        for (int rr = 0; rr < GV_ROWS; ++rr) {
          if (rr < nrows) {
            const float4 a = reinterpret_cast<const float4*>(
                St + (size_t)(row0 + rr) * p + kc)[q];
            float s = acc[rr];
            s = fmaf(a.x, b.x, s);
            s = fmaf(a.y, b.y, s);
            s = fmaf(a.z, b.z, s);
            s = fmaf(a.w, b.w, s);
            acc[rr] = s;
          }
        }
      }
    } else {
      for (int q = lane; q < len; q += 32) {
        const float b = zs[q];
#pragma unroll
        for (int rr = 0; rr < GV_ROWS; ++rr)
          if (rr < nrows)
            acc[rr] = fmaf(St[(size_t)(row0 + rr) * p + kc + q], b, acc[rr]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < GV_ROWS; ++rr)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], off);

  if (lane == 0) {
    const float e = eta[t];
    const float tau = __fmul_rn(e, lam[t]);
#pragma unroll
    for (int rr = 0; rr < GV_ROWS; ++rr) {
      if (rr < nrows) {
        const size_t o = (size_t)t * p + row0 + rr;
        epilogue<MOMENTUM>(acc[rr], C[o], Z[o], Xp, e, tau, theta, Xn, Zn,
                           o);
      }
    }
  }
}

// ---- r > 1: batched SGEMM ---------------------------------------------------

constexpr int BM = 128;            // output rows (i) per block
constexpr int BN = 128;            // output columns (j) per block
constexpr int BK = 8;              // contraction depth per step
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;
constexpr int RN = BN / TX;
constexpr int LOADS = BK * BM / THREADS;
constexpr int APAD = 4;

template <bool MOMENTUM>
__global__ void __launch_bounds__(THREADS)
fista_gemm_kernel(const float* __restrict__ Sig, const float* __restrict__ Z,
                  const float* __restrict__ Xp, const float* __restrict__ C,
                  const float* __restrict__ eta, const float* __restrict__ lam,
                  float theta, float* __restrict__ Xn, float* __restrict__ Zn,
                  int p, int r) {
  const int t = blockIdx.z;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const float* St = Sig + (size_t)t * p * p;
  const float* Zt = Z + (size_t)t * p * r;

  __shared__ float As[BK][BM + APAD];   // Sigma[i0 + ii, k0 + kk]
  __shared__ float Bs[BK][BN];          // z[k0 + kk, j0 + jj]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  float acc[RM][RN] = {};

  for (int k0 = 0; k0 < p; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + THREADS * l;
      const int ii = idx / BK;
      const int kk = idx % BK;
      const int i = i0 + ii;
      const int k = k0 + kk;
      As[kk][ii] = (i < p && k < p) ? St[(size_t)i * p + k] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + THREADS * l;
      const int kk = idx / BN;
      const int jj = idx % BN;
      const int k = k0 + kk;
      const int j = j0 + jj;
      Bs[kk][jj] = (k < p && j < r) ? Zt[(size_t)k * r + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int q = 0; q < RM; ++q) a[q] = As[kk][ty + TY * q];
#pragma unroll
      for (int s = 0; s < RN; ++s) b[s] = Bs[kk][tx + TX * s];
#pragma unroll
      for (int q = 0; q < RM; ++q)
#pragma unroll
        for (int s = 0; s < RN; ++s) acc[q][s] = fmaf(a[q], b[s], acc[q][s]);
    }
    __syncthreads();
  }

  const float e = eta[t];
  const float tau = __fmul_rn(e, lam[t]);
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    const int i = i0 + ty + TY * q;
    if (i >= p) continue;
#pragma unroll
    for (int s = 0; s < RN; ++s) {
      const int j = j0 + tx + TX * s;
      if (j >= r) continue;
      const size_t o = ((size_t)t * p + i) * r + j;
      epilogue<MOMENTUM>(acc[q][s], C[o], Z[o], Xp, e, tau, theta, Xn, Zn,
                         o);
    }
  }
}

template <bool MOMENTUM>
int launch_gemv(const void* Sig, const void* Z, const void* Xp,
                const void* C, const void* eta, const void* lam, float theta,
                void* Xn, void* Zn, int m, int p, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int rows_per_block = GV_WARPS * GV_ROWS;
  const dim3 grid((p + rows_per_block - 1) / rows_per_block, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(Sig) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Z) % 16 == 0;
  const float* args[6] = {
      static_cast<const float*>(Sig), static_cast<const float*>(Z),
      static_cast<const float*>(Xp), static_cast<const float*>(C),
      static_cast<const float*>(eta), static_cast<const float*>(lam)};
  if (vec)
    fista_gemv_kernel<true, MOMENTUM><<<grid, GV_THREADS, 0, s>>>(
        args[0], args[1], args[2], args[3], args[4], args[5], theta,
        static_cast<float*>(Xn), static_cast<float*>(Zn), p);
  else
    fista_gemv_kernel<false, MOMENTUM><<<grid, GV_THREADS, 0, s>>>(
        args[0], args[1], args[2], args[3], args[4], args[5], theta,
        static_cast<float*>(Xn), static_cast<float*>(Zn), p);
  return static_cast<int>(cudaGetLastError());
}

template <bool MOMENTUM>
int launch_gemm(const void* Sig, const void* Z, const void* Xp,
                const void* C, const void* eta, const void* lam, float theta,
                void* Xn, void* Zn, int m, int p, int r, int device,
                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((r + BN - 1) / BN, (p + BM - 1) / BM, m);
  fista_gemm_kernel<MOMENTUM>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(Sig), static_cast<const float*>(Z),
          static_cast<const float*>(Xp), static_cast<const float*>(C),
          static_cast<const float*>(eta), static_cast<const float*>(lam),
          theta, static_cast<float*>(Xn), static_cast<float*>(Zn), p, r);
  return static_cast<int>(cudaGetLastError());
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
