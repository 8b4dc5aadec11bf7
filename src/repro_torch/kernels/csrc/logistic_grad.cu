// All-tasks logistic gradient for m tasks:
//
//     z_t = X_t b_t,   r_t = y_t * sigmoid(-y_t z_t),   g_t = -X_t' r_t / n
//
// X is (m, n, p) row-major, y (m, n) in {-1, +1}, B and g (m, p); float32.
//
// Replaces `logistic_grad_pallas` (src/repro/kernels/logistic_grad/
// kernel.py, bodies `_resident_grad_kernel` and `_tiled_grad_kernel`) with
// one fused kernel, and `logistic_grad_unfused_pallas` (bodies
// `_logistic_z_kernel` and `_backproject_kernel`) with two kernels whose
// residual is computed between them by the caller.
//
// What bounds it on the H100: bytes. The work is 4 m n p FLOP against
// 4 (m n p + m n + 2 m p) bytes, one FLOP per byte, far below the card's
// 20 f32 FLOP per HBM byte. At (m, n, p) = (16, 512, 1024) and
// (4, 256, 8192) X is 33.5 MB: 0.010 ms at 3.35 TB/s. So the design reads
// X from HBM once: the forward product and the back-projection use the
// same copy of each row.
//
// Fused design (`logistic_grad_kernel`). The TPU kernel carried its
// gradient accumulator across a sequential sample axis of its grid; Hopper's
// blocks run in parallel and in no order. Here block (c, t) owns a chunk of
// consecutive samples of task t, so a task's samples are spread over
// `chunks` blocks and the whole card is busy even at m = 4.
//
// * Slab height. A block walks its chunk in slabs of up to SLAB_MAX rows.
//   Where the slab fits, it is copied into shared memory beside b_t and the
//   block's gradient accumulator, (slab + 2) p floats in all; the host
//   (`kernels/logistic_grad/ops.py::plan`) picks the slab height from the
//   card's shared-memory limit per block (227 KB on the H100): up to half
//   of it, so that two blocks share an SM, or all of it where one row does
//   not fit in half. All 256 threads then take each row's dot product with
//   b_t (a strided partial per thread, a shuffle tree per warp, the eight
//   warp sums added in order), one thread per row applies the stable
//   sigmoid, and each thread adds r_k x_k into the accumulator columns it
//   owns, reading the rows from shared memory. X is read from HBM once.
// * Where even one row with b and the accumulator does not fit (12 p bytes
//   over the limit, p > 19,328 on the H100) the block reads its rows from
//   global memory twice, keeps b_t in global memory and accumulates straight
//   into its workspace row.
// * The sample reduction. Each block writes its partial gradient, one row
//   of p floats, into a workspace (m, chunks, p), fences, and takes a ticket
//   from a per-task counter. The block that draws the last ticket adds the
//   task's `chunks` partial rows in chunk order, scales by -1/n and writes
//   g_t, then resets the counter to 0 for the next launch. No block waits
//   for another. Every sum runs in a fixed order, so the result is the same
//   from run to run (deterministic). The host caps chunks * p so that this
//   one-block tail stays short (512 KB of partial rows per task).
//
// Unfused design. `logistic_z_kernel` is a batched matrix-vector product,
// one warp per sample row. `logistic_backproject_kernel` gives each block 32
// column vectors of one task; its eight warps take every eighth sample and
// their sums are added in warp order through shared memory, so it too is
// deterministic and needs no second pass. X is read once by each kernel,
// twice in all.
//
// Every edge is masked, so any n and p work; float4 loads where p % 4 == 0
// and the pointers are 16-byte aligned, scalar loads otherwise. All products
// are FP32 FMA (the f32 parity bar rules out TF32 tensor cores).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLAB_MAX = 8;        // rows per slab; ops.py SLAB_MAX agrees

__device__ __forceinline__ float sigmoid(float a) {
  if (a >= 0.f) return 1.f / (1.f + expf(-a));
  const float e = expf(a);
  return e / (1.f + e);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// s + <a, b>
__device__ __forceinline__ float fma_dot(float a, float b, float s) {
  return fmaf(a, b, s);
}
__device__ __forceinline__ float fma_dot(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// acc + x r
__device__ __forceinline__ float fma_axpy(float x, float r, float acc) {
  return fmaf(x, r, acc);
}
__device__ __forceinline__ float4 fma_axpy(float4 x, float r, float4 acc) {
  return make_float4(fmaf(x.x, r, acc.x), fmaf(x.y, r, acc.y),
                     fmaf(x.z, r, acc.z), fmaf(x.w, r, acc.w));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// -s / n, elementwise
__device__ __forceinline__ float neg_div(float s, float n) { return -s / n; }
__device__ __forceinline__ float4 neg_div(float4 s, float n) {
  return make_float4(-s.x / n, -s.y / n, -s.z / n, -s.w / n);
}

// ---- fused ------------------------------------------------------------------

template <bool STAGED, typename T>
__global__ void __launch_bounds__(THREADS)
logistic_grad_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ B, float* __restrict__ work,
                     unsigned int* __restrict__ counters,
                     float* __restrict__ G, int n, int p, int rows_per_chunk,
                     int slab) {
  constexpr int W = sizeof(T) / sizeof(float);
  const int t = blockIdx.y;
  const int c = blockIdx.x;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int pv = p / W;                       // vectors per row
  const int r0 = c * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const float* Xt = X + (size_t)t * n * p;
  const float* yt = y + (size_t)t * n;
  float* part = work + ((size_t)t * chunks + c) * p;

  extern __shared__ float4 smem4[];
  __shared__ float red[WARPS][SLAB_MAX];
  __shared__ float rs[SLAB_MAX];
  __shared__ bool last;

  // b_t and the accumulator: in shared memory after the slab, or in global
  // memory (the accumulator then is this block's workspace row). Each
  // thread owns the accumulator vectors q = tid + k THREADS throughout.
  const T* bv = reinterpret_cast<const T*>(B + (size_t)t * p);
  T* acc = reinterpret_cast<T*>(part);
  T* xbuf = reinterpret_cast<T*>(smem4);
  if (STAGED) {
    T* bs = xbuf + (size_t)slab * pv;
    acc = bs + pv;
    for (int q = tid; q < pv; q += THREADS) bs[q] = bv[q];
    bv = bs;
  }
  for (int q = tid; q < pv; q += THREADS) acc[q] = zero<T>();

  for (int row0 = r0; row0 < r1; row0 += slab) {
    const int R = min(slab, r1 - row0);
    const T* xg = reinterpret_cast<const T*>(Xt + (size_t)row0 * p);
    const T* xs = xg;
    __syncthreads();              // the previous slab's readers are done
    if (STAGED) {
      const int len = R * pv;     // the R rows are contiguous
      for (int q = tid; q < len; q += THREADS) xbuf[q] = xg[q];
      __syncthreads();
      xs = xbuf;
    }

    // z_k = <x_k, b_t> for the slab's rows, with all threads
    float zp[SLAB_MAX];
#pragma unroll
    for (int r = 0; r < SLAB_MAX; ++r) zp[r] = 0.f;
    for (int q = tid; q < pv; q += THREADS) {
      const T b = bv[q];
#pragma unroll
      for (int r = 0; r < SLAB_MAX; ++r)
        if (r < R) zp[r] = fma_dot(xs[(size_t)r * pv + q], b, zp[r]);
    }
#pragma unroll
    for (int r = 0; r < SLAB_MAX; ++r) {
      float v = zp[r];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r] = v;
    }
    __syncthreads();
    if (tid < R) {
      float z = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) z += red[w][tid];
      const float yk = yt[row0 + tid];
      rs[tid] = yk * sigmoid(-yk * z);
    }
    __syncthreads();

    // acc += sum_k r_k x_k over the slab, from the same copy of the rows
    for (int q = tid; q < pv; q += THREADS) {
      T a = acc[q];
      for (int r = 0; r < R; ++r) a = fma_axpy(xs[(size_t)r * pv + q], rs[r], a);
      acc[q] = a;
    }
  }

  if (STAGED) {
    T* pg = reinterpret_cast<T*>(part);
    for (int q = tid; q < pv; q += THREADS) pg[q] = acc[q];
  }
  // publish the partial row, then take a ticket; the last block of the
  // task reduces all partial rows in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(counters + t, 1u) == (unsigned int)(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const T* wt = reinterpret_cast<const T*>(work + (size_t)t * chunks * p);
  T* gt = reinterpret_cast<T*>(G + (size_t)t * p);
  const float fn = (float)n;
  for (int q = tid; q < pv; q += THREADS) {
    T s = zero<T>();
    for (int cc = 0; cc < chunks; ++cc) s = add(s, __ldcg(wt + (size_t)cc * pv + q));
    gt[q] = neg_div(s, fn);
  }
  if (tid == 0) counters[t] = 0u;
}

// ---- unfused: z = X b --------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
logistic_z_kernel(const float* __restrict__ X, const float* __restrict__ B,
                  float* __restrict__ Z, int n, int p) {
  constexpr int W = sizeof(T) / sizeof(float);
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;                  // whole warps only
  const int pv = p / W;
  const T* xr = reinterpret_cast<const T*>(X + ((size_t)t * n + row) * p);
  const T* b = reinterpret_cast<const T*>(B + (size_t)t * p);
  float s = 0.f;
  for (int q = lane; q < pv; q += 32) s = fma_dot(xr[q], b[q], s);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) Z[(size_t)t * n + row] = s;
}

// ---- unfused: g = -X' r / n --------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
logistic_backproject_kernel(const float* __restrict__ X,
                            const float* __restrict__ Rv,
                            float* __restrict__ G, int n, int p) {
  constexpr int W = sizeof(T) / sizeof(float);
  const int t = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int pv = p / W;
  const int q = blockIdx.x * 32 + lane;
  const bool in = q < pv;
  const T* xt = reinterpret_cast<const T*>(X + (size_t)t * n * p);
  const float* rt = Rv + (size_t)t * n;

  __shared__ T red[WARPS][32];
  T a = zero<T>();
  if (in) {
#pragma unroll 4
    for (int k = warp; k < n; k += WARPS)
      a = fma_axpy(xt[(size_t)k * pv + q], rt[k], a);
  }
  red[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && in) {
    T s = red[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s = add(s, red[w][lane]);
    reinterpret_cast<T*>(G + (size_t)t * p)[q] = neg_div(s, (float)n);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool STAGED, typename T>
cudaError_t launch_grad(const float* X, const float* y, const float* B,
                        float* work, unsigned int* counters, float* G, int m,
                        int n, int p, int chunks, int rows_per_chunk, int slab,
                        int smem_bytes, cudaStream_t s) {
  auto kern = logistic_grad_kernel<STAGED, T>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(chunks, m), THREADS, smem_bytes, s>>>(
      X, y, B, work, counters, G, n, p, rows_per_chunk, slab);
  return cudaGetLastError();
}

}  // namespace

// The largest dynamic shared memory a block of `device` may opt in to.
extern "C" int logistic_grad_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// X (m, n, p), y (m, n), B (m, p) -> G (m, p). work is (m, chunks, p)
// floats of scratch; counters is m unsigned ints that are 0 on entry and
// are 0 again when the kernel ends. smem_bytes = 0 selects the variant that
// reads X from global memory twice; otherwise it is (slab + 2) * p * 4.
// The plan (chunks, rows_per_chunk, slab, smem_bytes) comes from
// kernels/logistic_grad/ops.py::plan.
extern "C" int logistic_grad_f32(const void* X, const void* y, const void* B,
                                 void* work, void* counters, void* G, int m,
                                 int n, int p, int chunks, int rows_per_chunk,
                                 int slab, int smem_bytes, int device,
                                 void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (slab < 1 || slab > SLAB_MAX || chunks < 1 || rows_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = p % 4 == 0 && aligned16(X) && aligned16(B) &&
                   aligned16(work) && aligned16(G);
  const bool staged = smem_bytes > 0;
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* Bf = static_cast<const float*>(B);
  float* wf = static_cast<float*>(work);
  unsigned int* cf = static_cast<unsigned int*>(counters);
  float* Gf = static_cast<float*>(G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (staged && vec)
    err = launch_grad<true, float4>(Xf, yf, Bf, wf, cf, Gf, m, n, p, chunks,
                                    rows_per_chunk, slab, smem_bytes, s);
  else if (staged)
    err = launch_grad<true, float>(Xf, yf, Bf, wf, cf, Gf, m, n, p, chunks,
                                   rows_per_chunk, slab, smem_bytes, s);
  else if (vec)
    err = launch_grad<false, float4>(Xf, yf, Bf, wf, cf, Gf, m, n, p, chunks,
                                     rows_per_chunk, slab, 0, s);
  else
    err = launch_grad<false, float>(Xf, yf, Bf, wf, cf, Gf, m, n, p, chunks,
                                    rows_per_chunk, slab, 0, s);
  return static_cast<int>(err);
}

// X (m, n, p), B (m, p) -> Z (m, n).
extern "C" int logistic_z_f32(const void* X, const void* B, void* Z, int m,
                              int n, int p, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((n + WARPS - 1) / WARPS, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* Bf = static_cast<const float*>(B);
  float* Zf = static_cast<float*>(Z);
  if (p % 4 == 0 && aligned16(X) && aligned16(B))
    logistic_z_kernel<float4><<<grid, THREADS, 0, s>>>(Xf, Bf, Zf, n, p);
  else
    logistic_z_kernel<float><<<grid, THREADS, 0, s>>>(Xf, Bf, Zf, n, p);
  return static_cast<int>(cudaGetLastError());
}

// X (m, n, p), r (m, n) -> G (m, p) = -X' r / n.
extern "C" int logistic_backproject_f32(const void* X, const void* Rv,
                                        void* G, int m, int n, int p,
                                        int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* Rf = static_cast<const float*>(Rv);
  float* Gf = static_cast<float*>(G);
  if (p % 4 == 0 && aligned16(X) && aligned16(G)) {
    const dim3 grid((p / 4 + 31) / 32, m);
    logistic_backproject_kernel<float4><<<grid, THREADS, 0, s>>>(Xf, Rf, Gf,
                                                                 n, p);
  } else {
    const dim3 grid((p + 31) / 32, m);
    logistic_backproject_kernel<float><<<grid, THREADS, 0, s>>>(Xf, Rf, Gf,
                                                                n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
