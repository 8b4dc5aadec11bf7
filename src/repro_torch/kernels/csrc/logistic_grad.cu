// All-tasks logistic gradient for m tasks:
//
//     z_t = X_t b_t,   r_t = y_t * sigmoid(-y_t z_t),   g_t = -X_t' r_t / n
//
// X is (m, n, p) row-major, y (m, n) in {-1, +1}, B and g (m, p); float32.
//
// Replaces `logistic_grad_pallas` (src/repro/kernels/logistic_grad/
// kernel.py, bodies `_resident_grad_kernel` and `_tiled_grad_kernel`) with
// one fused kernel, and `logistic_grad_unfused_pallas` (bodies
// `_logistic_z_kernel` and `_backproject_kernel`) with two kernels: the
// first writes the residual r (its plain version computes z, then r), the
// second reads it back.
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
// Unfused design: two launches, X read by each, and one (m, n) vector, r,
// through device memory: the fused kernel's yardstick, kept apart on
// purpose. Both are streaming matrix-vector products, and their plan
// (`unfused_plan`, a copy in kernels/logistic_grad/ops.py) gives each grid
// at least two blocks per SM at (16, 512, 1024) and (4, 256, 8192).
// * `logistic_residual_kernel`: r_k = y_k sigmoid(-y_k <x_k, b_t>), the
//   sigmoid in the fused kernel's stable form. A warp takes two rows, one,
//   or a share of one beside 1, 3 or 7 other warps: two at the first shape
//   (512 blocks of 16 rows, b_t read once for both; at one row a warp,
//   1024 blocks of 8 warps with 40-odd registers a thread need 1.3 waves
//   of the card's resident blocks, and ran slower), a quarter at the
//   second (512 blocks; one warp a row gave 128 blocks for 132 SMs). Each
//   lane has four X vectors in flight (two steps of two rows, or four of
//   one), X's loads skip L1, so that b_t stays there for the block's
//   other warps, and the chains are added in a fixed order.
// * `logistic_backproject_kernel`: a block owns a slice of 32 to 128
//   columns of one task and all n samples, split over its threads (32
//   floats and 512 blocks at the first shape, where 128 floats gave 128
//   blocks; 64 and 512 at the second). The sample axis stays inside the
//   block, so the slice's sum ends in the block in a fixed order, with no
//   workspace, counters or second pass.
// Both reductions run in a fixed order: deterministic.
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

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int off) {
  return make_float4(shfl_xor(v.x, off), shfl_xor(v.y, off),
                     shfl_xor(v.z, off), shfl_xor(v.w, off));
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

// ---- unfused: r = y sigmoid(-y X b) ------------------------------------------

constexpr int Z_LOADS = 4;         // X vectors a lane has in flight

// The unfused launch plans (ops.py UNFUSED_* agree). The forward kernel's
// (rows per warp, warps per row), first choice first: a warp takes two
// rows (reading b_t once for both), one, or a half, quarter or eighth of
// one. `unfused_plan` takes the first that gives the grid
// UNFUSED_BLOCKS_PER_SM blocks an SM, and the back-projection the widest
// column slice of UNFUSED_COLS that does; else the last of each.
constexpr int UNFUSED_BLOCKS_PER_SM = 2;
constexpr int Z_PLANS[][2] = {{2, 1}, {1, 1}, {1, 2}, {1, 4}, {1, 8}};
constexpr int UNFUSED_COLS[] = {128, 64, 32};

void unfused_plan(int m, int n, int p, int sms, int* rows_per_warp,
                  int* warps_per_row, int* cols) {
  const long long want = (long long)UNFUSED_BLOCKS_PER_SM * sms;
  *rows_per_warp = 1;
  *warps_per_row = WARPS;
  for (const auto& zp : Z_PLANS) {
    const int rows = WARPS * zp[0] / zp[1];
    if ((long long)m * ((n + rows - 1) / rows) >= want) {
      *rows_per_warp = zp[0];
      *warps_per_row = zp[1];
      break;
    }
  }
  *cols = UNFUSED_COLS[2];
  for (int c : UNFUSED_COLS) {
    if ((long long)m * ((p + c - 1) / c) >= want) {
      *cols = c;
      break;
    }
  }
}

// Skips L1: X is read once, and b_t, which every warp of the block reads,
// stays there.
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

// Warp w of block b takes ROWS rows from row0 = (b (WARPS / wpr) + w /
// wpr) ROWS, itself (wpr = 1) or with the wpr - 1 warps beside it (ROWS =
// 1). Its lane l reads vectors q = 32 s + l, 32 s + l + 32 wpr, ... (s =
// w % wpr) into ACC = Z_LOADS / ROWS chains a row, taken in turn, whose
// loads go out together. The chains, then the lanes (shuffle tree), then
// a row's warps (in warp order, through shared memory) are added in a
// fixed order, so two launches give the same bits. Lane rr of the row's
// first warp writes row row0 + rr's residual.
template <int ROWS, typename T>
__global__ void __launch_bounds__(THREADS)
logistic_residual_kernel(const float* __restrict__ X,
                         const float* __restrict__ y,
                         const float* __restrict__ B,
                         float* __restrict__ Rv, int n, int p, int wpr) {
  constexpr int W = sizeof(T) / sizeof(float);
  constexpr int ACC = Z_LOADS / ROWS;
  const int t = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * (WARPS / wpr) + warp / wpr) * ROWS;
  const int seg = warp % wpr;
  const int pv = p / W;
  const int stride = 32 * wpr;
  __shared__ float red[WARPS][ROWS];

  float s[ROWS] = {};
  if (row0 < n) {
    const T* xr[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)        // past n: a copy of row n - 1
      xr[rr] = reinterpret_cast<const T*>(
          X + ((size_t)t * n + min(row0 + rr, n - 1)) * p);
    const T* b = reinterpret_cast<const T*>(B + (size_t)t * p);
    float a[ACC][ROWS] = {};
    int q = 32 * seg + lane;
    for (; q + (ACC - 1) * stride < pv; q += ACC * stride) {
      T xv[ACC][ROWS], bv[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        bv[i] = b[q + i * stride];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          xv[i][rr] = ld_stream(xr[rr] + q + i * stride);
      }
#pragma unroll
      for (int i = 0; i < ACC; ++i)
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          a[i][rr] = fma_dot(xv[i][rr], bv[i], a[i][rr]);
    }
#pragma unroll
    for (int i = 0; i < ACC - 1; ++i) {      // fewer than ACC steps left
      if (q < pv) {
        const T bq = b[q];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          a[i][rr] = fma_dot(ld_stream(xr[rr] + q), bq, a[i][rr]);
      }
      q += stride;
    }
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      float v = a[0][rr];
#pragma unroll
      for (int i = 1; i < ACC; ++i) v += a[i][rr];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      s[rr] = v;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) red[warp][rr] = s[rr];
  }
  __syncthreads();
  if (seg == 0 && lane < ROWS && row0 + lane < n) {
    float z = red[warp][lane];
    for (int w = 1; w < wpr; ++w) z += red[warp + w][lane];
    const size_t o = (size_t)t * n + row0 + lane;
    const float yk = y[o];
    Rv[o] = yk * sigmoid(-yk * z);
  }
}

// ---- unfused: g = -X' r / n --------------------------------------------------

// Block b of task t owns cv = cols / W column vectors q = b cv + c; thread
// (c, s) = (tid % cv, tid / cv) adds r_k x_k over samples k = s, s + S,
// ... (S = THREADS / cv) in order, four loads ahead. The S partials of a
// column are added in a fixed order: by a shuffle tree within each warp
// where cv < 32, then the warps' (or, where cv >= 32, the threads')
// partials in order through shared memory. So a column is one block's
// sum, with no second pass and no atomics, and two launches give the same
// bits.
template <typename T>
__global__ void __launch_bounds__(THREADS)
logistic_backproject_kernel(const float* __restrict__ X,
                            const float* __restrict__ Rv,
                            float* __restrict__ G, int n, int p, int cv) {
  constexpr int W = sizeof(T) / sizeof(float);
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int c = tid % cv;
  const int s = tid / cv;
  const int groups = THREADS / cv;
  const int pv = p / W;
  const int q = blockIdx.x * cv + c;
  const bool in = q < pv;
  const T* xt = reinterpret_cast<const T*>(X + (size_t)t * n * p) + q;
  const float* rt = Rv + (size_t)t * n;

  __shared__ T red[THREADS];
  T a = zero<T>();
  if (in) {
    int k = s;
    for (; k + 3 * groups < n; k += 4 * groups) {
      T xv[4];
      float rv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = xt[(size_t)(k + i * groups) * pv];
        rv[i] = rt[k + i * groups];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) a = fma_axpy(xv[i], rv[i], a);
    }
    for (; k < n; k += groups) a = fma_axpy(xt[(size_t)k * pv], rt[k], a);
  }
  int part = s;                       // which partial of column c
  if (cv < 32) {
    for (int off = cv; off < 32; off *= 2) a = add(a, shfl_xor(a, off));
    part = tid / 32;
  }
  if (cv >= 32 || lane < cv) red[part * cv + c] = a;
  __syncthreads();
  if (tid < cv && in) {
    const int parts = cv < 32 ? WARPS : groups;
    T sum = red[c];
    for (int i = 1; i < parts; ++i) sum = add(sum, red[i * cv + c]);
    reinterpret_cast<T*>(G + (size_t)t * p)[q] = neg_div(sum, (float)n);
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

template <typename T>
cudaError_t launch_residual(int rows_per_warp, dim3 grid, cudaStream_t s,
                            const float* X, const float* y, const float* B,
                            float* R, int n, int p, int wpr) {
  if (rows_per_warp == 2)
    logistic_residual_kernel<2, T><<<grid, THREADS, 0, s>>>(X, y, B, R, n, p,
                                                            wpr);
  else
    logistic_residual_kernel<1, T><<<grid, THREADS, 0, s>>>(X, y, B, R, n, p,
                                                            wpr);
  return cudaGetLastError();
}

int device_sms(int device) {
  static int sms[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (sms[device] == 0)
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                           device);
  return sms[device];
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

// The unfused pair's plan for (m, n, p) on `device`: rows per warp and
// warps per row of the forward kernel, floats per column slice of the
// back-projection, and
// the SM count the rule saw, so that a test can hold `ops.unfused_plan`
// to it.
extern "C" int logistic_unfused_plan(int m, int n, int p, int device,
                                     int* rows_per_warp, int* warps_per_row,
                                     int* cols, int* sms) {
  *sms = device_sms(device);
  if (*sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  unfused_plan(m, n, p, *sms, rows_per_warp, warps_per_row, cols);
  return 0;
}

// The unfused pair, two launches on one stream from one host call:
// X (m, n, p), y (m, n), B (m, p) -> R (m, n) = y sigmoid(-y X b), then
// X, R -> G (m, p) = -X' R / n.
extern "C" int logistic_unfused_f32(const void* X, const void* y,
                                    const void* B, void* R, void* G, int m,
                                    int n, int p, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int rpw = 0, wpr = 0, cols = 0;
  unfused_plan(m, n, p, sms, &rpw, &wpr, &cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  const float* Bf = static_cast<const float*>(B);
  float* Rf = static_cast<float*>(R);
  float* Gf = static_cast<float*>(G);
  const bool vec = p % 4 == 0 && aligned16(X) && aligned16(B) &&
                   aligned16(G);
  const int rows = WARPS * rpw / wpr;
  const dim3 zgrid((n + rows - 1) / rows, m);
  const dim3 ggrid((p + cols - 1) / cols, m);
  cudaError_t err;
  if (vec)
    err = launch_residual<float4>(rpw, zgrid, s, Xf, yf, Bf, Rf, n, p, wpr);
  else
    err = launch_residual<float>(rpw, zgrid, s, Xf, yf, Bf, Rf, n, p, wpr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec)
    logistic_backproject_kernel<float4><<<ggrid, THREADS, 0, s>>>(
        Xf, Rf, Gf, n, p, cols / 4);
  else
    logistic_backproject_kernel<float><<<ggrid, THREADS, 0, s>>>(
        Xf, Rf, Gf, n, p, cols);
  return static_cast<int>(cudaGetLastError());
}
