// Row-wise group hard threshold, the master step of DSML (paper eq. 5-6):
//
//     keep_j = sum_t B[j, t]^2 > Lambda^2,   out[j, :] = keep_j ? B[j, :] : 0
//
// Replaces `group_threshold_pallas` (src/repro/kernels/group_threshold/
// kernel.py, body `_gt_kernel`). B is (p, m) row-major, float32 or bfloat16;
// the output has B's type and the keep column is int8 (p,). The squares are
// summed in f32 and compared with Lambda^2 rounded to f32, as the TPU body
// does (no square root).
//
// What bounds it: nothing on the card. At (p, m) = (1024, 16) it moves
// about 130 KB (B in, B out, the keep column), 0.04 us at 3.35 TB/s, so
// the launch sets its time. Design, simple and right: one warp per row,
// lanes stride over the m tasks; each lane squares and adds its entries in
// order, then a butterfly of shuffles sums the 32 lanes. Floating-point
// addition commutes, so every lane ends with the same bits and the same
// decision, and the order is fixed, so every run gives the same bits. Each
// lane writes its own entries; lane 0 writes the keep byte. Rows past p
// and lanes past m are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
group_threshold_kernel(const T* __restrict__ B, T* __restrict__ out,
                       int8_t* __restrict__ keep, float lam, int p, int m) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p) return;              // warp-uniform: the whole warp leaves
  const T* b = B + (size_t)row * m;
  T* o = out + (size_t)row * m;

  float sq = 0.f;
  for (int j = lane; j < m; j += 32) {
    const float v = to_f32(b[j]);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));

  const bool k = sq > __fmul_rn(lam, lam);
  for (int j = lane; j < m; j += 32) o[j] = k ? b[j] : zero<T>();
  if (lane == 0) keep[row] = k ? 1 : 0;
}

template <typename T>
int launch(const void* B, void* out, void* keep, float lam, int p, int m,
           int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((p + WARPS - 1) / WARPS);
  group_threshold_kernel<T>
      <<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(B), static_cast<T*>(out),
          static_cast<int8_t*>(keep), lam, p, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B (p, m) float32 -> out (p, m) float32, keep (p,) int8.
extern "C" int group_threshold_f32(const void* B, void* out, void* keep,
                                   float lam, int p, int m, int device,
                                   void* stream) {
  return launch<float>(B, out, keep, lam, p, m, device, stream);
}

// B (p, m) bfloat16 -> out (p, m) bfloat16, keep (p,) int8.
extern "C" int group_threshold_bf16(const void* B, void* out, void* keep,
                                    float lam, int p, int m, int device,
                                    void* stream) {
  return launch<__nv_bfloat16>(B, out, keep, lam, p, m, device, stream);
}
