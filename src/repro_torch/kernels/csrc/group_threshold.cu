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
// the launch sets its time: the design aims at an empty kernel's time.
// A row takes `row_lanes(m)` lanes (kernels/group_threshold/ops.py mirrors
// it): the least power of two that covers its vectors, at most 32. A
// vector is four elements (a float4, or four bf16 in 8 bytes) where
// m % 4 == 0 and both pointers are aligned, else one. At m = 16: 4 lanes
// of one float4 each, 8 rows a warp, 16 blocks. Each lane squares and adds
// its vectors' elements in order, then a butterfly of shuffles over the
// row's lanes adds the lanes' sums; floating-point addition commutes, so
// every lane of the row ends with the same bits and the same decision, and
// the order is fixed, so every run gives the same bits. Each lane writes
// its own vectors; the row's first lane writes the keep byte. Rows past p
// and vectors past m are masked.
//
// `empty_kernel` does nothing: its launch is the floor this kernel is
// timed against.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// Lanes a row takes for `vecs` vectors (ops.py row_lanes agrees).
int row_lanes(int vecs) {
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes *= 2;
  return lanes;
}

__device__ __forceinline__ float sq_add(float s, float v) {
  return __fadd_rn(s, __fmul_rn(v, v));
}

// One element, or four; squares added to s in element order, and the
// value or zero written back.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using V1 = float;
  using V4 = float4;
  static __device__ float add(float s, float v) { return sq_add(s, v); }
  static __device__ float add(float s, float4 v) {
    return sq_add(sq_add(sq_add(sq_add(s, v.x), v.y), v.z), v.w);
  }
  static __device__ float zero1() { return 0.f; }
  static __device__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Elem<__nv_bfloat16> {
  using V1 = __nv_bfloat16;
  using V4 = uint2;                 // four bf16
  static __device__ float add(float s, __nv_bfloat16 v) {
    return sq_add(s, __bfloat162float(v));
  }
  static __device__ float add(float s, uint2 v) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return sq_add(sq_add(sq_add(sq_add(s, a.x), a.y), b.x), b.y);
  }
  static __device__ __nv_bfloat16 zero1() { return __float2bfloat16(0.f); }
  static __device__ uint2 zero4() { return make_uint2(0u, 0u); }
};

// Row j = (global thread) >> shift, with lanes = 1 << shift; its lane s
// reads vectors s, s + lanes, ... of the row's vecs. The first stays in a
// register for the write (a row of at most `lanes` vectors, as at the
// master step, is read once). V is Elem<T>::V1 or V4.
template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
group_threshold_kernel(const T* __restrict__ B, T* __restrict__ out,
                       int8_t* __restrict__ keep, float lam, int p, int vecs,
                       int shift) {
  const int lanes = 1 << shift;
  const int gid = blockIdx.x * THREADS + threadIdx.x;
  const int row = gid >> shift;
  const int s = gid & (lanes - 1);
  const bool in = row < p;
  const V* b = reinterpret_cast<const V*>(B) + (size_t)row * vecs;
  V* o = reinterpret_cast<V*>(out) + (size_t)row * vecs;
  V zero;
  if constexpr (sizeof(V) == sizeof(T)) zero = Elem<T>::zero1();
  else zero = Elem<T>::zero4();

  const bool first = in && s < vecs;
  const V v0 = first ? b[s] : zero;
  float sq = first ? Elem<T>::add(0.f, v0) : 0.f;
  if (in)
    for (int j = s + lanes; j < vecs; j += lanes) sq = Elem<T>::add(sq, b[j]);
  // every lane of the warp takes part; the xor stays in the row's lanes
  for (int off = lanes / 2; off > 0; off /= 2)
    sq = __fadd_rn(sq, __shfl_xor_sync(FULL, sq, off));
  if (!in) return;

  const bool k = sq > __fmul_rn(lam, lam);
  if (first) o[s] = k ? v0 : zero;
  for (int j = s + lanes; j < vecs; j += lanes) o[j] = k ? b[j] : zero;
  if (s == 0) keep[row] = k ? 1 : 0;
}

__global__ void empty_kernel() {}

template <typename T>
int launch(const void* B, void* out, void* keep, float lam, int p, int m,
           int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  const int vecs = vec ? m / 4 : m;
  const int lanes = row_lanes(vecs);
  int shift = 0;
  while ((1 << shift) < lanes) ++shift;
  const long long threads = (long long)p * lanes;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* Bt = static_cast<const T*>(B);
  T* ot = static_cast<T*>(out);
  int8_t* kt = static_cast<int8_t*>(keep);
  if (vec)
    group_threshold_kernel<T, typename Elem<T>::V4>
        <<<grid, THREADS, 0, s>>>(Bt, ot, kt, lam, p, vecs, shift);
  else
    group_threshold_kernel<T, typename Elem<T>::V1>
        <<<grid, THREADS, 0, s>>>(Bt, ot, kt, lam, p, vecs, shift);
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

// The lanes a row takes for `vecs` vectors, as the launcher chooses them,
// so that a test can hold `ops.row_lanes` to it.
extern "C" int group_threshold_lanes(int vecs, int* lanes) {
  *lanes = row_lanes(vecs);
  return 0;
}

// One block of one thread that does nothing, on `stream`: the launch
// floor, timed beside the kernels.
extern "C" int empty_launch(int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
