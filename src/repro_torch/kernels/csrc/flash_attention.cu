// Causal or sliding-window attention forward with online softmax:
//
//     out[b, s, n] = sum_t p[s, t] v[b, t, n / G]  /  sum_t p[s, t],
//     p[s, t] = exp(q[b, s, n] . k[b, t, n / G] / sqrt(H) - m[s])  where visible
//
// Replaces `flash_attention_pallas` (src/repro/kernels/flash_attention/
// kernel.py:83, body `_flash_kernel`). It computes what the TPU body
// computes: m, l and the accumulator in f32; q.k accumulated in f32 and
// kept in f32, times 1/sqrt(H) rounded to f32 (the TPU body divides by
// sqrt(H): the same bits at H = 64 and 256, within an ulp at 128);
// masked scores set to -1e30 and p multiplied by the mask;
// p rounded to v's type before P.V, accumulated in f32; out =
// acc / max(l, 1e-30) in the input type. q and out are (B, S, N, H), k and
// v (B, T, K, H) with N = K * G, float32 or bfloat16, H in {64, 128, 256};
// every axis but the last is addressed through the strides it is given.
//
// Where it differs from the TPU kernel, the same function with other
// work: there the grid's third axis walks the key tiles in order and
// `ops.py` repeats the kv heads into HBM; here one block owns 64 query
// rows of one (batch, head) and loops over the key tiles itself, reading
// kv head n / G in place (no repeat). Causal blocks stop at the diagonal
// tile (the Pallas tile skip); with a window they also start at the
// first tile the window reaches. Skipped tiles are fully masked, so the
// skip changes nothing in m, l or acc. Ragged S and T are masked here,
// not routed elsewhere: key rows past T load as zeros and are masked,
// query rows past S are computed and not stored. Blocks of the latest
// (longest) query tiles are issued first, so the causal triangle does
// not leave one long tail of blocks.
//
// What bounds it on this card: the operations. At the serving path's
// shape (B, S, N, K, H) = (4, 2048, 32, 8, 64) in bf16, the causal half
// is 4 B N (S (S + 1) / 2) H = 68.7 GFLOP, 0.069 ms on the bf16 tensor
// cores (989 TFLOP/s), against 84 MB of q, k, v and out, 0.025 ms at
// 3.35 TB/s. So the design spends its effort on the products: in bf16
// both products run on the tensor cores through `mma.sync` m16n8k16
// (bf16 in, f32 accumulate), the score fragments are turned into the P.V
// operand in registers (no trip through shared memory), and each block
// streams K and V tiles through shared memory once for its 64 rows. In
// f32 there is no tensor-core path that keeps full f32 (TF32 keeps about
// three digits), so the same fragment layout is filled by FP32 FMA, and P
// goes through a per-warp shared tile. This first version loads each tile
// and then computes (no cp.async or TMA pipeline, no wgmma, no warp
// specialisation): those are the work of a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;             // 16 query rows each
constexpr int BQ = 16 * WARPS;       // query rows per block
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, N, G, causal, window;
  float scale;
  // strides in elements: batch, sequence, head
  long long qb, qs, qn, kb, ks, kn, vb, vs, vn, ob, os, on;
};

template <typename T, int H>
struct Tile {
  static constexpr int BK = H <= 128 ? 64 : 32;               // key rows
  static constexpr int LD = H + (sizeof(T) == 2 ? 8 : 4);      // smem row
  static constexpr int LDP = BK + 4;                           // f32 P row
  static constexpr size_t smem() {
    return (size_t)(BQ + 2 * BK) * LD * sizeof(T) +
           (sizeof(T) == 4 ? (size_t)WARPS * 16 * LDP * sizeof(float) : 0);
  }
};

// rows [row0, row0 + ROWS) of a (rows, H) slab with row stride `stride`
// into shared memory at row stride LD; rows at or past `nrows` are zeros
template <typename T, int H, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = H / VEC;                 // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += 32 * WARPS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) *
                                                      stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of one warp's 16 rows (the m16n8 accumulator of
// mma.sync): lane = 4 g + t holds, per 8-column tile j, the entries
// (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1).
// Scores S = Q K' over one key tile, in that layout, unscaled.
template <int H, int BK, int LD>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const __nv_bfloat16* Qw,
                                       const __nv_bfloat16* Ks, int g,
                                       int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    const uint32_t a[4] = {ld32(Qw + g * LD + c), ld32(Qw + (g + 8) * LD + c),
                           ld32(Qw + g * LD + c + 8),
                           ld32(Qw + (g + 8) * LD + c + 8)};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + c;
      mma_bf16(s[j], a, ld32(kr), ld32(kr + 8));
    }
  }
}

template <int H, int BK, int LD>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const float* Qw, const float* Ks,
                                       int g, int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
  for (int h = 0; h < H; h += 4) {
    const float4 qa = *reinterpret_cast<const float4*>(Qw + g * LD + h);
    const float4 qb = *reinterpret_cast<const float4*>(Qw + (g + 8) * LD + h);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float4 k0 =
          *reinterpret_cast<const float4*>(Ks + (j * 8 + 2 * t) * LD + h);
      const float4 k1 =
          *reinterpret_cast<const float4*>(Ks + (j * 8 + 2 * t + 1) * LD + h);
      s[j][0] += qa.x * k0.x + qa.y * k0.y + qa.z * k0.z + qa.w * k0.w;
      s[j][1] += qa.x * k1.x + qa.y * k1.y + qa.z * k1.z + qa.w * k1.w;
      s[j][2] += qb.x * k0.x + qb.y * k0.y + qb.z * k0.z + qb.w * k0.w;
      s[j][3] += qb.x * k1.x + qb.y * k1.y + qb.z * k1.z + qb.w * k1.w;
    }
  }
}

// acc += P V over one key tile; acc in the fragment layout over H / 8
// column tiles. bf16: p rounded to bf16 and fed back as the A operand
// straight from the score fragments.
template <int H, int BK, int LD, int LDP>
__device__ __forceinline__ void pv(float (&acc)[H / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const __nv_bfloat16* Vs, float*, int g,
                                   int t) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint32_t a[4] = {pack2(p[2 * kc][0], p[2 * kc][1]),
                           pack2(p[2 * kc][2], p[2 * kc][3]),
                           pack2(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack2(p[2 * kc + 1][2], p[2 * kc + 1][3])};
    const __nv_bfloat16* v0 = Vs + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const __nv_bfloat16* vj = v0 + j * 8;
      mma_bf16(acc[j], a, pack2(vj[0], vj[LD]),
               pack2(vj[8 * LD], vj[9 * LD]));
    }
  }
}

// f32: the warp's P tile goes through shared memory (16 x BK) so that
// every lane reads whole rows of it
template <int H, int BK, int LD, int LDP>
__device__ __forceinline__ void pv(float (&acc)[H / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const float* Vs, float* Pw, int g, int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int c = j * 8 + 2 * t;
    Pw[g * LDP + c] = p[j][0];
    Pw[g * LDP + c + 1] = p[j][1];
    Pw[(g + 8) * LDP + c] = p[j][2];
    Pw[(g + 8) * LDP + c + 1] = p[j][3];
  }
  __syncwarp();
#pragma unroll 2
  for (int kk = 0; kk < BK; ++kk) {
    const float p0 = Pw[g * LDP + kk], p1 = Pw[(g + 8) * LDP + kk];
    const float* vr = Vs + kk * LD + 2 * t;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(vr + j * 8);
      acc[j][0] += p0 * vv.x;
      acc[j][1] += p0 * vv.y;
      acc[j][2] += p1 * vv.x;
      acc[j][3] += p1 * vv.y;
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

template <typename T, int H>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_kernel(const Args a) {
  using TL = Tile<T, H>;
  constexpr int BK = TL::BK, LD = TL::LD, LDP = TL::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* Pw = reinterpret_cast<float*>(Vs + BK * LD) + warp * 16 * LDP;

  const int b = blockIdx.x / a.N, n = blockIdx.x % a.N, kvh = n / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const T* qp = static_cast<const T*>(a.q) + b * a.qb + n * a.qn;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + kvh * a.kn;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + kvh * a.vn;
  T* op = static_cast<T*>(a.o) + b * a.ob + n * a.on;

  load_tile<T, H, BQ, LD>(Qs, qp, a.qs, q0, a.S);

  // the key tiles any row of this block can see
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_end = (k_end + BK - 1) / BK;

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[H / 8][4];
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = k_begin / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // every warp is done with the last tile
    load_tile<T, H, BK, LD>(Ks, kp, a.ks, k0, a.T);
    load_tile<T, H, BK, LD>(Vs, vp, a.vs, k0, a.T);
    __syncthreads();

    float s[BK / 8][4];
    scores<H, BK, LD>(s, Qs + warp * 16 * LD, Ks, g, t);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e / 2], key = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = key < a.T && (!a.causal || key <= r) &&
                         (a.window <= 0 || key > r - a.window);
        s[j][e] = vis ? s[j][e] * a.scale : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];               // this lane's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e / 2], key = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = key < a.T && (!a.causal || key <= r) &&
                         (a.window <= 0 || key > r - a.window);
        s[j][e] = vis ? expf(s[j][e] - m[e / 2]) : 0.f;   // p * mask
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    pv<H, BK, LD, LDP>(acc, s, Vs, Pw, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    if (row[i] >= a.S) continue;
    T* orow = op + (long long)row[i] * a.os + 2 * t;
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
      store2(orow + j * 8, acc[j][2 * i] / l[i], acc[j][2 * i + 1] / l[i]);
  }
}

template <typename T, int H>
int launch(const Args& a, int BH, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = Tile<T, H>::smem();
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.S + BQ - 1) / BQ);
  flash_fwd_kernel<T, H><<<grid, 32 * WARPS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int H, int BH, int device, cudaStream_t stream) {
  switch (H) {
    case 64: return launch<T, 64>(a, BH, device, stream);
    case 128: return launch<T, 128>(a, BH, device, stream);
    case 256: return launch<T, 256>(a, BH, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, N, H), k/v (B, T, K, H) -> o (B, S, N, H), all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1); strides in elements, the last
// axis contiguous, rows 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int S, int T, int N, int K, int H, long long qb, long long qs,
    long long qn, long long kb, long long ks, long long kn, long long vb,
    long long vs, long long vn, long long ob, long long os, long long on,
    int causal, int window, float scale, int device, void* stream) {
  if (K <= 0 || N % K != 0 || B <= 0 || S <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, S, T, N, N / K, causal, window, scale,
               qb, qs, qn, kb, ks, kn, vb, vs, vn, ob, os, on};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, H, B * N, device, st)
              : dispatch<float>(a, H, B * N, device, st);
}
