// Causal or sliding-window attention forward with online softmax:
//
//     out[b, s, n] = sum_t p[s, t] v[b, t, n / G]  /  sum_t p[s, t],
//     p[s, t] = exp(q[b, s, n] . k[b, t, n / G] / sqrt(H) - m[s])  where visible
//
// Replaces `flash_attention_pallas` (src/repro/kernels/flash_attention/
// kernel.py:83, body `_flash_kernel`). It computes what the TPU body
// computes: m, l and the accumulator in f32; q.k accumulated in f32 and
// kept in f32, scaled by 1/sqrt(H); masked scores out of the softmax
// (p = 0); p rounded to v's type before P.V, accumulated in f32; out =
// acc / max(l, 1e-30) in the input type. q and out are (B, S, N, H), k and
// v (B, T, K, H) with N = K * G, float32 or bfloat16, H in {64, 128, 256};
// every axis but the last is addressed through the strides it is given.
//
// Where it differs from the TPU kernel, the same function with other
// work: there the grid's third axis walks the key tiles in order and
// `ops.py` repeats the kv heads into HBM; here one block owns a tile of
// query rows of one (batch, head) and loops over the key tiles itself,
// reading kv head n / G in place (no repeat). Causal blocks stop at the
// diagonal tile (the Pallas tile skip); with a window they also start at
// the first tile the window reaches. Skipped tiles are fully masked, so
// the skip changes nothing in m, l or acc. Ragged S and T are masked
// here, not routed elsewhere: key rows past T load as zeros and are
// masked, query rows past S are computed and not stored. Blocks of the
// latest (longest) query tiles are issued first, so the causal triangle
// does not leave one long tail of blocks. No split over keys: a row's
// sum runs in one order, so two launches give the same bits.
//
// The training forward also writes each row's log-sum-exp, (B, N, S) f32,
// lse = m + log(max(l, 1e-30)) in natural-log units with m the running
// max of the scaled scores, as the reference's `_flash_fwd`
// (src/repro/models/attention_core.py) returns it for its blockwise
// backward; a row that sees no key gets its -1e30. Both designs write it
// in their epilogue from the m and l they already hold (the bf16 design
// keeps m in raw score units and scales it once there), one lane a row;
// a null pointer (serving) writes nothing and costs one branch a row.
//
// What bounds it on this card: the operations. At the serving path's
// shape (B, S, N, K, H) = (4, 2048, 32, 8, 64) in bf16, the causal half
// is 4 B N (S (S + 1) / 2) H = 68.7 GFLOP, 0.069 ms on the bf16 tensor
// cores (989 TFLOP/s), against 84 MB of q, k, v and out, 0.025 ms at
// 3.35 TB/s. Two designs:
//
// * bf16 at every H (`hopper::flash_fwd_wgmma`): the serving path's
//   kernel, and recurrentgemma's local attention at H = 256. A persistent
//   grid (one block per SM) walks work items of 64 x CONSUMERS query rows
//   of one (batch, head), the longest first, aligned to S's end (a
//   partial item is the first, the shortest under a causal mask), each
//   block one item a round in a snake over the grid, so that the causal
//   triangle's lengths even out over the blocks. A block has CONSUMERS
//   warpgroups of 64 rows each (three at H = 64, two at H = 128 and 256)
//   and a producer warpgroup, whose first thread loads each item's Q once
//   and then K and V tile by tile by TMA into a ring of stages, with full
//   and empty mbarriers (and a pair for Q); the ring runs on across
//   items, so the next item's loads overlap this item's end. The tensor
//   maps are built on the host over the operands' own strides, 128-byte
//   swizzled, zero-filled past T. setmaxnreg gives the producer's
//   registers to the consumers. Each consumer computes S = Q K' with
//   `wgmma` from shared memory (Q stays there for the whole key loop),
//   the online softmax in registers (exp2 with log2(e) folded into the
//   scale; row maxima and sums as four interleaved chains), and
//   O += P V with `wgmma` m64nHk16, P rounded to bf16 as the register A
//   operand and V read from shared memory through the transpose bit. The
//   S product of tile j and the P V of tile j - 1 are in flight together
//   while tile j's softmax runs, and the warpgroups take turns at issuing
//   (round robin on named barriers), so the others' softmaxes run under
//   one's products. The mask is evaluated only on tiles that cross T's
//   end, the diagonal or the window's edge for some row of the
//   warpgroup, branch-free from each row's first and last visible key;
//   interior tiles skip it. The output leaves in 16-byte stores (a quad
//   transposes its words), O / l by a reciprocal and one exact
//   correction, which gives the division's bits.
//   The tile is laid out per H (`Layout<H>`). At H = 64 and 128: 128 keys
//   a tile (S m64n128k16) in three stages. At H = 256 the accumulator of
//   O is 128 floats a consumer thread (one m64n256k16 a 16-key step of
//   P V), so the tile is 64 keys: S (m64n64k16, 16 k-steps over Q's 4
//   panels) is 32 floats and P's bf16 fragments 16, and O, S and P live
//   together in the overlap above within the consumer's 240 registers.
//   The overlap is kept: ptxas reports 0 bytes spilled (80 keys, the
//   other candidate, spilled 16 bytes; 128 would need 64 + 32 more
//   registers). There shared memory bounds the ring: Q takes 64 KiB (4
//   panels of 128 rows) and a stage of K and V 64 KiB, so two stages fit
//   (193 KiB of 227) and three do not. With two stages a stage freed
//   only after its P V would leave the next tile's load no lead, so K and
//   V are released apart (`SPLIT_KV`): K after the S product, V after the
//   P V. K = 1 needs no head packing: the 16 query heads of a batch read
//   one kv head's 8 MiB from the 50 MB L2.
//   What bounds it: at the serving shape it runs at about two fifths of
//   the bf16 peak, at H = 256 at about three fifths (`chip_smoke.py`
//   phase 5). The softmax's instructions (about 6 per score) are not
//   fully hidden under the products at H = 64, where a tile's two
//   products are short: on the H100 a build without the softmax ran much
//   faster, and one that moved a share of the exp2 onto an FMA polynomial
//   ran slower, so the issue slots, not the MUFU unit, are the limit. At
//   H = 256 a score carries four times the products, and a build without
//   the softmax ran about a sixth faster, one without the output stores
//   within the spread (`PERF.md`).
// * float32 at every H (`flash_fwd_tf32x3`): full f32 on the tensor cores.
//   Each operand x is split into hi = x rounded to TF32 and lo = (x - hi)
//   rounded to TF32 (`cvt.rna.tf32.f32`), and each product a b is taken as
//   three TF32 products (lo.hi and hi.lo, then hi.hi) in `mma.sync` m16n8k8
//   with f32 accumulation: about 2^-21 relative error a product, against 2^-11
//   for one TF32 product, which could not meet the f32 bars. Never one TF32
//   product. What bounds it: the tensor cores at a third of the TF32 rate, 3 x
//   68.7 GFLOP / 495 TFLOP/s = 0.416 ms at the training copy's (4, 2048, 32,
//   8, 64), against 1.025 ms for the same work in FP32 FMA (67 TFLOP/s); and
//   the phases of a tile (S, the softmax, P V), which run one after another in
//   a warp and hardly overlap (on the H100, builds of an earlier version
//   without one of them each saved about that part's time). One block takes
//   128 query rows of one (batch, head) in 8 warps at H = 64 and 128, 64 rows
//   in 4 warps at 256 (shared memory); keys come in tiles of 32 (16 at H =
//   256) through a `cp.async` ring of 3 stages at H = 64 and 2 at 128 and 256,
//   and the block splits each tile of K and V into hi and lo once, into shared
//   memory, for all its warps. Rows are padded to H + 4 words, so that K's B
//   fragments (key g, column t: bank 4g + t) and V's (key 2t, column g: bank
//   8t + g) load without bank conflicts. Q is split once into registers at H =
//   64, and a k-step at a time from shared memory at 128 and 256. S and O stay
//   in the m16n8 accumulator layout; P V reads P's accumulator fragment as its
//   A fragment in place, by numbering the 8 keys of a k-step 0, 2, 4, 6, 1, 3,
//   5, 7 in A's columns and V's rows alike. A tile's P V is summed in
//   accumulators of its own, the small terms apart from hi.hi, and added to
//   the rescaled O once, rounded to nearest (one accumulator over the whole
//   row carried the tensor cores' truncation into row errors several times
//   larger). The softmax takes exp2 with log2(e) folded into the scale. A warp
//   skips the tiles none of its rows sees, and evaluates the mask only on
//   tiles that cross T's end, the diagonal or the window's edge for one of its
//   rows. Not `wgmma`: its TF32 operands must be K-major in shared memory, and
//   V, P V's B, is not (it would take a transpose and hi and lo copies of
//   every V tile in shared memory).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <cmath>

namespace {

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
  // the row log-sum-exp (B, N, S) f32, contiguous, or null: none written
  float* lse;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- float32: 3xTF32 on mma.sync ------------------------------------------

// The f32 body's block per H: warps of 16 query rows (8 where shared
// memory holds Q, the ring and the split tile for them, H <= 128), keys a
// tile, stages of the K/V ring, and padded rows (LD = H + 4: the B
// fragments' loads are free of bank conflicts). Q stays in shared memory
// for the whole key loop except at H = 64, where each warp keeps its split
// rows in registers.
template <int H>
struct Tf32Tile {
  static constexpr int WARPS = H <= 128 ? 8 : 4;
  static constexpr int BQ = 16 * WARPS;              // query rows
  static constexpr int BK = H <= 128 ? 32 : 16;      // keys a tile
  static constexpr int STAGES = H == 64 ? 3 : 2;
  static constexpr int LD = H + 4;
  static constexpr bool Q_REGS = H == 64;
  static constexpr int STAGE_FLOATS = 2 * BK * LD;   // K, then V
  // Q, the ring, and the tile being computed split: K and V's hi, then
  // K and V's lo
  static constexpr int SMEM =
      (BQ * LD + STAGES * STAGE_FLOATS + 2 * STAGE_FLOATS) * 4;
};
static_assert(Tf32Tile<64>::SMEM <= 232448 &&
                  Tf32Tile<128>::SMEM <= 232448 &&
                  Tf32Tile<256>::SMEM <= 232448,
              "over a block's shared memory");

// 16 bytes from global to shared memory, asynchronously; zeros where `in`
// is false (src-size 0: the source is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// rows [row0, row0 + ROWS) of a (rows, H) slab with row stride `stride`
// into shared memory at row stride LD, by cp.async; rows at or past
// `nrows` are zeros
template <int H, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int CPR = H / 4;                   // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool in = row0 + r < nrows;
    cp_async16(dst + r * LD + c,
               in ? src + (long long)(row0 + r) * stride + c : src, in);
  }
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
// away), lo the remainder x - hi (exact in f32) rounded to TF32, so that
// hi + lo holds x to about 2^-22 |x|. cvt leaves the 13 low bits
// unspecified: hi's are cleared before the subtraction, and the tensor
// cores ignore them in both.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi & 0xffffe000u);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// 2^x on the MUFU unit (about 2^-22 relative error; 0 below 2^-126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b on the tensor cores, one m16n8k8 TF32 product with f32
// accumulation: a (16 x 8, row) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b (8 x 8, col) b0 (t, g), b1 (t + 4, g); d as the
// accumulator layout below
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in full f32 as three TF32 products: the small terms lo.hi and
// hi.lo first, then hi.hi (lo.lo, about 2^-22 of the product, is left out)
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// One block a tile of BQ query rows of one (batch, head), 16 rows a warp,
// looping over the key tiles through a cp.async ring. S and O are kept in
// the m16n8 accumulator layout: lane = 4 g + t holds, per 8-column tile j,
// the entries (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t),
// (g + 8, 8j + 2t + 1).
template <int H>
__global__ void __launch_bounds__(32 * Tf32Tile<H>::WARPS, 1)
flash_fwd_tf32x3(const Args a) {
  using TL = Tf32Tile<H>;
  constexpr int WARPS = TL::WARPS, BQ = TL::BQ, BK = TL::BK, LD = TL::LD,
                STAGES = TL::STAGES, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + BQ * LD;
  uint32_t* hi = reinterpret_cast<uint32_t*>(ring + STAGES * TL::STAGE_FLOATS);
  uint32_t* lo = hi + TL::STAGE_FLOATS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / a.N, n = blockIdx.x % a.N, kvh = n / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const float* qp = static_cast<const float*>(a.q) + b * a.qb + n * a.qn;
  const float* kp = static_cast<const float*>(a.k) + b * a.kb + kvh * a.kn;
  const float* vp = static_cast<const float*>(a.v) + b * a.vb + kvh * a.vn;
  float* op = static_cast<float*>(a.o) + b * a.ob + n * a.on;
  // scores in log2 units: the softmax takes exp2
  const float scale_log2 = a.scale * 1.4426950408889634f;

  // the key tiles any row of this block can see
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_begin / BK;
  const int tiles = max(0, (k_end + BK - 1) / BK - kt0);

  // the ring: Q with the first tile in one group, then a tile a group;
  // tile i goes to stage i % STAGES, K then V
  auto load_kv = [&](int i) {
    float* st = ring + (i % STAGES) * TL::STAGE_FLOATS;
    const int k0 = (kt0 + i) * BK;
    copy_rows<H, BK, LD, THREADS>(st, kp, a.ks, k0, a.T);
    copy_rows<H, BK, LD, THREADS>(st + BK * LD, vp, a.vs, k0, a.T);
  };
  copy_rows<H, BQ, LD, THREADS>(Qs, qp, a.qs, q0, a.S);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load_kv(s);
    cp_async_commit();
  }

  const float* Qw = Qs + warp * 16 * LD;
  // this warp's Q split once, where registers allow (H = 64)
  uint32_t qh[TL::Q_REGS ? H / 8 : 1][4], ql[TL::Q_REGS ? H / 8 : 1][4];
  if constexpr (TL::Q_REGS) {
    cp_async_wait<STAGES - 2>();      // Q (and the first tile) landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < H / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(Qw[(g + 8 * (e & 1)) * LD + 8 * kk + t + 4 * (e >> 1)],
              qh[kk][e], ql[kk][e]);
  }

  const int row_lo = q0 + warp * 16;
  const int row[2] = {row_lo + g, row_lo + g + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[H / 8][4];
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<STAGES - 2>();      // tile i has landed
    __syncthreads();                  // and every warp is done with i - 1
    if (i + STAGES - 1 < tiles) load_kv(i + STAGES - 1);
    cp_async_commit();
    // the block splits tile i once, for every warp: K and V's hi and lo
    {
      const float* raw = ring + (i % STAGES) * TL::STAGE_FLOATS;
      constexpr int CPR = H / 4;
      for (int c4 = threadIdx.x; c4 < 2 * BK * CPR; c4 += THREADS) {
        const int at = (c4 / CPR) * LD + (c4 % CPR) * 4;
        const float4 x = *reinterpret_cast<const float4*>(raw + at);
        uint4 h, l;
        split(x.x, h.x, l.x);
        split(x.y, h.y, l.y);
        split(x.z, h.z, l.z);
        split(x.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(lo + at) = l;
      }
    }
    __syncthreads();

    const int k0 = (kt0 + i) * BK;
    // a tile no row of this warp sees adds nothing (m, l and O unchanged)
    if ((a.causal && k0 > row_lo + 15) ||
        (a.window > 0 && k0 + BK - 1 <= row_lo - a.window))
      continue;

    // S = Q K' over the tile: k-steps of 8 columns of H; B (k = h, n =
    // key) from K's rows, b0 = K[8j + g][h + t], b1 = K[8j + g][h + t + 4]
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 8; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (TL::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[e] = qh[kk][e], al[e] = ql[kk][e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(Qw[(g + 8 * (e & 1)) * LD + 8 * kk + t + 4 * (e >> 1)],
                ah[e], al[e]);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int o = (8 * j + g) * LD + 8 * kk + t;
        mma_3x(s[j], ah, al, hi[o], hi[o + 4], lo[o], lo[o + 4]);
      }
    }

    // the mask only where the tile crosses T's end, the diagonal or the
    // window's edge for some row of the warp
    const bool edge = k0 + BK > a.T ||
                      (a.causal && k0 + BK - 1 > row_lo) ||
                      (a.window > 0 && k0 <= row_lo + 15 - a.window);
    auto visible = [&](int r, int key) {
      return key < a.T && (!a.causal || key <= r) &&
             (a.window <= 0 || key > r - a.window);
    };
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale_log2;
        if (edge && !visible(row[e / 2], key)) x = NEG_INF;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];               // this lane's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = edge && !visible(row[e / 2], key)
                      ? 0.f
                      : exp2_approx(s[j][e] - m[e / 2]);   // p * mask
        l[e / 2] += s[j][e];
      }

    // O += P V: k-steps of 8 keys, A's column c standing for key
    // 8j + 2c (c < 4) or 8j + 2(c - 4) + 1, so that P's accumulator
    // fragment is its A fragment as it lies (a0 = s[j][0], a1 = s[j][2],
    // a2 = s[j][1], a3 = s[j][3]); V's B rows follow: b0 = V[8j + 2t],
    // b1 = V[8j + 2t + 1], column 8 nt + g. The tile's product is summed
    // apart from O, its small terms (lo.hi, hi.lo) apart from hi.hi, and
    // added to the rescaled O once, rounded to nearest: the tensor cores'
    // accumulation truncates, and over a long row of tiles in one
    // accumulator that bias would add up
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);
      split(s[j][2], ph[j][1], pl[j][1]);
      split(s[j][1], ph[j][2], pl[j][2]);
      split(s[j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int o = (8 * j + 2 * t) * LD + 8 * nt + g;
        mma_tf32(small, pl[j], hi[BK * LD + o], hi[BK * LD + o + LD]);
        mma_tf32(small, ph[j], lo[BK * LD + o], lo[BK * LD + o + LD]);
        mma_tf32(big, ph[j], hi[BK * LD + o], hi[BK * LD + o + LD]);
      }
      acc[nt][0] = fmaf(acc[nt][0], alpha[0], big[0] + small[0]);
      acc[nt][1] = fmaf(acc[nt][1], alpha[0], big[1] + small[1]);
      acc[nt][2] = fmaf(acc[nt][2], alpha[1], big[2] + small[2]);
      acc[nt][3] = fmaf(acc[nt][3], alpha[1], big[3] + small[3]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    if (row[r] >= a.S) continue;
    // m + log(max(l, 1e-30)) in natural-log units: m is NEG_INF where
    // the row saw no key, kept as it is (the plain version's -1e30)
    if (a.lse != nullptr && t == 0)
      a.lse[((long long)b * a.N + n) * a.S + row[r]] =
          (m[r] == NEG_INF ? NEG_INF : m[r] * 0.6931471805599453f) +
          logf(l[r]);
    float* orow = op + (long long)row[r] * a.os + 2 * t;
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
  }
}

template <int H>
int launch(const Args& a, int BH, int device, cudaStream_t stream) {
  using TL = Tf32Tile<H>;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_fwd_tf32x3<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.S + TL::BQ - 1) / TL::BQ);
  flash_fwd_tf32x3<H><<<grid, 32 * TL::WARPS, TL::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: TMA, mbarriers and wgmma ---------------------------------------

namespace hopper {

constexpr int PRODUCER_REGS = 24;

// Consumer warpgroups of 64 query rows each: three at H = 64 (two
// softmaxes run under the third's products), two at H = 128 and 256
// (three would not fit shared memory, nor, at 256, the register file),
// and a producer warpgroup. Registers per thread after setmaxnreg: an SM
// sub-partition holds one warp of each warpgroup, and 24 + CONSUMERS x
// CONSUMER_REGS <= 512 of its 16384 / 32.
// Keys per tile and stages: 128 keys in three stages at H = 64 and 128,
// 64 keys in two at H = 256 (the registers of O and shared memory; see
// the header). Shared memory: Q, then the K stages, then the V stages,
// each a run of H / 64 panels of (rows, 64) bf16, 128-byte rows swizzled
// as TMA writes them and wgmma reads them; then the mbarriers
template <int H>
struct Layout {
  static constexpr int CONSUMERS = H == 64 ? 3 : 2;
  static constexpr int BQ = 64 * CONSUMERS;     // query rows per item
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 240;
  static constexpr int BKEYS = H == 256 ? 64 : 128;    // keys per tile
  static constexpr int STAGES = H == 256 ? 2 : 3;      // K/V ring
  // K and V of a stage released apart (K after the S product, V after the
  // P V), where two stages would otherwise leave the next tile's load no
  // lead on the tile being computed; with three the load has a tile of
  // lead, and the second pair of barriers only costs issue slots
  static constexpr bool SPLIT_KV = STAGES == 2;
  static constexpr int PANEL_Q = BQ * 128;      // bytes of a 64-column panel
  static constexpr int PANEL_KV = BKEYS * 128;
  static constexpr int PANELS = H / 64;
  static constexpr int Q_BYTES = PANELS * PANEL_Q;
  static constexpr int KV_BYTES = PANELS * PANEL_KV;   // K or V, one stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // the barriers, and room to align the base to 1024 bytes
  static constexpr int BARS = (SPLIT_KV ? 4 : 2) * STAGES + 2;
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;
};
static_assert(Layout<64>::SMEM <= 232448 && Layout<128>::SMEM <= 232448 &&
                  Layout<256>::SMEM <= 232448,
              "over a block's shared memory");

struct Params {
  CUtensorMap q, k, v;        // (H, rows, heads, B) through the strides
  void* o;
  float* lse;                 // (B, N, S) f32, or null: none written
  int B, S, T, N, G, causal, window;
  float scale;                // 1 / sqrt(H)
  float scale_log2;           // 1 / sqrt(H) times log2(e)
  long long ob, os, on;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of `bar` with this parity has completed; a wait that
// outlasts any real copy (about 2^30 polls) traps, so a lost arrival is a
// launch error and not a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte swizzled tile:
// start address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barrier `id` over two consumer warpgroups: one waits for its
// turn (sync), the one before it opens it (arrive)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// keeps the compiler from moving accesses of `d` across the asm around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 4 x 4 transpose of 32-bit words across a quad (lanes 4 g .. 4 g + 3):
// lane t holds a[c] = A[t][c] and ends with a[u] = A[u][t], by two
// butterfly exchanges (with lane t ^ 1, then t ^ 2) in which each lane
// sends the word of each pair that its partner keeps
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c & k) continue;                  // the pair (c, c + k)
      const bool hi = t & k;
      const uint32_t recv =
          __shfl_xor_sync(0xffffffffu, hi ? a[c] : a[c + k], k);
      if (hi)
        a[c] = recv;
      else
        a[c + k] = recv;
    }
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D (64 x 128, f32) {+}= A (64 x 16, shared) B (16 x 128, shared),
// bf16, both K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The first k-step of the same product: D = A B, D only written, so
// that its old values need not stay live
__device__ __forceinline__ void wgmma_ss_n128_zero(float (&d)[64], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 64, f32) {+}= A (64 x 16, shared) B (16 x 64, shared): S over
// a tile of 64 keys (H = 256)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64_zero(float (&d)[32],
                                                  uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) B (16 x 256, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int H>
__device__ __forceinline__ void wgmma_pv(float (&o)[H / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (H == 64)
    wgmma_rs_n64(o, a, db);
  else if constexpr (H == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n256(o, a, db);
}

// S {+}= Q K' over one k-step of a tile of BKEYS keys; the first k-step
// overwrites S
template <int BKEYS>
__device__ __forceinline__ void wgmma_s(float (&d)[BKEYS / 2], uint64_t da,
                                        uint64_t db, bool first) {
  if constexpr (BKEYS == 64) {
    if (first)
      wgmma_ss_n64_zero(d, da, db);
    else
      wgmma_ss_n64(d, da, db, 1);
  } else {
    if (first)
      wgmma_ss_n128_zero(d, da, db);
    else
      wgmma_ss_n128(d, da, db, 1);
  }
}

// Persistent and warp specialised. A block stays on its SM and walks the
// work items (BQ query rows of one (batch, head)), one a round in a snake
// over the grid (`walk`), the latest (longest) query tiles first.
// Warpgroups 0 .. CONSUMERS - 1 each own 64 rows of the item; the last
// warpgroup is the producer, whose first thread issues every TMA copy:
// the item's Q into its buffer once the consumers have released it
// (after their last S product of the item before), then K and V tile by
// tile into the ring,
// whose position runs on across items, so the next item's loads overlap
// this item's last tiles and its output stores. setmaxnreg moves the
// producer's registers to the consumers.
// The accumulators use wgmma's fragment layout: in warp w of a warpgroup,
// lane 4 g + t holds for each 8-column tile j the entries (16 w + g,
// 8 j + 2 t + e) at 4 j + e and (16 w + g + 8, 8 j + 2 t + e) at
// 4 j + 2 + e, e in {0, 1}.
template <int H>
__global__ void __launch_bounds__(Layout<H>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ Params a) {
  using L = Layout<H>;
  constexpr int CONSUMERS = L::CONSUMERS, BQ = L::BQ, PANEL_Q = L::PANEL_Q;
  constexpr int BKEYS = L::BKEYS, STAGES = L::STAGES, PANEL_KV = L::PANEL_KV;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled panels start on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, ks = base + L::K_OFF, vs = base + L::V_OFF;
  // mbarriers: full and empty a stage (STAGES each), and where K and V are
  // released apart (SPLIT_KV) V's own full and empty; then q full, q
  // empty. Without the split V's barriers are K's, which then cover both
  constexpr bool SPLIT_KV = L::SPLIT_KV;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars + 8 * (L::BARS - 2), q_empty = q_full + 8;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto empty_k = [&](int s) { return bars + 8 * (STAGES + s); };
  auto full_v = [&](int s) {
    return SPLIT_KV ? bars + 8 * (2 * STAGES + s) : full_k(s);
  };
  auto empty_v = [&](int s) {
    return SPLIT_KV ? bars + 8 * (3 * STAGES + s) : empty_k(s);
  };

  const int BN = a.B * a.N;
  const int qtiles = (a.S + BQ - 1) / BQ;
  const int items = BN * qtiles;
  // item w: its query tile, (batch, head), and the key tiles any of its
  // rows can see (none where tiles <= 0). Query tiles are aligned to S's
  // end, so where BQ does not divide S the partial tile is the first,
  // the shortest under a causal mask: its rows below 0 load as zeros
  // (TMA) and are not stored.
  struct Item {
    int q0, b, n, kt0, tiles;
  };
  auto item = [&](int w) {
    Item it;
    it.q0 = a.S - (1 + w / BN) * BQ;
    it.b = (w % BN) / a.N;
    it.n = (w % BN) % a.N;
    const int q_last = it.q0 + BQ - 1;
    const int k_end = a.causal ? min(a.T, q_last + 1) : a.T;
    const int k_begin = a.window > 0 ? max(0, it.q0 - a.window + 1) : 0;
    it.kt0 = k_begin / BKEYS;
    it.tiles = (k_end + BKEYS - 1) / BKEYS - it.kt0;
    return it;
  };
  // the item of a block's round: round k covers items k G .. k G + G - 1
  // (G = gridDim.x), which block b takes in a snake, k G + b in even
  // rounds and k G + G - 1 - b in odd ones, so that a block that drew one
  // of a round's longest items draws one of the next round's shortest
  auto walk = [&](int k) {
    const int G = gridDim.x;
    return k * G + (k & 1 ? G - 1 - blockIdx.x : blockIdx.x);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);                   // the producer's copy
      mbar_init(empty_k(s), 4 * CONSUMERS);      // every consumer warp
      if (SPLIT_KV) {
        mbar_init(full_v(s), 1);
        mbar_init(empty_v(s), 4 * CONSUMERS);
      }
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      int ring = 0;
      for (int round = 0, w; (w = walk(round)) < items; ++round) {
        const Item it = item(w);
        const int kvh = it.n / a.G;
        mbar_wait(q_empty, (round & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int pn = 0; pn < L::PANELS; ++pn)
          tma_load(qs + pn * PANEL_Q, &a.q, 64 * pn, it.q0, it.n, it.b,
                   q_full);
        for (int j = 0; j < it.tiles; ++j, ++ring) {
          const int s = ring % STAGES, phase = ((ring / STAGES) & 1) ^ 1;
          const int k0 = (it.kt0 + j) * BKEYS;
          mbar_wait(empty_k(s), phase);
          mbar_expect_tx(full_k(s), (SPLIT_KV ? 1 : 2) * L::KV_BYTES);
          for (int pn = 0; pn < L::PANELS; ++pn)
            tma_load(ks + s * L::KV_BYTES + pn * PANEL_KV, &a.k, 64 * pn, k0,
                     kvh, it.b, full_k(s));
          if (SPLIT_KV) {
            mbar_wait(empty_v(s), phase);
            mbar_expect_tx(full_v(s), L::KV_BYTES);
          }
          for (int pn = 0; pn < L::PANELS; ++pn)
            tma_load(vs + s * L::KV_BYTES + pn * PANEL_KV, &a.v, 64 * pn, k0,
                     kvh, it.b, full_v(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t qa = qs + wg * 64 * 128;
    const float sl2 = a.scale_log2;

    float o[H / 2], sc[BKEYS / 2], m[2] = {}, l[2] = {}, alpha[2] = {};
    uint32_t pa[BKEYS / 16][4];
    int wr0 = 0, row[2] = {0, 0};

    // S = Q K' over the tile in stage s, unscaled, issued (not waited for)
    auto issue_s = [&](int s) {
      const uint32_t kb = ks + s * L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint64_t da =
            sw128(qa + (kk / 4) * PANEL_Q + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            sw128(kb + (kk / 4) * PANEL_KV + (kk % 4) * 32, 16, 1024);
        wgmma_s<BKEYS>(sc, da, db, kk == 0);
      }
      wgmma_commit();
    };
    // O += P V over the tile in stage s: P rounded to bf16 as the register
    // A operand, V read through the transpose bit; issued
    auto issue_pv = [&](int s) {
      const uint32_t vb = vs + s * L::KV_BYTES;
#pragma unroll
      for (int kc = 0; kc < BKEYS / 16; ++kc)
        wgmma_pv<H>(o, pa[kc], sw128(vb + kc * 16 * 128, PANEL_KV, 1024));
      wgmma_commit();
    };
    // the online softmax of the scores in sc, of the tile at key k0: sc
    // becomes p (0 where masked), m and l move on, and alpha is the factor
    // that O takes before this tile's P V is added
    auto softmax = [&](int k0) {
      // the mask, only on tiles that cross T's end, the diagonal or the
      // window's edge for some row of this warpgroup: row r sees keys
      // lo[r] .. hi[r]
      const bool edge = k0 + BKEYS > a.T ||
                        (a.causal && k0 + BKEYS - 1 > wr0) ||
                        (a.window > 0 && k0 <= wr0 + 63 - a.window);
      if (edge) {
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          hi[r] = a.causal ? min(row[r], a.T - 1) : a.T - 1;
          lo[r] = a.window > 0 ? row[r] - a.window + 1 : 0;
        }
#pragma unroll
        for (int i = 0; i < BKEYS / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          sc[i] = (key >= lo[r]) & (key <= hi[r]) ? sc[i] : -INFINITY;
        }
      }
      // row maxima as four interleaved chains (max is exact in any order)
      float mx4[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx4[r][c] = m[r];
#pragma unroll
      for (int i = 0; i < BKEYS / 2; ++i)
        mx4[(i >> 1) & 1][(i >> 2) & 3] =
            fmaxf(mx4[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
      float mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(mx4[r][0], mx4[r][1]),
                         fmaxf(mx4[r][2], mx4[r][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row that has seen no visible key yet keeps alpha = 1, p = 0
        const bool none = mx == -INFINITY;
        alpha[r] = none ? 1.f : ex2((m[r] - mx) * sl2);
        mb[r] = none ? 0.f : mx * sl2;
        m[r] = mx;
      }
      // p, and this lane's share of the row sums in four chains
      float sum4[2][4] = {};
#pragma unroll
      for (int i = 0; i < BKEYS / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], sl2, -mb[r]));
        sum4[r][(i >> 2) & 3] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] +
               ((sum4[r][0] + sum4[r][1]) + (sum4[r][2] + sum4[r][3]));
    };
    // O takes alpha and P is packed to bf16 A fragments, once the last
    // P V has completed
    auto rescale_pack = [&]() {
#pragma unroll
      for (int i = 0; i < H / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kc = 0; kc < BKEYS / 16; ++kc) {
        pa[kc][0] = pack2(sc[8 * kc + 0], sc[8 * kc + 1]);
        pa[kc][1] = pack2(sc[8 * kc + 2], sc[8 * kc + 3]);
        pa[kc][2] = pack2(sc[8 * kc + 4], sc[8 * kc + 5]);
        pa[kc][3] = pack2(sc[8 * kc + 6], sc[8 * kc + 7]);
      }
    };
    // Round robin: the warpgroups take turns at issuing their products
    // (named barrier 1 + wg is this warpgroup's turn, opened by the one
    // before it), so that the others' softmaxes run while one's products
    // hold the tensor cores. In an item each warpgroup has tiles + 1
    // turns; the last warpgroup opens warpgroup 0's first turn and opens
    // none after its own last one.
    int turns = 0, turn = 0;
    auto turn_begin = [&]() { named_sync(1 + wg); };
    auto turn_end = [&]() {
      if (wg != CONSUMERS - 1 || ++turn < turns)
        named_arrive(1 + (wg + 1) % CONSUMERS);
    };
    // this warp's share of releasing Q, after the item's last S product
    auto release_q = [&]() {
      if (lane == 0) mbar_arrive(q_empty);
    };

    int ring = 0;
    for (int round = 0, w; (w = walk(round)) < items; ++round) {
      const Item it = item(w);
      wr0 = it.q0 + 64 * wg;                   // this warpgroup's first row
      row[0] = wr0 + 16 * warp + g;
      row[1] = row[0] + 8;
#pragma unroll
      for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      turns = it.tiles + 1;
      turn = 0;

      mbar_wait(q_full, round & 1);
      if (it.tiles <= 0) {
        release_q();
      } else {
        if (wg == CONSUMERS - 1) named_arrive(1);
        int s = ring % STAGES;
        mbar_wait(full_k(s), (ring / STAGES) & 1);
        turn_begin();
        wgmma_fence();
        issue_s(s);
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        if (SPLIT_KV && lane == 0) mbar_arrive(empty_k(s));
        if (it.tiles == 1) release_q();
        softmax(it.kt0 * BKEYS);
        rescale_pack();
        // tile j: S of tile j and P V of tile j - 1 in flight together,
        // then the softmax of tile j while that P V runs
        for (int j = 1; j < it.tiles; ++j) {
          const int sp = s;
          s = (ring + j) % STAGES;
          mbar_wait(full_k(s), ((ring + j) / STAGES) & 1);
          if (SPLIT_KV) mbar_wait(full_v(sp), ((ring + j - 1) / STAGES) & 1);
          turn_begin();
          wgmma_fence();
          issue_s(s);
          issue_pv(sp);
          turn_end();
          wgmma_wait<1>();
          fence_regs(sc);
          if (SPLIT_KV && lane == 0) mbar_arrive(empty_k(s));  // K is free
          if (j == it.tiles - 1) release_q();
          softmax((it.kt0 + j) * BKEYS);
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(empty_v(sp)); // V (and K) are free
          rescale_pack();
        }
        if (SPLIT_KV)
          mbar_wait(full_v(s), ((ring + it.tiles - 1) / STAGES) & 1);
        turn_begin();
        wgmma_fence();
        issue_pv(s);
        turn_end();
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v(s));
        ring += it.tiles;
      }

      // out = O / l in bf16, a quad's words transposed in blocks of four
      // 8-column tiles, so that lane t stores the 16 bytes of tile 4 m + t
      // (a store instruction writes 64 bytes of each of 8 rows, not 16)
      __nv_bfloat16* op =
          static_cast<__nv_bfloat16*>(a.o) + it.b * a.ob + it.n * a.on;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        lr = fmaxf(lr, 1e-30f);
        // o / lr as the correctly rounded reciprocal, its product and one
        // exact correction (Markstein): the division's bits, without a
        // division's instructions for each of the row's H / 4 columns
        const float rl = 1.f / lr;
        auto div = [&](float x) {
          const float q = __fmul_rn(x, rl);
          return fmaf(fmaf(-q, lr, x), rl, q);
        };
        const bool stored = row[r] >= 0 && row[r] < a.S;
        // the row log-sum-exp in natural-log units: m is the raw score's
        // running max (-inf where the row saw no key, written as the
        // plain version's -1e30 + log(1e-30), which rounds to -1e30)
        if (a.lse != nullptr && stored && t == 0)
          a.lse[((long long)it.b * a.N + it.n) * a.S + row[r]] =
              m[r] == -INFINITY
                  ? -1e30f
                  : __fadd_rn(__fmul_rn(m[r], a.scale), logf(lr));
        __nv_bfloat16* orow = op + (long long)row[r] * a.os;
#pragma unroll
        for (int mt = 0; mt < H / 32; ++mt) {
          uint32_t w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 4 * mt + c;
            w[c] = pack2(div(o[4 * j + 2 * r]), div(o[4 * j + 2 * r + 1]));
          }
          quad_transpose(w, t);
          if (stored)
            *reinterpret_cast<uint4*>(orow + 8 * (4 * mt + t)) =
                make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: taken from the driver library
// at run time, so the build links nothing beyond the runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A (B, rows, heads, H) bf16 operand read through its strides (elements)
// as boxes of `box_rows` rows by 64 columns of one head: dims (H, rows,
// heads, B), the order flash kernels on Hopper use, zero fill past rows
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int rows,
                int heads, int H, long long sb, long long ss, long long sn,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H>
int launch(const Args& x, int B, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int K = x.N / x.G;
  Params p;
  constexpr int BQ = Layout<H>::BQ, BKEYS = Layout<H>::BKEYS;
  if (!tensor_map(&p.q, x.q, B, x.S, x.N, H, x.qb, x.qs, x.qn, BQ) ||
      !tensor_map(&p.k, x.k, B, x.T, K, H, x.kb, x.ks, x.kn, BKEYS) ||
      !tensor_map(&p.v, x.v, B, x.T, K, H, x.vb, x.vs, x.vn, BKEYS))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = x.o;
  p.lse = x.lse;
  p.B = B;
  p.S = x.S;
  p.T = x.T;
  p.N = x.N;
  p.G = x.G;
  p.causal = x.causal;
  p.window = x.window;
  p.scale = x.scale;
  p.scale_log2 = x.scale * 1.4426950408889634f;
  p.ob = x.ob;
  p.os = x.os;
  p.on = x.on;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<H>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one persistent block per SM, or one per item where there are fewer
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)B * x.N * ((x.S + BQ - 1) / BQ);
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_wgmma<H>
      <<<grid, Layout<H>::THREADS, Layout<H>::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

// bf16 on the wgmma design, float32 on the 3xTF32 one
int dispatch(const Args& a, bool bf16, int H, int B, int device,
             cudaStream_t stream) {
  switch (H) {
    case 64:
      return bf16 ? hopper::launch<64>(a, B, device, stream)
                  : launch<64>(a, B * a.N, device, stream);
    case 128:
      return bf16 ? hopper::launch<128>(a, B, device, stream)
                  : launch<128>(a, B * a.N, device, stream);
    case 256:
      return bf16 ? hopper::launch<256>(a, B, device, stream)
                  : launch<256>(a, B * a.N, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, N, H), k/v (B, T, K, H) -> o (B, S, N, H), all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1); strides in elements, the last
// axis contiguous, rows 16-byte aligned (the wrapper checks). With `lse`
// (float32 (B, N, S), contiguous; the training forward) each row's
// log-sum-exp m + log(max(l, 1e-30)) in natural-log units is written too,
// m the running max of the scaled scores (-1e30 where the row saw no key);
// serving passes null and writes none.
extern "C" int flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int bf16, int B, int S, int T, int N, int K, int H, long long qb,
    long long qs, long long qn, long long kb, long long ks, long long kn,
    long long vb, long long vs, long long vn, long long ob, long long os,
    long long on, int causal, int window, float scale, int device,
    void* stream) {
  if (K <= 0 || N % K != 0 || B <= 0 || S <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  o,  S,  T,  N,  N / K, causal, window, scale,
               qb, qs, qn, kb, ks, kn, vb, vs,    vn,     ob,     os,
               on, lse};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(a, bf16 != 0, H, B, device, st);
}

// the same without the log-sum-exp (the serving path's entry)
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int S, int T, int N, int K, int H, long long qb, long long qs,
    long long qn, long long kb, long long ks, long long kn, long long vb,
    long long vs, long long vn, long long ob, long long os, long long on,
    int causal, int window, float scale, int device, void* stream) {
  return flash_attention_fwd_lse(q, k, v, o, nullptr, bf16, B, S, T, N, K, H,
                                 qb, qs, qn, kb, ks, kn, vb, vs, vn, ob, os,
                                 on, causal, window, scale, device, stream);
}
