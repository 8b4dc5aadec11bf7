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
// (4, 256, 8192) X is 33.5 MB: 0.010 ms at 3.35 TB/s. So the fused design
// reads X once: the forward product and the back-projection use the same
// copy of each row.
//
// Fused design. The TPU kernel tiled the feature axis (bp < p) and
// carried its accumulator along a sequential sample axis of its grid;
// Hopper's blocks run in parallel and in no order.
//
// * The feature axis is split over a thread-block cluster of C blocks
//   (C <= 8, a portable size). A cluster owns a chunk of consecutive
//   samples of one task; its rank k owns the vectors [k sv, (k + 1) sv)
//   of each row (sv = ceil(pv / C); a vector is a float4 where p % 4 == 0
//   and the pointers are 16-byte aligned, else a float; pv vectors a
//   row), and thread i the vectors k sv + i + 256 j. For each row a block
//   sums its threads' partial products with b_t (a warp reduce-scatter
//   over the rows of a group, then the warps in order) into its own
//   shared memory; after a cluster barrier every rank reads the C
//   partials of the row from its peers through distributed shared memory
//   (`mapa`, `ld.shared::cluster`), in rank order, so every rank gets the
//   same z and residual, and back-projects its own slice. Only the threads
//   that wrote partials fence (`fence.acq_rel.cluster`); all arrive
//   relaxed, so the other threads' arrivals wait on nothing of their own.
//   The partials are double-buffered, so one cluster barrier a group of
//   rows suffices; after its last read a block arrives at one more
//   barrier, and waits on it just before it exits, so that no block
//   leaves while a peer still reads its shared memory. At (4, 256, 8192),
//   C = 8: 4 KB row slices and 288 blocks where one 229 KB slab block an
//   SM gave 64. That exchange is what this shape pays over the C = 1 one
//   (PERF.md, section 6, measures it and the alternatives that lost to it:
//   pushing the sums behind a split barrier, which costs a group of
//   look-ahead, point-to-point mbarriers, and clusters of 4 or 2).
// * Rows are staged by `cp.async` into a ring in shared memory that each
//   thread fills and reads for its own vectors only (and thread r for
//   row r's y), so the ring needs no barrier, only `cp.async.wait_group`,
//   and copies stay in flight through the reduction's barriers.
// * Registers (`logistic_grad_kernel`, mode REGISTERS): where a thread's
//   share of a row slice is at most V_MAX vectors, its share of b_t and of
//   the accumulator live in registers, and the rows go in groups of
//   R = GROUP_VECS / V through a ring of GROUP_STAGES groups, two groups
//   ahead: 48 KB a block at a 4 KB slice, so four blocks share an SM and
//   the 512 or 288 blocks of the path shapes are resident at once. (The
//   next group held in registers instead took 92 registers: two blocks an
//   SM, so two waves.)
// * Ring (`logistic_grad_rows_kernel<true>`, mode RING): a wider slice
//   goes a row at a time through a ring of STAGES row slices, STAGES - 1
//   rows ahead, beside the slice of b_t and of the accumulator in shared
//   memory. Where that does not fit in the per-block limit (mode TWICE,
//   `logistic_grad_rows_kernel<false>`), a block reads its rows from
//   global memory twice, b_t from global memory, and keeps the
//   accumulator in its workspace row.
// * The sample reduction. Each block writes its partial slice into a
//   workspace (m, chunks, p), fences, and takes a ticket from the counter
//   of its (task, rank). The block that draws the last ticket adds the
//   `chunks` partial slices in chunk order, scales by -1/n, writes its
//   slice of g_t and resets the counter to 0, so the counters are 0
//   between launches and the host keeps them. At (4, 256, 8192): 32 tail
//   blocks of 36 KB each, not 4 of 512 KB; at (16, 512, 1024), 16 of
//   128 KB. No block waits for another
//   outside its cluster, and no float atomics: every sum (lanes, warps,
//   ranks, chunks) runs in a fixed order, so two launches give the same
//   bits.
// * The plan (`grad_plan`, mirrored by kernels/logistic_grad/ops.py::plan;
//   `logistic_grad_plan` returns the launcher's choice): the smallest C
//   (a power of two, at most 8, no slice under 256 vectors) whose slice
//   fits in registers and whose grid gives BLOCKS_PER_SM blocks an SM;
//   chunks for that many blocks (SOLO_BLOCKS_PER_SM where C = 1: blocks
//   that wait on no peer gain from being more and shorter, a cluster's
//   lose), but no more partial slices a tail block than TAIL_BYTES; and
//   no empty chunk. A cluster launch goes through
//   `cudaLaunchKernelEx`, after `cudaOccupancyMaxActiveClusters` confirms
//   that the card can place a cluster at the plan's shared memory; a
//   launch it refuses returns its error.
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

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// the fused kernel's plan (ops.py agrees on each)
constexpr int CLUSTER_MAX = 8;     // blocks of a cluster, portable
constexpr int V_MAX = 4;           // a thread's vectors of a row slice held
                                   // in registers
constexpr int GROUP_VECS = 4;      // rows x vectors of a register group
constexpr int GROUP_STAGES = 3;    // groups in the register kernel's ring
constexpr int STAGES = 3;          // row slices in the ring kernel's ring
constexpr int BLOCKS_PER_SM = 2;   // blocks the plan gives every SM, at least
constexpr int SOLO_BLOCKS_PER_SM = 4;  // what chunks aim at where C = 1
constexpr long long TAIL_BYTES = 512 * 1024;  // partial slices a tail block
                                              // adds, at most
constexpr int STATIC_SMEM = 512;   // the kernels' static shared memory,
                                   // rounded up
enum Mode { REGISTERS = 0, RING = 1, TWICE = 2 };


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

// ---- fused ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// The two halves of a cluster barrier: arrive releases this thread's
// shared-memory writes to the cluster, wait acquires the others'. The
// relaxed arrive releases nothing: a thread that wrote for its peers
// fences first (`fence_cluster`), so the other threads' arrivals need not
// wait on their own memory operations.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A float in the shared memory of cluster rank `rank`, at the offset of
// `p` in this block's.
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

// 16 or 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// Sums v[0..R) over the warp's 32 lanes; lane l returns the sum of row
// l / (32 / R). A reduce-scatter: at each of the first log2 R steps a lane
// keeps half of its rows and adds its partner's copy of them (R - 1
// shuffles in all), then the lanes that hold one row add theirs in a
// butterfly (5 - log2 R shuffles). A fixed order.
template <int R>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[R],
                                                     int lane) {
#pragma unroll
  for (int h = R / 2, off = 16; h >= 1; h /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (int off = 16 / R; off >= 1; off /= 2)
    s += __shfl_xor_sync(FULL, s, off);
  return s;
}

struct GradArgs {
  const float* X;
  const float* y;
  const float* B;
  float* work;                 // (m, chunks, p): partial slices
  unsigned int* counters;      // (m, C): 0 between launches
  float* G;
  int n, p;
  int rows;                    // samples per chunk
  int csize;                   // blocks of a cluster, C
};

// Where a block works: task t, chunk c of `chunks`, cluster rank `rank`,
// its rows [r0, r1) and its slice's vectors [base, qe).
struct Tile {
  int t, c, chunks, rank, r0, r1, pv, base, qe;
  __device__ Tile(const GradArgs& a, int width) {
    t = blockIdx.y;
    rank = cluster_rank();
    c = blockIdx.x / a.csize;
    chunks = gridDim.x / a.csize;
    r0 = c * a.rows;
    r1 = min(a.n, r0 + a.rows);
    pv = a.p / width;
    const int sv = (pv + a.csize - 1) / a.csize;
    base = rank * sv;
    qe = min(pv, base + sv);
  }
};

// The shared memory of a group's exchange: the warps' partials, the
// block's (double-buffered, read by the cluster) and the residuals.
struct Exchange {
  float red[WARPS][GROUP_VECS];
  float zpart[2][GROUP_VECS];
  float rs[GROUP_VECS];
};

// The residuals of a group of R rows from each thread's partial products
// zp: summed over the warp's lanes, the warps in order, then, in a
// cluster, the ranks in order through distributed shared memory. Leaves
// rs[r] = y_r sigmoid(-y_r z_r) (0 past the nrows valid rows) for every
// thread of the block. yv is y of row tid, in threads tid < R.
template <int R>
__device__ __forceinline__ void group_residuals(float (&zp)[R], float yv,
                                                int nrows, int csize,
                                                int buf, Exchange& ex) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const float s = warp_reduce_scatter<R>(zp, lane);
  if (lane % (32 / R) == 0) ex.red[tid / 32][lane / (32 / R)] = s;
  __syncthreads();
  float z = 0.f;
  if (tid < R) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) z += ex.red[w][tid];
    ex.zpart[buf][tid] = z;
  }
  if (csize > 1) {
    if (tid < R) fence_cluster();      // zpart, released to the peers
    __syncwarp();
    cluster_arrive_relaxed();
    cluster_wait();
    if (tid < R) {
      float part[CLUSTER_MAX];
#pragma unroll
      for (int k = 0; k < CLUSTER_MAX; ++k)
        if (k < csize) part[k] = ld_cluster(&ex.zpart[buf][tid], k);
      z = 0.f;
#pragma unroll
      for (int k = 0; k < CLUSTER_MAX; ++k)
        if (k < csize) z += part[k];
    }
  }
  if (tid < R) ex.rs[tid] = tid < nrows ? yv * sigmoid(-yv * z) : 0.f;
  __syncthreads();
}

// After the block's partial slice is in its workspace row: the ticket,
// and in the block that draws the last one of its (task, rank), the sum of
// the `chunks` partial slices in chunk order, scaled by -1/n, into g_t.
template <typename T>
__device__ __forceinline__ void reduce_chunks(const GradArgs& a,
                                              const Tile& w) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  unsigned int* counter = a.counters + (size_t)w.t * a.csize + w.rank;
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == (unsigned int)(w.chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const T* wt = reinterpret_cast<const T*>(a.work +
                                           (size_t)w.t * w.chunks * a.p);
  T* gt = reinterpret_cast<T*>(a.G + (size_t)w.t * a.p);
  const float fn = (float)a.n;
  for (int q = w.base + threadIdx.x; q < w.qe; q += THREADS) {
    T s = zero<T>();
    int cc = 0;
    for (; cc + 8 <= w.chunks; cc += 8) {    // eight loads in flight
      T v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __ldcg(wt + (size_t)(cc + i) * w.pv + q);
#pragma unroll
      for (int i = 0; i < 8; ++i) s = add(s, v[i]);
    }
    for (; cc < w.chunks; ++cc) s = add(s, __ldcg(wt + (size_t)cc * w.pv + q));
    gt[q] = neg_div(s, fn);
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// Mode REGISTERS: thread i holds vectors l = i + THREADS v (v < V) of the
// slice of b_t and of the accumulator in registers, and takes its rows
// R = GROUP_VECS / V at a time. The rows come through a ring of
// GROUP_STAGES groups in dynamic shared memory, GROUP_STAGES - 1 groups
// ahead (y with them); each thread copies and reads only its own vectors
// and rows' y, so the ring needs no barrier, only `cp.async.wait_group`.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, V == 4 ? 3 : 4)
logistic_grad_kernel(const GradArgs a) {
  constexpr int W = sizeof(T) / sizeof(float);
  constexpr int R = GROUP_VECS / V;
  const Tile w(a, W);
  const int tid = threadIdx.x;
  const int len = w.qe - w.base;                  // may be <= 0
  const int sv = (w.pv + a.csize - 1) / a.csize;  // ring stride
  const T* Xs = reinterpret_cast<const T*>(a.X + (size_t)w.t * a.n * a.p) +
                w.base;
  const T* bg = reinterpret_cast<const T*>(a.B + (size_t)w.t * a.p) + w.base;
  const float* yt = a.y + (size_t)w.t * a.n;
  __shared__ Exchange ex;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);          // [GROUP_STAGES][R][sv]
  float* ys = reinterpret_cast<float*>(ring + (size_t)GROUP_STAGES * R * sv);

  T b[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int l = tid + v * THREADS;
    b[v] = l < len ? bg[l] : zero<T>();
    acc[v] = zero<T>();
  }
  auto issue = [&](int row0, int stage) {     // one commit group a group
    if (row0 < w.r1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (row0 + r < w.r1) {
          const T* xr = Xs + (size_t)(row0 + r) * w.pv;
          T* st = ring + (size_t)(stage * R + r) * sv;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int l = tid + v * THREADS;
            if (l < len) cp_async(st + l, xr + l);
          }
        }
      }
      if (tid < R && row0 + tid < w.r1)
        cp_async(ys + stage * R + tid, yt + row0 + tid);
    }
    cp_async_commit();
  };
  for (int s = 0; s < GROUP_STAGES - 1; ++s) issue(w.r0 + s * R, s);
  int buf = 0;
  for (int row0 = w.r0, g = 0; row0 < w.r1; row0 += R, ++g, buf ^= 1) {
    issue(row0 + (GROUP_STAGES - 1) * R, (g + GROUP_STAGES - 1) % GROUP_STAGES);
    cp_async_wait<GROUP_STAGES - 1>();          // this group's copies landed
    const int stage = g % GROUP_STAGES;
    const int nrows = min(R, w.r1 - row0);
    T x[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* st = ring + (size_t)(stage * R + r) * sv;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int l = tid + v * THREADS;
        x[r][v] = r < nrows && l < len ? st[l] : zero<T>();
      }
    }
    const float yv = tid < nrows ? ys[stage * R + tid] : 0.f;
    float zp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      zp[r] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) zp[r] = fma_dot(x[r][v], b[v], zp[r]);
    }
    group_residuals<R>(zp, yv, nrows, a.csize, buf, ex);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        const float rr = ex.rs[r];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fma_axpy(x[r][v], rr, acc[v]);
      }
    }
  }
  if (a.csize > 1) cluster_arrive();     // this block reads no peer again

  T* part = reinterpret_cast<T*>(a.work +
                                 ((size_t)w.t * w.chunks + w.c) * a.p) +
            w.base;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int l = tid + v * THREADS;
    if (l < len) part[l] = acc[v];
  }
  reduce_chunks<T>(a, w);
  if (a.csize > 1) cluster_wait();       // no peer reads this block again
}

// Modes RING (STAGED) and TWICE: a row at a time. Thread i owns the
// slice's vectors l = i + THREADS j (column base + l). STAGED: the ring,
// b_t's slice and the accumulator's in dynamic shared memory, each
// indexed by l, the ring STAGES - 1 rows ahead; else X's rows twice from
// global memory, b_t from global memory and the accumulator in the
// block's workspace row.
template <bool STAGED, typename T>
__global__ void __launch_bounds__(THREADS)
logistic_grad_rows_kernel(const GradArgs a) {
  constexpr int W = sizeof(T) / sizeof(float);
  const Tile w(a, W);
  const int tid = threadIdx.x;
  const int len = w.qe - w.base;                  // may be <= 0
  const int sv = (w.pv + a.csize - 1) / a.csize;  // ring stride
  const T* Xs = reinterpret_cast<const T*>(a.X + (size_t)w.t * a.n * a.p) +
                w.base;
  const T* bg = reinterpret_cast<const T*>(a.B + (size_t)w.t * a.p) + w.base;
  T* part = reinterpret_cast<T*>(a.work +
                                 ((size_t)w.t * w.chunks + w.c) * a.p) +
            w.base;
  const float* yt = a.y + (size_t)w.t * a.n;
  __shared__ Exchange ex;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  T* bs = ring + (size_t)STAGES * sv;
  T* accs = bs + sv;
  float* ys = reinterpret_cast<float*>(accs + sv);    // [STAGES]

  for (int l = tid; l < len; l += THREADS) {
    if (STAGED) {
      bs[l] = bg[l];
      accs[l] = zero<T>();
    } else {
      part[l] = zero<T>();
    }
  }
  auto issue = [&](int row, int stage) {     // one commit group a row
    if (row < w.r1) {
      const T* xr = Xs + (size_t)row * w.pv;
      T* st = ring + (size_t)stage * sv;
      for (int l = tid; l < len; l += THREADS) cp_async(st + l, xr + l);
      if (tid == 0) cp_async(ys + stage, yt + row);
    }
    cp_async_commit();
  };
  if (STAGED)
    for (int s = 0; s < STAGES - 1; ++s) issue(w.r0 + s, s);
  int buf = 0;
  for (int row = w.r0, j = 0; row < w.r1; ++row, ++j, buf ^= 1) {
    const T* xs = Xs + (size_t)row * w.pv;
    const T* bv = bg;
    T* av = part;
    float yv = 0.f;
    if (STAGED) {
      issue(row + STAGES - 1, (j + STAGES - 1) % STAGES);
      cp_async_wait<STAGES - 1>();            // this row's copies landed
      xs = ring + (size_t)(j % STAGES) * sv;
      bv = bs;
      av = accs;
      if (tid == 0) yv = ys[j % STAGES];
    } else if (tid == 0) {
      yv = yt[row];
    }
    float zp[1] = {0.f};
    for (int l = tid; l < len; l += THREADS)
      zp[0] = fma_dot(STAGED ? xs[l] : __ldcg(xs + l), bv[l], zp[0]);
    group_residuals<1>(zp, yv, 1, a.csize, buf, ex);
    const float rr = ex.rs[0];
    for (int l = tid; l < len; l += THREADS)
      av[l] = fma_axpy(STAGED ? xs[l] : __ldcg(xs + l), rr, av[l]);
  }
  if (a.csize > 1) cluster_arrive();     // this block reads no peer again
  if (STAGED) {
    cp_async_wait<0>();
    for (int l = tid; l < len; l += THREADS) part[l] = accs[l];
  }
  reduce_chunks<T>(a, w);
  if (a.csize > 1) cluster_wait();       // no peer reads this block again
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

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

struct GradPlan {
  int chunks;      // clusters per task, each a run of consecutive samples
  int rows;        // samples per chunk
  int cluster;     // C: blocks of a cluster, one column slice each
  int mode;        // REGISTERS, RING or TWICE
  int vecs;        // a thread's vectors of a row slice (REGISTERS: V)
  int smem;        // dynamic shared memory per block (the ring), or 0
};

// Chunks of the sample axis for a cluster size: enough for `want` blocks,
// no more partial slices per tail block than TAIL_BYTES, no empty chunk.
void grad_chunks(int m, int n, int csize, long long slice_floats,
                 long long want, int* chunks, int* rows) {
  long long ch = cdiv(want, (long long)m * csize);
  ch = std::min(ch, TAIL_BYTES / (4 * slice_floats));
  ch = std::max(std::min(ch, (long long)n), 1LL);
  *rows = static_cast<int>(cdiv(n, ch));
  *chunks = static_cast<int>(cdiv(n, *rows));
}

// The largest cluster a row of p floats allows: a power of two, at most
// CLUSTER_MAX, and no slice under THREADS vectors.
int cluster_max(int p, bool vec) {
  const int width = vec && p % 4 == 0 ? 4 : 1;
  const long long pv = cdiv(p, width);
  int cmax = 1;
  while (cmax * 2 <= CLUSTER_MAX && (long long)cmax * 2 * THREADS <= pv)
    cmax *= 2;
  return cmax;
}

// Whether `csize` is a cluster size that `cluster_max` allows.
bool cluster_allowed(int csize, int p, bool vec) {
  return csize >= 1 && csize <= cluster_max(p, vec) &&
         (csize & (csize - 1)) == 0;
}

// The plan for (m, n, p); `forced` > 0 takes that cluster size (one that
// `cluster_allowed`) instead of the rule's, with the rule's chunks and
// mode for it.
GradPlan grad_plan(int m, int n, int p, bool vec, int sms, int optin,
                   int forced = 0) {
  const int width = vec && p % 4 == 0 ? 4 : 1;
  const long long pv = cdiv(p, width);
  const long long want = (long long)BLOCKS_PER_SM * sms;
  const long long solo = (long long)SOLO_BLOCKS_PER_SM * sms;
  const int cmax = cluster_max(p, vec);
  GradPlan pl{};
  pl.cluster = forced > 0 ? forced : cmax;
  for (int cs = 1; forced <= 0 && cs <= cmax; cs *= 2) {
    const long long sv = cdiv(pv, cs);
    int chunks, rows;
    grad_chunks(m, n, cs, sv * width, cs == 1 ? solo : want, &chunks,
                &rows);
    if (cdiv(sv, THREADS) <= V_MAX && (long long)m * chunks * cs >= want) {
      pl.cluster = cs;
      break;
    }
  }
  const long long sv = cdiv(pv, pl.cluster);
  grad_chunks(m, n, pl.cluster, sv * width, pl.cluster == 1 ? solo : want,
              &pl.chunks, &pl.rows);
  const long long v = cdiv(sv, THREADS);
  const long long ring = (long long)(STAGES + 2) * sv * width * 4 +
                         STAGES * 4;
  pl.vecs = static_cast<int>(v);
  if (v <= V_MAX) {
    pl.mode = REGISTERS;
    if (v == 3) pl.vecs = 4;     // instantiated for V = 1, 2, 4
    const long long rows = GROUP_STAGES * (GROUP_VECS / pl.vecs);
    pl.smem = static_cast<int>(rows * sv * width * 4 + rows * 4);
  } else if (ring + STATIC_SMEM <= optin) {
    pl.mode = RING;
    pl.smem = static_cast<int>(ring);
  } else {
    pl.mode = TWICE;
  }
  return pl;
}

using GradKernel = void (*)(GradArgs);

GradKernel grad_kernel(const GradPlan& pl, bool vec) {
  if (pl.mode == REGISTERS) {
    if (vec)
      return pl.vecs == 1 ? logistic_grad_kernel<float4, 1>
             : pl.vecs == 2 ? logistic_grad_kernel<float4, 2>
                            : logistic_grad_kernel<float4, 4>;
    return pl.vecs == 1 ? logistic_grad_kernel<float, 1>
           : pl.vecs == 2 ? logistic_grad_kernel<float, 2>
                          : logistic_grad_kernel<float, 4>;
  }
  if (pl.mode == RING)
    return vec ? logistic_grad_rows_kernel<true, float4>
               : logistic_grad_rows_kernel<true, float>;
  return vec ? logistic_grad_rows_kernel<false, float4>
             : logistic_grad_rows_kernel<false, float>;
}

// Whether the card can place one cluster of `cfg` for `kern`: asked of
// cudaOccupancyMaxActiveClusters once per (kernel, cluster, shared memory).
cudaError_t check_cluster(GradKernel kern, const cudaLaunchConfig_t& cfg,
                          int csize) {
  struct Seen {
    GradKernel kern;
    int csize, smem;
  };
  static Seen seen[32];
  static int n_seen = 0;
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kern == kern && seen[i].csize == csize &&
        seen[i].smem == smem)
      return cudaSuccess;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kern,
                                                         &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (n_seen < 32) seen[n_seen++] = {kern, csize, smem};
  return cudaSuccess;
}

cudaError_t launch_fused(const GradPlan& pl, bool vec, int m,
                         const GradArgs& args, cudaStream_t s) {
  const GradKernel kern = grad_kernel(pl, vec);
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.chunks * pl.cluster, m);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (pl.cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = check_cluster(kern, cfg, pl.cluster);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&cfg, kern, args);
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

int device_smem_optin(int device) {
  static int bytes[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (bytes[device] == 0)
    cudaDeviceGetAttribute(&bytes[device],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes[device];
}

}  // namespace

// The fused kernel's plan for (m, n, p) on `device`, float4 vectors where
// `vec`: out[0..6] = chunks, rows a chunk, cluster size, mode (0
// registers, 1 ring, 2 twice), a thread's vectors of a row slice, dynamic
// shared memory, and the SM count the rule saw, so that a test can hold
// `ops.plan` to it.
extern "C" int logistic_grad_plan(int m, int n, int p, int vec, int device,
                                  int* out) {
  const int sms = device_sms(device);
  const int optin = device_smem_optin(device);
  if (sms <= 0 || optin <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const GradPlan pl = grad_plan(m, n, p, vec != 0, sms, optin);
  const int v[7] = {pl.chunks, pl.rows, pl.cluster, pl.mode, pl.vecs,
                    pl.smem, sms};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// X (m, n, p), y (m, n), B (m, p) -> G (m, p), in one launch with the
// plan of `logistic_grad_plan`, or, where `plan` is not -1, with a cluster
// of `plan` blocks (1, 2, 4 or 8, at most what `cluster_max` allows for
// p; else cudaErrorInvalidValue and nothing launched) and the rule's
// chunks and mode for it. work holds work_floats floats of scratch, at
// least m * chunks * p; counters holds n_counters unsigned ints, at least
// m * cluster, that are 0 on entry and 0 again when the kernel ends.
// Where `ran` is not null it receives the plan launched (out[0..5] of
// `logistic_grad_plan`).
extern "C" int logistic_grad_f32(const void* X, const void* y, const void* B,
                                 void* work, long long work_floats,
                                 void* counters, long long n_counters,
                                 void* G, int m, int n, int p, int device,
                                 void* stream, int* ran, int plan) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  const int optin = device_smem_optin(device);
  if (sms <= 0 || optin <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (m < 1 || n < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = p % 4 == 0 && aligned16(X) && aligned16(B) &&
                   aligned16(work) && aligned16(G);
  if (plan != -1 && !cluster_allowed(plan, p, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const GradPlan pl = grad_plan(m, n, p, vec, sms, optin, plan);
  if ((long long)m * pl.chunks * p > work_floats ||
      (long long)m * pl.cluster > n_counters)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ran != nullptr) {
    const int v[6] = {pl.chunks, pl.rows, pl.cluster, pl.mode, pl.vecs,
                      pl.smem};
    for (int i = 0; i < 6; ++i) ran[i] = v[i];
  }
  GradArgs args;
  args.X = static_cast<const float*>(X);
  args.y = static_cast<const float*>(y);
  args.B = static_cast<const float*>(B);
  args.work = static_cast<float*>(work);
  args.counters = static_cast<unsigned int*>(counters);
  args.G = static_cast<float*>(G);
  args.n = n;
  args.p = p;
  args.rows = pl.rows;
  args.csize = pl.cluster;
  return static_cast<int>(
      launch_fused(pl, vec, m, args, static_cast<cudaStream_t>(stream)));
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
// X, R -> G (m, p) = -X' R / n. `plan` is -1 for `unfused_plan`'s launch
// shapes, else z * 3 + c: the forward kernel takes Z_PLANS[z] and the
// back-projection UNFUSED_COLS[c] (out of range: cudaErrorInvalidValue,
// nothing launched).
extern "C" int logistic_unfused_f32(const void* X, const void* y,
                                    const void* B, void* R, void* G, int m,
                                    int n, int p, int device, void* stream,
                                    int plan) {
  constexpr int N_Z = sizeof(Z_PLANS) / sizeof(Z_PLANS[0]);
  constexpr int N_COLS = sizeof(UNFUSED_COLS) / sizeof(UNFUSED_COLS[0]);
  if (plan < -1 || plan >= N_Z * N_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int sms = device_sms(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int rpw = 0, wpr = 0, cols = 0;
  if (plan < 0) {
    unfused_plan(m, n, p, sms, &rpw, &wpr, &cols);
  } else {
    rpw = Z_PLANS[plan / N_COLS][0];
    wpr = Z_PLANS[plan / N_COLS][1];
    cols = UNFUSED_COLS[plan % N_COLS];
  }
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
