// Fused masked graph attention, one direction, forward (explicit relations).
//
// Replaces the Pallas TPU kernels
// tf_vqa_regat_tpu/ops/pallas/graph_attention.py::_fwd_kernel_v2 (the one the
// JAX package runs) and ::_fwd_kernel (v1, its per-head loop), and computes
// for every query row r of an example and every head h:
//
//   aff[h, m] = q[r, h] . k[m, h] * scale + bias[r, h, m]     (in that order)
//   w[h, m]   = exp(aff - M) / (sum_m exp(aff - M) + eps)
//   out[r, h] = sum_m w[h, m] vw[m, h, :]
//
// v2 (kPerHead false): M is the row max over ALL heads and eps = 1e-30, as
// _fwd_kernel_v2 normalises, so a head whose segment underflows against
// another head's max gets all-zero weights. v1 (kPerHead true): M is the
// head's own max and eps = 0, the exact per-head softmax of _fwd_kernel. The
// bias (edge labels, adjacency at -9e15, key mask at -9e15) is precombined
// by the caller and read through its strides, so a bias shared across heads
// comes with a head stride of 0 and is never materialised H-fold. The scaled
// dot is rounded before the bias is added (no FMA): a non-edge key's
// affinity then rounds to exactly -9e15, which is what gives an empty
// adjacency row uniform weights over its valid keys.
//
// What bounds it on an H100: at the model's shapes (R=100, H=16, dh=o=64,
// n=20, b=256) the function reads q (105 MB), k and vw (42 MB) and the
// shared bias (2 MB) and writes out (105 MB): ~254 MB, 76 us at 3.35 TB/s,
// for 2.1 GFLOP (31 us at 67 TFLOP/s f32). So it is memory-bound, on q and
// out, and stays in f32 FFMA (tensor cores gain nothing; TF32 would also
// break the 1e-4 agreement with the plain version).
//
// Design. A block takes a chunk of query rows of one example (the wrapper's
// tiling plan sizes it from b: a whole example at b=256, 20 rows at b=32, 8
// at b <= 8, so that ~132 blocks or more are in flight) and stages the
// example's K and VW in shared memory once. Its 512 threads form two groups
// of 256 that walk the chunk's tiles of kTile = 5 rows in turns (group 0
// tiles 0, 2, ...; group 1 tiles 1, 3, ...), each with its own q buffer,
// weights and maxima and its own named barrier. Per tile, three phases:
// affinities (with v2's row max), exponentials, output. What this does about
// the four causes that held the first version (a block per 8 rows, one warp
// per (head, key)):
//  1. Per-pair warp reductions: gone. A thread owns whole (head, key) pairs,
//     two keys of one head, and sums their dh-term dots for every row of the
//     tile in registers, reading the keys as float4 from K in shared memory
//     ([H, n, dh+4]: consecutive pairs sit 4 banks apart, so a warp's
//     16-byte reads never conflict) and each row's q as one float4 that the
//     threads of a head share (q is padded per head as K is). No shuffle
//     remains: v2's row max is one redux.sync per warp and row on the
//     order-preserving integer image of the affinities, merged across warps
//     by a shared-memory atomicMax (exact, and independent of the warps'
//     order); the softmax denominator is summed by the output threads from
//     the weights they read anyway.
//  2. K and VW re-read per 8-row tile: each block copies them once (16-byte
//     cp.async) and every tile of its chunk reads them from shared memory.
//     At b=256 that is once per example (42 MB), not 13 times.
//  3. Serialised phases with no copy overlap: a group copies its next tile's
//     q (cp.async) as soon as its affinities are done, under its own
//     exponentials and output and the other group's work; while one group
//     waits at a barrier, the other's phases keep the SM busy. Output stores
//     are float4 and need no barrier. The staging of K and VW at a block's
//     start is not overlapped: one block fills an SM's shared memory
//     (~221 KB at the model's widths).
//  4. Idle lanes: the 160 two-key items of the affinity phase fill 5 of a
//     group's 8 warps in one round; the exponentials run one thread per 4
//     keys of a (row, head); the output one thread per (head, 4 channels),
//     256 at the model's widths, every row of the tile unrolled. The
//     predicate on ragged rows guards only loads of the bias and stores.
// Measured on an H100 (PERF.md), the kernel sits at ~2.4x its bound: every
// phase adds its shared-memory reads to the same load/store path that the
// q copies and output stores use, so memory and arithmetic overlap only in
// part.
// All three steps of the plan landed: K staged with no warp reduction (step
// 1), a row chunk per block with K and VW staged once and q tiles copied
// ahead by cp.async (step 2; double-buffered across the two groups rather
// than within one, which the shared memory would not hold), and the float4
// output with lane-efficient softmax (step 3). No tensor cores, clusters or
// persistent scheduling; the two groups do the same work, so there is no
// warp specialisation either: the work is memory-bound.
// A v2 launch under grad also stores the row max [b, R] (`rowmax`, the
// exact max the exponentials took), for the backward; with a null pointer
// (eval, serve, predict) nothing more is stored.
//
// Backward: graph_attention_bwd_kernel and graph_attention_bwd_reduce give
// (dq, dk, dvw, dbias) for the output cotangent g. They replace the JAX
// package's VJP tf_vqa_regat_tpu/ops/pallas/graph_attention.py::_fused_bwd,
// which is XLA, not a Pallas kernel, and compute what its PyTorch
// transcription (graph_attention_backward in the wrapper) computes:
//
//   w        the forward's weights, rebuilt from q, k and the bias with the
//            same dot, the same `* scale + bias` order and, v2, the saved
//            row max (the max over all heads, so that a block needs only its
//            own heads); v1 the segment's own max
//   dvw[m]   = sum_r w[r, m] g[r]               dw[r, m] = g[r] . vw[m]
//   daff     = w (dw - sum_m w dw)              (the max taken as constant)
//   dq[r]    = scale sum_m daff[r, m] k[m]      dk[m] = scale sum_r daff[r, m] q[r]
//   dbias    daff in the bias's head layout: summed over all H heads, in
//            head order, for a bias shared across heads ([b, R, 1, n], the
//            model's); daff itself for a per-head bias (the wrapper sums any
//            other broadcast down)
//
// What bounds it: at the model's shapes (b=256, R=100, H=16, n=20,
// dh=o=64) a direction reads g and q (105 MB each), k and vw (21 MB each)
// and the shared bias (2 MB), and writes dq (105 MB), dk and dvw (21 MB
// each) and dbias (2 MB): ~403 MB, 120 us at 3.35 TB/s, for 5.2 GFLOP
// (78 us at 67 TFLOP/s f32). The transcription it replaces on the card
// wrote six [b, R, H, n] tensors of 33 MB (affinities, exponentials,
// weights, dw, w dw, daff) and copied q and g into the layouts of four
// batched products.
//
// Design (from csrc/implicit_attention.cu's backward, without its pos-FC
// phase): a block of 256 threads per (example, head group of hb heads,
// chunk of query rows), two blocks in flight per SM, so that one block's
// phases fill the other's barriers (the wrapper's backward_plan: the whole
// example and 4 heads at b=256, H=16: 88,640 B of shared memory a block);
// nothing of size [b, R, H, n] leaves the block.
//   - The group's K and VW are staged once by cp.async, rows padded to
//     dh+4 and o+4 so that a quarter-warp's 16-byte reads of 8 rows hit 8
//     bank groups.
//   - 8-row tiles of q, g, the bias (one head's row where it is shared) and
//     the row maxima stream through two buffers: tile t + 1's cp.async
//     copies run during tile t's phases.
//   - Per tile, between block barriers: A, the dots q . k and g . vw, a
//     thread per (product, head, 2 keys, 4 rows), so that each 16-byte read
//     of shared memory serves 2 or 4 dots (a thread per (head, key) and 8
//     rows took 1.3x longer, 4 keys and 4 rows 1.2x: fewer warps); B-D, a
//     group of 8 lanes per (row, head): the affinities and, v2, their
//     exponentials as the forward builds them (the same dot, order of
//     rounding and row max, so the same bits), v1 the segment's own max
//     and exponentials, the denominator and sum_m w dw by xor shuffles in a
//     fixed order, then w and daff (a per-head bias's gradient stored
//     here); then E, F and G, which only read: dq (a thread per head and 4
//     channels, float4 stores), the dK and dVW sums, and a shared bias's
//     gradient (daff over the group's heads, a thread per (row, key)).
//   - dK and dVW are sums over the chunk's rows kept in registers (10 keys
//     of one head and 4 channels per thread), added in row order and stored
//     once; with several row chunks per example (small b) each chunk stores
//     its sums and the reduce adds them in chunk order. With several head
//     groups a shared bias's gradient is summed per group, and the reduce
//     adds the groups in group order.
//   - No atomics: two launches on the same inputs give equal bits.
//   - The model's widths (n = 20, dh = o = 64, so 4 heads a block for any
//     H the configurations give) run an instance whose widths are template
//     parameters (kBwdInstances), in both softmax modes; every other shape
//     the wrapper's plan takes runs the general instance, the same code
//     with its widths read at run time.
// Measured on an H100 (PERF.md): 0.33-0.35 ms a direction at the model's
// shapes, ~35% of the bound, against 1.36 ms for the transcription; 512
// threads and one block per SM took 1.1x longer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 2;  // tile pipelines per block, sharing K and VW
constexpr int kGroupThreads = 256;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kTile = 5;  // query rows per tile

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Barrier of one group's threads only (named barrier 1 + g; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(kGroupThreads) : "memory");
}

// A float as an int whose signed order is the float's order (no NaN), so
// that the row max is an integer max: exact, and independent of the order in
// which the warps reach it.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Shared-memory layout, in floats (every region a multiple of 4, so each
// starts 16-byte aligned). nP = n rounded up to 4; dP = dh + 4.
struct Layout {
  int k, vw, q, w, mx, group, total;
  __host__ __device__ Layout(int H, int dh, int n, int o) {
    const int nP = (n + 3) & ~3, dP = dh + 4;
    k = 0;                    // [H, n, dP]     the example's keys
    vw = k + H * n * dP;      // [nP, H, o]     its values, rows >= n zero
    q = vw + nP * H * o;      // per group: [kTile, H, dP]  the tile's q
    w = q + kTile * H * dP;   //   [kTile, H, nP]  affinities, then exponentials
    mx = w + kTile * H * nP;  //   v2: [kTile] ordered row max; v1: [kTile, H]
    group = mx + ((kTile * H + 3) & ~3) - q;  // floats per group
    total = q + kGroups * group;
  }
};

template <bool kPerHead>
__global__ void __launch_bounds__(kThreads, 1) graph_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ vw,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ rowmax,  // [b, R] v2's row maxima, or null (no grad: not stored)
    int sb, int sr, int sh, float scale, int R, int n, int H, int dh, int o, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(H, dh, n, o);
  const int nP = (n + 3) & ~3, nP4 = nP / 4, dP = dh + 4, d4n = dh / 4, o4n = o / 4;
  const int HD = H * dh, Hn = H * n, Ho = H * o;
  const int tid = threadIdx.x;
  const int g = tid / kGroupThreads, gt = tid - g * kGroupThreads;
  const int lane = tid & 31, gwarp = gt >> 5;
  float* s_k = smem + L.k;
  float* s_vw = smem + L.vw;
  float* s_q = smem + L.q + g * L.group;
  float* s_w = smem + L.w + g * L.group;
  int* s_mx = reinterpret_cast<int*>(smem + L.mx + g * L.group);

  const int e = blockIdx.y;
  const int r_begin = blockIdx.x * chunk;
  const int r_end = min(R, r_begin + chunk);
  const int tiles = (r_end - r_begin + kTile - 1) / kTile;

  // q rows of tile t into this group's buffer (the group's own threads copy)
  auto load_q = [&](int t) {
    const int r0 = r_begin + t * kTile;
    const int rows = min(kTile, r_end - r0);
    const float* src = q + ((size_t)e * R + r0) * HD;
    for (int c = gt; c < rows * H * d4n; c += kGroupThreads) {
      const int rh = c / d4n, d4 = c - rh * d4n;
      cp_async16(s_q + rh * dP + d4 * 4, src + (size_t)c * 4);
    }
  };

  // K (re-laid as [H, n, dP]), VW and each group's first tile, by all threads.
  const float* k_ex = k + (size_t)e * n * HD;
  for (int c = tid; c < n * H * d4n; c += kThreads) {
    const int mh = c / d4n, d4 = c - mh * d4n;
    const int m = mh / H, h = mh - m * H;
    cp_async16(s_k + (h * n + m) * dP + d4 * 4, k_ex + (size_t)c * 4);
  }
  const float* vw_ex = vw + (size_t)e * n * Ho;
  for (int c = tid; c < n * Ho / 4; c += kThreads) cp_async16(s_vw + c * 4, vw_ex + (size_t)c * 4);
  if (g < tiles) load_q(g);
  cp_async_commit();
  // Zeros where a tile reads beyond the keys: VW rows n..nP-1 and the whole
  // weight buffer (its padding columns are never written again; rows past a
  // ragged tile's end stay finite). The row maxima start at -inf.
  for (int i = n * Ho + tid; i < nP * Ho; i += kThreads) s_vw[i] = 0.f;
  for (int i = gt; i < kTile * H * nP; i += kGroupThreads) s_w[i] = 0.f;
  if (gt < kTile) s_mx[gt] = ordered(-INFINITY);
  cp_async_wait_all();
  __syncthreads();  // K, VW and both groups' first tiles; from here on groups run apart

  // Group g takes tiles g, g + 2, ...: while one group is in one phase, the
  // other's phases fill the SM. Only group barriers from here on.
  const float* bias_ex = bias + (size_t)e * sb;
  for (int t = g; t < tiles; t += kGroups) {
    const int r0 = r_begin + t * kTile;
    const int rows = min(kTile, r_end - r0);
    if (t != g) {
      cp_async_wait_all();  // this tile's q, copied during the last tile
      group_sync(g);
    }

    // 1. Affinities: a thread takes keys m0 and m0 + n2 of one head (n2 =
    //    ceil(n / 2)) for every row of the tile, so each q read serves two
    //    dots. The loop runs by whole warps, so that v2's row max is taken
    //    per warp (one redux.sync per row) and merged across warps by an
    //    atomic max.
    const int n2 = (n + 1) / 2, Hn2 = H * n2;
    for (int p0 = gwarp * 32; p0 < Hn2; p0 += kGroupThreads) {
      const bool active = p0 + lane < Hn2;
      const int p = active ? p0 + lane : Hn2 - 1;
      const int h = p / n2, m0 = p - h * n2, m1 = m0 + n2;
      const bool has1 = active && m1 < n;
      const int m1c = has1 ? m1 : m0;
      float b0[kTile], b1[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float* br = bias_ex + (size_t)(r0 + r) * sr + (size_t)h * sh;
        b0[r] = r < rows ? br[m0] : 0.f;
        b1[r] = r < rows ? br[m1c] : 0.f;
      }
      const float4* k4a = reinterpret_cast<const float4*>(s_k + (h * n + m0) * dP);
      const float4* k4b = reinterpret_cast<const float4*>(s_k + (h * n + m1c) * dP);
      const float4* q4 = reinterpret_cast<const float4*>(s_q + h * dP);
      float a0[kTile], a1[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < d4n; ++d4) {
        const float4 ka = k4a[d4], kb = k4b[d4];
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 qv = q4[r * H * (dP / 4) + d4];
          a0[r] += qv.x * ka.x;
          a0[r] += qv.y * ka.y;
          a0[r] += qv.z * ka.z;
          a0[r] += qv.w * ka.w;
          a1[r] += qv.x * kb.x;
          a1[r] += qv.y * kb.y;
          a1[r] += qv.z * kb.z;
          a1[r] += qv.w * kb.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float x0 = __fadd_rn(__fmul_rn(a0[r], scale), b0[r]);
        const float x1 = __fadd_rn(__fmul_rn(a1[r], scale), b1[r]);
        if (active && r < rows) s_w[(r * H + h) * nP + m0] = x0;
        if (has1 && r < rows) s_w[(r * H + h) * nP + m1] = x1;
        if (!kPerHead) {
          const float x = fmaxf(active ? x0 : -INFINITY, has1 ? x1 : -INFINITY);
          const int mx = __reduce_max_sync(0xffffffffu, ordered(x));
          if (lane == 0 && r < rows) atomicMax(s_mx + r, mx);
        }
      }
    }
    group_sync(g);
    // a launch under grad keeps v2's row max, so that the backward can
    // rebuild the weights of a subset of the heads
    if (!kPerHead && rowmax && gt < rows) rowmax[(size_t)e * R + r0 + gt] = unordered(s_mx[gt]);
    if (t + kGroups < tiles) {
      load_q(t + kGroups);  // this group's q buffer is free: its affinities are done
      cp_async_commit();
    }

    // 2. Exponentials in place, one thread per 4 keys of a (row, head)
    //    segment (padding keys stay 0), against v2's row max or, for v1, the
    //    segment's own max (one thread per segment first).
    if (kPerHead) {
      float* s_segmx = reinterpret_cast<float*>(s_mx);
      for (int s = gt; s < rows * H; s += kGroupThreads) {
        float mx = -INFINITY;
        for (int j = 0; j < n; ++j) mx = fmaxf(mx, s_w[s * nP + j]);
        s_segmx[s] = mx;
      }
      group_sync(g);
    }
    for (int i = gt; i < rows * H * nP4; i += kGroupThreads) {
      const int s = i / nP4, m = (i - s * nP4) * 4;
      float* seg = s_w + s * nP;
      const float mx = kPerHead ? reinterpret_cast<const float*>(s_mx)[s] : unordered(s_mx[s / H]);
      float4 a = *reinterpret_cast<const float4*>(seg + m);
      a.x = m < n ? expf(a.x - mx) : 0.f;
      a.y = m + 1 < n ? expf(a.y - mx) : 0.f;
      a.z = m + 2 < n ? expf(a.z - mx) : 0.f;
      a.w = m + 3 < n ? expf(a.w - mx) : 0.f;
      *reinterpret_cast<float4*>(seg + m) = a;
    }
    group_sync(g);
    if (!kPerHead && gt < kTile) s_mx[gt] = ordered(-INFINITY);

    // 3. out[r, h, c] = sum_m e[r, h, m] vw[m, h, c] / (sum_m e[r, h, m] + eps):
    //    one thread per (head, 4 channels), every row of the tile, float4 in
    //    and out; each thread sums the denominators from the weights it
    //    reads. The next tile's barrier orders these reads of s_w before its
    //    affinities overwrite them, and the maxima reset above before its
    //    atomics.
    float* out_t = out + ((size_t)e * R + r0) * Ho;
    for (int hc = gt; hc < H * o4n; hc += kGroupThreads) {
      const int h = hc / o4n;
      const float4* v4 = reinterpret_cast<const float4*>(s_vw) + hc;
      const float* w_h = s_w + h * nP;
      float4 acc[kTile];
      float den[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        den[r] = 0.f;
      }
      for (int m = 0; m < nP; m += 4) {
        float4 w4[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          w4[r] = *reinterpret_cast<const float4*>(w_h + r * H * nP + m);
          den[r] += (w4[r].x + w4[r].y) + (w4[r].z + w4[r].w);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = v4[(size_t)(m + j) * (Ho / 4)];
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float wv = j == 0 ? w4[r].x : j == 1 ? w4[r].y : j == 2 ? w4[r].z : w4[r].w;
            acc[r].x += wv * v.x;
            acc[r].y += wv * v.y;
            acc[r].z += wv * v.z;
            acc[r].w += wv * v.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (r < rows) {
          const float d = kPerHead ? den[r] : den[r] + 1e-30f;
          reinterpret_cast<float4*>(out_t + (size_t)r * Ho)[hc] =
              make_float4(acc[r].x / d, acc[r].y / d, acc[r].z / d, acc[r].w / d);
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Backward (the note "Backward" at the top of the file).

constexpr int kBwdThreads = 256;
constexpr int kBwdBlocks = 2;     // blocks in flight per SM
constexpr int kBwdHalf = kBwdThreads / 2;  // threads of the dK sums; the rest sum dVW
constexpr int kBwdTile = 8;       // query rows per tile
constexpr int kBwdKeysA = 2;      // phase A: keys and rows of a tile per thread
constexpr int kBwdRowsA = 4;
constexpr int kBwdPartsA = kBwdTile / kBwdRowsA;  // a thread's rows: r, r + parts, ...
constexpr int kSegLanes = 8;      // lanes per (row, head) in phases B-D
constexpr int kBwdMaxKeys = 10;   // keys per thread in the dK and dVW sums, at most
constexpr int kBwdRowsD = 2;      // rows per thread in dq, at most
constexpr int kRedThreads = 256;  // threads of a reduce block

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Shared-memory layout of a backward block, in floats (every region a
// multiple of 4). hb heads per block; nP = n rounded up to 4; dP = dh + 4 and
// oP = o + 4, so that the rows of K, VW, q and g start 4 banks apart.
struct BwdLayout {
  int k, vw, buf, q, g, bias, mx, bufsize, w, da, total;
  __host__ __device__ BwdLayout(int hb, int dh, int n, int o) {
    const int nP = (n + 3) & ~3, dP = dh + 4, oP = o + 4, T = kBwdTile;
    k = 0;                    // [hb, n, dP]  the head group's keys
    vw = k + hb * n * dP;     // [hb, n, oP]  and values
    buf = vw + hb * n * oP;   // two tile buffers, each (offsets within it):
    q = 0;                    //   [T, hb, dP]  q rows
    g = q + T * hb * dP;      //   [T, hb, oP]  output cotangent rows
    bias = g + T * hb * oP;   //   [T, hb, nP]  bias rows (head 0's alone where shared)
    mx = bias + T * hb * nP;  //   [T]          the forward's row maxima (v2)
    bufsize = mx + T;
    w = buf + 2 * bufsize;    // [T, hb, nP]  affinities, exponentials, then weights
    da = w + T * hb * nP;     // [T, hb, nP]  dw, then daff
    total = da + T * hb * nP;
  }
};

// One block per (example, head group of hb heads, chunk of `chunk` query
// rows); grid (H / hb * chunks, b), the head group fastest. HB, N, DH and O
// are the widths (hb, n, dh, o) of a specialised instance, with which the
// tile loop's indexing folds and its loops unroll without guards; all 0 in
// the general instance, which reads them from its arguments. kPerHead: v1's
// per-head softmax, as the forward's flag.
template <int HB, int N, int DH, int O, bool kPerHead>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks) graph_attention_bwd_kernel(
    const float* __restrict__ gy,      // [b, R, H, o] output cotangent
    const float* __restrict__ q,       // [b, R, H, dh]
    const float* __restrict__ k,       // [b, n, H, dh]
    const float* __restrict__ vw,      // [b, n, H, o]
    const float* __restrict__ bias,    // [b, R, H, n] view: strides sb, sr, sh; keys contiguous
    const float* __restrict__ rowmax,  // [b, R] the forward's row maxima (v2)
    float scale,
    float* __restrict__ dq,            // [b, R, H, dh]
    float* __restrict__ dk,            // [b, n, H, dh] (one chunk per example)
    float* __restrict__ dvw,           // [b, n, H, o]  (one chunk per example)
    float* __restrict__ dbias,         // shared: [b, R, n] (one head group); else [b, R, H, n]
    float* __restrict__ ws_k,          // [chunks, b, n, H, dh] (several chunks)
    float* __restrict__ ws_v,          // [chunks, b, n, H, o]  (several chunks)
    float* __restrict__ ws_b,          // [groups, b, R, n] (shared, several head groups)
    int sb, int sr, int sh, int shared, int b, int R, int H, int chunk, int chunks, int hb_,
    int n_, int dh_, int o_) {
  constexpr bool kFixed = HB > 0;
  const int hb = kFixed ? HB : hb_, n = kFixed ? N : n_, dh = kFixed ? DH : dh_;
  const int o = kFixed ? O : o_;
  const int nP = (n + 3) & ~3, dP = dh + 4, oP = o + 4, d4n = dh / 4, o4n = o / 4, hn = hb * n;
  const int qc = hb * d4n, gc = hb * o4n;  // (head, 4 channels) of a q / g row
  const int RG = kBwdThreads / qc;         // dq: row groups
  // keys per thread in the dK / dVW sums and rows per thread in dq: exact
  // in a specialised instance, the most the wrapper's plan allows otherwise
  constexpr int kQc = kFixed ? HB * DH / 4 : 1, kGc = kFixed ? HB * O / 4 : 1;
  constexpr int kKeysK = kFixed ? (N + kBwdHalf / kQc - 1) / (kBwdHalf / kQc) : kBwdMaxKeys;
  constexpr int kKeysV = kFixed ? (N + kBwdHalf / kGc - 1) / (kBwdHalf / kGc) : kBwdMaxKeys;
  constexpr int kKeys = kKeysK > kKeysV ? kKeysK : kKeysV;
  constexpr int kRowsD =
      kFixed ? (kBwdTile + kBwdThreads / kQc - 1) / (kBwdThreads / kQc) : kBwdRowsD;
  // phase A's loop over 16-byte chunks: whole in a specialised instance
  // (1.02x faster at the model's shapes than two at a time), two at a time
  // otherwise
  constexpr int kUnrollA = kFixed ? (DH > O ? DH : O) / 4 : 2;
  static_assert(!kFixed || (DH % 4 == 0 && O % 4 == 0 && kQc <= kBwdHalf && kGc <= kBwdHalf),
                "an instance");
  static_assert(kKeys <= kBwdMaxKeys && kRowsD <= kBwdRowsD, "registers");
  extern __shared__ __align__(16) float smem[];
  const BwdLayout L(hb, dh, n, o);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = H / hb;
  const int c = blockIdx.x / groups, grp = blockIdx.x - c * groups, h0 = grp * hb;
  const int e = blockIdx.y;
  const int r_begin = c * chunk, r_end = min(R, r_begin + chunk);
  const int tiles = (r_end - r_begin + kBwdTile - 1) / kBwdTile;
  const int hbB = shared ? 1 : hb;  // heads of a bias row that a tile holds
  float* s_k = smem + L.k;
  float* s_vw = smem + L.vw;
  float* s_w = smem + L.w;
  float* s_da = smem + L.da;

  // Each thread's fixed share of a tile's q and g copies, computed once:
  // 16-byte slot c_j of a row's qc + gc (q's, then g's), rows c_r, c_r +
  // c_step, ...
  const int cq = qc + gc, c_step = kBwdThreads / cq, c_r = tid / cq, c_j = tid - c_r * cq;
  const bool c_g = c_j >= qc;
  const int c_jj = c_g ? c_j - qc : c_j, c_w4 = c_g ? o4n : d4n, c_p = c_g ? oP : dP;
  const int c_dst = (c_g ? L.g : L.q) + c_jj / c_w4 * c_p + c_jj % c_w4 * 4;
  const float* c_src = c_g ? gy + (size_t)h0 * o + c_jj * 4 : q + (size_t)h0 * dh + c_jj * 4;
  const size_t c_row = (size_t)H * (c_g ? o : dh);  // floats from one row to the next
  // phase A's items: (product, head, key group, row part); group m0 holds
  // keys m0, m0 + kg, ...
  const int kg = (n + kBwdKeysA - 1) / kBwdKeysA, hkg = hb * kg, itemsA = 2 * hkg * kBwdPartsA;

  // tile t's rows of q, g, the bias and the row maxima into buffer t % 2
  auto load_tile = [&](int t) {
    float* buf = smem + L.buf + (t & 1) * L.bufsize;
    const int r0 = r_begin + t * kBwdTile, rows = min(kBwdTile, r_end - r0);
    const size_t row0 = (size_t)e * R + r0;  // the tile's first row of [b, R]
    for (int r = c_r; c_r < c_step && r < rows; r += c_step)
      cp_async16(buf + c_dst + r * hb * c_p, c_src + (row0 + r) * c_row);
    const float* b_t = bias + (size_t)e * sb + (size_t)r0 * sr + (size_t)h0 * sh;
    for (int i = tid; i < rows * hbB * n; i += kBwdThreads) {
      const int rh = i / n, m = i - rh * n, r = rh / hbB, hh = rh - r * hbB;
      cp_async4(buf + L.bias + (r * hb + hh) * nP + m, b_t + (size_t)r * sr + (size_t)hh * sh + m);
    }
    if (!kPerHead)
      for (int i = tid; i < rows; i += kBwdThreads) cp_async4(buf + L.mx + i, rowmax + row0 + i);
  };

  // The head group's K and VW and the first tile. The weight buffers'
  // padding keys, never written again, read as zeros.
  const float* k_ex = k + (size_t)e * n * H * dh;
  const float* vw_ex = vw + (size_t)e * n * H * o;
  for (int i = tid; i < hn * d4n; i += kBwdThreads) {
    const int mh = i / d4n, d4 = i - mh * d4n, m = mh / hb, hh = mh - m * hb;
    cp_async16(s_k + (hh * n + m) * dP + d4 * 4, k_ex + ((size_t)m * H + h0 + hh) * dh + d4 * 4);
  }
  for (int i = tid; i < hn * o4n; i += kBwdThreads) {
    const int mh = i / o4n, c4 = i - mh * o4n, m = mh / hb, hh = mh - m * hb;
    cp_async16(s_vw + (hh * n + m) * oP + c4 * 4, vw_ex + ((size_t)m * H + h0 + hh) * o + c4 * 4);
  }
  load_tile(0);
  cp_async_commit();
  for (int i = tid; i < 2 * kBwdTile * hb * nP; i += kBwdThreads) s_w[i] = 0.f;  // s_w, s_da

  // dK (threads [0, kBwdHalf)) and dVW (the rest), summed over the chunk's
  // rows in registers: head eh, channels 4 ec..4 ec + 3, keys slice + S j
  const int kind = tid / kBwdHalf, u = tid - kind * kBwdHalf;
  const int e_qc = kind ? gc : qc, e_w4 = kind ? o4n : d4n, S = kBwdHalf / e_qc;
  const int slice = u / e_qc, ehc = u - slice * e_qc;
  const int eh = ehc / e_w4, ec = ehc - eh * e_w4;
  const bool e_on = slice < S;
  float4 acc[kKeys];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // a shared bias's gradient: this head group's sum, or the whole where the
  // group is the only one
  float* db_sum = groups > 1 ? ws_b + ((size_t)grp * b + e) * R * n : dbias + (size_t)e * R * n;

  for (int t = 0; t < tiles; ++t) {
    const int r0 = r_begin + t * kBwdTile, rows = min(kBwdTile, r_end - r0);
    const float* buf = smem + L.buf + (t & 1) * L.bufsize;
    const float* s_q = buf + L.q;
    const float* s_g = buf + L.g;
    const float* s_b = buf + L.bias;
    const float* s_mx = buf + L.mx;
    cp_async_wait_all();
    __syncthreads();  // tile t staged, and tile t - 1 read to its end
    if (t + 1 < tiles) {
      load_tile(t + 1);  // into the buffer tile t - 1 used
      cp_async_commit();
    }

    // A. The dots, a thread per (product, head, key group, row part): q . k,
    //    in the forward's order, into s_w; dw = g . vw into s_da. Each
    //    16-byte read of a row of q or g serves kBwdKeysA keys, and each of
    //    K or VW kBwdRowsA rows. Keys past n and rows past a ragged tile's
    //    end are computed, not stored.
    for (int i = tid; i < itemsA; i += kBwdThreads) {
      const int part = i % kBwdPartsA, pk = i / kBwdPartsA;
      const int which = pk >= hkg, j = which ? pk - hkg : pk;
      const int hh = j / kg, m0 = j - hh * kg;
      const int wp = which ? oP : dP, w4n = which ? o4n : d4n, xr = hb * (wp / 4);
      const float4* y4 = reinterpret_cast<const float4*>((which ? s_vw : s_k) + hh * n * wp);
      int yo[kBwdKeysA];  // each key's row, in float4s
#pragma unroll
      for (int kk = 0; kk < kBwdKeysA; ++kk) yo[kk] = min(m0 + kk * kg, n - 1) * (wp / 4);
      const float4* x4 =
          reinterpret_cast<const float4*>((which ? s_g : s_q) + hh * wp) + part * xr;
      float a[kBwdRowsA][kBwdKeysA];
#pragma unroll
      for (int r = 0; r < kBwdRowsA; ++r)
#pragma unroll
        for (int kk = 0; kk < kBwdKeysA; ++kk) a[r][kk] = 0.f;
#pragma unroll (kUnrollA)
      for (int d4 = 0; d4 < w4n; ++d4) {
        float4 y[kBwdKeysA];
#pragma unroll
        for (int kk = 0; kk < kBwdKeysA; ++kk) y[kk] = y4[yo[kk] + d4];
#pragma unroll
        for (int r = 0; r < kBwdRowsA; ++r) {
          const float4 x = x4[r * kBwdPartsA * xr + d4];
#pragma unroll
          for (int kk = 0; kk < kBwdKeysA; ++kk) {
            a[r][kk] = fmaf(x.x, y[kk].x, a[r][kk]);
            a[r][kk] = fmaf(x.y, y[kk].y, a[r][kk]);
            a[r][kk] = fmaf(x.z, y[kk].z, a[r][kk]);
            a[r][kk] = fmaf(x.w, y[kk].w, a[r][kk]);
          }
        }
      }
      float* out = (which ? s_da : s_w) + (part * hb + hh) * nP + m0;
#pragma unroll
      for (int r = 0; r < kBwdRowsA; ++r) {
#pragma unroll
        for (int kk = 0; kk < kBwdKeysA; ++kk) {
          if (part + r * kBwdPartsA < rows && m0 + kk * kg < n)
            out[r * kBwdPartsA * hb * nP + kk * kg] = a[r][kk];
        }
      }
    }
    __syncthreads();

    // B-D. A group of kSegLanes lanes per (row, head) segment, lane l taking
    //    keys l, l + kSegLanes, ...: the affinities as the forward builds
    //    them (dot * scale + bias, rounded in that order) and their
    //    exponentials, in v2 against the forward's row max (the forward's
    //    exponentials), in v1 against the segment's own max; the
    //    denominator (eps 1e-30 in v2, none in v1) and sum_m w dw, summed
    //    over the lanes by xor shuffles (a fixed order: every lane gets the
    //    same bits); then w and daff = w (dw - sum_m w dw). A per-head
    //    bias's gradient is daff itself.
    for (int s0 = warp * (32 / kSegLanes); s0 < rows * hb; s0 += kBwdThreads / kSegLanes) {
      const int sg = s0 + lane / kSegLanes, sl = lane % kSegLanes;
      const bool on = sg < rows * hb;
      const int r = on ? sg / hb : 0, hh = on ? sg - r * hb : 0;
      float* ew = s_w + (on ? sg : 0) * nP;
      float* dw = s_da + (on ? sg : 0) * nP;
      const float* bt = s_b + (r * hb + (shared ? 0 : hh)) * nP;
      float mx = kPerHead ? -INFINITY : s_mx[r];
      for (int m = sl; on && m < n; m += kSegLanes) {
        const float aff = __fadd_rn(__fmul_rn(ew[m], scale), bt[m]);
        ew[m] = aff;
        if (kPerHead) mx = fmaxf(mx, aff);
      }
      if (kPerHead) {
#pragma unroll
        for (int x = kSegLanes / 2; x; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, x));
      }
      float den = 0.f, sd = 0.f;
      for (int m = sl; on && m < n; m += kSegLanes) {
        const float e = expf(ew[m] - mx);
        ew[m] = e;
        den += e;
        sd = fmaf(e, dw[m], sd);
      }
#pragma unroll
      for (int x = kSegLanes / 2; x; x >>= 1) {
        den += __shfl_xor_sync(~0u, den, x);
        sd += __shfl_xor_sync(~0u, sd, x);
      }
      if (!kPerHead) den += 1e-30f;
      const float inv = 1.f / den, s = sd * inv;
      for (int m = sl; on && m < n; m += kSegLanes) {
        const float w = ew[m] * inv;
        const float da = w * (dw[m] - s);
        ew[m] = w;
        dw[m] = da;
        if (!shared) dbias[(((size_t)e * R + r0 + r) * H + h0 + hh) * n + m] = da;
      }
    }
    __syncthreads();

    // E, F and G only read the tile.
    // E. dq[r, h, 4c..] = scale sum_m daff[r, h, m] k[m, h, 4c..]: a thread
    //    per (head, 4 channels) and rows rg, rg + RG; float4 stores.
    {
      const int rg = tid / qc, hc = tid - rg * qc;
      if (rg < RG) {
        const int hh = hc / d4n, c4 = hc - hh * d4n;
        const float4* k4 = reinterpret_cast<const float4*>(s_k + hh * n * dP) + c4;
        float4 a[kRowsD];
#pragma unroll
        for (int j = 0; j < kRowsD; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int m = 0; m < n; ++m) {
          const float4 y = k4[m * (dP / 4)];
#pragma unroll
          for (int j = 0; j < kRowsD; ++j) {
            const int r = rg + j * RG;
            if (r < rows) {
              const float x = s_da[(r * hb + hh) * nP + m];
              a[j].x = fmaf(x, y.x, a[j].x);
              a[j].y = fmaf(x, y.y, a[j].y);
              a[j].z = fmaf(x, y.z, a[j].z);
              a[j].w = fmaf(x, y.w, a[j].w);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRowsD; ++j) {
          const int r = rg + j * RG;
          if (r < rows) {
            reinterpret_cast<float4*>(
                dq + (((size_t)e * R + r0 + r) * H + h0 + hh) * dh)[c4] =
                make_float4(scale * a[j].x, scale * a[j].y, scale * a[j].z, scale * a[j].w);
          }
        }
      }
    }

    // F. dK += daff q and dVW += w g over the tile's rows, in order.
    if (e_on) {
      const int xp = kind ? oP : dP;
      const float* x = (kind ? s_g : s_q) + eh * xp + ec * 4;
      const float* cf = (kind ? s_w : s_da) + eh * nP + slice;
      for (int r = 0; r < rows; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + r * hb * xp);
        const float* cr = cf + r * hb * nP;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          if (slice + j * S < n) {
            const float y = cr[j * S];
            acc[j].x = fmaf(y, xv.x, acc[j].x);
            acc[j].y = fmaf(y, xv.y, acc[j].y);
            acc[j].z = fmaf(y, xv.z, acc[j].z);
            acc[j].w = fmaf(y, xv.w, acc[j].w);
          }
        }
      }
    }

    // G. A shared bias's gradient: daff summed over the group's heads in
    //    head order, a thread per (row, key).
    if (shared) {
      for (int i = tid; i < rows * n; i += kBwdThreads) {
        const int r = i / n, m = i - r * n;
        const float* col = s_da + r * hb * nP + m;
        float sum = 0.f;
        for (int hh = 0; hh < hb; ++hh) sum += col[hh * nP];
        db_sum[(size_t)(r0 + r) * n + m] = sum;
      }
    }
  }

  if (e_on) {
    const int w = kind ? o : dh;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int m = slice + j * S;
      if (m < n) {
        const size_t at = (((size_t)e * n + m) * H + h0 + eh) * w + ec * 4;
        const float4 v = acc[j];
        if (chunks > 1) {
          *reinterpret_cast<float4*>((kind ? ws_v : ws_k) + (size_t)c * b * n * H * w + at) = v;
        } else if (kind) {
          *reinterpret_cast<float4*>(dvw + at) = v;
        } else {
          *reinterpret_cast<float4*>(dk + at) =
              make_float4(scale * v.x, scale * v.y, scale * v.z, scale * v.w);
        }
      }
    }
  }
}

// The second pass, in a fixed order: a shared bias's gradient, the head
// groups' sums added in group order (nb elements; none with one group), and
// dK and dVW, the row chunks' sums added in chunk order (nk and nv elements;
// none with one chunk).
__global__ void __launch_bounds__(kRedThreads) graph_attention_bwd_reduce(
    const float* __restrict__ ws_b, int groups, size_t nb, float* __restrict__ dbias,
    const float* __restrict__ ws_k, const float* __restrict__ ws_v, int chunks, size_t nk,
    size_t nv, float scale, float* __restrict__ dk, float* __restrict__ dvw) {
  const size_t stride = (size_t)gridDim.x * kRedThreads;
  for (size_t i = (size_t)blockIdx.x * kRedThreads + threadIdx.x; i < nb + nk + nv; i += stride) {
    float sum = 0.f;
    if (i < nb) {
      for (int gi = 0; gi < groups; ++gi) sum += ws_b[gi * nb + i];
      dbias[i] = sum;
    } else if (i < nb + nk) {
      const size_t j = i - nb;
      for (int ch = 0; ch < chunks; ++ch) sum += ws_k[ch * nk + j];
      dk[j] = scale * sum;
    } else {
      const size_t j = i - nb - nk;
      for (int ch = 0; ch < chunks; ++ch) sum += ws_v[ch * nv + j];
      dvw[j] = sum;
    }
  }
}

using BwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, float, float*, float*, float*, float*, float*, float*,
                           float*, int, int, int, int, int, int, int, int, int, int, int, int,
                           int);

// The specialised instances of the backward, by (heads per block, keys,
// head width, value width): the one every configuration runs (heads of 64,
// nongt_dim 20, groups of 4 heads), in both softmax modes. Every
// other shape the wrapper's backward_plan takes runs the general instance.
struct BwdInstance {
  int hb, n, dh, o;
  BwdKernel v2, v1;
};
const BwdInstance kBwdInstances[] = {
    {4, 20, 64, 64, graph_attention_bwd_kernel<4, 20, 64, 64, false>,
     graph_attention_bwd_kernel<4, 20, 64, 64, true>},
};

const BwdInstance* bwd_specialised(int hb, int n, int dh, int o) {
  for (const BwdInstance& i : kBwdInstances)
    if (i.hb == hb && i.n == n && i.dh == dh && i.o == o) return &i;
  return nullptr;
}

BwdKernel bwd_instance(int hb, int n, int dh, int o, int per_head) {
  const BwdInstance* i = bwd_specialised(hb, n, dh, o);
  if (i) return per_head ? i->v1 : i->v2;
  return per_head ? graph_attention_bwd_kernel<0, 0, 0, 0, true>
                  : graph_attention_bwd_kernel<0, 0, 0, 0, false>;
}

}  // namespace

extern "C" {

// A launch's scalars, built once per shape by the wrapper (its `_Launch`):
// bias strides, shapes, query rows per block, shared memory, 1/sqrt(dh).
struct GaLaunch {
  int sb, sr, sh, b, R, n, H, dh, o, rows, smem;
  float scale;
};

// Shared memory one block needs, in bytes (the wrapper's tiling plan computes
// the same and checks it against this once).
size_t regat_graph_attention_smem_bytes(int H, int dh, int n, int o) {
  return sizeof(float) * (size_t)Layout(H, dh, n, o).total;
}

// Lets both modes use `smem` bytes of dynamic shared memory on the current
// device. Call once per device and size, before the first launch that needs
// more than 48 KB. Returns the CUDA error (0 = done).
int regat_graph_attention_set_smem(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      graph_attention_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      graph_attention_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)err;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// A block takes `a->rows` query rows of one example. `per_head` 0: v2's
// global-max softmax; 1: v1's per-head softmax. `rowmax` null: nothing more
// is stored (eval, serve, predict); non-null (a v2 launch under grad): v2's
// row maxima [b, R], which the backward reads.
int regat_graph_attention_fwd(
    const float* q, const float* k, const float* vw, const float* bias, float* out,
    float* rowmax, const GaLaunch* a, int per_head, void* stream) {
  const dim3 grid((a->R + a->rows - 1) / a->rows, a->b);
  const cudaStream_t s = (cudaStream_t)stream;
  if (per_head) {
    graph_attention_kernel<true><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, bias, out, nullptr, a->sb, a->sr, a->sh, a->scale, a->R, a->n, a->H, a->dh,
        a->o, a->rows);
  } else {
    graph_attention_kernel<false><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, bias, out, rowmax, a->sb, a->sr, a->sh, a->scale, a->R, a->n, a->H, a->dh,
        a->o, a->rows);
  }
  return (int)cudaGetLastError();
}

// A backward launch's scalars, built once per shape and bias strides by the
// wrapper (its `_BwdLaunch`): bias strides, whether the bias is shared
// across heads, shapes, heads per block, query rows per block, row chunks
// per example, shared memory, 1/sqrt(dh).
struct GaBwdLaunch {
  int sb, sr, sh, shared, b, R, n, H, dh, o, hb, rows, chunks, smem;
  float scale;
};

// Shared memory one backward block needs, in bytes (the wrapper's
// backward_plan computes the same and checks it against this once).
size_t regat_graph_attention_bwd_smem_bytes(int hb, int dh, int n, int o) {
  return sizeof(float) * (size_t)BwdLayout(hb, dh, n, o).total;
}

// 1 if (hb, n, dh, o) has a specialised instance, else 0 (the general
// instance runs it); the wrapper holds its list of instances to this at load.
int regat_graph_attention_bwd_specialised(int hb, int n, int dh, int o) {
  return bwd_specialised(hb, n, dh, o) != nullptr;
}

// Lets the backward instance that runs (hb, n, dh, o), in both softmax
// modes, use `smem` bytes of dynamic shared memory on the current device.
// Returns the CUDA error (0 = done).
int regat_graph_attention_bwd_set_smem(int hb, int n, int dh, int o, int smem) {
  for (int per_head = 0; per_head < 2; ++per_head) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_instance(hb, n, dh, o, per_head), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches the backward and, where partial sums are to be added, its reduce
// on `stream`; returns the first cudaGetLastError() that is not 0, else 0.
// `rowmax` is read in v2 only; `ws_k` and `ws_v` with several chunks per
// example only; `ws_b` with a shared bias and several head groups only.
int regat_graph_attention_bwd(
    const float* gy, const float* q, const float* k, const float* vw, const float* bias,
    const float* rowmax, float* dq, float* dk, float* dvw, float* dbias, float* ws_k,
    float* ws_v, float* ws_b, const GaBwdLaunch* a, int per_head, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const BwdKernel kernel = bwd_instance(a->hb, a->n, a->dh, a->o, per_head);
  const int groups = a->H / a->hb;
  const dim3 grid(groups * a->chunks, a->b);
  kernel<<<grid, kBwdThreads, a->smem, s>>>(
      gy, q, k, vw, bias, rowmax, a->scale, dq, dk, dvw, dbias, ws_k, ws_v, ws_b, a->sb, a->sr,
      a->sh, a->shared, a->b, a->R, a->H, a->rows, a->chunks, a->hb, a->n, a->dh, a->o);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nb = a->shared && groups > 1 ? (size_t)a->b * a->R * a->n : 0;
  const size_t nk = a->chunks > 1 ? (size_t)a->b * a->n * a->H * a->dh : 0;
  const size_t nv = a->chunks > 1 ? (size_t)a->b * a->n * a->H * a->o : 0;
  const size_t need = (nb + nk + nv + kRedThreads - 1) / kRedThreads;
  if (need == 0) return 0;
  graph_attention_bwd_reduce<<<(int)(need < 1024 ? need : 1024), kRedThreads, 0, s>>>(
      ws_b, groups, nb, dbias, ws_k, ws_v, a->chunks, nk, nv, a->scale, dk, dvw);
  return (int)cudaGetLastError();
}

}  // extern "C"
