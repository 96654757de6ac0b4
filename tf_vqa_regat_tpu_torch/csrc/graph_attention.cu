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
// global-max softmax; 1: v1's per-head softmax.
int regat_graph_attention_fwd(
    const float* q, const float* k, const float* vw, const float* bias, float* out,
    const GaLaunch* a, int per_head, void* stream) {
  const dim3 grid((a->R + a->rows - 1) / a->rows, a->b);
  const cudaStream_t s = (cudaStream_t)stream;
  if (per_head) {
    graph_attention_kernel<true><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, bias, out, a->sb, a->sr, a->sh, a->scale, a->R, a->n, a->H, a->dh, a->o, a->rows);
  } else {
    graph_attention_kernel<false><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, bias, out, a->sb, a->sr, a->sh, a->scale, a->R, a->n, a->H, a->dh, a->o, a->rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
