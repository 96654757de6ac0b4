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
// out. What the design does about it: the TPU kernel's block-diagonal K/VW
// scratch and segment-sum matmuls (MXU padding that costs H x the FLOPs) are
// gone; each (row, head, key) is computed directly. One block takes a tile
// of kRows query rows of one example: their q (one contiguous chunk), the
// [rows, H, n] affinities and the per-row maxima sit in shared memory, and
// the [b, R, H, n] affinities and weights never reach device memory. Each
// block reads its example's K and VW once (through L1/L2) for all of its
// rows, so their re-reads fall by kRows against a block per row; each
// thread keeps kRows partial sums in registers. Staging K/VW in shared
// memory and a wider tile are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // query rows per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kPerHead>
__global__ void __launch_bounds__(kThreads) graph_attention_kernel(
    const float* __restrict__ q,     // [b, R, H, dh]
    const float* __restrict__ k,     // [b, n, H, dh]
    const float* __restrict__ vw,    // [b, n, H, o]
    const float* __restrict__ bias,  // [b, R, H, n] through strides (sb, sr, sh, 1)
    float* __restrict__ out,         // [b, R, H, o]
    int sb, int sr, int sh, float scale, int R, int n, int H, int dh, int o) {
  extern __shared__ float smem[];
  const int HD = H * dh, Hn = H * n;
  float* s_q = smem;                 // [kRows, H * dh]
  float* s_w = s_q + kRows * HD;     // [kRows, H * n]  affinities, then weights
  float* s_max = s_w + kRows * Hn;   // [kRows]         row max over all heads

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int e = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);
  const size_t row0 = (size_t)e * R + r0;

  const float* q_tile = q + row0 * HD;  // the tile's rows are contiguous
  for (int i = tid; i < rows * HD; i += kThreads) s_q[i] = q_tile[i];
  __syncthreads();

  // One warp per (head, key): lanes over dh, kRows dot products at once.
  const float* k_ex = k + (size_t)e * n * HD;
  const float* bias_ex = bias + (size_t)e * sb + (size_t)r0 * sr;
  for (int pair = warp; pair < Hn; pair += kWarps) {
    const int h = pair / n, m = pair % n;
    const float* k_vec = k_ex + (size_t)m * HD + (size_t)h * dh;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int d = lane; d < dh; d += 32) {
      const float kv = k_vec[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] += s_q[r * HD + h * dh + d] * kv;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dot = warp_sum(acc[r]);
      if (lane == r && r < rows) {
        const float b = bias_ex[(size_t)r * sr + (size_t)h * sh + m];
        s_w[r * Hn + pair] = __fadd_rn(__fmul_rn(dot, scale), b);
      }
    }
  }
  __syncthreads();

  if (!kPerHead) {  // v2: the row max over all heads
    for (int r = warp; r < rows; r += kWarps) {
      float mx = -INFINITY;
      for (int i = lane; i < Hn; i += 32) mx = fmaxf(mx, s_w[r * Hn + i]);
      mx = warp_max(mx);
      if (lane == 0) s_max[r] = mx;
    }
    __syncthreads();
  }

  // One warp per (row, head) segment: exp, sum, normalise. Each lane reads
  // back only the keys it wrote, so the warp needs no barrier in between.
  for (int seg = warp; seg < rows * H; seg += kWarps) {
    const int r = seg / H, h = seg % H;
    float* w = s_w + r * Hn + h * n;
    float mx;
    if (kPerHead) {
      mx = -INFINITY;
      for (int m = lane; m < n; m += 32) mx = fmaxf(mx, w[m]);
      mx = warp_max(mx);
    } else {
      mx = s_max[r];
    }
    float s = 0.f;
    for (int m = lane; m < n; m += 32) {
      const float ev = expf(w[m] - mx);
      w[m] = ev;
      s += ev;
    }
    s = warp_sum(s);
    const float denom = kPerHead ? s : s + 1e-30f;
    for (int m = lane; m < n; m += 32) w[m] = w[m] / denom;
  }
  __syncthreads();

  // out[r, h, c] = sum_m w[r, h, m] vw[m, h, c]: one thread per (h, c), all
  // rows of the tile at once; neighbouring threads read neighbouring c.
  const int Ho = H * o;
  const float* vw_ex = vw + (size_t)e * n * Ho;
  float* out_tile = out + row0 * Ho;
  for (int i = tid; i < Ho; i += kThreads) {
    const int h = i / o;
    const float* v = vw_ex + i;
    const float* w_h = s_w + h * n;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int m = 0; m < n; ++m) {
      const float vv = v[(size_t)m * Ho];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] += w_h[r * Hn + m] * vv;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) out_tile[(size_t)r * Ho + i] = acc[r];
  }
}

template <bool kPerHead>
int launch(const float* q, const float* k, const float* vw, const float* bias, float* out,
           int sb, int sr, int sh, float scale, int b, int R, int n, int H, int dh, int o,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_attention_kernel<kPerHead>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((R + kRows - 1) / kRows, b);
  graph_attention_kernel<kPerHead><<<grid, kThreads, smem, stream>>>(
      q, k, vw, bias, out, sb, sr, sh, scale, R, n, H, dh, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t regat_graph_attention_smem_bytes(int H, int dh, int n) {
  return sizeof(float) * ((size_t)kRows * H * dh + (size_t)kRows * H * n + kRows);
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `per_head` 0: v2's global-max softmax; 1: v1's per-head softmax.
int regat_graph_attention_fwd(
    const float* q, const float* k, const float* vw, const float* bias, float* out,
    int sb, int sr, int sh, float scale, int b, int R, int n, int H, int dh, int o,
    int per_head, void* stream) {
  const size_t smem = regat_graph_attention_smem_bytes(H, dh, n);
  const cudaStream_t s = (cudaStream_t)stream;
  return per_head
             ? launch<true>(q, k, vw, bias, out, sb, sr, sh, scale, b, R, n, H, dh, o, smem, s)
             : launch<false>(q, k, vw, bias, out, sb, sr, sh, scale, b, R, n, H, dh, o, smem, s);
}

}  // extern "C"
