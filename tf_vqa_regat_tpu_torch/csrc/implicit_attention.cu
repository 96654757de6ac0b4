// Fused implicit graph attention, one direction, forward: an eval variant and
// a train variant that also stores the post-relu pos weights.
//
// Replaces the Pallas TPU kernel
// tf_vqa_regat_tpu/ops/pallas/implicit_attention.py::_kernel_v3, both
// save_pwr=False (eval) and save_pwr=True (train), and computes the same
// function for every query row:
//
//   pe[m, p]   = sin|cos(pos[m, g(p)] * freq[p])            (optional keep-mask)
//   pwr[h, m]  = relu(sum_p pe[m, p] W[p, h] + b[h])        (stored if train)
//   bias[h, m] = log(max(pwr[h, m], 1e-6)) + mask[m]
//   aff[h, m]  = q[h] . k[m, h] * scale + bias[h, m]
//   w[h, m]    = exp(aff - max over ALL h, m) / (sum_m exp(...) + 1e-30)
//   out[h, :]  = sum_m w[h, m] vw[m, h, :]
//
// The softmax is normalised by the row max over all heads with an eps
// denominator, as _kernel_v3 does: a head whose whole segment underflows
// against that max gets all-zero weights, and a fully masked row (every key
// at -9e15) gets uniform weights.
//
// What bounds it on an H100: at the serve and train shapes (R=100, H=16,
// dh=o=64, n=20, P=64) a query row needs ~62k FMAs and 1,280 sin/cos, and
// each example's K and VW (2 x 80 KB) are read by all R of its rows. So the
// kernel is bound by L1/L2 traffic on K and VW and by latency at small batch,
// far below both the FP32 and the HBM roofline. What the design does about
// it: the TPU kernel's block-diagonal K/VW scratch, block-scattered pos-FC
// kernel and segment-sum matmuls (MXU padding that costs H x the FLOPs) are
// gone; each (row, head, key) is computed directly, one block per query row,
// with the row's q, sinusoid embedding, transposed pos-FC weights and
// affinities in shared memory, so the [b, R, n, P] embedding and the
// [b, R, H, n] bias never reach device memory. K and VW are read through
// L1/L2; staging them once per tile of rows in shared memory is later work.
//
// The train variant (a non-null `pwr`) differs in one 4-byte store per
// (row, head, key) from the lane that already holds the value: H x n floats
// per row, 33 MB per direction at b=256, written once and read by the
// backward. Nothing else changes; the eval launches pass null.
//
// Accuracy: the sinusoid arguments reach ~700 rad, so this file uses sinf /
// cosf / logf / expf and must not be built with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads) implicit_attention_kernel(
    const float* __restrict__ q,       // [b, R, H, dh]
    const float* __restrict__ k,       // [b, n, H, dh]
    const float* __restrict__ vw,      // [b, n, H, o]
    const float* __restrict__ pm,      // [b, R, n, 4]
    const float* __restrict__ w_pos,   // [P, H]
    const float* __restrict__ b_pos,   // [H]
    const float* __restrict__ mrow,    // [b, n]  additive key mask (0 / -9e15)
    const float* __restrict__ freq,    // [P]     per-lane sinusoid frequency
    const uint8_t* __restrict__ keep,  // [b, R, n, P] keep-mask, or null
    float inv_keep, float scale,
    float* __restrict__ out,           // [b, R, H, o]
    float* __restrict__ pwr,           // [b, R, H, n] post-relu pos weights, or null
    int R, int n, int H, int dh, int o, int P) {
  extern __shared__ float smem[];
  float* s_q = smem;               // [H * dh]
  float* s_pe = s_q + H * dh;      // [n * P]
  float* s_wt = s_pe + n * P;      // [H * P]  pos-FC weights, transposed
  float* s_aff = s_wt + H * P;     // [H * n]  affinities, then weights
  float* s_sum = s_aff + H * n;    // [H]
  float* s_red = s_sum + H;        // [kWarps]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int e = blockIdx.y;
  const size_t row = (size_t)e * R + blockIdx.x;

  const float* q_row = q + row * H * dh;
  for (int i = tid; i < H * dh; i += kThreads) s_q[i] = q_row[i];
  for (int i = tid; i < H * P; i += kThreads) {
    const int h = i / P, p = i % P;
    s_wt[i] = w_pos[p * H + h];
  }
  // Lane layout of ops/position.py::position_embedding: P/4 lanes per
  // geometric feature, the first P/8 of them sin, the next P/8 cos.
  const int per_geom = P / 4;
  const int n_freq = P / 8;
  const float* pm_row = pm + row * n * 4;
  const uint8_t* keep_row = keep ? keep + row * n * P : nullptr;
  for (int i = tid; i < n * P; i += kThreads) {
    const int m = i / P, p = i % P;
    const int j = p % per_geom;
    const float x = pm_row[m * 4 + p / per_geom] * freq[p];
    float v = (j >= n_freq) ? cosf(x) : sinf(x);
    if (keep_row) v *= (float)keep_row[i] * inv_keep;
    s_pe[i] = v;
  }
  __syncthreads();

  // One warp per (head, key): q.k and the pos-FC dot, lanes over dh and P.
  const float* k_ex = k + (size_t)e * n * H * dh;
  const float* mrow_ex = mrow + (size_t)e * n;
  for (int pair = warp; pair < H * n; pair += kWarps) {
    const int h = pair / n, m = pair % n;
    const float* k_vec = k_ex + ((size_t)m * H + h) * dh;
    const float* q_vec = s_q + h * dh;
    float dot = 0.f;
    for (int d = lane; d < dh; d += 32) dot += q_vec[d] * k_vec[d];
    const float* pe_vec = s_pe + m * P;
    const float* w_vec = s_wt + h * P;
    float pw = 0.f;
    for (int p = lane; p < P; p += 32) pw += pe_vec[p] * w_vec[p];
    dot = warp_sum(dot);
    pw = warp_sum(pw);
    if (lane == 0) {
      const float relu_pw = fmaxf(pw + b_pos[h], 0.f);
      if (pwr) pwr[row * H * n + pair] = relu_pw;
      const float bias = logf(fmaxf(relu_pw, 1e-6f)) + mrow_ex[m];
      s_aff[pair] = dot * scale + bias;
    }
  }
  __syncthreads();

  // Row max over all heads.
  float mx = -INFINITY;
  for (int i = tid; i < H * n; i += kThreads) mx = fmaxf(mx, s_aff[i]);
  mx = warp_max(mx);
  if (lane == 0) s_red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < kWarps ? s_red[lane] : -INFINITY;
    mx = warp_max(mx);
    if (lane == 0) s_red[0] = mx;
  }
  __syncthreads();
  mx = s_red[0];
  for (int i = tid; i < H * n; i += kThreads) s_aff[i] = expf(s_aff[i] - mx);
  __syncthreads();

  // Per-head denominators.
  for (int h = warp; h < H; h += kWarps) {
    float s = 0.f;
    for (int m = lane; m < n; m += 32) s += s_aff[h * n + m];
    s = warp_sum(s);
    if (lane == 0) s_sum[h] = s + 1e-30f;
  }
  __syncthreads();
  for (int i = tid; i < H * n; i += kThreads) s_aff[i] = s_aff[i] / s_sum[i / n];
  __syncthreads();

  // out[h, c] = sum_m w[h, m] vw[m, h, c]; neighbouring threads read
  // neighbouring c.
  const float* vw_ex = vw + (size_t)e * n * H * o;
  float* out_row = out + row * H * o;
  for (int i = tid; i < H * o; i += kThreads) {
    const int h = i / o, c = i % o;
    const float* w_h = s_aff + h * n;
    const float* v = vw_ex + (size_t)h * o + c;
    float acc = 0.f;
    for (int m = 0; m < n; ++m) acc += w_h[m] * v[(size_t)m * H * o];
    out_row[i] = acc;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t regat_implicit_attention_smem_bytes(int n, int H, int dh, int P) {
  return sizeof(float) * ((size_t)H * dh + (size_t)n * P + (size_t)H * P +
                          (size_t)H * n + H + kWarps);
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `pwr` null: the eval variant; non-null: the train variant.
int regat_implicit_attention_fwd(
    const float* q, const float* k, const float* vw, const float* pm,
    const float* w_pos, const float* b_pos, const float* mrow,
    const float* freq, const uint8_t* keep, float inv_keep, float scale,
    float* out, float* pwr, int b, int R, int n, int H, int dh, int o, int P,
    void* stream) {
  const size_t smem = regat_implicit_attention_smem_bytes(n, H, dh, P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        implicit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(R, b);
  implicit_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, vw, pm, w_pos, b_pos, mrow, freq, keep, inv_keep, scale, out, pwr, R, n,
      H, dh, o, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
