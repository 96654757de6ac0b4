// Fused implicit graph attention, one direction, forward: an eval variant and
// a train variant that also stores the post-relu pos weights.
//
// Replaces the Pallas TPU kernel
// tf_vqa_regat_tpu/ops/pallas/implicit_attention.py::_kernel_v3, both
// save_pwr=False (eval) and save_pwr=True (train), and computes the same
// function for every query row r of an example:
//
//   pe[m, p]   = sin|cos(pos[r, m, g(p)] * freq[p])         (optional keep-mask)
//   pwr[h, m]  = relu(sum_p pe[m, p] W[p, h] + b[h])        (stored if train)
//   bias[h, m] = log(max(pwr[h, m], 1e-6)) + mask[m]
//   aff[h, m]  = q[r, h] . k[m, h] * scale + bias[h, m]
//   w[h, m]    = exp(aff - max over ALL h, m) / (sum_m exp(...) + 1e-30)
//   out[r, h]  = sum_m w[h, m] vw[m, h, :]
//
// The softmax is normalised by the row max over all heads with an eps
// denominator, as _kernel_v3 does: a head whose whole segment underflows
// against that max gets all-zero weights, and a fully masked row (every key
// at -9e15) gets uniform weights. The sinusoid's argument is pos * freq,
// rounded once with the lane's single f32 frequency; the keep-mask enters as
// pe * (keep * inv_keep).
//
// What bounds it on an H100: at the model's shapes (R=100, H=16, dh=o=64,
// n=20, P=64, b=256) the train variant reads q (105 MB), the keep-mask
// (33 MB), k and vw (42 MB) and the position matrix (8 MB) and writes out
// (105 MB) and pwr (33 MB): 325 MB, 97 us at 3.35 TB/s, for 3.1 GFLOP of dots
// (46 us at 67 TFLOP/s f32) and 16M sincos. So it is memory-bound and stays
// off the tensor cores (TF32 would also break the agreement with the plain
// version, which the log magnifies near its 1e-6 floor).
//
// Design: the skeleton of csrc/graph_attention.cu (B2) plus a pos-FC phase.
// A block takes a chunk of query rows of one example (the wrapper's tiling
// plan: a whole example at b=256, 34 rows at b=64, 20 at b=32, 8 at b <= 8)
// and stages the example's K and VW once by 16-byte cp.async, with the
// pos-FC kernel, its bias, the lane frequencies and the key-mask row. K is
// [H, n, dh] with each row's 16-byte chunks rotated by the row's index: the
// banks of B2's rows padded to dh+4, without the 5 KB of padding, which the
// f64 pos-FC kernel takes instead (228,880 B of the 232,448 at the model's
// widths). Its 512 threads form two groups of 256 that walk the chunk's 5-row
// tiles in turns behind their own named barriers. Per tile, four phases:
//   0. pos-FC: the tile's bias [5, H, nP] is built in the group's weight
//      buffer. A thread pair takes one (row, key), one thread per half of
//      the P lanes (geometries 0-1, 2-3): one sincosf per (geometry,
//      frequency) gives its sin and cos lanes, the keep-mask is read as
//      32-bit words, and the thread keeps the 16 heads' sums in registers
//      against the pos-FC kernel, which shared memory broadcasts (a table
//      per lane half, 64 bytes out of bank step, so a warp's two addresses
//      never share a bank). The sums are f64 (DFMA) and each pos-FC output
//      is rounded to f32 once, with its bias: where it cancels to just above
//      the 1e-6 floor, one f32 step of it (~6e-8) moves the output by up to
//      ~1e-2 through relu and the log, so an f32 sum in any order parts from
//      the plain version there, and the nearest f32 is the one value both
//      can agree on. One xor shuffle per pair of heads joins the halves.
//      The train variant stores pwr there (kSavePwr, a template flag, so the
//      eval variant has no such store);
//   1. affinities, as B2: a thread owns two keys of one head for every row of
//      the tile and adds dot * scale to the bias in place; the row max is one
//      redux.sync per warp and row on the order-preserving integer image,
//      merged by a shared-memory atomicMax (exact and order-independent, so
//      two launches give equal bits);
//   2. exponentials, float4 in place;
//   3. output, one thread per (head, 4 channels), every row of the tile,
//      float4 stores, the denominators summed from the weights it reads.
// What this does about the causes that held the first version (one block
// per query row, one warp per (head, key)):
//  1. K and VW re-read for every query row: staged once per chunk (once per
//     example at b=256: 42 MB instead of ~4 GB of L1/L2 traffic).
//  2. A warp reduction per (head, key): gone. Dots are whole in registers;
//     the pos-FC sums need one shuffle per two heads and (row, key).
//  3. Serialised phases: the two groups fill each other's barriers, and a
//     group copies its next q tile during its exponentials and output.
//  4. The sinusoid twice: one sincosf per (row, key, geometry, frequency),
//     shared by all 16 heads and by the sin and cos lanes.
//  5. Host cost: the wrapper keeps the launch's scalars per shape, sets the
//     shared-memory attribute once per device, and the kernel reads the bool
//     key mask and a null pos-FC bias itself.
// Stages landed: K and VW staged once per chunk with the pos-FC phase in
// shared memory (stages 1 and 2), and the wrapper's host cost (stage 3).
// No tensor cores, clusters, persistent scheduling or warp specialisation:
// the work is memory-bound.
//
// Accuracy: the sinusoid arguments reach ~700 rad, so this file uses sincosf
// / logf / expf and must not be built with --use_fast_math.
//
// Backward: implicit_attention_bwd_kernel and implicit_attention_bwd_reduce
// give (dq, dk, dvw, dW_pos, db_pos) for the output cotangent g, the gradient
// of the train variant. They replace the JAX package's XLA VJP
// tf_vqa_regat_tpu/ops/pallas/implicit_attention.py::_fused_v3_bwd, which no
// Pallas kernel computes, and compute what its PyTorch transcription
// (implicit_attention_backward in the wrapper) computes:
//
//   w        the forward's weights, rebuilt from q, k, the saved pwr and
//            the saved row max (the max over all heads, so that a block
//            needs only its own heads)
//   dvw[m]   = sum_r w[r, m] g[r]               dw[r, m] = g[r] . vw[m]
//   daff     = w (dw - sum_m w dw)              (the max taken as constant)
//   dq[r]    = scale sum_m daff[r, m] k[m]      dk[m] = scale sum_r daff[r, m] q[r]
//   dpwr     = daff / pwr where pwr > 1e-6, else 0
//   dW_pos[p, h] = sum_{r, m} pe[r, m, p] dpwr[r, h, m]   db_pos[h] = sum dpwr[r, h, m]
//
// with pe the keep-masked sinusoid embedding; no gradient w.r.t. the
// position matrix.
//
// What bounds it: at the model's shapes (b=256) a direction reads g and q
// (105 MB each), k and vw (21 MB each), pwr and the keep-mask (33 MB each)
// and the position matrix (8 MB), and writes dq (105 MB), dk and dvw: 473 MB,
// 141 us at 3.35 TB/s, for ~6.3 GFLOP (94 us at 67 TFLOP/s f32). The
// transcription it replaces on the card built the [b, R, n, P] embedding
// (131 MB) and the [b, R, H, n] weights in HBM with a dozen kernels.
//
// Design: a block of 512 threads per (example, head group of hb <= 8 heads,
// chunk of query rows) (the wrapper's backward_plan: the whole example and 8
// heads at b=256, H=16); nothing of size [b, R, n, P] or [b, R, H, n] leaves
// the block.
//   - The group's K and VW are staged once by cp.async, rows padded to dh+4
//     so that a quarter-warp's 16-byte reads of 8 rows hit 8 bank groups.
//   - 8-row tiles of q, g, pwr, the position matrix, the keep-mask and the
//     row maxima stream through two buffers: tile t + 1's cp.async copies
//     run during tile t's phases.
//   - Per tile, between block barriers: A, the dots q . k and g . vw, a
//     thread per (head, key) over the tile's rows; B, per (row, head, key)
//     the affinity and its exponential as the forward builds them (the same
//     dot, bias and row max, so the same bits); C, per (row, head) the
//     forward's denominator and sum_m w dw; D, per (row, head, key) w, daff
//     and dpwr; then E, F and G, which only read: dq (a thread per head and
//     4 channels, float4 stores), the dK and dVW sums, and dW_pos. Each
//     thread's share of the copies and of B and D is fixed at the start, so
//     the tile loop divides by no runtime width.
//   - dK and dVW are sums over the chunk's rows kept in registers (10 keys of
//     one head and 4 channels per thread), added in row order and stored
//     once; with several row chunks per example (small b) each chunk stores
//     its sums and the reduce adds them in chunk order.
//   - dW_pos and db_pos are f64, as the forward's pos-FC sum is: dpwr
//     divides by pwr, which may sit just above 1e-6. dW_pos[p, h] sums
//     pe[i, p] dpwr[i, h] over the items i = (row, key), a product of K = 4
//     items at a time on the f64 tensor cores (mma m8n8k4: 8 embedding lanes
//     by 8 heads); a lane rebuilds its embedding lanes with one sincosf per
//     (item, geometry, frequency), as the forward does. The warps' sums are
//     added in warp order, and the blocks' in the reduce, in a fixed order,
//     and rounded to f32 once.
//   - No atomics: two launches on the same inputs give equal bits.
//   - No per-(head, key) warp reduction: dots are whole in a thread.
//   - The model's widths (16 heads of 64, n = 20, P = 64, so 8 heads a
//     block) run an instance whose widths are template parameters
//     (kBwdInstances); every other shape the wrapper's plan takes runs the
//     general instance, the same code with its widths read at run time,
//     which at the model's widths ran 1.5x slower (0.95 against 0.63 ms:
//     its per-key loops keep their guards, with exposed load latency).
// The train variant stores the row max [b, R] for it (rowmax); the eval
// variant is untouched.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 2;  // tile pipelines per block, sharing K and VW
constexpr int kGroupThreads = 256;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kTile = 5;       // query rows per tile
constexpr int kMaxHeads = 16;  // pos-FC sums a thread keeps in registers
constexpr float kMasked = -9e15f;  // additive key mask (reference graph_att_layer.py:95)

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
  int k, vw, wpos, bpos, freq, mrow, q, w, mx, group, total;
  __host__ __device__ Layout(int H, int dh, int n, int o, int P) {
    const int nP = (n + 3) & ~3, dP = dh + 4;
    k = 0;                         // [H, n, dh]     the example's keys, chunks rotated
    vw = k + H * n * dh;           // [nP, H, o]     its values, rows >= n zero
    wpos = vw + nP * H * o;        // f64 [2, P/2, H] pos-FC kernel by lane half, 64 B apart
    bpos = wpos + 2 * P * H + 16;  // [H]            pos-FC bias
    freq = bpos + ((H + 3) & ~3);  // [P]            lane frequencies
    mrow = freq + P;               // [nP]           key mask, 0 / -9e15
    q = mrow + nP;                 // per group: [kTile, H, dP]  the tile's q
    w = q + kTile * H * dP;        //   [kTile, H, nP]  bias, affinities, exponentials
    mx = w + kTile * H * nP;       //   [kTile]  ordered row max
    group = mx + ((kTile + 3) & ~3) - q;  // floats per group
    total = q + kGroups * group;
  }
};

template <bool kSavePwr>
__global__ void __launch_bounds__(kThreads, 1) implicit_attention_kernel(
    const float* __restrict__ q,        // [b, R, H, dh]
    const float* __restrict__ k,        // [b, n, H, dh]
    const float* __restrict__ vw,       // [b, n, H, o]
    const float* __restrict__ pm,       // [b, R, n, 4]
    const float* __restrict__ w_pos,    // [P, H]
    const float* __restrict__ b_pos,    // [H], or null (zero)
    const uint8_t* __restrict__ key_mask,  // [b, n] bool, rows `sm` apart
    const float* __restrict__ freq,     // [P]  per-lane sinusoid frequency
    const uint8_t* __restrict__ keep,   // [b, R, n, P] keep-mask, or null
    float inv_keep, float scale,
    float* __restrict__ out,            // [b, R, H, o]
    float* __restrict__ pwr,            // [b, R, H, n] post-relu pos weights (train)
    float* __restrict__ rowmax,         // [b, R] max of aff over all heads and keys (train)
    int R, int n, int H, int dh, int o, int P, int sm, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(H, dh, n, o, P);
  const int nP = (n + 3) & ~3, nP4 = nP / 4, dP = dh + 4, d4n = dh / 4, o4n = o / 4;
  const int HD = H * dh, Ho = H * o, P2 = P / 2, P4 = P / 4, P8 = P / 8;
  const int tid = threadIdx.x;
  const int g = tid / kGroupThreads, gt = tid - g * kGroupThreads;
  const int lane = tid & 31, gwarp = gt >> 5;
  float* s_k = smem + L.k;
  float* s_vw = smem + L.vw;
  double* s_wpos = reinterpret_cast<double*>(smem + L.wpos);
  float* s_bpos = smem + L.bpos;
  float* s_freq = smem + L.freq;
  float* s_mrow = smem + L.mrow;
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

  // K (re-laid as [H, n, dh]), VW and each group's first tile, by all threads.
  const float* k_ex = k + (size_t)e * n * HD;
  for (int c = tid; c < n * H * d4n; c += kThreads) {
    const int mh = c / d4n, d4 = c - mh * d4n;
    const int m = mh / H, h = mh - m * H;
    // chunk d4 of key row rr at (d4 + rr) % d4n: the banks of padded rows,
    // without the padding
    cp_async16(s_k + (h * n + m) * dh + (d4 + h * n + m) % d4n * 4, k_ex + (size_t)c * 4);
  }
  const float* vw_ex = vw + (size_t)e * n * Ho;
  for (int c = tid; c < n * Ho / 4; c += kThreads) cp_async16(s_vw + c * 4, vw_ex + (size_t)c * 4);
  if (g < tiles) load_q(g);
  cp_async_commit();
  // The pos-FC kernel in f64, lane p at row p % P2 of half p / P2's table;
  // half 1's table starts 64 bytes past a multiple of 128, so the two halves
  // of a warp, reading the same row of their tables, hit different banks.
  // Its bias, the lane frequencies and the key mask as 0 / -9e15.
  for (int i = tid; i < P * H; i += kThreads) {
    const int p = i / H, h = i - p * H, half = p / P2;
    s_wpos[half * (P2 * H + 8) + (p - half * P2) * H + h] = (double)w_pos[i];
  }
  for (int i = tid; i < H; i += kThreads) s_bpos[i] = b_pos ? b_pos[i] : 0.f;
  for (int i = tid; i < P; i += kThreads) s_freq[i] = freq[i];
  for (int i = tid; i < n; i += kThreads) s_mrow[i] = key_mask[(size_t)e * sm + i] ? 0.f : kMasked;
  // Zeros where a tile reads beyond the keys: VW rows n..nP-1 and the whole
  // weight buffer (its padding columns are never written again; rows past a
  // ragged tile's end stay finite). The row maxima start at -inf.
  for (int i = n * Ho + tid; i < nP * Ho; i += kThreads) s_vw[i] = 0.f;
  for (int i = gt; i < kTile * H * nP; i += kGroupThreads) s_w[i] = 0.f;
  if (gt < kTile) s_mx[gt] = ordered(-INFINITY);
  cp_async_wait_all();
  __syncthreads();  // all staged; from here on the groups run apart

  const float* pm_ex = pm + (size_t)e * R * n * 4;
  const uint8_t* keep_ex = keep ? keep + (size_t)e * R * n * P : nullptr;
  float* pwr_ex = kSavePwr ? pwr + (size_t)e * R * H * n : nullptr;
  // Group g takes tiles g, g + 2, ...: while one group is in one phase, the
  // other's phases fill the SM. Only group barriers from here on.
  for (int t = g; t < tiles; t += kGroups) {
    const int r0 = r_begin + t * kTile;
    const int rows = min(kTile, r_end - r0);
    if (t != g) {
      cp_async_wait_all();  // this tile's q, copied during the last tile
      group_sync(g);        // and the last tile's output has read the weights
    }

    // 0. Bias: threads 2i and 2i + 1 take (row, key) i of the tile, lanes
    //    [0, P/2) (geometries 0, 1) and [P/2, P) (2, 3). The loop runs by
    //    whole warps for the shuffle; the two threads of a pair are always
    //    both active.
    const int items = rows * n * 2;
    for (int i0 = gwarp * 32; i0 < items; i0 += kGroupThreads) {
      const bool active = i0 + lane < items;
      const int i = active ? i0 + lane : items - 1;
      const int half = i & 1, rm = i >> 1;
      const int r = rm / n, m = rm - r * n;
      const size_t pair = (size_t)r0 * n + rm;  // (row, key) within the example
      const float2 pos = *reinterpret_cast<const float2*>(pm_ex + pair * 4 + 2 * half);
      const uint32_t* keep32 =
          keep_ex ? reinterpret_cast<const uint32_t*>(keep_ex + pair * P + half * P2) : nullptr;
      // The sums in f64: rounded once, below, they are the f32 nearest the
      // exact pos-FC output, which relu and the log magnify where it cancels
      // to near zero.
      const double* w_half = s_wpos + half * (P2 * H + 8);
      double acc[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.0;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const float x = gi ? pos.y : pos.x;
        const int l0 = gi * P4;  // the geometry's first (sin) lane within the half
        const float* f = s_freq + half * P2 + l0;
        for (int j0 = 0; j0 < P8; j0 += 4) {
          // keep bytes of sin lanes l0 + j0.. and cos lanes l0 + P/8 + j0..
          uint32_t ks = 0, kc = 0;
          if (keep32) {
            ks = keep32[(l0 + j0) / 4];
            kc = keep32[(l0 + P8 + j0) / 4];
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + jj;
            float sv, cv;
            sincosf(__fmul_rn(x, f[j]), &sv, &cv);
            if (keep32) {
              sv *= (float)((ks >> (8 * jj)) & 0xffu) * inv_keep;
              cv *= (float)((kc >> (8 * jj)) & 0xffu) * inv_keep;
            }
            const double s = sv, c = cv;
            const double2* ws = reinterpret_cast<const double2*>(w_half + (l0 + j) * H);
            const double2* wc = reinterpret_cast<const double2*>(w_half + (l0 + P8 + j) * H);
#pragma unroll
            for (int h2 = 0; h2 < kMaxHeads / 2; ++h2) {
              if (2 * h2 < H) {
                const double2 a = ws[h2], b = wc[h2];
                acc[2 * h2] = fma(s, a.x, acc[2 * h2]);
                acc[2 * h2 + 1] = fma(s, a.y, acc[2 * h2 + 1]);
                acc[2 * h2] = fma(c, b.x, acc[2 * h2]);
                acc[2 * h2 + 1] = fma(c, b.y, acc[2 * h2 + 1]);
              }
            }
          }
        }
      }
      // Heads 2j (thread of half 0) and 2j + 1 (half 1): each sends its
      // partner the half sum the partner finishes.
#pragma unroll
      for (int hp = 0; hp < kMaxHeads / 2; ++hp) {
        if (2 * hp < H) {
          const double own = half ? acc[2 * hp + 1] : acc[2 * hp];
          const double give = half ? acc[2 * hp] : acc[2 * hp + 1];
          const int h = 2 * hp + half;
          const double sum = own + __shfl_xor_sync(0xffffffffu, give, 1) + (double)s_bpos[h];
          const float pw = fmaxf(__double2float_rn(sum), 0.f);
          if (active) {
            if (kSavePwr) pwr_ex[((size_t)(r0 + r) * H + h) * n + m] = pw;
            s_w[(r * H + h) * nP + m] = logf(fmaxf(pw, 1e-6f)) + s_mrow[m];
          }
        }
      }
    }
    group_sync(g);

    // 1. Affinities: a thread takes keys m0 and m0 + n2 of one head (n2 =
    //    ceil(n / 2)) for every row of the tile, so each q read serves two
    //    dots, and adds dot * scale to the bias in place (rounded in that
    //    order, as the plain version does). The loop runs by whole warps, so
    //    that the row max is taken per warp (one redux.sync per row) and
    //    merged across warps by an atomic max.
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
        b0[r] = r < rows ? s_w[(r * H + h) * nP + m0] : 0.f;
        b1[r] = r < rows ? s_w[(r * H + h) * nP + m1c] : 0.f;
      }
      const int ra = h * n + m0, rb = h * n + m1c;
      const float4* k4a = reinterpret_cast<const float4*>(s_k + ra * dh);
      const float4* k4b = reinterpret_cast<const float4*>(s_k + rb * dh);
      int ca = ra % d4n, cb = rb % d4n;  // where chunk 0 of each key row sits
      const float4* q4 = reinterpret_cast<const float4*>(s_q + h * dP);
      float a0[kTile], a1[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < d4n; ++d4) {
        const float4 ka = k4a[ca], kb = k4b[cb];
        ca = ca + 1 == d4n ? 0 : ca + 1;
        cb = cb + 1 == d4n ? 0 : cb + 1;
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
        const float x = fmaxf(active ? x0 : -INFINITY, has1 ? x1 : -INFINITY);
        const int mx = __reduce_max_sync(0xffffffffu, ordered(x));
        if (lane == 0 && r < rows) atomicMax(s_mx + r, mx);
      }
    }
    group_sync(g);
    // the train variant keeps the row max, so that the backward can rebuild
    // the weights of a subset of the heads
    if (kSavePwr && gt < rows) rowmax[(size_t)e * R + r0 + gt] = unordered(s_mx[gt]);
    if (t + kGroups < tiles) {
      load_q(t + kGroups);  // this group's q buffer is free: its affinities are done
      cp_async_commit();
    }

    // 2. Exponentials in place against the row max, one thread per 4 keys
    //    of a (row, head) segment (padding keys stay 0).
    for (int i = gt; i < rows * H * nP4; i += kGroupThreads) {
      const int s = i / nP4, m = (i - s * nP4) * 4;
      float* seg = s_w + s * nP;
      const float mx = unordered(s_mx[s / H]);
      float4 a = *reinterpret_cast<const float4*>(seg + m);
      a.x = m < n ? expf(a.x - mx) : 0.f;
      a.y = m + 1 < n ? expf(a.y - mx) : 0.f;
      a.z = m + 2 < n ? expf(a.z - mx) : 0.f;
      a.w = m + 3 < n ? expf(a.w - mx) : 0.f;
      *reinterpret_cast<float4*>(seg + m) = a;
    }
    group_sync(g);
    if (gt < kTile) s_mx[gt] = ordered(-INFINITY);

    // 3. out[r, h, c] = sum_m e[r, h, m] vw[m, h, c] / (sum_m e[r, h, m] + 1e-30):
    //    one thread per (head, 4 channels), every row of the tile, float4 in
    //    and out; each thread sums the denominators from the weights it
    //    reads. The next tile's first barrier orders these reads of s_w
    //    before its bias overwrites them, and the maxima reset above before
    //    its atomics.
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
          const float d = den[r] + 1e-30f;
          reinterpret_cast<float4*>(out_t + (size_t)r * Ho)[hc] =
              make_float4(acc[r].x / d, acc[r].y / d, acc[r].z / d, acc[r].w / d);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward (the note "Backward" at the top of the file).

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdHalf = kBwdThreads / 2;  // threads of the dK sums; the rest sum dVW
constexpr int kBwdTile = 8;       // query rows per tile
constexpr int kBwdMaxHeads = 8;   // heads per block: the N of a dW_pos product
constexpr int kBwdMaxKeys = 10;   // keys per thread in the dK and dVW sums, at most
constexpr int kBwdRowsD = 2;      // rows per thread in dq, at most (hb * dh <= 512)
constexpr int kRedThreads = 256;  // threads of a reduce block

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Shared-memory layout of a backward block, in floats (every region a
// multiple of 4). hb heads per block; nP = n rounded up to 4; dP = dh + 4,
// so that the rows of K, VW, q and g start 4 banks apart.
struct BwdLayout {
  int k, vw, mrow, freq, buf, q, g, pwr, pos, keep, mx, bufsize, w, da, den, s, dp, red, total;
  __host__ __device__ BwdLayout(int hb, int dh, int n, int P) {
    const int nP = (n + 3) & ~3, dP = dh + 4, T = kBwdTile, th = (T * hb + 3) & ~3;
    k = 0;                       // [hb, n, dP]  the head group's keys
    vw = k + hb * n * dP;        // [hb, n, dP]  and values
    mrow = vw + hb * n * dP;     // [nP]         key mask, 0 / -9e15
    freq = mrow + nP;            // [P]          lane frequencies
    buf = freq + P;              // two tile buffers, each (offsets within it):
    q = 0;                       //   [T, hb, dP]  q rows
    g = q + T * hb * dP;         //   [T, hb, dP]  output cotangent rows
    pwr = g + T * hb * dP;       //   [T, hb, nP]  post-relu pos weights
    pos = pwr + T * hb * nP;     //   [T, n, 4]    position matrix rows
    keep = pos + T * n * 4;      //   [T, n, P]    keep-mask bytes
    mx = keep + T * n * P / 4;   //   [T]          row maxima
    bufsize = mx + T;
    w = buf + 2 * bufsize;       // [T, hb, nP]  exponentials, then weights
    da = w + T * hb * nP;        // [T, hb, nP]  dw, then daff
    den = da + T * hb * nP;      // [T, hb]      denominators
    s = den + th;                // [T, hb]      sum_m w dw
    dp = s + th;                 // f64 [T, nP, hb]  dpwr
    total = dp + 2 * T * nP * hb;
    red = 0;                     // f64 [kBwdWarps, P + 1, hb] after the last tile
    const int red_end = red + 2 * kBwdWarps * (P + 1) * hb;
    total = total > red_end ? total : red_end;
  }
};

// m8n8k4 product on the f64 tensor cores, d += a b, with one lane's
// fragments: a = A[lane / 4][lane % 4], b = B[lane % 4][lane / 4] and
// d = D[lane / 4][2 (lane % 4) + {0, 1}].
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// One block per (example, head group of hb heads, chunk of `chunk` query
// rows); grid (H / hb * chunks, b), the head group fastest. HB, N, DH and
// PP are the widths (hb, n, dh, P) of a specialised instance, with which the
// tile loop's indexing folds and its loops unroll without guards; all 0 in
// the general instance, which reads them from its arguments.
template <int HB, int N, int DH, int PP>
__global__ void __launch_bounds__(kBwdThreads, 1) implicit_attention_bwd_kernel(
    const float* __restrict__ gy,       // [b, R, H, dh] output cotangent
    const float* __restrict__ q,        // [b, R, H, dh]
    const float* __restrict__ k,        // [b, n, H, dh]
    const float* __restrict__ vw,       // [b, n, H, dh]
    const float* __restrict__ pm,       // [b, R, n, 4]
    const float* __restrict__ mrow,     // [b, n] additive key mask, 0 / -9e15
    const float* __restrict__ freq,     // [P]  per-lane sinusoid frequency
    const uint8_t* __restrict__ keep,   // [b, R, n, P] keep-mask, or null
    float inv_keep,
    const float* __restrict__ pwr,      // [b, R, H, n] saved by the train variant
    const float* __restrict__ rowmax,   // [b, R]       saved by the train variant
    float scale,
    float* __restrict__ dq,             // [b, R, H, dh]
    float* __restrict__ dk,             // [b, n, H, dh] (one chunk per example)
    float* __restrict__ dvw,            // [b, n, H, dh] (one chunk per example)
    float* __restrict__ ws_kv,          // [2, chunks, b, n, H, dh] (several chunks)
    double* __restrict__ ws_w,          // [chunks, b, P + 1, H] the blocks' dW_pos, db_pos
    int b, int R, int H, int chunk, int chunks, int hb_, int n_, int dh_, int P_) {
  constexpr bool kFixed = HB > 0;
  const int hb = kFixed ? HB : hb_, n = kFixed ? N : n_, dh = kFixed ? DH : dh_;
  const int P = kFixed ? PP : P_;
  const int nP = (n + 3) & ~3, dP = dh + 4, dP4 = dP / 4, d4n = dh / 4, hn = hb * n;
  const int qc = hb * d4n;  // (head, 4 channels) of a q or g row
  const int S = kBwdHalf / qc;  // dK / dVW: key slices
  const int RG = kBwdThreads / qc;  // dq: row groups
  // keys per thread in the dK / dVW sums and rows per thread in dq: exact
  // in a specialised instance, the most the wrapper's plan allows otherwise
  constexpr int kQc = kFixed ? HB * DH / 4 : 1;
  constexpr int kKeys = kFixed ? (N + kBwdHalf / kQc - 1) / (kBwdHalf / kQc) : kBwdMaxKeys;
  constexpr int kRowsD =
      kFixed ? (kBwdTile + kBwdThreads / kQc - 1) / (kBwdThreads / kQc) : kBwdRowsD;
  static_assert(!kFixed || (DH % 4 == 0 && N % 4 == 0 && PP % 16 == 0 && PP <= 256 &&
                            HB <= kBwdMaxHeads && HB * N <= kBwdThreads),
                "an instance");
  static_assert(kKeys <= kBwdMaxKeys && kRowsD <= kBwdRowsD, "registers");
  extern __shared__ __align__(16) float smem[];
  const BwdLayout L(hb, dh, n, P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = H / hb;
  const int c = blockIdx.x / groups, h0 = (blockIdx.x - c * groups) * hb, e = blockIdx.y;
  const int r_begin = c * chunk, r_end = min(R, r_begin + chunk);
  const int tiles = (r_end - r_begin + kBwdTile - 1) / kBwdTile;
  float* s_k = smem + L.k;
  float* s_vw = smem + L.vw;
  float* s_mrow = smem + L.mrow;
  float* s_freq = smem + L.freq;
  float* s_w = smem + L.w;
  float* s_da = smem + L.da;
  float* s_den = smem + L.den;
  float* s_s = smem + L.s;
  double* s_dp = reinterpret_cast<double*>(smem + L.dp);

  // Each thread's fixed share of a tile's copies and elementwise work,
  // computed once: 16-byte chunk q_j of the q (or g) rows q_r, q_r +
  // q_step, ...; of the pwr rows p_r, p_r + p_step, ..., 16-byte chunk p_j
  // where n is a multiple of 4 (a row's hb n floats are contiguous, nP ==
  // n), else float p_j; the (head, key) (el_h, el_m) of the rows el_r,
  // el_r + el_step, ...
  const int q_step = kBwdThreads / (2 * qc), q_r = tid / (2 * qc);
  const int q_which = tid % (2 * qc) >= qc, q_j = tid % (2 * qc) - q_which * qc;
  const int q_dst = (q_which ? L.g : L.q) + q_j / d4n * dP + q_j % d4n * 4;
  const float* q_src = (q_which ? gy : q) + (size_t)h0 * dh + q_j * 4;  // + row H dh
  const bool p_vec = n % 4 == 0;
  const int p_w = p_vec ? hn / 4 : hn;
  const int p_step = kBwdThreads / p_w, p_r = tid / p_w, p_j = tid % p_w;
  const int el_step = kBwdThreads / hn, el_r = tid / hn;
  const int el_h = tid % hn / n, el_m = tid % hn - el_h * n;

  // tile t's rows of q, g, pwr, the position matrix, the keep-mask and the
  // row maxima into buffer t % 2
  auto load_tile = [&](int t) {
    float* buf = smem + L.buf + (t & 1) * L.bufsize;
    const int r0 = r_begin + t * kBwdTile, rows = min(kBwdTile, r_end - r0);
    const size_t row0 = (size_t)e * R + r0;  // the tile's first row of [b, R]
    for (int r = q_r; q_r < q_step && r < rows; r += q_step)
      cp_async16(buf + q_dst + r * hb * dP, q_src + (row0 + r) * H * dh);
    if (p_vec) {
      const float* pw = pwr + (row0 * H + h0) * n + 4 * p_j;
      for (int r = p_r; p_r < p_step && r < rows; r += p_step)
        cp_async16(buf + L.pwr + r * hb * nP + 4 * p_j, pw + (size_t)r * H * n);
    } else {
      const int ph = p_j / n, pk = p_j - ph * n;
      const float* pw = pwr + (row0 * H + h0) * n + p_j;
      for (int r = p_r; p_r < p_step && r < rows; r += p_step)
        cp_async4(buf + L.pwr + (r * hb + ph) * nP + pk, pw + (size_t)r * H * n);
    }
    for (int i = tid; i < rows * n; i += kBwdThreads)
      cp_async16(buf + L.pos + i * 4, pm + (row0 * n + i) * 4);
    if (keep) {
      const float* kp = reinterpret_cast<const float*>(keep + row0 * n * P);
      for (int i = tid; i < rows * n * P / 16; i += kBwdThreads)
        cp_async16(buf + L.keep + i * 4, kp + i * 4);
    }
    for (int i = tid; i < rows; i += kBwdThreads) cp_async4(buf + L.mx + i, rowmax + row0 + i);
  };

  // The head group's K and VW, the first tile, the key mask and the lane
  // frequencies. The weight buffers' padding keys, never written again,
  // read as zeros.
  const float* k_ex = k + (size_t)e * n * H * dh;
  const float* vw_ex = vw + (size_t)e * n * H * dh;
  for (int i = tid; i < hn * d4n; i += kBwdThreads) {
    const int mh = i / d4n, d4 = i - mh * d4n;
    const int m = mh / hb, hh = mh - m * hb;
    const size_t src = ((size_t)m * H + h0 + hh) * dh + d4 * 4;
    const int dst = (hh * n + m) * dP + d4 * 4;
    cp_async16(s_k + dst, k_ex + src);
    cp_async16(s_vw + dst, vw_ex + src);
  }
  load_tile(0);
  cp_async_commit();
  for (int i = tid; i < nP; i += kBwdThreads) s_mrow[i] = i < n ? mrow[(size_t)e * n + i] : 0.f;
  for (int i = tid; i < P; i += kBwdThreads) s_freq[i] = freq[i];
  for (int i = tid; i < 2 * kBwdTile * hb * nP; i += kBwdThreads) s_w[i] = 0.f;  // s_w, s_da

  // dK (threads [0, kBwdHalf)) and dVW (the rest), summed over the chunk's
  // rows in registers: head eh, channels 4 ec..4 ec + 3, keys slice + S j
  const int kind = tid / kBwdHalf, u = tid - kind * kBwdHalf;
  const int slice = u / qc, ehc = u - slice * qc;
  const int eh = ehc / d4n, ec = ehc - eh * d4n;
  const bool e_on = slice < S;
  float4 acc[kKeys];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // dW_pos in f64 (phase G): the warps form P / 16 sets of set_warps warps
  // (the warps past them, where P / 16 does not divide 16, idle), set pt
  // taking the 8 (geometry, frequency) pairs 8 pt..8 pt + 7. Lane l holds
  // pair 8 pt + l / 4, whose sin lane is row l / 4 of the D of product 0
  // and whose cos lane is that of product 1, and heads 2 (l % 4) and 2 (l %
  // 4) + 1, the D columns; set 0's lanes also sum their B fragments for
  // db_pos (head l / 4).
  const int fg = lane >> 2, fk = lane & 3;
  const int P4 = P / 4, P8 = P / 8, set_warps = kBwdWarps / (P / 16);
  const int pt = warp / set_warps, pair = 8 * pt + fg;
  // whether the warp takes a set: every warp where P / 16 divides 16 (known
  // at compile time in a specialised instance, so that the tile loop holds
  // no more registers for it)
  const bool g_on = (kFixed && kBwdWarps % (kFixed ? PP / 16 : 1) == 0) || pt < P / 16;
  const int geo = pair / P8, ps = geo * P4 + pair % P8;  // the pair's sin lane; cos: ps + P8
  double acc_w[2][2] = {{0.0, 0.0}, {0.0, 0.0}}, acc_b = 0.0;

  for (int t = 0; t < tiles; ++t) {
    const int r0 = r_begin + t * kBwdTile, rows = min(kBwdTile, r_end - r0);
    const float* buf = smem + L.buf + (t & 1) * L.bufsize;
    const float* s_q = buf + L.q;
    const float* s_g = buf + L.g;
    const float* s_pwr = buf + L.pwr;
    const float* s_mx = buf + L.mx;
    cp_async_wait_all();
    __syncthreads();  // tile t staged, and tile t - 1 read to its end
    if (t + 1 < tiles) {
      load_tile(t + 1);  // into the buffer tile t - 1 used
      cp_async_commit();
    }

    // A. The dots, a thread per (head, key) for every row of the tile:
    //    threads [0, hn) q . k, in the forward's order, into s_w; threads
    //    [hn, 2 hn) dw = g . vw into s_da. Rows past a ragged tile's end
    //    are computed, not stored.
    for (int i = tid; i < 2 * hn; i += kBwdThreads) {
      const int which = i >= hn, j = which ? i - hn : i;
      const int hh = j / n, m = j - hh * n;
      const float4* y4 = reinterpret_cast<const float4*>((which ? s_vw : s_k) + (hh * n + m) * dP);
      const float4* x4 = reinterpret_cast<const float4*>((which ? s_g : s_q) + hh * dP);
      float a[kBwdTile];
#pragma unroll
      for (int r = 0; r < kBwdTile; ++r) a[r] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < d4n; ++d4) {
        const float4 y = y4[d4];
#pragma unroll
        for (int r = 0; r < kBwdTile; ++r) {
          const float4 x = x4[r * hb * dP4 + d4];
          a[r] = fmaf(x.x, y.x, a[r]);
          a[r] = fmaf(x.y, y.y, a[r]);
          a[r] = fmaf(x.z, y.z, a[r]);
          a[r] = fmaf(x.w, y.w, a[r]);
        }
      }
      float* out = (which ? s_da : s_w) + hh * nP + m;
#pragma unroll
      for (int r = 0; r < kBwdTile; ++r) {
        if (r < rows) out[r * hb * nP] = a[r];
      }
    }
    __syncthreads();

    // B. Per (row, head, key): the affinity as the forward builds it (dot *
    //    scale + log(max(pwr, 1e-6)) + mask, rounded in that order) and its
    //    exponential against the saved row max: the forward's exponentials.
    for (int r = el_r; el_r < el_step && r < rows; r += el_step) {
      const int at = (r * hb + el_h) * nP + el_m;
      const float bias = logf(fmaxf(s_pwr[at], 1e-6f)) + s_mrow[el_m];
      s_w[at] = expf(__fadd_rn(__fmul_rn(s_w[at], scale), bias) - s_mx[r]);
    }
    __syncthreads();

    // C. Per (row, head): the denominator, summed as the forward sums it,
    //    and s = sum_m w dw.
    for (int i = tid; i < rows * hb; i += kBwdThreads) {
      const float* ew = s_w + i * nP;
      const float* dw = s_da + i * nP;
      float den = 0.f, sd = 0.f;
      for (int m = 0; m < nP; m += 4) {
        const float4 x = *reinterpret_cast<const float4*>(ew + m);
        den += (x.x + x.y) + (x.z + x.w);
      }
      for (int m = 0; m < n; ++m) sd = fmaf(ew[m], dw[m], sd);
      den += 1e-30f;
      s_den[i] = den;
      s_s[i] = sd / den;
    }
    __syncthreads();

    // D. Per (row, head, key): w, daff = w (dw - s), and dpwr = daff / pwr
    //    where pwr > 1e-6 (the gradient of log(max(relu(x), 1e-6))).
    for (int r = el_r; el_r < el_step && r < rows; r += el_step) {
      const int rh = r * hb + el_h, at = rh * nP + el_m;
      const float w = s_w[at] / s_den[rh];
      const float da = w * (s_da[at] - s_s[rh]);
      const float pw = s_pwr[at];
      s_w[at] = w;
      s_da[at] = da;
      s_dp[(r * nP + el_m) * hb + el_h] = pw > 1e-6f ? (double)(da / pw) : 0.0;
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
          const float4 y = k4[m * dP4];
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
      const float* x = (kind ? s_g : s_q) + eh * dP + ec * 4;
      const float* cf = (kind ? s_w : s_da) + eh * nP + slice;
      for (int r = 0; r < rows; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + r * hb * dP);
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

    // G. dW_pos[p, h] += pe[i, p] dpwr[i, h] over the tile's (row, key)
    //    items i, on the f64 tensor cores: each set of warps takes the items
    //    in groups of 4 (warp j of the set groups j, j + set_warps, ...),
    //    the K of two m8n8k4 products, whose A are the group's sin and cos
    //    lanes of the set's 8 pairs and whose B is its dpwr [4, 8 heads]
    //    (zero past hb). Lane l holds item 4 grp + l % 4: one sincosf gives
    //    its sin and cos lanes, as the forward's pos-FC phase does.
    {
      const float* pos = buf + L.pos;
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(buf + L.keep);
      const float f = s_freq[ps];
      const int items = rows * n;
      const int grp0 = g_on ? warp - pt * set_warps : 1 << 28;
      for (int grp = grp0; 4 * grp < items; grp += set_warps) {
        const int item = 4 * grp + fk;
        const bool valid = item < items;
        const int r = valid ? item / n : 0, m = item - r * n;
        const double bv = valid && fg < hb ? s_dp[(r * nP + m) * hb + fg] : 0.0;
        if (pt == 0) acc_b += bv;
        float sv = 0.f, cv = 0.f;
        if (valid) {
          sincosf(__fmul_rn(pos[item * 4 + geo], f), &sv, &cv);
          if (keep) {
            sv *= (float)kb[item * P + ps] * inv_keep;
            cv *= (float)kb[item * P + ps + P8] * inv_keep;
          }
        }
        mma_f64(acc_w[0], (double)sv, bv);
        mma_f64(acc_w[1], (double)cv, bv);
      }
    }
  }
  __syncthreads();  // every tile read: K and VW's space takes the dW_pos partials

  if (e_on) {
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int m = slice + j * S;
      if (m < n) {
        const size_t at = (((size_t)e * n + m) * H + h0 + eh) * dh + ec * 4;
        const float4 v = acc[j];
        if (chunks > 1) {
          *reinterpret_cast<float4*>(ws_kv + ((size_t)kind * chunks + c) * b * n * H * dh + at) = v;
        } else if (kind) {
          *reinterpret_cast<float4*>(dvw + at) = v;
        } else {
          *reinterpret_cast<float4*>(dk + at) =
              make_float4(scale * v.x, scale * v.y, scale * v.z, scale * v.w);
        }
      }
    }
  }
  // the block's dW_pos and db_pos: each set's warps' sums added in warp order
  double* red = reinterpret_cast<double*>(smem + L.red);  // [kBwdWarps, P + 1, hb]
  double* red_w = red + (size_t)warp * (P + 1) * hb;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int h = 2 * fk + i;
    if (g_on && h < hb) {
      red_w[ps * hb + h] = acc_w[0][i];
      red_w[(ps + P8) * hb + h] = acc_w[1][i];
    }
  }
  double db = 0.0;  // head fg's: its 4 lanes' sums, in lane order (set 0)
  for (int i = 0; i < 4; ++i) db += __shfl_sync(0xffffffffu, acc_b, (lane & ~3) + i);
  if (fk == 0 && fg < hb) red_w[P * hb + fg] = db;
  __syncthreads();
  double* out = ws_w + ((size_t)c * b + e) * (P + 1) * H;
  for (int i = tid; i < (P + 1) * hb; i += kBwdThreads) {
    const int p = i / hb, h = i - p * hb;
    // the warps that summed row p: the set of its pair (row P, db_pos: set 0)
    const int lp = p % P4, pr = p < P ? p / P4 * P8 + (lp < P8 ? lp : lp - P8) : 0;
    const int w0 = pr / 8 * set_warps;
    double sum = 0.0;
    for (int w = w0; w < w0 + set_warps; ++w) sum += red[(w * (P + 1) + p) * hb + h];
    out[p * H + h0 + h] = sum;
  }
}

// dW_pos and db_pos: the blocks' f64 sums [rows_w, cols] added down each
// column, in a fixed order (warp w takes rows w, w + 8, ...; the warps'
// sums in warp order), and rounded once. Blocks past `col_blocks` sum the
// chunks' partial dK and dVW in chunk order (several chunks per example).
__global__ void __launch_bounds__(kRedThreads) implicit_attention_bwd_reduce(
    const double* __restrict__ ws_w, int rows_w, int cols, int PH,
    float* __restrict__ dw_pos, float* __restrict__ db_pos,
    const float* __restrict__ ws_kv, int chunks, size_t kv, float scale,
    float* __restrict__ dk, float* __restrict__ dvw, int col_blocks) {
  constexpr int kRedWarps = kRedThreads / 32;
  if (blockIdx.x < col_blocks) {
    __shared__ double part[kRedWarps][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    double sum = 0.0;
    if (col < cols)
      for (int i = warp; i < rows_w; i += kRedWarps) sum += ws_w[(size_t)i * cols + col];
    part[warp][lane] = sum;
    __syncthreads();
    if (warp == 0 && col < cols) {
      double total = 0.0;
      for (int w = 0; w < kRedWarps; ++w) total += part[w][lane];
      const float v = __double2float_rn(total);
      if (col < PH) dw_pos[col] = v; else db_pos[col - PH] = v;
    }
    return;
  }
  const size_t stride = (size_t)(gridDim.x - col_blocks) * kRedThreads;
  for (size_t i = (size_t)(blockIdx.x - col_blocks) * kRedThreads + threadIdx.x; i < 2 * kv;
       i += stride) {
    const int kind = i >= kv;
    const size_t j = kind ? i - kv : i;
    const float* src = ws_kv + (size_t)kind * chunks * kv + j;
    float sum = 0.f;
    for (int ch = 0; ch < chunks; ++ch) sum += src[(size_t)ch * kv];
    if (kind) dvw[j] = sum; else dk[j] = scale * sum;
  }
}

using BwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, const float*, const uint8_t*, float, const float*,
                           const float*, float, float*, float*, float*, float*, double*, int,
                           int, int, int, int, int, int, int, int);

// The specialised instances of the backward, by (heads per block, keys,
// head width, embedding lanes): the one every configuration runs (16 heads
// of 64, nongt_dim 20, imp_pos_emb_dim 64, two groups of 8 heads). Every
// other shape the wrapper's backward_plan takes runs the general instance.
struct BwdInstance {
  int hb, n, dh, P;
  BwdKernel kernel;
};
const BwdInstance kBwdInstances[] = {
    {8, 20, 64, 64, implicit_attention_bwd_kernel<8, 20, 64, 64>},
};

BwdKernel bwd_specialised(int hb, int n, int dh, int P) {
  for (const BwdInstance& i : kBwdInstances)
    if (i.hb == hb && i.n == n && i.dh == dh && i.P == P) return i.kernel;
  return nullptr;
}

BwdKernel bwd_instance(int hb, int n, int dh, int P) {
  const BwdKernel kernel = bwd_specialised(hb, n, dh, P);
  return kernel ? kernel : implicit_attention_bwd_kernel<0, 0, 0, 0>;
}

}  // namespace

extern "C" {

// A launch's scalars, built once per shape by the wrapper (its `_Launch`):
// shapes, the key mask's row stride, query rows per block, shared memory,
// 1/sqrt(dh).
struct IaLaunch {
  int b, R, n, H, dh, o, P, sm, rows, smem;
  float scale;
};

// Shared memory one block needs, in bytes (the wrapper's tiling plan computes
// the same and checks it against this once).
size_t regat_implicit_attention_smem_bytes(int H, int dh, int n, int o, int P) {
  return sizeof(float) * (size_t)Layout(H, dh, n, o, P).total;
}

// Lets both variants use `smem` bytes of dynamic shared memory on the
// current device. Call once per device and size, before the first launch
// that needs more than 48 KB. Returns the CUDA error (0 = done).
int regat_implicit_attention_set_smem(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      implicit_attention_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      implicit_attention_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return (int)err;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = launched).
// `pwr` null: the eval variant; non-null: the train variant, which also
// writes `rowmax`. `b_pos` null: no pos-FC bias; `keep` null: no keep-mask.
int regat_implicit_attention_fwd(
    const float* q, const float* k, const float* vw, const float* pm, const float* w_pos,
    const float* b_pos, const uint8_t* key_mask, const float* freq, const uint8_t* keep,
    float inv_keep, float* out, float* pwr, float* rowmax, const IaLaunch* a, void* stream) {
  const dim3 grid((a->R + a->rows - 1) / a->rows, a->b);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pwr) {
    implicit_attention_kernel<true><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, pm, w_pos, b_pos, key_mask, freq, keep, inv_keep, a->scale, out, pwr,
        rowmax, a->R, a->n, a->H, a->dh, a->o, a->P, a->sm, a->rows);
  } else {
    implicit_attention_kernel<false><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, pm, w_pos, b_pos, key_mask, freq, keep, inv_keep, a->scale, out, nullptr,
        nullptr, a->R, a->n, a->H, a->dh, a->o, a->P, a->sm, a->rows);
  }
  return (int)cudaGetLastError();
}

// A backward launch's scalars, built once per shape by the wrapper (its
// `_BwdLaunch`): shapes, heads per block, query rows per block, row chunks
// per example, shared memory, 1/sqrt(dh).
struct IaBwdLaunch {
  int b, R, n, H, dh, P, hb, rows, chunks, smem;
  float scale;
};

// Shared memory one backward block needs, in bytes (the wrapper's
// backward_plan computes the same and checks it against this once).
size_t regat_implicit_attention_bwd_smem_bytes(int hb, int dh, int n, int P) {
  return sizeof(float) * (size_t)BwdLayout(hb, dh, n, P).total;
}

// 1 if (hb, n, dh, P) has a specialised instance, else 0 (the general
// instance runs it); the wrapper holds its list of instances to this at load.
int regat_implicit_attention_bwd_specialised(int hb, int n, int dh, int P) {
  return bwd_specialised(hb, n, dh, P) != nullptr;
}

// Lets the backward instance that runs (hb, n, dh, P) use `smem` bytes of
// dynamic shared memory on the current device. Returns the CUDA error (0 =
// done).
int regat_implicit_attention_bwd_set_smem(int hb, int n, int dh, int P, int smem) {
  return (int)cudaFuncSetAttribute(bwd_instance(hb, n, dh, P),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches the backward and its reduce on `stream`; returns the first
// cudaGetLastError() that is not 0, else 0. `keep` null: no keep-mask;
// `ws_kv` is read and written only with several chunks per example.
int regat_implicit_attention_bwd(
    const float* gy, const float* q, const float* k, const float* vw, const float* pm,
    const float* mrow, const float* freq, const uint8_t* keep, float inv_keep,
    const float* pwr, const float* rowmax, float* dq, float* dk, float* dvw, float* dw_pos,
    float* db_pos, float* ws_kv, double* ws_w, const IaBwdLaunch* a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const BwdKernel kernel = bwd_instance(a->hb, a->n, a->dh, a->P);
  const dim3 grid(a->H / a->hb * a->chunks, a->b);
  kernel<<<grid, kBwdThreads, a->smem, s>>>(
      gy, q, k, vw, pm, mrow, freq, keep, inv_keep, pwr, rowmax, a->scale, dq, dk, dvw, ws_kv,
      ws_w, a->b, a->R, a->H, a->rows, a->chunks, a->hb, a->n, a->dh, a->P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = (a->P + 1) * a->H, col_blocks = (cols + 31) / 32;
  const size_t kv = (size_t)a->b * a->n * a->H * a->dh;
  const size_t kv_need = (2 * kv + kRedThreads - 1) / kRedThreads;
  const int kv_blocks = a->chunks > 1 ? (int)(kv_need < 1024 ? kv_need : 1024) : 0;
  implicit_attention_bwd_reduce<<<col_blocks + kv_blocks, kRedThreads, 0, s>>>(
      ws_w, a->chunks * a->b, cols, a->P * a->H, dw_pos, db_pos, ws_kv, a->chunks, kv, a->scale,
      dk, dvw, col_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
