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
// `pwr` null: the eval variant; non-null: the train variant. `b_pos` null:
// no pos-FC bias; `keep` null: no keep-mask.
int regat_implicit_attention_fwd(
    const float* q, const float* k, const float* vw, const float* pm, const float* w_pos,
    const float* b_pos, const uint8_t* key_mask, const float* freq, const uint8_t* keep,
    float inv_keep, float* out, float* pwr, const IaLaunch* a, void* stream) {
  const dim3 grid((a->R + a->rows - 1) / a->rows, a->b);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pwr) {
    implicit_attention_kernel<true><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, pm, w_pos, b_pos, key_mask, freq, keep, inv_keep, a->scale, out, pwr,
        a->R, a->n, a->H, a->dh, a->o, a->P, a->sm, a->rows);
  } else {
    implicit_attention_kernel<false><<<grid, kThreads, a->smem, s>>>(
        q, k, vw, pm, w_pos, b_pos, key_mask, freq, keep, inv_keep, a->scale, out, nullptr,
        a->R, a->n, a->H, a->dh, a->o, a->P, a->sm, a->rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
