// Dropout's forward and its backward, one pass each.
//
// Replaces no TPU kernel: the JAX package's nn.dropout is XLA elementwise code
// that XLA fuses into its neighbours. In PyTorch the same 8-bit scheme
// (tf_vqa_regat_tpu_torch/nn.py::dropout: a uint8 draw per element, kept where
// it is >= t, the kept scaled by 256 / (256 - t)) ran as a chain of separate
// kernels at every dropout site of a training step: the draw, `>= t`,
// `x * scale`, `zeros_like` and `where` forward, and autograd's `where`
// against 0 and `* scale` backward. Leaving the draw aside, that chain moves
// about 44 bytes per f32 element; the function needs 18. This kernel computes
//
//   out[i] = bits[i] >= t ? in[i] * scale : 0
//
// in one pass: on x in the forward, on the output's cotangent dy in the
// backward (dy * scale where kept, 0 where dropped, which is what
// where(keep, dy, 0) * scale gives), with the draw saved as uint8 between
// them. f32: one rounding of the product (__fmul_rn, never contracted). bf16:
// the scale arrives already rounded to bf16 by the wrapper, the product is
// taken in f32 and rounded to bf16 once, as PyTorch's bf16 `x * scale` does.
// A dropped element is +0. So the bits equal the chain's.
//
// What bounds it on an H100: nothing but memory. Per element it reads the
// input (4 B in f32, 2 in bf16) and one byte of bits and writes the output:
// 9 B in f32, 5 in bf16, at 3.35 TB/s. At the model's largest site
// ([256, 100, 2304] f32, BAN's v_) that is 531 MB, 0.159 ms; the sites of a
// butd step, ~187 M elements, take ~0.50 ms each way at the bound.
//
// Design. Every thread moves 16-byte vectors (4 f32 or 8 bf16 values) with
// the vector's bits as one 4- or 8-byte load, so a warp's loads and stores are
// whole 128-byte lines. A grid-stride loop over a grid of a few waves of the
// 132 SMs takes kUnroll vectors a thread per pass, all loaded before any is
// stored, so that enough bytes are in flight to cover HBM's latency. The
// tensors (26-236 MB) are larger than the 50 MB L2 and each byte is touched
// once, so loads and stores are streaming (evict-first: ld.global.cs,
// st.global.cs) and leave the L2 to the GEMMs around the dropout.
// The input and the bits are rows: `rows` of `inner` contiguous elements,
// one row stride each, so the views on the main path run without a copy (the
// key projection's input roi[:, :n], the label drop's slice of its roi axis,
// a tensor-parallel rank's slice of the bits); the wrapper copies any other
// layout first. The output is contiguous, the layout the chain's `where`
// gives. Where a row is a whole number of vectors and both row strides and
// pointers keep them aligned, a launch is vectorised; otherwise it runs one
// element a thread through the same loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// the grid: at most kWaves waves of kBlocksPerSm blocks on each of the SMs
constexpr int kSms = 132;
constexpr int kBlocksPerSm = 8;
constexpr int kWaves = 4;

// 16 bytes of the input's type, and their bits.
template <typename T>
struct Vector;
template <>
struct Vector<float> {
  static constexpr int kElems = 4;
  using Data = float4;
  using Bits = unsigned int;
};
template <>
struct Vector<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using Data = uint4;
  using Bits = uint2;
};

__device__ __forceinline__ float drop(float x, unsigned int bits, unsigned int t,
                                      float scale) {
  return bits >= t ? __fmul_rn(x, scale) : 0.0f;
}

__device__ __forceinline__ __nv_bfloat16 drop(__nv_bfloat16 x, unsigned int bits,
                                              unsigned int t, float scale) {
  return bits >= t ? __float2bfloat16_rn(__fmul_rn(__bfloat162float(x), scale))
                   : __float2bfloat16_rn(0.0f);
}

// Unit u (a vector, or one element without VEC) is element j of row r, with
// `per_row` units a row; the output is contiguous, so its offset is u's.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, const uint8_t* __restrict__ bits,
                   T* __restrict__ out, unsigned int units, unsigned int per_row,
                   long long x_row, long long bits_row, unsigned int t, float scale) {
  constexpr int kElems = VEC ? Vector<T>::kElems : 1;
  using Data = typename std::conditional<VEC, typename Vector<T>::Data, T>::type;
  using Bits = typename std::conditional<VEC, typename Vector<T>::Bits, uint8_t>::type;
  const unsigned int stride = gridDim.x * kThreads;
  for (unsigned int base = blockIdx.x * kThreads + threadIdx.x; base < units;
       base += kUnroll * stride) {
    Data xv[kUnroll];
    Bits bv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned int u = base + k * stride;
      if (u < units) {
        const unsigned int r = u / per_row;
        const long long j = static_cast<long long>(u - r * per_row) * kElems;
        xv[k] = __ldcs(reinterpret_cast<const Data*>(x + r * x_row + j));
        bv[k] = __ldcs(reinterpret_cast<const Bits*>(bits + r * bits_row + j));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned int u = base + k * stride;
      if (u < units) {
        Data o;
        if constexpr (VEC) {
          const T* in = reinterpret_cast<const T*>(&xv[k]);
          const uint8_t* b = reinterpret_cast<const uint8_t*>(&bv[k]);
          T* r = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int e = 0; e < kElems; ++e) r[e] = drop(in[e], b[e], t, scale);
        } else {
          o = drop(xv[k], bv[k], t, scale);
        }
        __stcs(reinterpret_cast<Data*>(out) + u, o);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* bits, void* out, long long rows, long long inner,
           long long x_row, long long bits_row, int t, float scale, cudaStream_t stream) {
  if (x_row == inner && bits_row == inner) {  // both contiguous: one row
    inner *= rows;
    rows = 1;
  }
  constexpr int kElems = Vector<T>::kElems;
  const bool vec = inner % kElems == 0 && x_row % kElems == 0 && bits_row % kElems == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bits) % kElems == 0;
  const long long per_row = vec ? inner / kElems : inner;
  const long long units = rows * per_row;
  const long long blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int grid = static_cast<int>(blocks < kSms * kBlocksPerSm * kWaves
                                        ? blocks : kSms * kBlocksPerSm * kWaves);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* bp = static_cast<const uint8_t*>(bits);
  T* op = static_cast<T*>(out);
  if (vec)
    dropout_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xp, bp, op, static_cast<unsigned int>(units), static_cast<unsigned int>(per_row),
        x_row, bits_row, static_cast<unsigned int>(t), scale);
  else
    dropout_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xp, bp, op, static_cast<unsigned int>(units), static_cast<unsigned int>(per_row),
        x_row, bits_row, static_cast<unsigned int>(t), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = bits >= t ? x * scale : 0 over `rows` rows of `inner` contiguous
// elements (x's rows `x_row` elements apart, the bits' `bits_row` bytes; out
// contiguous), dtype 0: f32, 1: bf16, fewer than 2**31 elements, on
// `stream`. Returns the launch's CUDA error (0: none).
int regat_dropout(const void* x, const void* bits, void* out, long long rows,
                  long long inner, long long x_row, long long bits_row, int dtype, int t,
                  float scale, cudaStream_t stream) {
  if (rows < 1 || inner < 1 || rows * inner >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, bits, out, rows, inner, x_row, bits_row, t, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bits, out, rows, inner, x_row, bits_row, t, scale,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
