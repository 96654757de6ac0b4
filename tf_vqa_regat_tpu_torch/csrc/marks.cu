// Phase marks of a train step: one empty kernel per mark, launched <<<1, 1>>>
// on the caller's stream (train/profiling.py::mark).
//
// A mark is a kernel, not a host range, because a train step is one CUDA graph
// replay: a host range inside the step runs once, at capture, and never at a
// replay, while a kernel launched during the capture becomes a node of the
// graph and runs at every replay. The profiler records it on the device's
// clock beside every other kernel, so the device work between two marks is
// the work of the phase the first one opens. The names are unmangled
// (extern "C") and fixed: the benchmark's readers find them by name.
//
// Cost: one node per mark (no memory, no arguments), about 1.5-3 us of device
// timeline each.

#include <cuda_runtime.h>

extern "C" {

__global__ void regat_mark_gather() {}
__global__ void regat_mark_forward() {}
__global__ void regat_mark_backward() {}
__global__ void regat_mark_reduce() {}
__global__ void regat_mark_optimizer() {}
__global__ void regat_mark_end() {}
__global__ void regat_mark_b1_backward_begin() {}
__global__ void regat_mark_b1_backward_end() {}
__global__ void regat_mark_b2_backward_begin() {}
__global__ void regat_mark_b2_backward_end() {}

}  // extern "C"

namespace {

// In the order of train/profiling.py's MARKS, which checks it at load.
const char* const kNames[] = {
    "gather", "forward", "backward", "reduce", "optimizer", "end",
    "b1_backward_begin", "b1_backward_end", "b2_backward_begin", "b2_backward_end",
};
constexpr int kCount = sizeof(kNames) / sizeof(kNames[0]);

}  // namespace

extern "C" {

int regat_mark_count() { return kCount; }

// Mark i's name without the `regat_mark_` prefix, or null outside [0, count).
const char* regat_mark_name(int i) { return i >= 0 && i < kCount ? kNames[i] : nullptr; }

// Launches mark i on `stream` and returns cudaGetLastError() (0 = launched).
int regat_mark(int i, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (i) {
    case 0: regat_mark_gather<<<1, 1, 0, s>>>(); break;
    case 1: regat_mark_forward<<<1, 1, 0, s>>>(); break;
    case 2: regat_mark_backward<<<1, 1, 0, s>>>(); break;
    case 3: regat_mark_reduce<<<1, 1, 0, s>>>(); break;
    case 4: regat_mark_optimizer<<<1, 1, 0, s>>>(); break;
    case 5: regat_mark_end<<<1, 1, 0, s>>>(); break;
    case 6: regat_mark_b1_backward_begin<<<1, 1, 0, s>>>(); break;
    case 7: regat_mark_b1_backward_end<<<1, 1, 0, s>>>(); break;
    case 8: regat_mark_b2_backward_begin<<<1, 1, 0, s>>>(); break;
    case 9: regat_mark_b2_backward_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
