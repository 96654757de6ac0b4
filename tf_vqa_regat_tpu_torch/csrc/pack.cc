// Threaded row gather for host-side batch packing (data/loader.py), a copy
// of the JAX package's native/pack.cc.
//
// The numpy fancy-index gather that assembles a [B*R, row] feature batch
// holds the interpreter lock and runs on one thread; this is a plain
// parallel memcpy over row indices. Byte-generic: f32, bf16 (as 16-bit
// words) and int8 tables alike.
//
// Built at first use by data/native.py (g++ -O3 -shared); a failed build
// raises there. The caller checks every row against the table and `out`'s
// size before the call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// out[i] = tab[rows[i]] for rows[i] >= 0, else zeros. row_bytes per row.
void regat_gather_rows(const char* tab, const int64_t* rows, char* out,
                       int64_t n, int64_t row_bytes, int n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      char* dst = out + i * row_bytes;
      int64_t r = rows[i];
      if (r < 0) {
        std::memset(dst, 0, row_bytes);
      } else {
        std::memcpy(dst, tab + r * row_bytes, row_bytes);
      }
    }
  };
  if (n_threads <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
