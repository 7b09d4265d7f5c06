// Row-parallel loops of the host helpers (resample.cc, getocc.cc):
// what `#pragma omp parallel for schedule(static)` does in the JAX
// package's copies, on std::thread, since runtime/host_build.py compiles
// without OpenMP.

#pragma once

#include <algorithm>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

// body(begin, end) over rows [0, n) in `threads` contiguous chunks, as
// OpenMP's schedule(static) without a chunk size assigns them: the first
// n % threads threads take one row more. Chunk 0 runs on the calling
// thread; a chunk whose thread cannot be started runs there too.
template <class Body>
void parallel_rows(int64_t n, int64_t threads, const Body& body) {
  threads = std::max<int64_t>(std::min(threads, n), 1);
  const int64_t q = n / threads, r = n % threads;
  auto begin = [q, r](int64_t t) { return t * q + std::min(t, r); };
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (int64_t t = 1; t < threads; ++t) {
    try {
      pool.emplace_back(body, begin(t), begin(t + 1));
    } catch (const std::system_error&) {
      body(begin(t), begin(t + 1));
    }
  }
  body(begin(0), begin(1));
  for (auto& th : pool) th.join();
}
