// sepio — multithreaded seismogram binary I/O for sep2023_tpu.
//
// Counterpart of the reference's native data plane: the CUDA
// build streams per-shot float32 binaries (Shot_{pr,vx,vz,ett}<id>.bin)
// between disk and pinned host buffers inside its C++ layer
// (fileBinLoad/fileBinWrite, utilities.cu:10-31; pinned cubes,
// Src_Rec.cu:204-259). Here the device side is JAX/XLA; the native layer's
// job is keeping the host side off the Python hot path: a thread pool
// reads/writes all shots and channels concurrently into one contiguous
// (S, 4, nrec, nt) buffer that NumPy wraps zero-copy.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

const char* kChannels[4] = {"pr", "vx", "vz", "ett"};

std::string shot_path(const char* dir, int channel, int64_t shot_id) {
  char buf[4096];
  std::snprintf(buf, sizeof(buf), "%s/Shot_%s%lld.bin", dir,
                kChannels[channel], static_cast<long long>(shot_id));
  return std::string(buf);
}

int run_pool(int64_t n_tasks, int n_threads,
             const std::function<int(int64_t)>& task) {
  std::atomic<int64_t> next(0);
  std::atomic<int> status(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_tasks || status.load() != 0) return;
      int rc = task(i);
      if (rc != 0) status.store(rc);
    }
  };
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > n_tasks) nt = static_cast<int>(n_tasks);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return status.load();
}

}  // namespace

extern "C" {

// Read n_shots x 4 channel files into out (n_shots * 4 * nrec * nt floats).
// Returns 0 on success, 1 on open failure, 2 on short read.
int sepio_read_shots(const char* dir, const int64_t* shot_ids,
                     int64_t n_shots, int64_t nrec, int64_t nt, float* out,
                     int n_threads) {
  const int64_t trace = nrec * nt;
  return run_pool(n_shots * 4, n_threads, [&](int64_t idx) -> int {
    int64_t s = idx / 4;
    int c = static_cast<int>(idx % 4);
    std::string path = shot_path(dir, c, shot_ids[s]);
    FILE* fp = std::fopen(path.c_str(), "rb");
    if (!fp) return 1;
    float* dst = out + (s * 4 + c) * trace;
    size_t got = std::fread(dst, sizeof(float), trace, fp);
    std::fclose(fp);
    return got == static_cast<size_t>(trace) ? 0 : 2;
  });
}

// Write n_shots x 4 channel files from data (n_shots * 4 * nrec * nt floats).
int sepio_write_shots(const char* dir, const int64_t* shot_ids,
                      int64_t n_shots, int64_t nrec, int64_t nt,
                      const float* data, int n_threads) {
  const int64_t trace = nrec * nt;
  return run_pool(n_shots * 4, n_threads, [&](int64_t idx) -> int {
    int64_t s = idx / 4;
    int c = static_cast<int>(idx % 4);
    std::string path = shot_path(dir, c, shot_ids[s]);
    FILE* fp = std::fopen(path.c_str(), "wb");
    if (!fp) return 1;
    const float* src = data + (s * 4 + c) * trace;
    size_t put = std::fwrite(src, sizeof(float), trace, fp);
    std::fclose(fp);
    return put == static_cast<size_t>(trace) ? 0 : 2;
  });
}

int sepio_version() { return 1; }

}  // extern "C"
