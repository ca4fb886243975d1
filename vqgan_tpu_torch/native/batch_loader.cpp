// Multi-threaded batch assembler for the latent cache.
//
// The port's copy of the JAX package's native/batch_loader.cpp: the code
// below this header is the same, byte for byte.
//
// The stage-2 hot loop consumes batches of fixed-size .npy latent payloads
// (vqgan_tpu_torch/data/latent_cache.py). This loader gathers a whole batch
// with a pool of pread() workers straight into one contiguous buffer,
// overlapping page-cache misses across items.
//
// Exposed as a minimal C ABI consumed via ctypes
// (vqgan_tpu_torch/data/native_loader.py). Thread count is capped; errors
// are reported per call.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Task {
  const char *path;
  int64_t offset;     // byte offset of payload within the file
  int64_t nbytes;     // payload size
  char *dst;          // destination in the batch buffer
};

int read_one(const Task &t) {
  int fd = ::open(t.path, O_RDONLY);
  if (fd < 0) return -errno;
  int64_t done = 0;
  while (done < t.nbytes) {
    ssize_t r = ::pread(fd, t.dst + done, t.nbytes - done, t.offset + done);
    if (r < 0) {
      int err = -errno;
      ::close(fd);
      return err;
    }
    if (r == 0) {  // truncated file
      ::close(fd);
      return -EIO;
    }
    done += r;
  }
  ::close(fd);
  return 0;
}

}  // namespace

extern "C" {

// Read n file segments into out (contiguous, n * nbytes). Returns 0 on
// success or the negative errno of the first failure.
int batch_read(const char **paths, const int64_t *offsets, int64_t nbytes,
               int n, char *out, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 4;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next{0};
  std::atomic<int> status{0};

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      Task t{paths[i], offsets[i], nbytes, out + int64_t(i) * nbytes};
      int rc = read_one(t);
      if (rc != 0) {
        int expected = 0;
        status.compare_exchange_strong(expected, rc);
        return;
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto &th : pool) th.join();
  return status.load();
}

// Version tag so the Python side can validate the ABI.
int batch_loader_abi_version() { return 1; }

}  // extern "C"
