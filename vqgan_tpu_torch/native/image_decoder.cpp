// Multi-threaded JPEG decode + resize + center-crop batch assembler.
//
// The port's copy of the JAX package's native/image_decoder.cpp: the code
// below this header is the same, byte for byte, so both packages decode to
// the same bits (tests/test_torch_port_data_native.py holds them to it).
//
// The PIL path (vqgan_tpu_torch/data/datasets.py:load_image, the
// reference's torchvision Resize+CenterCrop+ToTensor) decodes one image at
// a time under the GIL. This decoder fans a batch out over a thread pool:
// libjpeg decompress -> PIL-equivalent triangle-filter resample of the
// shorter side to `image_size` -> center crop -> float32 [0,1] NHWC
// straight into one contiguous batch buffer. The pipeline_* entry points
// keep a ring of `depth` such batches decoded ahead by worker threads.
//
// The resampler replicates PIL's convolution resampling (triangle/bilinear
// kernel whose support scales with the downscale factor, weights
// normalized), so outputs match the PIL path within quantization noise.
//
// C ABI via ctypes (vqgan_tpu_torch/data/native_image.py), built by g++ at
// first use (vqgan_tpu_torch/data/native_build.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <numeric>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr *err = reinterpret_cast<ErrMgr *>(cinfo->err);
  longjmp(err->jump, 1);
}

// PIL-style triangle-filter coefficient table for one axis: for each output
// index, the first input tap and its normalized weights. Computed ONCE per
// (len_in, len_out) and reused across every row and channel — the per-pixel
// work in the passes below is then a pure multiply-accumulate.
struct Filter {
  std::vector<int> lo;      // [len_out] first input tap
  std::vector<int> taps;    // [len_out] tap count
  std::vector<float> w;     // [len_out * max_taps] normalized weights
  int max_taps = 0;
};

Filter make_filter(int len_in, int len_out) {
  Filter f;
  const double scale = double(len_in) / double(len_out);
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // triangle kernel support
  f.lo.resize(len_out);
  f.taps.resize(len_out);
  f.max_taps = int(std::ceil(2 * support)) + 2;
  f.w.assign(size_t(len_out) * f.max_taps, 0.0f);
  for (int o = 0; o < len_out; ++o) {
    const double center = (o + 0.5) * scale - 0.5;
    int lo = std::max(int(std::ceil(center - support)), 0);
    int hi = std::min(int(std::floor(center + support)), len_in - 1);
    f.lo[o] = lo;
    f.taps[o] = hi - lo + 1;
    double wsum = 0.0;
    for (int i = lo; i <= hi; ++i) {
      double x = std::fabs((i - center) / filterscale);
      wsum += x < 1.0 ? 1.0 - x : 0.0;
    }
    for (int i = lo; i <= hi; ++i) {
      double x = std::fabs((i - center) / filterscale);
      double wv = x < 1.0 ? 1.0 - x : 0.0;
      f.w[size_t(o) * f.max_taps + (i - lo)] =
          wsum > 0 ? float(wv / wsum) : (i == lo ? 1.0f : 0.0f);
    }
  }
  return f;
}

// Decode one JPEG file into a [S, S, 3] float32 [0,1] crop at dst.
int decode_one(const char *path, int image_size, float *dst) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;

  // Every automatic object with a non-trivial destructor is constructed
  // BEFORE setjmp: a longjmp back into this frame then returns through the
  // error branch, which destroys them normally on function exit. Declaring
  // them after setjmp would make the longjmp skip their initialization —
  // UB, and in practice a leak per corrupt JPEG.
  std::vector<unsigned char> row;
  std::vector<float> tmp;
  Filter fx, fy;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;  // corrupt / non-JPEG
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK → RGB in-library
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width, h = cinfo.output_height;
  const int ch = cinfo.output_components;  // 3 after JCS_RGB

  // shorter-side scale, floors clamped to image_size (load_image:60-64)
  const int S = image_size;
  const double scale = double(S) / std::min(w, h);
  const int rw = std::max(S, int(std::lround(w * scale)));
  const int rh = std::max(S, int(std::lround(h * scale)));
  fx = make_filter(w, rw);
  fy = make_filter(h, rh);

  // horizontal pass fused with scanline decode: uint8 row → float [rw*3]
  row.resize(size_t(w) * ch);
  unsigned char *rowp = row.data();
  tmp.resize(size_t(h) * rw * 3);
  constexpr float k1_255 = 1.0f / 255.0f;
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float *out_row = tmp.data() + size_t(y) * rw * 3;
    for (int o = 0; o < rw; ++o) {
      const float *wp = fx.w.data() + size_t(o) * fx.max_taps;
      const unsigned char *ip = row.data() + size_t(fx.lo[o]) * ch;
      float r = 0, g = 0, b = 0;
      if (ch == 3) {
        for (int t = 0; t < fx.taps[o]; ++t, ip += 3) {
          const float wv = wp[t];
          r += wv * ip[0];
          g += wv * ip[1];
          b += wv * ip[2];
        }
      } else {
        for (int t = 0; t < fx.taps[o]; ++t, ip += ch) r += wp[t] * ip[0];
        g = b = r;
      }
      out_row[o * 3 + 0] = r * k1_255;
      out_row[o * 3 + 1] = g * k1_255;
      out_row[o * 3 + 2] = b * k1_255;
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  // vertical pass fused with the center crop: each OUTPUT row is a weighted
  // sum of contiguous tmp rows (row-wise AXPY — vectorizes; no strided
  // column walks), and only the S cropped rows are ever computed
  const int left = (rw - S) / 2, top = (rh - S) / 2;
  const int row_f = S * 3;
  for (int oy = 0; oy < S; ++oy) {
    float *out_row = dst + size_t(oy) * row_f;
    std::memset(out_row, 0, size_t(row_f) * sizeof(float));
    const int o = oy + top;
    const float *wp = fy.w.data() + size_t(o) * fy.max_taps;
    for (int t = 0; t < fy.taps[o]; ++t) {
      const float wv = wp[t];
      const float *in_row =
          tmp.data() + (size_t(fy.lo[o] + t) * rw + left) * 3;
      for (int x = 0; x < row_f; ++x) out_row[x] += wv * in_row[x];
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode n JPEGs into out [n, image_size, image_size, 3] float32 [0,1].
// Returns 0 on success or the first failure's code (-1 open, -2 decode).
int decode_jpeg_batch(const char **paths, int n, int image_size, float *out,
                      int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 4;
  n_threads = std::min(n_threads, n);

  std::atomic<int> next{0};
  std::atomic<int> status{0};
  const size_t item = size_t(image_size) * image_size * 3;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      int rc = decode_one(paths[i], image_size, out + item * i);
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

}  // extern "C"

// ---------------------------------------------------------------------------
// Async batch pipeline: N producer threads decode whole batches ahead of the
// consumer into a ring of `depth` slots; pipeline_next() blocks only when
// the ring is empty. Deterministic batch order (sequence numbers), per-epoch
// seeded reshuffle, drop-last semantics. The native counterpart of
// data/prefetch.py's host stage: decode keeps running while the TPU step
// executes, without the GIL in the picture.

namespace {

struct Pipeline {
  std::vector<std::string> paths;
  int image_size, batch, depth;
  bool shuffle;
  uint64_t seed;
  size_t batches_per_epoch;

  std::vector<float> ring;            // depth * batch * S * S * 3
  std::vector<int> ring_idx;          // depth * batch dataset indices
  std::vector<long> slot_seq;         // sequence number held by each slot
  std::vector<uint8_t> slot_ready;    // slot has a decoded batch
  std::atomic<long> next_seq{0};      // next sequence a worker claims
  long consumed = 0;                  // next sequence the consumer takes
  std::atomic<int> error{0};
  bool stopping = false;

  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::map<long, std::vector<int>> epoch_order;  // epoch -> permutation
  std::vector<std::thread> workers;

  size_t item_floats() const {
    return size_t(image_size) * image_size * 3;
  }

  const std::vector<int> &order_for(long epoch) {
    // caller holds mu
    auto it = epoch_order.find(epoch);
    if (it != epoch_order.end()) return it->second;
    std::vector<int> order(paths.size());
    std::iota(order.begin(), order.end(), 0);
    if (shuffle) {
      std::mt19937_64 rng(seed + uint64_t(epoch) * 0x9E3779B97F4A7C15ull);
      std::shuffle(order.begin(), order.end(), rng);
    }
    while (epoch_order.size() > 2) epoch_order.erase(epoch_order.begin());
    return epoch_order.emplace(epoch, std::move(order)).first->second;
  }

  void worker() {
    const size_t bf = item_floats() * batch;
    while (true) {
      long seq = next_seq.fetch_add(1);
      std::vector<std::string> batch_paths(batch);
      std::vector<int> batch_idx(batch);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_producer.wait(lk, [&] {
          return stopping || error.load() || seq < consumed + depth;
        });
        if (stopping || error.load()) return;
        const long epoch = seq / long(batches_per_epoch);
        const long b = seq % long(batches_per_epoch);
        const std::vector<int> &order = order_for(epoch);
        for (int i = 0; i < batch; ++i) {
          batch_idx[i] = order[size_t(b) * batch + i];
          batch_paths[i] = paths[batch_idx[i]];
        }
      }
      float *dst = ring.data() + size_t(seq % depth) * bf;
      for (int i = 0; i < batch; ++i) {
        int rc = decode_one(batch_paths[i].c_str(), image_size,
                            dst + item_floats() * i);
        if (rc != 0) {
          int expected = 0;
          error.compare_exchange_strong(expected, rc);
          cv_consumer.notify_all();
          cv_producer.notify_all();
          return;
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        std::copy(batch_idx.begin(), batch_idx.end(),
                  ring_idx.begin() + size_t(seq % depth) * batch);
        slot_seq[seq % depth] = seq;
        slot_ready[seq % depth] = 1;
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Build a pipeline over n paths. Requires n >= batch; the last n % batch
// items of each epoch are dropped (training semantics). Returns NULL on
// invalid arguments.
void *pipeline_create(const char **paths, int n, int image_size, int batch,
                      int n_threads, int depth, uint64_t seed, int shuffle) {
  if (n < batch || batch <= 0 || image_size <= 0) return nullptr;
  if (depth < 2) depth = 2;
  if (n_threads <= 0) n_threads = 2;
  auto *p = new Pipeline();
  p->paths.assign(paths, paths + n);
  p->image_size = image_size;
  p->batch = batch;
  p->depth = depth;
  p->shuffle = shuffle != 0;
  p->seed = seed;
  p->batches_per_epoch = size_t(n) / batch;
  p->ring.resize(size_t(depth) * batch * p->item_floats());
  p->ring_idx.assign(size_t(depth) * batch, -1);
  p->slot_seq.assign(depth, -1);
  p->slot_ready.assign(depth, 0);
  const int workers = std::min<int>(n_threads, depth);
  p->workers.reserve(workers);
  for (int i = 0; i < workers; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Copy the next batch into out [batch, S, S, 3] float32 (and, when idx_out
// is non-NULL, the batch's dataset indices into idx_out [batch] — the
// caller's key to labels/metadata). Returns the batch's global sequence
// number (>= 0), or a negative decode error code.
long pipeline_next(void *handle, float *out, int *idx_out) {
  auto *p = static_cast<Pipeline *>(handle);
  const size_t bf = p->item_floats() * p->batch;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_consumer.wait(lk, [&] {
    return p->error.load() ||
           (p->slot_ready[p->consumed % p->depth] &&
            p->slot_seq[p->consumed % p->depth] == p->consumed);
  });
  if (p->error.load()) return -long(std::abs(p->error.load())) - 100;
  const long seq = p->consumed;
  std::memcpy(out, p->ring.data() + size_t(seq % p->depth) * bf,
              bf * sizeof(float));
  if (idx_out)
    std::memcpy(idx_out, p->ring_idx.data() + size_t(seq % p->depth) * p->batch,
                size_t(p->batch) * sizeof(int));
  p->slot_ready[seq % p->depth] = 0;
  p->consumed = seq + 1;
  lk.unlock();
  p->cv_producer.notify_all();
  return seq;
}

void pipeline_destroy(void *handle) {
  auto *p = static_cast<Pipeline *>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
  p->cv_producer.notify_all();
  p->cv_consumer.notify_all();
  for (auto &t : p->workers) t.join();
  delete p;
}

int image_decoder_abi_version() { return 3; }

}  // extern "C"
