// Multi-threaded prefetching corpus loader.
//
// TPU-native equivalent of the reference's data path: the shell loop over
// raw files (data/Makefile.in:125-241, raw2wav + x2x pipes) and the
// thread-pool runner (data/scripts/parallel.py:17-56).  A worker pool
// reads + decodes utterance files into float64 buffers while the device
// computes; Python pops completed items through ctypes (io/loader.py).
//
// Formats:
//   mode 0: headerless little-endian int16 "raw" (HTS raw/*.raw) -> /32768
//   mode 1: RIFF PCM wav, 16/32-bit int or float32 -> audioio scaling
//           (sample / 2^(nbit-1); test/audioio.cpp read convention)
//   mode 2: headerless little-endian float32 (lf0/mgc/bap/cmp streams)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Item {
  long index;
  std::vector<double> data;
  int sample_rate;   // wav only; 0 otherwise
  bool error;
};

struct Loader {
  std::vector<std::string> paths;
  int mode;
  size_t queue_cap;
  std::atomic<long> next_file{0};
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Item> queue;
  long produced = 0;   // items pushed (including errors)
  bool closing = false;
  std::vector<std::thread> workers;
};

bool read_file(const std::string &path, std::vector<uint8_t> &buf) {
  FILE *f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) { std::fclose(f); return false; }
  buf.resize(n);
  bool ok = n == 0 || std::fread(buf.data(), 1, n, f) == (size_t)n;
  std::fclose(f);
  return ok;
}

uint32_t rd32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd16(const uint8_t *p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

bool decode_wav(const std::vector<uint8_t> &b, std::vector<double> &out,
                int *sample_rate) {
  if (b.size() < 44 || std::memcmp(b.data(), "RIFF", 4) ||
      std::memcmp(b.data() + 8, "WAVE", 4))
    return false;
  size_t pos = 12;
  int fmt = 0, bits = 0, channels = 0;
  const uint8_t *data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= b.size()) {
    uint32_t sz = rd32(b.data() + pos + 4);
    const uint8_t *body = b.data() + pos + 8;
    if (pos + 8 + sz > b.size()) sz = (uint32_t)(b.size() - pos - 8);
    if (!std::memcmp(b.data() + pos, "fmt ", 4) && sz >= 16) {
      fmt = rd16(body);
      channels = rd16(body + 2);
      *sample_rate = (int)rd32(body + 4);
      bits = rd16(body + 14);
    } else if (!std::memcmp(b.data() + pos, "data", 4)) {
      data = body;
      data_len = sz;
    }
    pos += 8 + sz + (sz & 1);
  }
  if (!data || channels < 1) return false;
  size_t bytes = bits / 8;
  if (!bytes) return false;
  size_t frames = data_len / (bytes * channels);
  out.resize(frames);
  for (size_t i = 0; i < frames; i++) {
    const uint8_t *p = data + i * bytes * channels;  // channel 0
    if (fmt == 1 && bits == 16) {
      out[i] = (double)(int16_t)rd16(p) / 32768.0;
    } else if (fmt == 1 && bits == 32) {
      out[i] = (double)(int32_t)rd32(p) / 2147483648.0;
    } else if (fmt == 3 && bits == 32) {
      float v;
      std::memcpy(&v, p, 4);
      out[i] = v;
    } else {
      return false;
    }
  }
  return true;
}

void worker(Loader *L) {
  for (;;) {
    long i = L->next_file.fetch_add(1);
    if (i >= (long)L->paths.size()) return;
    Item it;
    it.index = i;
    it.sample_rate = 0;
    it.error = true;
    std::vector<uint8_t> buf;
    if (read_file(L->paths[i], buf)) {
      if (L->mode == 0) {
        size_t n = buf.size() / 2;
        it.data.resize(n);
        for (size_t k = 0; k < n; k++)
          it.data[k] = (double)(int16_t)rd16(buf.data() + 2 * k) / 32768.0;
        it.error = false;
      } else if (L->mode == 1) {
        it.error = !decode_wav(buf, it.data, &it.sample_rate);
      } else if (L->mode == 2) {
        size_t n = buf.size() / 4;
        it.data.resize(n);
        for (size_t k = 0; k < n; k++) {
          float v;
          std::memcpy(&v, buf.data() + 4 * k, 4);
          it.data[k] = v;
        }
        it.error = false;
      }
    }
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [L] {
      return L->queue.size() < L->queue_cap || L->closing;
    });
    if (L->closing) return;
    L->queue.push_back(std::move(it));
    L->produced++;
    L->cv_pop.notify_one();
  }
}

}  // namespace

extern "C" {

void *dl_open(const char **paths, long n, int mode, int n_threads,
              int queue_cap) {
  Loader *L = new Loader();
  L->paths.assign(paths, paths + n);
  L->mode = mode;
  L->queue_cap = queue_cap > 0 ? queue_cap : 8;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > (int)n && n > 0) nt = (int)n;
  for (int t = 0; t < nt; t++) L->workers.emplace_back(worker, L);
  return L;
}

// Peek the next completed item's length (samples).  Returns length >= 0,
// -1 when the corpus is exhausted, -2 if the next item failed to decode
// (pop it with dl_skip).  Blocks until an item is available.
long dl_peek(void *h, long *index, int *sample_rate) {
  Loader *L = (Loader *)h;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [L] {
    return !L->queue.empty() || L->produced == (long)L->paths.size();
  });
  if (L->queue.empty()) return -1;
  const Item &it = L->queue.front();
  *index = it.index;
  *sample_rate = it.sample_rate;
  return it.error ? -2 : (long)it.data.size();
}

// Copy the next item into out (cap doubles) and pop it.
long dl_next(void *h, double *out, long cap) {
  Loader *L = (Loader *)h;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->queue.empty()) return -1;
  Item it = std::move(L->queue.front());
  L->queue.pop_front();
  L->cv_push.notify_one();
  lk.unlock();
  long n = (long)it.data.size();
  if (n > cap) n = cap;
  std::memcpy(out, it.data.data(), n * sizeof(double));
  return n;
}

void dl_skip(void *h) {
  Loader *L = (Loader *)h;
  std::unique_lock<std::mutex> lk(L->mu);
  if (!L->queue.empty()) {
    L->queue.pop_front();
    L->cv_push.notify_one();
  }
}

void dl_close(void *h) {
  Loader *L = (Loader *)h;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->closing = true;
    L->cv_push.notify_all();
  }
  L->next_file.store((long)L->paths.size());
  for (auto &t : L->workers) t.join();
  delete L;
}

}  // extern "C"
