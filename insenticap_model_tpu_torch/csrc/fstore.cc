// fstore — batched record gather from a native feature store (.isc).
//
// The port's copy of the repo's native/fstore.cc gather, with the port's
// host-library interface (ops/_build.load_host): every entry point
// returns an int, so the store's handle comes back through an out
// argument. A gather of N records fans out over pread() threads into one
// contiguous output buffer; ctypes releases the GIL for the call. fp16
// records are widened to fp32 in the worker threads (subnormals, +-inf,
// NaN payloads and -0 kept bit for bit), so Python sees ready-to-device
// float32.
//
// C interface (utils/native.py):
//   fstore_open(path, data_off, rec_bytes, &handle)           -> 0 | -1
//   fstore_gather(handle, idx[], n, out, widen_f16, threads)   -> 0 | -1
//   fstore_close(handle)                                       -> 0
#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Store {
  int fd = -1;
  uint64_t data_off = 0;
  uint64_t rec_bytes = 0;
  ~Store() {
    if (fd >= 0) close(fd);
  }
};

// shared_ptr registry: a gather holds a reference for the length of the
// call, so a concurrent fstore_close (which only drops the registry slot)
// cannot free the Store or close the fd under an in-flight pread
std::mutex g_mu;
std::vector<std::shared_ptr<Store>> g_stores;

inline void WidenF16(const uint16_t* in, float* out, size_t n) {
  for (size_t i = 0; i < n; i++) {
    uint16_t h = in[i];
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
      if (man == 0) {
        bits = sign;
      } else {  // subnormal
        int shift = 0;
        while (!(man & 0x400)) { man <<= 1; shift++; }
        man &= 0x3FF;
        bits = sign | ((127 - 14 - shift) << 23) | (man << 13);
      }
    } else if (exp == 31) {
      bits = sign | 0x7F800000u | (man << 13);
    } else {
      bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    memcpy(&out[i], &bits, 4);
  }
}

bool ReadFull(int fd, void* buf, size_t n, uint64_t off) {
  char* p = (char*)buf;
  while (n > 0) {
    ssize_t r = pread(fd, p, n, (off_t)off);
    if (r < 0 && errno == EINTR) continue;  // transient: retry
    if (r <= 0) return false;
    p += r;
    off += (uint64_t)r;
    n -= (size_t)r;
  }
  return true;
}

}  // namespace

extern "C" {

int fstore_open(const char* path, uint64_t data_off, uint64_t rec_bytes,
                int64_t* handle) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  auto s = std::make_shared<Store>();
  s->fd = fd;
  s->data_off = data_off;
  s->rec_bytes = rec_bytes;
  std::lock_guard<std::mutex> lk(g_mu);
  g_stores.push_back(std::move(s));
  *handle = (int64_t)g_stores.size() - 1;
  return 0;
}

// Gather n records by index into out. widen_f16: records are fp16 on disk,
// the output fp32 (out stride = rec_bytes * 2). Returns 0 on success, -1
// on a bad handle or a short read (a record past the end of the file).
int fstore_gather(int64_t handle, const int64_t* idx, int64_t n, char* out,
                  int widen_f16, int num_threads) {
  std::shared_ptr<Store> s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= (int64_t)g_stores.size()) return -1;
    s = g_stores[handle];  // keeps the Store (and fd) alive for this call
  }
  if (!s || s->fd < 0) return -1;
  if (num_threads <= 0) num_threads = 8;
  if (num_threads > (int)n) num_threads = (int)n > 0 ? (int)n : 1;

  const uint64_t rec = s->rec_bytes;
  const uint64_t out_rec = widen_f16 ? rec * 2 : rec;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    std::vector<char> tmp;
    if (widen_f16) tmp.resize(rec);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load()) break;
      uint64_t off = s->data_off + (uint64_t)idx[i] * rec;
      char* dst = out + (uint64_t)i * out_rec;
      if (widen_f16) {
        if (!ReadFull(s->fd, tmp.data(), rec, off)) { err = 1; break; }
        WidenF16((const uint16_t*)tmp.data(), (float*)dst, rec / 2);
      } else {
        if (!ReadFull(s->fd, dst, rec, off)) { err = 1; break; }
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < num_threads; t++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return err.load() ? -1 : 0;
}

int fstore_close(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (handle >= 0 && handle < (int64_t)g_stores.size())
    g_stores[handle].reset();  // fd closes when the last gather finishes
  return 0;
}

}  // extern "C"
