// vfr_io — memory-mapped packed feature store (native data-loader backend).
//
// Format "VFRF1" (little-endian):
//   offset 0   : char magic[8]  = "VFRF1\0\0\0"
//   offset 8   : int64 num_videos
//   offset 16  : int32 rows_per_video   (static grid — matches the
//                framework's fixed-shape batching)
//   offset 20  : int32 feature_dim
//   offset 24  : num_videos * 64 bytes  null-padded video ids, SORTED
//   then       : num_videos * rows * dim float32 feature data
//
// The reader mmaps the file (zero-copy, page-cache backed) and serves
// batched gathers with a small thread pool — the batch-assembly hot op:
// out[i] = data[indices[i]] for [rows, dim] blocks.
//
// C ABI only (consumed via ctypes from vfr_tpu_torch/data/packed.py;
// built with g++ by vfr_tpu_torch/kernels/build.py::load_host).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'V', 'F', 'R', 'F', '1', '\0', '\0', '\0'};
constexpr int kIdBytes = 64;

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped_bytes = 0;
  int64_t num_videos = 0;
  int32_t rows = 0;
  int32_t dim = 0;
  const char* ids = nullptr;     // num_videos * 64
  const float* data = nullptr;   // num_videos * rows * dim
};

}  // namespace

extern "C" {

void* vfr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  size_t sz = static_cast<size_t>(st.st_size);
  if (sz < 24) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, sz, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(mem);
  if (memcmp(base, kMagic, 8) != 0) {
    munmap(mem, sz);
    ::close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->fd = fd;
  s->base = base;
  s->mapped_bytes = sz;
  memcpy(&s->num_videos, base + 8, 8);
  memcpy(&s->rows, base + 16, 4);
  memcpy(&s->dim, base + 20, 4);
  size_t id_bytes = static_cast<size_t>(s->num_videos) * kIdBytes;
  size_t need = 24 + id_bytes +
                static_cast<size_t>(s->num_videos) * s->rows * s->dim * 4;
  if (s->num_videos < 0 || s->rows <= 0 || s->dim <= 0 || need > sz) {
    munmap(mem, sz);
    ::close(fd);
    delete s;
    return nullptr;
  }
  s->ids = reinterpret_cast<const char*>(base + 24);
  s->data = reinterpret_cast<const float*>(base + 24 + id_bytes);
  return s;
}

void vfr_close(void* h) {
  Store* s = static_cast<Store*>(h);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->mapped_bytes);
  ::close(s->fd);
  delete s;
}

int64_t vfr_num_videos(void* h) { return static_cast<Store*>(h)->num_videos; }
int32_t vfr_rows(void* h) { return static_cast<Store*>(h)->rows; }
int32_t vfr_dim(void* h) { return static_cast<Store*>(h)->dim; }

// Binary search over the sorted fixed-width id table; -1 if absent.
int64_t vfr_find(void* h, const char* video_id) {
  Store* s = static_cast<Store*>(h);
  int64_t lo = 0, hi = s->num_videos - 1;
  while (lo <= hi) {
    int64_t mid = lo + (hi - lo) / 2;
    int c = strncmp(s->ids + mid * kIdBytes, video_id, kIdBytes);
    if (c == 0) return mid;
    if (c < 0)
      lo = mid + 1;
    else
      hi = mid - 1;
  }
  return -1;
}

// Copy the id at |index| (null-terminated, up to 64 bytes) into |out|.
void vfr_id_at(void* h, int64_t index, char* out) {
  Store* s = static_cast<Store*>(h);
  memcpy(out, s->ids + index * kIdBytes, kIdBytes);
}

const float* vfr_data(void* h) { return static_cast<Store*>(h)->data; }

// Batched gather: out[i, :, :] = data[indices[i], :, :], parallel memcpy.
void vfr_gather(void* h, const int64_t* indices, int64_t n, float* out,
                int threads) {
  Store* s = static_cast<Store*>(h);
  const size_t block = static_cast<size_t>(s->rows) * s->dim;
  if (threads < 1) threads = 1;
  if (threads == 1 || n < 4) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t v = indices[i];
      if (v < 0 || v >= s->num_videos) {
        memset(out + i * block, 0, block * 4);
      } else {
        memcpy(out + i * block, s->data + v * block, block * 4);
      }
    }
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        int64_t v = indices[i];
        if (v < 0 || v >= s->num_videos) {
          memset(out + i * block, 0, block * 4);
        } else {
          memcpy(out + i * block, s->data + v * block, block * 4);
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
