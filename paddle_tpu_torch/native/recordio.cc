// RecordIO-style chunked record files + buddy allocator.
//
// TPU-native equivalents of the reference dataset container and host
// memory pool (reference: recordio usage go/master/service.go
// partition:106 over recordio.Index; paddle/memory/detail/
// buddy_allocator.h:33 BuddyAllocator over system allocators).
// Record format: per record [u32 crc][u32 len][payload]; a chunk is just
// a file (the master leases lists of files).
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

#include "paddle_tpu_rt.h"
#include "transport.h"  // ptrt::crc32

namespace ptrt {
namespace {

// ---- buddy allocator ----------------------------------------------------

class Buddy {
 public:
  Buddy(int64_t total, int64_t min_block) {
    min_block_ = 64;
    while (min_block_ < min_block) min_block_ <<= 1;
    total_ = min_block_;
    while (total_ < total) total_ <<= 1;
    base_ = static_cast<uint8_t *>(::operator new(total_));
    max_order_ = 0;
    while ((min_block_ << max_order_) < total_) max_order_++;
    free_[max_order_].push_back(0);
  }
  ~Buddy() { ::operator delete(base_); }

  void *alloc(int64_t n) {
    std::lock_guard<std::mutex> g(mu_);
    if (n <= 0) n = 1;
    int order = 0;
    while ((min_block_ << order) < n) order++;
    if (order > max_order_) return nullptr;
    int o = order;
    while (o <= max_order_ && free_[o].empty()) o++;
    if (o > max_order_) return nullptr;
    int64_t off = free_[o].back();
    free_[o].pop_back();
    while (o > order) {  // split down
      o--;
      free_[o].push_back(off + (min_block_ << o));
    }
    used_[off] = order;
    used_bytes_ += (min_block_ << order);
    return base_ + off;
  }

  void free(void *p) {
    std::lock_guard<std::mutex> g(mu_);
    int64_t off = static_cast<uint8_t *>(p) - base_;
    auto it = used_.find(off);
    if (it == used_.end()) return;
    int order = it->second;
    used_.erase(it);
    used_bytes_ -= (min_block_ << order);
    // coalesce with buddy while free (reference: buddy_allocator.h
    // merging free blocks)
    while (order < max_order_) {
      int64_t buddy = off ^ (min_block_ << order);
      auto &fl = free_[order];
      bool merged = false;
      for (size_t i = 0; i < fl.size(); ++i) {
        if (fl[i] == buddy) {
          fl.erase(fl.begin() + i);
          off = std::min(off, buddy);
          order++;
          merged = true;
          break;
        }
      }
      if (!merged) break;
    }
    free_[order].push_back(off);
  }

  int64_t used() {
    std::lock_guard<std::mutex> g(mu_);
    return used_bytes_;
  }

 private:
  uint8_t *base_;
  int64_t total_, min_block_, used_bytes_ = 0;
  int max_order_;
  std::mutex mu_;
  std::map<int, std::vector<int64_t>> free_;
  std::map<int64_t, int> used_;
};

}  // namespace

extern "C" {

void *ptrt_recordio_writer_open(const char *path) {
  return fopen(path, "wb");
}
int ptrt_recordio_write(void *w, const void *data, int64_t n) {
  FILE *f = static_cast<FILE *>(w);
  uint32_t crc = crc32(data, static_cast<size_t>(n));
  uint32_t len = static_cast<uint32_t>(n);
  if (fwrite(&crc, 4, 1, f) != 1) return -1;
  if (fwrite(&len, 4, 1, f) != 1) return -1;
  if (n && fwrite(data, 1, static_cast<size_t>(n), f) !=
               static_cast<size_t>(n))
    return -1;
  return 0;
}
int ptrt_recordio_writer_close(void *w) {
  return fclose(static_cast<FILE *>(w));
}

void *ptrt_recordio_reader_open(const char *path) {
  return fopen(path, "rb");
}
int64_t ptrt_recordio_read(void *r, void *buf, int64_t buflen) {
  FILE *f = static_cast<FILE *>(r);
  uint32_t crc, len;
  if (fread(&crc, 4, 1, f) != 1) return -1;  // EOF
  if (fread(&len, 4, 1, f) != 1) return -2;
  if (len > static_cast<uint64_t>(buflen)) return -2;
  if (len && fread(buf, 1, len, f) != len) return -2;
  if (crc32(buf, len) != crc) return -2;
  return static_cast<int64_t>(len);
}
void ptrt_recordio_reader_close(void *r) { fclose(static_cast<FILE *>(r)); }

void *ptrt_buddy_create(int64_t total_bytes, int64_t min_block) {
  return new Buddy(total_bytes, min_block);
}
void *ptrt_buddy_alloc(void *a, int64_t n) {
  return static_cast<Buddy *>(a)->alloc(n);
}
void ptrt_buddy_free(void *a, void *p) { static_cast<Buddy *>(a)->free(p); }
int64_t ptrt_buddy_used(void *a) { return static_cast<Buddy *>(a)->used(); }
void ptrt_buddy_destroy(void *a) { delete static_cast<Buddy *>(a); }

}  // extern "C"

}  // namespace ptrt
