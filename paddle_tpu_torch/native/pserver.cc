// Parameter server: named float parameters, sync gradient aggregation
// with trainer barriers or async immediate updates, sparse row access,
// checkpoint with CRC.
//
// TPU-native equivalent of the reference C++/Go parameter servers
// (reference: paddle/pserver/ParameterServer2.h:73 — addGradient:482
// barrier aggregation, asyncSGD:468, getParameter:496,
// getParameterSparse:510, waitPassStart:406 barriers;
// go/pserver/service.go checkpoint:346 with crc+md5 meta).  Optimizers
// run server-side as in both references.
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "optimizer.h"
#include "paddle_tpu_rt.h"
#include "transport.h"

namespace ptrt {
namespace {

enum Op : uint32_t {
  kInitParam = 1,
  kSendGrad = 2,
  kGetParam = 3,
  kSendSparseGrad = 4,
  kGetRows = 5,
  kBarrier = 6,
};

struct ParamEntry {
  std::vector<float> value;
  std::vector<float> grad_accum;
  int grads_pending = 0;   // trainers aggregated so far this round
  int64_t version = 0;
  Optimizer opt;
};

class PServer {
 public:
  PServer(int port, int num_trainers, int sync, int async_lagged)
      : num_trainers_(num_trainers), sync_(sync),
        async_lagged_(async_lagged),
        server_(port, [this](uint32_t op, Reader &r, Writer &w) {
          handle(op, r, w);
        }) {}

  int port() const { return server_.port(); }

  void stop() {
    {
      // wake sync-barrier / gradient-round waiters so their connection
      // threads can exit before Server::stop() joins them
      std::lock_guard<std::mutex> g(mu_);
      stopping_ = true;
    }
    cv_.notify_all();
    server_.stop();
  }
  int64_t numLagged() {
    std::lock_guard<std::mutex> g(mu_);
    return lagged_grads_;
  }

  int64_t numUpdates() {
    std::lock_guard<std::mutex> g(mu_);
    return updates_;
  }

  int64_t numSparseRows() {
    std::lock_guard<std::mutex> g(mu_);
    return sparse_rows_;
  }

  int save(const char *path) {
    std::lock_guard<std::mutex> g(mu_);
    Writer w;
    w.u64(params_.size());
    for (auto &kv : params_) {
      w.str(kv.first);
      w.i64(kv.second.version);
      w.bytes(kv.second.value.data(), kv.second.value.size() * 4);
      w.bytes(kv.second.opt.m1.data(), kv.second.opt.m1.size() * 4);
      w.bytes(kv.second.opt.m2.data(), kv.second.opt.m2.size() * 4);
      w.i64(kv.second.opt.step);
      // optimizer config: a restored server must keep optimizing the
      // same way (reference: go/pserver checkpoint includes the
      // serialized optimizer state+config)
      w.u32(static_cast<uint32_t>(kv.second.opt.kind));
      w.f64(kv.second.opt.lr);
      w.f64(kv.second.opt.hp1);
      w.f64(kv.second.opt.hp2);
      w.f64(kv.second.opt.hp3);
    }
    uint32_t crc = crc32(w.buf.data(), w.buf.size());
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    uint64_t n = w.buf.size();
    fwrite(&crc, 4, 1, f);
    fwrite(&n, 8, 1, f);
    fwrite(w.buf.data(), 1, n, f);
    fclose(f);
    return 0;
  }

  int load(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    uint32_t crc = 0;
    uint64_t n = 0;
    if (fread(&crc, 4, 1, f) != 1 || fread(&n, 8, 1, f) != 1) {
      fclose(f);
      return -2;
    }
    std::vector<uint8_t> buf(n);
    if (fread(buf.data(), 1, n, f) != n) { fclose(f); return -2; }
    fclose(f);
    if (crc32(buf.data(), n) != crc) return -3;  // corrupted checkpoint
    std::lock_guard<std::mutex> g(mu_);
    Reader r(buf.data(), n);
    uint64_t cnt = r.u64();
    for (uint64_t i = 0; i < cnt; ++i) {
      std::string name = r.str();
      ParamEntry &e = params_[name];
      e.version = r.i64();
      uint64_t len;
      const uint8_t *v = r.blob(&len);
      e.value.resize(len / 4);
      memcpy(e.value.data(), v, len);
      v = r.blob(&len);
      e.opt.m1.resize(len / 4);
      if (len) memcpy(e.opt.m1.data(), v, len);
      v = r.blob(&len);
      e.opt.m2.resize(len / 4);
      if (len) memcpy(e.opt.m2.data(), v, len);
      e.opt.step = r.i64();
      e.opt.kind = static_cast<int>(r.u32());
      e.opt.lr = r.f64();
      e.opt.hp1 = r.f64();
      e.opt.hp2 = r.f64();
      e.opt.hp3 = r.f64();
    }
    return 0;
  }

 private:
  void handle(uint32_t op, Reader &r, Writer &w) {
    switch (op) {
      case kInitParam: {
        std::string name = r.str();
        int kind = static_cast<int>(r.u32());
        double lr = r.f64(), h1 = r.f64(), h2 = r.f64(), h3 = r.f64();
        uint64_t len;
        const uint8_t *data = r.blob(&len);
        std::lock_guard<std::mutex> g(mu_);
        // first trainer wins (reference: Go pserver InitParam once)
        if (!params_.count(name)) {
          ParamEntry &e = params_[name];
          e.value.resize(len / 4);
          memcpy(e.value.data(), data, len);
          e.opt.kind = kind;
          e.opt.lr = lr;
          e.opt.hp1 = h1;
          e.opt.hp2 = h2;
          e.opt.hp3 = h3;
          e.opt.ensure(e.value.size());
        }
        w.u32(0);
        break;
      }
      case kSendGrad: {
        std::string name = r.str();
        int64_t base_version = r.i64();
        uint64_t len;
        const uint8_t *data = r.blob(&len);
        std::unique_lock<std::mutex> g(mu_);
        auto it = params_.find(name);
        if (it == params_.end()) { w.u32(1); return; }
        ParamEntry &e = it->second;
        const float *grad = reinterpret_cast<const float *>(data);
        size_t n = len / 4;
        if (n != e.value.size()) { w.u32(2); return; }
        if (!sync_ || num_trainers_ <= 1) {
          // async staleness bound (reference: ParameterServer2.cpp:416
          // asyncGrdientCommitCheckAndStat over
          // FLAGS_async_lagged_grad_discard_ratio,
          // ParameterServer2.h:243): a gradient computed against
          // parameters at least async_lagged_ versions old is
          // discarded; the trainer still receives the fresh value so
          // it resynchronizes instead of looping on stale state.
          if (!sync_ && async_lagged_ > 0 &&
              e.version - base_version >= async_lagged_) {
            lagged_grads_++;
            w.u32(4);
            w.i64(e.version);
            w.bytes(e.value.data(), e.value.size() * 4);
            return;
          }
          e.opt.step++;
          e.opt.apply(e.value.data(), grad, 0, n);
          e.version++;
          updates_++;
        } else {
          if (e.grad_accum.size() != n) e.grad_accum.assign(n, 0.f);
          for (size_t i = 0; i < n; ++i) e.grad_accum[i] += grad[i];
          e.grads_pending++;
          int64_t my_version = e.version;
          if (e.grads_pending >= num_trainers_) {
            // average + one optimizer step (reference:
            // ParameterServer2 doOperation after all trainers report)
            float inv = 1.f / static_cast<float>(num_trainers_);
            for (size_t i = 0; i < n; ++i) e.grad_accum[i] *= inv;
            e.opt.step++;
            e.opt.apply(e.value.data(), e.grad_accum.data(), 0, n);
            e.grad_accum.assign(n, 0.f);
            e.grads_pending = 0;
            e.version++;
            updates_++;
            cv_.notify_all();
          } else {
            cv_.wait(g, [&] {
              return e.version > my_version || stopping_;
            });
            if (stopping_) { w.u32(3); return; }
          }
        }
        w.u32(0);
        w.i64(e.version);
        w.bytes(e.value.data(), e.value.size() * 4);
        break;
      }
      case kGetParam: {
        std::string name = r.str();
        std::lock_guard<std::mutex> g(mu_);
        auto it = params_.find(name);
        if (it == params_.end()) { w.u32(1); return; }
        w.u32(0);
        w.i64(it->second.version);
        w.bytes(it->second.value.data(), it->second.value.size() * 4);
        break;
      }
      case kSendSparseGrad: {
        // rows update immediately (async semantics — reference sparse
        // remote updates are asynchronous by design:
        // SparseRemoteParameterUpdater)
        std::string name = r.str();
        int64_t width = r.i64();
        uint64_t rlen, vlen;
        const uint8_t *rowsb = r.blob(&rlen);
        const uint8_t *valsb = r.blob(&vlen);
        std::lock_guard<std::mutex> g(mu_);
        auto it = params_.find(name);
        if (it == params_.end()) { w.u32(1); return; }
        ParamEntry &e = it->second;
        const int32_t *rows = reinterpret_cast<const int32_t *>(rowsb);
        const float *vals = reinterpret_cast<const float *>(valsb);
        size_t nrows = rlen / 4;
        // bounds: the vals blob must actually hold nrows*width floats
        if (width <= 0 ||
            vlen < nrows * static_cast<uint64_t>(width) * 4) {
          w.u32(2);
          return;
        }
        e.opt.step++;
        for (size_t i = 0; i < nrows; ++i) {
          // negative ids would wrap the size_t multiply past the bound
          if (rows[i] < 0) continue;
          size_t begin = static_cast<size_t>(rows[i]) * width;
          if (begin + width > e.value.size()) continue;
          e.opt.apply(e.value.data(), vals + i * width, begin,
                      begin + width);
          sparse_rows_++;  // rows actually applied (observability: lets
                           // tests prove updates shipped sparse)
        }
        e.version++;
        updates_++;
        w.u32(0);
        break;
      }
      case kGetRows: {
        std::string name = r.str();
        int64_t width = r.i64();
        uint64_t rlen;
        const uint8_t *rowsb = r.blob(&rlen);
        std::lock_guard<std::mutex> g(mu_);
        auto it = params_.find(name);
        if (it == params_.end()) { w.u32(1); return; }
        const int32_t *rows = reinterpret_cast<const int32_t *>(rowsb);
        size_t nrows = rlen / 4;
        // bounds: reject non-positive or absurd width before the
        // allocation (mirrors the kSendSparseGrad check) so a bad
        // request can't bad_alloc the server process. 1<<28 floats
        // (1 GiB) is far above any real sparse fetch.
        if (width <= 0 ||
            nrows * static_cast<uint64_t>(width) > (1ull << 28)) {
          w.u32(2);
          return;
        }
        std::vector<float> out(nrows * width, 0.f);
        for (size_t i = 0; i < nrows; ++i) {
          if (rows[i] < 0) continue;
          size_t begin = static_cast<size_t>(rows[i]) * width;
          if (begin + width <= it->second.value.size())
            memcpy(out.data() + i * width,
                   it->second.value.data() + begin, width * 4);
        }
        w.u32(0);
        w.bytes(out.data(), out.size() * 4);
        break;
      }
      case kBarrier: {
        // pass-start barrier across trainers (reference:
        // ParameterServer2::waitPassStart:406)
        std::unique_lock<std::mutex> g(mu_);
        barrier_count_++;
        if (barrier_count_ >= num_trainers_) {
          barrier_count_ = 0;
          barrier_gen_++;
          cv_.notify_all();
        } else {
          int64_t gen = barrier_gen_;
          cv_.wait(g, [&] { return barrier_gen_ > gen || stopping_; });
          if (stopping_) { w.u32(3); return; }
        }
        w.u32(0);
        break;
      }
      default:
        w.u32(0xFFFF);
    }
  }

  int num_trainers_;
  int sync_;
  int async_lagged_ = 0;       // 0 = unbounded (legacy behavior)
  int64_t lagged_grads_ = 0;   // discarded-as-stale count
  bool stopping_ = false;
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, ParamEntry> params_;
  int barrier_count_ = 0;
  int64_t barrier_gen_ = 0;
  int64_t updates_ = 0;
  int64_t sparse_rows_ = 0;  // total sparse rows applied
  Server server_;
};

}  // namespace

extern "C" {

void *ptrt_pserver_start(int port, int num_trainers, int sync,
                         int async_lagged) {
  return new PServer(port, num_trainers, sync, async_lagged);
}
void ptrt_pserver_stop(void *s) {
  PServer *p = static_cast<PServer *>(s);
  p->stop();
  delete p;
}
int ptrt_pserver_port(void *s) { return static_cast<PServer *>(s)->port(); }
int ptrt_pserver_save(void *s, const char *path) {
  return static_cast<PServer *>(s)->save(path);
}
int ptrt_pserver_load(void *s, const char *path) {
  return static_cast<PServer *>(s)->load(path);
}
int64_t ptrt_pserver_num_updates(void *s) {
  return static_cast<PServer *>(s)->numUpdates();
}
int64_t ptrt_pserver_num_lagged(void *s) {
  return static_cast<PServer *>(s)->numLagged();
}
int64_t ptrt_pserver_num_sparse_rows(void *s) {
  return static_cast<PServer *>(s)->numSparseRows();
}

void *ptrt_client_connect(const char *host, int port) {
  Client *c = new Client(host ? host : "", port);
  if (!c->connected()) {
    delete c;
    return nullptr;
  }
  return c;
}
void ptrt_client_close(void *c) { delete static_cast<Client *>(c); }

int ptrt_client_init_param(void *c, const char *name, const float *data,
                           int64_t n, int opt_kind, double lr, double hp1,
                           double hp2, double hp3) {
  Writer w;
  w.str(name);
  w.u32(static_cast<uint32_t>(opt_kind));
  w.f64(lr);
  w.f64(hp1);
  w.f64(hp2);
  w.f64(hp3);
  w.bytes(data, static_cast<size_t>(n) * 4);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kInitParam, w, &resp)) return -1;
  Reader r(resp.data(), resp.size());
  return static_cast<int>(r.u32());
}

int ptrt_client_send_grad(void *c, const char *name, const float *grad,
                          int64_t n, float *out, int64_t base_version,
                          int64_t *new_version) {
  Writer w;
  w.str(name);
  w.i64(base_version);
  w.bytes(grad, static_cast<size_t>(n) * 4);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kSendGrad, w, &resp)) return -1;
  Reader r(resp.data(), resp.size());
  int rc = static_cast<int>(r.u32());
  // rc 4 = discarded as stale; the fresh parameter still follows
  if ((rc == 0 || rc == 4)) {
    int64_t ver = r.i64();
    if (new_version) *new_version = ver;
    if (out) {
      uint64_t len;
      const uint8_t *v = r.blob(&len);
      memcpy(out, v, std::min<uint64_t>(len, static_cast<uint64_t>(n) * 4));
    }
  }
  return rc;
}

int ptrt_client_get_param(void *c, const char *name, float *out,
                          int64_t n, int64_t *version) {
  Writer w;
  w.str(name);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kGetParam, w, &resp)) return -1;
  Reader r(resp.data(), resp.size());
  int rc = static_cast<int>(r.u32());
  if (rc == 0) {
    int64_t ver = r.i64();
    if (version) *version = ver;
    if (out) {
      uint64_t len;
      const uint8_t *v = r.blob(&len);
      memcpy(out, v, std::min<uint64_t>(len, static_cast<uint64_t>(n) * 4));
    }
  }
  return rc;
}

int ptrt_client_send_sparse_grad(void *c, const char *name,
                                 const int32_t *rows, const float *vals,
                                 int64_t nrows, int64_t width) {
  Writer w;
  w.str(name);
  w.i64(width);
  w.bytes(rows, static_cast<size_t>(nrows) * 4);
  w.bytes(vals, static_cast<size_t>(nrows) * width * 4);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kSendSparseGrad, w, &resp))
    return -1;
  Reader r(resp.data(), resp.size());
  return static_cast<int>(r.u32());
}

int ptrt_client_get_rows(void *c, const char *name, const int32_t *rows,
                         float *out, int64_t nrows, int64_t width) {
  Writer w;
  w.str(name);
  w.i64(width);
  w.bytes(rows, static_cast<size_t>(nrows) * 4);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kGetRows, w, &resp)) return -1;
  Reader r(resp.data(), resp.size());
  int rc = static_cast<int>(r.u32());
  if (rc == 0 && out) {
    uint64_t len;
    const uint8_t *v = r.blob(&len);
    memcpy(out, v,
           std::min<uint64_t>(len, static_cast<uint64_t>(nrows) * width * 4));
  }
  return rc;
}

int ptrt_client_barrier(void *c) {
  Writer w;
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kBarrier, w, &resp)) return -1;
  Reader r(resp.data(), resp.size());
  return static_cast<int>(r.u32());
}

}  // extern "C"

}  // namespace ptrt
