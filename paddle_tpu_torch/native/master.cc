// Master task-queue service: dataset chunks -> leased tasks with
// timeouts and a failure cap, snapshot/recover to disk.
//
// TPU-native equivalent of the reference Go master
// (reference: go/master/service.go:89 — partition:106, GetTask:368,
// TaskFinished:411, TaskFailed:455, checkTimeoutFunc:341,
// processFailedTask:313, snapshot:207/recover:166 via etcd; here
// snapshot goes to a local file and discovery is by host:port).
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "paddle_tpu_rt.h"
#include "transport.h"

namespace ptrt {
namespace {

enum Op : uint32_t {
  kSetDataset = 20,
  kGetTask = 21,
  kTaskFinished = 22,
  kTaskFailed = 23,
  // etcd-style TTL-lease registry (reference:
  // go/pserver/etcd_client.go:31-97 — pserver slot registration with
  // TTL keep-alive; trainers discover live pservers by listing)
  kRegister = 24,
  kKeepAlive = 25,
  kUnregister = 26,
  kList = 27,
};

struct Task {
  int64_t id = 0;
  std::vector<std::string> chunks;
  int failures = 0;
};

struct Lease {
  std::string key;
  std::string value;
  int ttl_ms = 0;
  std::chrono::steady_clock::time_point deadline;
};

using Clock = std::chrono::steady_clock;

class Master {
 public:
  Master(int port, int timeout_ms, int failure_max)
      : timeout_ms_(timeout_ms), failure_max_(failure_max),
        server_(port, [this](uint32_t op, Reader &r, Writer &w) {
          handle(op, r, w);
        }) {
    timeout_thread_ = std::thread([this] { timeoutLoop(); });
  }

  ~Master() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (stopping_) return;
      stopping_ = true;
    }
    server_.stop();
    if (timeout_thread_.joinable()) timeout_thread_.join();
  }

  int port() const { return server_.port(); }

  int snapshot(const char *path) {
    std::lock_guard<std::mutex> g(mu_);
    Writer w;
    auto dump = [&w](const std::vector<Task> &ts) {
      w.u64(ts.size());
      for (const Task &t : ts) {
        w.i64(t.id);
        w.u32(static_cast<uint32_t>(t.failures));
        w.u64(t.chunks.size());
        for (const auto &c : t.chunks) w.str(c);
      }
    };
    std::vector<Task> pending_all = todo_;
    for (auto &kv : pending_) pending_all.push_back(kv.second.first);
    dump(pending_all);  // leased tasks go back to todo on recover
    dump(done_);
    dump(discarded_);
    w.i64(next_id_);
    w.u32(dataset_set_ ? 1 : 0);
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    uint32_t crc = crc32(w.buf.data(), w.buf.size());
    uint64_t n = w.buf.size();
    fwrite(&crc, 4, 1, f);
    fwrite(&n, 8, 1, f);
    fwrite(w.buf.data(), 1, n, f);
    fclose(f);
    return 0;
  }

  int recover(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    uint32_t crc = 0;
    uint64_t n = 0;
    if (fread(&crc, 4, 1, f) != 1 || fread(&n, 8, 1, f) != 1 ||
        n > (1ull << 32)) {
      fclose(f);
      return -2;
    }
    std::vector<uint8_t> buf(n);
    if (fread(buf.data(), 1, n, f) != n) { fclose(f); return -2; }
    fclose(f);
    if (crc32(buf.data(), n) != crc) return -3;  // corrupted snapshot
    std::lock_guard<std::mutex> g(mu_);
    Reader r(buf.data(), n);
    auto slurp = [&r](std::vector<Task> *ts) {
      uint64_t cnt = r.u64();
      ts->clear();
      for (uint64_t i = 0; i < cnt; ++i) {
        Task t;
        t.id = r.i64();
        t.failures = static_cast<int>(r.u32());
        uint64_t nc = r.u64();
        for (uint64_t k = 0; k < nc; ++k) t.chunks.push_back(r.str());
        ts->push_back(std::move(t));
      }
    };
    slurp(&todo_);
    slurp(&done_);
    slurp(&discarded_);
    next_id_ = r.i64();
    dataset_set_ = r.u32() != 0;
    pending_.clear();
    return 0;
  }

 private:
  void expireLeasesLocked(Clock::time_point now) {
    for (auto it = leases_.begin(); it != leases_.end();) {
      if (now >= it->second.deadline)
        it = leases_.erase(it);
      else
        ++it;
    }
  }

  bool keyHeldLocked(const std::string &key, Clock::time_point now) {
    for (auto &kv : leases_)
      if (kv.second.key == key && now < kv.second.deadline) return true;
    return false;
  }

  void timeoutLoop() {
    // requeue leased tasks whose lease expired (reference:
    // go/master checkTimeoutFunc:341)
    while (true) {
      {
        std::lock_guard<std::mutex> g(mu_);
        if (stopping_) return;
        auto now = Clock::now();
        expireLeasesLocked(now);
        for (auto it = pending_.begin(); it != pending_.end();) {
          auto age = std::chrono::duration_cast<std::chrono::milliseconds>(
                         now - it->second.second)
                         .count();
          if (age > timeout_ms_) {
            Task t = std::move(it->second.first);
            it = pending_.erase(it);
            failTaskLocked(std::move(t));
          } else {
            ++it;
          }
        }
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(
          std::max(10, timeout_ms_ / 4)));
    }
  }

  void failTaskLocked(Task t) {
    t.failures++;
    if (t.failures >= failure_max_) {
      // poisoned task discarded (reference: processFailedTask:313)
      discarded_.push_back(std::move(t));
    } else {
      todo_.push_back(std::move(t));
    }
  }

  void handle(uint32_t op, Reader &r, Writer &w) {
    switch (op) {
      case kSetDataset: {
        uint64_t n = r.u64();
        int per_task = static_cast<int>(r.u32());
        std::lock_guard<std::mutex> g(mu_);
        if (!dataset_set_) {  // first caller wins (SetDataset:280)
          std::vector<std::string> chunks;
          for (uint64_t i = 0; i < n; ++i) chunks.push_back(r.str());
          for (size_t i = 0; i < chunks.size();
               i += static_cast<size_t>(per_task)) {
            Task t;
            t.id = next_id_++;
            for (size_t k = i;
                 k < std::min(chunks.size(),
                              i + static_cast<size_t>(per_task));
                 ++k)
              t.chunks.push_back(chunks[k]);
            todo_.push_back(std::move(t));
          }
          dataset_set_ = true;
        }
        w.u32(0);
        break;
      }
      case kGetTask: {
        std::lock_guard<std::mutex> g(mu_);
        if (todo_.empty()) {
          bool pass_done = pending_.empty() && dataset_set_;
          if (pass_done && !done_.empty()) {
            // report pass end once, then recycle finished tasks so the
            // next get_task starts a fresh pass (reference: go/master
            // rotates todo/done queues between passes)
            todo_ = std::move(done_);
            done_.clear();
          }
          w.u32(pass_done ? 2u : 1u);  // 2: pass finished, 1: retry
          return;
        }
        Task t = todo_.front();
        todo_.erase(todo_.begin());
        int64_t id = t.id;
        std::string joined;
        for (size_t i = 0; i < t.chunks.size(); ++i) {
          if (i) joined += "\n";
          joined += t.chunks[i];
        }
        pending_[id] = {std::move(t), Clock::now()};
        w.u32(0);
        w.i64(id);
        w.str(joined);
        break;
      }
      case kTaskFinished: {
        int64_t id = r.i64();
        std::lock_guard<std::mutex> g(mu_);
        auto it = pending_.find(id);
        if (it != pending_.end()) {
          done_.push_back(std::move(it->second.first));
          pending_.erase(it);
        }
        w.u32(0);
        break;
      }
      case kTaskFailed: {
        int64_t id = r.i64();
        std::lock_guard<std::mutex> g(mu_);
        auto it = pending_.find(id);
        if (it != pending_.end()) {
          Task t = std::move(it->second.first);
          pending_.erase(it);
          failTaskLocked(std::move(t));
        }
        w.u32(0);
        break;
      }
      case kRegister: {
        std::string key = r.str();
        std::string value = r.str();
        int ttl_ms = static_cast<int>(r.u32());
        std::lock_guard<std::mutex> g(mu_);
        auto now = Clock::now();
        expireLeasesLocked(now);
        if (keyHeldLocked(key, now)) {
          // slot taken by a live lease (reference: etcd CAS on the
          // pserver index key — the caller retries another slot or
          // waits for the TTL to lapse)
          w.u32(1);
          return;
        }
        Lease l;
        l.key = std::move(key);
        l.value = std::move(value);
        l.ttl_ms = std::max(1, ttl_ms);
        l.deadline = now + std::chrono::milliseconds(l.ttl_ms);
        int64_t id = next_lease_++;
        leases_[id] = std::move(l);
        w.u32(0);
        w.i64(id);
        break;
      }
      case kKeepAlive: {
        int64_t id = r.i64();
        std::lock_guard<std::mutex> g(mu_);
        auto now = Clock::now();
        auto it = leases_.find(id);
        if (it == leases_.end() || now >= it->second.deadline) {
          if (it != leases_.end()) leases_.erase(it);
          w.u32(1);  // lease lapsed: the holder must re-register
          return;
        }
        it->second.deadline =
            now + std::chrono::milliseconds(it->second.ttl_ms);
        w.u32(0);
        break;
      }
      case kUnregister: {
        int64_t id = r.i64();
        std::lock_guard<std::mutex> g(mu_);
        leases_.erase(id);
        w.u32(0);
        break;
      }
      case kList: {
        std::string prefix = r.str();
        std::lock_guard<std::mutex> g(mu_);
        auto now = Clock::now();
        expireLeasesLocked(now);
        std::vector<std::pair<std::string, std::string>> out;
        for (auto &kv : leases_)
          if (kv.second.key.compare(0, prefix.size(), prefix) == 0)
            out.emplace_back(kv.second.key, kv.second.value);
        std::sort(out.begin(), out.end());
        w.u32(0);
        w.u64(out.size());
        for (auto &p : out) {
          w.str(p.first);
          w.str(p.second);
        }
        break;
      }
      default:
        w.u32(0xFFFF);
    }
  }

  int timeout_ms_;
  int failure_max_;
  std::mutex mu_;
  bool stopping_ = false;
  bool dataset_set_ = false;
  std::vector<Task> todo_, done_, discarded_;
  std::map<int64_t, std::pair<Task, Clock::time_point>> pending_;
  int64_t next_id_ = 0;
  std::map<int64_t, Lease> leases_;
  int64_t next_lease_ = 1;
  std::thread timeout_thread_;
  Server server_;
};

}  // namespace

extern "C" {

void *ptrt_master_start(int port, int timeout_ms, int failure_max) {
  return new Master(port, timeout_ms, failure_max);
}
void ptrt_master_stop(void *m) {
  Master *p = static_cast<Master *>(m);
  p->stop();
  delete p;
}
int ptrt_master_port(void *m) { return static_cast<Master *>(m)->port(); }
int ptrt_master_snapshot(void *m, const char *path) {
  return static_cast<Master *>(m)->snapshot(path);
}
int ptrt_master_recover(void *m, const char *path) {
  return static_cast<Master *>(m)->recover(path);
}

void *ptrt_mclient_connect(const char *host, int port) {
  Client *c = new Client(host ? host : "", port);
  if (!c->connected()) {
    delete c;
    return nullptr;
  }
  return c;
}
void ptrt_mclient_close(void *c) { delete static_cast<Client *>(c); }

int ptrt_mclient_set_dataset(void *c, const char *const *chunks, int n,
                             int chunks_per_task) {
  Writer w;
  w.u64(static_cast<uint64_t>(n));
  w.u32(static_cast<uint32_t>(chunks_per_task));
  for (int i = 0; i < n; ++i) w.str(chunks[i]);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kSetDataset, w, &resp)) return -1;
  return 0;
}

int64_t ptrt_mclient_get_task(void *c, char *buf, int64_t buflen) {
  Writer w;
  std::vector<uint8_t> resp;
  // -3: transport failure (distinct from -1 retry-later so callers can
  // tell a dead master from an empty queue)
  if (!static_cast<Client *>(c)->call(kGetTask, w, &resp)) return -3;
  Reader r(resp.data(), resp.size());
  uint32_t rc = r.u32();
  if (rc == 1) return -1;
  if (rc == 2) return -2;
  int64_t id = r.i64();
  std::string chunks = r.str();
  if (buf && buflen > 0) {
    if (chunks.size() > static_cast<size_t>(buflen - 1)) {
      // truncation would hand the worker a broken chunk path; surface
      // an explicit error instead
      return -4;
    }
    memcpy(buf, chunks.data(), chunks.size());
    buf[chunks.size()] = 0;
  }
  return id;
}

int ptrt_mclient_task_finished(void *c, int64_t task_id) {
  Writer w;
  w.i64(task_id);
  std::vector<uint8_t> resp;
  return static_cast<Client *>(c)->call(kTaskFinished, w, &resp) ? 0 : -1;
}

int ptrt_mclient_task_failed(void *c, int64_t task_id) {
  Writer w;
  w.i64(task_id);
  std::vector<uint8_t> resp;
  return static_cast<Client *>(c)->call(kTaskFailed, w, &resp) ? 0 : -1;
}

int64_t ptrt_mclient_register(void *c, const char *key, const char *value,
                              int ttl_ms) {
  Writer w;
  w.str(key);
  w.str(value);
  w.u32(static_cast<uint32_t>(ttl_ms));
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kRegister, w, &resp)) return -2;
  Reader r(resp.data(), resp.size());
  if (r.u32() != 0) return -1;  // key held by a live lease
  return r.i64();
}

int ptrt_mclient_keepalive(void *c, int64_t lease) {
  Writer w;
  w.i64(lease);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kKeepAlive, w, &resp)) return -2;
  Reader r(resp.data(), resp.size());
  return static_cast<int>(r.u32());  // 0 renewed, 1 lapsed
}

int ptrt_mclient_unregister(void *c, int64_t lease) {
  Writer w;
  w.i64(lease);
  std::vector<uint8_t> resp;
  return static_cast<Client *>(c)->call(kUnregister, w, &resp) ? 0 : -1;
}

int64_t ptrt_mclient_list(void *c, const char *prefix, char *buf,
                          int64_t buflen) {
  // entries come back newline-joined as "key=value" lines; returns the
  // entry count, or -4 when the buffer would truncate
  Writer w;
  w.str(prefix);
  std::vector<uint8_t> resp;
  if (!static_cast<Client *>(c)->call(kList, w, &resp)) return -2;
  Reader r(resp.data(), resp.size());
  if (r.u32() != 0) return -1;
  uint64_t n = r.u64();
  std::string joined;
  for (uint64_t i = 0; i < n; ++i) {
    std::string k = r.str();
    std::string v = r.str();
    if (i) joined += "\n";
    joined += k;
    joined += "=";
    joined += v;
  }
  if (buf && buflen > 0) {
    if (joined.size() > static_cast<size_t>(buflen - 1)) return -4;
    memcpy(buf, joined.data(), joined.size());
    buf[joined.size()] = 0;
  }
  return static_cast<int64_t>(n);
}

}  // extern "C"

}  // namespace ptrt
