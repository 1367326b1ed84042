// Framed-message TCP transport (internal).
//
// TPU-native equivalent of the reference's socket RPC layer
// (reference: paddle/pserver/LightNetwork.h:40 SocketServer,
// paddle/pserver/SocketChannel.h message framing, ProtoServer.h
// request/response dispatch).  One thread per connection; messages are
// [u32 opcode][u64 len][payload]; the response reuses the framing.
#ifndef PADDLE_TPU_RT_TRANSPORT_H
#define PADDLE_TPU_RT_TRANSPORT_H

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace ptrt {

// CRC-32 (IEEE, table-driven); table init is thread-safe (magic static)
uint32_t crc32(const void *data, size_t n);

// binary reader/writer over a byte vector
struct Writer {
  std::vector<uint8_t> buf;
  void u32(uint32_t v) { raw(&v, 4); }
  void u64(uint64_t v) { raw(&v, 8); }
  void i64(int64_t v) { raw(&v, 8); }
  void f64(double v) { raw(&v, 8); }
  void str(const std::string &s) {
    u64(s.size());
    raw(s.data(), s.size());
  }
  void bytes(const void *p, size_t n) {
    u64(n);
    raw(p, n);
  }
  void raw(const void *p, size_t n) {
    const uint8_t *b = static_cast<const uint8_t *>(p);
    buf.insert(buf.end(), b, b + n);
  }
};

struct Reader {
  const uint8_t *p;
  size_t n, off = 0;
  Reader(const void *data, size_t len)
      : p(static_cast<const uint8_t *>(data)), n(len) {}
  bool ok(size_t k) const { return off + k <= n; }
  uint32_t u32() { uint32_t v = 0; get(&v, 4); return v; }
  uint64_t u64() { uint64_t v = 0; get(&v, 8); return v; }
  int64_t i64() { int64_t v = 0; get(&v, 8); return v; }
  double f64() { double v = 0; get(&v, 8); return v; }
  std::string str() {
    uint64_t k = u64();
    if (!ok(k)) return "";
    std::string s(reinterpret_cast<const char *>(p + off), k);
    off += k;
    return s;
  }
  // zero-copy view of a length-prefixed blob
  const uint8_t *blob(uint64_t *len) {
    *len = u64();
    if (!ok(*len)) { *len = 0; return nullptr; }
    const uint8_t *b = p + off;
    off += *len;
    return b;
  }
  void get(void *out, size_t k) {
    if (!ok(k)) { memset(out, 0, k); return; }
    memcpy(out, p + off, k);
    off += k;
  }
};

// handler: (opcode, request reader) -> response writer content
using Handler = std::function<void(uint32_t, Reader &, Writer &)>;

class Server {
 public:
  // port 0 -> ephemeral; bound port readable via port()
  Server(int port, Handler handler);
  ~Server();
  void stop();
  int port() const { return port_; }

 private:
  void acceptLoop();
  void serveConn(int fd);
  void reapFinishedLocked();
  int listen_fd_ = -1;
  int port_ = 0;
  Handler handler_;
  std::atomic<bool> stopping_{false};
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::map<int, std::thread> conns_;  // fd -> serving thread
  std::vector<int> finished_fds_;     // done threads awaiting join/reap
};

class Client {
 public:
  Client(const std::string &host, int port);
  ~Client();
  bool connected() const { return fd_ >= 0; }
  // send request, block for response; returns false on IO error
  bool call(uint32_t opcode, const Writer &req, std::vector<uint8_t> *resp);

 private:
  int fd_ = -1;
};

bool sendFrame(int fd, uint32_t opcode, const void *payload, uint64_t len);
bool recvFrame(int fd, uint32_t *opcode, std::vector<uint8_t> *payload);

}  // namespace ptrt

#endif
