// See transport.h.  POSIX sockets, thread per connection (the reference
// pserver similarly dedicates threads per channel:
// paddle/pserver/SocketChannel.h, LightNetwork.h worker threads).
#include "transport.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>

namespace ptrt {

namespace {
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
}  // namespace

uint32_t crc32(const void *data, size_t n) {
  static const Crc32Table table;  // thread-safe init (magic static)
  uint32_t c = 0xFFFFFFFFu;
  const uint8_t *p = static_cast<const uint8_t *>(data);
  for (size_t i = 0; i < n; ++i)
    c = table.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static bool writeAll(int fd, const void *p, size_t n) {
  const char *b = static_cast<const char *>(p);
  while (n > 0) {
    ssize_t k = ::write(fd, b, n);
    if (k <= 0) return false;
    b += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

static bool readAll(int fd, void *p, size_t n) {
  char *b = static_cast<char *>(p);
  while (n > 0) {
    ssize_t k = ::read(fd, b, n);
    if (k <= 0) return false;
    b += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool sendFrame(int fd, uint32_t opcode, const void *payload, uint64_t len) {
  uint8_t hdr[12];
  memcpy(hdr, &opcode, 4);
  memcpy(hdr + 4, &len, 8);
  if (!writeAll(fd, hdr, 12)) return false;
  return len == 0 || writeAll(fd, payload, len);
}

bool recvFrame(int fd, uint32_t *opcode, std::vector<uint8_t> *payload) {
  uint8_t hdr[12];
  if (!readAll(fd, hdr, 12)) return false;
  uint64_t len;
  memcpy(opcode, hdr, 4);
  memcpy(&len, hdr + 4, 8);
  if (len > (1ull << 33)) return false;  // sanity cap 8GB
  payload->resize(len);
  return len == 0 || readAll(fd, payload->data(), len);
}

Server::Server(int port, Handler handler) : handler_(std::move(handler)) {
  listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (listen_fd_ < 0) return;
  int one = 1;
  setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  // all interfaces: pserver/master serve cross-host DCN traffic
  // (reference: the pservers bind routable addresses; trainers discover
  // them by host:port)
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(listen_fd_, reinterpret_cast<sockaddr *>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(listen_fd_, 128) != 0) {
    ::close(listen_fd_);
    listen_fd_ = -1;
    return;
  }
  socklen_t alen = sizeof(addr);
  getsockname(listen_fd_, reinterpret_cast<sockaddr *>(&addr), &alen);
  port_ = ntohs(addr.sin_port);
  accept_thread_ = std::thread([this] { acceptLoop(); });
}

Server::~Server() { stop(); }

void Server::stop() {
  bool expected = false;
  if (!stopping_.compare_exchange_strong(expected, true)) return;
  if (listen_fd_ >= 0) {
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    listen_fd_ = -1;
  }
  if (accept_thread_.joinable()) accept_thread_.join();
  std::map<int, std::thread> remaining;
  {
    // unblock connection threads stuck in read() on live clients
    std::lock_guard<std::mutex> g(conn_mu_);
    reapFinishedLocked();
    for (auto &kv : conns_) ::shutdown(kv.first, SHUT_RDWR);
    remaining.swap(conns_);
  }
  for (auto &kv : remaining)
    if (kv.second.joinable()) kv.second.join();
}

void Server::reapFinishedLocked() {
  for (int fd : finished_fds_) {
    auto it = conns_.find(fd);
    if (it != conns_.end()) {
      if (it->second.joinable()) it->second.join();
      conns_.erase(it);
    }
  }
  finished_fds_.clear();
}

void Server::acceptLoop() {
  while (!stopping_.load()) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) break;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::lock_guard<std::mutex> g(conn_mu_);
    reapFinishedLocked();  // bound dead-thread growth on busy servers
    conns_.emplace(fd, std::thread([this, fd] { serveConn(fd); }));
  }
}

void Server::serveConn(int fd) {
  std::vector<uint8_t> payload;
  uint32_t opcode;
  while (!stopping_.load() && recvFrame(fd, &opcode, &payload)) {
    Reader r(payload.data(), payload.size());
    Writer w;
    handler_(opcode, r, w);
    if (!sendFrame(fd, opcode, w.buf.data(), w.buf.size())) break;
  }
  {
    // mark finished BEFORE close: the fd number can be reused by a new
    // accept the moment it closes, and the reaper must find this entry
    std::lock_guard<std::mutex> g(conn_mu_);
    finished_fds_.push_back(fd);
  }
  ::close(fd);
}

Client::Client(const std::string &host, int port) {
  fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd_ < 0) return;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (host.empty() || host == "localhost" || host == "127.0.0.1")
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  else if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(fd_);
    fd_ = -1;
    return;
  }
  if (::connect(fd_, reinterpret_cast<sockaddr *>(&addr),
                sizeof(addr)) != 0) {
    ::close(fd_);
    fd_ = -1;
    return;
  }
  int one = 1;
  setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

Client::~Client() {
  if (fd_ >= 0) ::close(fd_);
}

bool Client::call(uint32_t opcode, const Writer &req,
                  std::vector<uint8_t> *resp) {
  if (fd_ < 0) return false;
  if (!sendFrame(fd_, opcode, req.buf.data(), req.buf.size())) return false;
  uint32_t op2;
  return recvFrame(fd_, &op2, resp) && op2 == opcode;
}

}  // namespace ptrt
