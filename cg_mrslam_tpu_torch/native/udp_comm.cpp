// Native UDP datagram transport for the inter-robot exchange (the port's
// own copy of cg_mrslam_tpu/native/udp_comm.cpp).
//
// The reference's communication runtime (graph_comm.cpp): one bound UDP
// socket per robot process (graph_comm.cpp:31-53), a receiver thread that
// drains recvfrom into a mutex-guarded queue (the receiveFromThrd /
// processQueueThrd split, graph_comm.cpp:156-208), and fire-and-forget
// sendto (graph_comm.cpp:103-122). The C ABI is loaded with ctypes by
// mr/transport.py, which owns the addressing and the wire codec.
//
// Differences from the JAX package's copy: the socket does not set
// SO_REUSEADDR (on Linux two sockets that both set it bind the same UDP
// port and split its datagrams between them silently; here the second bind
// fails), and a failed create or send returns -errno so the caller can
// raise with the reason.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (native/__init__.py).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxDatagram = 100000;  // msg_factory.h:115 wire bound

struct Datagram {
  std::vector<uint8_t> data;
  uint32_t src_ip;
  uint16_t src_port;
};

struct Comm {
  int fd = -1;
  std::thread rx;
  std::mutex mu;
  std::deque<Datagram> queue;
  std::atomic<bool> stop{false};
  std::atomic<long> dropped{0};
  size_t max_queue = 4096;

  ~Comm() { close_all(); }

  void close_all() {
    stop.store(true);
    if (fd >= 0) {
      // shutdown unblocks the blocking recvfrom in the receiver thread
      ::shutdown(fd, SHUT_RDWR);
      ::close(fd);
      fd = -1;
    }
    if (rx.joinable()) rx.join();
  }

  void rx_loop() {
    std::vector<uint8_t> buf(kMaxDatagram);
    while (!stop.load()) {
      sockaddr_in src{};
      socklen_t slen = sizeof(src);
      ssize_t n = ::recvfrom(fd, buf.data(), buf.size(), 0,
                             reinterpret_cast<sockaddr*>(&src), &slen);
      if (n < 0) {
        if (stop.load()) break;
        continue;  // transient error; UDP is fire-and-forget
      }
      Datagram d;
      d.data.assign(buf.begin(), buf.begin() + n);
      d.src_ip = ntohl(src.sin_addr.s_addr);
      d.src_port = ntohs(src.sin_port);
      std::lock_guard<std::mutex> lk(mu);
      if (queue.size() >= max_queue) {
        queue.pop_front();  // oldest-first drop, counted; the protocol
        dropped.fetch_add(1);  // is idempotent under loss
      }
      queue.push_back(std::move(d));
    }
  }
};

std::mutex g_mu;
std::vector<std::unique_ptr<Comm>> g_comms;

Comm* get(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (h < 0 || h >= static_cast<int>(g_comms.size())) return nullptr;
  return g_comms[h].get();
}

}  // namespace

extern "C" {

// Bind a UDP socket on `port` (any interface) and start the receiver
// thread. Returns a handle >= 0, or -errno on failure.
int udp_create(int port) {
  auto c = std::make_unique<Comm>();
  c->fd = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (c->fd < 0) return -errno;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(c->fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    int err = errno;
    ::close(c->fd);
    c->fd = -1;
    return -err;
  }
  Comm* raw = c.get();
  raw->rx = std::thread([raw] { raw->rx_loop(); });
  std::lock_guard<std::mutex> lk(g_mu);
  g_comms.push_back(std::move(c));
  return static_cast<int>(g_comms.size()) - 1;
}

// Fire-and-forget datagram to ip:port. Returns the bytes sent, or -errno
// (-EINVAL for a bad handle, length or address).
int udp_send(int h, const char* ip, int port, const uint8_t* buf, int len) {
  Comm* c = get(h);
  if (!c || c->fd < 0 || len < 0 || len > kMaxDatagram) return -EINVAL;
  sockaddr_in dst{};
  dst.sin_family = AF_INET;
  dst.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, ip, &dst.sin_addr) != 1) return -EINVAL;
  ssize_t n = ::sendto(c->fd, buf, len, 0,
                       reinterpret_cast<sockaddr*>(&dst), sizeof(dst));
  return n < 0 ? -errno : static_cast<int>(n);
}

// Pop the oldest queued datagram into buf (capacity maxlen). Returns its
// length, 0 if the queue is empty, -1 on a bad handle or a datagram longer
// than maxlen (which is discarded).
int udp_recv(int h, uint8_t* buf, int maxlen, uint32_t* src_ip,
             uint16_t* src_port) {
  Comm* c = get(h);
  if (!c) return -1;
  Datagram d;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    if (c->queue.empty()) return 0;
    d = std::move(c->queue.front());
    c->queue.pop_front();
  }
  if (static_cast<int>(d.data.size()) > maxlen) return -1;
  std::memcpy(buf, d.data.data(), d.data.size());
  if (src_ip) *src_ip = d.src_ip;
  if (src_port) *src_port = d.src_port;
  return static_cast<int>(d.data.size());
}

// Number of datagrams waiting.
int udp_pending(int h) {
  Comm* c = get(h);
  if (!c) return -1;
  std::lock_guard<std::mutex> lk(c->mu);
  return static_cast<int>(c->queue.size());
}

// Datagrams dropped to queue overflow since creation.
long udp_dropped(int h) {
  Comm* c = get(h);
  return c ? c->dropped.load() : -1;
}

// Stop the receiver thread and close the socket. The handle stays
// allocated (small) so the indices of other comms stay valid.
void udp_close(int h) {
  Comm* c = get(h);
  if (c) c->close_all();
}

}  // extern "C"
