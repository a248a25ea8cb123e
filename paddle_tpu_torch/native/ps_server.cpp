// A verbatim copy of paddle_tpu/native/ps_server.cpp: host C++ (no device
// code), built for the port by paddle_tpu_torch/native/__init__.py.
//
// Native parameter server: TCP wire-compatible with
// paddle_tpu/distributed/ps/rpc.py (same length-prefixed binary
// protocol), hosting sharded sparse tables with per-shard locking and
// in-server optimizer updates.
//
// Capability analog of the reference's C++ PS runtime:
// operators/distributed/grpc/grpc_server.cc (transport),
// listen_and_serv_op.cc:127 RunSyncLoop (serve loop),
// large_scale_kv.h:160,255 SparseVariable/ValueBlock (sharded storage
// + per-block mutex), heart_beat_monitor.cc (worker liveness).
// The Python PSServer remains as the no-toolchain fallback; this
// server runs the data plane entirely outside the GIL.
//
// C ABI (ctypes): ps_start / ps_port / ps_running / ps_stop /
// ps_last_error.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum Op : uint8_t {
  OP_CREATE = 1,
  OP_PULL = 2,
  OP_PUSH = 3,
  OP_SIZE = 4,
  OP_STATE = 5,
  OP_LOAD = 6,
  OP_BARRIER = 7,
  OP_SHUTDOWN = 8,
  OP_HEARTBEAT = 9,
  OP_WORKER_STATUS = 10,
  OP_OK = 100,
  OP_ERR = 101,
};

constexpr int kShards = 8;

// ---------------------------------------------------------------- buffers

struct Reader {
  const uint8_t* p;
  size_t n, off = 0;
  Reader(const uint8_t* buf, size_t len) : p(buf), n(len) {}
  void need(size_t k) const {
    if (off + k > n) throw std::runtime_error("short payload");
  }
  template <typename T>
  T scalar() {
    need(sizeof(T));
    T v;
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }
  std::string str() {
    uint16_t ln = scalar<uint16_t>();
    need(ln);
    std::string s(reinterpret_cast<const char*>(p + off), ln);
    off += ln;
    return s;
  }
  bool more() const { return off < n; }
};

struct Writer {
  std::vector<uint8_t> buf;
  template <typename T>
  void scalar(T v) {
    size_t o = buf.size();
    buf.resize(o + sizeof(T));
    std::memcpy(buf.data() + o, &v, sizeof(T));
  }
  void str(const std::string& s) {
    scalar<uint16_t>(static_cast<uint16_t>(s.size()));
    raw(s.data(), s.size());
  }
  void raw(const void* p, size_t k) {
    size_t o = buf.size();
    buf.resize(o + k);
    std::memcpy(buf.data() + o, p, k);
  }
};

// numpy array header: dtype str, u8 ndim, i64 dims, raw data
struct Array {
  std::string dtype;
  std::vector<int64_t> shape;
  const uint8_t* data;
  size_t nbytes;
  int64_t numel() const {
    int64_t k = 1;
    for (auto d : shape) k *= d;
    return k;
  }
};

size_t itemsize(const std::string& dt) {
  if (dt == "float32" || dt == "int32" || dt == "uint32") return 4;
  if (dt == "float64" || dt == "int64" || dt == "uint64") return 8;
  if (dt == "int16" || dt == "uint16") return 2;
  if (dt == "int8" || dt == "uint8" || dt == "bool") return 1;
  throw std::runtime_error("unsupported dtype " + dt);
}

Array read_array(Reader& r) {
  Array a;
  a.dtype = r.str();
  uint8_t nd = r.scalar<uint8_t>();
  for (int i = 0; i < nd; i++) a.shape.push_back(r.scalar<int64_t>());
  a.nbytes = static_cast<size_t>(a.numel()) * itemsize(a.dtype);
  r.need(a.nbytes);
  a.data = r.p + r.off;
  r.off += a.nbytes;
  return a;
}

void write_array_f32(Writer& w, const float* data,
                     const std::vector<int64_t>& shape) {
  w.str("float32");
  w.scalar<uint8_t>(static_cast<uint8_t>(shape.size()));
  int64_t k = 1;
  for (auto d : shape) {
    w.scalar<int64_t>(d);
    k *= d;
  }
  w.raw(data, static_cast<size_t>(k) * 4);
}

std::vector<int64_t> ids_as_i64(const Array& a) {
  std::vector<int64_t> out(a.numel());
  if (a.dtype == "int64") {
    std::memcpy(out.data(), a.data, a.nbytes);
  } else if (a.dtype == "int32") {
    const int32_t* p = reinterpret_cast<const int32_t*>(a.data);
    for (int64_t i = 0; i < a.numel(); i++) out[i] = p[i];
  } else {
    throw std::runtime_error("ids must be int32/int64, got " + a.dtype);
  }
  return out;
}

// ---------------------------------------------------------------- table

struct Table {
  int64_t dim;
  double lr;
  bool adagrad;
  bool zeros_init;
  std::unordered_map<int64_t, std::vector<float>> rows[kShards];
  std::unordered_map<int64_t, std::vector<float>> accum[kShards];
  std::mutex locks[kShards];
  std::mt19937 rng;
  std::normal_distribution<float> normal{0.0f, 1.0f};
  std::mutex rng_lock;

  Table(int64_t d, double l, bool ada, bool zeros, uint64_t seed)
      : dim(d), lr(l), adagrad(ada), zeros_init(zeros), rng(seed) {}

  static int shard_of(int64_t key) {
    int s = static_cast<int>(key % kShards);
    return s < 0 ? s + kShards : s;
  }

  std::vector<float> fresh_row() {
    std::vector<float> row(dim, 0.0f);
    if (!zeros_init) {
      std::lock_guard<std::mutex> g(rng_lock);
      for (auto& v : row) v = normal(rng) * 0.01f;
    }
    return row;
  }

  void pull(const std::vector<int64_t>& ids, float* out) {
    for (size_t i = 0; i < ids.size(); i++) {
      int s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(locks[s]);
      auto it = rows[s].find(ids[i]);
      if (it == rows[s].end())
        it = rows[s].emplace(ids[i], fresh_row()).first;
      std::memcpy(out + i * dim, it->second.data(), dim * 4);
    }
  }

  void push(const std::vector<int64_t>& ids, const float* grads) {
    // combine duplicate ids (scatter-add), then one update per row —
    // matches sparse_table.py push()
    std::map<int64_t, std::vector<float>> combined;
    for (size_t i = 0; i < ids.size(); i++) {
      auto& g = combined[ids[i]];
      if (g.empty()) g.assign(dim, 0.0f);
      const float* src = grads + i * dim;
      for (int64_t j = 0; j < dim; j++) g[j] += src[j];
    }
    for (auto& kv : combined) {
      int s = shard_of(kv.first);
      std::lock_guard<std::mutex> g(locks[s]);
      auto it = rows[s].find(kv.first);
      if (it == rows[s].end()) continue;  // un-pulled rows are skipped
      float* row = it->second.data();
      const float* grad = kv.second.data();
      if (adagrad) {
        auto& acc = accum[s][kv.first];
        if (acc.empty()) acc.assign(dim, 0.0f);
        for (int64_t j = 0; j < dim; j++) {
          acc[j] += grad[j] * grad[j];
          row[j] -= static_cast<float>(lr) * grad[j] /
                    (std::sqrt(acc[j]) + 1e-6f);
        }
      } else {
        for (int64_t j = 0; j < dim; j++)
          row[j] -= static_cast<float>(lr) * grad[j];
      }
    }
  }

  int64_t size() {
    int64_t n = 0;
    for (int s = 0; s < kShards; s++) {
      std::lock_guard<std::mutex> g(locks[s]);
      n += static_cast<int64_t>(rows[s].size());
    }
    return n;
  }
};

// ---------------------------------------------------------------- server

struct Server {
  int listen_fd = -1;
  int port = 0;
  int server_index = 0;
  int num_servers = 1;
  std::atomic<bool> running{true};
  std::thread accept_thread;
  // live connection registry: stop() force-closes every fd so no
  // detached handler thread can outlive the Server (use-after-free
  // guard); active_conns gates the final delete in ps_stop
  std::mutex conns_lock;
  std::unordered_map<int, int> conn_fds;  // fd -> fd (set)
  std::atomic<int> active_conns{0};
  std::mutex tables_lock;
  std::unordered_map<std::string, std::unique_ptr<Table>> tables;
  // barrier
  std::mutex barrier_lock;
  std::condition_variable barrier_cv;
  int64_t barrier_count = 0;
  int64_t barrier_gen = 0;
  // heartbeats
  std::mutex hb_lock;
  std::unordered_map<int64_t, std::chrono::steady_clock::time_point>
      heartbeats;
  double heartbeat_timeout = 30.0;

  Table& table(const std::string& name) {
    std::lock_guard<std::mutex> g(tables_lock);
    auto it = tables.find(name);
    if (it == tables.end())
      throw std::runtime_error("table '" + name +
                               "' not created on server " +
                               std::to_string(server_index) +
                               " (call create first)");
    return *it->second;
  }

  // returns false when the connection should close (shutdown)
  bool dispatch(uint8_t op, Reader& r, Writer& w) {
    switch (op) {
      case OP_CREATE: {
        std::string name = r.str();
        int64_t dim = r.scalar<int64_t>();
        double lr = r.scalar<double>();
        std::string optimizer = r.str();
        std::string init = r.more() ? r.str() : "random";
        std::lock_guard<std::mutex> g(tables_lock);
        if (!tables.count(name)) {
          uint64_t seed = std::hash<std::string>{}(name) & 0x7fffffff;
          tables[name] = std::make_unique<Table>(
              dim, lr, optimizer == "adagrad", init == "zeros", seed);
        }
        return true;
      }
      case OP_PULL: {
        std::string name = r.str();
        Array ids_a = read_array(r);
        auto ids = ids_as_i64(ids_a);
        Table& t = table(name);
        std::vector<float> out(ids.size() * t.dim);
        t.pull(ids, out.data());
        std::vector<int64_t> shape = ids_a.shape;
        shape.push_back(t.dim);
        write_array_f32(w, out.data(), shape);
        return true;
      }
      case OP_PUSH: {
        std::string name = r.str();
        Array ids_a = read_array(r);
        Array grads = read_array(r);
        if (grads.dtype != "float32")
          throw std::runtime_error("grads must be float32");
        auto ids = ids_as_i64(ids_a);
        Table& t = table(name);
        if (grads.numel() != static_cast<int64_t>(ids.size()) * t.dim)
          throw std::runtime_error("grads shape mismatch");
        t.push(ids, reinterpret_cast<const float*>(grads.data));
        return true;
      }
      case OP_SIZE: {
        std::string name = r.str();
        w.scalar<int64_t>(table(name).size());
        return true;
      }
      case OP_STATE: {
        std::string name = r.str();
        Table& t = table(name);
        // snapshot under shard locks; accumulators ride as "a:<key>"
        // entries (keeps restored adagrad step sizes decayed)
        std::vector<std::pair<std::string, std::vector<float>>> all;
        for (int s = 0; s < kShards; s++) {
          std::lock_guard<std::mutex> g(t.locks[s]);
          for (auto& kv : t.rows[s])
            all.emplace_back(std::to_string(kv.first), kv.second);
          for (auto& kv : t.accum[s])
            all.emplace_back("a:" + std::to_string(kv.first),
                             kv.second);
        }
        w.scalar<int64_t>(static_cast<int64_t>(all.size()));
        std::vector<int64_t> shape{t.dim};
        for (auto& kv : all) {
          w.str(kv.first);
          write_array_f32(w, kv.second.data(), shape);
        }
        return true;
      }
      case OP_LOAD: {
        std::string name = r.str();
        int64_t n = r.scalar<int64_t>();
        Table& t = table(name);
        for (int64_t i = 0; i < n; i++) {
          std::string key_s = r.str();
          bool is_accum = key_s.rfind("a:", 0) == 0;
          int64_t key = std::stoll(is_accum ? key_s.substr(2) : key_s);
          Array v = read_array(r);
          if (v.dtype != "float32")
            throw std::runtime_error("state rows must be float32");
          std::vector<float> row(
              reinterpret_cast<const float*>(v.data),
              reinterpret_cast<const float*>(v.data) + v.numel());
          int s = Table::shard_of(key);
          std::lock_guard<std::mutex> g(t.locks[s]);
          (is_accum ? t.accum[s] : t.rows[s])[key] = std::move(row);
        }
        return true;
      }
      case OP_BARRIER: {
        int64_t expected = r.scalar<int64_t>();
        std::unique_lock<std::mutex> g(barrier_lock);
        barrier_count++;
        if (barrier_count >= expected) {
          barrier_count = 0;
          barrier_gen++;
          barrier_cv.notify_all();
          w.scalar<uint8_t>(1);
          return true;
        }
        int64_t gen = barrier_gen;
        bool ok = barrier_cv.wait_for(
            g, std::chrono::seconds(60),
            [&] { return gen != barrier_gen; });
        // timed-out waiter rolls back its arrival so a later round
        // can't release early with fewer real participants (wire
        // parity with rpc.py's python server)
        if (!ok && gen == barrier_gen && barrier_count > 0) {
          barrier_count--;
        }
        w.scalar<uint8_t>(ok ? 1 : 0);
        return true;
      }
      case OP_HEARTBEAT: {
        int64_t wid = r.scalar<int64_t>();
        std::lock_guard<std::mutex> g(hb_lock);
        heartbeats[wid] = std::chrono::steady_clock::now();
        return true;
      }
      case OP_WORKER_STATUS: {
        double timeout = heartbeat_timeout;
        if (r.more()) {
          double t = r.scalar<double>();
          if (t > 0) timeout = t;
        }
        auto now = std::chrono::steady_clock::now();
        std::string json = "{";
        {
          std::lock_guard<std::mutex> g(hb_lock);
          bool first = true;
          for (auto& kv : heartbeats) {
            double age =
                std::chrono::duration<double>(now - kv.second).count();
            char item[128];
            std::snprintf(item, sizeof(item),
                          "%s\"%lld\": {\"age_sec\": %.3f, "
                          "\"alive\": %s}",
                          first ? "" : ", ",
                          static_cast<long long>(kv.first), age,
                          age < timeout ? "true" : "false");
            json += item;
            first = false;
          }
        }
        json += "}";
        w.raw(json.data(), json.size());
        return true;
      }
      case OP_SHUTDOWN:
        return false;
      default:
        throw std::runtime_error("unknown PS op " + std::to_string(op));
    }
  }

  void stop() {
    running = false;
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
      listen_fd = -1;
    }
    // unblock any parked barrier waiters
    {
      std::lock_guard<std::mutex> g(barrier_lock);
      barrier_gen++;
    }
    barrier_cv.notify_all();
    // kick every handler thread out of recv()
    std::lock_guard<std::mutex> g(conns_lock);
    for (auto& kv : conn_fds) ::shutdown(kv.first, SHUT_RDWR);
  }
};

bool recv_exact(int fd, uint8_t* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t k = ::recv(fd, buf + got, n - got, 0);
    if (k <= 0) return false;
    got += static_cast<size_t>(k);
  }
  return true;
}

bool send_all(int fd, const uint8_t* buf, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t k = ::send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
    if (k <= 0) return false;
    sent += static_cast<size_t>(k);
  }
  return true;
}

bool send_msg(int fd, uint8_t op, const uint8_t* payload, size_t n) {
  uint8_t hdr[5];
  hdr[0] = op;
  uint32_t ln = static_cast<uint32_t>(n);
  std::memcpy(hdr + 1, &ln, 4);
  if (!send_all(fd, hdr, 5)) return false;
  return n == 0 || send_all(fd, payload, n);
}

void serve_connection(Server* srv, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<uint8_t> payload;
  while (srv->running) {
    uint8_t hdr[5];
    if (!recv_exact(fd, hdr, 5)) break;
    uint8_t op = hdr[0];
    uint32_t ln;
    std::memcpy(&ln, hdr + 1, 4);
    payload.resize(ln);
    if (ln && !recv_exact(fd, payload.data(), ln)) break;
    Writer w;
    bool keep = true;
    try {
      Reader r(payload.data(), payload.size());
      keep = srv->dispatch(op, r, w);
      if (w.buf.size() > 0xFFFFFFFFull)
        throw std::runtime_error(
            "response exceeds the 4 GiB wire limit; snapshot the "
            "table in chunks");
    } catch (const std::exception& e) {
      std::string msg = e.what();
      if (!send_msg(fd, OP_ERR,
                    reinterpret_cast<const uint8_t*>(msg.data()),
                    msg.size()))
        break;
      continue;
    }
    if (!send_msg(fd, OP_OK, w.buf.data(), w.buf.size())) break;
    if (!keep) {  // shutdown: ack already sent
      srv->stop();
      break;
    }
  }
  ::close(fd);
  {
    std::lock_guard<std::mutex> g(srv->conns_lock);
    srv->conn_fds.erase(fd);
  }
  srv->active_conns--;
}

void accept_loop(Server* srv) {
  while (srv->running) {
    int fd = ::accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (!srv->running) break;
      continue;
    }
    {
      std::lock_guard<std::mutex> g(srv->conns_lock);
      srv->conn_fds[fd] = fd;
    }
    srv->active_conns++;
    std::thread(serve_connection, srv, fd).detach();
  }
}

thread_local std::string g_last_error;

}  // namespace

extern "C" {

const char* ps_last_error() { return g_last_error.c_str(); }

void* ps_start(const char* host, int port, int server_index,
               int num_servers) {
  auto srv = std::make_unique<Server>();
  srv->server_index = server_index;
  srv->num_servers = num_servers;
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    g_last_error = "socket() failed";
    return nullptr;
  }
  int one = 1;
  ::setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one,
               sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    // hostname endpoint (localhost, ps-node-0): resolve via getaddrinfo
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) {
      g_last_error = std::string("cannot resolve host ") + host;
      ::close(srv->listen_fd);
      if (res) ::freeaddrinfo(res);
      return nullptr;
    }
    addr.sin_addr =
        reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    ::freeaddrinfo(res);
  }
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(srv->listen_fd, 128) != 0) {
    g_last_error = std::string("bind/listen failed on ") + host + ":" +
                   std::to_string(port);
    ::close(srv->listen_fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr),
                &alen);
  srv->port = ntohs(addr.sin_port);
  srv->accept_thread = std::thread(accept_loop, srv.get());
  return srv.release();
}

int ps_port(void* h) { return static_cast<Server*>(h)->port; }

int ps_running(void* h) {
  return static_cast<Server*>(h)->running ? 1 : 0;
}

void ps_stop(void* h) {
  Server* srv = static_cast<Server*>(h);
  srv->stop();
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  // stop() force-closed every connection fd, so handlers drain fast;
  // wait for them (bounded) before freeing the Server they reference
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(10);
  while (srv->active_conns.load() > 0 &&
         std::chrono::steady_clock::now() < deadline) {
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  }
  if (srv->active_conns.load() == 0) {
    delete srv;
  }
  // else: leak rather than free under a live thread (can't happen
  // unless a handler wedged outside recv/send for 10s)
}

}  // extern "C"
