// Shared-memory object store of the port's runtime ("plasma" equivalent).
//
// Role of the reference's Plasma store (ray: src/ray/object_manager/plasma/
// store.h:55, client.cc, protocol over Unix socket + fd passing fling.cc):
// a per-node immutable object store in shared memory so every worker process
// on the node reads object payloads zero-copy.  Payloads are the flat
// SerializedObject wire format, so a worker wraps a stored numpy array or
// tensor buffer without copies (mmap -> a view; a CUDA tensor is one
// host-to-device copy from the mapping).
//
// Design (not a translation of plasma):
//   * one shm arena per node created with memfd_create, passed to clients
//     over SCM_RIGHTS during the socket handshake (like plasma's fling.cc,
//     but a single arena instead of per-object mmaps)
//   * server-side first-fit free-list allocator with coalescing (plasma
//     vendors dlmalloc; an in-server allocator keeps all metadata private)
//   * thread-per-connection control plane guarded by one mutex + condvar;
//     the data plane never touches the server (clients read/write the
//     mapped arena directly)
//   * objects are PRIMARY (owner payload: never auto-evicted, listed for
//     disk spilling like raylet/local_object_manager.h:41) or CACHE
//     (remote-fetch copies: LRU auto-evicted under memory pressure like
//     plasma/eviction_policy.cc)
//   * per-connection reference counts; a dying client auto-releases
//     (plasma client disconnect semantics)
//
// Exposed as a C API (rtps_*) for ctypes binding from Python
// (ray_tpu/_private/shm_store.py).

#define _GNU_SOURCE 1

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <iterator>
#include <stdexcept>
#include <string>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- protocol

constexpr uint64_t kMagic = 0x52545053484d3031ULL;  // "RTPSHM01"
constexpr uint64_t kAlign = 64;

enum Op : uint8_t {
  OP_CREATE = 1,
  OP_SEAL = 2,
  OP_GET = 3,
  OP_RELEASE = 4,
  OP_DELETE = 5,
  OP_CONTAINS = 6,
  OP_STATS = 7,
  OP_LIST = 8,   // a: max ids, b: 1 = spillable primaries, 0 = evictable caches
  OP_ABORT = 9,  // abort an unsealed create
  OP_FREE_INFO = 10,  // free-list shape: status=holes, offset=largest, size=total
};

enum Status : int64_t {
  ST_OK = 0,
  ST_FULL = -1,
  ST_EXISTS = -2,
  ST_NOT_FOUND = -3,
  ST_TIMEOUT = -4,
  ST_NOT_SEALED = -5,
  ST_ERR = -6,
};

struct Request {
  uint8_t op;
  uint8_t pad[7];
  uint8_t id[16];
  uint64_t a;  // CREATE: size, GET: timeout_ms (UINT64_MAX = infinite), LIST: max
  uint64_t b;  // CREATE: flags (1 = primary), LIST: 1 = primaries
};

struct Response {
  int64_t status;
  uint64_t offset;
  uint64_t size;
};

struct ObjectId {
  uint8_t b[16];
  bool operator==(const ObjectId& o) const { return memcmp(b, o.b, 16) == 0; }
};

struct IdHash {
  size_t operator()(const ObjectId& id) const {
    uint64_t h;
    memcpy(&h, id.b, 8);
    return static_cast<size_t>(h * 0x9E3779B97F4A7C15ULL);
  }
};

bool ReadFull(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteFull(int fd, const void* buf, size_t n) {
  const auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Send the arena fd + capacity in one message (SCM_RIGHTS, cf. plasma fling.cc).
bool SendHandshake(int sock, int arena_fd, uint64_t capacity) {
  uint64_t payload[2] = {kMagic, capacity};
  struct iovec iov = {payload, sizeof(payload)};
  char cmsgbuf[CMSG_SPACE(sizeof(int))];
  memset(cmsgbuf, 0, sizeof(cmsgbuf));
  struct msghdr msg;
  memset(&msg, 0, sizeof(msg));
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  msg.msg_control = cmsgbuf;
  msg.msg_controllen = sizeof(cmsgbuf);
  struct cmsghdr* cmsg = CMSG_FIRSTHDR(&msg);
  cmsg->cmsg_level = SOL_SOCKET;
  cmsg->cmsg_type = SCM_RIGHTS;
  cmsg->cmsg_len = CMSG_LEN(sizeof(int));
  memcpy(CMSG_DATA(cmsg), &arena_fd, sizeof(int));
  // MSG_NOSIGNAL: the peer may already be gone (e.g. Stop()'s throwaway
  // wake connection) — surface EPIPE as a failed handshake, not SIGPIPE.
  return sendmsg(sock, &msg, MSG_NOSIGNAL) == sizeof(payload);
}

bool RecvHandshake(int sock, int* arena_fd, uint64_t* capacity) {
  uint64_t payload[2] = {0, 0};
  struct iovec iov = {payload, sizeof(payload)};
  char cmsgbuf[CMSG_SPACE(sizeof(int))];
  struct msghdr msg;
  memset(&msg, 0, sizeof(msg));
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  msg.msg_control = cmsgbuf;
  msg.msg_controllen = sizeof(cmsgbuf);
  if (recvmsg(sock, &msg, 0) != sizeof(payload)) return false;
  if (payload[0] != kMagic) return false;
  struct cmsghdr* cmsg = CMSG_FIRSTHDR(&msg);
  if (cmsg == nullptr || cmsg->cmsg_type != SCM_RIGHTS) return false;
  memcpy(arena_fd, CMSG_DATA(cmsg), sizeof(int));
  *capacity = payload[1];
  return true;
}

// ---------------------------------------------------------------- allocator

// First-fit free list with coalescing over arena offsets.
class Arena {
 public:
  explicit Arena(uint64_t capacity) : capacity_(capacity) {
    free_[0] = capacity;
  }

  // Returns false if no contiguous block fits.
  bool Alloc(uint64_t size, uint64_t* offset) {
    uint64_t need = (size + kAlign - 1) & ~(kAlign - 1);
    if (need == 0) need = kAlign;
    for (auto it = free_.begin(); it != free_.end(); ++it) {
      if (it->second >= need) {
        *offset = it->first;
        uint64_t rem = it->second - need;
        uint64_t tail = it->first + need;
        free_.erase(it);
        if (rem > 0) free_[tail] = rem;
        used_ += need;
        sizes_[*offset] = need;
        return true;
      }
    }
    return false;
  }

  void Free(uint64_t offset) {
    auto sit = sizes_.find(offset);
    if (sit == sizes_.end()) return;
    uint64_t size = sit->second;
    sizes_.erase(sit);
    used_ -= size;
    auto it = free_.emplace(offset, size).first;
    // Coalesce with next block.
    auto next = std::next(it);
    if (next != free_.end() && it->first + it->second == next->first) {
      it->second += next->second;
      free_.erase(next);
    }
    // Coalesce with previous block.
    if (it != free_.begin()) {
      auto prev = std::prev(it);
      if (prev->first + prev->second == it->first) {
        prev->second += it->second;
        free_.erase(it);
      }
    }
  }

  uint64_t used() const { return used_; }
  uint64_t capacity() const { return capacity_; }

  // Free-list shape for fragmentation accounting: a put needs ONE
  // contiguous hole, so `largest` (not the total) bounds the biggest
  // allocatable object.
  void FreeInfo(uint64_t* holes, uint64_t* largest, uint64_t* total) const {
    for (const auto& kv : free_) {
      ++*holes;
      *total += kv.second;
      if (kv.second > *largest) *largest = kv.second;
    }
  }

 private:
  uint64_t capacity_;
  uint64_t used_ = 0;
  std::map<uint64_t, uint64_t> free_;             // offset -> size
  std::unordered_map<uint64_t, uint64_t> sizes_;  // offset -> allocated size
};

// ------------------------------------------------------------------ server

struct ObjectEntry {
  uint64_t offset = 0;
  uint64_t size = 0;
  bool sealed = false;
  bool primary = false;
  bool pending_delete = false;
  int creator_conn = -1;  // connection that created it (for abort-on-death)
  uint64_t refcount = 0;  // across all connections
  uint64_t lru_tick = 0;  // last-touched tick for CACHE eviction order
};

class StoreServer {
 public:
  StoreServer(const char* socket_path, uint64_t capacity)
      : path_(socket_path), arena_(capacity) {
    arena_fd_ = memfd_create("ray_tpu_store", MFD_CLOEXEC);
    if (arena_fd_ < 0) throw std::runtime_error("memfd_create failed");
    if (ftruncate(arena_fd_, static_cast<off_t>(capacity)) != 0) {
      close(arena_fd_);
      throw std::runtime_error("ftruncate failed");
    }
    base_ = static_cast<uint8_t*>(mmap(nullptr, capacity,
                                       PROT_READ | PROT_WRITE, MAP_SHARED,
                                       arena_fd_, 0));
    if (base_ == MAP_FAILED) {
      close(arena_fd_);
      throw std::runtime_error("mmap failed");
    }

    listen_fd_ = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (listen_fd_ < 0) throw std::runtime_error("socket failed");
    struct sockaddr_un addr;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", socket_path);
    unlink(socket_path);
    if (bind(listen_fd_, reinterpret_cast<struct sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
        listen(listen_fd_, 128) != 0) {
      close(listen_fd_);
      throw std::runtime_error("bind/listen failed");
    }
    accept_thread_ = std::thread([this] { AcceptLoop(); });

    // Opt-in whole-arena pre-fault (RT_STORE_PREFAULT=1): see
    // StoreClient::Prefault for why this must never be the default --
    // populating the full capacity on every cluster init melts a test
    // farm of short-lived clusters.
#ifdef MADV_POPULATE_WRITE
    const char* pf = getenv("RT_STORE_PREFAULT");
    if (pf != nullptr && strcmp(pf, "1") == 0) {
      uint64_t cap = arena_.capacity();
      prefault_thread_ = std::thread([this, cap] {
        madvise(base_, cap, MADV_POPULATE_WRITE);
      });
    }
#endif
  }

  ~StoreServer() { Stop(); }

  void Stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) return;
    // Wake a blocked accept4 with a throwaway self-connect BEFORE tearing
    // the listen socket down: on some kernels (gVisor/runsc sandboxes)
    // neither shutdown() nor close() of a listening unix socket wakes a
    // blocked accept, and the join below would hang the host process
    // forever. The connect completes against the backlog regardless of
    // whether accept ever returns it; AcceptLoop re-checks stopping_
    // before blocking again.
    int wake_fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (wake_fd >= 0) {
      struct sockaddr_un wake_addr;
      memset(&wake_addr, 0, sizeof(wake_addr));
      wake_addr.sun_family = AF_UNIX;
      snprintf(wake_addr.sun_path, sizeof(wake_addr.sun_path), "%s",
               path_.c_str());
      connect(wake_fd, reinterpret_cast<struct sockaddr*>(&wake_addr),
              sizeof(wake_addr));
      close(wake_fd);
    }
    shutdown(listen_fd_, SHUT_RDWR);
    close(listen_fd_);
    unlink(path_.c_str());
    {
      std::lock_guard<std::mutex> g(mu_);
      for (int fd : conn_fds_) shutdown(fd, SHUT_RDWR);
      cv_.notify_all();
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    if (prefault_thread_.joinable()) prefault_thread_.join();
    std::vector<std::unique_ptr<Conn>> conns;
    {
      std::lock_guard<std::mutex> g(mu_);
      conns.swap(conn_threads_);
    }
    for (auto& c : conns) {
      if (c->thread.joinable()) c->thread.join();
    }
    munmap(base_, arena_.capacity());
    close(arena_fd_);
  }

 private:
  void AcceptLoop() {
    int conn_id = 0;
    while (!stopping_.load()) {
      int fd = accept4(listen_fd_, nullptr, nullptr, SOCK_CLOEXEC);
      if (fd < 0) {
        if (errno == EINTR) continue;
        break;  // listen socket closed => shutting down
      }
      if (!SendHandshake(fd, arena_fd_, arena_.capacity())) {
        close(fd);
        continue;
      }
      try {
        RegisterConn(fd, conn_id++);
      } catch (...) {
        // Allocation failure under host memory pressure: refuse the
        // connection rather than std::terminate the host process.
        close(fd);
      }
    }
  }

  void RegisterConn(int fd, int id) {
    std::lock_guard<std::mutex> g(mu_);
    // Stop() may have run between accept4 and here; registering now
    // would miss its shutdown pass and leave a Serve thread blocked in
    // read() forever (deadlocking Stop's join).
    if (stopping_.load()) {
      close(fd);
      return;
    }
    ReapFinishedLocked();
    conn_fds_.push_back(fd);
    Conn* c = nullptr;
    try {
      conn_threads_.emplace_back(new Conn{std::thread(), {false}});
      c = conn_threads_.back().get();
    } catch (...) {
      // Roll the fd registration back before rethrowing to AcceptLoop's
      // close(fd): a registered-but-threadless fd would later have
      // Stop() shutdown() a possibly-reused descriptor number.
      conn_fds_.erase(
          std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
          conn_fds_.end());
      throw;
    }
    try {
      c->thread = std::thread([this, fd, id, c] {
      // An exception escaping a thread body is std::terminate — and
      // this store runs INSIDE the raylet host process, so that
      // would abort the whole node (seen once as a pytest SIGABRT
      // under the OOM-killer tests' memory pressure: bad_alloc in a
      // map insert). Drop the connection instead; the client sees a
      // closed socket and its pins auto-release.
      try {
        Serve(fd, id);
      } catch (...) {
        // Serve's own Cleanup closes the fd on every unwind path; if
        // even Cleanup threw, fd ownership is ambiguous — leak the
        // descriptor rather than risk closing a reused one.
      }
      c->done.store(true);
      });
    } catch (...) {
      conn_threads_.pop_back();
      conn_fds_.erase(
          std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
          conn_fds_.end());
      throw;
    }
  }

  // Join threads whose Serve() has exited (bounds conn_threads_ growth under
  // connection churn). Caller holds mu_.
  void ReapFinishedLocked() {
    for (auto it = conn_threads_.begin(); it != conn_threads_.end();) {
      if ((*it)->done.load()) {
        if ((*it)->thread.joinable()) (*it)->thread.join();
        it = conn_threads_.erase(it);
      } else {
        ++it;
      }
    }
  }

  void Serve(int fd, int conn_id) {
    std::unordered_map<ObjectId, uint64_t, IdHash> held;  // id -> refs
    ServeLoop(fd, conn_id, &held);
    Cleanup(fd, conn_id, held);
  }

  // The request loop, separated so an exception (bad_alloc under host
  // memory pressure) unwinds into Serve's cleanup instead of
  // std::terminate-ing the host process.
  void ServeLoop(int fd, int conn_id,
                 std::unordered_map<ObjectId, uint64_t, IdHash>* held_p) {
    auto& held = *held_p;
    Request req;
    try {
    while (ReadFull(fd, &req, sizeof(req))) {
      Response rsp = {ST_ERR, 0, 0};
      std::vector<uint8_t> extra;
      ObjectId id;
      memcpy(id.b, req.id, 16);
      switch (req.op) {
        case OP_CREATE:
          rsp = Create(id, req.a, req.b, conn_id, &held);
          break;
        case OP_SEAL:
          rsp = Seal(id);
          break;
        case OP_GET:
          rsp = Get(id, req.a, &held);
          break;
        case OP_RELEASE:
          rsp = Release(id, &held);
          break;
        case OP_DELETE:
          rsp = Delete(id);
          break;
        case OP_ABORT:
          rsp = Abort(id, &held);
          break;
        case OP_CONTAINS: {
          std::lock_guard<std::mutex> g(mu_);
          auto it = objects_.find(id);
          rsp.status =
              (it != objects_.end() && it->second.sealed) ? ST_OK : ST_NOT_FOUND;
          if (rsp.status == ST_OK) rsp.size = it->second.size;
          break;
        }
        case OP_STATS: {
          std::lock_guard<std::mutex> g(mu_);
          rsp.status = static_cast<int64_t>(objects_.size());
          rsp.offset = arena_.used();
          rsp.size = arena_.capacity();
          break;
        }
        case OP_LIST:
          rsp = List(req.a, req.b != 0, &extra);
          break;
        case OP_FREE_INFO: {
          std::lock_guard<std::mutex> g(mu_);
          uint64_t holes = 0, largest = 0, total = 0;
          arena_.FreeInfo(&holes, &largest, &total);
          rsp.status = static_cast<int64_t>(holes);
          rsp.offset = largest;
          rsp.size = total;
          break;
        }
        default:
          rsp.status = ST_ERR;
      }
      if (!WriteFull(fd, &rsp, sizeof(rsp))) break;
      if (!extra.empty() && !WriteFull(fd, extra.data(), extra.size())) break;
    }
    } catch (...) {
      // bad_alloc under host memory pressure mid-request: fall through
      // to Cleanup with whatever `held` recorded so far.
    }
  }

  void Cleanup(int fd, int conn_id,
               std::unordered_map<ObjectId, uint64_t, IdHash>& held) {
    // Client died or disconnected: release everything it held, abort its
    // unsealed creates (plasma disconnect semantics).
    {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& kv : held) {
        auto it = objects_.find(kv.first);
        if (it == objects_.end()) continue;
        ObjectEntry& e = it->second;
        e.refcount -= std::min(e.refcount, kv.second);
        if (!e.sealed && e.creator_conn == conn_id) {
          arena_.Free(e.offset);
          objects_.erase(it);
        } else if (e.refcount == 0 && e.pending_delete) {
          arena_.Free(e.offset);
          objects_.erase(it);
        }
      }
      // Forget this connection's fd so Stop() never calls shutdown() on an
      // fd number the process may have reused for an unrelated socket.
      conn_fds_.erase(std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
                      conn_fds_.end());
      cv_.notify_all();
    }
    close(fd);
  }

  // Evict the single least-recently-used sealed, unreferenced CACHE object.
  // Returns false when none is evictable. Caller holds mu_.
  bool EvictOneCache() {
    ObjectId victim;
    uint64_t best_tick = UINT64_MAX;
    bool found = false;
    for (auto& kv : objects_) {
      ObjectEntry& e = kv.second;
      if (e.sealed && !e.primary && e.refcount == 0 && e.lru_tick < best_tick) {
        best_tick = e.lru_tick;
        victim = kv.first;
        found = true;
      }
    }
    if (!found) return false;
    auto it = objects_.find(victim);
    arena_.Free(it->second.offset);
    objects_.erase(it);
    return true;
  }

  Response Create(const ObjectId& id, uint64_t size, uint64_t flags,
                  int conn_id,
                  std::unordered_map<ObjectId, uint64_t, IdHash>* held) {
    std::lock_guard<std::mutex> g(mu_);
    if (objects_.count(id)) return {ST_EXISTS, 0, 0};
    uint64_t offset = 0;
    // Allocation needs a CONTIGUOUS block, so evicting "enough bytes" is not
    // enough under fragmentation: evict LRU caches one at a time (freed
    // neighbours coalesce) and retry until the block fits or nothing is left.
    while (!arena_.Alloc(size, &offset)) {
      if (!EvictOneCache()) return {ST_FULL, arena_.used(), size};
    }
    ObjectEntry e;
    e.offset = offset;
    e.size = size;
    e.primary = (flags & 1) != 0;
    e.creator_conn = conn_id;
    e.refcount = 1;  // creator holds a ref until release
    e.lru_tick = tick_++;
    objects_[id] = e;
    (*held)[id] += 1;
    return {ST_OK, offset, size};
  }

  Response Seal(const ObjectId& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return {ST_NOT_FOUND, 0, 0};
    it->second.sealed = true;
    cv_.notify_all();
    return {ST_OK, it->second.offset, it->second.size};
  }

  Response Get(const ObjectId& id, uint64_t timeout_ms,
               std::unordered_map<ObjectId, uint64_t, IdHash>* held) {
    std::unique_lock<std::mutex> lk(mu_);
    auto sealed = [&]() -> ObjectEntry* {
      auto it = objects_.find(id);
      return (it != objects_.end() && it->second.sealed) ? &it->second : nullptr;
    };
    ObjectEntry* e = sealed();
    if (e == nullptr && timeout_ms > 0) {
      auto pred = [&] { return stopping_.load() || sealed() != nullptr; };
      if (timeout_ms == UINT64_MAX) {
        cv_.wait(lk, pred);
      } else {
        cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
      }
      e = sealed();
    }
    if (e == nullptr) return {ST_TIMEOUT, 0, 0};
    e->refcount += 1;
    e->lru_tick = tick_++;
    (*held)[id] += 1;
    return {ST_OK, e->offset, e->size};
  }

  Response Release(const ObjectId& id,
                   std::unordered_map<ObjectId, uint64_t, IdHash>* held) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    auto hit = held->find(id);
    if (it == objects_.end() || hit == held->end()) return {ST_NOT_FOUND, 0, 0};
    if (--hit->second == 0) held->erase(hit);
    ObjectEntry& e = it->second;
    if (e.refcount > 0) e.refcount -= 1;
    if (e.refcount == 0 && e.pending_delete) {
      arena_.Free(e.offset);
      objects_.erase(it);
    }
    return {ST_OK, 0, 0};
  }

  Response Delete(const ObjectId& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return {ST_NOT_FOUND, 0, 0};
    ObjectEntry& e = it->second;
    if (e.refcount > 0) {
      e.pending_delete = true;
      return {ST_OK, 0, 1};  // size=1: deferred
    }
    arena_.Free(e.offset);
    objects_.erase(it);
    return {ST_OK, 0, 0};
  }

  Response Abort(const ObjectId& id,
                 std::unordered_map<ObjectId, uint64_t, IdHash>* held) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return {ST_NOT_FOUND, 0, 0};
    if (it->second.sealed) return {ST_ERR, 0, 0};
    arena_.Free(it->second.offset);
    objects_.erase(it);
    held->erase(id);
    return {ST_OK, 0, 0};
  }

  Response List(uint64_t max_ids, bool primaries, std::vector<uint8_t>* extra) {
    std::lock_guard<std::mutex> g(mu_);
    // Oldest-first so the spiller drains cold objects (LRU spill order).
    std::vector<std::pair<uint64_t, const ObjectId*>> order;
    for (auto& kv : objects_) {
      const ObjectEntry& e = kv.second;
      if (e.sealed && e.refcount == 0 && e.primary == primaries) {
        order.emplace_back(e.lru_tick, &kv.first);
      }
    }
    std::sort(order.begin(), order.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    uint64_t n = std::min<uint64_t>(order.size(), max_ids);
    extra->resize(n * 16);
    for (uint64_t i = 0; i < n; ++i) {
      memcpy(extra->data() + i * 16, order[i].second->b, 16);
    }
    return {static_cast<int64_t>(n), 0, 0};
  }

  struct Conn {
    std::thread thread;
    std::atomic<bool> done;
  };

  std::string path_;
  Arena arena_;
  int arena_fd_ = -1;
  uint8_t* base_ = nullptr;
  int listen_fd_ = -1;
  std::thread accept_thread_;
  std::thread prefault_thread_;
  std::vector<std::unique_ptr<Conn>> conn_threads_;
  std::vector<int> conn_fds_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::atomic<bool> stopping_{false};
  std::unordered_map<ObjectId, ObjectEntry, IdHash> objects_;
  uint64_t tick_ = 0;
};

// ------------------------------------------------------------------ client

class StoreClient {
 public:
  explicit StoreClient(const char* socket_path) {
    fd_ = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd_ < 0) throw std::runtime_error("socket failed");
    struct sockaddr_un addr;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", socket_path);
    if (connect(fd_, reinterpret_cast<struct sockaddr*>(&addr),
                sizeof(addr)) != 0) {
      close(fd_);
      throw std::runtime_error("connect failed");
    }
    int arena_fd = -1;
    if (!RecvHandshake(fd_, &arena_fd, &capacity_)) {
      close(fd_);
      throw std::runtime_error("handshake failed");
    }
    base_ = static_cast<uint8_t*>(
        mmap(nullptr, capacity_, PROT_READ | PROT_WRITE, MAP_SHARED,
             arena_fd, 0));
    close(arena_fd);
    if (base_ == MAP_FAILED) {
      close(fd_);
      throw std::runtime_error("client mmap failed");
    }
  }

  ~StoreClient() {
    CloseSocket();
    if (prefault_thread_.joinable()) prefault_thread_.join();
    if (base_ != MAP_FAILED && base_ != nullptr) munmap(base_, capacity_);
  }

  void CloseSocket() {
    std::lock_guard<std::mutex> g(mu_);
    if (fd_ >= 0) {
      close(fd_);
      fd_ = -1;
    }
  }

  int64_t Call(uint8_t op, const uint8_t id[16], uint64_t a, uint64_t b,
               uint64_t* offset, uint64_t* size, uint8_t* extra,
               uint64_t extra_cap) {
    std::lock_guard<std::mutex> g(mu_);
    Request req;
    memset(&req, 0, sizeof(req));
    req.op = op;
    if (id != nullptr) memcpy(req.id, id, 16);
    req.a = a;
    req.b = b;
    if (!WriteFull(fd_, &req, sizeof(req))) return ST_ERR;
    Response rsp;
    if (!ReadFull(fd_, &rsp, sizeof(rsp))) return ST_ERR;
    if (offset != nullptr) *offset = rsp.offset;
    if (size != nullptr) *size = rsp.size;
    if (op == OP_LIST && rsp.status > 0) {
      uint64_t want = static_cast<uint64_t>(rsp.status) * 16;
      if (want > extra_cap || !ReadFull(fd_, extra, want)) return ST_ERR;
    }
    return rsp.status;
  }

  // Fault the whole arena into THIS process's page table in the
  // background (opt-in: RT_STORE_PREFAULT=1). Zero-fill of fresh shmem
  // pages runs at ~1 GB/s on the CI host no matter how it is triggered,
  // so per-allocation populate cannot beat plain write faults; paying
  // the cost ONCE per long-lived process in the background is the only
  // real win (first big put then runs at memcpy speed). Default-off
  // because populating object_store_memory_bytes on every cluster init
  // melts a test farm that starts hundreds of short-lived clusters.
  // madvise-only: POPULATE_WRITE installs pages/PTEs without writing
  // data, so it cannot race live objects (a touch loop would).
  void Prefault() {
#ifdef MADV_POPULATE_WRITE
    bool expected = false;
    if (!prefault_started_.compare_exchange_strong(expected, true)) return;
    prefault_thread_ = std::thread([this] {
      madvise(base_, capacity_, MADV_POPULATE_WRITE);
    });
#endif
  }

  uint8_t* base() const { return base_; }
  uint64_t capacity() const { return capacity_; }

 private:
  int fd_ = -1;
  uint8_t* base_ = nullptr;
  uint64_t capacity_ = 0;
  std::mutex mu_;
  std::atomic<bool> prefault_started_{false};
  std::thread prefault_thread_;
};

// ------------------------------------------------------- SPSC shm channels
//
// Compiled-DAG actor->actor edges (reference: mutable shared-memory objects
// src/ray/core_worker/experimental_mutable_object_manager.h:37 and
// python/ray/experimental/channel/shared_memory_channel.py:157).  A channel
// region lives INSIDE a sealed store object, so discovery/cleanup rides the
// normal object lifecycle; all per-message synchronization is client-side
// atomics on the mapped arena — zero server round trips on the data path.
//
// Single-producer single-consumer ring: `write_seq` counts published
// messages, `read_seq` consumed ones.  The writer waits while the ring is
// full (write_seq - read_seq == n_slots), publishes with a release store;
// the reader waits for write_seq > read_seq with an acquire load, and
// releases the slot by bumping read_seq.  Waiting spins briefly then
// sleeps 50us per poll (channel latency stays ~us-scale, idle channels
// cost nothing measurable).

constexpr uint64_t kChanMagic = 0x525443484e303153ULL;  // "RTCHN0:S"

struct ChanHeader {
  uint64_t magic;
  uint64_t slot_size;
  uint64_t n_slots;
  alignas(64) std::atomic<uint64_t> write_seq;
  alignas(64) std::atomic<uint64_t> read_seq;
  alignas(64) std::atomic<uint64_t> closed;
};

constexpr uint64_t kChanHeaderSize =
    (sizeof(ChanHeader) + kAlign - 1) & ~(kAlign - 1);

// Each slot carries an 8-byte length prefix.
uint64_t ChanSlotStride(uint64_t slot_size) {
  return (slot_size + 8 + kAlign - 1) & ~(kAlign - 1);
}

ChanHeader* ChanAt(StoreClient* cli, uint64_t offset) {
  auto* h = reinterpret_cast<ChanHeader*>(cli->base() + offset);
  return (h->magic == kChanMagic) ? h : nullptr;
}

uint8_t* ChanSlot(StoreClient* cli, uint64_t offset, ChanHeader* h,
                  uint64_t seq) {
  return cli->base() + offset + kChanHeaderSize +
         (seq % h->n_slots) * ChanSlotStride(h->slot_size);
}

// Wait until pred() or deadline. timeout_ms UINT64_MAX = forever.
// Three phases: spin (cheap, catches back-to-back traffic), sched_yield
// (hands the core to the peer — on loaded single-core hosts nanosleep's
// ~50us timer slack would dominate every hop), then a capped sleep so an
// idle channel doesn't burn the CPU.
template <typename Pred>
bool ChanWait(uint64_t timeout_ms, Pred pred) {
  for (int i = 0; i < 1024; ++i) {
    if (pred()) return true;
#if defined(__x86_64__)
    __builtin_ia32_pause();
#endif
  }
  // A short yield phase hands the core to the peer; keeping it short
  // matters on loaded single-core hosts, where N polling processes
  // yield-spinning against each other would thrash the scheduler.
  for (int i = 0; i < 64; ++i) {
    if (pred()) return true;
    std::this_thread::yield();
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (!pred()) {
    if (timeout_ms != UINT64_MAX &&
        std::chrono::steady_clock::now() >= deadline) {
      return false;
    }
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
  return true;
}

}  // namespace

// ------------------------------------------------------------------- C API

extern "C" {

void* rtps_server_start(const char* socket_path, uint64_t capacity) {
  try {
    return new StoreServer(socket_path, capacity);
  } catch (...) {
    return nullptr;
  }
}

void rtps_server_stop(void* srv) {
  auto* s = static_cast<StoreServer*>(srv);
  s->Stop();
  delete s;
}

void* rtps_client_connect(const char* socket_path) {
  try {
    return new StoreClient(socket_path);
  } catch (...) {
    return nullptr;
  }
}

void rtps_client_disconnect(void* cli) {
  delete static_cast<StoreClient*>(cli);
}


void rtps_client_prefault(void* cli) {
  static_cast<StoreClient*>(cli)->Prefault();
}

// Close only the control socket (server releases this client's refs) while
// LEAVING the arena mapped: user code may still hold zero-copy views into it,
// so unmapping would turn those into SIGSEGV. The mapping lives until process
// exit (plasma clients behave the same way). The handle leaks ~100 bytes.
void rtps_client_close_socket(void* cli) {
  static_cast<StoreClient*>(cli)->CloseSocket();
}

uint8_t* rtps_client_base(void* cli) {
  return static_cast<StoreClient*>(cli)->base();
}

int64_t rtps_create(void* cli, const uint8_t* id, uint64_t size,
                    uint64_t flags, uint64_t* offset) {
  return static_cast<StoreClient*>(cli)->Call(OP_CREATE, id, size, flags,
                                              offset, nullptr, nullptr, 0);
}

int64_t rtps_seal(void* cli, const uint8_t* id) {
  return static_cast<StoreClient*>(cli)->Call(OP_SEAL, id, 0, 0, nullptr,
                                              nullptr, nullptr, 0);
}

int64_t rtps_get(void* cli, const uint8_t* id, uint64_t timeout_ms,
                 uint64_t* offset, uint64_t* size) {
  return static_cast<StoreClient*>(cli)->Call(OP_GET, id, timeout_ms, 0,
                                              offset, size, nullptr, 0);
}

int64_t rtps_release(void* cli, const uint8_t* id) {
  return static_cast<StoreClient*>(cli)->Call(OP_RELEASE, id, 0, 0, nullptr,
                                              nullptr, nullptr, 0);
}

int64_t rtps_delete(void* cli, const uint8_t* id) {
  return static_cast<StoreClient*>(cli)->Call(OP_DELETE, id, 0, 0, nullptr,
                                              nullptr, nullptr, 0);
}

int64_t rtps_abort(void* cli, const uint8_t* id) {
  return static_cast<StoreClient*>(cli)->Call(OP_ABORT, id, 0, 0, nullptr,
                                              nullptr, nullptr, 0);
}

int64_t rtps_contains(void* cli, const uint8_t* id, uint64_t* size) {
  return static_cast<StoreClient*>(cli)->Call(OP_CONTAINS, id, 0, 0, nullptr,
                                              size, nullptr, 0);
}

int64_t rtps_stats(void* cli, uint64_t* used, uint64_t* capacity) {
  return static_cast<StoreClient*>(cli)->Call(OP_STATS, nullptr, 0, 0, used,
                                              capacity, nullptr, 0);
}

int64_t rtps_list(void* cli, uint64_t max_ids, uint64_t primaries,
                  uint8_t* ids_out) {
  return static_cast<StoreClient*>(cli)->Call(OP_LIST, nullptr, max_ids,
                                              primaries, nullptr, nullptr,
                                              ids_out, max_ids * 16);
}

int64_t rtps_free_info(void* cli, uint64_t* largest, uint64_t* total) {
  return static_cast<StoreClient*>(cli)->Call(OP_FREE_INFO, nullptr, 0, 0,
                                              largest, total, nullptr, 0);
}

// ---- channels (client-side atomics on the mapped arena; see ChanHeader)

uint64_t rtps_chan_region_size(uint64_t slot_size, uint64_t n_slots) {
  return kChanHeaderSize + n_slots * ChanSlotStride(slot_size);
}

int64_t rtps_chan_init(void* cli, uint64_t offset, uint64_t slot_size,
                       uint64_t n_slots) {
  if (slot_size == 0 || n_slots == 0) return ST_ERR;
  auto* h = reinterpret_cast<ChanHeader*>(
      static_cast<StoreClient*>(cli)->base() + offset);
  h->slot_size = slot_size;
  h->n_slots = n_slots;
  new (&h->write_seq) std::atomic<uint64_t>(0);
  new (&h->read_seq) std::atomic<uint64_t>(0);
  new (&h->closed) std::atomic<uint64_t>(0);
  std::atomic_thread_fence(std::memory_order_release);
  h->magic = kChanMagic;
  return ST_OK;
}

// Blocks while the ring is full. ST_FULL on timeout, ST_ERR on oversized
// payload / bad channel, ST_NOT_FOUND if the channel is closed. `kind` is
// the 1-byte message type prefix (written by the store so Python never
// has to concatenate kind+payload into a fresh buffer).
int64_t rtps_chan_send(void* cli, uint64_t offset, uint64_t kind,
                       const uint8_t* data, uint64_t len,
                       uint64_t timeout_ms) {
  auto* c = static_cast<StoreClient*>(cli);
  ChanHeader* h = ChanAt(c, offset);
  if (h == nullptr || len + 1 > h->slot_size) return ST_ERR;
  uint64_t w = h->write_seq.load(std::memory_order_relaxed);
  bool ok = ChanWait(timeout_ms, [&] {
    return h->closed.load(std::memory_order_relaxed) != 0 ||
           h->read_seq.load(std::memory_order_acquire) + h->n_slots > w;
  });
  if (h->closed.load(std::memory_order_relaxed) != 0) return ST_NOT_FOUND;
  if (!ok) return ST_FULL;
  uint8_t* slot = ChanSlot(c, offset, h, w);
  uint64_t total = len + 1;
  memcpy(slot, &total, 8);
  slot[8] = static_cast<uint8_t>(kind);
  if (len > 0) memcpy(slot + 9, data, len);
  h->write_seq.store(w + 1, std::memory_order_release);
  return ST_OK;
}

// Waits for the next message; on ST_OK *payload_offset/*len describe the
// slot IN the arena (zero-copy read). The slot stays owned by the reader
// until rtps_chan_recv_release. ST_TIMEOUT on timeout, ST_NOT_FOUND when
// the channel is closed and drained.
int64_t rtps_chan_recv_acquire(void* cli, uint64_t offset,
                               uint64_t timeout_ms, uint64_t* payload_offset,
                               uint64_t* len) {
  auto* c = static_cast<StoreClient*>(cli);
  ChanHeader* h = ChanAt(c, offset);
  if (h == nullptr) return ST_ERR;
  uint64_t r = h->read_seq.load(std::memory_order_relaxed);
  ChanWait(timeout_ms, [&] {
    return h->write_seq.load(std::memory_order_acquire) > r ||
           h->closed.load(std::memory_order_relaxed) != 0;
  });
  if (h->write_seq.load(std::memory_order_acquire) <= r) {
    // closed-and-drained reads as EOF; otherwise we simply timed out
    return h->closed.load(std::memory_order_relaxed) != 0 ? ST_NOT_FOUND
                                                          : ST_TIMEOUT;
  }
  uint8_t* slot = ChanSlot(c, offset, h, r);
  memcpy(len, slot, 8);
  *payload_offset = static_cast<uint64_t>(slot + 8 - c->base());
  return ST_OK;
}

// One-call receive for the hot path: wait, read the kind byte, copy the
// payload into `buf`, and release the slot — one FFI crossing instead of
// three. EXCEPTION: kind==1 (spilled object ref) returns WITHOUT
// releasing (out_released=0) — the caller must resolve the ref first and
// then call rtps_chan_recv_release, because the sender unpins the spilled
// object as soon as the slot recycles. ST_ERR if the payload exceeds cap.
int64_t rtps_chan_recv(void* cli, uint64_t offset, uint64_t timeout_ms,
                       uint8_t* buf, uint64_t cap, uint64_t* out_len,
                       uint64_t* out_kind, uint64_t* out_released) {
  auto* c = static_cast<StoreClient*>(cli);
  ChanHeader* h = ChanAt(c, offset);
  if (h == nullptr) return ST_ERR;
  uint64_t r = h->read_seq.load(std::memory_order_relaxed);
  ChanWait(timeout_ms, [&] {
    return h->write_seq.load(std::memory_order_acquire) > r ||
           h->closed.load(std::memory_order_relaxed) != 0;
  });
  if (h->write_seq.load(std::memory_order_acquire) <= r) {
    return h->closed.load(std::memory_order_relaxed) != 0 ? ST_NOT_FOUND
                                                          : ST_TIMEOUT;
  }
  uint8_t* slot = ChanSlot(c, offset, h, r);
  uint64_t total;
  memcpy(&total, slot, 8);
  if (total < 1) return ST_ERR;
  *out_kind = slot[8];
  *out_len = total - 1;
  if (*out_kind == 1) {  // spilled: hand back the slot un-released
    if (total - 1 > cap) return ST_ERR;
    memcpy(buf, slot + 9, total - 1);
    *out_released = 0;
    return ST_OK;
  }
  if (total - 1 > cap) return ST_ERR;
  if (total > 1) memcpy(buf, slot + 9, total - 1);
  h->read_seq.store(r + 1, std::memory_order_release);
  *out_released = 1;
  return ST_OK;
}

int64_t rtps_chan_recv_release(void* cli, uint64_t offset) {
  auto* c = static_cast<StoreClient*>(cli);
  ChanHeader* h = ChanAt(c, offset);
  if (h == nullptr) return ST_ERR;
  h->read_seq.fetch_add(1, std::memory_order_release);
  return ST_OK;
}

// Read the ring's true geometry from its header (attaching endpoints must
// NOT assume the creator used default sizes).
int64_t rtps_chan_geometry(void* cli, uint64_t offset, uint64_t* slot_size,
                           uint64_t* n_slots) {
  auto* c = static_cast<StoreClient*>(cli);
  ChanHeader* h = ChanAt(c, offset);
  if (h == nullptr) return ST_ERR;
  *slot_size = h->slot_size;
  *n_slots = h->n_slots;
  return ST_OK;
}

int64_t rtps_chan_close(void* cli, uint64_t offset) {
  auto* c = static_cast<StoreClient*>(cli);
  ChanHeader* h = ChanAt(c, offset);
  if (h == nullptr) return ST_ERR;
  h->closed.store(1, std::memory_order_release);
  return ST_OK;
}

}  // extern "C"
