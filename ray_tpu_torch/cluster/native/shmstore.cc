// shmstore — per-node shared-memory object store daemon.
//
// Role parity: the reference's plasma store (reference
// src/ray/object_manager/plasma/store.h:55, object_lifecycle_manager.h:101,
// eviction_policy.h:160): create/seal/get/release/delete over a local
// socket, zero-copy reads via shared memory, LRU eviction of unreferenced
// sealed objects, spill-to-disk overflow. Design differences (deliberate,
// TPU-host-oriented rather than a port):
//   - one POSIX shm segment per object (kernel-managed allocation; clients
//     mmap /dev/shm/<name> directly) instead of a dlmalloc arena + fd
//     passing;
//   - single-threaded epoll event loop, binary length-prefixed protocol;
//   - eviction spills to a directory and GET transparently restores.
//
// Protocol (little-endian):
//   request:  u32 payload_len | u8 op | 16B object id | op-specific
//   response: u32 payload_len | u8 status | op-specific
// Ops: CREATE(size u64) SEAL GET(timeout_ms i64) RELEASE DELETE CONTAINS
//      STATS LIST
// Build: g++ -O2 -std=c++17 -o shmstored shmstore.cc -lrt

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

enum Op : uint8_t {
  OP_CREATE = 1,
  OP_SEAL = 2,
  OP_GET = 3,
  OP_RELEASE = 4,
  OP_DELETE = 5,
  OP_CONTAINS = 6,
  OP_STATS = 7,
  OP_LIST = 8,
  OP_GET_COPY = 9,  // small-object fast path: data inline, no refcount
  OP_PUT_INLINE = 10,    // create+write+seal in ONE round trip
  OP_GET_COPY_BATCH = 11,  // N inline gets in ONE round trip
  OP_CONTAINS_BATCH = 12,  // N existence checks in ONE round trip
  OP_SPILL_CANDIDATES = 13,  // cold unreferenced primaries worth spilling
  OP_EVICT = 14,  // evict-with-report: drop ONE sealed refcount==0 object
};

enum Status : uint8_t {
  ST_OK = 0,
  ST_NOT_FOUND = 1,
  ST_EXISTS = 2,
  ST_OOM = 3,
  ST_TIMEOUT = 4,
  ST_ERR = 5,
  ST_NOT_SEALED = 6,
  // create() hit an id whose previous incarnation is pending_delete with
  // live reader pins: the name cannot be reused until the pins drain.
  // Clients retry instead of assuming the object is present (the old
  // behavior returned ST_EXISTS while get() said NOT_FOUND — an object
  // that "existed" but was unreadable for an unbounded window).
  ST_BUSY = 7,
};

volatile sig_atomic_t g_shutdown = 0;
void on_term(int) { g_shutdown = 1; }

struct ObjectId {
  char b[16];
  bool operator==(const ObjectId& o) const { return !memcmp(b, o.b, 16); }
};
struct ObjectIdHash {
  size_t operator()(const ObjectId& id) const {
    size_t h;
    memcpy(&h, id.b, sizeof(h));
    return h;
  }
};

std::string hex(const ObjectId& id) {
  static const char* d = "0123456789abcdef";
  std::string s;
  s.reserve(32);
  for (int i = 0; i < 16; i++) {
    unsigned char c = id.b[i];
    s += d[c >> 4];
    s += d[c & 15];
  }
  return s;
}

enum ObjState { CREATED, SEALED, SPILLED };

struct Object {
  ObjState state = CREATED;
  uint64_t size = 0;      // logical bytes (what GET reports)
  uint64_t capacity = 0;  // shm file bytes (>= size when recycled)
  int refcount = 0;       // sum of per-connection references
  bool pending_delete = false;  // delete deferred until refcount drains
  std::string shm_name;
  uint64_t lru_tick = 0;
  std::set<int> creators;  // fd that created (for cleanup on disconnect)
};

struct Waiter {
  int fd;
  ObjectId id;
  int64_t deadline_ms;  // monotonic ms; -1 = forever
};

struct Conn {
  int fd;
  std::vector<uint8_t> inbuf;
  std::deque<std::vector<uint8_t>> outq;
  size_t out_off = 0;
  // object -> per-connection refcount (released on disconnect)
  std::unordered_map<ObjectId, int, ObjectIdHash> refs;
};

int64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000LL + ts.tv_nsec / 1000000LL;
}

class Store {
 public:
  Store(std::string prefix, uint64_t capacity, std::string spill_dir)
      : prefix_(std::move(prefix)),
        capacity_(capacity),
        spill_dir_(std::move(spill_dir)) {}

  uint64_t used_ = 0, spilled_bytes_ = 0, tick_ = 0;
  uint64_t num_evictions_ = 0, num_spills_ = 0, num_restores_ = 0;
  uint64_t pool_bytes_ = 0, pool_counter_ = 0, num_recycles_ = 0;
  // Smallest segment worth recycling: below this the fault+zero cost of a
  // fresh segment is noise and pooling would just fragment the budget.
  static constexpr uint64_t kRecycleMin = 256 << 10;

  std::string shm_name_for(const ObjectId& id) const {
    return "/" + prefix_ + hex(id);
  }
  std::string spill_path_for(const ObjectId& id) const {
    return spill_dir_ + "/" + hex(id);
  }
  static std::string dev_path(const std::string& shm_name) {
    return "/dev/shm" + shm_name;  // shm_name starts with "/"
  }

  // Seal contract: a recycled segment is handed over WITHOUT zeroing (the
  // faulted-in pages are the whole point of recycling); the writer must
  // fill [0, size) before SEAL or readers can observe a prior object's
  // bytes. Both in-tree writers (pwrite put path, push-chunk receive)
  // write the full range.
  Status create(const ObjectId& id, uint64_t size, int fd) {
    auto eit = objects_.find(id);
    if (eit != objects_.end())
      return eit->second.pending_delete ? ST_BUSY : ST_EXISTS;
    if (size > capacity_) return ST_OOM;
    if (used_ + pool_bytes_ + size > capacity_ &&
        !evict(used_ + pool_bytes_ + size - capacity_))
      return ST_OOM;
    std::string name = shm_name_for(id);
    uint64_t cap = size;
    bool recycled = false;
    // Recycle a retired segment when one fits without gross waste: its
    // tmpfs pages are already faulted in, so the client's fill is a plain
    // memcpy instead of a per-page zero-fill fault storm (the plasma-arena
    // effect, reference plasma/dlmalloc.cc, without the arena).
    auto pit = pool_.lower_bound(size);
    if (size >= kRecycleMin && pit != pool_.end() &&
        pit->first <= size + std::max<uint64_t>(size, 8ull << 20)) {
      if (rename(dev_path(pit->second).c_str(),
                 dev_path(name).c_str()) == 0) {
        cap = pit->first;
        pool_bytes_ -= cap;
        pool_.erase(pit);
        num_recycles_++;
        recycled = true;
      }
    }
    if (!recycled) {
      int sfd = shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
      if (sfd < 0) return ST_ERR;
      if (ftruncate(sfd, (off_t)size) != 0) {
        close(sfd);
        shm_unlink(name.c_str());
        return ST_OOM;
      }
      close(sfd);
    }
    Object o;
    o.size = size;
    o.capacity = cap;
    o.shm_name = name;
    o.creators.insert(fd);
    objects_[id] = std::move(o);
    used_ += cap;
    return ST_OK;
  }

  Status seal(const ObjectId& id) {
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    if (it->second.state == SEALED) return ST_OK;
    if (it->second.state != CREATED) return ST_ERR;
    it->second.state = SEALED;
    it->second.creators.clear();
    it->second.lru_tick = ++tick_;
    return ST_OK;
  }

  // GET: returns ST_OK (+size) when sealed & resident; restores spilled.
  Status get(const ObjectId& id, uint64_t* size) {
    auto it = objects_.find(id);
    if (it == objects_.end() || it->second.pending_delete)
      return ST_NOT_FOUND;  // deleted-with-live-readers: no NEW refs
    Object& o = it->second;
    if (o.state == CREATED) return ST_NOT_SEALED;
    if (o.state == SPILLED && !restore(id, o)) return ST_ERR;
    o.lru_tick = ++tick_;
    *size = o.size;
    return ST_OK;
  }

  // Copy a SEALED+resident object's bytes into `dst` (caller already
  // validated via get()). Returns false if the object vanished meanwhile.
  bool read_into(const ObjectId& id, uint8_t* dst, uint64_t size) {
    auto it = objects_.find(id);
    if (it == objects_.end() || it->second.state != SEALED ||
        it->second.size != size)
      return false;
    int sfd = shm_open(it->second.shm_name.c_str(), O_RDONLY, 0);
    if (sfd < 0) return false;
    void* p = mmap(nullptr, size, PROT_READ, MAP_SHARED, sfd, 0);
    close(sfd);
    if (p == MAP_FAILED) return false;
    memcpy(dst, p, size);
    munmap(p, size);
    return true;
  }

  Status del(const ObjectId& id) {
    auto it = objects_.find(id);
    if (it == objects_.end()) return ST_NOT_FOUND;
    Object& o = it->second;
    if (o.refcount > 0 && o.state != SPILLED) {
      // Live readers still map these pages: defer (plasma-style) so the
      // segment cannot be recycled under a zero-copy numpy view. The last
      // release destroys it (add_ref hook below).
      o.pending_delete = true;
      return ST_OK;
    }
    destroy(it);
    return ST_OK;
  }

  // Evict-with-report: drop exactly this object's resident (or natively
  // spilled) copy NOW, refusing anything a reader still maps or a writer
  // still fills. The caller has already secured a durable copy elsewhere;
  // unlike evict() this never falls back to the store's own spill dir.
  Status evict_one(const ObjectId& id, uint64_t* freed) {
    auto it = objects_.find(id);
    if (it == objects_.end() || it->second.pending_delete)
      return ST_NOT_FOUND;
    Object& o = it->second;
    if (o.state == CREATED) return ST_NOT_SEALED;
    if (o.refcount > 0 && o.state != SPILLED) return ST_BUSY;
    *freed = o.size;
    destroy(it);
    num_evictions_++;
    return ST_OK;
  }

  void destroy(std::unordered_map<ObjectId, Object, ObjectIdHash>::iterator
                   it) {
    Object& o = it->second;
    if (o.state == SPILLED) {
      unlink(spill_path_for(it->first).c_str());
      spilled_bytes_ -= o.size;
    } else {
      retire_segment(o.shm_name, o.capacity);
      used_ -= o.capacity;
    }
    objects_.erase(it);
  }

  // Retire a segment: into the recycle pool when it is big enough to be
  // worth the resident pages, else unlink. Pool budget is half the store:
  // pool pages are the FIRST thing eviction reclaims, so a generous pool
  // costs nothing under pressure but keeps the inode set stable under
  // put/delete cycling (stable inodes are what the client's write-mapping
  // cache keys on).
  void retire_segment(const std::string& name, uint64_t cap) {
    if (cap >= kRecycleMin && pool_bytes_ + cap <= capacity_ / 2) {
      std::string pname =
          "/" + prefix_ + "pool" + std::to_string(pool_counter_++);
      if (rename(dev_path(name).c_str(), dev_path(pname).c_str()) == 0) {
        pool_.emplace(cap, std::move(pname));
        pool_bytes_ += cap;
        return;
      }
    }
    shm_unlink(name.c_str());
  }

  bool contains(const ObjectId& id) {
    auto it = objects_.find(id);
    return it != objects_.end() && it->second.state != CREATED &&
           !it->second.pending_delete;
  }

  void add_ref(const ObjectId& id, int n) {
    auto it = objects_.find(id);
    if (it == objects_.end()) return;
    it->second.refcount += n;
    if (it->second.refcount <= 0 && it->second.pending_delete) destroy(it);
  }

  // Evict LRU sealed, refcount==0 objects until `need` bytes are freed.
  // Spills to disk if a spill dir is configured, else drops (objects are
  // recoverable via lineage at the framework layer).
  bool evict(uint64_t need) {
    uint64_t freed = 0;
    // Recycle-pool pages first: reclaiming them costs nothing (no object
    // dies, no spill I/O). Largest first.
    while (freed < need && !pool_.empty()) {
      auto pit = std::prev(pool_.end());
      shm_unlink(pit->second.c_str());
      freed += pit->first;
      pool_bytes_ -= pit->first;
      pool_.erase(pit);
    }
    if (freed >= need) return true;
    std::vector<std::pair<uint64_t, ObjectId>> cands;
    for (auto& [id, o] : objects_)
      if (o.state == SEALED && o.refcount == 0)
        cands.push_back({o.lru_tick, id});
    std::sort(cands.begin(), cands.end(),
              [](auto& a, auto& b) { return a.first < b.first; });
    for (auto& [_, id] : cands) {
      if (freed >= need) break;
      Object& o = objects_[id];
      freed += o.capacity;
      if (!spill_dir_.empty() && spill(id, o)) {
        num_spills_++;
      } else {
        shm_unlink(o.shm_name.c_str());
        used_ -= o.capacity;
        objects_.erase(id);
      }
      num_evictions_++;
    }
    return freed >= need;
  }

  // Unlink EVERY shm segment this store owns (live objects, recycle pool,
  // spill files, owner marker). Run on orderly shutdown and on parent
  // death: a crashed session must not strand tmpfs pages — the reference's
  // plasma arena is one mmap'd file the kernel reclaims on process exit
  // (store_runner.cc); per-object segments need this explicit sweep.
  void cleanup_all() {
    for (auto& [id, o] : objects_) {
      if (o.state == SPILLED)
        unlink(spill_path_for(id).c_str());
      else
        shm_unlink(o.shm_name.c_str());
    }
    objects_.clear();
    for (auto& [cap, name] : pool_) shm_unlink(name.c_str());
    pool_.clear();
    shm_unlink(("/" + prefix_ + "owner").c_str());
    used_ = pool_bytes_ = spilled_bytes_ = 0;
  }

  // Owner marker: /dev/shm/<prefix>owner holds our pid so an out-of-band
  // sweeper (cluster/hygiene.py) can associate stranded segments with a
  // dead store and unlink them even after a SIGKILL (which no watchdog
  // survives).
  void write_owner_marker() {
    std::string name = "/" + prefix_ + "owner";
    int fd = shm_open(name.c_str(), O_CREAT | O_TRUNC | O_RDWR, 0600);
    if (fd < 0) return;
    char buf[32];
    int n = snprintf(buf, sizeof(buf), "%d\n", (int)getpid());
    if (write(fd, buf, n) != n) { /* best-effort marker */ }
    close(fd);
  }

  std::unordered_map<ObjectId, Object, ObjectIdHash> objects_;
  std::multimap<uint64_t, std::string> pool_;  // capacity -> shm name
  std::string prefix_;
  uint64_t capacity_;
  std::string spill_dir_;

 private:
  bool spill(const ObjectId& id, Object& o) {
    int sfd = shm_open(o.shm_name.c_str(), O_RDONLY, 0);
    if (sfd < 0) return false;
    void* p = mmap(nullptr, o.size, PROT_READ, MAP_SHARED, sfd, 0);
    close(sfd);
    if (p == MAP_FAILED) return false;
    std::string path = spill_path_for(id);
    int dfd = open(path.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0600);
    if (dfd < 0) {
      munmap(p, o.size);
      return false;
    }
    uint64_t off = 0;
    const char* src = (const char*)p;
    bool ok = true;
    while (off < o.size) {
      ssize_t w = write(dfd, src + off, o.size - off);
      if (w <= 0) {
        ok = false;
        break;
      }
      off += (uint64_t)w;
    }
    close(dfd);
    munmap(p, o.size);
    if (!ok) {
      unlink(path.c_str());
      return false;
    }
    // Spill frees the whole segment (no recycle: eviction's purpose is to
    // RELEASE memory, pooling would keep the pages resident).
    shm_unlink(o.shm_name.c_str());
    used_ -= o.capacity;
    spilled_bytes_ += o.size;
    o.state = SPILLED;
    return true;
  }

  bool restore(const ObjectId& id, Object& o) {
    if (used_ + pool_bytes_ + o.size > capacity_ &&
        !evict(used_ + pool_bytes_ + o.size - capacity_))
      return false;
    std::string path = spill_path_for(id);
    int dfd = open(path.c_str(), O_RDONLY);
    if (dfd < 0) return false;
    int sfd = shm_open(o.shm_name.c_str(), O_CREAT | O_RDWR, 0600);
    if (sfd < 0 || ftruncate(sfd, (off_t)o.size) != 0) {
      if (sfd >= 0) close(sfd);
      close(dfd);
      return false;
    }
    void* p = mmap(nullptr, o.size, PROT_WRITE, MAP_SHARED, sfd, 0);
    close(sfd);
    if (p == MAP_FAILED) {
      close(dfd);
      return false;
    }
    uint64_t off = 0;
    char* dst = (char*)p;
    bool ok = true;
    while (off < o.size) {
      ssize_t r = read(dfd, dst + off, o.size - off);
      if (r <= 0) {
        ok = false;
        break;
      }
      off += (uint64_t)r;
    }
    close(dfd);
    munmap(p, o.size);
    if (!ok) return false;
    unlink(path.c_str());
    used_ += o.size;
    o.capacity = o.size;  // restored into a fresh exact-size segment
    spilled_bytes_ -= o.size;
    o.state = SEALED;
    num_restores_++;
    return true;
  }
};

class Server {
 public:
  Server(Store* store, const std::string& sock_path)
      : store_(store), sock_path_(sock_path) {}

  int run() {
    signal(SIGPIPE, SIG_IGN);
    signal(SIGTERM, on_term);
    signal(SIGINT, on_term);
    ppid_ = getppid();
    listen_fd_ = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (listen_fd_ < 0) return perror("socket"), 1;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, sock_path_.c_str(), sizeof(addr.sun_path) - 1);
    unlink(sock_path_.c_str());
    if (bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) != 0)
      return perror("bind"), 1;
    if (listen(listen_fd_, 256) != 0) return perror("listen"), 1;
    ep_ = epoll_create1(0);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = listen_fd_;
    epoll_ctl(ep_, EPOLL_CTL_ADD, listen_fd_, &ev);
    // readiness marker for the launcher
    fprintf(stdout, "READY %s\n", sock_path_.c_str());
    fflush(stdout);

    std::vector<epoll_event> events(128);
    for (;;) {
      // Parent-death watchdog: this daemon is spawned by the node daemon
      // (or a driver embedding one); if that process dies — SIGKILL
      // included — we are reparented and must not outlive it holding
      // tmpfs pages (reference: the raylet supervises plasma's lifetime
      // by colocation, plasma/store_runner.cc).
      if (g_shutdown || getppid() != ppid_) {
        store_->cleanup_all();
        unlink(sock_path_.c_str());
        return 0;
      }
      int timeout = waiters_.empty() ? 1000 : 50;
      int n = epoll_wait(ep_, events.data(), (int)events.size(), timeout);
      if (n < 0 && errno == EINTR) continue;  // signal: re-check flag
      for (int i = 0; i < n; i++) {
        int fd = events[i].data.fd;
        if (fd == listen_fd_) {
          accept_conns();
        } else {
          if (events[i].events & (EPOLLHUP | EPOLLERR)) {
            close_conn(fd);
            continue;
          }
          if (events[i].events & EPOLLIN) handle_read(fd);
          if (conns_.count(fd) && (events[i].events & EPOLLOUT))
            flush_out(fd);
        }
      }
      service_waiters();
    }
    return 0;
  }

 private:
  void accept_conns() {
    for (;;) {
      int fd = accept4(listen_fd_, nullptr, nullptr, SOCK_NONBLOCK);
      if (fd < 0) break;
      conns_[fd] = Conn{fd};
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      epoll_ctl(ep_, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  void close_conn(int fd) {
    auto it = conns_.find(fd);
    if (it == conns_.end()) return;
    // release this connection's references; abort its unsealed creations
    for (auto& [id, cnt] : it->second.refs) store_->add_ref(id, -cnt);
    std::vector<ObjectId> to_del;
    for (auto& [id, o] : store_->objects_)
      if (o.state == CREATED && o.creators.count(fd)) to_del.push_back(id);
    for (auto& id : to_del) store_->del(id);
    epoll_ctl(ep_, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    conns_.erase(it);
    waiters_.remove_if([fd](const Waiter& w) { return w.fd == fd; });
  }

  void handle_read(int fd) {
    Conn& c = conns_[fd];
    char buf[65536];
    for (;;) {
      ssize_t r = recv(fd, buf, sizeof(buf), 0);
      if (r > 0) {
        c.inbuf.insert(c.inbuf.end(), buf, buf + r);
      } else if (r == 0) {
        close_conn(fd);
        return;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        close_conn(fd);
        return;
      }
    }
    // parse complete frames
    size_t off = 0;
    while (c.inbuf.size() - off >= 4) {
      uint32_t len;
      memcpy(&len, c.inbuf.data() + off, 4);
      if (c.inbuf.size() - off - 4 < len) break;
      handle_msg(fd, c.inbuf.data() + off + 4, len);
      off += 4 + len;
      if (!conns_.count(fd)) return;  // closed during handling
    }
    if (off) c.inbuf.erase(c.inbuf.begin(), c.inbuf.begin() + off);
  }

  void reply(int fd, uint8_t status, const void* extra = nullptr,
             uint32_t extra_len = 0) {
    std::vector<uint8_t> out(4 + 1 + extra_len);
    uint32_t len = 1 + extra_len;
    memcpy(out.data(), &len, 4);
    out[4] = status;
    if (extra_len) memcpy(out.data() + 5, extra, extra_len);
    Conn& c = conns_[fd];
    c.outq.push_back(std::move(out));
    flush_out(fd);
  }

  void flush_out(int fd) {
    Conn& c = conns_[fd];
    while (!c.outq.empty()) {
      auto& front = c.outq.front();
      ssize_t w = send(fd, front.data() + c.out_off,
                       front.size() - c.out_off, MSG_NOSIGNAL);
      if (w < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          epoll_event ev{};
          ev.events = EPOLLIN | EPOLLOUT;
          ev.data.fd = fd;
          epoll_ctl(ep_, EPOLL_CTL_MOD, fd, &ev);
          return;
        }
        close_conn(fd);
        return;
      }
      c.out_off += (size_t)w;
      if (c.out_off == front.size()) {
        c.outq.pop_front();
        c.out_off = 0;
      }
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    epoll_ctl(ep_, EPOLL_CTL_MOD, fd, &ev);
  }

  void handle_msg(int fd, const uint8_t* p, uint32_t len) {
    if (len < 1) return reply(fd, ST_ERR);
    uint8_t op = p[0];
    if (op == OP_STATS) {
      char js[512];
      int n = snprintf(js, sizeof(js),
                       "{\"capacity\":%llu,\"used\":%llu,\"spilled\":%llu,"
                       "\"objects\":%zu,\"evictions\":%llu,\"spills\":%llu,"
                       "\"restores\":%llu,\"pool_bytes\":%llu,"
                       "\"recycles\":%llu}",
                       (unsigned long long)store_->capacity_,
                       (unsigned long long)store_->used_,
                       (unsigned long long)store_->spilled_bytes_,
                       store_->objects_.size(),
                       (unsigned long long)store_->num_evictions_,
                       (unsigned long long)store_->num_spills_,
                       (unsigned long long)store_->num_restores_,
                       (unsigned long long)store_->pool_bytes_,
                       (unsigned long long)store_->num_recycles_);
      return reply(fd, ST_OK, js, (uint32_t)n);
    }
    if (op == OP_LIST) {
      std::string out;
      for (auto& [id, o] : store_->objects_)
        if (o.state != CREATED && !o.pending_delete) out.append(id.b, 16);
      return reply(fd, ST_OK, out.data(), (uint32_t)out.size());
    }
    if (op == OP_CONTAINS_BATCH) {
      // [op][count:u32][16B x count] -> ST_OK + one byte (1/0) per id.
      // Same sealed-and-not-pending-delete predicate as OP_CONTAINS; a
      // wait() over N refs costs one round trip instead of N.
      if (len < 5) return reply(fd, ST_ERR);
      uint32_t count;
      memcpy(&count, p + 1, 4);
      if (len < 5 + (uint64_t)count * 16) return reply(fd, ST_ERR);
      std::string out;
      out.reserve(count);
      for (uint32_t k = 0; k < count; k++) {
        ObjectId bid;
        memcpy(bid.b, p + 5 + k * 16, 16);
        out.push_back(store_->contains(bid) ? 1 : 0);
      }
      return reply(fd, ST_OK, out.data(), (uint32_t)out.size());
    }
    if (op == OP_SPILL_CANDIDATES) {
      // [op][want:u64] -> ST_OK + repeated [16B id][size:u64], coldest
      // first, of SEALED refcount==0 resident objects totalling at least
      // `want` bytes (or every candidate when less is available). Read-only:
      // the external spill coordinator (node daemon) copies the bytes out
      // through a durable backend and then issues OP_EVICT per object, so
      // the store never blocks on spill I/O (the reference splits the same
      // way: plasma evicts, local_object_manager.h owns the spill I/O).
      if (len < 9) return reply(fd, ST_ERR);
      uint64_t want;
      memcpy(&want, p + 1, 8);
      std::vector<std::pair<uint64_t, ObjectId>> cands;
      for (auto& [cid, o] : store_->objects_)
        if (o.state == SEALED && o.refcount == 0 && !o.pending_delete)
          cands.push_back({o.lru_tick, cid});
      std::sort(cands.begin(), cands.end(),
                [](auto& a, auto& b) { return a.first < b.first; });
      std::string out;
      uint64_t total = 0;
      for (auto& [_, cid] : cands) {
        if (want && total >= want) break;
        uint64_t sz = store_->objects_[cid].size;
        out.append(cid.b, 16);
        out.append((const char*)&sz, 8);
        total += sz;
      }
      return reply(fd, ST_OK, out.data(), (uint32_t)out.size());
    }
    if (len < 17) return reply(fd, ST_ERR);
    ObjectId id;
    memcpy(id.b, p + 1, 16);
    switch (op) {
      case OP_CREATE: {
        if (len < 25) return reply(fd, ST_ERR);
        uint64_t size;
        memcpy(&size, p + 17, 8);
        Status st = store_->create(id, size, fd);
        return reply(fd, st);
      }
      case OP_SEAL: {
        Status st = store_->seal(id);
        if (st == ST_OK) service_waiters();
        return reply(fd, st);
      }
      case OP_GET: {
        int64_t timeout_ms = 0;
        if (len >= 25) memcpy(&timeout_ms, p + 17, 8);
        uint64_t size;
        Status st = store_->get(id, &size);
        if (st == ST_OK) {
          store_->add_ref(id, 1);
          conns_[fd].refs[id]++;
          return reply(fd, ST_OK, &size, 8);
        }
        if ((st == ST_NOT_FOUND || st == ST_NOT_SEALED) && timeout_ms != 0) {
          int64_t dl = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
          waiters_.push_back({fd, id, dl});
          return;  // deferred reply
        }
        return reply(fd, st);
      }
      case OP_GET_COPY: {
        // [op][id][max_inline:8] -> ST_OK + size + payload for SEALED
        // objects up to max_inline bytes. ONE round trip, no per-client
        // refcount (the copy is consistent regardless of later eviction)
        // and no client-side open/mmap — the winning trade for the many-
        // small-results pattern (get() of task returns). Large or
        // not-yet-sealed objects return their status; the caller falls
        // back to the zero-copy OP_GET path.
        uint64_t max_inline = 0;
        if (len >= 25) memcpy(&max_inline, p + 17, 8);
        uint64_t size;
        Status st = store_->get(id, &size);
        if (st != ST_OK) return reply(fd, st);
        if (size > max_inline) return reply(fd, ST_ERR, &size, 8);
        std::vector<uint8_t> data(8 + size);
        memcpy(data.data(), &size, 8);
        if (size) {
          if (!store_->read_into(id, data.data() + 8, size))
            return reply(fd, ST_NOT_FOUND);
        }
        return reply(fd, ST_OK, data.data(),
                     static_cast<uint32_t>(data.size()));
      }
      case OP_PUT_INLINE: {
        // [op][id][payload...] -> create+copy+seal in one round trip: the
        // dominant put shape is a small task result, where three store
        // round trips (create/seal) plus client open/write/close syscalls
        // cost more than the payload copy itself.
        uint64_t size = len - 17;
        Status st = store_->create(id, size, fd);
        if (st == ST_EXISTS) return reply(fd, ST_EXISTS);
        if (st != ST_OK) return reply(fd, st);
        if (size) {
          auto it = store_->objects_.find(id);
          int sfd = shm_open(it->second.shm_name.c_str(), O_RDWR, 0);
          if (sfd < 0) {
            store_->del(id);
            return reply(fd, ST_ERR);
          }
          void* m = mmap(nullptr, size, PROT_WRITE, MAP_SHARED, sfd, 0);
          close(sfd);
          if (m == MAP_FAILED) {
            store_->del(id);
            return reply(fd, ST_ERR);
          }
          memcpy(m, p + 17, size);
          munmap(m, size);
        }
        store_->seal(id);
        service_waiters();
        return reply(fd, ST_OK);
      }
      case OP_GET_COPY_BATCH: {
        // [op][pad:16][count:u32][max_inline:u64][16B x count] -> ST_OK +
        // per-object [st:u8][size:u64][payload if st==OK]. One round trip
        // for a whole ray_tpu.get() of task results.
        if (len < 29) return reply(fd, ST_ERR);
        uint32_t count;
        uint64_t max_inline;
        memcpy(&count, p + 17, 4);
        memcpy(&max_inline, p + 21, 8);
        if (len < 29 + (uint64_t)count * 16) return reply(fd, ST_ERR);
        std::string out;
        for (uint32_t k = 0; k < count; k++) {
          ObjectId bid;
          memcpy(bid.b, p + 29 + k * 16, 16);
          uint64_t size = 0;
          Status st = store_->get(bid, &size);
          if (st == ST_OK && size > max_inline) st = ST_ERR;
          out.push_back((char)st);
          out.append((const char*)&size, 8);
          if (st == ST_OK && size) {
            size_t at = out.size();
            out.resize(at + size);
            if (!store_->read_into(bid, (uint8_t*)out.data() + at, size)) {
              out.resize(at);
              out[out.size() - 9] = (char)ST_NOT_FOUND;
            }
          }
        }
        return reply(fd, ST_OK, out.data(), (uint32_t)out.size());
      }
      case OP_RELEASE: {
        auto& refs = conns_[fd].refs;
        auto rit = refs.find(id);
        if (rit != refs.end() && rit->second > 0) {
          rit->second--;
          store_->add_ref(id, -1);
          if (!rit->second) refs.erase(rit);
        }
        return reply(fd, ST_OK);
      }
      case OP_DELETE:
        return reply(fd, store_->del(id));
      case OP_EVICT: {
        uint64_t freed = 0;
        Status st = store_->evict_one(id, &freed);
        if (st == ST_OK) return reply(fd, ST_OK, &freed, 8);
        return reply(fd, st);
      }
      case OP_CONTAINS:
        return reply(fd, store_->contains(id) ? ST_OK : ST_NOT_FOUND);
      default:
        return reply(fd, ST_ERR);
    }
  }

  void service_waiters() {
    int64_t now = now_ms();
    for (auto it = waiters_.begin(); it != waiters_.end();) {
      uint64_t size;
      Status st = store_->get(it->id, &size);
      if (st == ST_OK) {
        if (conns_.count(it->fd)) {
          store_->add_ref(it->id, 1);
          conns_[it->fd].refs[it->id]++;
          reply(it->fd, ST_OK, &size, 8);
        }
        it = waiters_.erase(it);
      } else if (it->deadline_ms >= 0 && now >= it->deadline_ms) {
        if (conns_.count(it->fd)) reply(it->fd, ST_TIMEOUT);
        it = waiters_.erase(it);
      } else {
        ++it;
      }
    }
  }

  Store* store_;
  std::string sock_path_;
  pid_t ppid_ = -1;
  int listen_fd_ = -1, ep_ = -1;
  std::unordered_map<int, Conn> conns_;
  std::list<Waiter> waiters_;
};

}  // namespace

int main(int argc, char** argv) {
  // usage: shmstored <socket_path> <capacity_bytes> <shm_prefix> [spill_dir]
  if (argc < 4) {
    fprintf(stderr,
            "usage: %s <socket> <capacity_bytes> <shm_prefix> [spill_dir]\n",
            argv[0]);
    return 2;
  }
  std::string spill_dir = argc > 4 ? argv[4] : "";
  if (!spill_dir.empty()) mkdir(spill_dir.c_str(), 0700);
  Store store(argv[3], strtoull(argv[2], nullptr, 10), spill_dir);
  store.write_owner_marker();
  Server srv(&store, argv[1]);
  int rc = srv.run();
  store.cleanup_all();
  return rc;
}
