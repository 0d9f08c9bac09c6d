// kvstore: revisioned MVCC key-value store with watch — the persistence layer
// under the apiserver (role of etcd3 + clientv3 in the reference:
// staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go).
//
// Semantics kept from etcd3 (the subset the apiserver storage layer uses):
//   * one global revision, bumped by every mutation (Put/Delete/Txn)
//   * per-key create_revision / mod_revision
//   * conditional transactions on mod_revision (the CAS under
//     GuaranteedUpdate, store.go:219-300)
//   * prefix range reads at current revision
//   * an append-only event log enabling "watch from revision N" catch-up,
//     with compaction; watching from a compacted revision errors (→ 410 Gone)
//   * blocking wait-for-revision (condition variable) so watchers poll
//     without busy-looping
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image). All calls
// are thread-safe behind one mutex; values are opaque byte strings.
//
// Serialization of multi-record results (range/events) into one buffer:
//   record := i64 a | i64 b | i64 klen | key bytes | i64 vlen | value bytes
// where (a, b) = (create_rev, mod_rev) for range and (rev, event_type) for
// events. Integers are host-endian int64. Buffers are malloc'd; callers free
// via kv_buf_free.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct ValueRec {
  std::string value;
  int64_t create_rev = 0;
  int64_t mod_rev = 0;
};

// CREATE vs PUT lets watchers emit ADDED vs MODIFIED without historical
// reads (etcd exposes the same via create_revision == mod_revision).
enum EventType : int64_t { EVENT_PUT = 0, EVENT_DELETE = 1, EVENT_CREATE = 2 };

struct Event {
  int64_t rev;
  int64_t type;
  std::string key;
  std::string value;  // for DELETE: the last value (prev-kv)
};

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, ValueRec> data;
  std::deque<Event> events;
  int64_t rev = 0;
  int64_t compacted_rev = 0;  // events with rev <= compacted_rev are gone
  size_t max_events = 1 << 20;

  void append_event(int64_t type, const std::string& key, const std::string& val) {
    events.push_back(Event{rev, type, key, val});
    if (events.size() > max_events) {
      compacted_rev = events.front().rev;
      events.pop_front();
    }
  }
};

bool has_prefix(const std::string& s, const char* prefix) {
  return s.compare(0, std::strlen(prefix), prefix) == 0;
}

// Serialize records into one malloc'd buffer.
struct BufWriter {
  std::vector<char> buf;
  void i64(int64_t v) {
    const char* p = reinterpret_cast<const char*>(&v);
    buf.insert(buf.end(), p, p + 8);
  }
  void bytes(const std::string& s) {
    i64(static_cast<int64_t>(s.size()));
    buf.insert(buf.end(), s.begin(), s.end());
  }
  char* out(int64_t* out_len) {
    *out_len = static_cast<int64_t>(buf.size());
    char* p = static_cast<char*>(std::malloc(buf.size() ? buf.size() : 1));
    if (p && !buf.empty()) std::memcpy(p, buf.data(), buf.size());
    return p;
  }
};

}  // namespace

extern "C" {

void* kv_new() { return new Store(); }

void kv_free(void* h) { delete static_cast<Store*>(h); }

int64_t kv_rev(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->rev;
}

int64_t kv_compacted_rev(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->compacted_rev;
}

// Unconditional put. Returns the new mod revision.
int64_t kv_put(void* h, const char* key, const char* val, int64_t val_len) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->rev++;
  ValueRec& r = s->data[key];
  bool created = (r.create_rev == 0);
  if (created) r.create_rev = s->rev;
  r.value.assign(val, static_cast<size_t>(val_len));
  r.mod_rev = s->rev;
  s->append_event(created ? EVENT_CREATE : EVENT_PUT, key, r.value);
  s->cv.notify_all();
  return s->rev;
}

// Conditional put (the CAS under GuaranteedUpdate):
//   expected_mod_rev == 0  → key must NOT exist (create)
//   expected_mod_rev  > 0  → key must exist at exactly that mod revision
//   expected_mod_rev == -1 → unconditional
// Returns new revision, or -1 on condition failure.
int64_t kv_txn_put(void* h, const char* key, int64_t expected_mod_rev,
                   const char* val, int64_t val_len) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->data.find(key);
  if (expected_mod_rev == 0 && it != s->data.end()) return -1;
  if (expected_mod_rev > 0 &&
      (it == s->data.end() || it->second.mod_rev != expected_mod_rev))
    return -1;
  s->rev++;
  ValueRec& r = s->data[key];
  bool created = (r.create_rev == 0);
  if (created) r.create_rev = s->rev;
  r.value.assign(val, static_cast<size_t>(val_len));
  r.mod_rev = s->rev;
  s->append_event(created ? EVENT_CREATE : EVENT_PUT, key, r.value);
  s->cv.notify_all();
  return s->rev;
}

// Conditional delete; expected_mod_rev semantics as kv_txn_put (-1 = any).
// Returns new revision, -1 on condition failure, 0 if the key is absent.
int64_t kv_txn_delete(void* h, const char* key, int64_t expected_mod_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->data.find(key);
  if (it == s->data.end()) return 0;
  if (expected_mod_rev > 0 && it->second.mod_rev != expected_mod_rev) return -1;
  s->rev++;
  std::string prev = std::move(it->second.value);
  s->data.erase(it);
  s->append_event(EVENT_DELETE, key, prev);
  s->cv.notify_all();
  return s->rev;
}

// Point get. Returns 1 if found (out buffer malloc'd), 0 if absent.
int64_t kv_get(void* h, const char* key, char** out, int64_t* out_len,
               int64_t* create_rev, int64_t* mod_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->data.find(key);
  if (it == s->data.end()) return 0;
  const ValueRec& r = it->second;
  *out_len = static_cast<int64_t>(r.value.size());
  *out = static_cast<char*>(std::malloc(r.value.size() ? r.value.size() : 1));
  if (*out && !r.value.empty()) std::memcpy(*out, r.value.data(), r.value.size());
  *create_rev = r.create_rev;
  *mod_rev = r.mod_rev;
  return 1;
}

// Prefix range at current revision. Returns record count; records carry
// (create_rev, mod_rev). Also writes the store revision for List consistency.
int64_t kv_range(void* h, const char* prefix, char** out, int64_t* out_len,
                 int64_t* at_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  BufWriter w;
  int64_t n = 0;
  for (auto it = s->data.lower_bound(prefix); it != s->data.end(); ++it) {
    if (!has_prefix(it->first, prefix)) break;
    w.i64(it->second.create_rev);
    w.i64(it->second.mod_rev);
    w.bytes(it->first);
    w.bytes(it->second.value);
    n++;
  }
  *out = w.out(out_len);
  *at_rev = s->rev;
  return n;
}

int64_t kv_count(void* h, const char* prefix) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int64_t n = 0;
  for (auto it = s->data.lower_bound(prefix); it != s->data.end(); ++it) {
    if (!has_prefix(it->first, prefix)) break;
    n++;
  }
  return n;
}

// Events with rev > since_rev matching prefix. Returns count, or -1 if
// since_rev predates compaction (watcher must relist — the 410 Gone path).
int64_t kv_events_since(void* h, int64_t since_rev, const char* prefix,
                        char** out, int64_t* out_len) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  if (since_rev < s->compacted_rev) return -1;
  BufWriter w;
  int64_t n = 0;
  // One event per revision, in revision order: the read starts at the
  // first event past since_rev instead of walking the whole log (the watch
  // pump reads it after every write).
  auto first = std::partition_point(
      s->events.begin(), s->events.end(),
      [since_rev](const Event& e) { return e.rev <= since_rev; });
  for (auto it = first; it != s->events.end(); ++it) {
    const Event& e = *it;
    if (!has_prefix(e.key, prefix)) continue;
    w.i64(e.rev);
    w.i64(e.type);
    w.bytes(e.key);
    w.bytes(e.value);
    n++;
  }
  *out = w.out(out_len);
  return n;
}

// Block until the store revision exceeds rev, or timeout_ms elapses.
// Returns the current revision either way.
int64_t kv_wait(void* h, int64_t rev, int64_t timeout_ms) {
  Store* s = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                 [&] { return s->rev > rev; });
  return s->rev;
}

// Install one record WITHOUT bumping the revision or appending an event —
// snapshot restore only. The caller (the WAL recovery path) owns revision
// bookkeeping via kv_init; feeding live traffic through here would corrupt
// MVCC history.
void kv_load(void* h, const char* key, const char* val, int64_t val_len,
             int64_t create_rev, int64_t mod_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  ValueRec& r = s->data[key];
  r.value.assign(val, static_cast<size_t>(val_len));
  r.create_rev = create_rev;
  r.mod_rev = mod_rev;
}

// Seed the revision counter + compaction floor from durable state (snapshot
// header). Recovery calls this BEFORE replaying the WAL tail, so replayed
// mutations re-earn exactly the revisions they held before the crash — the
// RV-continuity invariant.
void kv_init(void* h, int64_t rev, int64_t compacted_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->rev = rev;
  s->compacted_rev = compacted_rev;
}

// Drop events with rev <= at_rev (etcd compaction).
int64_t kv_compact(void* h, int64_t at_rev) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  while (!s->events.empty() && s->events.front().rev <= at_rev) {
    if (s->events.front().rev > s->compacted_rev)
      s->compacted_rev = s->events.front().rev;
    s->events.pop_front();
  }
  if (at_rev > s->compacted_rev) s->compacted_rev = at_rev;
  return s->compacted_rev;
}

void kv_buf_free(char* p) { std::free(p); }

}  // extern "C"
