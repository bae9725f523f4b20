// Native network co-simulator: per-route chunked fair-share packet service.
//
// A copy of `pivot_tpu/native/pivot_net.cpp`, built for the port.
//
// Behavioral parity with the Python `pivot_tpu_torch.infra.network.Route`
// (itself a redesign of the original simulator's `NetworkRoute`/`Packet`,
// `resources/network.py`): a transfer is served one
// CHUNK_MB-sized chunk at a time at chunk/bw sim-seconds per chunk; an
// unfinished transfer re-enters the tail of the route's queue after each
// chunk, so concurrent transfers share the route round-robin and congestion
// emerges from queueing.
//
// Why native: chunk service is the simulator's dominant event source — a
// 50 GB transfer is 50 chunk events, and a full Alibaba trace run generates
// millions.  This engine keeps the entire chunk-service loop (heap, queues,
// stats) in C++; the Python event kernel sees ONE wake callback per distinct
// completion instant instead of one event per chunk.
//
// The engine is a co-simulator: it never sees wall-clock or sim-clock except
// through `now` values passed in.  Arithmetic is double-precision with the
// same operation order as the Python implementation (start + chunk/bw), so
// completion times are bit-identical.
//
// API (extern "C", ctypes-friendly): create/destroy, add_route, send, peek,
// advance/collect_done, queued_mb, route_stats, total_chunks.

#include <cstdint>
#include <cmath>
#include <deque>
#include <queue>
#include <vector>

namespace {

constexpr double kChunkMb = 1000.0;  // ref Packet.PACKET_SIZE, network.py:12

struct Transfer {
  double remaining;
  double last_end = -1.0;  // end time of this transfer's previous chunk
  int32_t route;
  bool started = false;    // counted in the route's n_transfers yet?
  bool cancelled = false;  // dropped after its in-service chunk completes
};

struct HeapEntry {
  double time;
  int64_t seq;
  int32_t route;
  bool operator>(const HeapEntry& o) const {
    if (time != o.time) return time > o.time;
    return seq > o.seq;
  }
};

struct RouteState {
  double bw;
  std::deque<int64_t> queue;  // waiting transfer ids (excludes in-service)
  bool busy = false;
  int64_t current = -1;       // transfer in service
  double cur_chunk = 0.0;
  // Stats mirroring the Python Meter's per-slot logs (meter.py:121-125):
  double served_mb = 0.0;   // chunk MB counted at slot END (len==3 slots)
  int64_t n_transfers = 0;  // transfers with >=1 slot start (check-in)
  double gap_sum = 0.0;     // sum of slots[i].start - slots[i-1].end
};

struct Engine {
  std::vector<RouteState> routes;
  std::vector<Transfer> transfers;
  std::priority_queue<HeapEntry, std::vector<HeapEntry>, std::greater<HeapEntry>>
      heap;
  int64_t seq = 0;
  int64_t total_chunks = 0;
  // Completions accumulated by advance(), drained by collect_done().
  std::vector<int64_t> done_ids;
  std::vector<double> done_times;
  size_t done_cursor = 0;
  // Transfer slots released at collect time, reused by send — a slot is
  // only recycled after the caller has consumed its completion, so an id
  // is never live twice concurrently.
  std::vector<int64_t> free_ids;

  void serve_next(int32_t ri, double now) {
    RouteState& r = routes[ri];
    if (r.queue.empty()) {
      r.busy = false;
      r.current = -1;
      return;
    }
    r.busy = true;
    int64_t id = r.queue.front();
    r.queue.pop_front();
    Transfer& t = transfers[id];
    double chunk = t.remaining < kChunkMb ? t.remaining : kChunkMb;
    if (!t.started) {
      t.started = true;
      r.n_transfers += 1;
    } else if (t.last_end >= 0.0) {
      r.gap_sum += now - t.last_end;
    }
    r.current = id;
    r.cur_chunk = chunk;
    double service = r.bw > 0.0 ? chunk / r.bw : 0.0;
    heap.push(HeapEntry{now + service, seq++, ri});
  }

  void complete_chunk(int32_t ri, double tc) {
    RouteState& r = routes[ri];
    int64_t id = r.current;
    Transfer& t = transfers[id];
    t.remaining -= r.cur_chunk;
    r.served_mb += r.cur_chunk;
    t.last_end = tc;
    total_chunks += 1;
    // Cancelled wins over completed (Route._finish_chunk order,
    // network.py:118-127): even a fully transferred cancelled transfer
    // never reports done.
    if (t.cancelled) {
      free_ids.push_back(id);  // dropped: no completion, no re-enqueue
    } else if (t.remaining <= 0.0) {
      done_ids.push_back(id);
      done_times.push_back(tc);
    } else {
      r.queue.push_back(id);  // round-robin fairness
    }
    serve_next(ri, tc);
  }
};

}  // namespace

extern "C" {

void* net_create() { return new Engine(); }

void net_destroy(void* h) { delete static_cast<Engine*>(h); }

int32_t net_add_route(void* h, double bw) {
  Engine* e = static_cast<Engine*>(h);
  e->routes.push_back(RouteState{bw});
  return static_cast<int32_t>(e->routes.size() - 1);
}

int64_t net_send(void* h, int32_t route, double size_mb, double now) {
  Engine* e = static_cast<Engine*>(h);
  RouteState& r = e->routes[route];
  int64_t id;
  if (!e->free_ids.empty()) {  // recycle a collected transfer slot
    id = e->free_ids.back();
    e->free_ids.pop_back();
    e->transfers[id] = Transfer{size_mb, -1.0, route, false};
  } else {
    id = static_cast<int64_t>(e->transfers.size());
    e->transfers.push_back(Transfer{size_mb, -1.0, route, false});
  }
  r.queue.push_back(id);
  if (!r.busy) e->serve_next(route, now);
  return id;
}

double net_peek(void* h) {
  Engine* e = static_cast<Engine*>(h);
  return e->heap.empty() ? HUGE_VAL : e->heap.top().time;
}

// Process every chunk completion with time <= until; returns the number of
// finished transfers now waiting in the done buffer.
int64_t net_advance(void* h, double until) {
  Engine* e = static_cast<Engine*>(h);
  while (!e->heap.empty() && e->heap.top().time <= until) {
    HeapEntry top = e->heap.top();
    e->heap.pop();
    e->complete_chunk(top.route, top.time);
  }
  return static_cast<int64_t>(e->done_ids.size() - e->done_cursor);
}

// Drain up to cap finished transfers into (ids, times); returns count.
int64_t net_collect_done(void* h, int64_t* ids, double* times, int64_t cap) {
  Engine* e = static_cast<Engine*>(h);
  int64_t n = 0;
  while (e->done_cursor < e->done_ids.size() && n < cap) {
    ids[n] = e->done_ids[e->done_cursor];
    times[n] = e->done_times[e->done_cursor];
    e->free_ids.push_back(ids[n]);
    ++e->done_cursor;
    ++n;
  }
  if (e->done_cursor == e->done_ids.size()) {
    e->done_ids.clear();
    e->done_times.clear();
    e->done_cursor = 0;
  }
  return n;
}

// Cancel a live transfer (parity with Route.cancel, network.py:81-100):
// a waiting transfer is removed from its route's queue eagerly, so
// queued_mb / realtime_bw stay exact immediately; the in-service transfer
// has its current chunk (data already on the wire) finish normally and is
// then dropped by complete_chunk.  An id that is neither queued nor in
// service already completed — no-op, matching the Python fabric's scan
// finding nothing.
void net_cancel(void* h, int64_t id) {
  Engine* e = static_cast<Engine*>(h);
  Transfer& t = e->transfers[id];
  RouteState& r = e->routes[t.route];
  if (r.current == id) {
    t.cancelled = true;
    return;
  }
  for (auto it = r.queue.begin(); it != r.queue.end(); ++it) {
    if (*it == id) {
      r.queue.erase(it);
      e->free_ids.push_back(id);
      return;
    }
  }
}

// Exact FIFO-order sum over waiting transfers (excludes the in-service
// chunk) — summed fresh like the Python property, so parity is bitwise
// rather than accumulator-drift-prone.
double net_queued_mb(void* h, int32_t route) {
  Engine* e = static_cast<Engine*>(h);
  const RouteState& r = e->routes[route];
  double total = 0.0;
  for (int64_t id : r.queue) total += e->transfers[id].remaining;
  return total;
}

// out[0]=served_mb, out[1]=n_transfers, out[2]=gap_sum
void net_route_stats(void* h, int32_t route, double* out) {
  const RouteState& r = static_cast<Engine*>(h)->routes[route];
  out[0] = r.served_mb;
  out[1] = static_cast<double>(r.n_transfers);
  out[2] = r.gap_sum;
}

int64_t net_total_chunks(void* h) {
  return static_cast<Engine*>(h)->total_chunks;
}

}  // extern "C"
