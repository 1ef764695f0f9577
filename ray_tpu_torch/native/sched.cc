// rsched: native cluster resource scheduler.
//
// TPU-native equivalent of the reference's C++ scheduling core (reference:
// src/ray/raylet/scheduling/cluster_resource_scheduler.h,
// policy/hybrid_scheduling_policy.h:61, policy/bundle_scheduling_policy.h):
// fixed-point resource accounting per node, hybrid pack-then-spread node
// selection with top-k randomization, spread policy, and placement-group
// bundle planning (PACK / SPREAD / STRICT_PACK / STRICT_SPREAD) with
// simulated reservations.
//
// The control plane (Python, _private/control.py) keeps node *metadata*;
// this library owns the hot selection math.  C ABI via ctypes (no pybind11
// in the image).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
  std::string id;
  bool alive = true;
  std::vector<int64_t> total;  // indexed by interned resource id
  std::vector<int64_t> avail;
};

struct Sched {
  std::mutex mu;
  double spread_threshold = 0.5;
  int topk = 1;
  std::unordered_map<std::string, int> rids;
  std::vector<std::string> rnames;
  std::unordered_map<std::string, int> node_index;
  std::vector<Node> nodes;
  uint64_t rng = 0x9e3779b97f4a7c15ULL;
};

uint64_t next_rand(Sched* s) {
  // xorshift64*
  uint64_t x = s->rng;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  s->rng = x;
  return x * 0x2545F4914F6CDD1DULL;
}

int intern(Sched* s, const char* name) {
  auto it = s->rids.find(name);
  if (it != s->rids.end()) return it->second;
  int id = static_cast<int>(s->rnames.size());
  s->rids.emplace(name, id);
  s->rnames.emplace_back(name);
  for (auto& n : s->nodes) {
    n.total.resize(s->rnames.size(), 0);
    n.avail.resize(s->rnames.size(), 0);
  }
  return id;
}

Node* find_node(Sched* s, const char* node_id) {
  auto it = s->node_index.find(node_id);
  if (it == s->node_index.end()) return nullptr;
  return &s->nodes[it->second];
}

bool fits(const Node& n, const int* ids, const int64_t* demand, int cnt) {
  for (int i = 0; i < cnt; ++i) {
    int r = ids[i];
    int64_t have = r < static_cast<int>(n.avail.size()) ? n.avail[r] : 0;
    if (have < demand[i]) return false;
  }
  return true;
}

// Critical-resource utilization after hypothetically placing `demand`
// (reference scores nodes by their most-utilized dimension).
double util_after(const Node& n, const int* ids, const int64_t* demand,
                  int cnt) {
  double u = 0.0;
  for (size_t r = 0; r < n.total.size(); ++r) {
    if (n.total[r] <= 0) continue;
    int64_t used = n.total[r] - n.avail[r];
    for (int i = 0; i < cnt; ++i)
      if (ids[i] == static_cast<int>(r)) used += demand[i];
    double ur = static_cast<double>(used) / static_cast<double>(n.total[r]);
    if (ur > u) u = ur;
  }
  return u;
}

constexpr int kPack = 0;    // hybrid: pack below threshold, then spread
constexpr int kSpread = 1;  // least utilized

// Core single-placement policy over an availability snapshot.
int pick_index(Sched* s, const std::vector<Node>& nodes, const int* ids,
               const int64_t* demand, int cnt, int strategy) {
  struct Cand {
    int idx;
    double util;
  };
  std::vector<Cand> below, above;
  for (size_t i = 0; i < nodes.size(); ++i) {
    const Node& n = nodes[i];
    if (!n.alive || !fits(n, ids, demand, cnt)) continue;
    double u = util_after(n, ids, demand, cnt);
    if (u <= s->spread_threshold)
      below.push_back({static_cast<int>(i), u});
    else
      above.push_back({static_cast<int>(i), u});
  }
  if (below.empty() && above.empty()) return -1;
  if (strategy == kSpread) {
    auto& pool = below.empty() ? above : below;
    auto best = std::min_element(
        pool.begin(), pool.end(),
        [](const Cand& a, const Cand& b) { return a.util < b.util; });
    return best->idx;
  }
  // hybrid pack: busiest node still under the spread threshold; top-k
  // randomization among the k best to avoid herding (reference:
  // hybrid_scheduling_policy.h schedule_top_k_absolute)
  if (!below.empty()) {
    std::sort(below.begin(), below.end(),
              [](const Cand& a, const Cand& b) { return a.util > b.util; });
    int k = std::min<int>(std::max(1, s->topk),
                          static_cast<int>(below.size()));
    return below[next_rand(s) % k].idx;
  }
  auto best = std::min_element(
      above.begin(), above.end(),
      [](const Cand& a, const Cand& b) { return a.util < b.util; });
  return best->idx;
}

}  // namespace

extern "C" {

void* rsched_create(double spread_threshold, int topk) {
  auto* s = new Sched();
  s->spread_threshold = spread_threshold;
  s->topk = topk;
  return s;
}

void rsched_destroy(void* h) { delete static_cast<Sched*>(h); }

int rsched_intern(void* h, const char* name) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return intern(s, name);
}

// Register or replace a node's capacity; availability resets to total
// minus nothing (caller follows with rsched_set_avail for in-use state).
void rsched_upsert_node(void* h, const char* node_id, const int* ids,
                        const int64_t* totals, int cnt) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->node_index.find(node_id);
  if (it == s->node_index.end()) {
    s->node_index.emplace(node_id, static_cast<int>(s->nodes.size()));
    s->nodes.emplace_back();
    it = s->node_index.find(node_id);
    s->nodes.back().id = node_id;
  }
  Node& n = s->nodes[it->second];
  n.alive = true;
  n.total.assign(s->rnames.size(), 0);
  n.avail.assign(s->rnames.size(), 0);
  for (int i = 0; i < cnt; ++i) {
    if (ids[i] < 0 || ids[i] >= static_cast<int>(s->rnames.size())) continue;
    n.total[ids[i]] = totals[i];
    n.avail[ids[i]] = totals[i];
  }
}

void rsched_set_alive(void* h, const char* node_id, int alive) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (n) n->alive = alive != 0;
}

void rsched_remove_node(void* h, const char* node_id) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (n) {
    n->alive = false;
    n->total.assign(n->total.size(), 0);
    n->avail.assign(n->avail.size(), 0);
  }
}

// Overwrite availability (heartbeat ground truth).
void rsched_set_avail(void* h, const char* node_id, const int* ids,
                      const int64_t* avail, int cnt) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (!n) return;
  n->avail.assign(s->rnames.size(), 0);
  for (int i = 0; i < cnt; ++i) {
    if (ids[i] < 0 || ids[i] >= static_cast<int>(s->rnames.size())) continue;
    n->avail[ids[i]] = avail[i];
  }
}

// Atomic feasibility check + subtract.  Returns 1 on success.
int rsched_acquire(void* h, const char* node_id, const int* ids,
                   const int64_t* demand, int cnt) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (!n || !n->alive || !fits(*n, ids, demand, cnt)) return 0;
  for (int i = 0; i < cnt; ++i) n->avail[ids[i]] -= demand[i];
  return 1;
}

void rsched_release(void* h, const char* node_id, const int* ids,
                    const int64_t* demand, int cnt) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (!n) return;
  for (int i = 0; i < cnt; ++i) {
    if (ids[i] < 0 || ids[i] >= static_cast<int>(n->avail.size())) continue;
    n->avail[ids[i]] += demand[i];
    if (n->avail[ids[i]] > n->total[ids[i]])
      n->avail[ids[i]] = n->total[ids[i]];
  }
}

// Pick a node (no reservation).  Returns 1 and writes the node id, or 0.
int rsched_pick(void* h, const int* ids, const int64_t* demand, int cnt,
                int strategy, char* out, int out_cap) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  int idx = pick_index(s, s->nodes, ids, demand, cnt, strategy);
  if (idx < 0) return 0;
  std::snprintf(out, out_cap, "%s", s->nodes[idx].id.c_str());
  return 1;
}

// Pick AND reserve up to `want` placements of one demand in a single
// locked pass (batched lease ramp-up: one crossing of the ctypes
// boundary instead of `want` pick+acquire round-trips).  Each pick
// subtracts the demand from the real books so successive picks spread
// correctly and the availability matches the reservation the caller is
// about to mirror into its own accounting.  Writes node indices (resolve
// via rsched_node_name) into out_indices; returns how many were placed
// (0..want).  Picks the caller rejects must be handed back with
// rsched_release.
int rsched_pick_n(void* h, const int* ids, const int64_t* demand, int cnt,
                  int strategy, int want, int* out_indices) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  int got = 0;
  for (; got < want; ++got) {
    int idx = pick_index(s, s->nodes, ids, demand, cnt, strategy);
    if (idx < 0) break;
    Node& n = s->nodes[idx];
    for (int i = 0; i < cnt; ++i) n.avail[ids[i]] -= demand[i];
    out_indices[got] = idx;
  }
  return got;
}

// Acquire up to `want` copies of one demand on one node atomically.
// Returns how many copies fit (each subtracted); 0 when the node is
// missing, dead, or full.
int rsched_acquire_n(void* h, const char* node_id, const int* ids,
                     const int64_t* demand, int cnt, int want) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (!n || !n->alive) return 0;
  int got = 0;
  for (; got < want; ++got) {
    if (!fits(*n, ids, demand, cnt)) break;
    for (int i = 0; i < cnt; ++i) n->avail[ids[i]] -= demand[i];
  }
  return got;
}

// Plan placement for a placement group's bundles against a simulated
// snapshot (2-phase commit happens elsewhere; this is the policy step).
// bundles are flattened: offsets[b]..offsets[b+1] index into ids/demands.
// strategy: 0 PACK, 1 SPREAD, 2 STRICT_PACK, 3 STRICT_SPREAD.
// Writes each bundle's chosen node index into out_nodes (index into an
// id table returned via rsched_node_name).  Returns 1 on success.
int rsched_plan_bundles(void* h, const int* ids, const int64_t* demands,
                        const int* offsets, int n_bundles, int strategy,
                        int* out_nodes) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::vector<Node> sim = s->nodes;  // snapshot to reserve against

  auto sub = [&](int node, int b) {
    for (int i = offsets[b]; i < offsets[b + 1]; ++i)
      sim[node].avail[ids[i]] -= demands[i];
  };

  if (strategy == 2) {  // STRICT_PACK: all bundles on one node
    for (size_t ni = 0; ni < sim.size(); ++ni) {
      std::vector<Node> trial = sim;
      bool ok = trial[ni].alive;
      for (int b = 0; ok && b < n_bundles; ++b) {
        if (!fits(trial[ni], ids + offsets[b], demands + offsets[b],
                  offsets[b + 1] - offsets[b])) {
          ok = false;
          break;
        }
        for (int i = offsets[b]; i < offsets[b + 1]; ++i)
          trial[ni].avail[ids[i]] -= demands[i];
      }
      if (ok) {
        for (int b = 0; b < n_bundles; ++b) out_nodes[b] = static_cast<int>(ni);
        return 1;
      }
    }
    return 0;
  }

  std::vector<bool> used(sim.size(), false);
  for (int b = 0; b < n_bundles; ++b) {
    const int* bids = ids + offsets[b];
    const int64_t* bdem = demands + offsets[b];
    int cnt = offsets[b + 1] - offsets[b];
    int chosen = -1;
    if (strategy == 3) {  // STRICT_SPREAD: distinct nodes required
      double best_u = 2.0;
      for (size_t ni = 0; ni < sim.size(); ++ni) {
        if (used[ni] || !sim[ni].alive || !fits(sim[ni], bids, bdem, cnt))
          continue;
        double u = util_after(sim[ni], bids, bdem, cnt);
        if (u < best_u) {
          best_u = u;
          chosen = static_cast<int>(ni);
        }
      }
    } else {
      chosen = pick_index(s, sim, bids, bdem, cnt,
                          strategy == 1 ? kSpread : kPack);
    }
    if (chosen < 0) return 0;
    used[chosen] = true;
    sub(chosen, b);
    out_nodes[b] = chosen;
  }
  return 1;
}

// Resolve a node index from rsched_plan_bundles to its id string.
int rsched_node_name(void* h, int index, char* out, int out_cap) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (index < 0 || index >= static_cast<int>(s->nodes.size())) return 0;
  std::snprintf(out, out_cap, "%s", s->nodes[index].id.c_str());
  return 1;
}

int64_t rsched_get_avail(void* h, const char* node_id, int rid) {
  auto* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node* n = find_node(s, node_id);
  if (!n || rid < 0 || rid >= static_cast<int>(n->avail.size())) return -1;
  return n->avail[rid];
}

}  // extern "C"
