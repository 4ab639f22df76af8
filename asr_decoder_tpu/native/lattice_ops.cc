// Native lattice operations (C ABI): n-shortest-path extraction over the
// framework's binary lattice format.
//
// The SURVEY §7 plan keeps the reference's irregular host-side lattice
// algebra native in this build (the reference implements it in C++ at
// src/newfst/lattice-to-nbest.cc:15-147): this module is the hot
// result-building step of the post-processing service — lattice bytes in,
// ranked (words, ilabels, graph_cost, am_cost) out — with EXACTLY the
// semantics of fst/nbest.py::nshortest (reverse-Viterbi backward scores +
// A* expansion, pop-order ties broken by insertion sequence, optional
// unique-word-sequence dedup, same pop budget), so the Python and native
// paths are interchangeable and parity-tested.
//
// Lattice wire format (fst/lattice.py _read_stream):
//   i32 start, i32 nstates, i32 narcs,
//   per state: i32 narcs_s, f32 final1, f32 final2,
//              then per arc: i32 il, i32 ol, f32 w1, f32 w2, i32 dst
// A state is final iff final1 + final2 < +inf.
//
// Build: g++ -O2 -shared -fPIC -o liblatops.so lattice_ops.cc

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct Arc {
  int32_t il, ol, dst;
  float w1, w2;
};

struct Lat {
  int32_t start = -1;
  std::vector<std::vector<Arc>> arcs;
  std::vector<float> f1, f2;   // final weights (inf = not final)
};

const float kInf = std::numeric_limits<float>::infinity();

bool Parse(const uint8_t* p, size_t len, Lat* lat) {
  if (len < 12) return false;
  int32_t start, ns, na;
  std::memcpy(&start, p, 4);
  std::memcpy(&ns, p + 4, 4);
  std::memcpy(&na, p + 8, 4);
  if (ns < 0 || na < 0) return false;
  size_t off = 12;
  lat->start = start;
  lat->arcs.assign(ns, {});
  lat->f1.assign(ns, kInf);
  lat->f2.assign(ns, kInf);
  for (int32_t s = 0; s < ns; ++s) {
    if (off + 12 > len) return false;
    int32_t cnt;
    std::memcpy(&cnt, p + off, 4);
    std::memcpy(&lat->f1[s], p + off + 4, 4);
    std::memcpy(&lat->f2[s], p + off + 8, 4);
    off += 12;
    if (cnt < 0 || off + 20ull * cnt > len) return false;
    lat->arcs[s].resize(cnt);
    for (int32_t i = 0; i < cnt; ++i) {
      Arc& a = lat->arcs[s][i];
      std::memcpy(&a.il, p + off, 4);
      std::memcpy(&a.ol, p + off + 4, 4);
      std::memcpy(&a.w1, p + off + 8, 4);
      std::memcpy(&a.w2, p + off + 12, 4);
      std::memcpy(&a.dst, p + off + 16, 4);
      off += 20;
      if (a.dst < 0 || a.dst >= ns) return false;
    }
  }
  return true;
}

// Kahn topological order; false on cycle (fst/lattice.py topsort_order).
bool TopOrder(const Lat& lat, std::vector<int32_t>* order) {
  int32_t ns = lat.arcs.size();
  std::vector<int32_t> indeg(ns, 0);
  for (const auto& as : lat.arcs)
    for (const Arc& a : as) indeg[a.dst]++;
  std::vector<int32_t> stack;
  for (int32_t s = 0; s < ns; ++s)
    if (indeg[s] == 0) stack.push_back(s);
  order->clear();
  while (!stack.empty()) {
    int32_t s = stack.back();
    stack.pop_back();
    order->push_back(s);
    for (const Arc& a : lat.arcs[s])
      if (--indeg[a.dst] == 0) stack.push_back(a.dst);
  }
  return (int32_t)order->size() == ns;
}

struct HeapEnt {
  double f;
  int64_t cnt;
  int32_t state;
  int32_t path;   // index into path nodes, -1 = empty
  bool operator>(const HeapEnt& o) const {
    return f != o.f ? f > o.f : cnt > o.cnt;
  }
};

struct PathNode {
  int32_t parent;            // -1 at root
  const Arc* arc;
};

}  // namespace

extern "C" {

// n-shortest paths; writes a malloc'd result buffer:
//   per path: u32 nw, i32 words[nw], u32 ni, i32 ilabels[ni],
//             f32 graph_cost, f32 am_cost
// Returns the number of paths (≥0) or -1 on malformed input.
int lat_nbest(const uint8_t* data, size_t len, int n, int unique_words,
              uint8_t** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  Lat lat;
  if (!Parse(data, len, &lat)) return -1;
  int32_t ns = lat.arcs.size();
  if (lat.start < 0 || lat.start >= ns || ns == 0 || n <= 0) return 0;

  std::vector<int32_t> order;
  if (!TopOrder(lat, &order)) return -1;   // cyclic
  // backward best cost-to-final (fst/nbest.py backward_scores)
  std::vector<double> beta(ns, kInf);
  for (int32_t s = 0; s < ns; ++s)
    if (lat.f1[s] < kInf) beta[s] = (double)lat.f1[s] + lat.f2[s];
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    int32_t s = *it;
    for (const Arc& a : lat.arcs[s]) {
      double c = (double)a.w1 + a.w2 + beta[a.dst];
      if (c < beta[s]) beta[s] = c;
    }
  }
  if (beta[lat.start] == kInf) return 0;

  std::priority_queue<HeapEnt, std::vector<HeapEnt>, std::greater<HeapEnt>>
      heap;
  std::vector<PathNode> nodes;
  int64_t cnt = 0;
  heap.push({beta[lat.start], cnt, lat.start, -1});
  std::unordered_set<std::string> seen;
  std::string buf;
  int64_t budget = std::max<int64_t>(10000, 1000ll * n);
  int results = 0;
  while (!heap.empty() && results < n && budget > 0) {
    --budget;
    HeapEnt e = heap.top();
    heap.pop();
    if (lat.f1[e.state] < kInf) {
      // reconstruct the path arcs in forward order
      std::vector<const Arc*> path;
      for (int32_t p = e.path; p >= 0; p = nodes[p].parent)
        path.push_back(nodes[p].arc);
      std::reverse(path.begin(), path.end());
      std::vector<int32_t> words, ils;
      double g = lat.f1[e.state], am = lat.f2[e.state];
      for (const Arc* a : path) {
        if (a->ol != 0) words.push_back(a->ol);
        if (a->il != 0) ils.push_back(a->il);
        g += a->w1;
        am += a->w2;
      }
      bool fresh = true;
      if (unique_words) {
        buf.assign(reinterpret_cast<const char*>(words.data()),
                   words.size() * 4);
        fresh = seen.insert(buf).second;
      }
      if (fresh) {
        size_t need = 4 + 4 * words.size() + 4 + 4 * ils.size() + 8;
        size_t pos = *out_len;
        uint8_t* grown =
            static_cast<uint8_t*>(std::realloc(*out, pos + need));
        if (!grown) {  // keep *out valid for the caller's free()
          return -2;
        }
        *out = grown;
        uint8_t* q = *out + pos;
        uint32_t nw = words.size(), ni = ils.size();
        std::memcpy(q, &nw, 4);
        q += 4;
        std::memcpy(q, words.data(), 4 * nw);
        q += 4 * nw;
        std::memcpy(q, &ni, 4);
        q += 4;
        std::memcpy(q, ils.data(), 4 * ni);
        q += 4 * ni;
        float gf = (float)g, af = (float)am;
        std::memcpy(q, &gf, 4);
        std::memcpy(q + 4, &af, 4);
        *out_len = pos + need;
        ++results;
      }
    }
    double gcost = e.f - beta[e.state];
    for (const Arc& a : lat.arcs[e.state]) {
      if (beta[a.dst] == kInf) continue;
      ++cnt;
      nodes.push_back({e.path, &a});
      heap.push({gcost + a.w1 + a.w2 + beta[a.dst], cnt, a.dst,
                 (int32_t)nodes.size() - 1});
    }
  }
  return results;
}

void lat_free(uint8_t* p) { std::free(p); }

}  // extern "C"
