// nstpu_native: the host-side native runtime of navierstokes_tpu_torch, a
// copy of the JAX package's `native/src/nstpu_native.cpp`.
//
// It covers host roles the reference implements natively: the mesh data
// loader (read_mesh, src/solve_newton.c:91-197), the sparsity-graph build
// (the MatSeqBAIJSetPreallocation + MatSetValuesBlocked pattern machinery)
// and bandwidth-reducing ordering.  All functions are exported with C
// linkage for ctypes; Python keeps numpy versions with identical output.
// No device code: the CUDA kernels are `csrc/*.cu`, built apart.
//
// Built by g++ at first use into navierstokes_tpu_torch/_build/
// (`native/__init__.py`).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <numeric>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Gmsh 2.2 ASCII parser (semantics of the reference reader: type 4 = tet,
// types 2/3 = boundary facets; tags[1:] scanned for {1,2,4,5,6,7}; last
// writer wins on node tags).
// ---------------------------------------------------------------------------

struct GmshMesh {
  std::vector<double> coords;    // nv * 3
  std::vector<int32_t> tets;     // ne * 4
  std::vector<int32_t> tags;     // nv
  std::string error;
};

bool collected_tag(long t) {
  return t == 1 || t == 2 || t == 4 || t == 5 || t == 6 || t == 7;
}

// Fast forward over whitespace, parse one long.
inline const char* parse_long(const char* p, const char* end, long* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  char* q;
  *out = strtol(p, &q, 10);
  return q;
}

inline const char* parse_double(const char* p, const char* end, double* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  char* q;
  *out = strtod(p, &q);
  return q;
}

GmshMesh* parse_gmsh_file(const char* path) {
  auto* m = new GmshMesh();
  FILE* f = fopen(path, "rb");
  if (!f) {
    m->error = std::string("cannot open ") + path;
    return m;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    m->error = "short read";
    return m;
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = p + size;

  auto find_section = [&](const char* name) -> const char* {
    const char* s = strstr(p, name);
    return s;
  };

  const char* nodes = find_section("$Nodes");
  if (!nodes) {
    m->error = "no $Nodes section";
    return m;
  }
  const char* cur = nodes + strlen("$Nodes");
  long nv;
  cur = parse_long(cur, end, &nv);
  m->coords.resize(nv * 3);
  m->tags.assign(nv, -1);
  for (long i = 0; i < nv; ++i) {
    long id;
    cur = parse_long(cur, end, &id);
    cur = parse_double(cur, end, &m->coords[3 * i + 0]);
    cur = parse_double(cur, end, &m->coords[3 * i + 1]);
    cur = parse_double(cur, end, &m->coords[3 * i + 2]);
  }

  const char* elems = strstr(cur, "$Elements");
  if (!elems) {
    m->error = "no $Elements section";
    return m;
  }
  cur = elems + strlen("$Elements");
  long total;
  cur = parse_long(cur, end, &total);
  m->tets.reserve(total * 4);
  for (long i = 0; i < total; ++i) {
    long id, type, ntags;
    cur = parse_long(cur, end, &id);
    cur = parse_long(cur, end, &type);
    cur = parse_long(cur, end, &ntags);
    long tags[16];
    for (long t = 0; t < ntags && t < 16; ++t) cur = parse_long(cur, end, &tags[t]);
    if (type == 4) {
      for (int j = 0; j < 4; ++j) {
        long v;
        cur = parse_long(cur, end, &v);
        m->tets.push_back(static_cast<int32_t>(v - 1));
      }
    } else if (type == 2 || type == 3) {
      long surface = -1;
      for (long t = 1; t < ntags; ++t) {
        if (collected_tag(tags[t])) {
          surface = tags[t];
          break;
        }
      }
      int nvert = (type == 2) ? 3 : 4;
      for (int j = 0; j < nvert; ++j) {
        long v;
        cur = parse_long(cur, end, &v);
        if (surface != -1) m->tags[v - 1] = static_cast<int32_t>(surface);
      }
    } else {
      // Skip this element's node list: number of nodes per gmsh type.
      static const int nodes_per_type[32] = {0, 2, 3, 4, 4, 8, 6, 5, 3, 6,
                                             9, 10, 27, 18, 14, 1, 8, 20,
                                             15, 13, 0, 0, 0, 0, 0, 0, 0,
                                             0, 0, 0, 0, 0};
      int skip = (type >= 0 && type < 32) ? nodes_per_type[type] : 0;
      for (int j = 0; j < skip; ++j) {
        long v;
        cur = parse_long(cur, end, &v);
      }
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// Sparsity-graph build: tets -> deduplicated BCSR pattern + element scatter
// map (the static "graph" every assembly reuses).
// ---------------------------------------------------------------------------

struct Pattern {
  std::vector<int32_t> indptr;        // nv + 1
  std::vector<int32_t> indices;       // nnzb
  std::vector<int32_t> slot_of_pair;  // ne * 16
};

Pattern* build_pattern_impl(int64_t nv, int64_t ne, const int32_t* tets) {
  auto* pat = new Pattern();
  const int64_t npairs = ne * 16;
  std::vector<int64_t> keys(npairs);
  for (int64_t e = 0; e < ne; ++e) {
    const int32_t* t = tets + 4 * e;
    int64_t* k = keys.data() + 16 * e;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        k[4 * i + j] = static_cast<int64_t>(t[i]) * nv + t[j];
  }
  std::vector<int64_t> sorted = keys;
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());

  pat->indices.resize(sorted.size());
  pat->indptr.assign(nv + 1, 0);
  for (size_t s = 0; s < sorted.size(); ++s) {
    pat->indices[s] = static_cast<int32_t>(sorted[s] % nv);
    pat->indptr[sorted[s] / nv + 1]++;
  }
  std::partial_sum(pat->indptr.begin(), pat->indptr.end(), pat->indptr.begin());

  pat->slot_of_pair.resize(npairs);
  for (int64_t i = 0; i < npairs; ++i) {
    auto it = std::lower_bound(sorted.begin(), sorted.end(), keys[i]);
    pat->slot_of_pair[i] = static_cast<int32_t>(it - sorted.begin());
  }
  return pat;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee on the node adjacency graph.
// ---------------------------------------------------------------------------

void rcm_impl(int64_t nv, const int32_t* indptr, const int32_t* indices,
              int32_t* perm_out) {
  std::vector<int32_t> degree(nv);
  for (int64_t i = 0; i < nv; ++i) degree[i] = indptr[i + 1] - indptr[i];

  std::vector<char> visited(nv, 0);
  std::vector<int32_t> order;
  order.reserve(nv);

  std::vector<int32_t> by_degree(nv);
  std::iota(by_degree.begin(), by_degree.end(), 0);
  std::stable_sort(by_degree.begin(), by_degree.end(),
                   [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });

  size_t scan = 0;
  std::deque<int32_t> q;
  std::vector<int32_t> nbrs;
  while (order.size() < static_cast<size_t>(nv)) {
    while (scan < by_degree.size() && visited[by_degree[scan]]) ++scan;
    int32_t start = by_degree[scan];
    visited[start] = 1;
    q.push_back(start);
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop_front();
      order.push_back(u);
      nbrs.clear();
      for (int32_t s = indptr[u]; s < indptr[u + 1]; ++s) {
        int32_t v = indices[s];
        if (v != u && !visited[v]) nbrs.push_back(v);
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
        return degree[a] < degree[b];
      });
      for (int32_t v : nbrs) {
        visited[v] = 1;
        q.push_back(v);
      }
    }
  }
  for (int64_t i = 0; i < nv; ++i) perm_out[i] = order[nv - 1 - i];
}

}  // namespace

extern "C" {

// --- gmsh ---
void* nstpu_gmsh_parse(const char* path) { return parse_gmsh_file(path); }
const char* nstpu_gmsh_error(void* h) {
  auto* m = static_cast<GmshMesh*>(h);
  return m->error.empty() ? nullptr : m->error.c_str();
}
int64_t nstpu_gmsh_nv(void* h) {
  return static_cast<GmshMesh*>(h)->coords.size() / 3;
}
int64_t nstpu_gmsh_ne(void* h) {
  return static_cast<GmshMesh*>(h)->tets.size() / 4;
}
void nstpu_gmsh_fill(void* h, double* coords, int32_t* tets, int32_t* tags) {
  auto* m = static_cast<GmshMesh*>(h);
  memcpy(coords, m->coords.data(), m->coords.size() * sizeof(double));
  memcpy(tets, m->tets.data(), m->tets.size() * sizeof(int32_t));
  memcpy(tags, m->tags.data(), m->tags.size() * sizeof(int32_t));
}
void nstpu_gmsh_free(void* h) { delete static_cast<GmshMesh*>(h); }

// --- pattern ---
void* nstpu_pattern_build(int64_t nv, int64_t ne, const int32_t* tets) {
  return build_pattern_impl(nv, ne, tets);
}
int64_t nstpu_pattern_nnzb(void* h) {
  return static_cast<Pattern*>(h)->indices.size();
}
void nstpu_pattern_fill(void* h, int32_t* indptr, int32_t* indices,
                        int32_t* slot_of_pair) {
  auto* p = static_cast<Pattern*>(h);
  memcpy(indptr, p->indptr.data(), p->indptr.size() * sizeof(int32_t));
  memcpy(indices, p->indices.data(), p->indices.size() * sizeof(int32_t));
  memcpy(slot_of_pair, p->slot_of_pair.data(),
         p->slot_of_pair.size() * sizeof(int32_t));
}
void nstpu_pattern_free(void* h) { delete static_cast<Pattern*>(h); }

// --- rcm ---
void nstpu_rcm(int64_t nv, const int32_t* indptr, const int32_t* indices,
               int32_t* perm_out) {
  rcm_impl(nv, indptr, indices, perm_out);
}

}  // extern "C"
