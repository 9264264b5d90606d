// treekit: native host-side tree runtime for phyml_tpu.
//
// The reference implements its tree object model and I/O in C
// (t_tree/t_edge/t_node utilities.h:635-1023, Read_Tree io.c:24);
// phyml_tpu keeps topology as flat edge arrays and builds a postorder
// "rooted view" device schedule from them (topology.py).  These are
// the only scalar host loops on the search path, so they live here:
//
//   treekit_rooted_view   postorder schedule construction (the
//                         graph-builder feeding every XLA executable;
//                         semantics identical to Topology.rooted())
//   treekit_parse_newick  newick tokenizer -> flat preorder arrays
//                         (Read_Tree io.c:24: lengths after ':',
//                         internal labels, [comments], quoted names)
//   treekit_descendants   subtree masks for SPR pruning
//
// Built on demand by phyml_tpu/native/__init__.py (g++ -O2 -shared);
// every entry point has a pure-Python fallback.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Build the rooted postorder view of an unrooted binary tree.
//   n_otu   number of tips (ids 0..n_otu-1)
//   edges   [n_edges * 2] int32 endpoints, n_edges = 2*n_otu - 3
//   blen    [n_edges] branch lengths
// Outputs (caller-allocated):
//   child        [(n_otu-1) * 2]  postorder internal child table
//   parent       [2*n_otu - 1]
//   node_blen    [2*n_otu - 1]
//   node_to_edge [2*n_otu - 1]
//   unrooted_id  [2*n_otu - 1]
// Returns 0 on success.  Child order and postorder numbering match
// the recursive Python implementation exactly.
int treekit_rooted_view(int n_otu, const int32_t* edges,
                        const double* blen, int32_t* child,
                        int32_t* parent, double* node_blen,
                        int32_t* node_to_edge, int32_t* unrooted_id) {
  const int n = n_otu;
  const int n_edges = 2 * n - 3;
  const int n_unrooted = 2 * n - 2;
  const int n_nodes = 2 * n - 1;
  const int root = n_nodes - 1;
  if (n < 3) return 1;

  // adjacency CSR in edge-insertion order (matches Python adjacency())
  std::vector<int32_t> deg(n_unrooted, 0);
  for (int e = 0; e < n_edges; ++e) {
    int a = edges[2 * e], b = edges[2 * e + 1];
    if (a < 0 || a >= n_unrooted || b < 0 || b >= n_unrooted) return 2;
    deg[a]++;
    deg[b]++;
  }
  std::vector<int32_t> off(n_unrooted + 1, 0);
  for (int v = 0; v < n_unrooted; ++v) off[v + 1] = off[v] + deg[v];
  std::vector<int32_t> nbr(off[n_unrooted]), eid(off[n_unrooted]);
  std::vector<int32_t> fill(n_unrooted, 0);
  for (int e = 0; e < n_edges; ++e) {
    int a = edges[2 * e], b = edges[2 * e + 1];
    nbr[off[a] + fill[a]] = b;
    eid[off[a] + fill[a]] = e;
    fill[a]++;
    nbr[off[b] + fill[b]] = a;
    eid[off[b] + fill[b]] = e;
    fill[b]++;
  }
  if (deg[0] != 1) return 3;
  const int tip0_nbr = nbr[off[0]];
  const int tip0_edge = eid[off[0]];

  for (int v = 0; v < n_nodes; ++v) {
    parent[v] = -1;
    node_to_edge[v] = -1;
    node_blen[v] = 0.0;
    unrooted_id[v] = -1;
  }
  std::vector<int32_t> rooted_id(n_unrooted, -1);
  for (int t = 0; t < n; ++t) rooted_id[t] = t;

  // explicit-stack emulation of the recursive postorder DFS:
  // each frame visits its children in adjacency order, numbering
  // itself only after both subtrees are complete.
  struct Frame {
    int32_t u, came;
    int32_t n_kids, next_kid;
    int32_t kid_v[2], kid_e[2];
    int32_t kid_rid[2];
  };
  std::vector<Frame> stack;
  stack.reserve(n);
  int next_internal = n;
  int n_child_rows = 0;
  int32_t final_rid = -1;

  auto open_frame = [&](int u, int came) -> int {
    Frame f;
    f.u = u;
    f.came = came;
    f.n_kids = 0;
    f.next_kid = 0;
    for (int k = off[u]; k < off[u + 1]; ++k) {
      if (nbr[k] == came) continue;
      if (f.n_kids >= 2) return 4;  // not binary
      f.kid_v[f.n_kids] = nbr[k];
      f.kid_e[f.n_kids] = eid[k];
      f.n_kids++;
    }
    if (f.n_kids != 2) return 4;
    stack.push_back(f);
    return 0;
  };

  if (tip0_nbr < n) return 5;  // 2-taxon trees handled by caller
  if (int rc = open_frame(tip0_nbr, 0)) return rc;

  while (!stack.empty()) {
    Frame& f = stack.back();
    if (f.next_kid < f.n_kids) {
      const int slot = f.next_kid;
      const int v = f.kid_v[slot];
      if (v < n) {  // tip resolves immediately
        f.kid_rid[slot] = v;
        node_to_edge[v] = f.kid_e[slot];
        node_blen[v] = blen[f.kid_e[slot]];
        f.next_kid++;
      } else {
        f.next_kid++;  // will be resolved on child completion
        if (int rc = open_frame(v, f.u)) return rc;
      }
      continue;
    }
    // both kids resolved? a child frame writes its result into the
    // parent frame before popping, so n_kids==next_kid means check
    // rids are set (tips set eagerly; internals on completion)
    const int my_id = next_internal++;
    rooted_id[f.u] = my_id;
    child[2 * n_child_rows] = f.kid_rid[0];
    child[2 * n_child_rows + 1] = f.kid_rid[1];
    n_child_rows++;
    parent[f.kid_rid[0]] = my_id;
    parent[f.kid_rid[1]] = my_id;
    const int32_t came = f.came;
    stack.pop_back();
    if (!stack.empty()) {
      Frame& p = stack.back();
      // find which of p's kid slots is this node
      for (int s = 0; s < p.n_kids; ++s) {
        if (p.kid_v[s] == f.u) {
          p.kid_rid[s] = my_id;
          node_to_edge[my_id] = p.kid_e[s];
          node_blen[my_id] = blen[p.kid_e[s]];
          break;
        }
      }
    } else {
      final_rid = my_id;
      (void)came;
    }
  }
  if (final_rid < 0 || n_child_rows != n - 2) return 6;

  // root over (tip 0, v): full length on the tip-0 side
  node_to_edge[0] = tip0_edge;
  node_blen[0] = blen[tip0_edge];
  node_to_edge[final_rid] = tip0_edge;
  node_blen[final_rid] = 0.0;
  parent[0] = root;
  parent[final_rid] = root;
  parent[root] = root;
  child[2 * (n - 2)] = 0;
  child[2 * (n - 2) + 1] = final_rid;

  for (int uu = 0; uu < n_unrooted; ++uu)
    if (rooted_id[uu] >= 0) unrooted_id[rooted_id[uu]] = uu;
  unrooted_id[root] = -1;
  return 0;
}

// Subtree membership below rooted node v (inclusive), given the
// postorder child table: out[u] = 1 iff u is in subtree(v).
int treekit_descendants(int n_otu, const int32_t* child, int32_t v,
                        uint8_t* out) {
  const int n_nodes = 2 * n_otu - 1;
  if (v < 0 || v >= n_nodes) return 1;
  std::memset(out, 0, n_nodes);
  out[v] = 1;
  for (int i = n_otu - 2; i >= 0; --i) {
    const int u = n_otu + i;
    if (out[u]) {
      out[child[2 * i]] = 1;
      out[child[2 * i + 1]] = 1;
    }
  }
  return 0;
}

// Newick tokenizer.  Fills flat PREORDER node arrays:
//   parent_idx [max_nodes]  (-1 for the root)
//   length     [max_nodes]  (NaN when absent)
//   name_off/name_len       span of the node's name/label in `s`
//                           (quotes excluded; len 0 = unnamed)
// Returns the node count, or a negative error code:
//   -1 overflow, -2 unbalanced parens, -3 syntax, -4 bad number.
long treekit_parse_newick(const char* s, long slen, long max_nodes,
                          int64_t* parent_idx, double* length,
                          int64_t* name_off, int64_t* name_len) {
  long pos = 0, n_nodes = 0;
  const double NAN_ = __builtin_nan("");

  auto skip_ws = [&]() {
    while (pos < slen) {
      const char c = s[pos];
      if (c == '[') {
        int depth = 1;
        pos++;
        while (pos < slen && depth) {
          if (s[pos] == '[') depth++;
          else if (s[pos] == ']') depth--;
          pos++;
        }
      } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                 c == '\f' || c == '\v') {
        pos++;
      } else {
        break;
      }
    }
  };

  auto read_token = [&](int64_t* toff, int64_t* tlen) {
    skip_ws();
    if (pos < slen && (s[pos] == '\'' || s[pos] == '"')) {
      const char q = s[pos++];
      *toff = pos;
      while (pos < slen && s[pos] != q) pos++;
      *tlen = pos - *toff;
      if (pos < slen) pos++;
      return;
    }
    const long start = pos;
    while (pos < slen) {
      const char c = s[pos];
      if (c == '(' || c == ')' || c == ',' || c == ':' || c == ';' ||
          c == '[')
        break;
      pos++;
    }
    long a = start, b = pos;
    while (a < b && (s[a] == ' ' || s[a] == '\t')) a++;
    while (b > a && (s[b - 1] == ' ' || s[b - 1] == '\t' ||
                     s[b - 1] == '\n' || s[b - 1] == '\r'))
      b--;
    *toff = a;
    *tlen = b - a;
  };

  auto new_node = [&](long par) -> long {
    if (n_nodes >= max_nodes) return -1;
    parent_idx[n_nodes] = par;
    length[n_nodes] = NAN_;
    name_off[n_nodes] = 0;
    name_len[n_nodes] = 0;
    return n_nodes++;
  };

  // iterative clade reader: stack of open internal nodes
  std::vector<long> open;
  long root = -1;
  long cur_parent = -1;
  bool expect_clade = true;
  long last = -1;

  while (true) {
    skip_ws();
    if (pos >= slen) break;
    const char c = s[pos];
    if (expect_clade && c == '(') {
      const long id = new_node(cur_parent);
      if (id < 0) return -1;
      if (root < 0) root = id;
      open.push_back(id);
      cur_parent = id;
      pos++;
      continue;
    }
    if (expect_clade) {  // leaf
      const long id = new_node(cur_parent);
      if (id < 0) return -1;
      if (root < 0) root = id;
      read_token(&name_off[id], &name_len[id]);
      if (name_len[id] == 0) return -3;
      skip_ws();
      if (pos < slen && s[pos] == ':') {
        pos++;
        int64_t toff, tlen;
        read_token(&toff, &tlen);
        char buf[64];
        if (tlen <= 0 || tlen >= 63) return -4;
        std::memcpy(buf, s + toff, tlen);
        buf[tlen] = 0;
        char* end = nullptr;
        length[id] = std::strtod(buf, &end);
        if (end == buf) return -4;
      }
      last = id;
      expect_clade = false;
      continue;
    }
    if (c == ',') {
      pos++;
      expect_clade = true;
      continue;
    }
    if (c == ')') {
      if (open.empty()) return -2;
      const long id = open.back();
      open.pop_back();
      cur_parent = parent_idx[id];
      pos++;
      // optional label + length on the closed clade
      read_token(&name_off[id], &name_len[id]);
      skip_ws();
      if (pos < slen && s[pos] == ':') {
        pos++;
        int64_t toff, tlen;
        read_token(&toff, &tlen);
        char buf[64];
        if (tlen <= 0 || tlen >= 63) return -4;
        std::memcpy(buf, s + toff, tlen);
        buf[tlen] = 0;
        char* end = nullptr;
        length[id] = std::strtod(buf, &end);
        if (end == buf) return -4;
      }
      last = id;
      expect_clade = false;
      continue;
    }
    if (c == ';') break;
    return -3;
  }
  if (!open.empty()) return -2;
  (void)last;
  return root == 0 ? n_nodes : (root < 0 ? -3 : n_nodes);
}

}  // extern "C"
