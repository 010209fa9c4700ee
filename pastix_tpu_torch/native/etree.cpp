// Native elimination-tree toolkit: etree, postorder, column counts.
//
// C++ twins of pastix_tpu/order/etree.py (reference kass/find_supernodes
// prerequisites — SURVEY.md §2 row 5): Liu's elimination-tree algorithm
// with path compression, iterative postorder, and the Gilbert-Ng-Peyton
// O(nnz * alpha) column-count algorithm that feeds the exact cost model.

#include <cstdint>
#include <vector>
#include <algorithm>

namespace {
using i64 = int64_t;
}

extern "C" {

// Elimination tree of a symmetric pattern (full CSC). parent[n] out.
void pastix_etree(i64 n, const i64* indptr, const i64* indices,
                  i64* parent) {
  std::vector<i64> ancestor(n);
  for (i64 j = 0; j < n; ++j) {
    parent[j] = -1;
    ancestor[j] = -1;
    for (i64 e = indptr[j]; e < indptr[j + 1]; ++e) {
      i64 i = indices[e];
      if (i >= j) continue;
      // walk from i to the root of its current subtree, compressing
      while (true) {
        i64 a = ancestor[i];
        if (a == j) break;
        ancestor[i] = j;
        if (a == -1) {
          parent[i] = j;
          break;
        }
        i = a;
      }
    }
  }
}

// Iterative postorder of the forest. post[n] out; returns 0 ok.
i64 pastix_postorder(i64 n, const i64* parent, i64* post) {
  std::vector<i64> head(n + 1, -1), nxt(n);
  for (i64 j = n - 1; j >= 0; --j) {
    const i64 p = parent[j] == -1 ? n : parent[j];
    nxt[j] = head[p];
    head[p] = j;
  }
  std::vector<i64> stack;
  i64 k = 0;
  for (i64 root = head[n]; root != -1; root = nxt[root]) {
    stack.push_back(root);
    while (!stack.empty()) {
      const i64 node = stack.back();
      const i64 child = head[node];
      if (child == -1) {
        post[k++] = node;
        stack.pop_back();
      } else {
        head[node] = nxt[child];
        stack.push_back(child);
      }
    }
  }
  return k == n ? 0 : 1;
}

// Gilbert-Ng-Peyton column counts (nnz of L(:,j) incl. diagonal).
// pattern: full symmetric CSC.  counts[n] out.
void pastix_colcounts(i64 n, const i64* indptr, const i64* indices,
                      const i64* parent, const i64* post, i64* counts) {
  std::vector<i64> first(n, -1), maxfirst(n, -1), prevleaf(n, -1),
      ancestor(n), delta(n, 0), invpost(n);
  for (i64 k = 0; k < n; ++k) invpost[post[k]] = k;
  // first[j]: smallest postorder position in j's subtree; delta init
  for (i64 k = 0; k < n; ++k) {
    const i64 j = post[k];
    delta[j] = (first[j] == -1) ? 1 : 0;  // leaf in the etree
    for (i64 q = j; q != -1 && first[q] == -1; q = parent[q]) first[q] = k;
  }
  for (i64 i = 0; i < n; ++i) ancestor[i] = i;
  for (i64 k = 0; k < n; ++k) {
    const i64 j = post[k];
    if (parent[j] != -1) delta[parent[j]]--;  // j is not a leaf of parent
    for (i64 e = indptr[j]; e < indptr[j + 1]; ++e) {
      const i64 i = indices[e];
      if (i <= j || first[j] <= maxfirst[i]) continue;
      maxfirst[i] = first[j];
      const i64 jprev = prevleaf[i];
      prevleaf[i] = j;
      if (jprev == -1) {
        delta[j]++;  // j is the first leaf of row subtree i
      } else {
        // LCA of jprev and j with path compression
        i64 q = jprev;
        while (q != ancestor[q]) q = ancestor[q];
        for (i64 s = jprev; s != q;) {
          const i64 sp = ancestor[s];
          ancestor[s] = q;
          s = sp;
        }
        delta[j]++;
        delta[q]--;
      }
    }
    if (parent[j] != -1) ancestor[j] = parent[j];
  }
  for (i64 j = 0; j < n; ++j) counts[j] = delta[j];
  // accumulate deltas up the tree in postorder
  for (i64 k = 0; k < n; ++k) {
    const i64 j = post[k];
    if (parent[j] != -1) counts[parent[j]] += counts[j];
  }
}
}
