// Approximate minimum degree ordering (quotient graph).
//
// The reference reaches minimum-degree orderings through external
// Scotch/METIS (IPARM_ORDERING — SURVEY.md section 2 row 3); this is our
// own in-tree implementation in the Amestoy-Davis-Duff style: quotient
// graph with elements, supervariable detection by adjacency hashing,
// element absorption, aggressive mass elimination, and the approximate
// external degree bound.  Used (a) standalone (API_ORDER_AMD analog) and
// (b) as the hybrid fallback inside nested dissection for subgraphs that
// bisect poorly (expander-like irregular graphs where level-set
// separators inflate fill superlinearly).
//
// C ABI only (ctypes loader; no pybind11 in this environment).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <cstring>

namespace {

using i64 = int64_t;

struct AMD {
  i64 n;
  std::vector<i64> pe;     // start of list in iw (-1: no list)
  std::vector<i64> len;    // total list length
  std::vector<i64> elen;   // #elements at the head of a variable's list
  std::vector<i64> nv;     // supervariable size (0 = absorbed into another)
  std::vector<i64> degree; // approximate external degree
  std::vector<i64> w;      // work marks
  std::vector<i64> head, next, last;  // degree buckets
  std::vector<i64> iw;     // adjacency storage
  std::vector<i64> hhead;  // hash buckets for supervariable detection
  std::vector<i64> order;  // elimination order of supervariable roots
  std::vector<i64> parent; // absorption tree: var -> representative
  i64 iwlen = 0, pfree = 0;
  i64 mindeg = 0;
  i64 wflg = 2;

  void deg_insert(i64 i) {
    i64 d = std::min(degree[i], n - 1);
    next[i] = head[d];
    last[i] = -1;
    if (head[d] >= 0) last[head[d]] = i;
    head[d] = i;
    if (d < mindeg) mindeg = d;
  }
  void deg_remove(i64 i) {
    i64 d = std::min(degree[i], n - 1);
    if (last[i] >= 0) next[last[i]] = next[i];
    else if (head[d] == i) head[d] = next[i];
    if (next[i] >= 0) last[next[i]] = last[i];
    next[i] = last[i] = -1;
  }

  // compact iw, preserving live lists (garbage collection)
  void compress(const std::vector<uint8_t>& is_elem) {
    // mark live list heads by flipping pe sign trick: standard two-pass
    std::vector<std::pair<i64, i64>> lists;  // (old pe, node)
    for (i64 i = 0; i < n; ++i) {
      if (pe[i] >= 0 && len[i] > 0 && (nv[i] > 0 || is_elem[i]))
        lists.push_back({pe[i], i});
    }
    std::sort(lists.begin(), lists.end());
    i64 p = 0;
    for (auto& [ope, node] : lists) {
      i64 l = len[node];
      if (ope != p) {
        for (i64 k = 0; k < l; ++k) iw[p + k] = iw[ope + k];
      }
      pe[node] = p;
      p += l;
    }
    pfree = p;
  }

  void ensure(i64 need, const std::vector<uint8_t>& is_elem) {
    if (pfree + need <= iwlen) return;
    compress(is_elem);
    if (pfree + need > iwlen) {
      iwlen = std::max(pfree + need, iwlen + iwlen / 2);
      iw.resize(iwlen);
    }
  }
};

}  // namespace

extern "C" {

// Approximate minimum degree; perm-out is the elimination order
// (peritab: position -> vertex).  indptr/indices: symmetric adjacency
// WITHOUT self loops.  Returns 0 on success.
int64_t pastix_amd(int64_t n, const int64_t* indptr, const int64_t* indices,
                   int64_t* peritab) {
  if (n <= 0) return n < 0 ? 1 : 0;
  AMD a;
  a.n = n;
  const i64 nnz = indptr[n];
  a.iwlen = nnz + nnz / 5 + n + 64;
  a.iw.resize(a.iwlen);
  a.pe.assign(n, -1);
  a.len.assign(n, 0);
  a.elen.assign(n, 0);
  a.nv.assign(n, 1);
  a.degree.assign(n, 0);
  a.w.assign(n, 0);
  a.head.assign(n + 1, -1);
  a.next.assign(n, -1);
  a.last.assign(n, -1);
  a.hhead.assign(n + 1, -1);
  a.parent.assign(n, -1);
  std::vector<uint8_t> is_elem(n, 0);

  for (i64 i = 0; i < n; ++i) {
    a.pe[i] = indptr[i];
    a.len[i] = indptr[i + 1] - indptr[i];
    a.degree[i] = a.len[i];
  }
  std::memcpy(a.iw.data(), indices, nnz * sizeof(i64));
  a.pfree = nnz;
  a.mindeg = 0;
  for (i64 i = 0; i < n; ++i) a.deg_insert(i);

  std::vector<i64> lp;       // the new element's supervariables
  std::vector<i64> tmp;
  i64 nelim = 0;             // eliminated original vertices

  auto clear_w = [&]() {
    if (a.wflg > (i64)1e15) {
      std::fill(a.w.begin(), a.w.end(), 0);
      a.wflg = 2;
    }
  };

  while (nelim < n) {
    // pick minimum-degree supervariable
    i64 p = -1;
    while (a.mindeg <= n - 1) {
      p = a.head[std::min(a.mindeg, n - 1)];
      if (p >= 0) break;
      ++a.mindeg;
    }
    if (p < 0) {  // nothing in buckets (should not happen) — emit leftovers
      for (i64 i = 0; i < n; ++i)
        if (a.nv[i] > 0) { a.order.push_back(i); a.nv[i] = -a.nv[i]; ++nelim; }
      break;
    }
    a.deg_remove(p);

    // dense endgame: the minimum-degree pivot touches everything still
    // live — the remainder is a (near-)clique whose internal order cannot
    // change fill; emit it by degree and stop updating the quotient graph
    if (a.degree[p] >= n - nelim - a.nv[p]) {
      a.order.push_back(p);
      nelim += a.nv[p];
      a.nv[p] = -a.nv[p];
      for (i64 d = 0; d <= n - 1 && nelim < n; ++d) {
        for (i64 v = a.head[d]; v >= 0; v = a.next[v]) {
          if (a.nv[v] > 0) {
            a.order.push_back(v);
            nelim += a.nv[v];
            a.nv[v] = -a.nv[v];
          }
        }
      }
      break;
    }

    // ---- form element p: union of p's variables and its elements' vars
    lp.clear();
    clear_w();
    const i64 mark = a.wflg++;
    a.w[p] = mark;
    const i64 pp = a.pe[p], pl = a.len[p], pel = a.elen[p];
    for (i64 k = 0; k < pl; ++k) {
      const i64 e = a.iw[pp + k];
      if (k < pel) {
        // element: take its live variables
        const i64 ep = a.pe[e], el = a.len[e];
        for (i64 j = 0; j < el; ++j) {
          const i64 v = a.iw[ep + j];
          if (a.nv[v] > 0 && a.w[v] != mark) {
            a.w[v] = mark;
            lp.push_back(v);
          }
        }
        a.pe[e] = -1;  // absorbed into p
        a.len[e] = 0;
        is_elem[e] = 0;
      } else {
        const i64 v = a.iw[pp + k];
        if (a.nv[v] > 0 && a.w[v] != mark) {
          a.w[v] = mark;
          lp.push_back(v);
        }
      }
    }
    // eliminate p
    a.order.push_back(p);
    nelim += a.nv[p];
    a.nv[p] = -a.nv[p];

    // store element p's variable list
    a.ensure((i64)lp.size(), is_elem);
    a.pe[p] = a.pfree;
    a.len[p] = (i64)lp.size();
    a.elen[p] = -1;
    is_elem[p] = 1;
    for (i64 v : lp) a.iw[a.pfree++] = v;

    // |Lp| weight (for approximate degrees)
    i64 lpw = 0;
    for (i64 v : lp) lpw += a.nv[v];

    // ---- aggregate |Le \ Lp| for every element touching Lp ----------
    // (one O(|Le|) scan per element per pivot, not per variable — the
    // classic AMD w-array trick; quadratic rescans otherwise)
    clear_w();
    const i64 emark = a.wflg;
    a.wflg += n + 2;
    for (i64 v : lp) {
      const i64 vp = a.pe[v], vel = a.elen[v];
      for (i64 k = 0; k < vel; ++k) {
        const i64 e = a.iw[vp + k];
        if (e == p || a.pe[e] < 0 || !is_elem[e]) continue;
        if (a.w[e] < emark) {
          i64 wt = 0;  // live weight of element e
          const i64 ep = a.pe[e], el = a.len[e];
          for (i64 j = 0; j < el; ++j) {
            const i64 u = a.iw[ep + j];
            if (a.nv[u] > 0) wt += a.nv[u];
          }
          a.w[e] = emark + wt;
        }
        a.w[e] -= a.nv[v];
      }
    }

    // ---- update each variable in Lp -------------------------------
    for (i64 v : lp) {
      a.deg_remove(v);
      // rebuild v's list: live elements (now including p) + variables
      // not in Lp (those in Lp are covered by element p)
      const i64 vp = a.pe[v], vl = a.len[v], vel = a.elen[v];
      tmp.clear();
      tmp.push_back(p);
      i64 outer = 0;  // sum |Le \ Lp| over v's other elements
      for (i64 k = 0; k < vel; ++k) {
        const i64 e = a.iw[vp + k];
        if (e == p || a.pe[e] < 0 || !is_elem[e]) continue;
        const i64 ext = a.w[e] - emark;
        if (ext <= 0) {
          // aggressive absorption: Le is covered by Lp — kill element e
          a.pe[e] = -1;
          a.len[e] = 0;
          is_elem[e] = 0;
          continue;
        }
        tmp.push_back(e);
        outer += ext;
      }
      const i64 nel_new = (i64)tmp.size();
      i64 nvars = 0;
      for (i64 k = vel; k < vl; ++k) {
        const i64 u = a.iw[vp + k];
        if (a.nv[u] <= 0) continue;       // eliminated/absorbed
        if (a.w[u] == mark) continue;     // covered by element p
        tmp.push_back(u);
        ++nvars;
        outer += a.nv[u];
      }
      // write back (in place if it fits, else append)
      if ((i64)tmp.size() <= vl) {
        for (size_t k = 0; k < tmp.size(); ++k) a.iw[vp + k] = tmp[k];
        a.pe[v] = vp;
      } else {
        a.ensure((i64)tmp.size(), is_elem);
        a.pe[v] = a.pfree;
        for (i64 u : tmp) a.iw[a.pfree++] = u;
      }
      a.len[v] = (i64)tmp.size();
      a.elen[v] = nel_new;
      // approximate external degree (AMD bound)
      i64 d = std::min<i64>(a.degree[v] + lpw - a.nv[v],
                            (lpw - a.nv[v]) + outer);
      d = std::min(d, n - nelim - a.nv[v]);
      a.degree[v] = std::max<i64>(d, 0);
    }

    // ---- supervariable detection within Lp (hash on list content) --
    std::vector<i64> hnext(lp.size(), -1), hid(lp.size(), 0);
    for (size_t vi = 0; vi < lp.size(); ++vi) {
      const i64 v = lp[vi];
      if (a.nv[v] <= 0) continue;
      i64 h = 0;
      const i64 vp = a.pe[v];
      for (i64 k = 0; k < a.len[v]; ++k) h += a.iw[vp + k];
      h = ((h % (n + 1)) + (n + 1)) % (n + 1);
      hid[vi] = h;
      hnext[vi] = a.hhead[h];
      a.hhead[h] = (i64)vi;
    }
    for (size_t vi = 0; vi < lp.size(); ++vi) {
      const i64 v = lp[vi];
      if (a.nv[v] <= 0) continue;
      for (i64 uj = hnext[vi]; uj >= 0; uj = hnext[uj]) {
        const i64 u = lp[uj];
        if (a.nv[u] <= 0 || a.len[u] != a.len[v] ||
            a.elen[u] != a.elen[v])
          continue;
        // exact list comparison as sets (sort both views)
        const i64 lv = a.len[v];
        std::vector<i64> sv(a.iw.begin() + a.pe[v],
                            a.iw.begin() + a.pe[v] + lv);
        std::vector<i64> su(a.iw.begin() + a.pe[u],
                            a.iw.begin() + a.pe[u] + lv);
        std::sort(sv.begin(), sv.end());
        std::sort(su.begin(), su.end());
        bool same = true;
        for (i64 k = 0; k < lv; ++k) {
          i64 x = sv[k], y = su[k];
          // ignore mutual references v<->u
          if (x == u) x = v;
          if (y == u) y = v;
          if (x == v && y == v) continue;
          if (x != y) { same = false; break; }
        }
        if (same) {
          // absorb u into v
          a.deg_remove(u);
          a.nv[v] += a.nv[u];
          a.nv[u] = 0;
          a.parent[u] = v;
          a.pe[u] = -1;
          a.len[u] = 0;
        }
      }
    }

    // clear only the hash buckets this round touched (O(|Lp|), not O(n))
    for (size_t vi = 0; vi < lp.size(); ++vi) a.hhead[hid[vi]] = -1;

    // reinsert surviving Lp variables with updated degrees
    for (i64 v : lp) {
      if (a.nv[v] > 0) a.deg_insert(v);
    }
  }

  // ---- expand supervariable roots into the final permutation --------
  // absorbed variables follow their representative, in absorption order
  std::vector<std::vector<i64>> members(n);
  for (i64 i = 0; i < n; ++i)
    if (a.parent[i] >= 0) {
      i64 r = a.parent[i];
      while (a.parent[r] >= 0) r = a.parent[r];
      members[r].push_back(i);
    }
  i64 pos = 0;
  for (i64 root : a.order) {
    peritab[pos++] = root;
    for (i64 m : members[root]) peritab[pos++] = m;
  }
  if (pos != n) return 2;
  return 0;
}

}  // extern "C"
