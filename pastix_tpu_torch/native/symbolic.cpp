// Native supernodal block symbolic factorization.
//
// The C++ twin of pastix_tpu/symbolic/fax.py (reference symbolFaxGraph,
// src/fax/src/symbol_fax_graph.c wrapping symbol_fax.c — SURVEY.md §2
// row 4): quotient-graph column merge.  For each supernode, its off-
// diagonal row structure is the union of its A-pattern rows and its
// children's structures (minus the parent's own columns), split into
// dense blocks at row gaps and supernode boundaries.  A byte-mask
// workspace makes each merge linear; only the collected rows are sorted.
//
// Handle-based C ABI (compute -> query sizes -> copy -> free) for ctypes.

#include <cstdint>
#include <vector>
#include <algorithm>

namespace {
using i64 = int64_t;

struct SymbResult {
  std::vector<i64> blok_ptr, frow, lrow, targ;
};
}  // namespace

extern "C" {

// pattern: full symmetric CSC (indptr[n+1], indices); rangtab[nsup+1].
// Returns a heap handle; *nblok_out receives the total block count.
void* pastix_symbfact(i64 n, const i64* indptr, const i64* indices,
                      i64 nsup, const i64* rangtab, i64* nblok_out) {
  std::vector<i64> snode(n);
  for (i64 k = 0; k < nsup; ++k)
    for (i64 c = rangtab[k]; c < rangtab[k + 1]; ++c) snode[c] = k;

  auto* res = new SymbResult();
  res->blok_ptr.assign(nsup + 1, 0);
  std::vector<std::vector<i64>> structv(nsup);
  std::vector<std::vector<i64>> kids(nsup);
  std::vector<char> mark(n, 0);
  std::vector<i64> collect;

  for (i64 k = 0; k < nsup; ++k) {
    const i64 c1 = rangtab[k + 1];
    collect.clear();
    for (i64 c = rangtab[k]; c < c1; ++c) {
      for (i64 e = indptr[c]; e < indptr[c + 1]; ++e) {
        const i64 r = indices[e];
        if (r >= c1 && !mark[r]) {
          mark[r] = 1;
          collect.push_back(r);
        }
      }
    }
    for (i64 ck : kids[k]) {
      auto& cs = structv[ck];
      auto it = std::lower_bound(cs.begin(), cs.end(), c1);
      for (; it != cs.end(); ++it) {
        if (!mark[*it]) {
          mark[*it] = 1;
          collect.push_back(*it);
        }
      }
      cs.clear();
      cs.shrink_to_fit();
    }
    kids[k].clear();
    std::sort(collect.begin(), collect.end());
    for (i64 r : collect) mark[r] = 0;
    structv[k] = collect;

    if (!collect.empty()) {
      const i64 parent = snode[collect[0]];
      kids[parent].push_back(k);
      // split into blocks at gaps / supernode boundaries
      i64 start = 0;
      for (i64 i = 1; i <= (i64)collect.size(); ++i) {
        const bool brk =
            i == (i64)collect.size() || collect[i] != collect[i - 1] + 1 ||
            snode[collect[i]] != snode[collect[i - 1]];
        if (brk) {
          res->frow.push_back(collect[start]);
          res->lrow.push_back(collect[i - 1]);
          res->targ.push_back(snode[collect[start]]);
          start = i;
        }
      }
    }
    res->blok_ptr[k + 1] = (i64)res->frow.size();
  }
  *nblok_out = (i64)res->frow.size();
  return res;
}

void pastix_symb_copy(void* handle, i64* blok_ptr, i64* frow, i64* lrow,
                      i64* targ) {
  auto* res = static_cast<SymbResult*>(handle);
  std::copy(res->blok_ptr.begin(), res->blok_ptr.end(), blok_ptr);
  std::copy(res->frow.begin(), res->frow.end(), frow);
  std::copy(res->lrow.begin(), res->lrow.end(), lrow);
  std::copy(res->targ.begin(), res->targ.end(), targ);
}

void pastix_symb_free(void* handle) {
  delete static_cast<SymbResult*>(handle);
}
}
