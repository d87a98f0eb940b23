// Host C++: OCR-Jaccard adjacency and edge list by posting lists (plain C
// ABI, ctypes).
//
// The port's copy of ultrafnd_git_tpu/native/graphops.cpp, reduced to the
// dense adjacency and the edge list the port binds. Only pairs that share a token can have a
// nonzero intersection, so intersections are counted through per-token
// posting lists in O(sum_t |d_t|^2) instead of the O(N^2 V) incidence
// matmul of the numpy path in ops/jaccard.py.
//
// Numerics: intersection and union counts are exact integers; the ratio is
// computed in float32 with the numpy path's +1e-9f and operation order, so
// both paths give the same bits.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline float jac_f32(int64_t inter, int64_t len_i, int64_t len_j) {
  // numpy's order: union = f32(len_i) + f32(len_j) - f32(inter);
  // jac = f32(inter) / (union + 1e-9f)
  const float inter_f = static_cast<float>(inter);
  const float union_f = static_cast<float>(len_i) + static_cast<float>(len_j) - inter_f;
  return inter_f / (union_f + 1e-9f);
}

// Calls emit(i, j, jac) once per unordered pair (j < i) with a nonzero
// intersection.
template <typename Emit>
void for_each_intersecting_pair(const int64_t* row_off, const int32_t* tok,
                                int64_t n, int64_t vocab, Emit&& emit) {
  const int64_t nnz = row_off[n];
  std::vector<int64_t> pcnt(static_cast<size_t>(vocab) + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) pcnt[static_cast<size_t>(tok[e]) + 1]++;
  for (size_t t = 1; t < pcnt.size(); ++t) pcnt[t] += pcnt[t - 1];
  std::vector<int32_t> pdocs(static_cast<size_t>(nnz));
  {
    std::vector<int64_t> cursor(pcnt.begin(), pcnt.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t e = row_off[i]; e < row_off[i + 1]; ++e)
        pdocs[static_cast<size_t>(cursor[tok[e]]++)] = static_cast<int32_t>(i);
  }
  // When doc i is processed, each token's posting prefix [pcnt[t], seen[t])
  // holds exactly the docs < i that contain t.
  std::vector<int64_t> seen(pcnt.begin(), pcnt.end() - 1);
  std::vector<int32_t> acc(static_cast<size_t>(n), 0);
  std::vector<int32_t> touched;
  touched.reserve(1024);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len_i = row_off[i + 1] - row_off[i];
    for (int64_t e = row_off[i]; e < row_off[i + 1]; ++e) {
      const int32_t t = tok[e];
      for (int64_t p = pcnt[static_cast<size_t>(t)]; p < seen[static_cast<size_t>(t)]; ++p) {
        const int32_t j = pdocs[static_cast<size_t>(p)];
        if (acc[static_cast<size_t>(j)]++ == 0) touched.push_back(j);
      }
      seen[static_cast<size_t>(t)]++;
    }
    for (const int32_t j : touched) {
      const int64_t len_j = row_off[j + 1] - row_off[j];
      emit(i, static_cast<int64_t>(j), jac_f32(acc[static_cast<size_t>(j)], len_i, len_j));
      acc[static_cast<size_t>(j)] = 0;
    }
    touched.clear();
  }
}

}  // namespace

extern "C" {

// Symmetric COO edge list of the thresholded graph (both directions, no
// diagonal) from CSR token-id rows, as ufnd_jaccard_adj's arguments.
//   mode : 0 -> binary weights (1.0); 1 -> the Jaccard value as weight
//   cap  : capacity of out_i / out_j / out_w (entries)
// Returns the number of entries the full result needs; entries past `cap`
// are counted but not written, so the caller counts (cap 0), allocates and
// fills. Write order is deterministic (ascending i, then posting-list touch
// order for j) but not sorted; the caller sorts.
int64_t ufnd_jaccard_edges(const int64_t* row_off, const int32_t* tok, int64_t n,
                           int64_t vocab, float thresh, int mode, int64_t cap,
                           int32_t* out_i, int32_t* out_j, float* out_w) {
  int64_t count = 0;
  if (n <= 0) return 0;
  for_each_intersecting_pair(row_off, tok, n, vocab, [&](int64_t i, int64_t j, float jac) {
    if (jac < thresh) return;
    const float w = mode == 1 ? jac : 1.0f;
    if (w == 0.0f) return;
    if (count + 2 <= cap) {
      out_i[count] = static_cast<int32_t>(i);
      out_j[count] = static_cast<int32_t>(j);
      out_w[count] = w;
      out_i[count + 1] = static_cast<int32_t>(j);
      out_j[count + 1] = static_cast<int32_t>(i);
      out_w[count + 1] = w;
    }
    count += 2;
  });
  return count;
}

// Dense (n, n) float32 Jaccard adjacency from CSR token-id rows.
//   row_off : int64[n+1] CSR offsets into tok
//   tok     : int32[nnz] token ids in [0, vocab), unique within a row
//   mode    : 0 -> binary  (A[i,j] = 1 if jac >= thresh), diagonal 1
//             2 -> full pairwise jaccard (thresh ignored), true diagonal
//             |s| / (|s| + 1e-9), 0 for an empty set
//   out     : float32[n*n], caller-allocated, fully overwritten
void ufnd_jaccard_adj(const int64_t* row_off, const int32_t* tok, int64_t n,
                      int64_t vocab, float thresh, int mode, float* out) {
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(n) * static_cast<size_t>(n));
  if (n <= 0) return;
  for_each_intersecting_pair(row_off, tok, n, vocab, [&](int64_t i, int64_t j, float jac) {
    const float w = mode == 2 ? jac : (jac >= thresh ? 1.0f : 0.0f);
    if (w != 0.0f) {
      out[i * n + j] = w;
      out[j * n + i] = w;
    }
  });
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len_i = row_off[i + 1] - row_off[i];
    out[i * n + i] = mode == 2 ? jac_f32(len_i, len_i, len_i) : 1.0f;
  }
}

}  // extern "C"
