// Native (C++) setup kernels for ngsamg.
//
// The reference implements its entire setup pipeline natively
// (its src/ tree, ~67k LoC C++17); this module provides compiled
// equivalents of the host-side graph kernels that dominate this
// framework's setup phase, exposed through the raw CPython C API (no
// pybind11 in the image):
//
//   * greedy_color   — sequential greedy graph coloring (fewer colors and
//                      ~10x faster than the vectorized speculative rounds;
//                      color count = sequential depth of the GS sweep)
//   * handshake_match— one full pairwise-matching round (propose/accept
//                      loop of coarsen/pairwise.py) in one pass
//   * ell_slots      — CSR -> padded-ELL slot computation
//
// Build: compiled on first import by ngsamg/native/__init__.py
// (`c++ -O3 -std=c++17 -march=native -shared -fPIC` into
// build/native-<key>/). Python callers fall back to the numpy
// implementations when it cannot be built.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

// Index-dtype dispatch: scipy CSR carries int32 indptr/indices below 2^31
// nnz; converting to int64 in the Python wrappers costs a full O(nnz)
// pass per call (measured ~5 s per 1M-DoF setup). Kernels that take CSR
// arrays are templated on the index type and dispatched here.
template <typename F>
PyObject *dispatch_index(PyArrayObject *idx_like, F &&f) {
  switch (PyArray_TYPE(idx_like)) {
    case NPY_INT32:
      return f(int32_t{});
    case NPY_INT64:
      return f(int64_t{});
    default:
      PyErr_SetString(PyExc_TypeError,
                      "index arrays must be int32 or int64");
      return nullptr;
  }
}

// Edge-list access: kernels accept EITHER two 1-D int64 arrays (ei, ej)
// or ONE C-contiguous (m, 2) int64 array passed as ei with ej == None —
// the mesh stores edges as (m, 2), and slicing columns into contiguous
// copies cost ~40 ms per call at 14M edges (measured 9.8 s per setup).
struct EdgeView {
  const int64_t *i;
  const int64_t *j;
  int64_t s;  // element stride (1 split, 2 interleaved)
  int64_t ne;
};
static EdgeView edge_view(PyArrayObject *ei_o, PyObject *ej_o) {
  EdgeView ev;
  ev.ne = PyArray_DIM(ei_o, 0);
  ev.i = static_cast<const int64_t *>(PyArray_DATA(ei_o));
  if (PyArray_NDIM(ei_o) == 2) {
    ev.j = ev.i + 1;
    ev.s = 2;
  } else {
    ev.j = static_cast<const int64_t *>(
        PyArray_DATA((PyArrayObject *)ej_o));
    ev.s = 1;
  }
  return ev;
}


// ---------------------------------------------------------------------
// greedy_color(indptr int64[n+1], indices int64[nnz]) -> int32[n]
// ---------------------------------------------------------------------
template <typename I>
PyObject *greedy_color_impl(const I *indptr, const I *indices, int64_t n) {
  npy_intp dims[1] = {n};
  PyArrayObject *out =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT32);
  auto *colors = static_cast<int32_t *>(PyArray_DATA(out));
  std::fill(colors, colors + n, -1);

  std::vector<int32_t> mark(256, -1);
  int maxc = 0;
  for (int64_t v = 0; v < n; ++v) {
    for (I k = indptr[v]; k < indptr[v + 1]; ++k) {
      const int64_t nb = (int64_t)indices[k];
      const int32_t c = colors[nb];
      if (c >= 0) mark[c] = (int32_t)v;
    }
    int32_t c = 0;
    while (c < (int32_t)mark.size() && mark[c] == (int32_t)v) ++c;
    colors[v] = c;
    if (c > maxc) maxc = c;
  }
  (void)maxc;
  return (PyObject *)out;
}

PyObject *greedy_color(PyObject *, PyObject *args) {
  PyArrayObject *indptr_o, *indices_o;
  if (!PyArg_ParseTuple(args, "O!O!", &PyArray_Type, &indptr_o,
                        &PyArray_Type, &indices_o))
    return nullptr;
  const int64_t n = PyArray_DIM(indptr_o, 0) - 1;
  return dispatch_index(indptr_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return greedy_color_impl<I>(
        static_cast<const I *>(PyArray_DATA(indptr_o)),
        static_cast<const I *>(PyArray_DATA(indices_o)), n);
  });
}

// ---------------------------------------------------------------------
// handshake_match(indptr, indices, weights f64, can_match uint8,
//                 theta f64, iters int[, jitter int])
//   -> partner int64[n]  (-1 unmatched)
// Vertices with can_match == 0 never propose and are never proposed to.
// With jitter != 0 the symmetric tie-break hash of coarsen/pairwise.py
// (w *= 1 + 1e-9 * hash(lo, hi)/2^32) is applied in-kernel, saving the
// five O(nnz) numpy passes the python wrapper otherwise spends on it.
// ---------------------------------------------------------------------
template <typename I>
PyObject *handshake_match_impl(const I *indptr, const I *indices,
                               const double *w_raw, const uint8_t *cm,
                               double theta, int iters, int jitter,
                               int64_t n) {
  npy_intp dims[1] = {n};
  PyArrayObject *out =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT64);
  auto *partner = static_cast<int64_t *>(PyArray_DATA(out));
  std::fill(partner, partner + n, (int64_t)-1);

  const int64_t nnz = (int64_t)indptr[n];
  std::vector<double> w_jit;
  const double *w = w_raw;
  if (jitter) {
    w_jit.resize((size_t)nnz);
    for (int64_t v = 0; v < n; ++v)
      for (int64_t k = indptr[v]; k < indptr[v + 1]; ++k) {
        const int64_t nb = (int64_t)indices[k];
        const int64_t lo = v < nb ? v : nb;
        const int64_t hi = v < nb ? nb : v;
        const int64_t h =
            (lo * (int64_t)2654435761LL + hi * (int64_t)40503LL) &
            (int64_t)0xFFFFFFFFLL;
        w_jit[(size_t)k] =
            w_raw[k] * (1.0 + 1e-9 * ((double)h / 4294967296.0));
      }
    w = w_jit.data();
  }

  // row maxima for the strength threshold
  std::vector<double> rowmax(n, 0.0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t k = indptr[v]; k < indptr[v + 1]; ++k)
      rowmax[v] = std::max(rowmax[v], w[k]);

  std::vector<int64_t> best(n);
  for (int it = 0; it < iters; ++it) {
    bool any = false;
    // propose: strongest available neighbor above threshold
    for (int64_t v = 0; v < n; ++v) {
      best[v] = -1;
      if (partner[v] >= 0 || !cm[v]) continue;
      double bw = -1.0;
      for (int64_t k = indptr[v]; k < indptr[v + 1]; ++k) {
        const int64_t nb = (int64_t)indices[k];
        if (partner[nb] >= 0 || !cm[nb]) continue;
        const double thr =
            theta * std::min(rowmax[v], rowmax[nb]);
        if (w[k] < thr || w[k] <= 0.0) continue;
        if (w[k] > bw) { bw = w[k]; best[v] = nb; }
      }
    }
    // accept mutual proposals
    for (int64_t v = 0; v < n; ++v) {
      const int64_t b = best[v];
      if (b > v && best[b] == v) {
        partner[v] = b;
        partner[b] = v;
        any = true;
      }
    }
    if (!any) break;
  }
  return (PyObject *)out;
}

PyObject *handshake_match(PyObject *, PyObject *args) {
  PyArrayObject *indptr_o, *indices_o, *w_o, *cm_o;
  double theta;
  int iters;
  int jitter = 0;
  if (!PyArg_ParseTuple(args, "O!O!O!O!di|i", &PyArray_Type, &indptr_o,
                        &PyArray_Type, &indices_o, &PyArray_Type, &w_o,
                        &PyArray_Type, &cm_o, &theta, &iters, &jitter))
    return nullptr;
  auto *w_raw = static_cast<const double *>(PyArray_DATA(w_o));
  auto *cm = static_cast<const uint8_t *>(PyArray_DATA(cm_o));
  const int64_t n = PyArray_DIM(indptr_o, 0) - 1;
  return dispatch_index(indptr_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return handshake_match_impl<I>(
        static_cast<const I *>(PyArray_DATA(indptr_o)),
        static_cast<const I *>(PyArray_DATA(indices_o)), w_raw, cm, theta,
        iters, jitter, n);
  });
}

// ---------------------------------------------------------------------
// ell_slots(indptr int64[n+1]) -> (rows int64[nnz], slot int64[nnz], K)
// ---------------------------------------------------------------------
PyObject *ell_slots(PyObject *, PyObject *args) {
  PyArrayObject *indptr_o;
  if (!PyArg_ParseTuple(args, "O!", &PyArray_Type, &indptr_o))
    return nullptr;
  auto *indptr = static_cast<const int64_t *>(PyArray_DATA(indptr_o));
  const npy_intp n = PyArray_DIM(indptr_o, 0) - 1;
  const int64_t nnz = indptr[n];

  npy_intp dims[1] = {nnz};
  PyArrayObject *rows_o =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT64);
  PyArrayObject *slot_o =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT64);
  auto *rows = static_cast<int64_t *>(PyArray_DATA(rows_o));
  auto *slot = static_cast<int64_t *>(PyArray_DATA(slot_o));
  int64_t K = 0;
  for (int64_t v = 0; v < n; ++v) {
    const int64_t deg = indptr[v + 1] - indptr[v];
    if (deg > K) K = deg;
    for (int64_t k = indptr[v]; k < indptr[v + 1]; ++k) {
      rows[k] = v;
      slot[k] = k - indptr[v];
    }
  }
  PyObject *ret = Py_BuildValue("(NNl)", rows_o, slot_o, (long)K);
  return ret;
}

// ---------------------------------------------------------------------
// rap_csr(A_indptr, A_indices, A_data, P_indptr, P_indices, P_data, nc
//         [, emit_f32, symmetrize])
//   -> (C_indptr int64, C_indices int32, C_data f64|f32)
//   with C = P^T A P (scalar CSR, sorted columns)
//
// Fused two-pass Gustavson with a dense sparse-accumulator (SPA) per row
// — the native Galerkin triple product of the reference
// (utils_sparseMM.hpp:94-108 RestrictMatrix), serving the generic
// (unstructured / block-energy) setup path; structured levels use the
// stencil-domain RAP instead (transfer/stencil.py). A/P index arrays may
// be int32 (scipy native) or int64. With symmetrize != 0 the result is
// replaced by (C + C^T)/2 in place (A symmetric => C symmetric up to
// roundoff; averaging restores it exactly without scipy's 3-pass add).
// emit_f32 != 0 casts values on output (saves the caller's astype pass).
// ---------------------------------------------------------------------
template <typename I>
PyObject *rap_csr_impl(const I *ai, const I *aj, const double *av,
                       const I *pi, const I *pj, const double *pv,
                       int64_t n, int64_t nc, int emit_f32,
                       int symmetrize) {
  // ---- pass 1: AP = A @ P (CSR, SPA over coarse columns) --------------
  std::vector<int64_t> ap_ptr(n + 1, 0);
  std::vector<int32_t> ap_col;
  std::vector<double> ap_val;
  ap_col.reserve((size_t)(2 * ai[n]));  // heuristic (fan-out ~2-4)
  ap_val.reserve((size_t)(2 * ai[n]));
  {
    std::vector<double> acc(nc, 0.0);
    std::vector<int64_t> stamp(nc, -1);
    std::vector<int32_t> touched;
    for (int64_t i = 0; i < n; ++i) {
      touched.clear();
      for (I k = ai[i]; k < ai[i + 1]; ++k) {
        const I j = aj[k];
        const double a = av[k];
        if (a == 0.0) continue;
        for (I l = pi[j]; l < pi[j + 1]; ++l) {
          const int32_t c = (int32_t)pj[l];
          if (stamp[c] != i) {
            stamp[c] = i;
            acc[c] = 0.0;
            touched.push_back(c);
          }
          acc[c] += a * pv[l];
        }
      }
      std::sort(touched.begin(), touched.end());
      for (int32_t c : touched) {
        if (acc[c] == 0.0) continue;  // scipy matmul zero-pruning parity
        ap_col.push_back(c);
        ap_val.push_back(acc[c]);
      }
      ap_ptr[i + 1] = (int64_t)ap_col.size();
    }
  }

  // ---- transpose P (counting sort) -------------------------------------
  const int64_t pnnz = pi[n];
  std::vector<int64_t> pt_ptr(nc + 1, 0);
  std::vector<int32_t> pt_row(pnnz);
  std::vector<double> pt_val(pnnz);
  for (int64_t k = 0; k < pnnz; ++k) pt_ptr[pj[k] + 1]++;
  for (int64_t c = 0; c < nc; ++c) pt_ptr[c + 1] += pt_ptr[c];
  {
    std::vector<int64_t> cur(pt_ptr.begin(), pt_ptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (I k = pi[i]; k < pi[i + 1]; ++k) {
        const int64_t dst = cur[pj[k]]++;
        pt_row[dst] = (int32_t)i;
        pt_val[dst] = pv[k];
      }
  }

  // ---- pass 2: C = P^T @ AP --------------------------------------------
  std::vector<int64_t> c_ptr(nc + 1, 0);
  std::vector<int32_t> c_col;
  std::vector<double> c_val;
  c_col.reserve((size_t)pnnz);
  c_val.reserve((size_t)pnnz);
  {
    std::vector<double> acc(nc, 0.0);
    std::vector<int64_t> stamp(nc, -1);
    std::vector<int32_t> touched;
    for (int64_t r = 0; r < nc; ++r) {
      touched.clear();
      for (int64_t k = pt_ptr[r]; k < pt_ptr[r + 1]; ++k) {
        const int32_t i = pt_row[k];
        const double p = pt_val[k];
        if (p == 0.0) continue;
        for (int64_t l = ap_ptr[i]; l < ap_ptr[i + 1]; ++l) {
          const int32_t c = ap_col[l];
          if (stamp[c] != r) {
            stamp[c] = r;
            acc[c] = 0.0;
            touched.push_back(c);
          }
          acc[c] += p * ap_val[l];
        }
      }
      std::sort(touched.begin(), touched.end());
      for (int32_t c : touched) {
        if (acc[c] == 0.0) continue;  // scipy matmul zero-pruning parity
        c_col.push_back(c);
        c_val.push_back(acc[c]);
      }
      c_ptr[r + 1] = (int64_t)c_col.size();
    }
  }

  if (symmetrize) {
    // (C + C^T)/2 in place: for each upper entry find the mirror by
    // binary search (columns are sorted) and average both. Structure is
    // symmetric by construction (A, and hence C, structurally symmetric).
    for (int64_t r = 0; r < nc; ++r)
      for (int64_t k = c_ptr[r]; k < c_ptr[r + 1]; ++k) {
        const int32_t c = c_col[k];
        if (c <= r) continue;
        const int32_t *lo = c_col.data() + c_ptr[c];
        const int32_t *hi = c_col.data() + c_ptr[c + 1];
        const int32_t *it = std::lower_bound(lo, hi, (int32_t)r);
        if (it != hi && *it == (int32_t)r) {
          const int64_t km = it - c_col.data();
          const double avg = 0.5 * (c_val[k] + c_val[km]);
          c_val[k] = avg;
          c_val[km] = avg;
        }
      }
  }

  npy_intp d_ptr[1] = {nc + 1};
  npy_intp d_nnz[1] = {(npy_intp)c_col.size()};
  PyArrayObject *out_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  PyArrayObject *out_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_INT32);
  PyArrayObject *out_val = (PyArrayObject *)PyArray_SimpleNew(
      1, d_nnz, emit_f32 ? NPY_FLOAT32 : NPY_FLOAT64);
  std::copy(c_ptr.begin(), c_ptr.end(),
            static_cast<int64_t *>(PyArray_DATA(out_ptr)));
  std::copy(c_col.begin(), c_col.end(),
            static_cast<int32_t *>(PyArray_DATA(out_col)));
  if (emit_f32) {
    auto *dst = static_cast<float *>(PyArray_DATA(out_val));
    for (size_t k = 0; k < c_val.size(); ++k) dst[k] = (float)c_val[k];
  } else {
    std::copy(c_val.begin(), c_val.end(),
              static_cast<double *>(PyArray_DATA(out_val)));
  }
  return Py_BuildValue("(NNN)", out_ptr, out_col, out_val);
}

PyObject *rap_csr(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o, *pi_o, *pj_o, *pv_o;
  long nc_l;
  int emit_f32 = 0, symmetrize = 0;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!l|ii", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &PyArray_Type, &pi_o, &PyArray_Type, &pj_o,
                        &PyArray_Type, &pv_o, &nc_l, &emit_f32,
                        &symmetrize))
    return nullptr;
  if (PyArray_TYPE(ai_o) != PyArray_TYPE(pi_o)) {
    PyErr_SetString(PyExc_TypeError, "A and P index dtypes must match");
    return nullptr;
  }
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  auto *av = static_cast<const double *>(PyArray_DATA(av_o));
  auto *pv = static_cast<const double *>(PyArray_DATA(pv_o));
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return rap_csr_impl<I>(static_cast<const I *>(PyArray_DATA(ai_o)),
                           static_cast<const I *>(PyArray_DATA(aj_o)), av,
                           static_cast<const I *>(PyArray_DATA(pi_o)),
                           static_cast<const I *>(PyArray_DATA(pj_o)), pv,
                           n, (int64_t)nc_l, emit_f32, symmetrize);
  });
}

// ---------------------------------------------------------------------
// finest_mesh_scal(indptr, indices, data f64)
//   -> (diag f64[n], rowsum f64[n], ei int64[m], ej int64[m], ew f64[m])
// One fused pass over a symmetric scalar CSR producing everything the
// finest-level algebraic mesh needs (apps/h1.build_finest_mesh;
// reference BuildAlgMesh_ALG_scal, h1_impl.hpp:384-431): the diagonal,
// the signed row sums (L2 weights before clamping), and the strict
// upper-triangle edge list (exact zeros dropped — scipy
// setdiag(0)+eliminate_zeros+triu parity). Replaces a CSR copy,
// setdiag, eliminate_zeros, triu and a COO conversion (~5 O(nnz)
// allocating passes). ``mode``: 0 = all edges, |a_ij| weights;
// 1 = attractive (a_ij < 0) edges only, weight -a_ij; 2 = all edges,
// SIGNED weight -a_ij (attractive positive — lets coarse-level Galerkin
// weight sums cancel repulsive against attractive couplings).
// ---------------------------------------------------------------------
template <typename I>
PyObject *finest_mesh_scal_impl(const I *ai, const I *aj, const double *av,
                                int64_t n, int mode) {
  npy_intp d_n[1] = {n};
  PyArrayObject *o_diag =
      (PyArrayObject *)PyArray_SimpleNew(1, d_n, NPY_FLOAT64);
  PyArrayObject *o_rsum =
      (PyArrayObject *)PyArray_SimpleNew(1, d_n, NPY_FLOAT64);
  auto *diag = static_cast<double *>(PyArray_DATA(o_diag));
  auto *rsum = static_cast<double *>(PyArray_DATA(o_rsum));

  // pass 1: diag/rowsum + upper-edge count
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    double d = 0.0, s = 0.0;
    for (I k = ai[i]; k < ai[i + 1]; ++k) {
      const I j = aj[k];
      const double a = av[k];
      s += a;
      if (j == i) d = a;
      else if (j > i && (mode == 1 ? (a < 0.0) : (a != 0.0))) ++m;
    }
    diag[i] = d;
    rsum[i] = s;
  }
  npy_intp d_m2[2] = {m, 2};
  npy_intp d_m[1] = {m};
  PyArrayObject *o_edges =
      (PyArrayObject *)PyArray_SimpleNew(2, d_m2, NPY_INT64);
  PyArrayObject *o_ew =
      (PyArrayObject *)PyArray_SimpleNew(1, d_m, NPY_FLOAT64);
  auto *edg = static_cast<int64_t *>(PyArray_DATA(o_edges));
  auto *ew = static_cast<double *>(PyArray_DATA(o_ew));
  int64_t e = 0;
  for (int64_t i = 0; i < n; ++i)
    for (I k = ai[i]; k < ai[i + 1]; ++k) {
      const I j = aj[k];
      const double a = av[k];
      if (j > i && (mode == 1 ? (a < 0.0) : (a != 0.0))) {
        edg[2 * e] = i;
        edg[2 * e + 1] = (int64_t)j;
        ew[e] = (mode == 0) ? std::abs(a) : -a;
        ++e;
      }
    }
  return Py_BuildValue("(NNNN)", o_diag, o_rsum, o_edges, o_ew);
}

PyObject *finest_mesh_scal(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o;
  int neg_only = 0;
  if (!PyArg_ParseTuple(args, "O!O!O!|i", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &neg_only))
    return nullptr;
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  auto *av = static_cast<const double *>(PyArray_DATA(av_o));
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return finest_mesh_scal_impl<I>(
        static_cast<const I *>(PyArray_DATA(ai_o)),
        static_cast<const I *>(PyArray_DATA(aj_o)), av, n, neg_only);
  });
}

// ---------------------------------------------------------------------
// csr_permute(indptr, indices, data f32|f64, rowperm int64[nr] | None,
//             colmap int64[ncol] | None)
//   -> (indptr int64[nr+1], indices int32, data same-dtype)
// Permuted CSR out = A[rowperm][:, inv(colmap)]: row r of the output is
// old row rowperm[r]; every column j is renamed colmap[j]; rows come out
// column-sorted. One pass + per-row sorts — replaces scipy's
// A[perm][:, perm] double fancy-index (two allocating passes + a csc
// round trip, ~10 s at the 1M-DoF scale under load).
// ---------------------------------------------------------------------
template <typename I, typename V>
PyObject *csr_permute_impl(const I *ai, const I *aj, const V *av,
                           const int64_t *rperm, const int64_t *cmap,
                           int64_t n, int vdtype) {
  npy_intp d_ptr[1] = {n + 1};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  auto *optr = static_cast<int64_t *>(PyArray_DATA(o_ptr));
  optr[0] = 0;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t src = rperm ? rperm[r] : r;
    optr[r + 1] = optr[r] + (int64_t)(ai[src + 1] - ai[src]);
  }
  const int64_t nnz = optr[n];
  npy_intp d_nnz[1] = {nnz};
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_INT32);
  PyArrayObject *o_val =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, vdtype);
  auto *ocol = static_cast<int32_t *>(PyArray_DATA(o_col));
  auto *oval = static_cast<V *>(PyArray_DATA(o_val));
  std::vector<std::pair<int32_t, V>> buf;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t src = rperm ? rperm[r] : r;
    const int64_t lo = optr[r];
    int64_t d = lo;
    bool sorted = true;
    int32_t prev = -1;
    for (I k = ai[src]; k < ai[src + 1]; ++k, ++d) {
      const int32_t c =
          (int32_t)(cmap ? cmap[(int64_t)aj[k]] : (int64_t)aj[k]);
      ocol[d] = c;
      oval[d] = av[k];
      if (c < prev) sorted = false;
      prev = c;
    }
    if (!sorted) {
      const int64_t hi = optr[r + 1];
      buf.clear();
      for (int64_t k = lo; k < hi; ++k) buf.emplace_back(ocol[k], oval[k]);
      std::sort(buf.begin(), buf.end(),
                [](const auto &a, const auto &b) { return a.first < b.first; });
      for (int64_t k = lo; k < hi; ++k) {
        ocol[k] = buf[(size_t)(k - lo)].first;
        oval[k] = buf[(size_t)(k - lo)].second;
      }
    }
  }
  return Py_BuildValue("(NNN)", o_ptr, o_col, o_val);
}

PyObject *csr_permute(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o;
  PyObject *rperm_o, *cmap_o;
  if (!PyArg_ParseTuple(args, "O!O!O!OO", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &rperm_o, &cmap_o))
    return nullptr;
  int64_t n = PyArray_DIM(ai_o, 0) - 1;
  const int64_t *rperm = nullptr;
  if (rperm_o != Py_None) {
    rperm = static_cast<const int64_t *>(
        PyArray_DATA((PyArrayObject *)rperm_o));
    n = PyArray_DIM((PyArrayObject *)rperm_o, 0);  // output row count
  }
  const int64_t *cmap =
      cmap_o == Py_None ? nullptr
                        : static_cast<const int64_t *>(
                              PyArray_DATA((PyArrayObject *)cmap_o));
  const int vt = PyArray_TYPE(av_o);
  if (vt != NPY_FLOAT32 && vt != NPY_FLOAT64) {
    PyErr_SetString(PyExc_TypeError, "data must be float32 or float64");
    return nullptr;
  }
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    const I *ai = static_cast<const I *>(PyArray_DATA(ai_o));
    const I *aj = static_cast<const I *>(PyArray_DATA(aj_o));
    if (vt == NPY_FLOAT32)
      return csr_permute_impl<I, float>(
          ai, aj, static_cast<const float *>(PyArray_DATA(av_o)), rperm,
          cmap, n, NPY_FLOAT32);
    return csr_permute_impl<I, double>(
        ai, aj, static_cast<const double *>(PyArray_DATA(av_o)), rperm,
        cmap, n, NPY_FLOAT64);
  });
}

// ---------------------------------------------------------------------
// collapse_graph(indptr, indices, data f64, v2agg int64[n], nc)
//   -> (C_indptr int64[nc+1], C_indices int64, C_data f64)
// Galerkin-collapse of a scalar graph onto aggregates with the diagonal
// (intra-aggregate mass) dropped — the native form of
// coarsen/pairwise.coarse_strength_graph (C^T S C; setdiag(0);
// eliminate_zeros). Entries per coarse row come out in ascending column
// order; exact zeros are dropped like scipy's eliminate_zeros.
// ---------------------------------------------------------------------
template <typename I>
PyObject *collapse_graph_impl(const I *ai, const I *aj, const double *av,
                              const int64_t *agg, int64_t n, int64_t nc) {
  // bucket fine rows by coarse row (counting sort over v2agg)
  std::vector<int64_t> cptr(nc + 1, 0);
  for (int64_t v = 0; v < n; ++v)
    if (agg[v] >= 0) cptr[agg[v] + 1]++;
  for (int64_t c = 0; c < nc; ++c) cptr[c + 1] += cptr[c];
  std::vector<int64_t> members(cptr[nc]);
  {
    std::vector<int64_t> cur(cptr.begin(), cptr.end() - 1);
    for (int64_t v = 0; v < n; ++v)
      if (agg[v] >= 0) members[(size_t)cur[agg[v]]++] = v;
  }

  std::vector<int64_t> out_ptr(nc + 1, 0);
  std::vector<int32_t> out_col;
  std::vector<double> out_val;
  out_col.reserve((size_t)ai[n] / 2);
  out_val.reserve((size_t)ai[n] / 2);
  std::vector<double> acc(nc, 0.0);
  std::vector<int64_t> stamp(nc, -1);
  std::vector<int32_t> touched;
  for (int64_t c = 0; c < nc; ++c) {
    touched.clear();
    for (int64_t m = cptr[c]; m < cptr[c + 1]; ++m) {
      const int64_t v = members[(size_t)m];
      for (I k = ai[v]; k < ai[v + 1]; ++k) {
        const int64_t cj = agg[(int64_t)aj[k]];
        if (cj < 0 || cj == c) continue;  // dropped / diagonal
        if (stamp[cj] != c) {
          stamp[cj] = c;
          acc[cj] = 0.0;
          touched.push_back((int32_t)cj);
        }
        acc[cj] += av[k];
      }
    }
    std::sort(touched.begin(), touched.end());
    for (int32_t cj : touched) {
      if (acc[cj] == 0.0) continue;  // eliminate_zeros parity
      out_col.push_back(cj);
      out_val.push_back(acc[cj]);
    }
    out_ptr[c + 1] = (int64_t)out_col.size();
  }

  npy_intp d_ptr[1] = {nc + 1};
  npy_intp d_nnz[1] = {(npy_intp)out_col.size()};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_INT32);
  PyArrayObject *o_val =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_FLOAT64);
  std::copy(out_ptr.begin(), out_ptr.end(),
            static_cast<int64_t *>(PyArray_DATA(o_ptr)));
  std::copy(out_col.begin(), out_col.end(),
            static_cast<int32_t *>(PyArray_DATA(o_col)));
  std::copy(out_val.begin(), out_val.end(),
            static_cast<double *>(PyArray_DATA(o_val)));
  return Py_BuildValue("(NNN)", o_ptr, o_col, o_val);
}

// ---------------------------------------------------------------------
// collapse_signed(indptr, indices, data f64, v2agg int64[n], nc)
//   -> (C_indptr int64[nc+1], C_indices int32, C_data f64, diag f64[nc])
// Full signed Galerkin collapse A_c[I,J] = sum_{i in I, j in J} A_ij of a
// scalar operator (diagonal entries included): off-diagonal cluster sums
// in CSR form (ascending columns, exact zeros kept — a cancelling sum is
// a real "no coupling" statement) plus the cluster diagonal
// diag[I] = sum_{i,j in I} A_ij. This is the per-round coarse-energy
// re-evaluation of the reference's SPW (LocCoarseMap, spw_agg_impl.hpp)
// in scalar form: matching rounds after the first see the TRUE coarse
// couplings, where the unsigned strength collapse would hide
// sign-cancellation (near-singular sliver patches).
// ---------------------------------------------------------------------
template <typename I>
PyObject *collapse_signed_impl(const I *ai, const I *aj, const double *av,
                               const int64_t *agg, int64_t n, int64_t nc) {
  std::vector<int64_t> cptr(nc + 1, 0);
  for (int64_t v = 0; v < n; ++v)
    if (agg[v] >= 0) cptr[agg[v] + 1]++;
  for (int64_t c = 0; c < nc; ++c) cptr[c + 1] += cptr[c];
  std::vector<int64_t> members(cptr[nc]);
  {
    std::vector<int64_t> cur(cptr.begin(), cptr.end() - 1);
    for (int64_t v = 0; v < n; ++v)
      if (agg[v] >= 0) members[(size_t)cur[agg[v]]++] = v;
  }

  npy_intp d_nc[1] = {nc};
  PyArrayObject *o_diag =
      (PyArrayObject *)PyArray_ZEROS(1, d_nc, NPY_FLOAT64, 0);
  auto *diag = static_cast<double *>(PyArray_DATA(o_diag));

  std::vector<int64_t> out_ptr(nc + 1, 0);
  std::vector<int32_t> out_col;
  std::vector<double> out_val;
  out_col.reserve((size_t)ai[n] / 2);
  out_val.reserve((size_t)ai[n] / 2);
  std::vector<double> acc(nc, 0.0);
  std::vector<int64_t> stamp(nc, -1);
  std::vector<int32_t> touched;
  for (int64_t c = 0; c < nc; ++c) {
    touched.clear();
    double dsum = 0.0;
    for (int64_t m = cptr[c]; m < cptr[c + 1]; ++m) {
      const int64_t v = members[(size_t)m];
      for (I k = ai[v]; k < ai[v + 1]; ++k) {
        const int64_t cj = agg[(int64_t)aj[k]];
        if (cj < 0) continue;
        if (cj == c) {
          dsum += av[k];
          continue;
        }
        if (stamp[cj] != c) {
          stamp[cj] = c;
          acc[cj] = 0.0;
          touched.push_back((int32_t)cj);
        }
        acc[cj] += av[k];
      }
    }
    diag[c] = dsum;
    std::sort(touched.begin(), touched.end());
    for (int32_t cj : touched) {
      out_col.push_back(cj);
      out_val.push_back(acc[cj]);
    }
    out_ptr[c + 1] = (int64_t)out_col.size();
  }

  npy_intp d_ptr[1] = {nc + 1};
  npy_intp d_nnz[1] = {(npy_intp)out_col.size()};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_INT32);
  PyArrayObject *o_val =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_FLOAT64);
  std::copy(out_ptr.begin(), out_ptr.end(),
            static_cast<int64_t *>(PyArray_DATA(o_ptr)));
  std::copy(out_col.begin(), out_col.end(),
            static_cast<int32_t *>(PyArray_DATA(o_col)));
  std::copy(out_val.begin(), out_val.end(),
            static_cast<double *>(PyArray_DATA(o_val)));
  return Py_BuildValue("(NNNN)", o_ptr, o_col, o_val, o_diag);
}

PyObject *collapse_signed(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o, *agg_o;
  long nc_l;
  if (!PyArg_ParseTuple(args, "O!O!O!O!l", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &PyArray_Type, &agg_o, &nc_l))
    return nullptr;
  auto *av = static_cast<const double *>(PyArray_DATA(av_o));
  auto *agg = static_cast<const int64_t *>(PyArray_DATA(agg_o));
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return collapse_signed_impl<I>(
        static_cast<const I *>(PyArray_DATA(ai_o)),
        static_cast<const I *>(PyArray_DATA(aj_o)), av, agg, n,
        (int64_t)nc_l);
  });
}

PyObject *collapse_graph(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o, *agg_o;
  long nc_l;
  if (!PyArg_ParseTuple(args, "O!O!O!O!l", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &PyArray_Type, &agg_o, &nc_l))
    return nullptr;
  auto *av = static_cast<const double *>(PyArray_DATA(av_o));
  auto *agg = static_cast<const int64_t *>(PyArray_DATA(agg_o));
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return collapse_graph_impl<I>(
        static_cast<const I *>(PyArray_DATA(ai_o)),
        static_cast<const I *>(PyArray_DATA(aj_o)), av, agg, n,
        (int64_t)nc_l);
  });
}

// ---------------------------------------------------------------------
// smoothed_prol_scalar(
//   A_indptr, A_indices, A_data,            // level CSR (diag included)
//   edge_i, edge_j int64[ne], edge_w f64,   // algebraic-mesh edges
//   l2wt f64[n],                            // vertex L2 weights
//   v2agg int64[n], nc,
//   scale_aux, scale_real f64,              // omega / rho, precomputed
//   max_per_row, max_classic long, min_frac f64)
//   -> (P_indptr int64[n+1], P_indices int32, P_data f64)
//
// The fused semi-aux smoothed prolongation for scalar (dpv == 1) H1
// energies — one O(nnz) pass replacing the scipy SpGEMM chain of
// transfer/prolongation.smoothed_prol (the reference's `SemiAuxSProlMap`,
// vertex_factory_impl.hpp:1744-1831). Per row:
//   * classic eligibility: distinct coarse images of the real-matrix row
//     (zero entries and dropped columns excluded, own aggregate counted)
//     <= max_classic  ->  smooth with the REAL row (D_A^-1),
//     else with the aux replacement-matrix row (D_hat^-1, edge weights).
//   * fan-out-bounded truncation with kernel-preserving transport: keep
//     the <= max_per_row strongest entries (|val| >= min_frac * max,
//     strongest always kept; ties broken toward the lower coarse column,
//     matching the stable argsort of transfer/prolongation.truncate_prol),
//     dropped mass added onto the strongest kept entry (Q == identity).
// Output rows have ascending column order.
// ---------------------------------------------------------------------
template <typename I, typename V>
PyObject *smoothed_prol_scalar_impl(
    const I *ai, const I *aj, const V *av, const EdgeView &ev,
    const double *ew, const double *l2,
    const int64_t *agg, int64_t n, int64_t ne, int64_t nc,
    double scale_aux, double scale_real, int64_t max_per_row,
    int64_t max_classic, double min_frac, int filter_pos) {

  // aux (replacement-matrix) adjacency from the edge list (counting
  // sort); edge weights are SIGNED, the aux matrix takes max(w, 0)
  std::vector<int64_t> hptr(n + 1, 0);
  for (int64_t e = 0; e < ne; ++e) {
    hptr[ev.i[ev.s * e] + 1]++;
    hptr[ev.j[ev.s * e] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) hptr[v + 1] += hptr[v];
  std::vector<int64_t> hcol(hptr[n]);
  std::vector<double> hval(hptr[n]);
  std::vector<double> dhat(n);
  for (int64_t v = 0; v < n; ++v) dhat[(size_t)v] = l2[v];
  {
    std::vector<int64_t> cur(hptr.begin(), hptr.end() - 1);
    for (int64_t e = 0; e < ne; ++e) {
      const int64_t a = ev.i[ev.s * e], b = ev.j[ev.s * e];
      const double w = ew[e] > 0.0 ? ew[e] : 0.0;
      int64_t d = cur[a]++;
      hcol[(size_t)d] = b;
      hval[(size_t)d] = w;
      d = cur[b]++;
      hcol[(size_t)d] = a;
      hval[(size_t)d] = w;
      dhat[(size_t)a] += w;
      dhat[(size_t)b] += w;
    }
  }

  // A diagonal; with filter_pos, positive off-diagonals are lumped onto
  // it (the standard SA filtered matrix A_F — rowsum-preserving, so the
  // smoothed basis still reproduces constants exactly)
  std::vector<double> da(n, 0.0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t k = ai[v]; k < ai[v + 1]; ++k) {
      if (aj[k] == v) da[(size_t)v] += av[k];
      else if (filter_pos && av[k] > 0.0) da[(size_t)v] += av[k];
    }

  std::vector<int64_t> p_ptr(n + 1, 0);
  std::vector<int32_t> p_col;
  std::vector<double> p_val;
  p_col.reserve((size_t)(n * max_per_row));
  p_val.reserve((size_t)(n * max_per_row));

  std::vector<double> acc(nc, 0.0);
  std::vector<int64_t> stamp(nc, -1);
  std::vector<int64_t> touched;
  std::vector<int64_t> order;
  for (int64_t v = 0; v < n; ++v) {
    // -- classic eligibility: distinct coarse images of the real row ----
    // stamp value spaces (disjoint, never the initial -1):
    //   count pass: 3n + v;  accumulate pass: n + v;  dropped: ~(n + v)
    int64_t ndist = 0;
    bool classic = false;
    if (agg[v] >= 0 && max_classic > 1) {
      const int64_t sc = 3 * n + v;
      stamp[agg[v]] = sc;
      ndist = 1;
      for (int64_t k = ai[v]; k < ai[v + 1]; ++k) {
        const int64_t j = aj[k];
        if (j == v || av[k] == 0.0) continue;
        const int64_t c = agg[j];
        if (c < 0 || stamp[c] == sc) continue;
        stamp[c] = sc;
        ++ndist;
      }
      classic = ndist <= max_classic;
    }
    // -- accumulate the smoothed row ------------------------------------
    touched.clear();
    if (classic) {
      const double dinv =
          da[(size_t)v] > 0.0 ? 1.0 / da[(size_t)v] : 0.0;
      for (int64_t k = ai[v]; k < ai[v + 1]; ++k) {
        const int64_t j = aj[k];
        const int64_t c = agg[j];
        if (c < 0) continue;
        if (filter_pos && j != v && av[k] > 0.0) continue;  // lumped
        // diagonal uses the FILTERED entry da[v] (incl. lumped mass) so
        // the smoothed row still sums to 1 - scale*rowsum (constants)
        const double coef =
            j == v ? 1.0 - scale_real * da[(size_t)v] * dinv
                   : -scale_real * av[k] * dinv;
        if (stamp[c] != v + n) {
          stamp[c] = v + n;
          acc[c] = 0.0;
          touched.push_back(c);
        }
        acc[c] += coef;
      }
    } else {
      const double dinv =
          dhat[(size_t)v] > 0.0 ? 1.0 / dhat[(size_t)v] : 0.0;
      if (agg[v] >= 0) {
        const int64_t c = agg[v];
        stamp[c] = v + n;
        acc[c] = 1.0 - scale_aux * dhat[(size_t)v] * dinv;
        touched.push_back(c);
      }
      for (int64_t k = hptr[v]; k < hptr[v + 1]; ++k) {
        const int64_t j = hcol[(size_t)k];
        const int64_t c = agg[j];
        if (c < 0) continue;
        const double coef = scale_aux * hval[(size_t)k] * dinv;
        if (stamp[c] != v + n) {
          stamp[c] = v + n;
          acc[c] = 0.0;
          touched.push_back(c);
        }
        acc[c] += coef;
      }
    }
    // -- truncation with kernel-preserving transport --------------------
    // Ranking uses QUANTIZED relative magnitudes (40 fractional bits):
    // summation-order ulp noise must not flip near-ties, or the serial
    // and distributed setups transport dropped mass into different
    // columns (ties break toward the lower coarse column) — mirrored by
    // transfer/prolongation.truncate_prol.
    const int64_t m = (int64_t)touched.size();
    if (m > 0) {
      std::sort(touched.begin(), touched.end());  // ascending column
      double rowmax = 0.0;
      for (int64_t k = 0; k < m; ++k)
        rowmax = std::max(rowmax, std::abs(acc[touched[(size_t)k]]));
      const double qs = rowmax > 0.0 ? 1099511627776.0 / rowmax : 0.0;
      order.resize((size_t)m);
      for (int64_t k = 0; k < m; ++k) order[(size_t)k] = k;
      auto quant = [&](int64_t slot) -> int64_t {
        return (int64_t)std::floor(
            std::abs(acc[touched[(size_t)slot]]) * qs + 0.5);
      };
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) {
                         return quant(a) > quant(b);
                       });
      const int64_t qthr =
          (int64_t)std::floor(min_frac * 1099511627776.0 + 0.5);
      const int64_t s0 = touched[(size_t)order[0]];  // strongest column
      double dropped = 0.0;
      int64_t kept = 0;
      for (int64_t r = 0; r < m; ++r) {
        const int64_t c = touched[(size_t)order[r]];
        const bool keep =
            (r == 0) ||
            (r < max_per_row && quant(order[(size_t)r]) >= qthr);
        if (keep) {
          ++kept;
        } else {
          dropped += acc[c];
          acc[c] = 0.0;
          // mark as dropped: reuse stamp to exclude at emission
          stamp[c] = ~(v + n);
        }
      }
      acc[s0] += dropped;
      (void)kept;
      for (int64_t r = 0; r < m; ++r) {  // touched already ascending
        const int64_t c = touched[(size_t)r];
        if (stamp[c] != v + n) continue;  // dropped
        p_col.push_back((int32_t)c);
        p_val.push_back(acc[c]);
      }
    }
    p_ptr[v + 1] = (int64_t)p_col.size();
  }

  npy_intp d_ptr[1] = {n + 1};
  npy_intp d_nnz[1] = {(npy_intp)p_col.size()};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_INT32);
  PyArrayObject *o_val =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_FLOAT64);
  std::copy(p_ptr.begin(), p_ptr.end(),
            static_cast<int64_t *>(PyArray_DATA(o_ptr)));
  std::copy(p_col.begin(), p_col.end(),
            static_cast<int32_t *>(PyArray_DATA(o_col)));
  std::copy(p_val.begin(), p_val.end(),
            static_cast<double *>(PyArray_DATA(o_val)));
  return Py_BuildValue("(NNN)", o_ptr, o_col, o_val);
}

PyObject *smoothed_prol_scalar(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o, *ei_o, *ew_o, *l2_o, *agg_o;
  PyObject *ej_o;
  long nc_l, max_per_row_l, max_classic_l;
  double scale_aux, scale_real, min_frac;
  int filter_pos = 0;
  if (!PyArg_ParseTuple(args, "O!O!O!O!OO!O!O!lddlld|i", &PyArray_Type,
                        &ai_o, &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &PyArray_Type, &ei_o, &ej_o,
                        &PyArray_Type, &ew_o, &PyArray_Type, &l2_o,
                        &PyArray_Type, &agg_o, &nc_l, &scale_aux,
                        &scale_real, &max_per_row_l, &max_classic_l,
                        &min_frac, &filter_pos))
    return nullptr;
  const EdgeView ev = edge_view(ei_o, ej_o);
  auto *ew = static_cast<const double *>(PyArray_DATA(ew_o));
  auto *l2 = static_cast<const double *>(PyArray_DATA(l2_o));
  auto *agg = static_cast<const int64_t *>(PyArray_DATA(agg_o));
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  const int64_t ne = ev.ne;
  const int f32 = PyArray_TYPE(av_o) == NPY_FLOAT32;
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    if (f32)
      return smoothed_prol_scalar_impl<I, float>(
          static_cast<const I *>(PyArray_DATA(ai_o)),
          static_cast<const I *>(PyArray_DATA(aj_o)),
          static_cast<const float *>(PyArray_DATA(av_o)), ev, ew, l2,
          agg, n, ne, (int64_t)nc_l, scale_aux, scale_real,
          (int64_t)max_per_row_l, (int64_t)max_classic_l, min_frac,
          filter_pos);
    return smoothed_prol_scalar_impl<I, double>(
        static_cast<const I *>(PyArray_DATA(ai_o)),
        static_cast<const I *>(PyArray_DATA(aj_o)),
        static_cast<const double *>(PyArray_DATA(av_o)), ev, ew, l2,
        agg, n, ne, (int64_t)nc_l, scale_aux, scale_real,
        (int64_t)max_per_row_l, (int64_t)max_classic_l, min_frac,
        filter_pos);
  });
}

// ---------------------------------------------------------------------
// edges_to_adj(ei, ej int64[ne], w f64[ne], n)
//   -> (indptr int64[n+1], indices int32[2ne], data f64[2ne])
// Symmetric CSR adjacency from a unique (i < j) edge list, rows in
// ascending-column order — the canonical form scipy's coo->csr emits, in
// one counting-sort pass instead of four O(ne) numpy temporaries
// (mesh/topo.edge_graph).
// ---------------------------------------------------------------------
PyObject *edges_to_adj(PyObject *, PyObject *args) {
  PyArrayObject *ei_o, *w_o;
  PyObject *ej_o;
  long n_l;
  if (!PyArg_ParseTuple(args, "O!OO!l", &PyArray_Type, &ei_o,
                        &ej_o, &PyArray_Type, &w_o, &n_l))
    return nullptr;
  const EdgeView ev = edge_view(ei_o, ej_o);
  auto *w = static_cast<const double *>(PyArray_DATA(w_o));
  const int64_t ne = ev.ne;
  const int64_t n = (int64_t)n_l;

  npy_intp d_ptr[1] = {n + 1};
  npy_intp d_nnz[1] = {(npy_intp)(2 * ne)};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_INT32);
  PyArrayObject *o_val =
      (PyArrayObject *)PyArray_SimpleNew(1, d_nnz, NPY_FLOAT64);
  auto *ptr = static_cast<int64_t *>(PyArray_DATA(o_ptr));
  auto *col = static_cast<int32_t *>(PyArray_DATA(o_col));
  auto *val = static_cast<double *>(PyArray_DATA(o_val));

  std::fill(ptr, ptr + n + 1, (int64_t)0);
  for (int64_t e = 0; e < ne; ++e) {
    ptr[ev.i[ev.s * e] + 1]++;
    ptr[ev.j[ev.s * e] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) ptr[v + 1] += ptr[v];
  {
    std::vector<int64_t> cur(ptr, ptr + n);
    for (int64_t e = 0; e < ne; ++e) {
      int64_t d = cur[ev.i[ev.s * e]]++;
      col[d] = (int32_t)ev.j[ev.s * e];
      val[d] = w[e];
      d = cur[ev.j[ev.s * e]]++;
      col[d] = (int32_t)ev.i[ev.s * e];
      val[d] = w[e];
    }
  }
  // ascending-column order per row (scipy canonical form)
  std::vector<std::pair<int32_t, double>> buf;
  for (int64_t v = 0; v < n; ++v) {
    const int64_t lo = ptr[v], hi = ptr[v + 1];
    if (hi - lo <= 1) continue;
    bool sorted = true;
    for (int64_t k = lo + 1; k < hi; ++k)
      if (col[k] < col[k - 1]) { sorted = false; break; }
    if (sorted) continue;
    buf.clear();
    for (int64_t k = lo; k < hi; ++k) buf.emplace_back(col[k], val[k]);
    std::sort(buf.begin(), buf.end(),
              [](const auto &a, const auto &b) { return a.first < b.first; });
    for (int64_t k = lo; k < hi; ++k) {
      col[k] = buf[(size_t)(k - lo)].first;
      val[k] = buf[(size_t)(k - lo)].second;
    }
  }
  return Py_BuildValue("(NNN)", o_ptr, o_col, o_val);
}

// ---------------------------------------------------------------------
// map_edges(ei, ej int64[ne], v2agg int64[n], nc)
//   -> (ce_lo int64[nec], ce_hi int64[nec], e2ce int64[ne])
// Coarse edge list + fine->coarse edge map under aggregation, ids in
// ascending (lo*nc + hi) key order (np.unique parity with
// mesh/topo.map_edges). Radix sort over the aggregate ids: two stable
// counting passes, O(ne + nc) — replaces the O(ne log ne) np.unique.
// ---------------------------------------------------------------------
PyObject *map_edges_agg(PyObject *, PyObject *args) {
  PyArrayObject *ei_o, *agg_o;
  PyObject *ej_o;
  long nc_l;
  if (!PyArg_ParseTuple(args, "O!OO!l", &PyArray_Type, &ei_o,
                        &ej_o, &PyArray_Type, &agg_o, &nc_l))
    return nullptr;
  const EdgeView ev = edge_view(ei_o, ej_o);
  auto *agg = static_cast<const int64_t *>(PyArray_DATA(agg_o));
  const int64_t ne = ev.ne;
  const int64_t nc = (int64_t)nc_l;

  npy_intp d_e[1] = {ne};
  PyArrayObject *o_e2ce =
      (PyArrayObject *)PyArray_SimpleNew(1, d_e, NPY_INT64);
  auto *e2ce = static_cast<int64_t *>(PyArray_DATA(o_e2ce));

  std::vector<int64_t> lo((size_t)ne), hi((size_t)ne), cross;
  cross.reserve((size_t)ne / 2);
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t a = agg[ev.i[ev.s * e]], b = agg[ev.j[ev.s * e]];
    const int64_t l = a < b ? a : b, h = a < b ? b : a;
    lo[(size_t)e] = l;
    hi[(size_t)e] = h;
    e2ce[e] = -1;
    if (l != h && l >= 0) cross.push_back(e);
  }
  const int64_t m = (int64_t)cross.size();
  // stable radix: sort cross-edge ids by hi, then by lo
  std::vector<int64_t> tmp((size_t)m), cnt((size_t)nc + 1);
  std::fill(cnt.begin(), cnt.end(), (int64_t)0);
  for (int64_t k = 0; k < m; ++k) cnt[(size_t)hi[(size_t)cross[(size_t)k]] + 1]++;
  for (int64_t c = 0; c < nc; ++c) cnt[(size_t)c + 1] += cnt[(size_t)c];
  for (int64_t k = 0; k < m; ++k)
    tmp[(size_t)cnt[(size_t)hi[(size_t)cross[(size_t)k]]]++] = cross[(size_t)k];
  std::fill(cnt.begin(), cnt.end(), (int64_t)0);
  for (int64_t k = 0; k < m; ++k) cnt[(size_t)lo[(size_t)tmp[(size_t)k]] + 1]++;
  for (int64_t c = 0; c < nc; ++c) cnt[(size_t)c + 1] += cnt[(size_t)c];
  for (int64_t k = 0; k < m; ++k)
    cross[(size_t)cnt[(size_t)lo[(size_t)tmp[(size_t)k]]]++] = tmp[(size_t)k];
  // unique scan
  std::vector<int64_t> ce_lo, ce_hi;
  ce_lo.reserve((size_t)m / 2);
  ce_hi.reserve((size_t)m / 2);
  int64_t pl = -1, ph = -1;
  for (int64_t k = 0; k < m; ++k) {
    const int64_t e = cross[(size_t)k];
    const int64_t l = lo[(size_t)e], h = hi[(size_t)e];
    if (l != pl || h != ph) {
      ce_lo.push_back(l);
      ce_hi.push_back(h);
      pl = l;
      ph = h;
    }
    e2ce[e] = (int64_t)ce_lo.size() - 1;
  }
  npy_intp d_c[2] = {(npy_intp)ce_lo.size(), 2};
  PyArrayObject *o_ce =
      (PyArrayObject *)PyArray_SimpleNew(2, d_c, NPY_INT64);
  auto *ce = static_cast<int64_t *>(PyArray_DATA(o_ce));
  for (size_t k = 0; k < ce_lo.size(); ++k) {
    ce[2 * k] = ce_lo[k];
    ce[2 * k + 1] = ce_hi[k];
  }
  return Py_BuildValue("(NN)", o_ce, o_e2ce);
}

// ---------------------------------------------------------------------
// rho_power_h1(ei, ej int64[ne], w f64[ne], d f64[n], x0 f64[n], iters)
//   -> float
// Power iteration for rho(Dhat^-1 A-hat) on the H1 replacement matrix
// given implicitly by the edge list (A-hat x = d*x - scatter of
// max(w,0); weights are SIGNED, the aux diagonal d = l2 + incident
// attractive sums is computed in-kernel in bincount order), with the
// start vector supplied by the caller (numpy RNG parity).
// ---------------------------------------------------------------------
PyObject *rho_power_h1(PyObject *, PyObject *args) {
  PyArrayObject *ei_o, *w_o, *l2_o, *x0_o;
  PyObject *ej_o;
  int iters;
  if (!PyArg_ParseTuple(args, "O!OO!O!O!i", &PyArray_Type, &ei_o,
                        &ej_o, &PyArray_Type, &w_o,
                        &PyArray_Type, &l2_o, &PyArray_Type, &x0_o, &iters))
    return nullptr;
  const EdgeView ev = edge_view(ei_o, ej_o);
  auto *w = static_cast<const double *>(PyArray_DATA(w_o));
  auto *l2 = static_cast<const double *>(PyArray_DATA(l2_o));
  auto *x0 = static_cast<const double *>(PyArray_DATA(x0_o));
  const int64_t ne = ev.ne;
  const int64_t n = PyArray_DIM(l2_o, 0);

  std::vector<double> d(l2, l2 + n);
  for (int64_t e = 0; e < ne; ++e)
    d[(size_t)ev.i[ev.s * e]] += w[e] > 0.0 ? w[e] : 0.0;
  for (int64_t e = 0; e < ne; ++e)
    d[(size_t)ev.j[ev.s * e]] += w[e] > 0.0 ? w[e] : 0.0;
  std::vector<double> x(x0, x0 + n), y((size_t)n);
  std::vector<double> dinv((size_t)n);
  for (int64_t v = 0; v < n; ++v)
    dinv[(size_t)v] = d[v] > 0.0 ? 1.0 / std::max(d[v], 1e-300) : 0.0;
  double lam = 1.0;
  for (int it = 0; it < iters; ++it) {
    for (int64_t v = 0; v < n; ++v) y[(size_t)v] = d[v] * x[(size_t)v];
    for (int64_t e = 0; e < ne; ++e) {
      const double wa = w[e] > 0.0 ? w[e] : 0.0;
      y[(size_t)ev.i[ev.s * e]] -= wa * x[(size_t)ev.j[ev.s * e]];
      y[(size_t)ev.j[ev.s * e]] -= wa * x[(size_t)ev.i[ev.s * e]];
    }
    double nrm2 = 0.0;
    for (int64_t v = 0; v < n; ++v) {
      x[(size_t)v] = dinv[(size_t)v] * y[(size_t)v];
      nrm2 += x[(size_t)v] * x[(size_t)v];
    }
    const double nrm = std::sqrt(nrm2);
    if (nrm == 0.0) return PyFloat_FromDouble(2.0);
    lam = nrm;
    const double inv = 1.0 / nrm;
    for (int64_t v = 0; v < n; ++v) x[(size_t)v] *= inv;
  }
  return PyFloat_FromDouble(lam);
}

// ---------------------------------------------------------------------
// tile_ell_pack(indptr int64[n+1], indices int64[nnz], data f64[nnz],
//               M long, T long)
//   -> (tdata f32[T, K, M], tcols int32[T, K], K)
// Pack a scalar CSR into tile-ELL: T tiles of M consecutive rows; each
// tile stores its rows' values at the tile's DISTINCT columns (ascending)
// — tdata[t, k, m] = A[t*M+m, tcols[t, k]] (0 where absent). K is the
// max distinct-column count over tiles; pad slots carry col 0 / value 0.
// The device matvec then gathers T*K scalars of x (one per distinct column)
// instead of one per nonzero, and runs a dense (K, M) FMA per tile.
// ---------------------------------------------------------------------
template <typename I, typename V>
PyObject *tile_ell_pack_impl(const I *ai, const I *aj, const V *av,
                             int64_t n, int64_t M, int64_t T) {
  // pass 1: K = max distinct columns per tile
  int64_t K = 1;
  std::vector<int64_t> cbuf;
  for (int64_t t = 0; t < T; ++t) {
    cbuf.clear();
    const int64_t r1 = std::min(t * M + M, n);
    for (int64_t r = t * M; r < r1; ++r)
      for (I k = ai[r]; k < ai[r + 1]; ++k)
        cbuf.push_back((int64_t)aj[k]);
    std::sort(cbuf.begin(), cbuf.end());
    const int64_t d =
        std::unique(cbuf.begin(), cbuf.end()) - cbuf.begin();
    if (d > K) K = d;
  }

  // output values follow the INPUT dtype (f64 packs feed the
  // mixed-precision outer's exact finest operator — rounding here would
  // silently cap the attainable accuracy at f32)
  npy_intp dd[3] = {T, K, M};
  npy_intp dc[2] = {T, K};
  const int ovt = sizeof(V) == 4 ? NPY_FLOAT32 : NPY_FLOAT64;
  PyArrayObject *o_dat =
      (PyArrayObject *)PyArray_ZEROS(3, dd, ovt, 0);
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_ZEROS(2, dc, NPY_INT32, 0);
  auto *td = static_cast<V *>(PyArray_DATA(o_dat));
  auto *tc = static_cast<int32_t *>(PyArray_DATA(o_col));

  for (int64_t t = 0; t < T; ++t) {
    cbuf.clear();
    const int64_t r1 = std::min(t * M + M, n);
    for (int64_t r = t * M; r < r1; ++r)
      for (I k = ai[r]; k < ai[r + 1]; ++k)
        cbuf.push_back((int64_t)aj[k]);
    std::sort(cbuf.begin(), cbuf.end());
    const int64_t d =
        std::unique(cbuf.begin(), cbuf.end()) - cbuf.begin();
    int32_t *cols_t = tc + t * K;
    for (int64_t k = 0; k < d; ++k) cols_t[k] = (int32_t)cbuf[(size_t)k];
    V *dat_t = td + t * K * M;
    for (int64_t r = t * M; r < r1; ++r) {
      const int64_t m = r - t * M;
      for (I k = ai[r]; k < ai[r + 1]; ++k) {
        const int64_t slot =
            std::lower_bound(cbuf.begin(), cbuf.begin() + d,
                             (int64_t)aj[k]) -
            cbuf.begin();
        dat_t[slot * M + m] = av[k];
      }
    }
  }
  return Py_BuildValue("(NNl)", o_dat, o_col, (long)K);
}

PyObject *tile_ell_pack(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o;
  long M_l, T_l;
  if (!PyArg_ParseTuple(args, "O!O!O!ll", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o, &M_l,
                        &T_l))
    return nullptr;
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  const int vt = PyArray_TYPE(av_o);
  if (vt != NPY_FLOAT32 && vt != NPY_FLOAT64) {
    PyErr_SetString(PyExc_TypeError, "data must be float32 or float64");
    return nullptr;
  }
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    const I *ai = static_cast<const I *>(PyArray_DATA(ai_o));
    const I *aj = static_cast<const I *>(PyArray_DATA(aj_o));
    if (vt == NPY_FLOAT32)
      return tile_ell_pack_impl<I, float>(
          ai, aj, static_cast<const float *>(PyArray_DATA(av_o)), n,
          (int64_t)M_l, (int64_t)T_l);
    return tile_ell_pack_impl<I, double>(
        ai, aj, static_cast<const double *>(PyArray_DATA(av_o)), n,
        (int64_t)M_l, (int64_t)T_l);
  });
}

// ---------------------------------------------------------------------
// tile_chunk_counts(indptr, indices, M long, chunk long, T long)
//   -> int64[T]: distinct column-CHUNK count per M-row tile.
// The bucketed tile-ELL planner's hot pass (sparse/formats.py
// _tile_chunk_counts replacement: no 18M-key lexsort/unique temporaries).
// ---------------------------------------------------------------------
template <typename I>
PyObject *tile_chunk_counts_impl(const I *ai, const I *aj, int64_t n,
                                 int64_t M, int64_t chunk, int64_t T) {
  npy_intp dT[1] = {T};
  PyArrayObject *o_cnt = (PyArrayObject *)PyArray_ZEROS(1, dT, NPY_INT64, 0);
  auto *cnt = static_cast<int64_t *>(PyArray_DATA(o_cnt));
  std::vector<int64_t> cbuf;
  for (int64_t t = 0; t < T; ++t) {
    cbuf.clear();
    const int64_t r1 = std::min(t * M + M, n);
    for (int64_t r = t * M; r < r1; ++r)
      for (I k = ai[r]; k < ai[r + 1]; ++k)
        cbuf.push_back((int64_t)aj[k] / chunk);
    std::sort(cbuf.begin(), cbuf.end());
    cnt[t] = std::unique(cbuf.begin(), cbuf.end()) - cbuf.begin();
  }
  return (PyObject *)o_cnt;
}

PyObject *tile_chunk_counts(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o;
  long M_l, chunk_l, T_l;
  if (!PyArg_ParseTuple(args, "O!O!lll", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &M_l, &chunk_l, &T_l))
    return nullptr;
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return tile_chunk_counts_impl<I>(
        static_cast<const I *>(PyArray_DATA(ai_o)),
        static_cast<const I *>(PyArray_DATA(aj_o)), n, (int64_t)M_l,
        (int64_t)chunk_l, (int64_t)T_l);
  });
}

// ---------------------------------------------------------------------
// tile_ell_fill_range(indptr, indices, data, M, chunk, t0, t1, K,
//                     out_data f32|f64[Tb, K, chunk, M], out_cols
//                     i32[Tb, K])
// Fill ONE bucket (tiles [t0, t1)) of the bucketed/column-chunked
// tile-ELL: slots = the tile's distinct column chunks ascending,
// out_data[tl, slot, c % chunk? -> coff, m] = A[t*M+m, col]. Arrays are
// caller-allocated zeros; returns None. One pass per bucket, no global
// lexsort/scatter temporaries (the python packer's 30-40 s at 18M nnz).
// ---------------------------------------------------------------------
template <typename I, typename V>
void tile_ell_fill_range_impl(const I *ai, const I *aj, const V *av,
                              int64_t n, int64_t M, int64_t chunk,
                              int64_t t0, int64_t t1, int64_t K, V *td,
                              int32_t *tc) {
  std::vector<int64_t> cbuf;
  for (int64_t t = t0; t < t1; ++t) {
    cbuf.clear();
    const int64_t r1 = std::min(t * M + M, n);
    for (int64_t r = t * M; r < r1; ++r)
      for (I k = ai[r]; k < ai[r + 1]; ++k)
        cbuf.push_back((int64_t)aj[k] / chunk);
    std::sort(cbuf.begin(), cbuf.end());
    const int64_t d = std::unique(cbuf.begin(), cbuf.end()) - cbuf.begin();
    const int64_t tl = t - t0;
    int32_t *cols_t = tc + tl * K;
    for (int64_t k = 0; k < d; ++k) cols_t[k] = (int32_t)cbuf[(size_t)k];
    V *dat_t = td + tl * K * chunk * M;
    for (int64_t r = t * M; r < r1; ++r) {
      const int64_t m = r - t * M;
      for (I k = ai[r]; k < ai[r + 1]; ++k) {
        const int64_t cc = (int64_t)aj[k] / chunk;
        const int64_t coff = (int64_t)aj[k] - cc * chunk;
        const int64_t slot =
            std::lower_bound(cbuf.begin(), cbuf.begin() + d, cc) -
            cbuf.begin();
        dat_t[(slot * chunk + coff) * M + m] = av[k];
      }
    }
  }
}

PyObject *tile_ell_fill_range(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o, *od_o, *oc_o;
  long M_l, chunk_l, t0_l, t1_l, K_l;
  if (!PyArg_ParseTuple(args, "O!O!O!lllllO!O!", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o, &M_l,
                        &chunk_l, &t0_l, &t1_l, &K_l, &PyArray_Type, &od_o,
                        &PyArray_Type, &oc_o))
    return nullptr;
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  const int vt = PyArray_TYPE(av_o);
  if (vt != NPY_FLOAT32 && vt != NPY_FLOAT64) {
    PyErr_SetString(PyExc_TypeError, "data must be float32 or float64");
    return nullptr;
  }
  if (PyArray_TYPE(od_o) != vt) {
    PyErr_SetString(PyExc_TypeError, "out_data dtype must match data");
    return nullptr;
  }
  PyObject *r = dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    const I *ai = static_cast<const I *>(PyArray_DATA(ai_o));
    const I *aj = static_cast<const I *>(PyArray_DATA(aj_o));
    if (vt == NPY_FLOAT32)
      tile_ell_fill_range_impl<I, float>(
          ai, aj, static_cast<const float *>(PyArray_DATA(av_o)), n,
          (int64_t)M_l, (int64_t)chunk_l, (int64_t)t0_l, (int64_t)t1_l,
          (int64_t)K_l, static_cast<float *>(PyArray_DATA(od_o)),
          static_cast<int32_t *>(PyArray_DATA(oc_o)));
    else
      tile_ell_fill_range_impl<I, double>(
          ai, aj, static_cast<const double *>(PyArray_DATA(av_o)), n,
          (int64_t)M_l, (int64_t)chunk_l, (int64_t)t0_l, (int64_t)t1_l,
          (int64_t)K_l, static_cast<double *>(PyArray_DATA(od_o)),
          static_cast<int32_t *>(PyArray_DATA(oc_o)));
    Py_RETURN_NONE;
  });
  return r;
}

// ---------------------------------------------------------------------
// spw_round_h1(edges | (ei, ej), w f64[ne] SIGNED, l2 f64[n],
//              cm uint8[n] | None, theta, iters)
//   -> partner int64[n]
// One fused H1 matching round (coarsen/pairwise.spw_aggregate_energy):
// aux diagonal d = l2 + incident max(w,0) (edge order, bincount parity),
// harmonic soc s_e = max(w,0)/2 (1/d_i + 1/d_j), symmetric adjacency
// (counting sort, edges_to_adj parity), then the jittered handshake
// matching of handshake_match — replacing ~10 allocating O(ne) numpy
// passes per round per level.
// ---------------------------------------------------------------------
PyObject *spw_round_h1(PyObject *, PyObject *args) {
  PyArrayObject *ei_o, *w_o, *l2_o;
  PyObject *ej_o, *cm_o;
  double theta;
  int iters = 8;
  if (!PyArg_ParseTuple(args, "O!OO!O!Od|i", &PyArray_Type, &ei_o,
                        &ej_o, &PyArray_Type, &w_o,
                        &PyArray_Type, &l2_o, &cm_o, &theta, &iters))
    return nullptr;
  const EdgeView ev = edge_view(ei_o, ej_o);
  auto *w = static_cast<const double *>(PyArray_DATA(w_o));
  auto *l2 = static_cast<const double *>(PyArray_DATA(l2_o));
  const uint8_t *cm = nullptr;
  if (cm_o != Py_None)
    cm = static_cast<const uint8_t *>(
        PyArray_DATA((PyArrayObject *)cm_o));
  const int64_t ne = ev.ne;
  const int64_t n = PyArray_DIM(l2_o, 0);

  // aux diagonal (numpy-bincount accumulation order: edge order)
  std::vector<double> d(l2, l2 + n);
  for (int64_t e = 0; e < ne; ++e) {
    const double wa = w[e] > 0.0 ? w[e] : 0.0;
    d[(size_t)ev.i[ev.s * e]] += wa;
  }
  for (int64_t e = 0; e < ne; ++e) {
    const double wa = w[e] > 0.0 ? w[e] : 0.0;
    d[(size_t)ev.j[ev.s * e]] += wa;
  }
  for (int64_t v = 0; v < n; ++v) d[(size_t)v] = std::max(d[(size_t)v], 1e-300);

  // symmetric adjacency with soc values + in-place jitter
  std::vector<int64_t> ptr(n + 1, 0);
  for (int64_t e = 0; e < ne; ++e) {
    ptr[ev.i[ev.s * e] + 1]++;
    ptr[ev.j[ev.s * e] + 1]++;
  }
  for (int64_t v = 0; v < n; ++v) ptr[v + 1] += ptr[v];
  std::vector<int32_t> col((size_t)(2 * ne));
  std::vector<double> val((size_t)(2 * ne));
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t e = 0; e < ne; ++e) {
      const int64_t a = ev.i[ev.s * e], b = ev.j[ev.s * e];
      const double wa = w[e] > 0.0 ? w[e] : 0.0;
      const double soc =
          wa * 0.5 * (1.0 / d[(size_t)a] + 1.0 / d[(size_t)b]);
      const int64_t h =
          (a * (int64_t)2654435761LL + b * (int64_t)40503LL) &
          (int64_t)0xFFFFFFFFLL;
      const double sj = soc * (1.0 + 1e-9 * ((double)h / 4294967296.0));
      int64_t q = cur[(size_t)a]++;
      col[(size_t)q] = (int32_t)b;
      val[(size_t)q] = sj;
      q = cur[(size_t)b]++;
      col[(size_t)q] = (int32_t)a;
      val[(size_t)q] = sj;
    }
  }

  npy_intp dims[1] = {n};
  PyArrayObject *out =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT64);
  auto *partner = static_cast<int64_t *>(PyArray_DATA(out));
  std::fill(partner, partner + n, (int64_t)-1);
  std::vector<double> rowmax(n, 0.0);
  for (int64_t v = 0; v < n; ++v)
    for (int64_t k = ptr[v]; k < ptr[v + 1]; ++k)
      rowmax[(size_t)v] = std::max(rowmax[(size_t)v], val[(size_t)k]);
  std::vector<int64_t> best(n);
  for (int it = 0; it < iters; ++it) {
    bool any = false;
    for (int64_t v = 0; v < n; ++v) {
      best[(size_t)v] = -1;
      if (partner[v] >= 0 || (cm && !cm[v])) continue;
      double bw = -1.0;
      for (int64_t k = ptr[v]; k < ptr[v + 1]; ++k) {
        const int64_t nb = (int64_t)col[(size_t)k];
        if (partner[nb] >= 0 || (cm && !cm[nb])) continue;
        const double thr =
            theta * std::min(rowmax[(size_t)v], rowmax[(size_t)nb]);
        if (val[(size_t)k] < thr || val[(size_t)k] <= 0.0) continue;
        if (val[(size_t)k] > bw) {
          bw = val[(size_t)k];
          best[(size_t)v] = nb;
        }
      }
    }
    for (int64_t v = 0; v < n; ++v) {
      const int64_t b = best[(size_t)v];
      if (b > v && best[(size_t)b] == v) {
        partner[v] = b;
        partner[b] = v;
        any = true;
      }
    }
    if (!any) break;
  }
  return (PyObject *)out;
}

// ---------------------------------------------------------------------
// bsr_from_edge_blocks(edges (ne,2) int64, Bii, Bij, Bji, Bjj
//                      (ne,d,d) f64, Dv (nv,d,d) f64)
//   -> (indptr int64[nv+1], indices int32[nnzb], blocks f64[nnzb,d,d])
// Assemble the block replacement matrix A-hat from per-edge blocks +
// per-vertex diagonal blocks (apps/elasticity.replacement_matrix /
// reference CalcRMBlock assembly, aux_mat.hpp): BSR with ascending
// columns in one counting-sort pass — replaces a lexsort + unique +
// add.reduceat chain over 4*ne (d,d) blocks (~8 s of 9 s of the block
// smoothed-prol at 26k DoF).
// ---------------------------------------------------------------------
PyObject *bsr_from_edge_blocks(PyObject *, PyObject *args) {
  PyArrayObject *e_o, *bii_o, *bij_o, *bji_o, *bjj_o, *dv_o;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!", &PyArray_Type, &e_o,
                        &PyArray_Type, &bii_o, &PyArray_Type, &bij_o,
                        &PyArray_Type, &bji_o, &PyArray_Type, &bjj_o,
                        &PyArray_Type, &dv_o))
    return nullptr;
  const int64_t ne = PyArray_DIM(e_o, 0);
  const int64_t nv = PyArray_DIM(dv_o, 0);
  const int64_t d = PyArray_DIM(dv_o, 1);
  const int64_t dd = d * d;
  auto *edg = static_cast<const int64_t *>(PyArray_DATA(e_o));
  auto *bii = static_cast<const double *>(PyArray_DATA(bii_o));
  auto *bij = static_cast<const double *>(PyArray_DATA(bij_o));
  auto *bji = static_cast<const double *>(PyArray_DATA(bji_o));
  auto *bjj = static_cast<const double *>(PyArray_DATA(bjj_o));
  auto *dv = static_cast<const double *>(PyArray_DATA(dv_o));

  // row block degrees: diag + incident edges (duplicate (i,j) edges
  // cannot occur in a mesh edge list)
  npy_intp d_ptr[1] = {nv + 1};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  auto *ptr = static_cast<int64_t *>(PyArray_DATA(o_ptr));
  std::fill(ptr, ptr + nv + 1, (int64_t)0);
  for (int64_t e = 0; e < ne; ++e) {
    ptr[edg[2 * e] + 1]++;
    ptr[edg[2 * e + 1] + 1]++;
  }
  for (int64_t v = 0; v < nv; ++v) ptr[v + 1] += ptr[v] + 1;  // +diag
  const int64_t nnzb = ptr[nv];
  npy_intp d_col[1] = {nnzb};
  npy_intp d_blk[3] = {nnzb, d, d};
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_col, NPY_INT32);
  PyArrayObject *o_blk =
      (PyArrayObject *)PyArray_SimpleNew(3, d_blk, NPY_FLOAT64);
  auto *col = static_cast<int32_t *>(PyArray_DATA(o_col));
  auto *blk = static_cast<double *>(PyArray_DATA(o_blk));
  // place diagonals first, then scatter edge blocks; per-row sort after
  std::vector<int64_t> cur(nv);
  for (int64_t v = 0; v < nv; ++v) {
    col[ptr[v]] = (int32_t)v;
    std::copy(dv + v * dd, dv + (v + 1) * dd, blk + ptr[v] * dd);
    cur[(size_t)v] = ptr[v] + 1;
  }
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t i = edg[2 * e], j = edg[2 * e + 1];
    int64_t q = cur[(size_t)i]++;
    col[q] = (int32_t)j;
    std::copy(bij + e * dd, bij + (e + 1) * dd, blk + q * dd);
    // Bii accumulates into the diagonal block of row i
    double *di = blk + ptr[i] * dd;
    const double *src = bii + e * dd;
    for (int64_t k = 0; k < dd; ++k) di[k] += src[k];
    q = cur[(size_t)j]++;
    col[q] = (int32_t)i;
    std::copy(bji + e * dd, bji + (e + 1) * dd, blk + q * dd);
    double *dj = blk + ptr[j] * dd;
    src = bjj + e * dd;
    for (int64_t k = 0; k < dd; ++k) dj[k] += src[k];
  }
  // ascending-column rows (diag placed first -> sort each row)
  std::vector<std::pair<int32_t, int64_t>> ord;
  std::vector<double> tmp;
  for (int64_t v = 0; v < nv; ++v) {
    const int64_t lo = ptr[v], hi = ptr[v + 1];
    bool sorted = true;
    for (int64_t k = lo + 1; k < hi; ++k)
      if (col[k] < col[k - 1]) { sorted = false; break; }
    if (sorted) continue;
    ord.clear();
    for (int64_t k = lo; k < hi; ++k) ord.emplace_back(col[k], k);
    std::sort(ord.begin(), ord.end());
    tmp.assign(blk + lo * dd, blk + hi * dd);
    for (int64_t k = lo; k < hi; ++k) {
      col[k] = ord[(size_t)(k - lo)].first;
      const int64_t src = ord[(size_t)(k - lo)].second - lo;
      std::copy(tmp.begin() + src * dd, tmp.begin() + (src + 1) * dd,
                blk + k * dd);
    }
  }
  return Py_BuildValue("(NNN)", o_ptr, o_col, o_blk);
}

// ---------------------------------------------------------------------
// cluster_detect(indptr, indices, data f64, beta, eig_ratio, max_size)
//   -> (blocks f64 (ncand,K,K), members int32 (ncand,K), csz int32)
// One fused pass for smoothers/cluster_corr.detect_clusters: strength
// test |a_ij| >= beta sqrt(a_ii a_jj) feeds an array union-find; eligible
// components (2..max_size vertices) are screened IN-KERNEL — exact 2x2
// smallest eigenvalue for pairs, Gershgorin lower bound for larger
// blocks (a cluster whose bound already clears eig_ratio*maxdiag cannot
// be defective) — and only candidates get dense blocks extracted. This
// replaces ~6 allocating O(nnz) numpy passes (~20 s at 1M DoF under
// host memory pressure) with one read-only sweep.
// ---------------------------------------------------------------------
template <typename I>
PyObject *cluster_detect_impl(const I *ai, const I *aj, const double *av,
                              int64_t n, double beta, double eig_ratio,
                              int64_t max_size) {
  std::vector<double> diag(n, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for (I k = ai[i]; k < ai[i + 1]; ++k)
      if (aj[k] == i) diag[(size_t)i] = av[k];
  const double b2 = beta * beta;
  // union-find with path halving
  std::vector<int32_t> par(n);
  for (int64_t i = 0; i < n; ++i) par[(size_t)i] = (int32_t)i;
  auto find = [&](int32_t x) {
    while (par[(size_t)x] != x) {
      par[(size_t)x] = par[(size_t)par[(size_t)x]];
      x = par[(size_t)x];
    }
    return x;
  };
  for (int64_t i = 0; i < n; ++i) {
    const double di = diag[(size_t)i];
    if (di <= 0.0) continue;
    for (I k = ai[i]; k < ai[i + 1]; ++k) {
      const int64_t j = aj[k];
      if (j <= i) continue;
      const double dj = diag[(size_t)j];
      if (dj <= 0.0) continue;
      if (av[k] * av[k] >= b2 * di * dj) {
        int32_t ra = find((int32_t)i), rb = find((int32_t)j);
        if (ra != rb) par[(size_t)(ra < rb ? rb : ra)] = (ra < rb ? ra : rb);
      }
    }
  }
  // component sizes at roots
  std::vector<int32_t> sz(n, 0);
  for (int64_t i = 0; i < n; ++i) sz[(size_t)find((int32_t)i)]++;
  // eligible components -> contiguous ids; per-vertex slot in ascending
  // vertex order (matches the python lexsort layout)
  std::vector<int32_t> cid(n, -1);
  int64_t ncl = 0, K = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (par[(size_t)i] == (int32_t)i && sz[(size_t)i] >= 2 &&
        sz[(size_t)i] <= max_size) {
      cid[(size_t)i] = (int32_t)ncl++;
      K = std::max<int64_t>(K, sz[(size_t)i]);
    }
  }
  if (ncl == 0) {
    npy_intp z3[3] = {0, 0, 0}, z2[2] = {0, 0}, z1[1] = {0};
    return Py_BuildValue(
        "(NNN)", PyArray_ZEROS(3, z3, NPY_FLOAT64, 0),
        PyArray_ZEROS(2, z2, NPY_INT32, 0),
        PyArray_ZEROS(1, z1, NPY_INT32, 0));
  }
  std::vector<int32_t> vcl(n, -1), vslot(n, -1), cnt((size_t)ncl, 0);
  std::vector<std::vector<int32_t>> mem((size_t)ncl);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t c = cid[(size_t)find((int32_t)i)];
    if (c < 0) continue;
    vcl[(size_t)i] = c;
    vslot[(size_t)i] = cnt[(size_t)c]++;
    mem[(size_t)c].push_back((int32_t)i);
  }
  // in-kernel screening: candidates = clusters that MIGHT be defective
  // scratch dense block (K x K) reused per cluster
  std::vector<double> blk((size_t)(K * K));
  std::vector<int32_t> cand;
  cand.reserve((size_t)ncl / 4 + 16);
  for (int64_t c = 0; c < ncl; ++c) {
    const auto &m = mem[(size_t)c];
    const int64_t s = (int64_t)m.size();
    std::fill(blk.begin(), blk.begin() + (size_t)(s * s), 0.0);
    double maxd = 0.0;
    for (int64_t a = 0; a < s; ++a) {
      const int64_t i = m[(size_t)a];
      for (I k = ai[i]; k < ai[i + 1]; ++k) {
        const int64_t j = aj[k];
        if (vcl[(size_t)j] == (int32_t)c)
          blk[(size_t)(a * s + vslot[(size_t)j])] = av[k];
      }
      maxd = std::max(maxd, blk[(size_t)(a * s + a)]);
    }
    if (maxd <= 0.0) continue;
    bool candidate;
    if (s == 2) {  // exact smallest eigenvalue of the 2x2 block
      const double d1 = blk[0], d2 = blk[3], o = blk[1];
      const double tr = d1 + d2, df = d1 - d2;
      const double lam = 0.5 * (tr - std::sqrt(df * df + 4.0 * o * o));
      candidate = lam < eig_ratio * maxd;
    } else {  // Gershgorin lower bound: can only prove NON-defective
      double lo = 1e300;
      for (int64_t a = 0; a < s; ++a) {
        double row = blk[(size_t)(a * s + a)];
        for (int64_t b = 0; b < s; ++b)
          if (b != a) row -= std::abs(blk[(size_t)(a * s + b)]);
        lo = std::min(lo, row);
      }
      candidate = lo < eig_ratio * maxd;
    }
    if (candidate) cand.push_back((int32_t)c);
  }
  const int64_t nc = (int64_t)cand.size();
  npy_intp d_b[3] = {nc, K, K}, d_m[2] = {nc, K}, d_s[1] = {nc};
  PyArrayObject *o_blk = (PyArrayObject *)PyArray_ZEROS(3, d_b, NPY_FLOAT64, 0);
  PyArrayObject *o_mem = (PyArrayObject *)PyArray_ZEROS(2, d_m, NPY_INT32, 0);
  PyArrayObject *o_sz = (PyArrayObject *)PyArray_ZEROS(1, d_s, NPY_INT32, 0);
  auto *ob = static_cast<double *>(PyArray_DATA(o_blk));
  auto *om = static_cast<int32_t *>(PyArray_DATA(o_mem));
  auto *os = static_cast<int32_t *>(PyArray_DATA(o_sz));
  for (int64_t q = 0; q < nc; ++q) {
    const auto &m = mem[(size_t)cand[(size_t)q]];
    const int64_t s = (int64_t)m.size();
    os[q] = (int32_t)s;
    for (int64_t a = 0; a < s; ++a) {
      const int64_t i = m[(size_t)a];
      om[q * K + a] = (int32_t)i;
      for (I k = ai[i]; k < ai[i + 1]; ++k) {
        const int64_t j = aj[k];
        if (vcl[(size_t)j] == cand[(size_t)q])
          ob[(q * K + a) * K + vslot[(size_t)j]] = av[k];
      }
    }
  }
  return Py_BuildValue("(NNN)", o_blk, o_mem, o_sz);
}

PyObject *cluster_detect(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o;
  double beta, eig_ratio;
  long max_size_l;
  if (!PyArg_ParseTuple(args, "O!O!O!ddl", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o, &beta,
                        &eig_ratio, &max_size_l))
    return nullptr;
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  auto *av = static_cast<const double *>(PyArray_DATA(av_o));
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    return cluster_detect_impl<I>(
        static_cast<const I *>(PyArray_DATA(ai_o)),
        static_cast<const I *>(PyArray_DATA(aj_o)), av, n, beta,
        eig_ratio, (int64_t)max_size_l);
  });
}

// ---------------------------------------------------------------------
// Batched small symmetric eigen-math (the robust-SOC hot path).
//
// Replaces the numpy eigh/pinv/eigvalsh pipeline of
// apps/elasticity.py::soc_robust / _pencil_extreme_eig (the reference's
// CalcRobustPairSOC + PrepRobSOC, agglomerator_utils.hpp:764-885) with a
// fused cyclic-Jacobi solver: at d<=8 one Jacobi eigensolve is ~1 us, vs
// ~3 us per LAPACK call plus the O(ne*d*d) numpy temporaries between the
// stages (measured 11.6 s of 25.8 s setup at 147k DoF 3D elasticity).
// ---------------------------------------------------------------------

constexpr int kMaxD = 8;

// Cyclic Jacobi on row-major symmetric A (D x D, destroyed -> diagonal);
// V receives eigenvectors as COLUMNS; lam the eigenvalues (unsorted).
// Compile-time D so all inner loops unroll; SOC scores only order
// candidates, so the off-diagonal target is 1e-12 relative (not eps64).
template <int D, bool WANT_V>
static void jacobi_eig_t(double *A, double *V, double *lam) {
  if (WANT_V) {
    for (int i = 0; i < D * D; ++i) V[i] = 0.0;
    for (int i = 0; i < D; ++i) V[i * D + i] = 1.0;
  }
  double fro2 = 0.0;
  for (int i = 0; i < D * D; ++i) fro2 += A[i] * A[i];
  const double stop = 1e-24 * fro2;
  const double skip = stop / (D * D);
  for (int sweep = 0; sweep < 24; ++sweep) {
    double off2 = 0.0;
    for (int p = 0; p < D; ++p)
      for (int q = p + 1; q < D; ++q) off2 += A[p * D + q] * A[p * D + q];
    if (off2 <= stop) break;
    for (int p = 0; p < D; ++p)
      for (int q = p + 1; q < D; ++q) {
        const double apq = A[p * D + q];
        if (apq * apq <= skip) continue;
        const double app = A[p * D + p], aqq = A[q * D + q];
        const double tau = (aqq - app) / (2.0 * apq);
        const double t =
            (tau >= 0 ? 1.0 : -1.0) /
            (std::abs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t), s = t * c;
        for (int k = 0; k < D; ++k) {  // A <- J^T A J (columns p,q)
          const double akp = A[k * D + p], akq = A[k * D + q];
          A[k * D + p] = c * akp - s * akq;
          A[k * D + q] = s * akp + c * akq;
        }
        for (int k = 0; k < D; ++k) {  // rows p,q
          const double apk = A[p * D + k], aqk = A[q * D + k];
          A[p * D + k] = c * apk - s * aqk;
          A[q * D + k] = s * apk + c * aqk;
        }
        if (WANT_V)
          for (int k = 0; k < D; ++k) {
            const double vkp = V[k * D + p], vkq = V[k * D + q];
            V[k * D + p] = c * vkp - s * vkq;
            V[k * D + q] = s * vkp + c * vkq;
          }
      }
  }
  for (int i = 0; i < D; ++i) lam[i] = A[i * D + i];
}

// Runtime-d dispatch (d <= 8). Fixed-size paths for the hot 2/3/6.
static void jacobi_eig(double *A, double *V, double *lam, int d,
                       bool want_v) {
  switch (d * 2 + (want_v ? 1 : 0)) {
    case 2 * 2 + 1: return jacobi_eig_t<2, true>(A, V, lam);
    case 2 * 2 + 0: return jacobi_eig_t<2, false>(A, V, lam);
    case 3 * 2 + 1: return jacobi_eig_t<3, true>(A, V, lam);
    case 3 * 2 + 0: return jacobi_eig_t<3, false>(A, V, lam);
    case 6 * 2 + 1: return jacobi_eig_t<6, true>(A, V, lam);
    case 6 * 2 + 0: return jacobi_eig_t<6, false>(A, V, lam);
    default: break;
  }
  // generic fallback (rare sizes): same algorithm, runtime d
  if (want_v) {
    for (int i = 0; i < d * d; ++i) V[i] = 0.0;
    for (int i = 0; i < d; ++i) V[i * d + i] = 1.0;
  }
  double fro2 = 0.0;
  for (int i = 0; i < d * d; ++i) fro2 += A[i] * A[i];
  const double stop = 1e-24 * fro2;
  for (int sweep = 0; sweep < 24; ++sweep) {
    double off2 = 0.0;
    for (int p = 0; p < d; ++p)
      for (int q = p + 1; q < d; ++q) off2 += A[p * d + q] * A[p * d + q];
    if (off2 <= stop) break;
    for (int p = 0; p < d; ++p)
      for (int q = p + 1; q < d; ++q) {
        const double apq = A[p * d + q];
        if (!(std::abs(apq) > 0.0)) continue;
        const double app = A[p * d + p], aqq = A[q * d + q];
        const double tau = (aqq - app) / (2.0 * apq);
        const double t =
            (tau >= 0 ? 1.0 : -1.0) /
            (std::abs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t), s = t * c;
        for (int k = 0; k < d; ++k) {
          const double akp = A[k * d + p], akq = A[k * d + q];
          A[k * d + p] = c * akp - s * akq;
          A[k * d + q] = s * akp + c * akq;
        }
        for (int k = 0; k < d; ++k) {
          const double apk = A[p * d + k], aqk = A[q * d + k];
          A[p * d + k] = c * apk - s * aqk;
          A[q * d + k] = s * apk + c * aqk;
        }
        if (want_v)
          for (int k = 0; k < d; ++k) {
            const double vkp = V[k * d + p], vkq = V[k * d + q];
            V[k * d + p] = c * vkp - s * vkq;
            V[k * d + q] = s * vkp + c * vkq;
          }
      }
  }
  for (int i = 0; i < d; ++i) lam[i] = A[i * d + i];
}

// One pencil solve: extreme eigenvalue of (E, C) restricted to range(C),
// clamped at 0 (null C -> 0). E, C row-major d x d; C is NOT modified.
static double pencil_one(const double *Ee, const double *Ce, int d,
                         double tol, int reduction) {
  double work[kMaxD * kMaxD], V[kMaxD * kMaxD], lam[kMaxD];
  double W[kMaxD * kMaxD], EW[kMaxD * kMaxD], M[kMaxD * kMaxD];
  double lam2[kMaxD];
  std::copy(Ce, Ce + d * d, work);
  jacobi_eig(work, V, lam, d, true);
  double lmax = 0.0;
  for (int k = 0; k < d; ++k) lmax = std::max(lmax, lam[k]);
  int ko = 0;
  for (int k = 0; k < d; ++k)
    if (lam[k] > tol * std::max(lmax, 1e-300)) {
      const double isq = 1.0 / std::sqrt(lam[k]);
      for (int r = 0; r < d; ++r) W[r * d + ko] = V[r * d + k] * isq;
      ++ko;
    }
  if (ko == 0) return 0.0;
  for (int r = 0; r < d; ++r)
    for (int c2 = 0; c2 < ko; ++c2) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) acc += Ee[r * d + k] * W[k * d + c2];
      EW[r * d + c2] = acc;
    }
  for (int r = 0; r < ko; ++r)
    for (int c2 = 0; c2 < ko; ++c2) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) acc += W[k * d + r] * EW[k * d + c2];
      M[r * ko + c2] = acc;
    }
  jacobi_eig(M, V, lam2, ko, false);
  double ev = lam2[0];
  if (reduction == 0)
    for (int k = 1; k < ko; ++k) ev = std::min(ev, lam2[k]);
  else
    for (int k = 1; k < ko; ++k) ev = std::max(ev, lam2[k]);
  return std::max(ev, 0.0);
}

// Symmetrized series energy T = A (A+B)^+ B for one d x d pair.
static void harmonic_one(const double *Ae, const double *Be, int d,
                         double rcond, double *out) {
  double S[kMaxD * kMaxD], V[kMaxD * kMaxD], lam[kMaxD];
  double P[kMaxD * kMaxD], AP[kMaxD * kMaxD], T[kMaxD * kMaxD];
  const int dd = d * d;
  for (int k = 0; k < dd; ++k) S[k] = Ae[k] + Be[k];
  jacobi_eig(S, V, lam, d, true);
  double lmax = 0.0;
  for (int k = 0; k < d; ++k) lmax = std::max(lmax, std::abs(lam[k]));
  for (int r = 0; r < d; ++r)
    for (int c2 = 0; c2 < d; ++c2) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k)
        if (std::abs(lam[k]) > rcond * std::max(lmax, 1e-300))
          acc += V[r * d + k] * V[c2 * d + k] / lam[k];
      P[r * d + c2] = acc;
    }
  for (int r = 0; r < d; ++r)
    for (int c2 = 0; c2 < d; ++c2) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) acc += Ae[r * d + k] * P[k * d + c2];
      AP[r * d + c2] = acc;
    }
  for (int r = 0; r < d; ++r)
    for (int c2 = 0; c2 < d; ++c2) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) acc += AP[r * d + k] * Be[k * d + c2];
      T[r * d + c2] = acc;
    }
  for (int r = 0; r < d; ++r)
    for (int c2 = 0; c2 < d; ++c2)
      out[r * d + c2] = 0.5 * (T[r * d + c2] + T[c2 * d + r]);
}

// Rigid-body congruence out = Q^T M Q with Q = I except the displacement-
// rotation coupling block Q[:dim, dim:] = -skew(d)*s (3D) / (-dy, dx)*s
// (2D) — the transport of apps/elasticity.ElasticityEnergy.transport for
// a displacement d = (to - from).
static void rigid_congruence(const double *M, const double *dvec, int dim,
                             int dpv, double s, double *out) {
  double Q[kMaxD * kMaxD], T[kMaxD * kMaxD];
  for (int i = 0; i < dpv * dpv; ++i) Q[i] = 0.0;
  for (int i = 0; i < dpv; ++i) Q[i * dpv + i] = 1.0;
  if (dim == 2) {
    Q[0 * dpv + 2] = -dvec[1] * s;
    Q[1 * dpv + 2] = dvec[0] * s;
  } else {
    const double dx = dvec[0], dy = dvec[1], dz = dvec[2];
    Q[0 * dpv + 4] = s * dz;
    Q[0 * dpv + 5] = -s * dy;
    Q[1 * dpv + 3] = -s * dz;
    Q[1 * dpv + 5] = s * dx;
    Q[2 * dpv + 3] = s * dy;
    Q[2 * dpv + 4] = -s * dx;
  }
  for (int r = 0; r < dpv; ++r)  // T = M Q
    for (int c = 0; c < dpv; ++c) {
      double acc = 0.0;
      for (int k = 0; k < dpv; ++k) acc += M[r * dpv + k] * Q[k * dpv + c];
      T[r * dpv + c] = acc;
    }
  for (int r = 0; r < dpv; ++r)  // out = Q^T T
    for (int c = 0; c < dpv; ++c) {
      double acc = 0.0;
      for (int k = 0; k < dpv; ++k) acc += Q[k * dpv + r] * T[k * dpv + c];
      out[r * dpv + c] = acc;
    }
}

// Build Q (dpv x dpv) for displacement d (transport I + coupling block).
static void rigid_q(const double *dvec, int dim, int dpv, double s,
                    double *Q) {
  for (int i = 0; i < dpv * dpv; ++i) Q[i] = 0.0;
  for (int i = 0; i < dpv; ++i) Q[i * dpv + i] = 1.0;
  if (dim == 2) {
    Q[0 * dpv + 2] = -dvec[1] * s;
    Q[1 * dpv + 2] = dvec[0] * s;
  } else {
    const double dx = dvec[0], dy = dvec[1], dz = dvec[2];
    Q[0 * dpv + 4] = s * dz;
    Q[0 * dpv + 5] = -s * dy;
    Q[1 * dpv + 3] = -s * dz;
    Q[1 * dpv + 5] = s * dx;
    Q[2 * dpv + 3] = s * dy;
    Q[2 * dpv + 4] = -s * dx;
  }
}

// rigid_edge_blocks(pos, edges, E (ne,dpv,dpv), s) ->
// (Bii, Bij, Bji, Bjj) each (ne,dpv,dpv): the replacement-matrix blocks
// [Qim^T E Qim, -Qim^T E Qjm; ., Qjm^T E Qjm] (CalcRMBlockImpl) — the
// fused version of apps/elasticity._edge_rm_blocks.
PyObject *rigid_edge_blocks(PyObject *, PyObject *args) {
  PyArrayObject *pos_o, *e_o, *em_o;
  double s;
  if (!PyArg_ParseTuple(args, "O!O!O!d", &PyArray_Type, &pos_o,
                        &PyArray_Type, &e_o, &PyArray_Type, &em_o, &s))
    return nullptr;
  const int dim = (int)PyArray_DIM(pos_o, 1);
  const int64_t ne = PyArray_DIM(e_o, 0);
  const int dpv = (int)PyArray_DIM(em_o, 1);
  if (dpv > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *pos = static_cast<const double *>(PyArray_DATA(pos_o));
  auto *edg = static_cast<const int64_t *>(PyArray_DATA(e_o));
  auto *E = static_cast<const double *>(PyArray_DATA(em_o));
  npy_intp dims[3] = {ne, dpv, dpv};
  PyArrayObject *o_ii =
      (PyArrayObject *)PyArray_SimpleNew(3, dims, NPY_FLOAT64);
  PyArrayObject *o_ij =
      (PyArrayObject *)PyArray_SimpleNew(3, dims, NPY_FLOAT64);
  PyArrayObject *o_ji =
      (PyArrayObject *)PyArray_SimpleNew(3, dims, NPY_FLOAT64);
  PyArrayObject *o_jj =
      (PyArrayObject *)PyArray_SimpleNew(3, dims, NPY_FLOAT64);
  auto *bii = static_cast<double *>(PyArray_DATA(o_ii));
  auto *bij = static_cast<double *>(PyArray_DATA(o_ij));
  auto *bji = static_cast<double *>(PyArray_DATA(o_ji));
  auto *bjj = static_cast<double *>(PyArray_DATA(o_jj));
  const int dd = dpv * dpv;
  double dvec[3], Qi[kMaxD * kMaxD], Qj[kMaxD * kMaxD];
  double T1[kMaxD * kMaxD], T2[kMaxD * kMaxD];
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t i = edg[2 * e], j = edg[2 * e + 1];
    const double *Ee = E + e * dd;
    for (int k = 0; k < dim; ++k)
      dvec[k] = 0.5 * (pos[j * dim + k] - pos[i * dim + k]);  // mid - i
    rigid_q(dvec, dim, dpv, s, Qi);
    for (int k = 0; k < dim; ++k) dvec[k] = -dvec[k];  // mid - j
    rigid_q(dvec, dim, dpv, s, Qj);
    for (int r = 0; r < dpv; ++r)  // T1 = E Qi, T2 = E Qj
      for (int c = 0; c < dpv; ++c) {
        double a1 = 0.0, a2 = 0.0;
        for (int k = 0; k < dpv; ++k) {
          const double erk = Ee[r * dpv + k];
          a1 += erk * Qi[k * dpv + c];
          a2 += erk * Qj[k * dpv + c];
        }
        T1[r * dpv + c] = a1;
        T2[r * dpv + c] = a2;
      }
    double *pii = bii + e * dd, *pij = bij + e * dd;
    double *pji = bji + e * dd, *pjj = bjj + e * dd;
    for (int r = 0; r < dpv; ++r)
      for (int c = 0; c < dpv; ++c) {
        double aii = 0.0, aij = 0.0, ajj = 0.0;
        for (int k = 0; k < dpv; ++k) {
          aii += Qi[k * dpv + r] * T1[k * dpv + c];
          aij += Qi[k * dpv + r] * T2[k * dpv + c];
          ajj += Qj[k * dpv + r] * T2[k * dpv + c];
        }
        pii[r * dpv + c] = aii;
        pij[r * dpv + c] = -aij;
        pjj[r * dpv + c] = ajj;
      }
    for (int r = 0; r < dpv; ++r)
      for (int c = 0; c < dpv; ++c)
        pji[r * dpv + c] = pij[c * dpv + r];
  }
  return Py_BuildValue("(NNNN)", o_ii, o_ij, o_ji, o_jj);
}

// elast_rm_diag(pos (nv,dim) f64, edges (ne,2) i64, E (ne,dpv,dpv) f64,
// s) -> D (nv,dpv,dpv): the replacement-matrix diagonal accumulation
// D[i] += Qim^T E Qim, D[j] += Qjm^T E Qjm with Q*m the half transports
// to the edge midpoint (apps/elasticity.aux_diagonal without the l2/stab
// terms) — fused, no (ne,dpv,dpv) temporaries.
PyObject *elast_rm_diag(PyObject *, PyObject *args) {
  PyArrayObject *pos_o, *e_o, *em_o;
  double s;
  if (!PyArg_ParseTuple(args, "O!O!O!d", &PyArray_Type, &pos_o,
                        &PyArray_Type, &e_o, &PyArray_Type, &em_o, &s))
    return nullptr;
  const int64_t nv = PyArray_DIM(pos_o, 0);
  const int dim = (int)PyArray_DIM(pos_o, 1);
  const int64_t ne = PyArray_DIM(e_o, 0);
  const int dpv = (int)PyArray_DIM(em_o, 1);
  if (dpv > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *pos = static_cast<const double *>(PyArray_DATA(pos_o));
  auto *edg = static_cast<const int64_t *>(PyArray_DATA(e_o));
  auto *E = static_cast<const double *>(PyArray_DATA(em_o));
  npy_intp dims[3] = {nv, dpv, dpv};
  PyArrayObject *o_d =
      (PyArrayObject *)PyArray_ZEROS(3, dims, NPY_FLOAT64, 0);
  auto *D = static_cast<double *>(PyArray_DATA(o_d));
  const int dd = dpv * dpv;
  double dvec[3], B[kMaxD * kMaxD];
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t i = edg[2 * e], j = edg[2 * e + 1];
    const double *Ee = E + e * dd;
    for (int k = 0; k < dim; ++k)  // mid - pos_i = (pos_j - pos_i)/2
      dvec[k] = 0.5 * (pos[j * dim + k] - pos[i * dim + k]);
    rigid_congruence(Ee, dvec, dim, dpv, s, B);
    double *Di = D + i * dd;
    for (int k = 0; k < dd; ++k) Di[k] += B[k];
    for (int k = 0; k < dim; ++k) dvec[k] = -dvec[k];  // mid - pos_j
    rigid_congruence(Ee, dvec, dim, dpv, s, B);
    double *Dj = D + j * dd;
    for (int k = 0; k < dd; ++k) Dj[k] += B[k];
  }
  return (PyObject *)o_d;
}

// bsr_mm(A_indptr i64 (nbr+1), A_indices i32, A_data (nnzA, bs, bs) f64,
//        B_indptr i64, B_indices i32, B_data (nnzB, bs, bs) f64,
//        n_col_blocks_B) -> (C_indptr i64, C_indices i32,
//        C_data (nnzC, bs, bs)): block-sparse Gustavson product C = A B
// with dense (bs x bs) GEMM accumulation per block pair — the block-
// entry SpMM of the reference's MatMultABImpl (utils_sparseMM.hpp:61)
// for the prolongation-smoothing products (scipy treats the same
// product as scalar CSR, ~bs^2 more index work).
PyObject *bsr_mm(PyObject *, PyObject *args) {
  PyArrayObject *aip_o, *aix_o, *ad_o, *bip_o, *bix_o, *bd_o;
  long long ncB;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!L", &PyArray_Type, &aip_o,
                        &PyArray_Type, &aix_o, &PyArray_Type, &ad_o,
                        &PyArray_Type, &bip_o, &PyArray_Type, &bix_o,
                        &PyArray_Type, &bd_o, &ncB))
    return nullptr;
  const int64_t nbr = PyArray_DIM(aip_o, 0) - 1;
  const int ra = (int)PyArray_DIM(ad_o, 1);   // A blocks (ra x ca)
  const int ca = (int)PyArray_DIM(ad_o, 2);
  const int cb = (int)PyArray_DIM(bd_o, 2);   // B blocks (ca x cb)
  if (ra > kMaxD || ca > kMaxD || cb > kMaxD ||
      (int)PyArray_DIM(bd_o, 1) != ca) {
    PyErr_SetString(PyExc_ValueError, "bsr_mm: bad block sizes");
    return nullptr;
  }
  auto *aip = static_cast<const int64_t *>(PyArray_DATA(aip_o));
  auto *aix = static_cast<const int32_t *>(PyArray_DATA(aix_o));
  auto *ad = static_cast<const double *>(PyArray_DATA(ad_o));
  auto *bip = static_cast<const int64_t *>(PyArray_DATA(bip_o));
  auto *bix = static_cast<const int32_t *>(PyArray_DATA(bix_o));
  auto *bd = static_cast<const double *>(PyArray_DATA(bd_o));
  const int dda = ra * ca, ddb = ca * cb, ddc = ra * cb;
  std::vector<int64_t> cptr(nbr + 1, 0);
  std::vector<int32_t> ccols;
  std::vector<double> cdata;
  ccols.reserve((size_t)PyArray_DIM(ad_o, 0));
  cdata.reserve((size_t)PyArray_DIM(ad_o, 0) * ddc);
  std::vector<int64_t> mark((size_t)ncB, -1);
  for (int64_t i = 0; i < nbr; ++i) {
    const int64_t row_start = (int64_t)ccols.size();
    for (int64_t e = aip[i]; e < aip[i + 1]; ++e) {
      const int64_t k = aix[e];
      const double *Ab = ad + e * dda;
      for (int64_t f = bip[k]; f < bip[k + 1]; ++f) {
        const int64_t j = bix[f];
        const double *Bb = bd + f * ddb;
        int64_t pos = mark[j];
        if (pos < row_start) {  // first touch of column j in this row
          pos = (int64_t)ccols.size();
          mark[j] = pos;
          ccols.push_back((int32_t)j);
          cdata.resize(cdata.size() + ddc, 0.0);
        }
        double *Cb = cdata.data() + pos * ddc;
        for (int r = 0; r < ra; ++r)
          for (int c = 0; c < cb; ++c) {
            double acc = 0.0;
            for (int t = 0; t < ca; ++t)
              acc += Ab[r * ca + t] * Bb[t * cb + c];
            Cb[r * cb + c] += acc;
          }
      }
    }
    // emit ascending-column rows (first-touch order is arbitrary;
    // downstream truncation/merging relies on sorted BSR)
    const int64_t row_len = (int64_t)ccols.size() - row_start;
    if (row_len > 1) {
      std::vector<std::pair<int32_t, int64_t>> ord;
      ord.reserve((size_t)row_len);
      for (int64_t k = 0; k < row_len; ++k)
        ord.emplace_back(ccols[(size_t)(row_start + k)], k);
      bool sorted = true;
      for (int64_t k = 1; k < row_len; ++k)
        if (ord[(size_t)k].first < ord[(size_t)(k - 1)].first) {
          sorted = false;
          break;
        }
      if (!sorted) {
        std::sort(ord.begin(), ord.end());
        std::vector<double> tmp(
            cdata.begin() + row_start * ddc,
            cdata.begin() + (row_start + row_len) * ddc);
        for (int64_t k = 0; k < row_len; ++k) {
          ccols[(size_t)(row_start + k)] = ord[(size_t)k].first;
          const int64_t src = ord[(size_t)k].second;
          std::copy(tmp.begin() + src * ddc,
                    tmp.begin() + (src + 1) * ddc,
                    cdata.begin() + (row_start + k) * ddc);
        }
      }
    }
    cptr[i + 1] = (int64_t)ccols.size();
  }
  npy_intp d1[1] = {nbr + 1};
  PyArrayObject *o_ip =
      (PyArrayObject *)PyArray_SimpleNew(1, d1, NPY_INT64);
  memcpy(PyArray_DATA(o_ip), cptr.data(), sizeof(int64_t) * (nbr + 1));
  npy_intp d2[1] = {(npy_intp)ccols.size()};
  PyArrayObject *o_ix =
      (PyArrayObject *)PyArray_SimpleNew(1, d2, NPY_INT32);
  memcpy(PyArray_DATA(o_ix), ccols.data(),
         sizeof(int32_t) * ccols.size());
  npy_intp d3[3] = {(npy_intp)ccols.size(), ra, cb};
  PyArrayObject *o_d =
      (PyArrayObject *)PyArray_SimpleNew(3, d3, NPY_FLOAT64);
  memcpy(PyArray_DATA(o_d), cdata.data(), sizeof(double) * cdata.size());
  return Py_BuildValue("(NNN)", o_ip, o_ix, o_d);
}

// elast_map_edge_mats(pos (nv,dim), cpos (nagg,dim), edges (me,2) i64,
// ce (me,) i64, cedges (nce,2) i64, E (me,dpv,dpv), s) ->
// Ec (nce,dpv,dpv): coarse edge matrices as Q-transported sums
// Ec[ce] += Q(m_c -> m_f)^T E_f Q(m_c -> m_f) over the mapped fine
// edges (apps/elasticity.map_data hot loop, the AttachedEED Q-transport
// accumulation) — fused, no (me,dpv,dpv) temporaries, accumulation in
// edge order (bitwise equal to the numpy scatter_add path).
PyObject *elast_map_edge_mats(PyObject *, PyObject *args) {
  PyArrayObject *pos_o, *cpos_o, *e_o, *ce_o, *cedg_o, *em_o;
  double s;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!d", &PyArray_Type, &pos_o,
                        &PyArray_Type, &cpos_o, &PyArray_Type, &e_o,
                        &PyArray_Type, &ce_o, &PyArray_Type, &cedg_o,
                        &PyArray_Type, &em_o, &s))
    return nullptr;
  const int dim = (int)PyArray_DIM(pos_o, 1);
  const int64_t me = PyArray_DIM(e_o, 0);
  const int64_t nce = PyArray_DIM(cedg_o, 0);
  const int dpv = (int)PyArray_DIM(em_o, 1);
  if (dpv > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *pos = static_cast<const double *>(PyArray_DATA(pos_o));
  auto *cpos = static_cast<const double *>(PyArray_DATA(cpos_o));
  auto *edg = static_cast<const int64_t *>(PyArray_DATA(e_o));
  auto *cei = static_cast<const int64_t *>(PyArray_DATA(ce_o));
  auto *cedg = static_cast<const int64_t *>(PyArray_DATA(cedg_o));
  auto *E = static_cast<const double *>(PyArray_DATA(em_o));
  npy_intp dims[3] = {nce, dpv, dpv};
  PyArrayObject *o_ec =
      (PyArrayObject *)PyArray_ZEROS(3, dims, NPY_FLOAT64, 0);
  auto *Ec = static_cast<double *>(PyArray_DATA(o_ec));
  const int dd = dpv * dpv;
  double dvec[3], B[kMaxD * kMaxD];
  for (int64_t t = 0; t < me; ++t) {
    const int64_t i = edg[2 * t], j = edg[2 * t + 1];
    const int64_t c = cei[t];
    const int64_t lo = cedg[2 * c], hi = cedg[2 * c + 1];
    for (int k = 0; k < dim; ++k) {
      const double midf = 0.5 * (pos[i * dim + k] + pos[j * dim + k]);
      const double midc =
          0.5 * (cpos[lo * dim + k] + cpos[hi * dim + k]);
      dvec[k] = midf - midc;  // Q(m_c -> m_f): d = to - from
    }
    rigid_congruence(E + t * dd, dvec, dim, dpv, s, B);
    double *out = Ec + c * dd;
    for (int k = 0; k < dd; ++k) out[k] += B[k];
  }
  return (PyObject *)o_ec;
}

// elast_soc_robust(pos, edges, E (ne,dpv,dpv), D (nv,dpv,dpv), s, tol,
// reduction) -> (ne,) f64: the full robust-SOC pipeline fused per edge —
// transport D[i], D[j] to the midpoint frame, series (harmonic) energy,
// extreme pencil eigenvalue (CalcRobustPairSOC, agglomerator_utils.hpp:
// 764-885). No O(ne * dpv^2) temporaries.
PyObject *elast_soc_robust(PyObject *, PyObject *args) {
  PyArrayObject *pos_o, *e_o, *em_o, *d_o;
  double s, tol;
  int reduction;
  if (!PyArg_ParseTuple(args, "O!O!O!O!ddi", &PyArray_Type, &pos_o,
                        &PyArray_Type, &e_o, &PyArray_Type, &em_o,
                        &PyArray_Type, &d_o, &s, &tol, &reduction))
    return nullptr;
  const int dim = (int)PyArray_DIM(pos_o, 1);
  const int64_t ne = PyArray_DIM(e_o, 0);
  const int dpv = (int)PyArray_DIM(em_o, 1);
  if (dpv > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *pos = static_cast<const double *>(PyArray_DATA(pos_o));
  auto *edg = static_cast<const int64_t *>(PyArray_DATA(e_o));
  auto *E = static_cast<const double *>(PyArray_DATA(em_o));
  auto *D = static_cast<const double *>(PyArray_DATA(d_o));
  npy_intp dims[1] = {ne};
  PyArrayObject *o_out =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  auto *out = static_cast<double *>(PyArray_DATA(o_out));
  const int dd = dpv * dpv;
  double dvec[3], di[kMaxD * kMaxD], dj[kMaxD * kMaxD], C[kMaxD * kMaxD];
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t i = edg[2 * e], j = edg[2 * e + 1];
    // Qmi = transport(mid -> pos_i): d = pos_i - mid = (pos_i - pos_j)/2
    for (int k = 0; k < dim; ++k)
      dvec[k] = 0.5 * (pos[i * dim + k] - pos[j * dim + k]);
    rigid_congruence(D + i * dd, dvec, dim, dpv, s, di);
    for (int k = 0; k < dim; ++k) dvec[k] = -dvec[k];
    rigid_congruence(D + j * dd, dvec, dim, dpv, s, dj);
    harmonic_one(di, dj, dpv, 1e-12, C);
    out[e] = pencil_one(E + e * dd, C, dpv, tol, reduction);
  }
  return (PyObject *)o_out;
}

// pencil_extreme_eig(E (ne,d,d) f64, C (ne,d,d) f64, tol, reduction
// 0=min|1=max) -> (ne,) f64: extreme eigenvalue of pencil (E, C)
// restricted to range(C), clamped at 0 (null C -> 0).
PyObject *pencil_extreme_eig_native(PyObject *, PyObject *args) {
  PyArrayObject *e_o, *c_o;
  double tol;
  int reduction;
  if (!PyArg_ParseTuple(args, "O!O!di", &PyArray_Type, &e_o, &PyArray_Type,
                        &c_o, &tol, &reduction))
    return nullptr;
  const int64_t ne = PyArray_DIM(e_o, 0);
  const int d = (int)PyArray_DIM(e_o, 1);
  if (d > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *E = static_cast<const double *>(PyArray_DATA(e_o));
  auto *C = static_cast<const double *>(PyArray_DATA(c_o));
  npy_intp dims[1] = {ne};
  PyArrayObject *o_out =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  auto *out = static_cast<double *>(PyArray_DATA(o_out));
  const int dd = d * d;
  for (int64_t e = 0; e < ne; ++e)
    out[e] = pencil_one(E + e * dd, C + e * dd, d, tol, reduction);
  return (PyObject *)o_out;
}

// harmonic_mean_sym(A (ne,d,d) f64, B (ne,d,d) f64, rcond) -> (ne,d,d):
// symmetrized series energy A (A+B)^+ B (the SOC C-matrix and the
// neighbor-boost leg energy, agglomerator_utils.hpp:600-885).
PyObject *harmonic_mean_sym(PyObject *, PyObject *args) {
  PyArrayObject *a_o, *b_o;
  double rcond;
  if (!PyArg_ParseTuple(args, "O!O!d", &PyArray_Type, &a_o, &PyArray_Type,
                        &b_o, &rcond))
    return nullptr;
  const int64_t ne = PyArray_DIM(a_o, 0);
  const int d = (int)PyArray_DIM(a_o, 1);
  if (d > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *A = static_cast<const double *>(PyArray_DATA(a_o));
  auto *B = static_cast<const double *>(PyArray_DATA(b_o));
  npy_intp dims[3] = {ne, d, d};
  PyArrayObject *o_out =
      (PyArrayObject *)PyArray_SimpleNew(3, dims, NPY_FLOAT64);
  auto *out = static_cast<double *>(PyArray_DATA(o_out));
  const int dd = d * d;
  for (int64_t e = 0; e < ne; ++e)
    harmonic_one(A + e * dd, B + e * dd, d, rcond, out + e * dd);
  return (PyObject *)o_out;
}

// csr_sym_scale(indptr, indices, data f64, s f64[n]) -> data' (new array)
// with data'[k] = data[k] * s[row(k)] * s[col(k)] — one fused pass (the
// numpy route materializes an O(nnz) row-expansion first).
PyObject *csr_sym_scale(PyObject *, PyObject *args) {
  PyArrayObject *ai_o, *aj_o, *av_o, *s_o;
  if (!PyArg_ParseTuple(args, "O!O!O!O!", &PyArray_Type, &ai_o,
                        &PyArray_Type, &aj_o, &PyArray_Type, &av_o,
                        &PyArray_Type, &s_o))
    return nullptr;
  const int64_t n = PyArray_DIM(ai_o, 0) - 1;
  const int64_t nnz = PyArray_DIM(av_o, 0);
  auto *av = static_cast<const double *>(PyArray_DATA(av_o));
  auto *s = static_cast<const double *>(PyArray_DATA(s_o));
  npy_intp dims[1] = {nnz};
  PyArrayObject *o_out =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  auto *out = static_cast<double *>(PyArray_DATA(o_out));
  return dispatch_index(ai_o, [&](auto ix) -> PyObject * {
    using I = decltype(ix);
    auto *ai = static_cast<const I *>(PyArray_DATA(ai_o));
    auto *aj = static_cast<const I *>(PyArray_DATA(aj_o));
    for (int64_t r = 0; r < n; ++r) {
      const double sr = s[r];
      for (I k = ai[r]; k < ai[r + 1]; ++k)
        out[k] = av[k] * sr * s[aj[k]];
    }
    return (PyObject *)o_out;
  });
}

// ---------------------------------------------------------------------
// rap_bsr(A_indptr i64, A_indices i32, A_data (nnzA, br, br) f64,
//         P_indptr i64, P_indices i32, P_data (nnzP, br, bc) f64,
//         ncb, symmetrize) -> (C_indptr i64, C_indices i32,
//         C_data (nnzC, bc, bc) f64)
//
// Fused block-entry Galerkin triple product C = P^T A P — the
// per-block-size `RestrictMatrix` instantiations of the reference
// (utils_sparseMM.hpp:94-108) as ONE conversion-free kernel: block
// Gustavson AP = A@P with a dense per-row block accumulator, P^T by
// counting sort, second block Gustavson, and (C + C^T)/2 in-kernel
// (mirror blocks averaged with their transposes). ~br*bc less index
// work than the scalar rap_csr on block-energy levels, and no
// CSR<->BSR conversions around it (the composed scipy route measured
// 67 s vs 38.7 s scalar at 1.25M-DoF elasticity; this kernel replaces
// both).
// ---------------------------------------------------------------------
PyObject *rap_bsr(PyObject *, PyObject *args) {
  PyArrayObject *aip_o, *aix_o, *ad_o, *pip_o, *pix_o, *pd_o;
  long long ncb_l;
  int symmetrize = 1;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!L|i", &PyArray_Type, &aip_o,
                        &PyArray_Type, &aix_o, &PyArray_Type, &ad_o,
                        &PyArray_Type, &pip_o, &PyArray_Type, &pix_o,
                        &PyArray_Type, &pd_o, &ncb_l, &symmetrize))
    return nullptr;
  const int64_t n = PyArray_DIM(aip_o, 0) - 1;   // fine block rows
  const int64_t nc = (int64_t)ncb_l;             // coarse block rows
  const int br = (int)PyArray_DIM(ad_o, 1);
  const int bc = (int)PyArray_DIM(pd_o, 2);
  if (br > kMaxD || bc > kMaxD || (int)PyArray_DIM(ad_o, 2) != br ||
      (int)PyArray_DIM(pd_o, 1) != br) {
    PyErr_SetString(PyExc_ValueError, "rap_bsr: bad block sizes");
    return nullptr;
  }
  auto *aip = static_cast<const int64_t *>(PyArray_DATA(aip_o));
  auto *aix = static_cast<const int32_t *>(PyArray_DATA(aix_o));
  auto *ad = static_cast<const double *>(PyArray_DATA(ad_o));
  auto *pip = static_cast<const int64_t *>(PyArray_DATA(pip_o));
  auto *pix = static_cast<const int32_t *>(PyArray_DATA(pix_o));
  auto *pd = static_cast<const double *>(PyArray_DATA(pd_o));
  const int dda = br * br, ddp = br * bc, ddc = bc * bc;

  // ---- pass 1: AP = A @ P  (block rows, (br x bc) blocks) -------------
  std::vector<int64_t> ap_ptr(n + 1, 0);
  std::vector<int32_t> ap_col;
  std::vector<double> ap_val;
  ap_col.reserve((size_t)(2 * aip[n]));
  ap_val.reserve((size_t)(2 * aip[n]) * ddp);
  {
    std::vector<int64_t> mark((size_t)nc, -1);
    std::vector<int32_t> touched;
    std::vector<double> rowbuf;  // compact per-row block accumulators
    std::vector<int64_t> slot((size_t)nc, 0);
    for (int64_t i = 0; i < n; ++i) {
      touched.clear();
      rowbuf.clear();
      for (int64_t e = aip[i]; e < aip[i + 1]; ++e) {
        const int64_t j = aix[e];
        const double *Ab = ad + e * dda;
        for (int64_t f = pip[j]; f < pip[j + 1]; ++f) {
          const int32_t c = pix[f];
          const double *Pb = pd + f * ddp;
          int64_t sl = (mark[c] == i) ? slot[c] : -1;
          if (sl < 0) {
            mark[c] = i;
            sl = (int64_t)touched.size();
            slot[c] = sl;
            touched.push_back(c);
            rowbuf.resize(rowbuf.size() + ddp, 0.0);
          }
          double *Cb = rowbuf.data() + sl * ddp;
          for (int r = 0; r < br; ++r)
            for (int cq = 0; cq < bc; ++cq) {
              double acc = 0.0;
              for (int t = 0; t < br; ++t)
                acc += Ab[r * br + t] * Pb[t * bc + cq];
              Cb[r * bc + cq] += acc;
            }
        }
      }
      // emit in ascending column order (deterministic, sorted rows)
      std::vector<int32_t> ord(touched);
      std::sort(ord.begin(), ord.end());
      for (int32_t c : ord) {
        const double *Cb = rowbuf.data() + slot[c] * ddp;
        bool nz = false;
        for (int k = 0; k < ddp; ++k)
          if (Cb[k] != 0.0) { nz = true; break; }
        if (!nz) continue;  // prune exact-zero blocks
        ap_col.push_back(c);
        ap_val.insert(ap_val.end(), Cb, Cb + ddp);
      }
      ap_ptr[i + 1] = (int64_t)ap_col.size();
    }
  }

  // ---- transpose P (counting sort; blocks transposed to (bc x br)) ----
  const int64_t pnnz = pip[n];
  std::vector<int64_t> pt_ptr(nc + 1, 0);
  std::vector<int32_t> pt_row(pnnz);
  std::vector<double> pt_val((size_t)pnnz * ddp);
  for (int64_t k = 0; k < pnnz; ++k) pt_ptr[pix[k] + 1]++;
  for (int64_t c = 0; c < nc; ++c) pt_ptr[c + 1] += pt_ptr[c];
  {
    std::vector<int64_t> cur(pt_ptr.begin(), pt_ptr.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      for (int64_t k = pip[i]; k < pip[i + 1]; ++k) {
        const int64_t dst = cur[pix[k]]++;
        pt_row[dst] = (int32_t)i;
        const double *src = pd + k * ddp;
        double *dstb = pt_val.data() + dst * ddp;  // (bc x br) transposed
        for (int r = 0; r < br; ++r)
          for (int cq = 0; cq < bc; ++cq)
            dstb[cq * br + r] = src[r * bc + cq];
      }
  }

  // ---- pass 2: C = P^T @ AP  ((bc x bc) blocks) -----------------------
  std::vector<int64_t> c_ptr(nc + 1, 0);
  std::vector<int32_t> c_col;
  std::vector<double> c_val;
  c_col.reserve((size_t)pnnz);
  c_val.reserve((size_t)pnnz * ddc);
  {
    std::vector<int64_t> mark((size_t)nc, -1);
    std::vector<int32_t> touched;
    std::vector<double> rowbuf;
    std::vector<int64_t> slot((size_t)nc, 0);
    for (int64_t r = 0; r < nc; ++r) {
      touched.clear();
      rowbuf.clear();
      for (int64_t k = pt_ptr[r]; k < pt_ptr[r + 1]; ++k) {
        const int32_t i = pt_row[k];
        const double *Ptb = pt_val.data() + k * ddp;  // (bc x br)
        for (int64_t l = ap_ptr[i]; l < ap_ptr[i + 1]; ++l) {
          const int32_t c = ap_col[l];
          const double *APb = ap_val.data() + l * ddp;  // (br x bc)
          int64_t sl = (mark[c] == r) ? slot[c] : -1;
          if (sl < 0) {
            mark[c] = r;
            sl = (int64_t)touched.size();
            slot[c] = sl;
            touched.push_back(c);
            rowbuf.resize(rowbuf.size() + ddc, 0.0);
          }
          double *Cb = rowbuf.data() + sl * ddc;
          for (int rr = 0; rr < bc; ++rr)
            for (int cq = 0; cq < bc; ++cq) {
              double acc = 0.0;
              for (int t = 0; t < br; ++t)
                acc += Ptb[rr * br + t] * APb[t * bc + cq];
              Cb[rr * bc + cq] += acc;
            }
        }
      }
      std::vector<int32_t> ord(touched);
      std::sort(ord.begin(), ord.end());
      for (int32_t c : ord) {
        const double *Cb = rowbuf.data() + slot[c] * ddc;
        bool nz = false;
        for (int k = 0; k < ddc; ++k)
          if (Cb[k] != 0.0) { nz = true; break; }
        if (!nz) continue;
        c_col.push_back(c);
        c_val.insert(c_val.end(), Cb, Cb + ddc);
      }
      c_ptr[r + 1] = (int64_t)c_col.size();
    }
  }

  if (symmetrize) {
    // (C + C^T)/2 block-wise in place: upper block (r,c) averages with
    // the TRANSPOSE of its mirror (c,r); structurally-missing mirrors
    // are skipped (pruned exact-zero blocks)
    for (int64_t r = 0; r < nc; ++r)
      for (int64_t k = c_ptr[r]; k < c_ptr[r + 1]; ++k) {
        const int32_t c = c_col[k];
        if (c < r) continue;
        if (c == (int32_t)r) {  // diagonal block: Bd = (Bd + Bd^T)/2
          double *B = c_val.data() + k * ddc;
          for (int rr = 0; rr < bc; ++rr)
            for (int cq = rr + 1; cq < bc; ++cq) {
              const double avg =
                  0.5 * (B[rr * bc + cq] + B[cq * bc + rr]);
              B[rr * bc + cq] = avg;
              B[cq * bc + rr] = avg;
            }
          continue;
        }
        const int32_t *lo = c_col.data() + c_ptr[c];
        const int32_t *hi = c_col.data() + c_ptr[c + 1];
        const int32_t *it = std::lower_bound(lo, hi, (int32_t)r);
        if (it != hi && *it == (int32_t)r) {
          const int64_t km = it - c_col.data();
          double *Bu = c_val.data() + k * ddc;
          double *Bl = c_val.data() + km * ddc;
          for (int rr = 0; rr < bc; ++rr)
            for (int cq = 0; cq < bc; ++cq) {
              const double avg =
                  0.5 * (Bu[rr * bc + cq] + Bl[cq * bc + rr]);
              Bu[rr * bc + cq] = avg;
              Bl[cq * bc + rr] = avg;
            }
        }
      }
  }

  npy_intp d1[1] = {nc + 1};
  PyArrayObject *o_ip =
      (PyArrayObject *)PyArray_SimpleNew(1, d1, NPY_INT64);
  memcpy(PyArray_DATA(o_ip), c_ptr.data(), sizeof(int64_t) * (nc + 1));
  npy_intp d2[1] = {(npy_intp)c_col.size()};
  PyArrayObject *o_ix =
      (PyArrayObject *)PyArray_SimpleNew(1, d2, NPY_INT32);
  memcpy(PyArray_DATA(o_ix), c_col.data(),
         sizeof(int32_t) * c_col.size());
  npy_intp d3[3] = {(npy_intp)c_col.size(), bc, bc};
  PyArrayObject *o_d =
      (PyArrayObject *)PyArray_SimpleNew(3, d3, NPY_FLOAT64);
  memcpy(PyArray_DATA(o_d), c_val.data(), sizeof(double) * c_val.size());
  return Py_BuildValue("(NNN)", o_ip, o_ix, o_d);
}

// ---------------------------------------------------------------------
// bsr_smooth_update(A_indptr i64, A_indices i32, A_data (nnzA,d,d) f64,
//                   P_indptr i64, P_indices i32, P_data (nnzP,d,d) f64,
//                   Dinv (n,d,d) f64, scale, ncb)
//   -> (C_indptr i64, C_indices i32, C_data (nnzC,d,d) f64)
//
// One-pass damped-Jacobi prolongation smoothing
//     C = P_pw - scale * Dinv (A-hat @ P_pw)
// (transfer/prolongation.smoothed_prol's block path): block Gustavson
// per row with the Dinv premultiply, (-scale) damping, and the
// piecewise block added at its column — fused, sorted rows, no
// (nnz, d, d) host temporaries (the numpy composition moved ~3 GB per
// 1.25M-DoF elasticity level at this host's first-touch fault rate).
// ---------------------------------------------------------------------
PyObject *bsr_smooth_update(PyObject *, PyObject *args) {
  PyArrayObject *aip_o, *aix_o, *ad_o, *pip_o, *pix_o, *pd_o, *di_o;
  double scale;
  long long ncb_l;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!O!dL", &PyArray_Type, &aip_o,
                        &PyArray_Type, &aix_o, &PyArray_Type, &ad_o,
                        &PyArray_Type, &pip_o, &PyArray_Type, &pix_o,
                        &PyArray_Type, &pd_o, &PyArray_Type, &di_o,
                        &scale, &ncb_l))
    return nullptr;
  const int64_t n = PyArray_DIM(aip_o, 0) - 1;
  const int64_t nc = (int64_t)ncb_l;
  const int d = (int)PyArray_DIM(ad_o, 1);
  if (d > kMaxD || (int)PyArray_DIM(pd_o, 1) != d ||
      (int)PyArray_DIM(pd_o, 2) != d || (int)PyArray_DIM(di_o, 1) != d) {
    PyErr_SetString(PyExc_ValueError, "bsr_smooth_update: bad blocks");
    return nullptr;
  }
  auto *aip = static_cast<const int64_t *>(PyArray_DATA(aip_o));
  auto *aix = static_cast<const int32_t *>(PyArray_DATA(aix_o));
  auto *ad = static_cast<const double *>(PyArray_DATA(ad_o));
  auto *pip = static_cast<const int64_t *>(PyArray_DATA(pip_o));
  auto *pix = static_cast<const int32_t *>(PyArray_DATA(pix_o));
  auto *pd = static_cast<const double *>(PyArray_DATA(pd_o));
  auto *dinv = static_cast<const double *>(PyArray_DATA(di_o));
  const int dd = d * d;

  std::vector<int64_t> c_ptr(n + 1, 0);
  std::vector<int32_t> c_col;
  std::vector<double> c_val;
  c_col.reserve((size_t)(4 * aip[n] / 3));
  c_val.reserve((size_t)(4 * aip[n] / 3) * dd);
  std::vector<int64_t> mark((size_t)nc, -1);
  std::vector<int64_t> slot((size_t)nc, 0);
  std::vector<int32_t> touched;
  std::vector<double> rowbuf;
  double tmp[kMaxD * kMaxD];
  for (int64_t i = 0; i < n; ++i) {
    touched.clear();
    rowbuf.clear();
    for (int64_t e = aip[i]; e < aip[i + 1]; ++e) {
      const int64_t j = aix[e];
      const double *Ab = ad + e * dd;
      for (int64_t f = pip[j]; f < pip[j + 1]; ++f) {
        const int32_t c = pix[f];
        const double *Pb = pd + f * dd;
        int64_t sl = (mark[c] == i) ? slot[c] : -1;
        if (sl < 0) {
          mark[c] = i;
          sl = (int64_t)touched.size();
          slot[c] = sl;
          touched.push_back(c);
          rowbuf.resize(rowbuf.size() + dd, 0.0);
        }
        double *Cb = rowbuf.data() + sl * dd;
        for (int r = 0; r < d; ++r)
          for (int cq = 0; cq < d; ++cq) {
            double acc = 0.0;
            for (int t = 0; t < d; ++t)
              acc += Ab[r * d + t] * Pb[t * d + cq];
            Cb[r * d + cq] += acc;
          }
      }
    }
    std::vector<int32_t> ord(touched);
    std::sort(ord.begin(), ord.end());
    const double *Di = dinv + i * dd;
    // the (single) piecewise block of this row, if any
    const int32_t pwc = (pip[i + 1] > pip[i]) ? pix[pip[i]] : -1;
    const double *pwb = (pwc >= 0) ? pd + pip[i] * dd : nullptr;
    for (int32_t c : ord) {
      const double *Tb = rowbuf.data() + slot[c] * dd;
      // tmp = Dinv[i] @ T, out = (-scale) * tmp [+ pw]
      for (int r = 0; r < d; ++r)
        for (int cq = 0; cq < d; ++cq) {
          double acc = 0.0;
          for (int t = 0; t < d; ++t)
            acc += Di[r * d + t] * Tb[t * d + cq];
          tmp[r * d + cq] = acc;
        }
      c_col.push_back(c);
      const size_t base = c_val.size();
      c_val.resize(base + dd);
      double *out = c_val.data() + base;
      const double ns = -scale;
      if (c == pwc) {
        for (int t = 0; t < dd; ++t) out[t] = ns * tmp[t] + pwb[t];
      } else {
        for (int t = 0; t < dd; ++t) out[t] = ns * tmp[t];
      }
    }
    c_ptr[i + 1] = (int64_t)c_col.size();
  }

  npy_intp d1[1] = {n + 1};
  PyArrayObject *o_ip =
      (PyArrayObject *)PyArray_SimpleNew(1, d1, NPY_INT64);
  memcpy(PyArray_DATA(o_ip), c_ptr.data(), sizeof(int64_t) * (n + 1));
  npy_intp d2[1] = {(npy_intp)c_col.size()};
  PyArrayObject *o_ix =
      (PyArrayObject *)PyArray_SimpleNew(1, d2, NPY_INT32);
  memcpy(PyArray_DATA(o_ix), c_col.data(),
         sizeof(int32_t) * c_col.size());
  npy_intp d3[3] = {(npy_intp)c_col.size(), d, d};
  PyArrayObject *o_d =
      (PyArrayObject *)PyArray_SimpleNew(3, d3, NPY_FLOAT64);
  memcpy(PyArray_DATA(o_d), c_val.data(), sizeof(double) * c_val.size());
  return Py_BuildValue("(NNN)", o_ip, o_ix, o_d);
}

// ---------------------------------------------------------------------
// truncate_prol_blocks(indptr i64, indices i32, data (nnzb, d, d) f64,
//                      pos_c (ncb, dim) f64 | None, s, max_per_row,
//                      min_frac) -> (indptr i64, indices i32, data f64)
//
// Fan-out-bounded kernel-preserving prolongation truncation — the
// native form of transfer/prolongation.truncate_prol for block rows:
// per block row keep the (up to) max_per_row strongest blocks by
// Frobenius norm that clear min_frac * strongest, and TRANSPORT every
// dropped block B onto the strongest kept column c0 as B @ Q(c0 -> cd)
// (rigid-body Q when pos_c is given, identity otherwise) — exact
// kernel/RBM preservation. Magnitudes are quantized to 40 fractional
// bits before ranking, matching the numpy path bit for bit (ties keep
// ascending-column order). Replaces the padded-array numpy pipeline
// (measured 55 s of the 1.25M-DoF elasticity setup).
// ---------------------------------------------------------------------
PyObject *truncate_prol_blocks(PyObject *, PyObject *args) {
  PyArrayObject *ip_o, *ix_o, *d_o;
  PyObject *pos_obj;
  double s, min_frac;
  long mpr_l;
  if (!PyArg_ParseTuple(args, "O!O!O!Odld", &PyArray_Type, &ip_o,
                        &PyArray_Type, &ix_o, &PyArray_Type, &d_o,
                        &pos_obj, &s, &mpr_l, &min_frac))
    return nullptr;
  const int64_t n = PyArray_DIM(ip_o, 0) - 1;
  const int d = (int)PyArray_DIM(d_o, 1);
  if (d > kMaxD || (int)PyArray_DIM(d_o, 2) != d) {
    PyErr_SetString(PyExc_ValueError, "truncate_prol_blocks: bad block");
    return nullptr;
  }
  const bool rigid = pos_obj != Py_None;
  const double *pos = nullptr;
  int dim = 0;
  if (rigid) {
    PyArrayObject *pos_o = (PyArrayObject *)pos_obj;
    pos = static_cast<const double *>(PyArray_DATA(pos_o));
    dim = (int)PyArray_DIM(pos_o, 1);
  }
  auto *ip = static_cast<const int64_t *>(PyArray_DATA(ip_o));
  auto *ix = static_cast<const int32_t *>(PyArray_DATA(ix_o));
  const int64_t nnzb = ip[n];
  // work on a copy of the blocks (drop accumulation mutates slot0)
  std::vector<double> data(
      static_cast<const double *>(PyArray_DATA(d_o)),
      static_cast<const double *>(PyArray_DATA(d_o)) + nnzb * d * d);
  const int dd = d * d;
  const int64_t mpr = (int64_t)mpr_l;
  const double Q40 = 1099511627776.0;  // 2^40
  const double qthr = std::floor(min_frac * Q40 + 0.5);

  std::vector<int64_t> out_ptr(n + 1, 0);
  std::vector<int32_t> out_col;
  std::vector<double> out_val;
  out_col.reserve((size_t)nnzb);
  out_val.reserve((size_t)std::min<int64_t>(nnzb, n * mpr) * dd);

  std::vector<double> q;
  std::vector<int64_t> order;
  std::vector<char> keep;
  double Qm[kMaxD * kMaxD], add[kMaxD * kMaxD], dvec[3];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = ip[i], hi = ip[i + 1];
    const int64_t m = hi - lo;
    if (m == 0) { out_ptr[i + 1] = (int64_t)out_col.size(); continue; }
    q.resize((size_t)m);
    double rowmax = 0.0;
    for (int64_t k = 0; k < m; ++k) {
      const double *B = data.data() + (lo + k) * dd;
      double sq = 0.0;
      for (int t = 0; t < dd; ++t) sq += B[t] * B[t];
      const double nrm = std::sqrt(sq);
      q[(size_t)k] = nrm;
      if (nrm > rowmax) rowmax = nrm;
    }
    const double qs =
        rowmax > 0.0 ? Q40 / std::max(rowmax, 1e-300) : 0.0;
    for (int64_t k = 0; k < m; ++k)
      q[(size_t)k] = std::floor(std::max(q[(size_t)k], 0.0) * qs + 0.5);
    // stable descending order by quantized magnitude (ties: slot order)
    order.resize((size_t)m);
    for (int64_t k = 0; k < m; ++k) order[(size_t)k] = k;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                       return q[(size_t)a] > q[(size_t)b];
                     });
    keep.assign((size_t)m, 0);
    for (int64_t rkn = 0; rkn < m; ++rkn) {
      const int64_t k = order[(size_t)rkn];
      if (rkn == 0 || (rkn < mpr && q[(size_t)k] >= qthr))
        keep[(size_t)k] = 1;
    }
    const int64_t slot0 = order[0];
    const int32_t c0 = ix[lo + slot0];
    // transported drop accumulation, ascending slot order (np.add.at)
    for (int64_t k = 0; k < m; ++k) {
      if (keep[(size_t)k]) continue;
      const double *B = data.data() + (lo + k) * dd;
      double *D0 = data.data() + (lo + slot0) * dd;
      if (rigid) {
        const int32_t cd = ix[lo + k];
        for (int t = 0; t < dim; ++t)
          dvec[t] = pos[cd * dim + t] - pos[c0 * dim + t];
        rigid_q(dvec, dim, d, s, Qm);
        for (int r = 0; r < d; ++r)
          for (int c = 0; c < d; ++c) {
            double acc = 0.0;
            for (int t = 0; t < d; ++t)
              acc += B[r * d + t] * Qm[t * d + c];
            add[r * d + c] = acc;
          }
        for (int t = 0; t < dd; ++t) D0[t] += add[t];
      } else {
        for (int t = 0; t < dd; ++t) D0[t] += B[t];
      }
    }
    for (int64_t k = 0; k < m; ++k) {
      if (!keep[(size_t)k]) continue;
      out_col.push_back(ix[lo + k]);
      const double *B = data.data() + (lo + k) * dd;
      out_val.insert(out_val.end(), B, B + dd);
    }
    out_ptr[i + 1] = (int64_t)out_col.size();
  }

  npy_intp d1[1] = {n + 1};
  PyArrayObject *o_ip =
      (PyArrayObject *)PyArray_SimpleNew(1, d1, NPY_INT64);
  memcpy(PyArray_DATA(o_ip), out_ptr.data(), sizeof(int64_t) * (n + 1));
  npy_intp d2[1] = {(npy_intp)out_col.size()};
  PyArrayObject *o_ix =
      (PyArrayObject *)PyArray_SimpleNew(1, d2, NPY_INT32);
  memcpy(PyArray_DATA(o_ix), out_col.data(),
         sizeof(int32_t) * out_col.size());
  npy_intp d3[3] = {(npy_intp)out_col.size(), d, d};
  PyArrayObject *o_d =
      (PyArrayObject *)PyArray_SimpleNew(3, d3, NPY_FLOAT64);
  memcpy(PyArray_DATA(o_d), out_val.data(),
         sizeof(double) * out_val.size());
  return Py_BuildValue("(NNN)", o_ip, o_ix, o_d);
}

// ---------------------------------------------------------------------
// elast_ahat_bsr(pos (nv,dim) f64, edges (ne,2) i64, E (ne,dpv,dpv) f64,
//                s, l2 (nv,) f64)
//   -> (indptr i64, indices i32, data (nnzb, dpv, dpv) f64)
//
// Fully fused replacement-matrix (A-hat) assembly: per edge the four
// rigid-transported blocks (rigid_edge_blocks) scatter straight into
// the sorted-BSR output, the l2/Dirichlet vertex weights land on the
// displacement diagonal — no (ne, dpv, dpv) block temporaries (the
// separate rigid_edge_blocks + bsr_from_edge_blocks pipeline moved
// ~3 GB of intermediates at 2.7M edges; reference AssembleAhatSparse,
// aux_mat.hpp). Accumulation order matches bsr_from_edge_blocks
// (diagonal first, then edges in order) for bitwise parity.
// ---------------------------------------------------------------------
PyObject *elast_ahat_bsr(PyObject *, PyObject *args) {
  PyArrayObject *pos_o, *e_o, *em_o, *l2_o;
  double s;
  if (!PyArg_ParseTuple(args, "O!O!O!dO!", &PyArray_Type, &pos_o,
                        &PyArray_Type, &e_o, &PyArray_Type, &em_o, &s,
                        &PyArray_Type, &l2_o))
    return nullptr;
  const int64_t nv = PyArray_DIM(pos_o, 0);
  const int dim = (int)PyArray_DIM(pos_o, 1);
  const int64_t ne = PyArray_DIM(e_o, 0);
  const int dpv = (int)PyArray_DIM(em_o, 1);
  if (dpv > kMaxD) {
    PyErr_SetString(PyExc_ValueError, "block size > 8");
    return nullptr;
  }
  auto *pos = static_cast<const double *>(PyArray_DATA(pos_o));
  auto *edg = static_cast<const int64_t *>(PyArray_DATA(e_o));
  auto *E = static_cast<const double *>(PyArray_DATA(em_o));
  auto *l2 = static_cast<const double *>(PyArray_DATA(l2_o));
  const int dd = dpv * dpv;

  npy_intp d_ptr[1] = {nv + 1};
  PyArrayObject *o_ptr =
      (PyArrayObject *)PyArray_SimpleNew(1, d_ptr, NPY_INT64);
  auto *ptr = static_cast<int64_t *>(PyArray_DATA(o_ptr));
  std::fill(ptr, ptr + nv + 1, (int64_t)0);
  for (int64_t e = 0; e < ne; ++e) {
    ptr[edg[2 * e] + 1]++;
    ptr[edg[2 * e + 1] + 1]++;
  }
  for (int64_t v = 0; v < nv; ++v) ptr[v + 1] += ptr[v] + 1;  // +diag
  const int64_t nnzb = ptr[nv];
  npy_intp d_col[1] = {nnzb};
  npy_intp d_blk[3] = {nnzb, dpv, dpv};
  PyArrayObject *o_col =
      (PyArrayObject *)PyArray_SimpleNew(1, d_col, NPY_INT32);
  PyArrayObject *o_blk =
      (PyArrayObject *)PyArray_ZEROS(3, d_blk, NPY_FLOAT64, 0);
  auto *col = static_cast<int32_t *>(PyArray_DATA(o_col));
  auto *blk = static_cast<double *>(PyArray_DATA(o_blk));

  // diagonal placed first (l2 weight on displacement entries)
  std::vector<int64_t> cur(nv);
  for (int64_t v = 0; v < nv; ++v) {
    col[ptr[v]] = (int32_t)v;
    double *B = blk + ptr[v] * dd;
    for (int k = 0; k < dim; ++k) B[k * dpv + k] = l2[v];
    cur[(size_t)v] = ptr[v] + 1;
  }
  double dvec[3], Qi[kMaxD * kMaxD], Qj[kMaxD * kMaxD];
  double T1[kMaxD * kMaxD], T2[kMaxD * kMaxD];
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t i = edg[2 * e], j = edg[2 * e + 1];
    const double *Ee = E + e * dd;
    for (int k = 0; k < dim; ++k)
      dvec[k] = 0.5 * (pos[j * dim + k] - pos[i * dim + k]);  // mid - i
    rigid_q(dvec, dim, dpv, s, Qi);
    for (int k = 0; k < dim; ++k) dvec[k] = -dvec[k];  // mid - j
    rigid_q(dvec, dim, dpv, s, Qj);
    for (int r = 0; r < dpv; ++r)  // T1 = E Qi, T2 = E Qj
      for (int c = 0; c < dpv; ++c) {
        double a1 = 0.0, a2 = 0.0;
        for (int k = 0; k < dpv; ++k) {
          const double erk = Ee[r * dpv + k];
          a1 += erk * Qi[k * dpv + c];
          a2 += erk * Qj[k * dpv + c];
        }
        T1[r * dpv + c] = a1;
        T2[r * dpv + c] = a2;
      }
    int64_t qo = cur[(size_t)i]++;
    col[qo] = (int32_t)j;
    double *pij = blk + qo * dd;
    qo = cur[(size_t)j]++;
    col[qo] = (int32_t)i;
    double *pji = blk + qo * dd;
    double *di = blk + ptr[i] * dd;
    double *dj = blk + ptr[j] * dd;
    for (int r = 0; r < dpv; ++r)
      for (int c = 0; c < dpv; ++c) {
        double aii = 0.0, aij = 0.0, ajj = 0.0;
        for (int k = 0; k < dpv; ++k) {
          aii += Qi[k * dpv + r] * T1[k * dpv + c];
          aij += Qi[k * dpv + r] * T2[k * dpv + c];
          ajj += Qj[k * dpv + r] * T2[k * dpv + c];
        }
        di[r * dpv + c] += aii;
        dj[r * dpv + c] += ajj;
        pij[r * dpv + c] = -aij;
      }
    for (int r = 0; r < dpv; ++r)
      for (int c = 0; c < dpv; ++c)
        pji[r * dpv + c] = pij[c * dpv + r];
  }
  // ascending-column rows (diag placed first -> sort each row)
  std::vector<std::pair<int32_t, int64_t>> ord;
  std::vector<double> tmp;
  for (int64_t v = 0; v < nv; ++v) {
    const int64_t lo = ptr[v], hi = ptr[v + 1];
    bool sorted = true;
    for (int64_t k = lo + 1; k < hi; ++k)
      if (col[k] < col[k - 1]) { sorted = false; break; }
    if (sorted) continue;
    ord.clear();
    for (int64_t k = lo; k < hi; ++k) ord.emplace_back(col[k], k);
    std::sort(ord.begin(), ord.end());
    tmp.assign(blk + lo * dd, blk + hi * dd);
    for (int64_t k = lo; k < hi; ++k) {
      col[k] = ord[(size_t)(k - lo)].first;
      const int64_t src = ord[(size_t)(k - lo)].second - lo;
      std::copy(tmp.begin() + src * dd, tmp.begin() + (src + 1) * dd,
                blk + k * dd);
    }
  }
  return Py_BuildValue("(NNN)", o_ptr, o_col, o_blk);
}

// ---------------------------------------------------------------------
// rho_power(indptr, indices, data (scalar f64[nnz] OR blocks
//           f64[nnzb,br,bc]), dinv (nb, d, d) f64, x0 f64[n*? scalar
//           rows], iters) -> float
//
// Power-iteration estimate of rho(D^-1 A) with D block-diagonal — the
// native form of transfer/prolongation._rho_estimate and
// smoothers/build._lam_max_estimate (98 scipy matvecs, 13.5 s at
// 1.25M-DoF elasticity): y = A x (scalar-CSR or BSR matvec), x =
// blockwise Dinv y, lam = ||x||, x /= lam. The 2-norm uses pairwise
// summation like numpy (rho feeds only a damping scale).
// ---------------------------------------------------------------------
static double pairwise_sumsq(const double *v, int64_t n) {
  if (n <= 8) {
    double sq = 0.0;
    for (int64_t k = 0; k < n; ++k) sq += v[k] * v[k];
    return sq;
  }
  const int64_t h = n / 2;
  return pairwise_sumsq(v, h) + pairwise_sumsq(v + h, n - h);
}

PyObject *rho_power(PyObject *, PyObject *args) {
  PyArrayObject *ip_o, *ix_o, *d_o, *dinv_o, *x0_o;
  long iters_l;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!l", &PyArray_Type, &ip_o,
                        &PyArray_Type, &ix_o, &PyArray_Type, &d_o,
                        &PyArray_Type, &dinv_o, &PyArray_Type, &x0_o,
                        &iters_l))
    return nullptr;
  const int64_t nr = PyArray_DIM(ip_o, 0) - 1;  // matrix rows (blocks)
  const int is_bsr = PyArray_NDIM(d_o) == 3;
  const int br = is_bsr ? (int)PyArray_DIM(d_o, 1) : 1;
  const int bcw = is_bsr ? (int)PyArray_DIM(d_o, 2) : 1;
  const int db = (int)PyArray_DIM(dinv_o, 1);  // Dinv block size
  const int64_t n = PyArray_DIM(x0_o, 0);      // scalar length
  auto *dat = static_cast<const double *>(PyArray_DATA(d_o));
  auto *dinv = static_cast<const double *>(PyArray_DATA(dinv_o));
  auto *x0 = static_cast<const double *>(PyArray_DATA(x0_o));
  std::vector<double> x(x0, x0 + n), y((size_t)n);
  double lam = is_bsr ? 1.0 : 2.0;  // numpy-path initial defaults
  return dispatch_index(ip_o, [&](auto ixx) -> PyObject * {
    using I = decltype(ixx);
    auto *ip = static_cast<const I *>(PyArray_DATA(ip_o));
    auto *ix = static_cast<const I *>(PyArray_DATA(ix_o));
    for (long it = 0; it < iters_l; ++it) {
      // y = A x
      if (!is_bsr) {
        for (int64_t r = 0; r < nr; ++r) {
          double acc = 0.0;
          for (I k = ip[r]; k < ip[r + 1]; ++k)
            acc += dat[k] * x[(size_t)ix[k]];
          y[(size_t)r] = acc;
        }
      } else {
        std::fill(y.begin(), y.end(), 0.0);
        for (int64_t r = 0; r < nr; ++r) {
          double *yr = y.data() + r * br;
          for (I k = ip[r]; k < ip[r + 1]; ++k) {
            const double *B = dat + (int64_t)k * br * bcw;
            const double *xc = x.data() + (int64_t)ix[k] * bcw;
            for (int rr = 0; rr < br; ++rr) {
              double acc = 0.0;
              for (int cc = 0; cc < bcw; ++cc)
                acc += B[rr * bcw + cc] * xc[cc];
              yr[rr] += acc;
            }
          }
        }
      }
      // x = blockwise Dinv y
      const int64_t nb = n / db;
      for (int64_t b = 0; b < nb; ++b) {
        const double *Db = dinv + b * db * db;
        const double *yb = y.data() + b * db;
        double *xb = x.data() + b * db;
        for (int rr = 0; rr < db; ++rr) {
          double acc = 0.0;
          for (int cc = 0; cc < db; ++cc) acc += Db[rr * db + cc] * yb[cc];
          xb[rr] = acc;
        }
      }
      const double nrm = std::sqrt(pairwise_sumsq(x.data(), n));
      if (nrm == 0.0) return PyFloat_FromDouble(is_bsr ? 2.0 : lam);
      lam = nrm;
      const double inv = 1.0 / nrm;
      for (int64_t k = 0; k < n; ++k) x[(size_t)k] *= inv;
    }
    return PyFloat_FromDouble(lam);
  });
}

// ---------------------------------------------------------------------
// bsr_sym_scale(indptr i64, indices i32, data (nnzb, R, C) f64,
//               s f64[n_scal]) -> data' (nnzb, R, C) f64
// One-pass symmetric diagonal scaling of a BSR:
// data'[e][r][c] = data[e][r][c] * s[row*R + r] * s[col*C + c]
// (the block form of csr_sym_scale; the numpy broadcast version moved
// ~1.5 GB of gather/product temporaries at 5.8M finest blocks).
// ---------------------------------------------------------------------
PyObject *bsr_sym_scale(PyObject *, PyObject *args) {
  PyArrayObject *ip_o, *ix_o, *d_o, *s_o;
  if (!PyArg_ParseTuple(args, "O!O!O!O!", &PyArray_Type, &ip_o,
                        &PyArray_Type, &ix_o, &PyArray_Type, &d_o,
                        &PyArray_Type, &s_o))
    return nullptr;
  const int64_t n = PyArray_DIM(ip_o, 0) - 1;
  const int R = (int)PyArray_DIM(d_o, 1);
  const int C = (int)PyArray_DIM(d_o, 2);
  auto *ip = static_cast<const int64_t *>(PyArray_DATA(ip_o));
  auto *ix = static_cast<const int32_t *>(PyArray_DATA(ix_o));
  auto *dat = static_cast<const double *>(PyArray_DATA(d_o));
  auto *s = static_cast<const double *>(PyArray_DATA(s_o));
  npy_intp dims[3] = {PyArray_DIM(d_o, 0), R, C};
  PyArrayObject *o_d =
      (PyArrayObject *)PyArray_SimpleNew(3, dims, NPY_FLOAT64);
  auto *out = static_cast<double *>(PyArray_DATA(o_d));
  const int dd = R * C;
  for (int64_t i = 0; i < n; ++i) {
    const double *sr = s + i * R;
    for (int64_t e = ip[i]; e < ip[i + 1]; ++e) {
      const double *sc = s + (int64_t)ix[e] * C;
      const double *src = dat + e * dd;
      double *dst = out + e * dd;
      for (int r = 0; r < R; ++r)
        for (int c = 0; c < C; ++c)
          dst[r * C + c] = src[r * C + c] * sr[r] * sc[c];
    }
  }
  return (PyObject *)o_d;
}

// ---------------------------------------------------------------------
// frob2_sym(B (m, d, d) f64) -> (m,) f64: transpose-invariant batched
// squared Frobenius norm in the canonical order of
// apps/elasticity._frob2T — diagonal squares first, then the unordered
// off-diagonal pairs as (sq_ij + sq_ji) in row-major upper order —
// so both owners of a transposed block pair compute bitwise-identical
// weights, with no (m, d, d) squared temporaries.
// ---------------------------------------------------------------------
// fp-contract OFF: the transpose-invariance guarantee (owner of block
// (i,j) and owner of the TRANSPOSED block (j,i) compute bitwise-equal
// weights) requires every product to round identically on both operand
// orders — an FMA contracting one side's product into the accumulate
// would break it.
__attribute__((optimize("fp-contract=off")))
PyObject *frob2_sym(PyObject *, PyObject *args) {
  PyArrayObject *b_o;
  if (!PyArg_ParseTuple(args, "O!", &PyArray_Type, &b_o))
    return nullptr;
  const int64_t m = PyArray_DIM(b_o, 0);
  const int d = (int)PyArray_DIM(b_o, 1);
  auto *B = static_cast<const double *>(PyArray_DATA(b_o));
  npy_intp dims[1] = {m};
  PyArrayObject *o =
      (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  auto *out = static_cast<double *>(PyArray_DATA(o));
  const int dd = d * d;
  for (int64_t e = 0; e < m; ++e) {
    const double *Be = B + e * dd;
    // exactly the numpy association: diag sum and pair sum accumulate
    // separately, each pair as (sq_ij + sq_ji), then one final add
    double accd = 0.0, accp = 0.0;
    for (int i = 0; i < d; ++i) accd += Be[i * d + i] * Be[i * d + i];
    for (int i = 0; i < d; ++i)
      for (int j = i + 1; j < d; ++j)
        accp += Be[i * d + j] * Be[i * d + j] +
                Be[j * d + i] * Be[j * d + i];
    out[e] = accd + accp;
  }
  return (PyObject *)o;
}

PyMethodDef methods[] = {
    {"frob2_sym", frob2_sym, METH_VARARGS,
     "transpose-invariant batched squared Frobenius norms"},
    {"bsr_sym_scale", bsr_sym_scale, METH_VARARGS,
     "one-pass symmetric diagonal scaling of a BSR"},
    {"greedy_color", greedy_color, METH_VARARGS,
     "sequential greedy graph coloring"},
    {"pencil_extreme_eig", pencil_extreme_eig_native, METH_VARARGS,
     "batched extreme eigenvalue of small symmetric pencils"},
    {"bsr_mm", bsr_mm, METH_VARARGS,
     "block-sparse Gustavson product C = A B (BSR)"},
    {"elast_map_edge_mats", elast_map_edge_mats, METH_VARARGS,
     "coarse edge matrices: Q-transported fine-edge energy sums"},
    {"elast_rm_diag", elast_rm_diag, METH_VARARGS,
     "fused replacement-matrix diagonal accumulation"},
    {"rigid_edge_blocks", rigid_edge_blocks, METH_VARARGS,
     "fused per-edge replacement-matrix blocks (rigid transports)"},
    {"elast_soc_robust", elast_soc_robust, METH_VARARGS,
     "fused rigid-transport robust SOC (transports+harmonic+pencil)"},
    {"harmonic_mean_sym", harmonic_mean_sym, METH_VARARGS,
     "batched symmetrized series energy A (A+B)^+ B"},
    {"csr_sym_scale", csr_sym_scale, METH_VARARGS,
     "fused symmetric diagonal scaling of CSR data"},
    {"handshake_match", handshake_match, METH_VARARGS,
     "pairwise handshake matching round"},
    {"ell_slots", ell_slots, METH_VARARGS, "CSR->ELL slot computation"},
    {"rap_csr", rap_csr, METH_VARARGS,
     "fused Galerkin triple product P^T A P (scalar CSR)"},
    {"collapse_graph", collapse_graph, METH_VARARGS,
     "Galerkin-collapse a scalar graph onto aggregates (diag dropped)"},
    {"smoothed_prol_scalar", smoothed_prol_scalar, METH_VARARGS,
     "fused semi-aux smoothed prolongation (scalar H1)"},
    {"edges_to_adj", edges_to_adj, METH_VARARGS,
     "edge list -> symmetric CSR adjacency (canonical order)"},
    {"map_edges_agg", map_edges_agg, METH_VARARGS,
     "coarse edges + fine->coarse edge map under aggregation"},
    {"rho_power_h1", rho_power_h1, METH_VARARGS,
     "power iteration for rho(Dhat^-1 A-hat) from edges"},
    {"tile_chunk_counts", tile_chunk_counts, METH_VARARGS,
     "per-tile distinct column-chunk counts"},
    {"tile_ell_fill_range", tile_ell_fill_range, METH_VARARGS,
     "fill one bucket of the bucketed/chunked tile-ELL"},
    {"tile_ell_pack", tile_ell_pack, METH_VARARGS,
     "pack scalar CSR into tile-ELL (T, K, M)"},
    {"collapse_signed", collapse_signed, METH_VARARGS,
     "full signed Galerkin collapse with cluster diagonal"},
    {"finest_mesh_scal", finest_mesh_scal, METH_VARARGS,
     "fused scalar finest-mesh extraction (diag, rowsum, edges, |wt|)"},
    {"cluster_detect", cluster_detect, METH_VARARGS,
     "strong-cluster detection + candidate block extraction"},
    {"spw_round_h1", spw_round_h1, METH_VARARGS,
     "fused H1 matching round: soc + adjacency + handshake"},
    {"bsr_smooth_update", bsr_smooth_update, METH_VARARGS,
     "fused damped-Jacobi prolongation smoothing P - s*Dinv(A P)"},
    {"rap_bsr", rap_bsr, METH_VARARGS,
     "fused block-entry Galerkin triple product P^T A P (BSR in/out)"},
    {"truncate_prol_blocks", truncate_prol_blocks, METH_VARARGS,
     "fan-out-bounded kernel-preserving block prolongation truncation"},
    {"elast_ahat_bsr", elast_ahat_bsr, METH_VARARGS,
     "fused elasticity replacement-matrix assembly into sorted BSR"},
    {"rho_power", rho_power, METH_VARARGS,
     "power-iteration rho(D^-1 A) on scalar CSR or BSR"},
    {"bsr_from_edge_blocks", bsr_from_edge_blocks, METH_VARARGS,
     "assemble block replacement matrix from per-edge blocks"},
    {"csr_permute", csr_permute, METH_VARARGS,
     "CSR row/column permutation with sorted output"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_ngsamg_native", nullptr,
                         -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__ngsamg_native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
