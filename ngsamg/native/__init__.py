"""Optional native (C++) setup kernels with numpy fallbacks.

On first import the extension is compiled from ``kernels.cpp`` with the
system C++ compiler into ``<repo>/build/native-<key>/``, where the key
hashes the source, the Python ABI and the host CPU's flags (the build
uses ``-march=native``, so a build from another machine is never
loaded). This is the only build path: no setuptools is needed, only a
C++17 compiler (``CXX``, default ``c++``). The wrappers here
validate/convert dtypes and fall back to numpy when the extension is
missing, so the framework
works identically (just slower on the host setup path) without a
toolchain. ``NGSAMG_NO_AUTOBUILD=1`` skips the build.
"""

from __future__ import annotations

import numpy as np


def _build_and_load():  # pragma: no cover - environment dependent
    """Compile (once per key, under a file lock) and import the extension;
    None on any failure."""
    import fcntl
    import hashlib
    import importlib.util
    import os
    import subprocess
    import sysconfig

    if os.environ.get("NGSAMG_NO_AUTOBUILD", "0") == "1":
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "kernels.cpp")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = hashlib.sha1()
    with open(src, "rb") as f:
        key.update(f.read())
    key.update(suffix.encode())
    try:
        with open("/proc/cpuinfo", "rb") as f:
            key.update(
                next((ln for ln in f if ln.startswith(b"flags")), b"")
            )
    except OSError:
        pass
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(here)),
        "build",
        "native-" + key.hexdigest()[:16],
    )
    so = os.path.join(out_dir, "_ngsamg_native" + suffix)
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(so):
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    [
                        os.environ.get("CXX", "c++"),
                        "-O3", "-std=c++17", "-march=native",
                        "-shared", "-fPIC",
                        "-I" + sysconfig.get_paths()["include"],
                        "-I" + np.get_include(),
                        src, "-o", tmp,
                    ],
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                    timeout=600,
                    check=True,
                )
                os.replace(tmp, so)
        spec = importlib.util.spec_from_file_location(
            __name__ + "._ngsamg_native", so
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:
        return None


_nat = _build_and_load()
HAVE_NATIVE = _nat is not None


def _csr_idx(indptr, indices):
    """Matching-dtype (int32/int64) contiguous index arrays, no-copy when
    possible.

    Native kernels dispatch on the index dtype; scipy stores int32 below
    2^31 nnz, the native emitters int64 indptr + int32 indices. A dtype
    mismatch downcasts the (short) indptr — never the O(nnz) indices."""
    indptr = np.ascontiguousarray(indptr)
    indices = np.ascontiguousarray(indices)
    if indptr.dtype != indices.dtype:
        indptr = indptr.astype(indices.dtype)
    if indptr.dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
        indptr = indptr.astype(np.int64)
        indices = indices.astype(np.int64)
    return indptr, indices


def greedy_color(indptr, indices) -> np.ndarray | None:
    """Sequential greedy coloring; None when the extension is absent."""
    if not HAVE_NATIVE:
        return None
    return _nat.greedy_color(*_csr_idx(indptr, indices))


def rap_csr(A, P, dtype=None, symmetrize=False):
    """Fused P^T A P; returns a scipy CSR or None (extension absent).

    Accumulates in f64; emits float32 values directly when ``dtype`` says
    so, and applies the exact (C + C^T)/2 symmetrization in-kernel when
    ``symmetrize`` (saves scipy's allocating 3-pass add)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    A = A.tocsr()
    P = P.tocsr()
    nc = P.shape[1]
    ai, aj = _csr_idx(A.indptr, A.indices)
    pi, pj = _csr_idx(P.indptr, P.indices)
    if ai.dtype != pi.dtype:
        t = np.promote_types(ai.dtype, pi.dtype)
        ai, aj, pi, pj = (x.astype(t) for x in (ai, aj, pi, pj))
    emit_f32 = dtype is not None and np.dtype(dtype) == np.dtype(
        np.float32
    )
    indptr, indices, data = _nat.rap_csr(
        ai, aj, np.ascontiguousarray(A.data, dtype=np.float64),
        pi, pj, np.ascontiguousarray(P.data, dtype=np.float64),
        int(nc), 1 if emit_f32 else 0, 1 if symmetrize else 0,
    )
    if dtype is not None and data.dtype != np.dtype(dtype):
        data = data.astype(dtype)
    M = sp.csr_matrix((data, indices, indptr), shape=(nc, nc))
    M.has_canonical_format = True
    return M


def handshake_match(indptr, indices, weights, can_match, theta, iters=8,
                    jitter=False):
    if not HAVE_NATIVE:
        return None
    return _nat.handshake_match(
        *_csr_idx(indptr, indices),
        np.ascontiguousarray(weights, dtype=np.float64),
        np.ascontiguousarray(can_match, dtype=np.uint8),
        float(theta),
        int(iters),
        1 if jitter else 0,
    )


def edges_to_adj(edges, weights, n):
    """Symmetric CSR adjacency from an (i < j) edge list; CSR or None."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    indptr, indices, data = _nat.edges_to_adj(
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(weights, dtype=np.float64),
        int(n),
    )
    M = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    M.has_canonical_format = True
    return M


def map_edges_agg(edges, v2agg, n_agg):
    """(coarse_edges, e2ce) under aggregation; None when ext absent."""
    if not HAVE_NATIVE:
        return None
    ce, e2ce = _nat.map_edges_agg(
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(v2agg, dtype=np.int64),
        int(n_agg),
    )
    return ce, e2ce


def rho_power_h1(edges, w, d, x0, iters=10):
    """Power-iteration rho(Dhat^-1 A-hat) from edges; None when absent."""
    if not HAVE_NATIVE:
        return None
    return float(
        _nat.rho_power_h1(
            np.ascontiguousarray(edges, dtype=np.int64),
            None,
            np.ascontiguousarray(w, dtype=np.float64),
            np.ascontiguousarray(d, dtype=np.float64),
            np.ascontiguousarray(x0, dtype=np.float64),
            int(iters),
        )
    )


def tile_chunk_counts(indptr, indices, M, chunk, T):
    """int64[T] distinct column-chunk count per M-row tile, or None."""
    if not HAVE_NATIVE:
        return None
    return _nat.tile_chunk_counts(
        *_csr_idx(indptr, indices), int(M), int(chunk), int(T)
    )


def tile_ell_fill_range(A, M, chunk, t0, t1, K, out_data, out_cols):
    """Fill one bucket of the bucketed/chunked tile-ELL in place.

    ``out_data`` (t1-t0, K, chunk, M) matching A.data's float dtype,
    ``out_cols`` (t1-t0, K) int32, both zeroed by the caller. Returns
    True, or False when the extension is absent."""
    if not HAVE_NATIVE:
        return False
    data = A.data
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        data = data.astype(np.float64)
    _nat.tile_ell_fill_range(
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(data),
        int(M),
        int(chunk),
        int(t0),
        int(t1),
        int(K),
        out_data,
        out_cols,
    )
    return True


def tile_ell_pack(A, M, T):
    """(data (T,K,M) f32, cols (T,K) i32, K) or None (extension absent)."""
    if not HAVE_NATIVE:
        return None
    A = A.tocsr()
    data = A.data
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        data = data.astype(np.float64)
    return _nat.tile_ell_pack(
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(data),
        int(M),
        int(T),
    )


def collapse_graph(S, v2agg, n_agg):
    """C^T S C with the diagonal dropped; scipy CSR or None."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    S = S.tocsr()
    indptr, indices, data = _nat.collapse_graph(
        *_csr_idx(S.indptr, S.indices),
        np.ascontiguousarray(S.data, dtype=np.float64),
        np.ascontiguousarray(v2agg, dtype=np.int64),
        int(n_agg),
    )
    M = sp.csr_matrix((data, indices, indptr), shape=(n_agg, n_agg))
    M.has_canonical_format = True
    return M


def smoothed_prol_scalar(
    A, edges, edge_w, l2wt, v2agg, n_agg,
    scale_aux, scale_real, max_per_row, max_classic, min_frac,
    filter_pos=False,
):
    """Fused scalar semi-aux smoothed prolongation; CSR or None.

    ``scale_aux``/``scale_real`` are omega already divided by the
    respective spectral-radius estimates (the caller computes those so the
    numpy fallback and this kernel share them bit-for-bit)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    A = A.tocsr()
    Adata = A.data
    if Adata.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        Adata = Adata.astype(np.float64)
    indptr, indices, data = _nat.smoothed_prol_scalar(
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(Adata),
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(edge_w, dtype=np.float64),
        np.ascontiguousarray(l2wt, dtype=np.float64),
        np.ascontiguousarray(v2agg, dtype=np.int64),
        int(n_agg),
        float(scale_aux),
        float(scale_real),
        int(max_per_row),
        int(max_classic),
        float(min_frac),
        1 if filter_pos else 0,
    )
    return sp.csr_matrix(
        (data, indices, indptr), shape=(A.shape[0], int(n_agg))
    )


def finest_mesh_scal(A, neg_only=False, signed_wt=False):
    """(diag, signed rowsum, edges (m,2) int64, wt) from a symmetric
    scalar CSR in one fused pass; None when the extension is absent.

    With ``neg_only`` the edge list keeps only attractive (negative)
    couplings — the standard SA strength filter. With ``signed_wt`` all
    off-diagonal couplings are kept with SIGNED weight -a_ij (attractive
    positive), so coarse-level weight sums cancel repulsive couplings."""
    if not HAVE_NATIVE:
        return None
    A = A.tocsr()
    mode = 2 if signed_wt else (1 if neg_only else 0)
    diag, rsum, edges, ew = _nat.finest_mesh_scal(
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(A.data, dtype=np.float64),
        mode,
    )
    return diag, rsum, edges, ew


def csr_permute(A, rowperm=None, colperm=None):
    """``A[rowperm][:, colperm]`` as a canonical CSR; None when absent.

    ``rowperm``/``colperm`` are new-index -> old-index permutations (the
    numpy fancy-index convention). Column renaming uses the inverse map
    internally; rows come out column-sorted."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    A = A.tocsr()
    data = A.data
    if data.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        data = data.astype(np.float64)
    rp = (
        None
        if rowperm is None
        else np.ascontiguousarray(rowperm, dtype=np.int64)
    )
    cmap = None
    if colperm is None:
        icp = None
    else:
        cp = np.asarray(colperm, dtype=np.int64)
        icp = np.empty(len(cp), dtype=np.int64)
        icp[cp] = np.arange(len(cp), dtype=np.int64)
        cmap = icp
    indptr, indices, vals = _nat.csr_permute(
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(data),
        rp,
        cmap,
    )
    M = sp.csr_matrix(
        (vals, indices, indptr),
        shape=(
            A.shape[0] if rowperm is None else len(rp),
            A.shape[1],
        ),
    )
    M.has_canonical_format = True
    return M


def cluster_detect(A, beta, eig_ratio, max_size):
    """(blocks (ncand,K,K) f64, members (ncand,K) int32, csz int32) of
    candidate defective strong clusters; None when the ext is absent.

    One fused pass: strength union-find + in-kernel screening (exact 2x2
    eig for pairs, Gershgorin bound for larger) + dense block extraction
    for candidates only (smoothers/cluster_corr.detect_clusters)."""
    if not HAVE_NATIVE:
        return None
    A = A.tocsr()
    return _nat.cluster_detect(
        *_csr_idx(A.indptr, A.indices),
        np.ascontiguousarray(A.data, dtype=np.float64),
        float(beta),
        float(eig_ratio),
        int(max_size),
    )


def spw_round_h1(edges, w, l2, can_match, theta, iters=8):
    """Fused H1 matching round: aux diag + soc + adjacency + jittered
    handshake in one pass; partner int64[n] or None (ext absent)."""
    if not HAVE_NATIVE:
        return None
    cm = (
        None
        if can_match is None
        else np.ascontiguousarray(can_match, dtype=np.uint8)
    )
    return _nat.spw_round_h1(
        np.ascontiguousarray(edges, dtype=np.int64),
        None,
        np.ascontiguousarray(w, dtype=np.float64),
        np.ascontiguousarray(l2, dtype=np.float64),
        cm,
        float(theta),
        int(iters),
    )


def bsr_from_edge_blocks(edges, Bii, Bij, Bji, Bjj, Dv):
    """Assemble the block replacement matrix A-hat as a scipy BSR from
    per-edge (d,d) blocks + per-vertex diagonal blocks; None when the
    extension is absent (apps/elasticity.replacement_matrix)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    d = Dv.shape[1]
    indptr, indices, blocks = _nat.bsr_from_edge_blocks(
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(Bii, dtype=np.float64),
        np.ascontiguousarray(Bij, dtype=np.float64),
        np.ascontiguousarray(Bji, dtype=np.float64),
        np.ascontiguousarray(Bjj, dtype=np.float64),
        np.ascontiguousarray(Dv, dtype=np.float64),
    )
    nv = Dv.shape[0]
    return sp.bsr_matrix(
        (blocks, indices, indptr), shape=(nv * d, nv * d)
    )


def pencil_extreme_eig(E, C, tol=1e-10, reduction="min"):
    """Batched extreme eigenvalue of small symmetric pencils (E, C)
    restricted to range(C); None when the extension is absent
    (apps/elasticity._pencil_extreme_eig hot path)."""
    if not HAVE_NATIVE:
        return None
    return _nat.pencil_extreme_eig(
        np.ascontiguousarray(E, dtype=np.float64),
        np.ascontiguousarray(C, dtype=np.float64),
        float(tol),
        0 if reduction == "min" else 1,
    )


def harmonic_mean_sym(A, B, rcond=1e-12):
    """Batched symmetrized series energy A (A+B)^+ B; None when the
    extension is absent (soc_robust / _neib_boost)."""
    if not HAVE_NATIVE:
        return None
    return _nat.harmonic_mean_sym(
        np.ascontiguousarray(A, dtype=np.float64),
        np.ascontiguousarray(B, dtype=np.float64),
        float(rcond),
    )


def csr_sym_scale(A, s):
    """data * s[row] * s[col] in one pass over a CSR; None when the
    extension is absent (precond/amg device-staging scaling)."""
    if not HAVE_NATIVE:
        return None
    return _nat.csr_sym_scale(
        A.indptr, A.indices,
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(s, dtype=np.float64),
    )


def frob2_sym(B):
    """Transpose-invariant batched squared Frobenius norms (canonical
    summation order of apps/elasticity._frob2T, fp-contraction off);
    None when the extension is absent."""
    if not HAVE_NATIVE or not hasattr(_nat, "frob2_sym"):
        return None
    return _nat.frob2_sym(np.ascontiguousarray(B, dtype=np.float64))


def bsr_sym_scale(A, s):
    """One-pass symmetric diagonal scaling of a scipy BSR (block form of
    csr_sym_scale): data'[e,r,c] = data[e,r,c] * s[row_r] * s[col_c];
    None when the extension is absent (precond/amg._sym_scale)."""
    if not HAVE_NATIVE or not hasattr(_nat, "bsr_sym_scale"):
        return None
    return _nat.bsr_sym_scale(
        np.ascontiguousarray(A.indptr, dtype=np.int64),
        np.ascontiguousarray(A.indices, dtype=np.int32),
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(s, dtype=np.float64),
    )


def elast_rm_diag(pos, edges, E, s):
    """Fused replacement-matrix diagonal (aux_diagonal's RM part): D[i] +=
    Qim^T E Qim, D[j] += Qjm^T E Qjm; None when the extension is absent."""
    if not HAVE_NATIVE:
        return None
    return _nat.elast_rm_diag(
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
    )


def bsr_mm(A, B):
    """Block-sparse Gustavson product C = A @ B for scipy BSR inputs
    with compatible (possibly rectangular) block sizes; returns scipy
    BSR (or None when the extension is absent — callers fall back to
    scipy's scalar CSR product, which does ~bs^2 more index work)."""
    if not HAVE_NATIVE:
        return None
    import scipy.sparse as sp

    ra, ca = A.blocksize
    if B.blocksize[0] != ca:
        return None
    cbk = B.blocksize[1]
    ncB = B.shape[1] // cbk
    ip, ix, dat = _nat.bsr_mm(
        np.ascontiguousarray(A.indptr, dtype=np.int64),
        np.ascontiguousarray(A.indices, dtype=np.int32),
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(B.indptr, dtype=np.int64),
        np.ascontiguousarray(B.indices, dtype=np.int32),
        np.ascontiguousarray(B.data, dtype=np.float64),
        int(ncB),
    )
    return sp.bsr_matrix(
        (dat, ix, ip), shape=(A.shape[0], B.shape[1])
    )


def elast_map_edge_mats(pos, cpos, edges, ce, cedges, E, s):
    """Fused coarse-edge-matrix accumulation (map_data hot loop):
    Ec[ce] += Q(m_c -> m_f)^T E Q(m_c -> m_f) over mapped fine edges, in
    edge order (bitwise equal to the numpy scatter_add path); None when
    the extension is absent."""
    if not HAVE_NATIVE:
        return None
    return _nat.elast_map_edge_mats(
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(cpos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(ce, dtype=np.int64),
        np.ascontiguousarray(cedges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
    )


def elast_soc_robust(pos, edges, E, D, s, tol=1e-10, reduction="min"):
    """Fully fused robust SOC per edge (midpoint transports + series
    energy + extreme pencil eigenvalue); None when the extension is
    absent (apps/elasticity.soc_robust)."""
    if not HAVE_NATIVE:
        return None
    return _nat.elast_soc_robust(
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        np.ascontiguousarray(D, dtype=np.float64),
        float(s),
        float(tol),
        0 if reduction == "min" else 1,
    )


def rap_bsr(A, P, nc_blocks=None, symmetrize=True):
    """Fused block-entry Galerkin triple product C = P^T A P for scipy
    BSR inputs (A: (br,br) blocks, P: (br,bc) blocks) with in-kernel
    block symmetrization; returns scipy BSR with (bc,bc) blocks, or
    None when the extension is absent (transfer/galerkin.rap)."""
    if not HAVE_NATIVE or not hasattr(_nat, "rap_bsr"):
        return None
    import scipy.sparse as sp

    br, br2 = A.blocksize
    brp, bc = P.blocksize
    if br != br2 or brp != br:
        return None
    ncb = nc_blocks if nc_blocks is not None else P.shape[1] // bc
    ip, ix, dat = _nat.rap_bsr(
        np.ascontiguousarray(A.indptr, dtype=np.int64),
        np.ascontiguousarray(A.indices, dtype=np.int32),
        np.ascontiguousarray(A.data, dtype=np.float64),
        np.ascontiguousarray(P.indptr, dtype=np.int64),
        np.ascontiguousarray(P.indices, dtype=np.int32),
        np.ascontiguousarray(P.data, dtype=np.float64),
        int(ncb),
        1 if symmetrize else 0,
    )
    return sp.bsr_matrix(
        (dat, ix, ip), shape=(ncb * bc, ncb * bc)
    )


def bsr_smooth_update(Ahat, Ppw, Dinv, scale):
    """Fused damped-Jacobi prolongation smoothing
    C = P_pw - scale * Dinv (A-hat @ P_pw) for square-block scipy BSR
    inputs; returns sorted scipy BSR or None when the extension is
    absent (transfer/prolongation.smoothed_prol block path)."""
    if not HAVE_NATIVE or not hasattr(_nat, "bsr_smooth_update"):
        return None
    import scipy.sparse as sp

    d = Ahat.blocksize[0]
    if Ahat.blocksize[1] != d or Ppw.blocksize != (d, d):
        return None
    deg = np.diff(Ppw.indptr)
    if len(deg) and deg.max() > 1:
        return None  # kernel reads at most one (piecewise) block per row
    ncb = Ppw.shape[1] // d
    ip, ix, dat = _nat.bsr_smooth_update(
        np.ascontiguousarray(Ahat.indptr, dtype=np.int64),
        np.ascontiguousarray(Ahat.indices, dtype=np.int32),
        np.ascontiguousarray(Ahat.data, dtype=np.float64),
        np.ascontiguousarray(Ppw.indptr, dtype=np.int64),
        np.ascontiguousarray(Ppw.indices, dtype=np.int32),
        np.ascontiguousarray(Ppw.data, dtype=np.float64),
        np.ascontiguousarray(Dinv, dtype=np.float64),
        float(scale),
        int(ncb),
    )
    out = sp.bsr_matrix((dat, ix, ip), shape=Ppw.shape)
    out.has_sorted_indices = True
    return out


def truncate_prol_blocks(P, pos_c, s, max_per_row, min_frac):
    """Fan-out-bounded kernel-preserving truncation of a block
    prolongation (scipy BSR, sorted indices); ``pos_c`` None = identity
    transport; returns truncated scipy BSR or None when the extension
    is absent (transfer/prolongation.truncate_prol)."""
    if not HAVE_NATIVE or not hasattr(_nat, "truncate_prol_blocks"):
        return None
    import scipy.sparse as sp

    d = P.blocksize[0]
    if P.blocksize[1] != d:
        return None
    ip, ix, dat = _nat.truncate_prol_blocks(
        np.ascontiguousarray(P.indptr, dtype=np.int64),
        np.ascontiguousarray(P.indices, dtype=np.int32),
        np.ascontiguousarray(P.data, dtype=np.float64),
        None
        if pos_c is None
        else np.ascontiguousarray(pos_c, dtype=np.float64),
        float(s),
        int(max_per_row),
        float(min_frac),
    )
    return sp.bsr_matrix((dat, ix, ip), shape=P.shape)


def elast_ahat_bsr(pos, edges, E, s, l2):
    """Fully fused elasticity replacement-matrix assembly (rigid edge
    blocks scattered straight into sorted BSR + l2 displacement
    diagonal); None when the extension is absent
    (apps/elasticity.replacement_matrix)."""
    if not HAVE_NATIVE or not hasattr(_nat, "elast_ahat_bsr"):
        return None
    import scipy.sparse as sp

    d = E.shape[1]
    nv = len(l2)
    indptr, indices, blocks = _nat.elast_ahat_bsr(
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
        np.ascontiguousarray(l2, dtype=np.float64),
    )
    return sp.bsr_matrix(
        (blocks, indices, indptr), shape=(nv * d, nv * d)
    )


def rho_power(A, Dinv, x0, iters):
    """Power-iteration rho(D^-1 A) on a scalar CSR or block BSR with
    block-diagonal Dinv; None when the extension is absent
    (prolongation._rho_estimate / smoothers/build._lam_max_estimate)."""
    if not HAVE_NATIVE or not hasattr(_nat, "rho_power"):
        return None
    data = A.data
    if data.ndim == 3:
        data = np.ascontiguousarray(data, dtype=np.float64)
    else:
        data = np.ascontiguousarray(data.ravel(), dtype=np.float64)
    indptr, indices = _csr_idx(A.indptr, A.indices)
    return _nat.rho_power(
        indptr, indices, data,
        np.ascontiguousarray(Dinv, dtype=np.float64),
        np.ascontiguousarray(x0, dtype=np.float64),
        int(iters),
    )


def rigid_edge_blocks(pos, edges, E, s):
    """Fused per-edge replacement-matrix blocks (Bii, Bij, Bji, Bjj);
    None when the extension is absent (_edge_rm_blocks hot path)."""
    if not HAVE_NATIVE:
        return None
    return _nat.rigid_edge_blocks(
        np.ascontiguousarray(pos, dtype=np.float64),
        np.ascontiguousarray(edges, dtype=np.int64),
        np.ascontiguousarray(E, dtype=np.float64),
        float(s),
    )
