"""Stencil-domain setup for full-lattice levels (structured fast path).

On a full tensor lattice, every object in the setup pipeline is translation
-structured: the operator is a stencil (vector offsets + per-cell data), the
tentative prolongation is the 2^d index blocking, and the smoothed
prolongation P = (I - omega D^-1 A) P_pw couples only bounded offset
neighborhoods. This module computes the exact Galerkin product
A_c = P^T A P *in the stencil domain* via a polyphase (parity) decomposition
— pure vectorized numpy over coarse-lattice arrays, no sparse matrices —
replacing the scipy CSR matmuls that dominated host setup (measured 5 s of a
14 s setup at 2 M DoF; this path computes the same coarse operators in
O(#offset-combinations) dense array ops).

This is the structured-level answer to the reference's block-sparse `RestrictMatrix`
(/root/reference/src/base/linalg/utils_sparseMM.hpp:94-108) for structured
levels; unstructured levels keep the generic sparse RAP.

Math. Write fine index x = 2q + s (parity s in {0,1}^d, coarse base q) and
let K be the fine stencil offsets. With agg(x) = floor(x/2):

  P[2q+s, q+w] = [w = 0][x valid] - omega * dinv[x] *
                 sum_{k in K, floor((s+k)/2) = w} A_k[x]          (phi_{s,w})
  (AP)[2q+s, q+v] = sum_k A_k[2q+s] * phi_{s', v-h}[q+h],
                    s' = (s+k) mod 2,  h = floor((s+k)/2)
  A_c[c, c+e]     = sum_{s,w} phi_{s,w}[c-w] * (AP)phi_{s, w+e}[c-w]

Every factor is a coarse-shaped array; shifts are zero-filled slices.

Stencil pruning (`prune`) bounds the coarse-stencil growth (measured
7 -> 33 -> 179 -> 603 offsets unpruned) with SIGNED row-sum-preserving
diagonal lumping: every dropped entry is added to its row's diagonal, so
the coarse near-kernel (constant-vector) energies are exact. The SPD
perturbation is a graph Laplacian of the dropped weights, bounded by the
cumulative budget 2*tol*min(diag) — small against coarse-level
lambda_min; the PCG/self-tests catch violations (see prune's docstring).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class LatticeOp:
    """Stencil operator on a full row-major lattice.

    data[t, x] = A[x, x + offs[t]] in lattice coordinates; zero where
    x + offs[t] falls outside the lattice.
    """

    dims: tuple  # (d,) lattice extents
    offs: np.ndarray  # (m, d) int64 vector offsets (lexicographically sorted)
    data: np.ndarray  # (m, *dims) float64

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.data))

    def diagonal(self) -> np.ndarray:
        t = _find_zero_offset(self.offs)
        return self.data[t].reshape(-1)

    def gershgorin(self) -> float:
        """Upper bound on lambda_max(D^-1 A): max row sum of |D^-1 A|."""
        d = np.abs(self.diagonal().reshape(self.dims))
        s = np.abs(self.data).sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(d > 0, s / np.where(d == 0, 1.0, d), 0.0)
        return float(r.max()) if r.size else 1.0

    def offdiag_abs_sum(self) -> np.ndarray:
        """sum_j |a_xj| over j != x, per row (l1-Jacobi modification)."""
        s = np.abs(self.data).sum(axis=0) - np.abs(
            self.diagonal().reshape(self.dims)
        )
        return s.reshape(-1)

    def constant_diagonal(self) -> float | None:
        """The diagonal value when it is constant over the lattice.

        Uniform clipped stencils keep a constant diagonal everywhere
        (clipping removes off-diagonal terms only): smoothers and the
        implicit lattice transfers can then use a broadcast scalar
        instead of an (n,) inverse-diagonal array — at 10M rows that
        array is 40 MB of host staging + transfer + per-sweep HBM reads.
        """
        t0 = _find_zero_offset(self.offs)
        d0 = self.data[t0]
        v = d0.flat[0]
        return float(v) if bool((d0 == v).all()) else None

    def matvec(self, v: np.ndarray) -> np.ndarray:
        V = v.reshape(self.dims)
        y = np.zeros_like(V)
        for t in range(len(self.offs)):
            y += self.data[t] * _shift(V, self.offs[t])
        return y.reshape(-1)

    def power_lam(self, iters: int = 10) -> float:
        """Power-iteration estimate of lambda_max(D^-1 A) (+5% margin).

        Tighter than Gershgorin for wide coarse stencils (measured 2 PCG
        iterations at depth 5); costs iters stencil matvecs.
        """
        d = self.diagonal()
        with np.errstate(divide="ignore"):
            dinv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
        rng = np.random.default_rng(0)
        x = rng.standard_normal(self.n)
        lam = self.gershgorin()
        for _ in range(iters):
            y = dinv * self.matvec(x)
            nrm = float(np.linalg.norm(y))
            if nrm == 0:
                break
            lam = nrm
            x = y / nrm
        return min(lam * 1.05, self.gershgorin())


def _find_zero_offset(offs: np.ndarray) -> int:
    t = np.flatnonzero((offs == 0).all(axis=1))
    if len(t) != 1:
        raise ValueError("stencil has no diagonal offset")
    return int(t[0])


def _strides(dims) -> np.ndarray:
    """Row-major strides."""
    d = len(dims)
    s = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        s[k] = s[k + 1] * dims[k + 1]
    return s


def from_csr(A: sp.spmatrix, dims) -> LatticeOp | None:
    """Decode a row-major-lattice CSR into stencil form, or None.

    Returns None when the linear offsets cannot be unambiguously decoded
    into small vector offsets (reach too large for the lattice), or when
    decoded entries land outside the lattice (the matrix graph is not the
    lattice stencil it claims to be) — callers fall back to the generic
    sparse path.
    """
    dims = tuple(int(x) for x in dims)
    n = int(np.prod(dims))
    C = A.tocsr()
    if C.shape[0] != n:
        return None
    coo = C.tocoo()
    off_lin = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq = np.unique(off_lin)
    strides = _strides(dims)
    d = len(dims)
    # balanced decode: off = sum o_k * stride_k with small |o_k|
    vecs = np.zeros((len(uniq), d), dtype=np.int64)
    rem = uniq.copy()
    for k in range(d):
        o = np.round(rem / strides[k]).astype(np.int64)
        vecs[:, k] = o
        rem = rem - o * strides[k]
    if (rem != 0).any():
        return None
    # decode is unique only when the reach is well inside the lattice
    reach = np.abs(vecs).max(axis=0)
    if any(2 * int(r) + 1 > dims[k] for k, r in enumerate(reach)):
        return None
    slot = np.searchsorted(uniq, off_lin)  # uniq is sorted
    data = np.zeros((len(uniq), n), dtype=np.float64)
    # accumulate: non-canonical CSR may store duplicate (row, col) entries
    np.add.at(data, (slot, coo.row), coo.data)
    data = data.reshape((len(uniq),) + dims)
    op = LatticeOp(dims=dims, offs=vecs, data=data)
    # validate: entries whose decoded column is out of lattice must be zero
    for t in range(len(uniq)):
        if _out_of_range_mass(op, t) != 0.0:
            return None
    return op


def from_dia(A: sp.dia_matrix, dims) -> LatticeOp | None:
    """Decode a scipy DIA matrix on a row-major lattice (no COO expansion).

    The natural input format for structured problems: per-diagonal data
    maps to stencil rows by a shifted slice (scipy stores data[d, j] =
    A[j - off, j], i.e. indexed by column).
    """
    dims = tuple(int(x) for x in dims)
    n = int(np.prod(dims))
    if A.shape[0] != n:
        return None
    offs_lin = np.asarray(A.offsets, dtype=np.int64)
    order = np.argsort(offs_lin)
    strides = _strides(dims)
    d = len(dims)
    vecs = np.zeros((len(offs_lin), d), dtype=np.int64)
    rem = offs_lin[order].copy()
    for k in range(d):
        o = np.round(rem / strides[k]).astype(np.int64)
        vecs[:, k] = o
        rem = rem - o * strides[k]
    if (rem != 0).any():
        return None
    reach = np.abs(vecs).max(axis=0)
    if any(2 * int(r) + 1 > dims[k] for k, r in enumerate(reach)):
        return None
    # np.empty + edge zeroing: halves the memory traffic of the ingest
    # (zeros() writes the full 0.5 GB at 10M rows before the copy does)
    data = np.empty((len(offs_lin), n), dtype=np.float64)
    for t, src in enumerate(order):
        off = int(offs_lin[src])
        lo_r, hi_r = max(0, -off), min(n, n - off)
        data[t, :lo_r] = 0.0
        data[t, max(hi_r, 0) :] = 0.0
        if hi_r > lo_r:
            data[t, lo_r:hi_r] = A.data[src, lo_r + off : hi_r + off]
    op = LatticeOp(
        dims=dims, offs=vecs, data=data.reshape((len(offs_lin),) + dims)
    )
    for t in range(len(offs_lin)):
        if _out_of_range_mass(op, t) != 0.0:
            return None  # entries wrap lattice rows: not a lattice stencil
    return op


def uniform_from_dia(A: sp.dia_matrix, dims):
    """Detect an exactly-uniform clipped stencil directly on DIA arrays.

    The dominant ingest path (constant-coefficient lattice problems)
    previously materialized the full (noffs, n) LatticeOp data — ~1.2 GB
    of FIRST-TOUCH pages at 10M rows, which this host faults in at only
    ~170 MB/s (measured: the same copies run 15x faster on warm pages).
    This check reads A.data through ONE reusable row buffer and returns
    (offs, vals) — the `detect_uniform` result — without ever building
    the LatticeOp; None when the matrix is not an exactly-uniform clipped
    lattice stencil (callers fall back to `from_dia`).
    """
    dims = tuple(int(x) for x in dims)
    n = int(np.prod(dims))
    if A.shape[0] != n:
        return None
    offs_lin = np.asarray(A.offsets, dtype=np.int64)
    order = np.argsort(offs_lin)
    strides = _strides(dims)
    d = len(dims)
    vecs = np.zeros((len(offs_lin), d), dtype=np.int64)
    rem = offs_lin[order].copy()
    for k in range(d):
        o = np.round(rem / strides[k]).astype(np.int64)
        vecs[:, k] = o
        rem = rem - o * strides[k]
    if (rem != 0).any():
        return None
    reach = np.abs(vecs).max(axis=0)
    if any(2 * int(r) + 1 > dims[k] for k, r in enumerate(reach)):
        return None
    buf = np.zeros(n, dtype=np.float64)
    D = buf.reshape(dims)
    vals = np.empty(len(offs_lin))
    for t, src in enumerate(order):
        off = int(offs_lin[src])
        lo_r, hi_r = max(0, -off), min(n, n - off)
        buf[:lo_r] = 0.0
        buf[max(hi_r, 0):] = 0.0
        if hi_r > lo_r:
            buf[lo_r:hi_r] = A.data[src, lo_r + off: hi_r + off]
        sl = []
        for k, o in enumerate(vecs[t]):
            lo = max(0, -int(o))
            hi = dims[k] - max(0, int(o))
            if hi <= lo:
                sl = None
                break
            sl.append(slice(lo, hi))
        if sl is not None:
            box = D[tuple(sl)]
            v0 = box.flat[0]
            if not (box == v0).all():
                return None
            vals[t] = v0
        else:
            vals[t] = 0.0
        # entries outside the clip box (incl. lattice-wrapping rows) must
        # be zero — the same validation from_dia does, on slab views
        probe = LatticeOp(dims=dims, offs=vecs[t: t + 1], data=D[None])
        if _out_of_range_mass(probe, 0) != 0.0:
            return None
    return vecs, vals


def _out_of_range_mass(op: LatticeOp, t: int) -> float:
    """Max |data| over cells whose column x+off lies outside the lattice.

    The complement of the in-range box is the union of per-axis slabs
    (index < lo or >= hi with other axes unrestricted), so the max is
    taken over thin slab VIEWS — no full-size boolean mask / fancy
    indexing (those dominated stencil ingest at 10M rows).
    """
    D = op.data[t]
    out = 0.0
    for k, o in enumerate(op.offs[t]):
        lo = max(0, -int(o))
        hi = op.dims[k] - max(0, int(o))
        if lo > 0:
            sl = [slice(None)] * len(op.dims)
            sl[k] = slice(0, lo)
            v = D[tuple(sl)]
            if v.size:
                out = max(out, float(np.abs(v).max()))
        if hi < op.dims[k]:
            sl = [slice(None)] * len(op.dims)
            sl[k] = slice(hi, None)
            v = D[tuple(sl)]
            if v.size:
                out = max(out, float(np.abs(v).max()))
    return out


def _mask_out_of_range(op: LatticeOp) -> None:
    """Zero data at cells whose column falls outside the lattice."""
    for t in range(len(op.offs)):
        keep = np.zeros(op.dims, dtype=bool)
        sl = []
        for k, o in enumerate(op.offs[t]):
            lo = max(0, -int(o))
            hi = op.dims[k] - max(0, int(o))
            sl.append(slice(lo, max(hi, lo)))
        keep[tuple(sl)] = True
        op.data[t][~keep] = 0.0


def to_csr(op: LatticeOp) -> sp.csr_matrix:
    """Materialize as scipy CSR (small levels / tests)."""
    n = op.n
    strides = _strides(op.dims)
    rows_l, cols_l, vals_l = [], [], []
    base = np.arange(n, dtype=np.int64)
    for t in range(len(op.offs)):
        v = op.data[t].reshape(-1)
        nzm = v != 0
        off_lin = int((op.offs[t] * strides).sum())
        rows_l.append(base[nzm])
        cols_l.append(base[nzm] + off_lin)
        vals_l.append(v[nzm])
    A = sp.coo_matrix(
        (
            np.concatenate(vals_l) if vals_l else [],
            (
                np.concatenate(rows_l) if rows_l else [],
                np.concatenate(cols_l) if cols_l else [],
            ),
        ),
        shape=(n, n),
    ).tocsr()
    A.sum_duplicates()
    return A


def to_dia_arrays(op: LatticeOp):
    """(linear_offsets (m',), data (m', n)) for the device DiaMatrix.

    Distinct vector offsets can share a linear offset on small lattices;
    at any row at most one of them is in-range (its data nonzero), so
    summing collided rows is exact.
    """
    strides = _strides(op.dims)
    lin = (op.offs * strides).sum(axis=1)
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    uniq, first = np.unique(lin_s, return_index=True)
    n = op.n
    flat = op.data.reshape(len(op.offs), n)
    out = np.empty((len(uniq), n), dtype=np.float64)
    for u in range(len(uniq)):
        hi = first[u + 1] if u + 1 < len(uniq) else len(lin_s)
        sel = order[first[u] : hi]
        out[u] = flat[sel].sum(axis=0) if len(sel) > 1 else flat[sel[0]]
    return uniq, out


# ---------------------------------------------------------------------------
# polyphase helpers
# ---------------------------------------------------------------------------


def _poly(F: np.ndarray, s, mc) -> np.ndarray:
    """Parity component: out[q] = F[2q + s] (zero where 2q+s out of range)."""
    dims = F.shape
    d = len(dims)
    pad_shape = tuple(2 * m for m in mc)
    if pad_shape != dims:
        Fp = np.zeros(pad_shape, dtype=F.dtype)
        Fp[tuple(slice(0, dims[k]) for k in range(d))] = F
    else:
        Fp = F
    inter = []
    for k in range(d):
        inter += [mc[k], 2]
    V = Fp.reshape(inter)
    idx = tuple(
        itertools.chain.from_iterable(
            (slice(None), int(s[k])) for k in range(d)
        )
    )
    return np.ascontiguousarray(V[idx])


def _shift(a: np.ndarray, h) -> np.ndarray:
    """out[q] = a[q + h], zero-filled."""
    if all(x == 0 for x in h):
        return a
    out = np.zeros_like(a)
    src, dst = [], []
    for k, hk in enumerate(h):
        hk = int(hk)
        m = a.shape[k]
        lo_d, hi_d = max(0, -hk), min(m, m - hk)
        if hi_d <= lo_d:
            return out
        dst.append(slice(lo_d, hi_d))
        src.append(slice(lo_d + hk, hi_d + hk))
    out[tuple(dst)] = a[tuple(src)]
    return out


def _shift_add(acc: np.ndarray, a: np.ndarray, h) -> None:
    """acc += shift(a, h) without the temporary."""
    src, dst = [], []
    for k, hk in enumerate(h):
        hk = int(hk)
        m = a.shape[k]
        lo_d, hi_d = max(0, -hk), min(m, m - hk)
        if hi_d <= lo_d:
            return
        dst.append(slice(lo_d, hi_d))
        src.append(slice(lo_d + hk, hi_d + hk))
    acc[tuple(dst)] += a[tuple(src)]


# ---------------------------------------------------------------------------
# the stencil-domain smoothed-prolongation Galerkin product
# ---------------------------------------------------------------------------


def smoothed_rap(op: LatticeOp, omega: float):
    """A_c = P^T A P with P = (I - omega D^-1 A) P_pw, all in stencil form.

    Exact (up to fp roundoff) w.r.t. the scipy product with the explicit P
    of transfer/lattice_transfer.host_lattice_prol — tested against it.
    Returns (coarse LatticeOp, dinv (n,) of the FINE level).
    """
    d = len(op.dims)
    mc = tuple((x + 1) // 2 for x in op.dims)
    diag = op.diagonal().reshape(op.dims)
    with np.errstate(divide="ignore"):
        dinv = np.where(diag > 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)

    parities = list(itertools.product((0, 1), repeat=d))
    zero = (0,) * d
    ones_f = np.ones(op.dims, dtype=np.float64)
    valid = {s: _poly(ones_f, s, mc) for s in parities}
    dpoly = {s: _poly(dinv, s, mc) for s in parities}

    # polyphase extractions of the stencil data, shared by both loops
    # (one strided copy per (offset, parity); None marks all-zero slices)
    apolys: dict = {}
    for t in range(len(op.offs)):
        for s in parities:
            a = _poly(op.data[t], s, mc)
            apolys[(t, s)] = a if a.any() else None

    # phi_{s,w}: P's polyphase components
    phi = {s: {zero: valid[s].copy()} for s in parities}
    for t in range(len(op.offs)):
        k = op.offs[t]
        for s in parities:
            w = tuple(int((s[i] + k[i]) // 2) for i in range(d))
            apoly = apolys[(t, s)]
            if apoly is None:
                continue
            tgt = phi[s].setdefault(w, np.zeros(mc))
            tgt -= omega * dpoly[s] * apoly

    # AP polyphase
    ap: dict = {s: {} for s in parities}
    for t in range(len(op.offs)):
        k = op.offs[t]
        for s in parities:
            apoly = apolys[(t, s)]
            if apoly is None:
                continue
            s2 = tuple((s[i] + int(k[i])) % 2 for i in range(d))
            h = tuple(int((s[i] + k[i]) // 2) for i in range(d))
            for w, ph in phi[s2].items():
                v = tuple(w[i] + h[i] for i in range(d))
                tgt = ap[s].setdefault(v, None)
                contrib = apoly * _shift(ph, h)
                ap[s][v] = contrib if tgt is None else tgt + contrib

    # A_c[c, c+e] = sum_{s,w} phi_{s,w}[c-w] * AP_{s,w+e}[c-w]
    ac: dict = {}
    for s in parities:
        for w, ph in phi[s].items():
            neg_w = tuple(-x for x in w)
            for v, apv in ap[s].items():
                e = tuple(v[i] - w[i] for i in range(d))
                tgt = ac.get(e)
                if tgt is None:
                    tgt = ac[e] = np.zeros(mc)
                _shift_add(tgt, ph * apv, neg_w)

    offs_c = np.array(sorted(ac.keys()), dtype=np.int64)
    data_c = np.stack([ac[tuple(e)] for e in offs_c], axis=0)
    opc = LatticeOp(dims=mc, offs=offs_c, data=data_c)
    _mask_out_of_range(opc)
    _symmetrize(opc)
    return opc, dinv.reshape(-1)


def _symmetrize(op: LatticeOp) -> None:
    """data_e[c] <- (data_e[c] + data_{-e}[c+e]) / 2 (fp-roundoff cleanup)."""
    key = {tuple(int(x) for x in op.offs[t]): t for t in range(len(op.offs))}
    done = set()
    for t in range(len(op.offs)):
        e = tuple(int(x) for x in op.offs[t])
        ne = tuple(-x for x in e)
        if e in done or ne not in key:
            continue
        done.add(e)
        done.add(ne)
        t2 = key[ne]
        avg = 0.5 * (op.data[t] + _shift(op.data[t2], e))
        op.data[t] = avg
        op.data[t2] = _shift(avg, ne)
    _mask_out_of_range(op)


# ---------------------------------------------------------------------------
# uniform-lattice compression (clamp-structured hierarchy on patches)
# ---------------------------------------------------------------------------
#
# A uniform clipped stencil (constant coefficients, Dirichlet-eliminated
# boundary) generates a hierarchy whose per-level data depends only on the
# clamped distance to each face: boundary bands + a constant interior. Such
# levels are represented by a small PATCH operator plus per-dim index maps
# (full index -> patch index); every setup product (RAP, prune, Gershgorin)
# runs on the patch at O(patch) cost and expands only when the device needs
# the full arrays. Exactness (bitwise vs the uncompressed pipeline) is
# asserted by tests: the polyphase RAP is per-cell independent, so patch
# rows compute the identical scalar op sequences as their full-lattice
# counterparts.


@dataclass
class ClampedOp:
    """Clamp-structured lattice level: patch + per-dim expansion maps."""

    patch: LatticeOp
    dims: tuple  # full lattice extents
    maps: tuple  # per-dim int64 arrays: full index -> patch index
    bands: tuple  # per-dim (bn, bf): leading/trailing non-constant bands

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def offs(self) -> np.ndarray:
        return self.patch.offs

    @property
    def nnz(self) -> int:
        w = [np.bincount(m, minlength=self.patch.dims[k]).astype(np.float64)
             for k, m in enumerate(self.maps)]
        W = w[0]
        for wk in w[1:]:
            W = np.multiply.outer(W, wk)
        return int(round(((self.patch.data != 0) * W).sum()))

    def _expand_field(self, f: np.ndarray) -> np.ndarray:
        return f[np.ix_(*self.maps)]

    def diagonal(self) -> np.ndarray:
        t0 = _find_zero_offset(self.patch.offs)
        return self._expand_field(self.patch.data[t0]).reshape(-1)

    def gershgorin(self) -> float:
        return self.patch.gershgorin()  # exact: same row-value set

    def power_lam(self, iters: int = 10) -> float:
        return self.patch.power_lam(iters)

    def offdiag_abs_sum(self) -> np.ndarray:
        s = np.abs(self.patch.data).sum(axis=0) - np.abs(
            self.patch.data[_find_zero_offset(self.patch.offs)]
        )
        return self._expand_field(s).reshape(-1)

    def constant_diagonal(self) -> float | None:
        return self.patch.constant_diagonal()


def expand(cop: ClampedOp) -> LatticeOp:
    """Materialize the full-lattice operator."""
    data = np.stack(
        [cop._expand_field(cop.patch.data[t]) for t in range(len(cop.offs))]
    )
    return LatticeOp(dims=cop.dims, offs=cop.patch.offs.copy(), data=data)


def detect_uniform(op: LatticeOp) -> np.ndarray | None:
    """Per-offset constant value over each offset's valid region, or None."""
    vals = np.empty(len(op.offs))
    for t in range(len(op.offs)):
        sl = []
        for k, o in enumerate(op.offs[t]):
            lo = max(0, -int(o))
            hi = op.dims[k] - max(0, int(o))
            if hi <= lo:
                sl = None
                break
            sl.append(slice(lo, hi))
        if sl is None:
            vals[t] = 0.0
            continue
        v = op.data[t][tuple(sl)]
        v0 = v.flat[0]
        if not (v == v0).all():
            return None
        vals[t] = v0
    return vals


def synth_uniform(dims, offs: np.ndarray, vals: np.ndarray) -> LatticeOp:
    """Clipped constant stencil on ``dims`` from scalar values."""
    dims = tuple(int(x) for x in dims)
    data = np.zeros((len(offs),) + dims, dtype=np.float64)
    for t in range(len(offs)):
        sl = []
        for k, o in enumerate(offs[t]):
            lo = max(0, -int(o))
            hi = dims[k] - max(0, int(o))
            sl.append(slice(lo, max(hi, lo)))
        data[t][tuple(sl)] = vals[t]
    return LatticeOp(dims=dims, offs=offs.copy(), data=data)


def _detect_bands_1d(data: np.ndarray, axis: int) -> tuple | None:
    """Minimal (bn, bf) with all offsets constant along ``axis`` between."""
    m = data.shape[axis + 1]  # data is (noffs, *dims)
    if m == 1:
        return (0, 0)
    a = np.moveaxis(data, axis + 1, 1).reshape(data.shape[0], m, -1)
    eq = (a[:, :-1, :] == a[:, 1:, :]).all(axis=(0, 2))  # (m-1,) interfaces
    center = (m - 1) // 2
    if not eq[center]:
        return None
    lo = center
    while lo > 0 and eq[lo - 1]:
        lo -= 1
    hi = center
    while hi < m - 2 and eq[hi + 1]:
        hi += 1
    return (lo, m - 2 - hi)


def _maps_from_bands(n_full: int, n_patch: int, bn: int, bf: int):
    """Index map full -> patch: near band, replicated middle, far band."""
    rep = n_patch - bn - bf
    m = np.empty(n_full, dtype=np.int64)
    m[:bn] = np.arange(bn)
    far = n_full - bf
    m[far:] = np.arange(n_patch - bf, n_patch)
    mid = np.arange(bn, far)
    m[bn:far] = bn + (mid - bn) % max(rep, 1)
    return m


def _widen_middle(op: LatticeOp, grow: tuple) -> LatticeOp:
    """Widen the constant middle of each dim by ``grow[k]`` cells.

    Dims with grow[k] == 0 keep an identity map — they need no constant
    middle (small/identity dims have none at coarse levels)."""
    if all(g == 0 for g in grow):
        return op
    maps = []
    for k in range(len(op.dims)):
        if grow[k] == 0:
            maps.append(np.arange(op.dims[k], dtype=np.int64))
            continue
        b = _detect_bands_1d(op.data, k)
        if b is None:
            raise ValueError("cannot widen: no constant middle")
        maps.append(
            _maps_from_bands(op.dims[k] + grow[k], op.dims[k], *b)
        )
    maps = tuple(maps)
    data = np.stack(
        [op.data[t][np.ix_(*maps)] for t in range(len(op.offs))]
    )
    out = LatticeOp(
        dims=tuple(op.dims[k] + grow[k] for k in range(len(op.dims))),
        offs=op.offs.copy(),
        data=data,
    )
    _mask_out_of_range(out)  # widened middle may unclip far-band offsets
    return out


def compress_uniform(dims, offs, vals, margin: int = 4) -> "ClampedOp":
    """ClampedOp for a uniform clipped stencil on a large lattice."""
    dims = tuple(int(x) for x in dims)
    reach = int(np.abs(offs).max()) if len(offs) else 1
    H = 3 * reach + margin
    pdims, maps, bands = [], [], []
    for k, dk in enumerate(dims):
        if dk <= 2 * H + 4:
            pdims.append(dk)
            maps.append(np.arange(dk, dtype=np.int64))
            bands.append((dk, 0))
            continue
        rep = 2 if (dk % 2 == 0) else 3
        pk = 2 * H + rep
        pdims.append(pk)
        maps.append(_maps_from_bands(dk, pk, H, H))
        bands.append((H, H))
    patch = synth_uniform(tuple(pdims), offs, vals)
    return ClampedOp(
        patch=patch, dims=dims, maps=tuple(maps), bands=tuple(bands)
    )


def rap_clamped(cop: ClampedOp, omega: float, prune_tol: float):
    """Coarse level of a clamp-structured level (patch-RAP + band detect).

    Returns a ClampedOp when the coarse level still compresses, else the
    full LatticeOp. Falls back to the exact full-lattice RAP when band
    detection fails (never observed; correctness guard).
    """
    d = len(cop.dims)
    mc = tuple((x + 1) // 2 for x in cop.dims)
    reach = int(np.abs(cop.patch.offs).max()) if len(cop.patch.offs) else 1
    R = 3 * reach + 4
    # widen patch middles so every coarse-row window sees a faithful
    # neighborhood, preserving per-dim parity (grow by multiples of 2)
    grow = []
    for k in range(d):
        if cop.bands[k][0] >= cop.dims[k]:  # identity dim
            grow.append(0)
            continue
        mid = cop.patch.dims[k] - cop.bands[k][0] - cop.bands[k][1]
        need = max(0, 2 * R - mid)
        grow.append(need + (need % 2))
    grow = tuple(
        min(g, cop.dims[k] - cop.patch.dims[k]) // 2 * 2
        for k, g in enumerate(grow)
    )
    try:
        patch = _widen_middle(cop.patch, grow)
    except ValueError:
        # correctness guard (e.g. anisotropic lattices whose small dims
        # lose their constant middle): exact full-lattice fallback
        full = expand(cop)
        opc, _ = smoothed_rap(full, omega)
        return prune(opc, prune_tol)

    opc_p, _ = smoothed_rap(patch, omega)
    opc_p = prune(opc_p, prune_tol)
    if opc_p.dims == mc:
        return opc_p  # patch covers the whole coarse lattice
    # detect coarse clamp bands; adjust parity for the next level
    pbands, maps_c, pdims_c, growc = [], [], [], []
    ok = True
    for k in range(d):
        if opc_p.dims[k] == mc[k]:
            pbands.append((mc[k], 0))
            maps_c.append(np.arange(mc[k], dtype=np.int64))
            pdims_c.append(mc[k])
            growc.append(0)
            continue
        b = _detect_bands_1d(opc_p.data, k)
        if b is None or b[0] + b[1] + 1 > opc_p.dims[k]:
            ok = False
            break
        pbands.append(b)
        g = 1 if (opc_p.dims[k] % 2) != (mc[k] % 2) else 0
        growc.append(g)
        pdims_c.append(opc_p.dims[k] + g)
        maps_c.append(None)  # filled after parity widen
    if not ok:  # correctness guard: exact full-lattice fallback
        full = expand(cop)
        opc, _ = smoothed_rap(full, omega)
        return prune(opc, prune_tol)
    opc_p = _widen_middle(opc_p, tuple(growc))
    for k in range(d):
        if maps_c[k] is None:
            maps_c[k] = _maps_from_bands(mc[k], pdims_c[k], *pbands[k])
    return ClampedOp(
        patch=opc_p, dims=mc, maps=tuple(maps_c), bands=tuple(pbands)
    )


def prune(op: LatticeOp, tol: float) -> LatticeOp:
    """Drop weak offset pairs with row-sum-preserving diagonal lumping.

    Offsets are ranked by max |data|; the weakest are dropped while the
    cumulative dropped row mass stays below ``tol * min(diag)``. Each
    dropped entry is added (signed) to its row's diagonal, preserving row
    sums exactly — essential for AMG quality: the coarse near-kernel
    (constants) energy must not inflate (measured +4 PCG iterations with
    absolute-value lumping at tol=0.01). The SPD perturbation is a graph
    Laplacian of the dropped weights, bounded by 2*tol*min(diag) — small
    against coarse-level lambda_min (long-range prunable entries only
    appear on already-well-conditioned coarse grids); the V-cycle/PCG
    self-tests catch any violation. (Cf. non-Galerkin coarse grids,
    Falgout & Schroder.)
    """
    if tol <= 0 or len(op.offs) <= 1:
        return op
    t0 = _find_zero_offset(op.offs)
    dmin = float(op.data[t0][op.data[t0] > 0].min(initial=np.inf))
    if not np.isfinite(dmin):
        return op
    scores = np.abs(op.data).reshape(len(op.offs), -1).max(axis=1)
    # group into symmetric pairs (dropped atomically)
    key = {tuple(int(x) for x in op.offs[t]): t for t in range(len(op.offs))}
    groups, seen = [], set()
    for t in range(len(op.offs)):
        if t == t0 or t in seen:
            continue
        e = tuple(int(x) for x in op.offs[t])
        ne = tuple(-x for x in e)
        t2 = key.get(ne)
        g = (t,) if t2 is None or t2 == t or t2 in seen else (t, t2)
        seen.update(g)
        groups.append((max(scores[i] for i in g), g))
    groups.sort(key=lambda x: x[0])
    budget = tol * dmin
    drop = np.zeros(len(op.offs), dtype=bool)
    spent = 0.0
    for sc, g in groups:
        if sc + spent > budget:
            break
        for i in g:
            drop[i] = True
        spent += sc
    if not drop.any():
        return op
    # signed lump onto the diagonal preserves every row sum exactly
    lump = op.data[drop].sum(axis=0)
    data = op.data[~drop].copy()
    offs = op.offs[~drop].copy()
    t0n = _find_zero_offset(offs)
    data[t0n] += lump
    return LatticeOp(dims=op.dims, offs=offs, data=data)
