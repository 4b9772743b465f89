"""Device sparse matrix formats + the `matvec` dispatch.

The solve phase picks a per-level format that avoids or amortizes
gathers:

* :class:`DiaMatrix` — diagonal storage. y = sum_d diag_d * shift(x, off_d):
  every term is a contiguous static slice + FMA; zero gathers.
  Optimal for the (natural-ordered) finest FEM level, whose stencil has a
  few dozen distinct offsets. The reference's scalar CSR SpMV plays this
  role on CPU (utils_sparseMM.hpp).
* :class:`BlockELL` (bell.py) — padded block-ELL; gathers block rows of x.
  For scalar (bs=1) unstructured levels the rows are *supernoded* into
  8x8 tiles first (scipy BSR regrouping), cutting gather count 64x and
  turning the work into small dense blocks — the analog of the
  reference's `DynBlockSparseMatrix` row-fusion idea (dyn_block.hpp:109).
* :class:`DenseMatrix` — replicated dense matvec for small coarse levels
  (the reference's coarse direct-solve regime).

The solve traces these products under `utils.jaxcfg.full_f32` (full f32,
no TF32); see that function for why.

`matvec(A, x)` dispatches on the static pytree type inside jit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .bell import BlockELL, spmv as _bell_spmv
from . import bell as _bell


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["offsets", "nrows", "nrows_pad", "sym_half"],
)
@dataclass(frozen=True)
class DiaMatrix:
    """Diagonal-storage sparse matrix (square, scalar entries).

    data[d, i] = A[i, i + offsets[d]] (zero where out of range); the row
    dimension is padded to ``nrows_pad``. Vectors are (nrows_pad, 1) block
    vectors like everywhere else.

    ``sym_half``: only the offsets >= 0 diagonals are stored; the minus
    direction is read from the positive arrays by exact symmetry
    (data[-o][i] = data[o][i - o], verified at construction) — halves the
    HBM footprint and host->device shipping of symmetric operators.
    """

    data: jax.Array  # (ndiag, nrows_pad)
    offsets: tuple  # static ints, ascending
    nrows: int
    nrows_pad: int
    sym_half: bool = False

    @property
    def shape(self):
        return self.nrows, self.nrows

    def __matmul__(self, x):
        return matvec(self, x)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["nrows", "nrows_pad", "bs"],
)
@dataclass(frozen=True)
class DenseMatrix:
    """Dense square matrix acting on (nrows_pad, bs) block vectors."""

    data: jax.Array  # (nrows_pad*bs, nrows_pad*bs)
    nrows: int  # logical block rows
    nrows_pad: int
    bs: int

    def __matmul__(self, x):
        return matvec(self, x)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["inner"],
    meta_fields=["nrows", "nrows_pad", "tile_r", "tile_c"],
)
@dataclass(frozen=True)
class SupernodeELL:
    """Scalar matrix regrouped into (tile_r x tile_c) dense tiles (ELL).

    Wraps a BlockELL whose "block size" is the supernode tile; matvec
    reshapes the (n_pad, 1) scalar block vector into tile_c-wide tiles,
    applies the tiled SpMV (few, wide gathers + small dense matmuls),
    and reshapes back. Works for square operators and
    rectangular transfers; scalar (bs = 1) operators only.
    """

    inner: BlockELL
    nrows: int  # logical scalar rows
    nrows_pad: int  # padded scalar rows (output vector length)
    tile_r: int
    tile_c: int

    def __matmul__(self, x):
        return matvec(self, x)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["vals"],
    meta_fields=["offs", "dims", "nrows", "nrows_pad"],
)
@dataclass(frozen=True)
class StencilDia:
    """Uniform clipped stencil: scalar values + vector offsets, ZERO data.

    The format for constant-coefficient lattice levels (detected by
    transfer/stencil.detect_uniform): y = sum_t vals[t] * shift_nd(x, off_t)
    where the n-d zero-filled shifts implement the Dirichlet clipping
    exactly. No per-row data is stored or transferred — 8x less HBM traffic
    than DIA on a 7-point finest level and no host->device shipping.
    """

    vals: jax.Array  # (m,) stencil values
    offs: tuple  # m d-tuples (static)
    dims: tuple  # lattice extents
    nrows: int
    nrows_pad: int

    @property
    def shape(self):
        return self.nrows, self.nrows

    def __matmul__(self, x):
        return matvec(self, x)


def _stencil_dia_matvec(A: StencilDia, x: jax.Array) -> jax.Array:
    """Zero-padded n-d shifts + FMAs; XLA fuses the pad, the shifted
    slices and the sum into one pass over x."""
    d = len(A.dims)
    xf = x[: A.nrows, 0].reshape(A.dims)
    r = [max(abs(int(o[k])) for o in A.offs) for k in range(d)]
    xp = jnp.pad(xf, [(r[k], r[k]) for k in range(d)])
    y = jnp.zeros_like(xf)
    for t, off in enumerate(A.offs):
        sl = tuple(
            slice(r[k] + int(off[k]), r[k] + int(off[k]) + A.dims[k])
            for k in range(d)
        )
        y = y + A.vals[t] * xp[sl]
    yf = y.reshape(-1)
    return jnp.pad(yf, (0, A.nrows_pad - A.nrows))[:, None]


def f64_matvec_slabs(A, target_bytes: int = 300 * 1024 * 1024) -> int:
    """Row-slab count bounding f64 matvec temporaries.

    An f64 gather+einsum that materializes its gathered operand holds a
    transient as large as the f64 data; the count cuts the matvec into
    slabs of at most ``target_bytes`` of it, so the live-range allocator
    reuses one slab's temporaries for the next. (On an H100 XLA fuses the
    gather into the product: the f64 matvec of the 1.11 GB BlockELL of
    1.25M-DoF 3D elasticity compiles with no temporaries unslabbed, and
    with 36 MB and 54 MB in 2 and 4 slabs, so there the slabs only cost.)
    """
    data = getattr(A, "data", None)
    if isinstance(A, SupernodeELL):
        data = A.inner.data
    if isinstance(A, TileELLStack):
        data = max((b.data for b in A.blocks), key=lambda d: d.size)
    if data is None or jnp.dtype(data.dtype) != jnp.float64:
        return 1
    return max(1, -(-data.size * 8 // target_bytes))


def matvec_slabbed(A, x: jax.Array, nslabs: int) -> jax.Array:
    """y = A @ x computed in ``nslabs`` sequential row slabs.

    Semantically identical to :func:`matvec`; bounds peak HLO-temp
    memory to O(1/nslabs) for formats with per-row data (the f64 path —
    see :func:`f64_matvec_slabs`). Formats without per-row
    data (StencilDia) or with their own slab path fall through to the
    plain matvec.
    """
    if nslabs <= 1:
        return matvec(A, x)
    if isinstance(A, SupernodeELL):
        xt = x.reshape(-1, A.tile_c)
        yt = matvec_slabbed(A.inner, xt, nslabs)
        return yt.reshape(-1, 1)
    if isinstance(A, BlockELL):
        n = A.data.shape[0]
        slab = -(-n // nslabs)
        slab = -(-slab // 8) * 8
        xw = (
            x.reshape(-1, A.col_chunk * x.shape[1])
            if A.col_chunk > 1
            else x
        )
        ys = []
        a = 0
        while a < n:
            b = min(a + slab, n)
            xg = xw[A.cols[a:b]]
            ys.append(
                jnp.einsum(
                    "nkij,nkj->ni", A.data[a:b], xg,
                    preferred_element_type=A.data.dtype,
                )
            )
            a = b
        return jnp.concatenate(ys)
    if isinstance(A, TileELLStack):
        total = sum(b.data.shape[0] for b in A.blocks)
        ys = []
        for blk in A.blocks:
            ns = max(1, round(nslabs * blk.data.shape[0] / max(total, 1)))
            ys.append(_tile_ell_matvec_slabbed(blk, x, ns))
        return jnp.concatenate(ys)
    if isinstance(A, TileELL):
        return _tile_ell_matvec_slabbed(A, x, nslabs)
    return matvec(A, x)


def _tile_ell_matvec_slabbed(A: TileELL, x: jax.Array, nslabs: int):
    T = A.data.shape[0]
    slab = max(1, -(-T // nslabs))
    ys = []
    a = 0
    while a < T:
        b = min(a + slab, T)
        if A.chunk_c > 1:
            xc = x[:, 0].reshape(-1, A.chunk_c)[A.cols[a:b]]
            y = jnp.einsum(
                "tkcm,tkc->tm", A.data[a:b], xc,
                preferred_element_type=A.data.dtype,
            )
        else:
            xg = x[:, 0][A.cols[a:b]]
            y = jnp.einsum(
                "tkm,tk->tm", A.data[a:b], xg,
                preferred_element_type=A.data.dtype,
            )
        ys.append(y.reshape(-1))
        a = b
    return jnp.concatenate(ys)[:, None]


def matvec(A, x: jax.Array) -> jax.Array:
    """y = A @ x for any device sparse/dense format; x: (nrows_pad, bs)."""
    if isinstance(A, BlockELL):
        return _bell_spmv(A, x)
    if isinstance(A, DiaMatrix):
        return _dia_matvec(A, x)
    if isinstance(A, StencilDia):
        return _stencil_dia_matvec(A, x)
    if isinstance(A, DenseMatrix):
        n, bs = x.shape
        y = jnp.dot(
            A.data, x.reshape(-1), preferred_element_type=A.data.dtype
        )
        return y.reshape(n, bs)
    if isinstance(A, TileELL):
        return _tile_ell_matvec(A, x)
    if isinstance(A, TileELLStack):
        return _tile_ell_stack_matvec(A, x)
    if isinstance(A, SupernodeELL):
        xt = x.reshape(-1, A.tile_c)
        yt = _bell_spmv(A.inner, xt)
        return yt.reshape(-1, 1)
    from ..transfer.lattice_transfer import (
        LatticeProlongation,
        LatticeRestriction,
        lattice_prol_apply,
        lattice_restrict_apply,
    )

    if isinstance(A, LatticeProlongation):
        return lattice_prol_apply(A, x)
    if isinstance(A, LatticeRestriction):
        return lattice_restrict_apply(A, x)
    # interface-halo formats (parallel/halo.py) carry their own shard_map
    # apply; duck-typed to keep sparse/ free of parallel/ imports
    hm = getattr(A, "halo_matvec", None)
    if hm is not None:
        return hm(x)
    raise TypeError(type(A))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "cols"],
    meta_fields=["nrows", "nrows_pad", "ncols_pad", "tile_m", "chunk_c"],
)
@dataclass(frozen=True)
class TileELL:
    """Tile-ELL: M-row tiles sharing one DISTINCT-column slot list.

    data[t, k, m] = A[t*M + m, cols[t, k]] (zero where absent). The
    matvec gathers ONE x scalar per (tile, slot) — T*K indices instead of
    one per nonzero — and runs a dense (K, M) FMA per tile.
    For mesh matrices 8 consecutive (RCM/natural-ordered) rows share most
    of their column support, so K stays near the single-row degree and
    storage lands at ~2-4x the raw nnz — an order of magnitude below the
    8x8 supernode fill on the same graphs, which dominates both the
    host->device shipping and the per-sweep HBM traffic.

    Reference role: the scalar CSR SpMV of the reference's solve phase
    (utils_sparseLA.hpp SparseMatrix::Mult) for unstructured levels.
    """

    data: jax.Array  # (T, K, M) scalar slots, or (T, K, C, M) chunked
    cols: jax.Array  # (T, K) int32: scalar index (C==1) or chunk index
    nrows: int  # logical output rows
    nrows_pad: int  # == T * M
    ncols_pad: int  # padded input vector length (multiple of chunk_c)
    tile_m: int
    chunk_c: int = 1  # column-chunk width gathered per slot

    @property
    def shape(self):
        return self.nrows, self.ncols_pad

    def __matmul__(self, x):
        return matvec(self, x)


def _tile_ell_matvec(A: TileELL, x: jax.Array) -> jax.Array:
    if A.chunk_c > 1:
        # chunked slots: gather C consecutive x scalars per slot — one
        # index fetch per C scalars, so the gather bill drops by the
        # chunk fill factor
        xc = x[:, 0].reshape(-1, A.chunk_c)[A.cols]  # (T, K, C)
        y = jnp.einsum(
            "tkcm,tkc->tm", A.data, xc,
            preferred_element_type=A.data.dtype,
        )
        return y.reshape(-1)[:, None]
    xg = x[:, 0][A.cols]  # (T, K) gather — one scalar per slot
    y = jnp.einsum(
        "tkm,tk->tm", A.data, xg,
        preferred_element_type=A.data.dtype,
    )
    return y.reshape(-1)[:, None]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks"],
    meta_fields=["nrows", "nrows_pad", "ncols_pad", "tile_m"],
)
@dataclass(frozen=True)
class TileELLStack:
    """Bucketed TileELL: contiguous tile ranges with per-bucket slot
    counts.

    One global K (the max tile column-union) wastes ~2x storage and
    gathers on mesh matrices whose union distribution has a long tail
    (K_max 133 vs mean 72 on a 1.19M-DoF tet mesh). Rows are
    pre-permuted so tiles sort by descending union (plan_reorder); each
    bucket is a standalone TileELL over its contiguous row range and the
    matvec concatenates bucket outputs — a few extra ops for ~2x less
    HBM traffic and gather volume."""

    blocks: tuple  # tuple[TileELL, ...] over contiguous row ranges
    nrows: int
    nrows_pad: int  # == sum(b.nrows_pad)
    ncols_pad: int
    tile_m: int

    @property
    def shape(self):
        return self.nrows, self.ncols_pad

    def __matmul__(self, x):
        return matvec(self, x)


def _tile_ell_stack_matvec(A: TileELLStack, x: jax.Array) -> jax.Array:
    return jnp.concatenate([_tile_ell_matvec(b, x) for b in A.blocks])


def _dia_matvec(A: DiaMatrix, x: jax.Array) -> jax.Array:
    """Shift-and-FMA: one fused loop, no gathers."""
    n = A.nrows_pad
    xf = x[:, 0]
    if A.sym_half:
        hi = max(A.offsets[-1], 0)
        xp = jnp.pad(xf, (hi, hi))
        y = jnp.zeros_like(xf)
        for d, off in enumerate(A.offsets):
            y = y + A.data[d] * jax.lax.dynamic_slice_in_dim(
                xp, hi + off, n
            )
            if off > 0:
                # A[i, i-o] = data[o][i-o]; the zero pad of the shifted
                # data supplies the i < o mask
                dp = jnp.pad(A.data[d], (hi, hi))
                y = y + jax.lax.dynamic_slice_in_dim(
                    dp, hi - off, n
                ) * jax.lax.dynamic_slice_in_dim(xp, hi - off, n)
        return y[:, None]
    lo = -min(A.offsets[0], 0)
    hi = max(A.offsets[-1], 0)
    xp = jnp.pad(xf, (lo, hi))
    y = jnp.zeros_like(xf)
    for d, off in enumerate(A.offsets):
        y = y + A.data[d] * jax.lax.dynamic_slice_in_dim(xp, lo + off, n)
    return y[:, None]


# ---------------------------------------------------------------------------
# host-side construction / format selection
# ---------------------------------------------------------------------------


# symmetric halving pays off once shipping/residency dominate
_DIA_SYM_MIN_ROWS = 100_000

def dia_from_scipy(
    A: sp.spmatrix,
    dtype,
    row_align: int = 8,
    stage: bool = False,
) -> DiaMatrix:
    C = A.tocsr()
    n = C.shape[0]
    n_pad = -(-n // row_align) * row_align
    coo = C.tocoo()
    off_all = coo.col.astype(np.int64) - coo.row
    offs = _unique_offsets(off_all, n)
    # O(nnz) slot lookup instead of a searchsorted per entry
    b = int(max(-offs[0], offs[-1], 0))
    lut = np.zeros(2 * b + 1, dtype=np.int32)
    lut[offs + b] = np.arange(len(offs), dtype=np.int32)
    data = np.zeros((len(offs), n_pad), dtype=np.dtype(dtype))
    data[lut[off_all + b], coo.row] = coo.data
    arr = data if stage else jnp.asarray(data)
    return DiaMatrix(
        data=arr,
        offsets=tuple(int(o) for o in offs),
        nrows=n,
        nrows_pad=n_pad,
    )


def dia_from_stencil(
    op, dtype, row_align: int = 8, stage: bool = False
) -> DiaMatrix:
    """DiaMatrix straight from a stencil-form level (transfer/stencil.py).

    Skips the CSR detour entirely: linear offsets and per-row data come out
    of the lattice layout directly.
    """
    n = op.n
    n_pad = -(-n // row_align) * row_align
    from ..transfer.stencil import to_dia_arrays

    offs, raw = to_dia_arrays(op)
    data = np.zeros((len(offs), n_pad), dtype=np.dtype(dtype))
    data[:, :n] = raw
    arr = data if stage else jnp.asarray(data)
    return DiaMatrix(
        data=arr,
        offsets=tuple(int(o) for o in offs),
        nrows=n,
        nrows_pad=n_pad,
    )


def format_from_stencil(
    stc, dtype, row_align: int = 8, stage: bool = False
):
    """Device format for a stencil-form level (LatticeOp or ClampedOp).

    Uniform clipped stencils become :class:`StencilDia` (zero data
    transfer); clamp-compressed levels expand straight into padded DIA
    rows; plain stencil levels use :func:`dia_from_stencil`.
    """
    from ..transfer.stencil import ClampedOp, detect_uniform

    if isinstance(stc, ClampedOp):
        vals = detect_uniform(stc.patch)
        if vals is not None:
            n = stc.n
            n_pad = -(-n // row_align) * row_align
            v = np.asarray(vals, dtype=np.dtype(dtype))
            return StencilDia(
                vals=v if stage else jnp.asarray(v),
                offs=tuple(tuple(int(x) for x in o) for o in stc.offs),
                dims=tuple(stc.dims),
                nrows=n,
                nrows_pad=n_pad,
            )
        return dia_from_clamped(stc, dtype, row_align, stage=stage)
    return dia_from_stencil(stc, dtype, row_align, stage=stage)


def dia_from_clamped(
    cop, dtype, row_align: int = 8, stage: bool = False
) -> DiaMatrix:
    """DiaMatrix from a clamp-compressed level: expand each offset's field
    directly into the padded device array (no full f64 intermediate)."""
    from ..transfer.stencil import _strides

    n = cop.n
    n_pad = -(-n // row_align) * row_align
    strides = _strides(cop.dims)
    lin = (cop.offs * strides).sum(axis=1)
    order = np.argsort(lin, kind="stable")
    uniq, first = np.unique(lin[order], return_index=True)
    # np.empty + per-row assignment: a zeros() prefill writes the whole
    # (noffs, n_pad) array through slow first-touch faults before the
    # expansion writes it AGAIN; expanding from a dtype-cast patch keeps
    # every gather/temp in the (half-width) target dtype
    dt = np.dtype(dtype)
    patch_cast = cop.patch.data.astype(dt, copy=False)
    data = np.empty((len(uniq), n_pad), dtype=dt)
    for u in range(len(uniq)):
        hi = first[u + 1] if u + 1 < len(uniq) else len(order)
        ts = order[first[u]: hi]
        field = patch_cast[ts[0]][np.ix_(*cop.maps)].reshape(-1)
        for t in ts[1:]:
            field = field + patch_cast[t][np.ix_(*cop.maps)].reshape(-1)
        data[u, :n] = field
        data[u, n:] = 0
    # symmetric halving: drop the negative diagonals when every +-pair
    # verifies data[-o][o:] == data[o][:-o] exactly (the coarse operators
    # are explicitly symmetrized) — halves shipping + HBM residency
    offs_t = tuple(int(o) for o in uniq)
    if n >= _DIA_SYM_MIN_ROWS and 0 < max(offs_t):
        neg = {-o: u for u, o in enumerate(offs_t) if o < 0}
        ok = set(neg) == {o for o in offs_t if o > 0}
        if ok:
            for o in neg:
                up, un = offs_t.index(o), neg[o]
                if not (
                    np.array_equal(data[un, o:n], data[up, : n - o])
                    and not data[un, :o].any()
                ):
                    ok = False
                    break
        if ok:
            keep = [u for u, o in enumerate(offs_t) if o >= 0]
            return DiaMatrix(
                data=(data[keep] if stage else jnp.asarray(data[keep])),
                offsets=tuple(o for o in offs_t if o >= 0),
                nrows=n,
                nrows_pad=n_pad,
                sym_half=True,
            )
    return DiaMatrix(
        data=data if stage else jnp.asarray(data),
        offsets=offs_t,
        nrows=n,
        nrows_pad=n_pad,
    )


def _unique_offsets(off: np.ndarray, n: int) -> np.ndarray:
    """Sorted unique diagonal offsets, O(nnz) via a presence mask."""
    if len(off) == 0:
        return np.zeros(0, dtype=np.int64)
    present = np.zeros(2 * n - 1, dtype=bool)
    present[off + (n - 1)] = True
    return np.flatnonzero(present).astype(np.int64) - (n - 1)


def count_diagonals(A: sp.spmatrix, limit: int | None = None) -> int:
    """Number of distinct diagonals; with ``limit``, an early-out count.

    When ``limit`` is given the exact count is only needed up to it (the
    DIA-eligibility checks): a cheap row-sample that already exceeds the
    limit skips the full O(nnz) offset pass — unstructured matrices at the
    1M+ scale otherwise spend seconds here per setup.
    """
    n = A.shape[0]
    C = A.tocsr() if not sp.issparse(A) or A.format != "csr" else A
    if limit is not None and n > 8192:
        step = max(n // 4096, 1)
        rows = np.arange(0, n, step)
        lo, hi = C.indptr[rows], C.indptr[rows + 1]
        cnt = np.minimum(hi - lo, 64)
        idx = np.concatenate(
            [C.indices[a: a + c] for a, c in zip(lo, cnt)]
        ) if len(rows) else np.zeros(0, np.int64)
        offs = idx.astype(np.int64) - np.repeat(rows, cnt)
        if len(np.unique(offs)) > limit:
            return limit + 1  # definitely not DIA-eligible
    coo = C.tocoo()
    return len(
        _unique_offsets(coo.col.astype(np.int64) - coo.row, n)
    )


def _scipy_compat(dtype):
    """scipy-supported staging dtype (bf16 etc. cast at the final array)."""
    if np.dtype(dtype) in (np.dtype(np.float32), np.dtype(np.float64)):
        return np.dtype(dtype)
    return np.float32


def supernode_from_scipy(
    A: sp.spmatrix,
    dtype,
    tile: int = 8,
    row_align: int = 8,
    stage: bool = False,
    tile_c: int | None = None,
    nr_pad: int | None = None,
    nc_pad: int | None = None,
) -> SupernodeELL:
    """Regroup a scalar-entry matrix into (tile x tile_c) block-ELL.

    For rectangular operators (prolongation/restriction) pass the padded
    scalar row/col counts of the two level interfaces so the tile reshape
    matches the levels' vector layouts exactly.
    """
    tile_c = tile if tile_c is None else tile_c
    nr, nc = A.shape
    align_r = max(tile, row_align)
    if nr_pad is None:
        nr_pad = -(-nr // align_r) * align_r
    if nc_pad is None:
        nc_pad = -(-nc // tile_c) * tile_c
    if nr_pad % tile or nc_pad % tile_c:
        raise ValueError("pad sizes must be multiples of the tiles")
    P = sp.csr_matrix(A.tocsr().astype(_scipy_compat(dtype)), copy=False)
    P.resize((nr_pad, nc_pad))
    B = sp.bsr_matrix(P, blocksize=(tile, tile_c))
    inner = _bell.from_scipy(
        B, tile, tile_c, dtype=dtype, row_align=1, stage=stage
    )
    return SupernodeELL(
        inner=inner,
        nrows=nr,
        nrows_pad=nr_pad,
        tile_r=tile,
        tile_c=tile_c,
    )


def tile_ell_from_scipy(
    A: sp.spmatrix,
    dtype,
    tile_m: int = 8,
    row_align: int = 8,
    stage: bool = False,
    nr_pad: int | None = None,
    nc_pad: int | None = None,
) -> TileELL | None:
    """Pack a scalar matrix into :class:`TileELL` (native packer).

    Returns None when the native extension is absent (callers fall back
    to the supernode format). ``nr_pad``/``nc_pad`` pin the interface
    sizes for rectangular transfers.
    """
    from ..native import tile_ell_pack

    C = A.tocsr()
    nr, nc = C.shape
    align_r = max(tile_m, row_align)
    if nr_pad is None:
        nr_pad = -(-nr // align_r) * align_r
    if nr_pad % tile_m:
        nr_pad = -(-nr_pad // tile_m) * tile_m
    if nc_pad is None:
        nc_pad = -(-nc // row_align) * row_align
    T = nr_pad // tile_m
    res = tile_ell_pack(C, tile_m, T)
    if res is None:
        return None
    data, cols, _K = res
    dt = np.dtype(dtype)
    if data.dtype != dt:
        data = data.astype(dt)
    return TileELL(
        data=data if stage else jnp.asarray(data),
        cols=cols if stage else jnp.asarray(cols),
        nrows=nr,
        nrows_pad=nr_pad,
        ncols_pad=nc_pad,
        tile_m=tile_m,
    )


# Column-chunk width of the bucketed tile-ELL: wider chunks store fewer
# gathered slots (one index per chunk) at the price of zero fill. The
# value is not yet measured on the GPU.
TILE_CHUNK = int(__import__("os").environ.get("NGSAMG_TILE_CHUNK", "8"))
_STACK_MIN_TILES = 512  # merge smaller bucket runs (bounds op count)


def _tile_chunk_counts(C: sp.csr_matrix, tile_m: int, chunk: int, T: int):
    """Distinct column-chunk count per tile (tiles = tile_m-row groups)."""
    from ..native import tile_chunk_counts as _nat_counts

    cnt = _nat_counts(C.indptr, C.indices, tile_m, chunk, T)
    if cnt is not None:
        return cnt
    n = C.shape[0]
    t_rows = min(T * tile_m, n)
    nnz_head = int(C.indptr[t_rows])
    rows = np.repeat(
        np.arange(t_rows, dtype=np.int64), np.diff(C.indptr[: t_rows + 1])
    )
    cc = C.indices[:nnz_head].astype(np.int64) // chunk
    stride = C.shape[1] // chunk + 2
    keys = (rows // tile_m) * stride + cc
    uk = np.unique(keys)
    return np.bincount((uk // stride).astype(np.int64), minlength=T)


def tile_ell_stack_from_scipy(
    A: sp.spmatrix,
    dtype,
    tile_m: int = 8,
    chunk: int = TILE_CHUNK,
    nr_pad: int | None = None,
    nc_pad: int | None = None,
    stage: bool = False,
) -> "TileELLStack | None":
    """Pack into bucketed (and optionally column-chunked) tile-ELL.

    Callers should pre-sort tiles by descending column-union
    (plan_reorder(tile_sort_chunk=...)) so bucket runs are contiguous;
    the packer is correct for any order but then buckets at K_max."""
    C = A.tocsr()
    nr, nc = C.shape
    align_r = max(tile_m, 8)
    if nr_pad is None:
        nr_pad = -(-nr // align_r) * align_r
    if nr_pad % tile_m:
        nr_pad = -(-nr_pad // tile_m) * tile_m
    if nc_pad is None:
        nc_pad = -(-nc // 8) * 8
    if nc_pad % chunk:
        nc_pad = -(-nc_pad // chunk) * chunk
    T = nr_pad // tile_m
    cnt = _tile_chunk_counts(C, tile_m, chunk, T)
    kmax = int(cnt.max(initial=1))
    # grid of allowed per-bucket widths (geometric, ratio 1.5)
    grid = [max(kmax, 1)]
    while grid[-1] > 4:
        grid.append(max(int(grid[-1] / 1.5), 4))
    grid = np.array(sorted(set(grid)), dtype=np.int64)
    gK = grid[np.searchsorted(grid, np.maximum(cnt, 1), side="left")]
    # contiguous runs of equal gridded K; merge short runs into the
    # previous (wider-K) run so the block count stays O(len(grid))
    bounds = [0]
    Ks = [int(gK[0])]
    for t in range(1, T):
        if gK[t] != Ks[-1]:
            if t - bounds[-1] < _STACK_MIN_TILES and len(bounds) >= 1:
                Ks[-1] = max(Ks[-1], int(gK[t]))  # absorb into current
                continue
            bounds.append(t)
            Ks.append(int(gK[t]))
    bounds.append(T)
    # if a later tile absorbed a LARGER K into a run, per-tile counts may
    # exceed the run's K — recompute each bucket's K as its tiles' max
    Ks = [
        int(max(cnt[bounds[b]: bounds[b + 1]].max(initial=1), 1))
        for b in range(len(bounds) - 1)
    ]

    dt = np.dtype(dtype)
    blocks = [None] * (len(bounds) - 1)
    if dt in (np.dtype(np.float32), np.dtype(np.float64)):
        # native per-bucket fill: one pass over each bucket's rows, no
        # global lexsort/scatter temporaries (30-40 s at 18M nnz)
        from ..native import tile_ell_fill_range as _nat_fill

        Cd = (
            C
            if C.data.dtype == dt
            else sp.csr_matrix(
                (C.data.astype(dt), C.indices, C.indptr), shape=C.shape
            )
        )
        for b in range(len(bounds) - 1):
            t0, t1 = bounds[b], bounds[b + 1]
            Kb, Tb = Ks[b], t1 - t0
            data = np.zeros((Tb, Kb, chunk, tile_m), dtype=dt)
            colsb = np.zeros((Tb, Kb), dtype=np.int32)
            if not _nat_fill(Cd, tile_m, chunk, t0, t1, Kb, data, colsb):
                blocks = [None] * (len(bounds) - 1)
                break
            blocks[b] = (
                data.reshape(Tb, Kb, tile_m) if chunk == 1 else data,
                colsb,
            )
    if blocks and blocks[0] is None:
        # python fallback: global slot assignment (rank of each
        # (tile, chunk) pair within its tile) + per-bucket scatters
        t_rows = min(T * tile_m, nr)
        nnz_head = int(C.indptr[t_rows])
        rows = np.repeat(
            np.arange(t_rows, dtype=np.int64),
            np.diff(C.indptr[: t_rows + 1]),
        )
        cols = C.indices[:nnz_head].astype(np.int64)
        vals = C.data[:nnz_head]
        tid = rows // tile_m
        cc = cols // chunk
        order = np.lexsort((cc, tid))
        tid_s, cc_s = tid[order], cc[order]
        newpair = np.ones(len(order), dtype=bool)
        if len(order) > 1:
            newpair[1:] = (tid_s[1:] != tid_s[:-1]) | (
                cc_s[1:] != cc_s[:-1]
            )
        gid = np.cumsum(newpair) - 1
        pair_tid = tid_s[newpair]
        tile_first = np.searchsorted(
            pair_tid, np.arange(T, dtype=np.int64)
        )
        slot_pair = np.arange(len(pair_tid), dtype=np.int64) - tile_first[
            pair_tid
        ]
        slot = slot_pair[gid]
        coff = (cols % chunk)[order]
        moff = (rows % tile_m)[order]
        val_s = vals[order]
        for b in range(len(bounds) - 1):
            t0, t1 = bounds[b], bounds[b + 1]
            Kb, Tb = Ks[b], t1 - t0
            m = (tid_s >= t0) & (tid_s < t1)
            lt = tid_s[m] - t0
            if chunk > 1:
                data = np.zeros((Tb, Kb, chunk, tile_m), dtype=dt)
                data[lt, slot[m], coff[m], moff[m]] = val_s[m]
            else:
                data = np.zeros((Tb, Kb, tile_m), dtype=dt)
                data[lt, slot[m], moff[m]] = val_s[m]
            colsb = np.zeros((Tb, Kb), dtype=np.int32)
            colsb[lt, slot[m]] = cc_s[m].astype(np.int32)
            blocks[b] = (data, colsb)
    out_blocks = []
    for b, (data, colsb) in enumerate(blocks):
        t0, t1 = bounds[b], bounds[b + 1]
        out_blocks.append(
            TileELL(
                data=data if stage else jnp.asarray(data),
                cols=colsb if stage else jnp.asarray(colsb),
                nrows=min(max(nr - t0 * tile_m, 0), (t1 - t0) * tile_m),
                nrows_pad=(t1 - t0) * tile_m,
                ncols_pad=nc_pad,
                tile_m=tile_m,
                chunk_c=chunk,
            )
        )
    blocks = out_blocks
    return TileELLStack(
        blocks=tuple(blocks),
        nrows=nr,
        nrows_pad=nr_pad,
        ncols_pad=nc_pad,
        tile_m=tile_m,
    )


def dense_from_scipy(
    A: sp.spmatrix, bs: int, dtype, row_align: int = 8, stage: bool = False
) -> DenseMatrix:
    n = A.shape[0] // bs
    n_pad = -(-n // row_align) * row_align
    out = np.zeros((n_pad * bs, n_pad * bs), dtype=np.dtype(dtype))
    out[: A.shape[0], : A.shape[1]] = A.toarray()
    arr = out if stage else jnp.asarray(out)
    return DenseMatrix(data=arr, nrows=n, nrows_pad=n_pad, bs=bs)


# format-chooser thresholds (their GPU optimum is not yet measured)
DENSE_MAX_ROWS = 4096
DIA_MAX_DIAGS = 256


def plan_reorder(
    A: sp.spmatrix,
    bs: int,
    row_align: int = 8,
    tile_sort_chunk: int | None = None,
    tile_m: int = 8,
):
    """Bandwidth-reducing (RCM) row order for levels headed to supernoding.

    Supernoded tiles only stay dense if consecutive rows share neighbors;
    aggregate-ordered coarse levels do not (measured 17x nnz inflation), so
    they get reverse-Cuthill-McKee first. Returns a block-row permutation or
    None (levels that will use DIA/dense/natural block-ELL).

    ``tile_sort_chunk`` additionally sorts FULL tile_m-row tiles by
    descending column-chunk union so the bucketed tile-ELL packer
    (tile_ell_stack_from_scipy) gets contiguous equal-width runs; the
    partial tail tile stays pinned last (real rows must remain a prefix
    of every bucket's row range).
    """
    n = A.shape[0] // bs
    if bs != 1 or n <= DENSE_MAX_ROWS:
        return None
    if count_diagonals(A, limit=DIA_MAX_DIAGS) <= DIA_MAX_DIAGS:
        return None  # stencil level: DIA in natural order
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rcm = np.asarray(
        reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True),
        dtype=np.int64,
    )
    if tile_sort_chunk is None:
        return rcm
    Tfull = n // tile_m
    if Tfull < 2:
        return rcm
    from ..native import csr_permute as _natp

    C = A.tocsr()
    Ar = _natp(C, rcm, rcm)
    if Ar is None:
        Ar = C[rcm][:, rcm].tocsr()
    cnt = _tile_chunk_counts(Ar, tile_m, tile_sort_chunk, Tfull)
    order = np.argsort(-cnt, kind="stable")
    head = rcm[: Tfull * tile_m].reshape(Tfull, tile_m)[order].ravel()
    return np.concatenate([head, rcm[Tfull * tile_m:]])


def _te_bytes(fmt) -> int:
    if isinstance(fmt, TileELLStack):
        return sum(b.data.nbytes + b.cols.nbytes for b in fmt.blocks)
    return fmt.data.nbytes + fmt.cols.nbytes


def _pack_tile_ell(A, dtype, tile, row_align, stage, stack_chunk):
    """Plain tile-ELL, or the bucketed/chunked stack when requested
    (single-device levels whose rows were tile-sorted by plan_reorder)."""
    if stack_chunk is not None:
        return tile_ell_stack_from_scipy(
            A, dtype, tile_m=tile, chunk=stack_chunk, stage=stage
        )
    return tile_ell_from_scipy(
        A, dtype, tile_m=tile, row_align=row_align, stage=stage
    )


def choose_format(
    A: sp.spmatrix,
    bs: int,
    dtype,
    row_align: int = 8,
    *,
    dense_max_rows: int = DENSE_MAX_ROWS,
    dia_max_diags: int = DIA_MAX_DIAGS,
    supernode_tile: int = 8,
    stage: bool = False,
    stack_chunk: int | None = None,
    block_chunk: int | None = None,
):
    """Pick the device format for one level's matrix.

    Priority: dense (small) > DIA (few diagonals, scalar) > supernoded ELL
    (scalar unstructured) > block-ELL (bs > 1 keeps natural block tiles).
    Only formats compatible with identity row ordering are chosen here;
    color-permuted (GS) levels always use block-ELL.
    """
    n = A.shape[0] // bs
    # DIA wins over dense whenever the level is a stencil and not tiny:
    # same op count class, ~20x less memory/transfer for mid-size levels
    if bs == 1 and n > 512:
        nd = count_diagonals(A, limit=dia_max_diags)
        if nd <= 32:
            # true stencil level: DIA is gather-free at ~1x fill
            return dia_from_scipy(A, dtype, row_align, stage=stage)
        if n > dense_max_rows:
            # mid-density regime: pick DIA vs tile-ELL by stored bytes
            # (both beat the 8x8 supernode fill by ~an order of magnitude
            # on mesh graphs; DIA additionally has zero gathers, so it
            # wins any near-tie)
            te = _pack_tile_ell(
                A, dtype, supernode_tile, row_align, stage, stack_chunk
            )
            if nd <= dia_max_diags:
                n_pad = -(-n // row_align) * row_align
                dia_bytes = nd * n_pad * np.dtype(dtype).itemsize
                te_bytes = _te_bytes(te) if te is not None else None
                if te_bytes is None or dia_bytes <= 2 * te_bytes:
                    return dia_from_scipy(
                        A, dtype, row_align, stage=stage
                    )
            if te is not None:
                return te
        elif nd <= dia_max_diags:
            return dia_from_scipy(A, dtype, row_align, stage=stage)
    if n <= dense_max_rows and (n * bs) ** 2 * 4 <= 512e6:
        return dense_from_scipy(A, bs, dtype, row_align, stage=stage)
    if bs == 1:
        te = _pack_tile_ell(
            A, dtype, supernode_tile, row_align, stage, stack_chunk
        )
        if te is not None:
            return te
        return supernode_from_scipy(
            A, dtype, tile=supernode_tile, row_align=row_align, stage=stage
        )
    # block (bs > 1) unstructured levels: chunk adjacent block columns
    # per slot on single-device placements (the V-cycle on block
    # energies is gather-slot bound — see BlockELL.col_chunk)
    return _bell.from_scipy(
        A, bs, bs, dtype=dtype, row_align=row_align, stage=stage,
        col_chunk=(block_chunk or 1),
    )
