"""Device-resident block-ELL sparse format + SpMV.

Replaces the reference's block-entry `SparseMatrix<Mat<N,M>>` instantiations
(/root/reference/src/base/linalg/utils_sparseLA.hpp:56-441) with a padded
ELL layout that keeps all shapes static for XLA:

* ``data``: (n, K, br, bc) — K blocks per block row, zero-padded
* ``cols``: (n, K) int32 — block-column index per slot (0 for padding)

SpMV is a gather + batched small matmul, which XLA fuses into a single
bandwidth-bound kernel over the block dimensions (br, bc in {1, 2, 3, 6}).
Block vectors are (n, bc) arrays.

Row counts are padded to a multiple of ``row_align`` so that multi-chip row
sharding (:mod:`ngsamg.parallel`) divides evenly; padded rows are
entirely zero and stay zero through every operation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import host as _host


def to_scipy(A: "BlockELL"):
    """Padded block-ELL -> scipy BSR->CSR (introspection/debugging)."""
    import scipy.sparse as sp

    data = np.asarray(A.data, dtype=np.float64)[: A.nrows]
    cols = np.asarray(A.cols)[: A.nrows]
    if A.col_chunk > 1:
        C = A.col_chunk
        n, K, br, cbc = data.shape
        bc = cbc // C
        # expand each chunk slot into C plain block slots
        data = data.reshape(n, K, br, C, bc).transpose(0, 1, 3, 2, 4)
        data = data.reshape(n, K * C, br, bc)
        cols = (
            cols[:, :, None] * C + np.arange(C)[None, None, :]
        ).reshape(n, K * C)
        # a chunk overhanging ncols holds only zero blocks: clamp the
        # index into range (eliminate_zeros drops them below)
        cols = np.minimum(cols, max(A.ncols - 1, 0))
    n, K, br, bc = data.shape
    rows = np.repeat(np.arange(n), K)
    B = sp.bsr_matrix(
        (
            data.reshape(n * K, br, bc),
            cols.reshape(-1),
            np.arange(n + 1) * K,
        ),
        shape=(n * br, A.ncols * bc),
    )
    C = B.tocsr()
    C.eliminate_zeros()  # padding slots are all-zero blocks at col 0
    return C


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "cols"],
    meta_fields=["nrows", "ncols", "nrows_pad", "col_chunk"],
)
@dataclass(frozen=True)
class BlockELL:
    """Padded block-ELL sparse matrix (block rows x block cols).

    ``col_chunk = C > 1`` stores each slot as C ADJACENT block columns
    side by side (``data``: (n, K, br, C*bc), ``cols``: chunk index =
    block_col // C): the matvec gathers one (C*bc)-wide row of x per
    slot instead of C separate bc-wide gathers — the TileELL column-
    chunk trick at block granularity. Halving the slot count halves the
    gathered index count; the price is zero-fill where only one column
    of a pair is present.
    """

    data: jax.Array  # (n_pad, K, br, col_chunk*bc)
    cols: jax.Array  # (n_pad, K) int32 (block col, or chunk id if C>1)
    nrows: int  # logical number of block rows
    ncols: int  # logical number of block cols
    nrows_pad: int  # padded number of block rows (= data.shape[0])
    col_chunk: int = 1

    @property
    def ell_width(self) -> int:
        return self.data.shape[1]

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.data.shape[2], self.data.shape[3]

    @property
    def shape(self) -> tuple[int, int]:
        br, bc = self.block_shape
        return self.nrows * br, self.ncols * bc

    def __matmul__(self, x: jax.Array) -> jax.Array:
        return spmv(self, x)


def _chunked_pack(A, bs_r: int, bs_c: int, C: int, dtype):
    """(data (n, K, br, C*bc), cols (n, K) chunk ids) — C adjacent block
    columns per slot (see BlockELL.col_chunk)."""
    import scipy.sparse as sp

    if bs_r == bs_c == 1:
        B = A.tocsr()
        # the plain-assignment scatter below drops (not sums) duplicate
        # stored entries and assumes ascending column order — canonicalize
        if not B.has_canonical_format:
            B.sum_duplicates()
        bdata = B.data.reshape(-1, 1, 1)
        indptr, indices = B.indptr, B.indices
        n = B.shape[0]
    else:
        if bs_r == bs_c:
            from .host import to_bsr

            B = to_bsr(A, bs_r)  # cached square-block view
        else:
            B = sp.bsr_matrix(A, blocksize=(bs_r, bs_c))
        if not B.has_sorted_indices:
            B.sort_indices()
        bdata = B.data
        indptr, indices = B.indptr, B.indices
        n = B.shape[0] // bs_r
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols_b = indices.astype(np.int64)
    cc = cols_b // C
    # BSR column indices are ascending per row, so (row, cc) runs are
    # contiguous: slot = rank of the (row, chunk) pair within its row
    newp = np.ones(len(rows), dtype=bool)
    newp[1:] = (rows[1:] != rows[:-1]) | (cc[1:] != cc[:-1])
    gid = np.cumsum(newp) - 1
    pair_row = rows[newp]
    row_first = np.searchsorted(pair_row, np.arange(n, dtype=np.int64))
    slot_pair = np.arange(len(pair_row), dtype=np.int64) - row_first[
        pair_row
    ]
    slot = slot_pair[gid]
    K = int(slot.max(initial=-1)) + 1 if len(slot) else 1
    K = max(K, 1)
    try:
        data = np.zeros((n, K, bs_r, C, bs_c), dtype=np.dtype(dtype))
    except TypeError:
        data = np.zeros((n, K, bs_r, C, bs_c), dtype=dtype)
    cols = np.zeros((n, K), dtype=np.int32)
    data[rows, slot, :, cols_b % C, :] = bdata
    cols[rows, slot] = cc.astype(np.int32)
    return data.reshape(n, K, bs_r, C * bs_c), cols


def from_scipy(
    A,
    bs_r: int = 1,
    bs_c: int = 1,
    dtype=jnp.float32,
    row_align: int = 8,
    width: int | None = None,
    stage: bool = False,
    col_chunk: int = 1,
) -> BlockELL:
    """Build a BlockELL from a host scipy matrix.

    ``stage=True`` keeps numpy leaves (host staging) so a whole hierarchy
    can be shipped with ONE `jax.device_put`. ``col_chunk`` packs that many
    adjacent block columns per slot (single-device SQUARE operators
    only: the matvec reshapes x by the chunk, so the vector pad must
    divide it — row_align does).
    """
    if col_chunk > 1:
        data, cols = _chunked_pack(A, bs_r, bs_c, col_chunk, dtype)
    else:
        data, cols = _host.pad_to_ell(
            A, bs_r, bs_c, width=width, dtype=dtype
        )
    n = data.shape[0]
    n_pad = -(-n // row_align) * row_align
    if n_pad != n:
        pad = n_pad - n
        data = np.concatenate(
            [data, np.zeros((pad,) + data.shape[1:], data.dtype)]
        )
        cols = np.concatenate([cols, np.zeros((pad, cols.shape[1]), cols.dtype)])
    ncols = A.shape[1] // bs_c
    data = np.asarray(data, dtype=np.dtype(dtype))
    cols = np.asarray(cols, dtype=np.int32)
    if not stage:
        data, cols = jnp.asarray(data), jnp.asarray(cols)
    return BlockELL(
        data=data,
        cols=cols,
        nrows=n,
        ncols=ncols,
        nrows_pad=n_pad,
        col_chunk=col_chunk,
    )


def spmv(A: BlockELL, x: jax.Array) -> jax.Array:
    """y = A @ x for a block vector x of shape (ncols_pad?, bc).

    ``x`` may be longer than ``A.ncols`` (padded); gathered columns are always
    < ncols so padding never contaminates the product.
    """
    if A.col_chunk > 1:
        xw = x.reshape(-1, A.col_chunk * x.shape[1])
        xg = xw[A.cols]  # (n, K, C*bc)
    else:
        xg = x[A.cols]  # (n, K, bc)
    return jnp.einsum(
        "nkij,nkj->ni", A.data, xg, preferred_element_type=A.data.dtype
    )


def spmv_rows(A: BlockELL, x: jax.Array, rows: jax.Array) -> jax.Array:
    """(A @ x) restricted to the given block rows — used by multicolor GS."""
    d = A.data[rows]  # (m, K, br, bc)
    c = A.cols[rows]  # (m, K)
    if A.col_chunk > 1:
        xg = x.reshape(-1, A.col_chunk * x.shape[1])[c]
    else:
        xg = x[c]
    return jnp.einsum("mkij,mkj->mi", d, xg, preferred_element_type=d.dtype)


def block_vec(v: np.ndarray | jax.Array, bs: int, nrows_pad: int, dtype):
    """Reshape a flat DOF vector into a padded (nrows_pad, bs) block vector."""
    v = jnp.asarray(v, dtype=dtype).reshape(-1, bs)
    n = v.shape[0]
    if n < nrows_pad:
        v = jnp.concatenate(
            [v, jnp.zeros((nrows_pad - n, bs), dtype=dtype)], axis=0
        )
    return v


def flat_vec(v: jax.Array, nrows: int) -> jax.Array:
    """Inverse of :func:`block_vec`: drop row padding and flatten."""
    return v[:nrows].reshape(-1)
