"""Parity tests for the diagonal-storage SpMVs against plain references.

`formats._dia_matvec` (general and symmetric-half storage) and
`formats._stencil_dia_matvec` (uniform clipped stencils) are the
finest-level and structured coarse-level SpMVs of the lattice hierarchy.
Each is compared with an independent reference of its storage convention
on small lattices covering odd dims, negative offsets, offsets at
power-of-two boundaries, long diagonals and pad tails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from ngsamg.sparse import formats

# vector lengths around powers of two, where slicing bugs show
P2 = 128
LONG = 8192


def _dia_manual(offsets, data, n, sym_half):
    """Reference matrix (scipy CSR) for a DiaMatrix's storage convention:
    A[i, i+o] = data[d, i]; with ``sym_half`` also A[i, i-o] = data[d, i-o]
    for o > 0."""
    rows, cols, vals = [], [], []
    for d, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(data[d, i])
        if sym_half and off > 0:
            i = np.arange(off, n)
            rows.append(i)
            cols.append(i - off)
            vals.append(data[d, i - off])
    return sp.coo_matrix(
        (
            np.concatenate(vals).astype(np.float64),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(n, n),
    ).tocsr()


def _mk_dia(offsets, n, n_pad, sym_half, seed=0):
    rng = np.random.default_rng(seed)
    data = np.zeros((len(offsets), n_pad), dtype=np.float32)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = rng.standard_normal(hi - lo).astype(np.float32)
    return formats.DiaMatrix(
        data=jnp.asarray(data),
        offsets=tuple(int(o) for o in offsets),
        nrows=n,
        nrows_pad=n_pad,
        sym_half=sym_half,
    ), data


def _rand_x(n, n_pad, seed):
    x = np.zeros((n_pad, 1), dtype=np.float32)
    x[:n, 0] = np.random.default_rng(seed).standard_normal(n)
    return x


@pytest.mark.parametrize(
    "offsets,n",
    [
        ((-200, -128, -3, 0, 3, 128, 200), LONG - 77),  # pad tail
        ((-P2, -1, 0, 1, P2), LONG),  # power-of-two offsets
        ((-300, 0, 300), 2 * LONG - 5),  # long vector, odd length
    ],
)
def test_dia_general_matches_reference(offsets, n):
    n_pad = -(-n // 8) * 8
    A, data = _mk_dia(offsets, n, n_pad, sym_half=False)
    x = _rand_x(n, n_pad, 1)
    y = np.asarray(formats._dia_matvec(A, jnp.asarray(x)))[:, 0]
    ref = _dia_manual(A.offsets, data, n, False) @ x[:n, 0]
    np.testing.assert_allclose(y[:n], ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(y[n:], 0.0)


@pytest.mark.parametrize(
    "offsets,n",
    [
        ((0, 1, 127, 128, 500), LONG - 13),  # short and mid offsets
        ((0, 128, LONG + 37), 3 * LONG - 9),  # offset beyond one block
    ],
)
def test_dia_sym_half_matches_reference(offsets, n):
    n_pad = -(-n // 8) * 8
    A, data = _mk_dia(offsets, n, n_pad, sym_half=True)
    x = _rand_x(n, n_pad, 2)
    y = np.asarray(formats._dia_matvec(A, jnp.asarray(x)))[:, 0]
    ref = _dia_manual(A.offsets, data, n, True) @ x[:n, 0]
    np.testing.assert_allclose(y[:n], ref, rtol=1e-4, atol=1e-4)


def _mk_stencil(dims, offs, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    vals = rng.standard_normal(len(offs)).astype(np.float32)
    row_align = 8
    n_pad = -(-n // row_align) * row_align
    return formats.StencilDia(
        vals=jnp.asarray(vals),
        offs=tuple(tuple(int(x) for x in o) for o in offs),
        dims=tuple(int(d) for d in dims),
        nrows=n,
        nrows_pad=n_pad,
    )


def _stencil_dense(A):
    d = len(A.dims)
    n = A.nrows
    idx = np.stack(
        np.meshgrid(*[np.arange(s) for s in A.dims], indexing="ij"),
        axis=-1,
    ).reshape(n, d)
    strides = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * A.dims[k + 1]
    M = np.zeros((n, n))
    vals = np.asarray(A.vals)
    for t, off in enumerate(A.offs):
        tgt = idx + np.asarray(off)
        ok = np.all((tgt >= 0) & (tgt < np.asarray(A.dims)), axis=1)
        rows = np.flatnonzero(ok)
        cols = (tgt[ok] * strides).sum(axis=1)
        M[rows, cols] += vals[t]
    return M


@pytest.mark.parametrize(
    "dims,offs",
    [
        # odd dims, 7-point Laplacian-like stencil (negative offsets)
        ((7, 9, 11), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                      (0, -1, 0), (0, 0, 1), (0, 0, -1)]),
        # axis-0 stride (4*38=152) above a power-of-two boundary
        ((5, 4, 38), [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 0, 2),
                      (1, 1, -1), (-1, -1, 1)]),
        # 2-d lattice with pad tail and long diagonals
        ((33, 131), [(0, 0), (2, 0), (-2, 0), (0, 3), (0, -3), (1, 1),
                     (-1, -1)]),
    ],
)
def test_stencil_matches_reference(dims, offs):
    A = _mk_stencil(dims, offs)
    x = _rand_x(A.nrows, A.nrows_pad, 3)
    y = np.asarray(formats._stencil_dia_matvec(A, jnp.asarray(x)))[:, 0]
    np.testing.assert_array_equal(y[A.nrows:], 0.0)
    dense = _stencil_dense(A)
    np.testing.assert_allclose(
        y[: A.nrows], dense @ x[: A.nrows, 0], rtol=1e-4, atol=1e-4
    )
