"""Parity tests for the round-5 native setup kernels.

Each new kernel (rap_bsr, truncate_prol_blocks, elast_ahat_bsr,
rho_power) is checked against the numpy/scipy reference path it
replaces — same structure, values equal to fp-contraction tolerance
(the kernels compile with FMA; serial and distributed setups both call
the SAME kernel, so bitwise serial==dist equality is preserved).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from ngsamg import native
from ngsamg.apps.elasticity import ElasticityEnergy
from ngsamg.mesh.topo import AlgebraicMesh

pytestmark = pytest.mark.skipif(
    not native.HAVE_NATIVE, reason="native extension not built"
)


@pytest.mark.parametrize("br,bc", [(3, 6), (6, 6), (2, 3), (1, 1)])
def test_rap_bsr_matches_scipy(br, bc):
    rng = np.random.default_rng(0)
    n, nc = 120, 40
    A = sp.random(n, n, density=0.06, random_state=1, format="csr")
    A = A + A.T + sp.eye(n) * 3
    Ab = sp.bsr_matrix(sp.kron(A, np.ones((br, br))), blocksize=(br, br))
    Pr = sp.random(
        n, nc, density=0.04, random_state=2, format="csr"
    ) + sp.csr_matrix(
        (np.ones(n), (np.arange(n), rng.integers(0, nc, n))),
        shape=(n, nc),
    )
    Pb = sp.bsr_matrix(
        sp.kron(Pr, rng.standard_normal((br, bc))), blocksize=(br, bc)
    )
    C = native.rap_bsr(Ab, Pb, symmetrize=True)
    ref = (Pb.T @ (Ab @ Pb)).tocsr()
    ref = ((ref + ref.T) * 0.5).tocsr()
    scale = max(abs(ref).max(), 1.0)
    assert abs(C.tocsr() - ref).max() < 1e-12 * scale
    # emitted rows are sorted BSR
    assert (np.diff(C.indptr) >= 0).all()
    for i in range(min(10, C.shape[0] // bc)):
        cols = C.indices[C.indptr[i]:C.indptr[i + 1]]
        assert (np.diff(cols) > 0).all()


def _random_block_prol(rng, nf, ncv, d):
    rows, cols, blocks = [], [], []
    for i in range(nf):
        k = rng.integers(1, 9)
        for c in rng.choice(ncv, size=k, replace=False):
            rows.append(i)
            cols.append(c)
            blocks.append(rng.standard_normal((d, d)))
    order = np.lexsort((cols, rows))
    indptr = np.zeros(nf + 1, dtype=np.int64)
    np.add.at(indptr, np.array(rows) + 1, 1)
    indptr = np.cumsum(indptr)
    P = sp.bsr_matrix(
        (
            np.array(blocks)[order],
            np.array(cols)[order].astype(np.int32),
            indptr,
        ),
        shape=(nf * d, ncv * d),
    )
    P.sort_indices()
    return P


def test_truncate_prol_blocks_matches_numpy():
    """Native truncation == the padded numpy pipeline: identical
    structure, values to FMA tolerance, for the rigid transport."""
    from ngsamg.transfer import prolongation as tp

    rng = np.random.default_rng(3)
    en = ElasticityEnergy(3, rot_scale=2.0)
    nf, ncv, d = 150, 40, 6
    P = _random_block_prol(rng, nf, ncv, d)
    mesh_c = AlgebraicMesh(nv=ncv, edges=np.zeros((0, 2), dtype=np.int64))
    mesh_c.vertex_data["pos"] = rng.standard_normal((ncv, 3))
    nat = native.truncate_prol_blocks(
        P, mesh_c.vertex_data["pos"], en._s, 4, 0.04
    )
    # numpy reference: force the fallback by hiding the kernel
    orig = native.truncate_prol_blocks
    native.truncate_prol_blocks = lambda *a, **k: None
    try:
        ref = tp.truncate_prol(
            en, mesh_c, P.copy(), max_per_row=4, min_frac=0.04
        )
    finally:
        native.truncate_prol_blocks = orig
    assert (np.asarray(ref.indptr) == nat.indptr).all()
    assert (np.asarray(ref.indices) == nat.indices).all()
    assert abs(ref.tocsr() - nat.tocsr()).max() < 1e-12


def test_elast_ahat_bsr_matches_pipeline():
    """Fused A-hat assembly is bitwise equal to the two-kernel path."""
    rng = np.random.default_rng(4)
    nv = 100
    pos = rng.standard_normal((nv, 3))
    e = np.unique(np.sort(rng.integers(0, nv, (300, 2)), axis=1), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    E = rng.standard_normal((len(e), 6, 6))
    E = E + np.transpose(E, (0, 2, 1))
    l2 = np.abs(rng.standard_normal(nv))
    new = native.elast_ahat_bsr(pos, e, E, 2.0, l2)
    Bii, Bij, Bji, Bjj = native.rigid_edge_blocks(pos, e, E, 2.0)
    Dv = np.zeros((nv, 6, 6))
    idx = np.arange(3)
    Dv[:, idx, idx] = l2[:, None]
    old = native.bsr_from_edge_blocks(e, Bii, Bij, Bji, Bjj, Dv)
    assert abs(new.tocsr() - old.tocsr()).max() == 0.0


def test_rho_power_matches_numpy_power_iteration():
    from ngsamg.smoothers.build import _lam_max_estimate
    from ngsamg.sparse.host import block_diagonal_fast

    rng = np.random.default_rng(5)
    n = 120
    A = sp.random(n, n, density=0.06, random_state=1, format="csr")
    A = A + A.T + sp.eye(n) * 3
    Ab = sp.kron(A, rng.standard_normal((3, 3)) + np.eye(3) * 5).tocsr()
    Ab = ((Ab + Ab.T) * 0.5).tocsr()
    Dinv = np.linalg.pinv(block_diagonal_fast(Ab, 3))
    x0 = np.random.default_rng(0).standard_normal(Ab.shape[0])
    ref = _lam_max_estimate(Ab, 3, Dinv)  # itself native-backed
    scal = native.rho_power(Ab, Dinv, x0, 12) * 1.05
    bsr = native.rho_power(
        sp.bsr_matrix(Ab, blocksize=(3, 3)), Dinv, x0, 12
    ) * 1.05
    assert abs(scal - ref) / ref < 1e-10
    assert abs(bsr - ref) / ref < 1e-10
