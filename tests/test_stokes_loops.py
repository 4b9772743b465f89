"""Geometric facet loops + level contraction (the short-loop Stokes path).

The reference builds its potential space from SHORT geometric loops
(`CalcFacetLoops`, src/stokes/common/stokes_pc.cpp: facets around a primal
vertex in 2D / a primal edge in 3D) and keeps loops attached to the mesh
hierarchy. These tests cover the re-created path: geometric finest loops
(`st.geometric_loops`) contracted level-to-level (`st.contract_loops`),
which replaced the fundamental-cycle (tree) basis whose O(diameter) loops
densified the potential operator quadratically (measured 126 s setup at
10.7k DoF -> 2.2 s with this path).
"""

import numpy as np
import scipy.sparse as sp
import pytest

from ngsamg import AMGOptions, SpecOpt
from ngsamg.apps import stokes as st
from ngsamg.mesh.topo import map_edges
from ngsamg.precond.stokes import StokesAMG, _truncate_columns
from ngsamg.utils.stokes_fem import stokes_tri


def _geo_setup(n, dim, alpha=10.0, **opt_kw):
    sprob, _ = stokes_tri(n, dim=dim, alpha=alpha)
    sopts = AMGOptions()
    sopts.levels.max_coarse_size = 80
    for k, v in opt_kw.items():
        setattr(sopts.prol, k, SpecOpt(v))
    pc = StokesAMG(
        sprob.A,
        cell_pos=sprob.cell_pos,
        cell_vol=sprob.cell_vol,
        facet_cells=sprob.facet_cells,
        facet_flow=sprob.facet_flow,
        facet_verts=sprob.facet_verts,
        vert_pos=sprob.vert_pos,
        bnd_facet_verts=sprob.bnd_facet_verts,
        options=sopts,
    ).setup()
    return sprob, pc


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 7)])
def test_geometric_loops_are_exact_cycles(dim, n):
    sprob, _ = stokes_tri(n, dim=dim)
    mesh, _ = st.build_dual_mesh(
        sprob.cell_pos, sprob.cell_vol, sprob.facet_cells, sprob.facet_flow
    )
    Y = st.geometric_loops(
        mesh, np.asarray(sprob.facet_verts), sprob.vert_pos,
        sprob.bnd_facet_verts,
    )
    assert Y is not None and Y.shape[1] > 0
    # short: loop length = local fan size, never a tree path
    lens = np.diff(Y.tocsc().indptr)
    assert lens.max() <= 16, lens.max()
    C = st.build_loops(mesh, incidence=Y)
    assert np.abs(sprob.D @ C).max() < 1e-12


def test_geometric_loops_span_2d():
    """In 2D the vertex loops are the bounded faces of the planar dual:
    a full cycle basis (rank == dim ker D)."""
    sprob, _ = stokes_tri(12, dim=2)
    mesh, _ = st.build_dual_mesh(
        sprob.cell_pos, sprob.cell_vol, sprob.facet_cells, sprob.facet_flow
    )
    Y = st.geometric_loops(
        mesh, np.asarray(sprob.facet_verts), sprob.vert_pos,
        sprob.bnd_facet_verts,
    )
    C = st.build_loops(mesh, incidence=Y)
    ker_dim = sprob.n - np.linalg.matrix_rank(sprob.D.toarray())
    assert np.linalg.matrix_rank(C.toarray()) == ker_dim


def test_contracted_loops_stay_cycles_every_level():
    """Aggregation is a graph contraction; the quotient chain map keeps
    D_l C_l == 0 on every level of the hierarchy."""
    _, pc = _geo_setup(20, 2)
    assert pc.num_levels >= 3
    for i, cap in enumerate(pc.setup_levels_):
        assert cap.C is not None, f"level {i} lost its loops"
        mesh = cap.mesh
        flow = mesh.edge_data["flow"]
        e = mesh.edges
        ne = len(e)
        D = sp.coo_matrix(
            (
                np.concatenate([flow, -flow]),
                (
                    np.concatenate([e[:, 0], e[:, 1]]),
                    np.concatenate([np.arange(ne)] * 2),
                ),
            ),
            shape=(mesh.nv, ne),
        ).tocsr()
        scale = max(1.0, np.abs(flow).max())
        assert np.abs(D @ cap.C).max() < 1e-10 * scale, f"level {i}"


@pytest.mark.parametrize("dim,n,budget", [(2, 20, 20), (3, 9, 30)])
def test_geo_loops_alpha_robust(dim, n, budget):
    """Stiff grad-div penalty: the geometric potential space keeps the
    iteration count alpha-robust WITHOUT prolongation smoothing (compare
    51 iterations for the tree basis at alpha=1e3 in 2D)."""
    sprob, pc = _geo_setup(n, dim, alpha=1000.0)
    x, info = pc.solve(sprob.b, tol=1e-8, maxiter=150)
    r = np.linalg.norm(sprob.A @ x - sprob.b) / np.linalg.norm(sprob.b)
    assert info.converged and r < 1e-7
    assert info.iterations <= budget, info.iterations


def test_geo_loops_operator_complexity():
    """Short loops + auto-off curl smoothing keep the hierarchy lean."""
    _, pc = _geo_setup(9, 3)
    nnz = sum(c.A.nnz for c in pc.setup_levels_)
    oc = nnz / pc.setup_levels_[0].A.nnz
    assert oc < 4.0, oc
    # per-level operators stay sparse (no densified coarse levels)
    for i, cap in enumerate(pc.setup_levels_[:-1]):
        assert cap.A.nnz / cap.A.shape[0] < 60, (i, cap.A.nnz)


def test_truncate_columns():
    rng = np.random.default_rng(3)
    Y = sp.random(40, 25, density=0.5, random_state=rng, format="csc")
    T = _truncate_columns(Y, 4, 0.0)
    assert (np.diff(T.indptr) <= 4).all()
    # kept entries are each column's largest
    for j in range(25):
        col = np.abs(Y[:, j].toarray().ravel())
        kept = np.abs(T[:, j].toarray().ravel())
        nk = int((kept > 0).sum())
        if nk:
            thresh = np.sort(col[col > 0])[-nk]
            assert kept.max() == col.max()
            assert (col[kept > 0] >= thresh - 1e-15).all()
    # relative drop tolerance
    T2 = _truncate_columns(Y, 40, 0.5)
    for j in range(25):
        col = np.abs(Y[:, j].toarray().ravel())
        kept = np.abs(T2[:, j].toarray().ravel())
        if col.max() > 0:
            assert (kept[kept > 0] >= 0.5 * col.max() - 1e-15).all()


def test_vector_cr_geometric_loops():
    """The CR (vector facet dof) path lifts the same incidence cycles."""
    from ngsamg.utils.stokes_fem import stokes_cr

    sprob, _ = stokes_cr(10, dim=2, alpha=100.0)
    sopts = AMGOptions()
    sopts.levels.max_coarse_size = 120
    pc = StokesAMG(
        sprob.A,
        cell_pos=sprob.cell_pos,
        cell_vol=sprob.cell_vol,
        facet_cells=sprob.facet_cells,
        facet_flow=sprob.facet_flow,
        facet_verts=sprob.facet_verts,
        vert_pos=sprob.vert_pos,
        bnd_facet_verts=sprob.bnd_facet_verts,
        options=sopts,
    ).setup()
    assert pc._loops0 is not None
    assert np.abs(sprob.D @ pc.setup_levels_[0].C).max() < 1e-10
    x, info = pc.solve(sprob.b, tol=1e-8, maxiter=150)
    r = np.linalg.norm(sprob.A @ x - sprob.b) / np.linalg.norm(sprob.b)
    assert info.converged and r < 1e-7, (info.iterations, r)


def test_api_wrapper_threads_loop_geometry():
    from ngsamg import api as NgsAMG

    sprob, _ = stokes_tri(14, dim=2, alpha=100.0)
    pc = NgsAMG.stokes_gg_2d(
        sprob.A,
        cell_pos=sprob.cell_pos,
        cell_vol=sprob.cell_vol,
        facet_cells=sprob.facet_cells,
        facet_flow=sprob.facet_flow,
        facet_verts=sprob.facet_verts,
        vert_pos=sprob.vert_pos,
        bnd_facet_verts=sprob.bnd_facet_verts,
    )
    assert pc._pc._loops0 is not None
    x, info = pc.solve(sprob.b, tol=1e-8, maxiter=100)
    assert info.converged
