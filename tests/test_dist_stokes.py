"""Distributed Stokes setup vs serial setup (parallel/dist_stokes.py).

Completes the distributed-setup parity suite (test_dist_setup.py for H1,
dist-elasticity tests) for the Stokes family: hierarchies built from
cell-/facet-sharded inputs must reproduce the serial hierarchy — bitwise
on aggregates and coarse-edge numbering, to fp roundoff on operators and
prolongations (under the piecewise prolongation; the smoothed variant
uses the distributed loop basis, which spans the same ker(D) but is a
different basis, so there parity is convergence-level).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from ngsamg import AMGOptions, SpecOpt
from ngsamg.apps import stokes as st
from ngsamg.config import ProlType
from ngsamg.parallel.dist_stokes import dist_stokes_levels
from ngsamg.precond.stokes import StokesAMG
from ngsamg.utils.stokes_fem import stokes_cr, stokes_tri


def _serial_levels(prob, opts):
    pc = StokesAMG(
        prob.A,
        cell_pos=prob.cell_pos,
        cell_vol=prob.cell_vol,
        facet_cells=prob.facet_cells,
        facet_flow=prob.facet_flow,
        options=opts,
    ).setup()
    return pc


def _div_op(mesh, bs):
    """Flow-weighted divergence of a level's dual mesh."""
    e = mesh.edges
    fl = mesh.edge_data["flow"]
    if bs == 1:
        rows = np.concatenate([e[:, 0], e[:, 1]])
        cols = np.concatenate([np.arange(mesh.ne)] * 2)
        vals = np.concatenate([fl, -fl])
        return sp.coo_matrix((vals, (rows, cols)),
                             shape=(mesh.nv, mesh.ne)).tocsr()
    dim = fl.shape[1]
    dofs = (np.arange(mesh.ne)[:, None] * dim + np.arange(dim)).ravel()
    rows = np.concatenate(
        [np.repeat(e[:, 0], dim), np.repeat(e[:, 1], dim)]
    )
    cols = np.concatenate([dofs, dofs])
    vals = np.concatenate([fl.ravel(), -fl.ravel()])
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(mesh.nv, mesh.ne * dim)
    ).tocsr()


@pytest.mark.parametrize("n_shards", [2, 3])
def test_dist_stokes_scalar_piecewise_parity(n_shards):
    p, _ = stokes_tri(10, dim=2, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 60
    opts.prol.type = SpecOpt(ProlType.PIECEWISE)
    pc = _serial_levels(p, opts)
    d_levels = dist_stokes_levels(
        pc.A_host, pc.mesh0, 1, opts, n_shards
    )
    s_levels = pc.setup_levels_
    assert len(s_levels) == len(d_levels)
    for i, (sl, dl) in enumerate(zip(s_levels, d_levels)):
        assert sl.mesh.nv == dl.mesh.nv, f"level {i} nv"
        assert sl.mesh.ne == dl.mesh.ne, f"level {i} ne"
        if sl.v2agg is not None:
            np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
            np.testing.assert_array_equal(sl.mesh.edges, dl.mesh.edges)
        if i > 0:
            np.testing.assert_allclose(
                sl.mesh.edge_data["flow"], dl.mesh.edge_data["flow"],
                rtol=1e-12, atol=1e-14,
            )
            np.testing.assert_allclose(
                sl.mesh.vertex_data["vol"], dl.mesh.vertex_data["vol"],
                rtol=1e-12,
            )
        if sl.P is not None:
            dP = abs(sl.P - dl.P)
            assert dP.max() < 1e-11, f"level {i} P differs {dP.max():.2e}"
        scale = max(abs(sl.A).max(), 1e-300)
        dA = abs(sl.A - dl.A).max()
        assert dA < 1e-5 * scale, f"level {i} A differs {dA:.2e}"


def test_dist_stokes_3d_piecewise_parity():
    """Tet-mesh (3D) scalar facet-flux dist setup == serial."""
    p, _ = stokes_tri(5, dim=3, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 120
    opts.prol.type = SpecOpt(ProlType.PIECEWISE)
    pc = _serial_levels(p, opts)
    d_levels = dist_stokes_levels(pc.A_host, pc.mesh0, 1, opts, 3)
    s_levels = pc.setup_levels_
    assert len(s_levels) == len(d_levels) >= 2
    for i, (sl, dl) in enumerate(zip(s_levels, d_levels)):
        if sl.v2agg is not None:
            np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
        if sl.P is not None:
            assert abs(sl.P - dl.P).max() < 1e-10, f"level {i} P"
        scale = max(abs(sl.A).max(), 1e-300)
        assert abs(sl.A - dl.A).max() < 1e-5 * scale, f"level {i} A"
        if dl.C is not None:
            D = _div_op(dl.mesh, 1)
            assert np.abs(D @ dl.C).max() < 1e-10 * max(
                np.abs(D.data).max(), 1.0
            )


@pytest.mark.parametrize("n_shards", [3])
def test_dist_stokes_vector_piecewise_parity(n_shards):
    p, _ = stokes_cr(8, dim=2, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 80
    opts.prol.type = SpecOpt(ProlType.PIECEWISE)
    pc = _serial_levels(p, opts)
    d_levels = dist_stokes_levels(
        pc.A_host, pc.mesh0, pc.facet_bs, opts, n_shards
    )
    s_levels = pc.setup_levels_
    assert pc.facet_bs == 2
    assert len(s_levels) == len(d_levels)
    for i, (sl, dl) in enumerate(zip(s_levels, d_levels)):
        if sl.v2agg is not None:
            np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
        if sl.P is not None:
            dP = abs(sl.P - dl.P)
            assert dP.max() < 1e-10, f"level {i} P differs {dP.max():.2e}"
        scale = max(abs(sl.A).max(), 1e-300)
        dA = abs(sl.A - dl.A).max()
        assert dA < 1e-5 * scale, f"level {i} A differs {dA:.2e}"


@pytest.mark.parametrize("dim,gen,bs", [(2, stokes_tri, 1),
                                        (2, stokes_cr, 2)])
def test_dist_stokes_loops_span_kernel(dim, gen, bs):
    """The distributed loop basis spans exactly ker(D) on every level."""
    p = gen(8, dim=dim, alpha=10.0)
    p = p[0] if isinstance(p, tuple) else p
    opts = AMGOptions()
    opts.levels.max_coarse_size = 60
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    )
    d_levels = dist_stokes_levels(pc.A_host, pc.mesh0, bs, opts, 3)
    assert len(d_levels) >= 2
    for i, dl in enumerate(d_levels):
        if dl.C is None:
            continue
        D = _div_op(dl.mesh, bs)
        dmax = np.abs(D @ dl.C).max()
        fmax = max(np.abs(D.data).max(), 1.0)
        assert dmax < 1e-10 * fmax, f"level {i}: D C = {dmax:.2e}"
        # completeness: the columns span ker(D) exactly
        want = dl.mesh.ne * bs - np.linalg.matrix_rank(D.toarray())
        rank = np.linalg.matrix_rank(dl.C.toarray())
        assert rank == dl.C.shape[1] == want, (i, rank, dl.C.shape, want)


def test_dist_stokes_solve_end_to_end():
    """Full StokesAMG through options.dist_setup: smoothed prolongation
    with the distributed loop basis; convergence matches serial."""
    p, _ = stokes_tri(12, dim=2, alpha=10.0)
    opts_s = AMGOptions()
    opts_s.levels.max_coarse_size = 80
    pc_s = _serial_levels(p, opts_s)
    x_s, info_s = pc_s.solve(p.b, tol=1e-8, maxiter=150)
    assert info_s.converged

    opts_d = AMGOptions(dist_setup=3)
    opts_d.levels.max_coarse_size = 80
    pc_d = _serial_levels(p, opts_d)  # takes the dist path internally
    x_d, info_d = pc_d.solve(p.b, tol=1e-8, maxiter=150)
    r = np.linalg.norm(p.A @ x_d - p.b) / np.linalg.norm(p.b)
    assert info_d.converged and r < 1e-7
    assert info_d.iterations <= info_s.iterations + 10, (
        info_d.iterations, info_s.iterations,
    )


def test_dist_stokes_vector_solve_end_to_end():
    """CR (vector facet dof) dist setup incl. the distributed curl-space
    prolongation smoothing, end to end."""
    p = stokes_cr(8, dim=2, alpha=10.0)
    p = p[0] if isinstance(p, tuple) else p
    opts_s = AMGOptions()
    opts_s.levels.max_coarse_size = 100
    pc_s = _serial_levels(p, opts_s)
    x_s, info_s = pc_s.solve(p.b, tol=1e-8, maxiter=200)
    assert info_s.converged

    opts_d = AMGOptions(dist_setup=3)
    opts_d.levels.max_coarse_size = 100
    pc_d = _serial_levels(p, opts_d)
    x_d, info_d = pc_d.solve(p.b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(p.A @ x_d - p.b) / np.linalg.norm(p.b)
    assert info_d.converged and r < 1e-7
    assert info_d.iterations <= info_s.iterations + 15, (
        info_d.iterations, info_s.iterations,
    )


def test_dist_stokes_hdiv_parity():
    """Distributed HDiv setup (variable facet DOFs + preserved vectors)
    reproduces the serial hierarchy; preservation stays exact."""
    from ngsamg.precond.stokes import StokesHDivAMG
    from ngsamg.utils.stokes_fem import stokes_tri_hdiv

    p, counts, V = stokes_tri_hdiv(8, dim=2, alpha=10.0)

    def build(dist):
        o = AMGOptions(dist_setup=3 if dist else 0)
        o.levels.max_coarse_size = 120
        return StokesHDivAMG(
            p.A,
            cell_pos=p.cell_pos,
            cell_vol=p.cell_vol,
            facet_cells=p.facet_cells,
            facet_flow=p.facet_flow,
            facet_dof_counts=counts,
            preserved=V,
            options=o,
        ).setup()

    pc_s = build(False)
    pc_d = build(True)
    s_levels, d_levels = pc_s.setup_levels_, pc_d.setup_levels_
    assert len(s_levels) == len(d_levels) >= 2
    for i, (sl, dl) in enumerate(zip(s_levels, d_levels)):
        np.testing.assert_array_equal(
            sl.dofs.offsets, dl.dofs.offsets
        ), f"level {i} dofs"
        if sl.v2agg is not None:
            np.testing.assert_array_equal(sl.v2agg, dl.v2agg)
        if sl.P is not None:
            dP = abs(sl.P - dl.P).max()
            assert dP < 1e-9, f"level {i} P differs {dP:.2e}"
            # preservation stays exact through the distributed P
            Vf = sl.pres.vectors
            Vc = s_levels[i + 1].pres.vectors
            dV = np.abs(dl.P @ d_levels[i + 1].pres.vectors - Vf).max()
            dVs = np.abs(sl.P @ Vc - Vf).max()
            assert dV < max(5 * dVs, 1e-9), (i, dV, dVs)
        scale = max(abs(sl.A).max(), 1e-300)
        dA = abs(sl.A - dl.A).max()
        assert dA < 1e-8 * scale, f"level {i} A differs {dA:.2e}"
    # end-to-end solve through the dist-setup hierarchy
    x, info = pc_d.solve(p.b, tol=1e-8, maxiter=200)
    r = np.linalg.norm(p.A @ x - p.b) / np.linalg.norm(p.b)
    assert info.converged and r < 1e-7


def test_dist_stokes_collective_transport_parity():
    """The Stokes dual-mesh setup over the XLA-collective transport:
    every exchange — including the new `route_rows` typed-table routing
    — runs as a jitted shard_map/all_to_all program on the virtual mesh
    and reproduces the LocalTransport hierarchy (payloads bit-cast, so
    arithmetic is identical)."""
    import jax

    from ngsamg.parallel.transport import (
        CollectiveTransport,
        use_transport,
    )

    p, _ = stokes_tri(8, dim=2, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 60
    pc = _serial_levels(p, opts)
    n_shards = len(jax.devices())
    l_levels = dist_stokes_levels(pc.A_host, pc.mesh0, 1, opts, n_shards)
    t = CollectiveTransport()
    with use_transport(t):
        c_levels = dist_stokes_levels(
            pc.A_host, pc.mesh0, 1, opts, n_shards
        )
    assert t.calls > 0, "collective transport never exercised"
    assert len(l_levels) == len(c_levels)
    for i, (ll, cl) in enumerate(zip(l_levels, c_levels)):
        assert abs(ll.A - cl.A).max() == 0.0, f"L{i}"
        np.testing.assert_array_equal(
            ll.mesh.edge_data["flow"], cl.mesh.edge_data["flow"]
        )
        if ll.P is not None or cl.P is not None:
            assert abs(ll.P - cl.P).max() == 0.0, f"P L{i}"
        if ll.C is not None or cl.C is not None:
            assert abs(ll.C - cl.C).max() == 0.0, f"C L{i}"
