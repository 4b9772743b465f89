"""True multi-controller setup: one OS process per shard == one-controller.

The MP runtime (parallel/mp_runtime.py) runs the SAME rank-local level
loop as dist_setup under a pipe-mesh transport, each rank holding ONLY
its rows in a separate address space (spawn). The hierarchy must be
BITWISE-equal to the single-controller `dist_setup_levels` (position-
ordered accumulation + replicated power-iteration norm make every fp
summation order identical).
"""

import numpy as np
import pytest

from ngsamg import AMGOptions, SpecOpt
from ngsamg.apps.h1 import H1Energy
from ngsamg.config import CoarsenType
from ngsamg.parallel.dist_setup import dist_setup_levels
from ngsamg.parallel.mp_runtime import mp_dist_setup_levels
from ngsamg.utils import fem


def _opts():
    o = AMGOptions(dtype="float64")
    o.coarsen.algo = SpecOpt(CoarsenType.SPW)
    o.levels.max_coarse_size = 40
    # pin the in-loop TryContractStep off: at toy scale every coarse
    # level is below the default floor and would concentrate onto rank 0,
    # which is exactly what the residency assertions here must NOT see
    # (production contracts only levels far smaller than the finest);
    # contraction under MPTransport has its own test in test_dist_setup
    o.levels.rd_min_rows = 1
    o.levels.rd_slow_ratio = 2.0
    return o


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_mp_setup_bitwise_equals_single_controller(n_ranks):
    prob = fem.unstructured_poisson(20, dim=2)
    A = prob.A.tocsr()
    opts = _opts()
    en = H1Energy(bs=1)
    s_levels, s_log = dist_setup_levels(A, en, opts, n_ranks)
    m_levels, m_log = mp_dist_setup_levels(A, en, opts, n_ranks)
    assert len(s_levels) == len(m_levels) >= 3, (s_log.nvs, m_log.nvs)
    assert s_log.nvs == m_log.nvs
    assert s_log.nnzs == m_log.nnzs
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        SA, MA = sl.A.tocsr(), ml.A.tocsr()
        np.testing.assert_array_equal(SA.indptr, MA.indptr, err_msg=f"L{i}")
        np.testing.assert_array_equal(
            SA.indices, MA.indices, err_msg=f"L{i}"
        )
        np.testing.assert_array_equal(SA.data, MA.data, err_msg=f"L{i}")
        if sl.P is not None:
            SP, MP = sl.P.tocsr(), ml.P.tocsr()
            np.testing.assert_array_equal(SP.indptr, MP.indptr)
            np.testing.assert_array_equal(SP.indices, MP.indices)
            np.testing.assert_array_equal(SP.data, MP.data)
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)


def test_mp_setup_shard_residency_and_traffic():
    """Each rank's resident level-loop state stays a shard, not the
    global problem, and the pipe traffic is interface-sized."""
    prob = fem.unstructured_poisson(64, dim=2)
    A = prob.A.tocsr()
    peaks = {}
    for n_ranks in (2, 4):
        m_levels, m_log = mp_dist_setup_levels(
            A, H1Energy(bs=1), _opts(), n_ranks
        )
        stats = m_log.mp_rank_stats
        assert len(stats) == n_ranks
        glob = m_log.finest_global_bytes
        for st in stats:
            # a rank holds its rows of A + W + P + Ac (~2.7x the finest
            # matrix split n_ranks ways), never the global level state
            assert 0 < st["peak_shard_bytes"] < 3.0 * glob / n_ranks, (
                st["peak_shard_bytes"],
                glob,
            )
            assert st["transport_calls"] > 0
            # traffic accounting exists and is bounded (per-round halo
            # exchanges + position tags + the replicated power-iteration
            # vector; at this toy scale halo/volume is O(1), so only a
            # sanity bound is meaningful)
            assert 0 < st["moved_bytes"] < 100 * glob
        # same log every rank saw (replicated metadata)
        assert all(st["nvs"] == stats[0]["nvs"] for st in stats)
        peaks[n_ranks] = max(st["peak_shard_bytes"] for st in stats)
    # doubling the ranks ~halves what any one rank holds — the proof
    # that state is per-shard, not per-controller
    assert peaks[4] < 0.65 * peaks[2], peaks
    # ...and the hierarchy is the single-controller one
    s_levels, _ = dist_setup_levels(A, H1Energy(bs=1), _opts(), 4)
    for sl, ml in zip(s_levels, m_levels):
        assert abs(sl.A - ml.A).max() == 0.0


def test_mp_vector_h1_bitwise_equals_single_controller():
    """Vector (multidim) H1 runs one-process-per-rank through the same
    rank-local loop (`dist_setup._vector_levels_parts`)."""
    prob = fem.unstructured_poisson(16, dim=2)
    bs = 2
    A = sp_kron_eye(prob.A, bs)
    opts = _opts()
    opts.levels.max_coarse_size = 15
    en = H1Energy(bs=bs)
    s_levels, s_log = dist_setup_levels(A, en, opts, 2)
    m_levels, m_log = mp_dist_setup_levels(A, en, opts, 2)
    assert len(s_levels) == len(m_levels) >= 3, (s_log.nvs, m_log.nvs)
    assert s_log.nvs == m_log.nvs
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        assert sl.row_bs == ml.row_bs == bs
        SA, MA = sl.A.tocsr(), ml.A.tocsr()
        np.testing.assert_array_equal(SA.indptr, MA.indptr, err_msg=f"L{i}")
        np.testing.assert_array_equal(SA.indices, MA.indices, err_msg=f"L{i}")
        np.testing.assert_array_equal(SA.data, MA.data, err_msg=f"L{i}")
        if sl.P is not None:
            np.testing.assert_array_equal(
                sl.P.tocsr().data, ml.P.tocsr().data
            )


def sp_kron_eye(A, bs):
    import scipy.sparse as sp

    return sp.kron(A.tocsr(), sp.eye(bs), format="csr")


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_mp_elasticity_bitwise_equals_single_controller(n_ranks):
    """Block-energy (elasticity) setup runs one-process-per-rank through
    the SAME rank-local loop (`dist_elast._elast_levels_parts`) and is
    bitwise-equal to the single-controller run — the reference drives
    elasticity with the same distributed machinery as scalar H1
    (reducetable.hpp:22-949, elasticity.hpp:58-98)."""
    from ngsamg.apps.elasticity import ElasticityEnergy
    from ngsamg.parallel.dist_elast import dist_setup_levels_elast

    prob = fem.unstructured_elasticity(12, dim=2)
    A = prob.A.tocsr()
    opts = _opts()
    opts.levels.max_coarse_size = 15
    s_levels, s_log = dist_setup_levels_elast(
        A, ElasticityEnergy(dim=2), opts, n_ranks, prob.coords
    )
    m_levels, m_log = mp_dist_setup_levels(
        A, ElasticityEnergy(dim=2), opts, n_ranks, coords=prob.coords
    )
    assert len(s_levels) == len(m_levels) >= 3, (s_log.nvs, m_log.nvs)
    assert s_log.nvs == m_log.nvs
    assert s_log.nnzs == m_log.nnzs
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        assert sl.row_bs == ml.row_bs
        SA, MA = sl.A.tocsr(), ml.A.tocsr()
        np.testing.assert_array_equal(SA.indptr, MA.indptr, err_msg=f"L{i}")
        np.testing.assert_array_equal(SA.indices, MA.indices, err_msg=f"L{i}")
        np.testing.assert_array_equal(SA.data, MA.data, err_msg=f"L{i}")
        if sl.P is not None:
            SP, MP = sl.P.tocsr(), ml.P.tocsr()
            np.testing.assert_array_equal(SP.indptr, MP.indptr)
            np.testing.assert_array_equal(SP.indices, MP.indices)
            np.testing.assert_array_equal(SP.data, MP.data)
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)
        if sl.P_amg is not None or ml.P_amg is not None:
            np.testing.assert_array_equal(
                sl.P_amg.tocsr().data, ml.P_amg.tocsr().data
            )


def test_mp_elasticity_shard_residency():
    """Each elasticity rank's resident level-loop state is a shard of the
    problem, and doubling ranks shrinks it — block-energy setup is now
    genuinely shard-resident like the scalar loop."""
    from ngsamg.apps.elasticity import ElasticityEnergy

    prob = fem.unstructured_elasticity(16, dim=2)
    A = prob.A.tocsr()
    peaks = {}
    for n_ranks in (2, 4):
        m_levels, m_log = mp_dist_setup_levels(
            A, ElasticityEnergy(dim=2), _opts(), n_ranks,
            coords=prob.coords,
        )
        stats = m_log.mp_rank_stats
        assert len(stats) == n_ranks
        glob = m_log.finest_global_bytes
        for st in stats:
            # a rank holds its rows of A + mesh rows (G/E/pos/l2) + P +
            # Ac; the edge-matrix payload E is ~dpv^2/dim^2 times the
            # scalar graph, so the bound is looser than scalar H1's but
            # still a SHARD bound, not the global problem
            assert 0 < st["peak_shard_bytes"] < 5.0 * glob / n_ranks, (
                st["peak_shard_bytes"],
                glob,
            )
            assert st["transport_calls"] > 0
        peaks[n_ranks] = max(st["peak_shard_bytes"] for st in stats)
    assert peaks[4] < 0.7 * peaks[2], peaks


@pytest.mark.parametrize("bs", [1, 2])
def test_mp_stokes_equals_single_controller(bs):
    """The Stokes dual-mesh level loop runs one-process-per-rank
    (`dist_stokes._stokes_levels_parts` under MPTransport): per-rank
    cell/facet slices only, hierarchy equal to the single-controller run
    (operators/prolongations/loop basis)."""
    from ngsamg.config import ProlType
    from ngsamg.parallel.dist_stokes import dist_stokes_levels
    from ngsamg.parallel.mp_runtime import mp_dist_stokes_levels
    from ngsamg.precond.stokes import StokesAMG
    from ngsamg.utils.stokes_fem import stokes_cr, stokes_tri

    if bs == 1:
        p, _ = stokes_tri(10, dim=2, alpha=10.0)
    else:
        p, _ = stokes_cr(8, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 60
    opts.prol.type = SpecOpt(ProlType.PIECEWISE)
    pc = StokesAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        options=opts,
    ).setup()
    s_levels = dist_stokes_levels(pc.A_host, pc.mesh0, bs, opts, 3)
    m_levels, m_log = mp_dist_stokes_levels(
        pc.A_host, pc.mesh0, bs, opts, 3
    )
    assert len(s_levels) == len(m_levels) >= 2
    assert m_log.peak_shard_bytes > 0
    assert len(m_log.mp_rank_stats) == 3
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        assert abs(sl.A - ml.A).max() == 0.0, f"L{i}"
        assert sl.mesh.nv == ml.mesh.nv and sl.mesh.ne == ml.mesh.ne
        np.testing.assert_array_equal(sl.mesh.edges, ml.mesh.edges)
        np.testing.assert_array_equal(
            sl.mesh.edge_data["flow"], ml.mesh.edge_data["flow"]
        )
        if sl.P is not None or ml.P is not None:
            assert abs(sl.P - ml.P).max() == 0.0, f"P L{i}"
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)
        if sl.C is not None or ml.C is not None:
            assert abs(sl.C - ml.C).max() == 0.0, f"C L{i}"


def test_mp_setup_solves():
    """The MP-built hierarchy plugs into the serial consumers: a plain
    two-level check that P/Ac are consistent (Galerkin identity)."""
    prob = fem.unstructured_poisson(12, dim=2)
    A = prob.A.tocsr().astype(np.float64)
    levels, _ = mp_dist_setup_levels(A, H1Energy(bs=1), _opts(), 2)
    P = levels[0].P.tocsr()
    Ac = levels[1].A.tocsr()
    G = (P.T @ (A @ P)).tocsr()
    Gs = ((G + G.T) * 0.5).tocsr()
    assert abs(Gs - Ac).max() < 1e-12 * abs(Ac).max()


def test_mp_stokes_hdiv_equals_single_controller():
    """The HDiv preserved-vector level loop runs one-process-per-rank
    (`dist_stokes._stokes_hdiv_levels_parts` under MPTransport, with
    batched per-owner collectives): hierarchy equal to the
    single-controller run — completing the rank-local coverage of every
    distributed energy."""
    from ngsamg.parallel.dist_stokes import dist_stokes_hdiv_levels
    from ngsamg.parallel.mp_runtime import mp_dist_stokes_hdiv_levels
    from ngsamg.precond.stokes import StokesHDivAMG
    from ngsamg.utils.stokes_fem import stokes_tri_hdiv

    p, counts, V = stokes_tri_hdiv(8, dim=2, alpha=10.0)
    o = AMGOptions()
    o.levels.max_coarse_size = 120
    pc = StokesHDivAMG(
        p.A,
        cell_pos=p.cell_pos,
        cell_vol=p.cell_vol,
        facet_cells=p.facet_cells,
        facet_flow=p.facet_flow,
        facet_dof_counts=counts,
        preserved=V,
        options=o,
    ).setup()
    s_levels = dist_stokes_hdiv_levels(
        pc.A_host, pc.mesh0, pc.dofs0, pc.pres0, o, 3
    )
    m_levels, m_log = mp_dist_stokes_hdiv_levels(
        pc.A_host, pc.mesh0, pc.dofs0, pc.pres0, o, 3
    )
    assert len(s_levels) == len(m_levels) >= 2
    assert m_log.peak_shard_bytes > 0
    for i, (sl, ml) in enumerate(zip(s_levels, m_levels)):
        np.testing.assert_array_equal(sl.dofs.offsets, ml.dofs.offsets)
        assert abs(sl.A - ml.A).max() == 0.0, f"L{i}"
        np.testing.assert_array_equal(
            sl.pres.vectors, ml.pres.vectors
        )
        if sl.P is not None or ml.P is not None:
            assert abs(sl.P - ml.P).max() == 0.0, f"P L{i}"
            np.testing.assert_array_equal(sl.v2agg, ml.v2agg)
