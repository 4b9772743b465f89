"""The solve's precision policy: every matrix product the device solve
traces runs at full f32 precision (``utils.jaxcfg.full_f32``).

On a GPU an f32 product left at default precision may run in TF32 and
change the preconditioner; on the CPU it would not show. So these tests
read the traced programs instead: every ``dot_general`` in them, through
nested jits, loops and ``shard_map`` bodies, must carry ``HIGHEST``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ngsamg import AMGOptions, AMGPreconditioner
from ngsamg.config import SmootherOptions, SmootherType
from ngsamg.solve.cycle import amg_apply
from ngsamg.solve.pcg import (
    _pcg_chunk, _pcg_init, _pcg_mixed_chunk, _si_chunk,
)
from ngsamg.sparse import formats
from ngsamg.utils import fem

FULL = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
TOL2 = np.float32(1e-16)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(sub, "eqns"):
                    yield from _dot_precisions(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    yield from _dot_precisions(sub.jaxpr)


def _assert_full(fn, *args):
    precs = list(_dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr))
    assert precs, "no matrix product traced"
    assert all(p == FULL for p in precs), precs


def _opts(smoother, **kw):
    opts = AMGOptions(**kw)
    opts.smoother = SmootherOptions(type=SmootherType(smoother))
    opts.levels.max_coarse_size = 60
    return opts


def _poisson(smoother):
    prob = fem.poisson_3d(12)
    return AMGPreconditioner(
        prob.A, coords=prob.coords, options=_opts(smoother)
    ).setup(), prob.b


def _unstructured():
    prob = fem.unstructured_poisson(12, dim=2, refine=1)
    return AMGPreconditioner(
        prob.A, coords=prob.coords, options=_opts("chebyshev")
    ).setup(), prob.b


def _elasticity():
    prob = fem.unstructured_elasticity(16, dim=2)
    return AMGPreconditioner(
        prob.A, energy="elasticity", block_size=2, coords=prob.coords,
        options=_opts("gs"),
    ).setup(), prob.b


def _stokes():
    from ngsamg.precond.stokes import StokesAMG
    from ngsamg.utils.stokes_fem import stokes_tri

    prob, _ = stokes_tri(4, dim=2, alpha=10.0)
    pc = StokesAMG(
        prob.A, cell_pos=prob.cell_pos, cell_vol=prob.cell_vol,
        facet_cells=prob.facet_cells, facet_flow=prob.facet_flow,
        facet_verts=prob.facet_verts, vert_pos=prob.vert_pos,
        bnd_facet_verts=prob.bnd_facet_verts, options=AMGOptions(),
    ).setup()
    return pc, prob.b


@pytest.mark.parametrize(
    "make",
    [
        lambda: _poisson("chebyshev"),
        lambda: _poisson("gs"),
        _unstructured,
        _elasticity,
        _stokes,
    ],
    ids=["poisson-cheby", "poisson-gs", "unstructured", "elasticity",
         "stokes"],
)
def test_pcg_chunk_products_at_full_f32(make):
    pc, b = make()
    _assert_full(
        lambda op, A, s, t: _pcg_chunk(op, A, s, t, chunk=1),
        pc.op, pc.A_dev, _pcg_init(pc._to_dev(b)), TOL2,
    )


def test_stationary_chunk_and_cycle_at_full_f32():
    pc, b = _poisson("chebyshev")
    bd = pc._to_dev(b)
    state = (jnp.zeros_like(bd), bd, jnp.float32(1.0), jnp.int32(0))
    _assert_full(
        lambda op, A, s, t: _si_chunk(op, A, s, t, chunk=1),
        pc.op, pc.A_dev, state, TOL2,
    )
    _assert_full(amg_apply, pc.op, bd)


def test_mixed_chunk_at_full_f32():
    pc, b = _elasticity()
    A64 = pc._ensure_A64_mixed()
    assert A64 is not None
    with jax.enable_x64(True):
        b64 = jnp.asarray(np.asarray(pc._to_dev(b)), jnp.float64)
        z = jnp.zeros_like(b64)
        state = (z, b64, z, jnp.float64(0.0), jnp.float64(1.0),
                 jnp.int32(0))
        _assert_full(
            lambda op, A, s, t: _pcg_mixed_chunk(op, A, s, t, chunk=1),
            pc.op, A64, state, np.float64(1e-16),
        )


def test_sharded_halo_chunk_at_full_f32():
    from ngsamg.parallel.halo import HaloTileELL
    from ngsamg.parallel.shard import make_mesh, shard_operator

    prob = fem.unstructured_poisson(40, dim=2, refine=1)
    pc = AMGPreconditioner(
        prob.A, coords=prob.coords, options=_opts("chebyshev", shards=4)
    ).setup()
    op, A = shard_operator(pc.op, pc.A_dev, make_mesh(4),
                           replicate_below=100)
    assert any(isinstance(lev.A, HaloTileELL) for lev in op.levels)
    _assert_full(
        lambda op, A, s, t: _pcg_chunk(op, A, s, t, chunk=1),
        op, A, _pcg_init(pc._to_dev(prob.b)), TOL2,
    )


def test_unscoped_product_is_caught():
    """The check sees a product traced outside the policy."""
    A = formats.DenseMatrix(
        data=jnp.eye(8, dtype=jnp.float32), nrows=8, nrows_pad=8, bs=1
    )
    x = jnp.ones((8, 1), jnp.float32)
    jaxpr = jax.make_jaxpr(formats.matvec)(A, x).jaxpr
    precs = list(_dot_precisions(jaxpr))
    assert precs and all(p != FULL for p in precs)
