"""Multi-chip sharding of the AMG hierarchy (jax.sharding / GSPMD).

JAX replacement for the reference's MPI layer (SURVEY.md 2.1): the
domain decomposition of `ParallelDofs`/EQC row ownership becomes *row
sharding* of each level's block-ELL arrays over a 1-D device mesh; the
DCC/halo exchanges of `HybridMatrix`/`DCCMap`
(/root/reference/src/base/linalg/hybrid_matrix.hpp:28-144, dcc_map.hpp:20-134)
become XLA collectives inserted by GSPMD from sharding annotations; the
processor *contraction* on coarse levels (`GridContractMap`,
grid_contract.cpp:20) becomes the REPLICATION of levels smaller than
``replicate_below`` — coarse work is cheap and duplicating it removes all
communication, exactly the effect NgsAMG gets by shrinking its communicator.

Levels whose padded row count divides the mesh size are sharded row-wise;
vectors inherit the row sharding through the jitted solve (gathers of x
trigger all-gathers between devices). An explicit ppermute-based halo-exchange
SpMV for bandwidth-bound scaling lives in :mod:`ngsamg.parallel.halo`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solve.cycle import AMGOperator, DeviceLevel
from ..smoothers.core import ChebyshevSmoother, GSSmoother, JacobiSmoother
from ..sparse.bell import BlockELL
from ..sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    StencilDia,
    SupernodeELL,
    TileELL,
)


def make_mesh(n_devices: int | None = None, axis: str = "rows") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _put(x, sharding):
    return jax.device_put(x, sharding)


def _shard_bell(A: BlockELL, mesh: Mesh, rows: tuple) -> BlockELL:
    """``rows`` is the tuple of mesh axis names the row dim shards over
    (empty = replicated) — sub-tuples of one multi-axis mesh express the
    intermediate-contraction granularities without mixing meshes."""
    r0 = rows if rows else None
    row = NamedSharding(mesh, P(r0, None, None, None))
    rowc = NamedSharding(mesh, P(r0, None))
    return BlockELL(
        data=_put(A.data, row),
        cols=_put(A.cols, rowc),
        nrows=A.nrows,
        ncols=A.ncols,
        nrows_pad=A.nrows_pad,
        col_chunk=A.col_chunk,
    )


def _shard_mat(A, mesh: Mesh, rows: tuple):
    """Place any level operator format on the mesh (rows sharded or repl)."""
    repl = NamedSharding(mesh, P())
    r0 = rows if rows else None
    shard = bool(rows)
    if isinstance(A, BlockELL):
        return _shard_bell(A, mesh, rows)
    if isinstance(A, SupernodeELL):
        return SupernodeELL(
            inner=_shard_bell(A.inner, mesh, rows),
            nrows=A.nrows,
            nrows_pad=A.nrows_pad,
            tile_r=A.tile_r,
            tile_c=A.tile_c,
        )
    if isinstance(A, TileELL):
        rowd = NamedSharding(mesh, P(r0, None, None)) if shard else repl
        rowc = NamedSharding(mesh, P(r0, None)) if shard else repl
        return TileELL(
            data=_put(A.data, rowd),
            cols=_put(A.cols, rowc),
            nrows=A.nrows,
            nrows_pad=A.nrows_pad,
            ncols_pad=A.ncols_pad,
            tile_m=A.tile_m,
        )
    if isinstance(A, DiaMatrix):
        sh = NamedSharding(mesh, P(None, r0)) if shard else repl
        return DiaMatrix(
            data=_put(A.data, sh),
            offsets=A.offsets,
            nrows=A.nrows,
            nrows_pad=A.nrows_pad,
            sym_half=A.sym_half,
        )
    if isinstance(A, StencilDia):
        # scalar stencil values are tiny — replicate; the n-d shift matvec
        # partitions over the leading lattice dim with x's row sharding
        return StencilDia(
            vals=_put(A.vals, repl),
            offs=A.offs,
            dims=A.dims,
            nrows=A.nrows,
            nrows_pad=A.nrows_pad,
        )
    if isinstance(A, DenseMatrix):
        return DenseMatrix(
            data=_put(A.data, repl),
            nrows=A.nrows,
            nrows_pad=A.nrows_pad,
            bs=A.bs,
        )
    from ..transfer.lattice_transfer import (
        LatticeProlongation,
        LatticeRestriction,
    )

    if isinstance(A, (LatticeProlongation, LatticeRestriction)):
        import dataclasses as _dc

        rows2 = (
            NamedSharding(mesh, P(r0, None))
            if shard and A.Dinv.shape[0] != 1
            else repl
        )
        return _dc.replace(
            A,
            A=_shard_mat(A.A, mesh, rows),
            Dinv=_put(A.Dinv, rows2),
        )
    raise TypeError(type(A))


def _shard_smoother(sm, mesh: Mesh, rows: tuple):
    if sm is None:
        return None
    r0 = rows if rows else None
    shard = bool(rows)
    rows3 = (
        NamedSharding(mesh, P(r0, None, None))
        if shard
        else NamedSharding(mesh, P())
    )
    repl = NamedSharding(mesh, P())

    def dinv_sh(Dinv):
        # broadcast-scalar Dinv (uniform stencil levels) replicates
        return repl if Dinv.shape[0] == 1 else rows3

    if isinstance(sm, JacobiSmoother):
        return JacobiSmoother(
            Dinv=_put(sm.Dinv, dinv_sh(sm.Dinv)),
            omega=sm.omega,
            steps=sm.steps,
        )
    if isinstance(sm, ChebyshevSmoother):
        return ChebyshevSmoother(
            Dinv=_put(sm.Dinv, dinv_sh(sm.Dinv)),
            lam_max=_put(sm.lam_max, repl),
            lam_min=_put(sm.lam_min, repl),
            order=sm.order,
            steps=getattr(sm, "steps", 1),
        )
    from ..smoothers.block import BlockGSSmoother

    if isinstance(sm, BlockGSSmoother):
        # block sweeps gather arbitrary rows; keep the (small) block data
        # replicated — the level matrix itself may still be sharded
        return BlockGSSmoother(
            blocks=_put(sm.blocks, repl),
            Binv=_put(sm.Binv, repl),
            color_bounds=sm.color_bounds,
            steps=sm.steps,
        )
    from ..smoothers.hiptmair import HiptmairSmoother

    if isinstance(sm, HiptmairSmoother):
        # two-space smoother: C's rows live in the level's (range) row
        # space and follow its sharding; the potential space (loops) is
        # its own row space — shard its operator/CT/pot-smoother when the
        # padded pot dimension divides the mesh, else replicate (the
        # coarse-level/contraction rule applied to the pot space)
        n = int(np.prod([
            dict(zip(mesh.axis_names, mesh.devices.shape))[a] for a in rows
        ])) if rows else 1
        pot_rows = (
            rows if (shard and sm.A_pot.nrows_pad % max(n, 1) == 0) else ()
        )
        return HiptmairSmoother(
            range_sm=_shard_smoother(sm.range_sm, mesh, rows),
            pot_sm=_shard_smoother(sm.pot_sm, mesh, pot_rows),
            A_pot=_shard_mat(sm.A_pot, mesh, pot_rows),
            C=_shard_mat(sm.C, mesh, rows),
            CT=_shard_mat(sm.CT, mesh, pot_rows),
        )
    if isinstance(sm, GSSmoother):
        # GS shards fine: the coloring is GLOBAL, so rows of one color are
        # mutually independent across shards — simultaneous updates within
        # a color slice need no interface modification (a stronger
        # guarantee than the reference's l1-modified interface rows,
        # hybrid_smoother.hpp CalcModDiag). GSPMD partitions each color
        # slice across the row shards; the x gathers cross devices. This is
        # the answer to the 3-stage interior/interface overlap of
        # hybrid_base_smoother.hpp:56-61 — XLA overlaps the collective
        # with the independent per-color compute.
        return GSSmoother(
            Dinv=_put(sm.Dinv, rows3),
            color_bounds=sm.color_bounds,
            steps=sm.steps,
        )
    raise TypeError(type(sm))


def shard_operator(
    op: AMGOperator,
    A0: BlockELL,
    mesh: Mesh,
    *,
    axis: str = "rows",
    replicate_below: int = 4096,
    min_local_rows: int = 512,
    shards_hint: tuple | list | None = None,
) -> tuple[AMGOperator, BlockELL]:
    """Place the hierarchy on a device mesh: fine levels row-sharded,
    mid-size levels sharded over 2^k-device SUB-GROUPS (replicated across
    the rest — the `GridContractMap`/`FindRDFac` analog,
    grid_contract.cpp:20, base_factory.cpp:573: processors regroup
    gradually instead of jumping from all-ranks to one), coarsest levels
    fully replicated. A level lands on the largest power-of-two shard
    count that divides its padded rows and keeps >= ``min_local_rows``
    rows per shard.

    All granularities live on ONE factored mesh (axes of size 2): a
    j=2^k-way level shards its rows over the first k axes and replicates
    over the rest. Intermediates crossing DIFFERENT Mesh objects inside
    one jitted program produce wrong values under GSPMD (measured), so
    a single mesh is a correctness requirement, not a style choice.
    """
    n = mesh.devices.size
    devs = mesh.devices.reshape(-1)
    m = 0
    while (1 << (m + 1)) <= n:
        m += 1
    factored = (1 << m) == n and n > 1
    if factored:
        fmesh = Mesh(
            devs.reshape((2,) * m),
            tuple(f"{axis}{k}" for k in range(m)),
        )
        fax = fmesh.axis_names
    else:
        fmesh = mesh  # non-power-of-two: binary shard-or-replicate
        fax = (axis,)
    repl = NamedSharding(fmesh, P())

    def rows_for(j: int) -> tuple:
        if j <= 1:
            return ()
        if not factored:
            return fax if j == n else ()
        k = 0
        while (1 << (k + 1)) <= j:
            k += 1
        return tuple(fax[:k])

    def _lead(fmt) -> int:
        # size of the dimension the row sharding actually partitions
        if isinstance(fmt, TileELL):
            return fmt.data.shape[0]  # tiles
        if isinstance(fmt, SupernodeELL):
            return fmt.inner.data.shape[0]
        if isinstance(fmt, BlockELL):
            return fmt.data.shape[0]
        return fmt.nrows_pad

    def n_shards_for(fmt) -> int:
        if isinstance(fmt, DenseMatrix):
            return 1
        lead = _lead(fmt)
        if fmt.nrows >= replicate_below and lead % n == 0:
            return n
        if not factored:
            return 1
        j = n // 2
        while j > 1 and (
            lead % j != 0 or fmt.nrows // j < min_local_rows
        ):
            j //= 2
        return max(j, 1)

    new_levels = []
    for li, lev in enumerate(op.levels):
        j = n_shards_for(lev.A)
        # the level loop's OWN contraction decision (TryContractStep
        # analog, FactoryLog.shards_per_level) caps the placement: a
        # level the setup concentrated onto k shards is not spread back
        # over more devices than the setup's k
        if shards_hint is not None and li < len(shards_hint):
            k = 1
            while (k << 1) <= int(shards_hint[li]):
                k <<= 1
            j = min(j, k) if int(shards_hint[li]) > 0 else j
        rows = rows_for(j)
        if isinstance(lev.A, TileELL) and j == n and j > 1:
            # fully-row-sharded unstructured levels exchange INTERFACE
            # values only (hybrid_matrix.hpp:28-144 / dcc_map.hpp:20-134
            # in compiled form) instead of the O(n) GSPMD all-gather of x
            from .halo import halo_tile_ell

            A_s = halo_tile_ell(lev.A, fmesh, rows)
        elif (
            isinstance(lev.A, BlockELL)
            and lev.A.col_chunk == 1
            and j == n
            and j > 1
            and isinstance(lev.smoother, (JacobiSmoother, ChebyshevSmoother))
        ):
            # BLOCK levels (elasticity) get the same hybrid-matrix
            # structure — the reference's M+G split covers every block
            # size (hybrid_matrix.hpp:28-144); GS levels keep the plain
            # sharded BlockELL (the colored sweep slices matrix rows)
            from .halo import halo_block_ell

            A_s = halo_block_ell(lev.A, fmesh, rows)
        else:
            A_s = _shard_mat(lev.A, fmesh, rows)
        sm_s = _shard_smoother(lev.smoother, fmesh, rows)
        P_s = R_s = None
        if lev.P is not None:
            # P rows live on this (fine) level; R rows on the coarse
            # level. On PARTIALLY-replicated (contraction) levels P must
            # stay replicated: a sub-sharded P's gather makes the XLA
            # SPMD partitioner rewrite UPSTREAM computations incorrectly
            # (measured: 0.21 relative error appearing in the level
            # residual once matvec(P, x2) joins the graph; exact with P
            # replicated). Contraction-level transfers are small anyway.
            P_rows = rows if (j == n or j <= 1) else ()
            P_s = _shard_mat(lev.P, fmesh, P_rows)
            R_s = _shard_mat(lev.R, fmesh, ())
        new_levels.append(DeviceLevel(A=A_s, smoother=sm_s, P=P_s, R=R_s))
    cinv = None if op.coarse_inv is None else _put(op.coarse_inv, repl)
    cc = (
        None
        if op.cluster_corr is None
        else jax.tree_util.tree_map(
            lambda x: _put(np.asarray(x), repl), op.cluster_corr
        )
    )
    op_s = AMGOperator(
        levels=tuple(new_levels),
        coarse_inv=cinv,
        cluster_corr=cc,
        cycle=op.cycle,
    )
    A0_s = new_levels[0].A
    return op_s, A0_s


def level_shard_counts(op: AMGOperator) -> tuple[int, ...]:
    """Row-shard count per level (tests/introspection): the number of
    devices the level's operator rows are partitioned over."""
    out = []
    for lev in op.levels:
        arr = getattr(lev.A, "data", None)
        if arr is None:
            arr = getattr(getattr(lev.A, "inner", None), "data", None)
        if arr is None or not hasattr(arr, "sharding"):
            out.append(1)
            continue
        sh = arr.sharding
        spec = getattr(sh, "spec", None)
        if not spec or all(s is None for s in spec):
            out.append(1)
            continue
        mesh_shape = dict(zip(sh.mesh.axis_names, sh.mesh.devices.shape))
        cnt = 1
        for s in spec:
            if s is None:
                continue
            for name in (s if isinstance(s, tuple) else (s,)):
                cnt *= mesh_shape[name]
        out.append(cnt)
    return tuple(out)
