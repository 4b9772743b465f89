"""AMG preconditioner front-end (strict algebraic mode).

Device-solve re-creation of `BaseAMGPC` / `VertexAMGPC`
(/root/reference/src/base/precond/amg_pc.hpp:26-257, amg_pc_vertex.hpp:14-302)
in the reference's *strict algebraic mode* (amg_pc.hpp:126-137,
amg_register.hpp:24-100): the preconditioner is constructed from a bare
sparse matrix + optional free-DOF mask + optional vertex coordinates, with no
finite-element host. Lifecycle:

  AMGPreconditioner(A, ...) -> .setup()  (BuildAMGMat analog:
      host factory level loop -> smoothers -> coarse inverse ->
      device compile)                     -> .solve(b) / .apply(r)

The solve phase runs entirely on device in the configured dtype (f32 by
default); `solve` wraps the device PCG in a float64 defect-correction outer
loop so that tight tolerances (1e-8..1e-12) are reached with an f32 cycle —
the counterpart of the reference's all-f64 CPU solve.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

from ..apps.base import Energy
from ..apps.elasticity import ElasticityEnergy
from ..apps.h1 import H1Energy
from ..config import AMGOptions, CoarseSolveType, options_from_flags
from ..factory.levels import setup_levels
from ..smoothers.build import build_smoother, plan_row_order
from ..solve.cycle import AMGOperator, DeviceLevel, amg_apply
from ..solve.pcg import SolveResult, pcg, pcg_mixed
from ..sparse import bell, formats

ROW_ALIGN = 8


def _block_pad(fmt, bs: int) -> int:
    """Padded block-row count of a level operator (smoother sizing)."""
    return fmt.nrows_pad


def _scalar_pad(fmt, bs: int) -> int:
    """Padded scalar length of a level's vectors."""
    if isinstance(
        fmt,
        (
            formats.DiaMatrix,
            formats.SupernodeELL,
            formats.StencilDia,
            formats.TileELL,
            formats.TileELLStack,
        ),
    ):
        return fmt.nrows_pad  # scalar units (bs == 1 formats)
    return fmt.nrows_pad * bs


@jax.jit
def _refine_residual(A64, b64, x64):
    r = b64 - formats.matvec(A64, x64)
    return r, jnp.vdot(r[:, 0], r[:, 0])


from functools import partial as _partial


@_partial(
    jax.jit,
    static_argnames=("offs", "dims", "nslabs", "nrows", "nrows_pad"),
)
def _refine_residual_slabbed(
    vals, b64, x64, *, offs, dims, nslabs, nrows, nrows_pad
):
    """f64 residual r = b - A x over a StencilDia, in dim-0 lattice slabs.

    The whole-lattice f64 stencil matvec may materialize a padded copy of
    x plus shifted temporaries per stencil offset — up to ~17 vector-sized
    f64 buffers, which bound the largest lattice one device can hold.
    Computing the residual slab-by-slab
    (static slices, sequential through the output buffer so XLA's
    live-range allocator reuses one slab's temporaries for the next)
    bounds the transient footprint to O(n / nslabs).
    """
    d = len(dims)
    d0 = dims[0]
    rr = [max(abs(int(o[k])) for o in offs) for k in range(d)]
    slab = -(-d0 // nslabs)
    d0pad = slab * nslabs
    restn = nrows // d0
    x3 = x64[:nrows, 0].reshape(dims)
    xp = jnp.pad(
        x3,
        [(rr[0], d0pad - d0 + rr[0])]
        + [(rr[k], rr[k]) for k in range(1, d)],
    )
    bflat = b64[:nrows, 0]
    rbuf = jnp.zeros((d0pad * restn,), x64.dtype)
    rest_shape = tuple(dims[1:])
    for i in range(nslabs):
        a = i * slab
        y = jnp.zeros((slab,) + rest_shape, x64.dtype)
        for t, off in enumerate(offs):
            sl = (
                slice(a + rr[0] + int(off[0]), a + rr[0] + int(off[0]) + slab),
            ) + tuple(
                slice(rr[k] + int(off[k]), rr[k] + int(off[k]) + dims[k])
                for k in range(1, d)
            )
            y = y + vals[t] * xp[sl]
        lo, hi = a * restn, min((a + slab) * restn, nrows)
        rs = bflat[lo:hi] - y.reshape(-1)[: hi - lo]
        rbuf = lax.dynamic_update_slice(rbuf, rs, (lo,))
    r = jnp.pad(rbuf[:nrows], (0, nrows_pad - nrows))[:, None]
    return r, jnp.vdot(r[:, 0], r[:, 0])


@_partial(jax.jit, static_argnames=("dt",))
def _refine_scale(r64, inv_rn, dt):
    return (r64 * inv_rn).astype(jnp.dtype(dt))


@jax.jit
def _refine_accumulate(x64, dx32, rn):
    return x64 + dx32.astype(jnp.float64) * rn


def _spd_inverse(Ad: np.ndarray) -> np.ndarray:
    """Dense inverse of an SPD matrix: Cholesky (4x faster than the
    eigh-based pinv at ~3000 rows), pseudo-inverse fallback for the
    singular/regularized cases (`RegularizeMatrix` analog).

    Cholesky on a NEAR-singular matrix can succeed numerically while
    producing a garbage inverse (measured ||A^-1 A - I|| = 735 on a
    coarsest elasticity matrix whose rot null mode had been fuzzed to
    -8e-9 by f32 rounding) — so the result is verified on a random
    vector and falls back to the eigh pseudo-inverse when inaccurate."""
    try:
        import scipy.linalg as sla

        cf = sla.cho_factor(Ad, lower=True, check_finite=False)
        inv = sla.cho_solve(
            cf, np.eye(Ad.shape[0]), check_finite=False
        )
        v = np.random.default_rng(0).standard_normal(Ad.shape[0])
        err = np.linalg.norm(Ad @ (inv @ v) - v) / np.linalg.norm(v)
        if not np.isfinite(err) or err > 1e-8:
            raise np.linalg.LinAlgError(f"cho inverse off by {err:.1e}")
        return inv
    except Exception:
        return np.linalg.pinv(Ad, rcond=1e-10, hermitian=True)


@dataclass
class SolveInfo:
    iterations: int
    relres: float
    outer_iterations: int = 1
    converged: bool = True
    history: list = field(default_factory=list)


class AMGPreconditioner:
    """Algebraic multigrid preconditioner, device-resident solve phase."""

    def __init__(
        self,
        A: sp.spmatrix,
        *,
        energy: Energy | str = "h1",
        block_size: int = 1,
        coords: np.ndarray | None = None,
        freedofs: np.ndarray | None = None,
        options: AMGOptions | None = None,
        elmat_data: tuple | None = None,
        nodalp2: np.ndarray | None = None,
        dof_layout: str = "interleaved",
        **flags,
    ):
        if options is None:
            options = options_from_flags(flags) if flags else AMGOptions()
        self.options = options
        self.freedofs = None if freedofs is None else np.asarray(freedofs, bool)
        self._ext_free = None  # external->internal dof map (perm/subset)
        self._scale0 = None  # symmetric-scaling boundary (f32 hierarchies)
        self._x64_cycle = False  # cycle carries an f64 coarse solve
        if dof_layout == "compound":
            # component-major user layout [x0..xn, y0..yn, ...] permuted to
            # the interleaved internal layout (the reference's compound
            # FESpace tests, tests/h1/simple/test_vec.py)
            if self.freedofs is not None:
                raise ValueError("compound layout: pre-eliminate freedofs")
            A = A.tocsr()
            nv = A.shape[0] // block_size
            p = (
                np.arange(block_size)[None, :] * nv
                + np.arange(nv)[:, None]
            ).ravel()  # internal = external[p]
            A = A[p][:, p].tocsr()
            self._ext_free = np.argsort(p)
        elif dof_layout != "interleaved":
            raise ValueError(f"unknown dof_layout {dof_layout!r}")
        if not (isinstance(A, sp.dia_matrix) and self.freedofs is None):
            # DIA input feeds the structured fast path without a CSR detour
            A = A.tocsr()
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"matrix must be square, got {A.shape}")
        if A.shape[0] % block_size:
            raise ValueError(
                f"matrix size {A.shape[0]} not divisible by "
                f"block_size {block_size}"
            )
        if self.freedofs is not None:
            fd = self.freedofs
            vany = fd.reshape(-1, block_size).any(axis=1)
            vall = fd.reshape(-1, block_size).all(axis=1)
            if block_size > 1 and (vany & ~vall).any():
                # partial Dirichlet (some components of a vertex fixed):
                # keep ALL dofs of touched vertices and project the
                # constrained components — rows/cols zeroed, diagonal kept
                # (the reference's scalFreeRows projection,
                # amg_pc_vertex_impl.hpp:693-733). Externally the
                # preconditioner still exposes only the free dofs.
                kept = np.flatnonzero(np.repeat(vany, block_size))
                A = A[kept][:, kept].tocsr()
                sub_free = fd[kept]
                coo = A.tocoo()
                keep_e = (sub_free[coo.row] & sub_free[coo.col]) | (
                    coo.row == coo.col
                )
                A = sp.coo_matrix(
                    (coo.data[keep_e], (coo.row[keep_e], coo.col[keep_e])),
                    shape=A.shape,
                ).tocsr()
                self._ext_free = np.flatnonzero(sub_free)
            else:
                # subset selection (DOF subsets, amg_pc_vertex.hpp:211)
                idx = np.flatnonzero(self.freedofs)
                A = A[idx][:, idx].tocsr()
            if coords is not None:
                coords = np.asarray(coords)[vany]
        # nodal-P2 two-parent embedding (amg_pc_vertex.hpp:211-244,
        # elasticity_pc_impl.hpp nodal-P2 rows): AMG coarsens the vertex
        # subset; midnodes embed as the average of their two parents.
        # ``nodalp2``: (m, 3) int (midnode, parent1, parent2) in BLOCK-node
        # numbering over the (possibly freedofs-reduced) matrix; ``coords``
        # then holds the VERTEX (parent) coordinates only.
        self._nodalp2 = None
        if nodalp2 is not None:
            if self.freedofs is not None:
                raise ValueError("nodalp2 with freedofs: eliminate first")
            self._nodalp2 = np.asarray(nodalp2, dtype=np.int64)
        self.A_host = A if A.dtype == np.float64 else A.astype(np.float64)
        self.n = A.shape[0]
        self.coords = None if coords is None else np.asarray(coords, float)
        if isinstance(energy, str):
            if energy == "h1":
                energy = H1Energy(bs=block_size)
            elif energy in ("elasticity", "elast"):
                from ..apps.elasticity import ElasticityEnergy

                if self.coords is None:
                    raise ValueError("elasticity energy requires coords")
                energy = ElasticityEnergy(dim=self.coords.shape[1])
            else:
                raise ValueError(f"unknown energy '{energy}'")
        self.energy = energy
        # energy-specific coarsening default (the reference carries
        # per-app factory defaults): block energies need goal-driven
        # aggregate sizes — fixed 2-round pairs give oc ~5 at 1M DoF
        # with 3x3-block smoothed prolongations (measured: aaf 0.08 ->
        # oc 2.1 at 32 iterations vs oc 4.7 at 26)
        default_aaf = getattr(self.energy, "default_aaf", None)
        if (
            default_aaf is not None
            and self.options.coarsen.aaf.default is None
            and not self.options.coarsen.aaf.spec
        ):
            import copy as _copy
            from ..config import SpecOpt as _SpecOpt

            co = _copy.copy(self.options.coarsen)
            co.aaf = _SpecOpt(float(default_aaf))
            self.options = self.options.replace(coarsen=co)
        self.dtype = jnp.dtype(self.options.dtype)
        if self.dtype == jnp.float64 and not jax.config.jax_enable_x64:
            # explicit f64 request must not silently truncate to f32
            jax.config.update("jax_enable_x64", True)
        # ELMAT energy mode: finest mesh from element matrices
        # (AddElementMatrix analog; reference amg_pc_vertex.hpp:170)
        self._finest_mesh = None
        if elmat_data is not None:
            from ..apps.elmat import ElmatAccumulator

            dnums, elmats = elmat_data
            nv = self.n // self.energy.dpv
            acc = ElmatAccumulator(nv)
            acc.add_batch(np.asarray(dnums), np.asarray(elmats))
            self._finest_mesh = acc.finalize(self.coords)
        self._is_setup = False

    # ------------------------------------------------------------------
    # setup (BuildAMGMat, amg_pc.cpp:565-736)
    # ------------------------------------------------------------------
    def setup(self) -> "AMGPreconditioner":
        t0 = time.perf_counter()
        if self._nodalp2 is not None:
            self._setup_nodalp2_levels()
        elif (
            self.options.dist_setup > 1
            and isinstance(self.energy, (H1Energy, ElasticityEnergy))
            and self._finest_mesh is None
        ):
            from ..parallel.dist_setup import dist_setup_levels

            self.setup_levels_, self.log_ = dist_setup_levels(
                self.A_host, self.energy, self.options,
                self.options.dist_setup, coords=self.coords,
            )
        else:
            self.setup_levels_, self.log_ = setup_levels(
                self.A_host, self.energy, self.options, self.coords,
                finest_mesh=self._finest_mesh,
            )
        t1 = time.perf_counter()
        self._compile_device()
        t2 = time.perf_counter()
        self.setup_time_host = t1 - t0
        self.setup_time_device = t2 - t1
        self._is_setup = True
        if self.options.log_level >= 1:
            print(self.log_.summary())
            print(
                f"setup: host {self.setup_time_host:.3f}s, "
                f"device compile {self.setup_time_device:.3f}s"
            )
        if self.options.do_test:
            lmin, lmax = self.test()
            print(f"eigenvalue bounds of M^-1 A: [{lmin:.4g}, {lmax:.4g}]")
        return self

    def _setup_nodalp2_levels(self):
        """Nodal-P2 hierarchy: midnodes embed into their parent vertices.

        The full matrix stays the finest (smoothed) level; the AMG runs on
        the vertex-subspace operator E^T A E with the two-parent embedding
        E as the level-0 transfer (the reference's nodalp2 subset +
        smooth_lo_only pattern, amg_pc_vertex.hpp:211-244)."""
        from ..factory.levels import SetupLevel
        from ..mesh.topo import AlgebraicMesh

        bs = self._bs_guess()
        A_full = self.A_host.tocsr()
        E = self._nodalp2_embedding(bs)
        A1 = (E.T @ A_full @ E).tocsr()
        A1 = ((A1 + A1.T) * 0.5).tocsr()
        levels1, log1 = setup_levels(
            A1, self.energy, self.options, self.coords
        )
        for lev in levels1:
            lev.index += 1
        n_nodes = self.n // bs
        lev0 = SetupLevel(
            index=0,
            A=A_full,
            row_bs=bs,
            mesh=AlgebraicMesh(
                nv=n_nodes, edges=np.zeros((0, 2), dtype=np.int64)
            ),
            P=E.tobsr(blocksize=(bs, bs)),
        )
        self.setup_levels_ = [lev0] + levels1
        log1.nvs.insert(0, n_nodes)
        log1.nnzs.insert(0, int(A_full.nnz))
        self.log_ = log1

    def _bs_guess(self) -> int:
        dpv = getattr(self.energy, "bs", None)
        if dpv is not None:
            return int(dpv)  # H1 scalar/vector
        return int(getattr(self.energy, "dim", 1))  # elasticity: disp dofs

    def _nodalp2_embedding(self, bs: int) -> sp.csr_matrix:
        """E: vertex-space dofs -> full dofs; midnode = mean of parents."""
        n_nodes = self.n // bs
        trip = self._nodalp2
        is_mid = np.zeros(n_nodes, dtype=bool)
        is_mid[trip[:, 0]] = True
        vnum = np.full(n_nodes, -1, dtype=np.int64)
        verts = np.flatnonzero(~is_mid)
        vnum[verts] = np.arange(len(verts))
        if (vnum[trip[:, 1]] < 0).any() or (vnum[trip[:, 2]] < 0).any():
            raise ValueError("nodalp2 parents must be vertex nodes")
        k = np.arange(bs)
        rows = [
            (verts[:, None] * bs + k).ravel(),
            (trip[:, :1] * bs + k).ravel(),
            (trip[:, :1] * bs + k).ravel(),
        ]
        cols = [
            (vnum[verts][:, None] * bs + k).ravel(),
            (vnum[trip[:, 1]][:, None] * bs + k).ravel(),
            (vnum[trip[:, 2]][:, None] * bs + k).ravel(),
        ]
        vals = [
            np.ones(len(verts) * bs),
            np.full(len(trip) * bs, 0.5),
            np.full(len(trip) * bs, 0.5),
        ]
        return sp.coo_matrix(
            (
                np.concatenate(vals),
                (np.concatenate(rows), np.concatenate(cols)),
            ),
            shape=(self.n, len(verts) * bs),
        ).tocsr()

    @property
    def _row_align(self) -> int:
        return ROW_ALIGN * max(int(self.options.shards), 1)

    def _compile_device(self):
        opts = self.options
        nlev = len(self.setup_levels_)
        # bucketed/chunked tile-ELL only on single-device placements:
        # row-sharding assumes uniform per-level arrays (parallel/shard.py,
        # parallel/halo.py stay on the plain TileELL layout).
        # NGSAMG_NO_TILE_STACK=1 forces plain tile-ELL (fewer ops per
        # matvec for more stored bytes).
        self._use_tile_stack = int(opts.shards) <= 1 and os.environ.get(
            "NGSAMG_NO_TILE_STACK", "0"
        ) != "1"
        stages = self._device_stage_times = {}
        _t0 = time.perf_counter()

        def _mark(name):
            nonlocal _t0
            t = time.perf_counter()
            stages[name] = stages.get(name, 0.0) + (t - _t0)
            _t0 = t

        # 1) per-level row ordering: GS levels are permuted so that graph
        # colors occupy contiguous row slices (static-slice sweeps on device)
        perms, bounds, scal_perms = [], [], []
        for i, lev in enumerate(self.setup_levels_):
            is_coarsest = i == nlev - 1
            need_smoother = (not is_coarsest) or (
                opts.coarse_solve != CoarseSolveType.INV
            )
            perm = cb = None
            if lev.stencil is not None:
                pass  # stencil levels stay in natural (lattice) order
            elif need_smoother:
                perm, cb = plan_row_order(lev.A, lev.row_bs, opts.smoother, i)
            if perm is None and lev.stencil is None:
                # non-GS level: RCM reorder if it will be supernoded;
                # single-device levels additionally tile-sort so the
                # bucketed/chunked tile-ELL packs contiguous runs
                perm = formats.plan_reorder(
                    lev.A, lev.row_bs, self._row_align,
                    tile_sort_chunk=(
                        formats.TILE_CHUNK if self._use_tile_stack
                        else None
                    ),
                )
            perms.append(perm)
            bounds.append(cb)
            scal_perms.append(
                None
                if perm is None
                else (perm[:, None] * lev.row_bs
                      + np.arange(lev.row_bs)).ravel()
            )
        self._perm0 = scal_perms[0]
        self._iperm0 = (
            None if self._perm0 is None else np.argsort(self._perm0)
        )
        _mark("row_order")

        # 2) pick a device format per level and build the operators + smoothers
        # in the (possibly color-permuted) ordering. GS levels must stay in
        # block-ELL (the colored sweep slices its data/cols directly);
        # everything else goes through the format chooser (DIA for
        # stencil-like levels, supernoded ELL for unstructured scalar
        # levels, dense matvec for small coarse levels).
        from ..native import csr_permute as _nat_permute

        # Per-level symmetric diagonal scaling for sub-f64 device dtypes:
        # stage A'_l = S_l A_l S_l (unit diagonal) and P'_l = S_l^-1 P_l
        # S_{l+1}, so every Galerkin identity holds on the scaled hierarchy
        # and the solve boundary maps x = S_0 y, r' = S_0 r. The hierarchy
        # itself (aggregates, transports, P) is still built in f64 on the
        # UNSCALED operator — RBM/energy semantics are untouched; scaling
        # is purely a device-staging conditioner. Without it the f32 cycle
        # collapses on ill-scaled block energies (measured: 1.25M-DoF 3D
        # elasticity DIVERGES unscaled, 740 iters at 6k; scaled it matches
        # the f64 iteration count). The reference never faces this — it is
        # all-f64 (utils_denseLA.hpp LAPACK paths); here f32 + scaling +
        # f64 defect correction is the default scheme.
        self._scale0 = None
        use_scaling = jnp.dtype(self.dtype) != jnp.float64 and all(
            lev.stencil is None and lev.lattice_transfer is None
            for lev in self.setup_levels_
        )
        svecs: list = [None] * nlev

        def _sym_scale(A, i):
            """Scale A (CSR/BSR, already permuted) to unit diagonal."""
            d = A.diagonal()
            s = np.where(d > 0, 1.0 / np.sqrt(np.where(d > 0, d, 1.0)), 1.0)
            svecs[i] = s
            if sp.issparse(A) and A.format == "bsr":
                from ..native import bsr_sym_scale as _nat_bscale

                data = _nat_bscale(A, s)
                if data is None:
                    R, C = A.blocksize
                    brow = np.repeat(
                        np.arange(A.shape[0] // R), np.diff(A.indptr)
                    )
                    sr = s[brow[:, None] * R + np.arange(R)]
                    scl = s[A.indices[:, None] * C + np.arange(C)]
                    data = A.data * sr[:, :, None] * scl[:, None, :]
                out = sp.bsr_matrix(
                    (data, A.indices, A.indptr), shape=A.shape
                )
                out.has_sorted_indices = A.has_sorted_indices
                return out
            A = A.tocsr()
            from ..native import csr_sym_scale as _nat_scale

            dat = _nat_scale(A, s)
            if dat is None:
                rows = np.repeat(
                    np.arange(A.shape[0]), np.diff(A.indptr)
                )
                dat = A.data * (s[rows] * s[A.indices])
            return sp.csr_matrix(
                (dat, A.indices, A.indptr), shape=A.shape
            )

        A_fmts, A_perm, sms = [], [], []
        for i, lev in enumerate(self.setup_levels_):
            A = lev.A
            if (
                A is not None
                and lev.row_bs > 1
                and lev.stencil is None
                and getattr(A, "_amg_bsr_cache", None) is not None
            ):
                # block levels with a cached BSR view (seeded by the
                # fused block RAP) stay in the BLOCK domain through
                # permute + scaling + packing: one data gather instead
                # of csr-permute + csr_tobsr moving the bytes twice
                from ..sparse.host import bsr_permute, to_bsr

                A_b = to_bsr(A, lev.row_bs)
                if perms[i] is not None:
                    A_b = bsr_permute(A_b, perms[i])
                if use_scaling:
                    A_b = _sym_scale(A_b, i)
                A = A_b
            else:
                if A is not None and scal_perms[i] is not None:
                    p = scal_perms[i]
                    Ap = _nat_permute(A, p, p)
                    A = Ap if Ap is not None else A[p][:, p].tocsr()
                if use_scaling and A is not None:
                    A = _sym_scale(A, i)
            _mark("permute")
            A_perm.append(A)
            if lev.stencil is not None:
                A_fmt = formats.format_from_stencil(
                    lev.stencil, self.dtype, self._row_align, stage=True
                )
            elif bounds[i] is not None:  # GS level
                A_fmt = bell.from_scipy(
                    A, lev.row_bs, lev.row_bs, dtype=self.dtype,
                    row_align=self._row_align, stage=True,
                )
            else:
                A_fmt = formats.choose_format(
                    A, lev.row_bs, self.dtype, self._row_align, stage=True,
                    stack_chunk=(
                        formats.TILE_CHUNK if self._use_tile_stack
                        else None
                    ),
                    # default 1 (off): block gathers already fetch bc
                    # elements per slot, so C=2 chunking only adds
                    # zero-fill on 3D elasticity (slots 23->17 but
                    # gathered elements 28.7M->42.5M at 1.25M DoF).
                    block_chunk=(
                        int(os.environ.get("NGSAMG_BLOCK_CHUNK", "1"))
                        if self._use_tile_stack
                        else None
                    ),
                )
            A_fmts.append(A_fmt)
            _mark("pack_A")
            is_coarsest = i == nlev - 1
            need_smoother = (not is_coarsest) or (
                opts.coarse_solve != CoarseSolveType.INV
            )
            # single-device GS levels get per-color SPLIT matrix storage
            # (from the already-packed staged ELL arrays — no extra host
            # pass); sharded placements keep the sliced variant, whose
            # uniform arrays the row partitioner can split
            gs_ell = (
                (A_fmt.data, A_fmt.cols)
                if (
                    self._use_tile_stack
                    and bounds[i]
                    and isinstance(A_fmt, bell.BlockELL)
                )
                else None
            )
            sms.append(
                build_smoother(
                    A, lev.row_bs, opts.smoother, i,
                    _block_pad(A_fmt, lev.row_bs), self.dtype,
                    color_bounds=bounds[i],
                    stencil=lev.stencil,
                    ell=gs_ell,
                )
                if need_smoother
                else None
            )
            _mark("smoothers")

        dev_levels = []
        for i, lev in enumerate(self.setup_levels_):
            P_fmt = R_fmt = None
            if lev.P is not None or lev.lattice_transfer is not None:
                # column block size = the NEXT level's dofs per vertex
                # (equals energy.dpv except for synthetic embedding levels)
                dpv = self.setup_levels_[i + 1].row_bs
                P = Pb_blk = None
                if (
                    lev.P is not None
                    and sp.issparse(lev.P)
                    and lev.P.format == "bsr"
                    and lev.P.blocksize == (lev.row_bs, dpv)
                    and lev.row_bs * dpv > 1
                ):
                    # block-domain staging: permute + scale on the BSR
                    # blocks directly (one data gather; the CSR route
                    # paid bsr_tocsr + csr-permute + csr_tobsr per level)
                    from ..sparse.host import bsr_permute

                    Pb_blk = lev.P
                    if perms[i] is not None or perms[i + 1] is not None:
                        nfb = Pb_blk.shape[0] // lev.row_bs
                        ncb = Pb_blk.shape[1] // dpv
                        rp = (
                            perms[i]
                            if perms[i] is not None
                            else np.arange(nfb)
                        )
                        cpm = (
                            perms[i + 1]
                            if perms[i + 1] is not None
                            else np.arange(ncb)
                        )
                        Pb_blk = bsr_permute(Pb_blk, rp, col_perm=cpm)
                    if use_scaling:
                        # P' = S_f^-1 P S_c: *= s_c[col] then /= s_f[row],
                        # same operation order as the scalar path
                        sf = svecs[i]
                        sc = svecs[i + 1]
                        R, C = Pb_blk.blocksize
                        dat = Pb_blk.data.copy()
                        if sc is not None:
                            dat *= sc[
                                Pb_blk.indices[:, None] * C + np.arange(C)
                            ][:, None, :]
                        if sf is not None:
                            rows = np.repeat(
                                np.arange(Pb_blk.shape[0] // R),
                                np.diff(Pb_blk.indptr),
                            )
                            dat /= sf[
                                rows[:, None] * R + np.arange(R)
                            ][:, :, None]
                        Pb_blk = sp.bsr_matrix(
                            (dat, Pb_blk.indices, Pb_blk.indptr),
                            shape=Pb_blk.shape,
                        )
                elif lev.P is not None:
                    P = lev.P.tocsr()
                    if (
                        scal_perms[i] is not None
                        or scal_perms[i + 1] is not None
                    ):
                        Pp = _nat_permute(
                            P, scal_perms[i], scal_perms[i + 1]
                        )
                        if Pp is not None:
                            P = Pp
                        else:
                            if scal_perms[i] is not None:
                                P = P[scal_perms[i]]
                            if scal_perms[i + 1] is not None:
                                P = P[:, scal_perms[i + 1]]
                    if use_scaling:
                        # P' = S_f^-1 P S_c (*= s_c[col] / s_f[row])
                        sf = svecs[i]
                        sc = svecs[i + 1]
                        P = P.tocsr()
                        dat = P.data.copy()
                        if sc is not None:
                            dat *= sc[P.indices]
                        if sf is not None:
                            rows = np.repeat(
                                np.arange(P.shape[0]), np.diff(P.indptr)
                            )
                            dat /= sf[rows]
                        P = sp.csr_matrix(
                            (dat, P.indices, P.indptr), shape=P.shape
                        )
                nf_pad = _scalar_pad(A_fmts[i], lev.row_bs)
                nc_pad = _scalar_pad(
                    A_fmts[i + 1], self.setup_levels_[i + 1].row_bs
                )
                if (
                    lev.lattice_transfer is not None
                    and isinstance(
                        A_fmts[i],
                        (formats.DiaMatrix, formats.StencilDia),
                    )
                    and scal_perms[i] is None
                    and scal_perms[i + 1] is None
                ):
                    # implicit gather-free transfer (lattice levels): the
                    # smoothing matrix is the already-resident level A
                    from ..transfer.lattice_transfer import (
                        LatticeProlongation,
                        LatticeRestriction,
                    )

                    meta = lev.lattice_transfer
                    cd = (
                        lev.stencil.constant_diagonal()
                        if lev.stencil is not None
                        else None
                    )
                    if cd is not None and cd > 0:
                        # broadcast scalar: uniform level (pad rows stay
                        # zero because A's matvec zeroes its tail)
                        dinv = np.full(
                            1, 1.0 / cd, dtype=np.dtype(self.dtype)
                        )
                    else:
                        d = (
                            lev.stencil.diagonal()
                            if lev.stencil is not None
                            else lev.A.diagonal()
                        )
                        dinv = np.zeros(nf_pad, dtype=np.dtype(self.dtype))
                        dinv[: len(d)] = np.where(
                            d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0
                        )
                    if isinstance(A_fmts[i], formats.StencilDia):
                        placeholder = A_fmts[i]  # tiny: no re-point needed
                    else:
                        # placeholder A: the real (shared) operator is
                        # re-pointed after the single device_put, avoiding
                        # a 3x transfer
                        placeholder = formats.DiaMatrix(
                            data=np.zeros((0, 0), dtype=np.dtype(self.dtype)),
                            offsets=A_fmts[i].offsets,
                            nrows=A_fmts[i].nrows,
                            nrows_pad=A_fmts[i].nrows_pad,
                        )
                    common = dict(
                        A=placeholder,
                        Dinv=dinv[:, None],
                        dims_f=meta["dims_f"],
                        dims_c=meta["dims_c"],
                        omega=meta["omega"],
                        nf=lev.mesh.nv,
                        nf_pad=nf_pad,
                        nc=self.setup_levels_[i + 1].mesh.nv,
                        nc_pad=nc_pad,
                    )
                    P_fmt = LatticeProlongation(**common)
                    R_fmt = LatticeRestriction(**common)
                elif lev.row_bs == 1 and dpv == 1:
                    # scalar transfers: tile-ELL (one gathered x scalar
                    # per distinct coarse column of an 8-row tile);
                    # supernode fallback without the native packer
                    P_fmt = formats.tile_ell_from_scipy(
                        P, self.dtype, tile_m=8, nr_pad=nf_pad,
                        nc_pad=nc_pad, stage=True,
                    )
                    R_fmt = (
                        formats.tile_ell_from_scipy(
                            P.T.tocsr(), self.dtype, tile_m=8,
                            nr_pad=nc_pad, nc_pad=nf_pad, stage=True,
                        )
                        if P_fmt is not None
                        else None
                    )
                    if P_fmt is None or R_fmt is None:
                        P_fmt = formats.supernode_from_scipy(
                            P, self.dtype, tile=8, nr_pad=nf_pad,
                            nc_pad=nc_pad, stage=True,
                        )
                        R_fmt = formats.supernode_from_scipy(
                            P.T.tocsr(), self.dtype, tile=8,
                            nr_pad=nc_pad, nc_pad=nf_pad, stage=True,
                        )
                else:
                    Pb = (
                        Pb_blk
                        if Pb_blk is not None
                        else P.tobsr(blocksize=(lev.row_bs, dpv))
                    )
                    P_fmt = bell.from_scipy(
                        Pb, lev.row_bs, dpv, dtype=self.dtype,
                        row_align=self._row_align, stage=True,
                    )
                    R_fmt = bell.from_scipy(
                        Pb.T.tobsr(blocksize=(dpv, lev.row_bs)),
                        dpv,
                        lev.row_bs,
                        dtype=self.dtype,
                        row_align=self._row_align,
                        stage=True,
                    )
            dev_levels.append(
                DeviceLevel(
                    A=A_fmts[i], smoother=sms[i], P=P_fmt, R=R_fmt
                )
            )
            _mark("pack_PR")
        self._coarsest_perm = scal_perms[-1]
        if use_scaling and svecs[0] is not None:
            # solve-boundary scale in UNPERMUTED internal order:
            # x = S_0 y and r' = S_0 r both multiply by S_0
            self._scale0 = (
                svecs[0] if self._iperm0 is None else svecs[0][self._iperm0]
            )
        coarse_inv = None
        if opts.coarse_solve == CoarseSolveType.INV:
            # invert the PERMUTED coarsest matrix: the device format and the
            # restriction into the coarsest level are built in A_perm order
            coarse_inv = self._build_coarse_inv(
                dev_levels[-1], A_perm[-1], keep_f64=use_scaling
            )
        self._x64_cycle = bool(use_scaling and coarse_inv is not None)
        _mark("coarse_inv")
        # local cluster correction (smoothers/cluster_corr.py): batched
        # exact solves on near-singular sliver clusters of the finest
        # level, in the PERMUTED row order the device operator uses.
        # Skipped on stencil levels (translation-invariant couplings
        # cannot be locally defective) and non-scalar problems (for now).
        cluster_corr = None
        lev0 = self.setup_levels_[0]
        if (
            opts.cluster_corr.enabled
            and lev0.stencil is None
            and lev0.row_bs == 1
            and A_perm[0] is not None
        ):
            from ..smoothers.cluster_corr import detect_clusters

            cluster_corr = detect_clusters(
                A_perm[0],
                beta=opts.cluster_corr.beta,
                eig_ratio=opts.cluster_corr.eig_ratio,
                max_size=opts.cluster_corr.max_size,
                dtype=self.dtype,
            )
        _mark("cluster_corr")
        # single batched transfer of the whole hierarchy
        op_host = AMGOperator(
            levels=tuple(dev_levels),
            coarse_inv=coarse_inv,
            cluster_corr=cluster_corr,
            cycle=opts.cycle.value,
        )
        if self._x64_cycle:
            # keep the f64 coarse-inverse leaf f64 through the put (x64-off
            # device_put canonicalizes f64 -> f32); explicit-dtype f32
            # leaves are unaffected by the scope
            with jax.enable_x64(True):
                op = jax.device_put(op_host)
        else:
            op = jax.device_put(op_host)
        jax.block_until_ready(jax.tree_util.tree_leaves(op)[:1])
        _mark("device_put")
        # re-point implicit lattice transfers at the level's device A
        import dataclasses as _dc

        from ..transfer.lattice_transfer import (
            LatticeProlongation,
            LatticeRestriction,
        )

        new_levels = []
        for lev in op.levels:
            if isinstance(lev.P, LatticeProlongation):
                lev = _dc.replace(
                    lev,
                    P=_dc.replace(lev.P, A=lev.A),
                    R=_dc.replace(lev.R, A=lev.A),
                )
            new_levels.append(lev)
        self.op = _dc.replace(op, levels=tuple(new_levels))
        self.A_dev = self.op.levels[0].A
        # exact f64 finest operator for DEVICE-RESIDENT defect correction:
        # uniform stencils carry their (tiny, exact) f64 values on the
        # device, so the f64 residual never leaves it (no per-outer-step
        # vector transfer or host matvec)
        self._A64_dev = None
        # f64 device twin of the finest operator for the DEVICE-RESIDENT
        # mixed-precision outer PCG (built lazily on first mixed solve);
        # _A0_perm keeps the permuted+scaled f64 host matrix it packs from
        self._A64_mixed = None
        self._A0_perm = A_perm[0]
        if (
            isinstance(self.A_dev, formats.StencilDia)
            and self._perm0 is None
        ):
            st0 = self.setup_levels_[0].stencil
            from ..transfer.stencil import ClampedOp, detect_uniform

            vals64 = (
                detect_uniform(st0.patch)
                if isinstance(st0, ClampedOp)
                else None
            )
            if vals64 is not None:
                # scoped x64: enabling it globally would change the
                # dtype of every jnp default in the caller's program
                with jax.enable_x64(True):
                    self._A64_dev = formats.StencilDia(
                        vals=jnp.asarray(vals64, jnp.float64),
                        offs=self.A_dev.offs,
                        dims=self.A_dev.dims,
                        nrows=self.A_dev.nrows,
                        nrows_pad=self.A_dev.nrows_pad,
                    )

    def _build_coarse_inv(
        self, dev_coarsest: DeviceLevel, A_coarsest=None, keep_f64=False
    ):
        """Dense pseudo-inverse of the coarsest matrix (CoarseLevelInv).

        Computed in f64 on host, shipped padded; applied as one matmul.
        Pseudo-inverse covers the reference's regularized singular coarse
        matrices (`RegularizeMatrix`, elasticity_pc_impl.hpp:139).
        ``A_coarsest`` must be the matrix in the device (permuted) row order.
        ``keep_f64`` ships the inverse in f64 so the coarse solve runs in
        f64 inside an f32 cycle (see solve/cycle.py coarse_solve) — needed
        for ill-conditioned block energies where eps32 * ||A_c^-1|| noise
        makes the f32-applied pinv indefinite.
        """
        lev = self.setup_levels_[-1]
        Ad = (lev.A if A_coarsest is None else A_coarsest).toarray()
        inv = _spd_inverse(Ad)
        npad = _scalar_pad(dev_coarsest.A, lev.row_bs)
        out_dtype = np.float64 if keep_f64 else np.dtype(self.dtype)
        out = np.zeros((npad, npad), dtype=out_dtype)
        out[: inv.shape[0], : inv.shape[1]] = inv
        return out

    # ------------------------------------------------------------------
    # apply / solve
    # ------------------------------------------------------------------
    @property
    def operator_complexity(self) -> float:
        return self.log_.operator_complexity

    @property
    def num_levels(self) -> int:
        return len(self.setup_levels_)

    def _to_dev(self, v: np.ndarray) -> jax.Array:
        bs = self.setup_levels_[0].row_bs
        v = np.asarray(v)
        if self._scale0 is not None:
            v = v * self._scale0  # r' = S_0 r (scaled hierarchy boundary)
        if self._perm0 is not None:
            v = v[self._perm0]
        return bell.block_vec(v, bs, self.A_dev.nrows_pad, self.dtype)

    def _from_dev(self, v: jax.Array) -> np.ndarray:
        out = jax.device_get(bell.flat_vec(v, self.A_dev.nrows)).astype(
            np.float64
        )
        if self._iperm0 is not None:
            out = out[self._iperm0]
        if self._scale0 is not None:
            out = out * self._scale0  # x = S_0 y
        return out

    # partial-Dirichlet (scalFreeRows) external<->internal vector views
    def _expand_ext(self, b: np.ndarray) -> np.ndarray:
        if self._ext_free is None:
            return b
        out = np.zeros(self.n, dtype=np.float64)
        out[self._ext_free] = b
        return out

    def _contract_ext(self, x: np.ndarray) -> np.ndarray:
        return x if self._ext_free is None else x[self._ext_free]

    def matvec_free(self, p: np.ndarray) -> np.ndarray:
        """A @ p in the external (free-dof) space."""
        return self._contract_ext(self.A_host @ self._expand_ext(p))

    def _cycle_scope(self):
        """Trace scope of eager device work outside the solve kernels:
        f32 products at full f32 (``utils.jaxcfg.full_f32``), plus x64
        for cycles carrying an f64 coarse solve."""
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(jax.default_matmul_precision("highest"))
        if self._x64_cycle:
            stack.enter_context(jax.enable_x64(True))
        return stack

    def apply(self, r: np.ndarray) -> np.ndarray:
        """x = M^-1 r — one AMG cycle (the reference `Mult`)."""
        self._require_setup()
        r = self._expand_ext(np.asarray(r, dtype=np.float64))
        with self._cycle_scope():
            out = self._from_dev(amg_apply(self.op, self._to_dev(r)))
        return self._contract_ext(out)

    def solve(
        self,
        b: np.ndarray,
        *,
        tol: float = 1e-8,
        maxiter: int = 300,
        use_refinement: bool | None = None,
        return_device: bool = False,
        mixed: bool | None = None,
    ) -> tuple[np.ndarray, SolveInfo]:
        """AMG-PCG solve to relative residual ``tol``.

        With an f32 device dtype and a tight tolerance, runs float64 defect
        correction around the device PCG (inner tol bounded by f32 accuracy).

        ``mixed=True`` goes straight to the mixed-precision outer PCG (f64
        host Krylov + the f32 device cycle as M) instead of defect
        correction — iteration counts then track the f64-quality cycle
        (measured 1.5x fewer on ill-conditioned block energies, where each
        f32 inner pass stalls at its accuracy floor). ``None`` keeps the
        automatic behavior (defect correction with mixed as the stagnation
        fallback).

        ``return_device=True`` returns the solution as a DEVICE array (f64,
        length n) instead of copying it to the host — the production-serving
        mode; the reported relres is the device-computed TRUE residual.
        Only supported on the device-refined path (plain external dof
        layout); otherwise a host array is returned as usual.
        """
        self._require_setup()
        b = self._expand_ext(np.asarray(b, dtype=np.float64))
        bnorm = np.linalg.norm(b)
        if bnorm == 0:
            return self._contract_ext(np.zeros_like(b)), SolveInfo(0, 0.0)
        # inner accuracy floor of the device dtype (defect correction
        # bridges the gap to the requested tolerance)
        floors = {jnp.float64: 0.0, jnp.float32: 2e-6, jnp.bfloat16: 3e-2}
        floor = floors.get(jnp.dtype(self.dtype).type, 2e-6)
        if use_refinement is None:
            # always verify against the TRUE residual: PCG's recursive
            # residual drifts on ill-conditioned problems even in f64
            # (measured: claimed 1e-8, true 1.4e-7 at kappa ~ 1e9)
            use_refinement = True
        inner_tol = max(tol, floor)
        max_outer = (
            (30 if floor > 1e-3 else (8 if floor > 0 else 4))
            if use_refinement
            else 1
        )

        if mixed and jnp.dtype(self.dtype) != jnp.float64:
            A64 = self._ensure_A64_mixed()
            if A64 is not None:
                x, info = self._solve_mixed_device(
                    b, bnorm, tol=tol, maxiter=maxiter, A64=A64
                )
            else:
                x, info = self._solve_mixed_outer(
                    b, bnorm, tol=tol, maxiter=maxiter
                )
            return self._contract_ext(x), info
        if self._A64_dev is not None and use_refinement:
            x, info = self._solve_device_refined(
                b, bnorm, tol, inner_tol, max_outer, maxiter,
                return_device=return_device and self._ext_free is None,
            )
            if return_device and self._ext_free is None:
                return x, info
            return self._contract_ext(x), info
        x = np.zeros(self.n)
        total_it = 0
        history = []
        relres = 1.0
        stagnated = False
        for outer in range(max_outer):
            r = b - self.A_host @ x
            relres = np.linalg.norm(r) / bnorm
            history.append(relres)
            if relres <= tol:
                break
            if len(history) >= 2 and relres > 0.5 * history[-2]:
                stagnated = True
                break  # refinement stagnated (f32 accuracy floor)
            with self._cycle_scope():
                res: SolveResult = pcg(
                    self.op,
                    self.A_dev,
                    self._to_dev(r),
                    tol=float(max(inner_tol, 0.5 * tol / relres)),
                    # ask only for the reachable reduction: the f32 floor
                    # caps what one inner pass delivers (asking below it
                    # wastes tail iterations on drifted bookkeeping), and
                    # near convergence only tol/relres is needed (the old
                    # min() overshot 1e-8 targets to 1e-11)
                    maxiter=maxiter,
                )
            x = x + self._from_dev(res.x)
            total_it += int(res.iterations)
        r = b - self.A_host @ x
        relres = float(np.linalg.norm(r) / bnorm)
        history.append(relres)
        if stagnated and relres > tol and use_refinement:
            # Defect correction is structurally dead when the f32 finest
            # matvec cannot resolve the residual (ill-scaled problems:
            # eps32 * ||A|| ||x|| >> ||b||, e.g. slender-beam elasticity
            # where the inner f32 PCG's recursive residual collapses to
            # noise while the true residual grows). Mixed-precision
            # outer PCG — f64 Krylov vectors and finest matvec with the
            # f32 cycle as preconditioner — is immune: f32 error enters
            # only through M (measured: beam diverges at relres 1.77
            # under defect correction, converges to 5e-9 in 21 mixed
            # iterations with eig bounds [0.31, 1.0]).
            A64 = self._ensure_A64_mixed()
            if A64 is not None:
                x, mixed_info = self._solve_mixed_device(
                    b, bnorm, tol=tol, maxiter=maxiter, A64=A64
                )
            else:
                x, mixed_info = self._solve_mixed_outer(
                    b, bnorm, tol=tol, maxiter=maxiter
                )
            info = SolveInfo(
                iterations=total_it + mixed_info.iterations,
                relres=mixed_info.relres,
                outer_iterations=outer + 1 + mixed_info.outer_iterations,
                converged=mixed_info.converged,
                history=history + mixed_info.history,
            )
            return self._contract_ext(x), info
        info = SolveInfo(
            iterations=total_it,
            relres=relres,
            outer_iterations=outer + 1,
            converged=relres <= tol,
            history=history,
        )
        return self._contract_ext(x), info

    def _ensure_A64_mixed(self):
        """f64 DEVICE twin of the finest operator (lazy, cached).

        Packs the permuted+scaled f64 host matrix into the same format
        (and padding) as the f32 device operator, so mixed-precision
        Krylov state shares the hierarchy's vector layout. Index arrays
        are shared with the f32 twin where the formats allow it.
        """
        if self._A64_mixed is not None:
            return self._A64_mixed
        if self._A64_dev is not None:  # exact f64 stencil already there
            self._A64_mixed = self._A64_dev
            return self._A64_mixed
        A0 = self._A0_perm
        Af = self.A_dev
        if A0 is None or Af is None:
            return None
        bs = self.setup_levels_[0].row_bs
        fmt = None
        with jax.enable_x64(True):
            if isinstance(Af, formats.TileELLStack):
                fmt = formats.tile_ell_stack_from_scipy(
                    A0, np.float64, tile_m=Af.tile_m,
                    chunk=Af.blocks[0].chunk_c,
                    nr_pad=Af.nrows_pad, nc_pad=Af.ncols_pad,
                )
            elif isinstance(Af, formats.TileELL):
                fmt = formats.tile_ell_from_scipy(
                    A0, np.float64, tile_m=Af.tile_m,
                    nr_pad=Af.nrows_pad, nc_pad=Af.ncols_pad,
                )
            elif isinstance(Af, formats.DiaMatrix):
                fmt = formats.dia_from_scipy(
                    A0, np.float64, row_align=Af.nrows_pad,
                )
            elif isinstance(Af, formats.SupernodeELL):
                fmt = formats.supernode_from_scipy(
                    A0, np.float64, tile=Af.tile_r, tile_c=Af.tile_c,
                    nr_pad=Af.nrows_pad, nc_pad=Af.nrows_pad,
                )
            elif isinstance(Af, formats.DenseMatrix):
                fmt = formats.dense_from_scipy(
                    A0, bs, np.float64, row_align=Af.nrows_pad,
                )
            elif isinstance(Af, bell.BlockELL):
                fmt = bell.from_scipy(
                    sp.bsr_matrix(A0, blocksize=(bs, bs))
                    if not (sp.issparse(A0) and A0.format == "bsr")
                    else A0,
                    bs, bs, dtype=np.float64,
                    row_align=self._row_align,
                )
            if fmt is not None and _scalar_pad(fmt, bs) == _scalar_pad(
                Af, bs
            ):
                fmt = jax.device_put(fmt)
                self._A64_mixed = fmt
        return self._A64_mixed

    def _solve_mixed_device(
        self, b: np.ndarray, bnorm: float, *, tol: float, maxiter: int,
        A64,
    ) -> tuple[np.ndarray, SolveInfo]:
        """Device-resident mixed-precision PCG (see solve/pcg.pcg_mixed).

        f64 Krylov vectors and finest matvec live on device; the f32
        hierarchy is applied as M inside the same jitted chunk — zero
        per-iteration host<->device traffic (the host mixed outer pays a
        cycle readback per iteration).
        """
        bs = self.setup_levels_[0].row_bs
        with jax.enable_x64(True), self._cycle_scope():
            v = np.asarray(b, dtype=np.float64)
            if self._scale0 is not None:
                v = v * self._scale0
            if self._perm0 is not None:
                v = v[self._perm0]
            b64 = bell.block_vec(
                v, bs, self.A_dev.nrows_pad, np.float64
            )
            # short chunks on big problems: an iteration past convergence
            # still runs a full masked V-cycle + f64 finest matvec, so read
            # the residual every 2 iterations there
            n_scal = self.A_dev.nrows_pad * bs
            chunk = None if n_scal < 2_000_000 else 2
            # stopping criterion in the UNSCALED space: the hierarchy
            # solves A-hat = SAS whose residual norm can sit an order of
            # magnitude off the honest ||r||/||b|| (measured 4.2e-10 vs
            # 7.3e-9); weight = S^-1 makes the recurrence track the
            # unscaled norm, so the solve stops at the right iteration
            sinv_dev = None
            if self._scale0 is not None:
                s_perm = (
                    self._scale0[self._perm0]
                    if self._perm0 is not None
                    else self._scale0
                )
                sinv = np.zeros(
                    self.A_dev.nrows_pad * bs, dtype=np.float64
                )
                sinv[: len(s_perm)] = 1.0 / s_perm
                sinv_dev = jnp.asarray(sinv.reshape(-1, bs))
            res = pcg_mixed(
                self.op, A64, b64, tol=tol, maxiter=maxiter,
                chunk=chunk,
                cycle_dt=str(jnp.dtype(self.dtype)),
                weight=sinv_dev,
            )
            # true-residual verification on device (recursive residuals
            # drift; one extra f64 matvec, slabbed like the in-loop one),
            # with DEFECT-CORRECTION RESTARTS when the drift leaves the
            # true residual marginally above tol (the recurrence estimate
            # runs ~1-2x under the true residual at 1e-8; a restart costs
            # 1-2 extra iterations and makes `converged` trustworthy)
            from ..sparse.formats import f64_matvec_slabs, matvec_slabbed

            x64 = res.x
            total_iters = int(res.iterations)
            outer = 1
            relres = np.inf
            history = []
            # verification must happen in the UNSCALED space: the
            # hierarchy solves A-hat = S A S, whose residual r-hat = S r
            # can sit 10-20x LOWER relative than the honest unscaled
            # ||r||/||b|| (measured 4.2e-10 vs 7.3e-9 at 147k
            # elasticity) — checking r-hat lets drift misses through
            for _restart in range(3):
                r_true = b64 - matvec_slabbed(
                    A64, x64, f64_matvec_slabs(A64)
                )
                r_ver = (
                    r_true if sinv_dev is None else r_true * sinv_dev
                )
                relres = float(
                    jnp.sqrt(
                        jnp.vdot(r_ver.reshape(-1), r_ver.reshape(-1))
                    )
                ) / bnorm
                history.append(relres)
                if relres <= tol or total_iters >= maxiter:
                    break
                sub = pcg_mixed(
                    self.op, A64, r_true,
                    tol=min(0.8 * tol / relres, 0.5),
                    maxiter=maxiter - total_iters,
                    chunk=chunk,
                    cycle_dt=str(jnp.dtype(self.dtype)),
                    weight=sinv_dev,
                )
                x64 = x64 + sub.x
                total_iters += int(sub.iterations)
                outer += 1
            x = jax.device_get(
                bell.flat_vec(x64, self.A_dev.nrows)
            ).astype(np.float64)
        if self._iperm0 is not None:
            x = x[self._iperm0]
        if self._scale0 is not None:
            x = x * self._scale0
        return x, SolveInfo(
            iterations=total_iters,
            relres=relres,
            outer_iterations=outer,
            converged=relres <= tol,
            history=history,
        )

    def _solve_mixed_outer(
        self, b: np.ndarray, bnorm: float, *, tol: float, maxiter: int
    ) -> tuple[np.ndarray, SolveInfo]:
        """Mixed-precision PCG: f64 outer Krylov, f32 cycle as M.

        Host-resident vectors and finest matvec (exact f64); the device
        applies only the preconditioner. The robustness fallback for
        problems beyond the f32 matvec's attainable accuracy — cf. the
        mixed-precision iterative-refinement literature and the
        reference's all-f64 solve path (LinearSolver.hpp:10-87).
        """
        A = self.A_host
        x = np.zeros(self.n)
        r = b.copy()
        history = []
        z = self.apply(self._contract_ext(r))
        z = self._expand_ext(z)
        p = z.copy()
        rz = float(r @ z)
        it = 0
        relres = 1.0
        while it < maxiter:
            q = A @ p
            pq = float(p @ q)
            if pq <= 0 or rz == 0:
                break
            alpha = rz / pq
            x += alpha * p
            r -= alpha * q
            it += 1
            relres = float(np.linalg.norm(r) / bnorm)
            history.append(relres)
            if relres <= tol:
                break
            z = self._expand_ext(self.apply(self._contract_ext(r)))
            rz2 = float(r @ z)
            p = z + (rz2 / rz) * p
            rz = rz2
        return x, SolveInfo(
            iterations=it,
            relres=relres,
            outer_iterations=1,
            converged=relres <= tol,
            history=history,
        )

    def _solve_device_refined(
        self, b, bnorm, tol, inner_tol, max_outer, maxiter,
        return_device: bool = False,
    ) -> tuple[np.ndarray, SolveInfo]:
        """f64 defect correction with the residual computed ON DEVICE.

        One f64 finest-level matvec per outer iteration on the device
        replaces a host matvec plus two vector transfers. Only scalars
        leave the device until the final solution readback.
        """
        A64 = self._A64_dev
        n, n_pad = A64.nrows, A64.nrows_pad
        dt = str(jnp.dtype(self.dtype))
        # Past ~32M rows, slab the f64 residual so the f64 stencil
        # matvec's vector-sized temporaries shrink to O(n/nslabs).
        nslabs = 1
        if isinstance(A64, formats.StencilDia) and n > 32 * 1024 * 1024:
            nslabs = -(-n // (16 * 1024 * 1024))

        def _resid(b64, x64):
            if nslabs > 1:
                return _refine_residual_slabbed(
                    A64.vals, b64, x64, offs=A64.offs, dims=A64.dims,
                    nslabs=nslabs, nrows=n, nrows_pad=n_pad,
                )
            return _refine_residual(A64, b64, x64)

        with jax.enable_x64(True):
            b64 = jnp.pad(
                jnp.asarray(b, jnp.float64), (0, n_pad - n)
            )[:, None]
            x64 = jnp.zeros_like(b64)
        total_it = 0
        history = []
        relres = 1.0
        for outer in range(max_outer):
            with jax.enable_x64(True):
                r64, rn2 = _resid(b64, x64)
                rn = float(jnp.sqrt(rn2))
            relres = rn / bnorm
            history.append(relres)
            if relres <= tol or not np.isfinite(relres):
                break
            if len(history) >= 2 and relres > 0.5 * history[-2]:
                break  # stagnated at the f32 accuracy floor
            with jax.enable_x64(True):
                # scalars as arrays: python floats would retrace the jits
                r32 = _refine_scale(
                    r64, jnp.asarray(1.0 / rn, jnp.float64), dt
                )
            res: SolveResult = pcg(
                self.op,
                self.A_dev,
                r32,
                tol=float(max(inner_tol, 0.5 * tol / relres)),
                # ask only for the reachable reduction: the f32 floor
                # caps what one inner pass delivers (asking below it
                # wastes tail iterations on drifted bookkeeping), and
                # near convergence only tol/relres is needed (the old
                # min() overshot 1e-8 targets to 1e-11)
                maxiter=maxiter,
            )
            with jax.enable_x64(True):
                x64 = _refine_accumulate(
                    x64, res.x, jnp.asarray(rn, jnp.float64)
                )
            total_it += int(res.iterations)
        with jax.enable_x64(True):
            _r64, rn2 = _resid(b64, x64)
            relres = float(jnp.sqrt(rn2)) / bnorm
        history.append(relres)
        if return_device:
            x = x64[:n, 0]  # device f64 (the final readback is the
            # caller's choice — serving keeps solutions on device)
        else:
            x = jax.device_get(x64[:n, 0])
        info = SolveInfo(
            iterations=total_it,
            relres=relres,
            outer_iterations=outer + 1,
            converged=relres <= tol,
            history=history,
        )
        return x, info

    # ------------------------------------------------------------------
    # self-tests (reference `Preconditioner::Test`, ngs_amg_do_test)
    # ------------------------------------------------------------------
    def test(self, iters: int = 60) -> tuple[float, float]:
        """Eigenvalue bounds of M^-1 A via generalized Lanczos (host loop).

        Mirrors the reference self-test (amg_pc.cpp:720-724): runs a
        preconditioned Lanczos recurrence and returns (min, max) Ritz values
        — the spectral bounds of the preconditioned operator.
        """
        self._require_setup()
        rng = np.random.default_rng(0)
        n_ext = self.n if self._ext_free is None else len(self._ext_free)
        r = rng.standard_normal(n_ext)
        alphas, betas = [], []
        z = self.apply(r)
        rz = r @ z
        p = z.copy()
        beta_prev = 0.0
        for _ in range(min(iters, self.n)):
            q = self.matvec_free(p)
            pq = p @ q
            if pq <= 0 or rz == 0:
                break
            alpha = rz / pq
            r = r - alpha * q
            z = self.apply(r)
            rz_new = r @ z
            beta = rz_new / rz
            alphas.append(alpha)
            betas.append(beta)
            if np.sqrt(abs(rz_new)) < 1e-14:
                break
            p = z + beta * p
            rz = rz_new
        # CG -> Lanczos tridiagonal (standard relations)
        k = len(alphas)
        if k == 0:
            return 1.0, 1.0
        diag = np.zeros(k)
        off = np.zeros(max(k - 1, 0))
        for i in range(k):
            diag[i] = 1.0 / alphas[i]
            if i > 0:
                diag[i] += betas[i - 1] / alphas[i - 1]
            if i < k - 1:
                off[i] = np.sqrt(max(betas[i], 0.0)) / alphas[i]
        T = np.diag(diag)
        if k > 1:
            T += np.diag(off, 1) + np.diag(off, -1)
        ev = np.linalg.eigvalsh(T)
        return float(ev[0]), float(ev[-1])

    def test_levels(self, iters: int = 30) -> list[tuple[float, float]]:
        """Per-level hierarchy self-test (`test_levels` / `test_2level`,
        amg_pc.hpp:250-253, amg_pc.cpp:644-718): eigenvalue bounds of the
        preconditioned operator of every TAIL hierarchy — level l's
        operator preconditioned by the multigrid cycle rooted at l. A bad
        level pair shows up as a collapsed lambda_min at its index, which
        the single global bound cannot localize. Returns (lo, hi) per
        level (the coarsest level solves exactly — bounds ~(1, 1))."""
        self._require_setup()
        import jax.numpy as jnp

        from ..solve.cycle import _cycle
        from ..sparse.formats import matvec as _mv

        out = []
        for l in range(len(self.op.levels)):
            lev = self.op.levels[l]
            bs = self.setup_levels_[l].row_bs
            nb = _block_pad(lev.A, bs)
            bsv = _scalar_pad(lev.A, bs) // nb
            nreal = lev.A.nrows * (bsv if bs == 1 else 1)

            def apply_l(r, l=l):
                with self._cycle_scope():
                    return np.asarray(
                        _cycle(self.op, jnp.asarray(r, self.dtype), l),
                        dtype=np.float64,
                    )

            def matvec_l(p, lev=lev):
                with self._cycle_scope():
                    return np.asarray(
                        _mv(lev.A, jnp.asarray(p, self.dtype)),
                        dtype=np.float64,
                    )

            rng = np.random.default_rng(l)
            r = np.zeros((nb, bsv))
            r[: lev.A.nrows] = rng.standard_normal((lev.A.nrows, bsv))
            alphas, betas = [], []
            z = apply_l(r)
            rz = float((r * z).sum())
            p = z.copy()
            for _ in range(min(iters, max(nreal, 1))):
                q = matvec_l(p)
                pq = float((p * q).sum())
                if pq <= 0 or rz == 0:
                    break
                alpha = rz / pq
                r = r - alpha * q
                z = apply_l(r)
                rz_new = float((r * z).sum())
                alphas.append(alpha)
                betas.append(rz_new / rz)
                if np.sqrt(abs(rz_new)) < 1e-14:
                    break
                p = z + (rz_new / rz) * p
                rz = rz_new
            k = len(alphas)
            if k == 0:
                out.append((1.0, 1.0))
                continue
            diag = np.zeros(k)
            off = np.zeros(max(k - 1, 0))
            for i in range(k):
                diag[i] = 1.0 / alphas[i]
                if i > 0:
                    diag[i] += betas[i - 1] / alphas[i - 1]
                if i < k - 1:
                    off[i] = np.sqrt(max(betas[i], 0.0)) / alphas[i]
            T = np.diag(diag)
            if k > 1:
                T += np.diag(off, 1) + np.diag(off, -1)
            ev = np.linalg.eigvalsh(T)
            out.append((float(ev[0]), float(ev[-1])))
        return out

    def test_smoothers(self, sweeps: int = 4) -> list[float]:
        """Per-level smoother check (the reference's `test_smoothers` flag,
        amg_pc.hpp:250-253 / TestSmoother): symmetric sweeps must reduce the
        energy error on every smoothed level. Returns per-level reduction
        factors."""
        self._require_setup()
        from ..smoothers.core import smooth, smooth_back
        from ..sparse.formats import matvec

        import jax.numpy as jnp

        rates = []
        for i, lev in enumerate(self.op.levels):
            if lev.smoother is None:
                continue
            A = lev.A
            bs = self.setup_levels_[i].row_bs
            nb = _block_pad(A, bs)
            bsv = _scalar_pad(A, bs) // nb
            rng = np.random.default_rng(i)
            x = jnp.asarray(
                rng.standard_normal((nb, bsv)), dtype=self.dtype
            )
            # smoothing the homogeneous system from x: energy must drop
            with self._cycle_scope():
                e0 = float(jnp.vdot(x.reshape(-1), matvec(A, x).reshape(-1)))
                b0 = jnp.zeros_like(x)
                for _ in range(sweeps):
                    x = smooth(lev.smoother, A, x, b0)
                    x = smooth_back(lev.smoother, A, x, b0)
                e1 = float(jnp.vdot(x.reshape(-1), matvec(A, x).reshape(-1)))
            rates.append(e1 / max(e0, 1e-300))
        return rates

    def _require_setup(self):
        if not self._is_setup:
            raise RuntimeError("call .setup() first")


def amg_preconditioner(A, **kw) -> AMGPreconditioner:
    """Convenience: construct + setup in one call."""
    return AMGPreconditioner(A, **kw).setup()
