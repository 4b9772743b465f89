"""Drive the AMG-PCG main path once on the GPU and check every result.

    python chip_smoke.py          one GPU: the `poisson` phase (the
                                  9.94M-DoF 3D Poisson of the bench
                                  headline) and the `formats` phases (one
                                  solve per device format the other bench
                                  legs reach)
    python chip_smoke.py --four   four GPUs: the row-sharded solve against
                                  the single-device solve, nothing else

Every phase goes through the user entry point
``AMGPreconditioner(A, ...).setup().solve(b, tol=1e-8)`` (``StokesAMG``
for Stokes), checks convergence with the host f64 scipy residual
||b - A x|| / ||b|| and an iteration budget, and compares the finest-level
device matvec with scipy in f64 on the same random x. Any failure raises,
so the script exits non-zero and never prints its last line, which is
one JSON object naming the device. Without a GPU it exits non-zero before
any phase.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import subprocess
import sys
import time

import numpy as np

TOL = 1e-8
# finest-level matvec tolerance, relative to max(|A| |x|): A is stored in
# f32 (rel. rounding 6e-8 per entry) and XLA sums up to ~100 terms per row
# in its own order on the GPU, so the error stays below ~100 * eps32
KERNEL_TOL = 1e-5
# the f64 twin of the finest operator: f64 storage, same summation argument
KERNEL_TOL_F64 = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    """Card name and power limit, from a child process that has no JAX."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def _level_formats(op) -> list[str]:
    return [type(lev.A).__name__ for lev in op.levels]


def _host_relres(A, x, b) -> float:
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def kernel_check(A_dev, A_ref, dtype, tol: float, seed: int = 0) -> float:
    """max |A_dev x - A_ref x| / max(|A_ref| |x|) for one random x.

    ``A_dev`` is a device format, ``A_ref`` the scipy matrix it was packed
    from (same row order); x is rounded to ``dtype`` first so the error is
    the device's storage and summation alone. The matvec is traced under
    the solve's precision policy (``full_f32``).
    """
    import jax
    import jax.numpy as jnp

    from ngsamg.sparse import bell, formats
    from ngsamg.utils.jaxcfg import full_f32

    n = A_ref.shape[0]
    bs = n // A_dev.nrows
    x = np.random.default_rng(seed).standard_normal(n)
    x = x.astype(dtype).astype(np.float64)
    with jax.enable_x64(jnp.dtype(dtype) == jnp.float64):
        xd = bell.block_vec(x, bs, A_dev.nrows_pad, dtype)
        y = jax.jit(full_f32(formats.matvec))(A_dev, xd)
        y = np.asarray(bell.flat_vec(y, A_dev.nrows), np.float64)
    ref = A_ref @ x
    scale = float(np.max(abs(A_ref) @ np.abs(x)))
    err = float(np.max(np.abs(y - ref))) / scale
    log(
        f"  kernel {type(A_dev).__name__} ({np.dtype(dtype).name}, "
        f"{n} rows) vs scipy f64: max rel err {err:.3e} (tol {tol:.0e})"
    )
    check(err <= tol, f"{type(A_dev).__name__} matvec off by {err:.3e}")
    return err


def dia_to_scipy(A):
    """Host scipy matrix of a DiaMatrix's storage (f64): A[i, i+o] =
    data[d, i], and for sym-half storage also A[i, i-o] = data[d, i-o]."""
    import scipy.sparse as sp

    data = np.asarray(A.data, np.float64)
    n = A.nrows
    rows, cols, vals = [], [], []
    for d, off in enumerate(A.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(data[d, i])
        if A.sym_half and off > 0:
            rows.append(i + off)
            cols.append(i)
            vals.append(data[d, i])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def _finest_check(pc) -> float:
    """Finest device operator vs the host matrix it was packed from."""
    A_ref = getattr(pc, "_A0_perm", None)
    if A_ref is None:  # stencil levels: natural order, no scaling
        A_ref = pc.A_host
    return kernel_check(pc.A_dev, A_ref.tocsr(), pc.dtype, KERNEL_TOL)


def device_seconds(step, A, x, reps: int = 20, trials: int = 3) -> float:
    """Device seconds of one ``step(A, x) -> x``: the best of ``trials``
    dispatches of ``reps`` dependent calls chained inside one jit, so
    host dispatch overhead is paid once per dispatch, not per call.
    Optimization barriers keep XLA from fusing one call into the next."""
    import jax

    @jax.jit
    def chain(A, x):
        for _ in range(reps):
            x = jax.lax.optimization_barrier(step(A, x))
        return x

    jax.block_until_ready(chain(A, x))  # compile
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(A, x))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def spmv_rates(op, copy_bytes: int = 1 << 30) -> dict:
    """Achieved bytes/s of the structured-level SpMVs against a copy.

    Bytes are what each SpMV must move at least: x read once, y written
    once, plus the stored diagonals of a DiaMatrix. Also reports the
    compiled temporary bytes of the largest symmetric-half DIA matvec
    (a padded copy per diagonal would show as ~ndiag vectors).
    """
    import jax
    import jax.numpy as jnp

    from ngsamg.sparse import formats
    from ngsamg.utils.jaxcfg import full_f32

    matvec = full_f32(formats.matvec)
    mv = jax.jit(matvec)
    out = {}
    a = jnp.ones((copy_bytes // 4,), jnp.float32)
    out["copy"] = 2 * a.nbytes / device_seconds(
        lambda s, v: v * s, jnp.float32(1.0), a
    )
    del a
    log(f"  copy {2 * copy_bytes / 1e6:.0f} MB moved: "
        f"{out['copy'] / 1e9:.1f} GB/s")
    dia = [lev.A for lev in op.levels if isinstance(lev.A, formats.DiaMatrix)]
    cands = [("finest", op.levels[0].A)]
    if dia:
        cands.append(("largest DiaMatrix", max(dia, key=lambda A: A.nrows)))
    for tag, A in cands:
        x = jnp.ones((A.nrows_pad, 1), jnp.float32)
        nbytes = 2 * x.nbytes + getattr(A, "data", x[:0]).nbytes
        if isinstance(A, formats.DiaMatrix):
            kernel_check(A, dia_to_scipy(A), np.float32, KERNEL_TOL)
        out[tag] = nbytes / device_seconds(matvec, A, x)
        sym = getattr(A, "sym_half", False)
        log(
            f"  {tag} {type(A).__name__} matvec ({A.nrows} rows"
            f"{', sym-half' if sym else ''}): {nbytes / 1e6:.1f} MB in "
            f"{nbytes / out[tag] * 1e3:.3f} ms = {out[tag] / 1e9:.1f} GB/s"
            f" ({out[tag] / out['copy']:.2f} of copy)"
        )
        if sym:
            ma = mv.lower(A, x).compile().memory_analysis()
            temp = getattr(ma, "temp_size_in_bytes", None)
            if temp is not None:
                log(
                    f"  sym-half matvec temporaries: {temp} bytes = "
                    f"{temp / x.nbytes:.2f} vectors for "
                    f"{len(A.offsets)} stored diagonals"
                )
    return out


def _solve_phase(name, make_pc, prob, budget, **solve_kw):
    """setup, warm-up solve (compiles), timed solve, host f64 check."""
    t0 = time.perf_counter()
    pc = make_pc().setup()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc.solve(prob.b, tol=TOL, **{**solve_kw, "maxiter": 8})
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = pc.solve(prob.b, tol=TOL, **solve_kw)
    t_solve = time.perf_counter() - t0
    relres = _host_relres(prob.A, x, prob.b)
    fm = _level_formats(pc.op)
    log(
        f"[{name}] {prob.A.shape[0]} DoF: setup {t_setup:.3f} s, "
        f"warm-up solve (compiles) {t_warm:.3f} s, solve {t_solve:.3f} s, "
        f"{info.iterations} iterations (budget {budget}), host f64 "
        f"relres {relres:.3e}"
    )
    log(f"  level formats: {fm}")
    check(info.converged, f"{name}: solve did not converge")
    check(relres <= TOL, f"{name}: host f64 residual {relres:.3e}")
    check(
        info.iterations <= budget,
        f"{name}: {info.iterations} iterations > budget {budget}",
    )
    return pc, info, fm


def poisson(
    n: int = 216, n_ref: int = 48, budget: int = 20,
    copy_bytes: int = 1 << 30,
) -> dict:
    """The main path: structured 3D Poisson with the bench headline
    options (Chebyshev smoother), plus the GPU-vs-CPU iteration parity of
    the same options at ``n_ref``."""
    import jax

    from __graft_entry__ import cheby_options
    from ngsamg import AMGPreconditioner
    from ngsamg.utils import fem

    prob = fem.poisson_3d(n)
    pc, info, fm = _solve_phase(
        "poisson",
        lambda: AMGPreconditioner(
            prob.A, coords=prob.coords, options=cheby_options()
        ),
        prob,
        budget,
    )
    check("StencilDia" in fm and "DiaMatrix" in fm, fm)
    _finest_check(pc)
    # coarse levels: the lattice hierarchy keeps the natural order and no
    # scaling; clamp-compressed levels keep no host matrix (spmv_rates
    # checks the largest DiaMatrix against its own storage instead)
    for lev, host in zip(pc.op.levels[1:], pc.setup_levels_[1:]):
        if host.A is not None:
            kernel_check(lev.A, host.A.tocsr(), pc.dtype, KERNEL_TOL)
    rates = spmv_rates(pc.op, copy_bytes)
    log(f"  peak_bytes_in_use {_peak_bytes()}")
    pc = None
    gc.collect()

    # precision policy check: same options at n_ref on this device and
    # on the host CPU backend must agree within one iteration
    ref = fem.poisson_3d(n_ref)
    its = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            pcr = AMGPreconditioner(
                ref.A, coords=ref.coords, options=cheby_options()
            ).setup()
            xr, inf = pcr.solve(ref.b, tol=TOL)
        check(_host_relres(ref.A, xr, ref.b) <= TOL, dev)
        its[dev.platform] = int(inf.iterations)
    dev_its, cpu_its = its[jax.devices()[0].platform], its["cpu"]
    log(
        f"  iterations: {info.iterations} at {prob.n} DoF; poisson_3d"
        f"({n_ref}) {dev_its} on {jax.devices()[0].platform} vs "
        f"{cpu_its} on cpu"
    )
    check(abs(dev_its - cpu_its) <= 1, its)
    return {"iterations": int(info.iterations), "rates": rates, **its}


def unstructured(n: int = 55, refine: int = 1, budget: int = 30) -> dict:
    """Unstructured 3D Poisson: TileELLStack, DenseMatrix levels and the
    local cluster correction."""
    from __graft_entry__ import cheby_options
    from ngsamg import AMGPreconditioner
    from ngsamg.utils import fem

    prob = fem.unstructured_poisson(n, dim=3, refine=refine)
    pc, info, fm = _solve_phase(
        "unstructured",
        lambda: AMGPreconditioner(
            prob.A, coords=prob.coords, options=cheby_options()
        ),
        prob,
        budget,
    )
    check("TileELLStack" in fm and "DenseMatrix" in fm, fm)
    check(pc.op.cluster_corr is not None, "no cluster correction")
    _finest_check(pc)
    log(f"  peak_bytes_in_use {_peak_bytes()}")
    return {"iterations": int(info.iterations)}


def elasticity(n: int = 36, refine: int = 1, budget: int = 39) -> dict:
    """Unstructured 3D elasticity at the bench leg's size (~1.25M DoF)
    through the mixed-precision device PCG: BlockELL levels and the f64
    twin of the finest operator. Also reports the compiled temporaries of
    the f64 matvec with and without slabs."""
    import jax
    import jax.numpy as jnp

    from ngsamg import AMGOptions, AMGPreconditioner, SpecOpt
    from ngsamg.config import SmootherType
    from ngsamg.sparse import formats
    from ngsamg.utils import fem

    prob = fem.unstructured_elasticity(n, dim=3, refine=refine)
    opts = AMGOptions()
    opts.smoother.type = SpecOpt(SmootherType.CHEBYSHEV)
    pc, info, fm = _solve_phase(
        "elasticity",
        lambda: AMGPreconditioner(
            prob.A, energy="elasticity", block_size=3,
            coords=prob.coords, options=opts,
        ),
        prob,
        budget,
        mixed=True,
        maxiter=120,
    )
    check("BlockELL" in fm, fm)
    A64 = pc._A64_mixed
    check(A64 is not None, "no f64 twin of the finest operator")
    _finest_check(pc)
    kernel_check(A64, pc._A0_perm.tocsr(), np.float64, KERNEL_TOL_F64)
    with jax.enable_x64(True):
        p = jnp.zeros((A64.nrows_pad, prob.A.shape[0] // A64.nrows),
                      jnp.float64)
        data_bytes = A64.data.nbytes
        temps = {}
        for k in sorted({1, 2, formats.f64_matvec_slabs(A64)}):
            fn = jax.jit(lambda A, v, k=k: formats.matvec_slabbed(A, v, k))
            ma = fn.lower(A64, p).compile().memory_analysis()
            temps[k] = getattr(ma, "temp_size_in_bytes", None)
    log(
        f"  f64 twin matvec temporaries by slab count {temps} for "
        f"{data_bytes} data bytes"
    )
    log(f"  peak_bytes_in_use {_peak_bytes()}")
    return {"iterations": int(info.iterations), "f64_temps": temps}


def stokes(n: int = 20, budget: int = 150) -> dict:
    """3D facet Stokes (simplicial mesh): Hiptmair smoothing."""
    from ngsamg import AMGOptions
    from ngsamg.precond.stokes import StokesAMG
    from ngsamg.smoothers.hiptmair import HiptmairSmoother
    from ngsamg.utils.stokes_fem import stokes_tri

    prob, _ = stokes_tri(n, dim=3, alpha=10.0)
    opts = AMGOptions()
    opts.levels.max_coarse_size = 80
    pc, info, fm = _solve_phase(
        "stokes",
        lambda: StokesAMG(
            prob.A,
            cell_pos=prob.cell_pos,
            cell_vol=prob.cell_vol,
            facet_cells=prob.facet_cells,
            facet_flow=prob.facet_flow,
            facet_verts=prob.facet_verts,
            vert_pos=prob.vert_pos,
            bnd_facet_verts=prob.bnd_facet_verts,
            options=opts,
        ),
        prob,
        budget,
        maxiter=budget,
    )
    check(any(
        isinstance(lev.smoother, HiptmairSmoother) for lev in pc.op.levels
    ), "no Hiptmair level")
    _finest_check(pc)
    log(f"  peak_bytes_in_use {_peak_bytes()}")
    return {"iterations": int(info.iterations)}


def gs(n: int = 101, budget: int = 20) -> dict:
    """3D Poisson with the multicolor Gauss-Seidel smoother: per-color
    split matrix slices."""
    from ngsamg import AMGOptions, AMGPreconditioner
    from ngsamg.config import SmootherOptions, SmootherType
    from ngsamg.utils import fem

    prob = fem.poisson_3d(n)
    opts = AMGOptions()
    opts.smoother = SmootherOptions(type=SmootherType.GS)
    pc, info, fm = _solve_phase(
        "gs",
        lambda: AMGPreconditioner(prob.A, coords=prob.coords, options=opts),
        prob,
        budget,
    )
    check(any(
        getattr(lev.smoother, "cdata", ()) for lev in pc.op.levels
    ), "no level with per-color split storage")
    _finest_check(pc)
    log(f"  peak_bytes_in_use {_peak_bytes()}")
    return {"iterations": int(info.iterations)}


def _single_vs_sharded(name, pc, prob, op_s, A_s) -> int:
    """Solve with ``pc`` as built (one device) and with its hierarchy
    placed on the mesh (``op_s``, ``A_s``); both must converge to the
    host f64 tolerance in the same number of iterations."""
    its = {}
    for where in ("single", "sharded"):
        run = pc
        if where == "sharded":
            run = copy.copy(pc)
            run.op, run.A_dev = op_s, A_s
        run.solve(prob.b, tol=TOL, maxiter=8)  # compiles
        t0 = time.perf_counter()
        x, info = run.solve(prob.b, tol=TOL)
        t = time.perf_counter() - t0
        relres = _host_relres(prob.A, x, prob.b)
        log(f"  {name}, {where}: solve {t:.3f} s, {info.iterations} "
            f"iterations, host f64 relres {relres:.3e}")
        check(info.converged and relres <= TOL, (name, where, relres))
        its[where] = int(info.iterations)
    check(its["single"] == its["sharded"], (name, its))
    return its["sharded"]


def sharded(
    n: int = 216,
    n_dist: int = 101,
    n_devices: int = 4,
    halo_sizes: tuple = (40, 140),
) -> dict:
    """Row-sharded solves on an ``n_devices`` mesh against the
    single-device solve of the same hierarchy: the lattice hierarchy of
    ``poisson_3d(n)`` and the distributed-setup leg of the multi-device
    dry run at ``poisson_3d(n_dist)``; plus the dry run's interface-halo
    tile-ELL and block-ELL legs, which must contract the residual."""
    import __graft_entry__ as dry
    from ngsamg import AMGPreconditioner
    from ngsamg.parallel.halo import HaloBlockELL, HaloTileELL
    from ngsamg.parallel.shard import make_mesh, shard_operator
    from ngsamg.utils import fem

    mesh = make_mesh(n_devices)
    results = {}
    prob = fem.poisson_3d(n)
    t0 = time.perf_counter()
    pc = AMGPreconditioner(
        prob.A, coords=prob.coords,
        options=dry.cheby_options(shards=n_devices),
    ).setup()
    log(f"[sharded] {prob.n} DoF: setup {time.perf_counter() - t0:.3f} s, "
        f"formats {_level_formats(pc.op)}")
    results["lattice"] = _single_vs_sharded(
        "lattice setup", pc, prob, *shard_operator(pc.op, pc.A_dev, mesh)
    )
    pc = None
    gc.collect()

    t0 = time.perf_counter()
    pc, prob, op_s, A_s = dry.dist_setup_leg(mesh, n_dist)
    log(f"[sharded] {prob.n} DoF: distributed setup "
        f"{time.perf_counter() - t0:.3f} s, formats {_level_formats(pc.op)}")
    results["distributed"] = _single_vs_sharded(
        "distributed setup", pc, prob, op_s, A_s
    )
    pc = op_s = A_s = None
    gc.collect()

    step = dry.pcg_step()
    for tag, leg, size, fmt in (
        ("HaloTileELL", dry.halo_tile_leg, halo_sizes[0], HaloTileELL),
        ("HaloBlockELL", dry.halo_block_leg, halo_sizes[1], HaloBlockELL),
    ):
        pc_l, prob_l, op_l, A_l = leg(mesh, size)
        check(any(isinstance(lev.A, fmt) for lev in op_l.levels),
              f"no {tag} level")
        r0, r1 = dry.two_step_residuals(step, pc_l, op_l, A_l, prob_l.b)
        log(f"  {tag}: residual^2 {r0:.4e} -> {r1:.4e} over one step")
        check(np.isfinite(r0) and r1 < r0, tag)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU sharded solve and its comparison",
    )
    args = ap.parse_args(argv)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU (JAX platform {devs[0].platform})",
            file=sys.stderr,
        )
        return 2
    n_need = 4 if args.four else 1
    if len(devs) < n_need:
        print(f"chip_smoke: need {n_need} GPUs, have {len(devs)}",
              file=sys.stderr)
        return 2
    import ngsamg.native
    from ngsamg.utils.jaxcfg import enable_persistent_cache

    enable_persistent_cache()
    log(f"card: {card_line()}")
    log(f"jax.devices(): {devs}")
    log(
        "native setup extension: "
        + ("loaded" if ngsamg.native.HAVE_NATIVE
           else "absent, numpy fallbacks (slower host setup)")
    )
    t0 = time.perf_counter()
    phases = (
        (sharded,) if args.four
        else (poisson, unstructured, elasticity, stokes, gs)
    )
    for phase in phases:
        t = time.perf_counter()
        phase()
        gc.collect()
        log(f"phase {phase.__name__}: {time.perf_counter() - t:.1f} s")
    log(f"all phases: {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform,
            "kind": d.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
