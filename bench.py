"""Benchmark: 3D Poisson AMG setup + PCG solve on one accelerator.

Mirrors the reference's own throughput metric — "(scal) dofs / (sec * np)"
printed by its test harness (/root/reference/tests/h1/amg_utils.py:350-360)
— on the BASELINE.json north-star configuration (3D Poisson, AMG-PCG to
1e-8). Prints ONE merged JSON line

  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

RE-PRINTED (flushed) after every completed leg, so a driver timeout can
never erase finished work: whichever line a parser takes (first or last),
it is a complete, parseable snapshot of everything measured so far. Legs
not yet reached carry {"skipped": "pending"}; legs abandoned by the
wall-clock budget carry {"skipped": "budget"}.

The reference publishes no numbers (BASELINE.md): `vs_baseline` is computed
against an assumed NgsAMG CPU figure of 2.0e6 DoF/s per core for the
combined setup+solve pipeline (typical for one modern core running an
MPI-parallel smoothed-aggregation AMG at this scale), i.e.
vs_baseline = (our setup+solve DoF/s) / 2.0e6.

BASELINE.json's original bar is "faster than NgsAMG+MPI on 64 CPU cores"
at 50M DoF on a 16-device pod. Its per-device arithmetic, an assumption
and not a measurement: 64 cores x 2.0e6 DoF/s x ~0.5 MPI efficiency / 16
devices = ~4.0e6 DoF/s per device, reported as
`vs_baseline_64core_per_chip`.

Env knobs: NGSAMG_BENCH_N (grid n, default 216 -> ~9.94M DoF, the
BASELINE.json metric scale), NGSAMG_BENCH_TOL (default 1e-8),
NGSAMG_BENCH_BUDGET_S (global wall-clock budget, default 480 s; a leg is
skipped when less than its estimate remains).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_DOFS_PER_S = 2.0e6  # assumed NgsAMG-on-1-core setup+solve throughput
# per-chip bar implied by BASELINE.json's 64-core-vs-16-chip comparison:
# 64 cores x 2.0e6 x 0.5 MPI efficiency / 16 chips (see module docstring)
BASELINE_64CORE_PER_CHIP = BASELINE_DOFS_PER_S * 64 * 0.5 / 16

_T_START = time.perf_counter()
_BUDGET_S = float(os.environ.get("NGSAMG_BENCH_BUDGET_S", "480"))

# rough cold-compile-inclusive wall-clock per optional leg (not measured
# on the GPU): a leg is only started when this much budget remains
_LEG_EST_S = {
    "unstructured": 300.0,
    "elasticity": 330.0,
    "stokes": 150.0,
    "gs": 400.0,
}


def _remaining_s() -> float:
    return _BUDGET_S - (time.perf_counter() - _T_START)


# Problem-assembly cache: FE assembly (Delaunay + element integration) is
# NOT part of the measured metric (assembly_s is reported separately).
# Problems are deterministic (seeded), so cache the assembled matrices on
# disk.
_CACHE_DIR = os.environ.get(
    "NGSAMG_BENCH_CACHE", os.path.join(os.path.dirname(__file__), ".bench_cache")
)


def _cached_problem(tag: str, builder):
    if os.environ.get("NGSAMG_BENCH_NOCACHE", "0") == "1":
        return builder()
    import pickle

    path = os.path.join(_CACHE_DIR, tag + ".pkl")
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:
            pass  # stale/corrupt cache: rebuild
    prob = builder()
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(prob, f, protocol=4)
        os.replace(tmp, path)
    except Exception:
        pass  # cache is best-effort
    return prob


def _free_device_state(tag: str):
    """Release one bench leg's device memory before the next leg.

    Dropping the Python refs alone is not enough: jitted executables
    cached per shape capture the hierarchy arrays as constants and keep
    them resident (measured: the elasticity leg's device_put still
    RESOURCE_EXHAUSTED after pc=None+gc.collect()).  clear_caches()
    drops those executables; the legs recompile anyway (different
    shapes).
    """
    import gc

    import jax

    gc.collect()
    jax.clear_caches()
    gc.collect()
    try:
        live = sum(int(a.nbytes) for a in jax.live_arrays())
        print(f"[bench] live device bytes after {tag}: {live/1e6:.1f} MB",
              file=sys.stderr)
    except Exception:
        pass


class _Emitter:
    """Holds the merged result dict; re-prints the full JSON line after
    every completed leg (single atomic write + flush) so a timeout at ANY
    point leaves the last complete snapshot on stdout."""

    def __init__(self):
        self.result = None

    def emit(self):
        line = json.dumps(self.result)
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def main():
    from ngsamg.utils.jaxcfg import enable_persistent_cache

    enable_persistent_cache()
    from jax import device_get as jax_device_get  # noqa: E402
    from ngsamg import AMGOptions, AMGPreconditioner
    from ngsamg.utils import fem

    n = int(os.environ.get("NGSAMG_BENCH_N", "216"))
    tol = float(os.environ.get("NGSAMG_BENCH_TOL", "1e-8"))

    t0 = time.perf_counter()
    prob = _cached_problem(f"poisson3d_{n}", lambda: fem.poisson_3d(n))
    t_asm = time.perf_counter() - t0

    from ngsamg.config import SmootherOptions, SmootherType

    opts = AMGOptions()
    # Chebyshev is the performance smoother: pure fused SpMV work, a
    # ~7x smaller per-cycle graph than multicolor GS (which remains the
    # parity default), near-identical iteration counts on Poisson.
    opts.smoother = SmootherOptions(
        type=SmootherType(os.environ.get("NGSAMG_BENCH_SM", "chebyshev"))
    )
    # best-of-N: repeated runs reflect the warm-page steady state of a
    # long-lived serving process (first-touch page faults on the host are
    # much slower than warm writes)
    repeats = int(os.environ.get("NGSAMG_BENCH_REPEATS", "2"))
    t_setup = t_solve = float("inf")
    pc = x_dev = info = None
    for _rep in range(max(repeats, 1)):
        t0 = time.perf_counter()
        pc = AMGPreconditioner(
            prob.A, coords=prob.coords, options=opts
        ).setup()
        t_setup = min(t_setup, time.perf_counter() - t0)
        if _rep == 0:
            # warm-up: trigger all compiles on a throwaway solve along
            # the SAME path as the measurement (same tol => same branch)
            pc.solve(prob.b, tol=tol, maxiter=8)
        # solve delivers the solution ON DEVICE with a device-computed
        # TRUE relative residual (production serving keeps solutions on
        # device); the d2h readback is timed separately. Host-side
        # verification below re-checks the residual on the read-back
        # solution.
        t0 = time.perf_counter()
        x_dev, info = pc.solve(prob.b, tol=tol, return_device=True)
        t_solve = min(t_solve, time.perf_counter() - t0)
    t0 = time.perf_counter()
    x = np.asarray(jax_device_get(x_dev), dtype=np.float64)
    t_readback = time.perf_counter() - t0

    r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
    dofs_per_s = prob.n / (t_setup + t_solve)
    n_levels = pc.num_levels
    op_complexity = pc.operator_complexity

    # free this leg's device-resident hierarchy before the next leg so
    # the legs' hierarchies are never resident together
    pc = x_dev = None
    _free_device_state("headline")

    em = _Emitter()
    em.result = {
        "metric": "h1_3d_poisson_amg_setup_plus_pcg_solve_throughput",
        "value": round(dofs_per_s, 1),
        "unit": "DoF/s/chip",
        "vs_baseline": round(dofs_per_s / BASELINE_DOFS_PER_S, 3),
        "extra": {
            "vs_baseline_64core_per_chip": round(
                dofs_per_s / BASELINE_64CORE_PER_CHIP, 3
            ),
            "n_dof": prob.n,
            "iterations": int(info.iterations),
            "relres": float(r),
            "converged": bool(info.converged and r < tol),
            "levels": n_levels,
            "operator_complexity": round(op_complexity, 3),
            "setup_s": round(t_setup, 3),
            "solve_s": round(t_solve, 3),
            "solve_dofs_per_s": round(prob.n / t_solve, 1),
            "readback_s": round(t_readback, 3),
            "vs_baseline_incl_readback": round(
                prob.n / (t_setup + t_solve + t_readback)
                / BASELINE_DOFS_PER_S,
                3,
            ),
            "assembly_s": round(t_asm, 3),
            "tol": tol,
            "budget_s": _BUDGET_S,
            "unstructured": {"skipped": "pending"},
            "elasticity": {"skipped": "pending"},
            "stokes": {"skipped": "pending"},
            "gs": {"skipped": "pending"},
        },
    }
    # the headline is on stdout from here on — optional legs can only ADD
    em.emit()

    def _leg_gate(name: str, env: str) -> bool:
        """Decide whether to run an optional leg; record skip markers."""
        if os.environ.get(env, "1") == "0":
            em.result["extra"][name] = {"skipped": "disabled"}
            em.emit()
            return False
        rem = _remaining_s()
        if rem < _LEG_EST_S[name]:
            print(
                f"[bench] skipping {name}: {rem:.0f}s budget left < "
                f"{_LEG_EST_S[name]:.0f}s estimate",
                file=sys.stderr,
            )
            em.result["extra"][name] = {
                "skipped": "budget", "remaining_s": round(rem, 1),
            }
            em.emit()
            return False
        # mark the leg as RUNNING in the emitted snapshot: if an external
        # timeout kills the process mid-leg, the last stdout line shows
        # "in_progress" (started but not finished) rather than "pending"
        em.result["extra"][name] = {
            "skipped": "in_progress", "started_at_s": round(
                time.perf_counter() - _T_START, 1
            ),
        }
        em.emit()
        return True

    # elasticity leg (robust EVP matching, rigid transports, BSR
    # formats) — runs FIRST among the optional legs: it is the round-5
    # priority capture (iteration budget at defaults) and must fit the
    # driver window even when later legs do not
    if _leg_gate("elasticity", "NGSAMG_BENCH_ELAST"):
        try:
            # 3D, ~1.25M DoF (3x3 blocks): robust EVP matching,
            # rigid transports, block formats at benchmark scale
            en = int(os.environ.get("NGSAMG_BENCH_ELAST_N", "36"))
            eref = int(os.environ.get("NGSAMG_BENCH_ELAST_REFINE", "1"))
            edim = int(os.environ.get("NGSAMG_BENCH_ELAST_DIM", "3"))
            ep = _cached_problem(
                f"elast{edim}d_{en}_r{eref}",
                lambda: fem.unstructured_elasticity(en, dim=edim, refine=eref),
            )
            # PURE library defaults (round 5): per-energy auto Chebyshev
            # (order 5, window 0.25 on block levels), the energy's own
            # goal aaf 0.08 — measured 38 iterations / true relres
            # 6.6e-9 at this scale, inside the reference's <40 budget
            # (tests/elasticity/mdim/simple/test_3d_lo.py:5-11) with NO
            # bench-side knobs. Solved via the mixed-precision outer
            # (f64 Krylov + f32 cycle as M).
            from ngsamg import SpecOpt

            eopts = AMGOptions()
            # chebyshev like the other perf legs; multicolor GS is also
            # available at this scale via NGSAMG_BENCH_ELAST_SM=gs (the
            # per-color split-ELL storage removed the r3 compile OOM)
            esm = os.environ.get("NGSAMG_BENCH_ELAST_SM", "chebyshev")
            eopts.smoother.type = SpecOpt(SmootherType(esm))
            te_setup = te_solve = float("inf")
            # default ONE rep: this leg's headline value is the
            # iteration count (deterministic); a second ~250 s
            # host-bound setup doubles the leg's wall for timing
            # polish only (override with NGSAMG_BENCH_ELAST_REPEATS)
            ereps = int(
                os.environ.get("NGSAMG_BENCH_ELAST_REPEATS", "1")
            )
            for _rep in range(max(ereps, 1)):
                t0 = time.perf_counter()
                epc = AMGPreconditioner(
                    ep.A, energy="elasticity", block_size=edim,
                    coords=ep.coords, options=eopts,
                ).setup()
                te_setup = min(te_setup, time.perf_counter() - t0)
                if _rep == 0:
                    # warm up the MIXED path (the measured solve below):
                    # warming the plain path would leave the mixed
                    # compile inside the timed region; 2 iterations
                    # trigger every compile (chunked step + twin pack)
                    epc.solve(ep.b, tol=tol, maxiter=2, mixed=True)
                t0 = time.perf_counter()
                # the mixed solver verifies the TRUE residual on device
                # and defect-correction-restarts on a drift miss, so the
                # strict host-verified check below holds at plain tol
                ex, einfo = epc.solve(
                    ep.b, tol=tol, maxiter=120, mixed=True
                )
                te_solve = min(te_solve, time.perf_counter() - t0)
            er = np.linalg.norm(ep.A @ ex - ep.b) / np.linalg.norm(ep.b)
            em.result["extra"]["elasticity"] = {
                "n_dof": ep.n,
                "iterations": int(einfo.iterations),
                "relres": float(er),
                "converged": bool(einfo.converged and er < tol),
                "setup_s": round(te_setup, 3),
                "setup_us_per_dof": round(1e6 * te_setup / ep.n, 2),
                "solve_s": round(te_solve, 3),
                "dofs_per_s": round(ep.n / (te_setup + te_solve), 1),
                "smoother": esm,
            }
            epc = ex = None
            _free_device_state("elasticity")
        except Exception as _e:
            import traceback

            traceback.print_exc()
            em.result["extra"]["elasticity"] = {
                "error": f"{type(_e).__name__}: {_e}",
                "converged": False,
            }
            epc = ex = None  # noqa: F841  drop device refs before freeing
            _free_device_state("elasticity:error")
        em.emit()

    # unstructured leg (perturbed Delaunay; SPW + smoothed prol +
    # supernode formats) — the paths a general mesh exercises
    if _leg_gate("unstructured", "NGSAMG_BENCH_UNSTRUCTURED"):
        # a failure here must not kill the headline metric above
        try:
            # ~1.41M DoF (55^3-lattice perturbed Delaunay + one uniform red
            # refinement): the SPW + smoothed-prol + tile-ELL + cluster-
            # correction path at the scale the reference lives at
            nu = int(os.environ.get("NGSAMG_BENCH_UNSTRUCT_N", "55"))
            uref = int(os.environ.get("NGSAMG_BENCH_UNSTRUCT_REFINE", "1"))
            up = _cached_problem(
                f"unstruct3d_{nu}_r{uref}",
                lambda: fem.unstructured_poisson(nu, dim=3, refine=uref),
            )
            tu_setup = tu_solve = float("inf")
            ustages = None
            for _rep in range(max(repeats, 1)):
                t0 = time.perf_counter()
                upc = AMGPreconditioner(
                    up.A, coords=up.coords, options=opts
                ).setup()
                tu_setup = min(tu_setup, time.perf_counter() - t0)
                ustages = {
                    k: round(v, 3)
                    for k, v in upc._device_stage_times.items()
                }
                ustages["host_factory"] = round(upc.setup_time_host, 3)
                if _rep == 0:
                    upc.solve(up.b, tol=tol, maxiter=8)  # compile warm-up
                t0 = time.perf_counter()
                ux, uinfo = upc.solve(up.b, tol=tol)
                tu_solve = min(tu_solve, time.perf_counter() - t0)
            ur = np.linalg.norm(up.A @ ux - up.b) / np.linalg.norm(up.b)
            em.result["extra"]["unstructured"] = {
                "n_dof": up.n,
                "iterations": int(uinfo.iterations),
                "relres": float(ur),
                "converged": bool(uinfo.converged and ur < tol),
                "setup_s": round(tu_setup, 3),
                "setup_us_per_dof": round(1e6 * tu_setup / up.n, 2),
                "solve_s": round(tu_solve, 3),
                "dofs_per_s": round(up.n / (tu_setup + tu_solve), 1),
                "operator_complexity": round(upc.operator_complexity, 3),
                "setup_stages_s": ustages,
            }
            upc = ux = None
            _free_device_state("unstructured")
        except Exception as _e:
            import traceback

            traceback.print_exc()
            em.result["extra"]["unstructured"] = {
                "error": f"{type(_e).__name__}: {_e}",
                "converged": False,
            }
            upc = ux = None  # noqa: F841  drop device refs before freeing
            _free_device_state("unstructured:error")
        em.emit()

    # Stokes leg (dual-mesh facet AMG, div-preserving prolongation,
    # short geometric loops + Hiptmair smoothing — 3D simplicial mesh at
    # the >=100k-DoF scale the reference's largest subsystem lives at)
    if _leg_gate("stokes", "NGSAMG_BENCH_STOKES"):
        try:
            from ngsamg.precond.stokes import StokesAMG
            from ngsamg.utils.stokes_fem import stokes_tri

            sn = int(os.environ.get("NGSAMG_BENCH_STOKES_N", "20"))
            sdim = int(os.environ.get("NGSAMG_BENCH_STOKES_DIM", "3"))
            sprob, _ = _cached_problem(
                f"stokes_tri{sdim}d_{sn}",
                lambda: stokes_tri(sn, dim=sdim, alpha=10.0),
            )
            sopts = AMGOptions()
            sopts.levels.max_coarse_size = 80
            ts_setup = ts_solve = float("inf")
            for _rep in range(max(repeats, 1)):
                t0 = time.perf_counter()
                spc = StokesAMG(
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
                ts_setup = min(ts_setup, time.perf_counter() - t0)
                if _rep == 0:
                    spc.solve(sprob.b, tol=tol, maxiter=8)  # compile warm-up
                t0 = time.perf_counter()
                sx, sinfo = spc.solve(sprob.b, tol=tol, maxiter=150)
                ts_solve = min(ts_solve, time.perf_counter() - t0)
            sr = np.linalg.norm(sprob.A @ sx - sprob.b) / np.linalg.norm(
                sprob.b
            )
            em.result["extra"]["stokes"] = {
                "n_dof": sprob.A.shape[0],
                "iterations": int(sinfo.iterations),
                "relres": float(sr),
                "converged": bool(sinfo.converged and sr < tol),
                "setup_s": round(ts_setup, 3),
                "solve_s": round(ts_solve, 3),
                "dofs_per_s": round(
                    sprob.A.shape[0] / (ts_setup + ts_solve), 1
                ),
            }
            spc = sx = None
            _free_device_state("stokes")
        except Exception as _e:
            import traceback

            traceback.print_exc()
            em.result["extra"]["stokes"] = {
                "error": f"{type(_e).__name__}: {_e}",
                "converged": False,
            }
            spc = sx = None  # noqa: F841  drop device refs before freeing
            _free_device_state("stokes:error")
        em.emit()

    # GS leg (the parity-default smoother: color-sorted sweeps) at >=1M
    # DoF, with a same-problem Chebyshev run quantifying the GS-vs-
    # Chebyshev gap at the scale where it matters (the per-color static
    # slices multiply op count by ncolors x levels x sweeps)
    if _leg_gate("gs", "NGSAMG_BENCH_GS"):
        try:
            gn = int(os.environ.get("NGSAMG_BENCH_GS_N", "101"))
            gp = _cached_problem(f"poisson3d_{gn}", lambda: fem.poisson_3d(gn))
            gs = {"n_dof": gp.n}
            for sm in ("gs", "chebyshev"):
                gopts = AMGOptions()
                gopts.smoother = SmootherOptions(type=SmootherType(sm))
                tg_setup = tg_solve = float("inf")
                for _rep in range(max(repeats, 1)):
                    t0 = time.perf_counter()
                    gpc = AMGPreconditioner(
                        gp.A, coords=gp.coords, options=gopts
                    ).setup()
                    tg_setup = min(tg_setup, time.perf_counter() - t0)
                    if _rep == 0:
                        gpc.solve(gp.b, tol=tol, maxiter=8)
                    t0 = time.perf_counter()
                    gx, ginfo = gpc.solve(gp.b, tol=tol)
                    tg_solve = min(tg_solve, time.perf_counter() - t0)
                gr = np.linalg.norm(gp.A @ gx - gp.b) / np.linalg.norm(gp.b)
                gs[sm] = {
                    "iterations": int(ginfo.iterations),
                    "relres": float(gr),
                    "converged": bool(ginfo.converged and gr < tol),
                    "setup_s": round(tg_setup, 3),
                    "solve_s": round(tg_solve, 3),
                    "dofs_per_s": round(gp.n / (tg_setup + tg_solve), 1),
                }
                gpc = gx = None
                _free_device_state(f"gs-leg:{sm}")
            gs["converged"] = bool(
                gs["gs"]["converged"] and gs["chebyshev"]["converged"]
            )
            gs["solve_ratio_gs_over_cheb"] = round(
                gs["gs"]["solve_s"] / max(gs["chebyshev"]["solve_s"], 1e-9), 2
            )
            em.result["extra"]["gs"] = gs
        except Exception as _e:
            import traceback

            traceback.print_exc()
            em.result["extra"]["gs"] = {
                "error": f"{type(_e).__name__}: {_e}",
                "converged": False,
            }
            gpc = gx = None  # noqa: F841  drop device refs before freeing
            _free_device_state("gs:error")
        em.emit()

    em.result["extra"]["bench_wall_s"] = round(
        time.perf_counter() - _T_START, 1
    )
    em.emit()
    ok = em.result["extra"]["converged"]
    for name in ("unstructured", "elasticity", "stokes", "gs"):
        leg = em.result["extra"][name]
        ok = ok and leg.get("converged", "skipped" in leg)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
