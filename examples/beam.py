"""Elasticity beam demo + parameter study.

Mirrors the reference's examples/elasticity/beam.py: a cantilever beam,
comparing coarsening algorithms, prolongation types, and per-level smoother
overrides (the `_spec` idiom).

Run:  python examples/beam.py [dim] [n]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngsamg import AMGOptions, AMGPreconditioner, SpecOpt
from ngsamg.config import CoarsenType, ProlType, SmootherType
from ngsamg.utils import fem
from ngsamg.utils.jaxcfg import enable_persistent_cache

enable_persistent_cache()

dim = int(sys.argv[1]) if len(sys.argv) > 1 else 3
n = int(sys.argv[2]) if len(sys.argv) > 2 else 5

prob = fem.elasticity_3d(n, length=10) if dim == 3 else fem.elasticity_2d(
    2 * n, length=10
)
print(f"{dim}D beam, {prob.n} DOFs")

configs = {
    "spw + smoothed": {},
    "mis + smoothed": {"crs": CoarsenType.MIS},
    "spw + piecewise": {"prol": ProlType.PIECEWISE},
    "robust SOC": {"robust": True},
    "per-level smoother (jacobi on 0, gs above)": {"spec": True},
}

for name, cfg in configs.items():
    opts = AMGOptions(dtype="float64")
    opts.levels.max_coarse_size = 60
    if "crs" in cfg:
        opts.coarsen.algo = SpecOpt(cfg["crs"])
    if "prol" in cfg:
        opts.prol.type = SpecOpt(cfg["prol"])
    if cfg.get("robust"):
        opts.coarsen.robust = SpecOpt(True)
    if cfg.get("spec"):
        opts.smoother.type = SpecOpt(
            SmootherType.GS, (SmootherType.L1_JACOBI,)
        )
    t0 = time.perf_counter()
    pc = AMGPreconditioner(
        prob.A,
        energy="elasticity",
        block_size=prob.block_size,
        coords=prob.coords,
        options=opts,
    ).setup()
    x, info = pc.solve(prob.b, tol=1e-8, maxiter=150)
    r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
    print(
        f"  {name:45s} levels={pc.num_levels} OC={pc.operator_complexity:.2f}"
        f" iters={info.iterations:3d} relres={r:.1e}"
        f" t={time.perf_counter()-t0:.2f}s"
    )

