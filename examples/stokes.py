"""Stokes facet-AMG demo across the discretization families.

Runs the divergence-preserving facet AMG on each self-hosted Stokes
velocity system (cf. the reference's examples/: MAC lattice, simplicial
facet flux, Crouzeix-Raviart NC P1 vector dofs, statically-condensed
P1-HDG through the aux embedding) and prints iteration counts across the
grad-div penalty sweep.

Run:  python examples/stokes.py [n]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngsamg import AMGOptions
from ngsamg.precond.stokes import StokesAMG, StokesHDGEmbeddedAMG
from ngsamg.utils import stokes_fem
from ngsamg.utils.jaxcfg import enable_persistent_cache

enable_persistent_cache()

n = int(sys.argv[1]) if len(sys.argv) > 1 else 16


def run(label, prob, extra=None):
    o = AMGOptions()
    o.levels.max_coarse_size = 150
    t0 = time.perf_counter()
    if extra is None:
        pc = StokesAMG(
            prob.A,
            cell_pos=prob.cell_pos,
            cell_vol=prob.cell_vol,
            facet_cells=prob.facet_cells,
            facet_flow=prob.facet_flow,
            options=o,
        ).setup()
        A, b = prob.A, prob.b
    else:  # condensed HDG system + embedding
        S, b, E, geo = extra
        pc = StokesHDGEmbeddedAMG(S, E, **geo, options=o).setup()
        A = S
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = pc.solve(b, tol=1e-8, maxiter=300)
    t_solve = time.perf_counter() - t0
    r = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    print(
        f"{label:28s} ndof={A.shape[0]:7d} levels={pc.num_levels} "
        f"iters={info.iterations:3d} relres={r:.1e} "
        f"setup={t_setup:.2f}s solve={t_solve:.2f}s"
    )


for alpha in (10.0, 1000.0):
    print(f"--- alpha = {alpha} ---")
    run(f"MAC lattice 2D", stokes_fem.stokes_mac_2d(n, alpha=alpha))
    p, _ = stokes_fem.stokes_tri(n, dim=2, alpha=alpha)
    run("simplicial facet flux 2D", p)
    p, _ = stokes_fem.stokes_cr(n, dim=2, alpha=alpha)
    run("Crouzeix-Raviart NC P1 2D", p)
    hdg = stokes_fem.stokes_hdg_p1(max(n // 2, 6), alpha=alpha)
    run("condensed P1-HDG embedded", None, extra=hdg)
