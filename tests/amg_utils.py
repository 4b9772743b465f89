"""Shared test harness: solve + convergence assertions.

Mirrors the reference's acceptance criterion
(/root/reference/tests/h1/amg_utils.py:345-363 `Solve`): run the
preconditioned Krylov solve with an iteration budget and assert convergence
behavior — relative residual below tolerance AND iterations under budget —
rather than golden outputs.
"""

from __future__ import annotations

import numpy as np

from ngsamg import AMGOptions, AMGPreconditioner


def solve_and_check(
    prob,
    *,
    ms: int = 100,
    tol: float = 1e-8,
    options: AMGOptions | None = None,
    energy: str = "h1",
    **kw,
):
    """Build AMG, PCG-solve, assert convergence within the iteration budget.

    ``ms`` is the max-steps budget (reference per-test values: 30-100).
    Returns (pc, x, info).
    """
    pc = AMGPreconditioner(
        prob.A,
        energy=energy,
        block_size=prob.block_size,
        coords=prob.coords,
        options=options,
        **kw,
    ).setup()
    x, info = pc.solve(prob.b, tol=tol, maxiter=ms)
    # true residual check (not the solver's own bookkeeping)
    r = np.linalg.norm(prob.A @ x - prob.b) / np.linalg.norm(prob.b)
    assert r < 10 * tol, f"true relres {r:.3e} vs tol {tol:g}"
    assert info.converged, f"not converged: relres={info.relres:.3e}"
    assert info.iterations < ms, f"iters {info.iterations} >= budget {ms}"
    return pc, x, info
