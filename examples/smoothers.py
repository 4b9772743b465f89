"""Standalone smoother benchmark (reference examples/smoothers/smoothers.py).

Compares the exported smoothers (multicolor GS, l1-Jacobi, Chebyshev) as
stationary iterations on a 3D Poisson matrix, reporting the residual
reduction per sweep and sweep timings.
"""

import time

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ngsamg.api as NgsAMG
from ngsamg.utils import fem
from ngsamg.utils.jaxcfg import enable_persistent_cache

enable_persistent_cache()

p = fem.poisson_3d(32)
print(f"3D Poisson, {p.n} DOFs")
rng = np.random.default_rng(0)
xex = rng.standard_normal(p.n)
b = p.A @ xex

for name, ctor in [
    ("multicolor GS", NgsAMG.CreateHybridGSS),
    ("l1-Jacobi", NgsAMG.CreateJacobiSmoother),
    ("Chebyshev(3)", NgsAMG.CreateChebyshevSmoother),
]:
    sm = ctor(p.A)
    x = np.zeros(p.n)
    t0 = time.perf_counter()
    res = [np.linalg.norm(b)]
    for _ in range(8):
        x = sm.Smooth(x, b)
        x = sm.SmoothBack(x, b)
        res.append(np.linalg.norm(b - p.A @ x))
    dt = (time.perf_counter() - t0) / 8
    rate = (res[-1] / res[0]) ** (1 / 8)
    print(
        f"  {name:15s} rate/sym-sweep={rate:.3f}"
        f"  relres after 8: {res[-1]/res[0]:.2e}  {dt*1000:.1f} ms/sweep"
    )
