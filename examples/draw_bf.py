"""Coarse basis-function visualization data (reference examples drawBF.py).

Prints/draws the support and values of coarse AMG basis functions via
`GetBF` — here dumped as text/ppm-style ASCII since there is no GUI.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ngsamg.api as NgsAMG
from ngsamg.utils import fem
from ngsamg.utils.jaxcfg import enable_persistent_cache

enable_persistent_cache()

n = 32
p = fem.poisson_2d(n)
pc = NgsAMG.h1_scal(p.A, ngs_amg_max_coarse_size=50)
print("levels:", pc.GetNLevels())

level = min(2, pc.GetNLevels() - 1)
dof = pc.GetNDof(level) // 2
bf = pc.GetBF(level=level, dof=dof)
m = n - 1
grid = np.zeros((m, m))
grid[:] = bf.reshape(m, m)
print(f"basis function of level-{level} dof {dof}: support "
      f"{(np.abs(bf) > 1e-12).sum()} vertices, max {bf.max():.3f}")
scale = " .:-=+*#%@"
lo, hi = grid.min(), grid.max()
for row in grid[:: max(m // 32, 1)]:
    line = "".join(
        scale[int((v - lo) / (hi - lo + 1e-30) * (len(scale) - 1))]
        for v in row[:: max(m // 64, 1)]
    )
    print(line)
