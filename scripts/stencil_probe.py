"""Finest-level StencilDia SpMV variants on the headline 3D Poisson:
kernel rate against a copy, and the end-to-end solve with each variant.

    python scripts/stencil_probe.py [n]      (default n = 216, 9.94M DoF)

Variants, timed in the order xla, roll, roll, xla so that drift of the
card's clock shows as a difference between the two turns of one variant:

* ``xla``:  ``formats._stencil_dia_matvec`` as shipped (zero-padded n-d
  shifts + FMAs, one XLA fusion);
* ``roll``: the same sum over masked ``jnp.roll`` shifts of the flat
  vector, with no padded copies of x or y.

Each variant is checked against scipy in f64 (``chip_smoke.kernel_check``)
and must give the same iteration count. A third variant was timed once
and removed: a Pallas kernel on the Triton route (``backend="triton"``),
one program per block of 1024 rows, each of the stencil's offsets a
masked load of x at the row's flat neighbour index (masked where the
neighbour leaves the grid), summed with the offset's coefficient. To
time such a kernel again, add it to ``VARIANTS`` under its own name.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from __graft_entry__ import cheby_options  # noqa: E402
from ngsamg import AMGPreconditioner  # noqa: E402
from ngsamg.sparse import formats  # noqa: E402
from ngsamg.utils import fem  # noqa: E402
from ngsamg.utils.jaxcfg import (  # noqa: E402
    enable_persistent_cache,
    full_f32,
)


def roll_matvec(A, x):
    """Masked-roll form of the StencilDia matvec: no padded arrays."""
    d = len(A.dims)
    st = [1] * d
    for k in range(d - 2, -1, -1):
        st[k] = st[k + 1] * A.dims[k + 1]
    xf = x[:, 0]
    r = jnp.arange(A.nrows_pad, dtype=jnp.int32)
    coord, rem = [], r
    for k in range(d):
        coord.append(rem // st[k])
        rem = rem - coord[-1] * st[k]
    y = jnp.zeros_like(xf)
    for t, off in enumerate(A.offs):
        ok = r < A.nrows
        for k, o in enumerate(off):
            if o > 0:
                ok = ok & (coord[k] < A.dims[k] - o)
            elif o < 0:
                ok = ok & (coord[k] >= -o)
        shift = sum(int(o) * s for o, s in zip(off, st))
        y = y + jnp.where(ok, A.vals[t] * jnp.roll(xf, -shift), 0.0)
    return y[:, None]


VARIANTS = {"xla": formats._stencil_dia_matvec, "roll": roll_matvec}


def main(n: int) -> None:
    enable_persistent_cache()
    try:
        card = cs.card_line()
    except (OSError, subprocess.CalledProcessError):
        card = "no nvidia-smi"
    print(f"card: {card}; {jax.devices()}", flush=True)
    prob = fem.poisson_3d(n)
    t0 = time.perf_counter()
    pc = AMGPreconditioner(
        prob.A, coords=prob.coords, options=cheby_options()
    ).setup()
    print(f"setup {time.perf_counter() - t0:.3f} s, levels "
          f"{cs._level_formats(pc.op)}", flush=True)
    A = pc.op.levels[0].A
    a = jnp.ones(((1 << 30) // 4,), jnp.float32)
    copy = 2 * a.nbytes / cs.device_seconds(
        lambda s, v: v * s, jnp.float32(1.0), a
    )
    del a
    print(f"copy {copy / 1e9:.1f} GB/s", flush=True)
    best = {}
    for name in ("xla", "roll", "roll", "xla"):
        formats._stencil_dia_matvec = VARIANTS[name]
        jax.clear_caches()
        cs._finest_check(pc)
        x = jnp.ones((A.nrows_pad, 1), jnp.float32)
        sec = cs.device_seconds(full_f32(formats.matvec), A, x)
        nb = 2 * x.nbytes
        pc.solve(prob.b, tol=1e-8, maxiter=8)  # compiles
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            xs, info = pc.solve(prob.b, tol=1e-8)
            ts.append(time.perf_counter() - t0)
        rr = cs._host_relres(prob.A, xs, prob.b)
        print(f"[{name}] matvec {sec * 1e3:.4f} ms = {nb / sec / 1e9:.1f} "
              f"GB/s ({nb / sec / copy:.2f} of copy); solve "
              f"{['%.4f' % t for t in ts]} s, {info.iterations} it, "
              f"relres {rr:.3e}", flush=True)
        best.setdefault(name, []).append(min(ts))
    formats._stencil_dia_matvec = VARIANTS["xla"]
    print("best solve s:", {k: min(v) for k, v in best.items()}, flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 216)
