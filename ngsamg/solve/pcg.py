"""Preconditioned conjugate gradients + simple iteration drivers (device).

Device counterpart of the reference's solver layer
(/root/reference/src/base/solve/LinearSolver.hpp:10-87) and of the CG its
tests drive through NGSolve krylovspace (tests/h1/amg_utils.py:357).

The Krylov loop runs on device as *chunks* of `lax.fori_loop` iterations
with a static trip count; once the residual drops below tolerance the
state freezes (masked updates), and the host driver reads the residual
scalar between chunks and stops early. One host<->device round trip per
chunk, all FLOPs on the device. Every chunk is traced under
:func:`~ngsamg.utils.jaxcfg.full_f32` (f32 products at full f32).
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.bell import BlockELL
from ..sparse.formats import matvec
from ..utils.jaxcfg import full_f32
from .cycle import AMGOperator, amg_apply


class SolveResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array  # int32
    relres: jax.Array  # final ||r|| / ||b||


def default_chunk() -> int:
    """Iterations per device dispatch (`NGSAMG_PCG_CHUNK` overrides 16)."""
    env = os.environ.get("NGSAMG_PCG_CHUNK")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            import warnings

            warnings.warn(
                f"ignoring malformed NGSAMG_PCG_CHUNK={env!r}; "
                "using the backend default"
            )
    return 16


@full_f32
def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.vdot(a.reshape(-1), b.reshape(-1))


def _pcg_init(b: jax.Array):
    """Trivial PCG start state (no preconditioner application needed).

    The M-apply happens at the *top* of each iteration body, so the AMG
    cycle is traced/compiled exactly once (inside `_pcg_chunk`).
    """
    x = jnp.zeros_like(b)
    p = jnp.zeros_like(b)
    rz = jnp.zeros((), b.dtype)
    rn = _dot(b, b)
    return (x, b, p, rz, rn, jnp.int32(0))


@partial(jax.jit, static_argnames=("chunk",))
@full_f32
def _pcg_chunk(
    op: AMGOperator,
    A: BlockELL,
    state,
    tol_abs2: jax.Array,
    chunk: int = 16,
):
    """Run up to `chunk` PCG iterations; converged state is frozen."""
    eps = jnp.finfo(state[0].dtype).tiny

    def body(_i, s):
        x, r, p, rz_prev, rn, k = s
        active = rn > tol_abs2
        z = amg_apply(op, r)
        rz = _dot(r, z)
        first = k == 0
        beta = jnp.where(
            first, 0.0, rz / jnp.where(rz_prev == 0, eps, rz_prev)
        )
        p_new = z + beta * p
        q = matvec(A, p_new)
        pq = _dot(p_new, q)
        ok = active & (pq > 0) & (jnp.abs(rz) > 0)
        alpha = jnp.where(ok, rz / jnp.where(pq == 0, eps, pq), 0.0)
        x = x + alpha * p_new
        r = jnp.where(ok, r - alpha * q, r)
        p = jnp.where(ok, p_new, p)
        rz_prev = jnp.where(ok, rz, rz_prev)
        rn = jnp.where(ok, _dot(r, r), rn)
        k = k + ok.astype(jnp.int32)
        return (x, r, p, rz_prev, rn, k)

    return jax.lax.fori_loop(0, chunk, body, state)


def pcg(
    op: AMGOperator,
    A: BlockELL,
    b: jax.Array,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    chunk: int | None = None,
) -> SolveResult:
    """PCG with the AMG cycle as preconditioner. Zero initial guess.

    Host-driven chunk loop: early exit once converged (the between-chunk
    device->host read is a single scalar).
    """
    if chunk is None:
        chunk = default_chunk()
    bnorm2 = float(_dot(b, b))
    if bnorm2 == 0.0:
        z = jnp.zeros_like(b)
        return SolveResult(z, jnp.int32(0), jnp.asarray(0.0, b.dtype))
    tol_abs2 = jnp.asarray(tol * tol * bnorm2, b.dtype)
    state = _pcg_init(b)
    done = 0
    while done < maxiter:
        state = _pcg_chunk(op, A, state, tol_abs2, chunk=chunk)
        done += chunk
        rn = float(state[4])
        if not np.isfinite(rn) or rn <= float(tol_abs2):
            break
    x, r, _p, _rz, rn, k = state
    relres = jnp.sqrt(jnp.maximum(rn, 0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)


@partial(jax.jit, static_argnames=("chunk", "cycle_dt"))
@full_f32
def _pcg_mixed_chunk(
    op: AMGOperator,
    A64,
    state,
    tol_abs2: jax.Array,
    w=1.0,
    chunk: int = 4,
    cycle_dt: str = "float32",
):
    """Mixed-precision PCG chunk: f64 Krylov state + f64 finest matvec,
    the (f32/bf16) AMG cycle as M.

    M is applied to the unit-normalized residual (exact for a linear M),
    so the cast into the cycle dtype never leaves its dynamic range. The
    whole iteration is device-resident: no per-iteration host round trip,
    unlike the host-driven mixed outer.

    ``w`` WEIGHTS the convergence norm only (CG inner products stay in
    the solve space): on a symmetrically scaled hierarchy A-hat = SAS,
    passing w = S^-1 makes the stopping criterion the honest UNSCALED
    relative residual ||S^-1 r-hat|| / ||S^-1 b-hat|| = ||r||/||b||
    (the scaled-space norm can sit an order of magnitude off it).
    """
    dt = jnp.dtype(cycle_dt)
    tiny = jnp.finfo(jnp.float64).tiny
    from ..sparse.formats import f64_matvec_slabs, matvec_slabbed

    nslabs = f64_matvec_slabs(A64)

    def body(_i, s):
        x, r, p, rz_prev, rn, k = s
        active = rn > tol_abs2
        # cycle normalization needs the SOLVE-space residual norm (any
        # positive scale is exact for a linear M, but stay consistent)
        rnorm = jnp.sqrt(jnp.maximum(_dot(r, r), tiny))
        z32 = amg_apply(op, (r * (1.0 / rnorm)).astype(dt))
        z = z32.astype(jnp.float64) * rnorm
        rz = _dot(r, z)
        first = k == 0
        beta = jnp.where(
            first, 0.0, rz / jnp.where(rz_prev == 0, tiny, rz_prev)
        )
        p_new = z + beta * p
        q = matvec_slabbed(A64, p_new, nslabs)
        pq = _dot(p_new, q)
        ok = active & (pq > 0) & (jnp.abs(rz) > 0)
        alpha = jnp.where(ok, rz / jnp.where(pq == 0, tiny, pq), 0.0)
        x = x + alpha * p_new
        r = jnp.where(ok, r - alpha * q, r)
        p = jnp.where(ok, p_new, p)
        rz_prev = jnp.where(ok, rz, rz_prev)
        rw = w * r
        rn = jnp.where(ok, _dot(rw, rw), rn)
        k = k + ok.astype(jnp.int32)
        return (x, r, p, rz_prev, rn, k)

    return jax.lax.fori_loop(0, chunk, body, state)


def pcg_mixed(
    op: AMGOperator,
    A64,
    b64: jax.Array,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    chunk: int | None = None,
    cycle_dt: str = "float32",
    weight=None,
) -> SolveResult:
    """Device-resident mixed-precision PCG (f64 Krylov, low-precision M).

    ``A64`` is the exact f64 finest operator ON DEVICE; ``b64`` an f64
    device block vector. Iteration counts track the f64-quality cycle
    (the reference's all-f64 solves, LinearSolver.hpp:10-87) while the
    smoothing/transfer FLOPs stay in the fast dtype. Must be called
    inside a ``jax.enable_x64(True)`` scope.
    """
    if chunk is None:
        chunk = default_chunk()
    w = 1.0 if weight is None else weight
    wb = b64 if weight is None else b64 * weight
    bnorm2 = float(_dot(wb, wb))
    if bnorm2 == 0.0:
        z = jnp.zeros_like(b64)
        return SolveResult(z, jnp.int32(0), jnp.asarray(0.0, jnp.float64))
    tol_abs2 = jnp.asarray(tol * tol * bnorm2, jnp.float64)
    x = jnp.zeros_like(b64)
    p = jnp.zeros_like(b64)
    state = (
        x, b64, p,
        jnp.zeros((), jnp.float64),
        jnp.asarray(bnorm2, jnp.float64),
        jnp.int32(0),
    )
    done = 0
    while done < maxiter:
        state = _pcg_mixed_chunk(
            op, A64, state, tol_abs2, w, chunk=chunk, cycle_dt=cycle_dt
        )
        done += chunk
        rn = float(state[4])
        if not np.isfinite(rn) or rn <= float(tol_abs2):
            break
    x, _r, _p, _rz, rn, k = state
    relres = jnp.sqrt(jnp.maximum(rn, 0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)


def amg_iteration(
    op: AMGOperator,
    A: BlockELL,
    b: jax.Array,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    chunk: int | None = None,
) -> SolveResult:
    """Stationary AMG iteration x <- x + M^-1 (b - A x).

    The reference's `AMGAsLinearSolver` / `LinearSolver` simple-iteration
    driver (LinearSolver.hpp:73-87).
    """
    if chunk is None:
        chunk = default_chunk()
    bnorm2 = float(_dot(b, b))
    if bnorm2 == 0.0:
        z = jnp.zeros_like(b)
        return SolveResult(z, jnp.int32(0), jnp.asarray(0.0, b.dtype))
    tol_abs2 = jnp.asarray(tol * tol * bnorm2, b.dtype)
    x = jnp.zeros_like(b)
    state = (x, b, jnp.asarray(float(bnorm2), b.dtype), jnp.int32(0))
    done = 0
    while done < maxiter:
        state = _si_chunk(op, A, state, tol_abs2, chunk=chunk)
        done += chunk
        rn = float(state[2])
        if not np.isfinite(rn) or rn <= float(tol_abs2):
            break
    x, r, rn, k = state
    relres = jnp.sqrt(jnp.maximum(rn, 0.0) / bnorm2)
    return SolveResult(x=x, iterations=k, relres=relres)


@partial(jax.jit, static_argnames=("chunk",))
@full_f32
def _si_chunk(op, A, state, tol_abs2, chunk: int = 16):
    def body(_i, s):
        x, r, rn, k = s
        active = rn > tol_abs2
        x_new = x + amg_apply(op, r)
        r_new = r - matvec(A, x_new - x)
        x = jnp.where(active, x_new, x)
        r = jnp.where(active, r_new, r)
        rn = jnp.where(active, _dot(r, r), rn)
        k = k + active.astype(jnp.int32)
        return (x, r, rn, k)

    return jax.lax.fori_loop(0, chunk, body, state)
