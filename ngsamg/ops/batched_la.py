"""Batched small-matrix dense kernels (device).

JAX counterpart of the reference's dense LA utilities
(/root/reference/src/base/utils/utils_denseLA.hpp:267-1460):
`CalcPseudoInverseNew` / `CalcPseudoInverseWithTol` (eigendecomposition-based
pseudo-inverse with a relative zero threshold) and the generalized
eigenproblem kernels (`MEV`, `CalcRobustPairSOC`) that drive robust
elasticity coarsening. Shapes are (batch, k, k) with k in {1,2,3,6,8} —
thousands of tiny Hermitian problems solved as one `jnp.linalg.eigh` batch.

The host setup path uses the numpy equivalents (apps/elasticity.py,
smoothers/build.py); these device versions serve on-device setup stages and
are exercised by the test suite on CPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp



@partial(jax.jit, static_argnames=("rel_tol",))
def pinv_batched(M: jax.Array, rel_tol: float = 1e-10) -> jax.Array:
    """Eigendecomposition pseudo-inverse of symmetric (b, k, k) blocks.

    Eigenvalues below rel_tol * lam_max are treated as kernel
    (CalcPseudoInverseWithTol).
    """
    lam, V = jnp.linalg.eigh(M)
    tol = max(rel_tol, 64.0 * float(jnp.finfo(M.dtype).eps))
    lam_max = jnp.maximum(jnp.abs(lam).max(axis=-1, keepdims=True), 1e-300)
    ok = jnp.abs(lam) > tol * lam_max
    inv = jnp.where(ok, 1.0 / jnp.where(ok, lam, 1.0), 0.0)
    return jnp.einsum("bik,bk,bjk->bij", V, inv, V)


@partial(jax.jit, static_argnames=("rel_tol", "reduction"))
def pencil_extreme_eig(
    E: jax.Array,
    C: jax.Array,
    rel_tol: float = 1e-10,
    reduction: str = "min",
) -> jax.Array:
    """Extreme eigenvalue of the pencil (E, C) restricted to range(C).

    Device-batched `CalcRobustPairSOC` (utils_denseLA / agglomerator_utils):
    eigendecompose C, scale above-threshold eigvecs by 1/sqrt(lam), form
    W^T E W, and take the min (or max) eigenvalue, masking null directions
    of C with a +/-inf sentinel.
    """
    lam, V = jnp.linalg.eigh(C)
    tol = max(rel_tol, 64.0 * float(jnp.finfo(C.dtype).eps))
    lam_max = jnp.maximum(lam[..., -1:], 1e-300)
    ok = lam > tol * lam_max
    isq = jnp.where(ok, jax.lax.rsqrt(jnp.where(ok, lam, 1.0)), 0.0)
    W = V * isq[..., None, :]
    M = jnp.einsum("bki,bkl,blj->bij", W, E, W)
    big = 1e30 if reduction == "min" else -1e30
    k = E.shape[-1]
    diag_pen = jnp.where(ok, 0.0, big)  # (b, k): null dirs never win
    M = M + jnp.eye(k, dtype=M.dtype) * diag_pen[..., None, :]
    ev = jnp.linalg.eigvalsh(M)
    out = ev[..., 0] if reduction == "min" else ev[..., -1]
    allnull = ~ok.any(axis=-1)
    return jnp.where(allnull, 0.0, jnp.maximum(out, 0.0))


@jax.jit
def harmonic_mean_batched(A: jax.Array, B: jax.Array) -> jax.Array:
    """2 * A (A + B)^+ B symmetrized — the matrix harmonic mean used by the
    robust SOC preparation (`PrepRobSOC`)."""
    S = pinv_batched(A + B)
    H = jnp.einsum("bik,bkl,blj->bij", A, S, B)
    return H + jnp.swapaxes(H, -1, -2)