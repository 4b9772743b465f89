"""JAX runtime configuration helpers (platform, compilation cache and
the precision of device products)."""

from __future__ import annotations

import functools
import os

# fixed in-checkout cache path (listed in .gitignore): the cache key
# includes the path, so a directory that moves never hits
_REPO_CACHE = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE


def enable_persistent_cache():
    """Turn on JAX's persistent compilation cache in :func:`cache_dir`.

    AMG hierarchies re-compile per problem-shape; the cache makes repeated
    test/benchmark runs start hot.
    """
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def full_f32(fn):
    """Trace ``fn`` with every f32 matrix product at full f32 precision.

    The solve's one precision policy. On GPUs an f32 ``dot``/``einsum``
    with default precision may run in TF32; the device cycle's products
    are bandwidth-bound matvecs, so TF32 buys nothing and would make the
    cycle a different preconditioner from the one the CPU tests check.
    The scope is entered at trace time, so it holds inside ``jax.jit``
    whatever the caller's setting; nested uses are harmless.
    """
    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def force_cpu(n_devices: int = 8):
    """Select the CPU backend with n virtual devices (tests / multichip dryrun).

    Must run before the first JAX backend use.
    """
    os.environ.setdefault(
        "XLA_FLAGS",
        f"--xla_force_host_platform_device_count={n_devices}",
    )
    if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += (
            f" --xla_force_host_platform_device_count={n_devices}"
        )
    import jax

    jax.config.update("jax_platforms", "cpu")
