"""chip_smoke.py on the CPU: its refusal without a GPU, each phase at a
tiny size, the compile-cache location, and that every Pallas import
takes a GPU route.

The ``gpu``-marked test runs the whole script on a card, in a child
process so that the card is held by one process only; it skips where
there is no card."""

import ast
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from ngsamg.utils import jaxcfg

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize(
    "phase,kw",
    [
        ("poisson", dict(n=40, n_ref=16, copy_bytes=1 << 22)),
        ("unstructured", dict(n=14)),
        ("elasticity", dict(n=18, refine=0)),
        ("stokes", dict(n=5)),
        ("gs", dict(n=20)),
        ("sharded", dict(n=24, n_dist=24, halo_sizes=(40, 70))),
    ],
)
def test_phase_runs_on_cpu(phase, kw):
    out = getattr(chip_smoke, phase)(**kw)
    assert isinstance(out, dict) and out


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        jaxcfg.enable_persistent_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert pathlib.Path(jaxcfg.cache_dir()) == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# Pallas modules a kernel of this package may import: the core API and
# the two GPU routes
PALLAS_OK = {
    "jax.experimental.pallas",
    "jax.experimental.pallas.triton",
    "jax.experimental.pallas.mosaic_gpu",
}


def _imported_modules(tree):
    """Dotted names a module imports; ``from m import n`` also yields
    ``m.n``, which may name a submodule."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_pallas_imports_take_gpu_routes():
    for path in (REPO / "ngsamg").rglob("*.py"):
        src = path.read_text()
        for mod in _imported_modules(ast.parse(src)):
            if mod.startswith("jax.experimental.pallas.") and (
                importlib.util.find_spec(mod) is not None
            ):
                assert mod in PALLAS_OK, f"{path}: imports {mod}"
        for name in ("pallas_available", "use_pallas"):
            assert name not in src, f"{path}: {name}"


@pytest.fixture
def gpu_card():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True
    ).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
