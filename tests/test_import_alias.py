"""Former import names of the package: every other top-level package of
the checkout whose name starts with ``ngsamg`` is an alias of ``ngsamg``,
and its modules are ngsamg's own module objects."""

import importlib
import pathlib

import pytest

import ngsamg

REPO = pathlib.Path(__file__).resolve().parent.parent
ALIASES = sorted(
    p.name for p in REPO.iterdir()
    if p.name.startswith("ngsamg") and p.name != "ngsamg"
    and (p / "__init__.py").is_file()
)


def test_an_alias_exists():
    assert ALIASES


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize(
    "sub", ["", ".api", ".precond.amg", ".sparse.formats", ".native"]
)
def test_alias_gives_the_same_module(alias, sub):
    mod = importlib.import_module(alias + sub)
    real = importlib.import_module("ngsamg" + sub)
    assert mod is real
    assert real.__spec__.name == "ngsamg" + sub


def test_alias_classes_are_ngsamg_classes():
    for alias in ALIASES:
        amg = importlib.import_module(alias + ".precond.amg")
        assert amg.AMGPreconditioner is ngsamg.AMGPreconditioner
