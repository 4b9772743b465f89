"""Former import name of :mod:`ngsamg`, kept so that existing imports
keep working.

Importing this package or any ``<this package>.x.y`` gives the very
module object that ``import ngsamg.x.y`` gives: no module is loaded
twice, so classes and options compare equal under either name.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import ngsamg

_OLD = __name__
_NEW = ngsamg.__name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.x.y`` to ``ngsamg.x.y``."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        real = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = real.__spec__
        return real

    def exec_module(self, module):
        # the import system stamped the alias spec on the real module
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = ngsamg
