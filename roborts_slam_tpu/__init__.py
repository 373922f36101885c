"""The package's former import name, kept as an alias of ``roborts_slam``.

``import <former name>.engine`` yields the very module object
``roborts_slam.engine``: a finder maps every submodule name onto the
package's own, so no second copy of any module is loaded."""

import importlib
import importlib.abc
import importlib.util
import sys

import roborts_slam

_FORMER = __name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.startswith(_FORMER + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(
            "roborts_slam" + spec.name[len(_FORMER):])

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, _AliasFinder())
sys.modules[_FORMER] = roborts_slam
