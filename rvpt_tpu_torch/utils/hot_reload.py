"""Hot reload: source watch -> re-import (mirror of
``rvpt_tpu/utils/hot_reload.py``).

The reference's shader hot reload rebuilds every pipeline while handles
stay valid through an index indirection (src/rvpt/rvpt.cpp:444-468,
vk_util.cpp:799-813).  Here the watcher re-imports the package's changed
Python modules and drops the loaded kernel libraries (``ops.build.unload``):
each library's name carries a hash of its CUDA sources, so the next launch
loads it again, or rebuilds it when a source under ``csrc/`` changed.
"""

from __future__ import annotations

import importlib
import os
import sys
from types import ModuleType


class SourceWatcher:
    """Tracks the mtimes of a package's loaded modules;
    ``reload_if_changed`` re-imports the dirty ones and drops the kernel
    libraries."""

    def __init__(self, package: str = "rvpt_tpu_torch") -> None:
        self.package = package
        self._mtimes: dict[str, float] = {}
        self.scan()

    def _files(self):
        for name, mod in list(sys.modules.items()):
            if not name.startswith(self.package):
                continue
            f = getattr(mod, "__file__", None)
            if f and os.path.exists(f):
                yield name, f

    def scan(self) -> None:
        for name, f in self._files():
            self._mtimes[name] = os.path.getmtime(f)

    def dirty_modules(self) -> list[str]:
        return [name for name, f in self._files()
                if os.path.getmtime(f) > self._mtimes.get(name, 0)]

    def reload_if_changed(self, clear_caches: bool = True) -> list[str]:
        """Reload the modified modules, deepest first; on any reload and
        with ``clear_caches``, drop the loaded kernel libraries.  Returns
        the reloaded module names."""
        dirty = self.dirty_modules()
        if not dirty:
            return []
        for name in sorted(dirty, key=lambda n: -n.count(".")):
            mod = sys.modules.get(name)
            if isinstance(mod, ModuleType):
                importlib.reload(mod)
            self._mtimes[name] = os.path.getmtime(sys.modules[name].__file__)
        if clear_caches:
            from ..ops import build

            build.unload()
        return dirty
