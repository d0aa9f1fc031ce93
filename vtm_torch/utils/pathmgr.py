"""URI-aware path manager (copy of ``vtm/utils/pathmgr.py``): the analog
of PySlowFast's iopath ``pathmgr`` (slowfast/utils/env.py: a
PathManager with registered handlers for cloud URIs).

The same minimal surface (open/exists/isdir/ls/mkdirs/rm/copy) with a
registrable scheme table. Local paths work out of the box; ``gs://`` and
``s3://`` handlers are made on first use when ``fsspec`` (and the scheme's
filesystem package) imports, and otherwise raise an ImportError naming what is missing
instead of mangling the URI. The AVA dataset and its evaluator open every
file through ``pathmgr``.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List


class _LocalHandler:
    def open(self, path: str, mode: str = "r", **kw):
        if "w" in mode or "a" in mode:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        return open(path, mode, **kw)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def ls(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def rm(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def copy(self, src: str, dst: str) -> None:
        shutil.copy(src, dst)


class _FsspecHandler:
    """Cloud URIs through fsspec (gs://, s3://, ...) when available."""

    def __init__(self, scheme: str):
        import fsspec  # raises ImportError when absent — caught at registry time

        self.fs = fsspec.filesystem(scheme)
        self.scheme = scheme

    def open(self, path: str, mode: str = "r", **kw):
        return self.fs.open(path, mode, **kw)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def isdir(self, path: str) -> bool:
        return self.fs.isdir(path)

    def ls(self, path: str) -> List[str]:
        return sorted(os.path.basename(p.rstrip("/")) for p in self.fs.ls(path))

    def mkdirs(self, path: str) -> None:
        self.fs.makedirs(path, exist_ok=True)

    def rm(self, path: str) -> None:
        self.fs.rm(path, recursive=True)

    def copy(self, src: str, dst: str) -> None:
        self.fs.copy(src, dst)


class PathManager:
    def __init__(self):
        self._local = _LocalHandler()
        self._handlers: Dict[str, object] = {}
        self._factories: Dict[str, Callable[[], object]] = {
            "gs": lambda: _FsspecHandler("gs"),
            "s3": lambda: _FsspecHandler("s3"),
        }

    def register(self, scheme: str, factory: Callable[[], object]) -> None:
        self._factories[scheme] = factory

    def _handler(self, path: str):
        if "://" not in path:
            return self._local
        scheme = path.split("://", 1)[0]
        if scheme in self._handlers:
            return self._handlers[scheme]
        if scheme not in self._factories:
            raise ValueError(f"no path handler registered for scheme {scheme!r}")
        try:
            handler = self._factories[scheme]()
        except ImportError as e:
            raise ImportError(
                f"opening {scheme}:// paths requires fsspec (+ the {scheme} filesystem package), "
                f"which is not installed: {e}"
            ) from e
        self._handlers[scheme] = handler
        return handler

    def open(self, path: str, mode: str = "r", **kw):
        return self._handler(path).open(path, mode, **kw)

    def exists(self, path: str) -> bool:
        return self._handler(path).exists(path)

    def isdir(self, path: str) -> bool:
        return self._handler(path).isdir(path)

    def ls(self, path: str) -> List[str]:
        return self._handler(path).ls(path)

    def mkdirs(self, path: str) -> None:
        self._handler(path).mkdirs(path)

    def rm(self, path: str) -> None:
        self._handler(path).rm(path)

    def copy(self, src: str, dst: str) -> None:
        self._handler(src).copy(src, dst)


pathmgr = PathManager()
