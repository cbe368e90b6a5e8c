"""Pluggable remote-path filesystem for checkpoints and data files
(the port's own copy of ``partner_tpu/utils/remote_io.py``).

Paths that carry a scheme prefix (``oss://bucket/key``, ``s3://...``,
``memory://...``) route to a backend registered for that scheme; plain
paths stay on the local filesystem. Backends register at run time:

    from partner_tpu_torch.utils import remote_io
    remote_io.register("s3", MyS3FileSystem())

Each backend implements the small :class:`FileSystem` protocol (read and
write bytes, exists, makedirs, listdir, delete_tree).
:class:`MemoryFileSystem` is the in-tree test double and reference of the
protocol. The helpers (``read_bytes``, ``write_bytes``, ``exists``, ...)
take either kind of path, so the port's checkpoints work against remote
storage unchanged.
"""

import io
import os
import threading
from typing import Dict, List

_REGISTRY: Dict[str, "FileSystem"] = {}
_LOCK = threading.Lock()


class FileSystem:
    """Backend protocol; subclass and register under a scheme."""

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:  # no-op for object stores
        pass

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete_tree(self, path: str) -> None:
        """Remove a directory/prefix recursively (used by checkpoint
        ``keep`` pruning). Best-effort; missing paths are not an error."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def read_bytes(self, path):
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path, data):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def exists(self, path):
        return os.path.exists(path)

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def listdir(self, path):
        return sorted(os.listdir(path))

    def delete_tree(self, path):
        import shutil

        shutil.rmtree(path, ignore_errors=True)


class MemoryFileSystem(FileSystem):
    """In-memory object store — the test double and protocol reference."""

    def __init__(self):
        self.blobs: Dict[str, bytes] = {}

    def read_bytes(self, path):
        if path not in self.blobs:
            raise FileNotFoundError(path)
        return self.blobs[path]

    def write_bytes(self, path, data):
        self.blobs[path] = bytes(data)

    def exists(self, path):
        return path in self.blobs or any(
            k.startswith(path.rstrip("/") + "/") for k in self.blobs)

    def listdir(self, path):
        prefix = path.rstrip("/") + "/"
        names = {k[len(prefix):].split("/")[0]
                 for k in self.blobs if k.startswith(prefix)}
        return sorted(names)

    def delete_tree(self, path):
        prefix = path.rstrip("/") + "/"
        for k in [k for k in self.blobs
                  if k == path or k.startswith(prefix)]:
            del self.blobs[k]


_LOCAL = LocalFileSystem()


def register(scheme: str, fs: FileSystem) -> None:
    with _LOCK:
        _REGISTRY[scheme] = fs


def resolve(path: str):
    """(filesystem, backend_path) for a possibly scheme-prefixed path."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        fs = _REGISTRY.get(scheme)
        if fs is None:
            raise ValueError(
                f"no filesystem registered for scheme {scheme!r}; call "
                f"partner_tpu_torch.utils.remote_io.register({scheme!r}, fs)")
        return fs, rest
    return _LOCAL, path


def read_bytes(path: str) -> bytes:
    fs, p = resolve(path)
    return fs.read_bytes(p)


def write_bytes(path: str, data: bytes) -> None:
    fs, p = resolve(path)
    fs.write_bytes(p, data)


def exists(path: str) -> bool:
    fs, p = resolve(path)
    return fs.exists(p)


def makedirs(path: str) -> None:
    fs, p = resolve(path)
    fs.makedirs(p)


def listdir(path: str) -> List[str]:
    fs, p = resolve(path)
    return fs.listdir(p)


def delete_tree(path: str) -> None:
    fs, p = resolve(path)
    fs.delete_tree(p)


def open_read(path: str) -> io.BytesIO:
    return io.BytesIO(read_bytes(path))
