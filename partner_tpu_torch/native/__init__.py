"""Native (C++) host kernels of the data path, loaded with ctypes.

Counterpart of ``partner_tpu/native/__init__.py``, with its own copy of the
source (``src/partner_native.cpp``): the hard voxelizer, the GT-AUG box
collision test and the points-in-box test. ``ctypes.CDLL`` calls release
the interpreter lock, so the data loader's threads run these side by side,
where the numpy bodies hold the lock between their array operations.

Build: at first use ``g++ -O3 -std=c++17 -shared -fPIC`` compiles the
source into ``partner_tpu_torch/.build/``, keyed by a hash of the source
text, so it rebuilds only when the source changes; a finished build is
reused by every later process. Where the build or the load fails (no
``g++``, say), the callers run the numpy bodies
(``ops/voxelize.points_to_voxel``, ``data/augment.box_collision_test_np``,
``core/box_np_ops.points_in_rbbox_np``), which stay the parity oracles; the
failure and the compiler's stderr are logged once. :func:`available` says
which path runs, and :func:`numpy_only` runs the numpy bodies for a while
(to time or compare the two).

Public API (numpy in and out):
  available() -> bool
  numpy_only() -> context manager
  points_to_voxel(points, voxel_size, pc_range, max_points, max_voxels)
  box_collision_test(corners_a, corners_b) -> bool (N, K)
  points_in_rbbox(points, boxes) -> bool (P, N)
"""

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "src", "partner_native.cpp")
BUILD_DIR = os.path.join(_PKG, ".build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_NUMPY_ONLY = False
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry point -> (restype, argtypes)
_SIGNATURES = {
    # points, n, n_feat, voxel_size, pc_range, max_points, max_voxels,
    # voxels, coords, num_points -> voxels emitted
    "ptn_points_to_voxel": (_I, [_P, _I64, _I, _P, _P, _I, _I, _P, _P, _P]),
    # corners_a, n, corners_b, k, out
    "ptn_box_collision": (None, [_P, _I64, _P, _I64, _P]),
    # points, n, point stride, boxes, k, box stride, out
    "ptn_points_in_rbbox": (None, [_P, _I64, _I, _P, _I64, _I, _P]),
}


def library_path():
    """Where the build of the current source lives."""
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"partner_native_{tag}.so")


def _build_and_load():
    so_path = library_path()
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, SRC], check=True, capture_output=True,
                       text=True)
        os.replace(tmp, so_path)   # atomic for concurrent builders
    lib = ctypes.CDLL(so_path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _lib():
    global _LIB, _TRIED
    if not _TRIED:
        with _LOCK:
            if not _TRIED:
                try:
                    _LIB = _build_and_load()
                except subprocess.CalledProcessError as e:
                    logging.getLogger(__name__).warning(
                        "native library: g++ failed (exit %s); the data "
                        "path runs its numpy bodies. stderr:\n%s",
                        e.returncode, e.stderr)
                except OSError as e:
                    logging.getLogger(__name__).warning(
                        "native library: not built or not loaded (%s); the "
                        "data path runs its numpy bodies", e)
                _TRIED = True
    return None if _NUMPY_ONLY else _LIB


def available() -> bool:
    """True where the native library runs (built, loaded, and not inside
    :func:`numpy_only`); False where the numpy bodies run."""
    return _lib() is not None


@contextlib.contextmanager
def numpy_only():
    """Run the numpy bodies in place of the library inside the block (in
    every thread)."""
    global _NUMPY_ONLY
    before, _NUMPY_ONLY = _NUMPY_ONLY, True
    try:
        yield
    finally:
        _NUMPY_ONLY = before


def _loaded():
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native library is not available")
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def points_to_voxel(points, voxel_size, pc_range, max_points, max_voxels):
    """FCFS hard voxelization, the contract of
    ``ops/voxelize.points_to_voxel``: (voxels (V, max_points, C),
    coords (V, 3) int32 (z, y, x), num_points (V,) int32), trimmed to the
    voxels emitted."""
    lib = _loaded()
    points = np.ascontiguousarray(points, dtype=np.float32)
    voxel_size = np.ascontiguousarray(voxel_size, dtype=np.float32)
    pc_range = np.ascontiguousarray(pc_range, dtype=np.float32)
    n, c = points.shape
    voxels = np.zeros((max_voxels, max_points, c), dtype=np.float32)
    coords = np.zeros((max_voxels, 3), dtype=np.int32)
    num_points = np.zeros((max_voxels,), dtype=np.int32)
    n_vox = lib.ptn_points_to_voxel(
        _ptr(points), n, c, _ptr(voxel_size), _ptr(pc_range),
        int(max_points), int(max_voxels), _ptr(voxels), _ptr(coords),
        _ptr(num_points))
    return voxels[:n_vox], coords[:n_vox], num_points[:n_vox]


def box_collision_test(corners_a, corners_b):
    """Separating-axis rectangle overlap, bool (N, K)."""
    lib = _loaded()
    a = np.ascontiguousarray(corners_a, dtype=np.float32)
    b = np.ascontiguousarray(corners_b, dtype=np.float32)
    n, k = len(a), len(b)
    out = np.zeros((n, k), dtype=np.uint8)
    if n and k:
        lib.ptn_box_collision(_ptr(a), n, _ptr(b), k, _ptr(out))
    return out.astype(bool)


def points_in_rbbox(points, boxes):
    """Rotated 3D box membership, bool (P, N); the yaw is the last box
    column (7- and 9-column boxes)."""
    lib = _loaded()
    p = np.ascontiguousarray(points, dtype=np.float32)
    b = np.ascontiguousarray(boxes, dtype=np.float32)
    n, k = len(p), len(b)
    out = np.zeros((n, k), dtype=np.uint8)
    if n and k:
        lib.ptn_points_in_rbbox(_ptr(p), n, p.shape[1], _ptr(b), k,
                                b.shape[1], _ptr(out))
    return out.astype(bool)
