"""Host kernels in C++ (the port's copy of robot3dlotus_tpu/native): the
voxel-grid downsample with trace, fused with the workspace crop, that
serving's host preprocessing runs, and the dense stencil neighbour map.

voxelize.cpp is built at first use with `g++ -O3 -march=native` into
build/native/ at the root of the checkout, named by a tag of this CPU and
a hash of the source (a library built for another CPU or from another
source is never loaded), and loaded with ctypes. Nothing falls back: a
failed build raises with the compiler's message, and an input the C++
rejects raises with the contract it broke.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "voxelize.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()
_F = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_longlong)
_I32 = ctypes.POINTER(ctypes.c_int32)
SIGNATURES = {
    # xyz, n, voxel_size, means, first
    "voxelize_trace": [_F, ctypes.c_long, ctypes.c_float, _F, _I64],
    # xyz, n, voxel_size, bbox (7), rm_table, means, first, keep
    "crop_voxelize_trace": [_F, ctypes.c_long, ctypes.c_float, _F,
                            ctypes.c_int, _F, _I64,
                            ctypes.POINTER(ctypes.c_ubyte)],
    # grid, counts, B, N, offs, K, extent, out
    "neighbor_map_dense": [_I32, _I32, ctypes.c_long, ctypes.c_long, _I32,
                           ctypes.c_long, ctypes.c_long,
                           ctypes.POINTER(ctypes.c_int16)],
}


def cpu_tag():
    """Short tag of this CPU's ISA: the library is built -march=native, so
    one built on another CPU could stop at its first call (SIGILL)."""
    txt = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    txt += line
                    break
    except OSError:
        pass
    return hashlib.sha256(txt.encode()).hexdigest()[:8]


def library_path(src=SRC, build_dir=BUILD_DIR):
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir,
                        f"_voxelize-{cpu_tag()}-{digest.hexdigest()[:12]}.so")


def build(src=SRC, build_dir=BUILD_DIR):
    """Compiles `src` into build_dir unless its library is there; returns
    the library's path. A failed compile raises RuntimeError with g++'s
    message."""
    so_path = library_path(src, build_dir)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(build_dir, exist_ok=True)
    # build into a temporary file renamed into place: a concurrent loader
    # never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc={proc.returncode}) for "
                               f"{' '.join(cmd)}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def load(so_path):
    lib = ctypes.CDLL(so_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = argtypes
    return lib


def get_lib():
    """The loaded library, built at the first call."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = load(build())
    return _LIB


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def voxelize_trace_native(xyz, voxel_size):
    """Voxel downsample with trace: (means (M, 3) float32, first (M,)
    int64), voxels in (x, y, z) grid-key order, as ops.voxel.voxelize_pcd_np
    computes them for float32 input. Raises ValueError on a non-finite
    point or a grid over 2^21 cells an axis."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    if n == 0:
        return xyz.reshape(0, 3), np.zeros(0, np.int64)
    means = np.empty((n, 3), np.float32)
    first = np.empty(n, np.int64)
    m = get_lib().voxelize_trace(_ptr(xyz, ctypes.c_float), n,
                                 ctypes.c_float(voxel_size),
                                 _ptr(means, ctypes.c_float),
                                 _ptr(first, ctypes.c_longlong))
    if m < 0:
        raise ValueError("voxelize_trace: the cloud has a non-finite point "
                         "or spans more than 2^21 voxels on an axis")
    return means[:m].copy(), first[:m].copy()


def crop_voxelize_trace_native(xyz, voxel_size, workspace, rm_table=True):
    """Workspace crop (strictly inside X/Y/Z_BBOX, and above TABLE_HEIGHT
    with rm_table) fused with the voxel downsample. Returns (means (M, 3)
    float32, first (M,) int64 indices into the uncropped cloud, keep (n,)
    bool crop mask); raises ValueError when the kept points span more than
    2^21 voxels on an axis."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    bbox = np.asarray([
        workspace["X_BBOX"][0], workspace["X_BBOX"][1],
        workspace["Y_BBOX"][0], workspace["Y_BBOX"][1],
        workspace["Z_BBOX"][0], workspace["Z_BBOX"][1],
        workspace["TABLE_HEIGHT"]], np.float32)
    means = np.empty((max(n, 1), 3), np.float32)
    first = np.empty(max(n, 1), np.int64)
    keep = np.empty(max(n, 1), np.uint8)
    m = get_lib().crop_voxelize_trace(
        _ptr(xyz, ctypes.c_float), n, ctypes.c_float(voxel_size),
        _ptr(bbox, ctypes.c_float), int(bool(rm_table)),
        _ptr(means, ctypes.c_float), _ptr(first, ctypes.c_longlong),
        _ptr(keep, ctypes.c_ubyte))
    if m < 0:
        raise ValueError("crop_voxelize_trace: the cropped cloud spans more "
                         "than 2^21 voxels on an axis")
    return means[:m].copy(), first[:m].copy(), keep[:n].astype(bool)


def neighbor_map_dense_native(grid, counts, offs, extent):
    """Stencil neighbour map. grid (B, N, 3) int32 in [0, extent); counts
    (B,) int32; offs (K, 3) int32. Returns (B, N, K) int16, -1 where no
    point sits at the tap (rows >= count all -1; the lowest index wins a
    duplicated cell). Raises ValueError when extent^3 exceeds 4M cells, N
    does not fit int16, a count is outside [0, N] or a grid coordinate
    outside the extent."""
    grid = np.ascontiguousarray(grid, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    offs = np.ascontiguousarray(offs, np.int32)
    B, N, _ = grid.shape
    K = offs.shape[0]
    out = np.empty((B, N, K), np.int16)
    rc = get_lib().neighbor_map_dense(
        _ptr(grid, ctypes.c_int32), _ptr(counts, ctypes.c_int32), B, N,
        _ptr(offs, ctypes.c_int32), K, int(extent),
        _ptr(out, ctypes.c_int16))
    if rc < 0:
        raise ValueError(
            f"neighbor_map_dense: extent {extent} (at most 161: 4M cells), "
            f"N = {N} (at most 32767), counts in [0, N] and every grid "
            "coordinate inside the extent are its contract")
    return out
