"""ctypes loader of the port's native lattice mesher (``tetmesh.cpp``; port
of ``pies_tpu/native/load.py``).

At first use :func:`try_load` compiles ``tetmesh.cpp`` with ``g++`` into
``pies_tpu_torch/_build/`` (git-ignored; the file name carries a hash of the
source and flags, so an edited source is rebuilt) and loads it.  Nothing is
built at import time, and nothing is written inside the JAX package.  Where
no ``g++`` exists, :func:`try_load` returns None and ``scene.tetmesh`` takes
its NumPy route, which gives equal arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "tetmesh.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")  # pies_tpu/native/build.sh's

_cached = None
_checked = False


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        lib.pies_tetrahedralize.restype = ctypes.c_int
        lib.pies_tetrahedralize.argtypes = [
            fp, ctypes.c_int,  # vertices, num_vertices
            ip, ctypes.c_int,  # tris, num_tris
            ctypes.c_int,  # resolution
            ctypes.POINTER(fp), ip,  # out points, num_points
            ctypes.POINTER(ip), ip,  # out tets, num_tets
            ctypes.POINTER(ip), ip,  # out surface, num_surface
        ]
        lib.pies_free.restype = None
        lib.pies_free.argtypes = [ctypes.c_void_p]

    def tetrahedralize(self, vertices: np.ndarray, tris: np.ndarray, resolution: int):
        vertices = np.ascontiguousarray(vertices, np.float32)
        tris = np.ascontiguousarray(tris, np.int32)
        out_pts = ctypes.POINTER(ctypes.c_float)()
        out_tets = ctypes.POINTER(ctypes.c_int)()
        out_surf = ctypes.POINTER(ctypes.c_int)()
        n_pts, n_tets, n_surf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.pies_tetrahedralize(
            vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vertices.shape[0],
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), tris.shape[0], resolution,
            ctypes.byref(out_pts), ctypes.byref(n_pts), ctypes.byref(out_tets),
            ctypes.byref(n_tets), ctypes.byref(out_surf), ctypes.byref(n_surf),
        )
        if rc != 0:
            raise ValueError(f"pies_tetrahedralize failed (code {rc})")
        try:
            points = np.ctypeslib.as_array(out_pts, (n_pts.value, 3)).copy()
            tets = np.ctypeslib.as_array(out_tets, (n_tets.value, 4)).copy()
            surface = np.ctypeslib.as_array(out_surf, (n_surf.value, 3)).copy()
        finally:
            self._lib.pies_free(out_pts)
            self._lib.pies_free(out_tets)
            self._lib.pies_free(out_surf)
        return points, tets, surface


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return _BUILD / f"libpies_tetmesh_{digest.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile the mesher unless it is built already; None without ``g++``
    or when the compile fails.  The library appears under its final name
    only once complete, so concurrent builds do not see half a file."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def try_load() -> _Native | None:
    """The native mesher, built on first use; None (the NumPy route) where
    it cannot be built or loaded."""
    global _cached, _checked
    if _checked:
        return _cached
    _checked = True
    path = build()
    if path is not None:
        try:
            _cached = _Native(ctypes.CDLL(str(path)))
        except OSError:
            _cached = None
    return _cached
