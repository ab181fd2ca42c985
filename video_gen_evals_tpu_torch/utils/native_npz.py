"""ctypes binding for the native npz reader (``native/npz_reader.cc``).

Port of ``video_gen_evals_tpu/utils/native_npz.py``: mmap + zlib inflate in
C++ straight into numpy buffers, and a thread pool that opens many files at
once, for the feature-bank builder, the stats pass and manifest scans.

The library is built at first use, never at import: ``g++ -O3 -fPIC
-std=c++17 -shared -lz -lpthread`` into the git-ignored
``video_gen_evals_tpu_torch/_build/`` under a name made from a hash of the
source and flags (an edited source builds anew), each process building into
a temporary name and renaming, as ``ops/cuda_lib.py`` does for the kernels.
The JAX package's own ``make -C native`` output is never loaded.

Where the library cannot be built because the compiler or ``zlib.h`` is
missing, the reader falls back to ``numpy.load``, which gives the same
arrays, and says why once on stderr; :func:`reader` names the route taken.
Any other build error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import typing as T
import zipfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "npz_reader.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_DTYPES = {
    0: np.float32, 1: np.float64, 2: np.float16, 3: np.int32, 4: np.int64, 5: np.int16,
    6: np.int8, 7: np.uint32, 8: np.uint64, 9: np.uint16, 10: np.uint8, 11: np.bool_,
}

_lock = threading.Lock()
_LIB: T.Optional[ctypes.CDLL] = None
_TRIED = False
_FALLBACK_REASON: T.Optional[str] = None


def _compiler() -> T.Optional[str]:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def _build() -> T.Optional[str]:
    """The built library's path, or None (with the reason recorded) where
    the compiler or zlib.h is missing."""
    global _FALLBACK_REASON
    with open(SOURCE, "rb") as f:
        src = f.read()
    cxx = _compiler()
    if cxx is None:
        _FALLBACK_REASON = "no C++ compiler (g++ or c++) on PATH"
        return None
    h = hashlib.sha256(src)
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libvge_npz_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        log = proc.stdout + proc.stderr
        if "zlib.h" in log and ("No such file" in log or "not found" in log):
            _FALLBACK_REASON = "zlib.h not found by the C++ compiler"
            return None
        raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path


def load_library() -> T.Optional[ctypes.CDLL]:
    """The reader library, built on the first call in this process; None when
    the numpy fallback is in use."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            print(f"native_npz: reading npz files with numpy ({_FALLBACK_REASON})", file=sys.stderr)
            return None
        lib = ctypes.CDLL(path)
        lib.npz_open.restype = ctypes.c_void_p
        lib.npz_open.argtypes = [ctypes.c_char_p]
        lib.npz_num_arrays.restype = ctypes.c_int
        lib.npz_num_arrays.argtypes = [ctypes.c_void_p]
        lib.npz_get_info.restype = ctypes.c_int
        lib.npz_get_info.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_char_p, ctypes.c_int]
        lib.npz_read.restype = ctypes.c_int
        lib.npz_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.npz_close.restype = None
        lib.npz_close.argtypes = [ctypes.c_void_p]
        lib.npz_open_many.restype = ctypes.c_int
        lib.npz_open_many.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        _LIB = lib
        return lib


def reader() -> str:
    """``"native"`` or ``"numpy"``: the route this process reads npz files by."""
    return "native" if load_library() is not None else "numpy"


def _members(lib, handle):
    """``(index, name, dtype, shape)`` of every member the reader supports
    (string and pickled members are skipped)."""
    for i in range(lib.npz_num_arrays(handle)):
        info = (ctypes.c_int64 * 10)()
        name = ctypes.create_string_buffer(256)
        if lib.npz_get_info(handle, i, info, name, 256) != 0:
            continue
        yield i, name.value.decode(), _DTYPES[int(info[0])], tuple(int(info[2 + d]) for d in range(int(info[1])))


def _read_all(lib, handle, path: str, strict: bool) -> T.Dict[str, np.ndarray]:
    out: T.Dict[str, np.ndarray] = {}
    for i, name, dtype, shape in _members(lib, handle):
        arr = np.empty(shape, dtype)
        rc = lib.npz_read(handle, i, arr.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            out[name] = arr
        elif strict:
            raise IOError(f"native npz read failed for {path}:{name!r} rc={rc}")
    return out


def load_npz(path: str) -> T.Dict[str, np.ndarray]:
    """Every numeric array of an npz file (string members only through the
    numpy fallback)."""
    lib = load_library()
    if lib is None:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files if z[k].dtype != object}
    handle = lib.npz_open(path.encode())
    if not handle:
        raise IOError(f"native npz reader could not open {path}")
    try:
        return _read_all(lib, handle, path, strict=True)
    finally:
        lib.npz_close(handle)


def npz_shapes(path: str) -> T.Dict[str, T.Tuple[int, ...]]:
    """Name -> shape of every member from the npy headers alone: no payload
    is decompressed, so scanning a dataset stays cheap."""
    lib = load_library()
    if lib is None:
        out: T.Dict[str, T.Tuple[int, ...]] = {}
        with zipfile.ZipFile(path) as zf:
            for nm in zf.namelist():
                if not nm.endswith(".npy"):
                    continue
                with zf.open(nm) as f:
                    version = np.lib.format.read_magic(f)
                    if version == (1, 0):
                        shape, _c, _dt = np.lib.format.read_array_header_1_0(f)
                    else:
                        shape, _c, _dt = np.lib.format.read_array_header_2_0(f)
                    out[nm[:-4]] = tuple(int(d) for d in shape)
        return out
    handle = lib.npz_open(path.encode())
    if not handle:
        raise IOError(f"native npz reader could not open {path}")
    try:
        return {name: shape for _i, name, _dt, shape in _members(lib, handle)}
    finally:
        lib.npz_close(handle)


def load_npz_many(paths: T.Sequence[str], n_threads: int = 4) -> T.List[T.Optional[T.Dict[str, np.ndarray]]]:
    """Many npz files, opened by the native thread pool; None for a file that
    could not be opened."""
    lib = load_library()
    if lib is None:
        return [load_npz(p) for p in paths]
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    handles = (ctypes.c_void_p * n)()
    lib.npz_open_many(c_paths, n, handles, n_threads)
    results: T.List[T.Optional[T.Dict[str, np.ndarray]]] = []
    for path, handle in zip(paths, handles):
        if not handle:
            results.append(None)
            continue
        try:
            results.append(_read_all(lib, handle, path, strict=False))
        finally:
            lib.npz_close(handle)
    return results
