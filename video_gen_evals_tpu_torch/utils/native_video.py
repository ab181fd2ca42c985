"""ctypes binding for the native video decoder (``native/video_decoder.cc``).

A copy of ``video_gen_evals_tpu/utils/native_video.py`` (ctypes and numpy
only): libavformat/libavcodec demux and decode to packed RGB frame stacks in
C++, with a pthread pool for several videos at once. The reference decodes
frame by frame in Python loops (ref ``extract_mesh.py:47-101``); the
extraction pipeline decodes on host threads ahead of the device instead.
``load_library`` returns None where ``native/libvge_video.so`` has not been
built (``make -C native``) or its libav libraries do not load; the callers
then fall back to OpenCV.
"""

from __future__ import annotations

import ctypes
import os
import typing as T

import numpy as np

_LIB: T.Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libvge_video.so",
    )


def load_library() -> T.Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.vd_load.restype = ctypes.c_void_p
    lib.vd_load.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.vd_shape.restype = ctypes.c_int
    lib.vd_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.vd_error.restype = ctypes.c_char_p
    lib.vd_error.argtypes = [ctypes.c_void_p]
    lib.vd_copy.restype = ctypes.c_int
    lib.vd_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vd_free.restype = None
    lib.vd_free.argtypes = [ctypes.c_void_p]
    lib.vd_probe.restype = ctypes.c_int
    lib.vd_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.vd_load_many.restype = ctypes.c_int
    lib.vd_load_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    return load_library() is not None


def _stack_from_handle(lib: ctypes.CDLL, h: int, path: str) -> np.ndarray:
    shape = (ctypes.c_int64 * 3)()
    rc = lib.vd_shape(h, shape)
    if rc != 0:
        err = lib.vd_error(h).decode()
        raise IOError(f"native decode failed for {path}: {err or f'rc={rc}'}")
    t, hgt, wid = int(shape[0]), int(shape[1]), int(shape[2])
    frames = np.empty((t, hgt, wid, 3), np.uint8)
    if lib.vd_copy(h, frames.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise IOError(f"native frame copy failed for {path}")
    return frames


def decode_video(path: str, max_frames: int = 0) -> np.ndarray:
    """Decode every frame of ``path`` to a ``[T, H, W, 3]`` uint8 RGB stack."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(
            "native video decoder not built (make -C native) — use "
            "utils.io.load_all_frames for the OpenCV fallback"
        )
    h = lib.vd_load(path.encode(), max_frames)
    if not h:
        raise IOError(f"native decoder could not open {path}")
    try:
        return _stack_from_handle(lib, h, path)
    finally:
        lib.vd_free(h)


def decode_videos(
    paths: T.Sequence[str], n_threads: int = 4, max_frames: int = 0
) -> T.List[T.Optional[np.ndarray]]:
    """Decode many videos concurrently with the native thread pool.

    Returns one ``[T, H, W, 3]`` uint8 stack per path (``None`` for files
    that failed to decode — per-video fault isolation, matching the
    reference's per-video try/except at ref ``extract_mesh.py:232-236``).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native video decoder not built (make -C native)")
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    handles = (ctypes.c_void_p * n)()
    lib.vd_load_many(c_paths, n, max_frames, handles, n_threads)
    results: T.List[T.Optional[np.ndarray]] = []
    for i in range(n):
        h = handles[i]
        if not h:
            results.append(None)
            continue
        try:
            results.append(_stack_from_handle(lib, h, paths[i]))
        except IOError:
            results.append(None)
        finally:
            lib.vd_free(h)
    return results


def probe_video(path: str) -> T.Tuple[int, int, int]:
    """Container-level ``(nb_frames_estimate, H, W)`` without decoding
    (-1 frames when the container doesn't store a count)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native video decoder not built (make -C native)")
    out = (ctypes.c_int64 * 3)()
    rc = lib.vd_probe(path.encode(), out)
    if rc != 0:
        raise IOError(f"could not probe {path} (rc={rc})")
    return int(out[0]), int(out[1]), int(out[2])
