"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one library.

``nvcc`` compiles the sources for ``sm_90a``, one process per source and all
at once, and links the objects into a shared library with a plain C
interface, which ``ctypes`` loads. The build runs at first use,
inside the first call that launches a kernel, never at import. The library
goes to ``video_gen_evals_tpu_torch/_build/`` under a name made from a hash
of the sources and flags: an edited source builds anew, an unchanged one
loads what is there. Each process builds into a temporary name and renames,
so processes that build at once never load a half-written file.

:func:`load_library` takes a subset of the sources for a script that times
one kernel source alone: the first call in a process decides what is built.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into a ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
import typing as T

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("window_gather.cu", "temporal_block.cu", "temporal_chain.cu", "temporal_block_train.cu",
           "attention.cu", "roi_align.cu")
HEADERS = ("conv_tile.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # device, bank, n_rows, d, offsets, row_limit, n_videos, z0, one_pass_raw,
    # d_diff, video_idx, starts, batch, clip_len, out, stream
    "vge_gather_windows": [_I, _P, ctypes.c_longlong, _I, _P, _P, _I, _P, _I,
                           _I, _P, _P, _I, _I, _P, _P],
    # device, bank, n_rows, d, out_dim, offsets, row_limit, n_videos, z0,
    # one_pass_raw, d_diff, video_idx, starts, batch, clip_len, out, stream
    "vge_gather_windows_subblock": [_I, _P, ctypes.c_longlong, _I, _I, _P, _P, _I, _P, _I,
                                    _I, _P, _P, _I, _I, _P, _P],
    # device, x, w1, w2, gn_scale, gn_bias, out, batch, t_len, channels,
    # dilation, windows_per_block, smem_bytes, stream ("highest")
    "vge_temporal_block": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # device, x, w (bf16 planes of every chain), gn_scales, gn_biases, out,
    # chains (1 for K3, S for K9), batch, t_len, channels, dilation,
    # windows_per_block, smem_bytes, stream ("high")
    "vge_temporal_block_high": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # device, x, w (bf16 planes of every stage), gn_scales, gn_biases, out,
    # batch, t_len, channels, n_stages, dilations (host int array),
    # windows_per_block, smem_bytes, stream
    "vge_temporal_chain": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           ctypes.POINTER(ctypes.c_int), _I, _I, _P],
    # device, x, w1, w2, gn_scale, gn_bias, mask (or null), out, batch, t_len,
    # channels, dilation, windows_per_block, smem_bytes, stream ("highest")
    "vge_temporal_block_train_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_P],
    # device, x, w (bf16 planes), gn_scale, gn_bias, mask (or null), out,
    # batch, t_len, channels, dilation, windows_per_block, smem_bytes, stream
    # ("default")
    "vge_temporal_block_train_fwd_tc": [_I] + [_P] * 6 + [_I] * 6 + [_P],
    # device, x, w1, w2, w1t, w2t, gn_scale, dy, mask (or null), dx, d1, dr,
    # dh1, pgamma, pbeta, partial, dw1, dw2, dgamma, dbeta, batch, t_len,
    # channels, dilation, windows_per_block, smem_bytes, splits,
    # grad_smem_bytes, stream ("highest")
    "vge_temporal_block_train_bwd": [_I] + [_P] * 19 + [_I] * 8 + [_P],
    # device, x, w (bf16 planes), gn_scale, dy, mask (or null), dx, xb, d1, dr,
    # dh1, dr32, pgamma, pbeta, partial, dw1, dw2, dgamma, dbeta, batch, t_len,
    # channels, dilation, windows_per_block, smem_bytes, slabs, splits,
    # grad_smem_bytes, stream ("default")
    "vge_temporal_block_train_bwd_tc": [_I] + [_P] * 18 + [_I] * 9 + [_P],
    # device, q, k, v, out, (batch, row) strides of q, k, v in elements, batch,
    # n, heads, head width, scale, bf16_io, precision (0 highest, 1 default,
    # 2 high), stream; K6 and K7
    "vge_mha_core": [_I, _P, _P, _P, _P] + [_L] * 6 + [_I, _I, _I, _I, _F, _I, _I, _P],
    # device, q, k, v, out, (batch, row, head) strides of q, k, v, batch, n,
    # heads, head width, scale, bf16_io, precision, block_kv, stream
    "vge_flash_attention": [_I, _P, _P, _P, _P] + [_L] * 9 + [_I, _I, _I, _I, _F, _I, _I, _I, _P],
    # device, buffer, buf_h, buf_w, channels, boxes, levels, level_info,
    # strides, n_levels, n_rois, rois_per_image, window, window_x,
    # max_samples, out, stream; the buffer float32, or bfloat16 in the _bf16 entry
    "vge_roi_align": [_I, _P, _I, _I, _I, _P, _P, _P, _P] + [_I] * 6 + [_P, _P],
    "vge_roi_align_bf16": [_I, _P, _I, _I, _I, _P, _P, _P, _P] + [_I] * 6 + [_P, _P],
}
# entry points that return a size in bytes, not a CUDA error code
_SIZE_QUERIES = {
    "vge_mha_smem_bytes": [_I, _I],        # n, head width
    "vge_flash_smem_bytes": [_I, _I],      # block_kv, head width
    "vge_attention_max_smem": [],
    "vge_flash_streams": [_I, _I, _I],     # n, head width, block_kv: 1 where K8's FMA path streams
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library, where it came from, and what building it cost."""

    lib: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when an existing build was loaded
    build_log: str         # nvcc / ptxas output (registers, shared memory)


_lock = threading.Lock()
_loaded: T.Optional[KernelLibrary] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "video_gen_evals_tpu_torch are built from csrc/ at first use"
    )


def _build(sources: T.Tuple[str, ...]) -> KernelLibrary:
    nvcc = _nvcc()
    srcs = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256()
    for s in srcs + [os.path.join(CSRC_DIR, s) for s in HEADERS]:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libvge_kernels_{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
        t0 = time.perf_counter()
        try:
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(srcs, objs)
            ]
            outs = [proc.communicate()[0] for proc in procs]
            log = "".join(outs)
            failed = [s for s, proc in zip(sources, procs) if proc.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                                   f"{link.stdout}{link.stderr}")
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for table, restype in ((_SIGNATURES, ctypes.c_int), (_SIZE_QUERIES, ctypes.c_longlong)):
        for name, argtypes in table.items():
            if sources != SOURCES and not hasattr(lib, name):
                continue   # an entry point of a source left out
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    lib.vge_error_string.argtypes = [ctypes.c_int]
    lib.vge_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, seconds, log)


def load_library(sources: T.Optional[T.Sequence[str]] = None) -> KernelLibrary:
    """The kernel library, built on the first call in this process: from
    ``sources`` (names under ``csrc/``; ``window_gather.cu``, which holds the
    error strings, is always added) or from all of :data:`SOURCES`. Later
    calls return that library whatever they pass."""
    global _loaded
    with _lock:
        if _loaded is None:
            chosen = SOURCES if sources is None else tuple(dict.fromkeys(("window_gather.cu", *sources)))
            _loaded = _build(chosen)
        return _loaded


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load_library().lib.vge_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
