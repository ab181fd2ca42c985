"""Writing the per-video extraction result.

Port of ``save_video_npz`` of ``video_gen_evals_tpu/utils/io.py``: the npz the
scoring path's loader (``data/features.py``) reads back.
"""

from __future__ import annotations

import json
import os
import typing as T

import numpy as np


def save_video_npz(
    out_root: str,
    video_id: str,
    pose: np.ndarray,
    betas: np.ndarray,
    global_orient: np.ndarray,
    vit: np.ndarray,
    frame_idx: np.ndarray,
    meta: T.Optional[dict] = None,
) -> str:
    """Write ``<out_root>/<video_id>.npz`` (float32 arrays, int32 frame
    indices, ``meta`` as a JSON string) and return its path. The file is
    written under a temporary name and renamed, so a reader of the output
    tree never sees a torn npz."""
    out_dir = os.path.join(out_root, os.path.dirname(video_id))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_root, f"{video_id}.npz")
    tmp = f"{out_path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(
        tmp,
        pose=pose.astype(np.float32),
        betas=betas.astype(np.float32),
        global_orient=global_orient.astype(np.float32),
        vit=vit.astype(np.float32),
        frame_idx=np.asarray(frame_idx, np.int32),
        meta=json.dumps(meta or {}, ensure_ascii=False),
    )
    os.replace(tmp, out_path)
    return out_path
