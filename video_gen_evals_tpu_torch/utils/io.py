"""Host-side IO of the extraction: the per-video npz, video decoding and the
resumable ledgers.

Port of ``video_gen_evals_tpu/utils/io.py``: :func:`save_video_npz` writes the
npz the scoring path's loader (``data/features.py``) reads back (ref
``extract_mesh.py:25-44``); :func:`load_all_frames` decodes a video on the
host (a ``.npy`` frame stack, the native libav decoder of ``native/`` where
it is built and its libraries load, else OpenCV where it is installed);
:class:`ResumableLedger` keeps the per-action single / not-single / error
records that make an extraction run resumable (ref
``extract_mesh.py:121-194``). Every file is published by an atomic rename.
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


def load_all_frames(video_path: str, bgr2rgb: bool = True) -> np.ndarray:
    """Every frame of a video, ``[T, H, W, 3]`` uint8, decoded on the host.

    A ``.npy`` path is a decoded ``[T, H, W, 3]`` frame stack. Otherwise the
    native decoder (``make -C native``; RGB) is tried first, then OpenCV;
    without either this raises ``RuntimeError``."""
    if video_path.lower().endswith(".npy"):
        frames = np.load(video_path)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise RuntimeError(f"Frame stack {video_path} must be [T, H, W, 3], got {frames.shape}")
        return frames.astype(np.uint8)
    from .native_video import decode_video, native_available

    if native_available():
        try:
            frames = decode_video(video_path)
            return frames if bgr2rgb else frames[..., ::-1]
        except IOError:
            pass   # a container the native decoder cannot open: OpenCV may
    try:
        import cv2  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "OpenCV is not available in this environment; pass pre-decoded "
            "frame arrays to the extraction pipeline instead."
        ) from e
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"Could not open video: {video_path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if bgr2rgb else frame)
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"No frames decoded from {video_path}")
    return np.stack(frames)


class ResumableLedger:
    """Per-action JSON ledgers ``<base_dir>/{single,not_single,errors}/<action>.json``
    with skip-if-processed semantics (ref ``extract_mesh.py:121-194``): single
    and not-single videos count as processed, errors do not."""

    def __init__(self, base_dir: str, action: str):
        self.paths = {kind: os.path.join(base_dir, kind, f"{action}.json")
                      for kind in ("single", "not_single", "errors")}
        for p in self.paths.values():
            os.makedirs(os.path.dirname(p), exist_ok=True)
        self.singles: T.List[str] = self._load(self.paths["single"], [])
        self.nots: T.List[str] = self._load(self.paths["not_single"], [])
        self.errors: T.Dict[str, str] = self._load(self.paths["errors"], {})

    @staticmethod
    def _load(path: str, default):
        if not os.path.exists(path):
            return default
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return default   # an unreadable ledger: its videos run again

    def processed(self) -> T.Set[str]:
        return set(self.singles) | set(self.nots)

    def record(self, video: str, kind: str, error: T.Optional[str] = None) -> None:
        if kind == "single":
            self.singles.append(video)
            self._save(self.paths["single"], self.singles)
        elif kind == "not_single":
            self.nots.append(video)
            self._save(self.paths["not_single"], self.nots)
        else:
            self.errors[video] = error or "unknown"
            self._save(self.paths["errors"], self.errors)

    @staticmethod
    def _save(path: str, data) -> None:
        # a torn ledger would read as empty and re-run the whole action
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=4)
        os.replace(tmp, path)
