"""Dataset manifests: scan mesh-npz trees into VideoItem records.

Copy of ``video_gen_evals_tpu/data/manifest.py``: that package's
``data/__init__`` imports jax, which the port never loads. Keep the two in
step until the JAX package's ``__init__`` imports are made lazy.

Capability parity with the reference data discovery (C13-C14 in SURVEY.md):
- :func:`scan_class_tree`     <- ``NpzVideoDataset._scan`` (ref ``utils.py:229-324``):
  per-class directories of ``.npz`` files, optional per-class whitelist JSONs,
  optional class filter, corrupt files skipped.
- :func:`scan_generated_flat` <- ``create_dataset_from_generated_meshes``
  (ref ``eval.py:48-101``): flat directory, class inferred from filename.
- :func:`train_test_split`    <- ref ``utils.py:326-341``: per-class shuffle
  with ``random.Random(seed)`` (bitwise-identical split membership), both
  sides guaranteed non-empty.

The manifest is plain host-side metadata (JSON-serializable); all array work
happens downstream in the feature bank.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import random
import typing as T

from ..utils.names import infer_class_from_generated_stem
from ..utils.native_npz import npz_shapes


@dataclasses.dataclass
class VideoItem:
    cls: str
    name: str    # file name including .npz
    path: str
    length: int  # number of mesh frames (T)
    vit_dim: int


@dataclasses.dataclass
class VideoManifest:
    """A set of videos grouped by class."""

    items: T.List[VideoItem]

    @property
    def class_to_items(self) -> T.Dict[str, T.List[VideoItem]]:
        out: T.Dict[str, T.List[VideoItem]] = {}
        for it in self.items:
            out.setdefault(it.cls, []).append(it)
        return out

    @property
    def classes(self) -> T.List[str]:
        return sorted({it.cls for it in self.items})

    def label_dict(self) -> T.Dict[str, int]:
        return {cls: i for i, cls in enumerate(self.classes)}

    def __len__(self) -> int:
        return len(self.items)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump([dataclasses.asdict(it) for it in self.items], f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "VideoManifest":
        with open(path) as f:
            return cls([VideoItem(**d) for d in json.load(f)])


def _load_whitelist(wdir: str) -> T.Dict[str, T.Set[str]]:
    """Per-class whitelist JSONs: ``<cls>.json`` lists of video names; stems
    accepted with or without extension (ref ``utils.py:256-266``)."""
    if not os.path.isdir(wdir):
        return {}
    stem = lambda n: os.path.splitext(os.path.basename(n))[0]
    return {
        stem(path): {stem(v) for v in json.load(open(path))}
        for path in sorted(glob.glob(os.path.join(wdir, "*.json")))
    }


def _probe_npz(path: str) -> T.Optional[T.Tuple[int, int]]:
    """Return (mesh length, vit dim) or None if unreadable — header-only
    (``npz_shapes``): scanning must not decompress whole datasets just to
    read two shapes."""
    try:
        shapes = npz_shapes(path)
        return shapes["pose"][0], shapes["vit"][1]
    except Exception:
        return None


def scan_class_tree(
    root_dir: str,
    filter_classes: T.Optional[T.List[str]] = None,
    whitelist_json_dir: T.Optional[str] = None,
) -> VideoManifest:
    """Scan ``root_dir/<class>/*.npz`` into a manifest. Corrupt npz files are
    skipped (ref ``utils.py:292-294``)."""
    whitelist = _load_whitelist(whitelist_json_dir) if whitelist_json_dir else {}
    allowed = set(filter_classes) if filter_classes is not None else None
    items: T.List[VideoItem] = []
    classes = sorted(
        d
        for d in os.listdir(root_dir)
        if os.path.isdir(os.path.join(root_dir, d))
    )
    for cls in classes:
        if allowed is not None and cls not in allowed:
            continue
        cls_dir = os.path.join(root_dir, cls)
        for f in sorted(os.listdir(cls_dir)):
            if not f.endswith(".npz"):
                continue
            stem = os.path.splitext(f)[0]
            if whitelist and stem not in whitelist.get(cls, set()):
                continue
            path = os.path.join(cls_dir, f)
            probe = _probe_npz(path)
            if probe is None:
                continue
            length, vit_dim = probe
            items.append(
                VideoItem(cls=cls, name=f, path=path, length=length, vit_dim=vit_dim)
            )
    return VideoManifest(items)


def scan_generated_flat(generated_dir: str) -> VideoManifest:
    """Scan a directory (recursively, like ref ``train.py:95-102``'s
    ``scan_gen_flat``) of generated-mesh ``*.npz``; class inferred from the
    filename (ref ``eval.py:48-101``)."""
    paths: T.List[str] = []
    for dirpath, _dirs, files in os.walk(generated_dir):
        for f in files:
            if f.endswith(".npz"):
                paths.append(os.path.join(dirpath, f))
    items: T.List[VideoItem] = []
    for path in sorted(paths):
        f = os.path.basename(path)
        stem = os.path.splitext(f)[0]
        try:
            shapes = npz_shapes(path)  # header-only: no payload decompress
            length = shapes["pose"][0] if "pose" in shapes else 0
            vit_shape = shapes.get("vit")
            vit_dim = vit_shape[1] if vit_shape and len(vit_shape) > 1 else 0
        except Exception:
            continue
        if length <= 0:
            # an npz without a usable pose array can never produce a window
            # (enumerate_windows skips length<=0) — admitting it would only
            # crash the eager bank build later (KeyError 'pose'); the lazy
            # reference never reads such items either, so outputs match
            continue
        items.append(
            VideoItem(
                cls=infer_class_from_generated_stem(stem),
                name=f,
                path=path,
                length=length,
                vit_dim=vit_dim,
            )
        )
    return VideoManifest(items)


def train_test_split(
    manifest: VideoManifest, train_ratio: float = 0.8, seed: int = 1337
) -> T.Tuple[VideoManifest, VideoManifest]:
    """Per-class shuffled split with both sides non-empty; split membership is
    bitwise-identical to the reference for the same seed (``random.Random``,
    ref ``utils.py:326-341``)."""
    rng = random.Random(seed)
    train_items: T.List[VideoItem] = []
    test_items: T.List[VideoItem] = []
    for _cls, vids in manifest.class_to_items.items():
        vids_copy = vids[:]
        rng.shuffle(vids_copy)
        n = len(vids_copy)
        n_train = max(1, min(n - 1, int(round(n * train_ratio))))
        train_items.extend(vids_copy[:n_train])
        test_items.extend(vids_copy[n_train:])
    if not test_items:
        # single-video classes contribute nothing to the test side (the
        # reference's own rule); all-singleton datasets would otherwise
        # crash much later inside bank construction with an opaque
        # concatenate error
        raise ValueError(
            "train_test_split produced an empty test side: every class has "
            "a single video (each goes to train). Provide >= 2 videos for "
            "at least one class."
        )
    return VideoManifest(train_items), VideoManifest(test_items)
