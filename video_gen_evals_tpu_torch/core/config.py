"""Typed configuration of the port: the scoring path's switch for the
reference's accidental behaviors, and the training configuration tree.

The port's own copies of ``video_gen_evals_tpu/core/config.py``'s ``BugCompat``
(the fields the scoring path reads), ``PathsConfig`` and ``TrainConfig``, kept
here so the port loads nothing of the JAX package. A ``TrainConfig`` JSON
written by either package loads in the other's training CLI: the two have
the same fields.
"""

from __future__ import annotations

import dataclasses
import json
import typing as T

from ..utils.names import ACTION_CLASSES


@dataclasses.dataclass(frozen=True)
class BugCompat:
    """- ``layout_auto``: infer the generated-vs-real side-modality directory
      layout from the keypoint dir *name* (``SAVE_GEN``/``SAVE_NEW``/
      ``generated_kps``), as the reference does (ref
      ``utils.py:411-414,429-432,443-446``).
    - ``permissive_ckpt``: load checkpoints with ``strict=False``, tolerating
      missing and extra keys, as the reference does (ref ``eval.py:136-165``).

    CLI: ``--bug-compat`` (default) / ``--no-bug-compat``."""

    layout_auto: bool = True
    permissive_ckpt: bool = True

    @classmethod
    def enabled(cls) -> "BugCompat":
        return cls()

    @classmethod
    def disabled(cls) -> "BugCompat":
        return cls(layout_auto=False, permissive_ckpt=False)


@dataclasses.dataclass
class PathsConfig:
    real_meshes_dir: str = "meshes_10classes"
    generated_meshes_dir: str = "generated_meshes"
    human_scores: str = "TAG_final_human_scores.json"
    real_kp_dir: T.Optional[str] = "SAVE_REAL_ONLY_10_minus1"
    gen_kp_dir: T.Optional[str] = "generated_kps"
    real_clip_dir: T.Optional[str] = None
    real_dino_dir: T.Optional[str] = None
    gen_clip_dir: T.Optional[str] = None
    gen_dino_dir: T.Optional[str] = None


CONV_IMPLS = ("auto", "module", "kernel")


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters of ``Exp_TCL_Hard_V2Plus`` (ref ``train.py:471-480``),
    and the JAX package's run settings."""

    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)
    seed: int = 1337
    epochs: int = 30
    clip_len: int = 32
    stride: int = 8
    P: int = 10                      # classes per batch
    K: int = 24                      # windows per class
    lr: float = 3e-4
    eta_min: float = 1e-6            # cosine floor (ref train.py:184-186)
    latent_dim: int = 128            # accepted, unused (reference quirk)
    d_model: int = 256
    time_layers: int = 4
    time_heads: int = 8
    dropout: float = 0.1
    hard_negative_weight: float = 10.0
    filter_classes: T.Optional[T.List[str]] = dataclasses.field(
        default_factory=lambda: list(ACTION_CLASSES)
    )
    save_dir: str = "SAVE"
    name: str = "HumanActionScorer"
    # raise on the first non-finite loss instead of skipping the batch
    debug_nans: bool = False
    # write the per-epoch checkpoints on a worker thread, so the copy to the
    # host and the file write overlap the next epoch's steps (Experiment.run's
    # own saves only, at one rank; direct save_resume_checkpoint calls stay
    # blocking)
    async_checkpoint: bool = True
    # data-parallel ranks of the train CLI (None or 1: one device); the
    # CLI's --dp wins
    num_dp_devices: T.Optional[int] = None
    # directory of the cached stats and train/test feature banks (skips the
    # stats and normalize/delta passes when the video set is unchanged)
    bank_cache_dir: T.Optional[str] = None
    # the training conv stages (CONV_IMPLS): "auto" and "kernel" run K4 (its
    # plain version on the CPU), "module" K4's plain version under autograd
    # on any device
    conv_impl: str = "auto"

    @property
    def batch_size(self) -> int:
        return self.P * self.K

    def detect_modalities(self) -> T.List[str]:
        """Modalities = base four + whatever side dirs are configured
        (ref ``train.py:225-236``)."""
        mods = ["vit", "global", "pose", "beta"]
        if self.paths.real_kp_dir is not None:
            mods.append("kp2d")
        if self.paths.real_clip_dir is not None:
            mods.append("clip")
        if self.paths.real_dino_dir is not None:
            mods.append("dino")
        return mods

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            d = json.load(f)
        d["paths"] = PathsConfig(**d.get("paths", {}))
        return cls(**d)
