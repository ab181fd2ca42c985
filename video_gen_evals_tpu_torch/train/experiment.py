"""Experiment harness: the ref ``BaseExperiment``/``Exp_TCL_Hard_V2Plus``
training loop, on one device or as one rank of a data-parallel group.

Port of ``video_gen_evals_tpu/train/experiment.py``. Per epoch (ref
``train.py:433-467``):
  1. train over PK-balanced batches (the stacked 4-forward step);
  2. build class centroids from the train windows;
  3. test-set loss with per-component breakdown -> best-checkpoint criterion;
  4. test-set centroid distances (monitoring);
  5. human-correlation monitor on generated videos (monitoring; its failure
     is logged, never fatal);
  6. the resume checkpoint.

Data flow: the train and test feature banks are built on the host (or read
from ``cfg.bank_cache_dir``: ``stats.npz``, ``train_bank.npz``,
``test_bank.npz``, as in JAX ``experiment.py:90-110``; rank 0 writes, the
other ranks read after a barrier) and live on the device; every step gathers its PK batch there with the window-gather
kernel (``ops.window_kernel.gather_windows``). The eval passes run through
the scoring path's ``WindowEncoder`` on the live weights. One model is shared
by the trainer (training mode) and the encoder (eval mode, under
``inference_mode``); each sets the mode it needs before it runs.

Data parallelism (``rank``, a ``parallel.Rank``; JAX ``experiment.py:51-66``,
``:165-215``): every rank draws the same PK stream and the same stacked
batch, the step splits its rows over the ranks (``train/step.py``), the
initial weights are broadcast from rank 0, and the eval passes split their
window batches over the ranks (``WindowEncoder``). Only rank 0 writes
``metrics.jsonl``, the mapping, the config and the checkpoints, and a
barrier follows each epoch's writes; every rank restores a resume file. The
background saver runs only at one rank, as in JAX. The parameters stay
bitwise equal on every rank.

Tensor parallelism (``rank`` on a ``parallel.make_grid`` grid of data x
model ranks; JAX ``experiment.py:165-172``): the model is drawn whole from
the seed and broadcast as above, then each rank keeps its blocks of the
sharded parameters (``HumanActionScorer.shard_``), and the batch splits
over the data axis only. The eval passes and the best checkpoint use the
gathered model, a whole copy refreshed from the shards after each epoch's
training (``eval_model``), on every rank of the grid as the data-parallel
eval does. Checkpoints and resume files hold the gathered tree, moments
included, so they load at any grid, in the score CLI and as the JAX
package's ``.npz`` (``checkpoint.save_jax_npz_params`` of
``model.full_state_dict()``); a run resumes from one by cutting it.

Exact resume: a step's randomness is a function of ``(seed, step)`` and an
epoch's batch stream of ``(seed, epoch)``, so a run of N epochs and a run
resumed from any epoch's checkpoint end with the same bits.
``cfg.conv_impl``: ``"auto"`` and ``"kernel"`` run the conv stages' K4 (its
plain version on the CPU), ``"module"`` K4's plain version under autograd on
any device (the counterpart of JAX's XLA conv), which the run prints and the
saved config records.
Observability: structured JSONL metrics (``metrics.jsonl``), one event per
line, with the JAX package's event names and keys.
"""

from __future__ import annotations

import json
import os
import sys
import time
import typing as T

import numpy as np
import torch

from ..core.config import CONV_IMPLS, TrainConfig
from ..data import (
    ModalityPaths,
    PKBatchSampler,
    build_feature_bank,
    enumerate_windows,
    scan_class_tree,
    scan_generated_flat,
    train_test_split,
)
from ..metrics.correlation import correlate_with_class_fallback
from ..metrics.scores import finalize_centroids, finalize_video_scores
from ..models import EncoderConfig, HumanActionScorer
from ..ops.window_kernel import gather_windows
from ..parallel import Rank, barrier, broadcast_, broadcast_object
from ..data.features import build_feature_bank_cached
from ..data.stats import compute_stats_cached
from ..pipelines.score import WindowEncoder, on_ranks
from ..utils.device import resolve_device
from ..utils.names import infer_class_from_name
from .checkpoint import (
    AsyncSaver,
    restore_train_state,
    save_params,
    save_train_state,
    snapshot,
)
from .step import COMPONENTS, TrainStep


class Experiment:
    def __init__(
        self,
        cfg: TrainConfig,
        eval_batch: int = 512,
        device: T.Union[str, torch.device] = "cuda",
        precision: str = "default",
        rank: T.Optional[Rank] = None,
    ):
        """``precision``: the trainable conv-stage kernel's arithmetic,
        "default" (bf16 operands, fp32 sums) or "highest" (fp32). The eval
        passes run the scoring kernel at "high", or "highest" with it.
        ``rank``: this process's rank of a data-parallel group or of a
        (data, model) grid (its device replaces ``device``)."""
        if cfg.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {cfg.conv_impl!r}")
        self.cfg = cfg
        self.eval_batch = eval_batch
        self.rank = rank
        self.world = 1 if rank is None else rank.world
        n_data = 1 if rank is None else rank.data.world
        if n_data > 1 and cfg.batch_size % n_data:
            raise ValueError(
                f"PK batch size {cfg.batch_size} must divide evenly over the "
                f"{n_data} data-parallel ranks"
            )
        self.device = resolve_device(rank.device if rank is not None else device)
        self.writes = rank is None or rank.is_primary   # only rank 0 writes files
        self._ckpt_saver: T.Optional[AsyncSaver] = None

        ts = time.strftime("%Y%m%d_%H%M%S")
        save_dir = os.path.join(cfg.save_dir, f"{cfg.name}_{ts}")
        # the ranks' clocks may straddle a second: rank 0's name holds
        self.save_dir = save_dir if rank is None else broadcast_object(save_dir, rank)
        if self.writes:
            os.makedirs(self.save_dir, exist_ok=True)
        self.metrics_path = os.path.join(self.save_dir, "metrics.jsonl")

        # ---------------- data ----------------
        self.full_ds = scan_class_tree(
            cfg.paths.real_meshes_dir, filter_classes=cfg.filter_classes
        )
        self.train_ds, self.test_ds = train_test_split(self.full_ds, 0.8, cfg.seed)
        self.real_paths = ModalityPaths(
            keypoint_dir=cfg.paths.real_kp_dir,
            clip_dir=cfg.paths.real_clip_dir,
            dino_dir=cfg.paths.real_dino_dir,
            layout="real",
        )
        cache = lambda name: (os.path.join(cfg.bank_cache_dir, name)   # noqa: E731
                              if cfg.bank_cache_dir else None)
        self.stats = on_ranks(rank, lambda write: compute_stats_cached(
            self.train_ds.items, self.real_paths, cache_path=cache("stats.npz"), write=write))
        self.label_dict = self.full_ds.label_dict()
        if self.writes:
            with open(os.path.join(self.save_dir, "label_mapping.json"), "w") as f:
                json.dump(self.label_dict, f, indent=2)
            cfg.to_json(os.path.join(self.save_dir, "config.json"))

        mods = [m for m in cfg.detect_modalities() if m in self.stats.modalities]
        min_rows = cfg.clip_len + 8
        self.train_bank, self.test_bank = (
            on_ranks(rank, lambda write, ds=ds, name=name: build_feature_bank_cached(
                ds.items, self.real_paths, self.stats, mods, min_rows=min_rows,
                cache_path=cache(name), write=write))
            for ds, name in ((self.train_ds, "train_bank.npz"), (self.test_ds, "test_bank.npz")))
        self.train_windows = enumerate_windows(self.train_ds, cfg.clip_len, cfg.stride)
        self.test_windows = enumerate_windows(self.test_ds, cfg.clip_len, cfg.stride)
        self.window_labels = self._window_labels(self.train_bank, self.train_windows)
        steps_per_epoch = max(1, len(self._sampler_for_epoch(0)))

        # ---------------- model / optimizer ----------------
        dims_raw = {m: self.stats.dims_map_raw()[m] for m in mods}
        dims_diff = {m: self.stats.dims_map_diff()[m] for m in mods}
        self.enc_cfg = EncoderConfig.create(
            dims_raw,
            dims_diff,
            d_model=cfg.d_model,
            time_layers=cfg.time_layers,
            time_heads=cfg.time_heads,
            dropout=cfg.dropout,
        )
        self.model = HumanActionScorer(
            self.enc_cfg, generator=torch.Generator().manual_seed(cfg.seed)
        ).to(self.device)
        self.conv_impl = "module" if cfg.conv_impl == "module" else "kernel"
        if rank is not None:
            broadcast_([p.data for p in self.model.parameters()], rank)
        # the model the eval passes and checkpoints use: the trained one, or
        # under tensor parallelism a whole copy of its shards
        self.eval_model = self.model
        if rank is not None and rank.tp > 1:
            self.eval_model = HumanActionScorer(
                self.enc_cfg, generator=torch.Generator().manual_seed(0)).to(self.device)
            self.eval_model.load_state_dict(self.model.state_dict())
            self.model.shard_(rank.model)
        self.model.set_conv_impl(self.conv_impl)
        self.eval_model.set_conv_impl(self.conv_impl)
        eval_precision = "highest" if precision == "highest" else "high"
        self.train_step = TrainStep(
            self.model, cfg.lr, steps_per_epoch * cfg.epochs, eta_min=cfg.eta_min,
            hard_weight=cfg.hard_negative_weight, precision=precision,
            eval_precision=eval_precision, seed=cfg.seed, rank=rank, eval_model=self.eval_model,
        )
        self.encoder = WindowEncoder(
            self.eval_model, eval_batch, cfg.clip_len, eval_precision, self.device, rank=rank)
        self._train_bank_dev = self.encoder.upload(self.train_bank)
        self._test_bank_dev = self.encoder.upload(self.test_bank)
        self.best_eval_loss = float("inf")
        self.best_ckpt: T.Optional[str] = None

    # ------------------------------------------------------------------
    def _window_labels(self, bank, windows) -> np.ndarray:
        return np.array([self.label_dict[bank.classes[vi]] for vi, _ in windows], np.int64)

    def _sampler_for_epoch(self, epoch: int) -> PKBatchSampler:
        """The batch stream is a pure function of (seed, epoch), so a resumed
        run draws the batches the uninterrupted run drew."""
        return PKBatchSampler(
            self.window_labels,
            P=self.cfg.P,
            K=self.cfg.K,
            drop_last=True,
            rng=np.random.default_rng(self.cfg.seed * 100003 + epoch),
        )

    def _gather_batch(self, bank, bank_dev, windows, idxs) -> torch.Tensor:
        vi, st = (
            torch.from_numpy(np.array([windows[i][k] for i in idxs], np.int32)).to(self.device)
            for k in (0, 1)
        )
        return gather_windows(*bank_dev, bank.one_pass_raw, vi, st, self.cfg.clip_len)

    def refresh_eval_model(self) -> None:
        """Under tensor parallelism, the eval model gathered anew from the
        trained shards (a collective over the model axis); else nothing."""
        if self.eval_model is not self.model:
            self.eval_model.load_state_dict(self.model.full_state_dict())

    def _labels(self, labels: np.ndarray, idxs) -> torch.Tensor:
        return torch.from_numpy(labels[idxs]).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, record: T.Dict[str, T.Any]) -> None:
        if not self.writes:
            return
        record = {k: (float(v) if isinstance(v, np.floating) else v) for k, v in record.items()}
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------
    def train_one_epoch(self, epoch: int) -> float:
        total = 0.0
        n_batches = 0
        n_skipped = 0
        self._sync()
        t0 = time.time()
        for batch_idx in self._sampler_for_epoch(epoch):
            feats = self._gather_batch(
                self.train_bank, self._train_bank_dev, self.train_windows, batch_idx)
            metrics = self.train_step(feats, self._labels(self.window_labels, batch_idx))
            # the step skipped the update for a non-finite loss (ref
            # train.py:499-500 `continue`s before accumulating): leave the
            # batch out of the epoch's loss too
            if np.isfinite(metrics["total"]):
                total += metrics["total"]
            else:
                if self.cfg.debug_nans:
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch}, step {self.train_step.step - 1}: "
                        f"{metrics}")
                n_skipped += 1
            n_batches += 1
        self._sync()
        dt = time.time() - t0
        avg = total / max(1, n_batches - n_skipped)
        clips_per_sec = n_batches * self.cfg.batch_size * 4 / max(dt, 1e-9)
        self._log(
            {
                "event": "train_epoch",
                "epoch": epoch,
                "loss": avg,
                "batches": n_batches,
                "skipped": n_skipped,
                "seconds": dt,
                "clips_per_sec": clips_per_sec,
            }
        )
        return avg

    # ------------------------------------------------------------------
    def evaluate_centroids(self) -> np.ndarray:
        seq_sum, _tc_sum, count = self.encoder.encode_bank_segsum(
            self.train_bank, self.train_windows, self.window_labels,
            len(self.label_dict), bank_dev=self._train_bank_dev,
        )
        return finalize_centroids(torch.from_numpy(seq_sum), torch.from_numpy(count)).numpy()

    def evaluate_test_loss(self, epoch: int) -> T.Tuple[float, T.Dict[str, float]]:
        """The training loss over fixed test-window chunks in eval mode, tail
        chunk included; non-finite chunks skipped (ref ``train.py:286-333``)."""
        n = len(self.test_windows)
        B = min(self.eval_batch, n)
        total = 0.0
        comp_sum = dict.fromkeys(COMPONENTS, 0.0)
        n_batches = 0
        test_labels = self._window_labels(self.test_bank, self.test_windows)
        for lo in range(0, n, max(B, 1)):
            idxs = list(range(lo, min(lo + B, n)))
            feats = self._gather_batch(
                self.test_bank, self._test_bank_dev, self.test_windows, idxs)
            comps = self.train_step.eval_loss(feats, self._labels(test_labels, idxs), chunk=lo)
            if not np.isfinite(comps["total"]):
                continue
            total += comps["total"]
            for k in COMPONENTS:
                comp_sum[k] += comps[k]
            n_batches += 1
        if n_batches == 0:
            return float("inf"), {}
        avg = total / n_batches
        comps_avg = {k: v / n_batches for k, v in comp_sum.items()}
        self._log({"event": "eval_loss", "epoch": epoch, "loss": avg, **comps_avg})
        return avg, comps_avg

    def evaluate_centroid_distance(
        self, epoch: int, centroids: np.ndarray
    ) -> T.Tuple[float, T.Dict[str, float]]:
        seqs, _tc, win_video = self.encoder.encode_bank(
            self.test_bank, self.test_windows, bank_dev=self._test_bank_dev
        )
        labels = np.array(
            [self.label_dict[self.test_bank.classes[v]] for v in win_video], np.int64
        )
        d = np.linalg.norm(seqs - centroids[labels], axis=-1)
        avg = float(d.mean()) if len(d) else float("inf")
        per_class = {
            cls: float(d[labels == idx].mean())
            for cls, idx in self.label_dict.items()
            if np.any(labels == idx)
        }
        self._log(
            {
                "event": "centroid_distance",
                "epoch": epoch,
                "avg": avg,
                **{f"cls_{k}": v for k, v in per_class.items()},
            }
        )
        return avg, per_class

    def evaluate_human_corr(
        self, epoch: int, centroids: np.ndarray
    ) -> T.Optional[T.Dict[str, T.Any]]:
        """Human-correlation monitor (ref ``utils.py:1047-1220``): scores the
        generated videos and correlates with MOS using class-mean fallback."""
        cfg = self.cfg
        gen_dir = cfg.paths.generated_meshes_dir
        human_path = cfg.paths.human_scores
        if not (gen_dir and os.path.isdir(gen_dir) and os.path.exists(human_path)):
            return None
        gen_manifest = scan_generated_flat(gen_dir)
        inferred = infer_generated_classes(gen_manifest.items, self.label_dict)
        gen_paths = ModalityPaths(
            keypoint_dir=cfg.paths.gen_kp_dir,
            clip_dir=cfg.paths.gen_clip_dir,
            dino_dir=cfg.paths.gen_dino_dir,
            layout="generated",
        )
        bank = build_feature_bank(
            gen_manifest.items, gen_paths, self.stats, self.stats.modalities,
            min_rows=cfg.clip_len + 8,
        )
        windows = enumerate_windows(gen_manifest, cfg.clip_len, cfg.stride)
        ac_scores, tc_scores = generated_monitor_scores(
            gen_manifest.items, inferred, bank, windows, self.encoder, centroids,
            self.label_dict,
        )
        with open(human_path) as f:
            human = json.load(f)
        out = {
            "action": correlate_with_class_fallback(
                ac_scores, human, "ac", self.label_dict.keys()
            ),
            "motion": correlate_with_class_fallback(
                tc_scores, human, "tc", self.label_dict.keys()
            ),
        }
        self._log(
            {
                "event": "human_corr",
                "epoch": epoch,
                "action_spearman": out["action"]["spearman"],
                "motion_spearman": out["motion"]["spearman"],
            }
        )
        return out

    # ------------------------------------------------------------------
    def _saver(self) -> AsyncSaver:
        if self._ckpt_saver is None:
            self._ckpt_saver = AsyncSaver()
        return self._ckpt_saver

    def wait_for_checkpoints(self) -> None:
        """Block until pending background checkpoint saves are durable."""
        if self._ckpt_saver is not None:
            self._ckpt_saver.wait()

    def save_resume_checkpoint(
        self, epoch: int, path: T.Optional[str] = None, block: bool = True
    ) -> str:
        """Full train-state checkpoint for exact resume (model, optimizer,
        schedule, step counter, epoch, best loss), which the reference lacks
        (it saves model weights only, ref ``train.py:450-455``).

        ``block=False`` (used by :meth:`run` when async checkpointing is on)
        copies the state on the device and hands the fetch and the write to
        a worker thread; call :meth:`wait_for_checkpoints` before relying on
        the file. Only rank 0 writes; every rank returns the path. Under
        tensor parallelism every rank calls it (the gathers are collectives)
        and the file holds the gathered tree."""
        path = path or os.path.join(self.save_dir, f"resume_epoch{epoch:03d}.pt")
        model_state, step_state = self.model.full_state_dict(), self.train_step.state_dict()
        if not self.writes:
            return path
        state = {
            "model": model_state,
            "train_step": step_state,
            "epoch": epoch,
            "best_eval_loss": self.best_eval_loss,
        }
        if block or not self.cfg.async_checkpoint:
            save_train_state(path, state)
        else:
            snap = snapshot(state)
            self._saver().submit(lambda: save_train_state(path, snap))
        return path

    def restore_resume_checkpoint(self, path: str) -> int:
        """Restore the full train state; returns the next epoch to run."""
        self.wait_for_checkpoints()  # never read a file a worker is writing
        st = restore_train_state(path)
        self.model.load_full_state_dict(st["model"], strict=True)
        self.train_step.load_state_dict(st["train_step"])
        self.refresh_eval_model()
        self.best_eval_loss = float(st["best_eval_loss"])
        return int(st["epoch"]) + 1

    def run(self, start_epoch: int = 0) -> None:
        # inside the loop, checkpoint writes go to the background saver
        # (cfg.async_checkpoint, at one rank). The finally drains the queue,
        # so every file run() promised exists when it returns, even on an
        # exception (the last good checkpoint must land for resume).
        background = self.cfg.async_checkpoint and self.world == 1
        try:
            for epoch in range(start_epoch, self.cfg.epochs):
                self.train_one_epoch(epoch)
                self.refresh_eval_model()
                centroids = self.evaluate_centroids()
                eval_loss, _comps = self.evaluate_test_loss(epoch)
                if eval_loss < self.best_eval_loss:
                    self.best_eval_loss = eval_loss
                    ckpt = os.path.join(self.save_dir, f"best_eval_epoch{epoch + 1:03d}.pt")
                    if self.writes and background:
                        snap = snapshot(self.eval_model.state_dict())
                        # bind per-iteration values: ckpt and snap are rebound
                        # on later epochs before the worker may run
                        self._saver().submit(lambda p=ckpt, s=snap: save_params(p, s))
                    elif self.writes:
                        save_params(ckpt, self.eval_model.state_dict())
                    self.best_ckpt = ckpt
                    self._log({"event": "checkpoint", "epoch": epoch, "loss": eval_loss})
                self.evaluate_centroid_distance(epoch, centroids)
                try:
                    self.evaluate_human_corr(epoch, centroids)
                except Exception as e:  # noqa: BLE001
                    # purely a monitor (the reference's own monitor skips
                    # unloadable gen videos, ref utils.py:1083-1086): a bad
                    # generated tree must not abort training before the
                    # epoch's resume checkpoint is written
                    self._log({
                        "event": "human_corr_failed",
                        "epoch": epoch,
                        "error": f"{type(e).__name__}: {e}",
                    })
                self.save_resume_checkpoint(epoch, block=not background)
                if self.rank is not None:
                    barrier(self.rank)   # rank 0's files are on disk for every rank
        finally:
            # a drain-time save failure must not mask an exception in flight
            # from the loop body
            if sys.exc_info()[0] is None:
                self.wait_for_checkpoints()
            else:
                try:
                    self.wait_for_checkpoints()
                except Exception as e:  # noqa: BLE001
                    self._log({
                        "event": "checkpoint_drain_failed",
                        "error": f"{type(e).__name__}: {e}",
                    })


def infer_generated_classes(
    items: T.Sequence, label_dict: T.Dict[str, int]
) -> T.List[T.Optional[str]]:
    """Known-class-substring inference for generated videos (ref
    ``utils.py:1069-1073``): each item's class is set to the first label
    whose name appears in the filename stem, falling back to the first
    known class when none does. Returns the per-item inference BEFORE the
    fallback: the AC scorer needs to know which videos really matched (see
    :func:`generated_monitor_scores`)."""
    inferred: T.List[T.Optional[str]] = []
    for it in items:
        stem = os.path.splitext(it.name)[0]
        cls = infer_class_from_name(stem, label_dict.keys())
        inferred.append(cls)
        it.cls = cls if cls is not None else next(iter(label_dict))
    return inferred


def generated_monitor_scores(
    items: T.Sequence,
    inferred: T.Sequence[T.Optional[str]],
    bank,
    windows: T.Sequence[T.Tuple[int, int]],
    encoder: WindowEncoder,
    centroids: np.ndarray,
    label_dict: T.Dict[str, int],
) -> T.Tuple[T.Dict[str, float], T.Dict[str, float]]:
    """Per-video (ac_scores, tc_scores) for the human-corr monitor, as the
    reference's ``get_human_corr`` single pass (ref ``utils.py:1125-1165``):
    TC (mean window TC) covers EVERY video, while AC only covers videos whose
    name contains a known class (the reference leaves class-less videos out
    of ``action_scores``, ``utils.py:1154-1159``, though their VideoItem
    carried the fallback class)."""
    num_videos = len(items)
    win_video = np.array([v for v, _s in windows], np.int64)
    seq_sum, tc_sum, count = encoder.encode_bank_segsum(bank, windows, win_video, num_videos)
    video_label = np.array([label_dict.get(c, 0) for c in bank.classes], np.int64)
    ac_v, tc_v = (
        t.numpy()
        for t in finalize_video_scores(
            torch.from_numpy(seq_sum), torch.from_numpy(tc_sum), torch.from_numpy(count),
            torch.from_numpy(video_label), torch.from_numpy(centroids),
        )
    )
    tc_scores = {items[v].name: float(tc_v[v]) for v in range(num_videos)}
    ac_scores = {
        items[v].name: float(ac_v[v])
        for v in range(num_videos)
        if inferred[v] is not None and bank.classes[v] in label_dict
    }
    return ac_scores, tc_scores
