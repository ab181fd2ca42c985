"""TAG scoring pipeline (the serve path) — ref ``eval.py`` equivalent.

Port of ``video_gen_evals_tpu/pipelines/score.py``. Per batch of windows, on
the device:

  gather windows (K1 kernel) -> HumanActionScorer forward (K3 kernel for the
  40 residual conv stages) -> per-window TC -> per-segment sums (a one-hot
  GEMM: the same bits every sweep)

``--encoder-impl`` picks the forward as in JAX: ``auto`` and ``module`` the
module forward above; ``block_kernel`` and ``chain_kernel`` the fused forward
``models/fused_apply.py::block_kernel_forward``, with one conv stage a launch
(K3) or a chain's 4 stages a launch (K10), both at ``--precision high`` only.
``--precision`` names the conv-stage arithmetic: ``default`` (bf16 operands,
fp32 sums: K3 on the tensor-core body K4's forward uses), ``high`` (bf16x3)
or ``highest`` (fp32); every other matmul runs in fp32.
``--gather-impl``: ``auto`` and ``burst`` gather windows with K1; ``sliced``
and ``take`` with the torch gathers of ``data/features.py``, which JAX
computes outside Pallas (``take`` is exact for any start).

The bank is built on the host (or on the device, ``ScoreConfig.bank_impl``)
and uploaded once per sweep; window indices are uploaded once per sweep too,
and the segment sums come back in one fetch at its end, so the sweep never
waits on the host between batches. The tail batch is padded with repeats and
masked out of the sums, as in JAX. ``--bank-cache DIR`` keeps the stats and
banks between runs (``stats.npz``, ``real_train_bank.npz``,
``generated_bank[.host<I>of<N>].npz``, the JAX package's files and
fingerprints); ``--dump-features F.npz`` writes every generated window's
embedding and TC; ``--checkpoint`` takes a reference ``.pt`` or the JAX
package's path-keyed ``.npz`` params.

Data parallelism (``--mesh-data N``): N ranks (``parallel.launch_local`` on
one host, or one a process under ``--num-processes``), each sweeping every
N-th window batch of the same bank on its own device; the per-segment sums
are summed over the ranks in one ``all_reduce`` (per-window outputs are
gathered the same way, each window written by the one rank that encoded
it). Multi-host sweeps (``--num-hosts``, ``--host-id``): each host scores
its strided shard of the generated manifest and writes
``<output>.host<I>of<N>.json``; ``pipelines.merge_scores`` joins the shards
and computes the correlations.

Writes ``video_scores.json`` with the reference schema ``{vid: {ac, tc}}``
(ref ``eval.py:439-453``) and, given human MOS, sign-inverted Spearman
(ref ``eval.py:456-464``).

    python -m video_gen_evals_tpu_torch.pipelines.score \\
        --generated-meshes GEN --real-meshes REAL --checkpoint model.pt \\
        --real-kp-dir KP --gen-kp-dir GKP [--device cuda] [--mesh-data N] \\
        [--num-hosts N --host-id I] [--precision default|high|highest] \\
        [--gather-impl auto|burst|sliced|take] [--bank-cache DIR] [--dump-features F.npz]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import typing as T

import numpy as np
import torch

from ..data import (
    FeatureBank,
    ModalityPaths,
    ModalityStats,
    VideoManifest,
    enumerate_windows,
    scan_class_tree,
    scan_generated_flat,
    train_test_split,
)
from ..data.features import build_feature_bank_cached, gather_windows_sliced
from ..data.features import gather_windows as gather_windows_take
from ..data.stats import compute_stats_cached
from ..metrics.correlation import match_and_correlate
from ..metrics.scores import finalize_centroids, finalize_video_scores, tc_per_window
from ..models import EncoderConfig, HumanActionScorer
from ..models.fused_apply import block_kernel_forward
from ..ops.window_kernel import gather_windows
from ..parallel import Rank, all_reduce_sum, barrier, shard_items
from ..utils.device import disable_tf32, resolve_device
from ..utils.names import ACTION_CLASSES, canonicalize_class

PRECISIONS = ("default", "high", "highest")
ENCODER_IMPLS = ("auto", "module", "block_kernel", "chain_kernel")
# window gathers: K1 ("auto", "burst"), or the torch gathers JAX runs in XLA
GATHERS = {"auto": gather_windows, "burst": gather_windows, "sliced": gather_windows_sliced,
           "take": gather_windows_take}
BANK_IMPLS = ("auto", "host", "device")
# block_kernel_forward's arguments for each explicit kernel forward
_FUSED = {
    "block_kernel": dict(stage_fusion="stage", conv_variant="mm_first"),
    "chain_kernel": dict(stage_fusion="chain", conv_variant="slice"),
}


@dataclasses.dataclass
class ScoreConfig:
    clip_len: int = 32
    stride: int = 8
    batch_size: int = 512
    seed: int = 1337
    # arithmetic of the conv-stage kernel: "default" (bf16 operands, fp32
    # sums), "high" (bf16x3, the JAX scoring default) or "highest" (fp32);
    # every other matmul runs in fp32
    precision: str = "high"
    # the encoder forward (ENCODER_IMPLS): "auto" and "module" the module
    # forward, "block_kernel" / "chain_kernel" the fused kernel forwards
    encoder_impl: str = "auto"
    # the window gather (GATHERS)
    gather_impl: str = "auto"
    # where score_generated's banks and pipelines/full.py's in-memory bank are
    # assembled (BANK_IMPLS): "auto" and "host" on the host, "device" on the
    # encoder's device (data/device_bank.py)
    bank_impl: str = "auto"


class WindowEncoder:
    """Encodes window sweeps of a feature bank on one device and reduces them
    to per-segment sums there. ``encoder_impl``: see ``ENCODER_IMPLS``.
    With ``rank`` (a ``parallel.Rank``) it runs on the rank's device and
    encodes every ``world``-th batch, starting at its own index; the results
    are summed over the ranks, so every rank returns the whole sweep's."""

    def __init__(
        self,
        model: HumanActionScorer,
        batch_size: int,
        clip_len: int,
        precision: str = "high",
        device: T.Union[str, torch.device] = "cuda",
        encoder_impl: str = "auto",
        rank: T.Optional[Rank] = None,
        gather_impl: str = "auto",
    ):
        if gather_impl not in GATHERS:
            raise ValueError(f"gather_impl must be one of {tuple(GATHERS)}, got {gather_impl!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        if encoder_impl not in ENCODER_IMPLS:
            raise ValueError(f"encoder_impl must be one of {ENCODER_IMPLS}, got {encoder_impl!r}")
        if encoder_impl in _FUSED and precision != "high":
            # the fused kernels run bf16x3: another precision would silently
            # change numerics
            raise ValueError(
                f"encoder_impl={encoder_impl!r} runs the fused kernels at precision 'high' "
                f"(bf16x3); precision={precision!r} needs encoder_impl 'auto' or 'module'")
        self._fused = _FUSED.get(encoder_impl)   # block_kernel_forward's arguments, or None
        self.rank = rank
        self.device = resolve_device(rank.device if rank is not None else device)
        disable_tf32()
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.clip_len = clip_len
        self.precision = precision
        self.gather = GATHERS[gather_impl]

    def upload(self, bank: FeatureBank) -> T.Tuple[torch.Tensor, ...]:
        """``(bank, offsets, row_limit, z0_diff)`` on the device; a bank that
        is a tensor on the device already (``data/device_bank.py``) is taken
        as it is, with no host copy."""
        return tuple(
            (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))).to(self.device)
            for a in (bank.bank, bank.offsets, bank.row_limit, bank.z0_diff)
        )

    def _encode_batches(
        self,
        bank: FeatureBank,
        windows: T.Sequence[T.Tuple[int, int]],
        bank_dev: T.Optional[T.Tuple[torch.Tensor, ...]],
    ) -> T.Iterator[T.Tuple[slice, torch.Tensor, torch.Tensor]]:
        """``(batch slice, seq [B, D], tc [B])`` of every batch of the sweep
        (of this rank's batches under a rank), in eval mode under
        ``inference_mode``; the tail batch is padded with repeats of the last
        window (slots past ``len(windows)``)."""
        # a bank built with min_rows < clip_len would read the next video's rows
        bank.validate_clip_len(self.clip_len)
        n = len(windows)
        B = self.batch_size
        n_pad = -(-n // B) * B
        pad = lambda a: np.concatenate([a, np.repeat(a[-1:], n_pad - n)])   # noqa: E731
        vi_d, st_d = (
            torch.from_numpy(pad(np.array([w[i] for w in windows], np.int32))).to(self.device)
            for i in (0, 1)
        )
        bank_d, offsets_d, row_limit_d, z0_d = bank_dev if bank_dev is not None else self.upload(bank)
        self.model.eval()
        first, step = (0, 1) if self.rank is None else (self.rank.rank, self.rank.world)
        for lo in range(first * B, n_pad, step * B):
            b = slice(lo, lo + B)
            with torch.inference_mode():   # never held across a yield
                w = self.gather(bank_d, offsets_d, row_limit_d, z0_d, bank.one_pass_raw,
                                vi_d[b], st_d[b], self.clip_len)
                seq, frames, _ = self.forward(w)
                tc = tc_per_window(frames)
            yield b, seq, tc

    def forward(self, w: torch.Tensor):
        """The encoder forward on a window batch: ``model(w)`` or the fused
        kernel forward of ``encoder_impl``."""
        if self._fused is None:
            return self.model(w, self.precision)
        return block_kernel_forward(self.model.config, self.model, w, precision=self.precision,
                                    **self._fused)

    def encode_bank(
        self,
        bank: FeatureBank,
        windows: T.Sequence[T.Tuple[int, int]],
        bank_dev: T.Optional[T.Tuple[torch.Tensor, ...]] = None,
    ) -> T.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host ``(seq_embeds [N, D], window_tc [N], window_video [N])`` of
        every window, fetched once at the end of the sweep."""
        n = len(windows)
        video_idx = np.array([w[0] for w in windows], np.int32)
        d_model = self.model.config.d_model
        if n == 0:
            return np.zeros((0, d_model), np.float32), np.zeros((0,), np.float32), video_idx
        if self.rank is None:
            outs = [torch.cat([seq, tc[:, None]], dim=1)
                    for _b, seq, tc in self._encode_batches(bank, windows, bank_dev)]
            out = torch.cat(outs)[:n].cpu().numpy()
        else:
            # each window's row is written by the one rank that encoded it and
            # is zero on every other, so the sum over the ranks gathers them
            n_pad = -(-n // self.batch_size) * self.batch_size
            rows = torch.zeros((n_pad, d_model + 1), dtype=torch.float32, device=self.device)
            with torch.inference_mode():
                for b, seq, tc in self._encode_batches(bank, windows, bank_dev):
                    rows[b] = torch.cat([seq, tc[:, None]], dim=1)
            all_reduce_sum([rows], self.rank)
            out = rows[:n].cpu().numpy()
        return out[:, :d_model], out[:, d_model], video_idx

    def encode_bank_segsum(
        self,
        bank: FeatureBank,
        windows: T.Sequence[T.Tuple[int, int]],
        seg_ids: T.Sequence[int],
        num_segments: int,
        bank_dev: T.Optional[T.Tuple[torch.Tensor, ...]] = None,
    ) -> T.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Encode every window and return host ``(seq_sum [S, D], tc_sum [S],
        count [S])``, summing the window CLS embeddings and per-window TCs of
        the windows with ``seg_ids == s`` (video index for scoring, class id
        for centroids). ``bank_dev``: the bank already on the device
        (:meth:`upload`), to sweep it more than once."""
        seg_ids = np.asarray(seg_ids, np.int64)
        if len(seg_ids) != len(windows):
            raise ValueError(f"seg_ids has {len(seg_ids)} entries for {len(windows)} windows")
        d_model = self.model.config.d_model
        seq_sum = torch.zeros((num_segments, d_model), dtype=torch.float32, device=self.device)
        tc_sum = torch.zeros((num_segments,), dtype=torch.float32, device=self.device)
        count = torch.zeros((num_segments,), dtype=torch.float32, device=self.device)
        n = len(windows)
        n_pad = -(-n // self.batch_size) * self.batch_size
        seg_d = torch.from_numpy(
            np.concatenate([seg_ids, np.repeat(seg_ids[-1:], n_pad - n)])).to(self.device)
        valid = (torch.arange(n_pad, device=self.device) < n).to(torch.float32)
        ids = torch.arange(num_segments, device=self.device)[:, None]
        with torch.inference_mode():
            for b, seq, tc in self._encode_batches(bank, windows, bank_dev):
                # the batch's valid windows as a one-hot [S, B]: a GEMM sums
                # them in a fixed order, where index_add_ on CUDA adds with
                # atomics and two sweeps could differ in their last bits
                onehot = (seg_d[b][None, :] == ids).to(torch.float32) * valid[b][None, :]
                seq_sum += onehot @ seq
                tc_sum += onehot @ tc
                count += onehot.sum(dim=1)
        out = torch.cat([seq_sum, tc_sum[:, None], count[:, None]], dim=1)
        if self.rank is not None:
            all_reduce_sum([out], self.rank)
        # the sweep's one fetch
        out = out.cpu().numpy()
        return out[:, :d_model], out[:, d_model], out[:, d_model + 1]


def _bank_impl(cfg: ScoreConfig) -> str:
    """``cfg.bank_impl`` resolved: "auto" is "host", as in JAX."""
    if cfg.bank_impl not in BANK_IMPLS:
        raise ValueError(f"bank_impl must be one of {BANK_IMPLS}, got {cfg.bank_impl!r}")
    return "host" if cfg.bank_impl == "auto" else cfg.bank_impl


def on_ranks(rank: T.Optional[Rank], build: T.Callable[[bool], T.Any]) -> T.Any:
    """``build(write)`` of a cached quantity: alone, or at rank 0 of a group
    first (writing the cache) and at the other ranks after a barrier
    (reading it, never writing)."""
    if rank is None or rank.world == 1:
        return build(True)
    if rank.is_primary:
        out = build(True)
        barrier(rank)
        return out
    barrier(rank)
    return build(False)


def build_real_centroids(
    encoder: WindowEncoder,
    real_manifest: VideoManifest,
    paths: ModalityPaths,
    stats: ModalityStats,
    cfg: ScoreConfig,
    bank_cache: T.Optional[str] = None,
) -> T.Tuple[np.ndarray, T.Dict[str, int]]:
    """Class centroids from the real-video train split (ref ``eval.py:260-286``);
    the split's bank cached at ``bank_cache`` when given."""
    train_ds, _ = train_test_split(real_manifest, 0.8, seed=cfg.seed)
    label_dict = real_manifest.label_dict()
    bank = on_ranks(encoder.rank, lambda write: build_feature_bank_cached(
        train_ds.items, paths, stats, min_rows=cfg.clip_len + 8, cache_path=bank_cache,
        impl=_bank_impl(cfg), device=encoder.device, write=write))
    windows = enumerate_windows(train_ds, cfg.clip_len, cfg.stride)
    win_label = [label_dict[bank.classes[v]] for v, _s in windows]
    seq_sum, _tc_sum, count = encoder.encode_bank_segsum(
        bank, windows, win_label, len(label_dict)
    )
    centroids = finalize_centroids(torch.from_numpy(seq_sum), torch.from_numpy(count))
    return centroids.numpy(), label_dict


def score_bank(
    encoder: WindowEncoder,
    bank: FeatureBank,
    manifest: VideoManifest,
    centroids: np.ndarray,
    label_dict: T.Dict[str, int],
    cfg: ScoreConfig,
) -> T.Dict[str, T.Dict[str, float]]:
    """Score every video in ``manifest``: ``{video_id: {ac, tc}}``. AC only
    for videos whose canonical class has a centroid."""
    windows = enumerate_windows(manifest, cfg.clip_len, cfg.stride)
    if not windows:
        return {}
    win_video = [v for v, _s in windows]
    seq_sum, tc_sum, count = encoder.encode_bank_segsum(
        bank, windows, win_video, len(manifest.items)
    )
    video_cls = [canonicalize_class(c) for c in bank.classes]
    video_label = np.array([label_dict.get(c, 0) for c in video_cls], np.int64)
    has_label = [c in label_dict and label_dict[c] < len(centroids) for c in video_cls]
    ac_v, tc_v = (
        t.numpy()
        for t in finalize_video_scores(
            torch.from_numpy(seq_sum), torch.from_numpy(tc_sum), torch.from_numpy(count),
            torch.from_numpy(video_label), torch.from_numpy(centroids),
        )
    )
    scores: T.Dict[str, T.Dict[str, float]] = {}
    for v, it in enumerate(manifest.items):
        if count[v] <= 0:
            continue
        entry = scores.setdefault(os.path.splitext(it.name)[0], {})
        entry["tc"] = float(tc_v[v])
        if has_label[v]:
            entry["ac"] = float(ac_v[v])
    return scores


def score_generated(
    model: HumanActionScorer,
    generated_dir: str,
    real_meshes_dir: str,
    real_paths: ModalityPaths,
    gen_paths: ModalityPaths,
    cfg: T.Optional[ScoreConfig] = None,
    human_scores_path: T.Optional[str] = None,
    output_json: T.Optional[str] = "video_scores.json",
    stats: T.Optional[ModalityStats] = None,
    device: T.Union[str, torch.device] = "cuda",
    num_hosts: int = 1,
    host_id: int = 0,
    rank: T.Optional[Rank] = None,
    dump_features: T.Optional[str] = None,
    bank_cache_dir: T.Optional[str] = None,
) -> T.Dict[str, T.Any]:
    """The ref ``eval.py`` flow: stats from the real train split, class
    centroids, every generated video scored, optional Spearman vs human MOS.

    ``dump_features``: an ``.npz`` of every generated window's CLS embedding
    and TC with its video and start (the JAX package's keys; the reference's
    ``window_features.pt``, ref ``eval.py:202-205``). ``bank_cache_dir``:
    the stats and banks cached there (``stats.npz``, ``real_train_bank.npz``,
    ``generated_bank[.host<I>of<N>].npz``).

    ``rank``: a data-parallel rank (``parallel.Rank``); the sweeps are split
    over the group's ranks, every rank returns the same scores, and only
    rank 0 writes ``output_json``.
    ``num_hosts``/``host_id``: a multi-host sweep, as in JAX. This host
    scores only its strided shard of the generated manifest (stats and
    centroids come from the full real train split on every host, so shards
    agree); merge the per-host JSONs with ``pipelines.merge_scores``.
    Human correlations need every video, so they are computed at the merge
    and ``human_scores_path`` is ignored when ``num_hosts > 1``.
    ``output_json`` is suffixed ``.host<I>of<N>`` (unless already so
    suffixed), so hosts sharing an output directory never clobber each
    other; the path written is ``result["output_json"]``. A host whose shard
    is empty writes ``{}``."""
    cfg = cfg or ScoreConfig()
    writes = rank is None or rank.is_primary
    cache = lambda name: os.path.join(bank_cache_dir, name) if bank_cache_dir else None   # noqa: E731
    gen_manifest = scan_generated_flat(generated_dir)
    if num_hosts > 1:
        gen_manifest = VideoManifest(shard_items(gen_manifest.items, host_id, num_hosts))
        human_scores_path = None   # correlations run at merge time
        if output_json:
            stem, ext = os.path.splitext(output_json)
            tag = f".host{host_id}of{num_hosts}"
            if not stem.endswith(tag):
                output_json = f"{stem}{tag}{ext or '.json'}"
        if not gen_manifest.items:
            # more hosts than videos: an empty shard, still mergeable
            if output_json and writes:
                with open(output_json, "w") as f:
                    json.dump({}, f, indent=2)
            return {"scores": {}, "output_json": output_json}
    real_manifest = scan_class_tree(real_meshes_dir, filter_classes=list(ACTION_CLASSES))
    if stats is None:
        train_ds, _ = train_test_split(real_manifest, 0.8, seed=cfg.seed)
        stats = on_ranks(rank, lambda write: compute_stats_cached(
            train_ds.items, real_paths, cache_path=cache("stats.npz"), write=write))

    encoder = WindowEncoder(model, cfg.batch_size, cfg.clip_len, cfg.precision, device,
                            cfg.encoder_impl, rank=rank, gather_impl=cfg.gather_impl)
    centroids, label_dict = build_real_centroids(encoder, real_manifest, real_paths, stats, cfg,
                                                 bank_cache=cache("real_train_bank.npz"))
    gen_name = f"generated_bank.host{host_id}of{num_hosts}.npz" if num_hosts > 1 else "generated_bank.npz"
    gen_bank = on_ranks(rank, lambda write: build_feature_bank_cached(
        gen_manifest.items, gen_paths, stats, min_rows=cfg.clip_len + 8, cache_path=cache(gen_name),
        impl=_bank_impl(cfg), device=encoder.device, write=write))
    combined = score_bank(encoder, gen_bank, gen_manifest, centroids, label_dict, cfg)

    if dump_features:
        windows = enumerate_windows(gen_manifest, cfg.clip_len, cfg.stride)
        seqs, window_tc, win_video = encoder.encode_bank(gen_bank, windows)
        if writes:
            np.savez_compressed(
                dump_features,
                seq_embeds=seqs,
                window_tc=window_tc,
                window_video=win_video,
                window_start=np.array([s for _v, s in windows], np.int32),
                video_names=np.array(gen_bank.names),
                video_classes=np.array(gen_bank.classes),
            )

    result: T.Dict[str, T.Any] = {"scores": combined, "output_json": output_json}
    if output_json and writes:
        with open(output_json, "w") as f:
            json.dump(combined, f, indent=2)
    if human_scores_path:
        with open(human_scores_path) as f:
            human = json.load(f)
        ac_only = {k: v["ac"] for k, v in combined.items() if "ac" in v}
        tc_only = {k: v["tc"] for k, v in combined.items() if "tc" in v}
        result["ac_corr"] = match_and_correlate(ac_only, human, "ac")
        result["tc_corr"] = match_and_correlate(tc_only, human, "tc")
    return result


def load_checkpoint(path: str, model: HumanActionScorer, strict: bool = False) -> None:
    """``--checkpoint``: a reference-layout ``.pt``, or the JAX package's
    path-keyed ``.npz`` params (``path`` or ``path + ".npz"``). An orbax
    directory is refused by name."""
    from ..models.torch_compat import load_torch_checkpoint
    from ..train.checkpoint import load_jax_npz_params

    if path.endswith(".pt"):
        load_torch_checkpoint(path, model, strict=strict)
    else:
        load_jax_npz_params(path, model)


def _run_cli(rank: T.Optional[Rank], args, host_id: int) -> T.Dict[str, T.Any]:
    """The CLI's run on this process, as ``rank`` of a data-parallel group
    (a local rank of ``--mesh-data``, or a process of a distributed run) or
    (None) alone on ``--device``. Returns what the run did: videos scored,
    the file written and this process's kernel launches."""
    from ..core.config import BugCompat
    from ..ops import launch_counts

    bc = BugCompat.enabled() if args.bug_compat else BugCompat.disabled()
    cfg = ScoreConfig(args.clip_len, args.stride, args.batch_size, precision=args.precision,
                      encoder_impl=args.encoder_impl, gather_impl=args.gather_impl)
    real_paths = ModalityPaths(
        keypoint_dir=args.real_kp_dir, clip_dir=args.real_clip_dir,
        dino_dir=args.real_dino_dir, layout="auto" if bc.layout_auto else "real",
    )
    gen_paths = ModalityPaths(
        keypoint_dir=args.gen_kp_dir, clip_dir=args.gen_clip_dir,
        dino_dir=args.gen_dino_dir, layout="auto" if bc.layout_auto else "generated",
    )

    real_manifest = scan_class_tree(args.real_meshes, filter_classes=list(ACTION_CLASSES))
    train_ds, _ = train_test_split(real_manifest, 0.8, seed=cfg.seed)
    stats_cache = os.path.join(args.bank_cache, "stats.npz") if args.bank_cache else None
    stats = on_ranks(rank, lambda write: compute_stats_cached(train_ds.items, real_paths,
                                                              cache_path=stats_cache, write=write))
    model = HumanActionScorer(EncoderConfig.create(stats.dims_map_raw(), stats.dims_map_diff()))
    load_checkpoint(args.checkpoint, model, strict=not bc.permissive_ckpt)

    result = score_generated(
        model, args.generated_meshes, args.real_meshes, real_paths, gen_paths, cfg,
        human_scores_path=args.human_scores, output_json=args.output, stats=stats,
        device=args.device, num_hosts=args.num_hosts, host_id=host_id, rank=rank,
        dump_features=args.dump_features, bank_cache_dir=args.bank_cache,
    )
    if rank is None or rank.is_primary:
        print(f"Saved AC/TC scores for {len(result['scores'])} videos to {result['output_json']}")
        for key in ("ac_corr", "tc_corr"):
            if key in result and result[key]["spearman"] is not None:
                print(f"{key}: spearman={result[key]['spearman']:.4f} (n={result[key]['n']})")
    return {"rank": 0 if rank is None else rank.rank, "videos": len(result["scores"]),
            "output_json": result["output_json"], "launches": launch_counts()}


def main(argv: T.Optional[T.List[str]] = None) -> T.List[T.Dict[str, T.Any]]:
    """The score CLI. Returns what each rank did (one entry without
    ``--mesh-data``), in rank order."""
    import argparse

    from ..parallel import shutdown
    from ..utils.cli import add_distributed_args, maybe_initialize_distributed

    p = argparse.ArgumentParser(description="TAG scoring (AC + TC) pipeline, PyTorch + CUDA")
    p.add_argument("--generated-meshes", required=True)
    p.add_argument("--real-meshes", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="reference-layout .pt state_dict, or the JAX package's path-keyed .npz params")
    p.add_argument("--real-kp-dir", default=None)
    p.add_argument("--gen-kp-dir", default=None)
    p.add_argument("--real-clip-dir", default=None,
                   help="CLIP embeddings for real videos (<dir>/<class>/<stem>/clip_embeddings.npz)")
    p.add_argument("--gen-clip-dir", default=None,
                   help="CLIP embeddings for generated videos (<dir>/<stem>/clip_embeddings.npz)")
    p.add_argument("--real-dino-dir", default=None, help="DINO embeddings for real videos")
    p.add_argument("--gen-dino-dir", default=None, help="DINO embeddings for generated videos")
    p.add_argument("--human-scores", default=None)
    p.add_argument("--clip-len", type=int, default=32)
    p.add_argument("--stride", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--output", default="video_scores.json")
    p.add_argument("--dump-features", default=None,
                   help="optional .npz of every generated window's embedding and TC "
                        "(ref window_features.pt)")
    p.add_argument("--bank-cache", default=None,
                   help="directory for cached stats and feature banks (skips the stats and "
                        "normalize/delta passes when the video set is unchanged)")
    p.add_argument("--bug-compat", dest="bug_compat", action="store_true", default=True,
                   help="reproduce the reference's accidental behaviors (layout "
                        "auto-detection, permissive checkpoint loading)")
    p.add_argument("--no-bug-compat", dest="bug_compat", action="store_false")
    p.add_argument("--precision", default="high", choices=list(PRECISIONS),
                   help="conv-stage kernel arithmetic: 'default' (bf16 operands, fp32 sums), "
                        "'high' (bf16x3) or 'highest' (fp32)")
    p.add_argument("--gather-impl", default="auto", choices=list(GATHERS),
                   help="window gather: K1 (auto, burst), or the torch gathers sliced and take")
    p.add_argument("--encoder-impl", default="auto", choices=list(ENCODER_IMPLS),
                   help="encoder forward: the module forward (auto, module) or the fused "
                        "kernel forwards (block_kernel: K3 a stage; chain_kernel: K10 a chain; "
                        "both --precision high only)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel sweeps over N ranks: N local processes, rank r on "
                        "cuda:{r %% device count} (or the CPU with --device cpu); under "
                        "--num-processes, the processes' group (N must equal it). 0 = one device")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host sweep: total hosts sharding the generated manifest; each "
                        "writes <output>.hostIofN.json; merge with python -m "
                        "video_gen_evals_tpu_torch.pipelines.merge_scores")
    p.add_argument("--host-id", type=int, default=-1,
                   help="this host's shard index; -1 = the rank under --num-processes")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    add_distributed_args(p)
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        p.error(f"--device: {e}")
    if args.mesh_data < 0 or args.num_hosts < 1:
        p.error("--mesh-data must be >= 0 and --num-hosts >= 1")
    rank = maybe_initialize_distributed(args, args.device)
    try:
        return _dispatch(p, args, rank)
    finally:
        if rank is not None:
            shutdown(rank)


def _dispatch(p, args, rank: T.Optional[Rank]) -> T.List[T.Dict[str, T.Any]]:
    """The score CLI after its flags: check their combination, then run here
    or on ``--mesh-data`` local ranks."""
    from ..parallel import launch_local
    from ..utils.cli import resolve_host_id

    world = rank.world if rank is not None else 1
    if args.mesh_data > 0 and world > 1:
        if args.num_hosts > 1:
            # the group's ranks split ONE sweep; per-host manifest shards
            # would feed them different videos
            p.error(
                "--num-hosts manifest sharding cannot combine with a "
                "cross-process --mesh-data group: run one single-process "
                "CLI per host, or drop --num-hosts and let the group "
                "shard one manifest"
            )
        if args.mesh_data != world:
            p.error(f"--mesh-data {args.mesh_data} under --num-processes {world}: one rank a "
                    f"process, so --mesh-data must be {world}")
    host_id = resolve_host_id(p, args.host_id, args.num_hosts, rank)
    if args.num_hosts > 1 and args.human_scores:
        print("note: --human-scores is deferred with --num-hosts > 1: correlations need every "
              "video; run pipelines.merge_scores with --human-scores on the shards",
              file=sys.stderr)
    if world > 1:
        # one process of a distributed run: the group is the data-parallel
        # group under --mesh-data, else only the host index comes from it
        return [_run_cli(rank if args.mesh_data > 0 else None, args, host_id)]
    if args.mesh_data > 1:
        return launch_local(args.mesh_data, _run_cli, args, host_id, device=args.device)
    return [_run_cli(None, args, host_id)]


if __name__ == "__main__":
    main()
