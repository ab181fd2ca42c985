"""Training CLI — ref ``python train.py`` equivalent.

Port of ``video_gen_evals_tpu/pipelines/train_cli.py``:

    python -m video_gen_evals_tpu_torch.pipelines.train_cli \\
        --real-meshes REAL --real-kp-dir KP --generated-meshes GEN \\
        --gen-kp-dir GKP --human-scores MOS.json [--device cuda] [--resume CKPT] \\
        [--dp N] [--bank-cache DIR] [--conv-impl auto|module|kernel]

``--bank-cache DIR`` (or ``TrainConfig.bank_cache_dir``) keeps the stats and
the train and test banks between runs. ``--conv-impl`` (or
``TrainConfig.conv_impl``): ``auto`` and ``kernel`` train the conv stages
through K4 (its plain version on the CPU), ``module`` through K4's plain
version under autograd on any device.

``--dp N`` (or ``TrainConfig.num_dp_devices``; ``--dp`` wins) trains on N
data-parallel ranks: on one host N local processes (rank r on
``cuda:{r % device count}``, or the CPU with ``--device cpu``); under
``--coordinator`` / ``--num-processes P`` / ``--process-id`` each process is
one rank and ``--dp`` is absent or P. ``--tp`` other than 1 (tensor
parallelism) is not ported. The best checkpoint it writes
(``best_eval_epochNNN.pt``) is what the scoring CLI's ``--checkpoint``
takes.
"""

from __future__ import annotations

import typing as T


def _run(rank, cfg, args) -> T.Dict[str, T.Any]:
    """One process's run: alone on ``--device`` (``rank`` None) or as
    ``rank`` (a local rank of ``--dp``, or a process of a distributed run).
    Returns where it wrote and this process's kernel launches."""
    from ..ops import launch_counts
    from ..train.experiment import Experiment

    exp = Experiment(cfg, device=args.device, rank=rank)
    talk = exp.writes
    if talk:
        convs = ("K4's plain version under autograd" if exp.conv_impl == "module"
                 else "K4" if exp.device.type == "cuda" else "K4's plain version (CPU)")
        print(
            f"Training on {len(exp.train_ds)} videos ({len(exp.train_windows)} windows), "
            f"evaluating on {len(exp.test_ds)} videos; classes: {exp.full_ds.classes}"
            + ("" if rank is None else f"; {rank.world} data-parallel ranks")
            + f"; conv stages: --conv-impl {cfg.conv_impl} ({convs})"
        )
    start_epoch = 0
    if args.resume:
        start_epoch = exp.restore_resume_checkpoint(args.resume)
        if talk:
            print(f"Resumed from {args.resume}; continuing at epoch {start_epoch}")
    exp.run(start_epoch=start_epoch)
    if talk:
        print(f"Training complete. Best checkpoint: {exp.best_ckpt}")
    return {"rank": 0 if rank is None else rank.rank, "save_dir": exp.save_dir,
            "best_ckpt": exp.best_ckpt, "launches": launch_counts()}


def main(argv: T.Optional[T.List[str]] = None) -> T.List[T.Dict[str, T.Any]]:
    """The train CLI. Returns what each rank did (one entry on one device),
    in rank order."""
    import argparse

    from ..core.config import CONV_IMPLS, PathsConfig, TrainConfig
    from ..parallel import launch_local, shutdown
    from ..parallel.mesh import TENSOR_PARALLEL
    from ..utils.cli import add_distributed_args, maybe_initialize_distributed
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description="Train the HumanActionScorer fusion encoder")
    p.add_argument("--config", default=None, help="TrainConfig JSON; CLI flags override")
    p.add_argument("--real-meshes", default=None)
    p.add_argument("--real-kp-dir", default=None)
    p.add_argument("--generated-meshes", default=None)
    p.add_argument("--gen-kp-dir", default=None)
    p.add_argument("--real-clip-dir", default=None,
                   help="CLIP embeddings for real videos (enables the clip "
                        "modality; ref train.py:35-46 / utils.py:426-438)")
    p.add_argument("--real-dino-dir", default=None,
                   help="DINO embeddings for real videos")
    p.add_argument("--gen-clip-dir", default=None)
    p.add_argument("--gen-dino-dir", default=None)
    p.add_argument("--human-scores", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--clip-len", type=int, default=None)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--bank-cache", default=None,
                   help="directory for the cached stats and train/test feature banks "
                        "(skips the stats and normalize/delta passes on unchanged data)")
    p.add_argument("--conv-impl", default=None, choices=list(CONV_IMPLS),
                   help="conv stages in training: 'auto' and 'kernel' run K4 (its plain "
                        "version on the CPU), 'module' K4's plain version under autograd")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks: split each PK batch's stacked windows over N "
                        "ranks (default: one device; also TrainConfig.num_dp_devices)")
    p.add_argument("--tp", type=int, default=1,
                   help=f"tensor-parallel devices per data shard: 1 only ({TENSOR_PARALLEL})")
    p.add_argument("--resume", default=None,
                   help="resume-checkpoint file of a previous run (restores "
                        "model, optimizer, schedule, step and epoch exactly and "
                        "continues at the next epoch)")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    add_distributed_args(p)
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        p.error(f"--device: {e}")
    if args.tp != 1:
        p.error(f"--tp {args.tp}: tensor parallelism is not ported ({TENSOR_PARALLEL}); --tp 1 only")

    cfg = TrainConfig.from_json(args.config) if args.config else TrainConfig()
    paths: PathsConfig = cfg.paths
    for flag, field in (
        ("real_meshes", "real_meshes_dir"), ("real_kp_dir", "real_kp_dir"),
        ("generated_meshes", "generated_meshes_dir"), ("gen_kp_dir", "gen_kp_dir"),
        ("real_clip_dir", "real_clip_dir"), ("real_dino_dir", "real_dino_dir"),
        ("gen_clip_dir", "gen_clip_dir"), ("gen_dino_dir", "gen_dino_dir"),
        ("human_scores", "human_scores"),
    ):
        v = getattr(args, flag)
        if v:
            setattr(paths, field, v)
    for field in ("epochs", "clip_len", "stride", "lr", "save_dir"):
        v = getattr(args, field)
        if v is not None:
            setattr(cfg, field, v)
    if args.bank_cache:
        cfg.bank_cache_dir = args.bank_cache
    if args.conv_impl:
        cfg.conv_impl = args.conv_impl
    n_dp = args.dp if args.dp is not None else cfg.num_dp_devices
    if n_dp is not None and n_dp < 1:
        p.error(f"--dp must be >= 1, got {n_dp}")

    if n_dp is not None and cfg.batch_size % n_dp:
        p.error(f"PK batch size {cfg.batch_size} must divide evenly over --dp {n_dp}")

    rank = maybe_initialize_distributed(args, args.device)
    if rank is not None:
        try:
            if n_dp not in (None, rank.world):
                p.error(f"--dp {n_dp} under --num-processes {rank.world}: one rank a process, so "
                        f"--dp must be absent or {rank.world}")
            return [_run(rank, cfg, args)]
        finally:
            shutdown(rank)
    if n_dp is not None and n_dp > 1:
        return launch_local(n_dp, _run, cfg, args, device=args.device)
    return [_run(None, cfg, args)]


if __name__ == "__main__":
    main()
