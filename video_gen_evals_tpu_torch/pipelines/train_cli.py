"""Training CLI — ref ``python train.py`` equivalent.

Port of ``video_gen_evals_tpu/pipelines/train_cli.py`` for one device:

    python -m video_gen_evals_tpu_torch.pipelines.train_cli \\
        --real-meshes REAL --real-kp-dir KP --generated-meshes GEN \\
        --gen-kp-dir GKP --human-scores MOS.json [--device cuda] [--resume CKPT]

The best checkpoint it writes (``best_eval_epochNNN.pt``) is what the scoring
CLI's ``--checkpoint`` takes.
"""

from __future__ import annotations

import typing as T


def main(argv: T.Optional[T.List[str]] = None) -> None:
    import argparse

    from ..core.config import PathsConfig, TrainConfig
    from ..train.experiment import Experiment
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
    p.add_argument("--resume", default=None,
                   help="resume-checkpoint file of a previous run (restores "
                        "model, optimizer, schedule, step and epoch exactly and "
                        "continues at the next epoch)")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        p.error(f"--device: {e}")

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

    exp = Experiment(cfg, device=device)
    print(
        f"Training on {len(exp.train_ds)} videos ({len(exp.train_windows)} windows), "
        f"evaluating on {len(exp.test_ds)} videos; classes: {exp.full_ds.classes}"
    )
    start_epoch = 0
    if args.resume:
        start_epoch = exp.restore_resume_checkpoint(args.resume)
        print(f"Resumed from {args.resume}; continuing at epoch {start_epoch}")
    exp.run(start_epoch=start_epoch)
    print(f"Training complete. Best checkpoint: {exp.best_ckpt}")


if __name__ == "__main__":
    main()
