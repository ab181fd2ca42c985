"""Data and tensor parallelism of the PyTorch + CUDA port across the cards
of one host.

First one training step of the flagship scorer at ``TrainConfig`` defaults
(a seeded [240, 32, 2596] batch, 960 stacked windows, dropout 0.1) at K4's
"highest" and "default" on N ranks, one a card (N = the host's cards, so
NCCL by the backend rule): the loss and every gradient before the
optimizer against the same rows forwarded in N blocks on one card, and
against the whole batch on one card, within STEP_LOSS_RTOL / STEP_GRAD_TOL
(at "default" the whole batch is reported, not held: its GEMMs see 4x the
rows, round in the last bits otherwise, and bf16 operands on a rounding
boundary then round the other way). Then the same step on the N ranks as
a (data, model) grid, ``--tp N`` and (for N = 4) ``--dp 2 --tp 2``: the
model sharded over each model axis (``parallel/tensor.py``), its gradients
gathered whole, against the rows of each data shard forwarded in blocks on
one card and against the whole batch, the loss within STEP_LOSS_RTOL and
the gradients within TP_STEP_GRAD_TOL (see there why not STEP_GRAD_TOL);
each comparison names the three parameters most apart. Then the train CLI at
``TrainConfig`` defaults on ``chip_smoke.py``'s phase-5 tree (10 classes x
5 real videos, 20 generated), 2 epochs, once on one rank and once with
``--dp N``, and the score CLI on the one-rank run's best checkpoint, on one
rank and with ``--mesh-data N``. Prints each rank's backend (the ranks
print it), the step's differences, both runs' losses epoch by epoch and
their relative differences (reported, not held: after 8 AdamW updates they
carry the step's rounding, which AdamW turns into whole learning-rate moves
where a gradient is near zero), each rank's kernel launches, the second
epoch's clips/s of each run, the scores' largest difference (within
``merge_scores``' SCORE_ATOL / SCORE_RTOL), each run's seconds, and every
card's name and power limit. Needs two or more NVIDIA GPUs.

    python3 scripts/torch_parallel_cards.py
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one step on N ranks against the same rows on one card: the loss, relative;
# every gradient, relative to the largest |gradient| (the sums run in
# another order)
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-5, 1e-4
# the same on a grid with a model axis: its row-parallel sums reorder the
# transformer's pre-activations by an ulp, and a ReLU pre-activation that
# crosses zero moves its row's whole share of linear1's weight gradient, so
# the largest difference grows with the batch's rows (5.31e-4 of max |g| at
# "highest" on 4 H100s, the parameters most apart linear1's; PERF.md, PR
# 17). STEP_GRAD_TOL does not hold there.
TP_STEP_GRAD_TOL = 1e-3


def one_step(rank, device, precision, chunks=1, tp=1):
    """Loss and flat gradient of one training step of the seeded flagship
    scorer on a seeded batch at ``precision`` (K4's arithmetic): as ``rank``
    (only rank 0 returns the gradient), with ``tp`` > 1 on a grid of
    ``world / tp`` data x ``tp`` model ranks (the gradient gathered whole),
    or on ``device`` alone, its forward in ``chunks`` blocks of rows as
    ``chunks`` data ranks would split it (each block's dropout masks cut
    from the whole batch's draw)."""
    import torch

    from chip_smoke import CLIP, DIMS_DIFF, DIMS_RAW, SEED
    from video_gen_evals_tpu_torch.core.config import TrainConfig
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.parallel import make_grid
    from video_gen_evals_tpu_torch.train.step import _DROPOUT, TrainStep, loss_components, seeded_generator

    cfg = TrainConfig()
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF, dropout=cfg.dropout),
                              generator=torch.Generator().manual_seed(SEED)).to(device)
    if tp > 1:
        rank = make_grid(rank, n_model=tp)
        model.shard_(rank.model)
    ts = TrainStep(model, cfg.lr, 100, hard_weight=cfg.hard_negative_weight, precision=precision, seed=SEED,
                   rank=rank)
    g = torch.Generator().manual_seed(SEED)
    feats = torch.randn(cfg.batch_size, CLIP, model.config.input_dim, generator=g).to(device)
    labels = torch.arange(cfg.P).repeat_interleave(cfg.K).to(device)
    model.train()
    stacked = ts.stack(feats)
    n, per = stacked.shape[0], stacked.shape[0] // chunks
    if chunks == 1:
        emb = ts.embed(stacked, precision, seeded_generator(SEED, 0, _DROPOUT, device))
    else:
        emb = torch.cat([model(stacked[lo:lo + per], precision, rows=(lo, n),
                               generator=seeded_generator(SEED, 0, _DROPOUT, device))[0]
                         for lo in range(0, n, per)])
    total = sum(loss_components(emb, labels, ts.hard_weight).values())
    total.backward()
    if rank is not None:
        ts._sum_gradients()
    grads = [p.grad if model.tp is None else model.tp.gather(n, p.grad) for n, p in model.named_parameters()]
    grad = torch.cat([g.reshape(-1) for g in grads]).cpu()
    return total.item(), grad if rank is None or rank.is_primary else None


def _steps_rank(rank, tp=1):
    return {precision: one_step(rank, rank.device, precision, tp=tp) for precision in ("highest", "default")}


def _zero_launch_counts() -> None:
    """The counts ``ops.launch_counts`` reads, set to 0 before each in-process run."""
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
    from video_gen_evals_tpu_torch.ops.conv_kernel_train import fused_temporal_block_train
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows

    gather_windows.launches = fused_temporal_block.launches = 0
    fused_temporal_block_train.launches = fused_temporal_block_train.launches_bwd = 0


def _step_diff(a, b):
    """(loss relative, max |d gradient| / max |gradient|, share of gradients whose sign differs,
    ||d gradient|| / ||gradient||)."""
    (la, ga), (lb, gb) = a, b
    return (abs(la - lb) / abs(lb), float((ga - gb).abs().max()) / float(gb.abs().max()),
            float(((ga > 0) != (gb > 0)).float().mean()), float((ga - gb).norm() / gb.norm()))


def _worst(a, b, names, k=3):
    """The ``k`` parameters whose gradients differ most, relative to the largest |gradient|."""
    ga, gb = a[1], b[1]
    scale, out, lo = float(gb.abs().max()), [], 0
    for name, n in names:
        out.append((float((ga[lo:lo + n] - gb[lo:lo + n]).abs().max()) / scale, name))
        lo += n
    return ", ".join(f"{name} {d:.2e}" for d, name in sorted(out, reverse=True)[:k])


def main() -> int:
    import torch

    if torch.cuda.device_count() < 2:
        print("torch_parallel_cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    from chip_smoke import DIMS_DIFF, DIMS_RAW, _check, _events, _write_tree
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.core.config import PathsConfig, TrainConfig
    from video_gen_evals_tpu_torch.data import scan_generated_flat
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library
    from video_gen_evals_tpu_torch.parallel import launch_local
    from video_gen_evals_tpu_torch.pipelines.merge_scores import SCORE_ATOL, SCORE_RTOL
    from video_gen_evals_tpu_torch.pipelines.score import main as score_main
    from video_gen_evals_tpu_torch.pipelines.train_cli import main as train_main

    n = torch.cuda.device_count()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    lib = load_library()   # the ranks load this build
    print(f"{n} cards; kernel build {lib.build_seconds:.1f} s")
    dev = torch.device("cuda", 0)
    grids = [(n, 1), (1, n)] + ([(n // 2, 2)] if n % 2 == 0 and n > 2 else [])
    ones = {p: one_step(None, dev, p) for p in ("highest", "default")}
    with torch.device("meta"):
        shapes = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF))
    names = [(k, p.numel()) for k, p in shapes.named_parameters()]
    for n_data, tp in grids:
        t0 = time.perf_counter()
        ranked = launch_local(n, _steps_rank, tp, device="cuda")[0]
        grid = f"--dp {n_data} --tp {tp}"
        grad_tol = STEP_GRAD_TOL if tp == 1 else TP_STEP_GRAD_TOL
        for precision in ("highest", "default"):
            one, alike = ones[precision], one_step(None, dev, precision, chunks=n_data)
            d_alike, d_one = _step_diff(ranked[precision], alike), _step_diff(ranked[precision], one)
            print(f"one step at {precision} ({grid}), {one[1].numel()} gradients, {n} ranks against their data "
                  f"shards' rows on one card: loss {d_alike[0]:.2e} relative, gradients within {d_alike[1]:.2e} "
                  f"of max |g| ({d_alike[3]:.2e} in norm), {d_alike[2]:.2e} change sign; against the whole batch "
                  f"on one card: {d_one[0]:.2e}, {d_one[1]:.2e} ({d_one[3]:.2e}), {d_one[2]:.2e} (the rows on one "
                  f"card against the whole batch: {_step_diff(alike, one)[1]:.2e}); most apart: "
                  f"{_worst(ranked[precision], alike, names)}")
            _check(d_alike[0] <= STEP_LOSS_RTOL and d_alike[1] <= grad_tol,
                   f"the step on {n} ranks ({grid}) at {precision} differs from their rows on one card "
                   f"(tol {grad_tol:g})")
            if precision == "highest":
                _check(d_one[0] <= STEP_LOSS_RTOL and d_one[1] <= grad_tol,
                       f"the fp32 step on {n} ranks ({grid}) differs from one rank (tol {grad_tol:g})")
        print(f"{grid}: launch and both steps in {time.perf_counter() - t0:.1f} s; gradients held to {grad_tol:g}")
    with tempfile.TemporaryDirectory() as root:
        mesh_root, kp_root, gen_dir, gen_kp = _write_tree(root, videos_per_class=5,
                                                          frames=(248, 256, 240, 252, 244))
        human_path = os.path.join(root, "human.json")
        with open(human_path, "w") as f:
            json.dump({f"{os.path.splitext(it.name)[0]}.mp4": {"ac": float(i % 5), "tc": float(-(i % 7))}
                       for i, it in enumerate(scan_generated_flat(gen_dir).items)}, f)
        runs = {}
        for ranks, extra in ((1, []), (n, ["--dp", str(n)])):
            cfg = TrainConfig(paths=PathsConfig(real_meshes_dir=mesh_root, real_kp_dir=kp_root,
                                                generated_meshes_dir=gen_dir, gen_kp_dir=gen_kp,
                                                human_scores=human_path),
                              epochs=2, save_dir=os.path.join(root, f"SAVE_{ranks}"))
            path = os.path.join(root, f"train_{ranks}.json")
            cfg.to_json(path)
            _zero_launch_counts()
            t0 = time.perf_counter()
            done = train_main(["--config", path, "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
            for r in done:
                k = r["launches"]
                print(f"train {ranks} rank(s), rank {r['rank']}: launches K4 forward "
                      f"{k['fused_temporal_block_train']}, backward {k['fused_temporal_block_train_bwd']}, "
                      f"K1 {k['gather_windows']}, K3 {k['fused_temporal_block']}")
            runs[ranks] = (_events(done[0]["save_dir"]), done[0]["best_ckpt"], wall)
        for kind, key in (("train_epoch", "loss"), ("eval_loss", "loss"), ("centroid_distance", "avg")):
            a = [e[key] for e in runs[1][0] if e["event"] == kind]
            b = [e[key] for e in runs[n][0] if e["event"] == kind]
            _check(len(a) == len(b) == 2 and all(map(math.isfinite, a + b)), f"{kind}: {a} vs {b}")
            print(f"{kind}: 1 rank {a}, {n} ranks {b}, relative {[abs(y - x) / abs(x) for x, y in zip(a, b)]}")
        clips = {r: [e for e in runs[r][0] if e["event"] == "train_epoch"][1]["clips_per_sec"] for r in (1, n)}
        print(f"train CLI, 2 epochs at TrainConfig defaults: 1 rank {runs[1][2]:.1f} s, {clips[1]:.1f} clips/s "
              f"(second epoch); {n} ranks {runs[n][2]:.1f} s, {clips[n]:.1f} clips/s")

        scores, walls = {}, {}
        for ranks, extra in ((1, []), (n, ["--mesh-data", str(n)])):
            out = os.path.join(root, f"scores_{ranks}.json")
            _zero_launch_counts()
            t0 = time.perf_counter()
            done = score_main(["--generated-meshes", gen_dir, "--real-meshes", mesh_root, "--checkpoint",
                               runs[1][1], "--real-kp-dir", kp_root, "--gen-kp-dir", gen_kp, "--output", out,
                               "--no-bug-compat", "--device", "cuda", *extra])
            walls[ranks] = time.perf_counter() - t0
            for r in done:
                print(f"score {ranks} rank(s), rank {r['rank']}: launches K1 {r['launches']['gather_windows']}, "
                      f"K3 {r['launches']['fused_temporal_block']}")
            with open(out) as f:
                scores[ranks] = json.load(f)
        _check(sorted(scores[1]) == sorted(scores[n]), "the score runs scored different videos")
        d = 0.0
        for vid, entry in scores[1].items():
            for m, v in entry.items():
                _check(math.isclose(scores[n][vid][m], v, rel_tol=SCORE_RTOL, abs_tol=SCORE_ATOL),
                       f"{vid} {m}: {scores[n][vid][m]} vs {v}")
                d = max(d, abs(scores[n][vid][m] - v))
        print(f"score CLI on the trained checkpoint: 1 rank {walls[1]:.1f} s, --mesh-data {n} {walls[n]:.1f} s "
              f"(rank start, host stats and banks included); {len(scores[1])} videos, max |d| {d:.2e}")
    for card in cards:
        print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
