#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``video_gen_evals_tpu_torch``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

1. Card: name and power limit (nvidia-smi), and the build of the Hopper
   kernels from ``video_gen_evals_tpu_torch/csrc`` (nvcc, sm_90a).
2. Each kernel against its plain PyTorch version at its main path's
   shapes: the window gather (K1) on a 64-video x 128-row x 2596 bank at
   B=512 must be bitwise equal; the fused conv stage (K3) at [512, 32, 256],
   dilations 1/2/4/8, within 1e-4 ("highest") and 5e-4 ("high") of the fp32
   plain version; the trainable stage (K4) forward and backward at
   [960, 32, 256], dilations 1/2/4/8, with a seeded keep mask (keep 0.9) and
   without, at "highest" and at "default" against the plain version of the
   same precision (tolerances at K4_TOL), and two backward calls on the same
   inputs bitwise equal; each backward split into its three launches by
   torch.profiler at every dilation; the ptxas line of the forward's kernel
   at "highest" (K3's fma_block_kernel, with the mask). Milliseconds per call of kernel and plain from CUDA
   events (plain, kernel, kernel, plain), each kernel's bound from its shapes
   and the card's data-sheet peaks and the kernel's share of it, and the
   time of one library call where one computes the same function (for K1
   and K2 none does: ``bank[rows]`` is printed beside them as a note, its
   index precomputed outside the timing and without row 0's override).
3. End to end: the scoring CLI at the flagship width (5 modalities, 2596-d
   input, d_model 256, 4 layers, 8 heads, clip 32, stride 8, batch 512) on a
   synthetic tree (10 classes x 4 real videos, 20 generated) with seeded
   weights saved as a reference-layout .pt, at --precision high and highest
   on the card, and at highest on the CPU, where the plain versions of the
   kernels run. Every video's AC and TC must be finite, the two card runs
   must agree within 1e-3, the card's highest run must agree with the CPU
   run within 1e-4, and the launch counts must match the number of batches.
   Then the per-window route on the same tree and weights: the real train
   split's and the generated banks swept by WindowEncoder.encode_bank at
   "high" (K1 and K3 launched once and 40 times a batch), centroids by
   build_centroids and per-video AC and TC by video_ac_scores and
   video_tc_scores on the card, within 1e-5 of score_bank's segment sums on
   the same banks; build_centroids twice bitwise equal. Then
   apply_with_attention on one batch of generated windows at "highest": the
   fusion attention map's rows sum to 1 within 1e-6, the outputs are bitwise
   model(x, "highest") on the card, and map and outputs agree with the CPU
   within 1e-4.
4. Throughput of the WindowEncoder sweep at batch 256 and 512 on a
   64 x 120-frame bank. Then the same sweep at "high", batch 512, under the
   fused forwards of models/fused_apply.py: encoder_impl block_kernel (K3)
   and chain_kernel (K10, 4 stages) through WindowEncoder, and
   block_kernel_forward's chain2 (K10, 2 stages) and stacked (K9) through
   the same sweep written out here, the stacked one gathering through K2 and
   once with attn_impl "core" (K6 at "high"), and the module forward with
   attention_impl "pallas" (K8 at "highest") and "pallas_bf16" (K8 at
   "default"). Each arm's launch counts set to 0 before one sweep and read
   after it, its AC and TC within 1e-4 of the module forward's (2e-2 for
   pallas_bf16), windows/s.
5. Training: the train CLI at full width (TrainConfig defaults: P = 10,
   K = 24, so 960 stacked windows and 40 K4 forward and backward calls a
   step) on a synthetic tree (10 classes x 5 real videos, 20 generated, a
   synthetic MOS file), 2 epochs of 4 steps. Every logged loss finite, the
   launch counts of K4, K1 and K3 as the epochs' steps and eval passes give
   them, the parameters changed, every event kind in metrics.jsonl, the best
   .pt scored by the score CLI, and a run resumed from the first epoch's
   checkpoint bitwise equal to the 2-epoch run. Then one step at "highest"
   with dropout 0 and K = 4 on the card against the plain versions on the
   CPU, loss components within 1e-3. Steps/s and clips/s of the second epoch.

6. The attention kernels (K6 mha_core, K7 mha_head_batched, K8
   flash_attention) against their plain versions at the ViT-H shape
   (B = 32, N = 192, 16 heads of 80; q, k, v as slices of one qkv buffer,
   which K7 also reads in place: bitwise K6's result) in fp32 at "highest"
   (2e-5) and in bf16 at "default" (0.03), K6 at "high" (5e-5); at N = 100
   and 300 (K8 with 64-key blocks at ViT-H's width, K6 and K7 at widths 80
   and 32); at the scorer's [512, 33, 256] with 8 heads (K6 at all three
   precisions, K7 and K8 at "highest" and "default"). ms per call, the
   bound and the kernel's share of it, and F.scaled_dot_product_attention
   on the same tensors (cast to bf16 for "default") as the library time;
   K6 at "high" (bf16x3, bound by its bytes) is held against SDPA on the
   fp32 tensors, which runs 3xTF32 and agrees with it within "high"'s
   tolerance.
   Then K2 (gather_windows_subblock: bitwise equal to its plain version on a
   B = 512 x 32 x 2596 gather with a window clipped to an unaligned start,
   where it must differ from K1), K9 (fused_temporal_block_stacked over 10
   chains of [512, 32, 256], dilations 1/2/4/8; bitwise K3 "high" chain by
   chain, and timed beside ten K3 "high" launches) and K10
   (fused_temporal_chain over one chain's 4 stages, and the two halves of
   chain2) against their plain versions at "high" (FUSED_TOL), with ms,
   bound and library time as in phase 2.
7. The mesh-recovery stage at full width: ViT-H (depth 32, width 1280) and
   the SMPL token head at its published geometry, weights drawn on the card
   from a seed, one synthetic 72-frame 360 x 640 video with seeded boxes
   (some blurred by the anti-alias branch, some not) through
   Extractor.process_video with attention_impl "core" and frame_batch 32 (two
   full chunks and a padded tail). Shapes, dtypes, finite values, rotations
   orthonormal within 1e-4, K6 launched depth x chunks times, token_out
   within 1e-3 of the same run with attention_impl "plain". Then
   "head_batched" and "flash" through the same entry at depth 4 against
   "plain"; the card against the CPU's plain versions at depth 2 on 4 frames
   (1e-3); the bf16 fast mode at full depth and at depth 4 for K7 and K8
   against the fp32 run (BF16_STAGE_TOL); the mesh dict written with
   save_video_npz and read back by the scoring path's loader. Frames/s and
   ms per chunk (crop, backbone, head) for each attention_impl in fp32 and
   for core, head_batched and flash in the bf16 mode, peak memory.
8. The Faster R-CNN X101-32x8d-FPN detect stage at full width (weights drawn
   on the card from a seed) on the same 72-frame video. K5
   (roi_align_pyramid_dma) against its plain version on one detect chunk's
   own packed pyramid and proposals (8 x 1000 ROIs) and on over-span boxes
   of the same buffer (K5_TOL), ms and bound, the kernel's ptxas line, and
   the cells its loads cover beside the union the bound counts.
   Extractor.process_video(frames)
   with mesh_detector "rcnn" and no boxes, ViT-H at full depth,
   keep_all_frames: contract shapes, finite values, K5 launched once a chunk
   (9), K6 as in phase 7; then keep_all_frames=False, whose result is None or
   the frames of the detector's single-person mask. The small config on the
   card against the CPU's plain versions with roi_impl "dma" on both
   (levels, RPN outputs and box_forward logits 1e-4, detections 5e-3).
   Detector frames/s, ms per 8-frame chunk split into resize, backbone + FPN,
   RPN + proposals (NMS apart), pool (K5) and box head + postprocess, peak
   memory. The seeded R-CNN's person logit is raised (RCNN_PERSON_GAIN,
   RCNN_PERSON_BIAS) so that its frames hold person boxes.
9. The detector modes on the same video, weights drawn from the same seed.
   K5's bf16 instantiation against its plain version on a detect chunk's own
   levels cast to bf16 with RCNNConfig.fast()'s proposals (window 32) and on
   phase 8's over-span boxes (K5_TOL), ms and bound, ptxas line and cells
   loaded, as in phase 8. process_video(frames)
   with no boxes under fast() in fp32 and in the bf16 mode, and under the
   exact R-CNN in the bf16 mode, ViT-H at full depth: contract shapes, K5
   launched once a chunk in the pyramid's type and never in the other, K6
   as in phase 7, and the detect stage's boxes against phase 8's exact fp32
   run (MODE_IOU, MODE_FLIPS); detector frames/s and the chunk's split for
   each. Then the default mesh_detector "yolox" at DetectorConfig.yolox_l()
   (Megvii's YOLOX-L, 54.1 M parameters, weights drawn on the card):
   process_video(frames) with keep_all_frames (contract, K6, finite boxes)
   and without (None or the frames of the detector's single mask), frames/s,
   ms per 32-frame chunk split into letterbox, detector and postprocess (NMS
   apart), peak memory; the small YOLOX on the card against the CPU (raw
   outputs within 1e-4 of scale, equal detections).
10. The keypoint branch and what needs it, on the same video, every net drawn
   on the card from a seed: DWPose-L (RTMPose-l at its published geometry:
   384 x 288 crops, 133 keypoints, deepen and widen 1.0, GAU 256 / s 128, 576 x
   768 SimCC bins) with YOLOX-L, ViT-H at depth 32 and the SMPL head.
   process_video_keypoints (kp120 [72, 120] float32, valid [72] bool, each
   keypoint -1 or inside its pose crop's window); process_video_full with
   keypoints and keep_all_frames in the yolox mode (YOLOX once a 32-frame chunk
   for both branches, counted by a forward hook, K6 32 a chunk) and in the
   rcnn mode (the exact R-CNN 9 times, K5 9 times, YOLOX 3 times, K6 96
   times, kp120 bitwise the yolox mode's), then without keep_all_frames
   ((None, None) or the frames of the single-person mask); the CPU tests'
   small pose net on the card against the CPU on 4 frames (logits within
   POSE_LOGIT_TOL of scale, keypoints equal where the top-two gap allows);
   DWPose-L's bf16 mode against fp32 on one chunk's crops (POSE_BF16_TOL in L2
   norm, the share of keypoints within one bin and the largest move);
   process_videos_streamed over 72 + 72 frames of 360 x 640 and 48 of 288 x
   512 against process_video_full a video; run_tree on a .npy tree of 2
   actions x 3 videos with one corrupt (counts, the error ledger, a resumed
   run, every npz and keypoints.npy read back by the scoring loader as the
   five modalities, RUN_CONFIG.json), and the extract CLI's main at its
   defaults on the same tree (only the corrupt video an error);
   score_videos_end_to_end over 4 videos with a seeded flagship scorer (AC and
   TC finite, K1 and K3 launched once and 40 times a batch, extract_s, bank_s
   and score_s). Times: the keypoint branch's frames/s and a 32-frame chunk
   split into detect, pose crop, pose backbone, pose head + decode, and
   backmap + postprocess; process_video_full frames/s with keypoints in the
   yolox and rcnn modes at fp32 and in the bf16 mode, peak memory. The
   phase's K5, K6, K1 and K3 launch counts are printed before the kernels
   line. Phases 5 and 10 leave their trees and outputs for phase 11.
11. Parallelism and reporting (parallel/, utils/cli.py, merge_scores,
   leaderboard, human/mos.py): (a) an NCCL group of one on the card,
   all_gather_rows forward and backward, all_reduce_sum, broadcast_ and a
   barrier leaving every value as it was; (b) the train CLI with --dp 2
   --device cuda on phase 5's tree at TrainConfig defaults, two ranks
   sharing the card through gloo (printed by each rank): every epoch's
   train, eval and centroid loss within rtol 2e-3 of phase 5's one-rank run,
   each rank's K4 forward, K4 backward, K1 and K3 launches as its rows and
   its share of the eval batches give them, clips/s; (c) the score CLI on
   phase 5's trained checkpoint with --mesh-data 2, and with --num-hosts 2
   --host-id 0 and 1 merged by merge_scores, every AC and TC within
   SCORE_ATOL / SCORE_RTOL of phase 5's one-rank scores, K1 and K3 per rank;
   (d) the extract CLI at its defaults over phase 10's tree, one video at a
   time, as --num-hosts 2 (two runs in turn) and --mesh-data 2 against a
   one-rank run (ledger entries equal, and equal to phase 10's; files within
   phase 10's tolerances, bitwise or not said), then run_tree with
   keep_all_frames (a file for every video) the same three ways, K6 per
   rank; (e) the leaderboard CLI on (c)'s merged scores and the MOS CLI on
   seeded ratings of the same videos, correlated by merge_scores. The
   phase's seconds.
12. The bank layer and the CLIs' last flags, on phase 5's tree and
   checkpoint: (a) the score CLI with --bank-cache cold, then warm (3 cache
   hits printed), scores bitwise phase 5's uncached run; (b) --gather-impl
   take, sliced and burst on the warm cache, bitwise the same; (c)
   --dump-features: the JAX keys, seq_embeds and window_tc bitwise a sweep
   of the cached generated bank; (i) the checkpoint as the JAX package's
   path-keyed .npz, bitwise the .pt's scores; (d) K3 at "default" (K4's
   tensor-core forward body, no mask) against its plain versions at
   [512, 32, 256], d = 1/2/4/8 (K3_TOL against fp32, K4_TOL's "default"
   forward bound against plain "default"), ms, plain ms and bound, the score
   CLI at --precision default (K1 and K3 launched once and 40 times a
   batch) against --precision highest (BF16_SWEEP_TOL), and the sweep's
   windows/s at "default" and "high"; (h) profiling.trace around one sweep,
   whose Chrome trace names K1's and K3's kernels; (g) native_npz.reader()
   "native", every npz of the tree bitwise numpy's, the host bank build's
   seconds with each reader; (f) the train CLI with --bank-cache cold and
   warm (3 hits, losses bitwise) at --conv-impl kernel, then module (losses
   within BF16_SWEEP_TOL); (e) score_videos_end_to_end with
   bank_impl="device" (the bank a CUDA tensor) against "host" on config 4,
   within 1e-3, bank_s of both. The phase's seconds.
13. The last two paths: (a) the legacy crops (batched_person_crops,
   crop_scale 1.2, matmul and gather, at ViT-H's 256 x 192 and DWPose-L's
   384 x 288) on the card against the CPU within 1e-3 in 0-255 units, ms a
   32-frame chunk; (b) process_video_full(with_keypoints=True) with
   preproc="legacy" in the yolox and rcnn modes at phase 10's full width in
   fp32, keep_all_frames (contract shapes, K6 32 a chunk, K5 once a detect
   chunk, kp120 finite), frames/s, then the reference's rule; (c) the
   extract CLI with --preproc legacy over phase 10's tree (RUN_CONFIG.json
   legacy, not parity); (d) the train CLI with --tp 2 on phase 5's tree, two
   ranks sharing the card through gloo, 2 epochs: train and eval losses
   within TP_LOSS_RTOL of phase 5's --tp 1 run epoch by epoch, each rank's
   K4, K1 and K3 launches, clips/s, the gathered best checkpoint scored by
   the score CLI and written as the JAX package's .npz, and a --tp 2 run
   resumed from epoch 0's checkpoint bitwise the uninterrupted one. The
   phase's seconds.

Then the smoke's wall time, a JSON line listing the kernels, the card's name
and power limit, and as the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

DIMS_RAW = {"vit": 1024, "global": 9, "pose": 207, "beta": 10, "kp2d": 120}
DIMS_DIFF = {"vit": 1024, "global": 3, "pose": 69, "beta": 10, "kp2d": 120}
CLIP, STRIDE, BATCH = 32, 8, 512
TRAIN_WINDOWS = 960   # one training step's stacked batch: 4 x P x K = 4 x 10 x 24
SEED = 0
# NVIDIA H100 SXM data sheet, dense: fp32 outside tensor cores, bf16 tensor
# cores, device memory
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
# K4 against its plain version of the same precision, both on the card:
# (forward atol, gradient tol). A gradient g passes when |g - plain| <=
# tol * max(1, max|plain|) + tol * |plain|: the order of the sums differs, and
# a weight-gradient element sums 30720 products, so one that cancels to near
# zero carries the rounding of the whole sum. At "default" an intermediate on
# a bf16 rounding boundary can round the other way in the kernel than in the
# plain version, a relative step of 2^-8 in one operand.
K4_TOL = {"highest": (1e-4, 5e-4), "default": (1e-2, 2e-2)}
# attention kernels against their plain versions of the same precision, on
# the card: fp32 sums in another order (tests/test_attention.py's 2e-5); with
# bf16 operands a p or an output on a rounding boundary can round the other
# way, a step of 2^-8 relative; at "high" (bf16x3) each product carries about
# 2^-16 relative, and kernel and plain version split a p that differs in its
# last bits
ATTN_TOL = {"highest": 2e-5, "high": 5e-5, "default": 0.03}
VIT_B, VIT_N, VIT_H, VIT_HD = 32, 192, 16, 80   # one ViT-H layer of one 32-frame chunk
# the bf16 fast mode against the fp32 run on the same weights: max |d token_out|
# over the video, relative to max |token_out|. bf16 keeps 8 bits through 32
# residual blocks and 6 decoder layers of random weights; measured 0.013 at
# depth 32 and 0.017 at depth 4 on an H100.
BF16_STAGE_TOL = 0.05
MESH_FRAMES, MESH_HW = 72, (360, 640)
# K5 against its plain version, both on the card: fp32 sums of up to 48 x 56
# taps a bin in another order; relative to max(1, max |plain|), so 2e-5 on
# unit-scale features (the seeded detector's FPN levels are of order 10)
K5_TOL = 2e-5
RCNN_BATCH = 8   # ExtractorConfig.rcnn_frame_batch
# the pose net's SimCC logits on the card against the CPU: fp32 sums in another
# order, relative to max(1, max |logit|) (the CPU tests' tolerance against JAX)
POSE_LOGIT_TOL = 1e-4
# DWPose-L's SimCC logits in the bf16 mode against fp32, ||d|| / ||logits||
# over a chunk: bf16 keeps 8 bits through each of the backbone's ~90
# convolutions and the error accumulates (0.053-0.077 measured on the CPU for
# the seeded DWPose-L on this video's crops, two seeds; the max-norm ratio that
# BF16_STAGE_TOL bounds for ViT-H's residual stream read 0.11-0.32 there, set
# by single outlying logits)
POSE_BF16_TOL = 0.15
# K9 and K10 against their plain versions at "high", both on the card, and a
# fused forward's AC and TC against the module forward's: bf16x3 on both
# sides, the sums in another order (measured 2e-5 to 6e-5 on an H100)
FUSED_TOL = 1e-4
# the sweep's AC and TC with the temporal transformer's attention in K8 at
# "default" against the module forward's fp32 attention: q, k, v and p are
# rounded to bf16 (2^-9 relative each) in each of the 4 layers, and AC and TC
# are cosines of the L2-normalized embeddings, so they move by a few 2^-9
BF16_SWEEP_TOL = 2e-2


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# the bool template arguments of the attention kernels, in order
_ATTN_FLAGS = {"attention_fma_kernel": ("split", "flash"), "attention_resident_kernel": ("flash",)}
# the multi-window conv kernels: the tensor-core ones (K3 and K10 at "high", K4's
# forward and backward at "default") and the FMA ones (K3 and K4's forward and
# backward at "highest"); every instantiation's ptxas line is printed, and
# K5's (roi_align_kernel, by cell type and load width)
_TC_KERNELS = ("temporal_block_high_kernel", "temporal_chain_tc_kernel", "train_fwd_tc_kernel",
               "train_bwd_tc_kernel", "tap_grad_tc_kernel", "fma_block_kernel",
               "train_bwd_fma_kernel", "tap_grad_fma_kernel", "roi_align_kernel")


def _ptxas_summary(log: str):
    """One line per compiled kernel: registers and spills (nvcc -Xptxas -v)."""
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
            continue
        if name and "spill stores" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            ra = re.search(r"roi_align_kernelI(f|13__nv_bfloat16)Lb([01])E", name)
            tc = re.search(r"\d+([a-z_]+kernel)ILi(\d+)ELi(\d+)EE", name)
            a = re.search(r"\d+([a-z_]+kernel)ILi(\d+)E((?:Lb[01]E)*)", name)
            g = re.search(r"\d+([a-z_]+kernel)", name)
            flags = "".join(f", {k}={b}" for k, b in zip(_ATTN_FLAGS.get(a.group(1), ()),
                                                         re.findall(r"Lb([01])E", a.group(3)))) if a else ""
            short = (f"roi_align_kernel<{'float' if ra.group(1) == 'f' else 'bf16'}, vec16={ra.group(2)}>" if ra
                     else f"{tc.group(1)}<T={tc.group(2)}, C={tc.group(3)}>" if tc
                     else f"{a.group(1)}<C={a.group(2)}>" if a and a.group(1) in _TC_KERNELS
                     else f"{a.group(1)}<hd={a.group(2)}{flags}>" if a
                     else g.group(1) if g else name)
            yield f"{short}: {m.group(1)} registers; {spill}"
            name = None


def _ptxas_line(prefix: str) -> str:
    """The ptxas line of the built kernel whose summary starts with
    ``prefix`` (a kernel instantiated in two sources prints alike in both)."""
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library

    lines = [line for line in _ptxas_summary(load_library().build_log) if line.startswith(prefix)]
    return lines[0] if lines else f"{prefix}: not in this process's build log (the library was loaded, not built)"


def _time_ms(fn, iters: int) -> float:
    """Milliseconds per call over ``iters`` calls, warm, from CUDA events."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _interleaved_ms(kernel, plain, iters: int):
    """plain, kernel, kernel, plain; the mean of each pair."""
    p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _device_split(torch, fn, iters):
    """Device ms a call and launches a call of each kernel ``fn`` runs
    (torch.profiler), largest first; empty when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.count > 0:
            rows.append((us / 1e3 / iters, e.count / iters, e.key))
    return sorted(rows, reverse=True)


def _conv_fmas(windows: int, t_len: int, channels: int, dilation: int) -> int:
    """FMAs of one k=5 dilated conv over ``windows`` windows: a tap at offset
    o touches the t_len - |o| rows whose input row lies inside the window."""
    rows = sum(max(0, t_len - abs((j - 2) * dilation)) for j in range(5))
    return windows * rows * channels * channels


def _bound(nbytes: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _conv_stage_bound(windows, t_len, channels, n_convs, act_tensors, w_tensors, flops_per_fma, peak):
    """Mean over dilations 1/2/4/8 of a conv stage's bound: ``n_convs``
    conv-sized products, ``act_tensors`` [B, T, C] and ``w_tensors`` [5, C, C]
    fp32 tensors read or written once."""
    nbytes = 4 * (act_tensors * windows * t_len * channels + w_tensors * 5 * channels * channels)
    bounds = [_bound(nbytes, flops_per_fma * n_convs * _conv_fmas(windows, t_len, channels, d), peak)
              for d in (1, 2, 4, 8)]
    return sum(b[0] for b in bounds) / 4, bounds[0][1]


# K3 against its plain fp32 version, by precision: fp32 sums in another order
# ("highest"), bf16x3 products ("high"), bf16 operands ("default": each conv's
# input and weights rounded, 2^-9 relative each, through two convs and GELU;
# against the plain "default" version K4_TOL's "default" forward bound holds)
K3_TOL = {"highest": 1e-4, "high": 5e-4, "default": 0.05}


def _k3_rows(torch, dev, gen, precisions):
    """K3 at [512, 32, 256], dilations 1/2/4/8, against its plain versions:
    the max error against plain fp32 (K3_TOL) and against the plain version
    of the same precision (at "default", K4_TOL's forward bound), ms of
    kernel and plain (plain, kernel, kernel, plain), the bound. Returns the
    kernels line's entries."""
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block, fused_temporal_block_plain

    C = 256
    x = torch.randn(BATCH, CLIP, C, generator=gen).to(dev)
    w1, w2 = ((torch.randn(5, C, C, generator=gen) / math.sqrt(5 * C)).to(dev) for _ in range(2))
    gs = (1.0 + 0.1 * torch.randn(C, generator=gen)).to(dev)
    gb = (0.1 * torch.randn(C, generator=gen)).to(dev)
    results = {}
    for precision in precisions:
        errs, errs_same, kms, pms = [], [], [], []
        for d in (1, 2, 4, 8):
            got = fused_temporal_block(x, w1, w2, gs, gb, d, precision)
            ref32 = fused_temporal_block_plain(x, w1, w2, gs, gb, d, "highest")
            same = fused_temporal_block_plain(x, w1, w2, gs, gb, d, precision)
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(got).all()), f"K3 {precision} d={d}: non-finite output")
            errs.append((got - ref32).abs().max().item())
            errs_same.append((got - same).abs().max().item())
            _check(errs[-1] <= K3_TOL[precision],
                   f"K3 {precision} d={d}: max |kernel - plain fp32| {errs[-1]:.3e} > {K3_TOL[precision]}")
            if precision == "default":
                _check(errs_same[-1] <= K4_TOL["default"][0],
                       f"K3 default d={d}: max |kernel - plain default| {errs_same[-1]:.3e} > "
                       f"{K4_TOL['default'][0]}")
            k, p = _interleaved_ms(lambda: fused_temporal_block(x, w1, w2, gs, gb, d, precision),
                                   lambda: fused_temporal_block_plain(x, w1, w2, gs, gb, d, precision), 20)
            kms.append(k)
            pms.append(p)
        print(f"K3 fused_temporal_block[{precision}] [{BATCH}, {CLIP}, {C}] d=1/2/4/8: "
              f"max |kernel - plain fp32| {', '.join(f'{e:.2e}' for e in errs)} (tol {K3_TOL[precision]}); "
              f"vs plain {precision} {', '.join(f'{e:.2e}' for e in errs_same)}; "
              f"kernel ms {', '.join(f'{m:.3f}' for m in kms)}; plain ms {', '.join(f'{m:.3f}' for m in pms)}")
        # x in, out, w1, w2; "high" is three bf16 products per term, "default" one
        bound_ms, bound_by = (_conv_stage_bound(BATCH, CLIP, C, 2, 2, 2, 2, PEAK_FP32)
                              if precision == "highest"
                              else _conv_stage_bound(BATCH, CLIP, C, 2, 2, 2, 6 if precision == "high" else 2,
                                                     PEAK_BF16))
        print(f"   bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes the fused stage")
        results[f"fused_temporal_block[{precision}]"] = dict(
            max_abs_err=max(errs_same if precision == "default" else errs), ms=sum(kms) / 4,
            plain_ms=sum(pms) / 4, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return results


def phase_kernels(torch, dev, gen):
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows, gather_windows_plain

    results = {}
    # K1: 64 videos x 128 rows x 2596, B = 512, enumerated and clipped starts
    V, rows, D = 64, 128, sum(DIMS_RAW.values()) + sum(DIMS_DIFF.values())
    bank = torch.randn(V * rows, D, generator=gen).to(dev)
    offsets = (torch.arange(V, dtype=torch.int32) * rows).to(dev)
    row_limit = torch.full((V,), rows - 1, dtype=torch.int32).to(dev)
    z0 = torch.randn(sum(DIMS_DIFF.values()), generator=gen).to(dev)
    vi = torch.randint(0, V, (BATCH,), generator=gen, dtype=torch.int32).to(dev)
    st = (torch.randint(0, 13, (BATCH,), generator=gen, dtype=torch.int32) * 8)
    st[::17] = torch.randint(-50, 200, st[::17].shape, generator=gen, dtype=torch.int32)
    args = (bank, offsets, row_limit, z0, sum(DIMS_RAW.values()), vi, st.to(dev), CLIP)
    got, want = gather_windows(*args), gather_windows_plain(*args)
    torch.cuda.synchronize()
    _check(got.shape == (BATCH, CLIP, D), f"gather output shape {tuple(got.shape)}")
    _check(torch.equal(got, want), "gather kernel differs from its plain version")
    ms, plain_ms = _interleaved_ms(lambda: gather_windows(*args), lambda: gather_windows_plain(*args), 50)
    # no single PyTorch call computes the gather (the per-video row_limit
    # clamp, row 0's diff override); one advanced-index call over an index
    # precomputed outside the timing, without the override, is a note only
    row_idx = (offsets[vi.long()].long() + st.to(dev).long().clamp(0, rows - CLIP))[:, None] \
        + torch.arange(CLIP, device=dev)[None, :]
    note_ms = _time_ms(lambda: bank[row_idx], 50)
    gbs = 2 * BATCH * CLIP * D * 4 / (ms * 1e-3) / 1e9
    bound_ms, bound_by = _bound(2 * BATCH * CLIP * D * 4 + 2 * BATCH * 4, 0.0, PEAK_FP32)
    print(f"K1 gather_windows [{BATCH}, {CLIP}, {D}] from a {V}x{rows}x{D} bank: bitwise equal; "
          f"kernel {ms:.4f} ms ({gbs:.0f} GB/s moved), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {bound_ms / ms:.1%} of it); library: none, no single call computes the clamped "
          f"gather with row 0's override (note: bank[rows] {note_ms:.4f} ms, index precomputed outside "
          f"the timing, no override)")
    results["gather_windows"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, library_ms=None)

    # K3: [512, 32, 256], d in 1/2/4/8, both precisions, against plain fp32
    results.update(_k3_rows(torch, dev, gen, ("highest", "high")))
    results.update(phase_train_kernels(torch, dev, gen))
    return results


def phase_train_kernels(torch, dev, gen):
    """K4 forward and backward against their plain versions at [960, 32, 256]."""
    from video_gen_evals_tpu_torch.ops.conv_kernel_train import (
        fused_temporal_block_train, fused_temporal_block_train_bwd_plain,
        fused_temporal_block_train_plain)

    B, C = TRAIN_WINDOWS, 256
    x = torch.randn(B, CLIP, C, generator=gen).to(dev)
    dy = torch.randn(B, CLIP, C, generator=gen).to(dev)
    w1, w2 = ((torch.randn(5, C, C, generator=gen) / math.sqrt(5 * C)).to(dev) for _ in range(2))
    gs = (1.0 + 0.1 * torch.randn(C, generator=gen)).to(dev)
    gb = (0.1 * torch.randn(C, generator=gen)).to(dev)
    keep_mask = ((torch.rand(B, CLIP, C, generator=gen) < 0.9).float() / 0.9).to(dev)
    names = ("dx", "dw1", "dw2", "dgamma", "dbeta")

    def kernel_backward(mask, d, precision):
        leaves = [t.detach().requires_grad_() for t in (x, w1, w2, gs, gb)]
        out = fused_temporal_block_train(*leaves, mask, d, precision)
        return out, leaves

    results = {}
    for precision in ("highest", "default"):
        f_tol, g_tol = K4_TOL[precision]
        f_errs, g_errs, g_abs, f_ms, f_pms, b_ms, b_pms = [], [], [], [], [], [], []
        for d in (1, 2, 4, 8):
            for mask in (keep_mask, None):
                tag = f"K4 {precision} d={d} mask={'yes' if mask is not None else 'no'}"
                want = fused_temporal_block_train_plain(x, w1, w2, gs, gb, mask, d, precision)
                want_g = fused_temporal_block_train_bwd_plain(x, w1, w2, gs, mask, dy, d, precision)
                out, leaves = kernel_backward(mask, d, precision)
                got_g = torch.autograd.grad(out, leaves, dy)
                out2, leaves2 = kernel_backward(mask, d, precision)
                again_g = torch.autograd.grad(out2, leaves2, dy)
                torch.cuda.synchronize()
                _check(bool(torch.isfinite(out).all()), f"{tag}: non-finite forward")
                f_errs.append((out - want).abs().max().item())
                _check(f_errs[-1] <= f_tol, f"{tag}: max |forward - plain| {f_errs[-1]:.3e} > {f_tol}")
                for name, g, w, g2 in zip(names, got_g, want_g, again_g):
                    _check(bool(torch.isfinite(g).all()), f"{tag}: non-finite {name}")
                    _check(torch.equal(g, g2), f"{tag}: two backward calls differ in {name}")
                    scale = max(1.0, w.abs().max().item())
                    err = (g - w).abs()
                    _check(bool((err <= g_tol * scale + g_tol * w.abs()).all()),
                           f"{tag}: {name} differs from plain by {err.max().item():.3e} "
                           f"(tol {g_tol} * {scale:.1f} + {g_tol} * |plain|)")
                    g_abs.append(err.max().item())
                    g_errs.append(g_abs[-1] / scale)
            # timed with the mask, as the training step calls it
            k, p = _interleaved_ms(
                lambda: fused_temporal_block_train(x, w1, w2, gs, gb, keep_mask, d, precision),
                lambda: fused_temporal_block_train_plain(x, w1, w2, gs, gb, keep_mask, d, precision), 10)
            f_ms.append(k)
            f_pms.append(p)
            out, leaves = kernel_backward(keep_mask, d, precision)
            k, p = _interleaved_ms(
                lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True),
                lambda: fused_temporal_block_train_bwd_plain(x, w1, w2, gs, keep_mask, dy, d, precision), 10)
            b_ms.append(k)
            b_pms.append(p)
        # forward: x, mask in, out; w1, w2. backward: x, dy, mask in, dx out;
        # w1, w2 in, dw1, dw2 out; six conv-sized products
        peak = PEAK_FP32 if precision == "highest" else PEAK_BF16
        f_bound = _conv_stage_bound(B, CLIP, C, 2, 3, 2, 2, peak)
        b_bound = _conv_stage_bound(B, CLIP, C, 6, 4, 4, 2, peak)
        fmt = lambda v: ", ".join(f"{m:.3f}" for m in v)   # noqa: E731
        print(f"K4 fused_temporal_block_train[{precision}] [{B}, {CLIP}, {C}] d=1/2/4/8, mask and none: "
              f"max |forward - plain {precision}| {max(f_errs):.2e} (tol {f_tol}); "
              f"max |grad - plain| / scale {max(g_errs):.2e} (tol {g_tol}); backward twice: bitwise equal")
        print(f"   forward kernel ms {fmt(f_ms)}; plain ms {fmt(f_pms)}; bound {f_bound[0]:.4f} ms ({f_bound[1]}, "
              f"{f_bound[0] / (sum(f_ms) / 4):.1%} of the mean)")
        print(f"   backward kernel ms {fmt(b_ms)}; plain ms {fmt(b_pms)}; bound {b_bound[0]:.4f} ms ({b_bound[1]}, "
              f"{b_bound[0] / (sum(b_ms) / 4):.1%} of the mean)")
        if precision == "highest":
            print(f"   forward on the FMA body (K3's kernel with the mask): ptxas {_ptxas_line('fma_block_kernel<T=32, C=256>')}")
        # the backward's three launches by torch.profiler (weight preparation's small launches beside)
        for d in (1, 2, 4, 8):
            out, leaves = kernel_backward(keep_mask, d, precision)
            split = _device_split(torch, lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), 5)
            print(f"   backward d={d} device split: " + "; ".join(
                f"{key[:40]} {ms:.4f} ms x{n:g}" for ms, n, key in split[:5]))
        results[f"fused_temporal_block_train[{precision}]"] = dict(
            max_abs_err=max(f_errs), ms=sum(f_ms) / 4, plain_ms=sum(f_pms) / 4,
            bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None)
        results[f"fused_temporal_block_train_bwd[{precision}]"] = dict(
            max_abs_err=max(g_abs), ms=sum(b_ms) / 4, plain_ms=sum(b_pms) / 4,
            bound_ms=b_bound[0], bound_by=b_bound[1], library_ms=None)
    return results


def phase_fused_kernels(torch, dev, gen):
    """K2, K9 and K10 against their plain versions at the fused forwards'
    shapes: K9 over the scorer's 10 chains, K10 over one chain's 4 stages and
    the two halves of chain2, K2 on a sweep-sized bank."""
    from video_gen_evals_tpu_torch.ops.chain_kernel import fused_temporal_chain, fused_temporal_chain_plain
    from video_gen_evals_tpu_torch.ops.conv_kernel import (
        fused_temporal_block, fused_temporal_block_stacked, fused_temporal_block_stacked_plain)
    from video_gen_evals_tpu_torch.ops.window_kernel import (
        gather_windows, gather_windows_subblock, gather_windows_subblock_plain)

    results = {}
    # K2: 64 videos x 128 rows x 2596 bank, B = 512; video 3 has 37 rows, so
    # its windows clip to start 5, no multiple of 8: there K2 reads from row 0
    V, rows, D = 64, 128, sum(DIMS_RAW.values()) + sum(DIMS_DIFF.values())
    bank = torch.randn(V * rows, D, generator=gen).to(dev)
    offsets = (torch.arange(V, dtype=torch.int32) * rows).to(dev)
    row_limit = torch.full((V,), rows - 1, dtype=torch.int32)
    row_limit[3] = 36
    vi = torch.randint(0, V, (BATCH,), generator=gen, dtype=torch.int32)
    st = torch.randint(0, 13, (BATCH,), generator=gen, dtype=torch.int32) * 8
    vi[0], st[0] = 3, 8
    z0 = torch.randn(sum(DIMS_DIFF.values()), generator=gen).to(dev)
    args = (bank, offsets, row_limit.to(dev), z0, sum(DIMS_RAW.values()), vi.to(dev), st.to(dev), CLIP)
    got, want = gather_windows_subblock(*args), gather_windows_subblock_plain(*args)
    torch.cuda.synchronize()
    _check(got.shape == (BATCH, CLIP, D), f"K2 output shape {tuple(got.shape)}")
    _check(torch.equal(got, want), "K2 kernel differs from its plain version")
    k1 = gather_windows(*args)
    _check(not torch.equal(got[0], k1[0]), "K2 and K1 agree on a window whose clipped start is unaligned")
    ms, plain_ms = _interleaved_ms(lambda: gather_windows_subblock(*args),
                                   lambda: gather_windows_subblock_plain(*args), 50)
    base = (offsets[vi.long().to(dev)].long()
            + torch.minimum(st.to(dev).long(), (row_limit[vi.long()].to(dev).long() + 1 - CLIP).clamp_min(0))) // 8 * 8
    row_idx = base[:, None] + torch.arange(CLIP, device=dev)[None, :]
    note_ms = _time_ms(lambda: bank[row_idx], 50)
    bound_ms, bound_by = _bound(2 * BATCH * CLIP * D * 4 + 2 * BATCH * 4, 0.0, PEAK_FP32)
    print(f"K2 gather_windows_subblock [{BATCH}, {CLIP}, {D}] from a {V}x{rows}x{D} bank, one window clipped "
          f"to an unaligned start: bitwise equal to plain, differs from K1 there; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it); "
          f"library: none, no single call computes the clamped gather with row 0's override (note: "
          f"bank[rows] {note_ms:.4f} ms, index precomputed outside the timing, no override)")
    results["gather_windows_subblock"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                              bound_by=bound_by, library_ms=None)

    # K9 and K10 at "high", against the plain versions at "high" (K3_TOL's class)
    S, C = 10, 256
    xs = torch.randn(S, BATCH, CLIP, C, generator=gen).to(dev)
    w1s, w2s = ((torch.randn(S, 5, C, C, generator=gen) / math.sqrt(5 * C)).to(dev) for _ in range(2))
    gs = (1.0 + 0.1 * torch.randn(S, C, generator=gen)).to(dev)
    gb = (0.1 * torch.randn(S, C, generator=gen)).to(dev)

    def act_w_bytes(windows, weight_sets):
        """x read and out written once; each conv's [5, C, C] fp32 weights read once."""
        return 4 * (2 * windows * CLIP * C + 2 * weight_sets * 5 * C * C)

    def k3_per_chain(d):
        """K3 "high" launched once a chain: what K9 does in one launch."""
        return torch.stack([fused_temporal_block(xs[i], w1s[i], w2s[i], gs[i], gb[i], d, "high")
                            for i in range(S)])

    errs, kms, pms, bounds, k9_ms, k3_ms = [], [], [], [], [], []
    for d in (1, 2, 4, 8):
        got = fused_temporal_block_stacked(xs, w1s, w2s, gs, gb, d)
        want = fused_temporal_block_stacked_plain(xs, w1s, w2s, gs, gb, d)
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(got).all()), f"K9 d={d}: non-finite output")
        errs.append((got - want).abs().max().item())
        _check(errs[-1] <= FUSED_TOL, f"K9 d={d}: max |kernel - plain| {errs[-1]:.3e} > {FUSED_TOL}")
        _check(torch.equal(got, k3_per_chain(d)), f"K9 d={d}: differs from K3 high chain by chain")
        k, p = _interleaved_ms(lambda: fused_temporal_block_stacked(xs, w1s, w2s, gs, gb, d),
                               lambda: fused_temporal_block_stacked_plain(xs, w1s, w2s, gs, gb, d), 5)
        kms.append(k)
        pms.append(p)
        k, p = _interleaved_ms(lambda: fused_temporal_block_stacked(xs, w1s, w2s, gs, gb, d),
                               lambda: k3_per_chain(d), 10)
        k9_ms.append(k)
        k3_ms.append(p)
        bounds.append(_bound(act_w_bytes(S * BATCH, S), 6 * 2 * S * _conv_fmas(BATCH, CLIP, C, d), PEAK_BF16))
    fmt = lambda v: ", ".join(f"{m:.3f}" for m in v)   # noqa: E731
    bound_ms = sum(b[0] for b in bounds) / 4
    print(f"K9 fused_temporal_block_stacked[high] [{S}, {BATCH}, {CLIP}, {C}] d=1/2/4/8: max |kernel - plain| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {FUSED_TOL}); bitwise K3 high chain by chain; "
          f"kernel ms {fmt(kms)}; plain ms {fmt(pms)}; bound {bound_ms:.4f} ms ({bounds[0][1]}, "
          f"{bound_ms / (sum(kms) / 4):.1%} of the mean); no single PyTorch call computes the fused stage")
    print(f"   K9 beside {S} K3 high launches (one a chain, each with its weight planes), interleaved: "
          f"K9 ms {fmt(k9_ms)}; {S} x K3 ms {fmt(k3_ms)}; ratio {sum(k9_ms) / sum(k3_ms):.3f}")
    results["fused_temporal_block_stacked[high]"] = dict(
        max_abs_err=max(errs), ms=sum(kms) / 4, plain_ms=sum(pms) / 4, bound_ms=bound_ms,
        bound_by=bounds[0][1], library_ms=None)

    x = xs[0]
    for name, groups in (("fused_temporal_chain[4 stages]", ((1, 2, 4, 8),)),
                         ("fused_temporal_chain[2 stages]", ((1, 2), (4, 8)))):
        errs, kms, pms, bounds = [], [], [], []
        for dil in groups:
            n = len(dil)
            w = (w1s[:n], w2s[:n], gs[:n], gb[:n])   # n of the chains' weight sets as stages
            got = fused_temporal_chain(x, *w, dil)
            want = fused_temporal_chain_plain(x, *w, dil)
            torch.cuda.synchronize()
            _check(bool(torch.isfinite(got).all()), f"K10 {dil}: non-finite output")
            errs.append((got - want).abs().max().item())
            _check(errs[-1] <= FUSED_TOL, f"K10 {dil}: max |kernel - plain| {errs[-1]:.3e} > {FUSED_TOL}")
            k, p = _interleaved_ms(lambda: fused_temporal_chain(x, *w, dil),
                                   lambda: fused_temporal_chain_plain(x, *w, dil), 10)
            kms.append(k)
            pms.append(p)
            bounds.append(_bound(act_w_bytes(BATCH, n),
                                 6 * 2 * sum(_conv_fmas(BATCH, CLIP, C, d) for d in dil), PEAK_BF16))
        bound_ms = sum(b[0] for b in bounds) / len(groups)
        print(f"K10 {name} [{BATCH}, {CLIP}, {C}] dilations {' and '.join(map(str, groups))}: max |kernel - plain| "
              f"{', '.join(f'{e:.2e}' for e in errs)} (tol {FUSED_TOL}); kernel ms {fmt(kms)}; plain ms {fmt(pms)}; "
              f"bound {bound_ms:.4f} ms ({bounds[0][1]}, {bound_ms / (sum(kms) / len(groups)):.1%} of the mean)")
        results[name] = dict(max_abs_err=max(errs), ms=sum(kms) / len(groups), plain_ms=sum(pms) / len(groups),
                             bound_ms=bound_ms, bound_by=bounds[0][1], library_ms=None)
    return results


def _write_tree(root, videos_per_class=4, frames=(96, 107, 118, 128)):
    import numpy as np

    from video_gen_evals_tpu_torch.data.fixtures import make_fixture_tree, write_keypoints, write_mesh_npz
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES

    mesh_root, kp_root = make_fixture_tree(
        root, ACTION_CLASSES, videos_per_class=videos_per_class, frames=frames,
        vit_dim=DIMS_RAW["vit"], seed=SEED,
    )
    gen_dir, gen_kp = os.path.join(root, "generated_meshes"), os.path.join(root, "generated_kps")
    rng = np.random.default_rng(SEED + 1)
    for i, cls in enumerate(list(ACTION_CLASSES) * 2):
        stem = f"GenModel{i % 2}_{cls}_{i:02d}"
        n = int(rng.integers(96, 129))
        write_mesh_npz(os.path.join(gen_dir, f"{stem}.npz"), n, DIMS_RAW["vit"], rng)
        write_keypoints(os.path.join(gen_kp, stem, "keypoints.npy"), n, rng)
    return mesh_root, kp_root, gen_dir, gen_kp


def _expected_batches(mesh_root, gen_dir) -> int:
    from video_gen_evals_tpu_torch.data import (
        enumerate_windows, scan_class_tree, scan_generated_flat, train_test_split)
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES

    real = scan_class_tree(mesh_root, filter_classes=list(ACTION_CLASSES))
    train, _ = train_test_split(real, 0.8, seed=1337)
    n_train = len(enumerate_windows(train, CLIP, STRIDE))
    n_gen = len(enumerate_windows(scan_generated_flat(gen_dir), CLIP, STRIDE))
    return -(-n_train // BATCH) + -(-n_gen // BATCH)


def _e2e_window_metrics(torch, model, mesh_root, kp_root, gen_dir, gen_kp, batches):
    """Phase 3's per-window route, on the tree the score CLI just read: the
    real train split's and the generated banks swept once each by
    WindowEncoder.encode_bank at "high" (K1 once and K3 40 times a batch),
    then build_centroids on the real windows and video_ac_scores /
    video_tc_scores on the generated ones, all on the card, against the
    segment-sum route (build_real_centroids and score_bank) on the same banks
    and encoder; build_centroids twice, bitwise. Then apply_with_attention on
    one batch of the generated windows at "highest": its rows, its outputs
    against model(x, "highest") on the card, and the card against the CPU."""
    import copy

    import numpy as np

    from video_gen_evals_tpu_torch.data import (
        ModalityPaths, build_feature_bank, compute_stats, enumerate_windows, scan_class_tree,
        scan_generated_flat, train_test_split)
    from video_gen_evals_tpu_torch.metrics import build_centroids, video_ac_scores, video_tc_scores
    from video_gen_evals_tpu_torch.models.fusion_encoder import apply_with_attention
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows
    from video_gen_evals_tpu_torch.pipelines.score import (
        ScoreConfig, WindowEncoder, build_real_centroids, score_bank)
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES, canonicalize_class

    t0 = time.perf_counter()
    cfg = ScoreConfig(CLIP, STRIDE, BATCH, precision="high")
    real_paths = ModalityPaths(keypoint_dir=kp_root, layout="real")
    gen_paths = ModalityPaths(keypoint_dir=gen_kp, layout="generated")
    real = scan_class_tree(mesh_root, filter_classes=list(ACTION_CLASSES))
    train, _ = train_test_split(real, 0.8, seed=cfg.seed)
    gen = scan_generated_flat(gen_dir)
    stats = compute_stats(train.items, real_paths)
    real_bank = build_feature_bank(train.items, real_paths, stats, min_rows=CLIP + 8)
    gen_bank = build_feature_bank(gen.items, gen_paths, stats, min_rows=CLIP + 8)
    label_dict = real.label_dict()
    real_windows = enumerate_windows(train, CLIP, STRIDE)
    gen_windows = enumerate_windows(gen, CLIP, STRIDE)
    enc = WindowEncoder(model, BATCH, CLIP, "high", "cuda")

    gather_windows.launches = 0
    fused_temporal_block.launches = 0
    seq_r, _tc_r, vid_r = enc.encode_bank(real_bank, real_windows)
    seq_g, tc_g, vid_g = enc.encode_bank(gen_bank, gen_windows)
    n = (gather_windows.launches, fused_temporal_block.launches)
    _check(n == (batches, 40 * batches), f"e2e encode_bank: launches {n} != {(batches, 40 * batches)}")
    card = lambda a: torch.from_numpy(np.asarray(a)).cuda()   # noqa: E731
    labels = card(np.array([label_dict[real_bank.classes[v]] for v in vid_r], np.int64))
    centroids, counts = build_centroids(card(seq_r), labels, len(label_dict))
    again, _ = build_centroids(card(seq_r), labels, len(label_dict))
    _check(centroids.is_cuda and torch.equal(centroids.view(torch.int32), again.view(torch.int32)),
           "e2e: two build_centroids calls on the card differ")
    _check(bool((counts > 0).all()), f"e2e: a class with no real windows: {counts.tolist()}")
    video_cls = [canonicalize_class(c) for c in gen_bank.classes]
    video_label = card(np.array([label_dict.get(c, 0) for c in video_cls], np.int64))
    ac = video_ac_scores(card(seq_g), card(vid_g), video_label, centroids).cpu().numpy()
    tc = video_tc_scores(card(tc_g), card(vid_g), len(gen.items)).cpu().numpy()

    want_cen, _ = build_real_centroids(enc, real, real_paths, stats, cfg)
    want = score_bank(enc, gen_bank, gen, want_cen, label_dict, cfg)
    d_cen = float(np.abs(centroids.cpu().numpy() - want_cen).max())
    d_ac = d_tc = 0.0
    for v, it in enumerate(gen.items):
        w = want[os.path.splitext(it.name)[0]]
        _check(video_cls[v] in label_dict and "ac" in w, f"e2e: {it.name} has no class centroid")
        d_ac = max(d_ac, abs(float(ac[v]) - w["ac"]))
        d_tc = max(d_tc, abs(float(tc[v]) - w["tc"]))
    _check(len(want) == len(gen.items) and np.isfinite(ac).all() and np.isfinite(tc).all(),
           "e2e: per-window AC/TC not finite for every generated video")
    _check(max(d_ac, d_tc) <= 1e-5,
           f"e2e: per-window AC/TC against the segment sums: {d_ac:.3e}, {d_tc:.3e} > 1e-5")
    print(f"e2e per-window route (encode_bank at high, launches gather={n[0]} conv={n[1]}; "
          f"build_centroids, video_ac_scores, video_tc_scores on the card): max |dAC| {d_ac:.3e}, "
          f"|dTC| {d_tc:.3e}, |d centroid| {d_cen:.3e} against score_bank's segment sums over "
          f"{len(gen.items)} videos (tol 1e-5); build_centroids twice bitwise equal")

    vi = card(np.array([v for v, _s in gen_windows[:BATCH]], np.int32))
    st = card(np.array([s for _v, s in gen_windows[:BATCH]], np.int32))
    x = gather_windows(*enc.upload(gen_bank), gen_bank.one_pass_raw, vi, st, CLIP)
    (outs, attn) = apply_with_attention(model, x, "highest")
    with torch.no_grad():
        plain = model(x, "highest")
    _check(all(torch.equal(a, b) for a, b in zip(outs, plain)),
           "e2e: apply_with_attention's outputs differ from model(x, 'highest') on the card")
    m = len(DIMS_RAW)
    _check(tuple(attn.shape) == (x.shape[0], CLIP, m), f"e2e: attention map shape {tuple(attn.shape)}")
    d_rows = float((attn.sum(-1) - 1.0).abs().max())
    _check(d_rows <= 1e-6, f"e2e: attention rows sum to 1 within {d_rows:.3e} > 1e-6")
    outs_cpu, attn_cpu = apply_with_attention(copy.deepcopy(model).cpu(), x.cpu(), "highest")
    d_attn = float((attn.cpu() - attn_cpu).abs().max())
    d_out = max(float((a.cpu() - b).abs().max()) for a, b in zip(outs, outs_cpu))
    _check(max(d_attn, d_out) <= 1e-4, f"e2e: apply_with_attention card vs CPU: map {d_attn:.3e}, "
                                        f"outputs {d_out:.3e} > 1e-4")
    print(f"e2e apply_with_attention on {x.shape[0]} generated windows at highest: map [{x.shape[0]}, "
          f"{CLIP}, {m}], rows sum to 1 within {d_rows:.3e} (tol 1e-6); outputs bitwise model(x, "
          f"'highest') on the card; card vs CPU: map {d_attn:.3e}, outputs {d_out:.3e} (tol 1e-4); "
          f"{time.perf_counter() - t0:.1f} s for the per-window route and the map")


def phase_end_to_end(torch):
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows
    from video_gen_evals_tpu_torch.pipelines.score import main as score_main

    launches, scores = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        mesh_root, kp_root, gen_dir, gen_kp = _write_tree(root)
        batches = _expected_batches(mesh_root, gen_dir)
        model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF),
                                  generator=torch.Generator().manual_seed(SEED))
        ckpt = os.path.join(root, "model.pt")
        torch.save({"model_state_dict": model.state_dict()}, ckpt)
        print(f"e2e: synthetic tree + seeded .pt written in {time.perf_counter() - t0:.1f} s; "
              f"{batches} batches of {BATCH} expected per run")
        # the two precisions on the card, then the plain versions on the CPU
        # as the reference the card's "highest" run is held against
        for precision, device in (("high", "cuda"), ("highest", "cuda"), ("highest", "cpu")):
            arm = f"{precision}/{device}"
            out = os.path.join(root, f"scores_{precision}_{device}.json")
            argv = ["--generated-meshes", gen_dir, "--real-meshes", mesh_root,
                    "--checkpoint", ckpt, "--real-kp-dir", kp_root, "--gen-kp-dir", gen_kp,
                    "--clip-len", str(CLIP), "--stride", str(STRIDE),
                    "--batch-size", str(BATCH), "--output", out, "--no-bug-compat",
                    "--precision", precision, "--device", device]
            gather_windows.launches = 0
            fused_temporal_block.launches = 0
            t0 = time.perf_counter()
            score_main(argv)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = (gather_windows.launches, fused_temporal_block.launches)
            with open(out) as f:
                scores[arm] = json.load(f)
            print(f"e2e --precision {precision} --device {device}: {len(scores[arm])} videos in "
                  f"{wall:.2f} s (host stats + banks included); launches gather={n[0]} conv={n[1]}")
            want = (batches, 40 * batches) if device == "cuda" else (0, 0)
            _check(n == want, f"{arm}: launches {n} != {want}")
            if device == "cuda":
                launches[precision] = n
        _e2e_window_metrics(torch, model, mesh_root, kp_root, gen_dir, gen_kp, batches)

    def worst_diff(a, b):
        _check(len(a) == 20 and sorted(a) == sorted(b), "e2e: not every generated video scored")
        worst = 0.0
        for vid in a:
            for m in ("ac", "tc"):
                x, y = a[vid].get(m), b[vid].get(m)
                _check(x is not None and y is not None and math.isfinite(x) and math.isfinite(y),
                       f"e2e: {vid} {m} missing or not finite")
                worst = max(worst, abs(x - y))
        return worst

    d_prec = worst_diff(scores["high/cuda"], scores["highest/cuda"])
    _check(d_prec <= 1e-3, f"e2e: high vs highest differ by {d_prec:.3e} > 1e-3")
    d_ref = worst_diff(scores["highest/cuda"], scores["highest/cpu"])
    _check(d_ref <= 1e-4, f"e2e: card vs CPU plain versions differ by {d_ref:.3e} > 1e-4")
    print(f"e2e: max |dAC|,|dTC| over 20 videos: high vs highest on the card {d_prec:.3e} "
          f"(budget 1e-3); card vs CPU plain versions at highest {d_ref:.3e} (tol 1e-4)")
    return launches


def sweep_inputs(torch):
    """The throughput phase's sweep at the flagship width: a seeded bank of 64
    videos x 120 frames (128 rows each), its windows, their per-video segment
    ids, and a seeded model. ``scripts/profile_torch_sweep.py`` profiles the
    same sweep."""
    import numpy as np

    from video_gen_evals_tpu_torch.data import FeatureBank
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer

    V, frames, rows = 64, 120, 128
    D = sum(DIMS_RAW.values()) + sum(DIMS_DIFF.values())
    rng = np.random.default_rng(SEED)
    bank = FeatureBank(
        bank=rng.standard_normal((V * rows, D), dtype=np.float32),
        offsets=(np.arange(V) * rows).astype(np.int32),
        row_limit=np.full(V, rows - 1, np.int32),
        z0_diff=rng.standard_normal(sum(DIMS_DIFF.values()), dtype=np.float32),
        one_pass_raw=sum(DIMS_RAW.values()), classes=["x"] * V, names=[str(i) for i in range(V)],
    )
    windows = [(v, s) for v in range(V) for s in range(0, frames - CLIP + 1, STRIDE)]
    seg = [v for v, _s in windows]
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF),
                              generator=torch.Generator().manual_seed(SEED))
    return bank, windows, seg, model


def phase_throughput(torch, card) -> None:
    from video_gen_evals_tpu_torch.pipelines.score import WindowEncoder

    bank, windows, seg, model = sweep_inputs(torch)
    for precision, bs in (("high", 256), ("high", 512), ("highest", 512)):
        enc = WindowEncoder(model, bs, CLIP, precision, "cuda")
        dev_bank = enc.upload(bank)
        enc.encode_bank_segsum(bank, windows, seg, bank.num_videos, bank_dev=dev_bank)   # warm
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            # each sweep ends in its one fetch, so the host clock sees it finish
            enc.encode_bank_segsum(bank, windows, seg, bank.num_videos, bank_dev=dev_bank)
        dt = (time.perf_counter() - t0) / reps
        n_batches = -(-len(windows) // bs)
        print(f"throughput {precision} batch {bs}: {len(windows) / dt:.0f} windows/s "
              f"({len(windows)} windows, {n_batches} batches, {dt * 1e3 / n_batches:.2f} ms/batch "
              f"incl. padded tail) on {card}")


def _kernel_counters():
    """Every scoring kernel's launch counter, by the kernels line's names
    (K8's counts both of its precisions)."""
    from video_gen_evals_tpu_torch.ops.attention import flash_attention
    from video_gen_evals_tpu_torch.ops.attention_core import mha_core
    from video_gen_evals_tpu_torch.ops.chain_kernel import fused_temporal_chain
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block, fused_temporal_block_stacked
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows, gather_windows_subblock

    return {"gather_windows": gather_windows, "gather_windows_subblock": gather_windows_subblock,
            "fused_temporal_block[high]": fused_temporal_block,
            "fused_temporal_block_stacked[high]": fused_temporal_block_stacked,
            "fused_temporal_chain": fused_temporal_chain, "mha_core[high]": mha_core,
            "flash_attention": flash_attention}


def _fused_segsum(torch, model, bank, bank_dev, windows, seg, num_videos, gather, **fused):
    """WindowEncoder.encode_bank_segsum's sweep with ``gather`` (K1 or K2) and
    ``block_kernel_forward(**fused)`` at "high" for the fused forwards that
    no encoder_impl names: batches of BATCH, the tail padded with the last
    window, per-video sums of CLS embeddings, TCs and counts, one fetch."""
    import numpy as np

    from video_gen_evals_tpu_torch.metrics.scores import tc_per_window
    from video_gen_evals_tpu_torch.models.fused_apply import block_kernel_forward

    dev = bank_dev[0].device
    n = len(windows)
    n_pad = -(-n // BATCH) * BATCH
    idx = np.array(list(windows) + [windows[-1]] * (n_pad - n), np.int32)
    vi, st = (torch.from_numpy(np.ascontiguousarray(idx[:, i])).to(dev) for i in (0, 1))
    seg_d = torch.tensor(list(seg) + [seg[-1]] * (n_pad - n), device=dev)
    valid = (torch.arange(n_pad, device=dev) < n).float()
    seq_sum = torch.zeros(num_videos, model.config.d_model, device=dev)
    tc_sum, count = torch.zeros(num_videos, device=dev), torch.zeros(num_videos, device=dev)
    with torch.inference_mode():
        for lo in range(0, n_pad, BATCH):
            b = slice(lo, lo + BATCH)
            w = gather(*bank_dev, bank.one_pass_raw, vi[b], st[b], CLIP)
            seq, frames, _ = block_kernel_forward(model.config, model, w, precision="high", **fused)
            m = valid[b]
            seq_sum.index_add_(0, seg_d[b], seq * m[:, None])
            tc_sum.index_add_(0, seg_d[b], tc_per_window(frames) * m)
            count.index_add_(0, seg_d[b], m)
    return seq_sum.cpu().numpy(), tc_sum.cpu().numpy(), count.cpu().numpy()


def phase_fused_sweep(torch, card):
    """The throughput phase's sweep at "high", batch 512, under each fused
    forward: encoder_impl block_kernel and chain_kernel through WindowEncoder;
    block_kernel_forward's chain2 and stacked through the same sweep written
    out here (_fused_segsum), stacked once with K2 as its gather and once with
    attn_impl "core"; and the module forward with attention_impl "pallas" (K8
    at "highest") and "pallas_bf16" (K8 at "default"). Each arm's launch
    counts are set to 0 just before one sweep and read just after it; its AC
    and TC (8 classes of 8 videos, centroids from the arm's own sums) are held
    against the module forward's within FUSED_TOL (BF16_SWEEP_TOL for
    pallas_bf16). Then windows/s, warm, 5 sweeps per arm. Returns the
    launches of K2, K9, K10 (4 and 2 stages) and K6 at "high" on their arms."""
    import dataclasses

    from video_gen_evals_tpu_torch.metrics.scores import finalize_centroids, finalize_video_scores
    from video_gen_evals_tpu_torch.models import HumanActionScorer
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows, gather_windows_subblock
    from video_gen_evals_tpu_torch.pipelines.score import WindowEncoder

    bank, windows, seg, model = sweep_inputs(torch)
    V = bank.num_videos
    flash_models = {}
    for impl in ("pallas", "pallas_bf16"):
        flash_models[impl] = HumanActionScorer(dataclasses.replace(model.config, attention_impl=impl))
        flash_models[impl].load_state_dict(model.state_dict())
    encoders = {name: WindowEncoder(m, BATCH, CLIP, "high", "cuda", encoder_impl=impl)
                for name, m, impl in (("module", model, "module"), ("block_kernel", model, "block_kernel"),
                                      ("chain_kernel", model, "chain_kernel"),
                                      ("pallas", flash_models["pallas"], "module"),
                                      ("pallas_bf16", flash_models["pallas_bf16"], "module"))}
    dev_bank = encoders["module"].upload(bank)

    def encoder_sweep(name):
        return lambda: encoders[name].encode_bank_segsum(bank, windows, seg, V, bank_dev=dev_bank)

    def fused_sweep(gather, **fused):
        return lambda: _fused_segsum(torch, model, bank, dev_bank, windows, seg, V, gather, **fused)

    labels = torch.arange(V) % 8
    nb = -(-len(windows) // BATCH)
    layers = model.config.time_layers
    # (arm, one sweep, launches a sweep, the kernels-line rows this arm's
    # counts stand for, tolerance of AC and TC against the module forward's)
    arms = [
        ("module", encoder_sweep("module"),
         {"gather_windows": nb, "fused_temporal_block[high]": 40 * nb}, {}, FUSED_TOL),
        ("block_kernel", encoder_sweep("block_kernel"),
         {"gather_windows": nb, "fused_temporal_block[high]": 40 * nb}, {}, FUSED_TOL),
        ("chain_kernel", encoder_sweep("chain_kernel"),
         {"gather_windows": nb, "fused_temporal_chain": 10 * nb},
         {"fused_temporal_chain": "fused_temporal_chain[4 stages]"}, FUSED_TOL),
        ("chain2", fused_sweep(gather_windows, stage_fusion="chain2"),
         {"gather_windows": nb, "fused_temporal_chain": 20 * nb},
         {"fused_temporal_chain": "fused_temporal_chain[2 stages]"}, FUSED_TOL),
        ("stacked, K2 gather", fused_sweep(gather_windows_subblock, stage_fusion="stacked"),
         {"gather_windows_subblock": nb, "fused_temporal_block_stacked[high]": 4 * nb},
         {"gather_windows_subblock": "gather_windows_subblock",
          "fused_temporal_block_stacked[high]": "fused_temporal_block_stacked[high]"}, FUSED_TOL),
        ("stacked, attn_impl core", fused_sweep(gather_windows, stage_fusion="stacked", attn_impl="core"),
         {"gather_windows": nb, "fused_temporal_block_stacked[high]": 4 * nb, "mha_core[high]": layers * nb},
         {"mha_core[high]": "mha_core[high]"}, FUSED_TOL),
        ("module, attention_impl pallas", encoder_sweep("pallas"),
         {"gather_windows": nb, "fused_temporal_block[high]": 40 * nb, "flash_attention": layers * nb},
         {}, FUSED_TOL),
        ("module, attention_impl pallas_bf16", encoder_sweep("pallas_bf16"),
         {"gather_windows": nb, "fused_temporal_block[high]": 40 * nb, "flash_attention": layers * nb},
         {}, BF16_SWEEP_TOL),
    ]
    counters = _kernel_counters()
    ref, launches, rates = None, {}, {}
    for arm, sweep, want, rows, tol in arms:
        for fn in counters.values():
            fn.launches = 0
        sums = [torch.from_numpy(a) for a in sweep()]
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items() if fn.launches}
        _check(got == want, f"fused sweep {arm}: launches {got} != {want}")
        launches.update({row: got[counter] for counter, row in rows.items()})
        class_sum = torch.zeros(8, sums[0].shape[1]).index_add_(0, labels, sums[0])
        class_count = torch.zeros(8).index_add_(0, labels, sums[2])
        ac, tc = finalize_video_scores(*sums, labels, finalize_centroids(class_sum, class_count))
        _check(bool(torch.isfinite(ac).all() and torch.isfinite(tc).all()), f"fused sweep {arm}: non-finite AC/TC")
        if ref is None:
            ref = (ac, tc)
        d_ac, d_tc = ((a - r).abs().max().item() for a, r in zip((ac, tc), ref))
        _check(max(d_ac, d_tc) <= tol,
               f"fused sweep {arm}: AC/TC differ from module by {d_ac:.3e} / {d_tc:.3e} > {tol}")
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            sweep()   # ends in its one fetch, so the host clock sees it finish
        dt = (time.perf_counter() - t0) / reps
        rates[arm] = len(windows) / dt
        print(f"fused sweep high batch {BATCH}, {arm}: {rates[arm]:.0f} windows/s "
              f"({dt * 1e3 / nb:.2f} ms/batch); launches a sweep {got}; max |dAC| {d_ac:.2e}, "
              f"|dTC| {d_tc:.2e} vs module (tol {tol}) on {card}")
    print("fused sweep: windows/s against module's, " + "; ".join(
        f"{arm} {rate / rates['module']:.1%}" for arm, rate in rates.items() if arm != "module"))
    return launches


def _events(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _only_run(save_dir):
    (run,) = os.listdir(save_dir)
    return os.path.join(save_dir, run)


def phase_training(torch, card, root):
    """Phase 5, on a tree written under ``root``, which phase 11 reuses:
    returns the launches and what phase 11 compares against."""
    import copy

    from video_gen_evals_tpu_torch.core.config import PathsConfig, TrainConfig
    from video_gen_evals_tpu_torch.data import (
        enumerate_windows, scan_class_tree, scan_generated_flat, train_test_split)
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
    from video_gen_evals_tpu_torch.ops.conv_kernel_train import (
        LAUNCHES_PER_BACKWARD, fused_temporal_block_train)
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows
    from video_gen_evals_tpu_torch.pipelines.score import main as score_main
    from video_gen_evals_tpu_torch.pipelines.train_cli import main as train_main
    from video_gen_evals_tpu_torch.train.experiment import Experiment
    from video_gen_evals_tpu_torch.train.step import COMPONENTS, TrainStep
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES

    def reset():
        gather_windows.launches = fused_temporal_block.launches = 0
        fused_temporal_block_train.launches = fused_temporal_block_train.launches_bwd = 0

    def counts():
        return (fused_temporal_block_train.launches, fused_temporal_block_train.launches_bwd,
                gather_windows.launches, fused_temporal_block.launches)

    launches = {}
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    mesh_root, kp_root, gen_dir, gen_kp = _write_tree(
        root, videos_per_class=5, frames=(248, 256, 240, 252, 244))
    gen = scan_generated_flat(gen_dir)
    human = {f"{os.path.splitext(it.name)[0]}.mp4": {"ac": float(i % 5), "tc": float(-(i % 7))}
             for i, it in enumerate(gen.items)}
    human_path = os.path.join(root, "human.json")
    with open(human_path, "w") as f:
        json.dump(human, f)
    base = TrainConfig(
        paths=PathsConfig(real_meshes_dir=mesh_root, real_kp_dir=kp_root,
                          generated_meshes_dir=gen_dir, gen_kp_dir=gen_kp,
                          human_scores=human_path),
        epochs=2, save_dir=os.path.join(root, "SAVE_two"))
    cfg_path = os.path.join(root, "train.json")
    base.to_json(cfg_path)

    real = scan_class_tree(mesh_root, filter_classes=list(ACTION_CLASSES))
    train, test = train_test_split(real, 0.8, seed=base.seed)
    n_train, n_test, n_gen = (len(enumerate_windows(m, CLIP, STRIDE)) for m in (train, test, gen))
    steps = max(1, n_train // base.batch_size)
    eval_batches = -(-n_train // BATCH) + -(-n_test // BATCH) + -(-n_gen // BATCH)   # centroids, distance, monitor
    loss_chunks = -(-n_test // BATCH)
    print(f"train: tree written in {time.perf_counter() - t0:.1f} s; {n_train} train, {n_test} test, "
          f"{n_gen} generated windows; {steps} steps of {4 * base.batch_size} stacked windows per epoch")
    _check(steps >= 4, f"train: only {steps} steps per epoch")

    # the 2-epoch run through the CLI, at TrainConfig defaults
    reset()
    t0 = time.perf_counter()
    train_main(["--config", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    want = (40 * steps * 2, 40 * steps * 2 * LAUNCHES_PER_BACKWARD,
            2 * (steps + eval_batches + loss_chunks), 2 * 40 * (eval_batches + loss_chunks))
    print(f"train: 2 epochs in {wall:.1f} s (host stats + banks included); launches K4 forward={got[0]} "
          f"backward={got[1]} ({LAUNCHES_PER_BACKWARD} per stage backward) gather={got[2]} K3={got[3]}")
    _check(got == want, f"train: launches {got} != {want}")
    launches["default"] = got[:2]

    run_two = _only_run(base.save_dir)
    events = _events(run_two)
    kinds = {e["event"] for e in events}
    need = {"train_epoch", "eval_loss", "centroid_distance", "human_corr", "checkpoint"}
    _check(need <= kinds, f"train: metrics.jsonl lacks {sorted(need - kinds)} (has {sorted(kinds)})")
    for e in events:
        for k in ("loss", "avg") + COMPONENTS:
            _check(k not in e or math.isfinite(e[k]), f"train: non-finite {k} in {e}")
    epochs = [e for e in events if e["event"] == "train_epoch"]
    _check(len(epochs) == 2 and all(e["batches"] == steps and e["skipped"] == 0 for e in epochs),
           f"train: epochs {epochs}")
    second = epochs[1]
    print(f"train: epoch losses {epochs[0]['loss']:.4f} -> {second['loss']:.4f}; second epoch "
          f"{second['batches'] / second['seconds']:.3f} steps/s, {second['clips_per_sec']:.1f} clips/s on {card}")

    # the weights moved away from their seeded start
    final = torch.load(os.path.join(run_two, "resume_epoch001.pt"), map_location="cpu", weights_only=True)
    fresh = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF),
                              generator=torch.Generator().manual_seed(base.seed)).state_dict()
    moved = [k for k, v in final["model"].items() if k != "pos_enc.pe" and not torch.equal(v, fresh[k])]
    _check(len(moved) == len(fresh) - 1, f"train: only {len(moved)} of {len(fresh) - 1} parameters changed")

    # the best checkpoint goes through the score CLI
    best = sorted(f for f in os.listdir(run_two) if f.startswith("best_eval"))[-1]
    out = os.path.join(root, "scores_trained.json")
    score_main(["--generated-meshes", gen_dir, "--real-meshes", mesh_root,
                "--checkpoint", os.path.join(run_two, best), "--real-kp-dir", kp_root,
                "--gen-kp-dir", gen_kp, "--output", out, "--no-bug-compat", "--device", "cuda"])
    with open(out) as f:
        scored = json.load(f)
    _check(len(scored) == len(gen.items) and all(
        math.isfinite(v.get("ac", math.nan)) and math.isfinite(v.get("tc", math.nan))
        for v in scored.values()), "train: the trained checkpoint did not score every generated video finite")
    print(f"train: {best} scored {len(scored)} generated videos, all finite")

    # epoch 0's checkpoint + --resume for epoch 1 == the 2-epoch run, bit for bit
    resumed_cfg = copy.deepcopy(base)
    resumed_cfg.save_dir = os.path.join(root, "SAVE_resumed")
    resumed_cfg.to_json(cfg_path)
    train_main(["--config", cfg_path, "--device", "cuda",
                "--resume", os.path.join(run_two, "resume_epoch000.pt")])
    resumed = torch.load(os.path.join(_only_run(resumed_cfg.save_dir), "resume_epoch001.pt"),
                         map_location="cpu", weights_only=True)
    same = all(torch.equal(v, resumed["model"][k]) for k, v in final["model"].items())
    opt_a, opt_b = final["train_step"]["optimizer"]["state"], resumed["train_step"]["optimizer"]["state"]
    same = same and all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    same = same and final["train_step"]["step"] == resumed["train_step"]["step"] == 2 * steps
    same = same and final["best_eval_loss"] == resumed["best_eval_loss"]
    _check(same, "train: the resumed run is not bitwise equal to the 2-epoch run")
    print("train: resume from epoch 0's checkpoint ends bitwise equal to the 2-epoch run "
          "(weights, Adam moments, step, best eval loss)")

    # one step at "highest", dropout 0, K = 4: the card against the plain versions on the CPU
    small = copy.deepcopy(base)
    small.K, small.dropout, small.save_dir = 4, 0.0, os.path.join(root, "SAVE_small")
    exp = Experiment(small, device="cuda", precision="highest")
    idx = next(iter(exp._sampler_for_epoch(0)))
    stacked = exp.train_step.stack(
        exp._gather_batch(exp.train_bank, exp._train_bank_dev, exp.train_windows, idx))
    labels = exp._labels(exp.window_labels, idx)
    cpu_step = TrainStep(copy.deepcopy(exp.model).cpu(), small.lr, 8, precision="highest",
                         eval_precision="highest", seed=small.seed)
    reset()
    on_card = exp.train_step.update(stacked, labels)
    torch.cuda.synchronize()
    got = counts()
    _check(got[:2] == (40, 40 * LAUNCHES_PER_BACKWARD), f"train highest: K4 launches {got[:2]}")
    launches["highest"] = got[:2]
    t0 = time.perf_counter()
    on_cpu = cpu_step.update(stacked.cpu(), labels.cpu())
    worst = max(abs(on_card[k] - on_cpu[k]) for k in COMPONENTS + ("total",))
    print(f"train: first step at highest, dropout 0, {stacked.shape[0]} stacked windows: card "
          f"{ {k: round(on_card[k], 5) for k in COMPONENTS} } vs CPU plain versions, max |d| {worst:.3e} "
          f"(tol 1e-3; CPU step {time.perf_counter() - t0:.1f} s)")
    _check(worst <= 1e-3, f"train: card vs CPU loss components differ by {worst:.3e} > 1e-3")
    ctx = dict(base=base, run_two=run_two, mesh_root=mesh_root, kp_root=kp_root, gen_dir=gen_dir, gen_kp=gen_kp,
               human=human_path, best=os.path.join(run_two, best), scores=out, steps=steps, n_train=n_train,
               n_test=n_test, n_gen=n_gen, clips_per_sec=second["clips_per_sec"])
    return launches, ctx


def _attn_bound(batch, n, heads, hd, elem_bytes, flops_per_product, peak):
    """q, k, v read and out written once; two products of 2 n^2 hd each."""
    nbytes = 4 * batch * n * heads * hd * elem_bytes
    return _bound(nbytes, flops_per_product * 2 * batch * heads * n * n * hd, peak)


def phase_attention_kernels(torch, dev, gen):
    """K6, K7, K8 against their plain versions at the ViT-H layer's shapes,
    at odd N and at the scorer's shape."""
    import torch.nn.functional as F

    from video_gen_evals_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    from video_gen_evals_tpu_torch.ops.attention_core import (
        mha_core, mha_core_plain, mha_head_batched, mha_head_batched_plain)

    B, N, H, hd = VIT_B, VIT_N, VIT_H, VIT_HD
    D = H * hd
    results = {}

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def check(tag, got, want, precision):
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite output")
        e = err(got, want)
        _check(e <= ATTN_TOL[precision], f"{tag}: max |kernel - plain| {e:.3e} > {ATTN_TOL[precision]}")
        return e

    def sdpa_ms(q4, k4, v4, precision):
        """One PyTorch call for the same function on the same [B, N, H, hd]
        tensors (bf16 for "default", the cast made before the timing); timed
        here and used nowhere in the port."""
        ts = [t.transpose(1, 2) for t in (q4, k4, v4)]
        if precision == "default":
            ts = [t.to(torch.bfloat16) for t in ts]
        return _time_ms(lambda: F.scaled_dot_product_attention(*ts), 20)

    def kernel_row(name, tag, kernel, plain, precision, bound, library_ms):
        """Check, time (plain, kernel, kernel, plain), print with the share of
        the bound and the library call's time, record."""
        e = check(tag, kernel(), plain(), precision)
        ms, plain_ms = _interleaved_ms(kernel, plain, 20)
        results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                             library_ms=library_ms)
        library = f"SDPA {library_ms:.4f} ms ({ms / library_ms:.2f}x)"
        print(f"{tag}: max |kernel - plain| {e:.2e} (tol {ATTN_TOL[precision]}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {library}, bound {bound[0]:.4f} ms ({bound[1]}, "
              f"{bound[0] / ms:.1%} of the kernel's time)")

    for dtype, precision in ((torch.float32, "highest"), (torch.bfloat16, "default")):
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(dev).to(dtype)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]            # as the ViT block hands them
        q4, k4, v4 = qkv.reshape(B, N, 3, H, hd).unbind(dim=2)
        elem = 4 if dtype == torch.float32 else 2
        bound = _attn_bound(B, N, H, hd, elem, 2, PEAK_FP32 if precision == "highest" else PEAK_BF16)
        library_ms = sdpa_ms(q4, k4, v4, precision)
        what = f"{str(dtype)[6:]} [{B}, {N}, {H}, {hd}]"
        kernel_row(f"mha_core[{precision}]", f"K6 mha_core[{precision}] {what}, strided slices of qkv",
                   lambda: mha_core(q, k, v, H, precision=precision),
                   lambda: mha_core_plain(q, k, v, H, precision=precision), precision, bound, library_ms)
        kernel_row(f"mha_head_batched[{precision}]", f"K7 mha_head_batched[{precision}] {what}, read in place",
                   lambda: mha_head_batched(q, k, v, H, precision=precision),
                   lambda: mha_head_batched_plain(q, k, v, H, precision=precision), precision, bound, library_ms)
        _check(torch.equal(mha_head_batched(q, k, v, H, precision=precision),
                           mha_core(q, k, v, H, precision=precision)),
               f"K7 {precision}: not bitwise equal to K6 on the same strides")
        kernel_row(f"flash_attention[{precision}]", f"K8 flash_attention[{precision}] {what}, blocks 128/128",
                   lambda: flash_attention(q4, k4, v4, precision=precision),
                   lambda: flash_attention_plain(q4, k4, v4, precision=precision), precision, bound, library_ms)

        # N that is no multiple of a 16- or 64-key chunk: K8 over several
        # 64-key blocks; K6 and K7 at ViT-H's width for N = 100 and at head
        # width 32 for N = 300 (the one-pass kernels hold at most 192 keys of
        # width 80)
        for n_odd, hd_odd in ((100, hd), (300, 32)):
            t = torch.randn(4, n_odd, 3, H, hd, generator=gen).to(dev).to(dtype)
            a, b, c = t.unbind(dim=2)
            e8 = check(f"K8 {precision} N={n_odd}",
                       flash_attention(a, b, c, block_q=64, block_kv=64, precision=precision),
                       flash_attention_plain(a, b, c, block_q=64, block_kv=64, precision=precision), precision)
            t = torch.randn(4, n_odd, 3 * H * hd_odd, generator=gen).to(dev).to(dtype)
            a, b, c = t.chunk(3, dim=-1)
            e6 = check(f"K6 {precision} N={n_odd}", mha_core(a, b, c, H, precision=precision),
                       mha_core_plain(a, b, c, H, precision=precision), precision)
            e7 = check(f"K7 {precision} N={n_odd}", mha_head_batched(a, b, c, H, precision=precision),
                       mha_head_batched_plain(a, b, c, H, precision=precision), precision)
            print(f"   [{precision}] N={n_odd}: max |kernel - plain| K8 ({H} heads of {hd}, blocks 64/64) {e8:.2e}, "
                  f"K6 {e6:.2e} and K7 {e7:.2e} ({H} heads of {hd_odd})")

    # K6 "high" (bf16x3) at the ViT-H shape; its bound is the bytes (bf16x3
    # fits the bf16 tensor rate). Its library call is fp32 SDPA (3xTF32 on
    # the tensor cores), whose distance from the plain "high" is printed.
    qkv = torch.randn(B, N, 3 * D, generator=gen).to(dev)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    q4, k4, v4 = qkv.reshape(B, N, 3, H, hd).unbind(dim=2)
    e = check("K6 high", mha_core(q, k, v, H, precision="high"), mha_core_plain(q, k, v, H, precision="high"), "high")
    e32 = err(mha_core(q, k, v, H, precision="high"), mha_core_plain(q, k, v, H, precision="highest"))
    ms, plain_ms = _interleaved_ms(lambda: mha_core(q, k, v, H, precision="high"),
                                   lambda: mha_core_plain(q, k, v, H, precision="high"), 10)
    library_ms = sdpa_ms(q4, k4, v4, "highest")
    bound_ms, bound_by = _attn_bound(B, N, H, hd, 4, 2, PEAK_BF16)
    print(f"K6 mha_core[high] float32 [{B}, {N}, {D}]: max |kernel - plain high| {e:.2e} (tol {ATTN_TOL['high']}), "
          f"vs plain fp32 {e32:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA fp32 {library_ms:.4f} ms "
          f"({ms / library_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of the kernel's "
          f"time; no caller on the mesh path)")

    # the scorer's transformer shape [512, 33, 8 heads of 32] on fp32 slices of
    # qkv, as attn_impl "core" (K6) and attention_impl "pallas" (K8
    # "highest") and "pallas_bf16" (K8 "default") hand them; K7 on the same
    # slices. SDPA on the same tensors, cast to bf16 for "default".
    qkv = torch.randn(BATCH, 33, 3 * 256, generator=gen).to(dev)
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    q4, k4, v4 = (t.reshape(BATCH, 33, 8, 32) for t in (q, k, v))
    sdpa_high = err(F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q4, k4, v4))).transpose(1, 2),
                    mha_core_plain(q, k, v, 8, precision="high").reshape(BATCH, 33, 8, 32))
    print(f"   SDPA fp32 (3xTF32) at the scorer: max |SDPA - plain high| {sdpa_high:.2e} (tol {ATTN_TOL['high']})")
    kernel_row("mha_core[high]", f"K6 mha_core[high] float32 [{BATCH}, 33, 256], 8 heads, as attn_impl core "
               "hands them", lambda: mha_core(q, k, v, 8, precision="high"),
               lambda: mha_core_plain(q, k, v, 8, precision="high"), "high",
               _attn_bound(BATCH, 33, 8, 32, 4, 2, PEAK_BF16), sdpa_ms(q4, k4, v4, "highest"))
    for precision in ("highest", "high", "default"):
        e = check(f"K6 scorer {precision}", mha_core(q, k, v, 8, precision=precision),
                  mha_core_plain(q, k, v, 8, precision=precision), precision)
        ms = _time_ms(lambda: mha_core(q, k, v, 8, precision=precision), 20)
        line = f"   K6 [{precision}] at the scorer's [{BATCH}, 33, 256], 8 heads: max |kernel - plain| {e:.2e}, {ms:.4f} ms"
        if precision != "high":
            library_ms = sdpa_ms(q4, k4, v4, precision)
            bound_ms, bound_by = _attn_bound(BATCH, 33, 8, 32, 4, 2, PEAK_FP32 if precision == "highest" else PEAK_BF16)
            e7 = check(f"K7 scorer {precision}", mha_head_batched(q, k, v, 8, precision=precision),
                       mha_head_batched_plain(q, k, v, 8, precision=precision), precision)
            ms7 = _time_ms(lambda: mha_head_batched(q, k, v, 8, precision=precision), 20)
            e8 = check(f"K8 scorer {precision}", flash_attention(q4, k4, v4, precision=precision),
                       flash_attention_plain(q4, k4, v4, precision=precision), precision)
            ms8, plain8 = _interleaved_ms(lambda: flash_attention(q4, k4, v4, precision=precision),
                                          lambda: flash_attention_plain(q4, k4, v4, precision=precision), 20)
            line += (f"; K7 {e7:.2e}, {ms7:.4f} ms; K8 {e8:.2e}, {ms8:.4f} ms (plain {plain8:.4f} ms); SDPA "
                     f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, fp32 inputs: K6 "
                     f"{bound_ms / ms:.1%}, K8 {bound_ms / ms8:.1%})")
            if precision == "default":   # like for like with SDPA: K8 on the bf16 tensors SDPA reads
                qb, kb, vb = (t.to(torch.bfloat16) for t in (q4, k4, v4))
                cast_ms = _time_ms(lambda: flash_attention(qb, kb, vb, precision=precision), 20)
                line += f"; K8 on the bf16 cast {cast_ms:.4f} ms"
        print(line)
    return results


def mesh_video(n_frames=MESH_FRAMES, hw=MESH_HW, seed=SEED):
    """A seeded synthetic video and one box a frame: uint8 noise over a smooth
    component, and boxes that alternate between person-sized ones, whose crop
    window is below 2.2 x 256 pixels (no anti-alias blur), and near-frame-sized
    ones above it (blurred), all drifting from frame to frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    coarse = rng.uniform(40, 215, size=(n_frames, h // 40 + 2, w // 40 + 2, 3)).astype(np.float32)
    ys, xs = (np.arange(h) / 40.0).astype(np.float32), (np.arange(w) / 40.0).astype(np.float32)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[None, :, None, None], (xs - x0)[None, None, :, None]
    smooth = ((1 - fy) * (1 - fx) * coarse[:, y0][:, :, x0] + (1 - fy) * fx * coarse[:, y0][:, :, x0 + 1]
              + fy * (1 - fx) * coarse[:, y0 + 1][:, :, x0] + fy * fx * coarse[:, y0 + 1][:, :, x0 + 1])
    frames = np.clip(smooth + rng.standard_normal(smooth.shape, dtype=np.float32) * 12, 0, 255).astype(np.uint8)
    t = np.arange(n_frames)
    large = (t // 4) % 2 == 1
    bh = np.where(large, 300.0, 150.0) + rng.uniform(-10, 10, n_frames)
    bw = bh * np.where(large, 0.8, 0.45)
    cx = w / 2 + 60 * np.sin(t / 9.0) + rng.uniform(-3, 3, n_frames)
    cy = h / 2 + 15 * np.cos(t / 7.0)
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=1).astype(np.float32)
    return frames, boxes, large


def mesh_config(depth=32, impl="core", bf16=False, frame_batch=32):
    """The mesh stage at full width: ViT-H and the default head; only the
    backbone's depth is ever cut."""
    from video_gen_evals_tpu_torch.models.vit import ViTConfig
    from video_gen_evals_tpu_torch.pipelines.extract import ExtractorConfig

    return ExtractorConfig(
        vit=ViTConfig(depth=depth, attention_impl=impl), frame_batch=frame_batch,
        matmul_precision="default" if bf16 else "highest", param_dtype="bfloat16" if bf16 else "float32")


def _attention_counts():
    from video_gen_evals_tpu_torch.ops.attention import flash_attention
    from video_gen_evals_tpu_torch.ops.attention_core import mha_core, mha_head_batched

    return mha_core, mha_head_batched, flash_attention


def _run_counted(torch, ex, frames, boxes):
    """process_video with the three attention launch counts set to 0 just
    before and read just after: (mesh dict, (K6, K7, K8) launches)."""
    fns = _attention_counts()
    for fn in fns:
        fn.launches = 0
    out = ex.process_video(frames, boxes)
    torch.cuda.synchronize()
    return out, tuple(fn.launches for fn in fns)


def _check_contract(torch, np, mesh, n, tag):
    want = {"pose": (n, 23, 3, 3), "betas": (n, 10), "global_orient": (n, 1, 3, 3), "vit": (n, 1024)}
    for key, shape in want.items():
        _check(mesh[key].shape == shape and mesh[key].dtype == np.float32,
               f"{tag}: {key} is {mesh[key].dtype}{mesh[key].shape}, expected float32{shape}")
        _check(bool(np.isfinite(mesh[key]).all()), f"{tag}: non-finite {key}")
    _check(mesh["frame_idx"].dtype == np.int32 and np.array_equal(mesh["frame_idx"], np.arange(n)),
           f"{tag}: frame_idx")
    worst = 0.0
    for key in ("pose", "global_orient"):
        R = torch.from_numpy(mesh[key]).double()
        worst = max(worst, (R @ R.transpose(-1, -2) - torch.eye(3, dtype=torch.float64)).abs().max().item(),
                    (torch.linalg.det(R) - 1.0).abs().max().item())
    _check(worst <= 1e-4, f"{tag}: rotations off orthonormal by {worst:.2e} > 1e-4")
    return worst


def _max_diff(np, a, b, keys=("vit", "pose", "betas", "global_orient")):
    return {k: float(np.abs(a[k] - b[k]).max()) for k in keys}


def phase_mesh_stage(torch, card):
    import numpy as np

    from video_gen_evals_tpu_torch.data.features import ModalityPaths, load_video_arrays
    from video_gen_evals_tpu_torch.data.manifest import VideoItem
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor
    from video_gen_evals_tpu_torch.utils.io import save_video_npz

    launches = {}
    t0 = time.perf_counter()
    frames, boxes, large = mesh_video()
    n = len(frames)
    chunks = -(-n // 32)
    print(f"mesh: synthetic video {frames.shape} uint8 + boxes made in {time.perf_counter() - t0:.1f} s "
          f"({int(large.sum())} frames take the anti-alias blur, {int((~large).sum())} do not)")

    # full width and depth, fp32, K6
    t0 = time.perf_counter()
    ex = Extractor(mesh_config(), seed=SEED)
    torch.cuda.synchronize()
    params = [p for m in (ex.backbone, ex.head) for p in m.parameters()]
    print(f"mesh: ViT-H depth 32 + SMPL head drawn on the card in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in params) / 1e6:.0f} M parameters, "
          f"{sum(p.numel() * p.element_size() for p in params) / 2**30:.2f} GiB")
    crops = ex.crops(torch.from_numpy(frames[:8]).cuda(), torch.from_numpy(boxes[:8]).cuda())
    _check(tuple(crops.shape) == (8, 256, 192, 3), f"mesh: crops {tuple(crops.shape)}")
    mesh, counts = _run_counted(torch, ex, frames, boxes)
    worst = _check_contract(torch, np, mesh, n, "mesh core")
    _check(counts == (32 * chunks, 0, 0), f"mesh core: launches (K6, K7, K8) {counts} != ({32 * chunks}, 0, 0)")
    launches["mha_core[highest]"] = counts[0]
    ex.set_attention_impl("plain")
    plain, counts = _run_counted(torch, ex, frames, boxes)
    _check(counts == (0, 0, 0), f"mesh plain: attention kernels launched {counts}")
    d = _max_diff(np, mesh, plain)
    print(f"mesh: {n} frames, frame_batch 32 ({chunks} chunks, the last padded), attention_impl core: "
          f"K6 launched {launches['mha_core[highest]']} times; contract shapes, finite, rotations within {worst:.1e}; "
          f"max |core - plain| {d} (tol 1e-3 on vit), max |vit| {np.abs(mesh['vit']).max():.2f}")
    _check(d["vit"] <= 1e-3, f"mesh: token_out core vs plain {d['vit']:.3e} > 1e-3")

    # hand-off to the scoring path's loader
    with tempfile.TemporaryDirectory() as root:
        path = save_video_npz(root, "Synthetic/video_000", **mesh, meta={"frames": n})
        arrays = load_video_arrays(VideoItem("Synthetic", "video_000.npz", path, n, 1024), ModalityPaths())
    got = {k: v.shape for k, v in arrays.items()}
    _check(got == {"vit": (n, 1024), "global": (n, 9), "pose": (n, 207), "beta": (n, 10)},
           f"mesh: the scoring loader read {got}")
    print(f"mesh: save_video_npz -> load_video_arrays: {got}")

    # timing of the stage for each attention_impl on the same weights
    timing_frames, timing_boxes = frames[:64], boxes[:64]
    fps = {}
    for impl in ("core", "head_batched", "flash", "plain"):
        ex.set_attention_impl(impl)
        fps[impl] = _stage_timing(torch, ex, timing_frames, timing_boxes, f"fp32 {impl}", card)
    del ex
    torch.cuda.empty_cache()

    # K7 and K8 on a path, at depth 4, against plain on the same weights
    short_frames, short_boxes = frames[:40], boxes[:40]
    for bf16 in (False, True):
        ex4 = Extractor(mesh_config(depth=4, impl="plain", bf16=bf16), seed=SEED)
        ref, _ = _run_counted(torch, ex4, short_frames, short_boxes)
        tag = "default" if bf16 else "highest"
        for impl, slot, name in (("head_batched", 1, "mha_head_batched"), ("flash", 2, "flash_attention")):
            ex4.set_attention_impl(impl)
            out, counts = _run_counted(torch, ex4, short_frames, short_boxes)
            _check_contract(torch, np, out, 40, f"mesh {impl} {tag}")
            want = tuple(8 if i == slot else 0 for i in range(3))
            _check(counts == want, f"mesh {impl} {tag}: launches {counts} != {want}")
            launches[f"{name}[{tag}]"] = counts[slot]
            d = _max_diff(np, out, ref)
            tol = 1e-3 if not bf16 else BF16_STAGE_TOL * float(np.abs(ref["vit"]).max())
            print(f"mesh depth 4 {tag}: attention_impl {impl} launched its kernel {counts[slot]} times; "
                  f"max |{impl} - plain| {d} (tol {tol:.3g} on vit)")
            _check(d["vit"] <= tol, f"mesh {impl} {tag}: token_out vs plain {d['vit']:.3e} > {tol:.3g}")
        del ex4
        torch.cuda.empty_cache()

    # the card against the CPU's plain versions: depth 2, 4 blurred frames (an
    # unblurred crop is rounded to integers as cv2 does, and a value that
    # falls next to .5 may round the other way on the other device)
    idx = np.where(large)[0][:4]
    small_cfg = mesh_config(depth=2, frame_batch=4)
    on_card = Extractor(small_cfg, seed=SEED)
    t0 = time.perf_counter()
    on_cpu = Extractor(small_cfg, device="cpu", state_dicts={
        "vit": {k: v.cpu() for k, v in on_card.backbone.state_dict().items()},
        "head": {k: v.cpu() for k, v in on_card.head.state_dict().items()}})
    a, counts = _run_counted(torch, on_card, frames[idx], boxes[idx])
    b = on_cpu.process_video(frames[idx], boxes[idx])
    d = _max_diff(np, a, b)
    print(f"mesh depth 2, 4 frames: card (K6 x{counts[0]}) vs CPU plain versions: max |d| {d} "
          f"(tol 1e-3; CPU side {time.perf_counter() - t0:.1f} s)")
    _check(counts[0] == 2 and max(d.values()) <= 1e-3, f"mesh: card vs CPU {d}, K6 launches {counts[0]}")
    del on_card, on_cpu
    torch.cuda.empty_cache()

    # the bf16 fast mode at full depth, same seed and so the same weights rounded
    fast = Extractor(mesh_config(bf16=True), seed=SEED)
    out, counts = _run_counted(torch, fast, frames, boxes)
    _check_contract(torch, np, out, n, "mesh bf16")
    _check(counts == (32 * chunks, 0, 0), f"mesh bf16: launches {counts}")
    launches["mha_core[default]"] = counts[0]
    d = _max_diff(np, out, mesh)
    scale = float(np.abs(mesh["vit"]).max())
    print(f"mesh bf16 fast mode, depth 32: K6[default] launched {counts[0]} times; max |bf16 - fp32| {d}, "
          f"vit relative to max |vit| {d['vit'] / scale:.4f} (tol {BF16_STAGE_TOL})")
    _check(d["vit"] <= BF16_STAGE_TOL * scale, f"mesh bf16: token_out off by {d['vit']:.3e} > {BF16_STAGE_TOL} * {scale:.2f}")
    # the bf16 mode under every kernel attention_impl on the same weights
    for impl in ("core", "head_batched", "flash"):
        fast.set_attention_impl(impl)
        fps[f"{impl} bf16"] = _stage_timing(torch, fast, timing_frames, timing_boxes, f"bf16 {impl}", card)
    del fast
    torch.cuda.empty_cache()
    return launches


def _stage_timing(torch, ex, frames, boxes, tag, card):
    """Frames/s of process_video (host clock; the call ends in its one fetch)
    and CUDA-event ms of one chunk's crop, backbone and head."""
    ex.process_video(frames, boxes)   # warm
    torch.cuda.reset_peak_memory_stats()
    reps = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ex.process_video(frames, boxes)
    dt = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated() / 2**30
    f = torch.from_numpy(frames[:32]).cuda()
    b = torch.from_numpy(boxes[:32]).cuda()
    with torch.inference_mode():
        crops = ex.crops(f, b).to(ex.cfg.working_dtype)
        tokens, _ = ex.backbone(crops)
        parts = (_time_ms(lambda: ex.crops(f, b), 3), _time_ms(lambda: ex.backbone(crops), 3),
                 _time_ms(lambda: ex.head(tokens), 3))
    n_chunks = -(-len(frames) // 32)
    print(f"mesh timing {tag}: {len(frames) / dt:.1f} frames/s ({dt * 1e3 / n_chunks:.1f} ms per 32-frame chunk, upload and "
          f"fetch included); one chunk: crop {parts[0]:.2f} ms, backbone {parts[1]:.2f} ms, head {parts[2]:.2f} ms; "
          f"peak memory {peak:.2f} GiB on {card}")
    return len(frames) / dt


def _k5_work(torch, geom, channels):
    """FMAs that K5's contraction needs on these ROIs: the taps with weight
    (each bin row's span of rows times the span of columns any bin column
    weights, plus the 7 x 7 column sums)."""
    _wy0, _wx0, Wy, Wx, _w, _wx = geom
    rows_nz = (Wy != 0).to(torch.int64)
    col_nz = (Wx != 0).any(dim=1).to(torch.int64)
    idx_y = torch.arange(Wy.shape[2], device=Wy.device)
    ny = torch.where(rows_nz.bool(), idx_y, -1).amax(-1) - torch.where(rows_nz.bool(), idx_y, 10**6).amin(-1) + 1
    idx_x = torch.arange(Wx.shape[2], device=Wx.device)
    nx = torch.where(col_nz.bool(), idx_x, -1).amax(-1) - torch.where(col_nz.bool(), idx_x, 10**6).amin(-1) + 1
    ny, nx = ny.clamp_min(0), nx.clamp_min(0)
    return int(((ny.sum(-1) + 49) * nx).sum().item()) * channels


def _k5_cells(torch, geom, n_images, rois_per_image, buffer_hw):
    """Buffer cells K5 must read on these ROIs: the union, over an image's
    ROIs, of the window cells whose row and column both carry weight (each
    counted once; the zero padding right of the narrow levels and the cells
    no ROI weights are not read)."""
    wy0, wx0, Wy, Wx, _w, _wx = geom
    bufh, bufw = buffer_hw
    dev = Wy.device
    img = torch.arange(n_images, device=dev).repeat_interleave(rois_per_image)
    rows = img[:, None] * bufh + wy0.long()[:, None] + torch.arange(Wy.shape[2], device=dev)
    cols = wx0.long()[:, None] + torch.arange(Wx.shape[2], device=dev)
    flat = rows[:, :, None] * bufw + cols[:, None, :]
    weighted = (Wy != 0).any(dim=1)[:, :, None] & (Wx != 0).any(dim=1)[:, None, :]
    read = torch.zeros(n_images * bufh * bufw, dtype=torch.bool, device=dev)
    read[flat[weighted]] = True
    return int(read.sum().item())


# the seeded R-CNN scores every class alike, so no box passes 0.5 on a frame:
# the person class's logit weights are scaled by this power of two and its
# bias set, on every mode's weights (fp32 or bf16, exactly), so that the
# smoke's video holds frames with one person box and frames with several
RCNN_PERSON_GAIN, RCNN_PERSON_BIAS = 64.0, -2.0


def _k5_loaded_cells(torch, geom) -> int:
    """Cells K5's loads cover on these ROIs: each ROI's weighted rows times
    its weighted columns (the kernel loads a cell once a ROI; overlapping
    ROIs load it again, mostly from L2)."""
    _wy0, _wx0, Wy, Wx, _w, _wx = geom
    return int(((Wy != 0).any(dim=1).sum(-1) * (Wx != 0).any(dim=1).sum(-1)).sum().item())


def _person_class_(torch, rcnn):
    with torch.no_grad():
        cls_score = rcnn.roi_heads.box_predictor.cls_score
        cls_score.weight[0] *= RCNN_PERSON_GAIN
        cls_score.bias[0] = RCNN_PERSON_BIAS


def _reset_k5_counts():
    from video_gen_evals_tpu_torch.ops.roi_align import roi_align_pyramid_dma

    roi_align_pyramid_dma.launches = 0
    for key in roi_align_pyramid_dma.launches_by_dtype:
        roi_align_pyramid_dma.launches_by_dtype[key] = 0


def _over_span_boxes(torch):
    """100 boxes an image of a detect chunk on p2, wider than any window."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x0 = torch.rand(RCNN_BATCH, 100, generator=g, device="cuda") * 300
    y0 = torch.rand(RCNN_BATCH, 100, generator=g, device="cuda") * 600
    wide = torch.stack([x0, y0, x0 + 240 + torch.rand(RCNN_BATCH, 100, generator=g, device="cuda") * 780,
                        y0 + 8 + torch.rand(RCNN_BATCH, 100, generator=g, device="cuda") * 40], dim=-1)
    return wide, torch.zeros(RCNN_BATCH, 100, dtype=torch.int32, device="cuda")


def _k5_check(torch, buf, offs, lhw, strides, props, levels, window, valid):
    """K5 against its plain version on one detect chunk's packed pyramid and
    proposals and on over-span boxes of the same buffer (within K5_TOL x
    max(1, max |plain|)), ms of both in turns, and the bound: each buffer cell
    some ROI weights read once at the buffer's width, the boxes and levels,
    the float32 output written once. Returns the kernels-line entry."""
    from video_gen_evals_tpu_torch.ops.roi_align import (
        dma_geometry, roi_align_pyramid_dma, roi_align_pyramid_dma_plain)

    args = (buf, offs, lhw, strides, props, levels)
    dtype = str(buf.dtype).replace("torch.", "")
    with torch.inference_mode():
        got = roi_align_pyramid_dma(*args, window=window)
        want = roi_align_pyramid_dma_plain(*args, window=window)
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        _check(bool(torch.isfinite(got).all()) and got.dtype == torch.float32, f"K5[{dtype}]: output not finite float32")
        _check(err <= K5_TOL * scale, f"K5[{dtype}] on the detect chunk: max |kernel - plain| {err:.3e} > {K5_TOL} * {scale:.2f}")
        hist = torch.bincount(levels.flatten().long(), minlength=4).tolist()
        wide, wl = _over_span_boxes(torch)
        ow = roi_align_pyramid_dma(buf, offs, lhw, strides, wide, wl, window=window)
        pw = roi_align_pyramid_dma_plain(buf, offs, lhw, strides, wide, wl, window=window)
        torch.cuda.synchronize()
        scale_w = max(1.0, pw.abs().max().item())
        err_w = (ow - pw).abs().max().item()
        _check(err_w <= K5_TOL * scale_w, f"K5[{dtype}] over-span: max |kernel - plain| {err_w:.3e} > {K5_TOL} * {scale_w:.2f}")
        ms, plain_ms = _interleaved_ms(lambda: roi_align_pyramid_dma(*args, window=window),
                                       lambda: roi_align_pyramid_dma_plain(*args, window=window), 5)
        geom = dma_geometry(tuple(buf.shape[1:3]), offs, lhw, strides, props.reshape(-1, 4), levels.reshape(-1),
                            window=window)
        fmas = _k5_work(torch, geom, buf.shape[-1])
        cells = _k5_cells(torch, geom, *props.shape[:2], tuple(buf.shape[1:3]))
        loaded = _k5_loaded_cells(torch, geom)
    level_cells = props.shape[0] * sum(h * w for h, w in lhw)
    nbytes = buf.element_size() * cells * buf.shape[-1] + 4 * (props.numel() + levels.numel() + got.numel())
    bound_ms, bound_by = _bound(nbytes, 2 * fmas, PEAK_FP32)
    print(f"K5 roi_align_pyramid_dma[{dtype}] on one detect chunk, window {geom[4]} x {geom[5]}: buffer "
          f"{tuple(buf.shape)} {dtype} ({buf.numel() * buf.element_size() / 1e6:.1f} MB, {level_cells} level cells, "
          f"{cells} of them weighted by some ROI), {props.shape[0]} x {props.shape[1]} proposals "
          f"({int(valid.sum())} valid; levels p2..p5 {hist}): max |kernel - plain| {err:.2e} (tol {K5_TOL} x "
          f"{scale:.2f} = {K5_TOL * scale:.2e}); over-span boxes {err_w:.2e} (tol {K5_TOL} x {scale_w:.2f} = "
          f"{K5_TOL * scale_w:.2e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.1f} MB, {2 * fmas / 1e9:.2f} GFLOP of weighted taps); "
          f"no single PyTorch call computes ROIAlign (and no torchvision on the card)")
    cell_bytes = buf.element_size() * buf.shape[-1]
    vec = "vec16=1" if buf.shape[-1] % (16 // buf.element_size()) == 0 else "vec16=0"
    print(f"   its loads cover {loaded} cells a chunk, {loaded * cell_bytes / 1e6:.1f} MB ({loaded / cells:.2f} x the "
          f"union of {cells} weighted cells, {cells * cell_bytes / 1e6:.1f} MB, that the bound counts); ptxas "
          f"{_ptxas_line('roi_align_kernel<' + ('float' if dtype == 'float32' else 'bf16') + ', ' + vec)}")
    return dict(max_abs_err=max(err, err_w), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _detect_fps(torch, ex, frames_dev, reps=2):
    """Seconds of one detect_stage pass over the video (host clock after a
    synchronize; the results stay on the card), and the peak memory in GiB."""
    with torch.inference_mode():
        ex.detect_stage(frames_dev)   # warm
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            ex.detect_stage(frames_dev)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, torch.cuda.max_memory_allocated() / 2**30


def _rcnn_split(torch, ex, frames_dev) -> str:
    """CUDA-event ms of one detect chunk's parts: resize, backbone + FPN, RPN
    + proposals, pool (pack + K5), box head + postprocess, and the two NMS
    loops alone at the chunk's shapes (1000 steps of two launches each,
    whatever the boxes): frames x 5 levels of rpn_pre_nms_topk candidates,
    then frames x second_stage_candidates."""
    from video_gen_evals_tpu_torch.models.rcnn import fast_rcnn_postprocess, nms_masked, predictor_canvas

    rc, rcnn = ex.cfg.rcnn, ex.rcnn
    with torch.inference_mode():
        chunk = frames_dev[:RCNN_BATCH]
        canvas, hw = predictor_canvas(chunk, rc)
        feats = rcnn.backbone_features(canvas)
        props, valid = rcnn.proposals(feats, hw)
        pooled = rcnn.pool(feats, props)
        K = props.shape[1]

        def head_post():
            c, d = rcnn.box_head(pooled.reshape(-1, *pooled.shape[2:]))
            return fast_rcnn_postprocess(c.reshape(RCNN_BATCH, K, -1), d.reshape(RCNN_BATCH, K, -1), props, valid,
                                         hw, rc)

        parts = {
            "resize": _time_ms(lambda: predictor_canvas(chunk, rc), 3),
            "backbone + FPN": _time_ms(lambda: rcnn.backbone_features(canvas), 3),
            "RPN + proposals": _time_ms(lambda: rcnn.proposals(feats, hw), 3),
            "pool (pack + K5)": _time_ms(lambda: rcnn.pool(feats, props), 3),
            "box head + postprocess": _time_ms(head_post, 3),
        }
        rpn_boxes = props.repeat(len(feats), 1, 1)
        rpn_valid = torch.ones(rpn_boxes.shape[:2], dtype=torch.bool, device=rpn_boxes.device)
        nms_ms = [_time_ms(lambda: nms_masked(rpn_boxes, rpn_valid, rc.rpn_nms_thresh), 3),
                  _time_ms(lambda: nms_masked(props, valid, rc.test_nms_thresh), 3)]
    return (", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            + f"; NMS loops alone: RPN {nms_ms[0]:.2f} ({rc.rpn_pre_nms_topk} steps over {RCNN_BATCH} x 5 levels), "
            f"second stage {nms_ms[1]:.2f}")


def phase_detector(torch, card):
    """Phase 8: the R-CNN detect stage at full width, K5 on its own tensors,
    process_video from raw frames, the small config against the CPU, timings."""
    import dataclasses

    import numpy as np

    from video_gen_evals_tpu_torch.models.rcnn import FasterRCNN, RCNNConfig, init_rcnn_weights_, predictor_canvas
    from video_gen_evals_tpu_torch.models.vit import ViTConfig
    from video_gen_evals_tpu_torch.ops.attention_core import mha_core
    from video_gen_evals_tpu_torch.ops.roi_align import assign_fpn_levels, pack_pyramid, roi_align_pyramid_dma
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor, ExtractorConfig

    frames, _boxes, _large = mesh_video()
    n = len(frames)
    chunks = -(-n // RCNN_BATCH)
    cfg = ExtractorConfig(vit=ViTConfig(depth=32, attention_impl="core"), frame_batch=32,
                          matmul_precision="highest", mesh_detector="rcnn", keep_all_frames=True)
    t0 = time.perf_counter()
    ex = Extractor(cfg, seed=SEED)
    _person_class_(torch, ex.rcnn)
    torch.cuda.synchronize()
    n_det = sum(p.numel() for p in ex.rcnn.parameters())
    print(f"rcnn: X101-32x8d-FPN ({n_det / 1e6:.1f} M parameters) + ViT-H depth 32 + SMPL head drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s")

    # the main path: process_video from raw frames, counts set to 0 just before
    _reset_k5_counts()
    mha_core.launches = 0
    t0 = time.perf_counter()
    mesh = ex.process_video(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (roi_align_pyramid_dma.launches, mha_core.launches)
    worst = _check_contract(torch, np, mesh, n, "rcnn process_video")
    _check(counts == (chunks, 32 * -(-n // 32)) and roi_align_pyramid_dma.launches_by_dtype["float32"] == chunks,
           f"rcnn process_video: launches (K5, K6) {counts}, K5 by type {roi_align_pyramid_dma.launches_by_dtype}")
    print(f"rcnn: process_video({n} frames of {MESH_HW[0]} x {MESH_HW[1]}), mesh_detector rcnn, no boxes: "
          f"{wall:.2f} s cold; K5 launched {counts[0]} times ({chunks} chunks of {RCNN_BATCH}), K6 {counts[1]}; "
          f"contract shapes, finite, rotations within {worst:.1e}")
    launches = {"roi_align_pyramid_dma": counts[0]}

    frames_dev = torch.from_numpy(frames).cuda()
    det = ex.detect_stage(frames_dev)
    single = det["single"].cpu().numpy()
    box = det["box_mesh"]
    _check(bool(torch.isfinite(box).all()) and bool((box[:, 2] <= MESH_HW[1]).all())
           and bool((box[:, 3] <= MESH_HW[0]).all()) and bool((box[:, :2] >= 0).all()),
           "rcnn: detect-stage boxes not finite or outside the frame")
    ex.cfg.keep_all_frames = False
    filtered = ex.process_video(frames)
    ex.cfg.keep_all_frames = True
    accept = single.sum() > 0 and single.mean() >= cfg.min_single_ratio
    if accept:
        _check(filtered is not None and np.array_equal(filtered["frame_idx"], np.flatnonzero(single)),
               "rcnn keep_all_frames=False: kept frames differ from the detector's single mask")
    else:
        _check(filtered is None, "rcnn keep_all_frames=False: a video below min_single_ratio was kept")
    print(f"rcnn: detector's single-person mask holds {int(single.sum())} of {n} frames, present "
          f"{int(det['present'].sum())}; keep_all_frames=False -> "
          f"{'None (rejected)' if filtered is None else str(len(filtered['frame_idx'])) + ' frames'}, as the rule says")

    dt, peak = _detect_fps(torch, ex, frames_dev)

    # K5 against its plain version on chunk 0's own pyramid and proposals
    results = {}
    rc = ex.cfg.rcnn
    with torch.inference_mode():
        canvas, hw = predictor_canvas(frames_dev[:RCNN_BATCH], rc)
        feats = ex.rcnn.backbone_features(canvas)
        props, valid = ex.rcnn.proposals(feats, hw)
        levels = assign_fpn_levels(props)
        buf, offs, lhw = pack_pyramid(feats[:4])
    results["roi_align_pyramid_dma"] = _k5_check(torch, buf, offs, lhw, rc.strides[:4], props, levels,
                                                 rc.roi_window, valid)
    split = _rcnn_split(torch, ex, frames_dev)
    print(f"rcnn timing: detect stage {n / dt:.1f} frames/s ({dt * 1e3 / chunks:.1f} ms per {RCNN_BATCH}-frame chunk, "
          f"upload excluded, the chunks' results kept on the card); one chunk: {split} ms; "
          f"peak memory {peak:.2f} GiB with both nets' weights on {card}")
    del ex, feats, buf, canvas
    torch.cuda.empty_cache()

    # the small config on the card against the CPU's plain versions, K5 pinned on both
    small = dataclasses.replace(RCNNConfig.small(), roi_impl="dma")
    on_card = FasterRCNN(small).cuda().eval()
    init_rcnn_weights_(on_card, torch.Generator(device="cuda").manual_seed(SEED))
    with torch.no_grad():   # class logits of order 3, so that boxes pass the 0.25 score threshold
        on_card.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    on_cpu = FasterRCNN(small).eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    with torch.inference_mode():
        x, small_hw = predictor_canvas(frames_dev[np.arange(4) * 17], small)
        xc = x.cpu()
        d_feat = max((a.cpu() - b).abs().max().item() for a, b in zip(on_card.backbone_features(x),
                                                                      on_cpu.backbone_features(xc)))
        d_rpn = max((a.cpu() - b).abs().max().item()
                    for pa, pb in zip(on_card.rpn_raw(x), on_cpu.rpn_raw(xc)) for a, b in zip(pa, pb))
        fixed = torch.tensor([[4.0, 4.0, 40.0, 40.0], [10.0, 5.0, 70.0, 44.0], [0.0, 0.0, 80.0, 45.0],
                              [30.0, 10.0, 34.0, 18.0]]).expand(4, 4, 4).contiguous()
        lv = assign_fpn_levels(fixed)
        roi_align_pyramid_dma.launches = 0
        box_card = on_card.box_forward(x, fixed.cuda(), lv.cuda())
        box_cpu = on_cpu.box_forward(xc, fixed, lv)
        d_box = max((a.cpu() - b).abs().max().item() for a, b in zip(box_card, box_cpu))
        det_card, det_cpu = on_card(x, image_hw=small_hw), on_cpu(xc, image_hw=small_hw)
        torch.cuda.synchronize()
    _check(roi_align_pyramid_dma.launches == 2, f"rcnn small on the card: K5 launched {roi_align_pyramid_dma.launches}")
    v = det_cpu["valid"]
    same = torch.equal(det_card["valid"].cpu(), v) and torch.equal(det_card["classes"].cpu()[v], det_cpu["classes"][v])
    d_det = (det_card["boxes"].cpu()[v] - det_cpu["boxes"][v]).abs().max().item() if v.any() else 0.0
    print(f"rcnn small config, 4 frames, card (K5) vs CPU (its plain version): levels {d_feat:.2e}, RPN {d_rpn:.2e}, "
          f"box_forward {d_box:.2e} (tol 1e-4); {int(v.sum())} detections, valid and classes "
          f"{'equal' if same else 'DIFFER'}, boxes {d_det:.2e} (tol 5e-3)")
    _check(max(d_feat, d_rpn, d_box) <= 1e-4, "rcnn small: card vs CPU beyond 1e-4")
    _check(same and d_det <= 5e-3, "rcnn small: detections differ between card and CPU")
    return results, launches, {"box_mesh": box.cpu(), "single": torch.from_numpy(single),
                               "present": det["present"].cpu()}


# the detect-stage boxes of another detector mode against the exact fp32 run's:
# the best person box of each frame where both runs find a person, where the
# two are the same person (IoU >= 0.5; the class-wise NMS at 0.5 leaves no two
# kept person boxes of one run overlapping more, so a frame whose best box
# switched to another detection drops out), the median IoU at least 0.9.
# fast() changes only the pool (the levels rounded to bf16, 2^-9 relative, and
# a 32-row window), the bf16 mode every layer of the detector (2^-8 relative
# through 33 blocks); with the seeded weights a box is its proposal refined by
# small deltas (the box predictor's std is 0.001), so the same detection moves
# by a fraction of a pixel. And at most a sixth of the frames may flip between
# one person and not, or between a person and none.
MODE_IOU, MODE_FLIPS = 0.9, 1 / 6


def _compare_boxes(torch, det, exact, tag):
    """Flips of the single-person and person-present masks, and the IoU of
    the best person boxes where both runs find a person, against the exact
    fp32 run's detect stage."""
    from video_gen_evals_tpu_torch.models.detector import box_iou

    single, present = det["single"].cpu(), det["present"].cpu()
    n = len(single)
    flips = (int((single != exact["single"]).sum()), int((present != exact["present"]).sum()))
    both = present & exact["present"]
    a, b = det["box_mesh"].cpu()[both], exact["box_mesh"][both]
    iou = box_iou(a[:, None], b[:, None])[:, 0, 0]
    same = iou >= 0.5
    med = float(iou[same].median()) if same.any() else float("nan")
    d = (a[same] - b[same]).abs()
    print(f"{tag}: single-person frames {int(single.sum())} (exact fp32 {int(exact['single'].sum())}), frames with a "
          f"person {int(present.sum())} ({int(exact['present'].sum())}); flips {flips[0]} and {flips[1]} of {n}; "
          f"{int(both.sum())} frames with a person in both, the best box the same person (IoU >= 0.5) in "
          f"{int(same.sum())}: median IoU {med:.4f} (tol >= {MODE_IOU}), max |d box| "
          f"{float(d.max()) if len(d) else 0.0:.3f} px, mean {float(d.mean()) if len(d) else 0.0:.4f} px")
    _check(max(flips) <= MODE_FLIPS * n, f"{tag}: {flips} of {n} frames flip the single / present masks")
    _check(not same.any() or med >= MODE_IOU, f"{tag}: median IoU {med:.4f} < {MODE_IOU} against the exact fp32 run")


def phase_detector_modes(torch, card, exact):
    """Phase 9: K5 over a bf16 pyramid on its own tensors; process_video from
    raw frames under RCNNConfig.fast() in fp32 and in the bf16 mode, and the
    bf16 mode with the exact R-CNN, each held against phase 8's exact fp32
    detect stage; the default YOLOX-L detect stage end to end; the small
    YOLOX on the card against the CPU."""
    import numpy as np

    from video_gen_evals_tpu_torch.models.detector import (
        DetectorConfig, YOLOXDetector, dwpose_person_detections, init_yolox_weights_, nms_xla_indexed)
    from video_gen_evals_tpu_torch.models.rcnn import RCNNConfig, predictor_canvas
    from video_gen_evals_tpu_torch.models.vit import ViTConfig
    from video_gen_evals_tpu_torch.ops.attention_core import mha_core
    from video_gen_evals_tpu_torch.ops.roi_align import assign_fpn_levels, pack_pyramid, roi_align_pyramid_dma
    from video_gen_evals_tpu_torch.ops.upstream_crops import yolox_letterbox
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor, ExtractorConfig

    frames, _boxes, _large = mesh_video()
    n = len(frames)
    chunks, mesh_chunks = -(-n // RCNN_BATCH), -(-n // 32)
    frames_dev = torch.from_numpy(frames).cuda()
    results, launches = {}, {}
    modes = (("fast() fp32", RCNNConfig.fast(), False, "bfloat16"),
             ("fast() bf16 mode", RCNNConfig.fast(), True, "bfloat16"),
             ("exact bf16 mode", RCNNConfig.x101_32x8d(), True, "float32"))
    for tag, rc, bf16, pyramid in modes:
        cfg = ExtractorConfig(vit=ViTConfig(depth=32, attention_impl="core"), frame_batch=32, mesh_detector="rcnn",
                              rcnn=rc, keep_all_frames=True, matmul_precision="default" if bf16 else "highest",
                              param_dtype="bfloat16" if bf16 else "float32")
        ex = Extractor(cfg, seed=SEED)
        _person_class_(torch, ex.rcnn)
        if tag == "fast() fp32":   # K5 over chunk 0's own levels cast to bf16, fast()'s proposals, window 32
            with torch.inference_mode():
                canvas, hw = predictor_canvas(frames_dev[:RCNN_BATCH], rc)
                feats = ex.rcnn.backbone_features(canvas)
                props, valid = ex.rcnn.proposals(feats, hw)
                buf, offs, lhw = pack_pyramid([f.bfloat16() for f in feats[:4]])
            results["roi_align_pyramid_dma[bfloat16]"] = _k5_check(
                torch, buf, offs, lhw, rc.strides[:4], props, assign_fpn_levels(props), rc.roi_window, valid)
            del canvas, feats, buf
        # the main path, counts set to 0 just before and read just after
        _reset_k5_counts()
        mha_core.launches = 0
        t0 = time.perf_counter()
        mesh = ex.process_video(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_dtype = dict(roi_align_pyramid_dma.launches_by_dtype)
        k6 = mha_core.launches
        worst = _check_contract(torch, np, mesh, n, f"{tag} process_video")
        want = {"float32": 0, "bfloat16": 0, pyramid: chunks}
        _check(by_dtype == want and k6 == 32 * mesh_chunks,
               f"{tag} process_video: K5 launches by pyramid type {by_dtype} != {want}, K6 {k6}")
        if tag == "fast() fp32":
            launches["roi_align_pyramid_dma[bfloat16]"] = by_dtype["bfloat16"]
        print(f"{tag}: process_video({n} frames), mesh_detector rcnn, no boxes: {wall:.2f} s cold; K5[{pyramid}] "
              f"launched {by_dtype[pyramid]} times ({chunks} chunks), K6 {k6}; contract shapes, finite, rotations "
              f"within {worst:.1e}")
        det = ex.detect_stage(frames_dev)
        _check(bool(torch.isfinite(det["box_mesh"]).all()), f"{tag}: non-finite detect-stage boxes")
        _compare_boxes(torch, det, exact, tag)
        dt, peak = _detect_fps(torch, ex, frames_dev)
        print(f"{tag} timing: detect stage {n / dt:.1f} frames/s ({dt * 1e3 / chunks:.1f} ms per {RCNN_BATCH}-frame "
              f"chunk); one chunk: {_rcnn_split(torch, ex, frames_dev)} ms; peak memory {peak:.2f} GiB on {card}")
        del ex
        torch.cuda.empty_cache()

    # the default detector: YOLOX-L at full width, weights drawn on the card
    cfg = ExtractorConfig(det=DetectorConfig.yolox_l(), vit=ViTConfig(depth=32, attention_impl="core"),
                          frame_batch=32, matmul_precision="highest", keep_all_frames=True)
    t0 = time.perf_counter()
    ex = Extractor(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_det = sum(p.numel() for p in ex.detector.parameters())
    print(f"yolox: YOLOX-L ({n_det / 1e6:.2f} M parameters; Megvii's README gives 54.2 M) + ViT-H depth 32 + SMPL "
          f"head drawn on the card in {time.perf_counter() - t0:.1f} s")
    _check(54.0e6 < n_det < 54.4e6, f"yolox: YOLOX-L has {n_det} parameters")
    mha_core.launches = 0
    t0 = time.perf_counter()
    mesh = ex.process_video(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst = _check_contract(torch, np, mesh, n, "yolox process_video")
    _check(mha_core.launches == 32 * mesh_chunks, f"yolox process_video: K6 launched {mha_core.launches}")
    det = ex.detect_stage(frames_dev)
    single = det["single"].cpu().numpy()
    _check(bool(torch.isfinite(det["box_mesh"]).all()) and bool(torch.isfinite(det["box_pose"]).all()),
           "yolox: non-finite detect-stage boxes")
    ex.cfg.keep_all_frames = False
    filtered = ex.process_video(frames)
    ex.cfg.keep_all_frames = True
    if single.sum() > 0 and single.mean() >= cfg.min_single_ratio:
        _check(filtered is not None and np.array_equal(filtered["frame_idx"], np.flatnonzero(single)),
               "yolox keep_all_frames=False: kept frames differ from the detector's single mask")
    else:
        _check(filtered is None, "yolox keep_all_frames=False: a video below min_single_ratio was kept")
    print(f"yolox: process_video({n} frames), mesh_detector yolox, no boxes, keep_all_frames: {wall:.2f} s cold; "
          f"K6 {mha_core.launches}; contract shapes, finite, rotations within {worst:.1e}; single-person mask "
          f"{int(single.sum())} of {n} frames, a pose person in {int(det['present'].sum())}; keep_all_frames=False "
          f"-> {'None (rejected)' if filtered is None else str(len(filtered['frame_idx'])) + ' frames'}, as the rule says")
    dt, peak = _detect_fps(torch, ex, frames_dev)
    size = cfg.det.input_hw[0]
    with torch.inference_mode():
        chunk = frames_dev[:32]
        canvas, _ratio = yolox_letterbox(chunk.float(), size)
        raw = ex.detector(canvas)
        best = (raw["obj"][..., None] * raw["cls"]).amax(-1)
        cand = torch.where(best > cfg.pose_det_prefilter, best, 0.0)
        parts = {
            "letterbox": _time_ms(lambda: yolox_letterbox(chunk.float(), size), 3),
            "detector": _time_ms(lambda: ex.detector(canvas), 3),
            "postprocess": _time_ms(lambda: dwpose_person_detections(raw, cfg.pose_det_prefilter, cfg.pose_det_iou,
                                                                     cfg.det.max_detections), 3),
            "NMS": _time_ms(lambda: nms_xla_indexed(raw["boxes"], cand, cfg.pose_det_iou, cfg.det.max_detections), 3),
        }
    print(f"yolox timing: detect stage {n / dt:.1f} frames/s ({dt * 1e3 / mesh_chunks:.1f} ms per 32-frame chunk); "
          f"one chunk: letterbox {parts['letterbox']:.2f} ms, detector {parts['detector']:.2f} ms, postprocess "
          f"{parts['postprocess']:.2f} ms of which NMS {parts['NMS']:.2f} ms ({4 * cfg.det.max_detections} steps); "
          f"peak memory {peak:.2f} GiB with YOLOX-L and ViT-H on {card}")
    del ex, raw, canvas
    torch.cuda.empty_cache()

    # the small YOLOX on the card against the CPU, on 4 letterboxed frames
    small = DetectorConfig(input_hw=(128, 128), width=0.125)
    on_card = YOLOXDetector(small).cuda().eval()
    init_yolox_weights_(on_card, torch.Generator(device="cuda").manual_seed(SEED))
    on_cpu = YOLOXDetector(small).eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    with torch.inference_mode():
        x, _ratio = yolox_letterbox(frames_dev[np.arange(4) * 17].float(), 128)
        a, b = on_card(x), on_cpu(x.cpu())
        d_raw = max((a[k].cpu() - b[k]).abs().max().item() / max(1.0, b[k].abs().max().item()) for k in b)
        da, db = dwpose_person_detections(a), dwpose_person_detections(b)
    m = db[2]
    same = torch.equal(da[2].cpu(), m) and bool(
        ((da[0].cpu()[m] - db[0][m]).abs() <= 1e-4 * max(1.0, db[0][m].abs().max().item() if m.any() else 1.0)).all())
    print(f"yolox small config, 4 frames, card vs CPU: raw boxes, obj and cls within {d_raw:.2e} of max(1, max|x|) "
          f"(tol 1e-4); {int(db[2].sum())} person detections, {'equal' if same else 'DIFFER'}")
    _check(d_raw <= 1e-4 and same, "yolox small: card vs CPU differ")
    return results, launches



# ---------------------------------------------------------------------------
# phase 10: the keypoint branch, process_video_full, the streamed path,
# run_tree, the extract CLI and score_videos_end_to_end

def _pose_config(bf16=False, mesh_detector="yolox", keep_all_frames=True):
    """The extractor at full width: YOLOX-L, ViT-H at depth 32, the SMPL head,
    DWPose-L and, in rcnn mode, the exact X101-32x8d-FPN."""
    from video_gen_evals_tpu_torch.models.detector import DetectorConfig
    from video_gen_evals_tpu_torch.models.pose2d import PoseNetConfig
    from video_gen_evals_tpu_torch.models.vit import ViTConfig
    from video_gen_evals_tpu_torch.pipelines.extract import ExtractorConfig

    return ExtractorConfig(det=DetectorConfig.yolox_l(), vit=ViTConfig(depth=32, attention_impl="core"),
                           pose=PoseNetConfig.dwpose_l(), frame_batch=32, mesh_detector=mesh_detector,
                           keep_all_frames=keep_all_frames, matmul_precision="default" if bf16 else "highest",
                           param_dtype="bfloat16" if bf16 else "float32")


def _config4_inputs(torch):
    """Config 4's frames-to-scores inputs: 4 seeded 72-frame videos named by
    class, a seeded flagship scorer, unit centroids drawn from the seed."""
    import numpy as np

    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES

    names = [f"GenSynth_{cls}_{i:02d}" for i, cls in enumerate(ACTION_CLASSES[:4])]
    videos = {name: mesh_video(seed=SEED + 20 + i)[0] for i, name in enumerate(names)}
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF), generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    centroids = rng.normal(size=(len(ACTION_CLASSES), model.config.d_model)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=-1, keepdims=True)
    return names, videos, model, centroids, {c: i for i, c in enumerate(ACTION_CLASSES)}


def _kp_clear(torch, ex, frames_dev):
    """``[T, 120]`` bool: the kp120 entries whose keypoint is no near tie on
    this extractor (both SimCC axes' top-two gaps and the score's distance
    from 0.3 above POSE_LOGIT_TOL of the logits' scale)."""
    from video_gen_evals_tpu_torch.models.pose2d import wholebody_to_openpose
    from video_gen_evals_tpu_torch.ops.upstream_crops import dwpose_topdown_crop

    cfg = ex.cfg

    def chunk(frames, boxes):
        with torch.inference_mode():
            crops, _, _ = dwpose_topdown_crop(frames.float(), boxes, cfg.pose.input_hw, cfg.pose_padding)
            lx, ly = ex.pose_net.logits(crops)
            tol = POSE_LOGIT_TOL * max(1.0, lx.abs().max().item(), ly.abs().max().item())
            top = [torch.topk(a, 2, dim=-1).values for a in (lx, ly)]
            score = torch.minimum(top[0][..., 0], top[1][..., 0])
            clear = ((top[0][..., 0] - top[0][..., 1] > tol) & (top[1][..., 0] - top[1][..., 1] > tol)
                     & ((score - 0.3).abs() > tol) & (score.abs() > tol))
            _, c134 = wholebody_to_openpose(torch.zeros(*clear.shape, 2, device=clear.device), clear.float())
            rows = torch.cat([c134[:, :18], c134[:, 92:134]], dim=1) > 0.5
        return {"clear": rows.repeat_interleave(2, dim=1)}

    det = ex.detect_stage(frames_dev, with_keypoints=True)
    return ex._batched(chunk, frames_dev, det["box_pose"])["clear"]


def _check_kp120(torch, np, ex, frames, kp, tag):
    """kp120 ``[T, 120]`` float32 and valid ``[T]`` bool; each keypoint either
    (-1, -1) or its frame position (x * W, y * H) inside its pose crop's
    window (DWPose's backmap lands there)."""
    from video_gen_evals_tpu_torch.ops.upstream_crops import dwpose_center_scale

    n, H, W = frames.shape[:3]
    _check(kp["kp120"].shape == (n, 120) and kp["kp120"].dtype == np.float32, f"{tag}: kp120 {kp['kp120'].shape}")
    _check(kp["valid"].shape == (n,) and kp["valid"].dtype == bool, f"{tag}: valid {kp['valid'].shape}")
    pairs = kp["kp120"].reshape(n, 60, 2)
    _check(bool(np.isfinite(pairs).all()), f"{tag}: non-finite kp120")
    hidden = (pairs == -1).all(-1)
    det = ex.detect_stage(torch.from_numpy(frames).cuda(), with_keypoints=True)
    center, scale = (a.cpu().numpy()[:, None] for a in dwpose_center_scale(det["box_pose"], ex.cfg.pose.input_hw,
                                                                           ex.cfg.pose_padding))
    px = pairs * np.array([W, H], np.float32)
    inside = (np.abs(px - center) <= scale / 2 + 1e-3 * np.maximum(1.0, np.abs(center))).all(-1)
    _check(bool((hidden | inside).all()), f"{tag}: a keypoint neither -1 nor inside its crop window")
    return int(hidden.sum())


def phase_keypoints(torch, card, keep):
    """Phase 10: DWPose-L on the keypoint branch and everything that needs it:
    process_video_keypoints, process_video_full in both detector modes and
    both precision modes, the pose net on the card against the CPU, the
    streamed path, run_tree and the CLI on a .npy tree, and
    score_videos_end_to_end. The .npy tree and the CLI's outputs stay under
    ``keep`` for phase 11."""
    import numpy as np

    from video_gen_evals_tpu_torch.data.features import ModalityPaths, load_video_arrays
    from video_gen_evals_tpu_torch.data.manifest import VideoItem, VideoManifest
    from video_gen_evals_tpu_torch.data.windows import enumerate_windows
    from video_gen_evals_tpu_torch.models.pose2d import (
        PoseNetConfig, RTMPoseNet, init_pose_weights_, simcc_decode, wholebody_to_openpose)
    from video_gen_evals_tpu_torch.ops.attention_core import mha_core
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
    from video_gen_evals_tpu_torch.ops.roi_align import roi_align_pyramid_dma
    from video_gen_evals_tpu_torch.ops.upstream_crops import dwpose_backmap, dwpose_topdown_crop
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor
    from video_gen_evals_tpu_torch.pipelines.extract import main as extract_main
    from video_gen_evals_tpu_torch.pipelines.full import score_videos_end_to_end
    from video_gen_evals_tpu_torch.pipelines.score import ScoreConfig
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES

    frames, _boxes, _large = mesh_video()
    n, (H, W) = len(frames), MESH_HW
    chunks = -(-n // 32)
    frames_dev = torch.from_numpy(frames).cuda()
    launches = {}

    def counting(module):
        calls = [0]
        module.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
        return calls

    # DWPose-L in the yolox mode, keep_all_frames
    t0 = time.perf_counter()
    ex = Extractor(_pose_config(), seed=SEED)
    torch.cuda.synchronize()
    pcfg = ex.cfg.pose
    n_pose = sum(p.numel() for p in ex.pose_net.parameters())
    _check(pcfg.input_hw == (384, 288) and pcfg.num_keypoints == 133 and pcfg.simcc_bins == (576, 768)
           and (pcfg.deepen_factor, pcfg.widen_factor, pcfg.gau_dim, pcfg.gau_s) == (1.0, 1.0, 256, 128),
           f"keypoints: the pose net is not DWPose-L's geometry: {pcfg}")
    print(f"keypoints: DWPose-L (RTMPose-l, 384 x 288 crops, 133 keypoints, 576 x 768 SimCC bins; "
          f"{n_pose / 1e6:.2f} M parameters) + YOLOX-L + ViT-H depth 32 + SMPL head drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    kp = ex.process_video_keypoints(frames)
    torch.cuda.synchronize()
    hidden = _check_kp120(torch, np, ex, frames, kp, "process_video_keypoints")
    print(f"keypoints: process_video_keypoints({n} frames): kp120 {kp['kp120'].shape} float32, valid "
          f"{int(kp['valid'].sum())} of {n}; finite, {hidden} of {n * 60} keypoints -1, the rest inside their crops")

    yolox_calls = counting(ex.detector)
    yolox_calls[0] = mha_core.launches = 0
    mesh, kp_full = ex.process_video_full(frames, with_keypoints=True)
    torch.cuda.synchronize()
    worst = _check_contract(torch, np, mesh, n, "process_video_full yolox")
    _check(yolox_calls[0] == chunks and mha_core.launches == 32 * chunks,
           f"process_video_full yolox: YOLOX ran {yolox_calls[0]} times, K6 {mha_core.launches}")
    _check(np.array_equal(kp_full["kp120"], kp["kp120"]), "process_video_full yolox: kp120 differs from "
           "process_video_keypoints'")
    launches["K6 yolox"] = mha_core.launches
    print(f"keypoints: process_video_full({n} frames, with_keypoints) yolox mode: YOLOX ran {yolox_calls[0]} "
          f"times for both branches ({chunks} chunks), K6 {mha_core.launches}; contract shapes, rotations within "
          f"{worst:.1e}; kp120 equal to process_video_keypoints'")

    # rcnn mode: the same YOLOX and pose weights (seeds + 1 and + 3)
    rc = Extractor(_pose_config(mesh_detector="rcnn"), seed=SEED)
    _person_class_(torch, rc.rcnn)
    rcnn_calls, rc_yolox_calls = counting(rc.rcnn), counting(rc.detector)
    _reset_k5_counts()
    mha_core.launches = 0
    mesh_rc, kp_rc = rc.process_video_full(frames, with_keypoints=True)
    torch.cuda.synchronize()
    k5 = roi_align_pyramid_dma.launches
    _check_contract(torch, np, mesh_rc, n, "process_video_full rcnn")
    want = (-(-n // RCNN_BATCH), -(-n // RCNN_BATCH), chunks, 32 * chunks)
    got = (rcnn_calls[0], k5, rc_yolox_calls[0], mha_core.launches)
    _check(got == want, f"process_video_full rcnn: (R-CNN, K5, YOLOX, K6) {got} != {want}")
    _check(np.array_equal(kp_rc["kp120"], kp_full["kp120"]) and np.array_equal(kp_rc["valid"], kp_full["valid"]),
           "process_video_full rcnn: kp120 is not bitwise the yolox mode's")
    launches["K5 rcnn"], launches["K6 rcnn"] = k5, mha_core.launches
    print(f"keypoints: process_video_full rcnn mode: R-CNN ran {got[0]} times, K5 {got[1]}, YOLOX {got[2]}, K6 "
          f"{got[3]}; kp120 bitwise the yolox mode's")

    # the reference's rule
    ex.cfg.keep_all_frames = False
    single = ex.detect_stage(frames_dev)["single"].cpu().numpy()
    ruled, ruled_kp = ex.process_video_full(frames, with_keypoints=True)
    ex.cfg.keep_all_frames = True
    if single.sum() > 0 and single.mean() >= ex.cfg.min_single_ratio:
        _check(ruled is not None and np.array_equal(ruled["frame_idx"], np.flatnonzero(single))
               and ruled_kp["kp120"].shape == (n, 120), "keep_all_frames=False: kept frames differ from the mask")
    else:
        _check(ruled is None and ruled_kp is None, "keep_all_frames=False: a video below min_single_ratio was kept")
    print(f"keypoints: keep_all_frames=False: single-person mask {int(single.sum())} of {n} frames -> "
          f"{'(None, None)' if ruled is None else str(len(ruled['frame_idx'])) + ' mesh frames'}, as the rule says")

    # the pose net on the card against the CPU: the CPU tests' small config
    small = PoseNetConfig(input_hw=(64, 48), num_keypoints=133, widen_factor=0.125, deepen_factor=0.34,
                          gau_dim=32, gau_s=16)
    on_card = RTMPoseNet(small).cuda().eval()
    init_pose_weights_(on_card, torch.Generator(device="cuda").manual_seed(SEED))
    on_cpu = RTMPoseNet(small).eval()
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    with torch.inference_mode():
        idx = torch.arange(4, device="cuda") * 17
        det = ex.detect_yolox(frames_dev[idx])
        crops, _, _ = dwpose_topdown_crop(frames_dev[idx].float(), det["box_pose"], small.input_hw)
        a, b = on_card.logits(crops), on_cpu.logits(crops.cpu())
    scale = max(1.0, *(x.abs().max().item() for x in b))
    d = max((x.cpu() - y).abs().max().item() for x, y in zip(a, b)) / scale
    kp_a, kp_b = simcc_decode(*(x.cpu() for x in a), small.simcc_ratio)[0], simcc_decode(*b, small.simcc_ratio)[0]
    gaps = [torch.topk(x, 2, dim=-1).values for x in b]
    clear = (gaps[0][..., 0] - gaps[0][..., 1] > POSE_LOGIT_TOL * scale) & (gaps[1][..., 0] - gaps[1][..., 1]
                                                                          > POSE_LOGIT_TOL * scale)
    same = bool((kp_a[clear] == kp_b[clear]).all())
    print(f"keypoints: small pose net, 4 frames, card vs CPU: SimCC logits within {d:.2e} of max(1, max|x|) (tol "
          f"{POSE_LOGIT_TOL}); keypoints {'equal' if same else 'DIFFER'} on {int(clear.sum())} of {clear.numel()} "
          f"({int((~clear).sum())} excused as near ties)")
    _check(d <= POSE_LOGIT_TOL and same, "keypoints: small pose net card vs CPU differ")

    # the bf16 mode's pose net against fp32 on the same crops (the same weights rounded)
    bf16 = RTMPoseNet(pcfg).cuda().eval()
    bf16.load_state_dict(ex.pose_net.state_dict())
    bf16.to(torch.bfloat16).fp32_head_()
    with torch.inference_mode():
        det = ex.detect_yolox(frames_dev[:32])
        crops, _, _ = dwpose_topdown_crop(frames_dev[:32].float(), det["box_pose"], pcfg.input_hw)
        la, lb = ex.pose_net.logits(crops), bf16.logits(crops)
        ka, kb = simcc_decode(*la, pcfg.simcc_ratio)[0], simcc_decode(*lb, pcfg.simcc_ratio)[0]
    rel = max(((x - y).norm() / x.norm()).item() for x, y in zip(la, lb))
    rel_max = max(((x - y).abs().max() / x.abs().max()).item() for x, y in zip(la, lb))
    move = (ka - kb).abs().amax(-1)
    print(f"keypoints: DWPose-L bf16 mode vs fp32 on one chunk's crops: SimCC logits ||d|| / ||x|| {rel:.4f} "
          f"(tol {POSE_BF16_TOL}), max |d| / max |x| {rel_max:.4f}; "
          f"{float((move <= 1.0 / pcfg.simcc_ratio).float().mean()):.3f} of keypoints within one bin, largest move "
          f"{move.max().item():.1f} crop pixels")
    _check(rel <= POSE_BF16_TOL, f"keypoints: bf16 pose logits off by {rel:.4f} > {POSE_BF16_TOL}")
    del bf16, on_card, la, lb, crops
    torch.cuda.empty_cache()

    # the streamed path against the per-video one
    other, _, _ = mesh_video(48, (288, 512), seed=SEED + 2)
    items = [("a", frames), ("b", mesh_video(seed=SEED + 1)[0]), ("c", other)]
    mesh_by, kp_by = ex.process_videos_streamed(items, with_keypoints=True)
    worst_mesh, excused = 0.0, 0
    for name, fr in items:
        m, k = ex.process_video_full(fr, with_keypoints=True)
        _check(np.array_equal(mesh_by[name]["frame_idx"], m["frame_idx"])
               and np.array_equal(kp_by[name]["valid"], k["valid"]), f"streamed {name}: masks differ")
        for key in ("vit", "pose", "betas", "global_orient"):
            d = float(np.abs(mesh_by[name][key] - m[key]).max()) / max(1.0, float(np.abs(m[key]).max()))
            worst_mesh = max(worst_mesh, d)
        clear = _kp_clear(torch, ex, torch.from_numpy(fr).cuda())
        excused += int((~clear).sum())
        _check(bool((kp_by[name]["kp120"][clear] == k["kp120"][clear]).all()), f"streamed {name}: keypoints differ")
    _check(worst_mesh <= 1e-4, f"streamed: mesh arrays off by {worst_mesh:.2e} of scale")
    print(f"keypoints: process_videos_streamed over 72 + 72 frames of 360 x 640 and 48 of 288 x 512 against "
          f"process_video_full a video: mesh within {worst_mesh:.1e} of scale (tol 1e-4), masks equal, keypoints "
          f"equal ({excused} entries excused as near ties)")

    # run_tree on a .npy tree, then the CLI at its defaults
    root = keep
    tree = os.path.join(root, "videos")
    for a, action in enumerate(ACTION_CLASSES[:2]):
        os.makedirs(os.path.join(tree, action))
        for v in range(3):
            path = os.path.join(tree, action, f"v{v}.npy")
            if (a, v) == (1, 2):
                with open(path, "wb") as f:
                    f.write(b"corrupt: not a frame stack")
            else:
                np.save(path, mesh_video(32, seed=SEED + 10 + 3 * a + v)[0])
    out = {k: os.path.join(root, k) for k in ("meshes", "kps", "logs")}
    t0 = time.perf_counter()
    counts = ex.run_tree(tree, out["meshes"], out["logs"], kp_out_root=out["kps"])
    wall = time.perf_counter() - t0
    _check(counts == {"single": 5, "not_single": 0, "errors": 1, "skipped": 0}, f"run_tree: counts {counts}")
    with open(os.path.join(out["logs"], "errors", f"{ACTION_CLASSES[1]}.json")) as f:
        errors = json.load(f)
    _check(list(errors) == ["v2.npy"], f"run_tree: errors recorded for {list(errors)}")
    again = ex.run_tree(tree, out["meshes"], out["logs"], kp_out_root=out["kps"])
    _check(again == {"single": 0, "not_single": 0, "errors": 1, "skipped": 5}, f"run_tree resumed: {again}")
    read = set()
    for action in ACTION_CLASSES[:2]:
        for v in range(3 if action == ACTION_CLASSES[0] else 2):
            item = VideoItem(action, f"v{v}.npz", os.path.join(out["meshes"], action, f"v{v}.npz"), 32, 1024)
            arrays = load_video_arrays(item, ModalityPaths(keypoint_dir=out["kps"], layout="real"))
            read.add(tuple(sorted((k, x.shape) for k, x in arrays.items())))
    want = {(("beta", (32, 10)), ("global", (32, 9)), ("kp2d", (32, 120)), ("pose", (32, 207)),
             ("vit", (32, 1024)))}
    _check(read == want, f"run_tree: the scoring loader read {read}")
    _check(os.path.exists(os.path.join(out["logs"], "RUN_CONFIG.json")), "run_tree: no RUN_CONFIG.json")
    print(f"keypoints: run_tree over 2 actions x 3 .npy videos (one corrupt), keep_all_frames, --out-kps: "
          f"{counts} in {wall:.2f} s; resumed: {again} (an error is retried, as the ledger keeps it apart); "
          f"every npz + keypoints.npy read back as the five modalities; RUN_CONFIG.json written")
    t0 = time.perf_counter()
    cli = extract_main(["--videos", tree, "--out-meshes", os.path.join(root, "cli_meshes"),
                        "--out-kps", os.path.join(root, "cli_kps"), "--log-dir", os.path.join(root, "cli_logs")])
    torch.cuda.synchronize()
    _check(cli["errors"] == 1 and cli["single"] + cli["not_single"] == 5 and cli["skipped"] == 0,
           f"extract CLI: counts {cli}")
    print(f"keypoints: python -m video_gen_evals_tpu_torch.pipelines.extract at its defaults (seeded nets, the "
          f"reference's rule) on the same tree: {cli} in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # frames to scores in one call
    names, videos, model, centroids, label_dict = _config4_inputs(torch)
    windows = enumerate_windows(VideoManifest([VideoItem(c, nm, "", n, 1024) for c, nm in zip(ACTION_CLASSES, names)]),
                                CLIP, STRIDE)
    batches = -(-len(windows) // BATCH)
    times = {}
    gather_windows.launches = fused_temporal_block.launches = 0
    result = score_videos_end_to_end(ex, model, videos, centroids, label_dict, phase_times=times,
                                     cfg=ScoreConfig(clip_len=CLIP, stride=STRIDE, batch_size=BATCH))
    torch.cuda.synchronize()
    k1, k3 = gather_windows.launches, fused_temporal_block.launches
    _check(sorted(result.scores) == sorted(names) and not result.rejected, f"full: scored {sorted(result.scores)}")
    _check(all(math.isfinite(s[m]) for s in result.scores.values() for m in ("ac", "tc")), "full: AC or TC not finite")
    _check((k1, k3) == (batches, 40 * batches), f"full: launches K1 {k1}, K3 {k3} != ({batches}, {40 * batches})")
    _check(result.stats.modalities == ["vit", "global", "pose", "beta", "kp2d"], f"full: {result.stats.modalities}")
    launches["K1 full"], launches["K3 full"] = k1, k3
    print(f"keypoints: score_videos_end_to_end over {len(names)} videos of {n} frames (five modalities, "
          f"{len(windows)} windows): AC/TC finite; K1 {k1}, K3 {k3} ({batches} batch); extract_s "
          f"{times['extract_s']:.2f}, bank_s {times['bank_s']:.2f}, score_s {times['score_s']:.2f} on {card}")

    # times: the keypoint branch, then process_video_full in each mode
    with torch.inference_mode():
        chunk = frames_dev[:32]
        det = ex.detect_yolox(chunk)
        crops, center, scale = dwpose_topdown_crop(chunk.float(), det["box_pose"], pcfg.input_hw, ex.cfg.pose_padding)
        x = crops.permute(0, 3, 1, 2).contiguous()
        feats = ex.pose_net.backbone(x)
        kps, sc = simcc_decode(*ex.pose_net.head(feats), pcfg.simcc_ratio)
        parts = {
            "detect": _time_ms(lambda: ex.detect_yolox(chunk), 3),
            "pose crop": _time_ms(lambda: dwpose_topdown_crop(chunk.float(), det["box_pose"], pcfg.input_hw,
                                                              ex.cfg.pose_padding), 3),
            "pose backbone": _time_ms(lambda: ex.pose_net.backbone(x), 3),
            "pose head + decode": _time_ms(lambda: simcc_decode(*ex.pose_net.head(feats), pcfg.simcc_ratio), 3),
            "backmap + postprocess": _time_ms(lambda: ex.kp_post(*wholebody_to_openpose(
                dwpose_backmap(kps, center, scale, pcfg.input_hw), sc), (float(W), float(H))), 3),
        }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.process_video_keypoints(frames)
    dt = time.perf_counter() - t0
    print(f"keypoints timing: process_video_keypoints {n / dt:.1f} frames/s ({n} frames, upload and fetch "
          f"included); one 32-frame chunk: " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()) + f" on {card}")
    fps = {}
    for tag, bf16_mode, detector, net in (("yolox fp32", False, "yolox", ex), ("rcnn fp32", False, "rcnn", rc),
                                          ("yolox bf16", True, "yolox", None), ("rcnn bf16", True, "rcnn", None)):
        if net is None:   # the fp32 extractors ran this video already
            net = Extractor(_pose_config(bf16=bf16_mode, mesh_detector=detector), seed=SEED)
            if net.rcnn is not None:
                _person_class_(torch, net.rcnn)
            net.process_video_full(frames, with_keypoints=True)   # warm
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.process_video_full(frames, with_keypoints=True)
        dt = time.perf_counter() - t0
        fps[tag] = n / dt
        print(f"keypoints timing: process_video_full with keypoints, {tag}: {n / dt:.1f} frames/s ({n} frames); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
        if net is not ex:
            del net
        torch.cuda.empty_cache()
    del ex, rc
    torch.cuda.empty_cache()
    return launches, dict(tree=tree, cli={k: os.path.join(root, f"cli_{k}") for k in ("meshes", "kps", "logs")},
                          cli_counts=cli)


def _rank_share(batches: int, rank: int, world: int) -> int:
    """The batches of a sweep that ``rank`` encodes: every world-th, from its own index."""
    return len(range(rank, batches, world))


def _tree_files(np, root):
    """Every file under ``root`` by relative path: an npz's arrays, a .npy's
    array, a JSON ledger's entries as a sorted list."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
            elif name.endswith(".npy"):
                out[rel] = {"": np.load(path)}
    return out


def _ledger_entries(log_dir):
    """{(kind, action): videos} of a log dir's ledgers, per-host ones merged."""
    out = {}
    for kind in ("single", "not_single", "errors"):
        d = os.path.join(log_dir, kind)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, name)) as f:
                out.setdefault((kind, name.split(".")[0]), set()).update(json.load(f))
    return out


def _same_files(np, got_root, want_root, tag):
    """The files under ``got_root`` against ``want_root``'s: the same paths,
    frame indices and keypoints equal, the mesh arrays within phase 10's 1e-4
    of scale. Returns (files, bitwise)."""
    got, want = _tree_files(np, got_root), _tree_files(np, want_root)
    _check(sorted(got) == sorted(want), f"{tag}: files {sorted(got)} != {sorted(want)}")
    bitwise, worst = True, 0.0
    for path, arrays in want.items():
        _check(sorted(got[path]) == sorted(arrays), f"{tag}: {path} holds {sorted(got[path])}")
        for k, v in arrays.items():
            same = np.array_equal(got[path][k], v)
            bitwise = bitwise and same
            if k in ("vit", "pose", "betas", "global_orient"):
                worst = max(worst, float(np.abs(got[path][k] - v).max()) / max(1.0, float(np.abs(v).max())))
            else:
                _check(same, f"{tag}: {path} {k or 'keypoints'} differs")
    _check(worst <= 1e-4, f"{tag}: mesh arrays off by {worst:.2e} of scale (tol 1e-4)")
    return len(want), bitwise


def _parallel_extract_rank(rank, tree, out_root, log_dir, kp_root):
    """Phase 11: one rank of a 2-rank ``run_tree`` over phase 10's tree with
    phase 10's full-width extractor (keep_all_frames), one video at a time,
    on the shard the extract CLI's ``--mesh-data`` gives it."""
    import torch

    from video_gen_evals_tpu_torch.ops import launch_counts
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor, rank_shard

    shard, shards = rank_shard(0, 1, rank.rank, rank.world)
    ex = Extractor(_pose_config(), seed=SEED, device=rank.device)
    counts = ex.run_tree(tree, out_root, log_dir, kp_out_root=kp_root, stream_group=1, num_hosts=shards,
                         host_id=shard)
    torch.cuda.synchronize()
    return {"counts": counts, "launches": launch_counts()}


def phase_parallel(torch, card, train_ctx, kp_ctx, root):
    """Phase 11: the collectives on the card, then the CLIs on two ranks
    sharing the card (gloo) and as two hosts, against phases 5 and 10's
    one-rank runs; then the reporting CLIs."""
    import copy

    import numpy as np

    from video_gen_evals_tpu_torch.human.mos import AC_KEY, TC_KEY
    from video_gen_evals_tpu_torch.human.mos import main as mos_main
    from video_gen_evals_tpu_torch.ops.conv_kernel_train import LAUNCHES_PER_BACKWARD
    from video_gen_evals_tpu_torch.parallel import (
        all_gather_rows, all_reduce_sum, barrier, broadcast_, initialize_distributed, launch_local, shutdown)
    from video_gen_evals_tpu_torch.parallel.mesh import free_port
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor
    from video_gen_evals_tpu_torch.pipelines.extract import main as extract_main
    from video_gen_evals_tpu_torch.pipelines.leaderboard import main as leaderboard_main
    from video_gen_evals_tpu_torch.pipelines.merge_scores import SCORE_ATOL, SCORE_RTOL
    from video_gen_evals_tpu_torch.pipelines.merge_scores import main as merge_main
    from video_gen_evals_tpu_torch.pipelines.score import main as score_main
    from video_gen_evals_tpu_torch.pipelines.train_cli import main as train_main

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)

    # (a) NCCL at world 1 on the card: all_gather_rows forward and backward, a sum, a broadcast
    rank = initialize_distributed(f"localhost:{free_port()}", 1, 0, "cuda", join_alone=True)
    try:
        _check(rank.backend == "nccl", f"parallel: a rank alone on its card chose {rank.backend}")
        x = torch.randn(6, 5, device="cuda", requires_grad=True)
        w = torch.randn(6, 5, device="cuda")
        y = all_gather_rows(x, rank)
        (y * w).sum().backward()
        t = torch.randn(7, device="cuda")
        want = t.clone()
        all_reduce_sum([t], rank)
        broadcast_([t], rank)
        barrier(rank)
        torch.cuda.synchronize()
        ok = torch.equal(y, x) and torch.equal(x.grad, w) and torch.equal(t, want)
    finally:
        shutdown(rank)
    _check(ok, "parallel: the NCCL round trip at world 1 changed a value")
    print("parallel (a): NCCL group of 1 on the card: all_gather_rows (forward and its backward's own rows), "
          "all_reduce_sum, broadcast_ and a barrier leave every value as it was")

    # (b) the train CLI on 2 ranks sharing the card (gloo) against phase 5's one-rank run
    ctx = train_ctx
    cfg = copy.deepcopy(ctx["base"])
    cfg.save_dir = os.path.join(root, "SAVE_dp2")
    cfg_path = os.path.join(root, "train_dp2.json")
    cfg.to_json(cfg_path)
    t0 = time.perf_counter()
    ranks = train_main(["--config", cfg_path, "--device", "cuda", "--dp", "2"])
    wall = time.perf_counter() - t0
    _check([r["rank"] for r in ranks] == [0, 1] and ranks[0]["save_dir"] == ranks[1]["save_dir"],
           f"parallel (b): ranks {ranks}")
    one, two = _events(ctx["run_two"]), _events(ranks[0]["save_dir"])
    rel = {}
    for kind, key in (("train_epoch", "loss"), ("eval_loss", "loss"), ("centroid_distance", "avg")):
        a = [e[key] for e in one if e["event"] == kind]
        b = [e[key] for e in two if e["event"] == kind]
        _check(len(a) == len(b) == 2, f"parallel (b): {kind} events {len(a)} vs {len(b)}")
        rel[kind] = [abs(x2 - x1) / abs(x1) for x1, x2 in zip(a, b)]
    worst = max(max(v) for v in rel.values())
    _check(worst <= 2e-3, f"parallel (b): dp 2 losses off by {rel} relative (tol 2e-3)")
    steps = ctx["steps"]
    loss_chunks = -(-ctx["n_test"] // BATCH)
    sweeps = [-(-ctx[k] // BATCH) for k in ("n_train", "n_test", "n_gen")]
    for r in ranks:
        own = sum(_rank_share(nb, r["rank"], 2) for nb in sweeps)
        n = r["launches"]
        got = (n["fused_temporal_block_train"], n["fused_temporal_block_train_bwd"], n["gather_windows"],
               n["fused_temporal_block"])
        want = (40 * steps * 2, 40 * steps * 2 * LAUNCHES_PER_BACKWARD, 2 * (steps + loss_chunks + own),
                2 * 40 * (loss_chunks + own))
        print(f"parallel (b): train CLI --dp 2 rank {r['rank']}: launches K4 forward={got[0]} backward={got[1]} "
              f"K1={got[2]} K3={got[3]}")
        _check(got == want and min(got) > 0, f"parallel (b): rank {r['rank']} launches {got} != {want}")
    second = [e for e in two if e["event"] == "train_epoch"][1]
    print(f"parallel (b): train CLI --dp 2 --device cuda, 2 ranks sharing the card through gloo, 2 epochs of "
          f"{steps} steps in {wall:.1f} s (rank start, host stats + banks included): relative to phase 5's "
          f"one-rank run, epoch by epoch, " + ", ".join(f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in rel.items())
          + f" (tol 2e-3); second epoch {second['clips_per_sec']:.1f} clips/s against the one-rank "
          f"{ctx['clips_per_sec']:.1f} on {card} (two ranks share one card: not expected to beat one rank)")

    # (c) the score CLI on 2 ranks, and as 2 hosts merged, against phase 5's one-rank scores
    with open(ctx["scores"]) as f:
        want_scores = json.load(f)

    def score_argv(out):
        return ["--generated-meshes", ctx["gen_dir"], "--real-meshes", ctx["mesh_root"], "--checkpoint",
                ctx["best"], "--real-kp-dir", ctx["kp_root"], "--gen-kp-dir", ctx["gen_kp"], "--output", out,
                "--no-bug-compat", "--device", "cuda"]

    def score_diff(path, tag):
        with open(path) as f:
            got = json.load(f)
        _check(sorted(got) == sorted(want_scores), f"parallel (c) {tag}: videos differ")
        d = 0.0
        for vid, entry in want_scores.items():
            _check(sorted(got[vid]) == sorted(entry), f"parallel (c) {tag}: {vid} keys differ")
            for m, v in entry.items():
                _check(math.isclose(got[vid][m], v, rel_tol=SCORE_RTOL, abs_tol=SCORE_ATOL),
                       f"parallel (c) {tag}: {vid} {m} {got[vid][m]} vs {v}")
                d = max(d, abs(got[vid][m] - v))
        return d

    t0 = time.perf_counter()
    out_md = os.path.join(root, "scores_md2.json")
    ranks = score_main(score_argv(out_md) + ["--mesh-data", "2"])
    wall_md = time.perf_counter() - t0
    batches = -(-ctx["n_train"] // BATCH) + -(-ctx["n_gen"] // BATCH)
    for r in ranks:
        n = r["launches"]
        print(f"parallel (c): score CLI --mesh-data 2 rank {r['rank']}: launches K1={n['gather_windows']} "
              f"K3={n['fused_temporal_block']}")
        _check(n["gather_windows"] > 0 and n["fused_temporal_block"] == 40 * n["gather_windows"],
               f"parallel (c): rank {r['rank']} launches {n}")
    total = sum(r["launches"]["gather_windows"] for r in ranks)
    _check(total == batches, f"parallel (c): the ranks launched K1 {total} times for {batches} batches")
    d_md = score_diff(out_md, "--mesh-data 2")
    t0 = time.perf_counter()
    shards = [score_main(score_argv(os.path.join(root, "scores_hosts.json"))
                         + ["--num-hosts", "2", "--host-id", str(h)])[0]["output_json"] for h in range(2)]
    merged = os.path.join(root, "scores_merged.json")
    merge_main(shards + ["--output", merged, "--human-scores", ctx["human"]])
    wall_hosts = time.perf_counter() - t0
    d_hosts = score_diff(merged, "2 hosts merged")
    print(f"parallel (c): score CLI --mesh-data 2 ({wall_md:.1f} s, rank start included) and --num-hosts 2 + "
          f"merge_scores ({wall_hosts:.1f} s, two host runs in turn): every AC and TC of {len(want_scores)} videos "
          f"within SCORE_ATOL / SCORE_RTOL ({SCORE_ATOL:g} / {SCORE_RTOL:g}) of phase 5's one-rank scores; max "
          f"|d| {d_md:.2e} and {d_hosts:.2e}")

    # (d) the extract CLI as 2 hosts and on 2 ranks over phase 10's tree, one video at a time, against a
    # one-rank run; then run_tree with keep_all_frames (files for every video) the same three ways
    tree = kp_ctx["tree"]

    def cli(tag, *extra):
        out = {k: os.path.join(root, f"{tag}_{k}") for k in ("meshes", "kps", "logs")}
        got = extract_main(["--videos", tree, "--out-meshes", out["meshes"], "--out-kps", out["kps"],
                            "--log-dir", out["logs"], "--stream-group", "1", *extra])
        return out, got

    t0 = time.perf_counter()
    ref, ref_counts = cli("ref")
    _check(_ledger_entries(ref["logs"]) == _ledger_entries(kp_ctx["cli"]["logs"]),
           "parallel (d): one video at a time, the CLI's ledgers differ from phase 10's")
    hosts = [cli("hosts", "--num-hosts", "2", "--host-id", str(h))[1] for h in range(2)]
    md, md_counts = cli("md2", "--mesh-data", "2")
    wall_cli = time.perf_counter() - t0
    keys = ("single", "not_single", "errors", "skipped")
    _check({k: hosts[0][k] + hosts[1][k] for k in keys} == {k: ref_counts[k] for k in keys}
           and {k: md_counts[k] for k in keys} == {k: ref_counts[k] for k in keys},
           f"parallel (d): counts {hosts} / {md_counts} vs {ref_counts}")
    cli_hosts = {k: os.path.join(root, f"hosts_{k}") for k in ("meshes", "kps", "logs")}
    same = []
    for tag, out in (("--num-hosts 2", cli_hosts), ("--mesh-data 2", md)):
        _check(_ledger_entries(out["logs"]) == _ledger_entries(ref["logs"]), f"parallel (d) {tag}: ledgers differ")
        same.append([_same_files(np, out[k], ref[k], f"parallel (d) {tag}") for k in ("meshes", "kps")])
    for r in md_counts["ranks"]:
        print(f"parallel (d): extract CLI --mesh-data 2 rank {r['rank']} (shard {r['shard']} of {r['shards']}): "
              f"{r['counts']}; launches K6={r['launches']['mha_core']} (the rule rejects a video before its "
              f"mesh stage)")
    print(f"parallel (d): extract CLI at its defaults, --stream-group 1, as --num-hosts 2 and --mesh-data 2 "
          f"({wall_cli:.1f} s with the one-rank run): counts {ref_counts}, the same ledger entries (and phase 10's), "
          f"files {[(n, 'bitwise' if b else 'within tol') for n, b in sum(same, [])]}")

    t0 = time.perf_counter()
    ex = Extractor(_pose_config(), seed=SEED)
    runs = {}
    for tag, hosts_n in (("ref", 1), ("hosts", 2)):
        out = {k: os.path.join(root, f"rt_{tag}_{k}") for k in ("meshes", "kps", "logs")}
        runs[tag] = out
        counts = [ex.run_tree(tree, out["meshes"], out["logs"], kp_out_root=out["kps"], stream_group=1,
                              num_hosts=hosts_n, host_id=h) for h in range(hosts_n)]
        runs[tag + "_counts"] = {k: sum(c[k] for c in counts) for k in keys}
    del ex
    torch.cuda.empty_cache()
    out = {k: os.path.join(root, f"rt_ranks_{k}") for k in ("meshes", "kps", "logs")}
    ranks = launch_local(2, _parallel_extract_rank, tree, out["meshes"], out["logs"], out["kps"], device="cuda")
    wall_rt = time.perf_counter() - t0
    rank_counts = {k: sum(r["counts"][k] for r in ranks) for k in keys}
    _check(runs["hosts_counts"] == rank_counts == runs["ref_counts"] and runs["ref_counts"]["single"] == 5,
           f"parallel (d) run_tree: counts {runs}, ranks {rank_counts}")
    same = [_same_files(np, o[k], runs["ref"][k], f"parallel (d) run_tree {tag}")
            for tag, o in (("2 hosts", runs["hosts"]), ("2 ranks", out)) for k in ("meshes", "kps")]
    for i, r in enumerate(ranks):
        print(f"parallel (d): run_tree rank {i}: {r['counts']}; launches K6={r['launches']['mha_core']}")
        _check(r["launches"]["mha_core"] > 0, f"parallel (d): run_tree rank {i} never launched K6")
    print(f"parallel (d): run_tree with keep_all_frames, one video at a time, as 2 hosts and on 2 ranks sharing "
          f"the card ({wall_rt:.1f} s with the one-rank run): {runs['ref_counts']}, every npz and keypoints.npy "
          f"{'bitwise' if all(b for _, b in same) else 'within tol'} the one-rank run's ({sum(n for n, _ in same)} "
          f"file comparisons)")

    # (e) the reporting CLIs on (c)'s merged scores
    table = os.path.join(root, "comparison_table.json")
    leaderboard_main(["--scores", merged, "--output", table])
    with open(table) as f:
        board = json.load(f)
    values = [v for row in board["table_data"].values() for cell in row.values() for k, v in cell.items()
              if k in ("ac", "tc", "avg") and v is not None]
    _check(board["models"] == ["GenModel0", "GenModel1"] and len(board["actions"]) == 10
           and values and all(0.0 <= v <= 100.0 for v in values), f"parallel (e): leaderboard {board['models']}")
    rng = np.random.default_rng(SEED)
    stems = sorted(want_scores)
    quality = rng.uniform(1, 5, size=(len(stems), 2))
    rows = [{"participant_id": f"p{p}", "video_id": stem, AC_KEY: float(quality[v, 0] + rng.normal(0, 0.3)),
             TC_KEY: float(quality[v, 1] + rng.normal(0, 0.3))}
            for p in range(8) for v, stem in enumerate(stems) for _ in range(2 if v < 3 else 1)]
    raw, mos_out = os.path.join(root, "raw_ratings.json"), os.path.join(root, "human_mos.json")
    with open(raw, "w") as f:
        json.dump(rows, f)
    mos_main(["--input", raw, "--output", mos_out])
    with open(mos_out) as f:
        mos = json.load(f)
    _check(len(mos) == len(stems) and all(math.isfinite(v["ac"]) and math.isfinite(v["tc"]) for v in mos.values()),
           f"parallel (e): MOS of {len(mos)} videos")
    merge_main(shards + ["--output", os.path.join(root, "scores_merged_mos.json"), "--human-scores", mos_out])
    print(f"parallel (e): leaderboard over {len(board['models'])} models x {len(board['actions'])} actions, every "
          f"normalized score in [0, 100]; MOS of {len(mos)} videos from {len(rows)} seeded ratings, correlated "
          f"with the merged scores above")
    print(f"parallel: phase 11 took {time.perf_counter() - t_phase:.1f} s on {card}")


# ---------------------------------------------------------------------------
# phase 12: the bank layer and the CLIs' last flags

def _scores(path):
    with open(path) as f:
        return json.load(f)


def _worst_score_diff(a, b):
    _check(sorted(a) == sorted(b), "bank layer: the runs scored different videos")
    return max(abs(a[v][m] - b[v][m]) for v in a for m in ("ac", "tc"))


def _train_losses(save_dir):
    events = _events(_only_run(save_dir))
    return [e["loss"] for e in events if e["event"] in ("train_epoch", "eval_loss")]


def phase_bank_layer(torch, card, train_ctx, root):
    """Phase 12, on phase 5's tree and checkpoint and phase 10's videos:
    returns the K3 "default" row's entries and its launches."""
    import copy

    import numpy as np

    from video_gen_evals_tpu_torch.data import build_feature_bank, scan_class_tree, scan_generated_flat
    from video_gen_evals_tpu_torch.data import features as feats
    from video_gen_evals_tpu_torch.data.features import ModalityPaths, load_feature_bank
    from video_gen_evals_tpu_torch.data.stats import ModalityStats
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
    from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows
    from video_gen_evals_tpu_torch.pipelines import full as full_mod
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor
    from video_gen_evals_tpu_torch.pipelines.score import ScoreConfig, WindowEncoder
    from video_gen_evals_tpu_torch.pipelines.score import main as score_main
    from video_gen_evals_tpu_torch.pipelines.train_cli import main as train_main
    from video_gen_evals_tpu_torch.train.checkpoint import save_jax_npz_params
    from video_gen_evals_tpu_torch.utils import native_npz, profiling
    from video_gen_evals_tpu_torch.utils.names import ACTION_CLASSES

    t_phase = time.perf_counter()
    ctx = train_ctx
    os.makedirs(root, exist_ok=True)
    cache = os.path.join(root, "cache")
    base = ["--generated-meshes", ctx["gen_dir"], "--real-meshes", ctx["mesh_root"], "--real-kp-dir",
            ctx["kp_root"], "--gen-kp-dir", ctx["gen_kp"], "--no-bug-compat", "--device", "cuda"]
    want = _scores(ctx["scores"])   # phase 5's score CLI run: "high", no cache, K1

    def cli(tag, *flags, ckpt=ctx["best"]):
        out = os.path.join(root, f"scores_{tag}.json")
        hits = feats.CACHE_COUNTS["hit"]
        t0 = time.perf_counter()
        score_main(base + ["--checkpoint", ckpt, "--output", out, *flags])
        torch.cuda.synchronize()
        return _scores(out), feats.CACHE_COUNTS["hit"] - hits, time.perf_counter() - t0

    # (a) --bank-cache cold, then warm; (c) --dump-features on the cold run
    dump = os.path.join(root, "features.npz")
    cold, cold_hits, cold_s = cli("cold", "--bank-cache", cache, "--dump-features", dump)
    warm, warm_hits, warm_s = cli("warm", "--bank-cache", cache)
    _check(cold_hits == 0 and warm_hits == 3, f"bank layer (a): cache hits cold {cold_hits}, warm {warm_hits}")
    _check(cold == want and warm == want, "bank layer (a): the cached runs' scores are not bitwise the uncached "
           f"run's (max |d| cold {_worst_score_diff(cold, want):.3e}, warm {_worst_score_diff(warm, want):.3e})")
    print(f"bank layer (a): score CLI --bank-cache cold {cold_s:.2f} s (0 hits), warm {warm_s:.2f} s "
          f"({warm_hits} hits: stats.npz, real_train_bank.npz, generated_bank.npz); scores bitwise phase 5's "
          f"uncached run on {card}")
    # (b) every --gather-impl on the warm cache
    for impl in ("take", "sliced", "burst"):
        got, _, dt = cli(f"gather_{impl}", "--bank-cache", cache, "--gather-impl", impl)
        _check(got == want, f"bank layer (b): --gather-impl {impl} scores differ from K1's")
        print(f"bank layer (b): --gather-impl {impl}: scores bitwise K1's ({dt:.2f} s)")
    # (c) the dump's keys, and its embeddings against the sweep
    with np.load(dump) as z:
        keys = sorted(z.files)
        dumped = {k: z[k] for k in z.files}
    _check(keys == sorted(["seq_embeds", "window_tc", "window_video", "window_start", "video_names",
                           "video_classes"]), f"bank layer (c): dump keys {keys}")
    gen_bank = load_feature_bank(os.path.join(cache, "generated_bank.npz"))
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF))
    model.load_state_dict(torch.load(ctx["best"], map_location="cpu", weights_only=True)["model_state_dict"])
    windows = list(zip(dumped["window_video"].tolist(), dumped["window_start"].tolist()))
    seqs, tcs, _vid = WindowEncoder(model, BATCH, CLIP, "high", "cuda").encode_bank(gen_bank, windows)
    _check(np.array_equal(seqs, dumped["seq_embeds"]) and np.array_equal(tcs, dumped["window_tc"]),
           "bank layer (c): the dump's embeddings are not the sweep's")
    print(f"bank layer (c): --dump-features {keys}, {len(windows)} windows of {len(gen_bank.names)} videos; "
          f"seq_embeds and window_tc bitwise a sweep of the cached generated bank")
    # (i) the checkpoint as the JAX package's path-keyed .npz
    npz = save_jax_npz_params(os.path.join(root, "best_params"), model.state_dict(), model.config)
    got, _, _ = cli("npz", "--bank-cache", cache, ckpt=npz)
    _check(got == want, "bank layer (i): the .npz checkpoint's scores differ from the .pt's")
    print("bank layer (i): the best checkpoint as a path-keyed .npz scores bitwise the .pt")

    # (d) --precision default: K3 on the tensor-core body
    kern = _k3_rows(torch, torch.device("cuda"), torch.Generator().manual_seed(SEED), ("default",))
    highest, _, _ = cli("highest", "--bank-cache", cache, "--precision", "highest")
    gather_windows.launches = fused_temporal_block.launches = 0
    default, _, dt = cli("default", "--bank-cache", cache, "--precision", "default")
    k3_default = fused_temporal_block.launches
    batches = _expected_batches(ctx["mesh_root"], ctx["gen_dir"])
    _check((gather_windows.launches, k3_default) == (batches, 40 * batches),
           f"bank layer (d): launches K1 {gather_windows.launches}, K3 {k3_default} != ({batches}, {40 * batches})")
    d_def = _worst_score_diff(default, highest)
    _check(d_def <= BF16_SWEEP_TOL, f"bank layer (d): default vs highest AC/TC {d_def:.3e} > {BF16_SWEEP_TOL}")
    bank, sweep, seg, smodel = sweep_inputs(torch)
    rates = {}
    for precision in ("high", "default"):
        enc = WindowEncoder(smodel, BATCH, CLIP, precision, "cuda")
        dev_bank = enc.upload(bank)
        enc.encode_bank_segsum(bank, sweep, seg, bank.num_videos, bank_dev=dev_bank)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            enc.encode_bank_segsum(bank, sweep, seg, bank.num_videos, bank_dev=dev_bank)
        rates[precision] = 5 * len(sweep) / (time.perf_counter() - t0)
    print(f"bank layer (d): score CLI --precision default: K1 {batches}, K3 {k3_default} launches ({dt:.2f} s); "
          f"max |dAC|,|dTC| vs highest {d_def:.3e} (tol {BF16_SWEEP_TOL}, bf16 class); sweep at batch {BATCH}: "
          f"default {rates['default']:.0f} windows/s, high {rates['high']:.0f} windows/s on {card}")

    # (h) a trace of one sweep names K1 and K3
    trace_dir = os.path.join(root, "trace")
    enc = WindowEncoder(smodel, BATCH, CLIP, "high", "cuda")
    with profiling.trace(trace_dir):
        with profiling.annotate("vge_sweep"):
            enc.encode_bank_segsum(bank, sweep, seg, bank.num_videos)
        torch.cuda.synchronize()
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        text = f.read()
    named = {k: k in text for k in ("gather_windows_kernel", "temporal_block_high_kernel", "vge_sweep")}
    _check(all(named.values()), f"bank layer (h): the trace names {named}")
    print(f"bank layer (h): profiling.trace around one sweep: {trace_file} ({len(text) / 2**20:.1f} MiB) names "
          f"{sorted(named)}")

    # (g) the native reader against numpy, and the host bank build with each
    _check(native_npz.reader() == "native", "bank layer (g): the native npz reader did not build")
    real = scan_class_tree(ctx["mesh_root"], filter_classes=list(ACTION_CLASSES))
    files = [it.path for it in real.items] + [it.path for it in scan_generated_flat(ctx["gen_dir"]).items]
    for path in files:
        got = native_npz.load_npz(path)
        with np.load(path) as z:
            same = all(np.array_equal(got[k], z[k]) and got[k].dtype == z[k].dtype for k in z.files
                       if z[k].dtype.kind not in "OSU")
        _check(same and set(got) == {k for k in z.files if k != "meta"}, f"bank layer (g): {path} reads differ")
    paths = ModalityPaths(keypoint_dir=ctx["kp_root"], layout="real")
    st = ModalityStats.load(os.path.join(cache, "stats.npz"))
    secs = {}
    for route in ("native", "numpy", "native"):
        saved = native_npz._LIB
        if route == "numpy":
            native_npz._LIB = None
        try:
            t0 = time.perf_counter()
            built = build_feature_bank(real.items, paths, st, min_rows=CLIP + 8)
            secs.setdefault(route, []).append(time.perf_counter() - t0)
        finally:
            native_npz._LIB = saved
    print(f"bank layer (g): native_npz.reader() = native; {len(files)} npz files bitwise numpy's; host bank build "
          f"over {len(real.items)} videos ({built.bank.shape[0]} rows): native {min(secs['native']):.3f} s, numpy "
          f"{secs['numpy'][0]:.3f} s (warm file cache, the host's cores shared with the card's process)")

    # (f) the train CLI with --bank-cache, and --conv-impl kernel / module
    cfg = copy.deepcopy(ctx["base"])
    cfg.epochs = 1
    losses = {}
    for tag, flags in (("kernel_cold", ["--conv-impl", "kernel"]), ("kernel_warm", ["--conv-impl", "kernel"]),
                       ("module", ["--conv-impl", "module"])):
        cfg.save_dir = os.path.join(root, f"SAVE_{tag}")
        path = os.path.join(root, f"train_{tag}.json")
        cfg.to_json(path)
        hits = feats.CACHE_COUNTS["hit"]
        t0 = time.perf_counter()
        train_main(["--config", path, "--device", "cuda", "--bank-cache", os.path.join(root, "train_cache"), *flags])
        torch.cuda.synchronize()
        losses[tag] = _train_losses(cfg.save_dir)
        print(f"bank layer (f): train CLI --bank-cache {' '.join(flags)}: 1 epoch in {time.perf_counter() - t0:.1f} s, "
              f"{feats.CACHE_COUNTS['hit'] - hits} cache hits; train, eval loss {losses[tag]}")
        _check(all(math.isfinite(v) for v in losses[tag]), f"bank layer (f): {tag} losses {losses[tag]}")
    _check(losses["kernel_warm"] == losses["kernel_cold"],
           "bank layer (f): the warm run's losses are not bitwise the cold run's")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["module"], losses["kernel_cold"]))
    _check(rel <= BF16_SWEEP_TOL, f"bank layer (f): module vs kernel losses differ by {rel:.3e} relative")
    print(f"bank layer (f): warm run bitwise the cold one; --conv-impl module vs kernel: max relative loss "
          f"difference {rel:.3e} (tol {BF16_SWEEP_TOL}, both at 'default')")

    # (e) frames to scores with the bank built on the card
    names, videos, model, centroids, label_dict = _config4_inputs(torch)
    ex = Extractor(_pose_config(), seed=SEED)
    cfg4 = ScoreConfig(clip_len=CLIP, stride=STRIDE, batch_size=BATCH)
    banks, build = [], full_mod.build_bank_device
    full_mod.build_bank_device = lambda *a, **k: banks.append(build(*a, **k)) or banks[-1]
    runs, times = {}, {}
    try:
        for impl in ("device", "host", "device"):   # the second device run is timed
            times[impl] = {}
            runs[impl] = full_mod.score_videos_end_to_end(ex, model, videos, centroids, label_dict, cfg=cfg4,
                                                          phase_times=times[impl], bank_impl=impl)
    finally:
        full_mod.build_bank_device = build
    _check(len(banks) == 2 and all(b.bank.is_cuda for b in banks), "bank layer (e): the device bank is not on cuda")
    _check(runs["device"].rejected == runs["host"].rejected, "bank layer (e): the runs reject different videos")
    d_bank = _worst_score_diff(runs["device"].scores, runs["host"].scores)
    _check(d_bank <= 1e-3, f"bank layer (e): device vs host bank AC/TC {d_bank:.3e} > 1e-3")
    print(f"bank layer (e): score_videos_end_to_end bank_impl device (bank {tuple(banks[0].bank.shape)} on "
          f"{banks[0].bank.device}, float32 stream stats) vs host: max |dAC|,|dTC| {d_bank:.3e} (budget 1e-3); "
          f"bank_s device {times['device']['bank_s']:.3f} s (its second run), host {times['host']['bank_s']:.3f} s; "
          f"extract_s {times['device']['extract_s']:.2f} / {times['host']['extract_s']:.2f} s on {card}")
    del ex
    torch.cuda.empty_cache()
    print(f"bank layer: phase 12 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return kern, k3_default


# ---------------------------------------------------------------------------
# phase 13: the legacy preprocessing and tensor-parallel training

# the train CLI's --tp 2 against phase 5's --tp 1 run, epoch by epoch: the
# train and eval losses, relative (the same rows through the same K4 and K3
# launches; only the transformer's sums run in another order)
TP_LOSS_RTOL = 1e-3


def _legacy_config(mesh_detector="yolox", keep_all_frames=True):
    """Phase 10's full-width extractor (YOLOX-L, ViT-H depth 32, the SMPL
    head, DWPose-L, the exact R-CNN in rcnn mode) in fp32 with the legacy
    preprocessing."""
    import dataclasses

    return dataclasses.replace(_pose_config(mesh_detector=mesh_detector, keep_all_frames=keep_all_frames),
                               preproc="legacy")


def phase_last_paths(torch, card, train_ctx, kp_ctx, root):
    """Phase 13: preproc="legacy" (its crops on the card against the CPU,
    process_video_full in the yolox and rcnn modes, the extract CLI on phase
    10's tree) and the train CLI's --tp 2 on phase 5's tree (2 gloo ranks
    sharing the card) against phase 5's run, its checkpoint scored and saved
    as the JAX package's .npz, and a resumed --tp 2 run. Returns the phase's
    launch counts."""
    import copy

    import numpy as np

    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.ops.attention_core import mha_core
    from video_gen_evals_tpu_torch.ops.conv_kernel_train import LAUNCHES_PER_BACKWARD
    from video_gen_evals_tpu_torch.ops.image import batched_person_crops
    from video_gen_evals_tpu_torch.ops.roi_align import roi_align_pyramid_dma
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor
    from video_gen_evals_tpu_torch.pipelines.extract import main as extract_main
    from video_gen_evals_tpu_torch.pipelines.score import main as score_main
    from video_gen_evals_tpu_torch.pipelines.train_cli import main as train_main
    from video_gen_evals_tpu_torch.train.checkpoint import load_jax_npz_params, save_jax_npz_params

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    launches = {}
    frames, boxes, _large = mesh_video()
    n = len(frames)
    chunks = -(-n // 32)

    # (a) the legacy crops (batched_person_crops, crop_scale 1.2) on the card against the CPU
    fr_cpu, bx_cpu = torch.from_numpy(frames).float(), torch.from_numpy(boxes)
    fr_dev, bx_dev = fr_cpu.cuda(), bx_cpu.cuda()
    crop_lines = []
    for out_hw in ((256, 192), (384, 288)):
        for impl in ("matmul", "gather"):
            want = batched_person_crops(fr_cpu, bx_cpu, out_hw, scale=1.2, impl=impl)
            got = batched_person_crops(fr_dev, bx_dev, out_hw, scale=1.2, impl=impl)
            d = float((got.cpu() - want).abs().max())
            _check(bool(torch.isfinite(got).all()) and d <= 1e-3,
                   f"legacy (a): {impl} crops {out_hw} on the card differ from the CPU by {d:.3e} (tol 1e-3)")
            ms = _time_ms(lambda: batched_person_crops(fr_dev[:32], bx_dev[:32], out_hw, scale=1.2, impl=impl), 5)
            crop_lines.append(f"{out_hw[0]}x{out_hw[1]} {impl} max |d| {d:.2e}, {ms:.3f} ms a 32-frame chunk")
    print("legacy (a): batched_person_crops on the card against the CPU, 0-255 units (tol 1e-3): "
          + "; ".join(crop_lines) + f" on {card}")

    # (b) process_video_full(with_keypoints=True) in the legacy mode, yolox and rcnn, fp32
    fps = {}
    for mode in ("yolox", "rcnn"):
        ex = Extractor(_legacy_config(mode), seed=SEED)
        if ex.rcnn is not None:
            _person_class_(torch, ex.rcnn)
        mha_core.launches = 0
        _reset_k5_counts()
        mesh, kp = ex.process_video_full(frames, with_keypoints=True)
        torch.cuda.synchronize()
        got = (mha_core.launches, roi_align_pyramid_dma.launches)
        want = (32 * chunks, -(-n // RCNN_BATCH) if mode == "rcnn" else 0)
        worst = _check_contract(torch, np, mesh, n, f"legacy {mode}")
        _check(got == want, f"legacy (b) {mode}: (K6, K5) launches {got} != {want}")
        _check(kp["kp120"].shape == (n, 120) and kp["kp120"].dtype == np.float32
               and bool(np.isfinite(kp["kp120"]).all()) and kp["valid"].shape == (n,) and bool(kp["valid"].all()),
               f"legacy (b) {mode}: keypoints {kp['kp120'].shape}, valid {int(kp['valid'].sum())} of {n}")
        launches[f"K6 legacy {mode}"], launches[f"K5 legacy {mode}"] = got
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.process_video_full(frames, with_keypoints=True)
        fps[mode] = n / (time.perf_counter() - t0)
        print(f"legacy (b): process_video_full({n} frames, with_keypoints) {mode} mode, fp32, keep_all_frames: "
              f"K6 {got[0]}, K5 {got[1]}; contract shapes, rotations within {worst:.1e}, kp120 finite; "
              f"{fps[mode]:.1f} frames/s on {card}")
        if mode == "yolox":
            ex.cfg.keep_all_frames = False
            single = ex.detect_stage(torch.from_numpy(frames).cuda())["single"].cpu().numpy()
            ruled, ruled_kp = ex.process_video_full(frames, with_keypoints=True)
            if single.sum() > 0 and single.mean() >= ex.cfg.min_single_ratio:
                _check(ruled is not None and np.array_equal(ruled["frame_idx"], np.flatnonzero(single)),
                       "legacy (b): keep_all_frames=False kept other frames than the mask")
            else:
                _check(ruled is None and ruled_kp is None, "legacy (b): a video below min_single_ratio was kept")
            print(f"legacy (b): keep_all_frames=False: single-person mask {int(single.sum())} of {n} frames -> "
                  f"{'(None, None)' if ruled is None else str(len(ruled['frame_idx'])) + ' mesh frames'}")
        del ex
        torch.cuda.empty_cache()

    # (c) the extract CLI with --preproc legacy over phase 10's tree
    out = {k: os.path.join(root, f"legacy_cli_{k}") for k in ("meshes", "kps", "logs")}
    t0 = time.perf_counter()
    counts = extract_main(["--videos", kp_ctx["tree"], "--out-meshes", out["meshes"], "--out-kps", out["kps"],
                           "--log-dir", out["logs"], "--preproc", "legacy"])
    with open(os.path.join(out["logs"], "RUN_CONFIG.json")) as f:
        run_config = json.load(f)
    keys = ("single", "not_single", "errors", "skipped")
    _check(run_config["preproc"] == "legacy" and run_config["parity"] is False,
           f"legacy (c): RUN_CONFIG.json {run_config['preproc']}, parity {run_config['parity']}")
    _check(sum(counts[k] for k in keys) == sum(kp_ctx["cli_counts"][k] for k in keys)
           and counts["errors"] == kp_ctx["cli_counts"]["errors"],
           f"legacy (c): counts {counts} against phase 10's {kp_ctx['cli_counts']}")
    print(f"legacy (c): extract CLI --preproc legacy over phase 10's tree in {time.perf_counter() - t0:.1f} s: "
          f"{ {k: counts[k] for k in keys} }; RUN_CONFIG.json preproc legacy, parity false")

    # (d) the train CLI with --tp 2 on phase 5's tree: 2 ranks sharing the card (gloo), 2 epochs
    ctx = train_ctx
    cfg = copy.deepcopy(ctx["base"])
    cfg.save_dir = os.path.join(root, "SAVE_tp2")
    cfg_path = os.path.join(root, "train_tp2.json")
    cfg.to_json(cfg_path)
    t0 = time.perf_counter()
    ranks = train_main(["--config", cfg_path, "--device", "cuda", "--tp", "2"])
    wall = time.perf_counter() - t0
    _check([r["grid"] for r in ranks] == [(1, 2), (1, 2)] and ranks[0]["save_dir"] == ranks[1]["save_dir"],
           f"tp (d): ranks {ranks}")
    run_tp = ranks[0]["save_dir"]
    one, two = _events(ctx["run_two"]), _events(run_tp)
    rel = {}
    for kind, key in (("train_epoch", "loss"), ("eval_loss", "loss"), ("centroid_distance", "avg")):
        a = [e[key] for e in one if e["event"] == kind]
        b = [e[key] for e in two if e["event"] == kind]
        _check(len(a) == len(b) == 2 and all(map(math.isfinite, b)), f"tp (d): {kind} events {a} vs {b}")
        rel[kind] = [abs(y - x) / abs(x) for x, y in zip(a, b)]
    worst = max(max(rel["train_epoch"]), max(rel["eval_loss"]))
    _check(worst <= TP_LOSS_RTOL, f"tp (d): --tp 2 losses off by {rel} relative (tol {TP_LOSS_RTOL:g})")
    steps = ctx["steps"]
    loss_chunks = -(-ctx["n_test"] // BATCH)
    sweeps = [-(-ctx[k] // BATCH) for k in ("n_train", "n_test", "n_gen")]
    for r in ranks:
        own = sum(_rank_share(nb, r["rank"], 2) for nb in sweeps)
        k = r["launches"]
        got = (k["fused_temporal_block_train"], k["fused_temporal_block_train_bwd"], k["gather_windows"],
               k["fused_temporal_block"])
        want = (40 * steps * 2, 40 * steps * 2 * LAUNCHES_PER_BACKWARD, 2 * (steps + loss_chunks + own),
                2 * 40 * (loss_chunks + own))
        print(f"tp (d): train CLI --tp 2 rank {r['rank']}: launches K4 forward={got[0]} backward={got[1]} "
              f"K1={got[2]} K3={got[3]}")
        _check(got == want and min(got) > 0, f"tp (d): rank {r['rank']} launches {got} != {want}")
        launches[f"K4 tp2 rank {r['rank']}"], launches[f"K1 tp2 rank {r['rank']}"] = got[0], got[2]
    second = [e for e in two if e["event"] == "train_epoch"][1]
    print(f"tp (d): train CLI --tp 2 --device cuda, 2 ranks sharing the card through gloo, 2 epochs of {steps} "
          f"steps in {wall:.1f} s (rank start, host stats + banks included): relative to phase 5's --tp 1 run, "
          f"epoch by epoch, " + ", ".join(f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in rel.items())
          + f" (losses held to {TP_LOSS_RTOL:g}); second epoch {second['clips_per_sec']:.1f} clips/s against "
          f"--tp 1's {ctx['clips_per_sec']:.1f} on {card} (two ranks share one card: this measures the code "
          f"path, not scaling)")

    # the gathered best checkpoint: the score CLI, and the JAX package's .npz
    best = ranks[0]["best_ckpt"]
    scores_path = os.path.join(root, "scores_tp2.json")
    score_main(["--generated-meshes", ctx["gen_dir"], "--real-meshes", ctx["mesh_root"], "--checkpoint", best,
                "--real-kp-dir", ctx["kp_root"], "--gen-kp-dir", ctx["gen_kp"], "--output", scores_path,
                "--no-bug-compat", "--device", "cuda"])
    with open(scores_path) as f:
        scored = json.load(f)
    with open(ctx["scores"]) as f:
        scored_one = json.load(f)
    _check(sorted(scored) == sorted(scored_one) and all(
        math.isfinite(v.get("ac", math.nan)) and math.isfinite(v.get("tc", math.nan)) for v in scored.values()),
        "tp (d): the --tp 2 checkpoint did not score every generated video finite")
    d_scores = max(abs(scored[v][m] - scored_one[v][m]) for v in scored for m in scored[v])
    state = torch.load(best, map_location="cpu", weights_only=True)["model_state_dict"]
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF))
    model.load_state_dict(state, strict=True)
    npz = save_jax_npz_params(os.path.join(root, "best_tp2"), state, model.config)
    back = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF))
    load_jax_npz_params(npz, back)
    _check(all(torch.equal(v, back.state_dict()[k]) for k, v in state.items()),
           "tp (d): the gathered checkpoint's .npz does not read back bitwise")
    print(f"tp (d): {os.path.basename(best)} (the gathered tree) scored {len(scored)} generated videos, all "
          f"finite, max |d AC/TC| {d_scores:.2e} from phase 5's --tp 1 checkpoint (reported); loaded strictly by "
          f"the one-device model and written as the JAX package's .npz, read back bitwise")

    # epoch 0's checkpoint + --resume at --tp 2 against the uninterrupted --tp 2 run
    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg.save_dir = os.path.join(root, "SAVE_tp2_resumed")
    resumed_cfg.to_json(cfg_path)
    t0 = time.perf_counter()
    train_main(["--config", cfg_path, "--device", "cuda", "--tp", "2",
                "--resume", os.path.join(run_tp, "resume_epoch000.pt")])
    final = torch.load(os.path.join(run_tp, "resume_epoch001.pt"), map_location="cpu", weights_only=True)
    resumed = torch.load(os.path.join(_only_run(resumed_cfg.save_dir), "resume_epoch001.pt"), map_location="cpu",
                         weights_only=True)
    d_model = max(float((v - resumed["model"][k]).abs().max()) for k, v in final["model"].items())
    opt_a, opt_b = final["train_step"]["optimizer"]["state"], resumed["train_step"]["optimizer"]["state"]
    d_moments = max(float((opt_a[i][k] - opt_b[i][k]).abs().max()) for i in opt_a for k in opt_a[i])
    _check(final["train_step"]["step"] == resumed["train_step"]["step"] == 2 * steps,
           f"tp (d): resumed step {resumed['train_step']['step']}")
    _check(d_model == 0.0 and d_moments == 0.0 and final["best_eval_loss"] == resumed["best_eval_loss"],
           f"tp (d): the resumed --tp 2 run differs from the uninterrupted one: weights {d_model:.3e}, moments "
           f"{d_moments:.3e}")
    print(f"tp (d): --tp 2 resumed from epoch 0's gathered checkpoint ({time.perf_counter() - t0:.1f} s) ends "
          f"bitwise equal to the uninterrupted --tp 2 run (weights, Adam moments, step, best eval loss)")
    print(f"last paths: phase 13 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library

    t_start = time.perf_counter()
    card = _card()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = load_library()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel build {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path)}")
    for line in dict.fromkeys(_ptxas_summary(lib.build_log)):
        # the flagship instantiations, and every multi-window conv and K5 instantiation
        if "<" not in line or "T=32, C=256" in line or "hd=80" in line or line.startswith(_TC_KERNELS):
            print(f"  ptxas: {line}")

    gen = torch.Generator().manual_seed(SEED)
    kern = phase_kernels(torch, dev, gen)
    kern.update(phase_attention_kernels(torch, dev, gen))
    kern.update(phase_fused_kernels(torch, dev, gen))
    launches = phase_end_to_end(torch)
    phase_throughput(torch, card)
    fused_launches = phase_fused_sweep(torch, card)
    keep = tempfile.TemporaryDirectory()   # phases 5 and 10's trees, which phase 11 reuses
    train_launches, train_ctx = phase_training(torch, card, os.path.join(keep.name, "train"))
    mesh_launches = phase_mesh_stage(torch, card)
    det_kern, det_launches, exact_det = phase_detector(torch, card)
    kern.update(det_kern)
    mode_kern, mode_launches = phase_detector_modes(torch, card, exact_det)
    kern.update(mode_kern)
    kp_launches, kp_ctx = phase_keypoints(torch, card, os.path.join(keep.name, "keypoints"))
    phase_parallel(torch, card, train_ctx, kp_ctx, os.path.join(keep.name, "parallel"))
    bank_kern, k3_default = phase_bank_layer(torch, card, train_ctx, os.path.join(keep.name, "bank"))
    kern.update(bank_kern)
    last_launches = phase_last_paths(torch, card, train_ctx, kp_ctx, os.path.join(keep.name, "last"))
    keep.cleanup()

    src = "video_gen_evals_tpu_torch/csrc/"
    rows = [
        ("gather_windows", "window_gather.cu",
         "video_gen_evals_tpu/ops/window_kernel.py:174", launches["high"][0]),
        ("fused_temporal_block[high]", "temporal_block.cu",
         "video_gen_evals_tpu/ops/conv_kernel.py:347", launches["high"][1]),
        ("fused_temporal_block[highest]", "temporal_block.cu",
         "video_gen_evals_tpu/ops/conv_kernel.py:358", launches["highest"][1]),
        # JAX scores "default" through its module's XLA conv; the port's K3
        # runs it on K4's forward body, whose source is temporal_block_train.cu
        ("fused_temporal_block[default]", "temporal_block_train.cu",
         "video_gen_evals_tpu/ops/conv_kernel.py:347", k3_default),
    ]
    rows += [
        ("gather_windows_subblock", "window_gather.cu",
         "video_gen_evals_tpu/ops/window_kernel.py:95", fused_launches["gather_windows_subblock"]),
        ("fused_temporal_block_stacked[high]", "temporal_block.cu",
         "video_gen_evals_tpu/ops/conv_kernel.py:272", fused_launches["fused_temporal_block_stacked[high]"]),
    ] + [
        (name, "temporal_chain.cu", "video_gen_evals_tpu/ops/chain_kernel.py:228", fused_launches[name])
        for name in ("fused_temporal_chain[4 stages]", "fused_temporal_chain[2 stages]")
    ]
    for precision in ("default", "highest"):
        rows += [
            (f"fused_temporal_block_train[{precision}]", "temporal_block_train.cu",
             "video_gen_evals_tpu/ops/conv_kernel_train.py:294", train_launches[precision][0]),
            (f"fused_temporal_block_train_bwd[{precision}]", "temporal_block_train.cu",
             "video_gen_evals_tpu/ops/conv_kernel_train.py:335", train_launches[precision][1]),
        ]
    for precision in ("highest", "default"):
        rows += [
            (f"{name}[{precision}]", "attention.cu", replaces, mesh_launches[f"{name}[{precision}]"])
            for name, replaces in (
                ("mha_core", "video_gen_evals_tpu/ops/attention_core.py:102"),
                ("mha_head_batched", "video_gen_evals_tpu/ops/attention_core.py:172"),
                ("flash_attention", "video_gen_evals_tpu/ops/attention.py:123"))
        ]
    rows.append(("mha_core[high]", "attention.cu", "video_gen_evals_tpu/ops/attention_core.py:102",
                 fused_launches["mha_core[high]"]))
    rows.append(("roi_align_pyramid_dma", "roi_align.cu", "video_gen_evals_tpu/ops/roi_align.py:335",
                 det_launches["roi_align_pyramid_dma"]))
    rows.append(("roi_align_pyramid_dma[bfloat16]", "roi_align.cu", "video_gen_evals_tpu/ops/roi_align.py:335",
                 mode_launches["roi_align_pyramid_dma[bfloat16]"]))
    for name, _f, _rep, n in rows:
        _check(n > 0, f"{name} was never launched on its main path")
    print("keypoint path launches: " + ", ".join(f"{k} {v}" for k, v in kp_launches.items()))
    for name in ("K6 legacy yolox", "K6 legacy rcnn", "K5 legacy rcnn", "K4 tp2 rank 0", "K4 tp2 rank 1",
                 "K1 tp2 rank 0", "K1 tp2 rank 1"):
        _check(last_launches[name] > 0, f"{name}: never launched on its path")
    print("legacy and tensor-parallel path launches: " + ", ".join(f"{k} {v}" for k, v in last_launches.items()))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + f, "replaces": rep, "launches": n,
         **{k: kern[name][k] for k in keys}}
        for name, f, rep, n in rows
    ]}))
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s (kernel build included) on {card}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
