#!/usr/bin/env python3
"""Time K5 (``roi_align_pyramid_dma``, ROIAlignV2 over the packed FPN
pyramid) of the PyTorch + CUDA port on one NVIDIA GPU, alone, on the fp32
pyramid (window 48, the exact R-CNN) and the bf16 one (window 32,
``RCNNConfig.fast()``). It builds only ``csrc/roi_align.cu``
(``cuda_lib.load_library`` with a subset of the sources).

    python3 scripts/profile_torch_roi_align.py [--root DIR] [--iters 20] [--build-only]

``--root`` imports ``video_gen_evals_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive`` under the ignored
``_checkout/``), so that two versions are timed in one call on one card:
run parent, change, change, parent (``--build-only`` first, for both roots
at once, so that the timed runs build nothing). The kernel is held against
its plain version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phases 8-9; this script only times it.

The inputs are those of ``chip_smoke.py``'s detect chunk: the seeded
X101-32x8d-FPN R-CNN of ``Extractor(ExtractorConfig(mesh_detector="rcnn"),
seed=0)`` (the person logit raised as the smoke raises it) on the first 8
frames of the smoke's synthetic video, its 8 x 1000 proposals, and the
levels p2..p5 packed into [8, 360, 336, 256], in float32 and cast to
bfloat16 (fast() changes only the pool). The run that builds prints K5's
ptxas lines. A timed run prints, for each pyramid: ms a call from CUDA
events, the bound (the union of the cells the proposals weight, read once,
and the float32 output written once, at 3.35 TB/s) and the kernel's share of
it, and the bytes that the kernel's loads cover (the sum over ROIs of the
weighted rows x weighted columns of its window). Every line carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chunk_inputs(torch):
    """(fp32 buffer, bf16 buffer, row offsets, level sizes, strides,
    proposals [8, 1000, 4], levels [8, 1000]) of the smoke's detect chunk."""
    from chip_smoke import RCNN_BATCH, SEED, _person_class_, mesh_video
    from video_gen_evals_tpu_torch.models.rcnn import FasterRCNN, RCNNConfig, init_rcnn_weights_, predictor_canvas
    from video_gen_evals_tpu_torch.ops.roi_align import assign_fpn_levels, pack_pyramid
    from video_gen_evals_tpu_torch.pipelines.extract import _build_detector

    rc = RCNNConfig.x101_32x8d()
    rcnn = _build_detector(FasterRCNN, rc, None, init_rcnn_weights_,
                           torch.Generator(device="cuda").manual_seed(SEED + 2), torch.device("cuda"),
                           torch.float32)
    _person_class_(torch, rcnn)
    frames, _boxes, _large = mesh_video()
    with torch.inference_mode():
        canvas, hw = predictor_canvas(torch.from_numpy(frames[:RCNN_BATCH]).cuda(), rc)
        feats = rcnn.backbone_features(canvas)
        props, _valid = rcnn.proposals(feats, hw)
        buf, offs, lhw = pack_pyramid(feats[:4])
        buf16, _, _ = pack_pyramid([f.bfloat16() for f in feats[:4]])
    del rcnn, feats, canvas
    torch.cuda.empty_cache()
    return buf, buf16, offs, lhw, rc.strides[:4], props, assign_fpn_levels(props)


def timing(torch, ra, iters, card):
    from chip_smoke import PEAK_BYTES, PEAK_FP32, _bound, _k5_cells, _k5_loaded_cells, _k5_work, _time_ms

    buf, buf16, offs, lhw, strides, props, levels = chunk_inputs(torch)
    for b, window in ((buf, 48), (buf16, 32)):
        dtype = str(b.dtype).replace("torch.", "")
        with torch.inference_mode():
            ms = _time_ms(lambda: ra.roi_align_pyramid_dma(b, offs, lhw, strides, props, levels, window=window),
                          iters)
            geom = ra.dma_geometry(tuple(b.shape[1:3]), offs, lhw, strides, props.reshape(-1, 4),
                                   levels.reshape(-1), window=window)
            cells = _k5_cells(torch, geom, *props.shape[:2], tuple(b.shape[1:3]))
            loaded = _k5_loaded_cells(torch, geom)
            fmas = _k5_work(torch, geom, b.shape[-1])
        cell_bytes = b.element_size() * b.shape[-1]
        out_bytes = 4 * props.shape[0] * props.shape[1] * 49 * b.shape[-1]
        nbytes = cell_bytes * cells + 4 * (props.numel() + levels.numel()) + out_bytes
        bound, by = _bound(nbytes, 2 * fmas, PEAK_FP32)
        print(f"K5 [{dtype}] window {geom[4]} x {geom[5]}, {props.shape[0]} x {props.shape[1]} proposals on "
              f"{tuple(b.shape)}: {ms:.4f} ms; bound {bound:.4f} ms ({by}: {cells} weighted cells, "
              f"{nbytes / 1e6:.1f} MB, {bound / ms:.1%} of it); loads cover {loaded} cells, "
              f"{loaded * cell_bytes / 1e9:.3f} GB ({loaded / cells:.2f} x the union; at {PEAK_BYTES / 1e12:.2f} "
              f"TB/s {loaded * cell_bytes / PEAK_BYTES * 1e3:.4f} ms) on {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_REPO, help="checkout whose video_gen_evals_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--build-only", action="store_true", help="build roi_align.cu and stop")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_roi_align: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, _REPO)
    from chip_smoke import _card, _ptxas_summary   # this checkout's measurement helpers
    sys.path.insert(0, os.path.abspath(args.root))   # the root's package
    from video_gen_evals_tpu_torch.ops import roi_align as ra
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library

    card = _card()
    lib = load_library(sources=("roi_align.cu",))
    print(f"root {os.path.abspath(args.root)}: build {lib.build_seconds:.1f} s on {card}, "
          f"torch {torch.__version__}")
    for line in _ptxas_summary(lib.build_log):   # empty when an earlier run built the library
        if line.startswith("roi_align"):
            print(f"  ptxas {line}")
    if args.build_only:
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py sets them
    torch.backends.cudnn.allow_tf32 = False
    timing(torch, ra, args.iters, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
