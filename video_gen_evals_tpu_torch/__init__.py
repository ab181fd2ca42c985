"""video_gen_evals_tpu_torch — the TAG scoring and training paths in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``video_gen_evals_tpu`` (JAX/Pallas), which stays in the
repository as the numerical reference. The layout and names mirror the JAX
package: ``video_gen_evals_tpu_torch/ops/conv_kernel.py`` is the counterpart
of ``video_gen_evals_tpu/ops/conv_kernel.py``.

Subpackages
-----------
ops       : geometry deltas (SO(3), Procrustes, embedding deltas), temporal
            corruptions, and the Hopper kernels — the window gather
            (``window_kernel``), the fused residual conv stage of scoring
            (``conv_kernel``) and its trainable form with a backward
            (``conv_kernel_train``), each beside its plain PyTorch version.
data      : manifests, window enumeration, modality statistics, the
            host-built, sentinel-padded feature bank, the PK batch sampler.
models    : ``HumanActionScorer`` as ``nn.Module``s with the reference's
            state_dict names, and weight conversion to and from the JAX tree.
metrics   : per-window TC, AC/TC finalize, rank correlations.
train     : losses, the training step, checkpoints, the experiment harness.
parallel  : data-parallel ranks on ``torch.distributed`` and the multi-host
            split of a work list.
human     : the human-MOS pipeline.
pipelines : the scoring CLI (``python -m video_gen_evals_tpu_torch.pipelines.score``),
            the training CLI (``... .pipelines.train_cli``), extraction,
            ``merge_scores`` and the leaderboard.
csrc      : CUDA C++ sources, built with ``nvcc`` at first use.

The package imports ``torch`` and never ``jax`` or the JAX package.
"""

__version__ = "0.1.0"
