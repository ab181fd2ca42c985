"""The training step: clean + 3 corrupted forwards as one stacked batch.

Port of ``video_gen_evals_tpu/train/step.py`` (ref ``train.py:488-524``):
``TCL(clean) + w * (hard_shuf + hard_rev + hard_stat)``, each hard term a
SupCon 2-way CE between the clean embedding and the embedding of a
temporally corrupted copy of the batch. The clean batch and its three
corruptions go through the encoder as one ``[4B, T, D]`` forward.

:class:`TrainStep` is ``stack(feats) -> stacked`` and ``update(stacked,
labels) -> metrics``; a step is their composition.

- AdamW + per-step cosine annealing to ``eta_min`` (:func:`make_optimizer`:
  betas 0.9/0.999, eps 1e-8, decoupled weight decay 0.01 on all parameters;
  ref ``train.py:163,183-186``). The schedule stops at ``total_steps``, where
  optax's clamps: ``CosineAnnealingLR`` alone would climb again.
- A non-finite total skips the update (ref ``train.py:499-500``): the
  parameters, the optimizer state and the schedule stay as they were, the
  step counter still goes up by one, and ``skipped`` is 1.0 in the metrics.
- Randomness is a function of ``(seed, step)``: the shuffle's indices come
  from a CPU generator, the dropout masks from a generator on the model's
  device, both seeded anew every step. Nothing random needs saving for an
  exact resume.
- Data parallelism (``rank``, a ``parallel.Rank``): every rank builds the
  same stacked ``[4B, T, D]`` batch and forwards its own contiguous block of
  ``4B / world`` rows, with the dropout masks of the one-rank forward cut to
  its rows (``models.fusion_encoder.Dropout``). ``all_gather_rows``
  rebuilds the ``[4B]`` embeddings in order and every rank computes the
  global loss: TCL and the SupCon terms couple the whole batch, so a
  per-rank loss averaged as DDP does would be another loss. The gradients
  are summed over the ranks in one ``all_reduce``; every rank then holds the
  same sum, skips the same non-finite steps and applies the same update, so
  the parameters stay bitwise equal on every rank. At world 1 the path gives
  the single-device run's bits.
- Tensor parallelism (``rank`` on a ``parallel.make_grid`` grid, the model
  sharded by ``HumanActionScorer.shard_``): the rows split, the embeddings'
  gather and the gradient sum above run over the rank's data axis
  (``Rank.data``); the model axis's collectives run inside the forward
  (``parallel/tensor.py``). Every rank still computes the same loss and
  skips the same non-finite steps, and AdamW updates each rank's own blocks.
  :meth:`TrainStep.state_dict` gathers the AdamW moments of the sharded
  parameters whole, and :meth:`TrainStep.load_state_dict` cuts them again, so
  a resume file is the same at every grid. The eval loss runs ``eval_model``
  (the gathered model) when one is given.

Precision: ``precision`` ("default" or "highest") selects the arithmetic of
the trainable conv-stage kernel only. Every other matmul of the step runs in
fp32 with TF32 off (set and checked). The JAX step on the TPU ran every
matmul as one bf16 pass; the port does not.
"""

from __future__ import annotations

import math
import typing as T

import torch

from ..models import HumanActionScorer
from ..ops.corruption import partial_shuffle_within_window, reverse_sequence, static_window
from ..parallel import Rank, all_gather_rows, all_reduce_sum
from ..utils.device import disable_tf32
from .losses import supcon_hard_negatives, tcl_loss

COMPONENTS = ("tcl", "hard_shuf", "hard_rev", "hard_stat")
_SHUFFLE, _DROPOUT = 0, 1   # the two random streams of a step


def make_optimizer(
    params: T.Iterable[torch.nn.Parameter],
    lr: float,
    total_steps: int,
    eta_min: float = 1e-6,
    weight_decay: float = 0.01,
) -> T.Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.CosineAnnealingLR]:
    """AdamW with per-step cosine annealing to ``eta_min`` over ``total_steps``."""
    optimizer = torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.CosineAnnealingLR(
        optimizer, T_max=max(1, total_steps), eta_min=eta_min)
    return optimizer, scheduler


def position_cosine_schedule(
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.CosineAnnealingLR,
    count: int,
) -> None:
    """Put the schedule where ``count`` applied updates leave it, from the
    closed form ``eta_min + (lr - eta_min) * (1 + cos(pi * t / T_max)) / 2``
    with ``t = min(count, T_max)``."""
    t = min(int(count), scheduler.T_max)
    scheduler.last_epoch = t
    for group, base_lr in zip(optimizer.param_groups, scheduler.base_lrs):
        group["lr"] = scheduler.eta_min + (base_lr - scheduler.eta_min) * (
            1.0 + math.cos(math.pi * t / scheduler.T_max)) / 2.0
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]


def seeded_generator(seed: int, counter: int, stream: int,
                     device: T.Union[str, torch.device] = "cpu") -> torch.Generator:
    """A generator for random stream ``stream`` of step (or chunk) ``counter``."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed * 1_000_003 + counter) * 2 + stream) % (2**63))
    return g


def stack_corruptions(feats: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``[B, T, D] -> [4B, T, D]``: clean, shuffled, reversed, static."""
    return torch.cat([
        feats,
        partial_shuffle_within_window(feats, generator),
        reverse_sequence(feats),
        static_window(feats),
    ], dim=0)


def loss_components(
    emb: torch.Tensor, labels: torch.Tensor, hard_weight: float
) -> T.Dict[str, torch.Tensor]:
    """The four loss terms from the stacked batch's embeddings ``[4B, D]``."""
    B = emb.shape[0] // 4
    clean, sh, rev, st = emb[:B], emb[B : 2 * B], emb[2 * B : 3 * B], emb[3 * B :]
    return {
        "tcl": tcl_loss(clean, labels),
        "hard_shuf": hard_weight * supcon_hard_negatives(clean, clean, sh),
        "hard_rev": hard_weight * supcon_hard_negatives(clean, clean, rev),
        "hard_stat": hard_weight * supcon_hard_negatives(clean, clean, st),
    }


def _to_floats(components: T.Dict[str, torch.Tensor], total: torch.Tensor) -> T.Dict[str, float]:
    """One fetch for all the numbers."""
    values = torch.stack([components[k].detach() for k in COMPONENTS] + [total.detach()]).tolist()
    return dict(zip(COMPONENTS + ("total",), values))


class TrainStep:
    """The model's optimizer, schedule and step counter, and the step itself."""

    def __init__(
        self,
        model: HumanActionScorer,
        lr: float,
        total_steps: int,
        eta_min: float = 1e-6,
        hard_weight: float = 10.0,
        precision: str = "default",
        eval_precision: str = "high",
        seed: int = 0,
        rank: T.Optional[Rank] = None,
        eval_model: T.Optional[HumanActionScorer] = None,
    ):
        disable_tf32()
        self.rank = rank
        self.data = None if rank is None else rank.data   # the rows and the gradient sum
        self.model = model
        self.eval_model = model if eval_model is None else eval_model
        self.total_steps = max(1, total_steps)
        self.optimizer, self.scheduler = make_optimizer(
            model.parameters(), lr, total_steps, eta_min)
        self.hard_weight = hard_weight
        self.precision = precision
        self.eval_precision = eval_precision
        self.seed = seed
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def stack(self, feats: torch.Tensor) -> torch.Tensor:
        """This step's stacked batch: the shuffle is drawn from ``(seed, step)``."""
        return stack_corruptions(feats, seeded_generator(self.seed, self.step, _SHUFFLE))

    def _my_rows(self, n: int, required: bool) -> T.Optional[T.Tuple[int, int]]:
        """This rank's block ``(lo, hi)`` of an ``n``-row stacked batch, or
        None for the whole batch: without a rank, or (``required`` False)
        where the rows do not divide over the ranks."""
        if self.data is None:
            return None
        if n % self.data.world:
            if required:
                raise ValueError(f"{n} stacked windows must divide evenly over "
                                 f"{self.data.world} data-parallel ranks")
            return None
        per = n // self.data.world
        return self.data.rank * per, (self.data.rank + 1) * per

    def embed(self, stacked: torch.Tensor, precision: str,
              generator: T.Optional[torch.Generator] = None, required: bool = True,
              model: T.Optional[HumanActionScorer] = None) -> torch.Tensor:
        """The embeddings ``[4B, D]`` of the stacked batch by ``model``
        (default: the trained one): on one device its forward; on a
        data-parallel rank the forward of its rows, gathered from every rank
        of its data axis in order."""
        model = self.model if model is None else model
        rows = self._my_rows(stacked.shape[0], required)
        if rows is None:
            return model(stacked, precision, generator=generator)[0]
        lo, hi = rows
        emb, _, _ = model(stacked[lo:hi], precision, generator=generator, rows=(lo, stacked.shape[0]))
        return all_gather_rows(emb, self.data)

    def update(self, stacked: torch.Tensor, labels: torch.Tensor) -> T.Dict[str, float]:
        """Forward in training mode, backward, and one optimizer and schedule
        step unless the total is not finite. Returns the loss components,
        ``total`` and ``skipped`` as floats."""
        self.model.train()
        dropout_gen = seeded_generator(self.seed, self.step, _DROPOUT, self.device)
        emb = self.embed(stacked, self.precision, dropout_gen)
        components = loss_components(emb, labels, self.hard_weight)
        total = sum(components.values())
        metrics = _to_floats(components, total)
        finite = bool(torch.isfinite(total))
        if finite:
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
            if self.data is not None:
                self._sum_gradients()
            self.optimizer.step()
            if self.scheduler.last_epoch < self.total_steps:
                self.scheduler.step()
        self.step += 1
        metrics["skipped"] = 0.0 if finite else 1.0
        return metrics

    def _sum_gradients(self) -> None:
        """Every parameter's gradient summed over the data axis, in one collective."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_sum([p.grad for p in params], self.data)

    def __call__(self, feats: torch.Tensor, labels: torch.Tensor) -> T.Dict[str, float]:
        return self.update(self.stack(feats), labels)

    def eval_loss(self, feats: torch.Tensor, labels: torch.Tensor,
                  chunk: int = 0) -> T.Dict[str, float]:
        """The same loss in eval mode, no dropout and no gradient (ref
        ``train.py:286-333``); the shuffle is drawn from ``(seed + 999, chunk)``.
        On a data-parallel rank the chunk's rows are split over the ranks
        where they divide evenly, as the training step's; a chunk that does
        not divide runs whole on every rank."""
        self.eval_model.eval()
        with torch.no_grad():
            stacked = stack_corruptions(
                feats, seeded_generator(self.seed + 999, chunk, _SHUFFLE))
            emb = self.embed(stacked, self.eval_precision, required=False, model=self.eval_model)
            components = loss_components(emb, labels, self.hard_weight)
            return _to_floats(components, sum(components.values()))

    def _moments(self, state: T.Mapping[str, T.Any], fn) -> T.Dict[str, T.Any]:
        """``state`` (an optimizer state_dict) with ``fn(name, tensor)`` on
        each parameter's AdamW moments."""
        names = [n for n, _ in self.model.named_parameters()]
        per_param = {i: {k: fn(names[i], v) if k in ("exp_avg", "exp_avg_sq") else v for k, v in s.items()}
                     for i, s in state["state"].items()}
        return {**state, "state": per_param}

    def state_dict(self) -> T.Dict[str, T.Any]:
        """The optimizer, schedule and step counter; under tensor parallelism
        the moments gathered whole (a collective over the model axis)."""
        optimizer = self.optimizer.state_dict()
        if self.model.tp is not None:
            optimizer = self._moments(optimizer, self.model.tp.gather)
        return {"optimizer": optimizer, "scheduler": self.scheduler.state_dict(), "step": self.step}

    def load_state_dict(self, state: T.Mapping[str, T.Any]) -> None:
        """An interrupted run's state restores exactly. A checkpoint of a run
        with another length keeps its weights, moments and counts, and this
        run's schedule takes over at the saved count (the schedule is a
        function of the count, as optax's is). Whole moments are cut to this
        rank's blocks under tensor parallelism."""
        optimizer = state["optimizer"]
        if self.model.tp is not None:
            optimizer = self._moments(optimizer, self.model.tp.shard)
        self.optimizer.load_state_dict(optimizer)
        saved = state["scheduler"]
        if saved["T_max"] == self.scheduler.T_max:
            self.scheduler.load_state_dict(saved)
        else:
            position_cosine_schedule(self.optimizer, self.scheduler, saved["last_epoch"])
        self.step = int(state["step"])
