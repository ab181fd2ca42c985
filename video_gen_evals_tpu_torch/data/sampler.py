"""PK balanced batch sampler for metric learning.

The port's own copy of ``video_gen_evals_tpu/data/sampler.py`` (pure numpy;
ref ``utils.py:922-1015``): each batch holds P classes x K windows; per-class
shuffled queues drained without replacement, topped up *with replacement*
from the full class pool when a queue runs dry; class order cycles through a
shuffled list with reshuffle-on-wrap; batches themselves are shuffled; epoch
length = total_windows // (P*K), and never fewer than one batch.

Driven by a numpy ``Generator``: given the same generator stream the batches
equal the JAX package's bitwise (``tests/test_torch_train_ops.py``).
"""

from __future__ import annotations

import typing as T
from collections import defaultdict

import numpy as np


class PKBatchSampler:
    def __init__(
        self,
        labels: T.Sequence[int],
        P: int,
        K: int,
        drop_last: bool = False,
        rng: T.Optional[np.random.Generator] = None,
    ):
        self.labels = np.asarray(labels)
        self.P = int(P)
        self.K = int(K)
        self.drop_last = drop_last
        self.rng = rng if rng is not None else np.random.default_rng()

        self.class_to_indices: T.Dict[int, T.List[int]] = defaultdict(list)
        for idx, y in enumerate(self.labels):
            self.class_to_indices[int(y)].append(idx)
        self.classes = list(self.class_to_indices.keys())
        if len(self.classes) < self.P:
            raise ValueError(
                f"P: {self.P} exceeds num classes: {len(self.classes)}"
            )

    def __len__(self) -> int:
        total = sum(len(v) for v in self.class_to_indices.values())
        return total // (self.P * self.K)

    def __iter__(self) -> T.Iterator[np.ndarray]:
        per_class_queues = {}
        for c, idxs in self.class_to_indices.items():
            q = np.array(idxs)
            self.rng.shuffle(q)
            per_class_queues[c] = q.tolist()
        class_order = self.classes.copy()
        self.rng.shuffle(class_order)
        cursor = 0

        # the reference's loop is do-while shaped (ref ``utils.py:970-1010``:
        # yield first, THEN check the emitted count) — so even when
        # total_windows < P*K (len() == 0) it emits one batch; a plain
        # `while emitted < len(self)` head-check would silently train ZERO
        # steps per epoch on such datasets
        num_batches = max(1, len(self))
        emitted = 0
        while emitted < num_batches:
            if cursor + self.P <= len(class_order):
                chosen = class_order[cursor : cursor + self.P]
                cursor += self.P
            else:
                remaining = len(class_order) - cursor
                chosen = class_order[cursor:] + class_order[: self.P - remaining]
                self.rng.shuffle(class_order)
                cursor = self.P - remaining

            batch: T.List[int] = []
            for c in chosen:
                q = per_class_queues[c]
                if len(q) >= self.K:
                    take = q[: self.K]
                    del q[: self.K]
                else:
                    take = q.copy()
                    need = self.K - len(take)
                    pool = self.class_to_indices[c]
                    take.extend(self.rng.choice(pool, size=need, replace=True).tolist())
                    q.clear()
                batch.extend(take)

            batch_arr = np.array(batch)
            self.rng.shuffle(batch_arr)
            if self.drop_last and len(batch_arr) != self.P * self.K:
                # unreachable today (top-up-with-replacement always fills
                # each class to exactly K); raise rather than `continue`,
                # which would re-draw forever without advancing `emitted`
                raise RuntimeError(
                    f"PKBatchSampler produced a short batch "
                    f"({len(batch_arr)} != {self.P * self.K})"
                )
            yield batch_arr
            emitted += 1
