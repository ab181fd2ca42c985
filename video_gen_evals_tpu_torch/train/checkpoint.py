"""Checkpoints of the port's trainer, as ``torch.save`` files.

The reference only saves best-on-test-loss model state_dicts, with no
optimizer or step state (ref ``train.py:450-455``). As in the JAX package
(``video_gen_evals_tpu/train/checkpoint.py``) that capability stays and a
full train state is added for exact resume:

- :func:`save_params` writes the reference layout ``{"model_state_dict":
  ...}``, which ``models.torch_compat.load_torch_checkpoint`` and the scoring
  CLI read;
- :func:`save_train_state` / :func:`restore_train_state` hold model,
  optimizer, schedule, step, epoch and best eval loss;
- :class:`AsyncSaver` writes on a worker thread.

Every file is published by writing a temporary file and renaming it, so a
crash mid-write never leaves a torn file at the published path. Files are
read with ``weights_only=True``: tensors and plain containers only.
"""

from __future__ import annotations

import os
import queue
import threading
import typing as T

import torch


def _map_tensors(tree, fn: T.Callable[[torch.Tensor], torch.Tensor]):
    """``tree`` (tensors in dicts, lists and tuples) with ``fn`` on every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def snapshot(tree):
    """A copy of ``tree`` on its own device, for a save that runs while the
    optimizer goes on updating the live tensors in place."""
    return _map_tensors(tree, lambda t: t.detach().clone())


def _publish(path: str, obj) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_map_tensors(obj, lambda t: t.detach().cpu()), tmp)
    os.replace(tmp, path)


def save_params(path: str, model_state: T.Mapping[str, torch.Tensor]) -> None:
    """The model's state_dict in the reference layout."""
    _publish(path, {"model_state_dict": dict(model_state)})


def save_train_state(path: str, state: T.Mapping[str, T.Any]) -> None:
    """``state``: ``{"model", "train_step", "epoch", "best_eval_loss"}``."""
    _publish(path, dict(state))


def restore_train_state(path: str) -> T.Dict[str, T.Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


class AsyncSaver:
    """One-worker FIFO background checkpoint writer.

    A save copies the state from the device to the host and writes a file;
    on a worker thread both overlap the next epoch's steps. Guarantees:

    - FIFO single worker: saves land in submit order, so a resume file is
      never overwritten by an older epoch's bytes.
    - Deferred errors: a failed save is re-raised at the next :meth:`submit`
      or :meth:`wait`, never lost (resume depends on knowing the file is
      there).
    - Callers must :meth:`wait` before relying on the files. The worker is a
      daemon thread: an interpreter exit without a wait may cut a write
      short, which is a crash, and the rename publish makes that safe.

    What a submitted save reads must not change afterwards: hand it a
    :func:`snapshot`.
    """

    def __init__(self) -> None:
        self._q: "queue.Queue[T.Callable[[], None]]" = queue.Queue()
        self._thread: T.Optional[threading.Thread] = None
        self._err: T.Optional[BaseException] = None
        self._lock = threading.Lock()

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — deferred to the caller
                with self._lock:
                    if self._err is None:
                        self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError("async checkpoint save failed") from err

    def submit(self, fn: T.Callable[[], None]) -> None:
        self._raise_pending()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, name="ckpt-saver", daemon=True)
            self._thread.start()
        self._q.put(fn)

    def wait(self) -> None:
        """Block until every submitted save has finished; re-raise failures."""
        self._q.join()
        self._raise_pending()
