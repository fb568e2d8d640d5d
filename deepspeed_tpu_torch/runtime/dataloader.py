"""Data loader, in the port.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``: yields batches of
numpy arrays in an epoch-seeded permutation (``np.random.default_rng(seed +
epoch)``, so both packages draw the same order); the engine moves them to
its device. Accepts a ``Dataset``-style object (``__len__``/``__getitem__``),
a dict, tuple or list of arrays with a leading example dim, or any
iterable of batches.
"""

from typing import Any, Callable, Optional

import numpy as np


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class RepeatingLoader:
    """Wrap a loader to restart at StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        collate_fn: Optional[Callable] = None,
        seed: int = 1234,
        shuffle: bool = True,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

        self._arrays = None
        if isinstance(dataset, (dict, tuple, list)) and all(
            hasattr(x, "shape") for x in (dataset.values() if isinstance(dataset, dict) else dataset)
        ):
            self._arrays = dataset  # arrays with a leading example dim: index directly

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _num_examples(self):
        if self._arrays is not None:
            leaf = next(iter(self._arrays.values())) if isinstance(self._arrays, dict) else self._arrays[0]
            return len(leaf)
        return len(self.dataset)

    def __len__(self):
        n = self._num_examples()
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = self._num_examples()
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        nb = len(self)
        for b in range(nb):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            if self._arrays is not None:
                if isinstance(self._arrays, dict):
                    yield {k: np.asarray(v)[idx] for k, v in self._arrays.items()}
                else:
                    yield tuple(np.asarray(v)[idx] for v in self._arrays)
            else:
                yield self.collate_fn([self.dataset[int(i)] for i in idx])
        self.epoch += 1
