"""Host data loader feeding batches to the card (counterpart of
``focus_tpu/datasets/loader.py``).

The batching is the JAX loader's, bit for bit: the epoch order (a
``RandomState(seed + epoch)`` permutation when shuffling), ``drop_last``,
and ``pad_last``, which fills a short last batch by repeating its own
leading samples (so one shorter than half a batch stays short) and marks
the repeats' sample index -1 so that meters skip them.
Samples are fetched by a pool of ``num_workers`` threads (decode and
augmentation release the GIL) and stacked into one batch by a producer
thread that runs ``prefetch`` batches ahead.

On the card the producer copies each host batch into pinned memory and on
to the device with ``non_blocking`` copies on a side CUDA stream, then
records an event; the consumer's stream waits on that event, and every
tensor of the batch is recorded on the consumer's stream, so the allocator
reuses none of it until the work queued there has read it. uint8 frames
stay uint8: ``ops/preprocess.device_normalize`` runs on the card.

``wait_seconds`` is the time the consumer of the last epoch spent waiting
for a batch, ``first_wait_seconds`` the part of it spent on the first.
A consumer that leaves an epoch early stops the producer: every put the
producer makes gives up once the consumer has gone, and the batches
already queued are dropped.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from focus_tpu_torch.datasets.build import build_dataset
from focus_tpu_torch.models.build import resolve_device


def _stack_tree(samples):
    """Stack a list of sample pytrees into one batched pytree."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            _stack_tree([s[i] for s in samples]) for i in range(len(first))
        )
    if isinstance(first, dict):
        return {k: _stack_tree([s[k] for s in samples]) for k in first}
    if np.isscalar(first) or (isinstance(first, np.ndarray) and first.ndim == 0):
        return np.asarray(samples)
    return np.stack(samples)


def _mark_padded(batch, pad_mask):
    """Set the sample-index leaf to -1 for batch-padding duplicates.

    Samples follow the (video, label, index, metadata) convention: the
    index leaf of padded rows becomes the sentinel -1, which the meters
    skip, so every clip is scored exactly once.
    """
    if not pad_mask.any():
        return batch
    if isinstance(batch, (tuple, list)) and len(batch) >= 3:
        idx = batch[2]
        if (
            isinstance(idx, np.ndarray)
            and idx.ndim == 1
            and np.issubdtype(idx.dtype, np.integer)
        ):
            idx = np.where(pad_mask, -1, idx)
            return type(batch)(
                idx if i == 2 else leaf for i, leaf in enumerate(batch)
            )
    return batch


def _map_tree(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to_tensor(x):
    """A numeric numpy leaf as a tensor sharing its memory; others as they
    are."""
    if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


PRODUCER = "focus_tpu_torch.DataLoader.producer"  # the producer's name


class DataLoader:
    """Batched iterator over a map-style dataset, with device prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        num_workers: int = 8,
        seed: int = 0,
        device="cuda",
        prefetch: int = 2,
        pad_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.epoch = 0
        self.wait_seconds = self.first_wait_seconds = 0.0
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        return order

    def _batches(self) -> Iterator[tuple]:
        """(sample indices, pad mask) of each batch of the epoch."""
        order = self._epoch_indices()
        bs = self.batch_size
        for start in range(0, len(order), bs):
            batch_idx = order[start : start + bs]
            n_real = len(batch_idx)
            if self.pad_last and n_real < bs:
                batch_idx = np.concatenate(
                    [batch_idx, batch_idx[: bs - n_real]]
                )
            yield batch_idx, np.arange(len(batch_idx)) >= n_real

    def _to_device(self, batch):
        """(batch of tensors on the device, the event its copies record or
        None)."""
        batch = _map_tree(_to_tensor, batch)
        if self._stream is None:
            return _map_tree(
                lambda x: x.to(self.device) if torch.is_tensor(x) else x,
                batch), None
        with torch.cuda.stream(self._stream):
            batch = _map_tree(
                lambda x: x.pin_memory().to(self.device, non_blocking=True)
                if torch.is_tensor(x) else x, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return batch, event

    def __iter__(self) -> Iterator[Any]:
        batches = self._batches()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx, pad_mask in batches:
                        if stop.is_set():
                            break
                        samples = list(pool.map(self.dataset.__getitem__, idx))
                        batch = _mark_padded(_stack_tree(samples), pad_mask)
                        if not put(self._to_device(batch)):
                            break
            except Exception as e:  # noqa: BLE001
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True, name=PRODUCER)
        t.start()
        self.wait_seconds = self.first_wait_seconds = 0.0
        first = True
        try:
            while True:
                t0 = time.perf_counter()
                item = out_q.get()
                waited = time.perf_counter() - t0
                self.wait_seconds += waited
                if first:
                    self.first_wait_seconds, first = waited, False
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for x in _leaves(batch):
                        if torch.is_tensor(x):
                            x.record_stream(stream)
                yield batch
        finally:
            stop.set()
            while True:  # drop what was queued (device batches included)
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break


def _process_count(cfg) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(cfg.NUM_SHARDS)


def construct_loader(cfg, split: str, device="cuda"):
    """The split's (dataset, batch size, shuffle, drop_last) as the
    reference's table has them; evaluation splits keep full batches by
    padding the last one."""
    assert split in ["train", "val", "test"]
    if _process_count(cfg) > 1:
        raise NotImplementedError(
            "more than one process: the sharded loader comes with the DDP "
            "slice of the port"
        )
    if (getattr(cfg.DATA_LOADER, "WORKER_BACKEND", "thread") or "thread") != "thread":
        raise NotImplementedError(
            "DATA_LOADER.WORKER_BACKEND process: the port's loader has "
            "thread workers only"
        )
    if split == "train" and cfg.MULTIGRID.SHORT_CYCLE:
        raise NotImplementedError(
            "MULTIGRID.SHORT_CYCLE: the multigrid short cycle comes with the "
            "train loop's slice of the port"
        )
    if split == "train" and cfg.AUG.ENABLE and cfg.AUG.NUM_SAMPLE > 1:
        raise NotImplementedError(
            "AUG.NUM_SAMPLE > 1: repeated augmentation comes with the train "
            "loop's slice of the port"
        )
    if split == "train":
        dataset_name = cfg.TRAIN.DATASET
        batch_size = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last = True, True
    elif split == "val":
        dataset_name = cfg.TRAIN.DATASET
        batch_size = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last = False, False
    else:
        dataset_name = cfg.TEST.DATASET
        batch_size = cfg.TEST.BATCH_SIZE
        shuffle, drop_last = False, False
    dataset = build_dataset(dataset_name, cfg, split)
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        seed=cfg.RNG_SEED,
        device=device,
        prefetch=cfg.TPU.PREFETCH,
        pad_last=not drop_last,
    )
