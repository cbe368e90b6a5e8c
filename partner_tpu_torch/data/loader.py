"""Data loader: per-host sharded sampling and threaded prefetch.

Counterpart of ``partner_tpu/data/loader.py``: each host draws its
contiguous shard of an epoch-seeded permutation, builds fixed-shape
batches in worker threads and prefetches a bounded queue. The JAX
version asks jax for the host count and index; here the caller passes them.
The group-aware ``GroupSampler`` of the train path is not ported yet
(ROADMAP.md queue 1: the train-mode data path).
"""

import queue
import threading

import numpy as np

from .collate import collate


class EpochSampler:
    """Epoch-seeded shuffled, per-host contiguous shard."""

    def __init__(self, n, batch_size, shuffle=True, num_hosts=1, host_id=0,
                 seed=0, drop_last=True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.seed = seed
        self.drop_last = drop_last

    def indices(self, epoch):
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        per_host = int(np.ceil(self.n / self.num_hosts))
        pad = per_host * self.num_hosts - self.n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        shard = idx[self.host_id * per_host : (self.host_id + 1) * per_host]
        if self.drop_last:
            nb = len(shard) // self.batch_size
            shard = shard[: nb * self.batch_size]
        return shard


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, num_workers=2,
                 max_points=200000, max_voxels=None, num_hosts=1, host_id=0,
                 seed=0, prefetch=4, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_points = max_points
        self.max_voxels = max_voxels
        self.sampler = EpochSampler(
            len(dataset), batch_size, shuffle, num_hosts, host_id, seed
        )
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate_fn = collate_fn or (
            lambda items: collate(items, max_points=self.max_points,
                                  max_voxels=self.max_voxels)
        )
        self.epoch = 0

    def __len__(self):
        return len(self.sampler.indices(0)) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        idx = self.sampler.indices(self.epoch)
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        q = queue.Queue(maxsize=self.prefetch)
        batch_q = queue.Queue()
        for b in batches:
            batch_q.put(b)
        stop = threading.Event()
        n_live = [self.num_workers]
        lock = threading.Lock()

        def worker():
            while not stop.is_set():
                try:
                    b = batch_q.get_nowait()
                except queue.Empty:
                    break
                try:
                    items = [self.dataset[int(i)] for i in b]
                    q.put(self.collate_fn(items))
                except Exception as e:  # surface worker errors to consumer
                    q.put(e)
                    break
            with lock:
                n_live[0] -= 1
                if n_live[0] == 0:
                    q.put(None)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        try:
            served = 0
            while served < len(batches):
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                served += 1
                yield item
        finally:
            stop.set()


def build_dataloader(dataset, batch_size, workers_per_gpu=2, shuffle=True,
                     max_points=200000, max_voxels=None, num_hosts=1,
                     host_id=0, **kwargs):
    return DataLoader(
        dataset, batch_size, shuffle=shuffle, num_workers=workers_per_gpu,
        max_points=max_points, max_voxels=max_voxels,
        num_hosts=num_hosts, host_id=host_id, **kwargs,
    )
