"""Data loader: per-host sharded sampling and threaded prefetch.

Counterpart of ``partner_tpu/data/loader.py``: each host draws its
contiguous shard of an epoch-seeded permutation (``GroupSampler`` when the
dataset's ``flag`` holds more than one group, so that a batch never mixes
groups), builds fixed-shape batches in worker threads and prefetches a
bounded queue. Batches come out in the order the threads finish them: with
more than one thread that order, and the order in which the pipeline draws
from its random state, can change from run to run. The JAX version asks
jax for the host count and index; here the caller passes them.

Data parallelism (``rank``, ``world_size``) splits each global batch by
position: the sampler runs as one process's would (one host, the same
seed on every rank), and rank r loads the r-th ``batch_size /
world_size`` samples of each batch, whole samples (a double-flip
sample's four point rows stay together; a group sampler's batch stays in
one group). So N ranks load the same samples (the same indices) in
each global batch as one process does, as JAX's single-host ``data=N``
mesh does (``shard_batch``), and not the per-host contiguous shards of
the JAX loader's multi-host path. The pipeline's random draws
(augmentation, GT-AUG, sweeps) are each rank's own.
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


class GroupSampler:
    """Group-aware epoch-seeded sampler (``loader.py:48-96``): every run of
    ``batch_size`` consecutive indices lies in one ``flag`` group. Per
    group: shuffle, cycle to a multiple of batch_size * num_hosts; then
    concatenate, permute whole batches, and give each host its contiguous
    ``num_samples`` slice. One (seed, epoch) always gives one order."""

    def __init__(self, flag, batch_size, num_hosts=1, host_id=0, seed=0):
        self.flag = np.asarray(flag).astype(np.int64)
        self.batch_size = batch_size
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.seed = seed
        self.group_sizes = np.bincount(self.flag)
        self.num_samples = int(sum(
            int(np.ceil(s / (batch_size * num_hosts))) * batch_size
            for s in self.group_sizes
        ))

    def indices(self, epoch):
        rng = np.random.RandomState(self.seed + epoch)
        chunks = []
        for g, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == g)[0]
            idx = idx[rng.permutation(size)]
            target = (int(np.ceil(size / (self.batch_size * self.num_hosts)))
                      * self.batch_size * self.num_hosts)
            chunks.append(np.resize(idx, target))
        allidx = np.concatenate(chunks)
        nb = len(allidx) // self.batch_size
        allidx = allidx.reshape(nb, self.batch_size)[rng.permutation(nb)]
        allidx = allidx.reshape(-1)
        off = self.num_samples * self.host_id
        return allidx[off : off + self.num_samples]


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, num_workers=2,
                 max_points=200000, max_voxels=None, num_hosts=1, host_id=0,
                 seed=0, prefetch=4, collate_fn=None, group_by_flag=None,
                 rank=0, world_size=1):
        if batch_size % world_size:
            raise ValueError(f"a global batch of {batch_size} does not split "
                             f"over {world_size} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        # this rank's positions in each global batch
        self.part = slice(rank * batch_size // world_size,
                          (rank + 1) * batch_size // world_size)
        self.max_points = max_points
        self.max_voxels = max_voxels
        flag = getattr(dataset, "flag", None)
        if group_by_flag is None:
            # one group: GroupSampler would only be EpochSampler again
            group_by_flag = (
                shuffle and flag is not None and len(np.unique(flag)) > 1)
        if group_by_flag:
            self.sampler = GroupSampler(flag, batch_size, num_hosts, host_id,
                                        seed)
        else:
            self.sampler = EpochSampler(
                len(dataset), batch_size, shuffle, num_hosts, host_id, seed)
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
            idx[i : i + self.batch_size][self.part]
            for i in range(0, len(idx), self.batch_size)
        ]
        q = queue.Queue(maxsize=self.prefetch)
        batch_q = queue.Queue()
        for b in batches:
            batch_q.put(b)
        stop = threading.Event()
        n_live = [self.num_workers]
        lock = threading.Lock()

        def put(item):
            # a consumer that stopped early (a capped epoch) leaves the
            # queue full: give up then rather than block for ever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    b = batch_q.get_nowait()
                except queue.Empty:
                    break
                try:
                    items = [self.dataset[int(i)] for i in b]
                    put(self.collate_fn(items))
                except Exception as e:  # surface worker errors to consumer
                    put(e)
                    break
            with lock:
                n_live[0] -= 1
                if n_live[0] == 0:
                    put(None)

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
    """A loader of global batches of ``batch_size``; with ``rank`` and
    ``world_size`` in ``kwargs``, each batch's part of that rank."""
    return DataLoader(
        dataset, batch_size, shuffle=shuffle, num_workers=workers_per_gpu,
        max_points=max_points, max_voxels=max_voxels,
        num_hosts=num_hosts, host_id=host_id, **kwargs,
    )
