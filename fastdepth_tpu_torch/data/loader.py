"""Threaded, device-feeding batch loader.

Replaces torch's worker-process DataLoader (reference main.py:40-41,
num_workers=16) with a thread pool + double-buffered device prefetch:
h5py/numpy release the GIL for IO and gathers, and batches land on device
(optionally sharded over a mesh) while the previous step computes —
the host-side half of the streaming-inference path (BASELINE.json
config #4).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Process-worker plumbing (worker_mode='process').  The dataset is shipped
# ONCE per pool via the initializer (a per-call ``pool.map(dataset.__getitem__,
# ...)`` would re-pickle the whole dataset every batch); items come back as
# pickled numpy arrays over the pipe.  Module-level functions, because spawn
# workers import this module to find them.

_WORKER_DS = None


def _process_worker_init(dataset) -> None:
    global _WORKER_DS
    _WORKER_DS = dataset


def _process_worker_get(index: int):
    return _WORKER_DS[index]


def shard_rows(batch_size: int, num_shards: int = 1, shard_id: int = 0,
               microbatches: int = 1) -> np.ndarray:
    """Positions, within a global batch of ``batch_size``, of the rows
    shard ``shard_id`` of ``num_shards`` loads.  With ``microbatches`` = 1
    they are contiguous: ``[shard_id * k, (shard_id + 1) * k)``, k =
    batch_size / num_shards.  With ``microbatches`` = m (a train step's
    ``accum_steps``) the global batch is m microbatches of mb = batch_size
    / m rows, and the shard takes its contiguous share of EACH:
    ``i * mb + shard_id * mb / num_shards`` onward, mb / num_shards rows,
    for i = 0 .. m - 1, microbatch after microbatch.  Splitting a shard's
    contiguous rows m ways instead would put other rows into each
    microbatch (other BatchNorm moments): the JAX mesh step's microbatch
    i is the global rows ``[i * mb, (i + 1) * mb)`` over the data axis."""
    if batch_size % microbatches:
        raise ValueError(f"batch_size {batch_size} must divide by microbatches {microbatches}")
    mb = batch_size // microbatches
    if mb % num_shards:
        raise ValueError(
            f"microbatch size {mb} (batch {batch_size} / accum_steps "
            f"{microbatches}) must divide by the data-axis "
            f"size {num_shards}: each device scans its own rows")
    k = mb // num_shards
    return (np.arange(microbatches)[:, None] * mb + shard_id * k + np.arange(k)).reshape(-1)


class BatchLoader:
    """Iterates (rgb, depth) NHWC float32 batches over a dataset.

    ``pad_last``: if True, the final short batch is zero-padded to
    ``batch_size`` and yielded with its true count, keeping shapes static
    for jit (metrics must use the count to ignore padding).
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
        pad_last: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        device_put=None,
        worker_mode: str = "thread",
        num_shards: int = 1,
        shard_id: int = 0,
        microbatches: int = 1,
    ):
        """``worker_mode='process'`` runs item production in
        ``num_workers`` SPAWNED worker processes instead of threads — the
        GIL-free fallback (the torch num_workers=16 worker-process model,
        reference main.py:40-41) for hosts where the thread pool's
        Python-side fraction caps scaling.  Spawn (never fork: the parent
        may hold CUDA runtime state) re-imports cleanly; the dataset
        ships to each worker once per epoch via the pool initializer, so
        it must be picklable and per-epoch state (``set_epoch``) must be
        set BEFORE iterating — both already the Trainer convention.
        Item results return pickled over pipes (~0.8 MB per 224-square
        item), so process mode pays an IPC tax per item; measured
        thread-vs-process items/s on this host: docs/bench_host_train_r4
        (scripts/bench_host_pipeline.py)."""
        if worker_mode not in ("thread", "process"):
            raise ValueError(
                f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        # Multi-process sharding (num_shards = the number of processes):
        # ``batch_size`` stays the GLOBAL batch; every process draws the
        # SAME epoch order (same seed/set_epoch -> identical shuffles),
        # forms the same global batches, and loads only its contiguous
        # rows [shard_id*k, (shard_id+1)*k), k = batch_size/num_shards —
        # contiguous (not strided), so that process p's rows sit at global
        # positions p*k.. and the assembled global batch is exactly the
        # single-process one, padding rows last.
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(
                f"shard_id {shard_id} out of range for num_shards {num_shards}")
        if batch_size % num_shards:
            raise ValueError(
                f"batch_size {batch_size} must divide by num_shards "
                f"{num_shards}: every process feeds an equal slice of "
                "each global batch")
        if microbatches > 1 and not drop_last:
            raise ValueError(
                "microbatches > 1 needs drop_last=True: every global batch must be "
                "whole to split into equal microbatches")
        if num_shards > 1 and not (pad_last or drop_last):
            raise ValueError(
                "num_shards > 1 needs pad_last=True (eval) or "
                "drop_last=True (train): a ragged final batch would give "
                "processes unequal shard shapes and wedge the global-"
                "array assembly")
        self.num_shards = num_shards
        self.shard_id = shard_id
        self._rows = shard_rows(batch_size, num_shards, shard_id, microbatches)
        self._local_batch = batch_size // num_shards
        self._item_shapes = None  # lazy probe for all-padding local slices
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.drop_last = drop_last
        self.device_put = device_put
        self.seed = seed
        self.worker_mode = worker_mode
        self._rng = np.random.RandomState(seed)

    def set_epoch(self, epoch: int) -> None:
        """Re-seed the shuffle for a given epoch: epoch k's batch order is
        then identical whether the run is fresh or resumed mid-training
        (the torch DistributedSampler.set_epoch convention).  Forwards to
        the dataset so per-item augmentation streams vary by epoch too."""
        self._rng = np.random.RandomState(self.seed + epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_pool(self):
        """(executor, per-index getter) for the configured worker mode."""
        if self.worker_mode == "process":
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(self.dataset,),
            )
            return pool, _process_worker_get
        return (
            ThreadPoolExecutor(max_workers=self.num_workers),
            self.dataset.__getitem__,
        )

    def _probe_shapes(self):
        """Per-component item shapes+dtypes, for local slices that fall
        entirely in the padded tail of a short global batch (possible
        only for the LAST shard under pad_last) — there is no item to
        stack, so the zeros need a shape from somewhere."""
        if self._item_shapes is None:
            item = self.dataset[0]
            self._item_shapes = tuple(
                (np.shape(a), np.asarray(a).dtype) for a in item)
        return self._item_shapes

    def _load_batch(
        self, pool, getter, indices: Sequence[int], global_count: int
    ) -> Tuple:
        """Load THIS shard's rows of one global batch, padded to the
        local slice size; ``global_count`` (the unpadded global batch
        length) rides along for the consumer's metric masking.  Items
        are arbitrary array tuples — classically (rgb, depth), plus the
        augmentation-parameter components in device-augment mode — each
        component stacked along a new batch axis."""
        if len(indices):
            items = list(pool.map(getter, indices))
            arrays = [np.stack([it[j] for it in items])
                      for j in range(len(items[0]))]
        else:
            arrays = [np.zeros((0,) + tuple(shape), dtype)
                      for shape, dtype in self._probe_shapes()]
        count = len(indices)
        if self.pad_last and count < self._local_batch:
            pad = self._local_batch - count
            arrays = [
                np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                for a in arrays
            ]
        return tuple(arrays) + (global_count,)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        # draw the epoch's order EAGERLY (here, not at the generator's
        # first next()): the generator body below only runs when first
        # advanced, so a lazy draw would make overlapping iterators'
        # orders depend on WHEN each was first consumed.  Drawn at
        # __iter__ time, the order depends only on the set_epoch/__iter__
        # call sequence — which the caller controls (and set_epoch(k)
        # re-seeds, keeping the resume contract exact).
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        # shard each GLOBAL batch to this process's rows (shard_rows;
        # identity when num_shards == 1); the global count rides along
        rows = self._rows
        return self._iterate([(idxs[rows[rows < len(idxs)]], len(idxs)) for idxs in batches])

    def _iterate(self, batches) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        # the pool is LOCAL to this iterator: two live iterators over one
        # loader (overlapping epochs, an abandoned generator held by a
        # traceback) must not shut down or submit into each other's pool
        pool, getter = self._make_pool()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        errors: list = []

        def put_or_stop(item) -> bool:
            """Bounded put that never wedges the producer: if the consumer
            abandoned the iterator (stop set) while the queue is full, a
            bare q.put() would block this thread forever — leaking it, its
            batch, and the executor for process lifetime."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idxs, global_count in batches:
                    if stop.is_set():
                        return
                    batch = self._load_batch(pool, getter, idxs, global_count)
                    if self.device_put is not None:
                        batch = tuple(
                            self.device_put(a) for a in batch[:-1]
                        ) + (batch[-1],)
                    if not put_or_stop(batch):
                        return
            except BaseException as e:  # propagate to the consumer — a
                errors.append(e)        # swallowed error would silently
            finally:                    # truncate the epoch
                put_or_stop(None)  # stop set ⇒ consumer gone, skip it

        t = threading.Thread(
            target=producer, daemon=True, name="fdtpu-batch-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if errors:
                        raise errors[0]
                    break
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            pool.shutdown(wait=False, cancel_futures=True)
