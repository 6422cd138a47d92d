"""Batching, shuffling, dual-domain pairing and device prefetch.

Counterpart of ``ess_tpu/data/loader.py``:

- :class:`BatchLoader`: map-style dataset -> shuffled, drop-last batches of
  numpy arrays, ``__getitem__`` on a thread pool, optionally collated into a
  ring of preallocated buffers (``collate_buffers``), which
  ``pin_memory=True`` places in page-locked host memory;
- :class:`PairedLoader`: iterates the longer of two loaders and restarts
  the shorter one when it runs out;
- :func:`prefetch_to_device`: a background thread moves the next batches to
  the device while the current one is consumed.

Data order for a seed, the index sharding (``shard_index`` /
``num_shards``), the collate ring's ``>= prefetch_size + 2`` rule and the
zero padding of ghost-folded record batches of mixed capacity are the JAX
package's; the port pads the packed folded wire's columns too, where the
JAX collate raises on them.

Data parallel: a loader whose ``replica`` is ``(rank, world)`` yields that
rank's rows ``[r*B/N, (r+1)*B/N)`` of each batch of B rows that the
one-device loader yields, in its order, and reads only those samples; the
JAX package's single-process mesh shards the same global batches. A batch
that does not divide over the ranks (a last partial batch without
``drop_last``) raises there, as the mesh's sharding does.
``prefetch_to_device`` then puts them on the rank's device. (Its
``shard_index`` / ``num_shards`` deal whole indices by stride instead,
the JAX package's split between hosts, which gives other batches.)
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ess_tpu_torch import resolve_device


# the per-record columns of a ghost-folded sample, f32 and packed wires
RECORD_KEYS = ("raw_events", "valid", "ev_xq", "ev_yq", "ev_tq", "ev_pq")


def _collate(samples: list, out: Optional[Dict[str, np.ndarray]] = None
             ) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into batch arrays, into ``out`` (a ring
    buffer of the same keys and shapes) when given. Ghost-folded record
    batches ("band_offsets" present) may mix record capacities (a sample
    that overflowed the default margin was binned at a larger quantized
    level): their record columns (``RECORD_KEYS``) are zero-padded to the
    batch's largest capacity. The voxelizer reads the padding as no
    records: zero polarity and no validity on the f32 wire, past the
    window's count ``band_offsets[..., -1]`` on the packed one."""
    folded = "band_offsets" in samples[0]
    if out is not None:
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
                dst = out[key]
                if (folded and key in RECORD_KEYS
                        and any(v.shape != dst.shape[1:] for v in vals)):
                    out[key] = _stack_padded(vals)
                    continue
                for i, v in enumerate(vals):
                    dst[i] = v
            else:
                out[key] = vals
        return out
    result = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if not (isinstance(vals[0], np.ndarray) or np.isscalar(vals[0])):
            result[key] = vals
        elif (folded and key in RECORD_KEYS
                and isinstance(vals[0], np.ndarray)
                and len({v.shape for v in vals}) > 1):
            result[key] = _stack_padded(vals)
        else:
            result[key] = np.stack(vals)
    return result


def _stack_padded(vals: list) -> np.ndarray:
    """Stack (T, cap_i[, 4]) arrays, each zero-padded on axis 1 to the
    largest capacity."""
    cap = max(v.shape[1] for v in vals)
    out = np.zeros((len(vals), vals[0].shape[0], cap) + vals[0].shape[2:],
                   vals[0].dtype)
    for i, v in enumerate(vals):
        out[i, :, :v.shape[1]] = v
    return out


def _empty(shape, dtype, pin: bool) -> np.ndarray:
    if not pin:
        return np.empty(shape, dtype)
    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True)
    return t.numpy()


def _alloc_like(samples: list, pin: bool = False) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        v = samples[0][key]
        if isinstance(v, np.ndarray):
            out[key] = _empty((len(samples),) + v.shape, v.dtype, pin)
        elif np.isscalar(v):
            out[key] = _empty((len(samples),), np.asarray(v).dtype, pin)
    return out


class BatchLoader:
    """Shuffled, drop-last batch iterator over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 6,
                 shard_index: int = 0, num_shards: int = 1,
                 collate_buffers: int = 0, prefetch_size: int = 2,
                 pin_memory: bool = False, replica: tuple = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.rng = np.random.default_rng(seed)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.replica = replica
        # A ring of N > 0 collate destinations recycles each buffer after N
        # batches. prefetch_to_device(size=d) may still read a buffer until
        # d + 1 batches later, so the ring needs N >= d + 2; 0 stacks fresh
        # arrays for every batch.
        if collate_buffers and collate_buffers < prefetch_size + 2:
            raise ValueError(
                f"collate_buffers={collate_buffers} is too shallow: a buffer "
                f"is rewritten after that many batches while prefetch keeps "
                f"prefetch_size + 1 = {prefetch_size + 1} in flight; use at "
                f"least {prefetch_size + 2}, or 0 for fresh arrays")
        self.collate_buffers = collate_buffers
        self.pin_memory = pin_memory
        self._ring: list = []
        self._ring_i = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx[self.shard_index:: self.num_shards]

    def __len__(self) -> int:
        # no _indices() here: the length must not advance the shuffle
        n = len(range(self.shard_index, len(self.dataset), self.num_shards))
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        n_batches = (len(idx) // self.batch_size if self.drop_last
                     else -(-len(idx) // self.batch_size))
        with ThreadPoolExecutor(self.num_workers) as pool:
            r, world = self.replica
            for b in range(n_batches):
                chunk = idx[b * self.batch_size: (b + 1) * self.batch_size]
                if world > 1:
                    if len(chunk) % world:
                        raise ValueError(
                            f"a batch of {len(chunk)} samples does not "
                            f"divide over {world} data-parallel ranks")
                    rows = len(chunk) // world
                    chunk = chunk[r * rows:(r + 1) * rows]
                samples = list(pool.map(self.dataset.__getitem__, chunk))
                out = None
                if (self.collate_buffers
                        and len(chunk) == self.batch_size // world):
                    if len(self._ring) < self.collate_buffers:
                        self._ring.append(_alloc_like(samples,
                                                      self.pin_memory))
                    out = self._ring[self._ring_i]
                    self._ring_i = (self._ring_i + 1) % self.collate_buffers
                yield _collate(samples, out)


class PairedLoader:
    """Pairs two loaders into one stream of (batch_a, batch_b) for
    ``max(len(a), len(b))`` steps; the shorter one restarts when it runs
    out."""

    def __init__(self, loader_a, loader_b):
        self.loader_a = loader_a
        self.loader_b = loader_b

    def __len__(self) -> int:
        return max(len(self.loader_a), len(self.loader_b))

    def __iter__(self):
        it_a, it_b = iter(self.loader_a), iter(self.loader_b)
        for _ in range(len(self)):
            try:
                a = next(it_a)
            except StopIteration:
                it_a = iter(self.loader_a)
                a = next(it_a)
            try:
                b = next(it_b)
            except StopIteration:
                it_b = iter(self.loader_b)
                b = next(it_b)
            yield a, b


def _is_array(v) -> bool:
    """A numpy array or scalar of a numeric or boolean type."""
    return (isinstance(v, (np.ndarray, np.generic))
            and v.dtype.kind in "biuf")


def prefetch_to_device(iterator, *, size: int = 2, device=None
                       ) -> Iterator[Dict[str, object]]:
    """Move the batches of ``iterator`` (dicts of numpy arrays; values of
    other types pass through) to ``device`` ahead of their use: a
    background thread keeps up to ``size`` batches queued and one more in
    transfer.

    ``device`` resolves as the entry points' does: ``cuda:0`` unless the
    caller names another device; with no CUDA device and none named this
    raises, and a batch asked for on the card is never left on the CPU. On
    a CUDA device each array is copied from page-locked host memory (the
    array itself when it lies in pinned memory, as a
    ``BatchLoader(pin_memory=True)`` ring does, else a pinned staging copy)
    with ``non_blocking=True`` on a side stream; the consumer's stream
    waits on that copy before it sees the batch, and the tensors are
    recorded on it. The producer waits for a batch's copy to finish before
    it pulls the batch ``size + 2`` places later, so a recycled collate
    buffer (a ring of at least ``size + 2``) is never rewritten while it is
    being read. On the CPU each array is copied into a new tensor.
    """
    device = resolve_device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        out, keep = {}, []
        for k, v in batch.items():
            if not _is_array(v):
                out[k] = v
                continue
            host = torch.from_numpy(np.ascontiguousarray(v))
            if not cuda:
                out[k] = host.clone()
                continue
            if not host.is_pinned():
                host = host.pin_memory()
            keep.append(host)
            with torch.cuda.stream(side):
                out[k] = host.to(device, non_blocking=True)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(side)
        return out, done, keep

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def producer():
        in_flight: collections.deque = collections.deque()
        try:
            for item in iterator:
                if stop.is_set():
                    return
                out, done, keep = put(item)
                in_flight.append((done, keep))
                q.put((out, done))
                while len(in_flight) > size:
                    old, _ = in_flight.popleft()
                    if old is not None:
                        old.synchronize()
        except BaseException as e:  # hand worker errors to the consumer
            err.append(e)
        finally:
            for done, _ in in_flight:
                if done is not None:
                    done.synchronize()
            q.put((sentinel, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item, done = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for v in item.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(stream)
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()
