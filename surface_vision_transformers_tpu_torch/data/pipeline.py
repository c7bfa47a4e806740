"""Host-streaming input (counterpart of ``surface_vision_transformers_tpu.
data.pipeline.StreamingLoader``).

``StreamingLoader`` iterates shuffled, weight-padded batches of a
host-resident split (a plain array or a read-only np.memmap, which is never
read whole) in the JAX loader's order: epoch e permutes the rows with numpy's
``default_rng(seed + e)``, batch s takes rows [s*bs, (s+1)*bs) of the
permutation, and the last batch is padded with row 0 at weight 0.
``set_epoch`` aligns the order with an epoch index, as a resumed run needs.
Under a mesh (``layout``) each rank stages only its rows of every global
batch (``parallel.Layout.batch_index_of``, its share of each of
``accum`` microbatches, padding at weight 0), in the single process's
order.

On a CUDA device a background thread stages each batch: its rows are
gathered on the host (in chunks, on a pool of threads) into one of two
pinned buffers and copied to the device on a copy stream with
``non_blocking=True``; events order the copy after the step that last read
that slot and the step after the copy, so batch k+1 is gathered and copied
while the device runs batch k, and the next epoch's first batch while it
runs an epoch's last. A yielded batch stays valid until the batch after
next is requested. On the CPU the rows are gathered into fresh arrays.
``wait_s`` is the host time the consumer spent waiting for batches over the
last epoch.
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

# Row-gather threads: half the host's cores, at most 4. The training loop's
# own host work (its launches) shares the cores; more gather threads took
# longer steps than they saved (scripts/stream_step_threads.py).
GATHER_THREADS = max(1, min(4, (os.cpu_count() or 2) // 2))


def gather_rows(source: np.ndarray, idx: np.ndarray, out: np.ndarray,
                pool: ThreadPoolExecutor | None = None) -> np.ndarray:
    """``source[idx]`` into ``out`` (float32), casting per batch, so an
    on-disk float64 / float16 split is never converted whole; in
    ``GATHER_THREADS`` chunks of rows on ``pool`` where given."""
    def rows(lo, hi):
        if source.dtype == out.dtype:
            np.take(source, idx[lo:hi], axis=0, out=out[lo:hi])
        else:
            out[lo:hi] = source[idx[lo:hi]]

    if pool is None or len(idx) < 2:
        rows(0, len(idx))
    else:
        cuts = np.linspace(0, len(idx), min(len(idx), GATHER_THREADS) + 1).astype(int)
        for f in [pool.submit(rows, lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])]:
            f.result()
    return out


class StreamingLoader:
    """Shuffled, weight-padded batch iterator yielding (batch, targets,
    weights) float32 tensors on ``device`` (targets None when not given)."""

    def __init__(self, data: np.ndarray, targets: Optional[np.ndarray] = None, *,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 device="cpu", layout=None, accum: int = 1):
        if targets is not None and data.shape[0] != targets.shape[0]:
            raise ValueError(f"{data.shape[0]} samples vs {targets.shape[0]} targets")
        self.data = data
        self.targets = targets
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.device = torch.device(device)
        self.layout, self.accum = layout, accum
        self.wait_s = 0.0
        self._epoch = 0
        self._slots = None
        self._pool = None

    def set_epoch(self, epoch: int) -> None:
        """Align the shuffle stream with epoch ``epoch`` (the next iteration
        draws that epoch's order)."""
        self._epoch = int(epoch)

    @property
    def num_samples(self) -> int:
        return self.data.shape[0]

    def steps_per_epoch(self) -> int:
        return math.ceil(self.num_samples / self.batch_size)

    def plan(self, epoch: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """The (row indices (bs,), weights (bs,)) of every batch of epoch
        ``epoch``; under a mesh this rank's rows of each."""
        n, bs = self.num_samples, self.batch_size
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        out = []
        for s in range(self.steps_per_epoch()):
            idx = order[s * bs:(s + 1) * bs]
            w = np.ones(bs, np.float32)
            if idx.size < bs:
                w[idx.size:] = 0.0
                idx = np.concatenate([idx, np.zeros(bs - idx.size, idx.dtype)])
            out.append((idx, w))
        if self.layout is not None:
            rows, valid = self.layout.batch_index_of(bs, self.accum)
            out = [(idx[rows], w[rows] * valid) for idx, w in out]
        return out

    def _gather_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(GATHER_THREADS)
        return self._pool

    def _host_batch(self, idx, w):
        pool = self._gather_pool()
        x = gather_rows(self.data, idx,
                        np.empty((len(idx), *self.data.shape[1:]), np.float32), pool)
        t = (None if self.targets is None else
             gather_rows(self.targets, idx, np.empty(len(idx), np.float32)))
        return (torch.from_numpy(x), None if t is None else torch.from_numpy(t),
                torch.from_numpy(w))

    def __iter__(self) -> Iterator[tuple]:
        epoch = self._epoch
        plan = self.plan(epoch)
        self._epoch += 1
        self.wait_s = 0.0
        if self.device.type == "cuda":
            yield from self._iter_cuda(epoch, plan)
            return
        for idx, w in plan:
            t0 = time.perf_counter()
            batch = tuple(None if t is None else t.to(self.device)
                          for t in self._host_batch(idx, w))
            self.wait_s += time.perf_counter() - t0
            yield batch

    def _make_slots(self) -> list[dict]:
        bs, dev = self.batch_size, self.device
        if self.layout is not None:  # this rank's rows of a batch
            bs = len(self.layout.batch_index_of(bs, self.accum)[0])
        shapes = {"x": (bs, *self.data.shape[1:]), "w": (bs,)}
        if self.targets is not None:
            shapes["t"] = (bs,)
        return [{"host": {k: torch.empty(s, dtype=torch.float32, pin_memory=True)
                          for k, s in shapes.items()},
                 "dev": {k: torch.empty(s, dtype=torch.float32, device=dev)
                         for k, s in shapes.items()},
                 "copied": torch.cuda.Event(), "consumed": torch.cuda.Event()}
                for _ in range(2)]

    def close(self) -> None:
        """Wait for a batch staged ahead and stop the loader's threads."""
        if self._slots is not None:
            if self._ahead is not None:
                self._ahead[1].result()
                self._ahead = None
            self._stager.shutdown()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _stage(self, slot: dict, idx, w) -> dict:
        """On the stager thread: gather a batch into ``slot``'s pinned
        buffers and issue their copy to the device on the copy stream."""
        slot["copied"].synchronize()  # the buffers' last copy has been read
        host = slot["host"]
        gather_rows(self.data, idx, host["x"].numpy(), self._gather_pool())
        if "t" in host:
            gather_rows(self.targets, idx, host["t"].numpy())
        host["w"].numpy()[...] = w
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            # the step that last read this slot's device buffers is done
            self._copy_stream.wait_event(slot["consumed"])
            for key, t in host.items():
                slot["dev"][key].copy_(t, non_blocking=True)
            slot["copied"].record(self._copy_stream)
        return slot

    def _submit(self, idx, w) -> Future:
        """Stage a batch into the next slot in turn."""
        slot = self._slots[self._turn % 2]
        self._turn += 1
        return self._stager.submit(self._stage, slot, idx, w)

    def _iter_cuda(self, epoch: int, plan) -> Iterator[tuple]:
        if self._slots is None:
            self._slots = self._make_slots()
            self._copy_stream = torch.cuda.Stream(self.device)
            self._stager = ThreadPoolExecutor(1)
            self._turn, self._ahead = 0, None
        compute = torch.cuda.current_stream(self.device)
        ahead, self._ahead = self._ahead, None
        if ahead is not None and ahead[0] == epoch:
            staged = ahead[1]
        else:  # nothing staged, or another epoch's first batch (set_epoch)
            if ahead is not None:
                ahead[1].result()
            staged = self._submit(*plan[0])
        for k in range(len(plan)):
            t0 = time.perf_counter()
            slot = staged.result()
            # the next batch -- after the last, the next epoch's first, whose
            # order is known now -- goes to the slot that held batch k-1,
            # whose step is queued
            if k + 1 < len(plan):
                staged = self._submit(*plan[k + 1])
            else:
                self._ahead = (epoch + 1, self._submit(*self.plan(epoch + 1)[0]))
            compute.wait_event(slot["copied"])
            dev = slot["dev"]
            self.wait_s += time.perf_counter() - t0
            yield dev["x"], dev.get("t"), dev["w"]
            slot["consumed"].record(compute)
