"""Host input pipeline (own copy of `ramdsir_tpu/data/loaders.py`): eval's
sequential batches, and the training loaders that build each step's batch
on the host, with thread or process workers.

Semantics of the training loaders (the reference's per-domain loaders,
code/train.py:549-566):
  * shuffle + drop_last per source-domain loader;
  * the longest loader defines the epoch; shorter loaders cycle, with a
    reshuffle on every wrap (the reference's itertools.cycle replays its
    first epoch's order; the JAX package reshuffles, and so does the port).
Each sample's random draws come from a Generator seeded by (seed, epoch,
step, domain, row in domain), its position in the global batch, so thread
workers, process workers and a `rows` slice of the batch give the same
numbers for one seed.

Workers run numpy and the port's data modules only: they never import
torch, and the card belongs to the process that trains.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(items: List[Dict]) -> Dict:
    """Arrays and numbers stacked along a new first axis; anything else (the
    string ids) kept as a list."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], (np.ndarray, int, float, np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def sequential_batches(dataset: Sequence[Dict], batch_size: int) -> Iterator[Dict]:
    """Batches of `batch_size` items in order; the last holds the rest (the
    batches of `DataLoader(shuffle=False, drop_last=False)`)."""
    for start in range(0, len(dataset), batch_size):
        yield collate([dataset[i] for i in range(start, min(start + batch_size, len(dataset)))])


class DataLoader:
    """One dataset's batches: shuffle, drop_last, items built by a thread
    pool and prefetched `prefetch` batches ahead."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: Optional[int] = None,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict]:
        order = self._epoch_order()
        nb = len(self)
        if nb == 0:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue `item` unless the consumer has stopped reading."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                        if not put(collate(list(pool.map(self.dataset.__getitem__, idx)))):
                            return
            except Exception as e:  # raised in the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


class _CycledLoader:
    """Endless iterator over a loader, reshuffled at each wrap."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self._it = iter(loader)

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)


class MultiDomainIterator:
    """The per-domain loaders zipped: the longest defines the epoch, the
    others cycle.  Yields a list of per-domain batches a step."""

    def __init__(self, loaders: Sequence[DataLoader]):
        self.loaders = list(loaders)
        for i, loader in enumerate(self.loaders):
            if len(loader) == 0:
                raise ValueError(
                    f"loader {i} yields 0 batches (dataset size {len(loader.dataset)} "
                    f"< batch size {loader.batch_size} with drop_last)"
                )
        self.steps_per_epoch = max(len(loader) for loader in self.loaders)
        self._max_id = int(np.argmax([len(loader) for loader in self.loaders]))

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self):
        cycled = [iter(l) if i == self._max_id else _CycledLoader(l) for i, l in enumerate(self.loaders)]
        for _ in range(self.steps_per_epoch):
            yield [next(c) for c in cycled]


def concat_domain_batches(batches: List[Dict[str, np.ndarray]], keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """Per-domain sub-batches concatenated along the first axis."""
    return {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys}


def _assemble_batch(
    datasets,
    keys: Sequence[str],
    base_seed: int,
    epoch: int,
    step: int,
    assignments: List[np.ndarray],
    rows: Optional[slice] = None,
) -> Dict[str, np.ndarray]:
    """Rows `rows` (default all) of one step's domain-major batch: domain d
    contributes the items `assignments[d]`, each built with the Generator
    seeded by (base_seed, epoch, step, d, row in domain)."""
    total = sum(len(a) for a in assignments)
    lo, hi = (rows.start, rows.stop) if rows is not None else (0, total)
    out: Dict[str, np.ndarray] = {}
    row = 0
    for d, idxs in enumerate(assignments):
        ds = datasets[d]
        for j, i in enumerate(idxs):
            if not (lo <= row < hi):
                row += 1
                continue
            if hasattr(ds, "get_item"):
                item = ds.get_item(int(i), np.random.default_rng((base_seed, epoch, step, d, int(j))))
            else:
                item = ds[int(i)]
            for k in keys:
                v = np.asarray(item[k])
                if k not in out:
                    out[k] = np.empty((hi - lo,) + v.shape, v.dtype)
                out[k][row - lo] = v
            row += 1
    return out


class FusedMultiDomainLoader:
    """Workers build each step's whole domain-major batch (the per-domain
    sub-batches of `batch_sizes`, concatenated) in its final layout, so the
    training thread only hands it to the device.  Thread workers, `prefetch`
    steps ahead.

    rows: the slice of the global batch this process builds (a data-parallel
    rank's share); the draws stay seeded by global position, so the slice
    equals those rows of the full build."""

    def __init__(
        self,
        datasets: Sequence,
        batch_sizes: Sequence[int],
        keys: Sequence[str],
        num_workers: int = 6,
        seed: Optional[int] = None,
        prefetch: int = 4,
        rows: Optional[slice] = None,
    ):
        if len(datasets) != len(batch_sizes):
            raise ValueError(f"{len(datasets)} datasets for {len(batch_sizes)} batch sizes")
        self.rows = rows
        self.datasets = list(datasets)
        self.batch_sizes = list(batch_sizes)
        self.keys = list(keys)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self._base_seed = seed if seed is not None else int(np.random.SeedSequence().entropy) % (2**31)
        self._epoch = 0
        lens = [len(ds) // bs for ds, bs in zip(datasets, batch_sizes)]
        for i, n in enumerate(lens):
            if n == 0:
                raise ValueError(f"domain {i}: dataset size {len(datasets[i])} < batch size {batch_sizes[i]}")
        self.steps_per_epoch = max(lens)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def _epoch_plan(self) -> List[List[np.ndarray]]:
        """Per-step, per-domain index lists of one epoch."""
        plan = [[None] * len(self.datasets) for _ in range(self.steps_per_epoch)]
        for d, (ds, bs) in enumerate(zip(self.datasets, self.batch_sizes)):
            order = self.rng.permutation(len(ds))
            pos = 0
            for s in range(self.steps_per_epoch):
                if pos + bs > len(order):  # wrap: reshuffle
                    order = self.rng.permutation(len(ds))
                    pos = 0
                plan[s][d] = order[pos : pos + bs]
                pos += bs
        return plan

    def _build_step(self, assignments: List[np.ndarray], epoch: int, step: int) -> Dict[str, np.ndarray]:
        return _assemble_batch(self.datasets, self.keys, self._base_seed, epoch, step, assignments, self.rows)

    def __iter__(self):
        plan = self._epoch_plan()
        epoch = self._epoch
        self._epoch += 1
        with ThreadPoolExecutor(self.num_workers) as pool:
            window = []
            nxt = 0
            while nxt < len(plan) and len(window) < self.prefetch:
                window.append(pool.submit(self._build_step, plan[nxt], epoch, nxt))
                nxt += 1
            while window:
                fut = window.pop(0)
                if nxt < len(plan):
                    window.append(pool.submit(self._build_step, plan[nxt], epoch, nxt))
                    nxt += 1
                yield fut.result()


def _proc_worker_main(datasets, keys, base_seed, q_in, q_out, rows=None):
    """A process worker: builds whole batches for (epoch, step, assignments)
    tasks until it reads None.  A failure goes back to the parent as a
    RuntimeError with the worker's traceback."""
    while True:
        task = q_in.get()
        if task is None:
            return
        epoch, step, assignments = task
        try:
            q_out.put((epoch, step, _assemble_batch(datasets, keys, base_seed, epoch, step, assignments, rows)))
        except Exception as e:  # raised in the parent
            import traceback

            q_out.put((epoch, step, RuntimeError(f"loader worker failed: {e}\n{traceback.format_exc()}")))


class ProcessFusedMultiDomainLoader(FusedMultiDomainLoader):
    """`FusedMultiDomainLoader` with process workers, which decode and
    augment in parallel where threads share the interpreter lock (the
    reference runs 24-40 DataLoader worker processes, train.py:558-559).

    The workers persist across epochs, each with its own decode cache.  They
    start by `forkserver` (from a clean server process, not by forking a
    parent whose CUDA context and threads they must not inherit); the
    datasets reach them by pickle once.  The PNG library is built in the
    parent before they start, so they only load it.  A worker that fails
    raises its error in the parent; one that dies raises there too.
    `shutdown` stops them."""

    def __init__(self, *args, num_workers: Optional[int] = None, **kwargs):
        kwargs.setdefault("prefetch", 6)
        super().__init__(*args, **kwargs)
        self.num_workers = num_workers or min(8, max(2, (os.cpu_count() or 4) - 2))
        self._pool = None

    def _ensure_pool(self):
        if self._pool is not None:
            return
        from ramdsir_tpu_torch import native

        native.PNG.path()
        ctx = multiprocessing.get_context("forkserver")
        self._q_in = ctx.Queue()
        self._q_out = ctx.Queue()
        self._pool = [
            ctx.Process(
                target=_proc_worker_main,
                args=(self.datasets, self.keys, self._base_seed, self._q_in, self._q_out, self.rows),
                daemon=True,
            )
            for _ in range(self.num_workers)
        ]
        for p in self._pool:
            p.start()

    def shutdown(self) -> None:
        """Stop the workers: each finishes its task and reads its stop
        sign; what they still send is drained (a worker exits only once
        its queue's buffer has gone out), and any left after 30 s is
        terminated."""
        if self._pool is None:
            return
        for _ in self._pool:
            self._q_in.put(None)
        deadline = time.monotonic() + 30.0
        while any(p.is_alive() for p in self._pool) and time.monotonic() < deadline:
            try:
                self._q_out.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in self._pool:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        self._q_in.close()
        self._q_out.close()
        self._pool = None

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.shutdown()

    def _next_result(self, epoch: int):
        """The next finished (step, batch) of `epoch`, skipping what an
        epoch left unread (a run that stopped mid-epoch); raises if a worker
        has died."""
        while True:
            try:
                done_epoch, step, batch = self._q_out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self._pool if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"loader worker died (exit codes {dead})") from None
                continue
            if done_epoch == epoch:
                return step, batch

    def __iter__(self):
        self._ensure_pool()
        plan = self._epoch_plan()
        epoch = self._epoch
        self._epoch += 1
        inflight = 0
        nxt = 0
        ready: Dict[int, Dict[str, np.ndarray]] = {}
        want = 0
        while nxt < len(plan) and inflight < self.prefetch:
            self._q_in.put((epoch, nxt, [np.asarray(a) for a in plan[nxt]]))
            nxt += 1
            inflight += 1
        while want < len(plan):
            while want not in ready:
                step, batch = self._next_result(epoch)
                inflight -= 1
                if isinstance(batch, Exception):
                    raise batch
                ready[step] = batch
                if nxt < len(plan):
                    self._q_in.put((epoch, nxt, [np.asarray(a) for a in plan[nxt]]))
                    nxt += 1
                    inflight += 1
            yield ready.pop(want)
            want += 1
