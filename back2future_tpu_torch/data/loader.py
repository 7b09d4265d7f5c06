"""Batch assembly and threaded host prefetch.

Replaces the reference's donkey thread pool (data.lua:22-51) and
dataLoader container (dataset.lua:19-157):

  * `FlowDataset` — indexable dataset over manifest specs with
    `sample(q)` (uniform random with replacement, dataset.lua:123-138)
    and `get(i1, i2)` (sequential, dataset.lua:140-155) batch methods.
  * `PrefetchLoader` — a pool of `n_workers` host threads, each with an
    independent `np.random.Generator` seeded from
    `(manual_seed, epoch, idx)` (the reference seeds donkeys once at
    pool creation, data.lua:32-37, so successive epochs see fresh draws
    from long-lived generators; here a fresh pool is built per epoch, so
    an epoch counter is mixed into the seed to preserve that freshness),
    keeping a bounded queue of ready batches ahead of the training loop;
    `n_workers=0` is the synchronous debug mode (data.lua:39-44).
  * `device_prefetch` — overlaps host->device transfer with compute by
    keeping `depth` batches in flight on the device: pinned host memory,
    copies on a side stream.

Batches are dicts of stacked NHWC arrays: images (B,H,W,3F),
flow_gt (B,H,W,2), occ_gt (B,H,W,2), mask (B,H,W).

The port's copy of back2future_tpu/data/loader.py. The content of every
batch is the JAX package's for the same seed and epoch
(tests/test_torch_data.py). Two behaviours are copied as they are, for
that parity, though a review of the JAX loader found them wanting
(ADVICE.md): the deterministic-sample memo does not survive an epoch in
process mode (each epoch's workers start empty), and the round-robin
sweep of `scene_batches` restarts at slot 0 every epoch, so when the
epoch's samples are not a multiple of the scenes the leading scenes get
one more visit each epoch. `device_prefetch` (loader.py:453-486) is
rewritten for torch, without the mesh: in a data-parallel run each rank's
loader yields its local slice of the global batch (`shard`) and
`device_prefetch` puts that slice on the rank's device, which is the
local-slice half of the JAX package's `make_global_batch` branch; the
other half, assembling the global array, is DDP's
(parallel/distributed.py).
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .manifest import SampleSpec
from .sample import SampleConfig, default_image_loader, test_sample, train_sample


def _cuda_live() -> bool:
    """True if this process has initialised a CUDA context (CUDA's own
    threads make os.fork() unsafe: a child can inherit a held lock and
    deadlock — see PrefetchLoader._iter_processes). The counterpart of
    loader.py:37-51 (`_jax_backend_live`); never initialises CUDA
    itself."""
    import sys

    if "torch" not in sys.modules:
        return False
    import torch

    return torch.cuda.is_initialized()


def collate(samples: Sequence) -> Dict[str, np.ndarray]:
    """Stack (images, target, mask) triples into batch arrays
    (dataset.lua:102-120)."""
    images = np.stack([s[0] for s in samples])
    target = np.stack([s[1] for s in samples])
    mask = np.stack([s[2] for s in samples])
    return {"images": images,
            "flow_gt": target[..., 0:2],
            "occ_gt": target[..., 2:4],
            "mask": mask}


class FlowDataset:
    """Indexable dataset over manifest sample specs."""

    def __init__(self, specs: Sequence[SampleSpec], cfg: SampleConfig,
                 indices: Optional[np.ndarray] = None, train: bool = True,
                 image_loader: Callable = default_image_loader):
        self.specs = list(specs)
        self.cfg = cfg
        self.train = train
        self.image_loader = image_loader
        self.indices = (np.asarray(indices, np.int64) if indices is not None
                        else np.arange(len(self.specs)))
        if len(self.indices) == 0:
            raise ValueError("dataset has no samples")

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def deterministic(self) -> bool:
        """Samples are pure functions of the index: always true for the
        testHook (no rng at all, donkey.lua:433-513) and true for the
        trainHook when cfg draws nothing (SampleConfig.deterministic)."""
        return (not self.train) or self.cfg.deterministic

    def load(self, i: int, rng: Optional[np.random.Generator] = None):
        spec = self.specs[int(self.indices[i])]
        if self.train:
            if rng is None:
                # an OS-entropy fallback here would silently break the
                # package's "deterministic given (seed, epoch)" contract
                raise ValueError(
                    "train dataset load() needs an explicit rng for the "
                    "augmentation draws (PrefetchLoader seeds per "
                    "(seed, epoch, slot, position))")
            return train_sample(spec, self.cfg, rng, self.image_loader)
        return test_sample(spec, self.cfg, self.image_loader)

    def collate_batch(self, samples: Sequence) -> Dict[str, np.ndarray]:
        """Stack + pack into the configured wire format (data/wire.py)."""
        from .wire import encode_batch

        return encode_batch(collate(samples), self.cfg.wire)

    def sample(self, q: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """q uniform-random samples with replacement (dataset.lua:123-138)."""
        ids = rng.integers(0, len(self), size=q)
        return self.collate_batch([self.load(int(i), rng) for i in ids])

    def get(self, i1: int, i2: int) -> Dict[str, np.ndarray]:
        """Sequential inclusive-exclusive range [i1, i2) (dataset.lua:140-155)."""
        return self.collate_batch(
            [self.load(i) for i in range(i1, min(i2, len(self)))])


class PrefetchLoader:
    """Batch prefetcher pool (the donkey pool, data.lua:22-51).

    Seeding is per batch slot: slot s of epoch e draws its sample indices
    from rng (manual_seed, e, s) and each sample's augmentations from
    (manual_seed, e, s, position). Epoch content is therefore
    deterministic given (seed, epoch) alone — identical across worker
    modes, worker counts, AND host counts (the reference seeds long-lived
    donkeys once, data.lua:32-37, making content depend on nDonkeys; the
    rebuild's scheme is strictly stronger and is what makes multi-host
    training trajectory-equivalent to single-host in the JAX package,
    tests/test_multiprocess.py).

    Multi-host sharding: `batch_size` is the GLOBAL batch; with
    shard=(h, n_hosts) the loader yields host h's local slice
    (batch_size // n_hosts samples) of every global batch — sample
    indices and augmentation draws are computed from the global slot and
    position, so n hosts together materialize exactly the single-host
    epoch.

    worker_mode:
      * "process" — one OS process per worker (the faithful analog of the
        reference's donkeys, which are independent Lua interpreters):
        full CPU parallelism, unconstrained by the GIL. Worker w owns
        batch slots w, w+n, w+2n, ...
      * "thread" — in-process threads; lower batch-handoff cost, but
        Python/NumPy glue in the sample hooks serializes on the GIL.
      * "auto" (default) — processes when the platform supports fork,
        threads otherwise (or when B2F_LOADER_MODE overrides).
    """

    def __init__(self, dataset: FlowDataset, batch_size: int,
                 n_batches: int, n_workers: int = 8, manual_seed: int = 2,
                 sequential: bool = False, queue_depth: int = 4,
                 worker_mode: str = "auto",
                 shard: Tuple[int, int] = (0, 1),
                 scene_batches: int = 0):
        if batch_size % shard[1]:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{shard[1]} hosts")
        if queue_depth < 1:
            # depth 0 would deadlock the pacing condition (slot 0 can
            # never run ahead of itself); depth 1 is the no-prefetch mode
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.n_workers = n_workers
        self.manual_seed = manual_seed
        self.sequential = sequential
        self.queue_depth = queue_depth
        self.worker_mode = worker_mode
        self.shard = tuple(shard)
        # >0: each batch is drawn from this many distinct scenes (sample
        # specs), the batch split evenly among them; augmentation draws
        # stay per-position. Scene-coherent batches preserve the
        # per-scene constant-flow gradient component that mixed batches
        # cancel — the component that drives escape from the zero-flow
        # saddle of the unsupervised objective (config.Options.scene_batches).
        self.scene_batches = int(scene_batches)
        # Deterministic-hook sample memo: when samples are pure functions
        # of the index (no augmentation/noise/random-crop draws —
        # FlowDataset.deterministic), cache decoded samples across
        # batches, bounded by B2F_SAMPLE_CACHE_GB (default 8; 0
        # disables). In sync and thread modes the memo lives on across
        # epochs, so later epochs run at RAM speed. Copied as it is from
        # the JAX loader (ADVICE.md): in process mode each epoch's
        # workers start from the parent's memo, so what they cache is
        # lost at the epoch's end, and in the full-set / sweep regime
        # every worker decodes and caches every scene it meets.
        # Scene-coherent batches (scene_batches=1) repeat one index per
        # batch, so they hit this cache batch-size times per step.
        import os as _os

        cap_gb = float(_os.environ.get("B2F_SAMPLE_CACHE_GB", "8"))
        self._sample_cache: Optional[Dict[int, object]] = (
            {} if cap_gb > 0 and getattr(dataset, "deterministic", False)
            else None)
        self._sample_cache_cap = int(cap_gb * (1 << 30))
        self._sample_cache_bytes = 0
        # Advanced once per __iter__ so re-iterating (one epoch = one
        # iteration in train_epoch) yields fresh sample indices and
        # augmentation draws instead of replaying epoch 0 forever.
        # The train loop pins it via set_epoch() so the stream follows
        # the GLOBAL epoch number, not iterations-since-construction.
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the sample stream to global epoch `epoch` (0-based), like
        torch's DistributedSampler.set_epoch. Without this a `-cont`
        resumed run would replay the streams from epoch 0 again (its
        fresh loader restarts the per-__iter__ counter), silently
        training on the wrong epochs' draws; with it, resume trajectories
        are exactly the uninterrupted run's
        (tests/test_loop.py::test_resume_trajectory_matches_straight_run)."""
        self.epoch = int(epoch)

    def _resolved_mode(self) -> str:
        import multiprocessing as mp
        import os

        mode = os.environ.get("B2F_LOADER_MODE", self.worker_mode)
        if mode not in ("process", "thread"):
            mode = ("process" if "fork" in mp.get_all_start_methods()
                    else "thread")
        return mode

    def __len__(self) -> int:
        return self.n_batches

    def _load_cached(self, i: int, rng):
        """dataset.load with the deterministic-sample memo. Thread
        workers share the dict (atomic item writes; a race costs at most
        one duplicate decode), and the byte cap is approximate."""
        cache = self._sample_cache
        if cache is not None:
            hit = cache.get(i)
            if hit is not None:
                return hit
        s = self.dataset.load(i, rng)
        if cache is not None and self._sample_cache_bytes < self._sample_cache_cap:
            cache[i] = s
            self._sample_cache_bytes += sum(
                a.nbytes for a in s if hasattr(a, "nbytes"))
        return s

    def _run_job(self, slot: int, epoch: int) -> Dict[str, np.ndarray]:
        """Materialize this host's slice of global batch `slot`."""
        h, n_hosts = self.shard
        local = self.batch_size // n_hosts
        lo, hi = h * local, (h + 1) * local
        if self.sequential:
            base = slot * self.batch_size
            stop = min(base + hi, len(self.dataset))
            return self.dataset.collate_batch(
                [self._load_cached(i, None) for i in range(base + lo, stop)])
        rng = np.random.default_rng((self.manual_seed, epoch, slot))
        if 0 < len(self.dataset) <= self.scene_batches:
            # k >= the dataset: deterministic coverage instead of random
            # draws. n <= batch: every batch holds EVERY scene (cyclic
            # fill) — identical content across steps, i.e. deterministic
            # full-batch Adam, the maximal gradient-consistency regime
            # for escaping the zero-flow saddle (the one-batch probe's
            # dynamics, tools/overfit_probe.py, extended to the whole
            # set). n > batch: round-robin sweep — batch b holds scenes
            # [b*B, (b+1)*B) mod n, so each scene-block recurs with
            # period ceil(n/B) (a random draw would both skip scenes and
            # decohere steps). Copied as it is (ADVICE.md): the sweep
            # restarts at slot 0 every epoch, so where n_batches*B is no
            # multiple of n the leading scenes get one extra visit an
            # epoch.
            n = len(self.dataset)
            if n <= self.batch_size:
                ids = np.resize(np.arange(n), self.batch_size)
            else:
                ids = (np.arange(self.batch_size)
                       + slot * self.batch_size) % n
        elif self.scene_batches > 0:
            k = min(self.scene_batches, self.batch_size)
            scenes = rng.integers(0, len(self.dataset), size=k)
            # even split, first scenes take the remainder (global layout,
            # so multi-host slices stay consistent)
            ids = np.repeat(scenes, -(-self.batch_size // k))[:self.batch_size]
        else:
            ids = rng.integers(0, len(self.dataset), size=self.batch_size)
        return self.dataset.collate_batch([self._load_cached(
            int(ids[pos]),
            np.random.default_rng((self.manual_seed, epoch, slot, pos)))
            for pos in range(lo, hi)])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        self.epoch += 1
        if self.n_workers == 0:  # synchronous debug mode (data.lua:39-44)
            for slot in range(self.n_batches):
                yield self._run_job(slot, epoch)
            return
        if self._resolved_mode() == "process":
            yield from self._iter_processes(epoch)
            return

        job_q: queue.Queue = queue.Queue()
        # slot-ordered output: batches are delivered in job order even if
        # workers finish out of order, for deterministic epoch replays
        results: Dict[int, Dict[str, np.ndarray]] = {}
        results_lock = threading.Lock()
        next_slot = [0]
        slot_ready = threading.Condition(results_lock)
        errors: List[BaseException] = []

        for i in range(self.n_batches):
            job_q.put(i)

        def worker(widx: int):
            while True:
                try:
                    slot = job_q.get_nowait()
                except queue.Empty:
                    return
                with slot_ready:
                    # bounded prefetch, checked BEFORE materializing: at
                    # most queue_depth batches live ahead of the consumer
                    # (pacing after compute would let every blocked
                    # worker hold a finished batch in its frame too)
                    while (slot - next_slot[0] >= self.queue_depth
                           and not errors):
                        slot_ready.wait(timeout=0.5)
                    if errors:
                        return
                try:
                    batch = self._run_job(slot, epoch)
                except BaseException as e:  # surfaced to the consumer
                    with slot_ready:
                        errors.append(e)
                        slot_ready.notify_all()
                    return
                with slot_ready:
                    results[slot] = batch
                    slot_ready.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.n_workers)]
        for t in threads:
            t.start()

        for slot in range(self.n_batches):
            with slot_ready:
                while slot not in results and not errors:
                    slot_ready.wait(timeout=0.5)
                if errors:
                    raise errors[0]
                batch = results.pop(slot)
                next_slot[0] = slot + 1
                slot_ready.notify_all()
            yield batch
        for t in threads:
            t.join(timeout=5)

    def _iter_processes(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Process-pool epoch: worker w computes slots w, w+n, w+2n, ...
        and streams (slot, batch) over an IPC queue whose bound provides
        the prefetch backpressure; the consumer reorders by slot. Slot
        seeding (see class docstring) makes the content identical to
        thread/sync modes.

        Start method: "fork" when the parent has not initialized a CUDA
        context (cheapest startup; workers never touch torch themselves),
        "spawn" once one is live, as in any real training run — forking
        a process with CUDA's threads holding a lock can deadlock a
        child (symptom: epoch stalls with "loader worker died"/queue
        timeouts). Spawn costs per-epoch interpreter startup and requires
        a picklable dataset/image_loader; override either way with
        B2F_MP_START. Each batch goes through the queue's pipe by
        pickle."""
        import multiprocessing as mp
        import os

        method = os.environ.get("B2F_MP_START", "") or (
            "spawn" if _cuda_live() else "fork")
        ctx = mp.get_context(method)
        n = min(self.n_workers, self.n_batches) or 1
        out_q = ctx.Queue(maxsize=max(self.queue_depth, n))
        # consumed-slot watermark: workers pace themselves against it so
        # no worker runs more than max(queue_depth, n) slots ahead of the
        # consumer — the same bounded-prefetch invariant as thread mode
        # (otherwise fast workers could fill the consumer's reorder
        # buffer with up to a whole epoch of batches)
        progress = ctx.Value("l", 0, lock=False)
        # paired condition so waiting workers sleep until the consumer
        # advances the watermark instead of polling
        pace = ctx.Condition()

        procs = [ctx.Process(
            target=_process_worker,
            args=(self, epoch, w, n, out_q, progress, pace,
                  max(self.queue_depth, n)), daemon=True)
            for w in range(n)]
        for p in procs:
            try:
                p.start()
            except (AttributeError, TypeError, pickle.PicklingError) as e:
                # spawn ships the dataset to the child by pickle; a local
                # closure / lambda image_loader that worked under fork
                # fails here with an opaque reduction error
                raise RuntimeError(
                    f"loader worker start failed under the '{method}' "
                    "start method because the dataset is not picklable "
                    f"({e}). Use module-level functions for "
                    "dataset/image_loader, or set B2F_MP_START=fork "
                    "(only safe before CUDA is initialized) or "
                    "B2F_LOADER_MODE=thread.") from e
        try:
            pending: Dict[int, Dict[str, np.ndarray]] = {}
            for slot in range(self.n_batches):
                while slot not in pending:
                    try:
                        got, batch = out_q.get(timeout=5)
                    except queue.Empty:
                        dead = [p for p in procs
                                if not p.is_alive() and p.exitcode not in
                                (0, None)]
                        if dead:  # e.g. OOM-killed / native crash: no
                            #       error sentinel ever arrives
                            raise RuntimeError(
                                "loader worker died (exitcode "
                                f"{dead[0].exitcode}); batch slot {slot} "
                                "will never arrive") from None
                        continue
                    if got == -1:
                        raise RuntimeError(f"loader worker failed: {batch}")
                    pending[got] = batch
                with pace:
                    progress.value = slot + 1
                    pace.notify_all()
                yield pending.pop(slot)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()


def _process_worker(loader: "PrefetchLoader", epoch: int, widx: int, n: int,
                    out_q, progress, pace, max_ahead: int) -> None:
    """Module-level so it works under both fork and spawn start methods.
    Paces itself against the consumer's `progress` watermark so at most
    `max_ahead` slots are in flight across queue + reorder buffer; waits
    on the shared condition (timeout as a liveness fallback) instead of
    polling."""
    try:
        for slot in range(widx, loader.n_batches, n):
            with pace:
                while slot - progress.value >= max_ahead:
                    pace.wait(timeout=1.0)
            out_q.put((slot, loader._run_job(slot, epoch)))
    except BaseException as e:  # surfaced to the consumer
        out_q.put((-1, f"{type(e).__name__}: {e}"))


def device_prefetch(host_batches: Iterator[Dict[str, np.ndarray]], device,
                    depth: int = 2) -> Iterator[Dict[str, object]]:
    """Keep `depth` batches in flight on `device` ahead of the consumer
    (the H2D side of the donkey pipeline, train.lua:206-208; the torch
    counterpart of loader.py:453-486, without the mesh). Under DDP a
    rank passes its loader's local slices and its own device: each
    batch stays the rank's slice (the JAX package's multi-host branch
    assembles the global array with `make_global_batch`, which the port
    does not need).

    On a CUDA device each array is copied into pinned host memory and
    sent `non_blocking` on a side stream; the consumer's stream waits on
    the copy's event before the batch is handed out, and each tensor is
    recorded on that stream so the caching allocator cannot reuse its
    memory while the consumer's kernels may still read it. On any other
    device (the CPU in the tests) a batch is a plain `torch.from_numpy`."""
    import collections

    import torch

    device = torch.device(device)
    if device.type == "cuda":
        side = torch.cuda.Stream(device)

        def put(hb):
            return _stage(hb, device, side)

        def take(staged):
            return _release(staged, device)
    else:
        def put(hb):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in hb.items()}

        def take(batch):
            return batch

    buf = collections.deque()
    for hb in host_batches:
        buf.append(put(hb))
        if len(buf) > depth:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())


def _stage(hb: Dict[str, np.ndarray], device, stream):
    """Start the H2D copies of one host batch on `stream`; returns the
    pinned host tensors, the device tensors and the event that marks the
    copies' end."""
    import torch

    with torch.cuda.stream(stream):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in hb.items()}
        dev = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return pinned, dev, done


def _release(staged, device) -> Dict[str, object]:
    """Hand a staged batch to the current stream of `device`."""
    import torch

    _pinned, dev, done = staged
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(done)
    for t in dev.values():
        t.record_stream(consumer)
    return dev
