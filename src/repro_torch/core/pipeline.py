"""Multi-pipeline RAG integration (paper §4.1): decoupled workers + queues.

Requests flow  arrivals -> retrieval queue -> context queue -> done.
The retrieval and generation workers run as independent threads with their
own locks and their own backlog-aware schedulers, so batches are formed
*independently* per stage (the paper's key loosening of the serial
dependency).  Between batches each worker consults the placement policy —
the "lazy dynamic transfer" window where partitions / weight fractions are
adjusted without blocking the other pipeline.

The same decision objects (BacklogScheduler, PlacementOptimizer) also
drive the discrete-event simulator; this module is the real-time driver.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

from repro_torch.core.scheduler import BacklogScheduler


class StageQueue:
    """Thread-safe FIFO with enqueue timestamps."""

    def __init__(self, name: str):
        self.name = name
        self._dq: Deque[Any] = deque()
        self._lock = threading.Lock()
        self._event = threading.Event()

    def put(self, item: Any) -> None:
        with self._lock:
            self._dq.append(item)
            self._event.set()

    def put_many(self, items) -> None:
        with self._lock:
            self._dq.extend(items)
            if self._dq:
                self._event.set()

    def requeue(self, items) -> None:
        """Return popped-but-unprocessed items to the FRONT, preserving
        their original order (FIFO admission survives backpressure)."""
        with self._lock:
            self._dq.extendleft(reversed(list(items)))
            if self._dq:
                self._event.set()

    def pop_batch(self, n: int) -> List[Any]:
        with self._lock:
            out = []
            while self._dq and len(out) < n:
                out.append(self._dq.popleft())
            if not self._dq:
                self._event.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def snapshot(self) -> List[Any]:
        """Point-in-time copy of the queued items (nothing popped) —
        the scheduler peeks priorities without disturbing FIFO order."""
        with self._lock:
            return list(self._dq)

    def wait(self, timeout: float) -> bool:
        return self._event.wait(timeout)


@dataclass
class WorkerStats:
    batches: int = 0
    items: int = 0
    busy_seconds: float = 0.0
    batch_log: List[Dict[str, float]] = field(default_factory=list)


class PipelineWorker(threading.Thread):
    """One pipeline stage: forms batches by backlog, processes, forwards.

    ``process_fn(items) -> outputs`` runs under this worker's own lock;
    ``on_batch_boundary()`` (optional) is the lazy-reconfiguration hook
    called between batches (placement shifts, partition load/release).
    """

    def __init__(self, name: str, in_queue: StageQueue,
                 out_queue: Optional[StageQueue],
                 process_fn: Callable[[List[Any]], List[Any]],
                 scheduler: BacklogScheduler,
                 on_batch_boundary: Optional[Callable[[], None]] = None,
                 idle_wait: float = 0.01):
        super().__init__(name=name, daemon=True)
        self.in_queue = in_queue
        self.out_queue = out_queue
        self.process_fn = process_fn
        self.scheduler = scheduler
        self.on_batch_boundary = on_batch_boundary
        self.idle_wait = idle_wait
        self.stats = WorkerStats()
        # NB: must not be named ``_stop`` — that would shadow
        # threading.Thread._stop() and blow up inside Thread.join()
        self._stop_event = threading.Event()
        self._lock = threading.Lock()    # independent per-worker lock (§4.2)

    def stop(self) -> None:
        self._stop_event.set()

    def run(self) -> None:
        while not self._stop_event.is_set():
            backlog = len(self.in_queue)
            if backlog == 0:
                self.in_queue.wait(self.idle_wait)
                continue
            b = self.scheduler.choose_batch(backlog)
            if b <= 0:
                time.sleep(self.idle_wait)
                continue
            if self.on_batch_boundary is not None:
                self.on_batch_boundary()
            items = self.in_queue.pop_batch(b)
            if not items:
                continue
            t0 = time.perf_counter()
            with self._lock:
                outputs = self.process_fn(items)
            dt = time.perf_counter() - t0
            self.scheduler.observe(len(items), dt)
            self.stats.batches += 1
            self.stats.items += len(items)
            self.stats.busy_seconds += dt
            self.stats.batch_log.append(
                {"t": time.perf_counter(), "batch": len(items),
                 "seconds": dt, "backlog": backlog})
            if self.out_queue is not None and outputs:
                self.out_queue.put_many(outputs)


class StepPumpWorker(threading.Thread):
    """Iteration-level pipeline stage (continuous batching).

    Instead of popping a whole batch and blocking until it drains, the
    pump admits items from ``in_queue`` whenever ``capacity_fn()`` reports
    free slots, runs one decode step via ``step_fn()`` (which returns the
    items that finished *this step*), and forwards them immediately.  The
    lazy-reconfiguration hook ``on_policy_boundary`` runs every
    ``policy_every`` steps — the paper's dynamic batch policy acting
    *within* a generation rather than only between whole batches.
    """

    def __init__(self, name: str, in_queue: StageQueue,
                 out_queue: Optional[StageQueue],
                 capacity_fn: Callable[[], int],
                 admit_fn: Callable[[List[Any]], None],
                 step_fn: Callable[[], Optional[List[Any]]],
                 on_policy_boundary: Optional[Callable[[], None]] = None,
                 policy_every: int = 8,
                 idle_wait: float = 0.01):
        super().__init__(name=name, daemon=True)
        self.in_queue = in_queue
        self.out_queue = out_queue
        self.capacity_fn = capacity_fn
        self.admit_fn = admit_fn
        self.step_fn = step_fn
        self.on_policy_boundary = on_policy_boundary
        self.policy_every = max(policy_every, 1)
        self.idle_wait = idle_wait
        self.stats = WorkerStats()
        self._stop_event = threading.Event()    # see PipelineWorker note
        self._lock = threading.Lock()
        self._steps = 0

    def stop(self) -> None:
        self._stop_event.set()

    def run(self) -> None:
        while not self._stop_event.is_set():
            free = self.capacity_fn()
            items = self.in_queue.pop_batch(free) if free > 0 else []
            t0 = time.perf_counter()
            with self._lock:
                if items:
                    self.admit_fn(items)
                outputs = self.step_fn()
            dt = time.perf_counter() - t0
            if outputs is None and not items:   # no live slots: sleep
                self.in_queue.wait(self.idle_wait)
                continue
            self._steps += 1
            if (self.on_policy_boundary is not None
                    and self._steps % self.policy_every == 0):
                self.on_policy_boundary()
            self.stats.batches += 1
            self.stats.busy_seconds += dt
            if outputs:
                self.stats.items += len(outputs)
                self.stats.batch_log.append(
                    {"t": time.perf_counter(), "batch": len(outputs),
                     "seconds": dt, "backlog": len(self.in_queue)})
                if self.out_queue is not None:
                    self.out_queue.put_many(outputs)


@dataclass
class Pipeline:
    """The two-stage RAGDoll pipeline wiring."""

    retrieval_queue: StageQueue
    context_queue: StageQueue
    done_queue: StageQueue
    workers: List[PipelineWorker]

    def start(self) -> None:
        for w in self.workers:
            w.start()

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        for w in self.workers:
            w.join(timeout=5.0)

    def idle_fraction(self, horizon: float) -> Dict[str, float]:
        return {w.name: 1.0 - min(w.stats.busy_seconds / horizon, 1.0)
                for w in self.workers}


def build_pipeline(retrieval_fn, generation_fn,
                   ret_scheduler: BacklogScheduler,
                   gen_scheduler: BacklogScheduler,
                   on_ret_boundary=None, on_gen_boundary=None) -> Pipeline:
    rq = StageQueue("retrieval")
    cq = StageQueue("context")
    dq = StageQueue("done")
    rw = PipelineWorker("retrieval", rq, cq, retrieval_fn, ret_scheduler,
                        on_batch_boundary=on_ret_boundary)
    gw = PipelineWorker("generation", cq, dq, generation_fn, gen_scheduler,
                        on_batch_boundary=on_gen_boundary)
    return Pipeline(retrieval_queue=rq, context_queue=cq, done_queue=dq,
                    workers=[rw, gw])
