"""Persistent asynchronous runtime with dataflow run graphs (Tier-2).

The paper's headline overhead result (≤2.8% vs. native OpenCL) relies on a
*resident* multi-threaded runtime: device threads and queues live across
kernel launches.  This module is that runtime for the JAX port:

- ``GroupExecutor`` — one long-lived daemon thread per ``DeviceGroup``
  draining a FIFO job queue, so repeated runs/steps never pay thread spawn.
  ``submit_batch`` enqueues a job set atomically with respect to
  ``shutdown()``; post-shutdown submits raise deterministically.
- ``RunHandle``    — future-like per-run state: completion event, a private
  ``Introspector``, a lock-protected error list, and the run's *graph*
  edges: predecessor handles, run-scoped buffer write versions, and an
  optional epilogue (e.g. iterative buffer ping-pong) executed on the last
  worker before the handle completes.
- ``Runtime``      — ``submit(program, scheduler, after=...) -> RunHandle``.
  Predecessors are taken from ``after=``, from ``Program.reads_from`` links,
  and *inferred* from shared host buffers (read-after-write,
  write-after-write, write-after-read on buffer identity).  Dependent runs
  wait on their predecessors **on the worker threads**, never on the host:
  a group's persistent worker starts its portion of run N+1 the moment run
  N is safe for it, so chains of linked Programs pipeline without a host
  barrier per stage.  A failed predecessor *poisons* dependents — they
  complete immediately with a ``RunError`` instead of running on stale
  inputs (or hanging).

A worker waits for a package's device work on a CUDA event its group
recorded right after the kernel's launches (the reference's
``jax.block_until_ready``); CPU packages complete on return.

``EngineCL`` is a facade over this: ``run()`` = ``submit()`` + wait, with
identical blocking semantics; ``run_pipeline``/``run_iterative`` submit
whole dependency chains and wait once at the end.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

from repro_torch.core.device import DeviceGroup
from repro_torch.core.introspector import Introspector, PackageRecord
from repro_torch.core.obs import bus as obs_bus
from repro_torch.core.program import Program, buffer_version, bump_version
from repro_torch.core.scheduler.base import Scheduler
from repro_torch.core.trace import tracer


def _trace_execute(rec: PackageRecord) -> None:
    """Introspector streaming sink → span tracer + observability bus:
    every package record becomes a complete "execute" span on its device
    group's track (the record's perf_counter timestamps are already in the
    tracer's clock) and a busy interval in any attached utilization meter
    — one measurement, two consumers, so traces and live efficiency can
    never disagree.  Both checks cost one attribute read when off."""
    tr = tracer()
    if tr.enabled:
        tr.complete("execute", rec.t_enqueue, rec.t_end,
                    track=f"group/{rec.device}",
                    offset=rec.offset_wi, size=rec.size_wi)
    b = obs_bus()
    if b.active:
        b.record(rec)


class RunError(RuntimeError):
    """Raised by ``RunHandle.result()`` when any device worker failed."""

    def __init__(self, errors: Sequence[str]) -> None:
        self.errors = list(errors)
        super().__init__("\n".join(self.errors))


class RunHandle:
    """Future-like handle for one submitted run (a node in the run graph)."""

    def __init__(self, program: Program, scheduler: Scheduler, n_workers: int,
                 introspector: Optional[Introspector] = None,
                 deps: Sequence["RunHandle"] = (),
                 epilogue: Optional[Callable[[], None]] = None,
                 targets: Sequence[DeviceGroup] = ()) -> None:
        self.program = program
        self.scheduler = scheduler
        # Device groups this run executes on (a subset of the runtime's
        # groups when the submit pinned the run, e.g. per-group serving
        # sub-batches).  The scheduler partitions work across exactly these.
        self.targets = list(targets)
        self.introspector = introspector or Introspector()
        self._lock = threading.Lock()
        self._errors: List[str] = []
        self._pending_workers = n_workers
        self._started = False
        self._done = threading.Event()
        # -- run graph state ----------------------------------------------
        self.deps = tuple(deps)
        self._epilogue = epilogue
        self._poisoned = False
        # Done-callbacks: appended under _lock while not _finalized; the
        # finalizing thread flips _finalized under the same lock, so every
        # callback lands in exactly one of (final drain, immediate fire).
        self._finalized = False
        self._callbacks: List[Callable[["RunHandle"], None]] = []
        self._prepared = False
        self._prepare_done = threading.Event()
        # One fresh version per (run, buffer) — see version_for_write.
        self._write_versions: dict[int, Optional[int]] = {}
        # Submit-time snapshot of the buffer sets, used by later submits to
        # infer conflicts.  Programs that mutate their buffer lists while in
        # flight (swap_buffers epilogues) are still handled conservatively:
        # same-Program submits always conflict.
        self.read_ids = frozenset(map(id, program._ins))
        self.write_ids = frozenset(map(id, program._outs))

    # -- worker-facing -----------------------------------------------------
    def _mark_started(self) -> None:
        """First worker to pick up the run stamps t_run_start — metrics of
        queued async runs must not include the wait behind earlier runs."""
        with self._lock:
            if self._started:
                return
            self._started = True
        self.introspector.start_run()

    def _ensure_prepared(self, groups) -> None:
        """Per-run ``prepare`` ordering: the scheduler clone is prepared by
        the first worker that actually starts the run — not at submit time —
        so queued runs of a dependency chain read geometry/powers when they
        begin, and every worker observes a fully-prepared scheduler before
        its first ``next_package``."""
        with self._lock:
            first = not self._prepared
            self._prepared = True
        if first:
            try:
                self.scheduler.prepare(
                    self.program.n_work_groups, self.program.lws, groups
                )
            finally:
                self._prepare_done.set()
        else:
            self._prepare_done.wait()

    def version_for_write(self, buf) -> Optional[int]:
        """Run-scoped write version: the first chunk written to ``buf`` in
        this run bumps its version once; every later chunk of the same run
        shares it.  All device-resident output slices a run stashes are
        therefore keyed on one coherent version — the one a dependent run
        will look up."""
        key = id(buf)
        # Bump-and-read under the handle lock: two groups writing the same
        # buffer concurrently must agree on ONE version, or every stash of
        # this run would be orphaned under a superseded token.  Lock order
        # (handle lock -> version-table lock) is acyclic: the version table
        # never calls back into handles.
        with self._lock:
            if key not in self._write_versions:
                bump_version(buf)
                self._write_versions[key] = buffer_version(buf)
            return self._write_versions[key]

    def record_error(self, msg: str) -> None:
        with self._lock:
            self._errors.append(msg)

    def _poison(self) -> None:
        """Mark this run as skipped due to an upstream failure (record the
        poison error once, however many workers observe it)."""
        with self._lock:
            if self._poisoned:
                return
            self._poisoned = True
        ups = [e.splitlines()[0] for d in self.deps if d.has_errors()
               for e in d.errors()[:1]]
        self.record_error(
            "poisoned: upstream run failed (" + "; ".join(ups) + ")"
        )

    def _worker_finished(self) -> None:
        with self._lock:
            self._pending_workers -= 1
            last = self._pending_workers <= 0
        if last:
            if self._epilogue is not None and not self.has_errors():
                t0 = time.perf_counter()
                try:
                    self._epilogue()
                except BaseException:  # noqa: BLE001 — must surface, not hang
                    self.record_error(f"epilogue: {traceback.format_exc()}")
                tr = tracer()
                if tr.enabled:
                    tr.complete("runtime.epilogue", t0, time.perf_counter(), track="runtime",
                                kernel=self.program.label)
            if self._started:
                self.introspector.end_run()
            self._finalize()

    def _fail(self, msgs: Sequence[str]) -> None:
        """Complete immediately without running (e.g. validation errors)."""
        with self._lock:
            self._errors.extend(msgs)
            self._pending_workers = 0
        self._finalize()

    def _finalize(self) -> None:
        """Final state transition: set done, then fire callbacks exactly once.

        _finalized flips under _lock *before* _done is set so a concurrent
        add_done_callback either lands in the drained batch or observes
        _finalized and fires immediately — never neither, never both."""
        with self._lock:
            self._finalized = True
            cbs, self._callbacks = self._callbacks, []
        self._done.set()
        for fn in cbs:
            self._run_callback(fn)

    def _run_callback(self, fn: Callable[["RunHandle"], None]) -> None:
        try:
            fn(self)
        except BaseException:  # noqa: BLE001 — a callback must not kill the
            traceback.print_exc()  # worker thread (or skip later callbacks)

    # -- caller-facing -----------------------------------------------------
    def add_done_callback(self, fn: Callable[["RunHandle"], None]) -> None:
        """Call ``fn(handle)`` exactly once when this run reaches a final
        state — success, worker failure, validation failure, or upstream
        poisoning — after ``done()`` is True (so ``result()`` inside the
        callback never blocks).  A handle that is already final fires ``fn``
        immediately on the calling thread; otherwise it fires on the worker
        thread that finalizes the run (after the epilogue, if any).
        Callback exceptions are printed and swallowed: they must not kill a
        resident worker or starve later callbacks."""
        with self._lock:
            if not self._finalized:
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> list:
        """Block until complete; re-raise worker errors; return outputs."""
        if not self.wait(timeout):
            raise TimeoutError("run did not complete within timeout")
        if self._errors:
            raise RunError(self._errors)
        return self.program.outputs

    def has_errors(self) -> bool:
        with self._lock:
            return bool(self._errors)

    def errors(self) -> List[str]:
        with self._lock:
            return list(self._errors)

    @property
    def metrics(self) -> dict:
        """Per-run metrics (balance, work share, packages) — see Introspector."""
        return self.introspector.summary()


def conflicts(reads: frozenset, writes: frozenset, other: RunHandle) -> bool:
    """True when a run reading ``reads``/writing ``writes`` (host-buffer ids)
    must be ordered after ``other``: read-after-write, write-after-write, or
    write-after-read on any shared host buffer."""
    return bool((reads | writes) & other.write_ids) or bool(writes & other.read_ids)


class GroupExecutor:
    """One persistent worker thread per DeviceGroup, FIFO job order.

    Jobs for one group run serially on its thread (a device computes
    packages serially); jobs across groups run concurrently.  Also reused by
    HeteroTrainer so training steps don't re-spawn threads either."""

    def __init__(self, groups: Sequence[DeviceGroup], name: str = "enginecl") -> None:
        self.groups = list(groups)
        self._queues: dict[int, "queue.Queue"] = {}
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()  # guards _alive vs. enqueue atomically
        self._alive = True
        for i, g in enumerate(self.groups):
            q: "queue.Queue" = queue.Queue()
            self._queues[id(g)] = q
            t = threading.Thread(
                target=self._worker, args=(q,), name=f"{name}-{g.name}-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    @staticmethod
    def _worker(q: "queue.Queue") -> None:
        while True:
            job = q.get()
            if job is None:
                return
            fn, on_done = job
            try:
                fn()
            except BaseException:  # noqa: BLE001 — a resident worker must
                pass  # survive anything a job raises; jobs report their own
            finally:
                if on_done is not None:
                    on_done()

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._alive

    def add_group(self, group: DeviceGroup, name: str = "enginecl") -> None:
        """Attach a new group at runtime (elastic join): fresh queue + worker
        thread, atomic with respect to shutdown.  Idempotent per group."""
        with self._lock:
            if not self._alive:
                raise RuntimeError("executor is shut down")
            if id(group) in self._queues:
                return
            q: "queue.Queue" = queue.Queue()
            self._queues[id(group)] = q
            self.groups.append(group)
            t = threading.Thread(
                target=self._worker, args=(q,),
                name=f"{name}-{group.name}-{len(self._threads)}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def submit(self, group: DeviceGroup, fn: Callable[[], None],
               on_done: Optional[Callable[[], None]] = None) -> None:
        self.submit_batch([(group, fn, on_done)])

    def submit_batch(self, jobs: Sequence[tuple]) -> None:
        """Atomically enqueue ``(group, fn, on_done)`` jobs: either every job
        lands before any shutdown sentinel, or none does and this raises.
        Without the lock a submit racing ``shutdown()`` could slip a job in
        after the ``None`` sentinel and silently never run."""
        with self._lock:
            if not self._alive:
                raise RuntimeError("executor is shut down")
            for group, fn, on_done in jobs:
                self._queues[id(group)].put((fn, on_done))

    def shutdown(self, wait: bool = False) -> None:
        """Stop the workers once their queued jobs are done; ``wait``: join
        them (a process that exits while a worker still unwinds from torch
        work can abort in the interpreter's teardown)."""
        with self._lock:
            if self._alive:
                self._alive = False
                for q in self._queues.values():
                    q.put(None)  # after queued jobs: workers drain, then exit
        if wait:
            for t in self._threads:
                if t is not threading.current_thread():
                    t.join()

    def __del__(self) -> None:  # best-effort: release threads with the owner
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class Runtime:
    """Resident execution core: persistent dispatcher threads + run graph."""

    def __init__(self, groups: Sequence[DeviceGroup], *, pipeline_depth: int = 2) -> None:
        if not groups:
            raise ValueError("Runtime needs at least one DeviceGroup")
        self.groups = list(groups)
        self.pipeline_depth = max(1, pipeline_depth)
        self.executor = GroupExecutor(self.groups)
        self._submit_lock = threading.Lock()
        self._inflight: List[RunHandle] = []

    @property
    def alive(self) -> bool:
        return self.executor.alive

    def add_group(self, group: DeviceGroup) -> None:
        """Elastic join: attach a DeviceGroup to a live runtime.  New submits
        that don't pin ``groups=`` fan out to it; in-flight runs are
        unaffected (their worker set was fixed at submit time)."""
        with self._submit_lock:
            if any(g is group for g in self.groups):
                return
            self.executor.add_group(group)
            self.groups.append(group)

    # ---------------------------------------------------------------- submit
    def submit(self, program: Program, scheduler: Scheduler, *,
               after: Optional[Sequence[RunHandle]] = None,
               epilogue: Optional[Callable[[], None]] = None,
               groups: Optional[Sequence[DeviceGroup]] = None) -> RunHandle:
        """Enqueue one run on the persistent workers; returns immediately.

        The run is ordered after (a) every handle in ``after=``, (b) any
        in-flight run of a Program this one ``reads_from``, and (c) any
        in-flight run whose submit-time buffer sets conflict with this one's
        (shared host buffers).  Dependency waits happen on the group worker
        threads — the host never blocks — and an upstream failure poisons
        this handle instead of executing on stale data.

        ``groups`` pins the run to a subset of the runtime's device groups
        (default: all of them) — the scheduler partitions work across the
        subset only, and only those groups' worker threads are enqueued.
        Conflict inference still spans all in-flight runs, so runs pinned to
        disjoint groups over disjoint buffers proceed concurrently while
        shared-buffer runs stay ordered.

        ``epilogue`` (if given) runs exactly once on the last worker after a
        successful run, before the handle completes — dependents observe its
        effects (e.g. ``swap_buffers``).  Validation errors complete the
        handle immediately (``result()`` raises ``RunError``)."""
        targets = list(groups) if groups else self.groups
        deps: List[RunHandle] = []
        if after is not None:
            deps.extend([after] if isinstance(after, RunHandle) else list(after))
        reads = frozenset(map(id, program._ins))
        writes = frozenset(map(id, program._outs))
        linked = set(map(id, program._linked))
        with self._submit_lock:  # same run order in every group's queue
            self._inflight = [h for h in self._inflight if not h.done()]
            # Newest-first: a same-program predecessor transitively orders
            # all older same-program runs (each submit chained to the then-
            # newest), so one edge suffices — long iterative chains stay
            # O(N) edges, not O(N^2).
            same_program_covered = any(h.program is program for h in deps)
            for h in reversed(self._inflight):
                if h in deps:
                    continue
                if h.program is program:
                    if same_program_covered:
                        continue
                    same_program_covered = True
                    deps.append(h)
                elif id(h.program) in linked or conflicts(reads, writes, h):
                    deps.append(h)
            handle = RunHandle(program, scheduler.clone(), len(targets),
                               introspector=Introspector(sink=_trace_execute),
                               deps=deps, epilogue=epilogue, targets=targets)
            tr = tracer()
            if tr.enabled:
                tr.instant("submit", track="runtime", kernel=program.label,
                           deps=len(deps))
            errs = program.validate()
            if errs:
                handle._fail(errs)
                return handle
            self.executor.submit_batch([
                (g, (lambda g=g, h=handle: self._process(g, h)), handle._worker_finished)
                for g in targets
            ])
            self._inflight.append(handle)
        return handle

    def shutdown(self) -> None:
        self.executor.shutdown()

    # --------------------------------------------------------------- workers
    def _await_deps(self, handle: RunHandle) -> bool:
        """Block this worker until every predecessor run completed; returns
        False (poisoning the handle) when any predecessor failed.  Safe from
        deadlock: dependencies always precede their dependents in every
        group's FIFO queue (submit order), and cross-group progress is
        independent."""
        ok = True
        for dep in handle.deps:
            dep._done.wait()
            if dep.has_errors():
                ok = False
        if not ok:
            handle._poison()
        return ok

    def _process(self, group: DeviceGroup, handle: RunHandle) -> None:
        """Paper's Device thread body: pull → enqueue (async) → complete →
        write, against this run's scheduler/introspector/error list."""
        prog, sched = handle.program, handle.scheduler
        tr = tracer()
        track = f"group/{group.name}"
        dep_span = tr.enabled and bool(handle.deps)
        if dep_span:
            tr.begin("dep_wait", track=track, kernel=prog.label,
                     deps=len(handle.deps))
        ok = self._await_deps(handle)
        if dep_span:
            tr.end("dep_wait", track=track)
        if not ok:
            return
        handle._mark_started()
        handle._ensure_prepared(handle.targets or self.groups)
        # Per-run transfer accounting: runs on one group serialize on its
        # worker thread, so the cumulative-counter delta around this run is
        # exactly what this run caused on this group.
        xfer0, hits0 = group.n_transfers, group.n_cache_hits
        pending: list = []  # (offset, size, result, t_enqueue, capture wait)
        try:
            while True:
                pkg = sched.next_package(group)
                if pkg is not None:
                    off, size = pkg
                    t_enq, wait0 = time.perf_counter(), group.capture_wait_s
                    res = group.execute_chunk(prog, off, size)  # async: (results, event)
                    # Waiting for another group's graph capture is not this
                    # group's service time.
                    wait = group.capture_wait_s - wait0
                    if tr.enabled:
                        # Host-side dispatch cost only: the device compute is
                        # still in flight — it becomes the "execute" span.
                        tr.complete("dispatch", t_enq, time.perf_counter(),
                                    track=track, kernel=prog.label,
                                    offset=off, size=size)
                    pending.append((off, size, res, t_enq, wait))
                if pkg is None and not pending:
                    break
                # Block on the oldest package once the pipeline is full (or
                # the stream ended) — transfers/compute of newer packages
                # overlap with this wait.
                if pending and (len(pending) >= self.pipeline_depth or pkg is None):
                    off, size, (res, event), t_enq, wait = pending.pop(0)
                    group.wait(event)  # async: service time to completion
                    t_dev = time.perf_counter()
                    cost = prog.cost_fn(off, size) if prog.cost_fn else None
                    group.simulate_service_time(size, t_dev - t_enq, cost)
                    t_end = time.perf_counter()
                    # Device service time (plus simulated padding), measured
                    # ONCE — host write-back below must not inflate what
                    # adaptive raters (HGuided/ThroughputRater) observe.
                    service = t_end - t_enq - wait
                    self._write_back(group, handle, off, size, res)
                    if tr.enabled:
                        tr.complete("write_back", t_end, time.perf_counter(),
                                    track=track, kernel=prog.label,
                                    offset=off, size=size)
                    handle.introspector.record(
                        PackageRecord(group.name, off, size, t_enq, t_enq, t_end)
                    )
                    sched.observe(group, size, service)
        except BaseException:  # noqa: BLE001 — surfaced via RunHandle error
            # API.  BaseException, not Exception: a KeyboardInterrupt/
            # SystemExit escaping from kernel code must still be recorded
            # (else the handle completes "successfully" with zeroed outputs)
            # and must not kill the resident worker thread.
            handle.record_error(f"{group.name}: {traceback.format_exc()}")
        finally:
            dx = group.n_transfers - xfer0
            dh = group.n_cache_hits - hits0
            handle.introspector.record_counters(group.name, dx, dh)
            if tr.enabled and (dx or dh):
                tr.instant("transfers", track=track, kernel=prog.label,
                           transfers=dx, cache_hits=dh)

    def _write_back(self, group: DeviceGroup, handle: RunHandle,
                    off: int, size: int, res) -> None:
        """Host write-back + device-resident handoff: the produced device
        slices are stashed in this group's transfer cache under the run's
        write version, so a dependent run reading the same elements on the
        same group skips the host re-read and the upload."""
        prog = handle.program
        results = res if isinstance(res, (tuple, list)) else (res,)
        with group.stream_context():
            prog.write_outputs(off, size, results, bump=False)
        for b, r in zip(prog._outs, results):
            group.stash_output(prog, b, off, size, r, handle.version_for_write(b))
