"""Tier-1 ``EngineCL`` facade over the persistent runtime.

Mirrors the paper's API (§6) on PyTorch:

    engine = EngineCL()
    engine.use(DeviceMask.ALL)                      # or explicit DeviceGroups
    engine.scheduler(HGuided(k=2))
    program = Program().in_(x).out(y).kernel(fn)
    engine.program(program)
    engine.run()                                    # co-executes on all groups

    handle = engine.submit(other_program)           # async: Future-based API
    handle.result()                                 # outputs, or raises

Since the persistent-runtime refactor (see DESIGN.md) the engine no longer
spawns threads per run: a resident ``Runtime`` owns one long-lived
dispatcher thread per ``DeviceGroup``, fed by a run queue.  ``run()`` keeps
its exact blocking semantics (submit + wait), while ``submit()`` returns a
``RunHandle`` (``.result()``, ``.done()``, ``.metrics``) so several Programs
can be in flight.  Per-run state — scheduler bookkeeping (cloned), error
list, introspector — lives on the handle, so concurrent runs can't clobber
each other.  Host→device transfers go through the per-group transfer cache
(``DeviceGroup._input_slice``), which iterative and serving workloads hit
instead of re-transferring unchanged buffers.

Port of the JAX package's ``core/engine.py``.  ``discover`` enumerates
torch devices instead of JAX platforms: the host CPU is one group
(``cpu:0``) and every CUDA card one more (``cuda:i``), so an H100 node
gives the paper's own setting, a CPU and a GPU co-executing one program.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import torch

from repro_torch.core.device import DeviceGroup
from repro_torch.core.introspector import Introspector
from repro_torch.core.program import Program
from repro_torch.core.runtime import RunHandle, Runtime, conflicts
from repro_torch.core.scheduler.base import Scheduler
from repro_torch.core.scheduler.static import Static


class DeviceMask(enum.Flag):
    CPU = enum.auto()
    GPU = enum.auto()
    TPU = enum.auto()
    ALL = CPU | GPU | TPU


# torch device types per mask bit.  A TPU has no torch device: the bit
# selects nothing here.
_MASK_TYPES = {
    DeviceMask.CPU: ("cpu",),
    DeviceMask.GPU: ("cuda",),
    DeviceMask.TPU: (),
}


def torch_devices() -> List[torch.device]:
    """The machine's devices: the host CPU, then every visible CUDA card."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cpu")] + [torch.device("cuda", i) for i in range(cards)]


def discover(mask: DeviceMask = DeviceMask.ALL, devices=None) -> List[DeviceGroup]:
    """Platform/device discovery (paper challenge 1) — one group per device:
    ``DeviceGroup("cpu:0", "cpu")`` for the host CPU and
    ``DeviceGroup("cuda:i", "cuda:i")`` for each card (DeviceMask.TPU
    selects none).

    ``devices`` overrides :func:`torch_devices` (tests inject fakes: any
    objects with a torch device's ``type`` and ``index``)."""
    wanted = tuple(t for flag, types in _MASK_TYPES.items() if flag in mask for t in types)
    groups = []
    for d in devices if devices is not None else torch_devices():
        if d.type in wanted:
            i = d.index or 0
            groups.append(DeviceGroup(f"{d.type}:{i}", "cpu" if d.type == "cpu" else f"cuda:{i}"))
    return groups


class EngineCL:
    def __init__(self) -> None:
        self._groups: List[DeviceGroup] = []
        self._scheduler: Scheduler = Static()
        self._program: Optional[Program] = None
        self._engine_errors: List[str] = []  # pre-submit errors (no handle yet)
        self._gws: Optional[int] = None
        self._lws: Optional[int] = None
        self._pipeline_depth = 2  # packages enqueued ahead per device
        self._runtime: Optional[Runtime] = None
        self._runtime_sig: tuple = ()
        self._last_handle: Optional[RunHandle] = None
        self._idle_introspector = Introspector()  # before the first run

    # ----------------------------------------------------------- Tier-1 API
    def use(self, *what) -> "EngineCL":
        """DeviceMask, DeviceGroup(s), or a Program."""
        for w in what:
            if isinstance(w, DeviceMask):
                self._groups.extend(discover(w))
            elif isinstance(w, DeviceGroup):
                self._groups.append(w)
            elif isinstance(w, Program):
                self._program = w
            else:
                raise TypeError(f"cannot use({w!r})")
        return self

    def program(self, program: Program) -> "EngineCL":
        self._program = program
        return self

    def scheduler(self, sched: Scheduler) -> "EngineCL":
        self._scheduler = sched
        return self

    def global_work_items(self, gws: int) -> "EngineCL":
        self._gws = gws
        return self

    def local_work_items(self, lws: int) -> "EngineCL":
        self._lws = lws
        return self

    def work_items(self, gws: int, lws: int = 1) -> "EngineCL":
        self._gws, self._lws = gws, lws
        return self

    @property
    def introspector(self) -> Introspector:
        """The most recent run's introspector (per-run since the refactor)."""
        if self._last_handle is not None:
            return self._last_handle.introspector
        return self._idle_introspector

    # ------------------------------------------------------------ lifecycle
    def _ensure_runtime(self) -> Runtime:
        if not self._groups:
            self._groups = discover(DeviceMask.ALL)
        sig = tuple(id(g) for g in self._groups)
        # Safe to call after shutdown() — including a shutdown issued on the
        # Runtime directly: a dead executor is replaced, never submitted to.
        if (self._runtime is None or self._runtime_sig != sig
                or not self._runtime.alive):
            if self._runtime is not None:
                self._runtime.shutdown()
            self._runtime = Runtime(self._groups, pipeline_depth=self._pipeline_depth)
            self._runtime_sig = sig
        return self._runtime

    def shutdown(self) -> None:
        """Stop the resident workers (daemon threads; optional to call)."""
        if self._runtime is not None:
            self._runtime.shutdown()
            self._runtime = None
            self._runtime_sig = ()

    def __enter__(self) -> "EngineCL":
        return self

    def __exit__(self, *exc) -> None:
        runtime = self._runtime
        self.shutdown()
        if runtime is not None:
            # Joined: a process that exits while a worker still unwinds
            # from torch work can abort in the interpreter's teardown.
            runtime.executor.shutdown(wait=True)

    # ------------------------------------------------------------ async API
    def submit(self, program: Optional[Program] = None, *,
               after=None, epilogue=None) -> RunHandle:
        """Enqueue a run on the persistent workers; non-blocking.

        Multiple Programs may be in flight; each handle carries its own
        errors/metrics.  Runs are ordered by the run graph: explicit
        ``after=`` handles, ``Program.reads_from`` links, and conflicts
        inferred from shared host buffers against in-flight runs — the
        dependency wait happens on the worker threads, never here.  Note
        that inference only sees runs still in flight: when ordering against
        a run that may complete (or fail) before this submit lands, pass its
        handle via ``after=`` so failure poisoning stays deterministic."""
        prog = program if program is not None else self._program
        if prog is None:
            raise ValueError("no program set")
        if self._gws is not None:
            prog.gws = self._gws
        if self._lws is not None:
            prog.lws = self._lws
        handle = self._ensure_runtime().submit(
            prog, self._scheduler, after=after, epilogue=epilogue
        )
        # The newest run supersedes stale engine-level error state; the
        # engine's error API now tracks this (possibly in-flight) handle.
        self._engine_errors = []
        self._last_handle = handle
        return handle

    # ------------------------------------------------------------- run loop
    def run(self) -> "EngineCL":
        """Blocking run of the current program (tier-1 semantics unchanged)."""
        if self._program is None:
            self._engine_errors = ["no program set"]
            self._last_handle = None
            return self
        self.submit().wait()
        return self

    # ---- paper §10, implemented: multi-kernel & iterative dataflow ------
    def submit_pipeline(self, *programs: Program) -> List[RunHandle]:
        """Submit several linked Programs as one dependency chain;
        non-blocking — returns every stage's handle immediately.

        Stages share host buffers by construction (pass one program's out
        array as the next one's in_) — the paper's 'linked buffers' idea.
        Dependencies between the stages are computed here, statically, from
        the declared buffer sets (plus ``reads_from`` links) and passed as
        explicit ``after=`` edges: ordering and failure poisoning are
        deterministic even when an early stage fails before a later submit.
        Independent stages share no edge and pipeline freely across the
        groups' worker queues; the host never blocks between stages."""
        handles: List[RunHandle] = []
        for p in programs:
            reads = frozenset(map(id, p._ins))
            writes = frozenset(map(id, p._outs))
            linked = set(map(id, p._linked))
            after = [
                h for h in handles
                if h.program is p or id(h.program) in linked
                or conflicts(reads, writes, h)
            ]
            handles.append(self.submit(p, after=after))
        return handles

    def run_pipeline(self, *programs: Program) -> "EngineCL":
        """Blocking multi-kernel execution: ``submit_pipeline`` + wait.

        Unlike the pre-dataflow engine this does not host-block between
        dependent runs — each group's worker starts its part of stage N+1
        the moment stage N is safe for it, and intermediate buffers hand
        off device-resident through the transfer cache."""
        handles = self.submit_pipeline(*programs)
        for h in handles:
            h.wait()
        if handles:
            # Engine-level error API covers the whole chain: errors of every
            # stage but the last (the last is _last_handle, already read by
            # get_errors); poisoned stages carry their upstream cause.
            self._engine_errors = [e for h in handles[:-1] for e in h.errors()]
        return self

    def submit_iterative(self, n_iters: int,
                         swap: Optional[Sequence[tuple]] = None) -> List[RunHandle]:
        """Submit ``n_iters`` runs of the current program as a dependency
        chain; non-blocking.  ``swap`` pairs are ping-ponged *on the worker*
        (each run's epilogue) the moment that run completes — not on the
        host — so iteration N+1 starts without a host round-trip and the
        just-produced outputs hand off device-resident."""
        prog = self._program
        if prog is None:
            raise ValueError("no program set")
        swap = tuple(swap) if swap else ()

        def epilogue(p=prog, sw=swap):
            for i_in, i_out in sw:
                p.swap_buffers(i_in, i_out)

        handles: List[RunHandle] = []
        for _ in range(n_iters):
            handles.append(self.submit(
                prog,
                after=handles[-1:],  # same program: always a chain
                epilogue=epilogue if swap else None,
            ))
        return handles

    def run_iterative(self, n_iters: int, swap: Optional[Sequence[tuple]] = None) -> "EngineCL":
        """Iterative kernels (e.g. NBody steps): blocking
        ``submit_iterative`` + wait.  ``swap`` lists (in_index, out_index)
        buffer pairs ping-ponged between iterations.  Swapped-in outputs are
        served from the per-group transfer cache (device-resident handoff);
        unswapped inputs stay cached too, so iterations re-transfer only
        what actually changed."""
        if self._program is None:
            self._engine_errors = ["no program set"]
            return self
        handles = self.submit_iterative(n_iters, swap)
        for h in handles:
            h.wait()
        if handles:
            self._engine_errors = [e for h in handles[:-1] for e in h.errors()]
        return self

    # --------------------------------------------------------------- errors
    def has_errors(self) -> bool:
        if self._engine_errors:
            return True
        return self._last_handle is not None and self._last_handle.has_errors()

    def get_errors(self) -> List[str]:
        errs = list(self._engine_errors)
        if self._last_handle is not None:
            errs.extend(self._last_handle.errors())
        return errs
