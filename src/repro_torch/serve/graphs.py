"""CUDA graphs: the port's counterpart of what the JAX package jits.

The JAX package never dispatches a step from Python: one-shot generate jits
its prefill and its chain (``jax.jit(chain, static_argnums=(4,))``), every
server segment kernel is a ``lax.scan`` (its chunk stage behind a
``lax.cond``) that its DeviceGroup compiles once per group, and a
DeviceGroup jits every Program kernel it runs (``compile_kernel``: the
server's prefill waves, co-execution's packages).  Here the same work is
captured once per shape in a CUDA graph and replayed.  A graph launches the
kernels that the eager code launches, in the same order on the same
shapes, so every stream keeps its bits; the host makes one replay where it
made every launch of every layer of every step.

:class:`GraphCache` holds the captured loops of one owner (a one-shot
generate's prefill and chain, a server's ``ModelKernels``, a DeviceGroup's
compiled kernels), keyed by the loop's name,
step count and static ints, the shapes and dtypes of its inputs, their
device, its scope, and the identity of the weights the graph reads by
address (``consts``, which the entry keeps alive).  Never by an input's
address: a fresh cache of a captured shape replays, as a jitted function is
not recompiled for new buffers.

A loop reads and writes static buffers, one per input, shared by role and
shape among the loops of one scope (a speculative segment and its bypass
share one set).  A scope is the state's owner: a server's loops take their
batch's bucket and the DeviceGroup that runs the package, so two batches
live at once (two buckets, two groups' members of one bucket, on streams of
one card) never share a cache buffer, even where their shapes agree (a
paged pool's do whenever its block count is fixed).  Binding a loop to its
inputs copies in only the inputs whose
storage is not already the static buffer, and the loop hands back the
static buffers: a caller that feeds them back next time (the paged pool,
through the runtime's donated handoff; one-shot generate's cache, which
prefill writes in place) copies nothing.  A replay's outputs are the
graph's own tensors, overwritten by its next replay.

A loop body takes its step count: ``body(statics, n)``.  Capture runs it
first for one step, as a warm-up (library loads, shared-memory opt-ins, the
TMA encoder's entry point, the weights' cast to the compute dtype: every
step launches the same kernels, so one step takes them all), with its
launches counted nowhere, and then records it for its real count on the
inputs' device, on a side stream, as :class:`Segments`: after a device
synchronize and the allocator's ``empty_cache`` (as ``torch.cuda.graph``
enters), one CUDA graph per stretch between two of a mesh's collectives,
all drawing on one private memory pool.  A collective that the body
issues while the recording is open is not run: it ends the current graph,
becomes a node that issues it eagerly on the tensors the capture saw (the
in-place tensor of an ``all_reduce``, the ``parts`` of an ``all_gather``,
made once), and the next graph begins (``launch/mesh.py``).  A replay runs
graph 0, node 0, graph 1, ... in the order of the capture, each node
counted in ``Mesh.stats`` as the eager body counts its collective; a body
with no collective records one graph.  The nodes are issued under gloo;
under NCCL only a recording with no collective (a world of one) has run
on a card.  A body run under a mesh records in CUDA's
``relaxed`` capture mode, since a backward's collective reaches its
boundary on the autograd engine's thread, which must then end the graph
that the capturing thread began; every other body records in
``thread_local`` mode.  The wrappers' counts go to a recording
(``kernels/_build.py``) that follows the capturing stream, so that a
backward's launches from the autograd engine's thread are counted too,
one tally for every stretch; each replay adds that tally to the launch
counts.  A cache made with ``pool_per_scope=True`` gives every capture of
one scope one pool, which bounds its memory over many shapes (the
HeteroTrainer's share sizes) and is safe only where each replay's outputs
are copied out before the scope's next replay.  ``warmup=False`` skips
the warm-up: for a body whose
caller has just run it eagerly on the real state (the train step, whose
warm-up would be an extra, uncounted optimizer step).  The warm-up writes the
static buffers, so an owner captures a scope's loops before the scope's
first bind (a gated server captures the speculative scan and its bypass
together, a chunked one its loop with and without the chunk stage;
one-shot generate its prefill and chain per (batch, prompt, gen)); a
capture over buffers that already hold a caller's state (a public chain
called again at a new step count over the cache it returned) warms up on
clones of them instead, which costs their size in memory
(``warmup_clone_bytes``).  A replay runs on the
current stream: the DeviceGroup's under the runtime.  While the span
tracer is on, each replay is logged with its copy-ins and timed by CUDA
events (:meth:`GraphCache.stats`).  One capture (warm-up and recording)
runs at a time in the process; other threads keep launching on their own
streams meanwhile, and a capture's wait for another's is counted apart
(``wait_s``), so that a DeviceGroup's scheduler does not take it for the
group's work.

A body need not be a step loop: one-shot generate's prefill
(``serve/step.py``) and a DeviceGroup's compiled Program kernels
(:func:`compiled`, the counterpart of the reference's
``DeviceGroup.compile_kernel``: the server's prefill waves, co-execution's
packages) take one step.

The loops of one scope run one at a time (a batch's segments do); loops of
two scopes may run at once, each on its group's worker thread and stream
(two groups' members of one server), and bind and replay without waiting
for each other; only their captures take turns.  CPU
tensors run the loop eagerly, as every kernel runs its plain version there.
On CUDA tensors a failed capture or replay raises: there is no eager
fallback.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable

import torch

from repro_torch.core.device import running_group
from repro_torch.core.trace import tracer
from repro_torch.distributed.sharding import current_mesh
from repro_torch.kernels import _build
from repro_torch.launch import mesh as _mesh
from repro_torch.models.params import tree_leaves


# One capture at a time in the process: a recording synchronizes the
# whole device and empties the allocator's cache on entry, which must not
# happen under another thread's capture (two DeviceGroups of one card).
# The warm-up is inside too: two threads' eager warm-ups only contend for
# the interpreter lock, so the first capture ends sooner taken alone.
# Reentrant, so that a capture nested in a capture raises CUDA's error
# instead of waiting on itself.
_CAPTURE_LOCK = threading.RLock()


def _items(inputs: dict):
    """(role, index, tensor) of each input; a role holds a tensor (index
    None) or a list of tensors."""
    for role, v in inputs.items():
        if isinstance(v, (list, tuple)):
            for i, t in enumerate(v):
                yield role, i, t
        else:
            yield role, None, v


def _rebuild(inputs: dict, fn) -> dict:
    return {role: [fn(role, i, t) for i, t in enumerate(v)] if isinstance(v, (list, tuple))
            else fn(role, None, v) for role, v in inputs.items()}


def same_storage(x: torch.Tensor, s: torch.Tensor) -> bool:
    """Whether ``x`` is the buffer ``s`` itself (no copy needed)."""
    return (x.data_ptr() == s.data_ptr() and x.dtype == s.dtype
            and tuple(x.shape) == tuple(s.shape) and x.stride() == s.stride())


class Loop:
    """A loop bound to its inputs.  ``statics`` holds the buffers it reads
    and writes, by role (a graph's static buffers; on the eager path the
    inputs themselves, made contiguous); ``loop()`` runs it and returns its
    outputs."""

    def __init__(self, statics: dict, run: Callable) -> None:
        self.statics = statics
        self._run = run

    def __call__(self):
        return self._run()


def bind(graphs, name: str, steps: int, ints: tuple, inputs: dict, body: Callable,
         consts: tuple = (), scope=None) -> Loop:
    """``body(statics, steps) -> outputs`` bound to ``inputs``: captured
    and replayed through ``graphs`` where it takes the inputs' device, run
    eagerly when ``graphs`` is None or the inputs lie on the CPU."""
    dev = next(_items(inputs))[2].device
    if graphs is None or not graphs.accepts(dev):
        statics = _rebuild(inputs, lambda r, i, t: t.contiguous())
        return Loop(statics, lambda: body(statics, steps))
    return graphs.bind(name, steps, ints, inputs, body, consts, scope)


class Segments:
    """A loop recorded as CUDA graphs split at a mesh's collectives: a
    graph per stretch between two collectives, every one drawing on the
    private memory ``pool``, and between graphs i and i + 1 node i, the
    collective that the capture reached there, kept to be issued eagerly
    on the tensors the capture saw (``launch/mesh.py``).  A body that
    issues no collective records one graph.  :meth:`replay` runs graph 0,
    node 0, graph 1, ... in the order of the capture, on the current
    stream, so the launches, their order and shapes, and the collectives
    in number and bytes are the eager body's.

    While the recording is open (``with``), the collectives issued on the
    capturing ``stream`` (:func:`launch.mesh.recording_on`) come here; a
    boundary may be reached on the autograd engine's thread (a backward's
    collective), which ends the graph that another thread began: CUDA
    allows that in the ``relaxed`` capture mode only, which mesh
    recordings take (``GraphCache._record``)."""

    def __init__(self, stream, pool, mode: str) -> None:
        self.stream, self.pool, self.mode = stream, pool, mode
        self.graphs: list = []
        self.nodes: list = []
        self.key = stream.cuda_stream if stream is not None else None

    @property
    def stretches(self) -> int:
        return len(self.graphs)

    @property
    def collectives(self) -> int:
        return len(self.nodes)

    @staticmethod
    def _new_graph():
        return torch.cuda.CUDAGraph()

    def _begin(self) -> None:
        graph = self._new_graph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode=self.mode)
        self.graphs.append(graph)

    def _end(self) -> None:
        with torch.cuda.stream(self.stream):
            self.graphs[-1].capture_end()

    def boundary(self, collective: Callable[[], None]) -> None:
        """End the current graph, keep ``collective`` as the next node and
        begin the next graph."""
        self._end()
        self.nodes.append(collective)
        self._begin()

    def __enter__(self) -> "Segments":
        if self.key in _mesh.RECORDINGS:
            raise RuntimeError("a segmented recording is already open on this stream")
        # The capturing stream stays current on this thread for the whole
        # recording (the autograd engine's thread takes it from the forward).
        self._stream_ctx = torch.cuda.stream(self.stream)
        self._stream_ctx.__enter__()
        try:
            self._begin()
        except BaseException:
            self._stream_ctx.__exit__(None, None, None)
            raise
        _mesh.RECORDINGS[self.key] = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _mesh.RECORDINGS.pop(self.key, None)
        try:
            self._end()
        except Exception:
            if exc_type is None:
                raise
        finally:
            self._stream_ctx.__exit__(None, None, None)
        return False

    def replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.nodes):
                self.nodes[i]()


class _Entry:
    __slots__ = ("graph", "outputs", "tally", "consts")


class GraphCache:
    """The captured loops of one owner and their static buffers.  Counters:
    ``captures``, ``capture_s`` (all of capturing) and its phases:
    ``wait_s`` (waiting for another thread's capture to end),
    ``warmup_s`` (the uncounted warm-up step), ``begin_s`` (a device
    synchronize, the allocator's ``empty_cache``, the first capture's
    start), ``record_s`` (running the loop under capture, with every
    boundary's end, instantiation and begin between its stretches) and
    ``instantiate_s`` (ending the last capture, which instantiates its
    graph), in total and per loop name (``loops``, which also gives one
    replay's ``stretches`` and ``collectives``, of its latest capture);
    ``warmup_clone_bytes`` (buffers cloned because a capture found them
    holding a caller's state), ``replays``, ``copy_ins`` and
    ``copy_in_bytes`` (inputs copied into static buffers),
    ``output_copies`` and ``output_copy_bytes`` (a replay's outputs
    copied out of the graph's memory: a compiled kernel's, :func:`compiled`,
    and a server segment loop's), and
    ``log``, one ``(loop, copy-ins, bytes, events)`` per replay made while
    the span tracer is on, the events (CUDA events recorded around the
    replay on the card, else None) giving its device time in
    :meth:`stats`."""

    PHASES = ("wait_s", "warmup_s", "begin_s", "record_s", "instantiate_s")

    def __init__(self, *, pool_per_scope: bool = False) -> None:
        # pool_per_scope: every capture of one scope draws on one private
        # pool (else each recording has its own).  Only for an owner that
        # copies each replay's outputs out before the scope's next replay.
        self.pool_per_scope = pool_per_scope
        self._pools: dict = {}
        self._capture_pool = None
        self._entries: dict = {}
        self._buffers: dict = {}
        self._live: set = set()  # buffers whose content a caller relies on
        self._streams: dict = {}
        self._lock = threading.Lock()
        self.captures = 0
        self.capture_s = 0.0
        self.wait_s = 0.0
        self.loops: dict = {}  # name -> captures and seconds of each phase
        self.warmup_clone_bytes = 0
        self.replays = 0
        self.copy_ins = 0
        self.copy_in_bytes = 0
        self.output_copies = 0
        self.output_copy_bytes = 0
        self.log: collections.deque = collections.deque(maxlen=4096)

    @staticmethod
    def accepts(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def key(name: str, steps: int, ints: tuple, inputs: dict, consts: tuple = (),
            scope=None) -> tuple:
        """The cache key of loop ``name``: its step count and static ints,
        each input's role, shape and dtype, the device, the scope, and the
        identity of each leaf of ``consts`` (the weights).  No input's
        address."""
        items = list(_items(inputs))
        devices = {t.device for _, _, t in items}
        if len(devices) != 1:
            raise ValueError(f"loop {name!r} takes inputs on one device, got {devices}")
        metas = tuple((r, i, tuple(t.shape), t.dtype) for r, i, t in items)
        return (name, steps, tuple(ints), metas, str(devices.pop()), scope,
                tuple(id(leaf) for c in consts for leaf in tree_leaves(c)))

    def statics(self, likes: dict, device=None, scope=None) -> dict:
        """The static buffers of ``scope`` for inputs shaped like ``likes``
        (meta tensors will do, with ``device``), by role: made zero-filled
        on first use (a warm-up then reads valid block tables and
        positions) and shared by every loop of this cache and scope that
        takes that role at that shape."""
        def get(role, i, t):
            dev = torch.device(device) if device is not None else t.device
            k = (scope, role, i, tuple(t.shape), t.dtype, str(dev))
            buf = self._buffers.get(k)
            if buf is None:
                buf = self._buffers[k] = torch.zeros(t.shape, dtype=t.dtype, device=dev)
            return buf
        return _rebuild(likes, get)

    def capture(self, name: str, steps: int, ints: tuple, inputs: dict, body: Callable,
                consts: tuple = (), scope=None, warmup: bool = True):
        """The entry of loop ``name`` on inputs shaped like ``inputs``,
        captured now if this cache has none, and its static buffers."""
        key = self.key(name, steps, ints, inputs, consts, scope)
        with self._lock:
            statics = self.statics(inputs, scope=scope)
            entry = self._entries.get(key)
        if entry is None:
            # Outside the cache's lock: another group's thread binds its
            # own scope's loops meanwhile, and waits only for the capture
            # lock when it captures too.
            entry = self._capture(name, key, statics, body, steps, consts, warmup, scope)
        return entry, statics

    def bind(self, name: str, steps: int, ints: tuple, inputs: dict, body: Callable,
             consts: tuple = (), scope=None, warmup: bool = True) -> Loop:
        """Loop ``name`` bound to ``inputs``: captured if new, each input
        copied into its static buffer unless it is that buffer."""
        entry, statics = self.capture(name, steps, ints, inputs, body, consts, scope, warmup)
        n = nbytes = 0
        for (_, _, x), (_, _, s) in zip(_items(inputs), _items(statics)):
            self._live.add(id(s))
            if not same_storage(x, s):
                s.copy_(x)
                n += 1
                nbytes += x.numel() * x.element_size()
        with self._lock:
            self.copy_ins += n
            self.copy_in_bytes += nbytes

        dev = next(_items(statics))[2].device

        def run():
            logged, events = tracer().enabled, None
            if logged and dev.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            entry.graph.replay()
            if events is not None:
                events[1].record()
            entry.tally.replayed()
            with self._lock:
                self.replays += 1
                if logged:
                    self.log.append((name, n, nbytes, events))
            return entry.outputs

        return Loop(statics, run)

    def copy_out(self, outputs) -> tuple:
        """Copies of a replay's ``outputs`` out of the graph's memory, on
        the current stream (the next replay overwrites the graph's own
        tensors), counted in ``output_copies`` and ``output_copy_bytes``."""
        copies = tuple(o.clone() for o in outputs)
        with self._lock:
            self.output_copies += len(copies)
            self.output_copy_bytes += sum(o.numel() * o.element_size() for o in copies)
        return copies

    def _capture(self, name: str, key: tuple, statics: dict, body: Callable, steps: int,
                 consts: tuple, warmup: bool = True, scope=None) -> _Entry:
        phases = dict.fromkeys(self.PHASES, 0.0)
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            t1 = time.perf_counter()
            with self._lock:
                entry = self._entries.get(key)
            if entry is not None:  # captured by another thread meanwhile
                return entry

            def scratch(role, i, s):
                if id(s) not in self._live:
                    return s
                self.warmup_clone_bytes += s.numel() * s.element_size()
                return s.clone()

            dev = next(_items(statics))[2].device
            if warmup:
                warm = _rebuild(statics, scratch)
                # The warm-up's launches count nowhere.
                with _build.recording(torch.cuda.current_stream(dev)
                                      if dev.type == "cuda" else None):
                    body(warm, 1)
                del warm
            phases["warmup_s"] = time.perf_counter() - t1
            if self.pool_per_scope:
                if scope not in self._pools:
                    self._pools[scope] = torch.cuda.graph_pool_handle()
                self._capture_pool = self._pools[scope]
            try:
                # One tally for every stretch: they all capture on one stream.
                with _build.recording(self._stream(dev)) as tally:
                    graph, outputs, timed = self._record(statics, lambda st: body(st, steps))
            finally:
                self._capture_pool = None
            phases.update(timed)
            phases["wait_s"] = t1 - t0  # another thread's capture ahead of this one
            entry = _Entry()
            entry.graph, entry.outputs, entry.tally, entry.consts = graph, outputs, tally, consts
            with self._lock:
                self._entries[key] = entry
                self.wait_s += phases["wait_s"]
                self.captures += 1
                self.capture_s += time.perf_counter() - t0
                loop = self.loops.setdefault(name, dict(captures=0,
                                                        **dict.fromkeys(self.PHASES, 0.0)))
                loop["captures"] += 1
                # One replay's graphs and collectives, of the latest capture.
                loop["stretches"] = getattr(graph, "stretches", 1)
                loop["collectives"] = getattr(graph, "collectives", 0)
                for k, v in phases.items():
                    loop[k] += v
        group = running_group()
        if group is not None and group.graphs is not self:
            # The wait of a group's package for another thread's capture
            # of a loop outside the group's own cache (a server's segment
            # loops): not the group's work either.
            group.loop_wait_s += phases["wait_s"]
        return entry

    def _stream(self, dev: torch.device):
        """The side stream this cache captures on for ``dev`` (None off
        the card)."""
        if dev.type != "cuda":
            return None
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        return stream

    def _record(self, statics: dict, run: Callable):
        """Record ``run(statics)`` on the buffers' device as
        :class:`Segments` (one CUDA graph where the body issues no
        collective): (the recording, its outputs, the seconds of each
        recording phase)."""
        dev = next(_items(statics))[2].device
        with torch.cuda.device(dev):
            t0 = time.perf_counter()
            # As torch.cuda.graph enters: the card idle and the allocator's
            # cached blocks returned before the private pool is drawn.
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            # A backward's collective ends a graph on the autograd engine's
            # thread, which only the relaxed mode allows.  A step has such
            # collectives only under tensor or expert parallelism, whose
            # model code reads the thread's current mesh.
            rec = Segments(self._stream(dev), self._capture_pool or torch.cuda.graph_pool_handle(),
                           "relaxed" if current_mesh() is not None else "thread_local")
            with rec:
                t1 = time.perf_counter()
                outputs = run(statics)
                t2 = time.perf_counter()
            t3 = time.perf_counter()  # the last capture_end instantiates
        return rec, outputs, {"begin_s": t1 - t0, "record_s": t2 - t1,
                              "instantiate_s": t3 - t2}

    def stats(self) -> dict:
        totals = {k: sum(loop[k] for loop in self.loops.values()) for k in self.PHASES}
        return {"captures": self.captures, "capture_s": self.capture_s, **totals,
                "loops": {name: dict(loop) for name, loop in self.loops.items()},
                "warmup_clone_bytes": self.warmup_clone_bytes, "replays": self.replays,
                "copy_ins": self.copy_ins, "copy_in_bytes": self.copy_in_bytes,
                "output_copies": self.output_copies,
                "output_copy_bytes": self.output_copy_bytes,
                "static_bytes": sum(b.numel() * b.element_size()
                                    for b in self._buffers.values()),
                "per_replay": [[name, n, nbytes, _elapsed_ms(ev)]
                               for name, n, nbytes, ev in self.log]}


def passthrough(fn: Callable) -> Callable:
    """Mark a Program kernel that :meth:`DeviceGroup.compile_kernel` hands
    over as it is, never capturing it: one that binds graphs of its own (a
    server's segment kernels: a capture never nests in another), or one
    whose owner asked for eager loops (``graph=False``)."""
    fn.graph_passthrough = True
    return fn


# A Program's scalar argument reaches a compiled kernel as a 0-dim device
# tensor of this dtype, as the reference's jit traces it (a Python float
# as a weakly typed float32).
_SCALAR_DTYPES = ((bool, torch.bool), (int, torch.int64), (float, torch.float32))


def _device_arg(a, device, name: str):
    """Program argument ``a`` as a compiled kernel's input: a Python scalar
    as a 0-dim device tensor, copied in each call (one graph serves every
    value), a tensor on the group's device as it is."""
    for kind, dtype in _SCALAR_DTYPES:
        if isinstance(a, kind):
            return torch.full((), a, dtype=dtype, device=device)
    dev = torch.device(device)
    if isinstance(a, torch.Tensor) and a.device.type == dev.type and (
            dev.index is None or a.device.index == dev.index):
        return a
    raise TypeError(f"kernel {name!r}: a compiled kernel takes Program arguments that are "
                    f"Python scalars or tensors on {device}, not {type(a).__name__}"
                    + (f" on {a.device}" if isinstance(a, torch.Tensor) else "")
                    + "; pass host data as a Program input, or mark the kernel "
                    "graphs.passthrough")


def compiled(graphs: GraphCache, fn: Callable, key: tuple, n_ins: int, device,
             name: str) -> Callable:
    """A DeviceGroup's callable for Program kernel ``fn`` (the reference's
    ``jax.jit(fn, donate_argnums=...)``, keyed by ``key``): ``(offset,
    *ins, *args) -> outputs`` replaying one graph of ``fn`` per package
    shape and argument types, captured at that shape's first package, each
    in a scope of its own.  As the reference's jit traces them, the package
    offset reaches ``fn`` as an int64 device scalar and each scalar
    argument as a device scalar of its type (:func:`_device_arg`), copied
    in each call: one graph serves every offset and every value.  So a
    compiled kernel reads them as values, never as shapes or Python
    conditions (the eager path, the CPU group's and a passthrough
    kernel's, hands it Python numbers).  The outputs are copied out of the
    graph's memory on the current stream (``output_copies``): the next
    replay overwrites the graph's own tensors, and a package's results
    outlive it, in the runtime's pipelined write-back and as a stashed
    handoff to a dependent run."""
    def run(offset, *rest):
        ins = list(rest[:n_ins])
        inputs = {"offset": torch.full((), int(offset), dtype=torch.int64, device=device),
                  "ins": ins, "args": [_device_arg(a, device, name) for a in rest[n_ins:]]}

        def body(st, n):
            out = fn(st["offset"], *st["ins"], *st["args"])
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)

        scope = (key, tuple((tuple(t.shape), t.dtype) for t in ins + inputs["args"]))
        copies = graphs.copy_out(graphs.bind(name, 1, (key,), inputs, body, (fn,), scope)())
        return copies if len(copies) != 1 else copies[0]

    return run


def _elapsed_ms(events):
    """A replay's device time from its events, once the card has run it
    (None before, or off the card)."""
    if events is None or not events[1].query():
        return None
    return events[0].elapsed_time(events[1])
