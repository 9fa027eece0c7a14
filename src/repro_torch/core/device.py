"""Tier-2 ``DeviceGroup``: the co-execution unit.

In the paper a Device wraps one OpenCL device and its command queue/thread.
Here a DeviceGroup wraps one ``torch.device`` plus scheduling metadata: a
relative compute ``power``, a rated ``watts``, a minimum package size and
an optional *specialized kernel* (the paper's per-device kernel
source/binary).  On a CUDA device the group owns one CUDA stream, its
command queue: every upload, kernel and write-back of the group's packages
runs on it.

``sim_time_per_wi`` emulates a slower device (the load-balancing tests and
benchmarks of the reference): after a package's real work the group idles
to match a device of the given time per work-item.  Real co-execution
across unlike devices (the CPU and a GPU from ``discover``) leaves it 0.

Port of the JAX package's ``core/device.py``.  The reference's
``compile_kernel``, a per-group ``jax.jit(fn, donate_argnums=...)``, is
here a CUDA graph of the kernel per package shape, captured at that
shape's first package and replayed on the group's stream
(:meth:`DeviceGroup.compile_kernel`, ``serve/graphs.py``); the CPU group
and kernels marked ``graphs.passthrough`` run eagerly.  A donated input is a device tensor the kernel may update in
place and hand back as its output.  The transfer cache (``(id, version, lo, hi, need)``
keys, ``stash_output`` handoffs, ``consume`` on donated inputs) and the
power-of-two package ``_bucket`` are the reference's, so package geometry
and transfer counts match it.

The default device is ``cuda:0``; a group asked for CUDA raises when CUDA
is missing.  Slot migration between a server's per-group batches patches
the rows it moved into the destination group's device-resident copy of a
mirror in place (:meth:`DeviceGroup.patch_cached`, on the group's stream).
While a group runs a package's kernel, :func:`running_group` names it on
that thread: a server's segment kernels scope their graphs' static buffers
by it, so that two groups of one card never share a cache buffer.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch

from repro_torch.core.program import buffer_version
from repro_torch.core.trace import tracer

# The group whose package kernel this thread is running (each group runs
# its packages on a worker thread of its own).
_running = threading.local()


def running_group() -> Optional["DeviceGroup"]:
    """The DeviceGroup whose package kernel runs on this thread (None
    outside :meth:`DeviceGroup.execute_chunk`)."""
    return getattr(_running, "group", None)


class DeviceGroup:
    def __init__(
        self,
        name: str,
        device=None,
        *,
        power: float = 1.0,
        watts: float = 0.0,
        min_package_groups: int = 1,
        kernel: Optional[Callable] = None,
        sim_time_per_wi: float = 0.0,
        transfer_cache_entries: int = 128,
    ) -> None:
        self.name = name
        self.device = torch.device(device if device is not None else "cuda:0")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"DeviceGroup {name!r}: CUDA is not available; pass "
                    "device='cpu' to run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.stream = torch.cuda.Stream(self.device)
        elif self.device.type == "cpu":
            self.stream = None
        else:
            raise ValueError(f"unsupported device {self.device}: use cuda or cpu")
        self.devices = [self.device]
        # compile_kernel's graphs (the reference's per-group jit): a CUDA
        # group's own GraphCache, None on the CPU, where kernels run eagerly.
        self.graphs = None
        if self.device.type == "cuda":
            from repro_torch.serve.graphs import GraphCache

            self.graphs = GraphCache()
        self._compiled: dict = {}
        self.power = power
        # Rated board power (0 = unrated).  Rate-aware placement divides
        # observed throughput by watts when set, so scheduling optimizes
        # tokens/joule instead of raw tokens/s (Green Computing rating).
        self.watts = watts
        self.min_package_groups = min_package_groups
        self.specialized_kernel = kernel
        self.sim_time_per_wi = sim_time_per_wi
        self._sim_clock = 0.0  # simulated completion time of the last package
        # Device-resident transfer cache: (buffer version, offset, bucket) ->
        # padded device tensor.  Versions (program.buffer_version) change
        # when a buffer is rewritten/swapped, so hits are always
        # content-correct.
        self._xfer_cache: OrderedDict[tuple, Any] = OrderedDict()
        self._xfer_cache_entries = max(0, transfer_cache_entries)
        self._xfer_lock = threading.Lock()
        # ids of host buffers that were garbage collected: their cached
        # device slices can never be hit again, so they are evicted on the
        # next cache access.  Appended from GC finalizers (which may run
        # while _xfer_lock is held on this very thread), hence a lock-free
        # list + drain-under-lock instead of direct eviction.  _tracked_ids
        # guarantees ONE finalizer per live buffer per group, however many
        # slices/versions of it get cached.
        self._dead_buffers: list = []
        self._tracked_ids: set = set()
        self.n_transfers = 0  # host -> device copies of kernel inputs
        self.n_cache_hits = 0
        # Slot migration's row patches (patch_cached): applied in place,
        # and refused (the caller re-uploads the buffer instead).
        self.n_patches = 0
        self.n_patch_misses = 0
        # Seconds this group's packages waited for another thread's capture
        # of a graph that lives outside self.graphs (a server's segment
        # loops, ``graphs.GraphCache._capture`` credits them here).
        self.loop_wait_s = 0.0

    def stream_context(self):
        """Make this group's stream current (a no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def compile_kernel(self, program) -> Callable:
        """The group's callable for the (possibly specialized) kernel, keyed
        as the reference keys its per-group jit (the kernel, its name, the
        donated inputs): on a CUDA group, one graph per package shape
        (``graphs.compiled``); the kernel as it is on the CPU group and for
        a kernel marked ``graphs.passthrough`` (one that binds graphs of its
        own, or one its owner runs eagerly)."""
        fn = self.specialized_kernel or program._kernel
        if (self.graphs is None or not self.graphs.accepts(self.device)
                or getattr(fn, "graph_passthrough", False)):
            return fn
        # Kernel signature is (offset, *ins, *args): donated input i is
        # argument i + 1.
        donate = tuple(1 + i for i in program.donated_ins)
        key = (id(fn), program._kernel_name, donate)
        compiled = self._compiled.get(key)
        if compiled is None:
            from repro_torch.serve.graphs import compiled as compile_graph

            compiled = self._compiled[key] = compile_graph(
                self.graphs, fn, key, len(program._ins), self.device, program._kernel_name)
        return compiled

    @property
    def capture_wait_s(self) -> float:
        """Seconds this group's captures have waited for another group's
        capture to end (one capture runs at a time in the process), its
        compiled kernels' and its packages' segment loops' alike: not this
        group's work, so the runtime leaves it out of the service time its
        scheduler observes."""
        return (self.graphs.wait_s if self.graphs is not None else 0.0) + self.loop_wait_s

    @staticmethod
    def _bucket(size_wi: int, lws: int) -> int:
        """Round a package up to a power-of-two number of work-groups.

        The reference buckets so that XLA compiles at most log2(max_groups)
        executables per device; the port keeps the same package geometry
        (inputs padded, outputs trimmed on write-back), so package streams
        and transfer counts match the reference's.
        """
        groups = -(-size_wi // lws)
        return lws * (1 << max(0, (groups - 1).bit_length()))

    # ------------------------------------------------------- transfer cache
    def _drain_dead(self) -> None:
        """Evict entries of collected buffers (lock held by caller)."""
        if not self._dead_buffers:
            return
        dead = set()
        while self._dead_buffers:  # atomic pops: appends are never lost
            dead.add(self._dead_buffers.pop())
        self._tracked_ids -= dead
        for k in [k for k in self._xfer_cache if k[0] in dead]:
            del self._xfer_cache[k]

    def _cache_get(self, key, *, take: bool = False):
        with self._xfer_lock:
            self._drain_dead()
            if take:
                # Consume the entry: the caller donates the device tensor to
                # a kernel that writes it in place, so a retained entry would
                # serve those writes under the old version on the next probe.
                return self._xfer_cache.pop(key, None)
            v = self._xfer_cache.get(key)
            if v is not None:
                self._xfer_cache.move_to_end(key)
            return v

    def _cache_put(self, key, value, host_buf) -> None:
        if self._xfer_cache_entries <= 0:
            return
        with self._xfer_lock:
            self._drain_dead()
            register = key[0] not in self._tracked_ids
            if register:
                self._tracked_ids.add(key[0])
        if register:
            try:
                weakref.finalize(host_buf, self._dead_buffers.append, key[0])
            except TypeError:  # can't observe its death: don't pin a copy
                with self._xfer_lock:
                    self._tracked_ids.discard(key[0])
                return
        with self._xfer_lock:
            self._xfer_cache[key] = value
            self._xfer_cache.move_to_end(key)
            while len(self._xfer_cache) > self._xfer_cache_entries:
                self._xfer_cache.popitem(last=False)

    def clear_cache(self) -> None:
        with self._xfer_lock:
            self._xfer_cache.clear()

    def transfer_stats(self) -> dict:
        with self._xfer_lock:
            return {
                "transfers": self.n_transfers,
                "cache_hits": self.n_cache_hits,
                "cached_entries": len(self._xfer_cache),
            }

    @staticmethod
    def _pad_rows(t: torch.Tensor, need: int) -> torch.Tensor:
        return torch.cat([t, t.new_zeros((need,) + tuple(t.shape[1:]))])

    def _input_slice(self, program, host_buf, offset_wi: int, size_wi: int,
                     bucket: int, *, consume: bool = False):
        """Device copy of one input's package slice, padded to the bucket.

        Cached per (buffer version, offset, bucket): iterative/serving reruns
        over unchanged buffers skip the host->device transfer entirely.
        ``consume`` (donated inputs): the kernel writes the device tensor in
        place, so a cache hit is *popped* and fresh transfers are never
        retained — each upload/handoff serves exactly one run."""
        r = program.buffer_ratio(host_buf)
        lo, hi = int(r * offset_wi), int(r * (offset_wi + size_wi))
        need = int(r * bucket) - (hi - lo)
        # A buffer that is both input and output of the same Program
        # (in-place update) is uncacheable: under run-scoped write versions a
        # mid-run input slice would be keyed on the run's final version and
        # could shadow the produced output for dependent runs.
        if any(b is host_buf for b in program._outs):
            version = None
        else:
            version = buffer_version(host_buf)
        # Keyed on element bounds (not work-items): a buffer shared between
        # programs of different gws can't alias a wrong slice.  The leading
        # id ties every entry to the buffer whose death evicts it.
        key = (id(host_buf), version, lo, hi, need) if version is not None else None
        if key is not None:
            cached = self._cache_get(key, take=consume)
            if cached is not None:
                with self._xfer_lock:
                    self.n_cache_hits += 1
                return cached
            if need > 0:
                # Handoff probe: a producer run stashed this exact element
                # range unpadded (need=0).  Padding happens device-side —
                # no host re-read, no upload.  The padded tensor is a new
                # buffer, so donating it never touches the stashed base.
                base = self._cache_get(key[:4] + (0,))
                if base is not None:
                    with self._xfer_lock:
                        self.n_cache_hits += 1
                    dev = self._pad_rows(base, need)
                    if not consume:
                        self._cache_put(key, dev, host_buf)
                    return dev
        b = torch.as_tensor(host_buf[lo:hi])
        if need > 0:
            b = self._pad_rows(b, need)
        dev = b.to(self.device, copy=True)
        with self._xfer_lock:
            self.n_transfers += 1
        if key is not None and not consume:
            self._cache_put(key, dev, host_buf)
        return dev

    def stash_output(self, program, host_buf, offset_wi: int, size_wi: int,
                     dev_result, version: Optional[int]) -> None:
        """Device-resident output handoff: seed the transfer cache with a
        slice this group just produced, keyed under the producing run's
        write ``version`` (``RunHandle.version_for_write``).  A dependent
        run that reads the same element range on this group then serves the
        still-on-device result instead of re-reading host memory and paying
        a fresh upload.  Bucket padding is trimmed (a view: pad lanes hold
        garbage computed from padded inputs); consumers re-pad with zeros on
        their own bucket geometry."""
        if version is None or self._xfer_cache_entries <= 0:
            return
        r = program.buffer_ratio(host_buf)
        lo, hi = int(r * offset_wi), int(r * (offset_wi + size_wi))
        self._cache_put((id(host_buf), version, lo, hi, 0),
                        dev_result[: hi - lo], host_buf)

    def patch_cached(self, program, host_buf, rows, values) -> bool:
        """Patch leading-axis rows of this group's stashed device copy of
        ``host_buf`` in place, *without* a version bump.

        Slot migration rewrites a few rows of a mirror the destination group
        already holds device-resident (the full-range ``stash_output`` entry
        from its last segment).  Re-uploading the whole mirror would be
        O(buffer); this is O(rows).  The caller must have already written the
        same rows into the host mirror, so host and device stay coherent
        under the *unchanged* version token.  ``values`` must be a tensor of
        its own, not a view of the mirror (the upload may still read it
        after the mirror's next write-back).

        The rows are written into the stashed tensor itself (``index_copy_``
        on this group's stream, after its last segment's work and before its
        next's): a paged member's pool leaves are its segment loop's static
        buffers, which its next replay reads in place, and a contiguous
        member's next upload serves that tensor from the cache.

        Returns False (caller must ``invalidate`` instead) when no full-range
        stash exists — first segment on this group, entry LRU-evicted, or the
        buffer is uncacheable (a Program output, or unversioned).  On
        success, every *other* cached entry for this buffer id is evicted
        (padded variants under the same version would otherwise serve stale
        rows) and exactly one transfer is counted for the O(rows) upload."""
        version = (None if any(b is host_buf for b in program._outs)
                   else buffer_version(host_buf))
        base_key = (id(host_buf), version, 0, len(host_buf), 0)
        with self._xfer_lock:
            self._drain_dead()
            base = self._xfer_cache.get(base_key) if version is not None else None
            if base is None:
                self.n_patch_misses += 1
                return False
            for k in [k for k in self._xfer_cache
                      if k[0] == id(host_buf) and k != base_key]:
                del self._xfer_cache[k]
        idx = torch.as_tensor(list(rows), dtype=torch.long)
        with self.stream_context():
            base.index_copy_(0, idx.to(self.device, non_blocking=True),
                             values.to(self.device, base.dtype, non_blocking=True))
        with self._xfer_lock:
            self.n_transfers += 1
            self.n_patches += 1
            self._xfer_cache.move_to_end(base_key)
        return True

    def execute_chunk(self, program, offset_wi: int, size_wi: int):
        """Run one package on this group's stream; returns ``(results,
        event)`` without waiting for the device: ``event`` (None on the
        CPU) is recorded after the kernel's last launch, and
        :meth:`wait` blocks on it.  While the span tracer is on, an
        ``upload`` span covers the inputs' transfers (cache hits and
        host-to-device copies).

        Inputs are padded to the bucket size; callers must trim outputs to
        ``size_wi`` (Program.write_outputs does).
        """
        fn = self.compile_kernel(program)
        bucket = self._bucket(size_wi, program.lws)
        donated = set(program.donated_ins)
        with self.stream_context():
            if self.stream is not None:
                # Work the caller enqueued on the default stream (the
                # parameters, a cache it filled) precedes this package.
                self.stream.wait_stream(torch.cuda.default_stream(self.device))
            t0, n0 = time.perf_counter(), self.n_transfers
            ins = [
                self._input_slice(program, b, offset_wi, size_wi, bucket,
                                  consume=i in donated)
                for i, b in enumerate(program._ins)
            ]
            tr = tracer()
            if tr.enabled:
                tr.complete("upload", t0, time.perf_counter(), track=f"group/{self.name}",
                            kernel=program.label, transfers=self.n_transfers - n0)
            _running.group = self
            try:
                res = fn(offset_wi, *ins, *program._args)
            finally:
                _running.group = None
            event = None
            if self.stream is not None:
                event = torch.cuda.Event()
                event.record(self.stream)
        return res, event

    def simulate_service_time(self, size_wi: int, elapsed: float,
                              cost_units: Optional[float] = None) -> None:
        """Pad to the service time a device of this speed would need.

        A real device computes packages *serially*, so the simulated clock
        advances from the later of (previous simulated completion, actual
        package start) — otherwise pipelined dispatch would let sleeps
        overlap and produce impossible >S_max speedups.

        ``cost_units`` (defaults to size_wi) lets irregular kernels charge
        content-dependent work (Program.cost_fn)."""
        if self.sim_time_per_wi <= 0:
            return
        target = (cost_units if cost_units is not None else size_wi) * self.sim_time_per_wi
        now = time.perf_counter()
        start = max(self._sim_clock, now - elapsed)
        end = start + target
        if end > now:
            time.sleep(end - now)
            self._sim_clock = end
        else:
            self._sim_clock = now

    @staticmethod
    def wait(event) -> None:
        """Block this thread until a package's device work is done (the
        JAX package's ``jax.block_until_ready``)."""
        if event is not None:
            event.synchronize()

    def __repr__(self) -> str:
        return f"DeviceGroup({self.name!r}, device={self.device}, power={self.power})"
