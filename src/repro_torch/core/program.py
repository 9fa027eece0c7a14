"""Tier-1 ``Program``: the application-domain unit of EngineCL.

A Program owns input/output buffers, a data-parallel kernel and an
*out pattern* — exactly the paper's abstraction (§4.2).  The kernel is any
PyTorch function over chunk slices:

    program = Program()
    program.in_(x)                      # host buffers (CPU torch tensors)
    program.out(y)
    program.out_pattern(1, 255)         # 1 output element per 255 work-items
    program.kernel(fn, "binomial")      # fn(offset, *in_slices) -> out slices

The leading axis of every buffer is the data-parallel axis.  Buffer lengths
relate to the global work size through their own ratio (len / gws), so
buffers of different granularity (e.g. Binomial's 1:255) partition
consistently — the runtime slices work-items, never raw indices.

Port of the JAX package's ``core/program.py``.  Host buffers are CPU
``torch`` tensors, not numpy arrays: the server's host mirrors hold KV
caches in their compute dtype, and numpy has no bfloat16.  A numpy array
given to ``in_`` or ``out`` is wrapped (memory shared), and the same array
always gets the same wrapper, so two Programs that share a numpy buffer
share its host tensor: the run graph sees the shared buffer and the
transfer cache its version, as the reference's do.  The version machinery
is the reference's, unchanged.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from fractions import Fraction
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

# --------------------------------------------------------- buffer versioning
# The device-resident transfer cache (DeviceGroup) keys cached transfers on a
# *version token*: a process-unique integer assigned per host buffer and
# re-assigned whenever the buffer's contents change through runtime APIs
# (write_outputs, swap_buffers, invalidate).  Tokens come from one global
# counter, so a recycled ``id()`` after garbage collection can never alias a
# live cache entry.  Buffers that don't support weakrefs are uncacheable
# (version None) — correctness never depends on the finalizer firing.

_version_counter = itertools.count(1)
_versions: dict[int, int] = {}
_versions_lock = threading.Lock()


def _drop_version(key: int) -> None:
    # GC callback: may fire on a thread that already holds _versions_lock
    # (any allocation inside the locked regions can trigger collection), so
    # it must not acquire it.  A bare dict.pop is atomic under the GIL, and
    # the worst race outcome is a lost registration — the next lookup just
    # assigns a fresh (never-reused) token, i.e. a cache miss, never a stale
    # hit.
    _versions.pop(key, None)


def buffer_version(buf) -> Optional[int]:
    """Current version token for ``buf`` (None = not cacheable)."""
    key = id(buf)
    with _versions_lock:
        v = _versions.get(key)
        if v is None:
            try:
                weakref.finalize(buf, _drop_version, key)
            except TypeError:
                return None
            v = _versions[key] = next(_version_counter)
        return v


def bump_version(buf) -> None:
    """Invalidate cached transfers of ``buf`` (its contents changed)."""
    key = id(buf)
    with _versions_lock:
        if key in _versions:
            _versions[key] = next(_version_counter)


# One live wrapper per numpy array: id(array) -> the tensor sharing its
# memory.  The tensor holds the array, so while an entry lives its id names
# that array and no other.
_wrappers: "weakref.WeakValueDictionary[int, torch.Tensor]" = weakref.WeakValueDictionary()
_wrappers_lock = threading.Lock()


def host_tensor(buf) -> torch.Tensor:
    """``buf`` as a CPU host tensor: a tensor as it is; a numpy array (or
    anything ``np.asarray`` takes) wrapped without a copy, the same wrapper
    for the same array."""
    if isinstance(buf, torch.Tensor):
        return buf
    arr = np.asarray(buf)
    with _wrappers_lock:
        t = _wrappers.get(id(arr))
        if t is None:
            t = torch.as_tensor(arr)
            _wrappers[id(arr)] = t
    return t


class Program:
    def __init__(self) -> None:
        self._ins: list[Any] = []
        self._outs: list[Any] = []
        self._linked: list["Program"] = []
        self._kernel: Optional[Callable] = None
        self._kernel_name: str = "kernel"
        self._args: list[Any] = []
        self._donated_ins: tuple[int, ...] = ()
        self._out_pattern = Fraction(1, 1)  # out elems per work-item
        self.gws: Optional[int] = None
        self.lws: int = 1
        # Optional relative-cost model f(offset_wi, size_wi) -> work units
        # (default: size).  Used only by simulated-heterogeneity DeviceGroups
        # to model irregular kernels (Mandelbrot/Ray).
        self.cost_fn: Optional[Callable[[int, int], float]] = None

    # -- buffers ---------------------------------------------------------
    def in_(self, buf) -> "Program":
        self._ins.append(host_tensor(buf))
        return self

    def out(self, buf) -> "Program":
        self._outs.append(host_tensor(buf))
        return self

    def out_pattern(self, out_elems: int, work_items: int = 1) -> "Program":
        """``out_elems`` output indices written per ``work_items`` work-items."""
        self._out_pattern = Fraction(out_elems, work_items)
        return self

    # -- kernel ----------------------------------------------------------
    def kernel(self, fn: Callable, name: str = "kernel") -> "Program":
        """fn(offset:int, *in_slices, *args) -> out slice (or tuple of);
        the slices are tensors on the executing group's device."""
        self._kernel = fn
        self._kernel_name = name
        return self

    @property
    def label(self) -> str:
        """Human-readable kernel name — what traces and jit-cache keys call
        this Program's work (e.g. ``decode_seg4``, ``prefill_32``)."""
        return self._kernel_name

    # -- dataflow links ---------------------------------------------------
    def reads_from(self, *producers: "Program") -> "Program":
        """Declare upstream producers (the paper's linked buffers, §10).

        Submitting this Program orders it after any in-flight run of the
        named producers, even when the shared-buffer conflict cannot be
        inferred (e.g. the producer swaps in a new buffer mid-flight)."""
        self._linked.extend(producers)
        return self

    @property
    def linked(self) -> tuple:
        return tuple(self._linked)

    @property
    def reads(self) -> tuple:
        """Declared read set: the host buffers this Program's kernel consumes."""
        return tuple(self._ins)

    @property
    def writes(self) -> tuple:
        """Declared write set: the host buffers this Program's kernel produces."""
        return tuple(self._outs)

    def donate(self, *in_indices: int) -> "Program":
        """Donate input buffers (by ``in_`` index) to the kernel.

        The kernel may then update the donated inputs' device tensors in
        place and hand them back as its outputs (the JAX package's XLA
        buffer donation), so iterative Programs that carry large state (a
        KV cache ping-ponged between segments) never copy it on the device.
        Donated device inputs are *consumed*: the transfer cache hands them
        over and drops its entry (a retained entry would see the kernel's
        in-place writes under the input's old version), so each cached
        upload/handoff of a donated input serves exactly one run — the
        intended pattern is produce-once/consume-once chains like
        ``swap_buffers`` ping-pong, where the next run reads the *new*
        version anyway.  Host buffers are unaffected."""
        idx = sorted(set(int(i) for i in in_indices))
        for i in idx:
            if not 0 <= i < len(self._ins):
                raise IndexError(f"donate index {i} out of range for "
                                 f"{len(self._ins)} inputs")
        self._donated_ins = tuple(idx)
        return self

    @property
    def donated_ins(self) -> tuple:
        return self._donated_ins

    def args(self, *args) -> "Program":
        self._args = list(args)
        return self

    def arg(self, a) -> "Program":
        self._args.append(a)
        return self

    # -- geometry --------------------------------------------------------
    def global_work_items(self, gws: int) -> "Program":
        self.gws = gws
        return self

    def local_work_items(self, lws: int) -> "Program":
        self.lws = lws
        return self

    def work_items(self, gws: int, lws: int = 1) -> "Program":
        self.gws, self.lws = gws, lws
        return self

    # -- runtime-facing helpers (Tier-3) ----------------------------------
    def validate(self) -> list[str]:
        errs = []
        if self._kernel is None:
            errs.append("no kernel set")
        if self.gws is None:
            # Default: gws = leading dim of the first output / out_pattern.
            if self._outs:
                self.gws = int(Fraction(len(self._outs[0]), 1) / self._out_pattern)
            else:
                errs.append("no gws and no output buffer to infer it from")
        if self.gws is not None and self.lws and self.gws % self.lws:
            errs.append(f"gws {self.gws} not a multiple of lws {self.lws}")
        for i, b in enumerate(self._ins + self._outs):
            r = Fraction(len(b)) / self.gws
            if (r * self.lws).denominator != 1:
                errs.append(f"buffer {i}: length {len(b)} not compatible with gws/lws")
        return errs

    def buffer_ratio(self, buf) -> Fraction:
        return Fraction(len(buf), self.gws)

    def slice_inputs(self, offset_wi: int, size_wi: int) -> list:
        """Slice every input buffer for a work-item range."""
        out = []
        for b in self._ins:
            r = self.buffer_ratio(b)
            lo, hi = int(r * offset_wi), int(r * (offset_wi + size_wi))
            out.append(b[lo:hi])
        return out

    def write_outputs(self, offset_wi: int, size_wi: int, results: Sequence,
                      *, bump: bool = True) -> None:
        """Write one package's results back to the host output buffers.

        ``bump=True`` (the default, tier-1 semantics) re-versions each buffer
        per call.  The runtime passes ``bump=False`` and assigns ONE fresh
        version per (run, buffer) instead (``RunHandle.version_for_write``),
        so every chunk a run produces shares a single coherent version — the
        precondition for serving still-on-device output slices to dependent
        runs from the transfer cache."""
        if not isinstance(results, (tuple, list)):
            results = (results,)
        if len(results) != len(self._outs):
            raise ValueError(
                f"kernel returned {len(results)} outputs, program has {len(self._outs)}"
            )
        for b, res in zip(self._outs, results):
            r = self.buffer_ratio(b)
            lo, hi = int(r * offset_wi), int(r * (offset_wi + size_wi))
            b[lo:hi].copy_(res[: hi - lo])  # device -> host; trim bucket padding
            if bump:
                bump_version(b)  # output changed: stale any cached device copy

    def swap_buffers(self, i_in: int, i_out: int) -> None:
        """Ping-pong one (input, output) buffer pair between iterations.

        The just-written output becomes the next iteration's input, and the
        old input, made contiguous, the next output: ``.contiguous()``, the
        counterpart of the reference's ``np.ascontiguousarray``, returns
        the buffer itself when it is contiguous already, so the pair swaps
        in place with no host copy (a served segment's cache leaves are
        the pool's size).  No device tensor shares a host buffer's storage
        (uploads copy, and a stashed handoff is the kernel's own result),
        so writing the old input as the next output touches no live device
        state.  The swapped-in buffer's version is NOT bumped: its contents
        are exactly what the producing run wrote (and already re-versioned),
        so still-on-device result slices stay servable from the transfer
        cache — iterative chains hand buffers off device-resident instead
        of re-uploading.  The new output's version IS bumped: its transfers
        cached under its life as an input must not serve the next run."""
        new_in = self._outs[i_out]
        new_out = self._ins[i_in].contiguous()
        self._ins[i_in], self._outs[i_out] = new_in, new_out
        bump_version(new_out)

    def invalidate(self, buf=None) -> None:
        """Mark host buffers as externally modified (drops cached transfers).

        Call after mutating an input array in place outside the runtime; with
        no argument every buffer of this Program is invalidated."""
        targets = [buf] if buf is not None else self._ins + self._outs
        for b in targets:
            bump_version(b)

    @property
    def n_work_groups(self) -> int:
        return self.gws // self.lws

    @property
    def outputs(self) -> list:
        return self._outs
