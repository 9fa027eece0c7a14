"""Shape-bucketed continuous batching over the dataflow runtime.

Port of the JAX package's ``serve/batcher.py``.  ``InferenceServer`` owns
the request queue and the event loop; this module owns everything between a
formed batch and the runtime —

- ``Buckets``        — prompt-length buckets: prompts are right-padded to
  the smallest bucket that fits (padding is part of the serving contract: a
  padded request generates exactly as one-shot generate on the padded
  prompt).
- ``ModelKernels``   — the Program kernels, built once per server and
  shared by every group of the same geometry: a *prefill* kernel (prompt
  rows → first token + slot-leading cache rows) and a *decode-segment*
  kernel (``seg_len`` per-slot decode steps; the JAX ``lax.scan`` is a
  Python loop).
- ``BatchGroup``     — one live continuous batch: ``n_slots`` KV-cache
  slots backed by slot-leading host mirror buffers that form a single
  ``Program``, decoding in fixed-length segments submitted through
  ``Runtime.submit(after=prev_segment)``.

The segment Program's inputs are the previous segment's outputs, ping-pong
swapped by the run epilogue (``swap_buffers``) — so segment N+1 reads
segment N's token/position/cache buffers **device-resident** from the
transfer cache.  Steady-state decode therefore performs zero host→device
transfers; only join events — which rewrite slot rows in the host mirrors
and must ``invalidate`` them — pay a re-upload.  Every segment still writes
its outputs back to the host mirrors (the reference's design).

Requests *exit* at segment boundaries (their slot is left to decode
garbage — shapes are static — until a joiner overwrites the full slot row).
Requests *join* at segment boundaries after their prefill — submitted as
its own Program, concurrently with the in-flight segment — completes.

Host buffers are CPU torch tensors.  Speculative decoding (``draft``) and
chunked prefill (``chunk_len > 0``) are not ported yet (ROADMAP.md item
A5) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import bisect
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.program import Program
from repro_torch.core.trace import tracer
from repro_torch.models.params import Spec, tree_leaves, tree_map
from repro_torch.serve.step import (
    cache_batch_axes,
    make_decode_step,
    make_prefill_step,
    zeros_cache,
)

NOT_PORTED_A5 = ("is not ported to repro_torch yet: ROADMAP.md item A5 "
                 "(the rest of the continuous-batching server)")


class Buckets:
    """Prompt-length shape buckets (sorted, ascending)."""

    def __init__(self, sizes: Sequence[int]) -> None:
        if not sizes:
            raise ValueError("need at least one bucket size")
        self.sizes = sorted(set(int(s) for s in sizes))
        if self.sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {self.sizes}")

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Smallest bucket that fits, or None (prompt too long to serve)."""
        i = bisect.bisect_left(self.sizes, prompt_len)
        return self.sizes[i] if i < len(self.sizes) else None

    @staticmethod
    def pad(prompt: np.ndarray, bucket: int, pad_id: int) -> np.ndarray:
        """Right-pad a 1-D prompt to the bucket boundary."""
        out = np.full(bucket, pad_id, np.int32)
        out[: len(prompt)] = prompt
        return out


def segments_for(new_tokens: int, seg_len: int) -> int:
    """Decode segments a request needs: the first token comes from prefill,
    the remaining ``new_tokens - 1`` from fixed-length segments."""
    return max(0, math.ceil((new_tokens - 1) / seg_len))


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class ModelKernels:
    """Per-server kernel factory: every BatchGroup of the same geometry
    shares one kernel *object* per (kind, shape-key)."""

    def __init__(self, cfg, api, params, draft=None) -> None:
        if draft is not None:
            raise NotImplementedError(f"speculative decoding (draft=) {NOT_PORTED_A5}")
        self.cfg, self.api, self.params = cfg, api, params
        # Batch-axis geometry is max_seq-independent; probe with a tiny cache.
        self.bax = cache_batch_axes(cfg, api, 8)
        self.bax_leaves = tree_leaves(self.bax)
        self._seg_fns: dict = {}
        self._prefill_fns: dict = {}
        self.draft = None

    @property
    def spec_k(self) -> int:
        """Draft depth (0 = speculation off; the only value ported)."""
        return 0

    def _leaf_specs(self, max_seq: int) -> list:
        return tree_leaves(self.api.cache_spec(self.cfg, 1, max_seq))

    def _unflatten(self, leaves) -> dict:
        """The cache tree with ``leaves`` in ``tree_leaves`` order."""
        it = iter(leaves)
        return tree_map(lambda _: next(it), self.bax)

    def leaf_mirrors(self, n_slots: int, max_seq: int) -> List[torch.Tensor]:
        """Slot-leading host mirror buffers for every cache leaf, honoring
        each leaf's declared init (position leaves are −1 = empty, the same
        contract ``zeros_cache`` enforces on device), in the leaf's dtype
        (the compute dtype unless the spec says otherwise)."""
        out = []
        for s, a in zip(self._leaf_specs(max_seq), self.bax_leaves):
            dt = _torch_dtype(s.dtype or self.cfg.compute_dtype)
            shape = s.shape[:a] + s.shape[a + 1:]
            fill = {"neg_ones": -1, "ones": 1}.get(s.init, 0)
            out.append(torch.full((n_slots,) + tuple(shape), fill, dtype=dt))
        return out

    def leaf_neg_init(self, max_seq: int) -> List[bool]:
        """Which cache leaves record positions (init ``neg_ones``) — the
        leaves a paged pool must reset to −1 when a block is reallocated."""
        return [s.init == "neg_ones" for s in self._leaf_specs(max_seq)]

    def leaf_seq_axes(self) -> List[int]:
        """Per-leaf sequence-axis index in *mirror* coordinates (slot axis
        removed), found structurally by probing two cache lengths.  Raises
        for cache families without a per-leaf timeline (SSM/hybrid state):
        those caches cannot be paged."""
        a = tree_leaves(self.api.cache_spec(self.cfg, 1, 1))
        b = tree_leaves(self.api.cache_spec(self.cfg, 1, 2))
        axes = []
        for x, y, bax in zip(a, b, self.bax_leaves):
            assert isinstance(x, Spec)
            sax = None
            for i, (m, n) in enumerate(zip(x.shape, y.shape)):
                if m != n:
                    sax = i
                    break
            if sax is None:
                raise ValueError(
                    f"cache leaf {x.shape} has no sequence axis: "
                    f"{self.cfg.family!r} caches cannot be paged"
                )
            axes.append(sax - 1 if sax > bax else sax)
        return axes

    def _decode_loop(self, decode, seg_len, tok, pos, cache, cap=None):
        """``seg_len`` per-slot decode steps (the JAX ``lax.scan``):
        tokens, positions and the cache stay on the device.  ``cap`` clamps
        the positions a step writes at (contiguous caches): an exited slot
        decodes garbage past its row's end, which the JAX scatter drops and
        ``index_put_`` would reject; clamped, it lands in the exited slot's
        own last entry, which the next joiner's full-row write replaces."""
        params = self.params
        toks = torch.empty((tok.shape[0], seg_len), dtype=torch.int32, device=tok.device)
        for i in range(seg_len):
            p = pos[:, 0] if cap is None else torch.clamp(pos[:, 0], max=cap - 1)
            tok, cache = decode(params, cache, tok, p)
            pos = pos + 1
            toks[:, i] = tok[:, 0]
        return toks, tok, pos

    def segment_kernel(self, seg_len: int, max_seq: int) -> Callable:
        """``fn(offset, tok, pos, *cache_leaves) ->
        (toks[b, seg_len], tok', pos', *cache_leaves')`` — ``seg_len``
        per-slot decode steps (vector ``pos``: slots may sit at different
        depths).  Slot axis leads every buffer: the runtime slices it.

        The slot-leading leaves are copied into the model's batch layout
        once per segment and back once (the decode kernel reads a
        contiguous cache); the donated leaves are written back in place and
        returned as the outputs.  ``max_seq`` is the slots' timeline
        length (see ``_decode_loop``)."""
        key = (seg_len, max_seq)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        decode = make_decode_step(self.cfg, self.api)
        bax = self.bax_leaves

        def seg(offset, tok, pos, *leaves):
            cache = self._unflatten([x.movedim(0, a).contiguous()
                                     for x, a in zip(leaves, bax)])
            toks, tok, pos = self._decode_loop(decode, seg_len, tok, pos, cache,
                                               cap=max_seq)
            for x, c, a in zip(leaves, tree_leaves(cache), bax):
                x.copy_(c.movedim(a, 0))
            return (toks, tok, pos, *leaves)

        self._seg_fns[key] = seg
        return seg

    def paged_segment_kernel(self, seg_len: int) -> Callable:
        """Paged variant of :meth:`segment_kernel`: ``fn(offset, tok, pos,
        table, *pool_leaves) -> (toks, tok', pos', *pool_leaves')``.  Pool
        leaves are block-leading ``(n_blocks, layers, block_len, ...)``; the
        per-slot block table is broadcast across the layer axis so each
        layer's cache view carries it, and the decode path
        (``attention._paged_write`` / ``cached_attention``) recognizes the
        ``"table"`` leaf and resolves physical blocks.  The pool is never
        copied: each layer reads and writes its strided view of the donated
        pool leaves in place, and those leaves are returned as outputs."""
        key = ("paged", seg_len)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        decode = make_decode_step(self.cfg, self.api)
        bax = self.bax_leaves
        n_layers = self.cfg.n_layers

        def seg(offset, tok, pos, table, *leaves):
            cache = self._unflatten([x.movedim(0, a) for x, a in zip(leaves, bax)])
            cache["table"] = table[None].expand((n_layers,) + tuple(table.shape))
            toks, tok, pos = self._decode_loop(decode, seg_len, tok, pos, cache)
            return (toks, tok, pos, *leaves)

        self._seg_fns[key] = seg
        return seg

    def prefill_kernel(self, max_seq: int) -> Callable:
        """``fn(offset, tokens[b, S_b]) -> (tok0[b, 1], *slot_leading_cache)``
        — batched prefill against a fresh ``zeros_cache``; rows are
        independent, so the runtime may split requests across groups."""
        fn = self._prefill_fns.get(max_seq)
        if fn is not None:
            return fn
        prefill = make_prefill_step(self.cfg, self.api)
        cfg, api, params, bax = self.cfg, self.api, self.params, self.bax_leaves

        def pre(offset, tokens):
            cache = zeros_cache(cfg, api, tokens.shape[0], max_seq, device=tokens.device)
            tok, cache = prefill(params, {"tokens": tokens}, cache)
            leaves = [x.movedim(a, 0) for x, a in zip(tree_leaves(cache), bax)]
            return (tok, *leaves)

        self._prefill_fns[max_seq] = pre
        return pre


class BatchGroup:
    """One live continuous batch for one bucket.  All mutating methods are
    called from the server's single batcher thread; the runtime's worker
    threads only touch the handles (and fire done-callbacks)."""

    def __init__(self, kernels: ModelKernels, runtime, scheduler,
                 bucket: int, n_slots: int, seg_len: int, max_seq: int,
                 chunk_len: int = 0, target=None) -> None:
        if chunk_len:
            raise NotImplementedError(f"chunked prefill (chunk_len > 0) {NOT_PORTED_A5}")
        self.kernels = kernels
        self.runtime = runtime
        self.scheduler = scheduler
        self.bucket = bucket
        self.n_slots = n_slots
        self.seg_len = seg_len
        self.max_seq = max_seq
        self.chunk_len = 0
        self.spec_k = 0
        # Device groups this batch's runs are pinned to (None = all runtime
        # groups).
        self.target = list(target) if target else None
        self.slots: List[Optional[object]] = [None] * n_slots  # _Request per slot
        self.dead = False
        self.tokens_written = 0  # KV positions actually written (memory_stats)
        self.last_run_metrics: dict = {}
        self.telemetry = None  # set by the owning InferenceServer
        self._build_segment_program()
        self.seg_handle = None
        self.prev_handle = None
        self._seg_t0 = 0.0
        self._seg_tr0 = 0.0  # tracer-clock start (0 = not traced)
        # -- in-flight prefill wave ----------------------------------------
        self.prefill_handle = None
        self.prefill_wave: List[object] = []
        self._prefill_prog: Optional[Program] = None
        self._prefill_t0 = 0.0
        self._prefill_tr0 = 0.0  # tracer-clock start (0 = not traced)

    def _build_segment_program(self) -> None:
        """Contiguous layout: slot-leading mirrors, ping-pong in/out pairs
        (PagedBatchGroup overrides this with pool buffers + block table)."""
        kernels, n_slots, seg_len = self.kernels, self.n_slots, self.seg_len
        tok = torch.zeros((n_slots, 1), dtype=torch.int32)
        pos = torch.zeros((n_slots, 1), dtype=torch.int32)
        leaves = kernels.leaf_mirrors(n_slots, self.max_seq)
        toks_seg = torch.zeros((n_slots, seg_len), dtype=torch.int32)
        prog = Program().in_(tok).in_(pos)
        for b in leaves:
            prog.in_(b)
        prog.out(toks_seg).out(torch.zeros_like(tok)).out(torch.zeros_like(pos))
        for b in leaves:
            prog.out(torch.zeros_like(b))
        prog.kernel(kernels.segment_kernel(seg_len, self.max_seq), f"decode_seg{seg_len}")
        # Donate the cache-leaf inputs: each segment updates the KV slots in
        # place on the device instead of copying the cache per segment.
        # Safe because segments chain serially (after=prev) and the donated
        # device tensors are consumed from the transfer cache.
        prog.donate(*range(2, 2 + len(leaves)))
        prog.work_items(n_slots, 1)
        self.prog = prog
        self.n_leaves = len(leaves)
        # (in_index, out_index) ping-pong pairs: tok, pos, every cache leaf.
        self._swap_pairs = [(0, 1), (1, 2)] + [
            (2 + i, 3 + i) for i in range(self.n_leaves)
        ]

    # ------------------------------------------------------------- queries
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active(self) -> List[tuple]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def idle(self) -> bool:
        return (self.seg_handle is None and self.prefill_handle is None
                and not any(self.slots))

    # ----------------------------------------------------- memory interface
    def reserve_estimate(self, req) -> int:
        """Blocks this request would reserve (0: contiguous slots are
        pre-allocated — memory admission never defers)."""
        return 0

    def memory_available(self, already_reserved: int) -> float:
        return math.inf

    def memory_stats(self) -> dict:
        """KV memory accounting, comparable across layouts: contiguous
        groups allocate their full capacity up front (every slot row at
        ``max_seq``, whatever depth is recorded)."""
        allocated = sum(b.nbytes for b in self.prog._ins[2:2 + self.n_leaves])
        capacity = self.n_slots * self.max_seq
        return {
            "mode": "contiguous",
            "kv_bytes_allocated": allocated,
            "kv_bytes_device": allocated,
            "kv_bytes_touched": int(
                allocated * self.tokens_written / max(1, capacity)
            ),
            "tokens_written": self.tokens_written,
        }

    # ------------------------------------------------------------- prefill
    def _plan_prefill(self, requests: Sequence) -> List:
        """Pick which wave members need a prefill row (all of them for the
        contiguous layout; the paged override shares prefix blocks and
        skips rows whose whole prompt is cached)."""
        return list(requests)

    def start_prefill(self, requests: Sequence, notify: Callable) -> None:
        """Submit one prefill Program for a join wave (≤ free slots).  Runs
        concurrently with any in-flight decode segment: no shared buffers,
        so the run graph infers no edge between them."""
        assert self.prefill_handle is None
        assert len(requests) <= len(self.free_slots())
        self.prefill_wave = list(requests)
        self._prefill_t0 = _now()
        tr = tracer()
        self._prefill_tr0 = tr.now() if tr.enabled else 0.0
        rows = self._plan_prefill(requests)
        if not rows:
            # Every request hit the whole-prompt cache: nothing to run, but
            # the merge state machine still expects a completed handle.
            from repro_torch.serve.paged import _DoneHandle

            self._prefill_prog = None
            h = _DoneHandle()
        else:
            j = len(rows)
            tokens = torch.from_numpy(np.stack([r.prompt for r in rows]).astype(np.int32))
            prog = Program().in_(tokens)
            prog.out(torch.zeros((j, 1), dtype=torch.int32))
            for b in self.kernels.leaf_mirrors(j, self.max_seq):
                prog.out(b)
            prog.kernel(self.kernels.prefill_kernel(self.max_seq),
                        f"prefill_{self.bucket}")
            prog.work_items(j, 1)
            self._prefill_prog = prog
            h = self.runtime.submit(prog, self.scheduler, groups=self.target)
        self.prefill_handle = h
        h.add_done_callback(lambda _h: notify())

    def merge_prefill(self) -> dict:
        """Board a completed prefill wave: write each request's first token,
        start position, and full cache row into a free slot's host mirrors,
        then invalidate the mirrors (their device copies are stale).  Only
        legal between segments — an in-flight segment may slice the mirrors
        at any moment.  Returns {"joined": n, "failed": [...], "seconds"}."""
        h, wave, prog = self.prefill_handle, self.prefill_wave, self._prefill_prog
        assert h is not None and h.done()
        self.prefill_handle, self.prefill_wave, self._prefill_prog = None, [], None
        seconds = h.metrics.get("response_time") or (_now() - self._prefill_t0)
        tr = tracer()
        if tr.enabled and self._prefill_tr0:
            tr.complete("prefill_wave", self._prefill_tr0,
                        self._prefill_tr0 + seconds, track="batcher",
                        bucket=self.bucket, wave=len(wave))
            self._prefill_tr0 = 0.0
        if h.has_errors():
            return {"joined": 0, "failed": list(wave), "errors": h.errors(),
                    "seconds": seconds}
        free = self.free_slots()
        tok_b, pos_b = self.prog._ins[0], self.prog._ins[1]
        leaf_bufs = self.prog._ins[2:]
        tok0 = prog._outs[0]
        wave_leaves = prog._outs[1:]
        for i, req in enumerate(wave):
            slot = free.pop(0)
            tok_b[slot, 0] = tok0[i, 0]
            pos_b[slot, 0] = self.bucket
            for dst, src in zip(leaf_bufs, wave_leaves):
                dst[slot] = src[i]
            self.slots[slot] = req
            req.board(slot, int(tok0[i, 0]))
            if tr.enabled:
                tr.async_instant("first_token", req.seq, slot=slot)
        self.tokens_written += len(wave) * min(self.bucket, self.max_seq)
        for b in self.prog._ins:
            self.prog.invalidate(b)
        return {"joined": len(wave), "failed": [], "seconds": seconds}

    # ------------------------------------------------------------ segments
    def submit_segment(self, notify: Callable) -> None:
        """Chain the next decode segment after the previous one.  The swap
        epilogue runs worker-side, so the just-produced token/pos/cache
        buffers become the next segment's inputs *device-resident*."""
        assert self.seg_handle is None

        def epilogue(prog=self.prog, pairs=self._swap_pairs):
            for i_in, i_out in pairs:
                prog.swap_buffers(i_in, i_out)

        after = [self.prev_handle] if self.prev_handle is not None else None
        self._seg_t0 = _now()
        tr = tracer()
        self._seg_tr0 = tr.now() if tr.enabled else 0.0
        h = self.runtime.submit(self.prog, self.scheduler,
                                after=after, epilogue=epilogue,
                                groups=self.target)
        self.seg_handle = h
        h.add_done_callback(lambda _h: notify())

    def harvest_segment(self) -> dict:
        """Collect a completed segment: append each active slot's new tokens
        (truncated to what the request still needs), retire finished
        requests, and free their slots.  Returns stats for this segment."""
        h = self.seg_handle
        assert h is not None and h.done()
        self.seg_handle = None
        seconds = h.metrics.get("response_time") or (_now() - self._seg_t0)
        if h.has_errors():
            return {"errors": h.errors(), "seconds": seconds}
        self.prev_handle = h
        self.last_run_metrics = h.metrics
        # toks_seg is out 0 and never ping-ponged: stable across segments.
        toks_seg = self.prog._outs[0]
        n_active = 0
        finished = []
        delivered = 0
        tr = tracer()
        traced = tr.enabled
        for slot, req in self.active():
            n_active += 1
            need = req.remaining()
            take = toks_seg[slot, : min(self.seg_len, need)].tolist()
            if traced:
                tr.async_instant("decode_segment", req.seq, slot=slot,
                                 tokens=len(take))
            req.extend(take)
            delivered += len(take)
            if req.remaining() <= 0:
                finished.append(req)
                self.release_slot(slot)
        self.tokens_written += n_active * self.seg_len
        if traced and self._seg_tr0:
            tr.complete("segment", self._seg_tr0, self._seg_tr0 + seconds,
                        track="batcher", bucket=self.bucket,
                        n_active=n_active, finished=len(finished),
                        chunk_tokens=0)
            self._seg_tr0 = 0.0
        return {"n_active": n_active, "finished": finished, "seconds": seconds,
                "tokens": delivered}

    def release_slot(self, slot: int) -> None:
        """Free one KV slot (request retired or failed).  The paged variant
        additionally releases the slot's blocks and re-points its table at
        the sink block."""
        self.slots[slot] = None

    def fail_all(self, errors: Sequence[str]) -> List[object]:
        """A segment failed: group state is unrecoverable (mirrors may hold
        partial write-backs).  Collect every request this group owes an
        answer to; the server fails their handles and drops the group."""
        self.dead = True
        victims = [r for _, r in self.active()] + list(self.prefill_wave)
        self.slots = [None] * self.n_slots
        self.prefill_wave = []
        self.seg_handle = None
        self.prefill_handle = None
        return victims


def _now() -> float:
    return time.monotonic()
