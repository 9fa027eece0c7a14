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
  rows → first token + slot-leading cache rows; on the card the group that
  runs it replays a CUDA graph of it per wave shape,
  ``DeviceGroup.compile_kernel``) and a *decode-segment* kernel
  (``seg_len`` per-slot decode steps, with a chunk stage first in the
  mixed layouts; the JAX ``lax.scan`` is a CUDA graph on the card,
  captured once per shape and replayed, and a Python loop with
  ``graph=False`` or on the CPU: ``serve/graphs.py``).
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

With ``chunk_len > 0`` (chunked prefill) there is no prefill Program: a
join arms its slot host-side and the segment Program doubles as the prefill
engine, advancing each still-prefilling slot's cursor by one chunk before
its decode steps (the *mixed* layouts).

With a ``draft`` (speculative decoding) each segment step drafts ``k``
candidates and verifies them in one multi-row decode (the *spec* layouts:
a predecessor-token buffer, the draft cache's mirrors behind the target's,
a token buffer of ``seg_len * (k + 1)`` with a per-slot count); a segment
the ``SpecGate`` bypasses runs plain decode steps in the same layout.

Host buffers are CPU torch tensors, page-locked on a CUDA group.
"""
from __future__ import annotations

import bisect
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import running_group
from repro_torch.core.program import Program
from repro_torch.core.trace import tracer
from repro_torch.models.params import Spec, tree_leaves, tree_map
from repro_torch.serve import graphs
from repro_torch.serve.step import (
    DraftSpec,
    cache_batch_axes,
    make_chunk_step,
    make_decode_step,
    make_draft_verify_step,
    make_prefill_step,
    write_start,
    zeros_cache,
)


def chunks_for(bucket: int, chunk_len: int, start: int = 0) -> int:
    """Mixed-phase segments a prompt needs before its first token: the
    prefill cursor advances ``chunk_len`` positions per segment from
    ``start`` (> 0 when a paged prefix hit skips leading whole blocks)."""
    return max(0, math.ceil((bucket - start) / max(1, chunk_len)))


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


def spec_segments_for(new_tokens: int, seg_len: int, tokens_per_step: float) -> int:
    """Expected decode segments under speculation: each of a segment's
    ``seg_len`` draft/verify steps emits ``1 + acceptance * k`` tokens in
    expectation (1..k+1 guaranteed).  ``tokens_per_step = 1.0`` degrades to
    :func:`segments_for` exactly: the non-speculative accounting is the
    zero-acceptance special case, so forecasts stay comparable."""
    tps = max(1.0, float(tokens_per_step))
    return max(0, math.ceil((new_tokens - 1) / (seg_len * tps)))


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def host_zeros_like(b: torch.Tensor) -> torch.Tensor:
    """A zero host buffer shaped like ``b``, page-locked where ``b`` is: a
    ping-pong output swaps with its input every segment, so the two are
    pinned alike."""
    return torch.zeros(b.shape, dtype=b.dtype, pin_memory=b.is_pinned())


class ModelKernels:
    """Per-server kernel factory: every BatchGroup of the same geometry
    shares one kernel *object* per (kind, shape-key).

    ``graph=True``: each segment's loop (plain, paged, mixed with and
    without its chunk stage, the speculative scan and its bypass) is
    captured in a CUDA graph once per shape and replayed (``self.graphs``,
    the counterpart of the JAX group's jit of its ``lax.scan``); the
    segment kernels are marked ``graphs.passthrough``, so that the group
    never captures them whole.  The prefill kernels are captured and
    replayed by the group that runs them (``DeviceGroup.compile_kernel``,
    as the reference's group jits them).  ``graph=False`` runs every loop
    eagerly, prefill included."""

    def __init__(self, cfg, api, params, draft: Optional[DraftSpec] = None, *,
                 graph: bool = True) -> None:
        self.cfg, self.api, self.params = cfg, api, params
        self.graphs = graphs.GraphCache() if graph else None
        # Batch-axis geometry is max_seq-independent; probe with a tiny cache.
        self.bax = cache_batch_axes(cfg, api, 8)
        self.bax_leaves = tree_leaves(self.bax)
        self._seg_fns: dict = {}
        self._prefill_fns: dict = {}
        self.draft = draft
        if draft is not None:
            from repro_torch.models import get_model

            self.dapi = get_model(draft.cfg)
            self.dbax = cache_batch_axes(draft.cfg, self.dapi, 8)
            self.dbax_leaves = tree_leaves(self.dbax)

    @property
    def spec_k(self) -> int:
        """Draft depth (0 = speculation off)."""
        return self.draft.k if self.draft is not None else 0

    def _leaf_specs(self, max_seq: int) -> list:
        return tree_leaves(self.api.cache_spec(self.cfg, 1, max_seq))

    def _draft_leaf_specs(self, max_seq: int) -> list:
        return tree_leaves(self.dapi.cache_spec(self.draft.cfg, 1, max_seq))

    def _unflatten(self, leaves, bax=None) -> dict:
        """The cache tree (of ``bax``'s structure, the target's by default)
        with ``leaves`` in ``tree_leaves`` order."""
        it = iter(leaves)
        return tree_map(lambda _: next(it), self.bax if bax is None else bax)

    @staticmethod
    def _mirrors(specs, bax_leaves, compute_dtype, n_slots: int,
                 pin: bool) -> List[torch.Tensor]:
        out = []
        for s, a in zip(specs, bax_leaves):
            dt = _torch_dtype(s.dtype or compute_dtype)
            shape = s.shape[:a] + s.shape[a + 1:]
            fill = {"neg_ones": -1, "ones": 1}.get(s.init, 0)
            out.append(torch.full((n_slots,) + tuple(shape), fill, dtype=dt, pin_memory=pin))
        return out

    def leaf_mirrors(self, n_slots: int, max_seq: int, pin: bool = False) -> List[torch.Tensor]:
        """Slot-leading host mirror buffers for every cache leaf, honoring
        each leaf's declared init (position leaves are −1 = empty, the same
        contract ``zeros_cache`` enforces on device), in the leaf's dtype
        (the compute dtype unless the spec says otherwise); in page-locked
        memory with ``pin`` (a CUDA group's: its copies to and from the
        card then skip the staging through pageable memory)."""
        return self._mirrors(self._leaf_specs(max_seq), self.bax_leaves,
                             self.cfg.compute_dtype, n_slots, pin)

    def draft_leaf_mirrors(self, n_slots: int, max_seq: int,
                           pin: bool = False) -> List[torch.Tensor]:
        """Slot-leading mirrors for the *draft* model's cache.  Always
        contiguous slot rows, even when the target cache is paged: the draft
        cache carries no bitwise obligation (its staleness only moves the
        acceptance rate), so paging it would buy nothing."""
        return self._mirrors(self._draft_leaf_specs(max_seq), self.dbax_leaves,
                             self.draft.cfg.compute_dtype, n_slots, pin)

    def leaf_neg_init(self, max_seq: int) -> List[bool]:
        """Which cache leaves record positions (init ``neg_ones``) — the
        leaves a paged pool must reset to −1 when a block is reallocated."""
        return [s.init == "neg_ones" for s in self._leaf_specs(max_seq)]

    def draft_leaf_neg_init(self, max_seq: int) -> List[bool]:
        """Draft-cache analog of :meth:`leaf_neg_init` (chunked joins reset
        the position leaves of both caches in place of a prefill rewrite)."""
        return [s.init == "neg_ones" for s in self._draft_leaf_specs(max_seq)]

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
        the positions a step writes at on a contiguous cache of ``cap``
        positions (``step.write_start``; the speculative step clamps its k
        + 1 rows the same way): an exited slot decodes garbage past its
        row's end, which lands in its own last entries instead."""
        params = self.params
        toks = torch.empty((tok.shape[0], seg_len), dtype=torch.int32, device=tok.device)
        for i in range(seg_len):
            tok, cache = decode(params, cache, tok, write_start(pos[:, 0], cap))
            pos = pos + 1
            toks[:, i] = tok[:, 0]
        return toks, tok, pos

    # ------------------------------------------------- the bound loops
    #
    # A segment's loop reads its cache from static buffers (serve/graphs.py)
    # of its scope, the batch's bucket and the DeviceGroup that runs the
    # package (``_scope``), which keeps two live batches' state apart: two
    # buckets' batches, two groups' member batches of one bucket, the
    # packages one slot-split segment sends to two groups at once.  A
    # contiguous cache is copied into them in the model's layout
    # (the JAX package's per-segment relayout, moving the bytes
    # ``.contiguous()`` moved) and written back after; a paged pool's leaves
    # are the buffers themselves from the second segment on (the loop hands
    # them back as the segment's outputs, and the runtime's donated handoff
    # returns them), so the pool is copied in only when a join re-uploads
    # it.

    def _consts(self) -> tuple:
        return (self.params,) if self.draft is None else (self.params, self.draft.params)

    @staticmethod
    def _scope(bucket: int) -> tuple:
        """The scope of a loop bound now: ``bucket`` and the name of the
        DeviceGroup running the segment's package on this thread (None
        when called outside a group)."""
        group = running_group()
        return (bucket, group.name if group is not None else None)

    def _bind(self, name: str, steps: int, ints: tuple, inputs: dict, body: Callable,
              bucket: int) -> graphs.Loop:
        """Loop ``name`` bound in ``bucket``'s scope.  A replay's outputs
        (tokens, carries: never a cache) are copied out of the graph's
        memory: a group may run two packages of one shape in one segment
        (a slot-split batch), and the second replay overwrites the first's
        outputs before their write-back."""
        loop = graphs.bind(self.graphs, name, steps, ints, inputs, body, self._consts(),
                           scope=self._scope(bucket))
        if self.graphs is None or not self.graphs.accepts(inputs["tok"].device):
            return loop
        return graphs.Loop(loop.statics, lambda: self.graphs.copy_out(loop()))

    def _cache_in(self, leaves, paged: bool) -> list:
        """The target cache's loop inputs from the segment's leaves: views
        in the model's layout (contiguous: copied in, written back) or the
        pool leaves as they are (paged: used in place)."""
        if paged:
            return list(leaves)
        return [x.movedim(0, a) for x, a in zip(leaves, self.bax_leaves)]

    def _cache_tree(self, leaves, table=None) -> dict:
        """The target cache tree over a loop's buffers: the model's layout,
        or per-layer views of the pool with the block table broadcast over
        the layers (the decode path resolves physical blocks through its
        ``"table"`` leaf)."""
        if table is None:
            return self._unflatten(leaves)
        cache = self._unflatten([x.movedim(0, a) for x, a in zip(leaves, self.bax_leaves)])
        cache["table"] = table[None].expand((self.cfg.n_layers,) + tuple(table.shape))
        return cache

    @staticmethod
    def _copy_back(views, statics) -> None:
        """Write a loop's buffers back through the views they were copied
        from (nothing where the loop ran on the view's own storage)."""
        for x, s in zip(views, statics):
            if not graphs.same_storage(x, s):
                x.copy_(s)

    def _decode_bind(self, decode, seg_len: int, bucket: int, cap, tok, pos, cache_in,
                     table=None):
        """The segment's ``seg_len`` decode steps (:meth:`_decode_loop`) as
        one bound loop over (tok, pos, the cache and, paged, the table) in
        ``bucket``'s scope: returns (toks, tok', pos')."""
        paged = table is not None
        inputs = {"tok": tok, "pos": pos, "cache": cache_in}
        if paged:
            inputs["table"] = table

        def body(st, n):
            return self._decode_loop(decode, n, st["tok"], st["pos"],
                                     self._cache_tree(st["cache"], st.get("table")), cap=cap)

        return self._bind("decode", seg_len, (cap, paged), inputs, body, bucket)

    def segment_kernel(self, seg_len: int, bucket: int, max_seq: int) -> Callable:
        """``fn(offset, tok, pos, *cache_leaves) ->
        (toks[b, seg_len], tok', pos', *cache_leaves')`` — ``seg_len``
        per-slot decode steps (vector ``pos``: slots may sit at different
        depths).  Slot axis leads every buffer: the runtime slices it.

        The slot-leading leaves are copied into the model's batch layout
        once per segment and back once (the decode kernel reads a
        contiguous cache); the donated leaves are written back in place and
        returned as the outputs.  ``max_seq`` is the slots' timeline
        length (see ``_decode_loop``); ``bucket`` the group's, its loop's
        scope."""
        key = (seg_len, bucket, max_seq)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        decode = make_decode_step(self.cfg, self.api)

        def seg(offset, tok, pos, *leaves):
            views = self._cache_in(leaves, paged=False)
            loop = self._decode_bind(decode, seg_len, bucket, max_seq, tok, pos, views)
            toks, tok, pos = loop()
            self._copy_back(views, loop.statics["cache"])
            return (toks, tok, pos, *leaves)

        self._seg_fns[key] = graphs.passthrough(seg)
        return seg

    def paged_segment_kernel(self, seg_len: int, bucket: int) -> Callable:
        """Paged variant of :meth:`segment_kernel`: ``fn(offset, tok, pos,
        table, *pool_leaves) -> (toks, tok', pos', *pool_leaves')``.  Pool
        leaves are block-leading ``(n_blocks, layers, block_len, ...)``; the
        per-slot block table is broadcast across the layer axis so each
        layer's cache view carries it, and the decode path
        (``attention._paged_write`` / ``cached_attention``) recognizes the
        ``"table"`` leaf and resolves physical blocks.  The pool is not
        copied per segment: each layer reads and writes its strided view of
        the loop's pool buffers in place, and those are the outputs: buffers
        of ``bucket``'s scope, whose next segment takes them back."""
        key = ("paged", seg_len, bucket)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        decode = make_decode_step(self.cfg, self.api)

        def seg(offset, tok, pos, table, *leaves):
            loop = self._decode_bind(decode, seg_len, bucket, None, tok, pos,
                                     self._cache_in(leaves, paged=True), table)
            toks, tok, pos = loop()
            return (toks, tok, pos, *loop.statics["cache"])

        self._seg_fns[key] = graphs.passthrough(seg)
        return seg

    # ------------------------------------------------- mixed-phase kernels
    #
    # Chunked prefill: the decode segment Program doubles as the prefill
    # engine.  Each segment first advances every still-prefilling slot's
    # cursor by one chunk, then runs the ordinary decode loop over all
    # slots.  The JAX package gates the chunk stage with ``lax.cond`` on the
    # device cursors inside its jitted scan; here the batcher, which
    # mirrors every cursor on the host (``req.chunk_pos``), passes the
    # decision as the Program's one scalar argument, so no segment reads
    # the card back, and the segment replays one of its scope's two loops:
    # the chunk stage, the decode loop and the restores of still-prefilling
    # slots in one graph, or the same without the chunk stage.  A slot whose
    # prefill completes in a segment emits only ``ctok`` (its first token,
    # from the chunk's final prompt row) that segment and decodes from the
    # next one: the decode loop's phase mask is the cursor as of segment
    # entry, and still-prefilling slots' token/pos carries are restored
    # after the loop (their in-loop decode writes land at positions >=
    # bucket, which real decode overwrites before anything attends them).

    def _bind_entry(self, entries: dict, chosen, device, bucket: int) -> graphs.Loop:
        """Bind loop ``entries[chosen]`` (``(name, steps, ints, inputs,
        body)``) in ``bucket``'s scope.  On graphs every entry of the scope
        is captured at its first bind, before its buffers hold a cache, so
        that no capture warms up on clones of a live cache whichever entry
        a later segment takes."""
        if self.graphs is not None and self.graphs.accepts(device):
            for k, e in entries.items():
                if k != chosen:
                    self.graphs.capture(*e, self._consts(), self._scope(bucket))
        return self._bind(*entries[chosen], bucket)

    @staticmethod
    def _chunk_stage(chunk, params, cache, tok, pcur, ptoks, run_chunk: bool):
        """The chunk stage on ``cache`` (or, without it, its neutral
        outputs): (ctok, pcur')."""
        if not run_chunk:
            return torch.zeros_like(tok), pcur.clone()
        ctok, pcur2, _ = chunk(params, cache, ptoks, pcur)
        return ctok, pcur2

    def _mixed_bind(self, decode, chunk, seg_len: int, bucket: int, chunk_len: int, cap,
                    run_chunk: bool, tok, pos, pcur, ptoks, cache_in, table=None):
        """One mixed segment as a bound loop over (tok, pos, pcur, ptoks,
        the cache and, paged, the table) in ``bucket``'s scope: the chunk
        stage (when ``run_chunk``), ``seg_len`` decode steps and the
        restores.  The loop returns (toks, tok', pos', pcur', ctok)."""
        paged = table is not None
        inputs = {"tok": tok, "pos": pos, "pcur": pcur, "ptoks": ptoks, "cache": cache_in}
        if paged:
            inputs["table"] = table

        def entry(with_chunk: bool):
            def body(st, n):
                cache = self._cache_tree(st["cache"], st.get("table"))
                tok, pos, pcur = st["tok"], st["pos"], st["pcur"]
                decoding = pcur >= bucket  # (b, 1), phase at segment entry
                ctok, pcur2 = self._chunk_stage(chunk, self.params, cache, tok, pcur,
                                                st["ptoks"], with_chunk)
                toks, tok2, pos2 = self._decode_loop(decode, n, tok, pos, cache, cap=cap)
                completed = ~decoding & (pcur2 >= bucket)
                tok_out = torch.where(decoding, tok2, torch.where(completed, ctok, tok))
                pos_out = torch.where(decoding, pos2, pos)
                return toks, tok_out, pos_out, pcur2, ctok

            return ("mixed+chunk" if with_chunk else "mixed", seg_len,
                    (cap, paged, chunk_len), inputs, body)

        return self._bind_entry({c: entry(c) for c in (True, False)}, run_chunk,
                                tok.device, bucket)

    def mixed_segment_kernel(self, seg_len: int, bucket: int, chunk_len: int,
                             max_seq: int) -> Callable:
        """``fn(offset, tok, pos, pcur, ptoks, *cache_leaves, run_chunk) ->
        (toks[b, seg_len], tok', pos', pcur', ctok, *cache_leaves')``: one
        chunk stage (when ``run_chunk``) and ``seg_len`` decode steps.
        ``pcur``: (b, 1) prefill cursor (``>= bucket``: decoding);
        ``ptoks``: (b, bucket) padded-prompt buffer (a pure input, uploaded
        once per join and served from the transfer cache after)."""
        key = ("mixed", seg_len, bucket, chunk_len, max_seq)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        decode = make_decode_step(self.cfg, self.api)
        chunk = make_chunk_step(self.cfg, self.api, bucket, chunk_len)

        def seg(offset, tok, pos, pcur, ptoks, *rest):
            *leaves, run_chunk = rest
            views = self._cache_in(leaves, paged=False)
            loop = self._mixed_bind(decode, chunk, seg_len, bucket, chunk_len, max_seq,
                                    run_chunk, tok, pos, pcur, ptoks, views)
            outs = loop()
            self._copy_back(views, loop.statics["cache"])
            return (*outs, *leaves)

        self._seg_fns[key] = graphs.passthrough(seg)
        return seg

    def paged_mixed_segment_kernel(self, seg_len: int, bucket: int,
                                   chunk_len: int) -> Callable:
        """Paged variant: ``fn(offset, tok, pos, pcur, ptoks, table,
        *pool_leaves, run_chunk) -> (toks, tok', pos', pcur', ctok,
        *pool_leaves')``.  Chunk writes resolve physical blocks through the
        table like decode writes (invalid rows land in the sink block);
        chunk rows gather the slot's blocks to the logical layout."""
        key = ("paged_mixed", seg_len, bucket, chunk_len)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        decode = make_decode_step(self.cfg, self.api)
        chunk = make_chunk_step(self.cfg, self.api, bucket, chunk_len)

        def seg(offset, tok, pos, pcur, ptoks, table, *rest):
            *leaves, run_chunk = rest
            loop = self._mixed_bind(decode, chunk, seg_len, bucket, chunk_len, None, run_chunk,
                                    tok, pos, pcur, ptoks, self._cache_in(leaves, paged=True),
                                    table)
            outs = loop()
            return (*outs, *loop.statics["cache"])

        self._seg_fns[key] = graphs.passthrough(seg)
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

        self._prefill_fns[max_seq] = pre if self.graphs is not None else graphs.passthrough(pre)
        return pre

    # ------------------------------------------------- speculative kernels
    #
    # The JAX package's segment branches on its ``spec_on`` input with
    # ``lax.cond`` on the device.  Here the batcher, which sets the flag at
    # submit (``SpecGate``), passes its host value as a Program argument
    # beside the buffer (kept, unread, so that transfers match the JAX
    # package's), and the branch is taken in Python: no segment reads the
    # card back.  The draft cache is contiguous whatever the target's
    # layout, so the draft/verify step clamps its writes at ``max_seq``, and
    # its first draft step keeps the prompt's entries as prefill wrote them
    # (``prompt_len``: the bucket).

    def _spec_step(self, max_seq: int, bucket: int):
        return make_draft_verify_step(self.cfg, self.api, self.draft.cfg, self.dapi,
                                      self.draft.k, cap=max_seq, prompt_len=bucket)

    def _spec_scan(self, seg_len: int, step, tok, ptok, pos, tcache, dcache):
        """Shared draft/verify segment body: ``seg_len`` speculative steps,
        each emitting 1..k+1 tokens, cursor-scattered into one flat
        ``(b, seg_len*(k+1))`` buffer.  Beyond each slot's final cursor the
        buffer holds rejected rows' argmaxes; harvest reads only
        ``buf[:cnt]``.  Returns (buf, cnt, tok', ptok', pos')."""
        k = self.draft.k
        b, dev = tok.shape[0], tok.device
        buf = torch.zeros((b, seg_len * (k + 1)), dtype=torch.int32, device=dev)
        cur = torch.zeros((b,), dtype=torch.int32, device=dev)
        rows = torch.arange(k + 1, device=dev)
        p = pos[:, 0]
        for _ in range(seg_len):
            y, cnt, tok, ptok, p, tcache, dcache = step(self.params, self.draft.params,
                                                        tcache, dcache, tok, ptok, p)
            # All k+1 rows land at the cursor; the next step's scatter (at
            # cur + cnt) overwrites the rejected overhang.
            buf.scatter_(1, cur[:, None].long() + rows, y)
            cur = cur + cnt
        return buf, cur[:, None], tok, ptok, p[:, None]

    def _plain_scan(self, seg_len: int, decode, tok, ptok, pos, tcache, cap):
        """Bypass branch of the speculative segment: ``seg_len`` plain
        decode steps on the target cache only, shaped like
        :meth:`_spec_scan`'s outputs (``cnt = seg_len``, tokens in
        ``buf[:seg_len]``).  Greedy decode emits the bits the draft/verify
        path would; the draft cache is untouched (its staleness on a later
        re-probe only lowers the acceptance rate)."""
        k = self.draft.k
        b, dev = tok.shape[0], tok.device
        toks, tok2, pos2 = self._decode_loop(decode, seg_len, tok, pos, tcache, cap=cap)
        buf = torch.zeros((b, seg_len * (k + 1)), dtype=torch.int32, device=dev)
        buf[:, :seg_len] = toks
        cnt = torch.full((b, 1), seg_len, dtype=torch.int32, device=dev)
        # tok2's predecessor: the segment's second-to-last emission (or the
        # incoming tok for seg_len 1), what the first draft step re-decodes
        # when speculation resumes.
        ptok2 = toks[:, seg_len - 2:seg_len - 1] if seg_len > 1 else tok
        return buf, cnt, tok2, ptok2, pos2

    def _spec_bind(self, step, decode, seg_len: int, bucket: int, max_seq: int,
                   spec_on: bool, tok, ptok, pos, leaves, table=None, mixed=None):
        """The segment's speculative scan (draft/verify, by the host's
        ``spec_on``) or its bypass (plain decode) as one bound loop over
        (tok, ptok, pos, the target cache, the draft cache, and, paged, the
        table) in ``bucket``'s scope.  ``mixed`` (the mixed layouts: the
        chunk steps of both models, pcur, ptoks and the host's
        ``run_chunk``) adds pcur and ptoks to the inputs and, when
        ``run_chunk``, the chunk stage to the loop: it advances both
        caches' prompts on the loop's buffers (the target through the
        bitwise chunk path, the draft through the same masked chunk path,
        its logits discarded) before the scan, and the loop restores
        still-prefilling slots after it; a slot completing its prefill
        leaves with ``tok' = ctok`` and ``ptok' = ptoks[:, bucket-1]`` (the
        prompt's last token, which the first draft step re-decodes).
        Returns (loop, the target's inputs, the draft's inputs); the loop
        returns (buf, cnt, tok', ptok', pos') and, mixed, (pcur', ctok).
        The draft cache is contiguous whatever the target's layout: copied
        in and written back (:meth:`_spec_done`).  Every entry a segment of
        this server may take (spec or bypass when gated, with or without a
        chunk stage when mixed) is captured at the scope's first bind,
        before its buffers hold a cache."""
        paged = table is not None
        nt = len(self.bax_leaves)
        t_in = self._cache_in(leaves[:nt], paged)
        d_in = [x.movedim(0, a) for x, a in zip(leaves[nt:], self.dbax_leaves)]
        inputs = {"tok": tok, "ptok": ptok, "pos": pos, "cache": t_in, "draft": d_in}
        if mixed is not None:
            chunk, dchunk, pcur, ptoks, run_chunk = mixed
            inputs.update(pcur=pcur, ptoks=ptoks)
        if paged:
            inputs["table"] = table
        cap = None if paged else max_seq

        def entry(on: bool, with_chunk: bool):
            def body(st, n):
                tcache = self._cache_tree(st["cache"], st.get("table"))
                dcache = self._unflatten(st["draft"], self.dbax)
                tok, ptok, pos = st["tok"], st["ptok"], st["pos"]
                if mixed is not None:
                    pcur, ptoks = st["pcur"], st["ptoks"]
                    decoding = pcur >= bucket  # (b, 1), phase at segment entry
                    ctok, pcur2 = self._chunk_stage(chunk, self.params, tcache, tok, pcur,
                                                    ptoks, with_chunk)
                    if with_chunk:
                        dchunk(self.draft.params, dcache, ptoks, pcur)
                if on:
                    outs = self._spec_scan(n, step, tok, ptok, pos, tcache, dcache)
                else:
                    outs = self._plain_scan(n, decode, tok, ptok, pos, tcache, cap)
                if mixed is None:
                    return outs
                buf, cnt, tok2, ptok2, pos2 = outs
                completed = ~decoding & (pcur2 >= bucket)
                last_ptok = ptoks[:, bucket - 1:bucket]
                tok_out = torch.where(decoding, tok2, torch.where(completed, ctok, tok))
                ptok_out = torch.where(decoding, ptok2,
                                       torch.where(completed, last_ptok, ptok))
                pos_out = torch.where(decoding, pos2, pos)
                return buf, cnt, tok_out, ptok_out, pos_out, pcur2, ctok

            name = ("spec" if on else "spec_bypass") + ("_mixed" if mixed is not None else "")
            return (name + ("+chunk" if with_chunk else ""), seg_len,
                    (self.draft.k, max_seq, paged), inputs, body)

        ons = (True, False) if self.draft.auto_bypass else (spec_on,)
        chunks = (True, False) if mixed is not None else (False,)
        entries = {(on, c): entry(on, c) for on in ons for c in chunks}
        loop = self._bind_entry(entries, (spec_on, mixed is not None and run_chunk),
                                tok.device, bucket)
        return loop, t_in, d_in

    def _spec_done(self, loop, leaves, t_in, d_in, paged: bool) -> list:
        """Write the contiguous caches back from the loop's buffers; the
        segment's output leaves (a paged target's are the loop's pool
        buffers)."""
        nt = len(self.bax_leaves)
        if not paged:
            self._copy_back(t_in, loop.statics["cache"])
        self._copy_back(d_in, loop.statics["draft"])
        return (list(loop.statics["cache"]) if paged else list(leaves[:nt])) + list(leaves[nt:])

    def spec_segment_kernel(self, seg_len: int, bucket: int, max_seq: int) -> Callable:
        """Speculative variant of :meth:`segment_kernel`: ``fn(offset, tok,
        ptok, pos, *target_leaves, *draft_leaves, spec_on_buf, spec_on) ->
        (toks[b, seg_len*(k+1)], cnt[b, 1], tok', ptok', pos', *leaves')``.
        Each step drafts ``k`` candidates and verifies them in one multi-row
        decode; slots advance 1..k+1 positions a step, ``cnt`` reporting how
        many of the flat token buffer's entries are real."""
        return self._spec_kernel("spec", seg_len, bucket, 0, max_seq)

    def paged_spec_segment_kernel(self, seg_len: int, bucket: int, max_seq: int) -> Callable:
        """Paged-target speculative segment: ``fn(offset, tok, ptok, pos,
        table, *pool_leaves, *draft_leaves, spec_on_buf, spec_on) -> (toks,
        cnt, tok', ptok', pos', *pool_leaves', *draft_leaves')``.  The
        target resolves physical blocks through the table as
        :meth:`paged_segment_kernel` does; the draft cache stays
        contiguous."""
        return self._spec_kernel("paged_spec", seg_len, bucket, 0, max_seq)

    def _spec_kernel(self, kind: str, seg_len: int, bucket: int, chunk_len: int,
                     max_seq: int) -> Callable:
        """The four speculative segment kernels (``kind``: spec, paged_spec,
        spec_mixed, paged_spec_mixed), in the JAX package's buffer
        orders."""
        paged, mixed = kind.startswith("paged"), kind.endswith("mixed")
        key = (kind, seg_len, bucket, chunk_len, max_seq)
        fn = self._seg_fns.get(key)
        if fn is not None:
            return fn
        step = self._spec_step(max_seq, bucket)
        decode = make_decode_step(self.cfg, self.api)
        if mixed:
            chunk = make_chunk_step(self.cfg, self.api, bucket, chunk_len)
            dchunk = make_chunk_step(self.draft.cfg, self.dapi, bucket, chunk_len)

        def body(tok, ptok, pos, pcur, ptoks, table, rest):
            if mixed:
                *leaves, _spec_on_buf, run_chunk, spec_on = rest
            else:
                *leaves, _spec_on_buf, spec_on = rest
            loop, t_in, d_in = self._spec_bind(
                step, decode, seg_len, bucket, max_seq, spec_on, tok, ptok, pos, leaves, table,
                (chunk, dchunk, pcur, ptoks, run_chunk) if mixed else None)
            outs = loop()
            return (*outs, *self._spec_done(loop, leaves, t_in, d_in, paged))

        if mixed and paged:
            def seg(offset, tok, ptok, pos, pcur, ptoks, table, *rest):
                return body(tok, ptok, pos, pcur, ptoks, table, rest)
        elif mixed:
            def seg(offset, tok, ptok, pos, pcur, ptoks, *rest):
                return body(tok, ptok, pos, pcur, ptoks, None, rest)
        elif paged:
            def seg(offset, tok, ptok, pos, table, *rest):
                return body(tok, ptok, pos, None, None, table, rest)
        else:
            def seg(offset, tok, ptok, pos, *rest):
                return body(tok, ptok, pos, None, None, None, rest)

        self._seg_fns[key] = graphs.passthrough(seg)
        return seg

    def spec_mixed_segment_kernel(self, seg_len: int, bucket: int, chunk_len: int,
                                  max_seq: int) -> Callable:
        """Speculative mixed segment: ``fn(offset, tok, ptok, pos, pcur,
        ptoks, *target_leaves, *draft_leaves, spec_on_buf, run_chunk,
        spec_on) -> (toks, cnt, tok', ptok', pos', pcur', ctok,
        *leaves')``."""
        return self._spec_kernel("spec_mixed", seg_len, bucket, chunk_len, max_seq)

    def paged_spec_mixed_segment_kernel(self, seg_len: int, bucket: int, chunk_len: int,
                                        max_seq: int) -> Callable:
        """Paged-target speculative mixed segment: ``fn(offset, tok, ptok,
        pos, pcur, ptoks, table, *pool_leaves, *draft_leaves, spec_on_buf,
        run_chunk, spec_on) -> (toks, cnt, tok', ptok', pos', pcur', ctok,
        *leaves')``."""
        return self._spec_kernel("paged_spec_mixed", seg_len, bucket, chunk_len, max_seq)

    def spec_prefill_kernel(self, max_seq: int) -> Callable:
        """Prefill for speculative slots: the target *and* the draft prefill
        over the same prompt rows, so a joining slot lands with both caches
        populated through the prompt.  ``fn(offset, tokens) -> (tok0, ptok0,
        *target_leaves, *draft_leaves)`` where ``ptok0`` is the padded
        prompt's last token (position ``bucket - 1``), the predecessor the
        first draft step rewrites."""
        key = ("spec", max_seq)
        fn = self._prefill_fns.get(key)
        if fn is not None:
            return fn
        prefill = make_prefill_step(self.cfg, self.api)
        dprefill = make_prefill_step(self.draft.cfg, self.dapi)
        cfg, api, params = self.cfg, self.api, self.params
        dcfg, dapi, dparams = self.draft.cfg, self.dapi, self.draft.params

        def pre(offset, tokens):
            b, dev = tokens.shape[0], tokens.device
            cache = zeros_cache(cfg, api, b, max_seq, device=dev)
            tok, cache = prefill(params, {"tokens": tokens}, cache)
            dcache = zeros_cache(dcfg, dapi, b, max_seq, device=dev)
            _, dcache = dprefill(dparams, {"tokens": tokens}, dcache)
            ptok = tokens[:, -1:].to(torch.int32)
            tl = [x.movedim(a, 0) for x, a in zip(tree_leaves(cache), self.bax_leaves)]
            dl = [x.movedim(a, 0) for x, a in zip(tree_leaves(dcache), self.dbax_leaves)]
            return (tok, ptok, *tl, *dl)

        self._prefill_fns[key] = pre if self.graphs is not None else graphs.passthrough(pre)
        return pre


class BatchGroup:
    """One live continuous batch for one bucket.  All mutating methods are
    called from the server's single batcher thread; the runtime's worker
    threads only touch the handles (and fire done-callbacks)."""

    def __init__(self, kernels: ModelKernels, runtime, scheduler,
                 bucket: int, n_slots: int, seg_len: int, max_seq: int,
                 chunk_len: int = 0, target=None) -> None:
        self.kernels = kernels
        self.runtime = runtime
        self.scheduler = scheduler
        self.bucket = bucket
        self.n_slots = n_slots
        self.seg_len = seg_len
        self.max_seq = max_seq
        self.chunk_len = int(chunk_len)  # 0 = whole-prompt prefill Programs
        self.spec_k = kernels.spec_k  # draft depth; 0 = speculation off
        # Device groups this batch's runs are pinned to (None = all runtime
        # groups).
        self.target = list(target) if target else None
        self.spec_gate = None  # set by the server when drafting (SpecGate)
        self._seg_mode = "spec" if self.spec_k else "plain"
        self.slots: List[Optional[object]] = [None] * n_slots  # _Request per slot
        self.dead = False
        self.tokens_written = 0  # KV positions actually written (memory_stats)
        self.last_run_metrics: dict = {}
        self.telemetry = None  # set by the owning InferenceServer
        self.pin = self._pinned_mirrors()
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

    def _pinned_mirrors(self) -> bool:
        """Whether this batch's cache mirrors are page-locked: on a CUDA
        group (the reference has no counterpart; pinning changes no bits)."""
        groups = self.target or self.runtime.groups
        return any(g.device.type == "cuda" for g in groups)

    def _build_segment_program(self) -> None:
        """Contiguous layout: slot-leading mirrors, ping-pong in/out pairs
        (PagedBatchGroup overrides this with pool buffers + block table)."""
        kernels, n_slots, seg_len = self.kernels, self.n_slots, self.seg_len
        tok = torch.zeros((n_slots, 1), dtype=torch.int32)
        pos = torch.zeros((n_slots, 1), dtype=torch.int32)
        leaves = kernels.leaf_mirrors(n_slots, self.max_seq, self.pin)
        if self.chunk_len:
            self._build_mixed_program(tok, pos, leaves)
            return
        if self.spec_k:
            self._build_spec_program(
                [tok, None, pos],
                leaves + kernels.draft_leaf_mirrors(n_slots, self.max_seq, self.pin),
                kernels.spec_segment_kernel(seg_len, self.bucket, self.max_seq),
                f"spec_seg{seg_len}_k{self.spec_k}")
            return
        toks_seg = torch.zeros((n_slots, seg_len), dtype=torch.int32)
        prog = Program().in_(tok).in_(pos)
        for b in leaves:
            prog.in_(b)
        prog.out(toks_seg).out(torch.zeros_like(tok)).out(torch.zeros_like(pos))
        for b in leaves:
            prog.out(host_zeros_like(b))
        prog.kernel(kernels.segment_kernel(seg_len, self.bucket, self.max_seq), f"decode_seg{seg_len}")
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

    def _build_spec_program(self, ctl, leaves, kernel, label: str, *, n_carried: int = 3,
                            ctok_out=None) -> None:
        """A speculative segment Program in the JAX package's buffer order:
        ``[tok, ptok, pos, *rest_of_ctl, *leaves, spec_on] -> [toks, cnt,
        tok', ptok', pos', *carried', (ctok), *leaves']``.  ``ctl`` lists
        the control inputs (``None`` marks ``ptok``, made here); the first
        ``n_carried`` ping-pong, the rest are pure inputs (the mixed
        layouts' ``ptoks``, the paged block table).  The token buffer widens
        to the per-segment emission cap ``seg_len*(k+1)`` with a per-slot
        count of how much is real; ``spec_on`` rides last, after every
        donated leaf, so the donate range and the leaf slices stay where
        they are (the kernel reads the host's flag, its Program argument:
        :meth:`submit_segment`).  Every cache leaf is donated; target leaves
        ping-pong, and so do the draft's."""
        n_slots, k = self.n_slots, self.spec_k
        ctl = [torch.zeros((n_slots, 1), dtype=torch.int32) if b is None else b for b in ctl]
        prog = Program()
        for b in ctl + leaves:
            prog.in_(b)
        self._spec_on = torch.ones((n_slots, 1), dtype=torch.int32)
        prog.in_(self._spec_on)
        prog.out(torch.zeros((n_slots, self.seg_len * (k + 1)), dtype=torch.int32))
        prog.out(torch.zeros((n_slots, 1), dtype=torch.int32))  # cnt
        for b in ctl[:n_carried]:
            prog.out(host_zeros_like(b))
        if ctok_out is not None:
            prog.out(torch.zeros((n_slots, 1), dtype=torch.int32))
        for b in leaves:
            prog.out(host_zeros_like(b))
        prog.kernel(kernel, label)
        prog.args(*((False,) if self.chunk_len else ()), True)
        first = len(ctl)
        prog.donate(*range(first, first + len(leaves)))
        prog.work_items(n_slots, 1)
        self.prog = prog
        self.n_leaves = len(leaves)
        # toks (out 0) and cnt (out 1) are read-only harvest buffers.
        out0 = 2 + n_carried + (ctok_out is not None)
        self._swap_pairs = [(i, 2 + i) for i in range(n_carried)] + [
            (first + i, out0 + i) for i in range(self.n_leaves)
        ]
        if ctok_out is not None:
            self._ctok_out = ctok_out

    def _build_mixed_program(self, tok, pos, leaves) -> None:
        """Mixed-phase (chunked-prefill) segment Program, in the JAX
        package's buffer order ``[tok, pos, pcur, ptoks, *leaves] ->
        [toks, tok', pos', pcur', ctok, *leaves']``.  ``pcur`` (the per-slot
        prefill cursor) is ping-ponged, initialized to ``bucket`` so empty
        slots read as decoding; ``ptoks`` (the padded prompts) is a pure
        non-donated input, one upload per join; ``ctok`` (each slot's first
        generated token, meaningful the segment its prefill completes) is a
        pure output, never swapped.  The chunk-stage flag rides as the
        Program's scalar argument (:meth:`submit_segment`)."""
        kernels, n_slots, seg_len = self.kernels, self.n_slots, self.seg_len
        pcur = torch.full((n_slots, 1), self.bucket, dtype=torch.int32)
        ptoks = torch.zeros((n_slots, self.bucket), dtype=torch.int32)
        if self.spec_k:
            self._build_spec_program(
                [tok, None, pos, pcur, ptoks],
                leaves + kernels.draft_leaf_mirrors(n_slots, self.max_seq, self.pin),
                kernels.spec_mixed_segment_kernel(seg_len, self.bucket, self.chunk_len,
                                                  self.max_seq),
                f"spec_mixed_seg{seg_len}_b{self.bucket}_c{self.chunk_len}_k{self.spec_k}",
                n_carried=4, ctok_out=6)
            return
        toks_seg = torch.zeros((n_slots, seg_len), dtype=torch.int32)
        prog = Program().in_(tok).in_(pos).in_(pcur).in_(ptoks)
        for b in leaves:
            prog.in_(b)
        prog.out(toks_seg).out(torch.zeros_like(tok)).out(torch.zeros_like(pos))
        prog.out(torch.zeros_like(pcur)).out(torch.zeros_like(tok))  # pcur', ctok
        for b in leaves:
            prog.out(host_zeros_like(b))
        prog.kernel(kernels.mixed_segment_kernel(seg_len, self.bucket, self.chunk_len,
                                                 self.max_seq),
                    f"mixed_seg{seg_len}_b{self.bucket}_c{self.chunk_len}")
        prog.args(False)
        prog.donate(*range(4, 4 + len(leaves)))
        prog.work_items(n_slots, 1)
        self.prog = prog
        self.n_leaves = len(leaves)
        self._swap_pairs = [(0, 1), (1, 2), (2, 3)] + [
            (4 + i, 5 + i) for i in range(self.n_leaves)
        ]
        self._ctok_out = 4

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
        first_leaf = (3 if self.spec_k else 2) + (2 if self.chunk_len else 0)
        allocated = sum(b.nbytes for b in self.prog._ins[first_leaf:first_leaf + self.n_leaves])
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
        if self.chunk_len:
            # Chunked mode: there is no prefill Program.  Joining slots are
            # armed host-side (merge) and the segment kernel's chunk stage
            # does the prefill compute.  Planning still runs (the paged
            # override pins whole-prompt cache hits there); the join state
            # machine completes through an already-done handle.
            from repro_torch.serve.paged import _DoneHandle

            self._plan_prefill(requests)
            self._prefill_prog = None
            h = _DoneHandle()
            self.prefill_handle = h
            h.add_done_callback(lambda _h: notify())
            return
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
            if self.spec_k:
                prog.out(torch.zeros((j, 1), dtype=torch.int32))  # ptok0
                for b in (self.kernels.leaf_mirrors(j, self.max_seq, self.pin)
                          + self.kernels.draft_leaf_mirrors(j, self.max_seq, self.pin)):
                    prog.out(b)
                prog.kernel(self.kernels.spec_prefill_kernel(self.max_seq),
                            f"spec_prefill_{self.bucket}")
            else:
                for b in self.kernels.leaf_mirrors(j, self.max_seq, self.pin):
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
        if self.chunk_len:
            return self._merge_chunked(wave, seconds)
        free = self.free_slots()
        if self.spec_k:
            tok_b, ptok_b, pos_b = self.prog._ins[:3]
            leaf_bufs = self.prog._ins[3:3 + self.n_leaves]
            tok0, ptok0 = prog._outs[0], prog._outs[1]
            wave_leaves = prog._outs[2:]
        else:
            tok_b, ptok_b, pos_b = self.prog._ins[0], None, self.prog._ins[1]
            leaf_bufs = self.prog._ins[2:]
            tok0, ptok0 = prog._outs[0], None
            wave_leaves = prog._outs[1:]
        for i, req in enumerate(wave):
            slot = free.pop(0)
            tok_b[slot, 0] = tok0[i, 0]
            if ptok_b is not None:
                ptok_b[slot, 0] = ptok0[i, 0]
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

    def _merge_chunked(self, wave, seconds: float) -> dict:
        """Board a chunked join wave without a prefill Program: arm each
        request's slot for the segment kernel's chunk stage (cursor 0,
        prompt row uploaded, position leaves reset to −1: a chunked join
        writes no full row, and stale k/v under kpos −1 is never attended,
        so the big value leaves stay device-resident) and defer
        ``req.board`` to the harvest of the segment whose chunk completes
        the prompt (``ctok``)."""
        free = self.free_slots()
        if self.spec_k:
            tok_b, ptok_b, pos_b, pcur_b, ptoks_b = self.prog._ins[:5]
            leaf_bufs = self.prog._ins[5:5 + self.n_leaves]
            neg = (self.kernels.leaf_neg_init(self.max_seq)
                   + self.kernels.draft_leaf_neg_init(self.max_seq))
        else:
            tok_b, ptok_b, pos_b = self.prog._ins[0], None, self.prog._ins[1]
            pcur_b, ptoks_b = self.prog._ins[2], self.prog._ins[3]
            leaf_bufs = self.prog._ins[4:]
            neg = self.kernels.leaf_neg_init(self.max_seq)
        for req in wave:
            slot = free.pop(0)
            tok_b[slot, 0] = 0
            if ptok_b is not None:
                ptok_b[slot, 0] = int(req.prompt[-1])
            pos_b[slot, 0] = self.bucket
            pcur_b[slot, 0] = 0
            ptoks_b[slot, :] = torch.from_numpy(req.prompt)
            for dst, is_neg in zip(leaf_bufs, neg):
                if is_neg:
                    dst[slot] = -1
            self.slots[slot] = req
            req.slot = slot
            req.chunk_pos = 0
        for b in (tok_b, ptok_b, pos_b, pcur_b, ptoks_b):
            if b is not None:
                self.prog.invalidate(b)
        for dst, is_neg in zip(leaf_bufs, neg):
            if is_neg:
                self.prog.invalidate(dst)
        return {"joined": len(wave), "failed": [], "seconds": seconds}

    # ------------------------------------------------------------ segments
    def submit_segment(self, notify: Callable) -> None:
        """Chain the next decode segment after the previous one.  The swap
        epilogue runs worker-side, so the just-produced token/pos/cache
        buffers become the next segment's inputs *device-resident*."""
        assert self.seg_handle is None
        spec = ()
        if self.spec_k:
            spec = (True,)
            if self.spec_gate is not None:
                # SpecGate auto-bypass: decide this segment's mode; the
                # spec_on buffer is rewritten (one small re-upload) only
                # when the mode changes, as in the JAX package.
                want = 1 if self.spec_gate.decide(self.bucket) else 0
                if int(self._spec_on[0, 0]) != want:
                    self._spec_on[:] = want
                    self.prog.invalidate(self._spec_on)
                self._seg_mode = "spec" if want else "plain"
                spec = (bool(want),)

        def epilogue(prog=self.prog, pairs=self._swap_pairs):
            for i_in, i_out in pairs:
                prog.swap_buffers(i_in, i_out)

        if self.chunk_len:
            # The chunk stage runs iff some slot is still prefilling (its
            # host-mirrored cursor short of the bucket).  The kernel reads
            # the flags when the segment runs; they stay unchanged until the
            # harvest, since the next segment is submitted only after it.
            self.prog.args(any(r.chunk_pos < self.bucket for _, r in self.active()), *spec)
        elif spec:
            self.prog.args(*spec)
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
        cnt = self.prog._outs[1] if self.spec_k else None
        n_active = 0
        finished = []
        emitted = drafted = accepted = delivered = chunk_tokens = 0
        tr = tracer()
        traced = tr.enabled
        for slot, req in self.active():
            if self.chunk_len and req.chunk_pos < self.bucket:
                # Prefilling at segment entry: the chunk stage advanced the
                # cursor deterministically; mirror it host-side.  On the
                # segment whose chunk reaches the bucket boundary the
                # slot's first token is in ctok (a pure, never-swapped
                # output whose host mirror the write-back refreshed); it
                # boards here and decodes from the next segment on.
                old = req.chunk_pos
                req.chunk_pos = min(old + self.chunk_len, self.bucket)
                chunk_tokens += req.chunk_pos - old
                if traced:
                    tr.async_instant("prefill_chunk", req.seq, slot=slot,
                                     cursor=req.chunk_pos, tokens=req.chunk_pos - old)
                if req.chunk_pos >= self.bucket:
                    ctok = self.prog._outs[self._ctok_out]
                    req.board(slot, int(ctok[slot, 0]))
                    delivered += 1
                    if traced:
                        tr.async_instant("first_token", req.seq, slot=slot)
                    self.tokens_written += min(self.bucket, self.max_seq)
                    self._on_chunk_complete(slot, req)
                    if req.remaining() <= 0:
                        finished.append(req)
                        self.release_slot(slot)
                continue
            n_active += 1
            need = req.remaining()
            if self.spec_k:
                # Ragged emission: this segment produced c tokens for the
                # slot (seg_len steps, each 1 + its accepted draft depth).
                # A bypassed (plain) segment reports c = seg_len and adds
                # nothing to the draft accounting: plain segments must not
                # pollute the acceptance EMA.
                c = int(cnt[slot, 0])
                take = toks_seg[slot, : min(c, need)].tolist()
                emitted += c
                if self._seg_mode == "spec":
                    d, a = self.spec_k * self.seg_len, c - self.seg_len
                    drafted += d
                    accepted += a
                    req.note_spec(d, a)
                else:
                    d = a = 0
                if traced:
                    tr.async_instant("decode_segment", req.seq, slot=slot,
                                     tokens=len(take), drafted=d, accepted=a)
            else:
                take = toks_seg[slot, : min(self.seg_len, need)].tolist()
                if traced:
                    tr.async_instant("decode_segment", req.seq, slot=slot,
                                     tokens=len(take))
            req.extend(take)
            delivered += len(take)
            if req.remaining() <= 0:
                finished.append(req)
                self.release_slot(slot)
        self.tokens_written += emitted if self.spec_k else n_active * self.seg_len
        if traced and self._seg_tr0:
            tr.complete("segment", self._seg_tr0, self._seg_tr0 + seconds,
                        track="batcher", bucket=self.bucket,
                        n_active=n_active, finished=len(finished),
                        chunk_tokens=chunk_tokens)
            self._seg_tr0 = 0.0
        if self.telemetry is not None and chunk_tokens:
            self.telemetry.count("chunk_tokens", chunk_tokens)
        res = {"n_active": n_active, "finished": finished, "seconds": seconds,
               "tokens": delivered}
        if self.spec_k:
            res["drafted"], res["accepted"] = drafted, accepted
            res["mode"] = self._seg_mode
        if self.chunk_len:
            res["chunk_tokens"] = chunk_tokens
        return res

    def _on_chunk_complete(self, slot: int, req) -> None:
        """Hook fired when a slot's chunked prefill completes (its prompt KV
        is now fully written).  The paged override registers the slot's
        prompt blocks with the prefix cache here, the earliest moment their
        content is valid to share."""

    def release_slot(self, slot: int) -> None:
        """Free one KV slot (request retired or failed).  The paged variant
        additionally releases the slot's blocks and re-points its table at
        the sink block."""
        self.slots[slot] = None

    # ------------------------------------------------------------ migration
    def at_boundary(self) -> bool:
        """True between runs: no segment or prefill in flight, so the host
        mirrors are the authoritative slot state (every package was written
        back and the epilogue swap ran)."""
        return self.seg_handle is None and self.prefill_handle is None

    def can_accept_migration(self, src: "BatchGroup", slot: int) -> bool:
        """Could ``src``'s ``slot`` move here right now?  Requires a free
        slot and a quiescent destination — a prefill in flight would race
        the wave merge for the free slot we are about to fill."""
        return (not self.dead and self.at_boundary()
                and bool(self.free_slots()))

    def migrate_slot_to(self, slot: int, dst: "BatchGroup") -> bool:
        """Move one active request — tokens, positions, and its entire KV
        slot state — into a free slot of ``dst``.  Legal only at a segment
        boundary on both sides: after the epilogue swap, ``prog._ins`` rows
        ARE the current state (write-back keeps host mirrors coherent), so
        migration is a host row copy plus an O(rows)/O(blocks) device patch
        (:meth:`DeviceGroup.patch_cached`) — never a full-cache rewrite.
        The stream stays bitwise: decode is deterministic in the slot state,
        and the copied rows are exactly the state the source would have
        decoded from (between groups of one kind of device: a kernel's
        plain version and the kernel may differ in their last bits).
        Returns False (no partial
        effects) when either side is busy, ``dst`` is full, or its pool
        cannot cover the blocks."""
        req = self.slots[slot]
        if req is None or self.dead or dst.dead or dst is self:
            return False
        if self.seg_handle is not None or not dst.can_accept_migration(self, slot):
            return False
        d = dst.free_slots()[0]
        if not self._copy_slot_state(slot, dst, d):
            return False
        dst.slots[d] = req
        req.slot = d
        self.release_slot(slot)
        return True

    def _row_bufs(self) -> List[torch.Tensor]:
        """The slot-leading input buffers a migration must carry (everything
        except ``spec_on``, which is group-local gate state)."""
        bufs = list(self.prog._ins)
        return bufs[:-1] if self.spec_k else bufs

    def _copy_slot_state(self, slot: int, dst: "BatchGroup", d: int) -> bool:
        """Contiguous layout: copy the slot row of every input buffer
        (token/pos controls + every cache-leaf mirror) into ``dst``'s row
        ``d`` and propagate the rows to ``dst``'s device copies."""
        for src_buf, dst_buf in zip(self._row_bufs(), dst._row_bufs()):
            dst_buf[d] = src_buf[slot]
            dst._patch_or_invalidate(dst_buf, [d])
        return True

    def _patch_or_invalidate(self, buf: torch.Tensor, rows: Sequence[int]) -> None:
        """Propagate freshly written host-mirror rows to this batch's device
        groups: in-place O(rows) patch of the stashed device copy when one
        exists (version unchanged — host and device now agree again), full
        invalidation (one re-upload next segment) otherwise.  The rows are
        gathered into a tensor of their own first: the mirror is page-locked
        on a CUDA group, and its next write-back must not race the upload."""
        groups = self.target or self.runtime.groups
        vals = buf[torch.as_tensor(list(rows), dtype=torch.long)]
        if not all(g.patch_cached(self.prog, buf, rows, vals) for g in groups):
            self.prog.invalidate(buf)

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
