"""Paged KV-cache memory subsystem: block pool, block tables, prefix reuse.

Port of the JAX package's ``serve/paged.py``: plain and speculative
segments, with whole-prompt or chunked prefill; host mirrors are CPU torch
tensors.

The contiguous serving path materializes ``max_batch`` full-``max_seq`` KV
slot rows per :class:`~repro_torch.serve.batcher.BatchGroup`, so device memory
scales with *capacity* rather than recorded depth, and identical prompt
prefixes are stored (and prefilled) once per request.  This module replaces
the slot rows with the allocator the paper says the runtime should own:

- :class:`BlockPool` — a host-side allocator over ``n_blocks`` fixed-size
  KV **blocks** of ``block_len`` tokens each (the device arrays are the
  segment Program's pool buffers, layer-stacked like the contiguous cache
  leaves).  Blocks are refcounted; a content-addressed **prefix cache**
  (hash chain over full prompt blocks, plus whole-prompt entries) lets
  requests sharing a prompt prefix map their leading block-table entries to
  the same physical blocks.  Divergence is isolated by **copy-on-write**:
  an append into a block another slot still references first copies it.
- :class:`PagedBatchGroup` — the paged continuous batch: joins *allocate*
  blocks (instead of rewriting full slot rows), exits *free* them, and the
  segment Program carries a per-slot block **table** that the decode path
  resolves ``(slot, tile)`` through (``models.attention._paged_write`` /
  ``_paged_dense`` / ``kernels.flash_decode_paged``, whose CUDA kernel
  reads each layer's strided view of the pool in place).  Pool leaves ride the
  existing device-residency machinery unchanged: donated inputs, swap
  epilogues, one bump per (run, buffer).

Two physical blocks are reserved: block 0 is the **sink** every exited
slot's garbage decode writes land in (contiguous mode let them scribble on
their own dead row; a paged slot must not scribble on a *freed* block), and
block 1 is the **null** block backing unreserved table entries — nothing
ever writes it, so its recorded positions stay −1 and it is exactly masked,
which is what keeps gathered logical timelines bit-identical to contiguous
ones (DESIGN.md §10).

Bit-identity contract: a request's token stream is bit-identical to
one-shot ``make_generate`` on the padded prompt regardless of which
physical blocks back it, which blocks are reused from exited requests, and
whether its prefix blocks are shared (shared blocks hold KV computed from
identical tokens at identical positions — the same bits).  On the kernel
path the contract additionally requires the one-shot reference to tile its
contiguous cache at ``block_len`` (``cfg.decode_block``): equal logical
tile partitions make the online-softmax reduction identical term by term.

Chunked prefill rides the paged layout too (``_build_paged_mixed``): the
chunk stage writes through the block table (invalid rows into the sink),
whole-prompt prefix-cache hits board decoding at once, chain-cached
leading blocks start a prompt's cursor past them, and a completed prompt
registers its blocks with the prefix cache.  Speculative layouts keep the
target pool-backed and the draft cache in contiguous slot mirrors behind
the pool leaves; under speculation every joiner runs its own prefill row
(whole-prompt and wave-mate reuse are off: neither carries a draft cache),
and only chain-level block sharing of the target stays.  Under the
server's ``group_batches`` regime each DeviceGroup owns a pool (and a
prefix-cache namespace), and a slot migrating between groups copies its
blocks into fresh blocks of the destination's pool (``_copy_slot_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.program import Program
from repro_torch.core.trace import tracer
from repro_torch.serve.batcher import BatchGroup, host_zeros_like, segments_for


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Paged-serving configuration.

    block_len    : tokens per KV block (the kernel's logical tile size).
    n_blocks     : total physical blocks per group pool (0 = auto: full
                   capacity — every slot can reach max depth — plus the two
                   reserved blocks).  Rounded up so the pool axis divides
                   the slot work-items.
    prefix_cache : content-hash prompt blocks and share them across
                   requests (disabled automatically for rolling-window
                   caches, whose blocks are overwritten in place)."""

    block_len: int = 16
    n_blocks: int = 0
    prefix_cache: bool = True


class BlockPool:
    """Refcounted block allocator + content-addressed prefix cache.

    Pure host-side bookkeeping (the batcher thread is the only caller); the
    actual KV bytes live in the owning group's pool buffers.  Counters feed
    ``InferenceServer.metrics`` and the serving benchmark's allocated-vs-
    touched bytes columns."""

    SINK = 0      # write target of exited slots' garbage decode
    NULL = 1      # backs unreserved table entries; never written (kpos −1)
    RESERVED = 2  # first allocatable block id

    def __init__(self, n_blocks: int, *, block_len: int,
                 bytes_per_block: int = 0) -> None:
        if n_blocks < self.RESERVED + 1:
            raise ValueError(f"pool needs > {self.RESERVED} blocks")
        self.n_blocks = n_blocks
        self.block_len = block_len
        self.bytes_per_block = bytes_per_block
        self.ref = np.zeros(n_blocks, np.int64)
        # LIFO free list over ascending ids (pop() hands out low ids first
        # right after init — deterministic tests).
        self._free = list(range(n_blocks - 1, self.RESERVED - 1, -1))
        # prefix cache: key -> block id (full prompt blocks, chain-hashed)
        self._chain: Dict[tuple, int] = {}
        # whole-prompt entries: prompt bytes -> (block ids, first token)
        self._prompt: Dict[bytes, Tuple[Tuple[int, ...], int]] = {}
        self._block_keys: Dict[int, set] = {}
        # Cache retention: every registered block carries ONE extra "cache
        # pin" reference so prefix entries survive their request's exit
        # (repeated prompts across waves are the whole point).  Pins are an
        # LRU: under memory pressure ``alloc`` evicts the oldest pinned
        # blocks until the request fits — cached history never starves a
        # live request.
        self._pinned: Dict[int, None] = {}
        self.counters = {
            "allocs": 0, "frees": 0, "cow": 0, "prefix_hits": 0,
            "prefix_blocks_shared": 0, "prefill_rows": 0,
            "prefill_rows_shared": 0, "tokens_written": 0,
        }
        self.peak_in_use = 0

    # ------------------------------------------------------------ capacity
    @property
    def capacity(self) -> int:
        return self.n_blocks - self.RESERVED

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.free_count

    def reclaimable(self) -> int:
        """Pinned blocks only the cache still holds (ref == 1): evicting
        them frees real memory, so boarding admission counts them as
        available."""
        return int(sum(1 for b in self._pinned if self.ref[b] == 1))

    # ---------------------------------------------------------- allocation
    def alloc(self, n: int) -> List[int]:
        while n > self.free_count and self._pinned:
            # LRU-evict cached prefix blocks until the request fits.
            b = next(iter(self._pinned))
            self._unpin(b)
        if n > self.free_count:
            raise RuntimeError(
                f"pool exhausted: need {n} blocks, {self.free_count} free "
                "(admission must defer before this point)"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.ref[b] = 1
        self.counters["allocs"] += n
        # Peak of *required* allocation: blocks live requests hold.  Cache-
        # pinned blocks nobody references are opportunistic retention,
        # reclaimable on demand — they are reported as blocks_cached, not
        # as allocation the serving load needs.
        self.peak_in_use = max(self.peak_in_use,
                               self.in_use - self.reclaimable())
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            assert self.ref[b] > 0, f"incref of free block {b}"
            self.ref[b] += 1
        if blocks:
            # A prefix hit re-activates cached blocks without an alloc.
            self.peak_in_use = max(self.peak_in_use,
                                   self.in_use - self.reclaimable())

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; blocks reaching zero return to the
        free list and their prefix-cache entries are evicted (a reused
        block's bytes are about to change)."""
        for b in blocks:
            assert self.ref[b] > 0, f"double free of block {b}"
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._evict(b)
                self._free.append(b)
                self.counters["frees"] += 1

    # --------------------------------------------------------- prefix cache
    @staticmethod
    def chain_key(prev: tuple, tokens: np.ndarray) -> tuple:
        """Hash-chain key of one full prompt block: the block's *content*
        plus everything before it (KV depends on the whole causal prefix)."""
        return (prev, tokens.tobytes())

    def lookup_chain(self, key: tuple) -> Optional[int]:
        b = self._chain.get(key)
        if b is not None:
            self._touch(b)
        return b

    def register_chain(self, key: tuple, block: int) -> None:
        self._chain[key] = block
        self._block_keys.setdefault(block, set()).add(("chain", key))
        self._pin(block)

    def lookup_prompt(self, prompt_bytes: bytes):
        hit = self._prompt.get(prompt_bytes)
        if hit is not None:
            for b in hit[0]:
                self._touch(b)
        return hit

    def register_prompt(self, prompt_bytes: bytes, blocks: Sequence[int],
                        first_token: int) -> None:
        self._prompt[prompt_bytes] = (tuple(blocks), int(first_token))
        for b in blocks:
            self._block_keys.setdefault(b, set()).add(("prompt", prompt_bytes))
            self._pin(b)

    def _pin(self, block: int) -> None:
        if block not in self._pinned:
            self.ref[block] += 1
            self._pinned[block] = None

    def _touch(self, block: int) -> None:
        if block in self._pinned:  # LRU refresh
            self._pinned.pop(block)
            self._pinned[block] = None

    def _unpin(self, block: int) -> None:
        self._pinned.pop(block, None)
        self.release([block])

    def _evict(self, block: int) -> None:
        for kind, key in self._block_keys.pop(block, ()):
            if kind == "chain":
                self._chain.pop(key, None)
            else:
                self._prompt.pop(key, None)

    # -------------------------------------------------------------- metrics
    def note_tokens(self, n: int) -> None:
        self.counters["tokens_written"] += n

    def stats(self) -> dict:
        per_token = self.bytes_per_block / max(1, self.block_len)
        return {
            "mode": "paged",
            "blocks_total": self.capacity,
            "blocks_in_use": self.in_use,
            "blocks_free": self.free_count,
            "blocks_cached": len(self._pinned),
            "blocks_peak": self.peak_in_use,
            "bytes_per_block": self.bytes_per_block,
            # Peak blocks live requests held (× block bytes) vs. the bytes
            # decode/prefill really wrote — the capacity-vs-depth gap the
            # contiguous layout cannot express.  Cache retention is
            # excluded (blocks_cached; reclaimable on demand).
            "kv_bytes_allocated": self.peak_in_use * self.bytes_per_block,
            "kv_bytes_device": self.n_blocks * self.bytes_per_block,
            "kv_bytes_touched": int(self.counters["tokens_written"] * per_token),
            **self.counters,
        }


class _DoneHandle:
    """Stand-in RunHandle for an all-cached prefill wave (every request hit
    the whole-prompt cache: there is nothing to run, but the batcher's
    wave/merge state machine still sees a completed handle)."""

    @staticmethod
    def done() -> bool:
        return True

    @staticmethod
    def has_errors() -> bool:
        return False

    @staticmethod
    def errors() -> list:
        return []

    @property
    def metrics(self) -> dict:
        return {}

    def add_done_callback(self, fn: Callable) -> None:
        fn(self)


class PoolState:
    """Per-(server, bucket) persistent paged memory.

    BatchGroups are transient — the server dissolves an idle group and
    re-forms one when traffic returns — but the block pool must not be: its
    prefix-cache entries (and the KV bytes backing them) are most valuable
    exactly across idle gaps (the repeated-system-prompt case).  The server
    threads one PoolState through every PagedBatchGroup generation of a
    bucket: the allocator, the pool host mirrors, and the table ride along,
    so cached blocks — and even their device-resident transfer-cache
    entries, keyed on unchanged buffer versions — survive re-forms."""

    __slots__ = ("pool", "leaves", "table")

    def __init__(self) -> None:
        self.pool: Optional[BlockPool] = None
        self.leaves: Optional[list] = None
        self.table: Optional[torch.Tensor] = None


class _Plan:
    """Per-request prefill plan: how its prompt blocks are sourced."""

    __slots__ = ("req", "kind", "row", "src", "pinned", "first_token")

    def __init__(self, req, kind: str, *, row: Optional[int] = None,
                 src: Optional["_Plan"] = None,
                 pinned: Optional[List[int]] = None,
                 first_token: Optional[int] = None) -> None:
        self.req = req
        self.kind = kind          # "row" | "dup" | "cached"
        self.row = row            # index into the prefill Program's batch
        self.src = src            # wave-mate sharing the identical prompt
        self.pinned = pinned      # prompt blocks pinned at lookup (cached)
        self.first_token = first_token


class PagedBatchGroup(BatchGroup):
    """A continuous batch whose KV lives in a shared block pool.

    Differences from the contiguous base: the segment Program's cache
    buffers are pool leaves of shape ``(n_blocks, layers, block_len, ...)``
    plus a ``(n_slots, nmax)`` int32 block table; joins allocate (or share)
    blocks and scatter prefill rows block-wise into the pool mirrors; exits
    decref, pointing the dead slot's table at the sink block.  Pool buffers
    are indivisible — the slot axis cannot be split across devices that do
    not share the pool — so each PagedBatchGroup is pinned to exactly one
    DeviceGroup; multi-group paged serving runs one group (and one pool)
    per device via the server's ``group_batches`` regime."""

    def __init__(self, kernels, runtime, scheduler, bucket: int,
                 n_slots: int, seg_len: int, max_seq: int,
                 spec: PagedSpec, state: Optional[PoolState] = None,
                 chunk_len: int = 0, target=None) -> None:
        self.spec = spec
        self.state = state if state is not None else PoolState()
        self.window = int(kernels.cfg.window or 0)
        bl = int(spec.block_len)
        if bl < 1:
            raise ValueError(f"block_len must be >= 1, got {bl}")
        cs = min(max_seq, self.window) if self.window else max_seq
        if self.window and cs % bl != 0:
            raise ValueError(
                f"rolling cache of {cs} tokens needs block_len dividing it "
                f"(got {bl}): the paged ring must equal the contiguous ring "
                "or bit-identity breaks"
            )
        # Logical table width: every reserved position of a slot's timeline
        # (ring slots for rolling caches) maps to one table entry.
        self.nmax = table_width(bl, max_seq, self.window)
        self.block_len = bl
        self.prefix_enabled = bool(spec.prefix_cache) and not self.window
        super().__init__(kernels, runtime, scheduler, bucket, n_slots,
                         seg_len, max_seq, chunk_len=chunk_len, target=target)

    # ----------------------------------------------------- program assembly
    def _build_segment_program(self):
        kernels, n_slots, bl = self.kernels, self.n_slots, self.block_len
        n_blocks = pool_blocks(self.spec, n_slots, self.nmax)
        if self.state.pool is None:
            leaves = kernels.leaf_mirrors(n_blocks, bl, self.pin)
            self.state.pool = BlockPool(
                n_blocks, block_len=bl,
                bytes_per_block=sum(b.nbytes for b in leaves) // n_blocks,
            )
            self.state.leaves = leaves
            self.state.table = torch.zeros((n_slots, self.nmax), dtype=torch.int32)
        self.pool = self.state.pool
        leaves = self.state.leaves
        self._n_pool = len(leaves)
        # Which pool leaves record positions (Spec init "neg_ones"): fresh
        # blocks reset these to −1 so a reused block's stale timeline can
        # never alias valid positions of its new owner.
        self._neg_leaves = kernels.leaf_neg_init(bl)
        self._seq_axes = kernels.leaf_seq_axes()
        self.table = self.state.table  # all sink while no slot is boarded
        tok = torch.zeros((n_slots, 1), dtype=torch.int32)
        pos = torch.zeros((n_slots, 1), dtype=torch.int32)
        self.slot_blocks: List[Optional[List[int]]] = [None] * n_slots
        self._plans: List[_Plan] = []
        if self.chunk_len:
            self._build_paged_mixed(tok, pos, leaves)
            return
        if self.spec_k:
            # [tok, ptok, pos, table, *pool, *draft, spec_on]: the draft
            # mirrors are per group, not kept in the PoolState (a group
            # dissolves only when idle, and an idle group's draft rows
            # belong to no live request).
            self._build_spec_program(
                [tok, None, pos, self.table],
                leaves + kernels.draft_leaf_mirrors(n_slots, self.max_seq, self.pin),
                kernels.paged_spec_segment_kernel(self.seg_len, self.bucket, self.max_seq),
                f"spec_pseg{self.seg_len}_k{self.spec_k}")
            return
        toks_seg = torch.zeros((n_slots, self.seg_len), dtype=torch.int32)
        prog = Program().in_(tok).in_(pos).in_(self.table)
        for b in leaves:
            prog.in_(b)
        prog.out(toks_seg).out(torch.zeros_like(tok)).out(torch.zeros_like(pos))
        for b in leaves:
            prog.out(host_zeros_like(b))
        prog.kernel(kernels.paged_segment_kernel(self.seg_len, self.bucket),
                    f"decode_pseg{self.seg_len}")
        # Donate the pool-leaf inputs: segments update the shared blocks in
        # place on the device (consume-on-donate keeps the transfer cache
        # sane), exactly like the contiguous cache-leaf donation.
        prog.donate(*range(3, 3 + len(leaves)))
        prog.work_items(n_slots, 1)
        self.prog = prog
        self.n_leaves = len(leaves)
        self._swap_pairs = [(0, 1), (1, 2)] + [
            (3 + i, 3 + i) for i in range(self.n_leaves)
        ]

    def _build_paged_mixed(self, tok, pos, leaves) -> None:
        """Chunked-prefill paged layout, in the JAX package's buffer order
        ``[tok, pos, pcur, ptoks, table, *pool] -> [toks, tok', pos', pcur',
        ctok, *pool']``: ``pcur``/``ptoks`` join the carry as in the
        contiguous mixed Program, the block table stays a pure input, and
        chunk writes resolve physical blocks through it (invalid rows land
        in the sink block)."""
        kernels, n_slots, seg_len = self.kernels, self.n_slots, self.seg_len
        pcur = torch.full((n_slots, 1), self.bucket, dtype=torch.int32)
        ptoks = torch.zeros((n_slots, self.bucket), dtype=torch.int32)
        if self.spec_k:
            # [tok, ptok, pos, pcur, ptoks, table, *pool, *draft, spec_on].
            self._build_spec_program(
                [tok, None, pos, pcur, ptoks, self.table],
                leaves + kernels.draft_leaf_mirrors(n_slots, self.max_seq, self.pin),
                kernels.paged_spec_mixed_segment_kernel(seg_len, self.bucket, self.chunk_len,
                                                        self.max_seq),
                f"spec_pmixed_seg{seg_len}_b{self.bucket}_c{self.chunk_len}_k{self.spec_k}",
                n_carried=4, ctok_out=6)
            return
        toks_seg = torch.zeros((n_slots, seg_len), dtype=torch.int32)
        prog = Program().in_(tok).in_(pos).in_(pcur).in_(ptoks).in_(self.table)
        for b in leaves:
            prog.in_(b)
        prog.out(toks_seg).out(torch.zeros_like(tok)).out(torch.zeros_like(pos))
        prog.out(torch.zeros_like(pcur)).out(torch.zeros_like(tok))  # pcur', ctok
        for b in leaves:
            prog.out(host_zeros_like(b))
        prog.kernel(kernels.paged_mixed_segment_kernel(seg_len, self.bucket, self.chunk_len),
                    f"pmixed_seg{seg_len}_b{self.bucket}_c{self.chunk_len}")
        prog.args(False)
        prog.donate(*range(5, 5 + len(leaves)))
        prog.work_items(n_slots, 1)
        self.prog = prog
        self.n_leaves = len(leaves)
        self._swap_pairs = [(0, 1), (1, 2), (2, 3)] + [
            (5 + i, 5 + i) for i in range(self.n_leaves)
        ]
        self._ctok_out = 4

    # ----------------------------------------------------------- accounting
    def blocks_for(self, gen: int) -> int:
        """Blocks a request must be able to reserve: its forecast depth —
        prompt plus every decode-segment position it may write — in blocks
        (rolling caches reserve their whole ring).  Delegates to the
        module-level :func:`blocks_needed` so submit-time admission and
        boarding reservation can never desync."""
        return blocks_needed(self.bucket, gen, self.seg_len, self.block_len,
                             window=self.window, max_seq=self.max_seq,
                             spec_step=(self.spec_k + 1) if self.spec_k else 0)

    def reserve_estimate(self, req) -> int:
        return self.blocks_for(req.gen)

    def memory_available(self, already_reserved: int) -> float:
        # Cache-pinned blocks nobody else references are reclaimable on
        # demand (alloc LRU-evicts them), so they count as available.
        return (self.pool.free_count + self.pool.reclaimable()
                - already_reserved)

    def memory_stats(self) -> dict:
        return self.pool.stats()

    # -------------------------------------------------------------- prefill
    def _plan_prefill(self, requests: Sequence) -> List:
        """Decide how each wave member's prompt blocks are sourced: a fresh
        prefill row, a wave-mate with the identical padded prompt (prefill
        runs once for the shared blocks), or a whole-prompt prefix-cache hit
        (no prefill at all — blocks pinned here, table wired at merge)."""
        if self.chunk_len:
            return self._plan_chunked(requests)
        plans: List[_Plan] = []
        rows: List = []
        by_prompt: Dict[bytes, _Plan] = {}
        tr = tracer()
        for r in requests:
            pb = r.prompt.tobytes()
            # Drafting: every joiner runs its own prefill row (the draft
            # cache has to be produced for the slot, and neither the
            # whole-prompt cache nor a wave-mate's target row carries it).
            # Chain-level block sharing in _assign_blocks stays: target KV
            # of identical prefixes is identical bits.
            if self.prefix_enabled and not self.spec_k:
                hit = self.pool.lookup_prompt(pb)
                if hit is not None:
                    blocks, tok0 = hit
                    self.pool.incref(blocks)
                    self.pool.counters["prefix_hits"] += 1
                    self.pool.counters["prefill_rows_shared"] += 1
                    if tr.enabled:
                        tr.async_instant("prefix_hit", r.seq, kind="prompt",
                                         blocks=len(blocks))
                    plans.append(_Plan(r, "cached", pinned=list(blocks),
                                       first_token=tok0))
                    continue
                src = by_prompt.get(pb)
                if src is not None:
                    self.pool.counters["prefix_hits"] += 1
                    self.pool.counters["prefill_rows_shared"] += 1
                    if tr.enabled:
                        tr.async_instant("prefix_hit", r.seq, kind="wave")
                    plans.append(_Plan(r, "dup", src=src))
                    continue
            plan = _Plan(r, "row", row=len(rows))
            rows.append(r)
            by_prompt[pb] = plan
            plans.append(plan)
        self._plans = plans
        self.pool.counters["prefill_rows"] += len(rows)
        return rows

    def _plan_chunked(self, requests: Sequence) -> List:
        """Chunked planning: there are no prefill rows.  A whole-prompt
        cache hit still boards decoding at once (blocks pinned here, table
        wired at merge); everything else chunks.  Wave-mate ("dup") sharing
        is off (the mate's blocks hold no KV yet at plan time), but
        completed prompts enter the chain and prompt caches for later waves
        (:meth:`_on_chunk_complete`)."""
        plans: List[_Plan] = []
        tr = tracer()
        for r in requests:
            if self.prefix_enabled and not self.spec_k:
                hit = self.pool.lookup_prompt(r.prompt.tobytes())
                if hit is not None:
                    blocks, tok0 = hit
                    self.pool.incref(blocks)
                    self.pool.counters["prefix_hits"] += 1
                    self.pool.counters["prefill_rows_shared"] += 1
                    if tr.enabled:
                        tr.async_instant("prefix_hit", r.seq, kind="prompt",
                                         blocks=len(blocks))
                    plans.append(_Plan(r, "cached", pinned=list(blocks),
                                       first_token=tok0))
                    continue
            plans.append(_Plan(r, "row"))
        self._plans = plans
        return []

    def merge_prefill(self) -> dict:
        h, wave, prog = self.prefill_handle, self.prefill_wave, self._prefill_prog
        plans, self._plans = self._plans, []
        assert h is not None and h.done()
        self.prefill_handle, self.prefill_wave, self._prefill_prog = None, [], None
        seconds = h.metrics.get("response_time") or (_now() - self._prefill_t0)
        if h.has_errors():
            for p in plans:
                if p.pinned:
                    self.pool.release(p.pinned)
            return {"joined": 0, "failed": list(wave), "errors": h.errors(),
                    "seconds": seconds}
        if self.chunk_len:
            return self._merge_chunked_paged(plans, seconds)
        tr = tracer()
        if tr.enabled and self._prefill_tr0:
            tr.complete("prefill_wave", self._prefill_tr0,
                        self._prefill_tr0 + seconds, track="batcher",
                        bucket=self.bucket, wave=len(wave))
            self._prefill_tr0 = 0.0
        free = self.free_slots()
        if self.spec_k:
            tok_b, ptok_b, pos_b = self.prog._ins[:3]
            draft_bufs = self.prog._ins[4 + self._n_pool:-1]
            tok0, ptok0 = (prog._outs[0], prog._outs[1]) if prog is not None else (None, None)
            wave_leaves = prog._outs[2:2 + self._n_pool] if prog is not None else []
            draft_waves = prog._outs[2 + self._n_pool:] if prog is not None else []
        else:
            tok_b, ptok_b, pos_b = self.prog._ins[0], None, self.prog._ins[1]
            draft_bufs, ptok0, draft_waves = [], None, []
            tok0 = prog._outs[0] if prog is not None else None
            wave_leaves = prog._outs[1:] if prog is not None else []
        wrote_pool = False
        for plan in plans:
            slot = free.pop(0)
            blocks, first, wrote = self._assign_blocks(plan, wave_leaves, tok0)
            wrote_pool |= wrote
            self.slot_blocks[slot] = blocks
            self.table[slot, :] = BlockPool.NULL
            self.table[slot, : len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
            tok_b[slot, 0] = int(first)
            if ptok_b is not None:
                ptok_b[slot, 0] = ptok0[plan.row, 0]
                for dst, src in zip(draft_bufs, draft_waves):
                    dst[slot] = src[plan.row]
            pos_b[slot, 0] = self.bucket
            req = plan.req
            self.slots[slot] = req
            req.board(slot, int(first))
            if tr.enabled:
                tr.async_instant("first_token", req.seq, slot=slot)
        # Join boundary: tok/pos rows and the table always changed; the
        # pool leaves only when some block was actually written (an all-
        # cached wave re-uploads just the small control buffers).
        self.prog.invalidate(tok_b)
        if ptok_b is not None:
            self.prog.invalidate(ptok_b)
            for b in draft_bufs:
                self.prog.invalidate(b)
        self.prog.invalidate(pos_b)
        self.prog.invalidate(self.table)
        if wrote_pool:
            for b in self._pool_leaves():
                self.prog.invalidate(b)
        return {"joined": len(plans), "failed": [], "seconds": seconds}

    def _assign_blocks(self, plan: _Plan, wave_leaves, tok0):
        """Build one request's block list (prompt + reserved decode blocks).
        Returns (blocks, first_token, wrote_pool_mirrors)."""
        pool, bl, bucket = self.pool, self.block_len, self.bucket
        n_total = self.blocks_for(plan.req.gen)
        if plan.kind == "cached":
            prompt_blocks = plan.pinned
            fresh = pool.alloc(n_total - len(prompt_blocks))
            self._reset_kpos(fresh)
            return prompt_blocks + fresh, plan.first_token, bool(fresh)
        if plan.kind == "dup":
            src_blocks = self.slot_blocks[plan.src.req.slot]
            n_full = bucket // bl
            tail = bucket % bl
            shared = src_blocks[:n_full]
            pool.incref(shared)
            pool.counters["prefix_blocks_shared"] += len(shared)
            blocks = list(shared)
            if tail:
                # Copy-on-write, eagerly at the join boundary: the shared
                # partial tail block is about to receive this slot's first
                # divergent append (position ``bucket`` lies inside it), and
                # the wave-mate still references the original.
                cow = pool.alloc(1)[0]
                self._copy_block(cow, src_blocks[n_full])
                pool.counters["cow"] += 1
                pool.note_tokens(tail)
                blocks.append(cow)
            fresh = pool.alloc(n_total - len(blocks))
            self._reset_kpos(fresh)
            first = int(tok0[plan.src.row, 0])
            return blocks + fresh, first, True
        # kind == "row": fresh prefill output, chain-shared where possible.
        row = [leaf[plan.row] for leaf in wave_leaves]
        blocks: List[int] = []
        wrote = False
        if self.window:
            # Rolling cache: the prefill row IS the ring — copy it whole.
            for j in range(self.nmax):
                b = pool.alloc(1)[0]
                self._store_block(b, row, j)
                blocks.append(b)
            pool.note_tokens(min(bucket, self.nmax * bl))
            first = int(tok0[plan.row, 0])
            return blocks, first, True
        n_full = bucket // bl
        tail = bucket % bl
        key: tuple = ("root",)
        chain_live = self.prefix_enabled
        for j in range(n_full):
            key = BlockPool.chain_key(key, plan.req.prompt[j * bl:(j + 1) * bl])
            hit = pool.lookup_chain(key) if chain_live else None
            if hit is not None:
                pool.incref([hit])
                pool.counters["prefix_hits"] += 1
                pool.counters["prefix_blocks_shared"] += 1
                blocks.append(hit)
                continue
            b = pool.alloc(1)[0]
            self._store_block(b, row, j)
            pool.note_tokens(bl)
            wrote = True
            if chain_live:
                pool.register_chain(key, b)
            blocks.append(b)
        if tail:
            b = pool.alloc(1)[0]
            self._store_block(b, row, n_full)  # trailing −1s reset the block
            pool.note_tokens(tail)
            wrote = True
            blocks.append(b)
        first = int(tok0[plan.row, 0])
        if self.prefix_enabled and not tail and not self.spec_k:
            # Durable whole-prompt entry (block-aligned prompts only: a
            # partial tail would be appended into by this very request,
            # leaving the entry pointing at mutated bytes).
            pool.register_prompt(plan.req.prompt.tobytes(), blocks, first)
        fresh = pool.alloc(n_total - len(blocks))
        self._reset_kpos(fresh)
        return blocks + fresh, first, wrote or bool(fresh)

    # ----------------------------------------------------- chunked prefill
    def _merge_chunked_paged(self, plans: Sequence[_Plan], seconds: float) -> dict:
        """Board a chunked join wave: whole-prompt cache hits wire their
        pinned blocks and board decoding at once; everything else gets its
        block reservation (chain-cached leading full blocks advance the
        start cursor, so those positions are never chunked again) and
        prefills through the segment kernel's chunk stage."""
        free = self.free_slots()
        if self.spec_k:
            tok_b, ptok_b, pos_b, pcur_b, ptoks_b = self.prog._ins[:5]
            draft_bufs = self.prog._ins[6 + self._n_pool:-1]
            dneg = self.kernels.draft_leaf_neg_init(self.max_seq)
        else:
            tok_b, ptok_b, pos_b = self.prog._ins[0], None, self.prog._ins[1]
            pcur_b, ptoks_b = self.prog._ins[2], self.prog._ins[3]
            draft_bufs, dneg = [], []
        tr = tracer()
        wrote_pool = False
        for plan in plans:
            slot = free.pop(0)
            req = plan.req
            n_total = self.blocks_for(req.gen)
            if plan.kind == "cached":
                # Whole-prompt hit: boards decoding now, no chunk segments.
                fresh = self.pool.alloc(n_total - len(plan.pinned))
                self._reset_kpos(fresh)
                blocks = plan.pinned + fresh
                pcur0, first = self.bucket, int(plan.first_token)
                wrote_pool |= bool(fresh)
            else:
                lead = self._chain_head(req)
                fresh = self.pool.alloc(n_total - len(lead))
                self._reset_kpos(fresh)
                blocks = lead + fresh
                pcur0, first = len(lead) * self.block_len, 0
                wrote_pool = True
            self.slot_blocks[slot] = blocks
            self.table[slot, :] = BlockPool.NULL
            self.table[slot, : len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
            tok_b[slot, 0] = first
            if ptok_b is not None:
                ptok_b[slot, 0] = int(req.prompt[-1])
                for dst, is_neg in zip(draft_bufs, dneg):
                    if is_neg:
                        dst[slot] = -1
            pos_b[slot, 0] = self.bucket
            pcur_b[slot, 0] = pcur0
            ptoks_b[slot, :] = torch.from_numpy(req.prompt)
            self.slots[slot] = req
            req.slot = slot
            req.chunk_pos = pcur0
            if pcur0 >= self.bucket:
                req.board(slot, first)
                if tr.enabled:
                    tr.async_instant("first_token", req.seq, slot=slot)
        for b in (tok_b, ptok_b, pos_b, pcur_b, ptoks_b):
            if b is not None:
                self.prog.invalidate(b)
        self.prog.invalidate(self.table)
        if wrote_pool:
            # _reset_kpos only touches the position leaves.
            for leaf, neg in zip(self._pool_leaves(), self._neg_leaves):
                if neg:
                    self.prog.invalidate(leaf)
        for dst, is_neg in zip(draft_bufs, dneg):
            if is_neg:
                self.prog.invalidate(dst)
        return {"joined": len(plans), "failed": [], "seconds": seconds}

    def _chain_head(self, req) -> List[int]:
        """Chain-cached leading full blocks of a chunking prompt, increfed.
        Clamped so at least one prompt position is left to chunk: the
        completing chunk's final prompt row is where ``ctok`` comes from.
        Speculative slots always chunk from 0: the draft cache has no
        cached prefix to skip with."""
        if not self.prefix_enabled or self.spec_k:
            return []
        bl = self.block_len
        key: tuple = ("root",)
        lead: List[int] = []
        for j in range((self.bucket - 1) // bl):
            key = BlockPool.chain_key(key, req.prompt[j * bl:(j + 1) * bl])
            hit = self.pool.lookup_chain(key)
            if hit is None:
                break
            lead.append(hit)
        if lead:
            self.pool.incref(lead)
            self.pool.counters["prefix_hits"] += 1
            self.pool.counters["prefix_blocks_shared"] += len(lead)
            tr = tracer()
            if tr.enabled:
                tr.async_instant("prefix_hit", req.seq, kind="chain", blocks=len(lead))
        return lead

    def _on_chunk_complete(self, slot: int, req) -> None:
        """Chunk-completed prompt: its leading blocks now hold exactly the
        KV whole-prompt prefill would have produced (bit-identity), so they
        enter the prefix caches: chain entries per full block, plus a
        whole-prompt entry for block-aligned prompts (a partial tail block
        keeps receiving this request's decode appends and must not be
        shared)."""
        if not self.prefix_enabled or self.spec_k:
            return
        bl, bucket, pool = self.block_len, self.bucket, self.pool
        blocks = self.slot_blocks[slot]
        n_full = bucket // bl
        key: tuple = ("root",)
        for j in range(n_full):
            key = BlockPool.chain_key(key, req.prompt[j * bl:(j + 1) * bl])
            if pool.lookup_chain(key) is None:
                pool.register_chain(key, blocks[j])
        if bucket % bl == 0:
            pool.register_prompt(req.prompt.tobytes(), blocks[:n_full], req.tokens[0])

    # ------------------------------------------------- pool mirror plumbing
    def _pool_leaves(self) -> list:
        base = (4 if self.spec_k else 3) + (2 if self.chunk_len else 0)
        return self.prog._ins[base:base + self._n_pool]

    def _store_block(self, block: int, row: list, j: int) -> None:
        """Copy logical block ``j`` of one prefill slot row into physical
        ``block`` across every pool leaf (views along the seq axis)."""
        bl = self.block_len
        for leaf, src, sax in zip(self._pool_leaves(), row, self._seq_axes):
            dst = leaf[block].movedim(sax, 0)
            dst.copy_(src.movedim(sax, 0)[j * bl:(j + 1) * bl])

    def _copy_block(self, dst_block: int, src_block: int) -> None:
        for leaf in self._pool_leaves():
            leaf[dst_block] = leaf[src_block]

    def _reset_kpos(self, blocks: Sequence[int]) -> None:
        """Freshly-allocated decode blocks: mark every position empty (−1)
        in the position leaves.  The block's previous owner's timeline must
        never read as valid for the new owner."""
        if not blocks:
            return
        idx = torch.tensor(list(blocks), dtype=torch.long)
        for leaf, neg in zip(self._pool_leaves(), self._neg_leaves):
            if neg:
                leaf[idx] = -1

    # ------------------------------------------------------- exits / faults
    def release_slot(self, slot: int) -> None:
        super().release_slot(slot)
        blocks = self.slot_blocks[slot]
        if blocks:
            self.pool.release(blocks)
        self.slot_blocks[slot] = None
        # Exited slots keep decoding on static shapes: point every table
        # entry at the sink so their garbage writes cannot land in blocks
        # that may be reallocated to live requests.
        self.table[slot, :] = BlockPool.SINK
        self.prog.invalidate(self.table)

    # ------------------------------------------------------- slot migration
    def can_accept_migration(self, src, slot) -> bool:
        if not super().can_accept_migration(src, slot):
            return False
        need = len(src.slot_blocks[slot] or ())
        return self.pool.free_count + self.pool.reclaimable() >= need

    def _row_bufs(self) -> list:
        """Slot-row-leading inputs only: the control carries, plus (when
        drafting) the contiguous draft-cache mirrors.  The table and the
        pool leaves are block-addressed and migrate separately."""
        nctl = (3 if self.spec_k else 2) + (2 if self.chunk_len else 0)
        bufs = list(self.prog._ins[:nctl])
        if self.spec_k:
            bufs += list(self.prog._ins[nctl + 1 + self._n_pool:-1])
        return bufs

    def _copy_slot_state(self, slot, dst, d) -> bool:
        """Paged handoff: allocate fresh blocks in the destination pool,
        copy the slot's physical block rows across (O(blocks), not
        O(max_seq)), rewrite the destination table row, then move the
        control/draft rows.  Allocation happens FIRST so failure leaves no
        partial effects; the copied bytes are the slot's exact KV timeline,
        so decode from them is bitwise the source's (shared source blocks
        become private destination copies — sharing is lost, bits are
        not)."""
        src_blocks = self.slot_blocks[slot] or []
        try:
            new_blocks = dst.pool.alloc(len(src_blocks))
        except RuntimeError:
            return False
        if src_blocks:
            src_idx = torch.as_tensor(src_blocks, dtype=torch.long)
            dst_idx = torch.as_tensor(new_blocks, dtype=torch.long)
            for s_leaf, d_leaf in zip(self._pool_leaves(), dst._pool_leaves()):
                d_leaf[dst_idx] = s_leaf[src_idx]
                dst._patch_or_invalidate(d_leaf, new_blocks)
        dst.table[d, :] = BlockPool.NULL
        dst.table[d, : len(new_blocks)] = torch.as_tensor(new_blocks, dtype=torch.int32)
        dst._patch_or_invalidate(dst.table, [d])
        for s_buf, d_buf in zip(self._row_bufs(), dst._row_bufs()):
            d_buf[d] = s_buf[slot]
            dst._patch_or_invalidate(d_buf, [d])
        dst.slot_blocks[d] = list(new_blocks)
        return True

    def harvest_segment(self) -> dict:
        res = super().harvest_segment()
        if "errors" not in res:
            # Under speculation each slot advanced seg_len + its accepted
            # draft tokens, the net new valid positions in its blocks;
            # chunked segments also wrote each prefilling slot's chunk of
            # prompt positions.
            self.pool.note_tokens(res["n_active"] * self.seg_len
                                  + res.get("accepted", 0)
                                  + res.get("chunk_tokens", 0))
        self._gauge_pool()
        return res

    def _gauge_pool(self) -> None:
        """Stream the pool's occupancy into the rolling telemetry registry
        (gauges per tier plus a blocks-in-use observation stream, so
        ``metrics()`` carries p50/p99 occupancy over the window)."""
        tel = self.telemetry
        if tel is None:
            return
        s = self.pool.stats()
        tel.gauge("pool_blocks_total", s["blocks_total"])
        tel.gauge("pool_blocks_in_use", s["blocks_in_use"])
        tel.gauge("pool_blocks_free", s["blocks_free"])
        tel.gauge("pool_blocks_cached", s["blocks_cached"])
        tel.gauge("pool_kv_bytes_allocated", s["kv_bytes_allocated"])
        tel.gauge("pool_kv_bytes_touched", s["kv_bytes_touched"])
        tel.observe("pool_blocks_in_use_obs", s["blocks_in_use"])

    def detach(self) -> None:
        """Persist the *current* pool buffers back into the PoolState before
        the group dissolves: ping-pong swap epilogues rotate the tensor
        objects, so the state must track whichever tensors hold the latest
        written-back KV when the next group generation picks them up."""
        self.state.leaves = list(self._pool_leaves())
        self.state.table = self.prog._ins[(3 if self.spec_k else 2)
                                          + (2 if self.chunk_len else 0)]

    def fail_all(self, errors: Sequence[str]) -> List[object]:
        for slot in range(self.n_slots):
            if self.slot_blocks[slot]:
                self.pool.release(self.slot_blocks[slot])
                self.slot_blocks[slot] = None
        for p in self._plans:
            if p.pinned:
                self.pool.release(p.pinned)
        self._plans = []
        return super().fail_all(errors)


def validate_paged(cfg, groups, scheduler, spec: PagedSpec, *,
                   group_batches: bool = True) -> None:
    """Fail fast on configurations the paged subsystem cannot honor.

    Multi-group paged serving runs one :class:`PagedBatchGroup` — and one
    block pool — per DeviceGroup (the server's ``group_batches`` regime);
    any scheduler may drive placement and rebalancing.  The only rejected
    shape is multiple groups *without* per-group pools: a single pool is
    one indivisible device allocation and cannot be slot-split."""
    if len(groups) != 1 and not group_batches:
        raise ValueError(
            "paged serving across multiple DeviceGroups requires per-group "
            "block pools (group_batches): a single block pool is one "
            "indivisible device allocation and cannot be slot-split"
        )
    if cfg.seq_shard_cache:
        raise ValueError("paged serving is incompatible with seq_shard_cache")
    if cfg.kernel_impl == "cuda" and cfg.decode_block != spec.block_len:
        raise ValueError(
            f"paged serving on the kernel path needs cfg.decode_block == "
            f"block_len ({spec.block_len}), got {cfg.decode_block}: the "
            "one-shot reference must tile its contiguous cache identically "
            "or the bit-identity contract breaks (DESIGN.md §10)"
        )


def blocks_needed(bucket: int, gen: int, seg_len: int, block_len: int,
                  *, window: int = 0, max_seq: int = 0,
                  spec_step: int = 0) -> int:
    """Forecast block need of one request (admission-side mirror of
    ``PagedBatchGroup.blocks_for``, usable before any group exists).

    ``spec_step`` is the speculative tokens-per-step *cap* (k+1; 0 or 1 =
    speculation off): a drafting slot's last segment can start at position
    ``bucket + gen - 2`` and scatter-write every verify row, so the reserve
    must cover ``seg_len * spec_step`` positions past that — the worst
    case, not the expected acceptance (reservation is a guarantee)."""
    if window:
        cs = min(max_seq, window) if max_seq else window
        return -(-cs // block_len)
    if spec_step > 1:
        depth = bucket if gen <= 1 else bucket + gen - 2 + seg_len * spec_step
    else:
        depth = bucket + segments_for(gen, seg_len) * seg_len
    return -(-depth // block_len)


def table_width(block_len: int, max_seq: int, window: int) -> int:
    """Logical block-table width: one entry per reserved timeline position
    (the whole ring for rolling caches)."""
    cs = min(max_seq, window) if window else max_seq
    return cs // block_len if window else -(-max_seq // block_len)


def pool_blocks(spec: PagedSpec, n_slots: int, nmax: int) -> int:
    """Total physical blocks of a group pool (auto-size = full capacity
    plus the reserved sink/null pair), rounded up so the pool axis divides
    the slot work-items (Program buffer-ratio rule)."""
    n = spec.n_blocks or (BlockPool.RESERVED + n_slots * nmax)
    return -(-n // n_slots) * n_slots


def pool_capacity(spec: PagedSpec, n_slots: int, max_seq: int,
                  window: int) -> int:
    """Allocatable blocks of the pool a group of this geometry would own."""
    nmax = table_width(spec.block_len, max_seq, window)
    return pool_blocks(spec, n_slots, nmax) - BlockPool.RESERVED


def _now() -> float:
    import time

    return time.monotonic()
