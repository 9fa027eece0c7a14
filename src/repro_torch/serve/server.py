"""Continuous-batching inference server on the dataflow runtime.

Port of the JAX package's ``serve/server.py``, the layer between
*independent requests arriving over time* and the engine core, which only
knows how to co-execute one data-parallel Program:

    client threads ──submit()──▶ request queue (EDF per bucket)
                                    │  admission (deadline forecast,
                                    │  KV block pool)
                                    ▼
                          batcher thread (one event loop)
                    form/join/exit at decode-segment boundaries
                                    │
                                    ▼
            BatchGroup Programs ──Runtime.submit(after=…)──▶ DeviceGroups

``submit`` is thread-safe and non-blocking: it returns a ``RequestHandle``
future (``result()/done()``, latency metrics).  A single batcher thread
owns all batching state and never polls — it sleeps on a condition variable
that request arrivals and ``RunHandle.add_done_callback`` wake-ups notify.

Semantics: greedy decode; a request padded to its shape bucket produces
the tokens of one-shot ``make_generate`` on the padded prompt whatever
batch it shares slots with and however segments interleave, as long as the
decode arithmetic is batch-invariant (ROADMAP.md item C2 records where it
is not).

Contiguous or paged KV, whole-prompt prefill Programs or chunked prefill
(``chunk_len``: the prompt advances inside the decode segments,
``validate_chunked``), greedy speculative decoding (``draft``: draft/verify
segments, with or without the ``SpecGate`` bypass, ``validate_draft``), on
one DeviceGroup or several.  On several, either one batch's slot axis is
split across the groups each segment (Dynamic/HGuided, contiguous KV), or
``group_batches`` runs one sub-batch (and, paged, one block pool) per
group: join waves placed by ``plan_wave`` on the scheduler's placement
weights, decode slots migrating between members at segment boundaries
(``RateBalancer``, ``ForceMigrate``, ``drain_group``), groups joining and
draining on the live server (``join_group``, ``drain_group``,
``distributed.elastic.ElasticServeGroups``).  The weights live on one
device, so a server's groups are groups of that device: on one card,
streams of it, each member's segment loops in a graph scope of their own
(``ModelKernels``).  The bitwise contract holds across groups of one kind
of device; a stream moving between ``cpu`` (the kernels' plain versions)
and ``cuda`` (the kernels) could not keep its bits, and the server adds no
refusal for it (the JAX package has none): its groups must share the
weights' device.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.device import DeviceGroup
from repro_torch.core.obs import EngineObs
from repro_torch.core.runtime import Runtime
from repro_torch.core.scheduler.base import Scheduler
from repro_torch.core.scheduler.static import Static
from repro_torch.core.trace import tracer
from repro_torch.serve.admission import DeadlineAdmission, PoolAdmission, SpecGate, edf_key
from repro_torch.serve.batcher import (
    BatchGroup,
    Buckets,
    ModelKernels,
    chunks_for,
    segments_for,
    spec_segments_for,
)
from repro_torch.serve.multigroup import (
    MigrationPolicy,
    RateBalancer,
    plan_wave,
    proportional_split,
)
from repro_torch.serve.paged import (
    PagedBatchGroup,
    PagedSpec,
    PoolState,
    blocks_needed,
    pool_capacity,
    validate_paged,
)
from repro_torch.serve.step import DraftSpec
from repro_torch.serve.telemetry import Telemetry


class AdmissionError(RuntimeError):
    """Raised by ``RequestHandle.result()`` for rejected requests."""


class ServeError(RuntimeError):
    """Raised by ``RequestHandle.result()`` when the backing run failed."""


class RequestHandle:
    """Client-facing future for one request, with latency metrics."""

    def __init__(self, prompt_len: int, padded_len: int, max_new_tokens: int,
                 deadline: Optional[float]) -> None:
        self.prompt_len = prompt_len
        self.padded_len = padded_len
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.t_arrival = time.monotonic()
        self.t_admitted: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self._ev = threading.Event()
        self._tokens: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._rejected: Optional[str] = None
        # Speculative-decoding counters (stay 0 when serving undrafted).
        self.drafted = 0   # draft tokens proposed for this request
        self.accepted = 0  # draft tokens the verify step kept

    # -- batcher-facing ---------------------------------------------------
    def _finish(self, tokens: np.ndarray) -> None:
        self.t_done = time.monotonic()
        self._tokens = tokens
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        self.t_done = time.monotonic()
        self._error = exc
        self._ev.set()

    def _reject(self, reason: str) -> None:
        self.t_done = time.monotonic()
        self._rejected = reason
        self._ev.set()

    # -- client-facing ----------------------------------------------------
    def done(self) -> bool:
        return self._ev.is_set()

    @property
    def rejected(self) -> bool:
        return self._rejected is not None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the generated tokens (``max_new_tokens`` int32);
        raises ``AdmissionError`` if rejected, ``ServeError`` on failure."""
        if not self._ev.wait(timeout):
            raise TimeoutError("request did not complete within timeout")
        if self._rejected is not None:
            raise AdmissionError(self._rejected)
        if self._error is not None:
            raise ServeError(str(self._error)) from self._error
        return self._tokens

    @property
    def metrics(self) -> dict:
        """Latency breakdown (None until the stage happened): queue_wait =
        arrival→boarding, ttft = arrival→first token, latency = arrival→
        final state."""
        def d(t):
            return None if t is None else t - self.t_arrival

        return {
            "queue_wait": d(self.t_admitted),
            "ttft": d(self.t_first_token),
            "latency": d(self.t_done),
            "prompt_len": self.prompt_len,
            "padded_len": self.padded_len,
            "n_tokens": 0 if self._tokens is None else int(len(self._tokens)),
            "drafted": self.drafted,
            "accepted": self.accepted,
            "rejected_drafts": self.drafted - self.accepted,
            "acceptance": (self.accepted / self.drafted
                           if self.drafted else None),
        }


class _Request:
    """Batcher-internal request state (single-threaded after submit)."""

    __slots__ = ("handle", "prompt", "bucket", "gen", "deadline", "seq",
                 "tokens", "slot", "deferred", "chunk_pos")

    def __init__(self, handle: RequestHandle, prompt: np.ndarray, bucket: int,
                 gen: int, deadline: Optional[float], seq: int) -> None:
        self.handle = handle
        self.prompt = prompt  # padded to the bucket
        self.bucket = bucket
        self.gen = gen
        self.deadline = deadline
        self.seq = seq
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.deferred = False  # counted once, not per boarding attempt
        # Chunked prefill: host mirror of the slot's device cursor (None in
        # whole-prompt mode; bucket = prompt fully written, decoding).
        self.chunk_pos: Optional[int] = None

    def board(self, slot: int, first_token: int) -> None:
        self.slot = slot
        self.tokens = [first_token]
        self.handle.t_first_token = time.monotonic()

    def extend(self, toks) -> None:
        self.tokens.extend(int(t) for t in toks)

    def note_spec(self, drafted: int, accepted: int) -> None:
        """Accumulate one segment's draft/accept counts onto the handle."""
        self.handle.drafted += drafted
        self.handle.accepted += accepted

    def remaining(self) -> int:
        return self.gen - len(self.tokens)


def validate_family(cfg) -> None:
    """Refuse the families whose prompts carry more than tokens: the
    audio family's ``frames`` and the vlm family's ``patches``.  The JAX
    package's batcher prefills a wave from its tokens alone, so it cannot
    serve them either; the port serves them one-shot and co-executed
    (``make_generate``, ``launch/serve.py --coexec``) only."""
    if cfg.family in ("audio", "vlm"):
        extra = "frames" if cfg.family == "audio" else "patches"
        raise ValueError(
            f"family {cfg.family!r} cannot be served: its prefill needs the batch's "
            f"{extra!r} beside the tokens, and the batcher prefills from tokens alone (as "
            "the JAX package's does); use one-shot or co-executed generate")


def validate_draft(cfg, draft: DraftSpec) -> None:
    """Fail fast on model pairs speculative serving cannot keep bitwise
    equal to one-shot generate (the server's contract is exact equality, so
    anything that breaks it is a configuration error).  On the kernel path
    the verify's ``(k+1)·n_rep`` rows and the draft's two-row first step
    must fit the decode kernels' row limit."""
    if draft.cfg.vocab != cfg.vocab:
        raise ValueError(
            f"draft vocab {draft.cfg.vocab} != target vocab {cfg.vocab}: "
            "speculative decoding requires a shared tokenizer/vocab"
        )
    for role, c in (("target", cfg), ("draft", draft.cfg)):
        if c.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"{role} family {c.family!r} cannot serve speculatively: "
                "recurrent state (ssm/hybrid) has no per-position timeline "
                "to roll rejected draft tokens back from"
            )
        if c.window:
            raise ValueError(
                f"{role} uses a rolling window ({c.window}): a multi-row "
                "verify scatter would overwrite the oldest ring slots that "
                "its own first row must still attend, breaking bit-identity"
            )
    if cfg.seq_shard_cache:
        raise ValueError("speculative serving is incompatible with "
                         "seq_shard_cache (mesh decode is single-row)")
    from repro_torch.kernels._build import MAX_ROWS

    for role, c, sq in (("target", cfg, draft.k + 1), ("draft", draft.cfg, 2)):
        rows = sq * (c.n_heads // c.n_kv_heads)
        if c.kernel_impl == "cuda" and rows > MAX_ROWS:
            raise ValueError(
                f"draft k={draft.k}: the {role}'s {sq}-row decode takes {rows} rows "
                f"(Sq x n_rep), more than the decode kernels' {MAX_ROWS}")


def validate_chunked(cfg, api, chunk_len: int) -> None:
    """Fail fast on configurations chunked prefill cannot keep bitwise
    equal to whole-prompt prefill.  The chunk stage replays the prompt
    through the decode cache path (scatter, then attend the cache *as
    stored*), so anything that makes the stored prefix differ from what
    one-shot prefill would have attended is a configuration error, not a
    runtime surprise."""
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1: {chunk_len}")
    if api.prefill_chunk is None:
        raise ValueError(
            f"family {cfg.family!r} has no chunked-prefill path: recurrent "
            "state cannot replay a prompt in masked position chunks"
        )
    if cfg.window:
        raise ValueError(
            f"chunked prefill is incompatible with a rolling window "
            f"({cfg.window}): chunk rows must attend the stored prompt "
            "prefix, which the ring overwrites"
        )
    if cfg.cache_dtype:
        raise ValueError(
            "chunked prefill is incompatible with cache_dtype quantization: "
            "later chunks would attend quantized keys where one-shot "
            "prefill attends full-precision ones, breaking bit-identity"
        )
    if cfg.seq_shard_cache:
        raise ValueError("chunked prefill is incompatible with "
                         "seq_shard_cache (mesh decode is single-row)")


class InferenceServer:
    """Accepts independent requests over time and serves them through
    continuously-batched prefill/decode-segment runs on the engine runtime.

    Parameters
    ----------
    cfg, api, params : the model triple (as used by ``make_generate``);
                       params on the groups' device.
    groups           : DeviceGroups to co-execute on (default:
                       ``DeviceGroup("serve:0")`` on ``cuda:0``, which
                       raises without CUDA).  With several groups plus a
                       Dynamic/HGuided scheduler, each batch's slot axis is
                       split across them — the paper's co-execution regime.
    group_batches    : run one sub-batch (and, paged, one block pool +
                       prefix-cache namespace) per DeviceGroup instead of
                       slot-splitting a single batch: join waves are placed
                       by the scheduler's rate-aware placement weights and
                       decode slots migrate between members at segment
                       boundaries (Dynamic/HGuided).  Default: on for
                       multi-group paged serving, off otherwise.
    migration        : MigrationPolicy override (default RateBalancer for
                       rebalancing schedulers under group_batches).
    scheduler        : engine scheduler for slot partitioning (default Static).
    buckets          : prompt-length shape buckets (right-padding contract).
    max_batch        : KV slots per bucket group == max decode batch.
    seg_len          : decode tokens per segment; joins/exits happen only at
                       segment boundaries (the continuous-batching quantum).
    max_new_cap      : upper bound on ``max_new_tokens`` (sizes the caches).
    max_wait_ms      : batch-forming window — a lone request waits at most
                       this long for companions before decoding starts.
    admission        : DeadlineAdmission (deadline forecasting + EDF).
    paged            : PagedSpec: serve from a KV block pool (block tables,
                       prefix cache, copy-on-write) instead of contiguous
                       slot rows.
    draft            : DraftSpec for greedy speculative decoding: segments
                       run draft-k-then-verify steps, emitting 1..k+1
                       tokens per step while streams stay bitwise those of
                       undrafted serving (greedy verify emits the target's
                       own argmax chain whatever the draft's quality).
    chunk_len        : chunked prefill (0 = off): joins run no prefill
                       Program; each decode segment first advances every
                       still-prefilling slot's prompt by ``chunk_len``
                       tokens.  Streams stay bitwise those of whole-prompt
                       serving.
    graph            : replay each segment's loop as a CUDA graph on the
                       card (``ModelKernels``; ``stats()["graphs"]`` counts
                       captures, replays and copy-ins), and let the group
                       replay the prefill waves' graphs
                       (``DeviceGroup.compile_kernel``;
                       ``stats()["group_graphs"]``); False runs them all
                       eagerly.  Ignored with ``kernels``.
    """

    def __init__(self, cfg, api, params, *,
                 groups: Optional[Sequence[DeviceGroup]] = None,
                 scheduler: Optional[Scheduler] = None,
                 buckets: Sequence[int] = (16, 32, 64, 128),
                 max_batch: int = 4,
                 seg_len: int = 4,
                 max_new_cap: int = 64,
                 max_wait_ms: float = 5.0,
                 admission: Optional[DeadlineAdmission] = None,
                 pad_id: int = 0,
                 kernels: Optional[ModelKernels] = None,
                 paged: Optional[PagedSpec] = None,
                 draft: Optional[DraftSpec] = None,
                 chunk_len: int = 0,
                 graph: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 group_batches: Optional[bool] = None,
                 migration: Optional[MigrationPolicy] = None,
                 obs: Optional[EngineObs] = None) -> None:
        validate_family(cfg)
        self.groups = list(groups) if groups else [DeviceGroup("serve:0")]
        self.runtime = Runtime(self.groups)
        self.scheduler = scheduler or Static()
        self.paged = paged
        # Per-group sub-batch regime: one (Paged)BatchGroup — and, paged,
        # one block pool — per DeviceGroup, with rate-aware wave placement
        # and slot migration between members.  Default on for multi-group
        # paged serving (a single pool cannot be slot-split); contiguous
        # multi-group keeps the slot-splitting co-execution unless opted in.
        self.group_batches = (bool(group_batches)
                              if group_batches is not None
                              else (paged is not None and len(self.groups) > 1))
        if paged is not None:
            validate_paged(cfg, self.groups, self.scheduler, paged,
                           group_batches=self.group_batches)
        if draft is not None:
            validate_draft(cfg, draft)
        self.draft = draft
        self.chunk_len = int(chunk_len)  # 0 = whole-prompt prefill Programs
        if self.chunk_len:
            validate_chunked(cfg, api, self.chunk_len)
        self.pool_admission = PoolAdmission()
        self.kernels = kernels or ModelKernels(cfg, api, params, draft=draft, graph=graph)
        if draft is not None and self.kernels.spec_k != draft.k:
            raise ValueError("kernels were built without this draft spec")
        if self.chunk_len and draft is not None:
            # The chunk stage advances the draft cache too.
            validate_chunked(draft.cfg, self.kernels.dapi, self.chunk_len)
        self.buckets = Buckets(buckets)
        self.max_batch = int(max_batch)
        self.seg_len = int(seg_len)
        self.max_new_cap = int(max_new_cap)
        self.max_wait_s = max_wait_ms / 1e3
        self.admission = admission or DeadlineAdmission()
        # Streaming telemetry: one registry shared by the server, the
        # admission layer, and every batch group it forms (rolling
        # quantiles the point-in-time stats() dict cannot provide).
        self.telemetry = telemetry or Telemetry()
        self.admission.telemetry = self.telemetry
        # Live observability: utilization meter + decision journal + flight
        # recorder.  The continuous accounting follows the tracer by
        # default; the flight recorder only runs on failure paths.
        self.obs = obs if obs is not None else EngineObs(
            enabled=tracer().enabled)
        self.obs.attach()
        self._last_counter_emit = 0.0
        # Speculation auto-bypass (opt-in via DraftSpec.auto_bypass):
        # forecast per bucket whether drafted segments beat plain ones and
        # set the segments' mode accordingly, re-probing the losing mode
        # periodically.  Ungated spec servers draft every segment.
        self.spec_gate = (SpecGate(self.admission.model, draft.k)
                          if draft is not None and draft.auto_bypass else None)
        if self.spec_gate is not None and self.obs.enabled:
            self.spec_gate.journal = self.obs.journal
        self._draining: set = set()
        # Per-member decode-slot counts are fixed at construction (paged
        # PoolState shapes must stay stable across group re-forms):
        # max_batch total slots split power-proportionally, one minimum.
        # Rate-awareness lives in wave placement and migration instead.
        self._member_slots: dict = {}
        if self.group_batches:
            shares = proportional_split(
                self.scheduler.placement_weights(self.groups),
                self.max_batch, minimum=1)
            self._member_slots = {g.name: s
                                  for g, s in zip(self.groups, shares)}
        self._policy = migration if migration is not None else (
            RateBalancer()
            if self.group_batches and self.scheduler.rebalances()
            else MigrationPolicy())
        self.pad_id = pad_id
        self._cv = threading.Condition()
        self._poke = False  # wake-up latch: survives notifies that fire
        # while the batcher itself holds the cv
        self._pending: dict = {}        # bucket -> EDF-sorted [_Request]
        self._groups: dict = {}         # bucket -> BatchGroup, or a
        #   {group name: member BatchGroup} map under group_batches
        self._seq = itertools.count()
        self._closing = False
        self._stats = {
            "submitted": 0, "completed": 0, "rejected": 0, "failed": 0,
            "segments": 0, "occupancy_sum": 0, "tokens_out": 0,
            "prefill_waves": 0, "joins": 0, "midstream_joins": 0,
            "deferred": 0, "tokens_drafted": 0, "tokens_accepted": 0,
            "slot_migrations": 0,
        }
        # group name -> counters of its members (group_batches):
        # segments, prefill waves, tokens the segments delivered, slots
        # migrated in and out (stats()["placement"]["per_group"]).
        self._per_group: dict = {}
        self._mem_totals: dict = {}  # bucket -> folded memory_stats of
        #   dissolved contiguous groups (per-bucket lineage, max-rule)
        # bucket -> PoolState; (bucket, group name) under group_batches —
        # each DeviceGroup owns a pool + prefix namespace.
        self._pool_states: dict = {}
        self._thread = threading.Thread(
            target=self._loop, name="enginecl-batcher", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------------- API
    def submit(self, prompt, max_new_tokens: int = 16, *,
               deadline_s: Optional[float] = None) -> RequestHandle:
        """Enqueue one request; thread-safe, returns immediately.

        ``prompt`` is a 1-D int32 token array (padded to its shape bucket);
        ``deadline_s`` is a latency budget relative to now — requests whose
        budget the admission forecast cannot meet are rejected (the handle
        resolves with ``AdmissionError``) instead of queued."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not (1 <= max_new_tokens <= self.max_new_cap):
            raise ValueError(
                f"max_new_tokens must be in [1, {self.max_new_cap}]"
            )
        bucket = self.buckets.bucket_for(len(prompt))
        if bucket is None:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds largest bucket "
                f"{self.buckets.sizes[-1]}"
            )
        now = time.monotonic()
        deadline = None if deadline_s is None else now + deadline_s
        handle = RequestHandle(len(prompt), bucket, max_new_tokens, deadline)
        tr = tracer()
        with self._cv:
            if self._closing:
                raise RuntimeError("server is closed")
            self._stats["submitted"] += 1
            self.telemetry.count("requests_submitted")
            req = _Request(handle, self.buckets.pad(prompt, bucket, self.pad_id),
                           bucket, max_new_tokens, deadline, next(self._seq))
            if tr.enabled:
                tr.async_begin("request", req.seq, bucket=bucket,
                               prompt_len=len(prompt), gen=max_new_tokens)
            if self.paged is not None and not self.pool_admission.admit_submit(
                    self._blocks_needed(bucket, max_new_tokens),
                    self._pool_capacity(bucket)):
                # Never servable: this request's forecast depth exceeds the
                # pool outright — reject now rather than defer forever.
                self._reject(req, tr,
                             f"request needs "
                             f"{self._blocks_needed(bucket, max_new_tokens)}"
                             f" KV blocks, pool capacity is "
                             f"{self._pool_capacity(bucket)}", "pool")
                return handle
            if not self.admission.admit(now, deadline, bucket,
                                        self._segments_left(max_new_tokens,
                                                            bucket),
                                        n_chunks=self._n_chunks(bucket)):
                self._reject(req, tr,
                             f"deadline {deadline_s * 1e3:.1f}ms below "
                             f"forecast for bucket {bucket}", "deadline")
                return handle
            if tr.enabled:
                tr.async_instant("admission", req.seq, admitted=True,
                                 bucket=bucket)
            q = self._pending.setdefault(bucket, [])
            q.append(req)
            q.sort(key=lambda r: edf_key(r.deadline, r.seq))
            self._cv.notify_all()
        return handle

    def stats(self) -> dict:
        with self._cv:
            s = dict(self._stats)
            mem = self._memory_fold()
        occ = s.pop("occupancy_sum")
        # occupancy_mean is the canonical key (guarded: 0.0 when no segment
        # ran yet); mean_occupancy is kept as an alias for older consumers.
        s["occupancy_mean"] = occ / s["segments"] if s["segments"] else 0.0
        s["mean_occupancy"] = s["occupancy_mean"]
        s["acceptance"] = (s["tokens_accepted"] / s["tokens_drafted"]
                           if s["tokens_drafted"] else None)
        s["transfers"] = {g.name: g.transfer_stats() for g in self.groups}
        s["memory"] = mem
        s["admission"] = self.admission.stats()
        s["decisions"] = self.obs.journal.snapshot()
        s["chunk_len"] = self.chunk_len
        if self.spec_gate is not None:
            s["speculation"] = self.spec_gate.stats(list(self.buckets.sizes))
        if self.group_batches:
            s["placement"] = {
                "member_slots": dict(self._member_slots),
                "draining": sorted(self._draining),
                "per_group": {k: dict(v) for k, v in self._per_group.items()},
                # Migrated rows patched in place on the destination's
                # device copy, and refused (that buffer re-uploaded).
                "patches": {g.name: {"patched": g.n_patches, "missed": g.n_patch_misses}
                            for g in self.groups},
            }
        if self.kernels.graphs is not None:
            s["graphs"] = self.kernels.graphs.stats()
        # The groups' compiled kernels: the prefill waves' graphs.
        s["group_graphs"] = {g.name: g.graphs.stats() for g in self.groups
                             if g.graphs is not None}
        return s

    def metrics(self) -> dict:
        """Operator-facing snapshot: pool/slot utilization (blocks in use /
        free / peak, prefix-cache hits, CoW copies, allocated-vs-touched KV
        bytes), per-group transfer & cache-hit counters, each live group's
        last run metrics (which themselves carry the per-run transfer
        counters the Introspector records), and the streaming telemetry
        snapshot (rolling p50/p95/p99 + EMA for TTFT, inter-token latency,
        queue wait, segment time, acceptance, occupancy)."""
        with self._cv:
            mem = self._memory_fold()
            if self.group_batches:
                runs = {f"{b}:{nm}": dict(m.last_run_metrics)
                        for b, ms in self._groups.items()
                        for nm, m in ms.items()}
            else:
                runs = {b: dict(g.last_run_metrics)
                        for b, g in self._groups.items()}
        self._gauge_memory(mem)
        return {
            "memory": mem,
            "efficiency": self._efficiency_snapshot(),
            "groups": {g.name: g.transfer_stats() for g in self.groups},
            "last_runs": runs,
            "speculation": {
                "k": self.draft.k if self.draft else 0,
                "tokens_drafted": self._stats["tokens_drafted"],
                "tokens_accepted": self._stats["tokens_accepted"],
                "acceptance_ema": (
                    self.admission.model.acceptance(self.draft.k)
                    if self.draft else None),
            },
            "telemetry": self.telemetry.snapshot(),
        }

    def _gauge_memory(self, mem: dict) -> None:
        """Fold the memory snapshot into telemetry gauges (blocks/bytes per
        tier — today's pool is single-tier, device; the key names carry the
        tier so a host tier slots in alongside)."""
        for k, v in mem.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.telemetry.gauge(f"mem_{k}", v)

    def prometheus(self, prefix: str = "enginecl") -> str:
        """Prometheus-style text exposition of the streaming telemetry
        (memory and efficiency gauges refreshed from the live pools and
        the utilization meter first)."""
        with self._cv:
            mem = self._memory_fold()
        self._gauge_memory(mem)
        self._efficiency_snapshot()  # refreshes the coexec_* gauges
        return self.telemetry.prometheus(prefix)

    def _efficiency_snapshot(self) -> dict:
        """Live utilization/efficiency view (``metrics()["efficiency"]``):
        per-group busy fractions and token rates from the utilization
        meter's rolling windows, the scheduler's observed capacity rates
        as the speed signal, and the paper's load-balancing efficiency +
        straggler attribution on top.  Also folds the headline numbers
        into telemetry gauges so ``/metrics`` scrapes see them."""
        if not self.obs.enabled:
            return {"enabled": False}
        model = self.admission.model
        with self._cv:
            names = [g.name for g in self.groups]
            watts = {g.name: g.watts for g in self.groups}
            draining = set(self._draining)
        rates = {}
        for g in names:
            per = [r for r in (model.rate(b, g) for b in self.buckets.sizes)
                   if r]
            rates[g] = sum(per) / len(per) if per else None
        snap = self.obs.meter.snapshot(names, rates=rates, watts=watts,
                                       draining=draining)
        tel = self.telemetry
        if snap["efficiency"] is not None:
            tel.gauge("coexec_efficiency", snap["efficiency"])
        if snap["balance"] is not None:
            tel.gauge("coexec_balance", snap["balance"])
        tel.gauge("tokens_delivered_per_s", snap["tokens_per_s"])
        for g, d in snap["groups"].items():
            tel.gauge(f"group_busy_fraction_{g}", d["busy_fraction"])
            tel.gauge(f"group_tokens_per_s_{g}", d["tokens_per_s"])
        return snap

    def health(self) -> tuple:
        """Liveness/readiness view for ``/healthz``: ``(status_code,
        body)``.  200 while the batcher thread is alive, the server is
        accepting, and at least one group is not draining; 503 once any of
        those degrade (a draining group itself reports ``ready: False``
        but does not degrade overall health while others serve)."""
        alive = self._thread.is_alive()
        with self._cv:
            closing = self._closing
            draining = set(self._draining)
            queued = sum(len(q) for q in self._pending.values())
            deferred = self._stats["deferred"]
            rejected = self._stats["rejected"]
            mem = self._memory_fold()
        accepting = alive and not closing
        groups = {g.name: {"draining": g.name in draining,
                           "ready": accepting and g.name not in draining}
                  for g in self.groups}
        ok = accepting and any(d["ready"] for d in groups.values())
        body = {
            "status": "ok" if ok else "degraded",
            "batcher_alive": alive,
            "accepting": accepting,
            "groups": groups,
            "admission_pressure": {"queued": queued, "deferred": deferred,
                                   "rejected": rejected},
        }
        if mem.get("mode") == "paged":
            body["pool"] = {k: mem.get(k) for k in
                            ("blocks_in_use", "blocks_free", "blocks_total")
                            if k in mem}
        return (200 if ok else 503), body

    # Within one bucket's group lineage (successive groups re-use the same
    # logical pool/capacity), capacity-like keys take the max; across
    # buckets — genuinely distinct allocations — everything numeric sums.
    _MEM_MAX = frozenset({"kv_bytes_allocated", "kv_bytes_device",
                          "blocks_peak", "blocks_total", "bytes_per_block"})

    def _memory_fold(self) -> dict:
        # Per-bucket snapshots first.  Paged pools persist across group
        # re-forms (PoolState) and carry cumulative counters themselves;
        # contiguous groups fold their stats per bucket at dissolve time.
        per_bucket: dict = {
            b: dict(st) for b, st in self._mem_totals.items()
        }
        for b, st in self._pool_states.items():
            if st.pool is not None:
                self._fold_memory_into(per_bucket.setdefault(b, {}),
                                       st.pool.stats())
        for b, g in self._groups.items():
            if isinstance(g, dict):  # group_batches: member map
                for nm, m in g.items():
                    if not isinstance(m, PagedBatchGroup):
                        self._fold_memory_into(
                            per_bucket.setdefault((b, nm), {}),
                            m.memory_stats())
            elif not isinstance(g, PagedBatchGroup):
                self._fold_memory_into(per_bucket.setdefault(b, {}),
                                       g.memory_stats())
        acc: dict = {}
        for st in per_bucket.values():
            for k, v in st.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    acc[k] = v
                else:
                    acc[k] = acc.get(k, 0) + v
        return acc

    def _fold_memory_into(self, acc: dict, st: dict) -> None:
        for k, v in st.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                acc[k] = v
            elif k in self._MEM_MAX:
                acc[k] = max(acc.get(k, 0), v)
            else:
                acc[k] = acc.get(k, 0) + v

    def _blocks_needed(self, bucket: int, gen: int) -> int:
        return blocks_needed(bucket, gen, self.seg_len, self.paged.block_len,
                             window=self.kernels.cfg.window or 0,
                             max_seq=self._max_seq(bucket),
                             spec_step=(self.draft.k + 1) if self.draft else 0)

    def _pool_capacity(self, bucket: int) -> int:
        # Under group_batches each member owns a pool sized for its slot
        # share; a request is servable if the largest member's pool can
        # cover it.
        n_slots = (max(self._member_slots.values())
                   if self.group_batches and self._member_slots
                   else self.max_batch)
        return pool_capacity(self.paged, n_slots,
                             self._max_seq(bucket),
                             self.kernels.cfg.window or 0)

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop accepting requests.  ``drain=True`` serves everything
        already queued or in flight first; ``drain=False`` rejects queued
        requests but still finishes boarded ones."""
        with self._cv:
            self._closing = True
            if not drain:
                tr = tracer()
                for q in self._pending.values():
                    for r in q:
                        self._reject(r, tr, "server closed", "closed")
                    q.clear()
            self._cv.notify_all()
        self._thread.join(timeout)
        self.runtime.shutdown()
        self.obs.detach()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- event loop
    def _notify(self) -> None:
        with self._cv:
            self._poke = True
            self._cv.notify_all()

    def _loop(self) -> None:
        try:
            while True:
                with self._cv:
                    timer = self._advance_all()
                    if (self._closing and not self._pending_any()
                            and not self._groups):
                        return
                    if self._poke:
                        # A notify landed during _advance_all (the cv is
                        # re-entrant, so a synchronously-completed handle's
                        # callback fires while this thread holds it): the
                        # notify_all was unseen by wait(), so loop again
                        # instead of sleeping on a stale signal.
                        self._poke = False
                        continue
                    self._cv.wait(timeout=timer)
                    self._poke = False
        except BaseException as exc:  # noqa: BLE001 — a dying batcher must
            self._crash(exc)  # resolve every handle, not strand clients

    def _crash(self, exc: BaseException) -> None:
        """Batcher thread failed (scheduling bug, runtime shut down under
        us): fail every outstanding handle so no client blocks forever on
        ``result()``, then let the thread exit."""
        import traceback

        traceback.print_exc()
        self._postmortem("batcher_crashed", errors=[repr(exc)])
        with self._cv:
            victims: List[_Request] = []
            for q in self._pending.values():
                victims.extend(q)
                q.clear()
            for grp in self._groups.values():
                if isinstance(grp, dict):
                    for m in grp.values():
                        victims.extend(m.fail_all([repr(exc)]))
                else:
                    victims.extend(grp.fail_all([repr(exc)]))
            self._groups.clear()
            tr = tracer()
            for req in victims:
                self._stats["failed"] += 1
                self.telemetry.count("requests_failed")
                if tr.enabled:
                    tr.async_end("request", req.seq, status="failed")
                req.handle._fail(ServeError(f"batcher crashed: {exc!r}"))

    def _pending_any(self) -> bool:
        return any(self._pending.values())

    def _advance_all(self) -> Optional[float]:
        """One scheduling pass (cv held).  Returns seconds until the next
        forming-window expiry, or None to sleep until notified."""
        now = time.monotonic()
        # 1. advance live groups (harvest finished segments, merge prefills,
        #    board joiners, chain next segments, dissolve idle groups).
        for bucket in list(self._groups):
            entry = self._groups[bucket]
            if isinstance(entry, dict):  # group_batches: member map
                self._advance_members(bucket, entry, now)
                for nm in list(entry):
                    m = entry[nm]
                    if m.dead or (m.idle()
                                  and (not self._pending.get(bucket)
                                       or nm in self._draining)):
                        if isinstance(m, PagedBatchGroup):
                            m.detach()
                        else:
                            self._fold_memory_into(
                                self._mem_totals.setdefault((bucket, nm), {}),
                                m.memory_stats())
                        del entry[nm]
                if not entry:
                    del self._groups[bucket]
                continue
            grp = entry
            self._advance_group(grp, now)
            if grp.dead or (grp.idle() and not self._pending.get(bucket)):
                if isinstance(grp, PagedBatchGroup):
                    grp.detach()  # pool + prefix cache outlive the group
                else:
                    self._fold_memory_into(
                        self._mem_totals.setdefault(bucket, {}),
                        grp.memory_stats())
                del self._groups[bucket]
        # 2. form new groups for buckets whose window expired / filled.
        timer = None
        for bucket, q in self._pending.items():
            if not q or bucket in self._groups:
                continue
            oldest = min(r.handle.t_arrival for r in q)
            expires = oldest + self.max_wait_s
            if len(q) >= self.max_batch or now >= expires or self._closing:
                if self.group_batches:
                    members: dict = {}
                    self._groups[bucket] = members
                    self._ensure_members(bucket, members)
                    self._board_members(bucket, members, now, set())
                    continue
                if self.paged is not None:
                    state = self._pool_states.setdefault(bucket, PoolState())
                    grp = PagedBatchGroup(self.kernels, self.runtime,
                                          self.scheduler, bucket,
                                          self.max_batch, self.seg_len,
                                          self._max_seq(bucket), self.paged,
                                          state, chunk_len=self.chunk_len)
                else:
                    grp = BatchGroup(self.kernels, self.runtime,
                                     self.scheduler, bucket, self.max_batch,
                                     self.seg_len, self._max_seq(bucket),
                                     chunk_len=self.chunk_len)
                grp.telemetry = self.telemetry
                grp.spec_gate = self.spec_gate
                self._groups[bucket] = grp
                self._board(grp, now)
            else:
                wait = expires - now
                timer = wait if timer is None else min(timer, wait)
        return timer

    def _max_seq(self, bucket: int) -> int:
        if self.draft is not None:
            # Speculative slots write every verify row: the deepest
            # position a segment can touch is its start (<= bucket +
            # max_new_cap - 2) plus seg_len * (k+1) rows; reserve the cap,
            # not the expected acceptance.
            return bucket + self.max_new_cap + self.seg_len * (self.draft.k + 1)
        return bucket + segments_for(self.max_new_cap, self.seg_len) * self.seg_len

    def _segments_left(self, gen: int, bucket: int) -> int:
        """Decode segments a request with ``gen`` tokens still owed needs —
        the admission forecast's work unit.  Under speculation this uses the
        observed expected tokens-per-step (1 + acceptance·k), so deadline
        forecasts tighten as acceptance evidence accumulates; when the
        bypass gate forecasts this bucket runs plain segments, so does the
        forecast."""
        if self.draft is None:
            return segments_for(gen, self.seg_len)
        if self.spec_gate is not None and not self.spec_gate.speculating(bucket):
            return segments_for(gen, self.seg_len)
        tps = self.admission.model.tokens_per_step(self.draft.k)
        return spec_segments_for(gen, self.seg_len, tps)

    def _n_chunks(self, bucket: int) -> int:
        """Mixed-phase segments a join spends prefilling (0 = whole-prompt
        prefill)."""
        return chunks_for(bucket, self.chunk_len) if self.chunk_len else 0

    def _advance_group(self, grp: BatchGroup, now: float) -> None:
        """Legacy single-batch advance: harvest/merge, board, chain."""
        if not self._harvest_merge(grp, None):
            return
        # Starting a prefill wave touches no group mirrors — it overlaps a
        # running segment so joiners are ready at the next boundary.
        if grp.prefill_handle is None:
            self._board(grp, now)
        if grp.seg_handle is None and any(grp.slots):
            grp.submit_segment(self._notify)

    def _harvest_merge(self, grp: BatchGroup, gname: Optional[str]) -> bool:
        """Harvest a finished segment and merge a finished prefill (cv
        held); feeds the service model (segment/prefill times, per-group
        rates, spec-vs-plain mode times).  Returns False when the group
        failed — its requests are already resolved."""
        if grp.seg_handle is not None and grp.seg_handle.done():
            res = grp.harvest_segment()
            if "errors" in res:
                self._fail_group(grp, res["errors"])
                return False
            model = self.admission.model
            model.observe("segment", grp.bucket, res["seconds"])
            mode = res.get("mode")
            if mode is not None:
                # Mode-split EMAs drive the SpecGate's speedup forecast.
                model.observe("seg_spec" if mode == "spec" else "seg_plain",
                              grp.bucket, res["seconds"])
            if gname is not None and res["seconds"] > 0:
                # Capacity rate (slots, not occupancy: speed, not load) —
                # the scheduler's placement signal for this member.
                rate = grp.n_slots * grp.seg_len / res["seconds"]
                model.observe_rate(grp.bucket, gname, rate)
                self.telemetry.gauge(f"group_rate_{gname}", rate)
            self._stats["segments"] += 1
            self._count_group(grp, segments=1, tokens=res["tokens"])
            self._stats["occupancy_sum"] += res["n_active"]
            self.telemetry.observe("segment_s", res["seconds"])
            self.telemetry.observe("occupancy", res["n_active"])
            if self.obs.enabled or tracer().enabled:
                self._note_segment(grp, gname, res)
            drafted = res.get("drafted", 0)
            if drafted:
                self._stats["tokens_drafted"] += drafted
                self._stats["tokens_accepted"] += res["accepted"]
                model.observe_acceptance(self.draft.k, res["accepted"] / drafted)
                self.telemetry.observe("acceptance", res["accepted"] / drafted)
            for req in res["finished"]:
                self._retire(req)
        # Merging rewrites the segment Program's host mirrors, so it is only
        # legal at a segment boundary (an in-flight segment may slice them
        # at any moment).
        if (grp.seg_handle is None and grp.prefill_handle is not None
                and grp.prefill_handle.done()):
            res = grp.merge_prefill()
            if not self.chunk_len:  # chunked joins run no prefill Program
                self.admission.model.observe("prefill", grp.bucket, res["seconds"])
                self.telemetry.observe("prefill_s", res["seconds"])
            tr = tracer()
            if res["failed"]:
                self._postmortem(
                    "prefill_failed", bucket=grp.bucket,
                    errors=res.get("errors", ["prefill failed"]))
            for req in res["failed"]:
                self._stats["failed"] += 1
                self.telemetry.count("requests_failed")
                if tr.enabled:
                    tr.async_end("request", req.seq, status="failed")
                req.handle._fail(
                    ServeError("; ".join(res.get("errors", ["prefill failed"])))
                )
            if res["joined"] and self.obs.enabled:
                # First tokens delivered by this member's prefill wave.
                self.obs.meter.note_tokens(self._meter_key(gname),
                                           res["joined"])
            if res["joined"]:
                self._stats["joins"] += res["joined"]
                if self._stats["segments"]:
                    self._stats["midstream_joins"] += res["joined"]
            # gen=1 requests are complete straight out of prefill.
            for slot, req in grp.active():
                if req.remaining() <= 0:
                    self._retire(req)
                    grp.release_slot(slot)
        return True

    def _meter_key(self, gname: Optional[str]) -> str:
        """Utilization-meter key for a harvested batch: the member's
        DeviceGroup under group_batches, the lone group's name otherwise,
        and a pseudo-group for slot-split co-execution (its segments span
        groups — busy attribution still comes per-device from the
        Introspector stream)."""
        if gname is not None:
            return gname
        return self.groups[0].name if len(self.groups) == 1 else "_batch"

    def _note_segment(self, grp: BatchGroup, gname: Optional[str],
                      res: dict) -> None:
        """Per-harvest observability (cv held): delivered tokens into the
        meter's rolling window, and counter-track samples — occupancy,
        tokens/s, blocks in use, efficiency — into the trace, so one
        ``--trace-out`` file shows spans *and* load curves.  The
        efficiency sample (a windowed reduction, not a counter read) is
        rate-limited."""
        key = self._meter_key(gname)
        tokens = res.get("tokens", 0)
        if self.obs.enabled and tokens:
            self.obs.meter.note_tokens(key, tokens)
        tr = tracer()
        if not tr.enabled:
            return
        tr.counter("occupancy", **{key: res["n_active"]})
        if res["seconds"] > 0:
            tr.counter("tokens_per_s", **{key: tokens / res["seconds"]})
        blocks = grp.memory_stats().get("blocks_in_use")
        if blocks is not None:
            tr.counter("blocks_in_use", **{key: blocks})
        now = time.monotonic()
        if self.obs.enabled and now - self._last_counter_emit >= 0.2:
            self._last_counter_emit = now
            snap = self._efficiency_snapshot()
            if snap.get("efficiency") is not None:
                tr.counter("efficiency", efficiency=snap["efficiency"],
                           balance=snap["balance"])

    # ------------------------------------------------- group_batches regime
    def _make_member(self, bucket: int, g: DeviceGroup):
        """One per-DeviceGroup sub-batch: pinned to its group (``target``),
        driven by a private Static scheduler (the single member device
        takes every slot in one package), sized by the fixed slot split."""
        n_slots = self._member_slots.get(g.name, 0)
        if n_slots < 1:
            return None
        if self.paged is not None:
            state = self._pool_states.setdefault((bucket, g.name),
                                                 PoolState())
            grp = PagedBatchGroup(self.kernels, self.runtime, Static(),
                                  bucket, n_slots, self.seg_len,
                                  self._max_seq(bucket), self.paged, state,
                                  chunk_len=self.chunk_len, target=[g])
        else:
            grp = BatchGroup(self.kernels, self.runtime, Static(), bucket,
                             n_slots, self.seg_len, self._max_seq(bucket),
                             chunk_len=self.chunk_len, target=[g])
        grp.telemetry = self.telemetry
        grp.spec_gate = self.spec_gate
        return grp

    def _ensure_members(self, bucket: int, members: dict) -> None:
        """Instantiate missing members (initial formation, and groups that
        joined the live server since this bucket's members formed)."""
        for g in self.groups:
            if g.name in self._draining or g.name in members:
                continue
            m = self._make_member(bucket, g)
            if m is not None:
                members[g.name] = m

    def _advance_members(self, bucket: int, members: dict,
                         now: float) -> None:
        """One scheduling pass over a bucket's member groups: harvest and
        merge each, apply drain and policy migrations at the boundaries
        that line up, place the join wave, chain next segments."""
        self._ensure_members(bucket, members)
        for nm in list(members):
            self._harvest_merge(members[nm], nm)
        live = {nm: m for nm, m in members.items() if not m.dead}
        hold: set = set()
        if len(live) > 1:
            self._drain_migrations(live)
            weights = self._member_weights(bucket, live)
            moves, hold = self._policy.plan(live, weights)
            for src, slot, dst in moves:
                ok = live[src].migrate_slot_to(slot, live[dst])
                if ok:
                    self._stats["slot_migrations"] += 1
                    self.telemetry.count("slot_migrations")
                    self._count_group(live[src], migrations_out=1)
                    self._count_group(live[dst], migrations_in=1)
                self.obs.decision(
                    "migration", bucket=bucket, src=src, slot=slot, dst=dst,
                    outcome="moved" if ok else "blocked",
                    reason=type(self._policy).__name__,
                    weights={k: round(w, 4) for k, w in weights.items()},
                    **getattr(self._policy, "last_info", {}))
        self._board_members(bucket, live, now, hold)
        for nm, grp in live.items():
            if grp.seg_handle is not None or nm in hold:
                continue
            if nm in self._draining and any(grp.slots):
                others = [m for o, m in live.items()
                          if o != nm and o not in self._draining]
                if others and any(not m.at_boundary() for m in others):
                    # An acceptor's boundary is coming: hold this member's
                    # slots at the boundary so they can migrate out then.
                    continue
            if any(grp.slots):
                grp.submit_segment(self._notify)

    def _drain_migrations(self, members: dict) -> None:
        """Move every slot of draining members that can leave right now to
        a non-draining member at a boundary with room."""
        for nm in list(members):
            if nm not in self._draining:
                continue
            grp = members[nm]
            if not grp.at_boundary():
                continue
            for slot, req in enumerate(list(grp.slots)):
                if req is None:
                    continue
                for onm, other in members.items():
                    if onm == nm or onm in self._draining:
                        continue
                    if grp.migrate_slot_to(slot, other):
                        self._stats["slot_migrations"] += 1
                        self.telemetry.count("slot_migrations")
                        self._count_group(grp, migrations_out=1)
                        self._count_group(other, migrations_in=1)
                        self.obs.decision(
                            "migration", src=nm, slot=slot, dst=onm,
                            outcome="moved", reason="drain")
                        break

    def _member_weights(self, bucket: int, members: dict) -> dict:
        devs = [g for g in self.groups if g.name in members]
        rates = {g.name: self.admission.model.rate(bucket, g.name)
                 for g in devs}
        return {g.name: w for g, w in
                zip(devs, self.scheduler.placement_weights(devs, rates))}

    def _board_members(self, bucket: int, members: dict, now: float,
                       hold: set) -> None:
        """Place the pending join wave across boardable members: the
        scheduler's placement weights (observed per-group rates for
        adaptive schedulers, fixed proportions for Static) pick how many
        requests each member prefills this wave."""
        q = self._pending.get(bucket)
        if not q:
            return
        devs = [g for g in self.groups
                if g.name in members and g.name not in hold
                and g.name not in self._draining
                and members[g.name].prefill_handle is None]
        if not devs:
            return
        rates = {g.name: self.admission.model.rate(bucket, g.name)
                 for g in devs}
        weights = self.scheduler.placement_weights(devs, rates)
        caps = [len(members[g.name].free_slots()) for g in devs]
        loads = [sum(1 for r in members[g.name].slots if r is not None)
                 for g in devs]
        counts = plan_wave(weights, caps, loads, len(q))
        if self.obs.enabled and any(counts):
            self.obs.decision(
                "placement", bucket=bucket, queue=len(q), reason="plan_wave",
                weights={g.name: round(w, 4)
                         for g, w in zip(devs, weights)},
                rates={g.name: rates[g.name] for g in devs},
                caps={g.name: c for g, c in zip(devs, caps)},
                loads={g.name: ld for g, ld in zip(devs, loads)},
                outcome={g.name: c for g, c in zip(devs, counts)})
        for g, c in zip(devs, counts):
            if c > 0:
                self._board(members[g.name], now, limit=c)

    def _count_group(self, grp: BatchGroup, **deltas) -> None:
        """Add ``deltas`` to the counters of the DeviceGroup a member is
        pinned to (nothing for an unpinned batch)."""
        if grp.target:
            d = self._per_group.setdefault(grp.target[0].name, dict.fromkeys(
                ("segments", "prefill_waves", "tokens", "migrations_in",
                 "migrations_out"), 0))
            for k, v in deltas.items():
                d[k] += v

    # --------------------------------------------------------- elastic API
    def join_group(self, group: DeviceGroup) -> None:
        """Attach a DeviceGroup to the live server (elastic scale-out) —
        or reactivate a draining one by name.  The runtime spins up its
        worker thread immediately; it becomes a boarding and migration
        target for every bucket at the next scheduling pass."""
        with self._cv:
            if not self.group_batches:
                raise RuntimeError(
                    "join_group requires group_batches serving")
            if any(g.name == group.name for g in self.groups):
                self._draining.discard(group.name)
                self.obs.decision("elastic", action="reactivate",
                                  group=group.name)
                self._cv.notify_all()
                return
            self.runtime.add_group(group)
            self.groups.append(group)
            shares = proportional_split(
                self.scheduler.placement_weights(self.groups),
                self.max_batch, minimum=1)
            self._member_slots[group.name] = shares[len(self.groups) - 1]
            self.obs.decision("elastic", action="join", group=group.name,
                              slots=self._member_slots[group.name])
            self._cv.notify_all()

    def drain_group(self, name: str) -> None:
        """Stop placing work on ``name`` and migrate its decode slots out
        at segment boundaries; its per-bucket members dissolve once empty.
        The DeviceGroup stays attached (``join_group`` reactivates it)."""
        with self._cv:
            if not self.group_batches:
                raise RuntimeError(
                    "drain_group requires group_batches serving")
            if not any(g.name == name for g in self.groups):
                raise ValueError(f"unknown group {name!r}")
            active = [g.name for g in self.groups
                      if g.name not in self._draining]
            if name in active and len(active) <= 1:
                raise ValueError("cannot drain the only active group")
            self._draining.add(name)
            self.obs.decision("elastic", action="drain", group=name)
            self._cv.notify_all()

    def _board(self, grp: BatchGroup, now: float,
               limit: Optional[int] = None) -> None:
        """Start a prefill wave for as many pending requests as there are
        free slots, EDF order, re-checking each deadline against the
        forecast of the work *now* remaining.  With a paged pool, boarding
        additionally requires the pool to cover the request's forecast
        depth in blocks — otherwise the request is *deferred* (left queued,
        EDF order intact) until exits free blocks, never allowed to corrupt
        a live slot by overcommitting."""
        q = self._pending.get(grp.bucket)
        if not q:
            return
        free = len(grp.free_slots())
        if limit is not None:
            free = min(free, limit)
        wave: List[_Request] = []
        reserved = 0
        tr = tracer()
        while q and len(wave) < free:
            # Deadline admission first: a doomed head request must be culled
            # (popped + rejected) even when the pool cannot board it — a
            # memory deferral would otherwise park it at the head of the EDF
            # queue and starve feasible requests queued behind it.
            if not self.admission.admit(now, q[0].deadline, grp.bucket,
                                        self._segments_left(q[0].gen,
                                                            grp.bucket),
                                        n_chunks=self._n_chunks(grp.bucket)):
                req = q.pop(0)
                self._reject(req, tr,
                             "deadline unreachable at boarding time",
                             "deadline_boarding")
                continue
            if not self.pool_admission.admit_board(
                    grp.reserve_estimate(q[0]),
                    grp.memory_available(reserved)):
                if not q[0].deferred:  # count requests, not wake-ups
                    q[0].deferred = True
                    self._stats["deferred"] += 1
                    self.telemetry.count("requests_deferred")
                    self.obs.decision(
                        "admission", outcome="deferred", seq=q[0].seq,
                        bucket=grp.bucket, reason="pool pressure",
                        need_blocks=grp.reserve_estimate(q[0]),
                        available=grp.memory_available(reserved))
                    if tr.enabled:
                        tr.async_instant("deferred", q[0].seq,
                                         bucket=grp.bucket)
                break
            req = q.pop(0)
            req.handle.t_admitted = time.monotonic()
            self.telemetry.observe("queue_wait_s",
                                   req.handle.t_admitted
                                   - req.handle.t_arrival)
            if tr.enabled:
                tr.async_instant("board", req.seq, bucket=grp.bucket)
            reserved += grp.reserve_estimate(req)
            wave.append(req)
        if wave:
            self._stats["prefill_waves"] += 1
            self._count_group(grp, prefill_waves=1)
            grp.start_prefill(wave, self._notify)

    def _reject(self, req: _Request, tr, reason: str, kind: str) -> None:
        """Resolve one request as rejected (stats + telemetry + trace)."""
        self._stats["rejected"] += 1
        self.telemetry.count("requests_rejected")
        self.obs.decision("admission", outcome="rejected", reject_kind=kind,
                          seq=req.seq, bucket=req.bucket,
                          deadline=req.deadline, reason=reason)
        if tr.enabled:
            tr.async_instant("admission", req.seq, admitted=False, kind=kind)
            tr.async_end("request", req.seq, status="rejected", kind=kind)
        req.handle._reject(reason)

    def _retire(self, req: _Request) -> None:
        self._stats["completed"] += 1
        self._stats["tokens_out"] += req.gen
        req.handle._finish(np.asarray(req.tokens[: req.gen], np.int32))
        h = req.handle
        self.telemetry.count("requests_completed")
        self.telemetry.count("tokens_out", req.gen)
        latency = h.t_done - h.t_arrival
        self.telemetry.observe("latency_s", latency)
        if h.t_first_token is not None:
            ttft = h.t_first_token - h.t_arrival
            self.telemetry.observe("ttft_s", ttft)
            if req.gen > 1:
                # Inter-token latency: decode time amortized over the
                # tokens after the first (matches the bench harness's
                # external (latency - ttft)/(n - 1) definition exactly).
                self.telemetry.observe(
                    "itl_s", (latency - ttft) / (req.gen - 1))
        tr = tracer()
        if tr.enabled:
            tr.async_end("request", req.seq, status="ok", tokens=req.gen)

    def _fail_group(self, grp: BatchGroup, errors: Sequence[str]) -> None:
        self._postmortem("segment_failed", errors=list(errors),
                         bucket=grp.bucket)
        tr = tracer()
        for req in grp.fail_all(errors):
            self._stats["failed"] += 1
            self.telemetry.count("requests_failed")
            if tr.enabled:
                tr.async_end("request", req.seq, status="failed")
            req.handle._fail(ServeError("; ".join(errors)))

    def _postmortem(self, reason: str, *, errors: Sequence[str] = (),
                    **context) -> None:
        """Flight-recorder dump on a failure path (RunError surfacing as a
        failed segment/prefill, poisoned dependents, a dying batcher).
        Diagnostics must never raise into the failure handling that
        triggered them, and never block a healthy path — the recorder
        rate-limits itself."""
        try:
            ctx = {"errors": list(errors), **context}
            self.obs.postmortem(
                reason, context=ctx, stats=self.stats(),
                efficiency=self._efficiency_snapshot(),
                telemetry=self.telemetry.snapshot())
        except Exception:  # noqa: BLE001
            pass
