"""Heterogeneous data-parallel trainer: EngineCL applied to training.

Device groups of unequal throughput (the CPU and a GPU from ``discover``,
or groups slowed by ``sim_time_per_wi``) train one model.  Each step:

1. the shares: the global batch split over the groups in proportion to
   their EMA-rated powers (``core.rating.ThroughputRater``), in multiples
   of ``quantum`` sequences, the rounding drift onto the strongest group;
2. every group computes its share's gradients concurrently on its
   persistent worker (``core.runtime.GroupExecutor``), on its own device
   (``group.device``) and stream, with a copy of the parameters made there
   for this step, through ``torch.autograd.grad`` (no ``.grad`` is shared
   between the groups' threads);
3. the gradients are combined on the host device, weighted by the
   sequences each group took, optionally through int8 with error feedback
   (the cross-pod link), and one AdamW step is applied;
4. the measured seconds re-rate the groups: a straggler gets a smaller
   share next step.

The port of the JAX package's ``train/hetero.py``.  Its ``jax.jit`` of
the gradient is here a CUDA graph per device (``serve/graphs.py``),
captured on the first step of each share size (shares change with the
rater, as the jit recompiles per shape) on the group's worker thread and
stream, and replayed; its ``jax.device_put`` of the parameters is the copy
into the graph's static parameter leaves, each step.  The graphs of one
scope (a group's) draw on one private memory pool and write their
gradients into one set of static buffers, whatever the share size, so the
card's memory stays that of the largest share however many sizes the
rater visits (``GraphCache(pool_per_scope=True)``); that is safe because
the loss is read (``.item()``) and the gradients are copied out of the
graph's memory after each replay, before the scope's next.  The CPU group
runs eagerly on a copy of the parameters.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceGroup
from repro_torch.core.rating import ThroughputRater
from repro_torch.core.runtime import GroupExecutor
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw_update, lr_schedule
from repro_torch.serve.graphs import GraphCache
from repro_torch.train.compression import ErrorFeedback, decompress_tree


class HeteroTrainer:
    def __init__(self, cfg, api, groups: List[DeviceGroup], *, quantum: int = 1,
                 compress: bool = False, lr_kwargs: Optional[dict] = None) -> None:
        self.cfg = cfg
        self.api = api
        self.groups = groups
        self.quantum = quantum  # shares are multiples of this many sequences
        self.compress = compress
        self.lr_kwargs = lr_kwargs or {}
        self.rater = ThroughputRater(alpha=0.5)
        self.rater.reset({id(g): g.power for g in groups})
        self._ef = {id(g): ErrorFeedback() for g in groups}
        self._executor = GroupExecutor(groups, name="hetero")
        self._graphs: dict = {}  # device -> the GraphCache of its gradient graphs

    def shutdown(self) -> None:
        """Stop the resident per-group workers and join them (daemon
        threads; optional)."""
        self._executor.shutdown(wait=True)

    def grads(self, params, batch, device, scope=None) -> tuple[float, dict]:
        """(loss, gradient tree) of ``forward_train`` on ``batch`` at a copy
        of ``params`` on ``device``; the gradients stay on ``device``.  On
        a CUDA device a replay of the device's gradient graph for this
        batch shape and ``scope`` (captured at its first call, in the
        scope's pool), on the current stream, the parameters copied into
        its static leaves and the gradients written into the scope's;
        elsewhere eager.  Calls that may run at once take scopes of their
        own (the step passes each group's name: two groups on streams of
        one card never share a static buffer)."""
        device = torch.device(device)
        mb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if not GraphCache.accepts(device):
            leaves = [p.detach().to(device, copy=True) for p in tree_leaves(params)]
            loss, *g = self._grad_body(params, leaves, mb)
            return loss.item(), tree_unflatten(params, g)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        graphs = self._graphs.setdefault(device, GraphCache(pool_per_scope=True))
        keys = sorted(mb)
        leaves = [p.detach().to(device) for p in tree_leaves(params)]
        # The scope's gradient buffers, one set for every share size.
        out = graphs.statics({"grads": [torch.empty(p.shape, dtype=p.dtype, device="meta")
                                        for p in leaves]}, device, scope)["grads"]
        inputs = {"params": leaves, "batch": [mb[k] for k in keys], "grads": out}

        def body(st, n):
            loss, *g = self._grad_body(params, st["params"], dict(zip(keys, st["batch"])))
            for buf, gi in zip(st["grads"], g):
                buf.copy_(gi)
            return (loss, *st["grads"])

        loss, *g = graphs.copy_out(graphs.bind("grads", 1, (), inputs, body, scope=scope)())
        return loss.item(), tree_unflatten(params, g)

    def _grad_body(self, params, leaves: list, mb: dict) -> tuple:
        """(loss, *gradients in ``tree_leaves`` order) of ``forward_train``
        on ``mb`` at the parameter ``leaves`` (shaped as ``params``),
        through ``torch.autograd.grad``; the leaves are left without
        ``requires_grad``."""
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = self.api.forward_train(tree_unflatten(params, leaves), mb, self.cfg)
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return (loss.detach(), *[torch.zeros_like(p) if gi is None else gi
                                 for p, gi in zip(leaves, g)])

    # ---------------------------------------------------------------- shares
    def partition(self, batch_size: int) -> List[int]:
        powers = np.array([self.rater.power(id(g)) for g in self.groups])
        raw = batch_size * powers / powers.sum()
        q = self.quantum
        shares = np.maximum(q, (np.round(raw / q) * q).astype(int))
        # Fix rounding drift onto the most powerful group.
        drift = batch_size - int(shares.sum())
        shares[int(np.argmax(powers))] += drift
        if shares.min() < 0:
            raise ValueError(f"unsatisfiable shares {shares} for batch {batch_size}")
        return shares.tolist()

    # ------------------------------------------------------------------ step
    def submit_step(self, state: dict, batch: dict) -> "StepHandle":
        """Enqueue this step's per-group gradient jobs; non-blocking.

        The shares go to the persistent per-group workers atomically
        (``GroupExecutor.submit_batch``) and a future-like ``StepHandle``
        is returned; its ``result()`` blocks, then combines and applies
        AdamW."""
        bsz = batch["tokens"].shape[0]
        shares = self.partition(bsz)
        offsets = np.concatenate([[0], np.cumsum(shares)]).astype(int)
        handle = StepHandle(self, state, shares, n_workers=len(self.groups))

        def worker(i: int, group: DeviceGroup) -> None:
            try:
                lo, hi = offsets[i], offsets[i + 1]
                t0 = time.perf_counter()
                with group.stream_context():
                    if group.stream is not None:
                        # The last step's update, on the default stream,
                        # precedes this share's copy of the parameters.
                        group.stream.wait_stream(torch.cuda.default_stream(group.device))
                    loss, grads = self.grads(state["params"], {k: v[lo:hi] for k, v in
                                                               batch.items()}, group.device,
                                             scope=group.name)
                if group.device.type == "cuda":
                    torch.cuda.synchronize(group.device)
                dt = time.perf_counter() - t0
                group.simulate_service_time(hi - lo, dt)
                dt = max(time.perf_counter() - t0, 1e-9)
                if self.compress:
                    grads = decompress_tree(self._ef[id(group)].compress(grads))
                with handle._lock:
                    handle._results[i] = (loss, grads, hi - lo, dt)
            except BaseException as e:  # noqa: BLE001 -- even SystemExit/
                # KeyboardInterrupt must surface as a step error: the
                # executor swallows escapees, and a silently missing share
                # would renormalize into a wrong gradient.
                with handle._lock:
                    handle._errors.append(f"{group.name}: {e!r}")

        # Persistent per-group workers, enqueued atomically w.r.t. shutdown:
        # steps never spawn threads, and a raced shutdown() cannot strand a
        # partially-submitted step (it raises here instead).
        self._executor.submit_batch([
            (g, (lambda i=i, g=g: worker(i, g)), handle._worker_finished)
            for i, g in enumerate(self.groups)
        ])
        return handle

    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """Blocking step: ``submit_step`` + combine."""
        return self.submit_step(state, batch).result()

    def _combine(self, state: dict, shares: list,
                 results: dict[int, tuple]) -> tuple[dict, dict]:
        # Weighted combine by actual sequence counts, on the parameters'
        # device (the host-side cross-group reduction).
        dev = tree_leaves(state["params"])[0].device
        total = sum(r[2] for r in results.values())
        combined = None
        loss = 0.0
        for i, (l, g, n, dt) in sorted(results.items()):
            w = n / total
            loss += l * w
            scaled = tree_map(lambda x: x.to(dev, torch.float32) * w, g)
            combined = scaled if combined is None else tree_map(torch.add, combined, scaled)
            self.rater.update(id(self.groups[i]), n / dt)

        lr = lr_schedule(state["step"], **self.lr_kwargs)
        new_params, new_opt = adamw_update(state["params"], combined, state["opt"],
                                           state["step"], lr=lr)
        state["step"].add_(1)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"]}
        metrics = {
            "loss": loss,
            "shares": shares,
            "powers": [self.rater.power(id(g)) for g in self.groups],
            "grads": combined,
            "seconds": [results[i][3] for i in sorted(results)],
        }
        return new_state, metrics


class StepHandle:
    """Future-like handle for one in-flight training step (mirrors the
    runtime's ``RunHandle``: completion event + lock-protected errors)."""

    def __init__(self, trainer: HeteroTrainer, state: dict, shares: list,
                 n_workers: int) -> None:
        self._trainer = trainer
        self._state = state
        self._shares = shares
        self._lock = threading.Lock()
        self._results: dict[int, tuple] = {}
        self._errors: list[str] = []
        self._pending = n_workers
        self._done = threading.Event()
        self._combined: Optional[tuple] = None

    def _worker_finished(self) -> None:
        with self._lock:
            self._pending -= 1
            last = self._pending <= 0
        if last:
            self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout=None) -> tuple[dict, dict]:
        """Block for the gradient jobs, then combine: (new_state, metrics)."""
        if not self.wait(timeout):
            raise TimeoutError("training step did not complete within timeout")
        if self._errors:
            raise RuntimeError("; ".join(self._errors))
        # Combine exactly once, under the lock: rater updates aren't
        # idempotent, and result() may be called from several threads.
        with self._lock:
            if self._combined is None:
                self._combined = self._trainer._combine(
                    self._state, self._shares, self._results
                )
            return self._combined
