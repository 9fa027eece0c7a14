"""Serving launcher: one-shot batched greedy generate, co-executed
generate, and the continuous-batching server.

    # one-shot generate on the card, through the CUDA kernels (the default)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --full \\
        --requests 8 --prompt-len 256 --gen 32

    # on the CPU, reduced config, kernels' plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b --device cpu

    # the audio (whisper-tiny) and vlm (paligemma-3b) families: their batch
    # carries frames or image patches beside the tokens; one-shot and
    # co-executed generate (the server refuses them, as the JAX batcher
    # cannot prefill them)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --device cpu

    # co-executed through the EngineCL runtime: the request batch split in
    # packages over two groups of the run's device, checked bitwise
    # against one-shot generate
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --coexec --scheduler hguided --verify --device cpu

    # the paged continuous-batching server, Poisson arrivals, checked
    # against one-shot generate of each prompt
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --server --paged --device cpu --verify

    # the same with chunked prefill: prompts advance 3 tokens per decode
    # segment inside the segment Program, streams still bitwise one-shot's
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --server --paged --chunk-len 3 --device cpu --verify

    # speculative serving: the target drafts for itself, k = 2 candidates a
    # step verified in one multi-row decode, streams still bitwise one-shot's
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --server --paged --draft self --draft-k 2 --device cpu --verify

    # multi-group serving: one sub-batch and one block pool per group
    # (pod-a, pod-b), waves placed by rate, pod-b drained after 4 requests
    # (its slots migrate to pod-a), streams still bitwise one-shot's
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --server --paged --groups 2 --scheduler hguided --drain-after 4 \\
        --device cpu --verify

Weights are random (float32 masters drawn from ``--seed`` on the device,
cast once to the compute dtype); one-shot prompts are random tokens from
``--seed + 1``, server prompts and arrival gaps from ``--seed + 2`` (as the
JAX launcher draws them).  Under ``--paged --kernel cuda`` the one-shot
reference tiles its cache at the block length (``decode_block``), so the
served streams and the reference run the same tile partition.

On ``cuda`` one-shot generate, the server and co-execution replay CUDA
graphs (``serve/graphs.py``; the JAX launcher jits the same): one-shot
prefill and its chain are captured before the timed call, and their capture
time is reported apart (``capture_s``); the server captures each segment
loop at its first segment and each prefill wave's shape at its first wave;
co-execution embeds the eager generate (the JAX launcher's ``jit=False``),
which each group captures whole at a package shape's first package and
replays (``DeviceGroup.compile_kernel``).

``--coexec`` runs one-shot generate as the kernel of an EngineCL Program
over two DeviceGroups on the run's device, ``pod-a`` (power 2) and
``pod-b`` (power 1), each with its own CUDA stream, as the JAX launcher's
pair; the scheduler (``--scheduler``) cuts the requests into packages.
Every row of the port's kernels is independent of its batch, so
``--verify`` holds each package's tokens bitwise equal to one-shot
generate of the whole batch.  ``--draft`` serves speculatively: ``self``
(the target's own weights, acceptance 1), ``reduced`` (the reduced config
of ``--arch`` with weights from ``--seed + 3``) or an arch name whose
reduced config drafts; the reduced configs share vocab 256, so at
``--full`` only ``self`` passes ``validate_draft``.

``--groups N`` serves on N groups of the run's device (on ``cuda``, N
streams of one card), ``pod-a`` at power 2 and the others at power 1, as
the JAX launcher's simulated pods, with one sub-batch per group
(``group_batches``); ``--drain-after K`` drains the last group after the
K-th submission.  ``--http-port`` serves ``/metrics``, ``/healthz`` and
``/stats`` for the run (``ObsHTTP``), ``--metrics-every`` prints rolling
telemetry, ``--trace-out`` writes a Chrome trace of any mode, and
``--crash-dir`` takes the flight recorder's bundles.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ShapeCell, get_config, reduced
from repro_torch.core import DeviceGroup, Dynamic, EngineCL, HGuided, Program, Static
from repro_torch.launch.specs import make_batch
from repro_torch.models import KERNEL_IMPLS, get_model
from repro_torch.models.params import materialize
from repro_torch.serve import cast_params_cached, graphs, make_generate


# --scheduler: a fresh scheduler of each kind, as the JAX launcher's.
SCHEDULERS = {"static": Static, "dynamic": lambda: Dynamic(8), "hguided": HGuided}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: reduced)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", default="cuda", choices=KERNEL_IMPLS,
                    help="cfg.kernel_impl: 'cuda' runs prefill attention and "
                         "every decode step through the CUDA kernels (their "
                         "plain versions on the CPU); 'reference' the dense "
                         "torch paths")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--server", action="store_true",
                    help="continuous-batching server, Poisson arrivals")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="offered load, requests/s (server mode)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seg-len", type=int, default=2)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--scheduler", default="static", choices=sorted(SCHEDULERS),
                    help="engine scheduler")
    ap.add_argument("--coexec", action="store_true",
                    help="co-executed generate over two device groups of the "
                         "run's device (pod-a at power 2, pod-b at power 1)")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV block pool (block tables + "
                         "prefix cache)")
    ap.add_argument("--block-len", type=int, default=4,
                    help="tokens per KV block in --paged mode")
    ap.add_argument("--chunk-len", type=int, default=0,
                    help="chunked prefill (server mode): advance each prompt "
                         "this many tokens per decode segment inside the "
                         "mixed-phase segment Program instead of running a "
                         "whole-prompt prefill Program (0 = off).  Streams "
                         "stay bitwise equal (--verify holds)")
    ap.add_argument("--draft", default="",
                    help="speculative decoding draft (server mode): 'self' "
                         "(target params; acceptance 1), 'reduced' (fresh "
                         "reduced same-arch params), or an arch name whose "
                         "reduced config drafts.  Streams stay bitwise "
                         "one-shot generate's (--verify holds)")
    ap.add_argument("--draft-k", type=int, default=2,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--spec-gate", action="store_true",
                    help="auto-bypass speculation when the forecast speedup "
                         "drops below 1 (plain segments, periodic re-probes); "
                         "without it a --draft server drafts every segment")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget (server mode; 0 = none)")
    ap.add_argument("--verify", action="store_true",
                    help="assert bit-identity to one-shot generate: every "
                         "served stream to its prompt at batch 1 (server "
                         "mode), the co-executed tokens to the whole batch "
                         "(--coexec)")
    ap.add_argument("--groups", type=int, default=1,
                    help="server mode: co-execute across N device groups of "
                         "the run's device (pod-a at power 2, the rest at "
                         "power 1), one batch (and, under --paged, one KV "
                         "block pool) per group; wave placement and slot "
                         "migration follow --scheduler")
    ap.add_argument("--drain-after", type=int, default=0,
                    help="server mode with --groups >1: after this many "
                         "submissions, drain the last group: its decode "
                         "slots migrate to the surviving groups at segment "
                         "boundaries (--verify still holds)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run (load "
                         "in Perfetto / chrome://tracing); every mode")
    ap.add_argument("--http-port", type=int, default=-1,
                    help="server mode: serve live /metrics (Prometheus), "
                         "/healthz (liveness + per-group readiness) and "
                         "/stats (JSON) on 127.0.0.1:PORT for the run "
                         "(0 = ephemeral port, -1 = off); also turns on the "
                         "efficiency accounting and the decision journal")
    ap.add_argument("--http-hold-s", type=float, default=0.0,
                    help="server mode with --http-port: keep the live server "
                         "and its endpoints up this many seconds after the "
                         "replay drains, for external scrapers")
    ap.add_argument("--crash-dir", default="crashes",
                    help="directory for the flight recorder's post-mortem "
                         "bundles (written on engine failure)")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="server mode: print rolling telemetry (completed, "
                         "TTFT/ITL quantiles) every N seconds, plus the "
                         "Prometheus exposition at exit (0 = off)")
    return ap.parse_args(argv)


def load_model(args):
    """(cfg, api, float32 params on the device) for the parsed flags."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, kernel_impl=args.kernel)
    if getattr(args, "paged", False) and args.kernel == "cuda":
        # Tile the contiguous one-shot reference at the pool's block length
        # so --verify compares equal logical tile partitions (the paged
        # contract on the kernel path).
        cfg = dataclasses.replace(cfg, decode_block=args.block_len)
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = materialize(api.param_spec(cfg), gen, torch.float32, device)
    return cfg, api, params


def load_batch(cfg, args) -> dict:
    """The one-shot batch on the run's device: the tokens, and the
    patches or frames in the compute dtype (as the JAX package's batch).
    Under a context cap (``max_decode_ctx``, whisper's) the prompt is cut
    so that it and ``--gen`` fit, where the JAX package's generate would
    drop the cache writes past the cap."""
    prompt_len = args.prompt_len
    if cfg.max_decode_ctx:
        prompt_len = min(prompt_len, cfg.max_decode_ctx - args.gen)
        if prompt_len < 1:
            raise ValueError(f"--gen {args.gen} leaves no prompt within {cfg.name}'s "
                             f"max_decode_ctx {cfg.max_decode_ctx}")
    cell = ShapeCell("serve", prompt_len, args.requests, "prefill")
    batch = make_batch(cfg, cell, args.seed + 1)
    device = resolve_device(args.device)
    dt = getattr(torch, cfg.compute_dtype)
    return {k: torch.from_numpy(v).to(device, dt if v.dtype.kind == "f" else None)
            for k, v in batch.items()}


def run_oneshot(cfg, api, params, batch, gen: int):
    """Plain batched generate through the shared prefill+chain helper."""
    return make_generate(cfg, api)(params, batch, gen)


def make_draft(cfg, params, args):
    """``--draft`` as a DraftSpec, as the JAX launcher's ``_make_draft``:
    ``self`` re-uses the target's config and params (acceptance 1),
    ``reduced`` draws fresh params of the reduced same-arch config from
    ``--seed + 3``, and any other value names an arch whose reduced config
    drafts.  None without ``--draft``."""
    from repro_torch.serve import DraftSpec

    if not args.draft:
        return None
    if args.draft == "self":
        return DraftSpec(cfg, params, k=args.draft_k, auto_bypass=args.spec_gate)
    name = args.arch if args.draft == "reduced" else args.draft
    dcfg = dataclasses.replace(reduced(get_config(name)), kernel_impl=args.kernel)
    dapi = get_model(dcfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 3)
    dparams = materialize(dapi.param_spec(dcfg), gen, torch.float32, device)
    return DraftSpec(dcfg, dparams, k=args.draft_k, auto_bypass=args.spec_gate)


def server_prompts(cfg, args):
    """The server's prompts and arrival gaps, drawn as the JAX launcher's
    ``run_server`` draws them (numpy ``default_rng(seed + 2)``)."""
    rng = np.random.default_rng(args.seed + 2)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    gaps = rng.exponential(1.0 / args.rate, args.requests)
    return prompts, gaps


def serve_groups(device, n: int):
    """The server's device groups on ``device``: one, ``serve:0``, or the
    JAX launcher's ``--groups N`` pods, ``pod-a`` at power 2 and the rest
    at power 1 (on ``cuda``, each with its own stream)."""
    if n <= 1:
        return [DeviceGroup("serve:0", device=device)]
    return [DeviceGroup(f"pod-{chr(ord('a') + i)}", device=device,
                        power=2.0 if i == 0 else 1.0) for i in range(n)]


def _metrics_pump(server, stop: threading.Event, every: float) -> None:
    """Periodic rolling-telemetry print (``--metrics-every``): completed /
    rejected counts plus windowed TTFT and inter-token-latency quantiles."""
    def ms(v):
        return "-" if v is None else f"{v * 1e3:.1f}ms"

    while not stop.wait(every):
        tel = server.telemetry
        print(f"[metrics] completed={int(tel.counter('requests_completed'))} "
              f"rejected={int(tel.counter('requests_rejected'))} "
              f"ttft_p50={ms(tel.quantile('ttft_s', 0.5))} "
              f"ttft_p99={ms(tel.quantile('ttft_s', 0.99))} "
              f"itl_p50={ms(tel.quantile('itl_s', 0.5))} "
              f"queue_p50={ms(tel.quantile('queue_wait_s', 0.5))}",
              flush=True)


def run_server(cfg, api, params, args, *, graph: bool = True, live=None) -> dict:
    """Replay a seeded Poisson arrival trace through ``InferenceServer`` on
    ``--groups`` DeviceGroups of ``--device``; ``graph=False`` runs the
    segment loops eagerly (``InferenceServer(graph=)``).  ``live(server,
    http)``, if given, runs once every request is answered, while the
    server (and, with ``--http-port``, its endpoints: ``http`` is the
    ``ObsHTTP``, else None) is still up."""
    from repro_torch.core.obs import EngineObs
    from repro_torch.core.trace import tracer
    from repro_torch.serve.http import ObsHTTP
    from repro_torch.serve.paged import PagedSpec
    from repro_torch.serve.server import InferenceServer

    prompts, gaps = server_prompts(cfg, args)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    paged = PagedSpec(block_len=args.block_len) if args.paged else None
    groups = serve_groups(device, args.groups)
    obs = EngineObs(enabled=args.http_port >= 0 or tracer().enabled,
                    crash_dir=args.crash_dir)
    server = InferenceServer(
        cfg, api, params,
        groups=groups,
        scheduler=SCHEDULERS[args.scheduler](),
        buckets=(args.prompt_len,),
        max_batch=args.max_batch,
        seg_len=args.seg_len,
        max_new_cap=max(args.gen, 1),
        max_wait_ms=args.max_wait_ms,
        paged=paged,
        draft=make_draft(cfg, params, args),
        chunk_len=args.chunk_len,
        graph=graph,
        # --groups opts into per-group batches even for contiguous KV.
        group_batches=True if args.groups > 1 else None,
        obs=obs,
    )
    deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
    if cuda and cfg.kernel_impl == "cuda":
        # Build the kernel libraries here, not on the runtime's worker
        # thread at the first segment.
        from repro_torch.kernels import _build

        _build.build()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    http = None
    if args.http_port >= 0:
        http = ObsHTTP(server, port=args.http_port)
        print(f"[obs-http] serving /metrics /healthz /stats on {http.url()}", flush=True)
    stop = threading.Event()
    pump = None
    if args.metrics_every > 0:
        pump = threading.Thread(target=_metrics_pump, args=(server, stop, args.metrics_every),
                                name="metrics-pump", daemon=True)
        pump.start()
    drained = None
    t0 = time.perf_counter()
    try:
        with server:
            handles = []
            for i, (p, gap) in enumerate(zip(prompts, gaps)):
                time.sleep(gap)
                handles.append(server.submit(p, args.gen, deadline_s=deadline))
                if (args.drain_after and i + 1 == args.drain_after
                        and server.group_batches and len(groups) > 1):
                    drained = groups[-1].name
                    server.drain_group(drained)
            results = []
            for h in handles:
                # Wait for the *final* state before reading `rejected`.
                h.wait(timeout=600)
                results.append(None if h.rejected else h.result(timeout=600))
            wall = time.perf_counter() - t0
            if live is not None:
                live(server, http)
            if http is not None and args.http_hold_s > 0:
                # Keep the live server and its endpoints up so an external
                # scraper can probe a healthy engine, not a closed one.
                print(f"[obs-http] holding {args.http_hold_s:.0f}s for scrapes", flush=True)
                time.sleep(args.http_hold_s)
    finally:
        if http is not None:
            http.close()
        if pump is not None:
            stop.set()
            pump.join(timeout=5)
    if pump is not None:
        print(server.prometheus(), end="")
    s = server.stats()
    lat = sorted(h.metrics["latency"] for h in handles if not h.rejected)
    pct = (f"p50={lat[len(lat) // 2] * 1e3:.0f}ms "
           f"p99={lat[-1] * 1e3:.0f}ms " if lat else "")
    where = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"served {s['completed']}/{args.requests} requests on {where} ({cfg.name}, "
          f"kernel_impl={cfg.kernel_impl}) in {wall:.3f}s (rate {args.rate}/s, "
          f"{s['rejected']} rejected, {s['failed']} failed) {pct}"
          f"occupancy={s['occupancy_mean']:.2f} tokens/s={s['tokens_out'] / wall:.1f}")
    if server.group_batches:
        print(f"multi-group: slots={s['placement']['member_slots']} "
              f"migrations={s['slot_migrations']}"
              + (f" drained={drained}" if drained else ""))
    if s["tokens_drafted"]:
        print(f"speculation k={args.draft_k}: {s['tokens_accepted']}/{s['tokens_drafted']} "
              f"draft tokens accepted (acceptance={s['acceptance']:.2f})")
    if "speculation" in s:
        g = s["speculation"]
        print(f"spec gate: {g['speculated_segments']} spec / {g['bypassed_segments']} "
              f"plain segments ({g['probes']} probes)")
    mem = s.get("memory", {})
    if mem.get("mode") == "paged":
        print(f"paged KV: peak {mem['blocks_peak']}/{mem['blocks_total']} "
              f"blocks ({mem['kv_bytes_allocated']} B allocated, "
              f"{mem['kv_bytes_touched']} B touched), "
              f"{mem['prefix_hits']} prefix hits, {mem['cow']} CoW, "
              f"{s['deferred']} boardings deferred")
    result = {
        "prompts": prompts, "results": results, "stats": s, "wall_s": wall, "drained": drained,
        "groups": {g.name: {"capture_wait_s": g.capture_wait_s, **g.transfer_stats()}
                   for g in groups},
        "tokens_per_s": s["tokens_out"] / wall,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "request_metrics": [h.metrics for h in handles],
    }
    tr = tracer()
    if tr.enabled:  # installed by the caller (set_tracer)
        # The runtime's spans per kernel label: "dispatch" is the host time
        # of issuing a package's kernel (the decode loop's launches, or its
        # copy-ins and replay; a segment loop's first also its capture),
        # "write_back" the host copy of its outputs (the decode segment
        # writes its whole cache, the paged pool, back).
        spans: dict = {}
        for e in tr.chrome_events():
            if e.get("ph") == "X" and e["name"] in ("dispatch", "write_back"):
                key = (e["name"], e["args"].get("kernel", "?"))
                d = spans.setdefault(key, {"count": 0, "seconds": 0.0})
                d["count"] += 1
                d["seconds"] += e["dur"] / 1e6
        result["spans"] = {f"{n}/{k}": d for (n, k), d in sorted(spans.items())}
        for name, d in result["spans"].items():
            print(f"{name}: {d['count']} packages, {d['seconds'] / d['count'] * 1e3:.1f} ms each")
        if args.chunk_len:
            # The batcher's segment spans: a segment ran the chunk stage iff
            # some slot was prefilling at its entry (chunk_tokens > 0), and
            # mixed phases iff some slot decoded beside it (n_active > 0).
            segs = [e["args"] for e in tr.chrome_events()
                    if e.get("ph") == "X" and e["name"] == "segment"]
            result["chunk_stages"] = sum(a["chunk_tokens"] > 0 for a in segs)
            result["mixed_segments"] = sum(a["chunk_tokens"] > 0 and a["n_active"] > 0
                                           for a in segs)
            print(f"chunked prefill: chunk_len {args.chunk_len}, {len(segs)} segments, "
                  f"{result['chunk_stages']} with a chunk stage, "
                  f"{result['mixed_segments']} mixing decoding and prefilling slots")
    if args.verify:
        generate = make_generate(cfg, api)
        n = 0
        for p, r in zip(prompts, results):
            if r is None:
                continue
            tokens = torch.from_numpy(p[None]).to(device)
            want = generate(params, {"tokens": tokens}, args.gen)[0].cpu().numpy()
            assert np.array_equal(r, want), (r, want)
            n += 1
        print(f"verify: {n} results bit-identical to one-shot generate")
    return result


def coexec_groups(device):
    """The JAX launcher's co-execution pair on one device: ``pod-a`` at
    power 2 and ``pod-b`` at power 1, each with its own CUDA stream and its
    own graphs of the package kernel."""
    return [DeviceGroup("pod-a", device=device, power=2.0),
            DeviceGroup("pod-b", device=device, power=1.0)]


def run_coexec(cfg, api, params, batch, args, *, graph: bool = True) -> dict:
    """Split the request batch across device groups through the engine —
    the same ``make_generate`` path, embedded as the package kernel.  Each
    package is generated alone, on its group's stream.  The kernel is the
    eager generate (the JAX launcher's ``jit=False``); each CUDA group
    captures it whole per package shape and replays it
    (``DeviceGroup.compile_kernel``), as the reference's group jits it, so
    the first package of a shape carries its capture, in the balance too
    (the reference's carries its compile); the time one group's capture
    waits for the other's is left out of what the scheduler observes
    (``DeviceGroup.capture_wait_s``).  ``graph=False`` marks the kernel
    ``graphs.passthrough``, so the packages run eagerly."""
    device = batch["tokens"].device
    groups = coexec_groups(device)
    generate = make_generate(cfg, api, graph=False)
    # Cast the parameters once, here, not concurrently on the workers.
    cast_params_cached(params, cfg.compute_dtype)
    if device.type == "cuda" and cfg.kernel_impl == "cuda":
        # Build the kernel libraries here, not on a worker thread.
        from repro_torch.kernels import _build

        _build.build()

    # The batch's other leaves (frames, patches) are Program inputs too,
    # sliced by work item with the tokens, as the JAX launcher passes them.
    extra = sorted(k for k in batch if k != "tokens")

    def kern(offset, tokens, *extras):
        return generate(params, {"tokens": tokens, **dict(zip(extra, extras))}, args.gen)

    if not graph:
        graphs.passthrough(kern)

    out = torch.zeros((args.requests, args.gen), dtype=torch.int32)
    prog = (Program().in_(batch["tokens"].cpu()).out(out).kernel(kern, "generate")
            .work_items(args.requests, 1))
    for name in extra:
        prog.in_(batch[name].cpu())
    eng = EngineCL().use(*groups).scheduler(SCHEDULERS[args.scheduler]()).program(prog)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eng:
        eng.run()
        wall = time.perf_counter() - t0
        if eng.has_errors():
            raise SystemExit("\n".join(eng.get_errors()))
        s = eng.introspector.summary()
        packages = {g.name: [] for g in groups}
        package_s = {g.name: [] for g in groups}  # each package's service time, in run order
        for r in sorted(eng.introspector.records, key=lambda r: r.offset_wi):
            packages[r.device].append(r.size_wi)
        for r in sorted(eng.introspector.records, key=lambda r: r.t_start):
            package_s[r.device].append(r.seconds)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"co-exec generated {tuple(out.shape)} on {where} ({cfg.name}, kernel_impl="
          f"{cfg.kernel_impl}, {args.scheduler}) in {wall:.3f}s: "
          f"{out.numel() / wall:.1f} tokens/s balance={s['balance']:.3f} "
          f"share={ {k: round(v, 3) for k, v in s['work_share'].items()} }")
    for name, sizes in packages.items():
        d = s["per_device"].get(name, {})
        print(f"  {name}: packages {sizes}, busy {d.get('busy', 0.0):.3f}s, finish "
              f"{d.get('finish', 0.0):.3f}s")
    return {"tokens": out.numpy(), "wall_s": wall, "tokens_per_s": out.numel() / wall,
            "summary": s, "packages": packages, "package_s": package_s,
            "graphs": {g.name: g.graphs.stats() for g in groups if g.graphs is not None}}


def main(argv=None) -> dict:
    from repro_torch.core.trace import Tracer, set_tracer, tracer

    args = parse_args(argv)
    cfg, api, params = load_model(args)
    prev = set_tracer(Tracer(capacity=1 << 17, enabled=True)) if args.trace_out else None
    try:
        if args.server:
            return run_server(cfg, api, params, args)
        if args.coexec:
            batch = load_batch(cfg, args)
            result = run_coexec(cfg, api, params, batch, args)
            print(result["tokens"][: min(4, args.requests)])
            if args.verify:
                want = run_oneshot(cfg, api, params, batch, args.gen).cpu().numpy()
                assert np.array_equal(result["tokens"], want), "co-exec != one-shot generate"
                print("verify: co-exec output bit-identical to one-shot generate")
                result["verified"] = True
            return result
        return run_oneshot_main(cfg, api, params, args)
    finally:
        if args.trace_out:
            doc = tracer().write(args.trace_out)
            set_tracer(prev)
            print(f"trace: {len(doc['traceEvents'])} events -> {args.trace_out}")


def run_oneshot_main(cfg, api, params, args) -> dict:
    """One-shot generate of the request batch, timed; on the card the
    prefill and decode chain graphs are captured first, outside the timed
    call (``capture_s``; ``graphs``: their GraphCache counters)."""
    batch = load_batch(cfg, args)
    cuda = batch["tokens"].device.type == "cuda"
    generate = make_generate(cfg, api)
    capture_s = generate.prepare(params, batch, args.gen)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = generate(params, batch, args.gen).cpu().numpy()
    wall = time.perf_counter() - t0
    result = {
        "tokens": toks,
        "wall_s": wall,
        "tokens_per_s": toks.size / wall,
        "capture_s": capture_s,
        "graphs": generate.graphs.stats() if generate.graphs is not None else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    where = torch.cuda.get_device_name() if cuda else "cpu"
    mem = (f", peak memory {result['peak_memory_bytes'] / 2**30:.2f} GiB"
           if cuda else "")
    print(f"generated {toks.shape} on {where} ({cfg.name}, kernel_impl="
          f"{cfg.kernel_impl}) in {wall:.3f}s: {result['tokens_per_s']:.1f} "
          f"tokens/s{mem}" + (f" (its prefill and decode chain captured before, in "
                              f"{capture_s:.3f}s)"
                              if capture_s else ""))
    print(np.asarray(toks[: min(4, args.requests)]))
    return result


if __name__ == "__main__":
    main()
