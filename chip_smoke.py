#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--host-us`` runs only the ``[host]`` line, ``--train`` only the
``[train]`` phase, ``--mesh`` only the ``[mesh]`` phase, ``--examples``
only the ``[examples]`` phase and its two granite-34b kernel cases.)

Phases, each fatal on failure (non-zero exit, no result line):

1. card   -- the card's name and power limit (nvidia-smi).
2. build  -- every CUDA kernel from ``src/repro_torch/csrc`` (nine
             libraries; flash_decode's holds its chunk launch too), one
             nvcc each, all started together; then one line
             of the decode key-chunk plan.
3. kernels -- each kernel against its plain PyTorch version on the card.
             flash_attention and flash_decode at the main path's shapes, at
             internlm2-20b and recurrentgemma-2b widths (hd 256, MQA n_rep
             10, window 2048, a wrapped decode ring), at the MoE paths'
             widths (arctic-480b's GQA groups of 7, kimi-k2-1t-a32b's hd
             112, each held batch-invariant bitwise, and flash_decode_paged
             at both), multi-row, windowed,
             empty-slot and unaligned cases: bfloat16 at 2e-2 (atol and
             rtol, the reference suite's bf16 tolerance), float32 at 1e-4
             (the kernel's FMA sums and the plain version's cuBLAS products
             run in different orders); one ``scaled_dot_product_attention``
             call is timed beside each (here only; the port never calls
             it).  The audio and vlm paths' shapes: whisper-tiny's encoder
             (32 x 1500 x 1500, hd 64, bidirectional), its cross-attention
             at prefill (Sq 4, Sk 1500) and its decoder's causal prefill,
             paligemma-3b's prefix-LM prefill (8 x 288, hd 256, MQA, prefix
             256; sdpa takes the same boolean mask) and a float32 prefix
             case with a window; whisper's cross-attention decode over 1500
             valid keys and its self-attention decode.  ssm_scan and
             rglru_scan in float32 at 1e-4 at the recurrent main paths' shapes, a 2048-step case and odd cases
             (ssm: di not a multiple of a block's channels, N not a power
             of two, N 32, and N 1 with di not a multiple of 4, which takes
             the 4-byte copies; rglru: S not a multiple of the unrolled
             steps), with a nonzero start state; no single PyTorch call
             computes either recurrence.  Each ssm case prints its launch
             plan and its SFU floor beside its bound (its exponentials at 16
             a clock per SM at the card's maximum SM clock), and each of the
             8 rows of the main-path ssm case computed alone must equal its
             row of the batch, bitwise.  The build prints ssm_scan's
             registers and spills per instance (ptxas).
             flash_decode_paged in bfloat16 over block pools
             with a random block permutation: the served path's last step
             (B 8, H = KV = 20, hd 128, blocks of 16, 18 table entries, one
             layer's strided view of a 152-block (N, 40, 16, 20, 128)
             pool; every entry is live at that step), internlm2-20b widths
             (H 48, KV 8), a windowed ring in blocks, an empty slot
             (exact zeros) and multi-row Sq 4, the last four with
             null-block table entries, and 40 blocks of 16 keys (three key
             chunks).  Each is held bitwise against flash_decode at
             block_k = the block length on the gathered layout, and at 2e-2
             against its plain version; the ``scaled_dot_product_attention``
             yardstick runs on the pre-gathered contiguous layout (the
             gather is not timed).  ``[chunk]``: flash_decode's chunk
             launch (``flash_decode_chunk``, chunked prefill's rows) on a
             288-key cache at qwen1.5-4b widths, 8 slots x 64 rows at
             cursors 0, 64, 128 and 192 of a 256 prompt, at internlm2-20b
             widths (n_rep 6: 384 rows), ragged cursors with an empty slot
             (exact zeros) and a decoding one, a chunk of 40, and float32:
             at 2e-2 (f32 1e-4) against its plain version, and every
             prefilling slot's rows bitwise against flash_attention's rows
             of the whole prompt at the same positions; the sdpa yardstick
             takes the same boolean mask.  ``[verify]``: speculative verify
             launches (Sq = k + 1 rows, keys written through pos + k) of
             flash_decode at qwen1.5-4b widths (the self-draft's two-row
             first step on its cache of 16-key tiles, the served path's
             shape; k 2 and k 4 on tiles of 128), internlm2-20b widths (k
             2: 18 rows in two row blocks), rows across a 256-key chunk and
             an empty slot, and of flash_decode_paged over a permuted pool
             of 16-key blocks (qwen1.5-4b widths k 2, the served path's
             verify, and internlm2-20b widths): every row bitwise its
             one-row launch at pos + j over the same cache (the spec ==
             plain contract), the paged ones also bitwise flash_decode at
             block_k 16 on the gathered layout, all within 2e-2 of the
             plain version; each line prints the plan (key parts, row
             blocks, chunks) and the verify launch's time; the bound
             counts the keys the rows attend.  Batch invariance, bitwise: each slot of
             the qwen1.5-4b and recurrentgemma-2b main-path decode cases, and
             one batch element of the qwen1.5-4b prefill case, computed
             alone must equal its row of the batch of 8.  Each decode case
             prints its body (tensor-core "mma" or FMA "fma") and its chunk
             plan; each case prints the kernel's and the plain version's
             time.
   gemm   -- the row-invariant GEMM (``gemm_rowinv``) against torch.matmul,
             its plain version, at qwen1.5-4b's decode and prefill shapes,
             falcon-mamba-7b's in_proj, x_proj (N 288) and dt_proj (a
             strided x), the tied head of recurrentgemma-2b (the transposed
             layout), its block-diagonal gates (10 products, one launch),
             odd shapes that take the plain loads, and the float32 route:
             bfloat16 at 2e-2, float32 at 1e-4, each beside one cuBLAS call
             (torch.matmul, here only).  Each line prints the plan
             (``gemm.plan``: route, tile, stages, the K chain) and the rate
             beside its bound.  ``rms_norm`` against its plain version,
             beside F.rms_norm; ``layer_norm`` against its plain version at
             whisper-tiny's shapes (48000 x 384, 32 x 384, strided last
             rows), odd and wide rows and float32, beside F.layer_norm, and
             its rows bitwise at M 1, 3, 8 and 48000; whisper-tiny's
             encoder fc1 and its tied head (N 51865: the ``plain`` route)
             beside cuBLAS.  Held bitwise: row r of each kernel at M =
             1, 3, 8, 64, 65, 300, 2048 and 4096 (the routes' boundaries, a
             ragged tile, a 2 x 2048 prefill) equals the same row computed
             alone (the served-equals-one-shot contract); at each GEMM shape
             every bf16 route (wide, narrow, gemv, head, plain) gives the
             same bits, and x misaligned by one element in a larger buffer
             (the plain loads) the aligned rows' bits; printed beside it,
             what torch.matmul and PyTorch's mean give on the same rows.
             Held bitwise too: the per-row einsums of falcon-mamba-7b's
             decode step, which stay PyTorch calls.  Then one ``[host]``
             line: the wrappers' host time per call at the decode shapes
             (``--host-us`` prints only that line, for the src/ beside the
             script: a copy run from another checkout compares the two).
4. main paths -- ``repro_torch.launch.serve`` one-shot generate,
             ``kernel_impl="cuda"``, random weights from the seed, one model
             at a time (each freed before the next):
             - qwen1.5-4b, 40 layers, 8 requests x 256 prompt x 32
               generated: launches exactly flash_attention 40 and
               flash_decode 40 x 31;
             - falcon-mamba-7b, 64 layers, 8 x 256 x 32: ssm_scan 64 (one
               per layer of the prefill; decode is the elementwise step);
             - recurrentgemma-2b, 26 layers (18 rec, 8 local attention),
               8 x 256 x 32: rglru_scan 18, flash_attention 8, flash_decode
               8 x 31; and 2 x 2048 x 16, whose 2048-slot window ring
               wraps: 18, 8 and 8 x 15;
             - falcon-mamba-7b and recurrentgemma-2b at an odd prompt
               length, 2 x 300 x 8, which the TPU kernels could not take:
               ssm_scan 64; rglru_scan 18, flash_attention 8, flash_decode
               8 x 7.
             - the MoE family at full width, bf16 weights from seed 0
               (``run_moe_path``): arctic-480b cut to 2 layers (about 55.4
               GB) and kimi-k2-1t-a32b cut to 1 (about 38.8 GB), one at a
               time.  First ``[moe kernel]`` on the model's layer-0
               experts: ``moe_gemm`` (gate/up fused through the row map,
               and down over the buffer) at a random routing of the decode
               (8 tokens) and prefill (8 x 256) shapes, within 2e-2 rel.
               L2 of ``moe_gemm_plain`` (the reference's dense einsum),
               each case's plan printed, timed beside its bound,
               ``torch.bmm`` over the capacity buffer and a
               ``torch.matmul`` loop over the filled experts (counts read
               on the host); a routed row bitwise equal at 1, 3 and 8 rows
               of its expert (C 8) and 8 and 48 (C 48), rows past the
               counts zero, and the down row equal to ``gemm_rowinv``'s
               product.  Then the launcher's graphed one-shot generate
               (``run_oneshot_main``) of 8 x 256 + 32: launches exactly
               flash_attention n, flash_decode n x 31, moe_gemm 2n, and the
               row kernels' counts (the router and arctic's dense residual
               among the products) each forward; the first token the
               prefill's argmax; the per-layer check of the prefill and the
               first decode step (``layer_errors``, the moe_ffn output among
               the residual feeds); the assignments each layer's prefill
               drops.  Arctic also runs one-shot eager beside graphed, the
               ``[B7]`` profile, and the paged server (``run_moe_served``:
               the 8 prompts in one wave, eager and graphed, launches exact,
               streams bitwise one-shot generate of the same batch; beside
               it each prompt alone, held only where no prefill dropped).
             - the paged continuous-batching server on qwen1.5-4b's
               weights (``run_server`` of the launcher, ``--server --paged
               --block-len 16 --seg-len 8 --max-batch 8``), 8 requests x
               256 prompt x 32 generated: launches exactly flash_attention
               40 (one prefill wave), flash_decode_paged 40 x 8 x 4 (four
               segments of 8 steps) and nothing else; no request may fail
               or be rejected, and every served stream must equal the same
               8 prompts' one-shot generate as one batch of 8, and one-shot
               generate of each prompt alone (batch 1), bitwise.
             - chunked prefill through the same server on the same
               weights and prompts (``--chunk-len 64``), arrivals at 4/s
               so that later prompts prefill beside decoding slots, beside
               whole-prompt serving of the same arrivals, both under the
               profiler (the card's busy share); then ``--chunk-len 40`` on
               the contiguous layout, 4 requests.  Held: at least one
               segment mixing decoding and prefilling slots; launches
               exactly flash_attention 0, flash_decode 40 per chunk stage
               and flash_decode_paged 40 per decode step (contiguous:
               flash_decode 40 per chunk stage and per decode step; whole
               prompt: flash_attention 40 per prefill wave); every stream
               bitwise equal to the whole-prompt served streams and to
               one-shot generate of its prompt alone.  Tokens/s and each
               request's TTFT printed beside the whole-prompt run's.
             - speculative serving through the same server, arrivals 1 ms
               apart (``run_spec_paths``): ``--draft self --draft-k 2``
               paged, held at acceptance exactly 1.0, 2 segments and exact
               launches (per segment step and layer: the draft's two-row
               first step and one-row second step on flash_decode, the
               target's 3-row verify on flash_decode_paged; the wave's
               target and draft prefills on flash_attention), the
               multi-row ones of the two decode kernels held apart; a weak
               draft through the server API
               (qwen1.5-4b cut to 4 layers, weights from seed 7, k 2,
               contiguous, 4 requests), launches held against its segment
               count; ``--draft self --chunk-len 64``; ``--draft self
               --spec-gate`` (its probe/bypass/speculate counts printed).
               Every stream bitwise equal to the whole-prompt served
               streams and to one-shot generate of its prompt alone;
               tokens/s, wall, TTFT and peak memory beside the whole-prompt
               served path's of the same call.
             Every path also launches exactly one ``gemm_rowinv`` per
             product of the models (projections, MLPs, gates, the head) and
             one ``rms_norm`` per norm, in every forward pass: no product on
             a CUDA tensor reaches torch.matmul.
             Each one-shot run's tokens must lie in range, and its first token be
             the argmax of its prefill; its JSON line counts the TMA maps
             gemm_rowinv encoded during the run (host time: a cached map
             costs none).  Each is then held against the
             dense reference on the same weights one layer at a time,
             teacher-forced: every bf16 layer of the prefill (and, where a
             kernel serves decode, of the first decode step), fed the
             reference's input, must give an update within 2e-2 relative L2
             of the reference layer's, the update measured before the bf16
             residual add (the float32 sum of the layer's products that feed
             the residual stream; the rounded y - x is printed beside it,
             see ``layer_errors``).  The first-token logits of the whole
             stack are printed, not held: with random weights a deep stack
             is chaotic, and the float32 reference moves as far when its
             embeddings move by one ulp.  A profiler pass over one prefill
             and 8 decode steps, eager and replayed as CUDA graphs
             (one-shot generate's own prefill and chain graphs), prints the
             card's busy time against the wall time, and for the graphed
             regions every kernel's device time and launches, by kernel and,
             for gemm_rowinv, by product (``[B7]``, per decode step and per
             prefill).
             Prefill and the decode loops run as CUDA graphs
             (``serve/graphs.py``): the launcher's one-shot generate
             captures its prefill and chain before the timed call and
             replays each once (held), the servers replay every segment
             loop (a chunked one with and without its chunk stage) and
             every prefill wave (the group's compiled kernel).  ``[graph]``
             lines: on each main path, one-shot generate eager (prefill
             and chain eager) and graphed, two calls each, the second
             timed, every call's tokens held bitwise the launcher's, the
             graphed second call held to two replays that copy in the
             prompt tokens only; every served path above runs eager and
             graphed (``InferenceServer(graph=)``), both held to the same
             launch counts and streams, the graphed one to one replay a
             segment and one group replay a prefill wave, no capture
             warming up on clones, and the paged served path's segments
             after the first to copy in no pool leaf; each line prints
             tokens/s, wall, TTFT, the host's dispatch, write-back and
             epilogue of each segment, captures and their seconds by loop
             and phase (warm-up, begin, recording, instantiation),
             copy-ins per replay and the TMA maps encoded (at warm-up and
             capture: a replay encodes none); the two chunked paths run
             graphed once more with the profiler off (CUPTI's tracing of
             a graph launch costs the host time per node), held to the
             same counts and streams.  ``[C8]``: the whole-prompt
             served path graphed with the parent tree's host clone of every
             swapped buffer and pageable mirrors, then swapped in place
             with pageable mirrors, beside this tree's (in place, pinned):
             streams and launch counts held equal, epilogue and write-back
             per segment printed.  A failed capture raises and fails the
             run.
             - ``[a9 path]``, the audio and vlm families
               (``run_a9_path``): whisper-tiny, 4 + 4 layers, 32 requests x
               4 prompt tokens (and 1500 frames) + 124 generated (a 30 s
               window's transcript in 128 of its 448 positions):
               flash_attention 12, flash_decode 8 x 123 (self and cross),
               gemm_rowinv 65 + 33 x 123, layer_norm 22 + 13 x 123;
               paligemma-3b, 18 layers, 8 x (256 patches + 32) + 32:
               flash_attention 18 (prefix-LM mode), flash_decode 18 x 31
               and the dense row-kernel counts.  Each: graphed == eager
               (a call copying in the tokens and the frames or patches),
               every layer of the prefill and of the first decode step
               (whisper's encoder layers too) within 2e-2 of the reference
               impl, teacher-forced; the whole stack's logits printed.
5. coexec -- ``repro_torch.launch.serve --coexec --scheduler hguided
             --verify`` on qwen1.5-4b --full, 8 x 256 + 32: HGuided
             packages over two groups of cuda:0 (pod-a at power 2, pod-b
             at power 1, a CUDA stream each), each package the eager
             generate which the group captures per package shape and
             replays (its capture in the package's time and the balance),
             held bitwise equal to one-shot generate (the launcher's
             --verify), every group with a package and one replay a
             package, and the launch counts (packages + 1) times the
             one-shot path's; then the same with the groups' graphs off,
             held bitwise equal, launches packages times the one-shot
             path's; tokens/s, balance and each package's time printed.
             Then whisper-tiny's 32 x 4 + 124 the same way, graphed only:
             its frames a Program input sliced with the requests, the
             package graphs taking them as inputs; bitwise one-shot, its
             launches (packages + 1) times the one-shot path's.
             Then
             the paper's Listing 1 (examples/quickstart_torch.py) on
             ``discover(DeviceMask.ALL)``, which must be exactly cpu:0 and
             cuda:0, under HGuided(adaptive=True), no simulated speeds:
             held correct with a package on each group; work share, balance
             and packages printed.
   examples -- the port's examples (``examples/*_torch.py``), each loaded
             in-process and its seconds printed: pipeline_dataflow (the
             inferred dependencies [0, 1, 1], one transfer for the chain,
             the iterative halving right), async_coexec (two Programs in
             flight under Dynamic(8), the iterative run's cache hits on
             both groups), nbody_coexec (Listing 2: cpu on the host, phi
             and gpu on cuda:0, Static 8 % / 30 %, the first run and three
             iterations within 1e-3 of the kernel stepped alone on the
             CPU), continuous_batching at qwen1.5-4b full width, depth
             ``SERVED_DEPTH`` (every stream bitwise one-shot generate of its
             prompt alone; the server's launches, counted around its run
             alone, exactly what its prefill waves and segments make, and
             the 12 one-shot runs' 12 x one generate's), serve_hetero
             at granite-34b full width, depth ``GRANITE_DEPTH`` of 88 (both
             phases bitwise one-shot generate of the 64 requests, launches
             exactly packages times one generate's, one capture a package
             shape and one replay a package on each pod; balance and
             shares printed, not held).  The two granite-34b kernel cases
             (n_rep 48: 48 query rows over one kv head) are among
             phase 3's.
6. train  -- the training slice (``run_train_phase``; ``--train`` runs
             only this phase).  flash_attention's autograd Function at the
             train paths' shapes (bf16: qwen1.5-4b's B 2 x 512, whisper's
             encoder B 8 x 1500, paligemma's prefix P 256 at hd 256, MQA):
             its forward equal to the raw kernel's output bitwise, dq/dk/dv
             within 2e-2 rel L2 of autograd through flash_attention_plain,
             its forward, recompute backward and both timed beside sdpa's
             forward + backward and the bounds.  qwen1.5-4b at full width,
             20 of its 40 layers (the float32 state fits; 40 would not),
             ``kernel_impl="cuda"``, through the launcher's ``build_state``
             and ``make_train_step``: B 4 x 512 (SyntheticTokens, seed 0),
             2 microbatches, remat "dots", 3 steps; step 0's loss within
             1e-2 of ``kernel_impl="reference"`` on the same weights and
             batch, each layer's parameter gradients (its VJP on the
             kernel run's own layer input and output gradient, the kernel
             side under remat "dots") within 2e-2 rel L2 of the
             reference's, the whole model's gradient leaves printed but
             not held (on random weights they are chaotic: ROADMAP.md C11;
             the reference's own bf16 against float32 printed beside as
             the witness), finite losses, flash_attention launched exactly
             20 x 2 x 2 a step (dots recomputes its forward) and no other
             kernel; step time, tokens/s, peak memory (``--train`` adds
             the gradients and AdamW timed apart, a step under each remat
             policy and one profiled: card busy, the products' share,
             time by kernel).  whisper-tiny --full through
             ``repro_torch.launch.train``: 4 steps checkpointed every 2,
             then --restore --steps 6: the step-4 checkpoint equal to the
             state bitwise, the data cursor 4 -> 6, finite losses,
             flash_attention 12 a step exactly.  The HeteroTrainer over
             ``discover()``'s cpu:0 and cuda:0 (whisper-tiny, batch 8,
             quantum 1, 2 steps, the cuda group's power hint 16): shares
             covering the batch; the CPU share's parameter gradients layer
             by layer on cpu:0 within 2e-2 rel L2 of cuda:0's on the same
             inputs (float32); the combined loss within 1e-2 of the whole batch's on
             cuda:0 (its gradient printed, not held); as plumbing, step
             0's combined gradient the shares' weighted sum and the cuda
             group's its share's alone on cuda:0; shares, rated powers and
             each group's seconds printed.
   mesh   -- the device mesh (A11): worlds of spawned ranks that compute
             on cuda:0 and exchange over gloo (NCCL refuses two ranks of
             one communicator on one GPU), each held against a one-rank
             yardstick run first.  (a) internlm2-20b at full width, depth
             2, the seq-sharded cache on (data 2, model 2): B 8, prompt
             2048, cache 4096, 16 teacher-forced decode steps; every
             call's logits within 2e-2 rel L2 of the one-rank
             ``flash_decode`` path in bf16 and 1e-4 in float32; a rank
             holds 2048 slots.  (b) arctic-480b at full width, depth 1,
             expert parallel on (model 2): the ranks draw the model in
             turn and keep their 64 experts; 8 x 256 prefill and 8 decode
             steps at capacity factor 100; logits within 2e-2 of one
             rank's, ``moe_gemm`` launched exactly 2 a forward by each
             rank, drops printed.  (c) qwen1.5-4b at full width, depth 2,
             float32 compute, on (data 2): global batch 4 x 512, 2 steps;
             the losses within 1e-4 relative and the all-reduced
             gradients within 1e-3 rel L2 over all leaves of the
             yardstick's (rank 0 alone, first), the parameters after each
             step with ZeRO-1 bitwise those without.  (d) whisper-tiny
             through ``repro_torch.launch.train --mesh-shape 2x1``,
             checkpointed after 2 steps; rank 1 is lost and
             ``ElasticRunner`` rebuilds on rank 0 alone: restored bitwise,
             data cursor 2, one more step finite.  Each world prints its
             ranks' peak memory, seconds and collectives (count, bytes) a
             step.  ``--mesh`` runs only this phase.
7. results -- the ``[graph]`` table, eager beside graphed for every main
             and served path of this run, and its JSON line; a JSON line of
             every kernel's numbers (launches: each
             kernel's count on the first path that runs it; for
             flash_decode_paged, the served path; for flash_decode's chunk
             launch, listed as flash_decode_chunk, its flash_decode count
             on the chunked served path; for the multi-row launches of
             flash_decode and flash_decode_paged, listed as
             flash_decode_verify and flash_decode_paged_verify with the
             [verify] cases of the self-draft served path's shapes, their
             count on that path; layer_norm's on the whisper-tiny path;
             flash_attention's prefix-LM mode, listed as
             flash_attention_prefix with paligemma-3b's case, its count on
             that path), then the last line
             ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BF16_TOL = 2e-2
F32_TOL = 1e-4
LAYER_REL_TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside them
GEN = 32
# The A9 paths' shapes: whisper-tiny transcribes a 30 s window (1500 frames)
# from a 4-token prompt into 128 of its 448 positions; paligemma-3b
# captions 256 patches + a 32-token prompt.
WHISPER_B, WHISPER_PROMPT, WHISPER_GEN = 32, 4, 124
WHISPER_ENCODER = "prefill whisper-tiny encoder (hd 64, bidirectional 1500)"
WHISPER_CROSS = "prefill whisper-tiny cross-attention (Sq 4, Sk 1500)"
WHISPER_CROSS_DECODE = "decode whisper-tiny cross-attention (S 1500, every key valid)"
PALIGEMMA_PREFIX = "prefill paligemma-3b prefix-LM (hd 256, MQA, P 256)"
WHISPER_HEAD = "whisper-tiny decode tied head (N 51865, plain route)"
SPIN_CYCLES = 2_000_000  # ~1.1 ms at the H100's 1.755 GHz boost clock
# examples/serve_hetero_torch.py's model on the card: granite-34b at full
# width, 4 of its 88 layers (2.7 B float32 parameters, 10.9 GB).
GRANITE_DEPTH = 4
GRANITE_PREFILL = "prefill granite-34b (MQA, n_rep 48)"
GRANITE_DECODE = "decode granite-34b (n_rep 48)"


T0 = time.perf_counter()


def at() -> str:
    """Seconds since the script started, for the phase headers (the
    script's whole run must stay within half of its time limit)."""
    return f"[{time.perf_counter() - T0:.0f} s]"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, flush, iters: int) -> float:
    """Median device milliseconds of one call.  Before each call a 256 MB
    write evicts the 50 MB L2 (the main path finds its inputs cold) and a
    ~1 ms device spin lets the host enqueue the whole call, so the CUDA
    events time the card's work and not the host's dispatch.  A call that
    synchronizes inside (the plain decode version reads its tile count)
    includes host time all the same."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        evs.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in evs)
    return ms[len(ms) // 2]


# Cases whose rows are also computed one batch element (prefill) or one slot
# (decode) at a time and held bitwise against their row of the whole batch.
BATCH_INVARIANT = {"prefill qwen1.5-4b (main path)", "decode qwen1.5-4b (main path)",
                   "decode recurrentgemma-2b (hd 256, MQA, window 2048)",
                   "falcon-mamba-7b prefill (main path)",
                   "prefill arctic-480b (n_rep 7)", "decode arctic-480b (n_rep 7)",
                   "prefill kimi-k2-1t-a32b (hd 112)", "decode kimi-k2-1t-a32b (hd 112)",
                   WHISPER_ENCODER, WHISPER_CROSS, PALIGEMMA_PREFIX, WHISPER_CROSS_DECODE,
                   GRANITE_PREFILL, GRANITE_DECODE}


def attention_cases():
    # name, B, Sq, Sk, H, KV, hd, causal, window, q_offset, dtype[, prefix_len]
    return [
        ("prefill qwen1.5-4b (main path)", 8, 256, 256, 20, 20, 128, True, 0, 0, "bfloat16"),
        ("prefill qwen1.5-4b f32", 8, 256, 256, 20, 20, 128, True, 0, 0, "float32"),
        ("prefill internlm2-20b widths", 2, 256, 256, 48, 8, 128, True, 0, 0, "bfloat16"),
        ("prefill unaligned 300, window 128", 2, 300, 300, 20, 20, 128, True, 128, 0, "bfloat16"),
        ("prefill q_offset 256", 2, 64, 320, 48, 8, 128, True, 0, 256, "bfloat16"),
        ("prefill bidirectional", 2, 192, 192, 20, 20, 128, False, 0, 0, "bfloat16"),
        ("prefill recurrentgemma-2b (hd 256, MQA, window 2048)", 8, 256, 256, 10, 1, 256,
         True, 2048, 0, "bfloat16"),
        ("prefill recurrentgemma-2b 2048 tokens", 2, 2048, 2048, 10, 1, 256, True, 2048, 0,
         "bfloat16"),
        ("prefill hd 256 f32", 2, 256, 256, 10, 1, 256, True, 2048, 0, "float32"),
        # The MoE paths' attention: arctic's GQA groups of 7 heads, kimi's hd 112.
        ("prefill arctic-480b (n_rep 7)", 8, 256, 256, 56, 8, 128, True, 0, 0, "bfloat16"),
        ("prefill kimi-k2-1t-a32b (hd 112)", 8, 256, 256, 64, 8, 112, True, 0, 0, "bfloat16"),
        # serve_hetero's granite-34b: MQA, 48 query heads over one kv head.
        (GRANITE_PREFILL, 8, 256, 256, 48, 1, 128, True, 0, 0, "bfloat16"),
        # The A9 paths: whisper-tiny's encoder and cross-attention at prefill
        # (hd 64, bidirectional, Sk 1500 not a multiple of the tile), its
        # decoder's causal prefill, and paligemma-3b's prefix-LM prefill.
        (WHISPER_ENCODER, WHISPER_B, 1500, 1500, 6, 6, 64, False, 0, 0, "bfloat16"),
        (WHISPER_CROSS, WHISPER_B, WHISPER_PROMPT, 1500, 6, 6, 64, False, 0, 0, "bfloat16"),
        ("prefill whisper-tiny decoder self (causal, Sq 4)", WHISPER_B, WHISPER_PROMPT,
         WHISPER_PROMPT, 6, 6, 64, True, 0, 0, "bfloat16"),
        (PALIGEMMA_PREFIX, 8, 288, 288, 8, 1, 256, True, 0, 0, "bfloat16", 256),
        ("prefill prefix-LM f32, GQA, window 64", 2, 200, 200, 8, 2, 64, True, 64, 0,
         "float32", 96),
    ]


def decode_cases():
    # name, B, S, H, KV, hd, sq, pos, window, block_k, q dtype, cache dtype
    last = 256 + GEN - 2  # position of the main path's last decode step
    return [
        ("decode qwen1.5-4b (main path)", 8, 256 + GEN, 20, 20, 128, 1, [last] * 8, 0, 128,
         "bfloat16", "bfloat16"),
        ("decode qwen1.5-4b f32", 8, 256 + GEN, 20, 20, 128, 1, [last] * 8, 0, 128,
         "float32", "float32"),
        ("decode internlm2-20b widths, ragged", 4, 300, 48, 8, 128, 1, [10, 150, 299, 77], 0,
         128, "bfloat16", "bfloat16"),
        ("decode multi-row Sq 3", 4, 300, 48, 8, 128, 3, [0, 126, 200, 297], 0, 128,
         "bfloat16", "bfloat16"),
        ("decode 64 rows (Sq 8, n_rep 8)", 2, 256, 32, 4, 128, 8, [100, 248], 0, 64,
         "bfloat16", "bfloat16"),
        ("decode windowed ring 64", 4, 64, 20, 20, 128, 1, [30, 63, 64, 500], 64, 32,
         "bfloat16", "bfloat16"),
        ("decode empty slot", 3, 200, 20, 20, 128, 1, [-1, 0, 199], 0, 128,
         "bfloat16", "bfloat16"),
        ("decode f32 cache, bf16 q", 2, 300, 48, 8, 128, 1, [299, 5], 0, 128,
         "bfloat16", "float32"),
        ("decode recurrentgemma-2b (hd 256, MQA, window 2048)", 8, 256 + GEN, 10, 1, 256, 1,
         [last] * 8, 2048, 128, "bfloat16", "bfloat16"),
        ("decode recurrentgemma-2b, wrapped 2048 ring", 2, 2048, 10, 1, 256, 1, [2062, 4000],
         2048, 128, "bfloat16", "bfloat16"),
        ("decode arctic-480b (n_rep 7)", 8, 256 + GEN, 56, 8, 128, 1, [last] * 8, 0, 128,
         "bfloat16", "bfloat16"),
        ("decode kimi-k2-1t-a32b (hd 112)", 8, 256 + GEN, 64, 8, 112, 1, [last] * 8, 0, 128,
         "bfloat16", "bfloat16"),
        # granite-34b's 48 rows a slot: three 16-row groups of the block.
        (GRANITE_DECODE, 8, 256 + GEN, 48, 1, 128, 1, [last] * 8, 0, 128,
         "bfloat16", "bfloat16"),
        # whisper-tiny's decode: cross-attention over the 1500 encoder keys,
        # every one valid, and self-attention at the path's last step.
        (WHISPER_CROSS_DECODE, WHISPER_B, 1500, 6, 6, 64, 1, [1499] * WHISPER_B, 0, 128,
         "bfloat16", "bfloat16"),
        ("decode whisper-tiny self (hd 64)", WHISPER_B, WHISPER_PROMPT + WHISPER_GEN, 6, 6, 64,
         1, [WHISPER_PROMPT + WHISPER_GEN - 2] * WHISPER_B, 0, 128, "bfloat16", "bfloat16"),
    ]


def run_attention_case(case, dev, flush, torch, F, ops, fa):
    name, b, sq, sk, h, kv, hd, causal, window, qoff, dname, *rest = case
    prefix = rest[0] if rest else 0
    dt = getattr(torch, dname)
    g = torch.Generator(device=dev).manual_seed(len(name))
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dt)
    k = torch.randn((b, sk, kv, hd), generator=g, device=dev).to(dt)
    v = torch.randn((b, sk, kv, hd), generator=g, device=dev).to(dt)
    kw = dict(causal=causal, window=window, q_offset=qoff, prefix_len=prefix)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if dname == "bfloat16" else F32_TOL
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash_attention {name}: max |kernel - plain| = {err} > tol {tol}")
    if name in BATCH_INVARIANT:
        i = b // 2
        one = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
        torch.cuda.synchronize()
        if not torch.equal(one[0], got[i]):
            fail(f"flash_attention {name}: batch element {i} alone differs from its row in the "
                 f"batch of {b}")
        print(f"  flash_attention | {name}: batch element {i} alone == its row in the batch "
              f"of {b}, bitwise", flush=True)
    qpos = torch.arange(sq, device=dev)[:, None] + qoff
    kpos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    pre = (qpos < prefix) & (kpos < prefix)
    if causal:
        mask &= (kpos <= qpos) | pre
    if window > 0:
        mask &= (kpos > qpos - window) | pre
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    plain_causal = causal and window == 0 and qoff == 0 and sq == sk and not prefix
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=None if plain_causal else mask, is_causal=plain_causal,
        enable_gqa=h != kv)
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), flush, 20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush, 5)
    lib_ms = time_ms(lib, flush, 20)
    pairs = int(mask.sum())
    flops = 4 * hd * b * h * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()  # q, k, v in; out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    plan = fa.launch_plan(b, sq, sk, h, kv, hd, dt, prefix_len=prefix)
    print(f"  flash_attention | {name}: {plan['route']} body; max_abs_err={err:.3g} "
          f"kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


def run_decode_case(case, dev, flush, torch, F, ops, fd, attn):
    import numpy as np

    name, b, s, h, kv, hd, sq, pos, window, bk, qname, kvname = case
    qdt, kvdt = getattr(torch, qname), getattr(torch, kvname)
    g = torch.Generator(device=dev).manual_seed(len(name))
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(qdt)
    k = torch.randn((b, s, kv, hd), generator=g, device=dev).to(kvdt)
    v = torch.randn((b, s, kv, hd), generator=g, device=dev).to(kvdt)
    kp = np.full((b, s), -1, np.int32)
    for i, p in enumerate(pos):  # keys written through the slot's deepest row
        deepest = p + sq - 1 if p >= 0 else -1
        for t in range(max(0, deepest - s + 1), deepest + 1):
            kp[i, t % s if window else t] = t
    kpos = torch.from_numpy(kp).to(dev)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(window=window, block_k=bk)
    got = ops.flash_decode(q, k, v, kpos, posv, **kw)
    torch.cuda.synchronize()
    want = fd.flash_decode_plain(q, k, v, kpos, posv, **kw)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if qname == "bfloat16" else F32_TOL
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash_decode {name}: max |kernel - plain| = {err} > tol {tol}")
    for i, p in enumerate(pos):
        if p < 0 and torch.any(got[i, 0] != 0):
            fail(f"flash_decode {name}: empty slot {i} is not exact zeros")
    if name in BATCH_INVARIANT:
        for i in range(b):
            one = ops.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], kpos[i:i + 1],
                                   posv[i:i + 1], **kw)
            torch.cuda.synchronize()
            if not torch.equal(one[0], got[i]):
                fail(f"flash_decode {name}: slot {i} alone differs from its row in the batch "
                     f"of {b}")
        three = ops.flash_decode(q[:3], k[:3], v[:3], kpos[:3], posv[:3], **kw)
        torch.cuda.synchronize()
        if not torch.equal(three, got[:3]):
            fail(f"flash_decode {name}: slots 0-2 as a batch of 3 differ from their rows in the "
                 f"batch of {b}")
        print(f"  flash_decode | {name}: each of the {b} slots alone, and slots 0-2 as a batch "
              f"of 3, == their rows in the batch, bitwise", flush=True)
    rowpos = posv[:, None] + torch.arange(sq, device=dev, dtype=torch.int32)
    mask = attn.ragged_valid_mask(kpos[:, None, :], rowpos[:, :, None], window)[:, None]
    qt, kt, vt = q.transpose(1, 2), k.to(qdt).transpose(1, 2), v.to(qdt).transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
    ms = time_ms(lambda: ops.flash_decode(q, k, v, kpos, posv, **kw), flush, 20)
    plain_ms = time_ms(lambda: fd.flash_decode_plain(q, k, v, kpos, posv, **kw), flush, 5)
    lib_ms = time_ms(lib, flush, 20)
    bkk = min(bk, s)
    nt = fd.needed_tiles(kpos, posv, window=window, block_k=bkk, sq=sq)
    keys = int(torch.clamp(nt * bkk, max=s).sum())  # keys the needed tiles hold
    nbytes = (2 * keys * kv * hd * k.element_size() + 2 * q.numel() * q.element_size()
              + kpos.numel() * 4 + posv.numel() * 4)
    flops = 4 * hd * (h // kv) * kv * int(mask.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[qname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    plan = fd.launch_plan(b, s, sq, h, kv, hd, qdt, kvdt, block_k=bk)
    print(f"  flash_decode | {name}: {plan['route']} body, {plan['tiles']} tiles of "
          f"{plan['block_k']} keys in {plan['chunks']} chunk(s); max_abs_err={err:.3g} "
          f"kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


def paged_cases():
    # name, B, H, KV, hd, block_len, table entries (live + null), blocks in
    # the pool, layers of the pool, sq, pos, window
    last = 256 + GEN - 2  # the served path's last decode step
    return [
        ("paged qwen1.5-4b served last step (main path)", 8, 20, 20, 128, 16, (18, 0), 152,
         40, 1, [last] * 8, 0),
        ("paged internlm2-20b widths, ragged", 4, 48, 8, 128, 16, (19, 2), 96, 2, 1,
         [10, 150, 299, 77], 0),
        ("paged windowed ring of 4 blocks", 4, 20, 20, 128, 16, (4, 2), 24, 2, 1,
         [30, 63, 64, 500], 64),
        ("paged empty slot", 3, 20, 20, 128, 16, (13, 2), 48, 2, 1, [-1, 0, 199], 0),
        ("paged multi-row Sq 4", 4, 48, 8, 128, 16, (19, 2), 96, 2, 4, [0, 126, 200, 296], 0),
        ("paged 3 key chunks (40 blocks)", 2, 20, 20, 128, 16, (40, 0), 100, 2, 1, [639, 300],
         0),
        ("paged arctic-480b served last step (n_rep 7)", 8, 56, 8, 128, 16, (18, 0), 152, 2, 1,
         [last] * 8, 0),
        ("paged kimi-k2-1t-a32b widths (hd 112)", 4, 64, 8, 112, 16, (19, 2), 96, 2, 1,
         [10, 150, 299, 77], 0),
    ]


def run_paged_case(case, dev, flush, torch, F, ops, fd, attn):
    """flash_decode_paged on a block pool whose blocks hold a ragged logical
    cache in a random physical order, read through one layer's strided view
    of a layer-stacked pool (the other layers hold garbage, so a wrong
    stride shows).  Held bitwise against flash_decode at block_k = the
    block length on the gathered layout, and at 2e-2 against the plain
    version."""
    import numpy as np

    name, b, h, kv, hd, bl, (live, null), n_blocks, layers, sq, pos, window = case
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(len(name))
    s = live * bl  # logical timeline (the ring, for a windowed cache)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dt)
    kp = np.full((b, s), -1, np.int32)
    for i, p in enumerate(pos):  # keys written through the slot's deepest row
        deepest = p + sq - 1 if p >= 0 else -1
        for t in range(max(0, deepest - s + 1), deepest + 1):
            kp[i, t % s if window else t] = t
    rng = np.random.default_rng(len(name))
    phys = rng.permutation(np.arange(2, n_blocks))[: b * live].reshape(b, live)
    tables = np.ones((b, live + null), np.int32)  # null entries -> block 1
    tables[:, :live] = phys
    layer = layers // 2
    kpool = torch.randn((n_blocks, layers, bl, kv, hd), generator=g, device=dev).to(dt)
    vpool = torch.randn((n_blocks, layers, bl, kv, hd), generator=g, device=dev).to(dt)
    kppool = torch.randint(0, 4096, (n_blocks, layers, bl), generator=g, device=dev,
                           dtype=torch.int32)
    kppool[:, layer] = -1
    idx = torch.from_numpy(phys.reshape(-1)).long().to(dev)
    kppool[idx, layer] = torch.from_numpy(kp.reshape(b * live, bl)).to(dev)
    view = kpool[:, layer], vpool[:, layer], kppool[:, layer]
    tables = torch.from_numpy(tables).to(dev)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = ops.flash_decode_paged(q, *view, tables, posv, window=window)
    torch.cuda.synchronize()
    gk, gv, gkp = (fd.gather_pool(x, tables) for x in view)
    contig = ops.flash_decode(q, gk, gv, gkp, posv, window=window, block_k=bl)
    torch.cuda.synchronize()
    if not torch.equal(got, contig):
        fail(f"flash_decode_paged {name}: not bitwise equal to flash_decode at block_k={bl} "
             f"on the gathered layout (max |diff| {(got.float() - contig.float()).abs().max()})")
    want = fd.flash_decode_paged_plain(q, *view, tables, posv, window=window)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL):
        fail(f"flash_decode_paged {name}: max |kernel - plain| = {err} > tol {BF16_TOL}")
    for i, p in enumerate(pos):
        if p < 0 and torch.any(got[i] != 0):
            fail(f"flash_decode_paged {name}: empty slot {i} is not exact zeros")
    rowpos = posv[:, None] + torch.arange(sq, device=dev, dtype=torch.int32)
    mask = attn.ragged_valid_mask(gkp[:, None, :], rowpos[:, :, None], window)[:, None]
    qt, kt, vt = q.transpose(1, 2), gk.transpose(1, 2), gv.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
    ms = time_ms(lambda: ops.flash_decode_paged(q, *view, tables, posv, window=window),
                 flush, 20)
    plain_ms = time_ms(lambda: fd.flash_decode_paged_plain(q, *view, tables, posv,
                                                           window=window), flush, 5)
    lib_ms = time_ms(lib, flush, 20)
    nt = fd.needed_tiles(gkp, posv, window=window, block_k=bl, sq=sq)
    keys = int((nt * bl).sum())  # keys of the needed blocks
    nbytes = (2 * keys * kv * hd * 2 + keys * 4 + 2 * q.numel() * 2 + tables.numel() * 4
              + posv.numel() * 4)
    flops = 4 * hd * (h // kv) * kv * int(mask.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    plan = fd.paged_launch_plan(b, live + null, bl, sq, h, kv, hd, dt, dt)
    print(f"  flash_decode_paged | {name}: {plan['route']} body, {plan['tiles']} tiles of "
          f"{bl} keys in {plan['chunks']} chunk(s); bitwise = flash_decode(block_k={bl}); "
          f"max_abs_err={err:.3g} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"sdpa (pre-gathered)={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


# The chunked served path's prompt, chunk and cache length.
CHUNK_PLEN, CHUNK_LEN = 256, 64
MAIN_CHUNK_CASE = "chunk qwen1.5-4b cursor 192 (main path)"


def chunk_cases():
    # name, B, H, KV, hd, chunk rows, cursors ("empty": a slot with no key at
    # all, cursor 0; a cursor >= the prompt: a decoding slot, keys through
    # cursor + 3), dtype.  Prompt 256, cache 288 (the served path's).
    c = CHUNK_LEN
    return [
        *[(f"chunk qwen1.5-4b cursor {cur}" + (" (main path)" if cur == 192 else ""), 8, 20,
           20, 128, c, [cur] * 8, "bfloat16") for cur in (0, 64, 128, 192)],
        ("chunk internlm2-20b widths (n_rep 6: 384 rows), cursor 128", 4, 48, 8, 128, c,
         [128] * 4, "bfloat16"),
        ("chunk ragged cursors, one slot empty, one decoding", 4, 20, 20, 128, c,
         [0, 100, "empty", 256], "bfloat16"),
        ("chunk of 40 (does not divide 256)", 8, 20, 20, 128, 40,
         [0, 40, 80, 120, 160, 200, 240, 216], "bfloat16"),
        ("chunk qwen1.5-4b f32, cursor 128", 8, 20, 20, 128, c, [128] * 8, "float32"),
    ]


def run_chunk_case(case, dev, flush, torch, F, ops, fd, attn):
    """flash_decode's chunk launch (``flash_decode_chunk``) on a 288-key
    cache holding each slot's prompt keys through its chunk (stale random
    k/v under kpos -1 past them).  Held at the bf16 2e-2 (float32: 1e-4)
    against its plain version; each prefilling slot's rows held bitwise
    against ``flash_attention``'s rows of the whole 256-token prompt at the
    same positions (the chunked == whole-prompt contract), an empty slot's
    rows exact zeros.  Timed beside ``scaled_dot_product_attention`` with
    the same boolean mask over the same cache."""
    name, b, h, kv, hd, sq, cursors, dname = case
    dt = getattr(torch, dname)
    s = CHUNK_PLEN + GEN
    g = torch.Generator(device=dev).manual_seed(len(name))
    qfull = torch.randn((b, s, h, hd), generator=g, device=dev).to(dt)
    k = torch.randn((b, s, kv, hd), generator=g, device=dev).to(dt)
    v = torch.randn((b, s, kv, hd), generator=g, device=dev).to(dt)
    kpos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    pos = []
    for i, cur in enumerate(cursors):
        if cur == "empty":
            pos.append(0)
            continue
        end = min(CHUNK_PLEN, cur + sq) if cur < CHUNK_PLEN else cur + 3
        kpos[i, :end] = torch.arange(end, dtype=torch.int32, device=dev)
        pos.append(cur)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dt)
    for i, p in enumerate(pos):
        n = min(sq, s - p)
        q[i, :n] = qfull[i, p:p + n]
    got = ops.flash_decode_chunk(q, k, v, kpos, posv)
    torch.cuda.synchronize()
    want = fd.flash_decode_chunk_plain(q, k, v, kpos, posv)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if dname == "bfloat16" else F32_TOL
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash_decode_chunk {name}: max |kernel - plain| = {err} > tol {tol}")
    whole = ops.flash_attention(*(x[:, :CHUNK_PLEN].contiguous() for x in (qfull, k, v)))
    torch.cuda.synchronize()
    rows = 0
    for i, cur in enumerate(cursors):
        if cur == "empty":
            if torch.any(got[i] != 0):
                fail(f"flash_decode_chunk {name}: empty slot {i} is not exact zeros")
            continue
        if cur >= CHUNK_PLEN:
            continue
        end = min(CHUNK_PLEN, cur + sq)
        if not torch.equal(got[i, :end - cur], whole[i, cur:end]):
            d = (got[i, :end - cur].float() - whole[i, cur:end].float()).abs().max()
            fail(f"flash_decode_chunk {name}: slot {i}'s rows {cur}..{end - 1} differ from "
                 f"flash_attention's prefill rows (max |diff| {d})")
        rows += end - cur
    rowpos = posv[:, None] + torch.arange(sq, device=dev, dtype=torch.int32)
    mask = attn.ragged_valid_mask(kpos[:, None, :], rowpos[:, :, None], 0)[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
    ms = time_ms(lambda: ops.flash_decode_chunk(q, k, v, kpos, posv), flush, 20)
    plain_ms = time_ms(lambda: fd.flash_decode_chunk_plain(q, k, v, kpos, posv), flush, 5)
    lib_ms = time_ms(lib, flush, 20)
    # Bytes: q in, out, the keys and values of each slot's needed tiles
    # (each read once), kpos and pos.
    plan = fd.chunk_launch_plan(b, s, sq, h, kv, hd, dt, dt)
    bk = plan["block_k"]
    nt = fd.needed_tiles(kpos, posv, block_k=bk, sq=sq)
    keys = int(torch.clamp(nt * bk, max=s).sum())
    nbytes = (2 * keys * kv * hd * k.element_size() + 2 * q.numel() * q.element_size()
              + kpos.numel() * 4 + posv.numel() * 4)
    flops = 4 * hd * (h // kv) * kv * int(mask.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    grp = (f"{plan['key_parts']} key part(s), {plan['stage_keys']}-key stages"
           if plan["route"] == "mma" else f"{plan['grid'][0]} position tile(s)")
    print(f"  flash_decode_chunk | {name}: {plan['route']} body, grid {plan['grid']}, "
          f"{plan['tiles']} tiles of {bk} keys, no key chunks, {grp}; {rows} prefill rows "
          f"bitwise = flash_attention's; max_abs_err={err:.3g} kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa (mask)={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


# Speculative verify rows: a verify launch of Sq = k + 1 rows against each
# row's one-row launch at pos + j over the same cache after the same writes.
SPEC_K = 2
# The self-draft served path's multi-row launches, at its shapes: the
# draft's two-row first step (rows pos - 1, pos) on its contiguous cache,
# which the paged path tiles at the block length, and the target's verify
# on the pool.
DRAFT_MAIN = "draft first step qwen1.5-4b, 2 rows, tiles of 16 (spec served path)"
PAGED_VERIFY_MAIN = "verify paged qwen1.5-4b k 2, blocks of 16 (spec served path)"


def verify_cases():
    # name, B, H, KV, hd, k, pos, block_k (the tile, or the paged block
    # length), S (contiguous) or (table entries, pool blocks) (paged, a
    # permuted pool)
    s = 256 + GEN + 8 * (SPEC_K + 1)  # the spec served path's cache
    ragged = [256, 259, 262, 268, 271, 280, 283, 286]
    nmax = s // 16
    return [
        (DRAFT_MAIN, 8, 20, 20, 128, 1, [p - 1 for p in ragged], 16, s),
        ("verify qwen1.5-4b k 2", 8, 20, 20, 128, SPEC_K, ragged, 128, s),
        ("verify qwen1.5-4b k 4", 8, 20, 20, 128, 4, ragged, 128, s),
        ("verify internlm2-20b widths k 2 (18 rows: 2 row blocks)", 4, 48, 8, 128, 2,
         [10, 150, 296, 77], 128, s),
        ("verify across a 256-key chunk (k 4, rows past key 255)", 4, 20, 20, 128, 4,
         [252, 254, 255, 250], 128, s),
        ("verify empty slot", 3, 20, 20, 128, 2, [-1, 0, 190], 128, s),
        (PAGED_VERIFY_MAIN, 8, 20, 20, 128, SPEC_K, ragged, 16, (nmax, 2 + 8 * nmax)),
        ("verify paged internlm2-20b widths k 2", 4, 48, 8, 128, 2, [10, 150, 296, 77], 16,
         (nmax, 2 + 4 * nmax)),
    ]


def run_verify_case(case, dev, flush, torch, F, ops, fd, attn):
    """One speculative verify launch (Sq = k + 1 rows at pos .. pos + k, its
    keys written through pos + k) held bitwise, row by row, against the
    one-row launch at pos + j over the same cache (the spec == plain
    contract on the card), and at 2e-2 against the plain version; an empty
    slot's rows exact zeros.  Paged: a pool in a random block order, also
    bitwise flash_decode at block_k = the block length on the gathered
    layout.  Timed beside sdpa with the same mask.  The bound counts the
    keys the rows attend (each slot's keys through pos + k, read once for
    all its rows), their kpos and, paged, their table entries."""
    import numpy as np

    name, b, h, kv, hd, k, pos, bk, geom = case
    dt, sq = torch.bfloat16, k + 1
    paged = isinstance(geom, tuple)
    s = bk * geom[0] if paged else geom
    g = torch.Generator(device=dev).manual_seed(len(name))
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dt)
    kk = torch.randn((b, s, kv, hd), generator=g, device=dev).to(dt)
    vv = torch.randn((b, s, kv, hd), generator=g, device=dev).to(dt)
    kp = np.full((b, s), -1, np.int32)
    for i, p in enumerate(pos):
        if p >= 0:
            kp[i, :p + sq] = np.arange(p + sq)
    kpos = torch.from_numpy(kp).to(dev)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    if paged:
        (nmax, n_blocks), bl = geom, bk
        rng = np.random.default_rng(len(name))
        tables = torch.from_numpy(rng.permutation(np.arange(2, n_blocks))[: b * nmax]
                                  .reshape(b, nmax).astype(np.int32)).to(dev)
        idx = tables.reshape(-1).long()
        pool = []
        for x, fill in ((kk, 0), (vv, 0), (kpos, -1)):
            pl = torch.full((n_blocks, bl) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=dev)
            pl[idx] = x.reshape((b * nmax, bl) + tuple(x.shape[2:]))
            pool.append(pl)
        launch = lambda qq, pp: ops.flash_decode_paged(qq, *pool, tables, pp)  # noqa: E731
        plain = lambda: fd.flash_decode_paged_plain(q, *pool, tables, posv)  # noqa: E731
        plan = fd.paged_launch_plan(b, nmax, bl, sq, h, kv, hd, dt, dt)
    else:
        launch = lambda qq, pp: ops.flash_decode(qq, kk, vv, kpos, pp, block_k=bk)  # noqa: E731
        plain = lambda: fd.flash_decode_plain(q, kk, vv, kpos, posv, block_k=bk)  # noqa: E731
        plan = fd.launch_plan(b, s, sq, h, kv, hd, dt, dt, block_k=bk)
    got = launch(q, posv)
    torch.cuda.synchronize()
    for j in range(sq):
        one = launch(q[:, j:j + 1].contiguous(), posv + j)
        torch.cuda.synchronize()
        if not torch.equal(one[:, 0], got[:, j]):
            d = (one[:, 0].float() - got[:, j].float()).abs().max()
            fail(f"verify {name}: row {j} differs from the one-row launch at pos + {j} "
                 f"(max |diff| {d})")
    if paged:
        contig = ops.flash_decode(q, kk, vv, kpos, posv, block_k=bk)
        torch.cuda.synchronize()
        if not torch.equal(got, contig):
            fail(f"verify {name}: not bitwise flash_decode at block_k={bk} on the "
                 f"gathered layout")
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL):
        fail(f"verify {name}: max |kernel - plain| = {err} > tol {BF16_TOL}")
    for i, p in enumerate(pos):
        if p < 0 and torch.any(got[i] != 0):
            fail(f"verify {name}: empty slot {i} is not exact zeros")
    rowpos = posv[:, None] + torch.arange(sq, device=dev, dtype=torch.int32)
    mask = attn.ragged_valid_mask(kpos[:, None, :], rowpos[:, :, None], 0)[:, None]
    qt, kt, vt = q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=h != kv)
    ms = time_ms(lambda: launch(q, posv), flush, 20)
    plain_ms = time_ms(plain, flush, 5)
    lib_ms = time_ms(lib, flush, 20)
    keys = sum(p + sq for p in pos if p >= 0)  # each slot's keys through pos + k
    entries = sum(-(-(p + sq) // bk) for p in pos if p >= 0)  # their table entries
    nbytes = (2 * keys * kv * hd * 2 + keys * 4 + 2 * q.numel() * 2 + posv.numel() * 4
              + (entries * 4 if paged else 0))
    flops = 4 * hd * (h // kv) * kv * int(mask.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  {'flash_decode_paged' if paged else 'flash_decode'} verify | {name}: "
          f"{plan['route']} body, {plan['key_parts']} key part(s) of {plan['stage_keys']}-key "
          f"stages, {plan['row_blocks']} row block(s) of {plan['block_rows']} rows, "
          f"{plan['tiles']} tiles of {bk} keys in {plan['chunks']} chunk(s); {b} x {sq} rows "
          f"bitwise = their one-row launches; max_abs_err={err:.3g} kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa (mask)={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


def scan_cases():
    # kernel, name, shape: ssm (B, S, di, N), rglru (B, S, W)
    return [
        ("ssm_scan", "falcon-mamba-7b prefill (main path)", (8, 256, 8192, 16)),
        ("ssm_scan", "2048 steps", (1, 2048, 8192, 16)),
        ("ssm_scan", "odd shape", (3, 100, 96, 8)),
        ("ssm_scan", "di and N odd", (2, 77, 100, 12)),
        ("ssm_scan", "N 32", (2, 256, 2048, 32)),
        ("ssm_scan", "N 1, di not a multiple of 4", (2, 99, 250, 1)),
        ("rglru_scan", "recurrentgemma-2b prefill (main path)", (8, 256, 2560)),
        ("rglru_scan", "2048 steps", (2, 2048, 2560)),
        ("rglru_scan", "odd shape", (3, 96, 48)),
        ("rglru_scan", "S odd", (3, 100, 50)),
    ]


def run_scan_case(case, dev, flush, torch, ops, ss, rg, sm_clock_hz):
    """A scan kernel against its plain version in float32, inputs drawn as
    the reference's kernel suite draws them (tests/test_kernels.py) with a
    nonzero start state.  Bound: each input read once and each output
    written once at 3.35 TB/s, against the float32 operations at 67 TFLOP/s
    (ssm: 7 per state element and step, the exponential counted as one;
    rglru: one FMA, 2).  ssm_scan also prints its SFU floor: B*S*di*N
    exponentials at 16 a clock per SM, at ``sm_clock_hz``."""
    kernel, name, shape = case
    g = torch.Generator(device=dev).manual_seed(len(name) + len(shape))

    def rnd(*sh):
        return torch.randn(sh, generator=g, device=dev)

    if kernel == "ssm_scan":
        b, s, di, n = shape
        ins = (torch.nn.functional.softplus(rnd(b, s, di)), rnd(b, s, di), rnd(b, s, n),
               rnd(b, s, n), -torch.exp(rnd(di, n) * 0.5), rnd(b, di, n))
        fn, plain = ops.ssm_scan, ss.ssm_scan_plain
        nbytes = 4 * (3 * b * s * di + 2 * b * s * n + di * n + 2 * b * di * n)
        flops = 7 * b * s * di * n + b * s * di
    else:
        b, s, w = shape
        ins = (torch.sigmoid(rnd(b, s, w)), rnd(b, s, w), rnd(b, w))
        fn, plain = ops.rglru_scan, rg.rglru_scan_plain
        nbytes = 4 * (3 * b * s * w + 2 * b * w)
        flops = 2 * b * s * w
    got = fn(*ins)
    torch.cuda.synchronize()
    want = plain(*ins)
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    for x, y, what in zip(got, want, ("outputs", "last state")):
        if not torch.allclose(x, y, atol=F32_TOL, rtol=F32_TOL):
            fail(f"{kernel} {name}: {what} differ from the plain version by up to "
                 f"{(x - y).abs().max().item()} > tol {F32_TOL}")
    extra = ""
    if kernel == "ssm_scan":
        if name in BATCH_INVARIANT:
            for i in range(b):
                one = fn(*(t[i:i + 1] if t.dim() == 3 else t for t in ins))
                torch.cuda.synchronize()
                if not all(torch.equal(o[0], w[i]) for o, w in zip(one, got)):
                    fail(f"ssm_scan {name}: row {i} alone differs from its row in the batch "
                         f"of {b}")
            print(f"  ssm_scan | {name}: each of the {b} rows alone == its row in the batch, "
                  f"bitwise", flush=True)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        sfu_ms = b * s * di * n / (16 * sms * sm_clock_hz) * 1e3
        plan = ss.scan_plan(b, s, di, n, sms=sms)
        extra = (f" SFU floor={sfu_ms:.4f} ms ({sm_clock_hz / 1e9:.3f} GHz, {sms} SMs); plan "
                 f"{plan['kernel']}, {plan['channels']} channels a block, grid {plan['grid']}, "
                 f"{plan['steps']} steps x {plan['stages']} stages, {plan['smem']} B shared, "
                 f"16-byte copies dt/x {plan['vec_d']} B/C {plan['vec_n']}")
    ms = time_ms(lambda: fn(*ins), flush, 20)
    plain_ms = time_ms(lambda: plain(*ins), flush, 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  {kernel} | {name} {shape}: max_abs_err={err:.3g} kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms bound={rec['bound_ms']:.4f} ms ({rec['bound_by']})"
          + extra, flush=True)
    return rec


def gemm_cases():
    # name, M, K, N, weight layout ("kn": (K, N) row-major; "nk": stored
    # transposed, a tied head), bias, dtype, block-diagonal blocks (0: none)
    return [
        ("qwen1.5-4b decode qkv width (main path)", 8, 2560, 7680, "kn", False, "bfloat16", 0),
        ("qwen1.5-4b decode down_proj", 8, 6912, 2560, "kn", False, "bfloat16", 0),
        ("qwen1.5-4b decode head", 8, 2560, 151936, "kn", False, "bfloat16", 0),
        ("qwen1.5-4b prefill gate/up", 2048, 2560, 6912, "kn", False, "bfloat16", 0),
        ("qwen1.5-4b prefill down_proj", 2048, 6912, 2560, "kn", False, "bfloat16", 0),
        ("falcon-mamba-7b prefill in_proj", 2048, 4096, 16384, "kn", False, "bfloat16", 0),
        ("qwen1.5-4b decode q with bias", 8, 2560, 2560, "kn", True, "bfloat16", 0),
        ("recurrentgemma-2b decode tied head", 8, 2560, 256000, "nk", False, "bfloat16", 0),
        ("falcon-mamba-7b prefill x_proj (N 288)", 2048, 8192, 288, "kn", False, "bfloat16", 0),
        ("falcon-mamba-7b prefill dt_proj, strided x", 2048, 256, 8192, "kn", True,
         "bfloat16", 0),
        ("recurrentgemma-2b prefill gates, 10 blocks", 2048, 256, 256, "kn", True,
         "bfloat16", 10),
        ("odd shape, plain loads", 5, 36, 100, "kn", True, "bfloat16", 0),
        ("odd shape, transposed, plain loads", 130, 100, 36, "nk", False, "bfloat16", 0),
        ("M 1, ragged N", 1, 264, 1000, "kn", True, "bfloat16", 0),
        ("float32 decode", 8, 2560, 2560, "kn", True, "float32", 0),
        ("float32 prefill, ragged", 300, 256, 300, "nk", False, "float32", 0),
        ("float32 gates, 10 blocks", 64, 256, 256, "kn", True, "float32", 10),
        # whisper-tiny: the encoder's fc1 over 32 x 1500 frames, and the tied
        # head, whose N 51865 (not a multiple of 8) takes the plain route.
        ("whisper-tiny prefill encoder fc1 (M 48000)", WHISPER_B * 1500, 384, 1536, "kn", True,
         "bfloat16", 0),
        (WHISPER_HEAD, WHISPER_B, 384, 51865, "nk", False, "bfloat16", 0),
    ]


def gemm_operands(case, dev, torch):
    """x, w, bias of a GEMM case: x ~ N(0, 1), w ~ N(0, 1/K) (outputs of
    order 1, as a model's), the strided-x case reading dt_proj's input as
    a view of x_proj's output (rows 288 apart)."""
    name, m, k, n, layout, has_bias, dname, nb = case
    dt = getattr(torch, dname)
    g = torch.Generator(device=dev).manual_seed(len(name))
    if "strided" in name:
        x = torch.randn((m, k + 32), generator=g, device=dev).to(dt)[:, :k]
    elif nb:
        x = torch.randn((m, nb, k), generator=g, device=dev).to(dt)
    else:
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
    wshape = (nb, k, n) if nb else (k, n)
    w = (torch.randn(wshape, generator=g, device=dev) * k ** -0.5).to(dt)
    if layout == "nk":
        w = w.T.contiguous().T  # (K, N) view of an (N, K) row-major table
    bias = None
    if has_bias:
        bias = torch.randn((nb, n) if nb else (n,), generator=g, device=dev).to(dt)
    return x, w, bias


def run_gemm_case(case, dev, flush, torch, gemm):
    """The row-invariant GEMM against torch.matmul (its plain version; the
    same call is the cuBLAS yardstick) at the tolerance of its dtype: both
    round one float32 sum of the same products, summed in different
    orders.  Bound: x, w (and bias) read once and y written once at
    3.35 TB/s, against 2*M*N*K operations at the dtype's peak."""
    name, m, k, n, layout, has_bias, dname, nb = case
    x, w, bias = gemm_operands(case, dev, torch)
    got = gemm.linear(x, w, bias)
    torch.cuda.synchronize()
    want = gemm.linear_plain(x, w, bias)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if dname == "bfloat16" else F32_TOL
    if got.shape != want.shape or not torch.allclose(got.float(), want.float(), atol=tol,
                                                     rtol=tol):
        fail(f"gemm_rowinv {name}: max |kernel - plain| = {err} > tol {tol}")
    ms = time_ms(lambda: gemm.linear(x, w, bias), flush, 20)
    plain_ms = time_ms(lambda: gemm.linear_plain(x, w, bias), flush, 20)
    if nb:
        lib_ms = time_ms(lambda: torch.matmul(x.transpose(0, 1), w), flush, 20)
    else:
        lib_ms = time_ms(lambda: torch.matmul(x, w), flush, 20)
    blocks = max(nb, 1)
    nbytes = x.element_size() * (m * k * blocks + k * n * blocks + m * n * blocks
                                 + (bias.numel() if bias is not None else 0))
    flops = 2 * m * n * k * blocks
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    o = gemm.operands(x, w, bias)
    plan = gemm.plan(o["m"], o["n"], o["k"], o["wt"], o["tma"], batch=o["batch"], dtype=x.dtype)
    rate = (f"{flops / ms / 1e9:.1f} TFLOP/s of {PEAK_FLOPS[dname] / 1e12:.0f}"
            if rec["bound_by"] == "operations" else
            f"{nbytes / ms / 1e9:.3f} TB/s of {HBM_BYTES_PER_S / 1e12:.2f}")
    print(f"  gemm_rowinv | {name} (M {m}, K {k}, N {n}{f', {nb} blocks' if nb else ''}, w "
          f"{'transposed' if o['wt'] else 'row-major'}{', bias' if has_bias else ''}, {dname}): "
          f"plan {plan.describe()}; max_abs_err={err:.3g} kernel={ms:.4f} ms ({rate}) "
          f"plain={plain_ms:.4f} ms cuBLAS={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


ROW_PROBE = (0, 1, 2, 3, 5, 7, 15, 16, 63, 64, 127, 128, 299, 1000, 2047, 4095)
ROW_MS = (1, 3, 8, 64, 65, 300, 2048, 4096)  # the routes' boundaries, a ragged tile, 2 x 2048


def row_invariance(name, fn, x, torch, hold: bool, ms=ROW_MS) -> str:
    """Row r of ``fn`` over the first M rows of x, for each M of ``ms``,
    against the same row computed alone (M = 1), bitwise, for the rows of
    ``ROW_PROBE`` below M.  Held (a failure) with ``hold``, else counted
    and returned."""
    alone = {r: fn(x[r:r + 1])[0] for r in ROW_PROBE if r < max(ms)}
    bad = total = 0
    for m in ms:
        y = fn(x[:m])
        for r in ROW_PROBE:
            if r < m:
                total += 1
                if not torch.equal(y[r], alone[r]):
                    bad += 1
                    if hold:
                        torch.cuda.synchronize()
                        fail(f"{name}: row {r} of the M = {m} product differs from the same "
                             f"row computed alone")
    torch.cuda.synchronize()
    return f"{total - bad}/{total} rows equal to the row alone"


def route_agreement(what, x, w, b, torch, gemm) -> str:
    """Every bf16 route's product of the same M = 300 rows, bitwise equal to
    the plan's (one k16 chain whatever the tile and the load path), on at
    most 2048 columns of w (the plain loads are slow); and x misaligned by
    one element in a larger buffer (the plain loads) equal to x's rows."""
    xs, ws, bs = x[:300], w[:, :2048], None if b is None else b[:2048]
    want = gemm.linear(xs, ws, bs)
    routes = [r for r in gemm.ROUTES if r != "f32"]
    for route in routes:
        if not torch.equal(gemm.linear(xs, ws, bs, route=route), want):
            torch.cuda.synchronize()
            fail(f"gemm_rowinv {what}: route {route} differs from the plan's route")
    buf = torch.empty(xs.numel() + 8, dtype=xs.dtype, device=xs.device)
    xm = buf[1:1 + xs.numel()].view(xs.shape)
    xm.copy_(xs)
    o = gemm.operands(xm, ws, bs)
    route = gemm.plan(o["m"], o["n"], o["k"], o["wt"], o["tma"]).route
    if route != "plain" or not torch.equal(gemm.linear(xm, ws, bs), want):
        torch.cuda.synchronize()
        fail(f"gemm_rowinv {what}: x misaligned by one element (route {route}) differs from "
             f"the aligned rows")
    torch.cuda.synchronize()
    return (f"routes {', '.join(routes)} equal at M 300; x misaligned by one element "
            f"({route}) equal to the aligned rows")


def run_row_checks(dev, torch, gemm, rn):
    """The batch-invariance contract of the two row kernels, held bitwise;
    beside it, printed, what torch.matmul (cuBLAS) and PyTorch's own
    reductions give on the same rows: the fault the kernels repair."""
    g = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    x = torch.randn((4096, 6912), generator=g, device=dev).to(bf)
    ms = ", ".join(map(str, ROW_MS))
    for k, n, layout, has_bias in ((2560, 2560, "kn", True), (6912, 2560, "kn", False),
                                   (2560, 151936, "kn", False), (2560, 256000, "nk", False),
                                   (8192, 288, "kn", False), (384, 51865, "nk", False)):
        xk = x[:, :k] if k <= x.shape[1] else torch.randn((4096, k), generator=g,
                                                           device=dev).to(bf)
        w = (torch.randn((k, n) if layout == "kn" else (n, k), generator=g, device=dev)
             * k ** -0.5).to(bf)
        w = w if layout == "kn" else w.T
        b = torch.randn((n,), generator=g, device=dev).to(bf) if has_bias else None
        what = f"K {k}, N {n}{', transposed w' if layout == 'nk' else ''}{', bias' if b is not None else ''}"
        held = row_invariance(f"gemm_rowinv {what}", lambda t: gemm.linear(t, w, b), xk, torch,
                              True)
        lib = row_invariance("torch.matmul", lambda t: gemm.linear_plain(t, w, b), xk, torch,
                             False)
        agree = route_agreement(what, xk, w, b, torch, gemm)
        print(f"  gemm_rowinv | rows at M {ms} vs alone, {what}: kernel {held} "
              f"(held, bitwise); {agree} (held); torch.matmul {lib} (printed)", flush=True)
        del w
    del x
    for d, dname in ((2560, "bfloat16"), (4096, "bfloat16"), (2560, "float32")):
        dt = getattr(torch, dname)
        xd = torch.randn((4096, d), generator=g, device=dev).to(dt)
        wd = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
        held = row_invariance(f"rms_norm d {d}", lambda t: rn.rms_norm(t, wd, 1e-6), xd, torch,
                              True)
        lib = row_invariance("rms_norm_plain", lambda t: rn.rms_norm_plain(t, wd, 1e-6), xd,
                             torch, False)
        print(f"  rms_norm | rows at M {ms} vs alone, d {d} {dname} (plan {rn.plan(d)}): "
              f"kernel {held} "
              f"(held, bitwise); PyTorch's mean {lib} (printed)", flush=True)
    # The per-row einsums of falcon-mamba-7b's decode step (models/mamba.py:
    # the state readout and the one-step conv) stay PyTorch calls: held here
    # as the contract needs them, each row at batch 1, 3 and 8 against the
    # row alone.
    di, n, ck = 8192, 16, 4
    h = torch.randn((8, di, n), generator=g, device=dev)
    c = torch.randn((8, n), generator=g, device=dev)
    conv = torch.randn((8, ck, di), generator=g, device=dev).to(bf)
    cw = torch.randn((di, ck), generator=g, device=dev).to(bf)
    for what, fn in (("bdn,bn->bd (state readout)",
                      lambda i, j: torch.einsum("bdn,bn->bd", h[i:j], c[i:j])),
                     ("bkd,dk->bd (one-step conv)",
                      lambda i, j: torch.einsum("bkd,dk->bd", conv[i:j], cw))):
        for bsz in (1, 3, 8):
            y = fn(0, bsz)
            for r in range(bsz):
                if not torch.equal(y[r], fn(r, r + 1)[0]):
                    fail(f"einsum {what}: row {r} at batch {bsz} differs from the row alone")
        print(f"  [rows] falcon-mamba-7b decode einsum {what}: every row at batch 1, 3 and 8 == "
              f"the row alone (held, bitwise)", flush=True)


def rms_norm_cases():
    # name, rows, d, dtype, row stride (0: contiguous)
    return [
        ("qwen1.5-4b prefill (main path)", 2048, 2560, "bfloat16", 0),
        ("qwen1.5-4b decode", 8, 2560, "bfloat16", 0),
        ("falcon-mamba-7b prefill", 2048, 4096, "bfloat16", 0),
        ("last rows of a prefill (strided)", 8, 2560, "bfloat16", 256 * 2560),
        ("odd width", 7, 300, "bfloat16", 0),
        ("float32", 2048, 2560, "float32", 0),
    ]


def run_rms_norm_case(case, dev, flush, torch, rn):
    name, rows, d, dname, ld = case
    dt = getattr(torch, dname)
    g = torch.Generator(device=dev).manual_seed(len(name))
    if ld:
        x = torch.randn((rows, ld // d, d), generator=g, device=dev).to(dt)[:, -1]
    else:
        x = torch.randn((rows, d), generator=g, device=dev).to(dt)
    w = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
    got = rn.rms_norm(x, w, 1e-6)
    torch.cuda.synchronize()
    want = rn.rms_norm_plain(x, w, 1e-6)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if dname == "bfloat16" else F32_TOL
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"rms_norm {name}: max |kernel - plain| = {err} > tol {tol}")
    ms = time_ms(lambda: rn.rms_norm(x, w, 1e-6), flush, 20)
    plain_ms = time_ms(lambda: rn.rms_norm_plain(x, w, 1e-6), flush, 20)
    lib_ms = time_ms(lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6), flush, 20)
    nbytes = x.element_size() * (2 * rows * d + d)
    flops = 4 * rows * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["float32"] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  rms_norm | {name} ({rows} x {d}, {dname}): max_abs_err={err:.3g} "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms F.rms_norm={lib_ms:.4f} ms "
          f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
    return rec


def layer_norm_cases():
    # name, rows, d, dtype, row stride (0: contiguous)
    return [
        ("whisper-tiny encoder, 32 x 1500 rows (main path)", WHISPER_B * 1500, 384, "bfloat16",
         0),
        ("whisper-tiny decode", WHISPER_B, 384, "bfloat16", 0),
        ("whisper-tiny last rows of a prefill (strided)", WHISPER_B, 384, "bfloat16",
         WHISPER_PROMPT * 384),
        ("odd width", 7, 300, "bfloat16", 0),
        ("wide rows, the loop that reads x again", 64, 5000, "bfloat16", 0),
        ("float32", 2048, 384, "float32", 0),
    ]


def run_layer_norm_case(case, dev, flush, torch, ln):
    """``layer_norm`` against its plain version at the tolerance of its
    dtype, beside ``F.layer_norm`` (the library call: one fused pass, the
    same function up to the cast before the scale).  Bound: x read and y
    written once, w and b read, at 3.35 TB/s."""
    from repro_torch.kernels.rms_norm import plan as norm_plan

    name, rows, d, dname, ld = case
    dt = getattr(torch, dname)
    g = torch.Generator(device=dev).manual_seed(len(name))
    # A mean away from 0, as the centred variance must take it.
    x = (torch.randn((rows, ld // d, d) if ld else (rows, d), generator=g, device=dev) * 3
         + 1).to(dt)
    if ld:
        x = x[:, -1]
    w = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
    b = (0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
    got = ln.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    want = ln.layer_norm_plain(x, w, b, 1e-5)
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_TOL if dname == "bfloat16" else F32_TOL
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"layer_norm {name}: max |kernel - plain| = {err} > tol {tol}")
    ms = time_ms(lambda: ln.layer_norm(x, w, b, 1e-5), flush, 20)
    plain_ms = time_ms(lambda: ln.layer_norm_plain(x, w, b, 1e-5), flush, 20)
    lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(x, (d,), w, b, 1e-5), flush, 20)
    nbytes = x.element_size() * (2 * rows * d + 2 * d)
    flops = 8 * rows * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["float32"] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  layer_norm | {name} ({rows} x {d}, {dname}, plan {norm_plan(d)}): "
          f"max_abs_err={err:.3g} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"F.layer_norm={lib_ms:.4f} ms bound={rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)
    return rec


def run_layer_norm_rows(dev, torch, ln):
    """layer_norm's rows bitwise at M 1, 3, 8 and 32 x 1500 (whisper's
    decode, a ragged block, the prefill's encoder rows) against the same
    row alone, in bf16 and float32; PyTorch's own LayerNorm beside it,
    printed."""
    g = torch.Generator(device=dev).manual_seed(18)
    ms = (1, 3, 8, WHISPER_B * 1500)
    for d, dname in ((384, "bfloat16"), (384, "float32"), (300, "bfloat16")):
        dt = getattr(torch, dname)
        x = (torch.randn((max(ms), d), generator=g, device=dev) * 3 + 1).to(dt)
        w = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
        b = (0.1 * torch.randn((d,), generator=g, device=dev)).to(dt)
        held = row_invariance(f"layer_norm d {d} {dname}", lambda t: ln.layer_norm(t, w, b, 1e-5),
                              x, torch, True, ms=ms)
        lib = row_invariance("F.layer_norm", lambda t: torch.nn.functional.layer_norm(
            t, (d,), w, b, 1e-5), x, torch, False, ms=ms)
        print(f"  layer_norm | rows at M {', '.join(map(str, ms))} vs alone, d {d} {dname}: "
              f"kernel {held} (held, bitwise); F.layer_norm {lib} (printed)", flush=True)


def host_us(dev, torch, gemm, rn, calls: int = 1000) -> str:
    """The wrappers' host time per call at qwen1.5-4b's decode shapes: the
    mean over ``calls`` calls of ``gemm.linear`` (8 x 2560 by 2560 x 7680),
    of the same with x at a new address each call (where the kernel caches
    TMA maps, x's is encoded anew), and of ``rms_norm`` (8 x 2560),
    launched back to back without a synchronize (decode is host-bound: this
    is what a step pays a call)."""
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((8, 2560), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((2560, 7680), generator=g, device=dev).to(torch.bfloat16)
    wn = torch.ones((2560,), device=dev, dtype=torch.bfloat16)
    xs = torch.randn((8 * (calls + 100), 2560), generator=g, device=dev).to(torch.bfloat16)
    out = []
    for name, fn in (("gemm.linear 8x2560 @ 2560x7680", lambda i: gemm.linear(x, w)),
                     ("the same with x at a new address each call",
                      lambda i: gemm.linear(xs[8 * i:8 * i + 8], w)),
                     ("rms_norm 8x2560", lambda i: rn.rms_norm(x, wn, 1e-6))):
        for i in range(100):
            fn(calls + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        out.append(f"{name} {us:.2f} us")
    return (f"[host] wrapper host time per call, mean of {calls} calls without a synchronize: "
            + "; ".join(out))


def ssm_ptxas(text):
    """(instance NP, registers, spill line) of each ssm_scan kernel instance
    in the ptxas output of its build; nothing when it was not built now."""
    import re

    found, inst, spill = [], None, ""
    for line in (text or "").splitlines():
        m = re.search(r"Compiling entry function '\S*ssm_scan_kernelILi(\d+)E", line)
        if m:
            inst = int(m.group(1))
        elif inst is not None and "spill" in line:
            spill = line.strip()
        elif inst is not None and "Used" in line and "registers" in line:
            found.append((inst, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            inst = None
    if text is not None and not found:
        fail("no ssm_scan_kernel instance in ssm_scan's ptxas output")
    return sorted(found)


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def prefill_logits(cfg, params, batch, gen, dev):
    from repro_torch.models import get_model
    from repro_torch.serve import zeros_cache
    from repro_torch.serve.step import prefix_len

    api = get_model(cfg)
    b, s = batch["tokens"].shape
    cache = zeros_cache(cfg, api, b, prefix_len(cfg) + s + gen, device=dev)
    return api.prefill(params, batch, cfg, cache)[0]


# The products whose outputs a layer adds to the residual stream: the
# attention output projection, the MLP's down projection (arctic's dense
# residual branch's too), the Mamba and RG-LRU mixers' output projections,
# whisper's self- and cross-attention outputs and its MLP's second product;
# a MoE layer also adds its moe_ffn output (``layer_errors``).
RESIDUAL_FEEDS = (("attn", "wo"), ("mlp", "w_down"), ("dense_mlp", "w_down"), ("out_proj",),
                  ("mix", "wo"), ("mix", "out"), ("self_attn", "wo"), ("cross_attn", "wo"),
                  ("mlp", "w_out"))


def residual_feeds(lp) -> set:
    """data_ptr of each weight of layer params ``lp`` that feeds the
    residual stream."""
    ptrs = set()
    for path in RESIDUAL_FEEDS:
        t = lp
        for key in path:
            t = t.get(key) if isinstance(t, dict) else None
        if t is not None:
            ptrs.add(t.data_ptr())
    return ptrs


def layer_errors(cfg, params, batch, dev, torch, modes) -> dict:
    """The bf16 prefill and (with ``"decode"`` in ``modes``) the first
    decode step one layer at a time, teacher-forced: every layer gets the
    reference path's input, runs once through the kernels and once through
    the dense reference, and gives the relative L2 distance of the two
    layers' updates, each measured before the bf16 residual add: the sum,
    in float32, of the outputs of the layer's products that feed the
    residual stream (``RESIDUAL_FEEDS``).  ``errs[mode]`` holds these;
    ``errs[mode + "_rounded"]`` the distance of the rounded updates
    ``y - x``, printed only: where a layer adds less than half a bf16 ulp
    of the stream (recurrentgemma-2b's later rec layers at decode add 0.2%
    of it), ``y - x`` is the residual's rounding, and two paths whose
    products round differently part there by whole ulps of the stream.
    Both caches receive the same inputs, so the decode step holds
    flash_decode in the same way.  Random weights make a deep stack
    chaotic (see ``run_main_path``), so this is where a tolerance can hold
    the kernels at the main path's full width and depth."""
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import rglru as R
    from repro_torch.models import transformer as T
    from repro_torch.serve import zeros_cache
    from repro_torch.serve.step import prefix_len

    stack = R if cfg.family == "hybrid" else T
    rcfg = dataclasses.replace(cfg, kernel_impl="reference")
    tokens = batch["tokens"]
    b, s = tokens.shape
    # The vlm family's prefill runs its patches ahead of the prompt, under
    # the prefix-LM mask.
    pre = prefix_len(cfg)
    s += pre
    caches = [zeros_cache(c, get_model(c), b, s + 1, device=dev) for c in (cfg, rcfg)]
    layers = [stack.stack_order(params, cache, cfg) for cache in caches]
    errs = {}
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    real_linear, feeds, fed = L.linear, set(), []

    def linear(x, w, impl="reference", bias=None):
        y = real_linear(x, w, impl, bias)
        if w.data_ptr() in feeds:
            fed.append(y.float())
        return y

    real_ffn = M.moe_ffn

    def moe_ffn(x, p, cfg, impl=None):
        y = real_ffn(x, p, cfg, impl)
        fed.append(y.float().view(b, -1, y.shape[-1]))
        return y

    L.linear, M.moe_ffn = linear, moe_ffn
    try:
        for mode in modes:  # the prefill fills both caches for the decode step
            x = T.embed_tokens(params, tokens if mode == "prefill" else tokens[:, -1:], cfg)
            kw = {}
            if pre and mode == "prefill":
                x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
                kw = {"prefix_len": pre}
            errs[mode], errs[mode + "_rounded"] = [], []
            for (apply, lp, kc), (_, _, rc) in zip(*layers):
                feeds.clear()
                feeds.update(residual_feeds(lp))
                outs = []
                for c, cache in ((cfg, kc), (rcfg, rc)):
                    fed.clear()
                    y = apply(lp, x, positions, c, mode=mode, cache=cache, pos=s, **kw)[0]
                    if not fed:
                        fail(f"{cfg.name}: no residual-feeding product seen in a {mode} layer")
                    outs.append((y, sum(fed)))
                (yk, uk), (yr, ur) = outs
                errs[mode].append(float((uk - ur).norm() / ur.norm()))
                errs[mode + "_rounded"].append(
                    float((yk - yr).float().norm() / (yr - x).float().norm()))
                x = yr
    finally:
        L.linear, M.moe_ffn = real_linear, real_ffn
    return errs


def encdec_layer_errors(cfg, params, batch, dev, torch) -> dict:
    """``layer_errors`` for the audio family: every encoder layer, then
    every decoder layer of the prefill and of the first decode step (at
    position S), one at a time, teacher-forced: each gets the reference
    path's input (the decoder layers the reference's encoder output too),
    runs once through the kernels and once through the dense reference on
    a cache of its own, and gives the relative L2 distance of the two
    updates before the bf16 residual add (the float32 sum of the outputs
    of its ``wo`` and ``w_out`` products, biases included).  Returns
    ``{"encoder": [...], "prefill": [...], "decode": [...]}`` and each
    with ``_rounded`` (the rounded ``y - x``, printed)."""
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models import whisper as W
    from repro_torch.models.params import unstack
    from repro_torch.serve import zeros_cache

    rcfg = dataclasses.replace(cfg, kernel_impl="reference")
    tokens = batch["tokens"]
    b, s = tokens.shape
    caches = [zeros_cache(c, get_model(c), b, s + 1, device=dev) for c in (cfg, rcfg)]
    real_linear, feeds, fed = L.linear, set(), []

    def linear(x, w, impl="reference", bias=None):
        y = real_linear(x, w, impl, bias)
        if w.data_ptr() in feeds:
            fed.append(y.float())
        return y

    def run(name, lps, x, step):
        errs[name], errs[name + "_rounded"] = [], []
        for i, lp in enumerate(lps):
            feeds.clear()
            feeds.update(residual_feeds(lp))
            outs = []
            for c, cache in ((cfg, caches[0]), (rcfg, caches[1])):
                fed.clear()
                y = step(lp, x, c, cache, i)
                if not fed:
                    fail(f"{cfg.name}: no residual-feeding product seen in a {name} layer")
                outs.append((y, sum(fed)))
            (yk, uk), (yr, ur) = outs
            errs[name].append(float((uk - ur).norm() / ur.norm()))
            errs[name + "_rounded"].append(
                float((yk - yr).float().norm() / (yr - x).float().norm()))
            x = yr
        return x

    errs = {}
    enc = unstack(params["enc_layers"], cfg.enc_layers)
    dec = unstack(params["dec_layers"], cfg.n_layers)
    L.linear = linear
    try:
        x = run("encoder", enc, W.encoder_input(batch["frames"], cfg),
                lambda lp, x, c, cache, i: W._enc_layer(lp, x, c))
        post = params["enc_ln_post"]
        enc_out = L.layer_norm(x, post["w"], post["b"], cfg.norm_eps, "reference")
        x, _ = W.decoder_input(params, tokens, cfg)
        run("prefill", dec, x, lambda lp, x, c, cache, i: W._dec_layer(
            lp, x, enc_out, c, mode="prefill", cache=unstack(cache, cfg.n_layers)[i], posv=None))
        x, posv = W.decoder_input(params, tokens[:, -1:], cfg, s)
        run("decode", dec, x, lambda lp, x, c, cache, i: W._dec_layer(
            lp, x, None, c, mode="decode", cache=unstack(cache, cfg.n_layers)[i], posv=posv))
    finally:
        L.linear = real_linear
    return errs


# The port's kernels by their CUDA symbols (csrc/), longest match first.
KERNEL_SYMBOLS = (("flash_decode_paged", "flash_decode_paged"),
                  ("flash_decode_chunk", "flash_decode_chunk"),
                  # The decode kernels' merge of a slot's key chunks.
                  ("combine_chunks_kernel", "flash_decode_combine"),
                  ("flash_decode", "flash_decode"), ("flash_attention", "flash_attention"),
                  ("gemm_wgmma_kernel", "gemm_rowinv"), ("gemm_f32_kernel", "gemm_rowinv"),
                  ("rms_norm_kernel", "rms_norm"), ("layer_norm_kernel", "layer_norm"),
                  ("moe_gemm_kernel", "moe_gemm"),
                  ("ssm_scan_kernel", "ssm_scan"),
                  ("rglru_scan_kernel", "rglru_scan"))


def kernel_group(name: str) -> str:
    """A device kernel's group: the port kernel its symbol belongs to, else
    PyTorch's kernel name without namespace and template arguments."""
    for sym, group in KERNEL_SYMBOLS:
        if sym in name:
            return group
    short = name.replace("(anonymous namespace)::", "")
    if short.startswith("std::enable_if"):  # a return type ahead of the name
        short = short.split(">::type", 1)[-1]
    parts = short.split("<")[0].split("(")[0].replace("void ", "").strip().split("::")
    return "torch:" + "::".join(parts[-2:] if parts[-1] == "kernel" else parts[-1:])[:48]


def gemm_ops(params, run, torch) -> list:
    """The parameter each ``gemm_rowinv`` call of ``run()`` multiplies by,
    in launch order (the tree path of the weight's storage in ``params``,
    the cast weights the model reads; the tied head is the embedding)."""
    from repro_torch.kernels import ops

    names = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (str(k),))
        elif isinstance(tree, torch.Tensor):
            # Stacks of layers (``layers``, or ``units`` of a block pattern
            # whose positions are ``l<i>_<kind>``) name one product.
            names[tree.untyped_storage().data_ptr()] = ".".join(
                re.sub(r"^l\d+_", "", p) for p in path if p not in ("layers", "units"))
    walk(params, ())
    seq, real = [], ops.linear

    def recorded(x, w, *a, **kw):
        seq.append(names.get(w.untyped_storage().data_ptr(), "?"))
        return real(x, w, *a, **kw)

    ops.linear = recorded
    try:
        run()
    finally:
        ops.linear = real
    return seq


def by_kernel(events, ops_seq, per: int) -> dict:
    """Device time (ms) and launches of a region's kernels, grouped by
    kernel and, for ``gemm_rowinv``, by the product each launch computes
    (``ops_seq``, the eager launch order, which a graph keeps), each
    divided by ``per`` (the region's steps).  Where the trace lost a
    launch, the products are labelled step by step instead: a decode step
    ends at its argmax (PyTorch's one ``reduce_kernel`` a step), and only
    the steps whose trace holds every launch are labelled
    (``gemm_steps_labelled``; ``gemm_by_op`` None when none is)."""
    kernels = {}
    for name, ms in events:
        d = kernels.setdefault(kernel_group(name), [0, 0.0])
        d[0] += 1
        d[1] += ms
    steps, step = [], []
    for name, ms in events:
        if kernel_group(name) == "gemm_rowinv":
            step.append(ms)
        elif per > 1 and "reduce_kernel" in name:
            steps.append(step)
            step = []
    steps.append(step)
    if sum(map(len, steps)) == len(ops_seq):
        full, seq, n_labelled = [[ms for st in steps for ms in st]], ops_seq, per
    else:
        seq = ops_seq[:len(ops_seq) // per]
        full = [st for st in steps if len(st) == len(seq)] if per > 1 else []
        n_labelled = len(full)
    gemm = {}
    for st in full:
        for ms, op in zip(st, seq):
            d = gemm.setdefault(op, [0, 0.0])
            d[0] += 1
            d[1] += ms

    def table(d, n):
        return {k: {"launches": c / n, "ms": t / n}
                for k, (c, t) in sorted(d.items(), key=lambda kv: -kv[1][1])}
    return {"kernels": table(kernels, per),
            "gemm_by_op": table(gemm, n_labelled) if full else None,
            "gemm_steps_labelled": n_labelled if full else 0}


PROFILE_PAD = 32  # spin kernels ahead of each profiled region


def trace_losses(want: list, got: list, window: int = 8, skip: int = 16) -> list:
    """Where a trace's kernel names ``got`` lack launches of ``want`` (the
    same work's names, launched in the same order): ``(index in want,
    launches lacking, the first one's name, the name before it)`` per gap,
    names shortened to their kernel group.  A greedy walk: at a mismatch,
    the fewest names skipped in ``want`` (a loss) or in ``got`` (a launch
    the other region lacks) after which ``window`` names agree."""
    def agree(i, j):
        return want[i:i + window] == got[j:j + window]

    out, i, j = [], 0, 0
    while i < len(want) and j < len(got):
        if want[i] == got[j]:
            i, j = i + 1, j + 1
            continue
        for k in range(1, skip + 1):
            if agree(i + k, j):
                out.append((i, k, kernel_group(want[i]),
                            kernel_group(want[i - 1]) if i else "the start"))
                i += k
                break
            if agree(i, j + k):
                j += k
                break
        else:
            i, j = i + 1, j + 1  # no resync within reach: step past both
    if i < len(want):
        out.append((i, len(want) - i, kernel_group(want[i]),
                    kernel_group(want[i - 1]) if i else "the start"))
    return out


def gemm_launches(events) -> int:
    return sum(kernel_group(name) == "gemm_rowinv" for _, name, _ in events)


def profile_steps(cfg, params, batch, dev, torch) -> dict:
    """torch.profiler over one prefill and then 8 decode steps of the main
    path, each both eager and replayed as CUDA graphs (one-shot generate's
    own: ``make_generate(...).prefill`` replays its prefill graph, which
    writes the chain graph's static cache, and ``.chain`` its chain of 8
    steps on it; both captured before by ``generate.prepare``): the card's
    busy time (the sum of its kernels' durations, the graphs' kernels
    included) against the host's wall time for each, CUDA events around
    each region (the card's span from its first to its last operation, gaps
    included), and, for the graphed regions, every kernel's device time and
    launches, by kernel and, for ``gemm_rowinv``, by product (B7; per step
    for the decode region).  The profiler adds host time of its own, and
    its trace lacks the first few launches after it starts, so a pad of
    spin kernels runs ahead of each region (``pad_launches_traced``: how
    many of them the trace held), and the eager decode region starts at a
    device position, as the graphed one does, so that the two launch the
    same kernels in the same order (``trace_losses`` compares them)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import gemm
    from repro_torch.models import get_model
    from repro_torch.serve import make_decode_chain, make_generate, make_prefill_step, zeros_cache
    from repro_torch.serve.step import prefix_len

    t_start = time.perf_counter()
    api = get_model(cfg)
    b, s = batch["tokens"].shape
    s += prefix_len(cfg)  # the vlm family's patches sit ahead of the prompt
    steps = 8
    prefill = make_prefill_step(cfg, api)
    cache = zeros_cache(cfg, api, b, s + steps + 1, device=dev)
    tok, cache = prefill(params, batch, cache)
    generate = make_generate(cfg, api)
    t0 = time.perf_counter()
    capture_s = generate.prepare(params, batch, steps + 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    gtok, gpos, gcache, kw = generate.prefill(params, batch, steps + 1)
    torch.cuda.synchronize()
    eager_chain = make_decode_chain(cfg, api)
    # A device start position, as the graphed chain takes: the two regions
    # then launch the same kernels in the same order.
    spos = torch.tensor(s, dtype=torch.int32, device=dev)
    regions = (("prefill", lambda: prefill(params, batch, cache)),
               ("decode_8_steps", lambda: eager_chain(params, cache, tok, spos, steps)),
               ("prefill_graph", lambda: generate.prefill(params, batch, steps + 1)),
               ("decode_8_steps_graph",
                lambda: generate.chain(params, gcache, gtok, gpos, steps, **kw)))
    ops_seq = {"prefill_graph": gemm_ops(params, lambda: prefill(params, batch, cache), torch),
               "decode_8_steps_graph": gemm_ops(
                   params, lambda: eager_chain(params, cache, tok, spos, steps), torch)}
    out = {"graph_capture_s": capture_s, "graph_first_call_s": first_s,
           "graph_loops": generate.graphs.stats()["loops"]}
    names = {}  # each region's kernel names in launch order
    for region, run in regions:
        torch.cuda.synchronize()
        maps = gemm.maps_encoded()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # The trace lacks the first launches after the profiler starts
            # (eager and graphed regions alike): spin kernels ahead of the
            # region take that loss, and are left out of its events.
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            run()
            ev[1].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # The raw trace, not prof.events(): building the event tree of a
        # region's CPU ops and kernels takes the host seconds.
        events = sorted((e.start_ns(), e.name(), e.duration_ns() / 1e6)
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA)
        pad = sum("spin_kernel" in name for _, name, _ in events)
        events = [e for e in events if "spin_kernel" not in e[1]]
        names[region] = [name for _, name, _ in events]
        busy = sum(ms for _, _, ms in events)
        span = ev[0].elapsed_time(ev[1])
        maps = gemm.maps_encoded() - maps
        if region.endswith("graph") and maps:
            fail(f"{cfg.name}: a replay of the {region} graph encoded {maps} TMA maps")
        out[region] = {"wall_ms": wall * 1e3, "device_busy_ms": busy, "device_span_ms": span,
                       "pad_launches_traced": pad}
        if region.endswith("graph"):
            # A graph launches the eager region's kernels in the same order:
            # where its trace lacks one, say which, and where in the order.
            lost = trace_losses(names[region[:-len("_graph")]], names[region])
            out[region]["trace_losses"] = lost
            for i, n, name, before in lost:
                print(f"  [profile] {region}: the trace lacks {n} launch(es) of the eager "
                      f"region's {len(names[region[:-len('_graph')]])}, at launch {i} "
                      f"({name}, after {before})", flush=True)
        print(f"  [profile] {region}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
              f"({'not measured' if busy == 0 else f'{busy / wall / 1e3:.1%}'}), CUDA events "
              f"{span:.1f} ms; the trace holds {pad} of the {PROFILE_PAD} pad launches ahead "
              f"of it", flush=True)
        if region in ops_seq:
            per = steps if region.startswith("decode") else 1
            bk = by_kernel([(name, ms) for _, name, ms in events], ops_seq[region], per)
            out[region].update(bk)
            unit = "a step" if per > 1 else "a prefill"
            print(f"  [B7] {cfg.name} {region}, per {unit.split()[-1]}: by kernel (launches, ms) "
                  + "; ".join(f"{k} {d['launches']:g}, {d['ms']:.3f}"
                              for k, d in bk["kernels"].items()), flush=True)
            print(f"  [B7] {cfg.name} {region}, gemm_rowinv by product (launches, ms {unit}): "
                  + ("; ".join(f"{k} {d['launches']:g}, {d['ms']:.3f}"
                               for k, d in bk["gemm_by_op"].items())
                     + (f" (the {bk['gemm_steps_labelled']} of {per} steps whose trace "
                        f"holds every launch)" if bk["gemm_steps_labelled"] < per else "")
                     if bk["gemm_by_op"] is not None else
                     f"not measured (the trace held {gemm_launches(events)} of "
                     f"{len(ops_seq[region])} launches)"), flush=True)
    st = generate.graphs.stats()
    out["graph_replays"] = st["replays"]
    if st["warmup_clone_bytes"]:
        fail(f"{cfg.name}: generate's captures warmed up on {st['warmup_clone_bytes']} B of clones")
    print(f"  [graph] prefill: eager busy {out['prefill']['device_busy_ms']:.1f} / wall "
          f"{out['prefill']['wall_ms']:.1f} ms, graphed busy "
          f"{out['prefill_graph']['device_busy_ms']:.1f} / wall "
          f"{out['prefill_graph']['wall_ms']:.1f} ms; decode 8 steps: eager busy "
          f"{out['decode_8_steps']['device_busy_ms']:.1f} / "
          f"wall {out['decode_8_steps']['wall_ms']:.1f} ms, graphed busy "
          f"{out['decode_8_steps_graph']['device_busy_ms']:.1f} / wall "
          f"{out['decode_8_steps_graph']['wall_ms']:.1f} ms (profiler on); capture of both "
          f"{capture_s:.3f} s ({loops_line(out['graph_loops'])}); no replay encoded a TMA map "
          f"(held); the pass took {time.perf_counter() - t_start:.1f} s", flush=True)
    return out


def loops_line(loops: dict) -> str:
    """Capture seconds per loop, split by phase."""
    return "; ".join(f"{name} x{d['captures']}: "
                     + (f"waiting {d['wait_s']:.3f}, " if d["wait_s"] else "")
                     + f"warm-up {d['warmup_s']:.3f}, begin {d['begin_s']:.3f}, recording "
                     f"{d['record_s']:.3f}, instantiation {d['instantiate_s']:.3f} s"
                     for name, d in loops.items())


def oneshot_modes(cfg, api, params, batch, gen, want, torch) -> dict:
    """One-shot generate of the main path's batch eager (``graph=False``:
    eager prefill and chain) and graphed (prefill and the chain captured
    first by ``generate.prepare``), two calls each, the first under the
    span tracer (the graphs' replays timed by CUDA events), the second
    timed (host clock to the tokens on the host).  Held: every call's
    tokens bitwise ``want`` (the launcher's graphed run); the graphed
    generate captured its two graphs once, with no warm-up clone, and
    replayed each once a call, its second call copying in the batch's
    leaves only, the prompt tokens (and the audio family's frames or the vlm
    family's patches): the prefill graph writes the chain's static cache,
    token and start position."""
    import numpy as np

    from repro_torch.core.trace import Tracer, set_tracer
    from repro_torch.serve import make_generate

    out = {}
    for mode in ("eager", "graph"):
        generate = make_generate(cfg, api, graph=mode == "graph")
        capture_s = generate.prepare(params, batch, gen)
        # The first, untimed call under the span tracer: the graph cache
        # logs its replay with CUDA events around it.
        prev = set_tracer(Tracer(enabled=True))
        try:
            firsts = generate(params, batch, gen).cpu().numpy()
        finally:
            set_tracer(prev)
        torch.cuda.synchronize()
        before = (generate.graphs.copy_ins, generate.graphs.copy_in_bytes) if generate.graphs else None
        t0 = time.perf_counter()
        toks = generate(params, batch, gen).cpu().numpy()
        wall = time.perf_counter() - t0
        if not (np.array_equal(firsts, want) and np.array_equal(toks, want)):
            fail(f"{cfg.name}: {mode} one-shot tokens differ from the launcher's graphed run")
        rec = {"tokens_per_s": toks.size / wall, "wall_s": wall, "capture_s": capture_s}
        if mode == "graph":
            st = generate.graphs.stats()
            copies, nbytes = st["copy_ins"] - before[0], st["copy_in_bytes"] - before[1]
            replay_ms = {name: ms for name, _, _, ms in st["per_replay"][:2]}
            leaves = len(batch)
            if (st["captures"], st["replays"], copies, st["warmup_clone_bytes"]) != (
                    2, 4, leaves, 0):
                fail(f"{cfg.name}: graphed generate captured {st['captures']}, replayed "
                     f"{st['replays']}, copied {copies} inputs in on its second call, cloned "
                     f"{st['warmup_clone_bytes']} B for warm-ups; want 2, 4, {leaves} (the "
                     f"batch's leaves {sorted(batch)}), 0")
            rec.update(captures=st["captures"], replays=st["replays"],
                       second_call_copy_ins=copies, second_call_copy_in_bytes=nbytes,
                       first_call_replay_device_ms=replay_ms, loops=st["loops"],
                       static_bytes=st["static_bytes"])
        out[mode] = rec
        del generate
    print(f"  [graph] one-shot, second call: eager {out['eager']['tokens_per_s']:.1f} tokens/s "
          f"({out['eager']['wall_s']:.3f} s), graphed {out['graph']['tokens_per_s']:.1f} tokens/s "
          f"({out['graph']['wall_s']:.3f} s); capture {out['graph']['capture_s']:.3f} s; graphed "
          f"tokens bitwise eager (held); second graphed call copied in "
          f"{out['graph']['second_call_copy_ins']} inputs, "
          f"{out['graph']['second_call_copy_in_bytes']} B ({' and '.join(sorted(batch))}; "
          f"held); the first "
          f"call's replays took the card {out['graph']['first_call_replay_device_ms']} ms (CUDA "
          f"events); capture {loops_line(out['graph']['loops'])}", flush=True)
    return out


def row_kernel_launches(arch: str, forwards: int, n_layers: int = 0) -> dict:
    """Launches of the row kernels in ``forwards`` passes of the
    full-width stack (a prefill or one decode step each; ``n_layers``
    overrides the depth): one GEMM per product of models/ (dense and vlm
    layer: q, k, v, o and three MLP products; MoE layer: q, k, v, o, the
    router and, with a dense residual, its three products; Mamba layer:
    in_proj, x_proj, dt_proj, out_proj; recurrent layer: in_y, in_x, the
    two block-diagonal gates and out, plus three MLP products), one for the
    head; one rms_norm per norm of a layer and the final one; two
    ``moe_gemm`` per MoE layer (gate and up fused, then down).  The audio
    family's first pass is its prefill, the rest decode steps: a prefill
    runs per encoder layer q, k, v, o and two MLP products and two
    layer_norms, then the encoder's final norm, per decoder layer its self
    q, k, v, o, its cross q, k, v (over the frames), o and two MLP products
    and three norms, then the final norm and the head; a decode step per
    decoder layer 8 products (no cross k, v: they are cached) and three
    norms, then the final norm and the head."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    n = n_layers or cfg.n_layers
    moe = 0
    if cfg.family in ("dense", "vlm"):
        gemm, norms = 7 * n + 1, 2 * n + 1
    elif cfg.family == "moe":
        gemm, norms, moe = (5 + 3 * cfg.dense_residual) * n + 1, 2 * n + 1, 2 * n
    elif cfg.family == "ssm":
        gemm, norms = 4 * n + 1, n + 1
    elif cfg.family == "audio":
        e, steps = cfg.enc_layers, forwards - 1
        return {"gemm_rowinv": 6 * e + 10 * n + 1 + (8 * n + 1) * steps, "rms_norm": 0,
                "moe_gemm": 0, "layer_norm": 2 * e + 3 * n + 2 + (3 * n + 1) * steps}
    else:
        pat = cfg.block_pattern
        kinds = list(pat) * (n // len(pat)) + list(pat[: n % len(pat)])
        rec = kinds.count("rec")
        gemm, norms = 8 * rec + 7 * (n - rec) + 1, 2 * n + 1
    return {"gemm_rowinv": gemm * forwards, "rms_norm": norms * forwards,
            "moe_gemm": moe * forwards, "layer_norm": 0}


def main_paths():
    """(arch, requests, prompt length, generated, launches wanted, modes of
    the per-layer check) of each main path, run in this order.  Generate
    runs ``gen`` passes: the prefill and gen - 1 decode steps."""
    def want(arch, gen, fa=0, fd=0, ss=0, rg=0):
        return {"flash_attention": fa, "flash_decode": fd, "flash_decode_paged": 0,
                "ssm_scan": ss, "rglru_scan": rg, **row_kernel_launches(arch, gen)}

    q, m, r = "qwen1.5-4b", "falcon-mamba-7b", "recurrentgemma-2b"
    return [
        (q, 8, 256, GEN, want(q, GEN, fa=40, fd=40 * (GEN - 1)), ("prefill", "decode")),
        (m, 8, 256, GEN, want(m, GEN, ss=64), ("prefill",)),
        (r, 8, 256, GEN, want(r, GEN, fa=8, fd=8 * (GEN - 1), rg=18), ("prefill", "decode")),
        (r, 2, 2048, 16, want(r, 16, fa=8, fd=8 * 15, rg=18), ("prefill", "decode")),
        (m, 2, 300, 8, want(m, 8, ss=64), ("prefill",)),
        (r, 2, 300, 8, want(r, 8, fa=8, fd=8 * 7, rg=18), ("prefill", "decode")),
    ]


def run_main_path(argv, dev, torch, modes) -> dict:
    """The launcher's one-shot generate with the launch counts zeroed just
    before and read just after, then the checks of its prefill (and decode
    step, with ``"decode"`` in ``modes``) against the dense reference on
    the same weights (see ``layer_errors``)."""
    from repro_torch.kernels import gemm, ops
    from repro_torch.launch import serve
    from repro_torch.serve import cast_params_cached

    maps = gemm.maps_encoded()
    ops.reset_launch_counts()
    result = serve.main(argv)
    counts = ops.launch_counts()
    maps = gemm.maps_encoded() - maps
    toks = result["tokens"]
    args = serve.parse_args(argv)
    cfg, api, params = serve.load_model(args)
    if toks.shape != (args.requests, args.gen) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}]")
    g = result["graphs"]
    if g["captures"] != 2 or g["replays"] != 2 or g["warmup_clone_bytes"]:
        fail(f"the launcher's generate captured {g['captures']} and replayed {g['replays']} "
             f"graphs, cloning {g['warmup_clone_bytes']} B for warm-ups; want 2 and 2 (prefill "
             f"and the decode chain), 0")
    print(f"  [graph] the launcher's prefill and decode chain: captured in "
          f"{result['capture_s']:.3f} s before the timed call, replayed once each; gemm_rowinv "
          f"encoded {maps} TMA maps on this path (at the captures' warm-ups and recordings: a "
          f"replay encodes none)", flush=True)
    batch = serve.load_batch(cfg, args)
    modes_1shot = oneshot_modes(cfg, api, params, batch, args.gen, toks, torch)
    cast = cast_params_cached(params, cfg.compute_dtype)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    ref = dataclasses.replace(cfg, kernel_impl="reference")
    lk = prefill_logits(cfg, cast, batch, args.gen, dev)
    lr = prefill_logits(ref, cast, batch, args.gen, dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    ref32 = dataclasses.replace(ref, compute_dtype="float32")
    lk32 = prefill_logits(f32, params, batch, args.gen, dev)
    lr32 = prefill_logits(ref32, params, batch, args.gen, dev)
    # The model's own sensitivity: the float32 reference with every
    # embedding entry moved by one ulp.
    nudged = dict(params, embed=torch.nextafter(params["embed"],
                                                torch.tensor(float("inf"), device=dev)))
    ln32 = prefill_logits(ref32, nudged, batch, args.gen, dev)
    del nudged
    if not all(torch.isfinite(x).all() for x in (lk, lr, lk32, lr32, ln32)):
        fail("non-finite first-token logits")
    first_ok = bool((lk.argmax(-1)[:, 0].int().cpu().numpy() == toks[:, 0]).all())
    errs = layer_errors(cfg, cast, batch, dev, torch, modes)
    rounded = {m: errs.pop(m + "_rounded") for m in modes}
    out = {"counts": counts, "arch": cfg.name, "layers": cfg.n_layers,
           "requests": args.requests, "prompt_len": args.prompt_len, "gen": args.gen,
           "wall_s": result["wall_s"], "tokens_per_s": result["tokens_per_s"],
           "capture_s": result["capture_s"], "oneshot_modes": modes_1shot,
           "peak_memory_bytes": result["peak_memory_bytes"],
           "gemm_tma_maps_encoded": maps,
           "first_token_is_prefill_argmax": first_ok,
           **{f"layer_rel_l2_max_bf16_{m}": max(e) for m, e in errs.items()},
           **{f"layer_rel_l2_max_bf16_{m}_rounded_update": max(e) for m, e in rounded.items()},
           "logits_rel_l2_bf16": rel(lk, lr),
           "logits_rel_l2_f32": rel(lk32, lr32),
           "logits_rel_l2_bf16_reference_vs_f32_reference": rel(lr, lr32),
           "logits_rel_l2_f32_reference_embed_one_ulp": rel(ln32, lr32),
           "profile": profile_steps(cfg, cast, batch, dev, torch)}
    for mode, e in errs.items():
        print(f"  per-layer bf16 {mode} update before the residual add, kernel vs reference: "
              f"max rel L2 {max(e):.3g} (tol {LAYER_REL_TOL}; layers 0-3: "
              f"{[round(x, 5) for x in e[:4]]}); of the rounded update y - x (printed): max "
              f"{max(rounded[mode]):.3g}")
    print(f"  first-token logits of all {cfg.n_layers} layers (printed, not held): kernel vs "
          f"reference rel L2 {out['logits_rel_l2_bf16']:.3g} in bf16 and "
          f"{out['logits_rel_l2_f32']:.3g} in float32; the bf16 reference vs the float32 "
          f"reference {out['logits_rel_l2_bf16_reference_vs_f32_reference']:.3g}; the float32 "
          f"reference vs itself with the embeddings one ulp off "
          f"{out['logits_rel_l2_f32_reference_embed_one_ulp']:.3g}", flush=True)
    print(f"  generate's first token = argmax of its prefill logits: {first_ok}", flush=True)
    return out


def a9_paths():
    """(arch, requests, prompt length, generated, launches wanted) of the
    audio and vlm families' one-shot paths, full width and depth.
    whisper-tiny: flash_attention on every encoder layer and, at the
    prefill, on each decoder layer's causal self-attention and its
    cross-attention over the 1500 frames; flash_decode twice a decoder
    layer a step (self over the cache, cross over the encoder's keys).
    paligemma-3b: the dense counts, its 18 prefills in prefix-LM mode."""
    def want(arch, gen, fa, fd):
        return {"flash_attention": fa, "flash_decode": fd, "flash_decode_paged": 0,
                "ssm_scan": 0, "rglru_scan": 0, **row_kernel_launches(arch, gen)}

    from repro_torch.configs import get_config

    w, p = get_config("whisper-tiny"), get_config("paligemma-3b")
    return [
        (w.name, WHISPER_B, WHISPER_PROMPT, WHISPER_GEN,
         want(w.name, WHISPER_GEN, w.enc_layers + 2 * w.n_layers,
              2 * w.n_layers * (WHISPER_GEN - 1))),
        (p.name, 8, 32, GEN, want(p.name, GEN, p.n_layers, p.n_layers * (GEN - 1))),
    ]


def run_a9_path(argv, dev, torch) -> dict:
    """The launcher's one-shot generate of an audio or vlm model (its batch
    carries frames or image patches) with the launch counts zeroed just
    before and read just after; then one-shot generate eager and graphed
    (``oneshot_modes``: graphed bits = eager bits, a call copying in the
    tokens and the frames or patches); every layer of the prefill and of
    the first decode step (whisper: every encoder layer too) held within
    2e-2 relative L2 of the reference impl's (``kernel_impl="reference"``:
    dense torch attention, torch.matmul, PyTorch's norms) on the same bf16
    weights, teacher-forced (``layer_errors``, ``encdec_layer_errors``);
    the first token the prefill's argmax; the profiler pass
    (``profile_steps``: busy against wall, ``[B7]``).  The prefill's
    last-row logits of the whole stack are printed beside, not held: with
    random weights the float32 reference moves as far when its input (the
    frames, the token embeddings) moves by one ulp."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import cast_params_cached

    ops.reset_launch_counts()
    result = serve.main(argv)
    counts = ops.launch_counts()
    toks = result["tokens"]
    args = serve.parse_args(argv)
    cfg, api, params = serve.load_model(args)
    if toks.shape != (args.requests, args.gen) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{cfg.name}: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}]")
    g = result["graphs"]
    if g["captures"] != 2 or g["replays"] != 2 or g["warmup_clone_bytes"]:
        fail(f"{cfg.name}: the launcher's generate captured {g['captures']} and replayed "
             f"{g['replays']} graphs, cloning {g['warmup_clone_bytes']} B; want 2, 2, 0")
    batch = serve.load_batch(cfg, args)
    modes = oneshot_modes(cfg, api, params, batch, args.gen, toks, torch)
    cast = cast_params_cached(params, cfg.compute_dtype)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    ref = dataclasses.replace(cfg, kernel_impl="reference")
    lk = prefill_logits(cfg, cast, batch, args.gen, dev)
    lr = prefill_logits(ref, cast, batch, args.gen, dev)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    ref32 = dataclasses.replace(ref, compute_dtype="float32")
    lk32 = prefill_logits(f32, params, batch, args.gen, dev)
    lr32 = prefill_logits(ref32, params, batch, args.gen, dev)
    # The stack's input one float32 ulp off: the frames (the encoder's
    # input) for the audio family, the token embeddings for the vlm family.
    inf = torch.tensor(float("inf"), device=dev)
    if cfg.family == "audio":
        nudged = dict(batch, frames=torch.nextafter(batch["frames"].float(), inf))
        ln32 = prefill_logits(ref32, params, nudged, args.gen, dev)
    else:
        nudged = dict(params, embed=torch.nextafter(params["embed"], inf))
        ln32 = prefill_logits(ref32, nudged, batch, args.gen, dev)
    del nudged
    if not all(torch.isfinite(x).all() for x in (lk, lr, lk32, lr32, ln32)):
        fail(f"{cfg.name}: non-finite first-token logits")
    first_ok = bool((lk.argmax(-1)[:, 0].int().cpu().numpy() == toks[:, 0]).all())
    if cfg.family == "audio":
        errs = encdec_layer_errors(cfg, cast, batch, dev, torch)
    else:
        errs = layer_errors(cfg, cast, batch, dev, torch, ("prefill", "decode"))
    rounded = {m: errs.pop(m + "_rounded") for m in list(errs) if not m.endswith("_rounded")}
    out = {"counts": counts, "arch": cfg.name, "layers": cfg.n_layers,
           "requests": args.requests, "prompt_len": args.prompt_len, "gen": args.gen,
           "wall_s": result["wall_s"], "tokens_per_s": result["tokens_per_s"],
           "capture_s": result["capture_s"], "oneshot_modes": modes,
           "peak_memory_bytes": result["peak_memory_bytes"],
           "first_token_is_prefill_argmax": first_ok,
           **{f"layer_rel_l2_max_bf16_{m}": max(e) for m, e in errs.items()},
           **{f"layer_rel_l2_max_bf16_{m}_rounded_update": max(e) for m, e in rounded.items()},
           "logits_rel_l2_bf16": rel(lk, lr), "logits_rel_l2_f32": rel(lk32, lr32),
           "logits_rel_l2_bf16_reference_vs_f32_reference": rel(lr, lr32),
           "logits_rel_l2_f32_reference_input_one_ulp": rel(ln32, lr32)}
    for mode, e in errs.items():
        print(f"  per-layer bf16 {mode} update before the residual add, kernel vs reference: "
              f"max rel L2 {max(e):.3g} (held, tol {LAYER_REL_TOL}; layers 0-3: "
              f"{[round(x, 5) for x in e[:4]]}); of the rounded update y - x (printed): max "
              f"{max(rounded[mode]):.3g}", flush=True)
    print(f"  {cfg.name}: prefill last-row logits of the whole stack (printed, not held), "
          f"kernels vs reference impl: rel L2 {out['logits_rel_l2_bf16']:.3g} in bf16, "
          f"{out['logits_rel_l2_f32']:.3g} in float32; the bf16 reference vs the float32 "
          f"reference {out['logits_rel_l2_bf16_reference_vs_f32_reference']:.3g}; the float32 "
          f"reference vs itself with its {'frames' if cfg.family == 'audio' else 'embeddings'} "
          f"one ulp off {out['logits_rel_l2_f32_reference_input_one_ulp']:.3g}; generate's "
          f"first token = "
          f"argmax of its prefill logits: {first_ok}; one-shot {result['tokens_per_s']:.1f} "
          f"tokens/s, capture {result['capture_s']:.3f} s, peak memory "
          f"{(result['peak_memory_bytes'] or 0) / 2**30:.2f} GiB", flush=True)
    for mode, e in errs.items():
        if max(e) > LAYER_REL_TOL:
            fail(f"{cfg.name}: a bf16 {mode} layer through the kernels disagrees with the "
                 f"reference ({max(e):.3g})")
    if not first_ok:
        fail(f"{cfg.name}: generate's first token is not the argmax of its prefill logits")
    out["profile"] = profile_steps(cfg, cast, batch, dev, torch)
    return out


WHISPER_COEXEC_ARGV = ["--arch", "whisper-tiny", "--full", "--coexec", "--scheduler", "hguided",
                       "--verify", "--requests", str(WHISPER_B), "--prompt-len",
                       str(WHISPER_PROMPT), "--gen", str(WHISPER_GEN), "--seed", "0",
                       "--kernel", "cuda"]


# qwen1.5-4b's served and co-executed paths run at this depth, full width:
# the launcher's config cut here (as ``moe_model`` cuts its configs), every
# bitwise and launch-count check kept, the counts following the depth.
SERVED_DEPTH = 8


@contextlib.contextmanager
def served_depth(depth: int = SERVED_DEPTH):
    """The launcher's models at ``depth`` layers, full width, while the
    block runs: ``launch.serve``'s ``get_config`` wrapped."""
    from repro_torch.launch import serve

    real = serve.get_config
    serve.get_config = lambda name: dataclasses.replace(real(name), n_layers=depth)
    try:
        yield
    finally:
        serve.get_config = real


def served_oneshot_counts(depth: int = SERVED_DEPTH) -> dict:
    """The launches of qwen1.5-4b's one-shot generate of 8 x 256 + GEN at
    ``depth`` layers (the main path's at its full depth)."""
    return {"flash_attention": depth, "flash_decode": depth * (GEN - 1),
            "flash_decode_paged": 0, "ssm_scan": 0, "rglru_scan": 0,
            **row_kernel_launches("qwen1.5-4b", GEN, depth)}


SERVER_ARGV = ["--arch", "qwen1.5-4b", "--full", "--server", "--paged", "--block-len", "16",
               "--seg-len", "8", "--max-batch", "8", "--requests", "8", "--prompt-len", "256",
               "--gen", str(GEN), "--rate", "1000", "--max-wait-ms", "200", "--seed", "0",
               "--kernel", "cuda"]


MODES = ("eager", "graph")


def served_modes(run, torch, *, profiled=False, multi_row=False, modes=MODES) -> dict:
    """``run(graph)`` (the launcher's ``run_server``, or the server API) run
    eager and then graphed (``InferenceServer(graph=)``), each with the
    launch counts zeroed just before and read just after (with
    ``multi_row``, also the decode kernels' multi-row launches), the span
    tracer on (the runtime's dispatch, write-back and epilogue spans, the
    batcher's segment spans) and, with ``profiled``, torch.profiler
    recording the card's activity (its kernels' and copies' durations
    summed: the card's busy time).  No request may fail or be rejected; in
    the graphed run every segment must be a graph replay and every prefill
    wave a replay of the group's graph, and no capture may warm up on
    clones; the eager run captures nothing.  Returns ``{mode: (result,
    counts, busy ms or None, record)}``, the record as
    :func:`mode_record`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.trace import Tracer, set_tracer, tracer
    from repro_torch.kernels import gemm, ops

    out = {}
    for mode in modes:
        # Free the previous run's server (its graphs and buffers), so that
        # each run's peak memory is its own.
        gc.collect()
        prev, tr = tracer(), Tracer(capacity=1 << 17, enabled=True)
        set_tracer(tr)
        maps = gemm.maps_encoded()
        ops.reset_launch_counts()
        prof = None
        try:
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    result = run(mode == "graph")
            else:
                result = run(mode == "graph")
        finally:
            counts = ops.launch_counts()
            if multi_row:
                counts["multi_row"] = ops.multi_row_counts()
            set_tracer(prev)
        maps = gemm.maps_encoded() - maps
        # The runtime's host spans of each segment Program (not the prefill
        # waves'): dispatch (the loop's launches, or its copy-ins and
        # replay; the graphed run's first also its capture), write-back and
        # the epilogue (the ping-pong swap of its buffers); the dispatch's
        # upload (its inputs' transfers: re-uploads of mirrors a join
        # rewrote, cache hits otherwise).
        host = {"dispatch": [], "upload": [], "write_back": [], "runtime.epilogue": []}
        for e in tr.chrome_events():
            if (e.get("ph") == "X" and e["name"] in host
                    and "prefill" not in e["args"].get("kernel", "")):
                host[e["name"]].append(e["dur"] / 1e3)
        busy = None
        if prof is not None:
            # The raw trace, not prof.events(): building the event tree of a
            # run's ~10^5 kernels takes the host tens of seconds.
            busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
        s = result["stats"]
        if (s["completed"] != len(result["results"]) or s["failed"] or s["rejected"]
                or any(r is None for r in result["results"])):
            fail(f"served run ({mode}): {s['completed']} completed, {s['failed']} failed, "
                 f"{s['rejected']} rejected of {len(result['results'])}")
        g = s.get("graphs")
        if (g is not None) != (mode == "graph") or (g and g["replays"] != s["segments"]):
            fail(f"served run ({mode}): {s['segments']} segments, graph counters {g}: every "
                 f"graphed segment must be one replay, and no eager one")
        if g and g["warmup_clone_bytes"]:
            fail(f"served run ({mode}): a capture warmed up on {g['warmup_clone_bytes']} bytes "
                 f"of clones of a live cache; every loop must be captured before its first bind")
        waves = 0 if s["chunk_len"] else s["prefill_waves"]
        for name, gg in s["group_graphs"].items():
            want = (waves, 0) if mode == "graph" else (0, 0)
            if (gg["replays"], gg["warmup_clone_bytes"]) != want or (
                    mode == "eager" and gg["captures"]):
                fail(f"served run ({mode}): group {name} replayed {gg['replays']} prefill graphs "
                     f"({gg['captures']} captures, warm-up clones {gg['warmup_clone_bytes']} B); "
                     f"want {want[0]} (one a prefill wave) and 0 B, none eager")
        out[mode] = (result, counts, busy, mode_record(result, busy, maps, host))
    return out


def mode_record(result, busy, maps, host) -> dict:
    """One served run's numbers: tokens/s, wall, TTFT, segments, the host's
    dispatch and write-back of each segment (ms, the runtime's spans; the
    graphed run's first segment also captures its loop), peak memory, TMA
    maps encoded, the card's busy time where profiled, and the graph's
    captures, capture seconds, replays and copy-ins per replay (count and
    bytes)."""
    s = result["stats"]
    rec = {"tokens_per_s": result.get("tokens_per_s", s["tokens_out"] / result["wall_s"]),
           "wall_s": result["wall_s"],
           "ttft_s": sorted(m["ttft"] for m in result["request_metrics"]),
           "segments": s["segments"], "dispatch_ms": host["dispatch"],
           "write_back_ms": host["write_back"], "epilogue_ms": host["runtime.epilogue"],
           "upload_ms": host["upload"],
           "peak_memory_bytes": result.get("peak_memory_bytes"),
           "gemm_tma_maps_encoded": maps}
    if busy is not None:
        rec.update(device_busy_ms=busy, device_busy_share=busy / 1e3 / result["wall_s"])
    g = s.get("graphs")
    if g:
        rec["graph"] = {"captures": g["captures"], "capture_s": g["capture_s"],
                        "warmup_s": g["warmup_s"], "instantiate_s": g["instantiate_s"],
                        "replays": g["replays"], "static_bytes": g["static_bytes"],
                        "warmup_clone_bytes": g["warmup_clone_bytes"],
                        "copy_ins": [r[1] for r in g["per_replay"]],
                        "copy_in_bytes": [r[2] for r in g["per_replay"]],
                        "replay_device_ms": [r[3] for r in g["per_replay"]],
                        "loops": g["loops"]}
    waves = [gg for gg in s["group_graphs"].values() if gg["captures"]]
    if waves:
        rec["prefill_graph"] = {"captures": sum(gg["captures"] for gg in waves),
                                "replays": sum(gg["replays"] for gg in waves),
                                "output_copy_bytes": sum(gg["output_copy_bytes"] for gg in waves),
                                "loops": {k: v for gg in waves for k, v in gg["loops"].items()}}
    return rec


def print_modes(label, recs) -> None:
    """One line a mode, eager beside graphed."""
    def ms(xs):
        return "[" + ", ".join("?" if x is None else f"{x:.1f}" for x in xs) + "]"

    for mode, r in recs.items():
        t = r["ttft_s"]
        line = (f"  [graph] {label}, {mode}: {r['tokens_per_s']:.1f} tokens/s, {r['wall_s']:.3f} s,"
                f" TTFT {t[0]:.3f}-{t[-1]:.3f} s, {r['segments']} segments; host per segment: "
                f"dispatch {ms(r['dispatch_ms'])} ms (of it upload {ms(r['upload_ms'])} ms), "
                f"write-back {ms(r['write_back_ms'])} ms, epilogue {ms(r['epilogue_ms'])} ms")
        if "device_busy_ms" in r:
            line += f"; card busy {r['device_busy_ms']:.1f} ms ({r['device_busy_share']:.1%})"
        if r["peak_memory_bytes"]:
            line += f"; peak {r['peak_memory_bytes'] / 2**30:.2f} GiB"
        g = r.get("graph")
        if g:
            line += (f"; {g['captures']} captures in {g['capture_s']:.3f} s (warm-up "
                     f"{g['warmup_s']:.3f}, instantiation {g['instantiate_s']:.3f}; in its first "
                     f"segment's dispatch; warm-up clones {g['warmup_clone_bytes']} bytes, "
                     f"held at 0), {g['replays']} replays, copy-ins per replay "
                     f"{list(zip(g['copy_ins'], g['copy_in_bytes']))} (count, bytes), each "
                     f"replay's device time (CUDA events) {ms(g['replay_device_ms'])} ms; TMA maps "
                     f"encoded {r['gemm_tma_maps_encoded']} (at warm-up and capture); capture "
                     f"by loop: {loops_line(g['loops'])}")
        p = r.get("prefill_graph")
        if p:
            line += (f"; prefill waves: {p['replays']} replays of {p['captures']} group graphs "
                     f"(results copied out: {p['output_copy_bytes']} B), capture "
                     f"{loops_line(p['loops'])}")
        print(line, flush=True)


def host_round_trip_variants(run, torch) -> dict:
    """The served run graphed as the parent tree ran its host side, then
    with C8 repaired but C8b not: (1) ``Program.swap_buffers`` cloning the
    old input on the host each swap (the parent's code) with pageable
    mirrors; (2) the swap in place (this tree's), pageable mirrors.  This
    tree's own graphed run (pinned mirrors on a CUDA group) is
    :func:`served_modes`'s.  Returns ``{label: (result, counts, busy,
    record)}``."""
    from repro_torch.core import program as tprogram
    from repro_torch.serve import batcher

    real_swap, real_pin = tprogram.Program.swap_buffers, batcher.BatchGroup._pinned_mirrors

    def cloning_swap(self, i_in, i_out):
        new_in = self._outs[i_out]
        new_out = self._ins[i_in].clone()
        self._ins[i_in], self._outs[i_out] = new_in, new_out
        tprogram.bump_version(new_out)

    out = {}
    for label, swap in (("clone, pageable", cloning_swap), ("in place, pageable", real_swap)):
        tprogram.Program.swap_buffers = swap
        batcher.BatchGroup._pinned_mirrors = lambda self: False
        try:
            out[label] = served_modes(run, torch, modes=("graph",))["graph"]
        finally:
            tprogram.Program.swap_buffers = real_swap
            batcher.BatchGroup._pinned_mirrors = real_pin
    return out


def run_served_path(dev, torch) -> dict:
    """The launcher's paged continuous-batching server (``run_server``) on
    qwen1.5-4b's weights (the one-shot path's, drawn again from the same
    seed), eager and graphed (:func:`served_modes`).  Held for both: the
    launch counts, one prefill wave and 4 segments, and the streams against
    one-shot generate of the same 8 prompts as one batch and of each prompt
    alone (batch 1), bitwise; for the graphed run, every replay after the
    first copies in no pool leaf (the pool is the loop's own buffers,
    handed back through the runtime)."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serve import make_generate

    args = serve.parse_args(SERVER_ARGV)
    cfg, api, params = serve.load_model(args)
    if cfg.decode_block != args.block_len:
        fail(f"--paged --kernel cuda left decode_block at {cfg.decode_block}")
    run = lambda graph: serve.run_server(cfg, api, params, args, graph=graph)  # noqa: E731
    variants = host_round_trip_variants(run, torch)
    runs = served_modes(run, torch)
    segs = -(-(args.gen - 1) // args.seg_len)
    want = _launches(cfg.n_layers, fa=cfg.n_layers, fdp=cfg.n_layers * args.seg_len * segs,
                     forwards=[(1 + args.seg_len * segs, cfg.n_layers)])
    one8 = ones = None
    for mode, (result, counts, _, rec) in runs.items():
        s = result["stats"]
        print(f"  {mode}: launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"served path ({mode}) launch counts {counts} != {want}")
        if s["prefill_waves"] != 1 or s["segments"] != segs:
            fail(f"served path ({mode}) ran {s['prefill_waves']} prefill waves and "
                 f"{s['segments']} segments, want 1 and {segs}")
        served = np.stack(result["results"])
        if one8 is None:
            tokens = torch.from_numpy(np.stack(result["prompts"])).to(dev)
            generate = make_generate(cfg, api)
            one8 = generate(params, {"tokens": tokens}, args.gen).cpu().numpy()
            ones = np.stack([generate(params, {"tokens": tokens[i:i + 1]}, args.gen)[0]
                             .cpu().numpy() for i in range(args.requests)])
        rows8 = int(sum(np.array_equal(a, b) for a, b in zip(served, one8)))
        rows1 = int(sum(np.array_equal(a, b) for a, b in zip(served, ones)))
        if rows8 != args.requests or rows1 != args.requests:
            fail(f"served path ({mode}): {rows8}/{args.requests} streams equal one-shot generate "
                 f"of the same prompts as one batch, {rows1}/{args.requests} of each prompt "
                 f"alone (batch 1)")
        if mode == "graph":
            pool = s["memory"]["kv_bytes_device"]
            later = rec["graph"]["copy_in_bytes"][1:]
            if any(b >= pool // 4 for b in later):
                fail(f"served path: graphed segments after the first copied in {later} B "
                     f"(the pool holds {pool} B)")
    result, counts, _, _ = runs["graph"]
    for label, (vres, vcounts, _, _) in variants.items():
        if vcounts != counts or not all(np.array_equal(a, b) for a, b in
                                        zip(vres["results"], result["results"])):
            fail(f"served path ({label}): launch counts {vcounts} or streams differ from the "
                 f"pinned, in-place run's")
    s = result["stats"]
    mem = s["memory"]
    spans = result.get("spans", {})

    def per_package_ms(name):
        d = spans.get(name)
        return d["seconds"] / d["count"] * 1e3 if d else None
    out = {"arch": cfg.name, "requests": args.requests, "prompt_len": args.prompt_len,
           "gen": args.gen, "block_len": args.block_len, "seg_len": args.seg_len,
           "max_batch": args.max_batch, "wall_s": result["wall_s"],
           "tokens_per_s": result["tokens_per_s"],
           "peak_memory_bytes": result["peak_memory_bytes"],
           "prefill_waves": s["prefill_waves"], "segments": s["segments"],
           "blocks_peak": mem["blocks_peak"], "blocks_total": mem["blocks_total"],
           "bytes_per_block": mem["bytes_per_block"],
           "kv_bytes_allocated": mem["kv_bytes_allocated"],
           "kv_bytes_touched": mem["kv_bytes_touched"],
           "kv_bytes_device": mem["kv_bytes_device"],
           "transfers": s["transfers"],
           "segment_write_back_ms": per_package_ms(f"write_back/decode_pseg{args.seg_len}"),
           "segment_dispatch_ms": per_package_ms(f"dispatch/decode_pseg{args.seg_len}"),
           "prefill_write_back_ms": per_package_ms(f"write_back/prefill_{args.prompt_len}"),
           "prefill_dispatch_ms": per_package_ms(f"dispatch/prefill_{args.prompt_len}"),
           "streams_equal_batch8_oneshot": args.requests,
           "streams_equal_batch1_oneshot": args.requests,
           "ttft_s": sorted(m["ttft"] for m in result["request_metrics"]),
           "modes": {m: r[3] for m, r in runs.items()},
           "host_round_trip": {**{label: r[3] for label, r in variants.items()},
                               "in place, pinned": runs["graph"][3]}}
    print(f"  served == one-shot generate of the same prompts as one batch of "
          f"{args.requests}: {args.requests}/{args.requests}; == one-shot of each prompt alone "
          f"(batch 1): {args.requests}/{args.requests}; both held, bitwise, eager and graphed",
          flush=True)
    peak = result["peak_memory_bytes"] or 0
    print(f"  graphed: {result['tokens_per_s']:.1f} tokens/s, {result['wall_s']:.3f} s, peak "
          f"memory {peak / 2**30:.2f} GiB; pool {mem['blocks_peak']}/"
          f"{mem['blocks_total']} blocks at peak ({mem['kv_bytes_allocated']} B allocated, "
          f"{mem['kv_bytes_touched']} B touched, {mem['kv_bytes_device']} B on the card); "
          f"per segment (mean, the first one's capture included): host dispatch of its 8 steps "
          f"{out['segment_dispatch_ms']} ms, host write-back {out['segment_write_back_ms']} ms; "
          f"per prefill wave: dispatch "
          f"{out['prefill_dispatch_ms']} ms, write-back {out['prefill_write_back_ms']} ms",
          flush=True)
    print_modes("served, arrivals 1 ms apart", out["modes"])
    print(at() + " [C8] the segment's host round trip, graphed, this call: the parent's host "
          "clone of every swapped buffer with pageable mirrors, the swap in place with pageable "
          "mirrors, the swap in place with pinned mirrors (streams and launch counts held equal)",
          flush=True)
    print_modes("served, arrivals 1 ms apart", out["host_round_trip"])
    return out, counts, (np.stack(result["results"]), ones)


# The chunked served paths: the served path's model, prompts and lengths,
# with arrivals spread (Poisson at 4 requests/s, a lone request boards after
# 1 ms) so that later prompts prefill beside slots that already decode.
SPREAD = ["--rate", "4", "--max-wait-ms", "1"]


def _argv_with(argv, **flags):
    out = list(argv)
    for flag, value in flags.items():
        flag = "--" + flag.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = value
        else:
            out += [flag, value]
    return out


def graphed_unprofiled(run, torch, want_of, results, label) -> dict:
    """``run`` graphed once more without the profiler (CUPTI's tracing of a
    graph launch costs the host time per node), its launch counts held to
    ``want_of(its result)`` (the counts its own segments and chunk stages
    make: with spread arrivals they follow the host's timing) and its
    streams to ``results`` bitwise; its record (:func:`mode_record`),
    printed."""
    import numpy as np

    res, c, _, rec = served_modes(run, torch, modes=("graph",))["graph"]
    want = want_of(res)
    if c != want or not all(np.array_equal(a, b) for a, b in zip(res["results"], results)):
        fail(f"{label} (graphed, profiler off): launch counts {c} (want {want}) or streams "
             f"differ from the profiled graphed run's")
    print_modes(f"{label}, profiler off", {"graph": rec})
    return rec


def run_chunked_paths(dev, torch, whole) -> dict:
    """Chunked prefill through the launcher's server on qwen1.5-4b's
    weights, beside whole-prompt serving of the same arrivals, each eager
    and graphed, under the profiler (:func:`served_modes`):
    1. ``--paged --block-len 16 --chunk-len 64``, the served path's 8 x 256
       + 32 with spread arrivals, and the same arrivals served whole-prompt;
    2. ``--chunk-len 40`` on the contiguous layout, 4 requests.
    Held for every run: no failure; at least one segment mixing decoding
    and prefilling slots; launch counts exactly (chunked: flash_attention
    0, flash_decode n_layers per chunk stage, flash_decode_paged n_layers
    per decode step (contiguous: flash_decode for both), one gemm_rowinv per
    product and one rms_norm per norm of each chunk stage and decode step);
    every stream bitwise equal to the whole-prompt served streams and to
    one-shot generate of its prompt alone (batch 1).  Printed: tokens/s,
    each request's TTFT and the card's busy share beside the whole-prompt
    run's (the profiler adds host time to both)."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.serve import make_generate

    served_whole, ones = whole
    argv = SERVER_ARGV + SPREAD
    args_w = serve.parse_args(argv)
    args_c = serve.parse_args(argv + ["--chunk-len", str(CHUNK_LEN)])
    cfg, api, params = serve.load_model(args_c)
    n = cfg.n_layers
    out = {}
    def want_of(result, label, seg_len):
        steps = seg_len * result["stats"]["segments"]
        if label == "chunked":
            stages = result["chunk_stages"]
            return _launches(n, fd=n * stages, fdp=n * steps, forwards=[(stages + steps, n)])
        stages = result["stats"]["prefill_waves"]
        return _launches(n, fa=n * stages, fdp=n * steps, forwards=[(stages + steps, n)])

    for label, args in (("whole_prompt", args_w), ("chunked", args_c)):
        runs = served_modes(lambda graph: serve.run_server(cfg, api, params, args, graph=graph),
                            torch, profiled=True)
        for mode, (result, counts, busy, _) in runs.items():
            s = result["stats"]
            stages = result["chunk_stages"] if label == "chunked" else s["prefill_waves"]
            want = want_of(result, label, args.seg_len)
            print(f"  {label} ({mode}): launches {counts} (want {want})", flush=True)
            if counts != want:
                fail(f"{label} served path ({mode}) launch counts {counts} != {want}")
            got = np.stack(result["results"])
            eq_whole = int(sum(np.array_equal(a, b) for a, b in zip(got, served_whole)))
            eq_one = int(sum(np.array_equal(a, b) for a, b in zip(got, ones)))
            if eq_whole != args.requests or eq_one != args.requests:
                fail(f"{label} served path ({mode}): {eq_whole}/{args.requests} streams equal "
                     f"the whole-prompt served streams, {eq_one}/{args.requests} one-shot of "
                     f"each prompt alone")
            if label == "chunked" and result["mixed_segments"] < 1:
                fail(f"chunked served path ({mode}): no segment mixed decoding and prefilling "
                     f"slots")
            ttft = [m["ttft"] for m in result["request_metrics"]]
            print(f"  {label} ({mode}): {result['tokens_per_s']:.1f} tokens/s, "
                  f"{result['wall_s']:.3f} s, {s['segments']} segments"
                  + (f" ({stages} with a chunk stage, {result['mixed_segments']} mixed)"
                     if label == "chunked" else f", {stages} prefill waves")
                  + f"; card busy {busy:.1f} ms ({busy / 1e3 / result['wall_s']:.1%} of the "
                  f"wall, profiler on); TTFT s {[round(t, 3) for t in ttft]}; streams == "
                  f"whole-prompt served {eq_whole}/{args.requests}, == batch-1 one-shot "
                  f"{eq_one}/{args.requests} (held, bitwise)", flush=True)
        result, counts, busy, _ = runs["graph"]
        s = result["stats"]
        out[label] = {"wall_s": result["wall_s"], "tokens_per_s": result["tokens_per_s"],
                      "segments": s["segments"], "prefill_waves": s["prefill_waves"],
                      "device_busy_ms": busy,
                      "device_busy_share": busy / 1e3 / result["wall_s"],
                      "ttft_s": [m["ttft"] for m in result["request_metrics"]],
                      "streams_equal_whole_served": args.requests,
                      "streams_equal_batch1_oneshot": args.requests,
                      "modes": {m: r[3] for m, r in runs.items()}}
        print_modes(f"{label.replace('_', ' ')}, arrivals at 4/s", out[label]["modes"])
        if label == "chunked":
            chunked_counts = counts
            out[label].update(chunk_len=args.chunk_len, chunk_stages=result["chunk_stages"],
                              mixed_segments=result["mixed_segments"],
                              graph_profiler_off=graphed_unprofiled(
                                  lambda graph: serve.run_server(cfg, api, params, args,
                                                                 graph=graph),
                                  torch, lambda r: want_of(r, "chunked", args.seg_len),
                                  result["results"], "chunked (64)"))
    # 2. Contiguous chunked serving, chunks of 40, against its own one-shot
    # reference (decode tiles of 128: no --paged).
    argv = [a for a in argv if a not in ("--paged",)]
    argv = _argv_with(argv, requests="4", chunk_len="40")
    args = serve.parse_args(argv)
    ccfg = dataclasses.replace(cfg, decode_block=0)
    capi = get_model(ccfg)
    runs = served_modes(lambda graph: serve.run_server(ccfg, capi, params, args, graph=graph),
                        torch, profiled=True)
    generate = make_generate(ccfg, capi)
    refs = [generate(params, {"tokens": torch.from_numpy(p[None]).to(dev)}, args.gen)[0]
            .cpu().numpy() for p in runs["graph"][0]["prompts"]]
    def want40(result):
        stages, steps = result["chunk_stages"], args.seg_len * result["stats"]["segments"]
        return _launches(n, fd=n * (stages + steps), forwards=[(stages + steps, n)])

    for mode, (result, counts, busy, _) in runs.items():
        s = result["stats"]
        stages = result["chunk_stages"]
        want = want40(result)
        print(f"  contiguous, chunks of 40 ({mode}): launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"contiguous chunked served path ({mode}) launch counts {counts} != {want}")
        eq_one = _streams_equal(result, refs)
        if eq_one != args.requests:
            fail(f"contiguous chunked served path ({mode}): {eq_one}/{args.requests} streams "
                 f"equal one-shot generate of each prompt alone")
        print(f"  contiguous, chunks of 40 ({mode}): {args.requests} requests, {s['segments']} "
              f"segments ({stages} with a chunk stage, {result['mixed_segments']} mixed), "
              f"{result['tokens_per_s']:.1f} tokens/s; == batch-1 one-shot "
              f"{eq_one}/{args.requests} (held, bitwise)", flush=True)
    result, _, busy, _ = runs["graph"]
    s = result["stats"]
    out["contiguous_chunk40"] = {"requests": args.requests, "wall_s": result["wall_s"],
                                 "tokens_per_s": result["tokens_per_s"],
                                 "segments": s["segments"],
                                 "chunk_stages": result["chunk_stages"],
                                 "mixed_segments": result["mixed_segments"],
                                 "device_busy_ms": busy,
                                 "streams_equal_batch1_oneshot": args.requests,
                                 "modes": {m: r[3] for m, r in runs.items()}}
    print_modes("contiguous, chunks of 40", out["contiguous_chunk40"]["modes"])
    out["contiguous_chunk40"]["graph_profiler_off"] = graphed_unprofiled(
        lambda graph: serve.run_server(ccfg, capi, params, args, graph=graph), torch,
        want40, result["results"], "contiguous chunked (40)")
    return out, chunked_counts


def _launches(n, fa=0, fd=0, fdp=0, forwards=(), arch="qwen1.5-4b") -> dict:
    """A served path's wanted launch counts: the attention kernels' counts
    and the row kernels' of each (forwards, layers) pair."""
    want = {"flash_attention": fa, "flash_decode": fd,
            "flash_decode_paged": fdp, "ssm_scan": 0, "rglru_scan": 0,
            "gemm_rowinv": 0, "rms_norm": 0, "moe_gemm": 0, "layer_norm": 0}
    for f, layers in forwards:
        for name, c in row_kernel_launches(arch, f, layers).items():
            want[name] += c
    return want


def _streams_equal(result, want) -> int:
    import numpy as np

    return int(sum(np.array_equal(a, b) for a, b in zip(result["results"], want)))


def run_spec_paths(dev, torch, whole, plain_sp) -> tuple:
    """Speculative serving through the launcher's server on qwen1.5-4b's
    weights (8 x 256 + 32, arrivals 1 ms apart, seg_len 8, the served
    path's prompts), each eager and graphed (:func:`served_modes`; the
    graphed runs replay the draft/verify scan, and the gate's bypass):
    1. ``--paged --draft self --draft-k 2``: acceptance exactly 1.0, so
       every step emits k + 1 tokens and the segments and launches are
       fixed: per segment step the draft's two-row first step and its
       one-row second step (flash_decode) on the contiguous draft cache,
       then the target's 3-row verify (flash_decode_paged), each once a
       layer; the prefill wave runs the target's and the draft's prefill
       (flash_attention twice a layer); the multi-row launches are held
       apart (the first draft step and the verify);
    2. a weak draft through the server API: ``DraftSpec`` of qwen1.5-4b's
       config cut to 4 layers with weights from seed 7, k 2, on the
       contiguous layout (decode tiles of 128), 4 requests: its verify rows
       go to flash_decode, launches and multi-row launches held against
       the segment count;
    3. ``--draft self --chunk-len 64 --paged``;
    4. ``--draft self --spec-gate --paged``: the gate's probe, bypass and
       speculate counts printed (they depend on timing).
    Every stream held bitwise equal to the whole-prompt served streams and
    to one-shot generate of its prompt alone (batch 1)."""
    from repro_torch.core import DeviceGroup
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.models.params import materialize
    from repro_torch.serve import DraftSpec, InferenceServer, make_generate

    served_whole, ones = whole
    k = SPEC_K
    argv = SERVER_ARGV + ["--draft", "self", "--draft-k", str(k)]
    args = serve.parse_args(argv)
    cfg, api, params = serve.load_model(args)
    n = cfg.n_layers
    out = {}

    def held(label, result, refs):
        eq_whole = _streams_equal(result, served_whole[:len(refs)])
        eq_one = _streams_equal(result, refs)
        if eq_whole != len(refs) or eq_one != len(refs):
            fail(f"{label}: {eq_whole}/{len(refs)} streams equal the whole-prompt served "
                 f"streams, {eq_one}/{len(refs)} one-shot generate of each prompt alone")
        return eq_whole, eq_one

    # 1. Self-draft on the paged pool.
    runs = served_modes(lambda graph: serve.run_server(cfg, api, params, args, graph=graph),
                        torch, multi_row=True)
    for mode, (result, counts, _, _) in runs.items():
        s = result["stats"]
        steps = args.seg_len * s["segments"]
        segs = -(-(args.gen - 1) // (args.seg_len * (k + 1)))
        want = _launches(n, fa=2 * n * s["prefill_waves"], fd=k * n * steps, fdp=n * steps,
                         forwards=[(2 * s["prefill_waves"] + (k + 1) * steps, n)])
        want["multi_row"] = {"flash_decode": n * steps, "flash_decode_paged": n * steps}
        print(f"  self draft, paged ({mode}): launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"spec served path ({mode}) launch counts {counts} != {want}")
        if s["prefill_waves"] != 1 or s["segments"] != segs:
            fail(f"spec served path ({mode}) ran {s['prefill_waves']} prefill waves and "
                 f"{s['segments']} segments, want 1 and {segs}")
        if s["acceptance"] != 1.0 or not s["tokens_accepted"] == s["tokens_drafted"] > 0:
            fail(f"self draft ({mode}): acceptance {s['acceptance']} ({s['tokens_accepted']}/"
                 f"{s['tokens_drafted']}), want exactly 1.0")
        eq = held(f"self draft, paged ({mode})", result, ones)
    result, counts, _, _ = runs["graph"]
    s = result["stats"]
    ttft = sorted(m["ttft"] for m in result["request_metrics"])
    peak = result["peak_memory_bytes"] or 0
    out["self_draft_paged"] = {
        "k": k, "wall_s": result["wall_s"], "tokens_per_s": result["tokens_per_s"],
        "peak_memory_bytes": result["peak_memory_bytes"], "segments": s["segments"],
        "prefill_waves": s["prefill_waves"], "tokens_drafted": s["tokens_drafted"],
        "tokens_accepted": s["tokens_accepted"], "acceptance": s["acceptance"],
        "ttft_s": ttft, "streams_equal_whole_served": eq[0],
        "streams_equal_batch1_oneshot": eq[1], "launches": counts,
        "plain_served": {key: plain_sp[key] for key in ("tokens_per_s", "wall_s",
                                                         "peak_memory_bytes", "ttft_s")},
        "modes": {m: r[3] for m, r in runs.items()}}
    print(f"  self draft, paged (graphed): acceptance {s['acceptance']} ({s['tokens_accepted']}/"
          f"{s['tokens_drafted']}), {s['segments']} segments; {result['tokens_per_s']:.1f} "
          f"tokens/s, {result['wall_s']:.3f} s, TTFT s {[round(t, 3) for t in ttft]}, peak "
          f"{peak / 2**30:.2f} GiB; whole-prompt served, graphed (this call): "
          f"{plain_sp['tokens_per_s']:.1f} tokens/s, {plain_sp['wall_s']:.3f} s, TTFT s "
          f"{[round(t, 3) for t in plain_sp['ttft_s']]}, peak "
          f"{(plain_sp['peak_memory_bytes'] or 0) / 2**30:.2f} GiB; streams == whole-prompt "
          f"served {eq[0]}/{len(ones)}, == batch-1 one-shot {eq[1]}/{len(ones)} (held, "
          f"bitwise, eager and graphed)", flush=True)
    print_modes("self draft k 2, paged", out["self_draft_paged"]["modes"])

    # 2. A weak draft through the server API, contiguous, 4 requests.
    ccfg = dataclasses.replace(cfg, decode_block=0)
    capi = get_model(ccfg)
    dcfg = dataclasses.replace(ccfg, n_layers=4)
    dapi = get_model(dcfg)
    dparams = materialize(dapi.param_spec(dcfg), torch.Generator(device=dev).manual_seed(7),
                          torch.float32, dev)
    prompts = result["prompts"][:4]
    generate = make_generate(ccfg, capi)
    refs = [generate(params, {"tokens": torch.from_numpy(p[None]).to(dev)}, args.gen)[0]
            .cpu().numpy() for p in prompts]

    def weak(graph):
        srv = InferenceServer(ccfg, capi, params, groups=[DeviceGroup("serve:0", device=dev)],
                              buckets=(args.prompt_len,), max_batch=args.max_batch,
                              seg_len=args.seg_len, max_new_cap=args.gen,
                              max_wait_ms=args.max_wait_ms,
                              draft=DraftSpec(dcfg, dparams, k=k), graph=graph)
        t0 = time.perf_counter()
        with srv:
            hs = []
            for p in prompts:
                time.sleep(1e-3)
                hs.append(srv.submit(p, args.gen))
            res = [h.result(timeout=600) for h in hs]
            wall = time.perf_counter() - t0
        return {"results": res, "stats": srv.stats(), "wall_s": wall,
                "request_metrics": [h.metrics for h in hs]}

    runs = served_modes(weak, torch, multi_row=True)
    for mode, (result, counts, _, _) in runs.items():
        s = result["stats"]
        steps, waves = args.seg_len * s["segments"], s["prefill_waves"]
        want = _launches(n, fa=(n + 4) * waves, fd=(k - 1) * 4 * steps + (n + 4) * steps,
                         forwards=[(waves + steps, n), (waves + k * steps, 4)])
        want["multi_row"] = {"flash_decode": (n + 4) * steps, "flash_decode_paged": 0}
        print(f"  weak draft, contiguous ({mode}): launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"weak-draft served path ({mode}) launch counts {counts} != {want}")
        eq_one = _streams_equal(result, refs)
        if eq_one != len(refs):
            fail(f"weak draft ({mode}): {eq_one}/{len(refs)} streams equal one-shot generate")
    result, counts, _, _ = runs["graph"]
    s = result["stats"]
    out["weak_draft_contiguous"] = {
        "requests": len(prompts), "draft_layers": 4, "k": k, "segments": s["segments"],
        "prefill_waves": s["prefill_waves"], "acceptance": s["acceptance"],
        "tokens_drafted": s["tokens_drafted"], "tokens_accepted": s["tokens_accepted"],
        "wall_s": result["wall_s"], "streams_equal_batch1_oneshot": len(refs),
        "launches": counts, "modes": {m: r[3] for m, r in runs.items()}}
    print(f"  weak draft (4 layers, seed 7), contiguous (graphed): acceptance "
          f"{s['acceptance']:.3f} ({s['tokens_accepted']}/{s['tokens_drafted']}), "
          f"{s['segments']} segments, {result['wall_s']:.3f} s; streams == batch-1 one-shot "
          f"{len(refs)}/{len(refs)} (held, bitwise, eager and graphed)", flush=True)
    print_modes("weak 4-layer draft, contiguous, 4 requests", out["weak_draft_contiguous"]["modes"])

    # 3. Self draft with chunked prefill, paged.
    args_c = serve.parse_args(argv + ["--chunk-len", str(CHUNK_LEN)])
    runs = served_modes(lambda graph: serve.run_server(cfg, api, params, args_c, graph=graph),
                        torch, multi_row=True)
    for mode, (result, _, _, _) in runs.items():
        eq = held(f"self draft, chunked, paged ({mode})", result, ones)
    result, counts, _, _ = runs["graph"]
    s = result["stats"]
    out["self_draft_chunked_paged"] = {
        "chunk_len": CHUNK_LEN, "segments": s["segments"], "chunk_stages":
        result.get("chunk_stages"), "acceptance": s["acceptance"],
        "wall_s": result["wall_s"], "tokens_per_s": result["tokens_per_s"],
        "streams_equal_whole_served": eq[0], "streams_equal_batch1_oneshot": eq[1],
        "launches": counts, "modes": {m: r[3] for m, r in runs.items()}}
    print(f"  self draft, chunks of {CHUNK_LEN}, paged (graphed): {s['segments']} segments "
          f"({result.get('chunk_stages')} with a chunk stage), acceptance "
          f"{s['acceptance']:.3f}, {result['tokens_per_s']:.1f} tokens/s; launches {counts}; "
          f"streams == whole-prompt served {eq[0]}/{len(ones)}, == batch-1 one-shot "
          f"{eq[1]}/{len(ones)} (held, bitwise, eager and graphed)", flush=True)
    print_modes(f"self draft, chunks of {CHUNK_LEN}", out["self_draft_chunked_paged"]["modes"])

    # 4. The gate.
    args_g = serve.parse_args(argv + ["--spec-gate"])
    runs = served_modes(lambda graph: serve.run_server(cfg, api, params, args_g, graph=graph),
                        torch)
    for mode, (result, _, _, _) in runs.items():
        eq = held(f"self draft, gated, paged ({mode})", result, ones)
        g = result["stats"]["speculation"]
        print(f"  spec gate ({mode}): {g['speculated_segments']} spec / "
              f"{g['bypassed_segments']} plain segments, {g['probes']} probes "
              f"(timing-dependent, printed); {result['tokens_per_s']:.1f} tokens/s; streams == "
              f"whole-prompt served {eq[0]}/{len(ones)}, == batch-1 one-shot "
              f"{eq[1]}/{len(ones)} (held, bitwise)", flush=True)
    result, _, _, _ = runs["graph"]
    s = result["stats"]
    g = s["speculation"]
    out["self_draft_gated_paged"] = {
        "probes": g["probes"], "speculated_segments": g["speculated_segments"],
        "bypassed_segments": g["bypassed_segments"], "segments": s["segments"],
        "acceptance": s["acceptance"], "wall_s": result["wall_s"],
        "tokens_per_s": result["tokens_per_s"], "streams_equal_whole_served": eq[0],
        "streams_equal_batch1_oneshot": eq[1], "modes": {m: r[3] for m, r in runs.items()}}
    print_modes("self draft k 2, --spec-gate", out["self_draft_gated_paged"]["modes"])
    spec_counts = out["self_draft_paged"]["launches"]
    return out, spec_counts


# The multi-group served path (run A): the served path's model, prompts,
# lengths and arrivals (1 ms apart) on two CUDA-stream groups of the card,
# pod-a (power 2) and pod-b (power 1), HGuided, pod-b drained after the
# fourth submission.  A lone request boards after 1 ms (the served path
# waits up to 200 ms for a full batch): so the first requests board on both
# groups before the drain, where with the whole batch queued first pod-b,
# drained by then, would receive none.
MULTIGROUP_ARGV = _argv_with(SERVER_ARGV, max_wait_ms="1") + [
    "--groups", "2", "--scheduler", "hguided", "--drain-after", "4", "--verify",
    "--http-port", "0"]
# Run B's slots: pod-a 8, pod-b 4 (Static's 2:1 split of 12, one each at
# least), so the 8 requests leave free slots for the forced migrations.
MULTIGROUP_B_SLOTS = 12


def _http_probe(http, torch) -> dict:
    """``/metrics``, ``/healthz`` and ``/stats`` of a live server's
    ``ObsHTTP`` through urllib (127.0.0.1): status codes, the exposition's
    metric families, the health body and the stats' placement."""
    import urllib.request

    from repro_torch.serve import parse_exposition

    out = {}
    for path in ("/metrics", "/healthz", "/stats"):
        with urllib.request.urlopen(http.url(path), timeout=30) as r:
            body = r.read().decode()
            out[path] = {"status": r.status, "content_type": r.headers["Content-Type"]}
        if path == "/metrics":
            out[path]["families"] = len(parse_exposition(body))
        else:
            out[path]["body"] = json.loads(body)
    return out


def _per_group(result, stats, entries, label, card) -> dict:
    """Each group's numbers of one multi-group run, printed a line a group:
    segments and prefill waves it ran, its segment loops' captures (graph
    entries of its scope) and prefill graphs' captures, the seconds its
    packages waited for another thread's capture, its transfers, the
    migrated rows patched in place and refused, slots migrated in and out,
    and the tokens its segments delivered per second of the run's wall."""
    from collections import Counter

    loops = Counter(k[5][1] for k in entries)
    wall = result["wall_s"]
    ttft = max(m["ttft"] for m in result["request_metrics"])
    out = {}
    for name, d in stats["placement"]["per_group"].items():
        gg = stats["group_graphs"].get(name, {})
        rec = {**d, "loop_captures": loops.get(name, 0),
               "prefill_captures": gg.get("captures", 0),
               "capture_wait_s": result["groups"][name]["capture_wait_s"],
               "transfers": stats["transfers"][name]["transfers"],
               **stats["placement"]["patches"][name],
               "tokens_per_s": d["tokens"] / wall}
        out[name] = rec
        print(f"  [multigroup] {label}, {name}: {rec['segments']} segments, "
              f"{rec['prefill_waves']} prefill waves, {rec['loop_captures']} loop captures + "
              f"{rec['prefill_captures']} prefill graph captures, capture wait "
              f"{rec['capture_wait_s']:.3f} s, {rec['transfers']} transfers, "
              f"{rec['patched']} rows patched in place / {rec['missed']} refused, migrations "
              f"in {rec['migrations_in']} out {rec['migrations_out']}, "
              f"{rec['tokens_per_s']:.1f} tokens/s of its segments; run wall {wall:.3f} s, "
              f"TTFT max {ttft:.3f} s ({card})", flush=True)
    return out


def run_multigroup_paths(dev, torch, whole, card) -> dict:
    """Multi-group serving on two CUDA-stream groups of the card, graphed.

    Run A, the launcher (``run_server``, :data:`MULTIGROUP_ARGV`): paged,
    one sub-batch and one block pool per group, join waves placed by
    ``plan_wave`` on HGuided's weights, pod-b drained after the fourth
    submission (its slots migrate to pod-a at segment boundaries), the
    launcher's ``--verify`` (every stream bitwise one-shot generate of its
    prompt alone).  While the server is still up (every request answered),
    ``ObsHTTP``'s ``/metrics``, ``/healthz`` and ``/stats`` are read through
    urllib, and the launch counts, zeroed just before the run, are read:
    flash_attention n_layers a prefill wave, flash_decode_paged n_layers x
    seg_len a segment of either member, the row kernels a forward each.
    Held: no failure, streams bitwise the single-group served path's and
    batch-1 one-shot's, at least one migration, pod-b drained and reported
    ``ready: false`` by ``/healthz``, each group ran prefill waves, pod-a
    segments, at least one slot left pod-b (drained while its first wave
    is in flight, pod-b decodes nothing: a draining member runs segments
    only while no other member can take its slots), every segment a
    replay, no warm-up clone.

    Run B, ``InferenceServer`` directly: contiguous KV, the same prompts,
    ``ForceMigrate`` (a migration at every common boundary), pod-a and
    pod-b of ``serve.coexec_groups``; the migrated rows go through
    ``DeviceGroup.patch_cached``.  Held as run A, with flash_decode in
    place of flash_decode_paged, and both groups must run segments; patches
    and refusals counted."""
    import numpy as np

    from repro_torch.core import Static
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve import ForceMigrate, InferenceServer

    served_whole, ones = whole
    args = serve.parse_args(MULTIGROUP_ARGV)
    cfg, api, params = serve.load_model(args)
    n, seg = cfg.n_layers, args.seg_len
    out = {"card": card}

    def held(label, result, stats, counts, entries, want, decoders):
        res = result["results"]
        if (stats["completed"] != len(res) or stats["failed"] or stats["rejected"]
                or any(r is None for r in res)):
            fail(f"{label}: {stats['completed']} completed, {stats['failed']} failed, "
                 f"{stats['rejected']} rejected of {len(res)}")
        rows_w = int(sum(np.array_equal(a, b) for a, b in zip(res, served_whole)))
        rows_1 = int(sum(np.array_equal(a, b) for a, b in zip(res, ones)))
        if rows_w != len(res) or rows_1 != len(res):
            fail(f"{label}: {rows_w}/{len(res)} streams equal the single-group served path's, "
                 f"{rows_1}/{len(res)} one-shot generate's of each prompt alone")
        print(f"  {label}: launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"{label} launch counts {counts} != {want}")
        if stats["slot_migrations"] < 1:
            fail(f"{label}: no slot migrated")
        per = stats["placement"]["per_group"]
        if set(per) != {"pod-a", "pod-b"} or any(d["prefill_waves"] < 1 for d in per.values()) \
                or any(per[name]["segments"] < 1 for name in decoders):
            fail(f"{label}: each group must run prefill waves, and {decoders} segments: {per}")
        g = stats["graphs"]
        if g["replays"] != stats["segments"] or g["warmup_clone_bytes"]:
            fail(f"{label}: {stats['segments']} segments, {g['replays']} replays, warm-up clones "
                 f"{g['warmup_clone_bytes']} B: every segment one replay, no clone")
        scopes = {k[5] for k in entries}
        if not ({(args.prompt_len, g) for g in decoders} <= scopes
                <= {(args.prompt_len, "pod-a"), (args.prompt_len, "pod-b")}):
            fail(f"{label}: segment loops' scopes {sorted(scopes)}")
        for name, gg in stats["group_graphs"].items():
            if gg["replays"] != per[name]["prefill_waves"] or gg["warmup_clone_bytes"]:
                fail(f"{label}: group {name} replayed {gg['replays']} prefill graphs for "
                     f"{per[name]['prefill_waves']} waves (warm-up clones "
                     f"{gg['warmup_clone_bytes']} B)")
        print(f"  {label}: {len(res)}/{len(res)} streams bitwise the single-group served "
              f"path's and batch-1 one-shot's; {stats['slot_migrations']} migrations; "
              f"{stats['prefill_waves']} prefill waves, {stats['segments']} segments, all "
              f"replays, warm-up clones 0 B", flush=True)

    # -- run A: the launcher, paged, HGuided, pod-b drained -------------------
    live = {}

    def probe(server, http):
        live["counts"] = ops.launch_counts()
        live["stats"] = server.stats()
        live["entries"] = list(server.kernels.graphs._entries)
        live["http"] = _http_probe(http, torch)

    gc.collect()
    ops.reset_launch_counts()
    ra = serve.run_server(cfg, api, params, args, live=probe)
    sa = live["stats"]
    want = _launches(n, fa=n * sa["prefill_waves"], fdp=n * seg * sa["segments"],
                     forwards=[(sa["prefill_waves"] + seg * sa["segments"], n)])
    # pod-b is drained at the fourth submission, while its first prefill
    # wave (and its capture) is still in flight: its slots leave through the
    # drain's migrations before it decodes, so only pod-a must run segments.
    held("run A (launcher, paged, HGuided, drain)", ra, sa, live["counts"], live["entries"],
         want, ("pod-a",))
    if ra["drained"] != "pod-b" or sa["placement"]["draining"] != ["pod-b"]:
        fail(f"run A: drained {ra['drained']}, draining {sa['placement']['draining']}")
    per_b = sa["placement"]["per_group"]["pod-b"]
    if per_b["migrations_out"] < 1:
        fail(f"run A: no slot left the drained pod-b: {per_b}")
    h = live["http"]
    health = h["/healthz"]["body"]
    if (any(h[p]["status"] != 200 for p in h) or health["status"] != "ok"
            or health["groups"]["pod-b"]["ready"] is not False
            or not health["groups"]["pod-b"]["draining"]
            or health["groups"]["pod-a"]["ready"] is not True
            or h["/metrics"]["families"] < 1
            or h["/stats"]["body"]["slot_migrations"] != sa["slot_migrations"]):
        fail(f"run A: the live endpoints answered {h}")
    print(f"  run A endpoints (ObsHTTP on 127.0.0.1, read live): /metrics "
          f"{h['/metrics']['status']} ({h['/metrics']['families']} metric families), /healthz "
          f"{h['/healthz']['status']} (status {health['status']}, pod-b ready "
          f"{health['groups']['pod-b']['ready']}, draining "
          f"{health['groups']['pod-b']['draining']}), /stats {h['/stats']['status']}",
          flush=True)
    out["run_a"] = {"argv": MULTIGROUP_ARGV, "wall_s": ra["wall_s"],
                    "tokens_per_s": ra["tokens_per_s"],
                    "ttft_s": sorted(m["ttft"] for m in ra["request_metrics"]),
                    "slot_migrations": sa["slot_migrations"], "drained": ra["drained"],
                    "prefill_waves": sa["prefill_waves"], "segments": sa["segments"],
                    "member_slots": sa["placement"]["member_slots"],
                    "launches": live["counts"], "peak_memory_bytes": ra["peak_memory_bytes"],
                    "graphs": {k: sa["graphs"][k] for k in ("captures", "capture_s", "wait_s",
                                                            "replays", "output_copies")},
                    "endpoints": {p: h[p]["status"] for p in h},
                    "per_group": _per_group(ra, sa, live["entries"], "run A", card)}
    del ra, live
    gc.collect()
    torch.cuda.empty_cache()

    # -- run B: the server API, contiguous, ForceMigrate ----------------------
    prompts, gaps = serve.server_prompts(cfg, serve.parse_args(SERVER_ARGV))
    groups = serve.coexec_groups(dev)
    policy = ForceMigrate()
    ops.reset_launch_counts()
    server = InferenceServer(cfg, api, params, groups=groups, scheduler=Static(),
                             group_batches=True, migration=policy, buckets=(args.prompt_len,),
                             max_batch=MULTIGROUP_B_SLOTS, seg_len=seg, max_new_cap=args.gen,
                             max_wait_ms=200.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with server:
        handles = []
        for p, gap in zip(prompts, gaps):
            time.sleep(gap)
            handles.append(server.submit(p, args.gen))
        results = [hd.result(timeout=600) for hd in handles]
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        sb = server.stats()
        entries = list(server.kernels.graphs._entries)
    rb = {"results": results, "wall_s": wall,
          "request_metrics": [hd.metrics for hd in handles],
          "groups": {g.name: {"capture_wait_s": g.capture_wait_s} for g in groups}}
    want = _launches(n, fa=n * sb["prefill_waves"], fd=n * seg * sb["segments"],
                     forwards=[(sb["prefill_waves"] + seg * sb["segments"], n)])
    held("run B (server API, contiguous, ForceMigrate)", rb, sb, counts, entries, want,
         ("pod-a", "pod-b"))
    patches = sb["placement"]["patches"]
    if sum(p["patched"] for p in patches.values()) < 1:
        fail(f"run B: no migrated row went through patch_cached: {patches}")
    out["run_b"] = {"member_slots": sb["placement"]["member_slots"], "wall_s": wall,
                    "tokens_per_s": sb["tokens_out"] / wall,
                    "ttft_s": sorted(m["ttft"] for m in rb["request_metrics"]),
                    "slot_migrations": sb["slot_migrations"],
                    "moves_planned": policy.moves_planned,
                    "prefill_waves": sb["prefill_waves"], "segments": sb["segments"],
                    "launches": counts, "patches": patches,
                    "graphs": {k: sb["graphs"][k] for k in ("captures", "capture_s", "wait_s",
                                                            "replays", "output_copies")},
                    "per_group": _per_group(rb, sb, entries, "run B", card)}
    return out


COEXEC_ARGV = ["--arch", "qwen1.5-4b", "--full", "--coexec", "--scheduler", "hguided",
               "--verify", "--requests", "8", "--prompt-len", "256", "--gen", str(GEN),
               "--seed", "0", "--kernel", "cuda"]


def run_coexec_path(dev, torch, argv=COEXEC_ARGV, one=None, modes=MODES) -> dict:
    """The launcher's co-executed generate (``--coexec --scheduler hguided
    --verify``): the 8 requests cut into HGuided packages over pod-a and
    pod-b, two groups of cuda:0 with a CUDA stream each, every package a
    one-shot generate of its requests, which each group captures whole per
    package shape and replays (``DeviceGroup.compile_kernel``; the capture
    lands in a shape's first package, in the balance too, as the
    reference's compile does).  The launcher asserts its tokens bitwise
    equal to one-shot generate of the batch of 8 (``--verify``).  Then the
    same with the kernel run eagerly (``run_coexec(graph=False)`` marks it
    ``graphs.passthrough``: no group may capture or replay), its tokens
    held bitwise equal to the graphed run's.  Balance is the introspector's
    (earliest over latest group finish), captures and one group's wait for
    the other's capture included; the scheduler's observed service times
    leave that wait out.  Launch counts are
    zeroed just before and read just after each run: every package (and the
    verifying one-shot run) is one generate, so every kernel's count must be
    (packages (+ 1)) times the one-shot path's.  Each group must have run a
    package and, graphed, replayed one graph per package, captured once per
    package shape, with no warm-up clone.  ``argv`` and ``one`` (the
    one-shot path's counts) name another co-executed path, ``modes`` the
    runs it takes (the audio family's frames reach each package as a
    Program input, sliced with its requests)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    if one is None:
        one = served_oneshot_counts()  # qwen1.5-4b's one-shot 8 x 256 + GEN at its cut depth
    args = serve.parse_args(argv)
    out = {"arch": args.arch, "requests": args.requests, "prompt_len": args.prompt_len,
           "gen": args.gen, "scheduler": args.scheduler}
    ops.reset_launch_counts()
    result = serve.main(argv)
    counts = ops.launch_counts()
    if not result.get("verified"):
        fail("co-executed generate was not verified against one-shot generate")
    runs = {"graph": (result, counts, 1)}
    gc.collect()
    if "eager" in modes:
        cfg, api, params = serve.load_model(args)
        batch = serve.load_batch(cfg, args)
        ops.reset_launch_counts()
        eager = serve.run_coexec(cfg, api, params, batch, args, graph=False)
        runs["eager"] = (eager, ops.launch_counts(), 0)
        if not np.array_equal(eager["tokens"], result["tokens"]):
            fail("eager co-executed tokens differ from the graphed (verified) ones")
    for mode in modes:
        res, counts, extra = runs[mode]
        pk = res["packages"]
        n_pk = sum(len(v) for v in pk.values())
        want = {k: v * (n_pk + extra) for k, v in one.items()}
        print(f"  {mode}: launches {counts} (want {want}: {n_pk} packages"
              + (" + the verifying one-shot run" if extra else "") + ", each a generate)",
              flush=True)
        if counts != want:
            fail(f"co-executed path ({mode}) launch counts {counts} != {want}")
        if any(not sizes for sizes in pk.values()):
            fail(f"a group ran no package ({mode}): {pk}")
        graphs = res["graphs"]
        for name, sizes in pk.items():
            g = graphs.get(name)
            shapes = len({serve.DeviceGroup._bucket(n, 1) for n in sizes})
            if mode == "graph" and (g is None or (g["replays"], g["captures"],
                                                  g["warmup_clone_bytes"]) != (len(sizes),
                                                                               shapes, 0)):
                fail(f"co-executed path: group {name} ran packages {sizes} with graph counters "
                     f"{g}: want one replay a package, one capture a package shape, no clone")
            if mode == "eager" and (g is None or g["captures"] or g["replays"]):
                fail(f"co-executed path (eager): group {name} captured or replayed graphs: {g}")
        s = res["summary"]
        out[mode] = {"packages": pk, "balance": s["balance"], "work_share": s["work_share"],
                     "wall_s": res["wall_s"], "tokens_per_s": res["tokens_per_s"],
                     "package_s": res["package_s"], "per_group": s["per_device"],
                     "graphs": graphs}
        print(f"  [coexec] {mode}: packages {pk}; balance {s['balance']:.3f}; work share "
              f"{ {k: round(v, 3) for k, v in s['work_share'].items()} }; wall "
              f"{res['wall_s']:.3f} s ({res['tokens_per_s']:.1f} tokens/s); each package's "
              f"service time in run order (s) "
              f"{ {k: [round(x, 3) for x in v] for k, v in res['package_s'].items()} }"
              + ("".join(f"; {name}: {g['captures']} captures, {g['replays']} replays, capture "
                         f"{loops_line(g['loops'])}" for name, g in graphs.items())
                 if graphs else "") + "; bitwise equal to one-shot generate (held)", flush=True)
    out["verified_bitwise_vs_oneshot"] = True
    return out


def run_listing1(torch) -> dict:
    """The paper's Listing 1 kernel (examples/quickstart_torch.py) on the
    node's real pair: ``discover(DeviceMask.ALL)`` must give one ``cpu``
    and one ``cuda:0`` group, and HGuided(adaptive=True) must give each a
    package, with the output right.  No simulated speeds."""
    import importlib.util

    from repro_torch.core import DeviceMask, discover

    groups = discover(DeviceMask.ALL)
    names = [g.name for g in groups]
    if names != ["cpu:0", "cuda:0"]:
        fail(f"discover(DeviceMask.ALL) gave {names}, want ['cpu:0', 'cuda:0']")
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    n = 1 << 24
    res = qs.listing1(groups, n=n)
    s = res["summary"]
    per = s["per_device"]
    if not res["correct"]:
        fail("Listing 1 on cpu + cuda:0: wrong output")
    if any(per.get(g, {}).get("packages", 0) < 1 for g in names):
        fail(f"Listing 1: a group ran no package: {per}")
    out = {"groups": names, "work_items": n, "n_packages": s["n_packages"],
           "balance": s["balance"], "work_share": s["work_share"],
           "response_time_s": s["response_time"],
           "packages": {g: per[g]["packages"] for g in names}}
    print(f"  groups {names}; {s['n_packages']} packages {out['packages']}; balance "
          f"{s['balance']:.3f}; work share "
          f"{ {k: round(v, 3) for k, v in s['work_share'].items()} }; "
          f"{s['response_time'] * 1e3:.1f} ms; correct (held)", flush=True)
    return out


def print_graph_summary(summary, card) -> None:
    """The ``[graph]`` phase's table: each main path's decode (8 steps,
    profiler on) and one-shot generate, and each served path, eager beside
    graphed, all from this run; then the same as a JSON line."""
    import statistics

    print(at() + f" [graph] eager beside graphed decode, this run ({card})", flush=True)
    for r in summary["main_paths"]:
        print(f"  {r['path']}: prefill busy / wall eager {r['prefill_device_busy_ms_eager']:.1f} / "
              f"{r['prefill_wall_ms_eager']:.1f} ms, graphed {r['prefill_device_busy_ms_graph']:.1f}"
              f" / {r['prefill_wall_ms_graph']:.1f} ms; decode 8 steps busy / wall eager "
              f"{r['decode_8_device_busy_ms_eager']:.1f} / {r['decode_8_wall_ms_eager']:.1f} ms, "
              f"graphed {r['decode_8_device_busy_ms_graph']:.1f} / "
              f"{r['decode_8_wall_ms_graph']:.1f} ms; one-shot tokens/s (second call) eager "
              f"{r['tokens_per_s_eager']:.1f}, graphed {r['tokens_per_s_graph']:.1f}; capture "
              f"{r['capture_s']:.3f} s", flush=True)

    def median(xs):
        return f"{statistics.median(xs):.1f}" if xs else "none"
    for label, modes in summary["served_paths"]:
        e, g = modes["eager"], modes["graph"]
        print(f"  {label}: tokens/s eager {e['tokens_per_s']:.1f}, graphed {g['tokens_per_s']:.1f};"
              f" wall {e['wall_s']:.3f} / {g['wall_s']:.3f} s; TTFT max {e['ttft_s'][-1]:.3f} / "
              f"{g['ttft_s'][-1]:.3f} s; host dispatch per segment, median eager "
              f"{median(e['dispatch_ms'])} ms, graphed after the first "
              f"{median(g['dispatch_ms'][1:])} ms (first, with the capture: "
              f"{median(g['dispatch_ms'][:1])}; upload in it, median after the first "
              f"{median(g['upload_ms'][1:])}); write-back median {median(e['write_back_ms'])} / "
              f"{median(g['write_back_ms'])} ms; epilogue median {median(e['epilogue_ms'])} / "
              f"{median(g['epilogue_ms'])} ms", flush=True)
    c = summary["coexec"]
    print(f"  co-execution, qwen1.5-4b 8 x 256 + {GEN}, HGuided over pod-a and pod-b: tokens/s "
          f"eager {c['eager']['tokens_per_s']:.1f}, graphed {c['graph']['tokens_per_s']:.1f} "
          f"(captures included); balance {c['eager']['balance']:.3f} / "
          f"{c['graph']['balance']:.3f}", flush=True)
    print(json.dumps({"graph": {"main_paths": summary["main_paths"],
                                "served_paths": dict(summary["served_paths"]),
                                "coexec": c}}))


# ------------------------------------------------------------------ MoE
# The MoE paths: (arch, depth) at full width, the depth cut so the weights
# fit one card in bf16 (arctic-480b's two layers hold about 55.4 GB,
# kimi-k2-1t-a32b's one about 38.8 GB).  Only arctic serves.
MOE_PATHS = (("arctic-480b", 2), ("kimi-k2-1t-a32b", 1))
# moe_gemm replaces no pallas_call: the reference's expert einsums.
MOE_REPLACES = "src/repro/models/moe.py:112"


def moe_model(arch, depth, dev, torch):
    """(cfg, api, bf16 params on the card, seconds to draw them): the
    published config cut to ``depth`` layers, weights from seed 0, drawn
    in bf16 (the launcher's float32 masters would not fit)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.params import materialize

    cfg = dataclasses.replace(get_config(arch), n_layers=depth, kernel_impl="cuda")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = materialize(api.param_spec(cfg), torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    return cfg, api, params, time.perf_counter() - t0


def moe_route(cfg, tokens, dev, torch, seed):
    """A random top-k routing of ``tokens`` tokens, as ``models.moe``
    dispatches it at the call's capacity: (C, rows, count)."""
    from repro_torch.models import moe

    E, K = cfg.n_experts, cfg.top_k
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = moe.top_k(torch.randn(tokens, E, generator=g, device=dev), K)[1].reshape(-1)
    C = moe.capacity(tokens, cfg)
    _, _, rows, count = moe.dispatch(ids, torch.ones(ids.shape, dtype=torch.bfloat16, device=dev),
                                     torch.arange(ids.numel(), device=dev) // K, E, C)
    return C, rows, count


def run_moe_gemm_case(cfg, ex, tokens, fused, dev, flush, torch) -> dict:
    """``moe_gemm`` against ``moe_gemm_plain`` (the reference's dense
    einsum over the whole capacity buffer) on layer 0's expert weights, at
    a random routing of ``tokens`` tokens: gate and up fused over the
    token rows through the row map, or down over the buffer.  bf16, rel.
    L2 within 2e-2.  Timed beside ``torch.bmm`` over the whole capacity
    buffer (the reference's function as written; two calls for gate and
    up) and a ``torch.matmul`` loop over the filled experts, counts read
    on the host.  Bound: the weights of the experts that hold rows, the
    filled rows of A read once and the whole output written once, against
    2 x rows x K x N operations a product."""
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops

    C, rows, count = moe_route(cfg, tokens, dev, torch, 7 + tokens + fused)
    g = torch.Generator(device=dev).manual_seed(tokens)
    if fused:
        w, wu = ex["w_gate"], ex["w_up"]
        x = torch.randn(tokens, cfg.d_model, generator=g, device=dev).bfloat16()
        args, buf = (x, w, count, rows, wu), mg.capacity_buffer(x, count, rows)
    else:
        w, wu = ex["w_down"], None
        buf = mg.capacity_buffer(torch.randn(tokens, cfg.d_ff, generator=g, device=dev)
                                 .bfloat16(), count, rows)
        args = (buf, w, count)
    E, K, N = w.shape
    p = mg.plan(E, C, K, N, fused, torch.cuda.get_device_properties(dev).multi_processor_count)
    got = ops.moe_gemm(*args)
    torch.cuda.synchronize()
    want = mg.moe_gemm_plain(*args)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    err = (got.float() - want.float()).abs().max().item()
    name = (f"{cfg.name} {'decode' if tokens <= 8 else 'prefill'} "
            f"{'gate/up fused' if fused else 'down'}")
    if not torch.isfinite(got).all() or rel > BF16_TOL:
        fail(f"moe_gemm {name}: rel L2 {rel} > {BF16_TOL}")
    iters = 20 if tokens <= 8 else 5
    ms = time_ms(lambda: ops.moe_gemm(*args), flush, iters)
    plain_ms = time_ms(lambda: mg.moe_gemm_plain(*args), flush, iters)
    bmm_ms = time_ms(lambda: [torch.bmm(buf, t) for t in (w, wu) if t is not None], flush, iters)
    live = [(e, c) for e, c in enumerate(count.tolist()) if c]

    def loop():
        counts = count.tolist()  # the host read a graph could not capture
        for e, c in enumerate(counts):
            if c:
                for t in (w, wu):
                    if t is not None:
                        torch.matmul(buf[e, :c], t[e])
    loop_ms = time_ms(loop, flush, iters)
    nw = 2 if fused else 1
    filled = sum(c for _, c in live)
    nbytes = 2 * (nw * len(live) * K * N + filled * K + E * C * N)
    flops = 2 * nw * filled * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=bmm_ms,
               library_loop_ms=loop_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               plan=p.describe())
    print(f"  moe_gemm | {name} (E {E}, C {C}, K {K}, N {N}; {len(live)} experts hold "
          f"{filled} rows), plan {p.describe()}: rel L2 {rel:.3g}, max_abs_err={err:.3g}; "
          f"kernel={ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s of "
          f"{HBM_BYTES_PER_S / 1e12:.2f}, {rec['bound_ms'] / ms:.0%} of the bound) "
          f"plain={plain_ms:.4f} ms torch.bmm over the buffer{' x2' if fused else ''}="
          f"{bmm_ms:.4f} ms torch.matmul loop over the filled experts={loop_ms:.4f} ms "
          f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
    return rec


def moe_row_contract(cfg, ex, dev, torch) -> None:
    """Held bitwise: a routed row of ``moe_gemm`` (gate/up fused, and
    down) gives the same bits with 1, 3 and 8 rows in its expert at C 8,
    and with 8 and 48 rows at C 48, other experts filled beside it; every
    row past an expert's count is zero (the store loop and the
    epilogue); and the down row equals ``gemm_rowinv``'s product of the
    same row and expert (the same k16 chain).  The fused row against
    PyTorch's silu(gemm_rowinv) * gemm_rowinv is printed."""
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops

    E = cfg.n_experts
    e0 = min(5, E - 2)  # the expert whose row is held; the last one filled beside it
    g = torch.Generator(device=dev).manual_seed(11)
    xs = {True: torch.randn(48, cfg.d_model, generator=g, device=dev).bfloat16(),
          False: torch.randn(48, cfg.d_ff, generator=g, device=dev).bfloat16()}
    x1 = xs[True][:1]
    fused_as_torch = torch.nn.functional.silu(ops.linear(x1, ex["w_gate"][e0])) * ops.linear(
        x1, ex["w_up"][e0])
    down_as_gemm = ops.linear(xs[False][:1], ex["w_down"][e0])
    same_fused = []
    for fused in (True, False):
        x, first = xs[fused], None
        for n, C in ((1, 8), (3, 8), (8, 8), (8, 48), (48, 48)):
            rows = torch.full((E, C), -1, dtype=torch.int32, device=dev)
            rows[e0, :n] = torch.arange(n, dtype=torch.int32, device=dev)
            rows[E - 1, :min(n, 4)] = torch.arange(min(n, 4), dtype=torch.int32, device=dev) + 3
            count = (rows >= 0).sum(1).to(torch.int32)
            past = torch.arange(C, device=dev)[None, :] >= count[:, None]
            if fused:
                y = ops.moe_gemm(x, ex["w_gate"], count, rows, ex["w_up"])
            else:
                y = ops.moe_gemm(mg.capacity_buffer(x, count, rows), ex["w_down"], count)
            torch.cuda.synchronize()
            first = y[e0, 0].clone() if first is None else first
            if not torch.equal(y[e0, 0], first) or not (y[past] == 0).all():
                fail(f"moe_gemm row contract ({'gate/up' if fused else 'down'}): row 0 of "
                     f"expert {e0} with {n} rows at C {C} differs from its bits with 1 row at "
                     f"C 8, or a row past its expert's count is not zero")
            if fused:
                same_fused.append(bool(torch.equal(y[e0, 0], fused_as_torch[0])))
            elif not torch.equal(y[e0, 0], down_as_gemm[0]):
                fail(f"moe_gemm row contract (down): row 0 of expert {e0} with {n} rows at "
                     f"C {C} differs from gemm_rowinv's product of it")
    print(f"  moe_gemm rows bitwise equal at 1, 3, 8 rows (C 8) and 8, 48 rows (C 48), "
          f"gate/up and down, rows past the counts zero, the down row equal to gemm_rowinv's "
          f"product (held); the gate/up row equal to silu(gemm_rowinv) * gemm_rowinv in "
          f"PyTorch: {sum(same_fused)}/{len(same_fused)} (printed)", flush=True)


def moe_drops(cfg, api, params, tokens, dev, torch) -> list:
    """Assignments each layer of an eager prefill of ``tokens`` drops."""
    from repro_torch.models import moe
    from repro_torch.serve import make_prefill_step, zeros_cache

    b, s = tokens.shape
    with moe.dropped_assignments() as drops:
        make_prefill_step(cfg, api)(params, {"tokens": tokens},
                                    zeros_cache(cfg, api, b, s + 1, device=dev))
    return [int(d) for d in drops]


def run_moe_path(arch, depth, dev, torch) -> dict:
    """One MoE arch at full width and cut depth: the ``[moe kernel]``
    cases and the row contract on its layer-0 experts, then the
    launcher's one-shot generate (``run_oneshot_main``, graphed) of 8 x 256
    + 32 with exact launch counts and the per-layer reference check of the
    prefill and the first decode step; for arctic also one-shot generate
    eager beside graphed, the ``[B7]`` profile and the paged server."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import gemm, ops
    from repro_torch.launch import serve
    from repro_torch.models.params import tree_leaves, tree_map

    cfg, api, params, draw_s = moe_model(arch, depth, dev, torch)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"  {cfg.name}, {depth} of {get_config(arch).n_layers} layers, bf16 weights "
          f"{nbytes / 1e9:.1f} GB ({nbytes / 2**30:.1f} GiB) drawn in {draw_s:.1f} s", flush=True)
    ex = tree_map(lambda a: a[0], params["layers"])["experts"]
    print(at() + f" [moe kernel] moe_gemm against its plain version on {arch}'s layer-0 experts",
          flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    recs = {(t, f): run_moe_gemm_case(cfg, ex, t, f, dev, flush, torch)
            for t in (8, 8 * 256) for f in (True, False)}
    moe_row_contract(cfg, ex, dev, torch)
    del ex, flush
    argv = ["--arch", arch, "--full", "--requests", "8", "--prompt-len", "256", "--gen",
            str(GEN), "--seed", "0", "--kernel", "cuda"]
    args = serve.parse_args(argv)
    print(at() + f" [moe path] the launcher's one-shot generate (run_oneshot_main, graphed), "
          f"{arch} at depth {depth}, {args.requests} x {args.prompt_len} + {args.gen}", flush=True)
    maps = gemm.maps_encoded()
    ops.reset_launch_counts()
    result = serve.run_oneshot_main(cfg, api, params, args)
    counts = ops.launch_counts()
    maps = gemm.maps_encoded() - maps
    want = {"flash_attention": depth, "flash_decode": depth * (GEN - 1), "flash_decode_paged": 0,
            "ssm_scan": 0, "rglru_scan": 0, **row_kernel_launches(arch, GEN, depth)}
    print(f"  launches {counts} (want {want})", flush=True)
    if counts != want:
        fail(f"{arch} launch counts {counts} != {want}")
    toks = result["tokens"]
    if toks.shape != (args.requests, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{arch}: tokens of shape {toks.shape} in [{toks.min()}, {toks.max()}]")
    batch = serve.load_batch(cfg, args)
    lk = prefill_logits(cfg, params, batch, GEN, dev)
    lr = prefill_logits(dataclasses.replace(cfg, kernel_impl="reference"), params, batch, GEN, dev)
    if not (torch.isfinite(lk).all() and torch.isfinite(lr).all()):
        fail(f"{arch}: non-finite first-token logits")
    first_ok = bool((lk.argmax(-1)[:, 0].int().cpu().numpy() == toks[:, 0]).all())
    if not first_ok:
        fail(f"{arch}: generate's first token is not the argmax of its prefill logits")
    drops = moe_drops(cfg, api, params, batch["tokens"], dev, torch)
    errs = layer_errors(cfg, params, batch, dev, torch, ("prefill", "decode"))
    rounded = {m: errs.pop(m + "_rounded") for m in ("prefill", "decode")}
    for mode, e in errs.items():
        print(f"  per-layer bf16 {mode} update before the residual add, kernel vs reference: "
              f"{[round(x, 5) for x in e]} (tol {LAYER_REL_TOL}); rounded update y - x "
              f"(printed): {[round(x, 5) for x in rounded[mode]]}", flush=True)
        if max(e) > LAYER_REL_TOL:
            fail(f"{arch}: a bf16 {mode} layer through the kernels disagrees with the reference")
    rel = float((lk - lr).norm() / lr.norm())
    print(f"  first-token logits kernel vs reference rel L2 {rel:.3g} (printed); first token = "
          f"argmax of the prefill (held); assignments dropped by the prefill of 8 x "
          f"{args.prompt_len}, per layer: {drops} of {8 * args.prompt_len * cfg.top_k}; "
          f"{result['tokens_per_s']:.1f} tokens/s graphed, capture {result['capture_s']:.3f} s, "
          f"peak {(result['peak_memory_bytes'] or 0) / 2**30:.2f} GiB, TMA maps encoded {maps}",
          flush=True)
    out = {"arch": arch, "layers": depth, "weights_bytes": nbytes, "draw_s": draw_s,
           "counts": counts, "tokens_per_s": result["tokens_per_s"], "wall_s": result["wall_s"],
           "capture_s": result["capture_s"], "peak_memory_bytes": result["peak_memory_bytes"],
           "prefill_drops_per_layer": drops, "logits_rel_l2_bf16": rel,
           "gemm_tma_maps_encoded": maps,
           **{f"layer_rel_l2_bf16_{m}": e for m, e in errs.items()},
           "moe_gemm": {f"{'decode' if t <= 8 else 'prefill'} {'gate/up' if f else 'down'}": r
                        for (t, f), r in recs.items()}}
    if arch == "arctic-480b":
        from repro_torch.serve import make_generate

        ops.reset_launch_counts()
        eager = make_generate(cfg, api, graph=False)(params, batch, GEN).cpu().numpy()
        eager_counts = ops.launch_counts()
        print(f"  eager one-shot generate: launches {eager_counts} (held equal to the graphed "
              f"run's), tokens bitwise the graphed run's: {bool((eager == toks).all())} (held)",
              flush=True)
        if eager_counts != want or not (eager == toks).all():
            fail(f"{arch}: eager one-shot generate launched {eager_counts} or gave other tokens")
        out["oneshot_modes"] = oneshot_modes(cfg, api, params, batch, GEN, toks, torch)
        out["profile"] = profile_steps(cfg, params, batch, dev, torch)
        out["served"] = run_moe_served(cfg, api, params, dev, torch)
    return out, counts, recs[(8, False)]


def run_moe_served(cfg, api, params, dev, torch) -> dict:
    """The launcher's paged server (``run_server``) on the MoE path's
    weights, 8 x 256 + 32, blocks of 16, segments of 8, 8 slots, arrivals
    1 ms apart and a 200 ms wait, so that the 8 prompts board in one wave:
    eager and graphed (:func:`served_modes`), launch counts exact, every
    stream bitwise one-shot generate of the same 8 prompts as one batch
    (capacity is the wave's, as one-shot's).  Beside it, printed and held
    only where neither side's prefill dropped an assignment: each stream
    against one-shot generate of its prompt alone (batch 1, capacity 8)."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serve import make_generate

    args = serve.parse_args(_argv_with(SERVER_ARGV, arch=cfg.name))
    scfg = dataclasses.replace(cfg, decode_block=args.block_len)
    print(at() + f" [moe served path] run_server --paged, {cfg.name} at depth {cfg.n_layers}, "
          f"8 x 256 + {GEN}, block_len 16, seg_len 8, max_batch 8", flush=True)
    run = lambda graph: serve.run_server(scfg, api, params, args, graph=graph)  # noqa: E731
    runs = served_modes(run, torch)
    n = cfg.n_layers
    segs = -(-(args.gen - 1) // args.seg_len)
    want = _launches(n, fa=n, fdp=n * args.seg_len * segs,
                     forwards=[(1 + args.seg_len * segs, n)], arch=cfg.name)
    prompts = runs["eager"][0]["prompts"]
    tokens = torch.from_numpy(np.stack(prompts)).to(dev)
    generate = make_generate(scfg, api)
    one8 = generate(params, {"tokens": tokens}, args.gen).cpu().numpy()
    ones = [generate(params, {"tokens": tokens[i:i + 1]}, args.gen)[0].cpu().numpy()
            for i in range(args.requests)]
    drops8 = moe_drops(scfg, api, params, tokens, dev, torch)
    drops1 = [moe_drops(scfg, api, params, tokens[i:i + 1], dev, torch)
              for i in range(args.requests)]
    for mode, (result, counts, _, rec) in runs.items():
        s = result["stats"]
        print(f"  {mode}: launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"MoE served path ({mode}) launch counts {counts} != {want}")
        if s["prefill_waves"] != 1 or s["segments"] != segs:
            fail(f"MoE served path ({mode}) ran {s['prefill_waves']} prefill waves and "
                 f"{s['segments']} segments, want 1 (all 8 prompts in one wave) and {segs}")
        eq8 = _streams_equal(result, one8)
        eq1 = [bool(np.array_equal(a, b)) for a, b in zip(result["results"], ones)]
        must = [i for i in range(args.requests) if not any(drops8) and not any(drops1[i])]
        print(f"  {mode}: served == one-shot of the same 8 prompts as one batch: "
              f"{eq8}/{args.requests} (held); == one-shot of each prompt alone: {sum(eq1)}/"
              f"{args.requests} {eq1} (held where no prefill dropped: prompts {must}); "
              f"assignments dropped per layer by the batch-8 prefill {drops8}, by each batch-1 "
              f"prefill {drops1}", flush=True)
        if eq8 != args.requests or not all(eq1[i] for i in must):
            fail(f"MoE served path ({mode}): streams differ from one-shot generate")
    print_modes(f"{cfg.name} served, arrivals 1 ms apart", {m: r[3] for m, r in runs.items()})
    result = runs["graph"][0]
    return {"modes": {m: r[3] for m, r in runs.items()}, "counts": runs["graph"][1],
            "streams_equal_batch8_oneshot": args.requests,
            "streams_equal_batch1_oneshot": [bool(np.array_equal(a, b)) for a, b in
                                             zip(result["results"], ones)],
            "prefill_drops_batch8": drops8, "prefill_drops_batch1": drops1,
            "tokens_per_s": result["tokens_per_s"], "wall_s": result["wall_s"]}


# --------------------------------------------------------------- [examples]
def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module (its ``main``
    not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_runtime_examples(dev) -> dict:
    """pipeline_dataflow, async_coexec and nbody_coexec at their own sizes,
    every check of theirs a failure here."""
    out = {}
    t = time.perf_counter()
    pl = load_example("pipeline_dataflow_torch").pipeline(dev)
    if not (pl["deps"] == [0, 1, 1] and pl["correct"] and pl["iter_correct"]
            and pl["transfer_stats"]["transfers"] == 1):
        fail(f"pipeline_dataflow_torch: deps {pl['deps']}, correct {pl['correct']}, iterative "
             f"{pl['iter_correct']}, transfers {pl['transfer_stats']} (want [0, 1, 1], one)")
    out["pipeline_dataflow"] = {"deps": pl["deps"], "transfer_stats": pl["transfer_stats"],
                                "iter_stats": pl["iter_stats"],
                                "seconds": time.perf_counter() - t}
    print(f"  pipeline_dataflow: deps {pl['deps']}, chain {pl['transfer_stats']}, iterative "
          f"{pl['iter_stats']}; correct (held); {out['pipeline_dataflow']['seconds']:.2f} s",
          flush=True)
    t = time.perf_counter()
    ac = load_example("async_coexec_torch").async_coexec(dev)
    hits = {k: v["cache_hits"] for k, v in ac["transfer_stats"].items()}
    if not (ac["p1_correct"] and ac["p2_correct"] and ac["iter_correct"]
            and all(hits.values())):
        fail(f"async_coexec_torch: p1 {ac['p1_correct']}, p2 {ac['p2_correct']}, iterative "
             f"{ac['iter_correct']}, cache hits {hits}")
    out["async_coexec"] = {"packages": [ac["p1_packages"], ac["p2_packages"]],
                           "transfer_stats": ac["transfer_stats"],
                           "seconds": time.perf_counter() - t}
    print(f"  async_coexec: packages {out['async_coexec']['packages']}, "
          f"{ac['transfer_stats']}; correct (held); {out['async_coexec']['seconds']:.2f} s",
          flush=True)
    t = time.perf_counter()
    nb = load_example("nbody_coexec_torch").nbody(dev)
    s = nb["summary"]
    if not (nb["pos_correct"] and nb["vel_correct"] and nb["iter_correct"]):
        fail(f"nbody_coexec_torch: pos {nb['pos_correct']}, vel {nb['vel_correct']}, iterative "
             f"{nb['iter_correct']} (atol 1e-3 against the kernel on the CPU)")
    if sorted(k for k, v in s["work_share"].items() if v > 0) != ["cpu", "gpu", "phi"]:
        fail(f"nbody_coexec_torch: a group ran no package: {s['work_share']}")
    out["nbody_coexec"] = {"balance": s["balance"], "work_share": s["work_share"],
                           "transfer_stats": nb["transfer_stats"],
                           "seconds": time.perf_counter() - t}
    print(f"  nbody_coexec: balance {s['balance']:.3f}, share "
          f"{ {k: round(v, 3) for k, v in s['work_share'].items()} }, {nb['transfer_stats']}; "
          f"correct (held); {out['nbody_coexec']['seconds']:.2f} s", flush=True)
    return out


def run_continuous_batching_example(dev, torch) -> dict:
    """continuous_batching at qwen1.5-4b full width, ``SERVED_DEPTH``
    layers: the example holds every stream bitwise one-shot generate of its
    prompt alone.  Launch counts are zeroed just before and read just after
    the server's run, and held to what its prefill waves and segments make
    (one stack forward each wave and each segment step: flash_attention a
    layer a wave, flash_decode a layer a step), and likewise around the 12
    one-shot runs, held to 12 x one generate's."""
    import numpy as np

    from repro_torch.kernels import ops

    t = time.perf_counter()
    cb = load_example("continuous_batching_torch")
    cfg, api, params, layers = cb.model(True, SERVED_DEPTH, dev)
    runs = {}

    @contextlib.contextmanager
    def around(name):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        yield
        torch.cuda.synchronize()
        runs[name] = ops.launch_counts()

    try:
        res = cb.continuous_batching(cfg, api, params, dev, around=around)
    except AssertionError as e:
        fail(f"continuous_batching_torch: a stream differs from one-shot generate: {e}")
    if not all(np.array_equal(a, b) for a, b in zip(res["results"], res["oneshot"])):
        fail("continuous_batching_torch: a stream differs from one-shot generate")
    st, lat, n = res["stats"], res["latency"], cfg.n_layers
    steps = cb.SEG_LEN * st["segments"]
    want = {"server": _launches(n, fa=n * st["prefill_waves"], fd=n * steps,
                                forwards=[(st["prefill_waves"] + steps, n)]),
            "one-shot": {k: v * len(res["prompts"]) for k, v in _launches(
                n, fa=n, fd=n * (cb.GEN - 1), forwards=[(cb.GEN, n)]).items()}}
    for name, w in want.items():
        if runs[name] != w:
            fail(f"continuous_batching_torch ({name}): launches {runs[name]} != {w} "
                 f"({st['prefill_waves']} prefill waves, {st['segments']} segments of "
                 f"{cb.SEG_LEN} steps; {len(res['prompts'])} one-shot generates of "
                 f"{cb.GEN} tokens)")
    out = {"depth": n, "completed": st["completed"],
           "mean_occupancy": st["mean_occupancy"], "midstream_joins": st["midstream_joins"],
           "prefill_waves": st["prefill_waves"], "segments": st["segments"],
           "p50_latency_s": lat[len(lat) // 2], "launches": runs["server"],
           "one_shot_launches": runs["one-shot"], "seconds": time.perf_counter() - t}
    print(f"  continuous_batching (qwen1.5-4b full, {n} of {layers} layers): served "
          f"{st['completed']}/{len(res['results'])}, occupancy {st['mean_occupancy']:.2f}, "
          f"{st['midstream_joins']} joined mid-stream, p50 latency {out['p50_latency_s'] * 1e3:.1f}"
          f" ms; the server's launches {runs['server']} ({st['prefill_waves']} prefill waves, "
          f"{st['segments']} segments; held), the one-shot runs' {runs['one-shot']} "
          f"({len(res['prompts'])} x one generate; held); every stream bitwise one-shot "
          f"generate (held); {out['seconds']:.2f} s", flush=True)
    return out


def run_serve_hetero_example(dev, torch, depth: int = GRANITE_DEPTH) -> dict:
    """serve_hetero at granite-34b full width, ``depth`` layers: both
    phases' tokens bitwise one-shot generate of the 64 requests; each
    phase's launches exactly its packages times one generate's (the
    one-shot run's, itself held to the model's count); each pod one capture
    a package shape, one replay a package, no warm-up clone; balance and
    shares printed."""
    from repro_torch.kernels import ops
    from repro_torch.core import DeviceGroup

    t = time.perf_counter()
    sh = load_example("serve_hetero_torch")
    torch.cuda.reset_peak_memory_stats()
    cfg, api, params, layers = sh.model(True, depth, dev)
    runs = {}

    @contextlib.contextmanager
    def around(name):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        runs[name] = (ops.launch_counts(), time.perf_counter() - t0)

    res = sh.serve_hetero(cfg, api, params, dev, around=around)
    one = runs["one-shot"][0]
    want = {"flash_attention": depth, "flash_decode": depth * (sh.GEN - 1),
            "flash_decode_paged": 0, "ssm_scan": 0, "rglru_scan": 0,
            **row_kernel_launches("granite-34b", sh.GEN, depth)}
    if one != want:
        fail(f"serve_hetero_torch: one-shot generate launched {one}, want {want}")
    out = {"depth": depth, "one_shot_launches": one, "phases": {}}
    shapes = {}
    for name, ph in res["phases"].items():
        counts, secs = runs[name]
        n_pk = sum(len(v) for v in ph["packages"].values())
        if not ph["bitwise"]:
            fail(f"serve_hetero_torch {name}: tokens differ from one-shot generate")
        if counts != {k: v * n_pk for k, v in one.items()}:
            fail(f"serve_hetero_torch {name}: launches {counts} != {n_pk} packages x {one}")
        if not all(ph["packages"].values()):
            fail(f"serve_hetero_torch {name}: a pod ran no package: {ph['packages']}")
        for g, sizes in ph["packages"].items():
            shapes.setdefault(g, []).extend(sizes)
        out["phases"][name] = {"packages": ph["packages"], "balance": ph["balance"],
                               "work_share": ph["work_share"], "launches": counts,
                               "seconds": secs}
        print(f"  serve_hetero {name}: packages {ph['packages']}; balance {ph['balance']:.3f}; "
              f"share { {k: round(v, 3) for k, v in ph['work_share'].items()} }; launches "
              f"{n_pk} x one generate (held); bitwise one-shot generate of the "
              f"{len(res['tokens'])} requests (held); {secs:.2f} s", flush=True)
    for g, sizes in shapes.items():
        st = res["graphs"].get(g)
        n_shapes = len({DeviceGroup._bucket(n, 2) for n in sizes})
        if st is None or (st["replays"], st["captures"],
                          st["warmup_clone_bytes"]) != (len(sizes), n_shapes, 0):
            fail(f"serve_hetero_torch: pod {g} ran packages {sizes} with graph counters {st}: "
                 f"want one replay a package, one capture a package shape, no clone")
            continue
        out.setdefault("graphs", {})[g] = {k: st[k] for k in ("captures", "capture_s",
                                                               "wait_s", "replays")}
        print(f"  serve_hetero {g}: {st['captures']} captures ({st['capture_s']:.2f} s, waiting "
              f"{st['wait_s']:.2f} s), {st['replays']} replays (held)", flush=True)
    out["one_shot_s"] = runs["one-shot"][1]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t
    print(f"  serve_hetero (granite-34b full, {depth} of {layers} layers): one-shot generate "
          f"{out['one_shot_s']:.2f} s, launches {one} (held); peak {out['peak_gib']:.2f} GiB; "
          f"{out['seconds']:.2f} s", flush=True)
    return out


def run_examples_phase(dev, torch, card) -> dict:
    """The [examples] phase: the port's five examples of A12 in-process,
    the runtime ones at their own sizes, the model ones at full width."""
    print(at() + " [examples] pipeline_dataflow, async_coexec and nbody_coexec (Listing 2: cpu "
          "on the host, phi and gpu on cuda:0) at the reference's sizes", flush=True)
    t = time.perf_counter()
    out = run_runtime_examples(dev)
    gc.collect()
    print(at() + f" [examples] continuous_batching, qwen1.5-4b --full --depth {SERVED_DEPTH}: 12 "
          f"requests of 8 + 6, buckets (8,), max_batch 4, seg_len 2, arrivals 5 ms apart",
          flush=True)
    out["continuous_batching"] = run_continuous_batching_example(dev, torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(at() + f" [examples] serve_hetero, granite-34b --full --depth {GRANITE_DEPTH}: 64 "
          f"requests of 32 + 8 over pod-a and pod-b of cuda:0, HGuided(k=2, adaptive=True), "
          f"pod-b 4x slower in phase 2 ({card})", flush=True)
    out["serve_hetero"] = run_serve_hetero_example(dev, torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    print(f"  [examples] {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ [train]
# The training slice (A10): flash_attention's autograd Function at the
# train paths' shapes, then three train paths.  All bf16 unless stated.
TRAIN_REL_TOL = 2e-2   # dq/dk/dv, and per-layer parameter gradients, rel L2
TRAIN_LOSS_REL = 1e-2  # step 0's loss against kernel_impl="reference"
TRAIN_ATTENTION = (
    # name, B, S, H, KV, hd, causal, prefix_len
    ("train qwen1.5-4b (B 2, S 512, causal)", 2, 512, 20, 20, 128, True, 0),
    ("train whisper-tiny encoder (B 8, 1500, bidirectional)", 8, 1500, 6, 6, 64, False, 0),
    ("train paligemma-3b prefix-LM (B 8, 256 + 32, MQA, hd 256)", 8, 288, 8, 1, 256, True,
     256),
)
# qwen1.5-4b at its published widths, cut to 20 of its 40 layers: the float32
# state (weights, gradients, m, v) and the bf16 cast take 18 bytes a
# parameter, 42.5 GB at 2.36 B parameters (80 GB at 40 layers does not fit).
QWEN_TRAIN_LAYERS, QWEN_TRAIN_B, QWEN_TRAIN_S, QWEN_TRAIN_MB, QWEN_TRAIN_STEPS = 20, 4, 512, 2, 3
WHISPER_TRAIN_ARGV = ["--arch", "whisper-tiny", "--full", "--batch", "8", "--seq", "64",
                      "--seed", "0", "--kernel", "cuda", "--ckpt-interval", "2"]
# Two steps: after the first, each step waits the same 8-10 s on the CPU's
# quantum (cut from 3 to make room for the [mesh] phase).
HETERO_STEPS, HETERO_B, HETERO_S = 2, 8, 64
# The cuda group's power hint over the CPU's 1 (discover()'s default): the
# first step's shares follow it, so the CPU takes one sequence (it rated at
# ~0.13 sequences/s against the card's 11-21 on the H100).
HETERO_CUDA_POWER = 16.0


def rel_l2(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb > 0 else float(a.norm() > 0)


def tree_rel_l2(a: list, b: list) -> float:
    """Relative L2 of two gradient lists taken as one vector."""
    num = sum(float((x.detach().float() - y.detach().float()).norm()) ** 2 for x, y in zip(a, b))
    den = sum(float(y.detach().float().norm()) ** 2 for y in b)
    return (num / den) ** 0.5 if den > 0 else 0.0


def run_train_attention_case(case, dev, flush, torch, F, fa) -> dict:
    """flash_attention's Function at a train shape: the forward equals the
    raw kernel's output bitwise, dq/dk/dv are within TRAIN_REL_TOL of
    autograd through flash_attention_plain, and its times beside sdpa's
    forward + backward and the bounds."""
    name, b, s, h, kv, hd, causal, prefix = case
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(len(name))
    q = torch.randn((b, s, h, hd), generator=g, device=dev).to(dt).requires_grad_()
    k = torch.randn((b, s, kv, hd), generator=g, device=dev).to(dt).requires_grad_()
    v = torch.randn((b, s, kv, hd), generator=g, device=dev).to(dt).requires_grad_()
    do = torch.randn((b, s, h, hd), generator=g, device=dev).to(dt)
    kw = dict(causal=causal, prefix_len=prefix)
    with torch.no_grad():
        raw = fa._flash_attention_cuda(q, k, v, window=0, q_offset=0, block_q=64,
                                       block_k=fa.BLOCK_K, **kw)
    out = fa.flash_attention(q, k, v, **kw)
    if out.grad_fn is None or "FlashAttention" not in type(out.grad_fn).__name__:
        fail(f"flash_attention {name}: the output does not come from the autograd Function")
    if not torch.equal(out, raw):
        fail(f"flash_attention {name}: the Function's forward differs from the kernel's output")
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, **kw), (q, k, v), do)
    # The plain version's forward + backward, timed on one call after the
    # check's (its seconds would dominate the phase if it were timed as the
    # kernel is).
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.autograd.grad(fa.flash_attention_plain(q, k, v, **kw), (q, k, v), do)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    errs = {n: rel_l2(a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    if max(errs.values()) > TRAIN_REL_TOL:
        fail(f"flash_attention {name}: gradients {errs} beyond {TRAIN_REL_TOL} rel L2 of autograd "
             f"through flash_attention_plain")
    del got, want
    fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush, 10)
    out = fa.flash_attention(q, k, v, **kw)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
                     flush, 10)
    both_ms = time_ms(lambda: torch.autograd.grad(fa.flash_attention(q, k, v, **kw), (q, k, v),
                                                  do), flush, 10)
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=dev)
    if causal:
        mask &= (kpos <= qpos) | ((qpos < prefix) & (kpos < prefix))
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    plain_causal = causal and not prefix

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=None if plain_causal or
                                           not causal else mask, is_causal=plain_causal,
                                           enable_gqa=h != kv)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    lib_ms = time_ms(sdpa, flush, 10)
    pairs = int(mask.sum())
    esz = q.element_size()
    # Forward: 2 products of 2 hd flops a (query, key) pair; backward: the
    # recomputed QK^T and 4 more products (dV, dP, dQ, dK).
    fwd_ops, bwd_ops = 4 * hd * b * h * pairs, 10 * hd * b * h * pairs
    qn, kn = q.numel(), k.numel()
    both_bytes = esz * (4 * qn + 4 * kn)  # q, k, v, do in; out, dq, dk, dv out
    bwd_bytes = esz * (3 * qn + 4 * kn)   # q, k, v, do in; dq, dk, dv out

    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["bfloat16"] * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    both_bound, both_by = bound(both_bytes, fwd_ops + bwd_ops)
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_ops)
    recompute = ("prefix-LM" if prefix else "naive" if s * s <= fa.RECOMPUTE_NAIVE_MAX
                 else "chunked 1024")
    rec = dict(case=name, recompute=recompute, rel_l2=errs, forward_ms=fwd_ms,
               backward_ms=bwd_ms, forward_backward_ms=both_ms, plain_forward_backward_ms=plain_ms,
               sdpa_forward_backward_ms=lib_ms, bound_forward_backward_ms=both_bound,
               bound_forward_backward_by=both_by, bound_backward_ms=bwd_bound,
               bound_backward_by=bwd_by)
    print(f"  flash_attention train | {name}: forward == kernel bitwise; dq/dk/dv rel L2 "
          f"{', '.join(f'{v:.2e}' for v in errs.values())} (held {TRAIN_REL_TOL}); forward "
          f"{fwd_ms:.4f} ms, backward ({recompute} recompute) {bwd_ms:.4f} ms, forward + "
          f"backward {both_ms:.4f} ms; sdpa forward + backward {lib_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; bound forward + backward {both_bound:.4f} ms ({both_by}), "
          f"backward {bwd_bound:.4f} ms ({bwd_by})", flush=True)
    return rec


def layer_vjp(fn, lp, inputs, cot, device, torch):
    """The VJP at ``cot`` of ``fn(layer params, *inputs)``, taken on
    copies of the params and inputs on ``device``: (input gradients,
    parameter gradients in ``tree_leaves`` order)."""
    from repro_torch.models.params import tree_leaves, tree_unflatten

    leaves = [t.detach().to(device).requires_grad_() for t in tree_leaves(lp)]
    ins = [t.detach().to(device).requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = fn(tree_unflatten(lp, leaves), *ins)
        gs = torch.autograd.grad(out, ins + leaves, cot.to(device))
    return gs[:len(ins)], gs[len(ins):]


def params_rel_l2(a, b) -> float:
    """The largest rel L2 over two lists of parameter gradients (b's
    device)."""
    return max(rel_l2(x.to(y.device), y) for x, y in zip(a, b))


def train_layer_errors(cfg, params, batch, torch) -> list:
    """Per layer of the dense stack, the largest rel L2 of its parameter
    gradients under ``cfg`` (the kernels) against ``kernel_impl=
    "reference"``, each layer's VJP taken on the kernel run's own layer
    input and output gradient (first microbatch), each through
    ``remat(apply, cfg)`` as the train step runs it (so under remat "dots"
    the Function's forward runs again in the backward): the layer-by-layer
    reference check of the train path.  Whole-model gradients of random
    weights cannot be compared across implementations: they are chaotic
    (ROADMAP.md C11)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import cast_float
    from repro_torch.train.step import microbatches

    ref = dataclasses.replace(cfg, kernel_impl="reference")
    tokens = microbatches(batch, cfg.microbatches)[0]["tokens"]
    p = cast_float(params, cfg.compute_dtype)
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    order = T.stack_order(p, None, cfg)
    with torch.no_grad():
        x, xs = T.embed_tokens(p, tokens, cfg), []
        for apply, lp, _ in order:
            xs.append(x)
            x, _ = apply(lp, x, pos, cfg, mode="train", cache=None)
    xf = x.detach().requires_grad_()
    g = torch.autograd.grad(T.lm_loss(p, xf, *T.next_token_targets(tokens), cfg), xf)[0]
    errs = []
    for i in reversed(range(len(order))):
        apply, lp, _ = order[i]
        res = [layer_vjp(lambda lp, x, c=c: T.remat(apply, c)(lp, x, pos, c, mode="train",
                                                              cache=None)[0],
                         lp, [xs[i]], g, tokens.device, torch) for c in (cfg, ref)]
        errs.append(params_rel_l2(res[0][1], res[1][1]))
        g = res[0][0][0]
        del res
    return errs[::-1]


def whisper_device_layer_errors(cfg, params, batch, dev, torch) -> dict:
    """Per layer of whisper's encoder and decoder (and ``enc_ln_post``),
    the largest rel L2 of its parameter gradients on cpu:0 against cuda:0,
    each layer's VJP taken on the same inputs and output gradient (cuda:0's
    chain, from cuda:0's forward of ``batch``): the layer-by-layer check of
    the code a HeteroTrainer's CPU group runs.  In float32: with the
    saturated attention of the reference's init (ROADMAP.md C11) the
    gradients of a layer's q and k path amplify its rounding some
    thousandfold, so two bf16 devices part there by a few 1e-2 (float32
    against float64 by 1e-4)."""
    from repro_torch.models import layers as L
    from repro_torch.models import whisper as W
    from repro_torch.models.params import cast_float, unstack

    cpu = torch.device("cpu")
    p = cast_float(params, cfg.compute_dtype)
    tokens, frames = batch["tokens"].to(dev), batch["frames"].to(dev)
    impl, eps = L.impl_for(cfg, "train"), cfg.norm_eps
    enc, dec = unstack(p["enc_layers"], cfg.enc_layers), unstack(p["dec_layers"], cfg.n_layers)

    def enc_fn(lp, x):
        return W._enc_layer(lp, x, cfg, impl)

    def post_fn(lp, x):
        return L.layer_norm(x, lp["w"], lp["b"], eps, impl)

    def dec_fn(lp, x, e):
        return W._dec_layer(lp, x, e, cfg, mode="train", cache=None, posv=None)

    with torch.no_grad():
        xe = [W.encoder_input(frames, cfg)]
        for lp in enc:
            xe.append(enc_fn(lp, xe[-1]))
        enc_out = post_fn(p["enc_ln_post"], xe[-1])
        xd = [W.decoder_input(p, tokens, cfg)[0]]
        for lp in dec:
            xd.append(dec_fn(lp, xd[-1], enc_out))
    xf = xd[-1].detach().requires_grad_()
    g = torch.autograd.grad(W.train_loss(p, xf, tokens, cfg), xf)[0]

    def both(fn, lp, ins, cot):
        (gi, gp), (_, gc) = (layer_vjp(fn, lp, ins, cot, d, torch) for d in (dev, cpu))
        return gi, params_rel_l2(gc, gp)

    errs = {"decoder": [], "encoder": []}
    g_enc = torch.zeros_like(enc_out)
    for i in reversed(range(cfg.n_layers)):
        (g, ge), e = both(dec_fn, dec[i], [xd[i], enc_out], g)
        g_enc += ge
        errs["decoder"].insert(0, e)
    (g,), errs["enc_ln_post"] = both(post_fn, p["enc_ln_post"], [xe[-1]], g_enc)
    for i in reversed(range(cfg.enc_layers)):
        (g,), e = both(enc_fn, enc[i], [xe[i]], g)
        errs["encoder"].insert(0, e)
    return errs


def run_qwen_train(dev, torch, ops, card, attn_recs, detail) -> dict:
    """qwen1.5-4b at full width, 20 of 40 layers, kernel_impl="cuda",
    through the launcher's ``build_state`` and the port's
    ``make_train_step``: B 4 x S 512 (SyntheticTokens, seed 0), 2
    microbatches, remat "dots", 3 steps.  ``detail`` (``--train``) adds
    where a step's time goes: the gradients and AdamW timed apart, a step
    under each remat policy and a profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.launch.train import build_state, n_params
    from repro_torch.models import get_model
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=QWEN_TRAIN_LAYERS,
                              kernel_impl="cuda", microbatches=QWEN_TRAIN_MB)
    ref = dataclasses.replace(cfg, kernel_impl="reference")
    api = get_model(cfg)
    t0 = time.perf_counter()
    state, _ = build_state(cfg, api, dev, 0)
    ds = SyntheticTokens(cfg, QWEN_TRAIN_B, QWEN_TRAIN_S, seed=0)
    batches = [to_device(next(ds), dev) for _ in range(QWEN_TRAIN_STEPS)]
    torch.cuda.synchronize()
    n = n_params(state["params"])
    print(f"  qwen1.5-4b (remat {cfg.remat}, {QWEN_TRAIN_MB} microbatches of "
          f"{QWEN_TRAIN_B // QWEN_TRAIN_MB} x {QWEN_TRAIN_S}): {n:,} parameters, state built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    ops.reset_launch_counts()
    l_ref, g_ref = loss_and_grads(api, ref, state["params"], batches[0])
    ref_counts = {k: c for k, c in ops.launch_counts().items() if c}
    l_cu, g_cu = loss_and_grads(api, cfg, state["params"], batches[0])
    l_ref, l_cu = float(l_ref), float(l_cu)
    loss_rel = abs(l_cu - l_ref) / abs(l_ref)
    leaf = [rel_l2(a, w) for a, w in zip(g_cu, g_ref)]
    whole = tree_rel_l2(g_cu, g_ref)
    del g_cu
    # The witness of C11 within the reference alone: its whole-model
    # gradient in bf16 against the same in float32 (no kernel in either).
    ref32 = dataclasses.replace(ref, compute_dtype="float32")
    l_32, g_32 = loss_and_grads(api, ref32, state["params"], batches[0])
    l_32 = float(l_32)
    witness = {"loss_rel": abs(l_ref - l_32) / abs(l_32), "all_leaves": tree_rel_l2(g_ref, g_32),
               "leaf_max": max(rel_l2(a, w) for a, w in zip(g_ref, g_32))}
    del g_ref, g_32
    gc.collect()
    torch.cuda.empty_cache()
    if ref_counts:
        fail(f"qwen1.5-4b train: kernel_impl='reference' launched {ref_counts}")
    if not loss_rel <= TRAIN_LOSS_REL:
        fail(f"qwen1.5-4b train: step 0 loss {l_cu} vs reference {l_ref} ({loss_rel:.2e} rel)")
    layer_errs = train_layer_errors(cfg, state["params"], batches[0], torch)
    if max(layer_errs) > TRAIN_REL_TOL:
        fail(f"qwen1.5-4b train: a layer's parameter gradients through the kernels disagree with "
             f"the reference's beyond {TRAIN_REL_TOL} rel L2: {layer_errs}")
    print(f"  step 0 against kernel_impl='reference' (same weights and batch): loss {l_cu:.6f} vs "
          f"{l_ref:.6f} ({loss_rel:.2e} rel, held {TRAIN_LOSS_REL}); per-layer parameter "
          f"gradients (each layer's VJP on the kernel run's own inputs) max rel L2 "
          f"{max(layer_errs):.2e} (held {TRAIN_REL_TOL}; the kernel side through remat "
          f"{cfg.remat!r}); whole-model gradient leaves, not held (chaotic on random weights): "
          f"max rel L2 {max(leaf):.3g}, all leaves {whole:.3g}; the same within the reference, "
          f"bf16 against float32 (loss {l_32:.6f}, {witness['loss_rel']:.2e} rel): max rel L2 "
          f"{witness['leaf_max']:.3g}, all leaves {witness['all_leaves']:.3g}", flush=True)

    step_fn = make_train_step(cfg, api)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(QWEN_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, batches[i])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # remat "dots" keeps the products' outputs: each layer's flash_attention
    # forward runs again in the backward (its output is no product's).
    forwards = 2 if cfg.remat in ("dots", "full") else 1
    want = {k: 0 for k in counts}
    want["flash_attention"] = QWEN_TRAIN_LAYERS * QWEN_TRAIN_MB * forwards * QWEN_TRAIN_STEPS
    if counts != want:
        fail(f"qwen1.5-4b train launch counts {counts} != {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"qwen1.5-4b train: a loss is not finite: {losses}")

    step = sorted(step_s[1:])[len(step_s[1:]) // 2]
    toks = QWEN_TRAIN_B * QWEN_TRAIN_S
    out = {"layers": QWEN_TRAIN_LAYERS, "of_layers": 40, "params": n, "batch": QWEN_TRAIN_B,
           "seq": QWEN_TRAIN_S, "microbatches": QWEN_TRAIN_MB, "remat": cfg.remat,
           "losses": losses, "step_s": step_s, "tokens_per_s": toks / step,
           "peak_memory_bytes": peak, "launches": counts, "loss_rel_vs_reference": loss_rel,
           "layer_grad_rel_l2_max": max(layer_errs), "layer_grad_rel_l2": layer_errs,
           "leaf_grad_rel_l2_max_not_held": max(leaf), "grad_rel_l2_all_not_held": whole,
           "reference_bf16_vs_float32_not_held": witness}
    print(f"  3 steps: losses {[round(x, 4) for x in losses]}; step {[round(x, 3) for x in step_s]} "
          f"s; {toks / step:.1f} tokens/s (median of steps 1-2); peak memory {peak / 2**30:.2f} GiB; "
          f"launches {counts} (want {want}) -- {card}", flush=True)
    if detail:
        out.update(train_step_parts(cfg, api, state, batches, step_fn, attn_recs[0], forwards,
                                    torch, card))
    del state
    return out


def train_step_parts(cfg, api, state, batches, step_fn, fa_rec, forwards, torch, card) -> dict:
    """Where a qwen train step's time goes (``--train`` only): the
    gradients, then AdamW, timed apart (a fourth update of the state); a
    step under each remat policy (the state updated on); a profiled step
    of the config's own."""
    from repro_torch.models.params import tree_unflatten
    from repro_torch.optim import adamw_update, lr_schedule
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    torch.cuda.synchronize()
    t = time.perf_counter()
    _, grads = loss_and_grads(api, cfg, state["params"], batches[0])
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t
    lr = lr_schedule(state["step"])
    t = time.perf_counter()
    adamw_update(state["params"], tree_unflatten(state["params"], grads), state["opt"],
                 state["step"], lr=lr)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t
    del grads
    remat_s = {}
    for policy in ("none", "full", "dots"):
        fn = make_train_step(dataclasses.replace(cfg, remat=policy), api)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = fn(state, batches[1])
        torch.cuda.synchronize()
        remat_s[policy] = time.perf_counter() - t
    prof, state = profile_train_step(step_fn, state, batches[2], torch)
    per_mb = QWEN_TRAIN_LAYERS * QWEN_TRAIN_MB
    attn_fwd_s = per_mb * forwards * fa_rec["forward_ms"] / 1e3
    attn_bwd_s = per_mb * fa_rec["backward_ms"] / 1e3
    print(f"  a step's parts: gradients {grad_s:.3f} s (of which flash_attention forward "
          f"{attn_fwd_s:.3f} s and its recompute backward {attn_bwd_s:.3f} s, from the [train] "
          f"kernel line's times x {per_mb * forwards} and x {per_mb}), AdamW {adam_s:.3f} s; a "
          f"step under remat none / full / dots: "
          f"{' / '.join(f'{remat_s[p]:.3f}' for p in ('none', 'full', 'dots'))} s -- {card}",
          flush=True)
    print(f"  profiled step ({cfg.remat}): wall {prof['wall_ms']:.1f} ms, card busy "
          f"{prof['device_busy_ms']:.1f} ms ({prof['device_busy_ms'] / prof['wall_ms']:.1%}), "
          f"{prof['kernels']} kernels, of it the matrix products (cuBLAS) "
          f"{prof['gemm_ms']:.1f} ms; by kernel: "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in prof["groups"][:8]), flush=True)
    return {"grads_s": grad_s, "adamw_s": adam_s, "remat_step_s": remat_s, "profile": prof,
            "flash_forward_s_est": attn_fwd_s, "flash_backward_s_est": attn_bwd_s}


# Words in the names of cuBLAS's matrix-product kernels on Hopper.
GEMM_WORDS = ("nvjet", "gemm", "gemv", "xmma", "cutlass")


def profile_train_step(step_fn, state, batch, torch):
    """One train step under torch.profiler: its wall time, the card's busy
    time (its kernels' durations summed, from the raw trace), of it the
    matrix products' (the kernel groups named as cuBLAS's, ``GEMM_WORDS``),
    and every kernel group's time, largest first.  Returns (record,
    state)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or "spin_kernel" in e.name():
            continue
        g = kernel_group(e.name())
        groups[g] = groups.get(g, 0.0) + e.duration_ns() / 1e6
        n += 1
    every = sorted(groups.items(), key=lambda kv: -kv[1])
    gemm = sum(ms for g, ms in every if any(w in g.lower() for w in GEMM_WORDS))
    return {"wall_ms": wall * 1e3, "device_busy_ms": sum(groups.values()), "kernels": n,
            "gemm_ms": gemm, "groups": every}, state


def run_whisper_train(dev, torch, ops) -> dict:
    """whisper-tiny at full width through ``repro_torch.launch.train``: 4
    steps checkpointed every 2, then ``--restore --steps 6``."""
    import shutil

    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.launch import train as launch_train
    from repro_torch.models.params import tree_leaves

    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = WHISPER_TRAIN_ARGV + ["--ckpt", str(ckdir)]
    ops.reset_launch_counts()
    r1 = launch_train.main(argv + ["--steps", "4"])
    c1 = ops.launch_counts()
    saved, extra = restore_checkpoint(ckdir, 4, r1["state"])
    same = all(torch.equal(a, w) for a, w in zip(tree_leaves(saved), tree_leaves(r1["state"])))
    if not same or extra.get("data_cursor") != 4:
        fail(f"whisper-tiny train: the step-4 checkpoint differs from the state it saved "
             f"(equal={same}, extra={extra})")
    del saved
    ops.reset_launch_counts()
    r2 = launch_train.main(argv + ["--steps", "6", "--restore"])
    c2 = ops.launch_counts()
    shutil.rmtree(ckdir, ignore_errors=True)
    if (r2["start"], r2["cursor_at_start"], r2["data_cursor"]) != (4, 4, 6):
        fail(f"whisper-tiny train: the restart did not resume at step 4, cursor 4: "
             f"{r2['start']}, {r2['cursor_at_start']}, {r2['data_cursor']}")
    losses = r1["losses"] + r2["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"whisper-tiny train: a loss is not finite: {losses}")
    from repro_torch.configs import get_config

    cfg = get_config("whisper-tiny")
    per_step = cfg.enc_layers + 2 * cfg.n_layers  # encoder self; decoder self and cross
    for counts, steps in ((c1, 4), (c2, 2)):
        want = {k: 0 for k in counts}
        want["flash_attention"] = per_step * steps
        if counts != want:
            fail(f"whisper-tiny train launch counts {counts} != {want}")
    out = {"losses": losses, "seconds": [r1["seconds"], r2["seconds"]],
           "launches_per_step": per_step, "restored_state_bitwise": True}
    print(f"  whisper-tiny: 4 steps, checkpoints at 2 and 4 (the step-4 one equal to the state "
          f"bitwise), then --restore --steps 6 resumed at step 4, data cursor 4 -> 6; losses "
          f"{[round(x, 4) for x in losses]}; flash_attention {per_step} a step (encoder "
          f"{cfg.enc_layers}, decoder self and cross {2 * cfg.n_layers}), exact; "
          f"{r1['seconds']:.1f} s + {r2['seconds']:.1f} s", flush=True)
    return out


def run_hetero_train(dev, torch, card) -> dict:
    """The HeteroTrainer over ``discover()``'s cpu:0 and cuda:0 groups:
    whisper-tiny at full width, batch 8, quantum 1, 2 steps, the cuda
    group's power hint ``HETERO_CUDA_POWER`` (the first step's shares)."""
    from repro_torch.configs import get_config
    from repro_torch.core import discover
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import build_state
    from repro_torch.models import get_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.hetero import HeteroTrainer

    cfg = dataclasses.replace(get_config("whisper-tiny"), kernel_impl="cuda")
    api = get_model(cfg)
    state, _ = build_state(cfg, api, dev, 0)
    groups = discover()
    names = [g.name for g in groups]
    if names != ["cpu:0", "cuda:0"]:
        fail(f"discover() gave {names}, want ['cpu:0', 'cuda:0']")
    groups[1].power = HETERO_CUDA_POWER
    trainer = HeteroTrainer(cfg, api, groups, quantum=1)
    ds = SyntheticTokens(cfg, HETERO_B, HETERO_S, seed=0)
    batches = [next(ds) for _ in range(HETERO_STEPS)]
    whole_loss, whole = trainer.grads(state["params"], batches[0], dev)
    steps = []
    try:
        for i, batch in enumerate(batches):
            shares = trainer.partition(HETERO_B)
            if i == 0:
                # Before the step updates the state in place: the cuda
                # group's share alone on cuda:0, and the CPU group's share
                # layer by layer on cpu:0 against cuda:0.
                cuda_part = trainer.grads(state["params"], {k: v[shares[0]:] for k, v in
                                                            batch.items()}, dev)[1]
                t = time.perf_counter()
                cpu_layers = whisper_device_layer_errors(
                    dataclasses.replace(cfg, compute_dtype="float32"), state["params"],
                    {k: torch.as_tensor(v[:shares[0]]) for k, v in batch.items()}, dev, torch)
                cpu_layers_s = time.perf_counter() - t
            t = time.perf_counter()
            handle = trainer.submit_step(state, batch)
            state, m = handle.result()
            wall = time.perf_counter() - t
            if sum(m["shares"]) != HETERO_B or m["shares"] != shares:
                fail(f"hetero train: shares {m['shares']} do not cover the batch of {HETERO_B}")
            rec = {"shares": m["shares"], "powers": [float(p) for p in m["powers"]],
                   "seconds": m["seconds"],
                   "loss": m["loss"], "wall_s": wall}
            if i == 0:
                got = tree_leaves(m["grads"])
                parts = [tree_leaves(handle._results[j][1]) for j in range(2)]
                w = [n / HETERO_B for n in shares]
                want = [w[0] * a.to(dev) + w[1] * c for a, c in zip(*parts)]
                # Plumbing: the combine is the shares' weighted sum, and the
                # cuda group's gradient is its share's.
                rec["plumbing_combine_rel_l2"] = tree_rel_l2(got, want)
                rec["plumbing_cuda_share_rel_l2"] = tree_rel_l2(parts[1], tree_leaves(cuda_part))
                rec["cpu_share_layer_rel_l2"] = cpu_layers
                rec["cpu_share_layer_check_s"] = cpu_layers_s
                cpu_max = max(max(cpu_layers["encoder"]), max(cpu_layers["decoder"]),
                              cpu_layers["enc_ln_post"])
                rec["vs_whole_rel_l2_not_held"] = tree_rel_l2(got, tree_leaves(whole))
                rec["whole_loss"] = whole_loss
                rec["loss_rel_vs_whole"] = abs(m["loss"] - whole_loss) / abs(whole_loss)
                if max(rec["plumbing_combine_rel_l2"],
                       rec["plumbing_cuda_share_rel_l2"]) > TRAIN_REL_TOL:
                    fail(f"hetero train: the combined gradient is not the shares' weighted sum "
                         f"({rec['plumbing_combine_rel_l2']:.3g} rel L2), or the cuda group's "
                         f"gradient not its share's ({rec['plumbing_cuda_share_rel_l2']:.3g})")
                if cpu_max > TRAIN_REL_TOL:
                    fail(f"hetero train: the CPU share's layer gradients on cpu:0 disagree with "
                         f"cuda:0's beyond {TRAIN_REL_TOL} rel L2: {cpu_layers}")
                if rec["loss_rel_vs_whole"] > TRAIN_LOSS_REL:
                    fail(f"hetero train: the combined loss {m['loss']} vs the whole batch's on "
                         f"cuda:0 {whole_loss}")
                del parts, want, got, cuda_part, whole
            if not math.isfinite(m["loss"]):
                fail(f"hetero train: loss {m['loss']}")
            steps.append(rec)
            print(f"  step {i}: shares {dict(zip(names, m['shares']))}, rated powers "
                  f"{ {n: round(p, 3) for n, p in zip(names, rec['powers'])} } sequences/s, "
                  f"group seconds {dict(zip(names, [round(x, 3) for x in m['seconds']]))}, loss "
                  f"{m['loss']:.4f}, wall {wall:.2f} s"
                  + (f"; the CPU share's parameter gradients layer by layer on cpu:0 against "
                     f"cuda:0 (same inputs and output gradients, float32) max rel L2 "
                     f"{cpu_max:.2e}, held "
                     f"{TRAIN_REL_TOL} ({cpu_layers_s:.1f} s); plumbing: combine == the shares' "
                     f"weighted sum ({rec['plumbing_combine_rel_l2']:.2e} rel L2), the cuda "
                     f"group's gradient == its share's alone on cuda:0 "
                     f"({rec['plumbing_cuda_share_rel_l2']:.2e}); loss vs the whole batch on "
                     f"cuda:0 {rec['loss_rel_vs_whole']:.2e} rel (held {TRAIN_LOSS_REL}); "
                     f"gradient vs the whole batch on cuda:0 "
                     f"{rec['vs_whole_rel_l2_not_held']:.3g} rel L2 (not held: chaotic on "
                     f"random weights)" if i == 0 else "")
                  + f" -- {card}", flush=True)
    finally:
        trainer.shutdown()
    return {"groups": names, "cuda_power_hint": HETERO_CUDA_POWER, "steps": steps}


def run_train_phase(dev, torch, F, ops, card, detail=False) -> dict:
    """The [train] phase; ``detail`` (``--train``) adds where a qwen
    step's time goes (:func:`train_step_parts`)."""
    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    attn = [run_train_attention_case(c, dev, flush, torch, F, fa) for c in TRAIN_ATTENTION]
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    print(at() + f" [train] qwen1.5-4b at full width, {QWEN_TRAIN_LAYERS} of 40 layers, "
          f"kernel_impl='cuda', B {QWEN_TRAIN_B} x S {QWEN_TRAIN_S}, {QWEN_TRAIN_STEPS} steps",
          flush=True)
    qwen = run_qwen_train(dev, torch, ops, card, attn, detail)
    gc.collect()
    torch.cuda.empty_cache()
    print(at() + " [train] whisper-tiny --full through repro_torch.launch.train, checkpoint and "
          "restore", flush=True)
    whisper = run_whisper_train(dev, torch, ops)
    gc.collect()
    torch.cuda.empty_cache()
    print(at() + f" [train] HeteroTrainer over discover()'s cpu:0 and cuda:0, whisper-tiny "
          f"--full, batch {HETERO_B}, quantum 1, {HETERO_STEPS} steps", flush=True)
    hetero = run_hetero_train(dev, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    return {"attention": attn, "qwen1.5-4b": qwen, "whisper-tiny": whisper, "hetero": hetero}


# ------------------------------------------------------------------ [mesh]
# The device mesh (A11) on cuda:0: worlds of spawned ranks that compute on
# the one card and exchange over gloo (NCCL refuses two ranks of one
# communicator on one GPU), each held against a one-rank yardstick run
# first.  The rank functions are module-level: a spawned rank imports this
# script (not its main()) and calls them.
MESH_SEQ = {"arch": "internlm2-20b", "depth": 2, "batch": 8, "prompt": 2048, "cache": 4096,
            "steps": 16}
MESH_EP = {"arch": "arctic-480b", "depth": 1, "batch": 8, "prompt": 256, "steps": 8,
           "capacity_factor": 100.0}
MESH_DP = {"arch": "qwen1.5-4b", "depth": 2, "batch": 4, "seq": 512, "steps": 2}
MESH_ELASTIC_ARGV = ["--arch", "whisper-tiny", "--full", "--batch", "8", "--seq", "64",
                     "--seed", "0", "--kernel", "cuda", "--ckpt-interval", "2", "--steps", "2",
                     "--mesh-shape", "2x1"]
MESH_LOGITS_REL = {"bfloat16": BF16_TOL, "float32": F32_TOL}  # rel L2 a step's logits
MESH_LOSS_REL, MESH_GRAD_REL = 1e-4, 1e-3  # data parallelism, float32 compute
MESH_KERNELS = ("flash_attention", "flash_decode", "gemm_rowinv", "rms_norm", "moe_gemm",
                "rglru_scan")


def mesh_store(name: str) -> Path:
    """A fresh ``file://`` store (and the ranks' result files) under build/."""
    import shutil

    d = ROOT / "build" / "mesh" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d / "store"


def mesh_model(arch, depth, dtype, dev, torch, **over):
    """(cfg, api, params drawn from seed 0 in ``dtype`` on ``dev``): the
    published widths at ``depth`` layers, kernel_impl="cuda"."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.params import materialize

    cfg = dataclasses.replace(get_config(arch), n_layers=depth, kernel_impl="cuda",
                              compute_dtype=dtype, **over)
    api = get_model(cfg)
    params = materialize(api.param_spec(cfg), torch.Generator(device=dev).manual_seed(0),
                         getattr(torch, dtype), dev)
    return cfg, api, params


def mesh_tokens(batch, prompt, steps, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (batch, prompt)).astype(np.int32),
            [rng.integers(0, vocab, (batch, 1)).astype(np.int32) for _ in range(steps)])


def whole_logits(logits, cfg):
    """Logits whole over the vocabulary: gathered over "model" where the
    rank holds a slice of it (tensor parallelism), float32."""
    from repro_torch.distributed.sharding import current_mesh

    if logits.shape[-1] != cfg.vocab:
        logits = current_mesh().all_gather(logits, ("model",), logits.dim() - 1)
    return logits.float()


def mesh_generate_local(cfg, api, params, tokens, steps, cache, rows, record=None):
    """:func:`mesh_generate`, each call's logits kept as the rank holds
    them (over its slice of the vocabulary under tensor parallelism)."""
    logits, cache = api.prefill(params, {"tokens": rows(tokens)}, cfg, cache)
    out = [logits]
    if record:
        record(0)
    for i, tok in enumerate(steps):
        logits, cache = api.decode(params, rows(tok), tokens.shape[1] + i, cfg, cache)
        out.append(logits)
        if record:
            record(i + 1)
    return out


def mesh_generate(cfg, api, params, tokens, steps, cache, rows, record=None):
    """Prefill ``tokens`` then decode the teacher-forced ``steps``; returns
    every call's logits (float32, on the card, whole over the vocabulary:
    gathered after the calls, so ``record`` sees none of the gathers).
    ``rows`` cuts each host batch to the caller's rows; ``record(i)`` runs
    after call i."""
    return [whole_logits(x, cfg)
            for x in mesh_generate_local(cfg, api, params, tokens, steps, cache, rows, record)]


def mesh_decode_layers(cfg, api, params, tokens, steps, cache, rows, forced=None):
    """Prefill ``tokens``, then decode the teacher-forced ``steps`` one
    layer at a time, recording each layer's input and its decode
    attention output (``cached_attention``'s) and each call's logits, all
    float32 on the host.  ``forced`` (a yardstick's record): every layer
    takes the yardstick's input instead of its own, so the caches receive
    the yardstick's keys and values and a layer's attention output differs
    from the yardstick's only by how the attention is computed.  ``rows``
    cuts a host batch (or a record) to the caller's rows."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    from repro_torch.distributed.sharding import current_mesh

    logits, _ = api.prefill(params, {"tokens": rows(tokens)}, cfg, cache)
    mesh = current_mesh()
    rec = {"logits": [whole_logits(logits, cfg).cpu()], "x": [], "attn": [],
           "prefill_collectives": mesh.reset_stats() if mesh is not None else None}
    real, seen = A.cached_attention, []

    def cached_attention(q, cache, pos, cfg, **kw):
        out = real(q, cache, pos, cfg, **kw)
        seen.append(out.float().cpu())
        return out

    A.cached_attention = cached_attention
    try:
        for i, tok in enumerate(steps):
            pos = tokens.shape[1] + i
            x = T.embed_tokens(params, rows(tok), cfg)
            xs = []
            for li, (apply, lp, lc) in enumerate(T.stack_order(params, cache, cfg)):
                if forced is not None:
                    x = rows(forced["x"][i][li]).to(x.device, x.dtype)
                xs.append(x.float().cpu())
                x, _ = apply(lp, x, None, cfg, mode="decode", cache=lc, pos=pos)
            rec["x"].append(xs)
            rec["attn"].append(seen[-cfg.n_layers:])
            rec["logits"].append(whole_logits(T.logits_fn(params, x, cfg), cfg).cpu())
    finally:
        A.cached_attention = real
    return rec


def sliced_bytes(params, places, mesh) -> tuple:
    """(the bytes a rank holds of the leaves sliced over "model", those
    leaves' whole bytes)."""
    from repro_torch.distributed.sharding import axes_of
    from repro_torch.models.params import tree_leaves

    held = whole = 0
    for t, sh in zip(tree_leaves(params), tree_leaves(places)):
        if any("model" in axes_of(r) for r in sh):
            b = t.numel() * t.element_size()
            held += b
            whole += b * mesh.shape["model"]
    return held, whole


def mesh_seq_rank(rank, world, dev, yard_file, tokens, steps):
    """(a) on a rank of the (data 2, model 2) world: internlm2-20b with the
    seq-sharded cache, in bf16 then float32, teacher-forced by the
    yardstick's layer inputs: each decode step's attention outputs layer
    by layer, and each call's logits, against the yardstick's rows."""
    import torch

    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.step import zeros_cache
    from repro_torch.train.step import state_placements

    yard = torch.load(yard_file)
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    sh = S.named_sharding(mesh, ("batch", None), tokens.shape)

    def cut(t):  # the rank's rows of a host batch or record
        t = torch.from_numpy(t) if not isinstance(t, torch.Tensor) else t
        return S.rank_slice(t, sh, mesh)

    def rows(t):
        return cut(t).to(dev)

    out = {"coord": mesh.coord}
    for dtype in ("bfloat16", "float32"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg, api, params = mesh_model(MESH_SEQ["arch"], MESH_SEQ["depth"], dtype, dev, torch,
                                      seq_shard_cache=True)
        places = state_placements(cfg, api, mesh)[1]["params"]
        params = S.shard_tree(params, places, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        cache = zeros_cache(cfg, api, tokens.shape[0], MESH_SEQ["cache"], device=dev, mesh=mesh)
        mesh.reset_stats()
        y = yard[dtype]
        rec = mesh_decode_layers(cfg, api, params, tokens, steps, cache, rows, y)
        torch.cuda.synchronize()
        stats = mesh.reset_stats()  # the decode steps' (the prefill's are the record's)
        attn = [max(rel_l2(a, cut(b)) for a, b in zip(got, want))
                for got, want in zip(rec["attn"], y["attn"])]
        out[dtype] = {"logits_rel_l2": [rel_l2(a, cut(b)) for a, b in
                                        zip(rec["logits"], y["logits"])],
                      "plain_logits_rel_l2": [rel_l2(a, cut(b)) for a, b in
                                              zip(rec["logits"], y["plain_logits"])],
                      "attention_rel_l2": attn,
                      "finite": all(bool(torch.isfinite(x).all()) for x in rec["logits"]),
                      "cache_slots": int(cache["k"].shape[2]),
                      "collectives": stats,
                      "prefill_collectives": rec["prefill_collectives"],
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "sliced_bytes": sliced_bytes(params, places, mesh),
                      "seconds": time.perf_counter() - t0}
        del params, cache, rec
        torch.cuda.empty_cache()
    return out


def run_mesh_seq(dev, torch) -> dict:
    """(a) The seq-sharded decode: the yardstick (one rank, flash_decode,
    its row-parallel products split at the model ranks' boundary as the
    world sums them: :func:`row_split`) in bf16 and float32, beside the
    one rank's unsplit run (held in float32, printed in bf16, where the
    init's q and k path amplifies a rounding of the split sums: ROADMAP.md
    C11) and the one-rank reference impl's free-running logits (the
    witness of how far two exact attentions part on these random
    weights), then the world of 4."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.serve.step import zeros_cache

    c = MESH_SEQ
    t0 = time.perf_counter()
    yard, witness = {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg, api, params = mesh_model(c["arch"], c["depth"], dtype, dev, torch)
        tokens, steps = mesh_tokens(c["batch"], c["prompt"], c["steps"], cfg.vocab, 7)
        recs = []
        for impl, split in (("cuda", True), ("cuda", False), ("reference", False)):
            cf = dataclasses.replace(cfg, kernel_impl=impl)
            cache = zeros_cache(cf, api, c["batch"], c["cache"], device=dev)
            with row_split() if split else contextlib.nullcontext():
                recs.append(mesh_decode_layers(cf, api, params, tokens, steps, cache,
                                               lambda t: (t if isinstance(t, torch.Tensor)
                                                          else torch.from_numpy(t)).to(dev)))
            del cache
        yard[dtype] = dict(recs[0], plain_logits=recs[1]["logits"])
        witness[dtype] = [rel_l2(a, b) for a, b in zip(recs[2]["logits"], recs[1]["logits"])]
        del params, recs
        gc.collect()
        torch.cuda.empty_cache()
    yard_s = time.perf_counter() - t0
    store = mesh_store("seq")
    yard_file = store.parent / "yard.pt"
    torch.save(yard, yard_file)
    t0 = time.perf_counter()
    res = spawn_world(mesh_seq_rank, 4, "cuda", store, (str(yard_file), tokens, steps))
    world_s = time.perf_counter() - t0
    bad = []
    for r in res:
        for dtype, tol in MESH_LOGITS_REL.items():
            e = r[dtype]
            worst = max(e["logits_rel_l2"] + e["attention_rel_l2"])
            if not e["finite"] or worst > tol:
                bad.append(f"seq-sharded decode {dtype} on rank {r['coord']}: attention or "
                           f"logits rel L2 {worst:.3g} (tol {tol}), finite {e['finite']}")
            if dtype == "float32" and max(e["plain_logits_rel_l2"]) > tol:
                bad.append(f"seq-sharded decode float32 on rank {r['coord']}: logits rel L2 "
                           f"{max(e['plain_logits_rel_l2']):.3g} to the one rank's unsplit "
                           f"run (tol {tol})")
            if e["cache_slots"] != c["cache"] // 2:
                bad.append(f"seq-sharded decode: a rank holds {e['cache_slots']} slots")
    return {"world": 4, "mesh": {"data": 2, "model": 2}, "yardstick_s": yard_s,
            "witness_free_running_logits_rel_l2": witness, "world_s": world_s,
            "ranks": res}, bad


def mesh_ep_rank(rank, world, dev, yard_file, tokens, steps):
    """(b) on a rank of the (model 2) world: arctic-480b with its experts
    split over "model" (drawn whole one rank at a time, the rank's half
    kept), prefill and teacher-forced decode at the no-drop capacity,
    ``moe_gemm`` counted."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.serve.step import zeros_cache
    from repro_torch.train.step import state_placements

    yard = torch.load(yard_file)
    mesh = make_mesh((2,), ("model",), dev)
    S.set_current_mesh(mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(world):
        if r == rank:
            cfg, api, full = mesh_model(MESH_EP["arch"], MESH_EP["depth"], "bfloat16", dev, torch,
                                        ep_shard_map=True)
            places = state_placements(cfg, api, mesh)[1]["params"]
            params = S.shard_tree(full, places, mesh)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    draw_s = time.perf_counter() - t0
    moe.CAPACITY_FACTOR = MESH_EP["capacity_factor"]
    cache = zeros_cache(cfg, api, tokens.shape[0], tokens.shape[1] + len(steps), device=dev,
                        mesh=mesh)
    stats = []
    rows = lambda t: torch.from_numpy(t).to(dev)  # noqa: E731
    ops.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    with moe.dropped_assignments() as drops:
        logits = mesh_generate(cfg, api, params, tokens, steps, cache, rows,
                               lambda i: stats.append(mesh.reset_stats()))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    errs = [rel_l2(lg, yard[i].to(dev)) for i, lg in enumerate(logits)]
    return {"coord": mesh.coord, "rel_l2": errs, "counts": counts,
            "finite": all(bool(torch.isfinite(x).all()) for x in logits),
            "drops": int(sum(int(d) for d in drops)),
            "experts_held": int(params["layers"]["experts"]["w_up"].shape[1]),
            "sliced_bytes": sliced_bytes(params, places, mesh),
            "prefill_collectives": stats[0], "decode_step_collectives": stats[1],
            "draw_s": draw_s, "generate_s": gen_s,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def run_mesh_ep(dev, torch) -> dict:
    """(b) Expert parallelism: the yardstick (one rank, all 128 experts)
    then the world of 2."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import moe
    from repro_torch.serve.step import zeros_cache

    c = MESH_EP
    t0 = time.perf_counter()
    cfg, api, params = mesh_model(c["arch"], c["depth"], "bfloat16", dev, torch)
    tokens, steps = mesh_tokens(c["batch"], c["prompt"], c["steps"], cfg.vocab, 8)
    cache = zeros_cache(cfg, api, c["batch"], c["prompt"] + c["steps"], device=dev)
    factor, moe.CAPACITY_FACTOR = moe.CAPACITY_FACTOR, c["capacity_factor"]
    try:
        with moe.dropped_assignments() as drops:
            yard = [x.cpu() for x in mesh_generate(
                cfg, api, params, tokens, steps, cache, lambda t: torch.from_numpy(t).to(dev))]
        yard_drops = int(sum(int(d) for d in drops))
    finally:
        moe.CAPACITY_FACTOR = factor
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    yard_s = time.perf_counter() - t0
    store = mesh_store("ep")
    torch.save(yard, store.parent / "yard.pt")
    t0 = time.perf_counter()
    res = spawn_world(mesh_ep_rank, 2, "cuda", store, (str(store.parent / "yard.pt"), tokens,
                                                       steps))
    world_s = time.perf_counter() - t0
    want = 2 * c["depth"] * (1 + c["steps"])  # gate/up and down a layer a forward
    bad = []
    for r in res:
        if not r["finite"] or max(r["rel_l2"]) > BF16_TOL:
            bad.append(f"expert parallelism on rank {r['coord']}: logits rel L2 "
                       f"{max(r['rel_l2']):.3g} (tol {BF16_TOL}), finite {r['finite']}")
        if r["counts"].get("moe_gemm", 0) != want or r["experts_held"] != cfg.n_experts // 2:
            bad.append(f"expert parallelism on rank {r['coord']}: moe_gemm launched "
                       f"{r['counts'].get('moe_gemm', 0)} times (want {want}), "
                       f"{r['experts_held']} experts held")
    return {"world": 2, "mesh": {"model": 2}, "yardstick_s": yard_s, "yardstick_drops": yard_drops,
            "world_s": world_s, "moe_gemm_launches_per_rank": want, "ranks": res}, bad


def mesh_dp_rank(rank, world, dev, batches):
    """(c) on a rank of the (data 2) world: qwen1.5-4b in float32 compute.
    Rank 0 first runs the yardstick alone: the global batch on one rank
    split as the world splits it, into 2 microbatches of the data ranks'
    rows (the same products on the same rows, summed the same way), two
    steps; beside it, printed, the first step's gradients of the batch as
    1 microbatch (the random stack parts the two by summation order alone:
    ROADMAP.md C11).  Then the world steps twice with ZeRO-1 off and again
    on from the same state.  A step's gradients are read where
    ``make_train_step`` averages them (``reduce_over_batch``), and every
    comparison runs on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import rank_batch, to_device
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.models import get_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train import step as train_step
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_config(MESH_DP["arch"]), n_layers=MESH_DP["depth"],
                              kernel_impl="cuda", compute_dtype="float32")
    api = get_model(cfg)
    real, first = train_step.reduce_over_batch, []

    def reduce_over_batch(loss, grads, mesh):  # keeps a step's averaged gradients
        loss, grads = real(loss, grads, mesh)
        if not first:
            first.append([g.clone() for g in grads])
        return loss, grads

    train_step.reduce_over_batch = reduce_over_batch

    def steps(c, state, bs, mesh=None):
        fn = make_train_step(c, api, mesh=mesh)
        losses, stats, secs = [], [], []
        for b in bs:
            if mesh is not None:
                mesh.reset_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fn(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            if mesh is not None:
                stats.append(mesh.reset_stats())
        return state, losses, stats, secs

    out = {}
    if rank == 0:
        S.set_current_mesh(None)
        split = dataclasses.replace(cfg, microbatches=world)
        state, _ = build_state(split, api, dev, 0)
        whole = [to_device(b, dev) for b in batches]
        _, one_mb = loss_and_grads(api, cfg, state["params"], whole[0])
        state, yard_losses, _, _ = steps(split, state, whole)
        yard_grads = first.pop()
        out["witness_one_vs_two_microbatches"] = tree_rel_l2(one_mb, yard_grads)
        del state, whole
        gc.collect()
        torch.cuda.empty_cache()
    mesh = make_mesh((2, 1), ("data", "model"), dev)
    S.set_current_mesh(mesh)
    entries = {"tokens": ("batch", None)}
    after = None
    for zero1 in (False, True):
        c = dataclasses.replace(cfg, zero1=zero1)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _ = build_state(c, api, dev, 0, mesh)
        loc = [rank_batch(b, mesh, entries, dev) for b in batches]
        first.clear()
        state, losses, stats, secs = steps(c, state, loc, mesh)
        rec = {"losses": losses, "step_s": secs, "step_collectives": stats[-1],
               "m_shape": tuple(tree_leaves(state["opt"]["m"])[0].shape)}
        if rank == 0 and not zero1:
            grads = first.pop()
            rec["grads_rel_l2"] = tree_rel_l2(grads, yard_grads)
            rec["grads_bitwise"] = all(torch.equal(a, b) for a, b in zip(grads, yard_grads))
            rec["grads_rel_l2_one_microbatch"] = tree_rel_l2(grads, one_mb)
            rec["loss_rel"] = [abs(a - b) / abs(b) for a, b in zip(losses, yard_losses)]
            del grads
        params = tree_leaves(state["params"])
        if after is None:
            after = [p.clone() for p in params]
        else:
            rec["params_bitwise_zero1_off"] = all(torch.equal(a, b) for a, b in zip(after, params))
        rec.update(peak_bytes=torch.cuda.max_memory_allocated(),
                   seconds=time.perf_counter() - t0)
        out[f"zero1_{zero1}"] = rec
        del state, loc, params
        gc.collect()
        torch.cuda.empty_cache()
    return {"coord": mesh.coord, **out}


def run_mesh_dp(dev, torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import spawn_world

    c = MESH_DP
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["depth"])
    ds = SyntheticTokens(cfg, c["batch"], c["seq"], seed=0)
    batches = [next(ds) for _ in range(c["steps"])]
    t0 = time.perf_counter()
    res = spawn_world(mesh_dp_rank, 2, "cuda", mesh_store("dp"), (batches,))
    world_s = time.perf_counter() - t0
    r0 = res[0]
    off = r0["zero1_False"]
    bad = []
    if max(off["loss_rel"]) > MESH_LOSS_REL:
        bad.append(f"data parallelism: losses off the yardstick's by {off['loss_rel']} (tol "
                   f"{MESH_LOSS_REL})")
    if off["grads_rel_l2"] > MESH_GRAD_REL:
        bad.append(f"data parallelism: all-reduced gradients rel L2 "
                   f"{off['grads_rel_l2']:.3g} (tol {MESH_GRAD_REL})")
    for r in res:
        if not r["zero1_True"]["params_bitwise_zero1_off"]:
            bad.append(f"ZeRO-1's parameters on rank {r['coord']} differ from the replicated "
                       f"update's")
    return {"world": 2, "mesh": {"data": 2}, "world_s": world_s, "ranks": res}, bad


def mesh_elastic_rank(rank, world, dev, ckpt, store):
    """(d) on a rank of the (data 2) world: whisper-tiny through the
    launcher, checkpointed after 2 steps; rank 1 is then lost and rank 0
    rebuilds alone with ``ElasticRunner``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, to_device
    from repro_torch.distributed.elastic import ElasticRunner
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import make_train_step, state_spec

    torch.cuda.reset_peak_memory_stats()
    r = launch_train.main(MESH_ELASTIC_ARGV + ["--ckpt", ckpt])
    out = {"rank": rank, "losses": r["losses"], "train_s": r["seconds"],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if rank != 0:
        torch.distributed.destroy_process_group()  # the lost rank leaves
        return out
    args = launch_train.parse_args(MESH_ELASTIC_ARGV)
    cfg = dataclasses.replace(get_config(args.arch), kernel_impl=args.kernel)
    api = get_model(cfg)
    runner = ElasticRunner(cfg, api, step_factory=make_train_step, ckpt_dir=ckpt, model_par=1,
                           device=dev.type,
                           state_spec_fn=lambda c, plan: state_spec(c, api.param_spec(c, 1)))
    t0 = time.perf_counter()
    mesh, restored, extra = runner.on_failure([0], f"file://{store}")
    out["restore_s"] = time.perf_counter() - t0
    out["restored_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(r["state"]["params"]), tree_leaves(restored["params"])))
    ds = SyntheticTokens(cfg, args.batch, args.seq, seed=args.seed)
    ds.seek(extra["data_cursor"])
    _, m = runner.step_fn(restored, to_device(next(ds), mesh.device))
    out.update(cursor=extra["data_cursor"], world_after=dict(mesh.shape),
               next_loss=float(m["loss"]), backend_after=torch.distributed.get_backend())
    return out


def run_mesh_elastic(dev, torch) -> dict:
    from repro_torch.launch.mesh import spawn_world

    store = mesh_store("elastic")
    t0 = time.perf_counter()
    res = spawn_world(mesh_elastic_rank, 2, "cuda", store,
                      (str(store.parent / "ckpt"), str(store.parent / "store_survivors")))
    world_s = time.perf_counter() - t0
    r0 = res[0]
    bad = []
    if not r0["restored_bitwise"] or r0["cursor"] != 2 or not math.isfinite(r0["next_loss"]) \
            or r0["world_after"] != {"data": 1, "model": 1}:
        bad.append(f"elastic restart: restored bitwise {r0['restored_bitwise']}, cursor "
                   f"{r0['cursor']}, next loss {r0['next_loss']}, world {r0['world_after']}")
    if not all(math.isfinite(x) for r in res for x in r["losses"]):
        bad.append(f"elastic restart: a loss is not finite: {[r['losses'] for r in res]}")
    return {"world": 2, "mesh": {"data": 2}, "world_s": world_s, "ranks": res}, bad


# (e) and (f): tensor parallelism over "model" at full width, one world of
# 2 ranks running both in turn.
MESH_TP = ({"name": "e", "arch": "qwen1.5-4b", "depth": 4, "scheme": "heads", "seed": 11},
           {"name": "f", "arch": "recurrentgemma-2b", "depth": 3, "scheme": "qheads",
            "seed": 12})
MESH_TP_GEN = {"batch": 8, "prompt": 256, "steps": 16}
MESH_TP_TRAIN = {"arch": "qwen1.5-4b", "depth": 2, "batch": 4, "seq": 512}


@contextlib.contextmanager
def row_split():
    """One rank's row-parallel products split at the two ranks' boundary,
    each half its own launch and the halves added: the sums a world of 2
    computes, in the same order (``layers.row_parallel`` wrapped)."""
    from repro_torch.models import layers as L

    real = L.row_parallel

    def split(x, w, impl, mesh, bias=None):
        if mesh is not None:
            return real(x, w, impl, mesh, bias)
        k = w.shape[0] // 2
        y = (L.linear(x[..., :k].contiguous(), w[:k], impl)
             + L.linear(x[..., k:].contiguous(), w[k:], impl))
        return y if bias is None else y + bias

    L.row_parallel = split
    try:
        yield
    finally:
        L.row_parallel = real


def digest(tensors) -> str:
    """A hash of the tensors' bits (their float32 values, in order)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_layer_inputs(cfg, api, params, tokens, torch) -> tuple:
    """(each layer's input, each layer's output cotangent, the final
    hidden state, the cotangent of layer 0's input) of the train loss on
    one rank, float32, as ``train_layer_errors`` takes them."""
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    order = T.stack_order(params, None, cfg)
    with torch.no_grad():
        x, xs = T.embed_tokens(params, tokens, cfg), []
        for apply, lp, _ in order:
            xs.append(x)
            x, _ = apply(lp, x, pos, cfg, mode="train", cache=None)
    xf = x.detach().requires_grad_()
    g = torch.autograd.grad(T.lm_loss(params, xf, *T.next_token_targets(tokens), cfg), xf)[0]
    gs = [g]
    for i in reversed(range(len(order))):
        apply, lp, _ = order[i]
        (gx,), _ = layer_vjp(lambda lp, x: T.remat(apply, cfg)(lp, x, pos, cfg, mode="train",
                                                               cache=None)[0],
                             lp, [xs[i]], gs[0], tokens.device, torch)
        gs.insert(0, gx)
    return xs, gs[1:], xf.detach(), gs[0]


def tp_outer_grads(cfg, params, xf, g0, tokens, torch) -> dict:
    """The gradients of the leaves outside the layer stack, by key: the
    VJP of the loss at the final hidden state ``xf`` (``final_norm`` and
    the head) and of the embedding at ``g0``, the cotangent of layer 0's
    input; on a model rank, of the slices it holds, through the
    vocab-parallel embedding, head and loss."""
    from repro_torch.models import transformer as T

    keys = [k for k in params if k != "layers"]
    leaves = {k: params[k].detach().requires_grad_() for k in keys}
    p = dict(params, **leaves)
    with torch.enable_grad():
        loss = T.lm_loss(p, xf, *T.next_token_targets(tokens), cfg)
        x0 = T.embed_tokens(p, tokens, cfg)
        gs = torch.autograd.grad([loss, x0], [leaves[k] for k in keys], [None, g0])
    return dict(zip(keys, gs))


def leaf_gaps(a: list, b: list, paths: list, top: int = 4) -> dict:
    """The ``top`` largest rel L2 gaps of gradient list ``a`` to ``b``, by
    key path, a stacked leaf layer by layer (``path[i]``)."""
    gaps = {}
    for x, y, path in zip(a, b, paths):
        if path.startswith("layers/"):
            gaps.update({f"{path}[{i}]": rel_l2(x[i], y[i]) for i in range(x.shape[0])})
        else:
            gaps[path] = rel_l2(x, y)
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:top])


def tp_layer_grads(cfg, params, xs, gs, tokens, torch) -> list:
    """Each layer's parameter gradients (``tree_leaves`` order) at its
    input ``xs[i]`` and output cotangent ``gs[i]``: on a model rank, of
    the leaves it holds, through the tensor-parallel block."""
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    out = []
    for (apply, lp, _), x, g in zip(T.stack_order(params, None, cfg), xs, gs):
        out.append(layer_vjp(lambda lp, x: T.remat(apply, cfg)(lp, x, pos, cfg, mode="train",
                                                               cache=None)[0],
                             lp, [x], g, tokens.device, torch)[1])
    return out


def mesh_tp_train(rank, world, dev, mesh, batch, layer_file, torch) -> dict:
    """(e)'s train step on a rank: qwen1.5-4b at depth 2, float32 compute.
    First each layer's VJP through the tensor-parallel block, at the one
    rank's layer inputs and output cotangents (``layer_file``), its
    parameter gradients held against the one rank's slices of them; and
    the leaves outside the stack (:func:`tp_outer_grads`: the
    vocab-parallel embedding, ``final_norm`` and the head through the
    vocab-parallel loss) at the one rank's final hidden state and layer 0's
    input cotangent, held against the one rank's VJP there, drawn and
    taken on this rank with no mesh, and sliced.  Then rank 0 takes one
    rank's step of the same batch (the yardstick, kept on the card) and
    the world its step: the loss, the batch-averaged gradients gathered
    whole against the yardstick's (printed with the leaves that part most:
    summation order alone parts them, ROADMAP.md C11), and a digest of the
    leaves every rank holds whole after AdamW."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import rank_batch, to_device
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.sharding import axes_of
    from repro_torch.launch.train import build_state
    from repro_torch.models import get_model
    from repro_torch.models.params import tree_leaves, tree_map_path
    from repro_torch.train import make_train_step
    from repro_torch.train import step as train_step

    c = MESH_TP_TRAIN
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["depth"], kernel_impl="cuda",
                              compute_dtype="float32")
    api = get_model(cfg)
    real, seen = train_step.reduce_over_batch, []

    def reduce_over_batch(loss, grads, m):  # keeps the step's averaged gradients
        loss, grads = real(loss, grads, m)
        seen.append([g.clone() for g in grads])
        return loss, grads

    train_step.reduce_over_batch = reduce_over_batch
    out, yard = {}, None
    try:
        places = train_step.state_placements(cfg, api, mesh)[1]["params"]
        ref = torch.load(layer_file)
        tokens = to_device(batch, dev)["tokens"]
        xf, g0 = ref["xf"].to(dev), ref["g0"].to(dev)
        S.set_current_mesh(None)
        state, _ = build_state(cfg, api, dev, 0)
        outer = {k: S.rank_slice(g, places[k], mesh).clone() for k, g in
                 tp_outer_grads(cfg, state["params"], xf, g0, tokens, torch).items()}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        S.set_current_mesh(mesh)
        state, _ = build_state(cfg, api, dev, 0, mesh)
        got = tp_layer_grads(cfg, state["params"], [x.to(dev) for x in ref["xs"]],
                             [g.to(dev) for g in ref["gs"]], tokens, torch)
        lpl = tree_leaves(places["layers"])
        out["layer_rel_l2"] = [max(rel_l2(a, S.rank_slice(b.to(dev), sh[1:], mesh))
                                   for a, b, sh in zip(mine, want, lpl))
                               for mine, want in zip(got, ref["grads"])]
        out["outer_rel_l2"] = {k: rel_l2(g, outer[k]) for k, g in
                               tp_outer_grads(cfg, state["params"], xf, g0, tokens, torch).items()}
        del state, got, ref, outer
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            S.set_current_mesh(None)
            state, _ = build_state(cfg, api, dev, 0)
            _, m = make_train_step(cfg, api, mesh=None)(state, to_device(batch, dev))
            yard, yard_loss = seen.pop(), float(m["loss"])
            del state
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        S.set_current_mesh(mesh)
        torch.cuda.reset_peak_memory_stats()
        state, _ = build_state(cfg, api, dev, 0, mesh)
        places = train_step.state_placements(cfg, api, mesh)[1]["params"]
        gc.collect()
        torch.cuda.empty_cache()
        mesh.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = make_train_step(cfg, api, mesh=mesh)(
            state, rank_batch(batch, mesh, {"tokens": ("batch", None)}, dev))
        torch.cuda.synchronize()
        out.update(step_s=time.perf_counter() - t0, collectives=mesh.reset_stats(),
                   loss=float(m["loss"]), peak_bytes=torch.cuda.max_memory_allocated(),
                   sliced_bytes=sliced_bytes(state["params"], places, mesh))
        pl = tree_leaves(places)
        grads = [S.gather_leaf(g, sh, mesh) for g, sh in zip(seen.pop(), pl)]
        if yard is not None:
            out["grads_rel_l2"] = tree_rel_l2(grads, yard)
            out["grads_rel_l2_top_leaves"] = leaf_gaps(
                grads, yard, tree_leaves(tree_map_path(lambda p, _: p, state["params"])))
            out["loss_rel"] = abs(out["loss"] - yard_loss) / abs(yard_loss)
        whole = [p for p, sh in zip(tree_leaves(state["params"]), pl)
                 if not any("model" in axes_of(r) for r in sh)]
        out["replicated_digest"] = digest(whole)
        out["replicated_leaves"] = len(whole)
    finally:
        train_step.reduce_over_batch = real
    return out


def mesh_tp_rank(rank, world, dev, yard_file, inputs, train_batch, layer_file):
    """(e) and (f) on a rank of the (model 2) world: each model drawn whole
    one rank at a time and its slices kept (``state_placements``), then
    prefill and the teacher-forced decode steps with the launch counts and
    the collectives read, the logits gathered whole over the vocabulary
    and held against the yardstick's and, bitwise, the row-split one
    rank's; then (e)'s train step (:func:`mesh_tp_train`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.step import zeros_cache
    from repro_torch.train.step import state_placements

    yard = torch.load(yard_file)
    mesh = make_mesh((2,), ("model",), dev)
    S.set_current_mesh(mesh)
    out = {"coord": mesh.coord}
    g = MESH_TP_GEN
    rows = lambda t: torch.from_numpy(t).to(dev)  # noqa: E731
    for case in MESH_TP:
        tokens, steps = inputs[case["name"]]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for r in range(world):
            if r == rank:
                cfg, api, full = mesh_model(case["arch"], case["depth"], "bfloat16", dev, torch)
                places = state_placements(cfg, api, mesh)[1]["params"]
                params = S.shard_tree(full, places, mesh)
                del full
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        draw_s = time.perf_counter() - t0
        cache = zeros_cache(cfg, api, g["batch"], g["prompt"] + g["steps"], device=dev,
                            mesh=mesh)
        stats = []
        ops.reset_launch_counts()
        mesh.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = mesh_generate_local(cfg, api, params, tokens, steps, cache, rows,
                                 lambda i: stats.append(mesh.reset_stats()))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        logits = [whole_logits(x, cfg) for x in local]
        want, split = yard[case["name"]]["yard"], yard[case["name"]]["split"]
        gaps = [float((a - b.to(dev)).abs().max()) for a, b in zip(logits, split)]
        out[case["name"]] = {
            "rel_l2": [rel_l2(a, b.to(dev)) for a, b in zip(logits, split)],
            "plain_rel_l2": [rel_l2(a, b.to(dev)) for a, b in zip(logits, want)],
            "split_bitwise": all(torch.equal(a, b.to(dev)) for a, b in zip(logits, split)),
            "split_max_gap": max(gaps), "digest": digest(logits),
            "finite": all(bool(torch.isfinite(x).all()) for x in logits),
            "counts": counts, "prefill_collectives": stats[0],
            "decode_step_collectives": stats[1], "draw_s": draw_s, "generate_s": gen_s,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "sliced_bytes": sliced_bytes(params, places, mesh), "q_heads_held": q_heads(params)}
        del params, cache, local, logits
        gc.collect()
        torch.cuda.empty_cache()
    out["train"] = mesh_tp_train(rank, world, dev, mesh, train_batch, layer_file, torch)
    return out


def q_heads(params) -> int:
    """The q heads a rank holds of the first attention layer's ``wq``."""
    from repro_torch.models.params import tree_map_path

    found = []
    tree_map_path(lambda p, t: found.append(t) if p.endswith("wq") else None, params)
    return int(found[0].shape[-2])


def mesh_tp_want(case) -> dict:
    """A rank's launches in (e) or (f): one prefill and the decode steps
    at the rank's width (the kernels' count, not their size)."""
    g = MESH_TP_GEN
    forwards = 1 + g["steps"]
    if case["arch"] == "qwen1.5-4b":
        n = case["depth"]
        att = {"flash_attention": n, "flash_decode": n * g["steps"]}
    else:  # one (rec, rec, attn) unit
        att = {"flash_attention": 1, "flash_decode": g["steps"], "rglru_scan": 2}
    return {**att, **{k: v for k, v in row_kernel_launches(case["arch"], forwards,
                                                           case["depth"]).items() if v}}


def run_mesh_tp(dev, torch) -> tuple:
    """(e) and (f): the yardsticks first (one rank, teacher-forced, bf16:
    the row-split run, :func:`row_split`, which the world is held to, and
    the unsplit one, printed), then the world of 2."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.serve.step import zeros_cache

    g = MESH_TP_GEN
    t0 = time.perf_counter()
    yard, inputs = {}, {}
    for case in MESH_TP:
        cfg, api, params = mesh_model(case["arch"], case["depth"], "bfloat16", dev, torch)
        tokens, steps = mesh_tokens(g["batch"], g["prompt"], g["steps"], cfg.vocab, case["seed"])
        inputs[case["name"]] = (tokens, steps)
        rows = lambda t: torch.from_numpy(t).to(dev)  # noqa: E731
        runs = {}
        for label in ("yard", "split"):
            cache = zeros_cache(cfg, api, g["batch"], g["prompt"] + g["steps"], device=dev)
            with row_split() if label == "split" else contextlib.nullcontext():
                runs[label] = [x.cpu() for x in mesh_generate(cfg, api, params, tokens, steps,
                                                              cache, rows)]
            del cache
        yard[case["name"]] = runs
        del params
        gc.collect()
        torch.cuda.empty_cache()
    c = MESH_TP_TRAIN
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["depth"], kernel_impl="cuda",
                              compute_dtype="float32")
    train_batch = next(SyntheticTokens(cfg, c["batch"], c["seq"], seed=0))
    from repro_torch.launch.train import build_state
    from repro_torch.models import get_model

    api = get_model(cfg)
    state, _ = build_state(cfg, api, dev, 0)
    tokens = torch.from_numpy(train_batch["tokens"]).to(dev)
    xs, gs, xf, g0 = tp_layer_inputs(cfg, api, state["params"], tokens, torch)
    grads = tp_layer_grads(cfg, state["params"], xs, gs, tokens, torch)
    store = mesh_store("tp")
    torch.save({"xs": [x.cpu() for x in xs], "gs": [g.cpu() for g in gs], "xf": xf.cpu(),
                "g0": g0.cpu(), "grads": [[t.cpu() for t in layer] for layer in grads]},
               store.parent / "layers.pt")
    del state, xs, gs, xf, g0, grads
    gc.collect()
    torch.cuda.empty_cache()
    yard_s = time.perf_counter() - t0
    torch.save(yard, store.parent / "yard.pt")
    t0 = time.perf_counter()
    res = spawn_world(mesh_tp_rank, 2, "cuda", store, (str(store.parent / "yard.pt"), inputs,
                                                        train_batch,
                                                        str(store.parent / "layers.pt")))
    world_s = time.perf_counter() - t0
    bad = []
    for case in MESH_TP:
        n = case["name"]
        want = mesh_tp_want(case)
        if res[0][n]["digest"] != res[1][n]["digest"]:
            bad.append(f"({n}) the two model ranks' logits differ")
        for r in res:
            x = r[n]
            if not x["finite"] or max(x["rel_l2"]) > BF16_TOL:
                bad.append(f"({n}) rank {r['coord']}: logits rel L2 {max(x['rel_l2']):.3g} "
                           f"(tol {BF16_TOL}), finite {x['finite']}")
            if x["counts"] != want:
                bad.append(f"({n}) rank {r['coord']}: launches {x['counts']} != {want}")
    tr = [r["train"] for r in res]
    if tr[0]["replicated_digest"] != tr[1]["replicated_digest"]:
        bad.append("(e) train: the leaves held whole differ across the ranks after AdamW")
    if tr[0]["loss_rel"] > MESH_LOSS_REL:
        bad.append(f"(e) train: loss rel {tr[0]['loss_rel']:.3g} (tol {MESH_LOSS_REL})")
    for r in res:
        if max(r["train"]["layer_rel_l2"]) > MESH_GRAD_REL:
            bad.append(f"(e) train rank {r['coord']}: a layer's parameter gradients rel L2 "
                       f"{r['train']['layer_rel_l2']} (tol {MESH_GRAD_REL})")
        if not r["train"]["outer_rel_l2"] or max(r["train"]["outer_rel_l2"].values()) \
                > MESH_GRAD_REL:
            bad.append(f"(e) train rank {r['coord']}: the embedding's, final norm's or head's "
                       f"gradients rel L2 {r['train']['outer_rel_l2']} (tol {MESH_GRAD_REL})")
    return {"world": 2, "mesh": {"model": 2}, "yardstick_s": yard_s, "world_s": world_s,
            "ranks": res}, bad


def mesh_fail(bad: list) -> None:
    """Fail on a world's problems, after its lines are printed."""
    if bad:
        fail("[mesh] " + "; ".join(bad))


def gib(n) -> str:
    return f"{n / 2**30:.2f} GiB"


def run_mesh_phase(dev, torch, card) -> dict:
    """The [mesh] phase: (a) the seq-sharded decode, (b) expert
    parallelism on moe_gemm, both with their dense leaves tensor-parallel,
    (c) data parallelism with ZeRO-1, (d) the elastic restart, (e) and (f)
    tensor parallelism of qwen1.5-4b and recurrentgemma-2b; each world's
    ranks compute on cuda:0 over gloo."""
    from repro_torch.launch.mesh import backend_for

    print(at() + f" [mesh] worlds of ranks on cuda:0, backend {backend_for('cuda', 2)} "
          f"({torch.cuda.device_count()} card(s): NCCL needs a card a rank); {card}", flush=True)
    out = {}
    c = MESH_SEQ
    print(at() + f" [mesh] (a) seq-sharded decode, {c['arch']} at full width, depth "
          f"{c['depth']}, its dense leaves tensor-parallel (the heads scheme); world 4 (data 2, "
          f"model 2); B {c['batch']}, prompt {c['prompt']}, "
          f"cache {c['cache']}, {c['steps']} decode steps; bf16 then float32", flush=True)
    a, bad = run_mesh_seq(dev, torch)
    out["seq_decode"] = a
    def r3(xs):
        return [float(f"{x:.3g}") for x in xs]

    for r in a["ranks"]:
        print(f"  rank {r['coord']}: " + "; ".join(
            f"{dt} teacher-forced logits rel L2 a call {r3(r[dt]['logits_rel_l2'])} (to the "
            f"unsplit run {r3(r[dt]['plain_logits_rel_l2'])}), attention "
            f"a step (worst layer) {r3(r[dt]['attention_rel_l2'])} (tol {MESH_LOGITS_REL[dt]}), "
            f"peak {gib(r[dt]['peak_bytes'])}, sliced leaves {gib(r[dt]['sliced_bytes'][0])} "
            f"of {gib(r[dt]['sliced_bytes'][1])}, {r[dt]['seconds']:.1f} s, collectives a decode "
            f"step {[n / c['steps'] for n in r[dt]['collectives']['all_reduce']]} (all_reduce "
            f"count, bytes; all_gather {[n / c['steps'] for n in r[dt]['collectives']['all_gather']]}"
            f"), the prefill's {r[dt]['prefill_collectives']}" for dt in MESH_LOGITS_REL),
              flush=True)
    print(f"  witness, printed: one rank's free-running logits, kernel_impl 'reference' against "
          f"'cuda', rel L2 a call " + "; ".join(
              f"{dt} {r3(w)}" for dt, w in a["witness_free_running_logits_rel_l2"].items()),
          flush=True)
    print(f"  yardstick {a['yardstick_s']:.1f} s, world {a['world_s']:.1f} s", flush=True)
    mesh_fail(bad)
    c = MESH_EP
    print(at() + f" [mesh] (b) expert parallelism, {c['arch']} at full width, depth "
          f"{c['depth']}; world 2 (model 2), 64 experts a rank on moe_gemm, the dense leaves "
          f"tensor-parallel (wo and the dense MLP's w_down row-parallel, so the logits are held "
          f"to a tolerance); {c['batch']} x "
          f"{c['prompt']} prefill + {c['steps']} decode steps, capacity factor "
          f"{c['capacity_factor']}", flush=True)
    b, bad = run_mesh_ep(dev, torch)
    out["expert_parallel"] = b
    for r in b["ranks"]:
        print(f"  rank {r['coord']}: max rel L2 {max(r['rel_l2']):.3g} (tol {BF16_TOL}), "
              f"launches {r['counts']}, dropped {r['drops']} (yardstick {b['yardstick_drops']}), "
              f"peak {gib(r['peak_bytes'])}, sliced leaves {gib(r['sliced_bytes'][0])} of "
              f"{gib(r['sliced_bytes'][1])}, draw {r['draw_s']:.1f} s, generate "
              f"{r['generate_s']:.2f} s, prefill collectives {r['prefill_collectives']}, a "
              f"decode step's {r['decode_step_collectives']}", flush=True)
    print(f"  yardstick {b['yardstick_s']:.1f} s, world {b['world_s']:.1f} s", flush=True)
    mesh_fail(bad)
    c = MESH_DP
    print(at() + f" [mesh] (c) data parallelism, {c['arch']} at full width, depth {c['depth']}, "
          f"float32 compute; world 2 (data 2); global batch {c['batch']} x {c['seq']}, "
          f"{c['steps']} steps, ZeRO-1 off then on; held against one rank's step of the global "
          f"batch in 2 microbatches (the data ranks' rows)", flush=True)
    d, bad = run_mesh_dp(dev, torch)
    out["data_parallel"] = d
    for r in d["ranks"]:
        for z in ("zero1_False", "zero1_True"):
            x = r[z]
            print(f"  rank {r['coord']} {z}: losses {x['losses']}, step "
                  f"{[round(s, 3) for s in x['step_s']]} s, m slice {x['m_shape']}, peak "
                  f"{gib(x['peak_bytes'])}, a step's collectives {x['step_collectives']}"
                  + (f", gradients rel L2 {x['grads_rel_l2']:.3g} (tol {MESH_GRAD_REL}), "
                     f"losses rel {[float(f'{v:.3g}') for v in x['loss_rel']]} (tol "
                     f"{MESH_LOSS_REL})" if "grads_rel_l2" in x else "")
                  + (", parameters bitwise the replicated update's"
                     if x.get("params_bitwise_zero1_off") else ""), flush=True)
    w = d["ranks"][0]
    off = w["zero1_False"]
    print(f"  against one rank's gradients of the same batch in 1 microbatch, printed: rel L2 "
          f"{off['grads_rel_l2_one_microbatch']:.3g}; the witness, one rank's 1 against 2 "
          f"microbatches: {w['witness_one_vs_two_microbatches']:.3g}; the world's gradients "
          f"bitwise the 2-microbatch step's: {off['grads_bitwise']}", flush=True)
    print(f"  world {d['world_s']:.1f} s", flush=True)
    mesh_fail(bad)
    print(at() + " [mesh] (d) elastic restart, whisper-tiny --full through "
          "repro_torch.launch.train on a world of 2 (data 2), checkpoint after 2 steps, then "
          "ElasticRunner.on_failure onto a world of 1 and one more step", flush=True)
    e, bad = run_mesh_elastic(dev, torch)
    out["elastic"] = e
    mesh_fail(bad)
    r0 = e["ranks"][0]
    print(f"  losses {[r['losses'] for r in e['ranks']]}; restored bitwise, cursor "
          f"{r0['cursor']}, world {r0['world_after']} ({r0['backend_after']}), next loss "
          f"{r0['next_loss']:.4f}; peaks {[gib(r['peak_bytes']) for r in e['ranks']]}; restore "
          f"{r0['restore_s']:.1f} s, world {e['world_s']:.1f} s", flush=True)
    wit = d["ranks"][0]["witness_one_vs_two_microbatches"]
    g, c = MESH_TP_GEN, MESH_TP_TRAIN
    print(at() + f" [mesh] (e) tensor parallelism, qwen1.5-4b at full width, depth 4 of 40, the "
          f"heads scheme, and (f) recurrentgemma-2b at full width, depth 3 (rec, rec, attn), the "
          f"qheads scheme at hd 256, window 2048, rglru_scan on 1280 of 2560 channels, the tied "
          f"head over 128000 of 256000 tokens; one world of 2 (model 2) running both, bf16, "
          f"{g['batch']} x {g['prompt']} prefill + {g['steps']} teacher-forced decode steps "
          f"each, held against one rank's run with its row-parallel products split at the "
          f"ranks' boundary and the halves added (bitwise where gloo's bf16 sum is torch's; "
          f"rel L2, tol {BF16_TOL}), the unsplit one rank's printed; then (e)'s float32 train "
          f"step at depth {c['depth']}, each layer's VJP and the embedding's, final norm's "
          f"and head's held against one rank's, {c['batch']} x {c['seq']}", flush=True)
    t, bad = run_mesh_tp(dev, torch)
    out["tensor_parallel"] = t
    for case in MESH_TP:
        n = case["name"]
        for r in t["ranks"]:
            x = r[n]
            print(f"  ({n}) {case['arch']} rank {r['coord']}: {x['q_heads_held']} q heads held; "
                  f"against the row-split one rank: bitwise {x['split_bitwise']}, max gap "
                  f"{x['split_max_gap']:.3g}, logits rel L2 a call max {max(x['rel_l2']):.3g} "
                  f"(tol {BF16_TOL}); against the unsplit one rank, printed: rel L2 a call "
                  f"{[float(f'{v:.3g}') for v in x['plain_rel_l2']]}; launches {x['counts']} (want "
                  f"{mesh_tp_want(case)}); peak {gib(x['peak_bytes'])}, sliced leaves "
                  f"{gib(x['sliced_bytes'][0])} of {gib(x['sliced_bytes'][1])}; draw "
                  f"{x['draw_s']:.1f} s, generate {x['generate_s']:.2f} s; prefill collectives "
                  f"{x['prefill_collectives']}, a decode step's {x['decode_step_collectives']} "
                  f"(count, bytes)", flush=True)
        same = t["ranks"][0][n]["digest"] == t["ranks"][1][n]["digest"]
        print(f"  ({n}) the two ranks' logits bitwise equal: {same}", flush=True)
    for r in t["ranks"]:
        x = r["train"]
        print(f"  (e) train rank {r['coord']}: each layer's parameter gradients through the "
              f"tensor-parallel block, at one rank's layer inputs and output cotangents, rel L2 "
              f"{[float(f'{v:.3g}') for v in x['layer_rel_l2']]}, the leaves outside the "
              f"stack at one rank's final hidden state and layer 0's input cotangent "
              f"{ {k: float(f'{v:.3g}') for k, v in x['outer_rel_l2'].items()} } (tol "
              f"{MESH_GRAD_REL}); the step's loss {x['loss']:.6f}"
              + (f" (rel {x['loss_rel']:.3g} to one rank's, tol {MESH_LOSS_REL}), its whole "
                 f"gradients rel L2 {x['grads_rel_l2']:.3g} to one rank's, printed (summation "
                 f"order alone: one rank's 1 against 2 microbatches in (c), {wit:.3g}; C11), "
                 f"the leaves that part most "
                 f"{ {k: float(f'{v:.3g}') for k, v in x['grads_rel_l2_top_leaves'].items()} }"
                 if "grads_rel_l2" in x else "")
              + f", step {x['step_s']:.2f} s, peak {gib(x['peak_bytes'])}, sliced leaves "
                f"{gib(x['sliced_bytes'][0])} of {gib(x['sliced_bytes'][1])}, collectives "
                f"{x['collectives']}, {x['replicated_leaves']} leaves held whole", flush=True)
    print(f"  (e) train: the leaves held whole bitwise equal on both ranks after AdamW: "
          f"{t['ranks'][0]['train']['replicated_digest'] == t['ranks'][1]['train']['replicated_digest']}; "
          f"yardsticks {t['yardstick_s']:.1f} s, world {t['world_s']:.1f} s", flush=True)
    mesh_fail(bad)
    return out


def summary_row(path: str, rec: dict) -> dict:
    """A one-shot path's row of the ``[graph]`` table: its profiled prefill
    and 8 decode steps (busy and wall, eager and graphed), its one-shot
    tokens/s both ways and its capture seconds."""
    prof, om = rec["profile"], rec["oneshot_modes"]
    return {"path": path,
            **{f"{p}_{k}_{m}": prof[r][k]
               for p, m, r in (("decode_8", "eager", "decode_8_steps"),
                               ("decode_8", "graph", "decode_8_steps_graph"),
                               ("prefill", "eager", "prefill"),
                               ("prefill", "graph", "prefill_graph"))
               for k in ("device_busy_ms", "wall_ms")},
            "tokens_per_s_eager": om["eager"]["tokens_per_s"],
            "tokens_per_s_graph": om["graph"]["tokens_per_s"],
            "capture_s": om["graph"]["capture_s"]}


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)

    if "--host-us" in sys.argv[1:]:
        # Only the wrappers' host time, of the src/ beside this script (run a
        # copy of it from another checkout's root to compare two trees).
        from repro_torch.kernels import gemm
        from repro_torch.kernels import rms_norm as rn

        print(host_us(dev, torch, gemm, rn), flush=True)
        return
    if "--mesh" in sys.argv[1:]:
        # Only the [mesh] phase, its kernels built in this process before
        # any rank starts (the ranks load them).
        from repro_torch.kernels import _build

        _build.build(MESH_KERNELS)
        print(json.dumps({"mesh": run_mesh_phase(dev, torch, card)}))
        print(at() + " [done] the [mesh] phase passed", flush=True)
        return
    if "--examples" in sys.argv[1:]:
        # Only the [examples] phase and the granite-34b kernel cases.
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.models import attention as attn

        t0 = time.perf_counter()
        _build.build()
        print(at() + f" [build] {time.perf_counter() - t0:.1f} s", flush=True)
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        for case in attention_cases():
            if case[0] == GRANITE_PREFILL:
                run_attention_case(case, dev, flush, torch, F, ops, fa)
        for case in decode_cases():
            if case[0] == GRANITE_DECODE:
                run_decode_case(case, dev, flush, torch, F, ops, fd, attn)
        del flush
        print(json.dumps({"examples": run_examples_phase(dev, torch, card)}))
        print(at() + " [done] the [examples] phase passed", flush=True)
        return
    if "--train" in sys.argv[1:]:
        # Only the [train] phase, its one kernel built alone.
        from repro_torch.kernels import _build, ops

        _build.build(("flash_attention",))
        print(json.dumps({"train_path": run_train_phase(dev, torch, F, ops, card, True)}))
        print(at() + " [done] the [train] phase passed", flush=True)
        return

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import gemm
    from repro_torch.kernels import layer_norm as ln
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import attention as attn

    t0 = time.perf_counter()
    out = _build.build(ptxas_info=True)
    print(f"[build] {len(out)} kernel libraries built in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}", flush=True)
    for name, text in out.items():
        for line in text.splitlines():
            if "Used" in line and "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    if "ssm_scan" not in out:
        print("[ptxas] ssm_scan was built before this run: no ptxas output", flush=True)
    for inst, regs, spills in ssm_ptxas(out.get("ssm_scan")):
        print(f"[ptxas] ssm_scan_kernel<{inst}>: {regs} registers; {spills}", flush=True)
    sm_clock_hz = max_sm_clock_hz()

    print(at() + " [chunk plan] flash_decode / flash_decode_paged, bf16 tensor-core body: a slot's "
          "needed tiles in chunks of " + ", ".join(
              f"{_build.chunk_tiles(bk)} tiles at block_k {bk}" for bk in (128, 64, 32, 16))
          + f" ({_build.CHUNK_KEYS} keys; set by block_k alone), grid (KV, B, chunks)",
          flush=True)
    print(at() + " [kernels] kernel vs plain version on the card", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    recs = {}
    for case in attention_cases():
        rec = run_attention_case(case, dev, flush, torch, F, ops, fa)
        recs.setdefault("flash_attention", rec)
        if case[0] == PALIGEMMA_PREFIX:
            recs["flash_attention_prefix"] = rec
    for case in decode_cases():
        rec = run_decode_case(case, dev, flush, torch, F, ops, fd, attn)
        recs.setdefault("flash_decode", rec)
    for case in paged_cases():
        rec = run_paged_case(case, dev, flush, torch, F, ops, fd, attn)
        recs.setdefault("flash_decode_paged", rec)
    print(at() + " [chunk] flash_decode's chunk launch (chunked prefill's rows) against its plain "
          "version and, bitwise, flash_attention's prefill rows", flush=True)
    for case in chunk_cases():
        rec = run_chunk_case(case, dev, flush, torch, F, ops, fd, attn)
        if case[0] == MAIN_CHUNK_CASE:
            recs["flash_decode_chunk"] = rec
    print(at() + " [verify] speculative verify rows (Sq = k + 1) of flash_decode and "
          "flash_decode_paged against their one-row launches at pos + j, bitwise, and their "
          "plain versions", flush=True)
    for case in verify_cases():
        rec = run_verify_case(case, dev, flush, torch, F, ops, fd, attn)
        if case[0] == DRAFT_MAIN:
            recs["flash_decode_verify"] = rec
        elif case[0] == PAGED_VERIFY_MAIN:
            recs["flash_decode_paged_verify"] = rec
    for case in scan_cases():
        rec = run_scan_case(case, dev, flush, torch, ops, ss, rg, sm_clock_hz)
        recs.setdefault(case[0], rec)
    print(at() + " [gemm] the row-invariant GEMM and rms_norm against their plain versions "
          "(torch.matmul and PyTorch's mean), their timings beside cuBLAS and F.rms_norm, "
          "and the rows' batch invariance", flush=True)
    for case in gemm_cases():
        rec = run_gemm_case(case, dev, flush, torch, gemm)
        recs.setdefault("gemm_rowinv", rec)
    for case in rms_norm_cases():
        rec = run_rms_norm_case(case, dev, flush, torch, rn)
        recs.setdefault("rms_norm", rec)
    for case in layer_norm_cases():
        rec = run_layer_norm_case(case, dev, flush, torch, ln)
        recs.setdefault("layer_norm", rec)
    run_row_checks(dev, torch, gemm, rn)
    run_layer_norm_rows(dev, torch, ln)
    print(host_us(dev, torch, gemm, rn), flush=True)
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    launches = {}  # each kernel's count on the first main path that runs it
    summary = {"main_paths": [], "served_paths": []}  # the [graph] phase's table
    for arch, requests, prompt_len, gen, want, modes in main_paths():
        print(at() + f" [main path] repro_torch.launch.serve one-shot generate, {arch} --full, "
              f"{requests} x {prompt_len} + {gen}", flush=True)
        argv = ["--arch", arch, "--full", "--requests", str(requests), "--prompt-len",
                str(prompt_len), "--gen", str(gen), "--seed", "0", "--kernel", "cuda"]
        mp = run_main_path(argv, dev, torch, modes)
        counts = mp.pop("counts")
        print(f"  launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"{arch} main path launch counts {counts} != {want}")
        for mode in modes:
            if mp[f"layer_rel_l2_max_bf16_{mode}"] > LAYER_REL_TOL:
                fail(f"{arch}: a bf16 {mode} layer through the kernels disagrees with the "
                     f"reference")
        if not mp["first_token_is_prefill_argmax"]:
            fail(f"{arch}: generate's first token is not the argmax of its prefill logits")
        print(json.dumps({"main_path": mp}))
        summary["main_paths"].append(summary_row(f"{arch} {requests} x {prompt_len} + {gen}",
                                                 mp))
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
              flush=True)

    a9_counts = {}
    for arch, requests, prompt_len, gen, want in a9_paths():
        print(at() + f" [a9 path] repro_torch.launch.serve one-shot generate, {arch} --full, "
              f"{requests} x {prompt_len} + {gen}", flush=True)
        argv = ["--arch", arch, "--full", "--requests", str(requests), "--prompt-len",
                str(prompt_len), "--gen", str(gen), "--seed", "0", "--kernel", "cuda"]
        ap = run_a9_path(argv, dev, torch)
        counts = ap.pop("counts")
        print(f"  launches {counts} (want {want})", flush=True)
        if counts != want:
            fail(f"{arch} path launch counts {counts} != {want}")
        print(json.dumps({"a9_path": ap}))
        summary["main_paths"].append(summary_row(f"{arch} {requests} x {prompt_len} + {gen}",
                                                 ap))
        a9_counts[arch] = want
        if arch == "paligemma-3b":
            launches["flash_attention_prefix"] = counts["flash_attention"]
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)
        del ap
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
              flush=True)

    for arch, depth in MOE_PATHS:
        print(at() + f" [moe path] {arch} at full width, depth {depth}, bf16", flush=True)
        mo, counts, rec = run_moe_path(arch, depth, dev, torch)
        print(json.dumps({"moe_path": mo}))
        recs.setdefault("moe_gemm", rec)
        if "profile" in mo:
            summary["main_paths"].append(summary_row(f"{arch} (depth {depth}) 8 x 256 + {GEN}",
                                                     mo))
            summary["served_paths"].append((f"{arch} served, arrivals 1 ms apart",
                                            mo["served"]["modes"]))
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)
        del mo
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
              flush=True)

    with served_depth():
        depth = f"qwen1.5-4b --full at depth {SERVED_DEPTH} of 40"
        print(at() + f" [served path] repro_torch.launch.serve --server --paged, {depth}, "
              f"8 x 256 + {GEN}, block_len 16, seg_len 8, max_batch 8", flush=True)
        sp, counts, whole = run_served_path(dev, torch)
        print(json.dumps({"served_path": sp}))
        summary["served_paths"].append(("whole prompt, arrivals 1 ms apart", sp["modes"]))
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
              flush=True)

        print(at() + f" [chunked served path] repro_torch.launch.serve --server --paged --chunk-len "
              f"{CHUNK_LEN}, {depth}, 8 x 256 + {GEN}, block_len 16, seg_len 8, "
              f"arrivals at 4/s, beside whole-prompt serving of the same arrivals; then "
              f"contiguous --chunk-len 40, 4 requests", flush=True)
        cp, counts = run_chunked_paths(dev, torch, whole)
        print(json.dumps({"chunked_served_path": cp}))
        summary["served_paths"] += [("whole prompt, arrivals at 4/s", cp["whole_prompt"]["modes"]),
                                    ("chunked (64), the same arrivals", cp["chunked"]["modes"]),
                                    ("contiguous chunked (40), 4 requests",
                                     cp["contiguous_chunk40"]["modes"])]
        launches["flash_decode_chunk"] = counts["flash_decode"]
        gc.collect()
        torch.cuda.empty_cache()

        print(at() + f" [spec served path] repro_torch.launch.serve --server --paged --draft self "
              f"--draft-k {SPEC_K}, {depth}, 8 x 256 + {GEN}, block_len 16, seg_len 8, "
              f"arrivals 1 ms apart; a weak 4-layer draft through the server API (contiguous); "
              f"--draft self --chunk-len {CHUNK_LEN}; --draft self --spec-gate", flush=True)
        spp, counts = run_spec_paths(dev, torch, whole, sp)
        print(json.dumps({"spec_served_path": spp}))
        summary["served_paths"] += [
            ("self-draft k 2, paged", spp["self_draft_paged"]["modes"]),
            ("weak 4-layer draft, contiguous, 4 requests", spp["weak_draft_contiguous"]["modes"]),
            ("self-draft k 2, chunks of 64", spp["self_draft_chunked_paged"]["modes"]),
            ("self-draft k 2, --spec-gate", spp["self_draft_gated_paged"]["modes"])]
        launches["flash_decode_verify"] = counts["multi_row"]["flash_decode"]
        launches["flash_decode_paged_verify"] = counts["multi_row"]["flash_decode_paged"]
        gc.collect()
        torch.cuda.empty_cache()

        print(at() + f" [multigroup] run A: repro_torch.launch.serve --server --paged --groups 2 "
              f"--scheduler hguided --drain-after 4 --verify --http-port 0, {depth}, "
              f"8 x 256 + {GEN}, block_len 16, seg_len 8, arrivals 1 ms apart, a lone request "
              f"boarding after 1 ms; run B: "
              f"InferenceServer, contiguous, ForceMigrate, {MULTIGROUP_B_SLOTS} slots; groups "
              f"pod-a (power 2) and pod-b (power 1), two streams of cuda:0, graphed", flush=True)
        mg = run_multigroup_paths(dev, torch, whole, card)
        print(json.dumps({"multigroup": mg}))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
              flush=True)

        print(at() + f" [coexec] repro_torch.launch.serve --coexec --scheduler hguided --verify, "
              f"{depth}, 8 x 256 + {GEN}, groups pod-a (power 2) and pod-b (power 1) "
              f"on cuda:0", flush=True)
        cx = run_coexec_path(dev, torch)
    print(json.dumps({"coexec_path": cx}))
    summary["coexec"] = {m: {k: cx[m][k] for k in ("tokens_per_s", "wall_s", "balance")}
                         for m in MODES}
    gc.collect()
    torch.cuda.empty_cache()
    print(at() + f" [coexec] repro_torch.launch.serve --coexec --scheduler hguided --verify, "
          f"whisper-tiny --full, {WHISPER_B} x {WHISPER_PROMPT} + {WHISPER_GEN} (the frames a "
          f"Program input beside the tokens), graphed, groups pod-a and pod-b on cuda:0",
          flush=True)
    wx = run_coexec_path(dev, torch, WHISPER_COEXEC_ARGV, a9_counts["whisper-tiny"],
                         ("graph",))
    print(json.dumps({"whisper_coexec_path": wx}))
    gc.collect()
    torch.cuda.empty_cache()
    print(at() + " [coexec] the paper's Listing 1 (examples/quickstart_torch.py) on "
          "discover(DeviceMask.ALL) under HGuided(adaptive=True)", flush=True)
    print(json.dumps({"listing1": run_listing1(torch)}))
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"examples": run_examples_phase(dev, torch, card)}))

    print(at() + " [train] flash_attention's autograd Function at the train paths' shapes "
          "(bf16): forward == the kernel bitwise, dq/dk/dv against autograd through "
          "flash_attention_plain, times beside sdpa's forward + backward", flush=True)
    print(json.dumps({"train_path": run_train_phase(dev, torch, F, ops, card)}))
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"mesh": run_mesh_phase(dev, torch, card)}))

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:145"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:195"),
               # The chunk launch of flash_decode.cu: the JAX package's
               # chunk rows call the same pallas_call at its prefill tile.
               "flash_decode_chunk": ("src/repro_torch/csrc/flash_decode.cu",
                                      "src/repro/kernels/flash_decode.py:195"),
               # The decode kernels' multi-row launches (Sq > 1), the mode
               # of the JAX package's speculative step (serve/step.py:252).
               "flash_decode_verify": ("src/repro_torch/csrc/flash_decode.cu",
                                       "src/repro/kernels/flash_decode.py:195"),
               "flash_decode_paged": ("src/repro_torch/csrc/flash_decode_paged.cu",
                                      "src/repro/kernels/flash_decode.py:282"),
               "flash_decode_paged_verify": ("src/repro_torch/csrc/flash_decode_paged.cu",
                                             "src/repro/kernels/flash_decode.py:282"),
               "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:66"),
               "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                              "src/repro/kernels/rglru_scan.py:52"),
               # No pallas_call: the JAX package's jnp products and norm.
               "gemm_rowinv": ("src/repro_torch/csrc/gemm_rowinv.cu",
                               "src/repro/models/layers.py:195"),
               "rms_norm": ("src/repro_torch/csrc/rms_norm.cu",
                            "src/repro/models/layers.py:15"),
               "layer_norm": ("src/repro_torch/csrc/layer_norm.cu",
                              "src/repro/models/layers.py:22"),
               # flash_attention's prefix-LM mode: the JAX package computes
               # it in plain jnp (models/attention.py:108), never through
               # its pallas_call.
               "flash_attention_prefix": ("src/repro_torch/csrc/flash_attention.cu",
                                          "src/repro/models/attention.py:108"),
               "moe_gemm": ("src/repro_torch/csrc/moe_gemm.cu", MOE_REPLACES)}
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep, launches=launches[n],
                    **recs[n]) for n, (src, rep) in sources.items()]
    print_graph_summary(summary, card)
    print(at() + " [done] every phase passed", flush=True)
    print(card, flush=True)  # again, beside the numbers it qualifies
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
