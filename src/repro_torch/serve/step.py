"""Serving steps: prefill (prompt → cache), decode (one token, KV cache),
decode *chains* (N dependent tokens, device-resident), the chunked
prefill stage (``make_chunk_step``) and the greedy draft/verify step of
speculative decoding (``DraftSpec``, ``make_draft_verify_step``).

Params are cast to the compute dtype once (``cast_params_cached``) and the
cast copy is held beside the float32 masters for as long as they live: a
serving loop calls prefill/decode many times against the same parameters.

The KV cache is written in place; a cache passed to a step is updated and
returned, not copied (the JAX package donated it to the jitted step).

The decode chain and one-shot prefill run as CUDA graphs on the card
(``make_decode_chain(..., graph=True)``, ``make_generate``'s default):
captured once per shape and replayed, as the JAX package jits them
(``serve/graphs.py``), under a mesh too, as graphs between the mesh's
collectives.  ``graph=False`` is the eager loop, which CPU tensors always
run.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional

import torch

from repro_torch.core.trace import tracer
from repro_torch.distributed.sharding import current_mesh
from repro_torch.models import layers as L
from repro_torch.models.attention import pos_vector
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serve.graphs import GraphCache, same_storage

# (leaf ids, dtype) -> cast tree, dropped when any source leaf is collected.
_cast_cache: dict = {}


def _cast_float(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def cast_params_cached(tree, dtype):
    """``tree`` with floating leaves cast to ``dtype``, computed once per
    (tree, dtype) and kept until a source leaf is collected."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    leaves = tree_leaves(tree)
    key = (tuple(map(id, leaves)), str(dtype))
    hit = _cast_cache.get(key)
    if hit is not None:
        return hit
    out = _cast_float(tree, dtype)
    if all(o is i for o, i in zip(tree_leaves(out), leaves)):
        # No-op cast: caching would hold strong refs to the very leaves
        # whose death is the only eviction trigger.
        return out
    for leaf in leaves:
        weakref.finalize(leaf, _cast_cache.pop, key, None)
    _cast_cache[key] = out
    return out


def prefix_len(cfg) -> int:
    """Positions a prompt's prefill fills ahead of its tokens: the vlm
    family's ``n_patches`` image-patch embeddings, else none."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def check_context(cfg, prompt_len: int, gen: int) -> None:
    """Refuse a generate whose prompt and generated tokens outgrow the
    decoder's context cap (``max_decode_ctx``, whisper's 448): the JAX
    package's cache writes past it are dropped without a word."""
    if cfg.max_decode_ctx and prompt_len + gen > cfg.max_decode_ctx:
        raise ValueError(f"{cfg.name}: prompt {prompt_len} + gen {gen} > max_decode_ctx "
                         f"{cfg.max_decode_ctx}")


def _argmax_token(logits, cfg):
    """The greedy token of each row's last logits; over a mesh whose model
    ranks hold slices of the vocabulary, the whole row's argmax
    (``layers.vocab_argmax``)."""
    return L.vocab_argmax(logits[:, -1], cfg.vocab).to(torch.int32)[:, None]


def write_start(pos, cap: Optional[int], rows: int = 1):
    """The position a step of ``rows`` consecutive rows writes from, on a
    contiguous cache of ``cap`` positions (``None``: unclamped): ``pos``
    clamped to ``cap - rows``.  An exited slot keeps decoding garbage past
    its row's end, which the JAX scatter drops and ``index_put_`` would
    reject; clamped, its rows land at distinct entries of its own row, which
    the next joiner's write replaces.  A live slot never reaches the clamp:
    the server reserves every position its segments can write."""
    return pos if cap is None else torch.clamp(pos, max=cap - rows)


def make_prefill_step(cfg, api):
    def prefill_step(params, batch, cache):
        params = cast_params_cached(params, cfg.compute_dtype)
        logits, cache = api.prefill(params, batch, cfg, cache)
        return _argmax_token(logits, cfg), cache

    return prefill_step


def make_decode_step(cfg, api):
    """``(params, cache, token, pos) -> (token, cache)``; ``pos`` is a
    scalar or a (B,) per-slot position vector."""
    def decode_step(params, cache, token, pos):
        params = cast_params_cached(params, cfg.compute_dtype)
        logits, cache = api.decode(params, token, pos, cfg, cache)
        return _argmax_token(logits, cfg), cache

    return decode_step


def make_chunk_step(cfg, api, bucket: int, chunk_len: int):
    """One mixed-phase prefill-chunk stage over the whole batch (chunked
    prefill: the decode segment Program advances still-prefilling slots'
    cursors by ``chunk_len`` prompt tokens while other slots decode).

    ``chunk(params, cache, ptoks, pcur) -> (ctok, pcur', cache)`` where
    ``ptoks`` is the (B, bucket) padded-prompt buffer and ``pcur`` the
    (B, 1) prefill cursor (``pcur >= bucket``: the slot is decoding, all
    its rows arrive masked and its cache is untouched).  ``ctok`` is the
    argmax of the logits at each slot's final prompt row, the slot's first
    generated token, meaningful only for slots whose prefill completes this
    chunk (``pcur < bucket <= pcur'``); bitwise whole-prompt prefill's
    ``argmax(logits[:, -1])``.  Per-slot cursors stagger freely (paged
    prefix-cache hits skip whole blocks), so chunk tokens are gathered per
    slot with a clipped gather.  No host sync."""

    def chunk(params, cache, ptoks, pcur):
        params = cast_params_cached(params, cfg.compute_dtype)
        base = pcur[:, 0]  # (B,)
        positions = base[:, None] + torch.arange(chunk_len, dtype=torch.int32,
                                                 device=pcur.device)
        valid = positions < bucket
        idx = torch.clamp(positions, 0, bucket - 1).long()
        toks = torch.gather(ptoks, 1, idx)  # (B, chunk_len)
        last_idx = torch.clamp(bucket - 1 - base, 0, chunk_len - 1)
        logits, cache = api.prefill_chunk(params, toks, base, valid, cfg, cache, last_idx)
        return _argmax_token(logits, cfg), torch.clamp(pcur + chunk_len, max=bucket), cache

    return chunk


def zeros_cache(cfg, api, batch: int, max_seq: int, *, device, dtype=None, mesh=None):
    """Fresh empty KV cache honoring each leaf's declared init.

    The cache spec marks ``pos`` leaves ``neg_ones`` (−1 = empty slot):
    attention masks on recorded positions, so an all-zeros init would leave
    unwritten slots *valid* at position 0 and silently attend zero keys.

    Under a ``mesh``, the rank's slice of the cache of the global ``batch``
    (``distributed.sharding.rank_placements``): its batch rows and, under the
    seq-sharded decode, its part of the timeline, which the model axis
    must then divide."""
    dt = getattr(torch, dtype or cfg.compute_dtype)

    def mk(s):
        ldt = getattr(torch, s.dtype) if s.dtype else dt
        return torch.full(s.shape, _INIT_FILL.get(s.init, 0), dtype=ldt, device=device)

    if mesh is None:
        return tree_map(mk, api.cache_spec(cfg, batch, max_seq))
    from repro_torch.distributed.sharding import rank_placements
    from repro_torch.launch.mesh import model_par
    from repro_torch.models.attention import seq_mesh

    par = model_par(mesh)
    length = min(max_seq, cfg.window) if cfg.window else max_seq
    if seq_mesh(cfg, mesh) is not None and length % par:
        raise ValueError(f"a cache of {length} positions does not shard over a model "
                         f"axis of {par}")
    spec = api.cache_spec(cfg, batch, max_seq, par)
    return tree_map(mk, rank_placements(cfg, spec, mesh, "cache")[1])


_INIT_FILL = {"neg_ones": -1, "ones": 1}


def reset_cache(cfg, api, cache, batch: int, max_seq: int) -> None:
    """Refill ``cache`` (in place) with each leaf's declared init, as
    :func:`zeros_cache` makes it."""
    specs = tree_leaves(api.cache_spec(cfg, batch, max_seq))
    for leaf, s in zip(tree_leaves(cache), specs):
        leaf.fill_(_INIT_FILL.get(s.init, 0))


def cache_batch_axes(cfg, api, max_seq: int):
    """Per-leaf batch-axis index of the cache tree (layer-stacked leaves put
    batch at axis 1, not 0).  Found structurally — the axis whose extent
    tracks the requested batch size — so it holds across model families
    without a per-family table."""
    def ax(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"cache leaf {a.shape} has no batch axis: cannot slot it")

    return tree_map(ax, api.cache_spec(cfg, 1, max_seq), api.cache_spec(cfg, 2, max_seq))


def _unflatten(structure, leaves):
    """A tree of ``structure``'s shape with ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def make_decode_chain(cfg, api, *, graph: bool = False):
    """Multi-step greedy decode with device-resident handoff: ``n_steps``
    dependent decode steps whose tokens, positions and KV cache stay on the
    device, with no host synchronization per token.
    ``decode_chain(params, cache, token, pos, n_steps)`` returns
    ``(tokens[b, n_steps], last_token, cache)``; ``pos`` is the first
    step's position, an int or an int32 tensor on the device (a scalar or
    (B,)).

    ``graph=True`` (the JAX package's ``jax.jit(chain, static_argnums=(4,),
    donate_argnums=(1,))``): on CUDA tensors the chain is captured in a CUDA
    graph once per (n_steps, shapes, weights) and replayed
    (``serve/graphs.py``); an int ``pos`` becomes a device tensor outside
    the graph, so one graph serves every start position.  The cache is
    copied into the graph's static cache unless it is that cache, and the
    static cache is returned: as a donated JAX buffer, the cache passed in
    is consumed.  ``decode_chain.graphs`` is the GraphCache and
    ``decode_chain.capture(params, cache, token, pos, n_steps)`` captures
    without running."""
    decode = make_decode_step(cfg, api)

    def decode_chain(params, cache, token, pos, n_steps: int):
        b, dev = token.shape[0], token.device
        toks = torch.empty((b, n_steps), dtype=torch.int32, device=dev)
        posv = pos_vector(pos, b, dev)
        for i in range(n_steps):
            token, cache = decode(params, cache, token, posv + i)
            toks[:, i] = token[:, 0]
        return toks, token, cache

    if not graph:
        return decode_chain
    graphs = GraphCache()

    def loop(params, cache, token, pos, n_steps):
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), int(pos), dtype=torch.int32, device=token.device)
        inputs = {"token": token, "pos": pos.to(token.device, torch.int32),
                  "cache": tree_leaves(cache)}

        def body(st, n):
            toks, tok, _ = decode_chain(params, _unflatten(cache, st["cache"]), st["token"],
                                        st["pos"], n)
            return toks, tok

        return ("decode_chain", n_steps, (), inputs, body, (params,))

    def graphed_chain(params, cache, token, pos, n_steps: int, *, scope=None):
        if n_steps == 0 or not graphs.accepts(token.device):
            return decode_chain(params, cache, token, pos, n_steps)
        bound = graphs.bind(*loop(params, cache, token, pos, n_steps), scope)
        toks, tok = bound()
        return toks.clone(), tok.clone(), _unflatten(cache, bound.statics["cache"])

    def capture(params, cache, token, pos, n_steps: int, *, scope=None):
        graphs.capture(*loop(params, cache, token, pos, n_steps), scope)

    graphed_chain.graphs = graphs
    graphed_chain.capture = capture
    return graphed_chain


def make_generate(cfg, api, *, graph: bool = True):
    """One-shot batched generate: prefill + device-resident decode chain.

    Returned ``generate(params, batch, gen, *, cache=None)`` produces
    ``(b, gen)`` greedy int32 tokens on the tokens' device; ``cache``
    defaults to a fresh ``zeros_cache`` sized ``prefix + prompt_len + gen``
    (a caller-provided cache is consumed).  The chain starts at ``prefix +
    prompt_len``, where ``prefix`` is the vlm family's ``n_patches``
    (:func:`prefix_len`): the model functions' positions, which the JAX
    package's generate leaves out for that family (ROADMAP.md C9).  A
    prompt and ``gen`` past ``max_decode_ctx`` raise (:func:`check_context`).

    ``graph=True`` mirrors the JAX package's ``jit=True`` (its
    ``jax.jit(prefill, donate_argnums=(2,))`` and jitted chain): on the card,
    with ``cache=None`` and ``gen >= 2``, prefill and the chain each replay
    a CUDA graph of their own, captured at the shape's first call
    (``serve/graphs.py``), in a scope per (batch, prompt length, gen).  The
    prefill graph reads a static buffer of each batch leaf (the tokens,
    and the audio family's ``frames`` or the vlm family's ``patches``),
    refills the chain graph's static cache with its declared init and
    prefills it in place, and writes the chain's static token and start
    position; the chain then copies nothing in, so a call copies in only
    the batch's leaves.  A
    caller-provided cache, ``gen < 2``, CPU tensors and ``graph=False`` run
    prefill eagerly (the chain replays its graph wherever it takes CUDA
    tensors and ``graph=True``).  Under a mesh (the current one) the batch
    is the rank's rows and the cache (the prefill graph's static cache
    too) its slice, and greedy tokens are taken across the vocabulary's
    slices; both stages replay graphs all the same, recorded between the
    mesh's collectives (the argmax's over "model", the seq-sharded decode's
    combine, the tensor-parallel products' sums), each collective issued
    eagerly between two replays (``serve/graphs.Segments``).
    ``generate.prepare(params, batch, gen)``
    captures both graphs of that shape ahead of a timed call and returns the
    seconds it took (0 when nothing was captured); ``generate.graphs`` is
    their GraphCache (None when ``graph=False``); ``generate.prefill(params,
    batch, gen)`` and ``generate.chain`` are its two stages (the profiler
    times them apart).  Tracer spans
    ``generate.prefill`` (batch, seq) and ``generate.chain`` (steps) cover
    the host's share of each, as in the JAX package."""
    prefill = make_prefill_step(cfg, api)
    chain = make_decode_chain(cfg, api, graph=graph)
    graphs = chain.graphs if graph else None
    pre = prefix_len(cfg)

    def rank_cache(b: int, length: int, device):
        """A fresh cache of ``length`` positions for this rank's ``b``
        rows: under the current mesh the rank's slice of the global
        batch's cache."""
        from repro_torch.launch.mesh import data_par

        mesh = current_mesh()
        return zeros_cache(cfg, api, b * data_par(mesh), length, device=device, mesh=mesh)

    def prefill_loop(params, batch, st, like, gen: int):
        """The prefill graph's loop over (the batch's leaves, the chain's
        static cache, token and start position)."""
        names = sorted(batch)
        b, s = batch["tokens"].shape
        inputs = {"batch": [batch[n] for n in names], "cache": st["cache"],
                  "token": st["token"], "pos": st["pos"]}

        def body(bs, n):
            cache = _unflatten(like, bs["cache"])
            reset_cache(cfg, api, cache, b, pre + s + gen)
            tok, out = prefill(params, dict(zip(names, bs["batch"])), cache)
            for leaf, buf in zip(tree_leaves(out), bs["cache"]):
                if not same_storage(leaf, buf):  # every family writes in place
                    buf.copy_(leaf)
            bs["token"].copy_(tok)
            bs["pos"].fill_(pre + s)
            return ()

        return ("prefill", 1, (), inputs, body, (params,))

    def statics(params, batch, gen: int):
        """(scope, the static buffers, the cache's structure) of this
        shape's graphs, both captured first if new; None where prefill runs
        eagerly."""
        b, s = batch["tokens"].shape
        dev = batch["tokens"].device
        if graphs is None or gen < 2 or not graphs.accepts(dev):
            return None
        scope = ("generate", b, s, gen)
        like = rank_cache(b, pre + s + gen, "meta")
        names = sorted(batch)
        meta = {"batch": [torch.empty(batch[n].shape, dtype=batch[n].dtype, device="meta")
                          for n in names],
                "cache": tree_leaves(like),
                "token": torch.empty((b, 1), dtype=torch.int32, device="meta"),
                "pos": torch.empty((), dtype=torch.int32, device="meta")}
        st = graphs.statics(meta, dev, scope)
        chain.capture(params, _unflatten(like, st["cache"]), st["token"], st["pos"], gen - 1,
                      scope=scope)
        graphs.capture(*prefill_loop(params, dict(zip(names, st["batch"])), st, like, gen),
                       scope)
        return scope, st, like

    def run_prefill(params, batch, gen: int, cache=None):
        """generate's prefill: (first token, the chain's start position,
        the cache, the chain's keyword arguments), from the prefill graph
        where generate replays one."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        check_context(cfg, s, gen)
        graphed = statics(params, batch, gen) if cache is None else None
        if graphed is None:
            if cache is None:
                cache = rank_cache(b, pre + s + gen, tokens.device)
            tok, cache = prefill(params, batch, cache)
            return tok, pre + s, cache, {}
        scope, st, like = graphed
        graphs.bind(*prefill_loop(params, batch, st, like, gen), scope)()
        return st["token"], st["pos"], _unflatten(like, st["cache"]), {"scope": scope}

    def generate(params, batch, gen: int, *, cache=None):
        tr = tracer()
        b, s = batch["tokens"].shape
        with tr.span("generate.prefill", track="generate", batch=b, seq=s):
            tok, pos, cache, kw = run_prefill(params, batch, gen, cache)
        with tr.span("generate.chain", track="generate", steps=gen - 1):
            toks, _, _ = chain(params, cache, tok, pos, gen - 1, **kw)
        return torch.cat([tok, toks], dim=1)

    def prepare(params, batch, gen: int) -> float:
        check_context(cfg, batch["tokens"].shape[1], gen)
        before = graphs.capture_s if graphs is not None else 0.0
        statics(params, batch, gen)
        return (graphs.capture_s - before) if graphs is not None else 0.0

    generate.prepare = prepare
    generate.prefill = run_prefill
    generate.chain = chain
    generate.graphs = graphs
    return generate


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """Speculative-decoding draft model: a small config sharing the target's
    tokenizer/vocab, its own params, and the draft depth ``k`` (candidate
    tokens proposed per verify step).  ``k = 1`` is the shallowest useful
    draft: one candidate, 1–2 tokens emitted per step.

    ``auto_bypass=True`` arms the server's ``SpecGate``: segments run
    plain whenever the forecast speedup (tokens-per-step × measured
    plain/spec segment-time ratio) drops below 1, with periodic re-probes
    of the losing mode.  Off by default: an ungated spec server drafts
    every segment, which keeps drafted/accepted accounting deterministic."""

    cfg: Any
    params: Any
    k: int = 2
    auto_bypass: bool = False

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"draft k must be >= 1, got {self.k}")


def make_draft_verify_step(cfg, api, dcfg, dapi, k: int, *, prompt_len: int,
                           cap: Optional[int] = None):
    """One greedy speculative step: draft ``k`` candidates, verify all of
    them (plus the carried token) in a single multi-row decode, accept the
    longest matching prefix.

    ``step(params, dparams, cache, dcache, tok, ptok, pos)`` returns
    ``(y, cnt, tok', ptok', pos', cache, dcache)`` where ``y`` is (B, k+1)
    verified greedy tokens of which the first ``cnt`` (1..k+1 per slot,
    (B,) int32) are emitted this step; ``tok``/``ptok`` are (B, 1), the
    pending token at position ``pos`` and its predecessor at ``pos - 1``;
    ``pos`` is (B,) int32.  No host sync.

    Greedy acceptance keeps the emitted bits exact: row ``j`` of the verify
    attends the cache as sequential decode at ``pos + j`` would (its keys
    through ``pos + j`` are written before attention, deeper rows' keys sit
    beyond its mask), so ``y[:, j]`` is the token sequential decode gives,
    provided the attention row is bitwise its one-row launch (the port's
    kernels hold that, ``kernels/flash_decode.py``) and the products are
    row-invariant (``kernels/gemm.py``).  Whether the draft guessed right
    decides only how many rows are kept.  Rejected rows leave stale keys
    above ``pos'``; the next step's writes cover them before any row
    attends those positions.

    The draft cache rides the same timeline: the first draft step is a
    2-row decode of ``[ptok, tok]`` at ``pos - 1``, which both proposes the
    first candidate and repairs the draft-cache hole at ``pos - 1`` left
    when the previous step accepted every candidate.  A slot whose
    ``pos - 1`` lies in its prompt (``prompt_len``, the padded prompt's
    length) keeps that entry as its prefill (or chunk stage) wrote it: the
    re-decoded row would come from the decode path, not the prefill's, and
    the target's cache holds the prefill's bits there.  A self-draft then
    holds the target's cache bit for bit and accepts every candidate, where
    on a deep random-weight model that one difference alone makes its
    proposals near random.  The JAX package's step re-decodes ``pos - 1``
    always; the tokens the two steps emit are the same.

    ``cap`` (contiguous target or draft caches of ``cap`` positions) clamps
    where the step's rows write (:func:`write_start` of its k + 1 rows), so
    an exited slot's rows stay inside its own row; a live slot never
    reaches it (the server reserves ``seg_len * (k + 1)`` positions past
    its last segment's start)."""

    def step(params, dparams, cache, dcache, tok, ptok, pos):
        params = cast_params_cached(params, cfg.compute_dtype)
        dparams = cast_params_cached(dparams, dcfg.compute_dtype)
        bidx = torch.arange(tok.shape[0], device=tok.device)
        pw = write_start(pos, cap, k + 1)

        # Draft k candidates autoregressively (small model, k tiny).
        x0 = torch.cat([ptok, tok], dim=1)  # (B, 2) at pos-1, pos
        keep = torch.stack([pw - 1 < prompt_len, torch.zeros_like(pw, dtype=torch.bool)], dim=1)
        dc = dict(dcache, keep=keep[None].expand((dcfg.n_layers,) + tuple(keep.shape)))
        dlog, _ = dapi.decode(dparams, x0, pw - 1, dcfg, dc)
        ds = [_argmax_token(dlog, dcfg)]
        for j in range(1, k):
            dlog, dcache = dapi.decode(dparams, ds[-1], pw + j, dcfg, dcache)
            ds.append(_argmax_token(dlog, dcfg))
        drafts = torch.cat(ds, dim=1)  # (B, k)

        # One multi-row verify over [tok, d1..dk] at pos..pos+k.
        xs = torch.cat([tok, drafts], dim=1)  # (B, k+1)
        logits, cache = api.decode(params, xs, pw, cfg, cache)
        y = logits.argmax(dim=-1).to(torch.int32)  # (B, k+1)

        # Longest prefix of drafts matching the target's own greedy chain.
        match = (drafts == y[:, :k]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        cnt = (acc + 1).to(torch.int32)  # emitted tokens this step: y[:, :cnt]
        tok2 = y[bidx, acc][:, None]  # next pending token, at pos + cnt
        ptok2 = xs[bidx, acc][:, None]  # its predecessor, at pos + cnt - 1
        return y, cnt, tok2, ptok2, pos + cnt, cache, dcache

    return step
