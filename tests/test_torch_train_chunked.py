"""The train path the card takes for the recurrent families, on the CPU.

1. ``forward_train``'s loss and every gradient of falcon-mamba-7b and
   recurrentgemma-2b against the JAX package's at S 512: two 256-step
   chunks, the chunked log-step scans (the port's ``models/mamba.py`` and
   ``models/rglru.py`` chunk loops against the JAX package's ``lax.scan``
   over ``associative_scan`` chunks), where ``_train_parity``'s S 16
   takes the token-by-token scans.  Reduced widths, B 1, the JAX weights
   loaded through the port's loader, ``_train_parity``'s tolerances.  The
   JAX side runs "reference" for both port impls: its Pallas scans have
   no VJP, and the port trains on the reference scans under either.
   recurrentgemma's reduced window of 8 cuts keys in its attention layer.
2. The layer walk ``chip_smoke.py`` holds the card's per-layer gradients
   with (``train_walk``, ``train_layer_errors``, ``device_layer_errors``),
   for the ssm, hybrid and vlm families: composed layer after layer it is
   ``forward_train`` bitwise, and the reference against itself, or a
   device against itself, gives 0 at every layer."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _train_parity import GRAD_REL, LOSS_TOL, batch_of, port_loss_and_grads, rel_l2, weights
from repro.models import get_model as jax_get_model
from repro_torch import configs as tconfigs
from repro_torch.models import get_model
from repro_torch.models import params as tparams

S = 512  # two 256-step chunks


@functools.lru_cache(maxsize=None)
def jax_side(arch):
    """(JAX loss, gradient leaves and paths, numpy params, batch) at B 1 x S."""
    jcfg, jp, _ = weights(arch)
    jcfg = dataclasses.replace(jcfg, kernel_impl="reference")
    batch = batch_of(jcfg, b=1, s=S)
    loss, grads = jax.jit(jax.value_and_grad(jax_get_model(jcfg).forward_train),
                          static_argnums=2)(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                            jcfg)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(grads)[0]]
    return (float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)], paths,
            jax.tree_util.tree_map(np.asarray, jp), batch)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_chunked_train_loss_and_grads_match_jax(arch, impl):
    jloss, jgrads, paths, np_params, batch = jax_side(arch)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), kernel_impl=impl)
    assert S % 256 == 0 and S // 256 == 2
    if tcfg.window:
        assert tcfg.window < S
    loss, grads = port_loss_and_grads(tcfg, np_params, batch)
    assert abs(loss - jloss) <= LOSS_TOL
    assert len(grads) == len(jgrads)
    for path, g, j in zip(paths, grads, jgrads):
        assert g.shape == j.shape, path
        assert rel_l2(g, j) <= GRAD_REL, (path, rel_l2(g, j))


# The walk's families at the remat policy of each full config (the ssm
# family's "full", the others' "dots"); the recurrent ones at S 512.
WALK = [("falcon-mamba-7b", 1, S), ("recurrentgemma-2b", 1, S), ("paligemma-3b", 2, 16)]


def walk_case(arch, b, s, impl="cuda"):
    full = tconfigs.get_config(arch)
    cfg = dataclasses.replace(tconfigs.reduced(full), remat=full.remat, kernel_impl=impl)
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = tparams.materialize(api.param_spec(cfg), gen, torch.float32, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, b=b, s=s).items()}
    return cfg, api, params, batch


@pytest.mark.parametrize("arch,b,s", WALK)
def test_layer_walk_composes_forward_train_bitwise(arch, b, s):
    cfg, api, params, batch = walk_case(arch, b, s)
    want = api.forward_train(params, batch, cfg)
    p = tparams.cast_float(params, cfg.compute_dtype)
    x, layers, loss = chip_smoke.train_walk(cfg, p, batch)
    n_layers = cfg.n_layers if cfg.family != "hybrid" else (
        cfg.n_layers // len(cfg.block_pattern) + cfg.n_layers % len(cfg.block_pattern))
    assert len(layers) == n_layers
    xs, x, aux = chip_smoke.walk_forward(x, layers, torch)
    assert len(xs) == len(layers)
    got = loss(x, aux)
    assert torch.equal(got, want.detach()), (float(got), float(want))


@pytest.mark.parametrize("arch,b,s", WALK)
def test_layer_walk_reference_against_itself_is_zero(arch, b, s):
    cfg, api, params, batch = walk_case(arch, b, s, impl="reference")
    errs = chip_smoke.train_layer_errors(cfg, params, batch, torch)
    assert len(errs) == len(chip_smoke.train_walk(cfg, params, batch)[1])
    assert errs == [0.0] * len(errs)
    dev = chip_smoke.device_layer_errors(cfg, params, batch, torch.device("cpu"), torch)
    assert dev == dict.fromkeys(range(len(errs)), 0.0)
    assert chip_smoke.device_layer_errors(cfg, params, batch, torch.device("cpu"), torch,
                                          (0, -1)) == dict.fromkeys({0, len(errs) - 1}, 0.0)


@pytest.mark.parametrize("arch,b,s", WALK)
def test_layer_walk_kernels_within_the_card_tolerance(arch, b, s):
    """The "cuda" impl on CPU tensors (flash_attention's Function on its
    plain version) against the reference, layer by layer, within the
    card's 2e-2; exactly 0 where the family has no attention."""
    cfg, api, params, batch = walk_case(arch, b, s)
    errs = chip_smoke.train_layer_errors(cfg, params, batch, torch)
    assert max(errs) <= chip_smoke.TRAIN_REL_TOL, errs
    if cfg.family == "ssm":
        assert errs == [0.0] * len(errs)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b", "paligemma-3b",
                                  "qwen1.5-4b"])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(arch):
    """A train step frees its gradients when it returns: no tensor of it
    waits in a reference cycle for the garbage collector, which on the
    card kept 4 B a parameter alive into the graph capture that follows
    the first step (``params.tree_unflatten``'s recursive closure held
    the gradient list).  The first step runs before the audit: it imports
    what remat's checkpoint imports lazily."""
    import gc

    from repro_torch.launch.train import build_state
    from repro_torch.train import make_train_step

    full = tconfigs.get_config(arch)
    cfg = dataclasses.replace(tconfigs.reduced(full), remat=full.remat)
    api = get_model(cfg)
    state = build_state(cfg, api, "cpu", 0)[0]
    first, second = ({k: torch.from_numpy(v) for k, v in batch_of(cfg, seed=i).items()}
                     for i in (1, 2))
    step = make_train_step(cfg, api, graph=False)
    state, _ = step(state, first)
    gc.collect()
    gc.disable()
    try:
        state, m = step(state, second)
        del m
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, [tuple(t.shape) for t in cyclic]
