"""The port's model examples (continuous_batching and serve_hetero
``_torch.py``) on the CPU: each runs as a script with ``--device cpu`` and
prints its checks true, and on the reference example's own float32
weights (its lines run here, the weights carried over with
``load_jax_params``) the port's tokens are the JAX package's: every
served stream equals the JAX ``make_generate`` of its prompt alone, and
both co-executed phases equal the reference example's ``generate`` of the
whole request batch."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _examples import load_example, run_reference, run_script
from repro.serve import make_generate as jax_make_generate
from repro_torch.models.params import load_jax_params

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,expect", [
    ("continuous_batching_torch", ["served 12/12 requests",
                                   "all results bit-identical to one-shot generate"]),
    ("serve_hetero_torch", ["phase 1: both pods healthy", "phase 2: pod-b degrades 4x",
                            "bit-identical to one-shot generate: True"]),
], ids=["continuous_batching", "serve_hetero"])
def test_model_example_runs_on_cpu(name, expect, tmp_path):
    r = run_script(name, tmp_path)
    assert r.returncode == 0, r.stderr
    for line in expect:
        assert line in r.stdout, (line, r.stdout)
    assert r.stdout.count("bit-identical to one-shot generate") == (
        2 if name == "serve_hetero_torch" else 1)


def _port_model(mod, ref):
    """The port example's config and model on the reference's weights."""
    cfg, api, _, _ = mod.model(device=CPU)
    params = load_jax_params(jax.tree_util.tree_map(np.asarray, ref["params"]), cfg, "cpu")
    return cfg, api, params


def test_continuous_batching_matches_jax_generate():
    """The port's server, on the reference's weights and prompts, streams
    each request as the JAX package's one-shot ``make_generate`` of that
    prompt alone (the port's own one-shot generate, bitwise, inside);
    ``around`` wraps the server's run, then the one-shot runs."""
    ref = run_reference("continuous_batching", stop="server")
    mod = load_example("continuous_batching_torch")
    cfg, api, params = _port_model(mod, ref)
    seen = []

    @contextlib.contextmanager
    def around(name):
        seen.append(name)
        yield
        seen.append("/" + name)

    got = mod.continuous_batching(cfg, api, params, CPU, around=around)
    assert seen == ["server", "/server", "one-shot", "/one-shot"]
    reference = jax_make_generate(ref["cfg"], ref["api"])
    assert len(got["results"]) == ref["N"] and got["stats"]["completed"] == ref["N"]
    for p, tp, res in zip(ref["prompts"], got["prompts"], got["results"]):
        np.testing.assert_array_equal(tp, p)
        want = np.asarray(reference(ref["params"], {"tokens": jnp.asarray(p[None])},
                                    ref["GEN"]))[0]
        np.testing.assert_array_equal(res, want)


def test_serve_hetero_matches_the_reference_generate():
    """Both phases' tokens of the port's two pods equal the reference
    example's ``generate`` of the 64 requests (reduced granite-34b, its
    weights), and every pod ran packages in each phase."""
    ref = run_reference("serve_hetero", stop="tokens")
    mod = load_example("serve_hetero_torch")
    cfg, api, params = _port_model(mod, ref)
    got = mod.serve_hetero(cfg, api, params, CPU)
    tokens = np.random.default_rng(0).integers(0, ref["cfg"].vocab,
                                               (ref["N_REQ"], ref["PLEN"])).astype(np.int32)
    np.testing.assert_array_equal(got["tokens"], tokens)
    want = np.asarray(ref["generate"](0, jnp.asarray(tokens)))
    assert want.shape == (ref["N_REQ"], ref["GEN"])
    np.testing.assert_array_equal(got["oneshot"], want)
    for name, ph in got["phases"].items():
        np.testing.assert_array_equal(ph["tokens"], want, err_msg=name)
        assert ph["bitwise"], name
        assert all(ph["packages"].values()), (name, ph["packages"])
        assert sum(sum(v) for v in ph["packages"].values()) == ref["N_REQ"]
