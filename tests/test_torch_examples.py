"""The port's runtime examples (pipeline_dataflow, async_coexec and
nbody_coexec ``_torch.py``) on the CPU: each runs as a script with
``--device cpu`` and prints its checks true, and the same inputs go
through the reference example's Programs, built with the JAX package's
``repro.core`` (its own lines, run here), and through the port's."""
import numpy as np
import pytest
import torch

from _examples import load_example, run_reference, run_script

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,expect", [
    ("pipeline_dataflow_torch", ["inferred deps: [0, 1, 1]", "correct: True",
                                 "iterative correct: True"]),
    ("async_coexec_torch", ["p1 correct: True  p2 correct: True", "iterative correct: True"]),
    ("nbody_coexec_torch", ["pos correct: True", "vel correct: True",
                            "iterative correct: True"]),
], ids=["pipeline_dataflow", "async_coexec", "nbody_coexec"])
def test_runtime_example_runs_on_cpu(name, expect, tmp_path):
    r = run_script(name, tmp_path)
    assert r.returncode == 0, r.stderr
    for line in expect:
        assert line in r.stdout, (line, r.stdout)


def test_pipeline_matches_the_reference():
    """The chain's inferred dependencies and the transfer stats of its
    group and of the iterative group (one group each: deterministic) are
    the reference's; the outputs agree."""
    ref = run_reference("pipeline_dataflow")
    got = load_example("pipeline_dataflow_torch").pipeline(CPU)
    assert got["deps"] == [len(h.deps) for h in ref["handles"]] == [0, 1, 1]
    assert got["transfer_stats"] == ref["group"].transfer_stats()
    assert got["transfer_stats"]["transfers"] == 1
    assert got["iter_stats"] == ref["g2"].transfer_stats()
    np.testing.assert_allclose(got["w"], ref["w"], atol=1e-5, rtol=0)
    assert got["correct"] and got["iter_correct"]


def test_async_coexec_matches_the_reference():
    """Both Programs' outputs and package counts are the reference's, and
    the iterative run hits the transfer cache on both groups, as the
    reference's does."""
    ref = run_reference("async_coexec")
    got = load_example("async_coexec_torch").async_coexec(CPU)
    np.testing.assert_allclose(got["y1"], ref["y1"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["y2"], ref["y2"], atol=1e-5, rtol=0)
    assert (got["p1_packages"], got["p2_packages"]) == (ref["h1"].metrics["n_packages"],
                                                         ref["h2"].metrics["n_packages"])
    assert got["p1_correct"] and got["p2_correct"] and got["iter_correct"]
    assert all(st["cache_hits"] > 0 for st in got["transfer_stats"].values())
    assert all(g.transfer_stats()["cache_hits"] > 0 for g in ref["engine"]._groups)


def test_nbody_matches_the_benchmark_kernel():
    """The port's bodies are the benchmark's; its positions and velocities
    after the first run (three groups, Static 8 % / 30 %) and after the
    three iterations agree with ``benchmarks.kernels.nbody_kernel`` stepped
    alone, the field frozen at t = 0, at atol 1e-3; every group took its
    share, and each group's transfer stats are those of the reference
    example."""
    import jax.numpy as jnp

    from benchmarks.kernels import make_nbody, nbody_kernel

    got = load_example("nbody_coexec_torch").nbody(CPU)
    bench = make_nbody(4096)
    for a, b in zip(got["start"], bench["ins"]):
        np.testing.assert_array_equal(a, b)
    dt, eps = bench["args"][1:]
    assert (np.float32(got["dt"]), np.float32(got["eps"])) == (dt, eps)
    apos = bench["args"][0]
    pos, vel = jnp.asarray(bench["ins"][0]), jnp.asarray(bench["ins"][1])
    for step in range(4):
        pos, vel = nbody_kernel(0, pos, vel, apos, dt, eps)
        if step == 0:
            np.testing.assert_allclose(got["first"][0], np.asarray(pos), atol=1e-3, rtol=0)
            np.testing.assert_allclose(got["first"][1], np.asarray(vel), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["last"][0], np.asarray(pos), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["last"][1], np.asarray(vel), atol=1e-3, rtol=0)
    share = got["summary"]["work_share"]
    assert share == pytest.approx({"cpu": 0.08, "phi": 0.3, "gpu": 0.62}, abs=0.01)
    ref = run_reference("nbody_coexec")
    assert got["transfer_stats"] == {g.name: g.transfer_stats() for g in ref["engine"]._groups}
