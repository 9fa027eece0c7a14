"""The port's one-shot generate and launcher vs the JAX package.

``make_generate`` must give the same greedy tokens as
``repro.serve.make_generate`` on the same weights and prompts (float32,
reduced configs): exact token equality, since the logits agree to ~1e-6
(tests/test_torch_model.py) and random weights leave no near-ties."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.launch import serve as launcher
from repro_torch.models import get_model
from repro_torch.models import params as tparams

CASES = [("qwen1.5-4b", "reference", "reference"),
         ("internlm2-20b", "reference", "reference"),
         ("internlm2-20b", "cuda", "pallas_interpret"),
         ("falcon-mamba-7b", "cuda", "pallas_interpret"),
         ("recurrentgemma-2b", "cuda", "pallas_interpret")]


@pytest.mark.parametrize("arch,timpl,jimpl", CASES,
                         ids=[f"{a}-{t}" for a, t, _ in CASES])
def test_generate_tokens_match_jax(arch, timpl, jimpl):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)), kernel_impl=jimpl)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), kernel_impl=timpl)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    jp = jparams.materialize(japi.param_spec(jcfg, 1), jax.random.PRNGKey(0), jnp.float32)
    tp = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    prompts = np.random.default_rng(2).integers(0, tcfg.vocab, (3, 8)).astype(np.int32)
    gen = 6
    want = np.asarray(jserve.make_generate(jcfg, japi)(jp, {"tokens": jnp.asarray(prompts)}, gen))
    got = tserve.make_generate(tcfg, tapi)(tp, {"tokens": torch.from_numpy(prompts)}, gen)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, gen)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cast_params_cached_casts_once():
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    p = tparams.materialize(get_model(cfg).param_spec(cfg), torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    a = tserve.cast_params_cached(p, torch.bfloat16)
    assert a is tserve.cast_params_cached(p, "bfloat16")
    assert a["embed"].dtype == torch.bfloat16 and p["embed"].dtype == torch.float32
    # A float32 tree needs no cast and is returned as is.
    assert tserve.cast_params_cached(p, torch.float32)["embed"] is p["embed"]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "internlm2-20b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_launcher_runs_on_cpu(arch, capsys):
    reset_launch_counts()
    out = launcher.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                         "--prompt-len", "8", "--gen", "3", "--seed", "1"])
    assert out["tokens"].shape == (2, 3)
    assert out["peak_memory_bytes"] is None
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
    # The default kernel_impl is "cuda": on CPU tensors the plain versions
    # run and no launch is counted.
    assert launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                               "flash_decode_paged": 0, "ssm_scan": 0,
                               "rglru_scan": 0, "gemm_rowinv": 0, "rms_norm": 0,
                               "moe_gemm": 0, "layer_norm": 0, "flash_attention_bwd": 0}
    again = launcher.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                           "--prompt-len", "8", "--gen", "3", "--seed", "1",
                           "--kernel", "reference"])
    np.testing.assert_array_equal(again["tokens"], out["tokens"])


def test_launcher_without_cuda_raises_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--arch", "qwen1.5-4b", "--requests", "1", "--prompt-len", "4",
                       "--gen", "2"])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_launcher_without_cuda_raises_for_recurrent_archs(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--arch", arch, "--requests", "1", "--prompt-len", "4", "--gen", "2"])
