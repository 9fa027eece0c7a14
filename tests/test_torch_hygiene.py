"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the port's
example import neither jax nor the JAX package, and the whole package
imports with jax blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "examples" / name for name in ("quickstart_torch.py", "train_lm_torch.py",
                                          "hetero_train_torch.py")]
# Modules of the co-execution slice (the engine facade, the adaptive
# schedulers and the two row-invariant kernels' wrappers), of the
# multi-group slice (placement and migration, elastic groups, the
# observability endpoints), of the MoE slice (the block, the grouped
# expert GEMM's wrapper) and of the training slice (optimizer, train step,
# compression, heterogeneous trainer, data, checkpoints, launcher) and of
# the mesh slice (logical sharding, the mesh and its worlds, input specs),
# and of the tensor-parallel slice (the dry-run, the shape cells, the
# blocks computing on their slices, the greedy token across vocabulary
# slices).
SLICE_MODULES = ("core/engine.py", "core/scheduler/dynamic.py", "core/scheduler/hguided.py",
                 "kernels/gemm.py", "kernels/rms_norm.py", "serve/multigroup.py",
                 "distributed/elastic.py", "distributed/__init__.py", "serve/http.py",
                 "models/moe.py", "kernels/moe_gemm.py", "kernels/layer_norm.py",
                 "models/whisper.py", "configs/whisper_tiny.py", "configs/paligemma_3b.py",
                 "optim/__init__.py", "optim/adamw.py", "train/__init__.py", "train/step.py",
                 "train/compression.py", "train/hetero.py", "data/__init__.py",
                 "data/pipeline.py", "ckpt/__init__.py", "ckpt/checkpoint.py",
                 "launch/train.py", "distributed/sharding.py", "launch/mesh.py",
                 "launch/specs.py", "launch/dryrun.py", "configs/base.py", "models/layers.py",
                 "models/attention.py", "models/transformer.py", "models/mamba.py",
                 "models/rglru.py", "models/params.py", "serve/step.py")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_package_imports_with_jax_blocked():
    modules = sorted(".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
                     .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None  # any import of them raises\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [m for m, mod in sys.modules.items() if mod is not None\n"
            "          and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not loaded, loaded\n"
            "print('imported', len(" + repr(modules) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["imported", str(len(modules))]


def test_chip_smoke_refuses_without_cuda():
    """Without a card the script exits non-zero and prints no result line."""
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_train_phase_refuses_without_cuda():
    """``--train`` (the [train] phase alone) refuses likewise."""
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train"], env=env,
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr and '"train_path"' not in r.stdout


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_modules_are_checked(rel):
    """Each new module exists, is among the files checked above, and
    imports only torch, numpy, the standard library and the port."""
    path = PORT / rel
    assert path in FILES
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top in ("torch", "numpy", "repro_torch", "__future__") or \
            top in sys.stdlib_module_names, f"{rel} imports {mod}"


def test_kernel_sources_exist():
    """Every kernel the build knows has its CUDA source in the package."""
    from repro_torch.kernels import _build

    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file(), name
