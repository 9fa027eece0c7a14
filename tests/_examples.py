"""Helpers of the examples' tests: load a port example as a module, run a
reference example's own lines, run a port example as a script on the
CPU."""
import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_example(name: str):
    """The port's example ``examples/<name>.py`` as a module (its
    ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, stop: str = "") -> dict:
    """The namespace of the reference example ``examples/<name>.py`` after
    its top-level statements ran: all of them, or those before the first
    assignment to ``stop``."""
    path = ROOT / "examples" / f"{name}.py"
    body = ast.parse(path.read_text(), str(path)).body
    if stop:
        body = body[:next(i for i, node in enumerate(body) if isinstance(node, ast.Assign)
                          and any(getattr(t, "id", None) == stop for t in node.targets))]
    ns = {"__name__": f"reference_{name}"}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


def run_script(name: str, tmp_path, *args):
    """``examples/<name>.py --device cpu *args`` run as a script in
    ``tmp_path`` (the completed process)."""
    return subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"),
                           "--device", "cpu", *args],
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
