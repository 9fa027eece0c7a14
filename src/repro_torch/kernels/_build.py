"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with a plain C interface, into
``build/kernels/<name>-<hash>.so`` at the repository root (listed in
``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC --split-compile=8 \\
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The hash covers the sources and the flags, so an edited source builds anew.
:func:`build` starts one ``nvcc`` per missing library, all at once; each
splits its optimizer over up to 8 threads (``--split-compile``), which
takes flash_decode.cu's many attention instances from about 60 s to 25 s
on the H100's host.  Nothing
here runs at import: the CPU tests import every module without ``nvcc``.

Every wrapper counts its launches in :data:`LAUNCHES`, a plain integer per
kernel, incremented (:func:`count`, under a lock: co-executing groups launch
from their own worker threads) only where it launches its kernel.  While a
:func:`recording` is open on a thread (a CUDA graph's capture, which
launches nothing), that thread's counts go to the recording's
:class:`Tally` instead, and each replay of the graph adds the tally
(``serve/graphs.py``).  A recording opened on a capturing ``stream`` also
takes the launches that any other thread makes on that stream: a train
step's backward runs on the autograd engine's device thread, on the stream
its forward ran on.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=8")
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode", "flash_decode_paged",
           "ssm_scan", "rglru_scan", "gemm_rowinv", "rms_norm", "moe_gemm", "layer_norm")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' row and tile limits and shared-memory budget (attention_tile.cuh).
MAX_ROWS = 64
MAX_BLOCK_K = 128
MAX_SMEM = 232448
# The tensor-core tile body of the bfloat16 attention routes (attention_mma.cuh).
MMA_WARPS = 4
MMA_ROWS = 16 * MMA_WARPS  # query rows of one block
MMA_PAD = 8                # bf16 padding of a staged K/V/Q row
MMA_HEAD_DIMS = (64, 112, 128, 256)
CHUNK_KEYS = 256           # keys of one decode chunk

LAUNCHES = {name: 0 for name in KERNELS}
# Of those, the decode kernels' multi-row launches (Sq > 1: a speculative
# verify, or a draft's two-row first step).
MULTI_ROW = {"flash_decode": 0, "flash_decode_paged": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
_recording = threading.local()
# Raw stream handle -> the Tally of the recording open on that stream.
_stream_tallies: dict = {}


class Tally:
    """The launches counted while a recording was open: what one replay of
    the graph captured under it launches."""

    def __init__(self) -> None:
        self.launches: dict = {}
        self.multi_row: dict = {}

    def note(self, name: str, multi_row: bool) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        if multi_row:
            self.multi_row[name] = self.multi_row.get(name, 0) + 1

    def replayed(self) -> None:
        """Add one replay's launches to :data:`LAUNCHES` and
        :data:`MULTI_ROW`."""
        with _count_lock:
            for name, n in self.launches.items():
                LAUNCHES[name] += n
            for name, n in self.multi_row.items():
                MULTI_ROW[name] += n


@contextlib.contextmanager
def recording(stream=None):
    """Count this thread's launches into a fresh :class:`Tally` (yielded)
    instead of :data:`LAUNCHES` until the block ends; with a CUDA
    ``stream`` (the one a graph captures), also every other thread's
    launches onto it.  Other threads' launches onto other streams count as
    before."""
    tally, prev = Tally(), getattr(_recording, "tally", None)
    _recording.tally = tally
    handle = stream.cuda_stream if stream is not None else None
    prev_stream = _stream_tallies.get(handle)
    if handle is not None:
        _stream_tallies[handle] = tally
    try:
        yield tally
    finally:
        _recording.tally = prev
        if prev_stream is not None:
            _stream_tallies[handle] = prev_stream
        elif handle is not None:
            del _stream_tallies[handle]


def reset_launches() -> None:
    with _count_lock:
        for counts in (LAUNCHES, MULTI_ROW):
            for name in counts:
                counts[name] = 0


def count(name: str, multi_row: bool = False) -> None:
    """One launch of kernel ``name``, counted where the wrapper launched it
    (also in ``MULTI_ROW`` when it ran more than one query row a slot), or
    in the open recording's tally."""
    tally = getattr(_recording, "tally", None)
    if tally is None and _stream_tallies:
        tally = _stream_tallies.get(torch.cuda.current_stream().cuda_stream)
    if tally is not None:
        tally.note(name, multi_row)
        return
    with _count_lock:
        LAUNCHES[name] += 1
        if multi_row:
            MULTI_ROW[name] += 1


def smem_bytes(rows: int, hd: int, bk: int) -> int:
    """Dynamic shared memory of one block, as ``smem_bytes`` in the header."""
    return 4 * (2 * rows * hd + bk * (hd + 1) + rows * bk + 3 * rows) + 4 * bk


def mma_plan(rows: int, bk: int, hd: int):
    """How the tensor-core body splits a tile of ``bk`` keys for a block of
    ``rows`` query rows (in row groups of 16), as ``mma::plan`` in
    attention_mma.cuh: ``(ks, sb, kw)`` -- key parts, keys per stage (the
    largest of 64, 32, 16 dividing bk with kw = sb / ks keys per warp,
    kw <= 32 at hd > 128) -- or None when bk is not a multiple of 16."""
    rg = -(-rows // 16)
    rgp = 1 if rg <= 1 else 2 if rg <= 2 else 4
    kw_max = 32 if hd > 128 else 64
    for sb in (64, 32, 16):
        if bk % sb:
            continue
        ks = min(MMA_WARPS // rgp, sb // 16)
        if sb // ks <= kw_max:
            return ks, sb, sb // ks
    return None


def mma_smem_bytes(rows: int, bk: int, hd: int) -> int:
    """Dynamic shared memory of one tensor-core block (``mma::smem_bytes``):
    Q rows, the two-stage K/V ring (or the key parts' merge buffer, which
    reuses it), the staged key positions and the two stages' position spans."""
    ks, sb, _ = mma_plan(rows, bk, hd)
    q = (MMA_ROWS // ks) * (hd + MMA_PAD) * 2
    ring = 4 * sb * (hd + MMA_PAD) * 2
    merge = MMA_WARPS * 16 * (hd + 2) * 4 if ks > 1 else 0
    return q + max(ring, merge) + 2 * sb * 4 + 16


def uses_mma(dtype: torch.dtype, rows: int, bk: int, hd: int) -> bool:
    """Whether a bfloat16 launch runs the tensor-core body (attention_mma.cuh)
    rather than attend_rows: bfloat16 queries, hd in ``MMA_HEAD_DIMS`` and
    bk a multiple of 16."""
    return (dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS
            and mma_plan(rows, bk, hd) is not None)


def chunk_tiles(bk: int) -> int:
    """Tiles of one decode key chunk: ``CHUNK_KEYS // bk`` (at least 1), set
    by the tile size alone, never by the batch or the cache length."""
    return max(1, CHUNK_KEYS // bk)


def key_chunks(n_tiles: int, bk: int) -> int:
    """Key chunks of a decode launch over ``n_tiles`` tiles of ``bk`` keys:
    the grid's third axis."""
    return -(-n_tiles // chunk_tiles(bk))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels need it")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS, *, ptxas_info: bool = False) -> dict:
    """Compile every missing library among ``names``, one ``nvcc`` each, all
    started together.  Returns ``{name: compiler output}`` for the libraries
    built now (``ptxas_info`` adds each kernel's registers and spills).
    Raises if any build fails."""
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    outputs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        outputs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{outputs[name]}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return outputs


def kernel_fn(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel library ``name``, built and
    loaded on first use, with its argument types set."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    import ctypes

    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make ``device`` current for a launch (only if it is not already)
    and yield its current stream's raw handle, the wrappers' last
    argument.  The host cost of every launch: decode is host-bound."""
    idx = device.index
    if torch.cuda.current_device() == idx:
        yield torch._C._cuda_getCurrentRawStream(idx)
    else:
        with torch.cuda.device(idx):
            yield torch._C._cuda_getCurrentRawStream(idx)


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = _libs[name].kernel_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through kernel ``name``:
    grad mode is on and an input off the CPU requires grad.  A kernel
    writes its output through ctypes into a fresh tensor that carries no
    ``grad_fn``, so a loss through it would silently lose the gradient of
    every weight before it.  CPU tensors take the plain versions, which
    differentiate; ``None`` entries (optional operands) are skipped.
    Every wrapper calls this before its device dispatch."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad and t.device.type != "cpu":
            raise RuntimeError(
                f"{name}: the CUDA kernel has no backward, and an input on {t.device} "
                "requires grad; run it under torch.no_grad() (the train path takes "
                "the reference computations, and flash_attention's autograd Function)")
