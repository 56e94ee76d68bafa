"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface,

    nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

keyed by a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads at once.  No fast-math
flag is passed: the kernels' parity contracts need IEEE division and expf.
``build_all`` starts one nvcc per source, all at once.  Nothing here runs
at import time: the CPU tests import every module without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("multi_count", "runahead_threshold", "multi_mass", "multi_entropy",
           "taylor_eval", "paged_attend", "flash_fwd")
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}        # name -> nvcc output of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every source in ``names`` not built yet, one nvcc process
    each, all started together.  Returns the wall seconds; raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    nvcc = None
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        procs[name] = (target, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    try:
        for name, (target, tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            BUILD_LOG[name] = out
            if proc.returncode == 0:
                os.replace(tmp, target)
            else:
                failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
    finally:
        for _, tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s built library is (or will be)."""
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = load(_target(name))
    return lib


def load(path) -> ctypes.CDLL:
    """A built kernel library, with its error-string entry point typed."""
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


def check_rows(t: torch.Tensor, name: str) -> None:
    """The kernels take (B, N) float32 CUDA tensors with unit column
    stride (rows may be strided views, e.g. the engine's grid[:, 1:-1])."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.ndim != 2 or t.dtype != torch.float32:
        raise ValueError(f"{name} must be 2-D float32, got {t.dtype} of "
                         f"shape {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride, got strides "
                         f"{t.stride()}")
    if not 1 <= t.shape[0] <= 65535 or t.shape[1] < 1:
        raise ValueError(f"{name}: needs 1..65535 rows and at least one "
                         f"column, got shape {tuple(t.shape)}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry points
    take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
