"""Launch hygiene: process environment set-up (port of
``repro.launch.env``).

The knobs a deployment sets before the runtime does its work:

  * ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD``: silence tcmalloc's report
    of every allocation above ~1 GB (multi-GB weights trip it);
  * quiet logs: ``TORCH_CPP_LOG_LEVEL`` (c10's C++ log) and
    ``NCCL_DEBUG`` (read when NCCL starts, after ``configure``);
  * the default float dtype pinned to f32 (``REPRO_TORCH_DEFAULT_DTYPE``,
    ``float32`` unless exported otherwise): a factory call without a
    dtype never makes a model's tensors in another precision.

Everything has ``setdefault`` semantics: a value the operator (or
``launch/run.sh``) exported wins.  ``LD_PRELOAD`` of tcmalloc cannot be
set from inside the process (the dynamic linker reads it at exec time),
so ``launch/run.sh`` sets it.  ``launch/serve.py`` and
``launch/train.py`` call ``configure()`` first in ``main()``.

Nothing TPU-specific is carried over: the XLA flags of JAX's function
(the step marker, forced host devices) have no counterpart here; the
port's CPU ranks come from ``--host-devices`` (``launch/mesh.py``).
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess

import torch

log = logging.getLogger("repro_torch.launch.env")

# tcmalloc reports every allocation above ~1 GB by default; 60 GB is
# effectively silent (the JAX package's value)
TCMALLOC_THRESHOLD = "60000000000"
DTYPE_ENV = "REPRO_TORCH_DEFAULT_DTYPE"


def configure(*, quiet: bool = True) -> dict:
    """Apply launch hygiene to ``os.environ`` and torch's default dtype;
    returns what was resolved.  ``setdefault`` semantics throughout."""
    if quiet:
        os.environ.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
        os.environ.setdefault("NCCL_DEBUG", "WARN")
    os.environ.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                          TCMALLOC_THRESHOLD)
    name = os.environ.setdefault(DTYPE_ENV, "float32")
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"{DTYPE_ENV}={name!r} is not a torch float dtype")
    torch.set_default_dtype(dtype)
    if "libtcmalloc" not in os.environ.get("LD_PRELOAD", ""):
        # the linker read LD_PRELOAD at exec: launch/run.sh sets it
        log.debug("tcmalloc not preloaded; use launch/run.sh to LD_PRELOAD "
                  "it (glibc malloc fragments multi-GB host copies)")
    return {
        "torch_cpp_log_level": os.environ.get("TORCH_CPP_LOG_LEVEL"),
        "nccl_debug": os.environ.get("NCCL_DEBUG"),
        "tcmalloc_threshold":
            os.environ.get("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"),
        "default_dtype": str(torch.get_default_dtype()),
        "ld_preload": os.environ.get("LD_PRELOAD", ""),
    }


def gpu_name_and_power() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (its first line), or None where there is no ``nvidia-smi``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def describe() -> dict:
    """The resolved launch environment, for logs and reports: the GPU and
    its power limit, the CUDA and torch versions, where the kernels are
    built, and which backend the kernel wrappers take (the hand-written
    kernels on a card, their plain versions on the CPU): the counterpart
    of JAX's Pallas interpret-mode report."""
    from repro_torch.kernels.build import BUILD_DIR

    cuda = torch.cuda.is_available()
    return {
        "gpu": gpu_name_and_power(),
        "cuda_device": torch.cuda.get_device_name(0) if cuda else None,
        "cuda_version": torch.version.cuda,
        "torch_version": torch.__version__,
        "kernel_build_dir": str(BUILD_DIR),
        "kernels": ("hand-written CUDA kernels (built at first use)"
                    if cuda else "plain PyTorch versions (no CUDA device)"),
        "ld_preload": os.environ.get("LD_PRELOAD", ""),
        "tcmalloc_preloaded":
            "libtcmalloc" in os.environ.get("LD_PRELOAD", ""),
        "default_dtype": str(torch.get_default_dtype()),
    }
