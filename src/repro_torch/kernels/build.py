"""Builds the hand-written CUDA kernels from their sources at first use.

Each ``.cu`` source under ``kernels/`` exposes a plain C interface. ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library, which ``ctypes``
loads. Libraries go to ``build/kernels/`` at the repository root, named by
a hash of the source and the flags: an unchanged source is reused, a
changed one is rebuilt. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the hand-written kernels "
                           "are compiled with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(*sources: Path) -> Dict[str, float]:
    """Compile every source whose library is missing, all at once (one
    ``nvcc`` process per source). Returns the seconds each build took,
    keyed by source name; sources already built are left out."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((src, out, tmp, proc, time.perf_counter()))
    seconds = {}
    failures = []
    for src, out, tmp, proc, t0 in started:
        _, err = proc.communicate()
        if proc.returncode:
            failures.append(f"nvcc failed for {src.name}:\n{err}")
            continue
        os.replace(tmp, out)
        seconds[src.name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(source: Path) -> ctypes.CDLL:
    """The kernel library built from ``source``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        build(source)
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib


def refuse_fake(*xs) -> None:
    """Raise where a fake tensor (``FakeTensorMode``) reaches a kernel
    entry: the compile-only dry run (``launch.dryrun``) traces the plain
    paths a rank would run, and a kernel has nothing to trace."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(isinstance(x, FakeTensor) for x in xs):
        raise RuntimeError(
            "a fake tensor reached a hand-kernel entry: the compile-only "
            "dry run (launch.dryrun) traces the plain paths, "
            "attn_impl='xla' and seq_shard with "
            "collectives.set_fused_partials(False)")
