"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``gymca_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, in ``gymca_torch/build/``
(listed in ``.gitignore``).  The library's file name carries a hash of the
source and the flags, so an edited source builds anew.  A missing ``nvcc``,
a missing source or a failed build raises.

The kernels build from the sources beside this file into ``build/`` in the
package directory: in a checkout, ``gymca_torch/build/``; in an installed
copy, which carries ``csrc/*.cu`` as package data, ``build/`` inside the
installed package, which must then be writable.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["BUILD_DIR", "CSRC_DIR", "Built", "build", "load", "check_operand"]

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    seconds: Optional[float]  # None when an earlier build was reused
    log: str  # nvcc's output, with the -Xptxas -v report

    def ptxas_entries(self) -> Dict[str, List[str]]:
        """The ``-Xptxas -v`` lines of each kernel instance, by its mangled
        name: registers, barriers, shared memory, stack and spills."""
        entries: Dict[str, List[str]] = {}
        lines = None
        for ln in self.log.splitlines():
            if "Compiling entry function" in ln:
                lines = entries.setdefault(ln.split("'")[1], [])
            elif lines is not None and ("registers" in ln or "spill" in ln):
                lines.append(ln.strip())
        return entries

    def ptxas_report(self):
        """One line per kernel instance: its mangled name and its ptxas
        lines."""
        return [f"{name}: {' | '.join(lines)}" for name, lines in self.ptxas_entries().items()]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: building gymca_torch's CUDA kernels "
                           "needs the CUDA toolkit (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Build the named sources (default: every ``csrc/*.cu``) and return
    what was built or reused."""
    srcs = ([CSRC_DIR / f"{n}.cu" for n in names] if names is not None
            else sorted(CSRC_DIR.glob("*.cu")))
    missing = [str(s) for s in srcs if not s.is_file()]
    if missing or not srcs:
        raise RuntimeError(f"kernel sources not found in {CSRC_DIR}: {missing or '*.cu'}; "
                           "gymca_torch builds its kernels from a checkout of the repository")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Built] = {}
    running = []  # one nvcc per source, all started before any is waited on
    for src in srcs:
        target = _target(src)
        log_path = target.with_suffix(".log")
        if target.is_file() and log_path.is_file():
            done[src.stem] = Built(src.stem, target, None, log_path.read_text())
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, target, tmp, proc, time.perf_counter()))
    failed = []
    for src, target, tmp, proc, t0 in running:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"CUDA build of {src.name} failed: nvcc exited "
                          f"{proc.returncode}\n{out}")
            continue
        os.replace(tmp, target)  # atomic: concurrent builds agree
        target.with_suffix(".log").write_text(out)
        done[src.stem] = Built(src.stem, target, time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build([name])[name].path))


def check_operand(name: str, t, shape, dtype, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor of ``dtype``
    and ``shape`` on ``device``: what a kernel given ``t.data_ptr()`` reads."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the grid on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
