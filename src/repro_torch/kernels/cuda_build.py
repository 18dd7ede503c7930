"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` into a shared library, which is
loaded with ``ctypes``.  Libraries are built at first use, from the
sources in this package only, into ``build/`` beside ``csrc/`` (listed
in ``.gitignore``); a library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale one is never
loaded.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for every one of them.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "nvcc_path", "library_path", "build",
           "load", "ptxas_report"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")

#: kernel library name -> source file under csrc/
SOURCES = {"stencil_step": "stencil_step.cu",
           "stencil_sweep": "stencil_sweep.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default install, else ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built: content-addressed by
    its source and the compiler flags."""
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def ptxas_report(name: str) -> str:
    """The compiler's register / shared-memory report for library
    ``name`` (empty until it was built in this checkout)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(names=None) -> dict[str, float]:
    """Build every missing library of ``names`` (default: all) in
    parallel; returns ``{name: seconds}`` for the ones built now.  Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]} (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
