"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<name>-<hash>.so``
at the root of the checkout (a directory ``.gitignore`` lists), compiled for
Hopper only (``sm_90a``) with a plain C interface — no PyTorch headers, so a
build takes seconds.  The file name carries a hash of the source, of the
headers beside it and of the compiler flags, so an edited source, header or
flag is rebuilt and a stale library is never loaded.  Nothing is built at
import: the first launch builds (``library``), or ``build_all`` builds every
source at once, one nvcc per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# --split-compile=0: the device code's optimisation runs on as many threads
# as the machine has (the attention libraries, some 50 and 90 instantiations,
# build in about half the time; the code it makes times the same on the
# card: attention_ab.py)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, of every
    header in ``csrc/`` (a source may include any of them) and of
    :data:`NVCC_FLAGS`."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: List[str] | None = None) -> Dict[str, Path]:
    """Compile every source not yet built, all nvcc processes at once;
    returns ``{name: library path}``.  Raises with the compiler's output
    when one fails.  The ptxas report (registers, shared memory, spills)
    is kept beside each library as ``<name>.log``."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
