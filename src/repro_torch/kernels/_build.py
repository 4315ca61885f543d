"""Build and load the hand-written CUDA kernels.

At first use in a process, every ``csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source,
all started together, then linked into one shared library with a plain C
interface::

    build/repro_torch_kernels/<hash>/libhpc_kernels.so

``<hash>`` covers the sources and the flags, so a library built from the
same sources is reused and an edited source builds anew. The sources
include no PyTorch headers and are bound through ``ctypes``: a build takes
seconds, where ``torch.utils.cpp_extension.load`` takes minutes.

Nothing here runs at import: ``library()`` compiles and loads under a lock,
so two threads never build at once. ``last_build`` records what the last
call that loaded the library did (seconds, whether it compiled, and the
``-Xptxas -v`` lines with registers, shared memory and spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "libhpc_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# every exported function: (argtypes, restype)
_SIGNATURES = {
    "hpc_qmaxsim": ([_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _P],
                    _I),
    "hpc_qmaxsim_smem_bytes": ([_I, _I, _I], _LL),
    "hpc_kmeans_assign": ([_P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
    "hpc_kmeans_assign_smem_bytes": ([_I, _I], _LL),
    "hpc_error_string": ([_I], ctypes.c_char_p),
}


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this host")
    return found


def _compile(sources: List[Path], lib_path: Path) -> str:
    """Compile each source in parallel, link, and atomically place the
    library at ``lib_path``. Returns the compiler's output (ptxas lines)."""
    nvcc = _nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                for other in procs:
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic against a concurrent build
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source set has no
    library yet."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            lib_path = BUILD_ROOT / _digest(sources) / LIB_NAME
            t0 = time.perf_counter()
            compiled = not lib_path.exists()
            log = _compile(sources, lib_path) if compiled else ""
            lib = ctypes.CDLL(str(lib_path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            last_build.update(path=str(lib_path), compiled=compiled,
                              seconds=time.perf_counter() - t0, log=log)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().hpc_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({msg})")
