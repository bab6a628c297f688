"""Build and load the CUDA kernels of ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``_build/lib<name>-<hash>.so`` beside the package (the
hash is of the source, so an edited kernel is rebuilt), then loaded with
``ctypes``.  Nothing includes PyTorch's headers, so a build takes seconds.
The build runs at first use; :func:`build_all` starts one ``nvcc`` per
source at once, for callers that want every kernel ready up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: loaded libraries by kernel name (one ctypes handle per process)
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) by kernel name
BUILD_LOGS: Dict[str, str] = {}
#: wall seconds each build took in this process (absent when cached)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen], t0: float) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, _target(name))   # atomic: a reader never sees half a file
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(signatures: Dict[str, Dict[str, tuple]]) -> None:
    """Build every kernel named in ``signatures`` that is not built yet, all
    ``nvcc``s at once, and load them (see :func:`load`)."""
    names = [n for n in signatures if n not in _LIBS]
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    for n, proc in procs.items():
        _finish(n, proc, t0)
    for n in names:
        load(n, signatures.get(n))


def load(name: str, signatures: Optional[Dict[str, tuple]] = None
         ) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.

    ``signatures`` maps each C function to ``(restype, argtypes)``; they are
    set once, when the library is first loaded.  Every pointer and the
    stream go as ``ctypes.c_void_p``, or ctypes would cut them to 32 bits.
    """
    lib = _LIBS.get(name)
    if lib is None:
        t0 = time.perf_counter()
        _finish(name, _start(name), t0)
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        for fn, (restype, argtypes) in (signatures or {}).items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (its
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")
