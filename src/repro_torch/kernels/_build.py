"""Build the CUDA sources under ``repro_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` function and is
compiled by ``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, at first use (the hash is of the source, so an edited source
is rebuilt and a stale library is never loaded).  Nothing is compiled when
a module is imported: the CPU tests import every module and this box may
have no ``nvcc``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# repo root = parents[3] of src/repro_torch/kernels/_build.py
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes signature of each source's extern "C" entry point (pointers and
# the stream as c_void_p, or ctypes would cut them to 32 bits)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "gather_norm_dot": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    "batched_dot": (_P, _P, _P, _I, _I, _I, _P),
    "flash_attention": (*(_P,) * 5, *(_I,) * 7, _F, _I, _I, _I, _P),
    "wkv6": (*(_P,) * 8, *(_I,) * 5, _P),
    "mamba_scan": (*(_P,) * 8, *(_I,) * 4, _P),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # name -> nvcc's output (ptxas -v report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source -> (Popen, tmp path, target) or None
    when the library for this exact source is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or none


def build_all() -> list[str]:
    """Compile every source in ``csrc/`` in parallel (one ``nvcc`` each,
    all started together).  Returns the kernel names."""
    names = sorted(SIGNATURES)
    started = {name: _start(name) for name in names}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)
    return names


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    st = _start(name)
    if st is not None:
        _finish(name, st)
    lib = ctypes.CDLL(str(_target(name)))
    fn = getattr(lib, name)
    fn.argtypes = list(SIGNATURES[name])
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib
