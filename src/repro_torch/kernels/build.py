"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries land in ``build/repro_torch/`` at the repository root,
named by a hash of the source and the compiler flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built when this module
is imported: the first wrapper launch on a CUDA tensor builds what it needs,
and :func:`build_all` builds every kernel at once (one ``nvcc`` process per
source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_c_void_p, _c_int, _c_ll, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_float)

# kernel name -> (source file, C entry point, argtypes)
KERNELS = {
    "sgd_update": ("sgd_update.cu", "sgd_update_f32",
                   [_c_void_p] * 6 + [_c_ll, _c_float, _c_float, _c_int,
                                      _c_void_p]),
    "quantize_mod": ("quantize_mod.cu", "quantize_mod_launch",
                     [_c_void_p] * 5 + [_c_ll, _c_float, _c_float, _c_int,
                                        _c_int, _c_void_p]),
    "decode_avg": ("decode_avg.cu", "decode_avg_launch",
                   [_c_void_p] * 5 + [_c_ll, _c_int, _c_int, _c_int, _c_int,
                                      _c_void_p]),
}

_LOADED: dict = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return nvcc


def library_path(name: str) -> Path:
    """Where `name`'s library lives: keyed by its source and the flags."""
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / KERNELS[name][0])]


def _start_build(name: str):
    """Start nvcc for `name` unless its library exists; -> (proc, tmp, out)
    or None. The output is written under a temporary name and renamed, so
    a concurrent reader never loads a half-written library."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen(nvcc_command(find_nvcc(), name, tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for kernel {name!r} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=None) -> None:
    """Build every kernel (or `names`) in parallel: one nvcc per source."""
    names = list(names or KERNELS)
    jobs = {n: _start_build(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish_build(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel(name: str):
    """The ctypes function of kernel `name`, built and loaded on first use."""
    with _LOCK:
        fn = _LOADED.get(name)
        if fn is not None:
            return fn
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = KERNELS[name][2]
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
        return fn
