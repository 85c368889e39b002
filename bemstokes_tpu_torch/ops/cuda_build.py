"""Build and load the native libraries of `csrc/`: the CUDA kernels
(`*.cu`, nvcc) and the host code (`*.cpp`, g++).

Every source has a plain C interface.  A source is compiled at first use
into `bemstokes_tpu_torch/_build/`, keyed by a hash of the source, the
kernels' shared header (`.cu` only) and the flags, and loaded with ctypes; a
wrapper names its source and declares its argument types (`library`).
Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
HEADER = CSRC / "node_sweep_common.cuh"
BUILD_DIR = _PKG / "_build"
# `-Xptxas -v` only adds each kernel's registers, shared memory and spills to
# nvcc's output, which `build_all` returns
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_libs: dict[Path, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def nvcc_path() -> str:
    """The nvcc that builds the kernels: the one on PATH, else CUDA_HOME's."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def sources() -> list[Path]:
    """Every kernel source of the package."""
    return sorted(CSRC.glob("*.cu"))


def _start_build(source: Path):
    """(library path, running compiler or None, temporary output path) for
    one source; the compiler is started only if no build of this source
    exists yet."""
    if source.suffix == ".cu":
        compiler, flags, deps = nvcc_path(), NVCC_FLAGS, source.read_bytes() + HEADER.read_bytes()
    else:
        compiler, flags, deps = "g++", GXX_FLAGS, source.read_bytes()
    key = hashlib.sha256(deps + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}_{key}.so"
    if lib_path.exists():
        return lib_path, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{source.stem}_{key}.{os.getpid()}.so"
    proc = subprocess.Popen(
        [compiler, *flags, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    return lib_path, proc, tmp


def _finish_build(source: Path, lib_path: Path, proc, tmp) -> str:
    """Wait for a build started by `_start_build`; returns the compiler's
    output."""
    if proc is None:
        return ""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(proc.args[0]).name} failed to build {source.name} (rc {proc.returncode}):\n{out}\n{err}"
        )
    os.replace(tmp, lib_path)
    return out + err


def build(source: Path) -> Path:
    """Compile one library if no build of this source exists yet and
    return its path."""
    lib_path, proc, tmp = _start_build(source)
    _finish_build(source, lib_path, proc, tmp)
    return lib_path


def build_all() -> dict[str, tuple[Path, str]]:
    """Compile every kernel library, one nvcc per source, all started
    together.  Returns {source name: (library path, nvcc output)}; the
    output of a fresh build holds each kernel's registers, shared memory and
    spills (empty where a build existed already)."""
    started = [(src, *_start_build(src)) for src in sources()]
    return {
        src.name: (lib_path, _finish_build(src, lib_path, proc, tmp))
        for src, lib_path, proc, tmp in started
    }


def library(source: Path, declare) -> ctypes.CDLL:
    """The loaded library of `source`, built first if need be.  `declare(lib)`
    sets the argument and result types of its entry points, once."""
    with _lib_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _libs[source] = lib
        return lib
