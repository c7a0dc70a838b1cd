"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``.  Builds
happen at first use, into ``build/torch_kernels/`` beside the package,
and the library name carries a hash of the source, the ``csrc/`` headers
it includes and the flags, so an edited source or header is rebuilt and
an unchanged one is reused.  Nothing is
downloaded: the sources in the checkout are the only input.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("walk", "agg", "dma_agg", "quant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every ``csrc/`` file it includes, transitively."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(seen[path]):
            _sources(CSRC / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    parts = _sources(CSRC / f"{name}.cu", {})
    digest = hashlib.sha256(b"".join(parts[p] for p in sorted(parts))
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc``
    process per source, all started together.  Returns each source's
    ``ptxas -v`` report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    logs = {name: library_path(name).with_suffix(".log") for name in names}
    return {name: log.read_text() if log.is_file() else ""
            for name, log in logs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            build((name,))
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if ``<name>_launch`` returned a CUDA error code."""
    if err != 0:
        text = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({text})")


def bind(name: str, argtypes: list, entry: str = "launch") -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` and declare its C entry points: the
    ``<name>_<entry>(...)`` signature given here, returning the launch's
    ``cudaGetLastError()``, and ``<name>_error_string(int)``."""
    lib = library(name)
    launch = getattr(lib, f"{name}_{entry}")
    if launch.argtypes is None:
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
    return lib
