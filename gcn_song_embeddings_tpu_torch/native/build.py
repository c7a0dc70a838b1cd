"""Build and load the native readers from the C++ sources at the repo root.

``native/jsongraph.cc`` (the ``graph.json`` edge scanner) and
``native/featload.cc`` (the threaded per-track ``.npy`` reader) are
compiled with ``g++ -O3 -std=c++17 -fPIC -shared`` (``-pthread`` for
featload) at first use, into ``build/torch_native/`` beside the package.
The library name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  The port builds its own
libraries: it never loads what ``native/Makefile`` writes for the JAX
package.

Where no C++ compiler exists (or the sources are not beside the package)
``library`` returns None and the callers take their Python path; where a
compiler exists and the build fails, it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SOURCE_DIR = REPO / "native"
BUILD_DIR = REPO / "build" / "torch_native"
FLAGS = {"jsongraph": ("-O3", "-std=c++17", "-fPIC", "-shared"),
         "featload": ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(name: str) -> Path:
    source = (SOURCE_DIR / f"{name}.cc").read_bytes()
    digest = hashlib.sha256(source + " ".join(FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path | None:
    """The built library of ``native/<name>.cc``, compiled if needed;
    None where there is no compiler or no source to compile."""
    source = SOURCE_DIR / f"{name}.cc"
    out = library_path(name) if source.is_file() else None
    if out is None or out.is_file():
        return out
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS[name], "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL | None:
    """The loaded library of ``native/<name>.cc`` (built at first use), or
    None where it cannot be built here."""
    with _lock:
        if name not in _libs:
            path = build(name)
            _libs[name] = None if path is None else ctypes.CDLL(str(path))
        return _libs[name]
