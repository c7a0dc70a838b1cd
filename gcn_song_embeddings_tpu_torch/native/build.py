"""Build and load the native libraries from the C++ sources at the repo root.

``native/jsongraph.cc`` (the ``graph.json`` edge scanner),
``native/featload.cc`` (the threaded per-track ``.npy`` reader) and
``native/audiodec.cc`` (the FFmpeg clip decoder) are compiled with ``g++
-O3 -std=c++17 -fPIC -shared`` (``-pthread`` for featload, FFmpeg's
libraries for audiodec) at first use, into ``build/torch_native/`` beside
the package.  The library name carries a hash of the source, the flags and
the libraries, so an edited source is rebuilt and an unchanged one is
reused.  The port builds its own libraries: it never loads what
``native/Makefile`` writes for the JAX package.

Where no C++ compiler exists (or the sources are not beside the package)
``library`` returns None and the callers take their Python path.  The
decoder needs the system FFmpeg development files: as ``native/Makefile``
does, a build first preprocesses its probe header, and where that fails
``library`` returns None too (compressed clips are then refused by
``features.load_clip``).  Where a compiler and the headers exist and the
build fails, it raises.
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
         "featload": ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"),
         "audiodec": ("-O3", "-std=c++17", "-fPIC", "-shared")}
LIBS = {"audiodec": ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")}
# a header whose absence means the system libraries are absent
PROBES = {"audiodec": "libavcodec/avcodec.h"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(name: str) -> Path:
    source = (SOURCE_DIR / f"{name}.cc").read_bytes()
    flags = " ".join(FLAGS[name] + LIBS.get(name, ()))
    digest = hashlib.sha256(source + flags.encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _headers_present(cxx: str, name: str) -> bool:
    probe = PROBES.get(name)
    if probe is None:
        return True
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                          input=f"#include <{probe}>\n", capture_output=True,
                          text=True)
    return proc.returncode == 0


def build(name: str) -> Path | None:
    """The built library of ``native/<name>.cc``, compiled if needed;
    None where there is no compiler, no source to compile or (for the
    decoder) no FFmpeg headers."""
    source = SOURCE_DIR / f"{name}.cc"
    out = library_path(name) if source.is_file() else None
    if out is None or out.is_file():
        return out
    cxx = _compiler()
    if cxx is None or not _headers_present(cxx, name):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS[name], "-o", str(tmp), str(source),
                           *LIBS.get(name, ())],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str, path: Path) -> ctypes.CDLL | None:
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        # a library built on another machine (a copied build directory)
        # whose shared libraries this one lacks: build it here, or not at
        # all where this machine cannot
        path.unlink()
        path = build(name)
        return None if path is None else ctypes.CDLL(str(path))


def library(name: str) -> ctypes.CDLL | None:
    """The loaded library of ``native/<name>.cc`` (built at first use), or
    None where it cannot be built here."""
    with _lock:
        if name not in _libs:
            path = build(name)
            _libs[name] = None if path is None else _load(name, path)
        return _libs[name]
