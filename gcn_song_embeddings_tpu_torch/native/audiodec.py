"""Compressed clips through the native FFmpeg decoder (``native/audiodec.cc``).

One C call per clip demuxes any container (mp3, ogg, flac, m4a, wav),
decodes the first audio stream and resamples it to mono float32 at the
requested rate.  ``features.load_clip`` routes every extension but
``.wav`` and ``.npy`` here.  ``encode_mp3`` (libmp3lame through
libavcodec) makes real mp3 test vectors offline.

The library is built by ``native.build`` at first use; where the system
FFmpeg development files are absent it is not built and
``native_available()`` is False.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gcn_song_embeddings_tpu_torch.native import build

_bound = None


def _lib():
    global _bound
    lib = build.library("audiodec")
    if lib is not None and _bound is not lib:
        lib.ad_version.restype = ctypes.c_int
        lib.ad_version.argtypes = []
        lib.ad_decode.restype = ctypes.c_int64
        lib.ad_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        lib.ad_free.restype = None
        lib.ad_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ad_encode_mp3.restype = ctypes.c_int64
        lib.ad_encode_mp3.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        _bound = lib
    return lib


def native_available() -> bool:
    return _lib() is not None


def _require():
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native audio decoder cannot be built here "
                           "(it needs a C++ compiler and the system FFmpeg "
                           "development libraries)")
    return lib


def decode(path: str, target_sr: int) -> np.ndarray:
    """Decode any FFmpeg-readable audio file -> mono float32 at
    ``target_sr``."""
    lib = _require()
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.ad_decode(path.encode(), int(target_sr), ctypes.byref(out))
    if n < 0:
        raise ValueError(f"audio decode failed for {path!r} "
                         f"(AVERROR {int(n)})")
    try:
        return np.ctypeslib.as_array(out, shape=(int(n),)).copy()
    finally:
        lib.ad_free(out)


def encode_mp3(path: str, samples: np.ndarray, sr: int,
               bitrate: int = 128_000) -> None:
    """Encode mono float32 ``samples`` at ``sr`` to an mp3 file."""
    lib = _require()
    y = np.ascontiguousarray(np.asarray(samples, dtype=np.float32).ravel())
    err = lib.ad_encode_mp3(
        path.encode(), y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.shape[0], int(sr), int(bitrate))
    if err < 0:
        raise ValueError(f"mp3 encode failed for {path!r} "
                         f"(AVERROR {int(err)})")
