"""``graph.json`` edges through the native scanner (``native/jsongraph.cc``).

A single-pass C++ scan avoids materializing millions of Python dicts:
the 100k-track graph's million edge records take about four times as
long through the ``json`` module.  The ``json`` module reads the file where the scanner cannot be
built, where it returns null (a layout it does not take), and where the
id map is not ``0..n-1`` in key order (the scanner maps key i to index i).
"""

from __future__ import annotations

import ctypes
import json
from typing import Mapping

import numpy as np

from gcn_song_embeddings_tpu_torch.native import build

_bound = None


def _lib():
    global _bound
    lib = build.library("jsongraph")
    if lib is not None and _bound is not lib:
        lib.jg_table_new.restype = ctypes.c_void_p
        lib.jg_table_new.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int64]
        lib.jg_table_free.argtypes = [ctypes.c_void_p]
        lib.jg_parse_edges.restype = ctypes.c_void_p
        lib.jg_parse_edges.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.jg_edges_len.restype = ctypes.c_int64
        lib.jg_edges_len.argtypes = [ctypes.c_void_p]
        lib.jg_edges_missing.restype = ctypes.c_int64
        lib.jg_edges_missing.argtypes = [ctypes.c_void_p]
        lib.jg_edges_copy.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.POINTER(ctypes.c_int32)]
        lib.jg_edges_free.argtypes = [ctypes.c_void_p]
        _bound = lib
    return lib


def native_available() -> bool:
    return _lib() is not None


def load_edges(graph_path: str, index_map: Mapping[str, int]
               ) -> tuple[np.ndarray, np.ndarray, str]:
    """graph.json -> (from_idx, to_idx) int32 arrays and the reader that
    ran: ``"native"`` or ``"json"``."""
    lib = _lib()
    if lib is None or any(v != i for i, v in enumerate(index_map.values())):
        return (*load_edges_json(graph_path, index_map), "json")
    ids = list(index_map)
    arr = (ctypes.c_char_p * len(ids))(*[s.encode("utf-8") for s in ids])
    table = lib.jg_table_new(arr, len(ids))
    try:
        edges = lib.jg_parse_edges(graph_path.encode("utf-8"), table)
        if not edges:
            return (*load_edges_json(graph_path, index_map), "json")
        try:
            n = lib.jg_edges_len(edges)
            missing = lib.jg_edges_missing(edges)
            if missing:
                raise KeyError(f"{missing} edges reference ids absent from "
                               f"tracks.json/collections.json in "
                               f"{graph_path}")
            src = np.empty(n, dtype=np.int32)
            dst = np.empty(n, dtype=np.int32)
            if n:
                lib.jg_edges_copy(
                    edges, src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return src, dst, "native"
        finally:
            lib.jg_edges_free(edges)
    finally:
        lib.jg_table_free(table)


def load_edges_json(graph_path: str, index_map: Mapping[str, int]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The ``json`` module's reading of graph.json -> (from_idx, to_idx)."""
    with open(graph_path, encoding="utf-8") as f:
        edges = json.load(f)["edges"]
    src = np.fromiter((index_map[e["from"]] for e in edges),
                      dtype=np.int32, count=len(edges))
    dst = np.fromiter((index_map[e["to"]] for e in edges),
                      dtype=np.int32, count=len(edges))
    return src, dst
