"""Native host components, built lazily with the system toolchain.

The only native piece the workload needs host-side is the edge-list parser (the
accelerator kernels are Pallas — see ops/minplus.py). ``libedgelist.so`` is
compiled from ``edgelist.cpp`` with g++ on first use and cached next to the
source; every consumer falls back to the pure-Python path when the toolchain or the
build is unavailable, so the native layer is a pure accelerant.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libedgelist.so")
_SRC = os.path.join(_HERE, "edgelist.cpp")
_STAMP = _SO + ".sha256"  # content hash of the source the .so was built from

_lock = threading.Lock()
_lib = None
_build_failed = False


def _src_digest() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _stale() -> bool:
    """The binary is never version-controlled (see .gitignore); it is trusted
    only when the recorded source hash matches — mtime is meaningless after a
    fresh clone."""
    if not os.path.exists(_SO) or not os.path.exists(_STAMP):
        return True
    with open(_STAMP) as f:
        return f.read().strip() != _src_digest()


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if _stale():
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                     "-o", _SO + ".tmp"],
                    check=True, capture_output=True, timeout=120)
                os.replace(_SO + ".tmp", _SO)
                with open(_STAMP, "w") as f:
                    f.write(_src_digest())
            except Exception as e:  # toolchain missing / compile error
                logging.info("native edgelist build unavailable (%s); using "
                             "the pure-Python loader", e)
                _build_failed = True
                return None
        lib = ctypes.CDLL(_SO)
        lib.el_parse.restype = ctypes.c_void_p
        lib.el_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
        lib.el_error.restype = ctypes.c_char_p
        lib.el_error.argtypes = [ctypes.c_void_p]
        for name in ("el_num_edges", "el_num_nodes", "el_keys_size",
                     "el_labels_size"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.el_copy_edges.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.el_copy_weights.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.el_copy_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.el_copy_labels.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.el_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_edgelist(path: str, ncols: int, *, skip_header: bool = False):
    """Parse a 3- or 5-column tab edge list (.gz transparent).

    Returns (labels, keys, edges int32 (E, 2), weights f64) or None when the
    native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None

    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            buf = f.read()
    else:
        with open(path, "rb") as f:
            buf = f.read()
    if skip_header:
        nl = buf.find(b"\n")
        buf = buf[nl + 1:] if nl >= 0 else b""

    handle = lib.el_parse(buf, len(buf), ncols)
    try:
        err = lib.el_error(handle)
        if err:
            raise ValueError(f"native edgelist parse failed: {err.decode()}")
        num_edges = lib.el_num_edges(handle)
        edges = np.empty((num_edges, 2), np.int32)
        lib.el_copy_edges(handle, edges.ctypes.data_as(ctypes.c_void_p))
        weights = np.empty(num_edges, np.float64)
        lib.el_copy_weights(handle, weights.ctypes.data_as(ctypes.c_void_p))

        ksize = lib.el_keys_size(handle)
        kbuf = ctypes.create_string_buffer(ksize)
        lib.el_copy_keys(handle, kbuf)
        keys = kbuf.raw[:ksize].decode("utf-8").split("\n")[:-1]

        lsize = lib.el_labels_size(handle)
        lbuf = ctypes.create_string_buffer(lsize)
        lib.el_copy_labels(handle, lbuf)
        labels = lbuf.raw[:lsize].decode("utf-8").split("\n")[:-1]
        return labels, keys, edges, weights
    finally:
        lib.el_free(handle)
