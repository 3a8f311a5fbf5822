"""ctypes bridge to the host Benes router (native/benes_router.cpp).

The router is built with ``g++`` into the port's build directory at first
use.  At 2^24 slots the python router in ops/benes.py is far too slow; the
native one keeps the 10M-edge plan build near half a minute.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import threading

import numpy as np

from ._build import PKG_DIR, compile_all, lib_path

log = logging.getLogger(__name__)

_ROUTER_SRC = os.path.join(PKG_DIR, "native", "benes_router.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def get_router():
    """Load (building if needed) the router library, or None when the host
    has no C++ compiler."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = lib_path(_ROUTER_SRC)
        if not os.path.exists(out):
            if shutil.which("g++") is None:
                log.info("no g++ on this host; python Benes router in use")
                return None
            compile_all([(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                           "-Wall", _ROUTER_SRC], out)])
        lib = ctypes.CDLL(out)
        lib.benes_route.restype = ctypes.c_int
        lib.benes_route.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def benes_route_native(perm: np.ndarray):
    """Bit-packed Benes stage masks via the C++ router, or None when the
    router cannot be built here.

    Returns (n_stages, (N+7)//8) uint8, rows packbits-compatible.
    """
    lib = get_router()
    if lib is None:
        return None
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    N = len(perm)
    if N < 2 or N & (N - 1):
        raise ValueError("benes_route_native requires power-of-two N >= 2")
    n_stages = 2 * (N.bit_length() - 1) - 1
    out = np.zeros((n_stages, (N + 7) // 8), dtype=np.uint8)
    rc = lib.benes_route(
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        N, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError("invalid permutation for benes_route")
    return out
