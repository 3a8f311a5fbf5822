"""ctypes bridges to the port's host C++ code (``native/*.cpp``).

  benes_router.cpp -> ``benes_route_native``: the host Benes router.  At
                      2^24 slots the python router in ops/benes.py is far
                      too slow; the native one keeps the 10M-edge plan
                      build near half a minute.
  csr_builder.cpp  -> ``build_csr_csc_native``: the O(E + N) counting-sort
                      CSR + CSC builder that ``csr.from_coo`` takes first.
  louvain.cpp      -> ``louvain_move_native``: Louvain's local-move loop
                      (ops/louvain.py), the same double operations in the
                      same order as its python loop.

Each library is built with ``g++`` into the port's build directory at
first use.  Without a compiler the callers take their numpy paths.
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

_lock = threading.Lock()
_libs: dict = {}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
_F64P = ctypes.POINTER(ctypes.c_double)

# source -> {function: (restype, argtypes)}
_SIGNATURES = {
    "benes_router.cpp": {
        "benes_route": (ctypes.c_int, [_I64P, _I64, _U8P])},
    "csr_builder.cpp": {
        "build_csr_csc": (ctypes.c_int, [
            _I64P, _I64P, _F32P, _I64, _I64, _I64, _I64,
            _I32P, _I32P, _F32P, _I32P, _I32P, _F32P, _I32P, _F32P,
            _I32P])},
    "louvain.cpp": {
        "louvain_move": (ctypes.c_int, [
            _I64, _I64P, _I64P, _F64P, _F64P, _I64P, ctypes.c_double,
            ctypes.c_double, _I64P, _F64P])},
}

# source -> compiler flags beyond the common ones
_EXTRA_FLAGS = {"louvain.cpp": ["-ffp-contract=off"]}


def _load(source: str):
    """Load (building if needed) one native library, or None when the host
    has no C++ compiler or the build fails.  Tried once per process."""
    with _lock:
        if source in _libs:
            return _libs[source]
        _libs[source] = None
        src = os.path.join(PKG_DIR, "native", source)
        out = lib_path(src)
        if not os.path.exists(out):
            if shutil.which("g++") is None:
                log.info("no g++ on this host; %s not built", source)
                return None
            try:
                compile_all([(["g++", "-O3", "-std=c++17", "-shared",
                               "-fPIC", "-Wall",
                               *_EXTRA_FLAGS.get(source, ()), src], out)])
            except (OSError, RuntimeError) as e:
                log.warning("%s did not build (%s)", source, e)
                return None
        lib = ctypes.CDLL(out)
        for name, (restype, argtypes) in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[source] = lib
        return lib


def get_router():
    """The Benes router library, or None when it cannot be built here."""
    return _load("benes_router.cpp")


def get_csr_builder():
    """The CSR builder library, or None when it cannot be built here."""
    return _load("csr_builder.cpp")


def get_louvain():
    """The Louvain move library, or None when it cannot be built here."""
    return _load("louvain.cpp")


def louvain_move_native(indptr, nbr, nbr_w, k, order, m2: float,
                        min_gain: float):
    """(community of each node, total gain) of Louvain's local-move loop
    (native/louvain.cpp), or None when the library cannot be built
    here."""
    lib = get_louvain()
    if lib is None:
        return None
    n = len(k)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    nbr = np.ascontiguousarray(nbr, dtype=np.int64)
    nbr_w = np.ascontiguousarray(nbr_w, dtype=np.float64)
    k = np.ascontiguousarray(k, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    comm = np.empty(n, dtype=np.int64)
    gain = np.zeros(1, dtype=np.float64)
    lib.louvain_move(n, indptr.ctypes.data_as(_I64P),
                     nbr.ctypes.data_as(_I64P), nbr_w.ctypes.data_as(_F64P),
                     k.ctypes.data_as(_F64P), order.ctypes.data_as(_I64P),
                     float(m2), float(min_gain), comm.ctypes.data_as(_I64P),
                     gain.ctypes.data_as(_F64P))
    return comm, float(gain[0])


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
    rc = lib.benes_route(perm.ctypes.data_as(_I64P), N,
                         out.ctypes.data_as(_U8P))
    if rc != 0:
        raise ValueError("invalid permutation for benes_route")
    return out


def build_csr_csc_native(src: np.ndarray, dst: np.ndarray, weights,
                         n_nodes: int, n_pad: int, e_pad: int):
    """Run the native CSR + CSC builder.  Returns a dict of the padded
    arrays (``csr_src``, ``csr_dst``, ``csr_w``, ``csc_src``, ``csc_dst``,
    ``csc_w``, ``row_ptr``, ``out_degree``, ``col_ptr``), or None when the
    builder is unavailable or fails (the caller then takes the numpy path).  An
    endpoint id outside [0, n_nodes) raises ValueError."""
    lib = get_csr_builder()
    if lib is None:
        return None
    n_edges = len(src)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if len(dst) != n_edges or (weights is not None
                               and len(weights) != n_edges):
        raise ValueError("src, dst and weights must have one entry an edge")
    w_ptr = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float32)
        w_ptr = weights.ctypes.data_as(_F32P)
    out = {name: np.empty(e_pad, dtype=dt) for name, dt in (
        ("csr_src", np.int32), ("csr_dst", np.int32), ("csr_w", np.float32),
        ("csc_src", np.int32), ("csc_dst", np.int32), ("csc_w", np.float32))}
    out["row_ptr"] = np.empty(n_pad + 1, dtype=np.int32)
    out["col_ptr"] = np.empty(n_pad + 1, dtype=np.int32)
    out["out_degree"] = np.empty(n_pad, dtype=np.float32)

    def ptr(name):
        a = out[name]
        return a.ctypes.data_as(_F32P if a.dtype == np.float32 else _I32P)

    rc = lib.build_csr_csc(
        src.ctypes.data_as(_I64P), dst.ctypes.data_as(_I64P), w_ptr,
        n_edges, n_nodes, n_pad, e_pad,
        *(ptr(k) for k in ("csr_src", "csr_dst", "csr_w", "csc_src",
                           "csc_dst", "csc_w", "row_ptr", "out_degree",
                           "col_ptr")))
    if rc == 2:
        # invalid input, not "builder unavailable": the numpy path would
        # build a corrupt graph from the same ids
        raise ValueError(
            f"edge endpoint id out of range [0, {n_nodes}) in COO input")
    if rc != 0:
        log.warning("native csr builder returned %d; numpy path in use", rc)
        return None
    build_csr_csc_native.served += 1
    return out


#: graphs the native builder has built in this process
build_csr_csc_native.served = 0
