"""Native host runtime (C++), built on demand.

The reference's tree runtime is C (utilities.c/io.c); phyml_tpu_torch keeps
the device math in PyTorch/CUDA and moves the scalar host loops — the
postorder schedule, the newick tokenizer, subtree masks —
into `treekit.cpp`, compiled here with the system toolchain on first
use and cached next to the source.  Everything degrades gracefully to
the pure-Python implementations (set PHYML_TPU_NATIVE=0 to force
that, e.g. when no compiler is available).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "treekit.cpp")
_SO = os.path.join(_DIR, f"libtreekit-{sys.platform}.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", _SRC,
           "-o", _SO + ".tmp"]
    try:
        subprocess.run(cmd, check=True, capture_output=True,
                       timeout=120)
        os.replace(_SO + ".tmp", _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The loaded treekit library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PHYML_TPU_NATIVE", "1") == "0":
            return None
        stale = (not os.path.exists(_SO)
                 or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.treekit_rooted_view.argtypes = [
            ctypes.c_int, i32p, f64p, i32p, i32p, f64p, i32p, i32p]
        lib.treekit_rooted_view.restype = ctypes.c_int
        lib.treekit_descendants.argtypes = [
            ctypes.c_int, i32p, ctypes.c_int32, u8p]
        lib.treekit_descendants.restype = ctypes.c_int
        lib.treekit_parse_newick.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            i64p, f64p, i64p, i64p]
        lib.treekit_parse_newick.restype = ctypes.c_long
        _lib = lib
        return _lib


def rooted_view_arrays(n_otu: int, edges: np.ndarray,
                       blen: np.ndarray):
    """Native postorder schedule; returns None to signal fallback."""
    lib = get_lib()
    if lib is None or n_otu < 3:
        return None
    n_nodes = 2 * n_otu - 1
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    blen = np.ascontiguousarray(blen, dtype=np.float64)
    child = np.empty((n_otu - 1) * 2, dtype=np.int32)
    parent = np.empty(n_nodes, dtype=np.int32)
    node_blen = np.empty(n_nodes, dtype=np.float64)
    node_to_edge = np.empty(n_nodes, dtype=np.int32)
    unrooted_id = np.empty(n_nodes, dtype=np.int32)
    rc = lib.treekit_rooted_view(n_otu, edges.reshape(-1), blen,
                                 child, parent, node_blen,
                                 node_to_edge, unrooted_id)
    if rc != 0:
        return None
    return (child.reshape(n_otu - 1, 2), parent, node_blen,
            node_to_edge, unrooted_id)


def descendants(n_otu: int, child: np.ndarray, v: int):
    """Native subtree mask; returns None to signal fallback."""
    lib = get_lib()
    if lib is None:
        return None
    child = np.ascontiguousarray(child, dtype=np.int32)
    out = np.empty(2 * n_otu - 1, dtype=np.uint8)
    rc = lib.treekit_descendants(n_otu, child.reshape(-1),
                                 np.int32(v), out)
    if rc != 0:
        return None
    return out.astype(bool)


def parse_newick_arrays(text: str):
    """Native newick tokenizer.  Returns (parent, length, names) in
    preorder — names[i] is '' for unnamed internals; length[i] is NaN
    when absent — or None to signal fallback."""
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode("utf-8")
    # every node consumes at least one structural char
    max_nodes = max(8, data.count(b",") * 2 + data.count(b"(") + 4)
    parent = np.empty(max_nodes, dtype=np.int64)
    length = np.empty(max_nodes, dtype=np.float64)
    name_off = np.empty(max_nodes, dtype=np.int64)
    name_len = np.empty(max_nodes, dtype=np.int64)
    rc = lib.treekit_parse_newick(data, len(data), max_nodes,
                                  parent, length, name_off, name_len)
    if rc <= 0:
        if rc in (-2, -3, -4):
            raise ValueError(f"malformed newick (treekit code {rc})")
        return None
    n = int(rc)
    names = [
        data[name_off[i]:name_off[i] + name_len[i]].decode("utf-8")
        if name_len[i] else "" for i in range(n)
    ]
    return parent[:n].copy(), length[:n].copy(), names
