"""The kernel nodes of a captured CUDA graph, read back through libcuda.

A replay of a CUDA graph runs each of its kernel nodes exactly once, so
the nodes of a captured step are the launches every replay makes: a
count that needs no trace.  The graph must have been captured with
``torch.cuda.CUDAGraph(keep_graph=True)`` (``raw_cuda_graph`` is then the
``cudaGraph_t``).  The nodes are read through ``libcuda`` with ctypes:
``cuGraphGetNodes``, ``cuGraphNodeGetType``,
``cuGraphKernelNodeGetParams`` and ``cuFuncGetName`` (``cuKernelGetName``
for a node that holds a library kernel rather than a function).

A child-graph node or a conditional node would run its body zero, one or
many times a replay; a graph holding one is refused.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

__all__ = ["graph_kernel_nodes", "kernel_node_grids"]

_KERNEL, _CHILD_GRAPH, _CONDITIONAL = 0, 4, 13     # CUgraphNodeType


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                     "block_y", "block_z", "smem")] + [
        ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} returned CUresult {rc}")
    return call


def graph_kernel_nodes(graph) -> List[Tuple[str, int]]:
    """``[(mangled kernel name, grid x extent)]`` of every kernel node of
    ``graph`` (a ``torch.cuda.CUDAGraph`` captured with
    ``keep_graph=True``).  Raises if the graph holds a child-graph or a
    conditional node."""
    call = _libcuda()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    kernels, types = [], {}
    for node in nodes[:n.value]:
        t = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(t))
        types[t.value] = types.get(t.value, 0) + 1
        if t.value != _KERNEL:
            continue
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
             ctypes.byref(p))
        if p.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            call("cuKernelGetName", ctypes.byref(name),
                 ctypes.c_void_p(p.kern))
        kernels.append((name.value.decode(), int(p.grid_x)))
    if types.get(_CHILD_GRAPH) or types.get(_CONDITIONAL):
        raise RuntimeError(
            "a captured graph holds child-graph or conditional nodes "
            f"(node types {types}): a replay would not run each kernel "
            "node once")
    return kernels


def kernel_node_grids(graph, match: str) -> Dict[int, int]:
    """Kernel nodes of ``graph`` whose mangled name holds ``match``,
    counted by grid x extent."""
    grids: Dict[int, int] = {}
    for name, gx in graph_kernel_nodes(graph):
        if match in name:
            grids[gx] = grids.get(gx, 0) + 1
    return grids
