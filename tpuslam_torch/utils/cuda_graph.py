"""An eager function replayed as CUDA graphs, one per input signature.

``graph/lm.py`` runs the two-phase local BA this way on a card.  :func:`run`
calls ``body(tensors, consts)``, a function of a flat tuple of tensors
(``None`` where an input is absent) and a tuple of Python numbers that
returns a flat tuple of tensors, reads nothing back to the host and has
fixed shapes and trip counts.

On a CUDA device the first call of a signature (:func:`signature_key`)
captures ``body`` on static copies of its inputs; every call copies its
inputs into them, replays the graph on the current stream and returns
copies of the outputs.  A replay issues the kernels the body issues, with
the same arguments, in the same order.  CPU tensors run the body.  Each
caller keeps its own cache and counts (a family of graphs): the graphs of
a family share one memory pool per device, taken from a live graph of the
family (a pool freed with its last graph and then shared trips an
allocator assert), and every family captures on one stream per device.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple

import torch

from .profiler import Spans


class Graph(NamedTuple):
    graph: object  # torch.cuda.CUDAGraph
    inputs: tuple  # static copies of the tensor inputs, None where absent
    outputs: tuple  # static outputs
    passthrough: tuple  # per output: the index of the input it is, or -1


def new_counts() -> dict:
    """A family's counts: graphs captured (``captures``), calls that
    replayed one (``replays``), calls that ran the eager body (``eager``:
    CPU tensors and every fallback), and of those the calls on a CUDA
    device (``fallbacks``: a capturing stream, constants that are not
    numbers, inputs on more than one device, a signature whose capture
    failed)."""
    return {"captures": 0, "replays": 0, "eager": 0, "fallbacks": 0}


# per device: the stream every graph is captured on
_CAPTURE_STREAMS: dict = {}


def signature_key(device, tensors, consts):
    """What a captured graph is specific to: the device, each tensor input's
    shape, strides and dtype (``None`` for an absent one), and the
    constants, which the graph holds as kernel arguments and trip counts.
    None where a constant is not a Python number or an input lies on
    another device than ``device``: the graph cannot stand for the call."""
    if not all(isinstance(c, (int, float)) for c in consts) or any(
            t is not None and t.device != device for t in tensors):
        return None
    sig = tuple(None if t is None else (tuple(t.shape), t.stride(), t.dtype) for t in tensors)
    return (device, *sig, *consts)


def run(body, tensors, consts, device, graphs: dict, counts: dict, name: str, span: str):
    """``body(tensors, consts)``, as a replay of the signature's graph where
    ``device`` is a card.  ``graphs``: the family's cache, key -> :class:`Graph`
    or None once a capture failed; ``counts``: the family's counts
    (:func:`new_counts`); ``name`` heads a failed capture's warning; ``span``
    times each capture (``utils/profiler.Spans``).

    Capture and replay run on ``device`` whichever device is current.  The
    returned tensors are the caller's own: copies of the graph's outputs,
    or the caller's input where the body returned an input unchanged;
    never a static buffer."""
    if device.type != "cuda":
        counts["eager"] += 1
        return body(tensors, consts)
    # streams, capture and replay act on the current device: make it the inputs'
    with torch.cuda.device(device):
        key = None if torch.cuda.is_current_stream_capturing() else signature_key(device, tensors, consts)
        if key is not None and key not in graphs:
            graphs[key] = _capture(body, tensors, consts, graphs, counts, name, span)
        entry = graphs.get(key)
        if entry is None:
            counts["eager"] += 1
            counts["fallbacks"] += 1
            return body(tensors, consts)
        for buf, t in zip(entry.inputs, tensors):
            if t is not None:
                buf.copy_(t)
        entry.graph.replay()
        counts["replays"] += 1
        return tuple(tensors[i] if i >= 0 else None if o is None else o.clone()
                     for o, i in zip(entry.outputs, entry.passthrough))


def _capture(body, tensors, consts, graphs, counts, name, span):
    """Capture ``body`` on static copies of ``tensors``, on the current
    device: one eager warm-up on the device's capture stream (library
    handles and workspaces), then the capture on that stream into the
    memory pool of the family's live graphs on the device (a new pool for
    the first).  The host never waits on the device here.  Returns the
    cache entry, or None (with a warning) if the capture raised or recorded
    no work."""
    cur = torch.cuda.current_stream()
    if cur.device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[cur.device] = torch.cuda.Stream()
    side = _CAPTURE_STREAMS[cur.device]
    # a pool lives as long as a graph that uses it, so it is taken from one
    pool = next((e.graph.pool() for k, e in graphs.items() if e is not None and k[0] == cur.device), None)
    inputs = tuple(None if t is None else torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                                device=t.device).copy_(t)
                   for t in tensors)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for graph_nodes
        with Spans().span(span):
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                body(inputs, consts)
                # thread_local: the stream node and the prefetching loader
                # launch work from other threads during the capture
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outputs = body(inputs, consts)
                finally:
                    graph.capture_end()
            if graph_nodes(graph) == 0:
                raise RuntimeError("the capture recorded no work")
            graph.instantiate()
    except Exception as e:  # any failure to capture falls back to the eager body
        warnings.warn(f"{name}: CUDA graph capture failed, running the eager body: {e!r}")
        return None
    finally:
        cur.wait_stream(side)
    counts["captures"] += 1
    index = {id(t): i for i, t in enumerate(inputs) if t is not None}
    return Graph(graph, inputs, outputs, tuple(-1 if o is None else index.get(id(o), -1) for o in outputs))


def graph_nodes(graph) -> int:
    """Nodes of a captured graph kept with ``keep_graph=True``, as
    ``cuGraphGetNodes`` counts them."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t))
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned CUresult {rc}")
    return n.value
