"""DBoW2 vocabulary files: load ORBvoc trees, assign words, score (port of
``tpuslam/place/dbow_compat.py``).

The reference's system boots from a pre-trained ORB vocabulary in DBoW2's
text or binary format (System.cc:69-75; TemplatedVocabulary.h:1350-1437
text, :1525-1567 binary).  :func:`load_vocabulary` parses either into a
:class:`TreeVocabulary` of flat tensors (children table, packed node
descriptors, idf weights, leaf word ids).  The text parse is numpy's
``loadtxt`` (the plain version) or, with ``native=True``, the one-pass
``strtof`` scanner of ``native/vocab_loader.cpp``, built with the host
compiler into ``kernels/_build/`` at first use; a failed build raises.

:func:`assign_words` replays DBoW2's greedy descent (the nearest child by
Hamming distance at each level) for every descriptor at once,
:func:`bow_sparse` folds a frame's words into a padded sparse tf-idf vector
and :func:`l1_scores` is DBoW2's L1 score ``sum_w min(q_w, d_w)`` of a query
against a database of such vectors.  ``vocab.load_flat_vocabulary`` flattens
a tree's leaves into the codebook the ``Tracker`` uses.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..map.mapstate import popcount32

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "vocab_loader.cpp"


class TreeVocabulary(NamedTuple):
    """A DBoW2 k-ary vocabulary tree as flat tensors (node 0 is the root)."""

    children: torch.Tensor  # (n_nodes, k) int32 child node ids, -1 padded
    node_desc: torch.Tensor  # (n_nodes, 8) int32 words of the packed 256-bit centroids
    node_weight: torch.Tensor  # (n_nodes,) float32 idf weight (leaves)
    node_word: torch.Tensor  # (n_nodes,) int32 word id, -1 for inner nodes
    k: int
    depth: int  # L

    @property
    def n_words(self) -> int:
        return int((self.node_word >= 0).sum())


@functools.lru_cache(maxsize=None)
def _native_lib():
    from ..kernels import build

    lib = build.load_host(NATIVE_SRC)
    lib.vocab_parse_text.restype = ctypes.c_void_p
    lib.vocab_parse_text.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.vocab_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.vocab_data.argtypes = [ctypes.c_void_p]
    lib.vocab_free.argtypes = [ctypes.c_void_p]
    return lib


def native_parse_text(path: str):
    """(header (k, L, scoring, weighting), (rows, 35) float32) by the native
    scanner."""
    lib = _native_lib()
    rows, cols = ctypes.c_int(), ctypes.c_int()
    header = (ctypes.c_int * 4)()
    h = lib.vocab_parse_text(str(path).encode(), ctypes.byref(rows), ctypes.byref(cols), header)
    if not h:
        raise FileNotFoundError(path)
    try:
        n = rows.value * cols.value
        data = np.ctypeslib.as_array(lib.vocab_data(h), shape=(n,)).reshape(rows.value, cols.value).copy()
    finally:
        lib.vocab_free(h)
    return tuple(header), data


def numpy_parse_text(path: str):
    """The plain version of :func:`native_parse_text`."""
    with open(path, "r") as f:
        header = tuple(int(x) for x in f.readline().split()[:4])
        data = np.loadtxt(f, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    return header, data


def pack_desc_bytes(desc_bytes) -> np.ndarray:
    """(n, 32) uint8 -> (n, 8) uint32 little-endian words (bit i of byte b is
    pattern bit 8b + i, the ORB extractor's packing)."""
    return desc_bytes.astype(np.uint8).reshape(-1, 8, 4).view(np.uint32)[..., 0].reshape(-1, 8)


def build_tree(header, mat, device="cuda:0") -> TreeVocabulary:
    """Rows of (parent, is_leaf, d0..d31, weight), node ids 1.. in file order
    -> the tree's tensors on ``device``."""
    k, L = int(header[0]), int(header[1])
    n_nodes = mat.shape[0] + 1  # + root
    parent = mat[:, 0].astype(np.int64)
    is_leaf = mat[:, 1] > 0.5
    desc = np.clip(mat[:, 2:34], 0, 255).astype(np.uint8)
    children = np.full((n_nodes, k), -1, np.int32)
    slot = np.zeros(n_nodes, np.int32)
    for nid, pid in zip(range(1, n_nodes), parent):  # one linear pass
        s = slot[pid]
        if s < k:
            children[pid, s] = nid
            slot[pid] = s + 1
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    node_desc[1:] = pack_desc_bytes(desc)
    node_weight = np.zeros(n_nodes, np.float32)
    node_weight[1:] = mat[:, 34]
    node_word = np.full(n_nodes, -1, np.int32)
    node_word[1:][is_leaf] = np.arange(int(is_leaf.sum()), dtype=np.int32)

    def t(a):
        return torch.from_numpy(a).to(device)

    return TreeVocabulary(children=t(children), node_desc=t(node_desc.view(np.int32)), node_weight=t(node_weight),
                          node_word=t(node_word), k=k, depth=L)


def load_vocabulary_text(path: str, device="cuda:0", native: bool = False) -> TreeVocabulary:
    """DBoW2 text format: a "k L scoring weighting" header, then one
    "parent is_leaf d0..d31 weight" row per node."""
    header, data = (native_parse_text if native else numpy_parse_text)(path)
    if data.shape[1] != 35:
        raise ValueError(f"{path}: vocabulary rows have {data.shape[1]} values (want 35)")
    return build_tree(header, data, device)


def load_vocabulary_binary(path: str, device="cuda:0") -> TreeVocabulary:
    """The binary format of the ORB-SLAM2 fork: u32 nb_nodes, u32 size_node,
    i32 k, i32 L, i32 scoring, i32 weighting, then per node i32 parent, 32
    descriptor bytes, f32 weight, u8 is_leaf (``size_node`` bytes each)."""
    raw = np.fromfile(path, np.uint8)
    nb_nodes, size_node = raw[:8].view(np.uint32)[:2]
    k, L = raw[8:16].view(np.int32)[:2]
    rows = raw[24:24 + int(nb_nodes) * int(size_node)].reshape(int(nb_nodes), int(size_node))
    parent = rows[:, 0:4].copy().view(np.int32)[:, 0].astype(np.float32)
    desc = rows[:, 4:36].astype(np.float32)
    weight = rows[:, 36:40].copy().view(np.float32)[:, 0]
    is_leaf = (rows[:, 40] != 0).astype(np.float32)
    mat = np.column_stack([parent, is_leaf, desc, weight]).astype(np.float32)
    return build_tree((int(k), int(L), 0, 0), mat, device)


def load_vocabulary(path: str, device="cuda:0", native: bool = False) -> TreeVocabulary:
    """A ``.bin`` file in the binary format, anything else as text."""
    if str(path).endswith(".bin"):
        return load_vocabulary_binary(path, device)
    return load_vocabulary_text(path, device, native)


def assign_words(tv: TreeVocabulary, desc, valid):
    """(N, 8) descriptor words -> ((N,) int32 word ids, (N,) idf weights) by
    the greedy descent, one level of all N at a time; invalid rows get word
    -1 and weight 0.  Ties go to the first child, as DBoW2's strict ``<``."""
    node = torch.zeros(desc.shape[0], dtype=torch.long, device=desc.device)
    for _ in range(tv.depth + 1):  # + 1: a leaf may sit one level deeper
        ch = tv.children[node]  # (N, k)
        dist = popcount32(tv.node_desc[ch.clamp(min=0).long()] ^ desc[:, None, :]).sum(dim=-1)
        dist = torch.where(ch >= 0, dist, 1 << 30)
        nxt = torch.gather(ch, 1, torch.argmin(dist, dim=1, keepdim=True))[:, 0]
        node = torch.where(nxt >= 0, nxt.long(), node)  # stop at leaves
    word = torch.where(valid, tv.node_word[node], -1)
    weight = torch.where(word >= 0, tv.node_weight[node], 0.0)
    return word, weight


def bow_sparse(words, weights):
    """Per-descriptor (word, idf) -> a padded sparse BoW vector (uwords (N,),
    uweights (N,)): each word's summed weight on its first slot in sorted
    order, 0 and word -1 elsewhere, L1-normalized (DBoW2's BowVector
    addWeight + normalize)."""
    n = words.shape[0]
    order = torch.argsort(torch.where(words >= 0, words, 1 << 30), stable=True)
    w = words[order]
    wt = torch.where(w >= 0, weights[order], 0.0)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=w.device), w[1:] != w[:-1]])
    run_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    run_mass = torch.zeros(n, dtype=wt.dtype, device=w.device).index_add(0, run_id, wt)
    mass = torch.where(is_start, run_mass[run_id], 0.0)
    uwords = torch.where((w >= 0) & (mass > 0), w, -1)
    mass = torch.where(uwords >= 0, mass, 0.0)
    return uwords, mass / torch.clamp(mass.sum(), min=1e-12)


def l1_scores(q_words, q_weights, db_words, db_weights, db_valid):
    """DBoW2's L1 score of a query (N,) sparse BoW against (K, N) ones:
    ``sum_w min(q_w, d_w)``, -1 for invalid keyframes."""
    eq = (q_words[None, :, None] == db_words[:, None, :]) & (q_words >= 0)[None, :, None]
    pair_min = torch.minimum(q_weights[None, :, None], db_weights[:, None, :])
    s = torch.where(eq, pair_min, 0.0).sum(dim=(1, 2))
    return torch.where(db_valid, s, -1.0)
