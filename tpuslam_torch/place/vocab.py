"""Visual vocabulary and bag-of-words scoring (port of
``tpuslam/place/vocab.py``).

A flat codebook of ±1 word centres replaces DBoW2's vocabulary tree: word
assignment is one (N, 256) x (256, W) product of unpacked descriptors and an
argmax, and scoring a query against every keyframe is one (K, W) x (W,)
product of L2-normalized tf-idf vectors (the cosine similarity).  The ±1
products are even integers in [-256, 256], exact in float32 with TF32 off,
and ``torch.argmax`` takes the first of tied words as ``jnp.argmax`` does,
so word ids equal the reference's on the CPU and on the card.

The codebook is seeded (``random_vocabulary``) or trained by binary k-means
(``train_kmeans``); both draw from numpy's ``RandomState`` as the reference
does, so the codebooks are equal bit for bit.  :func:`load_flat_vocabulary`
flattens the leaves of a DBoW2 ORBvoc tree (``place/dbow_compat.py``) into
the codebook, with the tree's idf weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.orb import unpack_descriptor_bits
from ..map import mapstate as ms


class Vocabulary(NamedTuple):
    centers_pm1: torch.Tensor  # (W, 256) float32 in {-1, +1}
    # per-word idf weight, fixed when the codebook is made (DBoW2's node
    # weights); None weighs every word 1
    idf: Optional[torch.Tensor] = None  # (W,) float32

    @property
    def n_words(self) -> int:
        return self.centers_pm1.shape[0]

    @property
    def word_idf(self):
        if self.idf is None:
            return torch.ones(self.n_words, dtype=torch.float32, device=self.centers_pm1.device)
        return self.idf


def random_vocabulary(n_words: int = 1024, seed: int = 7, device="cuda:0") -> Vocabulary:
    """Random ±1 centres, a valid LSH codebook for 256-bit binary codes."""
    rng = np.random.RandomState(seed)
    centers = (rng.rand(n_words, 256) > 0.5).astype(np.float32) * 2.0 - 1.0
    return Vocabulary(centers_pm1=torch.from_numpy(centers).to(device))


def _pm1(desc):
    return unpack_descriptor_bits(desc) * 2.0 - 1.0


def from_packed_words(word_desc, idf=None) -> Vocabulary:
    """The codebook from packed 256-bit word centroids ((W, 8) int32 words)."""
    return Vocabulary(centers_pm1=_pm1(word_desc), idf=idf)


def load_flat_vocabulary(path: str, device="cuda:0", native: bool = False) -> Vocabulary:
    """A DBoW2 ORBvoc text or binary file (``dbow_compat.load_vocabulary``;
    ``native``: the compiled text scanner) flattened into the codebook: the
    leaf centroids in word-id order, with their idf weights (reference
    vocab.py:64-77).  Word assignment becomes the exact nearest leaf instead
    of the tree's greedy descent."""
    from .dbow_compat import load_vocabulary

    tv = load_vocabulary(path, device, native)
    words = tv.node_word.cpu().numpy()
    leaves = np.flatnonzero(words >= 0)
    order = torch.from_numpy(leaves[np.argsort(words[leaves])]).to(tv.node_desc.device)
    return from_packed_words(tv.node_desc[order], idf=tv.node_weight[order])


def train_kmeans(descriptors, n_words: int = 1024, n_iters: int = 8, seed: int = 7) -> Vocabulary:
    """Binary k-means (majority-vote centres) on (N, 8) int32 descriptor
    words, with per-word idf weights from the training corpus occupancy
    (DBoW2's setNodeWeights).  Every count and vote is an integer, so the
    centres equal the reference's."""
    bits = _pm1(descriptors)
    n, dev = bits.shape[0], bits.device
    rng = np.random.RandomState(seed)
    centers = bits[torch.from_numpy(rng.choice(n, n_words, replace=n < n_words)).to(dev)]
    assign = None
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        assign = torch.argmax(bits @ centers.T, dim=1)
        sums = torch.zeros((n_words, 256), device=dev).index_add(0, assign, bits)
        counts = torch.zeros(n_words, device=dev).index_add(0, assign, ones)
        centers = torch.where((counts > 0)[:, None], torch.where(sums >= 0, 1.0, -1.0), centers)
    counts = torch.zeros(n_words, device=dev).index_add(0, assign, ones)
    idf = torch.log(torch.tensor(n + 1, dtype=torch.float32, device=dev) / (counts + 1.0))
    return Vocabulary(centers_pm1=centers, idf=idf)


def assign_words(vocab: Vocabulary, desc, valid):
    """(N, 8) descriptor words -> (N,) int32 word ids, -1 where invalid."""
    words = torch.argmax(_pm1(desc) @ vocab.centers_pm1.T, dim=1).to(torch.int32)
    return torch.where(valid, words, -1)


def bow_vector(vocab: Vocabulary, desc, valid):
    """L2-normalized tf-idf word vector, (W,) float32 (DBoW2's transform)."""
    W = vocab.n_words
    words = assign_words(vocab, desc, valid)
    ones = torch.ones(words.shape[0], dtype=torch.float32, device=words.device)
    hist = torch.zeros(W + 1, device=words.device).index_add(0, torch.where(words >= 0, words, W).long(), ones)[:W]
    v = hist * vocab.word_idf
    return v / torch.clamp(torch.sqrt(torch.sum(v * v)), min=1e-12)


def update_kf_bow(vocab: Vocabulary, m: ms.MapState, kf_slot: int):
    """Store keyframe ``kf_slot``'s BoW vector in the map (KeyFrame::
    ComputeBoW).  Returns (map, bow)."""
    bow = bow_vector(vocab, m.kf_desc[kf_slot], m.kf_kp_valid[kf_slot])
    return m.replace(kf_bow=ms._set_row(m.kf_bow, kf_slot, bow)), bow


def bow_scores(query_bow, db_bows, db_valid):
    """Cosine similarity of a query against a (K, W) database; -1 where
    the keyframe is invalid."""
    return torch.where(db_valid, db_bows @ query_bow, -1.0)
