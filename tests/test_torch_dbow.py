"""The port's DBoW2 vocabulary loaders, tree word assignment and L1 scoring
(``tpuslam_torch/place/dbow_compat.py``), ``vocab.load_flat_vocabulary`` and
the ORBvoc branch of ``apps/common.build_vocab``, against the JAX package on
the toy trees of ``tests/test_dbow_compat.py`` and a random 3-level tree.

Tolerances: tree arrays, word ids and the flattened codebook equal; idf
weights, sparse BoW weights and L1 scores within 1e-6 (float32 sums in
another order)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dbow_compat import _toy_rows, _write_binary_vocab, _write_text_vocab
from tpuslam.place import dbow_compat as jdc
from tpuslam.place import vocab as jvb
from tpuslam_torch.apps import common
from tpuslam_torch.core import config as tcfg
from tpuslam_torch.core.camera import Camera
from tpuslam_torch.frontend.tracking import Tracker
from tpuslam_torch.place import dbow_compat as tdc
from tpuslam_torch.place import vocab as tvb


def _deep_rows(rng, k=3, L=3):
    rows, level, nid = [], [0], 0
    for lvl in range(L):
        nxt = []
        for p in level:
            for _ in range(k):
                nid += 1
                rows.append((p, 1 if lvl == L - 1 else 0, rng.randint(0, 256, 32), float(rng.rand())))
                nxt.append(nid)
        level = nxt
    return rows


def _same_tree(jt, tt):
    assert (jt.k, jt.depth) == (tt.k, tt.depth) and jt.n_words == tt.n_words
    np.testing.assert_array_equal(np.asarray(jt.children), tt.children.numpy())
    np.testing.assert_array_equal(np.asarray(jt.node_desc), tt.node_desc.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jt.node_weight), tt.node_weight.numpy())
    np.testing.assert_array_equal(np.asarray(jt.node_word), tt.node_word.numpy())


@pytest.mark.parametrize("tree", ["toy", "deep"])
def test_loaders_equal_reference(tmp_path, tree):
    rng = np.random.RandomState(0)
    rows, k, L = (_toy_rows(rng)[0], 2, 2) if tree == "toy" else (_deep_rows(rng), 3, 3)
    tpath, bpath = str(tmp_path / "voc.txt"), str(tmp_path / "voc.bin")
    _write_text_vocab(tpath, k, L, rows)
    _write_binary_vocab(bpath, k, L, rows)
    ref = jdc.load_vocabulary(tpath)
    _same_tree(ref, tdc.load_vocabulary(tpath, "cpu"))
    _same_tree(ref, tdc.load_vocabulary(tpath, "cpu", native=True))
    _same_tree(jdc.load_vocabulary(bpath), tdc.load_vocabulary(bpath, "cpu"))
    h_n, d_n = tdc.native_parse_text(tpath)
    h_p, d_p = tdc.numpy_parse_text(tpath)
    assert tuple(h_n) == tuple(h_p) == (k, L, 0, 0)
    np.testing.assert_array_equal(d_n, d_p)


def test_assignment_bow_and_scores_equal_reference(tmp_path):
    rng = np.random.RandomState(3)
    tpath = str(tmp_path / "voc.txt")
    _write_text_vocab(tpath, 3, 3, _deep_rows(rng))
    jt, tt = jdc.load_vocabulary(tpath), tdc.load_vocabulary(tpath, "cpu")
    q = tdc.pack_desc_bytes(rng.randint(0, 256, (64, 32)).astype(np.uint8))
    np.testing.assert_array_equal(q, jdc._pack_desc_bytes(q.view(np.uint8).reshape(64, 32)))
    valid = rng.rand(64) > 0.2
    jw, jwt = jdc.assign_words(jt, jnp.asarray(q), jnp.asarray(valid))
    tw, twt = tdc.assign_words(tt, torch.from_numpy(q.view(np.int32)), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(np.asarray(jwt), twt.numpy())
    assert (tw.numpy() == -1).sum() == (~valid).sum()
    juw, jut = jdc.bow_sparse(jw, jwt)
    tuw, tut = tdc.bow_sparse(tw, twt)
    np.testing.assert_array_equal(np.asarray(juw), tuw.numpy())
    np.testing.assert_allclose(tut.numpy(), np.asarray(jut), rtol=0, atol=1e-6)
    # a database of three BoWs: the query itself, a disjoint one, an invalid slot
    db_w = torch.stack([tuw, torch.full_like(tuw, -1), tuw])
    db_w[1, :2] = torch.tensor([10**6, 10**6 + 1])
    db_wt = torch.stack([tut, torch.zeros_like(tut), tut])
    db_wt[1, :2] = 0.5
    db_valid = torch.tensor([True, True, False])
    js = jdc.l1_scores(juw, jut, jnp.asarray(db_w.numpy()), jnp.asarray(db_wt.numpy()), jnp.asarray(db_valid.numpy()))
    ts = tdc.l1_scores(tuw, tut, db_w, db_wt, db_valid)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    assert abs(float(ts[0]) - 1.0) < 1e-6 and float(ts[1]) == 0.0 and float(ts[2]) == -1.0


def test_toy_tree_words_weights_and_sparse_bow(tmp_path):
    """tests/test_dbow_compat.py's toy checks, on the port."""
    rng = np.random.RandomState(2)
    rows, descs = _toy_rows(rng)
    tpath = str(tmp_path / "voc.txt")
    _write_text_vocab(tpath, 2, 2, rows)
    tt = tdc.load_vocabulary(tpath, "cpu")
    q = torch.from_numpy(tdc.pack_desc_bytes(np.stack(descs[2:6])).view(np.int32))
    words, weights = tdc.assign_words(tt, q, torch.ones(4, dtype=torch.bool))
    assert words.tolist() == [0, 1, 2, 3]
    np.testing.assert_allclose(weights.numpy(), [0.5, 0.7, 0.9, 1.1], rtol=1e-6)
    uw, uwt = tdc.bow_sparse(torch.tensor([2, 0, 2, -1, 0, 0], dtype=torch.int32),
                             torch.tensor([1.0, 0.5, 1.0, 9.0, 0.5, 0.5]))
    got = {int(a): float(b) for a, b in zip(uw, uwt) if a >= 0}
    assert got.keys() == {0, 2}
    np.testing.assert_allclose([got[0], got[2]], [1.5 / 3.5, 2.0 / 3.5], rtol=1e-6)


@pytest.mark.parametrize("fmt", ["txt", "bin"])
def test_flat_vocabulary_and_build_vocab(tmp_path, fmt):
    rng = np.random.RandomState(4)
    rows, descs = _toy_rows(rng)
    path = str(tmp_path / f"voc.{fmt}")
    (_write_text_vocab if fmt == "txt" else _write_binary_vocab)(path, 2, 2, rows)
    jv, tv = jvb.load_flat_vocabulary(path), tvb.load_flat_vocabulary(path, "cpu")
    assert tv.n_words == jv.n_words == 4
    np.testing.assert_array_equal(np.asarray(jv.centers_pm1), tv.centers_pm1.numpy())
    np.testing.assert_array_equal(np.asarray(jv.idf), tv.idf.numpy())
    q = torch.from_numpy(tdc.pack_desc_bytes(np.stack(descs[2:6])).view(np.int32))
    assert tvb.assign_words(tv, q, torch.ones(4, dtype=torch.bool)).tolist() == [0, 1, 2, 3]

    # the --vocab path branch: caps.vocab_words follows the file, and the
    # Tracker takes the codebook
    caps = tcfg.Capacities(max_keypoints=64, max_keyframes=8, max_points=256, max_planes=4, max_cuboids=2)
    cfg = tcfg.SlamConfig(caps=caps)
    cfg = cfg.replace(orb=dataclasses.replace(cfg.orb, n_features=64))
    voc, cfg2 = common.build_vocab(path, cfg, torch.device("cpu"), native=fmt == "txt")
    assert voc.n_words == cfg2.caps.vocab_words == 4 and cfg.caps.vocab_words == 1024
    cam = Camera.make(300.0, 300.0, 160.0, 120.0, "cpu", width=320, height=240)
    tr = Tracker(cam, cfg2, device="cpu", vocab=voc)
    assert tr.loop_closer.vocab is voc and tuple(tr.map.kf_bow.shape) == (8, 4)
    with pytest.raises(ValueError):
        Tracker(cam, cfg, device="cpu", vocab=voc)
    assert os.path.exists(path)
