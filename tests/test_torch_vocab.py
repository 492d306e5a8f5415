"""Parity of the port's vocabulary (tpuslam_torch.place.vocab) with the JAX
package's, on the CPU.

Tolerances: the seeded and trained codebooks, the trained centres and the
word ids exact (the ±1 products are integers, exact in float32, and both
argmaxes take the first of tied words); the idf weights, BoW rows and
scores within 1e-6 (a norm and a dot product summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_loop_scene as ls
import _torch_scene as sc
from tpuslam.map import mapstate as jms
from tpuslam.place import vocab as jvb
from tpuslam_torch.place import vocab as tvb


def _desc(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_words,seed", [(1024, 7), (64, 3), (256, 0)])
def test_random_vocabulary_is_the_reference_codebook(n_words, seed):
    want = np.asarray(jvb.random_vocabulary(n_words, seed).centers_pm1)
    got = tvb.random_vocabulary(n_words, seed, device="cpu")
    np.testing.assert_array_equal(got.centers_pm1.numpy(), want)
    assert got.n_words == n_words and torch.equal(got.word_idf, torch.ones(n_words))


def test_words_bow_and_scores_match_reference():
    """Golden-frame ORB descriptors (the JAX package's) and random ones, the
    seeded 1024-word codebook: many words tie for the best score."""
    desc = np.concatenate([np.asarray(sc.jax_frame(0).desc), _desc(300, 1)])
    valid = np.ones(len(desc), bool)
    valid[::7] = False
    voc_j = jvb.random_vocabulary(1024)
    voc_t = tvb.random_vocabulary(1024, device="cpu")
    w_j = np.asarray(jvb.assign_words(voc_j, jnp.asarray(desc), jnp.asarray(valid)))
    w_t = tvb.assign_words(voc_t, ls.t(desc), ls.t(valid)).numpy()
    np.testing.assert_array_equal(w_t, w_j)
    # the ties are real: some rows have several best words, and the first wins
    bits = tvb._pm1(ls.t(desc)) @ voc_t.centers_pm1.T
    n_best = (bits == bits.max(dim=1, keepdim=True).values).sum(dim=1)
    assert int((n_best > 1).sum()) > 10
    b_j = jvb.bow_vector(voc_j, jnp.asarray(desc), jnp.asarray(valid))
    b_t = tvb.bow_vector(voc_t, ls.t(desc), ls.t(valid))
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-6)
    db = np.stack([np.asarray(jvb.bow_vector(voc_j, jnp.asarray(_desc(256, s)), jnp.ones(256, bool)))
                   for s in range(6)] + [np.asarray(b_j)])
    db_valid = np.array([True, True, False, True, True, True, True])
    s_j = jvb.bow_scores(b_j, jnp.asarray(db), jnp.asarray(db_valid))
    s_t = tvb.bow_scores(b_t, ls.t(db), ls.t(db_valid))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    assert float(s_t[-1]) > 0.999 and float(s_t[2]) == -1.0


def test_train_kmeans_matches_reference():
    """Binary k-means on golden-frame descriptors: centres exact, idf 1e-6;
    and the trained codebook's word ids and BoW rows."""
    desc = np.concatenate([np.asarray(sc.jax_frame(f).desc)[np.asarray(sc.jax_frame(f).valid)] for f in (0, 8, 16)])
    voc_j = jvb.train_kmeans(jnp.asarray(desc), n_words=64, n_iters=8, seed=7)
    voc_t = tvb.train_kmeans(ls.t(desc), n_words=64, n_iters=8, seed=7)
    np.testing.assert_array_equal(voc_t.centers_pm1.numpy(), np.asarray(voc_j.centers_pm1))
    np.testing.assert_allclose(voc_t.idf.numpy(), np.asarray(voc_j.idf), rtol=1e-6)
    q = np.asarray(sc.jax_frame(24).desc)
    qv = np.asarray(sc.jax_frame(24).valid)
    np.testing.assert_array_equal(tvb.assign_words(voc_t, ls.t(q), ls.t(qv)).numpy(),
                                  np.asarray(jvb.assign_words(voc_j, jnp.asarray(q), jnp.asarray(qv))))
    np.testing.assert_allclose(tvb.bow_vector(voc_t, ls.t(q), ls.t(qv)).numpy(),
                               np.asarray(jvb.bow_vector(voc_j, jnp.asarray(q), jnp.asarray(qv))), atol=1e-6)
    # fewer descriptors than words: the draw takes some twice
    small = desc[:40]
    np.testing.assert_array_equal(tvb.train_kmeans(ls.t(small), n_words=64, n_iters=2).centers_pm1.numpy(),
                                  np.asarray(jvb.train_kmeans(jnp.asarray(small), n_words=64, n_iters=2).centers_pm1))


def test_from_packed_words_and_update_kf_bow_match_reference():
    words = _desc(32, 9)
    idf = np.random.RandomState(2).uniform(0.1, 2.0, 32).astype(np.float32)
    voc_j = jvb.from_packed_words(words, idf=jnp.asarray(idf))
    voc_t = tvb.from_packed_words(ls.t(words), idf=ls.t(idf))
    np.testing.assert_array_equal(voc_t.centers_pm1.numpy(), np.asarray(voc_j.centers_pm1))
    m_j = sc.jax_map()
    m_j = m_j._replace(kf_bow=jnp.zeros((m_j.kf_bow.shape[0], 32)))
    out_j, bow_j = jvb.update_kf_bow(voc_j, m_j, 3)
    out_t, bow_t = tvb.update_kf_bow(voc_t, ls.tmap(m_j), 3)
    np.testing.assert_allclose(bow_t.numpy(), np.asarray(bow_j), atol=1e-6)
    np.testing.assert_allclose(out_t.kf_bow.numpy(), np.asarray(out_j.kf_bow), atol=1e-6)
    assert float(out_t.kf_bow[3].sum()) > 0 and float(out_t.kf_bow[2].abs().sum()) == 0


def test_build_vocab_resolves_the_vocab_flag():
    """``apps/common.build_vocab``: the seeded codebook for '' and 'lsh', a
    trained one for 'train' (k-means over every 12th sample frame's
    descriptors), and an ORBvoc path read by the DBoW2 loaders (a missing
    file raises; the loaders are held to the reference in
    ``test_torch_dbow.py``)."""
    from tpuslam_torch.apps.common import build_vocab
    from tpuslam_torch.core import config as tcfg

    cfg = tcfg.SlamConfig(caps=tcfg.Capacities(vocab_words=64), orb=tcfg.OrbConfig(n_features=256))
    for name in ("", "lsh"):
        assert build_vocab(name, cfg, "cpu") == (None, cfg)
    with pytest.raises(FileNotFoundError):
        build_vocab("ORBvoc.txt", cfg, "cpu")
    with pytest.raises(ValueError):
        build_vocab("train", cfg, "cpu")
    grays = [sc.frame_u8(f) for f in range(0, 25)]
    voc, cfg2 = build_vocab("train", cfg, "cpu", sample_grays=grays)
    assert cfg2 is cfg and voc.n_words == 64 and voc.idf is not None
    assert bool(torch.isfinite(voc.idf).all()) and set(voc.centers_pm1.unique().tolist()) == {-1.0, 1.0}
