"""Parity of tpuslam_torch.kernels.orb and kernel K1's plain version with the
JAX package, on the CPU.

Tolerances: tables bit-equal; FAST+NMS rtol 1e-5 / atol 1e-3 (whole array
against the jnp reference, interior against the Pallas kernel in interpret
mode, whose borders differ by design); extract: the same (level, y, x) in
the same order on >= 99% of keypoints and >= 99.5% descriptor bit agreement
(float-order differences in the pyramid matmuls may flip a comparison).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpuslam.kernels import orb as jorb
from tpuslam.kernels.pallas_fast import _HALO, fast_nms_score as pallas_fast_nms
from tpuslam_torch.kernels import cuda_fast
from tpuslam_torch.kernels import orb as torb
from tpuslam_torch.workload import make_frames


def _blob_image(H=240, W=320, seed=0):
    """Bright squares on a dark noisy background (tests/test_orb.py style)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(H, W).astype(np.float32) * 10.0
    for _ in range(120):
        y, x = rng.randint(20, H - 28), rng.randint(20, W - 28)
        s = rng.randint(4, 12)
        img[y : y + s, x : x + s] += rng.rand() * 150.0 + 50.0
    return np.clip(img, 0, 255).astype(np.float32)


IMAGES = {"wall": lambda: make_frames(1, 240, 320)[0], "blobs": _blob_image}


@pytest.mark.parametrize(
    "name",
    ["fast_ring", "brief_pattern", "ic_angle_weights", "resize_240_200", "resize_320_267",
     "resize_480_400", "resize_640_533"],
)
def test_tables_bit_equal(name):
    if name.startswith("resize"):
        _, src, dst = name.split("_")
        ref, got = jorb._resize_matrix(int(src), int(dst)), torb._resize_matrix(int(src), int(dst))
    else:
        ref = {"fast_ring": jorb._FAST_RING, "brief_pattern": jorb._BRIEF_PAIRS,
               "ic_angle_weights": jorb._IC_WEIGHTS}[name]
        got = {"fast_ring": torb._FAST_RING, "brief_pattern": torb._brief_pattern(),
               "ic_angle_weights": torb._ic_angle_weights()}[name]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == np.asarray(ref).tobytes()


def test_level_dims_and_quota_match_reference():
    assert torb._level_dims(480, 640, 8, 1.2) == jorb._level_dims(480, 640, 8, 1.2)
    assert sum(torb._level_quota(1024, 8, 1.2)) == 1024
    assert torb._level_quota(256, 4, 1.2) == [82, 68, 57, 49]


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_pyramid_matches_reference(image):
    img = IMAGES[image]()
    ref = np.array(jorb.build_pyramid(jnp.asarray(img), 4, 1.2))
    got = torb.OrbExtractor(240, 320, "cpu", n_levels=4).pyramid(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    # the zero padding of the smaller levels is exact
    assert not got[3, 139:, :].any() and not got[3, :, 185:].any()


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_fast_nms_plain_matches_reference_whole_array(image):
    pyr = np.array(jorb.build_pyramid(jnp.asarray(IMAGES[image]()), 4, 1.2))
    ref = np.asarray(jorb._nms3(jorb.fast_response(jnp.asarray(pyr), 20.0, 7.0)))
    got = torb.fast_nms_plain(torch.from_numpy(pyr), 20.0, 7.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert (ref > 0).sum() > 50 and (ref > 1e5).sum() > 5
    # the ring wraps and NMS pads with -inf: the borders are scored too
    assert (got[:, :3, :] > 0).any() or (got[:, :, :3] > 0).any()


def test_fast_nms_plain_matches_pallas_kernel_interior():
    """The Pallas kernel in interpret mode, as tests/test_pallas_fast.py runs it;
    it zero-pads rows where the reference wraps them, so only the interior
    is compared."""
    rng = np.random.RandomState(0)
    H, W = 120, 256
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    p = np.pad(img, 1, mode="edge")
    img = sum(k[i, j] * p[i : i + H, j : j + W] for i in range(3) for j in range(3))
    img[40:43, 60:63] += 120.0
    img[80, 200] -= 110.0
    pyr = np.array(jorb.build_pyramid(jnp.asarray(img), 3, 1.2))
    ref = np.asarray(pallas_fast_nms(jnp.asarray(pyr), 20.0, 7.0, interpret=True))
    got = torb.fast_nms_plain(torch.from_numpy(pyr), 20.0, 7.0).numpy()
    sl = np.s_[:, _HALO : H - _HALO, _HALO : W - _HALO]
    np.testing.assert_allclose(got[sl], ref[sl], rtol=1e-5, atol=1e-3)
    assert (ref[sl] > 0).sum() > 20 and (ref[sl] > 1e5).sum() >= 2


def test_fast_nms_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    pyr = torch.from_numpy(np.array(jorb.build_pyramid(jnp.asarray(_blob_image()), 2, 1.2)))
    before = cuda_fast.fast_nms_score.launches
    got = cuda_fast.fast_nms_score(pyr, 20.0, 7.0)
    assert cuda_fast.fast_nms_score.launches == before
    assert torch.equal(got, torb.fast_nms_plain(pyr, 20.0, 7.0))


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_extract_matches_reference(image):
    img = IMAGES[image]()
    ref = jorb.extract(jnp.asarray(img), n_features=256, n_levels=4)
    got = torb.OrbExtractor(240, 320, "cpu", n_features=256, n_levels=4)(torch.from_numpy(img))
    ref_key = np.stack([np.asarray(ref.octave), np.asarray(ref.uv[:, 1]), np.asarray(ref.uv[:, 0])], 1)
    got_key = np.stack([got.octave.numpy(), got.uv[:, 1].numpy(), got.uv[:, 0].numpy()], 1)
    same = np.all(ref_key == got_key, axis=1)
    assert same.mean() >= 0.99, f"{same.mean():.4f} of keypoints agree"
    assert np.array_equal(np.asarray(ref.valid), got.valid.numpy())
    assert np.asarray(ref.valid).sum() > 100
    np.testing.assert_allclose(got.response.numpy()[same], np.asarray(ref.response)[same], rtol=1e-5, atol=1e-3)
    assert got.desc.dtype == torch.int32 and got.octave.dtype == torch.int32
    bits_ref = np.unpackbits(np.asarray(ref.desc)[same].view(np.uint8))
    bits_got = np.unpackbits(got.desc.numpy()[same].view(np.uint8))
    agree = (bits_ref == bits_got).mean()
    assert agree >= 0.995, f"descriptor bit agreement {agree:.5f}"
    ang = np.abs(np.angle(np.exp(1j * (got.angle.numpy() - np.asarray(ref.angle)))))[same]
    assert np.median(ang) < 1e-4


def test_unpack_descriptor_bits_and_pack_words_match_reference():
    rng = np.random.RandomState(5)
    words = rng.randint(0, 1 << 32, (33, 8), dtype=np.uint64).astype(np.uint32)
    words[0] = 0x80000000  # bit 31 alone: the int32 sign bit
    ref = np.asarray(jorb.unpack_descriptor_bits(jnp.asarray(words)))
    got = torb.unpack_descriptor_bits(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), ref)
    packed = torb.pack_words(got.reshape(33, 8, 32).long())
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), words)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_stable_matches_lax_top_k_tie_order(seed):
    """torch.topk orders ties differently from lax.top_k (lower index
    first); every top-k of the port goes through topk_stable."""
    x = np.array([0, 1, 1, 0, 1], np.float32)
    assert torb.topk_stable(torch.from_numpy(x), 3)[1].tolist() == [1, 2, 4]
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 4, (3, 200)).astype(np.float32)  # many ties
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 37)
    got_v, got_i = torb.topk_stable(torch.from_numpy(x), 37)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


@pytest.mark.cuda
def test_fast_nms_kernel_matches_plain_on_card(cuda_device):
    pyr = torch.from_numpy(np.array(jorb.build_pyramid(jnp.asarray(_blob_image()), 4, 1.2)))
    pyr = pyr.to(cuda_device)
    before = cuda_fast.fast_nms_score.launches
    got = cuda_fast.fast_nms_score(pyr, 20.0, 7.0)
    assert cuda_fast.fast_nms_score.launches == before + 1
    ref = torb.fast_nms_plain(pyr, 20.0, 7.0)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    assert int((got > 0).sum()) == int((ref > 0).sum())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)
