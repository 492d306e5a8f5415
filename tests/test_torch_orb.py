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
import torch.nn.functional as F

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


# --- the exactness arguments of kernel K1's design ---------------------------

PRETEST_IMAGES = {
    "random": lambda: np.random.RandomState(7).uniform(0, 255, (240, 320)).astype(np.float32),
    "smoothed_noise": lambda: make_frames(1, 240, 320)[0],
}


def _pretest_keep(pyr, kind, weak_th=7.0):
    """Plain-torch early rejection: False only where FAST cannot fire.

    ``compass``: at least two of ring positions 0, 4, 8, 12 bright, or two
    dark (any 9 consecutive positions hold two of them).  ``even_runs``, the
    kernel's: 4 cyclically consecutive even positions all bright, or all
    dark (any 9 consecutive positions hold such a run), written as the
    kernel writes it: fl(v - c) is monotone in v, so "all of a window
    bright" is fl(min(window) - c) > weak."""
    v = [torch.roll(pyr, (-dy, -dx), dims=(-2, -1)) for dy, dx in torb._FAST_RING.tolist()]
    if kind == "compass":
        d = [v[p] - pyr for p in (0, 4, 8, 12)]
        n_bright = sum((x > weak_th).int() for x in d)
        n_dark = sum((x < -weak_th).int() for x in d)
        return (n_bright >= 2) | (n_dark >= 2)
    e = v[0::2]
    lo = [torch.minimum(e[q], e[(q + 1) % 8]) for q in range(8)]
    hi = [torch.maximum(e[q], e[(q + 1) % 8]) for q in range(8)]
    best_lo = torch.stack([torch.minimum(lo[q], lo[(q + 2) % 8]) for q in range(8)]).amax(0)
    best_hi = torch.stack([torch.maximum(hi[q], hi[(q + 2) % 8]) for q in range(8)]).amin(0)
    return (best_lo - pyr > weak_th) | (best_hi - pyr < -weak_th)


def _live_mask(dims, shape):
    live = torch.zeros(shape, dtype=torch.bool)
    for lvl, (h, w) in enumerate(dims):
        live[lvl, :h, :w] = True
    return live


@pytest.mark.parametrize("kind", ["compass", "even_runs"])
@pytest.mark.parametrize("image", sorted(PRETEST_IMAGES))
def test_pretest_rejects_only_pixels_that_score_zero(kind, image):
    pyr_np = np.array(jorb.build_pyramid(jnp.asarray(PRETEST_IMAGES[image]()), 4, 1.2))
    pyr = torch.from_numpy(pyr_np)
    keep = _pretest_keep(pyr, kind)
    score = torb.fast_response(pyr, 20.0, 7.0)
    assert not score[~keep].any()
    live = _live_mask(torb._level_dims(240, 320, 4, 1.2), pyr.shape)
    assert (~keep[live]).float().mean() > (0.02 if kind == "compass" else 0.3)
    # FAST on the kept pixels only, then NMS: the JAX reference, bit for bit
    gated = torb.nms3(torch.where(keep, score, 0.0))
    assert torch.equal(gated, torb.fast_nms_plain(pyr, 20.0, 7.0))
    ref = np.asarray(jorb._nms3(jorb.fast_response(jnp.asarray(pyr_np), 20.0, 7.0)))
    np.testing.assert_allclose(gated.numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", ["compass", "even_runs"])
def test_pretest_gated_score_matches_pallas_kernel_interior(kind):
    """As test_fast_nms_plain_matches_pallas_kernel_interior, with the
    rejected pixels' FAST scores forced to 0 before NMS."""
    rng = np.random.RandomState(1)
    H, W = 120, 256
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    p = np.pad(img, 1, mode="edge")
    img = sum(k[i, j] * p[i : i + H, j : j + W] for i in range(3) for j in range(3))
    pyr_np = np.array(jorb.build_pyramid(jnp.asarray(img), 3, 1.2))
    pyr = torch.from_numpy(pyr_np)
    keep = _pretest_keep(pyr, kind)
    gated = torb.nms3(torch.where(keep, torb.fast_response(pyr, 20.0, 7.0), 0.0)).numpy()
    ref = np.asarray(pallas_fast_nms(jnp.asarray(pyr_np), 20.0, 7.0, interpret=True))
    sl = np.s_[:, _HALO : H - _HALO, _HALO : W - _HALO]
    np.testing.assert_allclose(gated[sl], ref[sl], rtol=1e-5, atol=1e-3)
    assert (ref[sl] > 0).sum() > 20


def _no_live_window(live):
    """(L, H, W) bool -> pixels whose wrapped 4-px window (9 x 9) holds no
    live pixel."""
    x = F.pad(live.float()[:, None], (4, 4, 4, 4), mode="circular")
    return F.max_pool2d(x, 9, stride=1)[:, 0] == 0


# kernel K1's tile and the rule by which it skips one (fast_nms.cu tile_live)
K1_TILE, K1_HALO = (32, 32), 4


def _k1_dead_tiles(dims, H, W):
    th, tw = K1_TILE
    for lvl, (h, w) in enumerate(dims):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                rows = (y0 - K1_HALO < h) or (y0 + th + K1_HALO > H)
                cols = (x0 - K1_HALO < w) or (x0 + tw + K1_HALO > W)
                if not (rows and cols):
                    yield lvl, y0, x0


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_padding_skip_is_exact(image):
    """The pyramid is zero outside each level's live region; the plain output
    (and the JAX reference's) is then exactly 0 on every pixel whose wrapped
    4-px window has no live pixel, and the kernel's tile rule skips only
    tiles made of such pixels."""
    ex = torb.OrbExtractor(240, 320, "cpu", n_levels=4)
    assert ex.live_dims.tolist() == [list(d) for d in ex.dims]
    pyr = ex.pyramid(torch.from_numpy(IMAGES[image]()))
    live = _live_mask(ex.dims, pyr.shape)
    assert not pyr[~live].any()
    dead = _no_live_window(live)
    assert not torb.fast_nms_plain(pyr, 20.0, 7.0)[dead].any()
    ref = np.asarray(jorb._nms3(jorb.fast_response(jnp.asarray(pyr.numpy()), 20.0, 7.0)))
    assert not ref[dead.numpy()].any() and (ref > 0).sum() > 50
    tiles = list(_k1_dead_tiles(ex.dims, 240, 320))
    assert len(tiles) > 10
    th, tw = K1_TILE
    for lvl, y0, x0 in tiles:
        assert dead[lvl, y0 : y0 + th, x0 : x0 + tw].all()


def _strict_on_weak_side(img, strict_th, weak_th):
    """fast_response with the kernel's rule: the strict threshold is tested
    only on the side of the pixel's weak run (fast_nms.cu fast_score)."""
    d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img
                     for dy, dx in torb._FAST_RING.tolist()])
    bits = (1 << torch.arange(16)).view(16, *[1] * img.dim())
    mask = lambda m: (m.long() * bits).sum(0)  # noqa: E731
    bright = torb._has_run9(mask(d > weak_th))
    weak = bright | torb._has_run9(mask(d < -weak_th))
    strict = torb._has_run9(mask(torch.where(bright, d, -d) > strict_th))
    return torch.where(weak, torb.fast_response(img, 1e30, weak_th) + torch.where(strict, 1e6, 0.0), 0.0)


@pytest.mark.parametrize("strict_th,weak_th", [(20.0, 7.0), (7.0, 7.0), (5.0, 7.0), (-3.0, 0.0), (0.0, 0.0)])
def test_strict_on_weak_side_is_exact_for_nonnegative_weak(strict_th, weak_th):
    pyr = torch.from_numpy(np.array(jorb.build_pyramid(jnp.asarray(_blob_image()), 3, 1.2)))
    want = torb.fast_response(pyr, strict_th, weak_th)
    assert (want >= 1e6).any() and (want > 0).any()
    assert torch.equal(_strict_on_weak_side(pyr, strict_th, weak_th), want)


def test_strict_on_weak_side_needs_nonnegative_weak():
    """With weak_th < 0 a pixel can hold both weak runs, and the rule the
    kernel uses differs: the wrapper refuses such a weak_th on the card."""
    img = torch.zeros(1, 9, 9)
    img[0, 4, 4] = 0.7  # every ring difference is -0.7
    got = _strict_on_weak_side(img, 0.5, -1.0)[0, 4, 4]
    assert float(torb.fast_response(img, 0.5, -1.0)[0, 4, 4]) >= 1e6 > float(got)


def test_fast_nms_wrapper_on_cpu_takes_live_dims_and_runs_plain():
    ex = torb.OrbExtractor(240, 320, "cpu", n_levels=4)
    pyr = ex.pyramid(torch.from_numpy(IMAGES["wall"]()))
    before = cuda_fast.fast_nms_score.launches
    got = cuda_fast.fast_nms_score(pyr, 20.0, 7.0, ex.live_dims)
    assert cuda_fast.fast_nms_score.launches == before
    assert torch.equal(got, torb.fast_nms_plain(pyr, 20.0, 7.0))


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


@pytest.mark.cuda
def test_fast_nms_kernel_with_live_dims_matches_plain_on_card(cuda_device):
    ex = torb.OrbExtractor(240, 320, cuda_device, n_levels=4)
    pyr = ex.pyramid(torch.from_numpy(IMAGES["wall"]()).to(cuda_device))
    got = cuda_fast.fast_nms_score(pyr, 20.0, 7.0, ex.live_dims)
    assert torch.equal(got, torb.fast_nms_plain(pyr, 20.0, 7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 45), (1, 5, 7), (2, 64, 68), (8, 480, 640)])
def test_fast_nms_kernel_odd_shapes_match_plain_on_card(cuda_device, shape):
    x = torch.from_numpy(np.random.RandomState(3).uniform(0, 255, shape).astype(np.float32))
    x = x.to(cuda_device)
    assert torch.equal(cuda_fast.fast_nms_score(x, 20.0, 7.0), torb.fast_nms_plain(x, 20.0, 7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("strict_th,weak_th", [(5.0, 7.0), (-3.0, 0.0)])
def test_fast_nms_kernel_strict_below_weak_matches_plain_on_card(cuda_device, strict_th, weak_th):
    pyr = torch.from_numpy(np.array(jorb.build_pyramid(jnp.asarray(_blob_image()), 3, 1.2)))
    pyr = pyr.to(cuda_device)
    got = cuda_fast.fast_nms_score(pyr, strict_th, weak_th)
    assert torch.equal(got, torb.fast_nms_plain(pyr, strict_th, weak_th))


@pytest.mark.cuda
def test_fast_nms_kernel_refuses_negative_weak_threshold(cuda_device):
    pyr = torch.zeros(1, 64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="weak_th"):
        cuda_fast.fast_nms_score(pyr, 0.5, -1.0)


@pytest.mark.cuda
def test_fast_nms_kernel_refuses_a_misaligned_pyramid(cuda_device):
    flat = torch.zeros(1 + 64 * 64, device=cuda_device)
    pyr = flat[1:].view(1, 64, 64)  # contiguous, 4 bytes past a 16-byte boundary
    assert pyr.is_contiguous() and pyr.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        cuda_fast.fast_nms_score(pyr, 20.0, 7.0)
    torch.cuda.synchronize()  # the context is unharmed
