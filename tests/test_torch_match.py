"""Parity of tpuslam_torch.kernels.match and kernel K2's plain version with
the JAX package, on the CPU.

Tolerances: Hamming distances are integers in float32, so d1 and d2 are
compared for equality, and idx too: both packages take the lower index
among tied minima (jnp.argmin; the Pallas fold keeps the earlier tile).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpuslam.kernels import match as jm
from tpuslam.kernels.orb import unpack_descriptor_bits as j_unpack_bits
from tpuslam.kernels.pallas_match import _dense_top2, hamming_top2 as pallas_top2
from tpuslam_torch.kernels import cuda_match
from tpuslam_torch.kernels import match as tm


def _desc(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy -> tensor; uint32 descriptor words are carried as int32."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _top2_inputs(N=200, M=700, seed=0):
    a, b = _desc(N, seed), _desc(M, seed + 1)
    b[5] = b[3]  # exact duplicate columns: a tie the lower index must win
    a[7] = b[3]
    valid_b = np.random.RandomState(seed + 2).rand(M) > 0.2
    valid_b[[3, 5]] = True
    return a, b, valid_b


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_top2_plain_matches_dense_reference(seed):
    a, b, valid_b = _top2_inputs(seed=seed)
    ref = [np.asarray(x) for x in _dense_top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid_b))]
    got = [x.numpy() for x in cuda_match.hamming_top2_plain(_t(a), _t(b), _t(valid_b))]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert got[0].dtype == np.int32 and got[0][7] == 3 and got[1][7] == 0.0 and got[2][7] == 0.0


def test_hamming_top2_plain_matches_pallas_kernel_interpret():
    """The Pallas kernel in interpret mode (200 x 700, as test_pallas_match.py)."""
    a, b, valid_b = _top2_inputs()
    ref = [np.asarray(x) for x in pallas_top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid_b), interpret=True)]
    got = [x.numpy() for x in cuda_match.hamming_top2_plain(_t(a), _t(b), _t(valid_b))]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


def test_hamming_top2_edge_cases_match_dense_reference():
    """All columns invalid, and a single column (d2 is then the 1e9 cap)."""
    a, b = _desc(9, 3), _desc(4, 4)
    for bb, vb in [(b, np.zeros(4, bool)), (b[:1], np.ones(1, bool))]:
        ref = [np.asarray(x) for x in _dense_top2(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(vb))]
        got = [x.numpy() for x in cuda_match.hamming_top2_plain(_t(a), _t(bb), _t(vb))]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


def test_hamming_top2_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    a, b, valid_b = _top2_inputs(20, 30)
    before = cuda_match.hamming_top2.launches
    got = cuda_match.hamming_top2(_t(a), _t(b), _t(valid_b))
    assert cuda_match.hamming_top2.launches == before
    for g, r in zip(got, cuda_match.hamming_top2_plain(_t(a), _t(b), _t(valid_b))):
        assert torch.equal(g, r)


def test_hamming_matrix_and_masked_argmin2_match_reference():
    a, b = _desc(31, 5), _desc(47, 6)
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tm.hamming_matrix(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), ref)
    dist = ref.copy()
    dist[:, 10] = dist[:, 3]  # ties
    r = jm.masked_argmin2(jnp.asarray(dist))
    g = tm.masked_argmin2(torch.from_numpy(dist))
    for rr, gg in zip(r, g):
        np.testing.assert_array_equal(gg.numpy(), np.asarray(rr))


def _match_inputs(seed=0, N=120, M=150):
    rng = np.random.RandomState(seed)
    b = _desc(M, seed + 10)
    # a: noisy copies of b's rows (a few flipped bits) plus random rows
    src = rng.randint(0, M, N)
    a = b[src].copy()
    flips = rng.randint(0, 256, (N, 12))
    for i in range(N):
        for f in flips[i, : rng.randint(0, 12)]:
            a[i, f // 32] ^= np.uint32(1 << (f % 32))
    a[N // 2 :] = _desc(N - N // 2, seed + 20)
    uv_b = rng.uniform(0, 200, (M, 2)).astype(np.float32)
    uv_a = (uv_b[src] + rng.normal(0, 5, (N, 2))).astype(np.float32)  # near their source
    valid_a = rng.rand(N) > 0.1
    valid_b = rng.rand(M) > 0.1
    return a, b, valid_a, valid_b, uv_a, uv_b


@pytest.mark.parametrize("variant", ["ungated", "window_gated", "per_row_radius", "mutual"])
def test_match_descriptors_matches_reference(variant):
    a, b, va, vb, uva, uvb = _match_inputs()
    kw = dict(max_dist=60.0, ratio=0.9)
    jargs = [jnp.asarray(x) for x in (a, b, va, vb)]
    targs = [_t(x) for x in (a, b, va, vb)]
    if variant == "window_gated":
        jkw = dict(gate_mask=jm.window_gate(jnp.asarray(uva), jnp.asarray(uvb), 60.0))
        tkw = dict(gate_mask=tm.window_gate(_t(uva), _t(uvb), 60.0))
    elif variant == "per_row_radius":
        rad = np.random.RandomState(9).uniform(20, 90, len(a)).astype(np.float32)
        oa = np.random.RandomState(10).randint(0, 8, len(a)).astype(np.int32)
        ob = np.random.RandomState(11).randint(0, 8, len(b)).astype(np.int32)
        jkw = dict(gate_mask=jm.window_gate(jnp.asarray(uva), jnp.asarray(uvb), jnp.asarray(rad))
                   & jm.octave_gate(jnp.asarray(oa), jnp.asarray(ob), -1, 1))
        tkw = dict(gate_mask=tm.window_gate(_t(uva), _t(uvb), _t(rad))
                   & tm.octave_gate(_t(oa), _t(ob), -1, 1))
    elif variant == "mutual":
        jkw = tkw = dict(mutual=True)
    else:
        jkw = tkw = {}
    ref = jm.match_descriptors(*jargs, **jkw, **kw)
    got = tm.match_descriptors(*targs, **tkw, **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert np.asarray(ref[2]).sum() > 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_consistency_matches_reference(seed):
    """Histogram bins with equal counts are common: the top-3 must break
    ties toward the lower bin, as lax.top_k does."""
    rng = np.random.RandomState(seed)
    n = 90
    # angles on a coarse grid so several bins tie
    angle_a = (rng.randint(0, 6, n) * (2 * np.pi / 6) + 0.01).astype(np.float32)
    angle_b = (rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    idx = rng.randint(0, n, n).astype(np.int32)
    ok = rng.rand(n) > 0.3
    angle_a = angle_a + angle_b[idx]
    ref = jm.rotation_consistency(jnp.asarray(angle_a), jnp.asarray(angle_b), jnp.asarray(idx), jnp.asarray(ok))
    got = tm.rotation_consistency(_t(angle_a), _t(angle_b), torch.from_numpy(idx).long(), _t(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["window_gate", "octave_gate"])
def test_gates_match_reference(name):
    rng = np.random.RandomState(4)
    if name == "window_gate":
        args = (rng.uniform(0, 50, (40, 2)).astype(np.float32), rng.uniform(0, 50, (60, 2)).astype(np.float32), 9.5)
        ref = jm.window_gate(*map(jnp.asarray, args[:2]), args[2])
        got = tm.window_gate(*map(_t, args[:2]), args[2])
    else:
        oa, ob = rng.randint(0, 8, 40).astype(np.int32), rng.randint(0, 8, 60).astype(np.int32)
        ref = jm.octave_gate(jnp.asarray(oa), jnp.asarray(ob), -1, 0)
        got = tm.octave_gate(_t(oa), _t(ob), -1, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- the exactness arguments of kernel K2's design ---------------------------


def _pm1_bytes(words):
    """(n, 8) uint32 -> (n, 256) int8 in {-1, +1} by the kernel's arithmetic:
    nibble q of a word becomes fragment register q, byte j = bit 4q + j."""
    w = words.astype(np.uint64)
    regs = []
    for q in range(8):
        s = (((w >> (4 * q)) & 15) * 0x00204081) & 0x01010101
        regs.append((~(s * 0xFE)) & 0xFFFFFFFF)
    regs = np.stack(regs, axis=2).astype(np.uint32)  # (n, word, q)
    return regs.view(np.int8).reshape(len(words), 256)  # little-endian: byte j of register q


@pytest.mark.parametrize("seed", [0, 1])
def test_pm1_int8_dot_gives_the_popcount_distance(seed):
    a, b = _desc(40, seed), _desc(50, seed + 7)
    a[0], a[1] = 0, 0xFFFFFFFF
    b[0], b[1] = a[1], ~a[2]
    A, B = _pm1_bytes(a), _pm1_bytes(b)
    bits_a = np.asarray(j_unpack_bits(jnp.asarray(a))).astype(np.int8)
    np.testing.assert_array_equal(A, 2 * bits_a - 1)  # the same bit order as the reference
    dot = A.astype(np.int32) @ B.astype(np.int32).T
    assert ((256 - dot) % 2 == 0).all()
    ham = (256 - dot) // 2
    popcount = np.unpackbits((a[:, None, :] ^ b[None, :, :]).view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(ham, popcount)
    np.testing.assert_array_equal(ham, np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    assert ham[1, 0] == 0 and ham[2, 1] == 256


NONE = np.iinfo(np.int64).max


def _fold(dist, cols):
    """Running (best, idx, second) over the columns, in the given (ascending)
    order, as one lane folds its accumulator fragment."""
    n = dist.shape[0]
    best, idx, second = np.full(n, NONE), np.full(n, NONE), np.full(n, NONE)
    for c in cols:
        d = dist[:, c]
        lt = d < best
        second = np.where(lt, best, np.where(d < second, d, second))
        best, idx = np.where(lt, d, best), np.where(lt, c, idx)
    return best, idx, second


def _merge(x, y):
    (bx, ix, sx), (by, iy, sy) = x, y
    take = (by < bx) | ((by == bx) & (iy < ix))
    return np.where(take, by, bx), np.where(take, iy, ix), np.where(take, np.minimum(sy, bx), np.minimum(sx, by))


def _kernel_order_top2(dist, split=4, warps=8, chunk=32):
    """The kernel's partition of the columns and its merge order: slices of a
    cluster, warps taking 32 columns at a time, lanes t owning columns
    2t, 2t+1 of each n8 tile; lanes merged by an xor tree, warps in order,
    slices in order."""
    m = dist.shape[1]
    width = -(-m // split)
    slices = []
    for r in range(split):
        c0, c1 = min(m, r * width), min(m, r * width + width)
        per_warp = []
        for w in range(warps):
            lanes = [_fold(dist, [c for cb in range(c0 + w * chunk, c1, warps * chunk)
                                  for nt in range(4) for e in range(2)
                                  if (c := cb + 8 * nt + 2 * t + e) < c1]) for t in range(4)]
            per_warp.append(_merge(_merge(lanes[0], lanes[1]), _merge(lanes[2], lanes[3])))
        x = per_warp[0]
        for y in per_warp[1:]:
            x = _merge(x, y)
        slices.append(x)
    x = slices[0]
    for y in slices[1:]:
        x = _merge(x, y)
    best, idx, second = x
    return idx.astype(np.int32), best.astype(np.float32), np.minimum(second, 10**9).astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "all_tied", "all_invalid", "m_1", "m_777"])
def test_slice_merge_in_kernel_order_equals_dense_reference(case):
    rng = np.random.RandomState(3)
    n, m = 30, {"m_1": 1, "m_777": 777}.get(case, 300)
    b = _desc(m, 11)
    if case == "ties":
        b[1::3] = b[0::3][: len(b[1::3])]  # every column has an earlier twin
    if case == "all_tied":
        b[:] = b[0]
    a = _desc(n, 12)
    a[:5] = b[:5]
    valid = rng.rand(m) > 0.2
    if case == "all_invalid":
        valid[:] = False
    if case == "m_1":
        valid[:] = True
    ref = [np.asarray(x) for x in _dense_top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))]
    dist = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b))).astype(np.int64)
    dist = np.where(valid[None, :], dist, 10**9)
    got = _kernel_order_top2(dist)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    if case in ("ties", "all_tied"):
        assert (got[1] == got[2]).sum() >= 5  # tied minima surface as d2 == d1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 700), (1024, 1024), (4096, 4096)])
def test_hamming_top2_kernel_matches_plain_on_card(cuda_device, shape):
    a, b, valid_b = _top2_inputs(*shape)
    a, b, valid_b = (_t(x).to(cuda_device) for x in (a, b, valid_b))
    before = cuda_match.hamming_top2.launches
    got = cuda_match.hamming_top2(a, b, valid_b)
    assert cuda_match.hamming_top2.launches == before + 1
    for g, r in zip(got, cuda_match.hamming_top2_plain(a, b, valid_b)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1000x777", "m_1", "all_invalid", "all_tied"])
def test_hamming_top2_kernel_edge_cases_match_plain_on_card(cuda_device, case):
    a, b = _desc(1000, 4), _desc(1 if case == "m_1" else 777, 5)
    if case == "all_tied":
        b[:] = b[0]
    valid = np.random.RandomState(2).rand(len(b)) > 0.2
    if case in ("m_1", "all_invalid"):
        valid[:] = case == "m_1"
    a, b, valid = (_t(x).to(cuda_device) for x in (a, b, valid))
    for g, r in zip(cuda_match.hamming_top2(a, b, valid), cuda_match.hamming_top2_plain(a, b, valid)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_hamming_top2_kernel_refuses_unaligned_descriptors(cuda_device):
    a, b = (_t(_desc(n, s)).to(cuda_device) for n, s in ((9, 1), (17, 2)))
    valid = torch.ones(16, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        cuda_match.hamming_top2(a, b.view(-1)[2:130].view(16, 8), valid)  # 8 bytes off
