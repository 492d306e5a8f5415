"""The two-phase local BA as one CUDA graph (``graph/lm.py:local_ba``).

On the CPU: the dispatcher runs the eager body and returns exactly its
output (the fields the gate leaves alone are the caller's own tensors),
the graph cache's key tells apart what a captured graph is specific to,
and the Tracker's own local BAs give a key.  On a card (``cuda`` marker,
skipped here): the eager body never waits for the device, a replay equals
the eager body bit for bit, returned tensors never alias the graph's
static buffers, a new signature captures a new graph, and a capture that
raises or records nothing falls back to the eager body.  No JAX: the eager
body is held to the JAX package in ``test_torch_ba.py`` and
``test_torch_ba_blocked.py``.

The windows are bench.py's (``workload.ba_window_arrays``): mono points
only, mono with a stereo bundle on half the valid lanes, and the
flagship's bundles (plane observations, their vertical lanes invalid as in
``test_torch_ba_blocked.py``, and cuboid bboxes).
"""

import numpy as np
import pytest
import torch

from tpuslam_torch import workload
from tpuslam_torch.graph import lm
from tpuslam_torch.utils import cuda_graph

BF = 40.0
CASES = ("mono", "stereo", "flagship")
CPU_SIZES = dict(K=4, N=64, P=256, Q=4, C=2)
CARD_SIZES = dict(K=32, N=1024, P=4096, Q=8, C=8)  # the local BA's window at the default capacities
ITERS = dict(phase1_iters=5, phase2_iters=10)


def _window(case, seed=0, device="cpu", **sizes):
    """(state, data, reproj_n) of one case."""
    sizes = {**CPU_SIZES, **sizes}
    state, data = workload.ba_window_arrays(seed, **sizes)
    keep = {"flagship": ("plane_obs", "cub_bbox")}.get(case, ())
    for b in lm.BUNDLES:
        if b not in keep:
            data.pop(b, None)
    if case == "flagship":
        po = data["plane_obs"]
        data["plane_obs"] = {**po, "valid": po["valid"] & (po["kind"] != 1)}
    else:
        data["plane_active"] = np.zeros_like(data["plane_active"])
        data["cuboid_active"] = np.zeros_like(data["cuboid_active"])
    if case == "stereo":
        m = data["mono"]
        T = state["poses"][m["kf"]]
        z = np.einsum("fj,fj->f", T[:, 2, :3], state["points"][m["pt"]]) + T[:, 2, 3]
        ur = m["uv"][:, 0] - BF / np.maximum(z, 1e-3)
        to_stereo = m["valid"] & (np.random.RandomState(seed + 1).rand(ur.shape[0]) < 0.5)
        data["stereo"] = {"kf": m["kf"], "pt": m["pt"], "uvr": np.concatenate([m["uv"], ur[:, None]], 1).astype(
            np.float32), "inv_sigma2": m["inv_sigma2"], "valid": to_stereo}
        data["mono"] = {**m, "valid": m["valid"] & ~to_stereo}
        data["bf"] = BF
    return lm.ba_state_from_numpy(state, device), lm.ba_data_from_numpy(data, device), sizes["N"]


def _bits(t):
    """A tensor's bits: floats compared as integers, so NaNs and signed
    zeros count."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _leaves(out):
    state, data, chi2s = out
    return (*lm._ba_leaves(state, data), chi2s)


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (x is not None and y is not None and x.dtype == y.dtype
                                      and x.shape == y.shape and torch.equal(_bits(x), _bits(y)))
        for x, y in zip(la, lb))


def _solve(fn, state, data, n):
    return fn(state, data, lm.BAWeights(), **ITERS, reproj_n=n)


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty graph cache and zero counts for the test."""
    monkeypatch.setattr(lm, "_BA_GRAPHS", {})
    monkeypatch.setattr(lm, "_BA_GRAPH_COUNTS", cuda_graph.new_counts())


@pytest.mark.parametrize("case", CASES)
def test_dispatcher_on_cpu_is_the_eager_body(fresh_cache, case):
    state, data, n = _window(case, seed=3)
    got = _solve(lm.local_ba, state, data, n)
    want = _solve(lm._local_ba_body, state, data, n)
    assert _same(got, want)
    _, d_out, chi2s = got
    assert chi2s.shape == (ITERS["phase2_iters"],)
    assert d_out.mono.valid is not data.mono.valid and d_out.mono.kf is data.mono.kf
    assert d_out.pose_fixed is data.pose_fixed
    assert (d_out.fx, d_out.fy, d_out.cx, d_out.cy, d_out.bf, d_out.cuboid_fix_scale) == (
        data.fx, data.fy, data.cx, data.cy, data.bf, data.cuboid_fix_scale)
    assert [b for b in ("stereo", *lm.BUNDLES) if getattr(d_out, b) is not None] == \
        [b for b in ("stereo", *lm.BUNDLES) if getattr(data, b) is not None]
    assert lm.ba_graph_counts() == {"captures": 0, "replays": 0, "eager": 1, "fallbacks": 0}
    assert lm._BA_GRAPHS == {}


def _key(case="mono", n_pts=256, dtype=torch.float32, weights=None, transposed=False, drop=None, iters=ITERS,
         reproj_n=None, **data_consts):
    state, data, n = _window(case, P=n_pts)
    state = state._replace(points=state.points.to(dtype))
    if transposed:  # same shape and values, other strides
        data = data._replace(mono=data.mono._replace(uv=data.mono.uv.T.contiguous().T))
    if drop:
        data = data._replace(**{drop: None})
    return lm.ba_graph_key(state, data._replace(**data_consts), weights or lm.BAWeights(), **iters,
                           reproj_n=n if reproj_n is None else reproj_n)


@pytest.mark.parametrize("change", [
    {"fx": 481.2}, {"cy": 239.5}, {"bf": BF}, {"cuboid_fix_scale": 1.0},
    {"weights": lm.BAWeights(chi2_mono=9.21)}, {"weights": lm.BAWeights(bbox_chi=60.0)},
    {"iters": dict(phase1_iters=4, phase2_iters=10)}, {"iters": dict(phase1_iters=5, phase2_iters=8)},
    {"reproj_n": 0}, {"n_pts": 128}, {"dtype": torch.float64}, {"transposed": True},
    {"case": "stereo"}, {"case": "flagship"}, {"case": "flagship", "drop": "cub_bbox"},
], ids=lambda c: "-".join(f"{k}={v}" if not isinstance(v, (dict, lm.BAWeights)) else k for k, v in c.items()))
def test_graph_key_tells_signatures_apart(change):
    assert _key() == _key()  # other data, same signature
    assert _key(**change) != _key()


@pytest.mark.parametrize("where", ["camera", "weight", "iters"])
def test_graph_key_refuses_constants_that_are_not_numbers(where):
    state, data, n = _window("mono")
    w = lm.BAWeights()
    assert lm.ba_graph_key(state, data, w, **ITERS, reproj_n=n) is not None
    if where == "camera":
        data = data._replace(fx=torch.tensor(data.fx))
    elif where == "weight":
        w = w._replace(chi2_mono=np.float32(w.chi2_mono))
    args = dict(ITERS, phase2_iters=torch.tensor(10)) if where == "iters" else ITERS
    assert lm.ba_graph_key(state, data, w, **args, reproj_n=n) is None


@pytest.mark.parametrize("field", ["points", "mono.uv", "pose_fixed"])
def test_graph_key_refuses_inputs_on_two_devices(field):
    state, data, n = _window("mono")
    if field == "points":  # the key's device is the points'
        state = state._replace(points=torch.empty_like(state.points, device="meta"))
    elif field == "mono.uv":
        data = data._replace(mono=data.mono._replace(uv=torch.empty_like(data.mono.uv, device="meta")))
    else:
        data = data._replace(pose_fixed=torch.empty_like(data.pose_fixed, device="meta"))
    assert lm.ba_graph_key(state, data, lm.BAWeights(), **ITERS, reproj_n=n) is None


class _Seen(Exception):
    pass


@pytest.mark.parametrize("mode,bundles", [
    ("points", []), ("flagship", ["plane_obs", "cub_bbox"]), ("rgbd", ["stereo", "plane_obs", "cub_bbox"]),
])
def test_the_trackers_local_ba_gives_a_key(monkeypatch, mode, bundles):
    """``run_local_ba``'s own call, with each mode's configuration, is one a
    graph can stand for: every constant a Python number, the mode's bundles
    present and the rest absent."""
    import chip_smoke
    from tpuslam_torch.apps import golden
    from tpuslam_torch.backend import local_ba

    cam, cfg, m = chip_smoke.ba_map("cpu")
    _, mode_cfg = golden.golden_setup(small=True, flagship=mode == "flagship", rgbd=mode == "rgbd")
    cfg = cfg.replace(sensor=mode_cfg.sensor, flags=mode_cfg.flags, ba=mode_cfg.ba)
    seen = []

    def spy(body, tensors, consts, device, *a, **k):
        seen.append((cuda_graph.signature_key(device, tensors, consts), tensors))
        raise _Seen

    monkeypatch.setattr(cuda_graph, "run", spy)
    with pytest.raises(_Seen):
        local_ba.run_local_ba(m, chip_smoke.BA_CENTER, cam, cfg)
    (key, tensors), = seen
    assert key is not None
    _, data = lm._ba_from_leaves(tensors, (0.0,) * len(lm._BA_CAMERA))
    assert [b for b in ("stereo", *lm.BUNDLES) if getattr(data, b) is not None] == bundles


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_eager_body_never_waits_for_the_card(cuda_device, case):
    """After a first call, which fills the per-device constant tables
    (``core/geometry.py``'s cuboid corner signs) as a capture's warm-up
    does."""
    state, data, n = _window(case, seed=5, device=cuda_device, **CARD_SIZES)
    _solve(lm._local_ba_body, state, data, n)
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _solve(lm._local_ba_body, state, data, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[2].shape == (ITERS["phase2_iters"],)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_graph_equals_eager_bit_for_bit_on_card(cuda_device, fresh_cache, case):
    for seed in (11, 12):
        state, data, n = _window(case, seed=seed, device=cuda_device, **CARD_SIZES)
        got = _solve(lm.local_ba, state, data, n)
        assert _same(got, _solve(lm._local_ba_body, state, data, n))
        assert got[1].pose_fixed is data.pose_fixed and got[1].mono.uv is data.mono.uv
    assert lm.ba_graph_counts() == {"captures": 1, "replays": 2, "eager": 0, "fallbacks": 0}


@pytest.mark.cuda
def test_replays_in_a_row_keep_earlier_outputs(cuda_device, fresh_cache):
    outs, wants = [], []
    for seed in (21, 22, 23):
        state, data, n = _window("flagship", seed=seed, device=cuda_device, **CARD_SIZES)
        outs.append(_solve(lm.local_ba, state, data, n))
        wants.append(_solve(lm._local_ba_body, state, data, n))
    for got, want in zip(outs, wants):
        assert _same(got, want)
    assert not _same(outs[0], outs[1])
    entry = next(iter(lm._BA_GRAPHS.values()))
    statics = {t.data_ptr() for t in (*entry.inputs, *entry.outputs) if t is not None}
    assert not {t.data_ptr() for out in outs for t in _leaves(out) if t is not None} & statics
    assert lm.ba_graph_counts() == {"captures": 1, "replays": 3, "eager": 0, "fallbacks": 0}


@pytest.mark.cuda
def test_second_signature_captures_a_second_graph(cuda_device, fresh_cache):
    for n_pts in (4096, 2048, 4096, 2048):
        state, data, n = _window("mono", seed=n_pts, device=cuda_device, **dict(CARD_SIZES, P=n_pts))
        assert _same(_solve(lm.local_ba, state, data, n), _solve(lm._local_ba_body, state, data, n))
    assert len(lm._BA_GRAPHS) == 2
    assert lm.ba_graph_counts() == {"captures": 2, "replays": 4, "eager": 0, "fallbacks": 0}


@pytest.mark.cuda
def test_capture_that_raises_falls_back_to_eager(cuda_device, fresh_cache, monkeypatch):
    body = lm._local_ba_body

    def reads_the_host_while_capturing(*a, **k):
        out = body(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            out[2][-1].item()  # a host read is not permitted in a capture
        return out

    monkeypatch.setattr(lm, "_local_ba_body", reads_the_host_while_capturing)
    state, data, n = _window("mono", seed=31, device=cuda_device, **CARD_SIZES)
    with pytest.warns(UserWarning, match="capture failed"):
        got = _solve(lm.local_ba, state, data, n)
    assert _same(got, _solve(body, state, data, n))
    again = _solve(lm.local_ba, state, data, n)  # the key stays eager, with no new capture
    assert _same(again, got)
    assert lm.ba_graph_counts() == {"captures": 0, "replays": 0, "eager": 2, "fallbacks": 2}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


@pytest.mark.cuda
def test_capture_that_records_nothing_falls_back_to_eager(cuda_device, fresh_cache, monkeypatch):
    body, last = lm._local_ba_body, []

    def launches_nothing_while_capturing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            return last[-1]  # the warm-up's outputs: no kernel reaches the graph
        last.append(body(*a, **k))
        return last[-1]

    monkeypatch.setattr(lm, "_local_ba_body", launches_nothing_while_capturing)
    state, data, n = _window("mono", seed=33, device=cuda_device, **CARD_SIZES)
    with pytest.warns(UserWarning, match="recorded no work"):
        got = _solve(lm.local_ba, state, data, n)
    assert _same(got, _solve(body, state, data, n))
    assert lm.ba_graph_counts() == {"captures": 0, "replays": 0, "eager": 1, "fallbacks": 1}


@pytest.mark.cuda
def test_graph_on_a_card_that_is_not_the_current_one(fresh_cache):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the inputs on one while the other is current")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for seed in (41, 42):
            state, data, n = _window("stereo", seed=seed, device=dev, **CARD_SIZES)
            got = _solve(lm.local_ba, state, data, n)
            assert all(t.device == dev for t in _leaves(got) if t is not None)
            assert _same(got, _solve(lm._local_ba_body, state, data, n))
        assert torch.cuda.current_device() == 0
    assert lm.ba_graph_counts() == {"captures": 1, "replays": 2, "eager": 0, "fallbacks": 0}
