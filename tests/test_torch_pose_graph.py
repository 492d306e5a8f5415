"""The motion-only pose LM as one CUDA graph (``graph/lm.py:optimize_pose``).

On the CPU: the dispatcher runs the eager body and returns exactly its
output, and the graph cache's key tells apart what a captured graph is
specific to.  On a card (``cuda`` marker, skipped here): a replay equals
the eager body bit for bit, returned tensors never alias the graph's
static buffers, a new signature captures a new graph, and a capture that
raises falls back to the eager body.  No JAX: the eager body is held to
the JAX package in ``test_torch_lm.py``.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.core import geometry as geo
from tpuslam_torch.graph import lm

FX, FY, CX, CY, BF = 500.0, 505.0, 320.0, 240.0, 40.0


def _problem(seed, n=300, stereo=False, device="cpu"):
    """A perturbed pose, points seen through it with pixel noise and 15%
    outliers, and per-point inverse sigmas; with ``stereo`` half the
    observations carry a right-view coordinate."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], 1).astype(np.float32)
    T_true = geo.se3_exp(torch.from_numpy(rng.normal(0, 0.05, 6).astype(np.float32))).numpy()
    pc = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    uv = np.stack([u, v], 1) + rng.normal(0, 0.7, (n, 2))
    bad = rng.rand(n) < 0.15
    uv[bad] = rng.uniform([0, 0], [640, 480], (bad.sum(), 2))
    inv_s2 = (1.0 / 1.2 ** (2.0 * rng.randint(0, 4, n))).astype(np.float32)
    valid = rng.rand(n) > 0.1
    ur = np.full(n, -1.0, np.float32)
    if stereo:
        has = rng.rand(n) < 0.5
        ur[has] = (u - BF / pc[:, 2] + rng.normal(0, 0.7, n))[has]
    T_init = geo.se3_exp(torch.from_numpy(rng.normal(0, 0.02, 6).astype(np.float32))).numpy() @ T_true
    t = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for k, a in (("T", T_init.astype(np.float32)), ("X", X), ("uv", uv.astype(np.float32)),
                      ("inv_s2", inv_s2), ("valid", valid), ("ur", ur))}
    return (t["T"], t["X"], t["uv"], t["inv_s2"], t["valid"]), {"ur": t["ur"], "bf": BF if stereo else 0.0}


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty graph cache and zero counts for the test."""
    monkeypatch.setattr(lm, "_POSE_GRAPHS", {})
    monkeypatch.setattr(lm, "_POSE_GRAPH_COUNTS", {"captures": 0, "replays": 0, "eager": 0, "fallbacks": 0})


@pytest.mark.parametrize("case", ["mono", "stereo", "no_ur"])
def test_dispatcher_on_cpu_is_the_eager_body(fresh_cache, case):
    args, kw = _problem(seed=3, stereo=case == "stereo")
    if case == "no_ur":
        kw = {}
    got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    want = lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)
    assert _same(got, want)
    assert got[1].dtype == torch.bool and got[2].dtype == torch.int32
    assert lm.pose_graph_counts() == {"captures": 0, "replays": 0, "eager": 1, "fallbacks": 0}
    assert lm._POSE_GRAPHS == {}


def _key(n=1024, ur=True, bf=0.0, fx=FX, cx=CX, chi2_th=5.991, dtype=torch.float32, rounds=4):
    args, kw = _problem(seed=0, n=n)
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    return lm.pose_graph_key((*args, kw["ur"] if ur else None), (fx, FY, cx, CY, chi2_th, rounds, 10, bf, 7.815))


@pytest.mark.parametrize("change", [
    {"n": 1000}, {"ur": False}, {"bf": BF}, {"fx": 481.2}, {"cx": 319.5}, {"chi2_th": 9.21},
    {"dtype": torch.float64}, {"rounds": 3},
])
def test_graph_key_tells_signatures_apart(change):
    assert _key() == _key()  # other data, same signature
    assert _key(**change) != _key()


def test_graph_key_refuses_constants_that_are_not_numbers():
    args, kw = _problem(seed=0, n=64)
    consts = (FX, FY, CX, CY, 5.991, 4, 10, 0.0, 7.815)
    assert lm.pose_graph_key((*args, kw["ur"]), consts) is not None
    assert lm.pose_graph_key((*args, kw["ur"]), (torch.tensor(FX), *consts[1:])) is None


def test_graph_key_refuses_inputs_on_two_devices():
    args, kw = _problem(seed=0, n=64)
    consts = (FX, FY, CX, CY, 5.991, 4, 10, 0.0, 7.815)
    elsewhere = torch.empty_like(kw["ur"], device="meta")
    assert lm.pose_graph_key((*args, elsewhere), consts) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_graph_equals_eager_bit_for_bit_on_card(cuda_device, fresh_cache, stereo):
    for seed in (11, 12):
        args, kw = _problem(seed=seed, n=1024, stereo=stereo, device=cuda_device)
        got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
        want = lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw)
        assert _same(got, want)
    assert lm.pose_graph_counts() == {"captures": 1, "replays": 2, "eager": 0, "fallbacks": 0}


@pytest.mark.cuda
def test_replays_in_a_row_keep_earlier_outputs(cuda_device, fresh_cache):
    outs, wants = [], []
    for seed in (21, 22, 23):
        args, kw = _problem(seed=seed, n=1024, device=cuda_device)
        outs.append(lm.optimize_pose(*args, FX, FY, CX, CY, **kw))
        wants.append(lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw))
    for got, want in zip(outs, wants):
        assert _same(got, want)
    assert not _same(outs[0], outs[1])
    statics = [t.data_ptr() for t in next(iter(lm._POSE_GRAPHS.values())).outputs]
    assert not {t.data_ptr() for out in outs for t in out} & set(statics)
    assert lm.pose_graph_counts() == {"captures": 1, "replays": 3, "eager": 0, "fallbacks": 0}


@pytest.mark.cuda
def test_second_signature_captures_a_second_graph(cuda_device, fresh_cache):
    for n in (1024, 512, 1024, 512):
        args, kw = _problem(seed=n, n=n, device=cuda_device)
        assert _same(lm.optimize_pose(*args, FX, FY, CX, CY, **kw),
                     lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw))
    assert len(lm._POSE_GRAPHS) == 2
    assert lm.pose_graph_counts() == {"captures": 2, "replays": 4, "eager": 0, "fallbacks": 0}


@pytest.mark.cuda
def test_capture_that_raises_falls_back_to_eager(cuda_device, fresh_cache, monkeypatch):
    body = lm._optimize_pose_body

    def reads_the_host_while_capturing(*a, **k):
        out = body(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            out[2].item()  # a host read is not permitted in a capture
        return out

    monkeypatch.setattr(lm, "_optimize_pose_body", reads_the_host_while_capturing)
    args, kw = _problem(seed=31, n=1024, device=cuda_device)
    with pytest.warns(UserWarning, match="capture failed"):
        got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    assert _same(got, body(*args, FX, FY, CX, CY, **kw))
    again = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)  # the key stays eager, with no new capture
    assert _same(again, got)
    assert lm.pose_graph_counts() == {"captures": 0, "replays": 0, "eager": 2, "fallbacks": 2}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()


@pytest.mark.cuda
def test_capture_that_records_nothing_falls_back_to_eager(cuda_device, fresh_cache, monkeypatch):
    body, last = lm._optimize_pose_body, []

    def launches_nothing_while_capturing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            return last[-1]  # the warm-up's outputs: no kernel reaches the graph
        last.append(body(*a, **k))
        return last[-1]

    monkeypatch.setattr(lm, "_optimize_pose_body", launches_nothing_while_capturing)
    args, kw = _problem(seed=33, n=1024, device=cuda_device)
    with pytest.warns(UserWarning, match="recorded no work"):
        got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
    assert _same(got, body(*args, FX, FY, CX, CY, **kw))
    assert lm.pose_graph_counts() == {"captures": 0, "replays": 0, "eager": 1, "fallbacks": 1}


@pytest.mark.cuda
def test_graph_on_a_card_that_is_not_the_current_one(fresh_cache):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the inputs on one while the other is current")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for seed in (41, 42):
            args, kw = _problem(seed=seed, n=1024, device=dev)
            got = lm.optimize_pose(*args, FX, FY, CX, CY, **kw)
            assert all(t.device == dev for t in got)
            assert _same(got, lm._optimize_pose_body(*args, FX, FY, CX, CY, **kw))
        assert torch.cuda.current_device() == 0
    assert lm.pose_graph_counts() == {"captures": 1, "replays": 2, "eager": 0, "fallbacks": 0}
