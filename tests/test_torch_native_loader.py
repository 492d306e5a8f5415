"""The port's prefetching loader (``tpuslam_torch/io/native_loader.py``)
against the JAX package's (``tpuslam/io/native_loader.py`` over
``native/dataloader.cpp``, where that library is built) and the port's
own readers (``io/datasets.py``), on the CPU: frames strictly in order,
gray equal to the reference loader's and the readers' on every pixel,
depth equal to the readers' and within the last bit of the reference's
(it multiplies by the float32 reciprocal of the depth factor), and
``max_frames``, ``prefetch``, ``max_hw`` and ``close()`` as the reference
defines them.
"""

import random
import sys
import threading
import time

import numpy as np
import pytest

import _torch_datasets as tds
from test_io import _make_dataset
from tpuslam.io import native_loader as jnl
from tpuslam_torch.io import datasets, native_loader, png


@pytest.mark.parametrize("n_threads, prefetch, native", [(3, 4, False), (1, 1, False), (4, 8, True)])
def test_native_loader_roundtrip(tmp_path, n_threads, prefetch, native):
    """``tests/test_io.py:31``'s case: 6 frames of 48x64 noise."""
    frames = _make_dataset(tmp_path)
    seq = native_loader.NativeSequence(str(tmp_path), n_threads=n_threads, prefetch=prefetch, max_hw=(48, 64),
                                       native=native)
    assert len(seq) == 6 and native_loader.available()
    got = list(seq)
    assert [it.frame_id for it in got] == list(range(6))  # strictly in order
    for it, ref in zip(got, frames):
        np.testing.assert_array_equal(it.gray, ref)
        assert it.gray.shape == (48, 64) and it.depth is None
    np.testing.assert_allclose([it.timestamp for it in got], np.arange(6) * 0.1)
    seq.close()


@pytest.mark.skipif(not jnl.available(), reason="the reference's native loader is not built")
def test_frames_equal_the_reference_loader(tmp_path):
    _make_dataset(tmp_path, n=9)
    ref = list(jnl.NativeSequence(str(tmp_path), n_threads=3, prefetch=4, max_hw=(48, 64)))
    got = list(native_loader.NativeSequence(str(tmp_path), n_threads=3, prefetch=4, max_hw=(48, 64)))
    assert [it.frame_id for it in got] == [it.frame_id for it in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.gray.astype(np.float32), b.gray)
        assert a.timestamp == b.timestamp


def test_depth_equals_the_readers_and_the_reference(tmp_path):
    root = tds.write_tum(str(tmp_path / "seq"), n_frames=6)
    got = list(native_loader.NativeSequence(root, depth_list="depth.txt", n_threads=2, max_hw=(240, 320)))
    want = list(datasets.IclDataset(root).frames(with_depth=True))
    assert [it.frame_id for it in got] == [it.frame_id for it in want] == list(range(6))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.gray, b.gray)
        np.testing.assert_array_equal(a.depth, b.depth)
        assert a.depth.dtype == np.float32 and (a.depth > 0).any()
    if jnl.available():
        ref = list(jnl.NativeSequence(root, depth_list="depth.txt", n_threads=2, max_hw=(240, 320)))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.depth, b.depth, rtol=2 ** -23, atol=0)


def test_missing_depth_is_filled_with_minus_one(tmp_path):
    root = tds.write_tum(str(tmp_path / "seq"), n_frames=3)
    path = tmp_path / "seq" / "depth.txt"
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines[:1] + ["0.1 depth/missing.png"]) + "\n")
    got = list(native_loader.NativeSequence(root, depth_list="depth.txt", max_hw=(240, 320)))
    assert (got[0].depth > 0).any()
    assert all((it.depth == -1).all() for it in got[1:]) and got[2].depth.shape == got[2].gray.shape


@pytest.mark.parametrize("max_frames", [1, 4, 99])
def test_max_frames(tmp_path, max_frames):
    _make_dataset(tmp_path)
    seq = native_loader.NativeSequence(str(tmp_path), max_hw=(48, 64), max_frames=max_frames)
    assert len(seq) == min(max_frames, 6)
    assert [it.frame_id for it in seq] == list(range(min(max_frames, 6)))


def test_in_order_under_uneven_decodes_and_at_most_prefetch_ahead(tmp_path, monkeypatch):
    _make_dataset(tmp_path, n=12)
    imread = png.imread_gray
    rng = random.Random(0)
    in_flight, peak, lock = [0], [0], threading.Lock()

    def slow(path, native=False):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        time.sleep(rng.uniform(0, 0.02))
        with lock:
            in_flight[0] -= 1
        return imread(path, native)

    monkeypatch.setattr(png, "imread_gray", slow)
    seq = native_loader.NativeSequence(str(tmp_path), n_threads=4, prefetch=3, max_hw=(48, 64))
    time.sleep(0.2)
    assert seq._scheduled <= 3  # nothing consumed yet: at most ``prefetch`` frames taken
    assert [it.frame_id for it in seq] == list(range(12))
    assert peak[0] <= 3


def test_close_stops_the_workers(tmp_path):
    _make_dataset(tmp_path, n=12)
    seq = native_loader.NativeSequence(str(tmp_path), n_threads=3, prefetch=2, max_hw=(48, 64))
    it = iter(seq)
    assert next(it).frame_id == 0
    seq.close()
    assert not any(t.is_alive() for t in seq._workers)
    assert list(it) == []
    seq.close()  # a second close is a no-op


def test_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        native_loader.NativeSequence(str(tmp_path))
    _make_dataset(tmp_path)
    with pytest.raises(ValueError, match="max_hw"):
        list(native_loader.NativeSequence(str(tmp_path), max_hw=(32, 64)))


def test_stress_more_workers_than_cores_keeps_every_frame_once_in_order(tmp_path):
    """16 workers, a switch interval of 1 us, a prefetch of 3: a lost update
    of the shared schedule or the ready map would drop, repeat or reorder a
    frame, or hang (bounded by a watchdog)."""
    _make_dataset(tmp_path, n=40, h=8, w=8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seq = native_loader.NativeSequence(str(tmp_path), n_threads=16, prefetch=3, max_hw=(8, 8))
        got = []
        reader = threading.Thread(target=lambda: got.extend(it.frame_id for it in seq), daemon=True)
        reader.start()
        reader.join(timeout=60)
        assert not reader.is_alive(), "the loader hung"
        seq.close()
    finally:
        sys.setswitchinterval(interval)
    assert got == list(range(40))
    assert not any(t.is_alive() for t in seq._workers)
