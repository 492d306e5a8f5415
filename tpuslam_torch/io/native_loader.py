"""Threaded prefetching dataset loader (port of ``tpuslam/io/native_loader.py``
and its worker pool, ``native/dataloader.cpp``).

``NativeSequence`` keeps the reference's interface and guarantees: frames
come strictly in order, decoded by ``n_threads`` workers at most
``prefetch`` frames ahead of the consumer; ``max_hw`` bounds the image
size, ``max_frames`` the count, ``close()`` stops the workers and
``available()`` says whether the pool can run.

The departure: the reference's pool links OpenCV for ``cv::imread``
(native/build.sh:7-10, dataloader.cpp:75, 87), which the card host lacks.
Here the workers are Python threads that decode with ``io/png.py``, whose
gray and depth rules equal ``cv2.imread``'s (the inflate and, with
``native``, the compiled unfilter run without the interpreter lock).  Frames
are what ``io/datasets.py`` reads: gray stays uint8 (the reference hands
out float32 copies), depth is the 16-bit PNG divided by ``depth_factor`` in
float32 (the reference multiplies by the float32 reciprocal, which can
differ in the last bit), and a frame whose depth file is missing or not
16-bit gets a depth of -1 everywhere, as the reference's ``dl_next`` fills
it.  A gray image that fails to decode raises at its turn in the stream
(the reference hands out an empty frame), and one larger than ``max_hw``
raises ``ValueError`` (the reference's fixed buffers would overflow).
"""

from __future__ import annotations

import os
import threading
from typing import Iterator

import numpy as np

from . import png
from .datasets import SequenceItem, _read_list


def available() -> bool:
    """The pool needs no library of its own: its workers decode with
    ``io/png.py`` (``native`` also builds the PNG unfilter helper)."""
    return True


class NativeSequence:
    """Iterates decoded frames produced by a pool of worker threads, in order."""

    def __init__(self, folder: str, rgb_list: str = "rgb.txt", depth_list: str = "", depth_factor: float = 5000.0,
                 n_threads: int = 4, prefetch: int = 8, max_hw=(480, 640), max_frames: int = 0,
                 native: bool = False):
        path = os.path.join(folder, rgb_list)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{folder}/{rgb_list}")
        self._rgb = _read_list(path)
        self._with_depth = bool(depth_list)
        self._depth = []
        if depth_list and os.path.exists(os.path.join(folder, depth_list)):
            self._depth = [rel for _, rel in _read_list(os.path.join(folder, depth_list))][:len(self._rgb)]
        self._folder, self._factor, self._native = folder, np.float32(depth_factor), native
        self._max_hw = tuple(max_hw)
        self.count = len(self._rgb) if max_frames <= 0 else min(max_frames, len(self._rgb))
        self._slots = threading.Semaphore(prefetch if prefetch > 0 else 8)
        self._cv = threading.Condition()
        self._ready = {}  # frame index -> SequenceItem, or the exception its decode raised
        self._scheduled = self._emitted = 0
        self._stop = False
        self._workers = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(n_threads if n_threads > 0 else 2)]
        for t in self._workers:
            t.start()

    def __len__(self):
        return self.count

    def _decode(self, i: int) -> SequenceItem:
        stamp, rel = self._rgb[i]
        gray = png.imread_gray(os.path.join(self._folder, rel), self._native)
        if gray.shape[0] > self._max_hw[0] or gray.shape[1] > self._max_hw[1]:
            raise ValueError(f"{rel}: {gray.shape} exceeds max_hw {self._max_hw}")
        depth = None
        if self._with_depth:
            depth = np.full(gray.shape, -1.0, np.float32)
            d_path = os.path.join(self._folder, self._depth[i]) if i < len(self._depth) else ""
            if d_path and os.path.exists(d_path):
                d = png.imread_unchanged(d_path, self._native)
                if d.dtype == np.uint16 and d.ndim == 2:
                    depth = d.astype(np.float32) / self._factor
        return SequenceItem(i, stamp, gray, depth, rel)

    def _work(self):
        while True:
            self._slots.acquire()  # at most ``prefetch`` frames decoded ahead of the consumer
            with self._cv:
                if self._stop or self._scheduled >= self.count:
                    self._slots.release()
                    return
                i = self._scheduled
                self._scheduled += 1
            try:
                out = self._decode(i)
            except Exception as e:  # handed to the consumer at this frame's turn
                out = e
            with self._cv:
                self._ready[i] = out
                self._cv.notify_all()

    def __iter__(self) -> Iterator[SequenceItem]:
        while self._emitted < self.count:
            i = self._emitted
            with self._cv:
                while i not in self._ready and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                out = self._ready.pop(i)
                self._emitted += 1
            self._slots.release()
            if isinstance(out, Exception):
                raise out
            yield out

    def close(self):
        """Stop the workers (a frame being decoded finishes first) and join them."""
        with self._cv:
            if self._stop:
                return
            self._stop = True
            self._cv.notify_all()
        for _ in self._workers:
            self._slots.release()
        for t in self._workers:
            t.join()
        self._ready.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
