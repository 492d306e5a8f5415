"""Sessions, the measured window and the harness's own spans.

A session is a fresh ``Tracker`` that maps one clip from its first frame,
driven by the port's app loop (``run_loop``).  Sessions follow one another
until the window closes, so every run does the same work per frame whatever
the program's speed.  The harness marks, from its own side of the calls:

- a frame's start: the time the loop's ``per_frame`` hook is called for it;
- a frame's pose: the first hook (or the loop's return) after which
  ``tracker.trajectory`` holds its frame id;
- a call's kind: ``init`` when the tracker was not tracking as it began,
  ``keyframe`` when the port's keyframe decisions made one during it,
  ``hot`` otherwise.

Everything here takes the program adapter and the clock as arguments, so
the scheduling and the arithmetic run under a fake program and clock in the
tests.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .clip import item


@dataclass
class FrameRec:
    fid: int
    t_start: float
    tracking: bool  # the tracker was tracking as the call began
    kf_before: int  # keyframes made before the call
    epoch: int = 0  # the program's map-scale changes as the call began
    t_return: Optional[float] = None
    return_epoch: int = 0  # ... and when its pose was seen returned
    kind: str = ""
    call_s: float = 0.0


@dataclass
class Session:
    index: int
    frames: List[FrameRec] = field(default_factory=list)
    attempted: int = 0  # frames handed in while the window was open
    completed: bool = False  # the whole clip was handed in while the window was open
    late: bool = False  # the rest of the clip was handed in after the window closed (``finish``)
    counters: Optional[dict] = None  # the port's counters at the window's close or the session's end
    tracker: object = None
    t_begin: float = 0.0  # the clock as the session's tracker was handed in
    t_end: float = 0.0  # ... and as its loop returned
    _seen: int = 0

    def _collect(self, prog, t):
        """Give every pose the tracker added since the last look the return
        time ``t``."""
        traj = self.tracker.trajectory
        if len(traj) > self._seen:
            by_fid = {f.fid: f for f in self.frames}
            epoch = prog.scale_changes(self.tracker)
            for fid, _ in traj[self._seen:]:
                rec = by_fid.get(int(fid))
                if rec is not None and rec.t_return is None:
                    rec.t_return, rec.return_epoch = t, epoch
            self._seen = len(traj)

    def _close_call(self, prog):
        """Classify the last call, now that it has returned."""
        if self.frames and not self.frames[-1].kind:
            rec = self.frames[-1]
            rec.kind = ("init" if not rec.tracking else
                        "keyframe" if prog.keyframes_made(self.tracker) > rec.kf_before else "hot")

    def run(self, prog, tracker, clip, until: float, clock: Callable[[], float], on_frame=None,
            until_keyframes: int = 0, start: int = 0):
        """Drive ``tracker`` over ``clip`` from frame ``start`` until it ends or
        the clock passes ``until`` (or, with ``until_keyframes`` > 0, the
        tracker has made that many keyframes: the warm-up); ``on_frame(session,
        rec)`` is called at each frame's start (the traced run's profiler)."""
        self.tracker = tracker
        if not start:
            self.t_begin = clock()
        n_before = len(self.frames)

        def items():
            for fid in range(start, len(clip.frames)):
                if clock() >= until or 0 < until_keyframes <= prog.keyframes_made(tracker):
                    self.counters = prog.counters(tracker)
                    return
                self.attempted += 1
                yield item(clip, fid)
            self.completed = True

        def hook(item):
            t = clock()
            self._collect(prog, t)
            self._close_call(prog)
            rec = FrameRec(fid=int(item[0]), t_start=t, tracking=prog.tracking(tracker),
                           kf_before=prog.keyframes_made(tracker), epoch=prog.scale_changes(tracker))
            self.frames.append(rec)
            if on_frame is not None:
                on_frame(self, rec)
            return clip.detections[rec.fid] if clip.detections is not None else (None, None)

        call_s = prog.run_loop(tracker, items(), hook)
        t = self.t_end = clock()
        self._collect(prog, t)
        self._close_call(prog)
        for rec, s in zip(self.frames[n_before:], call_s):
            rec.call_s = s
        if self.counters is None:
            self.counters = prog.counters(tracker)

    def finish(self, prog, clip, clock: Callable[[], float]):
        """Hand in the rest of a session the window cut, after it closed, so
        that the session's map is whole for the checks: late answers, which
        no window figure counts (their calls lie past ``attempted`` and
        their poses return after the window's end)."""
        attempted, t_end = self.attempted, self.t_end
        self.run(prog, self.tracker, clip, float("inf"), clock, start=attempted)
        self.attempted, self.completed, self.late, self.t_end = attempted, False, True, t_end

    def summary(self) -> dict:
        """Frames handed in, poses returned, keyframes, the median hot call
        and the local BA's ms per keyframe of this session, and its rate
        (poses over its own seconds): whether a run's first session differs
        from the later ones."""
        calls = self.frames[:self.attempted]
        hot = [f.call_s * 1e3 for f in calls if f.kind == "hot"]
        c = self.counters or {"stage_ms": {}, "keyframes": 0}
        posed = sum(f.t_return is not None and f.t_return <= self.t_end for f in calls)
        span = self.t_end - self.t_begin
        return {"attempted": self.attempted, "completed": self.completed, "late": self.late, "poses": posed,
                "keyframes": c["keyframes"], "hot_ms_p50": percentile(hot, 50.0) if hot else None,
                "map_ba_ms_per_kf": c["stage_ms"].get("map_ba", 0.0) / c["keyframes"] if c["keyframes"] else None,
                "poses_per_s": posed / span if span > 0 else None}

    def epochs(self) -> dict:
        """frame id -> the map-scale epoch its pose belongs to, for the frames
        that began and returned in one epoch (a frame in flight across a
        change may hold either scale)."""
        return {f.fid: f.epoch for f in self.frames if f.t_return is not None and f.epoch == f.return_epoch}

    def kinds(self) -> dict:
        """frame id -> its call's kind."""
        return {f.fid: f.kind for f in self.frames}

    def failed(self) -> int:
        """Frames after the session's first pose that ended without one
        (LOST), or every frame handed in if a whole clip never initialized."""
        posed = [f.fid for f in self.frames if f.t_return is not None]
        if not posed:
            return self.attempted if self.completed else 0
        first = min(posed)
        return sum(1 for f in self.frames[:self.attempted] if f.fid > first and f.t_return is None)


@dataclass
class Window:
    t0: float
    seconds: float
    sessions: List[Session]

    @property
    def end(self) -> float:
        return self.t0 + self.seconds

    def returned(self) -> List[FrameRec]:
        """Frames whose pose was returned inside the window."""
        return [f for s in self.sessions for f in s.frames if f.t_return is not None and f.t_return <= self.end]

    def calls(self) -> List[FrameRec]:
        """Frames handed in while the window was open."""
        return [f for s in self.sessions for f in s.frames[:s.attempted]]

    def attempted(self) -> int:
        return sum(s.attempted for s in self.sessions)

    def failed(self) -> int:
        return sum(s.failed() for s in self.sessions)

    def counters(self) -> dict:
        """The port's counters summed over the sessions, each as it stood
        when the window closed or the session ended."""
        stage, waits, kfs = {}, 0, 0
        for s in self.sessions:
            c = s.counters or {"stage_ms": {}, "waits": 0, "keyframes": 0}
            for k, v in c["stage_ms"].items():
                stage[k] = stage.get(k, 0.0) + v
            waits += c["waits"]
            kfs += c["keyframes"]
        return {"stage_ms": stage, "waits": waits, "keyframes": kfs}


def run_window(prog, config: dict, clip, seconds: float, device, clock: Callable[[], float] = time.perf_counter,
               on_frame=None) -> Window:
    """Sessions back to back for ``seconds``: each a fresh ``Tracker`` (its
    construction inside the window) over the whole clip."""
    t0 = clock()
    win = Window(t0=t0, seconds=seconds, sessions=[])
    while clock() < win.end:
        s = Session(index=len(win.sessions))
        win.sessions.append(s)
        s.run(prog, prog.make_tracker(config, device), clip, win.end, clock, on_frame)
    return win


def percentile(values, q: float) -> float:
    """The ``q``-th percentile with linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(win: Window) -> dict:
    """The window's end-to-end readings (``setup_s`` is the caller's)."""
    done = win.returned()
    lat = [(f.t_return - f.t_start) * 1e3 for f in done]
    return {"frames_per_s": len(done) / win.seconds, "pose_ms_p90": percentile(lat, 90.0),
            "pose_ms_p50": percentile(lat, 50.0), "poses": len(done)}
