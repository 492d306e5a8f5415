"""Device time of a call on the card, free of host launch cost.

A wrapper call costs tens of microseconds of host time (argument checks,
output allocation, the ctypes call), about as long as the kernels of this
package run.  Timed back to back, such calls measure the host's launch rate.
:func:`device_ms` first parks the stream in ``torch.cuda._sleep`` while the
host enqueues every call, so the events around the calls see only the
device's work, and it checks that the host did finish enqueueing before the
device woke up.
"""

from __future__ import annotations

import functools
import time

import torch


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms(device_index: int) -> float:
    with torch.cuda.device(device_index):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # wake the clocks
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls queued behind a
    spin long enough for the host to enqueue them all.  Raises if the host
    was still enqueueing when the spin ended, even after longer spins."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_call_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    spin_ms = 2.0 * reps * host_call_ms + 1.0
    for _ in range(3):
        parked, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        parked.record()
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms(torch.cuda.current_device())))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < parked.elapsed_time(start):
            return start.elapsed_time(end) / reps
        spin_ms *= 4.0
    raise RuntimeError(f"device_ms: the host took {host_ms:.3f} ms to enqueue {reps} calls, "
                       "longer than every head start tried")


def host_paced_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean time per call with no head start: events around ``reps`` calls
    made back to back: the slower of the host's and the device's rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
