"""Device time per call on one card, shared by the port's profilers and
``chip_smoke.py``."""
from __future__ import annotations

import statistics

REPS = 20                # launches back to back in one timed window
WINDOWS = 3              # timed windows; the median is reported


def device_ms(fn, reps: int = REPS, windows: int = WINDOWS) -> float:
    """Device ms per call of ``fn``: after one warm-up call, record an
    event, call ``fn`` ``reps`` times with no synchronise between the
    calls, record a second event and divide the time between them by
    ``reps``; the median of ``windows`` such windows.  The card queues
    each launch while it runs the one before, so the host's share of a
    call (argument checks, allocation, the launch itself) is hidden
    unless it is longer than the device's.  A call that makes the host
    wait for the card is timed with that wait in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)
