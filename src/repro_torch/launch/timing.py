"""Device time of a call on the card, for calls shorter than their own
host-side launch: ``sleep_ms_per_mcycle`` calibrates ``torch.cuda._sleep``
once, and ``time_ms`` holds the stream behind a sleep kernel while the host
enqueues the calls, so that CUDA events bracket the calls running back to
back and not the host's pace.  Needs a CUDA card."""
from __future__ import annotations

import time

import torch


def sleep_ms_per_mcycle() -> float:
    """Device milliseconds of ``torch.cuda._sleep(10**6)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 ** 6)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10


def time_ms(fn, inputs: list[tuple], reps: int,
            sleep_ms_per_mcycle: float) -> float:
    """Mean device milliseconds of one call, cycling through ``inputs``.

    A small GEMM takes less time on the card than its Python call takes on
    the host, so timing a loop of calls would time the host.  The stream is
    first held by a sleep kernel long enough for the host to enqueue every
    call; the events then bracket the calls running back to back.  The
    device's launch queue holds about a thousand launches: a call made of
    many small launches (a plain version's loop over the groups) can fill
    it during the hold and block the host, so such a call is timed again
    with fewer repetitions.  Raises if the host still took longer to
    enqueue the calls than the hold lasted (the time would be the host's)."""
    t0 = time.perf_counter()
    for i in range(min(len(inputs), 3)):
        fn(*inputs[i])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / min(len(inputs), 3)
    for n in (reps, max(reps // 8, 2)):
        hold_ms = 2.0 * n * host_ms + 5.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms / sleep_ms_per_mcycle * 10 ** 6))
        t0 = time.perf_counter()
        start.record()
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms <= hold_ms:
            return start.elapsed_time(end) / n
    raise AssertionError(f"enqueue of {n} calls took {enqueue_ms:.1f} ms, "
                         f"longer than the {hold_ms:.1f} ms hold")
