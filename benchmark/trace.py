"""Device-side readings of a run: a kernel's time by CUDA events, and the
reduction of a ``torch.profiler`` trace of the profiled calls to busy
seconds, device time by kernel name and idle gaps by what the host was
doing.  The arithmetic follows the program's ``profile_torch.py`` (device
time of CUDA events by name) and ``chip_smoke.py`` (``_time_ms``); it is
copied here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import heapq
import statistics

import numpy as np
import torch

REPS = 21                  # timed launches per kernel reading (median)
SLEEP_CYCLES = 4_000_000   # ~2 ms of device spin before each timed launch
FLUSH_BYTES = 256 << 20    # written before each timed launch: evicts the L2

# the benchmark's own host spans (record_function regions)
CALL = "solve call"
BETWEEN = "between calls"
SPANS = (CALL, BETWEEN)


def kernel_ms(fn) -> float:
    """Median device milliseconds of ``fn()`` over ``REPS`` launches after
    three warm-up launches.  Before each launch the L2 is flushed (as in
    the cycle, where other levels' traffic evicts it) and the stream is
    held busy by a device spin while the host enqueues, so the events time
    the device work and not the wrapper's host latency."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(0)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged copy of intervals ``(m, 2)``."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def reduce(prof, top: int = 10) -> dict:
    """Busy and window seconds, the top device operations and the longest
    idle gaps of a profile whose calls ran inside ``CALL`` spans.

    The window runs from the start of the first ``CALL`` span to the end
    of the last.  Busy time is the union of the device's kernel, memcpy
    and memset intervals inside it.  Each idle stretch is labelled with
    the benchmark span open on the host when it began and the innermost
    operator of the program open then, and the labels' idle time summed.
    """
    dev, dev_names, cpu, cpu_names, calls = [], [], [], [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.name in SPANS and e.device_type != torch.autograd.DeviceType.CPU:
            continue   # the device-side copy of a benchmark span
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((s, t))
            dev_names.append(e.name)
        elif e.name == CALL:
            calls.append((s, t))
        elif e.name not in SPANS and not e.name.startswith("ProfilerStep"):
            cpu.append((s, t))
            cpu_names.append(e.name)
    if not calls or not dev:
        return {}
    w0, w1 = min(c[0] for c in calls), max(c[1] for c in calls)
    dev_iv = np.asarray(dev)
    busy = _union(np.clip(dev_iv, w0, w1))
    busy = busy[busy[:, 1] > busy[:, 0]]
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())

    by_name: dict = {}
    for (s, t), name in zip(dev, dev_names):
        if t > w0 and s < w1:
            by_name[name] = by_name.get(name, 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    call_iv = np.asarray(sorted(calls))
    idle: dict = {}
    # sweep the gaps in time order beside a heap of the host operators
    # open so far, the latest-started on top; an operator that has ended
    # before one gap has ended before every later one
    order = sorted(range(len(cpu)), key=lambda i: cpu[i][0])
    heap: list = []
    j = 0
    for s, t in gaps:
        while j < len(order) and cpu[order[j]][0] <= s:
            i = order[j]
            heapq.heappush(heap, (-cpu[i][0], i))
            j += 1
        while heap and cpu[heap[0][1]][1] <= s:
            heapq.heappop(heap)
        k = np.searchsorted(call_iv[:, 0], s, side="right") - 1
        label = CALL if k >= 0 and call_iv[k, 1] > s else BETWEEN
        if heap:
            label += ": " + cpu_names[heap[0][1]]
        idle[label] = idle.get(label, 0.0) + (t - s)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n[:200], us * 1e-6] for n, us in ops],
        "idle_gaps": [[n[:200], us * 1e-6] for n, us in gaps_top],
    }
