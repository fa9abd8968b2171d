"""The traced run's device trace: ``torch.profiler`` with CPU and CUDA
activity over the window, exported as a Chrome trace under ``TMPDIR``
and reduced here.

- the window: the ``bench.window`` annotation around the jobs;
- busy: the union of the intervals in which a kernel, a copy or a
  memset ran on the card, inside the window;
- kernel time: the sum of every kernel's duration inside the window,
  whatever its name;
- the device operations that took most time, by name;
- the longest idle gaps, each named by the host spans (``spans.py``)
  that overlap it most, mapped onto the trace's clock from the window's
  start.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class DeviceTrace:
    def __init__(self, tmpdir: str):
        self.path = os.path.join(tmpdir, "trace.json")
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def window(self):
        from torch.profiler import record_function
        return record_function(WINDOW)

    def stop(self) -> list:
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with open(self.path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(self.path)
        return events


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(events, spans, t_window0: float) -> dict:
    """busy_s, window_s, kernel_s and the breakdown of one traced window.
    ``spans`` is the host span log; ``t_window0`` the perf_counter
    reading at the window annotation's start."""
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError("the trace has no %s annotation" % WINDOW)
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev = []
    kernel_us = 0.0
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e.get("name", "?")] += b - a
        if e["cat"] == "kernel":
            kernel_us += b - a
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])

    def to_trace(t):
        return w0 + (t - t_window0) * 1e6

    host = [(n, to_trace(t0), to_trace(t1)) for n, _, t0, t1 in spans.log]

    def label(a, b):
        over = defaultdict(float)
        for n, s0, s1 in host:
            o = min(b, s1) - max(a, s0)
            if o > 0:
                over[n] += o
        inner = sorted((v, n) for n, v in over.items() if n != "job")
        if inner:
            return "+".join(n for _, n in inner[::-1][:2])
        return "cli" if over else "harness"

    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[n, v / 1e6] for n, v in ops],
        "idle_gaps": [[label(a, b), (b - a) / 1e6] for a, b in gaps[:TOP]],
    }
