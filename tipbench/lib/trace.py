"""The traced window: a few training steps under torch.profiler, reduced
to device time by operation, device busy time, launches, and the idle
gaps by what the host was doing.

Method (chip_smoke.py:profile_steps at the commit that added this
benchmark): the profiler records CPU and CUDA activity over steps that
end in a device synchronise; the window is a user annotation around them,
so its length is host time on the trace's own clock; device busy time is
the union of the device operations' intervals inside it (kernels, copies
and sets), so overlapping operations count once.  The profiler inflates
host time, so end-to-end numbers come from the untraced run only.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

WINDOW = "tipbench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # a name in the breakdown is cut to this length


def traced_steps(step, first: int, steps: int) -> dict:
    """Run ``step(k)`` for k = first .. first + steps - 1 under the
    profiler; returns the trace's summary (:func:`reduce_trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for k in range(first, first + steps):
                step(k)
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce_trace(events)
    out.update(steps=steps, host_s=host_s)
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list) -> dict:
    """Summary of a Chrome trace's events (microsecond times): the
    window's length ``wall_s``, the device's ``busy_s`` in it, the count
    of device operations ``launches``, ``ops`` [[name, seconds, count]]
    of every device operation name by time, and the ``breakdown`` lists."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in spans if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    by_name: dict = {}
    for e in dev:
        rec = by_name.setdefault(e["name"], [0.0, 0])
        rec[0] += float(e["dur"]) / 1e6
        rec[1] += 1
    ops = sorted(([k, v[0], v[1]] for k, v in by_name.items()),
                 key=lambda r: -r[1])
    busy = _union((float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"])))
                  for e in dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return {
        "wall_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "launches": len(dev),
        "ops": ops,
        "breakdown": {
            "device_ops": [[k[:NAME_CHARS], s] for k, s, _ in ops[:TOP]],
            "idle_gaps": _gaps_by_host_op(gaps, spans, wins[0].get("tid")),
        },
    }


def _gaps_by_host_op(gaps, spans, tid) -> list:
    """The idle gaps' seconds summed by the innermost host operation that
    was running at each gap's middle, on the window's thread."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in spans if e.get("cat") == "cpu_op"
                  and e.get("tid") == tid)
    starts = [h[0] for h in host]
    total: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "(no host operation)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 400), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        total[name] = total.get(name, 0.0) + (b - a) / 1e6
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def op_seconds(summary: dict, patterns) -> tuple:
    """(seconds, count) of the device operations whose name matches any
    of the regular expressions ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    sec, cnt = 0.0, 0
    for name, s, c in summary["ops"]:
        if any(r.search(name) for r in rx):
            sec += s
            cnt += c
    return sec, cnt
