#!/usr/bin/env python3
"""Lay a profiler trace's device idle against the program's spans.

    python3 tools/idle_by_span.py TRACE.json [--top N]

TRACE.json is a Chrome trace of torch.profiler with CPU and CUDA
activities: the one the training CLIs' ``--profile-dir DIR`` write
(``DIR/trace.json``), or steps of a benchmark cell traced and exported by
a script (``tipbench/lib/trace.py:traced_steps`` runs them).  The
program's spans (tip_tpu_torch/trace.py) are its ``user_annotation``
events, on every thread: ``forward`` on the caller's, ``backward`` on the
autograd engine's; torch's own (``Optimizer.step#Adam.step``) count too.

The window is the benchmark's ``tipbench_window`` annotation where the
trace holds one, else the first program span's start to the last one's
end.  The device is busy in the union of its operations' intervals in the
window (kernels, copies, sets), as the benchmark reduces a trace
(``tipbench/lib/trace.py``, whose ``_union`` this takes; its gap loop
lies inside ``reduce_trace`` and its search by gap names host operations
on one thread, so neither can be imported and the loop is repeated
here); the rest of the window is idle.  Each idle gap
goes to the innermost program span open at its middle on any thread (of
the spans that hold the middle, the one that opened last), named by its
path on its thread (``forward/encode/rgcn``); what no span holds is
``(no span)``.

Prints one JSON object: ``window_s``, ``busy_s``, ``idle_s`` and
``by_span``, [[path, idle seconds, share of the idle]] by seconds.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tipbench.lib.trace import DEVICE_CATS, WINDOW, _union  # noqa: E402

NO_SPAN = "(no span)"


def program_spans(events: list) -> list:
    """(start, end, path) of the trace's user annotations but the window
    and the profiler's own step marks, each path by nesting on its thread."""
    by_tid: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"] != WINDOW
                and not e["name"].startswith("ProfilerStep#")):
            a = float(e["ts"])
            by_tid.setdefault(e.get("tid"), []).append(
                (a, a + float(e["dur"]), e["name"]))
    out = []
    for spans in by_tid.values():
        stack: list = []  # (end, path) of the spans open on this thread
        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= a:
                stack.pop()
            path = f"{stack[-1][1]}/{name}" if stack else name
            stack.append((b, path))
            out.append((a, b, path))
    return sorted(out)


def idle_by_span(events: list) -> dict:
    """The trace's device idle in the window, summed by program span."""
    spans = program_spans(events)
    wins = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if wins:
        w0 = float(wins[0]["ts"])
        w1 = w0 + float(wins[0]["dur"])
    elif spans:
        w0, w1 = spans[0][0], max(s[1] for s in spans)
    else:
        raise ValueError(f"the trace holds neither {WINDOW!r} nor a span")
    busy = _union((float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"])))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS
                  and w0 <= float(e["ts"]) < w1)
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    starts = [s[0] for s in spans]
    reach = list(itertools.accumulate((s[1] for s in spans), max))
    total: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        path = NO_SPAN
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if reach[i] < mid:  # no span this early reaches the middle
                break
            if spans[i][1] >= mid:
                path = spans[i][2]
                break
        total[path] = total.get(path, 0.0) + (b - a) / 1e6
    idle = sum(total.values())
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "idle_s": idle,
        "by_span": [[k, v, v / idle if idle else 0.0] for k, v in
                    sorted(total.items(), key=lambda kv: -kv[1])],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=0,
                    help="print only the N largest spans (0: all)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        out = idle_by_span(json.load(f)["traceEvents"])
    if args.top:
        out["by_span"] = out["by_span"][:args.top]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
