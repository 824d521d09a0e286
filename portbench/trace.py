"""Reading a ``torch.profiler`` Chrome trace of the measured window: the
device's busy time, its kernel time, the device operations that took most
time, and the longest idle gaps with what the host was doing in them."""
from __future__ import annotations

import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120           # a kernel's name in the breakdown, cut to this


@dataclass
class Summary:
    """Seconds of the traced window, of its union of device activity, and
    of its kernels (summed); the breakdown's two lists."""
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def union(intervals) -> list:
    """Merged (start, end) intervals, sorted."""
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def gaps(busy, lo: float, hi: float) -> list:
    """(start, end) of the idle stretches of [lo, hi] between the merged
    ``busy`` intervals."""
    out, at = [], lo
    for start, end in busy:
        if start > at:
            out.append((at, min(start, hi)))
        at = max(at, end)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


def _label(t: float, host: list, spans: list) -> str:
    """The innermost harness span open at ``t``, with the innermost host
    event open then (a PyTorch operation or a CUDA call)."""
    def inner(events):
        best = None
        for name, start, end in events:
            if start <= t < end and (best is None or end - start < best[1]):
                best = (name, end - start)
        return best and best[0]
    span = inner(spans) or "window"
    op = inner(host)
    return f"{span}:{op}" if op else span


def summarize(events: list, window: str, span_names) -> Summary:
    """The summary of the part of a trace's ``events`` inside the harness
    span named ``window``; ``span_names`` are the harness's other spans."""
    main = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == window]
    if len(main) != 1:
        raise ValueError(f"the trace holds {len(main)} spans {window!r}")
    lo = float(main[0]["ts"])
    hi = lo + float(main[0]["dur"])
    device, kernel_us, by_name = [], 0.0, {}
    host, spans = [], []
    for e in events:
        cat = e.get("cat")
        if "dur" not in e:
            continue
        start = float(e["ts"])
        end = start + float(e["dur"])
        if cat in DEVICE_CATS:
            a, b = max(start, lo), min(end, hi)
            if b <= a:
                continue
            device.append((a, b))
            if cat == "kernel":
                kernel_us += b - a
            name = e.get("name", "?")[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        elif cat in HOST_CATS and e.get("tid") == main[0].get("tid"):
            host.append((e.get("name", "?"), start, end))
        elif cat == "user_annotation" and e.get("name") in span_names:
            spans.append((e["name"], start, end))
    busy = union(device)
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=kernel_us / 1e6,
        device_ops=[[name, us / 1e6] for name, us in top],
        idle_gaps=[[_label((a + b) / 2, host, spans), (b - a) / 1e6]
                   for a, b in idle])


def read(path: str, window: str, span_names) -> Summary:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return summarize(events, window, span_names)
