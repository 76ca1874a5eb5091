"""Reduce a torch.profiler trace to a timeline of device activity.

Device busy time is the length of the union of every device interval
(kernels, copies, sets) inside the traced window, not a sum of kernel
times: overlapping kernels count once.  Idle gaps are the window's parts
outside that union, each labelled by what the host was doing at its
middle: the innermost `he.*` span around it, and the innermost host
event that covers it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW_SPAN = "vflbench.window"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class Timeline:
    """Times in ns of one clock.  `device`: (name, start, end) of every
    device event; `host`: (name, start, end) of every host event."""
    start: int
    end: int
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self) -> list:
        return [e for e in self.device if not e[0].startswith(COPY_PREFIXES)]


def _annotation(name: str) -> bool:
    """The benchmark's own spans, which the profiler also draws on the
    device's timeline over the kernels they enclose."""
    return name == WINDOW_SPAN or name.startswith("he.")


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event."""
    try:
        evs = prof.profiler.kineto_results.events()
    except AttributeError:
        evs = None
    if evs is not None:
        for e in evs:
            start = int(e.start_ns())
            yield (e.name(), e.device_type().name != "CPU", start,
                   start + int(e.duration_ns()))
        return
    for e in prof.events():
        yield (e.name, e.device_type.name != "CPU",
               int(e.time_range.start * 1e3), int(e.time_range.end * 1e3))


def from_profiler(prof) -> Timeline:
    device, host, window = [], [], None
    for name, is_dev, start, end in _events(prof):
        if is_dev:
            if not _annotation(name):
                device.append((name, start, end))
        elif name == WINDOW_SPAN:
            window = (start, end)
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    lo, hi = window
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
              if e > lo and s < hi]
    return Timeline(lo, hi, device, host)


def union(intervals, lo: int, hi: int) -> list:
    """Merged (start, end) of `intervals`, clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_s(tl: Timeline) -> float:
    return sum(e - s for s, e in union(((s, e) for _, s, e in tl.device),
                                       tl.start, tl.end)) / 1e9


def span_s(tl: Timeline, prefix: str) -> float:
    """Host seconds inside the spans whose names start with `prefix`:
    the union of their intervals within the window."""
    return sum(e - s for s, e in union(
        ((s, e) for n, s, e in tl.host if n.startswith(prefix)),
        tl.start, tl.end)) / 1e9


def gaps(tl: Timeline) -> list:
    """(start, end) of every stretch of the window with nothing on the
    device."""
    out, t = [], tl.start
    for s, e in union(((s, e) for _, s, e in tl.device), tl.start, tl.end):
        if s > t:
            out.append((t, s))
        t = e
    if tl.end > t:
        out.append((t, tl.end))
    return out


def _innermost(events, starts, t: int, limit: int | None):
    """Name of the latest-starting event of `events` (sorted by start)
    that covers t; None when there is none within `limit` steps back."""
    i = bisect.bisect_right(starts, t) - 1
    steps = 0
    while i >= 0 and (limit is None or steps < limit):
        name, s, e = events[i]
        if e >= t:
            return name
        i -= 1
        steps += 1
    return None


def idle_by_host(tl: Timeline, top: int = 10) -> list:
    """[label, seconds] of the idle gaps summed by what the host did."""
    host = sorted(tl.host, key=lambda e: e[1])
    spans = [e for e in host if e[0].startswith("he.")]
    ops = [e for e in host if not e[0].startswith("he.")]
    span_starts = [e[1] for e in spans]
    op_starts = [e[1] for e in ops]
    acc = collections.defaultdict(int)
    for s, e in gaps(tl):
        mid = (s + e) // 2
        span = _innermost(spans, span_starts, mid, None) or "legs"
        op = _innermost(ops, op_starts, mid, 256) or "python"
        acc[f"{span}: {op}"] += e - s
    return [[k, v / 1e9] for k, v in
            sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its parameter list, cut to `width`."""
    head = name.split("(", 1)[0] if not name.startswith("(") else \
        name[:name.find("(", 1)] if name.find("(", 1) > 0 else name
    return head.strip()[:width]


def device_ops(tl: Timeline, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    acc = collections.defaultdict(int)
    for name, s, e in tl.device:
        acc[short(name)] += e - s
    return [[k, v / 1e9] for k, v in
            sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def classify(name: str, classes: dict) -> str | None:
    """The operation class whose kernel-name list names `name`."""
    for cls, tokens in classes.items():
        if any(tok in name for tok in tokens):
            return cls
    return None


def kernel_seconds(tl: Timeline, classes: dict) -> tuple[dict, float, int]:
    """(seconds by class, seconds of unlisted kernels, kernel count)."""
    by_class = collections.defaultdict(float)
    glue = 0.0
    ks = tl.kernels()
    for name, s, e in ks:
        cls = classify(name, classes)
        if cls is None:
            glue += (e - s) / 1e9
        else:
            by_class[cls] += (e - s) / 1e9
    return dict(by_class), glue, len(ks)
