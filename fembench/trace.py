"""Reading a torch.profiler trace of the window: the device's busy time
(the union of its kernels', copies' and sets' intervals), time and count
by device operation, and the longest idle gaps with what the host was
doing in them. `collect` reduces the profiler's raw events to a small dict
that the per-layer metric readers read (and the tests hold them against,
as JSON)."""

from __future__ import annotations

import re

import numpy as np

SPAN_PREFIX = "fembench::"
TOP = 10  # device operations and idle gaps in a breakdown


def kernel_base(name: str) -> str:
    """A device operation's bare name: `void (anonymous
    namespace)::filter_tail_kernel<256>(int const*, ...)` ->
    `filter_tail_kernel`."""
    n = name.strip().replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = re.split(r"[(<]", n, maxsplit=1)[0]
    return n.rsplit("::", 1)[-1].strip()


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without `void`, namespaces of the library
    and its argument list, cut to `width`: the breakdown's key."""
    n = name.strip().replace("(anonymous namespace)::", "").replace("at::native::", "")
    if n.startswith("void "):
        n = n[5:]
    depth = 0
    for i, ch in enumerate(n):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            n = n[:i]
            break
    return n[:width]


def _raw_events(prof):
    """(name, on device, start s, end s, thread) of the events the profiler
    kept; the device's copies of user annotations (the harness's spans on
    the device's timeline) are left out."""
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_dev = "cpu" not in str(e.device_type()).lower()
        note = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        if on_dev and (note or name.startswith(SPAN_PREFIX)):
            continue
        t0 = e.start_ns() / 1e9
        yield name, on_dev, t0, t0 + e.duration_ns() / 1e9, e.start_thread_id()


def collect(prof, window_s: float) -> dict:
    dev_names, ds, de, host = [], [], [], []
    for name, on_dev, t0, t1, thread in _raw_events(prof):
        if on_dev:
            dev_names.append(name)
            ds.append(t0)
            de.append(t1)
        else:
            host.append((name, t0, t1, thread))
    return reduce(dev_names, np.array(ds), np.array(de), host, window_s)


def reduce(dev_names: list, ds: np.ndarray, de: np.ndarray, host: list, window_s: float) -> dict:
    """The trace's summary: window and busy seconds, {operation: [seconds,
    count]}, and the TOP longest idle gaps named by the host calls
    running at their middle (the innermost on each thread)."""
    ops: dict = {}
    for name, a, b in zip(dev_names, ds.tolist(), de.tolist()):
        s = ops.setdefault(name, [0.0, 0])
        s[0] += b - a
        s[1] += 1
    busy, gaps = 0.0, []
    if ds.size:
        order = np.argsort(ds, kind="stable")
        s, e = ds[order], np.maximum.accumulate(de[order])
        new = np.concatenate([[0], np.flatnonzero(s[1:] > e[:-1]) + 1])
        seg_s, seg_e = s[new], e[np.concatenate([new[1:] - 1, [s.size - 1]])]
        busy = float((seg_e - seg_s).sum())
        g = seg_s[1:] - seg_e[:-1]
        for i in np.argsort(-g, kind="stable")[:TOP].tolist():
            gaps.append((float(seg_e[i]), float(seg_s[i + 1])))
    hs = np.array([h[1] for h in host]) if host else np.zeros(0)
    he = np.array([h[2] for h in host]) if host else np.zeros(0)
    idle = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = {}
        for i in np.flatnonzero((hs <= mid) & (he >= mid)).tolist():
            name, st, _, thread = host[i]
            if thread not in inner or st > inner[thread][1]:
                inner[thread] = (name, st)
        label = " + ".join(sorted({v[0] for v in inner.values()})) or "no traced host call"
        idle.append([label[:160], b - a])
    return {"window_s": float(window_s), "busy_s": busy, "ops": ops, "idle_gaps": idle}


def kernel_seconds(trace: dict, prefix: str) -> tuple[float, int]:
    """(seconds, count) of the device operations whose bare name starts
    with `prefix`."""
    secs = n = 0
    for name, (s, c) in trace["ops"].items():
        if kernel_base(name).startswith(prefix):
            secs += s
            n += c
    return secs, n


def breakdown(trace: dict) -> dict:
    """The device operations that took most time, by `short_name`, and the
    longest idle gaps."""
    by: dict = {}
    for name, (s, _) in trace["ops"].items():
        k = short_name(name)
        by[k] = by.get(k, 0.0) + s
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": trace["idle_gaps"]}
