"""reads_per_device_s: the reads the window took from the feed over the
seconds the card was busy with them: every pulled read is mapped and its
records emitted before the trace stops, and the busy seconds are the union
of the intervals of every kernel, copy and set in torch.profiler's trace
of the window (warm-up before it). The reads/s one card gives where its
host keeps it fed; nothing where the trace saw no device operation."""


def read(run: dict):
    t = run.get("trace")
    if not t or not t["ops"] or t["busy_s"] <= 0:
        return None
    return run["window"]["pulled_reads"] / t["busy_s"]
