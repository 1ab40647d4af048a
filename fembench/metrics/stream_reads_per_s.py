"""stream_reads_per_s: reads whose every record (retried reads' included)
reached the consumer in the window, over the window's seconds, by the
host's clock: (engine.watermark_reads at the window's end - at its start)
/ seconds. Read in a traced run, under the profiler."""


def read(run: dict):
    w = run["window"]
    return w["reads_completed"] / w["seconds"] if w["seconds"] > 0 else None
