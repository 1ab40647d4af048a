"""batch_p95_ms: the 95th percentile, over every batch completed in the
(traced) window, of the time from the engine pulling the batch from the
feed to the first item after which engine.watermark_reads covers its last
read, by the host's clock: the turnaround a streaming or checkpointing
user feels. Quantiles as statistics.quantiles(n=100) gives them; none
under 20 batches."""

import statistics


def read(run: dict):
    lat = run["window"]["latencies_s"]
    return statistics.quantiles(lat, n=100)[94] * 1e3 if len(lat) >= 20 else None
