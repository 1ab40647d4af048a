"""filter_tail_roofline_pct: the filter tail's share of its roofline
(fem_tpu_torch/csrc/filter_tail.cu, every tier's launches).

Work, from FEM's counters over the reads the traced stream emitted (the
counters the check holds against the reference, so the work is what the
inputs need, whatever implements the kernel): the merged occurrences the
tail reads, 8 bytes each (num_candidates_without_additional_qgram_filter),
and the candidates it writes, 8 bytes each (num_candidates). A retry's
second run adds time and no work. Bound: bytes / 3.35 TB/s (H100 SXM,
NVIDIA's data sheet). Share: the bound over the profiler's summed time of
the device operations whose bare name begins `filter_tail`."""

from fembench.trace import kernel_seconds

PEAK_BYTES_S = 3.35e12
PREFIX = "filter_tail"


def read(run: dict):
    t = run.get("trace")
    if not t:
        return None
    secs, _ = kernel_seconds(t, PREFIX)
    c = run["window"]["totals"]
    nbytes = 8 * (c["num_candidates_without_additional_qgram_filter"] + c["num_candidates"])
    if secs <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / PEAK_BYTES_S) / secs
