"""banded_myers_roofline_pct: banded Myers' share of its roofline
(fem_tpu_torch/csrc/banded_myers.cu, every tier's launches).

Work, from FEM's counter num_candidates over the reads the traced stream
emitted (held against the reference by the check): each candidate is L
steps of the bit-parallel recurrence at 17 int32 operations a step (11 for
the recurrence with three-input logic ops, 6 for the band's pattern bits;
the kernel table's model in PERF.md), and L read bytes, L + 2e reference bytes and
8 result bytes. Bound: the larger of operations / 16.73 Top/s (64 int32
lanes x 132 SMs x 1.98 GHz, H100 SXM) and bytes / 3.35 TB/s. Share: the
bound over the profiler's summed time of the device operations whose bare
name begins `banded_myers`."""

from fembench.trace import kernel_seconds

PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9
OPS_PER_STEP = 17
PREFIX = "banded_myers"


def read(run: dict):
    t = run.get("trace")
    if not t:
        return None
    secs, _ = kernel_seconds(t, PREFIX)
    n = run["window"]["totals"]["num_candidates"]
    L, e = run["read_length"], run["fem"]["error_threshold"]
    if secs <= 0 or n <= 0:
        return None
    bound = max(n * L * OPS_PER_STEP / PEAK_INT32_OPS_S, n * (L + (L + 2 * e) + 8) / PEAK_BYTES_S)
    return 100.0 * bound / secs
