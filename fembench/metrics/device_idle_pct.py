"""device_idle_pct: the share of the traced window in which no operation
(kernel, copy or set) ran on the device: 100 x (1 - the union of their
intervals / the window's length), from torch.profiler's trace."""


def read(run: dict):
    t = run.get("trace")
    if not t or not t["ops"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
