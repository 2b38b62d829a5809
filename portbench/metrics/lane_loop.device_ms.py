"""lane_loop.device_ms: per pass, the device time of the kernels whose
name holds ``lane_loop_kernel`` in the traced window."""

KERNEL = "lane_loop_kernel"


def read(rec: dict) -> float | None:
    events = rec["device_events"]
    if not events or not rec["passes"]:
        return None
    ms = sum(t - s for n, s, t in events if KERNEL in n) * 1e3
    return ms / rec["passes"] if ms > 0.0 else None
