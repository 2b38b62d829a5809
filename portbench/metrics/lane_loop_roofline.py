"""lane_loop_roofline: the least time of the window's passes on the
card (``reference/roofline.py``: the larger of their float64 operations
over 34 TFLOP/s and their bytes over 3.35 TB/s) over the device time of
the lane-loop kernels, in percent."""

KERNEL = "lane_loop_kernel"


def read(rec: dict) -> float | None:
    events, least = rec["device_events"], rec["least_s"]
    if not events or not least:
        return None
    device = sum(t - s for n, s, t in events if KERNEL in n)
    return 100.0 * sum(least) / device if device > 0.0 else None
