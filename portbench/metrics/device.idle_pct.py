"""device.idle_pct: the share of the traced window (first pass's start to
last pass's end) in which no kernel, copy or set ran on the card."""


def read(rec: dict) -> float | None:
    events, window = rec["device_events"], rec["trace_window_s"]
    if not events or not window:
        return None
    spans = sorted((s, t) for _, s, t in events)
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    return 100.0 * (1.0 - busy / window)
