"""engine.tables_ms: per pass, the lane engine's timer of its per-lane
draw tables (``torch.tables_s``)."""


def read(rec: dict) -> float | None:
    t = rec["timers"].get("torch.tables_s")
    return None if t is None or not rec["passes"] else t / rec["passes"] * 1e3
