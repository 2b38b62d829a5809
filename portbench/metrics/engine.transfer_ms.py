"""engine.transfer_ms: per pass, the lane engine's uploads and read-backs
(``torch.upload_s`` + ``torch.readback_s``)."""


def read(rec: dict) -> float | None:
    t = rec["timers"]
    if not rec["passes"] or "torch.upload_s" not in t \
            or "torch.readback_s" not in t:
        return None
    return (t["torch.upload_s"] + t["torch.readback_s"]) / rec["passes"] * 1e3
