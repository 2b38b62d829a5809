"""study.host_ms: per pass, the harness's span around the pass less the
lane engine's four timers (draw tables, uploads, the host loop with its
launches, read-backs): candidates, lane packing, results and means."""

ENGINE = ("torch.tables_s", "torch.upload_s", "torch.run_s",
          "torch.readback_s")


def read(rec: dict) -> float | None:
    if not rec["passes"] or not all(k in rec["timers"] for k in ENGINE):
        return None
    engine = sum(rec["timers"][k] for k in ENGINE)
    return (sum(rec["pass_s"]) - engine) / rec["passes"] * 1e3
