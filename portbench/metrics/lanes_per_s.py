"""lanes_per_s: every lane of every pass of the window over the window's
seconds, from its start to the end of its last pass."""


def read(rec: dict) -> float:
    return rec["units"] / rec["window_s"]
