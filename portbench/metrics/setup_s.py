"""setup_s: seconds from the process's start to the first timed pass
(imports, loading the built kernels, making the trace pool, the warm
pass)."""


def read(rec: dict) -> float:
    return rec["setup_s"]
