"""Platform / fault-model parameter sets from the paper (§5.1).

The port's copy of ``repro/configs/paper.py``, as data.  SYNTHETIC matches
the synthetic-trace experiments (C = R = 600 s, D = 60 s, mu_ind = 125
years); LOGBASED matches the LANL log-based experiments (C = R = 60 s,
D = 6 s).  TPU_V5E is the reference's TPU-v5e setting: C is derived from
per-chip checkpoint shard bytes / bandwidth by the checkpoint manager,
with the same Jaguar-calibrated per-chip MTBF.  Predictor presets are the
two literature predictors used in §5.  These are the reference's
parameter sets; none of them is a statement about a GPU.
"""

from .base import PlatformConfig

__all__ = ["CP_SCENARIOS", "LOGBASED", "PREDICTOR_FAIR", "PREDICTOR_GOOD",
           "SYNTHETIC", "TPU_V5E"]

# Paper §5.1 synthetic-trace setting (times in seconds).
SYNTHETIC = PlatformConfig(
    mu_ind=125.0 * 365.0 * 86400.0,
    c=600.0, cp=600.0, r=600.0, d=60.0,
    recall=0.85, precision=0.82,
)

# Paper §5.1 log-based setting (LANL clusters 18/19).
LOGBASED = PlatformConfig(
    mu_ind=691.0 * 86400.0,
    c=60.0, cp=60.0, r=60.0, d=6.0,
    recall=0.85, precision=0.82,
)

# The two predictors compared throughout §5.
PREDICTOR_GOOD = {"recall": 0.85, "precision": 0.82}   # Yu et al. [7]
PREDICTOR_FAIR = {"recall": 0.70, "precision": 0.40}   # Zheng et al. [8]

# Proactive-checkpoint cost scenarios (§5.1): C_p = C, 0.1C, 2C.
CP_SCENARIOS = {"equal": 1.0, "cheap": 0.1, "expensive": 2.0}

# The reference's TPU-v5e platform: C computed from bytes/bandwidth at
# runtime.  ckpt_bandwidth=2e9 B/s is the reference's value for a TPU
# host, kept as it is; it was not measured for this port's card.
TPU_V5E = PlatformConfig(
    mu_ind=125.0 * 365.0 * 86400.0,
    c=0.0,            # 0 => derive from checkpoint shard bytes / bandwidth
    cp=0.0,           # 0 => derive from delta-encoded shard bytes
    r=120.0, d=30.0,
    recall=0.85, precision=0.82,
    ckpt_bandwidth=2e9,
)
