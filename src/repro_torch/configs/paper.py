"""Platform parameters of the paper's synthetic-trace setting (§5.1).

The port's copy of ``SYNTHETIC`` from ``repro/configs/paper.py``: C = R =
600 s, D = 60 s, mu_ind = 125 years, recall 0.85, precision 0.82.  The
trainer's launcher takes the predictor's recall and precision from it.
"""

from .base import PlatformConfig

__all__ = ["SYNTHETIC"]

# Paper §5.1 synthetic-trace setting (times in seconds).
SYNTHETIC = PlatformConfig(
    mu_ind=125.0 * 365.0 * 86400.0,
    c=600.0, cp=600.0, r=600.0, d=60.0,
    recall=0.85, precision=0.82,
)
