"""Options and sentinels of the AD-Census pipeline.

The port's own copy of ``adcensus_tpu/config.py``: the same 16 reference
tunables (AD-Census/adcensus_types.h:45-75) with identical defaults, plus
the ``exact_median`` engine extension.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Sentinel for invalid disparities (reference: adcensus_types.h:33).
INVALID_FLOAT = float(np.float32(np.inf))
# Large float sentinel (reference: adcensus_types.h:35).
LARGE_FLOAT = float(np.float32(99999.0))
# Cap on cross arm length, uint8 storage (reference: cross_aggregator.h:22).
MAX_ARM_LENGTH = 255


@dataclasses.dataclass(frozen=True)
class ADCensusOptions:
    """All tunables of the AD-Census pipeline; defaults match the
    reference constructor (adcensus_types.h:67-74)."""

    min_disparity: int = 0
    max_disparity: int = 64

    lambda_ad: int = 10        # AD cost weighting lambda
    lambda_census: int = 30    # census cost weighting lambda
    cross_L1: int = 34         # cross window max arm length
    cross_L2: int = 17         # cross window secondary length threshold
    cross_t1: int = 20         # cross window color threshold 1
    cross_t2: int = 6          # cross window color threshold 2
    so_p1: float = 1.0         # scanline optimization P1
    so_p2: float = 3.0         # scanline optimization P2
    so_tso: int = 15           # scanline optimization color-gradient threshold
    irv_ts: int = 20           # iterative region voting count threshold
    irv_th: float = 0.4        # iterative region voting ratio threshold

    lrcheck_thres: float = 1.0  # left-right consistency threshold

    do_lr_check: bool = True
    # One flag gates both region voting and interpolation, as in the
    # reference (ADCensusStereo.cpp:182-183 passes do_filling twice).
    do_filling: bool = True
    do_discontinuity_adjustment: bool = False

    # Engine extension: the reference's in-place raster-order median.
    # Not ported yet; the port raises when it is set.
    exact_median: bool = False

    @property
    def disp_range(self) -> int:
        return self.max_disparity - self.min_disparity

    def validate(self) -> None:
        if self.disp_range <= 0:
            raise ValueError(
                f"max_disparity ({self.max_disparity}) must exceed "
                f"min_disparity ({self.min_disparity})"
            )


def options_from_jax(d: dict) -> ADCensusOptions:
    """Options from ``dataclasses.asdict`` of an ``adcensus_tpu``
    ``ADCensusOptions``: the system has no weights, so this is what
    carries a configuration across. Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(ADCensusOptions)}
    unknown = set(d) - names
    missing = names - set(d)
    if unknown or missing:
        raise ValueError(
            f"options do not match: unknown {sorted(unknown)}, "
            f"missing {sorted(missing)}"
        )
    return ADCensusOptions(**d)
