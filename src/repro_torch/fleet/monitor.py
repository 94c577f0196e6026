"""Fleet health checks.  Only the Eq. 3 band check is ported so far;
the all-pairs health views wait for the all-pairs kernels."""
from __future__ import annotations

__all__ = ["fp_within_band"]


def fp_within_band(measured_fp: float, mean_predicted_fp: float,
                   slack: float = 3.0, abs_tol: float = 0.01) -> bool:
    """Is a measured false-positive rate consistent with the Eq. 3
    prediction?  Eq. 3 is an independence approximation, so accept a
    multiplicative slack plus an absolute floor for small samples."""
    return measured_fp <= mean_predicted_fp * slack + abs_tol
