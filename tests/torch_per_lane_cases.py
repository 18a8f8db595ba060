"""The float64 band and conversion that ``tests/test_torch_per_lane.py``
and ``tests/test_torch_per_lane_solve.py`` share."""
import numpy as np


TIGHT = dict(rtol=1e-9, atol=1e-9)   # float64, the same formulas


def _np(x):
    return np.asarray(x, np.float64)
