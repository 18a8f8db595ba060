"""Constants of the interior-point stagewise QP (``mpc_tpu.ops.ipqp``).

The fused IP-RTI solve (``ops.fused_ip``) runs the primal-dual
interior-point iteration of ``ipqp`` inside its kernel; these are the
numbers it runs with.  ``QpData`` and ``solve_qp``, the per-lane QP of the
vmapped path, are a later item of ROADMAP queue A (item 9).
"""
from __future__ import annotations

# float32 overflow guards of the iterate (HPIPM-style): slacks are floored
# at _S_FLOOR and duals capped at _Z_MAX, so sigma = z / s stays <= 1e16
_S_FLOOR = 1e-10
_Z_MAX = 1e6
# warm-started duals are clipped to [zc / _WARM_KAPPA, zc * _WARM_KAPPA]
# around the central-path value zc = mu0 / s
_WARM_KAPPA = 100.0

# init_ip / ip_iteration / solve_qp defaults, as the fused kernel uses them
_S_MIN = 1e-2       # smallest initial slack of a feasible row
_MU0 = 1.0          # initial barrier; dual of a violated row at the start
_SIGMA_B = 0.2      # barrier reduction: mu <- max(sigma gap / n, mu_min)
_TAU = 0.995        # fraction-to-boundary
_MU_MIN = 1e-8
