"""The port's parallel-scan sweep (``ops.pscan``) on the CPU: the scan's
algebra (its combine is associative, a block of its elements is the
slice of all) and the per-lane path's ``lqr_backend='pscan'`` on the IP
path and with a stage axis.  The sweep against the JAX package's
``mpc_tpu.ops.pscan`` (at the bands of ``tests/test_pscan.py``) and
against the port's sequential sweep in float64 is
``tests/test_torch_pscan_jax.py``; the stage-sharded sweep runs under
ranks in ``tests/test_torch_distributed.py``.
"""
import pytest
import torch

from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import pscan as TP
from mpc_tpu_torch.ops import sqp as TS
from tests.test_torch_fused_gn import ocp_numpy
from torch_lqr_cases import _problems, _torch


def test_combine_is_associative():
    """The composition the scan's order rests on: (a o b) o c == a o (b o
    c), float64, on random elements of the first three stages."""
    arrs, _ = _problems(3, B=2, seed=9)
    quad, QH, qH, dyn, _ = _torch(arrs, torch.float64)
    e = TP._elements(quad, QH, qH, dyn, 1e-6)
    a, b, c = (TP._take(e, k, k + 1) for k in range(3))
    left = TP._combine(TP._combine(a, b), c)
    right = TP._combine(a, TP._combine(b, c))
    for f, g in zip(left, right):
        torch.testing.assert_close(f, g, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (3, 4), (0, 4)])
def test_block_of_elements_is_the_slice_of_all(lo, hi):
    """A rank's block [lo, hi) of the H+1 elements, built from its own
    stages (the terminal element on the last block, a block of the
    terminal element alone included), equals that slice of every element
    built at once, float64."""
    arrs, _ = _problems(3, B=2, seed=9)
    quad, QH, qH, dyn, _ = _torch(arrs, torch.float64)
    whole = TP._take(TP._elements(quad, QH, qH, dyn, 1e-6), lo, hi)
    block = TP._elements(quad, QH, qH, dyn, 1e-6, lo, hi)
    for f, g in zip(block, whole):
        torch.testing.assert_close(f, g, rtol=1e-12, atol=1e-12)


def test_ip_path_and_stage_axis():
    """The IP solve has its own sweep and reads no ``lqr_backend`` (as in
    the JAX package): 'pscan' is 'scan' at atol 0.  A stage axis without
    a mesh raises ``ValueError``."""
    H, B = 6, 2
    d = ocp_numpy(H, B, seed=1)
    kw = dict(horizon=H, method="ip", ip_sqp_iters=1, ip_iters=3)
    tocp = convert.ocp_params(d)
    got = TS.solve_batch(TS.SolverConfig(lqr_backend="pscan", **kw), tocp,
                         TS.init_state(TS.SolverConfig(**kw), batch=B),
                         device="cpu")
    ref = TS.solve_batch(TS.SolverConfig(**kw), tocp,
                         TS.init_state(TS.SolverConfig(**kw), batch=B),
                         device="cpu")
    for f in ("X", "U", "status", "viol", "cost"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    cfg = TS.SolverConfig(horizon=H, lqr_backend="pscan", stage_axis="sp")
    with pytest.raises(ValueError, match="needs a mesh"):
        TS.solve_batch(cfg, tocp, TS.init_state(cfg, batch=B), device="cpu")
