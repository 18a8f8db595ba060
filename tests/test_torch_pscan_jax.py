"""The port's parallel-scan sweep (``ops.pscan``) against the JAX package's
``mpc_tpu.ops.pscan`` on the same seeded problems, at the bands of
``tests/test_pscan.py``, and against the port's sequential sweep in
float64: the gains at three horizons, the value functions, the LQR solve
against the dense KKT oracle, and the per-lane AL solve with
``lqr_backend='pscan'`` (the scan's algebra, its blocks and the IP path:
``tests/test_torch_pscan.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import pscan as JP
from mpc_tpu.ops import riccati as JR
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import pscan as TP
from mpc_tpu_torch.ops import riccati as TR
from mpc_tpu_torch.ops import sqp as TS
from tests.test_riccati import _dense_oracle
from tests.test_torch_fused_gn import jax_ocp, ocp_numpy
from torch_lqr_cases import TIGHT, _problems, _torch

BAND = dict(rtol=2e-3, atol=2e-3)     # tests/test_pscan.py:26-28


def _jax_vmapped(fn, arrs):
    """``fn(quad, QH, qH, dyn, dx0)`` of the JAX package, vmapped over the
    lanes, in float32."""
    Q, Rm, M, qx, qu, QH, qH, A, B, r, dx0 = (
        jnp.asarray(a, jnp.float32) for a in arrs)

    def one(Q, Rm, M, qx, qu, QH, qH, A, B, r, dx0):
        return fn(JR.StageQuad(Q, Rm, M, qx, qu), QH, qH, JR.LinDyn(A, B, r),
                  dx0)

    return jax.vmap(one)(Q, Rm, M, qx, qu, QH, qH, A, B, r, dx0)


def _close(got, ref, **band):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **band)


@pytest.mark.parametrize("H", [2, 10, 64])
def test_backward_pass_matches_jax(H):
    """K and d of ``backward_pass_pscan`` against JAX's pscan (float32) at
    H = 2, 10 and the long horizon 64, and against the port's sequential
    sweep in float64 within 1e-9."""
    arrs, _ = _problems(H)
    ref = _jax_vmapped(lambda q, QH, qH, d, _: JP.backward_pass_pscan(
        q, QH, qH, d, reg=1e-6), arrs)
    quad, QH, qH, dyn, _ = _torch(arrs, torch.float32)
    got = TP.backward_pass_pscan(quad, QH, qH, dyn, 1e-6)
    _close(got.K, ref.K, **BAND)
    _close(got.d, ref.d, **BAND)
    _close(got.dV1, ref.dV1, rtol=2e-3, atol=2e-2)
    _close(got.dV2, ref.dV2, rtol=2e-3, atol=2e-2)
    quad, QH, qH, dyn, _ = _torch(arrs, torch.float64)
    seq = TR.backward_pass(quad, QH, qH, dyn, 1e-6)
    par = TP.backward_pass_pscan(quad, QH, qH, dyn, 1e-6)
    for f in TR.RiccatiGains._fields:
        torch.testing.assert_close(getattr(par, f), getattr(seq, f),
                                   rtol=TIGHT, atol=TIGHT, msg=f)


def test_value_functions_match_jax():
    """Every P_k, p_k of the suffix scan against JAX's (H=12)."""
    arrs, _ = _problems(12, seed=5)
    P_ref, p_ref = _jax_vmapped(lambda q, QH, qH, d, _: JP.value_functions(
        q, QH, qH, d, reg=0.0), arrs)
    quad, QH, qH, dyn, _ = _torch(arrs, torch.float32)
    P, p = TP.value_functions(quad, QH, qH, dyn, 0.0)
    assert P.shape == (3, 13, 5, 5) and p.shape == (3, 13, 5)
    _close(P, P_ref, rtol=5e-3, atol=5e-3)
    _close(p, p_ref, rtol=5e-3, atol=2e-2)


@pytest.mark.parametrize("H", [5, 12])
def test_solve_lqr_matches_jax_and_oracle(H):
    """``forward_rollout_pscan`` and ``solve_lqr_pscan`` against JAX's and
    the dense KKT oracle (tests/test_pscan.py:31-42), and the float64
    solve against the sequential ``riccati.solve_lqr`` within 1e-9."""
    arrs, probs = _problems(H, seed=4)
    dX_ref, dU_ref, g_ref = _jax_vmapped(
        lambda q, QH, qH, d, x0: JP.solve_lqr_pscan(q, QH, qH, d, x0,
                                                     reg=0.0), arrs)
    quad, QH, qH, dyn, dx0 = _torch(arrs, torch.float32)
    dX, dU, gains = TP.solve_lqr_pscan(quad, QH, qH, dyn, dx0, 0.0)
    _close(dX, dX_ref, rtol=5e-3, atol=5e-3)
    _close(dU, dU_ref, rtol=5e-3, atol=5e-3)
    fX, fU = TP.forward_rollout_pscan(
        TR.RiccatiGains(*(torch.as_tensor(np.array(v)) for v in g_ref)),
        dyn, dx0)
    _close(fX, dX_ref, rtol=5e-3, atol=5e-3)
    _close(fU, dU_ref, rtol=5e-3, atol=5e-3)
    for b, p in enumerate(probs):
        dX_o, dU_o = _dense_oracle(*p)
        np.testing.assert_allclose(dU[b].numpy(), dU_o, rtol=5e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(dX[b].numpy(), dX_o, rtol=5e-3,
                                   atol=5e-3)
    quad, QH, qH, dyn, dx0 = _torch(arrs, torch.float64)
    seq = TR.solve_lqr(quad, QH, qH, dyn, dx0, 0.0)
    par = TP.solve_lqr_pscan(quad, QH, qH, dyn, dx0, 0.0)
    for a, b in zip(par[:2], seq[:2]):
        torch.testing.assert_close(a, b, rtol=TIGHT, atol=TIGHT)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solve_batch_pscan_matches_jax(dtype):
    """The per-lane AL solve with ``lqr_backend='pscan'`` against the JAX
    package's vmapped ``sqp.solve`` with pscan: float32 U within 1e-3
    (tests/test_pscan.py:93-103), float64 within 1e-9; and within 1e-3 of
    the port's own 'scan' solve."""
    H, B = 8, 3
    f64 = dtype == np.float64
    d = {k: (v.astype(dtype) if isinstance(v, np.ndarray)
             else {kk: vv.astype(dtype) for kk, vv in v.items()})
         for k, v in ocp_numpy(H, B, seed=2).items()}
    jcfg = JS.SolverConfig(horizon=H, lqr_backend="pscan", al_iters=2,
                           sqp_iters=2)
    tcfg = convert.solver_config(jcfg)
    tdt = torch.float64 if f64 else torch.float32
    with jax.enable_x64(f64):
        jst = jax.vmap(lambda _: JS.init_state(
            jcfg, dtype=jnp.float64 if f64 else jnp.float32))(jnp.arange(B))
        ref = JS.solve_batch(jcfg, jax_ocp(d), jst)
    tocp = convert.ocp_params(d)
    got = TS.solve_batch(tcfg, tocp, TS.init_state(tcfg, batch=B, dtype=tdt),
                         device="cpu")
    band = dict(rtol=TIGHT, atol=TIGHT) if f64 else dict(rtol=1e-3,
                                                         atol=1e-3)
    _close(got.U, ref.U, **band)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    scan = TS.solve_batch(dataclasses.replace(tcfg, lqr_backend="scan"),
                          tocp, TS.init_state(tcfg, batch=B, dtype=tdt),
                          device="cpu")
    torch.testing.assert_close(got.U, scan.U, rtol=1e-3, atol=1e-3)
