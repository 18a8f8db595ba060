"""The port's per-lane solve ``sqp.solve``/``solve_batch`` (AL and IP; KS,
ST once, boundary rows once) against the JAX package's, and C2's first
half, the IP wrapper outside its kernel's envelope (the rest of the
per-lane path: ``tests/test_torch_per_lane.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from tests.test_torch_fused_gn import assert_solutions_close
from tests.test_torch_fused_ip import (assert_ip_solutions_close,
                                       ip_ocp_numpy, jax_ocp, jax_state)
from torch_per_lane_cases import TIGHT, _np


# (method fields, OCP options, model, dtype): the AL and IP solves of KS,
# the IP solve of ST once and with boundary rows once.  The ST case runs
# in float64: its cold start is ill-conditioned (stationarity ~2.5e6), and
# in float32 rounding decides a ladder rung of one lane's chained solve (U
# parts by 5e-3 there from JAX's float32 solve, by 1e-15 in float64).
SOLVE_CASES = {
    "al-ladder": (dict(al_iters=2, sqp_iters=2), {}, "ks", np.float32),
    "al-casadi-moving": (dict(al_iters=1, sqp_iters=2, formulation="casadi",
                              integrator="euler", use_terminal_cost=False),
                         dict(moving=True), "ks", np.float32),
    "ip-warm-ladder": (dict(method="ip", ip_sqp_iters=2, ip_iters=4,
                            ip_warm_duals=True), {}, "ks", np.float32),
    "ip-warm-ladder-f64": (dict(method="ip", ip_sqp_iters=2, ip_iters=4,
                                ip_warm_duals=True), {}, "ks", np.float64),
    "ip-unguarded-casadi": (dict(method="ip", ip_sqp_iters=2, ip_iters=4,
                                 ip_alphas=(), formulation="casadi",
                                 integrator="euler",
                                 use_terminal_cost=False), {}, "ks",
                            np.float32),
    "ip-st": (dict(method="ip", ip_sqp_iters=1, ip_iters=4), {}, "st",
              np.float64),
    "ip-boundary-rows": (dict(method="ip", ip_sqp_iters=2, ip_iters=4,
                              boundary_rows=True), dict(boundaries=True),
                         "ks", np.float32),
}


def _solve_case(case, H=8, B=3):
    fields, opts, model, dtype = SOLVE_CASES[case]
    from mpc_tpu.models.vehicle import VEHICLE_2 as JV2
    extra = dict(model="st", vehicle=JV2) if model == "st" else {}
    jcfg = JS.SolverConfig(horizon=H, **fields, **extra)
    d = ip_ocp_numpy(H, B, seed=0, moving=opts.get("moving", False))
    if opts.get("boundaries"):
        t = cs.with_road_boundaries(convert.ocp_params(d), half_width=1.4)
        d = dict(d, boundaries=t.boundaries.numpy(),
                 boundary_signs=t.boundary_signs.numpy())
    d = {k: (v.astype(dtype) if isinstance(v, np.ndarray)
             else {kk: vv.astype(dtype) for kk, vv in v.items()})
         for k, v in d.items()}
    return jcfg, d, dtype


def _jax_ocp(d):
    p = jax_ocp(d)
    if "boundaries" in d:
        p = p._replace(boundaries=jnp.asarray(d["boundaries"]),
                       boundary_signs=jnp.asarray(d["boundary_signs"]))
    return p


def assert_tight(got, ref):
    """float64: the solution and the carried state within 1e-9 / 1e-8."""
    for f in ("X", "U", "kkt_stat", "viol", "cost", "status"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   _np(getattr(ref, f)), **TIGHT, err_msg=f)
    for f in ("lam_lo", "lam_hi", "mu", "prev_viol"):
        np.testing.assert_allclose(getattr(got.state, f).numpy(),
                                   _np(getattr(ref.state, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_equal_jax(case):
    """``sqp.solve_batch`` against the JAX package's per-lane (vmapped)
    ``sqp.solve_batch``, a warm second solve chained on each side's state:
    float32 at the reference bands, float64 within 1e-9; ``sqp.solve`` is
    lane 0 of it."""
    B = 3
    jcfg, d, dtype = _solve_case(case, B=B)
    f64 = dtype == np.float64
    tcfg, tocp = convert.solver_config(jcfg), convert.ocp_params(d)
    tdt = torch.float64 if f64 else torch.float32
    with jax.enable_x64(f64):
        jst = jax.vmap(lambda _: JS.init_state(
            jcfg, dtype=jnp.float64 if f64 else jnp.float32))(jnp.arange(B))
        ref = JS.solve_batch(jcfg, _jax_ocp(d), jst)
        ref2 = JS.solve_batch(jcfg, _jax_ocp(d), ref.state)
    got = TS.solve_batch(tcfg, tocp, TS.init_state(tcfg, batch=B, dtype=tdt),
                         device="cpu")
    got2 = TS.solve_batch(tcfg, tocp, got.state, device="cpu")
    if f64:
        assert_tight(got, ref)
        assert_tight(got2, ref2)
    elif tcfg.method == "ip":
        assert_ip_solutions_close(got, ref)
        assert_ip_solutions_close(got2, ref2)
    else:
        assert_solutions_close(got, ref)
        assert_solutions_close(got2, ref2)
        np.testing.assert_array_equal(got2.status.numpy(),
                                      np.asarray(ref2.status))
    if tcfg.boundary_rows:
        h, lo, _ = TS._all_rows(tcfg, got.X, got.U, tocp)
        margin = (h - lo)[..., -TS.C.NUM_BOUNDARY:]
        assert float(margin.min()) < 0.05, "no boundary row binds"
    one = TS.solve(tcfg, TS.map_tensors(tocp, lambda t: t[0]),
                   TS.init_state(tcfg, dtype=tdt), device="cpu")
    assert one.X.shape == got.X.shape[1:]
    np.testing.assert_allclose(one.U.numpy(), got.U[0].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(horizon=64, ip_sqp_iters=1, ip_iters=2),
    dict(horizon=8, ip_sqp_iters=1, ip_iters=3,
         ip_alphas=tuple(0.5 ** i for i in range(17))),
], ids=["h64", "17-rungs"])
def test_fused_ip_fallback_equal_jax(kw):
    """C2, first half: outside the IP kernel's envelope the wrapper returns
    the per-lane solve, held to JAX's ``sqp.solve_batch`` (which its
    ``solve_batch_fused_ip`` falls back to) at the reference bands."""
    H, B = kw["horizon"], 2
    jcfg = JS.SolverConfig(method="ip", ip_warm_duals=True, **kw)
    d = ip_ocp_numpy(H, B, seed=2)
    tcfg, tocp = convert.solver_config(jcfg), convert.ocp_params(d)
    assert TFI.ineligible_reason_ip(tcfg, tocp) is not None
    ref = JS.solve_batch(jcfg, jax_ocp(d), jax_state(jcfg, B))
    got = TFI.solve_batch_fused_ip(tcfg, tocp, TS.init_state(tcfg, batch=B),
                                   device="cpu")
    assert_ip_solutions_close(got, ref)
