"""The port's per-lane path against the JAX package's: the Riccati sweep
``riccati.backward_pass``/``solve_lqr``, the interior-point QP
``ipqp.solve_qp``, the solve ``sqp.solve``/``solve_batch`` (AL and IP; KS,
ST once, boundary rows once), the loop set-up ``make_loop_config``/
``make_loop_params`` on every shipped config, and C2's two fallbacks (the
IP wrapper outside its kernel's envelope, the xla loop with method='ip').

Inputs come from numpy seeds; the JAX side's objects reach the port through
``mpc_tpu_torch.convert``.  The sweep and the QP are held in float64 at
1e-9 (the same formulas in another order); the solves at the reference's
float32 bands (tests/test_fused_gn.py:42-55, tests/test_fused_ip.py:41-57);
the loops at the closed-loop bands of tests/test_torch_closed_loop.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu.io import config as jconfig
from mpc_tpu.ops import ipqp as JQ
from mpc_tpu.ops import riccati as JR
from mpc_tpu.ops import sqp as JS
from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu.utils import synthetic as jsyn
from mpc_tpu_torch import convert
from mpc_tpu_torch.io import config as tconfig
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import ipqp as TQ
from mpc_tpu_torch.ops import riccati as TR
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from tests.test_torch_fused_gn import assert_solutions_close
from tests.test_torch_fused_ip import (assert_ip_solutions_close,
                                       ip_ocp_numpy, jax_ocp, jax_state)

from asset_paths import CFG, SCN

TIGHT = dict(rtol=1e-9, atol=1e-9)   # float64, the same formulas


def _np(x):
    return np.asarray(x, np.float64)


def lqr_numpy(seed, B=3, H=6, nx=5, nu=2):
    """A well-conditioned stagewise LQR with a nonzero defect."""
    rng = np.random.default_rng(seed)

    def spd(n, lead):
        m = rng.normal(size=lead + (n, n))
        return m @ np.swapaxes(m, -1, -2) + n * np.eye(n)

    return dict(
        Q=spd(nx, (B, H)), R=spd(nu, (B, H)),
        M=0.1 * rng.normal(size=(B, H, nx, nu)),
        qx=rng.normal(size=(B, H, nx)), qu=rng.normal(size=(B, H, nu)),
        QH=spd(nx, (B,)), qH=rng.normal(size=(B, nx)),
        A=np.eye(nx) + 0.1 * rng.normal(size=(B, H, nx, nx)),
        B=0.1 * rng.normal(size=(B, H, nx, nu)),
        r=0.01 * rng.normal(size=(B, H, nx)),
        dx0=0.1 * rng.normal(size=(B, nx)))


@pytest.mark.parametrize("nx", [5, 7])
def test_backward_pass_and_solve_lqr_equal_jax(nx):
    d = lqr_numpy(0, nx=nx)
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in d.items()}
        jq = JR.StageQuad(Q=j["Q"], R=j["R"], M=j["M"], qx=j["qx"],
                          qu=j["qu"])
        jd = JR.LinDyn(A=j["A"], B=j["B"], r=j["r"])
        gains = jax.vmap(lambda q, QH, qH, dy: JR.backward_pass(
            q, QH, qH, dy, 1e-6))(jq, j["QH"], j["qH"], jd)
        dX, dU, _ = jax.vmap(lambda q, QH, qH, dy, x0: JR.solve_lqr(
            q, QH, qH, dy, x0, 1e-6))(jq, j["QH"], j["qH"], jd, j["dx0"])
    quad, dyn = convert.stage_quad(jq), convert.lin_dyn(jd)
    got = TR.backward_pass(quad, torch.tensor(d["QH"]),
                           torch.tensor(d["qH"]), dyn, 1e-6)
    want = convert.riccati_gains(gains)
    for f in TR.RiccatiGains._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), **TIGHT,
                                   err_msg=f)
    gX, gU, _ = TR.solve_lqr(quad, torch.tensor(d["QH"]),
                             torch.tensor(d["qH"]), dyn,
                             torch.tensor(d["dx0"]), 1e-6)
    np.testing.assert_allclose(gX.numpy(), _np(dX), **TIGHT)
    np.testing.assert_allclose(gU.numpy(), _np(dU), **TIGHT)


def test_costs_equal_jax():
    """stage_cost, terminal_cost and trajectory_cost (both terminal modes)
    against the JAX package's on one horizon, float64."""
    from mpc_tpu.models import costs as JC
    from mpc_tpu_torch.models import costs as TC
    rng = np.random.default_rng(3)
    X, U, R = (rng.normal(size=(7, 5)), rng.normal(size=(6, 2)),
               rng.normal(size=(7, 5)))
    w = {k: rng.uniform(0.1, 2.0, size=n) for k, n in (("q", 5), ("r", 2),
                                                       ("qN", 5))}
    with jax.enable_x64(True):
        jw = JC.Weights(**{k: jnp.asarray(v) for k, v in w.items()})
        want = [JC.stage_cost(jnp.asarray(X[:-1]), jnp.asarray(U),
                              jnp.asarray(R[:-1]), jw),
                JC.terminal_cost(jnp.asarray(X[-1]), jnp.asarray(R[-1]), jw)]
        want += [JC.trajectory_cost(jnp.asarray(X), jnp.asarray(U),
                                    jnp.asarray(R), jw, term)
                 for term in (True, False)]
    tw = convert.weights(jw)
    X, U, R = torch.tensor(X), torch.tensor(U), torch.tensor(R)
    got = [TC.stage_cost(X[:-1], U, R[:-1], tw),
           TC.terminal_cost(X[-1], R[-1], tw)]
    got += [TC.trajectory_cost(X, U, R, tw, term) for term in (True, False)]
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(wv), **TIGHT)


def qp_numpy(seed, B=3, H=6, nx=5, nu=2, nr=8):
    """A stagewise QP with two-sided rows, some sides unbounded, some rows
    violated at the start (h0 outside [lo, hi])."""
    d = lqr_numpy(seed, B, H, nx, nu)
    rng = np.random.default_rng(seed + 100)
    J = rng.normal(size=(B, H + 1, nr, nx + nu))
    J[:, -1, :, nx:] = 0.0               # terminal rows: dx columns only
    lo = rng.uniform(-1.0, 0.0, size=(B, H + 1, nr))
    hi = lo + rng.uniform(0.5, 2.0, size=(B, H + 1, nr))
    lo[..., ::3] = -np.inf
    hi[..., 1::4] = np.inf
    h0 = rng.uniform(-1.5, 1.5, size=(B, H + 1, nr))
    return dict(Q=d["Q"], R=d["R"], M=d["M"], qx=d["qx"], qu=d["qu"],
                QH=d["QH"], qH=d["qH"], A=d["A"], B=d["B"], r=d["r"], J=J,
                h0=h0, lo=lo, hi=hi)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_qp_equal_jax(warm):
    d = qp_numpy(1)
    rng = np.random.default_rng(7)
    z0 = [np.where(rng.uniform(size=d["h0"].shape) < 0.5, 0.0,
                   rng.uniform(0.0, 50.0, size=d["h0"].shape))
          for _ in range(2)] if warm else [None, None]
    with jax.enable_x64(True):
        jqp = JQ.QpData(**{k: jnp.asarray(v) for k, v in d.items()})
        zl, zh = (None, None) if not warm else (jnp.asarray(z0[0]),
                                                jnp.asarray(z0[1]))
        ref = jax.vmap(lambda qp, a, b: JQ.solve_qp(
            qp, n_iters=6, reg=1e-7, z_lo0=a, z_hi0=b),
            in_axes=(0, None if zl is None else 0,
                     None if zh is None else 0))(jqp, zl, zh)
    got = TQ.solve_qp(convert.qp_data(jqp), n_iters=6, reg=1e-7,
                      z_lo0=None if not warm else torch.tensor(z0[0]),
                      z_hi0=None if not warm else torch.tensor(z0[1]))
    want = convert.ip_state(ref)
    for f in TQ.IpState._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=1e-8,
                                   atol=1e-9, err_msg=f)
    assert bool((got.s_lo > 0).all()) and bool((got.z_hi >= 0).all())


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


CONFIGS = sorted(f for f in os.listdir(CFG) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", CONFIGS)
def test_make_loop_config_and_params_equal_jax(name):
    """The loop set-up of every shipped config: the LoopConfig equal to the
    JAX package's (through convert), the LoopParams within float32 rounding
    of JAX's (circle centres, boundary resampling and sign calibration, the
    padded track and the moving obstacle's track)."""
    jc = jconfig.load_config(os.path.join(CFG, name), SCN)
    tc = tconfig.load_config(os.path.join(CFG, name), SCN)
    jl = jcl.make_loop_config(jc)
    tl = tcl.make_loop_config(tc)
    assert tl == convert.loop_config(jl)
    assert tcl.make_loop_config(convert.planning_config(jc)) == tl
    jp = jcl.make_loop_params(jc, jl, seed=3)
    tp = tcl.make_loop_params(tc, tl, seed=3, device="cpu")
    want = convert.loop_params(jp)
    for f in tcl.LoopParams._fields:
        a, b = getattr(tp, f), getattr(want, f)
        if f == "noise_key":
            assert tp.noise_key.tolist() == [0, 3]
            continue
        assert (a is None) == (b is None), f
        if a is None:
            continue
        for x, y in zip(a if isinstance(a, tuple) else
                        (a.q, a.r, a.qN) if f == "weights" else (a,),
                        b if isinstance(b, tuple) else
                        (b.q, b.r, b.qN) if f == "weights" else (b,)):
            assert x.shape == y.shape and x.dtype == y.dtype, f
            np.testing.assert_allclose(x.double().numpy(),
                                       y.double().numpy(), rtol=1e-6,
                                       atol=1e-5, err_msg=f)


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


def test_xla_ip_loop_equal_jax():
    """C2, second half: ``closed_loop_batch_vec`` with engine='xla',
    method='ip' against JAX's (which falls back to ``closed_loop_batch``)
    on the non-chaotic overtake workload: X 5e-2, U 5e-3, the same
    feasibility, and ``closed_loop_batch`` itself equal to it."""
    kw = dict(method="ip", ip_sqp_iters=1, ip_iters=4, ip_warm_duals=True,
              engine="xla")
    jl, jp = jsyn.make_bench_loop(n_steps=20, horizon=10, n_lanes=4, **kw)
    ref = jcl.closed_loop_batch_vec(jl, jp)
    tl, tp = convert.loop_config(jl), convert.loop_params(jp)
    got = tcl.closed_loop_batch_vec(tl, tp, device="cpu")
    err_x = np.abs(np.asarray(ref.X) - got.X.numpy()).max()
    err_u = np.abs(np.asarray(ref.U) - got.U.numpy()).max()
    print(f"xla ip loop max abs err: X {err_x:.3g}  U {err_u:.3g}")
    assert got.X.shape == (4, 20, 5)
    assert err_x < 5e-2 and err_u < 5e-3
    np.testing.assert_array_equal(got.status.numpy() >= 0,
                                  np.asarray(ref.status) >= 0)
    again = tcl.closed_loop_batch(tl, tp, device="cpu")
    assert torch.equal(again.U, got.U)
