"""The port's per-lane path against the JAX package's: the Riccati sweep
``riccati.backward_pass``/``solve_lqr``, the interior-point QP
``ipqp.solve_qp`` and the loop set-up ``make_loop_config``/
``make_loop_params`` on every shipped config.  The solve ``sqp.solve``/
``solve_batch`` (AL and IP; KS, ST once, boundary rows once) is
``tests/test_torch_per_lane_solve.py``, with C2's first fallback (the IP
wrapper outside its kernel's envelope); its second (the xla loop with
method='ip') is in ``tests/test_torch_closed_loop_jax.py``.

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

from mpc_tpu.io import config as jconfig
from mpc_tpu.ops import ipqp as JQ
from mpc_tpu.ops import riccati as JR
from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu_torch import convert
from mpc_tpu_torch.io import config as tconfig
from mpc_tpu_torch.ops import ipqp as TQ
from mpc_tpu_torch.ops import riccati as TR
from mpc_tpu_torch.planner import closed_loop as tcl

from asset_paths import CFG, SCN
from torch_per_lane_cases import TIGHT, _np


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
