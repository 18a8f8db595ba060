"""The forcespro fleet's first cold-start solve (``chip_smoke.FLEET``, the
warm-up budget 5x10 with the ladder, obstacle centres at -1e4) through the
port's plain IP version against the JAX package's executable spec
``sqp.solve_batch(method='ip')``, which tests/test_fused_ip.py holds the
Pallas kernel to.

One lane a config, the loop's own horizon (H=12).  In float64 the plain
version is the spec: every quantity, both duals included, within the IP
bands on every lane.  In float32 config 3
(``config_LF_ZAM_Tutorial-1_2_T-1.yaml``) is held on every quantity but
one dual: the lower side of the friction row (h_f = a^2 + (v^2 tan(delta)
/ l)^2 >= 0) at the terminal stage, where a = 0 and the car drives
straight, so h_f and its gradient vanish.  That dual does not enter
stationarity and is not unique: the spec's own float32 and float64 solves
part on it, and a move of 1e-6 in the inputs moves it by more than the
kernel departed from the plain version on the card.  (Config 2's float32
steering-rate dual at stage 0 parts from the spec's by the fused
kernels' rounding of the rows' margins, which the JAX package's Pallas
kernel shares; ROADMAP queue C.)
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu.io.config import load_config as jload
from mpc_tpu.ops import sqp as JS
from mpc_tpu.parallel import multi as jmulti
from mpc_tpu.planner import closed_loop as jcl
from mpc_tpu_torch import convert
from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.parallel import multi
from mpc_tpu_torch.planner import closed_loop as tcl

from asset_paths import CFG, SCN

CONFIG3 = 3                   # config_LF_ZAM_Tutorial-1_2_T-1.yaml
FRICTION_ROW = 0
MOVE = 1e-6                   # the move of x0 under which the dual moves
# lam_lo of the fused_ip_ks_ring kernel against the plain float32 solve on
# config 3's copies at this cold start, on an H100 (chip_smoke.py's fleet
# phase); the dual moves by more under MOVE
CARD_DEPARTURE = 0.1235
Z_MAX = 1e6                   # the IP duals' cap (ipqp._Z_MAX)


class _Recorded(Exception):
    pass


def _first_cold_start(cold_start, lcfg, params):
    """(cfg, ocp, state) that the loop's first warm-up solve is handed."""
    got = []

    def record(cfg, ocp, state):
        got.append((cfg, ocp, state))
        raise _Recorded
    with pytest.raises(_Recorded):
        cold_start(lcfg, params, record)
    return got[0]


def _np(x):
    return np.asarray(x, np.float64)


def _lane(tree, idx):
    return jax.tree_util.tree_map(lambda a: a[jnp.asarray(idx)], tree)


@pytest.fixture(scope="module")
def cold0():
    """Both packages' inputs of the fleet's first cold start; the plain
    version in float32 (its own rungs, and replaying the float64 solve's)
    and float64; the spec in float32 and, on the four lanes and config 3's
    lane with x0 moved by +-MOVE, in float64."""
    jl, jp, _ = jmulti.make_multi_scenario_batch(
        [jload(os.path.join(CFG, n), SCN) for n in cs.FLEET], noised=False)
    tl, tp, _ = multi.make_multi_scenario_batch(
        [load_config(os.path.join(CFG, n), SCN) for n in cs.FLEET],
        noised=False, device="cpu")
    jcfg, jocp, jst = _first_cold_start(jcl._batch_cold_start, jl, jp)
    cfg, ocp, st = _first_cold_start(tcl._batch_cold_start, tl, tp)
    out = dict(jcfg=jcfg, jocp=jocp, jst=jst, cfg=cfg, ocp=ocp, st=st)

    def sol(o, s, **kw):
        return TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, o, s, **kw), s.mu)
    ocp64, st64 = cs.as_float64(ocp, st)
    trace64, trace32 = [], []
    out["p64"] = sol(ocp64, st64, rungs=trace64)
    rungs64 = torch.stack([r for r, _ in trace64])
    out["p32"] = sol(ocp, st, rungs=trace32)
    out["rungs32"] = torch.stack([r for r, _ in trace32])
    out["p32_spec_rungs"] = sol(ocp, st, follow=rungs64)
    # the float64 merits of every rung at the float32 solve's choices
    out["merits64_at_rungs32"] = []
    sol(ocp64, st64, rungs=out["merits64_at_rungs32"],
        follow=out["rungs32"])
    out["j32"] = jax.tree_util.tree_map(_np, JS.solve_batch(jcfg, jocp, jst))
    with jax.enable_x64(True):
        def f64(a):
            return (a.astype(jnp.float64)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a)
        idx = [0, 1, 2, 3, CONFIG3, CONFIG3]
        p = jax.tree_util.tree_map(f64, _lane(jocp, idx))
        p = p._replace(x0=p.x0.at[4].add(MOVE).at[5].add(-MOVE))
        j64 = JS.solve_batch(jcfg, p, jax.tree_util.tree_map(
            f64, _lane(jst, idx)))
        j64 = jax.tree_util.tree_map(_np, j64)
    out["j64"] = jax.tree_util.tree_map(lambda a: a[:4], j64)
    out["j64_moved"] = jax.tree_util.tree_map(lambda a: a[4:], j64)
    return out


def _held(got, ref, lanes, unheld=None):
    """Per field, whether ``got`` (port) lies within the IP bands of ``ref``
    (JAX) on ``lanes``; ``unheld`` (stage, row) of lam_lo is left out."""
    def t(x):
        return x.double().numpy()[lanes]
    out = {f: bool(np.allclose(t(getattr(got, f)), getattr(ref, f)[lanes],
                               rtol=band[0], atol=band[1]))
           for f, band in cs.IP_BANDS.items()}
    out["status"] = bool(np.array_equal(t(got.status),
                                        getattr(ref, "status")[lanes]))
    for f, band in cs.IP_STATE_BANDS.items():
        a, b = t(getattr(got.state, f)), getattr(ref.state, f)[lanes].copy()
        if f == "lam_lo" and unheld is not None:
            b[..., unheld[0], unheld[1]] = a[..., unheld[0], unheld[1]]
        out[f] = bool(np.allclose(a, b, rtol=band[0], atol=band[1]))
    return out


def test_cold_start_inputs_equal_jax(cold0):
    """The port records what the JAX package's loop hands its first
    warm-up solve, at atol 0: the 5x10 budget with the ladder, the
    obstacle centres at -1e4, the dummy boundary lines of configs 1-3."""
    c = cold0
    assert c["cfg"] == convert.solver_config(c["jcfg"])
    assert (c["cfg"].ip_sqp_iters, c["cfg"].ip_iters) == (5, 10)
    assert c["cfg"].ip_alphas and c["cfg"].boundary_rows
    assert c["cfg"].horizon == 12 and c["ocp"].x0.shape[0] == 4
    for f in ("x0", "x_ref", "obs_centers", "min_dist", "boundaries",
              "boundary_signs"):
        np.testing.assert_array_equal(getattr(c["ocp"], f).numpy(),
                                      np.asarray(getattr(c["jocp"], f)),
                                      err_msg=f)
    assert float(c["ocp"].obs_centers.max()) == -1e4
    for f in ("U", "lam_lo", "lam_hi", "mu"):
        np.testing.assert_array_equal(getattr(c["st"], f).numpy(),
                                      np.asarray(getattr(c["jst"], f)))


@pytest.mark.parametrize("lane", range(len(cs.FLEET)),
                         ids=[n.split(".")[0] for n in cs.FLEET])
def test_plain_float64_is_the_spec(cold0, lane):
    """In float64 the plain version is the spec on every quantity of the
    lane, both duals on every stage and row included."""
    held = _held(cold0["p64"], cold0["j64"], [lane])
    assert all(held.values()), held
    for f in ("U", "X"):
        np.testing.assert_allclose(
            getattr(cold0["p64"], f)[lane].numpy(),
            getattr(cold0["j64"], f)[lane], rtol=0, atol=1e-5)


def test_plain_float32_holds_config3_but_its_degenerate_dual(cold0):
    """Config 3 in float32, replaying the float64 solve's rungs (the
    spec's own choices, test_plain_float64_is_the_spec): X, U, viol, cost,
    status and the stationarity in the IP bands of the spec's float32
    solve, lam_hi on every entry and lam_lo on every entry but the
    friction row's lower side at the terminal stage."""
    c = cold0
    unheld = (c["cfg"].horizon, FRICTION_ROW)
    held = _held(c["p32_spec_rungs"], c["j32"], [CONFIG3], unheld)
    assert all(held.values()), held
    whole = _held(c["p32_spec_rungs"], c["j32"], [CONFIG3])
    assert not whole["lam_lo"]   # that entry alone is out of its band


def test_float32_rungs_differ_by_ties(cold0):
    """The plain version's own float32 rungs on config 3 part from the
    float64 solve's only where the float64 merits of the two rungs tie:
    each choice within TIE_RTOL of the best, the gate the card holds the
    kernel's choices to."""
    c = cold0
    regret = torch.stack([cs.rung_regret(r, m) for r, m in
                          c["merits64_at_rungs32"]])
    assert float(regret[:, CONFIG3].max()) <= cs.TIE_RTOL
    assert c["p32"].status[CONFIG3] == c["p64"].status[CONFIG3]


def test_degenerate_dual_is_not_unique(cold0):
    """Config 3's friction row at the terminal stage: the row's value and
    gradient vanish there (a = 0, delta ~ 0); the spec moves the dual of
    its lower side by more than the card's departure under a move of
    MOVE in x0, while X and U stay within their bands; and the spec's
    own float32 and float64 solves part on it by more than its band."""
    c = cold0
    H, lo = c["cfg"].horizon, c["jcfg"]
    X = c["j64"].X[CONFIG3, H]
    w = X[3] ** 2 * np.tan(X[2]) / lo.wheelbase     # v * psidot
    grad = np.abs([2 * w * X[3] ** 2 * (1 + np.tan(X[2]) ** 2)
                   / lo.wheelbase, 4 * w * X[3] * np.tan(X[2])
                   / lo.wheelbase])
    assert w * w < 1e-6 and grad.max() < 1e-2, (w, grad)
    dual = c["j64"].state.lam_lo[CONFIG3, H, FRICTION_ROW]
    moved = c["j64_moved"].state.lam_lo[:, H, FRICTION_ROW]
    assert np.abs(moved - dual).max() >= CARD_DEPARTURE, (dual, moved)
    assert np.abs(moved - dual).max() > 0.5 * Z_MAX   # to or from the cap
    for f in ("X", "U"):
        ref = getattr(c["j64"], f)[CONFIG3]
        np.testing.assert_allclose(getattr(c["j64_moved"], f),
                                   np.broadcast_to(ref, (2,) + ref.shape),
                                   *cs.IP_BANDS[f], err_msg=f)
    j32 = c["j32"].state.lam_lo[CONFIG3, H, FRICTION_ROW]
    rtol, atol = cs.IP_STATE_BANDS["lam_lo"]
    assert abs(j32 - dual) > atol + rtol * abs(dual), (j32, dual)
