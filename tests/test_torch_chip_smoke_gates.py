"""The CPU evidence behind two of ``chip_smoke.py``'s gates: the ladder's
rung gate (``TIE_RTOL``) and the bench track of the loop phases."""
import dataclasses

import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.utils import synthetic as tsyn
from tests.test_torch_chip_smoke import H


def _f64(t):
    return t.double() if t.is_floating_point() else t


@pytest.mark.parametrize("mode,al_iters,sqp_iters,step", [
    ("forcespro", 3, 4, 0), ("casadi", 2, 2, 1)])
def test_rung_gate_passes_rounding_and_catches_a_stuck_ladder(
        mode, al_iters, sqp_iters, step):
    """The plain version's float32 rung choices, replayed in float64 at the
    bench shape, lose at most TIE_RTOL of the best merit, and the two solves
    then agree within the check's bands on every lane.  A ladder stuck at
    alpha = 0 loses far more."""
    B = 16
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, H, B, mode=mode,
                                    device="cpu", al_iters=al_iters,
                                    sqp_iters=sqp_iters)
    cfg = lcfg.solver
    ocp = cs.ocp_at(lcfg, lp, step)
    st = TS.init_state(cfg, batch=B)
    r32, r64 = [], []
    o32 = TF.to_solution(cfg, TF.solve_batch_fused_plain(cfg, ocp, st, r32))
    follow = torch.stack([r for r, _ in r32])
    ocp64 = ocp._replace(x0=_f64(ocp.x0), x_ref=_f64(ocp.x_ref),
                         obs_centers=_f64(ocp.obs_centers),
                         min_dist=_f64(ocp.min_dist),
                         weights=ocp.weights.map(_f64))
    o64 = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp64, st.map(_f64), r64, follow=follow))
    regret = max(float(cs.rung_regret(c, m).max())
                 for c, (_, m) in zip(follow, r64))
    print(f"{mode}: float32 rungs under float64 merits, regret {regret:.3g}")
    assert regret <= cs.TIE_RTOL
    for f, (rtol, atol) in cs.BANDS.items():
        assert bool(cs.lanes_close(getattr(o32, f), getattr(o64, f).float(),
                                   rtol, atol).all()), f
    assert torch.equal(o32.status, o64.status)
    stuck = []
    TF.solve_batch_fused_plain(cfg, ocp, st, stuck,
                               follow=torch.zeros_like(follow))
    stuck_regret = max(float(cs.rung_regret(torch.zeros_like(c), m).max())
                       for c, (_, m) in zip(follow, stuck))
    assert stuck_regret > 100 * cs.TIE_RTOL


def test_loop_phases_use_a_track_where_rounding_does_not_part_lanes():
    """On the 10-step bench track the obstacle lies within a horizon of the
    start: the plain loop has infeasible steps there, and in float32 and in
    float64 it parts by far more than the loop check's bands.  On the
    bench's 100-step track, which chip_smoke.py uses, every step is
    feasible and float32 and float64 agree within those bands for the first
    10 steps."""
    B, T = 16, 10
    errs = {}
    for track_steps in (10, cs.T_BENCH):
        lcfg, lp = tsyn.make_bench_loop(track_steps, H, B, device="cpu",
                                        **cs.WARM)
        lcfg = dataclasses.replace(lcfg, n_steps=T)
        r32 = tcl.closed_loop_batch_vec(lcfg, lp, device="cpu")
        r64 = tcl.closed_loop_batch_vec(lcfg, lp.map(_f64), device="cpu")
        errs[track_steps] = (
            float((r32.X.double() - r64.X).abs().max()),
            float((r32.U.double() - r64.U).abs().max()),
            bool(torch.equal(r32.status >= 0, r64.status >= 0)),
            int((r32.status < 0).sum()))
        print(f"track of {track_steps} steps: float32 vs float64 X "
              f"{errs[track_steps][0]:.3g} U {errs[track_steps][1]:.3g} "
              f"equal feasibility {errs[track_steps][2]}, "
              f"{errs[track_steps][3]} of {B * T} float32 steps infeasible")
    short, bench = errs[10], errs[cs.T_BENCH]
    assert short[3] > 0
    assert short[0] > 5e-2 or short[1] > 5e-3 or not short[2]
    assert bench == (pytest.approx(0.0, abs=5e-2),
                     pytest.approx(0.0, abs=5e-3), True, 0)
