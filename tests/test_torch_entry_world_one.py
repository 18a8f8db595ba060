"""``mpc_tpu_torch.entry``'s path at world size 1 on the CPU, as
``chip_smoke.py``'s entry piece runs it in one NCCL rank on the card.

At world size 1 ``dryrun_multichip`` has no stage axis, so its open-loop
IP step (the flagship OCP, forcespro, 8x12) runs on the fused IP engine:
the CUDA kernel on the card, its plain version here.  That engine, as the
JAX package's Pallas kernel, forms a row's linearized margin as
hi - (h + J d): near an active bound the sum rounds to the spacing of
floats at h, and once the slack falls below it the dual reads the
rounding.  Lane 0 of the two drives its steering rate onto its bound, and
in float32 its stationarity stays above the status's threshold, so the
dry run's every-lane-converges assertion fails; float64, and the per-lane
path, converge both lanes (ROADMAP queue C).  On the JAX package's own
flagship OCP its interpret-mode Pallas kernel does the same: lane 0 at
status 0 with the port's dual, where its executable spec
``sqp.solve_batch(method='ip')`` converges.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke as cs
from mpc_tpu.ops import fused_ip as JFI
from mpc_tpu.ops import sqp as JS
from mpc_tpu.utils import synthetic as jsynthetic
from mpc_tpu_torch import convert, entry
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.utils import synthetic

H, LANES = 15, 2          # dryrun_multichip(1): 2 lanes, H=15
STEER_RATE_ROW = 10       # the box row on u[0]


@pytest.fixture(scope="module")
def ip_step():
    """The dry run's open-loop IP step on the CPU: (cfg, ocp, state)."""
    lcfg, _ = synthetic.make_bench_loop(n_steps=6, horizon=H,
                                        n_lanes=LANES, device="cpu",
                                        sqp_iters=2, al_iters=2)
    cfg = dataclasses.replace(lcfg.solver, formulation="forcespro",
                              method="ip", ip_sqp_iters=8, ip_iters=12)
    ocp, state = entry._flagship_ocp(H, LANES, device="cpu")
    return cfg, ocp, state


def test_engine_leaves_lane_0_unconverged_in_float32(ip_step):
    """The engine in float32: lane 0 at its steering-rate bound on stages
    0 and 1, status 0, its stationarity above ``tol_stat_ip`` and the
    bound's dual at stage 0 far above the float64 solve's; in float64 both
    lanes converge, and so does the per-lane path in float32."""
    cfg, ocp, state = ip_step
    f32 = TFI.solve_batch_fused_ip(cfg, ocp, state, device="cpu")
    ocp64, st64 = cs.as_float64(ocp, state)
    f64 = TFI.solve_batch_fused_ip(cfg, ocp64, st64, device="cpu")
    lane = TS.solve_batch(cfg, ocp, state, device="cpu")
    assert f32.status.tolist() == [0, 1]
    assert float(f32.kkt_stat[0]) > cfg.tol_stat_ip
    assert f64.status.tolist() == [1, 1] == lane.status.tolist()
    torch.testing.assert_close(f32.U[0, :2, 0], torch.full((2,), 0.4),
                               rtol=0, atol=1e-6)
    dual32 = float(f32.state.lam_hi[0, 0, STEER_RATE_ROW])
    dual64 = float(f64.state.lam_hi[0, 0, STEER_RATE_ROW])
    assert dual32 > 2 * dual64 > 2.0, (dual32, dual64)


@pytest.fixture(scope="module")
def jax_ip_step():
    """The same step on the JAX package's flagship OCP: its interpret-mode
    Pallas kernel, its spec and the port's plain version (float32 and
    float64) on the converted inputs, as float64 numpy."""
    lcfg, _ = jsynthetic.make_bench_loop(n_steps=6, horizon=H,
                                         n_lanes=LANES, sqp_iters=2,
                                         al_iters=2)
    jcfg = dataclasses.replace(lcfg.solver, formulation="forcespro",
                               method="ip", ip_sqp_iters=8, ip_iters=12)
    jocp, jst = ge._flagship_ocp(horizon=H, n_lanes=LANES)
    cfg = convert.solver_config(jcfg)
    ocp, st = convert.ocp_params(jocp, "cpu"), convert.sqp_state(jst, "cpu")
    ocp64, st64 = cs.as_float64(ocp, st)
    sols = {"kernel": JFI.solve_batch_fused_ip(jcfg, jocp, jst,
                                               interpret=True),
            "spec": JS.solve_batch(jcfg, jocp, jst),
            "port": TFI.solve_batch_fused_ip(cfg, ocp, st, device="cpu"),
            "port64": TFI.solve_batch_fused_ip(cfg, ocp64, st64,
                                               device="cpu")}

    def np64(sol):
        out = {f: np.asarray(getattr(sol, f), np.float64)
               for f in ("U", "X", "viol", "cost", "kkt_stat", "status")}
        out.update({f: np.asarray(getattr(sol.state, f), np.float64)
                    for f in ("lam_lo", "lam_hi")})
        return out
    return cfg, {k: np64(v) for k, v in sols.items()}


def test_jax_kernel_leaves_lane_0_unconverged_as_the_port(jax_ip_step):
    """On the JAX package's flagship OCP: its Pallas kernel (interpret
    mode) and the port's plain version agree within the IP bands on U, X,
    viol, cost and both duals of both lanes, and on lane 0's status (0)
    and stationarity (above ``tol_stat_ip``), its steering-rate bound's
    dual at stage 0 far above the exact one.  The spec and the float64
    plain version converge both lanes at the exact dual.  On lane 1 both
    float32 engines put that dual above the exact one too, the kernel's
    stationarity below the threshold and the port's above it (the status
    is not held there), so the dry run's contract fails on the reference's
    kernel as on the port's."""
    cfg, s = jax_ip_step
    kern, spec, port, port64 = (s[k] for k in ("kernel", "spec", "port",
                                               "port64"))
    assert kern["status"][0] == port["status"][0] == 0
    assert spec["status"].tolist() == port64["status"].tolist() == [1, 1]
    assert kern["kkt_stat"][0] > cfg.tol_stat_ip
    for f in ("U", "X", "viol", "cost"):
        rtol, atol = cs.IP_BANDS[f]
        np.testing.assert_allclose(port[f], kern[f], rtol=rtol, atol=atol,
                                   err_msg=f)
    rtol, atol = cs.IP_BANDS["kkt_stat"]
    np.testing.assert_allclose(port["kkt_stat"][0], kern["kkt_stat"][0],
                               rtol=rtol, atol=atol)
    rtol, atol = cs.IP_STATE_BANDS["lam_lo"]
    np.testing.assert_allclose(port["lam_lo"], kern["lam_lo"], rtol=rtol,
                               atol=atol)
    rtol, atol = cs.IP_STATE_BANDS["lam_hi"]
    np.testing.assert_allclose(port["lam_hi"], kern["lam_hi"], rtol=rtol,
                               atol=atol)
    exact = spec["lam_hi"][:, 0, STEER_RATE_ROW]
    np.testing.assert_allclose(port64["lam_hi"][:, 0, STEER_RATE_ROW],
                               exact, rtol=rtol, atol=atol)
    for got in (kern, port):
        excess = got["lam_hi"][:, 0, STEER_RATE_ROW] - exact
        assert excess[0] > atol + rtol * exact[0] and excess[1] > atol, \
            excess


def test_entry_path_at_world_size_one():
    """``chip_smoke.entry_path`` in one process: no process group,
    ``entry()``'s U of 32 lanes, and the dry run's outcome the failed
    every-lane assertion of its open-loop IP step, lane 0 at status 0."""
    (U, status), outcome = cs.entry_path("cpu")
    assert not torch.distributed.is_initialized()
    assert tuple(U.shape) == (32, 30, 2) and status.shape == (32,)
    assert outcome == f"AssertionError: {cs.ENTRY_C4}"
    assert cs.ENTRY_C4 == (f"1/{LANES} converged open-loop solves; "
                           "status by lane [0, 1]")


def _stub_entry(monkeypatch, failure):
    """``entry.entry`` a two-lane stand-in and the dry run raising
    ``failure``."""
    def fake_entry(device=None):
        return (lambda: (torch.zeros(2, 3, 2), torch.ones(2))), ()

    def fake_dryrun(n_devices, device=None):
        raise failure
    monkeypatch.setattr(entry, "entry", fake_entry)
    monkeypatch.setattr(entry, "dryrun_multichip", fake_dryrun)


@pytest.mark.parametrize("message", [
    "0/2 converged open-loop solves; status by lane [0, 0]",
    "1/2 converged open-loop solves; status by lane [1, 0]",
    "1 infeasible (lane, step) solves",
    "sharded != unsharded closed loop (max dX 0.1)"])
def test_entry_path_raises_any_other_dry_run_failure(monkeypatch, message):
    """Only ENTRY_C4's failure becomes the entry piece's outcome; any other
    failure of the dry run fails the piece."""
    _stub_entry(monkeypatch, AssertionError(message))
    with pytest.raises(AssertionError, match=re.escape(message)):
        cs.entry_path("cpu")
    _stub_entry(monkeypatch, AssertionError(cs.ENTRY_C4))
    (U, status), outcome = cs.entry_path("cpu")
    assert outcome == f"AssertionError: {cs.ENTRY_C4}"
    assert tuple(U.shape) == (2, 3, 2)


def test_main_raises_the_dry_runs_failure(monkeypatch, capsys):
    """``entry.main`` prints entry's line, then raises the dry run's
    failure (the launcher's exit code 1)."""
    _stub_entry(monkeypatch, AssertionError(cs.ENTRY_C4))
    with pytest.raises(AssertionError, match="status by lane"):
        entry.main(["--device", "cpu"])
    assert "entry: ran, U shape (2, 3, 2)" in capsys.readouterr().out
