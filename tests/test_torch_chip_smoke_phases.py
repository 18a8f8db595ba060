"""The CPU rehearsal of ``chip_smoke.py``'s planner, fleet and sharded
phases: the golden and C2 pieces, the forcespro fleet and its cold
starts' gate, the online planners and the casadi pair, the one-rank loop,
two gloo ranks, the dry run, scan against pscan, the entry's NCCL rank
(gloo here) and a failing rank."""
import types

import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI


@pytest.fixture
def planner_rehearsal(monkeypatch):
    """The planner phase's pieces on the CPU: the device clocks stubbed,
    the lines collected."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn: (1.0, fn()))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    return lines


def test_planner_golden_rehearsal(planner_rehearsal):
    """The golden piece: the IP golden's float64 loop on the device asked
    for, within its atol, with no kernel launched."""
    config, tag = cs.PLANNER_GOLDENS[1]
    line = cs.planner_golden(torch.device("cpu"), config, tag)
    assert line["max_abs_dX"] < cs.GOLDEN_ATOL and not line["kernel_launches"]
    assert planner_rehearsal == [line]


def test_planner_c2_rehearsal(planner_rehearsal, monkeypatch):
    """C2's pieces at small shapes: the IP wrapper past its envelope and
    the xla IP loop take the per-lane path, launch nothing and agree with
    the CPU (here, themselves); a route that launched a kernel fails."""
    dev = torch.device("cpu")
    line = cs.planner_c2_solve(dev, horizon=64, lanes=2)
    assert line["lanes_outside_bands"] == 0 and line["dtype"] == "float64"
    assert "H <= 63" in line["reason"]
    loop = cs.planner_c2_loop(dev, "NVIDIA H100 80GB HBM3, 700.00 W",
                              lanes=2, steps=2)
    assert loop["feasible_steps"] == loop["feasible_steps_cpu"] == 4
    assert loop["rounding_lanes"] == 0 and not loop["kernel_launches"]
    monkeypatch.setattr(cs, "launch_counts", lambda: {"fused_ip": 1})
    with pytest.raises(cs.CheckFailed, match="launched kernels"):
        cs.planner_c2_solve(dev, horizon=64, lanes=2)


def plain_as_kernel(cfg, ocp, state):
    """``chip_smoke.kernel_solve`` on the CPU: the plain version stands in
    for the kernel, committing the rungs of its own float64 solve."""
    eng = cs.engine(cfg)
    if not eng.ladder(cfg):
        return eng.solution(cfg, eng.plain(cfg, ocp, state), state), None
    trace = []
    eng.plain(cfg, *cs.as_float64(ocp, state), trace)
    rungs = torch.stack([r for r, _ in trace])
    return (eng.solution(cfg, eng.plain(cfg, ocp, state, follow=rungs),
                         state), rungs)


@pytest.fixture
def fleet_rehearsal(planner_rehearsal, monkeypatch):
    """The fleet phase's pieces on the CPU: each fused wrapper's call
    counted as a launch of the kernel ``chip_smoke.engine`` names (on the
    CPU the wrappers run the plain version, which launches nothing), the
    kernel of the cold starts' gates the plain version
    (:func:`plain_as_kernel`), the loop's kernel checks, the profile and
    the kernel's geometry recorded instead of run."""
    for mod, fn in ((TFI, "solve_batch_fused_ip"),
                    (TF, "solve_batch_fused")):
        def counting(cfg, params, state, device=None,
                     _real=getattr(mod, fn)):
            cs._launchers()[cs.engine(cfg).name].launches += 1
            return _real(cfg, params, state, device=device)
        monkeypatch.setattr(mod, fn, counting)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(TF, "geometry", lambda cfg, B: {"lanes": B})
    seen = {"compare": [], "calibration": []}

    def compare(name, cfg, ocp, state):
        seen["compare"].append((name, cfg, ocp))
        return None, {"X": 0.0, "U": 0.0}

    def calibration(name, cfg, ocp, state, kernel=False, groups=1,
                    _real=cs.gate_calibration):
        assert kernel and groups == len(cs.FLEET)
        seen["calibration"].append((name, cfg, ocp))
        return _real(name, cfg, ocp, state, kernel, groups)

    def profile(dev, row, lcfg, lp, start, window):
        seen["profile"] = (row, start, window)
        return {"window_steps": "", "device_busy_ms": 1.0, "kernel_ms": 0.5,
                "kernel_launches_seen": window, "copy_kernels_ms": 0.0,
                "linearize_boundaries_kernels_ms": 0.2,
                "device_launches": 1}
    monkeypatch.setattr(cs, "compare", compare)
    monkeypatch.setattr(cs, "gate_calibration", calibration)
    monkeypatch.setattr(cs, "kernel_solve", plain_as_kernel)
    monkeypatch.setattr(cs, "phase_profile", profile)
    return seen


def test_fleet_forcespro_rehearsal(fleet_rehearsal, planner_rehearsal):
    """(a) and (b) at B=8, T=2: the step-0 solve of the three configs other
    than the deployment and the loop's solve at step 1 on all four held to
    the plain version, the cold starts and step 0 calibrated a config
    each; a launch a solve, the infeasible step of the deployment config's
    copies held to the plain loop, the copies in agreement and the serving
    chain equal to the loop."""
    line = cs.fleet_forcespro(torch.device("cpu"), lanes=8, check_lanes=4,
                              steps=2, check_step=1)
    assert line["launches_by_kernel"]["fused_ip_ks_ring"] == 4
    assert line["serving"]["launches_by_kernel"]["fused_ip_ks_ring"] == 4
    assert line["copies_agreement"] == [1.0] * 4
    assert line["infeasible_lanes_by_config"] == [2, 0, 0, 0]
    held = fleet_rehearsal["compare"]
    assert [name for name, _, _ in held] == ["fleet_step0", "fleet_step1"]
    assert sorted(line["check_max_abs_err"]) == ["cold0", "cold1", "step0",
                                                 "step1"]
    name, cfg, ocp = held[0]   # lanes 1, 2, 3, 5: dummy rows only
    assert ocp.x0.shape[0] == 4 and cfg.ip_sqp_iters == 2
    assert float(ocp.boundaries[..., 1].abs().min()) > 1e5
    name, cfg, ocp = held[1]
    assert line["check_step"] == 1 and cfg.ip_sqp_iters == 2
    assert ocp.x0.shape[0] == 4 and ocp.obs_centers.dim() == 4
    assert float(ocp.boundaries[1:, ..., 1].abs().min()) > 1e5
    assert float(ocp.boundaries[0, ..., 1].abs().max()) < 1e3
    calibrated = fleet_rehearsal["calibration"]
    assert [name for name, _, _ in calibrated] == [
        "fleet_cold0_by_config", "fleet_cold1_by_config",
        "fleet_step0_by_config"]
    for name, cfg, ocp in calibrated:   # lanes 0-3: a copy of each config
        assert ocp.x0.shape[0] == 4, name
        assert float(ocp.boundaries[0, ..., 1].abs().max()) < 1e3, name
    assert [(c.ip_sqp_iters, c.ip_iters) for _, c, _ in calibrated] == [
        (5, 10), (5, 10), (2, 6)]
    assert fleet_rehearsal["profile"] == ("fleet", cs.GATE_STEP, 10)
    # each cold start held config by config: the configs on which the
    # plain version agrees with itself, the others named with their share
    lines = {l["case"]: l for l in planner_rehearsal if "case" in l}
    for i in (0, 1):
        cal = lines[f"fleet_cold{i}_by_config"][
            "plain_float32_vs_float64_lane_agreement"]
        check = lines[f"fleet_cold{i}"]
        held = check["configs_held"]
        assert held and line["cold_start_configs_held"][f"cold{i}"] == held
        out = check["configs_left_out"]
        assert sorted(held + [int(g) for g in out]) == [0, 1, 2, 3]
        for g in range(4):
            shares = [v[g] for v in cal.values()]
            assert (min(shares) >= 1 - cs.MAX_ROUNDING_SHARE) == (g in held)
        for g, why in out.items():
            assert why["plain_float32_vs_float64_lanes_parted"] > \
                cs.MAX_ROUNDING_SHARE
        assert check["lanes"] == len(held)
        assert set(check["lane_agreement"]) >= {"lam_lo", "lam_hi", "U"}


def _departing_kernel(config, entry, by=1.0):
    """:func:`plain_as_kernel` with lam_lo doubled and moved by ``by`` on
    the copies of ``config`` (lane % 4) at ``entry`` (stage, row), or
    everywhere."""
    def solve(cfg, ocp, state):
        ker, rungs = plain_as_kernel(cfg, ocp, state)
        lam = ker.state.lam_lo.clone()
        lanes = torch.arange(len(lam)) % len(cs.FLEET) == config
        if entry is None:
            lam[lanes] = 2 * lam[lanes] + by
        else:
            lam[lanes, entry[0], entry[1]] = \
                2 * lam[lanes, entry[0], entry[1]] + by
        return ker._replace(state=ker.state._replace(lam_lo=lam)), rungs
    return solve


@pytest.fixture
def fleet_cold0(fleet_rehearsal):
    """The fleet's first cold-start inputs on one copy of each config."""
    lcfg, lp, _, _ = cs.fleet_batch(torch.device("cpu"), cs.FLEET, 4, 2)
    return cs.cold_start_inputs(lcfg, lp)[0]


def test_fleet_cold_start_departure_fails_the_phase(fleet_cold0,
                                                    monkeypatch,
                                                    planner_rehearsal):
    """A kernel whose lam_lo departs on a held config's copies fails the
    cold start's gate; at FLEET_UNHELD's entry alone it passes, that
    entry's departure reported."""
    cfg, ocp, state = fleet_cold0
    monkeypatch.setattr(cs, "kernel_solve", _departing_kernel(1, None))
    with pytest.raises(cs.CheckFailed, match="lam_lo"):
        cs.hold_by_config("fleet_cold0", cfg, ocp, state, 4)
    (g, (dual, *entry)), = cs.FLEET_UNHELD[0].items()
    monkeypatch.setattr(cs, "kernel_solve", _departing_kernel(g, entry))
    errs, held = cs.hold_by_config("fleet_cold0", cfg, ocp, state, 4,
                                   cs.FLEET_UNHELD[0])
    assert g in held and errs[dual] < cs.IP_STATE_BANDS[dual][1]
    unheld = planner_rehearsal[-1]["unheld"][dual]
    assert (unheld["entries_a_lane"], unheld["lanes"]) == (1, 1)
    assert unheld["max_abs_err"] > cs.IP_STATE_BANDS[dual][1]
    with pytest.raises(cs.CheckFailed, match=dual):
        cs.hold_by_config("fleet_cold0", cfg, ocp, state, 4)


def test_fleet_online_and_lf_rehearsal(fleet_rehearsal):
    """(c), (d) and (e) cut short: the disturbed fleet against itself on
    the CPU, the casadi pair within its goldens, the online planner with
    no launch."""
    dev = torch.device("cpu")
    online = cs.fleet_online(dev, steps=2)
    assert online["launches_by_kernel"]["fused_ip_ks_ring"] == 4
    assert online["max_abs_err_X_vs_plain"] == 0.0
    lf = cs.fleet_lf_pair(dev, lanes=4, steps=3)
    assert lf["launches_by_kernel"]["fused_gn"] == 3
    assert lf["step_ms"] == pytest.approx(1.0 / 3)   # the stubbed clock
    assert lf["geometry"] == {"lanes": 4}
    assert max(lf["max_abs_err_xy_vs_golden"].values()) < cs.GOLDEN_BAND
    latency = cs.fleet_latency(dev, steps=1)
    assert not any(latency["launches_by_kernel"].values())


@pytest.fixture
def sharded_rehearsal(fleet_rehearsal, monkeypatch):
    """The sharded phase's pieces on the CPU: the fleet rehearsal's stubs,
    one geometry for every batch (the fused kernels' instance then does
    not depend on B, so the ranks are held at atol 0)."""
    one = {"threads_per_lane": 4, "lanes_per_block": 12}
    monkeypatch.setattr(TF, "geometry", lambda cfg, B: one)
    monkeypatch.setattr(TFI, "geometry", lambda cfg, B: one)


def test_sharded_phase_rehearsal(sharded_rehearsal, planner_rehearsal):
    """(a) to (d) at B=4, T=2 and H=6: the one-rank loop equal to
    ``closed_loop_batch_vec``, two gloo ranks spawned (the CPU standing in
    for their ``cuda:0``) launching fused_gn and fused_ip and equal at
    atol 0, the dry run's line (its engine-sharded loop on fused_gn, its
    IP solve on the per-lane path), scan against pscan; its line's names
    and budgets, and the kernels line's ``sharded_launches``."""
    from tests import torch_ranks
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    line = cs.phase_sharded(torch.device("cpu"), card, lanes=4, steps=2,
                            horizons=(6,), rank_device="cpu",
                            hook=torch_ranks.ranks_on_cpu)
    assert planner_rehearsal[-1] is line and line["phase"] == "sharded"
    assert sorted(line["seconds"]) == ["entry_one_rank", "one_rank",
                                       "pscan_timing", "two_ranks"]
    # (e): one rank spawned as a launcher starts it, entry's default path
    # asking for NCCL (served by gloo here), equal to the one-process run:
    # entry's results, and the dry run's outcome, here its open-loop IP
    # step's failed every-lane assertion (tests/test_torch_entry_world_one)
    entry = line["entry_one_rank"]
    assert entry["hook"]["requested_backends"] == ["nccl"]
    assert (entry["backend"], entry["group_size"], entry["device"],
            entry["mesh_device_type"]) == ("gloo", 1, "cpu", "cpu")
    assert all(entry["equal_atol0"].values())
    assert entry["dryrun_outcome"] == f"AssertionError: {cs.ENTRY_C4}"
    ops = entry["collectives_by_op"]
    assert set(ops) == {"all_reduce_sum", "all_reduce_max", "all_gather"}
    assert min(op["bytes"] for op in ops.values()) > 0
    one = line["one_rank"]
    assert one["mesh"] == {"dp": 1, "sp": 1} and one["collectives"] == []
    # four cold starts and two steps, a launch each
    assert one["kernel"] == "fused_gn" and one["launches"]["fused_gn"] == 6
    assert one["equal_atol0"] == ["X", "U", "status"]
    two = line["two_ranks"]
    assert two["applied"] == {"fused_gn": "atol 0", "fused_ip": "atol 0"}
    for r, rank in enumerate(two["ranks"]):
        assert (rank["rank"], rank["backend"], rank["device"]) == (
            r, "gloo", "cpu")
        assert rank["mesh"] == {"dp": 2, "sp": 1}
        assert rank["soft"]["lanes_per_rank"] == 2
        assert all(rank["soft"]["equal"].values())
        assert all(rank["hard"]["equal"].values())
        assert {c["op"] for c in rank["soft"]["collectives"]} == {
            "all_gather"}
        assert rank["dryrun"]["collective_backends"] == ["gloo"]
        assert "all_gather" in rank["dryrun"]["collective_ops"]
    assert line["dryrun_line"].startswith("dryrun_multichip(2): ok")
    assert "sp (pscan sharded)" in line["dryrun_line"]
    row, = line["pscan_timing"]["rows"]
    assert (row["horizon"], row["batch"], row["budget"]) == (6, 4, "al 1x1")
    assert row["scan"]["ms"] == row["pscan"]["ms"] == 1.0  # stubbed clock
    assert row["lanes_within_band"] == 1.0
    assert line["power_limit"] == "700.00 W"
    gn = cs.sharded_launches(line, "fused_gn")
    assert gn["one_rank"] == 6 and gn["soft"] == [6, 6]
    assert gn["hard"] == [0, 0] and min(gn["dryrun"]) > 0
    assert gn["entry"] > 0
    ip = cs.sharded_launches(line, "fused_ip")
    assert ip["hard"] == [1, 1] and ip["dryrun"] == [0, 0]
    assert ip["entry"] == 1   # the dry run's open-loop IP step, no sp axis
    assert cs.sharded_launches(line, "riccati")["soft"] == [0, 0]


def test_a_failing_rank_fails_the_sharded_phase(sharded_rehearsal):
    """A rank that raises stops the others and fails the phase."""
    from tests import torch_ranks
    lcfg, _, hard = cs.sharded_rows(torch.device("cpu"), 2, 1)
    done = types.SimpleNamespace(X=torch.zeros(2, 1, 5),
                                 U=torch.zeros(2, 1, 2),
                                 status=torch.zeros(2, 1))
    with pytest.raises(cs.CheckFailed, match="a sharded rank failed"):
        cs.sharded_two_ranks(torch.device("cpu"), lcfg, done, hard, done,
                             rank_device="cpu",
                             hook=torch_ranks.fail_on_rank_one)
