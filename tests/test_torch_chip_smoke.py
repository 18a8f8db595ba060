"""The choices ``chip_smoke.py`` makes on the card, checked on the CPU.
The tolerance of its ladder-rung gate and the track its loop phases run
on are ``tests/test_torch_chip_smoke_gates.py``; the rehearsals of its
planner, fleet and sharded phases
``tests/test_torch_chip_smoke_phases.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.models.vehicle import VEHICLE_2
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.planner import closed_loop as tcl
from mpc_tpu_torch.utils import synthetic as tsyn

H = 30


def test_rung_regret_follows_the_ladder_rule():
    """Regret against the first rung of least merit; a NaN trial never
    wins, and a NaN merit at alpha = 0 keeps the iterate."""
    nan = float("nan")
    m = torch.tensor([[1.0, nan, 2.0], [0.5, 2.0, 1.0], [0.5, 3.0, 4.0]])
    assert cs.rung_regret(torch.tensor([2, 0, 1]), m).tolist() == [0, 0, 0]
    reg = cs.rung_regret(torch.tensor([0, 1, 2]), m)
    assert reg[0] == pytest.approx(0.5) and reg[1] == float("inf")
    assert reg[2] == pytest.approx(3.0)


def _ocp64(ocp, st):
    return cs.as_float64(ocp, st)


def test_ip_stationarity_band_sits_above_float32_rounding():
    """At the converged cold-start iterate of the IP bench check the
    stationarity is float32 rounding: the plain version in float32 and in
    float64 part by more than tests/test_fused_ip.py's atol (5e-3) on some
    lanes, and by well under KKT_ATOL on every lane.  Every other band of
    the check holds on every lane, and the status is equal."""
    B = 48
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, H, B, device="cpu",
                                    **cs.IP_COLD)
    cfg = lcfg.solver
    ocp = cs.ocp_at(lcfg, lp)
    st = TS.init_state(cfg, batch=B)
    o32 = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(cfg, ocp,
                                                                 st), st.mu)
    ocp64, st64 = _ocp64(ocp, st)
    o64 = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp64, st64), st64.mu)
    gap = (o32.kkt_stat.double() - o64.kkt_stat).abs()
    print(f"stationarity float32 vs float64: max {float(gap.max()):.3g}, "
          f"{int((gap > 5e-3).sum())} of {B} lanes above 5e-3")
    assert float(gap.max()) > 5e-3
    assert float(gap.max()) < cs.KKT_ATOL / 2
    for f, (rtol, atol) in cs.IP_BANDS.items():
        assert bool(cs.lanes_close(getattr(o32, f).double(), getattr(o64, f),
                                   rtol, atol).all()), f
    assert torch.equal(o32.status, o64.status)


def test_rounding_lanes_are_the_ill_conditioned_ones():
    """Two lanes of the IP ladder check (lanes 283 and 1709 of its 2048)
    solve a QP so ill-conditioned that the plain version's float32 and
    float64 solves, committing the same rungs, leave the U band; the check
    excuses exactly those, decided without the kernel."""
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, H, cs.B_CHECK, device="cpu",
                                    **cs.IP_COLD)
    lp = lp.map(lambda t: t[torch.tensor([283, 1709, 0, 1])])
    cfg = dataclasses.replace(lcfg.solver, ip_sqp_iters=2, ip_iters=6,
                              ip_warm_duals=True,
                              ip_alphas=TS.SolverConfig(horizon=H).ip_alphas)
    ocp = cs.ocp_at(lcfg, lp)
    st = TS.init_state(cfg, batch=4)
    rungs = []
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, rungs), st.mu)
    follow = torch.stack([r for r, _ in rungs])
    eng = cs.engine(cfg)
    inband = {f: torch.tensor([True, True, True, True]) for f in cs.IP_BANDS}
    assert not any(v.any() for v in cs.rounding_lanes(
        eng, cfg, ocp, st, pln, inband, follow).values())
    inband["U"] = torch.tensor([False, True, True, True])
    noisy = cs.rounding_lanes(eng, cfg, ocp, st, pln, inband, follow)
    assert noisy["U"].tolist() == [True, True, False, False]


def test_unported_kernel_bound_from_its_shapes():
    """The Riccati sweep (B4, the last TPU kernel to be ported) moves 98
    floats a lane and stage (86 read, 12 written) and 32 a lane, and at the
    bench horizon it is bound by those bytes; its operations are counted on
    the plain version."""
    from mpc_tpu_torch.ops import riccati_kernel as TRK
    B = 64
    bufs = TRK.pack(*cs.random_lqr(np.random.default_rng(0), B, H))
    line = cs.riccati_bound(bufs)
    assert line["bytes"] == 4 * B * (H * 98 + 32)
    assert line["bound_by"] == "bytes"
    assert line["bound_ms"] == pytest.approx(line["bytes"] / 3.35e9)
    # ~1,000 fp32 operations a lane and stage: the 5x5 products
    assert 500 < line["fp32_ops"] / (B * H) < 2000


@pytest.mark.parametrize("kw,kernel,launches", [
    (cs.WARM, "fused_gn", 104), (cs.IP_WARM, "fused_ip", 104),
    (cs.XLA_WARM, "riccati", 48 + cs.XLA_STEPS),
    (cs.SOFT_ST, "fused_gn_st", 104),
    (cs.HARD_ST, "fused_ip_st", 104),
    (cs.XLA_ST, "riccati", 12 + cs.XLA_ST_STEPS)],
    ids=["soft", "hard", "xla", "soft-st", "hard-st", "xla-st"])
def test_each_row_launches_its_kernel_as_often_as_it_solves(kw, kernel,
                                                            launches):
    """One fused launch per cold start and step (the ST library's for the
    ST rows); one sweep per Gauss-Newton step on the xla engine: 4 cold
    starts at 3x4 and XLA_STEPS steps at 1x1 (XLA_ST_STEPS in the xla-st
    row, after one cold start)."""
    lcfg, _ = cs.bench_loop(n_lanes=2, device="cpu", **kw)
    if kw is cs.XLA_WARM:
        lcfg = dataclasses.replace(lcfg, n_steps=cs.XLA_STEPS)
    if kw is cs.XLA_ST:
        lcfg = dataclasses.replace(lcfg, n_steps=cs.XLA_ST_STEPS)
    assert cs.row_kernel(lcfg) == (kernel, launches)


def test_st_rows_name_their_libraries_and_kernels():
    """The ST rows' engines are the ST libraries (fused_gn_st.cu,
    fused_ip_st.cu), timed at their own threads a lane (4, 8); the
    profiler tells their kernels (StModel in the symbol) from the KS
    ones."""
    lcfg, _ = cs.bench_loop(n_lanes=2, device="cpu", **cs.SOFT_ST)
    eng = cs.engine(lcfg.solver)
    assert eng.name == "fused_gn_st" and "814-822" in eng.replaces
    assert eng.sweep(lcfg.solver) == (0, 4, 8)
    lcfg, _ = cs.bench_loop(n_lanes=2, device="cpu", **cs.HARD_ST)
    assert cs.engine(lcfg.solver).name == "fused_ip_st"
    assert lcfg.solver.vehicle is not None
    st = "fused_gn_kernel<4, false, StModel>(FgnArgs, Bufs)"
    ks = "fused_gn_kernel<4, false, KsModel>(FgnArgs, Bufs)"
    assert cs.kernel_symbol("fused_gn_st", st)
    assert not cs.kernel_symbol("fused_gn_st", ks)
    assert cs.kernel_symbol("fused_gn", ks)
    assert not cs.kernel_symbol("fused_gn", st)
    assert cs.kernel_symbol("riccati", "riccati_kernel<7>(RicArgs, RicBufs)")


def test_st_ip_row_runs_the_ring_source():
    """The hard-st row's library builds the ring source: timed at its own
    geometry only (32 lanes a block), its kernel told apart by its symbol
    from the KS IP kernel's, its source named in the kernels line."""
    lcfg, _ = cs.bench_loop(n_lanes=2, device="cpu", **cs.HARD_ST)
    eng = cs.engine(lcfg.solver)
    assert eng.sweep(lcfg.solver) == (0,)
    ring = "fused_ip_ring_kernel<4, false, StModel>(IpArgs, IpRBufs)"
    assert cs.kernel_symbol("fused_ip_st", ring)
    assert not cs.kernel_symbol("fused_ip", ring)
    assert not cs.kernel_symbol(
        "fused_ip_st", "fused_ip_kernel<1, false, StModel>(IpArgs, IpBufs)")
    assert cs.kernel_symbol("fused_ip", "fused_ip_kernel<1>(IpArgs, IpBufs)")
    assert not cs.kernel_symbol(
        "fused_ip_st", "fused_ip_ring_kernel<4, true, KsModel>(IpArgs, "
        "IpRBufs)")
    assert (cs.ROOT / "mpc_tpu_torch/ops/csrc" / cs.SOURCES["fused_ip_st"]
            ).is_file()


def test_hard_corridor_row_runs_the_ks_ring_library():
    """The hard-corridor row (KS, boundary rows) runs the KS ring library,
    the ring source's boundary instance: timed at its own geometry only,
    its kernel told apart by its symbol from fused_ip.cu's and the ST
    ring's, its own entry in the kernels line with the ring source and the
    Pallas kernel's boundary branch."""
    lcfg, _ = cs.bench_loop(n_lanes=2, device="cpu", **cs.HARD_CORRIDOR)
    eng = cs.engine(lcfg.solver)
    assert eng.name == "fused_ip_ks_ring" and ":765, :783" in eng.replaces
    assert eng.sweep(lcfg.solver) == (0,)
    assert cs._launchers()[eng.name] is TFI.launch_ip_ks_ring
    ring = "fused_ip_ring_kernel<4, true, KsModel>(IpArgs, IpRBufs)"
    assert cs.kernel_symbol("fused_ip_ks_ring", ring)
    assert not cs.kernel_symbol("fused_ip", ring)
    assert not cs.kernel_symbol("fused_ip_ks_ring",
                                "fused_ip_kernel<1>(IpArgs, IpBufs)")
    timing, loop, _, checks = _corridor_lines()
    entry = {"registers": 168, "spill_stores": 0, "spill_loads": 0,
             "smem_bytes_per_block": 47488, "geometry": {}}
    line = cs.kernel_line(eng, loop, timing, "warm_2x6", "cold_5x10",
                          checks, {eng.name: entry})
    assert line["source"] == "mpc_tpu_torch/ops/csrc/fused_ip_ring.cu"
    assert line["launches"] == 104 and line["route"] == "cuda"
    assert "boundary_instance" not in line


def test_splits_name_the_variants_of_the_warm_inputs():
    """B1.b's split: (b) the same problem without the ladder, (c) the
    instance without the boundary rows on the problem without its boundary
    data and the state cut to the 14 rows; the IP split: one Newton step."""
    B = 3
    lcfg, lp = cs.bench_loop(n_lanes=B, device="cpu", **cs.SOFT_CORRIDOR)
    cfg = lcfg.solver
    ocp = cs.ocp_at(lcfg, lp)
    st = TS.init_state(cfg, batch=B)
    out = cs.split_b1b(cfg, ocp, st)
    bcfg, bocp, bst = out["b1b_b_rows"]
    assert bcfg.alphas == () and bcfg.boundary_rows and bst is st
    ccfg, cocp, cst = out["b1b_c_ladder"]
    assert ccfg.alphas == cfg.alphas and not ccfg.boundary_rows
    assert cocp.boundaries is None and cocp.boundary_signs is None
    for f in ("lam_lo", "lam_hi", "mu", "prev_viol"):
        assert getattr(cst, f).shape == (B, cfg.horizon + 1, TF.NR)
    assert TF.ineligible_reason(ccfg, cocp) is None
    icfg = TS.SolverConfig(horizon=4, **cs.IP_WARM)
    (name, (one, _, _)), = cs.split_ip(icfg, ocp, st).items()
    assert name == "warm_1x1" and (one.ip_sqp_iters, one.ip_iters) == (1, 1)
    gcfg = TS.SolverConfig(horizon=4, **cs.SOFT_ST, vehicle=VEHICLE_2)
    (name, (two, tocp, tst)), = cs.split_gn_st(gcfg, ocp, st).items()
    assert name == "gn_st_warm_1x2" and tocp is ocp and tst is st
    assert (two.al_iters, two.sqp_iters, two.model) == (1, 2, "st")


def test_kernels_line_carries_the_st_instances():
    """The sweep's entry nests its nx=7 instance with every key the line
    needs (its launches from the xla-st row); an ST library's boundary
    instance, which no row of the main path drives, carries its checks'
    launches and errors, registers and spills."""
    errs = {"K": 1e-6, "d": 2e-6, "U": 3e-5, "X": 4e-5}
    timing = {"ms": 0.2, "plain_ms": 9.0, "bound_ms": 0.1,
              "bound_by": "bytes", "pack_ms": 0.5, "max_abs_err": errs}
    loop = {"kernel_launches": 68}
    info = {"registers": 255, "spill_stores": 0, "spill_loads": 0,
            "smem_bytes_per_block": 0}
    build = {"riccati": dict(info, st_instance=info),
             "fused_gn_st": {"boundary_instance": dict(info, geometry={})}}
    line = cs.riccati_kernel_line(loop, timing, {"c": errs}, {"v": errs},
                                  build, (loop, timing, {"c": errs},
                                          {"v": errs}))
    sti = line["st_instance"]
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in line and key in sti, key
    assert sti["launches"] == 68 and sti["name"] == "riccati nx=7"
    eng = cs.engine(TS.SolverConfig(horizon=4, model="st",
                                    vehicle=VEHICLE_2))
    bnd = cs.st_boundary_line(eng, {"st_road1.7_al_3x4": errs},
                              {"st_road1.7_al_3x4": 1}, build)
    assert bnd["max_abs_err"] == 3e-5 and bnd["registers"] == 255
    assert bnd["check_launches"] == 1 and "launches" not in bnd


def test_road_boundaries_hold_the_reference_inside():
    """The boundary rows of the synthetic road read +half_width (4 m) at
    the reference points, above their bound r_ego = 1.2 m; the front and
    rear circles sit 1.5 m along the heading of a curving road, hence the
    0.1 m band."""
    B, Hs = 3, 8
    lcfg, lp = tsyn.make_bench_loop(cs.T_BENCH, Hs, B, device="cpu",
                                    boundary_rows=True, **cs.XLA_WARM)
    ocp = cs.with_road_boundaries(cs.ocp_at(lcfg, lp))
    cfg = lcfg.solver
    idx = torch.arange(Hs + 1)
    bnd, sgn = TS._stage_boundaries(ocp, Hs + 1)
    h, lo, _ = TS._stage_rows(cfg, ocp.x_ref, torch.zeros(B, Hs + 1, 2),
                              TS._stage_obs(ocp, idx), idx, bnd, sgn)
    torch.testing.assert_close(h[..., -6:], torch.full((B, Hs + 1, 6), 4.0),
                               atol=0.1, rtol=0.0)
    assert bool((lo[..., -6:] == 1.2).all())


PTXAS = """ptxas info    : Compiling entry function '_Z15fused_ip_kernelILi2EEv6IpArgs6IpBufs' for 'sm_90a'
ptxas info    : Function properties for _Z15fused_ip_kernelILi2EEv6IpArgs6IpBufs
    736 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 880 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15fused_ip_kernelILi1EEv6IpArgs6IpBufs' for 'sm_90a'
ptxas info    : Function properties for _Z15fused_ip_kernelILi1EEv6IpArgs6IpBufs
    96 bytes stack frame, 76 bytes spill stores, 252 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem, 880 bytes cmem[0]
"""


def test_build_line_reads_each_entry_function():
    """``-Xptxas -v`` gives one block per entry function: registers, spills,
    stack frame and static shared memory of each; the main path's entry of
    the IP kernel is its instance for one stage a thread."""
    entries = cs.ptxas_entries(PTXAS)
    assert len(entries) == 2
    main = cs.main_entry(entries)
    assert main == {"registers": 168, "spill_stores": 76, "spill_loads": 252,
                    "stack_frame": 96, "static_smem_bytes": 64}
    only = {"k": main}
    assert cs.main_entry(only) is main


def test_ip_timing_sweeps_lanes_per_block():
    """The IP kernel's own choice (0), then 1, 2, 4, 8 up to the most lanes
    a block fits, and that most."""
    assert cs.ip_lane_sweep(12) == (0, 1, 2, 4, 8, 12)
    assert cs.ip_lane_sweep(8) == (0, 1, 2, 4, 8)
    assert cs.ip_lane_sweep(3) == (0, 1, 2, 3)


PTXAS_GN = "".join(
    f"ptxas info    : Compiling entry function "
    f"'_Z15fused_gn_kernelILi{t}EEv7FgnArgs4Bufs' for 'sm_90a'\n"
    f"ptxas info    : Function properties for "
    f"_Z15fused_gn_kernelILi{t}EEv7FgnArgs4Bufs\n"
    f"    {t}00 bytes stack frame, {t} bytes spill stores, {t} bytes spill "
    f"loads\nptxas info    : Used 128 registers, used 13 barriers, "
    f"880 bytes cmem[0]\n" for t in (8, 4, 2))


def test_al_build_line_reads_the_instance_the_bench_takes():
    """The AL kernel has one entry function a threads-a-lane instance; the
    build line's figures are those of the instance the geometry takes at
    the bench shape."""
    entries = cs.ptxas_entries(PTXAS_GN)
    assert len(entries) == 3
    for t in (2, 4, 8):
        assert cs.main_entry(entries, t)["spill_stores"] == t


def test_al_timing_sweeps_threads_per_lane():
    """The AL kernel is timed at its own choice (0) and at each instance,
    its default the kernel's own choice."""
    lcfg, _ = tsyn.make_bench_loop(cs.T_BENCH, H, 2, device="cpu", **cs.WARM)
    eng = cs.engine(lcfg.solver)
    assert eng.geometry == "threads_per_lane" and eng.default == 0
    assert eng.sweep(lcfg.solver) == (0, 2, 4, 8) == (0,) + TF.THREADS_PER_LANE


@pytest.mark.parametrize("kw,kernel,horizon", [
    (cs.HARD_CORRIDOR, "fused_ip_ks_ring", 14),
    (cs.SOFT_CORRIDOR, "fused_gn", 30)],
    ids=["hard-corridor", "soft-corridor"])
def test_corridor_rows_launch_their_kernel_once_a_solve(kw, kernel, horizon):
    """The corridor rows run their own budgets with boundary rows at their
    horizons: one fused launch per cold start and step, 104 a loop."""
    lcfg, lp = cs.bench_loop(n_lanes=2, device="cpu", **kw)
    assert lcfg.solver.boundary_rows and lcfg.solver.horizon == horizon
    assert lp.boundaries is not None
    assert cs.row_kernel(lcfg) == (kernel, 104)


def test_corridor_spans_the_track_with_its_edges_at_four_metres():
    """Left edge at y = +4 directed -x, right edge at y = -4 directed +x,
    128 points each, signs +1, beyond both ends of every lane's track; the
    starts lie inside it, every row's margin over r_ego 1.65 m (4 m less
    the start's y of about -1.15 m less 1.2 m)."""
    lcfg, lp = cs.bench_loop(n_lanes=3, device="cpu", **cs.SOFT_CORRIDOR)
    b = lp.boundaries
    assert b.shape == (3, 2, cs.CORRIDOR_POINTS, 2)
    assert bool((b[:, 0, :, 1] == 4.0).all() and (b[:, 1, :, 1] == -4.0).all())
    assert bool((b[:, 0, 1:, 0] < b[:, 0, :-1, 0]).all())     # left: -x
    assert bool((b[:, 1, 1:, 0] > b[:, 1, :-1, 0]).all())     # right: +x
    assert bool((lp.boundary_signs == 1.0).all())
    px = lp.track.path[..., 0]
    assert float(b[..., 0].min()) < float(px.min())
    assert float(b[..., 0].max()) > float(px.max())
    m = cs.boundary_margins(lcfg.solver, lp.x_init[:, None], b,
                            lp.boundary_signs)
    assert bool((m > 1.5).all())
    assert cs.active_boundary_rows(lcfg.solver, lp.x_init[:, None], b,
                                   lp.boundary_signs) == 0


PTXAS_BND = "".join(
    f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {name}\n"
    f"    8 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
    f"spill loads\nptxas info    : Used 128 registers, 880 bytes cmem[0]\n"
    for name, spill in (
        ("_Z15fused_gn_kernelILi4ELb0EEv7FgnArgs4Bufs", 68),
        ("_Z15fused_gn_kernelILi4ELb1EEv7FgnArgs4Bufs", 432),
        ("_Z15fused_gn_kernelILi2ELb1EEv7FgnArgs4Bufs", 7)))


def test_build_line_reads_the_boundary_instances():
    """Each fused kernel has an instance with and one without the boundary
    rows (the template's bool, Lb1E / Lb0E in the mangled name): the build
    line reads each at its threads a lane."""
    entries = cs.ptxas_entries(PTXAS_BND)
    assert cs.main_entry(entries, 4)["spill_stores"] == 68
    assert cs.main_entry(entries, 4, boundary=True)["spill_stores"] == 432
    assert cs.main_entry(entries, 2, boundary=True)["spill_stores"] == 7


PTXAS_LAD = "".join(
    f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {name}\n"
    f"    8 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
    f"spill loads\nptxas info    : Used 128 registers, 880 bytes cmem[0]\n"
    for name, spill in (
        ("_Z15fused_gn_kernelILi4ELb0E7KsModelLi0EEv7FgnArgs4Bufs", 1),
        ("_Z15fused_gn_kernelILi4ELb0E7KsModelLi1EEv7FgnArgs4Bufs", 2),
        ("_Z15fused_gn_kernelILi4ELb1E7KsModelLi0EEv7FgnArgs4Bufs", 3),
        ("_Z15fused_gn_kernelILi4ELb1E7KsModelLi1EEv7FgnArgs4Bufs", 4),
        ("_Z20fused_ip_ring_kernelILi4ELb1E7StModelEv6IpArgs7IpRBufs", 5),
        ("_Z15fused_gn_kernelILi8ELb1E7StModelLin1EEv7FgnArgs4Bufs", 7)))


def test_build_line_reads_the_ladder_instances():
    """The KS AL kernel has an instance with and one without the merit
    ladder (its int after the model's name), beside the boundary rows' bool
    after the threads a lane: the build line reads the one its row runs;
    the ST library's one instance (-1) takes either, and the ring source's
    instances have no ladder argument."""
    entries = cs.ptxas_entries(PTXAS_LAD)
    got = [cs.main_entry(entries, 4, boundary=b, ladder=lad)["spill_stores"]
           for b in (False, True) for lad in (False, True)]
    assert got == [1, 2, 3, 4]
    for lad in (False, True):
        assert cs.main_entry(entries, 8, boundary=True,
                             ladder=lad)["spill_stores"] == 7
    ring = {k: v for k, v in entries.items() if "ring" in k}
    ring["_Z20fused_ip_ring_kernelILi4ELb0E7StModelEv6IpArgs7IpRBufs"] = 6
    assert cs.main_entry(ring, 4, boundary=True)["spill_stores"] == 5
    assert cs.main_entry(ring, 4) == 6


def _corridor_lines():
    errs = {"U": 1e-4, "X": 2e-4}
    timing = {"warm_2x6": {"ms": 3.0, "plain_ms": 90.0, "bound_ms": 0.1,
                           "bound_by": "operations", "max_abs_err": errs,
                           "boundary_models_ms": 18.0},
              "cold_5x10": {"ms": 20.0, "plain_ms": 900.0, "bound_ms": 0.5,
                            "bound_by": "operations", "max_abs_err": errs}}
    loop = {"row": "hard-corridor", "kernel_launches": 104,
            "feasible_steps": 1638400, "total_solves": 1638400,
            "active_boundary_lane_steps": 163290}
    entry = {"registers": 168, "spill_stores": 292, "spill_loads": 496,
             "smem_bytes_per_block": 128976, "geometry": {}}
    build = {"fused_gn": dict(entry, boundary_instance=entry)}
    return timing, loop, build, {"case": errs}


def test_kernels_line_carries_each_boundary_instance():
    """The kernels line's entry of the AL kernel nests its boundary
    instance (the soft-corridor row's) with every key the line needs:
    launches of its corridor row, the largest check error, its time, plain
    time, bound and what sets it, the library call (none), and the glue of
    the rows' models."""
    timing, loop, build, checks = _corridor_lines()
    eng = cs.engine(TS.SolverConfig(horizon=30))
    bnd = cs.boundary_instance_line(eng, loop, timing, "warm_2x6",
                                    "cold_5x10", checks, build)
    for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "boundary_models_ms",
                "active_boundary_lane_steps", "registers", "spill_stores"):
        assert key in bnd, key
    assert bnd["launches"] == 104
    assert (bnd["max_abs_err"], bnd["max_abs_err_X"]) == (1e-4, 2e-4)
    line = cs.kernel_line(eng, loop, timing, "warm_2x6", "cold_5x10",
                          checks, build, bnd)
    assert line["boundary_instance"] is bnd
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in line, key


def test_corridor_loop_line_counts_active_rows(monkeypatch):
    """A corridor row's loop line: its kernel's launches, every step
    feasible, the lane-steps where a boundary row is active (states at
    y = 2.8 m, 1.2 m below the left edge) and the largest lateral y; a
    stand-in loop on the CPU gives the states."""
    B, T = 4, cs.T_BENCH
    monkeypatch.setattr(cs, "B_BENCH", B)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn: (1.0, fn()))

    def loop(lcfg, lp, device=None):
        TFI.launch_ip_ks_ring.launches += 104
        X = torch.zeros(B, T, 5)
        X[:, 40:60, 1] = 4.0 - 1.2
        zero = torch.zeros(B, T)
        return tcl.LoopResult(X=X, U=torch.zeros(B, T, 2),
                              status=zero.int(), viol=zero, cost=zero,
                              stat=zero)
    monkeypatch.setattr(tcl, "closed_loop_batch_vec", loop)
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    line, lcfg, _ = cs.phase_loop("cpu", "card, 700.00 W", "hard-corridor",
                                  "b", **cs.HARD_CORRIDOR)
    assert lines == [line]
    assert line["metric"] == "nmpc_solves_per_s_per_chip_h14"
    assert line["kernel_launches"] == 104
    assert line["launches_by_kernel"]["fused_gn"] == 0
    assert line["launches_by_kernel"]["fused_ip"] == 0
    assert line["feasible_steps"] == line["total_solves"] == B * T
    assert line["active_boundary_lane_steps"] == B * 20
    assert line["max_lateral_y"] == pytest.approx(2.8)


def test_fleet_phase_names_its_kernels():
    """The forcespro fleet runs the KS ring library with the boundary rows
    (fused_ip_ks_ring) and the casadi pair fused_gn's ladder instance."""
    dev = torch.device("cpu")
    lcfg, lp, lens, _ = cs.fleet_batch(dev, cs.FLEET, 8)
    assert cs.row_kernel(lcfg) == ("fused_ip_ks_ring", 102)
    assert lcfg.solver.horizon == 12 and lcfg.solver.ip_alphas
    assert lens.tolist() == [30, 100, 30, 91] * 2
    assert torch.equal(lp.x_init[4:], lp.x_init[:4])
    lcfg, _, lens, _ = cs.fleet_batch(dev, [c for c, _ in cs.FLEET_LF], 8)
    assert cs.row_kernel(lcfg) == ("fused_gn", 70)
    assert lcfg.solver.alphas and lcfg.solver.horizon == 10
    assert lens.tolist() == [30, 70] * 4


def test_ranks_share_the_one_card(monkeypatch):
    """Two ranks on a machine with one card both take ``cuda:0``."""
    from mpc_tpu_torch.parallel import mesh as pm
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for rank in ("0", "1"):
        monkeypatch.setenv("LOCAL_RANK", rank)
        assert pm.local_device() == torch.device("cuda", 0)
