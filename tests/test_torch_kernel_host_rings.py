"""The ring sources (``fused_ip_ring.cu`` as the KS library with boundary
rows and as the ST library) and the ST AL source at their ragged,
strided and boundary-row instances, compiled for the host and held
against their plain versions on the CPU, as in
``tests/test_torch_kernel_host.py``."""
import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from torch_host_kernels import (B, ST, assert_close, bench_ocp,
                                build_host_libs, corridor_ocp, host_gn,
                                host_ip)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return build_host_libs(tmp_path_factory, ("fused_gn_st", "fused_ip_st", "fused_ip_ks_ring"))


def test_fused_ip_source_with_boundary_rows(host_libs):
    """The KS IP library with the boundary rows, the ring source's instance
    (2x6, warm duals, the ladder, B=5 lanes of a block of 32), on a bending
    road whose rows bind."""
    cfg, ocp = corridor_ocp(method="ip", ip_sqp_iters=2, ip_iters=6,
                            ip_warm_duals=True)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert cs.active_boundary_rows(cfg, pln.X, ocp.boundaries,
                                   ocp.boundary_signs) > 0
    assert bool((pln.state.lam_lo[..., TF.NR:] > 1.0).any())
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_ip_ks_ring_ragged_lanes_at_the_corridor_horizon(host_libs):
    """The KS ring library at the hard-corridor row's horizon (H=14: 15
    stages over a block's 4 warps) and its warm-up budget (5x10, warm
    duals, the default ladder), B=5 lanes of a block of 32, moving
    obstacles, inside a road 4 m either side of the reference."""
    cfg, ocp = bench_ocp(horizon=14, moving=True, method="ip",
                         ip_sqp_iters=5, ip_iters=10, ip_warm_duals=True,
                         boundary_rows=True)
    ocp = cs.with_road_boundaries(ocp)
    assert TFI.ip_library(cfg) == "fused_ip_ks_ring" and cfg.ip_alphas
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)
    assert ker.X.shape == (B, 15, 5) and ker.state.lam_lo.shape[-1] == 20


@pytest.mark.parametrize("method", ["al", "ip"])
def test_st_sources_with_boundary_rows(host_libs, method):
    """The ST libraries' boundary instances on the bending road whose rows
    bind (the KS cases' budgets: al 3x2 with the ladder, ip 2x6 with warm
    duals and the ladder)."""
    kw = (dict(al_iters=3, sqp_iters=2) if method == "al" else
          dict(method="ip", ip_sqp_iters=2, ip_iters=6, ip_warm_duals=True))
    cfg, ocp = corridor_ocp(**kw, **ST)
    st = TS.init_state(cfg, batch=B)
    if method == "ip":
        bufs, ker = host_ip(host_libs, cfg, ocp, st)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, follow=bufs.get("rung")), st.mu)
        assert_close(ker, pln, cs.IP_BANDS,
                     {"lam_hi": cs.IP_STATE_BANDS["lam_hi"]})
        # the boundary rows' duals of a lane running along the edge are
        # degenerate (ROADMAP, known behaviours): lam_lo is held on the
        # lanes where the plain version's own float32 and float64 solves
        # agree, as chip_smoke's rounding_lanes excuses the others, here
        # one lane of five
        o64, s64 = cs.as_float64(ocp._replace(
            boundaries=ocp.boundaries.double(),
            boundary_signs=ocp.boundary_signs.double()), st)
        p64 = TFI.solve_batch_fused_ip_plain(cfg, o64, s64,
                                             follow=bufs.get("rung"))
        band = cs.IP_STATE_BANDS["lam_lo"]
        noisy = ~cs.lanes_close(pln.state.lam_lo.double(), p64[2], *band)
        assert int(noisy.sum()) <= 1
        assert bool((cs.lanes_close(ker.state.lam_lo, pln.state.lam_lo,
                                    *band) | noisy).all())
    else:
        bufs, ker = host_gn(host_libs, cfg, ocp, st, 4)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, follow=bufs.get("rung")))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    assert cs.active_boundary_rows(cfg, pln.X, ocp.boundaries,
                                   ocp.boundary_signs) > 0
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_st_al_source_at_eight_threads_a_lane_and_h40(host_libs):
    """B=5 ragged lanes at 8 threads a lane, H=40, moving obstacles, the
    ladder on: the ST ring's operand (71 floats) through several slots a
    producer."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, al_iters=2, sqp_iters=2,
                         **ST)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_gn(host_libs, cfg, ocp, st, 8)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp, st, follow=bufs.get("rung")))
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


def test_st_ip_ring_source_ragged_lanes_and_strided_stages(host_libs):
    """The ST ring source at H=40 (41 stages over a block's 4 warps, a
    thread looping over 10 or 11 of them in every separable phase and a
    producer over 13 or 14 in every ring), B=5 lanes of a block of 32,
    moving obstacles, warm duals and the ladder on."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, method="ip",
                         ip_sqp_iters=2, ip_iters=3, ip_warm_duals=True, **ST)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)
    assert ker.X.shape == (B, 41, 7)
