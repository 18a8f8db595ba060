"""The AL source ``fused_gn.cu`` (KS, with and without boundary rows)
compiled for the host and held against its plain version on the CPU, as
in ``tests/test_torch_kernel_host.py``."""
import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import sqp as TS
from torch_host_kernels import (AL_CASES, B, H, assert_close, bench_ocp,
                                build_host_libs, corridor_ocp, host_gn)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return build_host_libs(tmp_path_factory, ("fused_gn",))


@pytest.mark.parametrize("case", list(AL_CASES))
def test_fused_gn_source_matches_the_plain_version(host_libs, case):
    cfg, ocp = bench_ocp(**AL_CASES[case])
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_gn(host_libs, cfg, ocp, st)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp, st, follow=bufs.get("rung")))
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


def test_fused_gn_source_with_binding_rows(host_libs):
    """The obstacle 2.5 m beside the reference's last stage: its circle
    rows bind, so the multipliers, the penalties' growth on stalled rows
    and the violations that the updates between AL iterations compute
    shape the solve."""
    cfg, ocp = bench_ocp(al_iters=3, sqp_iters=2, alphas=())
    ahead = ocp.x_ref[:, H, None, :2] + torch.tensor(
        [[0.0, 2.5], [1.5, 2.5], [-1.5, 2.5]])
    ocp = ocp._replace(obs_centers=ahead.contiguous())
    st = TS.init_state(cfg, batch=B)
    _, ker = host_gn(host_libs, cfg, ocp, st, 4)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(cfg, ocp, st))
    assert bool((pln.state.mu > cfg.mu0).any())      # a penalty grew
    assert bool((pln.state.lam_lo > 0).any())        # a multiplier is on
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_gn_source_ragged_lanes_and_strided_stages(host_libs):
    """B=5 lanes in a block of 32 (the other 27 threads of every warp past
    the last lane) at 4 and 8 threads a lane, H=40: 41 stages, so each
    thread owns 5 to 11 of them, with moving obstacles and the ladder on."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, al_iters=2, sqp_iters=2)
    st = TS.init_state(cfg, batch=B)
    for threads_per_lane in (4, 8):
        bufs, ker = host_gn(host_libs, cfg, ocp, st, threads_per_lane)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, follow=bufs.get("rung")))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)


def test_fused_gn_source_with_boundary_rows(host_libs):
    """The AL source's boundary instance (3x2 with the ladder, B=5 ragged,
    4 threads a lane) on a bending road whose rows bind: their multipliers
    and penalties move."""
    cfg, ocp = corridor_ocp(al_iters=3, sqp_iters=2)
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_gn(host_libs, cfg, ocp, st, 4)
    pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
        cfg, ocp, st, follow=bufs.get("rung")))
    assert cs.active_boundary_rows(cfg, pln.X, ocp.boundaries,
                                   ocp.boundary_signs) > 0
    assert bool((pln.state.lam_lo[..., TF.NR:] > 0).any())
    assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)
