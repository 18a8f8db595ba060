"""The IP source ``fused_ip.cu`` (KS, no boundary rows) compiled for the
host and held against its plain version on the CPU, as in
``tests/test_torch_kernel_host.py``."""
import dataclasses

import pytest
import torch

import chip_smoke as cs
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from torch_host_kernels import (B, IP_CASES, assert_close, bench_ocp,
                                build_host_libs, host_ip)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return build_host_libs(tmp_path_factory, ("fused_ip",))


@pytest.mark.parametrize("case", list(IP_CASES))
def test_fused_ip_source_matches_the_plain_version(host_libs, case):
    cfg, ocp = bench_ocp(**IP_CASES[case])
    st = TS.init_state(cfg, batch=B)
    bufs, ker = host_ip(host_libs, cfg, ocp, st)
    pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
        cfg, ocp, st, follow=bufs.get("rung")), st.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                               rtol=0.0, atol=1e-3)


def test_fused_ip_source_warm_start_and_in_place_state(host_libs):
    """The bench point: warm ip 1x4 from the cold-start state; the kernel
    writes U and the duals in place and leaves the caller's state alone."""
    cfg, ocp = bench_ocp(method="ip", ip_sqp_iters=5, ip_iters=10,
                         ip_alphas=())
    _, cold = host_ip(host_libs, cfg, ocp, TS.init_state(cfg, batch=B))
    warm_cfg = dataclasses.replace(cfg, ip_sqp_iters=1, ip_iters=4,
                                   ip_warm_duals=True)
    before = cold.state.map(torch.clone)
    bufs, ker = host_ip(host_libs, warm_cfg, ocp, cold.state)
    for a, b in zip(cold.state, before):
        assert torch.equal(a, b)
    assert ker.U.data_ptr() == bufs["U"].data_ptr()
    pln = TFI.to_solution_ip(warm_cfg, TFI.solve_batch_fused_ip_plain(
        warm_cfg, ocp, cold.state), cold.state.mu)
    assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    assert bool((ker.status >= 0).all())


def test_fused_ip_source_ragged_lanes_and_strided_stages(host_libs):
    """B=5 lanes at 2 and 4 lanes a block (the last block ragged), H=40:
    41 stages over the warp's 32 threads, so threads 0..8 own two stages
    each (the strided path of the kernel), with moving obstacles and the
    ladder on."""
    cfg, ocp = bench_ocp(horizon=40, moving=True, method="ip",
                         ip_sqp_iters=2, ip_iters=3, ip_warm_duals=True)
    st = TS.init_state(cfg, batch=B)
    for lanes_per_block in (2, 4):
        bufs, ker = host_ip(host_libs, cfg, ocp, st, lanes_per_block)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, follow=bufs.get("rung")), st.mu)
        assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
        torch.testing.assert_close(ker.state.prev_viol, pln.state.prev_viol,
                                   rtol=0.0, atol=1e-3)
