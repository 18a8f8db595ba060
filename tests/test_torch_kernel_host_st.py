"""The ST libraries (``fused_gn_st.cu``, ``fused_ip_st.cu``) compiled for
the host and held against their plain versions on the CPU at each
budget of the KS sources, as in ``tests/test_torch_kernel_host.py``."""
import pytest

import chip_smoke as cs
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from torch_host_kernels import (AL_CASES, B, H, IP_CASES, ST, assert_close,
                                bench_ocp, build_host_libs, host_gn, host_ip)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    return build_host_libs(tmp_path_factory, ("fused_gn_st", "fused_ip_st"))


ST_CASES = {f"al-{k}": v for k, v in AL_CASES.items()}
ST_CASES.update({f"ip-{k}": v for k, v in IP_CASES.items()})


@pytest.mark.parametrize("case", list(ST_CASES))
def test_st_sources_match_the_plain_version(host_libs, case):
    """Both fused sources' ST instances (4 threads a lane; 2 lanes a
    block) against the plain versions, at the KS cases' budgets, all 7
    states in the X band."""
    cfg, ocp = bench_ocp(**ST_CASES[case], **ST)
    st = TS.init_state(cfg, batch=B)
    if cfg.method == "ip":
        bufs, ker = host_ip(host_libs, cfg, ocp, st)
        pln = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(
            cfg, ocp, st, follow=bufs.get("rung")), st.mu)
        assert_close(ker, pln, cs.IP_BANDS, cs.IP_STATE_BANDS)
    else:
        bufs, ker = host_gn(host_libs, cfg, ocp, st, 4)
        pln = TF.to_solution(cfg, TF.solve_batch_fused_plain(
            cfg, ocp, st, follow=bufs.get("rung")))
        assert_close(ker, pln, cs.BANDS, cs.STATE_BANDS)
    assert ker.X.shape == (B, H + 1, 7)
