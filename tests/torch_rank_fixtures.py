"""The spawned ranks' results that ``tests/test_torch_distributed*.py``
share: two ranks run every two-rank check of ``tests/torch_ranks.py`` at
once, four ranks the four-rank checks.  Both files read the two ranks'
results, so they are spawned once a test session (``torch_once.once``)."""
import pytest
import torch

from tests import torch_ranks
from tests.test_torch_fused_gn import ocp_numpy
from torch_once import once

H, B = 8, 8


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    def spawn(out):
        torch.save(ocp_numpy(H, B, seed=7), out / "inputs.pt")
        return torch_ranks.spawn(torch_ranks.two_rank_checks, 2, out)
    return once(tmp_path_factory, "two_ranks", spawn)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return torch_ranks.spawn(torch_ranks.four_rank_checks, 4,
                             tmp_path_factory.mktemp("four_ranks"))
