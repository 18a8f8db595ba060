"""The port's multi-rank path on four ranks spawned with gloo on
localhost: the mesh shapes of four, an uneven stage split over sp=4 and
``dryrun_multichip(2)`` and ``(4)`` (the two-rank checks:
``tests/test_torch_distributed.py``)."""
from torch_rank_fixtures import four, two  # noqa: F401 (fixtures)


def test_mesh_of_four_ranks(four):
    for r, res in enumerate(four):
        shape, coords, dp, sp = res["shapes"]["(2, 2)"]
        assert shape == {"dp": 2, "sp": 2}
        assert coords == {"dp": r // 2, "sp": r % 2}
        assert dp == (r % 2, 2 + r % 2) and sp == (r - r % 2, r - r % 2 + 1)
        assert res["shapes"]["None"][0] == {"dp": 4, "sp": 1}
        assert res["shapes"]["(1, 4)"][1] == {"dp": 0, "sp": r}
        assert len(res["errors"]) == 3
        # all_reduce over dp sums ranks r % 2 and 2 + r % 2; all_gather
        # over sp returns the sp group's ranks in order
        assert res["dp_sum"] == 2 * (r % 2) + 2
        assert res["sp_gather"] == [r - r % 2, r - r % 2 + 1]


def test_stage_split_over_four_ranks(four):
    """13 elements over sp=4 (4 + 3 + 3 + 3) at float64."""
    for res in four:
        assert max(res["sweep12_sp4"]) < 1e-9, res["sweep12_sp4"]


def test_dryrun_multichip_two_and_four(two, four):
    assert two[0]["dryrun"].startswith(
        "dryrun_multichip(2): ok — closed loop 2 lanes x 6 steps on mesh "
        "{'dp': 1, 'sp': 2}, stage axis sp (pscan sharded)")
    assert two[0]["dryrun"].endswith("open-loop batch 2/2 converged")
    assert four[0]["dryrun"].startswith(
        "dryrun_multichip(4): ok — closed loop 4 lanes x 6 steps on mesh "
        "{'dp': 2, 'sp': 2}")
    assert four[0]["dryrun"].endswith("open-loop batch 4/4 converged")
    assert {r["dryrun"] for r in two} == {two[0]["dryrun"]}
