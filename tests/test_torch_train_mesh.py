"""Process-group bootstrap of the port: each rank of a multi-card launch is
bound to its own card (``parallel.mesh``). The card and the process group
are stubbed, so these run on the CPU."""

import pytest
import torch

from mgwfbp_tpu_torch.parallel import mesh

_LAUNCH_VARS = (
    "LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK",
    "MGWFBP_COORDINATOR", "MGWFBP_NUM_PROCESSES", "MGWFBP_PROCESS_ID",
    "SLURM_NTASKS", "SLURM_PROCID", "OMPI_COMM_WORLD_SIZE",
    "OMPI_COMM_WORLD_RANK",
)


@pytest.fixture
def four_cards(monkeypatch):
    """A host with four cards and a process group that records its start."""
    for var in _LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = {"set_device": [], "init": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", calls["set_device"].append)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(
        mesh.dist, "init_process_group",
        lambda backend, **kw: calls["init"].append((backend, kw)),
    )
    return calls


@pytest.mark.parametrize("env, process_id, want", [
    ({"LOCAL_RANK": "3"}, 7, 3),
    ({"SLURM_LOCALID": "1"}, 5, 1),
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "2"}, 0, 2),
    ({"LOCAL_RANK": "0", "SLURM_LOCALID": "3"}, 6, 0),
    ({}, 6, 2),
    ({}, 3, 3),
])
def test_local_device_index(four_cards, env, process_id, want):
    assert mesh.local_device_index(process_id, env) == want


@pytest.mark.parametrize("device, env, want", [
    ("cuda", {}, torch.device("cuda", 2)),
    (None, {}, torch.device("cuda", 2)),
    ("cuda", {"LOCAL_RANK": "1"}, torch.device("cuda", 1)),
    ("cuda:3", {"LOCAL_RANK": "1"}, torch.device("cuda", 3)),
])
def test_ranks_of_a_multi_card_launch_take_their_own_card(
    four_cards, monkeypatch, device, env, want
):
    """Process 6 of 8 (two hosts of four cards) trains on its local card,
    which becomes the current device and the NCCL group's device."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = mesh.init_distributed(device, coordinator="localhost:29500",
                                num_processes=8, process_id=6)
    assert got == want
    assert four_cards["set_device"] == [want]
    backend, kw = four_cards["init"][0]
    assert backend == "nccl"
    assert kw["rank"] == 6 and kw["world_size"] == 8
    assert kw["init_method"] == "tcp://localhost:29500"
    assert kw["device_id"] == want


def test_a_local_rank_past_the_host_cards_raises(four_cards, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "4")
    with pytest.raises(ValueError, match="4 card"):
        mesh.init_distributed("cuda", coordinator="localhost:29500",
                              num_processes=8, process_id=4)
    assert four_cards["init"] == []


def test_one_process_starts_no_group(four_cards):
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    assert mesh.init_distributed("cuda") == torch.device("cuda", 0)
    assert four_cards["init"] == [] and four_cards["set_device"] == []
