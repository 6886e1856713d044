"""The port's multi-process runtime (parallel/dist.py, multihost.py,
utils/device.py) against the JAX package's helpers (the counterparts of
tests/test_dist.py), and its collectives at 2 ranks on the CPU (gloo;
tests/torch_launch.py starts them as torchrun would)."""
import os
import sys

import numpy as np
import pytest
import torch

from torch_launch import cli, free_port, launch, one_rank_group_check

from deepsignal_plant_tpu.parallel import dist as jax_dist
from deepsignal_plant_tpu_torch.parallel import dist
from deepsignal_plant_tpu_torch.parallel.multihost import host_row_shard
from deepsignal_plant_tpu_torch.utils.device import resolve_device

LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES")


@pytest.fixture(autouse=True)
def no_launch(monkeypatch):
    for v in LAUNCH_ENV:
        monkeypatch.delenv(v, raising=False)


@pytest.mark.parametrize("n,world", [(10, 3), (7, 4), (3, 1), (2, 4)])
def test_shard_for_host_matches_jax(n, world):
    """Complete, disjoint, independent of the listing order, and the JAX
    package's partition."""
    items = [f"f{i:03d}.fast5" for i in range(n)]
    shards = [dist.shard_for_host(items, r, world) for r in range(world)]
    assert sorted(sum(shards, [])) == sorted(items)
    for r in range(world):
        assert dist.shard_for_host(list(reversed(items)), r, world) == \
            shards[r] or world == 1
        assert shards[r] == jax_dist.shard_for_host(items, r, world)


def test_one_process_defaults():
    assert dist.process_info() == (0, 1)
    assert dist.shard_for_host(["b", "a"]) == ["b", "a"]
    assert dist.host_output_path("/x/y/calls.tsv") == "/x/y/calls.tsv"
    assert dist.init_distributed() is False
    assert not dist.pod_configured()
    dist.destroy()


@pytest.mark.parametrize("n,world", [(11, 3), (4, 4), (5, 1)])
def test_host_row_shard(n, world):
    from deepsignal_plant_tpu.parallel.multihost import \
        host_row_shard as jax_host_row_shard
    shards = [host_row_shard(n, r, world) for r in range(world)]
    assert sorted(np.concatenate(shards).tolist()) == list(range(n))
    for r in range(world):
        np.testing.assert_array_equal(shards[r],
                                      jax_host_row_shard(n, r, world))


def test_jax_pod_env_without_torchs_raises(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT"):
        dist.init_distributed()
    with pytest.raises(RuntimeError, match="not initialized"):
        dist.process_info()


def test_incomplete_launch_env_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT"):
        dist.init_distributed(device="cpu")
    # without the group, no rank may run as if it were alone
    with pytest.raises(RuntimeError, match="not initialized"):
        dist.host_output_path("calls.tsv")


def test_resolve_device_under_a_launch(monkeypatch):
    """cuda:<LOCAL_RANK> under a launch, raising when that card is not
    there; an explicit cuda:<n> likewise; never a silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert picked == [0, 0]
    monkeypatch.setenv("LOCAL_RANK", "1")
    for choice in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="does not exist"):
            resolve_device(choice)
    assert resolve_device("cpu") == torch.device("cpu")
    for bad in ("cuda:x", "gpu"):
        with pytest.raises(ValueError):
            resolve_device(bad)


def test_device_flag_takes_an_index():
    from deepsignal_plant_tpu_torch import cli
    p = cli.build_parser()
    assert p.parse_args(["train", "--train_file", "t", "--valid_file", "v",
                         "--model_dir", "m", "--device", "cuda:1"]
                        ).device == "cuda:1"
    with pytest.raises(SystemExit):
        p.parse_args(["call_freq", "-i", "x", "-o", "y", "--device", "tpu"])


_COLLECTIVES = r'''
import numpy as np, torch
from deepsignal_plant_tpu_torch.parallel import dist, multihost
assert dist.init_distributed(device="cpu")
rank, world = dist.process_info()
assert world == 2
payload = bytes([65 + rank]) * (1000 + 300 * rank)
got = multihost.allgather_bytes(payload, chunk_bytes=256)
assert got == [b"A" * 1000, b"B" * 1300], [len(g) for g in got]
assert multihost.allgather_bytes(payload, chunk_bytes=256, keep=False) == []
assert multihost.allgather_bytes(b"" if rank else b"x") == [b"x", b""]
total = multihost.global_sum([1.5, rank, 2 ** 40 + rank])
assert total.tolist() == [3.0, 1.0, 2.0 ** 41 + 1], total
a, b = multihost.all_sum([torch.full((2, 3), rank + 1.0),
                          torch.tensor([rank * 0.5])])
assert a.shape == (2, 3) and (a == 3).all() and b.tolist() == [0.5]
arrays = multihost.broadcast_arrays(
    {"w": np.arange(6.0).reshape(2, 3), "n": np.int64(7)} if rank == 0
    else None)
assert arrays["w"].tolist() == [[0, 1, 2], [3, 4, 5]] and arrays["n"] == 7
assert multihost.broadcast_arrays({} if rank == 0 else None) == {}
assert dist.host_output_path("/d/calls.tsv") == "/d/calls.host%d.tsv" % rank
assert dist.shard_for_host(["c", "a", "b"]) == [["a", "c"], ["b"]][rank]
dist.destroy()
print("COLLECTIVES rank=%d ok" % rank)
'''


def test_collectives_at_two_ranks():
    outs = launch([sys.executable, "-c", _COLLECTIVES], 2, timeout=120)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0 and f"COLLECTIVES rank={r} ok" in out, out[-3000:]


def test_nccl_group_needs_a_card(monkeypatch):
    """start_group's NCCL branch: a LOCAL_RANK with no card raises before
    any group starts (never a fallback to gloo)."""
    import torch.distributed as tdist
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"),
                 ("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tdist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        dist.init_distributed()
    assert not dist.group_running()


def test_one_rank_group_gives_the_steps_bytes(monkeypatch):
    """The train step and the evaluation sum over a running group even at
    one rank (as chip_smoke.py's NCCL run starts it): a mask of ones gives
    the bytes of the step without a group, a padded and masked step the
    update of the step on the rows kept (float32 on the CPU: 1e-5 of
    max|update|)."""
    from deepsignal_plant_tpu_torch.config import ModelConfig
    for k, v in (("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(free_port())), ("WORLD_SIZE", "1"),
                 ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    try:
        got = one_rank_group_check(
            "cpu", "gloo", ModelConfig(hidden_size=16, num_layers_comb=2,
                                       compute_dtype="float32"), 64, 1e-5)
        assert dist.process_info() == (0, 1)
    finally:
        dist.destroy()
    assert got["kept"] == 56 and got["update_scale"] > 0
    assert abs(got["masked_loss"] - got["kept_loss"]) <= 1e-6


@pytest.mark.parametrize("argv", [
    ["serve", "-i", "watch", "-o", "out", "-m", "m.ckpt.npz", "--device",
     "cpu"]], ids=["serve"])
def test_one_process_commands_refuse_a_launch(argv, tmp_path):
    """serve runs as one process: at 2 ranks every rank raises before it
    reads or writes anything (denoise runs at N ranks:
    tests/test_torch_dist_denoise.py)."""
    outs = launch(cli(*argv), 2, timeout=120, cwd=str(tmp_path))
    for rc, out in outs:
        assert rc != 0 and "runs as one process on one card" in out, \
            out[-3000:]
    assert os.listdir(tmp_path) == []
