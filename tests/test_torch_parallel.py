"""The port's data-parallel rules (anatomask_torch/parallel/mesh.py) against
the JAX package's: the per-rank batch and oversample split, the global-batch
scaling of `pick_mesh_for_batch` (the test process has 8 virtual JAX devices,
tests/conftest.py), the microbatch rule of the JAX PretrainTrainer
(ssl/pretrain.py:421-429), the world size a run takes, and the augmentation
draws a rank takes from the global batch's."""
import pytest
import torch

from anatomask_torch.data.augment import (AugmentConfig, SpatialAugmentConfig, apply_train_augment,
                                          draw_all, make_train_augment_fn, take_rows)
from anatomask_torch.data.augment_da5 import DA5Config
from anatomask_torch.parallel import mesh
from anatomask_torch.ssl.pretrain import accumulation_steps
from anatomask_tpu.parallel.mesh import (
    compute_shard_batch_and_oversample as jax_compute_shard_batch_and_oversample)
from anatomask_tpu.training.trainer import pick_mesh_for_batch


@pytest.mark.parametrize("oversample", [0.0, 0.33, 0.5, 1.0])
def test_shard_batch_and_oversample_match_jax(oversample):
    for world in range(1, 9):
        for batch in range(world, 17):
            for r in range(world):
                assert (mesh.compute_shard_batch_and_oversample(batch, oversample, r, world)
                        == jax_compute_shard_batch_and_oversample(batch, oversample, r, world))


@pytest.mark.parametrize("world", range(1, 9))
def test_global_batch_scaling_matches_pick_mesh_for_batch(world):
    for batch in range(1, 17):
        _, n, want = pick_mesh_for_batch(batch, True, log=lambda *a: None, max_devices=world)
        assert n == world
        assert mesh.global_batch_size(batch, world, log=lambda *a: None) == want


# (global batch, grad_accum_steps asked for, ranks) -> microbatches, by JAX's
# rule: lowered until it divides the global batch and the microbatch divides
# among the ranks
MICRO_TABLE = [
    (4, 2, 1, 2), (4, 2, 2, 2), (4, 2, 4, 1), (8, 4, 2, 4), (8, 4, 4, 2), (6, 4, 2, 3),
    (6, 3, 3, 2), (12, 4, 3, 4), (16, 8, 4, 4), (2, 2, 2, 1), (5, 2, 1, 1), (4, 0, 2, 1),
]


@pytest.mark.parametrize("batch,requested,ranks,micro", MICRO_TABLE)
def test_microbatch_rule_matches_jax(batch, requested, ranks, micro):
    assert accumulation_steps(batch, requested, ranks) == micro


def test_world_size_follows_the_cap(monkeypatch):
    monkeypatch.delenv("ATK_NUM_DEVICES", raising=False)
    assert mesh.world_size_for("cpu") == 1
    assert mesh.world_size_for("cpu", 3) == 3
    monkeypatch.setenv("ATK_NUM_DEVICES", "2")
    assert mesh.world_size_for("cpu") == 2
    assert mesh.world_size_for("cpu", 4) == 4
    visible = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"{visible} CUDA device"):
        mesh.world_size_for("cuda", visible + 1)


def test_no_group_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert not mesh.distributed() and mesh.world() == 1 and mesh.rank() == 0
    assert mesh.local_rows(4, 2) is None
    assert mesh.all_reduce_sum(x) is x
    assert mesh.mean_over_ranks(x) is x
    assert torch.equal(mesh.gather_ranks(x), x[None])
    assert mesh.shard_batch_spec(4, 0.33) == (4, 0.33)
    assert mesh.rank_device("cuda") == torch.device("cuda")


@pytest.mark.parametrize("da5", [False, True])
def test_rows_of_the_global_draws(da5):
    """A batch augmented with its rows of the global batch's draws equals
    those rows of the global batch augmented whole (the noise field, elastic
    and DA5 draws included)."""
    cfg = AugmentConfig(spatial=SpatialAugmentConfig(patch_size=(8, 8, 8), p_rotation=1.0,
                                                     p_scaling=1.0, p_elastic=1.0),
                        mirror_axes=(0, 1, 2), da5=DA5Config() if da5 else None)
    data = torch.randn((4, 12, 12, 12, 1), generator=torch.Generator().manual_seed(1))
    whole, _ = make_train_augment_fn(cfg)(torch.Generator().manual_seed(2), data)
    rows = torch.tensor([1, 3])
    part, _ = make_train_augment_fn(cfg)(torch.Generator().manual_seed(2), data[rows],
                                         rows=rows, global_batch=4)
    assert torch.equal(part, whole[rows])
    draws = draw_all(torch.Generator().manual_seed(2), data, cfg)
    every = take_rows(draws, torch.arange(4))
    assert torch.equal(apply_train_augment(cfg, every, data)[0], whole)
