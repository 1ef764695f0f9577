"""The port's meshes, logical-axis sharding and mesh collectives: the 14
cases of tests/test_parallel.py on eight gloo ranks.

The reference runs them on eight virtual CPU devices of one process
(tests/conftest.py); here a module-scoped pool of eight spawned gloo
processes (tests/_gloo_pool.py) runs every case, each rank with its own
shard: where the reference passes one global array, each rank passes its
block and the test stacks what the ranks return.  The ranks import no
JAX (this module imports none).  ``test_multi_axis_collective`` is a
``local_map`` over ("dp", "tp"); the multislice cases group the ranks
into hosts with ``num_slices``.  Cases the port adds: the local mesh and
the host groups of ranks on one host, the gradients of ``mesh_ppermute``
and ``mesh_all_to_all`` (the inverse permutation; the all-to-all with its
axes swapped) and the world-1 mesh of a process that joined no group.
"""

import numpy as np
import pytest
import torch

from _gloo_pool import GlooPool
from ray_tpu_torch.parallel import (Logical, MeshSpec, PartitionSpec as P,
                                    make_mesh, make_multislice_mesh,
                                    shard_tree, spec_from_logical, spec_of)

WORLD = 8


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


# -- rank-side bodies (module level: the ranks import them by name) ------


def _build_shapes():
    from ray_tpu_torch.parallel import axis_sizes

    return axis_sizes(make_mesh(dp=2, tp=4))


def _bad_shape():
    with pytest.raises(ValueError):
        make_mesh(dp=3, tp=3)  # 9 != 8
    return True


def _specs():
    mesh = make_mesh(dp=8)  # tp has size 1
    s = spec_from_logical(("embed", "heads", "head_dim"), mesh=mesh)
    mesh2 = make_mesh(fsdp=2, tp=4)
    s2 = spec_from_logical(("embed", "heads", "head_dim"), mesh=mesh2)
    return s, s2


def _tree_placement():
    mesh = make_mesh(fsdp=2, tp=4, device_type="cpu")
    params = {"w": np.ones((8, 16), np.float32),
              "b": np.zeros((16,), np.float32)}
    logical = {"w": Logical("embed", "mlp"), "b": Logical("mlp")}
    placed = shard_tree(params, logical, mesh)
    return (spec_of(placed["w"]), tuple(placed["w"].to_local().shape),
            placed["w"].full_tensor().numpy())


def _allreduce():
    from ray_tpu_torch.collective.nccl_group import mesh_allreduce

    mesh = make_mesh(dp=8)
    x = torch.arange(16.0)[2 * _rank():2 * _rank() + 2]  # 2 per rank
    return mesh_allreduce(x, mesh, "dp").numpy()


def _allgather():
    from ray_tpu_torch.collective.nccl_group import mesh_allgather

    mesh = make_mesh(dp=8)
    return mesh_allgather(torch.arange(8.0)[_rank():_rank() + 1], mesh,
                          "dp").numpy()


def _reducescatter():
    from ray_tpu_torch.collective.nccl_group import mesh_reducescatter

    mesh = make_mesh(dp=8)
    return mesh_reducescatter(torch.ones((1, 16)), mesh, "dp").numpy()


def _broadcast():
    from ray_tpu_torch.collective.nccl_group import mesh_broadcast

    mesh = make_mesh(dp=8)
    return mesh_broadcast(torch.full((1,), float(_rank())), mesh, "dp",
                          root=3).numpy()


def _ppermute_ring():
    from ray_tpu_torch.collective.nccl_group import mesh_ppermute

    mesh = make_mesh(dp=8)
    perm = [(i, (i + 1) % 8) for i in range(8)]
    return mesh_ppermute(torch.arange(8.0)[_rank():_rank() + 1], mesh,
                         perm, "dp").numpy()


def _all_to_all():
    from ray_tpu_torch.collective.nccl_group import mesh_all_to_all

    mesh = make_mesh(dp=8)
    x = torch.arange(64.0).reshape(8, 8)[_rank():_rank() + 1]  # row r
    return mesh_all_to_all(x, mesh, "dp", split_axis=1,
                           concat_axis=0).numpy()


def _multi_axis():
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel import NamedSharding, distribute

    mesh = make_mesh(dp=2, tp=4, device_type="cpu")
    pl = NamedSharding(mesh, P(("dp",), "tp")).placements
    x = distribute(torch.ones((8, 8)), NamedSharding(mesh, P(("dp",), "tp")))

    def f(shard):
        s = shard.clone()
        dist.all_reduce(s, group=mesh.get_group("dp"))
        dist.all_reduce(s, group=mesh.get_group("tp"))
        return s

    out = local_map(f, out_placements=list(pl), in_placements=(pl,),
                    device_mesh=mesh)(x)
    return out.full_tensor().numpy()


def _multislice():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel import NamedSharding, axis_sizes, distribute

    mesh = make_multislice_mesh(dcn={"dp": 2}, ici={"fsdp": 2, "tp": 2},
                                devices=list(range(8)), num_slices=2,
                                device_type="cpu")
    sizes = axis_sizes(mesh)
    dp_axis = list(mesh.mesh_dim_names).index("dp")
    first = mesh.mesh.select(dp_axis, 0).flatten().tolist()
    sh = NamedSharding(mesh, P("dp"))
    x = distribute(torch.arange(8.0), sh)

    def f(shard):
        s = shard.clone()
        dist.all_reduce(s, group=mesh.get_group("dp"))
        return s

    out = local_map(f, out_placements=[Replicate()] * 6,
                    in_placements=(sh.placements,), device_mesh=mesh)(x)
    return sizes, sorted(first), out.to_local().numpy()


def _local():
    from ray_tpu_torch.parallel import axis_sizes, local_mesh, slice_groups

    return (axis_sizes(local_mesh(device_type="cpu")),
            slice_groups(list(range(8))))


def _grads():
    from ray_tpu_torch.collective.nccl_group import (mesh_all_to_all,
                                                     mesh_ppermute)

    mesh = make_mesh(dp=8)
    r = _rank()
    x = torch.full((2, 8), float(r), requires_grad=True)
    w = torch.arange(16.0).reshape(2, 8) + 100 * r
    perm = [(i, (i + 1) % 8) for i in range(8)]
    (mesh_ppermute(x, mesh, perm, "dp") * w).sum().backward()
    gp = x.grad.clone()
    x.grad = None
    (mesh_all_to_all(x, mesh, "dp", split_axis=1, concat_axis=0)
     * torch.arange(16.0).reshape(16, 1)).sum().backward()
    return gp.numpy(), x.grad.numpy()


# -- the cases ------------------------------------------------------------


def test_mesh_resolve_fill():
    spec = MeshSpec(dp=-1, tp=2).resolve(8)
    assert spec.dp == 4 and spec.tp == 2


def test_mesh_build_shapes(pool):
    for sizes in pool.run(_build_shapes):
        assert sizes["dp"] == 2 and sizes["tp"] == 4
        assert sizes["pp"] == 1


def test_mesh_bad_shape(pool):
    assert all(pool.run(_bad_shape))


def test_spec_from_logical_collapses_size1_axes(pool):
    for s, s2 in pool.run(_specs):
        # embed->fsdp (size 1 -> None), heads->tp (size 1 -> None)
        assert s == P()
        assert s2 == P("fsdp", "tp")


def test_tree_sharding_placement(pool):
    for spec, local, full in pool.run(_tree_placement):
        assert spec == P("fsdp", "tp")
        assert local == (4, 4)
        assert np.allclose(full, 1.0)


def test_mesh_allreduce_sum(pool):
    out = np.concatenate(pool.run(_allreduce))
    # each rank's chunk replaced by the sum over ranks of its position
    chunks = np.arange(16.0).reshape(8, 2)
    assert np.allclose(out, np.tile(chunks.sum(0), 8))


def test_mesh_allgather(pool):
    for out in pool.run(_allgather):   # every rank holds the whole
        assert np.allclose(out, np.arange(8.0))


def test_mesh_reducescatter(pool):
    out = np.concatenate(pool.run(_reducescatter))
    assert out.shape == (8, 2)  # each rank owns its reduced chunk of 2
    assert np.allclose(out, 8.0)


def test_mesh_broadcast(pool):
    assert np.allclose(np.concatenate(pool.run(_broadcast)), 3.0)


def test_mesh_ppermute_ring(pool):
    out = np.concatenate(pool.run(_ppermute_ring))
    assert np.allclose(out, np.roll(np.arange(8.0), 1))


def test_mesh_all_to_all(pool):
    out = np.concatenate(pool.run(_all_to_all))
    assert out.shape == (64, 1)
    assert np.allclose(out.reshape(8, 8), np.arange(64.0).reshape(8, 8).T)


def test_multi_axis_collective(pool):
    for out in pool.run(_multi_axis):
        assert np.allclose(out, 8.0)


def test_multislice_mesh_layout(pool):
    """The dcn axis spans the hosts; every ici axis stays on one host."""
    for sizes, first, out in pool.run(_multislice):
        assert sizes["dp"] == 2 and sizes["fsdp"] == 2 and sizes["tp"] == 2
        assert first == [0, 1, 2, 3]          # dp index 0: host 0's ranks
        np.testing.assert_allclose(out, np.arange(8.0).reshape(2, 4).sum(0))


def test_multislice_mesh_validation():
    devs = list(range(8))
    with pytest.raises(ValueError, match="exactly one DCN axis"):
        make_multislice_mesh(dcn={"dp": 2, "pp": 2}, ici={}, devices=devs)
    with pytest.raises(ValueError, match="slices"):
        make_multislice_mesh(dcn={"dp": 3}, ici={"tp": 2}, devices=devs,
                             num_slices=2)
    with pytest.raises(ValueError, match="devices not divisible"):
        make_multislice_mesh(dcn={"dp": 3}, ici={"tp": 2}, devices=devs,
                             num_slices=3)


def test_local_mesh_and_hosts(pool):
    """Every rank here is on one host: the local mesh is all eight along
    dp, and the ranks form one host group."""
    for sizes, groups in pool.run(_local):
        assert sizes["dp"] == 8 and groups == [list(range(8))]


def test_ppermute_and_all_to_all_gradients(pool):
    """The gradient of a ring shift is the shift back; that of an
    all-to-all the all-to-all with its axes swapped."""
    res = pool.run(_grads)
    for r, (gp, ga) in enumerate(res):
        # rank r's x went to rank r+1, whose weights are arange + 100(r+1)
        nxt = (r + 1) % 8
        np.testing.assert_array_equal(
            gp, np.arange(16.0).reshape(2, 8) + 100 * nxt)
        # column j of rank r's x went to rank j as its rows 2r, 2r+1,
        # weighted 2r and 2r+1 there
        want = np.array([[2.0 * r] * 8, [2.0 * r + 1] * 8])
        np.testing.assert_array_equal(ga, want)


def test_world_one_mesh_without_a_group():
    """Every axis 1 in a process that joined no group: world 1, no
    collective needed to place or gather."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = make_mesh(device_type="cpu")
    x = shard_tree({"w": np.arange(6.0, dtype=np.float32)},
                   {"w": Logical("mlp")}, mesh)["w"]
    assert spec_of(x) == P() and x.to_local().shape == (6,)
    np.testing.assert_array_equal(x.full_tensor().numpy(), np.arange(6.0))
    with pytest.raises(ValueError, match="needs torch.distributed"):
        make_mesh(dp=2, devices=[0, 1], device_type="cpu")
