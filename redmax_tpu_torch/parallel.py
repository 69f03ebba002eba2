"""Batched rollouts sharded over the ranks of a torch.distributed world (the
JAX package's parallel.py, its jax.sharding.Mesh and shard_map become a
DeviceMesh and collectives).

The reference is single-process shared memory (OpenMP over the loop
constraints' PCG rows, Solver.cpp:714); the parallelism here is of another
kind: thousands of independent rollouts (the MPC sampling dimension) split
into contiguous blocks of lanes, one block a rank, with all-reduces in place
of shared accumulation for the objective's reductions.

Mesh dims:
  * "rollout": data parallel over tasks and initial states (the big dim);
  * "model": within-scene parallelism (pcg's constraint rows), size 1 for
    small scenes but present, so that every collective runs on every mesh.

The caller initializes the world (torchrun, or init_process_group with a
FileStore for a world of one). A mesh is made over the world's backend:
NCCL on "cuda", gloo on the CPU; one never stands in for the other, and
without an initialized world make_mesh raises.
"""

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from redmax_tpu_torch.checkpoint import tree_flatten, tree_map, tree_unflatten

_DEVICE_OF_BACKEND = {"nccl": "cuda", "gloo": "cpu"}


def make_mesh(n_devices=None, model: int = 1) -> DeviceMesh:
    """A ("rollout", "model") DeviceMesh of shape (n / model, model) over the
    initialized world's n ranks (n_devices, where given, must be the world
    size), on the world's backend's device ("cuda" for NCCL, "cpu" for
    gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world "
                           "(torchrun, or init_process_group with a FileStore)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans the whole world: n_devices {n}, world size {world}")
    if n % model:
        raise ValueError(f"model {model} does not divide the world size {n}")
    backend = dist.get_backend()
    if backend not in _DEVICE_OF_BACKEND:
        raise ValueError(f"no mesh device for the backend {backend!r}")
    device_type = _DEVICE_OF_BACKEND[backend]
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("an NCCL world needs CUDA")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("rollout", "model"))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(mesh: DeviceMesh, B: int) -> slice:
    """This rank's contiguous block of B lanes: the lanes split over both
    mesh dims, "rollout" major (JAX's P(("rollout", "model")))."""
    n = mesh.size()
    if B % n:
        raise ValueError(f"the batch of {B} lanes does not split over {n} ranks")
    k = B // n
    model = mesh.size(mesh.mesh_dim_names.index("model"))
    r = mesh.get_local_rank("rollout") * model + mesh.get_local_rank("model")
    return slice(r * k, (r + 1) * k)


def shard_batch_arrays(mesh: DeviceMesh, tree):
    """This rank's block of every leaf's leading (lane) dim, on the mesh's
    device."""
    dev = _mesh_device(mesh)
    leaves = tree_flatten(tree)
    if not leaves:
        return tree
    sl = _block(mesh, leaves[0].shape[0])
    return tree_map(lambda x: x[sl].to(dev), tree)


def gather_blocks(tree, dim: int = 0, group=None):
    """Every rank of group's block of every leaf, concatenated along dim in
    the group's rank order (group None: the world, whose rank order is the
    mesh's lane-block order)."""
    n = dist.get_world_size(group)
    out = []
    for x in tree_flatten(tree):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out.append(torch.cat(parts, dim))
    return tree_unflatten(tree, out)


def _finite_mean(mesh: DeviceMesh, objective, reduce_metrics: bool = True):
    """The mean objective over the finite lanes: the finite sum and the
    finite count all-reduced separately over "rollout" then "model" (the
    same value however the lanes fall on the ranks), then divided; inf, not
    0/0, when no lane is finite."""
    finite = torch.isfinite(objective)
    s = torch.where(finite, objective, torch.zeros_like(objective)).sum()
    n = finite.sum().to(s.dtype)
    if reduce_metrics:
        for dim in ("rollout", "model"):
            for x in (s, n):
                dist.all_reduce(x, group=mesh.get_group(dim))
    return torch.where(n > 0, s / torch.clamp_min(n, 1.0), torch.full_like(s, float("inf")))


def sharded_batch(solve_fn: Callable, mesh: DeviceMesh, reduce_metrics: bool = True):
    """Lift a per-task solve into a batched solve sharded over the mesh.

    solve_fn: (params, p0 [np], state0 (one lane), target [3]) -> MpcResult.
    Returns run(params, p0 [B, np], state0 [B, ...], targets [B, 3]) ->
    (MpcResult over the whole batch, the mean finite objective). Each rank
    solves its contiguous block of lanes one lane after another (the port's
    vmap), then the blocks are gathered onto every rank; the mean is
    all-reduced as a finite sum and a finite count (with reduce_metrics;
    else it is this rank's own)."""

    def run(params: Dict, p0, state0, targets):
        sl = _block(mesh, p0.shape[0])
        p0, state0, targets = p0[sl], tree_map(lambda x: x[sl], state0), targets[sl]
        lanes = [solve_fn(params, p0[i], tree_map(lambda x: x[i], state0), targets[i])
                 for i in range(p0.shape[0])]
        res = type(lanes[0])(*(torch.stack(f) for f in zip(*lanes)))
        mean = _finite_mean(mesh, res.objective, reduce_metrics)
        return gather_blocks(res), mean

    return run


def sharded_mpc_batched(solve_batched: Callable, mesh: DeviceMesh):
    """Shard an explicitly batched MPC solve (mpc.make_mpc_solver_batched)
    over the mesh: each rank passes its contiguous block of lanes whole (on
    the card, the chord kernel takes the block's lanes). run(params, P0
    [B, np], state0 [B, ...], targets [B, 3]) -> (MpcResult over the whole
    batch, the mean finite objective, all-reduced as in sharded_batch)."""

    def run(params: Dict, P0, state0, targets):
        sl = _block(mesh, P0.shape[0])
        res = solve_batched(params, P0[sl], tree_map(lambda x: x[sl], state0), targets[sl])
        mean = _finite_mean(mesh, res.objective)
        return gather_blocks(res), mean

    return run
