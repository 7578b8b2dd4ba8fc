"""Candidate-parallel detection over a process group (port of
gpd_tpu/parallel/sharded.py).

gpd_tpu shards a cloud's sample axis over the devices of one process with
``shard_map``. The port runs one process per device (``parallel``'s
docstring): every rank calls these functions with the replicated cloud and
its own contiguous shard of the sample axis (``shard_samples``), runs the
single-device stage on it, and the surviving grasp batches are gathered in
rank order. Every rank gets the same merged batch, laid out as gpd_tpu's
``out_specs=P(axis)``: rank-major, each rank's local hand-search layout,
``sample_id`` local to the rank's shard.

Draws. Every rank passes a generator seeded alike; the draws that must
agree across ranks (sampling, CEM's rounds) come from it in lockstep. The
scoring draws (shadow jitter, RANSAC) come from a per-rank generator
seeded with one int64 drawn from the caller's generator plus the rank
(``rank_generator``), the port's form of gpd_tpu's
``jax.random.fold_in(key, axis_index)``: scores, not geometry, depend on
the rank split, as in gpd_tpu.

Collectives: ``torch.distributed`` all-gathers (bool fields as uint8) and
broadcasts, NCCL between cards, gloo between CPU processes.

Programs. gpd_tpu jits each sharded function, so each rank's part runs as
device programs and reads nothing back to the host. Given an ``owner``, the
``GraspDetector`` whose ``net`` they score with, the functions here run
each rank's part as the owner's programs (``graphs.Programs.run``): on its
card CUDA graphs per static key, in its graphs and its one pool beside
``detect``'s, captured at a key's first call; on the CPU the same programs
eagerly. ``detect_sharded_raw`` is ``detect``'s A, the read of A's counts
and B on the rank's samples; ``candidates_sharded_raw`` and
``score_sharded_raw`` are one program each, with no read; the selection is
one program on the gathered batch. The collectives (``replicate``, the
gathers) and ``rank_generator``'s read stay outside the programs, and every
batch gathered from a program's outputs is a copy, which the next replay
leaves alone. Without an owner each function runs its eager body, which
reads its block and chunk counts back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from gpd_tpu_torch.config import DetectorConfig
from gpd_tpu_torch.core.types import CloudArrays, Grasps
from gpd_tpu_torch.detector import (candidates_stage, detect_core,
                                    score_candidates, select_and_cluster)
from gpd_tpu_torch.graphs import clone_tree
from gpd_tpu_torch.net import lenet


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's 1-D ("dp") mesh: the process group, this process's rank
    in it, its size and the device its collectives run on. ``group`` None
    is a world of one with no process group, in which no collective runs
    (gpd_tpu's one-device mesh)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: Optional[torch.device]


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The whole default process group as a mesh, one device per rank (NCCL:
    this process's card; gloo: the CPU); a world of one without a process
    group. ``n_devices``, if given, must be the world size."""
    if not dist.is_initialized():
        size, rank, group, device = 1, 0, None, None
    else:
        size, rank = dist.get_world_size(), dist.get_rank()
        group = dist.group.WORLD
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the mesh is the whole process group ({size} "
                         f"processes, one device each), not {n_devices}")
    return Mesh(group, rank, size, device)


def shard_samples(mesh: Mesh, sample_pos: torch.Tensor,
                  sample_mask: torch.Tensor):
    """This rank's contiguous rows of the sample axis, padded to a multiple
    of the mesh size with positions at 1e6 and mask False."""
    n = mesh.size
    pad = (-sample_pos.shape[0]) % n
    if pad:
        sample_pos = torch.cat([sample_pos, sample_pos.new_full((pad, 3),
                                                                1e6)])
        sample_mask = torch.cat([sample_mask, sample_mask.new_zeros(pad)])
    per = sample_pos.shape[0] // n
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return sample_pos[rows], sample_mask[rows]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as a collective sends it: bool as uint8 (gloo lacks bool),
    contiguous."""
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def _broadcast(mesh: Mesh, t: torch.Tensor, shape) -> torch.Tensor:
    """Rank 0's tensor of ``shape`` on every rank."""
    x = _wire(t)
    if mesh.rank != 0 and tuple(x.shape) != tuple(shape):
        x = x.new_empty(shape)
    dist.broadcast(x, src=0, group=mesh.group)
    return x.bool() if t.dtype == torch.bool else x


def replicate(mesh: Mesh, tree):
    """Rank 0's tensors on every rank: a dataclass of tensors
    (``CloudArrays``; a new object of rank 0's shapes, which another
    rank's may not share) or a module (its parameters and buffers
    overwritten in place)."""
    if mesh.group is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in [*tree.parameters(), *tree.buffers()]:
                dist.broadcast(t.data, src=0, group=mesh.group)
        return tree
    fields = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    shapes = [[tuple(t.shape) for t in fields.values()]]
    dist.broadcast_object_list(shapes, src=0, group=mesh.group,
                               device=mesh.device)
    return type(tree)(**{k: _broadcast(mesh, t, s)
                         for (k, t), s in zip(fields.items(), shapes[0])})


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated in rank order."""
    x = _wire(t)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


def gather_grasps(mesh: Mesh, grasps: Grasps) -> Grasps:
    """The ranks' grasp batches concatenated in rank order, on every rank,
    in new tensors: one all-gather per wire dtype (float32, int64, uint8),
    each of the fields of that dtype side by side; a copy without a
    process group."""
    if mesh.group is None:
        return clone_tree(grasps)
    by_dtype = {}
    for f in dataclasses.fields(Grasps):
        t = getattr(grasps, f.name)
        w = _wire(t).reshape(grasps.capacity, -1)
        by_dtype.setdefault(w.dtype, []).append((f.name, t, w))
    out = {}
    for items in by_dtype.values():
        merged = _gather(mesh, torch.cat([w for _, _, w in items], dim=1))
        parts = merged.split([w.shape[1] for _, _, w in items], dim=1)
        for (name, t, _), part in zip(items, parts):
            part = part.reshape((-1,) + t.shape[1:]).contiguous()
            out[name] = part.bool() if t.dtype == torch.bool else part
    return Grasps(**out)


def rank_generator(mesh: Mesh, generator: torch.Generator) -> torch.Generator:
    """This rank's scoring generator: one int64 drawn from ``generator``
    (the same on every rank, whose generators draw in lockstep) plus the
    rank."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(
        seed + mesh.rank)


def _check_owner(owner, net: lenet.LeNet) -> None:
    """The owner's programs score with its own net: a graph keyed by another
    net's identity would keep that net alive, out of reach of the owner's
    ``net`` setter, which drops the graphs of the net it replaces."""
    if net is not owner.net:
        raise ValueError("the owner's programs score with owner.net; "
                         "another net was given")


def detect_sharded_raw(cloud: CloudArrays, sample_pos: torch.Tensor,
                       sample_mask: torch.Tensor, net: lenet.LeNet,
                       generator: torch.Generator, cfg: DetectorConfig,
                       image_cap: int, mesh: Mesh, *, owner=None) -> Grasps:
    """Candidate-parallel ``detect_core`` without selection: this rank's
    sample shard (``shard_samples``) scored, then the gathered batch, for a
    caller's own outer loop. With an ``owner``, the rank's part is
    ``detect``'s programs (``GraspDetector._scored_programs``): A on the
    given samples, one read of A's counts, B over the live blocks and
    chunks; ``image_cap`` must be the owner's for the shard."""
    rank_gen = rank_generator(mesh, generator)
    if owner is None:
        g, _ = detect_core(cloud, sample_pos, sample_mask, net, rank_gen,
                           cfg, image_cap, scores_only=True)
        return gather_grasps(mesh, g)
    _check_owner(owner, net)
    if image_cap != owner.image_cap(sample_pos.shape[0]):
        raise ValueError(f"the owner's programs score chunks of "
                         f"{owner.image_cap(sample_pos.shape[0])} hands for "
                         f"{sample_pos.shape[0]} samples, not {image_cap}")
    g, _, _, _ = owner._scored_programs(cloud, sample_pos, sample_mask,
                                        rank_gen, cfg)
    return gather_grasps(mesh, g)


def select_merged(grasps: Grasps, cfg: DetectorConfig,
                  owner=None) -> Grasps:
    """``select_and_cluster`` of a gathered batch; with an ``owner``, a copy
    of its program's outputs, the batch copied into the program's inputs.
    Its key holds what the program's shapes follow from: the device, the
    batch's capacity and the config."""
    if owner is None:
        return select_and_cluster(grasps, cfg)
    key = ("sharded_select", grasps.valid.device, grasps.capacity, cfg)
    return clone_tree(owner.programs.run(
        key, lambda _, g: select_and_cluster(g, cfg), (grasps,)))


def sharded_detect(cloud: CloudArrays, sample_pos: torch.Tensor,
                   sample_mask: torch.Tensor, net: lenet.LeNet,
                   generator: torch.Generator, cfg: DetectorConfig,
                   image_cap: int, mesh: Mesh, *, owner=None) -> Grasps:
    """Candidate-parallel detection: ``detect_sharded_raw``, then one global
    selection and clustering over the merged set (the same on every rank;
    ``select_merged``)."""
    return select_merged(detect_sharded_raw(
        cloud, sample_pos, sample_mask, net, generator, cfg, image_cap, mesh,
        owner=owner), cfg, owner)


def candidates_sharded_raw(cloud: CloudArrays, sample_pos: torch.Tensor,
                           sample_mask: torch.Tensor, cfg: DetectorConfig,
                           mesh: Mesh, *, owner=None) -> Grasps:
    """Candidate-parallel ``candidates_stage`` (no descriptors, no CNN), the
    per-round work of CEM: the gathered batch, whose rank-major blocks give
    each rank back its own candidates. With an ``owner``, one program that
    reads nothing back (``host_reads=False``) and draws nothing, keyed by
    the device, the cloud's capacity and camera count, the config and the
    shard's sample count."""
    if owner is None:
        g = candidates_stage(cloud, sample_pos, sample_mask, cfg)
    else:
        key = ("sharded_candidates", cloud.device, cloud.capacity,
               cloud.num_cameras, cfg, sample_pos.shape[0])
        g = owner.programs.run(key, lambda _, c, p, m: candidates_stage(
            c, p, m, cfg, host_reads=False), (cloud, sample_pos, sample_mask))
    return gather_grasps(mesh, g)


def score_sharded_raw(cloud: CloudArrays, grasps: Grasps,
                      sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                      net: lenet.LeNet, generator: torch.Generator,
                      cfg: DetectorConfig, image_cap: int,
                      mesh: Mesh, *, owner=None) -> Grasps:
    """Candidate-parallel ``score_candidates`` of a batch from
    ``candidates_sharded_raw`` on the same sample shards: each rank scores
    its own block, then the gathered scored batch. With an ``owner``, one
    program that runs every block and chunk and reads nothing back
    (``host_reads=False``, as gpd_tpu's device loop), keyed as
    ``candidates_sharded_raw``'s and by the net and ``image_cap``; it
    draws from this rank's generator (``rank_generator``)."""
    per = grasps.capacity // mesh.size
    mine = grasps.take(slice(mesh.rank * per, (mesh.rank + 1) * per))
    rank_gen = rank_generator(mesh, generator)
    if owner is None:
        g, _ = score_candidates(cloud, mine, sample_pos, sample_mask, net,
                                rank_gen, cfg, image_cap, scores_only=True)
        return gather_grasps(mesh, g)
    _check_owner(owner, net)
    key = ("sharded_score", cloud.device, cloud.capacity, cloud.num_cameras,
           cfg, sample_pos.shape[0], id(net), image_cap)
    g, _ = owner.programs.run(key, lambda r, c, b, p, m: score_candidates(
        c, b, p, m, net, r, cfg, image_cap, host_reads=False),
        (cloud, mine, sample_pos, sample_mask), rank_gen)
    return gather_grasps(mesh, g)


def sharded_detect_host(detector, cloud: CloudArrays,
                        sample_pos: Optional[torch.Tensor] = None,
                        sample_mask: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        mesh: Optional[Mesh] = None) -> Grasps:
    """``sharded_detect`` for a ``GraspDetector``: rank 0's cloud and
    weights replicated, the samples (drawn as ``detect`` draws them when
    not given) sharded, image chunks of ``detector.image_cap`` of a rank's
    shard, and the detector's ``effective_config`` as ``detect`` uses it.
    The detector owns the programs, but under its test hook
    ``_force_eager``, which takes the eager bodies."""
    mesh = mesh or default_mesh()
    gen = detector._generator(generator)
    cloud = replicate(mesh, cloud)
    replicate(mesh, detector.net)
    if sample_pos is None:
        sample_pos, sample_mask = detector.sample_cloud(cloud, gen)
    spos, smask = shard_samples(mesh, sample_pos, sample_mask)
    return sharded_detect(cloud, spos, smask, detector.net, gen,
                          detector.effective_config(cloud),
                          detector.image_cap(spos.shape[0]), mesh,
                          owner=None if detector._force_eager else detector)
