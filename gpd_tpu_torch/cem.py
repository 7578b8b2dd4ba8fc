"""Sequential importance sampling (CEM) outer loop (port of gpd_tpu/cem.py).

The reference's ``SequentialImportanceSampling::detectGrasps``
(src/gpd/sequential_importance_sampling.cpp:54-270): round 0 evaluates
candidates at uniformly subsampled cloud points; each importance-sampling
round draws fresh samples from a Gaussian mixture over the accumulated
candidates' samples (plus uniform cloud draws) and runs the candidates-only
stage, as the reference's loop does no classification (.cpp:112-157);
descriptors and the CNN then score every round's candidates with that
round's own sample positions (pruneGraspCandidates,
grasp_detector.cpp:529-552), and the survivors go through selection and
clustering.

Two routes, as in gpd_tpu (cem.py:231-361), through one body,
``_cem_program``:

  - Without a mesh the whole request is ONE program, the counterpart of
    gpd_tpu's fused ``_cem_fused`` (cem.py:132-195): round 0, the
    importance-sampling rounds, every round's scoring pass, the score
    prune and the selection, with no read back to the host. On a card it
    runs as one CUDA graph, captured once per static key and replayed
    (``SequentialImportanceSampling.graphs``, every key in one memory
    pool; jax.jit compiles ``_cem_fused`` once per set of static
    arguments); on the CPU the same program runs eagerly. The round counts
    and the final count are read once, after it.
  - With ``mesh=`` (a ``parallel.sharded.Mesh``; every rank calls
    ``detect``), or with the test hook ``_force_loop``, gpd_tpu's Python
    round loop (cem.py:255-361), the same body. Without a mesh it reads
    each scoring pass's valid count. With a mesh each round's candidates
    come from ``candidates_sharded_raw`` on the rank's shard of the round's
    samples, the mixture centers accumulate from the gathered round in
    gpd_tpu's layout (each round's slots padded to a multiple of the mesh
    size, cem.py:281-289; MAX_OF_GAUSSIANS picks centers by slot), and each
    round is scored by ``score_sharded_raw``; every rank returns the same
    grasps. The mesh loop runs, as gpd_tpu's does, through programs only:
    each round's candidates, each round's draw (``_draw_round``), each
    scoring pass and the selection are programs of the detector
    (``parallel.sharded``'s ``owner``; CUDA graphs on its card), with the
    gathers and the prune between them, and the round counts and the final
    count are read once, after the selection. Under the detector's test
    hook ``_force_eager`` the mesh loop takes the sharded functions' eager
    bodies, which read their counts as they go.

Both routes draw from ``ops/draws.py`` in one order, gpd_tpu's key order
(cem.py:157-170): round 0's subsample, each round's ``cem_round``, then
each scoring pass's shadow and RANSAC draws; on one generator state they
find the same candidates and, up to the float atomics of the card's
rasters, the same grasps. Under GPD_TPU_PROFILE a request is traced
(``profiling.maybe_trace``): the program as one span (``cem_program``,
which on a card holds the graph's launch and the final read; a new key's
warm-up and capture come before it, in ``cem_capture``), the loop as three
(``cem_rounds``, ``cem_scoring``, ``select_and_cluster``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch

from gpd_tpu_torch import profiling
from gpd_tpu_torch.config import CEMConfig, DetectorConfig
from gpd_tpu_torch.core.types import CloudArrays, Grasps
from gpd_tpu_torch.detector import (CapturedGraph, GraspDetector,
                                    candidates_stage, clone_tree,
                                    score_candidates)
from gpd_tpu_torch.net.lenet import LeNet
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops import preprocess as pp
from gpd_tpu_torch.parallel import sharded

SUM_OF_GAUSSIANS = draws.SUM_OF_GAUSSIANS
MAX_OF_GAUSSIANS = draws.MAX_OF_GAUSSIANS


def _merge_pruned(scored: Sequence[Grasps], min_score: float) -> Grasps:
    """Every round's scored candidates in one batch, those scoring at or
    under ``min_score`` pruned (pruneGraspCandidates,
    grasp_detector.cpp:529-552)."""
    merged = Grasps(**{f.name: torch.cat([getattr(s, f.name) for s in scored])
                       for f in dataclasses.fields(Grasps)})
    return dataclasses.replace(merged, valid=merged.valid & (
        merged.score > min_score))


def _draw_round(generator: torch.Generator, centers: torch.Tensor,
                cmask: torch.Tensor, cloud: CloudArrays, sigma: float,
                workspace: tuple, method: int, n_gauss: int, n_rand: int,
                owner: Optional[GraspDetector] = None) -> torch.Tensor:
    """One round's sample positions, ``draws.cem_round``: gpd_tpu's
    ``_draw_round`` (cem.py:42). With an ``owner``, its program, keyed by the
    device, the cloud's capacity, the center buffer's size and the draw's
    static arguments; the centers and their mask are copied in, the draws
    come from ``generator``'s state through the graph's own generator
    (``GraspDetector._run_drawing``), and the positions come back as a
    copy, which the rounds keep past the next replay."""
    def program(g, c, m, points, pmask):
        return draws.cem_round(g, c, m, points, pmask, sigma, workspace,
                               method, n_gauss, n_rand)
    inputs = (centers, cmask, cloud.points, cloud.mask)
    if owner is None:
        return program(generator, *inputs)
    key = ("cem_round", cloud.device, cloud.capacity, centers.shape[0],
           method, n_gauss, n_rand, sigma, workspace)
    return owner._run_drawing(key, program, inputs, generator).clone()


def _cem_program(cloud: CloudArrays, net: LeNet, generator: torch.Generator,
                 cfg: DetectorConfig, n_init: int, n_iter: int, n_gauss: int,
                 n_rand: int, method: int, image_cap: int, sigma: float,
                 min_score: float, mesh: Optional[sharded.Mesh] = None,
                 host_reads: bool = False,
                 owner: Optional[GraspDetector] = None
                 ) -> Tuple[Grasps, torch.Tensor]:
    """The whole CEM request, the counterpart of gpd_tpu's ``_cem_fused``
    (gpd_tpu/cem.py:132-195) and of its round loop (:255-361): round 0 at
    uniform samples (.cpp:71-78), ``n_iter`` importance-sampling rounds of
    candidates only, each drawing from the mixture over every earlier
    round's candidate samples (a buffer of all rounds' slots, gpd_tpu's
    ``_accum_centers``), then every round scored with its own sample
    context, the prune, and selection. Returns (grasps, round counts as a
    device tensor).

    With the defaults it is the fused program: no read back to the host,
    every block and chunk run, so the shapes of all its work follow from
    the arguments alone and a CUDA graph can capture it. The loop is the
    same body with ``host_reads`` (each pass skips the blocks and chunks
    past its live count) and its three profiler spans; with ``mesh`` each
    round's candidates and scores come from the sharded stages, and a
    round's slots are its samples padded to a multiple of the mesh size
    (cem.py:281-289); with an ``owner`` too, those stages, each round's
    draw and the selection run as the owner's programs."""
    n_dev = 1 if mesh is None else mesh.size
    M = cfg.num_orientations * len(cfg.hand_axes)
    per = n_gauss + n_rand

    def rcap(s):
        return (s + (-s) % n_dev) * M

    def phase(name):
        return profiling.span(name) if host_reads else contextlib.nullcontext()

    n_slots = rcap(n_init) + n_iter * rcap(per)
    centers = torch.zeros((n_slots, 3), device=cloud.device)
    cmask = torch.zeros(n_slots, dtype=torch.bool, device=cloud.device)
    rounds = []

    def run_round(spos, smask):
        """Candidates only (generateGraspCandidates + filters, no CNN);
        with a mesh, this rank's shard and the gathered round."""
        if mesh is None:
            g = candidates_stage(cloud, spos, smask, cfg,
                                 host_reads=host_reads)
        else:
            spos, smask = sharded.shard_samples(mesh, spos, smask)
            g = sharded.candidates_sharded_raw(cloud, spos, smask, cfg, mesh,
                                               owner=owner)
        ofs = sum(r[0].capacity for r in rounds)
        centers[ofs:ofs + g.capacity] = g.sample
        cmask[ofs:ofs + g.capacity] = g.valid
        rounds.append((g, spos, smask))

    with phase("cem_rounds"):
        idx, valid = pp.subsample_uniform(generator, cloud.mask, n_init)
        run_round(torch.where(valid[:, None], cloud.points[idx], 1e6), valid)
        smask = torch.ones(per, dtype=torch.bool, device=cloud.device)
        for _ in range(n_iter):
            run_round(_draw_round(generator, centers, cmask, cloud, sigma,
                                  tuple(cfg.workspace), method, n_gauss,
                                  n_rand, owner), smask)
    with phase("cem_scoring"):
        if mesh is None:
            scored = [score_candidates(cloud, g, spos, sm, net, generator,
                                       cfg, image_cap,
                                       host_reads=host_reads)[0]
                      for g, spos, sm in rounds]
        else:
            scored = [sharded.score_sharded_raw(cloud, g, spos, sm, net,
                                                generator, cfg, image_cap,
                                                mesh, owner=owner)
                      for g, spos, sm in rounds]
        merged = _merge_pruned(scored, min_score)
    with phase("select_and_cluster"):
        out = sharded.select_merged(merged, cfg, owner)
    return out, torch.stack([g.valid.sum() for g, _, _ in rounds])


def _read_counts(out: Grasps, counts: torch.Tensor) -> Tuple[List[int], int]:
    """The round counts and the final count, in one read."""
    *counts, n_final = torch.cat([counts, out.valid.sum()[None]]).tolist()
    return counts, n_final


class SequentialImportanceSampling:
    """CEM grasp detector (reference: include/gpd/
    sequential_importance_sampling.h) on the detector's device, sharded over
    ``mesh`` when one is given."""

    def __init__(self, detector: GraspDetector, cem: CEMConfig,
                 mesh: Optional[sharded.Mesh] = None):
        self.detector = detector
        self.cem = cem
        self.mesh = mesh
        # The fused program's captured CUDA graphs by static key (see
        # ``graph_key``; the counterpart of jax.jit's cache of _cem_fused),
        # all captured into one memory pool. A request of a seen key
        # captures nothing.
        self.graphs = {}
        self.pool = None
        # Stats of the last detect() call (the reference prints these,
        # sequential_importance_sampling.cpp:105-186).
        self.last_round_counts = []
        self.last_num_grasps = 0
        self.last_runtime_s = 0.0
        # Test hook: force the Python round loop even without a mesh (the
        # fused-vs-loop equivalence tests use it), as gpd_tpu's.
        self._force_loop = False

    def detect(self, cloud: CloudArrays,
               generator: Optional[torch.Generator] = None,
               verbose: bool = True) -> Grasps:
        gen = self.detector._generator(generator)
        with profiling.maybe_trace():
            t0 = time.perf_counter()
            if self.mesh is None and not self._force_loop:
                out, counts, n_final = self._detect_program(cloud, gen)
            else:
                out, counts, n_final = self._detect_loop(cloud, gen)
            self.last_runtime_s = time.perf_counter() - t0
        self.last_round_counts = counts
        self.last_num_grasps = n_final
        if verbose:
            print(f"Initially detected grasp candidates: {counts[0]}")
            for it, c in enumerate(counts[1:]):
                print(f"Added {c} grasp candidates in round {it}.")
            print(f"Final result: found {n_final} grasps.")
            print(f"Total runtime: {self.last_runtime_s:.4f}s")
        return out

    def program_args(self, cloud: CloudArrays, n_dev: int = 1) -> tuple:
        """The static arguments of ``_cem_program`` after (cloud, net,
        generator) for a request on ``cloud`` over ``n_dev`` devices."""
        det, cem = self.detector, self.cem
        per = cem.num_samples_per_iteration
        n_rand = int(cem.prob_rand_samples * per)
        return (det.effective_config(cloud), cem.num_init_samples,
                cem.num_iterations, per - n_rand, n_rand, cem.sampling_method,
                det.image_cap(-(-per // n_dev)), cem.standard_deviation,
                cem.min_score)

    def graph_key(self, cloud: CloudArrays) -> tuple:
        """The static key of a fused request on ``cloud``: the device, the
        cloud's capacity and camera count, the LeNet's identity and the
        program's static arguments."""
        return (cloud.device, cloud.capacity, cloud.num_cameras,
                id(self.detector.net), self.program_args(cloud))

    @property
    def pool_bytes(self) -> int:
        """What the captures of every key have reserved for their pool."""
        return sum(e.pool_bytes for e in self.graphs.values())

    def _detect_program(self, cloud: CloudArrays, gen: torch.Generator
                        ) -> Tuple[Grasps, List[int], int]:
        """The fused route: ``_cem_program`` replayed from its CUDA graph on
        a card (a new key is captured first, in its own span,
        ``cem_capture``), run eagerly on the CPU; then one read of the round
        counts and the final count."""
        net, args = self.detector.net, self.program_args(cloud)
        if cloud.device.type != "cuda":
            with profiling.span("cem_program"):
                out, counts = _cem_program(cloud, net, gen, *args)
                return (out, *_read_counts(out, counts))
        if gen.device.type != "cuda":
            raise ValueError(f"the CEM program draws on {cloud.device}; the "
                             f"generator is on {gen.device}")
        key = self.graph_key(cloud)
        if key not in self.graphs:
            with profiling.span("cem_capture"):
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                private = torch.Generator(device=cloud.device)
                private.set_state(gen.get_state())
                self.graphs[key] = CapturedGraph(
                    cloud.device, lambda g, c: _cem_program(c, net, g, *args),
                    (cloud,), private, self.pool)
        with profiling.span("cem_program"):
            entry = self.graphs[key]
            entry.gen.set_state(gen.get_state())
            out, counts = clone_tree(entry.replay(cloud))
            gen.set_state(entry.gen.get_state())
            return (out, *_read_counts(out, counts))

    def _detect_loop(self, cloud: CloudArrays, gen: torch.Generator
                     ) -> Tuple[Grasps, List[int], int]:
        """gpd_tpu's Python round loop (cem.py:255-361), sharded with a
        mesh: ``_cem_program`` with its phase spans, host reads without a
        mesh, the detector's programs with one (the eager bodies under its
        ``_force_eager``); then one read of the counts."""
        det, owner, n_dev = self.detector, None, 1
        net = det.net
        if self.mesh is not None:
            cloud = sharded.replicate(self.mesh, cloud)
            net = sharded.replicate(self.mesh, net)
            n_dev = self.mesh.size
            owner = None if det._force_eager else det
        out, counts = _cem_program(cloud, net, gen,
                                   *self.program_args(cloud, n_dev),
                                   mesh=self.mesh, host_reads=True,
                                   owner=owner)
        return (out, *_read_counts(out, counts))
