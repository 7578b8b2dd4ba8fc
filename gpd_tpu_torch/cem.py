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
    prune and the selection, with no read back to the host. It runs as two
    programs back to back, R (the rounds) and S (the scoring, the prune and
    the selection, reading R's outputs in place): on a card two CUDA
    graphs, captured once per static key and replayed
    (``SequentialImportanceSampling.graphs``, every key in one memory
    pool; jax.jit compiles ``_cem_fused`` once per set of static
    arguments), on the CPU eagerly. The round counts and the final count
    are read once, after it.
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
(``profiling.maybe_trace``), the whole ``detect`` call in the span
``cem_detect``: the program in ``cem_program``, which holds R
(``cem_rounds``) and S and the final read (``cem_scoring``; a new key's
warm-up and capture of each, in ``cem_capture``), the loop in three
(``cem_rounds``, ``cem_scoring``, ``select_and_cluster``). A request
leaves its counters in ``last_counts`` and its scored batch, every
round's scored slots before the prune, in ``last_scored``.
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
from gpd_tpu_torch.detector import (GraspDetector, candidates_stage,
                                    score_candidates)
from gpd_tpu_torch.graphs import Programs, clone_tree
from gpd_tpu_torch.net.lenet import LeNet
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops import preprocess as pp
from gpd_tpu_torch.parallel import sharded

SUM_OF_GAUSSIANS = draws.SUM_OF_GAUSSIANS
MAX_OF_GAUSSIANS = draws.MAX_OF_GAUSSIANS


def _merge(scored: Sequence[Grasps]) -> Grasps:
    """Every round's scored candidates in one batch, before the prune."""
    return Grasps(**{f.name: torch.cat([getattr(s, f.name) for s in scored])
                     for f in dataclasses.fields(Grasps)})


def _draw_round(generator: torch.Generator, centers: torch.Tensor,
                cmask: torch.Tensor, cloud: CloudArrays, sigma: float,
                workspace: tuple, method: int, n_gauss: int, n_rand: int,
                owner: Optional[GraspDetector] = None) -> torch.Tensor:
    """One round's sample positions, ``draws.cem_round``: gpd_tpu's
    ``_draw_round`` (cem.py:42). With an ``owner``, its program, keyed by the
    device, the cloud's capacity, the center buffer's size and the draw's
    static arguments; the centers and their mask are copied in, the draws
    come from ``generator``'s state through the graph's own generator
    (``graphs.Programs.run``), and the positions come back as a
    copy, which the rounds keep past the next replay."""
    def program(g, c, m, points, pmask):
        return draws.cem_round(g, c, m, points, pmask, sigma, workspace,
                               method, n_gauss, n_rand)
    inputs = (centers, cmask, cloud.points, cloud.mask)
    if owner is None:
        return program(generator, *inputs)
    key = ("cem_round", cloud.device, cloud.capacity, centers.shape[0],
           method, n_gauss, n_rand, sigma, workspace)
    return owner.programs.run(key, program, inputs, generator).clone()


def _phase(name: str, on: bool):
    """The loop's phase span ``name`` (``on``), else nothing."""
    return profiling.span(name) if on else contextlib.nullcontext()


def _cem_rounds(cloud: CloudArrays, generator: torch.Generator,
                cfg: DetectorConfig, n_init: int, n_iter: int, n_gauss: int,
                n_rand: int, method: int, sigma: float,
                mesh: Optional[sharded.Mesh] = None, host_reads: bool = False,
                owner: Optional[GraspDetector] = None
                ) -> Tuple[tuple, torch.Tensor]:
    """Round 0 at uniform samples (.cpp:71-78), then ``n_iter``
    importance-sampling rounds of candidates only, each drawing from the
    mixture over every earlier round's candidate samples (a buffer of all
    rounds' slots, gpd_tpu's ``_accum_centers``). Returns (each round's
    (candidates, sample positions, sample mask), the rounds' valid counts
    as a device tensor)."""
    n_dev = 1 if mesh is None else mesh.size
    M = cfg.num_orientations * len(cfg.hand_axes)
    per = n_gauss + n_rand

    def rcap(s):
        return (s + (-s) % n_dev) * M

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

    idx, valid = pp.subsample_uniform(generator, cloud.mask, n_init)
    run_round(torch.where(valid[:, None], cloud.points[idx], 1e6), valid)
    smask = torch.ones(per, dtype=torch.bool, device=cloud.device)
    for _ in range(n_iter):
        run_round(_draw_round(generator, centers, cmask, cloud, sigma,
                              tuple(cfg.workspace), method, n_gauss, n_rand,
                              owner), smask)
    return tuple(rounds), torch.stack([g.valid.sum() for g, _, _ in rounds])


def _cem_scoring(cloud: CloudArrays, rounds: tuple, net: LeNet,
                 generator: torch.Generator, cfg: DetectorConfig,
                 image_cap: int, min_score: float,
                 mesh: Optional[sharded.Mesh] = None,
                 host_reads: bool = False,
                 owner: Optional[GraspDetector] = None
                 ) -> Tuple[Grasps, Grasps, tuple]:
    """Every round scored with its own sample context, the prune and the
    selection. Returns (the selection, the scored batch: every round's
    scored slots before the prune, each round in ``score_candidates``'
    valid-first order and padding, the rounds one after another; and each
    round's (first slot, slots that are its hands) in that batch, static)."""
    with _phase("cem_scoring", host_reads):
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
        # The prune (pruneGraspCandidates, grasp_detector.cpp:529-552).
        merged = _merge(scored)
        pruned = dataclasses.replace(merged, valid=merged.valid & (
            merged.score > min_score))
    with _phase("select_and_cluster", host_reads):
        out = sharded.select_merged(pruned, cfg, owner)
    starts = [0]
    for s in scored:
        starts.append(starts[-1] + s.capacity)
    slots = tuple((a, g.capacity) for a, (g, _, _) in zip(starts, rounds))
    return out, merged, slots


def _cem_program(cloud: CloudArrays, net: LeNet, generator: torch.Generator,
                 cfg: DetectorConfig, n_init: int, n_iter: int, n_gauss: int,
                 n_rand: int, method: int, image_cap: int, sigma: float,
                 min_score: float, mesh: Optional[sharded.Mesh] = None,
                 host_reads: bool = False,
                 owner: Optional[GraspDetector] = None
                 ) -> Tuple[Grasps, torch.Tensor, Grasps, tuple]:
    """The whole CEM request, the counterpart of gpd_tpu's ``_cem_fused``
    (gpd_tpu/cem.py:132-195) and of its round loop (:255-361): the rounds
    (``_cem_rounds``), then their scoring, the prune and the selection
    (``_cem_scoring``). Returns (grasps, round counts as a device tensor,
    the scored batch, its rounds' slots).

    With the defaults it is the fused program: no read back to the host,
    every block and chunk run, so the shapes of all its work follow from
    the arguments alone and CUDA graphs can capture its two parts. The
    loop is the same body with ``host_reads`` (each pass skips the blocks
    and chunks past its live count) and its three profiler spans; with
    ``mesh`` each round's candidates and scores come from the sharded
    stages, and a round's slots are its samples padded to a multiple of
    the mesh size (cem.py:281-289); with an ``owner`` too, those stages,
    each round's draw and the selection run as the owner's programs."""
    with _phase("cem_rounds", host_reads):
        rounds, counts = _cem_rounds(cloud, generator, cfg, n_init, n_iter,
                                     n_gauss, n_rand, method, sigma, mesh,
                                     host_reads, owner)
    out, scored, slots = _cem_scoring(cloud, rounds, net, generator, cfg,
                                      image_cap, min_score, mesh, host_reads,
                                      owner)
    return out, counts, scored, slots


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
        # The fused route's two programs, R and S, as CUDA graphs by
        # static key (``graph_key`` after the program's name), in one
        # memory pool of their own.
        self.programs = Programs(detector.device)
        # Stats of the last detect() call (the reference prints these,
        # sequential_importance_sampling.cpp:105-186).
        self.last_round_counts = []
        self.last_num_grasps = 0
        self.last_runtime_s = 0.0
        # Counters of the last detect() call, set from its one read:
        # "live_hands", the valid hands of every round (the sum of
        # last_round_counts), and "image_slots", the hand slots its scoring
        # passes imaged and scored (static per key).
        self.last_counts = {}
        # The last request's scored batch (``_cem_scoring``: every round's
        # scored slots before the prune; on a card the graph's own outputs,
        # which the next request rewrites) and each round's (first slot,
        # slots that are its hands) in it.
        self.last_scored: Optional[Grasps] = None
        self.last_round_slots = ()
        # Test hook: force the Python round loop even without a mesh (the
        # fused-vs-loop equivalence tests use it), as gpd_tpu's.
        self._force_loop = False

    def detect(self, cloud: CloudArrays,
               generator: Optional[torch.Generator] = None,
               verbose: bool = True) -> Grasps:
        gen = self.detector._generator(generator)
        with profiling.maybe_trace(), profiling.span("cem_detect"):
            t0 = time.perf_counter()
            if self.mesh is None and not self._force_loop:
                route = self._detect_program
            else:
                route = self._detect_loop
            out, counts, n_final, scored, slots = route(cloud, gen)
            self.last_runtime_s = time.perf_counter() - t0
        self.last_scored, self.last_round_slots = scored, slots
        self.last_round_counts = counts
        self.last_num_grasps = n_final
        self.last_counts = {"live_hands": sum(counts),
                            "image_slots": scored.capacity}
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
    def graphs(self) -> dict:
        """The fused route's CUDA graphs, R's and S's of every key."""
        return self.programs.graphs

    @property
    def pool(self):
        """The memory pool of every graph in ``graphs``."""
        return self.programs.pool

    @property
    def pool_bytes(self) -> int:
        """What the captures of every key have reserved for their pool."""
        return sum(e.pool_bytes for e in self.graphs.values())

    def _detect_program(self, cloud: CloudArrays, gen: torch.Generator
                        ) -> Tuple[Grasps, List[int], int, Grasps, tuple]:
        """The fused route, in the span ``cem_program``: R, ``_cem_rounds``
        (span ``cem_rounds``), then S, ``_cem_scoring`` on R's outputs in
        place, and the one read of the round counts and the final count
        (span ``cem_scoring``), each a program of ``self.programs`` keyed
        by its name and ``graph_key`` (a new key's capture in the span
        ``cem_capture``)."""
        (cfg, n_init, n_iter, n_gauss, n_rand, method, image_cap, sigma,
         min_score) = self.program_args(cloud)
        net, key = self.detector.net, self.graph_key(cloud)
        self.programs.last_graphs = []

        def rounds(g, c):
            # R hands its cloud on: on a card, S reads the graph's copy.
            return c, _cem_rounds(c, g, cfg, n_init, n_iter, n_gauss, n_rand,
                                  method, sigma)
        with profiling.span("cem_program"):
            with profiling.span("cem_rounds"):
                cloud_r, (rounds_out, counts) = self.programs.run(
                    ("cem_rounds",) + key, rounds, (cloud,), gen,
                    capture_span="cem_capture")
            with profiling.span("cem_scoring"):
                out, scored, slots = self.programs.run(
                    ("cem_scoring",) + key,
                    lambda g: _cem_scoring(cloud_r, rounds_out, net, g, cfg,
                                           image_cap, min_score),
                    (), gen, capture_span="cem_capture")
                out = clone_tree(out)
                return (out, *_read_counts(out, counts), scored, slots)

    def _detect_loop(self, cloud: CloudArrays, gen: torch.Generator
                     ) -> Tuple[Grasps, List[int], int, Grasps, tuple]:
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
        out, counts, scored, slots = _cem_program(
            cloud, net, gen, *self.program_args(cloud, n_dev),
            mesh=self.mesh, host_reads=True, owner=owner)
        return (out, *_read_counts(out, counts), scored, slots)
