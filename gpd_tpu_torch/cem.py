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
    round loop (cem.py:255-361): the same body with host reads, each
    scoring pass reading its valid count. With a mesh each round's
    candidates come from ``candidates_sharded_raw`` on the rank's shard of
    the round's samples, the mixture centers accumulate from the gathered
    round in gpd_tpu's layout (each round's slots padded to a multiple of
    the mesh size, cem.py:281-289; MAX_OF_GAUSSIANS picks centers by slot),
    and each round is scored by ``score_sharded_raw``; every rank returns
    the same grasps.

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
from gpd_tpu_torch.detector import (GraspDetector, candidates_stage,
                                    score_candidates, select_and_cluster)
from gpd_tpu_torch.net.lenet import LeNet
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops import images as img
from gpd_tpu_torch.ops import preprocess as pp
from gpd_tpu_torch.parallel import sharded

SUM_OF_GAUSSIANS = draws.SUM_OF_GAUSSIANS
MAX_OF_GAUSSIANS = draws.MAX_OF_GAUSSIANS

# The kernel wrappers whose calls a capture records into its graph.
_KERNELS = (img.raster_blocks, img.raster_sums, img.raster_sums2)


def _merge_pruned(scored: Sequence[Grasps], min_score: float) -> Grasps:
    """Every round's scored candidates in one batch, those scoring at or
    under ``min_score`` pruned (pruneGraspCandidates,
    grasp_detector.cpp:529-552)."""
    merged = Grasps(**{f.name: torch.cat([getattr(s, f.name) for s in scored])
                       for f in dataclasses.fields(Grasps)})
    return dataclasses.replace(merged, valid=merged.valid & (
        merged.score > min_score))


def _cem_program(cloud: CloudArrays, net: LeNet, generator: torch.Generator,
                 cfg: DetectorConfig, n_init: int, n_iter: int, n_gauss: int,
                 n_rand: int, method: int, image_cap: int, sigma: float,
                 min_score: float, mesh: Optional[sharded.Mesh] = None,
                 host_reads: bool = False) -> Tuple[Grasps, torch.Tensor]:
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
    (cem.py:281-289)."""
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
            g = sharded.candidates_sharded_raw(cloud, spos, smask, cfg, mesh)
        ofs = sum(r[0].capacity for r in rounds)
        centers[ofs:ofs + g.capacity] = g.sample
        cmask[ofs:ofs + g.capacity] = g.valid
        rounds.append((g, spos, smask))

    with phase("cem_rounds"):
        idx, valid = pp.subsample_uniform(generator, cloud.mask, n_init)
        run_round(torch.where(valid[:, None], cloud.points[idx], 1e6), valid)
        smask = torch.ones(per, dtype=torch.bool, device=cloud.device)
        for _ in range(n_iter):
            run_round(draws.cem_round(generator, centers, cmask, cloud.points,
                                      cloud.mask, sigma, tuple(cfg.workspace),
                                      method, n_gauss, n_rand), smask)
    with phase("cem_scoring"):
        if mesh is None:
            scored = [score_candidates(cloud, g, spos, sm, net, generator,
                                       cfg, image_cap,
                                       host_reads=host_reads)[0]
                      for g, spos, sm in rounds]
        else:
            scored = [sharded.score_sharded_raw(cloud, g, spos, sm, net,
                                                generator, cfg, image_cap,
                                                mesh)
                      for g, spos, sm in rounds]
        merged = _merge_pruned(scored, min_score)
    with phase("select_and_cluster"):
        out = select_and_cluster(merged, cfg)
    return out, torch.stack([g.valid.sum() for g, _, _ in rounds])


def _read_counts(out: Grasps, counts: torch.Tensor) -> Tuple[List[int], int]:
    """The round counts and the final count, in one read."""
    *counts, n_final = torch.cat([counts, out.valid.sum()[None]]).tolist()
    return counts, n_final


class _Captured:
    """``_cem_program`` captured as one CUDA graph for one static key, with
    the graph's input cloud, its generator and its outputs.

    The capture follows PyTorch's recipe: one eager run on a side stream
    first (it builds the kernels, makes every device constant and sets up
    cuBLAS and cuDNN), then the capture into ``pool``, which every key of
    one ``SequentialImportanceSampling`` shares. Sharing is safe because a
    replay reads no pool memory that it did not write itself, replays run
    one at a time on the caller's stream, and each replay's outputs are
    cloned before the next can start; the pool then holds about one key's
    working set, not the sum over keys. The raster launchers call
    ``cudaFuncSetAttribute`` and the occupancy query during the capture
    too; neither is a stream operation, and a capture accepts both. The
    program draws from a generator registered with the graph, so a replay
    draws what an eager run from the same state draws and advances it as
    far. Anything that cannot be captured (a read back to the host, a
    launch error) raises here.

    The kernel wrappers count their calls as always: the warm-up's, and the
    capture's, whose launches go into the graph (``launches``, per wrapper
    in ``_KERNELS``' order). A replay calls no wrapper; what it runs on
    the card shows in a profiler trace of it."""

    def __init__(self, cloud: CloudArrays, net: LeNet,
                 generator: torch.Generator, args: tuple, pool):
        device = cloud.device
        t0 = time.perf_counter()
        self.net = net               # keeps id(net) of the key taken
        self.cloud = CloudArrays(**{f.name: getattr(cloud, f.name).clone()
                                    for f in dataclasses.fields(CloudArrays)})
        self.gen = torch.Generator(device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.gen.set_state(generator.get_state())
            _cem_program(self.cloud, net, self.gen, *args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.gen)
        before = [k.launches for k in _KERNELS]
        # torch.cuda.graph empties the allocator's cache first; emptied
        # here, the growth of reserved memory is what the capture adds to
        # the pool.
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.graph(self.graph, pool=pool):
            self.out, self.counts = _cem_program(self.cloud, net, self.gen,
                                                 *args)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = [k.launches - b for k, b in zip(_KERNELS, before)]
        self.capture_s = time.perf_counter() - t0

    def replay(self, cloud: CloudArrays, generator: torch.Generator
               ) -> Tuple[Grasps, torch.Tensor]:
        """One request: the cloud into the graph's inputs, the generator's
        state in and back out, one replay. The outputs are clones, so a
        later replay cannot change what a caller holds."""
        for f in dataclasses.fields(CloudArrays):
            getattr(self.cloud, f.name).copy_(getattr(cloud, f.name))
        self.gen.set_state(generator.get_state())
        self.graph.replay()
        generator.set_state(self.gen.get_state())
        return (Grasps(**{f.name: getattr(self.out, f.name).clone()
                          for f in dataclasses.fields(Grasps)}),
                self.counts.clone())


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
                self.graphs[key] = _Captured(cloud, net, gen, args, self.pool)
        with profiling.span("cem_program"):
            out, counts = self.graphs[key].replay(cloud, gen)
            return (out, *_read_counts(out, counts))

    def _detect_loop(self, cloud: CloudArrays, gen: torch.Generator
                     ) -> Tuple[Grasps, List[int], int]:
        """gpd_tpu's Python round loop (cem.py:255-361), sharded with a
        mesh: ``_cem_program`` with host reads and its phase spans."""
        net, n_dev = self.detector.net, 1
        if self.mesh is not None:
            cloud = sharded.replicate(self.mesh, cloud)
            net = sharded.replicate(self.mesh, net)
            n_dev = self.mesh.size
        out, counts = _cem_program(cloud, net, gen,
                                   *self.program_args(cloud, n_dev),
                                   mesh=self.mesh, host_reads=True)
        return (out, *_read_counts(out, counts))
