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

This is gpd_tpu's loop path (cem.py:255-361). PyTorch runs eagerly, so
gpd_tpu's fused ``_cem_fused`` program, which gives the same results, has no
counterpart. With ``mesh=`` (a ``parallel.sharded.Mesh``; every rank calls
``detect``) each round's candidates come from ``candidates_sharded_raw`` on
the rank's shard of the round's samples, the mixture centers accumulate from
the gathered round in gpd_tpu's layout (each round's slots padded to a
multiple of the mesh size, cem.py:281-289; MAX_OF_GAUSSIANS picks centers by
slot), and each round is scored by ``score_sharded_raw``; every rank returns
the same grasps. Every draw comes from ``ops/draws.py``. Under
GPD_TPU_PROFILE a request is traced (``profiling.maybe_trace``), its three
phases as spans (``cem_rounds``, ``cem_scoring``, ``select_and_cluster``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from gpd_tpu_torch import profiling
from gpd_tpu_torch.config import CEMConfig
from gpd_tpu_torch.core.types import CloudArrays, Grasps
from gpd_tpu_torch.detector import (GraspDetector, candidates_stage,
                                    score_candidates, select_and_cluster)
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops import preprocess as pp
from gpd_tpu_torch.parallel import sharded

SUM_OF_GAUSSIANS = draws.SUM_OF_GAUSSIANS
MAX_OF_GAUSSIANS = draws.MAX_OF_GAUSSIANS


class SequentialImportanceSampling:
    """CEM grasp detector (reference: include/gpd/
    sequential_importance_sampling.h) on the detector's device, sharded over
    ``mesh`` when one is given."""

    def __init__(self, detector: GraspDetector, cem: CEMConfig,
                 mesh: Optional[sharded.Mesh] = None):
        self.detector = detector
        self.cem = cem
        self.mesh = mesh
        # Stats of the last detect() call (the reference prints these,
        # sequential_importance_sampling.cpp:105-186).
        self.last_round_counts = []
        self.last_num_grasps = 0
        self.last_runtime_s = 0.0

    def detect(self, cloud: CloudArrays,
               generator: Optional[torch.Generator] = None,
               verbose: bool = True) -> Grasps:
        det = self.detector
        cem = self.cem
        mesh = self.mesh
        gen = det._generator(generator)
        with profiling.maybe_trace():
            t0 = time.perf_counter()
            net = det.net
            n_dev = 1
            if mesh is not None:
                cloud = sharded.replicate(mesh, cloud)
                net = sharded.replicate(mesh, net)
                n_dev = mesh.size
            cfg = det.effective_config(cloud)

            per = cem.num_samples_per_iteration
            n_rand = int(cem.prob_rand_samples * per)
            n_gauss = per - n_rand
            cap = det.image_cap(-(-per // n_dev))
            M = cfg.num_orientations * len(cfg.hand_axes)

            def rcap(s):
                """A round's slots: its samples padded to a multiple of the
                mesh size, times the hands per sample."""
                return (s + (-s) % n_dev) * M

            # 1. Initial hypotheses at uniform samples (.cpp:71-78).
            idx, valid = pp.subsample_uniform(gen, cloud.mask,
                                              cem.num_init_samples)
            sample_pos = torch.where(valid[:, None], cloud.points[idx], 1e6)

            # Mixture centers: every round's candidate samples, written into
            # a buffer of all rounds' capacity (gpd_tpu's _accum_centers).
            n_slots = (rcap(cem.num_init_samples)
                       + cem.num_iterations * rcap(per))
            centers = torch.zeros((n_slots, 3), device=cloud.device)
            cmask = torch.zeros(n_slots, dtype=torch.bool, device=cloud.device)
            rounds = []

            def run_round(spos, smask):
                """Candidates only (generateGraspCandidates + filters, no
                CNN); with a mesh, this rank's shard and the gathered
                round."""
                if mesh is None:
                    g = candidates_stage(cloud, spos, smask, cfg)
                else:
                    spos, smask = sharded.shard_samples(mesh, spos, smask)
                    g = sharded.candidates_sharded_raw(cloud, spos, smask,
                                                       cfg, mesh)
                ofs = sum(r[0].capacity for r in rounds)
                centers[ofs:ofs + g.capacity] = g.sample
                cmask[ofs:ofs + g.capacity] = g.valid
                rounds.append((g, spos, smask))

            with profiling.span("cem_rounds"):
                run_round(sample_pos, valid)
                # 2. Importance-sampling rounds (.cpp:112-157): candidates
                # only.
                for _ in range(cem.num_iterations):
                    spos = draws.cem_round(
                        gen, centers, cmask, cloud.points, cloud.mask,
                        cem.standard_deviation, tuple(cfg.workspace),
                        cem.sampling_method, n_gauss, n_rand)
                    run_round(spos, torch.ones(spos.shape[0],
                                               dtype=torch.bool,
                                               device=spos.device))

            # 3. Classify every round's candidates with its own sample
            # context (neighborhoods and shadows are per sample), then prune
            # by score (pruneGraspCandidates, grasp_detector.cpp:529-552).
            with profiling.span("cem_scoring"):
                if mesh is None:
                    scored = [score_candidates(cloud, g, spos, smask, net,
                                               gen, cfg, cap)[0]
                              for g, spos, smask in rounds]
                else:
                    scored = [sharded.score_sharded_raw(
                        cloud, g, spos, smask, net, gen, cfg, cap, mesh)
                        for g, spos, smask in rounds]
                merged = Grasps(**{f.name: torch.cat([getattr(s, f.name)
                                                      for s in scored])
                                   for f in dataclasses.fields(Grasps)})
                merged = dataclasses.replace(merged, valid=merged.valid & (
                    merged.score > cem.min_score))

            # 4. Cluster + final ordering (.cpp:174-186).
            with profiling.span("select_and_cluster"):
                out = select_and_cluster(merged, cfg)
                counts = [int(c) for c in torch.stack(
                    [g.valid.sum() for g, _, _ in rounds]).cpu()]
                n_final = int(out.valid.sum())
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
