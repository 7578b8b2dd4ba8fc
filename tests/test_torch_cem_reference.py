"""gpd_tpu_torch's CEM held to the benchmark's plain reference CEM judge
(h100_bench/reference/cem.py) on the CPU, without JAX: one table scene of
the benchmark's CEM cell at a tiny size (8 initial samples, 2 rounds of
16), scored by a LeNet of seeded random weights. The fused route's body
and the loop (``_force_loop``) each pass every number of the cell within
its limit, and a fault planted in the program fails the number that
watches it: the mixture's centres taken from invalid slots too
(draws_off), the score prune skipped (selection_off), and one round's
scores put on another round's hands (score_round_median).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpd_tpu_torch import cem as tcem
from gpd_tpu_torch.config import CEMConfig
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.ops import draws
from test_torch_threads import set_cpu_share

set_cpu_share()

CELL = "gpd15_cem.cem_table_stream"
CEM_KW = dict(num_init_samples=8, num_iterations=2,
              num_samples_per_iteration=16)
# A table scene of the benchmark's generator (seed 101) with two objects
# and fewer points (~1.9k after the voxels) than the cell's, so that the
# judge's float64 pass takes seconds on one CPU.
SCENE = dict(seed=101, n_objects=2, points_per_object=700, table_points=1000)
# The random LeNet's score (positive minus negative logit) is scaled up
# tenfold, as a trained net's spreads over hands, and its positive bias
# lowered to put the score of these hands (near 17 then) about zero, so
# that the prune at min_score 0 removes most hands.
SCORE_SCALE, SCORE_SHIFT = 10.0, 17.0
# Its first convolution reads no shadow channel (the third of each
# projection's five): the shadows are random rays that the program and the
# judge draw apart, and without them a hand's score is its own, so that
# one round's scores on another round's hands show.
SHADOW_CHANNELS = [4, 9, 14]


@pytest.fixture(scope="module")
def case():
    """(config with the tiny CEM sizes, limits, a CEM detector of seeded
    random weights, its cloud, the raw input, the judge's weights)."""
    from h100_bench import harness
    from h100_bench.entries.serve import program_config
    from h100_bench.inputs import synthetic as syn
    w = harness.load_json(harness.BENCH, "workloads", f"{CELL}.json")
    config = harness.load_json(harness.BENCH, "configs",
                               f"{w['config']}.json")
    config["cem"] = {**config["cem"], **CEM_KW}
    limits = w["limits"]
    kw = dict(SCENE)
    rng = np.random.default_rng(kw.pop("seed"))
    pts, nrm = syn.make_scene(rng, **kw)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm,
                                       syn.view_cameras(rng, 2))
    params = lenet.init_params(torch.Generator().manual_seed(7), 15)
    params["fc2_w"] *= SCORE_SCALE
    params["fc2_b"] *= SCORE_SCALE
    params["fc2_b"][1] -= SCORE_SHIFT
    params["conv1_w"][:, SHADOW_CHANNELS] = 0.0
    det = GraspDetector(program_config(config["detector"], ""),
                        params=params, device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    raw = dict(points=p, cams=cs, view_points=vp)
    weights = {k: torch.as_tensor(v) for k, v in params.items()}
    return config, limits, det, cloud, raw, weights


def judged(case, loop=False):
    """One CEM request through the fused route's body (or the loop) and
    the judge's numbers of it."""
    from h100_bench.entries.cem import capture
    from h100_bench.entries.serve import to_host
    from h100_bench.reference import cem as ref
    config, _, det, cloud, raw, weights = case
    sis = tcem.SequentialImportanceSampling(det, CEMConfig(**config["cem"]))
    sis._force_loop = loop
    out = sis.detect(cloud, generator=torch.Generator().manual_seed(3),
                     verbose=False)
    assert min(sis.last_round_counts) > 0 and sis.last_num_grasps > 0
    return ref.judge(capture(sis, to_host(out), cloud), raw, config, weights,
                     "cpu", torch.Generator().manual_seed(0))


@pytest.mark.parametrize("loop", [False, True], ids=["fused", "loop"])
def test_every_number_within_its_limit(case, loop):
    nums = judged(case, loop)
    limits = {k: v for k, v in case[1].items() if k != "loop_rounds_off"}
    assert {k: nums[k] for k in limits if nums[k] > limits[k]} == {}, nums


def centres_from_invalid_slots(monkeypatch):
    """Every filled slot of the earlier rounds a mixture centre, valid or
    not."""
    real = draws.cem_round
    monkeypatch.setattr(draws, "cem_round", lambda g, c, m, *a: real(
        g, c, (c != 0).any(1), *a))


def prune_skipped(monkeypatch):
    """The selection made from every scored hand, the prune at min_score
    left out."""
    real = tcem._cem_scoring
    monkeypatch.setattr(tcem, "_cem_scoring", lambda *a: real(
        *a[:6], -float("inf"), *a[7:]))


def scores_on_other_hands(monkeypatch):
    """Round 1's hands scored with round 0's scores, slot for slot."""
    real = tcem._merge

    def merge(scored):
        a, b = scored[0], scored[1]
        moved = torch.where(b.valid, torch.nan_to_num(a.score, neginf=0.0),
                            -torch.inf)
        return real([a, dataclasses.replace(b, score=moved), *scored[2:]])
    monkeypatch.setattr(tcem, "_merge", merge)


@pytest.mark.parametrize("fault,number", [
    (centres_from_invalid_slots, "draws_off"),
    (prune_skipped, "selection_off"),
    (scores_on_other_hands, "score_round_median"),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_fails_its_number(case, fault, number, monkeypatch):
    fault(monkeypatch)
    nums = judged(case)
    assert nums[number] > case[1][number], nums
