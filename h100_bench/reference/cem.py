"""The check of a CEM request, GPD's sequential importance sampling
(sequential_importance_sampling.cpp:54-187): the program's outputs judged
against the plain GPD of ``reference/gpd.py``, run from the request's raw
input as ``reference/serve.py`` runs it for a grasp request, and each
importance-sampling round's draws against what the rounds before it found.

What a CEM request gives (``Outputs``, taken from the timed request): the
preprocessed cloud's point count and cloud, every round's hand slots (as
``serve.SLOT_FIELDS``: each slot's sample, its id in the round, rotation,
validity, hand geometry and the classifier's score), in round order, and
the selection.

The numbers, each a share or a gap, larger when worse:

- points_gap, normals_off, frames_off, hands_off and the score numbers
  (score_gap, _bias, _median, _trim): as ``serve.judge`` computes them,
  over every round's slots together (a sample named by its round and its
  id in it) whose sample has a cloud point within the frames' radius, so
  every round's frames and hands are held to ``gpd.hands_at`` at the
  program's samples with the ties read both ways, and every round's
  scores to the reference's images and LeNet;
- score_round_median: the largest, over the rounds, of the median score
  gap's magnitude among the round's hands. When a round's hands take
  scores that are not theirs (another round's), their gaps spread both
  ways, so the signed gaps' centre (score_median) hardly moves, and over
  every round's hands a median does not see one round of six;
- frameless_off: share of the samples with no cloud point within the
  frames' radius (mixture samples off the surface, which have no frame,
  frame_estimator.cpp:74-86) that have a valid hand;
- geometry_off: share of the samples off: a frame or a hand off, as
  serve's, or frameless with a valid hand;
- samples_off: share of round 0's samples that are no point of the
  reference's cloud (round 0 samples the cloud uniformly, .cpp:71-78);
- draws_off: share of the later rounds' samples that are not what the
  round draws (.cpp:112-157): a round not of ``n_gauss`` mixture samples
  then ``n_rand`` uniform ones, in slot order (each of its samples with
  its hands), counts every sample off; a mixture sample is off farther
  than DRAW_SIGMAS standard deviations from every sample with a valid hand
  in the rounds before it (the mixture's centres), a uniform one when it
  is no point of the reference's cloud or lies outside the workspace;
- selection_off: ``serve``'s, with the reference's own prune first: the
  selection's rows that ``gpd.select`` over the program's hands of every
  round that score above ``min_score`` lacks, with the rows' count gap.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench.reference import gpd
from h100_bench.reference import serve

# A mixture sample lies within this many standard deviations of a centre:
# a draw misses it with chance 7.5e-8 (the tail of a 3-D normal's radius
# beyond 6 sigma), 4e-5 over the 525 draws of a run's three checked
# requests.
DRAW_SIGMAS = 6.0
# A slot's sample is named across rounds as round * ROUND_IDS + its id.
ROUND_IDS = 1 << 20


@dataclasses.dataclass
class Outputs:
    """One CEM request's outputs, on the host."""
    n_points: int
    rounds: List[Dict[str, np.ndarray]]   # each round's hand slots
    selected: np.ndarray                  # (n, 14) position, rotation,
    #                                       score, sample id in its round
    cloud_points: Optional[np.ndarray] = None
    cloud_normals: Optional[np.ndarray] = None


def draw_counts(cem: dict) -> tuple:
    """(mixture, uniform) samples of an importance-sampling round, the
    uniform share of the round truncated to a whole number."""
    per = cem["num_samples_per_iteration"]
    n_rand = int(cem["prob_rand_samples"] * per)
    return per - n_rand, n_rand


def merged_slots(rounds: List[dict], local_ids: bool = False) -> dict:
    """Every round's slots in one set, each sample named across rounds
    (``ROUND_IDS``) unless ``local_ids``."""
    out = {}
    for k in serve.SLOT_FIELDS:
        parts = [s[k] + r * ROUND_IDS if k == "sample_id" and not local_ids
                 else s[k] for r, s in enumerate(rounds)]
        out[k] = np.concatenate(parts)
    return out


def _nearest(a: np.ndarray, b: torch.Tensor) -> torch.Tensor:
    """Each row of ``a``'s distance to the nearest row of ``b``."""
    x = torch.as_tensor(a, dtype=torch.float64, device=b.device)
    if not len(x):
        return torch.zeros(0, dtype=torch.float64, device=b.device)
    if not len(b):
        return torch.full((len(x),), float("inf"), dtype=torch.float64,
                          device=b.device)
    return torch.cat([gpd._sq_dist(x[i], b).amin(1)
                      for i in gpd._blocks(len(x), 1024)]).sqrt()


def _round_samples(slots: dict) -> tuple:
    """(sample ids, each id's position, each id's slot count)."""
    ids, first, n = np.unique(slots["sample_id"], return_index=True,
                              return_counts=True)
    return ids, slots["sample"][first], n


def draws_off(rounds: List[dict], points: torch.Tensor, spec: dict,
              cem: dict) -> float:
    """The share of rounds 1.. samples off (module docstring)."""
    n_gauss, n_rand = draw_counts(cem)
    per = n_gauss + n_rand
    M = spec["num_orientations"] * len(spec["hand_axes"])
    reach = DRAW_SIGMAS * cem["standard_deviation"]
    w = np.asarray(spec["workspace"], np.float64)
    off = total = 0
    for r in range(1, len(rounds)):
        earlier = rounds[:r]
        valid = np.concatenate([s["sample"][s["valid"].astype(bool)]
                                for s in earlier])
        # With no valid hand before the round every mixture draw starts at
        # the first slot (gpd_tpu's choice over an all-zero p): any earlier
        # sample is taken as a centre then.
        centres = valid if len(valid) else np.concatenate(
            [s["sample"] for s in earlier])
        ids, pos, n = _round_samples(rounds[r])
        total += per
        if not np.array_equal(ids, np.arange(per)) or (n != M).any():
            off += per
            continue
        c = torch.as_tensor(centres, dtype=torch.float64,
                            device=points.device)
        off += int((_nearest(pos[:n_gauss], c) > reach).sum())
        u = pos[n_gauss:].astype(np.float64)
        inside = ((u >= w[0::2]) & (u <= w[1::2])).all(1)
        off += int(((_nearest(u, points) > serve.SAME_POINT).cpu().numpy()
                    | ~inside).sum())
    return off / total if total else 0.0


def judge(out: Outputs, raw: dict, config: dict, weights: dict, device,
          generator: torch.Generator) -> dict:
    """The numbers of one CEM request (module docstring); ``config`` holds
    the ``detector`` and ``cem`` keys the request ran with. The reference's
    score of a hand is the mean over ``serve.SHADOW_DRAWS`` images where
    the images draw shadows."""
    spec, cem = config["detector"], config["cem"]
    if spec["sample_above_plane"] or \
            spec["remove_plane_before_image_calculation"]:
        raise NotImplementedError("CEM with the RANSAC plane")
    f64 = torch.float64
    with serve.tf32(False):
        cloud = gpd.preprocess(raw["points"], raw["cams"],
                               raw["view_points"], spec, device, f64,
                               ties=True)
        nums = {"points_gap": abs(out.n_points - len(cloud)) / len(cloud)}
        if out.cloud_points is not None:
            nums["normals_off"] = serve._normals_off(out, cloud)
        _, pos0 = serve._samples(out.rounds[0])
        d = _nearest(pos0, cloud.points)
        nums["samples_off"] = float((d > serve.SAME_POINT).double().mean()) \
            if len(d) else 0.0
        nums["draws_off"] = draws_off(out.rounds, cloud.points, spec, cem)

        # A mixture sample may have no cloud point within the frames'
        # radius: it has no frame (frame_estimator.cpp:74-86), and every
        # hand of it is invalid. The others are judged as serve judges a
        # request's samples; a sample within TIE of the radius is judged
        # neither way.
        slots = merged_slots(out.rounds)
        sid, spos = serve._samples(slots)
        near = _nearest(spos, cloud.points).cpu().numpy()
        r = spec["nn_radius_frames"]
        frameless = sid[near > r + serve.TIE]
        lone_off = np.isin(frameless, slots["sample_id"][
            slots["valid"].astype(bool)])
        nums["frameless_off"] = float(lone_off.mean()) if len(lone_off) \
            else 0.0
        sid, spos = sid[near < r - serve.TIE], spos[near < r - serve.TIE]
        sp = torch.as_tensor(spos, dtype=f64, device=device)
        judged, wrong = (serve._frames_wrong(slots, sid, sp, cloud, spec)
                         if len(sp) else (np.zeros(0, bool),) * 2)
        nums["frames_off"] = float((judged & wrong).sum() / judged.sum()) \
            if judged.any() else 0.0

        live = np.isin(slots["sample_id"], sid)
        S = torch.as_tensor(slots["sample"][live], dtype=f64, device=device)
        R = torch.as_tensor(slots["orientation"][live], dtype=f64,
                            device=device)
        ref = gpd.hands_at(cloud, S, R, spec)
        mine = {k: v[live] for k, v in slots.items()}
        bad, both = serve._hands_off(mine, ref)
        # The other answers, for the slots that are none so far.
        for nrm in (cloud.normals,) + cloud.tie_normals:
            for lean in (0.0, 1.0, -1.0):
                j = np.nonzero(bad)[0]
                if not len(j) or (lean == 0.0 and nrm is cloud.normals):
                    continue
                t = torch.as_tensor(j, device=device)
                alt = gpd.hands_at(cloud.with_normals(nrm), S[t], R[t], spec,
                                   lean * serve.TIE, lean * serve.TIE_COS)
                bad[j] = serve._hands_off({k: v[j] for k, v in mine.items()},
                                          alt)[0]
        nums["hands_off"] = float(bad.mean()) if len(bad) else 0.0
        # Per sample: its frame judged wrong or any of its hands off, or
        # frameless with a valid hand.
        off_s = (judged & wrong) | np.isin(sid, mine["sample_id"][bad])
        n = len(sid) + len(lone_off)
        nums["geometry_off"] = float((off_s.sum() + lone_off.sum()) / n) \
            if n else 0.0

        img_mask = torch.ones(len(cloud), dtype=torch.bool, device=device)
        t = torch.as_tensor(np.nonzero(both)[0], device=device)
        draws = serve.SHADOW_DRAWS \
            if spec["image_geometry"]["num_channels"] == 15 else 1
        ref_score = sum(gpd.lenet_scores(weights, gpd.images(
            cloud, img_mask, S[t], R[t], ref.bottom[t], ref.center[t], spec,
            generator), serve.operands(device)).double()
            for _ in range(draws)) / draws
        diff = (torch.as_tensor(mine["score"][both], device=device).double()
                - ref_score)
        nums.update(serve._score_numbers(diff))
        rnd = torch.as_tensor(mine["sample_id"][both] // ROUND_IDS,
                              device=device)
        nums["score_round_median"] = max(
            [float(diff[rnd == k].abs().median()) for k in rnd.unique()],
            default=0.0)
    nums["selection_off"] = serve._selection_off(
        serve.Outputs(n_points=out.n_points,
                      slots=pruned(out.rounds, cem["min_score"]),
                      selected=out.selected), spec)
    return nums


def pruned(rounds: List[dict], min_score: float) -> dict:
    """Every round's slots (ids in their round), the valid ones scoring at
    or under ``min_score`` made invalid (pruneGraspCandidates,
    grasp_detector.cpp:529-552)."""
    s = merged_slots(rounds, local_ids=True)
    s["valid"] = s["valid"].astype(bool) & (s["score"] > min_score)
    return s


def selection(slots: dict, spec: dict) -> np.ndarray:
    """``gpd.select`` over the valid slots, as (n, 14) rows of position,
    rotation, score and sample id."""
    v = slots["valid"].astype(bool)
    rows = gpd.select(
        torch.as_tensor(slots["position"][v], dtype=torch.float64),
        torch.as_tensor(slots["orientation"][v][:, :, 2], dtype=torch.float64),
        torch.as_tensor(slots["score"][v], dtype=torch.float64),
        spec["num_selected"], spec["min_inliers"])
    vi = np.nonzero(v)[0]
    return np.array([np.concatenate([p.numpy(),
                                     slots["orientation"][vi[i]].reshape(9),
                                     [sc, slots["sample_id"][vi[i]]]])
                     for i, p, sc in rows], np.float32).reshape(-1, 14)


def control(out: Outputs, raw: dict, config: dict, weights: dict, device,
            generator: torch.Generator, name: str) -> Outputs:
    """``serve.control`` in the program's place at the program's samples
    of every round (a draw both share), its slots split back into the
    rounds, and its selection made after the prune."""
    sizes, samples = [], []
    for s in out.rounds:
        ids, pos, _ = _round_samples(s)
        sizes.append(len(ids))
        samples.append(pos)
    c = serve.control(raw, np.concatenate(samples), config, weights, device,
                      generator, name)
    rounds, ofs = [], 0
    for n in sizes:
        m = (c.slots["sample_id"] >= ofs) & (c.slots["sample_id"] < ofs + n)
        r = {k: v[m] for k, v in c.slots.items()}
        r["sample_id"] = r["sample_id"] - ofs
        rounds.append(r)
        ofs += n
    return Outputs(n_points=c.n_points, rounds=rounds,
                   selected=selection(pruned(rounds,
                                             config["cem"]["min_score"]),
                                      config["detector"]),
                   cloud_points=c.cloud_points,
                   cloud_normals=c.cloud_normals)
