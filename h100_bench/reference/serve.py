"""The check of a grasp request: the program's outputs judged, each by
what it says, against the plain GPD of ``reference/gpd.py``, run from the
request's raw input; and the controls, that plain GPD computed one step
below a stated precision and put in the program's place.

What a request gives (``Outputs``, taken from the timed request): the
preprocessed cloud's point count (and, from memory, the cloud with its
normals), every hand slot the search produced (its sample, rotation,
validity, closing region, width, finger placement, position and antipodal
flags), the classifier's score of every valid hand, and the selection.

The numbers, each a share or a gap, larger when worse:

- points_gap: the preprocessed point counts' gap over the reference's;
- normals_off: share of the program's cloud points that are not the
  reference's points, or whose normal lies more than NORMAL_TOL off the
  reference's where the reference's is well defined (NORMAL_GAP; its sign
  only where it faces its camera, FACING) (clouds from memory only);
- samples_off: share of the samples that are no point of the reference's
  cloud, or (sampling above the plane) lie clearly on its plane;
- frames_off: share of the samples with a well-defined normal axis
  (FRAME_GAP) whose hands are not the orientation grid about it: each
  hand's closing axis perpendicular to the reference's normal axis, its
  approach and binormal at one of the grid's angles to it (FRAME_TOL);
- geometry_off: share of the valid samples whose frame is off (as in
  frames_off) or any of whose hand slots is off (as in hands_off);
- hands_off: share of the valid samples' hand slots whose validity, or
  (both valid) closing region, width, placement, position or antipodal
  flags differ from the reference's hand at the same pose (GEOM_TOL),
  evaluated as it stands and with its thresholds leaning either way
  (TIE): a slot is off when it is none of the three;
- score_gap: the widest gap between the program's score of a hand that
  both find valid and the reference's score of its image (the mean over
  SHADOW_DRAWS images where they draw shadows); score_bias, score_median,
  score_trim: the centre of those gaps, signed, as a magnitude (mean,
  median, mean of the middle 80%). The per-hand gap holds the images' own
  draws: GPD's shadow channels are random rays, which the program draws
  once and the judge apart, and a point on a cell's edge falls either way
  between float32 and float64; a centre over a request's thousands of
  hands averages them out;
- selection_off: the selection's rows that the reference's selection from
  the program's own hands and scores lacks, with the rows' count gap, as
  a share of the reference's rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from h100_bench.reference import gpd

# The precisions the program's place is computed in (TF32 on, classifier
# operand type). The configurations state float32 geometry with TF32 off
# and bfloat16 classifier operands; a control takes the nearest type below
# one of them: TF32 for the geometry or float8 e4m3 for the classifier.
CONTROLS = {"geometry": (True, torch.bfloat16),
            "classifier": (False, torch.float8_e4m3fn)}


def operands(device) -> torch.dtype:
    """The classifier's operand type the judge scores in: the
    configurations' bfloat16 on the card, float32 on the CPU (where the
    program scores in float32)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32

NORMAL_TOL = 0.1          # radians
# A normal's axis is judged where the covariance's two smallest
# eigenvalues lie this far apart (over the largest), its sign where it
# faces its camera by this |cosine|.
NORMAL_GAP = 0.1
FACING = 0.2
# A frame is judged where its normal axis is this well defined
# (``gpd.local_frames``).
FRAME_GAP = 0.1
FRAME_TOL = 0.01          # cosine units
GEOM_TOL = 1e-6           # metres
# Where a point lies on a threshold the reference's answer is taken both
# ways: the normals over radii a hair apart (``gpd.TIE_RADIUS``), and the
# hands with every threshold leaning this far either way
# (``gpd.hands_at``). A normal, frame or hand is off when it is none of
# the answers.
TIE = 1e-6
# ... and the friction cone's this far (cosine units): a normal's last
# digits, from an eigenvector of a moderately conditioned covariance.
TIE_COS = 2e-3
# The shadow draws a judge's score of a 15-channel hand averages over.
SHADOW_DRAWS = 3
SAME_POINT = 1e-5         # metres
# A sample within this of the plane's threshold is not judged by it.
PLANE_MARGIN = 0.002
SCORE_ROW_TOL = 1e-4


@dataclasses.dataclass
class Outputs:
    """One request's outputs, on the host."""
    n_points: int
    slots: Dict[str, np.ndarray]      # every hand slot, in output order
    selected: np.ndarray              # (n, 14) position, rotation, score, id
    cloud_points: Optional[np.ndarray] = None
    cloud_normals: Optional[np.ndarray] = None


SLOT_FIELDS = ("sample", "orientation", "valid", "bottom", "top", "center",
               "width", "finger_placement", "position", "full_antipodal",
               "half_antipodal", "score", "sample_id")


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _samples(slots) -> tuple:
    """(sample ids, positions) of the valid samples (padding rows of an
    unfilled sample lie far away), one row per id."""
    ids, first = np.unique(slots["sample_id"], return_index=True)
    pos = slots["sample"][first]
    live = np.abs(pos).max(1) < 1e5
    return ids[live], pos[live]


def judge(out: Outputs, raw: dict, config: dict, weights: dict, device,
          generator: torch.Generator) -> dict:
    """The numbers of one request (module docstring). The reference's
    score of a hand is the mean over SHADOW_DRAWS images where the images
    draw shadows."""
    spec = config["detector"]
    f64 = torch.float64
    with tf32(False):
        cloud = gpd.preprocess(raw["points"], raw["cams"],
                               raw["view_points"], spec, device, f64,
                               ties=True)
        nums = {"points_gap": abs(out.n_points - len(cloud)) / len(cloud)}
        if out.cloud_points is not None:
            nums["normals_off"] = _normals_off(out, cloud)
        plane = (gpd.plane_distance(cloud.points, generator)
                 if spec["sample_above_plane"]
                 or spec["remove_plane_before_image_calculation"] else None)
        slots = out.slots
        sid, spos = _samples(slots)
        sp = torch.as_tensor(spos, dtype=f64, device=device)
        d = gpd._sq_dist(sp, cloud.points).amin(1).sqrt() if len(sp) else \
            torch.zeros(0, dtype=f64, device=device)
        off = d > SAME_POINT
        if spec["sample_above_plane"] and len(sp):
            near = gpd._sq_dist(sp, cloud.points).argmin(1)
            off |= plane[near] < gpd.PLANE_DIST - PLANE_MARGIN
        nums["samples_off"] = float(off.double().mean()) if len(sp) else 0.0
        judged, wrong = (_frames_wrong(slots, sid, sp, cloud, spec)
                         if len(sp) else (np.zeros(0, bool),) * 2)
        nums["frames_off"] = float((judged & wrong).sum() / judged.sum()) \
            if judged.any() else 0.0

        live = np.isin(slots["sample_id"], sid)
        S = torch.as_tensor(slots["sample"][live], dtype=f64, device=device)
        R = torch.as_tensor(slots["orientation"][live], dtype=f64,
                            device=device)
        ref = gpd.hands_at(cloud, S, R, spec)
        mine = {k: v[live] for k, v in slots.items()}
        bad, both = _hands_off(mine, ref)
        # The other answers, for the slots that are none so far.
        for nrm in (cloud.normals,) + cloud.tie_normals:
            for lean in (0.0, 1.0, -1.0):
                j = np.nonzero(bad)[0]
                if not len(j) or (lean == 0.0 and nrm is cloud.normals):
                    continue
                t = torch.as_tensor(j, device=device)
                alt = gpd.hands_at(cloud.with_normals(nrm), S[t], R[t], spec,
                                   lean * TIE, lean * TIE_COS)
                bad[j] = _hands_off({k: v[j] for k, v in mine.items()},
                                    alt)[0]
        nums["hands_off"] = float(bad.mean()) if len(bad) else 0.0
        # Per sample: its frame judged wrong, or any of its hands off.
        off_s = judged & wrong
        off_s |= np.isin(sid, mine["sample_id"][bad])
        nums["geometry_off"] = float(off_s.mean()) if len(sid) else 0.0

        img_mask = torch.ones(len(cloud), dtype=torch.bool, device=device)
        if spec["remove_plane_before_image_calculation"]:
            img_mask = plane > gpd.PLANE_DIST
        idx = np.nonzero(both)[0]
        t = torch.as_tensor(idx, device=device)
        draws = SHADOW_DRAWS if spec["image_geometry"]["num_channels"] == 15 \
            else 1
        ref_score = sum(gpd.lenet_scores(weights, gpd.images(
            cloud, img_mask, S[t], R[t], ref.bottom[t], ref.center[t], spec,
            generator), operands(device)).double()
            for _ in range(draws)) / draws
        diff = (torch.as_tensor(mine["score"][idx], device=device).double()
                - ref_score)
        nums.update(_score_numbers(diff))
        nums["selection_off"] = _selection_off(out, spec)
    return nums


def work(out: Outputs, raw: dict, spec: dict, device) -> dict:
    """A request's work for the rooflines and mfu: its valid hands, and
    the points of their image neighbourhoods in the reference's cloud
    (within the image radius of the hand's sample, at most the
    neighbourhood cap; none counted where the plane is removed before the
    images, which reads fewer)."""
    v = out.slots["valid"].astype(bool)
    hands = int(v.sum())
    if spec["remove_plane_before_image_calculation"] or not hands:
        return dict(hands=hands, nbhd_points=0)
    cloud = gpd.preprocess(raw["points"], raw["cams"], raw["view_points"],
                           spec, device, torch.float64)
    s = torch.as_tensor(out.slots["sample"][v], dtype=torch.float64,
                        device=device)
    ig = spec["image_geometry"]
    r = max(ig["depth"], ig["height"] / 2.0, ig["outer_diameter"])
    total = 0
    for b in gpd._blocks(len(s), 1024):
        n = (gpd._sq_dist(s[b], cloud.points) <= r * r).sum(1)
        total += int(n.clamp(max=spec["image_neighbors_cap"]).sum())
    return dict(hands=hands, nbhd_points=total)


def _score_numbers(diff: torch.Tensor) -> dict:
    """score_gap, and the signed gaps' centre as a magnitude three ways:
    their mean (score_bias), median (score_median) and the mean of their
    middle 80% (score_trim)."""
    if not len(diff):
        return dict(score_gap=0.0, score_bias=0.0, score_median=0.0,
                    score_trim=0.0)
    d = diff.sort().values
    cut = len(d) // 10
    mid = d[cut:len(d) - cut] if len(d) > 2 * cut else d
    return dict(score_gap=float(d.abs().max()),
                score_bias=float(d.mean().abs()),
                score_median=float(d.median().abs()),
                score_trim=float(mid.mean().abs()))


def _normals_off(out: Outputs, cloud: gpd.Cloud) -> float:
    p = torch.as_tensor(out.cloud_points, dtype=torch.float64,
                        device=cloud.points.device)
    n = torch.as_tensor(out.cloud_normals, dtype=torch.float64,
                        device=cloud.points.device)
    bad = torch.zeros(len(p), dtype=torch.bool, device=p.device)
    for b in gpd._blocks(len(p), 1024):
        d2 = gpd._sq_dist(p[b], cloud.points)
        v, j = d2.min(1)
        best = torch.full_like(v, -1.0)
        for nrm in (cloud.normals,) + cloud.tie_normals:
            cos = (n[b] * nrm[j]).sum(1) / n[b].norm(dim=1).clamp(min=1e-12)
            best = torch.maximum(best, torch.where(cloud.facing[j] > FACING,
                                                   cos, cos.abs()))
        bad[b] = (v.sqrt() > SAME_POINT) | (
            (cloud.normal_gap[j] > NORMAL_GAP) & (best < math.cos(NORMAL_TOL)))
    return float(bad.double().mean()) if len(p) else 0.0


def _frames_wrong(slots, sid, sp, cloud, spec):
    """Per sample (rows of ``sid``): (its frame is judged, its hands fit
    the grid about none of the reference's normal axes, one for each of
    the cloud's answers for the normals)."""
    _, fvalid, gap = gpd.local_frames(sp, cloud, spec["nn_radius_frames"])
    judged = fvalid & (gap > FRAME_GAP)
    num = spec["num_orientations"]
    th = torch.tensor([-math.pi / 2 + math.pi * i / num for i in range(num)],
                      dtype=torch.float64, device=sp.device)
    grid = torch.stack([-torch.cos(th), torch.sin(th)], 1)        # (M, 2)
    row = {int(s): i for i, s in enumerate(sid)}
    rows = torch.as_tensor([row.get(int(s), -1) for s in slots["sample_id"]],
                           device=sp.device)
    live = rows >= 0
    R = torch.as_tensor(slots["orientation"], dtype=torch.float64,
                        device=sp.device)[live]
    wrong = torch.ones(len(sp), dtype=torch.bool, device=sp.device)
    for nrm in (cloud.normals,) + cloud.tie_normals:
        frames = gpd.local_frames(sp, cloud.with_normals(nrm),
                                  spec["nn_radius_frames"])[0]
        n = frames[rows[live], :, 0]
        ab = torch.stack([(R[:, :, 0] * n).sum(1), (R[:, :, 1] * n).sum(1)],
                         1)
        err = (ab[:, None, :] - grid[None]).abs().amax(2).amin(1)
        err = torch.maximum(err, (R[:, :, 2] * n).sum(1).abs())
        wrong &= torch.zeros(len(sp), dtype=torch.float64, device=sp.device
                             ).index_add_(0, rows[live],
                                          (err > FRAME_TOL).double()) > 0
    return judged.cpu().numpy(), wrong.cpu().numpy()


def _hands_off(mine: dict, ref: gpd.Hands):
    """(per slot: differs, per slot: valid in both and alike)."""
    rv = ref.valid.cpu().numpy()
    mv = mine["valid"].astype(bool)
    both = rv & mv

    def far(a, b):
        return np.abs(np.asarray(a, np.float64)
                      - b.cpu().numpy()) > GEOM_TOL
    geom = (far(mine["bottom"], ref.bottom) | far(mine["top"], ref.top)
            | far(mine["center"], ref.center) | far(mine["width"], ref.width)
            | (mine["finger_placement"] != ref.placement.cpu().numpy())
            | far(mine["position"], ref.position).any(1)
            | (mine["full_antipodal"] != ref.full.cpu().numpy())
            | (mine["half_antipodal"] != ref.half.cpu().numpy()))
    bad = (rv != mv) | (both & geom)
    return bad, both & ~geom


def _selection_off(out: Outputs, spec: dict) -> float:
    s = out.slots
    v = s["valid"].astype(bool)
    pos = torch.as_tensor(s["position"][v], dtype=torch.float64)
    axis = torch.as_tensor(s["orientation"][v][:, :, 2], dtype=torch.float64)
    score = torch.as_tensor(s["score"][v], dtype=torch.float64)
    rot = s["orientation"][v].reshape(-1, 9)
    ids = s["sample_id"][v]
    rows = gpd.select(pos, axis, score, spec["num_selected"],
                      spec["min_inliers"])
    used = np.zeros(len(rows), bool)
    missing = 0
    for r in out.selected:
        hit = -1
        for j, (i, p, sc) in enumerate(rows):
            if used[j] or ids[i] != int(round(r[13])):
                continue
            if (np.abs(rot[i] - r[3:12]).max() <= GEOM_TOL
                    and np.abs(p.numpy() - r[:3]).max() <= SAME_POINT
                    and abs(sc - r[12]) <= SCORE_ROW_TOL * max(1, abs(sc))):
                hit = j
                break
        if hit < 0:
            missing += 1
        else:
            used[hit] = True
    return (missing + abs(len(out.selected) - len(rows))) / max(len(rows), 1)


def control(raw: dict, samples: np.ndarray, config: dict, weights: dict,
            device, generator: torch.Generator, name: str) -> Outputs:
    """The plain GPD in the program's place, in the configuration's
    float32 with the control's step below: the request's outputs from the
    same raw input and the program's samples (a draw both share). The
    geometry control takes TF32 in every matrix product, its distances
    formed as one (``gpd.matmul_distances``); the classifier control
    rounds the LeNet's operands to float8."""
    spec = config["detector"]
    on, operands = CONTROLS[name]
    f32 = torch.float32
    dist = gpd.matmul_distances() if on else contextlib.nullcontext()
    with tf32(on), dist:
        cloud = gpd.preprocess(raw["points"], raw["cams"], raw["view_points"],
                               spec, device, f32)
        sp = torch.as_tensor(samples, dtype=f32, device=device)
        frames, fvalid, _ = gpd.local_frames(sp, cloud,
                                             spec["nn_radius_frames"])
        grid = gpd.orientation_grid(spec["num_orientations"],
                                    spec["hand_axes"], f32, device)
        M = len(grid)
        R = torch.matmul(frames[:, None], grid[None]).reshape(-1, 3, 3)
        S = sp.repeat_interleave(M, 0)
        h = gpd.hands_at(cloud, S, R, spec)
        valid = h.valid & fvalid.repeat_interleave(M)
        img_mask = torch.ones(len(cloud), dtype=torch.bool, device=device)
        if spec["remove_plane_before_image_calculation"]:
            img_mask = gpd.plane_distance(cloud.points, generator) > \
                gpd.PLANE_DIST
        t = torch.nonzero(valid)[:, 0]
        ims = gpd.images(cloud, img_mask, S[t], R[t], h.bottom[t],
                         h.center[t], spec, generator)
        score = torch.full((len(S),), -math.inf, device=device)
        score[t] = gpd.lenet_scores(weights, ims, operands)
    slots = dict(sample=S, orientation=R, valid=valid, bottom=h.bottom,
                 top=h.top, center=h.center, width=h.width,
                 finger_placement=h.placement, position=h.position,
                 full_antipodal=h.full, half_antipodal=h.half, score=score,
                 sample_id=torch.arange(len(sp), device=device
                                        ).repeat_interleave(M))
    slots = {k: v.cpu().numpy() for k, v in slots.items()}
    v = slots["valid"]
    rows = gpd.select(torch.as_tensor(slots["position"][v], dtype=torch.float64),
                      torch.as_tensor(slots["orientation"][v][:, :, 2],
                                      dtype=torch.float64),
                      torch.as_tensor(slots["score"][v], dtype=torch.float64),
                      spec["num_selected"], spec["min_inliers"])
    vi = np.nonzero(v)[0]
    sel = np.array([np.concatenate([p.numpy(), slots["orientation"][vi[i]]
                                    .reshape(9), [sc, slots["sample_id"][vi[i]]]])
                    for i, p, sc in rows], np.float32).reshape(-1, 14)
    return Outputs(n_points=len(cloud), slots=slots, selected=sel,
                   cloud_points=cloud.points.cpu().numpy(),
                   cloud_normals=cloud.normals.cpu().numpy())
