"""The check of a data-generation request, GPD's ``generate_data`` for one
(object, view) unit (data_generator.cpp:73-277): the program's outputs
judged against the plain GPD of ``reference/gpd.py`` run from the view's
raw points, and every label against a plain relabelling on the object's
ground-truth cloud, written from ``HandSearch::reevaluateHypothesis`` and
``labelHypothesis`` (hand_search.cpp:66-134, 190-228), in float64.

What a request gives (``Outputs``, taken from the timed request): the
preprocessed view's point count; every attempt's valid candidates (each
hand's sample, rotation, top, finger placement, sample index, attempt and
label); the kept rows (the same fields) and their uint8 images, in the
returned order; the number of attempts; and the seed of the request's
NumPy generator, which balances the rows.

The numbers, each a share, larger when worse:

- points_gap: the preprocessed point counts' gap over the reference's;
- samples_off: share of the candidates' samples (each attempt's) that are
  no point of the reference's view cloud;
- geometry_off: share of the kept rows whose hand is not the reference's
  hand at its pose on the view cloud (``gpd.hands_at``: valid, the same
  top and finger placement, the ties read both ways as ``serve`` reads
  them), or whose rotation is not the orientation grid about the
  reference's normal axis at its sample where that axis is well defined;
- labels_off: share of the valid candidates whose label (1 = full
  antipodal) is none of ``relabel``'s answers on the ground-truth cloud at
  the candidate's hand, the thresholds read as they stand and leaning
  either way (``serve.TIE``, ``serve.TIE_COS``);
- attempts_off: 1 when the attempt rule (attempts until
  ``min_grasps_per_view`` positives, at most MAX_ATTEMPTS, and a stop after
  two in a row without one) stops at another attempt than the program
  did, over the judged labels (the program's where it is one of the
  reference's answers, else the reference's), else 0;
- rows_off: the kept rows that are not the rows ``balance`` keeps from the
  program's own labels with the request's generator, with the count gap,
  over that count;
- images_off: share of the kept rows' pixels in the projection channels
  (the shadow channels, random rays that the program and the judge draw
  apart, left out) more than IMAGE_TOL from the reference's image at the
  row's hand on the reference's view cloud.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np
import torch

from h100_bench.reference import gpd
from h100_bench.reference import serve

# The port's attempt rule (datagen.py): at most this many attempts.
MAX_ATTEMPTS = 8
# A pixel is off when it lies this far (uint8 steps) from the reference's:
# a point on a cell's edge, or a normal's last digits, move a mean by one.
IMAGE_TOL = 1
# An attempt's sample is named across attempts as attempt * ATTEMPT_IDS +
# its index.
ATTEMPT_IDS = 1 << 20
HAND_KEYS = ("sample", "orientation", "top", "finger_placement",
             "sample_id", "attempt", "label")


@dataclasses.dataclass
class Outputs:
    """One data-generation request's outputs, on the host."""
    n_points: int
    candidates: Dict[str, np.ndarray]   # every valid candidate (HAND_KEYS)
    rows: Dict[str, np.ndarray]         # the kept rows, in returned order
    images: np.ndarray                  # (K, s, s, C) uint8 of the rows
    attempts: int
    rng_seed: int


def ground_truth(points: np.ndarray, normals: np.ndarray, device,
                 dtype=torch.float64) -> gpd.Cloud:
    """An object's ground-truth cloud as given: its points and normals."""
    p = torch.as_tensor(np.asarray(points, np.float32), device=device
                        ).to(dtype)
    n = torch.as_tensor(np.asarray(normals, np.float32), device=device
                        ).to(dtype)
    return gpd.Cloud(p, n, torch.ones(len(p), dtype=torch.long,
                                      device=device),
                     torch.zeros((1, 3), dtype=dtype, device=device))


def relabel(cloud: gpd.Cloud, samples: torch.Tensor, rot: torch.Tensor,
            top: torch.Tensor, placement: torch.Tensor, spec: dict,
            lean: float = 0.0, lean_cos: float = 0.0,
            block: int = 256) -> torch.Tensor:
    """reevaluateHypothesis and labelHypothesis for each stored hand
    (sample (H, 3), rotation (H, 3, 3), top (H,), finger placement (H,)):
    the cloud's points within the hand search radius of the sample, moved
    into the hand frame and cropped by the hand's height; the fingers
    evaluated at the stored top, the hand possible when both fingers of the
    stored placement are free; then the closing region's antipodal test.
    Returns (H,) bool: full antipodal (label 1). ``lean`` and ``lean_cos``
    as in ``gpd.hands_at``."""
    hg = spec["hand_geometry"]
    P = spec["num_finger_placements"]
    dt, dev = cloud.points.dtype, cloud.points.device
    sp = gpd._spacing(hg, P, dt, dev)
    fw, depth, height = hg["finger_width"], hg["depth"], hg["height"]
    radius = max(hg["outer_diameter"] - fw, depth, height / 2.0)
    e = lean
    out = torch.zeros(len(samples), dtype=torch.bool, device=dev)
    for b in gpd._blocks(len(samples), block):
        s, R, t = samples[b], rot[b], top[b]
        mid = placement[b]
        # Every point of the cloud, those within the radius marked.
        near = gpd._sq_dist(s, cloud.points) <= radius * radius
        rel = cloud.points[None, :, :] - s[:, None, :]
        p = torch.matmul(rel, R)                            # R^T (p - s)
        n = torch.matmul(cloud.normals[None, :, :].expand(len(s), -1, -1), R)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        hmask = near & (z > -height - e) & (z < height + e)
        free = gpd._fingers(x, y, hmask, t, depth, sp, fw, e)
        ok = free.gather(1, mid[:, None])[:, 0] & \
            free.gather(1, (mid + P)[:, None])[:, 0]
        left = sp[mid] + fw
        right = sp[mid + P]
        closing = hmask & (x > (t - depth)[:, None] - e) & \
            (x < t[:, None] + e) & (y > left[:, None] - e) & \
            (y < right[:, None] + e)
        ok = ok & closing.any(1)
        label = gpd._antipodal(x, y, z, n, closing, spec["friction_coeff"],
                               spec["min_viable"], e, lean_cos)
        out[b] = ok & (label == 2)
    return out


def balance(labels: np.ndarray, max_count: int, seed: int) -> np.ndarray:
    """balanceInstances (data_generator.cpp:406-430) over ``labels``:
    min(#positives, #negatives, max_count) of each class, in the order the
    request's generator (NumPy, ``seed``) draws: a permutation of the
    positives' indices, one of the negatives', and one of the kept rows."""
    rng = np.random.default_rng(seed)
    pos = np.nonzero(labels == 1)[0]
    neg = np.nonzero(labels == 0)[0]
    n = min(len(pos), len(neg), max_count)
    keep = np.concatenate([rng.permutation(pos)[:n],
                           rng.permutation(neg)[:n]])
    return rng.permutation(keep)


def stop_attempt(positives, min_pos: int) -> int:
    """The attempt (1-based) at which the rule stops over the attempts'
    positive counts, or len + 1 where it would go on past them."""
    total = streak = 0
    for k, got in enumerate(positives, 1):
        total += got
        streak = streak + 1 if got == 0 else 0
        if total >= min_pos or streak >= 2 or k == MAX_ATTEMPTS:
            return k
    return len(positives) + 1


def bottoms_and_centres(top, placement, spec):
    """The closing region's bottom and lateral centre of hands at ``top``
    with finger placement ``placement`` (hand_set.cpp's hand geometry)."""
    hg = spec["hand_geometry"]
    P = spec["num_finger_placements"]
    sp = gpd._spacing(hg, P, top.dtype, top.device)
    return top - hg["depth"], 0.5 * (sp[placement] + hg["finger_width"]
                                     + sp[placement + P])


def _tensors(hands: dict, device, dtype):
    return (torch.as_tensor(hands["sample"], device=device).to(dtype),
            torch.as_tensor(hands["orientation"], device=device).to(dtype),
            torch.as_tensor(hands["top"], device=device).to(dtype),
            torch.as_tensor(hands["finger_placement"], device=device).long())


def _labels_judged(cands: dict, mesh: gpd.Cloud, spec: dict, device):
    """(per candidate: its label is one of the reference's answers, the
    judged label: the program's where it is, else the reference's)."""
    S, R, T, M = _tensors(cands, device, torch.float64)
    mine = torch.as_tensor(cands["label"], device=device) == 1
    ref = relabel(mesh, S, R, T, M, spec)
    match = ref == mine
    for lean in (1.0, -1.0):
        j = torch.nonzero(~match)[:, 0]
        if not len(j):
            break
        alt = relabel(mesh, S[j], R[j], T[j], M[j], spec, lean * serve.TIE,
                      lean * serve.TIE_COS)
        match[j] = alt == mine[j]
    judged = torch.where(match, mine, ref)
    return match.cpu().numpy(), judged.cpu().numpy()


def _rows_off(out: Outputs, max_count: int) -> float:
    """The kept rows against the rows ``balance`` keeps from the program's
    labels."""
    c = out.candidates
    keep = balance(np.asarray(c["label"]), max_count, out.rng_seed)
    want = {k: np.asarray(c[k])[keep] for k in HAND_KEYS}
    n, m = len(keep), len(out.rows["label"])
    same = np.ones(min(n, m), bool)
    for k in HAND_KEYS if len(same) else ():
        a = np.asarray(out.rows[k])[:len(same)].reshape(len(same), -1)
        b = want[k][:len(same)].reshape(len(same), -1)
        same &= (a == b).all(1)
    return (int((~same).sum()) + abs(n - m)) / max(n, 1)


def _geometry_off(rows: dict, cloud: gpd.Cloud, spec: dict, device):
    """Per kept row: its hand or its frame off (module docstring)."""
    f64 = torch.float64
    S, R, T, M = _tensors(rows, device, f64)
    top, mid = T.cpu().numpy(), M.cpu().numpy()

    def off(h, j):
        return (~h.valid.cpu().numpy()
                | (np.abs(top[j] - h.top.cpu().numpy()) > serve.GEOM_TOL)
                | (mid[j] != h.placement.cpu().numpy()))
    bad = off(gpd.hands_at(cloud, S, R, spec), np.arange(len(S)))
    for nrm in (cloud.normals,) + cloud.tie_normals:
        for lean in (0.0, 1.0, -1.0):
            j = np.nonzero(bad)[0]
            if not len(j) or (lean == 0.0 and nrm is cloud.normals):
                continue
            t = torch.as_tensor(j, device=device)
            bad[j] = off(gpd.hands_at(cloud.with_normals(nrm), S[t], R[t],
                                      spec, lean * serve.TIE,
                                      lean * serve.TIE_COS), j)
    ids = np.asarray(rows["attempt"]) * ATTEMPT_IDS + np.asarray(
        rows["sample_id"])
    sid, first = np.unique(ids, return_index=True)
    sp = S[torch.as_tensor(first, device=device)]
    judged, wrong = serve._frames_wrong(
        dict(sample_id=ids, orientation=np.asarray(rows["orientation"])),
        sid, sp, cloud, spec)
    frame_off = (judged & wrong)[np.searchsorted(sid, ids)]
    return bad | frame_off


def _image_off(images: np.ndarray, rows: dict, cloud: gpd.Cloud, spec: dict,
               device, generator: torch.Generator) -> float:
    """images_off (module docstring): a pixel is off when it is more than
    IMAGE_TOL from the reference's image under each of the cloud's answers
    for the normals (a voxel grid puts points exactly at the normals'
    radius, and each way of rounding them is GPD's)."""
    if not len(images):
        return 0.0
    S, R, T, M = _tensors(rows, device, cloud.points.dtype)
    bottom, centre = bottoms_and_centres(T, M, spec)
    mask = torch.ones(len(cloud), dtype=torch.bool, device=device)
    C = images.shape[-1]
    keep = [c for c in range(C) if C != 15 or c % 5 != 4]
    mine = torch.as_tensor(images, device=device)[..., keep].int()
    off = torch.ones(mine.shape, dtype=torch.bool, device=device)
    for nrm in (cloud.normals,) + cloud.tie_normals:
        ref = gpd.images(cloud.with_normals(nrm), mask, S, R, bottom, centre,
                         spec, generator)
        off &= (mine - ref[..., keep].int()).abs() > IMAGE_TOL
    return float(off.double().mean())


def judge(out: Outputs, raw: dict, truth: dict, config: dict, device,
          generator: torch.Generator) -> dict:
    """The numbers of one request (module docstring). ``raw`` is the view
    as the benchmark made it (points, cams, view_points), ``truth`` the
    object's ground-truth points and normals, ``config`` the
    configuration with the ``datagen`` settings the request ran with."""
    spec, dg = config["detector"], config["datagen"]
    f64 = torch.float64
    with serve.tf32(False):
        cloud = gpd.preprocess(raw["points"], raw["cams"],
                               raw["view_points"], spec, device, f64,
                               ties=True)
        mesh = ground_truth(truth["points"], truth["normals"], device)
        nums = {"points_gap": abs(out.n_points - len(cloud)) / len(cloud)}
        c = out.candidates
        ids = np.asarray(c["attempt"]) * ATTEMPT_IDS + np.asarray(
            c["sample_id"])
        _, first = np.unique(ids, return_index=True)
        sp = torch.as_tensor(np.asarray(c["sample"])[first], device=device
                             ).to(f64)
        d = torch.cat([gpd._sq_dist(sp[b], cloud.points).amin(1)
                       for b in gpd._blocks(len(sp), 1024)]).sqrt() \
            if len(sp) else torch.zeros(0, dtype=f64, device=device)
        nums["samples_off"] = float((d > serve.SAME_POINT).double().mean()) \
            if len(d) else 0.0
        geo = _geometry_off(out.rows, cloud, spec, device) \
            if len(out.rows["label"]) else np.zeros(0, bool)
        nums["geometry_off"] = float(geo.mean()) if len(geo) else 0.0
        match, judged = _labels_judged(c, mesh, spec, device) \
            if len(c["label"]) else (np.zeros(0, bool),) * 2
        nums["labels_off"] = float(1.0 - match.mean()) if len(match) \
            else 0.0
        att = np.asarray(c["attempt"])
        pos = [int(judged[att == k].sum()) for k in range(out.attempts)]
        nums["attempts_off"] = float(
            stop_attempt(pos, dg["min_grasps_per_view"]) != out.attempts)
        nums["rows_off"] = _rows_off(out, dg["max_grasps_per_view"])
        nums["images_off"] = _image_off(out.images, out.rows, cloud, spec,
                                        device, generator)
    return nums


def _control_hands(c: dict, cloud: gpd.Cloud, spec: dict, device) -> dict:
    """The control's own candidates at the program's samples of every
    attempt (a draw both share): each sample's frame on ``cloud``, the
    orientation grid about it, and the valid hands there, in the program's
    order of samples, as ``serve.control`` makes a request's."""
    ids = c["attempt"] * ATTEMPT_IDS + c["sample_id"]
    uid, first = np.unique(ids, return_index=True)
    dt = cloud.points.dtype
    sp = torch.as_tensor(c["sample"][first], device=device).to(dt)
    frames, fvalid, _ = gpd.local_frames(sp, cloud,
                                         spec["nn_radius_frames"])
    grid = gpd.orientation_grid(spec["num_orientations"], spec["hand_axes"],
                                dt, device)
    M = len(grid)
    R = torch.matmul(frames[:, None], grid[None]).reshape(-1, 3, 3)
    S = sp.repeat_interleave(M, 0)
    h = gpd.hands_at(cloud, S, R, spec)
    live = (h.valid & fvalid.repeat_interleave(M)).cpu().numpy()
    row = np.repeat(first, M)[live]
    return dict(sample=S.cpu().numpy()[live],
                orientation=R.cpu().numpy()[live],
                top=h.top.cpu().numpy()[live],
                finger_placement=h.placement.cpu().numpy()[live],
                sample_id=c["sample_id"][row], attempt=c["attempt"][row])


def control(out: Outputs, raw: dict, truth: dict, config: dict, device,
            generator: torch.Generator, name: str) -> Outputs:
    """A control in the program's place, its labels balanced with the
    request's generator and its images made at the kept rows:

    - ``geometry``: the plain GPD in the configuration's float32 with TF32
      in every matrix product and distances formed as one
      (``gpd.matmul_distances``): the view's normals, the frames and the
      valid hands at the program's samples (``_control_hands``), their
      labels on the ground-truth cloud, the images;
    - ``view_labels``: a fault, the program's candidates relabelled against
      the view cloud in float64 instead of the ground-truth cloud."""
    spec, dg = config["detector"], config["datagen"]
    geometry = name == "geometry"
    dt = torch.float32 if geometry else torch.float64
    dist = gpd.matmul_distances() if geometry else contextlib.nullcontext()
    with serve.tf32(geometry), dist:
        cloud = gpd.preprocess(raw["points"], raw["cams"],
                               raw["view_points"], spec, device, dt)
        c = {k: np.asarray(v) for k, v in out.candidates.items()}
        if geometry:
            c = _control_hands(c, cloud, spec, device)
            against = ground_truth(truth["points"], truth["normals"],
                                   device, dt)
        else:
            against = cloud
        S, R, T, M = _tensors(c, device, dt)
        c["label"] = relabel(against, S, R, T, M, spec).long().cpu().numpy()
        keep = balance(c["label"], dg["max_grasps_per_view"], out.rng_seed)
        rows = {k: v[keep] for k, v in c.items()}
        Sr, Rr, Tr, Mr = _tensors(rows, device, dt)
        bottom, centre = bottoms_and_centres(Tr, Mr, spec)
        mask = torch.ones(len(cloud), dtype=torch.bool, device=device)
        images = gpd.images(cloud, mask, Sr, Rr, bottom, centre, spec,
                            generator).cpu().numpy()
    return Outputs(n_points=len(cloud), candidates=c, rows=rows,
                   images=images, attempts=out.attempts,
                   rng_seed=out.rng_seed)
