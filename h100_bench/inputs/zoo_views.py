"""The traffic kind ``zoo_views``: single-object views for data generation.

``objects`` objects of ``object_zoo`` (``zoo_seed``, ``points_per_object``
surface points with their normals each, the ground-truth clouds), each
seen from ``views_per_object`` cameras drawn by ``view_cameras`` from
``camera_seed``: even views by one camera, odd views by two fused ones, a
raw view randomly cut to ``view_capacity`` points where it has more, and a
view of fewer than ``min_view_points`` points left out (the port's
``tools/gen_dataset.py`` builds its single-object items so). Everything
comes from the mix's fixed seeds, so every run seed sends the same work.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from h100_bench.inputs import synthetic as syn


def zoo_views(mix: dict) -> Tuple[List[dict], List[dict]]:
    """(views, objects): per view {object (index), view, points,
    cam_source (None for one camera), view_points}; per object {name,
    points, normals}."""
    objects, views = [], []
    rng = np.random.default_rng(mix["camera_seed"])
    zoo = syn.object_zoo(mix["objects"], seed=mix["zoo_seed"],
                         points_per_object=mix["points_per_object"])
    for o, (name, mpts, mnrm) in enumerate(zoo):
        objects.append(dict(name=name, points=mpts, normals=mnrm))
        cams = syn.view_cameras(rng, 2 * mix["views_per_object"])
        for v in range(mix["views_per_object"]):
            if v % 2:
                pts, cs, vps = syn.render_fused_views(
                    rng, mpts, mnrm, cams[2 * v:2 * v + 2], occluded=False)
            else:
                pts = syn.render_view(rng, mpts, mnrm, cams[2 * v])
                cs, vps = None, cams[2 * v].reshape(1, 3)
            if len(pts) < mix["min_view_points"]:
                continue
            if len(pts) > mix["view_capacity"]:
                idx = rng.choice(len(pts), mix["view_capacity"],
                                 replace=False)
                pts = pts[idx]
                cs = None if cs is None else cs[idx]
            views.append(dict(object=o, view=v, points=pts, cam_source=cs,
                              view_points=vps))
    return views, objects
