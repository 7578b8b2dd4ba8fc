"""Visualization, host-side and optional (port of gpd_tpu/viz.py).

Equivalent of the reference's ``util::Plot`` PCLVisualizer wrappers
(reference: src/gpd/util/plot.cpp): headless matplotlib renders and PLY
dumps instead of an interactive VTK window. The geometry is NumPy;
matplotlib is imported only inside the plotting functions. Arrays may be
host arrays or tensors on any device, and grasps a list of dicts
(``Grasps.to_host_list``) or a ``Grasps`` batch (its valid rows).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gpd_tpu_torch.core.types import Grasps


def _host(a) -> np.ndarray:
    """A host array of ``a`` (a tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _grasp_list(grasps):
    """A list of grasp dicts from a ``Grasps`` batch (its valid rows) or a
    sequence of dicts."""
    if isinstance(grasps, Grasps):
        return grasps.to_host_list()
    return list(grasps)


def save_cloud_ply(path: str, points: np.ndarray,
                   normals: Optional[np.ndarray] = None,
                   colors: Optional[np.ndarray] = None) -> None:
    """Dump a cloud (+normals/colors) as ascii PLY for external viewers."""
    points = _host(points).astype(np.float32)
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(_host(normals).astype(np.float32))
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
        data = np.concatenate(cols, axis=1)
        for i in range(n):
            row = " ".join(f"{v:.6f}" for v in data[i])
            if colors is not None:
                c = _host(colors[i]).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


def hand_segments(position: np.ndarray, R: np.ndarray,
                  outer_diameter: float = 0.12, depth: float = 0.06,
                  finger_width: float = 0.01) -> np.ndarray:
    """Line segments sketching a 2-finger hand (like plotFingers3D,
    plot.cpp:174-371): base bar + two fingers + approach stub.
    Returns (4, 2, 3) segment endpoints."""
    position, R = _host(position), _host(R)
    approach, binormal = R[:, 0], R[:, 1]
    half = 0.5 * (outer_diameter - finger_width)
    left_base = position + half * binormal
    right_base = position - half * binormal
    return np.array([
        [left_base, right_base],                          # base bar
        [left_base, left_base + depth * approach],        # left finger
        [right_base, right_base + depth * approach],      # right finger
        [position, position - 0.04 * approach],           # approach stub
    ])


def plot_grasps(points: np.ndarray, grasps: Sequence[dict],
                path: Optional[str] = None, max_grasps: int = 20,
                hand_geometry=None):
    """Matplotlib 3D render of cloud + hands (plotFingers3D equivalent)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    pts = _host(points)
    step = max(1, len(pts) // 5000)
    ax.scatter(pts[::step, 0], pts[::step, 1], pts[::step, 2], s=1,
               c="gray", alpha=0.5)
    od, dp, fw = 0.12, 0.06, 0.01
    if hand_geometry is not None:
        od, dp, fw = (hand_geometry.outer_diameter, hand_geometry.depth,
                      hand_geometry.finger_width)
    for g in _grasp_list(grasps)[:max_grasps]:
        segs = hand_segments(g["position"], g["orientation"], od, dp, fw)
        for a, b in segs:
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="tab:blue")
    ax.set_box_aspect((1, 1, 1))
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def hand_volume_boxes(position: np.ndarray, R: np.ndarray,
                      outer_diameter: float = 0.12, depth: float = 0.06,
                      finger_width: float = 0.01,
                      height: float = 0.02) -> np.ndarray:
    """The four oriented cuboids of the reference's 3D hand rendering
    (plotHand3D, plot.cpp:380-411): left finger, right finger, base bar,
    approach stub. Returns (4, 8, 3) corner vertices in world frame.

    Box extents follow the reference exactly: fingers depth x finger_width
    x height, base 0.02 x outer_diameter x height (center 0.01 behind the
    hand along -approach), approach stub 0.07 x finger_width x height/2
    (center 0.04 further behind)."""
    position = _host(position).astype(np.float64)
    R = _host(R).astype(np.float64)
    approach, binormal = R[:, 0], R[:, 1]
    hw = 0.5 * outer_diameter
    left_bottom = position - (hw - 0.5 * finger_width) * binormal
    right_bottom = position + (hw - 0.5 * finger_width) * binormal
    left_center = left_bottom + 0.5 * depth * approach
    right_center = right_bottom + 0.5 * depth * approach
    base_center = 0.5 * (left_bottom + right_bottom) - 0.01 * approach
    approach_center = base_center - 0.04 * approach

    specs = [
        (left_center, (depth, finger_width, height)),
        (right_center, (depth, finger_width, height)),
        (base_center, (0.02, outer_diameter, height)),
        (approach_center, (0.07, finger_width, 0.5 * height)),
    ]
    corners = np.array([[sx, sy, sz] for sx in (-0.5, 0.5)
                        for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)])
    boxes = []
    for center, dims in specs:
        local = corners * np.asarray(dims)
        boxes.append(center + local @ R.T)
    return np.stack(boxes)


_BOX_FACES = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
              (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]


def plot_hands_3d(points: np.ndarray, grasps: Sequence[dict],
                  path: Optional[str] = None, max_grasps: int = 20,
                  hand_geometry=None, color_by: str = "score"):
    """Solid hand-volume render (plotFingers3D / plotAntipodalHands,
    plot.cpp:174-310): each hand drawn as its four translucent cuboids over
    the cloud. ``color_by``: 'score' (red->green ramp like
    plotFingers3D's use_same_color=false), 'antipodal' (green/red like
    plotAntipodalHands), or 'fixed' (teal)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    pts = _host(points)
    step = max(1, len(pts) // 5000)
    ax.scatter(pts[::step, 0], pts[::step, 1], pts[::step, 2], s=1,
               c="gray", alpha=0.4)
    od, dp, fw, hh = 0.12, 0.06, 0.01, 0.02
    if hand_geometry is not None:
        od, dp, fw, hh = (hand_geometry.outer_diameter, hand_geometry.depth,
                          hand_geometry.finger_width, hand_geometry.height)
    gs = _grasp_list(grasps)[:max_grasps]
    scores = [float(g.get("score", 0.0)) for g in gs]
    smin, smax = (min(scores), max(scores)) if scores else (0.0, 1.0)
    for g, s in zip(gs, scores):
        if color_by == "antipodal":
            rgb = (0.0, 0.7, 0.0) if g.get("full_antipodal") else (0.7, 0, 0)
        elif color_by == "score" and smax > smin:
            c = (s - smin) / (smax - smin)
            rgb = (1.0 - c, c, 0.0)
        else:
            rgb = (0.0, 0.5, 0.5)
        boxes = hand_volume_boxes(g["position"], g["orientation"], od, dp,
                                  fw, hh)
        for box in boxes:
            faces = [[box[i] for i in face] for face in _BOX_FACES]
            ax.add_collection3d(Poly3DCollection(
                faces, facecolors=[rgb], alpha=0.25, edgecolors=[rgb]))
    ax.set_box_aspect((1, 1, 1))
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def volume_box(position: np.ndarray, R: np.ndarray, volume_depth: float,
               volume_width: float, volume_height: float) -> np.ndarray:
    """Corner vertices (8, 3) of a hand's image-volume cube: a
    volume_depth x volume_width x volume_height box centered at
    position + 0.5*volume_depth*approach, oriented by the hand frame
    (plotVolumes3D / plotCube, plot.cpp:97-173)."""
    position = _host(position).astype(np.float64)
    R = _host(R).astype(np.float64)
    center = position + 0.5 * volume_depth * R[:, 0]
    corners = np.array([[sx, sy, sz] for sx in (-0.5, 0.5)
                        for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)])
    dims = np.array([volume_depth, volume_width, volume_height])
    return center + (corners * dims) @ R.T


def plot_volumes_3d(points: np.ndarray, grasps: Sequence[dict],
                    path: Optional[str] = None, max_grasps: int = 20,
                    hand_geometry=None, image_geometry=None):
    """Hands plus their associated image volumes (plotVolumes3D,
    plot.cpp:97-173): each valid hand as teal cuboids with a translucent
    green volume cube around its closing region, over the cloud."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    grasps = _grasp_list(grasps)
    fig = plot_hands_3d(points, grasps, path=None, max_grasps=max_grasps,
                        hand_geometry=hand_geometry, color_by="fixed")
    ax = fig.axes[0]
    vd, vw, vh = 0.06, 0.10, 0.02
    if image_geometry is not None:
        vd = image_geometry.depth
        vw = image_geometry.outer_diameter
        vh = 2.0 * image_geometry.height
    for g in grasps[:max_grasps]:
        box = volume_box(g["position"], g["orientation"], vd, vw, vh)
        faces = [[box[i] for i in face] for face in _BOX_FACES]
        ax.add_collection3d(Poly3DCollection(
            faces, facecolors=[(0.0, 0.8, 0.0)], alpha=0.10,
            edgecolors=[(0.0, 0.8, 0.0)]))
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_hand_geometry(grasp: dict, points: np.ndarray,
                       hand_geometry=None, image_geometry=None,
                       path: Optional[str] = None):
    """Single-hand geometry debug view (plotHandGeometry, plot.cpp:9-62):
    the hand's cuboids + image-volume cube with the configured dimensions
    annotated (hand depth/outer_diameter/height, finger width, volume
    extents) — headless matplotlib instead of the reference's VTK window."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    od, dp, fw, hh = 0.12, 0.06, 0.01, 0.02
    if hand_geometry is not None:
        od, dp, fw, hh = (hand_geometry.outer_diameter, hand_geometry.depth,
                          hand_geometry.finger_width, hand_geometry.height)
    vd, vw, vh = 0.06, 0.10, 0.02
    if image_geometry is not None:
        vd = image_geometry.depth
        vw = image_geometry.outer_diameter
        vh = 2.0 * image_geometry.height
    fig = plot_volumes_3d(points, [grasp], path=None, max_grasps=1,
                          hand_geometry=hand_geometry,
                          image_geometry=image_geometry)
    ax = fig.axes[0]
    ax.set_title(
        f"hand_depth={dp}  hand_outer_diameter={od}  hand_height*2={2 * hh}\n"
        f"finger_width={fw}  volume_depth={vd}  volume_width={vw}  "
        f"volume_height*2={vh}", fontsize=9)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_normals(points: np.ndarray, normals: np.ndarray,
                 path: Optional[str] = None, stride: int = 20):
    """Quiver render of surface normals (plotNormals, plot.cpp:498-668)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    p = _host(points)[::stride]
    n = _host(normals)[::stride]
    ax.quiver(p[:, 0], p[:, 1], p[:, 2], n[:, 0], n[:, 1], n[:, 2],
              length=0.01, normalize=True, linewidth=0.5)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def grasp_image_grid(image: np.ndarray, path: Optional[str] = None):
    """Render a multi-channel grasp image as a grid (the showImage debug
    view, image_15_channels_strategy.cpp:107-141)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    image = _host(image)
    c = image.shape[-1]
    cols = min(c, 5)
    rows = -(-c // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_2d(axes)
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        ax.axis("off")
        if i < c:
            ax.imshow(image[:, :, i], cmap="gray", vmin=0, vmax=255)
            ax.set_title(f"ch {i}", fontsize=8)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_loss_stats(log_file: str, path: Optional[str] = None):
    """Training-curve plot (replaces pytorch/plot_loss_stats.py): reads the
    'step,loss,accuracy' CSV written by gpd_tpu_torch.net.train."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.loadtxt(log_file, delimiter=",").reshape(-1, 3)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.plot(data[:, 0], data[:, 1])
    ax1.set_xlabel("step")
    ax1.set_ylabel("loss")
    ax2.plot(data[:, 0], data[:, 2])
    ax2.set_xlabel("step")
    ax2.set_ylabel("accuracy")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig
