"""Entry ``serve``: grasp requests from one client in a closed loop, the
robot that waits for each answer before it sends the next cloud.

A request is ``GraspDetector.preprocess_cloud`` + ``detect`` on a cloud in
memory (traffic ``input`` "memory"), or ``detect_file`` on an ascii PCD
file (``input`` "pcd"); it ends when the selected grasps are on the host.
The clouds are a pool (``inputs.generate``); requests cycle through it in
an order drawn from the seed, the window ending with the first whole pass
after ``seconds``, each pool entry with draws seeded from the
traffic's ``draw_seed`` and its index, so set-up's one pass over the pool
captures every CUDA graph the window replays, and every seed sends the
same work.

Correct: ``check_requests`` of the window's first pass, drawn from the
seed before the window opens. Right after each of them the benchmark
copies what the request produced (``capture``: the hand slots the
program scored, its selection, its point count and, from memory, its
cloud); after the window ``reference/serve.py`` judges each against the
plain GPD run from the request's raw input.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from h100_bench import harness
from h100_bench import trace as tr
from h100_bench.inputs import generate

def program_config(spec: dict, weights: str):
    """The program's DetectorConfig from a configuration file."""
    from gpd_tpu_torch.config import (DetectorConfig, HandGeometry,
                                      ImageGeometry)
    d = dict(spec)
    return DetectorConfig(
        hand_geometry=HandGeometry(**d.pop("hand_geometry")),
        image_geometry=ImageGeometry(**d.pop("image_geometry")),
        weights_file=weights,
        **{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def graphs_line(det) -> str:
    """The detector's captured CUDA graphs by program: count, capture
    seconds and pool bytes (``CapturedGraph.capture_s``, ``pool_bytes``)."""
    by = {}
    for key, g in det.graphs.items():
        n, s, b = by.get(key[0], (0, 0.0, 0))
        by[key[0]] = (n + 1, s + g.capture_s, b + g.pool_bytes)
    return "# graphs (count, capture s, pool bytes): " + ", ".join(
        f"{k} {n} {s:.3f} {b}" for k, (n, s, b) in by.items())


def to_host(out) -> np.ndarray:
    """The selected grasps on the host: (n, 15) float32 rows of position
    (3), rotation (9), score, sample id."""
    import torch
    v = out.valid
    rows = torch.cat([out.position, out.orientation.reshape(-1, 9),
                      out.score[:, None], out.sample_id[:, None].float()],
                     1)[v]
    return rows.cpu().numpy()


class Pool:
    """The traffic's clouds and the request that sends one."""

    def __init__(self, r: harness.Run, det):
        import torch
        self.r, self.det, self.torch = r, det, torch
        mix = r.traffic
        if mix["input"] == "memory":
            self.items = generate.table_scenes(mix)
        else:
            self.items = generate.pcd_files(mix, r.tmp)
        self.cam = np.asarray(r.config["detector"]["camera_position"],
                              np.float32).reshape(1, 3)

    def __len__(self):
        return len(self.items)

    def generator(self, i: int):
        return self.torch.Generator(device=self.r.device).manual_seed(
            generate.stream_seed(self.r.traffic["draw_seed"], i))

    def request(self, i: int):
        """One request as a user sends it: (the selected grasps on the
        host, the cloud it preprocessed from memory or None)."""
        det, it = self.det, self.items[i]
        cloud = None
        if self.r.traffic["input"] == "memory":
            cloud = det.preprocess_cloud(it["points"],
                                         view_points=it["view_points"],
                                         cam_source=it["cam_source"])
            out = det.detect(cloud, generator=self.generator(i),
                             verbose=False)
        else:
            out = det.detect_file(it, generator=self.generator(i),
                                  verbose=False)
        return to_host(out), cloud

    def request_split(self, i: int):
        """The same request with the preprocessing timed on its own, up to
        a device sync, and each step in a span of the benchmark's (the
        traced run's): (grasps, cloud from memory or None, preprocess
        seconds). From a file it runs the two steps
        ``detect_file`` is made of, the read and
        ``preprocess_cloud(capacity="serve")``."""
        from gpd_tpu_torch.io.pcd import load_cloud_file
        det, it = self.det, self.items[i]
        t0 = time.perf_counter()
        memory = self.r.traffic["input"] == "memory"
        if memory:
            with tr.span("bench_preprocess"):
                cloud = det.preprocess_cloud(it["points"],
                                             view_points=it["view_points"],
                                             cam_source=it["cam_source"])
                self.r.sync()
        else:
            with tr.span("bench_read_file"):
                points = load_cloud_file(it)
            with tr.span("bench_preprocess"):
                cloud = det.preprocess_cloud(points, view_points=self.cam,
                                             capacity="serve")
                self.r.sync()
        t_pre = time.perf_counter() - t0
        with tr.span("bench_detect"):
            out = det.detect(cloud, generator=self.generator(i),
                             verbose=False)
        with tr.span("bench_to_host"):
            host = to_host(out)
        return host, cloud if memory else None, t_pre

    def raw(self, i: int) -> dict:
        """The reference's input, read or made by the benchmark: points,
        camera bitmasks (None: every point seen by camera 0) and camera
        positions."""
        it = self.items[i]
        if self.r.traffic["input"] == "memory":
            return dict(points=it["points"], cams=it["cam_source"],
                        view_points=it["view_points"])
        return dict(points=generate.read_pcd(it), cams=None,
                    view_points=self.cam)


def _last_scored(det):
    """The scored hand slots of the detector's last request: the outputs
    of its last ``score`` program (on a card, the CUDA graph's own
    outputs, which its next replay rewrites; on the CPU, where the
    programs run eagerly and keep nothing, as ``record_scored`` kept
    them)."""
    from gpd_tpu_torch import detector
    for key in reversed(det.last_graphs):
        if key[0] == "score":
            return det.graphs[key].out[0]
    return detector.score_candidates.last


def record_scored():
    """On the CPU: ``score_candidates`` keeps its last scored slots in its
    attribute ``last``, once installed for the process."""
    from gpd_tpu_torch import detector
    real = detector.score_candidates
    if hasattr(real, "last"):
        return

    def recorded(*a, **k):
        out = real(*a, **k)
        recorded.last = out[0]
        return out
    recorded.last = None
    detector.score_candidates = recorded


def capture(det, host: np.ndarray, cloud=None):
    """What a request produced, on the host (``reference.serve.Outputs``):
    the hand slots the search made (the first samples x orientations rows
    of the scored batch, the rest being padding), the selection, the point
    count and the cloud from memory."""
    from h100_bench.reference.serve import SLOT_FIELDS, Outputs
    g = _last_scored(det)
    cfg = det.cfg
    n = cfg.num_samples * cfg.num_orientations * len(cfg.hand_axes)
    slots = {f: getattr(g, f)[:n].detach().cpu().numpy()
             for f in SLOT_FIELDS}
    out = Outputs(n_points=det.last_counts["points"], slots=slots,
                  selected=host)
    if cloud is not None:
        m = cloud.mask
        out.cloud_points = cloud.points[m].cpu().numpy()
        out.cloud_normals = cloud.normals[m].cpu().numpy()
    return out


def reference_pass(r: harness.Run, pool: Pool, checked: List[tuple],
                   controls=()):
    """The judge over the checked requests ((pool index, Outputs)), and
    each of ``controls`` in the program's place over the same. Returns
    (the numbers of each, {control: the numbers of each})."""
    import torch
    from h100_bench.reference import gpd
    from h100_bench.reference import serve as ref
    weights = gpd.load_lenet(r.path(r.config["weights"]), r.device)
    nums, ctrl = [], {c: [] for c in controls}
    for k, (i, outs) in enumerate(checked):
        raw = pool.raw(i)
        gen = torch.Generator(device=r.device).manual_seed(
            generate.stream_seed(r.seed, k))
        nums.append(ref.judge(outs, raw, r.config, weights, r.device, gen))
        # The program's samples, in its sample order (an unfilled one far
        # away, where it has no hand).
        _, first = np.unique(outs.slots["sample_id"], return_index=True)
        samples = outs.slots["sample"][first]
        for c in controls:
            c_out = ref.control(raw, samples, r.config, weights, r.device,
                                gen, c)
            if outs.cloud_points is None:
                c_out.cloud_points = c_out.cloud_normals = None
            ctrl[c].append(ref.judge(c_out, raw, r.config, weights,
                                     r.device, gen))
        if r.device != "cpu":
            torch.cuda.empty_cache()
    return nums, ctrl


def checks_of(nums: List[dict], limits: dict) -> List[harness.Check]:
    return [harness.Check(name, max(n[name] for n in nums), limit)
            for name, limit in limits.items()]


def run(r: harness.Run) -> harness.Outcome:
    import torch
    from gpd_tpu_torch.detector import GraspDetector
    if r.device == "cpu":
        record_scored()
    cfg = program_config(r.config["detector"], r.path(r.config["weights"]))
    det = GraspDetector(cfg, device=r.device)
    pool = Pool(r, det)
    n = len(pool)
    t0 = time.perf_counter()
    for i in range(n):
        pool.request(i)
    r.sync()
    r.log(f"# set-up: {n} clouds, warm pass {time.perf_counter() - t0:.3f} "
          f"s, {len(det.graphs)} graphs captured")
    r.log(graphs_line(det))
    keys = len(det.graphs)
    cuda = r.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mix = r.traffic
    lat, failed, layer, checked = [], 0, {}, []
    busy = window = bd = None
    order = generate.order(r.seed, n)
    # The checked requests, drawn from the seed before the window: places
    # in the window's first pass (the traced window's requests).
    first = mix["trace_requests"] if r.trace else n
    keep = set(np.random.default_rng(r.seed).permutation(first)[
        :mix["check_requests"]].tolist())
    if not r.trace:
        t_w0 = time.perf_counter()
        setup_s = t_w0 - r.t_start
        end = t_w0 + r.seconds
        k = 0
        # Whole passes over the pool: every seed sends the same requests.
        while time.perf_counter() < end or k % n:
            i = next(order)
            k += 1
            t0 = time.perf_counter()
            try:
                host, cloud = pool.request(i)
            except Exception as e:  # a failed request counts as one
                failed += 1
                r.log(f"# request {k} failed: {e!r}")
                continue
            lat.append(time.perf_counter() - t0)
            if k - 1 in keep:
                checked.append((i, capture(det, host, cloud)))
        t_w1 = time.perf_counter()
        lat = np.array(lat)
        e2e = {"setup_s": setup_s,
               "requests_per_s": len(lat) / (t_w1 - t_w0),
               "request_p95_ms": float(np.percentile(lat, 95)) * 1e3
               if len(lat) else float("inf")}
        r.log(f"# window {t_w1 - t_w0:.3f} s: {len(lat)} requests, "
              f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p95 "
              f"{e2e['request_p95_ms']:.3f} ms, max {lat.max() * 1e3:.3f} ms")
    else:
        setup_s = time.perf_counter() - r.t_start
        e2e = {"setup_s": setup_s}
        prof = tr.profiler()
        pre, traced = [], []
        with prof:
            with tr.span(tr.WINDOW):
                for k in range(mix["trace_requests"]):
                    i = next(order)
                    t0 = time.perf_counter()
                    host, cloud, t_pre = pool.request_split(i)
                    lat.append(time.perf_counter() - t0)
                    pre.append(t_pre)
                    # Every traced request's hands count toward the
                    # rooflines; the copy is left out of its latency.
                    traced.append((i, capture(det, host, cloud)))
                    if k in keep:
                        checked.append(traced[-1])
        evs = tr.events(prof, r.tmp)
        s = tr.summary(evs)
        busy, window, bd = s["busy_s"], s["window_s"], s["breakdown"]
        layer = dict(events=evs, window=s["window"], preprocess_s=pre,
                     channels=cfg.image_geometry.num_channels,
                     size=cfg.image_geometry.size)
    if len(det.graphs) != keys:
        r.log(f"# the window captured {len(det.graphs) - keys} graphs")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    del det, pool.det
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    nums, ctrl = reference_pass(r, pool, checked, r.controls)
    r.log(f"# reference over {len(checked)} requests in "
          f"{time.perf_counter() - t0:.3f} s")
    for (i, _), nm in zip(checked, nums):
        r.log(f"# request (pool {i}): " + ", ".join(
            f"{a} {b!r}" for a, b in nm.items()))
    checks = checks_of(nums, r.workload["limits"]) if nums else [
        harness.Check("requests_checked", 1.0, 0.0)]
    if r.trace:
        from h100_bench.reference import serve as ref
        layer["requests"] = [
            dict(latency_s=t, **ref.work(o, pool.raw(i), r.config["detector"],
                                         r.device))
            for t, (i, o) in zip(lat, traced)]
    return harness.Outcome(setup_s=setup_s, attempted=len(lat) + failed,
                           failed=failed, end_to_end=e2e, checks=checks,
                           memory_peak_bytes=peak, layer=layer, busy_s=busy,
                           window_s=window, breakdown=bd, numbers=nums,
                           control=ctrl)
