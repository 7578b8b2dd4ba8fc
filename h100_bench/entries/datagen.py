"""Entry ``datagen``: GPD's training-data generation (``generate_data``), one
job working through its list of (object, view) units.

A request is one unit: ``GraspDetector.preprocess_cloud`` of the view's
raw points in memory (pinned to the traffic's view capacity, as the port's
``tools/gen_dataset.py`` pins it), then ``DataGenerator.generate_view``
against the object's ground-truth cloud; it ends when the kept rows'
uint8 images and labels are on the host. The ground-truth clouds go to the
card in set-up, once per object (the mix's mesh capacity). The units are a
pool (``inputs/zoo_views.py``); requests cycle through it in an order drawn
from the seed, the window ending with the first whole pass after
``seconds``; each unit draws from generators seeded by the traffic's
``draw_seed`` and its index, so set-up's first pass over the pool captures
every CUDA graph the window replays, and every seed sends the same work.
Set-up goes on in whole passes until ``warm_until_s`` seconds after the
run started, holding each unit's rows through the next as the window
does: on an H100 this load ran ~3% slower until 22-43 s after the start,
a length that changed from run to run, and so spread the window's rate
and p95 from run to run; a generation job runs for hours, past it.
The configuration's ``datagen`` block sets the generator (the traffic's
tiny ``datagen`` block over it in the CPU tests).

Correct: ``check_requests`` of the window's first pass, drawn from the
seed before the window opens. Right after each of them the benchmark copies
what the unit produced (``capture``: the view's point count, every valid
candidate's hand and label, the kept rows' hands and images); after the
window ``reference/datagen.py`` judges each from the view's raw points and
the object's ground-truth cloud. A program whose generator keeps no hands
(``last_rows``) cannot be judged, and the run stops at once.

Traced: the readers get the trace's events and each traced unit's latency
and counters (``last_counts``).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from h100_bench import harness
from h100_bench import trace as tr
from h100_bench.entries import serve
from h100_bench.inputs import generate
from h100_bench.inputs.zoo_views import zoo_views


def datagen_spec(r: harness.Run) -> dict:
    """The data generator's settings of the run: the configuration's, with
    the traffic's (the tiny sizes) over them."""
    return {**r.config["datagen"], **r.traffic.get("datagen", {})}


class Pool:
    """The traffic's (object, view) units and the request that sends one."""

    def __init__(self, r: harness.Run, det, gen):
        import torch
        from gpd_tpu_torch.core.types import CloudArrays
        self.r, self.det, self.gen, self.torch = r, det, gen, torch
        self.items, self.objects = zoo_views(r.traffic)
        zero = np.zeros((1, 3), np.float32)
        self.meshes = [CloudArrays.from_numpy(
            o["points"], normals=o["normals"], view_points=zero,
            capacity=r.traffic["mesh_capacity"], device=det.device)
            for o in self.objects]

    def __len__(self):
        return len(self.items)

    def generator(self, i: int):
        return self.torch.Generator(device=self.r.device).manual_seed(
            generate.stream_seed(self.r.traffic["draw_seed"], i))

    def rng_seed(self, i: int) -> int:
        """The seed of unit ``i``'s NumPy generator, which balances its
        rows."""
        return generate.stream_seed(self.r.traffic["draw_seed"] + 1, i)

    def request(self, i: int):
        """One unit as a generation job runs it: (images, labels on the
        host, the preprocessed view)."""
        it = self.items[i]
        view = self.det.preprocess_cloud(
            it["points"], view_points=it["view_points"],
            cam_source=it["cam_source"],
            capacity=self.r.traffic["view_capacity"])
        images, labels = self.gen.generate_view(
            view, self.meshes[it["object"]], self.generator(i),
            np.random.default_rng(self.rng_seed(i)))
        return images, labels, view

    def raw(self, i: int) -> dict:
        it = self.items[i]
        return dict(points=it["points"], cams=it["cam_source"],
                    view_points=it["view_points"])

    def truth(self, i: int) -> dict:
        return self.objects[self.items[i]["object"]]


def capture(gen, pool: Pool, i: int, images: np.ndarray, view):
    """What a unit produced, on the host (``reference.datagen.Outputs``).
    The images are copied, so that the program's page-locked rows go back
    to its host allocator for the next unit, as a job's write drops
    them."""
    from h100_bench.reference.datagen import Outputs

    def host(hands):
        return {k: v.detach().cpu().numpy() for k, v in hands.items()}
    return Outputs(n_points=int(view.mask.sum()),
                   candidates=host(gen.last_candidates),
                   rows=host(gen.last_rows), images=np.array(images),
                   attempts=gen.last_counts["attempts"],
                   rng_seed=pool.rng_seed(i))


def reference_pass(r: harness.Run, pool: Pool, checked: List[tuple],
                   controls=()):
    """The judge over the checked units ((pool index, Outputs)), and each
    of ``controls`` in the program's place over the same. Returns (the
    numbers of each, {control: the numbers of each})."""
    import torch
    from h100_bench.reference import datagen as ref
    config = {**r.config, "datagen": datagen_spec(r)}
    nums, ctrl = [], {c: [] for c in controls}
    for k, (i, outs) in enumerate(checked):
        raw, truth = pool.raw(i), pool.truth(i)
        gen = torch.Generator(device=r.device).manual_seed(
            generate.stream_seed(r.seed, k))
        nums.append(ref.judge(outs, raw, truth, config, r.device, gen))
        for c in controls:
            c_out = ref.control(outs, raw, truth, config, r.device, gen, c)
            ctrl[c].append(ref.judge(c_out, raw, truth, config, r.device,
                                     gen))
        if r.device != "cpu":
            torch.cuda.empty_cache()
    return nums, ctrl


def run(r: harness.Run) -> harness.Outcome:
    import torch
    from gpd_tpu_torch.datagen import DataGenConfig, DataGenerator
    from gpd_tpu_torch.detector import GraspDetector
    cfg = serve.program_config(r.config["detector"],
                               r.path(r.config["weights"]))
    det = GraspDetector(cfg, device=r.device)
    gen = DataGenerator(det, DataGenConfig(**datagen_spec(r)))
    if not hasattr(gen, "last_rows"):
        raise RuntimeError("this program's data generator keeps no hands "
                           "(last_rows): its units cannot be judged")
    pool = Pool(r, det, gen)
    n = len(pool)
    t0 = time.perf_counter()
    # Each unit's rows are held through the next unit, as in the window,
    # so that set-up makes every page-locked block the window reuses.
    held = None
    for i in range(n):
        held = pool.request(i)
    r.sync()
    t1 = time.perf_counter()
    warm = 0
    while time.perf_counter() - r.t_start < r.traffic["warm_until_s"]:
        for i in range(n):
            held = pool.request(i)
        warm += 1
    r.sync()
    del held
    r.log(f"# set-up: {n} views of {len(pool.objects)} objects, first pass "
          f"{t1 - t0:.3f} s, {len(det.graphs)} graphs captured, {warm} more "
          f"passes in {time.perf_counter() - t1:.3f} s")
    r.log(serve.graphs_line(det))
    keys = len(det.graphs)
    cuda = r.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mix = r.traffic
    lat, failed, layer, checked, counts = [], 0, {}, [], []
    busy = window = bd = None
    order = generate.order(r.seed, n)
    # The checked units, drawn from the seed before the window: places in
    # the window's first pass (the traced window's units).
    first = mix["trace_requests"] if r.trace else n
    keep = set(np.random.default_rng(r.seed).permutation(first)[
        :mix["check_requests"]].tolist())
    if not r.trace:
        t_w0 = time.perf_counter()
        setup_s = t_w0 - r.t_start
        end = t_w0 + r.seconds
        k = 0
        # Whole passes over the pool: every seed sends the same units.
        while time.perf_counter() < end or k % n:
            i = next(order)
            k += 1
            t0 = time.perf_counter()
            try:
                images, _, view = pool.request(i)
            except Exception as e:  # a failed request counts as one
                failed += 1
                r.log(f"# request {k} failed: {e!r}")
                continue
            lat.append(time.perf_counter() - t0)
            counts.append(dict(gen.last_counts))
            if k - 1 in keep:
                checked.append((i, capture(gen, pool, i, images, view)))
        t_w1 = time.perf_counter()
        lat = np.array(lat)
        e2e = {"setup_s": setup_s,
               "requests_per_s": len(lat) / (t_w1 - t_w0),
               "request_p95_ms": float(np.percentile(lat, 95)) * 1e3
               if len(lat) else float("inf")}
        r.log(f"# window {t_w1 - t_w0:.3f} s: {len(lat)} views, "
              f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p95 "
              f"{e2e['request_p95_ms']:.3f} ms, max {lat.max() * 1e3:.3f} ms")
        r.log("# passes' mean latency (ms): " + " ".join(
            f"{lat[j:j + n].mean() * 1e3:.2f}" for j in range(0, len(lat), n)))
    else:
        setup_s = time.perf_counter() - r.t_start
        e2e = {"setup_s": setup_s}
        prof = tr.profiler()
        with prof:
            with tr.span(tr.WINDOW):
                for k in range(mix["trace_requests"]):
                    i = next(order)
                    t0 = time.perf_counter()
                    images, _, view = pool.request(i)
                    lat.append(time.perf_counter() - t0)
                    counts.append(dict(gen.last_counts))
                    if k in keep:
                        checked.append((i, capture(gen, pool, i, images,
                                                   view)))
        evs = tr.events(prof, r.tmp)
        s = tr.summary(evs)
        busy, window, bd = s["busy_s"], s["window_s"], s["breakdown"]
        layer = dict(events=evs, window=s["window"],
                     views=[dict(latency_s=t, **c)
                            for t, c in zip(lat, counts)])
    per_view = {k: sum(c[k] for c in counts) / max(len(counts), 1)
                for k in ("attempts", "candidates", "kept")}
    r.log(f"# per view: {per_view}")
    if len(det.graphs) != keys:
        r.log(f"# the window captured {len(det.graphs) - keys} graphs")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    del det, gen, pool.det, pool.gen
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    nums, ctrl = reference_pass(r, pool, checked, r.controls)
    r.log(f"# reference over {len(checked)} views in "
          f"{time.perf_counter() - t0:.3f} s")
    for (i, o), nm in zip(checked, nums):
        r.log(f"# view (pool {i}, {o.attempts} attempts, "
              f"{len(o.candidates['label'])} candidates, "
              f"{len(o.rows['label'])} rows): " + ", ".join(
                  f"{a} {b!r}" for a, b in nm.items()))
    checks = serve.checks_of(nums, r.workload["limits"]) if nums else [
        harness.Check("requests_checked", 1.0, 0.0)]
    return harness.Outcome(setup_s=setup_s, attempted=len(lat) + failed,
                           failed=failed, end_to_end=e2e, checks=checks,
                           memory_peak_bytes=peak, layer=layer, busy_s=busy,
                           window_s=window, breakdown=bd, numbers=nums,
                           control=ctrl)
