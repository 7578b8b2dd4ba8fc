"""Entry ``cem``: CEM grasp requests, GPD's sequential importance sampling
(``cem_detect_grasps``), from one client in a closed loop.

A request is ``GraspDetector.preprocess_cloud`` on a cloud in memory, then
``SequentialImportanceSampling(det, CEMConfig(...)).detect`` on its fused
route (on a card two CUDA graphs replayed back to back: R, the rounds, and
S, the scoring and the selection); it ends when the selected grasps are on
the host. The configuration's ``cem`` block sets the sampling (the
traffic's tiny ``cem`` block over it in the CPU tests). The pool, its
order, the window and the checked requests are those of ``serve``: set-up
sends each pool entry once, capturing every graph the window replays.

Correct: right after each checked request the benchmark copies what it
produced: every round's scored hand slots (``last_scored`` at
``last_round_slots``), its selection, its point count and its cloud. After
the window each checked request runs again by the loop (``_force_loop``)
from the same generator seed, whose round counts the fused route's must
equal (``loop_rounds_off``), and ``reference/cem.py`` judges it from the
request's raw input. A program whose CEM keeps no scored batch cannot be
judged, and the run stops at once.

Traced: the readers get the trace's events, and each traced request's
latency and counters (``last_counts``: its valid hands of every round and
the image slots its scoring passes computed).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from h100_bench import harness
from h100_bench import trace as tr
from h100_bench.entries import serve
from h100_bench.inputs import generate


def cem_spec(r: harness.Run) -> dict:
    """The CEM settings of the run: the configuration's, with the
    traffic's (the tiny sizes) over them."""
    return {**r.config["cem"], **r.traffic.get("cem", {})}


class Pool(serve.Pool):
    """The traffic's clouds and the CEM request that sends one."""

    def __init__(self, r: harness.Run, det, sis):
        super().__init__(r, det)
        self.sis = sis

    def request(self, i: int):
        """One request as a user sends it: (the selected grasps on the
        host, the preprocessed cloud)."""
        it = self.items[i]
        cloud = self.det.preprocess_cloud(it["points"],
                                          view_points=it["view_points"],
                                          cam_source=it["cam_source"])
        out = self.sis.detect(cloud, generator=self.generator(i),
                              verbose=False)
        return serve.to_host(out), cloud

    def request_split(self, i: int):
        """The same request with the preprocessing timed on its own, up to
        a device sync, and each step in a span of the benchmark's (the
        traced run's): (grasps, cloud, preprocess seconds)."""
        it = self.items[i]
        t0 = time.perf_counter()
        with tr.span("bench_preprocess"):
            cloud = self.det.preprocess_cloud(it["points"],
                                              view_points=it["view_points"],
                                              cam_source=it["cam_source"])
            self.r.sync()
        t_pre = time.perf_counter() - t0
        with tr.span("bench_detect"):
            out = self.sis.detect(cloud, generator=self.generator(i),
                                  verbose=False)
        with tr.span("bench_to_host"):
            host = serve.to_host(out)
        return host, cloud, t_pre


def capture(sis, host: np.ndarray, cloud):
    """What a request produced, on the host (``reference.cem.Outputs``):
    each round's hand slots of the scored batch, the selection, the point
    count and the cloud."""
    from h100_bench.reference.cem import Outputs
    from h100_bench.reference.serve import SLOT_FIELDS
    g = sis.last_scored
    whole = {f: getattr(g, f).detach().cpu().numpy() for f in SLOT_FIELDS}
    rounds = [{f: v[a:a + n] for f, v in whole.items()}
              for a, n in sis.last_round_slots]
    m = cloud.mask
    points = cloud.points[m].cpu().numpy()
    return Outputs(n_points=len(points), rounds=rounds, selected=host,
                   cloud_points=points,
                   cloud_normals=cloud.normals[m].cpu().numpy())


def loop_rounds_off(sis, pool: Pool, checked: List[tuple]) -> List[float]:
    """Per checked request (pool index, outputs, cloud, round counts): the
    share of its rounds whose count the loop, from the same generator
    seed, does not find."""
    sis._force_loop = True
    try:
        out = []
        for i, _, cloud, counts in checked:
            sis.detect(cloud, generator=pool.generator(i), verbose=False)
            loop = sis.last_round_counts
            out.append(sum(a != b for a, b in zip(counts, loop))
                       / len(counts) if len(loop) == len(counts) else 1.0)
        return out
    finally:
        sis._force_loop = False


def reference_pass(r: harness.Run, pool: Pool, checked: List[tuple],
                   controls=()):
    """The judge over the checked requests, and each of ``controls`` in
    the program's place over the same. Returns (the numbers of each,
    {control: the numbers of each})."""
    import torch
    from h100_bench.reference import cem as ref
    from h100_bench.reference import gpd
    weights = gpd.load_lenet(r.path(r.config["weights"]), r.device)
    config = {**r.config, "cem": cem_spec(r)}
    nums, ctrl = [], {c: [] for c in controls}
    for k, (i, outs, _, _) in enumerate(checked):
        raw = pool.raw(i)
        gen = torch.Generator(device=r.device).manual_seed(
            generate.stream_seed(r.seed, k))
        nums.append(ref.judge(outs, raw, config, weights, r.device, gen))
        for c in controls:
            c_out = ref.control(outs, raw, config, weights, r.device, gen, c)
            ctrl[c].append({**ref.judge(c_out, raw, config, weights,
                                        r.device, gen),
                            "loop_rounds_off": 0.0})
        if r.device != "cpu":
            torch.cuda.empty_cache()
    return nums, ctrl


def graph_launches(events) -> List[int]:
    """Each traced request's ``cudaGraphLaunch`` calls inside its
    ``cem_detect`` span."""
    calls = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
             and e.get("name", "").startswith("cudaGraphLaunch")]
    return [sum(1 for t in calls if s["ts"] <= t <= s["ts"] + s["dur"])
            for s in tr.spans(events, "cem_detect")]


def run(r: harness.Run) -> harness.Outcome:
    import torch
    from gpd_tpu_torch.cem import SequentialImportanceSampling
    from gpd_tpu_torch.config import CEMConfig
    from gpd_tpu_torch.detector import GraspDetector
    cfg = serve.program_config(r.config["detector"],
                               r.path(r.config["weights"]))
    det = GraspDetector(cfg, device=r.device)
    sis = SequentialImportanceSampling(det, CEMConfig(**cem_spec(r)))
    if not hasattr(sis, "last_scored"):
        raise RuntimeError("this program's CEM keeps no scored batch "
                           "(last_scored): its requests cannot be judged")
    pool = Pool(r, det, sis)
    n = len(pool)
    t0 = time.perf_counter()
    for i in range(n):
        pool.request(i)
    r.sync()
    r.log(f"# set-up: {n} clouds, warm pass {time.perf_counter() - t0:.3f} "
          f"s, {len(det.graphs)} detector graphs, {len(sis.graphs)} CEM keys "
          f"captured")
    r.log(serve.graphs_line(det))
    r.log(f"# CEM keys (count, capture s, pool bytes): {len(sis.graphs)} "
          f"{sum(g.capture_s for g in sis.graphs.values()):.3f} "
          f"{sis.pool_bytes}")
    keys = (len(det.graphs), len(sis.graphs))
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
                checked.append((i, capture(sis, host, cloud), cloud,
                                list(sis.last_round_counts)))
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
        pre, counters = [], []
        with prof:
            with tr.span(tr.WINDOW):
                for k in range(mix["trace_requests"]):
                    i = next(order)
                    t0 = time.perf_counter()
                    host, cloud, t_pre = pool.request_split(i)
                    lat.append(time.perf_counter() - t0)
                    pre.append(t_pre)
                    counters.append(dict(sis.last_counts))
                    if k in keep:
                        checked.append((i, capture(sis, host, cloud),
                                        cloud, list(sis.last_round_counts)))
        evs = tr.events(prof, r.tmp)
        s = tr.summary(evs)
        busy, window, bd = s["busy_s"], s["window_s"], s["breakdown"]
        layer = dict(events=evs, window=s["window"], preprocess_s=pre,
                     channels=cfg.image_geometry.num_channels,
                     size=cfg.image_geometry.size,
                     cem_requests=[dict(latency_s=t, **c)
                                   for t, c in zip(lat, counters)])
        spans = tr.spans(evs, "cem_detect")
        r.log(f"# graph launches per CEM request: {graph_launches(evs)}; "
              f"cem_detect spans, host ms: mean "
              f"{sum(e['dur'] for e in spans) / max(len(spans), 1) / 1e3:.3f}")
    if (len(det.graphs), len(sis.graphs)) != keys:
        r.log(f"# the window captured {len(det.graphs) - keys[0]} detector "
              f"graphs and {len(sis.graphs) - keys[1]} CEM keys")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else None

    t0 = time.perf_counter()
    loop_off = loop_rounds_off(sis, pool, checked)
    r.log(f"# the loop's round counts over {len(checked)} requests in "
          f"{time.perf_counter() - t0:.3f} s: "
          + ", ".join(f"fused {c} loop share off {x!r}"
                      for (_, _, _, c), x in zip(checked, loop_off)))
    del det, sis, pool.det, pool.sis
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    nums, ctrl = reference_pass(r, pool, checked, r.controls)
    for nm, x in zip(nums, loop_off):
        nm["loop_rounds_off"] = x
    r.log(f"# reference over {len(checked)} requests in "
          f"{time.perf_counter() - t0:.3f} s")
    for (i, *_), nm in zip(checked, nums):
        r.log(f"# request (pool {i}): " + ", ".join(
            f"{a} {b!r}" for a, b in nm.items()))
    checks = serve.checks_of(nums, r.workload["limits"]) if nums else [
        harness.Check("requests_checked", 1.0, 0.0)]
    return harness.Outcome(setup_s=setup_s, attempted=len(lat) + failed,
                           failed=failed, end_to_end=e2e, checks=checks,
                           memory_peak_bytes=peak, layer=layer, busy_s=busy,
                           window_s=window, breakdown=bd, numbers=nums,
                           control=ctrl)
