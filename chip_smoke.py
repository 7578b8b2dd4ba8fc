"""Drives the gpd_tpu_torch port on one CUDA card and holds its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

  1. device: one CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel of the main path from gpd_tpu_torch/csrc;
  3. kernels: each kernel against its plain version at the main path's
     shapes (raster_blocks at 512 hands, 2048 points and 2048 shadow
     points, with and without shadows), with its time, the plain version's,
     one library call's and the bound;
  4. main path: GraspDetector.preprocess_cloud + detect at the default
     DetectorConfig (15 channels, 1000 samples, packaged LeNet weights) on
     synthetic two-camera table scenes, one warm-up and 3 requests;
  5. stage breakdown: request 0's scene once more through detect with
     sync_stages, so each stage's time is its own (host clock);
  6. reference: on a small scene, the card's grasp images against the CPU
     route (the repo's own bf16 gate: under 0.5% of pixels off by > 1);
  7. the kernels line, the card line, and the status line last.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REQUESTS = 3
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def raster_operands(torch, gen, G, Km, Ks, size):
    """Raster operands shaped as make_images emits them: in-volume points
    hold cells < size and pre-masked values, out-of-volume ones the
    sentinel and zeros."""
    def one(K, nval):
        cells = torch.randint(0, size, (G, 4, K), generator=gen,
                              device="cuda", dtype=torch.int32)
        inside = torch.rand((G, 1, K), generator=gen, device="cuda") < 0.6
        idx = torch.where(inside, cells, size).to(torch.int32).contiguous()
        vals = torch.rand((G, nval, K), generator=gen, device="cuda") * inside
        return idx, vals.to(torch.bfloat16).contiguous()
    midx, mvals = one(Km, 6)
    sidx, svals = one(Ks, 3)
    return midx, mvals, sidx, svals


def check_raster(torch, img):
    """raster_blocks against raster_blocks_ref; returns the kernels-line
    entry for the with-shadow (main path) shapes."""
    G, K, size = 512, 2048, 60
    gen = torch.Generator(device="cuda").manual_seed(0)
    midx, mvals, sidx, svals = raster_operands(torch, gen, G, K, K, size)
    entry, max_err = None, 0.0
    for with_shadow in (True, False):
        args = ((midx, mvals, sidx, svals) if with_shadow
                else (midx, mvals, None, None))
        out = img.raster_blocks(*args, size)
        ref = img.raster_blocks_ref(*args, size)
        torch.cuda.synchronize()
        nb = out.shape[1]
        counts = [4, 9, 14] + ([16, 18, 20] if with_shadow else [])
        values = [b for b in range(nb) if b not in counts]
        if not torch.equal(out[:, counts], ref[:, counts]):
            fail(f"raster_blocks counts differ (shadows={with_shadow})")
        # Atomics add in a run-dependent order: the tolerance covers f32
        # reordering of at most 2048 bf16 terms a cell.
        if not torch.allclose(out[:, values], ref[:, values],
                              atol=1e-3, rtol=1e-5):
            fail(f"raster_blocks values differ (shadows={with_shadow})")
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        print(f"raster_blocks shadows={with_shadow}: G={G} Km={K} "
              f"Ks={K if with_shadow else 0} NB={nb} max_abs_err={err:.3e}")
        if not with_shadow:
            continue

        ms = cuda_ms(torch, lambda: img.raster_blocks(*args, size))
        plain_ms = cuda_ms(torch, lambda: img.raster_blocks_ref(*args, size))
        # Library yardstick: one index_put_(accumulate=True) on flat
        # indices precomputed from the same operands (never used by the
        # port), into a zeroed output.
        flat, vals = flat_contributions(torch, img, midx, mvals, sidx, svals,
                                        size, nb)
        lib_out = torch.zeros(out.numel(), device="cuda")

        def library():
            lib_out.zero_()
            lib_out.index_put_((flat,), vals, accumulate=True)
        library_ms = cuda_ms(torch, library)
        if not torch.allclose(lib_out.view_as(ref), ref, atol=1e-3, rtol=1e-5):
            fail("index_put_ yardstick disagrees with raster_blocks_ref")
        nbytes = sum(t.numel() * t.element_size()
                     for t in (midx, mvals, sidx, svals, out))
        n_ops = int(vals.numel())          # one f32 add per contribution
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
        print(f"raster_blocks timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_put_ {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f}"
              f" ms ({nbytes / 1e6:.1f} MB, {n_ops / 1e6:.1f} M adds)")
        entry = dict(name="raster_blocks", route="cuda",
                     source="gpd_tpu_torch/csrc/raster_blocks.cu",
                     replaces="gpd_tpu/ops/images.py:204",
                     ms=ms, plain_ms=plain_ms,
                     bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                     library_ms=library_ms)
    entry["max_abs_err"] = max_err
    return entry


def flat_contributions(torch, img, midx, mvals, sidx, svals, size, nb):
    """(flat output index, f32 value) of every in-image contribution."""
    G = midx.shape[0]
    R = img.raster_rows(size)
    g = torch.arange(G, device="cuda")[:, None]
    flats, values = [], []
    for idx, v, groups in ((midx, mvals, img._MAIN_GROUPS),
                           (sidx, svals, img._SHADOW_GROUPS)):
        for plane0, rsel, csel, rows_of_values in groups:
            rows, cols = idx[:, rsel].long(), idx[:, csel].long()
            ok = (rows < size) & (cols < size)
            for j, vrow in enumerate(rows_of_values):
                flat = (g * nb + plane0 + j) * (R * R) + rows * R + cols
                val = (torch.ones_like(rows, dtype=torch.float32)
                       if vrow is None else v[:, vrow].float())
                flats.append(flat[ok])
                values.append(val[ok])
    return torch.cat(flats), torch.cat(values)


def scene(syn, seed):
    """Synthetic two-camera table scene: 3 objects on a table patch."""
    rng = np.random.default_rng(seed)
    pts, nrm = syn.make_scene(rng, n_objects=3)
    cams = syn.view_cameras(rng, 2)
    return syn.render_fused_views(rng, pts, nrm, cams)


def main_path(torch, img, syn, det):
    t0 = time.perf_counter()
    p, cs, vp = scene(syn, 100)
    det.detect(det.preprocess_cloud(p, view_points=vp, cam_source=cs),
               generator=torch.Generator(device="cuda").manual_seed(100),
               verbose=False)
    print(f"warm-up request: {time.perf_counter() - t0:.3f} s")

    img.raster_blocks.launches = 0
    for r in range(REQUESTS):
        p, cs, vp = scene(syn, r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
        n_cloud = int(cloud.mask.sum())
        t_pre = time.perf_counter() - t0
        out = det.detect(cloud, verbose=False,
                         generator=torch.Generator(device="cuda").manual_seed(r))
        h = out.to_host()
        scores = h.score[h.valid]
        rt, ct = det.last_runtimes, det.last_counts
        print(f"request {r}: raw {len(p)} points, processed {n_cloud} "
              f"(capacity {cloud.capacity}); samples {ct['samples']}, "
              f"candidates {ct['candidates']}, selected {ct['selected']}; "
              f"preprocess {t_pre:.4f} s, detect {rt['detect']:.4f} s, "
              f"select {rt['select']:.4f} s, detect total {rt['total']:.4f} s; "
              f"top scores {np.round(scores[:5], 3).tolist()}")
        if ct["selected"] < 1:
            fail(f"request {r} selected no grasp")
        if not np.all(np.isfinite(scores)):
            fail(f"request {r} has non-finite scores")
    launches = img.raster_blocks.launches
    if launches < 1:
        fail("the main path never launched raster_blocks")
    print(f"raster_blocks launches on the main path: {launches} "
          f"({launches / REQUESTS:.2f} per request)")
    return launches


def stage_breakdown(torch, img, syn, det):
    """Request 0's scene once more, with detect waiting for the device after
    every stage (sync_stages): each stage's host-clock time."""
    p, cs, vp = scene(syn, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    torch.cuda.synchronize()
    times = {"preprocess": time.perf_counter() - t0}
    before = img.raster_blocks.launches
    det.detect(cloud, verbose=False, sync_stages=True,
               generator=torch.Generator(device="cuda").manual_seed(0))
    rt = det.last_runtimes
    for stage in ("sample", "candidates", "descriptors", "images",
                  "classify", "select"):
        times[stage] = rt[stage]
    print("stage breakdown (request 0 scene, ms): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in times.items()) +
        f"; sum {sum(times.values()) * 1e3:.2f}; detect total "
        f"{rt['total'] * 1e3:.2f}; "
        f"{img.raster_blocks.launches - before} image chunks")


def reference_check(torch, img, syn, GraspDetector, DetectorConfig, detector):
    """Grasp images of one small scene's hands, from the card's kernel route
    and from the CPU's plain route on the same inputs."""
    cfg = DetectorConfig(num_samples=32)
    cpu = GraspDetector(cfg, device="cpu")
    rng = np.random.default_rng(7)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    cloud = cpu.preprocess_cloud(p, view_points=vp, cam_source=cs)
    ecfg = cpu.effective_config(cloud)
    gen = torch.Generator().manual_seed(0)
    spos, smask = cpu.sample_cloud(cloud, gen)
    grasps = detector.candidates_stage(cloud, spos, smask, ecfg)
    noise = detector.shadow_noise(gen, cloud, spos.shape[0], ecfg)
    inputs = detector.image_inputs_stage(cloud, spos, smask, noise, ecfg)
    g = detector._compact_hands(grasps, cpu.image_cap(spos.shape[0]))
    ref = detector._images_for(cloud, g, *inputs, ecfg).numpy()

    def to_cuda(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.cuda()
        return type(x)(**{k: to_cuda(v) for k, v in vars(x).items()})
    before = img.raster_blocks.launches
    out = detector._images_for(to_cuda(cloud), to_cuda(g),
                               *[to_cuda(t) for t in inputs], ecfg)
    out = out.cpu().numpy()
    if img.raster_blocks.launches == before:
        fail("reference check did not reach the kernel")
    img.raster_blocks.launches = before
    if out.shape != ref.shape:
        fail(f"image shapes differ: {out.shape} vs {ref.shape}")
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    frac = float((diff > 1).mean())
    print(f"reference check: {int(g.valid.sum())} hands, images {out.shape}, "
          f"max u8 diff {int(diff.max())}, share |diff|>1 = {frac:.2e}")
    if frac >= 5e-3:
        fail("card images diverge from the CPU route")


def main():
    # One card: the first, unless the caller chose one.
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if torch.cuda.device_count() != 1:
        fail(f"{torch.cuda.device_count()} cards visible; this script "
             f"drives one")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    from gpd_tpu_torch import detector
    from gpd_tpu_torch.config import DetectorConfig
    from gpd_tpu_torch.datasets import synthetic as syn
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import images as img

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(["raster_blocks"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    entry = check_raster(torch, img)
    torch.cuda.reset_peak_memory_stats()
    det = GraspDetector(DetectorConfig(), device="cuda")
    entry["launches"] = main_path(torch, img, syn, det)
    print(f"peak device memory over the requests: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stage_breakdown(torch, img, syn, det)
    reference_check(torch, img, syn, GraspDetector, DetectorConfig, detector)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
