"""Drives the gpd_tpu_torch port on one CUDA card and holds its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

  1. device: one CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel from gpd_tpu_torch/csrc, one nvcc each,
     all started together, and prints their register and spill lines;
  3. kernels: each kernel against its plain version at the main paths'
     shapes, with its time, the plain version's, one library call's and
     the bound (each timed call reads its inputs from HBM, not the L2):
     raster_blocks at 512 hands, 2048 points and 2048 shadow points, with
     and without shadows; raster_sums at 512 hands, 2048 points, 60x60
     cells, Cp = 4 and 2; raster_sums2 (two row sets) at
     Cp = 6 and 3, with each Cp's ms / bound_ms on one line; then
     raster_blocks, raster_sums and raster_sums2 at ragged shapes (G 1,
     133, 256; K 200, 2047, 3072; with and without shadows, Cp 4 and 2,
     Cp 6 and 3). Every check runs the kernel twice: counts exactly
     equal, values within atol 1e-3 + rtol 1e-5;
  4. 15-channel path: GraspDetector.preprocess_cloud + detect at the default
     DetectorConfig (15 channels, 1000 samples, packaged LeNet weights) on
     synthetic two-camera table scenes, one warm-up and 3 requests; then
     request 0's scene once more through detect with sync_stages, so each
     stage's time is its own (host clock);
  5. 3-channel entry point: GraspDetector.detect_file on synthetic
     single-camera table scenes written as PCD files to a temporary
     directory, at the default widths with 3 channels, 1000 samples, the
     packaged 3-channel weights and outlier removal, sampling above the
     plane and plane removal before the images all on; one warm-up, 3
     requests, a stage breakdown, and the detect_grasps CLI once with a
     normals CSV and a CSV output;
  6. reference: on small scenes, the card's 15- and 3-channel grasp images
     against the CPU route (the repo's gate: under 0.5% of pixels off by
     more than one step);
  7. the kernels line, the card line, and the status line last.

Before each path of phases 4 and 5 every kernel's launch count is set to
0; it is read just after the path's requests.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REQUESTS = 3
KERNELS = ("raster_blocks", "raster_sums", "raster_sums2")
# Ragged shapes for the persistent kernels: one hand, a hand count that
# leaves blocks unequal runs of items, K short, not a multiple of 4, and
# above 2048.
RAGGED_G = (1, 133, 256)
RAGGED_K = (200, 2047, 3072)
# Device sleep before a timed run, so the host queues every launch first
# and the events time the card, not the launch rate (~50 ms at 1.98 GHz).
SLEEP_CYCLES = 100_000_000
# The one camera of the 3-channel scenes: view_cameras' draw from this
# seed, 44 degrees above the table.
CAMERA_SEED = 1000
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, args, iters=20, warmup=3):
    """Mean milliseconds per call of fn(*args) from CUDA events around
    `iters` calls queued behind a device sleep. The calls take turns over
    copies of the tensors in `args`, enough copies that the others' bytes
    fill the L2 cache twice between two uses of one: every call reads its
    inputs from HBM, as the bytes bound assumes."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if isinstance(t, torch.Tensor))
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    copies = [tuple(args)] + [
        tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)
        for _ in range(-(-2 * l2 // max(nbytes, 1)))]
    for i in range(warmup):
        fn(*copies[i % len(copies)])
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*copies[i % len(copies)])
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


def hold(torch, name, run, ref, counts):
    """Runs a kernel twice against its plain version's output ``ref``:
    counts (the index list ``counts`` of dim 1, or the last channel)
    exactly equal, values within the tolerance. Returns the max |diff|."""
    err = 0.0
    for _ in range(2):
        out = run()
        torch.cuda.synchronize()
        pick = ((lambda t: t[:, counts]) if counts is not None
                else (lambda t: t[..., -1]))
        if not torch.equal(pick(out), pick(ref)):
            fail(f"{name}: counts differ")
        # Atomics add in a run-dependent order: the tolerance covers f32
        # reordering of at most 3072 terms a cell.
        if not torch.allclose(out, ref, atol=1e-3, rtol=1e-5):
            fail(f"{name}: values differ")
        err = max(err, float((out - ref).abs().max()))
    return err


def raster_counts(with_shadow):
    return [4, 9, 14] + ([16, 18, 20] if with_shadow else [])


def bound(nbytes, n_ops):
    """(bound ms, bound_by): bytes at the HBM rate against f32 adds at the
    f32 rate, the larger."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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
        ref = img.raster_blocks_ref(*args, size)
        err = hold(torch, f"raster_blocks (shadows={with_shadow})",
                   lambda: img.raster_blocks(*args, size), ref,
                   raster_counts(with_shadow))
        max_err = max(max_err, err)
        nb = ref.shape[1]
        print(f"raster_blocks shadows={with_shadow}: G={G} Km={K} "
              f"Ks={K if with_shadow else 0} NB={nb} max_abs_err={err:.3e}")
        if not with_shadow:
            continue

        ms = cuda_ms(torch, lambda *a: img.raster_blocks(*a, size), args)
        plain_ms = cuda_ms(torch, lambda *a: img.raster_blocks_ref(*a, size),
                           args)
        # Library yardstick: one index_put_(accumulate=True) on flat
        # indices precomputed from the same operands (never used by the
        # port), into a zeroed output.
        flat, vals = flat_contributions(torch, img, midx, mvals, sidx, svals,
                                        size, nb)
        lib_out = torch.zeros(ref.numel(), device="cuda")

        def library(flat, vals):
            lib_out.zero_()
            lib_out.index_put_((flat,), vals, accumulate=True)
        library_ms = cuda_ms(torch, library, (flat, vals))
        if not torch.allclose(lib_out.view_as(ref), ref, atol=1e-3, rtol=1e-5):
            fail("index_put_ yardstick disagrees with raster_blocks_ref")
        nbytes = sum(t.numel() * t.element_size()
                     for t in (midx, mvals, sidx, svals, ref))
        n_ops = int(vals.numel())          # one f32 add per contribution
        bound_ms, bound_by = bound(nbytes, n_ops)
        print(f"raster_blocks timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_put_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {n_ops / 1e6:.1f} M adds); "
              f"ms / bound_ms = {ms / bound_ms:.2f}")
        entry = dict(name="raster_blocks", route="cuda",
                     source="gpd_tpu_torch/csrc/raster_blocks.cu",
                     replaces="gpd_tpu/ops/images.py:204",
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms,
                     bound_ratio=ms / bound_ms)
    entry["max_abs_err"] = max(max_err, check_raster_ragged(torch, img))
    return entry


def check_raster_ragged(torch, img):
    """raster_blocks at the ragged shapes, Ks = K; returns the max |diff|."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, n = 0.0, 0
    for G in RAGGED_G:
        for K in RAGGED_K:
            midx, mvals, sidx, svals = raster_operands(torch, gen, G, K, K, 60)
            for with_shadow in (True, False):
                args = ((midx, mvals, sidx, svals) if with_shadow
                        else (midx, mvals, None, None))
                max_err = max(max_err, hold(
                    torch, f"raster_blocks G={G} K={K} shadows={with_shadow}",
                    lambda: img.raster_blocks(*args, 60),
                    img.raster_blocks_ref(*args, 60),
                    raster_counts(with_shadow)))
                n += 1
    print(f"raster_blocks ragged: {n} shapes (G {RAGGED_G}, K {RAGGED_K}, "
          f"with and without shadows), each twice, max_abs_err={max_err:.3e}")
    return max_err


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


def sums_operands(torch, gen, G, K, Cp, n_rows, size):
    """raster_sums operands shaped as scatter_mean emits them: ~60% of
    entries in the image, the rest on the sentinel, pre-masked values with
    the count last."""
    inside = torch.rand((G, K), generator=gen, device="cuda") < 0.6

    def index():
        cells = torch.randint(0, size, (G, K), generator=gen, device="cuda",
                              dtype=torch.int32)
        return torch.where(inside, cells, size).to(torch.int32).contiguous()
    rows = [index() for _ in range(n_rows)]
    m = inside.float()[..., None]
    vals = torch.rand((G, K, Cp - 1), generator=gen, device="cuda") * m
    return rows, index(), torch.cat([vals, m], -1).contiguous()


def sums_flat(torch, rows, cols, aug, size):
    """(flat output index, value) of every in-image contribution, in the
    (G, len(rows), size, size, Cp) layout."""
    G, K, Cp = aug.shape
    g = torch.arange(G, device="cuda")[:, None]
    ch = torch.arange(Cp, device="cuda")
    flats, values = [], []
    for s, r in enumerate(rows):
        ok = (r < size) & (cols < size)
        cell = ((g * len(rows) + s) * size + r.long()) * size + cols.long()
        flats.append((cell[..., None] * Cp + ch)[ok].reshape(-1))
        values.append(aug[ok].reshape(-1))
    return torch.cat(flats), torch.cat(values)


def check_sums(torch, img):
    """raster_sums and raster_sums2 against their plain versions, each Cp
    timed; returns their kernels-line entries (Cp = 4 and Cp = 6, the first
    of each list)."""
    G, K, size = 512, 2048, 60
    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = {}
    for name, n_rows, cps, ragged_seed in (("raster_sums", 1, (4, 2), 3),
                                           ("raster_sums2", 2, (6, 3), 4)):
        fn, plain = getattr(img, name), getattr(img, name + "_ref")
        max_err, ratios = 0.0, []
        for Cp in cps:
            rows, cols, aug = sums_operands(torch, gen, G, K, Cp, n_rows, size)
            args = (*rows, cols, aug, size)
            ref = plain(*args)
            err = hold(torch, f"{name} (Cp={Cp})", lambda: fn(*args), ref,
                       None)
            max_err = max(max_err, err)
            print(f"{name} Cp={Cp}: G={G} K={K} size={size} "
                  f"output {tuple(ref.shape)} max_abs_err={err:.3e}")
            ms = cuda_ms(torch, lambda *a: fn(*a, size), args[:-1])
            plain_ms = cuda_ms(torch, lambda *a: plain(*a, size), args[:-1])
            # Library yardstick: one index_put_(accumulate=True) on flat
            # indices precomputed from the same operands (never used by the
            # port), into a zeroed output.
            flat, vals = sums_flat(torch, rows, cols, aug, size)
            lib_out = torch.zeros(ref.numel(), device="cuda")

            def library(flat, vals):
                lib_out.zero_()
                lib_out.index_put_((flat,), vals, accumulate=True)
            library_ms = cuda_ms(torch, library, (flat, vals))
            if not torch.allclose(lib_out.view_as(ref), ref, atol=1e-3,
                                  rtol=1e-5):
                fail(f"index_put_ yardstick disagrees with {name}_ref")
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*rows, cols, aug, ref))
            n_ops = int(vals.numel())      # one f32 add per contribution
            bound_ms, bound_by = bound(nbytes, n_ops)
            print(f"{name} timing (Cp={Cp}): {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{n_ops / 1e6:.2f} M adds); ms / bound_ms = "
                  f"{ms / bound_ms:.2f}")
            ratios.append(f"{ms / bound_ms:.2f} at Cp={Cp}")
            if Cp != cps[0]:
                continue
            entries[name] = dict(
                name=name, route="cuda",
                source="gpd_tpu_torch/csrc/raster_sums.cu",
                replaces=("gpd_tpu/ops/images.py:53" if n_rows == 1
                          else "gpd_tpu/ops/images.py:136"),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                bound_ratio=ms / bound_ms)
        print(f"{name} ms / bound_ms: {', '.join(ratios)} (the kernels "
              f"line holds Cp={cps[0]})")
        entries[name]["max_abs_err"] = max(max_err, check_sums_ragged(
            torch, img, name, n_rows, cps, ragged_seed))
    entries["raster_sums2"]["note"] = (
        "no detection path calls it (nor gpd_tpu's); launched here only "
        "against its plain version")
    return entries


def check_sums_ragged(torch, img, name, n_rows, cps, seed):
    """raster_sums (n_rows 1) or raster_sums2 (2) at the ragged shapes;
    returns the max |diff|."""
    fn, plain = getattr(img, name), getattr(img, name + "_ref")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err, n = 0.0, 0
    for G in RAGGED_G:
        for K in RAGGED_K:
            for Cp in cps:
                rows, cols, aug = sums_operands(torch, gen, G, K, Cp, n_rows,
                                                60)
                args = (*rows, cols, aug, 60)
                max_err = max(max_err, hold(
                    torch, f"{name} G={G} K={K} Cp={Cp}",
                    lambda: fn(*args), plain(*args), None))
                n += 1
    print(f"{name} ragged: {n} shapes (G {RAGGED_G}, K {RAGGED_K}, "
          f"Cp {cps[0]} and {cps[1]}), each twice, "
          f"max_abs_err={max_err:.3e}")
    return max_err


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

    reset_counts(img)
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
    launches = counts(img)
    if launches["raster_blocks"] < 1:
        fail("the 15-channel path never launched raster_blocks")
    print(f"launches on the 15-channel path: {launches} "
          f"({launches['raster_blocks'] / REQUESTS:.2f} raster_blocks per "
          f"request)")
    return launches


CFG_3CH = """\
# 3-channel detect_grasps config: default widths, 1000 samples, packaged
# 3-channel weights, every preprocessing option of the slice on.
image_num_channels = 3
num_samples = 1000
remove_outliers = 1
sample_above_plane = 1
remove_plane_before_image_calculation = 1
camera_position = {x} {y} {z}
"""


def single_camera_scenes(syn, pcd, tmp, seeds):
    """Synthetic 3-object table scenes seen by one camera, written as PCD
    files. Returns (paths, camera position (1, 3))."""
    cam = syn.view_cameras(np.random.default_rng(CAMERA_SEED), 1)
    paths = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        pts, nrm = syn.make_scene(rng, n_objects=3)
        p, _, _ = syn.render_fused_views(rng, pts, nrm, cam)
        paths.append(os.path.join(tmp, f"scene_{seed}.pcd"))
        pcd.save_pcd(paths[-1], p)
    return paths, cam


def entry_point_3ch(torch, img, pcd, det, paths):
    """Warm-up on paths[0], then one detect_file request per other path."""
    t0 = time.perf_counter()
    det.detect_file(paths[0], verbose=False,
                    generator=torch.Generator(device="cuda").manual_seed(100))
    print(f"3-channel warm-up request: {time.perf_counter() - t0:.3f} s")
    reset_counts(img)
    for r, path in enumerate(paths[1:]):
        n_raw = len(pcd.load_cloud_file(path))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.detect_file(
            path, verbose=False,
            generator=torch.Generator(device="cuda").manual_seed(r))
        t_total = time.perf_counter() - t0
        h = out.to_host()
        scores = h.score[h.valid]
        rt, ct = det.last_runtimes, det.last_counts
        print(f"3-channel request {r}: raw {n_raw} points, processed "
              f"{ct['points']} (capacity {ct['capacity']}); samples "
              f"{ct['samples']}, candidates {ct['candidates']}, selected "
              f"{ct['selected']}; detect {rt['detect']:.4f} s, detect total "
              f"{rt['total']:.4f} s, detect_file total {t_total:.4f} s; "
              f"top scores {np.round(scores[:5], 3).tolist()}")
        if ct["selected"] < 1:
            fail(f"3-channel request {r} selected no grasp")
        if not np.all(np.isfinite(scores)):
            fail(f"3-channel request {r} has non-finite scores")
    launches = counts(img)
    if launches["raster_sums"] < 1:
        fail("the 3-channel path never launched raster_sums")
    print(f"launches on the 3-channel path: {launches} "
          f"({launches['raster_sums'] / REQUESTS:.2f} raster_sums per "
          f"request)")
    return launches


def cli_3ch(detect_grasps, pcd, path, cam, tmp):
    """The detect_grasps CLI once, CONFIG PCD NORMALS_CSV OUT_CSV, on the
    card. The normals file has one comma-separated row per raw point (each
    point's unit direction to the camera); with voxels on, the detector
    estimates normals anew, as the reference does."""
    cfg = os.path.join(tmp, "three_channels.cfg")
    with open(cfg, "w") as f:
        f.write(CFG_3CH.format(x=cam[0, 0], y=cam[0, 1], z=cam[0, 2]))
    pts = pcd.load_cloud_file(path)
    nrm = cam[0][None, :] - pts
    normals_csv = os.path.join(tmp, "normals.csv")
    np.savetxt(normals_csv, nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
               delimiter=",")
    out_csv = os.path.join(tmp, "grasps.csv")
    t0 = time.perf_counter()
    rc = detect_grasps.main([cfg, path, normals_csv, out_csv])
    if rc != 0:
        fail(f"detect_grasps returned {rc}")
    with open(out_csv) as f:
        rows = f.read().splitlines()
    if not rows or any(len(r.split(",")) != 13 for r in rows):
        fail(f"detect_grasps wrote {len(rows)} CSV rows")
    print(f"detect_grasps CLI: exit 0 in {time.perf_counter() - t0:.3f} s, "
          f"{len(pts)} normals read, {len(rows)} CSV rows")


def reset_counts(img):
    for name in KERNELS:
        getattr(img, name).launches = 0


def counts(img):
    return {name: getattr(img, name).launches for name in KERNELS}


def stage_breakdown(torch, det, prepare, kernel, label):
    """One request once more, with detect waiting for the device after
    every stage (sync_stages): each stage's host-clock time. ``prepare``
    makes the cloud (timed as preprocess)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cloud = prepare()
    torch.cuda.synchronize()
    times = {"preprocess": time.perf_counter() - t0}
    before = kernel.launches
    det.detect(cloud, verbose=False, sync_stages=True,
               generator=torch.Generator(device="cuda").manual_seed(0))
    rt = det.last_runtimes
    for stage in ("sample", "candidates", "descriptors", "images",
                  "classify", "select"):
        times[stage] = rt[stage]
    print(f"stage breakdown ({label}, ms): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in times.items()) +
        f"; sum {sum(times.values()) * 1e3:.2f}; detect total "
        f"{rt['total'] * 1e3:.2f}; "
        f"{kernel.launches - before} image chunks")


def reference_check(torch, syn, GraspDetector, detector, cfg, kernel):
    """Grasp images of one small scene's hands, from the card's kernel route
    and from the CPU's plain route on the same inputs."""
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
    inputs = detector.image_inputs_stage(cloud, cloud.mask, spos, smask,
                                         noise, ecfg)
    g = detector._compact_hands(grasps, cpu.image_cap(spos.shape[0]))
    ref = detector._images_for(cloud, g, *inputs, ecfg).numpy()

    def to_cuda(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.cuda()
        return type(x)(**{k: to_cuda(v) for k, v in vars(x).items()})
    before = kernel.launches
    out = detector._images_for(to_cuda(cloud), to_cuda(g),
                               *[to_cuda(t) for t in inputs], ecfg)
    out = out.cpu().numpy()
    if kernel.launches == before:
        fail("reference check did not reach the kernel")
    if out.shape != ref.shape:
        fail(f"image shapes differ: {out.shape} vs {ref.shape}")
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    frac = float((diff > 1).mean())
    print(f"reference check, {cfg.image_geometry.num_channels} channels: "
          f"{int(g.valid.sum())} hands, images {out.shape}, max u8 diff "
          f"{int(diff.max())}, share |diff|>1 = {frac:.2e}")
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
    from gpd_tpu_torch.apps import detect_grasps
    from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
    from gpd_tpu_torch.datasets import synthetic as syn
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io import pcd
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import images as img

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(["raster_blocks", "raster_sums"])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                print(f"  {name}: {line.strip()}")

    entries = {"raster_blocks": check_raster(torch, img), **check_sums(
        torch, img)}

    torch.cuda.reset_peak_memory_stats()
    det = GraspDetector(DetectorConfig(), device="cuda")
    launches15 = main_path(torch, img, syn, det)
    print(f"peak device memory over the 15-channel requests: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    p, cs, vp = scene(syn, 0)
    stage_breakdown(torch, det, lambda: det.preprocess_cloud(
        p, view_points=vp, cam_source=cs), img.raster_blocks,
        "15 channels, request 0 scene")

    with tempfile.TemporaryDirectory() as tmp:
        paths, cam = single_camera_scenes(syn, pcd, tmp, (100, 0, 1, 2))
        cfg3 = DetectorConfig(
            image_geometry=ImageGeometry(num_channels=3),
            remove_outliers=True, sample_above_plane=True,
            remove_plane_before_image_calculation=True,
            camera_position=tuple(cam[0].tolist()))
        torch.cuda.reset_peak_memory_stats()
        det3 = GraspDetector(cfg3, device="cuda")
        launches3 = entry_point_3ch(torch, img, pcd, det3, paths)
        print(f"peak device memory over the 3-channel requests: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        stage_breakdown(torch, det3, lambda: det3.preprocess_cloud(
            pcd.load_cloud_file(paths[1]), view_points=cam,
            capacity="serve"), img.raster_sums,
            "3 channels, request 0 scene, preprocess includes the file read")
        cli_3ch(detect_grasps, pcd, paths[1], cam, tmp)

    reference_check(torch, syn, GraspDetector, detector,
                    DetectorConfig(num_samples=32), img.raster_blocks)
    reference_check(torch, syn, GraspDetector, detector,
                    DetectorConfig(num_samples=32, image_geometry=ImageGeometry(
                        num_channels=3)), img.raster_sums)

    entries["raster_blocks"]["launches"] = launches15["raster_blocks"]
    entries["raster_sums"]["launches"] = launches3["raster_sums"]
    entries["raster_sums2"]["launches"] = (launches15["raster_sums2"]
                                           + launches3["raster_sums2"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_ratio")
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **({"note": e["note"]} if "note" in e
                                       else {})}
        for e in entries.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
