"""Drives the gpd_tpu_torch port on one CUDA card and holds its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

  1. device: one CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel from gpd_tpu_torch/csrc, one nvcc each,
     and the ascii PCD parser and the C ABI with the host compiler, all
     started together, and prints the kernels' register and spill lines;
  3. kernels: each kernel against its plain version at the main paths'
     shapes, with its time, the plain version's, one library call's and
     the bound (each timed call reads its inputs from HBM, not the L2):
     raster_blocks at 512 hands, 2048 points and 2048 shadow points, with
     shadows (15 channels) and without (12 channels), each mode timed on
     the same operands; raster_sums at 512 hands, 2048 points, 60x60
     cells, Cp = 4 and 2; raster_sums2 (two row sets) at
     Cp = 6 and 3, with each Cp's ms / bound_ms on one line; then
     raster_blocks, raster_sums and raster_sums2 at ragged shapes (G 1,
     133, 256; K 200, 2047, 3072; with and without shadows, Cp 4 and 2,
     Cp 6 and 3); then raster_blocks at the staged route's chunk of 4096
     hands. Every check runs the kernel twice: counts exactly equal,
     values within atol 1e-3 + rtol 1e-5. Then raster_images (the sums
     finished into uint8 image channels in the kernel, make_images'
     route at 12 and 15 channels) against _raster_finish of
     raster_blocks_ref at 512 hands (15 and 12 channels) and at the
     staged chunk (15), twice: every pixel within one level; each timed
     beside raster_blocks + _raster_finish, the plain route and its bound
     (``python3 chip_smoke.py images`` runs this check alone). Then
     hand_search against its
     plain version (_eval_orientations) on the benchmark's first table
     cloud (capacity 14336) and first PCD cloud (8192), 1000 samples, 8
     orientations, identity rows: flags and mid equal on >= 99.9% of
     slots, values within 1e-5 where valid agrees, each timed with its
     bound (``python3 chip_smoke.py hand_search`` runs this check alone).
     Then radius_moments against radius_moments_ref and float64 on the
     same two clouds: the normals (every point a query) and the frames
     (1000 samples and a CEM round's 50), counts off float64 only at
     pairs within 1e-6 r^2 of the boundary, sums within 1e-5, twice bit
     for bit, each timed beside the plain route and two bounds (the full
     sweep's and that of the point groups its probe counts as swept;
     ``python3 chip_smoke.py radius_moments`` runs this check alone).
     Then outlier_knn, the outlier filter's mean distance to the 50
     nearest, on two pcd_stream scenes' filter inputs (the 16384 and 8192
     buckets): twice bit for bit, within 1e-5 of float64, the kept mask
     equal to h100_bench's float64 filter, timed beside the plain route
     and the two bounds (``python3 chip_smoke.py outlier_knn`` runs this
     check alone);
  4. 15-channel path: GraspDetector.preprocess_cloud + detect at the default
     DetectorConfig (15 channels, 1000 samples, packaged LeNet weights) on
     synthetic two-camera table scenes, one warm-up and 3 scenes.
     preprocess_cloud runs gpd_tpu's preprocess programs (workspace filter
     and voxels, normals; the outlier filter at 3 channels), each a CUDA
     graph captured at the first request of its key, with the host
     compactions between them. Per scene, preprocess by route: the first
     request apart (each new key's capture ms and pool bytes), then the
     graph route and the eager route (_force_eager) in turns (graph, eager,
     eager, graph), then one traced request by each route (window, busy
     share, host launch calls, kernel time of its preprocess span); every
     graph cloud must hold the eager cloud's mask and points exactly and
     no larger share of normals more than 1e-5 apart than the eager cloud
     holds against the CPU route's on the same input, and a request of
     seen keys must capture nothing. Then detect, which
     runs as three CUDA graphs (A: samples and candidates, then one read of
     A's counts, B: images and scores over the live chunks, C: selection),
     each captured at the first request of its key. Per scene the first
     request is timed apart (what it captured, each capture's ms, the
     shared pool's bytes), then the graph route and the eager route
     (_force_eager) in turns (graph, eager, eager, graph) on one generator
     seed, then one traced graph request and one traced eager request
     (window, busy share, host launch calls, kernel time of each): every
     request must find the
     eager route's candidate count and a grasp with finite scores, every
     graph request >= 90% of the eager route's selection by position
     (1e-5), a request of seen keys must capture nothing and call no
     kernel wrapper, and the traced replay must run in its detect_core
     span the raster_images kernels its captures recorded; then request
     0's scene once more through detect(staged=True) at detect's image
     chunk, so each stage's time is its own (host clock). Per scene
     last, whole requests (preprocess_cloud + detect) by the graph routes
     and the eager routes in turns, beside the 100 ms request limit. On
     request 0's scene, radius_neighbors over detect's samples at the image
     neighbourhoods' radius and cap with exact=False, exact=True and under
     FORCE_EXACT must give identical indices and masks (gpd_tpu's
     exact=False route is an exact sort and slice off a TPU);
  5. CEM: SequentialImportanceSampling at the default CEMConfig on the same
     scenes, one warm-up, then per scene with SUM_OF_GAUSSIANS and for
     request 0's scene with MAX_OF_GAUSSIANS the fused route (the default
     on a card: two CUDA graphs per static key, the rounds and the
     scoring, captured at its first request and replayed back to back)
     and the loop (_force_loop) in turns, each request from a
     generator of the same seed; every fused request must find the loop's
     round counts, a grasp with finite scores and >= 90% of the loop's
     selection by position (1e-5), a key's later requests capture
     nothing and call no kernel wrapper, each request's scored batch must
     hold its round counts, and one traced replay per key must run on the
     card the kernel launches its captures recorded, from two graph
     launches; prints ms
     per request of both routes, the capture's ms and the pool bytes the
     SIS's keys share, and raster_images launches per fused replay (from
     the trace);
  6. staged: request 0's scene through detect(staged=True) at a cap of
     4096 hands, its four-line report and peak memory; it must find
     detect's candidate count on the same generator seed and share >= 90%
     of detect's selection by position (1e-5);
  7. parallel: a world of one, an NCCL group over a file store on this
     card, on request 0's scene at the default DetectorConfig, by route.
     detect_sharded_raw and sharded_detect_host by the graph route (the
     detector as owner: its programs, CUDA graphs in its pool) and the
     eager route (no owner; _force_eager), the first request of each
     apart (each capture's ms and pool bytes), then graph, eager, eager,
     graph, then one traced request by each route (busy share, host launch
     calls, kernel time): every detect_sharded_raw batch must hold
     detect_core's valid geometry on the same samples (same count, 1e-5),
     every graph selection >= 90% of the eager route's by position, a
     later request must capture nothing and call no kernel wrapper, the
     traced detect_sharded_raw replay must take fewer than 100 host launch
     calls, and each traced replay must run the raster_blocks kernels its
     keys' captures recorded. CEM at the default CEMConfig by the mesh
     loop through the detector's programs, the eager mesh loop and the
     fused route, in turns, one traced request each: the same round counts
     on all three, the same final count on both mesh loops, nothing
     captured after the first requests, the traced graph loop running the
     raster_blocks kernels its keys' captures recorded. 40 training steps
     of fit with DistributedDataParallel (through StepGraphs: its eager
     steps, then one captured step with its all-reduce) must give the
     parameters of 40 plain steps, and 40 graph DDP steps those of 40
     eager DDP steps (each tensor within 1e-6 of its largest entry, under
     deterministic cuDNN), with ms a step in turns and host launch calls
     a step from a trace; the data-parallel evaluate must give the eager
     eval_step sums' loss (1e-6) and accuracy. No multi-card time is
     measured;
  8. C ABI: the port's gpd_c_api built with the host compiler against this
     Python's headers (or one line saying why it was not built, where
     Python.h is missing), loaded with ctypes, gpd_init("cuda"), a
     detector from a default config file: gpd_detect_grasps_in_cloud must
     return capi.detect_in_cloud's rows on scene 0 with seed 0 (geometry
     1e-5, scores 1e-3), gpd_calc_grasp_descriptors (G, 60, 60, 15) uint8
     images; a C request timed against capi's and api's;
  9. test_grasp_image: the app on a one-camera scene PCD on the card at an
     object point with a valid hand (its pose lines; the PNG where
     matplotlib imports), then viz's hand geometry on its hands;
 10. 3-channel entry point: GraspDetector.detect_file on synthetic
     single-camera table scenes written as PCD files to a temporary
     directory, at the default widths with 3 channels, 1000 samples, the
     packaged 3-channel weights and outlier removal, sampling above the
     plane and plane removal before the images all on; one warm-up, then
     per scene what phase 4 does per scene (its graphs run raster_sums;
     preprocess with the outlier filter, on the points read once),
     a stage breakdown, and the detect_grasps CLI once with a
     normals CSV and a CSV output; then the cem_detect_grasps (the fused
     route, raster_sums in a CUDA graph; traced, its replay must run the
     raster_sums launches its capture recorded),
     detect_grasps --staged and generate_candidates (with a CSV) CLIs
     once each; the api's detect_grasps_in_file and
     calc_grasp_descriptors once each at 15 channels, then
     detect_grasps_in_cloud with equal configs, on a new detector (the
     process's detectors emptied first) and on the kept one in turns (a
     call on the kept detector must capture nothing); and each PCD scene,
     then a 640 x 480 sensor frame (307200 points), parsed by the native
     and the NumPy route (identical, native in use, each route timed);
 11. profiler: one 15-channel detect request and one CEM request by each
     route: detect's graph route (replays of seen keys, which must run the
     launches their captures recorded) and its eager route, with their
     kernel time, busy share and host launch calls side by side, and each
     route's traced kernel time over the median of three untraced requests
     of it (the profiler makes a graph's launch call slow); CEM's
     loop first, the fused one a replay of a captured graph that must run
     the captured launches (after phase 15, one generate_view by each
     route at 15 and at 3 channels, whose graph replays must run the
     raster_blocks, at 3 channels the raster_sums, launches their captures
     recorded) under profiling.maybe_trace:
     the device's busy share of each window, its kernel launches and host
     launch calls, each span's host time and the device time of the kernels
     launched inside it, the window's longest idle gaps, and the device
     kernels with the most time (ten for detect's graph route, five for the
     others) with the operators that launched them;
 12. reference: on small scenes, the card's 15- and 3-channel grasp images
     against the CPU route (the repo's gate: under 0.5% of pixels off by
     more than one step);
 13. classify: lenet.score at 512 and 4096 hands, bf16 and f32;
 14. data generation: DataGenerator.generate_view at the default
     DetectorConfig and DataGenConfig on 12 (object, view) units (4 objects
     of the synthetic zoo, 3 render_view views each, the whole object as
     mesh cloud), each attempt gpd_tpu's programs (A: samples and
     candidates, one read of A's counts, B: images and scores over the
     live chunks, R: the relabeling), each a CUDA graph captured at the
     first request of its key: a warm pass that captures (each new key's
     capture ms and pool bytes, the pass's ms), then passes by the graph
     route and the eager attempt (_force_eager) in turns (graph, eager,
     eager, graph), each unit from its view_generator: ms/view and
     instances/s per route; per view attempts, candidates, positives,
     instances, ms by route and raster_blocks (recorded by the captures of
     the keys the view replayed, not traced; the eager route's wrapper
     calls); peak memory. Fails unless no later pass captures, no graph
     pass calls a kernel wrapper, every graph pass finds the eager route's
     labels on every unit and its images within the gate (under 0.5% of
     pixels more than one step apart). Then the same on the same detector
     for 4 views of 2 table scenes (render_view_occluded, the whole scene
     as mesh cloud), whose views fall in larger capacity buckets: each
     view's capacity and B keys, the detector's keys by part, its pool
     bytes and its one images buffer; fails unless every B key with
     images writes into that buffer and adds less than its bytes to the
     pool. Then one unit by a 3-channel detector at the packaged
     3-channel weights the same way (its B runs raster_sums in a graph);
     one eager attempt's candidates relabeled on the card and on the CPU
     (>= 99% agreement); one eager attempt's steps timed apart;
 15. training: net.train.fit on the generated instances of views 0-1 from
     memory (batch 64, lr 1e-3, wd 5e-4, two epochs; each step a replay of
     one CUDA graph, evaluation one per batch shape): ms per step, the
     loss must fall, held-out (view 2) accuracy; one step on the card and
     on the CPU from the same parameters and batch, and their gaps; then
     training by route (after phase 11's generate_view trace): 20 steps
     of StepGraphs.train_step (the graph) and of the eager train_step from
     the same parameters under deterministic cuDNN (losses and parameters
     within 1e-6 of each tensor's largest entry), ms a step in turns, and
     one traced pass of 20 steps by each route (busy share, host launch
     calls, kernel time);
 16. weights: the trained parameters as npz, ONNX (by the convert_weights
     CLI), a torch state dict and a raw .bin directory; a card detector
     from each holds them exactly and selects identically on scene 0;
 17. scores: in each reference check, the CPU route's images scored on the
     card and on the CPU at bf16 and f32: float32 logits, and top-k overlap
     of the card's bf16 scores with the CPU's >= 95%;
 18. net swap: the detector's net replaced by three nets made from the
     same parameters, each freed by the next, a scene-0 request after each,
     then back to the first net and garbage collected: the request must
     select as a fresh detector does (scores and positions within 1e-5),
     and detect's graphs hold only the current net;
 19. classifier pipeline, last, on a detector of its own (gen_dataset's:
     DetectorConfig() with 300 samples, min_inliers 0, the packaged
     weights), freed after it: gen_dataset.build_items at full width (15
     channels, 60x60, 8 orientations, view capacities 4096/12288, mesh
     capacities 6144/33792) for CLASSIFIER_DEPTH's 6 objects x 4 views and
     2 scenes x 4 views, through DataGenerator.generate by the graph route
     into memory (the card's machine has no h5py) twice: the first pass's
     new keys (capture ms, pool bytes), the second's ms/view and
     instances/s; fails unless the second captures nothing, calls no
     kernel wrapper and writes the first's labels. Then
     train_classifier's training (train.fit at batch 256, 6 epochs) on the
     training views: ms/step by CUDA events, the loss (must fall), held-out
     accuracy, and its float16 checkpoint (must hold gpd_tpu's keys, load
     through lenet.load_params and score finite). Then gpd_tpu's quality
     AUCs (held-out zoo objects, 80 samples; two clutter scenes, 120
     samples): the shipped lenet_15ch's on the card (floors 0.80 and 0.85)
     and on the CPU route from the same samples (within 0.02), the fresh
     checkpoint's and the shipped lenet_3ch's (no floor). Then one
     clutter view through a 15- and a 3-channel detector from one
     generator state: channels 0:3 of the raster_blocks images within the
     image gate of the raster_sums images; one traced graph view of
     gen_dataset's (its raster_images = those its captures recorded); the
     HDF5 CLIs where h5py imports, else one line saying they did not run.
     ``python3 chip_smoke.py classifier [OBJECTS VIEWS SCENES EPOCHS]``
     runs this phase alone (by default at the tools' defaults, 24 x 8, 8
     scenes, 6 epochs) and prints a summary line last;
 20. 12 and 1 channels, each on a detector of its own (random init from
     seed 0: no packaged checkpoint exists at these widths), freed after
     it. 12 channels (raster_images without shadows) at the default
     DetectorConfig otherwise: per scene of phase 4 what phase 4 does for
     detect and whole requests (graph against eager in turns, one traced
     replay running the raster_images its captures recorded); on scene 0
     the card against the same detector's CPU route (frames within 1e-4
     where well conditioned; from the CPU's frames the same valid hands
     within 1e-5; one image chunk within the image gate); CEM's fused
     route against its loop on scene 0 as phase 5 does; generate_view by
     route on one view of each zoo object as phase 14 does. 1 channel
     (raster_sums at Cp = 2): detect_file on phase 10's PCD scenes and
     options, per scene graph against eager in turns and one traced
     replay, then the card against the CPU route on the first scene.
     ``python3 chip_smoke.py widths`` runs raster_blocks' check and this
     phase alone and prints a summary line last;
 21. the kernels line (with each kernel's launches per path under its own
     name, data generation's per view by each route too; a second
     raster_blocks entry, shadows false; the 12/15-channel paths' launches
     on the raster_images entries), the card line, and the status line
     last.

Before each path of phases 4-10, 14, 19 and 20 every kernel's launch count
(the launch registry, ops/_build.py's LAUNCHES) is set to 0; it is read
just after the path's requests. A wrapper's launch counts where it
launches its kernel: eagerly, or into a CUDA graph during a capture. A replay calls no wrapper, so the kernels a replay runs are
counted from a profiler trace of it: the device kernels launched inside
its ``detect_core`` (detect) or ``cem_program`` (CEM) span. Phases 7-9
run after phase 6, phases 13-15 before phase 10; phases 12, 17 and 18
run late, 16 with them, and phases 19 and 20 last.
"""

import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np

REQUESTS = 3
# The kernel wrappers, each counting its launches under its own name.
KERNELS = ("raster_blocks", "raster_images", "raster_sums", "raster_sums2",
           "hand_search", "radius_moments", "outlier_knn")
# Kernel families of a profiler trace: a wrapper's kernels by their names
# (raster_sums2's kernels are raster_sums').
FAMILIES = ("raster_blocks", "raster_images", "raster_sums", "hand_search",
            "radius_moments")
# The hand search's check: (kind, traffic, configuration, capacity of the
# traffic's first cloud) of the benchmark's two serving cells.
HAND_SEARCH_CLOUDS = (("table", "table_stream", "gpd15", 14336),
                      ("pcd", "pcd_stream", "gpd3", 8192))
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
# Data generation: objects of the synthetic zoo drawn from this seed, and
# render_view views per object (the last one held out of training).
DATAGEN_SEED = 7
DATAGEN_OBJECTS = 4
DATAGEN_VIEWS = 3
DATAGEN_SCENES = 2
DATAGEN_SCENE_VIEWS = 2
# The classifier pipeline's depth: gen_dataset's items for 6 objects x 4
# views and 2 scenes x 4 views (its defaults: 24 x 8 and 8 x 8), and
# train_classifier's default epochs.
CLASSIFIER_DEPTH = (6, 4, 2)
CLASSIFIER_EPOCHS = 6
# The samples whose hands card_vs_cpu searches on the CPU too: the CPU's
# hand search over all 1000 took 16-26 s on the card's host.
CARD_VS_CPU_SAMPLES = 128
# The seed of the sensor-frame PCD that times the two ascii parse routes at
# the size of one depth frame.
SENSOR_SEED = 11
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


# f32 flops of one radius_moments pair test: three differences, a product,
# two fused multiply-adds (two each) and the compare.
MOMENT_PAIR_FLOPS = 9


def hand_search_ops(P):
    """The hand search's f32 operations per (member, orientation) at P
    finger placements: the hand-frame coordinates (3 products, 6 fused
    multiply-adds, counted twice), the height crop and min x (3), each of
    the 2P finger slabs' two tests and min (6P), then the closing-region
    test with its coordinates and y extremes (21)."""
    return 15 + 3 + 6 * P + 21


def check_raster(torch, img):
    """raster_blocks against raster_blocks_ref, with shadows (the 15-channel
    paths) and without (the 12-channel paths) on the same operands, each
    timed; returns the two kernels-line entries, with shadows first."""
    G, K, size = 512, 2048, 60
    gen = torch.Generator(device="cuda").manual_seed(0)
    midx, mvals, sidx, svals = raster_operands(torch, gen, G, K, K, size)
    entries = []
    for with_shadow in (True, False):
        args = ((midx, mvals, sidx, svals) if with_shadow
                else (midx, mvals, None, None))
        ref = img.raster_blocks_ref(*args, size)
        err = hold(torch, f"raster_blocks (shadows={with_shadow})",
                   lambda: img.raster_blocks(*args, size), ref,
                   raster_counts(with_shadow))
        print(f"raster_blocks shadows={with_shadow}: G={G} Km={K} "
              f"Ks={K if with_shadow else 0} NB={ref.shape[1]} "
              f"max_abs_err={err:.3e}")
        entries.append(dict(name="raster_blocks", shadows=with_shadow,
                            route="cuda",
                            source="gpd_tpu_torch/csrc/raster_blocks.cu",
                            replaces="gpd_tpu/ops/images.py:204",
                            max_abs_err=err,
                            **time_raster(torch, img, args, ref, size)))
    ragged = check_raster_ragged(torch, img)
    for e in entries:
        e["max_abs_err"] = max(e["max_abs_err"], ragged)
    return entries


def time_raster(torch, img, args, ref, size):
    """raster_blocks, its plain version and one index_put_ on the same
    operands (with shadows unless args' shadow operands are None), and the
    bound; prints them and returns the kernels-line timing fields."""
    ms = cuda_ms(torch, lambda *a: img.raster_blocks(*a, size), args)
    plain_ms = cuda_ms(torch, lambda *a: img.raster_blocks_ref(*a, size),
                       args)
    # Library yardstick: one index_put_(accumulate=True) on flat indices
    # precomputed from the same operands (never used by the port), into a
    # zeroed output.
    flat, vals = flat_contributions(torch, img, *args, size, ref.shape[1])
    lib_out = torch.zeros(ref.numel(), device="cuda")

    def library(flat, vals):
        lib_out.zero_()
        lib_out.index_put_((flat,), vals, accumulate=True)
    library_ms = cuda_ms(torch, library, (flat, vals))
    if not torch.allclose(lib_out.view_as(ref), ref, atol=1e-3, rtol=1e-5):
        fail("index_put_ yardstick disagrees with raster_blocks_ref")
    del lib_out
    nbytes = sum(t.numel() * t.element_size() for t in (*args, ref)
                 if t is not None)
    n_ops = int(vals.numel())          # one f32 add per contribution
    bound_ms, bound_by = bound(nbytes, n_ops)
    print(f"raster_blocks timing (G={args[0].shape[0]}, shadows="
          f"{args[2] is not None}): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {n_ops / 1e6:.1f} M "
          f"adds); ms / bound_ms = {ms / bound_ms:.2f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                bound_ratio=ms / bound_ms)


def images_ref(img, args, size):
    """The plain route's images of raster operands: _raster_finish of
    raster_blocks_ref, (G, C, size, size) uint8."""
    return img._raster_finish(img.raster_blocks_ref(*args, size), size,
                              12 if args[2] is None else 15)


def check_images(torch, img):
    """raster_images (the sums finished into uint8 channels in the kernel)
    against the plain route (images_ref), twice, at 512 hands with 2048
    points and 2048 shadow points, 15 channels and 12 (no shadows), then
    at the staged chunk of 4096 hands at 15: every pixel within one level
    (the sums' atomics add in a run-dependent order), the share of unequal
    pixels printed. Each timed beside the route it replaces on the card
    (raster_blocks, then _raster_finish: ``replaced_ms``), the plain route
    and its bound: the operands read once and the uint8 images written
    once, at the HBM rate. Returns the kernels-line entries: 15 channels,
    12 channels (each with the staged chunk's fields under
    ``staged_chunk`` at 15)."""
    size, K = 60, 2048
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = []
    for G in (512, 4096):
        args = raster_operands(torch, gen, G, K, K, size)
        for with_shadow in ((True, False) if G == 512 else (True,)):
            a = args if with_shadow else (*args[:2], None, None)
            C = 15 if with_shadow else 12
            ref = images_ref(img, a, size)
            share = 0.0
            for _ in range(2):
                out = img.raster_images(*a, size)
                torch.cuda.synchronize()
                gap = (out.int() - ref.int()).abs()
                if int(gap.max()) > 1:
                    fail(f"raster_images G={G} C={C}: a pixel "
                         f"{int(gap.max())} levels off the plain route")
                share = max(share, float((gap > 0).float().mean()))
            del out, gap, ref
            ms = cuda_ms(torch, lambda *x: img.raster_images(*x, size), a)
            replaced_ms = cuda_ms(torch, lambda *x: img._raster_finish(
                img.raster_blocks(*x, size), size, C), a)
            plain_ms = cuda_ms(torch, lambda *x: images_ref(img, x, size), a,
                               iters=3, warmup=1)
            nbytes = (sum(t.numel() * t.element_size() for t in a
                          if t is not None) + G * C * size * size)
            bound_ms, bound_by = bound(nbytes, 0)
            print(f"raster_images G={G} Km={K} Ks={K if with_shadow else 0} "
                  f"C={C}: unequal pixels {share:.3e} (max gap 1); "
                  f"{ms:.4f} ms against raster_blocks + _raster_finish "
                  f"{replaced_ms:.4f} ms ({replaced_ms / ms:.2f}x), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB); ms / bound_ms = "
                  f"{ms / bound_ms:.2f}")
            e = dict(name="raster_images", channels=C, route="cuda",
                     source="gpd_tpu_torch/csrc/raster_blocks.cu",
                     replaces="gpd_tpu/ops/images.py:204 and :638",
                     unequal_share=share, ms=ms, replaced_ms=replaced_ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     bound_ratio=ms / bound_ms)
            if G == 512:
                entries.append(e)
            else:
                entries[0]["staged_chunk"] = e
        del args
        torch.cuda.empty_cache()
    return entries


def check_raster_staged_chunk(torch, img):
    """raster_blocks at the staged route's chunk of 4096 hands (2048 points
    and 2048 shadow points each) against its plain version, timed; returns
    the timing fields with the max |diff|."""
    G, K, size = 4096, 2048, 60
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = raster_operands(torch, gen, G, K, K, size)
    ref = img.raster_blocks_ref(*args, size)
    err = hold(torch, f"raster_blocks G={G}",
               lambda: img.raster_blocks(*args, size), ref,
               raster_counts(True))
    print(f"raster_blocks shadows=True: G={G} Km={K} Ks={K} NB={ref.shape[1]}"
          f" output {ref.numel() * 4 / 2**30:.2f} GiB max_abs_err={err:.3e}")
    out = dict(time_raster(torch, img, args, ref, size), max_abs_err=err)
    del args, ref
    torch.cuda.empty_cache()
    return out


def benchmark_cloud(torch, GraspDetector, cell, config):
    """The first cloud of the benchmark's traffic ``cell``, preprocessed on
    the card as the benchmark's serving cell does, on a detector of its
    configuration ``config``. Returns (cloud, effective DetectorConfig)."""
    from h100_bench.entries.serve import program_config
    from h100_bench.inputs import generate
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "h100_bench")
    with open(os.path.join(root, "traffic", cell + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "configs", config + ".json")) as f:
        spec = json.load(f)
    mix["scene_seeds"] = mix["scene_seeds"][:1]
    det = GraspDetector(program_config(spec["detector"], spec["weights"]),
                        device="cuda")
    if mix["input"] == "memory":
        (it,) = generate.table_scenes(mix)
        cloud = det.preprocess_cloud(it["points"],
                                     view_points=it["view_points"],
                                     cam_source=it["cam_source"])
    else:
        (pts,) = generate.single_camera_scenes(mix)
        cam = np.asarray(det.cfg.camera_position, np.float32).reshape(1, 3)
        cloud = det.preprocess_cloud(pts, view_points=cam, capacity="serve")
    return cloud, det.effective_config(cloud)


def check_hand_search(torch, cand, detector, GraspDetector):
    """hand_search against its plain version on the benchmark's first
    table and PCD clouds at 1000 samples and 8 orientations, identity rows
    as the main path runs them: member counts exact, flags and mid equal
    on >= 99.9% of slots, the values within 1e-5 where valid agrees (R
    everywhere), twice; then the kernel, the plain version and the bound
    timed. Returns the kernels-line entry: the table cloud's shape, the PCD
    cloud's under "pcd"."""
    from gpd_tpu_torch import constant
    from gpd_tpu_torch.ops.frames import estimate_frames
    timings = {}
    for kind, cell, config, capacity in HAND_SEARCH_CLOUDS:
        cloud, cfg = benchmark_cloud(torch, GraspDetector, cell, config)
        if cloud.capacity != capacity:
            fail(f"hand_search: the {kind} cloud has capacity "
                 f"{cloud.capacity}, not {capacity}")
        spos, smask = detector.sample_points(cloud, seeded(torch, 0), cfg)
        frames, fvalid = estimate_frames(
            spos, smask, cloud.points, cloud.mask, cloud.normals,
            radius=cfg.nn_radius_frames)
        member, idx = cand._search_neighbors(
            spos, fvalid, cloud.points, cloud.mask, cfg.hand_search_radius,
            cfg.search_neighbors_cap)
        if idx is not None:
            fail(f"hand_search: the {kind} cloud took the capped route")
        rfix = constant(cand.rotation_grid(cfg.angles, cfg.hand_axes),
                        "cuda")
        params = cand.SearchParams.from_config(cfg)
        args = (cloud.points, cloud.normals, spos, frames, rfix, member,
                None, params)

        def plain(points, normals, spos, frames, rfix, member, idx, params):
            return cand._eval_orientations(
                points[None] - spos[:, None],
                normals[None].expand(spos.shape[0], -1, 3), member, frames,
                rfix, params)
        ref = plain(*args)
        n = ref["valid"].numel()
        err = 0.0
        for _ in range(2):
            out, members = cand.hand_search(*args)
            torch.cuda.synchronize()
            if not torch.equal(members, member.sum(1).int()):
                fail(f"hand_search ({kind}): member counts differ")
            off = {k: int((out[k] != ref[k]).sum())
                   for k in ("valid", "full", "half", "mid")}
            if max(off.values()) > n // 1000:
                fail(f"hand_search ({kind}): {off} of {n} slots differ")
            agree = out["valid"] == ref["valid"]
            gaps = [float((out["R"] - ref["R"]).abs().max())] + [
                float((out[k][agree] - ref[k][agree]).abs().max())
                for k in ("top", "bottom", "center", "width", "pos")]
            err = max(err, *gaps)
            if err > 1e-5:
                fail(f"hand_search ({kind}): values {err:.3e} apart")
        ms = cuda_ms(torch, lambda *a: cand.hand_search(*a), args)
        plain_ms = cuda_ms(torch, plain, args, iters=5, warmup=1)
        M, S, N = rfix.shape[0], spos.shape[0], cloud.capacity
        nbytes = (member.numel() + N * 24 + S * 48 + M * 36
                  + M * S * (13 * 4 + 4 * 4 + 8 + 3))
        n_ops = int(members.sum()) * M * hand_search_ops(
            params.num_placements)
        bound_ms, bound_by = bound(nbytes, n_ops)
        print(f"hand_search ({kind}, capacity {N}, S={S}, M={M}): members "
              f"mean {float(members.float().mean()):.1f}, max "
              f"{int(members.max())}; {int(ref['valid'].sum())} valid, "
              f"{int(ref['full'].sum())} full of {n} slots; mismatches "
              f"{off}; max abs err {err:.3e}; {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} G ops); ms / "
              f"bound_ms = {ms / bound_ms:.2f}")
        timings[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_ratio=ms / bound_ms,
                             max_abs_err=err, mismatches=off,
                             members_max=int(members.max()))
        del ref, out, args, member, cloud
        gc.collect()
        torch.cuda.empty_cache()
    return dict(name="hand_search", route="cuda",
                source="gpd_tpu_torch/csrc/hand_search.cu",
                replaces="none: gpd_tpu's _search_kernel "
                         "(gpd_tpu/ops/candidates.py:282) is XLA",
                **timings["table"], pcd=timings["pcd"],
                note="no one PyTorch call computes the search: no library "
                     "yardstick")


def check_radius_moments(torch, detector, GraspDetector):
    """radius_moments against radius_moments_ref and float64 on the
    benchmark's first table and PCD clouds: the normals' moments (every
    point a query, the normals radius) and the frames' (1000 samples and
    a CEM round's first 50, the frames radius). Counts off float64 only
    at pairs within 1e-6 r^2 of the boundary, sums within rtol = atol =
    1e-5 of float64 where the counts agree, twice bit for bit; the
    kernel's probe (radius_moments_probe) gives the same sums bit for bit
    and counts the (query warp, point group) pairs it judged and swept.
    Then the kernel and the plain route timed beside two operations
    bounds: the full sweep's (every live pair tested) and the swept
    groups' (32 x 32 pair tests each). Returns the kernels-line entry: the
    table normals' shape, the others under their names."""
    from gpd_tpu_torch.ops import neighbors as nbr
    timings = {}
    for kind, cell, config, capacity in HAND_SEARCH_CLOUDS:
        cloud, cfg = benchmark_cloud(torch, GraspDetector, cell, config)
        if cloud.capacity != capacity:
            fail(f"radius_moments: the {kind} cloud has capacity "
                 f"{cloud.capacity}, not {capacity}")
        w = cloud.mask.float()
        centroid = (cloud.points * w[:, None]).sum(0) / w.sum().clamp(min=1)
        p = torch.where(cloud.mask[:, None], cloud.points - centroid,
                        1.0e6).contiguous()
        n = cloud.normals
        spos, smask = detector.sample_points(cloud, seeded(torch, 0), cfg)

        def outer(v):
            x, y, z = v.unbind(1)
            return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z,
                                x, y, z], 1).contiguous()
        shapes = {"normals": (p, cloud.mask, p, cloud.mask, outer(p),
                              cfg.normals_radius),
                  "frames": (spos, smask, cloud.points, cloud.mask,
                             outer(n), cfg.nn_radius_frames),
                  "frames_cem": (spos[:50].contiguous(),
                                 smask[:50].contiguous(), cloud.points,
                                 cloud.mask, outer(n), cfg.nn_radius_frames)}
        for what, args in shapes.items():
            query, qmask, points, pmask, feats, radius = args
            r2 = float(np.float32(radius) * np.float32(radius))
            outs = [nbr.radius_moments(*args) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                fail(f"radius_moments ({kind} {what}): two launches differ")
            sums, counts = outs[0]
            q64, p64 = query.double(), points.double()
            c64, s64, edge = [], [], []
            for i in range(0, query.shape[0], 1024):
                d2 = ((q64[i:i + 1024, None] - p64[None]) ** 2).sum(-1)
                live = pmask[None] & qmask[i:i + 1024, None]
                m = ((d2 <= r2) & live).double()
                c64.append(m.sum(1))
                s64.append(m @ feats.double())
                edge.append((((d2 - r2).abs() <= 1e-6 * r2) & live).sum(1))
            c64, s64, edge = torch.cat(c64), torch.cat(s64), torch.cat(edge)
            off = (counts.double() - c64).abs()
            if bool((off > edge).any()):
                fail(f"radius_moments ({kind} {what}): counts off float64 "
                     f"beyond the boundary pairs")
            same = off == 0
            err = float((sums[same].double() - s64[same]).abs().max())
            if not torch.allclose(sums[same].double(), s64[same], rtol=1e-5,
                                  atol=1e-5):
                fail(f"radius_moments ({kind} {what}): sums {err:.3e} off "
                     f"float64")
            ref_s, ref_c = nbr.radius_moments_ref(*args)
            ref_same = ref_c.double() == c64
            ref_err = float((ref_s[ref_same].double()
                             - s64[ref_same]).abs().max())
            *probed, judged, swept = nbr.radius_moments_probe(*args)
            if not all(torch.equal(a, b) for a, b in zip(probed, outs[0])):
                fail(f"radius_moments ({kind} {what}): the probe's sums "
                     f"differ from the kernel's")
            ms = cuda_ms(torch, nbr.radius_moments, args)
            plain_ms = cuda_ms(torch, nbr.radius_moments_ref, args, iters=5,
                               warmup=1)
            Q, N, F = query.shape[0], points.shape[0], feats.shape[1]
            # f32 flops, a fused multiply-add counted as two (as
            # hand_search_ops): a pair's test (three differences, a
            # product, two fused multiply-adds, the compare) and a
            # member's F + 1 adds. The full sweep tests every live pair;
            # the kernel tests 32 x 32 pairs in each group it sweeps.
            pairs, members = int(qmask.sum()) * int(pmask.sum()), \
                int(c64.sum())
            n_ops = MOMENT_PAIR_FLOPS * pairs + (F + 1) * members
            swept_ops = MOMENT_PAIR_FLOPS * swept * 1024 + (F + 1) * members
            nbytes = Q * 13 + N * (13 + 4 * F) + Q * (F + 1) * 4
            bound_ms, bound_by = bound(nbytes, n_ops)
            swept_bound_ms, swept_by = bound(nbytes, swept_ops)
            print(f"radius_moments ({kind} {what}, Q={Q}, N={N}, F={F}, "
                  f"r={radius}): members {members} "
                  f"({members / max(1, pairs):.2%} of live pairs); "
                  f"boundary pairs {int(edge.sum())}; "
                  f"queries off float64: kernel {int((~same).sum())}, plain "
                  f"{int((~ref_same).sum())}; sums' gap to float64 "
                  f"{err:.3e} (plain {ref_err:.3e}); groups swept {swept} "
                  f"of {judged} (kernel's count); {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms; full-sweep bound {bound_ms:.4f} ms "
                  f"({bound_by}: {n_ops / 1e9:.3f} G flops), ms / bound_ms "
                  f"= {ms / bound_ms:.2f}; swept bound {swept_bound_ms:.4f} "
                  f"ms ({swept_by}: {swept_ops / 1e9:.3f} G flops), ms / "
                  f"swept_bound_ms = {ms / swept_bound_ms:.2f}; plain / ms "
                  f"= {plain_ms / ms:.1f}")
            timings[f"{kind}_{what}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_ratio=ms / bound_ms,
                swept_bound_ms=swept_bound_ms,
                swept_bound_ratio=ms / swept_bound_ms,
                groups_judged=judged, groups_swept=swept,
                max_abs_err=err, plain_max_abs_err=ref_err,
                queries_off_float64=int((~same).sum()), shape=[Q, N, F])
        del cloud, shapes, p, outs
        gc.collect()
        torch.cuda.empty_cache()
    head = timings.pop("table_normals")
    return dict(name="radius_moments", route="cuda",
                source="gpd_tpu_torch/csrc/radius_moments.cu",
                replaces="none: gpd_tpu's radius_moments "
                         "(gpd_tpu/ops/neighbors.py:176) is XLA",
                **head, by_shape=timings,
                note="no one PyTorch call computes the moments: no library "
                     "yardstick")

# f32 flops of one outlier_knn pair: three differences, a product, two
# fused multiply-adds (two each) and the compare with the list's bound.
KNN_PAIR_FLOPS = 9
# The outlier filter's check: (label, pcd_stream scene seed, the serve
# bucket its filter input fills): the traffic's first scene and its first
# at the 8192 bucket.
OUTLIER_SCENES = (("pcd scene 200", 200, 16384),
                  ("pcd scene 211", 211, 8192))


def outlier_inputs(seed):
    """The outlier filter's input in the pcd cell for pcd_stream's scene
    ``seed``: its points through the detector's first preprocess program
    on the card (workspace filter, voxels), compacted to the serve bucket,
    as preprocess_cloud hands them over. Returns (points, mask)."""
    from gpd_tpu_torch import detector
    from gpd_tpu_torch.core.types import CloudArrays
    from h100_bench.inputs import generate
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "h100_bench")
    with open(os.path.join(root, "traffic", "pcd_stream.json")) as f:
        mix = dict(json.load(f), scene_seeds=[seed])
    with open(os.path.join(root, "configs", "gpd3.json")) as f:
        spec = json.load(f)["detector"]
    (pts,) = generate.single_camera_scenes(mix)
    cam = np.asarray(spec["camera_position"], np.float32).reshape(1, 3)
    cloud = CloudArrays.from_numpy(
        pts, view_points=cam, capacity=detector.serve_capacity(len(pts)),
        device="cuda")
    cloud = detector._prep_filter_voxel(cloud, tuple(spec["workspace"]),
                                        spec["voxel_size"], True)
    cloud = cloud.compact_host(detector.serve_capacity(int(cloud.mask.sum())))
    return cloud.points, cloud.mask


def check_outlier_knn(torch):
    """outlier_knn (the outlier filter's mean distance to the 50 nearest)
    on two pcd_stream filter inputs, the 16384 and 8192 buckets (Q = N):
    twice bit for bit, the means within 1e-5 (relative) of float64's, the
    filter's kept mask equal to h100_bench's float64
    StatisticalOutlierRemoval; the probe (outlier_knn_probe) gives the
    same means bit for bit and counts the (query, point group) pairs it
    judged and swept. Then the kernel and the plain route (outlier_knn_ref
    on the card) timed beside two operations bounds: the full sweep's
    (every live pair tested) and the swept groups' (32 pair tests each).
    Returns the kernels-line entry: the first scene's, the other under
    ``by_shape``."""
    from gpd_tpu_torch.ops import neighbors as nbr
    from gpd_tpu_torch.ops import preprocess as pp
    from h100_bench.reference.gpd import outlier_mask
    timings = {}
    for label, seed, capacity in OUTLIER_SCENES:
        points, mask = outlier_inputs(seed)
        if points.shape[0] != capacity:
            fail(f"outlier_knn: the {label} filter input has capacity "
                 f"{points.shape[0]}, not {capacity}")
        args = (points, mask, 50)
        outs = [nbr.outlier_knn(*args) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(*outs):
            fail(f"outlier_knn ({label}): two launches differ")
        live = points[mask].double()
        d64 = torch.cat([torch.cdist(
            live[i:i + 1024], live,
            compute_mode="donot_use_mm_for_euclid_dist").sort(1).values[
                :, 1:51].mean(1) for i in range(0, len(live), 1024)])

        def rel_err(mean_d):
            return float(((mean_d[mask].double() - d64).abs() / d64).max())
        err, plain = rel_err(outs[0]), nbr.outlier_knn_ref(*args)
        plain_err = rel_err(plain)
        if err > 1e-5:
            fail(f"outlier_knn ({label}): means {err:.3e} off float64")
        want = outlier_mask(live)
        keep = pp._outlier_mask(*args, 1.0)
        off = int((keep[mask] != want).sum())
        if off or bool(keep[~mask].any()):
            fail(f"outlier_knn ({label}): the kept mask differs from "
                 f"float64's at {off} points")
        n = mask.sum()
        mu = torch.where(mask, plain, 0.0).sum() / n
        sd = torch.sqrt(torch.where(mask, (plain - mu) ** 2, 0.0).sum() / n)
        plain_off = int(((plain <= mu + sd)[mask] != want).sum())
        probed, judged, swept, bound_d2 = nbr.outlier_knn_probe(*args)
        if not torch.equal(probed, outs[0]):
            fail(f"outlier_knn ({label}): the probe's means differ from "
                 f"the kernel's")
        ms = cuda_ms(torch, nbr.outlier_knn, args)
        plain_ms = cuda_ms(torch, nbr.outlier_knn_ref, args, iters=5,
                           warmup=1)
        n_live, groups = int(n), -(-capacity // 32)
        n_ops = KNN_PAIR_FLOPS * n_live * n_live
        swept_ops = KNN_PAIR_FLOPS * swept * 32
        nbytes = capacity * (12 + 1 + 4)
        bound_ms, bound_by = bound(nbytes, n_ops)
        swept_bound_ms, swept_by = bound(nbytes, swept_ops)
        share = swept / (n_live * groups)
        print(f"outlier_knn ({label}, Q = N = {capacity}, {n_live} live, "
              f"mean_k 50): kept {int(want.sum())}, mask equal to "
              f"float64's (plain route off at {plain_off} points); means' "
              f"relative gap to float64 {err:.3e} (plain {plain_err:.3e}); "
              f"groups swept {swept} of {n_live * groups} pairs ({share:.2%}"
              f"; {judged} judged), mean bound {bound_d2:.3e} m^2; "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; full-sweep bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_ops / 1e9:.3f} G flops), "
              f"ms / bound_ms = {ms / bound_ms:.2f}; swept bound "
              f"{swept_bound_ms:.4f} ms ({swept_by}), ms / swept_bound_ms "
              f"= {ms / swept_bound_ms:.2f}; plain / ms = "
              f"{plain_ms / ms:.1f}")
        timings[label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_ratio=ms / bound_ms, swept_bound_ms=swept_bound_ms,
            swept_bound_ratio=ms / swept_bound_ms, groups_judged=judged,
            groups_swept=swept, swept_share=share, mean_bound=bound_d2,
            max_abs_err=err, plain_max_abs_err=plain_err,
            shape=[capacity, n_live])
        del points, mask, outs, plain, live, d64
        gc.collect()
        torch.cuda.empty_cache()
    head = timings.pop(OUTLIER_SCENES[0][0])
    return dict(name="outlier_knn", route="cuda",
                source="gpd_tpu_torch/csrc/outlier_knn.cu",
                replaces="none: gpd_tpu's _outlier_kernel "
                         "(gpd_tpu/ops/preprocess.py:102) is XLA",
                **head, by_shape=timings,
                note="no one PyTorch call computes the filter's means: no "
                     "library yardstick; max_abs_err is relative")


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
        if idx is None:
            continue
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


def graph_keys_line(det, n_before, t_first):
    """A request's first-request report: what it captured (the keys it
    added to det.graphs, each capture's ms and the pool bytes it added),
    the shared pool after it, and its ms."""
    new = list(det.graphs)[n_before:]
    if not new:
        return f"first request {t_first * 1e3:.2f} ms, keys seen"
    caps = ", ".join(f"{k[0]} {det.graphs[k].capture_s * 1e3:.2f} "
                     f"(+{det.graphs[k].pool_bytes} bytes)" for k in new)
    pool = sum(e.pool_bytes for e in det.graphs.values())
    return (f"first request {t_first * 1e3:.2f} ms, of it warm-up + "
            f"capture ms {caps}; the shared pool {pool} bytes over "
            f"{len(det.graphs)} graphs")


def normals_gaps(a, b):
    """(points compared, share of them whose normals are more than 1e-5
    apart, the largest gap): over the valid points of cloud ``a`` that
    cloud ``b`` holds at the same position."""
    pa, na = (t[a.mask].cpu().numpy() for t in (a.points, a.normals))
    pb, nb = (t[b.mask].cpu().numpy() for t in (b.points, b.normals))
    row = {p.tobytes(): i for i, p in enumerate(pb)}
    pairs = np.array([(i, row[p.tobytes()]) for i, p in enumerate(pa)
                      if p.tobytes() in row])
    if not len(pairs):
        fail("two preprocessed clouds share no point")
    gap = np.abs(na[pairs[:, 0]] - nb[pairs[:, 1]]).max(1)
    return len(pairs), float((gap > 1e-5).mean()), float(gap.max())


def in_turns(torch, det, request):
    """request() by the detector's graph routes (the default) and its eager
    routes (_force_eager) in turns, graph, eager, eager, graph, each timed
    on the host to a device sync. Returns {route: [(ms, result, the keys a
    graph request replayed)]}."""
    res = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        det._force_eager = route == "eager"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = request()
            torch.cuda.synchronize()
        finally:
            det._force_eager = False
        res[route].append((round((time.perf_counter() - t0) * 1e3, 2), out,
                           [k[0] for k in det.last_graphs]))
    return res


def preprocess_turns(torch, profiling, det, cpu_det, request, label, d):
    """One scene's preprocess_cloud (``request(detector)``) by its graph
    route (the default: one CUDA graph per program and key) and its eager
    route (_force_eager): the first request apart (what it captured, each
    new key's capture ms and pool bytes), then in_turns, then one traced
    request by each route, read by read_trace over its ``preprocess``
    span and on to the device sync after it (window, busy share, host
    launch calls, kernel time). The CPU route (``cpu_det``) on the same
    input sets the normals tolerance: each graph cloud must hold the eager
    cloud's mask and points exactly, and no larger share of normals more
    than 1e-5 apart (matched by position) than the eager cloud holds
    against the CPU's; a request of seen keys must capture nothing."""
    n_graphs = len(det.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    request(det)
    torch.cuda.synchronize()
    first = graph_keys_line(det, n_graphs, time.perf_counter() - t0)
    n_graphs = len(det.graphs)
    res = in_turns(torch, det, lambda: request(det))
    if len(det.graphs) != n_graphs:
        fail(f"{label}: a preprocess request of seen keys captured a graph")
    eager = res["eager"][0][1]
    n_cpu, share_cpu, max_cpu = normals_gaps(eager, request(cpu_det))
    gaps = []
    for _, cloud, _ in res["graph"]:
        if not (torch.equal(cloud.mask, eager.mask)
                and torch.equal(cloud.points, eager.points)):
            fail(f"{label}: the graph route's cloud leaves the eager "
                 f"route's mask or points")
        gaps.append(normals_gaps(cloud, eager))
        if gaps[-1][1] > share_cpu:
            fail(f"{label}: {gaps[-1][1]:.2e} of the graph route's normals "
                 f"are more than 1e-5 off the eager route's, which is "
                 f"{share_cpu:.2e} off the CPU's")

    def synced():
        # preprocess_cloud returns before the card ends its last program:
        # the window runs on to the device sync.
        with profiling.span("preprocess_request"):
            request(det)
            torch.cuda.synchronize()
    spans = ("preprocess_request", "preprocess")
    graph = read_trace(traced(profiling, synced, d), spans,
                       f"{label}, graph route", 0)
    det._force_eager = True
    try:
        eager_trace = read_trace(traced(profiling, synced, d + "_eager"),
                                 spans, f"{label}, eager route", 0)
    finally:
        det._force_eager = False
    print(f"{label}: {int(eager.mask.sum())} points (capacity "
          f"{eager.capacity}); {first}; ms in turns: graph "
          f"{[g[0] for g in res['graph']]}, eager "
          f"{[e[0] for e in res['eager']]}; a graph request replayed "
          f"{res['graph'][0][2]}; graph vs eager: masks and points equal, "
          f"normals more than 1e-5 apart {[f'{g[1]:.2e}' for g in gaps]} "
          f"(max {max(g[2] for g in gaps):.2e}); eager vs CPU on {n_cpu} "
          f"shared points {share_cpu:.2e} (max {max_cpu:.2e}); traced busy "
          f"{graph['busy']:.1%} vs {eager_trace['busy']:.1%}, host launch "
          f"calls {graph['calls']} vs {eager_trace['calls']}, kernel time "
          f"{graph['kernel_ms']:.2f} vs {eager_trace['kernel_ms']:.2f} ms")


def request_turns(torch, det, request, label):
    """A whole request, preprocess_cloud + detect (``request()``), by
    in_turns, beside the 100 ms request limit (PERF.md section 2)."""
    res = in_turns(torch, det, request)
    print(f"{label}: preprocess_cloud + detect, ms in turns: graph "
          f"{[g[0] for g in res['graph']]}, eager "
          f"{[e[0] for e in res['eager']]} (request limit 100 ms)")


def graph_turns(torch, img, profiling, det, request, label, family, d):
    """One request's scene by detect's graph route (the default) and its
    eager route (_force_eager): the first request of the scene apart (it
    captures what is new), then graph, eager, eager, graph in turns on
    one generator seed, then one traced graph request and one traced eager
    request, each read by read_trace (window, busy share, host launch
    calls, kernel time; no kernel list). Fails unless every
    request finds the eager route's candidate count and a grasp with
    finite scores, each graph request shares >= 90% of the eager route's
    selection by position (1e-5), a graph request of seen keys captures
    nothing and calls no kernel wrapper, and the traced replay runs in its
    detect_core span the ``family`` kernels its captures recorded. Returns
    the kernels the traced replay ran, per family."""
    n_graphs = len(det.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    request()
    first = graph_keys_line(det, n_graphs, time.perf_counter() - t0)
    n_graphs = len(det.graphs)
    res = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        det._force_eager = route == "eager"
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = request().to_host()
        finally:
            det._force_eager = False
        ms = round((time.perf_counter() - t0) * 1e3, 2)
        calls = sum(v - before[k] for k, v in counts().items())
        res[route].append((ms, dict(det.last_counts), out, calls,
                           dict(det.last_runtimes)))
    spans = ("detect_core", "select_and_cluster")
    events = traced(profiling, request, d)
    ran = span_launches(events, "detect_core")
    graph = read_trace(events, spans, f"{label}, graph replay", 0)
    want = captured_launches(*(det.graphs[k] for k in det.last_graphs))
    pair = det.last_graphs[1][-2:]
    det._force_eager = True
    try:
        eager_trace = read_trace(traced(profiling, request, d + "_eager"),
                                 spans, f"{label}, eager request", 0)
    finally:
        det._force_eager = False
    eager = res["eager"][0]
    shares = [selection_share(g[2], eager[2]) for g in res["graph"]]
    for route, runs in res.items():
        for ms, ct, out, calls, rt in runs:
            s = out.score[out.valid]
            if ct["candidates"] != eager[1]["candidates"]:
                fail(f"{label}: the {route} route found {ct['candidates']} "
                     f"candidates, the eager route {eager[1]['candidates']}")
            if ct["selected"] < 1 or not np.all(np.isfinite(s)):
                fail(f"{label}: the {route} route selected no grasp or a "
                     f"non-finite score")
            if route == "graph" and calls:
                fail(f"{label}: a graph request of seen keys called a "
                     f"kernel wrapper {calls} times: it ran eagerly")
    if len(det.graphs) != n_graphs:
        fail(f"{label}: a request of seen keys captured a graph")
    if min(shares) < 0.9:
        fail(f"{label}: the graph route shares {min(shares):.1%} of the "
             f"eager route's selection")
    if ran != want or ran[family] < 1:
        fail(f"{label}: a traced replay ran {ran}, its captures recorded "
             f"{want}")
    ct, rt = res["graph"][0][1], res["graph"][0][4]
    h = res["graph"][0][2]
    print(f"{label}: processed {ct['points']} points (capacity "
          f"{ct['capacity']}); samples {ct['samples']}, candidates "
          f"{ct['candidates']}, selected {ct['selected']}; {first}; ms in "
          f"turns: graph {[g[0] for g in res['graph']]}, eager "
          f"{[e[0] for e in res['eager']]}; graph detect "
          f"{rt['detect'] * 1e3:.2f}, select {rt['select'] * 1e3:.2f}, "
          f"detect total {rt['total'] * 1e3:.2f} ms; live (chunk, block) "
          f"ends {pair}; traced kernel time graph "
          f"{graph['kernel_ms']:.2f} vs eager {eager_trace['kernel_ms']:.2f} "
          f"ms ({graph['kernel_ms'] / eager_trace['kernel_ms'] - 1:+.2%}), "
          f"busy {graph['busy']:.1%} vs {eager_trace['busy']:.1%}, host "
          f"launch calls {graph['calls']} vs {eager_trace['calls']}; "
          f"selection shared with the eager "
          f"route's by position {[f'{x:.1%}' for x in shares]}; {family} "
          f"kernels run by a traced replay {ran[family]} (its captures "
          f"recorded {want[family]}; wrapper calls of the eager requests "
          f"{[e[3] for e in res['eager']]}); top scores "
          f"{np.round(h.score[h.valid][:5], 3).tolist()}")
    return ran


def main_path(torch, img, profiling, syn, det, cpu_det):
    """The 15-channel path: a warm-up request (its scene captures the first
    keys), then per scene preprocess_turns, graph_turns of detect and
    request_turns. Returns the kernel wrapper calls of the phase (warm-up
    and captures, the eager requests) and the kernels the traced replays
    ran."""
    t0 = time.perf_counter()
    p, cs, vp = scene(syn, 100)
    det.detect(det.preprocess_cloud(p, view_points=vp, cam_source=cs),
               generator=seeded(torch, 100), verbose=False)
    print(f"warm-up request (preprocess_cloud + detect): "
          f"{graph_keys_line(det, 0, time.perf_counter() - t0)}")

    reset_counts()
    ran = dict.fromkeys(FAMILIES, 0)
    traces = tempfile.TemporaryDirectory()
    for r in range(REQUESTS):
        p, cs, vp = scene(syn, r)
        print(f"request {r}: raw {len(p)} points")

        def prep(d, p=p, cs=cs, vp=vp):
            return d.preprocess_cloud(p, view_points=vp, cam_source=cs)
        preprocess_turns(torch, profiling, det, cpu_det, prep,
                         f"request {r} preprocess",
                         os.path.join(traces.name, f"preprocess_{r}"))
        cloud = prep(det)
        r_ran = graph_turns(
            torch, img, profiling, det, lambda: det.detect(
                cloud, generator=seeded(torch, r), verbose=False),
            f"request {r}", "raster_images",
            os.path.join(traces.name, f"detect_{r}"))
        for k, v in r_ran.items():
            ran[k] += v
        request_turns(torch, det, lambda: det.detect(
            prep(det), generator=seeded(torch, r), verbose=False),
            f"request {r}")
    traces.cleanup()
    launches = counts()
    if launches["raster_images"] < 1:
        fail("the 15-channel path never launched raster_images")
    print(f"launches on the 15-channel path: wrapper calls {launches} "
          f"(warm-ups and captures, and {5 * REQUESTS} eager requests, "
          f"{REQUESTS} of them traced); "
          f"{len(det.graphs)} graphs captured; traced replays ran "
          f"{ran['raster_images'] / REQUESTS:.2f} raster_images and "
          f"{ran['hand_search'] / REQUESTS:.2f} hand_search per request")
    return launches, {**ran, "raster_sums2": 0}


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


def entry_point_3ch(torch, img, profiling, pcd, det, cpu_det, paths, tmp):
    """Warm-up on paths[0], then per other path preprocess_turns of its
    points (read once; the serving buckets and the camera of detect_file),
    graph_turns of detect_file and request_turns. Returns the phase's
    kernel wrapper calls and the kernels the traced replays ran."""
    t0 = time.perf_counter()
    det.detect_file(paths[0], verbose=False, generator=seeded(torch, 100))
    print(f"3-channel warm-up request (detect_file): "
          f"{graph_keys_line(det, 0, time.perf_counter() - t0)}")
    reset_counts()
    ran = dict.fromkeys(FAMILIES, 0)
    cam = np.asarray(det.cfg.camera_position, np.float32).reshape(1, 3)
    for r, path in enumerate(paths[1:]):
        pts = pcd.load_cloud_file(path)
        print(f"3-channel request {r}: raw {len(pts)} points")

        def prep(d, pts=pts):
            return d.preprocess_cloud(pts, view_points=cam, capacity="serve")
        preprocess_turns(torch, profiling, det, cpu_det, prep,
                         f"3-channel request {r} preprocess (outliers)",
                         os.path.join(tmp, f"preprocess_file_{r}"))
        r_ran = graph_turns(
            torch, img, profiling, det, lambda: det.detect_file(
                path, verbose=False, generator=seeded(torch, r)),
            f"3-channel request {r} (detect_file, file read and preprocess "
            f"included)", "raster_sums",
            os.path.join(tmp, f"detect_file_{r}"))
        for k, v in r_ran.items():
            ran[k] += v
        request_turns(torch, det, lambda: det.detect(
            prep(det), generator=seeded(torch, r), verbose=False),
            f"3-channel request {r} (file read apart)")
    launches = counts()
    if launches["raster_sums"] < 1:
        fail("the 3-channel path never launched raster_sums")
    print(f"launches on the 3-channel path: wrapper calls {launches} "
          f"(warm-ups and captures, and {5 * REQUESTS} eager requests, "
          f"{REQUESTS} of them traced); "
          f"{len(det.graphs)} graphs captured; traced replays ran "
          f"{ran['raster_sums'] / REQUESTS:.2f} raster_sums and "
          f"{ran['hand_search'] / REQUESTS:.2f} hand_search per request")
    return launches, {**ran, "raster_blocks": 0, "raster_sums2": 0}


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
    return cfg


def seeded(torch, seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def selection_share(a, b):
    """The share of selection ``a``'s grasps that ``b`` holds at the same
    position (1e-5): both Grasps on the host."""
    pa, pb = a.position[a.valid], b.position[b.valid]
    if not len(pa) or not len(pb):
        return 0.0
    return float((np.abs(pa[:, None] - pb[None]).max(-1) <= 1e-5).any(1)
                 .mean())


def kernel_family(name):
    """The FAMILIES entry of a profiler trace's kernel ``name``, or None:
    csrc/raster_blocks.cu's images kernel is raster_images', its sums
    kernel raster_blocks'; of csrc/radius_moments.cu's three kernels a
    launch runs, its sweep stands for the launch."""
    if "raster_blocks_images" in name:
        return "raster_images"
    if "radius_moments" in name:
        return "radius_moments" if "radius_moments_kernel" in name else None
    return next((f for f in FAMILIES if f in name), None)


def span_launches(events, span, count=1):
    """Per kernel family, the device kernels of a profiler trace launched
    inside its ``count`` spans ``span`` (by the correlation id of their
    host launch; a graph replay's kernels carry its one launch call's)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    if len(spans) != count:
        fail(f"the profiler trace holds {len(spans)} {span} spans")
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    out = dict.fromkeys(FAMILIES, 0)
    for e in events:
        t = launch.get(e.get("args", {}).get("correlation"), -1)
        if e.get("cat") != "kernel" or e.get("ph") != "X" or not any(
                sp["ts"] <= t <= sp["ts"] + sp["dur"] for sp in spans):
            continue
        family = kernel_family(e["name"])
        if family is not None:
            out[family] += 1
    return out


def graph_launches(events, span):
    """The ``cudaGraphLaunch`` calls of a profiler trace inside its one
    ``span``."""
    (sp,) = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    return sum(1 for e in events if e.get("cat") == "cuda_runtime"
               and e.get("name", "").startswith("cudaGraphLaunch")
               and sp["ts"] <= e["ts"] <= sp["ts"] + sp["dur"])


def captured_launches(*graphs):
    """The launches that the captures of ``graphs`` recorded, per kernel
    family (span_launches')."""
    n = sum((g.launches for g in graphs), collections.Counter())
    return {"raster_blocks": n["raster_blocks"],
            "raster_images": n["raster_images"],
            "raster_sums": n["raster_sums"] + n["raster_sums2"],
            "hand_search": n["hand_search"],
            "radius_moments": n["radius_moments"]}


def cem_graphs(sis, cloud):
    """A CEM request's two graphs on ``cloud``, R and S."""
    key = sis.graph_key(cloud)
    return [sis.graphs[(name,) + key] for name in ("cem_rounds",
                                                    "cem_scoring")]


def cem_path(torch, img, profiling, syn, det, cem, CEMConfig, runs=None,
             label="CEM"):
    """CEM (SequentialImportanceSampling) at the default CEMConfig on the
    15-channel path's scenes, by the fused route (the default on the card:
    two CUDA graphs per static key, R the rounds and S the scoring,
    captured at the key's first request and replayed back to back) and
    by the loop (_force_loop), in turns (fused, loop, loop, fused, after
    the fused route's first request), every request from a generator of
    the same seed: ``runs``' (scene, sampling method) pairs, by default a
    scene each with SUM_OF_GAUSSIANS, then request 0's scene with
    MAX_OF_GAUSSIANS. Fails unless every fused request finds the
    loop's round counts, selects a grasp with finite scores and shares >=
    90% of the loop's selection by position (1e-5), returns a scored batch
    whose rounds hold their counts of valid hands (``last_scored``,
    ``last_round_slots``) with the loop's valid slots, and a key's later
    requests capture nothing and call no kernel wrapper. After the turns,
    one more fused request of the key is traced; it must run on the card
    the launches the key's captures recorded, from two graph launches.
    Returns the launches of the traced replays (from their traces) and the
    loop requests' counts."""
    fused = cem.SequentialImportanceSampling(det, CEMConfig())
    loop = cem.SequentialImportanceSampling(det, CEMConfig())
    loop._force_loop = True
    p, cs, vp = scene(syn, 100)
    t0 = time.perf_counter()
    loop.detect(det.preprocess_cloud(p, view_points=vp, cam_source=cs),
                generator=seeded(torch, 100), verbose=False)
    print(f"{label} warm-up request (loop): {time.perf_counter() - t0:.3f} s")
    reset_counts()
    by_route = {"fused": counts(), "loop": counts()}
    traces = tempfile.TemporaryDirectory()
    runs = runs or ([(r, cem.SUM_OF_GAUSSIANS) for r in range(REQUESTS)]
                    + [(0, cem.MAX_OF_GAUSSIANS)])
    for r, method in runs:
        fused.cem = loop.cem = CEMConfig(sampling_method=method)
        p, cs, vp = scene(syn, r)
        cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
        name = ("MAX_OF_GAUSSIANS" if method == cem.MAX_OF_GAUSSIANS
                else "SUM_OF_GAUSSIANS")
        n_graphs = len(fused.graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.detect(cloud, generator=seeded(torch, r), verbose=False)
        t_first = time.perf_counter() - t0
        if len(fused.graphs) > n_graphs:
            new = list(fused.graphs.values())[n_graphs:]
            first = (f"first fused request {t_first * 1e3:.2f} ms, of it "
                     f"the eager warm-ups and the captures of R and S "
                     f"{sum(e.capture_s for e in new) * 1e3:.2f} ms, the "
                     f"captures grew the shared pool by "
                     f"{sum(e.pool_bytes for e in new)} bytes to "
                     f"{fused.pool_bytes} over {len(fused.graphs) // 2} "
                     f"keys")
        else:
            first = (f"first fused request {t_first * 1e3:.2f} ms, key "
                     f"seen: nothing captured")
        n_graphs = len(fused.graphs)
        ms = {"fused": [], "loop": []}
        res, scored = {}, {}
        for route in ("fused", "loop", "loop", "fused"):
            sis = fused if route == "fused" else loop
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sis.detect(cloud, generator=seeded(torch, r),
                             verbose=False)
            ms[route].append(round((time.perf_counter() - t0) * 1e3, 2))
            delta = {k: v - before[k] for k, v in counts().items()}
            if route == "loop":
                for k, v in delta.items():
                    by_route["loop"][k] += v
            res.setdefault(route, []).append(
                (list(sis.last_round_counts), sis.last_num_grasps,
                 out.to_host(), delta["raster_images"]))
            valid = sis.last_scored.valid.cpu().numpy()
            scored.setdefault(route, []).append(valid)
            if [int(valid[a:a + n].sum()) for a, n in
                    sis.last_round_slots] != sis.last_round_counts:
                fail(f"{label} request {r} ({name}): the {route} route's "
                     f"scored batch does not hold its round counts")
        want = captured_launches(*cem_graphs(fused, cloud))
        d = os.path.join(traces.name, f"cem_{r}_{method}")
        events = traced(profiling, lambda: fused.detect(
            cloud, generator=seeded(torch, r), verbose=False), d)
        ran = span_launches(events, "cem_program")
        graphs = graph_launches(events, "cem_program")
        for k in KERNELS:
            by_route["fused"][k] += ran.get(k, 0)
        rounds_l, grasps_l, sel_l, launch_l = res["loop"][0]
        shares = [selection_share(f[2], sel_l) for f in res["fused"]]
        h = res["fused"][0][2]
        scores = h.score[h.valid]
        print(f"{label} request {r} ({name}): {int(cloud.mask.sum())} points, "
              f"capacity {cloud.capacity}; round candidates "
              f"{res['fused'][0][0]} (loop {rounds_l}), valid candidates "
              f"{sum(res['fused'][0][0])} (loop {sum(rounds_l)}), grasps "
              f"{[f[1] for f in res['fused']]} (loop "
              f"{[x[1] for x in res['loop']]}); selection shared with the "
              f"loop's by position {[f'{s:.1%}' for s in shares]}; ms in "
              f"turns: fused {ms['fused']}, loop {ms['loop']}; {first}; "
              f"raster_images launches per fused request: wrapper calls "
              f"{[f[3] for f in res['fused']]}, run by a traced replay "
              f"{ran['raster_images']} from {graphs} graph launches (its "
              f"captures recorded {want['raster_images']}; loop "
              f"{launch_l}); image slots {fused.last_counts['image_slots']} "
              f"for {fused.last_counts['live_hands']} valid hands; top scores "
              f"{np.round(scores[:5], 3).tolist()}")
        for rounds_f, grasps_f, sel_f, launch_f in res["fused"]:
            if rounds_f != rounds_l:
                fail(f"{label} request {r} ({name}): the fused route's round "
                     f"counts {rounds_f} are not the loop's {rounds_l}")
            s = sel_f.score[sel_f.valid]
            if grasps_f < 1 or not np.all(np.isfinite(s)):
                fail(f"{label} request {r} ({name}): the fused route found no "
                     f"grasp or a non-finite score")
            if launch_f != 0:
                fail(f"{label} request {r} ({name}): a fused request of a "
                     f"seen key called a kernel wrapper: it ran eagerly")
        if ran != want or ran["raster_images"] < 1 or graphs != 2:
            fail(f"{label} request {r} ({name}): a traced replay ran {ran} "
                 f"from {graphs} graph launches, its captures recorded "
                 f"{want} in 2 graphs")
        if any(not np.array_equal(v, scored["loop"][0])
               for v in scored["fused"]):
            fail(f"{label} request {r} ({name}): the fused route's scored "
                 f"batch has other valid slots than the loop's")
        if min(shares) < 0.9:
            fail(f"{label} request {r} ({name}): the fused route shares "
                 f"{min(shares):.1%} of the loop's selection")
        if len(fused.graphs) != n_graphs:
            fail(f"{label} request {r} ({name}): a request of a seen key "
                 f"captured a graph")
    print(f"launches on the {label} path: fused, run by {len(runs)} traced "
          f"replays {by_route['fused']}; loop {by_route['loop']} "
          f"({2 * len(runs)} requests); {len(fused.graphs)} graphs "
          f"captured ({len(fused.graphs) // 2} keys), their shared pool "
          f"{fused.pool_bytes} bytes")
    traces.cleanup()
    return by_route


def staged_path(torch, img, syn, det):
    """Request 0's scene through detect(staged=True) at its default staged
    cap, 4096 for the 8000 hands of 1000 samples: its report, candidates,
    launches and peak memory, held against detect() on the same generator
    seed."""
    p, cs, vp = scene(syn, 0)
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    ref = det.detect(cloud, generator=seeded(torch, 0), verbose=False)
    n_ref = det.last_counts["candidates"]
    det.detect(cloud, generator=seeded(torch, 0), verbose=False,
               staged=True)                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = det.detect(cloud, generator=seeded(torch, 0), verbose=True,
                     staged=True)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = det.last_counts["candidates"]
    a, b = out.to_host(), ref.to_host()
    shared = selection_share(a, b)
    print(f"staged request 0: {int(cloud.mask.sum())} points, candidates {n} "
          f"(detect: {n_ref}), selected {int(a.valid.sum())} (detect: "
          f"{int(b.valid.sum())}), "
          f"{shared:.1%} of them shared by position with detect's; "
          f"runtimes (ms) " + ", ".join(
              f"{k} {v * 1e3:.2f}" for k, v in det.last_runtimes.items()) +
          f"; launches {launches}; peak device memory {peak:.2f} GiB")
    if n != n_ref:
        fail(f"staged route found {n} candidates, detect {n_ref}")
    if shared < 0.9:
        fail(f"staged route shares {shared:.1%} of its selection with detect")
    if launches["raster_images"] < 1:
        fail("the staged route never launched raster_images")
    return launches


def clis_3ch(img, cem_app, detect_grasps, gen_app, cfg, path, tmp):
    """cem_detect_grasps, detect_grasps --staged and generate_candidates
    (with a CSV) once each on a 3-channel PCD scene; returns each one's
    launch counts. cem_detect_grasps runs under GPD_TPU_PROFILE: its one
    request captures the fused graph (an eager warm-up, then the capture,
    in the span cem_capture) and replays it (cem_program). Each wrapper
    call of the warm-up runs once and each of the capture once per replay,
    so the wrapper's count must equal the trace's kernels of the two spans
    together, and the replay must run raster_sums; the replay's count from
    the trace is returned as a path of its own."""
    out_csv = os.path.join(tmp, "candidates.csv")
    per_cli = {}
    for name, app, argv in (("cem_detect_grasps", cem_app, [cfg, path]),
                            ("detect_grasps --staged", detect_grasps,
                             [cfg, path, "--staged"]),
                            ("generate_candidates", gen_app,
                             [cfg, path, out_csv])):
        reset_counts()
        trace_dir = os.path.join(tmp, "cli_cem")
        if name == "cem_detect_grasps":
            os.environ["GPD_TPU_PROFILE"] = trace_dir
        t0 = time.perf_counter()
        try:
            rc = app.main(argv)
        finally:
            os.environ.pop("GPD_TPU_PROFILE", None)
        per_cli[name] = counts()
        how = ""
        if name == "cem_detect_grasps" and rc == 0:
            (trace,) = os.listdir(trace_dir)
            with open(os.path.join(trace_dir, trace)) as f:
                events = json.load(f)["traceEvents"]
            # R's and S's captures, each inside cem_program.
            warm = span_launches(events, "cem_capture", 2)["raster_sums"]
            ran = (span_launches(events, "cem_program")["raster_sums"]
                   - warm)
            calls = (per_cli[name]["raster_sums"]
                     + per_cli[name]["raster_sums2"])
            how = (f" (wrapper calls of the eager warm-up and the capture; "
                   f"the trace's kernels: warm-up {warm}, replay {ran})")
            if ran < 1 or calls != warm + ran:
                fail(f"cem_detect_grasps: {calls} raster_sums wrapper calls, "
                     f"the trace ran {warm} in the warm-up and {ran} in the "
                     f"replay")
            per_cli[f"{name} replay (trace)"] = {
                "raster_blocks": 0, "raster_sums": ran, "raster_sums2": 0}
        print(f"{name} CLI: exit {rc} in {time.perf_counter() - t0:.3f} s "
              f"({'traced' if how else 'untraced'}); raster_sums launches "
              f"{per_cli[name]['raster_sums']}{how}")
        if rc != 0:
            fail(f"{name} returned {rc}")
    with open(out_csv) as f:
        rows = f.read().splitlines()
    if not rows or any(len(r.split(",")) != 13 for r in rows):
        fail(f"generate_candidates wrote {len(rows)} CSV rows")
    print(f"generate_candidates CSV: {len(rows)} rows")
    for name in ("cem_detect_grasps", "detect_grasps --staged"):
        if per_cli[name]["raster_sums"] < 1:
            fail(f"{name} never launched raster_sums")
    return per_cli


def api_15ch(api, DetectorConfig, pcd, path, cam):
    """detect_grasps_in_file and calc_grasp_descriptors once each at the
    default (15-channel) config on a PCD scene."""
    cfg = DetectorConfig(camera_position=tuple(cam[0].tolist()))
    t0 = time.perf_counter()
    grasps = api.detect_grasps_in_file(cfg, path, seed=0)
    t_file = time.perf_counter() - t0
    t0 = time.perf_counter()
    cands, images = api.calc_grasp_descriptors(cfg, pcd.load_cloud_file(path),
                                               seed=0)
    t_desc = time.perf_counter() - t0
    print(f"api: detect_grasps_in_file {len(grasps)} grasps in {t_file:.3f} "
          f"s; calc_grasp_descriptors {len(cands)} candidates, images "
          f"{images.shape} {images.dtype} in {t_desc:.3f} s")
    if not grasps or not np.isfinite([g["score"] for g in grasps]).all():
        fail("detect_grasps_in_file found no grasp or a non-finite score")
    if images.shape != (len(cands), 60, 60, 15) or not len(cands):
        fail(f"calc_grasp_descriptors gave images {images.shape}")


def api_cache_check(torch, api, DetectorConfig, syn):
    """api.detect_grasps_in_cloud on scene 0 with equal configs (a new
    DetectorConfig() each call): with the process's detectors emptied
    before the call (a new detector per call, as the API made before it
    kept one per config) and on the kept detector, in turns (new, kept,
    kept, new). Fails unless a call on the kept detector captures no graph,
    and every call returns the same grasp count."""
    p, cs, vp = scene(syn, 0)
    res = {"new": [], "kept": []}
    for route in ("new", "kept", "kept", "new"):
        if route == "new":
            api._DETECTORS.clear()
            gc.collect()
        n = sum(len(d.graphs) for *_, d in api._DETECTORS.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grasps = api.detect_grasps_in_cloud(DetectorConfig(), p,
                                            view_points=vp, cam_source=cs,
                                            seed=0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        captured = sum(len(d.graphs) for *_, d in api._DETECTORS.values()) - n
        res[route].append((round(ms, 2), len(grasps), captured))
    print(f"api detector cache (detect_grasps_in_cloud, scene 0, equal "
          f"configs; ms, grasps, graphs captured): a new detector per call "
          f"{res['new']}, the kept detector {res['kept']}; the first two "
          f"calls {res['new'][0][0]} and {res['kept'][0][0]} ms")
    if any(c for _, _, c in res["kept"]):
        fail("an API call with an equal config captured graphs")
    if len({n for runs in res.values() for _, n, _ in runs}) != 1 or \
            not res["new"][0][1]:
        fail("API calls with equal configs returned other grasp counts")


def net_swap_check(torch, lenet, syn, det, GraspDetector, DetectorConfig):
    """det.net swapped to three nets made from the same numpy parameters,
    each freed by the next swap, a request on scene 0 (seed 0) after each,
    then back to the first net and garbage collected: the request's
    selection must equal a fresh detector's on the same cloud and seed
    (valid flags exact, scores and positions within 1e-5), and the graphs
    must hold only the current net."""
    p, cs, vp = scene(syn, 0)
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    first = det.net
    params = lenet.params_to_numpy(first)
    dropped = []
    for swap in range(4):
        n = len(det.graphs)
        det.net = lenet.params_from_numpy(params, "cuda") if swap < 3 \
            else first
        dropped.append(n - len(det.graphs))
        if swap == 3:
            gc.collect()
        out = det.detect(cloud, generator=seeded(torch, 0),
                         verbose=False).to_host()
    held = {k[4] for k in det.graphs if k[0] in ("candidates", "score",
                                                 "select")}
    fresh = GraspDetector(DetectorConfig(), device="cuda").detect(
        cloud, generator=seeded(torch, 0), verbose=False).to_host()
    v = out.valid
    gap = (float(np.abs(out.score[v] - fresh.score[fresh.valid]).max())
           if np.array_equal(v, fresh.valid) else np.inf)
    print(f"net swap (scene 0, seed 0): graphs dropped at each swap "
          f"{dropped}; nets held by detect's graphs {len(held)}; "
          f"{int(v.sum())} selected, score gap to a fresh detector {gap:.2e}")
    if held != {id(first)}:
        fail("detect's graphs hold a net other than the current one")
    if not v.any() or gap > 1e-5 or np.abs(
            out.position[v] - fresh.position[fresh.valid]).max() > 1e-5:
        fail("after the net swaps the detector leaves a fresh detector's "
             "selection")


def sensor_frame_pcd(pcd, tmp, seed=SENSOR_SEED):
    """An ascii PCD at the size of one 640 x 480 depth frame (307200
    points): a tilted plane 0.5-1 m away with 1 mm noise, back-projected
    through a pinhole camera, and 10% of the pixels without depth (NaN
    rows), as an organized sensor cloud comes."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:480, 0:640].astype(np.float64)
    x, y = (u - 319.5) / 525.0, (v - 239.5) / 525.0
    z = 0.5 + 0.25 * (x + 1.0) + rng.normal(0.0, 0.001, x.shape)
    pts = np.stack([x * z, y * z, z], -1).reshape(-1, 3)
    pts[rng.random(len(pts)) < 0.1] = np.nan
    path = os.path.join(tmp, "sensor_frame.pcd")
    pcd.save_pcd(path, pts)
    return path


def pcd_routes(pcd, paths, repeats=5):
    """Each PCD scene parsed by the native route and by NumPy: identical
    arrays, and the native route in use; prints each route's median
    load_pcd time over ``repeats`` calls (host clock, file read
    included)."""
    route = pcd.ascii_route()

    def timed():
        times, out = [], None
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = pcd.load_pcd(path)
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times))
    for path in paths:
        native, t_native = timed()
        saved = pcd._native_parser
        pcd._native_parser = lambda: None
        try:
            plain, t_numpy = timed()
        finally:
            pcd._native_parser = saved
        same = np.array_equal(native, plain, equal_nan=True)
        print(f"PCD {os.path.basename(path)} ({os.path.getsize(path)} bytes, "
              f"{len(native)} points): route {route}, load_pcd median of "
              f"{repeats}: native {t_native * 1e3:.2f} ms, numpy "
              f"{t_numpy * 1e3:.2f} ms; identical {same}")
        if route != "native":
            fail("ascii PCD bodies do not parse natively")
        if not same:
            fail(f"the native and NumPy routes disagree on {path}")


def traced(profiling, fn, d):
    """The Chrome trace events of fn() under profiling.maybe_trace(d)."""
    with profiling.maybe_trace(d) as prof:
        fn()
    if prof is None:
        fail("maybe_trace did not trace")
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        return json.load(f)["traceEvents"]


def read_trace(events, span_names, label, n_top):
    """Prints a traced request's device busy share over its window (the
    union of kernel intervals from the first span's start to the last
    one's end), the idle time in gaps under 20 us (kernel to kernel on the
    card) and its three longest idle gaps, each span's host time and
    the device time of the kernels launched inside it, and the n_top
    kernels with the most time with the operators that launched them.
    Returns the window's ms, busy share, kernel ms and host launch
    calls."""
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("ph") == "X"]
    spans = {e["name"]: e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") in span_names}
    if not kernels:
        fail(f"the profiler trace of the {label} holds no device kernel")
    if set(spans) != set(span_names):
        fail(f"the profiler trace lacks spans: {sorted(spans)}")
    w0 = min(e["ts"] for e in spans.values())
    w1 = max(e["ts"] + e["dur"] for e in spans.values())
    busy, end, gaps = 0.0, w0, []
    for e in sorted(kernels, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], w1)
        if b > a:
            gaps.append((a - end, end - w0))
            busy += b - a
            end = b
    gaps.append((w1 - end, end - w0))
    # Each kernel's launch on the host (the runtime call with its
    # correlation id) and the operator that launched it (the cpu_op with
    # its External id).
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    parts = []
    for name in span_names:
        sp = spans[name]
        inside = [k["dur"] for k in kernels if sp["ts"] <= launch.get(
            k.get("args", {}).get("correlation"), -1) <= sp["ts"] + sp["dur"]]
        parts.append(f"{name}: host {sp['dur'] / 1e3:.2f} ms, "
                     f"{len(inside)} kernels {sum(inside) / 1e3:.2f} ms")
    by_name = {}
    for e in kernels:
        op = op_of.get(e.get("args", {}).get("External id"), "?")
        t, n, ops = by_name.get(e["name"], (0.0, 0, set()))
        by_name[e["name"]] = (t + e["dur"], n + 1, ops | {op})
    total = sum(v[0] for v in by_name.values())
    # Launch calls on the host: one per kernel eagerly, one per graph.
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "") and w0 <= e["ts"] <= w1]
    calls = len(launches)
    print(f"profiler, {label}: window {(w1 - w0) / 1e3:.2f} ms, "
          f"{len(kernels)} kernel launches of {len(by_name)} kernels from "
          f"{calls} host launch calls, "
          f"{total / 1e3:.2f} ms of kernel time; device busy "
          f"{busy / (w1 - w0):.1%} of the window; idle in gaps under 20 "
          f"us {sum(g for g, _ in gaps if g < 20) / 1e3:.2f} ms in "
          f"{sum(1 for g, _ in gaps if 0 < g < 20)}; longest idle gaps (ms "
          f"at ms into the window) " + ", ".join(
              f"{g / 1e3:.2f} at {at / 1e3:.2f}"
              for g, at in sorted(gaps, reverse=True)[:3]) + "; " +
          "; ".join(parts))
    if calls <= 20:
        print("  host launch calls (ms at ms into the window, host ms): " +
              ", ".join(f"{e['name']} at {(e['ts'] - w0) / 1e3:.2f} "
                        f"{e['dur'] / 1e3:.3f}" for e in launches))
    g, at = max(gaps)
    if g > 5e3:
        # What ran across the longest idle gap: host operators and runtime
        # calls, and the copy engine's transfers.
        a, b = w0 + at, w0 + at + g
        over = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in (
                    "cpu_op", "cuda_runtime", "gpu_memcpy", "gpu_memset"):
                o = min(e["ts"] + e["dur"], b) - max(e["ts"], a)
                if o > 0:
                    over[e["name"]] = over.get(e["name"], 0.0) + o
        print(f"  across the longest idle gap ({g / 1e3:.2f} ms), ms: " +
              ", ".join(f"{n[:40]} {o / 1e3:.2f}" for n, o in sorted(
                  over.items(), key=lambda kv: -kv[1])[:6]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n_top]
    for kname, (t, n, ops) in top:
        print(f"  {t / 1e3:8.3f} ms {n:5d} calls  from "
              f"{', '.join(sorted(ops))[:80]}: {kname[:100]}")
    return dict(window_ms=(w1 - w0) / 1e3, busy=busy / (w1 - w0),
                kernel_ms=total / 1e3, calls=calls)


def profile_requests(torch, profiling, cem, CEMConfig, syn, det, tmp):
    """Two 15-channel detect requests, by the graph route (replays of seen
    keys) and by the eager route, and two CEM requests, by the loop and by
    the fused route (request 0's scene), under profiling.maybe_trace, each
    read by read_trace; beside detect's, each route's traced kernel time
    over the median total of three untraced requests of the route (under
    the profiler a graph's launch call takes milliseconds on the host, the
    card idle meanwhile). The CEM loop goes before the fused capture: a
    capture empties the allocator's cache, which the next eager requests
    refill. Each replay must run the launches its captures recorded."""
    p, cs, vp = scene(syn, 0)
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)

    def untraced_ms(eager):
        """The median detect total of three untraced requests."""
        det._force_eager = eager
        try:
            totals = []
            for _ in range(3):
                det.detect(cloud, generator=seeded(torch, 0), verbose=False)
                totals.append(det.last_runtimes["total"] * 1e3)
        finally:
            det._force_eager = False
        return float(np.median(totals))
    plain = {"graph": untraced_ms(False), "eager": untraced_ms(True)}
    n_graphs = len(det.graphs)
    events = traced(profiling, lambda: det.detect(
        cloud, generator=seeded(torch, 0), verbose=False),
        os.path.join(tmp, "detect"))
    graph = read_trace(events, ("detect_core", "select_and_cluster"),
                       "15-channel detect request, graph route (replays)",
                       10)
    ran = span_launches(events, "detect_core")
    want = captured_launches(*(det.graphs[k] for k in det.last_graphs))
    if ran != want or len(det.graphs) != n_graphs:
        fail(f"the traced detect replay ran {ran}, its captures recorded "
             f"{want}; graphs {n_graphs} -> {len(det.graphs)}")
    det._force_eager = True
    try:
        events = traced(profiling, lambda: det.detect(
            cloud, generator=seeded(torch, 0), verbose=False),
            os.path.join(tmp, "detect_eager"))
    finally:
        det._force_eager = False
    eager = read_trace(events, ("detect_core", "select_and_cluster"),
                       "15-channel detect request, eager route", 5)
    print(f"profiler, detect graph route vs eager route: kernel time "
          f"{graph['kernel_ms']:.2f} vs {eager['kernel_ms']:.2f} ms "
          f"({graph['kernel_ms'] / eager['kernel_ms'] - 1:+.2%}), window "
          f"{graph['window_ms']:.2f} vs {eager['window_ms']:.2f} ms, busy "
          f"{graph['busy']:.1%} vs {eager['busy']:.1%}, host launch calls "
          f"{graph['calls']} vs {eager['calls']}; the traced kernel time "
          f"over the median untraced request (detect total, 3 requests "
          f"each) {graph['kernel_ms'] / plain['graph']:.1%} of "
          f"{plain['graph']:.2f} ms vs {eager['kernel_ms'] / plain['eager']:.1%}"
          f" of {plain['eager']:.2f} ms; raster_images kernels of the replay "
          f"{ran['raster_images']} (captured {want['raster_images']})")
    sis = cem.SequentialImportanceSampling(det, CEMConfig())
    sis._force_loop = True
    events = traced(profiling, lambda: sis.detect(
        cloud, generator=seeded(torch, 0), verbose=False),
        os.path.join(tmp, "cem"))
    read_trace(events, ("cem_rounds", "cem_scoring", "select_and_cluster"),
               "15-channel CEM request, loop route", 5)
    # The fused route's key is captured before the trace, so the traced
    # request is one replay.
    sis._force_loop = False
    sis.detect(cloud, generator=seeded(torch, 0), verbose=False)
    events = traced(profiling, lambda: sis.detect(
        cloud, generator=seeded(torch, 0), verbose=False),
        os.path.join(tmp, "cem_fused"))
    read_trace(events, ("cem_program", "cem_rounds", "cem_scoring"),
               "15-channel CEM request, fused route (R and S replayed)", 5)
    ran = span_launches(events, "cem_program")
    want = captured_launches(*sis.graphs.values())
    graphs = graph_launches(events, "cem_program")
    print(f"profiler, fused CEM replay: kernel launches run {ran}, its "
          f"captures recorded {want}; graph launches {graphs}")
    if ran != want or graphs != 2:
        fail(f"the traced fused replay ran {ran} from {graphs} graph "
             f"launches, its captures recorded {want} in 2 graphs")


def classify_times(torch, lenet, net):
    """LeNet scores (lenet.score, the classify stage) of 512 and 4096
    random 15-channel images at bf16 (the card's default) and f32, by
    cuda_ms."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    parts = []
    for G in (512, 4096):
        x = torch.randint(0, 256, (G, 60, 60, 15), generator=gen,
                          device="cuda", dtype=torch.uint8)
        for dtype in (torch.bfloat16, torch.float32):
            ms = cuda_ms(torch, lambda a: lenet.score(net, a, dtype), (x,))
            parts.append(f"G={G} {str(dtype)[6:]} {ms:.4f} ms")
    print("classify (lenet.score, packaged 15-channel weights): " +
          ", ".join(parts))


def moved(torch, x, device):
    """A tensor, None, or a dataclass of tensors (CloudArrays, Grasps) on
    ``device``."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    return type(x)(**{k: moved(torch, v, device) for k, v in vars(x).items()})


def datagen_units(torch, syn, det, CloudArrays):
    """The data-generation work list: DATAGEN_OBJECTS objects of the
    synthetic zoo (fixed seed), each whole object's points and normals as
    its mesh cloud, and DATAGEN_VIEWS render_view views per object from
    view_cameras, preprocessed on the card with their camera as view point
    into the serving capacity buckets (as the generate_data CLI does: the
    1000 samples are drawn without replacement from the padded slots)."""
    rng = np.random.default_rng(DATAGEN_SEED)
    units = []
    for name, mpts, mnrm in syn.object_zoo(DATAGEN_OBJECTS, seed=DATAGEN_SEED):
        mesh = CloudArrays.from_numpy(mpts, normals=mnrm, device="cuda")
        for v, cam in enumerate(syn.view_cameras(rng, DATAGEN_VIEWS)):
            view = det.preprocess_cloud(syn.render_view(rng, mpts, mnrm, cam),
                                        view_points=cam[None],
                                        capacity="serve")
            units.append((name, v, view, mesh))
    return units


def datagen_span(torch, img, datagen, syn, det, CloudArrays):
    """Data generation over views in several capacity buckets: DATAGEN_SCENES
    make_scene table scenes (3 objects; 3000 and 9000 table points), each
    whole scene surface as mesh cloud, DATAGEN_SCENE_VIEWS
    render_view_occluded views each from view_cameras, preprocessed into
    the serving buckets, on the detector of the 15-channel phase (its keys
    of the zoo views kept), by datagen_turns. Prints each view's capacity
    and live pair, the keys by part, the pool's bytes, and the one images
    buffer's. Fails unless every B key with images writes into that
    buffer and adds less than its bytes to the pool."""
    rng = np.random.default_rng(DATAGEN_SEED + 1)
    units = []
    for s, table in enumerate((3000, 9000)[:DATAGEN_SCENES]):
        pts, nrm = syn.make_scene(rng, n_objects=3, table_points=table)
        mesh = CloudArrays.from_numpy(pts, normals=nrm, device="cuda")
        for v, cam in enumerate(syn.view_cameras(rng, DATAGEN_SCENE_VIEWS)):
            view = det.preprocess_cloud(
                syn.render_view_occluded(rng, pts, nrm, cam),
                view_points=cam[None], capacity="serve")
            units.append((f"scene_{s:03d}", v, view, mesh))
    gen = datagen.DataGenerator(det, datagen.DataGenConfig())
    reset_counts()
    passes = datagen_turns(torch, img, datagen, gen, units,
                           "data generation, 15 channels, scene views",
                           "raster_images")
    for u, (name, v, view, _) in enumerate(units):
        g = passes["graph"][0][u]
        print(f"generate_view {name} view {v}: {int(view.mask.sum())} points "
              f"(capacity {view.capacity}), attempts "
              f"{g['counts']['attempts']}, B keys "
              f"{[key_label(k) for k in g['keys'] if k[0] == 'score']}, "
              f"instances kept {len(g['labels'])}")
    parts = {}
    for k in det.graphs:
        parts[k[0]] = parts.get(k[0], 0) + 1
    bs = [e for k, e in det.graphs.items()
          if k[0] == "score" and k[-1] == "images"]
    bufs = list(det._images.values())
    nbytes = sum(b.nbytes for b in bufs)
    print(f"data generation over capacity buckets "
          f"{sorted({u[2].capacity for u in units})} (scenes) and the zoo "
          f"views': the detector's keys by part {parts}, of them {len(bs)} "
          f"B keys with images; pool "
          f"{sum(e.pool_bytes for e in det.graphs.values())} bytes over {len(det.graphs)} graphs (B keys with images: "
          f"{sum(e.pool_bytes for e in bs)}); images buffers {len(bufs)}, "
          f"{nbytes} bytes")
    if len(bufs) != 1 or any(e.out[1].data_ptr() != bufs[0].data_ptr()
                             or e.pool_bytes >= nbytes for e in bs):
        fail("a data-generation B key keeps its images in the pool")


def key_label(key):
    """A short name of a graph key of the data-generation programs: A by
    the view's capacity, B by its live (chunk, block) ends, R by the hand
    and mesh capacities."""
    if key[0] == "candidates":
        return f"A cap {key[2]}"
    if key[0] == "score":
        return f"B cap {key[2]} live ({key[8]}, {key[9]})"
    if key[0] == "relabel":
        return f"R hands {key[2]} mesh {key[3]}"
    return key[0]


def datagen_pass(torch, img, datagen, gen, units, eager):
    """generate_view on every unit by one route, the graph route (the
    default) or the eager attempt (``eager``: _force_eager), each unit from
    its view_generator and the pass's balancing rng from DATAGEN_SEED. Per
    unit: images, labels, host ms to the kept rows on the host,
    last_counts, kernel wrapper calls and the graph keys it replayed."""
    det = gen.detector
    rng = np.random.default_rng(DATAGEN_SEED)
    out = []
    det._force_eager = eager
    try:
        for name, v, view, mesh in units:
            before = sum(counts().values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images, labels = gen.generate_view(
                view, mesh, datagen.view_generator(DATAGEN_SEED, name, v,
                                                   "cuda"), rng)
            ms = (time.perf_counter() - t0) * 1e3
            out.append(dict(images=images, labels=labels, ms=ms,
                            counts=dict(gen.last_counts),
                            calls=sum(counts().values()) - before,
                            keys=list(det.last_graphs)))
    finally:
        det._force_eager = False
    return out


def replayed_launches(det, keys, family):
    """The ``family`` kernels that replays of ``keys`` ran: each replay
    runs the launches its capture recorded."""
    return sum(captured_launches(det.graphs[k])[family] for k in keys)


def datagen_turns(torch, img, datagen, gen, units, label, family):
    """The data-generation phase of ``units`` by route: a warm pass by the
    graph route (each new key's capture ms and pool bytes, the pass's ms),
    then the graph route and the eager attempt in turns, a pass each
    (graph, eager, eager, graph). Fails unless a later pass captures
    nothing, a graph pass calls no kernel wrapper, every graph pass finds
    the eager route's labels and counts on every unit and its images within
    the repo's gate (under 0.5% of pixels more than one step apart), and
    the graph replays of every view ran ``family`` kernels. Returns the
    passes by route."""
    det = gen.detector
    n0 = len(det.graphs)
    t0 = time.perf_counter()
    datagen_pass(torch, img, datagen, gen, units, eager=False)
    warm_ms = (time.perf_counter() - t0) * 1e3
    new = list(det.graphs)[n0:]
    n1 = len(det.graphs)
    print(f"{label}: warm pass (graph route) {warm_ms:.2f} ms over "
          f"{len(units)} views, {len(new)} keys captured (warm-up + capture "
          f"ms, pool bytes added): " + ", ".join(
              f"{key_label(k)} {det.graphs[k].capture_s * 1e3:.2f} "
              f"(+{det.graphs[k].pool_bytes})" for k in new) +
          f"; the detector's pool "
          f"{sum(e.pool_bytes for e in det.graphs.values())} bytes over "
          f"{len(det.graphs)} graphs")
    passes = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        passes[route].append(datagen_pass(torch, img, datagen, gen, units,
                                          eager=route == "eager"))
    later = len(det.graphs) - n1
    eager = passes["eager"][0]
    gaps, same_graph = [], []
    for run in passes["graph"]:
        for u, (g, e) in enumerate(zip(run, eager)):
            if g["counts"] != e["counts"] or not np.array_equal(
                    g["labels"], e["labels"]):
                fail(f"{label}: unit {u}'s graph route found {g['counts']} "
                     f"and other labels than the eager route's "
                     f"{e['counts']}")
            if g["calls"]:
                fail(f"{label}: a graph pass called a kernel wrapper "
                     f"{g['calls']} times: it ran eagerly")
            if replayed_launches(det, g["keys"], family) < 1:
                fail(f"{label}: unit {u}'s graph replays ran no {family}")
            diff = np.abs(g["images"].astype(np.int32)
                          - e["images"].astype(np.int32))
            gaps.append(float((diff > 1).mean()))
            if gaps[-1] >= 5e-3:
                fail(f"{label}: unit {u}'s graph images leave the image "
                     f"gate ({gaps[-1]:.2e} of pixels)")
    for u, (a, b) in enumerate(zip(*passes["graph"])):
        same_graph.append(float((a["images"] != b["images"]).mean()))
    if later:
        fail(f"{label}: the passes after the warm pass captured {later} "
             f"graphs")
    rates = {}
    for route, runs in passes.items():
        rates[route] = [(sum(x["ms"] for x in run) / len(run),
                         sum(len(x["labels"]) for x in run)
                         / sum(x["ms"] for x in run) * 1e3) for run in runs]
    print(f"{label}: ms/view in turns graph "
          f"{[round(r[0], 2) for r in rates['graph']]}, eager "
          f"{[round(r[0], 2) for r in rates['eager']]}; instances/s graph "
          f"{[round(r[1], 1) for r in rates['graph']]}, eager "
          f"{[round(r[1], 1) for r in rates['eager']]}; keys captured after "
          f"the warm pass {later}; labels equal on every unit; graph vs "
          f"eager images, share of pixels more than one step apart: max "
          f"{max(gaps):.2e}; graph vs graph, share of image bytes that "
          f"differ: max {max(same_graph):.2e}")
    return passes


def datagen_path(torch, img, datagen, units, det):
    """Data generation at the default DataGenConfig on every unit
    (datagen_turns), its per-view lines (attempts, candidates, positives,
    instances kept, ms by route in turns, the raster_images launches that
    the captures of the keys its replays ran recorded, and the eager
    route's wrapper calls), peak memory. Returns
    (per-unit (images, labels) of the first graph pass, the phase's
    wrapper calls, per-view raster_images of the eager and the graph
    route)."""
    gen = datagen.DataGenerator(det, datagen.DataGenConfig())
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    passes = datagen_turns(torch, img, datagen, gen, units,
                           "data generation, 15 channels", "raster_images")
    launches = counts()
    graph, eager = passes["graph"][0], passes["eager"][0]
    per_view = [e["calls"] for e in eager]
    per_view_graph = [replayed_launches(det, g["keys"], "raster_images")
                      for g in graph]
    for u, unit in enumerate(units):
        c, n = graph[u]["counts"], len(graph[u]["labels"])
        print(f"generate_view {unit[0]} view {unit[1]}: "
              f"{int(unit[2].mask.sum())} points, attempts {c['attempts']}, "
              f"candidates {c['candidates']}, positives {c['positives']}, "
              f"instances kept {n} ({int(graph[u]['labels'].sum())} "
              f"positive), ms in turns graph "
              f"{[round(r[u]['ms'], 2) for r in passes['graph']]}, eager "
              f"{[round(r[u]['ms'], 2) for r in passes['eager']]}; "
              f"raster_images recorded by the captures of the keys its "
              f"graph replays ran {per_view_graph[u]} (not traced), eager "
              f"wrapper calls {per_view[u]}")
        if graph[u]["images"].shape != (n, 60, 60, 15):
            fail(f"generate_view gave images {graph[u]['images'].shape}")
    print(f"data generation: {len(units)} views, "
          f"{sum(len(g['labels']) for g in graph)} instances a pass; "
          f"wrapper calls of the phase {launches} (the warm pass's warm-ups "
          f"and captures, two eager passes); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return ([(g["images"], g["labels"]) for g in graph], launches, per_view,
            per_view_graph)


def datagen_3ch(torch, img, datagen, GraspDetector, DetectorConfig,
                ImageGeometry, unit):
    """One unit by a 3-channel detector at the packaged 3-channel weights,
    by datagen_turns: its B runs raster_sums inside a graph. Returns the
    phase's wrapper calls, the raster_sums launches that the captures of
    the keys the view replayed recorded, and the detector (phase 11 traces
    one of its graph views)."""
    det3 = GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3)), device="cuda")
    gen = datagen.DataGenerator(det3, datagen.DataGenConfig())
    reset_counts()
    passes = datagen_turns(torch, img, datagen, gen, [unit],
                           f"data generation, 3 channels ({unit[0]} view "
                           f"{unit[1]})", "raster_sums")
    g = passes["graph"][0][0]
    replayed = replayed_launches(det3, g["keys"], "raster_sums")
    print(f"data generation, 3 channels: {len(g['labels'])} instances, "
          f"images {g['images'].shape}; raster_sums recorded by the "
          f"captures of the keys the graph view replayed {replayed} (not "
          f"traced here; phase 11 traces it), eager wrapper calls "
          f"{passes['eager'][0][0]['calls']}")
    if g["images"].shape[1:] != (60, 60, 3):
        fail(f"3-channel generate_view gave images {g['images'].shape}")
    return counts(), replayed, det3


def relabel_check_eager(torch, detector, cand, datagen, det, unit):
    """One eager attempt's candidates of ``unit`` on the card (detect_core),
    relabeled by reevaluate_hypotheses eagerly on the card and on the CPU
    (the plain route): label agreement over the valid hands, at least
    99%."""
    name, v, view, mesh = unit
    cfg = det.effective_config(view)
    g = datagen.view_generator(DATAGEN_SEED, name, v, "cuda")
    spos, smask = det.sample_cloud(view, g)
    grasps, _ = detector.detect_core(view, spos, smask, det.net, g, cfg,
                                     det.image_cap(spos.shape[0]),
                                     scores_only=True)
    card, _ = cand.reevaluate_hypotheses(mesh, grasps, cfg)
    cpu, _ = cand.reevaluate_hypotheses(moved(torch, mesh, "cpu"),
                                        moved(torch, grasps, "cpu"), cfg)
    valid = grasps.valid.cpu()
    agree = float((card.cpu() == cpu)[valid].float().mean())
    print(f"relabel check, eager ({name} view {v}): {int(valid.sum())} "
          f"hands, {int(card.sum())} positive on the card, {int(cpu.sum())} "
          f"on the CPU, label agreement {agree:.2%}")
    if agree < 0.99:
        fail(f"card and CPU relabeling agree on {agree:.2%} of the hands")


def datagen_breakdown_eager(torch, detector, cand, datagen, det, unit):
    """One eager attempt of generate_view on ``unit``, its steps timed
    apart on the host clock with a device wait after each: candidates and
    images (sample_cloud + detect_core), relabeling, the valid labels to
    the host and the balancing, and the kept rows' images to the host
    (what generate_view moves; the whole valid prefix, which it does not,
    is timed last for comparison)."""
    name, v, view, mesh = unit
    cfg = det.effective_config(view)
    g = datagen.view_generator(DATAGEN_SEED, name, v, "cuda")
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    spos, smask = det.sample_cloud(view, g)
    grasps, images = detector.detect_core(view, spos, smask, det.net, g, cfg,
                                          det.image_cap(spos.shape[0]))
    n = int(grasps.valid.sum())
    t.append(time.perf_counter())
    labels, _ = cand.reevaluate_hypotheses(mesh, grasps, cfg)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    labels = labels[:n].cpu().numpy()
    rng = np.random.default_rng(0)
    keep = rng.permutation(datagen.balance_instances(
        500, np.nonzero(labels == 1)[0], np.nonzero(labels == 0)[0], rng))
    t.append(time.perf_counter())
    kept = images[torch.from_numpy(keep).cuda()].cpu().numpy()
    t.append(time.perf_counter())
    prefix = images[:n].cpu().numpy()
    t.append(time.perf_counter())
    ms = np.diff(t) * 1e3
    print(f"generate_view breakdown, eager steps ({name} view {v}, one "
          f"attempt, ms): candidates + images {ms[0]:.2f} ({n} valid of "
          f"{grasps.capacity} hands), relabel {ms[1]:.2f} "
          f"({-(-grasps.capacity // 512)} blocks of 512), labels to host + "
          f"balance {ms[2]:.2f}, kept rows to host {ms[3]:.2f} ({len(kept)} "
          f"rows, {kept.nbytes / 1e6:.1f} MB); the whole valid prefix would "
          f"take {ms[4]:.2f} ({prefix.nbytes / 1e6:.1f} MB)")


def profile_offline(torch, profiling, datagen, det, unit, tmp,
                    family="raster_images", label="15 channels", gen=None,
                    seed=DATAGEN_SEED):
    """One generate_view of seen keys by each route under
    profiling.maybe_trace, in a span read by read_trace: the graph route
    (its replays must run the ``family`` kernels their captures recorded,
    and capture nothing) and the eager attempt, side by side; by ``gen``
    (a DataGenerator of ``det``, by default at the default DataGenConfig)
    from the unit's view_generator of ``seed``. Returns the ``family``
    kernels the traced graph view ran."""
    name, v, view, mesh = unit
    gen = gen or datagen.DataGenerator(det, datagen.DataGenConfig())
    tmp = os.path.join(tmp, f"datagen_{family}")

    def one_view():
        with profiling.span("generate_view"):
            gen.generate_view(view, mesh, datagen.view_generator(
                seed, name, v, "cuda"), np.random.default_rng(0))
            torch.cuda.synchronize()
    n = len(det.graphs)
    events = traced(profiling, one_view, os.path.join(tmp, "graph"))
    ran = span_launches(events, "generate_view")[family]
    want = replayed_launches(det, det.last_graphs, family)
    graph = read_trace(events, ("generate_view",),
                       f"generate_view (one view, {label}), graph route", 5)
    det._force_eager = True
    try:
        eager = read_trace(traced(profiling, one_view,
                                  os.path.join(tmp, "eager")),
                           ("generate_view",),
                           f"generate_view (one view, {label}), eager route",
                           5)
    finally:
        det._force_eager = False
    print(f"generate_view traced by route ({label}, {name} view {v}): "
          f"kernel time "
          f"graph {graph['kernel_ms']:.2f} vs eager {eager['kernel_ms']:.2f}"
          f" ms ({graph['kernel_ms'] / eager['kernel_ms'] - 1:+.2%}), busy "
          f"{graph['busy']:.1%} vs {eager['busy']:.1%}, host launch calls "
          f"{graph['calls']} vs {eager['calls']}, window "
          f"{graph['window_ms']:.2f} vs {eager['window_ms']:.2f} ms; "
          f"{family} kernels run by the graph view {ran} (its replays' "
          f"captures recorded {want})")
    if len(det.graphs) != n:
        fail(f"a traced generate_view ({label}) of seen keys captured a "
             f"graph")
    if ran != want or ran < 1:
        fail(f"a traced graph generate_view ({label}) ran {ran} {family}, "
             f"its captures recorded {want}")
    return ran


def training_routes(torch, profiling, train, lenet, params, data, tmp):
    """Training steps by route, batch 64, f32, on the first 1280 generated
    instances (20 batches): StepGraphs.train_step (one CUDA graph, its
    capture's warm-up the first step) and the eager train_step. First 20
    steps of each from ``params`` under deterministic cuDNN: the losses and
    parameters must agree within 1e-6 (of each tensor's largest entry).
    Then, under cuDNN's defaults, 20 steps a pass in turns (graph, eager,
    eager, graph; ms a step by CUDA events), and one traced pass of each
    route (read_trace of its train_steps span: busy share, host launch
    calls, kernel time)."""
    x = torch.from_numpy(np.concatenate([d[0] for d in data])[:1280]).cuda()
    y = torch.from_numpy(np.concatenate([d[1] for d in data])[:1280]).cuda()
    batches = [(x[i:i + 64], y[i:i + 64].long()) for i in range(0, 1280, 64)]
    routes = {}
    for route in ("graph", "eager"):
        net = lenet.params_from_numpy(params, "cuda")
        opt = train.make_optimizer(net)
        graphs = train.StepGraphs("cuda")
        routes[route] = (net, opt, graphs.train_step if route == "graph"
                         else train.train_step, graphs)

    def run(route, events=None):
        net, opt, step, _ = routes[route]
        out = []
        for bx, by in batches:
            out.append(step(net, opt, bx, by))
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        return out
    torch.backends.cudnn.deterministic = True
    try:
        losses = {r: [float(l) for l, _ in run(r)] for r in routes}
    finally:
        torch.backends.cudnn.deterministic = False
    trained = {r: lenet.params_to_numpy(routes[r][0]) for r in routes}
    loss_gap = float(np.abs(np.subtract(*losses.values())).max())
    param_gap = max(float(np.abs(trained["graph"][k] - trained["eager"][k])
                          .max() / np.abs(trained["eager"][k]).max())
                    for k in trained["eager"])
    if not (loss_gap <= 1e-6 and param_gap <= 1e-6):
        fail(f"20 graph steps leave 20 eager steps: loss gap {loss_gap:.2e},"
             f" parameter gap {param_gap:.2e}")
    ms = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        events = []
        run(route, events)
        torch.cuda.synchronize()
        ms[route].append(round(float(np.median(
            [a.elapsed_time(b) for a, b in zip(events, events[1:])])), 4))
    traces = {}
    for route in routes:
        def steps(route=route):
            with profiling.span("train_steps"):
                run(route)
                torch.cuda.synchronize()
        traces[route] = read_trace(
            traced(profiling, steps, os.path.join(tmp, f"train_{route}")),
            ("train_steps",), f"20 training steps, {route} route", 5)
    graphs = routes["graph"][3].graphs
    (entry,) = graphs.values()
    print(f"training by route: 20 steps of each from the same parameters "
          f"under deterministic cuDNN: loss gap {loss_gap:.2e}, parameter "
          f"gap {param_gap:.2e} of each tensor's largest entry; the step's "
          f"capture (its warm-up the first step) {entry.capture_s * 1e3:.2f} "
          f"ms, pool {entry.pool_bytes} bytes; median ms/step in turns: "
          f"graph {ms['graph']}, eager {ms['eager']}; traced 20 steps: "
          f"host launch calls {traces['graph']['calls']} vs "
          f"{traces['eager']['calls']} ({traces['graph']['calls'] / 20:.2f} "
          f"vs {traces['eager']['calls'] / 20:.2f} a step), busy "
          f"{traces['graph']['busy']:.1%} vs {traces['eager']['busy']:.1%}, "
          f"kernel time {traces['graph']['kernel_ms']:.2f} vs "
          f"{traces['eager']['kernel_ms']:.2f} ms, window "
          f"{traces['graph']['window_ms']:.2f} vs "
          f"{traces['eager']['window_ms']:.2f} ms")


class Blocks:
    """An in-memory dataset for net.train: one block."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels.astype(np.int32)

    def blocks(self):
        yield self.images, self.labels


def training_path(torch, lenet, train, data, units):
    """A LeNet from init_params(seed 0) trained on the card through
    train.fit on views 0-1 of every object (batch 64, lr 1e-3, wd 5e-4,
    two epochs, from memory): median ms per step (CUDA events between
    steps), the mean loss of the first and last 100 steps (of each half
    when there are fewer than 200; it must fall),
    and accuracy on the held-out views (view 2, the padded tail weighted
    out). Then one step from the same parameters and batch on the card and
    on the CPU, and their gaps. Returns the trained parameters."""
    held = [i for i, u in enumerate(units) if u[1] == DATAGEN_VIEWS - 1]
    fit_on = [i for i in range(len(units)) if i not in held]

    def blocks(idx):
        return Blocks(np.concatenate([data[i][0] for i in idx]),
                      np.concatenate([data[i][1] for i in idx]))
    train_set, held_set = blocks(fit_on), blocks(held)
    losses, events = [], []

    def on_step(step, loss, acc):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = train.fit(train_set, None, 15, epochs=2, batch_size=64, lr=1e-3,
                       weight_decay=5e-4, seed=0, device="cuda",
                       on_step=on_step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    steps = np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    loss = torch.stack(losses).cpu().numpy()
    w = min(100, len(loss) // 2)
    first, last = float(loss[:w].mean()), float(loss[-w:].mean())
    net = lenet.params_from_numpy(params, "cuda")
    held_loss, held_acc = train.evaluate(net, held_set)
    print(f"training (fit, each step a CUDA graph replay): "
          f"{len(train_set.labels)} instances, {len(loss)} steps "
          f"of 64 in {total:.3f} s, median {np.median(steps):.3f} ms/step "
          f"(p90 {np.percentile(steps, 90):.3f}); mean loss of the first "
          f"{w} steps {first:.4f}, of the last {w} {last:.4f}; held-out views "
          f"({len(held_set.labels)} instances): loss {held_loss:.4f}, "
          f"accuracy {held_acc:.4f}")
    if not last < first:
        fail("the training loss did not fall")

    p0 = lenet.init_params(torch.Generator().manual_seed(1), 15)
    x = torch.from_numpy(train_set.images[:64])
    y = torch.from_numpy(train_set.labels[:64].astype(np.int64))
    ref = float64_grads(torch, p0, x, y)
    stepped = {}
    for device in ("cuda", "cpu"):
        net = lenet.params_from_numpy(p0, device)
        loss, _ = train.train_step(net, train.make_optimizer(net),
                                   x.to(device), y.to(device))
        grads = dict(zip(p0, (v.grad.cpu().double()
                              for v in net.parameters())))
        gaps = {k: float((grads[k] - ref[k]).abs().max() /
                         ref[k].abs().max()) for k in p0}
        worst = max(gaps, key=gaps.get)
        stepped[device] = (float(loss), grads, lenet.params_to_numpy(net))
        print(f"one step on the {device}: loss {float(loss):.6f}; gradients "
              f"against float64, relative to each tensor's largest entry: "
              f"worst {worst} {gaps[worst]:.2e}, the others <= "
              f"{max(v for k, v in gaps.items() if k != worst):.2e}")
    (lc, gc, pc), (lh, gh, ph) = stepped["cuda"], stepped["cpu"]
    g_gap = max(float((gc[k] - gh[k]).abs().max() / gh[k].abs().max())
                for k in gh)
    p_gap = max(float(np.abs(pc[k] - ph[k]).max()) for k in ph)
    print(f"one step card vs CPU (same parameters and batch): max gradient "
          f"gap {g_gap:.2e} of each tensor's largest, max parameter gap "
          f"{p_gap:.2e} (Adam's first step is lr * g / (|g| + eps): 1e-3 "
          f"where a tiny gradient flips sign)")
    if not np.isfinite([lc, lh, g_gap, p_gap]).all():
        fail("the card-vs-CPU training step is not finite")
    return params


def float64_grads(torch, params, x, y):
    """Gradients of the mean cross-entropy of the LeNet at ``params`` on
    one batch, in float64 on the CPU: the reference of the card's and the
    CPU's float32 step."""
    F = torch.nn.functional
    P = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in params.items()}
    h = x.permute(0, 3, 1, 2).double() / 256
    for c in ("conv1", "conv2"):
        h = F.max_pool2d(F.relu(F.conv2d(h, P[c + "_w"], P[c + "_b"])), 2)
    h = F.relu(F.linear(h.flatten(1), P["fc1_w"], P["fc1_b"]))
    F.cross_entropy(F.linear(h, P["fc2_w"], P["fc2_b"]), y).backward()
    return {k: v.grad for k, v in P.items()}


def geometry_rows(g):
    """The valid (position, orientation, width) rows of a Grasps batch,
    sorted."""
    h = g.to_host()
    v = h.valid
    rows = np.concatenate([h.position[v], h.orientation[v].reshape(-1, 9),
                           h.width[v, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def host_ms(torch, fn):
    """(result, host milliseconds of fn() ending in a device sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def turns(torch, img, det, requests, order):
    """requests[route]() in ``order``, each timed on the host to a device
    sync, the detector's _force_eager set for the route "eager" only:
    {route: [(ms, result, kernel wrapper calls by kernel)]}."""
    res = {route: [] for route in requests}
    for route in order:
        det._force_eager = route == "eager"
        before = counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = requests[route]()
            torch.cuda.synchronize()
        finally:
            det._force_eager = False
        res[route].append((round((time.perf_counter() - t0) * 1e3, 2), out,
                           {k: v - before[k] for k, v in counts().items()}))
    return res


def traced_span(torch, profiling, fn, d, label, det, eager=False):
    """fn() traced inside a span of its own ("traced_call") that ends in a
    device sync, by the detector's graph routes or (``eager``) its eager
    routes: read_trace's numbers of the span, the raster kernels launched
    inside it by family (span_launches), and those the captures of the keys
    it replayed recorded."""
    def run():
        with profiling.span("traced_call"):
            fn()
            torch.cuda.synchronize()
    det.programs.last_graphs, det._force_eager = [], eager
    try:
        events = traced(profiling, run, d)
    finally:
        det._force_eager = False
    want = captured_launches(*(det.graphs[k] for k in det.last_graphs))
    return (read_trace(events, ("traced_call",), label, 0),
            span_launches(events, "traced_call"), want)


def all_kernels(ran):
    """span_launches' families as launches per kernel (raster_sums2's
    kernels are raster_sums' and count there)."""
    return {k: ran.get(k, 0) for k in KERNELS}


def sharded_by_route(torch, img, profiling, det, detector, sharded, mesh,
                     cloud, d):
    """detect_sharded_raw (on detect_core's samples of seed 0) and
    sharded_detect_host (seed 0) by their graph route (the detector as
    owner: its programs, replayed from CUDA graphs) and their eager route
    (no owner; _force_eager for sharded_detect_host): each call's first
    request apart (what it captured, each capture's ms and pool bytes),
    then graph, eager and the unsharded call (detect_core; detect) in turns
    (graph, eager, unsharded, unsharded, eager, graph), then one traced
    request by each route (busy share, host launch calls, kernel time).
    Fails unless a later
    request captures nothing and no graph request calls a kernel wrapper,
    every detect_sharded_raw batch holds detect_core's valid geometry
    (same count, 1e-5), every graph selection shares >= 90% of the eager
    route's by position with finite scores, the traced detect_sharded_raw
    replay takes fewer than 100 host launch calls, and each traced replay
    runs the raster_images kernels its keys' captures recorded. Returns
    each route's launches (the graph route's from its trace)."""
    cfg = det.effective_config(cloud)
    spos, smask = det.sample_cloud(cloud, seeded(torch, 0))
    s_l, m_l = sharded.shard_samples(mesh, spos, smask)
    cap = det.image_cap(s_l.shape[0])
    def detect_core():
        return detector.detect_core(cloud, spos, smask, det.net,
                                    seeded(torch, 0), cfg, cap,
                                    scores_only=True)[0]
    core = geometry_rows(detect_core())
    unsharded = {"detect_sharded_raw": ("detect_core", detect_core),
                 "sharded_detect_host": ("detect", lambda: det.detect(
                     cloud, generator=seeded(torch, 0), verbose=False))}
    calls = {
        "detect_sharded_raw": lambda: sharded.detect_sharded_raw(
            sharded.replicate(mesh, cloud), s_l, m_l,
            sharded.replicate(mesh, det.net), seeded(torch, 0), cfg, cap,
            mesh, owner=None if det._force_eager else det),
        "sharded_detect_host": lambda: sharded.sharded_detect_host(
            det, cloud, generator=seeded(torch, 0), mesh=mesh)}
    by_path = {}
    for name, fn in calls.items():
        n_graphs = len(det.graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first = graph_keys_line(det, n_graphs, time.perf_counter() - t0)
        turns(torch, img, det, {"eager": fn}, ("eager",))   # warm-up
        n_graphs = len(det.graphs)
        res = turns(torch, img, det, {"graph": fn, "eager": fn,
                                      "unsharded": unsharded[name][1]},
                    ("graph", "eager", "unsharded", "unsharded", "eager",
                     "graph"))
        graph, ran, want = traced_span(torch, profiling, fn,
                                       f"{d}/{name}_graph",
                                       f"{name}, graph replay", det)
        eager, ran_e, _ = traced_span(torch, profiling, fn,
                                      f"{d}/{name}_eager",
                                      f"{name}, eager request", det, True)
        if len(det.graphs) != n_graphs:
            fail(f"{name}: a request of seen keys captured a graph")
        if any(sum(c.values()) for _, _, c in res["graph"]):
            fail(f"{name}: a graph request called a kernel wrapper: it ran "
                 f"eagerly")
        if ran != want or ran["raster_images"] < 1:
            fail(f"{name}: a traced replay ran {ran}, its captures "
                 f"recorded {want}")
        outs = {r: [o for _, o, _ in res[r]] for r in res}
        if name == "detect_sharded_raw":
            gaps = []
            for o in outs["graph"] + outs["eager"]:
                rows = geometry_rows(o)
                gaps.append(float(np.abs(rows - core).max())
                            if rows.shape == core.shape and len(core)
                            else None)
            if any(g is None or g > 1e-5 for g in gaps):
                fail(f"{name}: the valid geometry leaves detect_core's "
                     f"({len(core)} valid hands): gaps {gaps}")
            if graph["calls"] >= 100:
                fail(f"{name}: a traced replay took {graph['calls']} host "
                     f"launch calls")
            what = (f"{len(core)} valid hands as detect_core, max geometry "
                    f"gap {max(gaps)}")
        else:
            ref = outs["eager"][0].to_host()
            shares = [selection_share(o.to_host(), ref)
                      for o in outs["graph"]]
            for o in outs["graph"] + outs["eager"]:
                h = o.to_host()
                if not h.valid.any() or not np.isfinite(
                        h.score[h.valid]).all():
                    fail(f"{name}: selected no grasp or a non-finite score")
            if min(shares) < 0.9:
                fail(f"{name}: the graph route shares {min(shares):.1%} of "
                     f"the eager route's selection")
            what = (f"selected {int(ref.valid.sum())} grasps (graph "
                    f"{[int(o.valid.sum()) for o in outs['graph']]}), "
                    f"selection shared with the eager route's by position "
                    f"{[f'{x:.1%}' for x in shares]}")
        print(f"parallel (world 1, NCCL), {name} by route: {what}; {first}; "
              f"ms in turns: graph {[r[0] for r in res['graph']]}, eager "
              f"{[r[0] for r in res['eager']]}, {unsharded[name][0]} "
              f"{[r[0] for r in res['unsharded']]}; traced: busy "
              f"{graph['busy']:.1%} vs {eager['busy']:.1%}, host launch "
              f"calls {graph['calls']} vs {eager['calls']}, kernel time "
              f"{graph['kernel_ms']:.2f} vs {eager['kernel_ms']:.2f} ms; "
              f"raster_images run by the traced replay "
              f"{ran['raster_images']} (its keys' captures recorded "
              f"{want['raster_images']}; the traced eager request "
              f"{ran_e['raster_images']}, its wrapper calls a request "
              f"{[c['raster_images'] for _, _, c in res['eager']]})")
        by_path[f"{name}, world 1 (NCCL), graph route (a traced replay)"] = \
            all_kernels(ran)
        by_path[f"{name}, world 1 (NCCL), eager route (wrapper calls, one "
                f"request)"] = res["eager"][0][2]
    return by_path


def cem_mesh_by_route(torch, img, profiling, det, cem, CEMConfig, mesh,
                      cloud, d):
    """CEM at the default CEMConfig on one seed by three routes: the mesh
    loop through the detector's programs (CUDA graphs: each round's
    candidates, draw and scores, the selection), the eager mesh loop
    (_force_eager) and the fused route (no mesh: two CUDA graphs); the graph
    loop's first request apart (its captures), then graph, eager, fused,
    fused, eager, graph, then one traced request by each route. Fails
    unless all three find the same round counts, the two mesh loops the
    same final count, a grasp with finite scores each, no later request
    captures or (graph, fused) calls a kernel wrapper, and the traced graph
    loop runs the raster_images kernels its keys' captures recorded.
    Returns each route's launches (graph loop and fused from traces)."""
    sis = {"graph": cem.SequentialImportanceSampling(det, CEMConfig(),
                                                     mesh=mesh),
           "fused": cem.SequentialImportanceSampling(det, CEMConfig())}
    sis["eager"] = sis["graph"]          # _force_eager picks the eager loop

    def request(route):
        def run():
            s = sis[route]
            out = s.detect(cloud, generator=seeded(torch, 0), verbose=False)
            return out.to_host(), list(s.last_round_counts), s.last_num_grasps
        return run
    requests = {r: request(r) for r in ("graph", "eager", "fused")}
    n_graphs = len(det.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    requests["graph"]()
    first = graph_keys_line(det, n_graphs, time.perf_counter() - t0)
    turns(torch, img, det, requests, ("fused", "eager"))       # warm-ups
    n_graphs, n_fused = len(det.graphs), len(sis["fused"].graphs)
    res = turns(torch, img, det, requests,
                ("graph", "eager", "fused", "fused", "eager", "graph"))
    traces = {}
    for route in requests:
        traces[route] = traced_span(
            torch, profiling, requests[route], f"{d}/cem_{route}",
            f"CEM {route} request", det, route == "eager")
    want_fused = captured_launches(*cem_graphs(sis["fused"], cloud))
    rounds = {r: [o[1] for _, o, _ in res[r]] for r in res}
    finals = {r: [o[2] for _, o, _ in res[r]] for r in res}
    if len(det.graphs) != n_graphs or len(sis["fused"].graphs) != n_fused:
        fail("CEM by route: a request of seen keys captured a graph")
    for r in ("graph", "fused"):
        if any(sum(c.values()) for _, _, c in res[r]):
            fail(f"CEM by route: a {r} request called a kernel wrapper")
    if len({str(x) for r in rounds for x in rounds[r]}) != 1:
        fail(f"CEM by route: round counts differ: {rounds}")
    if len(set(finals["graph"] + finals["eager"])) != 1:
        fail(f"CEM by route: the mesh loops' final counts differ: {finals}")
    for r in res:
        for _, (h, _, n), _ in res[r]:
            if n < 1 or not np.isfinite(h.score[h.valid]).all():
                fail(f"CEM by route: the {r} route found no grasp or a "
                     f"non-finite score")
    _, ran_g, want_g = traces["graph"]
    if ran_g != want_g or ran_g["raster_images"] < 1:
        fail(f"CEM mesh loop: a traced graph request ran {ran_g}, its keys' "
             f"captures recorded {want_g}")
    if traces["fused"][1] != want_fused:
        fail(f"CEM fused: a traced replay ran {traces['fused'][1]}, its "
             f"capture recorded {want_fused}")
    share = [selection_share(o[0], res["eager"][0][1][0])
             for _, o, _ in res["graph"]]
    print(f"parallel (world 1, NCCL), CEM by route: round candidates "
          f"{rounds['graph'][0]} on all three routes; final grasps graph "
          f"loop {finals['graph']}, eager loop {finals['eager']}, fused "
          f"{finals['fused']}; the graph loop's selection shared with the "
          f"eager loop's by position {[f'{x:.1%}' for x in share]}; the "
          f"graph loop's {first}; ms in turns: graph loop "
          f"{[r[0] for r in res['graph']]}, eager loop "
          f"{[r[0] for r in res['eager']]}, fused "
          f"{[r[0] for r in res['fused']]}; traced busy graph loop "
          f"{traces['graph'][0]['busy']:.1%}, eager loop "
          f"{traces['eager'][0]['busy']:.1%}, fused "
          f"{traces['fused'][0]['busy']:.1%}; host launch calls "
          f"{traces['graph'][0]['calls']}, {traces['eager'][0]['calls']}, "
          f"{traces['fused'][0]['calls']}; kernel time "
          f"{traces['graph'][0]['kernel_ms']:.2f}, "
          f"{traces['eager'][0]['kernel_ms']:.2f}, "
          f"{traces['fused'][0]['kernel_ms']:.2f} ms; raster_images run "
          f"by the traced graph loop {ran_g['raster_images']} (its keys' "
          f"captures recorded {want_g['raster_images']}), the traced eager "
          f"loop {traces['eager'][1]['raster_images']}, the fused replay "
          f"{traces['fused'][1]['raster_images']}")
    return {"CEM mesh=, world 1 (NCCL), graph loop (a traced request)":
                all_kernels(ran_g),
            "CEM mesh=, world 1 (NCCL), eager loop (wrapper calls, one "
            "request)": res["eager"][0][2]}


def ddp_by_route(torch, profiling, train, lenet, mesh, tmp):
    """fit's data-parallel step by route at world 1 (NCCL): 40 steps of
    batch 64 (15 channels) from one start through StepGraphs (the
    DDP-wrapped LeNet: DDP_EAGER_STEPS eager steps, then one CUDA graph
    holding the step and its all-reduce) and by the eager DDP train_step,
    under deterministic cuDNN (losses and parameters within 1e-6 of each
    tensor's largest entry); then 40 steps a pass in turns (graph, eager,
    eager, graph; median ms a step by CUDA events), one traced pass of
    each (host launch calls, busy share); then the data-parallel evaluate
    (StepGraphs' eval step, the sums all-reduced) against eager eval_step
    sums over the same 640 held-out rows (loss within 1e-6, accuracy
    equal)."""
    rng = np.random.default_rng(13)
    n = 40
    x = torch.from_numpy(rng.integers(0, 256, (n * 64, 60, 60, 15),
                                      dtype=np.uint8)).cuda()
    y = torch.from_numpy(rng.integers(0, 2, n * 64)).cuda()
    hx = rng.integers(0, 256, (640, 60, 60, 15), dtype=np.uint8)
    hy = rng.integers(0, 2, 640).astype(np.int32)
    params = lenet.init_params(torch.Generator().manual_seed(0), 15)
    routes = {}
    for route in ("graph", "eager"):
        net = lenet.params_from_numpy(params, "cuda")
        opt = train.make_optimizer(net)
        steps = train.StepGraphs("cuda")
        routes[route] = (net, train.data_parallel_model(net, mesh), opt,
                         steps.train_step if route == "graph"
                         else train.train_step, steps)

    def run(route, events=None):
        _, model, opt, step, _ = routes[route]
        out = []
        for i in range(0, n * 64, 64):
            out.append(step(model, opt, x[i:i + 64], y[i:i + 64]))
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        return out
    torch.backends.cudnn.deterministic = True
    try:
        losses = {r: [float(l) for l, _ in run(r)] for r in routes}
        held = Blocks(hx, hy)
        ev_graph = train.evaluate(routes["graph"][0], held, batch_size=64,
                                  mesh=mesh)
        net = routes["graph"][0]
        sums = [0.0, 0]
        for i in range(0, 640, 64):
            s, c = train.eval_step(
                net, torch.from_numpy(hx[i:i + 64]).cuda(),
                torch.from_numpy(hy[i:i + 64].astype(np.int64)).cuda(),
                torch.ones(64, device="cuda"))
            sums[0] += float(s)
            sums[1] += int(c)
        ev_eager = (sums[0] / 640, sums[1] / 640)
    finally:
        torch.backends.cudnn.deterministic = False
    trained = {r: lenet.params_to_numpy(routes[r][0]) for r in routes}
    loss_gap = float(np.abs(np.subtract(*losses.values())).max())
    param_gap = max(float(np.abs(trained["graph"][k] - trained["eager"][k])
                          .max() / np.abs(trained["eager"][k]).max())
                    for k in trained["eager"])
    if not (loss_gap <= 1e-6 and param_gap <= 1e-6):
        fail(f"{n} graph DDP steps leave {n} eager DDP steps: loss gap "
             f"{loss_gap:.2e}, parameter gap {param_gap:.2e}")
    if abs(ev_graph[0] - ev_eager[0]) > 1e-6 or ev_graph[1] != ev_eager[1]:
        fail(f"the data-parallel evaluate {ev_graph} leaves eager eval_step "
             f"sums {ev_eager}")
    ms = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        events = []
        run(route, events)
        torch.cuda.synchronize()
        ms[route].append(round(float(np.median(
            [a.elapsed_time(b) for a, b in zip(events, events[1:])])), 4))
    traces = {}
    for route in routes:
        def steps(route=route):
            with profiling.span("train_steps"):
                run(route)
                torch.cuda.synchronize()
        traces[route] = read_trace(
            traced(profiling, steps, os.path.join(tmp, f"ddp_{route}")),
            ("train_steps",), f"{n} DDP steps, {route} route", 5)
    (entry,) = routes["graph"][4].graphs.values()
    print(f"parallel (world 1, NCCL {torch.cuda.nccl.version()}), DDP by "
          f"route: {n} steps of each from the same parameters under "
          f"deterministic cuDNN ({train.DDP_EAGER_STEPS} eager steps "
          f"before the capture): loss gap {loss_gap:.2e}, parameter gap "
          f"{param_gap:.2e} of each tensor's largest entry; the step's "
          f"capture {entry.capture_s * 1e3:.2f} ms, pool {entry.pool_bytes} "
          f"bytes; median ms/step in turns: graph {ms['graph']}, eager "
          f"{ms['eager']}; traced {n} steps: host launch calls "
          f"{traces['graph']['calls']} vs {traces['eager']['calls']} "
          f"({traces['graph']['calls'] / n:.2f} vs "
          f"{traces['eager']['calls'] / n:.2f} a step), busy "
          f"{traces['graph']['busy']:.1%} vs {traces['eager']['busy']:.1%}, "
          f"kernel time {traces['graph']['kernel_ms']:.2f} vs "
          f"{traces['eager']['kernel_ms']:.2f} ms; data-parallel evaluate "
          f"(graph) loss {ev_graph[0]:.6f} accuracy {ev_graph[1]:.4f}, "
          f"eager eval_step sums {ev_eager[0]:.6f} {ev_eager[1]:.4f}")


def parallel_path(torch, img, profiling, syn, det, detector, cem, CEMConfig,
                  lenet, train, tmp):
    """parallel/ on a world of one: an NCCL group over a file store on this
    card (NCCL refuses two ranks on one card). On scene 0 at the default
    DetectorConfig: detect_sharded_raw and sharded_detect_host by route
    (sharded_by_route), CEM with mesh= by route against the fused route at
    the default CEMConfig (cem_mesh_by_route), then 40 training steps by
    fit with DistributedDataParallel against 40 plain steps from the same
    start and batches (every tensor within 1e-6 of its largest entry), and
    the data-parallel step by route (ddp_by_route). Returns each sharded
    path's launch counts."""
    import torch.distributed as dist
    from gpd_tpu_torch.parallel import multihost, sharded
    device = multihost.initialize(f"file://{tmp}/nccl_store", 1, 0)
    if dist.get_backend() != "nccl" or device.type != "cuda":
        fail(f"the process group runs {dist.get_backend()} on {device}")
    mesh = sharded.default_mesh()
    try:
        p, cs, vp = scene(syn, 0)
        cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
        traces = os.path.join(tmp, "parallel_traces")
        by_path = sharded_by_route(torch, img, profiling, det, detector,
                                   sharded, mesh, cloud, traces)
        by_path.update(cem_mesh_by_route(torch, img, profiling, det, cem,
                                         CEMConfig, mesh, cloud, traces))

        rng = np.random.default_rng(12)
        data = Blocks(rng.integers(0, 256, (40 * 64, 60, 60, 15),
                                   dtype=np.uint8),
                      rng.integers(0, 2, 40 * 64))

        def gap(a, b):
            return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
                       for k in b)
        # cuDNN's default weight-gradient algorithms add in no fixed order,
        # so two plain runs differ at rounding level and Adam turns that
        # into up to 2 lr where a gradient is noise: the comparison runs
        # with deterministic cuDNN, and the default's plain-vs-plain gap is
        # printed beside it.
        fits, step_ms = {}, {}
        for deterministic, dp in ((False, False), (False, False),
                                  (True, False), (True, True), (True, True),
                                  (True, False)):
            torch.backends.cudnn.deterministic = deterministic
            events = []

            def on_step(step, loss, acc):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            reset_counts()
            try:
                params = train.fit(data, None, 15, epochs=1, batch_size=64,
                                   seed=0, device="cuda", on_step=on_step,
                                   data_parallel=dp)
            finally:
                torch.backends.cudnn.deterministic = False
            torch.cuda.synchronize()
            fits.setdefault((deterministic, dp), []).append(params)
            step_ms.setdefault((deterministic, dp), []).append(float(
                np.median([a.elapsed_time(b)
                           for a, b in zip(events, events[1:])])))
            if dp:
                by_path["fit data_parallel, world 1 (NCCL)"] = counts()
        g_dp = max(gap(d, fits[True, False][0]) for d in fits[True, True])
        print(f"parallel: 40 training steps of fit with "
              f"DistributedDataParallel (through StepGraphs: "
              f"{train.DDP_EAGER_STEPS} eager steps, then the captured "
              f"step) against 40 plain steps from the same start and "
              f"batches, deterministic cuDNN: max parameter gap "
              f"{g_dp:.2e} of each tensor's largest entry (plain vs plain "
              f"{gap(*fits[True, False]):.2e}; with cuDNN's default "
              f"algorithms plain vs plain {gap(*fits[False, False]):.2e}); "
              f"median ms/step in turns: plain {step_ms[True, False]}, DDP "
              f"{step_ms[True, True]} (default cuDNN, plain: "
              f"{step_ms[False, False]})")
        if not g_dp <= 1e-6:
            fail("DDP training steps differ from plain ones")
        ddp_by_route(torch, profiling, train, lenet, mesh, tmp)
    finally:
        dist.destroy_process_group()
    return by_path


def c_abi(ctypes):
    """The port's C ABI library, loaded with its argument types."""
    from gpd_tpu_torch.ops import _build

    class Grasp(ctypes.Structure):
        _fields_ = [("position", ctypes.c_double * 3),
                    ("orientation", ctypes.c_double * 9),
                    ("sample", ctypes.c_double * 3),
                    ("width", ctypes.c_double), ("score", ctypes.c_double),
                    ("full_antipodal", ctypes.c_int),
                    ("half_antipodal", ctypes.c_int)]
    lib = _build.load("gpd_c_api")
    P = ctypes.POINTER
    lib.gpd_last_error.restype = ctypes.c_char_p
    lib.gpd_init.argtypes = [ctypes.c_char_p]
    lib.gpd_detector_create.restype = ctypes.c_int64
    lib.gpd_detector_create.argtypes = [ctypes.c_char_p]
    lib.gpd_detector_destroy.argtypes = [ctypes.c_int64]
    lib.gpd_detect_grasps_in_cloud.argtypes = [
        ctypes.c_int64, P(ctypes.c_float), ctypes.c_int, P(ctypes.c_float),
        ctypes.c_int, P(ctypes.c_uint32), P(P(Grasp)), P(ctypes.c_int)]
    lib.gpd_calc_grasp_descriptors.argtypes = [
        ctypes.c_int64, P(ctypes.c_float), ctypes.c_int, P(ctypes.c_float),
        ctypes.c_int, P(P(Grasp)), P(P(ctypes.c_uint8)), P(ctypes.c_int),
        P(ctypes.c_int), P(ctypes.c_int)]
    lib.gpd_free.argtypes = [ctypes.c_void_p]
    return lib, Grasp


def c_abi_path(torch, img, syn, api, capi, tmp, why_not_built):
    """The port's C ABI loaded with ctypes into this process, gpd_init
    ("cuda"), a detector from a default config file: on scene 0,
    gpd_detect_grasps_in_cloud (seed 0) must return capi.detect_in_cloud's
    rows (seed 0; geometry 1e-5, scores 1e-3: the card's raster sums with
    float atomics) and gpd_calc_grasp_descriptors (G, 60, 60, 15) uint8
    images; a C request timed against capi's and api's. Returns each entry
    point's launch counts."""
    if why_not_built:
        print(f"C ABI: not built: {why_not_built}")
        return {}
    import ctypes
    lib, Grasp = c_abi(ctypes)
    if lib.gpd_init(b"cuda") != 0:
        fail(f"gpd_init: {lib.gpd_last_error().decode()}")
    cfg = os.path.join(tmp, "c_abi.cfg")
    with open(cfg, "w") as f:
        f.write("# the defaults: 15 channels, 1000 samples\n")
    h = lib.gpd_detector_create(cfg.encode())
    if h <= 0:
        fail(f"gpd_detector_create: {lib.gpd_last_error().decode()}")
    p, cs, vp = scene(syn, 0)
    p, vp = np.ascontiguousarray(p, np.float32), np.ascontiguousarray(vp)
    cs = np.ascontiguousarray(cs, np.uint32)
    fp = ctypes.POINTER(ctypes.c_float)
    by_path = {}

    def c_detect():
        out, n = ctypes.POINTER(Grasp)(), ctypes.c_int(-1)
        if lib.gpd_detect_grasps_in_cloud(
                h, p.ctypes.data_as(fp), len(p), vp.ctypes.data_as(fp),
                len(vp), cs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.byref(out), ctypes.byref(n)) != 0:
            fail(f"gpd_detect_grasps_in_cloud: "
                 f"{lib.gpd_last_error().decode()}")
        rows = np.array([list(g.position) + list(g.orientation)
                         + list(g.sample) + [g.width, g.score,
                                             g.full_antipodal,
                                             g.half_antipodal]
                         for g in out[:n.value]])
        lib.gpd_free(out)
        return rows
    hp = capi.create_detector(cfg)
    c_detect()                                               # warm-up
    c_path = ("C ABI gpd_detect_grasps_in_cloud (wrapper calls: a graph "
              "replay calls none)")
    ms = {"C ABI": [], "capi": [], "api": []}
    for name in ("C ABI", "capi", "api", "api", "capi", "C ABI"):
        reset_counts()
        if name == "C ABI":
            rows, t = host_ms(torch, c_detect)
            by_path[c_path] = counts()
        elif name == "capi":
            expect, t = host_ms(torch, lambda: capi.detect_in_cloud(
                hp, p, vp, cs, seed=0))
        else:
            _, t = host_ms(torch, lambda: api.detect_grasps_in_cloud(
                capi._detectors[hp], p, view_points=vp, cam_source=cs,
                seed=0))
        ms[name].append(t)
    ok = rows.shape == expect.shape and len(rows) > 0
    geo = float(np.abs(rows[:, :16] - expect[:, :16]).max()) if ok else None
    sc = float(np.abs(rows[:, 16] - expect[:, 16]).max()) if ok else None
    print(f"C ABI: gpd_detect_grasps_in_cloud {len(rows)} rows, "
          f"capi.detect_in_cloud {len(expect)}; max geometry gap {geo}, "
          f"score gap {sc}, identical {ok and np.array_equal(rows, expect)}; "
          f"ms in turns: C ABI {ms['C ABI']}, capi {ms['capi']}, api "
          f"(serving buckets) {ms['api']}; raster_images launches "
          f"{by_path[c_path]['raster_images']} (wrapper calls: a graph "
          f"replay calls none)")
    if not ok or geo > 1e-5 or sc > 1e-3 or not np.array_equal(
            rows[:, 17:], expect[:, 17:]):
        fail("the C ABI's rows are not capi.detect_in_cloud's")

    out, imgs = ctypes.POINTER(Grasp)(), ctypes.POINTER(ctypes.c_uint8)()
    n, size, chans = ctypes.c_int(-1), ctypes.c_int(-1), ctypes.c_int(-1)
    reset_counts()
    if lib.gpd_calc_grasp_descriptors(
            h, p.ctypes.data_as(fp), len(p), vp.ctypes.data_as(fp), len(vp),
            ctypes.byref(out), ctypes.byref(imgs), ctypes.byref(n),
            ctypes.byref(size), ctypes.byref(chans)) != 0:
        fail(f"gpd_calc_grasp_descriptors: {lib.gpd_last_error().decode()}")
    by_path["C ABI gpd_calc_grasp_descriptors"] = counts()
    shape = (n.value, size.value, size.value, chans.value)
    images = np.ctypeslib.as_array(imgs, shape=shape).copy() if n.value else \
        np.zeros(shape, np.uint8)
    lib.gpd_free(out)
    lib.gpd_free(imgs)
    lib.gpd_detector_destroy(h)
    capi.destroy_detector(hp)
    print(f"C ABI: gpd_calc_grasp_descriptors {n.value} candidates, images "
          f"{images.shape} uint8, {int(images.any(axis=(1, 2, 3)).sum())} "
          f"not blank; raster_images launches "
          f"{by_path['C ABI gpd_calc_grasp_descriptors']['raster_images']}")
    if n.value < 1 or shape[1:] != (60, 60, 15):
        fail(f"gpd_calc_grasp_descriptors gave images {shape}")
    return by_path


def grasp_image_path(torch, img, syn, pcd, test_grasp_image, viz,
                     GraspDetector, DetectorConfig, tmp):
    """The test_grasp_image app on a one-camera scene PCD on the card, at
    the first of 20 processed object points (above the table) with a valid
    hand; then viz's geometry (segments, cuboids, image-volume cube, a PLY)
    on its hands. Returns its launch counts."""
    rng = np.random.default_rng(0)
    pts, nrm = syn.make_scene(rng, n_objects=3)
    p, _, _ = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 1))
    path = os.path.join(tmp, "grasp_image_scene.pcd")
    pcd.save_pcd(path, p)
    # The app's processed cloud, for its object points' indices.
    app_det = GraspDetector(DetectorConfig(num_samples=1), device="cuda")
    cloud = app_det.preprocess_cloud(pcd.load_cloud_file(path),
                                     view_points=np.zeros((1, 3), np.float32))
    above = np.nonzero(cloud.points[cloud.mask][:, 2].cpu().numpy() > 0.01)[0]
    for idx in above[::max(1, len(above) // 20)]:
        idx, grasps, _ = test_grasp_image.hand_poses(path, int(idx), "cuda")
        if bool(grasps.valid.any()):
            break
    else:
        fail("test_grasp_image found no object point with a valid hand")
    reset_counts()
    t0 = time.perf_counter()
    rc = test_grasp_image.main([path, str(idx),
                                os.path.join(tmp, "grasp_image.png")])
    t = time.perf_counter() - t0
    launches = counts()
    print(f"test_grasp_image: exit {rc} in {t:.3f} s at sample {idx}; "
          f"raster_images launches {launches['raster_images']}")
    if rc != 0 or launches["raster_images"] < 1:
        fail("test_grasp_image failed or never launched raster_images")
    hands = grasps.to_host_list()
    segs = np.stack([viz.hand_segments(g["position"], g["orientation"])
                     for g in hands])
    boxes = np.stack([viz.hand_volume_boxes(g["position"], g["orientation"])
                      for g in hands])
    cubes = np.stack([viz.volume_box(g["position"], g["orientation"], 0.06,
                                     0.10, 0.04) for g in hands])
    ply = os.path.join(tmp, "grasp_image_scene.ply")
    viz.save_cloud_ply(ply, pcd.load_cloud_file(path))
    gap = max(abs(np.linalg.norm(b[0].mean(0) - b[1].mean(0)) - 0.11)
              for b in boxes)
    print(f"viz on its {len(hands)} hands: segments {segs.shape}, cuboids "
          f"{boxes.shape}, volume cubes {cubes.shape}, finger spacing gap "
          f"{gap:.1e} m; PLY {os.path.getsize(ply)} bytes")
    if not (np.isfinite(segs).all() and np.isfinite(boxes).all()
            and gap < 1e-5):
        fail("viz's hand geometry is not finite or not the hand's")
    return launches

def weights_path(torch, syn, lenet, detector, GraspDetector, DetectorConfig,
                 convert_weights, params, tmp):
    """The trained parameters written as npz, converted to ONNX by the
    convert_weights CLI, and written as a torch state dict and a raw .bin
    directory. A card detector built from each format must hold exactly
    the npz's parameters, and score one 15-channel request's candidates
    (scene 0, from the npz detector's detect_core) into identical
    selections."""
    paths = {"npz": os.path.join(tmp, "trained.npz"),
             "onnx": os.path.join(tmp, "trained.onnx"),
             "pt": os.path.join(tmp, "trained.pt"),
             "bin": os.path.join(tmp, "trained_bin")}
    lenet.save_params_npz(paths["npz"], params)
    if convert_weights.main([paths["npz"], paths["onnx"], "15"]) != 0:
        fail("convert_weights did not write the ONNX file")
    torch.save({name: torch.from_numpy(params[key])
                for name, key in lenet.TORCH_NAMES.items()}, paths["pt"])
    os.makedirs(paths["bin"])
    for key, name in lenet.BIN_NAMES.items():
        params[key].tofile(os.path.join(paths["bin"], name))
    dets = {fmt: GraspDetector(DetectorConfig(weights_file=path),
                               device="cuda") for fmt, path in paths.items()}
    ref = dets["npz"]
    p, cs, vp = scene(syn, 0)
    cloud = ref.preprocess_cloud(p, view_points=vp, cam_source=cs)
    cfg = ref.effective_config(cloud)
    gen = seeded(torch, 0)
    spos, smask = ref.sample_cloud(cloud, gen)
    grasps, images = detector.detect_core(cloud, spos, smask, ref.net, gen,
                                          cfg, ref.image_cap(spos.shape[0]))
    selected = {}
    for fmt, det in dets.items():
        held = lenet.params_to_numpy(det.net)
        if set(held) != set(params) or not all(
                np.array_equal(held[k], params[k]) for k in params):
            fail(f"the {fmt} detector does not hold the trained parameters")
        scores = lenet.score(det.net, images)
        g = detector.select_and_cluster(dataclasses.replace(
            grasps, score=torch.where(grasps.valid, scores, -torch.inf)), cfg)
        selected[fmt] = g.to_host()
    a = selected["npz"]
    for fmt, b in selected.items():
        if not (np.array_equal(a.valid, b.valid) and np.array_equal(
                a.position, b.position) and np.array_equal(a.score, b.score)):
            fail(f"the {fmt} detector selects other grasps than the npz's")
    print(f"weights: npz, onnx (convert_weights CLI), pt and bin detectors "
          f"hold identical parameters; {int(grasps.valid.sum())} candidates "
          f"of scene 0 scored by each give identical selections "
          f"({int(a.valid.sum())} grasps, top score "
          f"{float(a.score[a.valid].max()):.4f})")


def score_check(torch, lenet, cpu_net, card_net, images, k_cap):
    """The same images (the CPU route's) scored on the card and on the CPU
    at bf16 and at f32: the logits' dtype, distinct scores against
    distinct images, max |score gap|, and top-k overlap of the card's bf16
    scores with the CPU's bf16 (must be >= 95%) and f32 scores."""
    n = len(images)
    x = torch.from_numpy(images)
    logits = card_net(x.cuda())
    if logits.dtype != torch.float32:
        fail(f"the card's logits are {logits.dtype}")
    s = {("card", "bf16"): lenet.score(card_net, x.cuda()).cpu(),
         ("card", "f32"): lenet.score(card_net, x.cuda(), torch.float32).cpu(),
         ("cpu", "bf16"): lenet.score(cpu_net, x, torch.bfloat16),
         ("cpu", "f32"): lenet.score(cpu_net, x)}
    k = max(1, min(k_cap, n // 2))

    def top(t):
        return set(torch.argsort(-t, stable=True)[:k].tolist())

    def gap(a, b):
        return float((s[a] - s[b]).abs().max())
    overlap = len(top(s["card", "bf16"]) & top(s["cpu", "bf16"])) / k
    overlap32 = len(top(s["card", "bf16"]) & top(s["cpu", "f32"])) / k
    n_images = len(np.unique(images.reshape(n, -1), axis=0))
    print(f"  scores of {n} hands: card logits {logits.dtype}; distinct "
          f"scores card bf16 {len(np.unique(s['card', 'bf16']))}, f32 "
          f"{len(np.unique(s['card', 'f32']))}, of {n_images} distinct "
          f"images; max |gap| card-CPU bf16 {gap(('card', 'bf16'), ('cpu', 'bf16')):.2e}"
          f", f32 {gap(('card', 'f32'), ('cpu', 'f32')):.2e}, card bf16 - "
          f"CPU f32 {gap(('card', 'bf16'), ('cpu', 'f32')):.2e}; top-{k} "
          f"overlap card bf16 with CPU bf16 {overlap:.1%}, with CPU f32 "
          f"{overlap32:.1%}")
    if overlap < 0.95:
        fail(f"the card's top-{k} shares {overlap:.1%} with the CPU's")


def reset_counts():
    from gpd_tpu_torch.ops import _build
    _build.LAUNCHES.clear()


def counts():
    """Kernel launches per wrapper of KERNELS since the last
    reset_counts (the launch registry's)."""
    from gpd_tpu_torch.ops import _build
    return {name: _build.LAUNCHES[name] for name in KERNELS}


def stage_breakdown(torch, det, prepare, kernel, label):
    """One request once more by the staged route at detect's image chunk
    (detect(staged=True, staged_cap=image_cap)), which waits for the
    device after every stage: each stage's host-clock time, and the image
    chunks as launches of the wrapper ``kernel``. ``prepare`` makes the
    cloud (timed as preprocess)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cloud = prepare()
    torch.cuda.synchronize()
    times = {"preprocess": time.perf_counter() - t0}
    before = counts()[kernel]
    det.detect(cloud, verbose=False, staged=True,
               staged_cap=det.image_cap(det.cfg.num_samples),
               generator=torch.Generator(device="cuda").manual_seed(0))
    rt = det.last_runtimes
    for stage in ("candidates", "images", "classify"):
        times[stage] = rt[stage]
    print(f"stage breakdown ({label}, ms): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in times.items()) +
        f"; sum {sum(times.values()) * 1e3:.2f}; staged total "
        f"{rt['total'] * 1e3:.2f}; "
        f"{counts()[kernel] - before} image chunks")


def reference_check(torch, syn, lenet, GraspDetector, detector, cfg, kernel):
    """Grasp images of one small scene's hands, from the card's kernel route
    and from the CPU's plain route on the same inputs; then the CPU route's
    images scored on the card and on the CPU (score_check)."""
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

    before = counts()[kernel]
    out = detector._images_for(moved(torch, cloud, "cuda"),
                               moved(torch, g, "cuda"),
                               *[moved(torch, t, "cuda") for t in inputs],
                               ecfg)
    out = out.cpu().numpy()
    if counts()[kernel] == before:
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
    score_check(torch, lenet, cpu.net, GraspDetector(cfg, device="cuda").net,
                ref[g.valid.numpy()], cfg.num_selected)


class MemoryWriter:
    """gen_dataset's train or test writer in host memory: the is_done and
    append of datagen.HDF5ShardWriter (the card's machine has no h5py)."""

    def __init__(self):
        self.done, self.images, self.labels = set(), [], []

    def is_done(self, obj, view):
        return (obj, view) in self.done

    def append(self, obj, view, images, labels):
        self.images.append(images)
        self.labels.append(np.asarray(labels).reshape(-1))
        self.done.add((obj, view))

    def dataset(self):
        """The instances as one in-memory block for net.train."""
        return Blocks(np.concatenate(self.images),
                      np.concatenate(self.labels))


def classifier_pass(torch, img, gen_dataset, det, gen, depth, kept=None):
    """gen_dataset's generation loop once: its build_items (``depth`` =
    objects, views per object, scenes) through gen.generate into two
    MemoryWriters, the per-view log kept out of the output. Returns the
    writers, the pass's host ms (preprocessing included, to the last view's
    rows on the host), the views, the keys it captured and the kernel
    wrapper calls it made. Appends each item to ``kept``."""
    objects, views, scenes = depth
    train, test = MemoryWriter(), MemoryWriter()
    n0, calls0 = len(det.graphs), sum(counts().values())

    def items():
        for item in gen_dataset.build_items(det, objects, views,
                                            num_scenes=scenes):
            if kept is not None:
                kept.append(item)
            yield item
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        gen.generate(items(), train, writer_test=test,
                     total_items=(objects + scenes) * views)
    torch.cuda.synchronize()
    return dict(train=train, test=test, ms=(time.perf_counter() - t0) * 1e3,
                views=len(train.done) + len(test.done),
                new=list(det.graphs)[n0:],
                calls=sum(counts().values()) - calls0)


def heldout_views(syn, CloudArrays, det):
    """gpd_tpu's held-out quality views (tests/test_classifier_quality.py):
    object_zoo(3, seed=17), one camera each from rng 99, preprocessed by
    ``det`` at its snug capacity; (view, whole object as mesh) pairs."""
    rng = np.random.default_rng(99)
    out = []
    for _, mpts, mnrm in syn.object_zoo(3, seed=17):
        cam = syn.view_cameras(rng, 1)[0]
        out.append((det.preprocess_cloud(syn.render_view(rng, mpts, mnrm, cam),
                                         view_points=cam.reshape(1, 3)),
                    CloudArrays.from_numpy(mpts, normals=mnrm,
                                           device="cuda")))
    return out


def clutter_views(syn, CloudArrays, det):
    """gpd_tpu's held-out clutter views: 2 make_scene(n_objects=3) scenes
    from rng 1234, two fused occluded cameras each; (view, whole scene as
    mesh) pairs."""
    rng = np.random.default_rng(1234)
    out = []
    for _ in range(2):
        spts, snrm = syn.make_scene(rng, n_objects=3)
        cams = syn.view_cameras(rng, 2, dist=0.7)
        vpts, vcam, vps = syn.render_fused_views(rng, spts, snrm, cams,
                                                 occluded=True)
        out.append((det.preprocess_cloud(vpts, view_points=vps,
                                         cam_source=vcam),
                    CloudArrays.from_numpy(spts, normals=snrm,
                                           device="cuda")))
    return out


def rank_auc(scores, labels):
    """The probability that a random positive outscores a random negative
    (gpd_tpu's quality tests' ``_auc``)."""
    scores, labels = np.concatenate(scores), np.concatenate(labels)
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    npos = int(labels.sum())
    nneg = len(labels) - npos
    if not (npos and nneg):
        fail(f"an AUC over {npos} positives and {nneg} negatives")
    return float((ranks[labels == 1].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg)), len(labels), npos


def quality_auc(torch, detector, cand, det, views, samples, seed,
                cpu_det=None):
    """The rank AUC of ``det``'s scores against full-mesh antipodal labels
    over ``views``: per view ``samples`` samples drawn on the card from
    seed + i, the valid candidates and scores from detect's A and B (CUDA
    graphs) given those samples, their labels from reevaluate_hypotheses
    on the card. With ``cpu_det``, the same views and samples through the
    CPU route too (detect_core and the relabeling on the CPU; the shadow
    draws are the CPU generator's). Returns (AUC, candidates, positives)
    per route."""
    out = {"card": ([], []), "cpu": ([], [])}
    for i, (view, mesh) in enumerate(views):
        cfg = dataclasses.replace(det.effective_config(view),
                                  num_samples=samples)
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        spos, smask = detector.sample_points(view, gen, cfg)
        scored, _, n_a, _ = det._scored_programs(view, spos, smask, gen,
                                                 cfg)
        labels, _ = cand.reevaluate_hypotheses(mesh, scored, cfg)
        out["card"][0].append(scored.score[:n_a[0]].cpu().numpy())
        out["card"][1].append(labels[:n_a[0]].cpu().numpy())
        if cpu_det is None:
            continue
        g, _ = detector.detect_core(
            moved(torch, view, "cpu"), spos.cpu(), smask.cpu(), cpu_det.net,
            torch.Generator().manual_seed(seed + i), cfg,
            det.image_cap(samples), scores_only=True)
        labels, _ = cand.reevaluate_hypotheses(moved(torch, mesh, "cpu"), g,
                                               cfg)
        n = int(g.valid.sum())
        out["cpu"][0].append(g.score[:n].numpy())
        out["cpu"][1].append(labels[:n].numpy())
    return {route: rank_auc(*v) for route, v in out.items() if v[0]}


def sliced_vs_native(torch, det, det3, view):
    """One view through the 15- and the 3-channel detector from one
    generator state (detect's A and B with images, CUDA graphs): the same
    candidates, and channels 0:3 of the raster_blocks images within the
    repo's image gate of the raster_sums images (slice_channels'
    premise)."""
    out = {}
    for c, d in ((15, det), (3, det3)):
        g, images, n = d.candidates_with_images(
            view, torch.Generator(device="cuda").manual_seed(3))
        out[c] = (g.position[:n].cpu(), images[:n].cpu().numpy())
    (p15, i15), (p3, i3) = out[15], out[3]
    if not (torch.equal(p15, p3) and len(p3) and i3.any()):
        fail(f"the 15- and 3-channel detectors found other candidates "
             f"({len(p15)}, {len(p3)})")
    diff = np.abs(i15[..., :3].astype(np.int32) - i3.astype(np.int32))
    frac = float((diff > 1).mean())
    print(f"sliced vs native (one clutter view, {len(p3)} hands): channels "
          f"0:3 of the 15-channel images against the 3-channel images: max "
          f"u8 diff {int(diff.max())}, share |diff|>1 = {frac:.2e}")
    if frac >= 5e-3:
        fail("sliced 15-channel images leave the 3-channel images' gate")


def classifier_hdf5(gen_dataset, train_classifier, lenet, tmp):
    """The HDF5 CLIs on the card, where h5py imports: gen_dataset.main at 1
    object x 2 views and no scenes, then train_classifier.main for 1 epoch;
    fails unless both sets and a checkpoint in gpd_tpu's keys result.
    Without h5py one line says they did not run."""
    try:
        import h5py
    except ImportError:
        print("gen_dataset / train_classifier HDF5 CLIs: NOT run on the "
              "card (this machine has no h5py); the phase generated and "
              "trained from memory through the same functions")
        return
    out = os.path.join(tmp, "classifier_set")
    gen_dataset.main([out, "1", "2", "0"], device="cuda")
    train_classifier.main([out, "1", os.path.join(out, "c.npz")],
                          device="cuda")
    with h5py.File(os.path.join(out, "train.h5")) as f:
        n = f["labels"].shape[0]
    with np.load(os.path.join(out, "c.npz")) as f:
        keys = sorted(f.files)
    if keys != sorted(lenet.load_params_npz(lenet.default_params_path(15))):
        fail(f"train_classifier wrote keys {keys}")
    print(f"gen_dataset / train_classifier HDF5 CLIs on the card: {n} "
          f"training instances, checkpoint keys {keys}")


def classifier_path(torch, img, profiling, syn, datagen, detector, cand,
                    lenet, train, gen_dataset, train_classifier,
                    GraspDetector, CloudArrays, ImageGeometry, tmp, depth,
                    epochs):
    """The classifier pipeline on its own detector (gen_dataset's:
    DetectorConfig() with 300 samples, min_inliers 0, the packaged
    weights): gen_dataset's items (build_items at ``depth``) through
    DataGenerator.generate by the graph route into memory, twice (the
    first pass captures; the second must capture nothing, call no kernel
    wrapper and find the first's labels); train_classifier's training at
    batch 256 for ``epochs`` on the second pass's train set and its
    float16 checkpoint; the quality AUCs; the sliced-vs-native check; one
    traced graph view. Returns the kernel wrapper calls of the phase."""
    det = gen_dataset.make_detector("cuda")
    gen = gen_dataset.make_generator(det, depth[1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    kept = []
    first = classifier_pass(torch, img, gen_dataset, det, gen, depth, kept)
    second = classifier_pass(torch, img, gen_dataset, det, gen, depth)
    train_set, test_set = second["train"].dataset(), second["test"].dataset()
    n_train, n_test = len(train_set.labels), len(test_set.labels)
    pool = sum(e.pool_bytes for e in det.graphs.values())
    print(f"classifier items: gen_dataset.build_items({depth[0]} objects, "
          f"{depth[1]} views, {depth[2]} scenes) at 15 channels, "
          f"{det.cfg.num_samples} samples, capacities view "
          f"{gen_dataset.VIEW_CAPACITY}/{gen_dataset.SCENE_VIEW_CAPACITY}, "
          f"mesh {gen_dataset.MESH_CAPACITY}/"
          f"{gen_dataset.SCENE_MESH_CAPACITY}; pass 1 {first['views']} "
          f"views in {first['ms']:.2f} ms, {len(first['new'])} keys "
          f"captured (warm-up + capture ms, pool bytes added): " + ", ".join(
              f"{key_label(k)} {det.graphs[k].capture_s * 1e3:.2f} "
              f"(+{det.graphs[k].pool_bytes})" for k in first["new"]) +
          f"; pool {pool} bytes over {len(det.graphs)} graphs")
    ms_view = second["ms"] / second["views"]
    print(f"classifier items, pass 2 (seen keys): {second['views']} views in "
          f"{second['ms']:.2f} ms, {ms_view:.2f} ms/view (preprocess, "
          f"attempts, rows to the host), "
          f"{(n_train + n_test) / second['ms'] * 1e3:.1f} instances/s; "
          f"train {n_train}, test {n_test} instances; keys captured "
          f"{len(second['new'])}, kernel wrapper calls {second['calls']}")
    if second["new"] or second["calls"]:
        fail("gen_dataset's second pass captured or ran eagerly")
    for split in ("train", "test"):
        a, b = first[split], second[split]
        if a.done != b.done or not all(
                np.array_equal(x, y) for x, y in zip(a.labels, b.labels)):
            fail(f"gen_dataset's second pass wrote other {split} labels")

    losses, events = [], []

    def on_step(step, loss, acc):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = train.fit(train_set, None, 15, epochs=epochs,
                       batch_size=train_classifier.BATCH_SIZE, device="cuda",
                       on_step=on_step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    step_ms = np.array([a.elapsed_time(b) for a, b in zip(events,
                                                           events[1:])])
    loss = torch.stack(losses).cpu().numpy()
    w = min(100, len(loss) // 2)
    first_loss, last_loss = float(loss[:w].mean()), float(loss[-w:].mean())
    held_loss, held_acc = train.evaluate(
        lenet.params_from_numpy(params, "cuda"), test_set)
    path = train_classifier.save_checkpoint(
        params, os.path.join(tmp, "lenet_15ch.npz"))
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files}
    shipped = lenet.load_params_npz(lenet.default_params_path(15))
    trained = lenet.params_from_numpy(lenet.load_params(path, 15), "cuda")
    x = torch.from_numpy(test_set.images[:256]).cuda()
    s = lenet.score(trained, x)
    print(f"classifier training (train.fit, batch "
          f"{train_classifier.BATCH_SIZE}, {epochs} epochs, each step a "
          f"CUDA graph replay): {n_train} instances, {len(loss)} steps in "
          f"{total:.3f} s, median {np.median(step_ms):.4f} ms/step (p90 "
          f"{np.percentile(step_ms, 90):.4f}, CUDA events); mean loss of the "
          f"first {w} steps {first_loss:.4f}, of the last {w} "
          f"{last_loss:.4f}; held-out views ({n_test} instances): loss "
          f"{held_loss:.4f}, accuracy {held_acc:.4f}; checkpoint "
          f"{sorted(stored)} {sorted({str(v.dtype) for v in stored.values()})}"
          f", {len(x)} held-out images scored finite: "
          f"{bool(torch.isfinite(s).all())}")
    if not last_loss < first_loss:
        fail("the classifier's training loss did not fall")
    if sorted(stored) != sorted(shipped) or any(
            v.dtype != np.float16 for v in stored.values()):
        fail("train_classifier's checkpoint leaves gpd_tpu's keys or "
             "float16")
    if not torch.isfinite(s).all():
        fail("the trained checkpoint scores non-finite")

    cfg3 = dataclasses.replace(det.cfg, image_geometry=ImageGeometry(
        num_channels=3))
    det3 = GraspDetector(cfg3, device="cuda")
    det_t = GraspDetector(det.cfg, params=lenet.load_params(path, 15),
                          device="cuda")
    cpu_det = GraspDetector(det.cfg, device="cpu")
    views = {"held-out objects": (heldout_views(syn, CloudArrays, det), 80,
                                  7, 0.80),
             "clutter": (clutter_views(syn, CloudArrays, det), 120, 5, 0.85)}
    aucs = {}
    for label, (vs, samples, seed, floor) in views.items():
        shipped_auc = quality_auc(torch, detector, cand, det, vs, samples,
                                  seed, cpu_det)
        trained_auc = quality_auc(torch, detector, cand, det_t, vs, samples,
                                  seed)["card"]
        auc3 = quality_auc(torch, detector, cand, det3, vs, samples,
                           seed)["card"]
        (card, n, npos), cpu = shipped_auc["card"], shipped_auc["cpu"]
        aucs[label] = dict(shipped=card, cpu=cpu[0], trained=trained_auc[0],
                           shipped_3ch=auc3[0])
        print(f"classifier AUC, {label} ({len(vs)} views, {samples} samples, "
              f"{n} candidates, {npos} positive): shipped lenet_15ch on the "
              f"card {card:.4f} (floor {floor}), on the CPU route "
              f"{cpu[0]:.4f} over {cpu[1]} candidates (|gap| "
              f"{abs(card - cpu[0]):.4f}, limit 0.02); this run's trained "
              f"checkpoint {trained_auc[0]:.4f} (not gated); shipped "
              f"lenet_3ch {auc3[0]:.4f} (no floor)")
        if not card > floor:
            fail(f"the shipped classifier's {label} AUC {card:.4f} <= "
                 f"{floor}")
        if abs(card - cpu[0]) >= 0.02:
            fail(f"{label} AUC: card {card:.4f}, CPU {cpu[0]:.4f}")
    sliced_vs_native(torch, det, det3, views["clutter"][0][0][0])
    traced_view = profile_offline(torch, profiling, datagen, det, kept[0],
                                  tmp, label="15 channels, gen_dataset",
                                  gen=gen, seed=0)
    launches = counts()
    print(f"classifier pipeline: kernel wrapper calls {launches} (captures' "
          f"warm-ups and captures, the CPU route none); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (launches["raster_images"] and launches["raster_sums"]):
        fail(f"the classifier pipeline launched {launches}")
    classifier_hdf5(gen_dataset, train_classifier, lenet, tmp)
    summary = dict(views=second["views"], ms_per_view=ms_view,
                   instances=n_train + n_test, steps=len(loss),
                   ms_per_step=float(np.median(step_ms)), auc=aucs)
    del det, det3, det_t, gen
    gc.collect()
    torch.cuda.empty_cache()
    return launches, traced_view, summary


def single_camera_config(DetectorConfig, ImageGeometry, cam, channels):
    """The detect_grasps config of the single-camera PCD scenes: default
    widths and 1000 samples at ``channels``, outlier removal, sampling
    above the plane and plane removal before the images on, the camera at
    ``cam`` (1, 3)."""
    return DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels),
        remove_outliers=True, sample_above_plane=True,
        remove_plane_before_image_calculation=True,
        camera_position=tuple(cam[0].tolist()))


def neighbor_routes(torch, det, cloud, label):
    """gpd_tpu's nearest-K routes on the card: radius_neighbors over
    detect's samples (seed 0) at the image neighbourhoods' radius and cap,
    which sorts (the cap is below the cloud's size), with exact=False,
    exact=True, and exact=False under FORCE_EXACT, must give identical idx
    and valid. Off a TPU gpd_tpu's exact=False route is XLA's sort and
    slice, so the port runs one selection for all three."""
    from gpd_tpu_torch.ops import neighbors as nbr
    cfg = det.effective_config(cloud)
    spos, smask = det.sample_cloud(cloud, seeded(torch, 0))
    k = cfg.image_neighbors_cap
    if k >= cloud.capacity:
        fail(f"{label}: cap {k} covers the {cloud.capacity}-point cloud, so "
             f"radius_neighbors would sort nothing")

    def run(exact):
        return nbr.radius_neighbors(spos, smask, cloud.points, cloud.mask,
                                    radius=cfg.image_radius, k=k,
                                    exact=exact)
    approx = nbr._use_approx(cloud.points.device)
    t0 = time.perf_counter()
    out = {"exact=False": run(False), "exact=True": run(True)}
    was = nbr.FORCE_EXACT
    nbr.FORCE_EXACT = True
    try:
        forced = nbr._use_approx(cloud.points.device)
        out["FORCE_EXACT"] = run(False)
    finally:
        nbr.FORCE_EXACT = was
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    idx, valid = out["exact=True"]
    same = [name for name, (i, v) in out.items()
            if torch.equal(i, idx) and torch.equal(v, valid)]
    if not (idx.is_cuda and approx and not forced and len(same) == 3
            and valid.any()):
        fail(f"{label}: neighbour routes differ (equal to exact=True: "
             f"{same}; gpd_tpu's approximate route {approx}, under "
             f"FORCE_EXACT {forced}; {int(valid.sum())} in radius)")
    print(f"{label}, neighbour routes on the card: radius_neighbors of "
          f"{spos.shape[0]} samples over {cloud.capacity} points, k {k}, "
          f"radius {cfg.image_radius}: exact=False (gpd_tpu's approx_min_k "
          f"route here), exact=True and FORCE_EXACT give identical idx "
          f"{tuple(idx.shape)} and valid ({int(valid.sum())} in radius); "
          f"the three calls {ms:.2f} ms (host clock)")


def well_conditioned(torch, cloud, spos, smask, radius, min_gap=0.05):
    """``smask`` kept where the local frame is well conditioned: (l1 - l0)
    / l2 > min_gap for the eigenvalues of sum n n^T over the cloud's points
    within ``radius`` (estimate_frames' moments), in float64. Elsewhere
    rounding sets the frame's axes (ROADMAP.md C), and two devices may
    take other ones."""
    p, n = cloud.points.double(), cloud.normals.double()
    near = ((torch.cdist(spos.double(), p) <= radius)
            & cloud.mask[None]).double()
    m = (near @ (n[:, :, None] * n[:, None, :]).reshape(-1, 9)).reshape(
        -1, 3, 3)
    w = torch.linalg.eigvalsh(m)
    return smask & ((w[:, 1] - w[:, 0]) > min_gap * w[:, 2].clamp_min(1e-12))


def card_vs_cpu(torch, img, detector, det, cloud, label):
    """detect's stages on the card against the same detector's CPU route
    (its config, on the CPU) on one cloud and detect's samples (seed 0).
    The local frames of the samples where they are well conditioned
    (well_conditioned) must agree within 1e-4; elsewhere rounding sets
    their axes (ROADMAP.md C). From the CPU's frames, the hand search and
    filters of the first CARD_VS_CPU_SAMPLES samples on each device must
    give the same valid hands, their positions and orientations within
    1e-5 (the hands that each device's own frames give are counted too).
    Then the CPU's first image chunk of those valid hands, from the CPU's
    image inputs, by the card's kernel and by the CPU's plain route must
    stay within the repo's image gate (under 0.5% of pixels more than one
    uint8 step apart)."""
    cfg = det.effective_config(cloud)
    spos, smask = det.sample_cloud(cloud, seeded(torch, 0))
    cloud_cpu = moved(torch, cloud, "cpu")

    def frames(c, s, m):
        return detector.estimate_frames(s, m, c.points, c.mask, c.normals,
                                        radius=cfg.nn_radius_frames)
    fr_card, fv_card = frames(cloud, spos, smask)
    fr_cpu, fv_cpu = frames(cloud_cpu, spos.cpu(), smask.cpu())
    kept = well_conditioned(torch, cloud, spos, smask,
                            cfg.nn_radius_frames).cpu() & fv_cpu
    if not (torch.equal(fv_card.cpu(), fv_cpu) and kept.any()):
        fail(f"{label}: card and CPU find other valid frames, or none is "
             f"well conditioned ({int(kept.sum())})")
    frame_gap = float((fr_card.cpu() - fr_cpu)[kept].abs().max())
    n = CARD_VS_CPU_SAMPLES
    t0 = time.perf_counter()
    cpu = detector.hands_at_frames(cloud_cpu, spos[:n].cpu(), fr_cpu[:n],
                                   fv_cpu[:n], cfg)
    t_cpu = time.perf_counter() - t0
    card = detector.hands_at_frames(cloud, spos[:n], fr_cpu[:n].cuda(),
                                    fv_cpu[:n].cuda(), cfg)
    own = detector.hands_at_frames(cloud, spos[:n], fr_card[:n],
                                   fv_card[:n], cfg).valid.cpu()
    v = cpu.valid
    if not (torch.equal(card.valid.cpu(), v) and v.any()):
        fail(f"{label}: from the same frames the card found "
             f"{int(card.valid.sum())} valid hands, the CPU {int(v.sum())}")
    gap = max(float((getattr(card, f).cpu()[v] - getattr(cpu, f)[v]).abs()
                    .max()) for f in ("position", "orientation"))
    if gap > 1e-5 or frame_gap > 1e-4:
        fail(f"{label}: card and CPU hands are {gap:.2e} apart, frames "
             f"{frame_gap:.2e}")
    mask = detector.image_point_mask(cloud_cpu,
                                     torch.Generator().manual_seed(1), cfg)
    inputs = detector.image_inputs_stage(cloud_cpu, mask, spos[:n].cpu(),
                                         smask[:n].cpu(), None, cfg)
    g = detector._compact_hands(cpu, det.image_cap(n))
    ref = detector._images_for(cloud_cpu, g, *inputs, cfg).numpy()
    before = sum(counts().values())
    out = detector._images_for(cloud, moved(torch, g, "cuda"),
                               *[moved(torch, t, "cuda") for t in inputs],
                               cfg).cpu().numpy()
    if sum(counts().values()) == before:
        fail(f"{label}: the card's images did not reach a kernel")
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    frac = float((diff > 1).mean())
    print(f"{label}, card vs CPU: frames {frame_gap:.2e} apart on the "
          f"{int(kept.sum())} of {int(smask.sum())} samples that are well "
          f"conditioned; from the CPU's frames {int(v.sum())} valid hands of "
          f"the first {n} samples on both, geometry gap {gap:.2e} (the "
          f"CPU's hand search {t_cpu:.2f} s; from the card's own frames "
          f"{int(own.sum())} valid, {int((own != v).sum())} hands other "
          f"than the CPU's); images of {int(g.valid.sum())} hands "
          f"{out.shape}: max u8 diff {int(diff.max())}, share |diff|>1 = "
          f"{frac:.2e} (gate 5e-3)")
    if frac >= 5e-3:
        fail(f"{label}: card images leave the CPU route's gate")


def path_12ch(torch, img, profiling, syn, datagen, cem, detector,
              GraspDetector, DetectorConfig, CEMConfig, ImageGeometry,
              CloudArrays, tmp):
    """The 12-channel detector (DetectorConfig with 12 channels, every
    other default; random init from seed 0: gpd_tpu ships no 12-channel
    checkpoint), on a detector of its own, freed after it: a warm-up
    request, then per scene of the 15-channel path graph_turns of detect
    and request_turns; card_vs_cpu on scene 0; CEM's fused route against
    its loop on scene 0 (cem_path); generate_view by route on one view of
    each zoo object (datagen_turns). Returns {path: kernel wrapper calls,
    or the kernels traced replays ran} and the raster_images launches a
    request, a CEM request and a view ran."""
    det = GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=12)), device="cuda")
    if det.net.conv1.in_channels != 12:
        fail(f"the 12-channel detector's net takes "
             f"{det.net.conv1.in_channels} channels")
    t0 = time.perf_counter()
    p, cs, vp = scene(syn, 100)
    det.detect(det.preprocess_cloud(p, view_points=vp, cam_source=cs),
               generator=seeded(torch, 100), verbose=False)
    print(f"12-channel warm-up request (preprocess_cloud + detect): "
          f"{graph_keys_line(det, 0, time.perf_counter() - t0)}")
    reset_counts()
    ran, clouds = 0, []
    for r in range(REQUESTS):
        p, cs, vp = scene(syn, r)

        def prep(d, p=p, cs=cs, vp=vp):
            return d.preprocess_cloud(p, view_points=vp, cam_source=cs)
        clouds.append(prep(det))
        ran += graph_turns(
            torch, img, profiling, det, lambda: det.detect(
                clouds[-1], generator=seeded(torch, r), verbose=False),
            f"12-channel request {r}", "raster_images",
            os.path.join(tmp, f"detect12_{r}"))["raster_images"]
        request_turns(torch, det, lambda: det.detect(
            prep(det), generator=seeded(torch, r), verbose=False),
            f"12-channel request {r}")
    launches = counts()
    print(f"launches on the 12-channel path: wrapper calls {launches} "
          f"(warm-ups and captures, and {5 * REQUESTS} eager requests); "
          f"{len(det.graphs)} graphs captured, pool "
          f"{sum(e.pool_bytes for e in det.graphs.values())} bytes; traced "
          f"replays ran {ran / REQUESTS:.2f} raster_images per request")
    card_vs_cpu(torch, img, detector, det, clouds[0], "12-channel request 0")
    cem_launches = cem_path(torch, img, profiling, syn, det, cem, CEMConfig,
                            [(0, cem.SUM_OF_GAUSSIANS)], "12-channel CEM")
    units = datagen_units(torch, syn, det, CloudArrays)[::DATAGEN_VIEWS]
    gen = datagen.DataGenerator(det, datagen.DataGenConfig())
    reset_counts()
    passes = datagen_turns(torch, img, datagen, gen, units,
                           "data generation, 12 channels", "raster_images")
    launches_gen = counts()
    graph = passes["graph"][0]
    per_view = [replayed_launches(det, g["keys"], "raster_images")
                for g in graph]
    shapes = {g["images"].shape[1:] for g in graph}
    print(f"data generation, 12 channels: {len(units)} views, "
          f"{sum(len(g['labels']) for g in graph)} instances a pass, images "
          f"{shapes}; raster_images recorded by the captures of the keys "
          f"each graph view replayed {per_view}, eager wrapper calls "
          f"{[e['calls'] for e in passes['eager'][0]]}")
    if shapes != {(60, 60, 12)}:
        fail(f"12-channel generate_view gave images {shapes}")
    del det, gen, passes, graph, clouds, units
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {
        f"detect, 12 channels (wrapper calls: warm-ups, captures, "
        f"{5 * REQUESTS} eager requests)": launches,
        f"detect, 12 channels, graph route ({REQUESTS} traced replays, from "
        f"the trace)": {"raster_images": ran, "raster_sums": 0,
                        "raster_sums2": 0},
        "CEM fused, 12 channels (1 traced replay, from the trace)":
            cem_launches["fused"],
        "CEM loop, 12 channels (2 requests)": cem_launches["loop"],
        f"generate_view, 12 channels ({len(per_view)} views; wrapper calls: "
        f"the warm pass's warm-ups and captures, two eager passes)":
            launches_gen}
    return by_path, per_view, dict(
        request=ran / REQUESTS, cem=cem_launches["fused"]["raster_images"],
        view=float(np.mean(per_view)))


def path_1ch(torch, img, profiling, syn, pcd, detector, GraspDetector,
             DetectorConfig, ImageGeometry, tmp):
    """The 1-channel detect_file (the 3-channel path's single-camera PCD
    scenes and options at 1 channel; random init from seed 0: gpd_tpu
    ships no 1-channel checkpoint), on a detector of its own, freed after
    it: a warm-up request, then per scene graph_turns of detect_file
    (graph against eager in turns, one traced replay), then card_vs_cpu on
    the first scene. Returns {path: kernel wrapper calls, or the kernels
    traced replays ran} and the raster_sums launches a request ran."""
    paths, cam = single_camera_scenes(syn, pcd, tmp, (100, 0, 1, 2))
    det = GraspDetector(single_camera_config(DetectorConfig, ImageGeometry,
                                             cam, 1), device="cuda")
    t0 = time.perf_counter()
    det.detect_file(paths[0], verbose=False, generator=seeded(torch, 100))
    print(f"1-channel warm-up request (detect_file): "
          f"{graph_keys_line(det, 0, time.perf_counter() - t0)}")
    reset_counts()
    ran = 0
    for r, path in enumerate(paths[1:]):
        ran += graph_turns(
            torch, img, profiling, det, lambda: det.detect_file(
                path, verbose=False, generator=seeded(torch, r)),
            f"1-channel request {r} (detect_file, file read and preprocess "
            f"included)", "raster_sums",
            os.path.join(tmp, f"detect_file1_{r}"))["raster_sums"]
    launches = counts()
    print(f"launches on the 1-channel path: wrapper calls {launches} "
          f"(warm-ups and captures, and {3 * REQUESTS} eager requests); "
          f"{len(det.graphs)} graphs captured, pool "
          f"{sum(e.pool_bytes for e in det.graphs.values())} bytes; traced "
          f"replays ran {ran / REQUESTS:.2f} raster_sums per request")
    card_vs_cpu(torch, img, detector, det, det.preprocess_cloud(
        pcd.load_cloud_file(paths[1]), view_points=cam, capacity="serve"),
        "1-channel request 0")
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return {f"detect_file, 1 channel (wrapper calls: warm-ups, captures, "
            f"{3 * REQUESTS} eager requests)": launches,
            f"detect_file, 1 channel, graph route ({REQUESTS} traced "
            f"replays, from the trace)": {"raster_blocks": 0,
                                          "raster_sums": ran,
                                          "raster_sums2": 0}}, \
        ran / REQUESTS


def widths_path(torch, img, profiling, syn, pcd, datagen, cem, detector,
                GraspDetector, DetectorConfig, CEMConfig, ImageGeometry,
                CloudArrays):
    """Phase 20: path_12ch, then path_1ch. Returns {path: launches} of the
    12-channel paths, of the 1-channel paths, the 12-channel per-view
    launches and the launches a request ran at each width."""
    with tempfile.TemporaryDirectory() as tmp:
        by12, per_view, per12 = path_12ch(
            torch, img, profiling, syn, datagen, cem, detector,
            GraspDetector, DetectorConfig, CEMConfig, ImageGeometry,
            CloudArrays, tmp)
        by1, per1 = path_1ch(torch, img, profiling, syn, pcd, detector,
                             GraspDetector, DetectorConfig, ImageGeometry,
                             tmp)
    return by12, by1, per_view, dict(per12, detect_file_1ch=per1)


def classifier_only(torch, card, args):
    """``python3 chip_smoke.py classifier [OBJECTS VIEWS SCENES EPOCHS]``:
    the classifier pipeline phase alone at that depth (by default
    gen_dataset's and train_classifier's: 24 objects x 8 views, 8 scenes,
    6 epochs), after building the two raster kernels; prints a summary
    line last."""
    from gpd_tpu_torch import datagen, detector, profiling
    from gpd_tpu_torch.config import ImageGeometry
    from gpd_tpu_torch.core.types import CloudArrays
    from gpd_tpu_torch.datasets import synthetic as syn
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.net import lenet, train
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import candidates as cand
    from gpd_tpu_torch.ops import images as img
    from gpd_tpu_torch.tools import gen_dataset, train_classifier

    objects, views, scenes, epochs = (args + [24, 8, 8, 6][len(args):])[:4]
    _build.build(["raster_blocks", "raster_sums"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches, _, summary = classifier_path(
            torch, img, profiling, syn, datagen, detector, cand, lenet, train,
            gen_dataset, train_classifier, GraspDetector, CloudArrays,
            ImageGeometry, tmp, (objects, views, scenes), epochs)
    summary["wall_s"] = time.perf_counter() - t0
    print(card)
    print(json.dumps({"classifier": summary, "launches": launches}))


def widths_only(torch, card):
    """``python3 chip_smoke.py widths``: raster_blocks with and without
    shadows against its plain version (timed), then phase 20 alone (the
    12- and 1-channel paths); prints a summary line last."""
    from gpd_tpu_torch import cem, datagen, detector, profiling
    from gpd_tpu_torch.config import CEMConfig, DetectorConfig, ImageGeometry
    from gpd_tpu_torch.core.types import CloudArrays
    from gpd_tpu_torch.datasets import synthetic as syn
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io import pcd
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import images as img

    t0 = time.perf_counter()
    _build.build(["raster_blocks", "raster_sums", "pcd_ascii"])
    _, free = check_raster(torch, img)
    by12, by1, per_view, per_request = widths_path(
        torch, img, profiling, syn, pcd, datagen, cem, detector,
        GraspDetector, DetectorConfig, CEMConfig, ImageGeometry, CloudArrays)
    print(card)
    print(json.dumps({"widths": dict(
        per_request, per_view_12ch=per_view, wall_s=time.perf_counter() - t0,
        shadow_free={k: free[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "bound_ratio")}),
        "launches": {**by12, **by1}}))


def images_only(torch, card):
    """``python3 chip_smoke.py images``: raster_images' check and timing
    alone (phase 3's images check), after the build's register and spill
    lines; prints its kernels-line entries last."""
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import images as img

    for name, log in _build.build(["raster_blocks"]).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line or "stack" in line:
                print(f"  {name}: {line.strip()}")
    entries = check_images(torch, img)
    print(card)
    print(json.dumps({"kernels": entries}))


def hand_search_only(torch, card):
    """``python3 chip_smoke.py hand_search``: the hand search's check and
    timing alone (phase 3's last check); prints its kernels-line entry
    last."""
    from gpd_tpu_torch import detector
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import candidates as cand

    for name, log in _build.build(["hand_search"]).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line or "stack" in line:
                print(f"  {name}: {line.strip()}")
    entry = check_hand_search(torch, cand, detector, GraspDetector)
    print(card)
    print(json.dumps({"kernels": [entry]}))


def radius_moments_only(torch, card):
    """``python3 chip_smoke.py radius_moments``: the radius moments' check
    and timing alone (phase 3's last check); prints its kernels-line entry
    last."""
    from gpd_tpu_torch import detector
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.ops import _build

    for name, log in _build.build(["radius_moments"]).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line or "stack" in line:
                print(f"  {name}: {line.strip()}")
    entry = check_radius_moments(torch, detector, GraspDetector)
    print(card)
    print(json.dumps({"kernels": [entry]}))


def outlier_knn_only(torch, card):
    """``python3 chip_smoke.py outlier_knn``: the outlier filter's check
    and timing alone (phase 3's last check); prints its kernels-line entry
    last."""
    from gpd_tpu_torch.ops import _build

    for name, log in _build.build(["outlier_knn"]).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line or "stack" in line:
                print(f"  {name}: {line.strip()}")
    entry = check_outlier_knn(torch)
    print(card)
    print(json.dumps({"kernels": [entry]}))


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
    if sys.argv[1:2] == ["classifier"]:
        return classifier_only(torch, card, [int(a) for a in sys.argv[2:]])
    if sys.argv[1:2] == ["widths"]:
        return widths_only(torch, card)
    if sys.argv[1:2] == ["hand_search"]:
        return hand_search_only(torch, card)
    if sys.argv[1:2] == ["images"]:
        return images_only(torch, card)
    if sys.argv[1:2] == ["radius_moments"]:
        return radius_moments_only(torch, card)
    if sys.argv[1:2] == ["outlier_knn"]:
        return outlier_knn_only(torch, card)
    from gpd_tpu_torch import api, capi, cem, datagen, detector, profiling
    from gpd_tpu_torch import viz
    from gpd_tpu_torch.apps import cem_detect_grasps, convert_weights
    from gpd_tpu_torch.apps import detect_grasps, generate_candidates
    from gpd_tpu_torch.apps import test_grasp_image
    from gpd_tpu_torch.config import CEMConfig, DetectorConfig, ImageGeometry
    from gpd_tpu_torch.core.types import CloudArrays
    from gpd_tpu_torch.datasets import synthetic as syn
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io import pcd
    from gpd_tpu_torch.net import lenet, train
    from gpd_tpu_torch.ops import _build
    from gpd_tpu_torch.ops import candidates as cand
    from gpd_tpu_torch.ops import images as img
    from gpd_tpu_torch.tools import gen_dataset, train_classifier

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version()}, {torch.cuda.get_device_name(0)}")

    # The C ABI compiles against this Python's headers; without them the C
    # ABI phase prints one line instead of running.
    libs = ["raster_blocks", "raster_sums", "hand_search", "radius_moments",
            "outlier_knn", "pcd_ascii"]
    why_no_c_abi = None
    if _build.python_include() is None:
        why_no_c_abi = (f"this Python has no Python.h in "
                        f"{sysconfig.get_paths()['include']}")
    else:
        libs.append("gpd_c_api")
    t0 = time.perf_counter()
    logs = _build.build(libs)
    print(f"build of {', '.join(libs)}: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                print(f"  {name}: {line.strip()}")

    shadow, free = check_raster(torch, img)
    entries = {"raster_blocks": shadow, **check_sums(torch, img)}
    entries["raster_blocks"]["staged_chunk"] = check_raster_staged_chunk(
        torch, img)
    images15, images12 = check_images(torch, img)
    entries["hand_search"] = check_hand_search(torch, cand, detector,
                                               GraspDetector)
    entries["radius_moments"] = check_radius_moments(torch, detector,
                                                     GraspDetector)
    entries["outlier_knn"] = check_outlier_knn(torch)

    torch.cuda.reset_peak_memory_stats()
    det = GraspDetector(DetectorConfig(), device="cuda")
    launches15, replay15 = main_path(torch, img, profiling, syn, det,
                                     GraspDetector(DetectorConfig(),
                                                   device="cpu"))
    print(f"peak device memory over the 15-channel requests: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    p, cs, vp = scene(syn, 0)
    stage_breakdown(torch, det, lambda: det.preprocess_cloud(
        p, view_points=vp, cam_source=cs), "raster_images",
        "15 channels, request 0 scene")
    neighbor_routes(torch, det, det.preprocess_cloud(
        p, view_points=vp, cam_source=cs), "15 channels, request 0 scene")
    cem_launches = cem_path(torch, img, profiling, syn, det, cem, CEMConfig)
    by_path = {"detect, 15 channels (wrapper calls: warm-ups, captures, "
               "15 eager requests)": launches15,
               "detect, 15 channels, graph route (3 traced replays, from "
               "the trace)": replay15,
               "CEM fused, 15 channels (4 traced replays, from the trace)":
                   cem_launches["fused"],
               "CEM loop, 15 channels (8 requests)": cem_launches["loop"],
               "staged, 15 channels": staged_path(torch, img, syn, det)}
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(parallel_path(torch, img, profiling, syn, det,
                                     detector, cem, CEMConfig, lenet, train,
                                     tmp))
        by_path.update(c_abi_path(torch, img, syn, api, capi, tmp,
                                  why_no_c_abi))
        by_path["test_grasp_image, 15 channels"] = grasp_image_path(
            torch, img, syn, pcd, test_grasp_image, viz, GraspDetector,
            DetectorConfig, tmp)
    classify_times(torch, lenet, det.net)

    units = datagen_units(torch, syn, det, CloudArrays)
    data, launches_gen, per_view, per_view_graph = datagen_path(
        torch, img, datagen, units, det)
    by_path[f"generate_view, 15 channels ({len(units)} views; wrapper "
            f"calls: the warm pass's warm-ups and captures, two eager "
            f"passes)"] = launches_gen
    datagen_span(torch, img, datagen, syn, det, CloudArrays)
    launches_gen3, replayed_gen3, det_gen3 = datagen_3ch(
        torch, img, datagen, GraspDetector, DetectorConfig, ImageGeometry,
        units[0])
    by_path["generate_view, 3 channels (1 view; wrapper calls: the warm "
            "pass's warm-ups and captures, two eager passes)"] = launches_gen3
    relabel_check_eager(torch, detector, cand, datagen, det, units[0])
    datagen_breakdown_eager(torch, detector, cand, datagen, det, units[1])
    trained = training_path(torch, lenet, train, data, units)

    with tempfile.TemporaryDirectory() as tmp:
        paths, cam = single_camera_scenes(syn, pcd, tmp, (100, 0, 1, 2))
        cfg3 = single_camera_config(DetectorConfig, ImageGeometry, cam, 3)
        torch.cuda.reset_peak_memory_stats()
        det3 = GraspDetector(cfg3, device="cuda")
        launches3, replay3 = entry_point_3ch(
            torch, img, profiling, pcd, det3,
            GraspDetector(cfg3, device="cpu"), paths, tmp)
        print(f"peak device memory over the 3-channel requests: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        stage_breakdown(torch, det3, lambda: det3.preprocess_cloud(
            pcd.load_cloud_file(paths[1]), view_points=cam,
            capacity="serve"), "raster_sums",
            "3 channels, request 0 scene, preprocess includes the file read")
        cfg_path = cli_3ch(detect_grasps, pcd, paths[1], cam, tmp)
        by_path["detect_file, 3 channels (wrapper calls: warm-ups, "
                "captures, 15 eager requests)"] = launches3
        by_path["detect_file, 3 channels, graph route (3 traced replays, "
                "from the trace)"] = replay3
        for name, launches in clis_3ch(
                img, cem_detect_grasps, detect_grasps, generate_candidates,
                cfg_path, paths[1], tmp).items():
            by_path[f"{name} CLI, 3 channels"] = launches
        api_15ch(api, DetectorConfig, pcd, paths[1], cam)
        api_cache_check(torch, api, DetectorConfig, syn)
        pcd_routes(pcd, paths[1:] + [sensor_frame_pcd(pcd, tmp)])
        profile_requests(torch, profiling, cem, CEMConfig, syn, det, tmp)
        traced_view = profile_offline(torch, profiling, datagen, det,
                                      units[1], tmp)
        traced_view3 = profile_offline(torch, profiling, datagen, det_gen3,
                                       units[0], tmp, "raster_sums",
                                       "3 channels")
        del det_gen3
        training_routes(torch, profiling, train, lenet, trained, data, tmp)
        weights_path(torch, syn, lenet, detector, GraspDetector,
                     DetectorConfig, convert_weights, trained, tmp)

    reference_check(torch, syn, lenet, GraspDetector, detector,
                    DetectorConfig(num_samples=32), "raster_images")
    reference_check(torch, syn, lenet, GraspDetector, detector,
                    DetectorConfig(num_samples=32, image_geometry=ImageGeometry(
                        num_channels=3)), "raster_sums")
    net_swap_check(torch, lenet, syn, det, GraspDetector, DetectorConfig)
    with tempfile.TemporaryDirectory() as tmp:
        launches_q, traced_q, _ = classifier_path(
            torch, img, profiling, syn, datagen, detector, cand, lenet, train,
            gen_dataset, train_classifier, GraspDetector, CloudArrays,
            ImageGeometry, tmp, CLASSIFIER_DEPTH, CLASSIFIER_EPOCHS)
    by_path[f"classifier pipeline, 15 and 3 channels (gen_dataset's items "
            f"{CLASSIFIER_DEPTH} twice, training, AUC requests, sliced vs "
            f"native; wrapper calls: warm-ups and captures)"] = launches_q
    by12, by1, per_view12, per_request = widths_path(
        torch, img, profiling, syn, pcd, datagen, cem, detector,
        GraspDetector, DetectorConfig, CEMConfig, ImageGeometry, CloudArrays)
    by_path.update(by1)

    # Every path's 12/15-channel images take raster_images; raster_blocks
    # runs in the kernel checks alone, and has no path.
    on_paths = {"raster_images": images15,
                **{k: entries[k] for k in ("raster_sums", "raster_sums2",
                                           "hand_search", "radius_moments",
                                           "outlier_knn")}}
    images15["launches"] = launches15["raster_images"]
    entries["raster_sums"]["launches"] = launches3["raster_sums"]
    entries["raster_sums2"]["launches"] = (launches15["raster_sums2"]
                                           + launches3["raster_sums2"])
    entries["hand_search"]["launches"] = launches15["hand_search"]
    entries["radius_moments"]["launches"] = launches15["radius_moments"]
    entries["outlier_knn"]["launches"] = launches3["outlier_knn"]
    for name, e in on_paths.items():
        # A path that counted only the raster kernels is left out.
        e["launches_by_path"] = {path: launches[name]
                                 for path, launches in by_path.items()
                                 if name in launches}
    images12["launches"] = next(iter(by12.values()))["raster_images"]
    images12["launches_by_path"] = {path: launches["raster_images"]
                                    for path, launches in by12.items()}
    images12["launches_by_path"].update({
        "generate_view, 12 channels, graph route, per view (recorded by the "
        "captures of the keys each view replayed; not traced)": per_view12,
        "per 12-channel request, CEM request and view, graph route":
            {k: per_request[k] for k in ("request", "cem", "view")}})
    entries["raster_sums"]["launches_by_path"][
        "detect_file, 1 channel, graph route, per request (from the "
        "traces)"] = per_request["detect_file_1ch"]
    print(f"raster_blocks shadow-free (12 channels): {free['ms']:.4f} ms, "
          f"{free['bound_ratio']:.2f} x its bound {free['bound_ms']:.4f} ms, "
          f"plain {free['plain_ms']:.4f} ms, index_put_ "
          f"{free['library_ms']:.4f} ms; launches a 12-channel request "
          f"{per_request['request']:.2f}, a CEM request {per_request['cem']}, "
          f"a data-generation view {per_request['view']:.2f}; raster_sums "
          f"launches a 1-channel detect_file "
          f"{per_request['detect_file_1ch']:.2f}")
    images15["launches_by_path"][
        "generate_view, 15 channels, eager route, per view (wrapper calls)"
    ] = per_view
    images15["launches_by_path"][
        "generate_view, 15 channels, graph route, per view (recorded by "
        "the captures of the keys each view replayed; not traced)"
    ] = per_view_graph
    images15["launches_by_path"][
        f"generate_view, 15 channels, graph route, {units[1][0]} view "
        f"{units[1][1]} (from its trace)"] = traced_view
    entries["raster_sums"]["launches_by_path"][
        f"generate_view, 3 channels, graph route, {units[0][0]} view "
        f"{units[0][1]} (recorded by the captures of the keys it replayed)"
    ] = [replayed_gen3]
    entries["raster_sums"]["launches_by_path"][
        f"generate_view, 3 channels, graph route, {units[0][0]} view "
        f"{units[0][1]} (from its trace)"] = traced_view3
    images15["launches_by_path"][
        "classifier pipeline, one gen_dataset view, graph route (from its "
        "trace)"] = traced_q
    keys = ("name", "shadows", "channels", "route", "source", "replaces",
            "launches", "max_abs_err", "unequal_share", "ms", "replaced_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_ratio",
            "launches_by_path", "staged_chunk", "pcd", "mismatches",
            "members_max", "plain_max_abs_err", "queries_off_float64",
            "swept_bound_ms", "swept_bound_ratio", "groups_judged",
            "groups_swept", "swept_share", "mean_bound", "shape", "by_shape",
            "note")
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                  for e in [*entries.values(), free,
                                            images15, images12]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
