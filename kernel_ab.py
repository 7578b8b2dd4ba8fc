"""Times the port's raster kernels in other copies of the repo against this
one ("current"), in turns on one card: every tree in order, then in reverse
(for one other tree: baseline, current, current, baseline).

    python3 kernel_ab.py TREE [TREE ...]

Each TREE holds the repo at another commit, or a variant of it, for example
unpacked from `git archive COMMIT` into chip_scratch/ (ignored by git,
copied to the chip machine); it is labelled by its directory's name. Each
tree's kernels build from its own csrc/ into its own _build/, all trees'
nvcc processes at once, and every tree is called through the port's public
wrappers, images.raster_blocks, images.raster_sums and images.raster_sums2,
so any commits of the port compare. The build prints each tree's
raster_sums register lines.

Then each tree's LeNet classify (lenet.score, its own default precision,
the packaged 15-channel weights) at 512 and 4096 random images.

Shapes: raster_blocks as the 15-channel path calls it (512 hands,
Km = Ks = 2048, with shadows); raster_sums at 60x60 cells and K = 2048 for
Cp = 4 (3 channels) and Cp = 2 (1 channel), and raster_sums2 (two row sets)
at Cp = 6 and 3, each at 512 and 256 hands, the detector's two chunk sizes;
then raster_sums2 at 512 hands with every row on the sentinel ("empty"), so
its loads, clears and stores are timed without a single addition. Each
version is first held against the current plain version; times are
chip_smoke.cuda_ms's (inputs read from HBM). Prints the card's name and
power limit first.
"""

import concurrent.futures
import importlib
import os
import subprocess
import sys

import chip_smoke


def port_of(tree):
    """gpd_tpu_torch.ops.images and gpd_tpu_torch.net.lenet as the copy of
    the repo in `tree` has them."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "gpd_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(tree))
    try:
        return (importlib.import_module("gpd_tpu_torch.ops.images"),
                importlib.import_module("gpd_tpu_torch.net.lenet"))
    finally:
        sys.path.pop(0)


def build_all(versions):
    """Builds every tree's kernels at once; prints raster_sums' registers."""
    def build(m):
        return m._build.build(["raster_blocks", "raster_sums"])
    with concurrent.futures.ThreadPoolExecutor(len(versions)) as pool:
        logs = dict(zip(versions, pool.map(build, versions.values())))
    for label, log in logs.items():
        lines = [line.split(":", 1)[-1].strip()
                 for line in log.get("raster_sums", "").splitlines()
                 if "Compiling entry" in line or "registers" in line]
        print(f"{label} raster_sums: " + "; ".join(lines))


def compare(torch, name, versions, call, args, ref):
    """Checks every version, then times them in turns: the list, then the
    list reversed."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, ref))
    bound_ms = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
    fns = {label: (lambda *a, m=m: call(m, *a)) for label, m in
           versions.items()}
    for label, fn in fns.items():
        out = fn(*args)
        torch.cuda.synchronize()
        if not torch.allclose(out, ref, atol=1e-3, rtol=1e-5):
            sys.exit(f"{name} {label}: disagrees with the plain version")
    times = {label: [] for label in fns}
    for label in [*fns, *reversed(fns)]:
        times[label].append(chip_smoke.cuda_ms(torch, fns[label], args))
    for label, t in times.items():
        print(f"{name} {label}: {' '.join(f'{x:.4f}' for x in t)} ms; "
              f"{min(t) / bound_ms:.2f}x the {bound_ms:.4f} ms bound")


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ports = {os.path.basename(os.path.normpath(tree)): port_of(tree)
             for tree in sys.argv[1:]}
    ports["current"] = port_of(os.path.dirname(os.path.abspath(__file__)))
    versions = {label: m[0] for label, m in ports.items()}
    build_all(versions)
    img = versions["current"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    K, size = 2048, 60

    args = chip_smoke.raster_operands(torch, gen, 512, K, K, size)
    compare(torch, "raster_blocks G=512", versions,
            lambda m, *a: m.raster_blocks(*a, size), args,
            img.raster_blocks_ref(*args, size))
    for name, n_rows, cps in (("raster_sums", 1, (4, 2)),
                              ("raster_sums2", 2, (6, 3))):
        for Cp in cps:
            for G in (512, 256):
                rows, cols, aug = chip_smoke.sums_operands(
                    torch, gen, G, K, Cp, n_rows, size)
                args = (*rows, cols, aug)
                compare(torch, f"{name} Cp={Cp} G={G}", versions,
                        lambda m, *a, name=name: getattr(m, name)(*a, size),
                        args, getattr(img, name + "_ref")(*args, size))
    for Cp in (6, 3):
        rows, cols, aug = chip_smoke.sums_operands(torch, gen, 512, K, Cp, 2,
                                                   size)
        args = (*(torch.full_like(r, size) for r in rows), cols, aug)
        compare(torch, f"raster_sums2 Cp={Cp} G=512 empty", versions,
                lambda m, *a: m.raster_sums2(*a, size), args,
                img.raster_sums2_ref(*args, size))
    classify_ab(torch, {label: m[1] for label, m in ports.items()})


def classify_ab(torch, lenets):
    """Each tree's lenet.score (its default precision on the card) with the
    packaged 15-channel weights on random images at the detector's chunk
    (512) and the staged route's (4096), in turns; with each tree's max
    |score gap| to the current one's and its count of distinct scores."""
    current = lenets["current"]
    params = current.load_params_npz(current.default_params_path(15))
    nets = {label: m.params_from_numpy(params, "cuda")
            for label, m in lenets.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for G in (512, 4096):
        x = torch.randint(0, 256, (G, 60, 60, 15), generator=gen,
                          device="cuda", dtype=torch.uint8)
        scores = {label: lenets[label].score(net, x)
                  for label, net in nets.items()}
        times = {label: [] for label in nets}
        for label in [*nets, *reversed(nets)]:
            times[label].append(chip_smoke.cuda_ms(
                torch, lambda a, m=lenets[label], n=nets[label]: m.score(n, a),
                (x,)))
        for label, t in times.items():
            s = scores[label]
            print(f"classify G={G} {label}: {' '.join(f'{v:.4f}' for v in t)}"
                  f" ms; scores {s.dtype}, {len(torch.unique(s))} distinct, "
                  f"max |gap| to current "
                  f"{float((s.float() - scores['current']).abs().max()):.4f}")


if __name__ == "__main__":
    main()
