"""Times the port's raster kernels in another copy of the repo ("baseline")
against this one ("current"), in turns on one card: baseline, current,
current, baseline.

    python3 kernel_ab.py BASELINE_TREE

BASELINE_TREE holds the repo at another commit, for example unpacked from
`git archive COMMIT` into chip_scratch/ (ignored by git, copied to the chip
machine). Each tree's kernels build from its own csrc/ into its own
_build/, and both are called through the port's public wrappers,
images.raster_blocks and images.raster_sums, so any two commits of the port
compare.

Shapes: raster_blocks as the 15-channel path calls it (512 hands,
Km = Ks = 2048, with shadows), and raster_sums at 60x60 cells and K = 2048
for Cp = 4 (3 channels) and Cp = 2 (1 channel), each at 512 and 256 hands,
the detector's two chunk sizes. Each version is first held against the
current plain version; times are chip_smoke.cuda_ms's (inputs read from
HBM). Prints the card's name and power limit first.
"""

import importlib
import os
import subprocess
import sys

import chip_smoke


def images_of(tree):
    """gpd_tpu_torch.ops.images as the copy of the repo in `tree` has it."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "gpd_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(tree))
    try:
        return importlib.import_module("gpd_tpu_torch.ops.images")
    finally:
        sys.path.pop(0)


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
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    versions = {"baseline": images_of(sys.argv[1]),
                "current": images_of(os.path.dirname(
                    os.path.abspath(__file__)))}
    img = versions["current"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    K, size = 2048, 60

    args = chip_smoke.raster_operands(torch, gen, 512, K, K, size)
    compare(torch, "raster_blocks G=512", versions,
            lambda m, *a: m.raster_blocks(*a, size), args,
            img.raster_blocks_ref(*args, size))
    for Cp in (4, 2):
        for G in (512, 256):
            (rows,), cols, aug = chip_smoke.sums_operands(torch, gen, G, K,
                                                          Cp, 1, size)
            args = (rows, cols, aug)
            compare(torch, f"raster_sums Cp={Cp} G={G}", versions,
                    lambda m, *a: m.raster_sums(*a, size), args,
                    img.raster_sums_ref(*args, size))


if __name__ == "__main__":
    main()
