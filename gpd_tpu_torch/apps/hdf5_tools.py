"""Dataset tooling for the HDF5 grasp-image datasets (port of
gpd_tpu/apps/hdf5_tools.py, host only).

Covers the reference's standalone pytorch/ dataset utilities in one CLI
(reference: pytorch/shuffle_hdf5.py, shuffle_hdf5_mem.py, reshape_hdf5.py,
reshape_hdf5_mem.py, hdf5_to_zarr.py, hdf5_to_lmdb.py):

  python -m gpd_tpu_torch.apps.hdf5_tools shuffle  in.h5 out.h5 [--seed N] [--mem]
  python -m gpd_tpu_torch.apps.hdf5_tools reshape  in.h5 out.h5 [--chunk N] [--mem]
  python -m gpd_tpu_torch.apps.hdf5_tools to-zarr  in.h5 out.zarr   (requires zarr)
  python -m gpd_tpu_torch.apps.hdf5_tools to-lmdb  in.h5 out.lmdb   (requires lmdb)
  python -m gpd_tpu_torch.apps.hdf5_tools info     in.h5

`shuffle` permutes (images, labels) jointly; `reshape` rewrites into
contiguous chunked datasets sized to the true row count (the reference's
reshapeHDF5 compaction, data_generator.cpp:306-347, exposed as a script in
pytorch/reshape_hdf5.py). Default is a streaming block copy bounded by
--block rows of memory; --mem loads everything (the *_mem.py variants).
zarr / lmdb converters are gated on their imports: without the package
they exit 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _open(path: str, mode: str = "r"):
    import h5py
    return h5py.File(path, mode)


def _create_like(dst, name, shape, dtype, chunk_rows):
    chunks = (min(chunk_rows, shape[0]),) + shape[1:] if shape[0] else None
    return dst.create_dataset(name, shape=shape, dtype=dtype, chunks=chunks)


def cmd_info(args) -> int:
    with _open(args.src) as f:
        for name in f:
            d = f[name]
            print(f"{name}: shape={d.shape} dtype={d.dtype} chunks={d.chunks}")
        if "labels" in f:
            labels = f["labels"][:]
            print(f"positives: {int(labels.sum())} / {len(labels)}")
    return 0


def cmd_shuffle(args) -> int:
    """Joint random permutation of images+labels (pytorch/shuffle_hdf5.py)."""
    rng = np.random.default_rng(args.seed)
    with _open(args.src) as src, _open(args.dst, "w") as dst:
        n = src["labels"].shape[0]
        perm = rng.permutation(n)
        for name in ("images", "labels"):
            d = src[name]
            out = _create_like(dst, name, d.shape, d.dtype, args.chunk)
            if args.mem:
                out[:] = d[:][perm]
            else:
                # Streaming gather: write in blocks of sorted source order so
                # HDF5 fancy-indexing stays monotonic (its requirement).
                for b0 in range(0, n, args.block):
                    sel = perm[b0:b0 + args.block]
                    order = np.argsort(sel)
                    rows = d[np.sort(sel)]
                    inv = np.empty_like(order)
                    inv[order] = np.arange(len(order))
                    out[b0:b0 + len(sel)] = rows[inv]
        print(f"shuffled {n} rows -> {args.dst}")
    return 0


def cmd_reshape(args) -> int:
    """Compact/re-chunk datasets (pytorch/reshape_hdf5.py; the reference's
    reshapeHDF5 final compaction, data_generator.cpp:306-347)."""
    with _open(args.src) as src, _open(args.dst, "w") as dst:
        for name in src:
            d = src[name]
            out = _create_like(dst, name, d.shape, d.dtype, args.chunk)
            if args.mem:
                out[:] = d[:]
            else:
                for b0 in range(0, d.shape[0], args.block):
                    out[b0:b0 + args.block] = d[b0:b0 + args.block]
            print(f"{name}: {d.shape} chunks {d.chunks} -> {out.chunks}")
    return 0


def cmd_to_zarr(args) -> int:
    """HDF5 -> zarr (pytorch/hdf5_to_zarr.py). Exits 2 without zarr."""
    try:
        import zarr
    except ImportError:
        print("zarr is not installed; install it to use to-zarr",
              file=sys.stderr)
        return 2
    with _open(args.src) as src:
        root = zarr.open(args.dst, mode="w")
        for name in src:
            d = src[name]
            z = root.create_dataset(
                name, shape=d.shape, dtype=d.dtype,
                chunks=(min(args.chunk, d.shape[0]),) + d.shape[1:])
            for b0 in range(0, d.shape[0], args.block):
                z[b0:b0 + args.block] = d[b0:b0 + args.block]
    print(f"wrote {args.dst}")
    return 0


def cmd_to_lmdb(args) -> int:
    """HDF5 -> lmdb (pytorch/hdf5_to_lmdb.py): one pickled (image, label)
    record per key. Exits 2 without lmdb."""
    try:
        import lmdb
    except ImportError:
        print("lmdb is not installed; install it to use to-lmdb",
              file=sys.stderr)
        return 2
    import pickle
    with _open(args.src) as src:
        n = src["labels"].shape[0]
        nbytes = src["images"].dtype.itemsize * int(
            np.prod(src["images"].shape)) * 2 + (1 << 24)
        env = lmdb.open(args.dst, map_size=nbytes)
        with env.begin(write=True) as txn:
            for b0 in range(0, n, args.block):
                imgs = src["images"][b0:b0 + args.block]
                labels = src["labels"][b0:b0 + args.block]
                for j in range(len(labels)):
                    txn.put(f"{b0 + j:010d}".encode(),
                            pickle.dumps((imgs[j], labels[j])))
            txn.put(b"__len__", str(n).encode())
        env.close()
    print(f"wrote {args.dst} ({n} records)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hdf5_tools", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, needs_dst in (("info", cmd_info, False),
                                ("shuffle", cmd_shuffle, True),
                                ("reshape", cmd_reshape, True),
                                ("to-zarr", cmd_to_zarr, True),
                                ("to-lmdb", cmd_to_lmdb, True)):
        sp = sub.add_parser(name)
        sp.add_argument("src")
        if needs_dst:
            sp.add_argument("dst")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--chunk", type=int, default=1000,
                        help="output chunk rows")
        sp.add_argument("--block", type=int, default=20000,
                        help="streaming block rows")
        sp.add_argument("--mem", action="store_true",
                        help="load whole dataset in memory (the *_mem.py "
                             "variants of the reference scripts)")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
