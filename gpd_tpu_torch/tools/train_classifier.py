"""Train the grasp classifier and write a packaged checkpoint (port of
gpd_tpu's tools/train_classifier.py).

The equivalent of the reference's canonical trainer invocation (reference:
pytorch/train_net3.py __main__ block): train the LeNet on an HDF5 dataset
made by ``gpd_tpu_torch.tools.gen_dataset`` (or the reference's own
generate_data layout) at batch 256 and save the final parameters where
``lenet.default_params_path`` looks for them.

    python -m gpd_tpu_torch.tools.train_classifier DATA_DIR [epochs] [out.npz]

Checkpoints are stored float16 under gpd_tpu's key names (``conv1_w``,
``conv1_b``, ..., as in the packaged npz), so either package loads them
(``load_params_npz`` upcasts to float32). Trains on the CUDA card
(``main(argv, device="cpu")`` for the CPU).

``GPD_EPOCHS_OVERRIDE_FILE``, if set and the file exists, clamps the epoch
count to the positive integer it holds (a wall-clock-bound operator can
shorten queued trainings without killing the queue); anything else in it
fails loudly.
"""

import os
import sys
import tempfile

import numpy as np

BATCH_SIZE = 256


def clamp_epochs(epochs: int) -> int:
    """``epochs``, clamped by ``GPD_EPOCHS_OVERRIDE_FILE``. Opt-in only: the
    file must be named explicitly (no world-writable default that could
    silently under-train a shipped checkpoint), and malformed content
    raises SystemExit."""
    ov = os.environ.get("GPD_EPOCHS_OVERRIDE_FILE")
    if ov and os.path.exists(ov):
        with open(ov) as f:
            raw = f.read().strip()
        if not raw.isdigit() or int(raw) <= 0:
            raise SystemExit(
                f"GPD_EPOCHS_OVERRIDE_FILE {ov}: expected a positive int, "
                f"got {raw!r}")
        epochs = min(epochs, int(raw))
        print(f"epoch count clamped to {epochs} by {ov}")
    return epochs


def save_checkpoint(params, out: str) -> str:
    """gpd_tpu's parameter dict written float16 to ``out`` (".npz" appended
    if missing, as np.savez would do silently). Returns the path."""
    if not out.endswith(".npz"):
        out += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **{k: np.asarray(v).astype(np.float16)
                     for k, v in params.items()})
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return out


def main(argv=None, device=None):
    """Returns 0. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    import h5py

    from gpd_tpu_torch.net import lenet, train

    data_dir = argv[0] if len(argv) > 0 else os.path.join(
        tempfile.gettempdir(), "gpd_dataset")
    epochs = clamp_epochs(int(argv[1]) if len(argv) > 1 else 6)
    train_path = os.path.join(data_dir, "train.h5")
    test_path = os.path.join(data_dir, "test.h5")
    has_test = os.path.exists(test_path)

    with h5py.File(train_path, "r") as f:
        num_channels = f["images"].shape[-1]
        n = f["labels"].shape[0]
    out = argv[2] if len(argv) > 2 else lenet.default_params_path(
        num_channels)
    print(f"training on {n} examples ({num_channels} channels), "
          f"{epochs} epochs -> {out}")

    params = train.train(train_path, test_path if has_test else None,
                         num_channels=num_channels, epochs=epochs,
                         batch_size=BATCH_SIZE, checkpoint_dir=None,
                         device=device)
    tl, ta = float("nan"), float("nan")
    if has_test:
        tl, ta = train.evaluate(lenet.params_from_numpy(params, device),
                                train.HDF5Dataset(test_path))
    print(f"final test loss {tl:.4f} acc {ta:.4f}")
    save_checkpoint(params, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
