"""CLI: train the grasp classifier (port of gpd_tpu/apps/train_net.py; the
reference's pytorch/train_net3.py).

    python -m gpd_tpu_torch.apps.train_net TRAIN_H5 TEST_H5 NUM_CHANNELS [EPOCHS] [CHECKPOINT_DIR]

Trains on the CUDA card, writes CHECKPOINT_DIR (default "checkpoints")/
lenet_e*_b*.npz after each evaluation and lenet_final.npz, and the
(step, loss, accuracy) of every 100th step to loss_stats.txt.
"""

import sys


def main(argv=None, device=None):
    """Returns 0, or -1 on a usage error. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print("Usage: train_net TRAIN_H5 TEST_H5 NUM_CHANNELS "
              "[EPOCHS] [CHECKPOINT_DIR]")
        return -1

    from gpd_tpu_torch.net.train import train

    train(
        train_path=argv[0],
        test_path=argv[1],
        num_channels=int(argv[2]),
        epochs=int(argv[3]) if len(argv) > 3 else 10,
        checkpoint_dir=argv[4] if len(argv) > 4 else "checkpoints",
        log_file="loss_stats.txt",
        device=device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
