"""The classifier pipeline's tools (ports of gpd_tpu's ``tools/``):
``gen_dataset`` (a labeled grasp-image set from the synthetic object zoo
and table scenes), ``train_classifier`` (the LeNet trained on it, written
as a packaged checkpoint) and ``slice_channels`` (a 3-channel set cut from
a 15-channel one). Run each with ``python -m gpd_tpu_torch.tools.<name>``.
"""
