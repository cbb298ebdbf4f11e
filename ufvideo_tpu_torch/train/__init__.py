"""Training on one card: losses, the train step with the reference's
optimizer and freezing policy, the ``[SEG]`` loss, LoRA, the data pipeline,
the Trainer and its launcher (``python -m ufvideo_tpu_torch.train``)."""
