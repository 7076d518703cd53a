from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: F401
