from repro_torch.data.pipeline import TokenPipeline, prefetch  # noqa: F401
