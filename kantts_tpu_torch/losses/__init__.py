from kantts_tpu_torch.losses.losses import criterion_builder  # noqa: F401
