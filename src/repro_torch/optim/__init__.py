from repro_torch.optim.adamw import adamw_init_spec, adamw_update, lr_schedule  # noqa: F401
