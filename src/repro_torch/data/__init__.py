from repro_torch.data.pipeline import DeviceLoader, SyntheticTokens, to_device  # noqa: F401
