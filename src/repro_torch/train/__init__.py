from repro_torch.train.step import TrainState, make_train_step, state_spec  # noqa: F401
