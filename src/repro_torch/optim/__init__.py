"""repro_torch.optim — the optimizer of the training slice."""
