"""repro_torch.data — the synthetic training data pipeline."""
