"""Fixed-batch serving steps (port of ``repro.runtime``)."""
