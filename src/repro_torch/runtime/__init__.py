"""Fixed-batch serving steps, the training step and the fault-tolerant
loop (port of ``repro.runtime``)."""
