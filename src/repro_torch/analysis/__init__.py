"""repro_torch.analysis — the tie-break seam the fabric transport routes
its incidental enumerations through."""
