"""Runtime checks of the PyTorch port: the conflict sanitizer
(:mod:`repro_torch.analysis.sanitize`)."""
