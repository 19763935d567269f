"""Runtime analysis of the port: the opt-in sanitizer plane
(:mod:`repro_torch.analysis.sanitize`)."""
