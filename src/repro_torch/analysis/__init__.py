"""Analysis of the port: the opt-in sanitizer plane
(:mod:`repro_torch.analysis.sanitize`), the H100 roofline
(:mod:`~repro_torch.analysis.roofline`), the analytic HBM-traffic model
(:mod:`~repro_torch.analysis.analytic`), each hand kernel's work
(:mod:`~repro_torch.analysis.kernel_work`), the ``torch.profiler`` reader
(:mod:`~repro_torch.analysis.profiler`) and the staticcheck twin
(:mod:`~repro_torch.analysis.staticcheck`)."""
