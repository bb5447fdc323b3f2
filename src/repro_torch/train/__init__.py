"""Training: the step factory and the fault guards (counterpart of ``repro.train``)."""
