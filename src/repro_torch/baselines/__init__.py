from repro_torch.baselines.interception import InterceptionCheckpointer  # noqa: F401
