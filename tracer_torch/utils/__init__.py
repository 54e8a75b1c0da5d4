"""tracer_torch.utils: retries, profiling and debug guards (port of tracer.utils)."""
