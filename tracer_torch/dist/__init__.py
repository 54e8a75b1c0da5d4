"""tracer_torch.dist: rendering and gradients across processes on
torch.distributed (port of tracer.dist)."""
