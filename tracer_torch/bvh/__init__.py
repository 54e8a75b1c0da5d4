"""tracer_torch.bvh: the BVH builder (NumPy, and native C++ when `g++` is
present) and the plain batched traversal (port of tracer.bvh)."""
