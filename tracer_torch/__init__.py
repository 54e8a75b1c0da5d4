"""tracer_torch: the PyTorch/CUDA port of the `tracer` path tracer.

Same module tree and names as `tracer/`: host-side scene code is copied
NumPy, the renderer is plain PyTorch (the twin of the CUDA kernel), and
the forward megakernel is hand-written CUDA C++ for Hopper
(`csrc/megakernel.cu`, bound in `tracer_torch.kernels.megakernel`).

Every tensor-producing function takes an explicit `device`; the package
keeps no global device state and never imports `jax` or `tracer`.
"""
