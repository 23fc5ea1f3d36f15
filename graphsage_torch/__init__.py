"""graphsage_torch: the PyTorch + CUDA port of graphsage_tpu, for NVIDIA
Hopper (H100).

The JAX package ``graphsage_tpu`` is the reference; this package imports
nothing of it and nothing of JAX.  Importing it needs neither a card nor
``nvcc``: the CUDA kernels (``graphsage_torch/csrc``) are built at their
first launch, by ``graphsage_torch.ops.build``.

Ported so far: full-graph serving (``graphsage_torch.infer``) with the
gather-mean and gather-max kernels.  ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
