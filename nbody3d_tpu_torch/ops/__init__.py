"""Physics operators: the hand-written CUDA kernels (``cuda_force``) with
their plain PyTorch twins, the plain oracle (``force_torch``), integrators,
diagnostics, Morton ordering and the step dispatch (``step``)."""
