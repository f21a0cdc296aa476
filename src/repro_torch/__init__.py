"""PyTorch/CUDA port of the PecSched serving stack for NVIDIA Hopper.

A second package beside ``repro`` (the JAX reference): the same module
layout, PyTorch idiom inside, and hand-written CUDA kernels in ``csrc/`` in
place of the Pallas TPU kernels.  It imports nothing of ``repro`` or ``jax``;
the scheduler brain (``core/``, ``sp/planner.py``, ``configs/``) is kept as
its own copy, held equal to the reference by ``tests/test_torch_isolation.py``.
"""
