"""Hopper counterparts of the JAX package's kernel labs (``scripts/``).

Each module carries the name of the script it ports: ``kernel_lab`` (one
vacuum leapfrog step per launch, three variants), ``kernel_lab2`` (k steps
per launch, temporal blocking) and ``pole_lab`` (the f32 FMA ceiling, two
formulations of the ADE pole update and a curl mix on one on-chip window).
Each holds a plain PyTorch version of its function beside the wrapper of
its CUDA kernel (``csrc/lab_*.cu``), and a ``main()`` that times the kernel
on the card: ``python3 -m tidy3d_tpu_torch.labs.kernel_lab`` and so on.
"""
