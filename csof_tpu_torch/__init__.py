"""csof_tpu_torch — the PyTorch + CUDA port of csof_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``csof_tpu``, with the same layer
layout. It imports torch and numpy, never jax, flax or yaml.

- :mod:`csof_tpu_torch.config`    — the experiment dataclasses (same fields and defaults)
- :mod:`csof_tpu_torch.compat`    — flax parameter trees -> torch ``state_dict``
- :mod:`csof_tpu_torch.ops`       — warp, correlation, losses, CUDA kernels (``ops/kernels``, ``csrc``)
- :mod:`csof_tpu_torch.models`    — SegFlow and its blocks (NCHW inside)
- :mod:`csof_tpu_torch.inference` — the serving remap and ``FlowPredictor``
- :mod:`csof_tpu_torch.data`      — the cine video chunk loader
- :mod:`csof_tpu_torch.training`  — schedules, optimizer, checkpoints, ``Trainer``

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
