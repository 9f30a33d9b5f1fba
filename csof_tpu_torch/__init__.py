"""csof_tpu_torch — the PyTorch + CUDA port of csof_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``csof_tpu``, with the same layer
layout. It imports torch, numpy and scipy, never jax, flax, yaml or
scikit-learn.

- :mod:`csof_tpu_torch.config`    — the experiment dataclasses (same fields and defaults), plans
- :mod:`csof_tpu_torch.compat`    — flax parameter trees -> torch ``state_dict``
- :mod:`csof_tpu_torch.ops`       — warp, correlation, losses, tiling, resampling,
  CUDA kernels (``ops/kernels``, ``csrc``)
- :mod:`csof_tpu_torch.models`    — SegFlow, the nnU-Net ``GenericUNet``, their blocks (NCHW)
- :mod:`csof_tpu_torch.inference` — the serving remap, ``FlowPredictor``,
  ``SlidingWindowPredictor`` and ``predict_case``
- :mod:`csof_tpu_torch.data`      — cropping, the ``Preprocessor``, the dataset files and
  split, the U-Net patch loader and the cine video chunk loader
- :mod:`csof_tpu_torch.training`  — schedules, optimizer, checkpoints, the SegFlow and
  U-Net losses, ``Trainer``

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
