"""csof_tpu_torch — the PyTorch + CUDA port of csof_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``csof_tpu``, with the same layer
layout. It imports torch, numpy and scipy, never jax, flax, optax, msgpack,
yaml or scikit-learn: it reads flax checkpoints and YAML configs itself.

- :mod:`csof_tpu_torch.config`    — the experiment dataclasses (same fields and defaults, the
  same ``config.yaml``), plans
- :mod:`csof_tpu_torch.compat`    — flax msgpack reader, flax parameter trees and optimizer
  state -> torch
- :mod:`csof_tpu_torch.ops`       — warp, correlation, losses, tiling, resampling,
  CUDA kernels (``ops/kernels``, ``csrc``)
- :mod:`csof_tpu_torch.models`    — SegFlow, the nnU-Net ``GenericUNet``, their blocks (NCHW)
- :mod:`csof_tpu_torch.inference` — the serving remap, ``FlowPredictor``,
  ``SlidingWindowPredictor`` and ``predict_case``
- :mod:`csof_tpu_torch.data`      — cropping, the ``Preprocessor``, the dataset files and
  split, the U-Net patch loader, the cine datasets and video chunk loader, augmentation
- :mod:`csof_tpu_torch.training`  — schedules, optimizer, checkpoints (the port's ``.pt``
  and the JAX package's msgpack), the SegFlow and U-Net losses, ``Trainer``,
  ``restore_trainer``, fold validation
- :mod:`csof_tpu_torch.evaluation` — segmentation metrics and the folder evaluator
- :mod:`csof_tpu_torch.cli`        — ``csof_torch_train``, ``csof_torch_predict``,
  ``csof_torch_predict_flow``, ``csof_torch_evaluate``, ``csof_torch_ensemble``

Entry points run on the CUDA device unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line).
"""

__version__ = "0.1.0"
