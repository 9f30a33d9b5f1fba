"""csof_tpu_torch — the PyTorch + CUDA port of csof_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``csof_tpu``, with the same layer
layout. It imports torch, numpy and scipy, never jax, flax, optax, msgpack,
yaml, matplotlib or scikit-learn: it reads flax checkpoints and YAML configs
itself (pandas only to read an M&Ms .xlsx table, on that route alone).

- :mod:`csof_tpu_torch.config`    — the experiment dataclasses (same fields and defaults, the
  same ``config.yaml``), plans, dataset folders
- :mod:`csof_tpu_torch.compat`    — flax msgpack reader, flax parameter trees and optimizer
  state -> torch
- :mod:`csof_tpu_torch.ops`       — warp, integration, correlation, losses, tiling,
  resampling, jacobian,
  strain, smoothing, CUDA kernels (``ops/kernels``, ``csrc``)
- :mod:`csof_tpu_torch.models`    — SegFlow, the nnU-Net ``GenericUNet``, RAFT, VoxelMorph,
  FinalFlow, their blocks (NCHW)
- :mod:`csof_tpu_torch.inference` — the serving remap, ``FlowPredictor``,
  ``SlidingWindowPredictor`` and ``predict_case``
- :mod:`csof_tpu_torch.data`      — dataset conversion, cropping, analysis, planning, the
  ``Preprocessor``, the dataset files and split, the U-Net patch loader, the cine datasets
  and video chunk loader, augmentation
- :mod:`csof_tpu_torch.training`  — schedules, optimizer, checkpoints (the port's ``.pt``
  and the JAX package's msgpack), the losses of every model kind, ``Trainer``,
  ``restore_trainer``, fold validation
- :mod:`csof_tpu_torch.evaluation` — segmentation metrics, SSIM and the folder evaluator
- :mod:`csof_tpu_torch.analysis`  — jacobian, strain and contour reports of a Flow tree,
  strain-curve metrics, statistics, per-phase results
- :mod:`csof_tpu_torch.cli`        — the ``csof_torch_*`` commands: convert, plan and
  preprocess, train, predict, predict_flow, evaluate, ensemble, strain, jacobian

Entry points run on the CUDA device unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line).
"""

__version__ = "0.1.0"
