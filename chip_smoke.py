#!/usr/bin/env python3
"""Drive the PyTorch port's SegFlow serving and training paths and its
nnU-Net 2D serving and training paths once on one NVIDIA GPU, then SegFlow
under the JAX package's kernel switches and in its other configurations,
then the port's command line, its strain analysis and its data plane, then
the nnU-Net 3d_fullres U-Net's training and serving and the cascade, then
the flow models: RAFT, VoxelMorph and FinalFlow; model selection,
postprocessing and the model zoo on phase 23's folds; MTL, Swin, the
temporal and the deformable models; the generative family, UDA and the
policy search; last, data-parallel training and sharded serving over
torch.distributed.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: the card's name and power limit (nvidia-smi); TF32 off for the
   float32 checks. Without a CUDA device the script exits non-zero.
2. build: compile the CUDA kernels (K1 corr, K2 corr backward, K3 skip fuse,
   K4 NCC map, K5 norm + activation, K6 3x3 conv) from csof_tpu_torch/csrc,
   one nvcc per source, all started together; then count the tensor-core
   instructions (HGMMA) of K6's forward and dx and of K3's conv pass in the
   library's SASS (csof_tpu_torch/sass_census.py): each must have some.
3. kernels: each kernel against its plain PyTorch version at the three
   SegFlow level geometries (K1, K3: B=8; K2: the training batch, B=4;
   radius 4), two ragged shapes, and shapes across the edges of their
   tilings (K1, K3: W, H, C, F = 12 and 130, strides 1-3, radius 1-4, B 1
   and 8; K2: C 1-130, W 1-129, H 1 and 17, strides 1-3, radius 1-4, B 1
   and 4, and tensors off the 16-byte grid), in float32 and bfloat16, with
   the median time of kernel and plain version in both dtypes, K3's library
   conv over the concat and the whole K3 chain as library calls, K3's
   device time by pass and K2's by level (torch.profiler); K3 and K2 twice
   on the same inputs must give the same bits; the correlation's autograd
   gradients on the card (K1 forward, K2 backward) against autograd of the
   plain forward.
4. serving: the flagship SegFlow (bench geometry, bfloat16, 4 classes, random
   weights from a seed) serves 3 synthetic cine requests through
   predict_and_export_case; the output files must exist, all outputs must be
   finite, and each request must launch K3 (and K1) 136 times.
5. parity: the same full-width weights, float32, one (1, 3, 128, 128, 1)
   video: the GPU forward (kernels) against the CPU forward (plain versions).
6. throughput: forward at (8, 12, 128, 128, 1) bfloat16, frames/s from the
   median of 10 timed forwards.
7. train, 8. train parity: 14 steps of Trainer.run_training at full width,
   and the float32 loss and gradients GPU vs CPU.
9. unet kernels: K5 and K6 against their plain versions at every distinct
   shape of one Task002 2d U-Net forward (batch 32) and ragged shapes (K5:
   each side of every threshold of its plan, warp, block and clusters of 2,
   4 and 8, also off the 16-byte grid; K6: across every tile edge of its
   tensor-core tiling, with and without bias, out_f32 on bf16), in float32
   and bfloat16, with the median time of kernel, plain version and library
   call (K6: F.conv2d; K5: F.instance_norm + F.leaky_relu, a two-call note)
   and K5's device time (torch.profiler); K5 twice on the same inputs must
   give the same bits; K6's bound as 3xTF32 (float32) and bf16 on the
   tensor cores, the FP32-core bound as a note.
10. unet serving: the full-width Task002 2d U-Net (2 classes, float32,
   random weights, both kernel switches on) serves 2 synthetic cases
   (1, 40, 320, 320) at 1.25 mm in plane through predict_case; outputs
   finite, files written, 26 K5 and 7 K6 launches per forward.
11. unet parity: float32 logits of 2 tiles, GPU (kernels) vs CPU (plain
   versions), and the shapes each kernel was launched at.
12. unet throughput: slices/s of predict_2d_stack (host clock, median of 5)
   and the CUDA-event time of one batch-32 forward.
13. unet train kernels: K6's backward (Conv3x3Function: dx by K6 on the
   flipped weight, dw and db by the library) against autograd of the plain
   version at the 4 distinct dx shapes of a Task002 2d training step (batch
   40) and ragged shapes across the tile edges, float32 and bfloat16; the
   dx time beside the plain version's and cuDNN's dgrad
   (torch.nn.grad.conv2d_input) and the bounds. Then K7 and K7 dx (the
   native norm and activation, csrc/inorm_lrelu.cu) at the 26 blocks of a
   training step (batch 40): y, mean, rstd, dz and the per-plane sums
   against the plain versions in float64 (the backward on the kernel's
   signs), both twice on the largest planes (the same bits), and each
   kernel's time and device time beside the float32 plain version's, the
   eager path's and the bound.
14. unet train: 4 synthetic Task002-like cases (1, 40, 320, 320) through
   run_cropping -> Preprocessor.run -> unpack_dataset -> load_dataset ->
   do_split -> SegPatchLoader, then Trainer.run_training of the full-width
   Task002 2d U-Net (float32, SGD-Nesterov + poly, CSOF_CONV2D_IMPL=pallas)
   at batch 40 x 320x256: 2 epochs x 6 steps + 2 validation batches;
   finite losses, a fg-dice in the log, 7 K6 + 6 K6-dx + 26 K7 + 26 K7-dx
   launches per step (7 K6 + 26 K7 a validation batch), the checkpoint
   triad written and reloaded; train slices/s.
15. unet train parity: full width, batch 2 of 320x256, float32: the GPU
   loss and every parameter gradient against the CPU's.
16. ncc: K4 against its plain version at 20 and 88 planes of 128^2 (the
   SegFlow loss at its training batch, B=4 x 5 frames, and at the bench
   geometry, 8 cines x 11 frames), ragged H and W (1, 17, 33, 129), planes
   wider than a block (column tiles), windows 1, 4, 8, 9, 15, 21, 31 (even,
   above 15, one wider than the plane), and tensors off the 16-byte grid in
   float32 and bf16; window 9's division without a divide against IEEE
   division for every float32; at both timed shapes the map's and the loss's
   CUDA-event, device and host time a call beside the bound; the map twice
   and the loss three times must give the same bits, and ncc_loss_kernel
   must be one launch a call, all of one device kernel (torch.profiler over
   ten calls, in a fresh process); then
   ncc_loss_kernel, the op's entry point, driven alone against the port's
   ncc_loss (C = 1, C = 3, bf16).
17. segflow pallas serving: the flagship serving forward (bench geometry,
   bf16, fused_cm, full width) with CSOF_CONV2D_IMPL=pallas: 87 K6 launches
   (the JAX package's routed convs; tests/test_torch_segflow_k6.py holds
   the count against JAX's) beside 34 K3 and K1; host clock with the switch
   off and on; a float32 forward at the same widths GPU vs CPU.
18. segflow pallas train: Trainer steps at 4 x 6 x 128^2, bf16, concat +
   deep supervision, the switch read by build_model (off, then on): 16 K1 +
   16 K2, and 55 K6 + 52 K6 dx a step under pallas; host clock both ways;
   then the float32 loss and every gradient GPU vs CPU at (1, 4, 128, 128).
19. segflow modes: split + fuse_q_hoist, project, mean1, the linear
   decoder and remat, each one loss forward + backward at full width, batch
   1 x 4 x 128^2, float32, under pallas, GPU vs CPU (K6 counts from the
   model, remat's recomputation included); then norm="instance" with K5
   (CSOF_FUSED_NORM=1), forward only, and K5 alone against its plain
   version at each shape SegFlow gave it (float32 and bf16).
20. segflow convs: K6 and its dx at every distinct shape phases 17 and 18
   gave them (Ci 1, 6, 32, 64, 128, 145, 209), bf16 and float32 against the
   plain versions; the bf16 K6 time of one serving forward and the dx time
   of one training step beside the plain version's, the library call's and
   the bound.
21. ncc wide: K4 at windows above 75 (101 on 4 x 64 x 1000, 127 on 20 x
   128^2; F9): the two-pass path's map and loss against the plain version,
   with times and bounds; the two-pass path counts two launches a call.
22. cli: the command line through its entry functions, at full width, on
   inputs written with the port's NIfTI writer (3 cines of 12 x 8 x
   160x176 with ED/ES labels and dataset.json; 2 Task002-like cases of 16
   slices, preprocessed as phase 14 preprocesses): csof_torch_train on
   SegFlow (default widths, bf16, the video augmentation, batch 4 x 6 x
   128^2, 2 epochs x 3 steps: 16 K1 + 16 K2 a step, the sidecars and the
   final checkpoint), csof_torch_predict_flow on that folder (3 cines, TTA,
   fused_cm: 136 K3 a cine; the Flow, Registered and Segmentation files),
   csof_torch_train on the Task002 2d U-Net (the default config,
   augmentation on, CSOF_CONV2D_IMPL=pallas, 1 epoch x 4 steps at batch 40
   x 320x256: 7 K6 + 6 K6 dx + 26 K7 + 26 K7 dx a step), --validation-only
   (summary.json; 7 K6 + 26 K7 a forward),
   csof_torch_predict on 2 cases with both kernel switches (26 K5 + 7 K6 a
   forward), csof_torch_evaluate and csof_torch_ensemble on those outputs;
   then one cine from the same SegFlow folder, float32 without TTA, on the
   card and on the CPU (Flow and Registered within phase 5's tolerance).
   Each command's launches are counted alone; its host seconds are printed
   beside the card's name and power limit; last, the CUDA-event time of
   augment_batch_2d at a U-Net batch and augment_video at a SegFlow batch.
   Then the strain analysis of the predict_flow tree: csof_torch_strain
   (with ground-truth labels for contour tracking) and csof_torch_jacobian
   on the card, csof_torch_strain with --device cpu on the same tree
   (analysis.json within STRAIN_TOL; the border-category histograms and
   perimeters of the labels' masks equal on both devices; gaussian_smooth
   equal on both, TF32 allowed), and strain_curve_metric of the exported
   curve folder against itself (every distance zero).
23. data plane: make_synthetic_acdc at ACDC size (4 patients, 8 frames of
   10 x 224 x 256 at 1.5 x 1.5 x 5 mm), csof_torch_convert_acdc,
   csof_torch_plan_and_preprocess with 4 worker processes (started after
   this process used CUDA) and with 1, into two roots: every plans file,
   .npz (member by member) and .pkl equal; the plans printed; then
   csof_torch_train on the planned 2d U-Net under CSOF_CONV2D_IMPL=pallas
   (the K6, K6-dx, K7 and K7-dx launches GenericUNet.kernel_launches gives
   at the planned patch and batch), csof_torch_predict on 2 cases with both kernel
   switches (K5 and K6 counted) and csof_torch_evaluate; every command's
   host seconds. Last, K5, K6 and K6 dx against their plain versions
   (float32 and bfloat16, phase 9's tolerances) at every distinct shape the
   planned U-Net's training and serving gave them. Then the planned 3D
   U-Net of the same root (plans_3D.json, preprocessed_3d/): csof_torch_train
   3 steps + 1 validation batch under pallas with CSOF_FUSED_NORM=1 set (no
   K5 on a 3D net), csof_torch_predict on 2 cases, csof_torch_evaluate, the
   K6 and K6-dx launches GenericUNet.kernel_launches gives.
24. unet3d train: the Task002 3d_fullres U-Net (task002_heart_3d: patch
   80x192x160, batch 2, base 32, cap 320, float32, deep supervision) on 3
   synthetic cases of 115 x 320 x 232 at its spacing (written, cropped and
   preprocessed): csof_torch_train (SGD-Nesterov + poly, clip 12, 3 steps + 1
   validation batch, pallas, CSOF_FUSED_NORM=1 set): 17 K6 a forward and 16
   K6 dx a step, in the z taps; then Trainer steps with the switch off and
   on and remat at its default (save_conv) and off: host ms a step and peak
   device memory.
25. unet3d serving: csof_torch_predict on 2 of those cases with mirror TTA
   (8 variants) and the switch on, at predict_case's tile batch for 3-D
   plans (TILE_BATCH_3D): 17 K6 a forward, the labels written, the peak
   device memory; then one forward's peak memory and time at 1, 2 and 4
   tiles x 8.
26. unet3d parity: the 3d_fullres U-Net's float32 logits of one 80x192x160
   patch GPU vs CPU (MODEL_TOL), and the loss and every gradient of a
   training step on 1 x 32x96x96 (17 K6 + 16 dx), the CPU replaying the
   GPU's LeakyReLU slopes as in phase 15.
27. unet3d kernels: K6 and K6 dx against their plain versions at every
   distinct z-tap shape phases 23-26 gave them (float32, bf16, bf16 with
   the float32 output of (3, 3, 3) taps); their times at the Task002
   3d_fullres tap shapes (kernel_times.k6_3d_times) beside the plain
   versions, F.conv3d and conv3d_input of the routed convs (the library
   calls), the tap route vs F.conv3d per conv, and the bounds.
28. cascade: csof_torch_plan_and_preprocess of 4 isotropic phantoms of
   64x96x96 with the 3D budget cut to 1e6 (a two-stage plan):
   preprocessed_3d holds the fullres stage, preprocessed_3d_lowres stage 0;
   predict_next_stage with the lowres U-Net on the card and on the CPU
   (equal files, or differing only at ties of the softmax); one forward of
   the fullres U-Net on concat_prev_stage's input.
29. raft: RAFT at RaftModelConfig() (feature 256, hidden and context 128,
   4 levels, radius 4, 12 iterations, bf16, random weights) serving 8 ED->ES
   pairs at 224^2 (the JAX package's sweep geometry): CUDA-event ms a
   forward, pairs/s, the device busy share (traced in a fresh process, as
   phase 30's and 31's), peak memory, no kernel of the port launched; one
   pair float32 card vs CPU; scan_unroll=-1 (fault F4)
   runs and gives scan_unroll=1's flows; csof_torch_train raft on phase 22's
   cines (default config, 3 steps + 1 validation batch at 4 x 6 x 128^2);
   one supervised Trainer step with flow_gt from a known smooth warp; the
   float32 loss and every gradient of both routes card vs CPU (1 pair of
   64^2; phase 8's tolerances, the CPU replaying the card's ReLU signs; a
   leaf whose float64 gradient is zero held to phase 8's tolerance of the
   model's largest entry).
30. voxelmorph: VoxelMorph at VoxelMorphModelConfig() (diffeomorphic, 7
   steps, bf16): register_sequence over a 17-frame cine at 192^2 (16 pairs)
   with its ms, pairs/s, busy share and peak memory; the flows' Jacobian
   determinants card vs CPU; one 3-D pair of 10 x 224 x 256 (z padded to
   16); csof_torch_train voxelmorph as phase 29 trains RAFT; the float32
   loss and gradients card vs CPU as phase 29's.
31. finalflow: FinalFlow at FinalFlowConfig() over 8 cines x 12 frames x
   128^2 bf16: each bottleneck (gru, 3d, transformer) and gru with
   diffeomorphic=True, with CSOF_CONV2D_IMPL unset and =pallas (56 K6 a
   forward, counted by the wrapper and as device events in a fresh process,
   equal to FinalFlow.kernel_launches), norm="instance" with CSOF_FUSED_NORM=1 (63
   K5); K6 and K5 against their plain versions at every distinct shape these
   forwards gave them, float32 and bf16, with one forward's kernel, plain,
   library and bound ms; each bottleneck's float32 forward under pallas card
   vs CPU at 1 x 6 x 128^2.
32. nnunet tail (run inside phase 23's folder, after it): the planned 2d
   and 3d U-Nets predict phase 23's served cases with --save-npz (both
   softmaxes at the cropped original geometry, as JAX compares them; the
   3d_fullres U-Net of phases 24-27 and the 2d U-Net of phase 14 trained
   on other cases); csof_torch_find_best_configuration over the two and
   their ensemble, csof_torch_determine_postprocessing on the 2d
   predictions; csof_torch_export_model_to_zip -> install_model_from_zip
   of the 2d fold, whose predictions must be the same bits;
   print_available_models, change_model, plot_task_pngs; the fold's
   debug.json, network_architecture.txt, progress.png (decoded, 1000 x
   600) and timestamped training log; each command's host seconds.
33. family: MTL (conv and Swin encoders, reconstruction and directional
   field, MTLConfig() widths, 16 x 256 x 224), the temporal model (8 cines
   x 12 frames x 128^2, 12 frames past its bus of 8) and the deformable
   layer (d = 128, 32 x 32 maps, batch 96), float32 and bf16, the switches
   off and on (with instance norm: CSOF_FUSED_NORM=1 too): K6 and K5
   launches = kernel_launches = a fresh process's device events (float32
   instance norm with the switches off: K7 in each block K5 runs with them
   on), outputs
   on vs off, ms a forward, peak memory, busy share; K6 and K5 vs plain at
   every shape these forwards gave them; float32 card vs CPU at batch 1.
34. generative: the generative family, UDA and the policy search at the
   JAX package's default widths, float32, random weights
   (csof_tpu_torch/profile_generative.py GEN_RUNS): the DDPM denoiser
   (DiffusionConfig(): T = 1000, features 32/64/128) on 16 x 128^2,
   unconditional and with a 4-class one-hot condition; latent diffusion over
   KLAutoencoder()'s 32^2 x 4 latents and the autoencoder's decode; the
   ControlNet at 128^2 with a 4-channel hint and on the 32^2 latents with
   the 128^2 hint (antialiased resize); VQVAE(); SwinGenerator() ->
   SwinDiscriminator() at batch 16; UDA with the Task002 2d U-Net on 8 + 8
   images of 320 x 256; PolicyNet(). Each forward and training step under
   CSOF_CONV2D_IMPL=pallas: K6 and K6 dx (UDA's U-Net: K7 and K7 dx too)
   launches = kernel_launches = a fresh process's device events
   (profile_generative --launches); latent diffusion's sample (50 steps at
   batch 4) and decode, its seconds; the forwards switch on vs off
   (MODEL_TOL); ms a forward and a step (off, on, on, off), peak memory,
   busy share; the ControlNet's base parameters the same bits after a
   step; each forward and step card vs CPU at batch 1
   (the step's losses and every gradient at phase 8's bound, the CPU
   replaying the card's signs); K6 and K6 dx vs plain at every shape these
   runs gave them, with one DDPM forward's and one DDPM step's times.
35. parallel: (a) NCCL at world 1 (an in-process store): phase 7's SegFlow
   (bf16, full width, 4 x 6 x 128^2, K1 + K2) through Trainer under DDP for
   2 steps against two unwrapped trainers on the same batches: losses and
   parameters within twice the unwrapped runs' spread, step-1 gradients at
   phase 8's bound; (b) the Task002 2d U-Net step (batch 40 x 320x256,
   CSOF_CONV2D_IMPL=pallas: K6 + dx, K7 + dx) under DDP with the batch Dice through
   the gather, against the step without a process group (loss, gradients,
   the SGD parameters); (d) predict_sharded of one 320^2 slice with mirror
   TTA under both kernel switches (K5, K6) against predict; DDP and
   sharded host ms beside the unwrapped ones; (c) gloo at world 2 with both
   ranks on the card (two spawned processes): SegFlow float32 with the video
   augmentation on 2 + 2 videos against world 1 on 4 (loss, all-reduced
   gradients); (e) csof_torch_train under torchrun's variables at world 1
   (NCCL) on phase 23's root: one log, the checkpoints and debug.json with
   the mesh; (f) the native host library (csof_tpu_torch/native) built with
   g++: its gather and min-max against the numpy branches, host ms of both.
   Every launch of the phase counts under "parallel".

Then the script's total seconds, one JSON line with each kernel's launches, error and times, and, last,
the device line. Any failure exits non-zero before the last line.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np

RADIUS = 4
BATCH = 8
TRAIN_BATCH, TRAIN_T, TRAIN_HW = 4, 6, 128
#: (C, H, W, stride) of the three SegFlow skip levels at the 128^2 ROI
LEVELS = [(32, 128, 128, 2), (64, 64, 64, 1), (128, 32, 32, 1)]
RAGGED = [(32, 24, 24, 1), (16, 20, 36, 2)]
#: K1 and K3 across their tilings' edges, (B, C, F, H, W, radius, stride):
#: W 5, 23, 33, 65, 70, 129 (no multiple of K1's 32 or K3's 64 columns; 5,
#: 23, 33, 65, 129 no multiple of K1's 16-byte group either), H 3, 9, 13,
#: 17 (no multiple of the rows a block), C 7, 12, 20 (K3's channel chunks
#: straddle q, m and corr), F 12 (6 groups) and 130 (two N blocks), strides
#: 1, 2 and 3, radius 1 to 4, B 1 and 8
TILING_RAGGED = [(1, 12, 12, 17, 70, 4, 1), (8, 12, 12, 9, 33, 4, 2), (2, 20, 40, 13, 65, 3, 3),
                 (1, 32, 32, 5, 129, 1, 1), (8, 7, 130, 3, 23, 2, 2), (1, 64, 64, 17, 5, 4, 1)]
#: K2 across its tiling's edges (32 x 4 tiles, 32 channels a block in
#: stages of 32 / 16 / 8), (B, C, H, W, radius, stride): C 1, 8, 13, 40, 130,
#: W 1, 17, 33, 129 (element copies) and 48, 64 (16-byte copies), H 1 and
#: 17, strides 1-3, radius 1-4, B 1 and 4
K2_TILING_RAGGED = [(1, 1, 17, 33, 4, 2), (4, 8, 1, 129, 4, 1), (1, 13, 17, 17, 3, 3),
                    (4, 130, 17, 1, 1, 1), (1, 13, 1, 1, 2, 2), (4, 8, 17, 129, 2, 3),
                    (1, 130, 17, 33, 4, 2), (4, 40, 17, 48, 3, 1), (1, 64, 17, 64, 4, 2)]
#: (atol, rtol) per check. K1, K2: the kernel and the plain version round the
#: same float32 sum taken in another order, so bfloat16 may differ by one
#: unit in the last place (2^-7 relative; K2's sums of 81 terms are larger,
#: hence its larger atol). K3: a one-ulp flip of a bfloat16 pre-norm value
#: is scaled by 1/std of its group.
TOL = {
    ("K1", "float32"): (1e-4, 1e-4),
    ("K1", "bfloat16"): (1e-2, 1e-2),
    ("K3", "float32"): (1e-4, 1e-4),
    ("K3", "bfloat16"): (5e-2, 5e-2),
    ("K2", "float32"): (1e-4, 1e-4),
    ("K2", "bfloat16"): (2e-2, 1e-2),
}
MODEL_TOL = (2e-3, 2e-3)  # GPU vs CPU float32 forward: reduction order only
#: GPU vs CPU float32 loss (relative) and gradients (|diff| <= GRAD_TOL *
#: max|leaf| + 1e-6 per leaf): reduction order only, as in the CPU tests
#: against JAX
LOSS_RTOL, GRAD_TOL = 1e-4, 2e-3
#: a leaf whose float64 gradient is at most this share of the model's
#: largest entry has an exact gradient of zero (loss_grad_parity)
ZERO_GRAD = 1e-10
T_FRAMES, DEPTH, CINE_HW = 12, 8, (160, 176)
#: K5 and K6 (atol, rtol): the same float32 sums in another order; bf16
#: rounds once (K5: one bf16 ulp after a normalization by 1/std; K6: the
#: conv sum and the bias add)
UNET_TOL = {
    ("K5", "float32"): (2e-5, 2e-5),
    ("K5", "bfloat16"): (2e-2, 8e-3),
    ("K6", "float32"): (1e-4, 1e-4),
    ("K6", "bfloat16"): (2e-2, 1e-2),
}
#: ragged shapes beside the served ones: K5 (N, C, H, W), K6 (N, Ci, Co, H,
#: W, bias, out_f32 on bf16): Ci 1, 13, 130 (not a multiple of the k step,
#: more than one chunk), Co 5, 40, 128, 130 (more than one block), W 1, 23,
#: 65, 70, 129 across the 64-pixel tiles, H 1 and 17
K5_RAGGED = [(3, 7, 33, 129), (5, 3, 17, 9)]
#: K5 on each side of every threshold of norm_act_plan (N, C, H, W): 4 KB
#: planes (warp / block), then slices of 80 KB (float32: a block / 2 / 4 / 8;
#: bf16: a block / 2 / 4); 1025, 2049, 20481, 40961, 81983 elements put
#: planes off the 16-byte grid
K5_PLAN_EDGES = [(2, 3, 32, 32), (2, 3, 1, 1025), (2, 3, 1, 2049), (2, 3, 128, 160),
                 (2, 3, 1, 20481), (1, 3, 160, 256), (1, 3, 40961, 1), (1, 2, 320, 256),
                 (1, 2, 257, 319)]
K6_RAGGED = [(3, 13, 40, 17, 23, True, False), (2, 1, 5, 9, 70, True, False),
             (2, 130, 130, 17, 129, True, False), (2, 1, 128, 1, 65, False, False),
             (3, 13, 5, 17, 1, True, True), (2, 130, 40, 1, 70, False, True),
             (2, 1, 130, 17, 23, False, False)]
UNET_CASES, UNET_DEPTH, UNET_HW, UNET_SPACING = 2, 40, (320, 320), 1.25
UNET_TILE_BATCH = 8  # PredictorConfig's default, which predict_case serves with
#: K6's backward beside the training dx shapes: forward convs (N, Ci, Co, H,
#: W), whose dx conv is (Co, Ci): Ci' 1, 13, 130 and Co' 5, 40, 128, 130
K6_BWD_RAGGED = [(3, 13, 40, 17, 23), (2, 5, 9, 9, 70), (2, 130, 1, 17, 65),
                 (1, 128, 130, 1, 129), (2, 40, 13, 17, 1), (2, 5, 130, 1, 70)]
#: dx, dw, db (atol as a fraction of max|ref|, rtol): the same sums in another
#: order (float32); bf16: dx rounds once as the plain version, dw is rounded
#: to bf16 as the JAX VJP rounds it where autograd of the plain version is not
K6_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
UNET_TRAIN_CASES = 4
UNET_TRAIN_EPOCHS, UNET_TRAIN_STEPS, UNET_VAL_STEPS, UNET_TRAIN_WARMUP = 2, 6, 2, 2
#: K4 (N, H, W, window): the SegFlow loss's B=4 x (T-1)=5 planes of 128^2 and
#: the bench geometry's 8 x 11 (both timed), ragged H and W (1, 17, 33, 129),
#: planes wider than a block (257, 600: column tiles), windows 1, 4, 8, 9, 15,
#: 21, 31 (even, above 15, one wider than the plane)
NCC_CASES = [(20, 128, 128, 9), (88, 128, 128, 9), (3, 33, 70, 9), (2, 17, 9, 9),
             (2, 1, 33, 1), (2, 17, 129, 4), (1, 129, 17, 31), (1, 17, 129, 15), (1, 9, 7, 21),
             (1, 20, 600, 31), (2, 17, 257, 8)]
NCC_TIMED = (20, 88)  # planes of 128^2, window 9
#: K4 on tensors one element past the 16-byte grid (the kernel's element copies)
NCC_UNALIGNED = [(3, 33, 70, 9), (2, 17, 129, 4)]
NCC_ATOL = 1e-4  # cc in [0, ~1]; the same operations, division by a reciprocal in the plain
LAUNCHES_PER_REQUEST = 136  # 34 skip fuses per forward x 4 TTA forwards
#: K1 (forward) and K2 (backward) per train step: the frame-0 prime step
#: runs only the bottleneck level's skip fuse, every later frame all three
CORR_PER_STEP = 1 + 3 * (TRAIN_T - 1)
TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH, TRAIN_WARMUP = 2, 7, 2
#: K6 launches of the flagship under CSOF_CONV2D_IMPL=pallas, as the JAX
#: package routes its Pallas conv (tests/test_torch_segflow_k6.py holds the
#: port's count against JAX's): a serving forward of 12 frames (the
#: encoders' level-0 convs and level 1's second, the decoders' four convs,
#: level 2 never: 128 channels), and (forward, dx) of a concat training step
#: of 6 frames (the skip fuses of levels 0 and 1 too; no dx for the query
#: encoder's first conv nor the memory encoder's first at frames 0 and 1)
PALLAS_SERVING_K6 = 3 + 4 + 3 * T_FRAMES + 4 * (T_FRAMES - 1)
PALLAS_TRAIN_K6 = (55, 52)
PALLAS_TRAIN_STEPS, PALLAS_TRAIN_WARMUP = 5, 2
#: the configurations beside concat and fused_cm, phase 19
MODES = [("split + fuse_q_hoist", dict(corr_fuse="split", fuse_q_hoist=True)),
         ("project", dict(corr_fuse="project")), ("mean1", dict(corr_fuse="mean1")),
         ("dec_upsample linear", dict(dec_upsample="linear")), ("remat", dict(remat=True))]
#: K4 windows above 75 (F9), (N, H, W, window): 101 on 1000-wide planes and
#: 127 on the SegFlow loss's 20 planes of 128^2
NCC_WIDE = [(4, 64, 1000, 101), (20, 128, 128, 127)]
#: phase 22, the command line: 3 cines (T_FRAMES x DEPTH x CINE_HW) with
#: labels at ED and ES (1-based frame numbers); SegFlow trained 2 epochs x 3
#: steps with 1 validation batch an epoch; the U-Net 1 epoch x 4 steps + 1
#: validation batch on 2 Task002-like cases of 16 slices (the reduced depth)
CLI_CINES, CLI_ED_ES = 3, (1, 7)
CLI_FLOW_EPOCHS, CLI_FLOW_STEPS, CLI_FLOW_VAL = 2, 3, 1
CLI_UNET_CASES, CLI_UNET_DEPTH, CLI_UNET_STEPS, CLI_UNET_VAL = 2, 16, 4, 1
#: the strain analysis card vs CPU (rtol, atol): float32 reductions in
#: another order; a strain in percent carries 100x a thickness's rounding
STRAIN_TOL = (1e-5, 1e-4)
#: phase 33, bf16 forwards with the switches on vs off: within this many
#: times the largest difference of the switches-off bf16 forward from the
#: float32 one (bf16's own rounding at that model, measured in the run): K6
#: and cuDNN (K5 and the plain norm) each round a bf16 output once, and a
#: one-ulp change moves every layer after it
FAMILY_BF16_FACTOR = 3.0
#: phase 33's forwards timed per median (20 cost the phase about 13 s more)
FAMILY_REPS = 10
#: phase 34's training steps timed per median
GEN_STEP_REPS = 5
#: phase 23, the data plane at ACDC size: ACDC cines hold about 10 slices of
#: 200-260 pixels at 1.5 x 1.5 x 5 mm; 4 patients (8 ED/ES cases), the
#: planned U-Net trained 1 epoch x 3 steps + 1 validation batch, 2 cases served
DP_PATIENTS, DP_FRAMES, DP_SHAPE = 4, 8, (10, 224, 256)
DP_WORKERS, DP_STEPS, DP_VAL, DP_PREDICT = 4, 3, 1, 2
#: phases 24-27, the Task002 3d_fullres U-Net (task002_heart_3d: patch
#: 80x192x160, batch 2, base 32, cap 320, float32): synthetic volumes of 115 x
#: 320 x 232 at its spacing (a Task002 volume after 3d_fullres resampling;
#: cut: 3 cases to train, 2 to serve, never smaller volumes); csof_torch_train
#: 1 epoch x 3 steps + 1 validation batch, then Trainer steps (2 warm-up, 3
#: timed) with the switch off and on, remat at its default and off
U3_CASES, U3_SHAPE, U3_SPACING_ZYX = 3, (115, 320, 232), (1.37, 1.25, 1.25)
U3_STEPS, U3_VAL, U3_WARMUP, U3_TIMED, U3_PREDICT = 3, 1, 2, 3, 2
#: K6 and K6 dx launches of one 3d_fullres forward / training step under
#: pallas: level 0's two (1, 3, 3) encoder convs one z tap each and its two
#: (3, 3, 3) decoder convs three each, level 1's stride-1 encoder conv and two
#: decoder convs three each (tests/test_torch_unet3d.py holds the port's count
#: against JAX's traced Pallas calls); no dx for the first conv's tap
U3_K6, U3_K6_DX = 17, 16
#: the training-step parity patch, cut so that the CPU side stays short
#: (level 1 is 48 wide: K6 still routes there, the same 17 + 16 launches)
U3_PARITY_PATCH = (32, 96, 96)
#: tile batches whose forward's peak memory phase 25 measures (x 8 mirrors)
U3_TILE_BATCHES = (1, 2, 4)
#: phase 28, the cascade: isotropic phantoms of about phase 23's voxels a case
#: (64 x 96 x 96 = 590k, ACDC's 10 x 224 x 256 = 573k; ACDC's 5 mm slices
#: stall the planner's patch shrinking, so its 3D plans get no lowres stage),
#: the 3D budget cut to 1e6 as the F10 test cuts it
CASCADE_CASES, CASCADE_SHAPE, CASCADE_BUDGET = 4, (64, 96, 96), 1e6
#: phase 29, RAFT at the JAX package's serving sweep geometry
#: (tools/bench_raft_sweep.py b8_*: 8 ED->ES pairs at 224^2); the float32
#: loss and gradients card vs CPU on 1 pair of 64^2 (8 x 8 at 1/8, 4 levels)
RAFT_PAIRS, RAFT_HW, RAFT_REPS, RAFT_PARITY_HW = 8, 224, 5, 64
#: phases 29-30: csof_torch_train of RAFT and VoxelMorph on phase 22's cines,
#: 1 epoch x 3 steps + 1 validation batch at TRAIN_BATCH x TRAIN_T x TRAIN_HW^2
FLOW_TRAIN_STEPS, FLOW_TRAIN_VAL = 3, 1
#: phase 30, VoxelMorph: register_sequence over a 17-frame cine at 192^2 (16
#: pairs, tools/bench_all.py:104's geometry) and one 3-D pair at phase 23's
#: ACDC geometry (10 x 224 x 256)
VXM_T, VXM_HW, VXM_3D = 17, 192, (10, 224, 256)
#: phase 31, FinalFlow at bench.py:98's geometry (8 cines x 12 frames x
#: 128^2); its float32 GPU-vs-CPU forwards at 1 cine x 6 frames
FF_B, FF_T, FF_HW, FF_PARITY_T = 8, 12, 128, 6


#: phase 35, data parallel over torch.distributed: the steps compared with
#: and without DDP, the rounds of timed steps (a, b, b, a), and the softmax
#: tolerance of predict_sharded against predict on the card (the tiles
#: forwarded in other batch compositions: cuDNN's float32 sums in another
#: order, a few ulp of a logit)
PAR_STEPS, PAR_ROUNDS, PAR_PROBS_ATOL = 2, 3, 1e-4


class PhaseError(RuntimeError):
    pass


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(label: str, name: str, got, ref, atol: float, rtol: float) -> float:
    """Print the max abs and rel error; fail outside atol + rtol * |ref|."""
    import torch

    got, ref = got.float(), ref.float()
    expect(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    expect(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * ref.abs()).all())
    phase(label, f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=atol {atol:g} + rtol {rtol:g} -> {'ok' if ok else 'FAIL'}")
    expect(ok, f"{name}: outside tolerance")
    return max_abs


def compare_by_plane(label: str, name: str, got, ref, rel: float) -> float:
    """``compare`` for an (N, C, H, W) tensor whose planes differ in scale
    (a constant plane's gradient is 1/sqrt(eps) times the others'): fail
    where |got - ref| > rel (|ref| + max |ref| of its plane). Returns the max
    abs error."""
    import torch

    got, ref = got.double(), ref.double()
    expect(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    expect(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    scale = ref.abs().amax((2, 3), keepdim=True)
    worst = float((diff / (ref.abs() + scale).clamp_min(1e-30)).max())
    max_abs = float(diff.max())
    phase(label, f"{name}: max_abs_err={max_abs:.3e}, worst |diff| / (|ref| + plane max) "
          f"{worst:.3e}, tol {rel:g} -> {'ok' if worst <= rel else 'FAIL'}")
    expect(worst <= rel, f"{name}: outside tolerance")
    return max_abs


def unaligned(t):
    """t's values in a contiguous tensor that starts one element past a
    16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def timed_pair(kern, plain, reps: int = 20) -> tuple[float, float]:
    """Median ms of kernel and plain version (``reps`` calls each time), in
    the order plain, kernel, kernel, plain, so that drift cancels in the
    pair."""
    p1, t1 = median_ms(plain, reps), median_ms(kern, reps)
    t2, p2 = median_ms(kern, reps), median_ms(plain, reps)
    return (t1 + t2) / 2, (p1 + p2) / 2


def k3_pass(name: str) -> str:
    """K3's pass of a kernel it launches: K1, the conv pass, the apply pass,
    or the rest (the wrapper's weight packing)."""
    return ("k1_pass" if "corr_kernel" in name else "conv_pass" if "fuse_conv_kernel" in name
            else "apply_pass" if "gn_apply_kernel" in name else "packing")


def check_kernels(card: str) -> dict:
    """Phase 3. Returns per kernel: max abs error over all checks, the
    summed bf16 time of kernel and plain version over the three level shapes
    (one SegFlow step), its bound (csof_tpu_torch/bounds.py) at those shapes,
    and (K3) the library conv's time and the whole chain as library calls;
    every kernel also in float32 (f32_* keys), K3's passes and K2's levels
    by device time."""
    import torch
    import torch.nn.functional as F

    from csof_tpu_torch.bounds import bound_ms, corr_work
    from csof_tpu_torch.kernel_times import device_ms
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {k: {"max_abs_err": 0.0, "bound_by": None, "library_ms": None}
           for k in ("K1", "K2", "K3")}
    sums = {}  # (kernel, dtype) -> summed ms, plain ms, library ms, note ms, work

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def fuse_params(f, cin):
        return (rand(f, cin, 3, 3, std=(2.0 / (9 * cin)) ** 0.5), rand(f, std=0.1),
                1.0 + rand(f, std=0.1), rand(f, std=0.1))

    def record(kname, err):
        res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for (c, h, w, s) in LEVELS + RAGGED:
            level = (c, h, w, s) in LEVELS
            q = rand(BATCH, c, h, w).to(dtype)
            m = rand(BATCH, c, h, w).to(dtype)
            cin = 2 * c + (2 * RADIUS + 1) ** 2
            wt, bias, gw, gb = fuse_params(c, cin)
            # K2 at the training batch, with a cotangent of the corr's shape
            qt, mt = q[:TRAIN_BATCH].contiguous(), m[:TRAIN_BATCH].contiguous()
            g = rand(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w).to(dtype)
            runs = {
                "K1": (BATCH, lambda: k1.corr_cuda(q, m, RADIUS, s),
                       lambda: k1.corr_plain(q, m, RADIUS, s)),
                "K3": (BATCH, lambda: k3.skip_fuse_cuda(q, m, wt, bias, gw, gb, RADIUS, s),
                       lambda: k3.skip_fuse_plain(q, m, wt, bias, gw, gb, RADIUS, s)),
                "K2": (TRAIN_BATCH, lambda: k1.corr_bwd_cuda(qt, mt, g, RADIUS, s),
                       lambda: k1.corr_bwd_plain(qt, mt, g, RADIUS, s)),
            }
            for kname, (b, kern, plain) in runs.items():
                tag = f"{dname} B={b} C={c} {h}x{w} r={RADIUS} s={s}"
                got = kern()
                torch.cuda.synchronize()
                ref = plain()
                atol, rtol = TOL[(kname, dname)]
                if kname == "K2":
                    err = max(compare("kernels", f"K2 {name} {tag}", a, r, atol, rtol)
                              for name, a, r in zip(("dq", "dm"), got, ref))
                else:
                    err = compare("kernels", f"{kname} {tag}", got, ref, atol, rtol)
                record(kname, err)
                # times at the level shapes, in both dtypes
                if not level:
                    continue
                t, p = timed_pair(kern, plain)
                acc = sums.setdefault((kname, dname), {"ms": 0.0, "plain_ms": 0.0,
                                                        "work": [0.0] * 4})
                acc["ms"] += t
                acc["plain_ms"] += p
                work = corr_work(kname, b, c, h, w, dtype.itemsize)
                acc["work"] = [a + v for a, v in zip(acc["work"], work)]
                extra = ""
                if kname == "K3":
                    x = torch.cat([q, m, k1.corr_cuda(q, m, RADIUS, s)], 1)
                    wb, bb = wt.to(dtype), bias.to(dtype)
                    lib = median_ms(lambda: F.conv2d(x, wb, padding=1))
                    groups = k3.num_groups_for(c)

                    def chain():  # the whole function as library calls, K1's corr
                        xc = torch.cat([q, m, k1.corr_cuda(q, m, RADIUS, s)], 1)
                        yc = F.group_norm(F.conv2d(xc, wb, bb, padding=1), groups,
                                          gw.to(dtype), gb.to(dtype))
                        return F.leaky_relu(yc, 0.01)

                    note = median_ms(chain)
                    passes = device_ms(kern, group=k3_pass)
                    for key, v in (("library_ms", lib), ("library_note_ms", note),
                                   *((f"{k}_ms", v) for k, v in passes.items())):
                        acc[key] = acc.get(key, 0.0) + v
                    extra = (f", library F.conv2d over the {cin}-channel concat {lib:.4f} ms, "
                             f"library chain (K1, cat, conv2d, group_norm, leaky_relu) "
                             f"{note:.4f} ms; device ms a call by pass: "
                             + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
                if kname == "K2":  # device time by level: one launch, dq and dm
                    dev = device_ms(kern)["all"]
                    acc["device_ms"] = acc.get("device_ms", 0.0) + dev
                    acc.setdefault("device_ms_by_level", []).append(dev)
                    extra = f", device {dev:.4f} ms"
                phase("kernels", f"{kname} {tag}: kernel {t:.4f} ms, plain {p:.4f} ms"
                      f"{extra} ({card})")
        # across the tiling edges of K1 (32 x 4 or 8 tiles, 16-byte groups)
        # and K3's conv (64 x 2 or 4 tiles, N blocks of 32/64/128, 16- or
        # 8-channel chunks straddling q, m and corr)
        for (b, c, f, h, w, r, s) in TILING_RAGGED:
            tag = f"{dname} B={b} C={c} F={f} {h}x{w} r={r} s={s}"
            q = rand(b, c, h, w).to(dtype)
            m = rand(b, c, h, w).to(dtype)
            params = fuse_params(f, 2 * c + (2 * r + 1) ** 2)
            got = k1.corr_cuda(q, m, r, s)
            torch.cuda.synchronize()
            record("K1", compare("kernels", f"K1 {tag}", got, k1.corr_plain(q, m, r, s),
                                 *TOL[("K1", dname)]))
            got = k3.skip_fuse_cuda(q, m, *params, r, s)
            torch.cuda.synchronize()
            record("K3", compare("kernels", f"K3 {tag}", got,
                                 k3.skip_fuse_plain(q, m, *params, r, s), *TOL[("K3", dname)]))
        # across the edges of K2's tiling (32 x 4 tiles, 32-channel blocks,
        # element copies where W is no multiple of the 16-byte group)
        for (b, c, h, w, r, s) in K2_TILING_RAGGED:
            tag = f"{dname} B={b} C={c} {h}x{w} r={r} s={s}"
            q, m = (rand(b, c, h, w).to(dtype) for _ in range(2))
            g = rand(b, (2 * r + 1) ** 2, h, w).to(dtype)
            got = k1.corr_bwd_cuda(q, m, g, r, s)
            torch.cuda.synchronize()
            ref = k1.corr_bwd_plain(q, m, g, r, s)
            record("K2", max(compare("kernels", f"K2 {name} {tag}", a, rf, *TOL[("K2", dname)])
                             for name, a, rf in zip(("dq", "dm"), got, ref)))
        # tensors off the 16-byte grid: K2's element copies and stores
        q, m = (rand(2, 20, 24, 64).to(dtype) for _ in range(2))
        g = rand(2, (2 * RADIUS + 1) ** 2, 24, 64).to(dtype)
        got = k1.corr_bwd_cuda(unaligned(q), unaligned(m), unaligned(g), RADIUS, 2)
        torch.cuda.synchronize()
        ref = k1.corr_bwd_plain(q, m, g, RADIUS, 2)
        record("K2", max(compare("kernels", f"K2 {name} {dname} unaligned B=2 C=20 24x64 s=2",
                                 a, rf, *TOL[("K2", dname)])
                         for name, a, rf in zip(("dq", "dm"), got, ref)))
    # determinism: K3 twice on the same inputs, the same bits
    for dtype in (torch.float32, torch.bfloat16):
        c, h, w, s = LEVELS[0]
        q, m = (rand(BATCH, c, h, w).to(dtype) for _ in range(2))
        params = fuse_params(c, 2 * c + (2 * RADIUS + 1) ** 2)
        a = k3.skip_fuse_cuda(q, m, *params, RADIUS, s)
        b = k3.skip_fuse_cuda(q, m, *params, RADIUS, s)
        torch.cuda.synchronize()
        expect(torch.equal(a, b), f"K3 {dtype}: two runs on the same inputs differ")
        # K2 at the training batch: each output summed by one thread, in order
        g = rand(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w).to(dtype)
        qt, mt = q[:TRAIN_BATCH].contiguous(), m[:TRAIN_BATCH].contiguous()
        a = k1.corr_bwd_cuda(qt, mt, g, RADIUS, s)
        b = k1.corr_bwd_cuda(qt, mt, g, RADIUS, s)
        torch.cuda.synchronize()
        expect(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
               f"K2 {dtype}: two runs on the same inputs differ")
    phase("kernels", "K3 and K2 twice on the same inputs (float32, bfloat16): bit-identical")

    for kname in ("K1", "K2", "K3"):
        r = res[kname]
        for dname, prefix in (("bfloat16", ""), ("float32", "f32_")):
            acc = sums.get((kname, dname))
            if acc is None:
                continue
            bound, by = bound_ms(*acc.pop("work"))
            r.update({prefix + k: v for k, v in acc.items()})
            r[prefix + "bound_ms"], r[prefix + "bound_by"] = bound, by
        phase("kernels", f"{kname} summed over the three levels: bf16 {r['ms']:.4f} ms"
              + (f", f32 {r['f32_ms']:.4f} ms" if "f32_ms" in r else "")
              + (f"; device bf16 {r['device_ms']:.4f} ms, f32 {r['f32_device_ms']:.4f} ms"
                 if "device_ms" in r else "")
              + f"; bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
              + (f", f32 {r['f32_bound_ms']:.6f}" if "f32_bound_ms" in r else "")
              + f" ({card})")

    # the autograd path: CorrFunction (K1 forward, K2 backward) against
    # autograd of the plain forward, float32
    c, h, w, s = LEVELS[0]
    q = rand(TRAIN_BATCH, c, h, w).requires_grad_(True)
    m = rand(TRAIN_BATCH, c, h, w).requires_grad_(True)
    g = rand(TRAIN_BATCH, (2 * RADIUS + 1) ** 2, h, w)
    got = torch.autograd.grad((k1.CorrFunction.apply(q, m, RADIUS, s) * g).sum(), (q, m))
    ref = torch.autograd.grad((k1.corr_plain(q, m, RADIUS, s) * g).sum(), (q, m))
    for name, a, b in zip(("dq", "dm"), got, ref):
        compare("kernels", f"CorrFunction autograd {name} float32 B={TRAIN_BATCH} C={c} "
                f"{h}x{w} s={s} vs autograd of corr_plain", a, b, *TOL[("K2", "float32")])
    torch.cuda.synchronize()
    return res


def synthetic_cine(rng: np.random.RandomState) -> np.ndarray:
    """(T, D, H, W) float32 cine: a bright disk whose radius beats over the
    cycle on a noisy background, off-centre so the ROI crop moves (the disk
    is where the cine exceeds 100)."""
    h, w = CINE_HW
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * 0.45 + rng.uniform(-8, 8), w * 0.55 + rng.uniform(-8, 8)
    out = np.empty((T_FRAMES, DEPTH, h, w), np.float32)
    for t in range(T_FRAMES):
        radius = 22 + 6 * np.cos(2 * np.pi * t / T_FRAMES)
        for d in range(DEPTH):
            r = radius * (1.0 - 0.05 * d)
            disk = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.float32)
            out[t, d] = 200.0 * disk + 30.0 * rng.rand(h, w)
    return out


def serve(model, card: str) -> dict:
    """Phase 4: 3 requests through predict_and_export_case."""
    import torch

    from csof_tpu_torch.inference.flow_predictor import FlowPredictor, predict_and_export_case
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    predictor = FlowPredictor(model, crop_size=128, device=torch.device("cuda"))
    rng = np.random.RandomState(0)
    cines = [synthetic_cine(rng) for _ in range(3)]
    props = {"spacing_after_resampling": (10.0, 1.5, 1.5)}
    with tempfile.TemporaryDirectory() as tmp:
        k1.launches = k1.bwd_launches = k3.launches = k5.launches = k6.launches = 0
        per_request = []
        for i, cine in enumerate(cines):
            before = k3.launches
            t0 = time.perf_counter()
            res = predict_and_export_case(predictor, cine, props, tmp, f"case{i}")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            per_request.append(k3.launches - before)
            for sub, ext in (("Flow", ".npz"), ("Registered", ".nii.gz"),
                             ("Segmentation", ".nii.gz")):
                expect((Path(tmp) / sub / f"case{i}{ext}").is_file(), f"missing {sub} output")
            for key in ("softmax", "flow", "registered"):
                expect(bool(np.isfinite(res[key]).all()), f"request {i}: non-finite {key}")
            expect(res["seg"].shape == cine.shape, f"seg shape {res['seg'].shape}")
            expect(res["flow"].shape == (*cine.shape, 2), f"flow shape {res['flow'].shape}")
            phase("serving", f"request {i}: cine {cine.shape} -> {secs:.3f} s host clock, "
                  f"K3 launches {per_request[-1]}, classes present "
                  f"{sorted(np.unique(res['seg']).tolist())} ({card})")
        counts = {"K1": k1.launches, "K3": k3.launches}
    others = {"K2": k1.bwd_launches, "K5": k5.launches, "K6": k6.launches}
    expect(others == {"K2": 0, "K5": 0, "K6": 0}, f"launched while serving: {others}")
    expect(per_request == [LAUNCHES_PER_REQUEST] * 3,
           f"K3 launches per request {per_request}, expected {LAUNCHES_PER_REQUEST}")
    for name, n in counts.items():
        expect(n == 3 * LAUNCHES_PER_REQUEST, f"{name} launched {n} times in the serving run")
    phase("serving", f"launches in the serving run: {counts}")
    return counts


def parity(model_cpu) -> None:
    """Phase 5: float32 forward, GPU kernels vs CPU plain versions."""
    import dataclasses

    import torch

    from csof_tpu_torch.models.segflow import SegFlow

    cfg32 = dataclasses.replace(model_cpu.cfg, dtype="float32")
    cpu = SegFlow(cfg32, model_cpu.num_classes)
    cpu.load_state_dict(model_cpu.state_dict())
    gpu = copy.deepcopy(cpu).cuda()
    video = np.random.RandomState(1).rand(1, 3, 128, 128, 1).astype(np.float32)
    with torch.inference_mode():
        out_gpu = gpu(torch.from_numpy(video).cuda())
        torch.cuda.synchronize()
        out_cpu = cpu(torch.from_numpy(video))
    for key in ("seg_logits", "flow", "cum_flow", "registered"):
        got = out_gpu[key].cpu()
        compare("parity", f"{key} {tuple(got.shape)} GPU vs CPU", got, out_cpu[key], *MODEL_TOL)


def throughput(model, card: str) -> float:
    """Phase 6: frames/s of the bf16 serving forward at the bench geometry."""
    import torch

    video = torch.from_numpy(
        np.random.RandomState(0).rand(BATCH, T_FRAMES, 128, 128, 1).astype(np.float32)
    ).cuda()
    times = []
    with torch.inference_mode():
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(video)
            torch.cuda.synchronize()
            if i >= 3:  # 3 warm-up forwards
                times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    fps = BATCH * T_FRAMES / med
    phase("throughput", f"forward (8, 12, 128, 128, 1) bf16: median {med * 1e3:.3f} ms over "
          f"{len(times)} reps (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) -> "
          f"{fps:.2f} frames/s on {card}")
    return fps


def synthetic_videos(n: int = 4) -> dict:
    """Training cines for VideoChunkLoader: the serving cines with the disk
    as label 1, ED at frame 0 and ES at the smallest disk."""
    rng = np.random.RandomState(2)
    videos = {}
    for i in range(n):
        cine = synthetic_cine(rng)
        videos[f"synthetic{i}"] = {"frames": cine, "seg": (cine > 100).astype(np.int32),
                                   "ed": 0, "es": T_FRAMES // 2}
    return videos


def train(card: str) -> dict:
    """Phase 7: Trainer.run_training at full width, bf16, batch 4 x 6 x 128^2."""
    import dataclasses

    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3
    from csof_tpu_torch.training import checkpoint as ckpt
    from csof_tpu_torch.training.trainer import Trainer

    config = ExperimentConfig(
        data=DataConfig(do_data_aug=False, batch_size=TRAIN_BATCH, video_length=TRAIN_T,
                        crop_size=TRAIN_HW),
        num_batches_per_epoch=TRAIN_STEPS_PER_EPOCH, max_num_epochs=TRAIN_EPOCHS)
    expect(config.segflow.corr_fuse == "concat" and config.segflow.dtype == "bfloat16",
           f"default config trains {config.segflow.corr_fuse} {config.segflow.dtype}")
    loader = VideoChunkLoader(synthetic_videos(), config.data.video_length,
                              config.data.batch_size, config.data.crop_size, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, tmp, device="cuda").initialize()
        trainer.checkpoint_every = TRAIN_EPOCHS  # so that the run writes "latest" too
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        step = trainer.run_iteration
        losses, event_ms = [], []

        def timed_step(batch, train=True):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss, aux = step(batch, train)  # ends in a read of the loss: synchronised
            end.record()
            end.synchronize()
            event_ms.append(start.elapsed_time(end))
            losses.append(loss)
            return loss, aux

        trainer.run_iteration = timed_step
        k1.launches = k1.bwd_launches = k3.launches = k5.launches = k6.launches = 0
        hist = trainer.run_training(loader, log_fn=lambda msg: phase("train", msg))
        counts = {"K1": k1.launches, "K2": k1.bwd_launches, "K3": k3.launches,
                  "K5": k5.launches, "K6": k6.launches}
        n = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
        expect(len(losses) == n and all(np.isfinite(losses)), f"losses {losses}")
        expect(counts == {"K1": CORR_PER_STEP * n, "K2": CORR_PER_STEP * n, "K3": 0, "K5": 0,
                          "K6": 0},
               f"launches in the train run {counts}, expected {CORR_PER_STEP} K1 and K2 "
               f"per step over {n} steps")
        after = trainer.model.state_dict()
        changed = sum(not torch.equal(after[k], v) for k, v in before.items())
        grads = [p for p in trainer.model.parameters() if p.grad is not None
                 and bool(p.grad.abs().sum() > 0)]
        expect(changed >= len(grads) > 0,
               f"{changed} of {len(before)} tensors changed, {len(grads)} had gradients")
        for name in (ckpt.BEST, ckpt.LATEST, ckpt.FINAL):
            expect((Path(tmp) / name).is_file() and (Path(tmp) / (name + ".json")).is_file(),
                   f"checkpoint {name} or its sidecar missing")
        fresh = Trainer(config, tmp, device="cuda")
        meta = fresh.load_checkpoint()
        expect(meta["epoch"] == TRAIN_EPOCHS and fresh.optimizer.count == n,
               f"reloaded epoch {meta['epoch']}, step {fresh.optimizer.count}")
        expect(all(torch.equal(v, after[k]) for k, v in fresh.model.state_dict().items()),
               "the reloaded weights differ from the trained ones")
    steps = hist.step_times[TRAIN_WARMUP:]
    med = statistics.median(steps)
    frames = TRAIN_BATCH * TRAIN_T
    phase("train", f"{n} steps, losses {losses[0]:.5f} -> {losses[-1]:.5f}; {changed} of "
          f"{len(before)} parameter tensors changed; launches {counts} ({CORR_PER_STEP} K1 + "
          f"{CORR_PER_STEP} K2 per step); checkpoint triad written and reloaded")
    phase("train", f"step ({TRAIN_BATCH}, {TRAIN_T}, {TRAIN_HW}, {TRAIN_HW}, 1) bf16: median "
          f"{med * 1e3:.3f} ms host clock over {len(steps)} steps after {TRAIN_WARMUP} warm-up "
          f"(min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}) -> "
          f"{frames / med:.2f} train frames/s; CUDA-event step median "
          f"{statistics.median(event_ms[TRAIN_WARMUP:]):.3f} ms on {card}")
    return counts


def train_parity(card: str) -> None:
    """Phase 8: float32 loss and gradients, GPU kernels vs CPU plain versions."""
    import torch

    from csof_tpu_torch.config.experiment import (
        DataConfig,
        ExperimentConfig,
        LossWeights,
        SegFlowModelConfig,
    )
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.training.trainer import build_model, make_segflow_loss

    config = ExperimentConfig(
        segflow=SegFlowModelConfig(dtype="float32"), data=DataConfig(do_data_aug=False),
        loss_weights=LossWeights(image_flow_global=0.5, regularization_xy=1.0,
                                 regularization_z=0.5, seg_registered=0.3, segmentation=1.0))
    cpu = build_model(config, 4, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    batch = next(VideoChunkLoader(synthetic_videos(1), 3, 1, 64, seed=3))
    loss_fn = make_segflow_loss(config)
    before = k1.bwd_launches
    loss_gpu, _ = loss_fn(gpu, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    loss_gpu.backward()
    torch.cuda.synchronize()
    expect(k1.bwd_launches - before == 1 + 3 * 2, "the GPU backward did not run K2")
    loss_cpu, _ = loss_fn(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss_cpu.backward()
    a, b = loss_gpu.item(), loss_cpu.item()
    expect(abs(a - b) <= LOSS_RTOL * abs(b), f"loss GPU {a} vs CPU {b}")
    worst, worst_name = 0.0, None
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        g, r = p.grad.cpu(), cpu_params[name].grad
        expect(bool(torch.isfinite(g).all()), f"{name}: non-finite gradient")
        ratio = float((g - r).abs().max()) / (GRAD_TOL * float(r.abs().max()) + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, name
    phase("train parity", f"full width float32 (1, 3, 64, 64, 1), every loss term on: loss GPU "
          f"{a:.7f} vs CPU {b:.7f}; {len(cpu_params)} gradients, worst |diff| / (tol "
          f"{GRAD_TOL:g} max|g| + 1e-6) = {worst:.3f} at {worst_name} "
          f"-> {'ok' if worst <= 1 else 'FAIL'} ({card})")
    expect(worst <= 1, f"gradient {worst_name} outside tolerance")


def check_unet_kernels(card: str) -> dict:
    """Phase 9. Returns per kernel: max abs error over all checks, and the
    float32 times of one U-Net forward (each served shape's median times its
    launches per forward) of kernel, plain version and library call, with
    the bound of the same work (csof_tpu_torch/bounds.py)."""
    import torch
    import torch.nn.functional as F

    from csof_tpu_torch.bounds import (
        UNET_BATCH,
        UNET_K5_SHAPES,
        UNET_K6_SHAPES,
        bound_ms,
        fp32_cores_note,
        unet_forward_work,
    )
    from csof_tpu_torch.kernel_times import device_ms
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
           for k in ("K5", "K6")}
    res["K6"]["library_ms"] = 0.0
    res["K5"]["library_note_ms"] = 0.0
    per_dtype = {}

    def rand(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std + mean

    runs = [("K5", (UNET_BATCH, *shape), count) for shape, count in UNET_K5_SHAPES]
    runs += [("K5", shape, 0) for shape in K5_RAGGED + K5_PLAN_EDGES]
    runs += [("K6", (UNET_BATCH, *shape), count) for shape, count in UNET_K6_SHAPES]
    runs += [("K6", shape, 0) for shape in K6_RAGGED]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for kname, shape, count in runs:
            if kname == "K5":
                n, c, h, w = shape
                x = rand(n, c, h, w, std=2.0, mean=0.5).to(dtype)
                x[0, 0] = 0.25  # a constant plane
                scale, bias = 1.0 + rand(c, std=0.2), rand(c, std=0.2)
                kern = lambda: k5.norm_act_cuda(x, scale, bias)  # noqa: E731
                plain = lambda: k5.norm_act_plain(x, scale, bias)  # noqa: E731
                sd, bd = scale.to(dtype), bias.to(dtype)
                lib = lambda: F.leaky_relu(  # noqa: E731
                    F.instance_norm(x, weight=sd, bias=bd, eps=1e-5), 0.01)
                plan = k5.norm_act_plan(n, c, h, w, dtype)
                tag = f"{dname} (N, C, H, W)={shape} {plan.path} {plan.cluster}"
                if not count:  # off the 16-byte grid: element copies and stores
                    got = k5.norm_act_cuda(unaligned(x), scale, bias)
                    torch.cuda.synchronize()
                    res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], compare(
                        "unet kernels", f"K5 {tag} unaligned", got, plain(),
                        *UNET_TOL[("K5", dname)]))
            else:
                n, ci, co, h, w, *flags = shape
                with_bias, out_f32 = flags or (True, False)
                out_f32 = out_f32 and dtype == torch.bfloat16
                x = rand(n, ci, h, w).to(dtype)
                wt, bias = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5), rand(co, std=0.1)
                bias = bias if with_bias else None
                kern = lambda: k6.conv3x3_cuda(x, wt, bias, out_f32)  # noqa: E731
                plain = lambda: k6.conv3x3_plain(x, wt, bias, out_f32)  # noqa: E731
                wd, bd = wt.to(dtype), None if bias is None else bias.to(dtype)
                lib = lambda: F.conv2d(x, wd, bd, padding=1)  # noqa: E731
                tag = (f"{dname} (N, Ci, Co, H, W)={(n, ci, co, h, w)}"
                       + ("" if with_bias else " no bias") + (" out_f32" if out_f32 else ""))
            got = kern()
            torch.cuda.synchronize()
            err = compare("unet kernels", f"{kname} {tag}", got, plain(),
                          *UNET_TOL[(kname, "float32" if kname == "K6" and out_f32 else dname)])
            r = res[kname]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if not count:
                continue
            t, p = timed_pair(kern, plain)
            lib_ms = median_ms(lib)
            tot = per_dtype.setdefault((kname, dname), [0.0, 0.0, 0.0])
            for i, v in enumerate((t, p, lib_ms)):
                tot[i] += count * v
            if dtype == torch.float32:
                r["ms"] += count * t
                r["plain_ms"] += count * p
                r["library_note_ms" if kname == "K5" else "library_ms"] += count * lib_ms
            dev = ""
            if kname == "K5":  # device time without the wrapper's host work
                d = device_ms(kern)["all"]
                key = "device_ms" if dtype == torch.float32 else "bf16_device_ms"
                r[key] = r.get(key, 0.0) + count * d
                dev = f", device {d:.4f} ms"
            libname = "F.instance_norm + F.leaky_relu (note)" if kname == "K5" else "F.conv2d"
            phase("unet kernels", f"{kname} {tag} x{count} per forward: kernel {t:.4f} ms"
                  f"{dev}, plain {p:.4f} ms, {libname} {lib_ms:.4f} ms ({card})")
    # determinism: K5 twice on the largest planes (a cluster each), the same bits
    for dtype in (torch.float32, torch.bfloat16):
        c, h, w = UNET_K5_SHAPES[0][0]
        x = rand(UNET_BATCH, c, h, w, std=2.0, mean=0.5).to(dtype)
        scale, bias = 1.0 + rand(c, std=0.2), rand(c, std=0.2)
        a, b = k5.norm_act_cuda(x, scale, bias), k5.norm_act_cuda(x, scale, bias)
        torch.cuda.synchronize()
        expect(torch.equal(a, b), f"K5 {dtype}: two runs on the same inputs differ")
        del x, a, b
    phase("unet kernels", "K5 twice on the same inputs (float32, bfloat16): bit-identical")
    for kname, r in res.items():
        r["bound_ms"], r["bound_by"] = bound_ms(*unet_forward_work(kname, 4))
        for dname, size in (("float32", 4), ("bfloat16", 2)):
            t, p, lib_ms = per_dtype[(kname, dname)]
            b, by = bound_ms(*unet_forward_work(kname, size))
            note = ""
            if kname == "K6" and size == 4:
                fp32_note = fp32_cores_note(unet_forward_work(kname, 4))[0]
                note = f", FP32-core bound (note) {fp32_note:.4f} ms"
            if kname == "K6" and size == 2:
                r["bf16_ms"], r["bf16_plain_ms"], r["bf16_library_ms"] = t, p, lib_ms
            phase("unet kernels", f"{kname} {dname}, one forward ({UNET_BATCH} x 320x256): kernel "
                  f"{t:.4f} ms, plain {p:.4f} ms, library {lib_ms:.4f} ms; {dname} bound "
                  f"{b:.4f} ms ({by}){note} ({card})")
    torch.cuda.synchronize()
    return res


def synthetic_case(rng: np.random.RandomState, depth: int = UNET_DEPTH) -> np.ndarray:
    """(z, y, x) float32 MRI-like volume: noise everywhere (nothing for the
    crop to remove) and a bright ellipsoid, the left atrium's stand-in."""
    h, w = UNET_HW
    zz, yy, xx = np.mgrid[0:depth, 0:h, 0:w].astype(np.float32)
    cz, cy, cx = depth / 2, h * 0.5 + rng.uniform(-20, 20), w * 0.5 + rng.uniform(-20, 20)
    blob = ((zz - cz) / 12) ** 2 + ((yy - cy) / 40) ** 2 + ((xx - cx) / 30) ** 2 <= 1
    return (20 + 30 * rng.rand(depth, h, w) + 200 * blob).astype(np.float32)


def unet_forwards(shape_zyx, plans) -> int:
    """Forwards predict_2d_stack runs for a preprocessed (z, y, x) volume:
    (slices padded to the depth bucket) x (tiles a slice) over the tile batch."""
    from csof_tpu_torch.ops.sliding_window import bucket_image_shape, step_grid

    patch = plans.fullres_stage().patch_size
    bucket = bucket_image_shape(shape_zyx[1:], patch, 0.5, 32)
    jobs = -(-shape_zyx[0] // 4) * 4 * len(step_grid(patch, bucket, 0.5))
    return -(-jobs // UNET_TILE_BATCH)


def unet_serve(model, plans, card: str) -> dict:
    """Phase 10: 2 synthetic cases through predict_case."""
    import torch

    from csof_tpu_torch.inference.predictor import predict_case
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3
    from csof_tpu_torch.utils.nifti import load_nifti, save_nifti

    per_forward = model.kernel_launches(plans.fullres_stage().patch_size)
    expect(per_forward == {"K5": 26, "K6": 7, "K7": 0}, f"launches per forward {per_forward}")
    rng = np.random.RandomState(3)
    spacing_xyz = (UNET_SPACING, UNET_SPACING, 1.37)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i in range(UNET_CASES):
            files.append(Path(tmp) / f"la_{i:03d}_0000.nii.gz")
            save_nifti(synthetic_case(rng), files[-1], spacing_xyz=spacing_xyz)
        k1.launches = k1.bwd_launches = k3.launches = k5.launches = k6.launches = 0
        forwards = 0
        for i, f in enumerate(files):
            before = (k5.launches, k6.launches)
            out = Path(tmp) / f"la_{i:03d}.nii.gz"
            t0 = time.perf_counter()
            res = predict_case(plans, model, [f], out, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_fwd = unet_forwards(res["properties"]["size_after_resampling"], plans)
            forwards += n_fwd
            got = (k5.launches - before[0], k6.launches - before[1])
            expect(n_fwd == 10, f"case {i}: {n_fwd} forwards, expected 10 (40 slices x 2 tiles)")
            expect(got == (26 * n_fwd, 7 * n_fwd),
                   f"case {i}: K5, K6 launches {got}, expected {26 * n_fwd}, {7 * n_fwd}")
            expect(bool(np.isfinite(res["softmax"]).all()), f"case {i}: non-finite softmax")
            expect(res["softmax"].shape == (2, UNET_DEPTH, *UNET_HW),
                   f"case {i}: softmax shape {res['softmax'].shape}")
            expect(out.is_file(), f"case {i}: {out.name} not written")
            seg = load_nifti(out).data_czyx
            expect(seg.shape == (UNET_DEPTH, *UNET_HW), f"case {i}: written seg {seg.shape}")
            phase("unet serving", f"case {i}: (1, {UNET_DEPTH}, {UNET_HW[0]}, {UNET_HW[1]}) -> "
                  f"{secs:.3f} s host clock, {n_fwd} forwards, K5/K6 launches {got}, labels "
                  f"written {sorted(np.unique(seg).tolist())} ({card})")
        counts = {"K1": k1.launches, "K2": k1.bwd_launches, "K3": k3.launches,
                  "K5": k5.launches, "K6": k6.launches}
    expect(counts == {"K1": 0, "K2": 0, "K3": 0, "K5": 26 * forwards, "K6": 7 * forwards},
           f"launches in the U-Net serving run {counts} over {forwards} forwards")
    phase("unet serving", f"launches in the U-Net serving run: {counts} ({forwards} forwards)")
    return counts


def unet_parity(model_cpu, card: str) -> None:
    """Phase 11: float32 logits of 2 tiles, GPU kernels vs CPU plain
    versions; the GPU forward's kernel shapes against bounds.py's lists."""
    from collections import Counter

    import torch

    from csof_tpu_torch.bounds import UNET_K5_SHAPES, UNET_K6_SHAPES
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    gpu = copy.deepcopy(model_cpu).cuda()
    x = np.random.RandomState(4).randn(2, 1, 320, 256).astype(np.float32)
    shapes = {"K5": Counter(), "K6": Counter()}
    orig = (k5.norm_act_cuda, k6.conv3x3_cuda)

    def k5_census(x, *a, **k):
        shapes["K5"][tuple(x.shape[1:])] += 1
        return orig[0](x, *a, **k)

    def k6_census(x, w, *a, **k):
        shapes["K6"][(x.shape[1], w.shape[0], *x.shape[2:])] += 1
        return orig[1](x, w, *a, **k)

    k5.norm_act_cuda, k6.conv3x3_cuda = k5_census, k6_census
    try:
        with torch.inference_mode():
            out_gpu = gpu(torch.from_numpy(x).cuda())
            torch.cuda.synchronize()
    finally:
        k5.norm_act_cuda, k6.conv3x3_cuda = orig
    for name, listed in (("K5", UNET_K5_SHAPES), ("K6", UNET_K6_SHAPES)):
        expect(shapes[name] == Counter(dict(listed)),
               f"{name} launched at {dict(shapes[name])}, bounds.py lists {listed}")
    with torch.inference_mode():
        out_cpu = model_cpu(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(out_gpu, out_cpu)):
        compare("unet parity", f"head {i} {tuple(a.shape)} GPU vs CPU", a.cpu(), b, *MODEL_TOL)
    phase("unet parity", f"kernel shapes of the forward match bounds.py ({card})")


def unet_throughput(model, plans, card: str) -> float:
    """Phase 12: slices/s of predict_2d_stack on a (1, 40, 320, 320) volume,
    and the CUDA-event time of one batch-32 forward."""
    import torch

    from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor

    sp = plans.fullres_stage()
    cfg = PredictorConfig(patch_size=tuple(sp.patch_size),
                          num_classes=plans.num_classes_with_background,
                          tile_batch=UNET_TILE_BATCH)
    predictor = SlidingWindowPredictor(model, cfg, "cuda")
    vol = np.random.RandomState(5).randn(1, UNET_DEPTH, *UNET_HW).astype(np.float32)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_2d_stack(vol)
        torch.cuda.synchronize()
        if i:  # 1 warm-up
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    x = torch.from_numpy(np.random.RandomState(6).randn(32, 1, *sp.patch_size)
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        fwd = median_ms(lambda: model(x), reps=10)
    phase("unet throughput", f"predict_2d_stack (1, {UNET_DEPTH}, {UNET_HW[0]}, {UNET_HW[1]}) "
          f"float32, TTA 4 flips, 10 forwards of 32: median {med:.3f} s over {len(times)} runs "
          f"(min {min(times):.3f}, max {max(times):.3f}) -> {UNET_DEPTH / med:.2f} slices/s; one "
          f"batch-32 forward {fwd:.3f} ms CUDA events (median of 10) on {card}")
    return UNET_DEPTH / med


def check_unet_train_kernels(card: str) -> dict:
    """Phase 13: Conv3x3Function's gradients against autograd of the plain
    version; the f32 dx time of one training step (each dx shape's median
    times its launches) of kernel, plain version and cuDNN's dgrad, with
    the bound of the same work."""
    import torch

    from csof_tpu_torch.bounds import (
        UNET_K6_DX_SHAPES,
        UNET_TRAIN_BATCH,
        bound_ms,
        fp32_cores_note,
        unet_train_work,
    )
    from csof_tpu_torch.ops.kernels import conv as k6

    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bf16_ms = [0.0, 0.0, 0.0]

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    # forward convs (N, Ci, Co, H, W) whose dx the step launches: the dx
    # shape (Ci', Co') is the conv's (Co, Ci)
    runs = [((UNET_TRAIN_BATCH, co_, ci_, h, w), count)
            for (ci_, co_, h, w), count in UNET_K6_DX_SHAPES]
    runs += [(shape, 0) for shape in K6_BWD_RAGGED]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for (n, ci, co, h, w), count in runs:
            x = rand(n, ci, h, w).to(dtype).requires_grad_(True)
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5).requires_grad_(True)
            b = rand(co, std=0.1).requires_grad_(True)
            dy = rand(n, co, h, w).to(dtype)
            got = torch.autograd.grad(k6.Conv3x3Function.apply(x, wt, b, False), (x, wt, b), dy)
            torch.cuda.synchronize()
            ref = torch.autograd.grad(k6.conv3x3_plain(x, wt, b), (x, wt, b), dy)
            tag = f"{dname} conv (N, Ci, Co, H, W)=({n}, {ci}, {co}, {h}, {w})"
            err = compare("unet train kernels", f"K6 dx {tag}", got[0], ref[0],
                          *UNET_TOL[("K6", dname)])
            res["max_abs_err"] = max(res["max_abs_err"], err)
            frac, rtol = K6_BWD_TOL[dname]
            for gname, a, r in (("dw", got[1], ref[1]), ("db", got[2], ref[2])):
                compare("unet train kernels", f"K6 {gname} {tag}", a, r,
                        frac * float(r.abs().max()), rtol)
            if not count:
                continue
            xd, wd, dyd = x.detach(), wt.detach(), dy.contiguous()
            kern = lambda: k6.conv3x3_dx_cuda(dyd, wd)  # noqa: E731
            plain = lambda: k6.conv3x3_dx_plain(dyd, wd)  # noqa: E731
            wl = wd.to(dtype)
            lib = lambda: torch.nn.grad.conv2d_input(xd.shape, wl, dyd, padding=1)  # noqa: E731
            t, p = timed_pair(kern, plain)
            lib_ms = median_ms(lib)
            if dtype == torch.float32:
                res["ms"] += count * t
                res["plain_ms"] += count * p
                res["library_ms"] += count * lib_ms
            else:
                bf16_ms = [a + count * v for a, v in zip(bf16_ms, (t, p, lib_ms))]
            phase("unet train kernels", f"K6 dx of {tag} x{count} per step: kernel {t:.4f} ms, "
                  f"plain {p:.4f} ms, torch.nn.grad.conv2d_input {lib_ms:.4f} ms ({card})")
    res["bound_ms"], res["bound_by"] = bound_ms(*unet_train_work("K6_dx"))
    fp32_note = fp32_cores_note(unet_train_work("K6_dx"))[0]
    bf16_bound, bf16_by = bound_ms(*unet_train_work("K6_dx", 2))
    res["bf16_ms"], res["bf16_plain_ms"], res["bf16_library_ms"] = bf16_ms
    phase("unet train kernels", f"K6 dx, one training step ({UNET_TRAIN_BATCH} x 320x256), "
          f"float32: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, conv2d_input "
          f"{res['library_ms']:.4f} ms, bound as 3xTF32 {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), FP32-core bound (note) {fp32_note:.4f} ms; "
          f"bfloat16: kernel {bf16_ms[0]:.4f} ms, plain {bf16_ms[1]:.4f} ms, conv2d_input "
          f"{bf16_ms[2]:.4f} ms, bound {bf16_bound:.4f} ms ({bf16_by}) ({card})")
    torch.cuda.synchronize()
    return res


def check_unet_norm_kernels(card: str) -> dict:
    """Phase 13, continued: K7 and K7 dx at the 26 blocks of a Task002 2d
    training step (batch 40, UNET_K5_SHAPES' planes), float32, against
    their plain versions in float64 (``native_forward_plain``: y and each
    plane's mean and rstd; ``native_backward_plain`` on the kernel's signs:
    dz and each plane's sums behind dbeta and dgamma); both kernels twice on
    the largest planes, the same bits; per kernel the step's summed median
    time, device time (torch.profiler), the float32 plain version's time and
    that of the eager path K7 replaces (``leaky_relu(InstanceNorm(z))``, and
    its autograd backward alone for K7 dx), with the bound
    (``bounds.unet_native_work``)."""
    import torch

    from csof_tpu_torch.bounds import UNET_K5_SHAPES, UNET_TRAIN_BATCH, bound_ms, unet_native_work
    from csof_tpu_torch.kernel_times import device_ms
    from csof_tpu_torch.models.blocks import InstanceNorm, leaky_relu
    from csof_tpu_torch.ops.kernels import norm_act as k7

    gen = torch.Generator(device="cuda").manual_seed(13)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
               "library_ms": 0.0} for k in ("K7", "K7_dx")}

    def rand(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std + mean

    for (c, h, w), count in UNET_K5_SHAPES:
        n = UNET_TRAIN_BATCH
        z, dy = rand(n, c, h, w, std=2.0, mean=0.5), rand(n, c, h, w)
        z[0, 0] = 0.25  # a constant plane
        norm = InstanceNorm(c).cuda()
        with torch.no_grad():
            norm.weight.add_(rand(c, std=0.2))
            norm.bias.add_(rand(c, std=0.2))
        wb = (norm.weight.detach(), norm.bias.detach())
        fplan, bplan = k7.native_plan(h * w), k7.native_plan(h * w, backward=True)
        tag = (f"(N, C, H, W)={(n, c, h, w)}, plans {fplan.path} {fplan.cluster} / "
               f"{bplan.path} {bplan.cluster}")
        y, mean, rstd = k7.native_forward_cuda(z, *wb)
        dz, pda, pdah = k7.native_backward_cuda(z, dy, mean, rstd, *wb)
        torch.cuda.synchronize()
        z64, wb64 = z.double(), [t.double() for t in wb]
        ry, rmean, rrstd = k7.native_forward_plain(z64, *wb64)
        label = "unet train kernels"
        errs = {"K7": [compare(label, f"K7 y {tag}", y, ry, *UNET_TOL[("K5", "float32")]),
                       compare(label, f"K7 mean {tag}", mean, rmean, 1e-5, 1e-5),
                       compare(label, f"K7 rstd {tag}", rstd, rrstd, 1e-5, 1e-5)]}
        del ry
        ref = k7.native_backward_plain(z64, dy.double(), rmean, rrstd, *wb64, positive=y >= 0)
        del z64
        errs["K7_dx"] = [compare_by_plane(label, f"K7 dx dz {tag}", dz, ref[0], 1e-4)]
        errs["K7_dx"] += [compare(label, f"K7 dx {what} {tag}", got, r,
                                  1e-4 * float(r.abs().max()), 1e-4)
                          for what, got, r in (("sum da", pda, ref[1]),
                                               ("sum da zh", pdah, ref[2]))]
        del ref
        if (c, h, w) == UNET_K5_SHAPES[0][0]:  # the largest planes: a cluster each way
            y2, _, _ = k7.native_forward_cuda(z, *wb)
            again = k7.native_backward_cuda(z, dy, mean, rstd, *wb)
            torch.cuda.synchronize()
            expect(torch.equal(y, y2) and all(torch.equal(a, b) for a, b in
                                              zip((dz, pda, pdah), again)),
                   f"K7 or K7 dx {tag}: two runs on the same inputs differ")
            phase(label, f"K7 and K7 dx twice at {tag}: bit-identical")
            del y2, again
        zr = z.detach().requires_grad_()
        eager = leaky_relu(norm(zr))
        runs = {"K7": (lambda: k7.native_forward_cuda(z, *wb),
                       lambda: k7.native_forward_plain(z, *wb),
                       lambda: leaky_relu(norm(z))),
                "K7_dx": (lambda: k7.native_backward_cuda(z, dy, mean, rstd, *wb),
                          lambda: k7.native_backward_plain(z, dy, mean, rstd, *wb),
                          lambda: torch.autograd.grad(eager, (zr, norm.weight, norm.bias), dy,
                                                      retain_graph=True))}
        for kname, (kern, plain, lib) in runs.items():
            t, p = timed_pair(kern, plain)
            lib_ms, d = median_ms(lib), device_ms(kern)["all"]
            r = res[kname]
            r["max_abs_err"] = max(r["max_abs_err"], *errs[kname])
            for key, v in (("ms", t), ("plain_ms", p), ("device_ms", d), ("library_ms", lib_ms)):
                r[key] += count * v
            phase(label, f"{kname} {tag} x{count} per step: kernel {t:.4f} ms, device {d:.4f} "
                  f"ms, plain {p:.4f} ms, eager {lib_ms:.4f} ms ({card})")
        del z, dy, y, mean, rstd, dz, pda, pdah, zr, eager, runs
    for kname, backward in (("K7", False), ("K7_dx", True)):
        r = res[kname]
        r["bound_ms"], r["bound_by"] = bound_ms(*unet_native_work(backward))
        phase("unet train kernels", f"{kname}, one training step ({UNET_TRAIN_BATCH} x 320x256, "
              f"26 launches), float32: kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, eager {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


class _TimedIter:
    """Iterator wrapper that records the host seconds of each next()."""

    def __init__(self, it):
        self.it, self.seconds = it, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self.it)
        self.seconds.append(time.perf_counter() - t0)
        return item


def _kernel_modules():
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import corr as k1
    from csof_tpu_torch.ops.kernels import ncc as k4
    from csof_tpu_torch.ops.kernels import norm_act as k5
    from csof_tpu_torch.ops.kernels import skipfuse as k3

    return k1, k3, k4, k5, k6


def _reset_counts() -> None:
    k1, k3, k4, k5, k6 = _kernel_modules()
    k1.launches = k1.bwd_launches = k3.launches = k4.launches = k5.launches = 0
    k5.native_launches = k5.native_bwd_launches = 0
    k6.launches = k6.bwd_launches = 0


def _read_counts() -> dict:
    """Launches of K1-K7 since ``_reset_counts`` (K7 and K7 dx: the native
    norm and activation, which every float32 2D instance block with K5 off
    runs on the card)."""
    k1, k3, k4, k5, k6 = _kernel_modules()
    return {"K1": k1.launches, "K2": k1.bwd_launches, "K3": k3.launches, "K4": k4.launches,
            "K5": k5.launches, "K6": k6.launches, "K6_dx": k6.bwd_launches,
            "K7": k5.native_launches, "K7_dx": k5.native_bwd_launches}


def unet_train_data(plans, tmp: Path) -> dict:
    """Synthetic Task002-like cases through the port's data plane: NIfTI
    files -> run_cropping -> Preprocessor.run -> unpack_dataset ->
    load_dataset. Returns the dataset dict."""
    from csof_tpu_torch.data.cropping import run_cropping
    from csof_tpu_torch.data.dataset import load_dataset, unpack_dataset
    from csof_tpu_torch.data.preprocessing import Preprocessor
    from csof_tpu_torch.utils.nifti import save_nifti

    rng = np.random.RandomState(7)
    spacing_xyz = (UNET_SPACING, UNET_SPACING, 1.37)
    cases = []
    t0 = time.perf_counter()
    for i in range(UNET_TRAIN_CASES):
        img = synthetic_case(rng)
        img_path, seg_path = tmp / f"la_{i:03d}_0000.nii", tmp / f"la_{i:03d}_seg.nii"
        save_nifti(img, img_path, spacing_xyz=spacing_xyz)
        save_nifti((img > 150).astype(np.uint8), seg_path, spacing_xyz=spacing_xyz)
        cases.append((f"la_{i:03d}", [str(img_path)], str(seg_path)))
    run_cropping(cases, tmp / "cropped")
    Preprocessor(plans).run(tmp / "cropped", tmp / "preprocessed")
    unpack_dataset(tmp / "preprocessed")
    ds = load_dataset(tmp / "preprocessed")
    expect(sorted(ds) == [c for c, _, _ in cases], f"preprocessed cases {sorted(ds)}")
    phase("unet train", f"{UNET_TRAIN_CASES} cases (1, {UNET_DEPTH}, {UNET_HW[0]}, "
          f"{UNET_HW[1]}) cropped, preprocessed and unpacked in "
          f"{time.perf_counter() - t0:.1f} s host clock")
    return ds


def unet_train(card: str) -> dict:
    """Phase 14: Trainer.run_training of the full-width Task002 2d U-Net at
    batch 40 on SegPatchLoader batches."""
    import os

    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.data.dataset import do_split
    from csof_tpu_torch.data.loaders import SegPatchLoader
    from csof_tpu_torch.training import checkpoint as ckpt
    from csof_tpu_torch.training.trainer import Trainer

    plans = task002_heart_2d()
    sp = plans.fullres_stage()
    config = ExperimentConfig(
        model="unet2d", max_num_epochs=UNET_TRAIN_EPOCHS,
        num_batches_per_epoch=UNET_TRAIN_STEPS, num_val_batches_per_epoch=UNET_VAL_STEPS,
        optim=OptimConfig(optimizer="sgd", scheduler="poly", initial_lr=1e-2,
                          weight_decay=3e-5),
        data=DataConfig(do_data_aug=False))
    n = UNET_TRAIN_EPOCHS * UNET_TRAIN_STEPS
    n_val = UNET_TRAIN_EPOCHS * UNET_VAL_STEPS
    env = {k: os.environ.pop(k, None) for k in ("CSOF_CONV2D_IMPL", "CSOF_FUSED_NORM")}
    os.environ["CSOF_CONV2D_IMPL"] = "pallas"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ds = unet_train_data(plans, Path(tmp))
            tr_keys, va_keys = do_split(list(ds), config.fold)
            train_it = _TimedIter(SegPatchLoader({k: ds[k] for k in tr_keys}, sp.patch_size,
                                                 sp.batch_size, seed=config.seed))
            val_it = SegPatchLoader({k: ds[k] for k in va_keys}, sp.patch_size, sp.batch_size,
                                    seed=config.seed + 1)
            out = Path(tmp) / "fold_0"
            trainer = Trainer(config, out, plans=plans, device="cuda").initialize()
            trainer.checkpoint_every = UNET_TRAIN_EPOCHS  # so that the run writes "latest"
            per_step = trainer.model.kernel_launches(sp.patch_size, backward=True)
            expect(per_step == {"K5": 0, "K6": 7, "K7": 26, "K6_dx": 6, "K7_dx": 26},
                   f"per step {per_step}")
            step, event_ms, losses, lines = trainer.run_iteration, [], [], []

            def timed_step(batch, train=True):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss, aux = step(batch, train)  # ends in a read of the loss: synchronised
                end.record()
                end.synchronize()
                if train:
                    event_ms.append(start.elapsed_time(end))
                    losses.append(loss)
                return loss, aux

            def log(msg):
                lines.append(msg)
                phase("unet train", msg)

            trainer.run_iteration = timed_step
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            hist = trainer.run_training(train_it, val_it, log_fn=log)
            counts = _read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            expect(len(losses) == n and all(np.isfinite(losses)), f"losses {losses}")
            want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 7 * (n + n_val),
                    "K6_dx": 6 * n, "K7": 26 * (n + n_val), "K7_dx": 26 * n}
            expect(counts == want, f"launches in the U-Net train run {counts}, expected {want}")
            expect(len(hist.eval_metrics) == UNET_TRAIN_EPOCHS
                   and all(np.isfinite(hist.eval_metrics)), f"fg-dice {hist.eval_metrics}")
            expect(all(" fg-dice " in line for line in lines[:UNET_TRAIN_EPOCHS]),
                   f"no fg-dice in the log {lines}")
            for name in (ckpt.BEST, ckpt.LATEST, ckpt.FINAL):
                expect((out / name).is_file() and (out / (name + ".json")).is_file(),
                       f"checkpoint {name} or its sidecar missing")
            trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            fresh = Trainer(config, out, plans=plans, device="cuda")
            meta = fresh.load_checkpoint()
            expect(meta["epoch"] == UNET_TRAIN_EPOCHS and fresh.optimizer.count == n,
                   f"reloaded epoch {meta['epoch']}, step {fresh.optimizer.count}")
            expect(all(torch.equal(v, trained[k]) for k, v in fresh.model.state_dict().items()),
                   "the reloaded weights differ from the trained ones")
            del fresh, trainer, trained
    finally:
        for k, v in env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    torch.cuda.empty_cache()
    steps = hist.step_times[UNET_TRAIN_WARMUP:]
    med = statistics.median(steps)
    load_s = train_it.seconds[UNET_TRAIN_WARMUP:]
    phase("unet train", f"{n} steps + {n_val} validation batches, losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, fg-dice {hist.eval_metrics}; launches {counts} (7 K6 + 6 K6 dx "
          f"+ 26 K7 + 26 K7 dx per step, 7 K6 + 26 K7 per validation batch); checkpoint triad "
          f"written and reloaded; peak "
          f"device memory {peak_gb:.2f} GB")
    phase("unet train", f"step ({sp.batch_size}, 1, 320, 256) float32: median "
          f"{med * 1e3:.3f} ms host clock over {len(steps)} steps after {UNET_TRAIN_WARMUP} "
          f"warm-up (min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}) -> "
          f"{sp.batch_size / med:.2f} train slices/s; CUDA-event step median "
          f"{statistics.median(event_ms[UNET_TRAIN_WARMUP:]):.3f} ms; SegPatchLoader batch "
          f"median {statistics.median(load_s) * 1e3:.3f} ms host clock, outside the step, on "
          f"{card}")
    return counts


def unet_train_parity(card: str) -> None:
    """Phase 15: float32 loss and every gradient of the full-width U-Net at
    batch 2 of 320x256, GPU kernels vs CPU plain versions (``grad_parity``:
    the CPU replays the GPU's LeakyReLU slopes; the deepest levels hold 5 x
    4 pixels a plane, where one flipped slope moves a leaf beyond
    GRAD_TOL)."""
    import torch

    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.models.unet import unet_from_plans

    cpu = unet_from_plans(task002_heart_2d(), conv_impl="pallas", fused_norm_act=False,
                          generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(8)
    seg = np.zeros((2, 320, 256), np.int32)
    seg[:, 100:200, 80:170] = 1
    data = (rng.randn(2, 1, 320, 256) + seg[:, None]).astype(np.float32)
    grad_parity("unet train parity", cpu, data, seg, "unet2d", (7, 6), card)


def ncc_planes(rng: np.random.RandomState, n: int, h: int, w: int):
    """I in [0, 1) with a constant corner (var cancels there), J a noisy copy."""
    import torch

    a = rng.rand(n, h, w).astype(np.float32)
    a[:, : h // 3, : w // 3] = 0.4
    b = (0.7 * a + 0.3 * rng.rand(n, h, w)).astype(np.float32)
    return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()


def check_ncc(card: str) -> tuple[dict, dict]:
    """Phase 16: K4 against its plain version across its plan's edges, with
    times at the SegFlow loss shapes; then the op's entry point,
    ncc_loss_kernel, driven alone."""
    import torch

    from csof_tpu_torch.bounds import bound_ms, ncc_loss_work, ncc_work
    from csof_tpu_torch.ops import losses as L
    from csof_tpu_torch.ops.kernels import ncc as k4

    rng = np.random.RandomState(9)
    res = {"max_abs_err": 0.0, "library_ms": None}
    planes = {}
    for n, h, w, window in NCC_CASES:
        pa, pb = ncc_planes(rng, n, h, w)
        got = k4.ncc_map_cuda(pa, pb, window)
        torch.cuda.synchronize()
        err = compare("ncc", f"K4 float32 (N, H, W)=({n}, {h}, {w}) window {window}", got,
                      k4.ncc_map_plain(pa, pb, window), NCC_ATOL, 0.0)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if (h, w, window) == (128, 128, 9):
            planes[n] = (pa, pb)
    for n, h, w, window in NCC_UNALIGNED:
        pa, pb = ncc_planes(rng, n, h, w)
        for dtype in (torch.float32, torch.bfloat16):
            a, b = unaligned(pa.to(dtype)), unaligned(pb.to(dtype))
            got = k4.ncc_map_cuda(a, b, window)
            torch.cuda.synchronize()
            err = compare("ncc", f"K4 {str(dtype).removeprefix('torch.')} off the 16-byte grid "
                          f"({n}, {h}, {w}) window {window}", got, k4.ncc_map_plain(a, b, window),
                          NCC_ATOL, 0.0)
            res["max_abs_err"] = max(res["max_abs_err"], err)
    bad = k4.division_mismatches(9)
    expect(bad == 0, f"window 9's division differs from IEEE division at {bad} floats")
    phase("ncc", "window 9's division by 81 without a divide: equal to IEEE division at all "
          "2^32 float32 values")

    # device and host time from a fresh process: torch.profiler loses device
    # events after many traces in one (phase 16 once read a third of them);
    # a second process where the first one's traces named no K4 kernel
    for attempt in (1, 2):
        proc = subprocess.run([sys.executable, "-m", "csof_tpu_torch.kernel_times",
                               "--only=K4"], capture_output=True, text=True, timeout=600)
        expect(proc.returncode == 0, f"kernel_times --only=K4 failed:\n{proc.stderr[-2000:]}")
        kt = json.loads(proc.stdout.strip().splitlines()[-1])
        if all(kt[f"K4_loss_{n}_kernels"] for n in NCC_TIMED) or attempt == 2:
            break
        phase("ncc", "kernel_times --only=K4: a trace without K4's kernel; once more")
    for n in NCC_TIMED:
        pa, pb = planes[n]
        la, lb = pa[..., None], pb[..., None]
        ms, plain_ms = timed_pair(lambda: k4.ncc_map_cuda(pa, pb),
                                  lambda: k4.ncc_map_plain(pa, pb))
        dev, host = kt[f"K4_map_{n}_device_ms"], kt[f"K4_map_{n}_host_us"]
        bnd, by = bound_ms(*ncc_work(n, 128, 128))
        loss_ms = median_ms(lambda: k4.ncc_loss_kernel(la, lb))
        loss_dev, loss_host = kt[f"K4_loss_{n}_device_ms"], kt[f"K4_loss_{n}_host_us"]
        loss_bnd = bound_ms(*ncc_loss_work(n, 128, 128))[0]
        note_ms = median_ms(lambda: L.ncc_loss(la, lb, reduction="none"))
        phase("ncc", f"K4 map ({n}, 128, 128): events {ms:.4f} ms, device {dev:.4f} ms, host "
              f"{host:.1f} us a call, bound {bnd:.6f} ms ({by}), plain {plain_ms:.4f} ms; loss "
              f"(no map): events {loss_ms:.4f} ms, device {loss_dev:.4f} ms, host "
              f"{loss_host:.1f} us a call, bound {loss_bnd:.6f} ms; library: none (no one "
              f"PyTorch call; note: the port's ncc_loss map, average pooling and elementwise "
              f"calls, {note_ms:.4f} ms) ({card})")
        suffix = "" if n == NCC_TIMED[0] else f"_{n}"
        res.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                    f"device_ms{suffix}": dev, f"host_us{suffix}": host,
                    f"bound_ms{suffix}": bnd, f"loss_ms{suffix}": loss_ms,
                    f"loss_device_ms{suffix}": loss_dev, f"loss_host_us{suffix}": loss_host,
                    f"loss_bound_ms{suffix}": loss_bnd})
        if not suffix:
            res["bound_by"] = by
        names = kt[f"K4_loss_{n}_kernels"]
        expect(kt[f"K4_loss_{n}_launches"] == len(names) == 1 and "ncc_kernel" in names[0],
               f"ncc_loss_kernel: {kt[f'K4_loss_{n}_launches']} launches a call, device "
               f"events {names}")

    # the same bits run to run
    pa, pb = planes[88]
    maps = [k4.ncc_map_cuda(pa, pb) for _ in range(2)]
    losses = [k4.ncc_loss_kernel(pa[..., None], pb[..., None]) for _ in range(3)]
    torch.cuda.synchronize()
    expect(torch.equal(maps[0], maps[1]), "K4 map: two runs on the same inputs differ")
    expect(losses[0].item() == losses[1].item() == losses[2].item(),
           f"ncc_loss_kernel: three runs differ: {[v.item() for v in losses]}")
    phase("ncc", f"K4 map twice and the loss three times at (88, 128, 128): bit-identical; "
          f"ncc_loss_kernel is one device kernel ({names[0][:60]}...)")

    pa, pb = planes[20]
    moving = pa[..., None]
    fixed = pb[:1].expand_as(pb)[..., None].contiguous()
    _reset_counts()
    value = k4.ncc_loss_kernel(moving, fixed)
    torch.cuda.synchronize()
    counts = _read_counts()
    ref = L.ncc_loss(moving, fixed)
    expect(abs(value.item() - ref.item()) <= 1e-5,
           f"ncc_loss_kernel {value.item()} vs ncc_loss {ref.item()}")
    expect(counts["K4"] == 1 and sum(counts.values()) == 1, f"launches {counts}")
    phase("ncc", f"ncc_loss_kernel on {tuple(moving.shape)}: {value.item():.6f} vs ncc_loss "
          f"{ref.item():.6f}; launches {counts} ({card})")
    a3, b3 = ncc_planes(rng, 4 * 3, 128, 128)
    a3, b3 = (t.view(4, 3, 128, 128).permute(0, 2, 3, 1).contiguous() for t in (a3, b3))
    for label, (x, y) in (("C = 3", (a3, b3)),
                          ("bf16", (moving.bfloat16(), fixed.bfloat16()))):
        value, ref = k4.ncc_loss_kernel(x, y), L.ncc_loss(x, y)
        expect(abs(value.item() - ref.item()) <= 1e-5,
               f"ncc_loss_kernel {label}: {value.item()} vs ncc_loss {ref.item()}")
        phase("ncc", f"ncc_loss_kernel {label} {tuple(x.shape)}: {value.item():.6f} vs ncc_loss "
              f"{ref.item():.6f}")
    return res, counts


# ---------------------------------------------------------------------------
# SegFlow under the JAX package's kernel switches, its other configurations,
# and K4's wide windows (phases 17-21)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def conv_shapes(record: dict):
    """Record each distinct K6 call SegFlow makes, (x shape, dtype, Co,
    bias, whether x needs a gradient) -> calls, by wrapping the conv that
    ConvNormAct calls (the wrapper still counts its launches)."""
    from csof_tpu_torch.models import blocks

    orig = blocks.conv3x3

    def rec(x, weight, bias=None, out_f32=False):
        key = (tuple(x.shape), x.dtype, weight.shape[0], bias is not None, x.requires_grad)
        record[key] = record.get(key, 0) + 1
        return orig(x, weight, bias, out_f32)

    blocks.conv3x3 = rec
    try:
        yield record
    finally:
        blocks.conv3x3 = orig


@contextlib.contextmanager
def norm_act_shapes(record: dict):
    """Count the K5 calls a model makes by shape, by wrapping the function
    ConvNormAct calls (the wrapper still counts its launches)."""
    from csof_tpu_torch.models import blocks

    orig = blocks.instance_norm_leaky_relu

    def rec(x, *args, **kw):
        key = tuple(x.shape)
        record[key] = record.get(key, 0) + 1
        return orig(x, *args, **kw)

    blocks.instance_norm_leaky_relu = rec
    try:
        yield record
    finally:
        blocks.instance_norm_leaky_relu = orig


@contextlib.contextmanager
def env(**values):
    """Set environment variables for a block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median host-clock ms of fn() ending in a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def segflow_pallas_serving(card: str) -> tuple[dict, dict]:
    """Phase 17: the flagship serving forward (bench geometry, bf16,
    fused_cm, full width) with CSOF_CONV2D_IMPL=pallas: K6 launched exactly
    where the JAX package routes its Pallas conv (87 a forward, the count
    tests/test_torch_segflow_k6.py holds against JAX's), host-clock time with
    the switch on and off (off, on, on, off), and a float32 forward at the
    same widths against the CPU's."""
    import dataclasses

    import torch

    from csof_tpu_torch.config.experiment import SegFlowModelConfig
    from csof_tpu_torch.inference.serving import apply_serving_config
    from csof_tpu_torch.models.segflow import SegFlow

    cfg = apply_serving_config(SegFlowModelConfig(), T_FRAMES)
    on = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(0), conv_impl="pallas")
    off = SegFlow(cfg, 4, conv_impl="native")
    off.load_state_dict(on.state_dict())
    on, off = on.cuda().eval(), off.cuda().eval()
    video = torch.from_numpy(np.random.RandomState(0).rand(BATCH, T_FRAMES, 128, 128, 1)
                             .astype(np.float32)).cuda()
    want = on.kernel_launches(T_FRAMES, 128)
    expect(want == {"K5": 0, "K6": PALLAS_SERVING_K6}, f"kernel_launches {want}")
    shapes = {}
    with torch.inference_mode():
        on(video)  # warm-up
        _reset_counts()
        with conv_shapes(shapes):
            out = on(video)
        torch.cuda.synchronize()
        counts = _read_counts()
        ref = off(video)
        times = [host_ms(lambda m=m: m(video)) for m in (off, on, on, off)]
    expect(counts == {"K1": 34, "K2": 0, "K3": 34, "K4": 0, "K5": 0, "K6": want["K6"],
                      "K6_dx": 0, "K7": 0, "K7_dx": 0},
           f"launches of one forward under pallas: {counts}")
    for key in ("seg_logits", "cum_flow", "registered"):
        expect(bool(torch.isfinite(out[key]).all()), f"non-finite {key} under pallas")
    diff = float((out["cum_flow"].float() - ref["cum_flow"].float()).abs().max())
    phase("segflow pallas serving", f"forward ({BATCH}, {T_FRAMES}, 128, 128, 1) bf16 "
          f"fused_cm, CSOF_CONV2D_IMPL=pallas: launches {counts} (K6 {want['K6']} = the JAX "
          f"package's routed convs); host clock median off {times[0]:.3f} / on {times[1]:.3f} "
          f"/ on {times[2]:.3f} / off {times[3]:.3f} ms; bf16 cum_flow on vs off max "
          f"|diff| {diff:.3e} ({card})")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu = SegFlow(cfg32, 4, conv_impl="pallas")
    cpu.load_state_dict(on.state_dict())
    gpu = copy.deepcopy(cpu).cuda()
    small = np.random.RandomState(1).rand(1, 3, 128, 128, 1).astype(np.float32)
    with torch.inference_mode():
        _reset_counts()
        got = gpu(torch.from_numpy(small).cuda())
        torch.cuda.synchronize()
        k6_n = _read_counts()["K6"]
        want_cpu = cpu(torch.from_numpy(small))
    expect(k6_n == gpu.kernel_launches(3, 128)["K6"], f"float32 forward: K6 {k6_n}")
    for key in ("seg_logits", "flow", "cum_flow", "registered"):
        compare("segflow pallas serving", f"float32 {key} GPU (K6 x{k6_n}) vs CPU",
                got[key].cpu(), want_cpu[key], *MODEL_TOL)
    return counts, shapes


def _grad_worst(gpu, cpu) -> tuple[float, str]:
    """The worst |diff| / (GRAD_TOL max|g| + 1e-6) over the parameters."""
    import torch

    worst, worst_name = 0.0, None
    ref = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        r = ref[name].grad
        if r is None:
            expect(p.grad is None or not bool(p.grad.any()), f"{name}: gradient on one side")
            continue
        g = p.grad.cpu()
        expect(bool(torch.isfinite(g).all()), f"{name}: non-finite gradient")
        ratio = float((g - r).abs().max()) / (GRAD_TOL * float(r.abs().max()) + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def segflow_pallas_train(card: str) -> tuple[dict, dict]:
    """Phase 18: Trainer steps of the flagship at the training geometry
    (4 x 6 x 128^2, bf16, concat + deep supervision, CSOF_CONV2D_IMPL=pallas
    read by build_model): K1 and K2 16, K6 55 and K6 dx 52 a step (the
    query encoder's first conv and the memory encoder's first at frames 0
    and 1 take no dx); host-clock step with the switch on and off; then the
    float32 loss and every gradient GPU vs CPU at (1, 4, 128, 128), the
    widths phase 19 checks the other configurations at."""
    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, SegFlowModelConfig
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.training.trainer import Trainer, build_model, make_segflow_loss

    config = ExperimentConfig(
        segflow=SegFlowModelConfig(deep_supervision=True),
        data=DataConfig(do_data_aug=False, batch_size=TRAIN_BATCH, video_length=TRAIN_T,
                        crop_size=TRAIN_HW))
    loader = VideoChunkLoader(synthetic_videos(), TRAIN_T, TRAIN_BATCH, TRAIN_HW, seed=0)
    batch = next(loader)
    shapes, step_ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for switch in ("native", "pallas"):
            with env(CSOF_CONV2D_IMPL=switch):
                trainer = Trainer(config, Path(tmp) / switch, device="cuda").initialize()
            expect({m.conv_impl for m in trainer.model.modules() if hasattr(m, "conv_impl")}
                   == {switch}, f"Trainer built SegFlow without conv_impl={switch}")
            losses = [trainer.run_iteration(batch)[0] for _ in range(PALLAS_TRAIN_WARMUP)]
            _reset_counts()
            with conv_shapes(shapes if switch == "pallas" else {}):
                losses.append(trainer.run_iteration(batch)[0])
            counts = _read_counts()
            step_ms[switch] = host_ms(lambda: losses.append(trainer.run_iteration(batch)[0]),
                                      reps=PALLAS_TRAIN_STEPS, warmup=0)
            expect(all(np.isfinite(losses)), f"{switch}: losses {losses}")
            want = trainer.model.kernel_launches(TRAIN_T, TRAIN_HW, backward=True)
            k6 = (want["K6"], want["K6_dx"]) if switch == "pallas" else (0, 0)
            expect(counts == {"K1": CORR_PER_STEP, "K2": CORR_PER_STEP, "K3": 0, "K4": 0,
                              "K5": 0, "K6": k6[0], "K6_dx": k6[1], "K7": 0, "K7_dx": 0},
                   f"{switch}: launches of one step {counts}")
            phase("segflow pallas train", f"{switch}: step ({TRAIN_BATCH}, {TRAIN_T}, "
                  f"{TRAIN_HW}, {TRAIN_HW}, 1) bf16 concat + deep supervision: launches "
                  f"{counts}; host clock median {step_ms[switch]:.3f} ms over "
                  f"{PALLAS_TRAIN_STEPS} steps; losses {losses[0]:.5f} -> {losses[-1]:.5f} "
                  f"({card})")
            pallas_counts = counts
    expect((want["K6"], want["K6_dx"]) == PALLAS_TRAIN_K6, f"kernel_launches {want}")

    config32 = ExperimentConfig(segflow=SegFlowModelConfig(deep_supervision=True,
                                                           dtype="float32"),
                                data=DataConfig(do_data_aug=False))
    with env(CSOF_CONV2D_IMPL="pallas"):
        cpu = build_model(config32, 4, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    small = next(VideoChunkLoader(synthetic_videos(1), 4, 1, 128, seed=3))
    loss_fn = make_segflow_loss(config32)
    _reset_counts()
    loss_gpu, _ = loss_fn(gpu, {k: torch.from_numpy(v).cuda() for k, v in small.items()})
    loss_gpu.backward()
    torch.cuda.synchronize()
    counts = _read_counts()
    want = gpu.kernel_launches(4, 128, backward=True)
    expect((counts["K6"], counts["K6_dx"]) == (want["K6"], want["K6_dx"]),
           f"float32 step: launches {counts}, expected {want}")
    loss_cpu, _ = loss_fn(cpu, {k: torch.from_numpy(v) for k, v in small.items()})
    loss_cpu.backward()
    a, b = loss_gpu.item(), loss_cpu.item()
    expect(abs(a - b) <= LOSS_RTOL * abs(b), f"loss GPU {a} vs CPU {b}")
    worst, worst_name = _grad_worst(gpu, cpu)
    phase("segflow pallas train", f"float32 (1, 4, 128, 128, 1) concat + deep supervision, "
          f"K6 x{counts['K6']} + dx x{counts['K6_dx']}: loss GPU {a:.7f} vs CPU {b:.7f}; worst "
          f"|diff| / (tol {GRAD_TOL:g} max|g| + 1e-6) = {worst:.3f} at {worst_name} "
          f"-> {'ok' if worst <= 1 else 'FAIL'} ({card})")
    expect(worst <= 1, f"gradient {worst_name} outside tolerance")
    return pallas_counts, shapes


def segflow_modes(card: str) -> dict:
    """Phase 19: every other configuration the JAX SegFlowModelConfig runs,
    once forward and backward (the trainer's loss) at full width, batch 1 x
    4 x 128^2, float32, CSOF_CONV2D_IMPL=pallas, the card against the CPU:
    split + fuse_q_hoist, project, mean1, the linear decoder, remat; then
    norm="instance" with K5 (CSOF_FUSED_NORM=1), forward only, and K5 alone
    against its plain version at each shape that forward gave it."""
    import torch

    from csof_tpu_torch.config.experiment import ExperimentConfig, SegFlowModelConfig
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.models.segflow import SegFlow
    from csof_tpu_torch.training.trainer import make_segflow_loss

    batch = next(VideoChunkLoader(synthetic_videos(1), 4, 1, 128, seed=5))
    total = {}
    for name, kw in MODES:
        cfg = SegFlowModelConfig(dtype="float32", **kw)
        loss_fn = make_segflow_loss(ExperimentConfig(segflow=cfg))
        cpu = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(3), conv_impl="pallas")
        gpu = copy.deepcopy(cpu).cuda()
        _reset_counts()
        loss_gpu, _ = loss_fn(gpu, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
        loss_gpu.backward()
        torch.cuda.synchronize()
        counts = _read_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        want = gpu.kernel_launches(4, 128, backward=True)
        # remat runs each step's forward again in the backward: K1 twice
        expect((counts["K6"], counts["K6_dx"]) == (want["K6"], want["K6_dx"]) and counts["K1"]
               == counts["K2"] * (2 if cfg.remat else 1) > 0,
               f"{name}: launches {counts}, expected {want}")
        loss_cpu, _ = loss_fn(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss_cpu.backward()
        a, b = loss_gpu.item(), loss_cpu.item()
        expect(abs(a - b) <= LOSS_RTOL * abs(b), f"{name}: loss GPU {a} vs CPU {b}")
        worst, worst_name = _grad_worst(gpu, cpu)
        phase("segflow modes", f"{name}: loss GPU {a:.7f} vs CPU {b:.7f}; launches {counts}; "
              f"worst gradient |diff| / (tol {GRAD_TOL:g} max|g| + 1e-6) = {worst:.3f} at "
              f"{worst_name} -> {'ok' if worst <= 1 else 'FAIL'}")
        expect(worst <= 1, f"{name}: gradient {worst_name} outside tolerance")

    from csof_tpu_torch.ops.kernels import norm_act as k5

    cfg = SegFlowModelConfig(dtype="float32", norm="instance")
    cpu = SegFlow(cfg, 4, generator=torch.Generator().manual_seed(4), conv_impl="pallas",
                  fused_norm_act=True).eval()
    gpu = copy.deepcopy(cpu).cuda()
    video = torch.from_numpy(batch["video"])
    k5_shapes = {}
    with torch.inference_mode():
        _reset_counts()
        with norm_act_shapes(k5_shapes):
            got = gpu(video.cuda())
        torch.cuda.synchronize()
        counts = _read_counts()
        ref = cpu(video)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    want = gpu.kernel_launches(4, 128)
    expect((counts["K5"], counts["K6"]) == (want["K5"], want["K6"]) and want["K5"] > 0,
           f"instance + K5: launches {counts}, expected {want}")
    for key in ("seg_logits", "flow", "cum_flow", "registered"):
        compare("segflow modes", f"instance norm + K5 x{counts['K5']} + K6 x{counts['K6']}: "
                f"{key} GPU vs CPU", got[key].cpu(), ref[key], *MODEL_TOL)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape in sorted(k5_shapes):  # K5 alone at each shape SegFlow gave it
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            scale = 1.0 + 0.2 * torch.randn(shape[1], generator=gen, device="cuda")
            bias = 0.2 * torch.randn(shape[1], generator=gen, device="cuda")
            out = k5.norm_act_cuda(x, scale, bias)
            torch.cuda.synchronize()
            dname = str(dtype).removeprefix("torch.")
            compare("segflow modes", f"K5 {dname} (N, C, H, W)={shape}", out,
                    k5.norm_act_plain(x, scale, bias), *UNET_TOL[("K5", dname)])
    phase("segflow modes", f"launches over the modes: {total} ({card})")
    return total


def check_segflow_convs(card: str, serving: dict, train: dict) -> dict:
    """Phase 20: K6 and its dx at every distinct shape SegFlow gave them
    in phases 17 and 18 (Ci 1, 6, 32, 64, 128, 145, 209; dx outputs 6, 32,
    64, 128, 145, 209 channels wide), bf16 as run and float32, against
    their plain versions; the bf16 K6 time of one serving forward and the
    dx time of one training step (each shape's median times its launches)
    beside the plain version's, the library call's and the bound."""
    import torch

    return check_recorded_convs("segflow convs", serving, train, {}, torch.bfloat16, card,
                                ("one serving forward", "one training step's dx"))


def check_recorded_convs(label: str, timed_fwd: dict, timed_dx: dict, others: dict, dtype,
                         card: str, what: tuple[str, str], seed: int = 5) -> dict:
    """K6 and its dx against their plain versions (bf16 and float32, phase
    9's tolerances) at every distinct shape of the ``conv_shapes`` records
    ``timed_fwd``, ``timed_dx`` and ``others`` (a dx where a record's input
    needed a gradient); the ``dtype`` time of the forward ``timed_fwd``
    recorded and of the dx of ``timed_dx`` (each shape's median times its
    launches there) beside the plain version's, the library call's and the
    bound. Returns {"fwd", "dx": {ms, plain_ms, library_ms, bound_ms,
    bound_by}, "max_abs_err"}."""
    import torch

    from csof_tpu_torch.bounds import bound_ms, conv3x3_work
    from csof_tpu_torch.ops.kernels import conv as k6

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    res = {"fwd": [0.0, 0.0, 0.0], "dx": [0.0, 0.0, 0.0], "err": 0.0}
    works = {"fwd": [], "dx": []}
    fwd, dxs = {}, {}
    for rec in (timed_fwd, timed_dx, others):
        for (shape, _, co, bias, grad), n in rec.items():
            fwd[(shape, co, bias)] = fwd.get((shape, co, bias), 0) + (n if rec is timed_fwd else 0)
            if grad:
                dxs[(shape, co)] = dxs.get((shape, co), 0) + (n if rec is timed_dx else 0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    for (shape, co, bias), n_serving in sorted(fwd.items()):
        n, ci, h, w = shape
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).removeprefix("torch.")
            x = rand(*shape).to(dt)
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5)
            b = rand(co, std=0.1) if bias else None
            got = k6.conv3x3_cuda(x, wt, b)
            torch.cuda.synchronize()
            err = compare(label, f"K6 {dname} (N, Ci, Co, H, W)=({n}, {ci}, {co}, {h}, "
                          f"{w})", got, k6.conv3x3_plain(x, wt, b), *UNET_TOL[("K6", dname)])
            res["err"] = max(res["err"], err)
            if dt != dtype or not n_serving:
                continue
            t, p = timed_pair(lambda: k6.conv3x3_cuda(x, wt, b),
                              lambda: k6.conv3x3_plain(x, wt, b))
            lib = median_ms(lambda: torch.nn.functional.conv2d(x, wt.to(dt),
                                                               None if b is None
                                                               else b.to(dt), padding=1))
            res["fwd"] = [a + n_serving * v for a, v in zip(res["fwd"], (t, p, lib))]
            works["fwd"].append((conv3x3_work(n, h, w, ci, co, itemsize, bias), n_serving))
    for ((n, ci, h, w), co), count in sorted(dxs.items()):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).removeprefix("torch.")
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5)
            dy = rand(n, co, h, w).to(dt)
            got = k6.conv3x3_dx_cuda(dy, wt)
            torch.cuda.synchronize()
            err = compare(label, f"K6 dx {dname} dy (N, Co, H, W)=({n}, {co}, {h}, {w})"
                          f" -> dx {ci} channels", got, k6.conv3x3_dx_plain(dy, wt),
                          *UNET_TOL[("K6", dname)])
            res["err"] = max(res["err"], err)
            if dt != dtype or not count:
                continue
            wl = wt.to(dt)
            t, p = timed_pair(lambda: k6.conv3x3_dx_cuda(dy, wt),
                              lambda: k6.conv3x3_dx_plain(dy, wt))
            lib = median_ms(lambda: torch.nn.grad.conv2d_input((n, ci, h, w), wl, dy, padding=1))
            res["dx"] = [a + count * v for a, v in zip(res["dx"], (t, p, lib))]
            works["dx"].append((conv3x3_work(n, h, w, co, ci, itemsize, False), count))
    out = {}
    for key, name in zip(("fwd", "dx"), what):
        summed = tuple(sum(c * wk[i] for wk, c in works[key]) for i in range(4))
        bnd, by = bound_ms(*summed)
        t, p, lib = res[key]
        phase(label, f"K6 {'dx ' if key == 'dx' else ''}{str(dtype).removeprefix('torch.')}, "
              f"{name} "
              f"({sum(c for _, c in works[key])} launches at {len(works[key])} shapes): kernel "
              f"{t:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound {bnd:.4f} ms ({by}) "
              f"({card})")
        out[key] = {"ms": t, "plain_ms": p, "library_ms": lib, "bound_ms": bnd, "bound_by": by}
    out["max_abs_err"] = res["err"]
    return out


def check_ncc_wide(card: str) -> tuple[dict, dict]:
    """Phase 21: K4 at windows whose rings shared memory cannot hold (F9):
    ncc_plan takes the two-pass path; the map and the loss against the
    plain version, with their times and bounds."""
    import torch

    from csof_tpu_torch.bounds import bound_ms, ncc_loss_work, ncc_work
    from csof_tpu_torch.ops.kernels import ncc as k4

    rng = np.random.RandomState(10)
    res = {"max_abs_err": 0.0}
    counts = {}
    for n, h, w, window in NCC_WIDE:
        pa, pb = ncc_planes(rng, n, h, w)
        plan = k4.ncc_plan(n, h, w, window, 4)
        expect(plan.path == "two_pass", f"({n}, {h}, {w}) window {window}: plan {plan}")
        _reset_counts()  # the entry points driven once; the timing launches are not counted
        got = k4.ncc_map_cuda(pa, pb, window)
        loss = k4.ncc_loss_kernel(pa[..., None], pb[..., None], window)
        torch.cuda.synchronize()
        counts = {k: counts.get(k, 0) + v for k, v in _read_counts().items()}
        ref = k4.ncc_map_plain(pa, pb, window)
        err = compare("ncc wide", f"K4 two-pass map ({n}, {h}, {w}) window {window}", got, ref,
                      NCC_ATOL, 0.0)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ref_loss = 1.0 - ref.clamp(0.001, 0.999).mean()
        expect(abs(loss.item() - ref_loss.item()) <= 1e-5,
               f"two-pass loss {loss.item()} vs plain {ref_loss.item()}")
        ms, plain_ms = timed_pair(lambda: k4.ncc_map_cuda(pa, pb, window),
                                  lambda: k4.ncc_map_plain(pa, pb, window))
        loss_ms = median_ms(lambda: k4.ncc_loss_kernel(pa[..., None], pb[..., None], window))
        bnd, by = bound_ms(*ncc_work(n, h, w, window))
        loss_bnd = bound_ms(*ncc_loss_work(n, h, w, window))[0]
        phase("ncc wide", f"K4 two-pass ({n}, {h}, {w}) window {window}: map {ms:.4f} ms (plain "
              f"{plain_ms:.4f}, bound {bnd:.5f} ({by})), loss {loss_ms:.4f} ms (bound "
              f"{loss_bnd:.5f}; {loss.item():.6f} vs plain {ref_loss.item():.6f}) ({card})")
        key = f"wide_{n}x{h}x{w}_w{window}"
        res.update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms, f"{key}_bound_ms": bnd,
                    f"{key}_loss_ms": loss_ms, f"{key}_loss_bound_ms": loss_bnd})
    expect(counts["K4"] == 4 * len(NCC_WIDE) and sum(counts.values()) == counts["K4"],
           f"launches {counts}")
    return res, counts


#: the keys every kernel has in the kernels line; a kernel's other measured
#: numbers (bf16 or float32 times, library notes, K3's passes) follow them
def cine_task(task: Path, rng: np.random.RandomState) -> Path:
    """A task with CLI_CINES cines (cine/<pid>_4d.nii.gz, T_FRAMES x DEPTH x
    CINE_HW), their ED/ES numbers in dataset.json and ED/ES labels in
    labelsTr, written with the port's NIfTI writer."""
    from csof_tpu_torch.utils.nifti import save_nifti

    for sub in ("cine", "labelsTr"):
        (task / sub).mkdir(parents=True)
    ed_es = {}
    for i in range(CLI_CINES):
        pid = f"patient{i + 1:03d}"
        cine = synthetic_cine(rng)  # (T, D, H, W)
        save_nifti(cine, task / "cine" / f"{pid}_4d.nii.gz", spacing_xyz=(1.5, 1.5, 10.0))
        for frame in CLI_ED_ES:
            save_nifti((cine[frame - 1] > 100).astype(np.uint8),
                       task / "labelsTr" / f"{pid}_frame{frame:02d}.nii.gz",
                       spacing_xyz=(1.5, 1.5, 10.0))
        ed_es[pid] = {"ed": CLI_ED_ES[0], "es": CLI_ED_ES[1]}
    (task / "dataset.json").write_text(json.dumps({"name": "synthetic", "ed_es_numbers": ed_es}))
    return task


def cli_inputs(tmp: Path, plans) -> tuple[Path, Path, Path]:
    """Phase 22's inputs, written with the port's NIfTI writer: a task with
    CLI_CINES cines (cine/<pid>_4d.nii.gz), their ED/ES numbers in
    dataset.json and ED/ES labels in labelsTr; CLI_UNET_CASES Task002-like
    volumes as a folder of *_0000.nii.gz with their labels; and a 2d
    preprocessed root (plans_2D.json, preprocessed_2d/) built as phase 14
    builds one. Returns (task, U-Net task, preprocessed root)."""
    from csof_tpu_torch.data.cropping import run_cropping
    from csof_tpu_torch.data.preprocessing import Preprocessor
    from csof_tpu_torch.utils.nifti import save_nifti

    rng = np.random.RandomState(11)
    task = cine_task(tmp / "task", rng)
    unet_task, pre = tmp / "unet_task", tmp / "pre"
    for sub in ("imagesTs", "labelsTs"):
        (unet_task / sub).mkdir(parents=True)
    spacing_xyz = (UNET_SPACING, UNET_SPACING, 1.37)
    cases = []
    for i in range(CLI_UNET_CASES):
        img = synthetic_case(rng, CLI_UNET_DEPTH)
        img_path = unet_task / "imagesTs" / f"la_{i:03d}_0000.nii.gz"
        seg_path = unet_task / "labelsTs" / f"la_{i:03d}.nii.gz"
        save_nifti(img, img_path, spacing_xyz=spacing_xyz)
        save_nifti((img > 150).astype(np.uint8), seg_path, spacing_xyz=spacing_xyz)
        cases.append((f"la_{i:03d}", [str(img_path)], str(seg_path)))
    run_cropping(cases, tmp / "cropped")
    Preprocessor(plans).run(tmp / "cropped", pre / "preprocessed_2d")
    plans.to_json(pre / "plans_2D.json")
    return task, unet_task, pre


def run_command(counts: dict, label: str, name: str, entry, argv: list, want: dict, card: str,
                **environ) -> float:
    """One command through its entry function on its own launch counts,
    host-clocked (ending in a synchronize); the counts must equal ``want``.
    Returns the host seconds."""
    import torch

    with env(**environ):
        _reset_counts()
        t0 = time.perf_counter()
        entry([str(a) for a in argv])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[name] = {k: v for k, v in _read_counts().items() if v}
    want = {k: v for k, v in want.items() if v}
    expect(counts[name] == want, f"{name}: launches {counts[name]}, expected {want}")
    phase(label, f"{name}: {secs:.3f} s host clock, launches {counts[name]} ({card})")
    return secs


def cli_phase(card: str) -> dict:
    """Phase 22: the port's command line at full width, each command through
    its entry function. Returns the launches of each command."""
    import dataclasses

    import torch

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import (
        DataConfig,
        ExperimentConfig,
        load_experiment_config,
    )
    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.data.dataset import do_split, load_dataset
    from csof_tpu_torch.utils.nifti import load_nifti
    from csof_tpu_torch.utils.logging import read_training_logs

    counts = {}

    def run(name: str, entry, argv: list, want: dict, **environ) -> None:
        run_command(counts, "cli", name, entry, argv, want, card, **environ)

    plans = task002_heart_2d()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        task, unet_task, pre = cli_inputs(tmp, plans)
        phase("cli", f"inputs: {CLI_CINES} cines {(T_FRAMES, DEPTH, *CINE_HW)}, "
              f"{CLI_UNET_CASES} cases {(1, CLI_UNET_DEPTH, *UNET_HW)} preprocessed, in "
              f"{time.perf_counter() - t0:.1f} s host clock")

        # csof_torch_train, SegFlow: default widths, bf16, the video augmentation
        flow_cfg = ExperimentConfig(
            model="segflow", max_num_epochs=CLI_FLOW_EPOCHS,
            num_batches_per_epoch=CLI_FLOW_STEPS, num_val_batches_per_epoch=CLI_FLOW_VAL,
            data=DataConfig(batch_size=TRAIN_BATCH, video_length=TRAIN_T, crop_size=TRAIN_HW))
        expect(flow_cfg.data.do_data_aug and flow_cfg.segflow.dtype == "bfloat16",
               "the SegFlow config is not the default bf16 one with augmentation")
        flow_cfg.to_yaml(tmp / "segflow.yaml")
        steps = CLI_FLOW_EPOCHS * CLI_FLOW_STEPS
        evals = CLI_FLOW_EPOCHS * CLI_FLOW_VAL
        run("csof_torch_train segflow", cli.train_entry,
            ["-c", tmp / "segflow.yaml", "-p", tmp / "unused", "-t", task, "-o", tmp / "flow"],
            {"K1": CORR_PER_STEP * (steps + evals), "K2": CORR_PER_STEP * steps})
        fold = tmp / "flow" / "fold_0"
        for name in ("config.yaml", "meta.json", "model_final_checkpoint.pt",
                     "model_final_checkpoint.pt.json"):
            expect((fold / name).is_file(), f"csof_torch_train segflow: {name} not written")
        epochs = [line for lines in read_training_logs(fold) for line in lines
                  if line.startswith("epoch ")]
        losses = [float(line.split(" train ")[1].split()[0]) for line in epochs]
        expect(len(losses) == CLI_FLOW_EPOCHS and all(np.isfinite(losses)),
               f"SegFlow epoch losses {losses}")
        expect(load_experiment_config(fold / "config.yaml") == flow_cfg,
               "config.yaml does not read back to the config")
        phase("cli", f"csof_torch_train segflow: epoch losses {losses}")

        # csof_torch_predict_flow: the fused_cm remap, mirror TTA, 3 cines
        run("csof_torch_predict_flow", cli.predict_flow_entry,
            ["-m", fold, "-t", task, "-o", tmp / "flow_out"],
            {"K1": CLI_CINES * LAUNCHES_PER_REQUEST, "K3": CLI_CINES * LAUNCHES_PER_REQUEST})
        for i in range(CLI_CINES):
            pid = f"patient{i + 1:03d}"
            flow = np.load(tmp / "flow_out" / "Flow" / f"{pid}.npz")["flow"]
            reg = load_nifti(tmp / "flow_out" / "Registered" / f"{pid}.nii.gz").data_czyx
            seg = load_nifti(tmp / "flow_out" / "Segmentation" / f"{pid}.nii.gz").data_czyx
            expect(flow.shape == (2, T_FRAMES, DEPTH, *CINE_HW) and np.isfinite(flow).all(),
                   f"{pid}: flow {flow.shape}")
            expect(reg.shape == seg.shape == (T_FRAMES, DEPTH, *CINE_HW)
                   and np.isfinite(reg).all(), f"{pid}: registered {reg.shape}, seg {seg.shape}")

        # csof_torch_train, U-Net: the Task002 2d plans, the default config
        # (augmentation on), K6 under CSOF_CONV2D_IMPL=pallas
        unet_cfg = ExperimentConfig(model="unet2d", max_num_epochs=1,
                                    num_batches_per_epoch=CLI_UNET_STEPS,
                                    num_val_batches_per_epoch=CLI_UNET_VAL)
        expect(unet_cfg.data.do_data_aug, "the U-Net config does not augment")
        unet_cfg.to_yaml(tmp / "unet.yaml")
        run("csof_torch_train unet2d", cli.train_entry,
            ["-c", tmp / "unet.yaml", "-p", pre, "-o", tmp / "unet"],
            {"K6": 7 * (CLI_UNET_STEPS + CLI_UNET_VAL), "K6_dx": 6 * CLI_UNET_STEPS,
             "K7": 26 * (CLI_UNET_STEPS + CLI_UNET_VAL), "K7_dx": 26 * CLI_UNET_STEPS},
            CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="0")
        unet_fold = tmp / "unet" / "fold_0"
        expect((unet_fold / "model_final_checkpoint.pt").is_file()
               and (unet_fold / "plans.json").is_file(), "U-Net checkpoint or plans not written")

        # --validation-only on the fold's validation case, then csof_torch_predict
        ds = load_dataset(pre / "preprocessed_2d")
        shapes = {k: np.load(v["data_file"])["data"].shape[1:] for k, v in ds.items()}
        _, val_keys = do_split(list(ds), 0, splits_file=pre / "splits.pkl")
        val_fwd = sum(unet_forwards(shapes[k], plans) for k in val_keys)
        run("csof_torch_train --validation-only", cli.train_entry,
            ["-c", tmp / "unet.yaml", "-p", pre, "-o", tmp / "unet", "--validation-only"],
            {"K6": 7 * val_fwd, "K7": 26 * val_fwd}, CSOF_CONV2D_IMPL="pallas",
            CSOF_FUSED_NORM="0")
        summary = json.loads((unet_fold / "validation_raw" / "summary.json").read_text())
        expect(len(summary["all"]) == len(val_keys) and "1" in summary["mean"],
               f"validation summary {summary.get('mean')}")
        pred_fwd = CLI_UNET_CASES * unet_forwards((CLI_UNET_DEPTH, *UNET_HW), plans)
        run("csof_torch_predict", cli.predict_entry,
            ["-m", unet_fold, "-i", unet_task / "imagesTs", "-o", tmp / "pred", "--save-npz"],
            {"K5": 26 * pred_fwd, "K6": 7 * pred_fwd}, CSOF_CONV2D_IMPL="pallas",
            CSOF_FUSED_NORM="1")
        for i in range(CLI_UNET_CASES):
            seg = load_nifti(tmp / "pred" / f"la_{i:03d}.nii.gz").data_czyx
            soft = np.load(tmp / "pred" / f"la_{i:03d}.npz")["softmax"]
            expect(seg.shape == (CLI_UNET_DEPTH, *UNET_HW) and np.isfinite(soft).all(),
                   f"case {i}: seg {seg.shape}, softmax finite {np.isfinite(soft).all()}")

        # csof_torch_evaluate and csof_torch_ensemble on those outputs
        run("csof_torch_evaluate", cli.evaluate_entry,
            ["-p", tmp / "pred", "-r", unet_task / "labelsTs", "-l", "1", "-o",
             tmp / "eval.json"], {})
        scores = json.loads((tmp / "eval.json").read_text())
        expect(len(scores["all"]) == CLI_UNET_CASES and "Dice" in scores["mean"]["1"],
               f"evaluation {scores['mean']}")
        run("csof_torch_ensemble", cli.ensemble_entry,
            ["-f", tmp / "pred", tmp / "pred", "-o", tmp / "ens"], {})
        for i in range(CLI_UNET_CASES):
            a = np.load(tmp / "ens" / f"la_{i:03d}.npz")["softmax"]
            b = np.load(tmp / "pred" / f"la_{i:03d}.npz")["softmax"]
            expect(np.allclose(a, b), f"case {i}: the ensemble of a folder with itself moved")

        # the same port-written folder on both devices: float32, no TTA, one cine
        cfg32 = load_experiment_config(fold / "config.yaml")
        cfg32 = dataclasses.replace(cfg32, segflow=dataclasses.replace(cfg32.segflow,
                                                                       dtype="float32"))
        fold32 = tmp / "flow32" / "fold_0"
        fold32.mkdir(parents=True)
        for name in ("model_final_checkpoint.pt", "model_final_checkpoint.pt.json",
                     "meta.json"):
            (fold32 / name).write_bytes((fold / name).read_bytes())
        cfg32.to_yaml(fold32 / "config.yaml")
        one = tmp / "task_one"
        (one / "cine").mkdir(parents=True)
        (one / "cine" / "patient001_4d.nii.gz").write_bytes(
            (task / "cine" / "patient001_4d.nii.gz").read_bytes())
        (one / "dataset.json").write_text(json.dumps(
            {"ed_es_numbers": {"patient001": {"ed": CLI_ED_ES[0], "es": CLI_ED_ES[1]}}}))
        per_forward = LAUNCHES_PER_REQUEST // 4
        run("csof_torch_predict_flow float32 GPU", cli.predict_flow_entry,
            ["-m", fold32, "-t", one, "-o", tmp / "gpu", "--disable-tta"],
            {"K1": per_forward, "K3": per_forward})
        run("csof_torch_predict_flow float32 CPU", cli.predict_flow_entry,
            ["-m", fold32, "-t", one, "-o", tmp / "cpu", "--disable-tta", "--device", "cpu"], {})
        for sub, key in (("Flow", "flow"), ("Registered", None)):
            f = f"patient001.{'npz' if key else 'nii.gz'}"
            got, ref = ((np.load(tmp / d / sub / f)[key] if key else
                         load_nifti(tmp / d / sub / f).data_czyx) for d in ("gpu", "cpu"))
            compare("cli", f"{sub} GPU vs CPU {got.shape}", torch.tensor(got), torch.tensor(ref),
                    *MODEL_TOL)
        cli_strain(tmp, task, card, counts)
    # the augmentation a train step runs, alone: CUDA events around each call
    # (host work inside: the draws' generator calls and the low-res levels)
    from csof_tpu_torch.data import augment as ta

    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.randn(40, 1, *plans.fullres_stage().patch_size)
                           .astype(np.float32)).cuda()
    seg = torch.from_numpy(rng.randint(0, 2, (40, *plans.fullres_stage().patch_size))).cuda()
    vid = torch.from_numpy(rng.rand(TRAIN_BATCH, TRAIN_T, TRAIN_HW, TRAIN_HW, 1)
                           .astype(np.float32)).cuda()
    vseg = torch.from_numpy(rng.randint(-1, 4, (TRAIN_BATCH, TRAIN_T, TRAIN_HW, TRAIN_HW))).cuda()
    gen = ta.step_generator(0, 0, "cuda")
    ms_2d = median_ms(lambda: ta.augment_batch_2d(gen, img, seg))
    ms_video = median_ms(lambda: ta.augment_video(gen, vid, vseg))
    phase("cli", f"augmentation: augment_batch_2d {tuple(img.shape)} {ms_2d:.3f} ms, "
          f"augment_video {tuple(vid.shape)} {ms_video:.3f} ms (CUDA events, median of 20; "
          f"{card})")
    return counts


def _report_diff(got, ref, path: str = "") -> float:
    """The largest |got - ref| over two analysis reports of the same layout;
    fails outside STRAIN_TOL or where one is NaN and the other not."""
    if isinstance(ref, dict):
        expect(sorted(got) == sorted(ref), f"analysis {path}: keys {sorted(got)} vs {sorted(ref)}")
        return max([_report_diff(got[k], ref[k], f"{path}/{k}") for k in ref] or [0.0])
    if isinstance(ref, list):
        expect(len(got) == len(ref), f"analysis {path}: {len(got)} vs {len(ref)} values")
        return max([_report_diff(a, b, f"{path}[{i}]") for i, (a, b) in
                    enumerate(zip(got, ref))] or [0.0])
    if np.isnan(ref):
        expect(np.isnan(got), f"analysis {path}: {got} where the CPU has NaN")
        return 0.0
    rtol, atol = STRAIN_TOL
    expect(abs(got - ref) <= atol + rtol * abs(ref), f"analysis {path}: card {got} vs CPU {ref}")
    return abs(got - ref)


def strain_labels(cine: np.ndarray) -> np.ndarray:
    """(T, D, H, W) labels of a synthetic cine: the bright disk as the LV
    cavity (3), a 4-pixel ring around it as the myocardium (2), the disk
    shifted 34 pixels in x outside both as the RV (1)."""
    from scipy.ndimage import binary_dilation

    disk = cine > 100
    ring = binary_dilation(disk, structure=np.ones((1, 1, 9, 9), bool)) & ~disk
    rv = np.roll(disk, 34, axis=-1) & ~disk & ~ring
    return (3 * disk + 2 * ring + rv).astype(np.uint8)


def cli_strain(tmp: Path, task: Path, card: str, counts: dict) -> None:
    """Phase 22's strain analysis. The predict_flow tree tmp/flow_out:
    csof_torch_strain (contour tracking against labels made from the
    cines) and csof_torch_jacobian on the card, csof_torch_strain on the
    CPU; the same flows with those labels as the segmentation on both
    devices; the perimeter pass and gaussian_smooth on both devices; then
    strain_curve_metric of the exported curves against themselves."""
    import torch

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.ops.filters import gaussian_smooth
    from csof_tpu_torch.ops.strain import perimeter_batch, perimeter_histogram
    from csof_tpu_torch.utils.nifti import load_nifti, save_nifti

    tree, gt_dir, gt_tree = tmp / "flow_out", tmp / "gt", tmp / "gt_tree"
    for d in (gt_dir, gt_tree / "Segmentation", gt_tree / "Flow"):
        d.mkdir(parents=True)
    labels = {}
    for i in range(CLI_CINES):
        pid = f"patient{i + 1:03d}"
        labels[pid] = strain_labels(load_nifti(task / "cine" / f"{pid}_4d.nii.gz").data_czyx)
        for d in (gt_dir, gt_tree / "Segmentation"):
            save_nifti(labels[pid], d / f"{pid}.nii.gz", spacing_xyz=(1.5, 1.5, 10.0))
        (gt_tree / "Flow" / f"{pid}.npz").write_bytes((tree / "Flow" / f"{pid}.npz").read_bytes())

    def run(name: str, entry, argv: list) -> None:
        run_command(counts, "cli", name, entry, argv, {}, card)

    run("csof_torch_strain", cli.strain_entry, ["-i", tree, "--gt-seg", gt_dir])
    run("csof_torch_jacobian", cli.jacobian_entry, ["-i", tree, "-o", tmp / "jacobian.json"])
    run("csof_torch_strain --device cpu", cli.strain_entry,
        ["-i", tree, "--gt-seg", gt_dir, "-o", tmp / "analysis_cpu.json", "--device", "cpu"])
    run("csof_torch_strain labels", cli.strain_entry, ["-i", gt_tree, "--gt-seg", gt_dir])
    run("csof_torch_strain labels --device cpu", cli.strain_entry,
        ["-i", gt_tree, "--gt-seg", gt_dir, "-o", tmp / "gt_cpu.json", "--device", "cpu"])
    for name, card_file, cpu_file in (("predict_flow tree", tree / "analysis.json",
                                       tmp / "analysis_cpu.json"),
                                      ("labels tree", gt_tree / "analysis.json",
                                       tmp / "gt_cpu.json")):
        got, ref = (json.loads(f.read_text()) for f in (card_file, cpu_file))
        expect(sorted(got) == [f"patient{i + 1:03d}" for i in range(CLI_CINES)]
               and all(set(e) == {"jacobian", "strain", "contour_tracking"} for e in got.values()),
               f"{name}: analysis {sorted(got)}")
        worst = _report_diff(got, ref)
        phase("cli", f"strain of the {name}, card vs CPU: analysis.json max |diff| {worst:.3e} "
              f"(rtol {STRAIN_TOL[0]}, atol {STRAIN_TOL[1]})")
        if name == "labels tree":
            radial = [v for e in got.values() for v in e["strain"]["lv_radial_strain_mean"]]
            expect(np.isfinite(radial).all() and max(map(abs, radial)) > 0,
                   f"{name}: radial strain {radial[:4]} ...")
    jac, ana = (json.loads(f.read_text()) for f in (tmp / "jacobian.json", tree / "analysis.json"))
    expect(all(jac[c]["jacobian"] == ana[c]["jacobian"] and jac[c]["strain"] == ana[c]["strain"]
               for c in ana), "csof_torch_jacobian and csof_torch_strain differ on the card")

    # the perimeter pass on integer masks: equal counts and perimeters on both devices
    masks = torch.from_numpy(np.concatenate([
        np.stack([lab == 1, lab == 3, (lab == 2) | (lab == 3)]).reshape(-1, *CINE_HW)
        for lab in labels.values()]))
    hist = perimeter_histogram(masks.cuda()).cpu()
    per = perimeter_batch(masks.cuda()).cpu()
    expect(torch.equal(hist, perimeter_histogram(masks)) and torch.equal(per, perimeter_batch(masks)),
           "perimeter histograms or perimeters differ between the card and the CPU")
    phase("cli", f"perimeters of {masks.shape[0]} masks {tuple(masks.shape[1:])}: histograms and "
          f"perimeters equal on the card and the CPU ({int(hist[:, 1:].sum())} border pixels)")
    # gaussian_smooth takes no convolution call: TF32 allowed, it still equals the CPU
    x = torch.from_numpy(load_nifti(task / "cine" / "patient001_4d.nii.gz").data_czyx.copy())
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = gaussian_smooth(x.cuda(), (1.5, 2.0), axes=(2, 3)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    ref = gaussian_smooth(x, (1.5, 2.0), axes=(2, 3))
    compare("cli", f"gaussian_smooth {tuple(x.shape)} card (TF32 allowed) vs CPU (bit-equal: "
            f"{torch.equal(got, ref)})", got, ref, 1e-6, 1e-6)

    run("strain_curve_metric", cli.strain_curve_metric_entry,
        ["--ai", gt_tree / "strain_curves", "--gt", gt_tree / "strain_curves", "-o", tmp / "scm"])
    mean = json.loads((tmp / "scm" / "strain_curve_summary.json").read_text())["mean"]
    dists = {k: v for k, v in mean.items() if k.startswith("distance_")}
    expect(len(dists) == 3 and all(v == 0.0 for v in dists.values()),
           f"strain_curve_metric of the curves against themselves: {dists}")
    phase("cli", f"strain_curve_metric, {CLI_CINES} cases against themselves: distances {dists}")


def check_planned_unet_kernels(card: str, trained: dict, served: dict,
                               k5_shapes: dict) -> dict:
    """Phase 23: K5, K6 and K6 dx at every distinct shape the planned U-Net's
    training and serving gave them (conv_shapes / norm_act_shapes records),
    float32 and bfloat16, against their plain versions at phase 9's
    tolerances. Returns each kernel's max abs error."""
    import torch

    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std + mean

    err = {"K5": 0.0, "K6": 0.0, "K6_dx": 0.0}
    fwd = sorted({(shape, co, bias) for rec in (trained, served)
                  for shape, _, co, bias, _ in rec})
    dxs = sorted({(shape, co) for shape, _, co, _, grad in trained if grad})
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for shape in sorted(k5_shapes):
            x = rand(*shape, std=2.0, mean=0.5).to(dtype)
            scale, bias = 1.0 + rand(shape[1], std=0.2), rand(shape[1], std=0.2)
            got = k5.norm_act_cuda(x, scale, bias)
            torch.cuda.synchronize()
            err["K5"] = max(err["K5"], compare(
                "data plane", f"K5 {dname} (N, C, H, W)={shape}", got,
                k5.norm_act_plain(x, scale, bias), *UNET_TOL[("K5", dname)]))
        for (n, ci, h, w), co, bias in fwd:
            x = rand(n, ci, h, w).to(dtype)
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5)
            b = rand(co, std=0.1) if bias else None
            got = k6.conv3x3_cuda(x, wt, b)
            torch.cuda.synchronize()
            err["K6"] = max(err["K6"], compare(
                "data plane", f"K6 {dname} (N, Ci, Co, H, W)=({n}, {ci}, {co}, {h}, {w})", got,
                k6.conv3x3_plain(x, wt, b), *UNET_TOL[("K6", dname)]))
        for (n, ci, h, w), co in dxs:
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5)
            dy = rand(n, co, h, w).to(dtype)
            got = k6.conv3x3_dx_cuda(dy, wt)
            torch.cuda.synchronize()
            err["K6_dx"] = max(err["K6_dx"], compare(
                "data plane", f"K6 dx {dname} dy (N, Co, H, W)=({n}, {co}, {h}, {w}) -> dx {ci} "
                "channels", got, k6.conv3x3_dx_plain(dy, wt), *UNET_TOL[("K6", dname)]))
    expect(k5_shapes and fwd and dxs, "the planned U-Net gave a kernel no shape")
    phase("data plane", f"the planned U-Net's kernels vs plain at {len(k5_shapes)} K5, "
          f"{len(fwd)} K6 and {len(dxs)} dx shapes (float32, bfloat16): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + f" ({card})")
    return err


def data_plane_phase(card: str, record3d: dict, tail: dict,
                     workdir: Path) -> tuple[dict, dict]:
    """Phase 23: the data plane at ACDC size, from a raw synthetic task to a
    trained, served and evaluated planned 2D U-Net, and the kernels against
    their plain versions at every shape it gave them; then the planned 3D
    U-Net (``data_plane_3d``, its K6 shapes into ``record3d``). Its files stay
    in ``workdir`` (phase 35 trains on its root). Returns each command's
    launches and each kernel's max abs error."""

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import ExperimentConfig
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.data.conversion.acdc import make_synthetic_acdc
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.utils.nifti import load_nifti

    counts = {}

    def run(name: str, entry, argv: list, want: dict, **environ) -> float:
        return run_command(counts, "data plane", name, entry, argv, want, card, **environ)

    with contextlib.nullcontext(workdir) as tmp:
        t0 = time.perf_counter()
        make_synthetic_acdc(tmp / "raw", num_patients=DP_PATIENTS, num_frames=DP_FRAMES,
                            shape_zyx=DP_SHAPE)
        phase("data plane", f"make_synthetic_acdc: {DP_PATIENTS} patients x {DP_FRAMES} frames of "
              f"{DP_SHAPE} in {time.perf_counter() - t0:.3f} s host clock ({card})")
        task = tmp / "task"
        run("csof_torch_convert_acdc", cli.convert_acdc_entry, ["-i", tmp / "raw", "-o", task], {})
        roots = {n: tmp / f"pre_{n}" for n in (DP_WORKERS, 1)}
        for n, root in roots.items():
            run(f"csof_torch_plan_and_preprocess --num-workers {n}",
                cli.plan_and_preprocess_entry, ["-t", task, "-o", root, "--num-workers", n], {})
        a, b = roots[DP_WORKERS], roots[1]
        files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        expect(files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()),
               "the two roots hold other files")
        for rel in files:
            if rel.suffix == ".npz":
                with zipfile.ZipFile(a / rel) as za, zipfile.ZipFile(b / rel) as zb:
                    same = za.namelist() == zb.namelist() and all(
                        za.read(m) == zb.read(m) for m in za.namelist())
            else:
                same = (a / rel).read_bytes() == (b / rel).read_bytes()
            expect(same, f"{rel}: {DP_WORKERS} workers and 1 wrote other bytes")
        npz = sum(r.suffix == ".npz" for r in files)
        expect(npz == 3 * 2 * DP_PATIENTS, f"{npz} .npz files")
        phase("data plane", f"{DP_WORKERS} workers vs 1: {len(files)} files equal (plans and .pkl "
              f"byte for byte, {npz} .npz member by member)")
        plans = Plans.from_json(a / "plans_2D.json")
        for key in ("2D", "3D"):
            for sid, sp in Plans.from_json(a / f"plans_{key}.json").plans_per_stage.items():
                phase("data plane", f"plans_{key} stage {sid}: patch {sp.patch_size}, batch "
                      f"{sp.batch_size}, pools {sp.pool_op_kernel_sizes}, spacing "
                      f"{sp.current_spacing}")

        # the planned 2d U-Net: K6 (and dx) where CSOF_CONV2D_IMPL=pallas routes it;
        # K5 serving, K7 (and dx) training on the card
        sp = plans.fullres_stage()
        per = unet_from_plans(plans, fused_norm_act=True, conv_impl="pallas").kernel_launches(
            sp.patch_size, backward=True)
        per_train = unet_from_plans(plans, fused_norm_act=False, conv_impl="pallas").cuda(
            ).kernel_launches(sp.patch_size, backward=True)
        cfg = ExperimentConfig(model="unet2d", max_num_epochs=1, num_batches_per_epoch=DP_STEPS,
                               num_val_batches_per_epoch=DP_VAL)
        cfg.to_yaml(tmp / "unet.yaml")
        train_convs, serve_convs, k5_shapes = {}, {}, {}
        with conv_shapes(train_convs):
            run("csof_torch_train unet2d planned", cli.train_entry,
                ["-c", tmp / "unet.yaml", "-p", a, "-o", tmp / "unet"],
                {"K6": per_train["K6"] * (DP_STEPS + DP_VAL),
                 "K6_dx": per_train["K6_dx"] * DP_STEPS,
                 "K7": per_train["K7"] * (DP_STEPS + DP_VAL),
                 "K7_dx": per_train["K7_dx"] * DP_STEPS},
                CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="0")
        fold = tmp / "unet" / "fold_0"
        expect((fold / "model_final_checkpoint.pt").is_file()
               and Plans.from_json(fold / "plans.json") == plans, "U-Net fold not written")
        phase("data plane", f"the planned U-Net: {per['K5']} K5 a forward; {per_train['K6']} K6, "
              f"{per_train['K6_dx']} K6 dx, {per_train['K7']} K7, {per_train['K7_dx']} K7 dx a "
              f"step at batch {sp.batch_size} x {sp.patch_size}")

        cases = sorted(p.name[:-len("_0000.nii.gz")] for p in (task / "imagesTr").glob("*.nii.gz"))
        served = cases[:DP_PREDICT]
        (tmp / "imagesTs").mkdir()
        for c in served:
            (tmp / "imagesTs" / f"{c}_0000.nii.gz").write_bytes(
                (task / "imagesTr" / f"{c}_0000.nii.gz").read_bytes())
        fwd = sum(unet_forwards(np.load(a / "preprocessed_2d" / f"{c}.npz")["data"].shape[1:],
                                plans) for c in served)
        with conv_shapes(serve_convs), norm_act_shapes(k5_shapes):
            run("csof_torch_predict planned", cli.predict_entry,
                ["-m", fold, "-i", tmp / "imagesTs", "-o", tmp / "pred"],
                {"K5": per["K5"] * fwd, "K6": per["K6"] * fwd}, CSOF_CONV2D_IMPL="pallas",
                CSOF_FUSED_NORM="1")
        for c in served:
            seg = load_nifti(tmp / "pred" / f"{c}.nii.gz").data_czyx
            expect(seg.shape == DP_SHAPE and seg.max() <= 3, f"{c}: prediction {seg.shape}")
        run("csof_torch_evaluate planned", cli.evaluate_entry,
            ["-p", tmp / "pred", "-r", task / "labelsTr", "-l", "1", "2", "3", "-o",
             tmp / "eval.json"], {})
        scores = json.loads((tmp / "eval.json").read_text())
        expect(len(scores["all"]) == DP_PREDICT and set(scores["mean"]) == {"1", "2", "3"},
               f"evaluation {scores['mean']}")
        phase("data plane", "Dice after the few steps: "
              + ", ".join(f"{k} {v['Dice']:.4f}" for k, v in sorted(scores["mean"].items())))
        data_plane_3d(card, run, a, tmp, served, record3d)
        t_tail = time.perf_counter()
        tail.update(nnunet_tail_phase(card, tmp, task, served, {
            "unet2d": counts["csof_torch_predict planned"],
            "unet3d": counts["csof_torch_predict unet3d planned"]}))
        phase("nnunet tail", f"phase 32 took {time.perf_counter() - t_tail:.1f} s")
    return counts, check_planned_unet_kernels(card, train_convs, serve_convs, k5_shapes)


def data_plane_3d(card: str, run, root: Path, tmp: Path, served: list, record: dict) -> None:
    """Phase 23, 3D: the planned 3D U-Net of the same root (plans_3D.json,
    preprocessed_3d/) trained 3 steps + 1 validation batch under
    CSOF_CONV2D_IMPL=pallas (CSOF_FUSED_NORM=1 set: no K5 on a 3D net), 2
    cases served with TTA, evaluated; K6's z-tap shapes go to ``record``."""
    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import ExperimentConfig
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.inference.predictor import TILE_BATCH_3D
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.sliding_window import bucket_image_shape, step_grid
    from csof_tpu_torch.utils.nifti import load_nifti

    plans = Plans.from_json(root / "plans_3D.json")
    patch = plans.fullres_stage().patch_size
    per = unet_from_plans(plans, conv_impl="pallas").kernel_launches(patch, backward=True)
    cfg = ExperimentConfig(model="unet3d", max_num_epochs=1, num_batches_per_epoch=DP_STEPS,
                           num_val_batches_per_epoch=DP_VAL)
    cfg.to_yaml(tmp / "unet3d.yaml")
    with conv_shapes(record):
        run("csof_torch_train unet3d planned", cli.train_entry,
            ["-c", tmp / "unet3d.yaml", "-p", root, "-o", tmp / "unet3d"],
            {"K6": per["K6"] * (DP_STEPS + DP_VAL), "K6_dx": per["K6_dx"] * DP_STEPS},
            CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="1")
    fold = tmp / "unet3d" / "fold_0"
    expect((fold / "model_final_checkpoint.pt").is_file(), "3D U-Net fold not written")
    fwd = sum(-(-len(step_grid(patch, bucket_image_shape(
        np.load(root / "preprocessed_3d" / f"{c}.npz")["data"].shape[1:], patch, 0.5, 32),
        0.5)) // TILE_BATCH_3D) for c in served)
    with conv_shapes(record):
        run("csof_torch_predict unet3d planned", cli.predict_entry,
            ["-m", fold, "-i", tmp / "imagesTs", "-o", tmp / "pred3d"], {"K6": per["K6"] * fwd},
            CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="1")
    for c in served:
        seg = load_nifti(tmp / "pred3d" / f"{c}.nii.gz").data_czyx
        expect(seg.shape == DP_SHAPE and seg.max() <= 3, f"{c}: 3D prediction {seg.shape}")
    run("csof_torch_evaluate unet3d planned", cli.evaluate_entry,
        ["-p", tmp / "pred3d", "-r", tmp / "task" / "labelsTr", "-l", "1", "2", "3", "-o",
         tmp / "eval3d.json"], {})
    scores = json.loads((tmp / "eval3d.json").read_text())
    expect(len(scores["all"]) == len(served), f"3D evaluation {scores['mean']}")
    phase("data plane", f"the planned 3D U-Net: patch {patch}, {per['K6']} K6 + "
          f"{per['K6_dx']} dx a step, {fwd} forwards for {len(served)} cases; Dice "
          + ", ".join(f"{k} {v['Dice']:.4f}" for k, v in sorted(scores["mean"].items()))
          + f" ({card})")


# -- phases 24-28: the Task002 3d_fullres U-Net -------------------------------


def synthetic_volume(rng: np.random.RandomState, shape) -> np.ndarray:
    """(z, y, x) float32 MRI-like volume of any size: noise everywhere and a
    bright ellipsoid a fifth to an eighth of each axis across."""
    d, h, w = shape
    zz, yy, xx = np.ogrid[0:d, 0:h, 0:w]
    cz, cy, cx = (d / 2 + rng.uniform(-5, 5), h / 2 + rng.uniform(-20, 20),
                  w / 2 + rng.uniform(-20, 20))
    blob = ((zz - cz) / (d / 5)) ** 2 + ((yy - cy) / (h / 8)) ** 2 + ((xx - cx) / (w / 8)) ** 2 <= 1
    return (20 + 30 * rng.rand(d, h, w) + 200 * blob).astype(np.float32)


def unet3d_data(tmp: Path) -> tuple[Path, Path]:
    """Phase 24's inputs: U3_CASES synthetic Task002-sized volumes at the
    3d_fullres spacing through run_cropping and Preprocessor.run into a
    preprocessed root holding task002_heart_3d's plans_3D.json; the first
    U3_PREDICT also as .nii.gz for csof_torch_predict. Returns (root,
    images folder)."""
    from csof_tpu_torch.config.plans import task002_heart_3d
    from csof_tpu_torch.data.cropping import run_cropping
    from csof_tpu_torch.data.preprocessing import Preprocessor
    from csof_tpu_torch.utils.nifti import save_nifti

    plans = task002_heart_3d()
    root, raw, images = tmp / "pre3d", tmp / "raw3d", tmp / "imagesTs3d"
    for d in (root, raw, images):
        d.mkdir()
    plans.to_json(root / "plans_3D.json")
    rng = np.random.RandomState(11)
    spacing_xyz = tuple(U3_SPACING_ZYX[::-1])
    cases = []
    t0 = time.perf_counter()
    for i in range(U3_CASES):
        img = synthetic_volume(rng, U3_SHAPE)
        img_path, seg_path = raw / f"la3_{i:03d}_0000.nii", raw / f"la3_{i:03d}_seg.nii"
        save_nifti(img, img_path, spacing_xyz=spacing_xyz)
        save_nifti((img > 150).astype(np.uint8), seg_path, spacing_xyz=spacing_xyz)
        if i < U3_PREDICT:
            save_nifti(img, images / f"la3_{i:03d}_0000.nii.gz", spacing_xyz=spacing_xyz)
        cases.append((f"la3_{i:03d}", [str(img_path)], str(seg_path)))
    run_cropping(cases, tmp / "cropped3d")
    Preprocessor(plans).run(tmp / "cropped3d", root / "preprocessed_3d")
    phase("unet3d train", f"{U3_CASES} cases {U3_SHAPE} at {U3_SPACING_ZYX} mm written, cropped "
          f"and preprocessed in {time.perf_counter() - t0:.1f} s host clock")
    return root, images


def unet3d_train(card: str, tmp: Path, root: Path) -> tuple[dict, Path]:
    """Phase 24: csof_torch_train on the Task002 3d_fullres U-Net (full width,
    float32, SGD-Nesterov + poly, clip 12, deep supervision) under
    CSOF_CONV2D_IMPL=pallas with CSOF_FUSED_NORM=1 set (K5 never runs on a
    3D net), then Trainer steps with the switch off and on, remat at its
    default (save_conv) and off: host ms a step and peak device memory.
    Returns the command's launches and its fold."""
    import gc

    import torch

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import ExperimentConfig, OptimConfig
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.data.dataset import load_dataset
    from csof_tpu_torch.data.loaders import SegPatchLoader
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.training.schedules import build_optimizer
    from csof_tpu_torch.training.trainer import Trainer
    from csof_tpu_torch.utils.logging import read_training_logs

    plans = Plans.from_json(root / "plans_3D.json")
    sp = plans.fullres_stage()
    per = unet_from_plans(plans, conv_impl="pallas").kernel_launches(sp.patch_size, True)
    expect(per == {"K5": 0, "K6": U3_K6, "K7": 0, "K6_dx": U3_K6_DX, "K7_dx": 0},
           f"3d_fullres launches {per}")
    cfg = ExperimentConfig(model="unet3d", max_num_epochs=1, num_batches_per_epoch=U3_STEPS,
                           num_val_batches_per_epoch=U3_VAL,
                           optim=OptimConfig(optimizer="sgd", scheduler="poly", initial_lr=1e-2,
                                             weight_decay=3e-5))
    cfg.to_yaml(tmp / "unet3d.yaml")
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    run_command(counts, "unet3d train", "csof_torch_train unet3d", cli.train_entry,
                ["-c", tmp / "unet3d.yaml", "-p", root, "-o", tmp / "unet3d"],
                {"K6": U3_K6 * (U3_STEPS + U3_VAL), "K6_dx": U3_K6_DX * U3_STEPS}, card,
                CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="1")
    fold = tmp / "unet3d" / "fold_0"
    log = "\n".join(line for lines in read_training_logs(fold) for line in lines)
    expect((fold / "model_final_checkpoint.pt").is_file() and " fg-dice " in log,
           f"unet3d fold not written or no fg-dice in its log: {log[-300:]}")
    phase("unet3d train", f"csof_torch_train: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {log.strip().splitlines()[-1]}")

    loader = SegPatchLoader(load_dataset(root / "preprocessed_3d"), sp.patch_size,
                            sp.batch_size, num_modalities=plans.num_modalities, seed=0)
    batches = [next(loader) for _ in range(U3_WARMUP + U3_TIMED)]
    for switch in ("native", "pallas"):
        for remat in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            with env(CSOF_CONV2D_IMPL=switch):
                tr = Trainer(cfg, tmp / f"steps_{switch}_{remat}", plans=plans,
                             device="cuda").initialize()
                if not remat:
                    tr.model = unet_from_plans(plans, remat=False, generator=torch.Generator()
                                               .manual_seed(cfg.seed)).cuda()
                    tr.optimizer = build_optimizer(cfg.optim, tr.total_steps,
                                                   tr.model.parameters())
                label = f"{tr.model.remat_policy if tr.model.remat else 'off'}"
                for b in batches[:U3_WARMUP]:
                    tr.run_iteration(b)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                times, losses = [], []
                for b in batches[U3_WARMUP:]:
                    t0 = time.perf_counter()
                    loss, _ = tr.run_iteration(b)  # ends in a read of the loss
                    times.append((time.perf_counter() - t0) * 1e3)
                    losses.append(loss)
                got = {k: v for k, v in _read_counts().items() if v}
            want = ({"K6": U3_K6 * U3_TIMED, "K6_dx": U3_K6_DX * U3_TIMED}
                    if switch == "pallas" else {})
            expect(got == want and all(np.isfinite(losses)),
                   f"{switch}, remat {label}: launches {got}, expected {want}; losses {losses}")
            phase("unet3d train", f"Trainer step ({sp.batch_size}, 1, {sp.patch_size}) float32, "
                  f"CSOF_CONV2D_IMPL={switch}, remat {label}: median "
                  f"{statistics.median(times):.3f} ms host clock over {U3_TIMED} steps after "
                  f"{U3_WARMUP} warm-up (min {min(times):.3f}, max {max(times):.3f}), peak "
                  f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches "
                  f"{got}, losses {losses[0]:.5f} -> {losses[-1]:.5f} ({card})")
            del tr
    gc.collect()
    torch.cuda.empty_cache()
    return counts["csof_torch_train unet3d"], fold


def unet3d_serve(card: str, tmp: Path, fold: Path, images: Path) -> dict:
    """Phase 25: csof_torch_predict of the trained 3d_fullres fold on
    U3_PREDICT cases, mirror TTA (8 variants), the switch on, at
    predict_case's tile batch for 3-D plans, with its peak device memory;
    then the peak memory and time of one forward of 1, 2 and 4 tiles x 8
    mirrors."""
    import gc

    import torch

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.inference.predictor import TILE_BATCH_3D
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.sliding_window import bucket_image_shape, step_grid
    from csof_tpu_torch.utils.nifti import load_nifti

    plans = Plans.from_json(fold / "plans.json")
    patch = plans.fullres_stage().patch_size
    tiles = len(step_grid(patch, bucket_image_shape(U3_SHAPE, patch, 0.5, 32), 0.5))
    forwards = -(-tiles // TILE_BATCH_3D) * U3_PREDICT
    counts = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    secs = run_command(counts, "unet3d serving", "csof_torch_predict unet3d", cli.predict_entry,
                       ["-m", fold, "-i", images, "-o", tmp / "pred3d"],
                       {"K6": U3_K6 * forwards}, card, CSOF_CONV2D_IMPL="pallas")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i in range(U3_PREDICT):
        seg = load_nifti(tmp / "pred3d" / f"la3_{i:03d}.nii.gz").data_czyx
        expect(seg.shape == U3_SHAPE and set(np.unique(seg).tolist()) <= {0, 1},
               f"case {i}: prediction {seg.shape}")
    phase("unet3d serving", f"{U3_PREDICT} cases {U3_SHAPE}: {tiles} tiles a case, tile batch "
          f"{TILE_BATCH_3D} x 8 mirrors, {forwards} forwards, {secs / U3_PREDICT:.3f} s a case "
          f"host clock, peak device memory {peak:.3f} GiB ({card})")
    net = unet_from_plans(plans, conv_impl="pallas",
                          generator=torch.Generator().manual_seed(0)).cuda().eval()
    peaks = {}
    for tb in U3_TILE_BATCHES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            x = torch.zeros(8 * tb, 1, *patch, device="cuda")
            with torch.inference_mode():
                ms = median_ms(lambda: net(x), reps=3, warmup=1)
            peaks[tb] = (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                         f"{ms / tb:.1f} ms a tile")
        except torch.cuda.OutOfMemoryError:
            peaks[tb] = "out of memory"
        x = None
    del net
    gc.collect()
    torch.cuda.empty_cache()
    phase("unet3d serving", f"one forward by tile batch (x 8 mirrors, {patch} float32): peak "
          f"device memory and CUDA-event ms a tile {peaks} ({card})")
    return counts["csof_torch_predict unet3d"]


@contextlib.contextmanager
def leaky_slopes(masks: list, replay: bool, flips: list, sites=None):
    """Record (``replay=False``) the sign mask of every LeakyReLU called
    through ``sites``, in call order, or replay recorded masks in place of
    the signs, counting in ``flips`` the entries where the replayed mask
    differs from the input's own sign. ``sites``: (owner, attribute, default
    slope) triples, by default the ConvNormAct blocks' ``blocks.leaky_relu``
    (``torch.relu`` is the site with slope 0). Where ``blocks.leaky_relu``
    is a site, a block that runs K7 on the card records its output's signs
    too (the sign of y is that of the pre-activation): the CPU runs those
    blocks through ``blocks.leaky_relu``, in the same order."""
    import torch

    from csof_tpu_torch.models import blocks

    sites = sites or [(blocks, "leaky_relu", 0.01)]
    replayed = iter(masks)
    native = blocks.native_norm_act

    def recording_native(*args, **kwargs):
        y = native(*args, **kwargs)
        masks.append((y >= 0).cpu())
        return y

    def site(default):
        def act(x, negative_slope=default):
            own = x >= 0
            if replay:
                mask = next(replayed).to(x.device)
                flips.append(int((mask != own).sum()))
            else:
                mask = own
                masks.append(own.cpu())
            return torch.where(mask, x, x * blocks.scalar_in(negative_slope, x.dtype))
        return act

    origs = [(owner, name, getattr(owner, name)) for owner, name, _ in sites]
    for owner, name, default in sites:
        setattr(owner, name, site(default))
    if not replay and (blocks, "leaky_relu") in [(o, n) for o, n, _ in sites]:
        origs.append((blocks, "native_norm_act", native))
        blocks.native_norm_act = recording_native
    try:
        yield
    finally:
        for owner, name, orig in origs:
            setattr(owner, name, orig)


def grad_parity(label: str, cpu, data: np.ndarray, seg: np.ndarray, model: str,
                want: tuple[int, int], card: str) -> None:
    """The float32 loss and every gradient of make_seg_loss, GPU kernels vs
    CPU plain versions, every leaf within GRAD_TOL and the loss within
    LOSS_RTOL. A LeakyReLU input within rounding of 0 can take the other
    slope on the other device, which moves the gradients behind it by up to
    100-fold at that voxel (a deep level of a few hundred voxels a plane
    turns one such flip into a leaf off by percents); so the CPU's run
    replays the slopes the GPU's run took (``leaky_slopes``), and the two
    differ by their arithmetic alone. ``want``: K6 and K6 dx launches of
    the GPU step."""
    import torch

    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.training.trainer import make_seg_loss

    gpu = copy.deepcopy(cpu).cuda()
    loss_fn = make_seg_loss(ExperimentConfig(model=model, data=DataConfig(do_data_aug=False)))

    def grads(m, device):
        m.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m, {"data": torch.from_numpy(data).to(device),
                              "seg": torch.from_numpy(seg).to(device)})
        loss.backward()
        return loss.item(), {k: None if p.grad is None else p.grad.cpu()
                             for k, p in m.named_parameters()}

    masks, flips = [], []
    before = (k6.launches, k6.bwd_launches)
    with leaky_slopes(masks, False, flips):
        a, g_gpu = grads(gpu, "cuda")
    torch.cuda.synchronize()
    got = (k6.launches - before[0], k6.bwd_launches - before[1])
    expect(got == want, f"the GPU step ran {got} K6 and K6 dx, expected {want}")
    with leaky_slopes(masks, True, flips):
        b, g_cpu = grads(cpu, "cpu")
    expect(len(flips) == len(masks), f"{len(flips)} LeakyReLUs replayed of {len(masks)}")
    ratios = {}
    for name, r in g_cpu.items():
        expect((g_gpu[name] is None) == (r is None), f"{name}: a gradient on one side only")
        if r is None:  # the zero-weight deep-supervision head
            continue
        expect(bool(torch.isfinite(g_gpu[name]).all()), f"{name}: non-finite gradient")
        ratios[name] = float((g_gpu[name] - r).abs().max()) / (GRAD_TOL * float(r.abs().max())
                                                                + 1e-6)
    worst_name = max(ratios, key=ratios.get)
    worst, med = ratios[worst_name], statistics.median(ratios.values())
    ok = worst <= 1 and abs(a - b) <= LOSS_RTOL * abs(b)
    phase(label, f"full width float32 {tuple(data.shape)}: loss GPU {a:.7f} vs CPU {b:.7f}; "
          f"{len(ratios)} gradients, |diff| / (tol {GRAD_TOL:g} max|g| + 1e-6): worst "
          f"{worst:.3f} at {worst_name}, median {med:.4f}; the CPU ran the GPU's slopes at "
          f"{len(masks)} LeakyReLUs, {sum(flips)} of whose inputs take the other sign on the "
          f"CPU -> {'ok' if ok else 'FAIL'} ({card})")
    expect(ok, f"gradient {worst_name} or the loss outside tolerance")


def unet3d_parity(card: str, record: dict) -> None:
    """Phase 26: the Task002 3d_fullres U-Net GPU (K6 in the z taps) vs CPU
    (the plain version) at full width, float32: the logits of one
    80x192x160 patch (MODEL_TOL), then the loss and every gradient of a
    training step on 1 x 32x96x96 (level 1 is 48 wide, so K6 routes there
    too: the same 17 K6 + 16 dx) under phase 15's rule (``grad_parity``)."""
    import torch

    from csof_tpu_torch.config.plans import task002_heart_3d
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.kernels import conv as k6

    plans = task002_heart_3d()
    cpu = unet_from_plans(plans, conv_impl="pallas",
                          generator=torch.Generator().manual_seed(2)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 1, *plans.fullres_stage().patch_size)
                         .astype(np.float32))
    with torch.no_grad(), conv_shapes(record):
        before = k6.launches
        got = gpu(x.cuda())
        torch.cuda.synchronize()
        n = k6.launches - before
        t0 = time.perf_counter()
        ref = cpu(x)
        cpu_s = time.perf_counter() - t0
    expect(n == U3_K6, f"the GPU forward ran {n} K6, expected {U3_K6}")
    for i, (g, r) in enumerate(zip(got, ref)):
        compare("unet3d parity", f"float32 head {i} {tuple(r.shape)} GPU vs CPU", g.cpu(), r,
                *MODEL_TOL)
    phase("unet3d parity", f"one patch {tuple(x.shape)}: {n} K6 launches; the CPU forward "
          f"took {cpu_s:.1f} s ({card})")
    del gpu, got
    torch.cuda.empty_cache()
    train = unet_from_plans(plans, conv_impl="pallas", remat=False,
                            generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(13)
    seg = np.zeros((1, *U3_PARITY_PATCH), np.int32)
    seg[:, 8:24, 30:70, 25:65] = 1
    data = (rng.randn(1, 1, *U3_PARITY_PATCH) + seg[:, None]).astype(np.float32)
    with conv_shapes(record):
        grad_parity("unet3d parity", train, data, seg, "unet3d", (U3_K6, U3_K6_DX), card)


def check_unet3d_kernels(card: str, record: dict) -> dict:
    """Phase 27: K6 and K6 dx against their plain versions at every distinct
    z-tap shape the 3D runs gave them (phases 23-26: ``record``), float32
    and bf16 (bf16 also with the float32 output that (3, 3, 3) taps take),
    phase 9's tolerances; then their times at the Task002 3d_fullres tap
    shapes (``kernel_times.k6_3d_times``: the forward's 17 launches at the
    serving batch, the step's 16 dx at batch 2; the plain versions; each
    routed conv through the tap route and as one F.conv3d, the library
    call) beside the bound (``bounds.unet3d_work``). Returns K6's and K6
    dx's entries of the kernels line."""
    import torch

    from csof_tpu_torch.bounds import bound_ms, unet3d_work
    from csof_tpu_torch.kernel_times import k6_3d_times
    from csof_tpu_torch.ops.kernels import conv as k6

    gen = torch.Generator(device="cuda").manual_seed(17)

    def rand(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    fwd = sorted({(shape, co) for shape, _, co, _, _ in record})
    dxs = sorted({(shape, co) for shape, _, co, _, grad in record if grad})
    expect(fwd and dxs, "the 3D runs gave K6 no shape")
    err = {"K6": 0.0, "K6_dx": 0.0}
    for dtype, out_f32 in ((torch.float32, False), (torch.bfloat16, False),
                           (torch.bfloat16, True)):
        dname = str(dtype).removeprefix("torch.")
        tol = UNET_TOL[("K6", "float32" if out_f32 else dname)]
        for (n, ci, h, w), co in fwd:
            x = rand(n, ci, h, w).to(dtype)
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5)
            got = k6.conv3x3_cuda(x, wt, None, out_f32)
            torch.cuda.synchronize()
            err["K6"] = max(err["K6"], compare(
                "unet3d kernels", f"K6 {dname}{' out_f32' if out_f32 else ''} (N, Ci, Co, H, W)="
                f"({n}, {ci}, {co}, {h}, {w})", got, k6.conv3x3_plain(x, wt, None, out_f32), *tol))
            del x, got
        if out_f32:
            continue
        for (n, ci, h, w), co in dxs:
            wt = rand(co, ci, 3, 3, std=(2.0 / (9 * ci)) ** 0.5)
            dy = rand(n, co, h, w).to(dtype)
            got = k6.conv3x3_dx_cuda(dy, wt)
            torch.cuda.synchronize()
            err["K6_dx"] = max(err["K6_dx"], compare(
                "unet3d kernels", f"K6 dx {dname} dy (N, Co, H, W)=({n}, {co}, {h}, {w}) -> dx "
                f"{ci} channels", got, k6.conv3x3_dx_plain(dy, wt), *UNET_TOL[("K6", dname)]))
            del dy, got
    torch.cuda.empty_cache()
    phase("unet3d kernels", f"{len(fwd)} K6 and {len(dxs)} dx z-tap shapes vs plain (float32, "
          f"bfloat16, bfloat16 out_f32): max abs err K6 {err['K6']:.3e}, dx {err['K6_dx']:.3e}")
    t = k6_3d_times(gen)
    out = {"K6": {"max_abs_err": err["K6"]}, "K6_dx": {"max_abs_err": err["K6_dx"]}}
    for key, tkey, what in (("K6", "K6_3D", "the 17 z-tap launches of one serving forward "
                             "(TILE_BATCH_3D tiles x 8 mirrors)"),
                            ("K6_dx", "K6_dx_3D", "the 16 z-tap dx launches of one training "
                             "step (batch 2)")):
        for dname, itemsize in (("float32", 4), ("bfloat16", 2)):
            bnd, by = bound_ms(*unet3d_work(key, itemsize))
            lib = t[f"K6_3D_convs_{dname}_{'conv3d_serving' if key == 'K6' else 'dgrad3d'}_ms"]
            entry = {"ms": t[f"{tkey}_{dname}_ms"], "plain_ms": t[f"{tkey}_{dname}_plain_ms"],
                     "device_ms": t[f"{tkey}_{dname}_device_ms"], "bound_ms": bnd,
                     "bound_by": by, "library_ms": lib}
            out[key].update({f"unet3d_{dname}_{k}": v for k, v in entry.items()})
            phase("unet3d kernels", f"{key} {dname}, {what}: kernel {entry['ms']:.4f} ms (device "
                  f"{entry['device_ms']:.4f}), plain {entry['plain_ms']:.4f} ms, library "
                  f"{lib:.4f} ms ({'F.conv3d' if key == 'K6' else 'conv3d_input'} of the "
                  f"routed convs), bound {bnd:.4f} ms ({by}) ({card})")
        out[key]["unet3d_launches_per_" + ("forward" if key == "K6" else "step")] = (
            U3_K6 if key == "K6" else U3_K6_DX)
    for dname in ("float32", "bfloat16"):
        convs = t[f"K6_3D_convs_{dname}"]
        phase("unet3d kernels", f"{dname}, the routed convs at batch 2, tap route vs one "
              "F.conv3d (ms): " + "; ".join(
                  f"{c['conv'][0]}->{c['conv'][1]} {tuple(c['conv'][2])} at "
                  f"{tuple(c['conv'][3])} x{c['convs']}: {c['route_ms']:.3f} vs "
                  f"{c['conv3d_ms']:.3f}" for c in convs)
              + f"; summed {t[f'K6_3D_convs_{dname}_route_ms']:.3f} vs "
              f"{t[f'K6_3D_convs_{dname}_conv3d_ms']:.3f} ({card})")
        out["K6"][f"unet3d_{dname}_route_b2_ms"] = t[f"K6_3D_convs_{dname}_route_ms"]
        out["K6"][f"unet3d_{dname}_conv3d_b2_ms"] = t[f"K6_3D_convs_{dname}_conv3d_ms"]
    return out


def cascade_phase(card: str, tmp: Path) -> dict:
    """Phase 28: the cascade. csof_torch_plan_and_preprocess of a task whose
    3D plans hold a low-resolution stage (CASCADE_CASES isotropic phantoms
    of CASCADE_SHAPE, about phase 23's voxels a case, the 3D budget cut to
    CASCADE_BUDGET as tests/test_torch_data_plane.py's F10 test cuts it)
    writes both stage folders; predict_next_stage runs the lowres U-Net
    (random weights from a seed) on the card and on the CPU, and the
    ``_segFromPrevStage.npy`` files must be equal (or differ only where the
    CPU softmax's top two are within 1e-4); one forward of the fullres U-Net
    on concat_prev_stage's input. Returns the launches of the card's run."""
    import torch

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.plans import Plans
    from csof_tpu_torch.data import planning
    from csof_tpu_torch.data.conversion.acdc import _phantom_frame
    from csof_tpu_torch.data.dataset import load_case, load_dataset
    from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.training import cascade
    from csof_tpu_torch.utils.nifti import save_nifti

    task, pre = tmp / "cascade_task", tmp / "cascade_pre"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    rng = np.random.RandomState(21)
    for i in range(CASCADE_CASES):
        img, seg = _phantom_frame(CASCADE_SHAPE, i / CASCADE_CASES, rng)
        save_nifti(img, task / "imagesTr" / f"c{i}_0000.nii.gz", spacing_xyz=(1.5, 1.5, 1.5))
        save_nifti(seg.astype(np.uint8), task / "labelsTr" / f"c{i}.nii.gz",
                   spacing_xyz=(1.5, 1.5, 1.5))
    (task / "dataset.json").write_text(json.dumps({"modality": {"0": "MRI"}, "training": [
        {"image": f"./imagesTr/c{i}.nii.gz", "label": f"./labelsTr/c{i}.nii.gz"}
        for i in range(CASCADE_CASES)]}))
    planner = planning.ExperimentPlanner

    class CutBudget(planner):
        def __init__(self, props, task_name):
            super().__init__(props, task_name, budget_3d=CASCADE_BUDGET)

    planning.ExperimentPlanner = CutBudget
    try:
        t0 = time.perf_counter()
        cli.plan_and_preprocess_entry(["-t", str(task), "-o", str(pre), "--num-workers", "2"])
        secs = time.perf_counter() - t0
    finally:
        planning.ExperimentPlanner = planner
    plans = Plans.from_json(pre / "plans_3D.json")
    expect(sorted(plans.plans_per_stage) == [0, 1], f"stages {sorted(plans.plans_per_stage)}")
    low, full = load_dataset(pre / "preprocessed_3d_lowres"), load_dataset(pre / "preprocessed_3d")
    expect(sorted(low) == sorted(full) and len(low) == CASCADE_CASES, "stage folders' cases")
    spacings = {name: pickle.loads((pre / name / "c0.pkl").read_bytes())[
        "spacing_after_resampling"] for name in ("preprocessed_3d", "preprocessed_3d_lowres")}
    expect(spacings["preprocessed_3d"] == tuple(plans.stage(1).current_spacing)
           and spacings["preprocessed_3d_lowres"] == tuple(plans.stage(0).current_spacing),
           f"stage folders hold spacings {spacings}")
    phase("cascade", f"plan_and_preprocess: {secs:.3f} s host clock; stage 0 patch "
          f"{plans.stage(0).patch_size} at {plans.stage(0).current_spacing}, stage 1 patch "
          f"{plans.stage(1).patch_size} at {plans.stage(1).current_spacing}; folders "
          f"preprocessed_3d (fullres) and preprocessed_3d_lowres ({card})")
    targets = {c: tuple(load_case(e)[0].shape[1:]) for c, e in full.items()}
    lowres = unet_from_plans(plans, stage=0, deep_supervision=False,
                             generator=torch.Generator().manual_seed(5)).eval()
    k = plans.num_classes_with_background
    probs, counts = {}, {}
    for where, device in (("card", "cuda"), ("cpu", "cpu")):
        net = copy.deepcopy(lowres).to(device)
        predictor = SlidingWindowPredictor(net, PredictorConfig(
            patch_size=tuple(plans.stage(0).patch_size), num_classes=k), device=device)

        def predict_fn(data, where=where, predictor=predictor):
            seg, p = predictor.predict(data)
            probs.setdefault(where, []).append(p)
            return seg

        _reset_counts()
        t0 = time.perf_counter()
        cascade.predict_next_stage(predict_fn, low, tmp / f"prev_{where}", targets)
        if where == "card":
            torch.cuda.synchronize()
            counts = {n: v for n, v in _read_counts().items() if v}
        phase("cascade", f"predict_next_stage, lowres U-Net with TTA on the {where}: "
              f"{time.perf_counter() - t0:.3f} s host clock")
    differ = 0
    for case in sorted(low):
        name = f"{case}_segFromPrevStage.npy"
        a, b = np.load(tmp / "prev_card" / name), np.load(tmp / "prev_cpu" / name)
        expect(a.shape == targets[case], f"{name}: shape {a.shape}")
        differ += int((a != b).sum())
    for g, c in zip(probs["card"], probs["cpu"]):
        top2 = np.sort(c, 0)[-2:]
        flips = g.argmax(0) != c.argmax(0)
        expect(not flips.any() or (top2[1] - top2[0])[flips].max() < 1e-4,
               "the lowres argmax differs card vs CPU where the CPU's top two are apart")
    phase("cascade", f"segFromPrevStage files card vs CPU: {differ} voxels differ "
          f"({'equal' if differ == 0 else 'only at ties of the lowres softmax'}); the lowres "
          f"softmax max abs diff {max(float(np.abs(g - c).max()) for g, c in zip(probs['card'], probs['cpu'])):.3e}")
    case = sorted(full)[0]
    data = np.asarray(load_case(full[case])[0])[:-1]
    x = cascade.concat_prev_stage(data, cascade.load_prev_stage_onehot(tmp / "prev_card", case, k))
    patch = plans.fullres_stage().patch_size
    crop = np.zeros((x.shape[0], *patch), np.float32)
    sl = tuple(slice(0, min(p, s)) for p, s in zip(patch, x.shape[1:]))
    crop[(slice(None),) + sl] = x[(slice(None),) + sl]
    fullres = unet_from_plans(plans, in_channels=x.shape[0], deep_supervision=False,
                              generator=torch.Generator().manual_seed(6)).cuda().eval()
    with torch.inference_mode():
        logits = fullres(torch.from_numpy(crop)[None].cuda())
    expect(logits.shape == (1, k, *patch) and bool(torch.isfinite(logits).all()),
           f"fullres logits {tuple(logits.shape)}")
    phase("cascade", f"the fullres U-Net on concat_prev_stage's input ({x.shape[0]} channels: "
          f"{plans.num_modalities} modality + {k - 1} one-hot): logits {tuple(logits.shape)}, "
          f"finite; launches of the card's lowres run {counts} ({card})")
    return counts


def smooth_flow_pairs(n: int, hw: int, seed: int):
    """n pairs of hw^2 float32 images (N, H, W, 1) and their flow (N, H, W,
    2): image2 a textured disk phantom, flow_gt a smooth field of up to 3
    pixels, image1 = image2 warped by it (border), so that image1(x) =
    image2(x + flow_gt(x)), RAFT's convention."""
    import torch

    from csof_tpu_torch.ops.warp import warp_batch

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:hw, :hw] / hw
    image2, flow = [], []
    for _ in range(n):
        a, b, c, d = rng.rand(4)
        disk = np.hypot(yy - 0.45 - 0.1 * a, xx - 0.55 + 0.1 * b) < 0.22 + 0.05 * c
        image2.append(0.2 + 0.6 * disk + 0.1 * np.sin(23 * yy + 6 * d) * np.cos(19 * xx)
                      + 0.03 * rng.rand(hw, hw))
        flow.append(np.stack([3 * np.sin(2 * np.pi * (xx + d)), 2 * np.cos(2 * np.pi * yy + a)],
                             -1))
    image2 = np.asarray(image2, np.float32)[..., None]
    flow = np.asarray(flow, np.float32)
    image1 = warp_batch(torch.from_numpy(image2), torch.from_numpy(flow), padding="border")
    return image1.numpy(), image2, flow


def flow_device_events() -> dict:
    """``python -m csof_tpu_torch.profile_flow --launches`` in a fresh
    process (one that has taken many traces can lose kernels from its later
    ones): RAFT's and VoxelMorph's host-clock ms, device events and busy ms
    a call at phases 29-30's geometries, FinalFlow's K5 and K6 device
    events a forward (phase 31), and phase 33's models' K5 and K6 device
    events, host-clock ms and busy ms a forward."""
    child = subprocess.run([sys.executable, "-m", "csof_tpu_torch.profile_flow", "--launches"],
                           capture_output=True, text=True, timeout=480)
    expect(child.returncode == 0, f"profile_flow --launches failed: {child.stderr[-2000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def busy_line(dev: dict) -> str:
    return (f"a fresh process's trace (profile_flow): host clock {dev['wall_ms']:.3f} ms, "
            f"{dev['events']} device events, busy {dev['busy_ms']:.3f} ms, busy share "
            f"{dev['busy_ms'] / dev['wall_ms']:.3f}")


@contextlib.contextmanager
def float64_math():
    """``Tensor.float()`` gives float64: with the model's parameters and
    compute dtypes in float64 (``float64_copy``), a flow model's forward and
    backward run in float64 throughout."""
    import torch

    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *args, **kwargs: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def float64_copy(model):
    import torch

    model = copy.deepcopy(model).double()
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return model


def loss_grad_parity(label: str, make_model, loss_fn, batch: dict, sites: list,
                     card: str) -> None:
    """The float32 loss and every gradient of one step, card vs CPU, with
    phase 8's tolerances: the loss within LOSS_RTOL and each gradient within
    GRAD_TOL of its largest entry + 1e-6. As in ``grad_parity``, an
    activation whose input is within rounding of 0 can take the other branch
    on the other device: one ReLU of RAFT's 124 so flipped moves an encoder's
    weight gradient by 3 % of its largest entry (those gradients are sums
    over pixels that nearly cancel). So the CPU's run replays the signs the
    card's run took at ``sites`` (``leaky_slopes``). A leaf whose exact
    gradient is zero (a conv bias in front of an InstanceNorm) is rounding
    alone on either device: it is told by a float64 backward of the same
    step on the CPU (largest entry at most ZERO_GRAD of the model's largest)
    and held to GRAD_TOL of the model's largest gradient entry instead."""
    import torch

    cpu = make_model()
    gpu = copy.deepcopy(cpu).cuda()

    def grads(model, device, dtype=np.float32):
        model.zero_grad()
        loss, _ = loss_fn(model, {k: torch.from_numpy(v.astype(dtype)).to(device)
                                  for k, v in batch.items()})
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}

    masks, flips = [], []
    with leaky_slopes(masks, False, flips, sites):
        a, g_gpu = grads(gpu, "cuda")
    with leaky_slopes(masks, True, flips, sites):
        b, g_cpu = grads(cpu, "cpu")
    expect(len(flips) == len(masks), f"{label}: {len(flips)} activations replayed of "
           f"{len(masks)}")
    with float64_math():
        _, g64 = grads(float64_copy(cpu), "cpu", np.float64)
    expect(all(g.dtype == torch.float64 for g in g64.values()), f"{label}: a float32 leaf in "
           "the float64 backward")
    top = max(float(g.abs().max()) for g in g64.values())
    zero = {n for n, g in g64.items() if float(g.abs().max()) <= ZERO_GRAD * top}
    expect(abs(a - b) <= LOSS_RTOL * abs(b), f"{label}: loss GPU {a} vs CPU {b}")
    worst, worst_name = -1.0, None
    for n, g in g_gpu.items():
        r = g_cpu[n]
        expect(bool(torch.isfinite(g).all()), f"{label}: {n}: non-finite gradient")
        if n in zero:
            ratio = float(g.abs().max()) / (GRAD_TOL * top)
        else:
            ratio = float((g - r).abs().max()) / (GRAD_TOL * float(r.abs().max()) + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, n
    phase(label, f"float32 loss GPU {a:.7f} vs CPU {b:.7f}; {len(g_gpu)} gradients, worst "
          f"|diff| / (tol {GRAD_TOL:g} max|g| + 1e-6) = {worst:.3f} at {worst_name}; "
          f"{len(zero)} leaves with a zero float64 gradient held to {GRAD_TOL:g} of the model's "
          f"largest entry; the CPU ran the card's signs at {len(masks)} activations, "
          f"{sum(flips)} of whose inputs take the other sign on the CPU -> "
          f"{'ok' if worst <= 1 else 'FAIL'} ({card})")
    expect(worst <= 1, f"{label}: gradient {worst_name} outside tolerance")


def flow_train_command(card: str, tmp: Path, task: Path, kind: str, counts: dict) -> None:
    """csof_torch_train of ``kind`` at its default config (full width, bf16)
    on the cine task: FLOW_TRAIN_STEPS steps + FLOW_TRAIN_VAL validation
    batches of TRAIN_BATCH x TRAIN_T x TRAIN_HW^2 chunks; no kernel of the
    port runs."""
    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig
    from csof_tpu_torch.utils.logging import read_training_logs

    cfg = ExperimentConfig(model=kind, max_num_epochs=1, num_batches_per_epoch=FLOW_TRAIN_STEPS,
                           num_val_batches_per_epoch=FLOW_TRAIN_VAL,
                           data=DataConfig(batch_size=TRAIN_BATCH, video_length=TRAIN_T,
                                           crop_size=TRAIN_HW))
    cfg.to_yaml(tmp / f"{kind}.yaml")
    run_command(counts, kind, f"csof_torch_train {kind}", cli.train_entry,
                ["-c", tmp / f"{kind}.yaml", "-p", tmp / "unused", "-t", task, "-o", tmp / kind],
                {}, card)
    fold = tmp / kind / "fold_0"
    for name in ("config.yaml", "meta.json", "model_final_checkpoint.pt"):
        expect((fold / name).is_file(), f"csof_torch_train {kind}: {name} not written")
    logs = read_training_logs(fold)
    expect(len(logs) == 1 and logs[0], f"csof_torch_train {kind}: no training log")
    line = logs[0][0]
    losses = [float(line.split(" train ")[1].split()[0]), float(line.split(" val ")[1].split()[0])]
    expect(all(np.isfinite(losses)), f"csof_torch_train {kind}: losses {losses}")
    phase(kind, f"csof_torch_train {kind}: {line}")


def raft_phase(card: str, tmp: Path, task: Path, dev: dict) -> dict:
    """Phase 29: RAFT at RaftModelConfig() (feature 256, hidden and context
    128, 4 levels, radius 4, 12 iterations, bf16), random weights from a
    seed, serving RAFT_PAIRS ED->ES pairs at RAFT_HW^2: CUDA-event ms a
    forward, pairs/s, peak memory, and the device busy share of ``dev``
    (``flow_device_events``: random pairs, the same geometry); one pair float32
    card vs CPU; scan_unroll=-1 (F4) runs; then csof_torch_train raft, one
    supervised Trainer step, and the float32 loss and gradients card vs CPU
    on both routes. Returns the launches (none: RAFT runs the library's
    convs)."""
    import dataclasses

    import torch

    from csof_tpu_torch.config.experiment import ExperimentConfig, RaftModelConfig
    from csof_tpu_torch.models.raft import RAFT
    from csof_tpu_torch.training.trainer import Trainer, make_raft_loss

    cfg = RaftModelConfig()
    expect((cfg.feature_dim, cfg.hidden_dim, cfg.context_dim, cfg.corr_levels, cfg.corr_radius,
            cfg.iters, cfg.dtype) == (256, 128, 128, 4, 4, 12, "bfloat16"),
           f"RaftModelConfig() is {cfg}")
    im1, im2, gt = smooth_flow_pairs(RAFT_PAIRS, RAFT_HW, 31)
    cpu = RAFT(cfg, generator=torch.Generator().manual_seed(31)).eval()
    model = copy.deepcopy(cpu).cuda()
    a, b = torch.from_numpy(im1).cuda(), torch.from_numpy(im2).cuda()
    counts = {}
    with torch.inference_mode():
        _reset_counts()
        flows = model(a, b)
        torch.cuda.synchronize()
        counts["raft_serving"] = {k: v for k, v in _read_counts().items() if v}
        expect(tuple(flows.shape) == (cfg.iters, RAFT_PAIRS, RAFT_HW, RAFT_HW, 2)
               and flows.dtype == torch.float32 and bool(torch.isfinite(flows).all()),
               f"RAFT flows {tuple(flows.shape)} {flows.dtype}")
        epe = float((flows[-1].float().cpu() - torch.from_numpy(gt)).norm(dim=-1).mean())
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: model(a, b), reps=RAFT_REPS, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase("raft", f"forward ({RAFT_PAIRS}, {RAFT_HW}, {RAFT_HW}, 1) x 2 bf16, {cfg.iters} "
          f"iterations: {ms:.3f} ms (CUDA events, median of {RAFT_REPS}), "
          f"{RAFT_PAIRS / ms * 1e3:.1f} pairs/s; {busy_line(dev)}; peak {peak:.3f} GiB; "
          f"random weights: mean endpoint error {epe:.3f} px; launches {counts['raft_serving']} "
          f"({card})")
    expect(not counts["raft_serving"], "RAFT launched a kernel of the port")
    f32 = dataclasses.replace(cfg, dtype="float32")
    cpu32 = RAFT(f32, generator=torch.Generator().manual_seed(32)).eval()
    gpu32 = copy.deepcopy(cpu32).cuda()
    x1, x2 = torch.from_numpy(im1[:1]), torch.from_numpy(im2[:1])
    with torch.inference_mode():
        got = gpu32(x1.cuda(), x2.cuda()).cpu()
        ref = cpu32(x1, x2)
        f4 = RAFT(dataclasses.replace(f32, scan_unroll=-1)).cuda().eval()
        f4.load_state_dict(gpu32.state_dict())
        unrolled = f4(x1.cuda(), x2.cuda()).cpu()
    compare("raft", f"float32 forward (1, {RAFT_HW}, {RAFT_HW}, 1), {cfg.iters} iterations, "
            "GPU vs CPU", got, ref, *MODEL_TOL)
    compare("raft", "scan_unroll=-1 (F4) vs scan_unroll=1 on the card", unrolled, got, 1e-6, 1e-6)

    flow_train_command(card, tmp, task, "raft", counts)
    train_cfg = ExperimentConfig(model="raft", max_num_epochs=1, num_batches_per_epoch=1)
    trainer = Trainer(train_cfg, tmp / "raft_step", device="cuda").initialize()
    sup = {"image1": im1[:TRAIN_BATCH, :TRAIN_HW, :TRAIN_HW],
           "image2": im2[:TRAIN_BATCH, :TRAIN_HW, :TRAIN_HW],
           "flow_gt": gt[:TRAIN_BATCH, :TRAIN_HW, :TRAIN_HW]}
    _reset_counts()
    loss, aux = trainer.run_iteration(sup)
    torch.cuda.synchronize()
    expect(np.isfinite(loss) and set(aux) == {"seq_loss"}, f"supervised step: {loss} {aux}")
    step_ms = host_ms(lambda: trainer.run_iteration(sup), reps=3, warmup=1)
    phase("raft", f"Trainer step, supervised route ({TRAIN_BATCH}, {TRAIN_HW}, {TRAIN_HW}, 1) "
          f"bf16 with flow_gt: sequence loss {loss:.5f}, {step_ms:.3f} ms host clock ({card})")
    p = RAFT_PARITY_HW
    loss_fn = make_raft_loss(ExperimentConfig(model="raft", raft=f32))
    for route in ("unsupervised", "supervised"):
        batch = {"image1": im1[:1, :p, :p], "image2": im2[:1, :p, :p]}
        if route == "supervised":
            batch["flow_gt"] = gt[:1, :p, :p]
        loss_grad_parity(f"raft {route} (1, {p}, {p}, 1)",
                         lambda: RAFT(f32, generator=torch.Generator().manual_seed(33)),
                         loss_fn, {k: np.ascontiguousarray(v) for k, v in batch.items()},
                         [(torch, "relu", 0.0)], card)
    return counts


def voxelmorph_phase(card: str, tmp: Path, task: Path, dev: dict) -> dict:
    """Phase 30: VoxelMorph at VoxelMorphModelConfig() (diffeomorphic, 7
    steps, bf16), random weights: register_sequence over a VXM_T-frame cine
    at VXM_HW^2 (VXM_T - 1 pairs, tools/bench_all.py:104's geometry) with
    its ms, pairs/s and peak memory, and the busy share of ``dev`` (as
    phase 29's); the flows' Jacobian
    determinants (ops/jacobian.py) card vs CPU; one 3-D pair of
    VXM_3D (z replicate-padded to a multiple of 8, the U-Net's 3 halvings);
    csof_torch_train voxelmorph; the float32 loss and gradients card vs
    CPU."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from csof_tpu_torch.config.experiment import ExperimentConfig, VoxelMorphModelConfig
    from csof_tpu_torch.models import voxelmorph
    from csof_tpu_torch.models.voxelmorph import VoxelMorph, register_sequence
    from csof_tpu_torch.ops.jacobian import jacobian_determinant_batch
    from csof_tpu_torch.training.trainer import make_voxelmorph_loss

    cfg = VoxelMorphModelConfig()
    expect(cfg.diffeomorphic and cfg.int_steps == 7 and cfg.dtype == "bfloat16",
           f"VoxelMorphModelConfig() is {cfg}")
    rng = np.random.RandomState(41)
    yy, xx = np.mgrid[:VXM_HW, :VXM_HW]
    frames = []
    for t in range(VXM_T):
        r = 40 + 12 * np.cos(2 * np.pi * t / (VXM_T - 1))
        disk = (yy - 0.48 * VXM_HW) ** 2 + (xx - 0.52 * VXM_HW) ** 2 <= r * r
        frames.append(0.15 + 0.7 * disk + 0.1 * rng.rand(VXM_HW, VXM_HW))
    cine = torch.from_numpy(np.asarray(frames, np.float32)[..., None])
    model = VoxelMorph(cfg, generator=torch.Generator().manual_seed(41)).eval()
    with torch.no_grad():  # the flow head's init is near zero: fields of a few pixels instead
        model.flow_head.weight.mul_(3e4)
    model = model.cuda()
    counts = {}
    with torch.inference_mode():
        c = cine.cuda()
        _reset_counts()
        out = register_sequence(model, c)
        torch.cuda.synchronize()
        counts["voxelmorph_sequence"] = {k: v for k, v in _read_counts().items() if v}
        n = VXM_T - 1
        for k, shape in (("flow", (n, VXM_HW, VXM_HW, 2)), ("flow_inverse", (n, VXM_HW, VXM_HW, 2)),
                         ("registered", (n, VXM_HW, VXM_HW, 1))):
            expect(tuple(out[k].shape) == shape and bool(torch.isfinite(out[k]).all()),
                   f"register_sequence {k}: {tuple(out[k].shape)}")
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(lambda: register_sequence(model, c), reps=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        phase("voxelmorph", f"register_sequence ({VXM_T}, {VXM_HW}, {VXM_HW}, 1) bf16, {n} pairs: "
              f"{ms:.3f} ms (CUDA events, median of 10), {n / ms * 1e3:.1f} pairs/s; "
              f"{busy_line(dev)}; peak {peak:.3f} GiB; launches "
              f"{counts['voxelmorph_sequence']} ({card})")
        flows = out["flow"]
        det = jacobian_determinant_batch(flows)
        ref = jacobian_determinant_batch(flows.cpu())
        compare("voxelmorph", f"Jacobian determinants of the {n} flows, card vs CPU",
                det.cpu(), ref, 1e-5, 1e-5)
        phase("voxelmorph", f"flows up to {float(flows.abs().max()):.3f} px; det J: min "
              f"{float(ref.min()):.4f}, max {float(ref.max()):.4f}, share <= 0 "
              f"{float((ref <= 0).float().mean()):.5f}")

        d, h, w = VXM_3D
        pad = -(-d // 8) * 8 - d
        vol = torch.from_numpy(rng.rand(2, 1, d, h, w).astype(np.float32))
        vol = F.pad(vol, (0, 0, 0, 0, 0, pad), mode="replicate").movedim(1, -1).cuda()
        model3 = VoxelMorph(cfg, ndim=3, generator=torch.Generator().manual_seed(42)).cuda().eval()
        torch.cuda.reset_peak_memory_stats()
        out3 = model3(vol[:1], vol[1:])
        torch.cuda.synchronize()
        expect(tuple(out3["flow"].shape) == (1, d + pad, h, w, 3)
               and bool(torch.isfinite(out3["flow"]).all())
               and bool(torch.isfinite(out3["registered"]).all()), "3-D pair outputs")
        ms3 = median_ms(lambda: model3(vol[:1], vol[1:]), reps=5, warmup=1)
        peak3 = torch.cuda.max_memory_allocated() / 2 ** 30
    phase("voxelmorph", f"one 3-D pair {VXM_3D} (z padded to {d + pad}) bf16: {ms3:.3f} ms, peak "
          f"{peak3:.3f} GiB, flow {tuple(out3['flow'].shape)} finite ({card})")

    flow_train_command(card, tmp, task, "voxelmorph", counts)
    f32 = dataclasses.replace(cfg, dtype="float32")
    loss_fn = make_voxelmorph_loss(ExperimentConfig(model="voxelmorph", voxelmorph=f32))
    fr = np.asarray(frames, np.float32)[..., None]
    batch = {"moving": fr[[VXM_T // 3, VXM_T // 2], :128, :128], "fixed": fr[[0, 0], :128, :128]}
    loss_grad_parity("voxelmorph",
                     lambda: VoxelMorph(f32, generator=torch.Generator().manual_seed(43)),
                     loss_fn, {k: np.ascontiguousarray(v) for k, v in batch.items()},
                     [(voxelmorph, "leaky_relu", 0.2)], card)
    return counts


def finalflow_phase(card: str, dev: dict) -> tuple[dict, dict]:
    """Phase 31: FinalFlow at FinalFlowConfig() (widths 32, 64, 128, group
    norm, bf16), random weights, over FF_B cines x FF_T frames x FF_HW^2
    (bench.py:98's geometry): each bottleneck (gru, 3d, transformer) and gru
    with diffeomorphic=True, with CSOF_CONV2D_IMPL unset and =pallas (ms a
    forward, CUDA events; under pallas K6 counted by the wrapper, equal to
    FinalFlow.kernel_launches); norm="instance" with CSOF_FUSED_NORM=1 under
    pallas (K5 likewise); the same forwards' K5 and K6 as device events,
    ``dev``, from a fresh process (``flow_device_events``); K6 and K5 against
    their plain versions at every distinct shape these forwards gave them
    (bf16 as run and float32), with one forward's kernel, plain, library and
    bound ms; then each bottleneck's float32 forward under pallas, card vs
    CPU, at 1 x FF_PARITY_T x FF_HW^2. Returns (launches, kernel entries)."""
    import torch

    from csof_tpu_torch.models.finalflow import FinalFlow, FinalFlowConfig

    rng = np.random.RandomState(51)
    yy, xx = np.mgrid[:FF_HW, :FF_HW]
    videos = np.empty((FF_B, FF_T, FF_HW, FF_HW, 1), np.float32)
    for b in range(FF_B):
        cy, cx = FF_HW * (0.45 + 0.1 * rng.rand()), FF_HW * (0.45 + 0.1 * rng.rand())
        for t in range(FF_T):
            r = 22 + 6 * np.cos(2 * np.pi * t / FF_T)
            videos[b, t, ..., 0] = (0.7 * ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r)
                                    + 0.15 + 0.1 * rng.rand(FF_HW, FF_HW))
    video = torch.from_numpy(videos).cuda()
    counts, k6_calls, k5_calls = {}, {}, {}
    runs = [(f"{bt}", dict(bottleneck_type=bt)) for bt in ("gru", "3d", "transformer")]
    runs += [("gru diffeomorphic", dict(diffeomorphic=True)), ("instance + K5", dict(
        norm="instance"))]
    for name, kw in runs:
        cfg = FinalFlowConfig(**kw)
        models = {}
        for switch in ("native", "pallas"):
            fused = "1" if name == "instance + K5" and switch == "pallas" else "0"
            with env(CSOF_CONV2D_IMPL=switch, CSOF_FUSED_NORM=fused):
                model = FinalFlow(cfg, generator=torch.Generator().manual_seed(52)).cuda().eval()
            models[switch] = model
            want = model.kernel_launches(FF_T, FF_HW)
            with torch.inference_mode():
                _reset_counts()
                if switch == "pallas":
                    with conv_shapes(k6_calls), norm_act_shapes(k5_calls):
                        out = model(video)
                else:
                    out = model(video)
                torch.cuda.synchronize()
                got = {k: v for k, v in _read_counts().items() if v}
                expect(got == {k: v for k, v in want.items() if v},
                       f"finalflow {name} {switch}: launches {got}, expected {want}")
                if got:
                    counts[f"finalflow {name}"] = got
                for k in ("flow", "flow_forward", "registered"):
                    expect(bool(torch.isfinite(out[k]).all()), f"finalflow {name}: {k} not finite")
                expect(tuple(out["flow"].shape) == (FF_B, FF_T, FF_HW, FF_HW, 2)
                       and not bool(out["flow"][:, 0].any()), f"finalflow {name}: flow")
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            t_on, t_off = timed_pair(lambda: models["pallas"](video),
                                     lambda: models["native"](video))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        phase("finalflow", f"{name}: forward ({FF_B}, {FF_T}, {FF_HW}, {FF_HW}, 1) bf16 "
              f"{t_off:.3f} ms with the switch unset, {t_on:.3f} ms under pallas"
              f"{' + CSOF_FUSED_NORM=1' if name == 'instance + K5' else ''} (CUDA events, "
              f"medians of 20 in the order unset, pallas, pallas, unset); launches under it "
              f"{counts.get(f'finalflow {name}', {})} = kernel_launches; peak {peak:.3f} GiB "
              f"({card})")
    # the same forwards' K5 and K6 as device events, traced in a fresh process
    for name, _ in runs:
        got = {k: dev[name][k] for k in ("K5", "K6")}
        expect(got == {k: dev[name]["want"][k] for k in ("K5", "K6")}
               == {k: counts[f"finalflow {name}"].get(k, 0) for k in ("K5", "K6")},
               f"finalflow {name}: device events {got}, wrapper {counts[f'finalflow {name}']}, "
               f"kernel_launches {dev[name]['want']}")
    phase("finalflow", f"K5 and K6 as device events of one forward each (a fresh process): "
          f"{ {name: {k: dev[name][k] for k in ('K5', 'K6')} for name, _ in runs} } = the "
          f"wrapper counts = FinalFlow.kernel_launches")

    # one forward's K6 calls: each run made the same calls; K5 ran in the instance run only
    entries = recorded_kernel_checks(
        "finalflow", k6_calls, k5_calls, {k: c / len(runs) for k, c in k6_calls.items()},
        k5_calls, torch.bfloat16, card, seed=53)

    small = torch.from_numpy(videos[:1, :FF_PARITY_T])
    for bt in ("gru", "3d", "transformer"):
        cpu = FinalFlow(FinalFlowConfig(bottleneck_type=bt, dtype="float32"),
                        generator=torch.Generator().manual_seed(54), conv_impl="pallas").eval()
        with torch.no_grad():  # the head's init is near zero: flows of a few pixels instead
            cpu.flow_decoder.Conv_0.weight.mul_(1e4)
        gpu = copy.deepcopy(cpu).cuda()
        with torch.inference_mode():
            got, ref = gpu(small.cuda()), cpu(small)
        for k in ("flow", "registered"):
            compare("finalflow", f"float32 {bt} under pallas (1, {FF_PARITY_T}, {FF_HW}, {FF_HW}, "
                    f"1): {k} GPU vs CPU (flows up to {float(ref['flow'].abs().max()):.2f} px)",
                    got[k].cpu(), ref[k], *MODEL_TOL)
    return counts, entries


# -- phase 32: the nnU-Net tail -----------------------------------------------


def nnunet_tail_phase(card: str, tmp: Path, task: Path, served: list, want: dict) -> dict:
    """Phase 32, inside phase 23's folder: the planned 2d and 3d U-Nets
    (trained there on one task) predict its served cases again with the
    softmax saved (both softmaxes at the cases' cropped original geometry,
    so they compare as JAX compares them); find_best_configuration over the
    two and their ensemble, determine_postprocessing on the 2d predictions;
    export_model_to_zip -> install_model_from_zip of the 2d fold, whose
    predictions must be the same bits; print_available_models over the
    folders, change_model on the installed one, plot_task_pngs of the task;
    the 2d fold's debug.json, network_architecture.txt, progress.png and
    training log. ``want``: the launches of phase 23's predictions of the
    same cases. Each command's host seconds; returns the launches."""
    import contextlib
    import io

    import torch

    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import load_experiment_config
    from csof_tpu_torch.utils.logging import read_training_logs
    from csof_tpu_torch.utils.nifti import load_nifti
    from csof_tpu_torch.utils.png import read_png

    counts: dict = {}
    switches = dict(CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="1")

    def run(name, entry, argv, launches=None):
        return run_command(counts, "nnunet tail", name, entry, argv, launches or {}, card,
                           **switches)

    folds = {"unet2d": tmp / "unet" / "fold_0", "unet3d": tmp / "unet3d" / "fold_0"}
    for kind, fold in folds.items():
        run(f"csof_torch_predict --save-npz {kind}", cli.predict_entry,
            ["-m", fold, "-i", tmp / "imagesTs", "-o", tmp / f"sel_{kind}", "--save-npz"],
            want[kind])
    labels = ["-l", "1", "2", "3"]
    run("csof_torch_find_best_configuration", cli.find_best_configuration_entry,
        ["-f", *(f"{k}={tmp / f'sel_{k}'}" for k in folds), "-r", task / "labelsTr", *labels,
         "-o", tmp / "best.json"])
    best = json.loads((tmp / "best.json").read_text())
    names = {"unet2d", "unet3d", "ensemble_unet2d+unet3d"}
    expect(set(best["scores"]) == names and best["best"] in names
           and all(0 <= v <= 1 for v in best["scores"].values()), f"selection {best}")
    run("csof_torch_determine_postprocessing", cli.determine_postprocessing_entry,
        ["-p", tmp / "sel_unet2d", "-r", task / "labelsTr", *labels])
    post = json.loads((tmp / "sel_unet2d" / "postprocessing.json").read_text())
    expect(set(post) == {"for_which_classes", "dice_after"}, f"postprocessing {post}")
    phase("nnunet tail", f"scores {best['scores']}, best {best['best']}, its postprocessing "
          f"{best['postprocessing']['for_which_classes']}; the 2d predictions' {post}")

    run("csof_torch_export_model_to_zip", cli.export_model_entry,
        ["-m", folds["unet2d"], "-o", tmp / "unet2d.zip"])
    with zipfile.ZipFile(tmp / "unet2d.zip") as z:
        members = z.namelist()
    expect({"model_final_checkpoint.pt", "config.yaml", "plans.json", "debug.json"}
           <= set(members), f"zip members {members}")
    installed = tmp / "zoo" / "unet2d" / "fold_0"
    run("csof_torch_install_model_from_zip", cli.install_model_entry,
        [tmp / "unet2d.zip", "-o", installed])
    run("csof_torch_predict installed", cli.predict_entry,
        ["-m", installed, "-i", tmp / "imagesTs", "-o", tmp / "sel_installed", "--save-npz"],
        want["unet2d"])
    for c in served:
        same = (np.array_equal(load_nifti(tmp / "sel_installed" / f"{c}.nii.gz").data_czyx,
                               load_nifti(tmp / "sel_unet2d" / f"{c}.nii.gz").data_czyx)
                and np.array_equal(np.load(tmp / "sel_installed" / f"{c}.npz")["softmax"],
                                   np.load(tmp / "sel_unet2d" / f"{c}.npz")["softmax"]))
        expect(same, f"{c}: the installed fold predicts other bits")
    shutil.copytree(folds["unet3d"], tmp / "zoo" / "unet3d" / "fold_0")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run("csof_torch_print_available_models", cli.print_models_entry, ["-r", tmp / "zoo"])
    print(buf.getvalue(), end="", flush=True)
    listing = [line for line in buf.getvalue().splitlines() if "  model=" in line]
    expect([line.split("model=")[1] for line in listing] == ["unet2d", "unet3d"],
           f"listing {listing}")
    run("csof_torch_change_model", cli.change_model_entry, ["-m", installed, "-k", "unet3d"])
    expect(load_experiment_config(installed / "config.yaml").model == "unet3d",
           "change_model did not change the kind")
    run("csof_torch_plot_task_pngs", cli.plot_task_pngs_entry,
        ["-t", task, "-o", tmp / "overlays"])
    pngs = sorted((tmp / "overlays").glob("*.png"))
    expect(len(pngs) == len(list((task / "labelsTr").glob("*.nii.gz")))
           and all(read_png(f).shape == (*DP_SHAPE[1:], 4) for f in pngs),
           f"{len(pngs)} overlays")
    phase("nnunet tail", f"the installed fold predicts the same bits for {len(served)} cases; "
          f"{listing}; {len(pngs)} overlays {DP_SHAPE[1:]} RGBA")

    fold = folds["unet2d"]
    debug = json.loads((fold / "debug.json").read_text())
    expect(debug["device_name"] == torch.cuda.get_device_name(0)
           and debug["model_class"] == "GenericUNet" and debug["num_parameters"] > 0,
           f"debug.json {sorted(debug)}")
    arch = (fold / "network_architecture.txt").read_text()
    expect(arch.endswith(f"total params: {debug['num_parameters']:,}"), "architecture total")
    expect(read_png(fold / "progress.png").shape == (600, 1000, 3), "progress.png size")
    logs = read_training_logs(fold)
    expect(len(logs) == 1 and logs[0][0].startswith("epoch 1: train "), f"training log {logs}")
    phase("nnunet tail", f"fold files: debug.json ({debug['num_parameters']:,} parameters on "
          f"{debug['device_name']}), network_architecture.txt, progress.png 1000 x 600, "
          f"{len(list(fold.glob('training_log_*.txt')))} timestamped log: {logs[0][0]}")
    return counts


# -- phase 33: MTL, Swin, temporal and deformable -----------------------------


def recorded_kernel_checks(label: str, k6_shapes, k5_shapes, k6_forward: dict,
                           k5_forward: dict, k5_dtype, card: str, seed: int = 61) -> dict:
    """K6 and K5 against their plain versions (bf16 and float32, phase 9's
    tolerances) at every recorded shape (``conv_shapes`` / ``norm_act_shapes``
    keys), then one forward's summed kernel, plain and library ms and bound
    at the dtype it ran them: ``k6_forward`` / ``k5_forward`` map a recorded
    shape to its calls in that forward (K5's ran at ``k5_dtype``). Returns
    {"K5", "K6": {ms, plain_ms, library_ms (K5: library_note_ms), bound_ms,
    bound_by, max_abs_err}}."""
    import torch

    from csof_tpu_torch.bounds import bound_ms, conv3x3_work, norm_act_work
    from csof_tpu_torch.ops.kernels import conv as k6
    from csof_tpu_torch.ops.kernels import norm_act as k5

    gen = torch.Generator(device="cuda").manual_seed(seed)
    err = {"K5": 0.0, "K6": 0.0}
    sums = {"K5": [0.0, 0.0, 0.0], "K6": [0.0, 0.0, 0.0]}
    works = {"K5": [], "K6": []}
    for key in sorted(set(k6_shapes), key=str):
        (n, ci, h, w), dtype, co, bias, _ = key
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).removeprefix("torch.")
            x = torch.randn(n, ci, h, w, generator=gen, device="cuda").to(dt)
            wt = torch.randn(co, ci, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * ci)) ** 0.5
            bb = torch.randn(co, generator=gen, device="cuda") * 0.1 if bias else None
            got = k6.conv3x3_cuda(x, wt, bb)
            torch.cuda.synchronize()
            err["K6"] = max(err["K6"], compare(
                label, f"K6 {dname} (N, Ci, Co, H, W)=({n}, {ci}, {co}, {h}, {w})", got,
                k6.conv3x3_plain(x, wt, bb), *UNET_TOL[("K6", dname)]))
            if dt != dtype or key not in k6_forward:
                continue
            t, p = timed_pair(lambda: k6.conv3x3_cuda(x, wt, bb),
                              lambda: k6.conv3x3_plain(x, wt, bb))
            lib = median_ms(lambda: torch.nn.functional.conv2d(
                x, wt.to(dt), None if bb is None else bb.to(dt), padding=1))
            per = k6_forward[key]
            sums["K6"] = [a + per * v for a, v in zip(sums["K6"], (t, p, lib))]
            works["K6"].append((conv3x3_work(n, h, w, ci, co, x.element_size(), bias), per))
    for shape in sorted(set(k5_shapes)):
        n, c, h, w = shape
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).removeprefix("torch.")
            x = (torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.5).to(dt)
            scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
            bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
            got = k5.norm_act_cuda(x, scale, bias)
            torch.cuda.synchronize()
            err["K5"] = max(err["K5"], compare(
                label, f"K5 {dname} (N, C, H, W)={shape}", got,
                k5.norm_act_plain(x, scale, bias), *UNET_TOL[("K5", dname)]))
            if dt != k5_dtype or shape not in k5_forward:
                continue
            t, p = timed_pair(lambda: k5.norm_act_cuda(x, scale, bias),
                              lambda: k5.norm_act_plain(x, scale, bias))
            lib = median_ms(lambda: torch.nn.functional.leaky_relu(
                torch.nn.functional.instance_norm(x, weight=scale.to(dt), bias=bias.to(dt),
                                                  eps=1e-5), 0.01))
            per = k5_forward[shape]
            sums["K5"] = [a + per * v for a, v in zip(sums["K5"], (t, p, lib))]
            works["K5"].append((norm_act_work(n, c, h, w, x.element_size()), per))
    entries = {}
    for key in ("K6", "K5"):
        summed = [sum(c * wk[i] for wk, c in works[key]) for i in range(len(works[key][0][0]))]
        bnd, by = bound_ms(*summed)
        t, p, lib = sums[key]
        phase(label, f"{key}, one forward ({sum(c for _, c in works[key]):.0f} launches at "
              f"{len(works[key])} shapes): kernel {t:.4f} ms, plain {p:.4f} ms, "
              f"{'library' if key == 'K6' else 'library note (F.instance_norm + F.leaky_relu)'} "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}) ({card})")
        entries[key] = {"ms": t, "plain_ms": p, ("library_ms" if key == "K6" else
                                                  "library_note_ms"): lib,
                        "bound_ms": bnd, "bound_by": by, "max_abs_err": err[key]}
    return entries


def family_phase(card: str, dev: dict) -> tuple[dict, dict]:
    """Phase 33: MTL (the conv and the Swin encoder, both heads), the
    temporal model and the deformable layer at full width
    (profile_flow.FAMILY_RUNS: MTLConfig() on 16 x 256 x 224, the temporal
    defaults on 8 cines x 12 frames x 128^2, d = 128 over 32 x 32 maps at
    batch 96; random weights), float32 and bf16, the switches off and on:
    under them the wrapper counts equal kernel_launches and the device
    events of a fresh process's trace (``dev``) (a float32 instance-norm
    run with them off: K7 in each block that runs K5 with them on), the
    outputs match the
    switches-off ones (float32: MODEL_TOL; bf16: FAMILY_BF16_FACTOR times
    the switches-off bf16 forward's distance from the float32 one; the
    decoders' heads scaled by 1e4, so that the logits are of a few units);
    CUDA-event ms a forward (off, on, on, off),
    peak memory, the fresh process's busy share; K6 and K5 against their
    plain versions at every shape these forwards gave them, with one bf16
    forward's times (MTL conv; its instance-norm run for K5); each model's
    float32 forward under the switches card vs CPU at batch 1. Returns
    (launches, kernel entries)."""
    import torch

    from csof_tpu_torch.profile_flow import FAMILY_RUNS, family_inputs, family_model, family_want

    def build(name, dtype, switch, seed=0):
        # the decoders' heads start at normal(1e-5): logits of a few units instead
        model = family_model(name, dtype, switch, seed)
        with torch.no_grad():
            for dec in ("seg_decoder", "rec_decoder", "decoder"):
                if hasattr(model, dec):
                    getattr(model, dec).Conv_0.weight.mul_(1e4)
        return model

    counts, k6_calls, k5_calls = {}, {}, {}
    for name in FAMILY_RUNS:
        args = tuple(a.cuda() for a in family_inputs(name))
        ref32 = None
        for dtype in ("float32", "bfloat16"):
            models = {sw: build(name, dtype, sw).cuda().eval() for sw in (False, True)}
            outs = {}
            for sw, model in models.items():
                want = {k: v for k, v in family_want(model).items() if v and sw}
                k7 = family_want(models[True])["K5"] if dtype == "float32" and not sw else 0
                if k7:  # K5 off: each block that runs K5 with the switches on runs K7
                    want["K7"] = k7
                with torch.inference_mode():
                    _reset_counts()
                    with conv_shapes(k6_calls.setdefault((name, dtype), {})), \
                            norm_act_shapes(k5_calls.setdefault((name, dtype), {})):
                        out = model(*args)
                    torch.cuda.synchronize()
                got = {k: v for k, v in _read_counts().items() if v}
                expect(got == want, f"{name} {dtype} switch {sw}: launches {got}, expected {want}")
                if got:
                    counts[f"{name} {dtype}" + ("" if sw else " switches off")] = got
                outs[sw] = out if isinstance(out, dict) else {"out": out}
                for k, v in outs[sw].items():
                    expect(bool(torch.isfinite(v).all()), f"{name} {dtype}: {k} not finite")
            for k, ref in outs[False].items():
                tol = MODEL_TOL
                if dtype == "bfloat16":
                    own = float((ref.float() - ref32[k]).abs().max())
                    tol = (FAMILY_BF16_FACTOR * own, 0.0)
                    phase("family", f"{name} bf16: {k} off the float32 forward by up to "
                          f"{own:.3e} (max |out| {float(ref32[k].abs().max()):.3f})")
                compare("family", f"{name} {dtype}: {k} {tuple(ref.shape)} switches on vs off",
                        outs[True][k], ref, *tol)
            if dtype == "float32":
                ref32 = outs[False]
            with torch.inference_mode():
                torch.cuda.reset_peak_memory_stats()
                t_on, t_off = timed_pair(lambda: models[True](*args),
                                         lambda: models[False](*args), FAMILY_REPS)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            d = dev[name][dtype]
            expect({k: d[k] for k in ("K5", "K6")} == d["want"]
                   == {k: counts.get(f"{name} {dtype}", {}).get(k, 0) for k in ("K5", "K6")},
                   f"{name} {dtype}: device events {d}, wrapper {counts.get(f'{name} {dtype}')}")
            phase("family", f"{name} {dtype} {tuple(args[0].shape)}: {t_off:.3f} ms a forward "
                  f"with the switches off, {t_on:.3f} on (CUDA events, medians of {FAMILY_REPS} "
                  f"in the order off, on, on, off); launches under them "
                  f"{counts.get(f'{name} {dtype}', {})} = kernel_launches = device events of a "
                  f"fresh process; peak {peak:.3f} GiB; the fresh process: "
                  f"{d['wall_ms']:.3f} ms host clock, busy {d['busy_ms']:.3f} ms, busy share "
                  f"{d['busy_ms'] / d['wall_ms']:.3f}, {d['events']} device events ({card})")
            del models, outs
        torch.cuda.empty_cache()

    for name in FAMILY_RUNS:
        cpu = build(name, "float32", True, seed=62).eval()
        gpu = copy.deepcopy(cpu).cuda()
        small = family_inputs(name, batch=1, seed=63)
        with torch.inference_mode():
            got, ref = gpu(*(a.cuda() for a in small)), cpu(*small)
        got, ref = (o if isinstance(o, dict) else {"out": o} for o in (got, ref))
        for k in ref:
            compare("family", f"{name} float32 batch 1 under the switches: {k} GPU vs CPU",
                    got[k].cpu(), ref[k], *MODEL_TOL)

    entries = recorded_kernel_checks(
        "family", {k: c for calls in k6_calls.values() for k, c in calls.items()},
        {k: c for calls in k5_calls.values() for k, c in calls.items()},
        k6_calls[("mtl conv", "bfloat16")], k5_calls[("mtl conv instance + K5", "bfloat16")],
        torch.bfloat16, card)
    return counts, entries


def generative_device_events() -> dict:
    """``python -m csof_tpu_torch.profile_generative --launches`` in a fresh
    process: each phase-34 run's K6 and K6 dx device events, host-clock ms,
    events and busy ms of one forward and one step under pallas."""
    child = subprocess.run([sys.executable, "-m", "csof_tpu_torch.profile_generative",
                            "--launches"], capture_output=True, text=True, timeout=600)
    expect(child.returncode == 0, f"profile_generative --launches failed: "
           f"{child.stderr[-2000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def _outputs(out) -> dict:
    """A forward's tensors by name (a dict's tensors, else "out")."""
    import torch

    if isinstance(out, dict):
        return {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}
    return {"out": out}


def compare_output(name: str, got, ref, z=None, codebook=None) -> None:
    """A float output within MODEL_TOL; an integer one (the VQ-VAE's codes)
    exactly. Given the reference run's quantizer input ``z`` and its
    ``codebook``, a position whose codes differ passes only as a near tie:
    the two codes' squared distances to z, in float64, within 1e-5 of
    sum(z^2) + sum(c^2), the float32 distance's rounding scale."""
    import torch

    got, ref = got.cpu(), ref.cpu()
    if got.is_floating_point():
        compare("generative", name, got, ref, *MODEL_TOL)
        return
    expect(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    differ = got != ref
    n, ties, worst = int(differ.sum()), 0, 0.0
    if n and z is not None:
        zd = z.detach().cpu().double().reshape(-1, z.shape[-1])[differ.reshape(-1)]
        cb = codebook.detach().cpu().double()
        a, b = cb[got[differ]], cb[ref[differ]]
        gap = ((zd - a).square().sum(1) - (zd - b).square().sum(1)).abs()
        scale = zd.square().sum(1) + torch.maximum(a.square().sum(1), b.square().sum(1))
        worst = float((gap / scale).max())
        ties = int((gap <= 1e-5 * scale).sum())
    ok = ties == n
    phase("generative", f"{name}: {n} of {ref.numel()} codes differ, {ties} of them near ties "
          f"(worst distance gap / scale {worst:.3e}, tie at 1e-5) -> {'ok' if ok else 'FAIL'}")
    expect(ok, f"{name}: {n - ties} codes differ beyond a near tie")


def _instance_biases(models: dict) -> set:
    """Parameter names (model/param) of conv biases right in front of an
    InstanceNorm: their exact gradient is zero (the norm removes a
    per-channel shift), so either device's value is rounding alone."""
    from csof_tpu_torch.models.blocks import ConvNormAct

    out = set()
    for key, model in models.items():
        for name, mod in model.named_modules():
            if isinstance(mod, ConvNormAct) and mod.norm_name.startswith("InstanceNorm"):
                out.add(f"{key}/{name}.Conv_0.bias")
    return out


def step_grad_parity(name: str, card: str) -> dict:
    """One training step of run ``name`` at batch 1 (profile_generative's
    ``small`` cases) on the card and on the CPU from the same weights,
    inputs and draws, the CPU replaying the card's LeakyReLU and ReLU signs
    (``leaky_slopes``): the forward's outputs within MODEL_TOL, the step's
    losses within LOSS_RTOL, every gradient the step leaves within GRAD_TOL
    of its largest entry + 1e-6 (phase 8's bound; conv biases in front of an
    InstanceNorm, whose exact gradient is zero, within GRAD_TOL of the
    model's largest entry). Returns the card case's loss and its worst
    ratio."""
    import torch

    from csof_tpu_torch.models import blocks
    from csof_tpu_torch.profile_generative import build_case

    gpu, cpu = (build_case(name, "pallas", dev, small=True, seed=81) for dev in ("cuda", "cpu"))
    quantizer = cpu.models["vqvae"].VectorQuantizer_0 if name == "vqvae" else None
    z = []
    hook = quantizer and quantizer.register_forward_hook(lambda m, args, out: z.append(args[0]))
    with torch.inference_mode():
        got, ref = _outputs(gpu.forward()), _outputs(cpu.forward())
    if hook:
        hook.remove()
    for k in ref:
        compare_output(f"{name} float32 batch 1 under pallas: {k} {tuple(ref[k].shape)} GPU vs "
                       "CPU", got[k].cpu(), ref[k], *((z[0], quantizer.codebook) if z else ()))
    if gpu.step is None:
        return {}
    sites = [(blocks, "leaky_relu", 0.01), (torch, "relu", 0.0)]
    masks, flips = [], []
    with leaky_slopes(masks, False, flips, sites):
        a = gpu.step()
    with leaky_slopes(masks, True, flips, sites):
        b = cpu.step()
    expect(len(flips) == len(masks), f"{name}: {len(flips)} activations replayed of {len(masks)}")
    a, b = ([float(v) for v in (x if isinstance(x, tuple) else (x,))] for x in (a, b))
    for la, lb in zip(a, b):
        expect(abs(la - lb) <= LOSS_RTOL * abs(lb), f"{name}: loss GPU {la} vs CPU {lb}")
    zero = _instance_biases(gpu.models)
    grads = {}
    for key in gpu.models:
        for (n, p), q in zip(gpu.models[key].named_parameters(),
                             cpu.models[key].parameters()):
            if q.grad is not None:
                grads[f"{key}/{n}"] = (p.grad.cpu(), q.grad)
    expect(bool(grads), f"{name}: the step left no gradient")
    top = max(float(r.abs().max()) for _, r in grads.values())
    worst, worst_name = -1.0, None
    for n, (g, r) in grads.items():
        expect(bool(torch.isfinite(g).all()), f"{name}: {n}: non-finite gradient")
        ratio = (float(g.abs().max()) / (GRAD_TOL * top) if n in zero else
                 float((g - r).abs().max()) / (GRAD_TOL * float(r.abs().max()) + 1e-6))
        if ratio > worst:
            worst, worst_name = ratio, n
    phase("generative", f"{name} step float32 batch 1: loss GPU {a} vs CPU {b}; {len(grads)} "
          f"gradients, worst |diff| / (tol {GRAD_TOL:g} max|g| + 1e-6) = {worst:.3f} at "
          f"{worst_name}; {len(zero & set(grads))} conv biases before an InstanceNorm held to "
          f"{GRAD_TOL:g} of the largest entry; the CPU ran the card's signs at {len(masks)} "
          f"activations, {sum(flips)} of whose inputs take the other sign on the CPU -> "
          f"{'ok' if worst <= 1 else 'FAIL'} ({card})")
    expect(worst <= 1, f"{name}: gradient {worst_name} outside tolerance")
    return {"worst": worst}


def generative_phase(card: str, dev: dict) -> tuple[dict, dict]:
    """Phase 34: the generative family, UDA and the policy search
    (profile_generative.GEN_RUNS: DiffusionConfig() and the other JAX
    defaults at full width, float32, random weights): each run's forward
    and training step with the switch on, whose wrapper counts (zeroed just
    before, read just after) equal kernel_launches and a fresh process's
    device events (``dev``); latent diffusion's sample (SAMPLE_STEPS steps at
    batch SAMPLE_B) and decode, its seconds and launches; the forward's
    outputs with the switch on vs off (MODEL_TOL); CUDA-event ms of the
    forward and the step (off, on, on, off), the step's peak memory and the
    fresh process's busy share; the ControlNet's base parameters the same
    bits after a step; then each forward and step card vs CPU at batch 1
    (``step_grad_parity``); last, K6 and K6 dx against their plain versions
    at every shape these runs gave them, with one DDPM forward's K6 and one
    DDPM step's dx times. Returns (launches by path, kernel entries)."""
    import torch

    from csof_tpu_torch.models.generative import controlnet_param_labels
    from csof_tpu_torch.profile_generative import (GEN_RUNS, SAMPLE_B, SAMPLE_STEPS,
                                                   build_case, sample_ldm)

    counts, records = {}, {}
    for name in GEN_RUNS:
        case = build_case(name, "pallas", "cuda")
        off = build_case(name, "native", "cuda")
        for kind, fn, want in (("forward", case.forward, case.want_forward),
                               ("step", case.step, case.want_step)):
            if fn is None:
                continue
            rec = records.setdefault((name, kind), {})
            with torch.inference_mode(kind == "forward"), conv_shapes(rec):
                _reset_counts()
                out = fn()
                torch.cuda.synchronize()
                got = {k: v for k, v in _read_counts().items() if v}
            expect(got == {k: v for k, v in want.items() if v},
                   f"{name} {kind}: launches {got}, kernel_launches {want}")
            d = dev[name][kind]
            keys = ("K6", "K6_dx", "K7", "K7_dx")
            expect({k: d[k] for k in keys} == {k: got.get(k, 0) for k in keys},
                   f"{name} {kind}: device events {d}, wrapper {got}")
            counts[f"generative {name} {kind}"] = got
            if kind == "forward":
                with torch.inference_mode():
                    ref = _outputs(off.forward())
                outs = _outputs(out)
                for k, v in ref.items():
                    expect(bool(torch.isfinite(outs[k]).all()), f"{name}: {k} not finite")
                    compare_output(f"{name} float32: {k} {tuple(v.shape)} switch on vs off",
                                   outs[k], v)
        if name == "ldm":
            _reset_counts()
            t0 = time.perf_counter()
            img = sample_ldm(case, torch.Generator(device="cuda").manual_seed(3))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = {k: v for k, v in _read_counts().items() if v}
            den, ae = case.models["denoiser"], case.models["ae"]
            want = {"K6": SAMPLE_STEPS * den.kernel_launches(32)["K6"]
                    + ae.kernel_launches(128)["K6"]}
            expect(got == want and tuple(img.shape) == (SAMPLE_B, 128, 128, 1)
                   and bool(torch.isfinite(img).all()), f"ldm sample: launches {got}, expected "
                   f"{want}, images {tuple(img.shape)}")
            counts["generative ldm sample"] = got
            phase("generative", f"ldm sample: {SAMPLE_STEPS} steps at batch {SAMPLE_B} over "
                  f"32^2 x 4 latents + decode to 128^2: {secs:.3f} s host clock, launches {got}"
                  f" ({card})")
        if name == "controlnet":
            labels = controlnet_param_labels(case.models["controlnet"])
            base = {n: p.detach().clone() for n, p in case.models["controlnet"].named_parameters()
                    if labels[n] == "frozen"}
            case.step()
            moved = [n for n, p in case.models["controlnet"].named_parameters()
                     if n in base and not torch.equal(p, base[n])]
            expect(not moved, f"controlnet: base parameters moved by a step: {moved[:5]}")
            phase("generative", f"controlnet: {len(base)} base parameters the same bits after a "
                  "step, the control branch's moved")
        with torch.inference_mode():
            f_on, f_off = timed_pair(case.forward, off.forward, FAMILY_REPS)
        line = (f"{name} float32: forward {f_off:.3f} ms with the switch off, {f_on:.3f} on")
        if case.step is not None:
            torch.cuda.reset_peak_memory_stats()
            s_on, s_off = timed_pair(case.step, off.step, GEN_STEP_REPS)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            d = dev[name]["step"]
            line += (f"; step {s_off:.3f} / {s_on:.3f} ms (CUDA events, medians in the order off,"
                     f" on, on, off); peak over those steps {peak:.3f} GiB; a fresh process's "
                     f"step: "
                     f"{d['wall_ms']:.3f} ms host clock, busy {d['busy_ms']:.3f} ms, busy share "
                     f"{d['busy_ms'] / d['wall_ms']:.3f}, {d['events']} device events")
        phase("generative", f"{line}; launches forward {counts[f'generative {name} forward']}, "
              f"step {counts.get(f'generative {name} step')} = kernel_launches = device events "
              f"({card})")
        del case, off
        torch.cuda.empty_cache()

    for name in GEN_RUNS:
        step_grad_parity(name, card)

    others = {}
    for (name, kind), rec in records.items():
        if (name, kind) not in (("ddpm", "forward"), ("ddpm", "step")):
            for k, v in rec.items():
                others[k] = others.get(k, 0) + v
    convs = check_recorded_convs("generative", records[("ddpm", "forward")],
                                 records[("ddpm", "step")], others, torch.float32, card,
                                 ("one DDPM forward", "one DDPM step's dx"), seed=34)
    return counts, convs


def _step_grads(trainer) -> list:
    """Each step's gradients as ``Optimizer.step`` sees them (after DDP's
    average), {name: tensor or None}, appended as the trainer steps."""
    record: list = []
    step = trainer.optimizer.step

    def capturing_step():
        record.append({n: None if p.grad is None else p.grad.detach().clone()
                       for n, p in trainer.model.named_parameters()})
        step()

    trainer.optimizer.step = capturing_step
    return record


def _par_trainer(config, out: Path, **kw):
    """A Trainer on the card (DDP-wrapped if a process group is up) and the
    record of its gradients."""
    from csof_tpu_torch.training.trainer import Trainer

    tr = Trainer(config, out, device=kw.pop("device", "cuda"), **kw).initialize()
    return tr, _step_grads(tr)


def _par_grads(label: str, got: dict, ref: dict) -> float:
    """Phase 8's bound on every gradient leaf (a leaf without a gradient on
    one side must have none on the other); the worst ratio."""
    worst, worst_name = 0.0, None
    for name, r in ref.items():
        g = got[name]
        if r is None:
            expect(g is None, f"{label}: {name} has a gradient on one side only")
            continue
        g, r = (np.asarray(x.float().cpu() if hasattr(x, "cpu") else x) for x in (g, r))
        expect(bool(np.isfinite(g).all()), f"{label}: {name}: non-finite gradient")
        ratio = float(np.abs(g - r).max()) / (GRAD_TOL * float(np.abs(r).max()) + 1e-6)
        if ratio > worst:
            worst, worst_name = ratio, name
    expect(worst <= 1, f"{label}: gradient {worst_name} outside tolerance ({worst:.3f})")
    return worst


def _alternate(a, b, batch, rounds: int = PAR_ROUNDS) -> tuple[float, float]:
    """Median host ms of a train step of ``a`` and of ``b``, in turns a, b,
    b, a (each step ends in the loss read, a synchronize)."""
    times: dict = {id(a): [], id(b): []}
    for _ in range(rounds):
        for tr in (a, b, b, a):
            tr.run_iteration(batch)
            times[id(tr)].append(tr.history.step_times[-1] * 1e3)
    return statistics.median(times[id(a)]), statistics.median(times[id(b)])


def _gloo_rank(rank: int, init: str, config, batch: dict) -> dict:
    """Phase 35 (c), one of two gloo ranks on cuda:0 (a spawned process): one
    Trainer step of SegFlow on its two videos of the global four."""
    import torch
    import torch.distributed as dist

    from csof_tpu_torch.ops.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.load_library()
    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tr, grads = _par_trainer(config, Path(tmp), device=torch.device("cuda", 0))
            _reset_counts()
            loss, _ = tr.run_iteration(batch)
            torch.cuda.synchronize()
            counts = _read_counts()
        return {"loss": loss, "mesh": tr.mesh.shape, "counts": counts,
                "grads": {n: None if g is None else g.cpu().numpy() for n, g in grads[0].items()}}
    finally:
        dist.destroy_process_group()


def parallel_phase(card: str, dp_root: Path, dp_tmp: Path) -> dict:
    """Phase 35: data-parallel training and sharded serving over
    torch.distributed. Returns the launches of every run of the phase."""
    import multiprocessing
    import socket

    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from csof_tpu_torch import native
    from csof_tpu_torch.cli import main as cli
    from csof_tpu_torch.config.experiment import (
        DataConfig,
        ExperimentConfig,
        OptimConfig,
        SegFlowModelConfig,
    )
    from csof_tpu_torch.config.plans import Plans, task002_heart_2d
    from csof_tpu_torch.data import loaders
    from csof_tpu_torch.data.loaders import VideoChunkLoader
    from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor
    from csof_tpu_torch.models.unet import unet_from_plans
    from csof_tpu_torch.ops.sliding_window import bucket_image_shape, step_grid
    from csof_tpu_torch.parallel.mesh import make_mesh
    from csof_tpu_torch.utils.logging import read_training_logs

    total: dict = {}

    def take() -> dict:
        got = _read_counts()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        _reset_counts()
        return {k: v for k, v in got.items() if v}

    _reset_counts()
    tmp = dp_tmp / "parallel"
    # (a), (b): the trainers without a process group first, then the group
    # SGD, so that the parameters compare: AdamW turns rounding noise in
    # near-zero gradients into full steps
    sgd = OptimConfig(optimizer="sgd", scheduler="poly", initial_lr=1e-2, weight_decay=3e-5)
    seg_cfg = ExperimentConfig(data=DataConfig(do_data_aug=False, batch_size=TRAIN_BATCH,
                                               video_length=TRAIN_T, crop_size=TRAIN_HW),
                               optim=sgd)
    loader = VideoChunkLoader(synthetic_videos(), TRAIN_T, TRAIN_BATCH, TRAIN_HW, seed=0)
    seg_batches = [next(loader) for _ in range(PAR_STEPS)]
    plain_a, grads_a = _par_trainer(seg_cfg, tmp / "a")
    plain_b, grads_b = _par_trainer(seg_cfg, tmp / "b")
    plans = task002_heart_2d()
    sp = plans.fullres_stage()
    unet_cfg = ExperimentConfig(model="unet2d", data=DataConfig(do_data_aug=False), optim=sgd)
    rng = np.random.RandomState(35)
    seg = np.zeros((sp.batch_size, *sp.patch_size), np.int32)
    seg[:, 100:220, 70:180] = 1
    unet_batch = {"seg": seg, "data": (rng.randn(sp.batch_size, *sp.patch_size, 1)
                                       + seg[..., None]).astype(np.float32)}
    with env(CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="0"):
        unet_plain, unet_grads_plain = _par_trainer(unet_cfg, tmp / "u", plans=plans)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        # (a) SegFlow, bf16, full width, DDP over NCCL at world 1
        ddp, grads_d = _par_trainer(seg_cfg, tmp / "d")
        expect(isinstance(ddp.train_model, DistributedDataParallel)
               and ddp.mesh.group is not None and ddp.mesh.shape == {"data": 1, "model": 1},
               f"the trainer under NCCL is not data parallel: {ddp.mesh}")
        take()
        loss_d = [ddp.run_iteration(b)[0] for b in seg_batches]
        seg_ddp = take()
        loss_a = [plain_a.run_iteration(b)[0] for b in seg_batches]
        loss_b = [plain_b.run_iteration(b)[0] for b in seg_batches]
        seg_plain = take()
        expect(seg_plain == {k: 2 * v for k, v in seg_ddp.items()}
               and seg_ddp.get("K1") == seg_ddp.get("K2") == CORR_PER_STEP * PAR_STEPS,
               f"SegFlow launches DDP {seg_ddp}, the two unwrapped {seg_plain}")
        for i, (d, a, b) in enumerate(zip(loss_d, loss_a, loss_b)):
            expect(abs(d - a) <= 2 * abs(b - a) + 1e-6 * abs(a),
                   f"step {i + 1}: loss DDP {d} vs {a} (a second unwrapped run {b})")
        worst = max(_par_grads("parallel segflow", gd, ga) for gd, ga in zip(grads_d, grads_a))
        same = [sum(x[n] is None and y[n] is None or x[n] is not None and y[n] is not None
                    and torch.equal(x[n], y[n]) for n in y)
                for x, y in ((grads_d[0], grads_a[0]), (grads_b[0], grads_a[0]))]
        # the gradient bound carried through two SGD-Nesterov steps (momentum
        # m): lr (1 + m) (2 + m) (GRAD_TOL max|g| + 1e-6), and twice the
        # spread of the two unwrapped runs
        lr_m = sgd.initial_lr * (1 + sgd.sgd_momentum) * (2 + sgd.sgd_momentum)
        p_a, p_b = dict(plain_a.model.named_parameters()), dict(plain_b.model.named_parameters())
        param_worst = 0.0
        for name, p in ddp.model.named_parameters():
            g = grads_a[0][name]
            bound = (lr_m * (GRAD_TOL * (0.0 if g is None else float(g.abs().max())) + 1e-6)
                     + 2 * float((p_b[name] - p_a[name]).detach().abs().max()))
            param_worst = max(param_worst, float((p - p_a[name]).detach().abs().max()) / bound)
        expect(param_worst <= 1, f"parameters after {PAR_STEPS} SGD steps: DDP vs unwrapped "
               f"{param_worst:.3f} of their bound")
        seg_ms_plain, seg_ms_ddp = _alternate(plain_a, ddp, seg_batches[0])
        phase("parallel", f"(a) SegFlow ({TRAIN_BATCH}, {TRAIN_T}, {TRAIN_HW}, {TRAIN_HW}, 1) "
              f"bf16, SGD, under DDP over NCCL at world 1: losses {loss_d} vs unwrapped "
              f"{loss_a} (a second unwrapped run {loss_b}); gradients worst {worst:.3f} of "
              f"phase 8's bound, step 1 the same bits at {same[0]} of {len(grads_a[0])} leaves "
              f"(the two unwrapped runs {same[1]}); parameters after {PAR_STEPS} steps "
              f"{param_worst:.3f} of their bound; launches "
              f"{seg_ddp} a trainer; step median {seg_ms_ddp:.3f} ms DDP vs {seg_ms_plain:.3f} "
              f"ms unwrapped, host clock ({card})")
        take()
        del plain_a, plain_b, ddp, grads_a, grads_b, grads_d, p_a, p_b

        # (b) the Task002 2d U-Net under pallas through the global-batch Dice
        with env(CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="0"):
            unet_ddp, unet_grads_ddp = _par_trainer(unet_cfg, tmp / "v", plans=plans)
        p0 = {n: p.detach().clone() for n, p in unet_plain.model.named_parameters()}
        take()
        u_loss_d = unet_ddp.run_iteration(unet_batch)[0]
        u_loss_p = unet_plain.run_iteration(unet_batch)[0]
        unet_counts = take()
        per = unet_plain.model.kernel_launches(sp.patch_size, backward=True)
        expect(unet_counts == {k: 2 * per[k] for k in ("K6", "K6_dx", "K7", "K7_dx")}
               and per["K7"] == per["K7_dx"] == 26,
               f"U-Net launches {unet_counts}, expected {per} a step")
        expect(abs(u_loss_d - u_loss_p) <= LOSS_RTOL * abs(u_loss_p),
               f"U-Net loss DDP {u_loss_d} vs {u_loss_p}")
        u_worst = _par_grads("parallel unet", unet_grads_ddp[0], unet_grads_plain[0])
        factor = unet_cfg.optim.initial_lr * (1 + unet_cfg.optim.sgd_momentum)
        plain_params = dict(unet_plain.model.named_parameters())
        for name, p in unet_ddp.model.named_parameters():
            ref, g = plain_params[name], unet_grads_plain[0][name]
            gmax = 0.0 if g is None else float(g.abs().max())
            tol = factor * (GRAD_TOL * gmax + 1e-6) + 2 * float(torch.finfo(torch.float32).eps
                                                                 * p0[name].abs().max())
            expect(float((p - ref).detach().abs().max()) <= tol,
                   f"U-Net {name} after one SGD step")
        u_ms_plain, u_ms_ddp = _alternate(unet_plain, unet_ddp, unet_batch)
        phase("parallel", f"(b) Task002 2d U-Net ({sp.batch_size}, 1, {sp.patch_size[0]}, "
              f"{sp.patch_size[1]}) float32 under pallas, DDP over NCCL at world 1 with the "
              f"batch Dice through the gather: loss {u_loss_d:.7f} vs {u_loss_p:.7f} "
              f"unwrapped; gradients worst {u_worst:.3f} of phase 8's bound; the parameters "
              f"after one SGD step within lr (1 + momentum) x that bound; launches "
              f"{unet_counts} (both sides); step median {u_ms_ddp:.3f} ms DDP vs "
              f"{u_ms_plain:.3f} ms unwrapped, host clock ({card})")
        take()
        del unet_plain, unet_ddp, unet_grads_plain, unet_grads_ddp, p0, plain_params
        torch.cuda.empty_cache()

        # (d) predict_sharded at world 1 over NCCL, K5 and K6
        with env(CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="1"):
            net = unet_from_plans(plans, fused_norm_act=True, conv_impl="pallas",
                                  generator=torch.Generator().manual_seed(35)).cuda().eval()
        pcfg = PredictorConfig(patch_size=tuple(sp.patch_size),
                               num_classes=plans.num_classes_with_background,
                               tile_batch=UNET_TILE_BATCH)
        predictor = SlidingWindowPredictor(net, pcfg, "cuda")
        image = synthetic_case(np.random.RandomState(36), depth=1)[None, 0].copy()
        image = (image - image.mean()) / image.std()
        mesh = make_mesh(device="cuda:0")
        take()
        seg_s, probs_s = predictor.predict_sharded(image, mesh)
        sharded_counts = take()
        seg_p, probs_p = predictor.predict(image)
        predict_counts = take()
        tiles = len(step_grid(sp.patch_size, bucket_image_shape(image.shape[1:], sp.patch_size,
                                                                0.5, pcfg.bucket), 0.5))
        per_fwd = net.kernel_launches(sp.patch_size)
        fwd_s = -(-tiles // UNET_TILE_BATCH)
        expect(sharded_counts == {k: v * fwd_s for k, v in per_fwd.items() if v},
               f"predict_sharded launches {sharded_counts}, {fwd_s} forwards of {per_fwd}")
        err = float(np.abs(probs_s - probs_p).max())
        agree = float((seg_s == seg_p).mean())
        expect(err <= PAR_PROBS_ATOL and agree >= 0.999 and np.isfinite(probs_s).all(),
               f"predict_sharded vs predict: {err:.3e} softmax, {agree:.5f} labels")
        ms_s = host_ms(lambda: predictor.predict_sharded(image, mesh), reps=5, warmup=1)
        ms_p = host_ms(lambda: predictor.predict(image), reps=5, warmup=1)
        phase("parallel", f"(d) predict_sharded of one {image.shape} slice ({tiles} tiles x 4 "
              f"mirrors, K5 and K6 on) over NCCL at world 1 vs predict: softmax max abs "
              f"{err:.3e} (tol {PAR_PROBS_ATOL:g}), labels {agree:.5f} equal; launches "
              f"{sharded_counts} vs {predict_counts}; {ms_s:.3f} ms vs {ms_p:.3f} ms, host "
              f"clock median of 5 ({card})")
        take()
        del net, predictor
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (c) gloo at world 2, both ranks on cuda:0: SegFlow float32 on 2 + 2 videos
    cfg_c = ExperimentConfig(segflow=SegFlowModelConfig(dtype="float32"),
                             data=DataConfig(batch_size=4, video_length=TRAIN_T,
                                             crop_size=TRAIN_HW))
    batch_c = next(VideoChunkLoader(synthetic_videos(), TRAIN_T, 4, TRAIN_HW, seed=3))
    t0 = time.perf_counter()
    init = (tmp / "gloo_store").as_uri()
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        ranks = pool.starmap(_gloo_rank, [(r, init, cfg_c, batch_c) for r in range(2)])
    spawn_s = time.perf_counter() - t0
    ref_tr, ref_grads = _par_trainer(cfg_c, tmp / "w1")
    take()
    ref_loss = ref_tr.run_iteration(batch_c)[0]
    w1_counts = take()
    c_worst = 0.0
    for r, res in enumerate(ranks):
        expect(res["mesh"] == {"data": 2, "model": 1}, f"rank {r}: mesh {res['mesh']}")
        expect(abs(res["loss"] - ref_loss) <= LOSS_RTOL * abs(ref_loss),
               f"rank {r}: loss {res['loss']} vs world 1 {ref_loss}")
        c_worst = max(c_worst, _par_grads(f"parallel gloo rank {r}", res["grads"],
                                          ref_grads[0]))
        for k, v in res["counts"].items():
            total[k] = total.get(k, 0) + v
    expect(ranks[0]["counts"]["K1"] == CORR_PER_STEP and ranks[0]["counts"]["K2"] == CORR_PER_STEP,
           f"a rank's launches {ranks[0]['counts']}")
    phase("parallel", f"(c) SegFlow float32 with the video augmentation, gloo at world 2 on "
          f"one card (2 + 2 videos of {TRAIN_T} x {TRAIN_HW}^2) vs world 1 on 4: losses "
          f"{[r['loss'] for r in ranks]} vs {ref_loss}; all-reduced gradients worst "
          f"{c_worst:.3f} of phase 8's bound; launches a rank "
          f"{ {k: v for k, v in ranks[0]['counts'].items() if v} }, world 1 {w1_counts}; two "
          f"spawned ranks {spawn_s:.1f} s host clock ({card})")
    del ref_tr, ref_grads, ranks
    torch.cuda.empty_cache()

    # (e) csof_torch_train under torchrun's variables at world 1 (NCCL)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dp_plans = Plans.from_json(dp_root / "plans_2D.json")
    per = unet_from_plans(dp_plans, conv_impl="pallas", fused_norm_act=False).cuda(
        ).kernel_launches(dp_plans.fullres_stage().patch_size, backward=True)
    out = tmp / "torchrun"
    counts_e: dict = {}
    with env(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)):
        secs = run_command(counts_e, "parallel", "csof_torch_train unet2d torchrun",
                           cli.train_entry, ["-c", dp_tmp / "unet.yaml", "-p", dp_root, "-o", out],
                           {"K6": per["K6"] * (DP_STEPS + DP_VAL),
                            "K6_dx": per["K6_dx"] * DP_STEPS,
                            "K7": per["K7"] * (DP_STEPS + DP_VAL),
                            "K7_dx": per["K7_dx"] * DP_STEPS}, card,
                           CSOF_CONV2D_IMPL="pallas", CSOF_FUSED_NORM="0")
    for k, v in counts_e["csof_torch_train unet2d torchrun"].items():
        total[k] = total.get(k, 0) + v
    fold = out / "fold_0"
    debug = json.loads((fold / "debug.json").read_text())
    logs = read_training_logs(fold)
    expect(not dist.is_initialized() and len(logs) == 1 and len(logs[0]) == 1
           and (fold / "model_final_checkpoint.pt").is_file()
           and (fold / "model_best.pt").is_file() and (fold / "config.yaml").is_file()
           and debug["mesh_shape"] == {"data": 1, "model": 1}
           and debug["devices"] == ["cuda:0"],
           f"torchrun fold: {sorted(p.name for p in fold.iterdir())}, {debug.get('mesh_shape')}")
    phase("parallel", f"(e) csof_torch_train under torchrun's variables (world 1, NCCL) on phase "
          f"23's root: {secs:.3f} s host clock, one log line {logs[0][0]!r}, the checkpoints and "
          f"debug.json (mesh {debug['mesh_shape']}, devices {debug['devices']}) written once")

    # (f) the native host library against its numpy versions, at the loaders'
    # calls (SegPatchLoader: one centre a call; VideoChunkLoader: one clip)
    lib = native.bindings.load_library()
    case = np.load(sorted((dp_root / "preprocessed_2d").glob("*.npz"))[0])["data"]
    arr = np.ascontiguousarray(case[:, case.shape[1] // 2], np.float32)
    prng = np.random.RandomState(37)
    centers = np.stack([prng.randint(-60, s + 60, 64) for s in arr.shape[1:]], 1)
    patch = tuple(dp_plans.fullres_stage().patch_size)
    got = native.extract_patches_2d(arr, centers, patch)
    expect(np.array_equal(got, loaders.extract_patches(arr, centers, patch)),
           "the C++ gather differs from the numpy branch")
    clip = np.ascontiguousarray(synthetic_cine(prng)[:TRAIN_T, 0, :TRAIN_HW, :TRAIN_HW],
                                np.float32)
    mm = native.minmax_normalize(clip.copy())
    mm_err = float(np.abs(mm - loaders.minmax_normalize(clip.copy())).max())
    expect(mm_err <= 2.0 ** -22, f"the C++ min-max is {mm_err} off the numpy branch")

    def host_med(fn, reps=21):
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times)

    one = centers[:1]
    g_ms = host_med(lambda: native.extract_patches_2d(arr, one, patch))
    g_np = host_med(lambda: loaders.extract_patches(arr, one, patch))
    m_ms = host_med(lambda: native.minmax_normalize(clip.copy()))
    m_np = host_med(lambda: loaders.minmax_normalize(clip.copy()))
    phase("parallel", f"(f) {Path(lib._name).name}: the gather of 64 patches {patch} from "
          f"{arr.shape} (centres past the borders) equal to the numpy branch, min-max of a "
          f"{clip.shape} clip within {mm_err:.2e} of it; a loader's call: one patch "
          f"{g_ms:.4f} ms vs {g_np:.4f} ms numpy, one clip {m_ms:.4f} ms vs {m_np:.4f} ms "
          f"(host clock medians of 21, {os.cpu_count()} CPUs, threads a call "
          f"{native.bindings.threads_for(1, got[0].size)} and "
          f"{native.bindings.threads_for(len(clip), clip.size)})")
    for k in ("K1", "K2", "K5", "K6", "K6_dx", "K7", "K7_dx"):
        expect(total.get(k, 0) > 0, f"phase 35 never launched {k}: {total}")
    return total


_MAIN_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from csof_tpu_torch.config.experiment import SegFlowModelConfig
        from csof_tpu_torch.inference.serving import apply_serving_config
        from csof_tpu_torch.models.segflow import SegFlow
        from csof_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the csof_tpu_torch package is missing: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    phase("build", f"{lib.name}: nvcc {_build.last_build_seconds:.1f} s, "
          f"ready in {time.perf_counter() - t0:.1f} s")
    from csof_tpu_torch.sass_census import counts

    hgmma = {}
    tc_kernels = ("conv3x3_kernel", "conv3x3_dx_kernel", "fuse_conv_kernel")
    for name, n in counts(lib).items():
        for kern in tc_kernels:
            if f"::{kern}<" in name:
                hgmma.setdefault(kern, []).append(n)
    expect(set(hgmma) == set(tc_kernels) and all(min(v) > 0 for v in hgmma.values()),
           f"K6 or K3's conv pass without tensor-core instructions: {hgmma}")
    phase("build", "HGMMA instructions per K6 and K3-conv instantiation (cuobjdump -sass): "
          f"{hgmma}")

    kernels = check_kernels(card)

    cfg = apply_serving_config(SegFlowModelConfig(), T_FRAMES)
    expect(cfg.corr_fuse == "fused_cm", f"serving config runs {cfg.corr_fuse}")
    model_cpu = SegFlow(cfg, num_classes=4, generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(model_cpu).cuda().eval()
    counts = serve(model, card)
    parity(model_cpu)
    throughput(model, card)
    del model, model_cpu
    train_counts = train(card)
    train_parity(card)

    from csof_tpu_torch.config.plans import task002_heart_2d
    from csof_tpu_torch.models.unet import unet_from_plans

    kernels.update(check_unet_kernels(card))
    plans = task002_heart_2d()
    unet_cpu = unet_from_plans(plans, fused_norm_act=True, conv_impl="pallas",
                               generator=torch.Generator().manual_seed(0)).eval()
    unet = copy.deepcopy(unet_cpu).cuda()
    unet_counts = unet_serve(unet, plans, card)
    unet_parity(unet_cpu, card)
    unet_throughput(unet, plans, card)
    del unet, unet_cpu
    torch.cuda.empty_cache()
    kernels["K6_dx"] = check_unet_train_kernels(card)
    kernels.update(check_unet_norm_kernels(card))
    unet_train_counts = unet_train(card)
    unet_train_parity(card)
    kernels["K4"], ncc_counts = check_ncc(card)

    t_new = time.perf_counter()
    torch.cuda.empty_cache()
    pallas_serving_counts, serving_shapes = segflow_pallas_serving(card)
    pallas_train_counts, train_shapes = segflow_pallas_train(card)
    modes_counts = segflow_modes(card)
    convs = check_segflow_convs(card, serving_shapes, train_shapes)
    wide, wide_counts = check_ncc_wide(card)
    kernels["K4"].update(wide)
    kernels["K4"]["max_abs_err"] = max(kernels["K4"]["max_abs_err"], wide["max_abs_err"])
    for k, key in (("K6", "fwd"), ("K6_dx", "dx")):
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], convs["max_abs_err"])
        kernels[k].update({f"segflow_bf16_{name}": v for name, v in convs[key].items()})
    phase("segflow pallas", f"phases 17-21 took {time.perf_counter() - t_new:.1f} s")
    t_cli = time.perf_counter()
    torch.cuda.empty_cache()
    cli_counts = cli_phase(card)
    phase("cli", f"phase 22 took {time.perf_counter() - t_cli:.1f} s")
    t_dp = time.perf_counter()
    torch.cuda.empty_cache()
    record3d = {}
    tail_counts: dict = {}
    dp_dir = tempfile.TemporaryDirectory()  # phase 35 trains on its root
    dp_tmp = Path(dp_dir.name)
    dp_counts, dp_errs = data_plane_phase(card, record3d, tail_counts, dp_tmp)
    for k, e in dp_errs.items():
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], e)
    phase("data plane", f"phase 23 took {time.perf_counter() - t_dp:.1f} s (phase 32 included)")
    t_u3 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        u3_root, u3_images = unet3d_data(tmp)
        with conv_shapes(record3d):
            u3_train_counts, u3_fold = unet3d_train(card, tmp, u3_root)
            u3_serve_counts = unet3d_serve(card, tmp, u3_fold, u3_images)
        unet3d_parity(card, record3d)
        u3 = check_unet3d_kernels(card, record3d)
        cascade_counts = cascade_phase(card, tmp)
    for k in ("K6", "K6_dx"):
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], u3[k].pop("max_abs_err"))
        kernels[k].update(u3[k])
    phase("unet3d", f"phases 24-28 took {time.perf_counter() - t_u3:.1f} s")
    t_flow = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        flow_cines = cine_task(tmp / "flow_task", np.random.RandomState(11))  # phase 22's
        dev = flow_device_events()
        raft_counts = raft_phase(card, tmp, flow_cines, dev["raft"])
        vxm_counts = voxelmorph_phase(card, tmp, flow_cines, dev["voxelmorph"])
    torch.cuda.empty_cache()
    ff_counts, ff_entries = finalflow_phase(card, dev["finalflow"])
    for k in ("K5", "K6"):
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"],
                                        ff_entries[k].pop("max_abs_err"))
        kernels[k].update({f"finalflow_bf16_{name}": v for name, v in ff_entries[k].items()})
    phase("flow models", f"phases 29-31 took {time.perf_counter() - t_flow:.1f} s")
    t_fam = time.perf_counter()
    torch.cuda.empty_cache()
    fam_counts, fam_entries = family_phase(card, dev["family"])
    for k in ("K5", "K6"):
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"],
                                        fam_entries[k].pop("max_abs_err"))
        kernels[k].update({f"family_bf16_{name}": v for name, v in fam_entries[k].items()})
    phase("family", f"phase 33 took {time.perf_counter() - t_fam:.1f} s")
    t_gen = time.perf_counter()
    torch.cuda.empty_cache()
    gen_counts, gen_convs = generative_phase(card, generative_device_events())
    for k, key in (("K6", "fwd"), ("K6_dx", "dx")):
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], gen_convs["max_abs_err"])
        kernels[k].update({f"generative_f32_{name}": v for name, v in gen_convs[key].items()})
    phase("generative", f"phase 34 took {time.perf_counter() - t_gen:.1f} s")
    t_par = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        par_counts = parallel_phase(card, dp_tmp / f"pre_{DP_WORKERS}", dp_tmp)
    finally:
        dp_dir.cleanup()
    phase("parallel", f"phase 35 took {time.perf_counter() - t_par:.1f} s")

    paths = {"serving": counts, "train": train_counts, "unet_serving": unet_counts,
             "unet_training": unet_train_counts, "ncc_op": ncc_counts,
             "segflow_pallas_serving": pallas_serving_counts,
             "segflow_pallas_train": pallas_train_counts, "segflow_modes": modes_counts,
             "ncc_wide_windows": wide_counts,
             **{name.replace("csof_torch_", "cli ").replace(" --", " "): c
                for name, c in cli_counts.items()},
             **{name.replace("csof_torch_", "data plane ").replace(" --", " "): c
                for name, c in dp_counts.items()},
             "unet3d_training": u3_train_counts, "unet3d_serving": u3_serve_counts,
             "cascade": cascade_counts, **raft_counts, **vxm_counts, **ff_counts,
             **{name.replace("csof_torch_", "nnunet tail ").replace(" --", " "): c
                for name, c in tail_counts.items()}, **fam_counts, **gen_counts,
             "parallel": par_counts}
    by_path = {k: {path: c.get(k, 0) for path, c in paths.items()}
               for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K6_dx", "K7", "K7_dx")}
    sources = {
        "K1": ("local_correlation", "csof_tpu_torch/csrc/corr.cu",
               "csof_tpu/ops/pallas/corr.py:131", None),
        "K2": ("local_correlation_backward", "csof_tpu_torch/csrc/corr_bwd.cu",
               "csof_tpu/ops/pallas/corr.py:409", None),
        "K3": ("fused_skip_fuse", "csof_tpu_torch/csrc/skipfuse.cu",
               "csof_tpu/ops/pallas/skipfuse.py:236",
               "F.conv2d over the (2C+81)-channel concat: K3's conv pass only; "
               "library_note_ms: the whole function as library calls (K1's corr, "
               "torch.cat, F.conv2d, F.group_norm, F.leaky_relu)"),
        "K4": ("ncc_map", "csof_tpu_torch/csrc/ncc.cu", "csof_tpu/ops/pallas/ncc.py:49",
               "none: no one PyTorch call computes the map (on no path of the JAX package; "
               "driven alone through ncc_loss_kernel)"),
        "K5": ("instance_norm_leaky_relu", "csof_tpu_torch/csrc/norm_act.cu",
               "csof_tpu/ops/pallas/norm_act.py:34",
               "none: no one PyTorch call; library_note_ms times F.instance_norm + "
               "F.leaky_relu"),
        "K6": ("conv3x3", "csof_tpu_torch/csrc/conv3x3.cu", "csof_tpu/ops/pallas/conv.py:175",
               "F.conv2d(x, w, b, padding=1)"),
        "K6_dx": ("conv3x3_dx", "csof_tpu_torch/csrc/conv3x3.cu",
                  "csof_tpu/ops/pallas/conv.py:229",
                  "torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1) (cuDNN dgrad)"),
        "K7": ("instance_norm_leaky_relu_native", "csof_tpu_torch/csrc/inorm_lrelu.cu",
               "none: the port's own fusion of leaky_relu(InstanceNorm(z)), the path the JAX "
               "package runs with CSOF_FUSED_NORM=0",
               "leaky_relu(InstanceNorm(z)), eager (the path the route replaces)"),
        "K7_dx": ("instance_norm_leaky_relu_native_backward", "csof_tpu_torch/csrc/inorm_lrelu.cu",
                  "none: the backward of K7's path",
                  "autograd's backward of leaky_relu(InstanceNorm(z)), eager"),
    }
    line = {"kernels": [
        {"name": f"{k} {name}", "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by_path[k].values()), "launches_by_path": by_path[k],
         "max_abs_err": kernels[k]["max_abs_err"], "ms": kernels[k]["ms"],
         "plain_ms": kernels[k]["plain_ms"], "bound_ms": kernels[k]["bound_ms"],
         "bound_by": kernels[k]["bound_by"], "library_ms": kernels[k]["library_ms"],
         **({"library_call": lib_call} if lib_call else {}),
         **{key: v for key, v in kernels[k].items() if key not in _MAIN_KEYS}}
        for k, (name, src, rep, lib_call) in sources.items()
    ]}
    phase("total", f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
