#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (renderformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card: the nvidia-smi name and power limit, and torch's device name;
  2. build: compiles the kernels from renderformer_tpu_torch/csrc, and
     counts the wgmma (HGMMA) and TMA load (UTMALDG) instructions that
     cuobjdump finds in the bf16 flash forward's kernels (K1/K2, K10) and
     the bf16 flash backward's (K8, K9's dK/dV, K9's dQ), which must both be
     non-zero, and the TF32 tensor-core instructions (HMMA .TF32) of the
     fp32 flash forward, of the fp32 dK/dV and dQ kernels of the flash
     backward (K8, K9's dK/dV, K9's dQ) and of the fp32 Swin window
     attention and its backward (K6, K6^T), which must be non-zero, with the
     backward's and the fp32 kernels' spills and registers, and those of
     K11's backward and K5;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     every shape the v1-base, v1.1-swin-large and v1-base nerf 512^2 renders
     give it, in bf16 and fp32 (the flash forward without RoPE, K10, and the
     fused RMSNorm, K11, in the renders' bf16), with kernel, plain, library
     and bound times (CUDA events, median; K4 and K5 also by CUDA graphs of
     calls, beside F.interpolate's; K3 also by CUDA graphs of calls, beside
     its bytes bound; K11's forward and backward also by CUDA graphs, beside
     F.rms_norm's and its autograd's; K11's backward's ds in the scale's
     dtype is its checked fp32 sum rounded once, the same bits in two calls
     and three replays of a CUDA graph), the tile plan of the bf16 flash
     forward at each site, and the flash forward (K1/K2 and K10, with and
     without the logsumexp) at its tile edges: Sq and Sk of 129 and 257, a
     batch row whose mask is all zero, a view fan-out; K1, K2 and K3 also at
     the shapes of phase 13's renders: infer's unpadded scene (1,809 keys,
     one view) and batch_infer's batches of 8 scenes at 3,728 keys;
  4. render, for each of v1-base, v1.1-swin-large and v1-base nerf
     (V1_BASE_NERF, pe_type='nerf', with RuntimeConfig(fused_norm=True)) at
     full width and full depth from a seeded init, with the default composed
     DPT tail: 1 scene x 8 views x 2048 triangles at 512^2 in bf16 (the
     bench.py workload), with exact launch counts of every kernel (counts set
     to 0 just before the render, read just after), finite output, and HDR
     PSNR against the same render through the plain versions (>= 40 dB; an
     fp32 render at 128^2 must reach >= 55 dB);
  5. speed, for each model: rays/s of the bf16 render on inputs already on
     the card, median of timed renders, and a profiler breakdown of one
     render (device time by kernel, and the device's idle share of the
     median unprofiled render); for v1-base also, with no bar, rays/s of the
     render with fused_norm=True beside the default, timed in turn;
  6. training kernels: the forward with its logsumexp (K1/K2, timed in
     turn with the render's instantiation), K3 (also by CUDA graphs of
     calls), the flash backward's tile plan at each site (keys a block, q
     step, q split, blocks on the card's SMs), the flash backward through
     its wrapper (K8 fused; K9 two-kernel, each of its dQ and dK/dV kernels
     timed alone against the plain version of its part; K8 also by bursts
     of launches beside autograd of SDPA; K9's dQ kernel also by CUDA graphs
     of calls beside autograd of SDPA for dq alone, with its tile plan, in
     both dtypes at every site, where two calls and three replays of a CUDA
     graph must give the same bits), K4, K5 and the
     transposed resize (K4^T; also by CUDA graphs of calls beside autograd of
     F.interpolate's, and on g in space-to-depth layout at K5's VJP) against
     their plain versions, at every shape of the v1-base train step, in bf16
     and fp32, and K10 with its logsumexp
     and K11's forward and backward at the nerf train step's shapes and
     dtypes, timed as in phase 3, and the flash forward's tile edges of
     phase 3 with the logsumexp; then the v1.1-swin-large train step's
     shapes in the dtypes it runs them: K3, K1 with the logsumexp and K8 at
     its 8-head sites, K4, K5 and K4^T at 512^2, K6 (also by CUDA graphs of
     calls beside SDPA's) and K7 in fp32, K7's VJP
     (bit for bit the inverse regroup), and K6's backward (K6^T) in fp32 at
     the step's 64 windows and in bf16 at the 8-view render's 512, shifted
     and unshifted, the same bits in two launches, by single calls and CUDA
     graphs beside autograd of SDPA with the boolean window mask;
  7. train: v1-base at full width and depth from a seeded init, the
     train_step_bench.py workload (1 scene x 1 view x 2048 triangles at
     256^2, bf16 stage 1 with an fp32 view stage, remat, AdamW): exact launch
     counts of one step with the fused backward and one with the two-kernel
     backward (counts set to 0 just before each step, read just after); the
     loss, grad norm, gradient cosine and worst per-parameter gradient of the
     kernel step against the same step through the plain versions, and of
     fused against two-kernel, within AGREE_BARS, while a planted fault in
     the backward must fall outside them; finite
     loss and grad norm over 3 steps; the median step time of 5 steps after a
     warm-up, trained rays/s, peak memory, and the device's idle share from
     one profiled step, of the fused and of the two-kernel backward's
     step.  Then the same workload for v1-base nerf with
     fused_norm=True and the fused backward: exact launch counts of one step,
     the kernel step against the plain step within AGREE_BARS, 3 finite
     steps, and the same timings.  Then v1.1-swin-large at full width and
     depth, the same workload at 512^2: the kernel step against the plain
     step within AGREE_BARS, exact launch counts, 3 finite steps and the
     same timings.  For v1-base and swin-large, two steps with
     TrainConfig(deterministic=True) (the two-kernel backward, deterministic
     cuDNN) from the same state and batch give the same bits of the loss,
     every gradient and every updated parameter;
  8. entry points, on v1-base at full width and depth from a seeded init in
     bf16 on the bench.py scene: the weights written as an HF directory
     (config.json + model.safetensors in the reference layout) and by
     export_params (jax_format) into a temporary directory, each loaded by
     RenderingPipeline.from_pretrained (load seconds printed) and rendered,
     equal bit for bit to the seeded render where two seeded renders give
     the same bits (else within their max-abs, stated); render_many over 4
     chunks of 8 views, with exactly 4 times a render's launch counts
     (counts set to 0 just before it, read just after), each chunk equal to
     render of its cameras under the same bar, and its rays/s beside four
     render calls, in turn (no bar); the infer stage writing 8 EXR and 8 PNG
     files, view 0's EXR the render's fp32 output; batch_infer's per-batch
     and video loops with --no_output on in-memory dicts, each printing its
     rays/s line; the HF and jax_format directories and a golden image
     (the seeded render of tools/verify_checkpoint's random scene, fp32,
     256^2) are kept for phase 12;
  9. fine-tuning through the training entry point: train.build with
     configs/config.yml's settings (v1-base at full width and depth from a
     seeded init, bf16 stage 1, remat, 256^2, batch 1, lr 5e-6) on the
     port's RenderFormerDataset over 5 in-memory scenes of 1,900-2,048
     triangles (a subclass replaces only the H5 read; 4 compact textures,
     1 full; 512^2 ground-truth PNGs written by io/image.write_png, read and
     downsized by the dataset), 2 epochs with a checkpoint every epoch:
     exactly phase 7's fused launch counts in one step, finite losses, grad
     norms and validation losses, the validation scene counted once, the
     checkpoints best, epoch_0, epoch_1 and final; under deterministic=True
     a resume from epoch_0 the bits of every parameter of the uninterrupted
     run, and a compact batch the bits of its full texture; dropout 0.1: a
     finite step, two steps at one (seed, step) from the same state the same
     bits, the kernel pass within AGREE_BARS of the plain one with the same
     masks;
     debug_nans: a NaN in the ground truth and one made in a backward raise
     FloatingPointError, a clean step does not, and without the flag the
     NaN skip leaves every parameter as it was; the linear head
     (use_dpt_decoder=False: K1 18 / K2 6 / K3 24) and vdir_num_freqs=6 (and
     K4 3 / K5 1) rendered at 512^2 x 8 views in bf16, >= 40 dB against the
     plain versions; and, informational, the fit loop's trained rays/s
     beside the bare step's;
 10. scenes to ground truth on the card: the native meshops library built
     with g++ from native/meshops.cpp (seconds printed); examples/cbox.json
     (remeshed: 4,326 triangles, one light) and veach-mis.json converted in
     memory through the port's scene modules; the path tracer's physics
     checks on the card (primary emission exact, direct lighting analytic,
     the furnace cases with the bars of tests/test_path_tracer.py); cbox's
     128^2 primary rays through the card's intersect against the CPU's (t
     within 1e-5 relative, the triangle equal but at ties), and again under
     allow_tf32=True (the same bits); a glossy 14-triangle box at 32^2, 256
     spp, depth 3, card against CPU (4x4-block means within 2x the
     difference of two card seeds, image means within 2 %); cbox's ground
     truth at generate_dataset's settings (256^2, 64 spp, depth 3, clamp 10),
     finite and >= 0, with seconds an image, path samples a second, peak
     memory and the device idle share of a profiled 4-spp image; cbox through
     the seeded v1-base renderer in bf16 at 512^2 with exactly a render's
     launches (K1 18 / K2 6 / K3 24 / K4 3 / K5 1); and generate_dataset's
     GT pass on two scene dicts at --seed 0, pathtrace (64^2, 16 spp) and
     model (tiny), writing PNGs through io/image.write_png;
 11. the multi-GPU code on one card: setup_distributed() under torchrun's
     environment of world 1 makes an NCCL group; the ring's one-device fold
     of 4 K/V slices at v1-base's view-stage cross site (8 views x 4,096
     rays x 6 heads x 128 against 2,064 keys, view 0's last 516 masked: a
     whole slice) and ray-self site (4,096 keys), in bf16 and fp32, the
     site's q rotation and K3 included: the output and (dq, dk, dv) against
     one unsharded K10 + K8 call and the plain ring (the kernels' plain
     versions), and the fold under the two-kernel backward against its own
     plain ring, within 2^-16 (fp32) and 2^-7 (bf16) of max|ref|, and
     against the ring of the JAX partials in torch ops within 2^-16 and
     2^-6 (a recorded deviation: that function does not round q after its
     scaling), with exact launch counts (K3 1, K10 4, K8 or K9's two kernels
     4), each kernel at the fold's shapes against its plain version (K9's
     dQ and dK/dV kernels each timed alone beside autograd of SDPA for its
     part, the dQ kernel also by CUDA graphs, on paths of their own, 'ring
     <site> <dtype> twokernel'), and the fold's ms beside the unsharded
     call's;
     one v1-base fit step through train.build inside the group, exactly
     phase 7's fused launches with the gradient all-reduce run, and under
     deterministic=True the loss, the grad norm and every updated parameter
     the bits of the same step with no group; the v1-base 512^2 x 8-view
     render on use_mesh() the bits of the render without it, with exactly a
     render's launches; --attn_impl xla raising on the card; and
     utils.profiling.trace() around a render writing a trace that names K1
     and an annotate()d range; make_mesh() with no group a mesh of one rank;
 12. the workflow tools on the card: (a) tools/overfit_run at its defaults
     on v1-base at full width and depth: 8 orbit frames of examples/cbox.json
     (4,326 triangles, padded to 4,352) converted in memory, the teacher's
     ground truth rendered in fp32 through the plain versions, the student
     (the teacher plus the JAX tool's noise) fine-tuned 8 epochs x 8 steps at
     256^2, bf16 with the fp32 view stage, through the trainer and dataset:
     every step's launches exact (K1 18 / K2 6 / K3 48 / K4 3 / K5 1 / K4^T 4
     / K8 18 + 6: no remat, as the JAX tool), the JAX pass condition (all
     finite, last epoch < 0.5 x first, epochs 3.. below the first), the
     losses, recovery ratio, fit seconds, trained rays/s and one profiled
     step's idle share; (b) tools/verify_checkpoint on phase 8's two
     directories against its golden image: steps 1, 2, 4 pass, 3 skipped,
     205,173,391 counted; (c) tools/precision_study on v1.1-swin-large at
     512^2, frame 0 padded to 4,352: each of its three renders exactly a
     swin-large render's launches, its stages' weights in its precisions'
     dtypes, the six PSNRs finite; (d) tools/gt_noise_sweep on frame 0 at
     64^2, spp 8/32/128 against a 512-spp reference, clamp 1: the unclamped
     PSNR rising at each step, the clamp's bias finite; (e)
     tools/compare_renders on the golden image and a copy: PSNR inf.
 13. the ft128 fine-tune cycle from files, with h5py and PyYAML made
     unimportable by a sys.meta_path finder (a line first says which of
     h5py, yaml, cv2, matplotlib and torch.utils.tensorboard import on the
     machine): the first 24 scene JSONs of datasets/ft128/json (sorted)
     converted from the repo root by the generator's function,
     scene/h5_tools.save_dict_to_h5_renderformer_method, into H5 files
     under build/ft128, each read back through io/h5 the bits of
     scene_tensors of its JSON; train.main -c on a copy of
     configs/config_tpu_finetune.yml whose h5_dir, checkpoint_dir and
     log_dir point there and which saves every epoch (v1-base at full
     width and depth from the seeded init, 256^2, bf16, remat, 2 epochs of
     21 steps, 3 scenes validated, all padded to 3,712 triangles): every
     step exactly phase 7's fused counts, finite losses and validation
     losses, the checkpoints best, epoch_0, epoch_1 and final, the step's
     ms and trained rays/s; infer --h5_file on one file and batch_infer over
     the folder (--padding_length 3712, batches of 8), each render exactly
     a v1-base render's launches, every EXR and PNG read back equal to its
     render, and the MP4; render_h5_to_png as a raster and path traced at
     4 spp with no kernel launched.  Its step's kernels are rows of phase
     6 at 3,728 keys (path 'ft128 fit v1-base'); infer's and batch_infer's
     are rows of phase 3 at their shapes (paths 'ft128 infer v1-base' and
     'ft128 batch_infer v1-base', one render each).
Then one JSON line with every kernel's numbers per render of each model
and per train step, the nvidia-smi line, and the result line.  Any failed
check exits non-zero before the result line.  Imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_TENSOR = 989e12   # H100 SXM dense bf16 tensor-core flop/s
PEAK_FP32 = 67e12           # H100 SXM fp32 flop/s outside the tensor cores
PEAK_TF32 = 494.7e12        # H100 SXM dense TF32 tensor-core flop/s
SPLIT_TF32 = PEAK_TF32 / 3  # fp32 products as split TF32: three TF32 products each
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s

# the renders at 512^2, 8 views, 2048 triangles
V, RES, NTRI = 8, 512, 2048
SK = 2048 + 16          # triangles + register tokens
ST = (RES // 8) ** 2    # ray tokens
D = 128                 # head dim of both models
DPT_C = 128             # dpt_features of both models
SWIN_C, SWIN_H = 1024, 8
GRID = RES // 8         # the 64 x 64 patch grid
NW = (GRID // 8) ** 2   # 8 x 8 windows a view
BASE, SWIN, NERF = 'v1-base', 'v1.1-swin-large', 'v1-base nerf'
PATHS = (BASE, SWIN, NERF)
# the train step at 256^2, 1 view, 2048 triangles: v1-base with the fused and
# the two-kernel backward, v1-base nerf with the fused backward and K11; and
# v1.1-swin-large's at 512^2 with the fused backward
TRAIN, TRAIN2, TRAIN_NERF = 'train v1-base', 'train v1-base twokernel', 'train v1-base nerf'
TRAIN_SWIN = 'train v1.1-swin-large'
ROPE_TRAIN = (TRAIN, TRAIN2)
TRAIN_PATHS = (TRAIN, TRAIN2, TRAIN_NERF, TRAIN_SWIN)
# phase 11: the ring's one-device fold at v1-base's view-stage cross and
# ray-self sites, in bf16 and fp32, with K8's backward and, as paths of their
# own, under the two-kernel backward (K9)
RING_FUSED = tuple(f'ring {site} {dt}' for site in ('cross', 'ray-self')
                   for dt in ('bf16', 'fp32'))
RING_PATHS = RING_FUSED + tuple(f'{p} twokernel' for p in RING_FUSED)
# phase 12: one student step of tools/overfit_run (v1-base at 256^2, no
# remat), and each of tools/precision_study's three swin-large renders (512^2,
# one view), by (stage-1, view-stage) precision; both on cbox's orbit frames,
# 4,326 triangles padded to 4,352
OVERFIT = 'overfit v1-base'
PRECISION_PATHS = {pv: f'precision {SWIN} {name}' for pv, name in (
    (('fp32', 'fp32'), 'fp32'), (('bf16', 'fp32'), 'bf16 fp32-view'), (('bf16', 'bf16'), 'bf16'))}
PREC_F32, PREC_F32V, PREC_BF16 = PRECISION_PATHS.values()
TOOL_PATHS = (OVERFIT,) + tuple(PRECISION_PATHS.values())
PRECISION_RES, PRECISION_PAD = 512, 4352   # precision_study's defaults
TOOL_SK = PRECISION_PAD + 16   # their attention sites' keys: triangles + register tokens
# phase 13: one step of the ft128 fine-tune that train.main runs from
# configs/config_tpu_finetune.yml (v1-base at 256^2, remat), its scenes
# padded to 3,712 triangles
FT128 = 'ft128 fit v1-base'
# and one render of each of phase 13's infer (random_scene_0_sphere3
# unpadded: 1,793 triangles, one view) and batch_infer (8 scenes of one view
# padded to 3,712 triangles) at 512^2 in bf16
FT_INFER, FT_BATCH = 'ft128 infer v1-base', 'ft128 batch_infer v1-base'
FT_PATHS = (FT128, FT_INFER, FT_BATCH)
ALL_PATHS = PATHS + TRAIN_PATHS + RING_PATHS + TOOL_PATHS + FT_PATHS
MASK_VALID = 16 + NTRI * 3 // 4   # keys kept at 2,064: a padded tail of triangles masked
TRAIN_RES = 256
TRAIN_ST = (TRAIN_RES // 8) ** 2   # 1024 ray tokens
SWIN_TRAIN_RES = 512               # swin-large's step: 4096 ray tokens, 64 windows
TRAIN_STEPS = 5                    # timed steps after a warm-up
LSE_BURST = 20                     # launches per timing of the logsumexp A/B

BWD_SOURCES = ['renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
               'renderformer_tpu_torch/csrc/flash_bwd.cu']
# K6 and K6^T: bf16 in their own files, fp32 in one file of both
SWIN_SOURCES = ['renderformer_tpu_torch/csrc/swin_attention.cu',
                'renderformer_tpu_torch/csrc/swin_attention_f32.cu']
KERNELS = {
    'flash_fwd_rope_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:876'),
    'flash_fwd_rope_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:888'),
    'rot_kv_broadcast': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/rot_kv.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:819'),
    # K8 and K9's dK/dV kernel: bf16 in flash_bwd_sm90.cu, fp32 in flash_bwd.cu
    'flash_bwd_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
        sources=BWD_SOURCES, replaces='renderformer_tpu/ops/flash_attention.py:425'),
    'flash_bwd_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
        sources=BWD_SOURCES, replaces='renderformer_tpu/ops/flash_attention.py:425'),
    # K9's dQ kernel: bf16 in flash_bwd_dq_sm90.cu, fp32 in flash_bwd.cu
    'flash_bwd_dq': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_dq_sm90.cu',
        sources=['renderformer_tpu_torch/csrc/flash_bwd_dq_sm90.cu',
                 'renderformer_tpu_torch/csrc/flash_bwd.cu'],
        replaces='renderformer_tpu/ops/flash_attention.py:323'),
    'flash_bwd_dkv': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_bwd_sm90.cu',
        sources=BWD_SOURCES, replaces='renderformer_tpu/ops/flash_attention.py:368'),
    'resize_bilinear': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/resize.cu',
        replaces='renderformer_tpu/ops/fused_resize.py:100'),
    'resize_bilinear_t': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/resize.cu',
        replaces='renderformer_tpu/ops/fused_resize.py:100'),
    'resize_s2d': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/resize.cu',
        replaces='renderformer_tpu/ops/fused_resize.py:229'),
    'swin_window_attention': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/swin_attention.cu',
        sources=SWIN_SOURCES, replaces='renderformer_tpu/ops/swin_attention.py:72'),
    # K6^T: the TPU package takes this VJP in XLA (_swin_op_bwd, the VJP of
    # the jnp _ref_paired); no Pallas kernel there
    'swin_window_attention_bwd': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/swin_attention_bwd.cu',
        sources=['renderformer_tpu_torch/csrc/swin_attention_bwd.cu', SWIN_SOURCES[1]],
        replaces='renderformer_tpu/ops/swin_attention.py:168'),
    # K7 forward and inverse, and as its own VJP (the inverse of the direction
    # it undoes): one kernel, one count
    'shifted_regroup': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/shifted_regroup.cu',
        replaces='renderformer_tpu/ops/shifted_regroup.py:68'),
    'flash_fwd_mask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:202'),
    'flash_fwd_nomask': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/flash_fwd_sm90.cu',
        replaces='renderformer_tpu/ops/flash_attention.py:217'),
    'rms_norm_fwd': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/fused_norm.cu',
        replaces='renderformer_tpu/ops/fused_norm.py:62'),
    'rms_norm_bwd': dict(
        route='cuda', source='renderformer_tpu_torch/csrc/fused_norm.cu',
        replaces='renderformer_tpu/ops/fused_norm.py:73'),
}


def _launches(**nonzero):
    """A path's launch counts: every kernel of KERNELS, 0 unless given."""
    return {**dict.fromkeys(KERNELS, 0), **nonzero}


# launches in one bf16 512^2 render with the composed DPT tail:
# v1-base: 12 encoder + 6 decoder masked attentions (K1), 6 ray
#   self-attentions (K2), a K rotation before each (K3), refinenet4/3/2
#   upsamples (K4), refinenet1's upsample into s2d layout (K5);
# swin-large: 12 encoder + 12 decoder masked attentions (K1, K3), window
#   attention in every decoder layer (K6), the regroup before and after it in
#   the 6 shifted layers (K7), and the same DPT head;
# v1-base nerf: the same attention sites without RoPE (K10 masked 12 + 6,
#   unmasked 6), the same DPT head, and with fused_norm=True K11 at each of the
#   102 RMSNorms: 3 stage-1 embeddings, 4 a self-attention block (query, q, k,
#   FFN), the ray encoder and the 2 position encodings of the view stage, 8 a
#   decoder block (query, context, cross q and k, self-attention input, q and
#   k, FFN).
# One v1-base train step with remat (each of the 24 attention sites runs K3
# and K1/K2 with the logsumexp in the forward, both again in the backward's
# recomputation, then K3 and the backward), the three K4 upsamples and K5 in
# the forward (the DPT head is not recomputed), and K4^T for the VJP of each.
# The nerf train step runs K10 with the logsumexp twice a site and K8 once,
# and K11's forward at the 102 norms plus again at the 96 inside the
# recomputed blocks, and its backward at the 102.
# One swin-large train step: its 12 encoder self-attentions (bf16) and 12
# decoder cross-attentions (fp32) run K3 three times and K1 twice each, as
# above, and K8 once; each of the 12 decoder layers runs K6 in the forward and
# again in the remat recomputation, and K6^T once; each of the 6 shifted
# layers runs K7 into and out of shifted order in the forward, both again in
# the recomputation, and both again as their VJPs (the regroup's VJP is the
# inverse regroup); the same DPT head's K4, K5 and K4^T.
_TRAIN = dict(flash_fwd_rope_mask=36, flash_fwd_rope_nomask=12, rot_kv_broadcast=72,
              resize_bilinear=3, resize_bilinear_t=4, resize_s2d=1)
EXPECTED_LAUNCHES = {
    BASE: _launches(flash_fwd_rope_mask=18, flash_fwd_rope_nomask=6, rot_kv_broadcast=24,
                    resize_bilinear=3, resize_s2d=1),
    SWIN: _launches(flash_fwd_rope_mask=24, rot_kv_broadcast=24, resize_bilinear=3,
                    resize_s2d=1, swin_window_attention=12, shifted_regroup=12),
    NERF: _launches(flash_fwd_mask=18, flash_fwd_nomask=6, resize_bilinear=3, resize_s2d=1,
                    rms_norm_fwd=102),
    TRAIN: _launches(**_TRAIN, flash_bwd_mask=18, flash_bwd_nomask=6),
    TRAIN2: _launches(**_TRAIN, flash_bwd_dq=24, flash_bwd_dkv=24),
    FT128: _launches(**_TRAIN, flash_bwd_mask=18, flash_bwd_nomask=6),
    TRAIN_NERF: _launches(flash_fwd_mask=36, flash_fwd_nomask=12, flash_bwd_mask=18,
                          flash_bwd_nomask=6, resize_bilinear=3, resize_bilinear_t=4,
                          resize_s2d=1, rms_norm_fwd=198, rms_norm_bwd=102),
    TRAIN_SWIN: _launches(flash_fwd_rope_mask=48, rot_kv_broadcast=72, flash_bwd_mask=24,
                          resize_bilinear=3, resize_bilinear_t=4, resize_s2d=1,
                          swin_window_attention=24, swin_window_attention_bwd=12,
                          shifted_regroup=36),
}

def fail(msg):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def card_line():
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if res.returncode:
        fail(f'nvidia-smi: {res.stderr.strip()}')
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() by CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops, flop_rate):
    """Least time for the work: bytes over HBM rate vs flops over peak."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / flop_rate * 1e3
    return max(tb, tf), ('bytes' if tb >= tf else 'operations')


def graph_burst_ms(fn, n=LSE_BURST, iters=10, side=None):
    """Device milliseconds a call of fn() takes: replays of a CUDA graph of n
    calls between two CUDA events, divided by n, so that no host work sits
    between the launches.  fn is warmed up and captured on ``side`` (a new
    stream by default)."""
    import torch
    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the stream that warmed fn up
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, iters=iters) / n
    del graph
    return ms


def graph_replays(fn, n):
    """fn()'s results after each of n replays of a CUDA graph of one call
    (cloned), the call warmed up and captured on a stream of its own."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    results = []
    for _ in range(n):
        graph.replay()
        torch.cuda.synchronize()
        results.append(tuple(t.clone() for t in out))
    del graph
    return results


def autograd_graph_ms(forward, inputs, grad_out, n=LSE_BURST, iters=10, wrt=None):
    """Device milliseconds of one torch.autograd.grad of ``forward(*inputs)``
    for ``grad_out`` (with respect to the inputs at the indices ``wrt``, all
    by default), as graph_burst_ms times a call: the forward runs once on the
    capturing stream, so that autograd's backward launches there."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = forward(*leaves)
    targets = leaves if wrt is None else [leaves[i] for i in wrt]
    ms = graph_burst_ms(lambda: torch.autograd.grad(out, targets, grad_out, retain_graph=True),
                        n, iters, side)
    del out, leaves
    return ms


def burst_ms(fn, n=LSE_BURST):
    """Milliseconds a call of fn() in bursts of n back-to-back calls between
    two CUDA events, divided by n: the device time where the card outruns
    the host's enqueue."""
    return time_ms(lambda: [fn() for _ in range(n)]) / n


def print_profile(name, kernels):
    """The 25 largest device rows of a profiled run, and below them the rows
    of the resize (K4, K5, K4^T), fused RMSNorm (K11), Swin window attention
    (K6, K6^T) and regroup (K7) kernels."""
    for i, e in enumerate(kernels):
        if i < 25 or any(w in e.key for w in ('resize', 'rms_norm', 'swin', 'regroup')):
            print(f'profile: {name} {e.self_device_time_total / 1e3:9.3f} ms '
                  f'{e.count:5d}x {e.key[:100]}', flush=True)


def psnr(ref, x):
    mse = float(((ref - x) ** 2).mean())
    peak = float(ref.max() - ref.min())
    return 10 * np.log10(peak ** 2 / max(mse, 1e-30))


def record_row(rows, kernel, site, dtype, per_run, out, ref, tol, why, fn, lib_fn, nbytes,
               flops, flop_rate, plain_fn=None):
    """Check one (kernel, site, dtype) and time fn as the kernel and plain_fn
    (default: fn inside reference_kernels()) as the plain version.  out, ref
    and tol may be tuples, checked pair by pair.  per_run: launches at this
    shape and dtype in one run of each path."""
    from renderformer_tpu_torch.ops import reference_kernels
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    tols = tol if isinstance(tol, tuple) else (tol,) * len(outs)
    errs = [float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs)]
    ms = time_ms(fn)
    if plain_fn is None:
        with reference_kernels():
            plain_ms = time_ms(fn, iters=3, warmup=1)
    else:
        plain_ms = time_ms(plain_fn, iters=3, warmup=1)
    lib_ms = time_ms(lib_fn) if lib_fn is not None else None
    bms, by = bound_ms(nbytes, flops, flop_rate)
    row = dict(kernel=kernel, site=site, dtype=str(dtype).split('.')[-1], per_run=per_run,
               max_abs_err=max(errs), errs=errs, tol=list(tols), tol_reason=why, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
    if flop_rate == SPLIT_TF32:
        # an fp32 attention kernel: its bound as split TF32 on the tensor
        # cores, and beside it the bound of the same flops as scalar fp32 FMAs
        row['bound_simt_ms'] = bound_ms(nbytes, flops, PEAK_FP32)[0]
    row['bound_share'] = bms / ms
    print('kernel ' + json.dumps(row), flush=True)
    for e, t in zip(errs, tols):
        if not np.isfinite(e) or e > t:
            fail(f'{kernel} {site} {row["dtype"]}: max err {e} > {t}')
    if bms > ms:
        fail(f'{kernel} {site} {row["dtype"]}: {ms} ms beats its bound {bms} ms ({by})')
    rows.append(row)


def attention_tol(ref, dtype, what):
    """Output-scaled tolerance of the attention kernels (K1, K2, K6)."""
    import torch
    amax = float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        return amax * 4 * 2.0 ** -8, (
            f'q and P round to bf16 in both, {what}, and out rounds once to '
            'bf16: 4 ulps of max|ref|')
    return amax * 2.0 ** -16, 'fp32 sums in another order: 2^-16 of max|ref|'


def check_resize(rows, x, hw, per_run, prefix=''):
    """K4 on x [B, n, n, C] to hw against its plain version; the row's site
    is prefix + n 'to' hw."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear
    b, n_in, _, c = x.shape
    it = x.element_size()
    with torch.inference_mode():
        out = resize_bilinear(x, hw)
        with reference_kernels():
            ref = resize_bilinear(x, hw)
        amax = float(x.float().abs().max())
        if x.dtype == torch.bfloat16:
            tol, why = amax * 2.0 ** -5, ('the plain version rounds frac, 1-frac and each '
                                          'lerp to bf16; the kernel rounds once: 4 ulps of '
                                          'max|x|')
        else:
            tol, why = amax * 2.0 ** -22, 'same fp32 ops in the same order'
        xc = x.permute(0, 3, 1, 2)

        def lib():
            return F.interpolate(xc, size=hw, mode='bilinear', align_corners=True)

        record_row(rows, 'resize_bilinear', f'{prefix}{n_in}to{hw[0]}', x.dtype, per_run, out, ref,
                   tol, why, lambda: resize_bilinear(x, hw), lib,
                   b * (n_in * n_in + hw[0] * hw[1]) * c * it, 8 * b * hw[0] * hw[1] * c,
                   PEAK_FP32)
        # host and device apart: the single call holds the host's enqueue
        # where the card waits for it; a graph of LSE_BURST calls does not
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: resize_bilinear(x, hw))
        row['library_burst_ms'] = graph_burst_ms(lib)
        print(f'resize: resize_bilinear {row["site"]} {row["dtype"]}: single call '
              f'{row["ms"]:.4f} ms against F.interpolate {row["library_ms"]:.4f}; device (graph '
              f'of {LSE_BURST}) {row["burst_ms"]:.4f} ms a call against '
              f'{row["library_burst_ms"]:.4f} (bound {row["bound_ms"]:.4f})', flush=True)


def check_resize_s2d(rows, x, hw, per_run, prefix=''):
    """K5 on x [B, n, n, C] to hw in s2d layout against its plain version."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_resize import resize_s2d
    from renderformer_tpu_torch.ops.s2d_conv import space_to_depth
    b, n_in, _, c = x.shape
    it = x.element_size()
    with torch.inference_mode():
        out = resize_s2d(x, hw)
        with reference_kernels():
            ref = resize_s2d(x, hw)
        xc = x.permute(0, 3, 1, 2)
        record_row(rows, 'resize_s2d', f'{prefix}{n_in}to{hw[0]}_s2d', x.dtype, per_run,
                   out, ref, 0.0, 'the plain resize in fp32 rounded once, then '
                   'space_to_depth: the same ops in the same order, bit for bit',
                   lambda: resize_s2d(x, hw),
                   lambda: space_to_depth(F.interpolate(
                       xc, size=hw, mode='bilinear', align_corners=True
                   ).permute(0, 2, 3, 1)),
                   b * (n_in * n_in + hw[0] * hw[1]) * c * it, 8 * b * hw[0] * hw[1] * c,
                   PEAK_FP32)
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: resize_s2d(x, hw))
        row['library_burst_ms'] = graph_burst_ms(lambda: space_to_depth(F.interpolate(
            xc, size=hw, mode='bilinear', align_corners=True).permute(0, 2, 3, 1)))
        print(f'resize: resize_s2d {row["site"]} {row["dtype"]}: single call {row["ms"]:.4f} ms '
              f'against F.interpolate + space_to_depth {row["library_ms"]:.4f}; device (graph of '
              f'{LSE_BURST}) {row["burst_ms"]:.4f} ms a call against '
              f'{row["library_burst_ms"]:.4f} (bound {row["bound_ms"]:.4f}: '
              f'{row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)


def check_resize_t(rows, g, n_in, s2d, per_run):
    """K4^T on g [1, 2n, 2n, C] to [1, n, n, C] against its plain version,
    with s2d on g in space-to-depth layout (K5's VJP) beside autograd of
    F.interpolate (then space_to_depth) for the same cotangent."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_resize import resize_bilinear_t, resize_s2d_t
    from renderformer_tpu_torch.ops.s2d_conv import space_to_depth
    b, n_out, _, c = g.shape
    hw = (n_in, n_in)
    if s2d:
        g = space_to_depth(g).contiguous()
    fn = (lambda: resize_s2d_t(g, hw)) if s2d else (lambda: resize_bilinear_t(g, hw))
    with torch.no_grad():
        out = fn()
        with reference_kernels():
            ref = fn()
    tol = float(ref.float().abs().max()) * (2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-6)

    def interp(xc):
        y = F.interpolate(xc, size=(n_out, n_out), mode='bilinear', align_corners=True)
        return space_to_depth(y.permute(0, 2, 3, 1)) if s2d else y

    gl = g if s2d else g.permute(0, 3, 1, 2)
    xl = torch.zeros(b, c, n_in, n_in, dtype=g.dtype, device=g.device, requires_grad=True)
    yl = interp(xl)

    def lib_t():
        return torch.autograd.grad(yl, xl, gl, retain_graph=True)

    with torch.no_grad():
        record_row(rows, 'resize_bilinear_t', f'{n_out}to{n_in}' + ('_s2d' if s2d else ''),
                   g.dtype, per_run, out, ref, tol, 'the same nonzero weights in fp32, summed '
                   'in another order and rounded once: 1 bf16 ulp / 1e-6 of max|ref|', fn, lib_t,
                   (n_out * n_out + n_in * n_in) * c * g.element_size(),
                   8 * n_out * n_out * c, PEAK_FP32)
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(fn)
    row['library_burst_ms'] = autograd_graph_ms(interp, [xl], gl)
    print(f'resize: resize_bilinear_t {row["site"]} {row["dtype"]}: single call '
          f'{row["ms"]:.4f} ms against autograd of F.interpolate {row["library_ms"]:.4f}; device '
          f'(graph of {LSE_BURST}) {row["burst_ms"]:.5f} ms a call against '
          f'{row["library_burst_ms"]:.5f} (bound {row["bound_ms"]:.5f}: '
          f'{row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)


def k3_bytes(b, bkv, sk, h, it):
    """K3 reads k at the scene batch and the fp32 tables, writes k at the q batch."""
    return bkv * sk * h * D * it + 2 * b * sk * D * 4 + b * sk * h * D * it


K3_WHY = ('same fp32 arithmetic as the plain version; one ulp of the largest output for '
          'a differently rounded product')


def k3_burst(rows, fn):
    """K3's device time at the last row's site: a CUDA graph of LSE_BURST
    calls, against its bytes bound."""
    row = rows[-1]
    row['burst_ms'] = graph_burst_ms(fn)
    print(f'k3: rot_kv_broadcast {row["site"]} {row["dtype"]}: device (graph of {LSE_BURST}) '
          f'{row["burst_ms"]:.5f} ms a call against its bytes bound {row["bound_ms"]:.5f} '
          f'({row["bound_ms"] / row["burst_ms"]:.3f} of it); single call {row["ms"]:.4f}',
          flush=True)


def k3_tol(ref):
    import torch
    return float(ref.float().abs().max()) * (2.0 ** -7 if ref.dtype == torch.bfloat16
                                             else 2.0 ** -22)


NORM_D = 768  # the model width of v1-base, the width of every K11 site

# the flash forward at its tile edges, bf16 (csrc/flash_fwd_sm90.cu) and fp32
# (csrc/flash_attention.cu, 64-row q tiles, 32-key tiles, keys split across
# a cluster where the grid is small): name, B, Bkv, Sq, Sk, H, masked; a
# masked case with B > 1 zeroes batch row 1's mask.  Sq and Sk are not
# multiples of 32, 64 or 128; the last case is the swin-large
# cross-attention's head count and fan-out at a small length.
FLASH_EDGES = [
    ('edge_129x257_reps2', 2, 1, 129, 257, 2, True),
    ('edge_257x129', 1, 1, 257, 129, 2, False),
    ('edge_129x129_zero_row', 3, 3, 129, 129, 1, True),
    ('edge_257x257_h8_reps8', 8, 1, 257, 257, 8, True),
]
SASS_KERNEL = 'flash_fwd_sm90_kernel'
SASS_F32_KERNEL = 'flash_fwd_f32_kernel'
SASS_BWD_KERNEL = 'flash_bwd_kv_kernel'
SASS_BWD_BF16_KERNEL = 'flash_bwd_sm90_kernel'
SASS_DQ_KERNEL = 'flash_bwd_dq_f32_kernel'
SASS_SWIN_F32_KERNEL = 'swin_fwd_f32_kernel'
SASS_SWIN_BWD_F32_KERNEL = 'swin_bwd_f32_kernel'
SASS_DQ_BF16_KERNEL = 'flash_bwd_dq_sm90_kernel'


def flash_rate(dtype):
    """The flop rate of the flash forward's bound: bf16 tensor cores, or
    split TF32 for fp32."""
    import torch
    return PEAK_BF16_TENSOR if dtype == torch.bfloat16 else SPLIT_TF32


def sass_counts(sass, kernel, ops):
    """{instantiation of ``kernel``: {op: lines of its SASS holding every
    word of op}} from cuobjdump's output."""
    counts, cur = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :', 1)[1].strip()
            cur = name[name.index(kernel) + len(kernel):][:40] if kernel in name else None
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
        elif cur:
            for op in ops:
                counts[cur][op] += all(w in line for w in op.split())
    return counts


def res_usage(lib_path, kernel):
    """{instantiation of ``kernel``: 'REG:.. STACK:.. LOCAL:..'} by cuobjdump
    -res-usage."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([cuobjdump, '-res-usage', lib_path], capture_output=True, text=True,
                         timeout=300)
    usage, cur = {}, None
    for line in res.stdout.splitlines():
        if 'Function ' in line:
            name = line.split('Function ', 1)[1].strip().rstrip(':')
            cur = name[name.index(kernel) + len(kernel):][:40] if kernel in name else None
        elif cur and 'REG:' in line:
            usage[cur] = ' '.join(w for w in line.split() if w.split(':')[0] in
                                  ('REG', 'STACK', 'LOCAL', 'SHARED'))
            cur = None
    return usage


def sass_check(lib_path):
    """Phase 2: HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    of the bf16 flash forward's kernels and of the bf16 flash backward's
    (K8, K9's dK/dV and K9's dQ), and TF32 HMMA (mma.sync on the tensor
    cores) in each of the fp32 flash forward's and in each fp32
    instantiation of the flash backward's dK/dV and dQ kernels, by
    cuobjdump; fails unless every one has them.  Spills (local loads and
    stores) and registers of the backward and the fp32 kernels, and of
    K11's backward, K4/K5 and K4^T, are printed beside them."""
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    res = subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True, text=True,
                         timeout=300)
    if res.returncode:
        fail(f'cuobjdump: {res.stderr.strip()[:500]}')
    # each instantiation must hold the ops of ``need``; local-memory loads
    # and stores (spills) of the fp32 kernels are counted beside them
    for kernel, what, need, seen, only in (
            (SASS_KERNEL, 'bf16 flash forward', ('HGMMA', 'UTMALDG'), (), ''),
            (SASS_BWD_BF16_KERNEL, 'bf16 flash backward', ('HGMMA', 'UTMALDG'), ('LDL', 'STL'),
             ''),
            (SASS_F32_KERNEL, 'fp32 flash forward', ('HMMA TF32',), ('LDL', 'STL'), ''),
            (SASS_BWD_KERNEL, 'fp32 flash backward dK/dV', ('HMMA TF32',), ('LDL', 'STL'),
             'If'),
            (SASS_DQ_KERNEL, 'fp32 flash backward dQ (K9)', ('HMMA TF32',), ('LDL', 'STL'), ''),
            (SASS_SWIN_F32_KERNEL, 'fp32 Swin window attention (K6)', ('HMMA TF32',),
             ('LDL', 'STL'), ''),
            (SASS_SWIN_BWD_F32_KERNEL, 'fp32 Swin window attention backward (K6^T)',
             ('HMMA TF32',), ('LDL', 'STL'), ''),
            (SASS_DQ_BF16_KERNEL, 'bf16 flash backward dQ (K9)', ('HGMMA', 'UTMALDG'),
             ('LDL', 'STL'), ''),
            ('rms_norm_bwd_kernel', 'fused RMSNorm backward (K11)', (), ('LDL', 'STL'), ''),
            ('resize_rows_kernel', 'row-tiled resize (K4, K5)', (), ('LDL', 'STL'), ''),
            ('resize_t_kernel', 'transposed resize (K4^T)', (), ('LDL', 'STL'), '')):
        counts = {k: c for k, c in sass_counts(res.stdout, kernel, need + seen).items()
                  if k.startswith(only)}
        print(f'build: sass of {len(counts)} {what} kernels ({kernel}): '
              + ', '.join(f'{op} {sum(c[op] for c in counts.values())}' for op in need + seen)
              + '; ' + json.dumps(counts), flush=True)
        if seen:
            usage = {k: u for k, u in res_usage(lib_path, kernel).items() if k.startswith(only)}
            print(f'build: resources of the {what} kernels: {json.dumps(usage)}', flush=True)
        if not counts or any(not c[op] for c in counts.values() for op in need):
            fail(f'the {what} kernels lack {need}: {counts}')


def print_plan(kernel, site, b, sq, h, dtype=None, sk=None):
    """The tile plan the flash forward takes at a main-path site: the bf16
    kernel's q rows a block; the fp32 kernel's 64 rows and key split (blocks
    of a cluster that share a q tile's keys)."""
    import torch
    from renderformer_tpu_torch.ops.flash_attention import flash_fwd_rows, flash_fwd_splits
    dtype = dtype or torch.bfloat16
    rows = flash_fwd_rows(dtype, b, sq, h)
    splits = flash_fwd_splits(dtype, b, sq, sk or sq, h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f'plan: {kernel} {site} {str(dtype).split(".")[-1]} B {b} x H {h} x Sq {sq}: {rows} '
          f'q rows a block, keys split {splits} ways, {-(-sq // rows) * h * b * splits} '
          f'blocks on {sms} SMs', flush=True)


def check_flash_edges(rows, randn, tables, with_lse, dtype):
    """K1/K2 (on K rotated by K3) and K10 in ``dtype`` (bf16 or fp32)
    at FLASH_EDGES against their plain versions; the logsumexp of a row
    whose keys are all masked (m = -1e30) is left out of the logsumexp
    comparison, its output (uniform over the keys) is not."""
    import torch
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        fan_out, flash_fwd, flash_fwd_rope, rot_kv_broadcast)
    it = 2 if dtype == torch.bfloat16 else 4
    for name, b, bkv, sq, sk, h, masked in FLASH_EDGES:
        q = randn(b, sq, h, D, dtype=dtype)
        k, v = randn(bkv, sk, h, D, dtype=dtype), randn(bkv, sk, h, D, dtype=dtype)
        cq, sq_t = tables(b, sq)
        ck, sk_t = tables(b, sk)
        mask, keep = None, list(range(b))
        if masked:
            mask = randn(b, sk) > -0.5
            mask[:, 0] = True
            if b > 1:
                mask[1] = False
                keep.remove(1)
        kb, vb = fan_out(k, b).contiguous(), fan_out(v, b).contiguous()
        with torch.no_grad():
            k_rot = rot_kv_broadcast(k, ck, sk_t)
            for kname, fn in (
                    ('flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask',
                     lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_t, with_lse=with_lse)),
                    ('flash_fwd_mask' if masked else 'flash_fwd_nomask',
                     lambda: flash_fwd(q, kb, vb, mask, with_lse=with_lse))):
                out = fn()
                with reference_kernels():
                    ref = fn()
                tol, why = attention_tol(ref[0] if with_lse else ref, dtype,
                                         'P at the running max vs the row max')
                if with_lse:
                    out, ref = (out[0], out[1][keep]), (ref[0], ref[1][keep])
                    tol = (tol, 1e-5 * float(ref[1].abs().max()) + 2e-5)
                    why += '; lse m*ln2 + ln(l) in fp32: 1e-5 of max|lse| + 2e-5'
                record_row(rows, kname, name + ('_lse' if with_lse else ''), dtype, {}, out, ref,
                           tol, why, fn, None,
                           (2 * b * sq + 2 * b * sk) * h * D * it + (b * sk if masked else 0),
                           4 * b * h * sq * sk * D, flash_rate(dtype))
        del q, k, v, kb, vb, k_rot, out, ref


def check_flash_fwd(rows, randn, site, b, sq, sk, masked, dtype, per_run, with_lse=False):
    """K10 at q [b, sq, 6, D] against k, v [b, sk, 6, D] (a padded tail of
    triangles masked) against its plain version; SDPA with the boolean key
    mask, or none, is the library yardstick."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import flash_fwd
    H = 6
    it = 2 if dtype == torch.bfloat16 else 4
    q = randn(b, sq, H, D, dtype=dtype)
    k, v = randn(b, sk, H, D, dtype=dtype), randn(b, sk, H, D, dtype=dtype)
    mask = None
    if masked:
        mask = torch.ones(b, sk, dtype=torch.bool, device=q.device)
        mask[:, 16 + NTRI * 3 // 4:] = False
    with torch.no_grad():
        out = flash_fwd(q, k, v, mask, with_lse=with_lse)
        with reference_kernels():
            ref = flash_fwd(q, k, v, mask, with_lse=with_lse)
        ref_out = ref[0] if with_lse else ref
        tol, why = attention_tol(ref_out, dtype, 'P at the running max vs the row max')
        if with_lse:
            tol = (tol, 1e-5 * float(ref[1].abs().max()) + 2e-5)
            why += '; lse m*ln2 + ln(l) in fp32: 1e-5 of max|lse| + 2e-5'
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = mask[:, None, None, :] if masked else None
        record_row(rows, 'flash_fwd_mask' if masked else 'flash_fwd_nomask',
                   site + ('_lse' if with_lse else ''), dtype, per_run, out, ref, tol, why,
                   lambda: flash_fwd(q, k, v, mask, with_lse=with_lse),
                   lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                   (2 * b * sq + 2 * b * sk) * H * D * it + (b * sk if masked else 0)
                   + (b * H * sq * 4 if with_lse else 0),
                   4 * b * H * sq * sk * D, flash_rate(dtype))
    del q, k, v, out, ref, qs, ks, vs
    torch.cuda.empty_cache()


def ulp_tol(ref):
    """One bf16 ulp of max|ref| (2^-7 of its binade); fp32: 2^-20 of max|ref|."""
    import torch
    amax = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(amax)) - 7)
    return amax * 2.0 ** -20


def check_rms_norm(rows, randn, site, r, dtype, eps, per_fwd, per_bwd):
    """K11's forward and backward at x [r, 768] against their plain versions;
    torch.nn.functional.rms_norm and its autograd are the library
    yardsticks."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.fused_norm import rms_norm_bwd, rms_norm_fwd
    it = 2 if dtype == torch.bfloat16 else 4
    x, g = randn(r, NORM_D, dtype=dtype), randn(r, NORM_D, dtype=dtype)
    scale = 1 + 0.1 * randn(NORM_D)
    why = ('the same arithmetic, inv from a sum of squares in another order, which can '
           'round bf16(inv) to its other neighbour: 1 bf16 ulp of max|ref|, fp32 2^-20 of it')
    ws = scale.to(dtype)  # the paths hand K11 the scale in x's dtype
    with torch.no_grad():
        y = rms_norm_fwd(x, ws, eps)
        with reference_kernels():
            ref = rms_norm_fwd(x, ws, eps)
        record_row(rows, 'rms_norm_fwd', site, dtype, per_fwd, y, ref, ulp_tol(ref), why,
                   lambda: rms_norm_fwd(x, ws, eps),
                   lambda: F.rms_norm(x, (NORM_D,), ws, eps),
                   2 * r * NORM_D * it + NORM_D * ws.element_size(), 4 * r * NORM_D,
                   PEAK_FP32)
        # host and device apart: the single call above holds the host's work
        # where the card waits for it; a graph of LSE_BURST calls does not
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: rms_norm_fwd(x, ws, eps))
        row['library_burst_ms'] = graph_burst_ms(lambda: F.rms_norm(x, (NORM_D,), ws, eps))
        print(f'norm: rms_norm_fwd {site} {row["dtype"]} scale {row["dtype"]}: single call '
              f'{row["ms"]:.4f} ms against F.rms_norm {row["library_ms"]:.4f}; device (graph of '
              f'{LSE_BURST}) {row["burst_ms"]:.4f} ms a call against {row["library_burst_ms"]:.4f}'
              f' (bound {row["bound_ms"]:.4f})', flush=True)
        # checked with the scale's fp32 cast, whose ds is an fp32 sum, against
        # the plain version's; the path's call writes ds in the scale's dtype:
        # that sum rounded once, the same bits in every call and in every
        # replay of a CUDA graph
        got = rms_norm_bwd(x, ws.float(), g, eps)
        with reference_kernels():
            ref = rms_norm_bwd(x, ws.float(), g, eps)
        calls = [rms_norm_bwd(x, ws, g, eps) for _ in range(2)]
        calls += graph_replays(lambda: rms_norm_bwd(x, ws, g, eps), 3)
        for dxc, dsc in calls:
            if not (dsc.dtype == ws.dtype and torch.equal(dsc, got[1].to(ws.dtype))
                    and torch.equal(dxc, got[0])):
                fail(f'rms_norm_bwd {site}: a call or graph replay differs from the checked '
                     'call, or ds is not its fp32 sum rounded to the scale\'s dtype')
    xl, wl = x.detach().clone().requires_grad_(True), ws.detach().clone().requires_grad_(True)
    yl = F.rms_norm(xl, (NORM_D,), wl, eps)
    with torch.no_grad():
        record_row(rows, 'rms_norm_bwd', site, dtype, per_bwd, got, ref,
                   (ulp_tol(ref[0]), 1e-5 * float(ref[1].abs().max())),
                   why + '; ds: sums over warps, blocks and clusters against one sum over the '
                   'rows, 1e-5 of max|ds|',
                   lambda: rms_norm_bwd(x, ws, g, eps),
                   lambda: torch.autograd.grad(yl, (xl, wl), g, retain_graph=True),
                   3 * r * NORM_D * it + 2 * NORM_D * ws.element_size(), 10 * r * NORM_D,
                   PEAK_FP32)
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(lambda: rms_norm_bwd(x, ws, g, eps))
    row['library_burst_ms'] = autograd_graph_ms(
        lambda a, w: F.rms_norm(a, (NORM_D,), w, eps), (x, ws), g)
    print(f'norm: rms_norm_bwd {site} {row["dtype"]} scale {row["dtype"]}: single call '
          f'{row["ms"]:.4f} ms against autograd of F.rms_norm {row["library_ms"]:.4f}; device '
          f'(graph of {LSE_BURST}) {row["burst_ms"]:.5f} ms a call against '
          f'{row["library_burst_ms"]:.5f} (bound {row["bound_ms"]:.5f}: '
          f'{row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)
    del x, g, y, ref, got, xl, wl, yl
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks():
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_fwd_rope, rot_kv_broadcast, rot_kv_broadcast_plain)
    from renderformer_tpu_torch.ops.shifted_regroup import regroup_index, shifted_regroup
    from renderformer_tpu_torch.ops.swin_attention import (
        region_table, swin_window_attention)
    from renderformer_tpu_torch.nn.swin import swin_attn_mask

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def tables(b, s):
        pos = randn(b, s, 9) * 0.3
        c, sn = make_cos_sin(pos, rope_dim=12, head_dim=D)
        return c[:, :, 0].contiguous(), sn[:, :, 0].contiguous()

    bf, f32 = torch.bfloat16, torch.float32

    def record(kernel, site, dtype, launches, *args):
        # launches: {dtype: {path: launches per render}}; a row in a dtype no
        # path runs there is checked and timed, launched by no path
        record_row(rows, kernel, site, dtype, launches.get(dtype, {}), *args)

    # name, B, Bkv, Sq, Sk, H, keys kept by the mask (None: no mask; a tuple:
    # a batch row's each), launches per render by dtype: the bf16 renders at
    # 8 views, precision_study's swin-large renders of one cbox view, each
    # stage in its precision's dtype, and phase 13's renders: infer's one
    # view of an unpadded scene, batch_infer's batches of 8 scenes of one
    # view (its ray self-attention the 8-view render's shape)
    prec_stage1 = {bf: {PREC_F32V: 12, PREC_BF16: 12}, f32: {PREC_F32: 12}}
    prec_view = {bf: {PREC_BF16: 12}, f32: {PREC_F32: 12, PREC_F32V: 12}}
    flash_sites = [
        ('stage1_self', 1, 1, SK, SK, 6, MASK_VALID, {bf: {BASE: 12}}),
        ('cross', V, 1, ST, SK, 6, MASK_VALID, {bf: {BASE: 6}}),
        ('ray_self', V, V, ST, ST, 6, None, {bf: {BASE: 6, FT_BATCH: 6}}),
        ('stage1_self_h8', 1, 1, SK, SK, 8, MASK_VALID, {bf: {SWIN: 12}}),
        ('cross_h8', V, 1, ST, SK, 8, MASK_VALID, {bf: {SWIN: 12}}),
        ('precision_stage1_self_h8', 1, 1, TOOL_SK, TOOL_SK, 8, 16 + CBOX_TRIS, prec_stage1),
        ('precision_cross_h8', 1, 1, ST, TOOL_SK, 8, 16 + CBOX_TRIS, prec_view),
        ('ft128_infer_stage1_self', 1, 1, FT_INFER_SK, FT_INFER_SK, 6, FT_INFER_SK,
         {bf: {FT_INFER: 12}}),
        ('ft128_infer_cross', 1, 1, ST, FT_INFER_SK, 6, FT_INFER_SK, {bf: {FT_INFER: 6}}),
        ('ft128_infer_ray_self', 1, 1, ST, ST, 6, None, {bf: {FT_INFER: 6}}),
        ('ft128_batch_stage1_self', V, V, FT_SK, FT_SK, 6, FT_BATCH_KEPT, {bf: {FT_BATCH: 12}}),
        ('ft128_batch_cross', V, V, ST, FT_SK, 6, FT_BATCH_KEPT, {bf: {FT_BATCH: 6}}),
    ]
    # views, site prefix, launches of K4 and K5, and of K6 and K7 (a kind
    # each: unshifted / shifted, forward / inverse), per render by dtype
    # (K4 and K5 at one view: precision_study's and infer's renders)
    one_view = {k: {p: 1 for p in v} for k, v in prec_view.items()}
    one_view[bf][FT_INFER] = 1
    view_stages = [
        (V, '', {bf: {BASE: 1, SWIN: 1, NERF: 1, FT_BATCH: 1}}, {bf: {SWIN: 6}}),
        (1, 'precision_', one_view, {k: {p: 6 for p in v} for k, v in prec_view.items()}),
    ]
    for dtype in (bf, f32):
        it = 2 if dtype == bf else 4
        for site, b, bkv, sq, sk, H, valid, n in flash_sites:
            masked = valid is not None
            print_plan('flash_fwd_rope', site, b, sq, H, dtype, sk)
            q = randn(b, sq, H, D, dtype=dtype)
            k = randn(bkv, sk, H, D, dtype=dtype)
            v = randn(bkv, sk, H, D, dtype=dtype)
            cq, sq_t = tables(b, sq)
            ck, sk_t = (cq, sq_t) if sq == sk and b == bkv else tables(b, sk)
            mask = None
            if masked:   # a padded tail of triangles
                kept = torch.tensor(valid, device=dev).reshape(-1, 1)
                mask = (torch.arange(sk, device=dev) < kept).expand(b, sk).contiguous()
            with torch.inference_mode():
                # K3 at this site
                out = rot_kv_broadcast(k, ck, sk_t)
                ref = rot_kv_broadcast_plain(k, ck, sk_t)
                record('rot_kv_broadcast', site, dtype, n, out, ref, k3_tol(ref), K3_WHY,
                       lambda: rot_kv_broadcast(k, ck, sk_t), None,
                       k3_bytes(b, bkv, sk, H, it), 3 * b * sk * H * D, PEAK_FP32)
                k3_burst(rows, lambda: rot_kv_broadcast(k, ck, sk_t))
                k_rot = out
                # K1 / K2 at this site
                kname = 'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask'
                out = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t)
                with reference_kernels():
                    ref = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t)
                tol, why = attention_tol(
                    ref, dtype, 'P at the running max (online softmax) vs the row max')
                # library yardstick: SDPA on the rotated q, [B, H, S, D] layout
                qr = rot_kv_broadcast_plain(q, cq, sq_t)
                qs = qr.transpose(1, 2).contiguous()
                ks = k_rot.transpose(1, 2).contiguous()
                vs = v.repeat_interleave(b // bkv, dim=0).transpose(1, 2).contiguous()
                am = mask[:, None, None, :] if mask is not None else None
                record(kname, site, dtype, n, out, ref, tol, why,
                       lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_t),
                       lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                       (b * sq * H * D * 2 + b * sk * H * D + bkv * sk * H * D) * it
                       + (b * sk if masked else 0) + 2 * b * sq * D * 4,
                       4 * b * H * sq * sk * D, flash_rate(dtype))
            del q, k, v, k_rot, out, ref, qr, qs, ks, vs
            torch.cuda.empty_cache()

        for nv, prefix, head, swin in view_stages:
            # K4: refinenet4/3/2 upsamples of both DPT heads; K5: refinenet1's
            # upsample into s2d layout, the composed tail's input
            for n_in in (32, 64, 128):
                check_resize(rows, randn(nv, n_in, n_in, DPT_C, dtype=dtype),
                             (2 * n_in, 2 * n_in), head.get(dtype, {}), prefix)
            check_resize_s2d(rows, randn(nv, RES // 2, RES // 2, DPT_C, dtype=dtype),
                             (RES, RES), head.get(dtype, {}), prefix)
            torch.cuda.empty_cache()

            # K7 and K6 at the swin-large shapes: [nv, 4096, 1024] window-ordered
            # stream, [nv * 64, 64, 1024] window batches of 8 heads of 128
            x = randn(nv, ST, SWIN_C, dtype=dtype)
            with torch.inference_mode():
                for inverse in (False, True):
                    out = shifted_regroup(x, (GRID, GRID), 8, inverse=inverse)
                    with reference_kernels():
                        ref = shifted_regroup(x, (GRID, GRID), 8, inverse=inverse)
                    # library yardstick: the same permutation as one gather
                    idx = torch.from_numpy(regroup_index(GRID, GRID, 8, inverse)).to(dev)
                    if not torch.equal(x.index_select(1, idx), ref):
                        fail(f'regroup_index inverse={inverse} is not the regroup')
                    record('shifted_regroup', prefix + ('inverse' if inverse else 'forward'),
                           dtype, swin, out, ref, 0.0, 'a permutation: exact',
                           lambda: shifted_regroup(x, (GRID, GRID), 8, inverse=inverse),
                           lambda: x.index_select(1, idx),
                           2 * nv * ST * SWIN_C * it, 0, PEAK_FP32)
            del x, out, ref
            bw = nv * NW
            q, k, v = (randn(bw, 64, SWIN_C, dtype=dtype) for _ in range(3))
            qh, kh, vh = (t.reshape(bw, 64, SWIN_H, D).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            for shift in (0, 4):
                regions = region_table(GRID, GRID, 8, shift, dev) if shift else None
                am = None
                if shift:
                    am = torch.from_numpy(swin_attn_mask(GRID, GRID, 8, shift)).to(dev)
                    am = am.repeat(nv, 1, 1)[:, None]
                with torch.inference_mode():
                    out = swin_window_attention(q, k, v, num_heads=SWIN_H, regions=regions)
                    with reference_kernels():
                        ref = swin_window_attention(q, k, v, num_heads=SWIN_H,
                                                    regions=regions)
                    tol, why = attention_tol(ref, dtype, 'sums of e and P.V in another order')
                    record('swin_window_attention', prefix + ('shifted' if shift else 'unshifted'),
                           dtype, swin, out, ref, tol, why,
                           lambda: swin_window_attention(q, k, v, num_heads=SWIN_H,
                                                         regions=regions),
                           lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am),
                           4 * bw * 64 * SWIN_C * it + (NW * 64 if shift else 0),
                           4 * bw * SWIN_H * 64 * 64 * D, flash_rate(dtype))
                del out, ref
            del q, k, v, qh, kh, vh
            torch.cuda.empty_cache()

    # K10 and K11 at the v1-base nerf render's shapes, in its bf16
    for site, b, sq, sk, masked, n in (('nerf_stage1_self', 1, SK, SK, True, 12),
                                       ('nerf_cross', V, ST, SK, True, 6),
                                       ('nerf_ray_self', V, ST, ST, False, 6)):
        print_plan('flash_fwd', site, b, sq, 6)
        check_flash_fwd(rows, randn, site, b, sq, sk, masked, bf, {NERF: n})
    for dtype in (bf, f32):
        check_flash_edges(rows, randn, tables, False, dtype)
    eps_tiny = float(np.finfo(np.float32).eps)  # torch's RMSNorm default
    for site, r, eps, n in (('embed_2048', NTRI, eps_tiny, 3), ('stage1_2064', SK, 1e-6, 48),
                            ('rays_8x4096', V * ST, 1e-6, 38), ('tris_8x2064', V * SK, 1e-6, 13)):
        check_rms_norm(rows, randn, site, r, bf, eps, {NERF: n}, {})
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the render
# ---------------------------------------------------------------------------

def bench_inputs(n_tris=NTRI, n_views=V):
    """bench.py's workload, made from numpy seed 0."""
    rng = np.random.default_rng(0)
    return (
        rng.normal(size=(1, n_tris, 3, 3)).astype(np.float32) * 0.3,
        rng.uniform(0, 1, (1, n_tris, 13, 32, 32)).astype(np.float32),
        np.ones((1, n_tris), bool),
        rng.normal(size=(1, n_tris, 3, 3)).astype(np.float32),
        np.tile(np.eye(4, dtype=np.float32), (1, n_views, 1, 1)),
        np.full((1, n_views, 1), 40.0, np.float32),
    )


def render_pipeline(path):
    """The seeded pipeline of a render path: the presets as they are, and
    V1_BASE_NERF with the fused RMSNorm."""
    from renderformer_tpu_torch import V1_BASE_NERF, RenderingPipeline, RuntimeConfig
    if path == NERF:
        return RenderingPipeline.from_config(V1_BASE_NERF, seed=0,
                                             runtime=RuntimeConfig(fused_norm=True))
    return RenderingPipeline.from_pretrained(path, seed=0)


def time_render(pipe, dargs):
    """Host seconds of one bf16 render on inputs on the card."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    pipe.render(*dargs, resolution=RES, precision='bf16')
    torch.cuda.synchronize()
    return time.perf_counter() - t


def fused_norm_ab(card, pipe, dargs):
    """Informational, no bar: rays/s of the v1-base render with
    fused_norm=True beside the default on the same model, timed in turn."""
    from renderformer_tpu_torch import RenderingPipeline, RuntimeConfig
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    fused = RenderingPipeline(pipe.model, runtime=RuntimeConfig(fused_norm=True))
    reset_launch_counts()
    time_render(fused, dargs)  # warm-up, and its K11 launches
    n_norm = LAUNCHES['rms_norm_fwd']
    turns = [(time_render(pipe, dargs), time_render(fused, dargs)) for _ in range(5)]
    default, with_k11 = (statistics.median(x) for x in zip(*turns))
    rays = V * RES * RES
    print(f'speed: {BASE} bf16 {RES}^2 fused_norm=True (informational, no bar): '
          f'{rays / with_k11:.1f} rays/s ({with_k11 * 1e3:.2f} ms, {n_norm} K11 launches) '
          f'against the default {rays / default:.1f} rays/s ({default * 1e3:.2f} ms), medians '
          f'of 5 turns {[(round(a * 1e3, 2), round(b * 1e3, 2)) for a, b in turns]} ms, '
          f'on {card}', flush=True)
    del fused


def render_checks(card, preset):
    """Phases 4 and 5 for one model; returns its launch counts and the
    median render time."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels, reset_launch_counts

    t0 = time.time()
    pipe = render_pipeline(preset)
    n_params = sum(p.numel() for p in pipe.model.state_dict().values())
    print(f'render: {preset} seeded init, {n_params} parameters, '
          f'{time.time() - t0:.1f} s', flush=True)
    args = bench_inputs()

    reset_launch_counts()
    img = pipe.render(*args, resolution=RES, precision='bf16')
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f'render: {preset} launches ' + json.dumps(launches), flush=True)
    if launches != EXPECTED_LAUNCHES[preset]:
        fail(f'{preset} launch counts {launches} != {EXPECTED_LAUNCHES[preset]}')
    if tuple(img.shape) != (1, V, RES, RES, 3):
        fail(f'{preset} render shape {tuple(img.shape)}')
    if not bool(torch.isfinite(img).all()):
        fail(f'{preset} render has non-finite values')
    with reference_kernels():
        ref = pipe.render(*args, resolution=RES, precision='bf16')
    p_bf16 = psnr(ref.float().cpu().numpy(), img.float().cpu().numpy())
    print(f'render: {preset} bf16 512^2 kernels vs plain HDR PSNR {p_bf16:.2f} dB '
          f'(need >= 40); mean {float(img.mean()):.6f} std {float(img.std()):.6f}',
          flush=True)
    if not p_bf16 >= 40.0:
        fail(f'{preset} bf16 render PSNR {p_bf16} < 40 dB')

    res32 = 128
    img32 = pipe.render(*args, resolution=res32, precision='fp32')
    with reference_kernels():
        ref32 = pipe.render(*args, resolution=res32, precision='fp32')
    if not bool(torch.isfinite(img32).all()):
        fail(f'{preset} fp32 render has non-finite values')
    p_fp32 = psnr(ref32.cpu().numpy(), img32.cpu().numpy())
    print(f'render: {preset} fp32 {res32}^2 kernels vs plain HDR PSNR {p_fp32:.2f} dB '
          f'(need >= 55)', flush=True)
    if not p_fp32 >= 55.0:
        fail(f'{preset} fp32 render PSNR {p_fp32} < 55 dB')
    del ref, img32, ref32
    torch.cuda.empty_cache()

    # phase 5: speed, on inputs already on the card (as bench.py times it)
    dargs = tuple(torch.as_tensor(a, device='cuda') for a in args)
    rays = V * RES * RES
    times = [time_render(pipe, dargs) for _ in range(6)]
    times = times[1:]  # the first render after the fp32 one is a warm-up
    med = statistics.median(times)
    print(f'speed: {preset} bf16 {RES}^2 x{V} views, {NTRI} tris, inputs on the card: '
          f'{rays / med:.1f} rays/s (median of {len(times)} renders, '
          f'{med * 1e3:.2f} ms; all {[round(x * 1e3, 2) for x in times]} ms) '
          f'on {card}', flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe.render(*dargs, resolution=RES, precision='bf16')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print_profile(preset, kernels)
    # the profiler slows the host, so the idle share is read against the
    # median unprofiled render; the profiled wall time is printed beside it
    print(f'speed: {preset} device time {dev_ms:.2f} ms a render (profiled), device '
          f'idle share {1 - dev_ms / (med * 1e3):.3f} of the {med * 1e3:.2f} ms median '
          f'render ({1 - dev_ms / (wall * 1e3):.3f} of the {wall * 1e3:.2f} ms '
          f'profiled render)', flush=True)
    if preset == BASE:
        fused_norm_ab(card, pipe, dargs)
    del pipe, dargs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def check_dq(row, lib, io, sdpa_io, site, dtype):
    """K9's dQ kernel at a train site, beside its checked row: the tile plan
    (q rows a block, the fp32 key split, blocks on the card's SMs); the
    device time of a call by CUDA graphs of LSE_BURST calls, beside autograd
    of SDPA for dq alone timed the same way and the bound; and determinism:
    two calls and three replays of a CUDA graph of one call give the same
    bits, or the phase fails."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_bwd_dq_rows, flash_bwd_dq_splits, launch_flash_bwd)
    q = io[0]
    b, sq, h, _ = q.shape
    sk = io[1].shape[1]
    dt = str(dtype).split('.')[-1]
    rows = flash_bwd_dq_rows(dtype, b, sq, h)
    splits = flash_bwd_dq_splits(dtype, b, sq, sk, h)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f'plan: flash_bwd_dq {site} {dt} B {b} x H {h} x Sq {sq} x Sk {sk}: {rows} q rows '
          f'a block, keys split {splits} ways, {-(-sq // rows) * h * b * splits} blocks on '
          f'{sms} SMs', flush=True)

    def call():
        return launch_flash_bwd(lib, 'dq', *io)[0]

    qs, ks, vs, am, gl = sdpa_io
    with torch.no_grad():
        row['graph_ms'] = graph_burst_ms(call)
    with torch.enable_grad():  # the caller checks the kernels under no_grad
        row['library_graph_ms'] = autograd_graph_ms(
            lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c, attn_mask=am),
            (qs, ks, vs), gl, wrt=(0,))
    print(f'dq: {site} {dt}: CUDA graphs of {LSE_BURST} {row["graph_ms"]:.4f} ms a call '
          f'against autograd of SDPA for dq alone {row["library_graph_ms"]:.4f} '
          f'({row["graph_ms"] / row["library_graph_ms"]:.3f}x; bound {row["bound_ms"]:.4f}, '
          f'share {row["bound_ms"] / row["graph_ms"]:.3f}), single calls {row["ms"]:.4f} '
          f'against {row["library_ms"]:.4f}', flush=True)
    with torch.no_grad():
        first, second = call(), call()
        replays = graph_replays(lambda: (call(),), 3)
    torch.cuda.synchronize()
    same = [torch.equal(first, second)] + [torch.equal(first, r[0]) for r in replays]
    print(f'dq: {site} {dt}: the same bits in two calls and three graph replays: {same}',
          flush=True)
    if not all(same):
        fail(f'flash_bwd_dq {site} {dt}: dq differs between calls or graph replays ({same})')


def train_kernel_checks():
    """The forward's logsumexp (K1/K2), K3, K8, K9's two kernels, K4, K5 and
    K4^T at the v1-base train step's shapes, in bf16 and fp32, and K10 with
    its logsumexp and K11 at the nerf train step's shapes in the dtypes it
    runs them; per_run counts the launches at the dtype the step runs there
    (bf16 stage 1, fp32 view stage) in one step of each path that launches
    the kernel (K8's shapes are the same in the nerf step)."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_dkv_plain, flash_bwd_dq_plain, flash_bwd_keys, flash_bwd_splits,
        flash_fwd_rope, launch_flash_bwd, launch_flash_fwd_rope, rot_kv_broadcast,
        rot_kv_broadcast_plain)

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    lib = _build.library()
    rows = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def tables(b, s):
        c, sn = make_cos_sin(randn(b, s, 9) * 0.3, rope_dim=12, head_dim=D)
        return c[:, :, 0].contiguous(), sn[:, :, 0].contiguous()

    # name, Sq, Sk, heads, keys kept by the mask (None: no mask), dtype of the
    # step there, sites a step, launches a site by path (of K3, of K1/K2 with
    # the logsumexp, of K8, of K9's kernels), and whether the site is checked
    # in the other dtype too.  With remat K3 runs three times a site (forward,
    # recomputation, backward) and K1/K2 twice; tools/overfit_run's step keeps
    # remat off (K3 twice, K1/K2 once) and shares the ray-self site's shape
    bf, f32 = torch.bfloat16, torch.float32
    remat = dict(k3={TRAIN: 3, TRAIN2: 3}, fwd={TRAIN: 2, TRAIN2: 2},
                 k8={TRAIN: 1, TRAIN_NERF: 1}, k9={TRAIN2: 1})
    overfit = dict(k3={OVERFIT: 2}, fwd={OVERFIT: 1}, k8={OVERFIT: 1}, k9={})
    ft128 = dict(k3={FT128: 3}, fwd={FT128: 2}, k8={FT128: 1}, k9={})
    swin = dict(k3={TRAIN_SWIN: 3}, fwd={TRAIN_SWIN: 2}, k8={TRAIN_SWIN: 1}, k9={})
    swin_st = (SWIN_TRAIN_RES // 8) ** 2
    cbox = 16 + CBOX_TRIS
    sites = [
        ('train_stage1_self', SK, SK, 6, MASK_VALID, bf, 12, remat, True),
        ('train_cross', TRAIN_ST, SK, 6, MASK_VALID, f32, 6, remat, True),
        ('train_ray_self', TRAIN_ST, TRAIN_ST, 6, None, f32, 6,
         {k: {**remat[k], **overfit[k], **ft128[k]} for k in remat}, True),
        ('swin_train_stage1_self', SK, SK, SWIN_H, MASK_VALID, bf, 12, swin, False),
        ('swin_train_cross', swin_st, SK, SWIN_H, MASK_VALID, f32, 12, swin, False),
        ('overfit_stage1_self', TOOL_SK, TOOL_SK, 6, cbox, bf, 12, overfit, False),
        ('overfit_cross', TRAIN_ST, TOOL_SK, 6, cbox, f32, 6, overfit, False),
        ('ft128_stage1_self', FT_SK, FT_SK, 6, 16 + FT_MAX_TRIS, bf, 12, ft128, False),
        ('ft128_cross', TRAIN_ST, FT_SK, 6, 16 + FT_MAX_TRIS, f32, 6, ft128, False),
    ]
    for dtype in (bf, f32):
        it = 2 if dtype == torch.bfloat16 else 4
        for site, sq, sk, H, valid, step_dtype, n, launches, both in sites:
            masked = valid is not None
            if not both and dtype != step_dtype:
                continue
            if dtype == step_dtype:
                print_plan('flash_fwd_rope', site, 1, sq, H, dtype, sk)
                splits = flash_bwd_splits(dtype, 1, sq, sk, H)
                keys = flash_bwd_keys(dtype)
                step = ('64 q rows a step, in halves of 32' if dtype == torch.bfloat16
                        else '16 q rows a step')
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                print(f'plan: flash_bwd {site} {str(dtype).split(".")[-1]} B 1 x H {H} x Sk '
                      f'{sk}: {keys} keys a block, {step}, q steps split {splits} ways, '
                      f'{-(-sk // keys) * H * splits} blocks on {sms} SMs', flush=True)

            def per_step(kind):
                return ({p: m * n for p, m in launches[kind].items()} if dtype == step_dtype
                        else {})
            q, do = randn(1, sq, H, D, dtype=dtype), randn(1, sq, H, D, dtype=dtype)
            k, v = randn(1, sk, H, D, dtype=dtype), randn(1, sk, H, D, dtype=dtype)
            cq, sq_t = tables(1, sq)
            ck, sk_t = (cq, sq_t) if sq == sk else tables(1, sk)
            mask = None
            if masked:
                mask = torch.ones(1, sk, dtype=torch.bool, device=dev)
                mask[:, valid:] = False
            with torch.no_grad():
                # K3
                k_rot = rot_kv_broadcast(k, ck, sk_t)
                ref_rot = rot_kv_broadcast_plain(k, ck, sk_t)
                record_row(rows, 'rot_kv_broadcast', site, dtype, per_step('k3'), k_rot, ref_rot,
                           k3_tol(ref_rot), K3_WHY, lambda: rot_kv_broadcast(k, ck, sk_t), None,
                           k3_bytes(1, 1, sk, H, it), 3 * sk * H * D, PEAK_FP32)
                k3_burst(rows, lambda: rot_kv_broadcast(k, ck, sk_t))
                # K1/K2 with the logsumexp
                kname = 'flash_fwd_rope_mask' if masked else 'flash_fwd_rope_nomask'
                out, lse = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t, with_lse=True)
                with reference_kernels():
                    ref_out, ref_lse = flash_fwd_rope(q, k_rot, v, mask, cq, sq_t,
                                                      with_lse=True)
                tol, why = attention_tol(ref_out, dtype, 'P at the running max vs the row max')
                lse_tol = 1e-5 * float(ref_lse.abs().max()) + 2e-5
                qs, ks = (rot_kv_broadcast_plain(q, cq, sq_t).transpose(1, 2).contiguous(),
                          k_rot.transpose(1, 2).contiguous())
                vs = v.transpose(1, 2).contiguous()
                am = mask[:, None, None, :] if mask is not None else None
                fwd_bytes = (2 * sq + 2 * sk) * H * D * it + (sk if masked else 0) \
                    + 2 * sq * D * 4 + H * sq * 4
                record_row(rows, kname, site + '_lse', dtype, per_step('fwd'), (out, lse),
                           (ref_out, ref_lse), (tol, lse_tol),
                           why + '; lse m*ln2 + ln(l) in fp32: 1e-5 of max|lse| + 2e-5',
                           lambda: flash_fwd_rope(q, k_rot, v, mask, cq, sq_t, with_lse=True),
                           lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am),
                           fwd_bytes, 4 * H * sq * sk * D, flash_rate(dtype))
                # what the logsumexp costs: against the render's instantiation on
                # the same inputs, the two timed in turn three times, each as
                # bursts of LSE_BURST launches into buffers made beforehand, so
                # that neither the host nor an allocation sits between them
                lse_buf = torch.empty_like(lse)

                def burst(buf):
                    return lambda: [launch_flash_fwd_rope(lib, q, k_rot, v, mask, cq, sq_t, buf)
                                    for _ in range(LSE_BURST)]

                pairs = [(time_ms(burst(lse_buf)) / LSE_BURST, time_ms(burst(None)) / LSE_BURST)
                         for _ in range(3)]
                w, wo = (statistics.median(x) for x in zip(*pairs))
                print(f'lse: {kname} {site} {rows[-1]["dtype"]}: {w:.4f} ms a launch with the '
                      f'logsumexp, {wo:.4f} ms without ({w / wo - 1:+.3f}), medians of the '
                      f'turns {[(round(a, 4), round(b, 4)) for a, b in pairs]}', flush=True)
                lse = ref_lse
                delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2).contiguous()
                io = (q, k_rot, v, mask, lse, delta, do)
                with reference_kernels():
                    ref = flash_bwd(*io)
                tols = tuple(attention_tol(r, dtype, '')[0] * 2 for r in ref)
                why = ('q, P and dS round to the dtype in both, dQ sums by atomics (K8) in a '
                       'run-dependent order: 8 bf16 ulps / 2^-15 of max|ref| per output')
            # library yardsticks: autograd through SDPA on the same inputs, for
            # all three gradients (K8), dq alone and (dk, dv) alone (K9's kernels)
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qs, ks, vs))
            yl = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am)
            gl = do.transpose(1, 2).contiguous()

            def lib_grad(*wrt):
                return lambda: torch.autograd.grad(yl, wrt, gl, retain_graph=True)

            b_in = (2 * sq + 2 * sk) * H * D * it + 2 * H * sq * 4 + (sk if masked else 0)
            b_out_kv, b_out_q = 2 * sk * H * D * it, sq * H * D * it
            with torch.no_grad():
                # the wrappers the train step calls are checked; K9's kernels are
                # timed one at a time, each against the plain version of its part
                fused = flash_bwd(*io, 'fused')
                record_row(rows, 'flash_bwd_mask' if masked else 'flash_bwd_nomask', site, dtype,
                           per_step('k8'), fused, ref, tols, why,
                           lambda: flash_bwd(*io, 'fused'), lib_grad(ql, kl, vl),
                           b_in + sq * H * D * it + b_out_kv + b_out_q,
                           10 * H * sq * sk * D, flash_rate(dtype))
            # the device's time: bursts of launches, the kernel's and autograd
            # of SDPA's, beside the single calls
            row = rows[-1]
            with torch.no_grad():
                row['burst_ms'] = burst_ms(lambda: launch_flash_bwd(lib, 'fused', *io))
            row['library_burst_ms'] = burst_ms(lib_grad(ql, kl, vl))
            print(f'bwd: {row["kernel"]} {site} {row["dtype"]}: bursts of {LSE_BURST} '
                  f'{row["burst_ms"]:.4f} ms a launch against autograd of SDPA '
                  f'{row["library_burst_ms"]:.4f} ({row["burst_ms"] / row["library_burst_ms"]:.3f}x;'
                  f' bound {row["bound_ms"]:.4f}), single calls {row["ms"]:.4f} against '
                  f'{row["library_ms"]:.4f}', flush=True)
            with torch.no_grad():
                two = flash_bwd(*io, 'twokernel')
                record_row(rows, 'flash_bwd_dq', site, dtype, per_step('k9'), two[0],
                           ref[0], tols[0], why, lambda: launch_flash_bwd(lib, 'dq', *io),
                           lib_grad(ql), b_in + b_out_q, 6 * H * sq * sk * D,
                           flash_rate(dtype), plain_fn=lambda: flash_bwd_dq_plain(*io))
                check_dq(rows[-1], lib, io, (qs, ks, vs, am, gl), site, dtype)
                record_row(rows, 'flash_bwd_dkv', site, dtype, per_step('k9'), two[1:],
                           ref[1:], tols[1:], why, lambda: launch_flash_bwd(lib, 'dkv', *io),
                           lib_grad(kl, vl), b_in + b_out_kv, 8 * H * sq * sk * D,
                           flash_rate(dtype), plain_fn=lambda: flash_bwd_dkv_plain(*io))
            del q, do, k, v, k_rot, ref_rot, out, lse, ref_out, ref, fused, two, ql, kl, vl, io
            del yl
            torch.cuda.empty_cache()

        # K4 and K5 in the fp32 view stage's DPT head (refinenet4/3/2, refinenet1)
        view_stage = ({p: 1 for p in (TRAIN, TRAIN2, TRAIN_NERF, OVERFIT, FT128)}
                      if dtype == torch.float32 else {})
        for n_in in (16, 32, 64):
            check_resize(rows, randn(1, n_in, n_in, DPT_C, dtype=dtype), (2 * n_in, 2 * n_in),
                         view_stage)
        check_resize_s2d(rows, randn(1, TRAIN_RES // 2, TRAIN_RES // 2, DPT_C, dtype=dtype),
                         (TRAIN_RES, TRAIN_RES), view_stage)

        # K4^T: the VJP of refinenet4/3/2's upsamples (g NHWC) and of
        # refinenet1's K5 (g in s2d layout, as the step runs it; at 256 -> 128
        # also NHWC, off the step's path, to compare), in the fp32 view stage
        for n_in, s2d in ((16, False), (32, False), (64, False), (128, False), (128, True)):
            check_resize_t(rows, randn(1, 2 * n_in, 2 * n_in, DPT_C, dtype=dtype), n_in, s2d,
                           view_stage if s2d or n_in < 128 else {})
        torch.cuda.empty_cache()

    # the nerf train step: K10 with the logsumexp twice a site (the forward and
    # the remat recomputation); K11 forward at each norm, again in the
    # recomputed blocks, and backward once
    for site, sq, sk, masked, dtype, n in (
            ('train_nerf_stage1_self', SK, SK, True, bf, 12),
            ('train_nerf_cross', TRAIN_ST, SK, True, f32, 6),
            ('train_nerf_ray_self', TRAIN_ST, TRAIN_ST, False, f32, 6)):
        print_plan('flash_fwd', site, 1, sq, 6, dtype, sk)
        check_flash_fwd(rows, randn, site, 1, sq, sk, masked, dtype, {TRAIN_NERF: 2 * n},
                        with_lse=True)
    for dtype in (bf, f32):
        check_flash_edges(rows, randn, tables, True, dtype)
    eps_tiny = float(np.finfo(np.float32).eps)
    for site, r, dtype, eps, n_fwd, n_bwd in (
            ('train_embed_2048', NTRI, bf, eps_tiny, 3, 3),
            ('train_stage1_2064', SK, bf, 1e-6, 96, 48),
            ('train_rays_1024', TRAIN_ST, f32, 1e-6, 74, 38),
            ('train_tris_2064', SK, f32, 1e-6, 25, 13)):
        check_rms_norm(rows, randn, site, r, dtype, eps, {TRAIN_NERF: n_fwd},
                       {TRAIN_NERF: n_bwd})
    swin_train_kernel_checks(rows, randn)
    return rows


def check_swin_bwd(rows, randn, site, bw, dtype, shift, per_run):
    """K6^T on [bw, 64, 1024] windows of 8 heads against its plain version;
    two launches give the same bits, or the phase fails; timed by single
    calls and by CUDA graphs of LSE_BURST calls, beside autograd of SDPA
    with the boolean window mask timed the same way."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.nn.swin import swin_attn_mask
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.swin_attention import region_table, swin_window_attention_bwd
    dev = torch.device('cuda')
    it = 2 if dtype == torch.bfloat16 else 4
    q, k, v, do = (randn(bw, 64, SWIN_C, dtype=dtype) for _ in range(4))
    regions = region_table(GRID, GRID, 8, shift, dev) if shift else None

    def fn():
        return swin_window_attention_bwd(q, k, v, do, num_heads=SWIN_H, regions=regions)

    with torch.no_grad():
        out, again = fn(), fn()
        with reference_kernels():
            ref = fn()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(out, again)]
    name = 'shifted' if shift else 'unshifted'
    dt = str(dtype).split('.')[-1]
    print(f'swin_bwd: {site}_{name} {dt}: the same bits in two launches (dq, dk, dv): {same}',
          flush=True)
    if not all(same):
        fail(f'swin_window_attention_bwd {site}_{name} {dt}: two launches differ ({same})')
    if dtype == torch.bfloat16:
        tols = tuple(8 * 2.0 ** -8 * float(r.float().abs().max()) for r in ref)
        why = ('P and dS round to bf16 in both; a sum in another order can round dS to its '
               'neighbour: 8 bf16 ulps of max|ref| per output, as K8\'s')
    else:
        tols = tuple(2.0 ** -16 * float(r.float().abs().max()) for r in ref)
        why = 'fp32 sums in another order: 2^-16 of max|ref| per output, as K6\'s'
    am = None
    if shift:
        am = torch.from_numpy(swin_attn_mask(GRID, GRID, 8, shift)).to(dev)
        am = am.repeat(bw // NW, 1, 1)[:, None]
    qh, kh, vh, gh = (t.reshape(bw, 64, SWIN_H, D).transpose(1, 2).contiguous()
                      for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
    yl = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am)
    with torch.no_grad():
        # the bytes: q, k, v and dO read, dq, dk and dv written, and the
        # region table; five 64x64x128 products a (window, head)
        record_row(rows, 'swin_window_attention_bwd', f'{site}_{name}', dtype, per_run, out, ref,
                   tols, why, fn,
                   lambda: torch.autograd.grad(yl, (ql, kl, vl), gh, retain_graph=True),
                   7 * bw * 64 * SWIN_C * it + (NW * 64 if shift else 0),
                   5 * 2 * bw * SWIN_H * 64 * 64 * D, flash_rate(dtype))
        row = rows[-1]
        row['burst_ms'] = graph_burst_ms(fn)
    row['library_burst_ms'] = autograd_graph_ms(
        lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=am), (qh, kh, vh), gh)
    print(f'swin_bwd: {row["site"]} {dt}: single call {row["ms"]:.4f} ms against autograd of '
          f'SDPA {row["library_ms"]:.4f}; device (graph of {LSE_BURST}) {row["burst_ms"]:.5f} ms '
          f'a call against {row["library_burst_ms"]:.5f} (bound {row["bound_ms"]:.5f} by '
          f'{row["bound_by"]}: {row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)
    del q, k, v, do, out, again, ref, qh, kh, vh, gh, ql, kl, vl, yl
    torch.cuda.empty_cache()


def swin_train_kernel_checks(rows, randn):
    """The swin-large train step's Swin and DPT kernels at its shapes, fp32
    (the view stage): K4, K5 and K4^T at 512^2; K7 on the [1, 4096, 1024]
    stream, and its VJP against the plain inverse regroup, bit for bit; K6
    on its 64 windows; K6^T there, and in bf16 at the 8-view render's 512
    windows (view_precision='bfloat16')."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch.nn.swin import swin_attn_mask
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.shifted_regroup import regroup_index, shifted_regroup
    from renderformer_tpu_torch.ops.swin_attention import region_table, swin_window_attention
    dev = torch.device('cuda')
    f32 = torch.float32
    on_step = {TRAIN_SWIN: 1}
    for n_in in (32, 64, 128):
        check_resize(rows, randn(1, n_in, n_in, DPT_C), (2 * n_in, 2 * n_in), on_step)
    check_resize_s2d(rows, randn(1, SWIN_TRAIN_RES // 2, SWIN_TRAIN_RES // 2, DPT_C),
                     (SWIN_TRAIN_RES, SWIN_TRAIN_RES), on_step)
    for n_in, s2d in ((32, False), (64, False), (128, False), (256, True)):
        check_resize_t(rows, randn(1, 2 * n_in, 2 * n_in, DPT_C), n_in, s2d, on_step)
    torch.cuda.empty_cache()

    # K7: 6 shifted layers a step, each direction 3 times (forward, remat
    # recomputation, and as the VJP of the other direction)
    x = randn(1, ST, SWIN_C)
    g = randn(1, ST, SWIN_C)
    for inverse in (False, True):
        with torch.no_grad():
            out = shifted_regroup(x, (GRID, GRID), 8, inverse=inverse)
            with reference_kernels():
                ref = shifted_regroup(x, (GRID, GRID), 8, inverse=inverse)
            idx = torch.from_numpy(regroup_index(GRID, GRID, 8, inverse)).to(dev)
            record_row(rows, 'shifted_regroup', 'swin_train_' + ('inverse' if inverse
                                                                  else 'forward'),
                       f32, {TRAIN_SWIN: 18}, out, ref, 0.0, 'a permutation: exact',
                       lambda: shifted_regroup(x, (GRID, GRID), 8, inverse=inverse),
                       lambda: x.index_select(1, idx), 2 * ST * SWIN_C * 4, 0, PEAK_FP32)
        xl = x.detach().clone().requires_grad_(True)
        gx, = torch.autograd.grad(shifted_regroup(xl, (GRID, GRID), 8, inverse=inverse), xl, g)
        with torch.no_grad(), reference_kernels():
            want = shifted_regroup(g, (GRID, GRID), 8, inverse=not inverse)
        same = torch.equal(gx, want)
        print(f'regroup: VJP of the {"inverse" if inverse else "forward"} regroup at the '
              f'swin train step\'s [1, {ST}, {SWIN_C}] fp32 is the plain '
              f'{"forward" if inverse else "inverse"} regroup bit for bit: {same}', flush=True)
        if not same:
            fail(f'shifted_regroup VJP inverse={inverse} differs from the inverse regroup')
    del x, g, out, ref, xl, gx, want

    # K6 on the step's 64 windows, fp32: 6 layers a shift, twice each (the
    # forward and the remat recomputation); also timed by CUDA graphs of
    # LSE_BURST calls, beside SDPA timed the same way
    q, k, v = (randn(NW, 64, SWIN_C) for _ in range(3))
    qh, kh, vh = (t.reshape(NW, 64, SWIN_H, D).transpose(1, 2).contiguous() for t in (q, k, v))
    for shift in (0, 4):
        regions = region_table(GRID, GRID, 8, shift, dev) if shift else None
        am = (torch.from_numpy(swin_attn_mask(GRID, GRID, 8, shift)).to(dev)[:, None]
              if shift else None)

        def fn():
            return swin_window_attention(q, k, v, num_heads=SWIN_H, regions=regions)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)

        with torch.no_grad():
            out = fn()
            with reference_kernels():
                ref = fn()
            tol, why = attention_tol(ref, f32, 'sums of e and P.V in another order')
            record_row(rows, 'swin_window_attention',
                       'swin_train_' + ('shifted' if shift else 'unshifted'), f32,
                       {TRAIN_SWIN: 12}, out, ref, tol, why, fn, sdpa,
                       4 * NW * 64 * SWIN_C * 4 + (NW * 64 if shift else 0),
                       4 * NW * SWIN_H * 64 * 64 * D, SPLIT_TF32)
            row = rows[-1]
            row['burst_ms'] = graph_burst_ms(fn)
            row['library_burst_ms'] = graph_burst_ms(sdpa)
        print(f'swin: {row["site"]} fp32: single call {row["ms"]:.4f} ms against SDPA '
              f'{row["library_ms"]:.4f}; device (graph of {LSE_BURST}) {row["burst_ms"]:.5f} ms '
              f'a call against {row["library_burst_ms"]:.5f} (bound {row["bound_ms"]:.5f} by '
              f'{row["bound_by"]}: {row["bound_ms"] / row["burst_ms"]:.3f} of it)', flush=True)
    del q, k, v, qh, kh, vh, out, ref
    torch.cuda.empty_cache()

    # K6^T: once a layer, 6 layers a shift, fp32 at the step's 64 windows;
    # bf16 at the 8-view render's 512 windows, launched by no path here
    for shift in (0, 4):
        check_swin_bwd(rows, randn, 'swin_train', NW, f32, shift, {TRAIN_SWIN: 6})
    for shift in (0, 4):
        check_swin_bwd(rows, randn, 'swin_8views', V * NW, torch.bfloat16, shift, {})


# ---------------------------------------------------------------------------
# phase 7: the train steps
# ---------------------------------------------------------------------------

def train_batch(device, res=TRAIN_RES):
    """tools/train_step_bench.py's batch at res^2, made from numpy seed 0."""
    import torch
    rng = np.random.default_rng(0)
    b = {'triangles': rng.normal(size=(1, NTRI, 3, 3)).astype(np.float32) * 0.3,
         'texture': rng.uniform(0, 1, (1, NTRI, 13, 32, 32)).astype(np.float32),
         'mask': np.ones((1, NTRI), bool),
         'vn': rng.normal(size=(1, NTRI, 3, 3)).astype(np.float32),
         'c2w': np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1)),
         'fov': np.full((1, 1, 1), 40.0, np.float32),
         'gt': rng.uniform(0, 1, (1, 1, res, res, 3)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


# bars of a train step against another: relative loss and grad-norm
# differences, the cosine of the flattened gradients, and the largest relative
# difference of one parameter's gradient; about 4x to 60x the kernel step's
# readings (PERF.md section 2).  The planted fault passes the first three and
# only the last catches it.
AGREE_BARS = dict(loss_rel=1e-4, grad_norm_rel=1e-3, one_minus_cosine=1e-5,
                  worst_param_rel=5e-2)


def grad_agreement(name, a, b, names):
    """The agreement measures of two (loss, grads) results, grads in the
    order of ``names``; printed, with the bars."""
    import torch
    (la, ga), (lb, gb) = a, b
    la, lb = float(la), float(lb)

    def dot(xs, ys):
        return sum(float(torch.sum(x.double() * y.double())) for x, y in zip(xs, ys))

    na, nb = dot(ga, ga) ** 0.5, dot(gb, gb) ** 0.5
    diff = torch.stack(torch._foreach_norm(torch._foreach_sub(ga, gb))).tolist()
    ref = torch.stack(torch._foreach_norm(gb)).tolist()
    rel = [(d / r if r else (0.0 if d == 0 else float('inf')), n)
           for d, r, n in zip(diff, ref, names)]
    worst = sorted(rel, reverse=True)[:3]
    m = dict(loss_rel=abs(la - lb) / abs(lb), grad_norm_rel=abs(na - nb) / nb,
             one_minus_cosine=1 - dot(ga, gb) / (na * nb), worst_param_rel=worst[0][0])
    print(f'train: {name}: loss {la:.7f} vs {lb:.7f}, grad norm {na:.6f} vs {nb:.6f}; '
          + ', '.join(f'{k} {v:.3e} (bar {AGREE_BARS[k]})' for k, v in m.items())
          + f'; worst parameters {[(n, f"{r:.3e}") for r, n in worst]}', flush=True)
    return m


def within_bars(m):
    return all(m[k] <= bar for k, bar in AGREE_BARS.items())


@contextlib.contextmanager
def planted_fault():
    """A wrong backward, the control of the agreement bars: dK keeps a factor
    log2(e) (its 1/log2(e) left out) at the unmasked sites, the view stage's
    ray self-attentions."""
    from renderformer_tpu_torch.ops import flash_attention as fa
    real = fa.flash_bwd

    def faulty(q_rot, k_rot, v, mask, lse, delta, do, variant='fused'):
        dq, dk, dv = real(q_rot, k_rot, v, mask, lse, delta, do, variant)
        return dq, (dk if mask is not None else dk * fa.LOG2E), dv

    fa.flash_bwd = faulty
    try:
        yield
    finally:
        fa.flash_bwd = real


def seeded_train_state(cfg, tc):
    """A model of ``cfg`` from the seeded init on the card, its optimizer and
    its train state."""
    import torch
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.nn.core import init_weights
    from renderformer_tpu_torch.training import state as ts
    with torch.device('meta'):
        model = RenderFormer(cfg)
    model = model.to_empty(device='cpu')
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to('cuda')
    tx = ts.make_optimizer(tc)
    return model, tx, ts.TrainState.create(model, tx, tc)


def step_launches(path, step, state, batch):
    """One step of a train path on the main path, counts set to 0 just before
    it and read just after, against EXPECTED_LAUNCHES."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    reset_launch_counts()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f'train: {path} launches ' + json.dumps(launches), flush=True)
    if launches != EXPECTED_LAUNCHES[path]:
        fail(f'{path} launch counts {launches} != {EXPECTED_LAUNCHES[path]}')
    return state, m, launches


def check_finite(name, losses):
    print(f'train: {name} 3 steps, loss / grad norm '
          f'{[(x["loss"], x["grad_norm"]) for x in losses]}', flush=True)
    if not all(np.isfinite(x['loss']) and np.isfinite(x['grad_norm']) for x in losses):
        fail(f'train: {name} non-finite loss or grad norm')


def step_speed(card, name, step, state, batch, agree, res=TRAIN_RES):
    """The median step of TRAIN_STEPS after a warm-up, trained rays/s (res^2
    a step), peak memory and the device's idle share from one profiled step;
    printed, with the agreement measures, as one 'train' JSON line."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    times = times[1:]
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'train: {name} step {med * 1e3:.2f} ms median of {len(times)} '
          f'({[round(x * 1e3, 2) for x in times]} ms), {res ** 2 / med:.1f} trained '
          f'rays/s at {res}^2, peak memory {peak:.2f} GiB, on {card}', flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print_profile(name, kernels)
    # where the host's time goes: ops by self CPU time
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:15]:
        print(f'profile: {name} host {e.self_cpu_time_total / 1e3:9.3f} ms '
              f'{e.count:5d}x {e.key[:100]}', flush=True)
    print(f'train: {name} device time {dev_ms:.2f} ms a step (profiled), device idle share '
          f'{1 - dev_ms / (med * 1e3):.3f} of the {med * 1e3:.2f} ms median step '
          f'({1 - dev_ms / (wall * 1e3):.3f} of the {wall * 1e3:.2f} ms profiled step)',
          flush=True)
    print('train ' + json.dumps({'path': name, 'step_ms': med * 1e3,
                                 'rays_per_s': res ** 2 / med, 'peak_gib': peak,
                                 'device_ms': dev_ms, 'idle_share': 1 - dev_ms / (med * 1e3),
                                 **agree}), flush=True)


def deterministic_check(name, model, tx, state, batch, tc):
    """Two steps of ``tc`` with deterministic=True (and flash_bwd left to it:
    the two-kernel backward) from the same state and batch: the loss, every
    gradient and every updated parameter the same bits, or the phase fails.
    The state is put back as it was."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.training import state as ts
    tcd = dataclasses.replace(tc, flash_bwd='', deterministic=True)
    grads = ts.make_loss_fns(model, tcd)[1]
    reset_launch_counts()
    (l1, g1), (l2, g2) = grads(state, batch), grads(state, batch)
    torch.cuda.synchronize()
    k8, k9 = LAUNCHES['flash_bwd_mask'] + LAUNCHES['flash_bwd_nomask'], LAUNCHES['flash_bwd_dq']
    same_grads = bool(torch.equal(l1, l2)) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    del g1, g2
    # what a step updates in place: the masters, AdamW's moments, the RoPE
    # base frequencies it decays, and the counters
    params = list(model.parameters())
    moved = params + [t for k in ('mu', 'nu') for t in state.opt_state[k].values()] + list(
        ts.decayed_buffers(model).values())
    snap = [t.detach().clone() for t in moved], state.opt_state['count'], state.step

    def restore():
        with torch.no_grad():
            torch._foreach_copy_(moved, snap[0])
        state.opt_state['count'], state.step = snap[1], snap[2]

    step = ts.make_train_step(model, tx, tcd)[0]
    _, m1 = step(state, batch)
    after = [p.detach().clone() for p in params]
    restore()
    _, m2 = step(state, batch)
    torch.cuda.synchronize()
    same_params = all(torch.equal(a, p) for a, p in zip(after, params))
    restore()
    del after, snap
    torch.cuda.empty_cache()
    print(f'train: {name} deterministic=True: two loss-and-gradient passes ({k8} K8 and {k9} K9 '
          f'dQ launches) give the same bits of the loss ({float(l1):.7f}) and all '
          f'{len(params)} gradients: {same_grads}; two steps from the same state give the '
          f'same loss and grad norm ({m1} vs {m2}) and the same bits of every updated '
          f'parameter: {same_params}', flush=True)
    if k8 or not k9:
        fail(f'{name} deterministic=True ran K8 ({k8} launches) or no K9 ({k9})')
    if not (same_grads and same_params and m1 == m2):
        fail(f'{name} deterministic=True: two runs differ')


def train_checks(card):
    """Phase 7 for v1-base; returns the launch counts of one step of each
    backward."""
    import torch
    from renderformer_tpu_torch.config import PRESETS
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.training import state as ts

    t0 = time.time()
    batch = train_batch('cuda')
    tcs = {v: ts.TrainConfig(precision='bfloat16', resolution=TRAIN_RES, steps_per_epoch=100,
                             remat=True, flash_bwd=v) for v in ('fused', 'twokernel')}
    model, tx, state = seeded_train_state(PRESETS[BASE], tcs['fused'])
    n_params = sum(p.numel() for p in model.parameters())
    print(f'train: v1-base seeded init, {n_params} parameters; dtypes '
          f'{ts.resolve_dtypes(tcs["fused"])}, remat, {TRAIN_RES}^2, 1 view, {NTRI} tris '
          f'({time.time() - t0:.1f} s)', flush=True)

    # the gradient of the kernel step against the plain-version step, and a
    # planted fault that the same bars must catch
    names = [n for n, _ in model.named_parameters()]
    grads_fused = ts.make_loss_fns(model, tcs['fused'])[1]
    with reference_kernels():
        plain = grads_fused(state, batch)
    fused = grads_fused(state, batch)
    two = ts.make_loss_fns(model, tcs['twokernel'])[1](state, batch)
    with planted_fault():
        bad = grads_fused(state, batch)
    agree = {'fused_vs_plain': grad_agreement('fused vs plain', fused, plain, names),
             'twokernel_vs_plain': grad_agreement('two-kernel vs plain', two, plain, names),
             'fused_vs_twokernel': grad_agreement('fused vs two-kernel', fused, two, names)}
    control = grad_agreement('planted fault vs plain', bad, plain, names)
    for k, m in agree.items():
        if not within_bars(m):
            fail(f'train {k}: {m} past the bars {AGREE_BARS}')
    if within_bars(control):
        fail(f'train: the planted fault passes the bars ({control})')
    agree['planted_fault_vs_plain'] = control
    del plain, fused, two, bad
    torch.cuda.empty_cache()

    # one step of each backward on the main path, counts set to 0 just before
    launches, losses = {}, []
    for path, v in ((TRAIN, 'fused'), (TRAIN2, 'twokernel')):
        state, m, launches[path] = step_launches(
            path, ts.make_train_step(model, tx, tcs[v])[0], state, batch)
        losses.append(m)
    step = ts.make_train_step(model, tx, tcs['fused'])[0]
    state, m = step(state, batch)
    losses.append(m)
    check_finite('v1-base', losses)
    step_speed(card, 'v1-base', step, state, batch, agree)
    step2 = ts.make_train_step(model, tx, tcs['twokernel'])[0]
    step_speed(card, 'v1-base twokernel', step2, state, batch, agree)
    deterministic_check('v1-base', model, tx, state, batch, tcs['fused'])
    del state, model, step, step2
    torch.cuda.empty_cache()
    return launches


def train_nerf_checks(card):
    """Phase 7 for v1-base nerf with the fused RMSNorm and the fused
    backward; returns the launch counts of one step."""
    import torch
    from renderformer_tpu_torch import V1_BASE_NERF
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.training import state as ts

    batch = train_batch('cuda')
    tc = ts.TrainConfig(precision='bfloat16', resolution=TRAIN_RES, steps_per_epoch=100,
                        remat=True, flash_bwd='fused', fused_norm=True)
    model, tx, state = seeded_train_state(V1_BASE_NERF, tc)
    print(f'train: v1-base nerf seeded init, {sum(p.numel() for p in model.parameters())} '
          f'parameters, fused_norm, fused backward', flush=True)
    names = [n for n, _ in model.named_parameters()]
    grads = ts.make_loss_fns(model, tc)[1]
    with reference_kernels():
        plain = grads(state, batch)
    agree = {'nerf_vs_plain': grad_agreement('nerf kernels vs plain', grads(state, batch),
                                             plain, names)}
    if not within_bars(agree['nerf_vs_plain']):
        fail(f'train nerf: {agree["nerf_vs_plain"]} past the bars {AGREE_BARS}')
    del plain
    torch.cuda.empty_cache()

    step = ts.make_train_step(model, tx, tc)[0]
    state, m, launches = step_launches(TRAIN_NERF, step, state, batch)
    losses = [m]
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(m)
    check_finite('v1-base nerf', losses)
    step_speed(card, 'v1-base nerf', step, state, batch, agree)
    del state, model, step
    torch.cuda.empty_cache()
    return {TRAIN_NERF: launches}


def train_swin_checks(card):
    """Phase 7 for v1.1-swin-large at 512^2 with the fused backward; returns
    the launch counts of one step."""
    import torch
    from renderformer_tpu_torch.config import PRESETS
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.training import state as ts

    t0 = time.time()
    batch = train_batch('cuda', SWIN_TRAIN_RES)
    tc = ts.TrainConfig(precision='bfloat16', resolution=SWIN_TRAIN_RES, steps_per_epoch=100,
                        remat=True, flash_bwd='fused')
    model, tx, state = seeded_train_state(PRESETS[SWIN], tc)
    print(f'train: v1.1-swin-large seeded init, {sum(p.numel() for p in model.parameters())} '
          f'parameters; dtypes {ts.resolve_dtypes(tc)}, remat, {SWIN_TRAIN_RES}^2, 1 view, '
          f'{NTRI} tris, fused backward ({time.time() - t0:.1f} s)', flush=True)
    names = [n for n, _ in model.named_parameters()]
    grads = ts.make_loss_fns(model, tc)[1]
    with reference_kernels():
        plain = grads(state, batch)
    agree = {'swin_vs_plain': grad_agreement('swin-large kernels vs plain', grads(state, batch),
                                             plain, names)}
    if not within_bars(agree['swin_vs_plain']):
        fail(f'train swin-large: {agree["swin_vs_plain"]} past the bars {AGREE_BARS}')
    del plain
    torch.cuda.empty_cache()

    step = ts.make_train_step(model, tx, tc)[0]
    state, m, launches = step_launches(TRAIN_SWIN, step, state, batch)
    losses = [m]
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(m)
    check_finite('v1.1-swin-large', losses)
    step_speed(card, 'v1.1-swin-large', step, state, batch, agree, SWIN_TRAIN_RES)
    deterministic_check('v1.1-swin-large', model, tx, state, batch, tc)
    del state, model, step
    torch.cuda.empty_cache()
    return {TRAIN_SWIN: launches}


# ---------------------------------------------------------------------------
# phase 8: the user's entry points
# ---------------------------------------------------------------------------

ENTRY_K = 4  # camera chunks of render_many, of V views each
VERIFY_RES = 256  # tools/verify_checkpoint's default resolution


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def held(name, got, ref, bar):
    """got against ref: the same bits where two renders gave the same bits
    (bar 0), else within the max-abs of two renders; fails otherwise."""
    err = max_abs(got, ref)
    same = bool(torch_equal(got, ref))
    print(f'entry: {name}: max-abs {err:.3g} against the seeded render, '
          f'bit for bit {same} (bar: {"bit for bit" if bar == 0 else f"max-abs <= {bar:.3g}"})',
          flush=True)
    if not (same if bar == 0 else err <= bar):
        fail(f'{name} differs from the seeded render: max-abs {err}')


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def entry_cameras():
    """ENTRY_K chunks of V cameras, each shifted along x: c2w [K, 1, V, 4, 4],
    fov [K, 1, V, 1]."""
    c2w = np.tile(np.eye(4, dtype=np.float32), (ENTRY_K, 1, V, 1, 1))
    c2w[..., 0, 3] = np.linspace(-0.3, 0.3, ENTRY_K * V, dtype=np.float32).reshape(
        ENTRY_K, 1, V)
    return c2w, np.full((ENTRY_K, 1, V, 1), 40.0, np.float32)


def entry_point_checks(card, keep):
    """Phase 8 on full-width, full-depth v1-base from the seeded init, bf16,
    the bench.py scene: (a) from_pretrained on an HF directory and on a
    jax_format directory, both written into ``keep`` for phase 12, renders
    what the seeded pipeline renders; (b) render_many over ENTRY_K chunks
    launches ENTRY_K times a render's kernels, each chunk what render gives;
    (c) the infer stage writes the EXR and PNG files, the EXR the render's
    fp32 output; (d) both loops of batch_infer run with --no_output on
    in-memory dicts.  Then the seeded pipeline renders verify_checkpoint's
    random scene at its defaults (fp32, 256^2) into ``keep``/golden.exr,
    phase 12's golden image."""
    import tempfile

    import torch
    from renderformer_tpu_torch import RenderingPipeline, batch_infer, export_params, infer
    from renderformer_tpu_torch.io import safetensors
    from renderformer_tpu_torch.io.image import read_exr, write_exr
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.tools import verify_checkpoint

    t0 = time.time()
    seeded = render_pipeline(BASE)
    args = bench_inputs()
    dargs = tuple(torch.as_tensor(a, device='cuda') for a in args)

    def render(pipe, c2w=dargs[4], fov=dargs[5]):
        return pipe.render(*dargs[:4], c2w, fov, resolution=RES, precision='bf16')

    ref = render(seeded)
    again = render(seeded)
    torch.cuda.synchronize()
    bar = 0.0 if torch_equal(ref, again) else max_abs(ref, again)
    print(f'entry: {BASE} seeded init in {time.time() - t0:.1f} s; two bf16 {RES}^2 renders '
          + ('give the same bits, so every check below is bit for bit' if bar == 0 else
             f'differ by max-abs {bar:.3g}: a kernel on the path sums in an order that varies '
             f'between calls, so the checks below are held to that'), flush=True)

    with tempfile.TemporaryDirectory(prefix='rf_entry_') as tmp:
        # (a) loading
        hf, jx = os.path.join(keep, 'hf'), os.path.join(keep, 'jax_format')
        os.makedirs(hf)
        seeded.config.save_json(os.path.join(hf, 'config.json'))
        safetensors.save_file(seeded.model.state_dict(), os.path.join(hf, 'model.safetensors'))
        export_params(jx, seeded.model, seeded.config)
        want_sd = seeded.model.state_dict()
        for name, path in (('HF directory', hf), ('jax_format directory', jx)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipe = RenderingPipeline.from_pretrained(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            sd = pipe.model.state_dict()
            if sorted(sd) != sorted(want_sd) or not all(torch_equal(sd[k], want_sd[k])
                                                        for k in want_sd):
                fail(f'{name}: the loaded weights differ from the seeded weights')
            mb = os.path.getsize(os.path.join(path, 'model.safetensors')) / 2 ** 20
            print(f'entry: from_pretrained({name}, {mb:.1f} MiB) in {load_s:.3f} s, '
                  f'weights bit for bit, on {card}', flush=True)
            held(f'from_pretrained({name}) render', render(pipe), ref, bar)
            del pipe, sd
        torch.cuda.empty_cache()

        # (b) the video path
        c2w_seq, fov_seq = (torch.as_tensor(a, device='cuda') for a in entry_cameras())
        reset_launch_counts()
        many = seeded.render_many(*dargs[:4], c2w_seq, fov_seq, resolution=RES,
                                  precision='bf16')
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        want = {k: ENTRY_K * n for k, n in EXPECTED_LAUNCHES[BASE].items()}
        print(f'entry: render_many {ENTRY_K} x {V} views launches ' + json.dumps(launches),
              flush=True)
        if launches != want:
            fail(f'render_many launch counts {launches} != {want}')
        if tuple(many.shape) != (ENTRY_K, 1, V, RES, RES, 3):
            fail(f'render_many shape {tuple(many.shape)}')
        for i in range(ENTRY_K):
            held(f'render_many chunk {i} against render of its cameras', many[i],
                 render(seeded, c2w_seq[i], fov_seq[i]), bar)

        def many_s():
            torch.cuda.synchronize()
            t = time.perf_counter()
            seeded.render_many(*dargs[:4], c2w_seq, fov_seq, resolution=RES, precision='bf16')
            torch.cuda.synchronize()
            return time.perf_counter() - t

        def four_s():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(ENTRY_K):
                render(seeded, c2w_seq[i], fov_seq[i])
            torch.cuda.synchronize()
            return time.perf_counter() - t

        turns = [(many_s(), four_s()) for _ in range(5)]
        m, f = (statistics.median(x) for x in zip(*turns))
        rays = ENTRY_K * V * RES * RES
        print(f'speed: {BASE} bf16 {RES}^2 render_many {ENTRY_K} x {V} views (informational, '
              f'no bar): {rays / m:.1f} rays/s ({m * 1e3:.2f} ms) against {ENTRY_K} render '
              f'calls {rays / f:.1f} rays/s ({f * 1e3:.2f} ms), medians of 5 turns '
              f'{[(round(a * 1e3, 2), round(b * 1e3, 2)) for a, b in turns]} ms, on {card}',
              flush=True)
        del many

        # (c) the infer stage
        scene = dict(triangles=args[0][0], texture=args[1][0], mask=args[2][0], vn=args[3][0],
                     c2w=args[4][0], fov=args[5][0, :, 0])
        out_dir = os.path.join(tmp, 'infer')
        t = time.perf_counter()
        rendered = infer.render_scene(seeded, scene, out_dir, 'bench', resolution=RES,
                                      precision='bf16')
        infer_s = time.perf_counter() - t
        files = sorted(os.listdir(out_dir))
        want_files = sorted(f'bench_view_{i}.{e}' for i in range(V) for e in ('exr', 'png'))
        if files != want_files:
            fail(f'infer wrote {files}, not {want_files}')
        exr0 = torch.from_numpy(read_exr(os.path.join(out_dir, 'bench_view_0.exr')).copy())
        if not torch_equal(exr0, torch.from_numpy(rendered[0, 0])):
            fail('infer: view 0 read back from its EXR is not the rendered image')
        held('infer view 0 read back from its EXR', exr0, ref[0, 0].float().cpu(), bar)
        print(f'entry: infer wrote {V} EXR + {V} PNG files in {infer_s:.2f} s', flush=True)

        # (d) batch_infer's loops, --no_output, in-memory dicts
        bargs = batch_infer.build_parser().parse_args(
            ['--h5_folder', tmp, '--no_output', '--resolution', str(RES),
             '--batch_size', str(V), '--frames_per_call', str(ENTRY_K)])
        batch = {k: args[i] for i, k in enumerate(('triangles', 'texture', 'mask', 'vn', 'c2w'))}
        batches = [{**batch, 'fov': args[5][..., 0], 'file_paths': [f'frame_{i}.h5']}
                   for i in range(4)]
        c2w_np, fov_np = entry_cameras()
        chunks = [{'c2w': c2w_np[i % ENTRY_K], 'fov': fov_np[i % ENTRY_K][..., 0],
                   'entries': [(f'frame_{i}.h5', j) for j in range(V)], 'n_valid': V}
                  for i in range(3 * ENTRY_K)]
        for name, run, items in (('per-batch', batch_infer.run_batches, batches),
                                 ('video', batch_infer.run_video, chunks)):
            out = batch_infer.Output(bargs, os.path.join(tmp, 'batch'))
            meter = (run(seeded, items, out, bargs) if name == 'per-batch'
                     else run(seeded, scene, items, out, bargs))
            if out.close():
                fail(f'batch_infer {name} loop kept frames with --no_output')
            batch_infer.report(meter)
            s = meter.summary()
            print(f'speed: batch_infer {name} loop, --no_output, {len(meter._times)} calls of '
                  f'{meter.rays_per_step} rays: {s["rays_per_s_median"]:.1f} rays/s median '
                  f'(informational, no bar) on {card}', flush=True)
    sc = verify_checkpoint.random_scene()
    golden = seeded.render(*(sc[k] for k in ('triangles', 'texture', 'mask', 'vn', 'c2w', 'fov')),
                           resolution=VERIFY_RES, precision='fp32')
    write_exr(os.path.join(keep, 'golden.exr'), golden[0, 0].float().cpu().numpy())
    del seeded, dargs, ref, again, golden
    torch.cuda.empty_cache()
    print(f'entry: phase 8 in {time.time() - t0:.1f} s', flush=True)


# ---------------------------------------------------------------------------
# phase 9: fine-tuning through the training entry point
# ---------------------------------------------------------------------------

FIT_SCENES = 5          # numpy seeds 0-4; 4 train, 1 validation
FIT_GT_RES = 512        # the ground truth's PNGs, downsized by the dataset
FIT_RES = 256
# configs/config.yml as a dict: the card's machine has no PyYAML
FIT_CONFIG = {
    'training': {'num_epochs': 2, 'learning_rate': 5e-6, 'weight_decay': 1e-4,
                 'max_grad_norm': 1.0, 'batch_size': 1},
    'data': {'max_resolution': FIT_RES, 'train_val_split': 0.8},
    'model': {'model_id': 'v1-base'},
    'output': {'save_interval': 1},
    'memory': {'autocast_dtype': 'bfloat16', 'use_gradient_checkpointing': True},
}
# the two view-stage variants rendered at 512^2 x 8 views: the linear head
# (no DPT: no K4, no K5) and the NeRF-encoded 2-D ray map with the DPT head;
# 6 frequencies, the encoder's default for vertex normals, as no released
# model sets vdir_num_freqs
LINEAR, VDIR = 'v1-base linear head', 'v1-base vdir_num_freqs=6'
FIT_RENDERS = {
    LINEAR: (dict(use_dpt_decoder=False),
             _launches(flash_fwd_rope_mask=18, flash_fwd_rope_nomask=6, rot_kv_broadcast=24)),
    VDIR: (dict(vdir_num_freqs=6), EXPECTED_LAUNCHES[BASE]),
}


def fit_scenes():
    """FIT_SCENES scenes of 1,900-2,048 triangles and one view from numpy seeds
    0-4: the first four textured as the scene converter writes them (a
    per-face constant times the patch mask), the last with random patches."""
    from renderformer_tpu_torch.training.dataset import texture_patch_mask
    scenes = []
    for seed in range(FIT_SCENES):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1900, 2049))
        if seed < FIT_SCENES - 1:
            flat = rng.uniform(0, 1, (n, 13)).astype(np.float16).astype(np.float32)
            tex = flat[..., None, None] * texture_patch_mask(32)
        else:
            tex = rng.uniform(0, 1, (n, 13, 32, 32)).astype(np.float32)
        scenes.append({'triangles': rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.3,
                       'texture': tex, 'vn': rng.normal(size=(n, 3, 3)).astype(np.float32),
                       'c2w': np.eye(4, dtype=np.float32)[None],
                       'fov': np.full((1,), 40.0, np.float32),
                       'gt': rng.integers(0, 256, (FIT_GT_RES, FIT_GT_RES, 3), dtype=np.uint8)})
    return scenes


def memory_dataset(scenes, root):
    """The port's dataset on in-memory scenes (``InMemoryDataset``: only the
    H5 read replaced); the ground truth is PNGs in ``root`` that
    io/image.write_png wrote, which the dataset reads and downsizes."""
    from renderformer_tpu_torch.io.image import write_png
    from renderformer_tpu_torch.training.dataset import InMemoryDataset
    for i, sc in enumerate(scenes):
        write_png(os.path.join(root, f'scene_{i}.png'), sc['gt'])
    return InMemoryDataset({f'scene_{i}': sc for i, sc in enumerate(scenes)}, root,
                           max_resolution=FIT_RES)


def fit_trainer(dataset, ckpt, resume=None, **train_kw):
    """train.build on FIT_CONFIG into ``ckpt``; ``train_kw`` set TrainConfig
    fields the YAML schema has no key for (deterministic)."""
    import functools
    from renderformer_tpu_torch import train
    from renderformer_tpu_torch.training.state import TrainConfig
    cfg = {**FIT_CONFIG, 'output': {**FIT_CONFIG['output'], 'checkpoint_dir': ckpt,
                                    'log_dir': os.path.join(ckpt, 'runs')}}
    real = train.TrainConfig
    train.TrainConfig = functools.partial(TrainConfig, **train_kw)
    try:
        return train.build(cfg, resume=resume, dataset=dataset,
                           log=lambda *a: print('fit:', *a, flush=True))
    finally:
        train.TrainConfig = real


def timed_fit(tr):
    """tr.fit() with the first step's launch counts (counts set to 0 just
    before it, read just after), each epoch's seconds, and the items each
    validation counted; returns (launches, epoch seconds, counted)."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    launches, seconds, counted = [], [], []
    step, evaluate, epoch = tr._train_step, tr._eval_step, tr.train_epoch

    def first_counted(state, batch):
        if launches:
            return step(state, batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        out = step(state, batch)
        torch.cuda.synchronize()
        launches.append(dict(LAUNCHES))
        return out

    def eval_counted(state, batch):
        m = evaluate(state, batch)
        counted.append(m['n'])
        return m

    def epoch_timed(e, indices):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = epoch(e, indices)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out

    tr._train_step, tr._eval_step, tr.train_epoch = first_counted, eval_counted, epoch_timed
    tr.fit()
    return launches[0], seconds, counted


def params_of(model):
    return [p.detach().clone() for p in model.parameters()]


def same_bits(a, b):
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def fit_checks(card):
    """Phase 9: v1-base at full width and depth from the seeded init, trained
    through train.build on a dataset of FIT_SCENES in-memory scenes, 2 epochs:
    (1) one step's launches, (2) finite losses and grad norms, a finite
    validation loss that counts the one validation scene once, (3) the
    checkpoints, (4) under deterministic=True a resume from epoch_0 gives the
    bits of the run that was not interrupted, (5) a compact batch's step the
    bits of its full texture's, (6) dropout: a finite step, two steps at one
    (seed, step) the same bits, the kernel step within AGREE_BARS of the
    plain one with the same masks, (7) debug_nans raises on a NaN, the NaN skip leaves the parameters
    as they were, (8) the linear head and the vdir ray map rendered at 512^2
    x 8 views.  Informational: the fit loop's trained rays/s beside the bare
    step's."""
    import tempfile

    import torch
    from renderformer_tpu_torch import V1_BASE, RenderingPipeline
    from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels, reset_launch_counts
    from renderformer_tpu_torch.training import state as ts
    from renderformer_tpu_torch.training.dataset import expand_texture_flat

    t0 = time.time()
    root = tempfile.mkdtemp(prefix='fit_')
    try:
        dataset = memory_dataset(fit_scenes(), root)
        n_train = len(dataset.split(0.8, 42)[0])
        print(f'fit: {len(dataset)} scenes padded to {dataset.padding_length} triangles, '
              f'patches {dataset.texture_patch_size}^2, {n_train} to train ('
              f'{time.time() - t0:.1f} s)', flush=True)

        # (1)-(3): the fit as configs/config.yml gives it, the fused backward
        ckpt = os.path.join(root, 'a')
        tr = fit_trainer(dataset, ckpt)
        launches, seconds, counted = timed_fit(tr)
        print(f'fit: one step launches ' + json.dumps(launches), flush=True)
        if launches != EXPECTED_LAUNCHES[TRAIN]:
            fail(f'fit step launch counts {launches} != {EXPECTED_LAUNCHES[TRAIN]}')
        metrics = [(m['loss'], m['grad_norm']) for m in tr.step_metrics]
        print(f'fit: losses and grad norms {metrics}, train {tr.train_losses}, validation '
              f'{tr.val_losses}, validation items counted {counted}', flush=True)
        if len(metrics) != 2 * n_train or not np.isfinite(np.array(metrics)).all():
            fail(f'fit: {len(metrics)} steps or a non-finite loss or grad norm')
        if not np.isfinite(tr.val_losses).all() or counted != [1.0, 1.0]:
            fail(f'fit: validation {tr.val_losses}, items counted {counted}')
        tags = ('best', 'epoch_0', 'epoch_1', 'final')
        missing = [t for t in tags if not os.path.exists(os.path.join(ckpt, t, 'state.pt'))]
        print(f'fit: checkpoints {sorted(os.listdir(ckpt))}, missing {missing}', flush=True)
        if missing:
            fail(f'fit: checkpoints {missing} missing')

        # informational: the loop (loader, prefetch, upload) against the bare step
        batch = tr._put(tr._host(next(dataset.batches([0], 1, shuffle=False))))
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr._train_step(tr.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        bare = statistics.median(times[1:])
        loop = seconds[1] / n_train
        print(f'fit: trained rays/s (informational, no bar): the fit loop {FIT_RES ** 2 / loop:.1f} '
              f'({loop * 1e3:.2f} ms a step over epoch 1, loader, prefetch and upload '
              f'included; epoch 0, decoding, {seconds[0] * 1e3 / n_train:.2f} ms) against '
              f'the bare step {FIT_RES ** 2 / bare:.1f} ({bare * 1e3:.2f} ms, median of 3), '
              f'on {card}', flush=True)
        t = time.perf_counter()
        path = tr.save('timed', 1)
        size = os.path.getsize(os.path.join(path, 'state.pt')) / 2 ** 30
        print(f'fit: one checkpoint (informational): {size:.2f} GiB in '
              f'{time.perf_counter() - t:.2f} s on this thread (host copies and torch.save); '
              f'the fit writes them on its writer thread', flush=True)
        del tr, batch
        shutil.rmtree(ckpt)
        torch.cuda.empty_cache()

        # (4): deterministic, 2 epochs; then a resume from epoch_0 runs epoch 1
        ckpt = os.path.join(root, 'b')
        full = fit_trainer(dataset, ckpt, deterministic=True)
        full.fit()
        want = params_of(full.model)
        del full
        torch.cuda.empty_cache()
        tr = fit_trainer(dataset, ckpt, resume=os.path.join(ckpt, 'epoch_0'),
                         deterministic=True)
        tr.fit()
        resumed = same_bits(params_of(tr.model), want)
        print(f'fit: deterministic=True, resumed from epoch_0 at epoch {tr.start_epoch}: every '
              f'parameter the bits of the uninterrupted run: {resumed}', flush=True)
        if not resumed:
            fail('fit: the resumed run differs from the uninterrupted one')
        del want

        # (5): a compact batch against its full texture, one loss-and-gradient pass
        grads = ts.make_loss_fns(tr.model, tr.tc)[1]
        compact = next(dataset.batches([0], 1, shuffle=False))
        full_tex = dict(compact)
        full_tex['texture'] = expand_texture_flat(full_tex.pop('texture_flat'), 32)
        (la, ga), (lb, gb) = (grads(tr.state, tr._put(tr._host(b))) for b in (compact, full_tex))
        same = bool(torch.equal(la, lb)) and same_bits(ga, gb)
        print(f'fit: compact batch against its full texture (deterministic): loss '
              f'{float(la):.7f} vs {float(lb):.7f}, the same bits of the loss and all '
              f'{len(ga)} gradients: {same}', flush=True)
        if 'texture_flat' not in compact or not same:
            fail('fit: the compact batch does not give its full texture\'s bits')
        del ga, gb

        # (7): debug_nans; a clean step with it on raises nothing
        batch = tr._put(tr._host(compact))
        bad = dict(batch, gt=batch['gt'].clone())
        bad['gt'][0, 0, 7, 9, 1] = float('nan')
        tc_nan = dataclasses.replace(tr.tc, debug_nans=True)
        step_nan = ts.make_train_step(tr.model, tr.tx, tc_nan)[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = step_nan(tr.state, batch)
        torch.cuda.synchronize()
        m['seconds'] = time.perf_counter() - t
        try:
            step_nan(tr.state, bad)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        before = params_of(tr.model)
        _, m_bad = ts.make_train_step(tr.model, tr.tx, tr.tc)[0](tr.state, bad)
        kept = same_bits(params_of(tr.model), before)
        x = torch.zeros(3, device='cuda', requires_grad=True)
        try:
            with ts.nan_check(True):
                torch.autograd.grad((x * torch.sqrt(x)).sum(), x)
            in_backward = None
        except FloatingPointError as e:
            in_backward = str(e)
        print(f'fit: debug_nans: a clean step {m}; with a NaN in the ground truth: '
              f'{raised!r}; a NaN made in a CUDA backward: {in_backward!r}; without the flag '
              f'the step reads {m_bad} and leaves every parameter as it was: {kept}',
              flush=True)
        if not (np.isfinite(m['loss']) and raised and in_backward and kept):
            fail('fit: debug_nans or the NaN skip misbehaved')
        del tr, before, batch, bad
        shutil.rmtree(ckpt)
        torch.cuda.empty_cache()

        # (6): dropout 0.1, deterministic, on the seeded model
        tc = ts.TrainConfig(precision='bfloat16', resolution=FIT_RES, steps_per_epoch=100,
                            remat=True, deterministic=True)
        model, tx, state = seeded_train_state(dataclasses.replace(V1_BASE, dropout=0.1), tc)
        batch = train_batch('cuda')
        grads = ts.make_loss_fns(model, tc)[1]
        names = [n for n, _ in model.named_parameters()]
        with reference_kernels():
            plain = grads(state, batch)
        agree = grad_agreement('dropout 0.1 kernels vs plain, the same masks',
                               grads(state, batch), plain, names)
        del plain
        if not within_bars(agree):
            fail(f'fit: dropout: {agree} past the bars {AGREE_BARS}')
        # two steps at one (seed, step) from the same state: the same bits
        deterministic_check('v1-base dropout 0.1', model, tx, state, batch, tc)
        _, m = ts.make_train_step(model, tx, tc)[0](state, batch)
        print(f'fit: dropout 0.1: a step {m}', flush=True)
        if not np.isfinite([m['loss'], m['grad_norm']]).all():
            fail(f'fit: dropout: a step {m}')
        del model, state, grads
        torch.cuda.empty_cache()

        # (8): the two view-stage variants
        args = bench_inputs()
        for name, (kw, expected) in FIT_RENDERS.items():
            pipe = RenderingPipeline.from_config(dataclasses.replace(V1_BASE, **kw), seed=0)
            reset_launch_counts()
            img = pipe.render(*args, resolution=RES, precision='bf16')
            torch.cuda.synchronize()
            got = dict(LAUNCHES)
            with reference_kernels():
                ref = pipe.render(*args, resolution=RES, precision='bf16')
            p = psnr(ref.float().cpu().numpy(), img.float().cpu().numpy())
            print(f'fit: {name} render 512^2 x {V} bf16: launches {json.dumps(got)}; kernels '
                  f'vs plain HDR PSNR {p:.2f} dB (need >= 40); mean {float(img.mean()):.6f}',
                  flush=True)
            if got != expected:
                fail(f'{name} launch counts {got} != {expected}')
            if tuple(img.shape) != (1, V, RES, RES, 3) or not bool(torch.isfinite(img).all()):
                fail(f'{name} render: shape {tuple(img.shape)} or non-finite values')
            if not p >= 40.0:
                fail(f'{name} render PSNR {p} < 40 dB')
            del pipe, img, ref
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f'fit: phase 9 in {time.time() - t0:.1f} s', flush=True)


# ---------------------------------------------------------------------------
# phase 10: scenes to ground truth on the card
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(HERE, 'examples')
CBOX_TRIS = 4326                  # the in-repo examples/cbox.json, remeshed
GT_RES, GT_SPP, GT_DEPTH, GT_CLAMP = 256, 64, 3, 10.0   # generate_dataset's GT
PROFILE_SPP = 4                   # the profiled GT image's samples a pixel
RAY_RES = 128                     # cbox's primary rays, card against CPU
STAT_RES, STAT_SPP = 32, 256      # the card-against-CPU statistical render
GEN_RES, GEN_SPP = 64, 16         # the generator's GT pass


def _quad(center, u, v, size):
    c = np.asarray(center, np.float32)
    u = np.asarray(u, np.float32) * size / 2
    v = np.asarray(v, np.float32) * size / 2
    p00, p01, p10, p11 = c - u - v, c - u + v, c + u - v, c + u + v
    return np.stack([np.stack([p00, p10, p11]), np.stack([p00, p11, p01])]).astype(np.float32)


def _flat_vn(tris):
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)


def _camera(pos, rot=None):
    c2w = np.eye(4, dtype=np.float32)
    if rot is not None:
        c2w[:3, :3] = rot
    c2w[:3, 3] = pos
    return c2w


# a camera looking straight down -y: x right, -z up in the image
DOWN = np.stack([np.array([1, 0, 0]), np.array([0, 0, -1]), np.array([0, 1, 0])],
                axis=1).astype(np.float32)


def physics_scenes():
    """The physics checks of tests/test_path_tracer.py: name -> (scene,
    render keywords, check(img) -> (value, bar, ok))."""
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    out = {}
    tris = _quad([0, 0, 0], [1, 0, 0], [0, 1, 0], 2.0)
    out['primary emission exact'] = (
        (tris, np.zeros((2, 3)), f32([[2.0, 3.0, 4.0]] * 2), _camera([0, 0, 3.0]), 40.0),
        dict(resolution=16, spp=2, max_depth=1),
        lambda img: (img[8, 8].tolist(), 'rtol 1e-5 of [2, 3, 4]',
                     np.allclose(img[8, 8], [2.0, 3.0, 4.0], rtol=1e-5, atol=0)))
    h, s, E = 2.0, 0.05, 500.0
    tris = np.concatenate([_quad([0, 0, 0], [1, 0, 0], [0, 0, -1], 4.0),
                           _quad([0, h, 0], [1, 0, 0], [0, 0, 1], s)])
    diffuse = f32([[0.6, 0.5, 0.4]] * 2 + [[0.0] * 3] * 2)
    want = diffuse[0] / np.pi * E * (s * s) / (h * h)
    out['direct lighting analytic'] = (
        (tris, diffuse, f32([[0.0] * 3] * 2 + [[E] * 3] * 2), _camera([0, 1.0, 0], DOWN), 30.0),
        dict(resolution=8, spp=128, max_depth=1),
        lambda img: ((img[4, 4] / want).tolist(), 'ratio to analytic within 0.08',
                     np.allclose(img[4, 4], want, rtol=0.08, atol=0)))
    L, size = 2.0, 6.0
    box = np.concatenate([_quad(c, u, v, size) for c, u, v in [
        ([0, -3, 0], [1, 0, 0], [0, 0, -1]), ([0, 3, 0], [1, 0, 0], [0, 0, 1]),
        ([0, 0, -3], [1, 0, 0], [0, 1, 0]), ([0, 0, 3], [-1, 0, 0], [0, 1, 0]),
        ([-3, 0, 0], [0, 0, 1], [0, 1, 0]), ([3, 0, 0], [0, 0, -1], [0, 1, 0])]])
    tris = np.concatenate([box, _quad([0, 0, 0], [1, 0, 0], [0, 1, 0], 1.0)])
    n = len(tris)
    diffuse = np.concatenate([np.zeros((12, 3), np.float32), np.ones((2, 3), np.float32)])
    emissive = np.concatenate([np.full((12, 3), L, np.float32), np.zeros((2, 3), np.float32)])
    for spec, rough, lo, hi in [(None, None, 0.97, 1.03), (0.5, 0.6, 0.90, 1.02),
                                (1.0, 0.3, 0.90, 1.02), (1.0, 0.6, 0.88, 1.02)]:
        kw = dict(resolution=8, spp=512, max_depth=4)
        if spec is not None:
            kw.update(specular=np.full(n, spec, np.float32), roughness=np.full(n, rough, np.float32))

        def check(img, lo=lo, hi=hi):
            c = float(img[3:5, 3:5].mean()) / L
            return c, f'[{lo}, {hi}] of L', lo <= c <= hi
        out[f'furnace spec {spec} rough {rough}'] = (
            (tris, diffuse, emissive, _camera([0, 0, 2.0]), 20.0), kw, check)
    return out


def glossy_box():
    """The statistical check's scene (tests/test_torch_path_tracer.py's): a
    closed box of 14 triangles, red and green side walls, a GGX floor, a
    small light 0.3 under the ceiling; the camera inside."""
    walls = [([0, -1, 0], [1, 0, 0], [0, 0, -1], [0.7, 0.7, 0.7]),
             ([0, 1, 0], [1, 0, 0], [0, 0, 1], [0.7, 0.7, 0.7]),
             ([0, 0, -1], [1, 0, 0], [0, 1, 0], [0.7, 0.7, 0.7]),
             ([0, 0, 1], [-1, 0, 0], [0, 1, 0], [0.7, 0.7, 0.7]),
             ([-1, 0, 0], [0, 0, 1], [0, 1, 0], [0.7, 0.1, 0.1]),
             ([1, 0, 0], [0, 0, -1], [0, 1, 0], [0.1, 0.7, 0.1])]
    tris, diffuse, emissive, spec, rough = [], [], [], [], []
    for i, (c, u, v, alb) in enumerate(walls):
        tris.append(_quad(c, u, v, 2.0))
        diffuse += [alb] * 2
        emissive += [[0.0] * 3] * 2
        spec += [1.0 if i == 0 else 0.1] * 2
        rough += [0.3 if i == 0 else 0.9] * 2
    tris.append(_quad([0, 0.7, 0], [1, 0, 0], [0, 0, 1], 0.5))
    diffuse += [[0.0] * 3] * 2
    emissive += [[30.0] * 3] * 2
    spec += [0.0] * 2
    rough += [1.0] * 2
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (np.concatenate(tris), f32(diffuse), f32(emissive), _camera([0, 0, 0.9]), 60.0,
            dict(specular=f32(spec), roughness=f32(rough)))


def trace(scene, dev, seed, **kw):
    """path_trace of (tris, diffuse, emissive, c2w, fov_deg) on dev; HDR numpy."""
    import torch
    from renderformer_tpu_torch.scene.path_tracer import path_trace
    tris, diffuse, emissive, c2w, fov = scene
    t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), device=dev).to(dt)  # noqa: E731
    for k in ('specular', 'roughness'):
        if k in kw:
            kw[k] = t(kw[k])
    return path_trace(t(tris), t(_flat_vn(tris)), torch.ones(len(tris), dtype=torch.bool,
                                                             device=dev),
                      t(diffuse), t(emissive), t(c2w), np.float32(np.deg2rad(fov)),
                      torch.Generator(dev).manual_seed(seed), **kw).cpu().numpy()


def block_means(img, b=4):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def primary_rays(scene):
    """cbox's RAY_RES^2 primary rays through the pixel centres, on the CPU."""
    import torch
    from renderformer_tpu_torch.scene.path_tracer import _primary_rays
    return _primary_rays(torch.full((RAY_RES, RAY_RES, 2), 0.5),
                         torch.as_tensor(scene['c2w'][0]),
                         np.float32(np.deg2rad(scene['fov'][0])), RAY_RES)


def check_intersection(scene, rays, want, dev, tf32):
    """The card's intersect of ``rays`` against the CPU's (``want``): hits
    equal, t within 1e-5 relative, the triangle equal except at ties (the
    CPU's t of the card's triangle within 1e-5 of the CPU's nearest hit, as
    on a shared edge).  Returns the card's (t, idx) on the CPU."""
    import torch
    from renderformer_tpu_torch.scene.path_tracer import intersect
    o, d = rays
    tris = torch.as_tensor(scene['triangles'])
    mask = torch.as_tensor(scene['mask'])
    t_cpu, i_cpu, h_cpu = want
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        t_dev, i_dev, h_dev = (x.cpu() for x in intersect(
            o.to(dev), d.to(dev), tris.to(dev), mask.to(dev)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    rel = float(((t_dev - t_cpu).abs() / t_cpu.abs())[h_cpu].max())
    n_hit_differ = int((h_dev != h_cpu).sum())
    differ = ((i_dev != i_cpu) & h_cpu).nonzero()[:, 0].tolist()
    ties = 0
    for r in differ:
        k = int(i_dev[r])
        t_k = float(intersect(o[r:r + 1], d[r:r + 1], tris[k:k + 1], mask[k:k + 1])[0][0])
        ties += abs(t_k - float(t_cpu[r])) <= 1e-5 * abs(float(t_cpu[r]))
    print(f'scene: intersect cbox {RAY_RES}^2 primary rays x {tris.shape[0]} triangles, card '
          f'against CPU (allow_tf32={tf32}): {int(h_cpu.sum())} of {h_cpu.numel()} hit, '
          f'{n_hit_differ} differ (need 0); t max relative difference {rel:.3g} (need <= '
          f'1e-5); the triangle differs at {len(differ)} rays, {ties} of them ties within '
          f'1e-5 (need all)', flush=True)
    if n_hit_differ or not rel <= 1e-5 or ties != len(differ):
        fail(f'intersect (allow_tf32={tf32}): the card disagrees with the CPU')
    return t_dev, i_dev


def convert_example(name):
    """An in-repo example scene converted in memory (no H5), as
    generate_dataset's GT pass takes it; prints its triangles, lights and
    seconds."""
    from renderformer_tpu_torch.generate_dataset import scene_tensors
    t = time.time()
    with open(os.path.join(EXAMPLES, f'{name}.json')) as f:
        scene = scene_tensors(json.load(f), EXAMPLES)
    lights = int((scene['texture'][:, 10:13].max(axis=(1, 2, 3)) > 0).sum())
    print(f'scene: {name} converted in memory in {time.time() - t:.2f} s: '
          f'{scene["triangles"].shape[0]} triangles, {lights} emissive, '
          f'{scene["c2w"].shape[0]} camera(s)', flush=True)
    return scene, lights


def scene_checks(card, dev='cuda'):
    """Phase 10: scene JSONs to ground truth on the card.  (1) the native
    meshops build; (2) cbox (remeshed) and veach-mis converted in memory,
    cbox 4,326 triangles and one light; (3) the path tracer's physics
    checks; (4) cbox's primary rays through the card's intersect against
    the CPU's, also under allow_tf32=True; (5) a small glossy box at
    STAT_RES^2 and STAT_SPP, card against CPU; (6) cbox's GT at
    generate_dataset's settings, finite and >= 0, with its seconds, path
    samples a second, peak memory and the device idle share of a profiled
    image; (7) cbox through the seeded v1-base renderer at 512^2 in bf16,
    exactly a render's K1-K5 launches; (8) the generator's pathtrace and
    model GT passes on two scene dicts at --seed 0, writing PNGs."""
    import random
    import tempfile

    import torch
    from renderformer_tpu_torch import generate_dataset as gd
    from renderformer_tpu_torch.io.image import read_png
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.scene import remesh
    from renderformer_tpu_torch.scene.path_tracer import render_scene_pathtrace

    t0 = time.time()
    # (1) the native build
    t = time.time()
    lib = remesh.build()
    print(f'scene: native meshops (g++ {" ".join(remesh.CXX_FLAGS)}) {lib} in '
          f'{time.time() - t:.2f} s', flush=True)

    # (2) two scenes, converted in memory
    cbox, lights = convert_example('cbox')
    if cbox['triangles'].shape[0] != CBOX_TRIS or lights != 1:
        fail(f'cbox: {cbox["triangles"].shape[0]} triangles and {lights} lights, '
             f'want {CBOX_TRIS} and 1')
    convert_example('veach-mis')

    # (3) physics on the card
    for name, (scene, kw, check) in physics_scenes().items():
        img = trace(scene, dev, 0, **kw)
        value, bar, ok = check(img)
        print(f'scene: physics {name}: {value} ({bar}) {"ok" if ok else "FAILED"}', flush=True)
        if not ok:
            fail(f'path tracer physics: {name}: {value}, want {bar}')

    # (4) intersection: card against CPU, and under allow_tf32=True
    from renderformer_tpu_torch.scene.path_tracer import intersect
    rays = primary_rays(cbox)
    t = time.time()
    want = intersect(*rays, torch.as_tensor(cbox['triangles']), torch.as_tensor(cbox['mask']))
    print(f'scene: intersect on the CPU in {time.time() - t:.2f} s', flush=True)
    t_a, i_a = check_intersection(cbox, rays, want, dev, False)
    t_b, i_b = check_intersection(cbox, rays, want, dev, True)
    same = bool(torch.equal(t_a, t_b) and torch.equal(i_a, i_b))
    print(f'scene: intersect on the card with allow_tf32 True and False: the same t and '
          f'triangles bit for bit {same} (need True)', flush=True)
    if not same:
        fail('allow_tf32 changed the card\'s intersection')

    # (5) statistics: card against CPU
    box = glossy_box()
    kw = dict(resolution=STAT_RES, spp=STAT_SPP, max_depth=3, **box[5])
    t = time.time()
    card0, card1 = (trace(box[:5], dev, s, **kw) for s in (0, 1))
    t_card = (time.time() - t) / 2
    t = time.time()
    cpu0 = trace(box[:5], 'cpu', 0, **kw)
    t_cpu = time.time() - t
    noise = float(np.abs(block_means(card0) - block_means(card1)).max())
    err = float(np.abs(block_means(card0) - block_means(cpu0)).max())
    mean_rel = abs(float(card0.mean()) / float(cpu0.mean()) - 1)
    print(f'scene: statistics, glossy box of {len(box[0])} triangles at {STAT_RES}^2, '
          f'{STAT_SPP} spp, depth 3, NEE+MIS: 4x4-block means card - CPU max {err:.4g} '
          f'against card seed 0 - seed 1 max {noise:.4g} (need <= 2x); image means card '
          f'{float(card0.mean()):.5f} CPU {float(cpu0.mean()):.5f}, {mean_rel * 100:.3f} % '
          f'apart (need <= 2 %); {t_card:.2f} s a card render, {t_cpu:.2f} s the CPU\'s',
          flush=True)
    if not (np.isfinite(card0).all() and np.isfinite(cpu0).all()):
        fail('statistics: a render is not finite')
    if not (err <= 2 * noise and mean_rel <= 0.02):
        fail(f'statistics: the card disagrees with the CPU (blocks {err} against '
             f'{noise}, means {mean_rel})')

    # (6) cbox's GT at generate_dataset's settings
    def gt(spp, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = render_scene_pathtrace(cbox, view=0, resolution=GT_RES, spp=spp,
                                     max_depth=GT_DEPTH, seed=0, clamp=GT_CLAMP, device=dev,
                                     **kw)
        torch.cuda.synchronize()
        return img, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    img, sec = gt(GT_SPP)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    samples = GT_RES * GT_RES * GT_SPP
    print(f'scene: cbox GT ({CBOX_TRIS} triangles) at {GT_RES}^2, {GT_SPP} spp, depth '
          f'{GT_DEPTH}, clamp {GT_CLAMP}: {sec:.2f} s an image, {samples / sec:.4g} path '
          f'samples/s, peak memory {peak:.3f} GiB; mean {float(img.mean()):.5f}, max '
          f'{float(img.max()):.4g}, min {float(img.min()):.4g}, finite '
          f'{bool(np.isfinite(img).all())}, on {card}', flush=True)
    if not (np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0):
        fail('cbox GT is not finite and >= 0, or is black')
    from torch.profiler import ProfilerActivity, profile
    _, plain = gt(PROFILE_SPP)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = gt(PROFILE_SPP)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    for e in kernels[:10]:
        print(f'profile: cbox GT {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x '
              f'{e.key[:90]}', flush=True)
    print(f'scene: cbox GT at {PROFILE_SPP} spp: device time {dev_ms:.1f} ms (profiled), '
          f'device idle share {1 - dev_ms / (plain * 1e3):.3f} of the {plain * 1e3:.1f} ms '
          f'unprofiled image ({1 - dev_ms / (wall * 1e3):.3f} of the {wall * 1e3:.1f} ms '
          f'profiled one)', flush=True)

    # (7) the same cbox through the renderer
    t = time.time()
    pipe = render_pipeline(BASE)
    print(f'scene: {BASE} seeded init in {time.time() - t:.1f} s', flush=True)
    args = tuple(cbox[k][None] for k in ('triangles', 'texture', 'mask', 'vn', 'c2w'))
    fov = cbox['fov'][None, :, None]
    reset_launch_counts()
    out = pipe.render(*args, fov, resolution=RES, precision='bf16')
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f'scene: cbox through {BASE} bf16 {RES}^2 launches ' + json.dumps(launches)
          + f'; finite {bool(torch.isfinite(out).all())}, mean {float(out.float().mean()):.5f}',
          flush=True)
    if launches != EXPECTED_LAUNCHES[BASE]:
        fail(f'cbox render launch counts {launches} != {EXPECTED_LAUNCHES[BASE]}')
    if tuple(out.shape) != (1, 1, RES, RES, 3) or not bool(torch.isfinite(out).all()):
        fail(f'cbox render: shape {tuple(out.shape)} or non-finite values')
    del pipe, out
    torch.cuda.empty_cache()

    # (8) the generator's GT pass on in-memory scene dicts
    root = tempfile.mkdtemp(prefix='rf_gen_')
    try:
        cfg = gd.build_config(gd.build_parser().parse_args(
            ['--data_path', root, '--obj_path', os.path.join(EXAMPLES, 'objects', 'cbox'),
             '--seed', '0']))
        cfg['BASE_DIR'] = EXAMPLES
        random.seed(0)
        gen = gd.SceneGenerator(cfg)
        scenes = {}
        for i in range(2):  # drawn and converted in turn, as the generator does
            name, scene = gen.next_scene(i)
            scenes[name] = gd.scene_tensors(scene)
        for mode, kw in (('pathtrace', dict(spp=GEN_SPP)), ('model', dict(preset='tiny'))):
            t = time.time()
            imgs = gd.render_gt(scenes, mode, os.path.join(root, mode), resolution=GEN_RES,
                                seed=0, **kw)
            for name, img in imgs.items():
                back = read_png(os.path.join(root, mode, f'{name}.png'))
                if back.shape != (GEN_RES, GEN_RES, 3) or not np.array_equal(back, img):
                    fail(f'generator {mode}: {name}.png is not the image rendered')
            print(f'scene: generator GT {mode} ({kw}) at {GEN_RES}^2 on 2 scenes at --seed 0 '
                  f'({", ".join(f"{k}: {v["triangles"].shape[0]} triangles" for k, v in scenes.items())}) '
                  f'in {time.time() - t:.2f} s; PNG means '
                  f'{[round(float(x.mean()), 2) for x in imgs.values()]}', flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f'scene: phase 10 in {time.time() - t0:.1f} s', flush=True)


# ---------------------------------------------------------------------------
# phase 11: the multi-GPU code on one card
# ---------------------------------------------------------------------------

RING_N = 4                       # K/V slices of the ring's one-device fold
RING_MASKED = SK // RING_N       # keys masked at the end of view 0 at the cross site
# v1-base's view-stage attention sites: (Sq, Sk, per-scene K/V, masked)
RING_SITES = {'cross': (ST, SK, True, True), 'ray-self': (ST, ST, False, False)}
# bars of the fold, of max|ref|, against the unsharded kernels and the ring
# of the kernels' plain versions, and of the fold under K9 against its own
# plain ring: the flash kernels' fp32 bar; in bf16 one or two units of the
# last place at the largest element (each output rounds once to bf16; K9's
# dQ rounds a slice).  Against the ring of the JAX partials in torch ops, a
# function that scales the logits after the product where the kernels round
# q to bf16 after its scaling: 2^-6 in bf16, a deviation from the 2^-7 asked
# for, set after H100 runs read dQ 0.0084 of max|ref| at the cross site
# with the partials rounding P and dS as the kernels do and without, and
# with the fold's dQ summed in fp32 and without (PERF.md, §6 and §7)
RING_TOL = {'fp32': 2.0 ** -16, 'bf16': 2.0 ** -7}
RING_TOL_JAX = {'fp32': 2.0 ** -16, 'bf16': 2.0 ** -6}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def ring_site_inputs(site, dtype, dev='cuda'):
    """v1-base's view-stage site at 512^2 x 8 views (6 heads of 128): q, the
    per-scene (cross) or per-view (ray-self) K and V, the mask (view 0's last
    RING_MASKED keys, a whole ring slice) and the RoPE tables, from numpy
    seed 0, with the output cotangent."""
    import torch
    from renderformer_tpu_torch.encodings.rope import make_cos_sin
    sq, sk, per_scene, masked = RING_SITES[site]
    h = 6
    rng = np.random.default_rng(0)

    def t(*shape, dt=dtype):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(dev, dt)

    bkv = 1 if per_scene else V
    q, k, v = t(V, sq, h, D), t(bkv, sk, h, D), t(bkv, sk, h, D)
    mask = None
    if masked:
        mask = torch.ones((V, sk), dtype=torch.bool, device=dev)
        mask[0, -RING_MASKED:] = False
    tabs = []
    for n in (sq, sk):
        cos, sin = make_cos_sin(t(V, n, 9, dt=torch.float32), 12, D)
        tabs += [cos[:, :, 0].contiguous(), sin[:, :, 0].contiguous()]
    return q, k, v, mask, tabs, t(V, sq, h, D) * 0.1


def ring_site_rotated(q, k, v, tabs):
    """The model's ring site up to the ring: q rotated in fp32 torch ops, K
    rotated and fanned out per view by K3, V fanned out."""
    from renderformer_tpu_torch.encodings.rope import apply_rope
    from renderformer_tpu_torch.ops.flash_attention import fan_out, rotate_kv
    cq, sq_, ck, sk_ = tabs
    return (apply_rope(q, cq[:, :, None, :], sq_[:, :, None, :]), rotate_kv(k, ck, sk_),
            fan_out(v, q.shape[0]).contiguous())


def ring_site_run(fold, q, k, v, mask, tabs, g, impl='flash'):
    """The site's rotations, then the fold of RING_N slices (``fold``) or
    one K10 call with its logsumexp, and the backward: the output and the
    gradients of q, k and v."""
    import torch
    from renderformer_tpu_torch.ops.flash_attention import flash_attention
    from renderformer_tpu_torch.parallel.ring_attention import ring_fold
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    qr, kr, vr = ring_site_rotated(q, k, v, tabs)
    out = (ring_fold(qr, kr, vr, mask, n=RING_N, impl=impl) if fold
           else flash_attention(qr, kr, vr, mask))
    grads = torch.autograd.grad(out, (q, k, v), g)
    return (out.detach(), *grads)


def ring_kernel_rows(rows, path, site, q, k, v, mask, tabs, g):
    """The fold's kernels at the shapes and on the data it gives them, each
    against its plain version: K3 at the site (its one launch), and for
    each of the RING_N K/V slices K10 with its logsumexp and K8 against the
    global logsumexp and delta (one launch of each a slice), per_run
    {path: 1} a row, and K9's dQ and dK/dV kernels, each timed alone
    against the plain version of its part (per_run {path twokernel: 1};
    K3 and K10 count there too), K9's dQ also by CUDA graphs and for the
    same bits over calls and replays (check_dq).  SDPA and autograd through
    it on the slice are the library yardsticks, for all three gradients
    (K8), dq alone and (dk, dv) alone (K9's kernels); a row of the slice
    with every key masked gives SDPA NaNs, which only its time reads.  The
    logsumexp of such a row is left out of the comparison and must lie below
    -1e29, where it weighs exactly 0 in the merge; its output (uniform over
    the keys) is not."""
    import torch
    import torch.nn.functional as F
    from renderformer_tpu_torch import _build
    from renderformer_tpu_torch.ops import reference_kernels
    from renderformer_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_dkv_plain, flash_bwd_dq_plain, flash_fwd, launch_flash_bwd,
        rot_kv_broadcast, rot_kv_broadcast_plain)
    dtype = q.dtype
    it = 2 if dtype == torch.bfloat16 else 4
    b, sq, h, _ = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    lib = _build.library()
    tk = f'{path} twokernel'
    one, both = {path: 1}, {path: 1, tk: 1}
    _, _, ck, sk_t = tabs
    with torch.no_grad():
        k_rot = rot_kv_broadcast(k, ck, sk_t)
        ref_rot = rot_kv_broadcast_plain(k, ck, sk_t)
        record_row(rows, 'rot_kv_broadcast', f'ring_{site}', dtype, both, k_rot, ref_rot,
                   k3_tol(ref_rot), K3_WHY, lambda: rot_kv_broadcast(k, ck, sk_t), None,
                   k3_bytes(b, bkv, sk, h, it), 3 * b * sk * h * D, PEAK_FP32)
        del k_rot, ref_rot
        qr, kr, vr = ring_site_rotated(q, k, v, tabs)
        out, lse = flash_fwd(qr, kr, vr, mask, with_lse=True)  # the global logsumexp
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        qs, gs = qr.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        n = sk // RING_N
        for i in range(RING_N):
            cut = slice(i * n, (i + 1) * n)
            ki, vi = kr[:, cut].contiguous(), vr[:, cut].contiguous()
            mi = None if mask is None else mask[:, cut].contiguous()
            keep = torch.ones(b, dtype=torch.bool, device=q.device) if mi is None else mi.any(-1)
            name = f'ring_{site}_slice{i}'
            kname = 'flash_fwd_mask' if mi is not None else 'flash_fwd_nomask'
            o_i, lse_i = flash_fwd(qr, ki, vi, mi, with_lse=True)
            with reference_kernels():
                ref_o, ref_lse = flash_fwd(qr, ki, vi, mi, with_lse=True)
            if not bool((lse_i[~keep] < -1e29).all()):
                fail(f'{path} slice {i}: a fully masked row\'s logsumexp is not below -1e29')
            tol, why = attention_tol(ref_o, dtype, 'P at the running max vs the row max')
            tol = (tol, 1e-5 * float(ref_lse[keep].abs().max()) + 2e-5)
            why += ('; lse m*ln2 + ln(l) in fp32 over the rows with a key: 1e-5 of max|lse| '
                    '+ 2e-5')
            ks_, vs_ = ki.transpose(1, 2).contiguous(), vi.transpose(1, 2).contiguous()
            am = None if mi is None else mi[:, None, None, :]
            record_row(rows, kname, name + '_lse', dtype, both, (o_i, lse_i[keep]),
                       (ref_o, ref_lse[keep]), tol, why,
                       lambda: flash_fwd(qr, ki, vi, mi, with_lse=True),
                       lambda: F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=am),
                       (2 * b * sq + 2 * b * n) * h * D * it + (b * n if mi is not None else 0)
                       + b * h * sq * 4, 4 * b * h * sq * n * D, flash_rate(dtype))
            del o_i, lse_i, ref_o, ref_lse
            # as the ring calls K8: dQ added into an fp32 sum (here a zero one)
            io = (qr, ki, vi, mi, lse, delta, g)
            acc, ref_acc, scratch = (torch.zeros(qr.shape, dtype=torch.float32,
                                                 device=q.device) for _ in range(3))
            got = (acc, *flash_bwd(*io, 'fused', dq_acc=acc)[1:])
            with reference_kernels():
                ref = (ref_acc, *flash_bwd(*io, dq_acc=ref_acc)[1:])
            tols = tuple(attention_tol(r, dtype, '')[0] * 2 for r in ref)
            why = ('q, P and dS round to the dtype in both, dQ sums by atomics (K8) in a '
                   'run-dependent order into fp32: 8 bf16 ulps / 2^-15 of max|ref| per output')
            with torch.enable_grad():
                ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qs, ks_, vs_))
                yl = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am)

            def lib_grad(*wrt):
                return lambda: torch.autograd.grad(yl, wrt, gs, retain_graph=True)

            b_in = ((2 * b * sq + 2 * b * n) * h * D * it + 2 * b * h * sq * 4
                    + (b * n if mi is not None else 0))
            record_row(rows, 'flash_bwd_mask' if mi is not None else 'flash_bwd_nomask', name,
                       dtype, one, got, ref, tols, why,
                       lambda: flash_bwd(*io, 'fused', dq_acc=scratch), lib_grad(ql, kl, vl),
                       b_in + 2 * b * n * h * D * it
                       + 2 * b * sq * h * D * 4,  # dk, dv; the fp32 dQ sum read and written
                       10 * b * h * sq * n * D, flash_rate(dtype))
            # K9 as the ring calls it under 'twokernel': dQ written in the dtype
            # (then added into the ring's fp32 sum), dK and dV
            two = flash_bwd(*io, 'twokernel')
            with reference_kernels():
                ref9 = flash_bwd(*io)
            tols9 = tuple(attention_tol(r, dtype, '')[0] * 2 for r in ref9)
            why9 = ('q, P and dS round to the dtype in both, in another summation order: '
                    '8 bf16 ulps / 2^-15 of max|ref| per output')
            record_row(rows, 'flash_bwd_dq', name, dtype, {tk: 1}, two[0], ref9[0], tols9[0],
                       why9, lambda: launch_flash_bwd(lib, 'dq', *io), lib_grad(ql),
                       b_in + b * sq * h * D * it, 6 * b * h * sq * n * D, flash_rate(dtype),
                       plain_fn=lambda: flash_bwd_dq_plain(*io))
            check_dq(rows[-1], lib, io, (qs, ks_, vs_, am, gs), name, dtype)
            record_row(rows, 'flash_bwd_dkv', name, dtype, {tk: 1}, two[1:], ref9[1:],
                       tols9[1:], why9, lambda: launch_flash_bwd(lib, 'dkv', *io),
                       lib_grad(kl, vl), b_in + 2 * b * n * h * D * it,
                       8 * b * h * sq * n * D, flash_rate(dtype),
                       plain_fn=lambda: flash_bwd_dkv_plain(*io))
            del got, ref, ql, kl, vl, yl, io, two, ref9, ki, vi, ks_, vs_, acc, ref_acc
            del scratch
        del qr, kr, vr, out, lse, delta, qs, gs
    torch.cuda.empty_cache()


def ring_checks(card, rows):
    """Phase 11 (b): the ring's one-device fold of RING_N slices at v1-base's
    cross and ray-self sites in bf16 and fp32: output and (dq, dk, dv)
    against the unsharded K10 and K8, the plain ring (the kernels' plain
    versions, inside reference_kernels()) and the ring of the JAX partials
    in torch ops (RING_TOL_JAX), and the fold under the two-kernel backward
    against its plain ring (K9's dQ rounds to the dtype a slice; RING_TOL), the
    kernels at the fold's shapes (ring_kernel_rows), exact launch counts
    (K3 once, K10 and K8 RING_N times each), K9 in place of K8 under
    flash_backward('twokernel') (the '<path> twokernel' paths), and the
    fold's ms beside one unsharded call.  Returns the launches of each
    RING_PATHS path."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reference_kernels, reset_launch_counts
    from renderformer_tpu_torch.ops.flash_attention import flash_backward, flash_fwd
    from renderformer_tpu_torch.parallel.ring_attention import ring_fold
    launches = {}
    for site, (sq, sk, per_scene, masked) in RING_SITES.items():
        for dt_name, dtype in (('bf16', torch.bfloat16), ('fp32', torch.float32)):
            path = f'ring {site} {dt_name}'
            q, k, v, mask, tabs, g = ring_site_inputs(site, dtype)
            torch.cuda.synchronize()
            reset_launch_counts()
            fold = ring_site_run(True, q, k, v, mask, tabs, g)
            torch.cuda.synchronize()
            launches[path] = dict(LAUNCHES)
            kind = 'mask' if masked else 'nomask'
            want = _launches(rot_kv_broadcast=1, **{f'flash_fwd_{kind}': RING_N,
                                                    f'flash_bwd_{kind}': RING_N})
            print(f'parallel: {path} launches ' + json.dumps(launches[path]), flush=True)
            if launches[path] != want:
                fail(f'{path} launch counts {launches[path]} != {want}')
            one = ring_site_run(False, q, k, v, mask, tabs, g)
            with reference_kernels():
                plain = ring_site_run(True, q, k, v, mask, tabs, g)
                jax_ring = ring_site_run(True, q, k, v, mask, tabs, g, impl='xla')
                with flash_backward('twokernel'):
                    plain9 = ring_site_run(True, q, k, v, mask, tabs, g)
            reset_launch_counts()
            with flash_backward('twokernel'):
                det = ring_site_run(True, q, k, v, mask, tabs, g)
            torch.cuda.synchronize()
            launches[f'{path} twokernel'] = dict(LAUNCHES)
            k9 = {n: c for n, c in LAUNCHES.items() if c}
            if k9 != {'rot_kv_broadcast': 1, f'flash_fwd_{kind}': RING_N,
                      'flash_bwd_dq': RING_N, 'flash_bwd_dkv': RING_N}:
                fail(f'{path} under twokernel: launches {k9}')
            errs, bad = {}, []
            for ref_name, got, ref, bar in (
                    ('unsharded', fold, one, RING_TOL), ('plain ring', fold, plain, RING_TOL),
                    ('JAX-partials ring', fold, jax_ring, RING_TOL_JAX),
                    ('K9 fold vs its plain ring', det, plain9, RING_TOL)):
                for name, a, b in zip(('out', 'dq', 'dk', 'dv'), got, ref):
                    amax = float(b.float().abs().max())
                    err = float((a.float() - b.float()).abs().max())
                    errs[f'{ref_name} {name}'] = (err, err / amax)
                    if not np.isfinite(err) or err > bar[dt_name] * amax:
                        bad.append(f'{name} vs {ref_name}: max err {err} > '
                                   f'{bar[dt_name]} x max|ref| {amax}')
            ring_kernel_rows(rows, path, site, q, k, v, mask, tabs, g)
            fold_ms = time_ms(lambda: ring_site_run(True, q, k, v, mask, tabs, g), iters=5)
            one_ms = time_ms(lambda: ring_site_run(False, q, k, v, mask, tabs, g), iters=5)
            with torch.no_grad():
                qr, kr, vr = ring_site_rotated(q, k, v, tabs)
                fwd_fold = time_ms(lambda: ring_fold(qr, kr, vr, mask, n=RING_N), iters=5)
                fwd_one = time_ms(lambda: flash_fwd(qr, kr, vr, mask, with_lse=True), iters=5)
                del qr, kr, vr
            print(f'parallel: {path}: [{V}, {sq}, 6, {D}] against {sk} keys'
                  f'{f", view 0 last {RING_MASKED} masked" if masked else ""}; the fold of '
                  f'{RING_N} against one unsharded K10 + K8: forward {fwd_fold:.3f} ms vs '
                  f'{fwd_one:.3f} ms, forward and backward (the site: q rotation, K3, '
                  f'autograd) {fold_ms:.3f} ms vs {one_ms:.3f} ms on {card}; max err / '
                  f'max|ref| (bar {RING_TOL[dt_name]:.3g}, against the JAX partials '
                  f'{RING_TOL_JAX[dt_name]:.3g}) '
                  + json.dumps({n: [f'{e:.3g}', f'{r:.3g}'] for n, (e, r) in errs.items()}),
                  flush=True)
            if bad:
                fail(f'{path}: ' + '; '.join(bad))
            del fold, one, plain, jax_ring, det, plain9
            torch.cuda.empty_cache()
    return launches


def parallel_checks(card, rows):
    """Phase 11: the multi-GPU code on one card.  (a) setup_distributed()
    under torchrun's environment of world 1 makes an NCCL group; (b)
    ring_checks, with ring_kernel_rows' rows added to ``rows``; (c) one
    v1-base fit step through train.build inside the group: exactly phase
    7's fused launches with the gradient all-reduce run, and under
    deterministic=True the loss, the grad norm and every updated parameter
    the bits of the same step with no group; (d) the v1-base 512^2 x
    8-view render on use_mesh() the bits of the render without it, with
    exactly a render's launches; (e) ``infer --attn_impl xla`` and
    ring_fold(impl='xla') raise on the card; (f) trace() around a render
    writes a trace that names K1 and an annotate()d range; (g) with the
    group gone, make_mesh() gives a mesh of one rank.  Returns ring_checks'
    launches."""
    import glob
    import tempfile

    import torch
    import torch.distributed as dist
    from renderformer_tpu_torch import infer
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.parallel.distributed import (
        process_info, setup_distributed, teardown_distributed)
    from renderformer_tpu_torch.parallel.ring_attention import ring_fold
    from renderformer_tpu_torch.parallel.sharding import make_mesh
    from renderformer_tpu_torch.training import state as ts
    from renderformer_tpu_torch.utils.profiling import annotate, trace

    t0 = time.time()
    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    root = tempfile.mkdtemp(prefix='parallel_')
    try:
        # (a)
        if not setup_distributed() or dist.get_backend() != 'nccl':
            fail('setup_distributed() made no NCCL group under a torchrun environment')
        print(f'parallel: NCCL group {process_info()} on cuda:{torch.cuda.current_device()} '
              f'({time.time() - t0:.1f} s)', flush=True)

        # (b)
        launches = ring_checks(card, rows)
        print(f'parallel: ring checks done ({time.time() - t0:.1f} s)', flush=True)

        # (c)
        dataset = memory_dataset(fit_scenes(), root)
        tr = fit_trainer(dataset, os.path.join(root, 'ckpt'))
        if tr.mesh is None or tuple(tr.mesh.shape) != (1, 1):
            fail(f'the trainer in a group of one made the mesh {tr.mesh}')
        batch = tr._put(tr._host(next(dataset.batches([0], 1, shuffle=False))))
        start = {n: t.clone() for n, t in tr.model.state_dict().items()}
        reduced = []
        real_reduce = ts.all_reduce_mean

        def counted_reduce(grads, loss, mesh):
            reduced.append(sum(g.numel() for g in grads))
            return real_reduce(grads, loss, mesh)

        def step_from_start(step):
            tr.model.load_state_dict(start)
            tr.state.opt_state = tr.tx.init(dict(tr.model.named_parameters()))
            tr.state.step = 0
            reset_launch_counts()
            _, m = step(tr.state, batch)
            torch.cuda.synchronize()
            return m, dict(LAUNCHES), params_of(tr.model)

        ts.all_reduce_mean = counted_reduce
        try:
            m, counts, _ = step_from_start(tr._train_step)
            print(f'parallel: fit step in the group (fused): loss {m["loss"]:.7f} grad norm '
                  f'{m["grad_norm"]:.6f}, all-reduces {reduced} gradient elements, launches '
                  + json.dumps(counts), flush=True)
            if counts != EXPECTED_LAUNCHES[TRAIN] or len(reduced) != 1:
                fail(f'the fit step in the group: launches {counts}, all-reduces {reduced}')
            if not (np.isfinite(m['loss']) and np.isfinite(m['grad_norm'])):
                fail('the fit step in the group: a non-finite loss or grad norm')
            det = dataclasses.replace(tr.tc, deterministic=True)
            m_g, _, p_g = step_from_start(ts.make_train_step(tr.model, tr.tx, det,
                                                             mesh=tr.mesh)[0])
            m_n, _, p_n = step_from_start(ts.make_train_step(tr.model, tr.tx, det)[0])
        finally:
            ts.all_reduce_mean = real_reduce
        same = (m_g == m_n and same_bits(p_g, p_n) and len(reduced) == 2)
        print(f'parallel: deterministic step in the group of one against no group: loss '
              f'{m_g["loss"]!r} vs {m_n["loss"]!r}, grad norm {m_g["grad_norm"]!r} vs '
              f'{m_n["grad_norm"]!r}, all {len(p_g)} updated parameters the same bits, '
              f'one all-reduce in the group, none without: {same}', flush=True)
        if not same:
            fail('the step in a group of one differs from the step with no group')
        del tr, p_g, p_n, start, batch
        torch.cuda.empty_cache()
        print(f'parallel: fit checks done ({time.time() - t0:.1f} s)', flush=True)

        # (d)
        pipe = render_pipeline(BASE)
        dargs = [torch.as_tensor(a, device='cuda') for a in bench_inputs()]
        want = pipe.render(*dargs, resolution=RES, precision='bf16')
        pipe.use_mesh()
        torch.cuda.synchronize()
        reset_launch_counts()
        got = pipe.render(*dargs, resolution=RES, precision='bf16')
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        same = bool(torch.equal(got, want))
        print(f'parallel: v1-base render on use_mesh() {tuple(pipe.mesh.shape)}: the bits of '
              f'the render without a mesh: {same}; launches ' + json.dumps(counts), flush=True)
        if not same or counts != EXPECTED_LAUNCHES[BASE]:
            fail(f'the render on a mesh of one: same bits {same}, launches {counts}')

        # (e)
        for what, fn in (
                ("infer --attn_impl xla",
                 lambda: infer.main(['--h5_file', root, '--model_id', BASE,
                                     '--attn_impl', 'xla'])),
                ("ring_fold(impl='xla')",
                 lambda: ring_fold(*(torch.zeros(1, 8, 1, D, device='cuda'),) * 3, None,
                                   n=2, impl='xla'))):
            try:
                fn()
            except (ValueError, RuntimeError) as e:
                print(f'parallel: {what} on the card raises: {e}', flush=True)
            else:
                fail(f'{what} ran on the card')

        # (f)
        for attempt in range(2):
            tdir = os.path.join(root, f'trace{attempt}')
            with trace(tdir):
                with annotate('phase11 render'):
                    pipe.render(*dargs, resolution=RES, precision='bf16')
            files = glob.glob(os.path.join(tdir, '*.json'))
            text = open(files[0]).read() if len(files) == 1 else ''
            named = {n: n in text for n in ('flash_fwd_sm90_kernel', 'phase11 render')}
            print(f'parallel: trace {files} ({os.path.getsize(files[0]) if files else 0} '
                  f'bytes) names ' + json.dumps(named), flush=True)
            if all(named.values()):
                break
        else:
            fail('the trace names neither K1 nor the annotated range')
        del pipe, want, got, dargs
        torch.cuda.empty_cache()
    finally:
        teardown_distributed()
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
        shutil.rmtree(root, ignore_errors=True)
    mesh = make_mesh()  # with no group: a mesh of one rank, what use_mesh() takes alone
    print(f'parallel: make_mesh() with no group: {mesh}', flush=True)
    if tuple(mesh.shape) != (1, 1):
        fail(f'make_mesh() with no group gave {mesh}')
    print(f'parallel: phase 11 in {time.time() - t0:.1f} s', flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the workflow tools on the card
# ---------------------------------------------------------------------------

# one student step of tools/overfit_run at its defaults, whose TrainConfig
# keeps remat off as the JAX tool's does: each of the 24 attention sites
# runs K3 and K1/K2 with the logsumexp in the forward, then K3 again and K8
# in the backward; the DPT head's K4 x3 and K5, and K4^T for the VJP of each
OVERFIT_LAUNCHES = _launches(flash_fwd_rope_mask=18, flash_fwd_rope_nomask=6,
                             rot_kv_broadcast=48, flash_bwd_mask=18, flash_bwd_nomask=6,
                             resize_bilinear=3, resize_bilinear_t=4, resize_s2d=1)
OVERFIT_FRAMES = 8                    # the JAX tool's 8 orbit frames of cbox
# gt_noise_sweep cut to the phase's time (the tool: 256^2, 1024-spp
# reference, spp 8..256, clamp 10); at clamp 10 cbox's clamped and unclamped
# references are the same image once clipped to [0, 1] (an infinite bias),
# so the clamp here is 1, where it bites
SWEEP_RES, SWEEP_REF_SPP, SWEEP_SPPS, SWEEP_CLAMP = 64, 512, (8, 32, 128), 1.0


def run_tool(main, argv):
    """(exit code, printed lines) of a tool's main(argv), its lines echoed."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f'  | {ln}', flush=True)
    return rc, lines


def overfit_checks(card, frames, root):
    """(a) tools/overfit_run at its defaults on v1-base at full width and
    depth: the teacher (the seeded init) renders the 8 frames' ground truth
    through the plain versions in fp32, the student (the teacher plus the
    JAX tool's noise) fine-tunes 8 epochs x 8 steps through the trainer and
    the dataset (in memory, as the JAX tool keeps them), bf16 with the fp32 view stage;
    every step launches exactly OVERFIT_LAUNCHES (counts set to 0 just
    before it, read just after), and the JAX pass condition holds.  Then the
    timings of the student's step (step_speed).  Returns the first step's
    launches."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.tools import overfit_run
    args = overfit_run.build_parser().parse_args(['--workdir', os.path.join(root, 'overfit')])
    counts, bad, steps = [], [], []

    def hook(tr):
        step = tr._train_step
        steps.append(step)

        def counted(state, batch):
            torch.cuda.synchronize()
            reset_launch_counts()
            out = step(state, batch)
            torch.cuda.synchronize()
            counts.append(dict(LAUNCHES))
            if counts[-1] != OVERFIT_LAUNCHES:
                bad.append((len(counts) - 1, counts[-1]))
            return out

        tr._train_step = counted

    t = time.time()
    res = overfit_run.run(args, frames=frames, trainer_hook=hook,
                          log=lambda *a: print('overfit:', *a, flush=True))
    out, tr = res['out'], res['trainer']
    print('overfit ' + json.dumps(out), flush=True)
    print(f'overfit: step 0 launches ' + json.dumps(counts[0] if counts else {}), flush=True)
    if len(counts) != out['steps_total'] or bad:
        fail(f'overfit: {len(counts)} of {out["steps_total"]} steps counted; steps off '
             f'{OVERFIT_LAUNCHES}: {bad[:2]}')
    losses = out['losses']
    rays = out['steps_total'] * out['resolution'] ** 2 / res['fit_s']
    print(f'overfit: {out["preset"]} {out["epochs"]} epochs x {out["scenes"]} steps at '
          f'{out["resolution"]}^2 ({out["padding_length"]} triangles a scene, {out["precision"]} '
          f'with the fp32 view stage): epoch losses {losses}, recovery ratio '
          f'{out["recovery_ratio"]:.4f} (pass: all finite, last < 0.5 x first, epochs 3.. below '
          f'the first: {res["ok"]}); every step exactly {json.dumps({k: v for k, v in OVERFIT_LAUNCHES.items() if v})}; '
          f'fit {res["fit_s"]:.2f} s, {rays:.1f} trained rays/s; the whole run '
          f'{time.time() - t:.1f} s, on {card}', flush=True)
    if not res['ok']:
        fail(f'overfit: the student did not converge: {losses}')
    batch = tr._put(tr._host(next(tr.dataset.batches([0], 1, shuffle=False))))
    step_speed(card, OVERFIT, steps[0], tr.state, batch,
               {'recovery_ratio': out['recovery_ratio'], 'fit_s': res['fit_s']},
               res=out['resolution'])
    tr.dataset.close()
    del res, tr, batch
    torch.cuda.empty_cache()
    return counts[0]


def verify_checks(card, keep):
    """(b) tools/verify_checkpoint on phase 8's HF and jax_format
    directories with the golden image the seeded pipeline wrote: steps 1, 2
    and 4 pass, step 3 says it is skipped, exit code 0, and the count is
    the JAX param_count of v1-base."""
    import torch
    from renderformer_tpu_torch.config import PRESETS
    from renderformer_tpu_torch.models.renderformer import RenderFormer
    from renderformer_tpu_torch.tools import verify_checkpoint
    with torch.device('meta'):
        model = RenderFormer(PRESETS[BASE])
    n = verify_checkpoint.param_count(model)
    n_par = sum(p.numel() for p in model.parameters())
    golden = os.path.join(keep, 'golden.exr')
    for name in ('hf', 'jax_format'):
        t = time.time()
        rc, lines = run_tool(verify_checkpoint.main,
                             ['--checkpoint', os.path.join(keep, name), '--golden_exr', golden])
        text = '\n'.join(lines)
        want = [f'params: {n / 1e6:.1f}M', '[1/4] loaded', 'finite=True',
                '[3/4] torch parity: skipped', '(OK at the >30dB', 'checkpoint verified OK']
        missing = [w for w in want if w not in text]
        print(f'verify: {name} directory: exit code {rc} in {time.time() - t:.1f} s; '
              f'{n:,} parameters counted ({n_par:,} parameters and {n - n_par} RoPE '
              f'frequency elements, as the JAX param_count), on {card}', flush=True)
        if rc != 0 or missing:
            fail(f'verify_checkpoint on the {name} directory: exit code {rc}, lines '
                 f'missing {missing}')


def precision_checks(card, frame):
    """(c) tools/precision_study on v1.1-swin-large at full width and depth
    from the seeded init, PRECISION_RES^2, frame 0 of the cbox orbit padded
    to PRECISION_PAD: each of its three renders launches exactly a
    swin-large render's kernels (counts set to 0 just before it, read just
    after) with its stages' weights in the dtypes of its precisions, and
    the six PSNRs are finite.  Returns each render's launches by path."""
    import torch
    from renderformer_tpu_torch import RenderingPipeline
    from renderformer_tpu_torch.io.h5 import pad_scene
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.pipelines.rendering_pipeline import _DTYPES
    from renderformer_tpu_torch.tools import precision_study
    t = time.time()
    pipe = RenderingPipeline.from_pretrained(SWIN)
    real, seen = pipe.render, []

    def counted(*a, precision, view_precision, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        img = real(*a, precision=precision, view_precision=view_precision, **kw)
        torch.cuda.synchronize()
        model = pipe._model_for(_DTYPES[precision], _DTYPES[view_precision])
        dts = (next(model.transformer.parameters()).dtype,
               next(model.view_transformer.parameters()).dtype)
        seen.append((precision, view_precision, dict(LAUNCHES), dts))
        return img

    pipe.render = counted
    out, _ = precision_study.study(pipe, pad_scene(frame, PRECISION_PAD), PRECISION_RES, SWIN,
                                   h5='cbox orbit frame 0, in memory')
    print('precision ' + json.dumps(out), flush=True)
    for p, vp, launches, dts in seen:
        print(f'precision: {SWIN} {p} / view {vp}: weights {[str(d) for d in dts]}, launches '
              + json.dumps({k: v for k, v in launches.items() if v}), flush=True)
        if launches != EXPECTED_LAUNCHES[SWIN] or dts != (_DTYPES[p], _DTYPES[vp]):
            fail(f'precision_study {p}/{vp}: launches {launches} or weight dtypes {dts}')
    psnrs = [v for k in ('psnr_hdr', 'psnr_ldr_pbr_neutral') for v in out[k].values()]
    if len(seen) != 3 or not all(np.isfinite(psnrs)):
        fail(f'precision_study: {len(seen)} renders, PSNRs {psnrs}')
    print(f'precision: {SWIN} at {PRECISION_RES}^2, {out["n_tris"]} triangles: three renders '
          f'in {time.time() - t:.1f} s (the seeded init included), on {card}', flush=True)
    del pipe
    torch.cuda.empty_cache()
    return {PRECISION_PATHS[p, vp]: launches for p, vp, launches, _ in seen}


def sweep_checks(card, frame):
    """(d) tools/gt_noise_sweep on cbox's orbit frame 0 at the cut of
    SWEEP_*: the unclamped PSNR rises at each spp step, the clamp's bias is
    finite."""
    from renderformer_tpu_torch.io.h5 import pad_scene
    from renderformer_tpu_torch.tools import gt_noise_sweep
    t = time.time()
    rows, biases = gt_noise_sweep.sweep(
        [('cbox', pad_scene(frame))], SWEEP_RES, SWEEP_REF_SPP, SWEEP_SPPS, SWEEP_CLAMP,
        log=lambda s: print(f'sweep: {s}', flush=True))
    secs = time.time() - t
    spp = 2 * (SWEEP_REF_SPP + sum(SWEEP_SPPS))
    print(f'sweep: {len(rows)} rows and 2 references at {SWEEP_RES}^2 in {secs:.1f} s '
          f'({spp * SWEEP_RES ** 2 / secs / 1e6:.3f} M path samples/s), on {card}', flush=True)
    unclamped = [r[2] for r in rows]
    if not all(b > a for a, b in zip(unclamped, unclamped[1:])) or not np.isfinite(biases[0][1]):
        fail(f'gt_noise_sweep: unclamped PSNRs {unclamped} do not rise, or the bias '
             f'{biases} is not finite')


def compare_checks(keep):
    """(e) tools/compare_renders on the golden image and a copy of it
    written again: PSNR inf, max|diff| 0, exit code 0."""
    from renderformer_tpu_torch.io.image import read_exr, write_exr
    from renderformer_tpu_torch.tools import compare_renders
    golden, copy = os.path.join(keep, 'golden.exr'), os.path.join(keep, 'golden_again.exr')
    write_exr(copy, read_exr(golden))
    rc, lines = run_tool(compare_renders.main, [golden, copy])
    if rc != 0 or not lines or not lines[0].startswith('PSNR: inf dB') \
            or 'max|diff|=0.000e+00' not in lines[0]:
        fail(f'compare_renders on an image and its copy: exit code {rc}, {lines}')


def tool_checks(card, keep):
    """Phase 12: the workflow tools on the card, (a) to (e); returns the
    launches of TOOL_PATHS (the kernels at their shapes are rows of phases
    3 and 6)."""
    from renderformer_tpu_torch.tools import make_video_frames
    t0 = time.time()
    frames = make_video_frames.orbit_frames(os.path.join(EXAMPLES, 'cbox.json'),
                                            OVERFIT_FRAMES, 360.0)
    print(f'tools: {OVERFIT_FRAMES} cbox orbit frames in memory, '
          f'{frames[0]["triangles"].shape[0]} triangles ({time.time() - t0:.1f} s)', flush=True)
    launches = {OVERFIT: overfit_checks(card, frames, keep)}
    print(f'tools: (a) done ({time.time() - t0:.1f} s)', flush=True)
    verify_checks(card, keep)
    print(f'tools: (b) done ({time.time() - t0:.1f} s)', flush=True)
    launches.update(precision_checks(card, frames[0]))
    print(f'tools: (c) done ({time.time() - t0:.1f} s)', flush=True)
    sweep_checks(card, frames[0])
    print(f'tools: (d) done ({time.time() - t0:.1f} s)', flush=True)
    compare_checks(keep)
    print(f'tools: phase 12 in {time.time() - t0:.1f} s on {card}', flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the ft128 fine-tune cycle from files
# ---------------------------------------------------------------------------

FT_SCENES = 24                    # the first scene JSONs of datasets/ft128/json, sorted
FT_JSON = os.path.join('datasets', 'ft128', 'json')
FT_CONFIG = os.path.join('configs', 'config_tpu_finetune.yml')
FT_MAX_TRIS = 3585                # random_scene_110_3k, the largest of the cut
FT_PAD = 3712                     # the dataset's bucket: 3,585 rounded up to 128
FT_SK = FT_PAD + 16               # the step's keys: triangles + register tokens
FT_INFER_TRIS = 1793              # random_scene_0_sphere3, the first file, infer's scene
FT_INFER_SK = FT_INFER_TRIS + 16
# keys kept in batch_infer's second batch (natural order: random_scene_105 to
# 113), the cut's two largest scenes among them; phase 3's rows mask so
FT_BATCH_KEPT = tuple(16 + n for n in (525, 525, 3113, 1793, 3585, 549, 525, 1793))
FT_SCRATCH = os.path.join(HERE, 'build', 'ft128')   # .gitignore lists build/
FT_PROBED = ('h5py', 'yaml', 'cv2', 'matplotlib', 'torch.utils.tensorboard')
FT_BLOCKED = ('h5py', 'yaml')


class _Blocked:
    """A sys.meta_path finder that makes FT_BLOCKED unimportable."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FT_BLOCKED:
            raise ImportError(f'{name} made unimportable for phase 13')
        return None


def ft_config(root):
    """configs/config_tpu_finetune.yml with h5_dir, checkpoint_dir and log_dir
    under ``root`` and a checkpoint every epoch, written as a YAML file;
    every other line as it is (gt_dir stays datasets/ft128/gt)."""
    import re
    with open(os.path.join(HERE, FT_CONFIG)) as f:
        text = f.read()
    for key, value in (('h5_dir', os.path.join(root, 'h5')),
                       ('checkpoint_dir', os.path.join(root, 'checkpoints')),
                       ('log_dir', os.path.join(root, 'runs')), ('save_interval', '1')):
        text, n = re.subn(rf'^(\s*{key}:).*$', rf'\g<1> "{value}"' if key != 'save_interval'
                          else rf'\g<1> {value}', text, flags=re.M)
        if n != 1:
            fail(f'{FT_CONFIG}: {n} lines of {key}')
    path = os.path.join(root, 'config_ft128.yml')
    with open(path, 'w') as f:
        f.write(text)
    return path


def counted_renders(rendered):
    """RenderingPipeline.render wrapped: each call's launches (counts set to
    0 just before it, read just after) and its output on the host are
    appended to ``rendered``; returns the function that restores it."""
    import torch
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from renderformer_tpu_torch.pipelines.rendering_pipeline import RenderingPipeline
    real = RenderingPipeline.render

    def render(self, *a, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = real(self, *a, **kw)
        torch.cuda.synchronize()
        rendered.append((dict(LAUNCHES), out.cpu().numpy()))
        return out

    RenderingPipeline.render = render
    return lambda: setattr(RenderingPipeline, 'render', real)


def ft_convert(root):
    """(a) the first FT_SCENES JSONs converted from the repo root by the
    generator's function into ``root``/h5, each read back through
    io/h5.load_scene_h5 against scene_tensors of the same JSON; returns the
    files and their triangle counts by scene name."""
    from renderformer_tpu_torch.generate_dataset import scene_tensors
    from renderformer_tpu_torch.io.h5 import load_scene_h5
    from renderformer_tpu_torch.scene.h5_tools import save_dict_to_h5_renderformer_method
    names = sorted(f for f in os.listdir(os.path.join(HERE, FT_JSON)) if f.endswith('.json'))
    h5_dir = os.path.join(root, 'h5')
    os.makedirs(h5_dir)
    files, tris, t_write, t_check = [], [], 0.0, 0.0
    for name in names[:FT_SCENES]:
        with open(os.path.join(HERE, FT_JSON, name)) as f:
            scene = json.load(f)
        path = os.path.join(h5_dir, name[:-len('.json')] + '.h5')
        t = time.perf_counter()
        save_dict_to_h5_renderformer_method(scene, path, '')
        t_write += time.perf_counter() - t
        t = time.perf_counter()
        got, want = load_scene_h5(path), scene_tensors(scene)
        t_check += time.perf_counter() - t
        bad = [k for k in want if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
               or got[k].tobytes() != want[k].tobytes()]
        if bad:
            fail(f'ft128: {path} read back differs from scene_tensors in {bad}')
        files.append(path)
        tris.append(got['triangles'].shape[0])
    sizes = [os.path.getsize(p) for p in files]
    print(f'ft128: the cut: the first {len(files)} of {len(names)} scene JSONs of {FT_JSON} '
          f'(sorted) converted by scene/h5_tools.save_dict_to_h5_renderformer_method in '
          f'{t_write:.1f} s ({t_write / len(files):.2f} s a scene), {min(tris)}-{max(tris)} '
          f'triangles, {sum(sizes)} bytes of H5 ({min(sizes)}-{max(sizes)} a file); each read '
          f'back through io/h5.load_scene_h5 the bits of scene_tensors of its JSON '
          f'({t_check:.1f} s with the second conversion)', flush=True)
    if max(tris) != FT_MAX_TRIS:
        fail(f'ft128: the cut\'s largest scene has {max(tris)} triangles, not {FT_MAX_TRIS}')
    return files, {os.path.splitext(os.path.basename(p))[0]: n for p, n in zip(files, tris)}


def ft_fit(card, root):
    """(b) train.main(['-c', ft_config(root)]): every step's launches exactly
    phase 7's fused rope counts with remat, finite losses, the four
    checkpoints; returns (a step's launches, the fit's numbers)."""
    import torch
    from renderformer_tpu_torch import train
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    counts, bad, step_s, epoch_s, trainers = [], [], [], [], []

    def hook(tr):
        step, epoch = tr._train_step, tr.train_epoch

        def counted(state, batch):
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            counts.append(dict(LAUNCHES))
            if counts[-1] != EXPECTED_LAUNCHES[FT128]:
                bad.append((len(counts) - 1, counts[-1]))
            return out

        def timed(e, indices):
            t = time.perf_counter()
            out = epoch(e, indices)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t)
            return out

        tr._train_step, tr.train_epoch = counted, timed
        trainers.append(tr)

    real_build = train.build

    def build(*a, **kw):
        tr = real_build(*a, **kw)
        hook(tr)
        return tr

    config = ft_config(root)
    train.build = build
    t = time.perf_counter()
    try:
        rc = train.main(['-c', config])
    finally:
        train.build = real_build
    fit_s = time.perf_counter() - t
    if rc != 0 or not trainers:
        fail(f'ft128: train.main exit code {rc}')
    tr = trainers[0]
    ds = tr.dataset
    n_train = len(ds.split(tr.cfg.train_val_split, tr.cfg.seed)[0])
    print(f'ft128: the bucket: {len(ds)} scenes padded to {ds.padding_length} triangles '
          f'({ds.padding_length + 16} keys with the register tokens), {n_train} to train, '
          f'{len(ds) - n_train} to validate', flush=True)
    if ds.padding_length != FT_PAD:
        fail(f'ft128: the bucket is {ds.padding_length} triangles, not {FT_PAD}')
    metrics = [(m['loss'], m['grad_norm']) for m in tr.step_metrics]
    res = tr.tc.resolution
    print(f'ft128: train.main -c {os.path.relpath(config, HERE)}: exit code {rc}; '
          f'{len(counts)} steps, each ' + json.dumps(counts[0] if counts else {}), flush=True)
    print(f'ft128: epoch losses {tr.train_losses}, validation {tr.val_losses}; step losses '
          f'{[round(m[0], 6) for m in metrics]}', flush=True)
    if len(counts) != tr.tc.num_epochs * n_train or bad:
        fail(f'ft128: {len(counts)} steps counted; steps off {EXPECTED_LAUNCHES[FT128]}: '
             f'{bad[:2]}')
    if not (np.isfinite(np.array(metrics)).all() and np.isfinite(tr.train_losses).all()
            and np.isfinite(tr.val_losses).all() and len(tr.val_losses) == tr.tc.num_epochs):
        fail('ft128: a non-finite loss, grad norm or validation loss')
    ckpt = tr.cfg.checkpoint_dir
    missing = [k for k in ('best', 'epoch_0', 'epoch_1', 'final')
               if not os.path.exists(os.path.join(ckpt, k, 'state.pt'))]
    print(f'ft128: checkpoints {sorted(os.listdir(ckpt))}, missing {missing}', flush=True)
    if missing:
        fail(f'ft128: checkpoints {missing} missing')
    med = statistics.median(step_s[n_train:])   # epoch 1: the scenes decoded and cached
    numbers = {'fit_s': fit_s, 'step_ms': med * 1e3, 'steps': len(counts),
               'epoch_s': epoch_s, 'rays_per_s_step': res ** 2 / med,
               'rays_per_s_epoch1': n_train * res ** 2 / epoch_s[1],
               'train_losses': tr.train_losses, 'val_losses': tr.val_losses}
    print(f'ft128: a step {med * 1e3:.2f} ms (median of epoch 1, each step synchronized and '
          f'counted; {res ** 2 / med:.1f} trained rays/s at {res}^2); epoch 1 {epoch_s[1]:.2f} s '
          f'for {n_train} steps ({numbers["rays_per_s_epoch1"]:.1f} trained rays/s with the '
          f'loader), epoch 0 {epoch_s[0]:.2f} s; train.main {fit_s:.1f} s (the seeded init, '
          f'validation and checkpoints included), on {card}', flush=True)
    ds.close()
    del trainers, tr
    torch.cuda.empty_cache()
    return counts[0], numbers


def ft_render_checks(card, root, files, tris):
    """(c) infer.main on one file and batch_infer.main over the folder, each
    render exactly a v1-base render's launches at the shapes of phase 3's
    ft128 rows, the EXR and PNG files read back equal to the render;
    render_h5_to_png.main as a raster and path traced at 4 spp, no kernel
    launched, a PNG of the image's shape.  Returns the launches of one
    render of each of FT_INFER and FT_BATCH."""
    import torch
    from renderformer_tpu_torch import batch_infer, infer, render_h5_to_png
    from renderformer_tpu_torch.io.image import read_exr, read_png
    from renderformer_tpu_torch.ops import LAUNCHES, reset_launch_counts
    h5_dir = os.path.dirname(files[0])

    def read_back(name, out_dir, base, hdr):
        exr = read_exr(os.path.join(out_dir, f'{base}_view_0.exr'))
        png = read_png(os.path.join(out_dir, f'{base}_view_0.png'))
        hdr = hdr.astype(np.float32)
        if not (np.isfinite(exr).all() and exr.tobytes() == hdr.tobytes()
                and np.array_equal(png, infer.to_ldr(hdr))):
            fail(f'ft128: {name}: {base} read back differs from its render')

    rendered = []
    restore = counted_renders(rendered)
    try:
        out_dir = os.path.join(root, 'infer')
        t = time.perf_counter()
        rc = infer.main(['--h5_file', files[0], '--model_id', BASE, '--output_dir', out_dir])
        infer_s = time.perf_counter() - t
        if rc != 0 or len(rendered) != 1:
            fail(f'ft128: infer exit code {rc}, {len(rendered)} renders')
        launches, hdr = rendered[0]
        print(f'ft128: infer --h5_file {os.path.basename(files[0])}: exit code {rc} in '
              f'{infer_s:.1f} s (the seeded init included), {hdr.shape} '
              + json.dumps(launches), flush=True)
        if launches != EXPECTED_LAUNCHES[BASE]:
            fail(f'ft128: infer launches {launches} != {EXPECTED_LAUNCHES[BASE]}')
        infer_tris = tris[os.path.splitext(os.path.basename(files[0]))[0]]
        if hdr.shape != (1, 1, RES, RES, 3) or infer_tris != FT_INFER_TRIS:
            fail(f'ft128: infer rendered {hdr.shape} of {infer_tris} triangles, not the '
                 f'shapes of phase 3\'s ft128_infer rows')
        ran = {FT_INFER: launches}
        read_back('infer', out_dir, os.path.splitext(os.path.basename(files[0]))[0],
                  hdr[0, 0])
        rendered.clear()
        out_dir = os.path.join(root, 'batch')
        t = time.perf_counter()
        rc = batch_infer.main(['--h5_folder', h5_dir, '--model_id', BASE, '--output_dir',
                               out_dir, '--padding_length', str(FT_PAD)])
        batch_s = time.perf_counter() - t
        per = [l for l, _ in rendered]
        print(f'ft128: batch_infer over {len(files)} files: exit code {rc} in {batch_s:.1f} s '
              f'(the seeded init included), {len(rendered)} renders of '
              f'{[o.shape[0] for _, o in rendered]} scenes, each ' + json.dumps(per[0]),
              flush=True)
        if rc != 0 or sum(o.shape[0] for _, o in rendered) != len(files) \
                or any(l != EXPECTED_LAUNCHES[BASE] for l in per):
            fail(f'ft128: batch_infer exit code {rc} or launches {per}')
        names = batch_infer_order(h5_dir)
        kept = tuple(16 + tris[n] for n in names[V:2 * V])
        if any(o.shape[:2] != (V, 1) or o.shape[2:4] != (RES, RES) for _, o in rendered) \
                or kept != FT_BATCH_KEPT:
            fail(f'ft128: batch_infer rendered {[o.shape for _, o in rendered]}, its second '
                 f'batch keeps {kept} keys: not the shapes of phase 3\'s ft128_batch rows')
        ran[FT_BATCH] = per[0]
        order = iter(names)
        for _, out in rendered:
            for i in range(out.shape[0]):
                read_back('batch_infer', out_dir, next(order), out[i, 0])
        if not os.path.exists(os.path.join(out_dir, 'video.mp4')):
            fail('ft128: batch_infer wrote no video.mp4')
    finally:
        restore()
    for flags, suffix in (([], 'raster'), (['--pathtrace', '--spp', '4'], 'pathtrace')):
        png = os.path.join(root, f'h5_to_png_{suffix}.png')
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        render_h5_to_png.main([files[0], '--output', png] + flags)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launched = {k: v for k, v in LAUNCHES.items() if v}
        img = read_png(png)
        print(f'ft128: render_h5_to_png {suffix}: {img.shape} in {secs:.2f} s, mean '
              f'{img.mean():.2f}, kernels launched {launched}, on {card}', flush=True)
        if launched or img.shape != (256, 256, 3) or not img.any():
            fail(f'ft128: render_h5_to_png {suffix}: launches {launched} or image '
                 f'{img.shape} empty')
    return ran


def batch_infer_order(h5_dir):
    """The scene names in the order batch_infer renders them."""
    from renderformer_tpu_torch.io.h5 import list_scene_files
    return [os.path.splitext(os.path.basename(p))[0] for p in list_scene_files(h5_dir)]


def ft128_checks(card):
    """Phase 13 with h5py and PyYAML unimportable: (a) the cut of ft128
    written as H5 files by the port and read back, (b) train.main -c from
    the YAML, (c) infer, batch_infer and render_h5_to_png from the files.
    Returns the launches of one fit step and of one render of each of infer
    and batch_infer, by path."""
    t0 = time.time()
    probe = ('import importlib, json\nout = {}\n'
             f'for name in {FT_PROBED!r}:\n'
             '    try:\n        importlib.import_module(name)\n        out[name] = True\n'
             '    except Exception:\n        out[name] = False\nprint(json.dumps(out))\n')
    res = subprocess.run([sys.executable, '-c', probe], capture_output=True, text=True,
                         timeout=300)
    print(f'ft128: import on this machine: {res.stdout.strip() or res.stderr.strip()[-300:]}',
          flush=True)
    already = sorted(m for m in sys.modules if m.split('.')[0] in FT_BLOCKED)
    if already:
        fail(f'ft128: {already} imported before phase 13')
    blocker = _Blocked()
    sys.meta_path.insert(0, blocker)
    shutil.rmtree(FT_SCRATCH, ignore_errors=True)
    os.makedirs(FT_SCRATCH)
    try:
        with contextlib.chdir(HERE):   # the JSONs and the YAML name paths from the repo root
            files, tris = ft_convert(FT_SCRATCH)
            print(f'ft128: (a) done ({time.time() - t0:.1f} s)', flush=True)
            launches, numbers = ft_fit(card, FT_SCRATCH)
            print(f'ft128: (b) done ({time.time() - t0:.1f} s)', flush=True)
            ran = ft_render_checks(card, FT_SCRATCH, files, tris)
        imported = sorted(m for m in sys.modules if m.split('.')[0] in FT_BLOCKED)
        if imported:
            fail(f'ft128: {imported} imported during phase 13')
    finally:
        sys.meta_path.remove(blocker)
        shutil.rmtree(FT_SCRATCH, ignore_errors=True)
    print('ft128 ' + json.dumps({**numbers, 'seconds': time.time() - t0}), flush=True)
    print(f'ft128: phase 13 in {time.time() - t0:.1f} s on {card}', flush=True)
    return {FT128: launches, **ran}


def _times(weighted):
    """ms, plain_ms, bound_ms and library_ms of (row, launches) pairs: each
    row's median times its launches, summed; library_ms None where a row has
    no library call."""
    lib = [r['library_ms'] for r, _ in weighted]
    return dict(ms=sum(r['ms'] * n for r, n in weighted),
                plain_ms=sum(r['plain_ms'] * n for r, n in weighted),
                bound_ms=sum(r['bound_ms'] * n for r, n in weighted),
                library_ms=(None if any(x is None for x in lib) else
                            sum(x * n for x, (_, n) in zip(lib, weighted))))


def kernel_summary(rows, launches):
    """One entry a kernel: its launches in each path's run, and its times
    summed over the shapes and dtypes each path runs it at (a row's per_run
    launches times its median ms), totalled over the paths and per path;
    max_abs_err over every row of the kernel, fp32 and bf16."""
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r['kernel'] == name]
        for p in ALL_PATHS:
            if launches[p][name] and not any(p in r['per_run'] for r in mine):
                fail(f'{name} was launched on {p!r}, where no row measured it')
            counted = sum(r['per_run'].get(p, 0) for r in mine)
            if counted != launches[p][name]:
                fail(f'{name} on {p!r}: its rows count {counted} launches, the run '
                     f'{launches[p][name]}')
        on_path = [(r, sum(r['per_run'].values())) for r in mine if r['per_run']]
        total = _times(on_path)
        by_ops = sum(r['bound_ms'] * n for r, n in on_path if r['bound_by'] == 'operations')
        kernels.append(dict(
            name=name, **meta, launches=sum(launches[p][name] for p in ALL_PATHS),
            launches_by_path={p: launches[p][name] for p in ALL_PATHS},
            max_abs_err=max(r['max_abs_err'] for r in mine), **total,
            bound_by='operations' if by_ops * 2 > total['bound_ms'] else 'bytes',
            by_path={p: _times([(r, r['per_run'][p]) for r in mine if p in r['per_run']])
                     for p in ALL_PATHS}))
    return kernels


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('no CUDA device: this smoke run needs one GPU')
    if not os.path.isdir(os.path.join(HERE, 'renderformer_tpu_torch')):
        fail('renderformer_tpu_torch/ is not beside this script')
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f'card: {card}', flush=True)
    print(f'card: torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    from renderformer_tpu_torch import _build
    t = time.time()
    path = _build.build(verbose=True)
    _build.library()
    print(f'build: {path} in {time.time() - t:.1f} s', flush=True)
    sass_check(path)

    rows = kernel_checks()
    launches = {preset: render_checks(card, preset) for preset in PATHS}
    rows += train_kernel_checks()
    launches.update(train_checks(card))
    launches.update(train_nerf_checks(card))
    launches.update(train_swin_checks(card))
    keep = tempfile.mkdtemp(prefix='rf_smoke_')  # phase 8's checkpoints for phase 12
    try:
        entry_point_checks(card, keep)
        fit_checks(card)
        scene_checks(card)
        launches.update(parallel_checks(card, rows))
        launches.update(tool_checks(card, keep))
        launches.update(ft128_checks(card))
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    for name in KERNELS:
        if not any(launches[p][name] for p in ALL_PATHS):
            fail(f'{name} was launched by no path')

    print(json.dumps({'kernels': kernel_summary(rows, launches)}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
