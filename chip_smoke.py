#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which must pass (else the script exits non-zero and prints
no result):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every CUDA kernel from ``cross_attention_renderer_torch/
     csrc`` with one ``nvcc`` each, all at once, and prints what ``ptxas -v``
     says of the exchange core's instantiations, K2, K3, K9 and K4 (each
     in both plans and types, and K2, K3 and K4 with int8 tables too)
     (registers, barriers, spills, any note of serialised wgmma), and of
     the row gathers' (the copy and bulk gathers of T1-T5, T7-T10, T12,
     T13, and the block fill of T6 and T11) and the bilinear gather's
     (K5-K8, one a depth and output type): registers and spills; from
     here on every launch of the exchange core (K2, K3, K4, K9) is held to
     ``core_plan`` (``watch_core_plans``): the first launch at each set of
     widths logs its plan and stage slots a ring beside ``core_plan``'s,
     and a difference fails the run;
  3. V=2 main path: the flagship renderer (122M DPT-hybrid, bf16 compute, f32
     parameters from a seeded initialiser; the decoder's output layer is
     drawn at 1/64 of its scale, since an untrained decoder has no image
     range to check against) encodes two 256x256 views and renders the full
     65,536-ray image in 8 blocks of 8,192 rays, with the kernels' launch
     counters set to 0 just before and read just after (16 attention
     launches, 8 epilogue launches and 8 stream takes launches, the
     address math, per image); the image must be finite
     with RGB in [-1, 1.5] and some valid rays; then the encode and
     whole-image times and a profile of one image;
  4. V=2 kernel checks: each kernel against its plain PyTorch version, on
     the inputs of the main path's first ray block, with the tolerance stated
     below, and the times of both beside the least time the card could take
     (``bound_ms``); K2 is timed as its launch alone, its weights laid out
     once before the timed calls, and its launch shape (grid, block, cluster,
     stage slots, shared memory) is printed; the stream takes kernel's
     cells and aux equal to its plain version's bit for bit, its launch
     timed alone (in a CUDA graph) beside its bytes bound, its whole call
     and the plain version beside it;
  5. V=2 small-input agreement: a narrow model renders a small scene with
     the kernels in bf16 on the card and with the plain versions in f32 on
     the CPU; the images must agree within the stated tolerance;
  5b. V=2 fused render (K4): the same model and scene as phase 3 with
     ``fused_render=True`` (8 fused render core launches, and no attention
     or epilogue launch, per image); the same image checks; K4 against its
     plain version on the first block's inputs, timed as its launch alone
     (weights laid out before the timed calls), with its launch shape; the
     image, and the first
     block's attention weights and depth, against phase 3's staged render
     within the stated tolerance; then the small-input agreement;
  6. V=3 default path (Path A): the same as phase 3 for three views at 48
     samples (16 attention, 8 multi-stream epilogue and 8 stream takes
     launches per image), then K3 (timed as K2 in phase 4), K1 at V*P =
     144 and the stream takes kernel at three streams (as in phase 4),
     against their plain versions;
  7. V=3 reference-compatible path (Path B, ``reference_exchange_compat``
     with the fused MLP): the same image checks (16 attention and 72 fused
     MLP launches per image, 9 a block), then K9 against its plain version,
     timed as its launch alone, with its launch shape, beside the two
     ``torch.matmul`` products of the same function;
  8. V=3 small-input agreement for both V=3 paths, as phase 5;
  9. V=2 sorted stream (K5): phase 3's model and scene with
     ``sorted_stream=True`` (48 resident-gather and 16 attention launches,
     and no epilogue or render core launch, per image); the image, and the
     first block's attention weights and depth, against phase 3's staged
     render within the stated tolerance; K5 against its plain version on
     the first block's self- and cross-stream inputs of each level, K6 on
     the self-stream ones (no path launches K6); the small-input agreement;
 10. V=3 sorted stream: phase 6's model with ``sorted_stream=True`` (48
     K5, 16 attention and no multi-stream epilogue launches per image), its
     image against phase 6's; the small-input agreement, also with
     ``reference_exchange_compat``;
 11. V=3 compat with the one-hot gather (K7): phase 7's model with
     ``gather='onehot'`` (48 one-hot gather, 16 attention and 72 fused MLP
     launches per image), its image against phase 7's; K7 against its
     plain version on the first block's inputs of each level;
 12. K8: the banded gather against its plain version on the V=2 level-0
     table (2x64x64x256 bf16, exactly the 4 MiB it is limited to) at phase
     9's first-block self-stream coordinates; the small-input agreement of
     the V=3 compat model with ``gather='banded'``, where every level is
     small enough for K8 (6 launches a forward);
 13. wide latents: K2, K3, K4 and K9 against their plain versions at
     fusion_features 384 and 512 (models of the flagship's widths but
     that one, the ViT cut to 2 blocks, on the first 4,096 rays), each
     printing the plan the exchange core took for it ('smem' or
     'global'); the small-input agreement at fusion_features 512 on the
     V=2, V=2 fused render and V=3 default paths;
 14. the 13 row-gather probes (T1-T13, the scripts of
     ``cross_attention_renderer_torch/tools/``): each instantiation equal
     to its plain version bit for bit, timed at the probe's shapes beside
     ``torch.index_select`` (a ``copy_`` for the fills) and its byte bound;
     a line a case with its time over ``index_select``'s, its share of the
     bound and the launch plan its kernel took (no speed gate);
 15. evaluation: ``evaluate_scene`` on the flagship V=2 image with LPIPS
     from seeded random VGG weights written by ``convert_weights``; its
     PSNR, SSIM and LPIPS on the card (cuDNN's TF32 off) against the same
     metrics of the same image on the CPU in f32;
 17. training, the flagship stage-1 step (``tools/bench_train.py``'s
     setting: the 122M model in bf16 from seed 0, batch 12 of 256x256
     scenes, 192 query rays, ``TrainConfig()``) on both routes of
     ``train/trainer.py``, each from the same parameters and batch: the
     default route (the train model clones the renderer with both kernel
     flags off: no K1 or K2 launch) and the kernel route
     (``CAR_TRAIN_KERNELS=1``: 2 K1 and 1 K2 launches a step, their
     gradients from the plain versions). The first step's loss and
     grad_norm must be finite; the two routes' first losses and each
     tensor's first gradient must agree within the stated bf16 tolerance;
     then each route is timed (one warm-up, 5 steps between CUDA events,
     peak memory allocated), after which every parameter must have
     changed, and one more step is profiled;
 18. ``fit``: 3 steps of a narrow model in bf16 into a temporary
     directory (a ``current`` checkpoint at step 2), then a fresh model
     resumed from it, whose step must reproduce the first run's third
     loss;
 19. stage 2: one flagship step at batch 4 on one 32x32 ray patch a scene
     (mask 1) with the depth and LPIPS terms (phase 15's random VGG
     weights): ``lpips_loss`` above 0, and a nonzero finite gradient at
     the VGG input.
 20. f32 models: the flagship model in f32 (the JAX CLI's default type)
     driven as phase 3 drives it on the V=2 (16 K1, 8 K2), V=2 fused render
     (8 K4), V=3 default (16 K1, 8 K3) and V=3 compat (16 K1, 72 K9)
     paths, the images checked as there; each kernel's f32 instantiation
     against its plain version in f32 on the first block's inputs, with
     the bf16 tolerances, and timed;
 21. the CLI's evaluation: a 2-scene corpus of 256x455 frames written by
     ``tools/make_corpus.py``, then ``cli/eval.py`` at its defaults (f32,
     8 ray blocks) on both scenes at ``--views 2`` and ``--views 3`` (16 K1
     and 8 K2 or K3 launches an image), each run's first scene against
     ``evaluate_scene`` of the same model and scene;
 22. ``cli/train.py`` at its defaults (f32, batch 12, 192 rays) for 3
     steps from the same corpus: finite losses, the final checkpoint;
 23. fast evaluation: ``make_fast_renderer`` (``train/evaluation.py``) with
     each lever alone (pruned 16,24 and 8,16; narrow 128,128,64; q8) and
     the CLI's ``--fast`` composition on the V=2, V=2 fused render and V=3
     default paths of the flagship in bf16, and q8 on the f32 flagship,
     each image driven as phase 3 drives it (per image: pruned 24 K1 and
     16 K2, or 16 K4, or 24 K1 and 16 K3; the other levers as dense),
     beside the dense image of the same model (the dense image timed and
     profiled, each bf16 lever's image timed between CUDA events, not
     profiled); the q8 image against the dense image of the dequantized pyramid and narrow at the full widths
     against the dense image (the path-vs-path tolerance); K2, K3 and K4's
     int8 instantiations, with bf16 and with f32 slot weights, against
     their plain versions at the flagship's shapes and at the pruned
     shapes of ``--fast``, and K1, K2, K3 and K4 at the pruned renderer's
     shapes (both passes), each timed;
 24. the other encoders, view counts and ablation flags, as phase 3
     drives the flagship (bf16, 256x256, 8 blocks, seed 0, the decoder's
     last layer at 1/64): the ResNet34 and U-Net models at V=2 on K2, at
     V=3 on K3 and in the fused render on K4 (each in its 4-level mode),
     the DPT model at V=4 on K3 (S = 4 streams) and K1 (V*P = 192) and at
     V=4 compat on K9, the DPT and U-Net models at V=1 on K1 (C = 576 and
     960), and the four ablation flags on the V=2 flagship; each image's
     launch counts and range, then its ms over one image timed between
     CUDA events (not profiled), and the image against the same model's
     unfused route (no K1-K4 or K9) within the path-vs-path tolerance;
     each new kernel mode and shape against its plain version on the
     path's first block, timed beside its bound (the U-Net fused
     render's K4 call repeated 20 times on its inputs, bit for bit); the
     small-input agreement of the sorted stream (K5) and the one-hot (K7)
     and banded (K8) gathers at V=4 and at four levels; one default-route
     train step of each new encoder (ms, peak GB); ``cli/train.py`` (2
     steps) and ``cli/eval.py`` (one scene) with ``--model resnet
     --no_sample``.
 25. the unposed path (``cli/render_unposed.py``) on a known-pose image
     pair of the value-noise world: the classical frontend on the card,
     its keypoints and matches against the same call on the CPU, its
     relative pose within 2 degrees and a direction cosine of 0.98 of the
     truth; SuperPoint and SuperGlue from seed-0 weights at 256x256, K =
     1024, 20 Sinkhorn iterations on the card against the same nets on
     the CPU (the tolerances below), each net's ms and ``estimate_pose``'s
     host ms; then ``render_unposed`` with the flagship in f32 (seed 0,
     decoder output at 1/64): 76 frames, 16 K1 and 8 K2 launches each,
     every frame finite with RGB in [-1, 1.5], frame 0 against phase 3's
     ``drive`` of the same scene (the path-vs-path tolerance), frames/s,
     ms a frame and the device-busy share of one profiled frame.
 26. the capability path (``tools/capability_run.py``, ``eval_pruned.py``,
     ``make_fast_eval_demo.py``): ``capability_run.run`` with the medium
     config (12.1M) on 32 plane worlds, 1,000 f32 steps on the trainer's
     default route (no K1 or K2 launch in training), an eval every 500
     steps (each one forward of the 64x64 held-out image: 2 K1 and 1 K2),
     every logged loss and gradient norm finite, the best held-out PSNR
     at least 15 dB; the last eval image (the best parameters) against
     the same weights on the plain route (no kernel) within the
     path-vs-path tolerance; the saved ``.npz`` reloaded into a fresh
     model renders the same image bit for bit; K1 and K2 in f32 at the
     eval's shape against their plain versions; then ``eval_pruned`` at
     its defaults in bf16 on 4 unseen plane worlds: every mode's PSNR
     finite, q8 within 0.2 dB of dense, each mode's launches an image
     (4 blocks: dense, uniform, narrow, q8 8 K1 and 4 K2; the pruned
     modes 12 and 8; no K4), K1 and K2 (bf16 and int8 tables) at the
     dense and pruned shapes against their plain versions, timed; then
     ``make_fast_eval_demo`` writes its strip under ``build/``.
 27. the parallel layer (``parallel/``, ``train.shard_state``,
     ``make_sharded_renderer``) with phase 3's flagship: in this process a
     1-rank NCCL group, its (1, 1, 1) mesh's 3 stage-1 steps (batch 12,
     192 rays) against 3 plain steps, and ``make_sharded_renderer`` on
     phase 3's first block of 8,192 rays (2 K1 and 1 K2) against that
     block of phase 3's image; then two processes on ``cuda:0`` over gloo
     (NCCL refuses two ranks on one card), each 3 steps at model = 2 and
     3 at data = 2 against the 1-rank mesh's, the two ranks' equal, and
     the render at rays = 2 of the first 16,384 rays (each rank 2 K1 and
     1 K2), gathered, against phase 3's first two blocks; then, on each
     rank at model = 2, 3 ``CAR_TRAIN_KERNELS=1`` steps (2 K1 and 1 K2 a
     step, K2 reading the exchange's sliced weights gathered over the
     model group) against the 3 plain steps as the meshes' steps are held,
     the sliced model rendering phase 3's first block through K2 on the
     gathered weights (2 K1 and 1 K2) against that block, and
     (``TP_RENDERS``) the V=2 fused render (1 K4), V=3 (2 K1 and 1 K3) and
     V=3 compat (2 K1 and 9 K9) flagships sliced the same way, each
     block against the same model unsliced within the path-vs-path
     tolerance. A failed rank fails the run.
 28. more than four context views (``VIEW_PATHS``), as phase 3 drives the
     flagship (bf16, 256x256, 8 blocks; the decoder's last layer a further
     sqrt(2 / V) smaller, as phase 24's): V=5 and V=6 on the default route
     (16 K1 and 8 K3 with S = 5 and 6 an image), and at V=5 the compat
     route with K9 (200 launches), the sorted stream (48 K5), the unfused
     exchange, f32, ResNet34 (K3's 4-level mode) and q8 (K3's int8 mode);
     each image against the same model's unfused route (16 blocks) within
     the path-vs-path tolerance (q8 against the dense image of its
     dequantized pyramid); each new K3 mode and K1 shape against its plain
     version on its path's first call (K1 at V*P = 240 and 288), K3 at
     S = 8 on a V=8 flagship's first block in bf16, f32 and int8, and at
     S = 4 and 6 on a V=4 and a V=6 one in f32 and int8, each printing
     its plan; the V=6 call repeated 20 times on its inputs, bit for bit;
     V=5 and V=6 images timed and profiled; the small-input agreement at
     V=5;
 29. the card tools ported from the JAX repository's ``tools/``
     (``TOOL_RUNS``): each run once in this process at its shortest
     setting, printing its lines (``bench_ondisk`` on phase 21's corpus);
 30. widths the kernels once refused (``WIDTH_PATHS``), as phase 3 drives
     the flagship: fusion_features 100 on V=2 (16 K1, 8 K2), its fused
     render (8 K4), V=3 (16 K1, 8 K3), V=3 compat (72 K9), V=2 sorted (48
     K5) and V=3 compat one-hot (48 K7); 102 on V=2 and V=3; 264 on V=3;
     narrow 100,50,30 on V=2; each image against the same model's unfused
     route, each kernel at its new widths against its plain version and
     timed beside its bound; K2 in f32 and int8 at 102 (a q8 image), K8 at
     C = 100 and in an ff=100 small-input render; then a seeded upstream
     ``.pth`` through ``tools/convert_checkpoint.py`` into ``cli/eval.py
     --checkpoint_path`` (16 K1, 8 K2), held to ``evaluate_scene``.
Then it prints the ``train`` JSON line (phases 17-19), the ``cli`` line
(phases 21-22), the ``fast_eval`` line (phase 23: each image's ms and
rays/s, the dense images' device busy, each path's launches), the
``ablations`` line (phase 24: each image's ms and rays/s),
the ``unposed`` line (phase 25), the ``capability`` line (phase 26: the
curve, steps/s, peak GB, each eval_pruned mode's dB, ms an image and
rays/s), the ``parallel`` line (phase 27: each mesh's losses, gradient
norms, ms a step and peak GB a rank, the renders' ms and launches a
rank), the ``views`` line (phase 28: the timed images, each path's
launches), the ``tools`` line (phase 29: seconds a run), the ``widths``
line (phase 30: each path's launches, the converted checkpoint's
metrics), the ``kernels`` JSON line (K1-K9, their f32 and int8
instantiations, the new modes and shapes of phases 24, 26, 28 and 30,
T1-T13; K1-K4's and K9's launches with phase 27's sharded renders and
kernel-route steps), the card line and, last, the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

H = W = 256
RAY_BLOCK = 8192
N_BLOCKS = (H * W) // RAY_BLOCK
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
BF16_TENSOR_FLOPS = 989e12      # dense bf16 tensor cores, published
F32_FLOPS = 67e12               # f32 outside the tensor cores, published
# Tolerances, as fractions of max(1, max |plain|): the kernel and its plain
# version read the same bf16 inputs and accumulate in f32 but round
# intermediates at different places (the plain versions round every
# product's output to bf16, the kernels keep f32 until the next product's
# input, and K3 sums the streams in f32 before it rounds once).
K1_TOL = {'out': 2 ** -7, 'at_wt': 2 ** -8}
K2_TOL = K3_TOL = K9_TOL = 2 ** -5
K4_TOL = {'z': 2 ** -5, 'at_wt': 2 ** -8}
# The fused render against the staged one (K2 + 2 x K1) of the same model:
# both run in bf16, but the staged path rounds the joint latent, key, query
# embeddings and both rounds' outputs to bf16 between kernels and its query
# MLPs round after each product and again after the bias, where K4 keeps
# f32 until each product's input. A few bf16 steps of each output.
FUSED_VS_STAGED_TOL = {'rgb': 2 ** -4, 'at_wt': 2 ** -7, 'depth_ray': 2 ** -4}
# K5-K8 against take_gather: both read the same bf16 table and round each
# corner's weight to bf16; the kernels sum the products in f32 and round
# once, the plain version rounds each product and each partial sum to bf16
# (up to 8 roundings of 2^-9 of the largest table value). A few bf16 steps.
GATHER_TOL = 2 ** -5
# The sorted stream (K5) and the one-hot gather (K7) against the paths they
# replace (phases 3, 6 and 7), in bf16: the staged K2 and K3 keep f32 until
# each product's input, where the sorted path's plain-torch fuse MLP and
# projections round every product to bf16; K5 and K7 sum the weighted
# corners in f32 and round once, where the take path rounds each. A few bf16
# steps of each output, as the fused render against the staged one.
PATH_TOL = FUSED_VS_STAGED_TOL
SMALL_TOL = 0.1     # bf16 card render vs f32 CPU render of the same model
WIDE_FF = (384, 512)    # fusion_features past the 'smem' plan's widths
CLI_CHUNKS = 8          # cli/eval.py's default --n_chunks
WIDE_RAYS = 4096
# evaluate_scene's metrics on the card against the CPU's, both f32 on the
# same image: sums in another order (PSNR, SSIM) and cuDNN's f32
# convolutions against the CPU's (LPIPS)
EVAL_TOL = {'psnr': 1e-3, 'ssim': 1e-4, 'lpips_rel': 1e-3}
# The decoder has no output squashing: at its initial scale random weights
# put RGB near +-40. Its last layer is drawn this much smaller so that the
# random image lies in an image's range and the range check below means
# something.
RGB_LAYER_SCALE = 1.0 / 64
SMALL = dict(npoints=16, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
PATH_B = dict(reference_exchange_compat=True, fused_mlp=True)
# Phase 23, fast evaluation: each lever of train/evaluation.py's fast
# renderer alone (the JAX tools' pruned 16,24, the CLI preset's pruned
# 8,16, narrow 128,128,64, q8) and the CLI's --fast composition, on the
# paths with a packed-table exchange.
FAST_LEVERS = (('pruned 16,24', dict(pruned=(16, 24))),
               ('pruned 8,16', dict(pruned=(8, 16))),
               ('narrow 128,128,64', dict(narrow=(128, 128, 64))),
               ('q8', dict(q8=True)),
               ('fast', dict(pruned=(8, 16), narrow=(128, 128, 64),
                             q8=True)))
FAST_PATHS = (('V=2', dict(npoints=64), 'fused_exchange_epilogue'),
              ('V=2 fused render', dict(npoints=64, fused_render=True),
               'fused_render_core'),
              ('V=3', dict(n_view=3), 'fused_exchange_epilogue_multi'))
# Training phases (17-19). The kernel route against the default route of
# the same flagship step: both run in bf16 from the same parameters, the
# kernel route's forward through K2 and K1 (f32 until each product's
# input), the default route's through the unfused exchange and the plain
# attention (rounding every product to bf16), so the rgb the loss reads
# differs by a few bf16 steps; the gradients are the plain versions' in
# both. The loss within ROUTE_LOSS_TOL relative; each tensor's gradient
# within ROUTE_GRAD_TOL of the larger of its norm and GRAD_FLOOR of the
# whole gradient's norm (the ViT's key biases have a gradient of 0 in
# exact arithmetic: rounding noise on both routes). Measured at the
# flagship (NVIDIA H100 80GB HBM3, 700 W, four runs): the losses 4.7e-4
# apart, the worst tensor 2.9-3.2e-2 (GroupNorms of the ResNet stem and
# first stage), the median 2.4-2.5e-3; the tolerances leave a factor of
# 3-8.
ROUTE_LOSS_TOL = 2 ** -8
ROUTE_GRAD_TOL = 0.1
GRAD_FLOOR = 1e-3
TRAIN_TIMED = 5
# fit's resumed step against the first run's on the same parameters: the
# same forward (cuDNN may pick another algorithm in another process)
RESUME_TOL = 1e-3
# Phase 25, the unposed path. SuperPoint and SuperGlue run in full f32 on
# both sides (TF32 off), so the card and the CPU differ by summation order
# alone: the score map (values near 1/65 with random weights) within
# SP_SCORE_TOL, descriptors within SP_DESC_TOL. Scores that tie within that
# noise may swap an NMS or top-K decision: at most SP_SWAPS of the valid
# keypoints may differ between the two. SuperGlue gets the same keypoints
# on both sides: matches equal, matching scores within SG_SCORE_TOL.
SP_SCORE_TOL = 1e-5
SP_DESC_TOL = 1e-4
SP_SWAPS = 0.01
SG_SCORE_TOL = 1e-4
UNPOSED_KEYPOINTS = 1024
UNPOSED_SINKHORN = 20
UNPOSED_POSES = 80              # 76 frames after the trajectory's trim
UNPOSED_POSE_GATE = (2.0, 0.98)  # degrees, translation direction cosine
# Phase 26, the capability path: tools/capability_run.py's protocol on
# plane worlds (the JAX tool's TPU record: 23.0 dB at step 1,500,
# BENCH_NOTES.md:498-506), cut to 1,000 steps to leave the script's time
# to phase 27 (the port's best at step 1,000: 17.7-18.0 dB; at 600 steps
# 15.69 dB, too near the floor to cut further; NVIDIA H100
# 80GB HBM3, 700 W, two runs), then eval_pruned at its defaults in bf16
# and the fast-eval strip. The floor is a sanity check, far under that
# record.
CAPABILITY = dict(config='medium', world='plane', worlds=32, steps=1000,
                  eval_every=500, lr=2.5e-4, dtype='f32')
CAPABILITY_FLOOR_DB = 15.0
Q8_GATE_DB = 0.2        # q8 against dense (JAX's tables: within 0.01 dB)
EVAL_PRUNED = dict(world='plane', worlds=4, pruned=(16, 24),
                   narrow=(64, 64, 64), n_chunks=4, iters=8)
# Phase 27, the parallel layer on one card: a 1-rank NCCL group, then two
# ranks on cuda:0 over gloo (NCCL refuses two ranks on one device). Each
# mesh takes PARALLEL_STEPS stage-1 steps of phase 3's flagship, held to
# the plain steps (the two ranks to the 1-rank mesh): the first step,
# from the same parameters, within phase 17's route tolerances (a mesh of
# one rank reduces over one rank, but the card's atomic adds keep two runs
# from being bit-equal; model = 2 rounds each row-parallel product's
# halves to bf16 before their f32 sum; data = 2 sums the batch's halves
# in another order). Adam's first updates move every element by about lr
# in the direction of its gradient's sign, which rounding picks where the
# gradient is noise (tests/test_torch_train.py), and the random model's
# loss rises over these steps: the later steps drift apart. Measured
# (NVIDIA H100 80GB HBM3, 700 W, three runs): 1.5-3.1e-3 between the
# plain and the 1-rank mesh steps, 6.5e-3 to 1.1e-2 at model = 2 and
# 1.4-2.2e-2 at data = 2; PARALLEL_DRIFT_TOL leaves a factor of 2.3.
PARALLEL_STEPS = 3
PARALLEL_DRIFT_TOL = 0.05
# The other fused kernels on weights gathered over model = 2: each model
# (flagship kwargs) sliced by shard_state renders its scene's first block
# through its kernel, against the same model unsliced (PATH_TOL): (label,
# kwargs, launches a block).
TP_RENDERS = (
    ('V=2 fused render', dict(npoints=64, fused_render=True),
     {'fused_render_core': 1, 'epipolar_attention': 0,
      'fused_exchange_epilogue': 0}),
    ('V=3', dict(n_view=3),
     {'epipolar_attention': 2, 'fused_exchange_epilogue_multi': 1}),
    # 3 self and 6 cross fuse calls a block
    ('V=3 compat', dict(n_view=3, **PATH_B),
     {'epipolar_attention': 2, 'fused_mlp2': 9}),
)
PARALLEL_TIMEOUT = 400      # seconds, for the two ranks together


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up
    (``utils/profiling.py``)."""
    from cross_attention_renderer_torch.utils.profiling import cuda_ms as ms
    return ms(fn, iters)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def scale(want) -> float:
    return max(1.0, float(want.float().abs().max()))


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def attention_bound(q, k, v):
    """(bound_ms, bound_by) of one epipolar_attention call on these inputs."""
    B, V, R, P, D = q.shape
    C = v.shape[-1]
    nbytes = (q.numel() + k.numel() + v.numel() + B * R * C
              + B * V * R * P) * q.element_size()
    flops = B * R * V * P * (2 * D + 2 * C + 5)     # dots, sums, softmax
    return bound(nbytes, flops, F32_FLOPS)


def exchange_work(tables, cells, aux_list, params):
    """(bytes read, multiply-adds) of the exchange epilogue with S =
    len(aux_list) streams: the table rows the cells reference, the cells,
    aux and the ten epilogue weights read once; the tensor-core products of
    every sample."""
    import torch
    S, M = len(aux_list), aux_list[0].shape[0]
    w1, w2, k2 = params[0], params[2], params[8]
    F, H1, O, K = w1.shape[0] - 3, w1.shape[1], w2.shape[1], k2.shape[1]
    row_bytes = sum(int(torch.unique(c).numel()) * t.shape[-1]
                    * t.element_size() for t, c in zip(tables, cells))
    nbytes = (row_bytes + sum(c.numel() * 4 for c in cells)
              + sum(a.numel() * a.element_size() for a in aux_list)
              + sum(p.numel() * 2 for p in params[:10]))
    macs = M * (S * (F * H1 + H1 * O) + S * O * O + S * O * K + K * K)
    return nbytes, macs


def epilogue_bound(tables, cells, aux_list, params):
    """(bound_ms, bound_by) of one exchange epilogue call: its reads and
    products, and its (M, O) and (M, K) outputs (in aux's type) written
    once. The products at the bf16 tensor-core rate, which the f32
    instantiation runs them at too."""
    nbytes, macs = exchange_work(tables, cells, aux_list, params)
    M, O, K = aux_list[0].shape[0], params[2].shape[1], params[8].shape[1]
    return bound(nbytes + M * (O + K) * aux_list[0].element_size(),
                 2 * macs, BF16_TENSOR_FLOPS)


def render_core_bound(tables, cells, aux_self, aux_cross, lc, params, B, R,
                      P, repeat):
    """(bound_ms, bound_by) of one fused_render_core call: the exchange's
    reads and products; the local coordinates and query weights read once,
    the (B, R, O) output and (B, 2, R, P) weights written once; per sample
    the query MLP, the repeat MLP's local-coordinate half and its second
    layer, and each round's q . k and value sum; per ray encode_latent and
    the repeat MLP's z_embed half (the same for every sample of a ray). All
    at the bf16 tensor-core rate, which makes it a lower bound."""
    nbytes, macs = exchange_work(tables, cells, (aux_self, aux_cross),
                                 params)
    M, O, K = aux_self.shape[0], params[2].shape[1], params[8].shape[1]
    rounds = 2 if repeat else 1
    query = params[10:14] + (params[14:] if repeat else ())
    nbytes += (sum(p.numel() * 2 for p in query)
               + (lc.numel() + B * R * O + M) * lc.element_size())
    macs += M * rounds * (16 * K + K * K + K + O)
    if repeat:
        macs += B * R * (O * K + K * K)
    return bound(nbytes, 2 * macs, BF16_TENSOR_FLOPS)


def mlp_bound(x1, x2, w1a, w1b, b1, w2, b2):
    """(bound_ms, bound_by) of one fused_mlp2 call: x1, x2, the weights and
    the output moved once; the products of every row."""
    M, K1 = x1.shape
    H, O = w1a.shape[1], w2.shape[1]
    nbytes = (x1.numel() + x2.numel() + M * O) * x1.element_size() + 2 * (
        w1a.numel() + w1b.numel() + w2.numel()) + 4 * (H + O)
    return bound(nbytes, 2 * M * (K1 * H + 3 * H + H * O), BF16_TENSOR_FLOPS)


def sorted_case(SG, fm, coords, image_id, padding_mode):
    """K5's (table, idx, w) for one ``grid_sample_sorted`` call."""
    B, Hl, Wl, C = fm.shape
    idx, w = SG._corners_flat(Hl, Wl, coords.float(), image_id, padding_mode)
    return fm.reshape(B * Hl * Wl, C), idx, w


def table_case(PG, features, coords, padding_mode):
    """K7's (table, idx, w) for one ``grid_sample_pallas`` call."""
    B, Hl, Wl, C = features.shape
    idx, w = PG.flat_corners(features, coords, padding_mode)
    return features.reshape(B * Hl * Wl, C), idx, w


def check_gather(label, kernel, cases, out_dtype):
    """A gather kernel against ``take_gather`` cast to the kernel's output
    type (``out_dtype``) on each (table, idx, w) case, within GATHER_TOL.
    Returns its numbers per launch, the mean over the cases, with the time
    of ``embedding_bag`` (one PyTorch call that computes the same sum) on
    the same inputs as ``library_ms``, timed before the kernel's check and
    timing on each case. (The kernel loads its table rows at L2's normal
    priority, so it leaves no ``evict_last`` marks for the yardstick or
    the next case to find.)"""
    import dataclasses
    import torch.nn.functional as F
    from cross_attention_renderer_torch.ops.sorted_gather import take_gather
    from cross_attention_renderer_torch.tools._common import bilinear_bound
    rows = []
    for table, idx, w in cases:
        dt = out_dtype
        w_t = w.to(table.dtype)
        try:
            lib = cuda_ms(lambda: F.embedding_bag(
                idx, table, per_sample_weights=w_t, mode='sum'), 10)
        except RuntimeError as e:      # the yardstick only, never the port
            log(f'{label}: embedding_bag refused these inputs: {e}')
            lib = None
        plain = cuda_ms(lambda: take_gather(table, idx, w).to(dt), 3)
        got = kernel(table, idx, w)
        want = take_gather(table, idx, w).to(dt)
        err, tol = max_err(got, want), GATHER_TOL * scale(want)
        if got.dtype != dt:
            raise RuntimeError(f'{label} returned {got.dtype}, not {dt}')
        plan = dataclasses.asdict(kernel.last_plan)
        log(f'{label} table {tuple(table.shape)}, M={idx.shape[0]} -> {dt}: '
            f'max err {err:.3e} (tol {tol:.3e}), plan {plan}')
        if err > tol:
            raise RuntimeError(f'{label} disagrees with its plain version')
        del got, want
        ms = cuda_ms(lambda: kernel(table, idx, w), 10)
        rows.append((err, *bilinear_bound(table, idx, w, dt), ms, plain,
                     lib, plan))
    n = len(rows)
    libs = [r[5] for r in rows]
    return {'max_abs_err': max(r[0] for r in rows),
            'ms': sum(r[3] for r in rows) / n,
            'plain_ms': sum(r[4] for r in rows) / n,
            'bound_ms': sum(r[1] for r in rows) / n,
            'bound_by': max(rows, key=lambda r: r[1])[2],
            'library_ms': None if None in libs else sum(libs) / n,
            'cases': [{'table': list(c[0].shape), 'M': int(c[1].shape[0]),
                       'ms': r[3], 'bound_ms': r[1], 'library_ms': r[5],
                       'plan': r[6]} for c, r in zip(cases, rows)]}


def drive(label, model, scene, RM, counted, expected, capture=None,
          render_image=None, times=None, timed=True, n_img=3,
          profiled=True):
    """Renders the full image through ``render_image`` (by default
    ``make_scan_renderer``'s) with the launch counters of ``counted``
    ({name: kernel wrapper}) set to 0 just before and read just after, and
    checks the image. Then, where ``timed``, times encode and ``n_img``
    whole images between CUDA events and, where ``profiled``, profiles one
    image; ``times`` (a dict), where given, receives the image's ms,
    rays/s and the profiled image's wall and device busy ms (None where
    not ``profiled``). Records the
    arguments of the first ``n`` calls of each ``capture`` entry ({key:
    (module, name, n)}; by default the first call of every counted kernel
    the renderer module calls). Returns the recorded arguments, the
    launches and the image."""
    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer)
    uv_full = scene['query']['uv']
    if render_image is None:
        render_image = make_scan_renderer(model, N_BLOCKS)
    if capture is None:
        capture = {name: (RM, name, 1) for name in counted
                   if hasattr(RM, name)}
    captured = {key: [] for key in capture}

    def recorder(key, fn, n):
        def wrapper(*args):
            if len(captured[key]) < n:
                captured[key].append(args)
            return fn(*args)
        return wrapper

    originals = {key: getattr(module, name)
                 for key, (module, name, _) in capture.items()}
    for key, (module, name, n) in capture.items():
        setattr(module, name, recorder(key, originals[key], n))
    for fn in counted.values():
        fn.launches = 0
    with torch.inference_mode():
        z = model.encode(scene)
        rgb, valid = render_image(scene, z, uv_full)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    for key, (module, name, _) in capture.items():
        setattr(module, name, originals[key])
    log(f'{label} launches per image: {launches}')
    if launches != expected:
        raise RuntimeError(f'{label}: unexpected kernel launches {launches}, '
                           f'expected {expected}')
    rgb_f = rgb.float()
    valid_frac = float(valid.float().mean())
    if rgb.shape != (1, 1, H * W, 3) or not bool(torch.isfinite(rgb_f).all()):
        raise RuntimeError(f'{label}: image is not finite or has the wrong '
                           'shape')
    lo, hi = float(rgb_f.min()), float(rgb_f.max())
    if lo < -1.0 or hi > 1.5 or valid_frac <= 0.0:
        raise RuntimeError(f'{label}: rgb range [{lo}, {hi}], valid '
                           f'{valid_frac}')
    log(f'{label} image: rgb in [{lo:.4f}, {hi:.4f}], valid fraction '
        f'{valid_frac:.4f}')
    if not timed:
        return captured, launches, rgb

    V = scene['context']['rgb'].shape[1]
    with torch.inference_mode():
        encode_ms = cuda_ms(lambda: model.encode(scene), 5)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_img):
            render_image(scene, z, uv_full)
        end.record()
        torch.cuda.synchronize()
        image_s = start.elapsed_time(end) / 1e3 / n_img
    log(f'{label} encode: {encode_ms:.3f} ms | image: {image_s * 1e3:.1f} ms '
        f'| {H * W / image_s:.1f} rays/s ({H * W:,} rays, {N_BLOCKS} blocks, '
        f'V={V}, '
        f'{model.n_samples} samples, {str(model.dtype)[6:]})')

    busy = {'wall_ms': None, 'device_busy_ms': None}
    if profiled:
        with torch.inference_mode():
            busy = profile_device(f'{label} profile of one image',
                                  lambda: render_image(scene, z, uv_full))
    if times is not None:
        times.update(image_ms=image_s * 1e3, rays_per_s=H * W / image_s,
                     profiled_wall_ms=busy['wall_ms'],
                     device_busy_ms=busy['device_busy_ms'])
    return captured, launches, rgb


def profile_device(label, fn) -> dict:
    """Runs ``fn`` once under ``torch.profiler``; logs its wall time, the
    device's busy time and the 12 operations with the most device time
    (user annotations, such as the optimizer's step range, left out: their
    device time is their kernels'). Returns the two times in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')
              and not getattr(e, 'is_user_annotation', False)]
    dev_us = sum(e.self_device_time_total for e in events)
    log(f'{label}: wall {wall_ms:.1f} ms, device busy {dev_us / 1e3:.1f} ms '
        f'({100 * dev_us / 1e3 / wall_ms:.1f}%)')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f'  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  '
            f'{e.key[:90]}')
    return {'wall_ms': wall_ms, 'device_busy_ms': dev_us / 1e3}


def first_block(model, scene):
    """The model's rgb, at_wt and depth_ray on the image's first ray block,
    as f32."""
    import torch
    s = dict(scene)
    s['query'] = dict(scene['query'],
                      uv=scene['query']['uv'][:, :, :RAY_BLOCK])
    with torch.inference_mode():
        out = model(s)
    return {k: out[k].float() for k in ('rgb', 'at_wt', 'depth_ray')}


def check_dtype(label, outputs, dtype):
    """A kernel's outputs are in its inputs' type (bf16 or f32)."""
    got = {str(t.dtype) for t in outputs}
    if got != {str(dtype)}:
        raise RuntimeError(f'{label} returned {got} for {dtype} inputs')


def check_render_core(FR, args):
    """K4 against its plain version on ``args``; returns its numbers. Its
    weights are laid out once (``prepared_render``) before the timed calls,
    which then time the launch alone."""
    import torch
    from cross_attention_renderer_torch.ops import gather_epilogue as GE
    GE.prepared_render(args[5], args[9], args[4].device,
                       [t.shape[-1] // 4 for t in args[0]])
    torch.cuda.synchronize()
    z, wt = FR.fused_render_core(*args)
    z_ref, wt_ref = FR.fused_render_core_reference(*args)
    check_dtype('K4', (z, wt), args[2].dtype)
    err_z, err_wt = max_err(z, z_ref), max_err(wt, wt_ref)
    log(f'K4 fused_render_core (B, R, P) = {tuple(args[6:9])}, repeat '
        f'{args[9]}: max err z {err_z:.3e} (tol '
        f'{K4_TOL["z"] * scale(z_ref):.3e}), at_wt {err_wt:.3e} (tol '
        f'{K4_TOL["at_wt"]:.3e})')
    if err_z > K4_TOL['z'] * scale(z_ref) or err_wt > K4_TOL['at_wt']:
        raise RuntimeError('K4 disagrees with its plain version')
    del z, wt, z_ref, wt_ref
    bound_ms, bound_by = render_core_bound(*args)
    return {'max_abs_err': max(err_z, err_wt),
            'ms': cuda_ms(lambda: FR.fused_render_core(*args), 10),
            'plain_ms': cuda_ms(
                lambda: FR.fused_render_core_reference(*args), 3),
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'launch': launch_shape('K4 fused_render_core',
                                   FR.fused_render_core)}


def check_paths(label, tols, rgb, rgb_ref, block=None, block_ref=None):
    """One path's image (and, where given, first block's at_wt and
    depth_ray) against another path's, each within its fraction ``tols``
    of max(1, max |ref|)."""
    pairs = [('rgb', 'rgb', rgb, rgb_ref)] + [
        (k, f'first block {k}', block[k], block_ref[k])
        for k in (('at_wt', 'depth_ray') if block else ())]
    for key, name, got, want in pairs:
        tol = tols[key]
        err = max_err(got, want)
        log(f'{label}, {name}: max err {err:.3e} (tol '
            f'{tol * scale(want):.3e})')
        if err > tol * scale(want):
            raise RuntimeError(f'{label}: the paths disagree ({name})')


def check_attention(label, EA, q, k, v):
    """K1 against its plain version on (q, k, v); returns its numbers."""
    out, wt = EA.epipolar_attention(q, k, v)
    out_ref, wt_ref = EA.epipolar_attention_reference(q, k, v)
    check_dtype(f'K1 ({label})', (out, wt), v.dtype)
    err_out, err_wt = max_err(out, out_ref), max_err(wt, wt_ref)
    log(f'K1 epipolar_attention {label} {tuple(q.shape)} x '
        f'{tuple(v.shape)}: max err out {err_out:.3e} (tol '
        f'{K1_TOL["out"] * scale(out_ref):.3e}), at_wt {err_wt:.3e} (tol '
        f'{K1_TOL["at_wt"]:.3e})')
    if (err_out > K1_TOL['out'] * scale(out_ref)
            or err_wt > K1_TOL['at_wt']):
        raise RuntimeError(f'K1 disagrees with its plain version ({label})')
    bound_ms, bound_by = attention_bound(q, k, v)
    return {'max_abs_err': max(err_out, err_wt),
            'ms': cuda_ms(lambda: EA.epipolar_attention(q, k, v), 20),
            'plain_ms': cuda_ms(
                lambda: EA.epipolar_attention_reference(q, k, v), 5),
            'bound_ms': bound_ms, 'bound_by': bound_by}


def core_ptxas(logs, names=('gather_epilogue', 'gather_epilogue_multi',
                             'fused_mlp', 'fused_render'),
               kernel='exchange_core_kernel'):
    """The ``ptxas -v`` lines of a kernel's instantiations in the named
    sources (by default the exchange core's, K2, K3, K9, K4): registers,
    barriers and spills of each, and any note of serialised wgmma."""
    lines = []
    for name in names:
        keep = False
        for line in logs.get(name, '').splitlines():
            if 'Compiling entry' in line or 'Function properties' in line:
                keep = kernel in line
            if (keep and 'Compile time' not in line) or (
                    kernel in line and 'Performance' in line):
                lines.append(f'{name}: {line.strip()}')
    return lines


def gather_ptxas(log_text):
    """One line an instantiation of the copy and bulk gathers (T1-T5,
    T7-T10, T12, T13), the block fill (T6, T11) and the bilinear gather
    (K5-K8) from ``ptxas -v``: its template arguments, registers and spill
    bytes."""
    import re
    keys = {'copy_gather': ('index', 'unroll', 'rows', 'stage'),
            'bulk_gather': ('window',), 'bilinear_gather': ('depth',)}
    lines, name, spilled = [], None, '?'
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\w*?(copy_gather|bulk_gather"
                      r"|bilinear_gather|block_fill)_kernel(I\w*?EEv)?", line)
        if m:
            args = re.findall(r'L[ib](\d+)E', m[2] or '')
            named = [' '.join(a) for a in zip(keys.get(m[1], ()), args)]
            if m[1] == 'bilinear_gather':
                named.append('bf16 out' if 'bfloat16' in m[2] else 'f32 out')
            name = f"{m[1]}<{', '.join(named)}>" if named else m[1]
        spill = re.search(r'(\d+) bytes spill stores', line)
        if spill and name:
            spilled = spill[1]
        regs = re.search(r'Used (\d+) registers', line)
        if regs and name:
            lines.append(f'{name}: {regs[1]} registers, {spilled} bytes '
                         'spilled')
            name = None
    return lines


def check_epilogue(name, kernel, plain, args, aux_list, params, tol,
                   iters=10, plain_iters=3):
    """An exchange epilogue (K2 or K3) against its plain version. Its
    weights are laid out once (``prepared_weights``) before the timed calls,
    which then time the launch alone (``iters`` calls, the plain version
    ``plain_iters``)."""
    import torch
    from cross_attention_renderer_torch.ops import gather_epilogue as GE
    GE.prepared_weights(params, len(aux_list), aux_list[0].device,
                        [t.shape[-1] // 4 for t in args[0]])
    torch.cuda.synchronize()
    jl, kv = kernel(*args)
    jl_ref, kv_ref = plain(*args)
    check_dtype(name, (jl, kv), aux_list[0].dtype)
    err_jl, err_kv = max_err(jl, jl_ref), max_err(kv, kv_ref)
    log(f'{name} M={aux_list[0].shape[0]}: max err jl {err_jl:.3e} (tol '
        f'{tol * scale(jl_ref):.3e}), kv {err_kv:.3e} (tol '
        f'{tol * scale(kv_ref):.3e})')
    if err_jl > tol * scale(jl_ref) or err_kv > tol * scale(kv_ref):
        raise RuntimeError(f'{name} disagrees with its plain version')
    del jl, kv, jl_ref, kv_ref
    bound_ms, bound_by = epilogue_bound(args[0], args[1], aux_list, params)
    return {'max_abs_err': max(err_jl, err_kv),
            'ms': cuda_ms(lambda: kernel(*args), iters),
            'plain_ms': cuda_ms(lambda: plain(*args), plain_iters),
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'launch': launch_shape(name, kernel)}


def launch_shape(name, kernel):
    """Logs and returns the last launch's shape and plan of an
    exchange-core kernel (K2, K3, K4, K9) as the launch reported them."""
    grid, stages, smem, threads, *cluster = kernel.last_launch
    log(f'{name} launch: grid {grid} blocks of {threads} threads, cluster '
        f'shape {tuple(cluster)}, {stages} weight stage slots ({stages // 2}'
        f' a ring), {smem:,} bytes of shared memory a block, plan '
        f'{kernel.last_plan!r}')
    return {'grid': grid, 'threads': threads, 'cluster': cluster,
            'stage_slots': stages, 'smem_bytes': smem,
            'plan': kernel.last_plan}


def check_stream_takes(label, ST, args, calls=50, iters=10,
                       plain_iters=3):
    """The address math kernel (``ops/stream_takes.py``) against its plain
    version on a path's first block (``stream_takes``' recorded
    arguments): every cell equal and every aux value equal bit for bit.
    Times the launch alone (``calls`` in one CUDA graph), the wrapper's
    whole call (the relative transforms, allocations and launch) and the
    plain version, beside the bytes bound: each sample's 20 input bytes
    read once, its cells and aux rows of every stream written once."""
    import torch
    from cross_attention_renderer_torch.ops.gather_epilogue import (
        aux_layout)
    from cross_attention_renderer_torch.utils.profiling import graph_ms
    level_hw, pixel_val, pt_views, c2w, intr, H_, W_, dtype, points = args
    B, V, R, P, _ = pt_views.shape
    M, L = B * V * R * P, len(level_hw)

    def plain():
        return ST.stream_takes_reference(level_hw, pixel_val,
                                         points(pt_views, c2w), intr, H_, W_,
                                         dtype)

    cells, aux = ST.stream_takes(*args)
    want_cells, want_aux = plain()
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    cells_differ = sum(int((a != b).sum())
                       for a, b in zip(cells, want_cells))
    aux_differ = sum(int((a.view(bits) != b.view(bits)).sum())
                     for a, b in zip(aux, want_aux))
    width = aux_layout(L)[1]
    nbytes = M * 20 + V * M * (4 * L + width * aux[0].element_size())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f'{label} stream_takes M={M:,} V={V} levels={L}: cells differing '
        f'{cells_differ}, aux values differing {aux_differ}')
    if cells_differ or aux_differ:
        raise RuntimeError(f'{label}: stream_takes disagrees with its plain '
                           'version')
    out = torch.stack(aux)
    rel = torch.linalg.inv_ex(c2w).inverse[:, :, None] @ c2w[:, None]
    kernel_args = (level_hw, pixel_val.contiguous(), pt_views.contiguous(),
                   rel.contiguous(), intr.contiguous(), cells, out, H_, W_)
    numbers = {'M': M, 'V': V, 'levels': L,
               'ms': graph_ms(lambda: ST.launch_kernel(*kernel_args), calls),
               'call_ms': cuda_ms(lambda: ST.stream_takes(*args), iters),
               'plain_ms': cuda_ms(plain, plain_iters),
               'bound_ms': bound_ms, 'bound_by': 'bytes',
               'bytes': nbytes, 'cells_differing': cells_differ,
               'aux_values_differing': aux_differ}
    log(f'{label} stream_takes: {numbers["ms"]:.4f} ms a launch (bound '
        f'{bound_ms:.4f} ms, {nbytes / 1e6:.1f} MB), {numbers["call_ms"]:.4f}'
        f' ms a call, plain {numbers["plain_ms"]:.3f} ms')
    return numbers


def watch_core_plans(GE) -> dict:
    """Holds every exchange-core launch of the run (K2, K3, K4, K9) to
    ``core_plan``: wraps ``GE.record_launch`` so that each launch at widths
    not seen before logs its plan and stage slots a ring as the launch
    reported them beside ``core_plan``'s answer for those widths, and
    raises where they differ. Returns {widths: (plan, slots a ring)},
    filled as the launches come."""
    seen, real = {}, GE.record_launch

    def record(wrapper, info, widths):
        real(wrapper, info, widths)
        key = tuple(sorted(widths.items()))
        if key in seen:
            return
        got = (wrapper.last_plan, info[1] // 2)
        want = GE.core_plan(**widths)
        seen[key] = got
        log(f'core launch {widths}: plan {got[0]!r}, {got[1]} stage slots '
            f'a ring (core_plan: {want.plan!r}, {want.slots})')
        if got != (want.plan, want.slots):
            raise RuntimeError(f'the core launched {got} at {widths}, '
                               f'core_plan says {want}')

    GE.record_launch = record
    return seen


def repeat_bitwise(label, fn, args, n):
    """``fn(*args)`` n times on one set of inputs: every output equal, bit
    for bit, to the first call's (a stale read of the f rows the consumers
    store in the scratch would show as a difference)."""
    import torch
    first = fn(*args)
    for i in range(1, n):
        again = fn(*args)
        for a, b in zip(first, again):
            if not torch.equal(a, b):
                raise RuntimeError(f'{label}: call {i + 1} of {n} differs '
                                   'from the first')
    torch.cuda.synchronize()
    log(f'{label}: {n} calls on one set of inputs, bit for bit, plan '
        f'{fn.last_plan!r}, {fn.last_launch[1] // 2} stage slots a ring')
    return n


def small_agreement(label, RM, make_scene, dev, counted=None, small=SMALL,
                    **kw):
    """A narrow model's bf16 render on the card against its f32 render on
    the CPU, through the same entry point. ``counted`` ({name: (kernel
    wrapper, launches)}) are the launches the card render must make.
    Returns them."""
    import torch
    n_view = kw.get('n_view', 2)
    ref = RM.CrossAttentionRenderer(seed=1, device='cpu', **small, **kw)
    card_model = RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=1,
                                           device=dev, **small, **kw)
    s_cpu = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512,
                       device='cpu')
    s_dev = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512, device=dev)
    counted = counted or {}
    with torch.inference_mode():
        want = ref(s_cpu)['rgb']
        for fn, _ in counted.values():
            fn.launches = 0
        got = card_model(s_dev)['rgb'].float().cpu()
    launches = {name: fn.launches for name, (fn, _) in counted.items()}
    if launches != {name: n for name, (_, n) in counted.items()}:
        raise RuntimeError(f'small input {label}: unexpected kernel launches '
                           f'{launches}')
    plans = {name: fn.last_plan for name, (fn, n) in counted.items()
             if n and hasattr(fn, 'last_plan')}
    if plans:
        log(f'small input {label}: launches {launches}, plans {plans}')
    err = max_err(got, want)
    log(f'small input {label}: bf16 card render vs f32 CPU render, max err '
        f'{err:.3e} (tol {SMALL_TOL * scale(want):.3e})')
    if not bool(torch.isfinite(got).all()) or err > SMALL_TOL * scale(want):
        raise RuntimeError(f'small-input render ({label}) disagrees with the '
                           'reference')
    return launches


def check_mlp(FM, args, label='K9 fused_mlp2'):
    """K9 against its plain version on ``args``; returns its numbers. Its
    weights are laid out once (``prepared_mlp``) before the timed calls,
    which then time the launch alone."""
    import torch
    from cross_attention_renderer_torch.ops import gather_epilogue as GE
    GE.prepared_mlp(args[2:], args[0].device)
    torch.cuda.synchronize()
    out = FM.fused_mlp2(*args)
    ref = FM.fused_mlp2_reference(*args)
    check_dtype(label, (out,), args[0].dtype)
    err = max_err(out, ref)
    log(f'{label} {tuple(args[0].shape)}: max err {err:.3e} (tol '
        f'{K9_TOL * scale(ref):.3e})')
    if err > K9_TOL * scale(ref):
        raise RuntimeError(f'{label} disagrees with its plain version')
    del out, ref
    bound_ms, bound_by = mlp_bound(*args)
    return {'max_abs_err': err,
            'ms': cuda_ms(lambda: FM.fused_mlp2(*args), 20),
            'plain_ms': cuda_ms(lambda: FM.fused_mlp2_reference(*args), 10),
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'launch': launch_shape(label, FM.fused_mlp2)}


def first_call(model, scene, module, name):
    """The arguments of the first call of ``module.<name>`` in one forward
    of ``model`` on ``scene``."""
    import torch
    fn, seen = getattr(module, name), []

    def recorder(*args):
        if not seen:
            seen.append(args)
        return fn(*args)

    setattr(module, name, recorder)
    try:
        with torch.inference_mode():
            model(scene)
    finally:
        setattr(module, name, fn)
    return seen[0]


def check_wide(ff, RM, FM, FR, GE, make_scene, dev):
    """K2, K3, K4 and K9 against their plain versions at fusion_features
    ``ff``: models of the flagship's other widths with the ViT cut to 2
    blocks, on the first WIDE_RAYS rays of a 256x256 scene. Returns each
    kernel's numbers and plan."""
    import torch
    out = {}
    base = dict(fusion_features=ff, vit_depth=2)
    for key, kw, name in (
            ('K2', dict(npoints=64), 'fused_exchange_epilogue'),
            ('K4', dict(npoints=64, fused_render=True), 'fused_render_core'),
            ('K3', dict(n_view=3), 'fused_exchange_epilogue_multi'),
            ('K9', dict(n_view=3, **PATH_B), 'fused_mlp2')):
        model = flagship(RM, dev, **base, **kw)
        scene = make_scene(0, n_view=kw.get('n_view', 2), H=H, W=W,
                           n_rays=WIDE_RAYS, device=dev)
        args = first_call(model, scene, RM, name)
        label = f'{key} {name} ff={ff}'
        if key == 'K2':
            n = check_epilogue(label, GE.fused_exchange_epilogue,
                               GE.fused_exchange_epilogue_reference, args,
                               args[2:4], args[4], K2_TOL)
        elif key == 'K3':
            n = check_epilogue(label, GE.fused_exchange_epilogue_multi,
                               GE.fused_exchange_epilogue_multi_reference,
                               args, args[2], args[3], K3_TOL)
        elif key == 'K4':
            log(f'{label}:')
            n = check_render_core(FR, args)
        else:
            n = check_mlp(FM, args, label)
        out[key] = n
        del model, scene, args
        torch.cuda.empty_cache()
    return out


def random_lpips_npz(path):
    """LPIPS weights drawn from seed 0 (VGG16's 13 convolutions at 0.05,
    nonnegative 1x1 heads), written through ``convert_weights`` as the
    learned ones would be: the repository ships none."""
    import numpy as np
    from cross_attention_renderer_torch.losses.lpips import convert_weights
    rng = np.random.default_rng(0)
    layer_ids = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    channels = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                512)
    vgg, c_in = {}, 3
    for lid, c in zip(layer_ids, channels):
        vgg[f'{lid}.weight'] = rng.normal(0, 0.05, (c, c_in, 3, 3)).astype(
            np.float32)
        vgg[f'{lid}.bias'] = np.zeros(c, np.float32)
        c_in = c
    lins = {f'lins.{i}.model.1.weight': np.abs(rng.normal(
        0, 1, (1, c, 1, 1))).astype(np.float32)
        for i, c in enumerate((64, 128, 256, 512, 512))}
    return convert_weights(vgg, lins, str(path))


def check_evaluation(RM, make_scene, dev, npz):
    """``evaluate_scene`` on the flagship V=2 image with LPIPS, on the card,
    against the same metrics of the same image on the CPU in f32."""
    import torch
    from cross_attention_renderer_torch.losses import lpips as LP
    from cross_attention_renderer_torch.train.evaluation import (
        evaluate_scene)
    from cross_attention_renderer_torch.utils import metrics as MT
    model = flagship(RM, dev, npoints=64)
    scene = make_scene(0, H=H, W=W, n_rays=H * W, full_image=True,
                       device=dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        card = evaluate_scene(model, scene, H, W, N_BLOCKS,
                              lpips_fn=LP.load_lpips(str(npz), device=dev))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    pred = torch.from_numpy(card['pred'])
    target = torch.from_numpy(card['target'])
    cpu = {'psnr': float(MT.psnr(pred, target)),
           'ssim': float(MT.ssim(pred, target)),
           'lpips': float(LP.load_lpips(str(npz), device='cpu')(
               (pred[None] - 0.5) * 2.0, (target[None] - 0.5) * 2.0)[0])}
    got = {k: float(card[k]) for k in ('psnr', 'ssim', 'lpips')}
    log(f'evaluate_scene (V=2, {H}x{W}, {N_BLOCKS} blocks, {eval_s:.2f} s '
        f'with the encode): card {got}, CPU f32 {cpu}')
    ok = (all(map(np_isfinite, got.values()))
          and abs(got['psnr'] - cpu['psnr']) <= EVAL_TOL['psnr']
          and abs(got['ssim'] - cpu['ssim']) <= EVAL_TOL['ssim']
          and abs(got['lpips'] - cpu['lpips'])
          <= EVAL_TOL['lpips_rel'] * abs(cpu['lpips'])
          and got['lpips'] > 0 and -1 <= got['ssim'] <= 1)
    if not ok:
        raise RuntimeError('evaluate_scene on the card disagrees with the '
                           'CPU metrics of the same image')
    return {'card': got, 'cpu': cpu, 'seconds': eval_s}


def np_isfinite(x) -> bool:
    return x == x and abs(x) != float('inf')


def probe_kernels(dev):
    """T1-T13: every case of the five probe scripts, then one entry a probe
    for the ``kernels`` line (its first case's numbers, all cases
    beside)."""
    import importlib
    from cross_attention_renderer_torch.tools import _common as PC
    records = []
    for name in ('micro_kgather', 'micro_kgather2', 'micro_kgather3',
                 'micro_kgather_bisect', 'micro_kgather_bisect2'):
        log(f'--- probes: {name}')
        mod = importlib.import_module(
            f'cross_attention_renderer_torch.tools.{name}')
        records += mod.run(dev)
    # each case against index_select (timed before the kernel touched the
    # table) and its bound; unroll sets only the chunks of one row a lane
    # takes at a step, so cases that differ in unroll or bm alone may run
    # one launch, marked here
    log('probe: unroll sets the chunks of one row a lane takes at a step; '
        'the rows in flight fill each lane to 8 chunks')
    first = {}
    for r in records:
        lib = r['library_ms']
        key = (r['probe'], r.get('table'), r.get('rows'), str(r.get('plan')))
        same = first.setdefault(key, r['case']) if r.get('plan') else None
        log(f"probe {r['probe']} {r['case']}: {r['ms']:.4f} ms, "
            + (f"{r['ms'] / lib:.3f}x {r['library']} ({lib:.4f} ms), "
               if lib else 'no library call, ')
            + f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
            f"({r['bound_ms']:.4f} ms)"
            + (f", plan {r['plan']}" if r.get('plan') else '')
            + (f", the launch of '{same}'" if same not in (None, r['case'])
               else ''))
    entries = []
    for tid, (site, fn_name) in PC.PROBES.items():
        cases = [r for r in records if r['probe'] == tid]
        if not cases:
            raise RuntimeError(f'probe {tid} ran no case')
        main_case = cases[0]
        entries.append({
            'name': f'{tid} {fn_name}', 'route': 'cuda',
            'source': 'cross_attention_renderer_torch/csrc/row_gather.cu',
            'replaces': site, 'launches': 0, 'launches_by_path': {},
            **{k: main_case[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                         'bound_by', 'library_ms',
                                         'max_abs_err')},
            'case': main_case['case'],
            'cases': [{k: r.get(k) for k in ('case', 'ms', 'plain_ms',
                                             'library_ms', 'bound_ms',
                                             'plan')}
                      for r in cases]})
    return entries


def train_routes(EA, GE, make_scene, dev, model_fn, batch, rays):
    """Phase 17: one step of ``model_fn()``'s model on each route from the
    same parameters and batch, with the K1 and K2 counters set to 0 just
    before the step and read just after; each route's loss, grad_norm,
    launches, gradient and timing; then the routes against each other."""
    import torch
    from cross_attention_renderer_torch.tools import bench_train as BT
    from cross_attention_renderer_torch.train import trainer as T
    scene = make_scene(0, batch=batch, n_view=2, H=H, W=W, n_rays=rays,
                       device=dev)
    cfg = T.TrainConfig()
    counted = {'epipolar_attention': EA.epipolar_attention,
               'fused_exchange_epilogue': GE.fused_exchange_epilogue}
    expected = {'default': {'epipolar_attention': 0,
                            'fused_exchange_epilogue': 0},
                'kernels': {'epipolar_attention': 2,
                            'fused_exchange_epilogue': 1}}
    out, grads = {}, {}
    for route in BT.ROUTES:
        model = model_fn()
        before = [p.detach().to('cpu', copy=True) for p in model.parameters()]
        state = T.create_train_state(model, cfg)
        step = BT.make_route_step(model, cfg, route)
        for fn in counted.values():
            fn.launches = 0
        state, metrics = step(state, scene)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counted.items()}
        loss = float(metrics['total_loss'])
        gnorm = float(metrics['grad_norm'])
        log(f'train {route} route: loss {loss:.6f}, grad_norm {gnorm:.6f}, '
            f'launches a step {launches}')
        if launches != expected[route]:
            raise RuntimeError(f'train {route} route: launches {launches}, '
                               f'expected {expected[route]}')
        if not (np_isfinite(loss) and np_isfinite(gnorm)):
            raise RuntimeError(f'train {route} route: loss {loss}, '
                               f'grad_norm {gnorm}')
        # the step's clip scaled the gradients by clip / norm where the
        # norm was over the clip; undone here to compare the routes
        unclip = max(1.0, gnorm / cfg.clip_norm)
        grads[route] = {n: (p.grad.float() * unclip).cpu()
                        for n, p in model.named_parameters()}
        timed = BT.time_steps(step, state, scene, TRAIN_TIMED)
        # every parameter has changed after these steps (not after the
        # first alone: the decoder's blocks start with a zero output layer,
        # as the reference's, so their first layer gets no gradient then)
        changed = sum(not torch.equal(p.detach().cpu(), b)
                      for p, b in zip(model.parameters(), before))
        log(f'train {route} route: {changed} of {len(before)} parameter '
            f'tensors changed over {TRAIN_TIMED + 2} steps')
        if changed != len(before) or not np_isfinite(timed['total_loss']):
            raise RuntimeError(f'train {route} route: {changed} of '
                               f'{len(before)} parameters changed, loss '
                               f'{timed["total_loss"]}')
        del before
        out[route] = {'loss': loss, 'grad_norm': gnorm,
                      'launches_per_step': launches,
                      **{k: timed[k] for k in ('ms_per_step', 'steps_per_s',
                                               'peak_gb')},
                      'profile': profile_device(
                          f'train {route} route, profile of one step',
                          lambda: step(state, scene))}
        log(f'train {route} route: {timed["ms_per_step"]:.2f} ms a step, '
            f'{timed["steps_per_s"]:.3f} steps/s, peak '
            f'{timed["peak_gb"]:.2f} GB (batch {batch}, {rays} rays, '
            f'{H}x{W}, {TRAIN_TIMED} steps after a warm-up)')
        del model, state, step, metrics
        torch.cuda.empty_cache()

    d, k = grads['default'], grads['kernels']
    total = float(sum(g.norm() ** 2 for g in d.values())) ** 0.5
    errs = sorted(((float((k[n] - g).norm())
                    / max(float(g.norm()), GRAD_FLOOR * total), n)
                   for n, g in d.items()), reverse=True)
    loss_err = abs(out['kernels']['loss'] - out['default']['loss']) / abs(
        out['default']['loss'])
    log(f'train routes: loss {loss_err:.3e} apart relative (tol '
        f'{ROUTE_LOSS_TOL:.3e}); worst gradients (norm of the difference '
        f'over the default route\'s): '
        + ', '.join(f'{n} {e:.3e}' for e, n in errs[:4])
        + f' (tol {ROUTE_GRAD_TOL})')
    if loss_err > ROUTE_LOSS_TOL or errs[0][0] > ROUTE_GRAD_TOL:
        raise RuntimeError('the kernel route\'s step disagrees with the '
                           'default route\'s')
    out['agreement'] = {'loss_rel': loss_err, 'grad_worst': errs[0][0],
                        'grad_worst_tensor': errs[0][1],
                        'grad_median': errs[len(errs) // 2][0]}
    return out


def check_fit(make_scene, dev, model_fn):
    """Phase 18: ``fit`` 3 steps into a temporary directory (a 'current'
    checkpoint at step 2, 'final' at 3), then a model from another seed
    resumed from 'current' for the last step."""
    import itertools
    import tempfile
    from cross_attention_renderer_torch.train import trainer as T
    scene = make_scene(1, batch=4, n_view=2, H=64, W=64, n_rays=256,
                       device=dev)
    cfg = T.TrainConfig(lr=1e-3, steps_til_summary=2,
                        iters_til_checkpoint=10 ** 6)
    first, second = [], []
    with tempfile.TemporaryDirectory() as ckpt:
        T.fit(model_fn(0), cfg, itertools.repeat(scene), 3, ckpt_dir=ckpt,
              log_fn=lambda i, m: first.append(float(m['total_loss'])))
        names = sorted(p.name for p in Path(ckpt).iterdir())
        state = T.fit(model_fn(5), cfg, itertools.repeat(scene), 3,
                      ckpt_dir=ckpt,
                      log_fn=lambda i, m: second.append(
                          float(m['total_loss'])))
    err = abs(second[0] - first[2]) / abs(first[2]) if second else None
    log(f'fit: losses {first}, checkpoints {names}; resumed at step 2 for '
        f'one step: loss {second} (relative difference {err}, tol '
        f'{RESUME_TOL}), step {state.step}')
    if (names != ['current.pt', 'final.pt'] or len(second) != 1
            or state.step != 3 or err > RESUME_TOL
            or not all(map(np_isfinite, first))):
        raise RuntimeError('fit / resume failed')
    return {'losses': first, 'resumed_loss': second[0], 'resume_rel': err}


def check_stage2(make_scene, dev, model_fn, npz):
    """Phase 19: one stage-2 step (depth and LPIPS) at batch 4, each scene's
    1,024 query rays one 32x32 pixel patch with mask 1."""
    import torch
    from cross_attention_renderer_torch.losses.lpips import load_lpips
    from cross_attention_renderer_torch.train import trainer as T
    batch = 4
    scene = make_scene(2, batch=batch, n_view=2, H=H, W=W, n_rays=1024,
                       device=dev)
    j, i = torch.meshgrid(torch.arange(32.0), torch.arange(32.0),
                          indexing='ij')
    patch = torch.stack([i, j], -1).reshape(1, 1, 1024, 2).to(dev)
    corner = torch.tensor([[40.0, 60.0], [100.0, 20.0], [0.0, 200.0],
                           [180.0, 130.0]], device=dev)[:, None, None]
    scene['query']['uv'] = patch + corner
    scene['query']['mask'] = torch.ones(batch, device=dev)
    lpips = load_lpips(str(npz), device=dev)
    inputs = []

    def lpips_fn(pred, target):         # keeps the VGG input's gradient
        pred.retain_grad()
        inputs.append(pred)
        return lpips(pred, target)

    model = model_fn()
    cfg = T.TrainConfig(depth=True, lpips=True)
    state = T.create_train_state(model, cfg)
    state, m = T.make_train_step(model, cfg, lpips_fn=lpips_fn)(state, scene)
    metrics = {k: float(v) for k, v in m.items()}
    g = inputs[0].grad
    g_abs = float(g.abs().max()) if g is not None else 0.0
    log(f'stage 2 (batch {batch}, one 32x32 patch a scene): {metrics}; '
        f'VGG input gradient max |g| {g_abs:.3e}')
    if not (metrics['lpips_loss'] > 0 and 'depth_loss' in metrics
            and all(map(np_isfinite, metrics.values()))
            and g is not None and bool(torch.isfinite(g).all())
            and g_abs > 0):
        raise RuntimeError('stage-2 step: no LPIPS term or no gradient '
                           'through it')
    return {**metrics, 'vgg_input_grad_max': g_abs}


def f32_paths(RM, EA, GE, FR, FM, make_scene, dev, attention, epilogue,
              epilogue_multi, mlp, render_core):
    """Phase 20: the flagship model in f32 (the JAX CLI's default type) on
    the V=2, V=2 fused render, V=3 default and V=3 compat paths, each image
    driven as phase 3 drives it (the launch counts of the bf16 paths), and
    each f32 kernel instantiation (K1, K2, K4, K3, K9) against its plain
    version in f32 on the first block's inputs, with the bf16 kernels'
    tolerances. Returns the launches by path and each kernel's numbers."""
    import torch
    f32 = torch.float32
    by_path, out = {}, {}
    scene = make_scene(0, H=H, W=W, n_rays=H * W, full_image=True,
                       device=dev)
    for label, kw, counted, expected in (
            ('V=2 f32', dict(npoints=64), dict([attention, epilogue]),
             {'epipolar_attention': 2 * N_BLOCKS,
              'fused_exchange_epilogue': N_BLOCKS}),
            ('V=2 fused render f32', dict(npoints=64, fused_render=True),
             dict([render_core, attention, epilogue]),
             {'fused_render_core': N_BLOCKS, 'epipolar_attention': 0,
              'fused_exchange_epilogue': 0}),
            ('V=3 (Path A) f32', dict(n_view=3),
             dict([attention, epilogue_multi]),
             {'epipolar_attention': 2 * N_BLOCKS,
              'fused_exchange_epilogue_multi': N_BLOCKS}),
            ('V=3 compat (Path B) f32', dict(n_view=3, **PATH_B),
             dict([attention, mlp]),
             {'epipolar_attention': 2 * N_BLOCKS,
              'fused_mlp2': 9 * N_BLOCKS})):
        if kw.get('n_view') == 3 and scene['context']['rgb'].shape[1] != 3:
            scene = make_scene(0, n_view=3, H=H, W=W, n_rays=H * W,
                               full_image=True, device=dev)
        model = flagship(RM, dev, f32, **kw)
        captured, launches, rgb = drive(label, model, scene, RM, counted,
                                        expected)
        check_dtype(f'{label} image', (rgb,), f32)
        by_path[label.replace(' ', '_').replace('(', '').replace(')', '')
                .replace('=', '')] = launches
        if label == 'V=2 f32':
            out['K1'] = check_attention('V=2 f32', EA,
                                        *captured['epipolar_attention'][0])
            args = captured['fused_exchange_epilogue'][0]
            out['K2'] = check_epilogue(
                'K2 fused_exchange_epilogue f32', GE.fused_exchange_epilogue,
                GE.fused_exchange_epilogue_reference, args, args[2:4],
                args[4], K2_TOL)
        elif label.startswith('V=2 fused'):
            log(f'{label}:')
            out['K4'] = check_render_core(FR,
                                          captured['fused_render_core'][0])
        elif label.startswith('V=3 (Path A)'):
            out['K1']['at_v3'] = check_attention(
                'V=3 f32', EA, *captured['epipolar_attention'][0])
            args = captured['fused_exchange_epilogue_multi'][0]
            out['K3'] = check_epilogue(
                'K3 fused_exchange_epilogue_multi f32',
                GE.fused_exchange_epilogue_multi,
                GE.fused_exchange_epilogue_multi_reference, args, args[2],
                args[3], K3_TOL)
        else:
            out['K9'] = check_mlp(FM, captured['fused_mlp2'][0],
                                  'K9 fused_mlp2 f32')
        del model, captured, rgb
        torch.cuda.empty_cache()
    return by_path, out


def fast_launches(exchange, lever, n_blocks=N_BLOCKS):
    """The launches per image of the fast renderer with ``lever`` (its
    keywords) on the path whose exchange is ``exchange``, in ``n_blocks``
    ray blocks: the pruned renderer runs a coarse pass without round 2
    (one K1, or one K4 without it) and the fine pass per ray block."""
    pruned = lever.get('pruned') is not None
    if exchange == 'fused_render_core':
        return {'fused_render_core': (2 if pruned else 1) * n_blocks,
                'epipolar_attention': 0, 'fused_exchange_epilogue': 0}
    out = {'epipolar_attention': (3 if pruned else 2) * n_blocks,
           exchange: (2 if pruned else 1) * n_blocks}
    if exchange == 'fused_exchange_epilogue':
        out['fused_render_core'] = 0
    return out


# Where aux and the local coordinates sit in K2's, K3's and K4's
# arguments.
F32_ARGS = {'fused_exchange_epilogue': (2, 3),
            'fused_exchange_epilogue_multi': (2,),
            'fused_render_core': (2, 3, 4)}


def as_f32(exchange, args):
    """A core kernel's captured arguments with aux and the local
    coordinates in f32 (tables, cells, weights and sizes as they are): the
    inputs of its f32 instantiation."""
    args = list(args)
    for i in F32_ARGS[exchange]:
        args[i] = (tuple(a.float() for a in args[i])
                   if isinstance(args[i], (tuple, list)) else args[i].float())
    return tuple(args)


def check_core(key, GE, FR, args, label):
    """K2, K3 or K4 (``key``) against its plain version on ``args``."""
    if key == 'fused_render_core':
        log(f'{label}:')
        return check_render_core(FR, args)
    if key == 'fused_exchange_epilogue':
        return check_epilogue(label, GE.fused_exchange_epilogue,
                              GE.fused_exchange_epilogue_reference, args,
                              args[2:4], args[4], K2_TOL)
    return check_epilogue(label, GE.fused_exchange_epilogue_multi,
                          GE.fused_exchange_epilogue_multi_reference, args,
                          args[2], args[3], K3_TOL)


def fast_eval(RM, EA, GE, FR, make_scene, dev, counted):
    """Phase 23: ``make_fast_renderer`` at full width (seed-0 weights,
    ``make_scene(0)``) on the V=2, V=2 fused render and V=3 default paths
    in bf16, with each lever of FAST_LEVERS, each image driven as phase 3
    drives it (the launch counts of ``fast_launches``) beside the dense
    image of the same model (the dense image timed and profiled, each
    bf16 lever's timed over one image); the f32 model with q8 on the same
    paths (launches and kernels checked, not timed). The
    q8 image equals the dense image of the dequantized pyramid (q * s),
    narrow at the full widths equals the dense image, within PATH_TOL.
    Each kernel's int8 instantiations (bf16 and f32 slot weights) against
    their plain versions at the flagship's shapes (q8) and at the pruned
    shapes (--fast, narrow), and K1, K2, K3 and K4 at the pruned renderer's
    shapes. Returns (launches by path, times by path and mode, the checks'
    numbers by kernel)."""
    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer)
    by_path, times = {}, {}
    numbers = {'K1': {}, 'pruned': {}, 'int8': {}, 'int8_f32': {}}
    for path, kw, exchange in FAST_PATHS:
        V = kw.get('n_view', 2)
        scene = make_scene(0, n_view=V, H=H, W=W, n_rays=H * W,
                           full_image=True, device=dev)
        uv = scene['query']['uv']
        names = ['epipolar_attention', exchange] + (
            ['fused_exchange_epilogue', 'fused_render_core'] if V == 2
            else [])
        cnt = {n: counted[n] for n in dict.fromkeys(names)}
        key = path.replace('=', '').replace(' ', '_').lower()
        for dtype in (torch.bfloat16, torch.float32):
            model = flagship(RM, dev, dtype, **kw)
            levers = FAST_LEVERS if dtype == torch.bfloat16 else (
                ('q8', dict(q8=True)),)
            suffix = '' if dtype == torch.bfloat16 else ' f32'
            if dtype == torch.bfloat16:
                t = times.setdefault(f'{path} dense', {})
                _, by_path[f'fast_{key}_dense'], rgb_dense = drive(
                    f'{path} dense', model, scene, RM, cnt,
                    fast_launches(exchange, {}), capture={}, times=t,
                    n_img=1)
            for name, lever in levers:
                label = f'{path} {name}{suffix}'
                capture = {exchange: (RM, exchange, 2)}
                if exchange != 'fused_render_core':
                    capture['epipolar_attention'] = (
                        RM, 'epipolar_attention', 2)
                # the bf16 levers' images are timed, not profiled (the
                # profiler's trace costs seconds an image); the f32 runs
                # check the kernels
                timed = dtype == torch.bfloat16
                captured, launches, rgb = drive(
                    label, model, scene, RM, cnt,
                    fast_launches(exchange, lever), capture=capture,
                    render_image=make_fast_renderer(model, N_BLOCKS,
                                                    **lever),
                    times=times.setdefault(label, {}) if timed else None,
                    timed=timed, n_img=1, profiled=False)
                if dtype == torch.float32:
                    check_dtype(f'{label} image', (rgb,), dtype)
                tag = name.replace(' ', '_').replace(',', '_')
                by_path[f'fast_{key}_{tag}{suffix.replace(" ", "_")}'] = (
                    launches)
                calls = captured[exchange]
                if dtype == torch.float32:
                    numbers['int8_f32'].setdefault(exchange, {})[path] = (
                        check_core(exchange, GE, FR, calls[0],
                                   f'{label}: {exchange} int8 f32'))
                elif name == 'q8':
                    numbers['int8'].setdefault(exchange, {})[path] = (
                        check_core(exchange, GE, FR, calls[0],
                                   f'{label}: {exchange} int8'))
                    check_q8_image(label, model, scene, rgb, RM)
                elif name == 'fast':
                    for i, when in enumerate(('coarse', 'fine')):
                        shape = f'{path} {when}'
                        numbers['int8'].setdefault(
                            f'{exchange} pruned', {})[shape] = check_core(
                                exchange, GE, FR, calls[i],
                                f'{label} {when}: {exchange} int8')
                        numbers['int8_f32'].setdefault(
                            f'{exchange} pruned', {})[shape] = check_core(
                                exchange, GE, FR,
                                as_f32(exchange, calls[i]),
                                f'{label} {when}: {exchange} int8 f32')
                elif name.startswith('pruned'):
                    for i, when in enumerate(('coarse', 'fine')):
                        shape = f'{path} {name} {when}'
                        numbers['pruned'].setdefault(exchange, {})[
                            shape] = check_core(exchange, GE, FR, calls[i],
                                                f'{label} {when}: {exchange}')
                        if exchange != 'fused_render_core':
                            numbers['K1'][shape] = check_attention(
                                shape, EA,
                                *captured['epipolar_attention'][i])
                else:
                    # every level at its full width passes unchanged
                    with torch.inference_mode():
                        z = model.encode(scene)
                    rgb_full, _ = make_fast_renderer(
                        model, N_BLOCKS,
                        narrow=tuple(f.shape[-1] for f in z))(scene, z, uv)
                    check_paths(f'{path} narrow at the full widths vs dense',
                                PATH_TOL, rgb_full, rgb_dense)
                del captured, calls, rgb
                torch.cuda.empty_cache()
            del model
            torch.cuda.empty_cache()
        for label in [k for k in times if k.startswith(path)]:
            t = times[label]
            busy = ('not profiled' if t['device_busy_ms'] is None else
                    f'device busy {t["device_busy_ms"]:.1f} ms of a '
                    f'profiled {t["profiled_wall_ms"]:.1f} ms')
            log(f'fast {label}: {t["image_ms"]:.1f} ms an image, '
                f'{t["rays_per_s"]:.1f} rays/s, {busy}')
        del scene, rgb_dense
    return by_path, times, numbers


def check_q8_image(label, model, scene, rgb_q8, RM):
    """The q8 image against the dense image of the same model rendered from
    the dequantized pyramid q * s (train/evaluation.py:quantize_pyramid's
    int8 levels and scales), within PATH_TOL: the scales' fold into W1 is
    the only difference."""
    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer, quantize_pyramid)
    with torch.inference_mode():
        z = model.encode(scene)
    z_q, _ = quantize_pyramid(model, z)
    z_deq = []
    for x, q in zip(z, z_q):
        x = x.float()
        s = torch.clamp(x.abs().amax(dim=tuple(range(x.ndim - 1))) / 127.0,
                        min=1e-8)
        z_deq.append((q.float() * s).to(model.dtype))
    rgb_deq, _ = make_scan_renderer(model, N_BLOCKS)(
        scene, tuple(z_deq), scene['query']['uv'])
    check_paths(f'{label} vs dense on the dequantized pyramid', PATH_TOL,
                rgb_q8, rgb_deq)


def check_cli(dev, build_dir, counted_v2, counted_v3, by_path, extra=()):
    """Phases 21-22: the port's CLI as a user runs it, with its defaults
    (the 122M model in f32, 64 samples at V=2 and 48 at V=3, 8 ray blocks,
    batch 12 of 192 rays): a 2-scene corpus of 256x455 frames written by
    ``tools/make_corpus.py`` under ``build/``, ``cli/eval.py`` on both
    scenes at ``--views 2`` (16 K1 and 8 K2 launches an image) and
    ``--views 3`` (16 K1 and 8 K3), LPIPS from phase 15's random weights,
    each scene's metrics finite and the first one's equal, within
    EVAL_TOL, to ``evaluate_scene`` of the same model and scene; then
    ``cli/train.py`` for 3 steps (the default route: no K1 or K2 launch),
    its losses finite and its final checkpoint written. Adds the eval
    launches to ``by_path``; returns the phases' numbers. ``extra``: flags
    added to every CLI call (none on the card)."""
    import os
    import shutil

    import torch
    from cross_attention_renderer_torch.cli import common as CC
    from cross_attention_renderer_torch.cli import eval as eval_cli
    from cross_attention_renderer_torch.cli import train as train_cli
    from cross_attention_renderer_torch.data.realestate import (
        RealEstate10kVis)
    from cross_attention_renderer_torch.losses.lpips import load_lpips
    from cross_attention_renderer_torch.tools import make_corpus
    from cross_attention_renderer_torch.train.evaluation import (
        evaluate_scene)
    corpus, logs = build_dir / 'smoke_corpus', build_dir / 'smoke_logs'
    for d in (corpus, logs):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    make_corpus.main(['--root', str(corpus), '--scenes', '2',
                      '--defects', '0'])
    out = {'corpus_s': time.perf_counter() - t0}
    frames, poses = corpus / 'frames', corpus / 'poses.mat'
    os.environ['LPIPS_WEIGHTS'] = str(build_dir / 'lpips_random.npz')
    data = ['--img_root', str(frames), '--pose_root', str(poses),
            '--logging_root', str(logs), *extra]
    for views, counted in ((2, counted_v2), (3, counted_v3)):
        label = f'CLI eval --views {views}'
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = eval_cli.main([*data, '--max_scenes', '2', '--views',
                             str(views), '--experiment_name',
                             f'eval_v{views}'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        per_image = 2 * CLI_CHUNKS, CLI_CHUNKS
        expected = dict(zip(counted, (2 * n for n in per_image)))
        log(f'{label}: launches {launches} for 2 scenes, means '
            f'{res["means"]}, seconds a scene '
            f'{[round(r["seconds"], 3) for r in res["scenes"]]}, '
            f'{wall:.1f} s in all')
        if launches != expected:
            raise RuntimeError(f'{label}: launches {launches}, expected '
                               f'{expected}')
        if len(res['scenes']) != 2 or not all(
                np_isfinite(v) for r in res['scenes'] for v in r.values()):
            raise RuntimeError(f'{label}: metrics {res["scenes"]}')
        by_path[f'cli_eval_v{views}'] = launches
        opt = CC.base_parser('x').parse_args(['--views', str(views),
                                              *extra])
        model = CC.build_model(opt).eval()
        scene = CC.scene_batch(RealEstate10kVis(
            frames, poses, num_ctxt_views=views)[0], opt.device)
        size = scene['context']['rgb'].shape[2:4]
        want = evaluate_scene(model, scene, *size, CLI_CHUNKS,
                              lpips_fn=load_lpips(device=opt.device))
        got = res['scenes'][0]
        log(f'{label}: first scene {got}, evaluate_scene '
            f'{ {k: float(want[k]) for k in ("psnr", "ssim", "lpips")} }')
        if (abs(got['psnr'] - float(want['psnr'])) > EVAL_TOL['psnr']
                or abs(got['ssim'] - float(want['ssim'])) > EVAL_TOL['ssim']
                or abs(got['lpips'] - float(want['lpips']))
                > EVAL_TOL['lpips_rel'] * abs(float(want['lpips']))):
            raise RuntimeError(f'{label} disagrees with evaluate_scene')
        out[f'eval_v{views}'] = {'launches': launches, 'means': res['means'],
                                 'seconds': [r['seconds']
                                             for r in res['scenes']],
                                 'wall_s': wall}
        del model, scene, res
        torch.cuda.empty_cache()

    counted = dict(counted_v2)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_cli.main([*data, '--max_steps', '3', '--steps_til_log', '1',
                          '--experiment_name', 'train'])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    steps = res['log']
    log(f'CLI train (batch 12, 192 rays, f32): '
        + '; '.join(f'step {r["step"]} loss {r["total_loss"]:.5f} '
                    f'grad_norm {r["grad_norm"]:.4f} {r["ms"]:.1f} ms'
                    for r in steps)
        + f'; launches {launches}; {wall:.1f} s in all')
    final = logs / 'train' / 'checkpoints' / 'final.pt'
    if (res['state'].step != 3 or len(steps) != 3 or not final.exists()
            or not all(np_isfinite(r['total_loss']) for r in steps)
            or any(launches.values())):
        raise RuntimeError(f'CLI train: step {res["state"].step}, log '
                           f'{steps}, launches {launches}')
    out['train'] = {'steps': steps, 'wall_s': wall, 'launches': launches}
    del res
    shutil.rmtree(logs, ignore_errors=True)
    return out


# Phase 24, the other encoders, view counts and ablation flags at full width
# (bf16, 256x256, 8 blocks of 8,192 rays): (label, model kwargs, the
# kernels a path launches with their counts per image, the kernels it runs
# at a new mode or shape with the entry of the kernels line each counts
# under; each of those is checked on its first call). The four-level
# encoders put K2, K3 and K4 in their 4-level mode.
ABLATION_PATHS = (
    ('ResNet V=2', dict(model='resnet', npoints=64),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8},
     {'fused_exchange_epilogue': 'fused_exchange_epilogue_l4',
      'epipolar_attention': 'epipolar_attention_c256'}),
    ('ResNet V=3', dict(model='resnet', n_view=3),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi': 'fused_exchange_epilogue_multi_l4',
      'epipolar_attention': 'epipolar_attention_c256'}),
    ('ResNet V=2 fused render', dict(model='resnet', npoints=64,
                                     fused_render=True),
     {'fused_render_core': 8, 'epipolar_attention': 0,
      'fused_exchange_epilogue': 0},
     {'fused_render_core': 'fused_render_core_l4'}),
    ('U-Net V=2', dict(model='unet', npoints=64),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8},
     {'fused_exchange_epilogue': 'fused_exchange_epilogue_l4',
      'epipolar_attention': 'epipolar_attention_c480'}),
    ('U-Net V=3', dict(model='unet', n_view=3),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi': 'fused_exchange_epilogue_multi_l4',
      'epipolar_attention': 'epipolar_attention_c480'}),
    ('U-Net V=2 fused render', dict(model='unet', npoints=64,
                                    fused_render=True),
     {'fused_render_core': 8, 'epipolar_attention': 0,
      'fused_exchange_epilogue': 0},
     {'fused_render_core': 'fused_render_core_l4'}),
    ('V=4', dict(n_view=4),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi': 'fused_exchange_epilogue_multi_s4',
      'epipolar_attention': 'epipolar_attention_vp192'}),
    # 4 self and 12 cross fuse calls a block
    ('V=4 compat', dict(n_view=4, **PATH_B),
     {'epipolar_attention': 16, 'fused_mlp2': 16 * 8,
      'fused_exchange_epilogue_multi': 0},
     {'epipolar_attention': 'epipolar_attention_vp192'}),
    ('V=1', dict(n_view=1, npoints=64),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 0},
     {'epipolar_attention': 'epipolar_attention_c576'}),
    ('U-Net V=1', dict(model='unet', n_view=1, npoints=64),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 0},
     {'epipolar_attention': 'epipolar_attention_c960'}),
    ('V=2 no_sample', dict(npoints=64, no_sample=True),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8}, {}),
    ('V=2 no_multiview', dict(npoints=64, no_multiview=True),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8}, {}),
    ('V=2 no_high_freq', dict(npoints=64, no_high_freq=True),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8}, {}),
    ('V=2 no_latent_concat', dict(npoints=64, no_latent_concat=True),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 0},
     {'epipolar_attention': 'epipolar_attention_c576'}),
)
# Flags the same model takes as plain attributes (read at each forward):
# the V=2 flagship and the V=4 model are built once for them.
ATTRIBUTE_FLAGS = ('no_sample', 'no_multiview', 'no_high_freq',
                   'reference_exchange_compat', 'fused_mlp')
# The small-input agreement (phase 8's) of the sorted stream and the
# one-hot and banded gathers at V=4 and at four levels: (label, kwargs,
# the launches of one forward).
ABLATION_SMALL = (
    ('V=4 sorted', dict(n_view=4, sorted_stream=True),
     {'resident_gather': 6}),
    ('V=4 compat one-hot', dict(n_view=4, gather='onehot', **PATH_B),
     {'onehot_gather': 6, 'fused_mlp2': 16}),
    ('ResNet V=2 sorted', dict(model='resnet', sorted_stream=True),
     {'resident_gather': 8}),
    ('U-Net V=3 sorted', dict(model='unet', n_view=3, sorted_stream=True),
     {'resident_gather': 8}),
    ('ResNet V=3 compat one-hot', dict(model='resnet', n_view=3,
                                       gather='onehot', **PATH_B),
     {'onehot_gather': 8, 'fused_mlp2': 9}),
    ('U-Net V=4 compat banded', dict(model='unet', n_view=4,
                                     gather='banded', **PATH_B),
     {'banded_gather': 8, 'fused_mlp2': 16}),
)


# The paths whose core call (the 'resident' plan's) is repeated on one set
# of inputs, bit for bit: K4 at the U-Net's widths (phase 24), K3 at S = 6
# (phase 28).
REPEATED = ('U-Net V=2 fused render', 'V=6')
REPEATS = 20


def unfused_twin(model):
    """``model`` on its unfused route: a shallow copy (the same weights)
    with the fused epilogues, the fused render, K1 and K9 off, as the
    trainer's clone and more (the plain PyTorch path of the JAX package's
    ``fused_epilogue=False``)."""
    import copy
    twin = copy.copy(model)
    twin.fused_epilogue = twin.fused_attention = False
    twin.fused_render = twin.fused_mlp = False
    return twin


def ablation_model(RM, dev, cache, kw):
    """The full-width bf16 model of ``kw`` from seed 0, the attribute flags
    set on a model built once per structure (``cache``). The decoder reads
    the V views' latents side by side, so its random output grows with V
    (at 1/64 the V=3 compat image reaches -0.875, the V=4 one -1.14): above
    two views its last layer is drawn a further sqrt(2 / V) smaller, so
    that the random image keeps the V=2 model's range."""
    import math

    import torch
    struct = {k: v for k, v in kw.items() if k not in ATTRIBUTE_FLAGS}
    key = tuple(sorted(struct.items()))
    if key not in cache:
        cache.clear()
        torch.cuda.empty_cache()
        model = flagship(RM, dev, **struct)
        if model.n_view > 2:
            with torch.no_grad():
                model.phi.lin_out.weight.mul_(math.sqrt(2 / model.n_view))
        cache[key] = model
    model = cache[key]
    for flag in ATTRIBUTE_FLAGS:
        setattr(model, flag, kw.get(flag, False))
    return model


def ablations(RM, EA, GE, FR, FM, PG, SG, BG, make_scene, dev, counted,
              build_dir, cli_extra=()):
    """Phase 24: the ResNet34 and U-Net encoders, 1 and 4 views and the
    four ablation flags at full width (``ABLATION_PATHS``), each image
    driven as phase 3 drives it (its launch counts, finite, RGB in
    [-1, 1.5]) and timed over one image, then held against the same
    model's unfused route (``unfused_twin``) within PATH_TOL. The first call of each path's new kernel mode or shape
    against its plain version, timed beside its bound. The small-input
    agreement of the sorted stream and the one-hot and banded gathers at
    V=4 and at four levels (``ABLATION_SMALL``). One default-route train
    step of each new encoder at the flagship's batch (ms, peak GB). The
    CLI's train (2 steps) and eval (one scene) with ``--model resnet
    --no_sample``. Returns (launches by path, times by path, the checks'
    numbers by kernel-line entry, the train and CLI numbers)."""
    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer)
    checks = {'fused_exchange_epilogue': lambda label, args: check_epilogue(
                  label, GE.fused_exchange_epilogue,
                  GE.fused_exchange_epilogue_reference, args, args[2:4],
                  args[4], K2_TOL),
              'fused_exchange_epilogue_multi': lambda label, args:
                  check_epilogue(label, GE.fused_exchange_epilogue_multi,
                                 GE.fused_exchange_epilogue_multi_reference,
                                 args, args[2], args[3], K3_TOL),
              'fused_render_core': lambda label, args: check_render_core(
                  FR, args),
              'epipolar_attention': lambda label, args: check_attention(
                  label, EA, *args)}
    by_path, times, numbers, cache = {}, {}, {}, {}
    for label, kw, expected, checked in ABLATION_PATHS:
        V = kw.get('n_view', 2)
        model = ablation_model(RM, dev, cache, kw)
        scene = make_scene(0, n_view=V, H=H, W=W, n_rays=H * W,
                           full_image=True, device=dev)
        key = label.lower().replace(' ', '_').replace('=', '').replace(
            '-', '')
        captured, launches, rgb = drive(
            label, model, scene, RM, {n: counted[n] for n in expected},
            expected, capture={n: (RM, n, 1) for n in checked},
            times=times.setdefault(label, {}), n_img=1, profiled=False)
        by_path[key] = launches
        twin = unfused_twin(model)
        with torch.inference_mode():
            rgb_ref, _ = make_scan_renderer(twin, N_BLOCKS)(
                scene, twin.encode(scene), scene['query']['uv'])
        check_paths(f'{label} vs its unfused route', PATH_TOL, rgb.float(),
                    rgb_ref.float())
        del twin, rgb, rgb_ref
        for name, entry in checked.items():
            result = checks[name](f'{label}', captured[name][0])
            if label in REPEATED:
                result['repeats'] = repeat_bitwise(
                    label, counted[name], captured[name][0], REPEATS)
            numbers.setdefault(entry, {})[label] = result
        del captured, scene
        torch.cuda.empty_cache()
    cache.clear()
    torch.cuda.empty_cache()

    kernels = {'resident_gather': SG.resident_gather,
               'onehot_gather': PG.onehot_gather,
               'banded_gather': BG.banded_gather, 'fused_mlp2': FM.fused_mlp2}
    for label, kw, launches in ABLATION_SMALL:
        by_path[f'small_{label.lower().replace(" ", "_")}'] = \
            small_agreement(label, RM, make_scene, dev, counted={
                n: (kernels[n], c) for n, c in launches.items()}, **kw)

    from cross_attention_renderer_torch.tools import bench_train as BT
    train = {}
    with torch.enable_grad():
        for model_kw in (dict(model='resnet'), dict(model='unet')):
            train[model_kw['model']] = encoder_train_step(
                RM, make_scene, dev, BT.BATCH, BT.RAYS, model_kw)
        cli = ablation_cli(dev, build_dir, dict(
            [(n, counted[n]) for n in ('epipolar_attention',
                                       'fused_exchange_epilogue')]),
            cli_extra)
    return by_path, times, numbers, {'train': train, 'cli': cli}


def encoder_train_step(RM, make_scene, dev, batch, rays, model_kw):
    """One default-route train step (``train/trainer.py``, the unfused
    exchange and the plain attention) of a full-width bf16 model of
    ``model_kw`` on a batch of 256x256 scenes: the first step's loss and
    grad_norm finite, then 3 steps between CUDA events and the peak
    memory allocated."""
    import torch
    from cross_attention_renderer_torch.train import trainer as T
    model = RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=0,
                                      device=dev, npoints=64, **model_kw)
    scene = make_scene(0, batch=batch, n_view=2, H=H, W=W, n_rays=rays,
                       device=dev)
    cfg = T.TrainConfig()
    state = T.create_train_state(model, cfg)
    step = T.make_train_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, scene)
    loss, gnorm = float(m['total_loss']), float(m['grad_norm'])
    label = f'train step {model_kw["model"]}'
    if not (np_isfinite(loss) and np_isfinite(gnorm)):
        raise RuntimeError(f'{label}: loss {loss}, grad_norm {gnorm}')
    n = 3
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        state, m = step(state, scene)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / n
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f'{label} (batch {batch}, {rays} rays, 256x256, bf16, default '
        f'route): first loss {loss:.5f}, grad_norm {gnorm:.4f}, '
        f'{ms:.1f} ms a step, peak {peak:.2f} GB')
    del model, state, step, scene
    torch.cuda.empty_cache()
    return {'loss': loss, 'grad_norm': gnorm, 'ms_per_step': ms,
            'peak_gb': peak, 'batch': batch, 'rays': rays}


def ablation_cli(dev, build_dir, counted, extra=()):
    """``cli/train.py`` for 2 steps and ``cli/eval.py`` on one scene, both
    with ``--model resnet --no_sample`` at their defaults (f32) on phase
    21's corpus: finite losses and metrics, the final checkpoint, and the
    eval's launches (16 K1 and 8 K2 in the 4-level mode an image).
    ``extra``: flags added to both calls (none on the card)."""
    import shutil

    import torch
    from cross_attention_renderer_torch.cli import eval as eval_cli
    from cross_attention_renderer_torch.cli import train as train_cli
    corpus, logs = build_dir / 'smoke_corpus', build_dir / 'smoke_logs_ab'
    shutil.rmtree(logs, ignore_errors=True)
    flags = ['--img_root', str(corpus / 'frames'), '--pose_root',
             str(corpus / 'poses.mat'), '--logging_root', str(logs),
             '--model', 'resnet', '--no_sample', *extra]
    out = {}
    t0 = time.perf_counter()
    res = train_cli.main([*flags, '--max_steps', '2', '--steps_til_log',
                          '1', '--experiment_name', 'train'])
    steps = res['log']
    final = logs / 'train' / 'checkpoints' / 'final.pt'
    log('CLI train --model resnet --no_sample: '
        + '; '.join(f'step {r["step"]} loss {r["total_loss"]:.5f} '
                    f'{r["ms"]:.1f} ms' for r in steps))
    if (res['state'].step != 2 or not final.exists()
            or not all(np_isfinite(r['total_loss']) for r in steps)):
        raise RuntimeError(f'CLI train --model resnet: {steps}')
    out['train'] = {'steps': steps, 'wall_s': time.perf_counter() - t0}
    del res
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = eval_cli.main([*flags, '--max_scenes', '1', '--experiment_name',
                         'eval'])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    log(f'CLI eval --model resnet --no_sample: launches {launches}, '
        f'metrics {res["scenes"]}')
    if (launches != {'epipolar_attention': 2 * CLI_CHUNKS,
                     'fused_exchange_epilogue': CLI_CHUNKS}
            or len(res['scenes']) != 1
            or not all(np_isfinite(v) for v in res['scenes'][0].values())):
        raise RuntimeError(f'CLI eval --model resnet: launches {launches}, '
                           f'{res["scenes"]}')
    out['eval'] = {'launches': launches, 'scene': res['scenes'][0],
                   'wall_s': time.perf_counter() - t0}
    shutil.rmtree(logs, ignore_errors=True)
    return out


def rot_deg(Ra, Rb) -> float:
    import numpy as np
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))


def check_superpoint(PSP, images, dev) -> dict:
    """SuperPoint (seed-0 weights) on the card against the CPU on the same
    (2, 1, 256, 256) images: score maps, valid keypoints, scores and
    descriptors (SP_* tolerances). Returns the CPU's features and the
    numbers."""
    import torch
    params = PSP.init_params(0)
    nets = {d: PSP.SuperPoint.from_params(params, device=d)
            for d in (dev, 'cpu')}
    x = {d: images.to(d) for d in nets}
    feats = {d: nets[d](x[d], max_keypoints=UNPOSED_KEYPOINTS)
             for d in nets}
    maps = {d: nets[d].dense(x[d])[0].cpu() for d in nets}
    diff = (maps[dev] - maps['cpu']).abs()
    flips = int((diff > SP_SCORE_TOL).sum())
    out = {'score_map_pixels_off': flips,
           'score_map_max_err_else': float(diff[diff <= SP_SCORE_TOL].max())}
    swaps, score_err, desc_err = 0, 0.0, 0.0
    for b in range(images.shape[0]):
        sides = {}
        for d in nets:
            f = {k: v[b].cpu() for k, v in feats[d].items()}
            keys = (f['keypoints'][:, 1] * 4096 + f['keypoints'][:, 0])
            sides[d] = {int(k): i for i, k in enumerate(keys.tolist())
                        if f['valid'][i]}, f
        (a, fa), (c, fc) = sides[dev], sides['cpu']
        common = sorted(set(a) & set(c))
        swaps = max(swaps, len(set(a) ^ set(c)))
        ia = torch.tensor([a[k] for k in common], dtype=torch.long)
        ic = torch.tensor([c[k] for k in common], dtype=torch.long)
        score_err = max(score_err, max_err(fa['scores'][ia],
                                           fc['scores'][ic]))
        desc_err = max(desc_err, max_err(fa['descriptors'][ia],
                                         fc['descriptors'][ic]))
        out.setdefault('valid', []).append(len(c))
    out.update(keypoints_swapped=swaps, score_max_err=score_err,
               descriptor_max_err=desc_err)
    log(f'SuperPoint card vs CPU: {out}')
    if (flips > SP_SWAPS * UNPOSED_KEYPOINTS
            or out['score_map_max_err_else'] > SP_SCORE_TOL
            or swaps > SP_SWAPS * min(out['valid'])
            or score_err > SP_SCORE_TOL or desc_err > SP_DESC_TOL):
        raise RuntimeError('SuperPoint on the card disagrees with the CPU')
    out['ms'] = cuda_ms(lambda: nets[dev](
        x[dev], max_keypoints=UNPOSED_KEYPOINTS), 10)
    return feats['cpu'], out


def check_superglue(PSG, feats, dev) -> dict:
    """SuperGlue (seed-0 weights, 20 iterations) on the card against the
    CPU, both fed the CPU's SuperPoint features: matches equal, matching
    scores within SG_SCORE_TOL. Compared at a match threshold of 0 (every
    mutual nearest pair), since random weights put no score above the
    demo's 0.2; the count above 0.2 is reported. Returns the numbers."""
    import torch
    params = PSG.init_params(0)
    data = {f'{k}{i}': feats[k][i:i + 1]
            for k in ('keypoints', 'scores', 'descriptors', 'valid')
            for i in (0, 1)}
    out = {}
    for d in (dev, 'cpu'):
        net = PSG.SuperGlue.from_params(params, device=d)
        dd = dict({k: v.to(d) for k, v in data.items()}, image_shape=(H, W))
        out[d] = {k: v.cpu() for k, v in net(
            dd, sinkhorn_iterations=UNPOSED_SINKHORN,
            match_threshold=0.0).items()}
        if d == dev:
            ms = cuda_ms(lambda: net(dd, sinkhorn_iterations=UNPOSED_SINKHORN),
                         10)
    same = all(torch.equal(out[dev][k], out['cpu'][k])
               for k in ('matches0', 'matches1'))
    err = max(max_err(out[dev][k], out['cpu'][k])
              for k in ('matching_scores0', 'matching_scores1'))
    m0, s0 = out['cpu']['matches0'], out['cpu']['matching_scores0']
    numbers = {'mutual_matches': int((m0 > -1).sum()),
               'matches_above_0.2': int(((m0 > -1) & (s0 > 0.2)).sum()),
               'matches_equal': same, 'score_max_err': err, 'ms': ms}
    log(f'SuperGlue card vs CPU: {numbers}')
    if not same or err > SG_SCORE_TOL:
        raise RuntimeError('SuperGlue on the card disagrees with the CPU')
    return numbers


def unposed(RM, dev, attention, epilogue, card) -> dict:
    """Phase 25: the unposed path, as the module docstring says. Returns
    the trajectory's launches of K1 and K2 and prints the ``unposed``
    line."""
    import numpy as np
    import torch
    from cross_attention_renderer_torch.cli.render_unposed import (
        render_unposed)
    from cross_attention_renderer_torch.data.synthetic import (
        noise_world_pair)
    from cross_attention_renderer_torch.pose import classical as PCL
    from cross_attention_renderer_torch.pose import superglue as PSG
    from cross_attention_renderer_torch.pose import superpoint as PSP
    from cross_attention_renderer_torch.pose import unposed as PU
    K = PU.DEMO_INTRINSICS[:3, :3].astype(np.float64)
    g0, g1, c2w0, c2w1 = noise_world_pair(K)
    rel = np.linalg.inv(c2w1) @ c2w0            # x_cam1 = rel @ x_cam0
    out = {'card': card}

    # the classical frontend, on the card and on the CPU
    match = {}
    for d in (dev, 'cpu'):
        PCL.match_pair_classical(g0, g1, device=d)    # loads the kernels
        t0 = time.perf_counter()
        match[d] = PCL.match_pair_classical(g0, g1, device=d)
        out[f'classical_ms_{"card" if d == dev else "cpu"}'] = (
            time.perf_counter() - t0) * 1e3
    kp_err = max(float(np.abs(match[dev][k] - match['cpu'][k]).max())
                 for k in ('keypoints0', 'keypoints1'))
    n_match = int((match[dev]['matches'] > -1).sum())
    out['classical'] = {
        'matches': n_match, 'keypoint_max_err_px': kp_err,
        'matches_equal': bool(np.array_equal(match[dev]['matches'],
                                             match['cpu']['matches']))}
    log(f'classical frontend card vs CPU: {out["classical"]}')
    if not out['classical']['matches_equal'] or kp_err > 1e-4:
        raise RuntimeError('the classical frontend on the card disagrees '
                           'with the CPU')
    t0 = time.perf_counter()
    pose = PU.estimate_pose(match[dev]['mkpts0'].astype(np.float64),
                            match[dev]['mkpts1'].astype(np.float64), K, K)
    out['estimate_pose_ms'] = (time.perf_counter() - t0) * 1e3
    if pose is None:
        raise RuntimeError('estimate_pose found no pose on the world pair')
    t_gt = rel[:3, 3] / np.linalg.norm(rel[:3, 3])
    out['pose'] = {'rot_err_deg': rot_deg(pose[0], rel[:3, :3]),
                   't_cos': float(pose[1] @ t_gt),
                   'inliers': int(pose[2].sum())}
    log(f'estimate_pose on the card\'s matches: {out["pose"]}, '
        f'{out["estimate_pose_ms"]:.1f} ms on the host')
    if (out['pose']['rot_err_deg'] > UNPOSED_POSE_GATE[0]
            or out['pose']['t_cos'] < UNPOSED_POSE_GATE[1]):
        raise RuntimeError(f'unposed pose off the truth: {out["pose"]}')

    # SuperPoint and SuperGlue at the demo's configuration
    images = torch.from_numpy(np.stack([g0, g1])[:, None])
    feats, out['superpoint'] = check_superpoint(PSP, images, dev)
    out['superglue'] = check_superglue(PSG, feats, dev)
    del feats
    torch.cuda.empty_cache()

    # the trajectory: 76 frames of the flagship in f32
    model = flagship(RM, dev, torch.float32, npoints=64)
    counted = dict([attention, epilogue])
    stamps, first = [], {}

    def sink(rgb, i, n):
        lo, hi = float(rgb.min()), float(rgb.max())    # waits for the frame
        stamps.append(time.perf_counter())
        if not (bool(torch.isfinite(rgb).all()) and lo >= -1.0
                and hi <= 1.5):
            raise RuntimeError(f'unposed frame {i}: rgb in [{lo}, {hi}]')
        if i == 0:
            first['rgb'] = rgb.float().clone()

    im0, im1 = (np.repeat(g[..., None], 3, -1) for g in (g0, g1))
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    traj = render_unposed(model, im0, im1, sink, n_frames=UNPOSED_POSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    n = len(stamps)
    expected = {'epipolar_attention': 2 * N_BLOCKS * n,
                'fused_exchange_epilogue': N_BLOCKS * n}
    log(f'unposed trajectory: {n} frames, launches {launches}')
    if n != UNPOSED_POSES - 4 or launches != expected:
        raise RuntimeError(f'unposed trajectory: {n} frames, launches '
                           f'{launches}, expected {expected}')
    ms_frame = (stamps[-1] - stamps[0]) / (n - 1) * 1e3
    out['trajectory'] = {'frames': n, 'wall_s': wall,
                         'ms_per_frame': ms_frame,
                         'frames_per_s': 1e3 / ms_frame,
                         'launches': launches}

    # frame 0 through phase 3's drive, then one profiled frame
    def tensor(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    scene0 = {'context': {k: tensor(v) for k, v in traj['context'].items()},
              'query': {k: tensor(traj['query'][k][:, :1])
                        for k in ('cam2world', 'intrinsics', 'uv')}}
    times = {}
    _, _, rgb0 = drive('unposed frame 0', model, scene0, RM, counted,
                       {'epipolar_attention': 2 * N_BLOCKS,
                        'fused_exchange_epilogue': N_BLOCKS},
                       times=times, n_img=1)
    check_paths('unposed frame 0 vs drive', PATH_TOL,
                first['rgb'].reshape(rgb0.shape), rgb0)
    out['trajectory'].update(
        profiled_wall_ms=times['profiled_wall_ms'],
        device_busy_ms=times['device_busy_ms'],
        device_busy_share=times['device_busy_ms'] / times['profiled_wall_ms'])
    log(f'unposed trajectory: {ms_frame:.1f} ms a frame, '
        f'{1e3 / ms_frame:.2f} frames/s, one profiled frame '
        f'{times["device_busy_ms"]:.1f} of {times["profiled_wall_ms"]:.1f} ms '
        'device busy')
    print(json.dumps({'unposed': out}), flush=True)
    del model, traj, scene0, rgb0, first
    torch.cuda.empty_cache()
    return launches


def capability(RM, EA, GE, dev, counted, build_dir, card):
    """Phase 26: the capability path, as the module docstring says.
    Returns the kernel entries of its new shapes and prints the
    ``capability`` line."""
    import numpy as np
    import torch
    from cross_attention_renderer_torch.tools import capability_run as CR
    from cross_attention_renderer_torch.tools import eval_pruned as EP
    from cross_attention_renderer_torch.tools import (
        make_fast_eval_demo as DEMO)
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)
    from cross_attention_renderer_torch.utils.params_io import load_params
    t_start = time.perf_counter()
    out = {'card': card, 'protocol': dict(CAPABILITY)}
    save = build_dir / 'capability_medium.npz'

    # (a) the capability run, its train steps' launches counted apart
    train_launches = dict.fromkeys(counted, 0)
    make_step = CR.make_train_step

    def counting_step(model, cfg):
        step = make_step(model, cfg)

        def wrapped(state, scene):
            before = {n: fn.launches for n, fn in counted.items()}
            result = step(state, scene)
            for n, fn in counted.items():
                train_launches[n] += fn.launches - before[n]
            return result
        return wrapped

    for fn in counted.values():
        fn.launches = 0
    CR.make_train_step = counting_step
    try:
        with torch.enable_grad():
            run = CR.run(**CAPABILITY, device=dev, save=str(save),
                         out=str(build_dir / 'capability_demo.png'),
                         log=log)
    finally:
        CR.make_train_step = make_step
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counted.items()}
    # step 0, every eval_every steps, the last parameters, the best ones
    n_evals = 3 + CAPABILITY['steps'] // CAPABILITY['eval_every']
    want = fast_launches('fused_exchange_epilogue', {}, n_evals)
    log(f'capability run launches: {launches} ({n_evals} evals; training '
        f'{train_launches})')
    if any(train_launches.values()) or launches != want:
        raise RuntimeError(f'capability run: unexpected launches {launches}'
                           f', training {train_launches}, expected {want}')
    curve = run['curve']
    if not all(np.isfinite([r['loss'], r['grad_norm'], r['psnr']]).all()
               for r in curve):
        raise RuntimeError(f'capability run: a non-finite eval row {curve}')
    out.update(curve=curve, step0_psnr=run['step0_psnr'],
               best_psnr=run['best_psnr'], final_psnr=run['final_psnr'],
               steps_per_s=run['steps_per_s'], peak_gb=run['peak_gb'],
               params_m=run['params_m'], launches=launches,
               train_launches=train_launches)
    log(f'capability run: best {run["best_psnr"]:.2f} dB (floor '
        f'{CAPABILITY_FLOOR_DB}), {run["steps_per_s"]:.2f} steps/s, peak '
        f'{run["peak_gb"]} GB')
    if run['best_psnr'] < CAPABILITY_FLOOR_DB:
        raise RuntimeError('capability run: the best held-out PSNR is under '
                           'the floor')

    # the last eval image (the best parameters) against the plain route
    # of the same weights, and the saved file in a fresh model
    model = run['model']
    held_out = CR.to_scene(CR.load_world(CR.HELD_OUT, CAPABILITY['world']),
                           dev)
    plain = model.clone()
    plain.fused_attention = plain.fused_epilogue = False
    before = {n: fn.launches for n, fn in counted.items()}
    with torch.inference_mode():
        plain_out = plain(held_out)
    if {n: fn.launches for n, fn in counted.items()} != before:
        raise RuntimeError('the plain route launched a kernel')
    pred = torch.from_numpy(run['pred'])
    check_paths('capability eval vs the plain route', PATH_TOL, pred,
                plain_out['rgb'].float().cpu())
    out['plain_route_err'] = max_err(pred, plain_out['rgb'].cpu())
    # the held-out rays that no context view sees render no image
    valid = plain_out['valid_mask'][0, :, 0].bool().cpu().numpy()
    out['held_out_valid_fraction'] = float(valid.mean())
    out['best_psnr_valid_rays'] = CR.psnr(run['pred'][0, 0][valid],
                                          run['gt'][0, 0][valid])
    log(f'capability: {100 * valid.mean():.2f}% of the held-out rays are '
        f'valid; the best image over them: '
        f'{out["best_psnr_valid_rays"]:.2f} dB')
    fresh = CR.build_model(CAPABILITY['config'], CAPABILITY['dtype'], dev)
    fresh.load_state_dict(load_params(str(save)))
    with torch.inference_mode():
        again = fresh(held_out)['rgb'].float().cpu()
    if not torch.equal(again, pred):
        raise RuntimeError('the saved parameters render another image')
    log('capability: the saved parameters reload and render the same image '
        'bit for bit')

    # f32 K1 and K2 at the eval's shape (the held-out image in one forward)
    numbers = {}
    capture = {'epipolar_attention': (RM, 'epipolar_attention', 2),
               'fused_exchange_epilogue': (RM, 'fused_exchange_epilogue',
                                           1)}
    calls = record_calls(capture, lambda: model(held_out))
    numbers['f32'] = {
        'epipolar_attention': check_attention(
            'capability eval f32', EA, *calls['epipolar_attention'][0]),
        'fused_exchange_epilogue': check_core(
            'fused_exchange_epilogue', GE, None,
            calls['fused_exchange_epilogue'][0],
            'K2 capability eval f32')}
    # where a train step's time goes: one profiled step of the trained
    # model on a batch of the run's shape, after a warm-up step
    state = create_train_state(model, TrainConfig(lr=CAPABILITY['lr']))
    step = make_train_step(model, TrainConfig(lr=CAPABILITY['lr']))
    batch = CR.batch_scene([CR.load_world(s, CAPABILITY['world'])
                            for s in range(2)], np.random.default_rng(1),
                           dev)
    with torch.enable_grad():
        step(state, batch)
        out['train_step_profile'] = profile_device(
            'capability train step', lambda: step(state, batch))
    del run, model, plain, fresh, calls, state, step, batch
    torch.cuda.empty_cache()

    # (b) eval_pruned at its defaults, bf16, on the saved parameters
    t0 = time.perf_counter()
    model = CR.build_model(CAPABILITY['config'], 'bf16', dev).eval()
    model.load_state_dict(load_params(str(save)))
    for fn in counted.values():
        fn.launches = 0
    table = EP.evaluate(model, device=dev, **EVAL_PRUNED)
    torch.cuda.synchronize()
    total = {n: fn.launches for n, fn in counted.items()}
    renders = EVAL_PRUNED['worlds'] * (1 + EVAL_PRUNED['iters'])
    want_total = dict.fromkeys(counted, 0)
    for mode, row in table.items():
        pruned = 'pruned' in mode or 'p+' in mode
        want = fast_launches('fused_exchange_epilogue',
                             {'pruned': EVAL_PRUNED['pruned'] if pruned
                              else None}, EVAL_PRUNED['n_chunks'])
        if row['launches'] != want or not np.isfinite(row['psnr']):
            raise RuntimeError(f'eval_pruned {mode}: launches '
                               f'{row["launches"]} (expected {want}), psnr '
                               f'{row["psnr"]}')
        for n in want_total:
            want_total[n] += renders * want[n]
        log(f'eval_pruned {mode:>13}: {row["psnr"]:.3f} dB, '
            f'{row["ms"]:.2f} ms an image, {row["rays_per_s"]:,.0f} rays/s, '
            f'launches an image {row["launches"]}')
    if total != want_total:
        raise RuntimeError(f'eval_pruned: launches {total}, expected '
                           f'{want_total}')
    gap = abs(table['q8']['psnr'] - table['dense']['psnr'])
    log(f'eval_pruned: q8 {gap:.4f} dB from dense (gate {Q8_GATE_DB})')
    if gap > Q8_GATE_DB:
        raise RuntimeError('eval_pruned: q8 is too far from dense')
    out['eval_pruned'] = dict(EVAL_PRUNED, modes=table, launches=total,
                              seconds=time.perf_counter() - t0)

    # bf16 K1 and K2 (bf16 and int8 tables) at the dense and pruned shapes
    scene = CR.to_scene(CR.load_world(200000, EVAL_PRUNED['world']), dev)
    with torch.inference_mode():
        z = model.encode(scene)
    uv = scene['query']['uv']
    n_chunks = EVAL_PRUNED['n_chunks']
    capture['epipolar_attention'] = (RM, 'epipolar_attention', 2)
    capture['fused_exchange_epilogue'] = (RM, 'fused_exchange_epilogue', 2)
    k1, k2, k2_i8 = {}, {}, {}
    for label, render in (
            ('dense', make_scan_renderer(model, n_chunks)),
            ('pruned', make_fast_renderer(model, n_chunks,
                                          pruned=EVAL_PRUNED['pruned'])),
            ('q8', make_fast_renderer(model, n_chunks, q8=True))):
        calls = record_calls(capture, lambda: render(scene, z, uv))
        with torch.inference_mode():
            out[f'{label}_image_profile'] = profile_device(
                f'eval_pruned {label} image', lambda: render(scene, z, uv))
        shapes = (('coarse', 'fine') if label == 'pruned' else (label,))
        for i, shape in enumerate(shapes):
            name = f'medium bf16 {shape}'
            args = calls['fused_exchange_epilogue'][i]
            if label == 'q8':
                k2_i8[name] = check_core('fused_exchange_epilogue', GE,
                                         None, args, f'K2 int8 {name}')
                continue
            k2[name] = check_core('fused_exchange_epilogue', GE, None,
                                  args, f'K2 {name}')
            k1[name] = check_attention(name, EA,
                                       *calls['epipolar_attention'][i])
    numbers['bf16'] = {'epipolar_attention': k1,
                       'fused_exchange_epilogue': k2}
    numbers['int8'] = k2_i8
    del model, scene, z, calls
    torch.cuda.empty_cache()

    # (c) the fast-eval strip
    strip = build_dir / 'fast_eval_demo.png'
    if strip.exists():
        strip.unlink()
    out['demo'] = DEMO.main(['--params', str(save), '--config',
                             CAPABILITY['config'], '--world',
                             CAPABILITY['world'], '--out', str(strip),
                             '--device', torch.device(dev).type])
    if not strip.is_file() or strip.stat().st_size == 0:
        raise RuntimeError('make_fast_eval_demo wrote no strip')
    out['seconds'] = time.perf_counter() - t_start
    print(json.dumps({'capability': out}), flush=True)
    return capability_kernels(numbers, launches, table, renders)


def record_calls(capture, fn):
    """The arguments of the first ``n`` calls of each ``capture`` entry
    ({key: (module, name, n)}) in ``fn()``, run under inference mode."""
    import torch
    calls = {key: [] for key in capture}
    originals = {key: getattr(m, name) for key, (m, name, _) in
                 capture.items()}

    def recorder(key, orig, n):
        def wrapper(*args):
            if len(calls[key]) < n:
                calls[key].append(args)
            return orig(*args)
        return wrapper

    for key, (m, name, n) in capture.items():
        setattr(m, name, recorder(key, originals[key], n))
    try:
        with torch.inference_mode():
            fn()
    finally:
        for key, (m, name, _) in capture.items():
            setattr(m, name, originals[key])
    return calls


def capability_kernels(numbers, launches, table, renders):
    """Phase 26's kernel entries: K1 and K2 in f32 at the capability
    eval's shape (the run's launches), in bf16 at eval_pruned's dense and
    pruned shapes, and K2's int8 tables (eval_pruned's launches)."""
    def mode_launches(name, modes):
        return renders * sum(table[m]['launches'][name] for m in modes)

    bf16_k2 = ('dense', 'uniform_fine', 'pruned', 'narrow', 'narrow+pruned')
    entries = []
    for entry, name, source, replaces, what, by_shape, n in (
            ('epipolar_attention_medium_f32', 'epipolar_attention',
             'epipolar_attention.cu', 'ops/epipolar_attention.py:118',
             'K1 f32, the medium config\'s capability eval',
             {'eval': numbers['f32']['epipolar_attention']},
             launches['epipolar_attention']),
            ('fused_exchange_epilogue_medium_f32', 'fused_exchange_epilogue',
             'gather_epilogue.cu', 'ops/gather_epilogue.py:220',
             'K2 f32, the medium config\'s capability eval',
             {'eval': numbers['f32']['fused_exchange_epilogue']},
             launches['fused_exchange_epilogue']),
            ('epipolar_attention_medium_bf16', 'epipolar_attention',
             'epipolar_attention.cu', 'ops/epipolar_attention.py:118',
             'K1 bf16, eval_pruned on the medium config',
             numbers['bf16']['epipolar_attention'],
             mode_launches('epipolar_attention', table)),
            ('fused_exchange_epilogue_medium_bf16',
             'fused_exchange_epilogue', 'gather_epilogue.cu',
             'ops/gather_epilogue.py:220',
             'K2 bf16, eval_pruned on the medium config',
             numbers['bf16']['fused_exchange_epilogue'],
             mode_launches('fused_exchange_epilogue', bf16_k2)),
            ('fused_exchange_epilogue_i8_medium', 'fused_exchange_epilogue',
             'gather_epilogue.cu', 'ops/gather_epilogue.py:220',
             'K2 int8 tables, bf16, eval_pruned q8 on the medium config',
             numbers['int8'],
             mode_launches('fused_exchange_epilogue',
                           ('q8', 'all(n+p+q8)')))):
        first = next(iter(by_shape.values()))
        entries.append({
            'name': entry, 'mode': what, 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': n, 'launches_by_path': {'capability': n},
            'backward': ('none: int8 tables take no gradient'
                         if 'i8' in entry else
                         'the plain version, recomputed (ops/_autograd.py)'),
            'library_ms': None, **first, 'checked_on': by_shape})
    return entries


# --- 27. the parallel layer -------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def parallel_steps(base, mesh, scene, steps=PARALLEL_STEPS) -> dict:
    """``steps`` stage-1 steps (``TrainConfig()``) of a copy of ``base``,
    the flagship (phase 3's weights), on ``mesh`` (None: the plain step),
    each rank on its rows of ``scene``: the losses and gradient norms, the
    host ms a step after the first (each step ends in a host read of its
    metrics) and the peak GB allocated on this rank."""
    import copy

    import torch
    from cross_attention_renderer_torch.parallel.distributed import (
        process_batch_slice)
    from cross_attention_renderer_torch.tools import bench_train as BT
    from cross_attention_renderer_torch.tools.multihost_smoke import (
        take_rows)
    from cross_attention_renderer_torch.train import trainer as T
    cfg = T.TrainConfig()
    model = copy.deepcopy(base)
    state = T.create_train_state(model, cfg)
    if mesh is not None:
        state = T.shard_state(state, mesh)
        start, size = process_batch_slice(BT.BATCH, mesh)
        scene = take_rows(scene, start, size)
    step = T.make_train_step(model, cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, scene)
        losses.append(float(metrics['total_loss']))
        norms.append(float(metrics['grad_norm']))
        secs.append(time.perf_counter() - t0)
    out = {'losses': losses, 'grad_norms': norms,
           'ms_per_step': 1e3 * sum(secs[1:]) / (steps - 1),
           'peak_gb': torch.cuda.max_memory_allocated() / 1e9}
    if not all(map(np_isfinite, losses + norms)):
        raise RuntimeError(f'parallel steps: {out}')
    del model, state, step
    torch.cuda.empty_cache()
    return out


def check_steps(label, got, want) -> dict:
    """The first step's loss within ROUTE_LOSS_TOL and its gradient norm
    within ROUTE_GRAD_TOL of ``want``'s, relative (both start from the same
    parameters); the later steps' losses and norms within
    PARALLEL_DRIFT_TOL."""
    def rel(key, i):
        return abs(got[key][i] - want[key][i]) / abs(want[key][i])

    loss, norm = rel('losses', 0), rel('grad_norms', 0)
    drift = max(rel(k, i) for k in ('losses', 'grad_norms')
                for i in range(1, len(want['losses'])))
    log(f'{label}: losses {got["losses"]}, grad norms {got["grad_norms"]} '
        f'against {want["losses"]}, {want["grad_norms"]}: step 1 {loss:.3e} '
        f'(tol {ROUTE_LOSS_TOL:.3e}) and {norm:.3e} (tol {ROUTE_GRAD_TOL}), '
        f'later steps {drift:.3e} (tol {PARALLEL_DRIFT_TOL}); '
        f'{got["ms_per_step"]:.1f} ms a step, peak {got["peak_gb"]:.2f} GB')
    if (loss > ROUTE_LOSS_TOL or norm > ROUTE_GRAD_TOL
            or drift > PARALLEL_DRIFT_TOL):
        raise RuntimeError(f'{label}: the steps disagree')
    return {'loss_rel': loss, 'grad_norm_rel': norm, 'drift_rel': drift}


def sharded_render(model, mesh, rays, counted, scene=None) -> dict:
    """``make_sharded_renderer`` of ``model``, the flagship (phase 3's)
    on the first ``rays`` rays of ``scene`` (by default phase 3's), with
    the counters of ``counted`` set to 0 just before and read just after
    the first render; then the host ms of one render (mean of 3 after
    it). Returns the gathered rgb (f32), the launches and the ms."""
    import torch
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.train.evaluation import (
        make_sharded_renderer)
    if scene is None:
        scene = make_scene(0, H=H, W=W, n_rays=H * W, full_image=True,
                           device=model.phi.lin_out.weight.device)
    uv = scene['query']['uv'][:, :, :rays]
    render = make_sharded_renderer(model, mesh)
    with torch.inference_mode():
        z = model.encode(scene)
    for fn in counted.values():
        fn.launches = 0
    rgb, valid = render(scene, z, uv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    t0 = time.perf_counter()
    for _ in range(3):
        render(scene, z, uv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 3
    if rgb.shape != (1, 1, rays, 3) or not bool(
            torch.isfinite(rgb.float()).all()):
        raise RuntimeError(f'sharded render: rgb {tuple(rgb.shape)}')
    del scene, z
    torch.cuda.empty_cache()
    return {'rgb': rgb.float(), 'launches': launches, 'ms': ms}


def check_render(label, got, want, launches, expected) -> float:
    """The launches as expected, the image within the path-vs-path rgb
    tolerance of ``want`` (phase 3's blocks)."""
    err = max_err(got, want) / scale(want)
    log(f'{label}: launches {launches}, rgb {err:.3e} from phase 3\'s '
        f'(tol {PATH_TOL["rgb"]:.3e})')
    if launches != expected:
        raise RuntimeError(f'{label}: launches {launches}, expected '
                           f'{expected}')
    if err > PATH_TOL['rgb']:
        raise RuntimeError(f'{label}: the image disagrees with phase 3\'s')
    return err


def parallel_rank(argv) -> int:
    """One of phase 27's two ranks on ``cuda:0`` over gloo (``python3
    chip_smoke.py parallel-rank <rank> <port> <dir>``): 3 steps at
    model = 2, 3 at data = 2, 3 kernel-route steps at model = 2 (their K1
    and K2 launches counted), the sharded render at rays = 2 of phase 3's
    first 2 blocks, then a model sliced at model = 2 rendering phase 3's
    first block through K2 on the gathered weights, and each model of
    TP_RENDERS sliced at model = 2 rendering its scene's first block
    through its kernel, against the same model unsliced; prints a
    ``PARALLEL_RANK`` JSON line, rank 0 saves the gathered images to
    ``<dir>/rgb.pt`` and ``<dir>/rgb_model2.pt``."""
    import copy

    import torch
    import torch.distributed as dist
    rank, port, out = int(argv[0]), int(argv[1]), Path(argv[2])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.ops import epipolar_attention as EA
    from cross_attention_renderer_torch.ops import fused_mlp as FM
    from cross_attention_renderer_torch.ops import fused_render as FR
    from cross_attention_renderer_torch.ops import gather_epilogue as GE
    from cross_attention_renderer_torch.parallel.distributed import (
        initialize, make_global_mesh)
    from cross_attention_renderer_torch.tools import bench_train as BT
    from cross_attention_renderer_torch.train import trainer as T
    initialize(f'localhost:{port}', 2, rank, local_device_ids=[0],
               backend='gloo')
    watch_core_plans(GE)    # the rank's core launches, as the script's
    try:
        dev = torch.device('cuda', 0)
        scene = make_scene(0, batch=BT.BATCH, n_view=2, H=H, W=W,
                           n_rays=BT.RAYS, device=dev)
        base = flagship(RM, dev, npoints=64)
        counted = {'epipolar_attention': EA.epipolar_attention,
                   'fused_exchange_epilogue': GE.fused_exchange_epilogue}
        result = {}
        for label, shape in (('model2', dict(data=1, model=2)),
                             ('data2', dict(data=2, model=1))):
            result[label] = parallel_steps(base, make_global_mesh(**shape),
                                           scene)
        # the kernel route at model = 2: K2 and K1 read the exchange's
        # sliced weights gathered over the model group
        model2 = make_global_mesh(data=1, model=2)
        for fn in counted.values():
            fn.launches = 0
        with BT.route_env('kernels'):
            result['model2_kernels'] = parallel_steps(base, model2, scene)
        result['model2_kernels']['launches'] = {
            name: fn.launches for name, fn in counted.items()}
        del scene
        torch.set_grad_enabled(False)
        render = sharded_render(
            base, make_global_mesh(data=1, model=1, rays=2), 2 * RAY_BLOCK,
            counted)
        if rank == 0:
            torch.save(render['rgb'].cpu(), out / 'rgb.pt')
        result['render'] = {k: render[k] for k in ('launches', 'ms')}
        # a model sliced at model = 2 renders through K2 on the gathered
        # weights: every rank all of phase 3's first block
        sliced = copy.deepcopy(base)
        T.shard_state(T.create_train_state(sliced, T.TrainConfig()), model2)
        render = sharded_render(sliced, model2, RAY_BLOCK, counted)
        if rank == 0:
            torch.save(render['rgb'].cpu(), out / 'rgb_model2.pt')
        result['render_model2'] = {k: render[k] for k in ('launches', 'ms')}
        del sliced, render
        # K4, K3 and K9 on the gathered weights, each against its model
        # unsliced on this rank
        kernels = {'epipolar_attention': EA.epipolar_attention,
                   'fused_exchange_epilogue': GE.fused_exchange_epilogue,
                   'fused_exchange_epilogue_multi':
                       GE.fused_exchange_epilogue_multi,
                   'fused_mlp2': FM.fused_mlp2,
                   'fused_render_core': FR.fused_render_core}
        result['tp_renders'] = {}
        for label, kw, expected in TP_RENDERS:
            model = flagship(RM, dev, **kw)
            scene = make_scene(0, n_view=kw.get('n_view', 2), H=H, W=W,
                               n_rays=H * W, full_image=True, device=dev)
            want = first_block(model, scene)['rgb']
            T.shard_state(T.create_train_state(model, T.TrainConfig()),
                          model2)
            render = sharded_render(model, model2, RAY_BLOCK,
                                    {n: kernels[n] for n in expected}, scene)
            result['tp_renders'][label] = {
                'launches': render['launches'], 'ms': render['ms'],
                'rgb_rel': max_err(render['rgb'], want) / scale(want)}
            del model, scene, want, render
            torch.cuda.empty_cache()
        print('PARALLEL_RANK ' + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def parallel(RM, EA, GE, dev, staged_head, card) -> dict:
    """Phase 27, the parallel layer, as the module docstring says.
    Returns the launches of K1 and K2 by path (per rank)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.parallel.mesh import make_mesh
    from cross_attention_renderer_torch.tools import bench_train as BT
    counted = {'epipolar_attention': EA.epipolar_attention,
               'fused_exchange_epilogue': GE.fused_exchange_epilogue}
    per_block = {'epipolar_attention': 2, 'fused_exchange_epilogue': 1}
    report = {'card': card}

    # 1. one process, a 1-rank NCCL group
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        mesh = make_mesh(device_type='cuda')
        log(f'parallel: {mesh} over the {dist.get_backend()} group')
        scene = make_scene(0, batch=BT.BATCH, n_view=2, H=H, W=W,
                           n_rays=BT.RAYS, device=dev)
        base = flagship(RM, dev, npoints=64)
        with torch.enable_grad():
            plain = parallel_steps(base, None, scene)
            nccl = parallel_steps(base, mesh, scene)
        del scene
        report['plain'] = plain
        report['nccl_1rank'] = dict(nccl, agreement=check_steps(
            'parallel 1-rank NCCL mesh steps vs plain steps', nccl, plain))
        render = sharded_render(base, mesh, RAY_BLOCK, counted)
        del base
    finally:
        dist.destroy_process_group()
    report['nccl_1rank']['render'] = {
        'ms': render['ms'], 'launches': render['launches'],
        'rgb_rel': check_render(
            'parallel 1-rank NCCL sharded render (8,192 rays)', render['rgb'],
            staged_head[:, :, :RAY_BLOCK], render['launches'], per_block)}
    by_path = {'sharded_render_nccl_rays1': render['launches']}
    del render
    torch.cuda.empty_cache()

    # 2. two processes on cuda:0 over gloo
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f'rank{rank}.log' for rank in range(2)]
        procs = []
        for rank, path in enumerate(logs):
            with open(path, 'w') as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     'parallel-rank', str(rank), str(port), tmp],
                    stdout=f, stderr=subprocess.STDOUT))
        # a rank that fails leaves the other waiting in a collective: stop
        # both at the first failure or at the time limit
        deadline = time.monotonic() + PARALLEL_TIMEOUT
        try:
            while (any(p.poll() is None for p in procs)
                   and all(p.poll() in (None, 0) for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = [path.read_text() for path in logs]
        for rank, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                log(f'  [rank {rank}] {line}')
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f'parallel rank {rank} exited '
                                   f'{p.returncode}')
        ranks = [json.loads(next(line for line in out.splitlines()
                                 if line.startswith('PARALLEL_RANK '))[14:])
                 for out in outs]
        rgb = torch.load(Path(tmp) / 'rgb.pt').to(dev)
        rgb_model2 = torch.load(Path(tmp) / 'rgb_model2.pt').to(dev)
    if any(ranks[0][k][m] != ranks[1][k][m] for k in ('model2', 'data2')
           for m in ('losses', 'grad_norms')):
        raise RuntimeError('the two ranks\' steps differ')
    for rank, r in enumerate(ranks):
        for label in ('model2', 'data2'):
            r[label]['agreement'] = check_steps(
                f'parallel gloo rank {rank}, {label} steps vs the 1-rank '
                'NCCL mesh', r[label], nccl)
        check_render(f'parallel gloo rank {rank}, rays=2 render launches',
                     rgb, staged_head, r['render']['launches'], per_block)
        by_path[f'sharded_render_gloo_rays2_rank{rank}'] = r['render'][
            'launches']
        r['model2_kernels']['agreement'] = check_steps(
            f'parallel gloo rank {rank}, kernel-route steps at model = 2 vs '
            'the plain steps', r['model2_kernels'], plain)
        if r['model2_kernels']['launches'] != {
                k: PARALLEL_STEPS * n for k, n in per_block.items()}:
            raise RuntimeError(f'kernel-route step at model = 2: launches '
                               f'{r["model2_kernels"]["launches"]}')
        by_path[f'train_kernel_route_model2_rank{rank}'] = r[
            'model2_kernels']['launches']
        r['render_model2']['rgb_rel'] = check_render(
            f'parallel gloo rank {rank}, model = 2 render (K2 on the '
            'gathered weights)', rgb_model2, staged_head[:, :, :RAY_BLOCK],
            r['render_model2']['launches'], per_block)
        by_path[f'sharded_render_gloo_model2_rank{rank}'] = r[
            'render_model2']['launches']
        for label, _, expected in TP_RENDERS:
            t = r['tp_renders'][label]
            log(f'parallel gloo rank {rank}, model = 2 {label} render on '
                f'the gathered weights: launches {t["launches"]}, rgb '
                f'{t["rgb_rel"]:.3e} from the unsliced model\'s (tol '
                f'{PATH_TOL["rgb"]:.3e}), {t["ms"]:.1f} ms')
            if t['launches'] != expected or t['rgb_rel'] > PATH_TOL['rgb']:
                raise RuntimeError(f'parallel model = 2 {label} render: '
                                   f'{t}, expected launches {expected}')
            key = label.lower().replace(' ', '_').replace('=', '')
            by_path[f'sharded_render_gloo_model2_{key}_rank{rank}'] = t[
                'launches']
    report['gloo_2ranks'] = ranks
    print(json.dumps({'parallel': report}), flush=True)
    return by_path


# Phase 28, more than four context views. Each path of VIEW_PATHS renders
# the full image as phase 3 drives the flagship (bf16 unless the path says
# f32, 256x256, 8 blocks), its launches as given, then the image against
# the same model's unfused route (``unfused_twin``) within PATH_TOL; the
# unfused exchange at V=5 and V=6 holds (1, V, R, P, V * 288) bf16 values
# a block, ~8 GB at V=6 and 8,192 rays, so that reference renders in
# VIEWS_UNFUSED_BLOCKS blocks (the same function). Entries as
# ABLATION_PATHS'; 'q8' renders through make_fast_renderer(q8=True).
VIEW_PATHS = (
    ('V=5', dict(n_view=5),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi': 'fused_exchange_epilogue_multi_s5',
      'epipolar_attention': 'epipolar_attention_vp240'}),
    ('V=6', dict(n_view=6),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi': 'fused_exchange_epilogue_multi_s6',
      'epipolar_attention': 'epipolar_attention_vp288'}),
    # 5 self and 20 cross fuse calls a block
    ('V=5 compat', dict(n_view=5, **PATH_B),
     {'epipolar_attention': 16, 'fused_mlp2': 25 * 8,
      'fused_exchange_epilogue_multi': 0}, {}),
    ('V=5 sorted', dict(n_view=5, sorted_stream=True),
     {'resident_gather': 6 * 8, 'epipolar_attention': 16,
      'fused_exchange_epilogue_multi': 0}, {}),
    ('V=5 unfused', dict(n_view=5, fused_epilogue=False),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 0}, {}),
    ('V=5 f32', dict(n_view=5, dtype='float32'),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi':
      'fused_exchange_epilogue_multi_s5_f32'}),
    ('ResNet V=5', dict(model='resnet', n_view=5),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi':
      'fused_exchange_epilogue_multi_l4_s5'}),
    ('V=5 q8', dict(n_view=5, q8=True),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     {'fused_exchange_epilogue_multi':
      'fused_exchange_epilogue_multi_i8_s5'}),
)
VIEWS_UNFUSED_BLOCKS = 16
VIEWS_TIMED = ('V=5', 'V=6')        # the paths whose image is timed
K3_STREAMS = 8                      # K3 is also checked at S = 8
K3_TYPED = (4, 6, K3_STREAMS)       # S checked in f32 and int8 on a block
QUICK = (3, 1)      # the calls timed of the modes on no image path (kernel,
                    # plain version): the plain version at S = 8 is 0.6-1.6 s


def views(RM, EA, GE, FM, SG, make_scene, dev, counted):
    """Phase 28: the flagship at more than four context views
    (``VIEW_PATHS``), each image driven as phase 3 drives it and held
    against the same model's unfused route (the q8 image against the
    dense image of its dequantized pyramid, as phase 23); the first call
    of each path's new kernel mode or shape against its plain version,
    timed beside its bound (the q8 call also with f32 slot weights); K3
    at S = 8 on a V=8 flagship's first block in bf16, f32 and int8 (bf16
    and f32 slot weights); each entry's plan; the small-input agreement
    at V=5.
    Returns (launches by path, the f32 launches by path, the checks'
    numbers by kernel-line entry, the timed images)."""
    import math

    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    def k3(label, args, iters=10, plain_iters=3):
        return check_epilogue(
            label, GE.fused_exchange_epilogue_multi,
            GE.fused_exchange_epilogue_multi_reference, args, args[2],
            args[3], K3_TOL, iters, plain_iters)

    checks = {'fused_exchange_epilogue_multi': k3,
              'epipolar_attention': lambda label, args: check_attention(
                  label, EA, *args)}
    by_path, by_path_f32, numbers, times, plans = {}, {}, {}, {}, {}
    for label, kw, expected, checked in VIEW_PATHS:
        kw = dict(kw)
        V = kw['n_view']
        q8 = kw.pop('q8', False)
        if 'dtype' in kw:
            kw['dtype'] = getattr(torch, kw['dtype'])
        model = flagship(RM, dev, **kw)
        # the decoder reads the V latents side by side (ablation_model)
        with torch.no_grad():
            model.phi.lin_out.weight.mul_(math.sqrt(2 / V))
        scene = make_scene(0, n_view=V, H=H, W=W, n_rays=H * W,
                           full_image=True, device=dev)
        key = label.lower().replace(' ', '_').replace('=', '').replace(
            '-', '')
        captured, launches, rgb = drive(
            label, model, scene, RM, {n: counted[n] for n in expected},
            expected, capture={n: (RM, n, 1) for n in checked},
            render_image=(make_fast_renderer(model, N_BLOCKS, q8=True)
                          if q8 else None),
            times=times.setdefault(label, {}), n_img=1,
            timed=label in VIEWS_TIMED)
        (by_path_f32 if 'dtype' in kw else by_path)[key] = launches
        if q8:
            check_q8_image(label, model, scene, rgb, RM)
        elif kw.get('fused_epilogue') is False:
            log(f'{label}: the unfused route itself')
        else:
            twin = unfused_twin(model)
            with torch.inference_mode():
                rgb_ref, _ = make_scan_renderer(twin, VIEWS_UNFUSED_BLOCKS)(
                    scene, twin.encode(scene), scene['query']['uv'])
            check_paths(f'{label} vs its unfused route '
                        f'({VIEWS_UNFUSED_BLOCKS} blocks)', PATH_TOL,
                        rgb.float(), rgb_ref.float())
            del twin, rgb_ref
        for name, entry in checked.items():
            numbers.setdefault(entry, {})[label] = checks[name](
                label, captured[name][0])
            if name == 'fused_exchange_epilogue_multi':
                plans[entry] = GE.fused_exchange_epilogue_multi.last_plan
            if name == 'fused_exchange_epilogue_multi' and label in REPEATED:
                numbers[entry][label]['repeats'] = repeat_bitwise(
                    label, GE.fused_exchange_epilogue_multi,
                    captured[name][0], REPEATS)
        if q8:      # the int8 tables beside f32 slot weights as well
            entry = f'{checked["fused_exchange_epilogue_multi"]}_f32'
            numbers[entry] = {label: k3(f'{label} f32 slot weights', as_f32(
                'fused_exchange_epilogue_multi',
                captured['fused_exchange_epilogue_multi'][0]), *QUICK)}
            plans[entry] = GE.fused_exchange_epilogue_multi.last_plan
        del captured, scene, rgb, model
        torch.cuda.empty_cache()

    # K3 on the first block of a V=4, 6 and 8 flagship in f32 and int8 (S
    # = 8 in bf16 too: it is on no image path)
    for V in K3_TYPED:
        model = flagship(RM, dev, n_view=V)
        scene = make_scene(0, n_view=V, H=H, W=W, n_rays=RAY_BLOCK,
                           device=dev)
        args = first_call(model, scene, RM, 'fused_exchange_epilogue_multi')
        sv = f'fused_exchange_epilogue_multi_s{V}'
        if V == K3_STREAMS:
            numbers[sv] = {f'V={V}': k3(f'K3 S = {V} bf16', args, *QUICK)}
            plans[sv] = GE.fused_exchange_epilogue_multi.last_plan
        f32 = (tuple(t.float() for t in args[0]), args[1],
               tuple(a.float() for a in args[2]), args[3])
        numbers[f'{sv}_f32'] = {f'V={V}': k3(f'K3 S = {V} f32', f32,
                                             *QUICK)}
        plans[f'{sv}_f32'] = GE.fused_exchange_epilogue_multi.last_plan
        del f32
        seen = []
        fn = RM.fused_exchange_epilogue_multi

        def recorder(*a):
            if not seen:
                seen.append(a)
            return fn(*a)

        RM.fused_exchange_epilogue_multi = recorder
        try:
            with torch.inference_mode():
                z = model.encode(scene)
            make_fast_renderer(model, 1, q8=True)(scene, z,
                                                  scene['query']['uv'])
        finally:
            RM.fused_exchange_epilogue_multi = fn
        i8 = f'fused_exchange_epilogue_multi_i8_s{V}'
        numbers[i8] = {f'V={V}': k3(f'K3 S = {V} int8', seen[0], *QUICK)}
        numbers[f'{i8}_f32'] = {f'V={V}': k3(
            f'K3 S = {V} int8 f32', as_f32('fused_exchange_epilogue_multi',
                                            seen[0]), *QUICK)}
        plans[i8] = plans[f'{i8}_f32'] = (
            GE.fused_exchange_epilogue_multi.last_plan)
        del model, scene, args, seen, z
        torch.cuda.empty_cache()
    log(f'views: K3 plans by entry {plans}')
    by_path['small_v5'] = small_agreement(
        'V=5', RM, make_scene, dev, counted={
            'epipolar_attention': (EA.epipolar_attention, 2),
            'fused_exchange_epilogue_multi': (
                GE.fused_exchange_epilogue_multi, 1)}, n_view=5)
    for label in VIEWS_TIMED:
        t = times[label]
        log(f'views {label}: {t["image_ms"]:.1f} ms an image, '
            f'{t["rays_per_s"]:.1f} rays/s, device busy '
            f'{t["device_busy_ms"]:.1f} ms of a profiled '
            f'{t["profiled_wall_ms"]:.1f} ms')
    for entry, plan in plans.items():
        numbers[entry] = {k: dict(v, plan=plan)
                          for k, v in numbers[entry].items()}
    return by_path, by_path_f32, numbers, {k: times[k] for k in VIEWS_TIMED}


# Phase 29, the card tools ported from the JAX repository's tools/, each
# run once in this process at its shortest setting (tool, argv).
TOOL_RUNS = (
    ('bench_train_roofline', ['--iters', '1']),
    ('profile_sorted', ['--iters', '2']),
    ('trace_render', ['--blocks', '1']),
    ('bench_traj', ['--frames', '1']),
    ('bench_traj', ['--fast', '--frames', '1']),
    ('bench_v3', ['--iters', '1']),
    ('bench_block', ['std', '--iters', '1']),
    ('bench_blocks', ['--chunks', '8', '--iters', '1']),
    ('bench_sorted_stream', ['--iters', '1']),
    ('bench_ondisk', ['--steps', '2', '--workers', '2',
                      '--iter-batches', '2']),
)


def tools_phase(build_dir) -> dict:
    """Phase 29: each of TOOL_RUNS through its ``main`` (bench_ondisk on
    phase 21's corpus, trace_render into ``build/``), each printing its
    lines; returns each run's seconds."""
    import importlib

    import torch
    seconds = {}
    for name, argv in TOOL_RUNS:
        argv = list(argv)
        if name == 'bench_ondisk':
            argv += ['--root', str(build_dir / 'smoke_corpus')]
        if name == 'trace_render':
            argv += ['--out', str(build_dir / 'trace_render')]
        tool = importlib.import_module(
            f'cross_attention_renderer_torch.tools.{name}')
        log(f'--- tools: {name} {" ".join(argv)}')
        t0 = time.perf_counter()
        tool.main(argv)
        torch.cuda.synchronize()
        seconds[f'{name} {" ".join(argv)}'] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    log(f'tools: seconds by run {json.dumps(seconds)}')
    return seconds


# Phase 30, widths the kernels once refused: fusion_features 100 (levels of
# 100 channels, 100 % 8 = 4; f rows S * O = 264 and 396 that do not tile),
# 102 (levels of 102, an O of 134 = 2 mod 4, K9's input 268) and 264 (S * O
# = 888 at V = 3), and --narrow 100,50,30 (levels narrowed to 100, 50, 30),
# each a full-depth model driven as phase 3 drives the flagship: (label,
# model kwargs, the kernels a path launches with their counts per image,
# the kernels checked against their plain versions on the path's first
# call, the width's tag that names their kernels-line entries).
WIDTH_PATHS = (
    ('ff=100 V=2', dict(fusion_features=100, npoints=64),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8},
     ('epipolar_attention', 'fused_exchange_epilogue'), 'ff100'),
    ('ff=100 V=2 fused render', dict(fusion_features=100, npoints=64,
                                     fused_render=True),
     {'fused_render_core': 8, 'epipolar_attention': 0,
      'fused_exchange_epilogue': 0}, ('fused_render_core',), 'ff100'),
    ('ff=100 V=3', dict(fusion_features=100, n_view=3),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     ('fused_exchange_epilogue_multi',), 'ff100'),
    ('ff=100 V=3 compat', dict(fusion_features=100, n_view=3, **PATH_B),
     {'epipolar_attention': 16, 'fused_mlp2': 72}, ('fused_mlp2',),
     'ff100'),
    ('ff=100 V=2 sorted', dict(fusion_features=100, npoints=64,
                               sorted_stream=True),
     {'resident_gather': 48, 'epipolar_attention': 16,
      'fused_exchange_epilogue': 0, 'fused_render_core': 0},
     ('resident_gather',), 'ff100'),
    ('ff=100 V=3 compat one-hot', dict(fusion_features=100, n_view=3,
                                       gather='onehot', **PATH_B),
     {'onehot_gather': 48, 'epipolar_attention': 16, 'fused_mlp2': 72},
     ('onehot_gather',), 'ff100'),
    ('ff=102 V=2', dict(fusion_features=102, npoints=64),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8},
     ('epipolar_attention', 'fused_exchange_epilogue'), 'ff102'),
    ('ff=102 V=3', dict(fusion_features=102, n_view=3),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     ('fused_exchange_epilogue_multi',), 'ff102'),
    ('ff=264 V=3', dict(fusion_features=264, n_view=3),
     {'epipolar_attention': 16, 'fused_exchange_epilogue_multi': 8},
     ('epipolar_attention', 'fused_exchange_epilogue_multi'), 'ff264'),
    ('narrow 100,50,30 V=2', dict(npoints=64, narrow=(100, 50, 30)),
     {'epipolar_attention': 16, 'fused_exchange_epilogue': 8},
     ('fused_exchange_epilogue',), 'narrow'),
)
WIDTH_UNFUSED_BLOCKS = 16
# the gathers' calls a block (3 self-stream levels, then 3 cross ones)
GATHER_CAPTURE = {'resident_gather': ('RM', 'grid_sample_sorted'),
                  'onehot_gather': ('PG', 'grid_sample_pallas')}
WIDTH_MODES = {'ff100': 'fusion_features 100 (levels 100, 100, 64; O 132)',
               'ff102': 'fusion_features 102 (levels 102, 102, 64; O 134)',
               'ff264': 'fusion_features 264 (levels 264, 264, 64; O 296)',
               'narrow': 'narrow 100,50,30 (levels 100, 50, 30; O 288)'}
CONVERTED_SEED = 30
# each kernel's source and the TPU kernel it replaces
KERNEL_SOURCES = {
    'epipolar_attention': ('epipolar_attention.cu',
                           'ops/epipolar_attention.py:118'),
    'fused_exchange_epilogue': ('gather_epilogue.cu',
                                'ops/gather_epilogue.py:220'),
    'fused_exchange_epilogue_multi': ('gather_epilogue_multi.cu',
                                      'ops/gather_epilogue.py:421'),
    'fused_mlp2': ('fused_mlp.cu', 'ops/experimental/fused_mlp.py:77'),
    'fused_render_core': ('fused_render.cu', 'ops/fused_render.py:349'),
    'resident_gather': ('bilinear_gather.cu', 'ops/sorted_gather.py:206'),
    'onehot_gather': ('bilinear_gather.cu', 'ops/pallas_gather.py:70'),
    'banded_gather': ('bilinear_gather.cu',
                      'ops/experimental/banded_gather.py:106'),
}


def check_widths_kernel(name, label, args, EA, GE, FR, FM, SG, PG):
    """The kernel ``name`` against its plain version on a path's captured
    arguments (the gathers: the block's six calls, output in the tables'
    type), with its numbers."""
    if name == 'epipolar_attention':
        return check_attention(label, EA, *args[0])
    if name == 'fused_render_core':
        log(f'{label}:')
        return check_render_core(FR, args[0])
    if name == 'fused_mlp2':
        return check_mlp(FM, args[0], f'K9 fused_mlp2 {label}')
    if name in ('fused_exchange_epilogue', 'fused_exchange_epilogue_multi'):
        return check_core(name, GE, FR, args[0], f'{name} {label}')
    kernel = SG.resident_gather if name == 'resident_gather' else (
        PG.onehot_gather)
    cases = [sorted_case(SG, *a) if name == 'resident_gather'
             else table_case(PG, *a) for a in args]
    return check_gather(f'{name} {label}', kernel, cases, cases[0][0].dtype)


def widths(RM, EA, GE, FR, FM, PG, SG, BG, make_scene, dev, counted,
           build_dir):
    """Phase 30: every kernel at widths it once refused (``WIDTH_PATHS``),
    each path's full image (bf16, 256x256, 8 blocks) with the flagship's
    launch counts (no route falls back to a plain version) and against the
    same model's unfused route (16 blocks) within the path-vs-path
    tolerance; each kernel checked on its path's first call against its
    plain version within its tolerance (K5 and K7 on the block's six
    calls), timed beside its bound; K2 in f32 and in int8 (a q8 image,
    against the dense image of its dequantized pyramid) at
    fusion_features 102; K8 on the ff=100 V=2 sorted block's level-0 table
    (C = 100) and in the small-input render at ff=100; then the converter:
    a seeded upstream ``.pth`` of the flagship,
    ``tools/convert_checkpoint.py``, and ``cli/eval.py --checkpoint_path``
    on phase 21's corpus, held to ``evaluate_scene`` of the converted
    weights. Returns (launches by path, the kernels-line entries' numbers
    with their kernel, mode and launches by path, the converter's
    numbers)."""
    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    modules = {'RM': RM, 'SG': SG, 'PG': PG}
    by_path, numbers = {}, {}
    k8_case = None
    for label, kw, expected, checked, tag in WIDTH_PATHS:
        kw = dict(kw)
        narrow = kw.pop('narrow', None)
        model = flagship(RM, dev, **kw)
        V = model.n_view
        scene = make_scene(0, n_view=V, H=H, W=W, n_rays=H * W,
                           full_image=True, device=dev)
        capture = {name: ((modules[GATHER_CAPTURE[name][0]],
                           GATHER_CAPTURE[name][1], 6)
                          if name in GATHER_CAPTURE else (RM, name, 1))
                   for name in checked}

        def render(m, blocks):
            if narrow:
                return make_fast_renderer(m, blocks, narrow=narrow)
            return make_scan_renderer(m, blocks)

        captured, launches, rgb = drive(
            label, model, scene, RM, {n: counted[n] for n in expected},
            expected, capture=capture, render_image=render(model, N_BLOCKS),
            timed=False)
        key = 'widths_' + label.lower().replace(' ', '_').replace(
            '=', '').replace(',', '_').replace('-', '')
        by_path[key] = launches
        twin = unfused_twin(model)
        with torch.inference_mode():
            rgb_ref, _ = render(twin, WIDTH_UNFUSED_BLOCKS)(
                scene, twin.encode(scene), scene['query']['uv'])
        check_paths(f'{label} vs its unfused route '
                    f'({WIDTH_UNFUSED_BLOCKS} blocks)', PATH_TOL,
                    rgb.float(), rgb_ref.float())
        del twin, rgb_ref
        for name in checked:
            numbers[f'{name}_{tag}'] = dict(check_widths_kernel(
                name, label, captured[name], EA, GE, FR, FM, SG, PG),
                kernel=name, mode=WIDTH_MODES[tag], checked_on=label)
        for name, n in launches.items():
            if n and f'{name}_{tag}' in numbers:
                numbers[f'{name}_{tag}'].setdefault(
                    'launches_by_path', {})[key] = n
        if label == 'ff=100 V=2 sorted':
            k8_case = sorted_case(SG, *captured['resident_gather'][0])
        if label == 'ff=102 V=2':
            # K2 in f32 (tables and slot weights) on the first block
            a = captured['fused_exchange_epilogue'][0]
            f32 = (tuple(t.float() for t in a[0]), a[1], a[2].float(),
                   a[3].float(), a[4], a[5])
            numbers['fused_exchange_epilogue_f32_ff102'] = dict(
                check_core('fused_exchange_epilogue', GE, FR, f32,
                           f'K2 f32 {label}'),
                kernel='fused_exchange_epilogue', launches_by_path={},
                mode=f'K2 f32, {WIDTH_MODES[tag]} (on no image path)',
                checked_on=label)
            del f32
            # K2 on int8 tables of 102 channels: a q8 image
            q8 = f'{label} q8'
            captured, launches, rgb = drive(
                q8, model, scene, RM, {n: counted[n] for n in expected},
                expected, capture={'fused_exchange_epilogue': (
                    RM, 'fused_exchange_epilogue', 1)},
                render_image=make_fast_renderer(model, N_BLOCKS, q8=True),
                timed=False)
            by_path['widths_ff102_v2_q8'] = launches
            check_q8_image(q8, model, scene, rgb, RM)
            numbers['fused_exchange_epilogue_i8_ff102'] = dict(
                check_core('fused_exchange_epilogue', GE, FR,
                           captured['fused_exchange_epilogue'][0],
                           f'K2 int8 {q8}'),
                kernel='fused_exchange_epilogue',
                launches_by_path={'widths_ff102_v2_q8': launches[
                    'fused_exchange_epilogue']},
                mode=f'K2 int8, {WIDTH_MODES[tag]}', checked_on=q8)
        del captured, scene, rgb, model
        torch.cuda.empty_cache()

    # K8 on a table of C = 100 (the ff=100 V=2 level 0), and in a render
    if k8_case[0].numel() * 2 > PG.BANDED_TABLE_BYTES:
        raise RuntimeError('the ff=100 level-0 table exceeds K8\'s limit')
    small = 'widths_ff100_v3_compat_banded_small'
    by_path[small] = small_agreement(
        'ff=100 V=3 compat banded', RM, make_scene, dev,
        counted={'banded_gather': (BG.banded_gather, 6)},
        small=dict(SMALL, fusion_features=100), n_view=3, gather='banded',
        **PATH_B)
    numbers['banded_gather_c100'] = dict(
        check_gather('K8 banded_gather C = 100', BG.banded_gather,
                     [k8_case], k8_case[0].dtype),
        kernel='banded_gather',
        launches_by_path={small: by_path[small]['banded_gather']},
        mode='K8, C = 100 (fusion_features 100, level 0)',
        checked_on='ff=100 V=2 sorted, the first block\'s level 0')
    del k8_case
    torch.cuda.empty_cache()
    converted = check_converted(build_dir, {n: counted[n] for n in (
        'epipolar_attention', 'fused_exchange_epilogue')})
    by_path['widths_converted_cli_eval_v2'] = converted['launches']
    return by_path, numbers, converted


def check_converted(build_dir, counted, extra=()):
    """The upstream checkpoint's path on the card: a seeded upstream-layout
    ``.pth`` of the CLI's model (the flagship in f32;
    ``tests/torch_checkpoint_cases.py``), converted by
    ``tools/convert_checkpoint.py``, loaded by ``cli/eval.py
    --checkpoint_path`` (V=2, phase 21's corpus, one scene: 16 K1 and 8 K2
    an image), its metrics held to ``evaluate_scene`` of the CLI's model
    with the converted weights loaded strictly. ``extra``: flags added to
    every CLI call (none on the card)."""
    import torch
    from cross_attention_renderer_torch.cli import common as CC
    from cross_attention_renderer_torch.cli import eval as eval_cli
    from cross_attention_renderer_torch.data.realestate import (
        RealEstate10kVis)
    from cross_attention_renderer_torch.losses.lpips import load_lpips
    from cross_attention_renderer_torch.tools import convert_checkpoint
    from cross_attention_renderer_torch.train.evaluation import (
        evaluate_scene)
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'tests'))
    from torch_checkpoint_cases import upstream_state_dict
    t0 = time.perf_counter()
    opt = CC.base_parser('x').parse_args(['--views', '2', *extra])
    model = CC.build_model(opt).eval()
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    pth, out = build_dir / 'upstream_seeded.pth', build_dir / 'converted.pt'
    upstream = upstream_state_dict(shapes, CONVERTED_SEED)
    torch.save({'model': {k: torch.from_numpy(v)
                          for k, v in upstream.items()}}, pth)
    del upstream
    convert_checkpoint.main(['--torch_ckpt', str(pth), '--out', str(out),
                             '--views', '2'])
    corpus = build_dir / 'smoke_corpus'
    frames, poses = corpus / 'frames', corpus / 'poses.mat'
    for fn in counted.values():
        fn.launches = 0
    res = eval_cli.main(['--img_root', str(frames), '--pose_root',
                         str(poses), '--logging_root',
                         str(build_dir / 'smoke_logs'), '--max_scenes', '1',
                         '--views', '2', '--checkpoint_path', str(out),
                         '--experiment_name', 'eval_converted', *extra])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    expected = {'epipolar_attention': 2 * CLI_CHUNKS,
                'fused_exchange_epilogue': CLI_CHUNKS}
    got = res['scenes'][0]
    if launches != expected or not all(np_isfinite(v) for v in got.values()):
        raise RuntimeError(f'converted checkpoint: launches {launches}, '
                           f'metrics {got}')
    model.load_state_dict(torch.load(out, weights_only=True)['params'])
    scene = CC.scene_batch(RealEstate10kVis(frames, poses,
                                            num_ctxt_views=2)[0], opt.device)
    want = evaluate_scene(model, scene, *scene['context']['rgb'].shape[2:4],
                          CLI_CHUNKS, lpips_fn=load_lpips(device=opt.device))
    want = {k: float(want[k]) for k in ('psnr', 'ssim', 'lpips')}
    log(f'converted checkpoint: cli eval --checkpoint_path {got}, launches '
        f'{launches}; evaluate_scene of the converted weights {want}')
    if (abs(got['psnr'] - want['psnr']) > EVAL_TOL['psnr']
            or abs(got['ssim'] - want['ssim']) > EVAL_TOL['ssim']
            or abs(got['lpips'] - want['lpips'])
            > EVAL_TOL['lpips_rel'] * abs(want['lpips'])):
        raise RuntimeError('the converted checkpoint\'s eval disagrees with '
                           'evaluate_scene of its weights')
    for f in (pth, out):
        f.unlink()
    del model, scene
    return {'launches': launches, 'cli': got, 'evaluate_scene': want,
            'seconds': time.perf_counter() - t0}


def flagship(RM, dev, dtype=None, **kw):
    """The 122M model from seed 0 (bf16 compute unless ``dtype`` says
    otherwise), decoder output layer scaled."""
    import torch
    model = RM.CrossAttentionRenderer(dtype=dtype or torch.bfloat16, seed=0,
                                      device=dev, **kw).eval()
    with torch.no_grad():
        model.phi.lin_out.weight.mul_(RGB_LAYER_SCALE)
    return model


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / 'cross_attention_renderer_torch').is_dir():
        print('chip_smoke: run from a checkout of the repository',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))

    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.ops import _build
    from cross_attention_renderer_torch.ops import epipolar_attention as EA
    from cross_attention_renderer_torch.ops import fused_mlp as FM
    from cross_attention_renderer_torch.ops import fused_render as FR
    from cross_attention_renderer_torch.ops import gather_epilogue as GE
    from cross_attention_renderer_torch.ops import pallas_gather as PG
    from cross_attention_renderer_torch.ops import sorted_gather as SG
    from cross_attention_renderer_torch.ops import stream_takes as ST
    from cross_attention_renderer_torch.ops.experimental import (
        banded_gather as BG)

    t_start = time.perf_counter()
    # -- 1. device ---------------------------------------------------------
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    log(f'device: {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}')

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    for name, out in logs.items():
        print(f'--- nvcc {name}\n{out}', file=sys.stderr)
    log(f'build: {time.perf_counter() - t0:.1f} s')
    for line in core_ptxas(logs):
        log(f'ptxas {line}')
    for source in ('row_gather', 'bilinear_gather'):
        for line in gather_ptxas(logs.get(source, '')):
            log(f'ptxas {source} {line}')
    # every core launch from here on is held to core_plan's plan and slots
    core_plans = watch_core_plans(GE)

    attention = ('epipolar_attention', EA.epipolar_attention)
    epilogue = ('fused_exchange_epilogue', GE.fused_exchange_epilogue)
    epilogue_multi = ('fused_exchange_epilogue_multi',
                      GE.fused_exchange_epilogue_multi)
    mlp = ('fused_mlp2', FM.fused_mlp2)
    render_core = ('fused_render_core', FR.fused_render_core)
    resident = ('resident_gather', SG.resident_gather)
    windowed = ('windowed_gather', SG.windowed_gather)
    onehot = ('onehot_gather', PG.onehot_gather)
    banded = ('banded_gather', BG.banded_gather)
    takes = ('stream_takes', ST.stream_takes)
    by_path = {}        # launches per image of every kernel on every path

    # -- 3. V=2 main path --------------------------------------------------
    model_v2 = flagship(RM, dev, npoints=64)
    scene = make_scene(0, H=H, W=W, n_rays=H * W, full_image=True,
                       device=dev)
    captured, launches, rgb_staged = drive(
        'V=2', model_v2, scene, RM, dict([attention, epilogue, takes]),
        {'epipolar_attention': 2 * N_BLOCKS,
         'fused_exchange_epilogue': N_BLOCKS, 'stream_takes': N_BLOCKS})
    by_path['v2'] = launches
    block_staged = first_block(model_v2, scene)
    staged_head = rgb_staged[:, :, :2 * RAY_BLOCK].float().clone()

    # -- 4. V=2 kernel checks on the first block's inputs ------------------
    torch.set_grad_enabled(False)
    k1 = check_attention('V=2', EA, *captured['epipolar_attention'][0])
    args = captured['fused_exchange_epilogue'][0]
    k2 = check_epilogue('K2 fused_exchange_epilogue',
                        GE.fused_exchange_epilogue,
                        GE.fused_exchange_epilogue_reference, args,
                        args[2:4], args[4], K2_TOL)
    k_takes = {'V=2': check_stream_takes('V=2', ST,
                                         captured['stream_takes'][0])}
    del captured, args
    torch.cuda.empty_cache()

    # -- 5. V=2 small input ------------------------------------------------
    small_agreement('V=2', RM, make_scene, dev)

    # -- 5b. V=2 fused render (K4) -----------------------------------------
    model = flagship(RM, dev, npoints=64, fused_render=True)
    captured, launches, rgb_fused = drive(
        'V=2 fused render', model, scene, RM,
        dict([render_core, attention, epilogue]),
        {'fused_render_core': N_BLOCKS, 'epipolar_attention': 0,
         'fused_exchange_epilogue': 0})
    by_path['v2_fused_render'] = launches
    check_paths('fused vs staged render', FUSED_VS_STAGED_TOL, rgb_fused,
                rgb_staged, first_block(model, scene), block_staged)
    k4 = check_render_core(FR, captured['fused_render_core'][0])
    del model, scene, captured, rgb_fused
    torch.cuda.empty_cache()
    small_agreement('V=2 fused render', RM, make_scene, dev,
                    fused_render=True)

    # -- 6. V=3 default path (Path A): K1 and K3 ---------------------------
    model_v3 = flagship(RM, dev, n_view=3)
    scene = make_scene(0, n_view=3, H=H, W=W, n_rays=H * W,
                       full_image=True, device=dev)
    captured, launches, rgb_v3 = drive(
        'V=3 (Path A)', model_v3, scene, RM,
        dict([attention, epilogue_multi, takes]),
        {'epipolar_attention': 2 * N_BLOCKS,
         'fused_exchange_epilogue_multi': N_BLOCKS,
         'stream_takes': N_BLOCKS})
    by_path['v3'] = launches
    k1['at_v3'] = check_attention('V=3', EA,
                                  *captured['epipolar_attention'][0])
    args = captured['fused_exchange_epilogue_multi'][0]
    k3 = check_epilogue('K3 fused_exchange_epilogue_multi',
                        GE.fused_exchange_epilogue_multi,
                        GE.fused_exchange_epilogue_multi_reference, args,
                        args[2], args[3], K3_TOL)
    k_takes['V=3'] = check_stream_takes('V=3', ST,
                                        captured['stream_takes'][0])
    del captured, args
    torch.cuda.empty_cache()

    # -- 7. V=3 reference-compatible path (Path B): K1 and K9 --------------
    model_v3c = flagship(RM, dev, n_view=3, **PATH_B)
    per_block = 3 * 3       # 3 self and 6 cross fuse calls per block
    captured, launches, rgb_v3c = drive(
        'V=3 compat (Path B)', model_v3c, scene, RM, dict([attention, mlp]),
        {'epipolar_attention': 2 * N_BLOCKS,
         'fused_mlp2': per_block * N_BLOCKS})
    by_path['v3_compat'] = launches
    args = captured['fused_mlp2'][0]
    k9 = check_mlp(FM, args)
    x1, x2, w1a, w1b, b1, w2, b2 = args
    dt = x1.dtype
    w1a_, w1b_, w2_ = (w.to(dt) for w in (w1a, w1b, w2))

    def two_matmuls():      # the same function as two torch.matmul calls
        h = torch.relu(x1 @ w1a_ + x2 @ w1b_ + b1.to(dt))
        return h @ w2_ + b2.to(dt)

    log(f'note: the torch.matmul chain relu(x1 @ W1a + x2 @ W1b + b1) @ W2 '
        f'+ b2 on K9\'s inputs: {cuda_ms(two_matmuls, 10):.3f} ms')
    del scene, captured, args, x1, x2
    torch.cuda.empty_cache()

    # -- 8. V=3 small inputs -----------------------------------------------
    small_agreement('V=3 (Path A)', RM, make_scene, dev, n_view=3)
    small_agreement('V=3 compat (Path B)', RM, make_scene, dev, n_view=3,
                    **PATH_B)

    # -- 9. V=2 sorted stream: K5 (and K6 on its inputs) -------------------
    model_v2.sorted_stream = True
    scene = make_scene(0, H=H, W=W, n_rays=H * W, full_image=True,
                       device=dev)
    captured, launches, rgb_sorted = drive(
        'V=2 sorted', model_v2, scene, RM,
        dict([resident, attention, epilogue, render_core]),
        {'resident_gather': 6 * N_BLOCKS, 'epipolar_attention': 2 * N_BLOCKS,
         'fused_exchange_epilogue': 0, 'fused_render_core': 0},
        capture={'grid_sample_sorted': (RM, 'grid_sample_sorted', 6)})
    by_path['v2_sorted'] = launches
    check_paths('V=2 sorted vs staged render', PATH_TOL, rgb_sorted,
                rgb_staged, first_block(model_v2, scene), block_staged)
    # the first block's 3 self-stream levels, then its 3 cross-stream ones
    cases = [sorted_case(SG, *args) for args in captured['grid_sample_sorted']]
    k5 = check_gather('K5 resident_gather', SG.resident_gather, cases,
                      torch.bfloat16)
    k6 = check_gather('K6 windowed_gather', SG.windowed_gather, cases[:3],
                      torch.float32)
    log('K6 windowed_gather: 0 launches on every path (no renderer path '
        'calls it; in the JAX package only tools and tests do)')
    k8_case = cases[0]      # level 0, the V=2 path's 2x64x64x256 table
    del model_v2, scene, captured, cases, rgb_sorted, rgb_staged
    torch.cuda.empty_cache()
    small_agreement('V=2 sorted', RM, make_scene, dev, sorted_stream=True)

    # -- 10. V=3 sorted stream: K5 -----------------------------------------
    model_v3.sorted_stream = True
    scene = make_scene(0, n_view=3, H=H, W=W, n_rays=H * W,
                       full_image=True, device=dev)
    _, launches, rgb = drive(
        'V=3 sorted', model_v3, scene, RM,
        dict([resident, attention, epilogue_multi]),
        {'resident_gather': 6 * N_BLOCKS, 'epipolar_attention': 2 * N_BLOCKS,
         'fused_exchange_epilogue_multi': 0})
    by_path['v3_sorted'] = launches
    check_paths('V=3 sorted vs default render', PATH_TOL, rgb, rgb_v3)
    del model_v3, rgb, rgb_v3
    torch.cuda.empty_cache()
    small_agreement('V=3 sorted', RM, make_scene, dev, n_view=3,
                    sorted_stream=True)
    small_agreement('V=3 compat sorted', RM, make_scene, dev, n_view=3,
                    sorted_stream=True, **PATH_B)

    # -- 11. V=3 compat with the one-hot gather: K7 -------------------------
    model_v3c.gather = 'onehot'
    captured, launches, rgb = drive(
        'V=3 compat one-hot', model_v3c, scene, RM,
        dict([onehot, attention, mlp]),
        {'onehot_gather': 6 * N_BLOCKS, 'epipolar_attention': 2 * N_BLOCKS,
         'fused_mlp2': per_block * N_BLOCKS},
        capture={'grid_sample_pallas': (PG, 'grid_sample_pallas', 6)})
    by_path['v3_compat_onehot'] = launches
    check_paths('V=3 compat one-hot vs take render', PATH_TOL, rgb, rgb_v3c)
    # the first block's 3 epipolar-gather levels, then its 3 cross ones
    k7 = check_gather('K7 onehot_gather', PG.onehot_gather,
                      [table_case(PG, *args)
                       for args in captured['grid_sample_pallas']],
                      torch.bfloat16)
    del model_v3c, scene, captured, rgb, rgb_v3c
    torch.cuda.empty_cache()

    # -- 12. K8 ------------------------------------------------------------
    table_bytes = k8_case[0].numel() * 2
    log(f'K8 on the V=2 level-0 table {tuple(k8_case[0].shape)}: '
        f'{table_bytes:,} bytes in bf16, limit {PG.BANDED_TABLE_BYTES:,}')
    if table_bytes > PG.BANDED_TABLE_BYTES:
        raise RuntimeError('the V=2 level-0 table exceeds K8\'s limit')
    k8 = check_gather('K8 banded_gather', BG.banded_gather, [k8_case],
                      torch.bfloat16)
    del k8_case
    by_path['v3_compat_banded_small'] = small_agreement(
        'V=3 compat banded', RM, make_scene, dev,
        counted={'banded_gather': (BG.banded_gather, 6)}, n_view=3,
        gather='banded', **PATH_B)

    # -- 13. wide latents: the exchange core's plans ------------------------
    wide = {ff: check_wide(ff, RM, FM, FR, GE, make_scene, dev)
            for ff in WIDE_FF}
    wide_small = dict(SMALL, fusion_features=512)
    for label, kw, counted in (
            ('V=2', {}, {'epipolar_attention': (EA.epipolar_attention, 2),
                         'fused_exchange_epilogue': (
                             GE.fused_exchange_epilogue, 1)}),
            ('V=2 fused render', dict(fused_render=True),
             {'fused_render_core': (FR.fused_render_core, 1),
              'epipolar_attention': (EA.epipolar_attention, 0)}),
            ('V=3 (Path A)', dict(n_view=3),
             {'epipolar_attention': (EA.epipolar_attention, 2),
              'fused_exchange_epilogue_multi': (
                  GE.fused_exchange_epilogue_multi, 1)})):
        small_agreement(f'{label} ff=512', RM, make_scene, dev,
                        counted=counted, small=wide_small, **kw)
    for key, numbers in (('K2', k2), ('K3', k3), ('K9', k9), ('K4', k4)):
        numbers['wide'] = {str(ff): wide[ff][key] for ff in WIDE_FF}
    torch.cuda.empty_cache()

    # -- 14. the row-gather probes (T1-T13) ---------------------------------
    t0 = time.perf_counter()
    probes = probe_kernels(dev)
    log(f'probes: {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()

    # -- 15. evaluation ----------------------------------------------------
    build_dir = root / 'cross_attention_renderer_torch' / 'build'
    build_dir.mkdir(parents=True, exist_ok=True)
    evaluation = check_evaluation(
        RM, make_scene, dev, random_lpips_npz(build_dir / 'lpips_random.npz'))
    torch.cuda.empty_cache()

    # -- 17-19. training ---------------------------------------------------
    from cross_attention_renderer_torch.tools import bench_train as BT
    t0 = time.perf_counter()
    with torch.enable_grad():
        routes = train_routes(EA, GE, make_scene, dev,
                              lambda: BT.flagship_train_model(dev),
                              BT.BATCH, BT.RAYS)
        by_path['train_kernel_route_step'] = routes['kernels'][
            'launches_per_step']
        fitted = check_fit(make_scene, dev, lambda seed: (
            RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=seed,
                                      device=dev, **SMALL)))
        stage2 = check_stage2(make_scene, dev,
                              lambda: BT.flagship_train_model(dev),
                              build_dir / 'lpips_random.npz')
    log(f'training phases: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'train': {
        'card': card, 'step': {'batch': BT.BATCH, 'rays': BT.RAYS,
                               'hw': H, 'views': 2, 'dtype': 'bf16'},
        'routes': routes, 'fit': fitted, 'stage2': stage2}}), flush=True)

    # -- 20. f32 models through the kernels ---------------------------------
    t0 = time.perf_counter()
    with torch.no_grad():
        by_path_f32, k_f32 = f32_paths(RM, EA, GE, FR, FM, make_scene, dev,
                                       attention, epilogue, epilogue_multi,
                                       mlp, render_core)
    log(f'f32 phases: {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()

    # -- 21-22. the CLI: eval at V=2 and V=3, then 3 train steps ------------
    t0 = time.perf_counter()
    with torch.enable_grad():
        cli = check_cli(dev, build_dir, dict([attention, epilogue]),
                        dict([attention, epilogue_multi]), by_path_f32)
    log(f'CLI phases: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'cli': dict(cli, card=card)}), flush=True)
    torch.cuda.empty_cache()

    # -- 23. fast evaluation -------------------------------------------------
    t0 = time.perf_counter()
    with torch.no_grad():
        fast_paths, fast_times, fast = fast_eval(
            RM, EA, GE, FR, make_scene, dev,
            dict([attention, epilogue, epilogue_multi, render_core]))
    log(f'fast-eval phase: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'fast_eval': {'card': card, 'images': fast_times,
                                    'launches': fast_paths}}), flush=True)
    torch.cuda.empty_cache()
    # Its launches by instantiation: bf16 tables (dense, pruned, narrow),
    # int8 tables beside bf16 (q8, fast) and beside f32 (the f32 model).
    # -- 24. the other encoders, view counts and ablation flags --------------
    t0 = time.perf_counter()
    with torch.no_grad():
        ab_paths, ab_times, ab_numbers, ab_runs = ablations(
            RM, EA, GE, FR, FM, PG, SG, BG, make_scene, dev,
            dict([attention, epilogue, epilogue_multi, render_core, mlp]),
            build_dir)
    log(f'ablation phase: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'ablations': dict(ab_runs, card=card, images=ab_times,
                                        launches=ab_paths)}), flush=True)
    torch.cuda.empty_cache()
    # The flags on the flagship V=2 model run K1 and K2 at its shapes, and
    # the V=4 compat path K9 at phase 7's: their launches join those
    # kernels' entries. The new modes and shapes have entries of their own.
    for key in ('v2_no_sample', 'v2_no_multiview', 'v2_no_high_freq'):
        by_path[key] = ab_paths[key]
    by_path['v4_compat'] = {'fused_mlp2': ab_paths['v4_compat']['fused_mlp2']}

    # -- 25. the unposed path ------------------------------------------------
    t0 = time.perf_counter()
    with torch.no_grad():
        by_path_f32['unposed'] = unposed(RM, dev, attention, epilogue, card)
    log(f'unposed phase: {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()

    # -- 26. the capability path ---------------------------------------------
    t0 = time.perf_counter()
    cap_kernels = capability(RM, EA, GE, dev,
                             dict([attention, epilogue, render_core]),
                             build_dir, card)
    log(f'capability phase: {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()

    # -- 27. the parallel layer ----------------------------------------------
    t0 = time.perf_counter()
    by_path.update(parallel(RM, EA, GE, dev, staged_head, card))
    log(f'parallel phase: {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()

    # -- 28. more than four context views -------------------------------------
    t0 = time.perf_counter()
    with torch.no_grad():
        vw_paths, vw_paths_f32, vw_numbers, vw_times = views(
            RM, EA, GE, FM, SG, make_scene, dev,
            dict([attention, epilogue_multi, mlp, resident]))
    log(f'views phase: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'views': {'card': card, 'images': vw_times,
                                'launches': dict(vw_paths,
                                                 **vw_paths_f32)}}),
          flush=True)
    torch.cuda.empty_cache()
    # K9 and K5 run at V=5 on their own entries' kernels; K1 at V=5 and
    # V=6 has entries of its shapes (V*P = 240, 288), its f32 instantiation
    # its own entry's; K3's modes at S = 5, 6, 8 have entries of their own.
    by_path['v5_compat'] = {'fused_mlp2': vw_paths['v5_compat']['fused_mlp2']}
    by_path['v5_sorted'] = {
        'resident_gather': vw_paths['v5_sorted']['resident_gather']}
    by_path_f32['v5_f32'] = {
        'epipolar_attention': vw_paths_f32['v5_f32']['epipolar_attention']}

    # -- 29. the card tools ----------------------------------------------------
    t0 = time.perf_counter()
    with torch.enable_grad():
        tool_seconds = tools_phase(build_dir)
    log(f'tools phase: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'tools': {'card': card, 'seconds': tool_seconds}}),
          flush=True)
    torch.cuda.empty_cache()

    # -- 30. widths the kernels once refused, and the upstream checkpoint --
    t0 = time.perf_counter()
    with torch.no_grad():
        wd_paths, wd_numbers, converted = widths(
            RM, EA, GE, FR, FM, PG, SG, BG, make_scene, dev,
            dict([attention, epilogue, epilogue_multi, render_core, mlp,
                  resident, onehot]), build_dir)
    log(f'widths phase: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'widths': {'card': card, 'launches': wd_paths,
                                 'converted': converted}}), flush=True)
    torch.cuda.empty_cache()

    fast_f32 = {p: n for p, n in fast_paths.items() if p.endswith('_f32')}
    fast_i8 = {p: n for p, n in fast_paths.items()
               if p not in fast_f32 and ('_q8' in p or '_fast' in p)}
    fast_bf16 = {p: n for p, n in fast_paths.items()
                 if p not in fast_f32 and p not in fast_i8}
    k1['pruned'] = fast['K1']
    for key, numbers in (('fused_exchange_epilogue', k2),
                         ('fused_exchange_epilogue_multi', k3),
                         ('fused_render_core', k4)):
        numbers['pruned'] = fast['pruned'][key]

    kernels = []
    for (name, _), numbers, source, replaces in (
            (attention, k1, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118'),
            (epilogue, k2, 'gather_epilogue.cu', 'ops/gather_epilogue.py:220'),
            (epilogue_multi, k3, 'gather_epilogue_multi.cu',
             'ops/gather_epilogue.py:421'),
            (mlp, k9, 'fused_mlp.cu', 'ops/experimental/fused_mlp.py:77'),
            (render_core, k4, 'fused_render.cu', 'ops/fused_render.py:349'),
            (resident, k5, 'bilinear_gather.cu', 'ops/sorted_gather.py:206'),
            (windowed, k6, 'bilinear_gather.cu', 'ops/sorted_gather.py:311'),
            (onehot, k7, 'bilinear_gather.cu', 'ops/pallas_gather.py:70'),
            (banded, k8, 'bilinear_gather.cu',
             'ops/experimental/banded_gather.py:106')):
        fast_runs = dict(fast_bf16, **(fast_i8 if name == attention[0]
                                       else {}))
        paths = {p: n[name] for p, n in dict(by_path, **fast_runs).items()
                 if n.get(name)}
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': sum(paths.values()), 'launches_by_path': paths,
            'backward': 'the plain version, recomputed (ops/_autograd.py)',
            'library_ms': None, **numbers})
    for (name, _), numbers, source, replaces in (
            (attention, k_f32['K1'], 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118'),
            (epilogue, k_f32['K2'], 'gather_epilogue.cu',
             'ops/gather_epilogue.py:220'),
            (epilogue_multi, k_f32['K3'], 'gather_epilogue_multi.cu',
             'ops/gather_epilogue.py:421'),
            (mlp, k_f32['K9'], 'fused_mlp.cu',
             'ops/experimental/fused_mlp.py:77'),
            (render_core, k_f32['K4'], 'fused_render.cu',
             'ops/fused_render.py:349')):
        fast_runs = fast_f32 if name == attention[0] else {}
        paths = {p: n[name] for p, n in dict(by_path_f32,
                                              **fast_runs).items()
                 if n.get(name)}
        kernels.append({
            'name': f'{name}_f32', 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': sum(paths.values()), 'launches_by_path': paths,
            'backward': 'the plain version, recomputed (ops/_autograd.py)',
            'library_ms': None, **numbers})
    for (name, _), source, replaces in (
            (epilogue, 'gather_epilogue.cu', 'ops/gather_epilogue.py:220'),
            (epilogue_multi, 'gather_epilogue_multi.cu',
             'ops/gather_epilogue.py:421'),
            (render_core, 'fused_render.cu', 'ops/fused_render.py:349')):
        for suffix, runs, numbers in (('_i8', fast_i8, fast['int8']),
                                      ('_i8_f32', fast_f32,
                                       fast['int8_f32'])):
            paths = {p: n[name] for p, n in runs.items() if n.get(name)}
            (flagship_numbers,) = numbers[name].values()
            kernels.append({
                'name': f'{name}{suffix}', 'route': 'cuda',
                'source': f'cross_attention_renderer_torch/csrc/{source}',
                'replaces': f'cross_attention_renderer_tpu/{replaces}',
                'launches': sum(paths.values()), 'launches_by_path': paths,
                'backward': 'none: int8 tables take no gradient',
                'library_ms': None, **flagship_numbers,
                'pruned': numbers[f'{name} pruned']})
    # the ABLATION_PATHS that run each new entry's kernel at its mode or shape
    for entry, (name, _), source, replaces, what in (
            ('fused_exchange_epilogue_l4', epilogue, 'gather_epilogue.cu',
             'ops/gather_epilogue.py:220', 'K2, 4 pyramid levels'),
            ('fused_exchange_epilogue_multi_l4', epilogue_multi,
             'gather_epilogue_multi.cu', 'ops/gather_epilogue.py:421',
             'K3, 4 pyramid levels'),
            ('fused_render_core_l4', render_core, 'fused_render.cu',
             'ops/fused_render.py:349', 'K4, 4 pyramid levels'),
            ('fused_exchange_epilogue_multi_s4', epilogue_multi,
             'gather_epilogue_multi.cu', 'ops/gather_epilogue.py:421',
             'K3, S = 4 streams (V=4)'),
            ('epipolar_attention_vp192', attention, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118', 'K1, V*P = 192 (V=4)'),
            ('epipolar_attention_c576', attention, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118',
             'K1, C = 576 (V=1, no_latent_concat)'),
            ('epipolar_attention_c960', attention, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118', 'K1, C = 960 (U-Net V=1)'),
            ('epipolar_attention_c256', attention, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118',
             'K1, C = 256 (ResNet34 V=2 and V=3)'),
            ('epipolar_attention_c480', attention, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118',
             'K1, C = 480 (U-Net V=2 and V=3)')):
        paths = {}
        for label, _, _, entries in ABLATION_PATHS:
            key = label.lower().replace(' ', '_').replace('=', '').replace(
                '-', '')
            if entries.get(name) == entry:
                paths[key] = ab_paths[key][name]
        by_label = ab_numbers[entry]
        first = next(iter(by_label.values()))
        kernels.append({
            'name': entry, 'mode': what, 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': sum(paths.values()), 'launches_by_path': paths,
            'backward': 'the plain version, recomputed (ops/_autograd.py)',
            'library_ms': None, **first, 'checked_on': by_label})
    # the VIEW_PATHS that run each view entry's kernel at its S or shape
    view_entries = (
        ('fused_exchange_epilogue_multi_s5', 'K3, S = 5 streams (V=5)'),
        ('fused_exchange_epilogue_multi_s6', 'K3, S = 6 streams (V=6)'),
        ('fused_exchange_epilogue_multi_s8',
         'K3, S = 8 streams (a V=8 block; on no image path)'),
        ('fused_exchange_epilogue_multi_s5_f32', 'K3 f32, S = 5 (V=5 f32)'),
        ('fused_exchange_epilogue_multi_s8_f32',
         'K3 f32, S = 8 (on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s5', 'K3 int8, S = 5 (V=5 q8)'),
        ('fused_exchange_epilogue_multi_i8_s5_f32',
         'K3 int8 with f32 slot weights, S = 5 (on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s8',
         'K3 int8, S = 8 (on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s8_f32',
         'K3 int8 with f32 slot weights, S = 8 (on no image path)'),
        ('fused_exchange_epilogue_multi_s4_f32',
         'K3 f32, S = 4 (a V=4 block; on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s4',
         'K3 int8, S = 4 (a V=4 block; on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s4_f32',
         'K3 int8 with f32 slot weights, S = 4 (on no image path)'),
        ('fused_exchange_epilogue_multi_s6_f32',
         'K3 f32, S = 6 (a V=6 block; on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s6',
         'K3 int8, S = 6 (a V=6 block; on no image path)'),
        ('fused_exchange_epilogue_multi_i8_s6_f32',
         'K3 int8 with f32 slot weights, S = 6 (on no image path)'),
        ('fused_exchange_epilogue_multi_l4_s5',
         'K3, 4 pyramid levels, S = 5 (ResNet34 V=5)'),
        ('epipolar_attention_vp240',
         'K1, V*P = 240 (V=5; C = 256 on ResNet34)'),
        ('epipolar_attention_vp288', 'K1, V*P = 288 (V=6)'))
    for entry, what in view_entries:
        name = ('epipolar_attention' if entry.startswith('epipolar')
                else 'fused_exchange_epilogue_multi')
        source = ('epipolar_attention.cu' if entry.startswith('epipolar')
                  else 'gather_epilogue_multi.cu')
        replaces = ('ops/epipolar_attention.py:118'
                    if entry.startswith('epipolar')
                    else 'ops/gather_epilogue.py:421')
        # K3's entries: the path that checked it; K1's: every bf16 path at
        # its view count
        paths = {}
        for label, _, _, entries in VIEW_PATHS:
            key = label.lower().replace(' ', '_').replace('=', '').replace(
                '-', '')
            if name == 'epipolar_attention':
                views_of = 'v5' if entry.endswith('240') else 'v6'
                hit = views_of in key and key in vw_paths
            else:
                hit = entries.get(name) == entry
            if hit:
                paths[key] = dict(vw_paths, **vw_paths_f32)[key][name]
        by_label = vw_numbers[entry]
        first = next(iter(by_label.values()))
        kernels.append({
            'name': entry, 'mode': what, 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': sum(paths.values()), 'launches_by_path': paths,
            'backward': ('none: int8 tables take no gradient'
                         if '_i8' in entry else
                         'the plain version, recomputed (ops/_autograd.py)'),
            'library_ms': None, **first, 'checked_on': by_label})
    # phase 30's entries: each kernel at the widths it once refused
    for entry, n in wd_numbers.items():
        n = dict(n)
        name = n.pop('kernel')
        source, replaces = KERNEL_SOURCES[name]
        paths = n.pop('launches_by_path')
        kernels.append({
            'name': entry, 'mode': n.pop('mode'), 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': sum(paths.values()), 'launches_by_path': paths,
            'backward': ('none: int8 tables take no gradient'
                         if '_i8' in entry else
                         'the plain version, recomputed (ops/_autograd.py)'),
            'library_ms': None, **n})
    # the address math: no TPU kernel (XLA fused it in the JAX package)
    kernels.append({
        'name': 'stream_takes', 'route': 'cuda',
        'source': 'cross_attention_renderer_torch/csrc/stream_takes.cu',
        'replaces': None, 'launches': N_BLOCKS,
        'launches_by_path': {'v2': by_path['v2']['stream_takes'],
                             'v3': by_path['v3']['stream_takes']},
        'backward': 'none: the address math takes no gradient',
        'library_ms': None, **k_takes['V=2'], 'checked_on': k_takes})
    kernels += cap_kernels + probes
    for kern in kernels:
        log(f'{kern["name"]}: {kern["ms"]:.3f} ms, plain '
            f'{kern["plain_ms"]:.3f} ms, bound {kern["bound_ms"]:.3f} ms '
            f'({kern["bound_by"]}), library {kern["library_ms"]} ms, '
            f'launches per image {kern["launches_by_path"]}')
    log(f'evaluation: {json.dumps(evaluation)}')
    log(f'core plans: {len(core_plans)} widths launched, each on the plan '
        f'and slots core_plan gives: ' + '; '.join(
            f'{dict(k)["mode"]} S={dict(k)["S"]} F={dict(k)["F"]} '
            f'O={dict(k)["O"]}: {p} {n}' for k, (p, n) in core_plans.items()))
    log(f'chip_smoke: {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['parallel-rank']:
        sys.exit(parallel_rank(sys.argv[2:]))
    sys.exit(main())
