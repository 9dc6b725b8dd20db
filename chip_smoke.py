#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (the literal and the fused decoder
tail), the decoder's UpConvs in both forms, its training paths (config 4 and config 3, config 4 also under
torch.distributed and fed from each input loader), spatial sharding (configs 2 and 4 in bands), the other encoders, the
evaluation entry points, the serving entry points (convert, export, HTTP,
sequence) and its public LPG op once on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repo root; one CUDA card, nvcc

Phases, one JSON line each, then the result:

1. device     - torch and CUDA versions, the card's name and power limit.
2. build      - builds the three sources of csrc/ (nvcc, sm_90a), one nvcc
                each, started together: lpg_fused.cu (K1 the fused LPG head
                forward, K2 its backward, K3/K4 the public LPG op's forward
                and backward, K5 the head as phase planes), fused_tail.cu
                (K6 the fused decoder tail) and batchnorm.cu (K7 the
                eval-mode BatchNorm), and a profiling build of
                fused_tail.cu with -DK6_STAGE_CLOCKS (K6's stage clocks);
                ptxas's registers and spills of every K1-K4 instance and of
                K6, and the count of HMMA (tensor-core) instructions in the
                SASS (cuobjdump) of each of K6's two instances (bf16 and f32
                iconv2), which must be > 0.
3. floor      - the launch floor: the device time per call of an empty
                kernel launched through the library (lpg_empty_launch) on the
                grid and block of each forward launch whose row below
                prints its floor (K1/K3 at the serving and ragged heads; K5
                at the serving and b4 export heads).
4. kernel     - K1 against its plain PyTorch version at the three shapes of
                a 352x1216 forward and one ragged B=2 shape; rule rtol 2e-5,
                atol 2e-6*max|ref| on pixels with |denominator| >= 1e-3 (the
                excluded count is printed).  Times from CUDA events: device
                time per call (batches of 50 calls queued behind a sleep
                kernel) and the median single-call latency of 50 calls;
                the kernel alone (its library entry called directly on the
                same tensors), the wrapper's overhead and the share of the
                bound the kernel alone reaches, the launch (warps per cell
                row: b1 heads split their rows; warps per block; blocks),
                the floor and the distance above it, one row per head; and the
                op's CUDA implementation called directly (the wrapper
                before K1 became a torch.library op): its times and the
                dispatcher's share of the call latency.
5. kernel_bwd - K2 against its plain version at the three head shapes of
                the config-4 training step (b16, 352x704) and a ragged B=2
                shape, with f32 and bf16 raw; rule rtol 2e-4,
                atol 2e-5*max|ref| on cells whose k x k denominators all
                have |den| >= 1e-3 (excluded cells counted).  K1 at the same
                three shapes.  Times, the kernel alone, overhead, bound and
                share as phase 4 (K1 with its launch: no split, 8 warps per
                block), one row per head and the per-step sums.
                The device kernels one bf16 call of each wrapper launches
                (torch.profiler, utils/profiling.py): K1's and K2's own and
                nothing else, so no cast of raw.
6. kernel_lpg - K3 against its plain version at the three serving head
                shapes (planes from plane_from_spherical, max_depth 80) and
                the ragged shape, K1's rule, alone with its launch and
                floor as phase 4; K4 at the three config-4 head
                shapes with f32 and bf16 planes, K2's rule.  Times and
                bounds.  Then the op path: local_planar_guidance forward and
                backward at the serving heads, 3 K3 + 3 K4 launches.
7. tail       - K5 against its plain version and against K1 interleaved,
                bit for bit, at the three serving shapes and the three b4
                export heads, f32 and bf16 raw (bf16 also equal to K5 on its
                f32 copy), alone with its launch and floor as phase 4 (the
                plain version timed at the serving heads with f32 raw); one
                bf16 call launches K5 alone (torch.profiler); K6 against its
                plain version at 352x1216 b1 (B=1, Hh=176, W2=608) and at a
                ragged B=2, Hh=16, W2=152: max and mean abs error and pixels
                above 1e-4, rule mean <= 2e-5, max <= 5e-2, share above 1e-4
                <= 1%.  Times (K6 also alone, launched directly on the same
                iconv2 view; the wrapper's overhead) and bounds (K6
                against the bf16 tensor-core rate, with the f32 CUDA-core
                floor, and the share of the bound reached); K6's median
                SM cycles per block in each stage (staging, upconv,
                reduction chain, iconv1, final conv) from the profiling
                build.
7b. bn       - K7, the eval-mode BatchNorm (+ReLU or SiLU) of
                csrc/batchnorm.cu, on the BatchNorm calls of a bf16 serving
                forward at 352x1216 (their shapes, activations and eps from
                forward pre-hooks; the forward must launch K7 once per
                call): DenseNet-161 BTS's 175 (ReLU, eps 1.1e-5) at b1 and
                b8, EfficientNet-B5 BTS's 130 (76 SiLU, 9 ReLU; eps 1e-3 in
                the encoder) at b1 and b16: equal to the ATen chain at every
                call, bit for bit; the summed device ms of all of them
                (torch.profiler, each window holding every launch the calls
                make, or dropped) for K7 through its op, the plain chain and
                F.batch_norm + F.relu or F.silu (the yardstick the port
                never calls), against their byte bound (4 bytes an
                element), K7 also by plane size; the host's microseconds to
                issue one call on DenseNet-161's norm5 input through the
                module, the op, the launch alone, the chain and
                F.batch_norm.
8. upconv     - the five UpConvs of DenseNet-161 BTS (bts_size 512) at the
                b1 352x1216 serving shapes and the b16 352x704 config-4
                shapes, f32 and bf16: the fused form (one stride-2
                transposed conv with the folded 4x4 kernel, the default)
                against the literal one (nearest-2x upsample, then the 3x3
                conv) on the same weights, input and cotangent: rule
                max|fused - literal| <= 2e-5 (f32), 2^-6 (bf16) of
                max|literal| in the forward, and |g_fused - g_literal| <=
                1e-4 (f32), 2^-6 (bf16) of |g_literal| for the gradients of
                x, the weight and the bias; device ms of each form's
                forward and of its backward alone (CUDA events, batches
                queued behind a sleep kernel), 4 batches of each in turns;
                each form's peak memory of a forward and backward above
                its inputs; each form's MACs; the largest difference
                between two forwards, and between two backwards, of one
                form on one input: the fused forward must repeat bit for
                bit (in f32 it runs as one phase conv, the port's
                UpConv.deterministic); in f32 also the fused form on
                cuDNN's transposed-conv algorithm, which does not repeat,
                timed beside it.
9. slice      - serving: create_model + bts_test.predict, DenseNet-161,
                bts_size 512, 352x1216, batch 1, KITTI focal, seeded
                weights, float32 and bfloat16; 3 K1 launches per forward;
                outputs finite where the LPG denominators are non-zero;
                depth in (0, max_depth]; the kernel path against
                use_pallas="never"; the f32 model against the same weights on
                the CPU at 64x96; median ms per forward and peak memory; the
                literal UpConv form on the same weights: the final depth's
                gap to the fused default, the device kernels of one forward
                of each form (torch.profiler), each form's peak memory and
                6 forwards of each in turns (f32: also the fused form on
                cuDNN's transposed-conv algorithm).
10. slice_tail - the same serving with --fused_tail always: 3 K5 + 1 K6 and
                no K1 per forward; the device kernels of one bf16 forward
                (torch.profiler): their count, and under each K5 and K6 op
                that kernel alone (no cast); finite outputs, depth in
                (0, max_depth];
                against use_pallas="never" on the fused path (maps by K1's
                rule, d1x1 and final by K6's); against the literal tail
                (fused_tail="auto": maps <= 1e-5, d1x1 <= 5e-3, final
                <= 5e-3*max_depth); 20 forwards of each path in turns
                (median, q1, q3) and each path's peak memory.
11. train     - config 4 (DenseNet-161, bts_size 512, KITTI 352x1216 uint8
                frames augmented to 352x704 with rotation <= 1 degree, b16,
                bfloat16, remat 'layer', AdamW + poly decay) through
                create_model + training.Trainer on seeded synthetic data
                (LiDAR-like depth: ~5% of pixels in [1, 80) m).  One f32 step
                at b2 on the kernel path against use_pallas="never" from the
                same state and draws (loss rtol 1e-4, per-tensor gradient
                gaps |dg|/|g| <= 1e-3); one f32 step on the card against the
                same weights and draws on the CPU at 64x96 (loss rtol 1e-5,
                whole-gradient gap <= 2e-2); then 2 warm-up and
                10 timed b16 steps: 3 K1 and 3 K2 launches per step, finite
                loss and gradients, BN running statistics that moved, ms per
                step, images/s, peak memory; then 8 steps of each path
                (kernel, use_pallas="never") in turns, with each path's peak
                memory; then 4 steps of each UpConv form (fused, literal)
                in turns, with each form's peak memory; a torch.profiler
                window of 2 steps for the device busy share and the top
                kernels.
12. train_ddp - config 4 under torch.distributed.  (a) bts_main
                (@arguments/arguments_train_eigen.txt: DenseNet-161, b16,
                bf16, remat 'layer') through python -m torch.distributed.run
                --nproc_per_node 1, NCCL, on a synthetic KITTI tree of 16
                375x1242 frames (KB crop, then 352x704) for 12 steps: 3 K1 +
                3 K2 per step (and 3 K1 for the step-1 summary forward), ms
                per step (median, q1, q3 of 10 after 2), images/s, peak
                memory, beside the train phase's; before it, one f32 b2 step
                through DistributedDataParallel against the unwrapped step
                made in this process (the train phase's rules).  (b) two
                ranks under torchrun in a gloo group, both on cuda:0: one
                f32 step at a global b4 (2 x b2) against the world-1 b4 step
                (loss rtol 1e-5, BatchNorm statistics 1e-5, each gradient
                tensor within the larger of 1e-3 and twice the distance one
                ulp of every weight moves it); ZeRO-1 against replicated
                AdamW over two steps of the same gradients (parameters
                1e-6) and each rank's optimizer-state bytes (about half);
                ms per step at b16 (2 x b8, bf16), 3 K1 + 3 K2 per step per
                rank.  The ranks are this script (train_ddp_rank); a failed
                rank fails the phase.
13. spatial   - spatial sharding: ranks under torchrun, all on cuda:0 over
                gloo (halos staged through pinned host memory; the ranks
                are this script, spatial_rank).  (a) config 2 serving
                (DenseNet-161, bts_size 512, 352x1216, b1, f32, KITTI
                focal) at 2 ranks (H over 2) and at 4 (2 x 2), each band's
                outputs gathered into the frame: max|banded - one process|
                / max|one process| <= 2e-5 for each of the five outputs
                against the forward made in this process on the same
                seeded weights, 3 K1 per rank; bts_test --spatial_shards 2
                on 3 synthetic KITTI frames writes the one-process run's
                PNGs within one unit.  (b) config 4 at 2 ranks: one f32
                Trainer step at a global b2 against the one-process step
                (loss rtol 1e-5, BatchNorm statistics 1e-5, the gradient
                the Trainer applied within the larger of 1e-3 and twice
                the distance one ulp of every weight moves it, the
                largest of 3 probes with seeded signs); the same step with
                BatchNorm frozen: the whole gradient within the larger of
                1e-4 and twice the probes', each tensor within the larger
                of 1e-3 and twice its probes' (a ReLU input within ~1e-6
                of zero flips under either change: the flipped masks of
                the encoder's BatchNorm outputs are counted); then
                2 warm-up and 8 timed bf16 b16 steps (remat 'layer'): ms per
                step (median, q1, q3), peak memory per rank beside the
                train phase's, halo bytes sent per step per rank, the
                backend, 3 K1 + 3 K2 per step per rank.
14. kernel_nyu - K1 and K2 at the three config-3 heads (NYU 416x544, b4)
                and K1 at the three heads of a NYU online eval (480x640, b4),
                f32 and bf16 raw, by the rules and with the columns of
                kernel_bwd; the per-step sums of config 3.
15. encoders  - ResNet-50/101, ResNeXt-50/101, MobileNetV2 and
                EfficientNet-B5 serving at 352x1216 b1 (bts_size 512,
                seeded weights): one f32 forward
                with 3 K1 launches against use_pallas="never" (maps by K1's
                rule, final rtol 1e-5) and against the CPU at 64x96 (rtol
                2e-4, atol 2e-4*max|ref|); median ms of 5 bf16 forwards and
                the peak memory.
15b. serve_b5 - EfficientNet-B5 BTS serving at the b16 stream's shape
                (create_model + bts_test.predict, 352x1216, b16, bf16,
                seeded weights): 130 K7 and 3 K1 launches per forward,
                counted from 0 just before the run; finite outputs, depth
                in (0, max_depth]; equal, bit for bit, to the same forward
                with every BatchNorm on its plain version; median ms of 5
                forwards after 2 warm-up, images/s and the peak memory.
16. train_nyu - config 3 (ResNeXt-101, NYU 480x640 frames border-cropped to
                427x565 and augmented to 416x544 with rotation <= 2.5
                degrees, depth in [0.2, 9.5) m, b4, bf16, no remat, AdamW lr
                1e-4, wd 1e-2, eps 1e-3) through create_model + Trainer, by
                the train phase's pattern: one f32 b2 step against
                use_pallas="never", one f32 step against the CPU at 64x96
                (loss rtol 1e-5; the whole gradient within the larger of
                2e-2 and twice its movement when every weight moves by one
                ulp: at 64x96 this gradient is set by f32 rounding), then
                2 warm-up and 10 timed b4 bf16 steps (3 K1 and 3 K2
                launches each): ms per step, images/s, peak memory; a
                torch.profiler window of 2 steps (busy share, top kernels).
17. eval      - the entry points on a synthetic NYU tree of 10 frames at
                480x640: bts_main with the config-3 recipe
                (arguments/arguments_train_nyu.txt, ResNeXt-101, b4) for 4
                steps with --do_online_eval --eval_freq 2 (3 K1 launches per
                batch forward, a padded tail of 2); best_eval.json with the
                nine metrics and ckpt_best/<metric>/ for each; bts_test on
                ckpt_best/abs_rel in the same batches, bts_eval on its PNGs
                against that online eval (the PNGs' 1 mm rounding: 5e-3 of
                each continuous metric, 1e-3 for d1-d3); online eval at b4
                against b1 on that state in f32 (1e-4 of each continuous
                metric, d1-d3 within 2 pixels per frame); a KITTI online
                eval (KB crop, garg crop, padded back to 375x1242) of the
                config-4 state from phase 10 over 20 frames at b16: finite,
                3 K1 launches per batch forward, images/s.
18. serving   - DenseNet-161, bts_size 512, KITTI, seeded weights, f32:
                an upstream-style full .pth ({"model": module.encoder.
                base_model.* / module.decoder.*}) through bts_convert, read
                back by read_weights equal to the source; bts_export at
                352x1216 b4 and load_exported: 3 K1 per forward, depth
                against bts_test.predict of the same weights <= 1e-4 *
                max_depth; again with --fused_tail always (3 K5 + 1 K6, no
                K1); artifact size, export and load seconds.  The kernels
                at these b4 heads against use_pallas="never" on the same
                frames (16 with the literal tail, 4 with the fused one):
                the maps by K1's rule, the final depth 1e-5 relative (K6's
                rule with the fused tail), and the exported depth by the
                same rule.  bts_serve from the artifact on a free port:
                /healthz, then 16 concurrent POST /v1/depth (PNG bodies,
                ?focal=; half .npy within 1e-4 * max_depth of eager and 1e-5
                relative of never, half PNG within 1 unit of depth_to_png of
                each), fewer device calls than requests and 3 K1 per call,
                requests/s and p50/p90 latency; the in-process backend
                (checkpoint, no artifact) with 4 requests by the same rules;
                shutdown with nothing left running; bts_sequence
                --do_kb_crop b4 over 10 frames of 375x1242 (a padded tail of
                2): 3 K1 per batch forward, each PNG within 1 unit of
                bts_test's for the same frame, through the kernels and
                through --use_pallas never; frames/s.
19. input     - the input plane at config-4 width.  A leg this machine
                cannot run (the native library does not build: no libpng/
                libjpeg headers; no array_record package) is named on its
                own line with the reason, first.  (a) 16 synthetic KITTI
                375x1242 frames (b16, KB crop) and 8 NYU 480x640 (b4, border
                crop): BtsDataLoader with --use_native_loader always against
                never over one epoch and from a resume at step 3 (images,
                focals, KITTI depths bit for bit, NYU depths within one
                ulp); without the library, always must raise; host ms per
                batch of each path (median, q1, q3), workers and threads
                from the arguments file.  (b) make_records shards of the 16
                frames through BtsDataLoader against the PNG tree, bit for
                bit; records/s.  (c) bts_main
                (@arguments/arguments_train_eigen.txt, bf16, remat layer) for
                12 steps from the PNG tree with never, with always and from
                the records, and (the control) the same batches decoded
                before the run and fed from memory: the same first loss,
                finite losses, 3 K1 + 3 K2 per step (and 3 K1 for the
                step-1 summary), ms per step (median, q1, q3 after 2),
                images/s, peak memory, beside the train phase's.  (d)
                bts_main --debug_nans for 2 steps (the first loss of (c)'s
                never run; ms per step beside it), again with the hooks
                alone (anomaly mode left off), and
                one step in a subprocess with a NaN in the weight of
                encoder.features.denseblock2.denselayer1.conv1: exits non-zero
                with FloatingPointError naming it.
20. result    - {"kernels": [...]}: all seven kernels, launches by main path
                (serve, serve_tail, train, train_ddp, spatial, op,
                encoders, serve_b5, train_nyu, eval, export, serve_http,
                sequence, input; each path's
                counts set to 0 just before it runs, K7's checked against
                the BatchNorm calls that take it), and ms,
                plain_ms, bound_ms per the unit
                named in "per" (K1, K2: a training step's three heads, bf16
                raw; K3: the three serving heads; K4: the three config-4
                heads, bf16 plane; K5: a fused-tail forward's three heads;
                K6: one 352x1216 forward; K7: the 175 BatchNorms of one
                352x1216 b1 forward, with library_ms, and under
                efficientnet_b5_b16 the same numbers and launches for the
                130 of one EfficientNet-B5 b16 forward), with kernel_only_ms,
                share_of_bound and (K3, K5) floor_ms where measured, the
                nvidia-smi line, and the
                contract line {"ok": true, ...} last.

Any failed check raises, so the script exits non-zero and prints no result.
Nothing falls back to the CPU or to the plain version.  It imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SLICE_SHAPES = [(1, 44, 152, 8), (1, 88, 304, 4), (1, 176, 608, 2)]  # (B, h, w, k) at 352x1216
EXPORT_SHAPES = [(4, 44, 152, 8), (4, 88, 304, 4), (4, 176, 608, 2)]  # the exported b4 serving heads
TRAIN_SHAPES = [(16, 44, 88, 8), (16, 88, 176, 4), (16, 176, 352, 2)]  # b16 at 352x704
RAGGED_SHAPE = (2, 13, 37, 8)  # W = 296, not a multiple of 32
TAIL_SHAPES = [(1, 176, 608), (2, 16, 152)]  # (B, Hh, W2): 352x1216 b1, and a ragged width
RTOL, ATOL_SCALE, DENOM_MIN = 2e-5, 2e-6, 1e-3
GRAD_RTOL, GRAD_ATOL_SCALE = 2e-4, 2e-5
TAIL_MEAN, TAIL_MAX, TAIL_OFF_SHARE = 2e-5, 5e-2, 0.01  # K6's rule (tests/test_torch_port_tail.py)
SOURCES = {"lpg_fused": "bts_tpu_torch/csrc/lpg_fused.cu", "fused_tail": "bts_tpu_torch/csrc/fused_tail.cu",
           "batchnorm": "bts_tpu_torch/csrc/batchnorm.cu"}
# (wrapper, key, library, the TPU kernel it replaces: kernel body, with the pallas_call that launches it)
KERNELS = [
    ("lpg_fused", "K1", "lpg_fused", "bts_tpu/ops/lpg_pallas.py:376"),  # _fused_fwd_kernel, _fused_fwd_call :443
    ("lpg_fused_bwd", "K2", "lpg_fused", "bts_tpu/ops/lpg_pallas.py:393"),  # _fused_bwd_kernel, _fused_bwd_call :463
    ("lpg_plane", "K3", "lpg_fused", "bts_tpu/ops/lpg_pallas.py:113"),  # _fwd_kernel, _fwd_call :185
    ("lpg_plane_bwd", "K4", "lpg_fused", "bts_tpu/ops/lpg_pallas.py:125"),  # _bwd_kernel, _bwd_call :206
    ("lpg_phase_planes", "K5", "lpg_fused", "bts_tpu/ops/tail_pallas.py:127"),  # _phase_lpg_kernel, call :153
    ("fused_tail", "K6", "fused_tail", "bts_tpu/ops/tail_pallas.py:208"),  # _tail_kernel, fused_tail :402
    ("bn_act", "K7", "batchnorm", "none: the JAX package leaves BatchNorm to XLA, which fuses it"),
]
H, W, FOCAL, MAX_DEPTH = 352, 1216, 721.5377, 80.0
TRAIN_H, TRAIN_W, TRAIN_B = 352, 704, 16
# config 3 (scripts/bench_suite.py:46-71, arguments/arguments_train_nyu.txt):
# ResNeXt-101, NYU 480x640 frames border-cropped to 427x565, trained at
# 416x544, b4, bf16, rotation <= 2.5 degrees, no remat
NYU_H, NYU_W, NYU_CROP_H, NYU_CROP_W = 480, 640, 427, 565
NYU_TRAIN_H, NYU_TRAIN_W, NYU_B = 416, 544, 4
NYU_FOCAL, NYU_MAX_DEPTH = 518.8579, 10.0
NYU_TRAIN_SHAPES = [(4, 52, 68, 8), (4, 104, 136, 4), (4, 208, 272, 2)]  # config 3: b4 at 416x544
NYU_EVAL_SHAPES = [(4, 60, 80, 8), (4, 120, 160, 4), (4, 240, 320, 2)]  # NYU online eval: b4 at 480x640
NEW_ENCODERS = ("resnet50_bts", "resnet101_bts", "resnext50_bts", "resnext101_bts", "mobilenetv2_bts",
                "efficientnet_b5_bts")
ENCODER_FORWARDS = 5  # timed bf16 forwards per encoder, after 2 warm-up
B5_SERVE_BATCH, B5_SERVE_FORWARDS = 16, 5  # serve_b5: the stream's batch; timed forwards, after 2 warm-up
EVAL_FRAMES, KITTI_EVAL_FRAMES, KITTI_FULL = 10, 20, (375, 1242)
SERVE_B, SERVE_REQUESTS, SERVE_LINGER_MS, SEQ_FRAMES = 4, 16, 20.0, 10  # the serving phase
TIMED_FORWARDS = 20
WARMUP_STEPS, TIMED_STEPS = 2, 10
TURNS = 8  # training steps of each path in the kernel-vs-never comparison
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# operations counted per full-resolution pixel (mul, add, div); the per-cell
# transform is a few tens of operations per k*k pixels and is left out
K1_OPS_PER_PIXEL, K2_OPS_PER_PIXEL = 5, 10
# K6: flops per full-resolution pixel, all dots of bf16 operands: upconv
# 4*64*32*2, the reduction chain (32*16 + 16*8 + 8)*2, iconv1 9*36*32*2,
# the final conv 9*32*2
K6_FLOPS_PER_PIXEL = 4 * 64 * 32 * 2 + (32 * 16 + 16 * 8 + 8) * 2 + 9 * 36 * 32 * 2 + 9 * 32 * 2
K6_TILE = (8, 16)  # fused_tail.cu's output tile (phase rows, phase cols): one block each
# the five UpConvs of DenseNet-161 BTS at bts_size 512, (cin, cout), upconv5
# (input at H/32) .. upconv1 (input at H/2)
UPCONV_CHANNELS = [(2208, 512), (512, 256), (128, 128), (128, 64), (64, 32)]
UPCONV_TURNS = 4  # upconv: timed batches of each form, in turns
# upconv: fused against literal, max|fused - literal| / max|literal| of the
# forward and |g_fused - g_literal| / |g_literal| of each gradient (x,
# weight, bias); bf16: the two forms round their kernels differently
# (tests/test_torch_port_upconv.py holds the CPU to the same rule)
UPCONV_FWD_RULE = {"float32": 2e-5, "bfloat16": 2.0**-6}
UPCONV_GRAD_RULE = {"float32": 1e-4, "bfloat16": 2.0**-6}
UPCONV_FORWARDS, UPCONV_STEPS = 6, 4  # slice, train: forwards / steps of each UpConv form in turns


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sass_count(lib_path, kernel: str, opcode: str) -> dict:
    """Instructions with opcode ``opcode`` in the SASS (``cuobjdump -sass`` of
    the built library) of each function whose name contains ``kernel``, by
    mangled name."""
    from bts_tpu_torch.ops import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip() if kernel in line else None
            if name:
                counts[name] = 0
        elif name and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas -v reported for each function whose
    name contains ``kernel``, by mangled name."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if kernel in line else None
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report.setdefault(name, {}).update(spill_store_bytes=int(m[1]), spill_load_bytes=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report.setdefault(name, {})["registers"] = int(m[1])
    return report


def demangle(name: str) -> str:
    """A mangled kernel name as C++ (cu++filt of the CUDA toolkit)."""
    from bts_tpu_torch.ops import _build

    filt = Path(_build.find_nvcc()).parent / "cu++filt"
    return subprocess.run([str(filt), name], capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def call_median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    """Median over ``runs`` single calls, CUDA events around each, the card
    idle before each: the call's latency, host dispatch included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = _events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_median_ms(fn, host_ms: float, runs: int = 50, repeats: int = 7) -> float:
    """Device time per call: ``runs`` calls queued behind a sleep kernel that
    outlasts their enqueueing (``host_ms`` per call, twice over at up to
    2 GHz), so the card never waits for the host between them, timed by CUDA
    events; the median over ``repeats`` such batches."""
    fn()
    return statistics.median(_batch_ms(fn, runs, host_ms) for _ in range(repeats))


def _batch_ms(fn, n: int, host_ms: float) -> float:
    """Device ms per call of ``n`` calls queued behind a sleep kernel that
    outlasts their enqueueing (``host_ms`` per call, twice over at up to
    2 GHz), by CUDA events."""
    start, end = _events()
    torch.cuda._sleep(int(2 * 2e6 * n * host_ms))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def timings(fn, plain_fn=None) -> dict:
    """Host latency and device time of ``fn``, and of ``plain_fn`` where given."""
    row = {"call_ms": call_median_ms(fn)}
    row["ms"] = device_median_ms(fn, row["call_ms"])
    if plain_fn is not None:
        row["plain_call_ms"] = call_median_ms(plain_fn)
        row["plain_ms"] = device_median_ms(plain_fn, row["plain_call_ms"])
    return row


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the rate for their type (f32 unless given), whichever
    is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def alone(row: dict, launch) -> None:
    """The kernel launched directly (``launch``: the library call the
    wrapper makes, on the same tensors, returning its error code) beside the
    wrapper's time already in ``row``: kernel_only_ms (and its single-call
    latency kernel_only_call_ms), the wrapper's overhead, and the share of
    the bound the kernel alone reaches."""
    def fn():
        check(launch() == 0, "direct launch failed")

    row["kernel_only_call_ms"] = call_median_ms(fn)
    row["kernel_only_ms"] = device_median_ms(fn, row["kernel_only_call_ms"])
    row["wrapper_overhead_ms"] = row["ms"] - row["kernel_only_ms"]
    row["share_of_bound"] = row["bound_ms"] / row["kernel_only_ms"]


def fwd_alone(lib, entry, x, k, out_shape=None):
    """A forward kernel launched directly on x as it is (its dtype and
    strides): library entry ``entry``, K1 (lpg_fused_forward) and K3
    (lpg_forward) into (B, h*k, w*k), K5 (lpg_phase_forward) into
    ``out_shape`` (B, 4, h*k/2, w*k/2)."""
    from bts_tpu_torch.ops.lpg_cuda import _DTYPES

    b, h, w, _ = x.shape
    out = torch.empty(out_shape or (b, h * k, w * k), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)
    return lambda: fn(x.data_ptr(), _DTYPES[x.dtype], *x.stride(), out.data_ptr(), b, h, w, k, stream)


def launch_floor(row: dict, kernel: str, b: int, h: int, w: int, k: int, floors: dict) -> None:
    """The launch the library makes for forward ``kernel`` (K1, K3, K5) at
    this shape, the floor (an empty kernel on the same grid and block,
    phase floor) and how far the kernel alone sits above it."""
    from bts_tpu_torch.ops.lpg_cuda import launch_shape

    row["launch"] = launch_shape(kernel, b, h, w, k)
    row["floor_ms"] = floors[("K5" if kernel == "K5" else "K1", b, h, w, k)]
    row["above_floor_ms"] = row["kernel_only_ms"] - row["floor_ms"]


def phase_floor(card: str) -> dict:
    """The launch floor: device time per call of an empty kernel launched
    through the library (lpg_empty_launch) on the grid and block of each
    forward launch whose row prints its floor: K1 and K3 (they share their
    launch) at the serving heads and the ragged shape, K5 at the serving and
    b4 export heads.  Returns the floors by (kernel, B, h, w, k)."""
    from bts_tpu_torch.ops.lpg_cuda import _lib, launch_shape

    stream = torch.cuda.current_stream().cuda_stream
    floors, rows = {}, []
    shapes = [("K1", s) for s in SLICE_SHAPES + [RAGGED_SHAPE]] + [("K5", s) for s in SLICE_SHAPES + EXPORT_SHAPES]
    for kernel, (b, h, w, k) in shapes:
        kind = int(kernel == "K5")

        def empty():
            check(_lib().lpg_empty_launch(kind, b, h, w, k, stream) == 0, "empty launch failed")

        row = {"kernel": kernel, "shape": [b, h, w, k], "launch": launch_shape(kernel, b, h, w, k),
               "call_ms": call_median_ms(empty)}
        row["ms"] = device_median_ms(empty, row["call_ms"])
        floors[(kernel, b, h, w, k)] = row["ms"]
        rows.append(row)
    emit({"phase": "floor", "card": card, "what": "empty kernel through lpg_empty_launch on each "
          "forward's grid and block (K1 and K3 share theirs)", "rows": rows})
    return floors


def k2_alone(lib, raw, g, k):
    """K2 launched directly on raw and g as they are (dtypes and strides)."""
    from bts_tpu_torch.ops.lpg_cuda import _DTYPES

    b, h, w, _ = raw.shape
    dx = torch.empty((b, 3, h, w), dtype=raw.dtype, device=raw.device)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.lpg_fused_backward(raw.data_ptr(), _DTYPES[raw.dtype], *raw.stride(), g.data_ptr(),
                                          *g.stride(), dx.data_ptr(), b, h, w, k, stream)


def compare_lpg(out, ref, den) -> dict:
    """K1's rule on pixels whose denominator is not near zero."""
    keep = den.abs() >= DENOM_MIN
    diff = (out - ref).abs()[keep]
    scale = ref[keep].abs().max().item()
    limit = RTOL * ref[keep].abs() + ATOL_SCALE * scale
    ok = bool(torch.isfinite(out[keep]).all()) and bool((diff <= limit).all())
    return {
        "max_abs_err": diff.max().item(),
        "max_rel_err": (diff / ref[keep].abs().clamp_min(1e-30)).max().item(),
        "excluded_pixels": int((~keep).sum()),
        "pixels": out.numel(),
        "within_rule": ok,
    }


def compare_grad(out, ref, den, k, rtol=GRAD_RTOL) -> dict:
    """K2's and K4's rule on cells whose k x k denominators (``den``, full
    resolution) all have |den| >= 1e-3."""
    b, h, w = out.shape[:3]
    keep = (den.reshape(b, h, k, w, k).abs() >= DENOM_MIN).all(4).all(2)
    out, ref = out.float()[keep], ref.float()[keep]
    diff = (out - ref).abs()
    scale = ref.abs().max().item()
    ok = bool(torch.isfinite(out).all()) and bool((diff <= rtol * ref.abs() + GRAD_ATOL_SCALE * scale).all())
    return {"max_abs_err": diff.max().item(), "max_abs_ref": scale,
            "excluded_cells": int((~keep).sum()), "cells": keep.numel(), "within_rule": ok}


def _raw(b, h, w, k, dtype=torch.float32):
    rng = np.random.default_rng(1000 * k + h)
    nchw = torch.from_numpy(rng.standard_normal((b, 3, h, w), dtype=np.float32)).cuda()
    return nchw.to(dtype).permute(0, 2, 3, 1)  # the (B, h, w, 3) view the decoder passes


def phase_kernel(card: str, floors: dict) -> None:
    from bts_tpu_torch.ops.lpg_cuda import _k1_cuda, _lib, fused_denominator, lpg_fused, lpg_fused_plain

    rows = []
    for b, h, w, k in SLICE_SHAPES + [RAGGED_SHAPE]:
        raw = _raw(b, h, w, k)
        out = lpg_fused(raw, k)
        ref = lpg_fused_plain(raw, k)
        torch.cuda.synchronize()
        row = {"shape": [b, h, w, 3], "k": k, "out": list(out.shape)}
        row.update(compare_lpg(out, ref, fused_denominator(raw, k)))
        check(row["within_rule"], f"K1 disagrees with plain at {row}")
        row.update(timings(lambda: lpg_fused(raw, k), lambda: lpg_fused_plain(raw, k)))
        row.update(bound(4 * b * h * w * 3 + 4 * b * h * w * k * k, K1_OPS_PER_PIXEL * b * h * w * k * k))
        alone(row, fwd_alone(_lib(), "lpg_fused_forward", raw, k))
        launch_floor(row, "K1", b, h, w, k, floors)
        # the op's CUDA implementation called directly: the wrapper as it was
        # before K1 became a torch.library op, so the dispatcher's share shows
        direct = lambda: _k1_cuda(raw, k)  # noqa: E731
        row["unregistered_call_ms"] = call_median_ms(direct)
        row["unregistered_ms"] = device_median_ms(direct, row["unregistered_call_ms"])
        row["unregistered_wrapper_overhead_ms"] = row["unregistered_ms"] - row["kernel_only_ms"]
        row["dispatcher_call_overhead_ms"] = row["call_ms"] - row["unregistered_call_ms"]
        row["card"] = card
        rows.append(row)
    emit({"phase": "kernel", "rule": f"rtol {RTOL}, atol {ATOL_SCALE}*max|ref|, |den|>={DENOM_MIN}",
          "shapes": rows})


def lpg_rows(b, h, w, k, dtype, backward: bool = True) -> list:
    """K2 (when ``backward``) and K1 at one head shape with ``dtype`` raw:
    each against its plain version by its rule, its times, bound, the kernel
    alone, the wrapper's overhead and the share of the bound; one row each."""
    from bts_tpu_torch.ops.lpg_cuda import (
        _lib, fused_denominator, launch_shape, lpg_fused, lpg_fused_bwd, lpg_fused_bwd_plain, lpg_fused_plain,
    )

    rows = []
    raw = _raw(b, h, w, k, dtype)
    esize = raw.element_size()
    if backward:
        g = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (b, h * k, w * k), dtype=np.float32)).cuda()
        out = lpg_fused_bwd(raw, g, k)
        ref = lpg_fused_bwd_plain(raw, g, k)
        torch.cuda.synchronize()
        check(out.dtype == dtype and out.shape == raw.shape, f"K2 output {out.dtype} {out.shape}")
        check(out.permute(0, 3, 1, 2).is_contiguous(), "K2 output is not NCHW memory")
        # bf16: both round one f32 value, so they may differ by one bf16 step
        rule = compare_grad(out, ref, fused_denominator(raw, k), k,
                            rtol=GRAD_RTOL if dtype == torch.float32 else 2**-7)
        row = {"kernel": "K2", "shape": [b, h, w, 3], "k": k, "raw_dtype": str(dtype)[6:]}
        row.update(rule)
        check(rule["within_rule"], f"K2 disagrees with plain at {row}")
        row.update(timings(lambda: lpg_fused_bwd(raw, g, k), lambda: lpg_fused_bwd_plain(raw, g, k)))
        row.update(bound(4 * b * h * w * k * k + 2 * 3 * esize * b * h * w,
                         K2_OPS_PER_PIXEL * b * h * w * k * k))
        alone(row, k2_alone(_lib(), raw, g, k))
        rows.append(row)

    frow = {"kernel": "K1", "shape": [b, h, w, 3], "k": k, "raw_dtype": str(dtype)[6:]}
    fout = lpg_fused(raw, k)
    frow.update(compare_lpg(fout, lpg_fused_plain(raw, k), fused_denominator(raw, k)))
    check(frow["within_rule"], f"K1 disagrees with plain at {frow}")
    frow.update(timings(lambda: lpg_fused(raw, k), lambda: lpg_fused_plain(raw, k)))
    frow.update(bound(3 * esize * b * h * w + 4 * b * h * w * k * k,
                      K1_OPS_PER_PIXEL * b * h * w * k * k))
    alone(frow, fwd_alone(_lib(), "lpg_fused_forward", raw, k))
    frow["launch"] = launch_shape("K1", b, h, w, k)
    rows.append(frow)
    return rows


def add_to_step(total: dict, row: dict) -> None:
    """Add a head's row to its kernel's per-step sums in ``total``."""
    t = total.setdefault(row["kernel"], {}).setdefault(row["raw_dtype"], dict.fromkeys(
        ("ms", "kernel_only_ms", "plain_ms", "bound_ms", "max_abs_err"), 0.0))
    for key in ("ms", "kernel_only_ms", "plain_ms", "bound_ms"):
        t[key] += row[key]
    t["max_abs_err"] = max(t["max_abs_err"], row["max_abs_err"])
    t["bound_by"] = row["bound_by"]
    t["wrapper_overhead_ms"] = t["ms"] - t["kernel_only_ms"]
    t["share_of_bound"] = t["bound_ms"] / t["kernel_only_ms"]


def phase_kernel_bwd(card: str) -> dict:
    """K2 (and K1) at the training step's head shapes, each head's row with
    the kernel alone, the wrapper's overhead and the share of the bound; the
    device kernels one bf16 call of each wrapper launches.  Returns the
    per-step sums for the result line."""
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.utils.profiling import launched_kernels

    rows, total = [], {}
    for b, h, w, k in TRAIN_SHAPES + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            head = lpg_rows(b, h, w, k, dtype)
            rows += head
            if (b, h, w, k) in TRAIN_SHAPES:
                for row in head:
                    add_to_step(total, row)
    for row in rows:
        row["card"] = card
    # bf16 raw: each wrapper launches its kernel and nothing else (no cast)
    b, h, w, k = TRAIN_SHAPES[0]
    raw = _raw(b, h, w, k, torch.bfloat16)
    g = torch.ones((b, h * k, w * k), device="cuda")
    profs = {"K1": launched_kernels(lambda: lpg_fused(raw, k)),
             "K2": launched_kernels(lambda: lpg_fused_bwd(raw, g, k))}
    launched = {key: prof["kernels"] for key, prof in profs.items()}
    emit({"phase": "kernel_bwd",
          "rule": f"K2: rtol {GRAD_RTOL} (bf16: 2^-7), atol {GRAD_ATOL_SCALE}*max|ref| on cells "
                  f"with every |den|>={DENOM_MIN}; K1: rtol {RTOL}, atol {ATOL_SCALE}*max|ref|",
          "shapes": rows, "per_training_step": total, "device_kernels_per_bf16_call": launched,
          "profiler_windows": {key: prof["windows"] for key, prof in profs.items()}})
    for key, kernel in (("K1", "lpg_fwd_kernel"), ("K2", "lpg_bwd_kernel")):
        check(len(launched[key]) == 1 and kernel in launched[key][0],
              f"{key}'s wrapper on bf16 raw launched {launched[key]}")
    return total


def phase_kernel_nyu(card: str) -> None:
    """K1 and K2 at the config-3 heads (NYU 416x544, b4) and K1 at the heads
    of a NYU online eval (480x640, b4), f32 and bf16 raw, the rows of
    kernel_bwd, and the per-step sums of config 3."""
    rows, total = [], {}
    for shapes, backward in ((NYU_TRAIN_SHAPES, True), (NYU_EVAL_SHAPES, False)):
        for b, h, w, k in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                head = lpg_rows(b, h, w, k, dtype, backward)
                for row in head:
                    row.update(card=card, path="train_nyu" if backward else "eval")
                rows += head
                if backward:
                    for row in head:
                        add_to_step(total, row)
    emit({"phase": "kernel_nyu",
          "rule": f"K2: rtol {GRAD_RTOL} (bf16: 2^-7), atol {GRAD_ATOL_SCALE}*max|ref| on cells "
                  f"with every |den|>={DENOM_MIN}; K1: rtol {RTOL}, atol {ATOL_SCALE}*max|ref|",
          "shapes": rows, "per_config3_step": total})


def plane_denominator(plane, k):
    """n1*u + n2*v + n3 of the LPG of ``plane`` (B, h, w, 4), at full resolution."""
    from bts_tpu_torch.ops.lpg_cuda import _patch_coords

    b, h, w, _ = plane.shape
    p = plane.float()
    off = _patch_coords(k, plane.device)
    den = (p[..., 0][:, :, None, :, None] * off.view(1, 1, 1, 1, k)
           + p[..., 1][:, :, None, :, None] * off.view(1, 1, k, 1, 1) + p[..., 2][:, :, None, :, None])
    return den.reshape(b, h * k, w * k)


def _plane(b, h, w, k, dtype=torch.float32):
    from bts_tpu_torch.ops.lpg import plane_from_spherical

    return plane_from_spherical(_raw(b, h, w, k), MAX_DEPTH).to(dtype)


def _add(total: dict, row: dict) -> None:
    for key in ("ms", "plain_ms", "bound_ms"):
        if key in row:
            total[key] = total.get(key, 0.0) + row[key]
    total["bound_by"] = row["bound_by"]


def phase_kernel_lpg(card: str, floors: dict):
    """K3 and K4, the public LPG op's kernels: each against its plain
    version (K3 also alone, with its launch and floor), then the op path
    (forward and backward through local_planar_guidance at the three
    serving heads) with its launches."""
    from bts_tpu_torch.ops.lpg import local_planar_guidance
    from bts_tpu_torch.ops.lpg_cuda import (
        _lib, lpg_plane, lpg_plane_bwd, lpg_plane_bwd_plain, lpg_plane_fwd, lpg_plane_plain,
    )

    rows, total = [], {"K3": {"max_abs_err": 0.0, "kernel_only_ms": 0.0, "floor_ms": 0.0},
                       "K4": {"max_abs_err": 0.0}}
    for b, h, w, k in SLICE_SHAPES + [RAGGED_SHAPE]:
        plane = _plane(b, h, w, k)
        out, ref = lpg_plane_fwd(plane, k), lpg_plane_plain(plane, k)
        torch.cuda.synchronize()
        row = {"kernel": "K3", "shape": [b, h, w, 4], "k": k, "card": card}
        row.update(compare_lpg(out, ref, plane_denominator(plane, k)))
        check(row["within_rule"], f"K3 disagrees with plain at {row}")
        row.update(timings(lambda: lpg_plane_fwd(plane, k), lambda: lpg_plane_plain(plane, k)))
        row.update(bound(16 * b * h * w + 4 * b * h * w * k * k, K1_OPS_PER_PIXEL * b * h * w * k * k))
        alone(row, fwd_alone(_lib(), "lpg_forward", plane, k))
        launch_floor(row, "K3", b, h, w, k, floors)
        rows.append(row)
        if (b, h, w, k) in SLICE_SHAPES:
            _add(total["K3"], row)
            total["K3"]["max_abs_err"] = max(total["K3"]["max_abs_err"], row["max_abs_err"])
            total["K3"]["kernel_only_ms"] += row["kernel_only_ms"]
            total["K3"]["floor_ms"] += row["floor_ms"]
    for b, h, w, k in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            plane = _plane(b, h, w, k, dtype)
            g = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (b, h * k, w * k), dtype=np.float32)).cuda()
            out, ref = lpg_plane_bwd(plane, g, k), lpg_plane_bwd_plain(plane, g, k)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == plane.shape, f"K4 output {out.dtype} {out.shape}")
            row = {"kernel": "K4", "shape": [b, h, w, 4], "k": k, "plane_dtype": str(dtype)[6:], "card": card}
            row.update(compare_grad(out, ref, plane_denominator(plane, k), k,
                                    rtol=GRAD_RTOL if dtype == torch.float32 else 2**-7))
            check(row["within_rule"], f"K4 disagrees with plain at {row}")
            row.update(timings(lambda: lpg_plane_bwd(plane, g, k), lambda: lpg_plane_bwd_plain(plane, g, k)))
            row.update(bound(4 * b * h * w * k * k + 4 * plane.element_size() * b * h * w,
                             K2_OPS_PER_PIXEL * b * h * w * k * k))
            rows.append(row)
            if dtype == torch.bfloat16:
                _add(total["K4"], row)
            else:
                total["K4"]["max_abs_err"] = max(total["K4"]["max_abs_err"], row["max_abs_err"])

    # the op path: every count to 0, the public op forward and backward
    lpg_plane.launches, lpg_plane_bwd.launches = 0, 0
    for b, h, w, k in SLICE_SHAPES:
        plane = _plane(b, h, w, k).requires_grad_()
        out = local_planar_guidance(plane, k)
        g = torch.randn_like(out)
        (out * g).sum().backward()
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(plane.grad).all()), "op path not finite")
    torch.cuda.synchronize()
    launches = {"lpg_plane": lpg_plane.launches, "lpg_plane_bwd": lpg_plane_bwd.launches}
    check(launches == {"lpg_plane": 3, "lpg_plane_bwd": 3}, f"op path launches {launches}")
    total["K3"]["share_of_bound"] = total["K3"]["bound_ms"] / total["K3"]["kernel_only_ms"]
    emit({"phase": "kernel_lpg",
          "rule": f"K3: rtol {RTOL}, atol {ATOL_SCALE}*max|ref|, |den|>={DENOM_MIN}; K4: rtol {GRAD_RTOL} "
                  f"(bf16: 2^-7), atol {GRAD_ATOL_SCALE}*max|ref| on cells with every |den|>={DENOM_MIN}",
          "shapes": rows, "op_path_launches": launches, "per_op": total})
    return total, launches


def _tail_inputs(b, hh, w2, seed=0):
    """Seeded K6 inputs at (B, Hh, W2): iconv2 as the decoder's NCHW view,
    the three maps from K5, and random tail weights (the CPU tests' scale)."""
    from bts_tpu_torch.ops import tail_cuda

    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return (torch.randn(*shape, generator=g) * 0.3).cuda()

    shapes = {"up": (3, 3, 64, 32), "r1": (1, 1, 32, 16), "r2": (1, 1, 16, 8),
              "r3": (1, 1, 8, 1), "i1": (3, 3, 36, 32), "f": (3, 3, 32, 1)}
    params = {n: {"kernel": t(*sh), "bias": t(sh[-1])} for n, sh in shapes.items()}
    iconv2 = t(b, 64, hh, w2).to(torch.bfloat16).permute(0, 2, 3, 1)
    maps = [tail_cuda.lpg_phase_planes_plain(_raw(b, 2 * hh // k, 2 * w2 // k, k), k) for k in (2, 4, 8)]
    return iconv2, maps, params


def tail_gap(out, ref) -> dict:
    e = (out - ref).abs()
    return {"max_abs_err": e.max().item(), "mean_abs_err": e.mean().item(),
            "pixels_above_1e-4": int((e > 1e-4).sum()), "pixels": e.numel(),
            "within_rule": bool(torch.isfinite(out).all()) and e.mean().item() <= TAIL_MEAN
            and e.max().item() <= TAIL_MAX and (e > 1e-4).float().mean().item() <= TAIL_OFF_SHARE}


def final_rule(out, ref) -> dict:
    """The f32 final depth through the kernels against the same forward
    through their plain versions: 1e-5 relative (phase slice's f32 rule)."""
    e = (out - ref).abs()
    return {"max_abs_err": e.max().item(), "max_rel_err": (e / ref.abs()).max().item(), "rtol": 1e-5,
            "within_rule": bool(torch.isfinite(out).all()) and bool(torch.allclose(out, ref, rtol=1e-5, atol=0.0))}


def stage_cycles(lib_path, iconv2, maps, params, b, hh, w2) -> dict:
    """K6's stage times in SM cycles, the median over its blocks, from the
    profiling build (-DK6_STAGE_CLOCKS: clock64() at the start and after each
    stage, thread 0 of each block)."""
    from bts_tpu_torch.ops import tail_cuda

    lib = tail_cuda.bind(ctypes.CDLL(str(lib_path)))
    lib.fused_tail_stage_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    prm = tail_cuda.pack_tail_params(params)
    small = tail_cuda.host_floats(prm)
    fo = torch.empty((b, 4, hh, w2), device="cuda")
    do = torch.empty_like(fo)
    for _ in range(3):
        check(lib.fused_tail_forward(iconv2.data_ptr(), 0, *iconv2.stride(), *(m.data_ptr() for m in maps),
                                     prm.data_ptr(), small.data_ptr(), fo.data_ptr(), do.data_ptr(), b, hh, w2,
                                     torch.cuda.current_stream().cuda_stream) == 0, "K6 profiling launch")
    torch.cuda.synchronize()
    blocks = b * -(-hh // K6_TILE[0]) * -(-w2 // K6_TILE[1])
    stamps = np.zeros((blocks, 6), np.int64)
    check(lib.fused_tail_stage_clocks(stamps.ctypes.data, stamps.size) == 0, "K6 stage clocks")
    d = np.diff(stamps, axis=1)
    out = {name: float(np.median(d[:, i]))
           for i, name in enumerate(("staging", "upconv", "reduction_chain", "iconv1", "final_conv"))}
    out["block"] = float(np.median(stamps[:, -1] - stamps[:, 0]))
    return out


def phase_tail(card: str, clocks_lib, floors: dict) -> dict:
    """K5 against its plain version and bit-equal to K1 interleaved, with
    f32 and bf16 raw, at the serving and b4 export heads, alone with its
    launch and floor; K6 against its plain version; times and bounds of
    each call; K6's stage cycles from its profiling build ``clocks_lib``."""
    from bts_tpu_torch.models.bts import set_float32_precision
    from bts_tpu_torch.ops import tail_cuda
    from bts_tpu_torch.ops.lpg_cuda import _lib, lpg_fused
    from bts_tpu_torch.utils.profiling import launched_kernels

    set_float32_precision()  # the plain tail's f32 convs without TF32
    rows, total = [], {"K6": {}}
    # K5 per forward: "K5" the serving heads with f32 raw (the result line's),
    # then bf16 raw (what a bf16 decoder passes) and the b4 export heads
    for shapes, key in ((SLICE_SHAPES, "K5"), (EXPORT_SHAPES, "K5 b4 export")):
        for b, h, w, k in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                raw = _raw(b, h, w, k, dtype)
                ph, plain = tail_cuda.lpg_phase_planes(raw, k), tail_cuda.lpg_phase_planes_plain(raw, k)
                full = lpg_fused(raw, k)
                torch.cuda.synchronize()
                row = {"kernel": "K5", "shape": [b, h, w, 3], "k": k, "raw_dtype": str(dtype)[6:],
                       "out": list(ph.shape), "card": card,
                       "equal_to_plain": torch.equal(ph, plain),
                       "equal_to_k1_interleaved": torch.equal(tail_cuda.interleave2x2(ph), full),
                       "equal_to_f32_copy": torch.equal(ph, tail_cuda.lpg_phase_planes(raw.float(), k)),
                       "max_abs_err": (ph - plain).abs().max().item()}
                check(row["equal_to_plain"] and row["equal_to_k1_interleaved"] and row["equal_to_f32_copy"],
                      f"K5 not bit-equal at {row}")
                # the plain version timed at the result line's heads only
                plain = key == "K5" and dtype == torch.float32
                row.update(timings(lambda: tail_cuda.lpg_phase_planes(raw, k),
                                   (lambda: tail_cuda.lpg_phase_planes_plain(raw, k)) if plain else None))
                row.update(bound(3 * raw.element_size() * b * h * w + 4 * b * h * w * k * k,
                                 K1_OPS_PER_PIXEL * b * h * w * k * k))
                alone(row, fwd_alone(_lib(), "lpg_phase_forward", raw, k, tuple(ph.shape)))
                launch_floor(row, "K5", b, h, w, k, floors)
                rows.append(row)
                t = total.setdefault(key if dtype == torch.float32 else f"{key} bf16",
                                     {"max_abs_err": 0.0, "kernel_only_ms": 0.0, "floor_ms": 0.0})
                _add(t, row)
                t["max_abs_err"] = max(t["max_abs_err"], row["max_abs_err"])
                t["kernel_only_ms"] += row["kernel_only_ms"]
                t["floor_ms"] += row["floor_ms"]
                t["share_of_bound"] = t["bound_ms"] / t["kernel_only_ms"]
    # bf16 raw: the wrapper launches K5 and nothing else (no cast)
    b, h, w, k = SLICE_SHAPES[0]
    raw = _raw(b, h, w, k, torch.bfloat16)
    k5_prof = launched_kernels(lambda: tail_cuda.lpg_phase_planes(raw, k))
    k5_kernels = k5_prof["kernels"]
    check(len(k5_kernels) == 1 and "lpg_phase_kernel" in k5_kernels[0],
          f"K5's wrapper on bf16 raw launched {k5_kernels}")
    for b, hh, w2 in TAIL_SHAPES:
        iconv2, maps, params = _tail_inputs(b, hh, w2)
        fin, d1 = tail_cuda.fused_tail(iconv2, *maps, params)
        rfin, rd1 = tail_cuda.fused_tail_plain(iconv2, *maps, params)
        torch.cuda.synchronize()
        row = {"kernel": "K6", "shape": [b, hh, w2, 64], "card": card,
               "final": tail_gap(fin, rfin), "d1x1": tail_gap(d1, rd1)}
        check(row["final"]["within_rule"] and row["d1x1"]["within_rule"], f"K6 disagrees with plain at {row}")
        row["max_abs_err"] = max(row["final"]["max_abs_err"], row["d1x1"]["max_abs_err"])
        row.update(timings(lambda: tail_cuda.fused_tail(iconv2, *maps, params),
                           lambda: tail_cuda.fused_tail_plain(iconv2, *maps, params)))
        # the kernel alone, on the same iconv2 view and weights packed beforehand
        prm, fo, do = tail_cuda.pack_tail_params(params), torch.empty_like(fin), torch.empty_like(d1)
        small = tail_cuda.host_floats(prm)
        lib, stream = tail_cuda._lib(), torch.cuda.current_stream().cuda_stream

        def kernel_only():
            err = lib.fused_tail_forward(iconv2.data_ptr(), 0, *iconv2.stride(), *(m.data_ptr() for m in maps),
                                         prm.data_ptr(), small.data_ptr(), fo.data_ptr(), do.data_ptr(),
                                         b, hh, w2, stream)
            check(err == 0, f"K6 launch error {err}")

        row["kernel_only_ms"] = device_median_ms(kernel_only, call_median_ms(kernel_only))
        torch.cuda.synchronize()
        check(torch.equal(fo, fin) and torch.equal(do, d1), "K6 alone differs from the wrapper")
        pixels = 4 * b * hh * w2
        row.update(bound(2 * b * hh * w2 * 64 + 3 * 4 * pixels + 2 * 4 * pixels,
                         K6_FLOPS_PER_PIXEL * pixels, BF16_OPS_PER_S))
        row["cuda_core_f32_floor_ms"] = K6_FLOPS_PER_PIXEL * pixels / F32_OPS_PER_S * 1e3
        row["wrapper_overhead_ms"] = row["ms"] - row["kernel_only_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["kernel_only_ms"]
        rows.append(row)
        if (b, hh, w2) == TAIL_SHAPES[0]:
            total["K6"] = {key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            emit({"phase": "tail_k6", "shape": [b, hh, w2, 64], "card": card,
                  **{key: row[key] for key in ("kernel_only_ms", "ms", "wrapper_overhead_ms", "bound_ms",
                                               "cuda_core_f32_floor_ms", "share_of_bound")},
                  "stage_cycles_median": stage_cycles(clocks_lib, iconv2, maps, params, b, hh, w2)})
    emit({"phase": "tail", "rule": f"K5: bit-equal to its plain version, to K1 interleaved and (bf16 raw) to "
          f"itself on the f32 copy; K6: mean abs <= {TAIL_MEAN}, max abs <= {TAIL_MAX}, share above 1e-4 <= "
          f"{TAIL_OFF_SHARE}", "shapes": rows, "per_forward": total,
          "device_kernels_per_bf16_k5_call": k5_kernels, "profiler_windows": k5_prof["windows"]})
    return total


def set_upconv(model, form: str) -> None:
    """Every UpConv of ``model`` in ``form`` (the same weights in each):
    "fused" (the default; in f32 its forward one phase conv), "literal",
    or "fused_default" (fused, the forward on cuDNN's transposed-conv
    algorithm in f32 too)."""
    from bts_tpu_torch.models.layers import UpConv

    for m in model.modules():
        if isinstance(m, UpConv):
            m.fused = form != "literal"
            m.deterministic = form == "fused" and m.conv.dtype == torch.float32


DENSENET161_BTS_BNS = 175  # BatchNorms of a DenseNet-161 BTS forward: 161 encoder, 9 dense ASPP, 5 decoder
# and of an EfficientNet-B5 BTS forward: 116 encoder (76 before a SiLU), 9 dense ASPP, 5 decoder
BTS_BNS = {"densenet161_bts": DENSENET161_BTS_BNS, "efficientnet_b5_bts": 130}
BN_BATCHES = {"densenet161_bts": (1, 8), "efficientnet_b5_bts": (1, 16)}  # phase_bn's batches: the serving cells'
K7_PATHS: dict = {}  # K7's launches on each main path of the result (k7_counted)


class K7Run:
    """K7's launches over one main-path run (``launches``), the BatchNorm
    calls in it that take K7 (``calls``), and ``expect``, which a caller sets
    where the run calls an exported program: its graph calls no module."""

    def __init__(self):
        self.launches, self.calls, self.expect = 0, 0, None


@contextlib.contextmanager
def k7_counted(path: str | None = None, expect: int | None = None):
    """Counts K7's launches over one main-path run from 0 just before it,
    and checks them: one for each BatchNorm call that takes K7 (eval mode,
    no grad, an NCHW-contiguous f32 or bf16 CUDA x of K7's size), counted
    around BatchNorm.forward, or ``expect`` (``run.expect``) where given, as
    0 for the timed train steps, which are not slowed by the count.  Adds the
    launches to K7_PATHS[path]."""
    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.ops import bn_cuda

    run, forward = K7Run(), BatchNorm.forward
    run.expect = expect

    def counted(module, x, act="none"):
        if (not (module.training or torch.is_grad_enabled()) and x.is_cuda and x.dtype in bn_cuda.DTYPES
                and x.is_contiguous() and bn_cuda.fits(x)):
            run.calls += 1
        return forward(module, x, act)

    if expect is None:
        BatchNorm.forward = counted
    bn_cuda.bn_act.launches = 0
    try:
        yield run
    finally:
        BatchNorm.forward = forward
    run.launches = bn_cuda.bn_act.launches
    want = run.calls if run.expect is None else run.expect
    check(run.launches == want, f"{path}: {run.launches} K7 launches, not {want}")
    if path is not None:
        K7_PATHS[path] = K7_PATHS.get(path, 0) + run.launches


def bn_calls(encoder: str) -> list:
    """(per-image shape, activation, eps) of each BatchNorm call of a BTS
    bf16 serving forward of ``encoder`` at 352x1216, in order (forward
    pre-hooks), after checking that the forward launched K7 once per
    BatchNorm and that the model holds BTS_BNS[encoder] of them."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.ops import bn_cuda

    cfg = Config(mode="test", encoder=encoder, bts_size=512, max_depth=MAX_DEPTH, dataset="kitti",
                 input_height=H, input_width=W, compute_dtype="bfloat16", seed=0)
    model = create_model(cfg, "cuda")
    calls = []

    def hook(module, args, kwargs):
        calls.append((tuple(args[0].shape[1:]), kwargs.get("act", "none"), module.eps))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, BatchNorm)]
    before = bn_cuda.bn_act.launches
    with torch.inference_mode():
        model(torch.rand(1, 3, H, W, device="cuda"), torch.tensor([FOCAL], device="cuda"))
    torch.cuda.synchronize()
    launched = bn_cuda.bn_act.launches - before
    for handle in handles:
        handle.remove()
    check(launched == len(calls) == len(handles) == BTS_BNS[encoder],
          f"K7, {encoder}: {launched} launches for {len(calls)} BatchNorm calls of {len(handles)} modules")
    return calls


def host_us_per_call(fn, n: int = 400) -> float:
    """Host microseconds to issue one call of ``fn`` (its enqueue): ``n``
    calls on a tensor small enough that the card keeps up with the host,
    timed before the synchronise."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def kernels_ms(fn, expect: int, windows: int = 3) -> dict:
    """The summed device ms of the kernels one call of ``fn`` launches
    (torch.profiler, linked by correlation id to the window's ops), the
    median over ``windows`` windows that each hold all ``expect`` of its
    launches.  Late in a long process a window drops the records of the
    first launch in it, op and kernel, every time (PERF.md): a sleep kernel
    launched first takes that place and is not counted.  A window with
    another count is dropped and counted; under ``windows`` whole ones in
    ``windows`` + 3 tries fail.  A sum of durations leaves out the card's
    idle gaps, which the host sets."""
    from bts_tpu_torch.utils.profiling import window

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    fn()
    sums, counts = [], []
    for _ in range(windows + 3):
        with window() as prof:
            torch.cuda._sleep(1)
            fn()
        records = prof.profiler.kineto_results.events()
        ops = {r.correlation_id() for r in records if r.device_type() == cpu and r.linked_correlation_id() == 0}
        ops.discard(0)
        kernels = [r.duration_ns() for r in records if r.device_type() == cuda and not r.is_user_annotation()
                   and r.linked_correlation_id() in ops and not r.name().startswith(("Memcpy", "Memset"))
                   and "spin_kernel" not in r.name()]
        counts.append(len(kernels))
        if len(kernels) == expect:
            sums.append(sum(kernels) * 1e-6)
            if len(sums) == windows:
                break
    check(len(sums) == windows, f"{len(sums)} of {len(counts)} profiler windows held all {expect} launches: {counts}")
    return {"ms": statistics.median(sums), "launches": expect, "windows_dropped": len(counts) - windows}


def phase_bn(card: str) -> dict:
    """K7 on the BatchNorm calls of a 352x1216 serving forward of each
    encoder of BN_BATCHES at its batches (DenseNet-161 b1 and b8, ReLU;
    EfficientNet-B5 b1 and b16, SiLU and eps 1e-3): equal to the chain at
    each call; the summed device ms and launches of all of them (K7, the
    plain chain, F.batch_norm + its F.relu or F.silu as a yardstick)
    against their byte bound, K7 also by plane size; the host's cost of one
    call of each route.  Returns {encoder: {"b<n>": record}} and
    "host_per_call"."""
    import torch.nn.functional as F

    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.ops import bn_cuda

    g = torch.Generator(device="cuda").manual_seed(0)

    def params(c):
        return (torch.randn(c, generator=g, device="cuda") * 0.5, torch.rand(c, generator=g, device="cuda") + 0.1,
                1 + 0.2 * torch.randn(c, generator=g, device="cuda"), 0.2 * torch.randn(c, generator=g, device="cuda"))

    library_act = {"none": lambda y: y, "relu": F.relu, "silu": F.silu}
    routes = {
        "kernel": lambda x, p, a, e: bn_cuda.bn_act(x, *p, e, a),  # the op, as BatchNorm calls it
        "launch": lambda x, p, a, e: bn_cuda._k7_cuda(x, *p, e, a),  # its CUDA implementation alone
        "plain": lambda x, p, a, e: bn_cuda.bn_act_plain(x, *p, e, a),
        "library": lambda x, p, a, e: library_act[a](F.batch_norm(x, p[0], p[1], p[2], p[3], False, 0.0, e)),
    }
    out = {}
    for encoder, batches in BN_BATCHES.items():
        calls = bn_calls(encoder)
        ps = [params(shape[0]) for shape, _, _ in calls]
        acts = [act for _, act, _ in calls]
        eps = [e for _, _, e in calls]
        acted = sum(act != "none" for act in acts)
        counts = {"calls": len(calls), "relu": acts.count("relu"), "silu": acts.count("silu")}
        out[encoder] = dict(counts)
        if encoder == "densenet161_bts":
            norm5 = calls[160], ps[160]
        # the launches of one pass over all the calls: K7 one a call; the
        # chain eight and its F.relu or F.silu; F.batch_norm two (cuDNN)
        # and its F.relu or F.silu
        expect = {"kernel": len(calls), "plain": 8 * len(calls) + acted, "library": 2 * len(calls) + acted}
        for b in batches:
            xs = [(torch.randn((b,) + shape, generator=g, device="cuda") * 2 + 0.5).to(torch.bfloat16)
                  for shape, _, _ in calls]
            args = list(zip(xs, ps, acts, eps))
            with torch.inference_mode():
                differ = sum(int((routes["launch"](*arg) != routes["plain"](*arg)).sum()) for arg in args)
                check(differ == 0, f"K7, {encoder} at b{b}: {differ} elements differ from the chain")
                elements = sum(x.numel() for x in xs)
                rec = {"phase": "bn", "card": card, "encoder": encoder, "batch": b,
                       "per": "all BatchNorm calls of one forward", **counts,
                       "elements_per_image": elements // b, "elements_differing": differ,
                       **bound(4 * elements, 4 * elements)}
                for name in ("kernel", "plain", "library"):
                    got = kernels_ms(lambda route=routes[name]: [route(*arg) for arg in args], expect[name])
                    rec[f"{name}_ms"], rec[f"{name}_launches"] = got["ms"], got["launches"]
                    rec[f"{name}_windows_dropped"] = got["windows_dropped"]
                rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
                by_plane = {}
                for arg in args:
                    by_plane.setdefault(arg[0].shape[2] * arg[0].shape[3], []).append(arg)
                rec["by_plane"] = {}
                for hw, group in sorted(by_plane.items(), reverse=True):
                    n = sum(arg[0].numel() for arg in group)
                    got = kernels_ms(lambda group=group: [routes["kernel"](*arg) for arg in group], len(group))
                    row = {"calls": len(group), "elements": n, **bound(4 * n, 4 * n), "kernel_ms": got["ms"],
                           "windows_dropped": got["windows_dropped"]}
                    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                    rec["by_plane"][hw] = row
            emit(rec)
            out[encoder][f"b{b}"] = rec
            del xs, args
            torch.cuda.empty_cache()
    # the host's cost of one call, on DenseNet-161's norm5 input (b1, 2208
    # x 11 x 38): the module, the op, the launch alone (the op less its
    # dispatch), the chain with its ReLU and F.batch_norm with F.relu
    (shape, _, eps), p = norm5
    x = torch.randn((1,) + shape, generator=g, device="cuda").to(torch.bfloat16)
    bn = BatchNorm(shape[0], eps=eps).to("cuda").eval()
    with torch.inference_mode():
        host = {"module_us": host_us_per_call(lambda: bn(x, act="relu")),
                **{f"{name}_us": host_us_per_call(lambda route=route: route(x, p, "relu", eps))
                   for name, route in routes.items()}}
    out["host_per_call"] = host
    emit({"phase": "bn_host", "card": card, "shape": [1, *shape], **host})
    return out


def phase_upconv(card: str) -> None:
    """The five UpConvs of DenseNet-161 BTS at the b1 352x1216 serving
    shapes and the b16 352x704 config-4 shapes, f32 and bf16: the fused form
    (one stride-2 transposed conv, the default) against the literal one
    (upsample, then the 3x3 conv) on the same weights, input and cotangent:
    the forward gap and each gradient's gap under UPCONV_FWD_RULE and
    UPCONV_GRAD_RULE; device ms of each form's forward and backward (the
    backward alone, the graph retained), UPCONV_TURNS batches of each in
    turns; the peak memory of a forward and backward above its inputs; the
    MACs of each form (9 per output pixel and input channel, or 4); how far
    a second forward and a second backward of each form on the same input
    land from the first.  The fused form must repeat its forward bit for
    bit (in f32 one phase conv, UpConv.deterministic); in f32 the fused
    form on cuDNN's transposed-conv algorithm ("fused_default", whose sums
    vary between calls) is timed beside it, the cost of that choice.
    Backwards are recorded, not held to repeat: every conv's backward
    takes cuDNN's default algorithms."""
    from bts_tpu_torch.models.bts import init_weights, set_float32_precision
    from bts_tpu_torch.models.layers import UpConv

    set_float32_precision()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for serving, (b, h, w) in (("serving b1", (1, H, W)), ("config 4 b16", (TRAIN_B, TRAIN_H, TRAIN_W))):
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for i, (cin, cout) in enumerate(UPCONV_CHANNELS):
                shape = (b, cin, h >> (5 - i), w >> (5 - i))
                forms = {"fused": UpConv(cin, cout, dtype, fused=True)}
                init_weights(forms["fused"], torch.Generator().manual_seed(i))
                with torch.no_grad():
                    forms["fused"].conv.bias.normal_(0, 0.05, generator=torch.Generator().manual_seed(i))
                forms["fused"].cuda()
                forms["literal"] = UpConv(cin, cout, dtype, fused=False).cuda()
                if dt == "float32":
                    forms["fused_default"] = UpConv(cin, cout, dtype, fused=True).cuda()
                    forms["fused_default"].deterministic = False
                for m in list(forms.values())[1:]:
                    m.load_state_dict(forms["fused"].state_dict())
                x = torch.randn(shape, device="cuda", generator=gen).to(dtype).requires_grad_()
                out_shape = (b, cout, 2 * shape[2], 2 * shape[3])
                cot = torch.randn(out_shape, device="cuda", generator=gen).to(dtype)
                rec = {"phase": "upconv", "card": card, "shapes": serving, "upconv": 5 - i, "compute_dtype": dt,
                       "input": list(shape), "output": list(out_shape)}
                outs, grads, fwd, bwd = {}, {}, {}, {}
                for name, m in forms.items():
                    params = (x, m.conv.weight, m.conv.bias)
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    y = m(x)
                    grads[name] = torch.autograd.grad(y, params, cot, retain_graph=True)
                    torch.cuda.synchronize()
                    rec[f"{name}_peak_mib_above_inputs"] = (torch.cuda.max_memory_allocated() - base) / 2**20
                    outs[name] = y.detach()
                    fwd[name] = lambda m=m: m(x)
                    bwd[name] = lambda y=y, params=params: torch.autograd.grad(y, params, cot, retain_graph=True)
                with torch.no_grad():  # two calls of one form on one input: equal where cuDNN's sums are
                    rec["repeat_max_abs_diff"] = {name: (m(x) - outs[name]).abs().max().item()
                                                  for name, m in forms.items()}
                rec["repeat_grad_max_abs_diff"] = {
                    name: max((a - b).abs().max().item() for a, b in zip(bwd[name](), grads[name]))
                    for name in forms}
                scale = outs["literal"].abs().max().item()
                rec["fwd_gap"] = (outs["fused"] - outs["literal"]).abs().max().item() / scale
                rec["grad_gaps"] = {n: ((f.float() - g.float()).norm() / g.float().norm()).item()
                                    for n, f, g in zip(("x", "weight", "bias"), grads["fused"], grads["literal"])}
                rec["rule"] = {"fwd": UPCONV_FWD_RULE[dt], "grad": UPCONV_GRAD_RULE[dt]}
                pixels = b * out_shape[1] * out_shape[2] * out_shape[3]
                rec["gmac"] = {"fused": pixels * cin * 4 / 1e9, "literal": pixels * cin * 9 / 1e9}
                times = {(name, part): [] for name in forms for part in ("fwd", "bwd")}
                calls = {}
                for (name, part) in times:
                    fn = (fwd if part == "fwd" else bwd)[name]
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    host_ms = (time.perf_counter() - t0) * 1e3  # an upper bound of the enqueueing
                    torch.cuda.synchronize()
                    one = _batch_ms(fn, 1, host_ms)
                    calls[(name, part)] = (max(1, min(20, int(4.0 / max(one, 1e-3)))), host_ms)
                for turn in range(UPCONV_TURNS):
                    for name in list(forms) if turn % 2 == 0 else list(forms)[::-1]:
                        for part in ("fwd", "bwd"):
                            n, host_ms = calls[(name, part)]
                            times[(name, part)].append(
                                _batch_ms((fwd if part == "fwd" else bwd)[name], n, host_ms))
                for (name, part), t in times.items():
                    rec[f"{name}_{part}_ms"] = statistics.median(t)
                    rec[f"{name}_{part}_ms_range"] = [min(t), max(t)]
                for part in ("fwd", "bwd"):
                    rec[f"{part}_fused_over_literal"] = rec[f"fused_{part}_ms"] / rec[f"literal_{part}_ms"]
                    if "fused_default" in forms:
                        rec[f"{part}_fused_over_fused_default"] = (rec[f"fused_{part}_ms"]
                                                                    / rec[f"fused_default_{part}_ms"])
                emit(rec)
                check(rec["repeat_max_abs_diff"]["fused"] == 0.0, f"upconv fused forward does not repeat {rec}")
                check(rec["fwd_gap"] <= UPCONV_FWD_RULE[dt], f"upconv fused vs literal forward {rec}")
                check(all(g <= UPCONV_GRAD_RULE[dt] for g in rec["grad_gaps"].values()),
                      f"upconv fused vs literal gradients {rec}")
                del forms, outs, grads, fwd, bwd, x, cot
    torch.cuda.empty_cache()


def upconv_ab(model, run, n: int, forms=("fused", "literal")) -> dict:
    """``run`` (one synchronised forward or step of ``model``) with every
    UpConv in each of ``forms`` (see set_upconv): each form's peak memory
    (after one warm-up), then ``n`` runs of each in turns, the order
    reversed every other turn: ms median, q1, q3.  Leaves the model
    fused."""
    rec, times = {}, {form: [] for form in forms}
    for form in times:
        set_upconv(model, form)
        run()
        torch.cuda.reset_peak_memory_stats()
        run()
        rec[f"{form}_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for i in range(n):
        for form in forms if i % 2 == 0 else forms[::-1]:
            set_upconv(model, form)
            t0 = time.perf_counter()
            run()
            times[form].append((time.perf_counter() - t0) * 1e3)
    set_upconv(model, "fused")
    for form, t in times.items():
        q = statistics.quantiles(t, n=4)
        rec[f"{form}_ms"] = {"median": statistics.median(t), "q1": q[0], "q3": q[2], "n": len(t)}
    return rec


def _forward(cfg, model, batch):
    from bts_tpu_torch.cli.bts_test import predict

    outs = next(predict(cfg, model, [batch], "cuda"))
    torch.cuda.synchronize()
    return outs


def phase_slice(card: str) -> int:
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.ops.lpg_cuda import fused_denominator, lpg_fused
    from bts_tpu_torch.utils.profiling import launched_kernels

    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8),
             "focal": np.array([FOCAL], np.float32)}
    cfgs = {dt: Config(mode="test", encoder="densenet161_bts", bts_size=512, max_depth=MAX_DEPTH,
                       dataset="kitti", input_height=H, input_width=W, compute_dtype=dt, seed=0)
            for dt in ("float32", "bfloat16")}
    models = {dt: create_model(cfg, "cuda") for dt, cfg in cfgs.items()}
    heads = _heads(*models.values())  # raw reduction outputs of the last forward, for the denominators

    # the main path: every count to 0, one forward per compute dtype
    lpg_fused.launches = 0
    outs = {}
    with k7_counted("serve", expect=2 * DENSENET161_BTS_BNS):
        for dt in cfgs:
            before = lpg_fused.launches
            outs[dt] = (_forward(cfgs[dt], models[dt], batch), dict(heads))
            check(lpg_fused.launches - before == 3, f"{dt}: {lpg_fused.launches - before} launches, not 3")
    launches = lpg_fused.launches

    for dt, cfg in cfgs.items():
        model, (kernel_outs, raw_heads) = models[dt], outs[dt]
        rec = {"phase": "slice", "compute_dtype": dt, "card": card,
               "shapes": [list(o.shape) for o in kernel_outs]}
        check(all(tuple(o.shape) == (1, 1, H, W) for o in kernel_outs), f"{dt}: shapes {rec['shapes']}")
        # finite where the denominators are non-zero; depth in (0, max_depth]
        for i, (name, k) in enumerate((("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))):
            den = fused_denominator(raw_heads[name].permute(0, 2, 3, 1), k)
            check(bool(torch.isfinite(kernel_outs[i][:, 0][den != 0]).all()), f"{dt}: LPG {k} not finite")
        check(all(bool(torch.isfinite(o).all()) for o in kernel_outs[3:]), f"{dt}: non-finite depth")
        depth = kernel_outs[4] / (FOCAL / 715.0873)  # before the focal scaling
        rec["final_depth_min_max"] = [depth.min().item(), depth.max().item()]
        check(0 < rec["final_depth_min_max"][0] and rec["final_depth_min_max"][1] <= MAX_DEPTH,
              f"{dt}: depth range {rec['final_depth_min_max']}")

        # the same model through use_pallas="never"
        model.decoder.use_pallas = "never"
        count = lpg_fused.launches
        plain_outs = _forward(cfg, model, batch)
        check(lpg_fused.launches == count, "use_pallas='never' launched the kernel")
        model.decoder.use_pallas = cfg.use_pallas
        lpg_rows = []
        for i, (name, k) in enumerate((("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))):
            den = fused_denominator(raw_heads[name].permute(0, 2, 3, 1), k)
            row = compare_lpg(kernel_outs[i][:, 0], plain_outs[i][:, 0], den)
            check(row["within_rule"], f"{dt}: LPG {k} kernel vs never {row}")
            lpg_rows.append(dict(row, k=k))
        rec["lpg_kernel_vs_never"] = lpg_rows
        a, b = kernel_outs[4], plain_outs[4]
        # f32: 1e-5 relative.  bf16: the f32 LPG maps are cast to bf16 for
        # conv1, whose rounding step is 2^-8 relative, so a last-bit change in
        # a map can move a bf16 input by one step; 1e-2 bounds what follows.
        rtol = 1e-5 if dt == "float32" else 1e-2
        rec["final_vs_never"] = {"max_abs_err": (a - b).abs().max().item(),
                                 "max_rel_err": ((a - b).abs() / b.abs()).max().item(), "rtol": rtol}
        check(bool(torch.allclose(a, b, rtol=rtol, atol=0.0)), f"{dt}: final vs never {rec['final_vs_never']}")

        if dt == "float32":  # the same weights on the CPU, at a small input
            small = {"image": batch["image"][:, :64, :96], "focal": batch["focal"]}
            gpu_small = _forward(cfg, model, small)
            from bts_tpu_torch.cli.bts_test import predict

            cpu_small = next(predict(cfg, model.to("cpu"), [small], "cpu"))
            model.to("cuda")
            worst = 0.0
            for g, c in zip(gpu_small, cpu_small):
                g = g.cpu()
                scale = c.abs().max().item()
                check(bool(torch.allclose(g, c, rtol=2e-4, atol=2e-4 * scale)), "f32 GPU vs CPU at 64x96")
                worst = max(worst, (g - c).abs().max().item() / scale)
            rec["gpu_vs_cpu_64x96_max_err_over_scale"] = worst

        # both paths in turns (kernel, never, never, kernel, ...), so drift
        # in the host's or the card's speed falls on both alike
        setting = {"kernel": cfg.use_pallas, "never": "never"}
        times = {"kernel": [], "never": []}
        for path in setting:
            model.decoder.use_pallas = setting[path]
            for _ in range(3):
                _forward(cfg, model, batch)
            torch.cuda.reset_peak_memory_stats()
            _forward(cfg, model, batch)
            rec[f"{path}_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        count = lpg_fused.launches
        for i in range(TIMED_FORWARDS):
            for path in ("kernel", "never") if i % 2 == 0 else ("never", "kernel"):
                model.decoder.use_pallas = setting[path]
                t0 = time.perf_counter()
                _forward(cfg, model, batch)
                times[path].append((time.perf_counter() - t0) * 1e3)
        model.decoder.use_pallas = cfg.use_pallas
        n = lpg_fused.launches - count
        check(n == 3 * TIMED_FORWARDS, f"{n} launches in {TIMED_FORWARDS} kernel-path forwards")
        for path, t in times.items():
            q = statistics.quantiles(t, n=4)
            rec[f"{path}_ms_per_forward"] = {"median": statistics.median(t), "q1": q[0], "q3": q[2],
                                             "n": len(t)}

        # the literal UpConv form against the fused default: the final depth's
        # gap, each form's device kernels per forward, and forwards in turns
        forms = ("fused", "literal") + (("fused_default",) if dt == "float32" else ())
        up = upconv_ab(model, lambda: _forward(cfg, model, batch), UPCONV_FORWARDS, forms)
        set_upconv(model, "literal")
        literal = _forward(cfg, model, batch)
        for form in ("literal", "fused"):
            set_upconv(model, form)
            prof = launched_kernels(lambda: _forward(cfg, model, batch))
            up[f"device_kernels_{form}"], up[f"profiler_windows_{form}"] = len(prof["kernels"]), prof["windows"]
        check(all(bool(torch.isfinite(o).all()) for o in literal[3:]), f"{dt}: literal UpConv: non-finite depth")
        up["final_max_rel_gap"] = ((literal[4] - kernel_outs[4]).abs().max() / kernel_outs[4].abs().max()).item()
        rec["upconv_fused_vs_literal"] = up
        emit(rec)
    del models
    torch.cuda.empty_cache()
    return launches


def tail_serving(dt: str):
    """slice_tail's serving config in compute dtype ``dt`` (DenseNet-161,
    bts_size 512, 352x1216, seed 0, --fused_tail always) and its b1 batch."""
    from bts_tpu_torch.config import Config

    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8),
             "focal": np.array([FOCAL], np.float32)}
    return Config(mode="test", encoder="densenet161_bts", bts_size=512, max_depth=MAX_DEPTH, dataset="kitti",
                  input_height=H, input_width=W, compute_dtype=dt, seed=0, fused_tail="always"), batch


def phase_slice_tail(card: str) -> dict:
    """Serving with --fused_tail always: 3 K5 + 1 K6 and no K1 per forward,
    against use_pallas="never" on the same path and against the literal tail
    (fused_tail="auto"); both paths timed in turns."""
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.ops import tail_cuda
    from bts_tpu_torch.ops.lpg_cuda import fused_denominator, lpg_fused
    from bts_tpu_torch.utils.profiling import launched_kernels

    focal_scale = FOCAL / 715.0873
    cfgs = {dt: tail_serving(dt)[0] for dt in ("float32", "bfloat16")}
    batch = tail_serving("float32")[1]
    models = {dt: create_model(cfg, "cuda") for dt, cfg in cfgs.items()}
    heads = _heads(*models.values())
    counters = {"lpg_fused": lpg_fused, "lpg_phase_planes": tail_cuda.lpg_phase_planes,
                "fused_tail": tail_cuda.fused_tail}

    def counts():
        return {n: c.launches for n, c in counters.items()}

    # the main path: every count to 0, one forward per compute dtype
    for c in counters.values():
        c.launches = 0
    outs = {}
    with k7_counted("serve_tail", expect=2 * DENSENET161_BTS_BNS):
        for dt in cfgs:
            before = counts()
            outs[dt] = (_forward(cfgs[dt], models[dt], batch), dict(heads))
            n = {k: v - before[k] for k, v in counts().items()}
            check(n == {"lpg_fused": 0, "lpg_phase_planes": 3, "fused_tail": 1}, f"{dt}: launches {n}")
    launches = counts()

    # the device kernels of one bf16 fused-tail forward: under each K5 op its
    # kernel alone (no cast of the bf16 raw), under the K6 op K6's
    prof = launched_kernels(lambda: _forward(cfgs["bfloat16"], models["bfloat16"], batch),
                            ("bts_tpu_torch::lpg_phase_planes", "bts_tpu_torch::fused_tail"))
    prof = {"device_kernels": len(prof.pop("kernels")), **prof}
    emit({"phase": "slice_tail_kernels", "compute_dtype": "bfloat16", "card": card, **prof})
    k5, k6 = prof["by_op"].values()
    check(len(k5) == 3 and all(len(ks) == 1 and "lpg_phase_kernel" in ks[0] for ks in k5)
          and len(k6) == 1 and len(k6[0]) == 1 and "fused_tail_kernel" in k6[0][0],
          f"bf16 fused-tail forward: K5 and K6 ops launched {prof['by_op']}")

    for dt, cfg in cfgs.items():
        model, (fused, raw_heads) = models[dt], outs[dt]
        rec = {"phase": "slice_tail", "compute_dtype": dt, "card": card,
               "shapes": [list(o.shape) for o in fused]}
        check(all(tuple(o.shape) == (1, 1, H, W) for o in fused), f"{dt}: shapes {rec['shapes']}")
        dens = [fused_denominator(raw_heads[n].permute(0, 2, 3, 1), k)
                for n, k in (("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))]
        for i, den in enumerate(dens):
            check(bool(torch.isfinite(fused[i][:, 0][den != 0]).all()), f"{dt}: LPG map {i} not finite")
        check(all(bool(torch.isfinite(o).all()) for o in fused[3:]), f"{dt}: non-finite depth")
        depth = fused[4] / focal_scale
        rec["final_depth_min_max"] = [depth.min().item(), depth.max().item()]
        check(0 < rec["final_depth_min_max"][0] and rec["final_depth_min_max"][1] <= MAX_DEPTH,
              f"{dt}: depth range {rec['final_depth_min_max']}")

        # the same path through the plain versions (use_pallas="never")
        model.decoder.use_pallas = "never"
        before = counts()
        plain = _forward(cfg, model, batch)
        check(counts() == before, "use_pallas='never' launched a kernel")
        model.decoder.use_pallas = cfg.use_pallas
        rec["maps_kernel_vs_never"] = [dict(compare_lpg(fused[i][:, 0], plain[i][:, 0], dens[i]), k=k)
                                       for i, k in enumerate((8, 4, 2))]
        check(all(r["within_rule"] for r in rec["maps_kernel_vs_never"]), f"{dt}: maps vs never")
        rec["d1x1_kernel_vs_never"] = tail_gap(fused[3], plain[3])
        rec["final_kernel_vs_never"] = tail_gap(fused[4] / (MAX_DEPTH * focal_scale),
                                                plain[4] / (MAX_DEPTH * focal_scale))
        check(rec["d1x1_kernel_vs_never"]["within_rule"] and rec["final_kernel_vs_never"]["within_rule"],
              f"{dt}: tail kernel vs never {rec['d1x1_kernel_vs_never']} {rec['final_kernel_vs_never']}")

        # against the literal tail (tests/test_tail.py's rule, scaled to max_depth)
        model.decoder.fused_tail = "auto"
        literal = _forward(cfg, model, batch)
        model.decoder.fused_tail = "always"
        gaps = [(a - b).abs().max().item() for a, b in zip(fused, literal)]
        gaps[4] /= focal_scale
        limits = [1e-5, 1e-5, 1e-5, 5e-3, 5e-3 * MAX_DEPTH]
        rec["fused_vs_literal_max_abs"] = dict(zip(("d8", "d4", "d2", "d1x1", "final"), gaps))
        rec["fused_vs_literal_limits"] = limits
        emit({"phase": "slice_tail_check", "compute_dtype": dt, **{k: rec[k] for k in (
            "final_depth_min_max", "d1x1_kernel_vs_never", "final_kernel_vs_never", "fused_vs_literal_max_abs")}})
        check(all(g <= lim for g, lim in zip(gaps, limits)), f"{dt}: fused vs literal {gaps}")

        # both tails in turns (fused, literal, literal, fused, ...), and each one's peak memory
        setting = {"fused": "always", "literal": "auto"}
        times = {"fused": [], "literal": []}
        for path in setting:
            model.decoder.fused_tail = setting[path]
            for _ in range(3):
                _forward(cfg, model, batch)
            torch.cuda.reset_peak_memory_stats()
            _forward(cfg, model, batch)
            rec[f"{path}_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for i in range(TIMED_FORWARDS):
            for path in ("fused", "literal") if i % 2 == 0 else ("literal", "fused"):
                model.decoder.fused_tail = setting[path]
                t0 = time.perf_counter()
                _forward(cfg, model, batch)
                times[path].append((time.perf_counter() - t0) * 1e3)
        model.decoder.fused_tail = "always"
        for path, t in times.items():
            q = statistics.quantiles(t, n=4)
            rec[f"{path}_ms_per_forward"] = {"median": statistics.median(t), "q1": q[0], "q3": q[2], "n": len(t)}
        emit(rec)
    del models
    torch.cuda.empty_cache()
    return launches


def train_batch(b: int, h: int, w: int, seed: int) -> dict:
    """Seeded synthetic KITTI batch: uint8 frames and sparse LiDAR-like depth
    (about 5% of pixels in [1, 80) m, the rest 0 = no return)."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, MAX_DEPTH, (b, h, w)).astype(np.float32)
    depth[rng.random((b, h, w)) >= 0.05] = 0.0
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), "depth": depth,
            "focal": np.full((b,), FOCAL, np.float32)}


def named_grads(model) -> dict:
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}


def tensor_gaps(grads: dict, ref: dict) -> dict:
    """|g - g_ref| / |g_ref| per tensor, the denominator floored at 1e-6 of
    the global gradient norm (see :func:`grad_gaps`)."""
    floor = 1e-6 * torch.sqrt(sum(r.square().sum() for r in ref.values())).item()
    return {n: ((g - ref[n]).norm() / max(ref[n].norm().item(), floor)).item() for n, g in grads.items()}


def grad_gaps(model, ref_model) -> dict:
    """Per-tensor |g - g_ref| / |g_ref|, the denominator floored at 1e-6 of
    the global gradient norm (a conv bias followed by a train-mode BatchNorm
    has an exactly-zero gradient in exact arithmetic, and its rounding noise
    is no gap), the five worst, and the gap of the whole gradient.  Each
    argument is a model or its :func:`named_grads`."""
    grads, ref = (x if isinstance(x, dict) else named_grads(x) for x in (model, ref_model))
    pairs = [(n, g, ref[n]) for n, g in grads.items()]
    total = torch.sqrt(sum(r.square().sum() for _, _, r in pairs)).item()
    floor = 1e-6 * total
    gaps = tensor_gaps(grads, ref)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:5]
    diff = torch.sqrt(sum((g - r).square().sum() for _, g, r in pairs)).item()
    return {"worst_gap": gaps[worst[0]], "worst": [[n, gaps[n]] for n in worst],
            "global_gap": diff / total, "tensors": len(gaps),
            "floored": sum(r.norm().item() < floor for _, _, r in pairs), "global_grad_norm": total}


def train_config(**kw):
    from bts_tpu_torch.config import Config

    base = dict(mode="train", encoder="densenet161_bts", bts_size=512, max_depth=MAX_DEPTH,
                dataset="kitti", input_height=TRAIN_H, input_width=TRAIN_W, batch_size=TRAIN_B,
                compute_dtype="bfloat16", remat=True, remat_policy="layer", do_random_rotate=True,
                degree=1.0, seed=0, device="cuda")
    base.update(kw)
    return Config(**base)


def perturbed(model, perturb: float, seed: int = 0):
    """``model`` with every weight scaled by 1 +- perturb (a sign from ``seed``)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_((1 + perturb * (torch.randint(0, 2, p.shape, generator=gen) * 2 - 1)).to(p.device))
    return model


def one_step(cfg, device, batch, use_pallas=None, perturb: float = 0.0):
    """A fresh seeded model and trainer on ``device``, one step on ``batch``;
    ``perturb``: every weight first scaled by 1 +- perturb (a seeded sign)."""
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.training.trainer import Trainer

    model = create_model(cfg, device)
    if use_pallas is not None:
        model.decoder.use_pallas = use_pallas
    if perturb:
        perturbed(model, perturb)
    trainer = Trainer(model, cfg, total_steps=100, device=device)
    metrics = trainer.train_step(batch)
    return model, float(metrics["loss"])


def phase_train(card: str) -> dict:
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.training.trainer import Trainer

    set_float32_precision()
    rec = {"phase": "train", "card": card, "config": "config 4: densenet161_bts, bts_size 512, kitti "
           f"{H}x{W} uint8 -> {TRAIN_H}x{TRAIN_W}, rotate 1.0 deg, remat layer, AdamW eps 1e-3"}

    # kernel path vs use_pallas="never": one f32 step, b2, same state and draws
    cfg = train_config(compute_dtype="float32", batch_size=2)
    batch = train_batch(2, H, W, seed=1)
    k1, k2 = lpg_fused.launches, lpg_fused_bwd.launches
    kmodel, kloss = one_step(cfg, "cuda", batch)
    check(lpg_fused.launches - k1 == 3 and lpg_fused_bwd.launches - k2 == 3, "kernel-path step launches")
    nmodel, nloss = one_step(cfg, "cuda", batch, use_pallas="never")
    gaps = grad_gaps(kmodel, nmodel)
    rec["kernel_vs_never_f32_b2"] = {"loss": kloss, "never_loss": nloss,
                                     "loss_rel_err": abs(kloss - nloss) / abs(nloss), **gaps}
    emit({"phase": "train_check", "kernel_vs_never_f32_b2": rec["kernel_vs_never_f32_b2"]})
    check(abs(kloss - nloss) <= 1e-4 * abs(nloss), f"loss kernel vs never {kloss} {nloss}")
    check(gaps["worst_gap"] <= 1e-3, f"gradient gap kernel vs never {gaps}")
    del kmodel, nmodel

    # the f32 step on the card against the same weights and draws on the CPU
    cfg = train_config(compute_dtype="float32", batch_size=2, input_height=64, input_width=96)
    batch = train_batch(2, 80, 112, seed=2)
    gmodel, gloss = one_step(cfg, "cuda", batch)
    cmodel, closs = one_step(cfg.replace(device="cpu"), "cpu", batch)
    gaps = grad_gaps(gmodel, cmodel)
    stats_err = max((a.cpu() - b).abs().max().item()
                    for a, b in zip(gmodel.buffers(), cmodel.buffers()))
    rec["gpu_vs_cpu_f32_64x96_b2"] = {"loss": gloss, "cpu_loss": closs,
                                      "loss_rel_err": abs(gloss - closs) / abs(closs),
                                      "bn_stats_max_abs_err": stats_err, **gaps}
    emit({"phase": "train_check", "gpu_vs_cpu_f32_64x96_b2": rec["gpu_vs_cpu_f32_64x96_b2"]})
    # at 64x96 the deepest BatchNorms see 2x4x6 values per channel and the
    # gradients are rounding-sensitive: the CPU alone, 1 thread against 8,
    # moves the whole gradient by ~1e-2 and single BN biases by a few 1e-2
    # with bit-equal losses.  So the card is held to the CPU's loss and to
    # the whole gradient, and the worst tensors are printed.
    check(abs(gloss - closs) <= 1e-5 * abs(closs), f"loss GPU vs CPU {gloss} {closs}")
    check(gaps["global_gap"] <= 2e-2, f"gradient gap GPU vs CPU {gaps}")
    del gmodel, cmodel
    torch.cuda.empty_cache()

    # the main path: config 4 at b16, bf16, remat 'layer'
    cfg = train_config()
    batch = train_batch(TRAIN_B, H, W, seed=3)
    model = create_model(cfg, "cuda")
    trainer = Trainer(model, cfg, total_steps=1000, device="cuda")
    stats_before = [model.encoder.features.norm0.running_mean.clone(), model.decoder.bn5.running_var.clone()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
    times, losses = [], []
    with k7_counted("train", expect=0):  # train mode keeps the chain
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
    launches = {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches}
    steps = WARMUP_STEPS + TIMED_STEPS
    rec["steps"] = steps
    rec["launches"] = launches
    check(launches == {"lpg_fused": 3 * steps, "lpg_fused_bwd": 3 * steps},
          f"{launches} in {steps} steps, not 3 K1 and 3 K2 per step")
    check(all(np.isfinite(losses)), f"losses {losses}")
    moved = [not torch.equal(a, b) for a, b in
             zip(stats_before, [model.encoder.features.norm0.running_mean, model.decoder.bn5.running_var])]
    check(all(moved), "BN running statistics did not move")
    q = statistics.quantiles(times, n=4)
    med = statistics.median(times)
    check(all(bool(torch.isfinite(p.grad).all()) for p in trainer.params), "non-finite gradients")
    rec.update(losses=losses, grad_norm=float(metrics["grad_norm"]),
               learning_rate=metrics["learning_rate"],
               ms_per_step={"median": med, "q1": q[0], "q3": q[2], "n": len(times)},
               images_per_s=TRAIN_B * 1e3 / med,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    # the same step on use_pallas="never", in turns with the kernel path
    # (kernel, never, never, kernel, ...), and each path's peak memory
    paths = {"kernel": cfg.use_pallas, "never": "never"}
    turns = {"kernel": [], "never": []}
    for path, setting in paths.items():
        model.decoder.use_pallas = setting
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        rec[f"{path}_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for i in range(TURNS):
        for path in ("kernel", "never") if i % 2 == 0 else ("never", "kernel"):
            model.decoder.use_pallas = paths[path]
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            turns[path].append((time.perf_counter() - t0) * 1e3)
    model.decoder.use_pallas = cfg.use_pallas
    for path, t in turns.items():
        q = statistics.quantiles(t, n=4)
        rec[f"{path}_ms_per_step_in_turns"] = {"median": statistics.median(t), "q1": q[0],
                                               "q3": q[2], "n": len(t)}

    def step():
        trainer.train_step(batch)
        torch.cuda.synchronize()

    # the literal UpConv form against the fused default, in turns
    rec["upconv_fused_vs_literal"] = upconv_ab(model, step, UPCONV_STEPS)

    rec["profile_2_steps"] = profile_steps(trainer, batch)
    emit(rec)
    return rec, model


def profile_steps(trainer, batch, steps: int = 2) -> dict:
    """A profiled window of ``steps`` training steps: the device busy share
    and the kernels that take the time."""
    from bts_tpu_torch.utils.profiling import window

    with window() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "device_launches": sum(e.count for e in kernels),
        "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top],
    }



DDP_STEPS, DDP_FRAMES = 12, 16  # train_ddp (a): bts_main steps under torchrun, frames of the tree
DDP_TIMED = 4  # train_ddp (b): timed b16 steps of the two ranks, after 2 warm-up


def _step_record(cfg, batch, device, perturb: float = 0.0, seed: int = 0, frozen_bn: bool = False) -> dict:
    """One f32 step of a fresh seeded model through the Trainer: the loss,
    the gradient the step applied and the BatchNorm buffers, on the host;
    ``perturb`` as :func:`one_step`'s, its signs from ``seed``.
    ``frozen_bn``: every BatchNorm in eval mode (running statistics), the
    batch taken as it is (``augment=False``: (B, TRAIN_H, TRAIN_W))."""
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.training.trainer import Trainer

    model = perturbed(create_model(cfg, device), perturb, seed)
    trainer = Trainer(model, cfg, total_steps=100, device=device, augment=not frozen_bn)
    if frozen_bn:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.eval()
    loss = float(trainer.train_step(batch)["loss"])
    return {"loss": loss, "grads": named_grads(model), "ddp": trainer.ddp is not None,
            "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()}}


def _step_gaps(rec: dict, ref: dict) -> dict:
    """The train phase's comparison of two f32 steps, and the BatchNorm
    buffers.  With ``ref["probe_grads"]`` (the reference step from weights
    moved by one ulp, one or more seeded sign draws): each tensor's gap
    beside twice the largest probe's, and the tensors over max(1e-3, that),
    and the largest probe's gap of the whole gradient."""
    gaps = grad_gaps(rec["grads"], ref["grads"])
    bn = max((rec["buffers"][n] - b).abs().max().item() for n, b in ref["buffers"].items())
    out = {"loss": rec["loss"], "ref_loss": ref["loss"],
           "loss_rel_err": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]), "bn_buffers_max_abs_err": bn,
           **{k: gaps[k] for k in ("worst_gap", "worst", "global_gap", "tensors")}}
    if "probe_grads" in ref:
        probes = [tensor_gaps(p, ref["grads"]) for p in ref["probe_grads"]]
        probe = {n: max(p[n] for p in probes) for n in ref["grads"]}
        mine = tensor_gaps(rec["grads"], ref["grads"])
        out["ulp_probe"] = {"probes": len(probes),
                            "global_gap": max(grad_gaps(p, ref["grads"])["global_gap"] for p in ref["probe_grads"]),
                            "worst_gap": max(probe.values()),
                            "over_rule": {n: [g, probe[n]] for n, g in mine.items() if g > max(1e-3, 2 * probe[n])}}
    return out


def _quartiles(times) -> dict:
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2], "n": len(times)}


def _torchrun(nproc: int, mode: str, tmp: Path, entry: str = "train_ddp_rank") -> list:
    """This script as ``nproc`` ranks under torchrun (``<entry> <mode>
    <tmp>``); returns each rank's record, by rank.  A failed rank fails the
    launch and the phase."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           str(Path(__file__).resolve()), entry, mode, str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    tag = f'{{"phase": "{entry}"'
    recs = [json.loads(line[line.index(tag):]) for line in proc.stdout.splitlines() if tag in line]
    check(proc.returncode == 0 and len(recs) == nproc,
          f"torchrun {mode}: exit {proc.returncode}\\n{proc.stdout[-4000:]}\\n{proc.stderr[-6000:]}")
    return sorted(recs, key=lambda r: r["rank"])


def phase_train_ddp(card: str, train_rec: dict) -> dict:
    """Config 4 under torch.distributed.  (a) bts_main through torchrun,
    one rank over NCCL, on a synthetic KITTI tree; (b) two ranks on the one
    card over gloo.  The world-1 references are made here, in this process,
    without a process group.  Returns (a)'s K1 and K2 launches."""
    import tempfile

    from bts_tpu_torch.models.bts import set_float32_precision

    set_float32_precision()
    rec = {"phase": "train_ddp", "card": card,
           "config": "config 4 as the train phase; (a) bts_main @arguments/arguments_train_eigen.txt under torchrun "
                     "(NCCL, world 1), (b) two gloo ranks on cuda:0"}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        # the unwrapped f32 steps the ranks are held to: b2 for (a), b4 for (b)
        # and, for (b), the b4 step from weights moved by one ulp (2^-23): how
        # far f32 rounding alone moves this gradient
        for b, seed in ((2, 1), (4, 4)):
            cfg = train_config(compute_dtype="float32", batch_size=b)
            batch = train_batch(b, H, W, seed=seed)
            ref = _step_record(cfg, batch, "cuda")
            if b == 4:
                ref["probe_grads"] = [_step_record(cfg, batch, "cuda", perturb=2**-23)["grads"]]
            torch.save(ref, tmp / f"ref_b{b}.pt")
        torch.cuda.empty_cache()
        _png_tree(tmp / "kitti", DDP_FRAMES, KITTI_FULL, "kitti", seed=12)

        t0 = time.perf_counter()
        (a,) = _torchrun(1, "nccl", tmp)
        rec["nccl_world1"] = dict(a, seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        b = _torchrun(2, "gloo", tmp)
        rec["gloo_world2"] = {"ranks": b, "seconds": time.perf_counter() - t0}
    rec["train_phase_same_call"] = {k: train_rec[k] for k in ("ms_per_step", "images_per_s", "peak_mem_gib")}
    emit(rec)
    # (a) the train phase's rules for the kernel path against never
    g = a["ddp_vs_unwrapped_f32_b2"]
    check(g["loss_rel_err"] <= 1e-4 and g["worst_gap"] <= 1e-3, f"DDP (NCCL) vs unwrapped: {g}")
    # (b) the world-1 step: loss 1e-5 relative, BatchNorm statistics 1e-5,
    # each gradient tensor within the larger of 1e-3 and twice the distance
    # one ulp of every weight moves it, the whole gradient within the larger
    # of 1e-3 and twice the probe's (the world-2 forward sums in another
    # order; through ReLU masks at zero the f32 gradient moves by as much
    # as a one-ulp change of the weights moves it)
    for r in b:
        g = r["world2_vs_world1_f32_b4"]
        probe = g["ulp_probe"]
        check(g["loss_rel_err"] <= 1e-5 and g["bn_buffers_max_abs_err"] <= 1e-5 and not probe["over_rule"]
              and g["global_gap"] <= max(1e-3, 2 * probe["global_gap"]), f"rank {r['rank']} of 2 vs world 1: {g}")
        z = r["zero_vs_replicated"]
        check(max(z["param_max_abs_err_per_step"]) <= 1e-6, f"rank {r['rank']} ZeRO-1 vs replicated: {z}")
        share = z["optimizer_state_bytes"] / z["replicated_state_bytes"]
        check(z["optimizer"] == "ZeroRedundancyOptimizer" and 0.3 < share < 0.7, f"ZeRO-1 state share {share}")
        steps = r["steps"]
        check(r["launches"] == {"lpg_fused": 3 * steps, "lpg_fused_bwd": 3 * steps}, f"rank {r['rank']}: {r}")
    held = sum(r["zero_vs_replicated"]["optimizer_state_bytes"] for r in b)
    check(held == b[0]["zero_vs_replicated"]["replicated_state_bytes"], f"ZeRO-1 shards hold {held} bytes")
    K7_PATHS["train_ddp"] = a["k7_launches"]
    return a["launches"]


def ddp_rank(mode: str, tmp: str) -> int:
    """One rank of the train_ddp phase, started by torchrun; prints its
    record as one JSON line.  ``nccl``: bts_main's process group (world 1),
    the f32 b2 step through DDP against the unwrapped one, then bts_main
    for DDP_STEPS steps on the tree.  ``gloo``: a gloo group made here, both
    ranks on cuda:0; the f32 step at a global b4 against world 1, ZeRO-1
    against replicated AdamW over two steps of the same gradients, and
    timed b16 steps."""
    import torch.distributed as dist

    from bts_tpu_torch.cli import bts_main
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.ops import lpg_cuda
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.parallel import distributed as parallel
    from bts_tpu_torch.training.optimizer import state_bytes
    from bts_tpu_torch.training.trainer import Trainer

    tmp = Path(tmp)
    set_float32_precision()
    lpg_cuda._lib()  # built by the parent under build/torch_kernels
    if mode == "nccl":
        parallel.maybe_init_distributed(train_config())
        check(dist.get_backend() == "nccl" and parallel.world() == 1, f"{dist.get_backend()} {parallel.world()}")
    else:
        dist.init_process_group("gloo")
    rank, world = parallel.rank(), parallel.world()
    device = torch.device("cuda", 0) if mode == "gloo" else parallel.local_device(torch.device("cuda"))
    torch.cuda.set_device(device)
    rec = {"phase": "train_ddp_rank", "mode": mode, "rank": rank, "world": world, "device": str(device)}
    try:
        if mode == "nccl":
            # (a) one f32 b2 step through DDP against the unwrapped step
            cfg = train_config(compute_dtype="float32", batch_size=2)
            step = _step_record(cfg, train_batch(2, H, W, seed=1), device)
            rec["ddp_vs_unwrapped_f32_b2"] = _step_gaps(step, torch.load(tmp / "ref_b2.pt"))
            check(step["ddp"], "the step did not run through DistributedDataParallel")
            torch.cuda.empty_cache()

            # the main path: bts_main with the config-4 recipe on the tree
            times = []
            train_step = Trainer.train_step

            def timed(self, batch):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = train_step(self, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                return out

            Trainer.train_step = timed
            data = str(tmp / "kitti")
            argv = ["@arguments/arguments_train_eigen.txt", "--device", "cuda", "--num_devices", "1",
                    "--input_height", str(TRAIN_H), "--input_width", str(TRAIN_W),
                    "--remat", "--remat_policy", "layer", "--compute_dtype", "bfloat16",
                    "--num_epochs", str(DDP_STEPS), "--data_path", data, "--gt_path", data,
                    "--filenames_file", str(tmp / "kitti" / "split.txt"), "--use_native_loader", "never",
                    "--log_directory", str(tmp / "runs"), "--model_name", "c4_ddp", "--save_freq", "1000"]
            torch.cuda.reset_peak_memory_stats()
            lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
            with k7_counted() as k7:  # the summary forward's BatchNorms that take K7
                check(bts_main.main(argv) == 0, "bts_main")
            launches = {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches}
            # 3 K1 + 3 K2 per step, and 3 K1 for the step-1 summary forward
            check(launches == {"lpg_fused": 3 * DDP_STEPS + 3, "lpg_fused_bwd": 3 * DDP_STEPS},
                  f"{launches} in {DDP_STEPS} steps")
            check(len(times) == DDP_STEPS, f"{len(times)} steps")
            timing = _quartiles(times[WARMUP_STEPS:])
            rec.update(launches=launches, k7_launches=k7.launches, steps=DDP_STEPS, ms_per_step=timing,
                       images_per_s=TRAIN_B * 1e3 / timing["median"],
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        else:
            # (b) the f32 step at a global b4, this rank's rows, against world 1
            cfg = train_config(compute_dtype="float32", batch_size=4)
            rows = parallel.rank_rows(4, 1, rank, world)
            local = {k: v[rows] for k, v in train_batch(4, H, W, seed=4).items()}
            step = _step_record(cfg, local, device)
            rec["world2_vs_world1_f32_b4"] = _step_gaps(step, torch.load(tmp / "ref_b4.pt"))
            check(step["ddp"], "the step did not run through DistributedDataParallel")
            del step
            # ZeRO-1 against replicated AdamW: two steps, each fed the same gradients
            rep = Trainer(create_model(cfg, device), cfg, total_steps=100, device=device)
            zcfg = cfg.replace(shard_opt_state=True)
            zero = Trainer(create_model(zcfg, device), zcfg, total_steps=100, device=device)
            gaps = []
            for _ in range(2):
                rep.train_step(local)
                for p, q in zip(zero.params, rep.params):
                    p.grad = q.grad.clone()
                zero.optimizer.step()
                zero.scheduler.step()
                gaps.append(max((p - q).abs().max().item() for p, q in zip(zero.params, rep.params)))
            rec["zero_vs_replicated"] = {
                "param_max_abs_err_per_step": gaps, "optimizer": type(zero.optimizer).__name__,
                "optimizer_state_bytes": state_bytes(zero.optimizer),
                "replicated_state_bytes": state_bytes(rep.optimizer)}
            del rep, zero
            torch.cuda.empty_cache()
            # timed b16 steps: this rank's b8, bf16, remat
            cfg = train_config()
            rows = parallel.rank_rows(TRAIN_B, 1, rank, world)
            local = {k: v[rows] for k, v in train_batch(TRAIN_B, H, W, seed=3).items()}
            trainer = Trainer(create_model(cfg, device), cfg, total_steps=100, device=device)
            torch.cuda.reset_peak_memory_stats()
            lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
            times = []
            for i in range(WARMUP_STEPS + DDP_TIMED):
                t = time.perf_counter()
                metrics = trainer.train_step(local)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            steps = WARMUP_STEPS + DDP_TIMED
            rec.update(launches={"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches},
                       steps=steps, loss=float(metrics["loss"]), ms_per_step_b16=_quartiles(times[WARMUP_STEPS:]),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit(rec)
    finally:
        dist.destroy_process_group()
    return 0

SPATIAL_TIMED = 8  # spatial: timed b16 steps at 2 ranks, after WARMUP_STEPS
SPATIAL_FRAMES = 3  # spatial: frames of bts_test's synthetic KITTI tree
SPATIAL_RULE = 2e-5  # spatial: max|banded - one process| / max|one process| of each forward output
SPATIAL_PROBES = 3  # spatial: one-ulp weight probes of each f32 step's gradient (seeds 0, 1, 2)
SPATIAL_LAYOUTS = {"h2": (2, 1), "hw4": (2, 2)}  # the rank launches: (--spatial_shards, --spatial_shards_w)


def _serve_config(**kw):
    from bts_tpu_torch.config import Config

    return Config(**{**dict(mode="test", encoder="densenet161_bts", bts_size=512, max_depth=MAX_DEPTH,
                            dataset="kitti", input_height=H, input_width=W, compute_dtype="float32", seed=0,
                            device="cuda"), **kw})


def _serve_frame() -> dict:
    rng = np.random.default_rng(21)
    return {"image": rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8), "focal": np.array([FOCAL], np.float32)}


def _frozen_batch() -> dict:
    """The frozen-BatchNorm step's b2, at the training size as it is."""
    return train_batch(2, TRAIN_H, TRAIN_W, seed=6)


def _spatial_refs(cfg, tmp: Path) -> None:
    """The one-process f32 b2 steps the spatial ranks are held to, each with
    the same step from weights moved by one ulp (2^-23) under
    SPATIAL_PROBES seeded signs: how far f32 rounding alone moves each
    tensor of the gradient (through ReLU masks at zero, by up to ~1e-2)."""
    for name, batch, frozen_bn in (("step", train_batch(2, H, W, seed=1), False),
                                   ("frozen", _frozen_batch(), True)):
        ref = _step_record(cfg, batch, "cuda", frozen_bn=frozen_bn)
        ref["probe_grads"] = [_step_record(cfg, batch, "cuda", perturb=2**-23, seed=seed, frozen_bn=frozen_bn)["grads"]
                              for seed in range(SPATIAL_PROBES)]
        torch.save(ref, tmp / f"{name}_ref.pt")


def _relu_flips(cfg, device, bands, worst) -> dict:
    """Where the banded frozen-BatchNorm forward leaves the one-process one:
    a fresh seeded model in eval mode on the frozen step's input, once on
    the whole frame (this rank's band of every encoder BatchNorm output
    kept) and once on the bands.  Every encoder BatchNorm output feeds a
    ReLU; a sign that differs is a ReLU mask flipped by the bands' order of
    sums.  Returns the flips on this rank's band, the largest |input| (whole
    frame) of a flip, the layers with most flips, and the flips in the
    layers of ``worst`` (tensor names)."""
    from bts_tpu_torch.data.augment import eval_preprocess
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.parallel import spatial

    b = _frozen_batch()
    image = eval_preprocess(torch.as_tensor(b["image"]).to(device)).permute(0, 3, 1, 2)
    focal = torch.as_tensor(b["focal"]).to(device)
    model = create_model(cfg, device).eval()
    whole, flips = {}, {}

    def keep(name):
        def hook(mod, args, out):
            r0, r1, c0, c1 = bands.band(bands.height // out.shape[-2])
            whole[name] = out[..., r0:r1, c0:c1].float()
        return hook

    def compare(name):
        def hook(mod, args, out):
            ref = whole.pop(name)
            flip = (ref > 0) != (out.float() > 0)
            flips[name] = (int(flip.sum()), ref[flip].abs().max().item() if flip.any() else 0.0)
        return hook

    bns = [(n, m) for n, m in model.named_modules() if n.startswith("encoder.") and isinstance(m, BatchNorm)]
    for fn, use, x in ((keep, None, image), (compare, bands, bands.cut(image).contiguous())):
        handles = [m.register_forward_hook(fn(n)) for n, m in bns]
        with torch.no_grad(), spatial.use(use):
            model(x, focal)
        for h in handles:
            h.remove()
    layers = {n.rsplit(".", 2)[0] for n in worst}
    return {"bn_outputs": len(flips), "flips": sum(f for f, _ in flips.values()),
            "max_abs_input_at_flip": max(a for _, a in flips.values()),
            "most": sorted(([n, *f] for n, f in flips.items() if f[0]), key=lambda e: -e[1])[:8],
            "worst_layers": {n: list(f) for n, f in flips.items() if n.rsplit(".", 1)[0] in layers}}


def _kitti_test_argv(tmp: Path, out: str) -> list:
    return ["--device", "cuda", "--encoder", "densenet161_bts", "--bts_size", "512", "--dataset", "kitti",
            "--max_depth", str(MAX_DEPTH), "--compute_dtype", "float32", "--batch_size", "1", "--do_kb_crop",
            "--data_path", str(tmp / "kitti"), "--filenames_file", str(tmp / "kitti" / "split.txt"),
            "--use_native_loader", "never", "--out_path", str(tmp / out)]


def phase_spatial(card: str, train_rec: dict) -> dict:
    """Spatial sharding: ranks started by torchrun from this script, all on
    cuda:0 over gloo (halos staged through pinned host memory).  (a) config
    2 serving (DenseNet-161, bts_size 512, 352x1216, b1, f32, KITTI focal)
    at 2 ranks (H over 2) and 4 (2 x 2) against the one-process forward made
    here on the same seeded weights, and bts_test --spatial_shards 2 on
    synthetic KITTI frames against the one-process bts_test's PNGs; (b)
    config 4 at 2 ranks: one f32 step at a global b2 against the one-process
    step, the gradient with BatchNorm frozen, and timed bf16 b16 steps (remat
    'layer').  Returns K1's and K2's launches in the ranks' main path (the
    serving forwards and the timed steps)."""
    import tempfile

    from bts_tpu_torch.cli import bts_test
    from bts_tpu_torch.models.bts import create_model, set_float32_precision

    set_float32_precision()
    rec = {"phase": "spatial", "card": card,
           "config": "(a) config 2 serving, 352x1216 b1 f32; (b) config 4, 352x704: f32 b2, bf16 b16 remat layer",
           "transport": "every rank on cuda:0: gloo on the host, halos staged through pinned host memory"}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        # the one-process references on the same seeded weights and inputs
        model = create_model(_serve_config(), "cuda")
        torch.save([o.cpu() for o in _forward(_serve_config(), model, _serve_frame())], tmp / "serve_ref.pt")
        del model
        _spatial_refs(train_config(compute_dtype="float32", batch_size=2), tmp)
        torch.cuda.empty_cache()
        _png_tree(tmp / "kitti", SPATIAL_FRAMES, KITTI_FULL, "kitti", seed=13)
        check(bts_test.main(_kitti_test_argv(tmp, "whole")) == 0, "bts_test, one process")
        torch.cuda.empty_cache()

        for name, (n, m) in SPATIAL_LAYOUTS.items():
            t0 = time.perf_counter()
            ranks = _torchrun(n * m, name, tmp, entry="spatial_rank")
            rec[name] = {"ranks": ranks, "seconds": time.perf_counter() - t0}
        from PIL import Image

        pngs = {}
        for f in sorted((tmp / "whole" / "raw").iterdir()):
            a, b = (np.asarray(Image.open(d / "raw" / f.name), dtype=np.int64) for d in (tmp / "whole", tmp / "banded"))
            pngs[f.name] = {"max_abs_units": int(np.abs(a - b).max()), "pixels_off": int((a != b).sum())}
        rec["bts_test_pngs"] = pngs
    rec["train_phase_same_call"] = {k: train_rec[k] for k in ("ms_per_step", "images_per_s", "peak_mem_gib")}
    rec["frozen_relu_flips_h2"] = sum(r["frozen_bn_grads"]["relu_flips"]["flips"] for r in rec["h2"]["ranks"])
    emit(rec)
    check(len(pngs) == SPATIAL_FRAMES and all(p["max_abs_units"] <= 1 for p in pngs.values()),
          f"bts_test --spatial_shards 2 against one process: {pngs}")
    launches = {"lpg_fused": 0, "lpg_fused_bwd": 0}
    for name, r in ((name, r) for name in SPATIAL_LAYOUTS for r in rec[name]["ranks"]):
        s = r["serve"]
        check(max(s["rel_err"]) <= SPATIAL_RULE and s["launches"] == {"lpg_fused": 3, "lpg_fused_bwd": 0},
              f"{name} rank {r['rank']} serving: {s}")
        launches["lpg_fused"] += s["launches"]["lpg_fused"]
        K7_PATHS["spatial"] = K7_PATHS.get("spatial", 0) + s["k7_launches"]
        if name != "h2":
            continue
        check(r["bts_test_launches"] == 3 * SPATIAL_FRAMES, f"rank {r['rank']} bts_test: {r['bts_test_launches']}")
        # the steps: loss 1e-5 relative, BatchNorm statistics 1e-5, the
        # whole gradient within the larger of 1e-3 (train-mode BatchNorm, as
        # train_ddp) or 1e-4 (frozen) and twice the largest gap of the
        # one-ulp probes; with BatchNorm frozen also each tensor within the
        # larger of 1e-3 and twice its probes' largest (with train-mode
        # BatchNorm, biases in denseblock4 move up to 2.8x their probes' on
        # an H100: PERF.md)
        for key, floor in (("step_f32_b2", 1e-3), ("frozen_bn_grads", 1e-4)):
            g = r[key]
            probe = g["ulp_probe"]
            check(g["loss_rel_err"] <= 1e-5 and g["bn_buffers_max_abs_err"] <= 1e-5
                  and g["global_gap"] <= max(floor, 2 * probe["global_gap"])
                  and (key == "step_f32_b2" or not probe["over_rule"]), f"rank {r['rank']} {key}: {g}")
        t = r["train_bf16_b16"]
        steps = WARMUP_STEPS + SPATIAL_TIMED
        check(t["launches"] == {"lpg_fused": 3 * steps, "lpg_fused_bwd": 3 * steps} and np.isfinite(t["loss"]),
              f"rank {r['rank']} bf16 steps: {t}")
        for k in launches:
            launches[k] += t["launches"][k]
    return launches


def spatial_rank(name: str, tmp: str) -> int:
    """One rank of the spatial phase, started by torchrun (``name`` in
    SPATIAL_LAYOUTS); prints its record as one JSON line."""
    import torch.distributed as dist

    from bts_tpu_torch.cli import bts_test
    from bts_tpu_torch.data.augment import eval_preprocess
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.ops import lpg_cuda
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.parallel import distributed as parallel
    from bts_tpu_torch.parallel import spatial
    from bts_tpu_torch.training.trainer import Trainer

    tmp = Path(tmp)
    n, m = SPATIAL_LAYOUTS[name]
    flags = dict(spatial_shards=n, spatial_shards_w=m)
    set_float32_precision()
    lpg_cuda._lib()  # built by the parent under build/torch_kernels
    cfg = _serve_config(**flags)
    parallel.maybe_init_distributed(cfg)
    device = parallel.local_device(torch.device("cuda"))
    rank = parallel.rank()
    rec = {"phase": "spatial_rank", "layout": name, "rank": rank, "world": parallel.world(),
           "backend": dist.get_backend(), "device": str(device), "band": None}

    def counts():
        return {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches}

    try:
        # (a) the serving forward on this rank's band, gathered into the frame
        model = create_model(cfg, device)
        bands = spatial.bands(spatial.grid(), H, W)
        rec["band"] = bands.band(1)
        frame = _serve_frame()
        with torch.inference_mode():
            image = eval_preprocess(torch.as_tensor(frame["image"]).to(device)).permute(0, 3, 1, 2)
            focal = torch.as_tensor(frame["focal"]).to(device)
            lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
            with k7_counted() as k7, spatial.use(bands):
                outs = model(bands.cut(image).contiguous(), focal)
            torch.cuda.synchronize()
            launched = counts()
            whole = [bands.gather(o).cpu() for o in outs]
        ref = torch.load(tmp / "serve_ref.pt")
        rec["serve"] = {"launches": launched, "k7_launches": k7.launches,
                        "rel_err": [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(whole, ref)]}
        del model, outs
        torch.cuda.empty_cache()
        if name == "h2":
            lpg_fused.launches = 0
            check(bts_test.main(_kitti_test_argv(tmp, "banded") + ["--spatial_shards", str(n)]) == 0, "bts_test")
            rec["bts_test_launches"] = lpg_fused.launches
            torch.cuda.empty_cache()
            # (b) the f32 b2 step (both ranks take the global b2)
            tcfg = train_config(compute_dtype="float32", batch_size=2, **flags)
            step = _step_record(tcfg, train_batch(2, H, W, seed=1), device)
            rec["step_f32_b2"] = _step_gaps(step, torch.load(tmp / "step_ref.pt"))
            del step
            # the same step with BatchNorm frozen, and the ReLU masks its bands flip
            frozen = _step_record(tcfg, _frozen_batch(), device, frozen_bn=True)
            g = rec["frozen_bn_grads"] = _step_gaps(frozen, torch.load(tmp / "frozen_ref.pt"))
            del frozen
            g["relu_flips"] = _relu_flips(tcfg, device, spatial.bands(spatial.grid(), TRAIN_H, TRAIN_W),
                                          [n for n, _ in g["worst"]])
            torch.cuda.empty_cache()
            # timed bf16 b16 steps, remat 'layer': this rank's band of every frame
            tcfg = train_config(**flags)
            trainer = Trainer(create_model(tcfg, device), tcfg, total_steps=100, device=device)
            batch = train_batch(TRAIN_B, H, W, seed=3)
            torch.cuda.reset_peak_memory_stats()
            lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
            halo0, times = spatial.HALO_BYTES["sent"], []
            with k7_counted(expect=0):  # train mode keeps the chain
                for _ in range(WARMUP_STEPS + SPATIAL_TIMED):
                    t = time.perf_counter()
                    metrics = trainer.train_step(batch)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
            steps = WARMUP_STEPS + SPATIAL_TIMED
            timing = _quartiles(times[WARMUP_STEPS:])
            rec["train_bf16_b16"] = {
                "launches": counts(), "steps": steps, "loss": float(metrics["loss"]), "ms_per_step": timing,
                "images_per_s": TRAIN_B * 1e3 / timing["median"],
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "halo_bytes_per_step": (spatial.HALO_BYTES["sent"] - halo0) / steps}
        emit(rec)
    finally:
        dist.destroy_process_group()
    return 0


def _heads(*models) -> dict:
    """The raw reduction outputs of the last forward of any of ``models``, by head."""
    heads = {}
    for model in models:
        for name in ("reduc8x8", "reduc4x4", "reduc2x2"):
            getattr(model.decoder, name).register_forward_hook(
                lambda mod, args, out, name=name: heads.__setitem__(name, out))
    return heads


def phase_encoders(card: str) -> int:
    """Each encoder the DenseNets' slices do not reach, serving at KITTI
    352x1216 b1 (bts_size 512, seeded weights): one f32 forward with its 3 K1
    launches, finite, against use_pallas="never" (maps by K1's rule, final
    rtol 1e-5) and against the same weights on the CPU at 64x96 (rtol 2e-4,
    atol 2e-4*max|ref|); then the median ms of bf16 forwards and the peak
    memory.  Returns the K1 launches of the phase's forwards."""
    from bts_tpu_torch.cli.bts_test import predict
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.ops.lpg_cuda import fused_denominator, lpg_fused

    set_float32_precision()
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8),
             "focal": np.array([FOCAL], np.float32)}
    small = {"image": batch["image"][:, :64, :96], "focal": batch["focal"]}
    lpg_fused.launches = 0
    with k7_counted("encoders"):  # every forward of the phase, as K1's count
        for name in NEW_ENCODERS:
            cfg = Config(mode="test", encoder=name, bts_size=512, max_depth=MAX_DEPTH, dataset="kitti",
                         input_height=H, input_width=W, compute_dtype="float32", seed=0)
            model = create_model(cfg, "cuda")
            heads = _heads(model)
            rec = {"phase": "encoders", "encoder": name, "card": card}
            before = lpg_fused.launches
            outs = _forward(cfg, model, batch)
            check(lpg_fused.launches - before == 3, f"{name}: {lpg_fused.launches - before} K1 launches, not 3")
            check(all(tuple(o.shape) == (1, 1, H, W) for o in outs), f"{name}: shapes")
            check(bool(torch.isfinite(outs[4]).all()), f"{name}: non-finite depth")
            model.decoder.use_pallas = "never"
            plain = _forward(cfg, model, batch)
            model.decoder.use_pallas = cfg.use_pallas
            rows = []
            for i, (head, k) in enumerate((("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))):
                row = compare_lpg(outs[i][:, 0], plain[i][:, 0], fused_denominator(heads[head].permute(0, 2, 3, 1), k))
                check(row["within_rule"], f"{name}: LPG {k} kernel vs never {row}")
                rows.append(dict(row, k=k))
            rec["lpg_kernel_vs_never"] = rows
            rec["final_vs_never_max_rel_err"] = ((outs[4] - plain[4]).abs() / plain[4].abs()).max().item()
            check(bool(torch.allclose(outs[4], plain[4], rtol=1e-5, atol=0.0)), f"{name}: final vs never")
            gpu_small = _forward(cfg, model, small)
            cpu_small = next(predict(cfg, model.to("cpu"), [small], "cpu"))
            worst = 0.0
            for g, c in zip(gpu_small, cpu_small):
                g, scale = g.cpu(), c.abs().max().item()
                check(bool(torch.allclose(g, c, rtol=2e-4, atol=2e-4 * scale)), f"{name}: f32 GPU vs CPU at 64x96")
                worst = max(worst, (g - c).abs().max().item() / scale)
            rec["gpu_vs_cpu_64x96_max_err_over_scale"] = worst
            del model, heads
            cfg16 = cfg.replace(compute_dtype="bfloat16")
            model = create_model(cfg16, "cuda")
            for _ in range(2):
                _forward(cfg16, model, batch)
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(ENCODER_FORWARDS):
                t0 = time.perf_counter()
                _forward(cfg16, model, batch)
                times.append((time.perf_counter() - t0) * 1e3)
            rec["bf16_ms_per_forward"] = {"median": statistics.median(times), "min": min(times),
                                          "max": max(times), "n": len(times)}
            rec["bf16_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            emit(rec)
            del model
            torch.cuda.empty_cache()
        # per encoder: the f32 forward, the 64x96 one, 2 warm-up and the timed bf16 ones
    check(lpg_fused.launches == 3 * len(NEW_ENCODERS) * (4 + ENCODER_FORWARDS),
          f"{lpg_fused.launches} K1 launches in the encoders phase")
    return lpg_fused.launches


def phase_serve_b5(card: str) -> dict:
    """EfficientNet-B5 BTS serving at the b16 stream's shape: create_model +
    bts_test.predict, bts_size 512, 352x1216, b16, bf16, seeded weights.
    Every count set to 0 just before the run: 130 K7 (76 with SiLU) and 3 K1
    launches per forward; outputs finite, depth in (0, max_depth]; equal,
    bit for bit, to the same forward with every BatchNorm on its plain
    version (no K7 launch); the median ms of the timed forwards, images/s
    and the peak memory.  Returns K1's launches of the path."""
    from bts_tpu_torch.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.models.layers import BatchNorm
    from bts_tpu_torch.ops import bn_cuda
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused

    b, name = B5_SERVE_BATCH, "efficientnet_b5_bts"
    cfg = Config(mode="test", encoder=name, bts_size=512, max_depth=MAX_DEPTH, dataset="kitti",
                 input_height=H, input_width=W, compute_dtype="bfloat16", seed=0)
    model = create_model(cfg, "cuda")
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8), "focal": np.full(b, FOCAL, np.float32)}
    forwards = 3 + B5_SERVE_FORWARDS  # the checked one, 2 warm-up, the timed ones
    times = []
    lpg_fused.launches = 0
    with k7_counted("serve_b5") as k7:
        outs = _forward(cfg, model, batch)
        for i in range(forwards - 1):
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _forward(cfg, model, batch)
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
    check(k7.calls == BTS_BNS[name] * forwards, f"{name}: {k7.calls} BatchNorm calls took K7 in {forwards} forwards")
    check(lpg_fused.launches == 3 * forwards, f"{name}: {lpg_fused.launches} K1 launches in {forwards} forwards")
    rec = {"phase": "serve_b5", "encoder": name, "card": card, "batch": b, "compute_dtype": "bfloat16",
           "k7_launches_per_forward": k7.launches / forwards, "k1_launches_per_forward": lpg_fused.launches / forwards,
           "shapes": [list(o.shape) for o in outs]}
    check(all(tuple(o.shape) == (b, 1, H, W) for o in outs), f"{name}: shapes {rec['shapes']}")
    check(all(bool(torch.isfinite(o).all()) for o in outs[3:]), f"{name}: non-finite depth")
    depth = outs[4] / (FOCAL / 715.0873)  # before the focal scaling
    rec["final_depth_min_max"] = [depth.min().item(), depth.max().item()]
    check(0 < rec["final_depth_min_max"][0] and rec["final_depth_min_max"][1] <= MAX_DEPTH,
          f"{name}: depth range {rec['final_depth_min_max']}")
    rec["ms_per_forward"] = {"median": statistics.median(times), "min": min(times), "max": max(times),
                             "n": len(times)}
    rec["images_per_s"] = b * 1e3 / rec["ms_per_forward"]["median"]
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the same forward with every BatchNorm on its plain version
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = lambda x, act="none", m=m: bn_cuda.bn_act_plain(
                x, m.running_mean, m.running_var, m.weight, m.bias, m.eps, act)
    before = bn_cuda.bn_act.launches
    plain = _forward(cfg, model, batch)
    check(bn_cuda.bn_act.launches == before, f"{name}: the plain forward launched K7")
    rec["outputs_equal_to_plain"] = [bool(torch.equal(o, q)) for o, q in zip(outs, plain)]
    check(all(rec["outputs_equal_to_plain"]), f"{name}: K7's forward differs from the plain one "
                                              f"{rec['outputs_equal_to_plain']}")
    emit(rec)
    del model, outs, plain
    torch.cuda.empty_cache()
    return lpg_fused.launches


def nyu_config(**kw):
    """Config 3 (scripts/bench_suite.py:46-71, arguments/arguments_train_nyu.txt)."""
    from bts_tpu_torch.config import Config

    base = dict(mode="train", encoder="resnext101_bts", bts_size=512, max_depth=NYU_MAX_DEPTH,
                dataset="nyu", input_height=NYU_TRAIN_H, input_width=NYU_TRAIN_W, batch_size=NYU_B,
                compute_dtype="bfloat16", do_random_rotate=True, degree=2.5, learning_rate=1e-4,
                weight_decay=1e-2, adam_eps=1e-3, seed=0, device="cuda")
    base.update(kw)
    return Config(**base)


def nyu_batch(b: int, h: int, w: int, seed: int) -> dict:
    """Seeded synthetic NYU batch after the loader's border crop: uint8
    frames, dense depth in [0.2, 9.5) m."""
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
            "depth": rng.uniform(0.2, 9.5, (b, h, w)).astype(np.float32),
            "focal": np.full((b,), NYU_FOCAL, np.float32)}


def phase_train_nyu(card: str) -> dict:
    """Config 3 through create_model + Trainer: kernel path against
    use_pallas="never" (one f32 step, b2), the card against the CPU (one f32
    step at 64x96), then 2 warm-up and 10 timed b4 bf16 steps with 3 K1 and
    3 K2 launches each.  Returns the launches of those steps."""
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.training.trainer import Trainer

    set_float32_precision()
    rec = {"phase": "train_nyu", "card": card, "config": "config 3: resnext101_bts, bts_size 512, nyu "
           f"{NYU_CROP_H}x{NYU_CROP_W} uint8 -> {NYU_TRAIN_H}x{NYU_TRAIN_W}, rotate 2.5 deg, b{NYU_B}, "
           "bf16, no remat, AdamW lr 1e-4 wd 1e-2 eps 1e-3"}

    cfg = nyu_config(compute_dtype="float32", batch_size=2)
    batch = nyu_batch(2, NYU_CROP_H, NYU_CROP_W, seed=1)
    k1, k2 = lpg_fused.launches, lpg_fused_bwd.launches
    kmodel, kloss = one_step(cfg, "cuda", batch)
    check(lpg_fused.launches - k1 == 3 and lpg_fused_bwd.launches - k2 == 3, "kernel-path step launches")
    nmodel, nloss = one_step(cfg, "cuda", batch, use_pallas="never")
    gaps = grad_gaps(kmodel, nmodel)
    rec["kernel_vs_never_f32_b2"] = {"loss": kloss, "never_loss": nloss,
                                     "loss_rel_err": abs(kloss - nloss) / abs(nloss), **gaps}
    emit({"phase": "train_nyu_check", "kernel_vs_never_f32_b2": rec["kernel_vs_never_f32_b2"]})
    check(abs(kloss - nloss) <= 1e-4 * abs(nloss), f"loss kernel vs never {kloss} {nloss}")
    check(gaps["worst_gap"] <= 1e-3, f"gradient gap kernel vs never {gaps}")
    del kmodel, nmodel

    # the card against the CPU, f32, 64x96.  ResNeXt-101's gradient at this
    # size is set by f32 rounding: scaling every weight by 1 +- 2^-23 (one
    # ulp) moves the whole gradient by ~4e-2 with the loss bit-equal (on the
    # CPU, 1 thread against 4 moves it by 1.6e-2).  So the loss is held to
    # rtol 1e-5 and the whole gradient to the larger of the train phase's
    # 2e-2 and twice its movement under that one-ulp change on the card.
    cfg = nyu_config(compute_dtype="float32", batch_size=2, input_height=64, input_width=96)
    batch = nyu_batch(2, 80, 112, seed=2)
    gmodel, gloss = one_step(cfg, "cuda", batch)
    pmodel, _ = one_step(cfg, "cuda", batch, perturb=2**-23)
    ulp_gap = grad_gaps(pmodel, gmodel)["global_gap"]
    del pmodel
    cmodel, closs = one_step(cfg.replace(device="cpu"), "cpu", batch)
    gaps = grad_gaps(gmodel, cmodel)
    limit = max(2e-2, 2 * ulp_gap)
    rec["gpu_vs_cpu_f32_64x96_b2"] = {"loss": gloss, "cpu_loss": closs,
                                      "loss_rel_err": abs(gloss - closs) / abs(closs),
                                      "one_ulp_weight_change_global_gap": ulp_gap, "global_gap_limit": limit,
                                      **gaps}
    emit({"phase": "train_nyu_check", "gpu_vs_cpu_f32_64x96_b2": rec["gpu_vs_cpu_f32_64x96_b2"]})
    check(abs(gloss - closs) <= 1e-5 * abs(closs), f"loss GPU vs CPU {gloss} {closs}")
    check(gaps["global_gap"] <= limit, f"gradient gap GPU vs CPU {gaps}, limit {limit}")
    del gmodel, cmodel
    torch.cuda.empty_cache()

    # the main path: config 3 at b4, bf16
    cfg = nyu_config()
    batch = nyu_batch(NYU_B, NYU_CROP_H, NYU_CROP_W, seed=3)
    model = create_model(cfg, "cuda")
    trainer = Trainer(model, cfg, total_steps=1000, device="cuda")
    stats_before = [model.encoder.bn1.running_mean.clone(), model.decoder.bn5.running_var.clone()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
    times, losses = [], []
    with k7_counted("train_nyu", expect=0):  # train mode keeps the chain
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
    launches = {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches}
    steps = WARMUP_STEPS + TIMED_STEPS
    check(launches == {"lpg_fused": 3 * steps, "lpg_fused_bwd": 3 * steps},
          f"{launches} in {steps} steps, not 3 K1 and 3 K2 per step")
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(all(bool(torch.isfinite(p.grad).all()) for p in trainer.params), "non-finite gradients")
    moved = [not torch.equal(a, b) for a, b in
             zip(stats_before, [model.encoder.bn1.running_mean, model.decoder.bn5.running_var])]
    check(all(moved), "BN running statistics did not move")
    q = statistics.quantiles(times, n=4)
    med = statistics.median(times)
    rec.update(steps=steps, launches=launches, losses=losses, grad_norm=float(metrics["grad_norm"]),
               ms_per_step={"median": med, "q1": q[0], "q3": q[2], "n": len(times)},
               images_per_s=NYU_B * 1e3 / med, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    rec["profile_2_steps"] = profile_steps(trainer, batch)
    emit(rec)
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def _png_tree(root: Path, n: int, hw, dataset: str, seed: int) -> Path:
    """``n`` seeded frames and gt depth PNGs under ``root`` and their split
    file: NYU dense depth in [0.2, 9.5) m, KITTI ~5% of pixels in [1, 80) m."""
    from PIL import Image

    from bts_tpu_torch.data.depth_io import write_depth_png

    rng = np.random.default_rng(seed)
    (root / "rgb").mkdir(parents=True)
    (root / "gt").mkdir()
    focal = NYU_FOCAL if dataset == "nyu" else FOCAL
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(root / "rgb" / f"{i}.png")
        if dataset == "nyu":
            depth = rng.uniform(0.2, 9.5, hw)
        else:
            depth = rng.uniform(1.0, MAX_DEPTH, hw) * (rng.random(hw) < 0.05)
        write_depth_png(str(root / "gt" / f"{i}.png"), depth, dataset)
        lines.append(f"rgb/{i}.png gt/{i}.png {focal}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return root / "split.txt"


def metric_gaps(a, b, names) -> dict:
    return {n: abs(float(x) - float(y)) for n, x, y in zip(names, a, b)}


def phase_eval(card: str, kitti_model) -> dict:
    """The entry points on a synthetic NYU tree of 10 frames at 480x640:
    bts_main with the config-3 recipe for 4 steps and --do_online_eval
    --eval_freq 2 (b4: a padded tail of 2), bts_test on its abs_rel best
    checkpoint, bts_eval on the PNGs; online eval at b4 against b1 on that
    state in f32; then a KITTI online eval (KB crop, garg crop) of the config-4
    model ``kitti_model`` over 20 frames of 375x1242 at b16.  Returns the K1
    and K2 launches of the phase."""
    import tempfile

    from bts_tpu_torch.cli import bts_eval, bts_main, bts_test
    from bts_tpu_torch.config import parse_args
    from bts_tpu_torch.evaluation.metrics import METRIC_NAMES
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.utils.weights import load_state_dict, read_weights

    rec = {"phase": "eval", "card": card}
    evals = []
    online_eval = bts_main.online_eval

    def counted_eval(model, cfg, device, max_samples=0):
        """bts_main's online eval, with its K1 launches, batches and time."""
        before, t0 = lpg_fused.launches, time.perf_counter()
        results = online_eval(model, cfg, device, max_samples)
        seconds = time.perf_counter() - t0
        n = EVAL_FRAMES if cfg.dataset == "nyu" else KITTI_EVAL_FRAMES
        evals.append({"k1_launches": lpg_fused.launches - before, "batches": -(-n // cfg.batch_size),
                      "batch_size": cfg.batch_size, "seconds": seconds, "images_per_s": n / seconds,
                      "results": None if results is None else [float(v) for v in results]})
        return results

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp, contextlib.ExitStack() as k7:
        tmp = Path(tmp)
        split = str(_png_tree(tmp / "nyu", EVAL_FRAMES, (NYU_H, NYU_W), "nyu", seed=10))
        data = str(tmp / "nyu")
        logdir = tmp / "runs" / "nyu_c3"
        argv = ["@arguments/arguments_train_nyu.txt", "--encoder", "resnext101_bts", "--bts_size", "512",
                "--input_height", str(NYU_TRAIN_H), "--input_width", str(NYU_TRAIN_W), "--batch_size", str(NYU_B),
                "--num_epochs", "2", "--compute_dtype", "bfloat16", "--data_path", data, "--gt_path", data,
                "--filenames_file", split, "--log_directory", str(tmp / "runs"), "--model_name", "nyu_c3",
                "--log_freq", "2", "--use_native_loader", "never", "--do_online_eval", "--eval_freq", "2",
                "--data_path_eval", data, "--gt_path_eval", data, "--filenames_file_eval", split,
                "--min_depth_eval", "1e-3", "--max_depth_eval", "10", "--device", "cuda"]
        bts_main.online_eval = counted_eval
        lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
        k7.enter_context(k7_counted("eval"))  # to the end of the phase, as K1's count
        try:
            check(bts_main.main(argv) == 0, "bts_main")
        finally:
            bts_main.online_eval = online_eval
        train_launches = {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches}
        rec["bts_main"] = {"launches": train_launches, "online_evals": evals[:]}
        check(len(evals) == 2, f"{len(evals)} online evals in 4 steps at --eval_freq 2")
        for e in evals:
            check(e["k1_launches"] == 3 * e["batches"] == 9, f"online eval launches {e}")
            check(all(np.isfinite(e["results"])), f"online eval metrics {e}")
        best = json.loads((logdir / "best_eval.json").read_text())
        check(set(best) == set(METRIC_NAMES), f"best_eval.json {best}")
        for name, entry in best.items():
            check((logdir / "ckpt_best" / name / f"{entry['step']}.pt").exists(), f"ckpt_best/{name}")
        rec["best_eval"] = best

        # bts_test on the abs_rel best, in the online eval's batches, then bts_eval
        ckpt = str(logdir / "ckpt_best" / "abs_rel")
        common = ["--encoder", "resnext101_bts", "--bts_size", "512", "--dataset", "nyu", "--max_depth", "10",
                  "--data_path", data,
                  "--filenames_file", split, "--device", "cuda"]
        out = tmp / "pred"
        check(bts_test.main(common + ["--mode", "test", "--checkpoint_path", ckpt, "--batch_size", str(NYU_B),
                                      "--out_path", str(out), "--use_native_loader", "never"]) == 0, "bts_test")
        eval_argv = ["--dataset", "nyu", "--data_path", data, "--gt_path", data, "--filenames_file", split,
                     "--image_path", str(out / "raw"), "--min_depth_eval", "1e-3", "--max_depth_eval", "10"]
        scored = bts_eval.evaluate(parse_args(eval_argv, mode="eval"))
        check(bts_eval.main(eval_argv) == 0, "bts_eval")
        online = evals[best["abs_rel"]["step"] // 2 - 1]["results"]
        gaps = metric_gaps(scored, online, METRIC_NAMES)
        # the PNGs round each depth to 1 mm, a move of at most 0.5 mm: 2.5e-3
        # of the least gt depth (0.2 m), so 5e-3 of each continuous metric.
        # A move of 0.5 mm crosses a d1-d3 threshold only where gt lies within
        # 0.5 mm * 1.25 of threshold * prediction (or of prediction /
        # threshold): 2 mm of the 9.3 m over which gt is uniform, 2.2e-4 of
        # the pixels; the limit is 1e-3
        rule = {n: (5e-3 * abs(v) if n not in ("d1", "d2", "d3") else 1e-3) for n, v in zip(METRIC_NAMES, online)}
        rec["bts_eval_vs_online_eval"] = {"step": best["abs_rel"]["step"], "bts_eval": [float(v) for v in scored],
                                          "online_eval": online, "gap": gaps, "limit": rule}
        check(all(gaps[n] <= rule[n] for n in METRIC_NAMES), f"bts_eval vs online eval {gaps}")

        # online eval at b4 (padded tail of 2) against b1 on the same state, f32
        cfg = parse_args(argv, mode="train").replace(compute_dtype="float32")
        model = create_model(cfg, "cuda")
        load_state_dict(model, read_weights(ckpt)[0])
        r4 = counted_eval(model, cfg, "cuda")
        r1 = counted_eval(model, cfg.replace(batch_size=1), "cuda")
        gaps = metric_gaps(r4, r1, METRIC_NAMES)
        # f32 cuDNN may pick other algorithms per batch size: each depth moves
        # by ~1e-6 relative, so 1e-4 of each continuous metric, and a depth at
        # a d1-d3 threshold may flip: 2 pixels of a frame's eigen crop
        valid = 426 * 560  # every gt pixel of the eigen crop of a 480x640 frame is valid
        rule = {n: (1e-4 * abs(v) if n not in ("d1", "d2", "d3") else 2 / valid) for n, v in zip(METRIC_NAMES, r1)}
        rec["online_eval_b4_vs_b1_f32"] = {"gap": gaps, "limit": rule, "b4": evals[-2], "b1": evals[-1]}
        check(evals[-2]["k1_launches"] == 9 and evals[-1]["k1_launches"] == 3 * EVAL_FRAMES,
              f"f32 online eval launches {evals[-2:]}")
        check(all(gaps[n] <= rule[n] for n in METRIC_NAMES), f"online eval b4 vs b1 {gaps}")
        del model

        # KITTI: the config-4 state, KB crop, garg crop, padded back to 375x1242
        split = str(_png_tree(tmp / "kitti", KITTI_EVAL_FRAMES, KITTI_FULL, "kitti", seed=11))
        kcfg = train_config(do_kb_crop=True, garg_crop=True, data_path_eval=str(tmp / "kitti"),
                            gt_path_eval=str(tmp / "kitti"), filenames_file_eval=split, min_depth_eval=1e-3,
                            max_depth_eval=MAX_DEPTH)
        for _ in range(2):  # the second one timed
            results = counted_eval(kitti_model, kcfg, "cuda")
        rec["kitti_online_eval"] = evals[-1]
        check(results is not None and all(np.isfinite(results)), f"KITTI online eval {results}")
        check(all(e["k1_launches"] == 3 * -(-KITTI_EVAL_FRAMES // TRAIN_B) for e in evals[-2:]),
              f"KITTI online eval launches {evals[-2:]}")
    rec["launches"] = {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches}
    emit(rec)
    return rec["launches"]


def _http(port: int, path: str, data=None, accept=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _png(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def serve_requests(server, frames, focals, eager_depth, plain_depth, rule_m: float) -> dict:
    """``len(frames)`` concurrent POST /v1/depth to ``server`` (PNG bodies,
    ?focal=), half asking for .npy and half for the PNG; each answer against
    ``eager_depth`` (N, H, W) of its frame: .npy within ``rule_m`` metres,
    the PNG within 1 unit of depth_to_png; and against ``plain_depth``, the
    same forward through the plain versions: .npy by the final depth's rule
    (:func:`final_rule`), the PNG within 1 unit.  Returns the gaps, the
    device calls and K1 launches they took, requests/s and p50/p90
    latency."""
    import io

    from PIL import Image

    from bts_tpu_torch.data.depth_io import depth_to_png
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused

    port, batcher = server.server_address[1], server.batcher
    bodies = [_png(f) for f in frames]
    results = [None] * len(frames)

    def hit(i):
        t0 = time.perf_counter()
        accept = "application/octet-stream" if i % 2 == 0 else None
        results[i] = _http(port, f"/v1/depth?focal={focals[i]}", bodies[i], accept) + (
            (time.perf_counter() - t0) * 1e3,)

    calls, lpg_fused.launches = batcher.calls, 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(frames)) as pool:
        list(pool.map(hit, range(len(frames))))
    wall = time.perf_counter() - t0
    rec = {"requests": len(frames), "device_calls": batcher.calls - calls, "k1_launches": lpg_fused.launches,
           "requests_per_s": len(frames) / wall}
    npy_gap, png_gap, vs_plain, png_plain_gap = 0.0, 0, [], 0
    for i, (code, body, ctype, _) in enumerate(results):
        check(code == 200, f"request {i}: {code} {body[:200]}")
        if i % 2 == 0:
            check(ctype == "application/octet-stream", f"request {i}: {ctype}")
            npy = np.load(io.BytesIO(body))
            npy_gap = max(npy_gap, float(np.abs(npy - eager_depth[i]).max()))
            vs_plain.append(final_rule(torch.from_numpy(npy), torch.from_numpy(plain_depth[i])))
        else:
            check(ctype == "image/png", f"request {i}: {ctype}")
            png = np.array(Image.open(io.BytesIO(body))).astype(np.int64)
            png_gap = max(png_gap, int(np.abs(png - depth_to_png(eager_depth[i], "kitti").astype(np.int64)).max()))
            png_plain_gap = max(png_plain_gap, int(np.abs(
                png - depth_to_png(plain_depth[i], "kitti").astype(np.int64)).max()))
    latency = sorted(r[3] for r in results)
    q = statistics.quantiles(latency, n=10, method="inclusive")
    rec.update(npy_max_abs_err_m=npy_gap, npy_limit_m=rule_m, png_max_unit_gap=png_gap,
               npy_max_rel_err_vs_never=max(r["max_rel_err"] for r in vs_plain),
               png_max_unit_gap_vs_never=png_plain_gap,
               latency_ms={"p50": statistics.median(latency), "p90": q[8], "max": latency[-1]})
    check(npy_gap <= rule_m and png_gap <= 1, f"served depth against eager {rec}")
    check(all(r["within_rule"] for r in vs_plain) and png_plain_gap <= 1, f"served depth against never {rec}")
    check(rec["k1_launches"] == 3 * rec["device_calls"], f"K1 launches per device call {rec}")
    return rec


def phase_serving(card: str) -> dict:
    """The serving entry points on DenseNet-161, bts_size 512, KITTI, seeded
    weights, f32: an upstream-style full .pth -> bts_convert -> bts_export
    (352x1216, b4; then --fused_tail always) -> load_exported, against the
    eager predict of the same weights and against its plain versions
    (use_pallas="never"); bts_serve over HTTP from the artifact (16
    concurrent requests) and in process from the checkpoint (4), against
    both; bts_sequence over 10 frames of 375x1242 (KB crop, b4) against
    bts_test through the kernels and through the plain versions.
    Returns the launches of its three paths (export, serve_http, sequence)."""
    import contextlib
    import io
    import os
    import tempfile
    import threading

    from PIL import Image

    from bts_tpu_torch.cli import bts_convert, bts_export, bts_sequence, bts_serve, bts_test
    from bts_tpu_torch.cli.bts_test import predict
    from bts_tpu_torch.config import Config, adopt_sidecar_geometry, parse_args
    from bts_tpu_torch.models.bts import create_model, set_float32_precision
    from bts_tpu_torch.ops import tail_cuda
    from bts_tpu_torch.ops.lpg_cuda import fused_denominator, lpg_fused
    from bts_tpu_torch.utils.serving import load_exported
    from bts_tpu_torch.utils.weights import read_weights, restore_model

    set_float32_precision()
    rec = {"phase": "serving", "card": card, "config": f"densenet161_bts, bts_size 512, kitti {H}x{W}, "
           f"b{SERVE_B}, float32, seeded weights"}
    rule_m = 1e-4 * MAX_DEPTH  # the exported / served depth against the eager forward
    counters = {"lpg_fused": lpg_fused, "lpg_phase_planes": tail_cuda.lpg_phase_planes,
                "fused_tail": tail_cuda.fused_tail}
    launches = {path: dict.fromkeys(counters, 0) for path in ("export", "serve_http", "sequence")}

    def reset():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {n: c.launches for n, c in counters.items()}

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        common = ["--encoder", "densenet161_bts", "--bts_size", "512", "--max_depth", str(MAX_DEPTH),
                  "--dataset", "kitti", "--input_height", str(H), "--input_width", str(W),
                  "--compute_dtype", "float32", "--device", "cuda"]

        # 1. an upstream-style full .pth of the seeded model -> bts_convert
        src = create_model(Config(encoder="densenet161_bts", bts_size=512, max_depth=MAX_DEPTH,
                                  compute_dtype="float32", seed=0)).state_dict()
        upstream = {("module.encoder.base_model." + k[len("encoder."):]) if k.startswith("encoder.")
                    else "module." + k: v for k, v in src.items()}
        pth, ckpt = tmp / "bts_densenet161_kitti.pth", tmp / "converted"
        torch.save({"model": upstream, "global_step": 0}, pth)
        t0 = time.perf_counter()
        check(bts_convert.main(common + ["--torch_checkpoint", str(pth), "--checkpoint_path", str(ckpt)]) == 0,
              "bts_convert")
        restored, step = read_weights(str(ckpt))
        check(step == 0 and restored.keys() == src.keys() and all(torch.equal(restored[k], v) for k, v in src.items()),
              "bts_convert's checkpoint differs from the source weights")
        rec["convert"] = {"seconds": time.perf_counter() - t0, "tensors": len(src),
                          "pth_mb": os.path.getsize(pth) / 1e6,
                          "sidecar_encoder_pad": json.loads((ckpt / "config.json").read_text())["encoder_pad"]}
        check(rec["convert"]["sidecar_encoder_pad"] == "torch", "bts_convert's sidecar")
        pth.unlink()

        # the eager reference: the converted weights through bts_test.predict
        cfg = adopt_sidecar_geometry(Config(mode="test", encoder="densenet161_bts", bts_size=512,
                                            max_depth=MAX_DEPTH, dataset="kitti", input_height=H, input_width=W,
                                            batch_size=SERVE_B, compute_dtype="float32", checkpoint_path=str(ckpt)))
        check(cfg.encoder_pad == "torch", "the sidecar's geometry was not adopted")
        with contextlib.redirect_stdout(io.StringIO()):
            model = restore_model(cfg, "cuda")
        rng = np.random.default_rng(20)
        frames = rng.integers(0, 256, (SERVE_REQUESTS, H, W, 3), dtype=np.uint8)
        focals = rng.uniform(700.0, 725.0, SERVE_REQUESTS).astype(np.float32)

        heads = _heads(model)  # raw reduction outputs of the last forward, for K1's denominators
        lpg_heads = (("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))

        def eager(fused_tail="auto", use_pallas="auto", n=SERVE_REQUESTS):
            """bts_test.predict's five outputs over the first n frames at b4,
            and each head's K1 denominators (B, H, W)."""
            model.decoder.fused_tail, model.decoder.use_pallas = fused_tail, use_pallas
            outs, dens = [], []
            for i in range(0, n, SERVE_B):
                outs.append(next(predict(cfg, model, [{"image": frames[i:i + SERVE_B],
                                                       "focal": focals[i:i + SERVE_B]}], "cuda")))
                dens.append([fused_denominator(heads[name].permute(0, 2, 3, 1), k) for name, k in lpg_heads])
            model.decoder.fused_tail, model.decoder.use_pallas = "auto", cfg.use_pallas
            torch.cuda.synchronize()
            return [torch.cat(o) for o in zip(*outs)], [torch.cat(d) for d in zip(*dens)]

        # the kernels at the b4 352x1216 heads against their plain versions
        # (use_pallas="never") on the same frames: the maps by K1's rule, the
        # final depth by final_rule (the literal tail) or K6's rule (the
        # fused tail, scaled by max_depth and each frame's focal scale)
        focal_scale = torch.from_numpy(focals / 715.0873).cuda()[:, None, None, None]
        refs, kernel_vs_never = {}, {}
        for fused_tail in ("auto", "always"):
            n = SERVE_REQUESTS if fused_tail == "auto" else SERVE_B
            kern, dens = eager(fused_tail, n=n)
            before = counts()
            plain, _ = eager(fused_tail, "never", n=n)
            check(counts() == before, "use_pallas='never' launched a kernel")
            row = {"frames": n, "maps": [dict(compare_lpg(kern[i][:, 0], plain[i][:, 0], dens[i]), k=k)
                                         for i, (_, k) in enumerate(lpg_heads)]}
            if fused_tail == "auto":
                row["final"] = final_rule(kern[4], plain[4])
            else:
                row["d1x1"] = tail_gap(kern[3], plain[3])
                row["final"] = tail_gap(kern[4] / (MAX_DEPTH * focal_scale[:n]),
                                        plain[4] / (MAX_DEPTH * focal_scale[:n]))
            kernel_vs_never[fused_tail] = row
            emit({"phase": "serving_kernel_vs_never", "fused_tail": fused_tail, "card": card, **row})
            check(all(r["within_rule"] for r in row["maps"]) and row["final"]["within_rule"]
                  and row.get("d1x1", {"within_rule": True})["within_rule"],
                  f"--fused_tail {fused_tail}: b{SERVE_B} kernels vs never {row}")
            refs[fused_tail] = (kern[4][:, 0].cpu().numpy(), plain[4][:, 0].cpu().numpy())
            del kern, plain, dens
        rec["kernel_vs_never"] = kernel_vs_never
        eager_depth, plain_depth = refs["auto"]

        # 2. bts_export at b4 -> load_exported: 3 K1 per forward, against eager
        exports = {}
        for fused_tail in ("auto", "always"):
            art = tmp / f"densenet161_kitti_b{SERVE_B}_{fused_tail}.pt2"
            argv = common + ["--checkpoint_path", str(ckpt), "--batch_size", str(SERVE_B), "--export_path", str(art),
                             "--fused_tail", fused_tail]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                check(bts_export.main(argv) == 0, f"bts_export --fused_tail {fused_tail}")
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            serve = load_exported(str(art))
            load_s = time.perf_counter() - t0
            x, f = frames[:SERVE_B], focals[:SERVE_B]
            serve(x, f)  # warm-up
            torch.cuda.synchronize()
            reset()
            with k7_counted("export", expect=DENSENET161_BTS_BNS):
                got = serve(x, f)
            torch.cuda.synchronize()
            n = counts()
            for key in counters:
                launches["export"][key] += n[key]
            want, never = (r[:SERVE_B] for r in refs[fused_tail])
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                serve(x, f)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            exports[fused_tail] = {
                "summary": out.getvalue().strip().splitlines()[-1], "export_s": export_s, "load_s": load_s,
                "artifact_mb": os.path.getsize(art) / 1e6, "launches_per_forward": n,
                "max_abs_err_m_vs_eager": float(np.abs(got[..., 0].cpu().numpy() - want).max()),
                "limit_m": rule_m, "ms_per_b4_forward_median_of_5": statistics.median(times)}
            got, never = got[..., 0], torch.from_numpy(never).cuda()
            exports[fused_tail]["vs_never"] = (
                final_rule(got, never) if fused_tail == "auto" else
                tail_gap(got / (MAX_DEPTH * focal_scale[:SERVE_B, 0]), never / (MAX_DEPTH * focal_scale[:SERVE_B, 0])))
            emit({"phase": "serving_export", "fused_tail": fused_tail, "card": card, **exports[fused_tail]})
            expected = ({"lpg_fused": 3, "lpg_phase_planes": 0, "fused_tail": 0} if fused_tail == "auto"
                        else {"lpg_fused": 0, "lpg_phase_planes": 3, "fused_tail": 1})
            check(n == expected, f"exported forward, --fused_tail {fused_tail}: launches {n}")
            check(exports[fused_tail]["max_abs_err_m_vs_eager"] <= rule_m, f"exported vs eager {exports[fused_tail]}")
            check(exports[fused_tail]["vs_never"]["within_rule"], f"exported vs never {exports[fused_tail]}")
            del serve
            if fused_tail == "always":
                art.unlink()
        rec["export"] = exports
        literal = tmp / f"densenet161_kitti_b{SERVE_B}_auto.pt2"

        # 3. bts_serve: from the artifact (16 concurrent requests), then in process (4)
        http = {}
        for backend, extra in (("exported", ["--export_path", str(literal)]),
                               ("in_process", ["--checkpoint_path", str(ckpt), "--batch_size", str(SERVE_B)])):
            scfg = adopt_sidecar_geometry(parse_args(common + extra + ["--serve_port", "0", "--serve_linger_ms",
                                                                        str(SERVE_LINGER_MS)], mode="test"))
            with contextlib.redirect_stdout(io.StringIO()):
                server = bts_serve.make_server(scfg)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                port = server.server_address[1]
                code, body, _ = _http(port, "/healthz")
                health = json.loads(body)
                check(code == 200 and health == {"status": "ok", "batch": SERVE_B, "height": H, "width": W,
                                                 "needs_focal": True, "dataset": "kitti"}, f"healthz {code} {body}")
                n = SERVE_REQUESTS if backend == "exported" else SERVE_B
                serve_requests(server, frames[:SERVE_B], focals, eager_depth, plain_depth, rule_m)  # warm-up
                reset()
                with k7_counted("serve_http") as k7:
                    http[backend] = serve_requests(server, frames[:n], focals, eager_depth, plain_depth, rule_m)
                    if backend == "exported":  # the artifact's graph calls no module
                        k7.expect = DENSENET161_BTS_BNS * http[backend]["device_calls"]
                for key, v in counts().items():
                    launches["serve_http"][key] += v
            finally:
                t0 = time.perf_counter()
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            http[backend]["shutdown_s"] = time.perf_counter() - t0
            check(not thread.is_alive() and not server.batcher._thread.is_alive(), "bts_serve did not shut down")
            emit({"phase": "serving_http", "backend": backend, "card": card, **http[backend]})
        check(http["exported"]["device_calls"] < SERVE_REQUESTS, f"no micro-batching: {http['exported']}")
        rec["http"] = http
        literal.unlink()

        # 4. bts_sequence --do_kb_crop b4 over 10 frames of 375x1242 against bts_test
        seq_dir = tmp / "kitti_seq"
        (seq_dir / "rgb").mkdir(parents=True)
        frames_full = np.random.default_rng(21).integers(0, 256, (SEQ_FRAMES, *KITTI_FULL, 3), dtype=np.uint8)
        for i, img in enumerate(frames_full):
            Image.fromarray(img).save(seq_dir / "rgb" / f"{i:010d}.png")
        # focal 715.0873 scales bts_test's depth by exactly 1, as bts_sequence applies none
        (seq_dir / "split.txt").write_text("".join(f"rgb/{i:010d}.png None 715.0873\n" for i in range(SEQ_FRAMES)))
        run = common + ["--checkpoint_path", str(ckpt), "--do_kb_crop", "--batch_size", str(SERVE_B)]
        batches = -(-SEQ_FRAMES // SERVE_B)
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out, k7_counted("sequence"):
            check(bts_sequence.main(run + ["--image_path", str(seq_dir / "rgb"), "--out_path", str(tmp / "seq")]) == 0,
                  "bts_sequence")
        seq_s = time.perf_counter() - t0
        launches["sequence"] = counts()
        check(K7_PATHS["sequence"] == DENSENET161_BTS_BNS * batches, f"bts_sequence: {K7_PATHS['sequence']} K7")
        check(launches["sequence"]["lpg_fused"] == 3 * batches, f"bts_sequence launches {launches['sequence']}")
        # bts_test on the same frames through the kernels and through their
        # plain versions (--use_pallas never)
        gaps = {}
        for use_pallas in ("auto", "never"):
            before = counts()
            with contextlib.redirect_stdout(io.StringIO()):
                check(bts_test.main(run + ["--data_path", str(seq_dir), "--filenames_file", str(seq_dir / "split.txt"),
                                           "--out_path", str(tmp / use_pallas), "--use_native_loader", "never",
                                           "--use_pallas", use_pallas]) == 0, f"bts_test --use_pallas {use_pallas}")
            check(use_pallas == "auto" or counts() == before, "bts_test --use_pallas never launched a kernel")
            gaps[use_pallas] = 0
            for i in range(SEQ_FRAMES):
                seq = np.array(Image.open(tmp / "seq" / f"{i:010d}.png"))
                ref = np.array(Image.open(tmp / use_pallas / "raw" / f"rgb_{i:010d}.png"))
                check(seq.dtype == np.uint16 and seq.shape == (H, W), f"sequence PNG {i}: {seq.dtype} {seq.shape}")
                gaps[use_pallas] = max(gaps[use_pallas], int(np.abs(seq.astype(np.int64) - ref.astype(np.int64)).max()))
        rec["sequence"] = {"frames": SEQ_FRAMES, "batches": batches, "k1_launches": launches["sequence"]["lpg_fused"],
                           "png_max_unit_gap_vs_bts_test": gaps["auto"],
                           "png_max_unit_gap_vs_bts_test_never": gaps["never"], "seconds": seq_s,
                           "frames_per_s": SEQ_FRAMES / seq_s, "log": out.getvalue().strip().splitlines()[-1]}
        check(max(gaps.values()) <= 1, f"bts_sequence against bts_test: {rec['sequence']}")
    rec["launches"] = launches
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return launches


INPUT_STEPS, INPUT_NYU_FRAMES, INPUT_NYU_B = 12, 8, 4  # the input phase: bts_main steps, NYU parity frames, batch
INPUT_LOADER_EPOCHS = 9  # the input phase's loader timing: batches of each path (the first carries the start)
NAN_MODULE = "encoder.features.denseblock2.denselayer1.conv1"  # (d): the conv whose weight holds the NaN


def _input_argv(split: str, choice: str, runs: Path, name: str, steps: int, data: str = "") -> list:
    """bts_main with the config-4 recipe (@arguments/arguments_train_eigen.txt:
    DenseNet-161, b16, KB crop, 352x704, rotation <= 1 degree) on the card,
    bf16, remat 'layer', ``steps`` steps over a 16-frame split."""
    return ["@arguments/arguments_train_eigen.txt", "--device", "cuda", "--input_height", str(TRAIN_H),
            "--input_width", str(TRAIN_W), "--remat", "--remat_policy", "layer", "--compute_dtype", "bfloat16",
            "--num_epochs", str(steps), "--data_path", data, "--gt_path", data, "--filenames_file", split,
            "--use_native_loader", choice, "--log_directory", str(runs), "--model_name", name, "--save_freq", "1000"]


def _bts_main_run(argv: list) -> dict:
    """bts_main in this process; each step timed on the host clock around
    the step and a synchronize, with its loss; K1/K2 and K7 launches counted from 0."""
    from bts_tpu_torch.cli import bts_main
    from bts_tpu_torch.ops.lpg_cuda import lpg_fused, lpg_fused_bwd
    from bts_tpu_torch.training.trainer import Trainer

    times, losses = [], []
    train_step = Trainer.train_step

    def timed(self, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(self, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(out["loss"]))
        return out

    Trainer.train_step = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lpg_fused.launches, lpg_fused_bwd.launches = 0, 0
    t0 = time.perf_counter()
    try:
        with k7_counted() as k7:  # the summary forward's BatchNorms that take K7
            check(bts_main.main(argv) == 0, f"bts_main {argv}")
    finally:
        Trainer.train_step = train_step
    return {"seconds": time.perf_counter() - t0, "losses": losses, "times": times,
            "launches": {"lpg_fused": lpg_fused.launches, "lpg_fused_bwd": lpg_fused_bwd.launches},
            "k7_launches": k7.launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _loader_ms(cfg, epochs: int) -> dict:
    """Host ms between batches of ``prefetched`` drained as fast as it
    delivers (no consumer work), after the first batch."""
    from bts_tpu_torch.data.dataloader import BtsDataLoader

    times = []
    t = time.perf_counter()
    for _ in BtsDataLoader(cfg, "train").prefetched(num_epochs=epochs):
        now = time.perf_counter()
        times.append((now - t) * 1e3)
        t = now
    return _quartiles(times[1:])


def _same_batches(a: list, b: list, nyu: bool = False) -> dict:
    """Images, focals and KITTI depths bit for bit; NYU depths (native
    against PIL) within one ulp: the native loader multiplies the counts by
    float32(1/1000), PIL's path divides them by 1000."""
    check(len(a) == len(b) and len(a) > 0, f"{len(a)} batches against {len(b)}")
    ulps = 0
    for x, y in zip(a, b):
        check(x.keys() == y.keys(), f"keys {sorted(x)} {sorted(y)}")
        for k in x:
            if k == "depth" and nyu:
                ulps = max(ulps, int(np.abs(x[k].view(np.int32).astype(np.int64) - y[k].view(np.int32)).max()))
            else:
                check(np.array_equal(x[k], y[k]), f"{k} differs")
    check(ulps <= 1, f"NYU depths {ulps} ulps apart")
    return {"batches": len(a), "depth_max_ulps": ulps}


def phase_input(card: str, train_rec: dict) -> dict:
    """The input plane at config-4 width: (a) the native C++ loader against
    PIL, (b) ArrayRecord shards, (c) bts_main fed from each, (d)
    --debug_nans.  A leg this machine cannot run (no libpng/libjpeg to
    build the native library, no array_record) is named on its own line,
    with the reason, before the rest runs.  Returns the K1/K2 launches of
    the bts_main runs."""
    import tempfile

    from bts_tpu_torch.config import parse_args
    from bts_tpu_torch.data import native_loader as nl
    from bts_tpu_torch.data.dataloader import BtsDataLoader
    from bts_tpu_torch.models.bts import create_model

    rec = {"phase": "input", "card": card,
           "config": "config 4 (bts_main @arguments/arguments_train_eigen.txt, bf16, remat layer) on 16 synthetic "
                     f"KITTI {KITTI_FULL[0]}x{KITTI_FULL[1]} frames; NYU parity on {INPUT_NYU_FRAMES} "
                     f"{NYU_H}x{NYU_W} frames at b{INPUT_NYU_B}"}
    native = nl.available()
    try:
        import array_record  # noqa: F401

        records_missing = ""
    except ImportError as e:
        records_missing = str(e)
    if not native:
        # the compiler's first error line says which header or library is missing
        why = next((ln.strip() for ln in nl.unavailable_reason().splitlines() if "error" in ln),
                   nl.unavailable_reason()[:300])
        emit({"phase": "input", "leg_not_run": "(a) the native side of the loader parity and its timing; "
              "(c) bts_main with --use_native_loader always",
              "reason": f"the native loader (csrc/btsdata.cc) does not build on this machine: {why}"})
    if records_missing:
        emit({"phase": "input", "leg_not_run": "(b) ArrayRecord shards; (c) bts_main from records",
              "reason": f"the array_record package is not installed: {records_missing}"})
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        split = str(_png_tree(tmp / "kitti", DDP_FRAMES, KITTI_FULL, "kitti", seed=12))
        nyu_split = str(_png_tree(tmp / "nyu", INPUT_NYU_FRAMES, (NYU_H, NYU_W), "nyu", seed=13))
        data = str(tmp / "kitti")

        def cfg(choice, fn=split, dataset="kitti"):
            c = parse_args(_input_argv(fn, choice, tmp / "runs", "loader", 1, data), mode="train")
            if dataset == "nyu":  # the NYU layout: border crop, b4, max depth 10 m
                c = c.replace(dataset="nyu", do_kb_crop=False, batch_size=INPUT_NYU_B, max_depth=NYU_MAX_DEPTH,
                              data_path=str(tmp / "nyu"), gt_path=str(tmp / "nyu"))
            return c

        # (a) loader parity: one epoch, and a resume at step 3; then host ms per batch
        loader = {"dataloader_workers": cfg("never").dataloader_workers, "num_threads": cfg("never").num_threads}
        if native:
            for name, dataset, fn in (("kitti", "kitti", split), ("nyu", "nyu", nyu_split)):
                for start in (0, 3):
                    got = {c: list(BtsDataLoader(cfg(c, fn, dataset), "train").prefetched(num_epochs=1,
                                                                                          start_step=start))
                           for c in ("always", "never")}
                    loader[f"{name}_parity_start_{start}"] = _same_batches(got["always"], got["never"],
                                                                           nyu=dataset == "nyu")
        else:
            with_always = cfg("always")
            try:
                BtsDataLoader(with_always, "train").prefetched()
            except RuntimeError as e:
                loader["always_raises"] = str(e).splitlines()[0]
            check("always_raises" in loader, "--use_native_loader always did not raise without the library")
        for c in ("always", "never") if native else ("never",):
            loader[f"kitti_b16_host_ms_per_batch_{c}"] = _loader_ms(cfg(c), INPUT_LOADER_EPOCHS)
            loader[f"nyu_b{INPUT_NYU_B}_host_ms_per_batch_{c}"] = _loader_ms(cfg(c, nyu_split, "nyu"),
                                                                         INPUT_LOADER_EPOCHS)
        rec["loader"] = loader
        emit({"phase": "input_loader", **loader})

        # (b) records: shards of the same 16 frames, read through the loader
        runs = [("png_never", split, "never")] + ([("png_always", split, "always")] if native else [])
        if not records_missing:
            from bts_tpu_torch.tools import make_records

            check(make_records.main(["--filenames_file", split, "--data_path", data, "--gt_path", data,
                                     "--out", str(tmp / "rec" / "train"), "--shard_size", "8"]) == 0, "make_records")
            shards = str(tmp / "rec" / "train-*.array_record")
            recs = {}
            for start in (0, 3):
                tree = list(BtsDataLoader(cfg("never"), "train").prefetched(num_epochs=1, start_step=start))
                got = list(BtsDataLoader(cfg("auto", shards), "train").prefetched(num_epochs=1, start_step=start))
                recs[f"parity_start_{start}"] = _same_batches(got, tree)
            epochs = 4
            t = time.perf_counter()
            n = sum(len(b["image"]) for b in BtsDataLoader(cfg("auto", shards), "train").prefetched(num_epochs=epochs))
            recs["records_per_s"] = n / (time.perf_counter() - t)
            recs["records"] = n
            rec["records"] = recs
            runs.append(("records", shards, "auto"))

        # (c) bts_main for INPUT_STEPS steps, fed from each input
        train = {}

        def record(name, choice, r):
            timing = _quartiles(r["times"][WARMUP_STEPS:])
            train[name] = {"use_native_loader": choice, "first_loss": r["losses"][0], "losses": r["losses"],
                           "ms_per_step": timing, "images_per_s": TRAIN_B * 1e3 / timing["median"],
                           "peak_mem_gib": r["peak_mem_gib"], "launches": r["launches"],
                           "k7_launches": r["k7_launches"], "seconds": r["seconds"],
                           "first_two_step_ms": r["times"][:2]}
            emit({"phase": "input_train", "run": name, **train[name]})
            check(len(r["losses"]) == INPUT_STEPS and all(np.isfinite(r["losses"])), f"{name}: {r['losses']}")
            # 3 K1 + 3 K2 per step, and 3 K1 for the step-1 summary forward
            check(r["launches"] == {"lpg_fused": 3 * INPUT_STEPS + 3, "lpg_fused_bwd": 3 * INPUT_STEPS},
                  f"{name}: {r['launches']} in {INPUT_STEPS} steps")

        for name, fn, choice in runs:
            record(name, choice, _bts_main_run(_input_argv(fn, choice, tmp / "runs", name, INPUT_STEPS, data)))
        # the control: the same batches, decoded before the run and fed from
        # memory (no loader thread), so bts_main's cost apart from its input
        pre = list(BtsDataLoader(cfg("never"), "train").batches(num_epochs=INPUT_STEPS))
        prefetched = BtsDataLoader.prefetched
        BtsDataLoader.prefetched = lambda self, num_epochs=None, depth=2, start_step=0: (b for b in pre[start_step:])
        try:
            record("memory", "none: decoded before the run",
                   _bts_main_run(_input_argv(split, "never", tmp / "runs", "memory", INPUT_STEPS, data)))
        finally:
            BtsDataLoader.prefetched = prefetched
        del pre
        first = {name: t["first_loss"] for name, t in train.items()}
        check(len(set(first.values())) == 1, f"first losses differ: {first}")
        rec["train"] = train
        rec["train_phase_same_call"] = {k: train_rec[k] for k in ("ms_per_step", "images_per_s", "peak_mem_gib")}

        # (d) --debug_nans: two clean steps against the same two steps without
        # the flag, then a NaN planted in one conv weight, in a subprocess
        r = _bts_main_run(_input_argv(split, "never", tmp / "runs", "debug_nans", 2, data) + ["--debug_nans"])
        ref = train["png_never"]
        dn = {"ms_first_two_steps": r["times"], "ms_first_two_steps_without": ref["first_two_step_ms"],
              "losses": r["losses"], "losses_without": ref["losses"][:2], "launches": r["launches"],
              "k7_launches": r["k7_launches"]}
        check(r["losses"][0] == ref["first_loss"] and np.isfinite(r["losses"]).all(), f"--debug_nans: {dn}")
        # the hooks alone, autograd's anomaly mode left off: which of the two costs
        detect = torch.autograd.set_detect_anomaly
        torch.autograd.set_detect_anomaly = lambda mode, check_nan=True: contextlib.nullcontext()
        try:
            h = _bts_main_run(_input_argv(split, "never", tmp / "runs", "hooks", 2, data) + ["--debug_nans"])
        finally:
            torch.autograd.set_detect_anomaly = detect
        dn.update(ms_first_two_steps_hooks_only=h["times"], losses_hooks_only=h["losses"])
        check(h["losses"][0] == ref["first_loss"], f"--debug_nans, hooks only: {dn}")
        sd = create_model(train_config(device="cpu"), "cpu").encoder.state_dict()
        sd[NAN_MODULE.removeprefix("encoder.") + ".weight"][0, 0, 0, 0] = float("nan")
        torch.save(sd, tmp / "encoder_nan.pt")
        argv = _input_argv(split, "never", tmp / "runs", "nan", 1, data) + [
            "--debug_nans", "--pretrained_model", str(tmp / "encoder_nan.pt")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "bts_tpu_torch.cli.bts_main", *argv], capture_output=True,
                              text=True, timeout=600, cwd=Path(__file__).resolve().parent)
        raised = [ln for ln in proc.stderr.splitlines() if ln.startswith("FloatingPointError")]
        dn["nan_subprocess"] = {"exit": proc.returncode, "raised": raised, "seconds": time.perf_counter() - t0}
        rec["debug_nans"] = dn
        emit({"phase": "input_debug_nans", **dn})
        check(proc.returncode != 0 and raised == [f"FloatingPointError: --debug_nans: NaN in the output of "
                                                  f"{NAN_MODULE} (Conv2d)"],
              f"--debug_nans with a NaN in {NAN_MODULE}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    emit(rec)
    launches = {k: sum(t["launches"][k] for t in train.values()) + dn["launches"][k] + h["launches"][k]
                for k in ("lpg_fused", "lpg_fused_bwd")}
    K7_PATHS["input"] = sum(t["k7_launches"] for t in train.values()) + dn["k7_launches"] + h["k7_launches"]
    torch.cuda.empty_cache()
    return launches


def k7_numbers(per_bn: dict) -> dict:
    """K7's row of the result: DenseNet-161's b1 forward's BatchNorms, and
    under "efficientnet_b5_b16" EfficientNet-B5's b16 forward's (phase_bn,
    which checked every element equal to the chain's)."""
    def row(rec):
        return {"ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"], "library_ms": rec["library_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "share_of_bound": rec["share_of_bound"]}

    b5 = per_bn["efficientnet_b5_bts"]["b16"]
    return {"max_abs_err": 0.0, **row(per_bn["densenet161_bts"]["b1"]),
            "per": "352x1216 b1 serving forward: its 175 BatchNorms, bf16 (library: F.batch_norm + F.relu)",
            "efficientnet_b5_b16": dict(row(b5), launches=b5["kernel_launches"],
                                        per=f"352x1216 b16 EfficientNet-B5 serving forward: its {b5['calls']} "
                                            f"BatchNorms, {b5['silu']} with SiLU, bf16 "
                                            f"(library: F.batch_norm + F.silu or F.relu)")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from bts_tpu_torch.ops import _build, bn_cuda, lpg_cuda, tail_cuda  # fails outside a checkout of the repo

    card = card_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "card": card})
    # one nvcc per library, started together: the three sources and K6's
    # profiling build with stage clocks
    jobs = [(name, ()) for name in SOURCES] + [("fused_tail", ("K6_STAGE_CLOCKS",))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: _build.build(*job), jobs))
    built, clocks_lib = dict(zip(SOURCES, libs)), libs[-1].path
    lpg_cuda._lib()
    tail_cuda._lib()
    bn_cuda._lib()
    # K6 does its upconv and iconv1 on the tensor cores: HMMA in its SASS
    # (one instance for bf16 iconv2, one for f32)
    k6 = {"hmma_instructions": sass_count(built["fused_tail"].path, "fused_tail_kernel", "HMMA"),
          "ptxas": ptxas_report(built["fused_tail"].log, "fused_tail_kernel")}
    # registers and spills of each K1/K3 (lpg_fwd_kernel<kRaw, K, In>) and
    # K2/K4 (lpg_bwd_kernel<K, kPlane, ...>) instance, by demangled name
    lpg = {demangle(n): r for kernel in ("lpg_fwd_kernel", "lpg_bwd_kernel")
           for n, r in ptxas_report(built["lpg_fused"].log, kernel).items()}
    emit({"phase": "build", "sources": SOURCES, "kernels": {key: name for name, key, _, _ in KERNELS},
          "seconds": {**{n: b.seconds for n, b in built.items()}, "fused_tail_stage_clocks": libs[-1].seconds},
          "lpg_ptxas": lpg, "fused_tail_kernel": k6})
    check(len(k6["hmma_instructions"]) == 2 and all(n > 0 for n in k6["hmma_instructions"].values()),
          f"fused_tail_kernel without HMMA instructions: {k6['hmma_instructions']}")

    floors = phase_floor(card)
    phase_kernel(card, floors)
    per_step = phase_kernel_bwd(card)
    per_op, op_launches = phase_kernel_lpg(card, floors)
    per_tail = phase_tail(card, clocks_lib, floors)
    per_bn = phase_bn(card)
    phase_upconv(card)
    serve_launches = phase_slice(card)
    tail_launches = phase_slice_tail(card)
    train_rec, kitti_model = phase_train(card)
    train_launches = train_rec["launches"]
    ddp_launches = phase_train_ddp(card, train_rec)
    spatial_launches = phase_spatial(card, train_rec)
    phase_kernel_nyu(card)
    encoder_launches = phase_encoders(card)
    b5_launches = phase_serve_b5(card)
    nyu_launches = phase_train_nyu(card)
    eval_launches = phase_eval(card, kitti_model)
    del kitti_model
    serving = phase_serving(card)
    input_launches = phase_input(card, train_rec)
    paths = ("serve", "serve_tail", "train", "train_ddp", "spatial", "op", "encoders", "serve_b5", "train_nyu",
             "eval", "export", "serve_http", "sequence", "input")
    by_path = {name: dict.fromkeys(paths, 0) for name, _, _, _ in KERNELS}
    by_path["bn_act"].update(K7_PATHS)
    by_path["lpg_fused"].update(serve=serve_launches, serve_tail=tail_launches["lpg_fused"],
                                train=train_launches["lpg_fused"], train_ddp=ddp_launches["lpg_fused"],
                                encoders=encoder_launches, serve_b5=b5_launches,
                                train_nyu=nyu_launches["lpg_fused"], eval=eval_launches["lpg_fused"])
    by_path["lpg_fused"]["spatial"] = spatial_launches["lpg_fused"]
    by_path["lpg_fused_bwd"].update(train=train_launches["lpg_fused_bwd"],
                                    train_ddp=ddp_launches["lpg_fused_bwd"],
                                    spatial=spatial_launches["lpg_fused_bwd"],
                                    train_nyu=nyu_launches["lpg_fused_bwd"], eval=eval_launches["lpg_fused_bwd"])
    for name, n in input_launches.items():
        by_path[name]["input"] = n
    by_path["lpg_plane"]["op"] = op_launches["lpg_plane"]
    by_path["lpg_plane_bwd"]["op"] = op_launches["lpg_plane_bwd"]
    by_path["lpg_phase_planes"]["serve_tail"] = tail_launches["lpg_phase_planes"]
    by_path["fused_tail"]["serve_tail"] = tail_launches["fused_tail"]
    for path, counts in serving.items():
        for name, n in counts.items():
            by_path[name][path] = n
    check(all(sum(p.values()) > 0 for p in by_path.values()), f"a kernel of the main paths never launched: {by_path}")
    numbers = {
        "K1": dict(per_step["K1"]["bfloat16"], max_abs_err=per_step["K1"]["float32"]["max_abs_err"],
                   per="training step: the three config-4 heads, bf16 raw"),
        "K2": dict(per_step["K2"]["bfloat16"], max_abs_err=per_step["K2"]["float32"]["max_abs_err"],
                   per="training step: the three config-4 heads, bf16 raw"),
        "K3": dict(per_op["K3"], per="public op forward: the three 352x1216 b1 heads, f32 plane"),
        "K4": dict(per_op["K4"], per="public op backward: the three config-4 heads, bf16 plane "
                                     "(max_abs_err: f32 plane)"),
        "K5": dict(per_tail["K5"], per="fused-tail forward: the three 352x1216 b1 heads"),
        "K6": dict(per_tail["K6"], per="fused-tail forward, 352x1216 b1 (ms: through the wrapper, "
                                       "packed weights cached)"),
        "K7": k7_numbers(per_bn),
    }
    result = []
    for name, key, lib, replaces in KERNELS:
        t = numbers[key]
        result.append({"name": name, "route": "cuda", "source": SOURCES[lib], "replaces": replaces,
                       "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
                       "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
                       "per": t["per"], **{key: t[key] for key in ("kernel_only_ms", "share_of_bound", "floor_ms",
                                                              "efficientnet_b5_b16") if key in t}})
    emit({"kernels": result})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["train_ddp_rank"]:  # a rank of the train_ddp phase, started by torchrun
        sys.exit(ddp_rank(*sys.argv[2:]))
    if sys.argv[1:2] == ["spatial_rank"]:  # a rank of the spatial phase, started by torchrun
        sys.exit(spatial_rank(*sys.argv[2:]))
    sys.exit(main())
