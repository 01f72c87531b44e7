#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's ten main paths and holds them to the repository's own
bars: the render path — the pretrained lego coarse and fine networks
rendering a 256x256 frame with 64 stratified + 128 importance samples on
white, through ``nerf_rs_tpu_torch.render.render_image`` — the training
path — the JAX CLI's default job, a full-width 8x256 student distilled from
the lego networks at 4096 rays and 64 + 128 samples, through
``nerf_rs_tpu_torch.train.train_step`` and ``data.DistillationDataset`` —
and the accelerated render and serving path — bench.py's default: a 128^3
occupancy grid swept through K1, probe culling (32 probes, stride 4,
``accel_compact="off"``), ray packing, and the fused resampler K3, through
``render_image(grid=...)`` and the HTTP viewer (``api``, ``serve``) — and
the hash-grid family — the paper config (16 levels of 2^17 rows, F = 2,
resolutions 16-1024), distilled from the lego networks as ``train --model
hashgrid`` does, then rendered dense and through a grid of its own sigma,
through the hash-encode kernel — and the int8 W8A8 family — the lego
networks quantized after training and rendered through the int8 MLP kernel
(``render --impl int8``), and an 8x256 student distilled through the QAT
forward (``train --impl int8qat``) — and the checkpoint, dataset and
front-end slice — a nerf_synthetic scene learned through ``python -m
nerf_rs_tpu_torch train --data`` with checkpoints, resume and SIGTERM, then
rendered, exported, evaluated and served from its checkpoints — and
occupancy-culled, placement-aware training with the rest of the front ends
— the teacher_sp30 fine-tune through ``train --accel-every --accel-aabb
--accel-probes``, then ``verify``, ``extract`` and ``render --orbit
--trace-dir`` — and the data-parallel layer — the render, the bench's
accel frame and a training step split over the ranks of a
``torch.distributed`` world (``parallel/``), here a world of 1 under NCCL,
and ``train`` and ``render --sharded`` under torchrun — and the examples
gallery and the vendored networks' serving presets — every
``examples_torch/`` script as a user runs it, and bench.py's frontier
presets on ``assets/trained/`` at 800x800 against the lego teacher's
frame — and K1's wide envelope — the lego networks widened to width 512 and
384 and deepened to 20 layers, computing the same function, rendered
through ``render --weights`` (``--impl int8`` through the wide int8
kernel), and a 512-wide student trained, rendered, evaluated and served. Phases, each reported on its own line:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the fused MLP kernels K1 and K2 (both on the tensor cores, f32
   and bf16), the fused resampler K3, the hash encode and the int8 MLP
   kernel are compiled from the checkout's sources (one nvcc per source, in
   parallel); ``cuobjdump --dump-sass`` must show HGMMA (``wgmma``)
   instructions in both variants (sigma_only or not) of K1 f32 and bf16,
   of K1's wide bf16 kernel,
   of K1 f32's record mode (K2 f32's recompute) and of K2's bf16 kernel,
   narrow and wide, and of the wide K2's dW kernel in both modes,
   HMMA (``mma.sync``) instructions, every one tf32, in both variants
   of K2's f32 kernel, narrow and wide, and IGMMA (s8 ``wgmma``)
   instructions in both variants of both int8 kernels, narrow and wide;
   ptxas's registers and spills of the hash encode's four instances, K3's
   seven, the wide K1's six (bf16, sigma_only or not; f32 on the CUDA
   cores and its record mode, each sigma_only or not), the wide K2's ten
   (its two per-tile kernels, the f32 record's split into planes, its dW
   kernel and the dW sum in both modes, the small sums) and the wide int8
   kernel's two are printed, and a spill in any of them, or ptxas
   serializing the wgmmas of a wide K1, K2 or int8 kernel (its C75xx
   notes), fails; the build's time is printed beside the
   previous design's;
3. K1 against its plain PyTorch version at the render's shapes (8192 rays
   x 64 samples sigma-only, 8192 x 192 full), f32 and bf16, two calls
   bitwise equal; the kernel's and the plain version's f32 distance from
   the float64 evaluation (reported); bf16 sigma held to the float64
   evaluation, no further from it than the plain version
   (``fused_mlp.bf16_sigma_agrees``);
4. the f32 frame with K1: PSNR against the committed golden > 45 dB, and
   2 K1 launches per ray chunk, every one on the tensor cores;
5. the bf16 frame against the f32 frame, at BF16_FRAME_BAR_DB, every K1
   launch (2 a chunk) on the tensor cores;
6. the plain-PyTorch f32 frame against the kernel frame, >= 60 dB;
7. K1, plain and library-yardstick (``models.mlp.nerf_mlp`` in the same
   dtype) times at the phase-3 shapes, f32 and bf16, their shares of
   their bounds, and the 256x256 frame times (medians of 3) with the
   kernels and plain, f32 and bf16;
8. K2 against its plain version on what the training path hands it (the
   lego networks as students: coarse at 4096 x 64 and fine at 4096 x 192,
   both full), f32 and bf16: every leaf's gradient, d(points) and d(dirs)
   at BWD_BARS (f32 against float64; a sample where the kernel's forward
   put a mask f32 cannot resolve on the other side of zero with all of
   that forward's masks: ``kernel_mask_exact``), and two calls bitwise
   equal;
9. one training step from the same state and batch, kernels against the
   plain MLP: losses and parameters after the step;
10. 50 kernel steps from a random init: the loss falls, K2 launches twice
    a step and K1 four times (teacher and student, coarse and fine); then
    BF16_STEPS steps of the bf16 training path (``train --dtype
    bfloat16``): the loss stays finite, every K2 launch is bf16, two a step;
11. K2 times at the fine shape in both modes against their plain versions
    and their library yardsticks (autograd through ``models.mlp.nerf_mlp``
    in the same dtype), K1 f32 on the same samples (the f32 recompute's
    code alone), K2's peak scratch and its bounds by route,
    ms per step and rays/s for the kernel and the plain training paths,
    and one kernel step under ``torch.profiler`` (idle share, top kernels);
12. K3 against its plain version on what the render hands it (the f32
    coarse pass of RAY_CHUNK golden-camera rays), at (64, 128) and
    (32, 64), with the scalar far and with the per-ray far of
    ``accel_sample_aabb``: rows sorted, every entry within a coarse bin
    of the plain version, 99% within 5e-5 + 1e-5 |t|, two calls bitwise
    equal;
13. the 256x256 f32 accel frame: PSNR against the committed golden
    > 45 dB, K3 once and K1 twice per rendered chunk, every hit ray
    bitwise the unpacked accel frame's;
14. the 800x800 frames (bench.py's size, 16384-ray chunks): f32 accel+K3
    against f32 dense >= 40 dB (bench.py's accel bar), bf16 accel+K3
    against f32 accel+K3 at BF16_FRAME_BAR_DB, and the share of rays
    packed away;
15. serving: the port's HTTP handler on a loopback port answers three
    256x256 /render requests with the bytes of ``render_image`` for each
    seed, and a bad size with 400;
16. times: K3 and the plain chain per call at 16384 x (64, 128), the grid
    build, the 800x800 f32 frames dense, accel with the plain chain and
    accel with K3, the 800x800 bf16 accel+K3 frame, and the device idle
    shares of the accel+K3 frames;
17. the hash encode against its plain version on the render's points
    (16384 golden-camera rays x 64 and x 192), tables U(-1, 1), at the
    paper config and at L = 4, F = 8, f32 and bf16: f32 within 1e-5 x
    max |table|, bf16 within 2 bf16 ulps of max |feature|, two calls
    bitwise equal;
18. one hash-grid step with the kernel against one with the plain encode
    (loss and parameters, phase 9's bars), then HASH_STEPS distillation
    steps from a random init at 4096 rays, 64 + 128, f32, the teacher
    through K1: the loss falls, the encode launches twice a step;
19. frames of the trained field: 256x256 and 800x800 f32 dense with the
    kernel against the plain encode (>= 60 dB), bf16 against f32 (>=
    BF16_FRAME_BAR_DB), the 800x800 accel+K3 frame on a 128^3 grid from
    ``accel.hashgrid_grid_kwargs`` against the dense frame (>= 40 dB),
    PSNR against the lego teacher's frames (reported); two encode
    launches per rendered chunk;
20. times: the encode kernel, its plain version, its bound and one
    ``index_select`` of the same rows (the library yardstick) per call at
    the main path's four shapes — the training step's 4096 rays x 64 and
    x 192 along its own rays, the 800x800 frame's 16384 x 64 and x 192 a
    chunk — f32 and bf16, rows gathered per second; the train step with
    the kernel and with the plain encode, the 800x800 frames dense and
    accel+K3 with their idle shares and top device kernels;
21. the int8 kernel against its plain version on phase 3's inputs (coarse
    sigma-only at 8192 x 64, fine full at 8192 x 192): sigma bitwise
    equal, rgb within 2e-6, two calls bitwise equal, and its outputs'
    sha256 the parent's (NARROW_INT8_SHA256); then the wide int8 kernel
    (``csrc/int8_mlp_wide_tc.cu``, past width 256 or depth 16) at the same
    bars on the same inputs, sigma-only and full, on the lego widened by
    ``widen_nerf`` to WIDE_INT8_LEGOS and on the random networks
    WIDE_INT8_RANDOM, every call a wide launch;
22. the post-training int8 256x256 frame: against the f32 K1 frame (> 25
    dB), against the plain int8 frame (>= 60 dB), two int8 launches per
    chunk and no K1; the int8 accel+K3 frame on phase 12's grid against
    the dense int8 frame (>= 40 dB);
23. QAT_STEPS int8qat distillation steps from a random init (8x256, 4096
    rays, 64 + 128, the teacher through K1): the loss falls, K1 launches
    only for the teacher, K2 and the int8 kernel never; the trained
    student's int8 kernel frame against its int8qat frame (>= 40 dB), and
    against the lego teacher's (reported);
24. times: the int8 kernel, its plain version and ``torch._int_mm`` of the
    same layers at the phase-21 shapes, the wide int8 kernel likewise and
    with its bound on the lego widened to 512/256/8 (fine full, coarse
    sigma-only) and 384/192/8 (fine full), the int8 frame with the kernel and
    the plain version, the int8 frame under ``torch.profiler`` (device busy,
    idle share, top kernels), the int8qat step and its peak memory;
25. checkpoints, data and front ends, through ``nerf_rs_tpu_torch.cli.main``
    at the train defaults (8x256, 4096 rays, 64 + 128, f32, K1 and K2): a
    scene of 16 200x200 views of the lego networks (K1 f32, the port's PNG
    writer, ``transforms_train.json``); ``train --data`` for 40 steps with a
    checkpoint every 20 (the loss falls, K1 and K2 twice a step: no
    teacher), resumed to 60 ("resumed from ... at step 40"); ``render
    --checkpoint`` bitwise the render of the in-memory state the CLI saved,
    ``export`` + ``render --weights`` bitwise the same, ``evaluate
    --checkpoint-dir`` (PSNR reported), one ``/render`` of ``serve``'s
    handler after ``api.init_renderer(checkpoint=...)`` the same bytes; a
    ``train`` subprocess stopped by SIGTERM after its first step (exit 0, a
    final checkpoint of step >= 1, killed and failed at 120 s); ``train
    --model hashgrid --data`` for 20 steps and its checkpoint rendered with
    the encode kernel (2 launches a chunk) against the plain encode (>= 60
    dB); times: the dataset load, a step on ``--data``, a checkpoint's save
    and restore, SIGTERM to exit;
26. occupancy-culled, placement-aware training and the rest of the front
    ends, through ``nerf_rs_tpu_torch.cli.main``: the teacher_sp30 recipe
    (``train --init-weights assets/lego_rust --fine-samples 0
    --teacher-samples 64,128 --accel-every 25 --accel-warmup 0 --accel-aabb
    --accel-probes 128 --accel-pad 4 --lr 1e-4``, 8x256, 4096 rays, f32)
    for SP_STEPS steps: the loss falls, a grid refresh every 25 steps (each
    a rebuild or one of JAX's dense fallbacks), K1 three times a step, 16
    times a refresh and twice for the batch the loop draws past its last
    step, K2 once a step; the
    single-pass probe-placed 256x256 frame against the teacher's 64+128
    before and after (``evaluate``, reported); one culled step from the same
    state, batch and 128^3 grid, kernels against the plain MLP (64+128
    mask-only, and the recipe's 64+0 under 128-probe placement: phase 9's
    bars); times, ABBA: the dense step, the culled step mask-only and with
    scatter and gather compaction (capacities from
    ``accel.capacities_from_occupancy`` and from the live rows), one grid
    refresh; ``train --model hashgrid`` and ``--impl int8qat`` under
    ``--accel-every`` (the refreshes ran, the encode's launches); ``verify
    --impl pallas --image --image-full`` in f32 and ``--image`` in bf16;
    ``extract`` at 128^3 (K1 bf16 sigma-only: cells on the other side of the
    iso level against the plain f32 lattice, at most EXTRACT_FLIP_BAR of
    the cells next to the surface); ``render --orbit 4 --trace-dir``: frame
    0 bitwise the plain render, K1's kernel in the Chrome trace;
27. the parallel layer in a world of 1 under NCCL on the card: (a) the
    256x256 f32 golden frame through ``render_image_sharded``, bitwise
    ``render_image``, one all-gather, K1 twice a chunk on the tensor cores;
    (b) the 800x800 bf16 accel+K3 frame (32 probes, stride 4, packing)
    through the sharded culled path, bitwise the single-device frame, one
    all-gather, K3 once and K1 twice per rendered chunk; (c) one
    ``sharded_train_step`` at 4096 rays 64+128 f32, bitwise ``train_step``
    from the same state and batch, one all-reduce, K2 twice; (e) times:
    the sharded and single-device frame and step in turns (medians of 10),
    the step's pooling and the collectives alone, NCCL's start-up (medians
    of 3); (d) ``train --steps 40`` under
    ``torch.distributed.run --nproc-per-node 1`` (exit 0, the loss falls),
    then in this process ``train`` in a world of 1 from torchrun's
    variables against plain ``train`` over the same steps, in turns, with
    their steady step times, and ``render --sharded`` under torchrun (the
    unsharded render's bytes);
28. the examples and the vendored presets: (a) every ``examples_torch/``
    script in a process of its own (the four that launch no kernel two
    at a time beside the others), at the JAX script's defaults (01 and
    08 with ``--impl pallas``, 02 in f32 and in bf16; 04 and 06 start one
    rank a card under NCCL through torchrun), through a runner that
    prints the kernels' launch counts: exit 0, its key lines (01's PNG
    > 45 dB from the golden, 02's deviations within phase 3's bars of
    its dtype, 03's losses finite and its export of the reference's
    shapes, 04 and 06 bitwise, 05 >= 40 dB and packed bitwise, 08's 12
    frames, the first > 45 dB from the plain path's frame, 07's
    ratio, 09's PSNR and 11's losses and PSNR finite, 10's mesh not
    empty, 12's PTQ frame > 25 dB from the f32 frame and its QAT losses
    finite, 13's PNG), every K1 launch on the tensor cores, the kernels
    it should reach launched, its wall time (overlapped, reported); then the hash encode
    against its plain version at 11's table and level shapes; (b)
    PRESETS at 800x800, each on a 128^3 grid of its own field with
    bench.py's accel defaults through bf16 K1, against the lego
    teacher's 64+128 bf16 frame (the same key): every K1 call of the
    teacher frame and of each preset's grid sweeps and frame recorded and
    held to its plain version by network and mode (``k1_bf16_witness``:
    phase 3's bf16 witness over the path's own inputs, sigma and rgb);
    PSNR at its bar, K1 launches as the grid and the rendered chunks
    need, every one on the tensor cores; the frame time (median of
    PRESET_REPS) and rays/s, and one frame under ``torch.profiler``
    (idle share, top kernels); (c) the sp29 preset at 256x256 in f32: K1
    frame against the plain frame (>= 60 dB), one K1 launch a rendered
    chunk. Comparison and timing launches do not count;
29. K1's and K2's wide envelope (K1: ``fused_mlp_wide_tc.cu``, bf16 on
    the tensor cores in thread-block clusters, and ``fused_mlp_wide_f32.cu``,
    f32 on the CUDA cores; K2: ``fused_mlp_wide_bwd_bf16.cu`` and, after the
    wide f32 forward's record pass, ``fused_mlp_wide_bwd_tc.cu``): (a) the lego networks widened by ``widen_nerf`` (same function)
    to (width, v_width, depth) = (512, 256, 8), (384, 192, 8) and (512,
    256, 12), through ``render --weights DIR --impl pallas``: f32 256x256
    64+128 > 45 dB from the golden and >= 60 dB from ``--impl xla``, no
    note, every K1 launch wide (2 a chunk); at (512, 256, 8) the bf16 frame
    >= BF16_FRAME_BAR_DB from the f32 frame, and the 800x800 bf16 accel
    frame (128^3 grid through wide K1 sigma-only, 32 probes at stride 4,
    packing, K3) >= 40 dB from the dense bf16 frame; (b) random networks
    at WIDE_RANDOM, 8192 x 64 sigma-only and 8192 x 192 full, f32 within
    TOLERANCES, bf16 rgb within 2e-2 and sigma by the bf16 witness, reruns
    bitwise; (c) wide K2 against its plain version at the training path's
    inputs on the widened legos (fine and coarse full, coarse sigma-only),
    at phase 8's bars, and K2 bf16 on the random 512/512/32 network of
    ``tests/test_torch_cuda.py``'s card case (37 x 29 samples),
    full and sigma-only at the 32-deep bf16 bar (each gradient within
    max(3e-2, 1.5 x the plain version's distance) of the float64
    evaluation, the kernel's largest distance no larger than the plain
    version's, the distance from plain reported); one 512/256/8 step
    against the plain step at phase
    9's bound; ``train --width 512 --v-width 256`` for WIDE_STEPS f32 and
    WIDE_BF16_STEPS bf16 steps through wide K1 and wide K2 with no note,
    then ``render --checkpoint`` through wide K1 without a note,
    ``evaluate`` (PSNR finite) and one ``/render`` of ``serve``'s handler
    byte for byte ``pixels_to_rgba(render_image(...))``; (d) ``render
    --impl int8`` of the lego widened to 512/256/8 and 512/256/12 through
    the wide int8 kernel: no note, two wide int8 launches a chunk, >= 60 dB
    from the plain int8 frame, > 25 dB from its f32 frame; (e) K1 past
    width 512, the wide1k pair (``fused_mlp_wide1k_f32tc.cu``, split-f32
    ``wgmma``, and ``fused_mlp_wide1k_tc.cu``, both on the tensor cores):
    the lego widened 4x to WIDE1K_LEGO through ``render --weights``, f32 >
    45 dB from the golden and >= 60 dB from ``--impl xla``, bf16 >=
    BF16_FRAME_BAR_DB from f32, no note, every K1 launch a wide1k launch on
    the tensor cores (2 a chunk); its bf16 grid and 256x256 accel+K3 frame
    >= 40 dB from the dense bf16 frame; one bf16 ``/render`` byte for byte;
    the pair against plain on WIDE1K_RANDOM and the widened lego at (b)'s
    bars, every call a wide1k launch; times at 1024/512/8, each kernel
    and its library call in turns; (f) K2 past width 512 (the wide1k pair
    in record mode, ``fused_mlp_wide1k_bwd.cu``, the dW kernel): random
    WIDE1K_K2_RANDOM and the lego widened to WIDE1K_LEGO on 37 x 29
    samples, f32 and bf16, full and sigma-only, at (c)'s bars (bf16 on the
    32-deep network at the float64 one), every call a wide1k launch; one
    f32 step of a 1024/512/8 student on WIDE1K_STEP_RAYS rays, kernels,
    plain and float64 steps on the same fine samples: the kernel step
    within 1e-5 of the float64 step's loss, 2 lr of its parameters, and
    off it by more than 1e-5 on no larger a share of entries than
    max(plain's, 1e-3); ``train --width 1024 --v-width 512`` for
    WIDE1K_TRAIN_STEPS f32 and bf16 steps with no note, two wide1k K1 and
    two wide1k K2 launches a step, finite losses, and its checkpoint
    through ``render --checkpoint`` (two wide1k launches a chunk); times
    in turns with autograd through ``models.mlp.nerf_mlp`` at the
    training path's fine and coarse sigma-only calls, the plain version,
    bounds and peak scratch; (g) times:
    K1 f32 and bf16 at (512, 256, 8) full and sigma-only and at (384, 192,
    8) full, wide K2 at the fine training call, each beside the plain
    version, the library call and the bound, wide K2 f32 with its record
    pass's share (one call under ``torch.profiler``), and the widened
    lego's frames (f32, bf16, int8 with the wide int8 kernel and plain).

Any failed phase exits non-zero. The line before the last is a JSON
summary of the kernels, each with its bound (the larger of its bytes over
the memory rate and its operations over the peak for their type through
the kernel's route — K1 f32 and wide1k f32 six bf16 passes a product
(split-f32), wide1k K2 f32 its recompute and dW so and its W dz as
3xTF32, bf16
for K1 bf16 and K2's bf16 mode, K2's f32 mode its recompute as K1 f32
and its dW and W dz as 3xTF32 at the tf32 peak (the f32 entries also
carry their all-CUDA-core bound), f32 on the CUDA cores for K3 and the
hash encode and K1's wide f32 kernels, bf16 for K1's wide bf16 kernels,
int8 for the int8 kernels — from this run's shapes; the hash encode's entry
also lists its four shapes in both dtypes, the wide kernels' their three,
the wide1k kernels' their two);
the last line is the JSON device record.
Never imports JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H = W = 256
N_COARSE, N_FINE = 64, 128
RAY_CHUNK = 8192
GOLDEN_PPM = REPO / "tests" / "goldens" / "lego_256x256_64c128f_key0.ppm"
GOLDEN_BAR_DB = 45.0           # tests/test_render.py's bar for this golden
PLAIN_BAR_DB = 60.0
# The JAX package's own bf16 drift, measured once on the CPU: its XLA path
# rendered the lego at 64x64 with 16+32 samples, seed 0, in bfloat16 and in
# float32, 33.90 dB apart. This bar is that value less 3 dB.
BF16_FRAME_BAR_DB = 30.9
# Kernel against plain version. f32: only the summation order differs.
# bf16: the bars tests/test_fused_mlp.py sets for two bf16 orderings; every
# rgb within its bar, sigma as ``fused_mlp.bf16_sigma_agrees`` holds it (a
# bar on every sample holds only for the plain version's own summation
# order: its f32 sums already leave samples of phase 3's inputs outside
# these bars of the same function evaluated in float64; PERF.md).
TOLERANCES = {
    "float32": {"rgb_atol": 1e-4, "sigma_atol": 1e-3, "sigma_rtol": 1e-4},
    "bfloat16": {"rgb_atol": 2e-2, "sigma_atol": 2e-2, "sigma_rtol": 2e-2},
}
# K2 against its plain version, per gradient (every leaf, d(points),
# d(dirs)), as ||g_k - g_p|| / ||g_p||. bf16: 3e-2, where the sums' order
# flips the bf16 rounding of a layer's output gradient. f32: the two differ
# by summation order only, but on the fine network's training inputs f32
# itself is that coarse — each lies ~2.5e-4 from the same function in
# float64 (measured on an H100 80GB HBM3; PERF.md) — so each gradient of K2 is held to the
# float64 evaluation instead: within 1e-4 of it, or no further from it
# than F32_VS_PLAIN times the plain version is. K2 differentiates its own
# forward, so a sample where that forward put a ReLU mask f32 cannot
# resolve on the other side of zero is evaluated with all of the
# forward's masks (kernel_mask_exact).
BWD_BARS = {"float32": 1e-4, "bfloat16": 3e-2}
F32_VS_PLAIN = 1.5
# A ReLU mask f32 cannot resolve: its pre-activation within MASK_TAU x
# (|b| + sum |w_i x_i|) of zero, 16 f32 units in the last place of the
# terms' size (unresolved_masks).
MASK_TAU = 2.0 ** -20
TRAIN_RAYS = 4096              # the JAX CLI's train defaults (nerf_rs_tpu/cli.py)
TRAIN_STEPS = 50
BF16_STEPS = 10                # the bf16 training path, K2's bf16 mode
# The accel path as bench.py runs it by default (bench.py:536-543).
BENCH_SIZE, BENCH_CHUNK = 800, 16384
GRID_RES, PROBES, STRIDE = 128, 32, 4
ACCEL_BAR_DB = 40.0            # bench.py's accel frame against the dense frame
# K3 against its plain version: tests/test_resample.py's bars.
K3_ATOL, K3_RTOL, K3_SHARE = 5e-5, 1e-5, 0.99


class PhaseFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return -10.0 * math.log10(max(mse, 1e-20))


def timed_ms(fn, reps: int = 3, inner: int = 1, warm: bool = True) -> float:
    """Median wall time of ``reps`` runs after one warm-up (unless the
    caller has just run ``fn``), each run ``inner`` calls bracketed by
    device synchronizations; per call."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise PhaseFailure("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise PhaseFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("1 device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), device 0: {name}")
    print(card, flush=True)
    return name, card


def phase_build():
    from nerf_rs_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    names = ", ".join(src.name for src in _build.sources())
    say("2 build", f"{names} built and loaded in {secs:.1f} s ({_build.library_path().name}; "
        f"the build before the dW kernel: {PARTIALS_BUILD_S} s)")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        injected = 0
        for line in log.read_text().splitlines():
            entry = re.search(r"entry function '.*?(fused_mlp_bwd_tc_kernel|fused_mlp_tc_kernel|"
                              r"fused_mlp_bwd_bf16_kernel|fused_mlp_wide_tc_kernel|"
                              r"fused_mlp_wide_f32_kernel|fused_mlp_wide_bwd_tc_kernel|"
                              r"fused_mlp_wide_bwd_bf16_kernel|fused_mlp_wide_dw_kernel|"
                              r"dw_sum_kernel|small_sum_kernel|record_planes_kernel|"
                              r"fused_mlp_f32tc_kernel|reduce_partials|resample_kernel|"
                              r"hash_encode_kernel|int8_mlp_tc_kernel|int8_mlp_wide_tc_kernel|"
                              r"fused_mlp_wide1k_tc_kernel|fused_mlp_wide1k_f32tc_kernel|"
                              r"fused_mlp_wide1k_bwd_kernel)"
                              r"(I\w*?L[bi][0-9]E)?", line)
            if "(C7519)" in line:              # an arrive ptxas adds before a wgmma
                injected += 1
            elif entry:
                say("2 build", "ptxas: " + "".join(g for g in entry.groups() if g))
            elif "registers" in line or "spill" in line or "wgmma" in line:
                say("2 build", "ptxas: " + line.strip())
        say("2 build", f"ptxas: {injected} warpgroup.arrive injected before wgmmas (C7519)")
        usage = ptxas_usage(log.read_text(), GATHER_KERNELS)
        say("2 build", "ptxas, the hash encode and K3: " + "; ".join(
            f"{name} {regs} registers, spill stores {st} B, loads {ld} B"
            for name, (regs, st, ld) in sorted(usage.items())))
        spilled = [name for name, (_, st, ld) in usage.items() if st or ld]
        if len(usage) != 4 + 7 or spilled:
            raise PhaseFailure(f"the hash encode (4 instances) and K3 (7) as built: "
                               f"{sorted(usage)}; spilled: {spilled}")
        # The wide K1, K2 and int8 kernels: no spill and no serialized
        # wgmmas (ptxas's C75xx notes name the function) in any of them.
        for label, pattern, instances in (("K1", WIDE_K1_KERNELS, WIDE_K1_INSTANCES),
                                          ("K2", WIDE_K2_KERNELS, WIDE_K2_INSTANCES),
                                          ("int8", WIDE_INT8_KERNELS, 2),
                                          ("K1 past width 512", WIDE1K_K1_KERNELS, 4),
                                          ("K2 past width 512", WIDE1K_K2_KERNELS, 4)):
            wide = ptxas_usage(log.read_text(), pattern)
            serialized = sorted({m.group(1) + m.group(2) for m in re.finditer(
                r"wgmma\.mma_async instructions are serialized.*?" + pattern,
                log.read_text())})
            say("2 build", f"ptxas, the wide {label}: " + "; ".join(
                f"{name} {regs} registers, spill stores {st} B, loads {ld} B"
                for name, (regs, st, ld) in sorted(wide.items()))
                + f"; wgmmas serialized in {serialized or 'none'}")
            spilled = [name for name, (_, st, ld) in wide.items() if st or ld]
            if len(wide) != instances or spilled or serialized:
                raise PhaseFailure(f"the wide {label} as built: {sorted(wide)}; spilled: "
                                   f"{spilled}; wgmmas serialized: {serialized}")
    sass = tensor_core_instructions(_build)
    say("2 build", "tensor-core instructions in the SASS: " + ", ".join(
        f"{re.search(TC_KERNEL, fn).group(0)} {count} {kind}"
        for (fn, kind), count in sass.items() if count))
    # K1 (f32 forward and record mode, bf16, wide bf16, wide1k bf16 and
    # split-f32) and K2 bf16 (narrow and wide): HGMMA in every instance (sigma_only or not); K2 f32 (narrow
    # and wide): HMMA in both, every one .TF32.
    hgmma = {kernel: [count for (fn, kind), count in sass.items()
                      if kind == "HGMMA" and re.search(kernel, fn)]
             for kernel in ("fused_mlp_f32tc_kernelILb[01]ELb0E",   # K1 f32
                            "fused_mlp_f32tc_kernelILb[01]ELb1E",   # its record mode
                            "fused_mlp_tc_kernel", "fused_mlp_bwd_bf16_kernel",
                            "fused_mlp_wide_tc_kernel", "fused_mlp_wide_bwd_bf16_kernel",
                            "fused_mlp_wide_dw_kernel",    # its bf16 and f32 modes
                            "fused_mlp_wide1k_tc_kernel", "fused_mlp_wide1k_f32tc_kernel")}
    for kernel, counts in hgmma.items():
        if len(counts) != 2 or not all(counts):
            raise PhaseFailure(f"{kernel} (both variants) has no HGMMA instructions in the built "
                               f"library")
    # K2 past width 512 (fused_mlp_wide1k_bwd_kernel, f32 and bf16, each
    # sigma-only or not): HMMA in all four, every one .TF32.
    for kernel, instances in (("fused_mlp_bwd_tc_kernel", 2), ("fused_mlp_wide_bwd_tc_kernel", 2),
                              ("fused_mlp_wide1k_bwd_kernel", 4)):
        k2 = {fn: count for (fn, kind), count in sass.items()
              if kind == "HMMA" and re.search(rf"\d{kernel}", fn)}
        if len(k2) != instances or not all(count and sass.get((fn, "TF32"), 0) == count
                                           for fn, count in k2.items()):
            raise PhaseFailure(f"K2's kernel {kernel} ({instances} variants) lacks HMMA "
                               "instructions, or has some that are not tf32")
    # The int8 kernels, narrow and wide: IGMMA (integer wgmma) in both
    # instances of each.
    for kernel in (INT8_KERNEL, WIDE_INT8_KERNEL):
        igmma = [count for (fn, kind), count in sass.items()
                 if kind == "IGMMA" and re.search(kernel, fn)]
        if len(igmma) != 2 or not all(igmma):
            raise PhaseFailure(f"{kernel} (both variants) has no IGMMA instructions in the "
                               "built library")


# The hash encode's instances (f32, bf16 x paired or generic) and K3's (K
# values a lane: 1, 2, ..., 64), as ptxas names them.
GATHER_KERNELS = r"(hash_encode_kernel|resample_kernel)(I\w+?E)E?v"
# The wide K1's kernels: bf16 (sigma-only or not), f32 and its record mode
# (each sigma-only or not): six instances.
WIDE_K1_KERNELS = r"(fused_mlp_wide_tc_kernel|fused_mlp_wide_f32_kernel)(I(?:Lb[01]E)+)"
WIDE_K1_INSTANCES = 6
# The wide K2's kernels: the per-tile kernels (sigma-only or not), the f32
# record's split into planes, the dW kernel and its sum (bf16 and f32
# modes, ILi1E and ILi3E) and the small sums: ten instances.
WIDE_K2_KERNELS = (r"(fused_mlp_wide_bwd_bf16_kernel|fused_mlp_wide_bwd_tc_kernel|"
                   r"fused_mlp_wide_dw_kernel|dw_sum_kernel|small_sum_kernel|"
                   r"record_planes_kernel)(I(?:Lb[01]E|Li[13]E)|(?=E))")
WIDE_K2_INSTANCES = 10
# The wide int8 kernel's two instances (sigma-only or not).
WIDE_INT8_KERNELS = r"(int8_mlp_wide_tc_kernel)(ILb[01]E)"
# K1 past width 512: bf16 and split-f32 (each sigma-only or not): four
# instances.
WIDE1K_K1_KERNELS = r"(fused_mlp_wide1k_tc_kernel|fused_mlp_wide1k_f32tc_kernel)(ILb[01]E)"
# K2 past width 512: the half-tile backward (f32 and bf16, each sigma-only
# or not; its f32 record's split into planes is WIDE_K2_KERNELS'
# record_planes_kernel): four instances.
WIDE1K_K2_KERNELS = r"(fused_mlp_wide1k_bwd_kernel)(I(?:Lb[01]E)+)"
# The wide K2 with per-tile partials (before its dW kernel): the build and
# the whole run of its final chip_smoke run (PERF.md).
PARTIALS_BUILD_S, PARTIALS_TOTAL_S = 118.7, 882.5


def ptxas_usage(log: str, pattern: str) -> dict:
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from ``ptxas -v`` output, for the entry functions matching ``pattern``
    (named by its two groups)."""
    usage, fn = {}, None
    for line in log.splitlines():
        head = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if head:
            found = re.search(pattern, head.group(1))
            fn = "".join(found.groups()) if found else None
            continue
        if fn is None:
            continue
        entry = usage.setdefault(fn, [0, 0, 0])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            entry[1:] = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            entry[0] = int(regs.group(1))
    return {fn: tuple(v) for fn, v in usage.items()}


MLP_KERNEL = (r"(?:fused_mlp(?:_wide(?:1k)?)?(?:_bwd)?_(?:tc|bf16|f32tc)_kernel(?:I(?:Lb[01]E)+)?"
              r"|fused_mlp_wide1k_bwd_kernelI(?:Lb[01]E)+|fused_mlp_wide_dw_kernelILi[13]E)")
INT8_KERNEL = r"int8_mlp_tc_kernelILb[01]E"
WIDE_INT8_KERNEL = r"int8_mlp_wide_tc_kernelILb[01]E"
TC_KERNEL = rf"(?:{MLP_KERNEL}|{INT8_KERNEL}|{WIDE_INT8_KERNEL})"


def tensor_core_instructions(build) -> dict:
    """{(function, kind): count} from ``cuobjdump --dump-sass`` of the built
    library: HGMMA, HMMA and IGMMA (integer ``wgmma``) instructions of each
    instance of the fused MLP kernels and the int8 kernel (TC_KERNEL), the
    HMMA ones also counted by operand type (kind "TF32" or "BF16")."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        raise PhaseFailure(f"cuobjdump failed: {sass.stderr.strip()[-500:]}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1) if re.search(TC_KERNEL, head.group(1)) else None
            if fn:
                counts[(fn, "HGMMA")] = counts[(fn, "HMMA")] = counts[(fn, "IGMMA")] = 0
            continue
        for op in ("HGMMA", "HMMA", "IGMMA"):
            if fn and re.search(rf"\b{op}\.", line):
                counts[(fn, op)] += 1
                for kind in ("TF32", "BF16"):
                    if op == "HMMA" and f".{kind}" in line:
                        counts[(fn, kind)] = counts.get((fn, kind), 0) + 1
    return counts


def main_path_inputs(cam, dev, n_rays: int = RAY_CHUNK):
    """The main path's field inputs for ``n_rays`` rays of the frame's
    center rows: stratified samples at the coarse width (64) and at the
    fine width (64 + 128 = 192) per ray."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.ops.sampling import stratified_samples

    _, dirs = camera_rays(cam, H, W, dev)
    first = (H // 2 - n_rays // W // 2) * W
    dirs = dirs.reshape(-1, 3)[first:first + n_rays].contiguous()
    ids = torch.arange(first, first + n_rays, device=dev)
    k_c, k_f = random.split(random.key(0, dev))
    near = torch.as_tensor(cam.near, device=dev)
    far = torch.as_tensor(cam.far, device=dev)
    origin = torch.as_tensor(cam.position, device=dev)
    t_c = stratified_samples(random.fold_in(k_c, ids), near, far, N_COARSE, (n_rays,))
    t_f = stratified_samples(random.fold_in(k_f, ids), near, far, N_COARSE + N_FINE, (n_rays,))
    pts_c = (origin + dirs[:, None, :] * t_c[..., None]).contiguous()
    pts_f = (origin + dirs[:, None, :] * t_f[..., None]).contiguous()
    return pts_c, pts_f, dirs[:, None, :]


def recorded_k1(run):
    """``run()`` with every call of K1's wrapper recorded -> (what ``run``
    returns, [(params, points, viewdirs, kwargs)]). The launches count as
    they would unrecorded."""
    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm

    real = fm.fused_nerf_mlp
    seen = []

    def record(params, points, viewdirs, **kw):
        seen.append((params, points, viewdirs, kw))
        return real(params, points, viewdirs, **kw)

    # The wrapper counts through its module name.
    names = ("launches", "tc_launches", "wide_launches", "wide1k_launches")
    for name in names:
        setattr(record, name, getattr(real, name))
    fm.fused_nerf_mlp = record
    try:
        out = run()
    finally:
        fm.fused_nerf_mlp = real
        for name in names:
            setattr(real, name, getattr(record, name))
    return out, seen


def k1_bf16_witness(calls, names):
    """bf16 K1 against its plain version on recorded calls of a main path,
    grouped by network (``names``: id -> name) and mode. Each call is run
    again through the kernel, its plain version and the plain version in
    float64, and the samples outside the bf16 bars are counted (sigma:
    ``fused_mlp.BF16_SIGMA_BARS``; rgb: TOLERANCES["bfloat16"]["rgb_atol"]).
    The counts add over a group's calls, and each group is held as
    ``fused_mlp.bf16_sigma_agrees`` holds one call: outside the float64
    evaluation's bars on at most 2x the plain version's count + 2, and
    outside the plain version's own on at most 4 + 5e-5 n of its n values;
    two reruns of every call bitwise equal. -> [(ok, line)]. The
    caller keeps these launches out of the counts."""
    import collections

    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        BF16_SIGMA_BARS,
        fused_nerf_mlp,
        fused_nerf_mlp_reference,
    )

    def outside(got, want, atol, rtol):
        got, want = got.double().reshape(-1), want.double().reshape(-1)
        return int(((got - want).abs() > atol + rtol * want.abs()).sum())

    bars = {"sigma": BF16_SIGMA_BARS, "rgb": (TOLERANCES["bfloat16"]["rgb_atol"], 0.0)}
    groups = collections.defaultdict(lambda: {"calls": 0, "rows": 0, "bitwise": True,
                                              "sigma": [0, 0, 0, 0], "rgb": [0, 0, 0, 0]})
    with torch.no_grad():
        for params, pts, vd, kw in calls:
            if kw.get("dtype") != "bfloat16":
                continue
            g = groups[(names.get(id(params), "?"), bool(kw.get("sigma_only")))]
            out_k = fused_nerf_mlp(params, pts, vd, **kw)
            again = fused_nerf_mlp(params, pts, vd, **kw)
            out_r = fused_nerf_mlp_reference(params, pts, vd, **kw)
            out_64 = fused_nerf_mlp_reference(params, pts.double(), vd.double(), **kw)
            g["calls"] += 1
            g["rows"] += out_k[1].numel()
            g["bitwise"] &= all(torch.equal(a, b) for a, b in zip(out_k, again))
            for i, what in ((1, "sigma"), (0, "rgb")):
                if what == "rgb" and kw.get("sigma_only"):
                    continue
                atol, rtol = bars[what]
                c = g[what]
                c[0] += out_k[i].numel()
                c[1] += outside(out_k[i], out_r[i], atol, rtol)
                c[2] += outside(out_k[i], out_64[i], atol, rtol)
                c[3] += outside(out_r[i], out_64[i], atol, rtol)
            del out_k, again, out_r, out_64
    results = []
    for (name, sigma_only), g in sorted(groups.items()):
        ok = g["bitwise"]
        parts = []
        for what in ("sigma", "rgb"):
            n, kp, ke, pe = g[what]
            if not n:
                continue
            good = ke <= 2 * pe + 2 and kp <= 4 + 5e-5 * n
            ok &= good
            parts.append(f"{what} outside the bars of {n:,}: kernel vs plain {kp} (bar "
                         f"{4 + 5e-5 * n:.0f}), vs float64 kernel {ke}, plain {pe} (bar "
                         f"{2 * pe + 2})")
        results.append((ok, f"{name} sigma_only={sigma_only}: {g['calls']} calls, {g['rows']:,} "
                            f"rows; " + "; ".join(parts) + f"; reruns bitwise {g['bitwise']} -> "
                            f"{'ok' if ok else 'FAIL'}"))
    return results


def phase_kernel_vs_plain(coarse, fine, cam, dev):
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        bf16_sigma_agrees,
        fused_nerf_mlp,
        fused_nerf_mlp_reference,
    )

    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    cases = {"coarse": (coarse, pts_c, True), "fine": (fine, pts_f, False)}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    timings = []
    saved = save_counts()
    with torch.no_grad():
        for dtype, tol in TOLERANCES.items():
            for name, (net, pts, sigma_only) in cases.items():
                kw = dict(dtype=dtype, sigma_only=sigma_only)
                torch.cuda.synchronize()
                rgb_k, sig_k = fused_nerf_mlp(net, pts, vd, **kw)
                rgb_2, sig_2 = fused_nerf_mlp(net, pts, vd, **kw)
                torch.cuda.synchronize()
                rgb_r, sig_r = fused_nerf_mlp_reference(net, pts, vd, **kw)
                torch.cuda.synchronize()
                shape = tuple(pts.shape[:-1])
                if tuple(sig_k.shape) != shape or tuple(rgb_k.shape) != (*shape, 3):
                    raise PhaseFailure(f"{name}/{dtype}: output shapes {tuple(rgb_k.shape)}, "
                                       f"{tuple(sig_k.shape)} for input {tuple(pts.shape)}")
                if not (torch.isfinite(rgb_k).all() and torch.isfinite(sig_k).all()):
                    raise PhaseFailure(f"{name}/{dtype}: non-finite kernel output")
                bitwise = torch.equal(rgb_k, rgb_2) and torch.equal(sig_k, sig_2)
                rgb_err = float((rgb_k - rgb_r).abs().max())
                sig_err = float((sig_k - sig_r).abs().max())
                sig_excess = float(((sig_k - sig_r).abs()
                                    - tol["sigma_rtol"] * sig_r.abs()).max())
                line = (f"{name} {shape} sigma_only={sigma_only} {dtype}: max|d rgb| "
                        f"{rgb_err:.3e} (atol {tol['rgb_atol']}), max|d sigma| {sig_err:.3e} "
                        f"(atol {tol['sigma_atol']}, rtol {tol['sigma_rtol']}), sigma range "
                        f"[{float(sig_r.min()):.3g}, {float(sig_r.max()):.3g}]")
                if dtype == "float32":
                    ok = rgb_err <= tol["rgb_atol"] and sig_excess <= tol["sigma_atol"]
                    rgb_64, sig_64 = fused_nerf_mlp_reference(net, pts.double(), vd.double(), **kw)

                    def dist(x, ref):
                        return float((x.double() - ref).abs().max())

                    line += (f"; max distance from the float64 evaluation: kernel rgb "
                             f"{dist(rgb_k, rgb_64):.3e} sigma {dist(sig_k, sig_64):.3e}, plain "
                             f"rgb {dist(rgb_r, rgb_64):.3e} sigma {dist(sig_r, sig_64):.3e}")
                    del rgb_64, sig_64
                else:
                    _, sig_64 = fused_nerf_mlp_reference(net, pts.double(), vd.double(), **kw)
                    sig_ok, counts = bf16_sigma_agrees(sig_k, sig_r, sig_64)
                    ok = rgb_err <= tol["rgb_atol"] and sig_ok
                    line += (f"; sigma samples outside the bars of {sig_k.numel()}: kernel vs "
                             f"plain {counts['kernel_vs_plain']} (bar 4 + 5e-5 n), vs float64 "
                             f"kernel {counts['kernel_vs_exact']}, plain "
                             f"{counts['plain_vs_exact']} (bar: kernel <= 2 plain + 2)")
                ok = ok and bitwise
                say("3 kernel", f"{line}; two calls bitwise equal: {bitwise} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailure(f"kernel disagrees with its plain version: {name}/{dtype}")
                errs[dtype] = max(errs[dtype], rgb_err, sig_err)
                timings.append((name, dtype, net, pts, sigma_only))
    restore_counts(saved)                      # comparison launches do not count
    return errs, timings, vd


def render(coarse, fine, cam, dev, impl: str, dtype: str, size: int = 0):
    import torch

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=RAY_CHUNK, impl=impl,
                       dtype=dtype)
    size = size or H
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(coarse, fine, cam, size, size, random.key(0, dev), cfg, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tuple(img.shape) != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise PhaseFailure(f"{impl}/{dtype} frame: shape {tuple(img.shape)} or non-finite values")
    return img.cpu().numpy(), ms


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-300))


def main_path_backward_inputs(dev):
    """What the training path hands K2: one nerf_loss backward of the lego
    networks, trained as students, on a distillation batch of TRAIN_RAYS
    rays with 64 + 128 samples, with K2's wrapper recording its inputs.
    -> {"coarse": (net, points, viewdirs, g_rgb, g_sigma), "fine": ...}."""
    import torch

    import nerf_rs_tpu_torch.ops.kernels.fused_mlp as fm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import nerf_loss

    _, dataset, cfg, key = distill_setup(dev, "pallas")
    nets = {net: NerfMLP(load_nerf_params(find_lego_assets() / net), device=dev,
                         requires_grad=True) for net in ("coarse", "fine")}
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    seen = []
    real = fm.fused_nerf_mlp_backward

    def record(pk, points, viewdirs, g_rgb, g_sigma, **kw):
        seen.append((points, viewdirs, g_rgb, g_sigma))
        return real(pk, points, viewdirs, g_rgb, g_sigma, **kw)

    # The wrapper counts through its module name.
    names = ("launches", "bf16_launches", "wide_launches", "dw_launches", "wide1k_launches")
    for name in names:
        setattr(record, name, getattr(real, name))
    fm.fused_nerf_mlp_backward = record
    try:
        loss, _ = nerf_loss(nets, batch, random.fold_in(key, torch.tensor(0)), cfg)
        loss.backward()
    finally:
        fm.fused_nerf_mlp_backward = real
        for name in names:
            setattr(real, name, getattr(record, name))
    by_samples = {args[0].shape[-2]: args for args in seen}
    return {"coarse": (nets["coarse"], *by_samples[N_COARSE]),
            "fine": (nets["fine"], *by_samples[N_COARSE + N_FINE])}


def k2_gradients(net, args, dtype: str, sigma_only: bool = False, exact_rays: int = 0):
    """K2 twice and its plain version on one call's inputs (points, dirs,
    two cotangents), and for f32 the float64 evaluation (on ``exact_rays``
    rays at a time when given: its sums over the samples are the same in
    float64). -> (kernel, kernel again, plain, float64 or None) outputs."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
    )

    kw = dict(dtype=dtype, sigma_only=sigma_only)
    got = fused_nerf_mlp_backward(net, *args, **kw)
    again = fused_nerf_mlp_backward(net, *args, **kw)
    want = fused_nerf_mlp_backward_reference(net, *args, **kw)
    exact = None
    if dtype == "float32":
        step = exact_rays or args[0].shape[0]
        parts = [fused_nerf_mlp_backward_reference(net, *(a[r:r + step].double() for a in args),
                                                   **kw)
                 for r in range(0, args[0].shape[0], step)]
        exact = (sum(p[0] for p in parts), sum(p[1] for p in parts),
                 torch.cat([p[2] for p in parts]), torch.cat([p[3] for p in parts]))
    torch.cuda.synchronize()
    return got, again, want, exact


def named_gradients(pk, out) -> dict:
    """Every leaf's gradient, d(points) and d(dirs) (one dir per ray) of a
    K2 output on pack ``pk``."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import unpack_grads

    leaves = unpack_grads(pk, out[0], out[1])
    grads = {f"{layer}/{part}": leaves[layer][part]
             for layer in leaves for part in ("kernel", "bias")}
    grads["d(points)"] = out[2]
    grads["d(dirs)"] = out[3].sum(1)
    return grads


def mask_gradients(net, args, sigma_only: bool = False, tau: float = 0.0, masks=None,
                   chunk: int = 16384):
    """The float64 gradients of sum(g_rgb rgb) + sum(g_sigma sigma) for the
    function of ``net``'s f32 pack, by autograd on ``args`` (points,
    viewdirs, g_rgb, g_sigma). ReLU masks (trunk layers ``dense{i}``, the
    view layer ``viewdirs``, the sigma head ``alpha``) are float64's own,
    but: with ``tau``, every mask whose pre-activation z lies within tau x
    (|b| + sum |w_i x_i|) of zero flipped; with ``masks`` ({layer: (flat
    samples, units, on)}), those masks set. ``chunk`` samples at a time.
    -> (named_gradients' dict, masks flipped)."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    pk = net.packed("float32")
    points, viewdirs, g_rgb, g_sigma = args
    pts_all = points.reshape(-1, 3).double()
    dirs_all = torch.broadcast_to(viewdirs, points.shape).reshape(-1, 3).double()
    g_rgb_all, g_sig_all = g_rgb.reshape(-1, 3).double(), g_sigma.reshape(-1).double()
    mats = {n: pk.mat(n).double().requires_grad_() for n in pk.segments}
    biases = {n: pk.bias(n).double().requires_grad_() for n in pk.bias_slots}
    leaves = list(mats.values()) + list(biases.values())
    sums = [torch.zeros_like(t) for t in leaves]
    d_pts, d_dirs = [], []
    flipped = 0

    def relu(sources, name, s):
        nonlocal flipped
        z = biases[name] + sum(a @ mats[w] for a, w in sources)
        mask = z > 0
        if tau:
            with torch.no_grad():
                size = biases[name].abs() + sum(a.abs() @ mats[w].abs() for a, w in sources)
                near = z.abs() < tau * size
            flipped += int(near.sum())
            mask = mask ^ near
        if masks and name in masks:
            rows, units, on = masks[name]
            mine = (rows >= s) & (rows < s + z.shape[0])
            mask[rows[mine] - s, units[mine]] = on[mine]
        return z * mask

    for s in range(0, pts_all.shape[0], chunk):
        pts = pts_all[s:s + chunk].requires_grad_()
        dirs = dirs_all[s:s + chunk].requires_grad_()
        enc_x = fm._encode(pts, 10, fm._ENC_X)
        h = relu([(enc_x, "dense0")], "dense0", s)
        for i in range(1, pk.depth):
            sources = [(h, f"dense{i}")]
            if f"dense{i}_enc" in pk.segments:
                sources.insert(0, (enc_x, f"dense{i}_enc"))
            h = relu(sources, f"dense{i}", s)
        out = (g_sig_all[s:s + chunk] * relu([(h, "alpha")], "alpha", s)[:, 0]).sum()
        if not sigma_only:
            enc_d = fm._encode(dirs, 4, fm._ENC_D)
            bneck = h @ mats["bottleneck"] + biases["bottleneck"]
            hv = relu([(bneck, "viewdirs"), (enc_d, "viewdirs_dir")], "viewdirs", s)
            rgb = torch.sigmoid(hv @ mats["rgb"] + biases["rgb"])
            out = out + (g_rgb_all[s:s + chunk] * rgb).sum()
        grads = torch.autograd.grad(out, leaves + [pts, dirs], allow_unused=True)
        for acc, g in zip(sums, grads[:len(leaves)]):
            if g is not None:
                acc += g
        d_pts.append(grads[-2])
        d_dirs.append(torch.zeros_like(dirs) if grads[-1] is None else grads[-1])
    dw = torch.zeros(pk.weights.numel(), dtype=torch.float64, device=pts_all.device)
    db = torch.zeros(pk.biases.numel(), dtype=torch.float64, device=pts_all.device)
    for (off, k, ld), g in zip(pk.segments.values(), sums):
        dw[off:off + k * ld] = g.reshape(-1)
    for (off, n), g in zip(pk.bias_slots.values(), sums[len(mats):]):
        db[off:off + n] = g
    out = (dw, db, torch.cat(d_pts).reshape(points.shape),
           torch.cat(d_dirs).reshape(points.shape))
    return named_gradients(pk, out), flipped


def float64_preactivations(net, args, sigma_only: bool, chunk: int = 65536):
    """Each ReLU layer's float64 pre-activations for the function of
    ``net``'s f32 pack at ``args``' points and viewdirs, ``chunk`` samples
    at a time: yields (layer, first sample, z, |b| + sum |w_i x_i|) for
    the trunk layers ``dense{i}``, the sigma head ``alpha`` and (unless
    ``sigma_only``) the view layer ``viewdirs``."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    pk = net.packed("float32")
    points, viewdirs = args[:2]
    pts_all = points.reshape(-1, 3).double()
    dirs_all = torch.broadcast_to(viewdirs, points.shape).reshape(-1, 3).double()

    def layer(sources, name):
        w = [(a, pk.mat(n).double()) for a, n in sources]
        b = pk.bias(name).double()
        return b + sum(a @ m for a, m in w), b.abs() + sum(a.abs() @ m.abs() for a, m in w)

    with torch.no_grad():
        for s in range(0, pts_all.shape[0], chunk):
            enc_x = fm._encode(pts_all[s:s + chunk], 10, fm._ENC_X)
            h = None
            for i in range(pk.depth):
                sources = [(enc_x, "dense0")] if i == 0 else [(h, f"dense{i}")]
                if f"dense{i}_enc" in pk.segments:
                    sources.insert(0, (enc_x, f"dense{i}_enc"))
                z, size = layer(sources, f"dense{i}")
                yield f"dense{i}", s, z, size
                h = torch.relu(z)
            yield ("alpha", s, *layer([(h, "alpha")], "alpha"))
            if not sigma_only:
                enc_d = fm._encode(dirs_all[s:s + chunk], 4, fm._ENC_D)
                bneck = h @ pk.mat("bottleneck").double() + pk.bias("bottleneck").double()
                yield ("viewdirs", s,
                       *layer([(bneck, "viewdirs"), (enc_d, "viewdirs_dir")], "viewdirs"))


def unresolved_masks(net, args, sigma_only: bool, tau=None):
    """The ReLU masks f32 cannot resolve: wherever the float64
    pre-activation z lies within ``tau`` (MASK_TAU unless given) x (|b| +
    sum |w_i x_i|) of zero. -> {layer: (flat samples, units, float64's
    mask)}."""
    import torch

    tau = MASK_TAU if tau is None else tau
    found = {}
    for name, s, z, size in float64_preactivations(net, args, sigma_only):
        rows, units = torch.nonzero(z.abs() < tau * size, as_tuple=True)
        if rows.numel():
            found.setdefault(name, []).append((rows + s, units, z[rows, units] > 0))
    return {name: tuple(torch.cat(parts) for parts in zip(*found[name])) for name in found}


def kernel_mask_exact(net, args, sigma_only: bool, exact: dict):
    """The float64 gradients ``exact`` (named), except on the samples
    where the kernel's own forward put a mask that f32 cannot resolve
    (unresolved_masks) on the other side of zero from float64's: those
    samples are evaluated again in float64 with every ReLU mask as the
    kernel's forward set it (``fused_mlp.recorded_outputs``, which K2's f32
    mode differentiates; the sigma head's mask is K1's sigma > 0), so that
    the masks downstream of such a unit (an identity copy of it, say)
    follow it as they do in the kernel. -> (the gradients, {"unresolved":
    masks found, "other_side": of them set the other way, "samples":
    samples evaluated again, "masks": masks of theirs that differ from
    float64's})."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, recorded_outputs

    info = {"unresolved": 0, "other_side": 0, "samples": 0, "masks": 0}
    found = unresolved_masks(net, args, sigma_only)
    info["unresolved"] = sum(int(v[0].numel()) for v in found.values())
    if not info["unresolved"]:
        return exact, info
    points, viewdirs, g_rgb, g_sigma = args
    samples = points.shape[-2] if points.dim() >= 2 else 1
    pts = points.reshape(-1, 3)
    dirs = torch.broadcast_to(viewdirs, points.shape).reshape(-1, 3)
    every = torch.unique(torch.cat([v[0] for v in found.values()]))
    with torch.no_grad():
        rec = recorded_outputs(net, pts[every].contiguous(), dirs[every].contiguous())
        sigma = fused_nerf_mlp(net, pts[every].contiguous(), dirs[every].contiguous(),
                               dtype="float32", sigma_only=True)[1].reshape(-1, 1)
    depth = net.packed("float32").depth
    layers = {f"dense{i}": rec[i] for i in range(depth)}
    layers["alpha"] = sigma
    if not sigma_only:
        layers["viewdirs"] = rec[depth + 1]
    touched = []
    for name, (rows, units, on) in found.items():
        mine = layers[name][torch.searchsorted(every, rows), units] > 0
        info["other_side"] += int((mine != on).sum())
        touched.append(rows[mine != on])
    if not info["other_side"]:
        return exact, info
    touched = torch.unique(torch.cat(touched))
    local = torch.searchsorted(every, touched)
    sub = (pts[touched].reshape(-1, 1, 3), dirs[touched].reshape(-1, 1, 3),
           g_rgb.reshape(-1, 3)[touched].reshape(-1, 1, 3), g_sigma.reshape(-1)[touched][:, None])
    masks = {}
    for name, out in layers.items():
        on = out[local] > 0
        rows, units = torch.meshgrid(torch.arange(on.shape[0], device=on.device),
                                     torch.arange(on.shape[1], device=on.device), indexing="ij")
        masks[name] = (rows.reshape(-1), units.reshape(-1), on.reshape(-1))
    theirs, _ = mask_gradients(net, sub, sigma_only, masks=masks)
    ours, _ = mask_gradients(net, sub, sigma_only)
    info["samples"] = int(touched.numel())
    for name, _, z, _ in float64_preactivations(net, sub, sigma_only):
        on = masks[name][2].reshape(z.shape[0], -1)
        info["masks"] += int((on != (z[:, :on.shape[1]] > 0)).sum())
    fixed = {k: v.clone() for k, v in exact.items()}
    for k in fixed:
        delta = theirs[k] - ours[k]
        if k == "d(points)":
            fixed[k].reshape(-1, 3)[touched] += delta.reshape(-1, 3)
        elif k == "d(dirs)":
            fixed[k].reshape(-1, 3).index_add_(0, touched // samples, delta.reshape(-1, 3))
        else:
            fixed[k] += delta
    return fixed, info


def backward_vs_plain(phase: str, name: str, net, args, dtype: str, sigma_only: bool = False,
                      exact_rays: int = 0) -> float:
    """K2 against its plain version on one call's inputs, at BWD_BARS (f32
    held to the float64 evaluation: each gradient within max(bar,
    F32_VS_PLAIN x the plain version's distance) of it, kernel_mask_exact),
    and two calls bitwise; raises on a miss. -> the
    largest parameter-gradient difference from plain."""
    import torch

    bar = BWD_BARS[dtype]
    got, again, want, exact = k2_gradients(net, args, dtype, sigma_only, exact_rays)
    if not all(bool(torch.isfinite(x).all()) for x in got):
        raise PhaseFailure(f"K2 {name}/{dtype}: non-finite gradient")
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    pk = net.packed(dtype)
    gk, gp = named_gradients(pk, got), named_gradients(pk, want)
    vs_plain = {k: rel_err(gk[k], gp[k]) for k in gp}
    worst = max(vs_plain, key=vs_plain.get)
    line = (f"K2 {name} {tuple(args[0].shape[:-1])} {dtype}{' sigma-only' if sigma_only else ''}: "
            f"worst ||g_k - g_p|| / ||g_p|| {vs_plain[worst]:.3e} ({worst}) over {len(gp)} "
            "gradients")
    if exact is None:
        ok = vs_plain[worst] <= bar
        line += f" (bar {bar})"
    else:
        g64 = named_gradients(pk, exact)
        g64k, info = kernel_mask_exact(net, args, sigma_only, g64)
        margin = {k: rel_err(gk[k], g64k[k]) / max(bar, F32_VS_PLAIN * rel_err(gp[k], g64[k]))
                  for k in g64}
        tight = max(margin, key=margin.get)
        ok = margin[tight] <= 1.0
        line += (f"; against float64 ({info['unresolved']} masks within "
                 f"2^{round(math.log2(MASK_TAU))} of zero, {info['other_side']} set the other way "
                 f"by the kernel's forward: {info['samples']} samples on its masks, "
                 f"{info['masks']} of theirs differing), tightest {tight}: kernel "
                 f"{rel_err(gk[tight], g64k[tight]):.3e}, plain {rel_err(gp[tight], g64[tight]):.3e} "
                 f"(bar max({bar}, {F32_VS_PLAIN} x plain))")
        if info["samples"]:
            line += (f"; against float64's own masks {rel_err(gk[tight], g64[tight]):.3e} "
                     f"(reported)")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))  # parameters
    ok = ok and bitwise
    say(phase, f"{line}; two calls bitwise equal: {bitwise} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure(f"K2 disagrees with its plain version or is not deterministic: "
                           f"{name}/{dtype}")
    return err


def phase_backward_vs_plain(dev):
    """K2 against its plain version on what the training path hands it."""
    inputs = main_path_backward_inputs(dev)
    errs = {dtype: 0.0 for dtype in BWD_BARS}
    for name, (net, *args) in inputs.items():
        for dtype in BWD_BARS:
            errs[dtype] = max(errs[dtype], backward_vs_plain("8 backward", name, net, args, dtype))
    return errs, inputs["fine"]


def distill_setup(dev, impl: str, dtype: str = "float32", arch=None):
    """The training job's state, dataset, config and step key, as
    ``python -m nerf_rs_tpu_torch train`` builds them (``--dtype``; the
    student's (width, v_width, depth, skip_at) ``arch``, the default
    8x256 unless given)."""
    import torch

    from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state

    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=RenderConfig(
        n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl=impl, dtype=dtype),
        arch=ArchConfig(*arch) if arch else ArchConfig())
    state = create_train_state(torch.Generator(device=dev).manual_seed(cfg.seed), cfg)
    assets = find_lego_assets()
    teacher = {net: load_nerf_params(assets / net) for net in ("coarse", "fine")}
    dataset = DistillationDataset(teacher, cfg=cfg.render.replace(impl="pallas"), seed=cfg.seed,
                                  device=dev)
    return state, dataset, cfg, random.key(cfg.seed + 1, dev)


def phase_step_vs_plain(dev, arch=None, phase: str = "9 step"):
    """One training step from the same state and batch: the kernels
    (impl="pallas") against the plain MLP (impl="xla"), f32; the student
    ``arch`` as distill_setup takes it. -> the kernel step's launch counts."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    results = {}
    batch = None
    for impl in ("pallas", "xla"):
        state, dataset, cfg, key = distill_setup(dev, impl, arch=arch)
        if batch is None:
            batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
        torch.cuda.synchronize()
        zero_counts()
        state, metrics = train_step(state, batch, random.fold_in(key, torch.tensor(0)), cfg)
        torch.cuda.synchronize()
        if impl == "pallas":
            counts = read_counts()
        results[impl] = (float(metrics["loss"]), state, cfg, metrics)
    (loss_k, state_k, cfg, m_k), (loss_p, state_p, _, m_p) = results["pallas"], results["xla"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    parts = ", ".join(f"{name} rel {abs(float(m_k[name]) - float(m_p[name])) / float(m_p[name]):.2e}"
                      for name in ("mse_coarse", "mse_fine"))
    diffs = {(net, name): (p.detach() - state_p.params[net].weights[name].detach()).abs()
             for net in ("coarse", "fine") for name, p in state_k.params[net].weights.items()}
    worst_max = max(float(d.max()) for d in diffs.values())
    share = (sum(int((d > 1e-5).sum()) for d in diffs.values())
             / sum(d.numel() for d in diffs.values()))
    leaf, leaf_share = max(((k, float((d > 1e-5).float().mean())) for k, d in diffs.items()),
                           key=lambda kv: kv[1])
    # tests/test_train.py's bound, over all entries of both networks: Adam's
    # first step is about lr * sign(g), so an entry moves by more than 1e-5
    # only where the two gradients straddle zero. The coarse samples are
    # the same in both steps; the fine samples move with the coarse sigmas'
    # last bits (importance sampling), so the fine network's first layers
    # hold most of those entries.
    ok = loss_rel <= 1e-5 and worst_max < 2 * cfg.lr_init and share < 1e-3
    student = f"{cfg.arch.width}/{cfg.arch.v_width}/{cfg.arch.depth} "
    say(phase, f"one f32 step of a {student}student, kernels vs plain MLP: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} "
        f"(rel {loss_rel:.2e}, bar 1e-5; {parts}); params after the step: max |d| {worst_max:.3e} "
        f"(bar < {2 * cfg.lr_init:g}), share of entries > 1e-5 {share:.2e} (bar < 1e-3; "
        f"largest in {leaf[0]}/{leaf[1]}: {leaf_share:.2e}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the kernel training step disagrees with the plain step")
    return counts


def phase_train(dev):
    """The training path: TRAIN_STEPS kernel steps from a random init,
    with the launch counts set to 0 just before and read just after."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "pallas")
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    fused_nerf_mlp.launches = fused_nerf_mlp_backward.launches = 0
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    secs = time.perf_counter() - t0
    launches = {"fused_nerf_mlp": fused_nerf_mlp.launches,
                "fused_nerf_mlp_backward": fused_nerf_mlp_backward.launches}
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    ok = (all(math.isfinite(v) for v in losses) and last < first
          and launches["fused_nerf_mlp_backward"] == 2 * TRAIN_STEPS
          and launches["fused_nerf_mlp"] == 4 * TRAIN_STEPS)
    say("10 train", f"{TRAIN_STEPS} kernel steps, 8x256 student, {TRAIN_RAYS} rays, "
        f"{N_COARSE}+{N_FINE} samples: loss {losses[0]:.5f} -> {losses[-1]:.5f}, mean of the "
        f"first 10 {first:.5f}, of the last 10 {last:.5f}; launches K1 "
        f"{launches['fused_nerf_mlp']} (expected {4 * TRAIN_STEPS}), K2 "
        f"{launches['fused_nerf_mlp_backward']} (expected {2 * TRAIN_STEPS}); "
        f"{secs:.1f} s with the teacher batches -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("training did not reduce the loss, or went around the kernels")
    return launches


def phase_train_bf16(dev):
    """The training path in bf16 (``train --dtype bfloat16``): BF16_STEPS
    kernel steps from a random init, counts set to 0 just before and read
    just after; every K2 launch is a bf16 one, two a step."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "pallas", "bfloat16")
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    for step in range(BF16_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    ok = (all(math.isfinite(v) for v in losses)
          and counts["fused_nerf_mlp_backward_bf16"] == 2 * BF16_STEPS
          and counts["fused_nerf_mlp_backward"] == 2 * BF16_STEPS)
    say("10 train", f"{BF16_STEPS} bf16 kernel steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"K2 launches {counts['fused_nerf_mlp_backward']}, bf16 "
        f"{counts['fused_nerf_mlp_backward_bf16']} (expected {2 * BF16_STEPS} each) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("bf16 training went around the bf16 K2 or gave a non-finite loss")
    return counts


def library_backward_ms(net, pts, viewdirs, g_rgb, g_sigma, dtype: str = "float32") -> float:
    """K2's library yardstick: the forward of ``models.mlp.nerf_mlp`` in
    ``dtype`` (cuBLAS products, TF32 off; bf16 on a bf16 tree and inputs, as
    ``library_mlp_ms``) with grad on, and ``torch.autograd.grad`` of
    sum(g_rgb rgb) + sum(g_sigma sigma) to the parameters, the function K2
    computes (parameter gradients, recompute included); median ms. The
    port's kernel path never calls it."""
    return timed_ms(library_backward_call(net, pts, viewdirs, g_rgb, g_sigma, dtype))


def profile_step(dev):
    """(wall ms, device busy ms, top device kernels) of one kernel train
    step (student forward, backward and Adam) on a fixed batch, warmed up."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "pallas")
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    step_key = random.fold_in(key, torch.tensor(0))
    train_step(state, batch, step_key, cfg)
    return profile_frame(lambda: train_step(state, batch, step_key, cfg))


def time_steps(dev, impl: str) -> float:
    """Median ms of a train step (student forward, backward and Adam) on one
    fixed batch, after a warm-up step."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, impl)
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    step_key = random.fold_in(key, torch.tensor(0))
    return timed_ms(lambda: train_step(state, batch, step_key, cfg))


def accel_cfg(dtype: str = "float32", sampling: str = "pallas", cull: bool = True,
              chunk: int = RAY_CHUNK):
    """bench.py's default accel render: probe culling without per-sample
    masks, ray packing, K1 and K3."""
    from nerf_rs_tpu_torch.config import RenderConfig

    return RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=chunk, impl="pallas",
                        dtype=dtype, sampling_impl=sampling, accel_compact="off",
                        accel_aabb_probes=PROBES, accel_range_stride=STRIDE,
                        accel_cull_rays=cull)


def resample_inputs(coarse, cam, dev, n_rays: int, nc: int, nf: int, grid=None):
    """What render_rays hands K3 for ``n_rays`` center rays of the 256x256
    golden camera, key 0: t_c and sigma_c of the f32 K1 sigma-only coarse
    pass, u from the fine keys, and far — the camera's, or with ``grid``
    the per-ray far_w of ``accel_sample_aabb`` (t_c drawn over each ray's
    occupied range, 32 probes) -> (t_c, sigma_c, u, far, coarse bin width)."""
    import torch

    from nerf_rs_tpu_torch.accel import ray_occupied_range
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp
    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.ops.sampling import _batched_uniform, stratified_samples

    _, dirs = camera_rays(cam, H, W, dev)
    first = (H // 2 - n_rays // W // 2) * W
    dirs = dirs.reshape(-1, 3)[first:first + n_rays].contiguous()
    ids = torch.arange(first, first + n_rays, device=dev)
    k_c, k_f = random.split(random.key(0, dev))
    near = torch.as_tensor(cam.near, device=dev)
    far = torch.as_tensor(cam.far, device=dev)
    origin = torch.as_tensor(cam.position, device=dev)
    t_lo, t_hi, far_w = near, far, far
    if grid is not None:
        t_lo, t_hi = ray_occupied_range(grid, origin, dirs, near, far, probes=PROBES)
        far_w = torch.minimum(far, t_hi + (t_hi - t_lo) / nc)
    t_c = stratified_samples(random.fold_in(k_c, ids), t_lo, t_hi, nc, (n_rays,))
    pts = (origin + dirs[:, None, :] * t_c[..., None]).contiguous()
    saved = fused_nerf_mlp.launches
    with torch.no_grad():
        _, sigma = fused_nerf_mlp(coarse, pts, dirs[:, None, :], sigma_only=True)
    fused_nerf_mlp.launches = saved                   # set-up launches do not count
    u = _batched_uniform(random.fold_in(k_f, ids), (n_rays,), nf)
    return t_c, sigma, u, far_w, float(cam.far - cam.near) / nc


def phase_resample_vs_plain(coarse, cam, dev, grid):
    """K3 against its plain version on the render's inputs."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, fused_resample_reference

    worst = 0.0
    saved = fused_resample.launches
    for nc, nf in ((N_COARSE, N_FINE), (32, 64)):
        for far_kind, g in (("scalar far", None), ("per-ray far", grid)):
            t_c, sigma, u, far, bin_width = resample_inputs(coarse, cam, dev, RAY_CHUNK, nc, nf, g)
            got = fused_resample(t_c, sigma, u, far)
            again = fused_resample(t_c, sigma, u, far)
            want = fused_resample_reference(t_c, sigma, u, far)
            torch.cuda.synchronize()
            err = (got - want).abs()
            share = float((err <= K3_ATOL + K3_RTOL * want.abs()).float().mean())
            max_err = float(err.max())
            ok = (tuple(got.shape) == (RAY_CHUNK, nc + nf) and bool(torch.isfinite(got).all())
                  and bool((got[:, 1:] >= got[:, :-1]).all()) and max_err <= bin_width
                  and share >= K3_SHARE and torch.equal(got, again))
            say("12 resample", f"K3 ({nc}, {nf}) {far_kind} x {RAY_CHUNK} rays: max |d t| "
                f"{max_err:.3e} (bar: a coarse bin, {bin_width:.4f}), share within "
                f"{K3_ATOL:g} + {K3_RTOL:g} |t| {share:.6f} (bar >= {K3_SHARE}), rows sorted "
                f"{bool((got[:, 1:] >= got[:, :-1]).all())}, two calls bitwise equal "
                f"{torch.equal(got, again)} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"K3 disagrees with its plain version: ({nc}, {nf}), {far_kind}")
            worst = max(worst, max_err)
    fused_resample.launches = saved                   # comparison launches do not count
    return worst


def rendered_chunks(grid, cam, size: int, cfg, dev):
    """(hit rays, chunks the packed render renders) for a size x size frame."""
    import torch

    from nerf_rs_tpu_torch.ops.rays import camera_rays
    from nerf_rs_tpu_torch.render import _image_ray_ranges

    _, dirs = camera_rays(cam, size, size, dev)
    (t0, t1), _, n_hit = _image_ray_ranges(
        grid, torch.as_tensor(cam.position, device=dev), dirs,
        torch.as_tensor(cam.near, device=dev), torch.as_tensor(cam.far, device=dev), cfg)
    hit = (t1 > t0).reshape(size, size)
    n = size * size
    return hit, min(-(-max(int(n_hit), 1) // cfg.ray_chunk), -(-n // cfg.ray_chunk))


def render_accel(coarse, fine, cam, dev, cfg, grid, size: int, key: int = 0):
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(coarse, fine, cam, size, size, random.key(key, dev), cfg, device=dev,
                       grid=grid)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tuple(img.shape) != (size, size, 3) or not bool(torch.isfinite(img).all()):
        raise PhaseFailure(f"accel frame: shape {tuple(img.shape)} or non-finite values")
    return img, ms


def phase_accel_frame(coarse, fine, cam, dev, grid):
    """The accel path's main run: the 256x256 f32 frame with K1 and K3,
    with the launch counts set to 0 just before and read just after."""
    import torch

    from nerf_rs_tpu_torch.io.image import load_ppm
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample

    cfg = accel_cfg()
    hit, chunks = rendered_chunks(grid, cam, H, cfg, dev)
    torch.cuda.synchronize()
    fused_nerf_mlp.launches = fused_nerf_mlp_backward.launches = fused_resample.launches = 0
    packed, ms = render_accel(coarse, fine, cam, dev, cfg, grid, H)
    launches = {"fused_nerf_mlp": fused_nerf_mlp.launches, "fused_resample": fused_resample.launches,
                "fused_nerf_mlp_backward": fused_nerf_mlp_backward.launches}
    unpacked, _ = render_accel(coarse, fine, cam, dev, cfg.replace(accel_cull_rays=False), grid, H)
    golden_db = psnr(packed.cpu().numpy(), load_ppm(GOLDEN_PPM))
    bitwise = torch.equal(packed[hit], unpacked[hit])
    ok = (golden_db > GOLDEN_BAR_DB and launches["fused_resample"] == chunks
          and launches["fused_nerf_mlp"] == 2 * chunks
          and launches["fused_nerf_mlp_backward"] == 0 and bitwise)
    say("13 accel", f"f32 accel frame {H}x{W} (grid {GRID_RES}^3, {PROBES} probes, stride "
        f"{STRIDE}, packing, K3): PSNR vs committed golden {golden_db:.2f} dB (bar > "
        f"{GOLDEN_BAR_DB}); {int(hit.sum())} of {H * W} rays hit, {chunks} chunks rendered; "
        f"launches K3 {launches['fused_resample']} (expected {chunks}), K1 "
        f"{launches['fused_nerf_mlp']} (expected {2 * chunks}); hit rays bitwise equal to "
        f"the unpacked accel frame: {bitwise}; {ms:.1f} ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the accel frame misses the golden bar, went around K1/K3, or packing "
                           "changed a hit ray")
    return launches


def phase_bench_frames(coarse, fine, cam, dev, grid, card):
    """The 800x800 frames of bench.py's default run."""
    from nerf_rs_tpu_torch.config import RenderConfig

    size = BENCH_SIZE
    dense_cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=BENCH_CHUNK,
                             impl="pallas")
    dense, dense_ms = render_accel(coarse, fine, cam, dev, dense_cfg, None, size)
    cfg = accel_cfg(chunk=BENCH_CHUNK)
    fast, fast_ms = render_accel(coarse, fine, cam, dev, cfg, grid, size)
    fast_bf16, bf16_ms = render_accel(coarse, fine, cam, dev, accel_cfg("bfloat16", chunk=BENCH_CHUNK),
                                      grid, size)
    accel_db = psnr(fast.cpu().numpy(), dense.cpu().numpy())
    bf16_db = psnr(fast_bf16.cpu().numpy(), fast.cpu().numpy())
    hit, chunks = rendered_chunks(grid, cam, size, cfg, dev)
    n = size * size
    ok = accel_db >= ACCEL_BAR_DB and bf16_db >= BF16_FRAME_BAR_DB
    say("14 800", f"{size}x{size} 16384-ray chunks: f32 accel+K3 vs f32 dense {accel_db:.2f} dB "
        f"(bar >= {ACCEL_BAR_DB}); bf16 accel+K3 vs f32 accel+K3 {bf16_db:.2f} dB (bar >= "
        f"{BF16_FRAME_BAR_DB}); rays that miss {1 - float(hit.float().mean()):.4f}, packed away "
        f"(not rendered) {1 - chunks * BENCH_CHUNK / n:.4f} ({chunks} of {-(-n // BENCH_CHUNK)} "
        f"chunks); first frames (with first-use costs) dense {dense_ms:.1f} ms, accel f32 "
        f"{fast_ms:.1f} ms, accel bf16 {bf16_ms:.1f} ms on {card} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the 800x800 accel frames miss their bars")
    return dense_cfg, cfg, dense.cpu().numpy()


def phase_serve(dev):
    """The viewer: the port's HTTP handler on a loopback port, serving the
    accel path with K1 and K3."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nerf_rs_tpu_torch import api, serve
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.image import pixels_to_rgba
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    api._state.clear()
    api.init_renderer(accel=True, device=dev, cfg=RenderConfig(
        ray_chunk=16384, accel_cull_rays=True, impl="pallas", sampling_impl="pallas"))
    state = dict(api._state)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        same = []
        for seed in range(3):
            t0 = time.perf_counter()
            body = urllib.request.urlopen(f"{base}/render?width=256&height=256&seed={seed}",
                                          timeout=300).read()
            ms = (time.perf_counter() - t0) * 1e3
            want = pixels_to_rgba(render_image(
                state["params"]["coarse"], state["params"]["fine"], state["camera"], 256, 256,
                random.key(seed, dev), state["cfg"], device=dev, grid=state["grid"]))
            same.append(body == want.tobytes())
            say("15 serve", f"GET /render 256x256 seed {seed}: {len(body)} bytes in {ms:.1f} ms, "
                f"equal to render_image's bytes: {same[-1]}")
        try:
            urllib.request.urlopen(f"{base}/render?width=0&height=256", timeout=60)
            bad = None
        except urllib.error.HTTPError as e:
            bad = e.code
    finally:
        srv.shutdown()
        srv.server_close()
        api._state.clear()
    ok = all(same) and bad == 400
    say("15 serve", f"bad size answered {bad} (expected 400) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the viewer's frames differ from render_image, or a bad size was not "
                           "refused")


def profile_frame(fn):
    """(wall ms, device busy ms, the top device kernels by time) of one
    run of ``fn`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall, sum(by_name.values()), top


def phase_accel_times(coarse, fine, cam, dev, grid, card, dense_cfg, cfg):
    """K3 and the plain chain per call, the grid build, the 800x800 frames
    (f32 dense and accel, bf16 accel) and the accel+K3 frames' device idle
    shares."""
    import torch

    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample, fused_resample_reference

    saved = save_counts()
    t_c, sigma, u, far, _ = resample_inputs(coarse, cam, dev, BENCH_CHUNK, N_COARSE, N_FINE)
    k3_ms = timed_ms(lambda: fused_resample(t_c, sigma, u, far), inner=20)
    plain_ms = timed_ms(lambda: fused_resample_reference(t_c, sigma, u, far), inner=20)
    say("16 times", f"{card}: K3 {BENCH_CHUNK} x ({N_COARSE}, {N_FINE}): kernel {k3_ms:.4f} ms, "
        f"plain chain {plain_ms:.4f} ms per call (median of 3 runs of 20 calls)")
    grid_ms = timed_ms(lambda: build_scene_grid(coarse, fine, resolution=GRID_RES))
    say("16 times", f"{card}: grid build, two {GRID_RES}^3 sweeps through K1 (bf16, "
        f"sigma-only, tensor cores): {grid_ms:.1f} ms (median of 3)")
    size = BENCH_SIZE
    frames = {}
    for label, c, g, warm in (("f32 dense", dense_cfg, None, False),
                              ("f32 accel, plain chain", cfg.replace(sampling_impl="xla"), grid,
                               True),
                              ("f32 accel, K3", cfg, grid, False),
                              ("bf16 accel, K3", cfg.replace(dtype="bfloat16"), grid, True)):
        frames[label] = timed_ms(lambda: render_accel(coarse, fine, cam, dev, c, g, size),
                                 warm=warm)
        say("16 times", f"{card}: {size}x{size} frame, {label}: {frames[label]:.1f} ms, "
            f"{size * size / frames[label] * 1e3:,.0f} rays/s (median of 3)")
    for label, c in (("f32 accel+K3", cfg), ("bf16 accel+K3", cfg.replace(dtype="bfloat16"))):
        wall, busy, top = profile_frame(lambda: render_accel(coarse, fine, cam, dev, c, grid, size))
        if busy > 0:
            kernels = "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top)
            say("16 times", f"{card}: {label} {size}x{size} frame under torch.profiler: wall "
                f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; "
                f"top: {kernels}")
        else:
            say("16 times", f"{card}: torch.profiler saw no device time: idle share not measured")
    restore_counts(saved)                      # timing launches do not count
    return k3_ms, plain_ms


# The hash-grid family (phases 17-20): the paper config, distilled from the
# lego networks with the JAX CLI's hash-grid recipe (nerf_rs_tpu/cli.py:384-402).
HASH_STEPS = 300
HASH_RECIPE = dict(lr_init=1e-2, lr_final=1e-4, adam_eps=1e-15)
HASH_WIDE = dict(levels=4, features=8)          # train --hash-levels 4 --hash-features 8
# One H100 SXM's data-sheet peaks at 700 W, for the bounds of the kernels line.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12           # dense tf32 tensor-core peak
BF16_FLOP_S = 989e12           # dense bf16 tensor-core peak
SPLIT_F32_PASSES = 6           # bf16 products an f32 product takes on K1 f32's route
# The acceptance bar of the tensor-core K1: a bf16 fine call at most a
# quarter of the CUDA-core bf16 kernel's 64.741 ms (PERF.md, PR 5).
BF16_FINE_TARGET_MS = 16.0


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def bound(n_bytes: float, ops: float, peak_ops: float):
    """(ms, "bytes" or "operations"): the least time for ``n_bytes`` moved
    at the memory rate and ``ops`` done at ``peak_ops``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_bound(net, pts, viewdirs, peak_ops: float, weight_bytes: int, passes: int = 1):
    """K1's bound for one full call of ``net`` at these inputs: points,
    dirs and the weights (``weight_bytes`` each, f32 biases) read once,
    rgb and sigma written once; the products at ``peak_ops``, ``passes``
    operations a product operation (SPLIT_F32_PASSES for split-f32)."""
    n, rays = pts.numel() // 3, viewdirs.numel() // 3
    w = sum(int(p["kernel"].numel()) * weight_bytes + 4 * int(p["bias"].numel())
            for p in net.tree().values())
    return bound(4 * (n * 7 + rays * 3) + w, passes * mlp_flops(net, False) * n, peak_ops)


def backward_bounds(net, pts, viewdirs, g_rgb, g_sigma) -> dict:
    """K2's bounds for one full call at these inputs, (ms, "bytes" or
    "operations") by route: points, dirs and cotangents read once, the
    weights read and their gradients written once (4 or 2 bytes a weight);
    three forwards of products. "float32" is the f32 mode's route: the
    recompute as K1 f32 (six bf16 passes a product) and the dW and W dz
    products as 3xTF32 (three tf32 products each); "wide_float32" the wide
    f32 mode's: the recompute on the CUDA cores (the wide f32 forward), W
    dz as 3xTF32 and dW as split-f32 (six bf16 passes, the dW kernel);
    "cuda_cores" all three forwards on the CUDA cores; "bfloat16" all
    three in bf16."""
    n = pts.numel() // 3
    fwd = mlp_flops(net, False) * n
    io = 4 * (pts.numel() + viewdirs.numel() + g_rgb.numel() + g_sigma.numel())
    n_w = sum(int(p.numel()) for p in net.parameters())

    def at(n_bytes, ms):
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= ms else (ms, "operations")

    return {"float32": at(io + 8 * n_w, (SPLIT_F32_PASSES * fwd / BF16_FLOP_S
                                         + 3 * 2 * fwd / TF32_FLOP_S) * 1e3),
            "wide_float32": at(io + 8 * n_w, (fwd / F32_FLOP_S + 3 * fwd / TF32_FLOP_S
                                              + SPLIT_F32_PASSES * fwd / BF16_FLOP_S) * 1e3),
            "cuda_cores": at(io + 8 * n_w, 3 * fwd / F32_FLOP_S * 1e3),
            "bfloat16": at(io + 6 * n_w, 3 * fwd / BF16_FLOP_S * 1e3)}


def library_mlp_ms(net, pts, viewdirs, dtype: str, sigma_only: bool) -> float:
    """The library yardstick: ``models.mlp.nerf_mlp`` (cuBLAS products,
    torch's encode and elementwise ops) in ``dtype`` on inputs and weights
    already in it, median ms of a call. The port's kernel path never calls
    it."""
    return timed_ms(library_mlp_call(net, pts, viewdirs, dtype, sigma_only))


def library_mlp_call(net, pts, viewdirs, dtype: str, sigma_only: bool):
    """library_mlp_ms's call, with its inputs and weights already cast."""
    import torch

    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tree = {layer: {k: v.detach().to(dt) for k, v in p.items()} for layer, p in net.tree().items()}
    p, d = pts.to(dt), viewdirs.to(dt)
    return lambda: nerf_mlp(tree, p, d, sigma_only=sigma_only)


def mlp_flops(net, sigma_only: bool) -> int:
    """Forward FLOPs per sample of a NeRF MLP: two per weight of the layers
    it runs (the encode and the activations are a few hundred more)."""
    skip = ("bottleneck", "viewdirs", "rgb") if sigma_only else ()
    return 2 * sum(int(p["kernel"].numel()) for layer, p in net.tree().items()
                   if layer not in skip)


@contextlib.contextmanager
def plain_encode():
    """The hash encode's plain version on CUDA tensors, inside the same
    autograd function and backward: the comparison side of phases 18-20."""
    import nerf_rs_tpu_torch.ops.kernels.hash_encode as he

    real = he._forward
    he._forward = he.hash_encode_reference
    try:
        yield
    finally:
        he._forward = real


def counters():
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_backward
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp
    from nerf_rs_tpu_torch.ops.kernels.resample import fused_resample

    return (fused_nerf_mlp, fused_nerf_mlp_backward, fused_resample, fused_hash_encode,
            fused_int8_mlp)


# The wrappers' other counts, (index in counters(), attribute): K1's
# tensor-core count, K2's bf16 count, K1's wide count, K2's wide count, the
# wide K2's dW kernel's, the wide int8 kernel's, K1's wide1k count and K2's.
SUB_COUNTS = ((0, "tc_launches"), (1, "bf16_launches"), (0, "wide_launches"),
              (1, "wide_launches"), (1, "dw_launches"), (4, "wide_launches"),
              (0, "wide1k_launches"), (1, "wide1k_launches"))


def save_counts():
    """Every launch count: each wrapper's, then SUB_COUNTS."""
    fns = counters()
    return [fn.launches for fn in fns] + [getattr(fns[i], a) for i, a in SUB_COUNTS]


def restore_counts(saved) -> None:
    fns = counters()
    for fn, n in zip(fns, saved):
        fn.launches = n
    for (i, a), n in zip(SUB_COUNTS, saved[len(fns):]):
        setattr(fns[i], a, n)


def zero_counts() -> None:
    restore_counts([0] * (len(counters()) + len(SUB_COUNTS)))


def read_counts() -> dict:
    fns = counters()
    return {**{fn.__name__: fn.launches for fn in fns}, "fused_nerf_mlp_tc": fns[0].tc_launches,
            "fused_nerf_mlp_backward_bf16": fns[1].bf16_launches,
            "fused_nerf_mlp_wide": fns[0].wide_launches,
            "fused_nerf_mlp_backward_wide": fns[1].wide_launches,
            "fused_nerf_mlp_backward_dw": fns[1].dw_launches,
            "fused_int8_mlp_wide": fns[4].wide_launches,
            "fused_nerf_mlp_wide1k": fns[0].wide1k_launches,
            "fused_nerf_mlp_backward_wide1k": fns[1].wide1k_launches}


def encode_vs_plain(tables, pts, cfg, top: float):
    """The encode kernel against its plain version on the same tables and
    points: within 1e-5 x ``top`` (max |table|) in f32, 2 bf16 ulps of the
    largest feature in bf16, and two calls bitwise equal. -> (ok, max
    |kernel - plain|, bar, what the bar is, exactly equal, bitwise). The
    caller keeps these launches out of the counts."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.hash_encode import fused_hash_encode, hash_encode_reference

    got = fused_hash_encode(tables, pts, cfg)
    again = fused_hash_encode(tables, pts, cfg)
    want = hash_encode_reference(tables, pts, cfg)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if tables.dtype == torch.float32:
        bar, what = 1e-5 * top, "1e-5 x max|table|"
    else:
        bar, what = 2 * bf16_ulp(float(want.float().abs().max())), "2 bf16 ulps of max|feature|"
    shape = (*pts.shape[:-1], cfg.levels * cfg.features)
    bitwise = torch.equal(got, again)
    ok = (tuple(got.shape) == shape and got.dtype == tables.dtype
          and bool(torch.isfinite(got).all()) and err <= bar and bitwise)
    return ok, err, bar, what, torch.equal(got.float(), want.float()), bitwise


def phase_hash_vs_plain(cam, dev):
    """The encode kernel against its plain version at the paper config and
    the wide-F config, on the points the render hands it (16384 golden
    camera rays at 64 coarse and 192 fine samples), tables U(-1, 1)."""
    import torch

    from nerf_rs_tpu_torch.config import HashGridConfig

    pts_c, pts_f, _ = main_path_inputs(cam, dev, BENCH_CHUNK)
    saved = save_counts()
    worst = 0.0
    for name, cfg in (("paper", HashGridConfig()), ("wide F=8", HashGridConfig(**HASH_WIDE))):
        gen = torch.Generator(device=dev).manual_seed(17)
        t32 = torch.rand((cfg.levels, 1 << cfg.table_log2, cfg.features), generator=gen,
                         device=dev) * 2.0 - 1.0
        top = float(t32.abs().max())
        for dtype in (torch.float32, torch.bfloat16):
            tables = t32.to(dtype)
            for label, pts in (("coarse", pts_c), ("fine", pts_f)):
                ok, err, bar, what, exact, bitwise = encode_vs_plain(tables, pts, cfg, top)
                if dtype == torch.float32:
                    worst = max(worst, err)
                say("17 hash", f"{name} (L={cfg.levels}, T=2^{cfg.table_log2}, F={cfg.features}) "
                    f"{str(dtype)[6:]} {label} {tuple(pts.shape[:-1])}: max |kernel - plain| "
                    f"{err:.3e} (bar {bar:.3e}, {what}), exactly equal {exact}, two calls "
                    f"bitwise equal {bitwise} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailure(f"the hash encode disagrees with its plain version: "
                                       f"{name}/{dtype}/{label}")
    restore_counts(saved)                      # comparison launches do not count
    return worst


def hash_setup(dev):
    """The hash-grid training job, as ``train --model hashgrid`` builds it
    at its defaults: the paper field, 4096 rays, 64 + 128 samples, the
    recipe above, the lego teacher through K1."""
    import torch

    from nerf_rs_tpu_torch.config import HashGridConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import create_train_state

    rcfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl="pallas",
                        model="hashgrid", hash=HashGridConfig())
    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=rcfg, **HASH_RECIPE)
    state = create_train_state(torch.Generator(device=dev).manual_seed(cfg.seed), cfg)
    teacher = {net: load_nerf_params(find_lego_assets() / net) for net in ("coarse", "fine")}
    dataset = DistillationDataset(teacher, cfg=rcfg.replace(model="mlp"), seed=cfg.seed,
                                  device=dev)
    return state, dataset, cfg, random.key(cfg.seed + 1, dev)


def phase_hash_step_vs_plain(dev):
    """One hash-grid step from the same state and batch, the encode kernel
    against its plain version (same backward): loss and parameters."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    saved = save_counts()
    results, batch = {}, None
    for label in ("kernel", "plain"):
        state, dataset, cfg, key = hash_setup(dev)
        if batch is None:
            batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
        with plain_encode() if label == "plain" else contextlib.nullcontext():
            state, metrics = train_step(state, batch, random.fold_in(key, torch.tensor(0)), cfg)
        torch.cuda.synchronize()
        results[label] = (float(metrics["loss"]), state.params["shared"])
    restore_counts(saved)                      # comparison launches do not count
    (loss_k, field_k), (loss_p, field_p) = results["kernel"], results["plain"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    diffs = {name: (p.detach() - field_p.weights[name].detach()).abs()
             for name, p in field_k.weights.items()}
    worst = max(float(d.max()) for d in diffs.values())
    share = sum(int((d > 1e-5).sum()) for d in diffs.values()) / sum(d.numel() for d in diffs.values())
    same = all(torch.equal(p, field_p.weights[n]) for n, p in field_k.weights.items())
    ok = loss_rel <= 1e-5 and worst < 2 * cfg.lr_init and share < 1e-3
    say("18 hash step", f"one f32 hash-grid step, encode kernel vs plain encode: loss {loss_k:.7f} "
        f"vs {loss_p:.7f} (rel {loss_rel:.2e}, bar 1e-5); params after the step: max |d| "
        f"{worst:.3e} (bar < {2 * cfg.lr_init:g}), share of entries > 1e-5 {share:.2e} (bar < "
        f"1e-3), bitwise equal {same} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the hash-grid step with the kernel disagrees with the plain step")


def phase_hash_train(dev):
    """The hash-grid training path: HASH_STEPS steps from a random init,
    with the launch counts set to 0 just before and read just after."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = hash_setup(dev)
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for step in range(HASH_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    secs = time.perf_counter() - t0
    launches = read_counts()
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    ok = (all(math.isfinite(v) for v in losses) and last < first
          and launches["fused_hash_encode"] == 2 * HASH_STEPS
          and launches["fused_nerf_mlp"] == 2 * HASH_STEPS
          and launches["fused_nerf_mlp_backward"] == 0)
    say("18 hash train", f"{HASH_STEPS} steps, paper hash grid (L=16, T=2^17, F=2), {TRAIN_RAYS} "
        f"rays, {N_COARSE}+{N_FINE} samples, lr 1e-2 -> 1e-4, eps 1e-15: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, mean of the first 10 {first:.5f}, of the last 10 {last:.5f}; launches "
        f"hash encode {launches['fused_hash_encode']} (expected {2 * HASH_STEPS}), K1 (teacher) "
        f"{launches['fused_nerf_mlp']} (expected {2 * HASH_STEPS}), K2 "
        f"{launches['fused_nerf_mlp_backward']} (expected 0); {secs:.1f} s with the teacher "
        f"batches -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("hash-grid training did not reduce the loss, or went around the encode "
                           "kernel")
    return state, cfg, launches


def hash_render_cfg(hcfg, dtype: str = "float32"):
    from nerf_rs_tpu_torch.config import RenderConfig

    return RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=BENCH_CHUNK,
                        model="hashgrid", hash=hcfg, dtype=dtype)


def phase_hash_frames(field, hcfg, cam, dev, lego_256, lego_800, card):
    """Frames of the trained field: dense with the kernel and with the
    plain encode at 256x256 and 800x800, bf16, the 800x800 accel+K3 frame
    on a grid swept through the field, and PSNR against the lego teacher."""
    import torch

    from nerf_rs_tpu_torch.accel import build_scene_grid, hashgrid_grid_kwargs

    def frame(size, cfg, grid=None, plain=False):
        with plain_encode() if plain else contextlib.nullcontext():
            img, ms = render_accel(field, field, cam, dev, cfg, grid, size)
        return img.cpu().numpy(), ms

    dense = hash_render_cfg(hcfg)
    out = {}
    for size in (H, BENCH_SIZE):
        chunks = -(-size * size // BENCH_CHUNK)
        torch.cuda.synchronize()
        zero_counts()
        out[size], ms = frame(size, dense)
        launches = read_counts()
        plain, plain_ms = frame(size, dense, plain=True)
        plain_db = psnr(plain, out[size])
        teacher_db = psnr(out[size], lego_256 if size == H else lego_800)
        ok = (plain_db >= PLAIN_BAR_DB and launches["fused_hash_encode"] == 2 * chunks
              and launches["fused_nerf_mlp"] == 0)
        say("19 hash frames", f"{size}x{size} f32 dense, {chunks} chunks: encode launches "
            f"{launches['fused_hash_encode']} (expected {2 * chunks}); plain-encode frame vs "
            f"kernel frame {plain_db:.2f} dB (bar >= {PLAIN_BAR_DB}); vs the lego teacher's frame "
            f"{teacher_db:.2f} dB (reported); first frames {ms:.1f} ms kernel, {plain_ms:.1f} ms "
            f"plain on {card} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"the {size}x{size} hash-grid frame went around the kernel or "
                               f"differs from the plain encode's")
    bf16, _ = frame(BENCH_SIZE, hash_render_cfg(hcfg, "bfloat16"))
    bf16_db = psnr(bf16, out[BENCH_SIZE])
    grid_cfg = hash_render_cfg(hcfg)
    t0 = time.perf_counter()
    grid = build_scene_grid(field, field, resolution=GRID_RES, **hashgrid_grid_kwargs(grid_cfg))
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    acfg = accel_cfg(chunk=BENCH_CHUNK).replace(model="hashgrid", hash=hcfg)
    hit, chunks = rendered_chunks(grid, cam, BENCH_SIZE, acfg, dev)
    torch.cuda.synchronize()
    zero_counts()
    fast, fast_ms = frame(BENCH_SIZE, acfg, grid)
    launches = read_counts()
    accel_db = psnr(fast, out[BENCH_SIZE])
    ok = (bf16_db >= BF16_FRAME_BAR_DB and accel_db >= ACCEL_BAR_DB
          and launches["fused_hash_encode"] == 2 * chunks
          and launches["fused_resample"] == chunks)
    say("19 hash frames", f"{BENCH_SIZE}x{BENCH_SIZE}: bf16 dense vs f32 dense {bf16_db:.2f} dB (bar "
        f">= {BF16_FRAME_BAR_DB}); grid {GRID_RES}^3 swept through the field in {grid_ms:.1f} ms, "
        f"{float(grid.occ.float().mean()):.4f} of the cells occupied; f32 accel+K3 ({PROBES} "
        f"probes, stride {STRIDE}, packing) vs f32 dense {accel_db:.2f} dB (bar >= "
        f"{ACCEL_BAR_DB}); {chunks} chunks rendered, launches encode "
        f"{launches['fused_hash_encode']} (expected {2 * chunks}), K3 "
        f"{launches['fused_resample']} (expected {chunks}); rays that miss "
        f"{1 - float(hit.float().mean()):.4f}; first accel frame {fast_ms:.1f} ms -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the hash-grid bf16 or accel frames miss their bars, or went around the "
                           "kernels")
    return grid, dense, acfg


def step_points(batch, samples: int, dev):
    """Points along a training batch's own rays: ``samples`` stratified t
    a ray over [near, far] (the coarse pass's layout, and at 192 the fine
    pass's count), ray-ordered as the step hands them to the encode."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.sampling import stratified_samples

    rays = batch["origins"].shape[0]
    keys = random.fold_in(random.key(0, dev), torch.arange(rays, device=dev))
    t = stratified_samples(keys, batch["near"], batch["far"], samples, (rays,))
    return (batch["origins"][:, None, :] + batch["dirs"][:, None, :] * t[..., None]).contiguous()


def encode_bound(hc, n: int, rows: int, element_bytes: int):
    """The encode's bound for ``n`` samples: the points read once, the
    ``rows`` distinct table rows the samples' corners touch read once, the
    output written once; its operations at the f32 peak."""
    return bound(12 * n + element_bytes * hc.features * (rows + n * hc.levels),
                 n * hc.levels * (3 * 6 + 8 * 3 + 8 * 2 * hc.features), F32_FLOP_S)


def phase_hash_times(field, cfg, cam, dev, grid, dense, acfg, card):
    """The encode kernel, its plain version, its bound and one index_select
    of the same rows per call at the main path's four shapes (the training
    step's 4096 rays x 64 and x 192 along its own rays, the 800x800 frame's
    16384 x 64 and x 192 a chunk), f32 and bf16; train-step times with the
    kernel and the plain encode; the 800x800 frames with their idle
    shares."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.hash_encode import (
        _Corners,
        _lattice,
        fused_hash_encode,
        hash_encode_reference,
    )
    from nerf_rs_tpu_torch.train import train_step

    hcfg = cfg.render.hash
    saved = save_counts()
    state, dataset, cfg, key = hash_setup(dev)
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    pts_c, pts_f, _ = main_path_inputs(cam, dev, BENCH_CHUNK)
    shapes = {(TRAIN_RAYS, N_COARSE): step_points(batch, N_COARSE, dev),
              (TRAIN_RAYS, N_COARSE + N_FINE): step_points(batch, N_COARSE + N_FINE, dev),
              (BENCH_CHUNK, N_COARSE): pts_c, (BENCH_CHUNK, N_COARSE + N_FINE): pts_f}
    tables32 = field.weights["hash_tables"].detach()
    table_rows = hcfg.levels * (1 << hcfg.table_log2)
    times = {}
    for (rays, samples), pts in shapes.items():
        n = pts.numel() // 3
        corners = _Corners(_lattice(pts, hcfg), hcfg, 1 << hcfg.table_log2, dev)
        idx = torch.cat([corners(c)[0].reshape(-1) for c in range(8)])
        touched = torch.zeros(table_rows, dtype=torch.bool, device=dev)
        touched[idx] = True
        rows = int(touched.sum())
        for dtype in (torch.float32, torch.bfloat16):
            tables = tables32.to(dtype)
            flat = tables.reshape(-1, hcfg.features)
            k_ms = timed_ms(lambda: fused_hash_encode(tables, pts, hcfg), inner=10)
            p_ms = timed_ms(lambda: hash_encode_reference(tables, pts, hcfg), inner=2)
            lib_ms = timed_ms(lambda: flat.index_select(0, idx), inner=10)
            bnd = encode_bound(hcfg, n, rows, tables.element_size())
            times[(rays, samples, dtype)] = dict(shape=[rays, samples], dtype=str(dtype)[6:],
                                                 ms=k_ms, plain_ms=p_ms, bound_ms=bnd[0],
                                                 bound_by=bnd[1], library_ms=lib_ms)
            say("20 hash times", f"{card}: hash encode {rays} x {samples} {str(dtype)[6:]} "
                f"(L={hcfg.levels}, F={hcfg.features}): kernel {k_ms:.4f} ms, plain {p_ms:.3f} "
                f"ms, index_select of the same {idx.numel()} rows {lib_ms:.4f} ms per call "
                f"(medians of 3); bound {bnd[0]:.4f} ms ({bnd[1]}; {rows} distinct rows), "
                f"{bnd[0] / k_ms:.1%} of it; {n * hcfg.levels * 8 / k_ms * 1e3:.4g} rows "
                f"gathered per s")
        del idx, corners, touched
    step_key = random.fold_in(key, torch.tensor(0))
    step_ms = {"kernel": timed_ms(lambda: train_step(state, batch, step_key, cfg))}
    with plain_encode():
        step_ms["plain"] = timed_ms(lambda: train_step(state, batch, step_key, cfg))
    for label in ("kernel", "plain"):
        say("20 hash times", f"{card}: hash-grid train step ({label} encode), {TRAIN_RAYS} rays "
            f"{N_COARSE}+{N_FINE}, f32: {step_ms[label]:.1f} ms, "
            f"{TRAIN_RAYS / step_ms[label] * 1e3:,.0f} rays/s fwd+bwd (median of 3, teacher batch "
            f"excluded)")
    size = BENCH_SIZE
    for label, c, g in (("dense", dense, None), ("accel, K3", acfg, grid)):
        ms = timed_ms(lambda: render_accel(field, field, cam, dev, c, g, size), warm=False)
        wall, busy, top = profile_frame(lambda: render_accel(field, field, cam, dev, c, g, size))
        line = (f"{card}: hash-grid {size}x{size} f32 frame, {label}: {ms:.1f} ms, "
                f"{size * size / ms * 1e3:,.0f} rays/s (median of 3)")
        if busy > 0:
            kernels = "; ".join(f"{name[:60]} {t:.1f} ms" for name, t in top)
            line += (f"; under torch.profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
                     f"idle share {1 - busy / wall:.4f}; top: {kernels}")
        else:
            line += "; torch.profiler saw no device time: idle share not measured"
        say("20 hash times", line)
    restore_counts(saved)                      # timing launches do not count
    return times


# The int8 W8A8 family (phases 21-24): the lego networks quantized after
# training (render --impl int8), and a student distilled through the QAT
# forward as the JAX CLI's train defaults with --impl int8qat do.
QAT_STEPS = 50
INT8_RGB_ATOL = 2e-6           # only the kernel's expf may differ from torch.sigmoid's
INT8_VS_F32_BAR_DB = 25.0      # tests/test_quant.py:76, post-training int8 vs exact frame
QAT_BAR_DB = 40.0              # the trained student's kernel frame vs its fake-quant frame
INT8_OPS_S = 1979e12           # one H100 SXM's dense int8 tensor-core peak (data sheet, 700 W)
# sha256 of the narrow int8 kernel's outputs on phase 21's inputs (int8_digest:
# rgb, then sigma), as the narrow kernel's sources before the wide int8 kernel
# gave them on an H100 80GB HBM3 (tools/torch_k1_parent_ab.py --only int8
# prints both sides' digests; PERF.md): the narrow kernel is held to them bit
# for bit.
NARROW_INT8_SHA256 = {
    "coarse": "408a631679d58301f787aca93cebbaa946edbf2dc7d351757cb224a956c8f128",
    "fine": "fb2caa4172d3ac3d34878e009412598287a06f81495964d4aebd06317e65b6b7"}
# The wide int8 kernel against its plain version (phase 21): the lego
# networks widened by widen_nerf (coarse sigma-only, fine full, as the render
# pairs them), and random networks (width, v_width, depth, skip_at), each
# sigma-only and full: narrow in width but deep (256/128/20) and the
# envelope's corner (512/512/32).
WIDE_INT8_LEGOS = ((384, 192, 8), (512, 256, 8), (512, 256, 20))
WIDE_INT8_RANDOM = ((512, 512, 32, 10), (256, 128, 20, 4))


def int8_digest(rgb, sigma) -> str:
    """sha256 of an int8 call's outputs: rgb's then sigma's f32 bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in (rgb, sigma):
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def plain_int8():
    """The int8 kernel's plain version on CUDA tensors, wherever the render
    path asks for the kernel: the comparison side of phases 22 and 24."""
    import nerf_rs_tpu_torch.ops.kernels.int8_mlp as im

    real = im.fused_int8_mlp
    im.fused_int8_mlp = im.fused_int8_mlp_reference
    try:
        yield
    finally:
        im.fused_int8_mlp = real


def phase_int8_vs_plain(coarse, fine, cam, dev):
    """The int8 kernel against its plain version on phase 3's inputs: the
    coarse network sigma-only at RAY_CHUNK x 64, the fine one full at
    RAY_CHUNK x 192. Sigma bitwise, rgb within INT8_RGB_ATOL, two calls
    bitwise equal."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference

    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    saved = save_counts()
    worst, cases = 0.0, []
    with torch.no_grad():
        for name, net, pts, sigma_only in (("coarse", coarse, pts_c, True),
                                           ("fine", fine, pts_f, False)):
            rgb, sig = fused_int8_mlp(net, pts, vd, sigma_only=sigma_only)
            rgb2, sig2 = fused_int8_mlp(net, pts, vd, sigma_only=sigma_only)
            rgb_r, sig_r = fused_int8_mlp_reference(net, pts, vd, sigma_only=sigma_only)
            torch.cuda.synchronize()
            shape = tuple(pts.shape[:-1])
            finite = bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(sig).all())
            same_sigma = torch.equal(sig, sig_r)
            rgb_err = float((rgb - rgb_r).abs().max())
            sig_err = float((sig - sig_r).abs().max())
            bitwise = torch.equal(rgb, rgb2) and torch.equal(sig, sig2)
            digest = int8_digest(rgb, sig)
            parent = digest == NARROW_INT8_SHA256[name]
            ok = (tuple(sig.shape) == shape and tuple(rgb.shape) == (*shape, 3) and finite
                  and same_sigma and rgb_err <= INT8_RGB_ATOL and bitwise and parent)
            say("21 int8", f"{name} {shape} sigma_only={sigma_only}: sigma bitwise equal "
                f"{same_sigma} ({int((sig != sig_r).sum())} samples differ, max |d sigma| "
                f"{sig_err:.3e}), max |d rgb| {rgb_err:.3e} (atol {INT8_RGB_ATOL}), two calls "
                f"bitwise equal {bitwise}; outputs sha256 {digest[:16]}, bit for bit the "
                f"parent's (NARROW_INT8_SHA256): {parent} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"the int8 kernel disagrees with its plain version: {name}")
            worst = max(worst, rgb_err, sig_err)
            cases.append((name, net, pts, sigma_only))
    restore_counts(saved)                      # comparison launches do not count
    return worst, cases, vd


def phase_wide_int8_vs_plain(cam, dev, assets: Path):
    """The wide int8 kernel against its plain version at phase 21's bars on
    phase 3's inputs (RAY_CHUNK x 64 sigma-only, RAY_CHUNK x 192 full):
    the lego networks widened to WIDE_INT8_LEGOS and the random networks
    WIDE_INT8_RANDOM; every call on the wide kernel. -> (worst error,
    {(arch, sigma_only): (net, points)}, viewdirs) for the times."""
    import torch

    from nerf_rs_tpu_torch.config import ArchConfig
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference

    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    saved = save_counts()
    nets = []
    for arch in WIDE_INT8_LEGOS:
        for seed, (net, pts, so) in enumerate((("coarse", pts_c, True), ("fine", pts_f, False))):
            tree = widen_nerf(load_nerf_params(assets / net), *arch, seed=seed)
            nets.append((f"lego {net} widened to {arch}", arch, NerfMLP(tree, device=dev), pts,
                         so))
    for arch in WIDE_INT8_RANDOM:
        g = torch.Generator(device=dev).manual_seed(21)
        net = NerfMLP(init_nerf_params(g, ArchConfig(*arch)), device=dev)
        nets += [(f"random {arch}", arch[:3], net, pts, so)
                 for pts, so in ((pts_c, True), (pts_f, False))]
    worst, cases = 0.0, {}
    with torch.no_grad():
        for label, arch, net, pts, so in nets:
            wide0 = fused_int8_mlp.wide_launches
            rgb, sig = fused_int8_mlp(net, pts, vd, sigma_only=so)
            rgb2, sig2 = fused_int8_mlp(net, pts, vd, sigma_only=so)
            wide = fused_int8_mlp.wide_launches - wide0
            rgb_r, sig_r = fused_int8_mlp_reference(net, pts, vd, sigma_only=so)
            torch.cuda.synchronize()
            shape = tuple(pts.shape[:-1])
            finite = bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(sig).all())
            same_sigma = torch.equal(sig, sig_r)
            rgb_err = float((rgb - rgb_r).abs().max())
            sig_err = float((sig - sig_r).abs().max())
            bitwise = torch.equal(rgb, rgb2) and torch.equal(sig, sig2)
            ok = (tuple(sig.shape) == shape and tuple(rgb.shape) == (*shape, 3) and finite
                  and same_sigma and rgb_err <= INT8_RGB_ATOL and bitwise and wide == 2)
            say("21 int8 wide", f"{label} {shape} sigma_only={so}: sigma bitwise equal "
                f"{same_sigma} ({int((sig != sig_r).sum())} samples differ, max |d sigma| "
                f"{sig_err:.3e}), max |d rgb| {rgb_err:.3e} (atol {INT8_RGB_ATOL}), two calls "
                f"bitwise equal {bitwise}, wide int8 launches {wide} (expected 2) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"the wide int8 kernel disagrees with its plain version: "
                                   f"{label}")
            worst = max(worst, rgb_err, sig_err)
            if label.startswith("lego"):
                cases[(arch, so)] = (net, pts)
    restore_counts(saved)                      # comparison launches do not count
    return worst, cases, vd


def phase_wide_int8_times(cases, vd, card):
    """The wide int8 kernel, its plain version, torch._int_mm of the same
    layers and the bound at 512/256/8 (fine full, coarse sigma-only) and
    384/192/8 (fine full), on the widened legos. -> {(arch, sigma_only):
    (ms, plain ms, bound, library ms)}."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference

    saved = save_counts()
    times = {}
    with torch.no_grad():
        for key in (((512, 256, 8), False), ((512, 256, 8), True), ((384, 192, 8), False)):
            net, pts = cases[key]
            so = key[1]
            k_ms = timed_ms(lambda: fused_int8_mlp(net, pts, vd, sigma_only=so))
            p_ms = timed_ms(lambda: fused_int8_mlp_reference(net, pts, vd, sigma_only=so))
            n, rays = pts.numel() // 3, vd.numel() // 3
            pk = net.packed("int8")
            ops = mlp_flops(net, so)
            bnd = bound(4 * (n * 7 + rays * 3) + sum(
                t.numel() * t.element_size() for t in (pk.weights, pk.epilogue)), ops * n,
                INT8_OPS_S)
            lib_ms = int_mm_ms(net, n, so)
            times[key] = (k_ms, p_ms, bnd, lib_ms)
            say("24 int8 times", f"{card}: wide int8 kernel at {key[0]}, {tuple(pts.shape[:-1])} "
                f"{'sigma-only' if so else 'full'} ({ops / 1e6:.3f} M operations a sample): "
                f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, torch._int_mm of the same layers "
                f"{lib_ms:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}, at {INT8_OPS_S / 1e12:g} "
                f"TOP/s), {bnd[0] / k_ms:.1%} of it (medians of 3)")
    restore_counts(saved)                      # timing launches do not count
    return times


def phase_int8_frames(coarse, fine, cam, dev, img_f32, grid):
    """The int8 render path's main run: the post-training W8A8 256x256
    frame through the kernel, with the counts set to 0 just before and read
    just after; against the f32 K1 frame and the plain int8 frame; then
    the same frame on the accel path (phase 12's grid, K3)."""
    import torch

    n_chunks = -(-H * W // RAY_CHUNK)
    torch.cuda.synchronize()
    zero_counts()
    img, ms = render(coarse, fine, cam, dev, "int8", "float32")
    launches = read_counts()
    with plain_int8():
        plain, plain_ms = render(coarse, fine, cam, dev, "int8", "float32")
    f32_db, plain_db = psnr(img, img_f32), psnr(plain, img)
    ok = (f32_db > INT8_VS_F32_BAR_DB and plain_db >= PLAIN_BAR_DB
          and launches["fused_int8_mlp"] == 2 * n_chunks and launches["fused_nerf_mlp"] == 0
          and launches["fused_nerf_mlp_backward"] == 0)
    say("22 int8 frames", f"post-training int8 frame {H}x{W} {N_COARSE}+{N_FINE}: vs the f32 K1 "
        f"frame {f32_db:.2f} dB (bar > {INT8_VS_F32_BAR_DB}); plain int8 frame vs kernel frame "
        f"{plain_db:.2f} dB (bar >= {PLAIN_BAR_DB}); launches int8 {launches['fused_int8_mlp']} "
        f"(expected {2 * n_chunks}), K1 {launches['fused_nerf_mlp']} (expected 0); first frames "
        f"{ms:.1f} ms kernel, {plain_ms:.1f} ms plain -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the int8 frame misses its bars or went around the int8 kernel")
    cfg = accel_cfg().replace(impl="int8")
    hit, chunks = rendered_chunks(grid, cam, H, cfg, dev)
    torch.cuda.synchronize()
    zero_counts()
    fast, fast_ms = render_accel(coarse, fine, cam, dev, cfg, grid, H)
    accel = read_counts()
    accel_db = psnr(fast.cpu().numpy(), img)
    ok = (accel_db >= ACCEL_BAR_DB and accel["fused_int8_mlp"] == 2 * chunks
          and accel["fused_resample"] == chunks and accel["fused_nerf_mlp"] == 0)
    say("22 int8 frames", f"int8 accel frame {H}x{W} (grid {GRID_RES}^3, {PROBES} probes, stride "
        f"{STRIDE}, packing, K3) vs the dense int8 frame {accel_db:.2f} dB (bar >= "
        f"{ACCEL_BAR_DB}); {chunks} chunks rendered, launches int8 {accel['fused_int8_mlp']} "
        f"(expected {2 * chunks}), K3 {accel['fused_resample']} (expected {chunks}); "
        f"{fast_ms:.1f} ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the int8 accel frame misses its bar or went around the kernels")
    return launches


def phase_qat(cam, dev, img_f32):
    """QAT_STEPS int8qat distillation steps from a random init (the 8x256
    student, TRAIN_RAYS rays, 64 + 128, f32, the teacher through K1), with
    the counts set to 0 just before and read just after; then the trained
    student rendered through the int8 kernel and through the fake-quant
    forward."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    state, dataset, cfg, key = distill_setup(dev, "int8qat")
    batches = dataset.batches(cfg.batch_rays, seed=cfg.seed)
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for step in range(QAT_STEPS):
        state, metrics = train_step(state, next(batches), random.fold_in(key, torch.tensor(step)),
                                    cfg)
        losses.append(float(metrics["loss"]))
    secs = time.perf_counter() - t0
    launches = read_counts()
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    ok = (all(math.isfinite(v) for v in losses) and last < first
          and launches["fused_nerf_mlp"] == 2 * QAT_STEPS
          and launches["fused_nerf_mlp_backward"] == 0 and launches["fused_int8_mlp"] == 0)
    say("23 qat", f"{QAT_STEPS} int8qat steps, 8x256 student, {TRAIN_RAYS} rays, "
        f"{N_COARSE}+{N_FINE} samples: loss {losses[0]:.5f} -> {losses[-1]:.5f}, mean of the first "
        f"10 {first:.5f}, of the last 10 {last:.5f}; launches K1 (teacher) "
        f"{launches['fused_nerf_mlp']} (expected {2 * QAT_STEPS}), K2 "
        f"{launches['fused_nerf_mlp_backward']} (expected 0), int8 {launches['fused_int8_mlp']} "
        f"(expected 0); {secs:.1f} s with the teacher batches -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("QAT did not reduce the loss, or the student's steps went through a "
                           "kernel")
    student = (state.params["coarse"], state.params["fine"])
    real, _ = render(*student, cam, dev, "int8", "float32")
    fake, _ = render(*student, cam, dev, "int8qat", "float32")
    qat_db, teacher_db = psnr(real, fake), psnr(real, img_f32)
    ok = qat_db >= QAT_BAR_DB
    say("23 qat", f"trained student {H}x{W}: int8 kernel frame vs int8qat frame {qat_db:.2f} dB "
        f"(bar >= {QAT_BAR_DB}); vs the lego teacher's f32 frame {teacher_db:.2f} dB (reported) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the QAT student's int8 frame differs from its fake-quant frame")


def int_mm_ms(net, n: int, sigma_only: bool) -> float:
    """The library yardstick: torch._int_mm of int8 codes layer by layer at
    the network's shapes for n samples, each layer's K and N padded to
    multiples of 8 as it requires, summed over the layers (the products
    only: no encode, requantize or dequant)."""
    import torch

    dev = next(net.parameters()).device
    skip = ("bottleneck", "viewdirs", "rgb") if sigma_only else ()
    acts, total = {}, 0.0
    for layer, p in net.tree().items():
        if layer in skip:
            continue
        k, m = (-(-int(d) // 8) * 8 for d in p["kernel"].shape)
        if k not in acts:
            acts[k] = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        total += timed_ms(lambda: torch._int_mm(acts[k], w.t()), inner=5)
    return total


def phase_int8_times(cases, vd, cam, dev, card):
    """The int8 kernel, its plain version and _int_mm at the phase-21
    shapes; the int8 256x256 frame with the kernel and with the plain
    version; the QAT step and its peak memory."""
    import torch

    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import fused_int8_mlp, fused_int8_mlp_reference
    from nerf_rs_tpu_torch.train import train_step

    saved = save_counts()
    times = {}
    with torch.no_grad():
        for name, net, pts, sigma_only in cases:
            kw = dict(sigma_only=sigma_only)
            k_ms = timed_ms(lambda: fused_int8_mlp(net, pts, vd, **kw))
            p_ms = timed_ms(lambda: fused_int8_mlp_reference(net, pts, vd, **kw))
            lib_ms = int_mm_ms(net, pts.numel() // 3, sigma_only)
            times[name] = (k_ms, p_ms, lib_ms)
            say("24 int8 times", f"{card}: {name} {tuple(pts.shape[:-1])} sigma_only={sigma_only}: "
                f"int8 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, torch._int_mm of the same "
                f"layers {lib_ms:.3f} ms (medians of 3)")
    coarse, fine = cases[0][1], cases[1][1]
    frame_ms = {"kernel": timed_ms(lambda: render(coarse, fine, cam, dev, "int8", "float32"))}
    with plain_int8():
        frame_ms["plain"] = timed_ms(lambda: render(coarse, fine, cam, dev, "int8", "float32"))
    say("24 int8 times", f"{card}: int8 frame {H}x{W} {N_COARSE}+{N_FINE}: kernel "
        f"{frame_ms['kernel']:.1f} ms, plain {frame_ms['plain']:.1f} ms (medians of 3)")
    wall, busy, top = profile_frame(lambda: render(coarse, fine, cam, dev, "int8", "float32"))
    if busy > 0:
        kernels = "; ".join(f"{name[:60]} {t:.1f} ms" for name, t in top)
        say("24 int8 times", f"{card}: int8 frame under torch.profiler: wall {wall:.1f} ms, device "
            f"busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; top: {kernels}")
    else:
        say("24 int8 times", f"{card}: torch.profiler saw no device time: idle share not measured")
    state, dataset, cfg, key = distill_setup(dev, "int8qat")
    batch = next(dataset.batches(cfg.batch_rays, seed=cfg.seed))
    step_key = random.fold_in(key, torch.tensor(0))
    train_step(state, batch, step_key, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = timed_ms(lambda: train_step(state, batch, step_key, cfg), warm=False)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    say("24 int8 times", f"{card}: int8qat train step, {TRAIN_RAYS} rays {N_COARSE}+{N_FINE}: "
        f"{step_ms:.1f} ms, {TRAIN_RAYS / step_ms * 1e3:,.0f} rays/s fwd+bwd (median of 3, "
        f"teacher batch excluded), peak device memory {peak:.2f} GiB")
    restore_counts(saved)                      # timing launches do not count
    return times


# The checkpoint, dataset and front-end slice (phase 25): a nerf_synthetic
# scene rendered from the lego networks, learned through the CLI as a user
# runs it (`train --data`, resume, SIGTERM), then rendered, exported,
# evaluated and served from its checkpoints.
SCENE_VIEWS, SCENE_SIZE = 16, 200
SCENE_ANGLE_X = 0.6911112070083618      # nerf_synthetic lego's camera_angle_x
DATA_STEPS, DATA_RESUME_STEPS, DATA_CKPT_EVERY = 40, 60, 20
HASH_DATA_STEPS = 20
PAETH_VIEWS = 4                         # 800x800 frames whose PNG decode is timed
STEP_RUN = 5                            # steps timed back to back
SIGTERM_LIMIT_S = 120


def write_scene(coarse, fine, dev, root: Path) -> None:
    """SCENE_VIEWS views of SCENE_SIZE^2 of the lego networks through K1
    f32 (64 + 128 samples), from the upper hemisphere at radius 4.03 looking
    at the origin, z up: the PNGs by the port's own writer and a
    ``transforms_train.json`` whose c2w columns are right, up, -forward and
    the position."""
    import numpy as np

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.image import save_png
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.rays import Camera
    from nerf_rs_tpu_torch.render import render_image

    cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=BENCH_CHUNK, impl="pallas")
    rng = np.random.default_rng(0)
    half = np.float32(0.5 * SCENE_ANGLE_X)     # atan(0.5 w / focal)
    frames = []
    for i in range(SCENE_VIEWS):
        theta, elev = 2.0 * math.pi * i / SCENE_VIEWS, rng.uniform(0.2, 1.2)
        pos = (4.03 * np.array([math.cos(elev) * math.cos(theta),
                                math.cos(elev) * math.sin(theta), math.sin(elev)])).astype(np.float32)
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, pos
        cam = Camera(position=pos, forward=fwd.astype(np.float32), up=up.astype(np.float32),
                     alpha_width=half, alpha_height=half, near=np.float32(2.0),
                     far=np.float32(6.0))
        img = render_image(coarse, fine, cam, SCENE_SIZE, SCENE_SIZE, random.key(i, dev), cfg,
                           device=dev)
        save_png(root / f"r_{i}.png", img, SCENE_SIZE, SCENE_SIZE)
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": SCENE_ANGLE_X, "frames": frames}))


def cli_run(argv) -> str:
    """``nerf_rs_tpu_torch.cli.main(argv)`` in this process: its standard
    output; a non-zero exit fails the phase."""
    import io

    from nerf_rs_tpu_torch import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    except SystemExit as e:
        rc = e.code
    if rc != 0:
        raise PhaseFailure(f"`{' '.join(argv[:1])}` exited with {rc!r}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def sigterm_train(scene: Path, ck: Path):
    """``python -m nerf_rs_tpu_torch train --data`` as a subprocess with
    --steps 100000, SIGTERM after its first step line: (exit code, output,
    seconds from the signal to the exit, killed at SIGTERM_LIMIT_S)."""
    import os
    import signal
    import threading

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerf_rs_tpu_torch", "train", "--data", str(scene),
         "--checkpoint-dir", str(ck), "--steps", "100000", "--log-every", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killed = []

    def kill():
        killed.append(True)
        proc.kill()

    timer = threading.Timer(SIGTERM_LIMIT_S, kill)
    timer.start()
    t_sig = None
    try:
        out = []
        for line in proc.stdout:
            out.append(line)
            if line.startswith("step "):
                t_sig = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                break
        out.append(proc.stdout.read())
        rc = proc.wait()
        secs = time.perf_counter() - t_sig if t_sig is not None else float("nan")
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    return rc, "".join(out), secs, bool(killed)


def paeth_png(px) -> bytes:
    """(H, W, C) u8 -> an 8-bit PNG with every row Paeth-filtered, as
    encoders that pick a filter per row often write photographs."""
    import struct
    import zlib

    import numpy as np

    h, w, c = px.shape
    p = px.astype(np.int16)
    a, b, cc = np.zeros_like(p), np.zeros_like(p), np.zeros_like(p)
    a[:, 1:], b[1:], cc[1:, 1:] = p[:, :-1], p[:-1], p[:-1, :-1]
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((p - pred) & 0xFF).astype(np.uint8).reshape(h, -1)], axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def pageable_batches(dataset, batch_rays: int, seed: int):
    """``dataset``'s batches gathered in pageable host memory and copied
    with a blocking ``.to``: the comparison side of phase 25's step times."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    near = torch.tensor(dataset.near, dtype=torch.float32, device=dataset.device)
    far = torch.tensor(dataset.far, dtype=torch.float32, device=dataset.device)
    while True:
        idx = rng.integers(0, len(dataset), size=batch_rays)
        yield {"origins": torch.from_numpy(dataset.frame_origins[dataset.frame_idx[idx]]).to(
                   dataset.device),
               "dirs": torch.from_numpy(dataset.dirs[idx]).to(dataset.device),
               "rgb": torch.from_numpy(dataset.rgb[idx]).to(dataset.device),
               "near": near, "far": far}


def write_paeth_scene(scene: Path, out: Path, views: int):
    """The first ``views`` frames of ``scene`` at nerf_synthetic's 800x800
    (each pixel 4x4, the alpha 255 less the smallest channel) as RGBA PNGs
    with every row Paeth: (the frames' pixels, the bytes of the first)."""
    import numpy as np

    from nerf_rs_tpu_torch.io.image import load_png

    meta = json.loads((scene / "transforms_train.json").read_text())
    meta["frames"] = meta["frames"][:views]
    out.mkdir()
    first, pixels = None, []
    for frame in meta["frames"]:
        rgb = load_png(scene / f"{frame['file_path']}.png")[..., :3].repeat(4, 0).repeat(4, 1)
        px = np.concatenate([rgb, 255 - rgb.min(axis=-1, keepdims=True)], axis=-1)
        data = paeth_png(px)
        (out / f"{frame['file_path']}.png").write_bytes(data)
        first = data if first is None else first
        pixels.append(px)
    (out / "transforms_train.json").write_text(json.dumps(meta))
    return pixels, first


def phase_data(coarse, fine, cam, dev, card):
    """Phase 25 in a temporary directory, removed when the phase ends."""
    with tempfile.TemporaryDirectory(prefix="nerf_rs_tpu_torch_data_") as tmp:
        run_phase_data(Path(tmp), coarse, fine, cam, dev, card)


def run_phase_data(root: Path, coarse, fine, cam, dev, card):
    """Phase 25: the checkpoint, dataset and front-end slice through the
    CLI, at the JAX CLI's train defaults (8x256, 4096 rays, 64 + 128, f32,
    --impl pallas), with the launch counts set to 0 just before each run
    and read just after."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from nerf_rs_tpu_torch import api, serve
    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import BlenderDataset
    from nerf_rs_tpu_torch.io import checkpoint as ckpt_io
    from nerf_rs_tpu_torch.io.image import decode_png, load_ppm, save_ppm
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image
    from nerf_rs_tpu_torch.train import train_step

    t_phase = time.perf_counter()
    scene = root / "scene"
    scene.mkdir()
    t0 = time.perf_counter()
    write_scene(coarse, fine, dev, scene)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataset = BlenderDataset(scene, device=dev)
    load_s = time.perf_counter() - t0
    say("25 data", f"scene: {SCENE_VIEWS} views of {SCENE_SIZE}x{SCENE_SIZE} rendered through K1 "
        f"f32 and written as PNG in {scene_s:.2f} s; {card}: BlenderDataset load "
        f"{load_s * 1e3:.1f} ms ({len(dataset):,} rays)")

    # nerf_synthetic's own frames are 800x800 RGBA whose rows an encoder
    # filters with Average and Paeth: the PNG reader's wavefront at that
    # size, on this host.
    big, first = write_paeth_scene(scene, root / "scene800", PAETH_VIEWS)
    decode_ms = timed_ms(lambda: decode_png(first), warm=False)
    exact = (decode_png(first) == big[0]).all()
    t0 = time.perf_counter()
    big_set = BlenderDataset(root / "scene800", device=dev)
    big_s = time.perf_counter() - t0
    exact = exact and len(big_set) == PAETH_VIEWS * big[0].shape[0] * big[0].shape[1]
    say("25 data", f"{card} host: decode_png of an 800x800 RGBA PNG, every row Paeth "
        f"{decode_ms:.1f} ms (median of 3), pixels exact and every ray loaded: {exact}; "
        f"BlenderDataset of "
        f"{PAETH_VIEWS} such frames {big_s * 1e3:.1f} ms, {big_s / PAETH_VIEWS * 1e3:.1f} ms a "
        f"frame: lego's 100 train views would load in about {big_s / PAETH_VIEWS * 100:.1f} s "
        f"(projected) -> {'ok' if exact else 'FAIL'}")
    if not exact:
        raise PhaseFailure("decode_png misread a Paeth-filtered frame")
    del big, big_set

    # Train, then resume; every state the CLI saves is kept here as well.
    saved = {}
    real_save = ckpt_io.save_checkpoint

    def save_and_keep(directory, state, **kw):
        saved[state.step] = {net: {layer: {part: t.detach().cpu().clone()
                                           for part, t in parts.items()}
                                   for layer, parts in m.tree().items()}
                             for net, m in state.params.items()}
        return real_save(directory, state, **kw)

    ck = root / "ck"
    train = ["train", "--data", str(scene), "--checkpoint-dir", str(ck), "--checkpoint-every",
             str(DATA_CKPT_EVERY), "--log-every", "1"]
    ckpt_io.save_checkpoint = save_and_keep
    try:
        torch.cuda.synchronize()
        zero_counts()
        first = cli_run([*train, "--steps", str(DATA_STEPS)])
        c_first = read_counts()
        zero_counts()
        second = cli_run([*train, "--steps", str(DATA_RESUME_STEPS)])
        c_second = read_counts()
    finally:
        ckpt_io.save_checkpoint = real_save
    losses = [float(v) for v in re.findall(r"^step \d+: loss ([0-9.]+)", first, re.M)]
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    resumed = f"resumed from {ck / f'step_{DATA_STEPS:08d}'} at step {DATA_STEPS}" in second
    n2 = DATA_RESUME_STEPS - DATA_STEPS
    ok = (len(losses) == DATA_STEPS and all(math.isfinite(v) for v in losses) and tail < head
          and c_first["fused_nerf_mlp_backward"] == 2 * DATA_STEPS
          and c_first["fused_nerf_mlp"] == 2 * DATA_STEPS
          and c_second["fused_nerf_mlp_backward"] == 2 * n2 and c_second["fused_nerf_mlp"] == 2 * n2
          and resumed and sorted(saved) == list(range(DATA_CKPT_EVERY, DATA_RESUME_STEPS + 1,
                                                      DATA_CKPT_EVERY)))
    say("25 data", f"train --data {DATA_STEPS} steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
        f"mean of the first 10 {head:.5f}, of the last 10 {tail:.5f}; launches K1 "
        f"{c_first['fused_nerf_mlp']}, K2 {c_first['fused_nerf_mlp_backward']} (expected "
        f"{2 * DATA_STEPS} each: no teacher); resume to {DATA_RESUME_STEPS}: 'resumed from ... "
        f"at step {DATA_STEPS}' printed: {resumed}, K1 {c_second['fused_nerf_mlp']}, K2 "
        f"{c_second['fused_nerf_mlp_backward']} (expected {2 * n2} each); states saved at "
        f"{sorted(saved)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("train --data did not learn, resume, or went around the kernels")

    # Render from the checkpoint, from its export, and from the saved state.
    last = ckpt_io.latest_checkpoint(ck)
    render = ["render", "--width", str(W), "--height", str(H)]
    zero_counts()
    cli_run([*render, "--checkpoint", str(last), "-o", str(root / "ck.ppm")])
    c_render = read_counts()
    mem = saved[DATA_RESUME_STEPS]
    img = render_image(NerfMLP(mem["coarse"], device=dev), NerfMLP(mem["fine"], device=dev), cam,
                       H, W, random.key(0, dev), RenderConfig(ray_chunk=BENCH_CHUNK,
                                                              impl="pallas"), device=dev)
    save_ppm(root / "mem.ppm", img, H, W)
    cli_run(["export", "--checkpoint", str(last), "-o", str(root / "exp")])
    cli_run([*render, "--weights", str(root / "exp"), "-o", str(root / "exp.ppm")])
    ck_bytes = (root / "ck.ppm").read_bytes()
    same_mem = ck_bytes == (root / "mem.ppm").read_bytes()
    same_exp = ck_bytes == (root / "exp.ppm").read_bytes()
    chunks = -(-H * W // BENCH_CHUNK)
    out = cli_run(["evaluate", "--checkpoint-dir", str(ck), "--size", str(H)])
    m = re.search(r"PSNR vs teacher ([0-9.]+) dB", out)
    eval_db = float(m.group(1)) if m else float("nan")

    api._state.clear()
    api.init_renderer(checkpoint=str(last), device=dev,
                      cfg=RenderConfig(ray_chunk=BENCH_CHUNK, impl="pallas"))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/render?width={W}&height={H}&seed=0",
            timeout=300).read()
    finally:
        srv.shutdown()
        srv.server_close()
        api._state.clear()
    served = np.frombuffer(body, np.uint8).reshape(-1, 4)[:, :3].tobytes() == ck_bytes[-H * W * 3:]
    ok = (same_mem and same_exp and served and math.isfinite(eval_db)
          and c_render["fused_nerf_mlp"] == 2 * chunks)
    say("25 data", f"render --checkpoint step {DATA_RESUME_STEPS} {W}x{H}: K1 launches "
        f"{c_render['fused_nerf_mlp']} (expected {2 * chunks}); bitwise the render of the saved "
        f"in-memory state: {same_mem}; export + render --weights bitwise: {same_exp}; one /render "
        f"from serve's handler (init_renderer(checkpoint=...)) the same bytes: {served}; evaluate "
        f"--checkpoint-dir {H}x{H}: PSNR vs the lego teacher {eval_db:.2f} dB (reported) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the checkpoint's renders differ between the front ends")

    # SIGTERM: the step in flight, a checkpoint, exit 0.
    rc, text, sig_s, killed = sigterm_train(scene, root / "ck_sigterm")
    newest = ckpt_io.latest_checkpoint(root / "ck_sigterm")
    step = ckpt_io.restore_params(newest)[1] if newest is not None else -1
    ok = rc == 0 and not killed and "final checkpoint" in text and step >= 1
    say("25 data", f"{card}: SIGTERM after the first step line: exit {rc}, killed at "
        f"{SIGTERM_LIMIT_S} s: {killed}, 'final checkpoint' printed: {'final checkpoint' in text}, "
        f"newest checkpoint step {step}; {sig_s:.2f} s from the signal to the exit -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure(f"train did not stop cleanly on SIGTERM:\n{text[-2000:]}")

    # The hash grid: train --model hashgrid --data, its checkpoint rendered
    # through the encode kernel and through the plain encode.
    hck = root / "ck_hash"
    zero_counts()
    cli_run(["train", "--model", "hashgrid", "--data", str(scene), "--checkpoint-dir", str(hck),
             "--steps", str(HASH_DATA_STEPS), "--log-every", "5"])
    c_hash = read_counts()
    hlast = ckpt_io.latest_checkpoint(hck)
    zero_counts()
    cli_run([*render, "--checkpoint", str(hlast), "-o", str(root / "hash.ppm")])
    c_hrender = read_counts()
    with plain_encode():
        cli_run([*render, "--checkpoint", str(hlast), "-o", str(root / "hash_plain.ppm")])
    hash_db = psnr(load_ppm(root / "hash.ppm"), load_ppm(root / "hash_plain.ppm"))
    ok = (hash_db >= PLAIN_BAR_DB and c_hash["fused_hash_encode"] == 2 * HASH_DATA_STEPS
          and c_hrender["fused_hash_encode"] == 2 * chunks and c_hrender["fused_nerf_mlp"] == 0)
    say("25 data", f"train --model hashgrid --data {HASH_DATA_STEPS} steps: encode launches "
        f"{c_hash['fused_hash_encode']} (expected {2 * HASH_DATA_STEPS}); render --checkpoint "
        f"{W}x{H}: encode launches {c_hrender['fused_hash_encode']} (expected {2 * chunks}), "
        f"kernel vs plain encode {hash_db:.2f} dB (bar >= {PLAIN_BAR_DB}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the hash-grid checkpoint's render misses its bar or its kernel")

    # Times: a step on --data, one checkpoint's save and restore.
    saved_counts = save_counts()
    state = ckpt_io.restore_checkpoint(last, dev)
    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=RenderConfig(
        n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl="pallas"))
    batches = dataset.batches(TRAIN_RAYS, seed=1)
    key = random.key(1, dev)
    fixed = next(batches)
    draw_ms = timed_ms(lambda: next(batches), inner=20)
    # Runs of STEP_RUN steps with no synchronization between them, as the
    # CLI's loop runs them between log lines, so the host may queue a step
    # while the card runs the last: one fixed batch; fresh batches drawn
    # beforehand; drawn in the loop into pinned memory and copied without
    # blocking (BlenderDataset.batches); drawn in the loop and copied from
    # pageable memory, which blocks the host until the card has run what
    # was queued. Timed in that order and then in the reverse one; each
    # figure is the mean of its two medians.
    ready = [next(batches) for _ in range(8 * STEP_RUN)]
    pageable = pageable_batches(dataset, TRAIN_RAYS, seed=2)
    runs = {"fixed": lambda: fixed, "drawn before": ready.pop,
            "pinned": lambda: next(batches), "pageable": lambda: next(pageable)}
    run_ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            run_ms[name].append(timed_ms(lambda: train_step(state, runs[name](), key, cfg),
                                         inner=STEP_RUN))
    run_ms = {name: statistics.mean(v) for name, v in run_ms.items()}
    step_ms = run_ms["pinned"]
    save_ms = timed_ms(lambda: ckpt_io.save_checkpoint(root / "timed", state))
    restore_ms = timed_ms(lambda: ckpt_io.restore_checkpoint(last, dev))
    restore_counts(saved_counts)                   # timing launches do not count
    size_mb = sum(p.stat().st_size for p in last.iterdir()) / 1e6
    say("25 data", f"{card}: train step on --data, {TRAIN_RAYS} rays {N_COARSE}+{N_FINE}, f32: "
        f"{step_ms:.1f} ms, {TRAIN_RAYS / step_ms * 1e3:,.0f} rays/s fwd+bwd; a step in runs of "
        f"{STEP_RUN} with the batch " + ", ".join(f"{k} {v:.1f} ms" for k, v in run_ms.items())
        + f"; a batch drawn and copied to the card {draw_ms:.3f} ms; checkpoint "
        f"({size_mb:.1f} MB: params and Adam's moments) save {save_ms:.1f} ms, restore to the "
        f"card {restore_ms:.1f} ms; dataset load {load_s * 1e3:.1f} ms; SIGTERM to exit "
        f"{sig_s:.2f} s (the save and restore medians of 3; the load and SIGTERM one run "
        f"each); phase 25 took {time.perf_counter() - t_phase:.1f} s")



# Occupancy-culled, placement-aware training and the rest of the front ends
# (phase 26): the teacher_sp30 recipe (assets/trained/README.md: `train
# --init-weights assets/lego_rust --fine-samples 0 --teacher-samples 64,128
# --accel-aabb --accel-probes 128`, lr 1e-4, --accel-pad 4 for the stride-4
# serving preset), cut to SP_STEPS steps; then verify, extract and render
# --orbit/--trace-dir through the CLI.
SP_STEPS, SP_EVERY = 100, 25
SP_RECIPE = ["--fine-samples", "0", "--teacher-samples", "64,128", "--accel-every", str(SP_EVERY),
             "--accel-warmup", "0", "--accel-aabb", "--accel-probes", "128", "--accel-pad", "4",
             "--lr", "1e-4", "--batch-rays", str(TRAIN_RAYS)]
SP_EVAL = ["--size", str(H), "--coarse-samples", str(N_COARSE), "--fine-samples", "0",
           "--ref-samples", f"{N_COARSE},{N_FINE}", "--accel-probes", "128"]
HASH_ACCEL_STEPS, QAT_ACCEL_STEPS = 30, 10
EXTRACT_RES, EXTRACT_ISO = 128, 10.0
# Lattice cells on the other side of the iso level between K1 bf16's
# lattice and the plain f32 one, as a share of the cells next to the f32
# surface: a bf16 sigma within about 1% of the level flips (the plain bf16
# version flips 0.18% at 64^3 on a CPU).
EXTRACT_FLIP_BAR = 0.01
ORBIT_FRAMES = 4
VERIFY_BF16_TOLERANCE = 4.0


def step_losses(out: str):
    return [float(v) for v in re.findall(r"^step \d+: loss ([0-9.]+)", out, re.M)]


def near_surface_flips(sig, plain, iso: float):
    """(cells on the other side of ``iso`` between two lattices, cells of
    ``plain`` next to its iso surface)."""
    side, side_plain = sig > iso, plain > iso
    near = side_plain != side_plain.roll(1, 0)
    for ax in (1, 2):
        near |= side_plain != side_plain.roll(1, ax)
    return int((side != side_plain).sum()), int(near.sum())


def phase_culled(coarse, fine, cam, dev, card):
    """Phase 26 in a temporary directory, removed when the phase ends."""
    with tempfile.TemporaryDirectory(prefix="nerf_rs_tpu_torch_culled_") as tmp:
        return run_phase_culled(Path(tmp), coarse, fine, cam, dev, card)


def run_phase_culled(root: Path, coarse, fine, cam, dev, card):
    """Phase 26: occupancy-culled, placement-aware training through the CLI
    and on the same state with the kernels against the plain MLP, its
    times, the hash-grid and int8qat students under --accel-every, then
    verify, extract and render --orbit --trace-dir; the launch counts set
    to 0 just before each run and read just after."""
    import torch

    from nerf_rs_tpu_torch.accel import (
        _oracle_sigma,
        build_scene_grid,
        capacities_from_occupancy,
        density_grid,
        field_grid_kwargs,
    )
    from nerf_rs_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data import DistillationDataset
    from nerf_rs_tpu_torch.io.image import load_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import refresh_grid, train_state_from_params, train_step

    t_phase = time.perf_counter()
    assets = find_lego_assets()
    lego = {net: load_nerf_params(assets / net) for net in ("coarse", "fine")}

    # 1. The culled, placement-aware fine-tune through the CLI.
    def sp_psnr(argv):
        m = re.search(r"PSNR vs teacher ([0-9.]+) dB", cli_run(["evaluate", *argv, *SP_EVAL]))
        return float(m.group(1)) if m else float("nan")

    before_db = sp_psnr(["--weights-dir", str(assets)])
    ck = root / "sp"
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = cli_run(["train", "--init-weights", str(assets), *SP_RECIPE, "--steps", str(SP_STEPS),
                   "--checkpoint-dir", str(ck), "--checkpoint-every", str(10 * SP_STEPS),
                   "--log-every", "1"])
    sp_s = time.perf_counter() - t0
    c_sp = read_counts()
    after_db = sp_psnr(["--checkpoint-dir", str(ck)])
    losses = step_losses(out)
    refreshes = re.findall(r"^accel: .*$", out, re.M)
    loads = re.findall(r"accel-load ([0-9.]+)/([0-9.]+)", out)
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    # A step: the teacher's 64+128 batch (K1 twice), the student's single
    # pass (K1 once, K2 once); a refresh: two 128^3 sweeps of 262144-row
    # chunks (coarse and fine), K1 f32 sigma-only; and the teacher's batch
    # the loop draws before it sees the last step, as the JAX CLI's does.
    sweep = 2 * -(-GRID_RES ** 3 // 262_144)
    want_k1 = 3 * SP_STEPS + 2 + sweep * (SP_STEPS // SP_EVERY)
    ok = (len(losses) == SP_STEPS and all(math.isfinite(v) for v in losses) and tail < head
          and len(refreshes) == SP_STEPS // SP_EVERY
          and c_sp["fused_nerf_mlp"] == want_k1 and c_sp["fused_nerf_mlp_backward"] == SP_STEPS)
    say("26 culled", f"train --init-weights lego {' '.join(SP_RECIPE)} --steps {SP_STEPS}: "
        f"{sp_s:.1f} s; loss {losses[0]:.5f} -> {losses[-1]:.5f}, mean of the first 10 {head:.5f}, "
        f"of the last 10 {tail:.5f}; {len(refreshes)} grid refreshes (expected "
        f"{SP_STEPS // SP_EVERY}): {sorted(set(refreshes))}; steps logging accel-load "
        f"{len(loads)}; launches K1 {c_sp['fused_nerf_mlp']} (expected {want_k1}: 3 a step, "
        f"{sweep} a refresh, 2 for the batch drawn past the last step), K2 {c_sp['fused_nerf_mlp_backward']} (expected {SP_STEPS}) -> "
        f"{'ok' if ok else 'FAIL'}")
    say("26 culled", f"single-pass {N_COARSE}+0 probe-placed {W}x{H} frame vs the teacher's "
        f"{N_COARSE}+{N_FINE} (evaluate, reported, no bar): before {before_db:.2f} dB, after "
        f"{SP_STEPS} steps {after_db:.2f} dB")
    if not ok:
        raise PhaseFailure("the culled fine-tune did not learn, refresh its grid, or went around "
                           "the kernels")

    # 2. Kernels against plain, one culled step from one state, batch and
    # grid: 8x256, 4096 rays, 64+128, f32, mask-only; and the recipe's
    # single-pass step under 128-probe placement.
    cfg = TrainConfig(batch_rays=TRAIN_RAYS, render=RenderConfig(
        n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=TRAIN_RAYS, impl="pallas"))
    teacher = {"coarse": coarse, "fine": fine}
    batch = next(DistillationDataset(teacher, cfg=cfg.render, seed=3, device=dev).batches(
        TRAIN_RAYS))
    key = random.key(4, dev)
    sweep_kw = field_grid_kwargs(cfg.render)
    grid = build_scene_grid(coarse, fine, resolution=GRID_RES, **sweep_kw)
    frac = float(grid.occ.float().mean())
    sp_cfg = cfg.replace(render=cfg.render.replace(n_fine=0, accel_sample_aabb=True,
                                                   accel_aabb_probes=128, accel_pad_probes=4.0))
    live = {}
    for label, step_cfg, bar_lr in (("64+128 mask-only", cfg, cfg.lr_init),
                                    ("64+0 128-probe placement", sp_cfg, sp_cfg.lr_init)):
        states, metrics = {}, {}
        for impl in ("pallas", "xla"):
            state = train_state_from_params(lego, dev)
            zero_counts()
            states[impl], m = train_step(state, batch, key, step_cfg.replace(
                render=step_cfg.render.replace(impl=impl)), grid=grid)
            metrics[impl] = {k: float(v) for k, v in m.items()}
            if impl == "pallas":
                c_step = read_counts()
        live[label] = metrics["pallas"]
        diffs = [(p.detach() - states["xla"].params[net].weights[name].detach()).abs()
                 for net in ("coarse", "fine")
                 for name, p in states["pallas"].params[net].weights.items()]
        rel = abs(metrics["pallas"]["loss"] - metrics["xla"]["loss"]) / metrics["xla"]["loss"]
        worst = max(float(d.max()) for d in diffs)
        share = sum(int((d > 1e-5).sum()) for d in diffs) / sum(d.numel() for d in diffs)
        passes = 1 if step_cfg.render.n_fine == 0 else 2
        ok = (rel <= 1e-5 and worst < 2 * bar_lr and share < 1e-3
              and c_step["fused_nerf_mlp"] == passes
              and c_step["fused_nerf_mlp_backward"] == passes
              and metrics["pallas"]["live_frac_coarse"] == metrics["xla"]["live_frac_coarse"])
        say("26 culled", f"one culled step ({label}, grid {GRID_RES}^3 of the lego networks "
            f"{frac:.4f} occupied), kernels vs plain MLP: loss {metrics['pallas']['loss']:.6f} vs "
            f"{metrics['xla']['loss']:.6f} (relative {rel:.2e}, bar 1e-5); params max abs diff "
            f"{worst:.2e} (bar < {2 * bar_lr:g}), share > 1e-5 {share:.2e} (bar < 1e-3); live "
            f"coarse {metrics['pallas']['live_frac_coarse']:.4f} fine "
            f"{metrics['pallas']['live_frac_fine']:.4f}; launches K1 {c_step['fused_nerf_mlp']}, "
            f"K2 {c_step['fused_nerf_mlp_backward']} (expected {passes} each) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"the culled step ({label}) on the kernels misses the plain MLP's")

    # 3. Times from one state, ABBA medians of 3: the dense step, the
    # culled step in each accel_compact mode (capacities from
    # capacities_from_occupancy, and from the mask-only step's live rows
    # x 1.15), one refresh at 128^3.
    saved_counts = save_counts()
    state = train_state_from_params(lego, dev)
    cap_c, cap_f = capacities_from_occupancy(frac, cfg.render)
    lc, lf = live["64+128 mask-only"]["live_frac_coarse"], live["64+128 mask-only"]["live_frac_fine"]
    meas_c, meas_f = (min(1.0, -(-1.15 * v // 0.125) * 0.125) for v in (lc, lf))

    def culled(compact, c, f):
        return cfg.replace(render=cfg.render.replace(accel_compact=compact,
                                                     accel_coarse_capacity=c,
                                                     accel_fine_capacity=f))

    variants = {"dense": lambda: train_step(state, batch, key, cfg),
                "mask-only": lambda: train_step(state, batch, key, culled("none", 1.0, 1.0),
                                                grid=grid)}
    for compact in ("scatter", "gather"):
        variants[f"{compact} {cap_c:.3f}/{cap_f:.3f}"] = (
            lambda c=compact: train_step(state, batch, key, culled(c, cap_c, cap_f), grid=grid))
        variants[f"{compact} measured {meas_c:.3f}/{meas_f:.3f}"] = (
            lambda c=compact: train_step(state, batch, key, culled(c, meas_c, meas_f), grid=grid))
    variants[f"refresh {GRID_RES}^3"] = lambda: refresh_grid(
        state.params, cfg, 0, resolution=GRID_RES, explore=0.01, sweep_kw=sweep_kw)
    step_ms = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            step_ms[name].append(timed_ms(variants[name]))
    scatter = next(k for k in variants if k.startswith("scatter measured"))
    profiles = {name: profile_frame(variants[name]) for name in ("dense", scatter)}
    restore_counts(saved_counts)                   # timing launches do not count
    step_ms = {name: statistics.mean(v) for name, v in step_ms.items()}
    say("26 culled", f"{card}: step and refresh times, {TRAIN_RAYS} rays {N_COARSE}+{N_FINE} f32, "
        f"8x256 lego state, grid {frac:.4f} occupied (ABBA, mean of two medians of 3): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in step_ms.items())
        + f"; capacities_from_occupancy gives {cap_c:.3f}/{cap_f:.3f}")
    for name, (wall, busy, top) in profiles.items():
        say("26 culled", f"{card}: one {name} step under torch.profiler: {wall:.1f} ms wall, "
            f"device busy {busy:.1f} ms, idle {1 - busy / wall:.2%}; top device kernels: "
            + ", ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))

    # 4. The hash-grid and int8qat students under --accel-every.
    runs = {"hashgrid": (["--model", "hashgrid", "--accel-every", "10"], HASH_ACCEL_STEPS),
            "int8qat": (["--impl", "int8qat", "--accel-every", "5"], QAT_ACCEL_STEPS)}
    for family, (flags, steps) in runs.items():
        zero_counts()
        out = cli_run(["train", *flags, "--accel-warmup", "0", "--steps", str(steps),
                       "--log-every", "1"])
        c = read_counts()
        losses = step_losses(out)
        refreshes = re.findall(r"^accel: .*$", out, re.M)
        every = int(flags[-1])
        ok = (len(losses) == steps and all(math.isfinite(v) for v in losses)
              and len(refreshes) == -(-steps // every))
        if family == "hashgrid":
            # Two encode launches a step; a refresh sweeps the one field.
            want = 2 * steps + len(refreshes) * -(-GRID_RES ** 3 // 262_144)
            ok = ok and c["fused_hash_encode"] == want and c["fused_nerf_mlp_backward"] == 0
            counts = f"encode {c['fused_hash_encode']} (expected {want})"
        else:
            # The teacher through K1 (two a step); the fake-quant student,
            # its refresh sweeps too, in torch ops.
            ok = ok and c["fused_nerf_mlp"] == 2 * steps + 2 \
                and c["fused_nerf_mlp_backward"] == 0 and c["fused_int8_mlp"] == 0
            counts = (f"K1 {c['fused_nerf_mlp']} (expected {2 * steps + 2}: the teacher, and its "
                      f"batch drawn past the last step), K2 "
                      f"{c['fused_nerf_mlp_backward']}, int8 {c['fused_int8_mlp']} (expected 0)")
        say("26 culled", f"train {' '.join(flags)} --accel-warmup 0 --steps {steps}: loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}; {len(refreshes)} refreshes: "
            f"{sorted(set(refreshes))}; launches {counts} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"train --accel-every of the {family} student failed")

    # 5. verify through K1: f32 with both images, bf16 with the small one.
    # The golden sigmas reach 213, where one bf16 ulp is 1.0: the JAX
    # package's bf16 kernel misses the default 1e-2 there by 1.00 (its
    # interpret mode on a CPU), so bf16 is held to 4 such ulps.
    for flags in (["--impl", "pallas", "--image", "--image-full"],
                  ["--impl", "pallas", "--dtype", "bfloat16", "--image", "--tolerance",
                   str(VERIFY_BF16_TOLERANCE)]):
        zero_counts()
        out = cli_run(["verify", *flags])
        c = read_counts()
        worst = re.search(r"^worst error (\S+)", out, re.M).group(1)
        images = re.findall(r"^(.*golden): ([0-9.]+) dB \[(OK|FAIL)\] \(bar (\d+) dB", out, re.M)
        tol = re.search(r"\(tolerance (\S+)\)", out).group(1)
        say("26 front ends", f"verify {' '.join(flags)}: exit 0, worst error {worst} (tolerance "
            f"{tol}); " + "; ".join(f"{lab} {db} dB [{st}] (bar {bar})" for lab, db, st, bar in images)
            + f"; K1 launches {c['fused_nerf_mlp']}, on the tensor cores {c['fused_nerf_mlp_tc']}")

    # 6. extract at 128^3 on the lego networks (K1 bf16 sigma-only).
    zero_counts()
    t0 = time.perf_counter()
    out = cli_run(["extract", "-o", str(root / "lego.ply"), "--resolution", str(EXTRACT_RES)])
    extract_s = time.perf_counter() - t0
    c = read_counts()
    m = re.search(r": ([0-9,]+) vertices, ([0-9,]+) triangles", out)
    with torch.no_grad():
        sig = density_grid(fine, resolution=EXTRACT_RES)
        plain = density_grid(fine, resolution=EXTRACT_RES, mlp_fn=_oracle_sigma)
    flips, near = near_surface_flips(sig, plain, EXTRACT_ISO)
    chunks = -(-EXTRACT_RES ** 3 // 262_144)
    ok = (m is not None and flips <= EXTRACT_FLIP_BAR * near and c["fused_nerf_mlp"] == chunks
          and c["fused_nerf_mlp_tc"] == chunks)
    say("26 front ends", f"{card}: extract --resolution {EXTRACT_RES}: {extract_s:.2f} s (the CLI "
        f"call: lattice, mesh, vertex colors, PLY), {m.group(1) if m else '?'} vertices, "
        f"{m.group(2) if m else '?'} faces; K1 bf16 launches {c['fused_nerf_mlp']} (expected "
        f"{chunks}); K1 bf16 lattice vs plain f32 lattice: {flips} cells on the other side of iso "
        f"{EXTRACT_ISO:g}, {flips / max(near, 1):.4%} of the {near} cells next to the surface (bar "
        f"<= {EXTRACT_FLIP_BAR:.0%}), {flips / EXTRACT_RES ** 3:.2e} of all -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("extract's lattice through K1 bf16 misses its bar or its kernel")

    # 7. render --orbit with a trace; frame 0 against the plain render.
    render = ["render", "--width", str(W), "--height", str(H), "--ray-chunk", str(RAY_CHUNK)]
    zero_counts()
    t0 = time.perf_counter()
    cli_run([*render, "--orbit", str(ORBIT_FRAMES), "--trace-dir", str(root / "trace"),
             "-o", str(root / "orbit.ppm")])
    orbit_s = time.perf_counter() - t0
    c = read_counts()
    cli_run([*render, "-o", str(root / "plain.ppm")])
    same = (root / "orbit_000.ppm").read_bytes() == (root / "plain.ppm").read_bytes()
    moved = bool((load_ppm(root / "orbit_000.ppm") != load_ppm(root / "orbit_001.ppm")).any())
    traces = list((root / "trace").glob("*.pt.trace.json"))
    names = ({e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]
              if e.get("cat") == "kernel"} if len(traces) == 1 else set())
    k1_names = sorted(n for n in names if "fused_mlp_f32tc_kernel" in n)
    chunks = -(-H * W // RAY_CHUNK)
    ok = (same and moved and k1_names and c["fused_nerf_mlp"] == 2 * chunks * ORBIT_FRAMES)
    say("26 front ends", f"{card}: render --orbit {ORBIT_FRAMES} --trace-dir {W}x{H}: "
        f"{orbit_s:.2f} s with the trace; frame 0 bitwise the plain render: {same}; frames differ: "
        f"{moved}; K1 launches {c['fused_nerf_mlp']} (expected {2 * chunks * ORBIT_FRAMES}); the "
        f"Chrome trace ({len(traces)} file) holds {len(names)} kernel names, K1's: "
        f"{[n[:60] for n in k1_names][:2]} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("render --orbit/--trace-dir differs from the plain render or lacks K1")
    say("26 front ends", f"phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return c_sp


LAUNCH_LIMIT_S = 300                    # a torchrun launch of phase 27 is killed after this
SHARDED_STEPS = 40
SHARDED_LOG_EVERY = 10


@contextlib.contextmanager
def counted_collectives():
    """Every collective of ``torch.distributed`` wrapped with a counter
    for the block: yields the counts (name -> calls)."""
    import torch.distributed as dist

    names = ("all_reduce", "broadcast", "barrier", "all_gather", "all_gather_single",
             "all_gather_into_tensor", "gather", "reduce", "scatter", "reduce_scatter",
             "reduce_scatter_tensor", "all_to_all", "send", "recv")
    counts, real = {}, {}
    for name in names:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        real[name] = fn

        def wrapped(*args, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kw)

        setattr(dist, name, wrapped)
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def torchrun(argv) -> str:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1
    -m nerf_rs_tpu_torch ARGV`` from the checkout, killed (with its
    session) at LAUNCH_LIMIT_S: its output; a non-zero exit fails the
    phase."""
    import os
    import signal

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "nerf_rs_tpu_torch", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text = proc.communicate(timeout=LAUNCH_LIMIT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise PhaseFailure(f"torchrun {' '.join(argv[:1])} did not end in {LAUNCH_LIMIT_S} s")
    if proc.returncode != 0:
        raise PhaseFailure(f"torchrun {' '.join(argv)} exited with {proc.returncode}:\n"
                           f"{text[-3000:]}")
    return text


@contextlib.contextmanager
def world_variables(on: bool):
    """torchrun's variables for a world of 1 (a free loopback port) set
    for the block when ``on``, so that the CLI run in this process joins
    a world of 1 under NCCL; removed again after it."""
    import os
    import socket

    if not on:
        yield
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        yield
    finally:
        for name in env:
            os.environ.pop(name, None)


def steady_step_ms(out: str, batch_rays: int) -> float:
    """The mean step time between the second and the last logged step of
    a ``train`` output: each step line's cumulative rays/s gives the time
    from the loop's start to that step's end (batch x (step + 1) / rate),
    so that the first step's start-up costs fall out."""
    rows = [(int(s), float(r.replace(",", ""))) for s, r in
            re.findall(r"^step (\d+): loss .*?\(([0-9,]+) rays/s", out, re.M)]
    (s0, r0), (s1, r1) = rows[1], rows[-1]
    return (batch_rays * (s1 + 1) / r1 - batch_rays * (s0 + 1) / r0) * 1e3 / (s1 - s0)


ABBA_ROUNDS = 5


def abba_ms(fn_a, fn_b):
    """Median wall times (ms) of ``fn_a`` and ``fn_b`` run in turns, a b b
    a, ABBA_ROUNDS times after one warm-up call each, every call
    bracketed by device synchronizations."""
    import torch

    fn_a()
    fn_b()
    times = ([], [])
    for _ in range(ABBA_ROUNDS):
        for i in (0, 1, 1, 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (fn_a, fn_b)[i]()
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[0]), statistics.median(times[1])


def phase_sharded(coarse, fine, cam, dev, grid, card):
    """Phase 27 in a temporary directory, removed when the phase ends."""
    with tempfile.TemporaryDirectory(prefix="nerf_rs_tpu_torch_sharded_") as tmp:
        return run_phase_sharded(Path(tmp), coarse, fine, cam, dev, grid, card)


def run_phase_sharded(root: Path, coarse, fine, cam, dev, grid, card):
    """Phase 27: the parallel layer in a world of 1 under NCCL on the card:
    the sharded f32 golden frame, the sharded culled 800x800 bf16 accel+K3
    frame and one sharded step, each bitwise its single-device counterpart,
    with the launch and collective counts set to 0 just before each and read
    just after; ``train`` and ``render --sharded`` under torchrun; times."""
    import torch
    import torch.distributed as dist

    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.io.image import load_ppm
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.parallel import make_mesh, multihost
    from nerf_rs_tpu_torch.parallel.mesh import all_gather_rows
    from nerf_rs_tpu_torch.parallel.render_sharded import effective_chunk, render_image_sharded
    from nerf_rs_tpu_torch.parallel.train_sharded import _pool, sharded_train_step
    from nerf_rs_tpu_torch.render import render_image
    from nerf_rs_tpu_torch.train import train_step

    # NCCL's start-up: join a world of 1 (the communicator is made when the
    # group is, bound to the card; the kernels, built by phase 1, are loaded
    # in turn around a barrier) and make its first all-reduce; twice
    # left again, the third kept for the phase (median of 3).
    init_s = []
    for i in range(3):
        t0 = time.perf_counter()
        multihost.initialize(f"file://{root / f'store{i}'}", 1, 0, device=dev)
        x = torch.ones(1, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
        if i < 2:
            multihost.shutdown()
    try:
        mesh = make_mesh()
        if (mesh.size, mesh.rank, mesh.device, dist.get_backend()) != (1, 0, dev, "nccl"):
            raise PhaseFailure(f"world of 1: mesh {mesh}, backend {dist.get_backend()}")
        gather = "all_gather_into_tensor"

        # (a) the 256x256 f32 golden frame.
        cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=RAY_CHUNK, impl="pallas")
        key = random.key(0, dev)
        chunks = -(-H * W // effective_chunk(H * W, mesh.size, cfg))
        torch.cuda.synchronize()
        zero_counts()
        with counted_collectives() as coll:
            img_s = render_image_sharded(coarse, fine, cam, H, W, key, cfg, mesh=mesh)
            torch.cuda.synchronize()
        k, coll_a = read_counts(), dict(coll)
        img_1 = render_image(coarse, fine, cam, H, W, key, cfg, device=dev)
        golden_db = psnr(img_s.cpu().numpy(), load_ppm(GOLDEN_PPM))
        ok = (torch.equal(img_s, img_1) and golden_db > GOLDEN_BAR_DB and coll_a == {gather: 1}
              and k["fused_nerf_mlp"] == k["fused_nerf_mlp_tc"] == 2 * chunks)
        say("27 sharded", f"(a) render_image_sharded, world of 1 under NCCL, {H}x{W} "
            f"{N_COARSE}+{N_FINE} f32: bitwise render_image {torch.equal(img_s, img_1)}, PSNR vs "
            f"golden {golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}); collectives {coll_a}; K1 "
            f"{k['fused_nerf_mlp']} launches, {k['fused_nerf_mlp_tc']} on the tensor cores "
            f"(expected {2 * chunks} each) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure("the sharded f32 frame is not render_image's, or went around K1 "
                               "or the one all-gather")

        # (b) bench.py's 800x800 bf16 accel+K3 frame through the culled path.
        acfg = accel_cfg("bfloat16", chunk=BENCH_CHUNK)
        torch.cuda.synchronize()
        zero_counts()
        with counted_collectives() as coll:
            acc_s = render_image_sharded(coarse, fine, cam, BENCH_SIZE, BENCH_SIZE, key, acfg,
                                         mesh=mesh, grid=grid)
            torch.cuda.synchronize()
        k, coll_b = read_counts(), dict(coll)
        acc_1, _ = render_accel(coarse, fine, cam, dev, acfg, grid, BENCH_SIZE)
        _, rendered = rendered_chunks(grid, cam, BENCH_SIZE, acfg, dev)
        ok = (torch.equal(acc_s, acc_1) and coll_b == {gather: 1}
              and k["fused_resample"] == rendered
              and k["fused_nerf_mlp"] == k["fused_nerf_mlp_tc"] == 2 * rendered)
        say("27 sharded", f"(b) the {BENCH_SIZE}x{BENCH_SIZE} bf16 accel+K3 frame (32 probes, "
            f"stride 4, packing) through the sharded culled path: bitwise the single-device "
            f"frame {torch.equal(acc_s, acc_1)}; collectives {coll_b}; K3 {k['fused_resample']}, "
            f"K1 {k['fused_nerf_mlp']} ({k['fused_nerf_mlp_tc']} on the tensor cores) for "
            f"{rendered} rendered chunks -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure("the sharded culled frame is not the single-device frame, or "
                               "its launches or collectives are off")

        # (c) one step at the train defaults, from the same state and batch.
        state_1, dataset, tcfg, tkey = distill_setup(dev, "pallas")
        state_s = distill_setup(dev, "pallas")[0]
        batch = next(dataset.batches(tcfg.batch_rays, seed=tcfg.seed))
        k0 = random.fold_in(tkey, torch.tensor(0))
        _, m_1 = train_step(state_1, batch, k0, tcfg)
        torch.cuda.synchronize()
        zero_counts()
        with counted_collectives() as coll:
            _, m_s = sharded_train_step(mesh, state_s, batch, k0, tcfg)
            torch.cuda.synchronize()
        k, coll_c = read_counts(), dict(coll)
        same = all(torch.equal(p, state_s.params[net].weights[name])
                   for net, module in state_1.params.items()
                   for name, p in module.weights.items())
        same_m = all(torch.equal(m_1[name], m_s[name]) for name in m_1)
        ok = (same and same_m and coll_c == {"all_reduce": 1}
              and k["fused_nerf_mlp_backward"] == 2 and k["fused_nerf_mlp"] == 2)
        say("27 sharded", f"(c) sharded_train_step, {TRAIN_RAYS} rays {N_COARSE}+{N_FINE} f32, "
            f"against train_step from the same state and batch: params bitwise {same}, metrics "
            f"bitwise {same_m} (loss {float(m_s['loss']):.7f}); collectives {coll_c}; K2 "
            f"{k['fused_nerf_mlp_backward']}, K1 {k['fused_nerf_mlp']} launches (expected 2 "
            f"each) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure("the sharded step is not train_step's, or its launches or "
                               "collectives are off")

        # (e) times: the sharded frame and step against the single-device
        # ones in turns (the data-parallel layer's cost at world 1), the
        # step's pooling and the collectives alone.
        saved = save_counts()
        frame_ms = abba_ms(
            lambda: render_image_sharded(coarse, fine, cam, H, W, key, cfg, mesh=mesh),
            lambda: render_image(coarse, fine, cam, H, W, key, cfg, device=dev))
        step_ms = abba_ms(lambda: sharded_train_step(mesh, state_s, batch, k0, tcfg),
                          lambda: train_step(state_1, batch, k0, tcfg))
        restore_counts(saved)
        n_grad = sum(p.numel() for module in state_s.params.values()
                     for p in module.weights.values())
        pooled = {name: m_s[name] for name in ("loss", "mse_fine", "mse_coarse")}
        pool_ms = timed_ms(lambda: _pool(mesh, state_s, dict(pooled), None), inner=10)
        flat = torch.zeros(n_grad + 3, device=dev)
        rows = img_s.reshape(-1, 3)
        reduce_ms = timed_ms(lambda: dist.all_reduce(flat), inner=10)
        gather_ms = timed_ms(lambda: all_gather_rows(mesh, rows), inner=10)
    finally:
        multihost.shutdown()
    init_med = statistics.median(init_s)
    say("27 sharded", f"(e) {card}: world of 1 under NCCL, in turns (sharded, single, single, "
        f"sharded; medians of {2 * ABBA_ROUNDS}): frame {H}x{W} f32 sharded "
        f"{frame_ms[0]:.1f} ms, single-device {frame_ms[1]:.1f} ms; step sharded "
        f"{step_ms[0]:.1f} ms, single-device {step_ms[1]:.1f} ms; the step's pooling (flat "
        f"buffer, all-reduce, division, views back) {pool_ms:.3f} ms, its all-reduce of "
        f"{n_grad + 3:,} floats alone {reduce_ms:.3f} ms, the frame's all-gather of "
        f"{rows.shape[0]:,} x 3 floats {gather_ms:.3f} ms (medians of 3); NCCL start-up (group, "
        f"the kernels' load and its barrier, first all-reduce) {init_med:.3f} s ({', '.join(f'{s:.3f}' for s in init_s)})")

    # (d) train under torchrun (world of 1); then in this process, in turns
    # (no group, group, group, no group), train with torchrun's variables
    # set (a world of 1 under NCCL) against plain train over the same
    # steps, so that launch-to-launch noise stays out; render --sharded.
    argv = ["train", "--device", "cuda", "--steps", str(SHARDED_STEPS), "--log-every",
            str(SHARDED_LOG_EVERY)]
    t0 = time.perf_counter()
    out = torchrun(argv)
    train_s = time.perf_counter() - t0
    outs = {True: [], False: []}
    for grouped in (False, True, True, False):
        with world_variables(grouped):
            outs[grouped].append(cli_run(argv))
    losses = step_losses(out)
    n_logged = len(range(0, SHARDED_STEPS, SHARDED_LOG_EVERY)) + 1
    if any(len(step_losses(o)) != n_logged for o in [out] + outs[True] + outs[False]):
        raise PhaseFailure(f"train logged other than {n_logged} step lines:\n{out[-2000:]}")
    falls = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    launched_ms = steady_step_ms(out, TRAIN_RAYS)
    step_run_ms = {k: [steady_step_ms(o, TRAIN_RAYS) for o in v] for k, v in outs.items()}
    t0 = time.perf_counter()
    out_r = torchrun(["render", "--sharded", "--device", "cuda", "-o", str(root / "sharded.ppm")])
    render_s = time.perf_counter() - t0
    cli_run(["render", "--device", "cuda", "-o", str(root / "single.ppm")])
    same_bytes = (root / "sharded.ppm").read_bytes() == (root / "single.ppm").read_bytes()
    ok = (falls and same_bytes and all("mesh: 1 rank(s) (nccl)" in o for o in [out] + outs[True])
          and all("mesh: 1 rank(s)\n" in o for o in outs[False])
          and "rays split over 1 rank(s)" in out_r)
    say("27 sharded", f"(d) {card}: train --device cuda --steps {SHARDED_STEPS} --log-every "
        f"{SHARDED_LOG_EVERY} under torchrun --nproc-per-node 1: exit 0 in {train_s:.1f} s, "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, steady step (steps {SHARDED_LOG_EVERY + 1}-"
        f"{SHARDED_STEPS - 1}) {launched_ms:.2f} ms; in this process, in turns (plain, world of "
        f"1 from torchrun's variables, world of 1, plain): plain "
        f"{', '.join(f'{v:.2f}' for v in step_run_ms[False])} ms, world of 1 under NCCL "
        f"{', '.join(f'{v:.2f}' for v in step_run_ms[True])} ms; render --sharded under "
        f"torchrun exit 0 in {render_s:.1f} s, its bytes the unsharded render's {same_bytes} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("train or render --sharded under torchrun failed its checks:\n"
                           + out[-2000:] + out_r[-1000:])
    return frame_ms, step_ms


# The examples gallery and the vendored serving presets (phase 28).
EXAMPLE_LIMIT_S = 300                  # an examples_torch/ script is killed after this
# Each script with the JAX script's defaults (01 and 08 through K1), its
# outputs in the phase's directory, and the dtype its K1 launches run in.
EXAMPLES = (
    ("01_render.py", ["--impl", "pallas"], "float32"),
    ("02_fused_kernel.py", [], "float32"),
    ("02_fused_kernel.py", ["--dtype", "bfloat16"], "bfloat16"),
    ("03_train_distillation.py", ["--ckpt", "{tmp}/ck03", "--export", "{tmp}/exported03"], None),
    ("04_multichip_render.py", [], None),
    ("05_occupancy_grid.py", [], "bfloat16"),
    ("06_multihost.py", [], None),
    ("07_accel_training.py", [], "bfloat16"),
    ("08_turntable.py", ["--impl", "pallas"], "float32"),
    ("09_student_distillation.py", [], None),
    ("10_geometry_export.py", ["--out", "{tmp}/lego_mesh.ply"], "bfloat16"),
    ("11_hashgrid.py", ["--out", "{tmp}/hashgrid.png"], None),
    ("12_int8_quantization.py", [], None),
    ("13_single_pass_serving.py", [], "bfloat16"),
)
# The scripts' kernels that must have launched, by the wrappers' counts.
EXAMPLE_KERNELS = {"01_render.py": "fused_nerf_mlp", "02_fused_kernel.py": "fused_nerf_mlp",
                   "05_occupancy_grid.py": "fused_nerf_mlp", "07_accel_training.py": "fused_nerf_mlp",
                   "08_turntable.py": "fused_nerf_mlp", "10_geometry_export.py": "fused_nerf_mlp",
                   "11_hashgrid.py": "fused_hash_encode", "12_int8_quantization.py": "fused_int8_mlp",
                   "13_single_pass_serving.py": "fused_nerf_mlp"}
# Runs a script as __main__ in a process of its own and prints the
# kernels' launch counts on its way out.
COUNTING_RUNNER = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
from chip_smoke import read_counts
sys.argv = sys.argv[2:]
code = 0
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    code = e.code
finally:
    print("KERNEL_LAUNCHES " + json.dumps(read_counts()), flush=True)
sys.exit(code)
"""
# bench.py's frontier presets (bench.py:394-436) with its accel defaults
# (bench.py:536-543): a 128^3 grid of each network's own field,
# accel_compact "off", 32 probes at stride 4, ray packing, bf16 K1. The
# bar is the JAX package's record against the teacher frame (bench.py's
# comments, assets/trained/README.md) less 0.5 dB for bf16 orderings.
PRESETS = (
    ("tsp_s64x0_probe", "teacher_sp30", 64, 0, True, 29.9),
    ("sp29_s64x0_probe", "student128_sp29", 64, 0, True, 28.8),
    ("student30_800q", "student128_30db", 64, 128, False, 29.6),
)
EXAMPLE_11_HASH = dict(levels=8, table_log2=14, res_max=256)   # 11_hashgrid.py's defaults
PRESET_REPS = 5                        # bench.py's key for the compared frame is rep - 1


def example_run(script: str, args, root: Path):
    """One ``examples_torch/`` script in its own process (its session
    killed at EXAMPLE_LIMIT_S), from ``root``: (output, launch counts, wall
    s); a non-zero exit fails the phase."""
    import os
    import signal

    argv = [a.format(tmp=root) for a in args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", COUNTING_RUNNER, str(REPO), str(REPO / "examples_torch" / script),
         *argv], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text = proc.communicate(timeout=EXAMPLE_LIMIT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise PhaseFailure(f"examples_torch/{script} did not end in {EXAMPLE_LIMIT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise PhaseFailure(f"examples_torch/{script} {' '.join(argv)} exited with "
                           f"{proc.returncode}:\n{text[-3000:]}")
    counts = json.loads(re.search(r"^KERNEL_LAUNCHES (.*)$", text, re.M).group(1))
    return text, counts, wall


def check_example(script: str, args, out: str, root: Path, dev) -> str:
    """The key lines of a script's output (run with ``args``) and the
    files it wrote -> a short summary; a miss fails the phase."""
    from nerf_rs_tpu_torch.io.image import load_png, load_ppm

    def need(ok, what):
        if not ok:
            raise PhaseFailure(f"examples_torch/{script}: {what}:\n{out[-2000:]}")

    if script == "01_render.py":
        db = psnr(load_png(root / "lego.png") / 255.0, load_ppm(GOLDEN_PPM))
        need(db > GOLDEN_BAR_DB, f"lego.png {db:.2f} dB from the golden (bar > {GOLDEN_BAR_DB})")
        return f"lego.png vs committed golden {db:.2f} dB"
    if script == "02_fused_kernel.py":
        rgb = float(re.search(r"max \|rgb - oracle\| += (\S+)", out).group(1))
        sigma = float(re.search(r"max \|sigma - oracle\| = (\S+)", out).group(1))
        dtype = args[args.index("--dtype") + 1] if "--dtype" in args else "float32"
        tol = TOLERANCES[dtype]
        need(rgb <= tol["rgb_atol"] and sigma <= tol["sigma_atol"],
             f"{dtype} deviations {rgb:.2e} / {sigma:.2e} over {tol['rgb_atol']:g} / "
             f"{tol['sigma_atol']:g}")
        line = re.search(r"^\d+ samples .*$", out, re.M)
        return (f"{dtype} deviations rgb {rgb:.2e}, sigma {sigma:.2e} (bars {tol['rgb_atol']:g} / "
                f"{tol['sigma_atol']:g}); {line.group(0) if line else 'not timed'}")
    if script == "03_train_distillation.py":
        from nerf_rs_tpu_torch.io.weights import load_nerf_params, validate_param_shapes

        need(all(math.isfinite(float(v)) for v in re.findall(r"loss (\S+)", out)),
             "a non-finite loss")
        for net in ("coarse", "fine"):
            validate_param_shapes(load_nerf_params(root / "exported03" / net))
        return "losses finite; exported03 reads back with the reference's shapes"
    if script == "04_multichip_render.py":
        need("sharded == single-device, bitwise: True" in out, "sharded frame not bitwise")
        return "sharded == single-device, bitwise: True"
    if script == "05_occupancy_grid.py":
        need("ray-culled render bitwise equal: True" in out, "packed frame not bitwise")
        db = float(re.search(r"accelerated vs exact: ([\d.]+) dB", out).group(1))
        need(db >= ACCEL_BAR_DB, f"accelerated vs exact {db} dB < {ACCEL_BAR_DB}")
        return f"accelerated vs exact {db} dB, packed bitwise"
    if script == "06_multihost.py":
        need("multihost == single-device, bitwise: True" in out, "multihost frame not bitwise")
        need((root / "lego_multihost.png").exists(), "no lego_multihost.png")
        return "multihost == single-device, bitwise: True; lego_multihost.png written"
    if script == "07_accel_training.py":
        ratio = float(re.search(r"culled/dense throughput: (\S+)x", out).group(1))
        need(math.isfinite(ratio) and ratio > 0, f"culled/dense ratio {ratio}")
        return re.search(r"^culled/dense .*$", out, re.M).group(0)
    if script == "08_turntable.py":
        from nerf_rs_tpu_torch.config import RenderConfig
        from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
        from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
        from nerf_rs_tpu_torch.models.mlp import NerfMLP
        from nerf_rs_tpu_torch.ops import random
        from nerf_rs_tpu_torch.ops.rays import orbit_camera
        from nerf_rs_tpu_torch.render import render_image

        frames = sorted((root / "turntable").glob("frame_*.png"))
        shapes = {load_png(f).shape for f in frames}
        need(len(frames) == 12 and shapes == {(128, 128, 3)}, f"frames {len(frames)}, {shapes}")
        # Frame 0 (orbit angle 0) against the plain path's frame, as 08 renders it.
        assets = find_lego_assets()
        nets = [NerfMLP(load_nerf_params(assets / net), device=dev) for net in ("coarse", "fine")]
        cam = orbit_camera(camera_from_golden(load_golden(assets / "tf_reference_samples.json")), 0.0)
        plain = render_image(*nets, cam, 128, 128, random.key(0, dev),
                             RenderConfig(n_coarse=32, n_fine=64, ray_chunk=128 ** 2, impl="xla"))
        db = psnr(load_png(frames[0]) / 255.0, plain.cpu().numpy())
        need(db > GOLDEN_BAR_DB, f"frame_000.png {db:.2f} dB from the plain frame (bar > "
             f"{GOLDEN_BAR_DB})")
        return (f"12 frames of 128x128; frame_000.png vs the plain frame {db:.2f} dB (bar > "
                f"{GOLDEN_BAR_DB}); " + re.search(r"^\S+ ms/frame .*$", out, re.M).group(0))
    if script == "09_student_distillation.py":
        db = float(re.search(r"student PSNR vs teacher \S+ after \d+ steps: (\S+) dB", out).group(1))
        need(math.isfinite(db), f"student PSNR {db}")
        return f"student PSNR vs teacher {db} dB after a few steps (finite; no bar)"
    if script == "10_geometry_export.py":
        verts, faces = (int(v.replace(",", "")) for v in re.search(
            r"([\d,]+) vertices, ([\d,]+) triangles", out).groups())
        need(verts > 0 and faces > 0 and (root / "lego_mesh.ply").stat().st_size > 0,
             "an empty mesh")
        return f"lego_mesh.ply {verts:,} vertices, {faces:,} triangles"
    if script == "11_hashgrid.py":
        need(all(math.isfinite(float(v)) for v in re.findall(r"loss (\S+)", out)),
             "a non-finite loss")
        db = float(re.search(r"hashgrid PSNR vs teacher \S+ after \d+ steps: (\S+) dB",
                             out).group(1))
        shape = load_png(root / "hashgrid.png").shape
        need(math.isfinite(db) and shape == (32, 32, 3), f"PSNR {db}, hashgrid.png {shape}")
        return (f"losses finite, PSNR vs teacher {db} dB after a few steps (no bar: the encode "
                f"is held to its plain version below), hashgrid.png {shape}")
    if script == "12_int8_quantization.py":
        db = float(re.search(r"PTQ int8 vs f32 exact at \S+: (\S+) dB", out).group(1))
        need(db > INT8_VS_F32_BAR_DB, f"PTQ int8 vs f32 {db} dB (bar > {INT8_VS_F32_BAR_DB})")
        need(all(math.isfinite(float(v)) for v in re.findall(r"QAT step \d+: loss (\S+)", out)),
             "a non-finite QAT loss")
        return f"PTQ int8 vs f32 exact {db} dB (bar > {INT8_VS_F32_BAR_DB}); QAT losses finite"
    if script == "13_single_pass_serving.py":
        shape = load_png(root / "single_pass.png").shape
        need(shape == (128, 128, 3), f"single_pass.png shape {shape}")
        return re.search(r"^\d+x\d+ single-pass .*$", out, re.M).group(0)
    raise PhaseFailure(f"examples_torch/{script}: no check of its output")


def phase_examples(cam, dev, card):
    """Phase 28 in a temporary directory, removed when the phase ends."""
    with tempfile.TemporaryDirectory(prefix="nerf_rs_tpu_torch_examples_") as tmp:
        return run_phase_examples(Path(tmp), cam, dev, card)


def run_phase_examples(root: Path, cam, dev, card):
    """Phase 28: (a) every examples_torch/ script on the card; (b) the
    vendored networks' serving presets at 800x800 against the teacher
    frame, with times and idle shares; (c) the sp29 preset's f32 K1 frame
    against its plain frame. Returns the phase's launches of each kernel
    line entry."""
    import torch

    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import HashGridConfig, RenderConfig
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import infer_arch
    from nerf_rs_tpu_torch.render import render_image

    t_phase = time.perf_counter()
    extra = {"fused_nerf_mlp": 0, "fused_nerf_mlp_bf16": 0, "hash_encode": 0, "int8_mlp": 0}
    pts_c, pts_f, _ = main_path_inputs(cam, dev, BENCH_CHUNK)

    # (a) The gallery: the scripts that launch no kernel (not in
    # EXAMPLE_KERNELS) two at a time beside the others, which run one at a
    # time: one at a time, the phase alone took 314.6 s and the whole run
    # 1,122 s, past its 1,080 s. Each script's launches are its own
    # process's; its wall overlaps others', so it is reported, not a
    # metric. Then every script's checks, in order.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        side = {i: pool.submit(example_run, script, args, root)
                for i, (script, args, _) in enumerate(EXAMPLES) if script not in EXAMPLE_KERNELS}
        runs = {i: example_run(script, args, root)
                for i, (script, args, _) in enumerate(EXAMPLES) if i not in side}
        runs.update({i: future.result() for i, future in side.items()})
    for i, (script, args, k1_dtype) in enumerate(EXAMPLES):
        out, counts, wall = runs[i]
        summary = check_example(script, args, out, root, dev)
        kernel = EXAMPLE_KERNELS.get(script)
        if kernel and counts[kernel] == 0:
            raise PhaseFailure(f"examples_torch/{script} never launched {kernel}")
        if counts["fused_nerf_mlp_tc"] != counts["fused_nerf_mlp"]:
            raise PhaseFailure(f"examples_torch/{script}: K1 launches off the tensor cores: {counts}")
        if counts["fused_nerf_mlp"] and k1_dtype is None:
            raise PhaseFailure(f"examples_torch/{script} launched K1 in its plain configuration")
        extra["fused_nerf_mlp" if k1_dtype == "float32" else "fused_nerf_mlp_bf16"] += \
            counts["fused_nerf_mlp"]
        extra["hash_encode"] += counts["fused_hash_encode"]
        extra["int8_mlp"] += counts["fused_int8_mlp"]
        launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "no kernel"
        say("28 examples", f"{script} {' '.join(args).format(tmp='.')}: exit 0 in {wall:.1f} s "
            f"wall (overlapped); launches: {launched}; {summary}")

    # The encode against its plain version at 11's table and level shapes
    # (f32 tables, as 11 trains and renders them).
    hcfg = HashGridConfig(**EXAMPLE_11_HASH)
    gen = torch.Generator(device=dev).manual_seed(11)
    tables = torch.rand((hcfg.levels, 1 << hcfg.table_log2, hcfg.features), generator=gen,
                        device=dev) * 2.0 - 1.0
    saved = save_counts()
    for label, pts in (("coarse", pts_c), ("fine", pts_f)):
        ok, err, bar, what, exact, bitwise = encode_vs_plain(tables, pts, hcfg,
                                                             float(tables.abs().max()))
        say("28 examples", f"11_hashgrid.py's encode (L={hcfg.levels}, T=2^{hcfg.table_log2}, "
            f"F={hcfg.features}, res_max {hcfg.res_max}) float32 {label} {tuple(pts.shape[:-1])}: "
            f"max |kernel - plain| {err:.3e} (bar {bar:.3e}, {what}), exactly equal {exact}, two "
            f"calls bitwise equal {bitwise} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"the encode disagrees with its plain version at 11's shapes ({label})")
    restore_counts(saved)                      # comparison launches do not count

    # (b) The vendored presets at 800x800 against the teacher's frame, each
    # frame's K1 calls (and its grid sweep's) held to the plain version.
    def check_k1_calls(what, calls, nets):
        names = {id(net): "{} (width {}, v_width {})".format(label, *infer_arch(net.tree())[:2])
                 for label, net in nets.items()}
        saved = save_counts()
        for ok, line in k1_bf16_witness(calls, names):
            say("28 presets", f"{what}: bf16 K1 vs plain on the path's own inputs, {line}")
            if not ok:
                raise PhaseFailure(f"bf16 K1 disagrees with its plain version in the {what}")
        restore_counts(saved)                  # comparison launches do not count
        calls.clear()

    size = BENCH_SIZE
    trained = REPO / "assets" / "trained"
    key = random.fold_in(random.key(0, dev), torch.tensor(PRESET_REPS - 1))
    lego = {net: NerfMLP(load_nerf_params(REPO / "assets" / "lego_rust" / net), device=dev)
            for net in ("coarse", "fine")}
    teacher_cfg = RenderConfig(n_coarse=N_COARSE, n_fine=N_FINE, ray_chunk=min(BENCH_CHUNK, 16384),
                               impl="pallas", dtype="bfloat16")
    zero_counts()
    teacher, calls = recorded_k1(
        lambda: render_image(lego["coarse"], lego["fine"], cam, size, size, key, teacher_cfg))
    torch.cuda.synchronize()
    counts = read_counts()
    check_k1_calls("teacher frame", calls, lego)
    n_chunks = -(-size * size // BENCH_CHUNK)
    if counts["fused_nerf_mlp"] != 2 * n_chunks or counts["fused_nerf_mlp_tc"] != 2 * n_chunks:
        raise PhaseFailure(f"teacher frame: K1 launches {counts} (expected {2 * n_chunks}, every "
                           f"one on the tensor cores)")
    extra["fused_nerf_mlp_bf16"] += counts["fused_nerf_mlp"]
    teacher = teacher.cpu().numpy()
    say("28 presets", f"teacher frame {size}x{size} (assets/lego_rust, {N_COARSE}+{N_FINE}, bf16 "
        f"K1, {teacher_cfg.ray_chunk}-ray chunks): {counts['fused_nerf_mlp']} K1 launches, all "
        f"on the tensor cores")
    sweep_launches = 2 * -(-GRID_RES ** 3 // 262_144)
    nets = {}
    for name, weights, nc, nf, aabb, bar in PRESETS:
        pc, pf = (NerfMLP(load_nerf_params(trained / weights / net), device=dev)
                  for net in ("coarse", "fine"))
        nets[name] = (pc, pf)
        cfg = RenderConfig(n_coarse=nc, n_fine=nf, ray_chunk=BENCH_CHUNK, impl="pallas",
                           dtype="bfloat16", accel_compact="off", accel_sample_aabb=aabb,
                           accel_aabb_probes=PROBES, accel_range_stride=STRIDE,
                           accel_cull_rays=True)
        torch.cuda.synchronize()
        zero_counts()

        def main_path():
            g = build_scene_grid(pc, pf, resolution=GRID_RES)
            return g, render_image(pc, pf, cam, size, size, key, cfg, grid=g)

        (grid, img), calls = recorded_k1(main_path)
        torch.cuda.synchronize()
        counts = read_counts()
        check_k1_calls(name, calls, {"coarse": pc, "fine": pf})
        _, chunks = rendered_chunks(grid, cam, size, cfg, dev)
        want = sweep_launches + chunks * (2 if nf else 1)
        db = psnr(img.cpu().numpy(), teacher)
        ok = (db >= bar and counts["fused_nerf_mlp"] == want
              and counts["fused_nerf_mlp_tc"] == want and bool(torch.isfinite(img).all()))
        extra["fused_nerf_mlp_bf16"] += counts["fused_nerf_mlp"]
        saved = save_counts()
        frames = []
        for _ in range(PRESET_REPS + 1):       # the first a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_image(pc, pf, cam, size, size, key, cfg, grid=grid)
            torch.cuda.synchronize()
            frames.append((time.perf_counter() - t0) * 1e3)
        frame_ms = statistics.median(frames[1:])
        wall, busy, top = profile_frame(
            lambda: render_image(pc, pf, cam, size, size, key, cfg, grid=grid))
        restore_counts(saved)                  # timing launches do not count
        idle = f"idle share {1 - busy / wall:.4f} (wall {wall:.1f} ms, busy {busy:.1f} ms)" \
            if busy > 0 else "idle share not measured (torch.profiler saw no device time)"
        say("28 presets", f"{name} (assets/trained/{weights}, {nc}+{nf}, "
            f"{'box+probe placement' if aabb else 'probe culling'}): vs teacher frame {db:.2f} dB "
            f"(bar >= {bar}); grid {float(grid.occ.float().mean()):.4f} occupied, {chunks} of "
            f"{n_chunks} chunks rendered; K1 launches {counts['fused_nerf_mlp']} (expected "
            f"{want}), on the tensor cores {counts['fused_nerf_mlp_tc']} -> "
            f"{'ok' if ok else 'FAIL'}")
        say("28 presets", f"{card}: {name} {size}x{size} frame {frame_ms:.1f} ms (median of "
            f"{PRESET_REPS}; {min(frames[1:]):.1f}-{max(frames[1:]):.1f}), "
            f"{size * size / frame_ms * 1e3:,.0f} rays/s; one frame under "
            f"torch.profiler: {idle}; top: " + "; ".join(f"{n[:50]} {ms:.1f} ms" for n, ms in top))
        if not ok:
            raise PhaseFailure(f"{name} misses its bar against the teacher or went around the "
                               f"tensor-core K1")

    # (c) K1 f32 end to end at the students' widths: the sp29 preset at
    # 256x256 in f32, kernel frame against the plain frame.
    pc, pf = nets["sp29_s64x0_probe"]
    cfg = RenderConfig(n_coarse=64, n_fine=0, ray_chunk=BENCH_CHUNK, impl="pallas",
                       accel_compact="off", accel_sample_aabb=True, accel_aabb_probes=PROBES,
                       accel_range_stride=STRIDE, accel_cull_rays=True)
    grid = build_scene_grid(pc, pf, resolution=GRID_RES)
    _, chunks = rendered_chunks(grid, cam, H, cfg, dev)
    torch.cuda.synchronize()
    zero_counts()
    img = render_image(pc, pf, cam, H, W, random.key(0, dev), cfg, grid=grid)
    torch.cuda.synchronize()
    counts = read_counts()
    plain = render_image(pc, pf, cam, H, W, random.key(0, dev), cfg.replace(impl="xla"), grid=grid)
    db = psnr(img.cpu().numpy(), plain.cpu().numpy())
    ok = (db >= PLAIN_BAR_DB and counts["fused_nerf_mlp"] == chunks
          and counts["fused_nerf_mlp_tc"] == chunks)
    extra["fused_nerf_mlp"] += counts["fused_nerf_mlp"]
    say("28 presets", f"sp29_s64x0_probe {H}x{W} f32: K1 frame vs plain frame {db:.2f} dB (bar >= "
        f"{PLAIN_BAR_DB}); K1 f32 launches {counts['fused_nerf_mlp']} (expected {chunks}, width "
        f"128 / v_width 64), on the tensor cores {counts['fused_nerf_mlp_tc']} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the sp29 f32 K1 frame misses the plain frame's bar or went around "
                           "the tensor-core K1")
    say("28 examples", f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return extra


# K1's wide envelope (phase 29): networks wider than 256 or deeper than 16
# through the wide kernels (csrc/fused_mlp_wide_tc.cu in bf16,
# csrc/fused_mlp_wide_f32.cu in f32) as a user reaches them: the lego
# networks widened to the same function at (width, v_width, depth) =
# WIDE_LEGOS, rendered through the CLI; random networks at WIDE_RANDOM
# against the plain version; a 512-wide student trained, checkpointed,
# rendered, evaluated and served; `--impl int8` through the wide int8
# kernel (csrc/int8_mlp_wide_tc.cu); past width 512, the wide1k pair
# (WIDE1K_LEGO, WIDE1K_RANDOM).
WIDE_LEGOS = ((512, 256, 8), (384, 192, 8), (512, 256, 12))
WIDE_RANDOM = ((384, 192, 8, 4), (512, 256, 8, 4), (512, 256, 12, 4))
# Past width 512 (phase 29 (e)): K1's wide1k pair (csrc/fused_mlp_wide1k_tc.cu
# in bf16, csrc/fused_mlp_wide1k_f32tc.cu in f32) on the lego widened 4x to
# mip-NeRF 360's trunk width, and random networks (width, v_width, depth,
# skip_at): that width with the NeRF view width, widths not a multiple of
# 64, and the envelope's edge.
WIDE1K_LEGO = (1024, 512, 8)
WIDE1K_RANDOM = ((1024, 512, 8, 4), (1024, 128, 8, 4), (776, 264, 12, 4), (1024, 1024, 32, 10))
WIDE1K_FRAME = 256                      # the accel+K3 frame's size past width 512
# The random network and samples of tests/test_torch_cuda.py's
# test_wide_backward_kernel_matches_plain[random_512x512x32-bfloat16-*]
# (random_k2_case).
WIDE_K2_RANDOM = (512, 512, 32, 10)
WIDE_STEPS = 20
WIDE_BF16_STEPS = 5                     # train --dtype bfloat16 steps of the 512-wide student
WIDE_EXACT_RAYS = 1024                  # rays a chunk of the float64 evaluation of wide K2
FRONT_NOTE = "outside the fused kernels' range"     # cli._impl_for_params
K2_NOTE = "the fused backward K2 serves"            # cli._train_impl_for_params
INT8_NOTE = "outside the int8 kernel's range"


def random_k2_case(arch, dev, rays: int = 37, samples: int = 29):
    """tests/test_torch_cuda.py's random wide K2 case, from numpy: the
    network (Glorot-uniform kernels and N(0, 0.1) biases, seed 5), points
    uniform in [-4, 4]^3 and one unit dir a ray (seed 5), normal cotangents
    (seed 6). -> (NerfMLP, (points, dirs, g_rgb, g_sigma))."""
    import numpy as np
    import torch

    from nerf_rs_tpu_torch.config import ArchConfig
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes

    rng = np.random.default_rng(5)
    tree = {}
    for layer, (d_in, d_out) in arch_shapes(ArchConfig(*arch)).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        tree[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                       "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    rng = np.random.default_rng(5)
    pts = rng.uniform(-4, 4, size=(rays, samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rng = np.random.default_rng(6)
    g_rgb = rng.normal(size=(rays, samples, 3)).astype(np.float32)
    g_sig = rng.normal(size=(rays, samples)).astype(np.float32)
    args = tuple(torch.from_numpy(a).to(dev) for a in (pts, dirs, g_rgb, g_sig))
    return NerfMLP(tree, device=dev), args


def random_k2_report(net, args, label: str, sigma_only: bool = False,
                     phase: str = "29 wide") -> float:
    """K2 bf16 on a random network 32 layers deep (random_k2_case's seeds),
    held to the float64 evaluation (the reference on float64 inputs,
    rounded where the kernels round), since any summation order but
    cuBLAS's own lies further than 3e-2 from the plain version there
    (PERF.md §7): each gradient within max(3e-2, F32_VS_PLAIN x the plain
    version's distance) of it, and the kernel's largest distance over the
    call's gradients no larger than the plain version's; every gradient
    finite, two calls bitwise equal, the color branch zero in sigma-only
    calls. Its largest distance from the plain version is reported. ->
    the largest parameter-gradient difference from plain."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_backward_reference

    got, again, want, _ = k2_gradients(net, args, "bfloat16", sigma_only)
    with torch.no_grad():
        exact = fused_nerf_mlp_backward_reference(net, *(a.double() for a in args),
                                                  dtype="bfloat16", sigma_only=sigma_only)
    pk = net.packed("bfloat16")
    gk, gp, g64 = (named_gradients(pk, out) for out in (got, want, exact))
    live = [k for k in g64 if bool(g64[k].any())]
    zero = all(not bool(gk[k].any()) for k in g64 if k not in live)
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if not live:    # the sigma head's ReLU off on every sample: every gradient zero
        ok = finite and bitwise and zero
        say(phase, f"K2 {label} {tuple(args[0].shape[:-1])} bfloat16"
            f"{' sigma-only' if sigma_only else ''}: every gradient zero in float64 (the sigma "
            f"head's ReLU off on every sample), the kernel's too: {zero}; two calls bitwise "
            f"equal: {bitwise} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"K2 bf16 on the random network {label} is not zero where float64 "
                               "is, or is not deterministic")
        return 0.0
    vs_plain = {k: rel_err(gk[k], gp[k]) for k in live}
    worst = max(vs_plain, key=vs_plain.get)
    k64, p64 = ({k: rel_err(g[k].double(), g64[k]) for k in live} for g in (gk, gp))
    k_worst, p_worst = max(k64, key=k64.get), max(p64, key=p64.get)
    margin = {k: k64[k] / max(BWD_BARS["bfloat16"], F32_VS_PLAIN * p64[k]) for k in live}
    tight = max(margin, key=margin.get)
    ok = finite and bitwise and zero and k64[k_worst] <= p64[p_worst] and margin[tight] <= 1.0
    say(phase, f"K2 {label} {tuple(args[0].shape[:-1])} bfloat16"
        f"{' sigma-only' if sigma_only else ''}: against float64 over {len(live)} gradients, "
        f"tightest {tight}: kernel {k64[tight]:.3e}, plain {p64[tight]:.3e} (bar max("
        f"{BWD_BARS['bfloat16']}, {F32_VS_PLAIN} x plain)); worst: kernel {k64[k_worst]:.3e} "
        f"({k_worst}), plain {p64[p_worst]:.3e} ({p_worst}) (bar: the kernel's no larger); "
        f"worst ||g_k - g_p|| / ||g_p|| {vs_plain[worst]:.3e} ({worst}; reported); finite "
        f"{finite}; two calls bitwise equal: {bitwise} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure(f"K2 bf16 on the random network {label} misses the float64 bars, is "
                           "not finite or is not deterministic")
    return max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))


def widen_nerf(tree, width: int, v_width: int, depth: int = 0, seed: int = 0):
    """A param tree (numpy f32) of trunk width ``width``, view width
    ``v_width`` and ``depth`` dense layers (default: the same) that
    computes the function of ``tree`` (numpy or torch leaves): each
    hidden unit of the trunk, the bottleneck and the view layer is kept,
    and copied so that it appears 1, 2 or 4 times (up to doubling a layer,
    ``width - w`` (or ``v_width - v``) units twice and the rest once; past
    that, some units 4 times, at most quadrupling a layer). Never 3
    times: a copy keeps its unit's incoming weights and bias, and the
    outgoing rows of a unit that appears c times are divided by c in every
    copy, which is exact in binary for c = 2 and 4 but not for 3, so the
    next layer sums the same products (in another order). Widths that
    would need a unit 3 times (4 w - 1) are refused.
    The encode rows of the skip and view layers stay as they are. Each
    layer's units are placed by a permutation drawn from ``seed``, so a
    kernel that reads the wrong columns cannot pass. Layers past the
    original depth are identity layers after the last trunk layer:
    relu(h I + 0) = h for the h >= 0 it receives, exact in f32 and bf16."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def kern(name):
        return np.asarray(tree[name]["kernel"], np.float32)

    def bias(name):
        return np.asarray(tree[name]["bias"], np.float32)

    def spread(n, m):
        """(source unit of each of m units, the factor of its outgoing rows)."""
        extra = m - n
        quads = max(0, -(-(extra - n) // 2))           # units 4 times; 3 extra copies each
        if not 0 <= extra <= 3 * n or 3 * quads > extra:
            raise ValueError(f"cannot widen a layer of {n} units to {m}")
        if quads:
            picks = rng.choice(n, extra - 2 * quads, replace=False)
            copies = np.concatenate([np.repeat(picks[:quads], 3), picks[quads:]])
        else:
            copies = rng.choice(n, extra, replace=False)
        src = np.concatenate([np.arange(n), copies])
        rng.shuffle(src)
        return src, (1.0 / np.bincount(src, minlength=n)[src]).astype(np.float32)

    def fed_by(k, units):
        src, factor = units
        return k[src] * factor[:, None]

    w, v = kern("dense0").shape[1], kern("viewdirs").shape[1]
    d = sum(1 for name in tree if name.startswith("dense"))
    depth = depth or d
    if depth < d:
        raise ValueError(f"cannot cut {d} layers to {depth}")
    out, units = {}, None
    for i in range(d):
        k = kern(f"dense{i}")
        if i > 0:
            enc = k.shape[0] - w                       # a skip layer's encode rows come first
            k = np.concatenate([k[:enc], fed_by(k[enc:], units)])
        units = spread(w, width)
        out[f"dense{i}"] = {"kernel": k[:, units[0]], "bias": bias(f"dense{i}")[units[0]]}
    for i in range(d, depth):
        out[f"dense{i}"] = {"kernel": np.eye(width, dtype=np.float32),
                            "bias": np.zeros(width, np.float32)}
    out["alpha"] = {"kernel": fed_by(kern("alpha"), units), "bias": bias("alpha")}
    bneck = spread(w, width)
    out["bottleneck"] = {"kernel": fed_by(kern("bottleneck"), units)[:, bneck[0]],
                         "bias": bias("bottleneck")[bneck[0]]}
    view, k = spread(v, v_width), kern("viewdirs")
    k = np.concatenate([fed_by(k[:w], bneck), k[w:]])
    out["viewdirs"] = {"kernel": k[:, view[0]], "bias": bias("viewdirs")[view[0]]}
    out["rgb"] = {"kernel": fed_by(kern("rgb"), view), "bias": bias("rgb")}
    return out


def write_wide_lego(root: Path, assets: Path, width: int, v_width: int, depth: int) -> Path:
    """The lego networks widened by ``widen_nerf`` (seed 0 coarse, 1 fine),
    saved with the port's ``save_nerf_params`` beside the lego camera: a
    directory for ``render --weights``."""
    import shutil

    from nerf_rs_tpu_torch.io.weights import load_nerf_params, save_nerf_params

    out = root / f"lego_{width}x{v_width}x{depth}"
    for seed, net in enumerate(("coarse", "fine")):
        save_nerf_params(out / net, widen_nerf(load_nerf_params(assets / net), width, v_width,
                                               depth, seed=seed))
    shutil.copy(assets / "tf_reference_samples.json", out)
    return out


def phase_wide(cam, dev, card, assets: Path):
    """Phase 29 in a temporary directory, removed when the phase ends."""
    with tempfile.TemporaryDirectory(prefix="nerf_rs_tpu_torch_wide_") as tmp:
        return run_phase_wide(Path(tmp), cam, dev, card, assets)


def wide_cli_frame(argv, out: Path):
    """``render`` through the CLI with the counts set to 0 just before and
    read just after -> (frame as float32 (H, W, 3), stdout, counts)."""
    from nerf_rs_tpu_torch.io.image import load_ppm

    zero_counts()
    text = cli_run(["render", *argv, "-o", str(out)])
    return load_ppm(out), text, read_counts()


def run_phase_wide(root: Path, cam, dev, card, assets: Path):
    """Phase 29: K1's, K2's and the int8 wide kernels on their main paths,
    each run with the counts set to 0 just before and read just after; ->
    (the wide K1 and K2 entries of the kernels line, the wide int8 kernel's
    launches in the main-path runs)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from nerf_rs_tpu_torch import api, serve
    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
    from nerf_rs_tpu_torch.io import checkpoint as ckpt_io
    from nerf_rs_tpu_torch.io.image import load_ppm, pixels_to_rgba
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp,
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
        fused_nerf_mlp_reference,
    )
    from nerf_rs_tpu_torch.render import render_image

    t_phase = time.perf_counter()
    golden = load_ppm(GOLDEN_PPM)
    chunks = -(-H * W // 16384)                       # the CLI's --ray-chunk
    launched = {"float32": 0, "bfloat16": 0}          # wide launches of the main-path runs
    frames = {}

    # (a) The widened lego through `render --weights`, f32 and plain.
    for width, v_width, depth in WIDE_LEGOS:
        d = write_wide_lego(root, assets, width, v_width, depth)
        t0 = time.perf_counter()
        img, text, c = wide_cli_frame(["--weights", str(d), "--impl", "pallas"], root / "k.ppm")
        ms = (time.perf_counter() - t0) * 1e3
        plain, _, _ = wide_cli_frame(["--weights", str(d), "--impl", "xla"], root / "p.ppm")
        launched["float32"] += c["fused_nerf_mlp_wide"]
        frames[(width, v_width, depth)] = (d, img)
        golden_db, plain_db = psnr(img, golden), psnr(plain, img)
        ok = (golden_db > GOLDEN_BAR_DB and plain_db >= PLAIN_BAR_DB and FRONT_NOTE not in text
              and c["fused_nerf_mlp"] == c["fused_nerf_mlp_wide"] == 2 * chunks
              and c["fused_nerf_mlp_tc"] == 0)
        say("29 wide", f"lego widened to width {width}, v_width {v_width}, depth {depth}: render "
            f"--impl pallas {W}x{H} f32 vs golden {golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}), vs "
            f"--impl xla {plain_db:.2f} dB (bar >= {PLAIN_BAR_DB}); note printed: "
            f"{FRONT_NOTE in text}; K1 launches {c['fused_nerf_mlp']}, wide "
            f"{c['fused_nerf_mlp_wide']} (expected {2 * chunks}, none on the tensor cores); "
            f"{ms:.0f} ms through the CLI -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"the widened lego ({width}, {v_width}, {depth}) misses its bars "
                               "or went around the wide f32 kernel")

    # bf16 and the accel path at (512, 256, 8).
    d, img_f32 = frames[WIDE_LEGOS[0]]
    img16, text, c = wide_cli_frame(["--weights", str(d), "--dtype", "bfloat16"], root / "b.ppm")
    launched["bfloat16"] += c["fused_nerf_mlp_wide"]
    bf16_db = psnr(img16, img_f32)
    ok = (bf16_db >= BF16_FRAME_BAR_DB and c["fused_nerf_mlp_wide"] == 2 * chunks
          and c["fused_nerf_mlp_tc"] == 2 * chunks)
    say("29 wide", f"width 512 bf16 frame vs f32 frame {bf16_db:.2f} dB (bar >= "
        f"{BF16_FRAME_BAR_DB}); K1 wide launches {c['fused_nerf_mlp_wide']}, on the tensor "
        f"cores {c['fused_nerf_mlp_tc']} (expected {2 * chunks}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the width-512 bf16 frame misses its bar or went around the wide "
                           "bf16 kernel")
    wide = {net: NerfMLP(load_nerf_params(d / net), device=dev) for net in ("coarse", "fine")}
    zero_counts()
    t0 = time.perf_counter()
    grid = build_scene_grid(wide["coarse"], wide["fine"], resolution=GRID_RES)
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    c_grid = read_counts()
    cfg = accel_cfg(dtype="bfloat16")
    _, n_rendered = rendered_chunks(grid, cam, BENCH_SIZE, cfg, dev)
    zero_counts()
    fast, fast_ms = render_accel(wide["coarse"], wide["fine"], cam, dev, cfg, grid, BENCH_SIZE)
    c_fast = read_counts()
    dense, dense_ms = render(wide["coarse"], wide["fine"], cam, dev, "pallas", "bfloat16",
                             BENCH_SIZE)
    launched["bfloat16"] += c_grid["fused_nerf_mlp_wide"] + c_fast["fused_nerf_mlp_wide"]
    accel_db = psnr(fast.cpu().numpy(), dense)
    sweeps = 2 * -(-GRID_RES ** 3 // (1 << 18))       # accel.build_scene_grid's chunk
    ok = (accel_db >= ACCEL_BAR_DB and c_grid["fused_nerf_mlp_wide"] == c_grid["fused_nerf_mlp"]
          == c_grid["fused_nerf_mlp_tc"] == sweeps
          and c_fast["fused_nerf_mlp_wide"] == c_fast["fused_nerf_mlp_tc"] == 2 * n_rendered
          and c_fast["fused_resample"] == n_rendered)
    say("29 wide", f"width 512 bf16 accel frame {BENCH_SIZE}x{BENCH_SIZE} (grid {GRID_RES}^3 "
        f"through wide K1 bf16 sigma-only: {c_grid['fused_nerf_mlp_wide']} launches (expected "
        f"{sweeps}) "
        f"in {grid_ms:.0f} ms, {float(grid.occ.float().mean()):.4f} occupied; {PROBES} probes, "
        f"stride {STRIDE}, packing, K3) vs the dense bf16 frame {accel_db:.2f} dB (bar >= "
        f"{ACCEL_BAR_DB}); {n_rendered} chunks rendered, K1 wide launches "
        f"{c_fast['fused_nerf_mlp_wide']} (expected {2 * n_rendered}), K3 "
        f"{c_fast['fused_resample']} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the width-512 accel frame misses its bar or went around the wide "
                           "kernel")

    # (b) Random wide networks against the plain version at the render's
    # shapes; not counted.
    saved = save_counts()
    pts_c, pts_f, vd = main_path_inputs(cam, dev)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    nets = {}
    for arch in WIDE_RANDOM:
        g = torch.Generator(device=dev).manual_seed(29)
        net = nets[arch] = NerfMLP(init_nerf_params(g, ArchConfig(*arch)), device=dev)
        for pts, so in ((pts_c, True), (pts_f, False)):
            for dtype in ("float32", "bfloat16"):
                ok, err, line, _ = k1_vs_plain(net, pts, vd, dtype, so)
                errs[dtype] = max(errs[dtype], err)
                say("29 wide", f"K1 {dtype} at {arch}, {tuple(pts.shape[:-1])} "
                    f"{'sigma-only' if so else 'full'}: {line} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseFailure(f"wide K1 {dtype} at {arch} disagrees with its plain "
                                       "version")
    restore_counts(saved)

    # (c) Wide K2 against its plain version at the training path's inputs
    # (what a nerf_loss backward of the lego students hands K2, fed to the
    # widened legos, the same function), not counted; one 512-wide step
    # against the plain step; then a 512-wide student trained through
    # wide K1 and wide K2 (f32, and a few bf16 steps), rendered, evaluated
    # and served.
    saved = save_counts()
    bwd_in = main_path_backward_inputs(dev)
    bwd_errs = {"float32": 0.0, "bfloat16": 0.0}
    bwd_nets = {}
    for width, v_width, depth in WIDE_LEGOS:
        for name, so in (("fine", False), ("coarse", False), ("coarse", True)):
            key = (width, v_width, depth, name)
            if key not in bwd_nets:
                tree = widen_nerf(load_nerf_params(assets / name), width, v_width, depth)
                bwd_nets[key] = NerfMLP(tree, device=dev)
            for dtype in ("float32", "bfloat16"):
                bwd_errs[dtype] = max(bwd_errs[dtype], backward_vs_plain(
                    "29 wide", f"widened lego {name} ({width}, {v_width}, {depth})",
                    bwd_nets[key], bwd_in[name][1:], dtype, sigma_only=so,
                    exact_rays=WIDE_EXACT_RAYS))
    # The random 512/512/32 network of tests/test_torch_cuda.py's bf16 K2
    # case, on its 37 x 29 samples, full and sigma-only, at the 32-deep bf16
    # bar (random_k2_report: the float64 evaluation; the plain version
    # itself lies further than 3e-2 from it there, PERF.md §7).
    net, args = random_k2_case(WIDE_K2_RANDOM, dev)
    label = f"random {WIDE_K2_RANDOM[:3]} (the card test's seeds)"
    for so in (False, True):
        bwd_errs["bfloat16"] = max(bwd_errs["bfloat16"],
                                   random_k2_report(net, args, label, sigma_only=so))
    restore_counts(saved)
    c_step = phase_step_vs_plain(dev, arch=(512, 256, 8, 4), phase="29 wide")
    if c_step["fused_nerf_mlp_backward_wide"] != 2 or c_step["fused_nerf_mlp_backward"] != 2:
        raise PhaseFailure(f"the 512-wide kernel step went around wide K2: {c_step}")
    ck = root / "ck"
    zero_counts()
    out = cli_run(["train", "--width", "512", "--v-width", "256", "--steps", str(WIDE_STEPS),
                   "--log-every", "10", "--checkpoint-dir", str(ck)])
    c_train = read_counts()
    zero_counts()
    out16 = cli_run(["train", "--width", "512", "--v-width", "256", "--dtype", "bfloat16",
                     "--steps", str(WIDE_BF16_STEPS), "--log-every", "1"])
    c16 = read_counts()
    launched["float32"] += c_train["fused_nerf_mlp_wide"]
    launched["bfloat16"] += c16["fused_nerf_mlp_wide"]
    launched["k2_float32"] = c_train["fused_nerf_mlp_backward_wide"]
    launched["k2_bfloat16"] = c16["fused_nerf_mlp_backward_wide"]
    launched["dw_float32"] = c_train["fused_nerf_mlp_backward_dw"]
    launched["dw_bfloat16"] = c16["fused_nerf_mlp_backward_dw"]
    losses = [float(v) for v in re.findall(r"^step \d+: loss ([0-9.e+-]+)", out, flags=re.M)]
    losses16 = [float(v) for v in re.findall(r"^step \d+: loss ([0-9.e+-]+)", out16, flags=re.M)]
    last = ckpt_io.latest_checkpoint(ck)
    n_k2, n_k2_16 = 2 * WIDE_STEPS, 2 * WIDE_BF16_STEPS
    ok = (K2_NOTE not in out + out16 and FRONT_NOTE not in out + out16 and last is not None
          and losses and losses16 and all(map(math.isfinite, losses + losses16))
          and c_train["fused_nerf_mlp_backward"] == c_train["fused_nerf_mlp_backward_wide"] == n_k2
          and c_train["fused_nerf_mlp_wide"] == n_k2
          and c_train["fused_nerf_mlp_backward_bf16"] == 0
          and c16["fused_nerf_mlp_backward"] == c16["fused_nerf_mlp_backward_wide"]
          == c16["fused_nerf_mlp_backward_bf16"] == n_k2_16
          and c_train["fused_nerf_mlp_backward_dw"] >= n_k2
          and c16["fused_nerf_mlp_backward_dw"] >= n_k2_16)
    say("29 wide", f"train --width 512 --v-width 256 --steps {WIDE_STEPS}: note printed: "
        f"{K2_NOTE in out or FRONT_NOTE in out}; losses {losses}; K2 launches "
        f"{c_train['fused_nerf_mlp_backward']}, wide {c_train['fused_nerf_mlp_backward_wide']}, "
        f"wide K1 {c_train['fused_nerf_mlp_wide']} (expected {n_k2} each: the student's two "
        f"networks a step); checkpoint {last}; --dtype bfloat16 --steps {WIDE_BF16_STEPS}: "
        f"note printed: {K2_NOTE in out16 or FRONT_NOTE in out16}, losses {losses16}, K2 "
        f"launches {c16['fused_nerf_mlp_backward']}, wide {c16['fused_nerf_mlp_backward_wide']}, "
        f"bf16 {c16['fused_nerf_mlp_backward_bf16']} (expected {n_k2_16} each); the dW kernel "
        f"{c_train['fused_nerf_mlp_backward_dw']} and {c16['fused_nerf_mlp_backward_dw']} "
        f"times (a round a launch, at least one a K2 launch) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the 512-wide student did not train through wide K1 and wide K2")
    ck_img, text, c = wide_cli_frame(["--checkpoint", str(last)], root / "ck.ppm")
    launched["float32"] += c["fused_nerf_mlp_wide"]
    out = cli_run(["evaluate", "--checkpoint-dir", str(ck), "--size", str(H)])
    m = re.search(r"PSNR vs teacher ([0-9.]+) dB", out)
    eval_db = float(m.group(1)) if m else float("nan")
    api._state.clear()
    api.init_renderer(checkpoint=str(last), device=dev,
                      cfg=RenderConfig(ray_chunk=BENCH_CHUNK, impl="pallas"))
    state = dict(api._state)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/render?width={W}&height={H}&seed=0",
            timeout=300).read()
    finally:
        srv.shutdown()
        srv.server_close()
        api._state.clear()
    want = pixels_to_rgba(render_image(state["params"]["coarse"], state["params"]["fine"],
                                       state["camera"], H, W, random.key(0, dev), state["cfg"],
                                       device=dev, grid=state["grid"]))
    served = body == want.tobytes()
    ok = (FRONT_NOTE not in text and c["fused_nerf_mlp_wide"] == 2 * chunks
          and math.isfinite(eval_db) and served and state["cfg"].impl == "pallas")
    say("29 wide", f"render --checkpoint of the 512-wide student: note printed: "
        f"{FRONT_NOTE in text}, wide K1 launches {c['fused_nerf_mlp_wide']} (expected "
        f"{2 * chunks}); evaluate --checkpoint-dir {H}x{H}: PSNR vs teacher {eval_db:.2f} dB "
        f"(reported); serve (init_renderer(checkpoint=...)) impl {state['cfg'].impl}, one "
        f"/render byte for byte pixels_to_rgba(render_image(...)): {served} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the 512-wide checkpoint's front ends went around wide K1 or disagree")

    # (d) `--impl int8` through the wide int8 kernel: the lego widened to
    # 512/256/8 and 512/256/12, against the plain int8 frame and the f32
    # frame.
    int8_launched = 0
    for arch in (WIDE_LEGOS[0], WIDE_LEGOS[2]):
        d, img_f32 = frames[arch]
        q8, text, c = wide_cli_frame(["--weights", str(d), "--impl", "int8"], root / "q.ppm")
        int8_launched += c["fused_int8_mlp_wide"]
        with plain_int8():
            plain, _, _ = wide_cli_frame(["--weights", str(d), "--impl", "int8"],
                                         root / "qp.ppm")
        q8_db, plain_db = psnr(q8, img_f32), psnr(plain, q8)
        ok = (INT8_NOTE not in text and q8_db > INT8_VS_F32_BAR_DB and plain_db >= PLAIN_BAR_DB
              and c["fused_int8_mlp"] == c["fused_int8_mlp_wide"] == 2 * chunks
              and c["fused_nerf_mlp"] == 0)
        say("29 wide", f"render --impl int8 of the lego widened to {arch}: note printed: "
            f"{INT8_NOTE in text}; vs the plain int8 frame {plain_db:.2f} dB (bar >= "
            f"{PLAIN_BAR_DB}), vs its f32 frame {q8_db:.2f} dB (bar > {INT8_VS_F32_BAR_DB}); "
            f"int8 launches {c['fused_int8_mlp']}, wide {c['fused_int8_mlp_wide']} (expected "
            f"{2 * chunks}), K1 {c['fused_nerf_mlp']} (expected 0) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"--impl int8 at {arch} printed the note, missed a bar or went "
                               "around the wide int8 kernel")

    # (e) Past width 512: K1's wide1k pair.
    wide1k_entries = run_wide1k(root, cam, dev, card, assets, pts_c, pts_f, vd, golden, chunks)

    # (f) Past width 512: K2's wide1k kernels.
    wide1k_entries += run_wide1k_k2(root, dev, card, assets, bwd_in, chunks)

    # (g) Times, not counted: K1 and the plain version and the library
    # call at the render's shapes, bounds, frames.
    saved = save_counts()
    times = {}
    for arch, pts, so in ((WIDE_RANDOM[1], pts_f, False), (WIDE_RANDOM[1], pts_c, True),
                          (WIDE_RANDOM[0], pts_f, False)):
        net = nets[arch]
        for dtype in ("float32", "bfloat16"):
            with torch.no_grad():
                k_ms = timed_ms(lambda: fused_nerf_mlp(net, pts, vd, dtype=dtype, sigma_only=so))
                p_ms = timed_ms(lambda: fused_nerf_mlp_reference(net, pts, vd, dtype=dtype,
                                                                 sigma_only=so))
                lib_ms = library_mlp_ms(net, pts, vd, dtype, so)
            n = pts.numel() // 3
            w_bytes = 4 if dtype == "float32" else 2
            flops = mlp_flops(net, so) * n
            peak = F32_FLOP_S if dtype == "float32" else BF16_FLOP_S
            bnd = bound(4 * (n * 7 + vd.numel()) + w_bytes * sum(
                int(p.numel()) for p in net.parameters()), flops, peak)
            times[(arch, so, dtype)] = (k_ms, p_ms, bnd, lib_ms)
            say("29 times", f"{card}: K1 {dtype} at {arch[:3]}, {tuple(pts.shape[:-1])} "
                f"{'sigma-only' if so else 'full'} ({flops / n / 1e6:.3f} MFLOP a sample): "
                f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library (models.mlp.nerf_mlp, "
                f"{dtype}) {lib_ms:.3f} ms; bound {bnd[0]:.3f} ms ({bnd[1]}, at "
                f"{peak / 1e12:g} TFLOP/s), {bnd[0] / k_ms:.1%} of it (median of 3)")
    frame_ms = {dtype: timed_ms(lambda: render(wide["coarse"], wide["fine"], cam, dev, "pallas",
                                               dtype))
                for dtype in ("float32", "bfloat16")}
    frame_ms["int8"] = timed_ms(lambda: render(wide["coarse"], wide["fine"], cam, dev, "int8",
                                               "float32"))
    with plain_int8():
        frame_ms["plain int8"] = timed_ms(lambda: render(wide["coarse"], wide["fine"], cam, dev,
                                                         "int8", "float32"))
    accel_ms = timed_ms(lambda: render_accel(wide["coarse"], wide["fine"], cam, dev, cfg, grid,
                                             BENCH_SIZE))
    # Wide K2 at the training path's fine inputs on the lego widened to
    # 512/256/8: parameter gradients, as the training path asks.
    k2_net, k2_args = bwd_nets[(512, 256, 8, "fine")], bwd_in["fine"][1:]
    k2_times, k2_scratch = {}, {}
    for dtype in ("float32", "bfloat16"):
        k_ms = timed_ms(lambda: fused_nerf_mlp_backward(k2_net, *k2_args, dtype=dtype,
                                                        input_grads=False))
        p_ms = timed_ms(lambda: fused_nerf_mlp_backward_reference(k2_net, *k2_args, dtype=dtype,
                                                                  input_grads=False))
        lib_ms = library_backward_ms(k2_net, *k2_args, dtype=dtype)
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fused_nerf_mlp_backward(k2_net, *k2_args, dtype=dtype, input_grads=False)
        torch.cuda.synchronize()
        k2_scratch[dtype] = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
        k2_times[dtype] = (k_ms, p_ms, lib_ms)
    # The f32 call's record pass (the wide f32 forward in record mode):
    # its share of one call's device time, under torch.profiler.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused_nerf_mlp_backward(k2_net, *k2_args, dtype="float32", input_grads=False)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    k2_busy = sum(e.device_time_total for e in events) / 1e3
    record_ms = sum(e.device_time_total for e in events
                    if "fused_mlp_wide_f32_kernel<false, true>" in e.key) / 1e3
    say("29 times", f"{card}: wide K2 f32's record pass (fused_mlp_wide_f32_kernel in record "
        f"mode): {record_ms:.3f} ms of the call's {k2_busy:.3f} ms device time "
        f"({record_ms / max(k2_busy, 1e-9):.1%}), one call under torch.profiler")
    if record_ms <= 0:
        raise PhaseFailure("the profiled wide K2 f32 call shows no record pass on the device")
    k2_bnd = backward_bounds(k2_net, *k2_args)
    k2_bnd = {"float32": k2_bnd["wide_float32"], "bfloat16": k2_bnd["bfloat16"],
              "cuda_cores": k2_bnd["cuda_cores"]}
    for dtype in ("float32", "bfloat16"):
        k_ms, p_ms, lib_ms = k2_times[dtype]
        route = ("the recompute on the CUDA cores, W dz 3xTF32, dW split-f32"
                 if dtype == "float32" else "bf16")
        say("29 times", f"{card}: wide K2 {dtype} on the lego widened to 512/256/8, "
            f"{tuple(k2_args[0].shape[:-1])} fine, parameter gradients: kernel {k_ms:.3f} ms, "
            f"plain {p_ms:.3f} ms, library (autograd through models.mlp.nerf_mlp, {dtype}) "
            f"{lib_ms:.3f} ms; bound {k2_bnd[dtype][0]:.3f} ms ({k2_bnd[dtype][1]}; {route}), "
            f"{k2_bnd[dtype][0] / k_ms:.1%} of it; all on the CUDA cores "
            f"{k2_bnd['cuda_cores'][0]:.3f} ms; peak scratch {k2_scratch[dtype]:.3f} GiB "
            "(medians of 3)")
    restore_counts(saved)
    say("29 times", f"{card}: the lego widened to 512/256/8, {W}x{H} {N_COARSE}+{N_FINE} frame "
        f"f32 {frame_ms['float32']:.1f} ms, bf16 {frame_ms['bfloat16']:.1f} ms, int8 (wide int8 "
        f"kernel) {frame_ms['int8']:.1f} ms, int8 plain {frame_ms['plain int8']:.1f} ms; "
        f"{BENCH_SIZE}x{BENCH_SIZE} bf16 accel+K3 frame {accel_ms:.1f} ms (first runs: dense "
        f"{dense_ms:.0f}, accel {fast_ms:.0f}); medians of 3; phase 29 took "
        f"{time.perf_counter() - t_phase:.1f} s")

    f32_ms, f32_plain, f32_bnd, f32_lib = times[(WIDE_RANDOM[1], False, "float32")]
    b_ms, b_plain, b_bnd, b_lib = times[(WIDE_RANDOM[1], False, "bfloat16")]
    csrc = "nerf_rs_tpu_torch/ops/kernels/csrc"
    replaces = "nerf_rs_tpu/ops/kernels/fused_mlp.py:779"
    return [
        {"name": "fused_nerf_mlp_wide", "route": "cuda",
         "source": f"{csrc}/fused_mlp_wide_f32.cu",
         "replaces": replaces, "launches": launched["float32"], "max_abs_err": errs["float32"],
         "ms": f32_ms, "plain_ms": f32_plain, "bound_ms": f32_bnd[0], "bound_by": f32_bnd[1],
         "library_ms": f32_lib, "shapes": wide_shapes(times, "float32")},
        {"name": "fused_nerf_mlp_wide_bf16", "route": "cuda",
         "source": f"{csrc}/fused_mlp_wide_tc.cu",
         "sources": [f"{csrc}/{name}" for name in ("fused_mlp_wide_tc.cu", "fused_mlp_wide_tc.cuh",
                                                   "fused_mlp_cluster.cuh")],
         "replaces": replaces, "launches": launched["bfloat16"], "max_abs_err": errs["bfloat16"],
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bnd[0], "bound_by": b_bnd[1],
         "library_ms": b_lib, "shapes": wide_shapes(times, "bfloat16")},
        *({"name": "fused_nerf_mlp_backward_wide" + ("_bf16" if dtype == "bfloat16" else ""),
           "route": "cuda", "source": f"{csrc}/{source}",
           "sources": [f"{csrc}/{name}" for name in (*extra_sources, source,
                                                       "fused_mlp_wide_dw.cu",
                                                       "fused_mlp_wide_dw.cuh")],
           "replaces": "nerf_rs_tpu/ops/kernels/fused_mlp.py:663",
           "launches": launched[f"k2_{dtype}"], "dw_launches": launched[f"dw_{dtype}"],
           "max_abs_err": bwd_errs[dtype],
           "ms": k2_times[dtype][0], "plain_ms": k2_times[dtype][1],
           "bound_ms": k2_bnd[dtype][0], "bound_by": k2_bnd[dtype][1],
           "library_ms": k2_times[dtype][2], "bound_ms_cuda_cores": k2_bnd["cuda_cores"][0],
           "peak_scratch_gib": k2_scratch[dtype],
           **({"record_ms": record_ms} if dtype == "float32" else {})}
          for dtype, source, extra_sources in (
              ("float32", "fused_mlp_wide_bwd_tc.cu", ("fused_mlp_wide_f32.cu",
                                                       "fused_mlp_bwd_tc.cuh")),
              ("bfloat16", "fused_mlp_wide_bwd_bf16.cu", ("fused_mlp_wide_tc.cuh",)))),
        *wide1k_entries,
    ], int8_launched


def k1_vs_plain(net, pts, vd, dtype: str, sigma_only: bool):
    """K1 against its plain version on the same inputs, two kernel calls
    (bitwise equal), f32 at TOLERANCES, bf16 rgb at its bar and sigma by
    ``bf16_sigma_agrees`` -> (ok, max |kernel - plain| over rgb and sigma,
    a line of what was seen, the kernel's K1 launches and wide1k launches)."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        bf16_sigma_agrees,
        fused_nerf_mlp,
        fused_nerf_mlp_reference,
    )

    before = fused_nerf_mlp.launches, fused_nerf_mlp.wide1k_launches
    with torch.no_grad():
        k = fused_nerf_mlp(net, pts, vd, dtype=dtype, sigma_only=sigma_only)
        k2 = fused_nerf_mlp(net, pts, vd, dtype=dtype, sigma_only=sigma_only)
        launched = (fused_nerf_mlp.launches - before[0], fused_nerf_mlp.wide1k_launches - before[1])
        p = fused_nerf_mlp_reference(net, pts, vd, dtype=dtype, sigma_only=sigma_only)
    torch.cuda.synchronize()
    rerun = all(torch.equal(a, b) for a, b in zip(k, k2))
    tol = TOLERANCES[dtype]
    rgb_err = float((k[0] - p[0]).abs().max())
    sig_err = float((k[1] - p[1]).abs().max())
    if dtype == "float32":
        sig_ok = bool(torch.allclose(k[1], p[1], atol=tol["sigma_atol"], rtol=tol["sigma_rtol"]))
        witness = ""
    else:
        with torch.no_grad():
            exact = fused_nerf_mlp_reference(net, pts.double(), vd.double(), dtype=dtype,
                                             sigma_only=sigma_only)[1]
        sig_ok, counts = bf16_sigma_agrees(k[1], p[1], exact)
        witness = (f", sigma outside the bars: kernel vs plain {counts['kernel_vs_plain']}, vs "
                   f"float64 kernel {counts['kernel_vs_exact']}, plain {counts['plain_vs_exact']}")
    finite = all(bool(torch.isfinite(t).all()) for t in k)
    ok = rerun and sig_ok and finite and rgb_err <= tol["rgb_atol"]
    line = (f"max |rgb - plain| {rgb_err:.3g} (bar {tol['rgb_atol']}), max |sigma - plain| "
            f"{sig_err:.3g}{witness}; reruns bitwise {rerun}")
    return ok, max(rgb_err, sig_err), line, launched


def run_wide1k(root: Path, cam, dev, card, assets: Path, pts_c, pts_f, vd, golden, chunks: int):
    """Phase 29 (e): K1 past width 512 on its main paths, each run with the
    counts set to 0 just before and read just after: the lego widened to
    WIDE1K_LEGO through `render --weights` (f32 against the golden and the
    plain frame, bf16 against f32), its bf16 grid and accel+K3 frame, one
    served frame; then the wide1k pair against the plain version on the
    random networks and the widened lego (not counted), and times at
    1024/512/8. -> the two kernels' entries of the kernels line."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from nerf_rs_tpu_torch import api, serve
    from nerf_rs_tpu_torch.accel import build_scene_grid
    from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
    from nerf_rs_tpu_torch.io.image import pixels_to_rgba
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp, fused_nerf_mlp_reference
    from nerf_rs_tpu_torch.render import render_image

    t_step = time.perf_counter()
    launched = {"float32": 0, "bfloat16": 0}           # wide1k launches of the main-path runs
    d = write_wide_lego(root, assets, *WIDE1K_LEGO)
    t0 = time.perf_counter()
    img, text, c = wide_cli_frame(["--weights", str(d), "--impl", "pallas"], root / "k1k.ppm")
    f32_ms = (time.perf_counter() - t0) * 1e3
    launched["float32"] += c["fused_nerf_mlp_wide1k"]
    plain, _, _ = wide_cli_frame(["--weights", str(d), "--impl", "xla"], root / "p1k.ppm")
    golden_db, plain_db = psnr(img, golden), psnr(plain, img)
    ok = (golden_db > GOLDEN_BAR_DB and plain_db >= PLAIN_BAR_DB and FRONT_NOTE not in text
          and c["fused_nerf_mlp"] == c["fused_nerf_mlp_wide1k"] == c["fused_nerf_mlp_tc"]
          == 2 * chunks)
    say("29 wide1k", f"lego widened to {WIDE1K_LEGO}: render --impl pallas {W}x{H} f32 vs golden "
        f"{golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}), vs --impl xla {plain_db:.2f} dB (bar >= "
        f"{PLAIN_BAR_DB}); note printed: {FRONT_NOTE in text}; K1 launches "
        f"{c['fused_nerf_mlp']}, wide1k {c['fused_nerf_mlp_wide1k']}, on the tensor cores "
        f"{c['fused_nerf_mlp_tc']} (expected {2 * chunks}); {f32_ms:.0f} ms through the CLI -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure(f"the lego widened to {WIDE1K_LEGO} misses its bars or went around "
                           "the wide1k split-f32 kernel")
    img16, text, c = wide_cli_frame(["--weights", str(d), "--dtype", "bfloat16"],
                                    root / "b1k.ppm")
    launched["bfloat16"] += c["fused_nerf_mlp_wide1k"]
    bf16_db = psnr(img16, img)
    ok = (bf16_db >= BF16_FRAME_BAR_DB and FRONT_NOTE not in text
          and c["fused_nerf_mlp"] == c["fused_nerf_mlp_wide1k"] == c["fused_nerf_mlp_tc"]
          == 2 * chunks)
    say("29 wide1k", f"width 1024 bf16 frame vs f32 frame {bf16_db:.2f} dB (bar >= "
        f"{BF16_FRAME_BAR_DB}); note printed: {FRONT_NOTE in text}; K1 launches "
        f"{c['fused_nerf_mlp']}, wide1k {c['fused_nerf_mlp_wide1k']}, on the tensor cores "
        f"{c['fused_nerf_mlp_tc']} (expected {2 * chunks}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the width-1024 bf16 frame misses its bar or went around the wide1k "
                           "bf16 kernel")

    # The bf16 grid and accel+K3 frame against the dense bf16 frame.
    wide = {net: NerfMLP(load_nerf_params(d / net), device=dev) for net in ("coarse", "fine")}
    zero_counts()
    grid = build_scene_grid(wide["coarse"], wide["fine"], resolution=GRID_RES)
    torch.cuda.synchronize()
    c_grid = read_counts()
    cfg = accel_cfg(dtype="bfloat16")
    _, n_rendered = rendered_chunks(grid, cam, WIDE1K_FRAME, cfg, dev)
    zero_counts()
    fast, fast_ms = render_accel(wide["coarse"], wide["fine"], cam, dev, cfg, grid, WIDE1K_FRAME)
    c_fast = read_counts()
    dense, dense_ms = render(wide["coarse"], wide["fine"], cam, dev, "pallas", "bfloat16",
                             WIDE1K_FRAME)
    launched["bfloat16"] += c_grid["fused_nerf_mlp_wide1k"] + c_fast["fused_nerf_mlp_wide1k"]
    accel_db = psnr(fast.cpu().numpy(), dense)
    sweeps = 2 * -(-GRID_RES ** 3 // (1 << 18))       # accel.build_scene_grid's chunk
    ok = (accel_db >= ACCEL_BAR_DB
          and c_grid["fused_nerf_mlp_wide1k"] == c_grid["fused_nerf_mlp"] == sweeps
          and c_fast["fused_nerf_mlp_wide1k"] == c_fast["fused_nerf_mlp_tc"] == 2 * n_rendered
          and c_fast["fused_resample"] == n_rendered)
    say("29 wide1k", f"width 1024 bf16 accel frame {WIDE1K_FRAME}x{WIDE1K_FRAME} (grid "
        f"{GRID_RES}^3 through the wide1k bf16 kernel sigma-only: {c_grid['fused_nerf_mlp_wide1k']}"
        f" launches (expected {sweeps}), {float(grid.occ.float().mean()):.4f} occupied; "
        f"{PROBES} probes, stride {STRIDE}, packing, K3) vs the dense bf16 frame {accel_db:.2f} "
        f"dB (bar >= {ACCEL_BAR_DB}); {n_rendered} chunks rendered, wide1k launches "
        f"{c_fast['fused_nerf_mlp_wide1k']} (expected {2 * n_rendered}), K3 "
        f"{c_fast['fused_resample']}; first runs: accel {fast_ms:.0f} ms, dense {dense_ms:.0f} "
        f"ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the width-1024 accel frame misses its bar or went around the wide1k "
                           "kernel")

    # One /render request through serve.Handler, bf16 (init_renderer on the
    # widened weights), byte for byte the render it stands for.
    api._state.clear()
    api.init_renderer(str(d), cfg=RenderConfig(ray_chunk=BENCH_CHUNK, impl="pallas",
                                               dtype="bfloat16"), device=dev, checkpoint=None)
    state = dict(api._state)
    zero_counts()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/render?width={W}&height={H}&seed=0",
            timeout=300).read()
    finally:
        srv.shutdown()
        srv.server_close()
        api._state.clear()
    c_serve = read_counts()
    launched["bfloat16"] += c_serve["fused_nerf_mlp_wide1k"]
    saved = save_counts()
    want = pixels_to_rgba(render_image(state["params"]["coarse"], state["params"]["fine"],
                                       state["camera"], H, W, random.key(0, dev), state["cfg"],
                                       device=dev, grid=state["grid"]))
    restore_counts(saved)
    served = body == want.tobytes()
    serve_chunks = -(-H * W // BENCH_CHUNK)
    ok = (served and state["cfg"].impl == "pallas"
          and c_serve["fused_nerf_mlp_wide1k"] == c_serve["fused_nerf_mlp_tc"] == 2 * serve_chunks)
    say("29 wide1k", f"serve (init_renderer on the width-1024 weights, bf16) impl "
        f"{state['cfg'].impl}, one /render {W}x{H} byte for byte pixels_to_rgba(render_image(...)):"
        f" {served}; wide1k launches {c_serve['fused_nerf_mlp_wide1k']} (expected "
        f"{2 * serve_chunks}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the width-1024 served frame disagrees or went around the wide1k kernel")

    # The pair against the plain version at the render's shapes, not
    # counted: the random networks and the widened lego (coarse sigma-only,
    # fine full, as the render pairs them).
    saved = save_counts()
    errs = {"float32": 0.0, "bfloat16": 0.0}
    nets = {}
    for arch in WIDE1K_RANDOM:
        g = torch.Generator(device=dev).manual_seed(29)
        nets[arch] = NerfMLP(init_nerf_params(g, ArchConfig(*arch)), device=dev)
    cases = [(arch, nets[arch], pts, so) for arch in WIDE1K_RANDOM
             for pts, so in ((pts_c, True), (pts_f, False))]
    cases += [(f"lego {name} {WIDE1K_LEGO}", wide[name], pts, so)
              for name, pts, so in (("coarse", pts_c, True), ("fine", pts_f, False))]
    for label, net, pts, so in cases:
        for dtype in ("float32", "bfloat16"):
            ok, err, line, (k1, w1k) = k1_vs_plain(net, pts, vd, dtype, so)
            ok = ok and k1 == w1k == 2
            errs[dtype] = max(errs[dtype], err)
            say("29 wide1k", f"K1 {dtype} at {label}, {tuple(pts.shape[:-1])} "
                f"{'sigma-only' if so else 'full'}: {line}; wide1k launches {w1k} of {k1} "
                f"(expected 2) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseFailure(f"K1 {dtype} at {label} disagrees with its plain version or "
                                   "went around the wide1k kernel")

    # Times at 1024/512/8, not counted: the kernel and the library call
    # (models.mlp.nerf_mlp in the same dtype) in turns, medians of 3 with
    # their ranges; the plain version on its own, median of 3; the bound
    # through the kernel's route (f32: six bf16 passes a product).
    times = {}
    net = nets[WIDE1K_RANDOM[0]]
    n_w = sum(int(p.numel()) for p in net.parameters())
    for pts, so in ((pts_f, False), (pts_c, True)):
        n = pts.numel() // 3
        flops = mlp_flops(net, so) * n
        io = 4 * (n * 7 + vd.numel())
        for dtype in ("float32", "bfloat16"):
            with torch.no_grad():
                got = turns({"kernel": lambda: fused_nerf_mlp(net, pts, vd, dtype=dtype,
                                                              sigma_only=so),
                             "library": library_mlp_call(net, pts, vd, dtype, so)})
                p_ms = timed_ms(lambda: fused_nerf_mlp_reference(net, pts, vd, dtype=dtype,
                                                                 sigma_only=so))
            (k_ms, k_lo, k_hi), (lib_ms, lib_lo, lib_hi) = got["kernel"], got["library"]
            if dtype == "float32":
                bnd = bound(io + 4 * n_w, SPLIT_F32_PASSES * flops, BF16_FLOP_S)
                route = f"{SPLIT_F32_PASSES} bf16 passes at {BF16_FLOP_S / 1e12:g} TFLOP/s"
            else:
                bnd = bound(io + 2 * n_w, flops, BF16_FLOP_S)
                route = f"at {BF16_FLOP_S / 1e12:g} TFLOP/s"
            times[(WIDE1K_RANDOM[0], so, dtype)] = (k_ms, p_ms, bnd, lib_ms)
            apart = k_hi < lib_lo or lib_hi < k_lo
            say("29 times", f"{card}: wide1k K1 {dtype} at {WIDE1K_RANDOM[0][:3]}, "
                f"{tuple(pts.shape[:-1])} {'sigma-only' if so else 'full'} "
                f"({flops / n / 1e6:.3f} MFLOP a sample), in turns (medians of 3, ranges): kernel "
                f"{k_ms:.3f} ms ({k_lo:.3f}-{k_hi:.3f}), library (models.mlp.nerf_mlp, {dtype}) "
                f"{lib_ms:.3f} ms ({lib_lo:.3f}-{lib_hi:.3f}): the kernel "
                f"{lib_ms / k_ms:.3f}x the library's speed, the ranges "
                f"{'apart' if apart else 'overlapping'}; plain {p_ms:.3f} ms (median of 3); "
                f"bound {bnd[0]:.3f} ms ({bnd[1]}, {route}), {bnd[0] / k_ms:.1%} of it")
    restore_counts(saved)
    say("29 wide1k", f"step (e) took {time.perf_counter() - t_step:.1f} s")

    csrc = "nerf_rs_tpu_torch/ops/kernels/csrc"
    entries = []
    for dtype, name, source, extra in (
            ("float32", "fused_nerf_mlp_wide1k", "fused_mlp_wide1k_f32tc.cu",
             ("fused_mlp_f32tc.cuh", "fused_mlp_wide_tc.cuh", "fused_mlp_cluster.cuh")),
            ("bfloat16", "fused_nerf_mlp_wide1k_bf16", "fused_mlp_wide1k_tc.cu",
             ("fused_mlp_wide_tc.cuh", "fused_mlp_cluster.cuh"))):
        k_ms, p_ms, bnd, lib_ms = times[(WIDE1K_RANDOM[0], False, dtype)]
        entries.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{source}",
            "sources": [f"{csrc}/{f}" for f in (source, "fused_mlp_wide1k.cuh", *extra)],
            "replaces": "nerf_rs_tpu/ops/kernels/fused_mlp.py:779", "launches": launched[dtype],
            "max_abs_err": errs[dtype], "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib_ms, "shapes": wide_shapes(times, dtype)})
    return entries


# Past width 512 (phase 29 (f)): K2's wide1k kernels on random networks
# (width, v_width, depth, skip_at) beside the lego widened 4x, at the card
# tests' 37 x 29 samples; the one f32 step's student and batch (a float64
# step at 4096 rays needs about 6.4 GB an activation of the fine pass);
# `train --width 1024 --v-width 512`'s steps in f32 and bf16.
WIDE1K_K2_RANDOM = ((1024, 512, 8, 4), (776, 264, 12, 4), (1024, 1024, 32, 10))
WIDE1K_STEP_RAYS = 1024
WIDE1K_TRAIN_STEPS = {"float32": 5, "bfloat16": 3}


def float64_mlp(params, points, viewdirs, sigma_only: bool = False):
    """``models.mlp.nerf_mlp`` in float64 (the one-step check's third step:
    its parameters are float64), as ``render.get_mlp_fn`` hands an MLP to
    ``render_rays``."""
    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    return nerf_mlp(params, points.double(), viewdirs.double(), sigma_only=sigma_only)


def wide1k_step(dev, arch=(1024, 512, 8, 4), rays: int = WIDE1K_STEP_RAYS):
    """Phase 29 (f)'s one f32 step past width 512, from distill_setup's
    random init of ``arch`` and one batch of ``rays`` rays, 64 + 128: the
    plain f32 step (impl="xla") draws the fine samples, and the kernel step
    (impl="pallas") and the plain MLP in float64 (parameters, batch and
    Adam in float64) take the same ones (``render.importance_samples``
    replayed, here only). Bars: the kernel step's loss within 1e-5
    relative of the float64 step's; every parameter within 2 lr of it;
    its share of entries more than 1e-5 from the float64 step at most
    max(the plain step's share, 1e-3). The kernel-vs-plain share is
    reported. -> the kernel step's launch counts."""
    import torch

    from nerf_rs_tpu_torch import render
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.train import train_step

    drawn = []
    real_draw, real_mlp = render.importance_samples, render.get_mlp_fn

    def replay(*args, **kw):
        if not drawn:
            drawn.append(real_draw(*args, **kw))
        return drawn[0]

    results, batch, counts = {}, None, None
    render.importance_samples = replay
    try:
        for kind in ("plain", "pallas", "float64"):
            state, dataset, cfg, key = distill_setup(dev, "pallas" if kind == "pallas" else "xla",
                                                     arch=arch)
            if batch is None:
                batch = next(dataset.batches(rays, seed=cfg.seed))
            b = batch
            if kind == "float64":
                for net in state.params.values():
                    net.to(torch.float64)
                state.mu, state.nu = ({net: {n: torch.zeros_like(w) for n, w in m.weights.items()}
                                       for net, m in state.params.items()} for _ in range(2))
                b = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                     for k, v in batch.items()}
                render.get_mlp_fn = lambda *a, **kw: float64_mlp
            torch.cuda.synchronize()
            zero_counts()
            state, metrics = train_step(state, b, random.fold_in(key, torch.tensor(0)), cfg)
            torch.cuda.synchronize()
            render.get_mlp_fn = real_mlp
            if kind == "pallas":
                counts = read_counts()
            results[kind] = (float(metrics["loss"]), {
                (net, name): w.detach().double() for net, m in state.params.items()
                for name, w in m.weights.items()})
    finally:
        render.importance_samples, render.get_mlp_fn = real_draw, real_mlp
    (loss_k, w_k), (loss_p, w_p), (loss_64, w_64) = (results[k] for k in
                                                     ("pallas", "plain", "float64"))

    def apart(a, b):
        diffs = {k: (a[k] - b[k]).abs() for k in b}
        total = sum(d.numel() for d in diffs.values())
        share = sum(int((d > 1e-5).sum()) for d in diffs.values()) / total
        return max(float(d.max()) for d in diffs.values()), share

    max_k, share_k = apart(w_k, w_64)
    max_p, share_p = apart(w_p, w_64)
    max_kp, share_kp = apart(w_k, w_p)
    loss_rel, loss_rel_p = abs(loss_k - loss_64) / abs(loss_64), abs(loss_p - loss_64) / abs(loss_64)
    lr = cfg.lr_init
    launched = (counts["fused_nerf_mlp_wide1k"] == 2 and counts["fused_nerf_mlp_backward"]
                == counts["fused_nerf_mlp_backward_wide1k"] == 2)
    ok = (loss_rel <= 1e-5 and max_k < 2 * lr and share_k <= max(share_p, 1e-3) and launched
          and len(drawn) == 1)
    say("29 wide1k", f"one f32 step of a {arch[0]}/{arch[1]}/{arch[2]} student, {rays} rays "
        f"{N_COARSE}+{N_FINE} on the same fine samples (the plain step's, replayed): kernels vs "
        f"the float64 step: loss rel {loss_rel:.2e} (bar 1e-5; plain {loss_rel_p:.2e}), params max "
        f"|d| {max_k:.3e} (bar < {2 * lr:g}; plain {max_p:.3e}), share of entries > 1e-5 "
        f"{share_k:.2e} (bar <= max(plain's {share_p:.2e}, 1e-3)); kernels vs plain: max |d| "
        f"{max_kp:.3e}, share {share_kp:.2e} (reported); K1 wide1k launches "
        f"{counts['fused_nerf_mlp_wide1k']}, K2 {counts['fused_nerf_mlp_backward']}, wide1k "
        f"{counts['fused_nerf_mlp_backward_wide1k']} (expected 2 each) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the kernel step past width 512 misses the float64 step's bars or "
                           "went around the wide1k kernels")
    return counts


def run_wide1k_k2(root: Path, dev, card, assets: Path, bwd_in, chunks: int):
    """Phase 29 (f): K2 past width 512 (the wide1k forwards' record modes,
    ``csrc/fused_mlp_wide1k_bwd.cu``, the dW kernel). Against the plain
    version, not counted: WIDE1K_K2_RANDOM and the lego widened to
    WIDE1K_LEGO (fine) on 37 x 29 samples, both dtypes, full and
    sigma-only (f32 against float64 with the kernel's masks; bf16 against
    plain at 3e-2, or on the 32-deep random network against float64,
    random_k2_report); one f32 step against plain and float64
    (wide1k_step); then the main path, counted: ``train --width 1024
    --v-width 512`` in f32 and bf16, its checkpoint rendered through K1;
    times in turns against autograd through ``models.mlp.nerf_mlp`` at the
    training path's inputs. -> the two kernels' entries of the kernels
    line."""
    import numpy as np
    import torch

    from nerf_rs_tpu_torch.io import checkpoint as ckpt_io
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
    )

    t_step = time.perf_counter()
    saved = save_counts()
    errs = {"float32": 0.0, "bfloat16": 0.0}
    lego = {name: NerfMLP(widen_nerf(load_nerf_params(assets / name), *WIDE1K_LEGO), device=dev)
            for name in ("coarse", "fine")}
    cases = []
    for arch in WIDE1K_K2_RANDOM:
        net, args = random_k2_case(arch, dev)
        cases.append((f"random {arch[:3]}", net, args, arch[2] == 32))
    _, args = random_k2_case(WIDE1K_K2_RANDOM[0], dev)
    cases.append((f"lego fine widened to {WIDE1K_LEGO}", lego["fine"],
                   (args[0] * 0.4, *args[1:]), False))
    for label, net, args, deep in cases:
        for dtype in ("float32", "bfloat16"):
            for so in (False, True):
                before = fused_nerf_mlp_backward.wide1k_launches
                if dtype == "bfloat16" and deep:
                    err = random_k2_report(net, args, label, sigma_only=so, phase="29 wide1k")
                else:
                    err = backward_vs_plain("29 wide1k", label, net, args, dtype, sigma_only=so)
                errs[dtype] = max(errs[dtype], err)
                if fused_nerf_mlp_backward.wide1k_launches - before != 2:
                    raise PhaseFailure(f"K2 at {label} went around the wide1k kernels")
    del cases
    restore_counts(saved)
    wide1k_step(dev)

    # The main path: the CLI trains a 1024/512/8 student, f32 and bf16.
    launched = {}
    ck = root / "ck1k"
    outs = {}
    for dtype, steps in WIDE1K_TRAIN_STEPS.items():
        zero_counts()
        argv = ["train", "--width", "1024", "--v-width", "512", "--steps", str(steps),
                "--log-every", "1"]
        if dtype == "float32":
            argv += ["--checkpoint-dir", str(ck)]
        else:
            argv += ["--dtype", "bfloat16"]
        out = cli_run(argv)
        c = read_counts()
        losses = [float(v) for v in re.findall(r"^step \d+: loss ([0-9.e+-]+)", out, flags=re.M)]
        n_k2 = 2 * steps
        ok = (K2_NOTE not in out and FRONT_NOTE not in out and len(losses) == steps
              and all(map(math.isfinite, losses))
              and c["fused_nerf_mlp_backward"] == c["fused_nerf_mlp_backward_wide1k"] == n_k2
              and c["fused_nerf_mlp_wide1k"] == n_k2
              and c["fused_nerf_mlp_backward_bf16"] == (n_k2 if dtype == "bfloat16" else 0)
              and c["fused_nerf_mlp_backward_dw"] >= n_k2)
        say("29 wide1k", f"train --width 1024 --v-width 512 {dtype} --steps {steps}: note "
            f"printed: {K2_NOTE in out or FRONT_NOTE in out}; losses {losses}; K2 launches "
            f"{c['fused_nerf_mlp_backward']}, wide1k {c['fused_nerf_mlp_backward_wide1k']}, bf16 "
            f"{c['fused_nerf_mlp_backward_bf16']}, wide1k K1 {c['fused_nerf_mlp_wide1k']} "
            f"(expected {n_k2} each: the student's two networks a step); the dW kernel "
            f"{c['fused_nerf_mlp_backward_dw']} times (a round a launch) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseFailure(f"the 1024-wide student did not train in {dtype} through the "
                               "wide1k K1 and K2")
        launched[dtype] = (c["fused_nerf_mlp_backward_wide1k"], c["fused_nerf_mlp_backward_dw"])
        outs[dtype] = out
    last = ckpt_io.latest_checkpoint(ck)
    img, text, c = wide_cli_frame(["--checkpoint", str(last)], root / "ck1k.ppm")
    finite = bool(np.isfinite(img).all())
    ok = (last is not None and FRONT_NOTE not in text and finite
          and c["fused_nerf_mlp_wide1k"] == c["fused_nerf_mlp"] == 2 * chunks)
    say("29 wide1k", f"render --checkpoint of the 1024-wide student ({last}): note printed: "
        f"{FRONT_NOTE in text}, frame finite {finite}, wide1k K1 launches "
        f"{c['fused_nerf_mlp_wide1k']} (expected {2 * chunks}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the 1024-wide checkpoint's frame went around the wide1k K1")

    # Times, not counted: at the training path's inputs (fine 4096 x 192
    # full, coarse 4096 x 64 sigma-only) on the lego widened 4x, parameter
    # gradients as the training path asks; the kernel and autograd through
    # models.mlp.nerf_mlp in turns (medians of 3, ranges), the plain version
    # alone; bounds from the shapes; the peak scratch of a call.
    saved = save_counts()
    times, entries = {}, []
    for name, so in (("fine", False), ("coarse", True)):
        args = bwd_in[name][1:]
        net = lego[name]
        n = args[0].numel() // 3
        for dtype in ("float32", "bfloat16"):
            kw = dict(dtype=dtype, sigma_only=so, input_grads=False)
            got = turns({"kernel": lambda: fused_nerf_mlp_backward(net, *args, **kw),
                         "library": library_backward_call(net, *args, dtype=dtype,
                                                          sigma_only=so)})
            p_ms = timed_ms(lambda: fused_nerf_mlp_backward_reference(net, *args, **kw))
            torch.cuda.synchronize()
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fused_nerf_mlp_backward(net, *args, **kw)
            torch.cuda.synchronize()
            scratch = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
            bnd = wide1k_backward_bounds(net, *args, sigma_only=so)
            (k_ms, k_lo, k_hi), (lib_ms, lib_lo, lib_hi) = got["kernel"], got["library"]
            times[(name, dtype)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                        bound=bnd[dtype], route=bnd[f"route_{dtype}"],
                                        scratch=scratch, n=n, so=so)
            apart = k_hi < lib_lo or lib_hi < k_lo
            say("29 times", f"{card}: wide1k K2 {dtype} on the lego widened to {WIDE1K_LEGO}, "
                f"{tuple(args[0].shape[:-1])} {name}{' sigma-only' if so else ''}, parameter "
                f"gradients, in turns (medians of 3, ranges): kernel {k_ms:.3f} ms "
                f"({k_lo:.3f}-{k_hi:.3f}), library (autograd through models.mlp.nerf_mlp, "
                f"{dtype}) {lib_ms:.3f} ms ({lib_lo:.3f}-{lib_hi:.3f}): the kernel "
                f"{lib_ms / k_ms:.3f}x the library's speed, the ranges "
                f"{'apart' if apart else 'overlapping'}; plain {p_ms:.3f} ms (median of 3); bound "
                f"{bnd[dtype][0]:.3f} ms ({bnd[dtype][1]}), {bnd[dtype][0] / k_ms:.1%} of it; "
                f"through the kernels' route {bnd['route_' + dtype][0]:.3f} ms; peak scratch "
                f"{scratch:.3f} GiB")
    restore_counts(saved)
    say("29 wide1k", f"step (f) took {time.perf_counter() - t_step:.1f} s")
    csrc = "nerf_rs_tpu_torch/ops/kernels/csrc"
    for dtype, name, record in (("float32", "fused_nerf_mlp_backward_wide1k",
                                 "fused_mlp_wide1k_f32tc.cu"),
                                ("bfloat16", "fused_nerf_mlp_backward_wide1k_bf16",
                                 "fused_mlp_wide1k_tc.cu")):
        t = times[("fine", dtype)]
        entries.append({
            "name": name, "route": "cuda", "source": f"{csrc}/fused_mlp_wide1k_bwd.cu",
            "sources": [f"{csrc}/{f}" for f in ("fused_mlp_wide1k_bwd.cu", record,
                                                "fused_mlp_wide_dw.cu", "fused_mlp_wide_dw.cuh",
                                                "fused_mlp_bwd_tc.cuh", "fused_mlp_wide1k.cuh")],
            "replaces": "nerf_rs_tpu/ops/kernels/fused_mlp.py:663",
            "launches": launched[dtype][0], "dw_launches": launched[dtype][1],
            "max_abs_err": errs[dtype], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": t["library_ms"],
            "bound_ms_route": t["route"][0], "peak_scratch_gib": t["scratch"],
            "shapes": [{"net": f"lego {net} widened to {list(WIDE1K_LEGO)}", "samples": v["n"],
                        "sigma_only": v["so"], "ms": v["ms"], "plain_ms": v["plain_ms"],
                        "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
                        "library_ms": v["library_ms"], "peak_scratch_gib": v["scratch"]}
                       for (net, dt), v in times.items() if dt == dtype]})
    return entries


def library_backward_call(net, pts, viewdirs, g_rgb, g_sigma, dtype: str = "float32",
                          sigma_only: bool = False):
    """library_backward_ms's call (``sigma_only``: the sigma head alone, as
    the coarse pass runs it), with its inputs and weights already cast."""
    import torch

    from nerf_rs_tpu_torch.models.mlp import nerf_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tree = {layer: {k: v.detach().to(dt).clone().requires_grad_() for k, v in p.items()}
            for layer, p in net.tree().items()}
    skip = ("bottleneck", "viewdirs", "rgb") if sigma_only else ()
    leaves = [t for layer, p in tree.items() if layer not in skip for t in p.values()]
    p, d, gr, gs = (x.to(dt) for x in (pts, viewdirs, g_rgb, g_sigma))

    def run():
        rgb, sigma = nerf_mlp(tree, p, d, sigma_only=sigma_only)
        loss = (sigma * gs.reshape(sigma.shape)).sum()
        if not sigma_only:
            loss = loss + (rgb * gr.reshape(rgb.shape)).sum()
        return torch.autograd.grad(loss, leaves)

    return run


def wide1k_backward_bounds(net, pts, viewdirs, g_rgb, g_sigma, sigma_only: bool) -> dict:
    """K2's bounds past width 512 for one call at these inputs (points,
    dirs and cotangents read once, the weights read and their gradients
    written once), (ms, "bytes" or "operations"): "float32" and
    "route_float32" both the f32 route (the recompute and dW as split-f32,
    six bf16 passes a product at the bf16 peak, W dz as 3xTF32, three tf32
    products at the tf32 peak); "bfloat16" three forwards of bf16
    products at the bf16 peak, "route_bfloat16" with W dz as one tf32
    product at the tf32 peak, as the kernel runs it."""
    n = pts.numel() // 3
    fwd = mlp_flops(net, sigma_only) * n
    io = 4 * (pts.numel() + viewdirs.numel() + g_rgb.numel() + g_sigma.numel())
    n_w = sum(int(p.numel()) for p in net.parameters())

    def at(n_bytes, ms):
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= ms else (ms, "operations")

    f32 = at(io + 8 * n_w, (2 * SPLIT_F32_PASSES * fwd / BF16_FLOP_S + 3 * fwd / TF32_FLOP_S)
             * 1e3)
    return {"float32": f32, "route_float32": f32,
            "bfloat16": at(io + 6 * n_w, 3 * fwd / BF16_FLOP_S * 1e3),
            "route_bfloat16": at(io + 6 * n_w, (2 * fwd / BF16_FLOP_S + fwd / TF32_FLOP_S) * 1e3)}


def turns(fns: dict, reps: int = 3) -> dict:
    """{name: (median, min, max) ms of a call} of the calls in ``fns``,
    each warmed up once, then timed one call at a time in turns, the order
    reversed every round, each call bracketed by device synchronizations."""
    import torch

    for fn in fns.values():
        fn()
    got = {name: [] for name in fns}
    order = list(fns)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            got[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (statistics.median(v), min(v), max(v)) for name, v in got.items()}


def wide_shapes(times, dtype: str):
    return [{"arch": list(arch), "sigma_only": so, "ms": k, "plain_ms": p, "bound_ms": b[0],
             "bound_by": b[1], "library_ms": lib}
            for (arch, so, dt), (k, p, b, lib) in times.items() if dt == dtype]


def main() -> int:
    import torch

    t_run = time.perf_counter()
    name, card = phase_device()
    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
    from nerf_rs_tpu_torch.io.image import load_ppm, save_ppm
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp,
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
        fused_nerf_mlp_reference,
    )

    phase_build()

    dev = torch.device("cuda", 0)
    assets = find_lego_assets()
    if assets is None:
        raise PhaseFailure("lego weights not found (assets/lego_rust)")
    coarse = NerfMLP(load_nerf_params(assets / "coarse"), device=dev)
    fine = NerfMLP(load_nerf_params(assets / "fine"), device=dev)
    cam = camera_from_golden(load_golden(assets / "tf_reference_samples.json"))

    k1_errs, timing_cases, vd = phase_kernel_vs_plain(coarse, fine, cam, dev)

    # One small frame per configuration first, so that the timed frames
    # below pay no first-use costs (allocator growth, library handles).
    frame_kinds = (("pallas", "float32"), ("pallas", "bfloat16"), ("xla", "float32"),
                   ("xla", "bfloat16"))
    for impl, dtype in frame_kinds:
        render(coarse, fine, cam, dev, impl, dtype, size=32)

    n_chunks = -(-H * W // RAY_CHUNK)
    torch.cuda.synchronize()
    zero_counts()
    img_f32, _ = render(coarse, fine, cam, dev, "pallas", "float32")
    f32_counts = read_counts()
    out_dir = Path(tempfile.mkdtemp(prefix="nerf_rs_tpu_torch_smoke_"))
    save_ppm(out_dir / "lego_256x256_64c128f_key0_f32.ppm", img_f32, H, W)
    golden_db = psnr(img_f32, load_ppm(GOLDEN_PPM))
    say("4 frame", f"f32 kernel frame {H}x{W} {N_COARSE}+{N_FINE}: PSNR vs committed golden "
        f"{golden_db:.2f} dB (bar > {GOLDEN_BAR_DB}), {f32_counts['fused_nerf_mlp']} K1 launches "
        f"({f32_counts['fused_nerf_mlp_tc']} on the tensor cores) for {n_chunks} chunks, written "
        f"to {out_dir}")
    if not golden_db > GOLDEN_BAR_DB:
        raise PhaseFailure(f"f32 frame PSNR {golden_db:.2f} dB <= {GOLDEN_BAR_DB}")
    if (f32_counts["fused_nerf_mlp"] != 2 * n_chunks
            or f32_counts["fused_nerf_mlp_tc"] != 2 * n_chunks
            or f32_counts["fused_nerf_mlp_backward"] != 0):
        raise PhaseFailure(f"K1 launches {f32_counts} (expected {2 * n_chunks} K1, every one on "
                           f"the tensor cores, no K2)")

    # The bf16 render path's main run: every K1 launch on the tensor cores.
    torch.cuda.synchronize()
    zero_counts()
    img_bf16, _ = render(coarse, fine, cam, dev, "pallas", "bfloat16")
    bf16_counts = read_counts()
    img_plain_bf16, _ = render(coarse, fine, cam, dev, "xla", "bfloat16")
    bf16_db, plain_bf16_db = psnr(img_bf16, img_f32), psnr(img_plain_bf16, img_bf16)
    ok = (bf16_db >= BF16_FRAME_BAR_DB and bf16_counts["fused_nerf_mlp"] == 2 * n_chunks
          and bf16_counts["fused_nerf_mlp_tc"] == 2 * n_chunks)
    say("5 bf16", f"bf16 kernel frame vs f32 kernel frame: {bf16_db:.2f} dB (bar >= "
        f"{BF16_FRAME_BAR_DB}); K1 launches {bf16_counts['fused_nerf_mlp']}, on the tensor cores "
        f"{bf16_counts['fused_nerf_mlp_tc']} (expected {2 * n_chunks} each); plain bf16 frame vs "
        f"kernel bf16 frame {plain_bf16_db:.2f} dB (reported) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure("the bf16 frame misses its bar or went around the tensor-core K1")

    img_plain, _ = render(coarse, fine, cam, dev, "xla", "float32")
    plain_db = psnr(img_plain, img_f32)
    say("6 plain", f"plain f32 frame vs kernel f32 frame: {plain_db:.2f} dB "
        f"(bar >= {PLAIN_BAR_DB})")
    if not plain_db >= PLAIN_BAR_DB:
        raise PhaseFailure(f"plain frame PSNR {plain_db:.2f} dB < {PLAIN_BAR_DB}")

    times = {}
    saved = save_counts()
    with torch.no_grad():
        for case, dtype, net, pts, sigma_only in timing_cases:
            kw = dict(dtype=dtype, sigma_only=sigma_only)
            k_ms = timed_ms(lambda: fused_nerf_mlp(net, pts, vd, **kw))
            p_ms = timed_ms(lambda: fused_nerf_mlp_reference(net, pts, vd, **kw))
            lib_ms = library_mlp_ms(net, pts, vd, dtype, sigma_only)
            times[(case, dtype)] = (k_ms, p_ms, lib_ms)
            say("7 times", f"{card}: {case} {tuple(pts.shape[:-1])} {dtype}: kernel "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, models.mlp.nerf_mlp in {dtype} (library "
                f"yardstick) {lib_ms:.3f} ms (medians of 3)")
    frame_ms = {kind: timed_ms(lambda: render(coarse, fine, cam, dev, *kind)) for kind in frame_kinds}
    restore_counts(saved)                          # timing launches do not count
    say("7 times", f"{card}: frame {H}x{W} {N_COARSE}+{N_FINE} (medians of 3): " + ", ".join(
        f"{'kernel' if impl == 'pallas' else 'plain'} {dtype} {frame_ms[(impl, dtype)]:.1f} ms"
        for impl, dtype in frame_kinds))
    f32_fine = times[("fine", "float32")]
    f32_pts = next(c[3] for c in timing_cases if c[:2] == ("fine", "float32"))
    f32_bound = mlp_bound(fine, f32_pts, vd, BF16_FLOP_S, 4, passes=SPLIT_F32_PASSES)
    f32_cc_bound = mlp_bound(fine, f32_pts, vd, F32_FLOP_S, 4)
    say("7 times", f"{card}: f32 fine call {f32_fine[0]:.3f} ms: {f32_bound[0] / f32_fine[0]:.1%} "
        f"of its {f32_bound[0]:.3f} ms bound through its route ({f32_bound[1]}; six bf16 passes "
        f"a product at {BF16_FLOP_S / 1e12:g} TFLOP/s), {f32_cc_bound[0] / f32_fine[0]:.1%} of "
        f"the {f32_cc_bound[0]:.3f} ms CUDA-core bound; {f32_fine[0] / f32_fine[2]:.2f}x the "
        f"library yardstick's time")
    bf16_fine = times[("fine", "bfloat16")]
    bf16_bound = mlp_bound(fine, next(c[3] for c in timing_cases if c[:2] == ("fine", "bfloat16")),
                           vd, BF16_FLOP_S, 2)
    say("7 times", f"{card}: bf16 fine call {bf16_fine[0]:.3f} ms (target <= {BF16_FINE_TARGET_MS} "
        f"ms: {'met' if bf16_fine[0] <= BF16_FINE_TARGET_MS else 'missed'}), "
        f"{bf16_bound[0] / bf16_fine[0]:.1%} of its {bf16_bound[0]:.3f} ms bound "
        f"({bf16_bound[1]}), {bf16_fine[0] / bf16_fine[2]:.2f}x the library yardstick's time; "
        f"bf16 kernel frame {'faster' if frame_ms[('pallas', 'bfloat16')] < frame_ms[('xla', 'bfloat16')] else 'NOT faster'} "
        f"than the plain bf16 frame")

    # The training path: K2 against its plain version, one step against the
    # plain MLP's step, then the path itself.
    bwd_errs, (net, pts, vd_f, g_rgb, g_sigma) = phase_backward_vs_plain(dev)
    phase_step_vs_plain(dev)
    launches = phase_train(dev)
    bf16_train_counts = phase_train_bf16(dev)

    # K2 as the training path calls it (parameter gradients only) in both
    # modes, its plain version, its library yardstick, its peak scratch;
    # K1 f32 on the same samples, the arithmetic of K2's f32 recompute.
    saved = save_counts()
    k2_ms, lib_bwd_ms = {}, {}
    for dtype in ("float32", "bfloat16"):
        args = (net, pts, vd_f, g_rgb, g_sigma)
        k2_ms[dtype] = (
            timed_ms(lambda: fused_nerf_mlp_backward(*args, dtype=dtype, input_grads=False)),
            timed_ms(lambda: fused_nerf_mlp_backward_reference(*args, dtype=dtype,
                                                               input_grads=False)))
        lib_bwd_ms[dtype] = library_backward_ms(*args, dtype=dtype)
    with torch.no_grad():
        k1_same_ms = timed_ms(lambda: fused_nerf_mlp(net, pts, vd_f))
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_nerf_mlp_backward(net, pts, vd_f, g_rgb, g_sigma, input_grads=False)
    torch.cuda.synchronize()
    scratch_gib = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
    restore_counts(saved)                          # timing launches do not count
    kb_ms, pb_ms = k2_ms["float32"]
    kt2_ms, pt2_ms = k2_ms["bfloat16"]
    say("11 times", f"{card}: K2 fine {tuple(pts.shape[:-1])}, parameter gradients (median of 3): "
        f"float32 kernel {kb_ms:.3f} ms, plain {pb_ms:.3f} ms, library yardstick (autograd "
        f"through models.mlp.nerf_mlp, f32, TF32 off) {lib_bwd_ms['float32']:.3f} ms -> the "
        f"kernel is {'faster' if kb_ms < min(pb_ms, lib_bwd_ms['float32']) else 'NOT faster'} "
        f"than both; bfloat16 kernel {kt2_ms:.3f} ms, plain {pt2_ms:.3f} ms, library yardstick "
        f"(the same in bf16) {lib_bwd_ms['bfloat16']:.3f} ms; peak scratch of a float32 call "
        f"{scratch_gib:.3f} GiB")
    say("11 times", f"{card}: K1 f32 forward on the same samples (K2 f32's recompute runs its "
        f"code) {k1_same_ms:.3f} ms: {k1_same_ms / kb_ms:.1%} of the f32 K2 call; the rest, "
        f"{kb_ms - k1_same_ms:.3f} ms, holds the 3xTF32 dW and W dz products, the heads, the "
        f"workspace and the partials")
    k2_bounds = backward_bounds(net, pts, vd_f, g_rgb, g_sigma)
    say("11 times", f"{card}: K2 bounds from this call's shapes: float32 through its route (the "
        f"recompute as six bf16 passes at {BF16_FLOP_S / 1e12:g} TFLOP/s, dW and W dz as 3xTF32 "
        f"at {TF32_FLOP_S / 1e12:g}) {k2_bounds['float32'][0]:.3f} ms "
        f"({k2_bounds['float32'][1]}), {k2_bounds['float32'][0] / kb_ms:.1%} of it; all on the "
        f"CUDA cores {k2_bounds['cuda_cores'][0]:.3f} ms; bfloat16 "
        f"{k2_bounds['bfloat16'][0]:.3f} ms ({k2_bounds['bfloat16'][1]}), "
        f"{k2_bounds['bfloat16'][0] / kt2_ms:.1%} of it")
    saved = save_counts()
    step_ms = {impl: time_steps(dev, impl) for impl in ("pallas", "xla")}
    restore_counts(saved)
    for impl, label in (("pallas", "kernels"), ("xla", "plain MLP")):
        say("11 times", f"{card}: train step ({label}), {TRAIN_RAYS} rays {N_COARSE}+{N_FINE}, "
            f"f32: {step_ms[impl]:.1f} ms, {TRAIN_RAYS / step_ms[impl] * 1e3:,.0f} rays/s "
            f"fwd+bwd (median of 3, teacher batch excluded)")
    saved = save_counts()
    step_wall, step_busy, step_top = profile_step(dev)
    restore_counts(saved)
    say("11 times", f"{card}: one kernel train step under torch.profiler: {step_wall:.1f} ms wall, "
        f"device busy {step_busy:.1f} ms, idle {1 - step_busy / step_wall:.2%}; top device "
        f"kernels: " + ", ".join(f"{name[:40]} {ms:.1f} ms" for name, ms in step_top))

    # The accelerated render and serving path: K3 against its plain
    # version, the path itself, the bench-size frames, the viewer, times.
    from nerf_rs_tpu_torch.accel import build_scene_grid

    grid = build_scene_grid(coarse, fine, resolution=GRID_RES)
    say("12 resample", f"grid {GRID_RES}^3 built: {float(grid.occ.float().mean()):.4f} of the "
        f"cells occupied")
    k3_err = phase_resample_vs_plain(coarse, cam, dev, grid)
    accel_launches = phase_accel_frame(coarse, fine, cam, dev, grid)
    dense_cfg, bench_cfg, lego_800 = phase_bench_frames(coarse, fine, cam, dev, grid, card)
    phase_serve(dev)
    k3_ms, k3_plain_ms = phase_accel_times(coarse, fine, cam, dev, grid, card, dense_cfg,
                                           bench_cfg)

    # The hash-grid family: the encode kernel against its plain version, the
    # distillation path, the trained field's frames, times.
    hash_err = phase_hash_vs_plain(cam, dev)
    phase_hash_step_vs_plain(dev)
    hstate, hcfg, hash_launches = phase_hash_train(dev)
    field = hstate.params["shared"]
    hgrid, hdense, hacfg = phase_hash_frames(field, hcfg.render.hash, cam, dev, img_f32, lego_800,
                                             card)
    hash_times = phase_hash_times(field, hcfg, cam, dev, hgrid, hdense, hacfg, card)

    # The int8 family: the kernel against its plain version, the
    # post-training int8 frames, QAT distillation, times.
    int8_err, int8_cases, int8_vd = phase_int8_vs_plain(coarse, fine, cam, dev)
    wide_int8_err, wide_int8_cases, wide_int8_vd = phase_wide_int8_vs_plain(cam, dev, assets)
    int8_launches = phase_int8_frames(coarse, fine, cam, dev, img_f32, grid)
    phase_qat(cam, dev, img_f32)
    int8_times = phase_int8_times(int8_cases, int8_vd, cam, dev, card)
    wide_int8_times = phase_wide_int8_times(wide_int8_cases, wide_int8_vd, card)
    del wide_int8_cases

    # Checkpoints, the nerf_synthetic dataset and the CLI's front ends.
    phase_data(coarse, fine, cam, dev, card)

    # Occupancy-culled, placement-aware training and the rest of the front
    # ends.
    phase_culled(coarse, fine, cam, dev, card)

    # The parallel layer: a world of 1 under NCCL.
    phase_sharded(coarse, fine, cam, dev, grid, card)

    # The examples gallery and the vendored networks' serving presets.
    extra = phase_examples(cam, dev, card)

    # K1's wide envelope: networks wider than 256 or deeper than 16.
    wide_entries, wide_int8_launches = phase_wide(cam, dev, card, assets)

    # Bounds from this run's shapes (bytes: each input read once, each
    # output written once; operations at the peak of their type).
    k_ms, p_ms, lib_ms = times[("fine", "float32")]
    kt_ms, pt_ms, libt_ms = times[("fine", "bfloat16")]
    # K3's work a ray, whatever implements it: the weights and CDF (about
    # 10 operations a coarse sample), a bin search a fine sample, and one
    # merge of the two sorted lists (Nc + Nf comparisons).
    k3_bound = bound(4 * BENCH_CHUNK * (3 * N_COARSE + 2 * N_FINE),
                     BENCH_CHUNK * (10 * N_COARSE + N_FINE * math.ceil(math.log2(N_COARSE))
                                    + N_COARSE + N_FINE), F32_FLOP_S)
    h_main = hash_times[(BENCH_CHUNK, N_COARSE + N_FINE, torch.float32)]
    from nerf_rs_tpu_torch.ops.kernels.int8_mlp import pack_int8_params

    _, q_net, q_pts, _ = int8_cases[1]                             # fine, full
    q_n, q_rays = q_pts.numel() // 3, int8_vd.numel() // 3
    q_pk = pack_int8_params(q_net.tree())
    q_bytes = sum(t.numel() * t.element_size() for t in (q_pk.weights, q_pk.epilogue))
    q_bound = bound(4 * (q_n * 7 + q_rays * 3) + q_bytes, mlp_flops(q_net, False) * q_n,
                    INT8_OPS_S)
    q_ms, q_plain_ms, q_lib_ms = int8_times["fine"]

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bnd, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"nerf_rs_tpu_torch/ops/kernels/csrc/{source}",
                "replaces": replaces, "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, **extra}

    say("end", f"{card}: every phase ok in {time.perf_counter() - t_run:.1f} s (the run before the dW "
        f"kernel: {PARTIALS_TOTAL_S} s)")
    print(json.dumps({"kernels": [
        entry("fused_nerf_mlp", "fused_mlp_f32tc.cu", "nerf_rs_tpu/ops/kernels/fused_mlp.py:779",
              launches["fused_nerf_mlp"] + extra["fused_nerf_mlp"], k1_errs["float32"], k_ms,
              p_ms, f32_bound, lib_ms,
              bound_ms_cuda_cores=f32_cc_bound[0]),
        entry("fused_nerf_mlp_bf16", "fused_mlp_tc.cu", "nerf_rs_tpu/ops/kernels/fused_mlp.py:779",
              bf16_counts["fused_nerf_mlp_tc"] + extra["fused_nerf_mlp_bf16"], k1_errs["bfloat16"],
              kt_ms, pt_ms, bf16_bound, libt_ms),
        entry("fused_nerf_mlp_backward", "fused_mlp_bwd_tc.cu",
              "nerf_rs_tpu/ops/kernels/fused_mlp.py:663", launches["fused_nerf_mlp_backward"],
              bwd_errs["float32"], kb_ms, pb_ms, k2_bounds["float32"], lib_bwd_ms["float32"],
              bound_ms_cuda_cores=k2_bounds["cuda_cores"][0]),
        entry("fused_nerf_mlp_backward_bf16", "fused_mlp_bwd_bf16.cu",
              "nerf_rs_tpu/ops/kernels/fused_mlp.py:663",
              bf16_train_counts["fused_nerf_mlp_backward_bf16"], bwd_errs["bfloat16"],
              kt2_ms, pt2_ms, k2_bounds["bfloat16"], lib_bwd_ms["bfloat16"],
              bound_ms_cuda_cores=k2_bounds["cuda_cores"][0]),
        entry("fused_resample", "resample.cu", "nerf_rs_tpu/ops/kernels/resample.py:207",
              accel_launches["fused_resample"], k3_err, k3_ms, k3_plain_ms, k3_bound, None),
        entry("hash_encode", "hash_encode.cu", "tools/pallas_gather_probe.py:81",
              hash_launches["fused_hash_encode"] + extra["hash_encode"], hash_err, h_main["ms"],
              h_main["plain_ms"],
              (h_main["bound_ms"], h_main["bound_by"]), h_main["library_ms"],
              shapes=list(hash_times.values())),
        entry("int8_mlp", "int8_mlp_tc.cu", "tools/pallas_int8_probe.py:66",
              int8_launches["fused_int8_mlp"] + extra["int8_mlp"], int8_err, q_ms, q_plain_ms,
              q_bound, q_lib_ms),
        entry("int8_mlp_wide", "int8_mlp_wide_tc.cu", "tools/pallas_int8_probe.py:66",
              wide_int8_launches, wide_int8_err, *wide_int8_times[((512, 256, 8), False)],
              sources=[f"nerf_rs_tpu_torch/ops/kernels/csrc/{name}"
                       for name in ("int8_mlp_wide_tc.cu", "int8_mlp_tc.cuh")],
              shapes=[{"arch": list(arch), "sigma_only": so, "ms": k, "plain_ms": p,
                       "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
                      for (arch, so), (k, p, b, lib) in wide_int8_times.items()]),
        *wide_entries,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
