"""Smoke run of the PyTorch/CUDA port (``epropnp_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card (an H100: the kernels are built for ``sm_90a``).

It builds the hand-written kernels from ``epropnp_tpu_torch/csrc`` with
``nvcc`` (K1 fused LM solve, K2 fused RSLM init, K3 DCNv2 sampling
contraction; one compiler per source, all started together) and runs
these phases; any failure exits non-zero:

a. K1 (fused LM solve) against its torch twin on the card, at the shapes
   of the main path: (2048, 16) and (32, 4096) in fast Gauss-Newton mode,
   (1024, 512) with the full trust region. Each K1 and K2 row (a, b, b+,
   f, i, l) gives the group size of K1's launch, the time by CUDA events
   over back-to-back calls (``ms``: at small shapes the host's time a
   call), the kernel's own time from the profiler (``device_ms``) and the
   bound's share of ``ms`` (``bound_share``).
b. K2 (fused RSLM init) against its twin at B=1024, N=512: per object
   (the twin replays the kernel's Philox stream), by distribution (median
   init cost within 2x of the twin's) and by the cost consistency of the
   returned pose.
b+. K2 through the legacy layout's entry (``rslm_init`` at N=96 with 16
   points and N=384 with 24: full-set scoring) at dof 6 and 4, B=1024:
   per object against the twin (at dof 4, where the f32 twin misses its
   own f64 run for 1-2% of the objects, against the f64 twin as often as
   the f32 twin meets it), cost consistency, and the init beating the
   ground truth shifted by 1 m.
c. Serving: a full-width CDPN-34 on seeded random weights answers 3
   requests of 32 crops at 256x256 through ``sixdof.test.infer_poses``
   (``init='rslm'``, fused kernels on); each request must launch K1 twice
   (the proposals' solve and the refine). Then one request with the bf16
   backbone (``network.bf16_backbone``, the model ``load_cdpn`` builds),
   its latency beside the f32 requests'.
d. The bench problem (``utils.synthetic.make_problem``, a copy of
   ``bench.make_problem``: 6DoF, B=1024, N=512, RSLM init with 64
   proposals, then 10 trust-region LM iterations) through ``LMSolver``,
   kernel path against twin path.
e. K3 against its twin (and an f64 twin) at the Det serving shapes
   (672x1600 x 6 images): a backbone stage-3 layer at stride 1 and its
   stride-2 first block, a stage-4 layer, FCOS level 0; beside each time
   its share of the bound and one f32 ``torch.matmul`` of the pre-sampled
   (L, 9c) stack (a yardstick the port never calls).
e+. K3's int8 variant (bf16 weight) and bf16 variant at the v1b_serving
   shapes: the stage-3 layer, the stride-2 first block and stage 4, and
   both on the packed FCOS canvas (5 levels, one launch);
   beside each time its share of the bound and the bf16 product of the
   pre-sampled stack.
f. K1 at dof 4 with projection bounds in fast mode (the Det solve) against
   its twin (and an f64 twin) at (98304, 16) x 3, (1536, 128) x 5 and
   (1536, 256) x 5 (the flip-TTA refine).
g. Det serving: EPro-PnP-Det v1b (ResNet-101-DCN, FPN, FCOSEmbHead,
   DeformPnPHead, the 4DoF solve) on seeded random weights answers 3
   requests of 6 camera frames (1600x900, sky-cropped to 1600x672) through
   ``det.api.inference_detector``; each request must launch K3 36 times and
   K1 twice. A 320x800 image runs through the card and through the twins
   on the CPU with the same random draws.
h. Det serving at ``DetConfig.v1b_serving()`` (bf16 backbone and dense
   stage, level-packed towers, int8 DCN sampling) on phase g's weights: 3
   requests of 6 frames, each launching K3-int8 28 times (26 backbone
   DCNs, 2 packed tower DCNs) and K1 twice, a profile by kind, and a
   320x800 card-against-CPU check of the dense outputs; then one request
   with the bf16 DCN sampling (``int8_dcn_gather`` off), 28 K3-bf16
   launches.
i. K1 in the training modes (the trust region with projection bounds,
   with and without the JtJ output) against its twin (and an f64 twin):
   (128, 16) x 3 and (32, 512) x 5 + JtJ at dof 6 (the 6DoF training
   step), (1536, 128) x 10 + JtJ at dof 4 (the Det training solve).
j. 6DoF training: ``sixdof.main.train_loop`` at
   ``SixDoFConfig.epropnp_basic()`` width (CDPN-34, 32 crops of 256x256,
   512 points, AMIS 512 samples in 4 iterations, RMSprop; K1 on) on
   seeded synthetic batches, with the loop's default prefetch (a producer
   thread and pinned copies on a side stream), 10 steps of which the last
   8 are timed; every
   step must launch K1 twice, both in its training modes; then one step
   profiled by kind. Before it (not counted), one step at reduced size
   (ResNet-18, 64x64) on the card and on the CPU with the same draws.
k. ``demo/fit_identity`` reduced (8192 poses, 2 epochs): the loss falls.
l. K2 with projection bounds (dof 4, N=128, 64 x 16 x 3, the Det training
   init) against its twin (and an f64 twin) at B=288 and B=1536: per
   object as phase b+ at dof 4, cost consistency, median within 2x.
m. K3's gradient (``DCNFunction``: the kernel's forward, the
   ``dcn_backward`` torch ops) against torch autograd through the twin (f32
   and f64) at the stage-3 layer, the stride-2 first block and FCOS level
   0 of 6 images at 672x1600; the backward's and forward's times and the
   backward's peak memory. Then with a bf16 map (the stage-3 layer and the
   stride-2 block) and with the level table (the packed FCOS canvas, f32
   and bf16), against the twin's autograd in f32 on the same bf16-rounded
   inputs (8e-3 of the largest entry for a bf16 map, 2.2e-4 in f32; no
   gradient in the canvas' gaps).
n. Det training: ``det.main.train_loop`` at ``DetConfig.v1b()`` width with
   ``use_pallas`` (ResNet-101-DCN, 6 images of 1600x672 a step, AMIS 128,
   RSLM 64x16x3, AdamW; f32, TF32 off) on seeded synthetic batches, 6
   steps of which the last 4 are timed; every step must launch K2 with
   bounds twice, K3-f32 36 times and K1 twice in its training modes, and
   nothing else; then one step profiled by kind. Before it (not counted),
   one reduced step (ResNet-18, 64x64, DCN in the towers) on the card and
   on the CPU in f32 and f64 with the draws replayed.
s. Det training in bf16: path n with the JAX package's training options
   (``bf16_backbone``, ``bf16_dense``, ``level_packed_towers``), then with
   ``remat_dense`` too: 6 steps each (4 timed), every step launching
   K3-bf16 28 times (56 with remat: the dense forward runs again in the
   backward), K2 with bounds twice and K1 twice in its training modes;
   ms a step, images/s, the peaks of step 0 (cuDNN's exhaustive search)
   and of the timed steps, beside path n's. Before it (not counted), the reduced step with the
   same options on the card and on the CPU in bf16, held to an f64 run of
   the same weights with the options off (the card no further from it
   than 3x the CPU's, + 2e-3).
t. 6DoF training in bf16: path j with ``network.bf16_backbone``, then
   with ``network.remat`` too: 10 steps each (8 timed), K1 twice a step;
   ms a step, samples/s and the peak beside path j's; the reduced step
   card against CPU as in s.
o. Det serving from a checkpoint with flip TTA at ``DetConfig.v1b()``:
   phase g's seeded weights written as an mmdet-named ``.pth`` and as a
   flax msgpack file (``utils.convert.det_variables`` and this script's
   ``pack_msgpack``), each loaded by ``det.api.init_detector``; phase g's
   request 1 through either loaded model equals the same request through
   phase g's model bit for bit (the ``.pth`` model at mmcv's modulation
   scale 1.0, which its ``conv_offset`` keys select, against phase g's
   model at that scale). Then 3 TTA requests of 6 frames
   (``inference_detector(tta=True)``), each launching K3 72 times and K1
   twice, a profile by kind, ``det.test.mc_score_and_orient_density`` on
   the last request's problem (K1 once in fast mode and once with its JtJ;
   the yaw density integrates to 1), and a 320x800 TTA request on the card
   against the CPU twins under phase g's rules.
p. 6DoF evaluation: ``sixdof.main.test_loop`` on a full-width CDPN-34
   checkpoint written by ``utils.checkpoint.save_checkpoint`` (seeded
   weights, BatchNorm calibrated), 96 seeded synthetic crops of 256x256 in
   3 batches of 32, first with ``init='epnp_device'`` (K1 once a batch),
   then ``init='rslm'`` (K1 twice a batch); each batch's wall and
   ``PoseEvaluator``'s metrics are printed, and the first batch's model
   outputs go through ``infer_poses`` on the card and on the CPU twins
   (phase c's rule).
   ``init='epnp'`` (host ``cv2.solvePnP``) is not driven: the GPU machine
   has no cv2.
q. Det on a dataset: a nuScenes-format tree written from a seed under
   ``build/`` (``write_det_tree``: 4 train and 2 val keyframes of six
   1600x900 frames rendered by ``det.synthetic``, uint8 ``.npy``, the
   converter's info pickles with objects of all ten classes). Training:
   ``tools.train_det.make_batch_iter`` on ``NuScenes3DDataset`` (the sky
   crop, training flips) into ``det.main.train_loop`` at
   ``DetConfig.v1b()``, batch 6, 4 steps of which the last 2 are timed,
   each launching K2 with bounds twice, K3-f32 36 times and K1 twice in
   its training modes and nothing else; per step the wall, images/s and
   the host's pipeline + collate time, with the loop's default prefetch
   (the pipeline on the producer thread), then synchronously
   (``prefetch=0``) on the same tree. Evaluation: ``init_detector`` on
   the run's ``latest.pt`` (the trained weights bit for bit), then
   ``tools.test_det.evaluate_dataset`` over the 12 val frames in batches
   of 6 with the RSLM samples drawn on the card, plain (K3 36 times and
   K1 twice a batch) and with flip TTA (K3 72 times, K1 twice); per batch
   the read, pipeline and inference times, then the fusion + eval time,
   the metrics (finite NDS, mAP and TP errors) and the 2 sample tokens of
   ``results_nusc.json``. Then the val ground truth as detections through
   ``NuScenes3DDataset.evaluate`` (mAP at least 0.95) and ``kitti_eval``
   on the same boxes through the native ``ops.iou3d`` (every AP 100).
r. 6DoF on a dataset, through the CLIs: a LineMOD-format tree written
   from a seed under ``build/`` by ``sixdof.synthetic`` (class ape, 192
   train and 64 test frames of 640x480, PNG frames by ``utils.image_ops``
   with every row filter type, ``.npy`` coordinate maps,
   ``models/models_info.txt`` and ``obj_01.ply``). Training:
   ``tools.train_6dof.main`` at ``epropnp_basic`` (CDPN-34, batch 32, 2
   epochs of 6 steps), the host pipeline (PNG decoding, denoising, DZI
   crops, collation; no OpenCV) on a background thread ahead of the step;
   each step launches K1 twice in its training modes and nothing else;
   per step the wall, samples/s and the host pipeline's time for the
   batch; the step from a batch already on the card (the end of epoch 0,
   all made in the lead that step 0's build gives the producer) against
   path j's, and the pace once no lead is left (epoch 1's steps that wait
   for the producer). Evaluation: ``tools.test_6dof.main`` on the
   run's ``latest.pt`` over the 64 test frames in batches of 32 with
   ``--init epnp_device`` (K1 once a batch) and ``rslm`` (twice): batch
   walls and finite metrics. Validation:
   ``tools.validate_6dof_synthetic.main`` (64 train and 32 test frames, 2
   epochs, ``epnp_device``) on a tree of its own, its JSON line. Neither
   path imports cv2; the trees are removed at the end.
u. 6DoF data-parallel training (``parallel.mesh``): two processes of this
   script (``--dp-rank``, the torchrun environment set) form a gloo group
   on the one card and run ``sixdof.main.train_loop(data_parallel=True)``
   at path j's width, 32 crops globally (16 a rank) of path j's seeded
   synthetic batches, 6 steps (the last 4 timed), each rank's step
   launching K1 twice in its training modes. After every step both
   ranks' parameters, BatchNorm statistics and ``norm_factor`` are
   bit-identical (state digests); per rank the ms a step and the peaks,
   and from one more step (profiled: the card synchronised around the
   gradient and BatchNorm all-reduces, a barrier before each) their share
   and that of the wait for the other rank. Then the
   world of one (``u one``): in this process, 3 steps of the same loop in
   a group of one over NCCL against two plain runs of the same seed; the
   group's state no further from the first plain run than twice the
   second plain run is.
v. Det data-parallel training: as u at ``DetConfig.v1b()`` (f32,
   R101-DCN, 1600x672) with the published 6 images a rank (12 globally),
   each rank's memory capped at 45% of the card, 4 steps (2 timed), each
   rank's step launching K3-f32 36 times, K2 with bounds twice and K1
   twice; then ``v one`` as ``u one``. Two ranks on one card are no
   data-parallel throughput: the all-reduces go through the host.
w. Det data-parallel evaluation: ``tools.test_det.main --data-parallel``
   on two ranks over path q's 12 val frames from its ``latest.pt``, plain
   and with ``--tta`` (each rank 3 frames of each batch of 6: K3 36 times
   a batch, 72 with TTA); its detections against one single-process run
   per shard with the same seed (rtol/atol 1e-4), NDS and mAP beside path
   q's. It runs before path q's tree is removed.

Every launch counter is set to 0 just before each path that a user's
call drives (b+'s entry calls, c, c's bf16 request, d, g, h, h's bf16
request, j, k, n, s and t with each option set, o, p with each init, q's
training with and without the prefetch, each of its evaluations and its
metrics check, r's training, each evaluation and the validation, and u,
v and w, whose rank processes zero and read their own) and read just
after it. In every path the same
convention holds: the launches of a check of the card against the CPU
twins made inside the path (c, d, g, h, o, p) are taken back out of its
counts (``uncounted``), while a profiled repeat of the path's own call
counts. Each phase's wall time is printed. Earlier lines
print each phase's numbers, the card's ``nvidia-smi`` name and power
limit, and one JSON object with a row per kernel; the last line is
``{"ok": true, "device": {...}}``. The run fails if ptxas reports spill
bytes for an instance of K1, K2 or K3 (an ``lm_solve_kernel``,
``rslm_init_kernel`` or ``dcn_forward`` entry of the build log); it
prints each K1 and K2 instance's registers, block shape and resident
blocks an SM at the main path's shapes, and each K1/K2 row its bound's
share of its time (``bound_share``).

``--only e,e+`` runs just the listed kernel phases (a, b, b+, e, e+, f,
i, l, m, and the card-vs-CPU steps 'j card vs CPU', 'n card vs CPU',
's card vs CPU', 's remat card vs CPU', 't card vs CPU', 't remat card
vs CPU'), not the main run (paths c, d, g, h, j, k, n, s, t, o, p, q, r,
u, v and w), and prints no ``ok`` line. ``--paths 'u,u one,w'`` runs
just the listed paths of the main run (w writes path q's tree itself),
without the kernel phases and without the ``ok`` line. ``--only
a-groups`` times K1 over its group sizes at the main path's shapes (the
measurement behind ``lm_kernel.group_size``); it is not part of the full
run.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# K1 agreement rule: summation order differs between the kernel (warp
# shuffles) and the twin (torch reductions), so a near-tie accept/reject
# or a near-singular step can flip for a few objects; at least 99% of the
# objects must agree on the final cost (rtol 1e-4) and on every pose
# component (|d| <= 1e-4 * (|ref| + 1e-2)).
K1_RTOL, K1_MIN_FRAC = 1e-4, 0.99
# K2: the twin replays the kernel's Philox stream, so both draw the same
# samples; at least 99% of the objects must agree on the init cost at
# rtol 1e-4 (the rest: an argmin flipped by a near-tie of proposal costs
# summed in another order). Beside it the JAX test's distributional rule
# (median init cost within 2x of the twin's) and consistency (returned
# cost == scoring-subsample cost of the returned pose, rtol 1e-3: the
# kernel's pose is renormalised, evaluate_pnp's projection is not).
K2_MEDIAN_RATIO, K2_CONSIST_RTOL = 2.0, 1e-3
# K3: max|kernel - twin| <= 1e-4 * max|twin| (f32 sums of 2304-4608 terms
# in another order; the f64 twin's distance to both is printed beside it).
K3_REL = 1e-4
# K3's bf16 and int8 variants against the twin in the same variant:
# max|k - t| <= 8e-3 max|t| (about two bf16 ulps of the largest entry: the
# combined corner value is rounded to bf16 on both sides and a sum in
# another order may round it the other way). The int8 twin against the
# f32 twin: the JAX budget is 1e-2 max|t| (tests/test_int8_dcn.py:55-57),
# set on maps of 240-1564 samples a channel. The quantizer's step is
# amax / 127 per channel, and on these maps (25k-135k samples a channel)
# the amax stands further out from the bulk of the values: the same
# quantizer (bit-exact with quantize_packed_table) gives 1.05-1.32% of
# max|t| here (H100, PERF.md), so the rule is 1.5e-2 and the ratio is
# printed beside the JAX budget.
K3_VARIANT_REL, K3_INT8_JAX_BUDGET, K3_INT8_BUDGET = 8e-3, 1e-2, 1.5e-2
# Peak rates of one H100 SXM (NVIDIA data sheet): f32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3.
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
PEAK_BF16_FLOPS = 989e12
# f32 operations of one point evaluation in K1/K2 (projection, Huber cost
# and IRLS rescale, Jacobian, JtJ + gradient sums; an FMA counts 2),
# counted from accumulate_point in csrc/pnp_common.cuh; the scoring cost
# of one point (point_cost) is about 40.
K1_POINT_FLOPS = {6: 200, 4: 130}
K2_SCORE_FLOPS = 40
# Det phase: residual-branch scale of the random backbone (see
# build_det_model) and the card-against-CPU rule of the dense outputs,
# max|card - cpu| <= 1e-4 * max|cpu| per output (f32 on both sides).
RESIDUAL_SCALE, DET_DENSE_REL = 0.3, 1e-4
# v1b_serving: card against CPU (both bf16 + int8) at most this many times
# the CPU's own bf16-serving-against-f32 spread, measured in the same run.
SERVING_SPREAD_FACTOR = 2.0
# DCNs per v1b_serving request: 26 backbone (stages 3-4 of ResNet-101)
# and one per FCOS tower on the packed canvas.
SERVING_K3_LAUNCHES = 28
# K1 in the training modes (phase i): the JtJ is compared where the poses
# agree, max|dJtJ| <= K1_JTJ_REL * max|JtJ| per object. Where fewer than
# 99% of the poses meet the twin's, the kernel must meet the f64 twin's
# pose within K1_POSE_F64_MARGIN of the share the f32 twin does: points
# clamped at a bound lose their Jacobian rows and leave flat directions
# in which f32 rounding moves the pose at equal cost (the f32 twin meets
# its f64 pose for 78-82% of the Det-shaped objects, 97-100% at the 6DoF
# shapes: H100 and CPU measurements of make_bounded_pnp_problem, PERF.md).
K1_JTJ_REL, K1_POSE_F64_MARGIN = 1e-4, 0.02
# The reduced training step, card against CPU (f32, TF32 off, the same
# draws): the loss components within TRAIN_LOSS_REL of the CPU's; the
# BatchNorm statistics within TRAIN_STATS_REL; the gradients and the
# updates, by relative L2 distance to the CPU's f64 run, over all leaves
# and for the worst leaf, at most TRAIN_F64_FACTOR times the CPU f32 run's
# distance (+ 1e-5). A per-leaf rule on f32 alone cannot hold: ReLU
# pre-activations within ~1e-6 of 0 change sign under f32 rounding, which
# moves whole gradient rows, and the change reaches every upstream leaf;
# over 3 seeds the CPU's f32 run lies 0.1-2.7% (global) and up to 4% (one
# leaf) from its f64 run, with losses within 4.4e-5 (CPU measurement,
# tiny_train_cfg with 4 crops).
TRAIN_LOSS_REL, TRAIN_STATS_REL, TRAIN_F64_FACTOR = 1e-4, 1e-4, 3.0
# The reduced bf16 steps (paths s and t), card against CPU in bf16: the
# card's distance to an f64 run of the same weights with the options off
# at most TRAIN_F64_FACTOR times the CPU bf16 run's, plus this floor (a
# few bf16 roundings). A bf16 step lies far from f64 on these random
# models: on the CPU, losses 0.05-0.49 (relative, worst term), BatchNorm
# statistics 0.02-0.03, gradients 0.66-0.79 and updates 0.69-1.02
# (relative L2) over 2 seeds of each suite (CPU measurement; rounding of
# the batch statistics' backward dominates, as in the JAX package).
TRAIN_BF16_FLOOR = 2e-3
# Those rules cannot fail on a bf16 step's gradients: a zero gradient lies
# 1.0 from f64, within 3x the CPU's 0.66-0.91. So the reduced bf16 steps
# add a direction rule: in each group of leaves (the backbone, each head;
# the Det's DCN layers, whose gradients K3's backward gives, a group of
# their own), the card's gradient's cosine to the f64 run's at least the
# CPU bf16 run's less TRAIN_BF16_COS_MARGIN, and the pooled distance at
# most TRAIN_F64_FACTOR x the CPU's (+ TRAIN_BF16_FLOOR), over
# TRAIN_BF16_BATCHES batches for the Det step (a batch's cosine moves by
# up to 0.26 between the card and the CPU) and TRAIN_BF16_BATCHES_6DOF
# for the 6DoF step (its batches agree within 0.02, and its CPU runs
# take ~8 s a batch on the card's host); the first batch is the step
# above. The CPU's cosines are 0.54-0.93 a group on an H100's host, the
# card's Det cosines 0.03-0.11 below them, its 6DoF ones within 0.01; a
# zero, negated or unrelated gradient has 0 or less. Three planted faults
# made from the card's gradients (its zeroed group, negated, another
# batch's) must fail it in every run
# (``tests/test_torch_mixed_precision.py::GradYardstick``, the same rule
# with JAX's bf16 step in the CPU's place).
TRAIN_BF16_BATCHES, TRAIN_BF16_BATCHES_6DOF = 10, 4
TRAIN_BF16_COS_MARGIN = 0.2
# A bf16 or f64 step can be non-finite (the pose loss's logsumexp
# backward; the step then skips it, as JAX's does): such a batch is left
# out of the direction rule, and this many must remain.
TRAIN_BF16_MIN_BATCHES = 3
# Training steps of path j, and the K1 launches of each: the init's
# proposals and the main solve with its JtJ.
TRAIN_STEPS, TRAIN_K1_PER_STEP = 10, 2
# nuScenes CAM_FRONT-like intrinsics of a 1600x900 frame
NUSCENES_K = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]]
LINEMOD_K = [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
             [0.0, 0.0, 1.0]]


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_spills(log_text: str, key: str):
    """Spill bytes (stores + loads) that ptxas reports for each kernel
    instance whose entry name holds ``key`` (``dcn_forward``: K3;
    ``lm_solve_kernel``: K1; ``rslm_init_kernel``: K2) in a build log."""
    spills, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name is not None:
            if key in name:
                spills[name] = int(m.group(1)) + int(m.group(2))
            name = None
    return spills


# Phases that run only when ``--only`` names them.
OPT_IN_PHASES = ('a-groups',)
# Instances each kernel must build (name key, count): K1 dof x fast x
# bounds x JtJ, K2 dof x bounds, K3 f32/bf16/int8 forwards.
KERNEL_INSTANCES = {'K1': ('lm_solve_kernel', 16),
                    'K2': ('rslm_init_kernel', 4),
                    'K3': ('dcn_forward', 4)}


def k1_group(b, n):
    """K1's threads an object at (B, N); None for a package without the
    picker (a tree before it, driven by this script for a comparison)."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel
    picker = getattr(lm_kernel, 'group_size', None)
    return None if picker is None else picker(b, n)


def k1k2_occupancy(lib):
    """Registers, block shape and resident blocks an SM of every K1 and K2
    instance at the main path's shapes (the library's occupancy query);
    printed one row each. Empty for a library without the query (a tree
    before it)."""
    import ctypes
    if not hasattr(lib, 'epropnp_lm_occupancy'):
        print('occupancy: this library has no occupancy query')
        return []
    rows = []
    out = (ctypes.c_int * 4)()
    k1 = [  # (dof, fast, bounds, jtj, B, N): phases a, f and i
        (6, 1, 0, 0, 2048, 16), (6, 1, 0, 0, 32, 4096),
        (6, 0, 0, 0, 1024, 512), (4, 1, 1, 0, 98304, 16),
        (4, 1, 1, 0, 1536, 128), (4, 1, 1, 0, 1536, 256),
        (4, 1, 1, 1, 1536, 256), (6, 0, 1, 0, 128, 16),
        (6, 0, 1, 1, 32, 512), (4, 0, 1, 1, 1536, 128)]
    for dof in (4, 6):  # the other instances at the bench shape
        for fast in (0, 1):
            for bnd in (0, 1):
                for jtj in (0, 1):
                    if not any(r[:4] == (dof, fast, bnd, jtj) for r in k1):
                        k1.append((dof, fast, bnd, jtj, 1024, 512))
    for dof, fast, bnd, jtj, b, n in k1:
        g = k1_group(b, n)
        err = lib.epropnp_lm_occupancy(dof, fast, bnd, jtj, n, g, out)
        rows.append(dict(kernel='K1', dof=dof, fast_mode=fast, bounds=bnd,
                         jtj=jtj, B=b, N=n, group=g, err=err,
                         registers=out[0], threads=out[1],
                         dynamic_smem=out[2], blocks_per_sm=out[3]))
    for dof, bnd, n, props, pts in ((6, 0, 512, 64, 16), (4, 1, 128, 64, 16),
                                    (6, 0, 384, 64, 24), (4, 0, 384, 64, 24)):
        err = lib.epropnp_rslm_occupancy(dof, bnd, n, props, pts, out)
        rows.append(dict(kernel='K2', dof=dof, bounds=bnd, N=n,
                         proposals=props, points=pts, err=err,
                         registers=out[0], threads=out[1],
                         dynamic_smem=out[2], blocks_per_sm=out[3]))
    for row in rows:
        print('occupancy: ' + json.dumps(row))
    return rows


def pnp_problem(torch, device, b, n, seed, init_noise):
    """Synthetic 6DoF problem (``bench.make_problem`` at any size) and a
    perturbed ground-truth init: f32 tensors x3d, x2d, w2d, cam4, pose0."""
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_pnp_problem
    p = make_pnp_problem(b, n, seed, init_noise=init_noise)
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in p.items()}
    return (t['x3d'], t['x2d'], t['w2d'],
            camera_to_fxfycxcy(t['cams']).contiguous(), t['pose0'])


def time_ms(torch, fn, warmup=2, iters=10):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(e):
    """Device time (us) of a profiler event, across torch versions."""
    return getattr(e, 'self_device_time_total', None) or getattr(
        e, 'self_cuda_time_total', 0)


def device_ms(torch, fn, key, iters=20):
    """Mean device time (ms) of one launch of the kernels whose name holds
    ``key`` over ``iters`` calls of ``fn`` (``torch.profiler``): the
    kernel's own time, where ``time_ms`` also counts the host's gaps
    between short launches. None where the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if key in e.key and _device_us(e) > 0:
            total += _device_us(e)
            count += e.count
    return total / count / 1e3 if count else None


def bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    """The least time for the work on one H100 (ms) and what bounds it:
    operations at ``peak_flops`` (the f32 peak unless given) or bytes
    (each input read once, each output written once) at the memory
    rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def k1_bound(b, n, dof, evals):
    """K1's bound: ``evals`` point evaluations per object, the points,
    camera, delta and pose read once, pose and cost written once."""
    pose = 4 if dof == 4 else 7
    return bound_ms(K1_POINT_FLOPS[dof] * b * n * evals,
                    b * (28 * n + 4 * (4 + 1 + 2 * pose + 1)))


def profile_once(torch, fn, label, top=6):
    """Profile one call of ``fn`` with ``torch.profiler``: print the wall
    time, the summed device time of its kernels and the top kernels.
    Returns ``([(kernel name, device ms, count), ...], wall ms)``.

    An error of ``fn`` (a failed launch) propagates; only the reading of
    the trace, which is instrumentation, reports a failure instead.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    try:
        events = prof.key_averages()
        dev = _device_us
        # device-side events only: an op's row repeats its kernels' time
        kernels = sorted(
            (e for e in events if dev(e) > 0
             and str(getattr(e, 'device_type', '')).endswith('CUDA')),
            key=dev, reverse=True)
        busy_us = sum(dev(e) for e in kernels)
    except Exception as err:  # noqa: BLE001 - reading the trace only
        print(f'profile {label}: unreadable ({type(err).__name__}: {err})')
        return [], wall * 1e3
    print(f'profile {label}: wall {wall * 1e3:.3f} ms, device busy '
          f'{busy_us / 1e3:.3f} ms ({len(kernels)} kernel names)')
    for e in kernels[:top]:
        print(f'profile {label}:   {dev(e) / 1e3:9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')
    return [(e.key, dev(e) / 1e3, e.count) for e in kernels], wall * 1e3


def agree(a, b, rtol, floor):
    """Per-row: every entry within rtol * (|b| + floor)."""
    ok = np.abs(a - b) <= rtol * (np.abs(b) + floor)
    return ok.reshape(ok.shape[0], -1).all(-1)


def kernel_counters():
    """Each kernel's launch counter: (module, attribute)."""
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.ops.pnp import lm_kernel, rslm_kernel
    return {'K1': (lm_kernel, 'launches'),
            'K1-train': (lm_kernel, 'launches_train'),
            'K2': (rslm_kernel, 'launches'),
            'K2-bounds': (rslm_kernel, 'launches_bounds'),
            'K2-legacy': (rslm_kernel, 'launches_legacy'),
            'K3-f32': (dcn_kernel, 'launches'),
            'K3-bf16': (dcn_kernel, 'launches_bf16'),
            'K3-int8': (dcn_kernel, 'launches_int8')}


def launch_counts():
    return {k: getattr(m, a) for k, (m, a) in kernel_counters().items()}


def uncounted(fn):
    """``fn()`` with every launch counter put back afterwards: launches made
    to hold the card against the CPU twins are not the path's."""
    saved = launch_counts()
    try:
        return fn()
    finally:
        for key, (mod, attr) in kernel_counters().items():
            setattr(mod, attr, saved[key])


def drive(torch, fn):
    """Run one path of the main run with every launch counter set to 0
    just before it; returns the counts read just after it."""
    for m, a in kernel_counters().values():
        setattr(m, a, 0)
    fn()
    torch.cuda.synchronize()
    return launch_counts()


def phase_a(torch, device):
    """K1 against its twin at the main path's shapes."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel as k1
    shapes = [  # (B, N, fast_mode, num_iter, what)
        (2048, 16, True, 3, 'serving RSLM proposals'),
        (32, 4096, True, 3, 'serving refine'),
        (1024, 512, False, 10, 'bench trust-region LM'),
    ]
    rows, max_err = [], 0.0
    for i, (b, n, fast, iters, what) in enumerate(shapes):
        noise = (0.05, 0.1) if fast else (0.3, 0.5)
        x3d, x2d, w2d, cam, pose0 = pnp_problem(torch, device, b, n, 10 + i,
                                                noise)
        delta = torch.full((b,), 10.0 / n, device=device)
        kw = dict(dof=6, num_iter=iters, fast_mode=fast, z_min=0.1)
        run_k = lambda: k1.lm_solve_cuda(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        run_t = lambda: k1.lm_solve_reference(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        pk, ck = run_k()
        pt, ct = run_t()
        torch.cuda.synchronize()
        pk, ck, pt, ct = (t.cpu().numpy() for t in (pk, ck, pt, ct))
        assert np.isfinite(pk).all() and np.isfinite(ck).all(), 'K1 non-finite'
        frac_c = agree(ck, ct, K1_RTOL, 0.0).mean()
        frac_p = agree(pk, pt, K1_RTOL, 1e-2).mean()
        err = float(max(np.abs(pk - pt).max(), np.abs(ck - ct).max()))
        max_err = max(max_err, err)
        ms = time_ms(torch, run_k, iters=20)
        plain_ms = time_ms(torch, run_t, iters=5)
        bound = k1_bound(b, n, 6, iters + (not fast))[0]
        row = dict(B=b, N=n, fast_mode=fast, num_iter=iters, what=what,
                   group=k1_group(b, n),
                   cost_agree=float(frac_c), pose_agree=float(frac_p),
                   max_abs_err=err, ms=ms,
                   device_ms=device_ms(torch, run_k, 'lm_solve_kernel'),
                   plain_ms=plain_ms, bound_ms=bound, bound_share=bound / ms)
        print('phase a: K1 ' + json.dumps(row))
        assert frac_c >= K1_MIN_FRAC and frac_p >= K1_MIN_FRAC, \
            f'K1 disagrees with its twin at {(b, n, fast)}'
        rows.append(row)
    main = rows[-1]
    bound, by = k1_bound(main['B'], main['N'], 6, main['num_iter'] + 1)
    return dict(name='lm_solve (K1)', route='cuda',
                source='epropnp_tpu_torch/csrc/lm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_lm.py:396',
                max_abs_err=max_err, ms=main['ms'],
                device_ms=main['device_ms'], plain_ms=main['plain_ms'],
                bound_ms=bound, bound_by=by, library_ms=None)


def phase_a_groups(torch, device):
    """K1's device time over its group sizes (threads an object) at the
    main path's shapes, beside the size ``lm_kernel.group_size`` picks:
    the measurement behind the picker. Each size's result is held to the
    twin as phase a holds K1."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel as k1
    from epropnp_tpu_torch.utils.synthetic import make_bounded_pnp_problem
    picker = k1.group_size
    shapes = [  # (dof, B, N, num_iter, fast, problem)
        (6, 1024, 512, 10, False, 'bench'),
        (6, 2048, 16, 3, True, 'bench'), (6, 32, 4096, 3, True, 'bench'),
        (4, 98304, 16, 3, True, 'det'), (4, 1536, 128, 5, True, 'det'),
        (4, 1536, 256, 5, True, 'det'), (6, 128, 16, 3, False, 'bounded'), (6, 32, 512, 5, False, 'bounded'),
        (4, 1536, 128, 10, False, 'bounded')]
    try:
        for i, (dof, b, n, iters, fast, kind) in enumerate(shapes):
            kw = dict(dof=dof, num_iter=iters, fast_mode=fast, z_min=0.1)
            if kind == 'bench':
                x3d, x2d, w2d, cam, pose0 = pnp_problem(
                    torch, device, b, n, 10 + i,
                    (0.05, 0.1) if fast else (0.3, 0.5))
                args = (x3d, x2d, w2d, cam,
                        torch.full((b,), 10.0 / n, device=device), pose0)
            elif kind == 'det':
                x3d, x2d, w2d, cam, bounds, pose0 = det_pnp_problem(
                    torch, device, b, n, 60 + n)
                args = (x3d, x2d, w2d, cam,
                        torch.full((b,), 10.0 / n, device=device), pose0)
                kw['bounds'] = bounds
            else:
                p = make_bounded_pnp_problem(b, n, 80 + n, dof, init_noise=(
                    (0.3, 0.5) if n == 16 else (0.05, 0.1)))
                t = {k: torch.tensor(v, dtype=torch.float32, device=device)
                     for k, v in p.items()}
                args = (t['x3d'], t['x2d'], t['w2d'],
                        k1.camera_to_fxfycxcy(t['cams']).contiguous(),
                        t['delta'], t['pose0'])
                kw.update(bounds=t['bounds'], with_jtj=n > 16)
            ct = k1.lm_solve_reference(*args, **kw)[1].cpu().numpy()
            picked, times = picker(b, n), {}
            for g in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
                if not picked // 8 <= g <= picked * 8:
                    continue
                k1.group_size = lambda b_, n_, g=g: g
                run = lambda: k1.lm_solve_cuda(*args, **kw)  # noqa: E731
                ck = run()[1].cpu().numpy()
                times[g] = dict(device_ms=device_ms(torch, run,
                                                    'lm_solve_kernel'),
                                cost_agree=float(agree(ck, ct, K1_RTOL,
                                                       0.0).mean()))
            k1.group_size = picker
            best = min(times, key=lambda g: times[g]['device_ms'])
            print('phase a-groups: K1 ' + json.dumps(dict(
                dof=dof, B=b, N=n, num_iter=iters, fast_mode=fast,
                bounds='bounds' in kw, picked=picked, fastest=best,
                by_group=times)))
    finally:
        k1.group_size = picker


def phase_b(torch, device):
    """K2 against its twin at B=1024, N=512."""
    from epropnp_tpu_torch.ops.pnp import HuberPnPCost, PerspectiveCamera
    from epropnp_tpu_torch.ops.pnp import evaluate_pnp
    from epropnp_tpu_torch.ops.pnp import rslm_kernel as k2
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_problem
    x3d, x2d, w2d, cam, _ = (torch.from_numpy(np.ascontiguousarray(a)).to(
        device) for a in make_problem(seed=1))
    b, n = x3d.shape[:2]
    cam4 = camera_to_fxfycxcy(cam).contiguous()
    delta = torch.full((b,), 10.0 / n, device=device)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(7)
                          ).to(device)
    kw = dict(dof=6, num_points=16, num_proposals=64, num_iter=3,
              z_min=0.1, score_points=128)
    run_k = lambda: k2.rslm_init_cuda(x3d, x2d, w2d, cam4, delta, seeds, **kw)  # noqa: E731,E501
    run_t = lambda: k2.rslm_init_reference(x3d, x2d, w2d, cam4, delta, seeds, **kw)  # noqa: E731,E501
    pk, ck = run_k()
    pt, ct = run_t()
    torch.cuda.synchronize()
    assert torch.isfinite(pk).all() and torch.isfinite(ck).all(), \
        'K2 non-finite'
    stride = n // 128
    camera = PerspectiveCamera(cam_mats=cam, z_min=0.1)
    ev = evaluate_pnp(x3d[:, ::stride], x2d[:, ::stride], w2d[:, ::stride],
                      pk, camera, HuberPnPCost(delta=delta), out_cost=True)
    ck_n, ct_n, ev_n = (t.cpu().numpy() for t in (ck, ct, ev.cost))
    med_k, med_t = float(np.median(ck_n)), float(np.median(ct_n))
    consist = agree(ck_n, ev_n, K2_CONSIST_RTOL, 0.0).mean()
    replay = agree(ck_n, ct_n, K1_RTOL, 0.0).mean()  # same Philox draws
    err = float(np.abs(ck_n - ct_n).max())
    ms = time_ms(torch, run_k, iters=10)
    plain_ms = time_ms(torch, run_t, iters=3)
    props, pts, iters = kw['num_proposals'], kw['num_points'], kw['num_iter']
    flops = b * props * (K1_POINT_FLOPS[6] * pts * (iters + 1)
                         + K2_SCORE_FLOPS * kw['score_points'])
    bound, by = bound_ms(flops, b * (28 * n + 4 * (4 + 1 + 1 + 7 + 1)))
    dev_ms = device_ms(torch, run_k, 'rslm_init_kernel')
    print('phase b: K2 ' + json.dumps(dict(
        B=b, N=n, median_cost=med_k, twin_median_cost=med_t,
        consistency=float(consist), per_object_agree=float(replay),
        max_abs_cost_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, bound_share=bound / ms)))
    assert replay >= K1_MIN_FRAC, 'K2 disagrees with its twin per object'
    assert med_k <= K2_MEDIAN_RATIO * med_t, 'K2 init worse than 2x twin'
    assert consist == 1.0, 'K2 cost is not the cost of its pose'
    return dict(name='rslm_init (K2)', route='cuda',
                source='epropnp_tpu_torch/csrc/rslm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_rslm.py:817',
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


LEGACY_CASES = [  # (N, num_points, dof): 128 % 24 != 0, N % 128 != 0
    (96, 16, 6), (96, 16, 4), (384, 24, 6), (384, 24, 4)]


def legacy_problem(torch, device, b, n, dof, seed):
    """A dof-6 or dof-4 problem at the legacy layout's shapes: f32 tensors
    x3d, x2d, w2d, cam4, delta, seeds, the cameras and the GT pose."""
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_pnp_problem
    p = make_pnp_problem(b, n, seed, dof=dof)
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in p.items()}
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(seed)
                          ).to(device)
    return (t['x3d'], t['x2d'], t['w2d'],
            camera_to_fxfycxcy(t['cams']).contiguous(),
            torch.full((b,), 10.0 / n, device=device), seeds, t['cams'],
            t['pose'])


def legacy_kw(num_points, dof):
    return dict(dof=dof, num_points=num_points, num_proposals=64,
                num_iter=3, z_min=0.1, score_points=128)


def path_legacy_entry(torch, device, b=1024):
    """The legacy layout's entry as a caller drives it: ``rslm_init`` on
    CUDA tensors at each legacy case."""
    from epropnp_tpu_torch.ops.pnp import rslm_kernel
    for i, (n, k, dof) in enumerate(LEGACY_CASES):
        args = legacy_problem(torch, device, b, n, dof, 80 + i)[:6]
        rslm_kernel.rslm_init(*args, **legacy_kw(k, dof))
    torch.cuda.synchronize()


def phase_b_legacy(torch, device, b=1024):
    """K2 through the legacy layout (full-set scoring) at dof 6 and 4."""
    from epropnp_tpu_torch.ops.pnp import HuberPnPCost, PerspectiveCamera
    from epropnp_tpu_torch.ops.pnp import evaluate_pnp
    from epropnp_tpu_torch.ops.pnp import rslm_kernel as k2
    rows = []
    for i, (n, k, dof) in enumerate(LEGACY_CASES):
        x3d, x2d, w2d, cam4, delta, seeds, cams, pose_gt = legacy_problem(
            torch, device, b, n, dof, 80 + i)
        args, kw = (x3d, x2d, w2d, cam4, delta, seeds), legacy_kw(k, dof)
        assert not k2.packed_layout(n, k)
        run_k = lambda: k2.rslm_init_cuda(*args, **kw)  # noqa: E731
        run_t = lambda: k2.rslm_init_reference(*args, **kw)  # noqa: E731
        pk, ck = run_k()
        pt, ct = run_t()
        _, c64 = k2.rslm_init_reference(*(a.double() for a in args[:5]),
                                        seeds, **kw)
        camera = PerspectiveCamera(cam_mats=cams, z_min=0.1)
        cost_fun = HuberPnPCost(delta=delta)
        ev = evaluate_pnp(x3d, x2d, w2d, pk, camera, cost_fun,
                          out_cost=True).cost
        bad = pose_gt.clone()
        bad[:, 0] += 1.0
        ev_bad = evaluate_pnp(x3d, x2d, w2d, bad, camera, cost_fun,
                              out_cost=True).cost
        torch.cuda.synchronize()
        ck_n, ct_n, c64_n, ev_n, bad_n = (t.cpu().numpy()
                                          for t in (ck, ct, c64, ev, ev_bad))
        assert pk.shape == (b, 4 if dof == 4 else 7)
        assert torch.isfinite(pk).all() and np.isfinite(ck_n).all(), \
            'K2 legacy non-finite'
        replay = agree(ck_n, ct_n, K1_RTOL, 0.0).mean()
        # the kernel and the f32 twin against the f64 twin (same draws):
        # at dof 4 the f32 twin itself misses the f64 cost for 1-2% of
        # the objects, so there the kernel is held to the twin's spread
        spread = agree(ct_n, c64_n, K1_RTOL, 0.0).mean()
        kernel64 = agree(ck_n, c64_n, K1_RTOL, 0.0).mean()
        consist = agree(ck_n, ev_n, K2_CONSIST_RTOL, 0.0).mean()
        beats = float((ck_n < bad_n).mean())
        err = float(np.abs(ck_n - ct_n).max())
        ms = time_ms(torch, run_k, iters=10)
        plain_ms = time_ms(torch, run_t, iters=3)
        flops = b * kw['num_proposals'] * (
            K1_POINT_FLOPS[dof] * k * (kw['num_iter'] + 1)
            + K2_SCORE_FLOPS * n)
        pose = 4 if dof == 4 else 7
        bound, by = bound_ms(flops, b * (28 * n + 4 * (4 + 1 + 1 + pose
                                                       + 1)))
        row = dict(B=b, N=n, num_points=k, dof=dof, per_object_agree=float(
            replay), twin_f32_vs_f64_cost_agree=float(spread),
            kernel_vs_f64_cost_agree=float(kernel64),
            consistency=float(consist), beats_gt_plus_1m=beats,
            median_cost=float(np.median(ck_n)), max_abs_cost_err=err,
            ms=ms, device_ms=device_ms(torch, run_k, 'rslm_init_kernel'),
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            bound_share=bound / ms)
        print('phase b+: K2 legacy ' + json.dumps(row))
        assert replay >= K1_MIN_FRAC or kernel64 >= spread - 0.005, \
            'K2 legacy disagrees with its twin'
        assert consist == 1.0, 'K2 legacy cost is not the full-set cost'
        assert beats >= K1_MIN_FRAC, 'K2 legacy init worse than GT + 1 m'
        rows.append(row)
    main = max(rows, key=lambda r: r['N'] * (r['dof'] == 6))
    return dict(name='rslm_init legacy layout (K2)', route='cuda',
                source='epropnp_tpu_torch/csrc/rslm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_rslm.py:931',
                max_abs_err=max(r['max_abs_cost_err'] for r in rows),
                ms=main['ms'], device_ms=main['device_ms'],
                plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=None)


def calibrate_batchnorm(torch, model, inp):
    """Set every BatchNorm's running statistics to those of one batch.

    With random weights and the default statistics (mean 0, var 1) the
    eval-mode activations shrink layer by layer, the dense noc map comes
    out nearly constant and the PnP problem degenerates to a single 3D
    point. Calibrated statistics normalise each layer as training would,
    so the seeded model emits a spread-out point cloud.
    """
    for mod in model.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            mod.reset_running_stats()
            mod.momentum = None  # cumulative average: one batch = its stats
    model.train()
    with torch.no_grad():
        model(inp)
    model.eval()


def serving_requests(torch, device, num_requests=3, bs=32, seed=0,
                     bf16_backbone=False, profile=True):
    """Answer ``num_requests`` requests of ``bs`` crops with a CDPN-34
    (``sixdof.main.build_cdpn`` of the default SixDoFConfig, a bf16
    backbone with ``bf16_backbone``) on seeded random weights; returns
    (latencies in s, poses per request, K1 launches per request, the share
    of crops whose pose from the last request's model outputs matches the
    CPU twin path's)."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel
    from epropnp_tpu_torch.sixdof import test as test_lib
    from epropnp_tpu_torch.sixdof.config import (
        NetworkConfig, PnPConfig, SixDoFConfig)
    from epropnp_tpu_torch.sixdof.main import build_cdpn
    from epropnp_tpu_torch.sixdof.train import Batch

    torch.manual_seed(seed)
    cfg = SixDoFConfig(network=NetworkConfig(bf16_backbone=bf16_backbone),
                       pnp=PnPConfig(use_pallas=True))
    inp_res, out_res = cfg.dataiter.inp_res, cfg.dataiter.out_res
    model = build_cdpn(cfg).to(device).eval()
    cam = torch.tensor(LINEMOD_K, device=device)
    r = np.random.default_rng(seed)
    calibrate_batchnorm(torch, model, torch.tensor(
        r.normal(size=(bs, inp_res, inp_res, 3)), dtype=torch.float32,
        device=device))
    lat, poses, k1_launches = [], [], []

    def request(batch, box, gen):
        with torch.no_grad():
            outs = model(batch.inp)
            return test_lib.infer_poses(outs, batch, t(box), cam, cfg,
                                        init='rslm', rng=gen)

    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731,E501
    for req in range(num_requests + 1):  # request 0 warms up
        box = r.uniform(60, 140, (bs, 2))
        s_box = box.max(-1) * 1.5
        zeros = torch.zeros((bs, out_res, out_res, 3), device=device)
        batch = Batch(
            inp=t(r.normal(size=(bs, inp_res, inp_res, 3))),
            target_coor=zeros, loss_msk=zeros,
            trans_local=torch.zeros((bs, 3), device=device),
            pose=torch.zeros((bs, 3, 4), device=device),
            c_box=t(r.uniform([200, 150], [450, 330], (bs, 2))),
            s_box=t(s_box), dim=t(r.uniform(0.03, 0.1, (bs, 3))))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + req)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        k1_before = lm_kernel.launches
        t0 = time.perf_counter()
        res = request(batch, box, gen)
        pose = res.pose_est.cpu().numpy()  # waits for the device
        if req:
            lat.append(time.perf_counter() - t0)
            poses.append((pose, res.pose_est_trans.cpu().numpy()))
            k1_launches.append(lm_kernel.launches - k1_before)
    if device.type == 'cuda' and profile:
        profile_once(torch, lambda: request(batch, box, gen), 'serving')
    return lat, poses, k1_launches, uncounted(lambda: twin_path_agreement(
        torch, model, batch, box, cam, cfg))


def twin_path_agreement(torch, model, batch, box, cam, cfg, seed=123,
                        init='rslm'):
    """``infer_poses`` on the card (kernels) against the same call on CPU
    copies of the model outputs (kernel twins), with the same random draws
    (a CPU generator feeds both). Returns the share of crops whose [R|t]
    agree within 1e-3 * (|ref| + 1): the proposals' argmin may flip on a
    near-tie of costs summed in another order."""
    from epropnp_tpu_torch.sixdof import test as test_lib
    with torch.no_grad():
        outs = model(batch.inp)
        res = []
        for dev in (cam.device, torch.device('cpu')):
            to = lambda x: x.to(dev)  # noqa: E731
            res.append(test_lib.infer_poses(
                type(outs)(*map(to, outs)), type(batch)(*map(to, batch)),
                torch.tensor(box, dtype=torch.float32, device=dev), to(cam),
                cfg, init=init, rng=torch.Generator().manual_seed(seed)
            ).pose_est.cpu().numpy())
    return float(agree(res[0], res[1], 1e-3, 1.0).mean())


def phase_c(torch, device, bf16_backbone=False, num_requests=3,
            f32_lat=None):
    """CDPN-34 serving (``bf16_backbone``: path c's bf16 request, the model
    ``load_cdpn`` builds for ``network.bf16_backbone``, its latency printed
    beside ``f32_lat``, path c's)."""
    label = 'path c bf16' if bf16_backbone else 'phase c'
    lat, poses, k1_launches, twin_agree = serving_requests(
        torch, device, num_requests, bf16_backbone=bf16_backbone,
        profile=not bf16_backbone)
    print(f'{label}: share of the 32 crops whose pose from the kernel path '
          f'matches the CPU twin path: {twin_agree:.4f}')
    assert twin_agree >= 0.9, 'serving: kernel path disagrees with twins'
    if f32_lat is not None:
        print(f'{label}: latency ms ' + json.dumps(dict(
            bf16=[x * 1e3 for x in lat], f32=[x * 1e3 for x in f32_lat])))
    for i, (lat_s, (pose, pose_t), k1) in enumerate(zip(lat, poses,
                                                         k1_launches)):
        rot = pose[:, :, :3]
        orth = np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max()
        print(f'{label}: request {i}: 32 crops, latency '
              f'{lat_s * 1e3:.3f} ms, K1 launches {k1}, '
              f'finite={bool(np.isfinite(pose).all())}, '
              f'max|RR^T-I|={orth:.2e}')
        assert k1 == 2, 'serving: K1 not launched for proposals and refine'
        assert pose.shape == (32, 3, 4) and pose_t.shape == (32, 3, 4)
        assert np.isfinite(pose).all() and np.isfinite(pose_t).all(), \
            'non-finite pose'
        assert orth < 1e-4, 'rotation not orthonormal'
    return lat


def bench_twin_solve(torch, x3d, x2d, w2d, cam, cost_fun, seeds, solver):
    """The bench solve of ``LMSolver`` written out with the kernels' torch
    twins (the solver itself always launches the kernels on the card)."""
    from epropnp_tpu_torch.ops.pnp.lm_kernel import (
        camera_to_fxfycxcy, lm_solve_reference)
    from epropnp_tpu_torch.ops.pnp.rslm_kernel import rslm_init_reference
    rs = solver.init_solver
    cam4 = camera_to_fxfycxcy(cam).contiguous()
    delta = cost_fun.delta.contiguous()
    params = solver._lm_params()
    pose0, _ = rslm_init_reference(
        x3d, x2d, w2d, cam4, delta, seeds, dof=6, num_points=rs.num_points,
        num_proposals=rs.num_proposals, num_iter=rs.num_iter, z_min=0.1,
        score_points=rs.score_points, **params)
    return lm_solve_reference(x3d, x2d, w2d, cam4, delta, pose0, dof=6,
                              num_iter=solver.num_iter, z_min=0.1, **params)


def phase_d(torch, device):
    from epropnp_tpu_torch.ops.pnp import (
        AdaptiveHuberPnPCost, LMSolver, PerspectiveCamera, RSLMSolver,
        evaluate_pnp)
    from epropnp_tpu_torch.utils import synthetic
    x3d, x2d, w2d, cam, pose_gt = (
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in synthetic.make_problem())
    b = x3d.shape[0]
    solver = LMSolver(
        dof=6, num_iter=synthetic.BENCH_LM_ITER, use_pallas=True,
        init_solver=RSLMSolver(dof=6, num_points=synthetic.BENCH_RS_POINTS,
                               num_proposals=synthetic.BENCH_RS_PROPOSALS,
                               num_iter=synthetic.BENCH_RS_ITER,
                               use_pallas=True, fast_sampling=True))
    camera = PerspectiveCamera(cam_mats=cam)
    cost_fun = AdaptiveHuberPnPCost(relative_delta=0.1).set_param(x2d, w2d)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def run_kernel():
        pose, _, cost, _ = solver(x3d, x2d, w2d, camera, cost_fun, rng=gen,
                                  with_cost=True)
        return pose, cost

    seeds = torch.randint(0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                          device=device)

    def run_twin():
        return uncounted(lambda: bench_twin_solve(
            torch, x3d, x2d, w2d, cam, cost_fun, seeds, solver))

    pose, cost = run_kernel()
    pose_t, cost_t = run_twin()
    gt_cost = evaluate_pnp(x3d, x2d, w2d, pose_gt, camera, cost_fun,
                           out_cost=True).cost
    c, ct, cg = (t.cpu().numpy() for t in (cost, cost_t, gt_cost))
    assert np.isfinite(c).all() and np.isfinite(pose.cpu().numpy()).all(), \
        'bench: non-finite pose or cost'
    at_gt = float((c <= cg * 1.01).mean())
    ms_k = time_ms(torch, run_kernel, warmup=2, iters=10)
    kernels, _ = profile_once(torch, run_kernel, 'bench')
    busy = sum(k[1] for k in kernels)  # device ms of one solve
    ms_t = time_ms(torch, run_twin, warmup=1, iters=3)
    print('phase d: bench ' + json.dumps(dict(
        B=b, N=x3d.shape[1], median_cost=float(np.median(c)),
        twin_median_cost=float(np.median(ct)),
        gt_pose_median_cost=float(np.median(cg)),
        frac_cost_le_gt_1pct=at_gt,
        kernel_solves_per_s=b / (ms_k / 1e3),
        twin_solves_per_s=b / (ms_t / 1e3), kernel_ms=ms_k, twin_ms=ms_t,
        device_busy_ms=busy, device_solves_per_s=b / max(busy, 1e-9) * 1e3,
        k1_device_ms=sum(k[1] for k in kernels if 'lm_solve_kernel' in k[0]),
        k2_device_ms=sum(k[1] for k in kernels
                         if 'rslm_init_kernel' in k[0]))))
    assert at_gt >= 0.95, 'bench: fewer than 95% of solves reach the GT cost'
    assert np.isfinite(ct).all()


def dcn_problem(torch, device, n, h, w, c, cout, stride, seed, x=None):
    """A DeformConv layer's inputs at one path shape: x (n, h, w, c), or
    the given map, the raw conv_offset output of seeded non-zero offset
    weights (offsets of a few pixels, some samples off the map) and a
    weight (cout, c, 3, 3)."""
    from epropnp_tpu_torch.ops.deform_conv import DeformConv, conv_nhwc
    gen = torch.Generator(device=device).manual_seed(seed)
    if x is None:
        x = torch.randn((n, h, w, c), generator=gen, device=device)
    mod = DeformConv(c, cout, stride, bias=False).to(device)
    with torch.no_grad():
        mod.conv_offset.weight.normal_(0, 1.5 / (9 * c) ** 0.5, generator=gen)
        mod.weight.normal_(0, (2 / (9 * c)) ** 0.5, generator=gen)
        om = conv_nhwc(mod.conv_offset, x).contiguous()
    return x, om, mod.weight.detach()


def phase_e(torch, device):
    """K3 against its twin at the Det serving shapes (672x1600 x 6)."""
    from epropnp_tpu_torch.ops import dcn_kernel as k3
    shapes = [  # (n, h, w, c, cout, stride, what)
        (6, 42, 100, 256, 256, 1, 'backbone stage 3 (x22 per request)'),
        (6, 84, 200, 256, 256, 2, 'backbone stage 3 first block'),
        (6, 21, 50, 512, 512, 1, 'backbone stage 4 (x2 per request)'),
        (6, 84, 200, 256, 256, 1, 'FCOS towers, level 0 (x2 per request)'),
    ]
    rows = []
    for i, (n, h, w, c, cout, stride, what) in enumerate(shapes):
        x, om, weight = dcn_problem(torch, device, n, h, w, c, cout, stride,
                                    40 + i)
        w3 = k3.kernel_weight(weight)
        with torch.no_grad():
            run_k = lambda: k3.dcn_forward_cuda(x, om, w3, None, stride)  # noqa: E731,E501
            run_t = lambda: k3.dcn_reference(x, om, weight, None, stride)  # noqa: E731,E501
            out_k, out_t = run_k(), run_t()
            out_64 = k3.dcn_reference(x.double(), om.double(),
                                      weight.double(), None, stride)
            torch.cuda.synchronize()
            ho, wo = out_k.shape[1:3]
            # samples off the map: share of (position, tap) with a corner
            # outside (the offsets are the raw conv_offset output)
            rows_, w4 = k3.corner_rows_and_weights(om, (0, 0, h, w), (h, w),
                                                   stride, 2.0)
            off_map = float(((w4 == 0).any(-1)).float().mean())
            err = float((out_k - out_t).abs().max())
            scale = float(out_t.abs().max())
            err64_k = float((out_k.double() - out_64).abs().max())
            err64_t = float((out_t.double() - out_64).abs().max())
            ms = time_ms(torch, run_k, warmup=2, iters=10)
            plain_ms = time_ms(torch, run_t, warmup=1, iters=3)
            # yardstick of the contraction part only: one product of the
            # pre-sampled (L, 9c) stack (not a port of the kernel)
            sampled = k3.sampled_stack(x, om, stride)
            w_flat = w3.reshape(9 * c, cout)
            mm_ms = time_ms(torch, lambda: torch.matmul(sampled, w_flat),
                            warmup=2, iters=10)
            del sampled, rows_, w4
        length = n * ho * wo
        flops = 2 * length * 9 * c * cout + 8 * length * 9 * c
        nbytes = 4 * (n * h * w * c + length * 27 + 9 * c * cout
                      + length * cout)
        bound, by = bound_ms(flops, nbytes)
        row = dict(shape=[n, h, w, c, cout], stride=stride, what=what,
                   L=length, gflop=flops / 1e9, off_map_share=off_map,
                   max_abs_err=err, max_abs_twin=scale,
                   f64_err_kernel=err64_k, f64_err_twin=err64_t, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   bound_share=bound / ms, matmul_of_sampled_stack_ms=mm_ms,
                   tflops=flops / ms / 1e9)
        print('phase e: K3 ' + json.dumps(row))
        assert err <= K3_REL * scale, f'K3 disagrees with its twin: {what}'
        assert off_map > 0, 'no sample fell off the map'
        rows.append(row)
    main = rows[0]
    return dict(name='dcn_forward (K3)', route='cuda',
                source='epropnp_tpu_torch/csrc/dcn_kernel.cu',
                replaces='epropnp_tpu/ops/pallas_dcn.py:102',
                max_abs_err=max(r['max_abs_err'] for r in rows),
                ms=main['ms'], plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=None)


FCOS_LEVELS_672 = [(84, 200), (42, 100), (21, 50), (11, 25), (6, 13)]
E_VARIANT_SHAPES = [  # (n, h, w, c, cout, stride, what, variants)
    (6, 42, 100, 256, 256, 1, 'backbone stage 3 (x22 per request)',
     ('int8', 'bf16')),
    (6, 84, 200, 256, 256, 2, 'backbone stage 3 first block',
     ('int8', 'bf16')),
    (6, 21, 50, 512, 512, 1, 'backbone stage 4 (x2 per request)',
     ('int8', 'bf16')),
    (6, None, None, 256, 256, 1, 'FCOS towers, packed canvas of '
     'FCOS_LEVELS_672 (x2 per request)', ('int8', 'bf16')),
]


def phase_e_variants(torch, device):
    """K3's int8 (bf16 weight) and bf16 variants at the v1b_serving shapes,
    each against its twin in the same variant (and an f64 twin), the int8
    twin against the f32 twin."""
    from epropnp_tpu_torch.ops import dcn_kernel as k3
    from epropnp_tpu_torch.ops.level_pack import (
        pack_levels, plan_level_packing)
    bf16 = torch.bfloat16
    rows = {'int8': [], 'bf16': []}
    for i, (n, h, w, c, cout, stride, what, variants) in enumerate(
            E_VARIANT_SHAPES):
        levels = None
        if h is None:  # the 5 FCOS levels of 672x1600 on one canvas
            layout = plan_level_packing(FCOS_LEVELS_672)
            gen = torch.Generator(device=device).manual_seed(71)
            canvas = pack_levels([torch.randn((n, lh, lw, c), generator=gen,
                                              device=device)
                                  for lh, lw in FCOS_LEVELS_672], layout)
            x, om, weight = dcn_problem(torch, device, n, None, None, c,
                                        cout, 1, 70, x=canvas)
            levels = layout.regions()
            h, w = layout.canvas_hw
            length = n * sum(lh * lw for lh, lw in FCOS_LEVELS_672)
        else:
            x, om, weight = dcn_problem(torch, device, n, h, w, c, cout,
                                        stride, 60 + i)
            ho, wo = k3.output_hw(h, w, stride)
            length = n * ho * wo
        w3 = k3.kernel_weight(weight)
        xb = x.to(bf16)
        with torch.no_grad():
            ref32 = k3.dcn_reference(xb.float(), om, w3, None, stride, 2.0,
                                     levels)
            # yardstick of the contraction part only: one bf16 product of
            # the pre-sampled (L, 9c) stack (not a port of the kernel)
            stack = k3.sampled_stack(xb, om, stride, 2.0, levels).to(bf16)
            w_flat = w3.to(bf16).reshape(9 * c, cout)
            mm_ms = time_ms(torch, lambda: torch.matmul(stack, w_flat),
                            warmup=2, iters=10)
            del stack
            for variant in variants:
                if variant == 'int8':
                    xv, w3v = k3.quantize_nhwc(xb, w3.to(bf16))
                else:
                    xv, w3v = xb, w3.to(bf16)
                run_k = lambda: k3.dcn_forward_cuda(  # noqa: E731
                    xv, om, w3v, None, stride, 2.0, levels)
                run_t = lambda: k3.dcn_reference(  # noqa: E731
                    xv, om, w3v, None, stride, 2.0, levels)
                out_k, out_t = run_k(), run_t()
                out_64 = k3.dcn_reference(xv if variant == 'int8'
                                          else xv.double(), om.double(),
                                          w3v.double(), None, stride, 2.0,
                                          levels)
                torch.cuda.synchronize()
                scale = float(out_t.float().abs().max())
                err = float((out_k.float() - out_t.float()).abs().max())
                err64_k = float((out_k.double() - out_64).abs().max())
                err64_t = float((out_t.double() - out_64).abs().max())
                err32 = float((out_t.float() - ref32.reshape(
                    out_t.shape)).abs().max())
                ms = time_ms(torch, run_k, warmup=2, iters=10)
                plain_ms = time_ms(torch, run_t, warmup=1, iters=3)
                flops = 2 * length * 9 * c * cout
                nbytes = (xv.numel() * xv.element_size() + om.numel() * 4
                          + w3v.numel() * 2 + length * cout * 2)
                bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                row = dict(variant=variant, shape=[n, h, w, c, cout],
                           stride=stride, levels=len(levels or [0]),
                           what=what, L=length, gflop=flops / 1e9,
                           max_abs_err=err, max_abs_twin=scale,
                           f64_err_kernel=err64_k, f64_err_twin=err64_t,
                           twin_vs_f32_twin=err32,
                           twin_vs_f32_twin_rel=err32 / float(
                               ref32.abs().max()),
                           jax_budget=K3_INT8_JAX_BUDGET, ms=ms,
                           plain_ms=plain_ms,
                           bound_ms=bound, bound_by=by,
                           bound_share=bound / ms,
                           matmul_of_sampled_stack_ms=mm_ms,
                           tflops=flops / ms / 1e9)
                print('phase e+: K3 ' + json.dumps(row))
                assert err <= K3_VARIANT_REL * scale, \
                    f'K3 {variant} disagrees with its twin: {what}'
                if variant == 'int8':
                    assert err32 < K3_INT8_BUDGET * float(
                        ref32.abs().max()), f'int8 beyond budget: {what}'
                rows[variant].append(row)
                del out_k, out_t, out_64
    out = []
    for variant in ('bf16', 'int8'):
        main = rows[variant][0]
        out.append(dict(name=f'dcn_forward {variant} (K3)', route='cuda',
                        source='epropnp_tpu_torch/csrc/dcn_kernel.cu',
                        replaces='epropnp_tpu/ops/pallas_dcn.py:102',
                        max_abs_err=max(r['max_abs_err']
                                        for r in rows[variant]),
                        ms=main['ms'], plain_ms=main['plain_ms'],
                        bound_ms=main['bound_ms'],
                        bound_by=main['bound_by'], library_ms=None))
    return out


def det_pnp_problem(torch, device, b, n, seed):
    """A 4DoF problem seen by a camera at 1600x672: nuScenes-like focal
    length, principal points shifted per object so that part of the
    objects reach past the image-shape bounds and are clamped."""
    from epropnp_tpu_torch.ops.pnp import PerspectiveCamera
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_pnp_problem
    p = make_pnp_problem(b, n, seed, dof=4, init_noise=(0.05, 0.1),
                         focal=(1266.4, 1266.4), depth=(4.0, 20.0))
    shift = np.random.default_rng(seed + 1).uniform(
        [-150.0, -150.0], [1750.0, 820.0], (b, 2))
    p['x2d'] = p['x2d'] + shift[:, None]
    p['cams'][:, :2, 2] += shift
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in p.items()}
    cam = PerspectiveCamera.from_img_shape(
        t['cams'], torch.tensor([672.0, 1600.0], device=device).expand(b, 2),
        allowed_border=200.0)
    bounds = torch.cat([torch.full((b, 2), cam.lb, device=device), cam.ub],
                       -1).contiguous()
    return (t['x3d'], t['x2d'], t['w2d'],
            camera_to_fxfycxcy(t['cams']).contiguous(), bounds, t['pose0'])


def phase_f(torch, device):
    """K1 at dof 4 with bounds in fast mode against its twin."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel as k1
    rows = []
    for b, n, iters, what in ((98304, 16, 3, 'Det RSLM proposals'),
                              (1536, 128, 5, 'Det refine'),
                              (1536, 256, 5, 'Det flip-TTA refine')):
        x3d, x2d, w2d, cam, bounds, pose0 = det_pnp_problem(
            torch, device, b, n, 60 + n)
        delta = torch.full((b,), 10.0 / n, device=device)
        kw = dict(bounds=bounds, dof=4, num_iter=iters, fast_mode=True,
                  z_min=0.1)
        run_k = lambda: k1.lm_solve_cuda(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        run_t = lambda: k1.lm_solve_reference(x3d, x2d, w2d, cam, delta, pose0, **kw)  # noqa: E731,E501
        pk, ck = run_k()
        pt, ct = run_t()
        f64 = [a.double() for a in (x3d, x2d, w2d, cam, delta, pose0)]
        kw64 = dict(kw, bounds=bounds.double())
        p64, c64 = k1.lm_solve_reference(*f64, **kw64)
        torch.cuda.synchronize()
        pk, ck, pt, ct, p64, c64 = (a.cpu().numpy()
                                    for a in (pk, ck, pt, ct, p64, c64))
        proj = x2d.cpu().numpy()
        lo, hi = bounds[:, None, :2].cpu().numpy(), bounds[:, None, 2:].cpu(
            ).numpy()
        clamped = float(((proj < lo) | (proj > hi)).any(-1).any(-1).mean())
        finite = np.isfinite(ct)
        frac_c = agree(ck, ct, K1_RTOL, 0.0).mean()
        frac_p = agree(pk, pt, K1_RTOL, 1e-2).mean()
        spread_c = agree(ct, c64, K1_RTOL, 0.0).mean()
        spread_p = agree(pt, p64, K1_RTOL, 1e-2).mean()
        ms = time_ms(torch, run_k, iters=20)
        plain_ms = time_ms(torch, run_t, iters=5)
        bound, by = k1_bound(b, n, 4, iters)
        row = dict(B=b, N=n, num_iter=iters, what=what,
                   group=k1_group(b, n), objects_past_bounds=clamped,
                   twin_finite=float(finite.mean()),
                   cost_agree=float(frac_c), pose_agree=float(frac_p),
                   twin_f32_vs_f64_cost_agree=float(spread_c),
                   twin_f32_vs_f64_pose_agree=float(spread_p),
                   max_abs_cost_err=float(np.nanmax(np.abs(ck - ct))),
                   ms=ms,
                   device_ms=device_ms(torch, run_k, 'lm_solve_kernel'),
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   bound_share=bound / ms)
        # the kernel against the f64 twin, beside the f32 twin against it:
        # where the problem itself amplifies f32 rounding (objects whose
        # clamped points keep their Jacobian rows in fast mode), the f32
        # twin misses the f64 answer as often as the kernel does
        row['kernel_vs_f64_cost_agree'] = float(agree(ck, c64, K1_RTOL,
                                                      0.0).mean())
        row['finiteness_differs'] = float(
            (np.isfinite(pk).all(-1) != np.isfinite(pt).all(-1)).mean())
        print('phase f: K1 dof 4 + bounds ' + json.dumps(row))
        assert row['finiteness_differs'] <= 1 - K1_MIN_FRAC, \
            'K1 non-finite where its twin is finite'
        assert (frac_c >= K1_MIN_FRAC and frac_p >= K1_MIN_FRAC) or (
            row['kernel_vs_f64_cost_agree'] >= spread_c - 0.005), \
            f'K1 dof 4 disagrees with its twin at {(b, n)}'
        rows.append(row)
    return rows


def det_frames(seed, num=6, h=900, w=1600):
    """``num`` random camera frames (h, w, 3) in [0, 255] and their
    intrinsics (one nuScenes sample's six cameras, at random)."""
    r = np.random.default_rng(seed)
    imgs = [r.uniform(0, 255, (h, w, 3)).astype(np.float32)
            for _ in range(num)]
    return imgs, [np.array(NUSCENES_K) for _ in range(num)]


def build_det_model(torch, device, seed, img_hw=(672, 1600)):
    """v1b with K1 on the path, seeded random weights, non-zero DCN offset
    weights, BatchNorm statistics calibrated on one seeded batch of 6."""
    import dataclasses
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det.config import DetConfig
    from epropnp_tpu_torch.ops.deform_conv import DeformConv
    cfg = DetConfig.v1b()
    cfg = dataclasses.replace(cfg, pnp=dataclasses.replace(cfg.pnp,
                                                           use_pallas=True))
    torch.manual_seed(seed)
    model = api.init_detector(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DeformConv):
                c = mod.conv_offset.in_channels
                mod.conv_offset.weight.normal_(0, 0.5 / (9 * c) ** 0.5,
                                               generator=gen)
    inp = torch.randn((6,) + tuple(img_hw) + (3,), generator=gen,
                      device=device)
    calibrate_batchnorm(torch, model.backbone, inp)
    # scale every bottleneck's residual branch (its last BatchNorm) by
    # RESIDUAL_SCALE: at scale 1 this random ResNet-101 is chaotic, and
    # f32 rounding alone moves the head's outputs by O(1) (CPU f32 against
    # f64); at 0.3 they stay within ~1e-5, so card and CPU can be compared
    with torch.no_grad():
        for mod in model.backbone.modules():
            if hasattr(mod, 'bn3'):
                mod.bn3.weight.mul_(RESIDUAL_SCALE)
    return cfg, model


def phase_g(torch, device, num_requests=3):
    """Det serving: 3 requests of 6 frames, each through K3 36 times and
    K1 twice; then a 320x800 image on the card against the CPU twins."""
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.ops.pnp import lm_kernel
    t0 = time.perf_counter()
    cfg, model = build_det_model(torch, device, seed=0)
    torch.cuda.synchronize()
    print(f'phase g: model built and calibrated in '
          f'{time.perf_counter() - t0:.1f} s')
    time_dense_conv(torch, model)
    infer = dtest.make_inference_fn(model, cfg, min_fcos_score=0.0)
    lat = []
    for req in range(num_requests + 1):  # request 0 warms up
        imgs, ks = det_frames(100 + req)
        gen = torch.Generator().manual_seed(req)
        torch.cuda.synchronize()
        k3_0, k1_0 = dcn_kernel.launches, lm_kernel.launches
        t0 = time.perf_counter()
        _, out3d = api.inference_detector(model, cfg, imgs, ks,
                                          infer_fn=infer, rng=gen)
        dt = time.perf_counter() - t0
        k3, k1 = dcn_kernel.launches - k3_0, lm_kernel.launches - k1_0
        live = np.concatenate([a for im in out3d for a in im], 0)
        print(f'phase g: request {req}{" (warm-up)" if not req else ""}: 6 '
              f'frames, latency {dt * 1e3:.3f} ms, K3 launches {k3}, K1 '
              f'launches {k1}, live objects {len(live)}, '
              f'finite={bool(np.isfinite(live).all())}')
        assert k3 == 36, 'Det request: K3 not launched 36 times'
        assert k1 == 2, 'Det request: K1 not launched for proposals + refine'
        assert np.isfinite(live).all(), 'non-finite live box'
        if req:
            lat.append(dt)
    print('phase g: latency per 6-frame request (ms): '
          + json.dumps([round(v * 1e3, 3) for v in lat]))
    time_host_pipeline(imgs, ks)
    kernels, _ = profile_once(torch, lambda: api.inference_detector(
        model, cfg, imgs, ks, infer_fn=infer,
        rng=torch.Generator().manual_seed(0)), 'det serving', top=12)
    if kernels:
        total = sum(k[1] for k in kernels)
        share = lambda *keys: sum(  # noqa: E731
            k[1] for k in kernels if any(s in k[0].lower() for s in keys))
        k3_ms = share('dcn_forward')
        conv_ms = share('cudnn', 'conv', 'fprop', 'implicit_gemm')
        pnp_ms = share('lm_solve')
        print('phase g: device time by kind: ' + json.dumps(dict(
            total_ms=total, k3_ms=k3_ms, cudnn_conv_ms=conv_ms,
            k1_ms=pnp_ms, k3_share=k3_ms / total,
            cudnn_conv_share=conv_ms / total, k1_share=pnp_ms / total)))
    rel, rel64, pose_close, pose_agree = uncounted(
        lambda: reduced_size_agreement(torch, model, cfg))
    print(f'phase g: 320x800 card vs CPU twins: dense max rel err {rel:.3e}'
          f' (rule {DET_DENSE_REL:g}; CPU f32 vs f64 {rel64:.3e}), poses '
          f'within 1e-3 {pose_close:.4f}, or of equal cost {pose_agree:.4f}')
    assert rel <= DET_DENSE_REL, 'dense outputs: card and CPU disagree'
    assert pose_agree >= 0.99, 'poses: card and CPU twins disagree'
    return lat


def build_serving_model(torch, device, int8=True):
    """``DetConfig.v1b_serving()`` (or its bf16-gather variant) holding
    phase g's seeded weights, BatchNorm statistics and residual scale;
    returns (cfg, model, the f32 v1b cfg, the f32 model)."""
    import dataclasses
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det.config import DetConfig
    cfg32, model32 = build_det_model(torch, device, seed=0)
    cfg = DetConfig.v1b_serving()
    if not int8:
        cfg = dataclasses.replace(cfg, int8_dcn_gather=False)
    model = api.init_detector(cfg, device=device)
    model.load_state_dict(model32.state_dict())
    return cfg, model, cfg32, model32


def serving_request(torch, model, cfg, infer, seed):
    """One 6-frame request through ``det.api.inference_detector``: returns
    (latency in s, live boxes, launches per kernel during it)."""
    from epropnp_tpu_torch.det import api
    imgs, ks = det_frames(100 + seed)
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    _, out3d = api.inference_detector(model, cfg, imgs, ks, infer_fn=infer,
                                      rng=torch.Generator().manual_seed(seed))
    dt = time.perf_counter() - t0
    after = launch_counts()
    live = np.concatenate([a for im in out3d for a in im], 0)
    return dt, live, {k: after[k] - before[k] for k in after}


def phase_h(torch, device, num_requests=3):
    """Det serving at v1b_serving: 3 requests of 6 frames, each through
    K3-int8 28 times and K1 twice; a profile by kind; the 320x800 card
    against CPU check of the dense outputs."""
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det import test as dtest
    t0 = time.perf_counter()
    cfg, model, cfg32, model32 = build_serving_model(torch, device)
    torch.cuda.synchronize()
    print(f'phase h: model built in {time.perf_counter() - t0:.1f} s, '
          f'parameters {next(model.parameters()).dtype}')
    infer = dtest.make_inference_fn(model, cfg, min_fcos_score=0.0)
    lat = []
    for req in range(num_requests + 1):  # request 0 warms up
        dt, live, n = serving_request(torch, model, cfg, infer, req)
        print(f'phase h: request {req}{" (warm-up)" if not req else ""}: 6 '
              f'frames, latency {dt * 1e3:.3f} ms, launches {json.dumps(n)},'
              f' live objects {len(live)}, '
              f'finite={bool(np.isfinite(live).all())}')
        assert n['K3-int8'] == SERVING_K3_LAUNCHES, \
            f'v1b_serving request: K3-int8 not launched ' \
            f'{SERVING_K3_LAUNCHES} times'
        assert n['K3-f32'] == n['K3-bf16'] == 0, 'a float DCN was launched'
        assert n['K1'] == 2, 'v1b_serving: K1 not launched twice'
        assert np.isfinite(live).all(), 'non-finite live box'
        if req:
            lat.append(dt)
    print('phase h: latency per 6-frame request (ms): '
          + json.dumps([round(v * 1e3, 3) for v in lat]))
    imgs, ks = det_frames(100)
    kernels, wall_ms = profile_once(torch, lambda: api.inference_detector(
        model, cfg, imgs, ks, infer_fn=infer,
        rng=torch.Generator().manual_seed(0)), 'v1b_serving', top=15)
    if kernels:
        kinds = {'k3_int8': ('dcn_forward',),
                 'k1': ('lm_solve',),
                 'transposes': ('nchwtonhwc', 'nhwctonchw', 'transpose'),
                 'norms': ('batch_norm', 'bn_fw', 'norm'),
                 'convs_and_gemms': ('conv', 'fprop', 'xmma', 'implicit',
                                     'cudnn', 'cutlass', 'gemm', 'nvjet'),
                 'copies_and_casts': ('copy', 'cast')}
        by_kind, rest = {k: 0.0 for k in kinds}, 0.0
        for name, ms, _ in kernels:
            low = name.lower()
            kind = next((k for k, keys in kinds.items()
                         if any(key in low for key in keys)), None)
            if kind is None:
                rest += ms
            else:
                by_kind[kind] += ms
        busy = sum(k[1] for k in kernels)
        print('phase h: device time by kind (ms): ' + json.dumps(dict(
            by_kind, other=rest, device_busy=busy,
            host_gap=wall_ms - busy)))
    rel, spread = uncounted(lambda: serving_reduced_size(
        torch, model, cfg, model32, cfg32))
    print(f'phase h: 320x800 card vs CPU, both v1b_serving: dense max rel '
          f'err {rel:.3e}; CPU v1b_serving vs CPU f32 v1b {spread:.3e}; '
          f'rule <= {SERVING_SPREAD_FACTOR:g} x that spread')
    assert rel <= SERVING_SPREAD_FACTOR * spread, \
        'v1b_serving dense outputs: card and CPU disagree'
    return lat


def serving_reduced_size(torch, model, cfg, model32, cfg32, seed=7):
    """One 320x800 image through the dense stage: the serving model on the
    card (bf16 convs, K3-int8) and on the CPU (bf16 convs, K3-int8's
    twin), and the f32 model on the CPU. Returns (max over dense outputs
    of max|card - cpu| / max|cpu|, the same for the CPU serving model
    against the CPU f32 model)."""
    import copy
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.det.pipelines import default_pipeline
    device = next(model.parameters()).device
    imgs, ks = det_frames(seed, num=1, h=320, w=800)
    s = default_pipeline(dict(img=imgs[0], cam_intrinsic=ks[0]),
                         training=False)
    flat = lambda d: [a.float().cpu() for o in d[0] for a in o] + [  # noqa: E731,E501
        a.float().cpu() for a in d[1:]]
    outs = []
    for m, c, dev in ((model, cfg, device),
                      (copy.deepcopy(model).cpu(), cfg, 'cpu'),
                      (copy.deepcopy(model32).cpu(), cfg32, 'cpu')):
        img = torch.as_tensor(s['img'][None], dtype=torch.float32).to(dev)
        outs.append(flat(dtest.make_inference_fn(m, c).dense(img)))
    rel = lambda xs, ys: max(float((a - b).abs().max() / b.abs().max())  # noqa: E731,E501
                             for a, b in zip(xs, ys) if b.abs().max() > 0)
    return rel(outs[0], outs[1]), rel(outs[1], outs[2])


def phase_h_bf16(torch, device):
    """One request of the bf16-gather variant (v1b_serving with
    ``int8_dcn_gather`` off) after a warm-up: 28 K3-bf16 launches."""
    from epropnp_tpu_torch.det import test as dtest
    cfg, model, _, _ = build_serving_model(torch, device, int8=False)
    infer = dtest.make_inference_fn(model, cfg, min_fcos_score=0.0)
    for req in range(2):  # request 0 warms up
        dt, live, n = serving_request(torch, model, cfg, infer, req)
        print(f'phase h, bf16 gather: request {req}'
              f'{" (warm-up)" if not req else ""}: latency {dt * 1e3:.3f} '
              f'ms, launches {json.dumps(n)}, live objects {len(live)}')
        assert n['K3-bf16'] == SERVING_K3_LAUNCHES, \
            'bf16-gather request: K3-bf16 not launched 28 times'
        assert n['K3-int8'] == n['K3-f32'] == 0
        assert np.isfinite(live).all(), 'non-finite live box'


def time_host_pipeline(imgs, ks):
    """The host part of a request alone: the numpy pipeline of its 6
    frames (crop, dense x2d maps, normalisation) and the stacking."""
    from epropnp_tpu_torch.det.pipelines import (
        REFERENCE_CROP_BOX, default_pipeline)
    t0 = time.perf_counter()
    samples = [default_pipeline(dict(img=img, cam_intrinsic=k),
                                training=False,
                                crop_box=REFERENCE_CROP_BOX)
               for img, k in zip(imgs, ks)]
    t1 = time.perf_counter()
    for key in ('img', 'img_dense_x2d', 'img_dense_x2d_mask'):
        np.stack([s[key] for s in samples])
    t2 = time.perf_counter()
    print(f'phase g: host pipeline of 6 frames {(t1 - t0) * 1e3:.3f} ms, '
          f'stacking {(t2 - t1) * 1e3:.3f} ms')


def time_dense_conv(torch, model):
    """The head's dense-stage 3x3 conv 256 -> 128 at stride 8 (6 x 84 x
    200) as served (channels-last, cuDNN's exhaustive algorithm search)
    and with cuDNN's default heuristics, which pick FFT tiling there
    (NCHW tensors: a separate entry in PyTorch's algorithm cache)."""
    import torch.nn.functional as F
    conv = model.bbox_head.convs[1].conv
    x = torch.randn((6, conv.in_channels, 84, 200),
                    device=next(model.parameters()).device)
    x_cl = x.to(memory_format=torch.channels_last)
    w = conv.weight.detach().contiguous()
    with torch.no_grad():
        served = time_ms(torch, lambda: conv(x_cl), warmup=1, iters=3)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            heur = time_ms(torch, lambda: F.conv2d(x, w, padding=1),
                           warmup=1, iters=2)
    print(f'phase g: dense conv {conv.in_channels}->{conv.out_channels} at '
          f'6x84x200: {served:.3f} ms as served (exhaustive search), '
          f'{heur:.3f} ms with cuDNN default heuristics')


def reduced_size_agreement(torch, model, cfg, seed=7, tta=False):
    """One 320x800 image (and with ``tta`` its horizontal flip): the dense
    stage on the card (K3) against a CPU copy of the model (K3's twin),
    then everything after it (subheads, RSLM + K1 or its twin, NMS; with
    ``tta`` the flip-TTA post) from the card's dense outputs on both
    devices, with one CPU generator feeding both the same draws.

    Returns (max over dense outputs of max|card - cpu| / max|cpu|, the
    same for the CPU f32 outputs of the image against f64, the share of
    the objects whose 4DoF pose agrees within 1e-3 * (|ref| + 1), and the
    share that agrees or whose two poses cost the same within 1e-4 on the
    CPU's problem: a far object's flat cost valley, where f32 rounding
    picks another point of equal cost)."""
    import copy
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.det.pipelines import default_pipeline
    from epropnp_tpu_torch.ops.pnp import evaluate_pnp
    device = next(model.parameters()).device
    imgs, ks = det_frames(seed, num=1, h=320, w=800)
    s = default_pipeline(dict(img=imgs[0], cam_intrinsic=ks[0]),
                         training=False)
    model_cpu = copy.deepcopy(model).cpu()
    make = dtest.make_tta_inference_fn if tta else dtest.make_inference_fn

    def flat(dense):
        return [a for d in dense for o in d[0] for a in o] + [
            a for d in dense for a in d[1:]]

    rel, poses = 0.0, []
    for first, dev, m in ((True, device, model),
                          (False, torch.device('cpu'), model_cpu)):
        t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a)[None], dtype=dt).to(dev)
        infer = make(m, cfg, min_fcos_score=0.0)
        img = t(s['img'])
        dense = [infer.dense(i) for i in (
            (img, torch.flip(img, [2])) if tta else (img,))]
        if first:
            dense_card = dense
        else:
            dense_cpu = dense
            rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                      for a, b in zip(flat(dense_card), flat(dense_cpu)))
        moved = [([type(o)(*(a.to(dev) for a in o)) for o in d[0]],
                  d[1].to(dev), d[2].to(dev)) for d in dense_card]
        x2d = t(s['img_dense_x2d'])
        common = (t(ks[0]), t(s['img_shape']), t(s['ori_shape']))
        if tta:
            args = (*moved, *common, x2d, torch.flip(x2d, [2]),
                    t(s['img_dense_x2d_mask']))
        else:
            args = (*moved, *common, t(s['flip'], torch.bool), x2d,
                    t(s['img_dense_x2d_mask']))
        res = infer.post(*args, rng=torch.Generator().manual_seed(seed))
        poses.append(res.bbox_3d[:, 3:].cpu())
    x3d, x2d, w2d, camera, cost_fun = infer.pnp_problem(*args)[2:]
    with torch.no_grad():
        costs = [evaluate_pnp(x3d, x2d, w2d, p, camera, cost_fun,
                              out_cost=True).cost.numpy() for p in poses]
        img64 = torch.as_tensor(s['img'][None], dtype=torch.float64)
        dense64 = dtest.make_inference_fn(model_cpu.double(), cfg).dense(
            img64)
    poses = [p.numpy() for p in poses]
    same_nan = (np.isnan(poses[0]) == np.isnan(poses[1])).all(-1)
    close = agree(np.nan_to_num(poses[0]), np.nan_to_num(poses[1]), 1e-3,
                  1.0) & same_nan
    flat_cost = agree(costs[0], costs[1], 1e-4, 0.0)
    rel64 = max(float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(flat(dense_cpu[:1]), flat([dense64])))
    return rel, rel64, float(close.mean()), float((close | flat_cost).mean())


def frac_close(a, b, floor=0.0):
    """Share of rows whose every entry is within K1_RTOL * (|b| + floor)."""
    return float(agree(a, b, K1_RTOL, floor).mean())


def phase_i(torch, device):
    """K1 in the training modes (trust region with projection bounds, with
    and without the JtJ output) against its twin and an f64 twin."""
    from epropnp_tpu_torch.ops.pnp import lm_kernel as k1
    from epropnp_tpu_torch.utils.synthetic import make_bounded_pnp_problem
    rows = []
    for dof, b, n, iters, jtj, what in (
            (6, 128, 16, 3, False, '6DoF training RSLM proposals'),
            (6, 32, 512, 5, True, '6DoF training solve + JtJ'),
            (4, 1536, 128, 10, True, 'Det training solve + JtJ')):
        p = make_bounded_pnp_problem(b, n, 80 + n, dof, init_noise=(
            (0.3, 0.5) if n == 16 else (0.05, 0.1)))
        t = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in p.items()}
        args = (t['x3d'], t['x2d'], t['w2d'],
                k1.camera_to_fxfycxcy(t['cams']).contiguous(), t['delta'],
                t['pose0'])
        kw = dict(bounds=t['bounds'], dof=dof, num_iter=iters,
                  fast_mode=False, z_min=0.1, with_jtj=jtj)
        run_k = lambda: k1.lm_solve_cuda(*args, **kw)  # noqa: E731
        run_t = lambda: k1.lm_solve_reference(*args, **kw)  # noqa: E731
        out_k, out_t = run_k(), run_t()
        out_64 = k1.lm_solve_reference(
            *(a.double() for a in args), **dict(
                kw, bounds=t['bounds'].double()))
        torch.cuda.synchronize()
        ok_, ot, o64 = ([a.cpu().numpy() for a in o]
                        for o in (out_k, out_t, out_64))
        lo, hi = p['bounds'][:, None, :2], p['bounds'][:, None, 2:]
        past = ((p['x2d'] < lo) | (p['x2d'] > hi)).any(-1)
        row = dict(dof=dof, B=b, N=n, num_iter=iters, with_jtj=jtj,
                   what=what, group=k1_group(b, n),
                   points_past_bounds=float(past.mean()),
                   objects_past_bounds=float(past.any(-1).mean()),
                   cost_agree=frac_close(ok_[1], ot[1]),
                   pose_agree=frac_close(ok_[0], ot[0], 1e-2),
                   kernel_vs_f64_cost_agree=frac_close(ok_[1], o64[1]),
                   twin_f32_vs_f64_cost_agree=frac_close(ot[1], o64[1]),
                   kernel_vs_f64_pose_agree=frac_close(ok_[0], o64[0], 1e-2),
                   twin_f32_vs_f64_pose_agree=frac_close(ot[0], o64[0],
                                                         1e-2),
                   max_abs_cost_err=float(np.abs(ok_[1] - ot[1]).max()))
        finite = all(np.isfinite(a).all() for a in ok_)
        if jtj:
            # an object whose points all lie past a bound has JtJ = 0
            same = agree(ok_[0], ot[0], K1_RTOL, 1e-2)
            rel = lambda a, b: np.abs(a - b).max((1, 2)) / np.maximum(  # noqa: E731,E501
                np.abs(b).max((1, 2)), 1e-30)
            row['jtj_zero_objects'] = float(
                (np.abs(ot[2]).max((1, 2)) == 0).mean())
            row['jtj_agree_where_poses_agree'] = float(
                (rel(ok_[2], ot[2])[same] <= K1_JTJ_REL).mean())
            row['jtj_max_rel_err_where_poses_agree'] = float(
                rel(ok_[2], ot[2])[same].max())
            row['twin_f32_vs_f64_jtj_max_rel_err'] = float(
                rel(ot[2], o64[2])[same].max())
        row['ms'] = time_ms(torch, run_k, iters=20)
        row['device_ms'] = device_ms(torch, run_k, 'lm_solve_kernel')
        row['plain_ms'] = time_ms(torch, run_t, iters=5)
        # the JtJ output adds its lower triangle to the bytes written
        bound, by = k1_bound(b, n, dof, iters + 1)
        row['bound_ms'], row['bound_by'] = bound, by
        row['bound_share'] = bound / row['ms']
        print('phase i: K1 training mode ' + json.dumps(row))
        assert finite, 'K1 non-finite in a training mode'
        assert row['cost_agree'] >= K1_MIN_FRAC or (
            row['kernel_vs_f64_cost_agree']
            >= row['twin_f32_vs_f64_cost_agree'] - 0.005), \
            f'K1 training mode: costs disagree at {(dof, b, n)}'
        assert row['pose_agree'] >= K1_MIN_FRAC or (
            row['kernel_vs_f64_pose_agree']
            >= row['twin_f32_vs_f64_pose_agree'] - K1_POSE_F64_MARGIN), \
            f'K1 training mode: poses disagree at {(dof, b, n)}'
        if jtj:
            assert row['jtj_agree_where_poses_agree'] >= K1_MIN_FRAC, \
                f'K1 JtJ disagrees where the poses agree at {(dof, b, n)}'
        rows.append(row)
    main = rows[1]
    return dict(name='lm_solve (K1), training modes', route='cuda',
                source='epropnp_tpu_torch/csrc/lm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_lm.py:396',
                max_abs_err=max(r['max_abs_cost_err'] for r in rows),
                ms=main['ms'], device_ms=main['device_ms'],
                plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=None)


def tiny_train_cfg():
    """The JAX tests' tiny 6DoF training config (ResNet-18, 64x64 crops,
    16x16 maps, 32 points, 32 Monte Carlo samples), K1 on."""
    from epropnp_tpu_torch.sixdof.config import (
        DataIterConfig, NetworkConfig, PnPConfig, SixDoFConfig, TrainConfig)
    return SixDoFConfig(
        network=NetworkConfig(back_layers_num=18),
        dataiter=DataIterConfig(inp_res=64, out_res=16, sample_points=32),
        pnp=PnPConfig(mc_samples=32, num_iter=2, lm_num_iter=2,
                      rs_num_points=8, rs_num_proposals=2, rs_num_iter=1,
                      use_pallas=True),
        train=TrainConfig(lr_epoch_step=()))


class DrawReplay:
    """Records every random draw of a training step (the 6DoF point
    subsample or the Det object sampler, the init's sampler, the AMIS
    proposals) and replays them, cast to the caller's dtype (indices stay
    integers) and device, so that runs on the card and on the CPU, in f32
    and f64, see the same random numbers. With ``pose_samples`` the AMIS
    proposals are replayed whole (``draw_pose_samples``), not as the
    uniforms and normals they are made of: the von Mises sampler's
    rejection loop takes as many rounds as the model's concentrations ask,
    which differ between a bf16 run and an f64 one."""

    def __init__(self, det: bool = False, pose_samples: bool = False):
        from epropnp_tpu_torch.models.dense_heads import deform_pnp_head
        from epropnp_tpu_torch.ops.pnp import distributions, epropnp
        from epropnp_tpu_torch.ops.pnp import levenberg_marquardt as lm
        from epropnp_tpu_torch.sixdof import train
        self.sites = [(epropnp, 'draw_pose_samples') if pose_samples
                      else (distributions, '_draw'), (lm, '_rand'),
                      (deform_pnp_head, 'draw_object_samples') if det
                      else (train, 'sample_point_indices')]
        self.real = {name: getattr(mod, name) for mod, name in self.sites}
        self.draws, self.replay = [], None

    def __enter__(self):
        for mod, name in self.sites:
            setattr(mod, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for mod, name in self.sites:
            setattr(mod, name, self.real[name])

    def start_replay(self):
        self.replay = list(self.draws)

    def _wrap(self, name):
        real = self.real[name]

        def draw(*args, **kwargs):
            if name == 'sample_point_indices':
                device = args[-1]
                like = None
            elif name == 'draw_pose_samples':
                like = args[0].loc
            else:
                like = args[2]
            if self.replay is None:
                out = real(*args, **kwargs)
                self.draws.append(out.cpu())
                return out
            out = self.replay.pop(0)
            if like is None:
                return out.to(device)
            return out.to(device=like.device, dtype=like.dtype
                          if out.is_floating_point() else out.dtype)
        return draw


def step_snapshot(torch, model, run_step):
    """``run_step()`` (one training step of ``model``) and what it did: the
    losses, the gradient and the update of every parameter, the BatchNorm
    statistics (numpy, float64)."""
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    metrics = run_step()
    as_np = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    return dict(
        losses={k: float(v) for k, v in metrics.items()},
        grads={k: as_np(p.grad) for k, p in model.named_parameters()},
        updates={k: as_np(p - before[k])
                 for k, p in model.named_parameters()},
        stats={k: as_np(v) for k, v in model.named_buffers()
               if k.endswith(('running_mean', 'running_var'))})


def train_step_snapshot(torch, cfg, model, batch, device):
    """One 6DoF training step of ``model`` on ``device`` (:func:`step_snapshot`)."""
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.sixdof import train as strain
    dtype = next(model.parameters()).dtype
    state = strain.TrainState(model, strain.make_optimizer(cfg, model))
    step = strain.make_train_step(strain.build_epropnp(cfg), cfg,
                                  torch.tensor(LINEMOD_K, dtype=dtype,
                                               device=device))
    tb = strain.Batch(*(t.to(dtype) for t in smain.to_device(batch, device)))
    return step_snapshot(torch, model, lambda: step(
        state, tb, torch.Generator().manual_seed(0)))


def leaf_rel(a, b):
    """Per leaf: max|a - b| / max|b| (max over the leaves)."""
    return max(float(np.abs(a[k] - b[k]).max()
                     / max(np.abs(b[k]).max(), 1e-30)) for k in b)


def rel_l2(a, b):
    """Relative L2 distance over all leaves and that of the worst leaf."""
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k] ** 2)) for k in b)
    worst = max(float(np.linalg.norm(a[k] - b[k])
                      / max(np.linalg.norm(b[k]), 1e-30)) for k in b)
    return (num / max(den, 1e-60)) ** 0.5, worst


def bf16_direction(runs, group, zeroed, label):
    """The reduced bf16 steps' direction rule (TRAIN_BF16_COS_MARGIN):
    ``runs`` is a list over batches of (card, CPU bf16, CPU f64)
    gradients (name -> array), ``group(name)`` a leaf's group. A batch in
    which a run's gradient is not finite (the step skips it, as JAX's
    does) is left out; at least TRAIN_BF16_MIN_BATCHES must remain. Each
    batch weighs the same: its gradients are scaled by its f64
    gradient's norm. Checks the card's gradients and fails unless each
    planted fault (``zeroed`` group, negated, the batch before's) fails
    the rule; returns the distances, cosines and failing groups of each,
    and each batch's cosines."""
    acc, per_batch = {}, []

    def norm(grads):
        return sum(float(np.sum(v * v)) for v in grads.values()) ** 0.5

    def add(who, grads, f64, scale):
        for k, f in f64.items():
            g, f = grads[k] * scale, f * scale
            a = acc.setdefault((who, group(k)), np.zeros(4))
            a += (np.sum((g - f) ** 2), np.sum(g * f), np.sum(g * g),
                  np.sum(f * f))
    previous = None
    for i, (card, cpu, f64) in enumerate(runs):
        finite = {who: all(np.isfinite(v).all() for v in g.values())
                  for who, g in (('card', card), ('cpu', cpu),
                                 ('f64', f64))}
        row = dict(batch=i, finite=finite, norms=dict(
            card=norm(card), cpu=norm(cpu), f64=norm(f64)))
        per_batch.append(row)
        if not all(finite.values()):
            continue
        scale = 1.0 / max(row['norms']['f64'], 1e-300)
        row['cosines'] = {}
        for who, g in (('card', card), ('cpu', cpu)):
            row['cosines'][who] = sum(float(np.sum(g[k] * f))
                                      for k, f in f64.items()) / max(
                row['norms'][who] * row['norms']['f64'], 1e-300)
        add('card', card, f64, scale)
        add('cpu', cpu, f64, scale)
        add('zeroed', {k: v * 0 if group(k) == zeroed else v
                       for k, v in card.items()}, f64, scale)
        add('negated', {k: -v for k, v in card.items()}, f64, scale)
        if previous is not None:
            add('unrelated', previous, f64, scale)
        previous = card

    def rows(who):
        return {grp: a for (w, grp), a in acc.items() if w == who}

    def distance(who):
        r = rows(who).values()
        return (sum(a[0] for a in r) / max(sum(a[3] for a in r),
                                           1e-300)) ** 0.5

    def cosines(who):
        return {grp: float(a[1] / max(a[2] * a[3], 1e-300) ** 0.5)
                for grp, a in rows(who).items()}
    used = sum('cosines' in r for r in per_batch)
    print(f'{label}: per batch, finite gradients, global norms and cosines '
          'to the f64 run: ' + json.dumps(per_batch))
    assert used >= TRAIN_BF16_MIN_BATCHES, \
        f'{label}: {used} batches with finite gradients in every run'
    ref = cosines('cpu')
    out = dict(batches_used=used)
    for who in ('card', 'cpu', 'zeroed', 'negated', 'unrelated'):
        cos = cosines(who)
        failing = [grp for grp in ref
                   if not cos[grp] >= ref[grp] - TRAIN_BF16_COS_MARGIN]
        if not distance(who) <= TRAIN_F64_FACTOR * distance('cpu') \
                + TRAIN_BF16_FLOOR:
            failing.append('distance')
        out[who] = dict(distance=distance(who), cosines=cos,
                        failing=failing)
    print(f'{label}: gradients against the f64 run over {used} batches, by '
          'group (planted faults zeroed / negated / unrelated must fail; '
          f'rule: cosine within {TRAIN_BF16_COS_MARGIN:g} of the CPU bf16 '
          f'run\'s, distance {TRAIN_F64_FACTOR:g}x): ' + json.dumps(out))
    assert not out['card']['failing'], \
        f'{label}: gradients point away from f64: {out["card"]["failing"]}'
    for fault in ('zeroed', 'negated', 'unrelated'):
        assert out[fault]['failing'], \
            f'{label}: the planted fault {fault!r} passes the direction rule'
    return out


def card_vs_cpu(torch, device, model, snapshot, label, det=False,
                yardstick=None, group=None, zeroed=None, batches=1):
    """One reduced-size training step of ``model`` on the card and on the
    CPU, f32, TF32 off, the same weights and the same draws, and the CPU in
    f64 as the yardstick of f32 rounding; ``snapshot(model, device)`` runs
    the step. The rules: losses within TRAIN_LOSS_REL of the CPU's,
    BatchNorm statistics within TRAIN_STATS_REL, gradients and updates no
    further from the f64 run than TRAIN_F64_FACTOR times the CPU f32 run
    (+ 1e-5).

    ``yardstick`` = ``(model64, snapshot64)`` (a bf16 step: the same
    weights in f64 with the bf16 options off) takes the f64 copy's place;
    then every rule is the yardstick's: the card's losses, BatchNorm
    statistics, gradients and updates no further from the f64 run than
    TRAIN_F64_FACTOR times the CPU bf16 run (+ TRAIN_BF16_FLOOR); and
    :func:`bf16_direction` over ``batches`` batches (``snapshot`` takes
    the batch's index), by ``group``, ``zeroed`` the group of
    its planted fault."""
    import copy
    cpu_dev = torch.device('cpu')

    def three(i):
        with DrawReplay(det, pose_samples=yardstick is not None) as draws:
            cpu = snapshot(copy.deepcopy(model), cpu_dev, i)
            draws.start_replay()
            card = snapshot(copy.deepcopy(model).to(device), device, i)
            draws.start_replay()
            cpu64 = (snapshot(copy.deepcopy(model).double(), cpu_dev, i)
                     if yardstick is None else yardstick[1](
                         copy.deepcopy(yardstick[0]), cpu_dev, i))
        return cpu, card, cpu64
    cpu, card, cpu64 = three(0)
    losses = lambda r: {k: v for k, v in r['losses'].items()  # noqa: E731
                        if k.startswith('loss')}
    lc, l32, l64 = losses(card), losses(cpu), losses(cpu64)
    rel = lambda a, b: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)  # noqa: E731,E501
                           for k in b)
    out = dict(losses_card_vs_cpu=rel(lc, l32),
               losses_card_vs_f64=rel(lc, l64),
               losses_cpu_f32_vs_f64=rel(l32, l64),
               stats_card_vs_cpu=leaf_rel(card['stats'], cpu['stats']),
               stats_card_vs_f64=leaf_rel(card['stats'], cpu64['stats']),
               stats_cpu_f32_vs_f64=leaf_rel(cpu['stats'], cpu64['stats']))
    for what in ('grads', 'updates'):
        out[f'{what}_card_vs_cpu'] = rel_l2(card[what], cpu[what])
        out[f'{what}_card_vs_f64'] = rel_l2(card[what], cpu64[what])
        out[f'{what}_cpu_f32_vs_f64'] = rel_l2(cpu[what], cpu64[what])
    floor = 1e-5 if yardstick is None else TRAIN_BF16_FLOOR
    run = 'f32' if yardstick is None else 'bf16'
    print(f'{label}, card vs CPU ({run}, TF32 off, same draws; "cpu_f32" '
          f'is the CPU {run} run); [global, worst leaf] relative L2 for '
          'gradients and updates: ' + json.dumps(out) + '; rule: '
          + (f'losses {TRAIN_LOSS_REL:g} of the CPU\'s, BatchNorm '
             f'statistics {TRAIN_STATS_REL:g}, gradients and updates'
             if yardstick is None else 'losses, BatchNorm statistics, '
             'gradients and updates') + ' no further from the f64 run '
          f'than {TRAIN_F64_FACTOR:g}x the CPU {run} run (+{floor:g})')
    print(f'{label} losses: card ' + json.dumps(card['losses'])
          + ' CPU ' + json.dumps(cpu['losses']))
    if yardstick is None:
        assert out['losses_card_vs_cpu'] <= TRAIN_LOSS_REL, \
            f'{label}: losses differ'
        assert out['stats_card_vs_cpu'] <= TRAIN_STATS_REL, \
            f'{label}: BatchNorm statistics differ'
    else:
        for what in ('losses', 'stats'):
            assert out[f'{what}_card_vs_f64'] <= TRAIN_F64_FACTOR * out[
                f'{what}_cpu_f32_vs_f64'] + floor, \
                f'{label}: {what} further from f64 than the CPU\'s'
    for what in ('grads', 'updates'):
        for i, scope in enumerate(('global', 'worst leaf')):
            assert out[f'{what}_card_vs_f64'][i] <= TRAIN_F64_FACTOR * out[
                f'{what}_cpu_f32_vs_f64'][i] + floor, \
                f'{label}: {what} ({scope}) further from f64 than {run}'
    if yardstick is not None:
        t0 = time.perf_counter()
        runs = [(card['grads'], cpu['grads'], cpu64['grads'])]
        for i in range(1, batches):
            c, g, f = three(i)
            runs.append((g['grads'], c['grads'], f['grads']))
        out['direction'] = bf16_direction(runs, group, zeroed, label)
        print(f'{label}: {batches - 1} more batches in '
              f'{time.perf_counter() - t0:.1f} s')
    return out


def train_card_vs_cpu(torch, device):
    """The reduced 6DoF step (``tiny_train_cfg``, 4 crops), card against
    CPU (:func:`card_vs_cpu`)."""
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.utils.synthetic import make_sixdof_batch
    cfg = tiny_train_cfg()
    model, _, _ = smain.build_all(cfg, device='cpu')
    smain.init_state(cfg, model, seed=3)
    batch = tuple(make_sixdof_batch(3, 4, 64, 16).values())
    return card_vs_cpu(
        torch, device, model, lambda m, dev, i: train_step_snapshot(
            torch, cfg, m, batch, dev), 'path j: reduced step')


def train_bf16_card_vs_cpu(torch, device, remat=False):
    """Path t's reduced step (``tiny_train_cfg`` with ``bf16_backbone``,
    and ``remat``), card against CPU in bf16, with path j's weights in
    f64 and the options off as the yardstick (:func:`card_vs_cpu`)."""
    import dataclasses
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.utils.synthetic import make_sixdof_batch
    cfg = tiny_train_cfg()
    model, _, _ = smain.build_all(cfg, device='cpu')
    smain.init_state(cfg, model, seed=3)
    cfg_b = dataclasses.replace(cfg, network=dataclasses.replace(
        cfg.network, bf16_backbone=True, remat=remat))
    model_b, _, _ = smain.build_all(cfg_b, device='cpu')
    model_b.load_state_dict(model.state_dict())
    batches = [tuple(make_sixdof_batch(3 + i, 4, 64, 16).values())
               for i in range(TRAIN_BF16_BATCHES_6DOF)]
    return card_vs_cpu(
        torch, device, model_b, lambda m, dev, i: train_step_snapshot(
            torch, cfg_b, m, batches[i], dev),
        f'path t{" remat" if remat else ""}: reduced bf16 step',
        yardstick=(model.double(), lambda m, dev, i: train_step_snapshot(
            torch, cfg, m, batches[i], dev)),
        group=lambda name: name.split('.')[0], zeroed='backbone',
        batches=len(batches))


def profile_step(torch, fn, wrapped, label):
    """One call of ``fn`` (a training step) under ``torch.profiler``, with
    each ``wrapped`` method (label -> (owner, name)) in a named range.
    Returns ``(wall ms, device ms of each range, the device kernels, their
    self device ms)``, or None (printed) where the trace is unreadable. The
    ranges (and torch's own Optimizer.step annotation) also show on the
    device timeline, as spans from their first kernel to their last: not
    kernels, but the device-time extent of each range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = {}

    def scoped(name, real):
        def call(*args, **kwargs):
            with record_function(name):
                return real(*args, **kwargs)
        return call

    for name, (owner, attr) in wrapped.items():
        saved[name] = getattr(owner, attr)
        setattr(owner, attr, scoped(name, saved[name]))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, (owner, attr) in wrapped.items():
            setattr(owner, attr, saved[name])
    try:
        dev = lambda e: (getattr(e, 'device_time_total', None)  # noqa: E731
                         or getattr(e, 'cuda_time_total', 0)) / 1e3
        self_dev = lambda e: (getattr(e, 'self_device_time_total', None)  # noqa: E731,E501
                              or getattr(e, 'self_cuda_time_total', 0)) / 1e3
        ranges = dict.fromkeys(wrapped, 0.0)
        for e in prof.events():
            if e.name in ranges and str(e.device_type).endswith('CPU'):
                ranges[e.name] += dev(e)
        device_rows = [e for e in prof.key_averages()
                       if str(getattr(e, 'device_type', '')).endswith('CUDA')]
        is_span = lambda e: (getattr(e, 'is_user_annotation', False)  # noqa: E731,E501
                             or e.key in wrapped
                             or e.key.startswith('Optimizer.'))
        kernels = [e for e in device_rows if not is_span(e)]
        return wall, ranges, kernels, self_dev
    except Exception as err:  # noqa: BLE001 - reading the trace only
        print(f'{label}: profile unreadable ({type(err).__name__}: {err})')
        return None


def print_kinds(label, kinds, kernels, self_dev, top):
    print(f'{label}: one training step by kind (ms): ' + json.dumps(kinds))
    for e in sorted(kernels, key=self_dev, reverse=True)[:top]:
        print(f'{label}:   {self_dev(e):9.3f} ms  x{e.count:<5d} '
              f'{e.key[:90]}')


def kernel_share(kernels, self_dev, *keys):
    """Self device ms of the kernels whose name holds one of ``keys``."""
    return sum(self_dev(e) for e in kernels
               if any(k in e.key.lower() for k in keys))


CUDNN_GEMM_KEYS = ('conv', 'cudnn', 'xmma', 'gemm', 'cutlass', 'dgrad',
                   'wgrad', 'implicit', 'winograd', 'fft')


def profile_train_step(torch, fn):
    """One 6DoF training step by kind: the CDPN forward, the AMIS forward
    (K1 apart), K1, the backward (CDPN and PnP graph), the optimizer;
    cuDNN/GEMM kernels over both passes; the device-idle share of the
    step's wall time."""
    from epropnp_tpu_torch.models.cdpn import CDPN
    from epropnp_tpu_torch.ops.pnp.epropnp import EProPnPBase
    from epropnp_tpu_torch.sixdof.train import RMSprop
    got = profile_step(torch, fn, {
        'cdpn forward': (CDPN, 'forward'),
        'amis forward': (EProPnPBase, 'monte_carlo_forward'),
        'optimizer': (RMSprop, 'step')}, 'path j')
    if got is None:
        return None
    wall, ranges, kernels, self_dev = got
    busy = sum(self_dev(e) for e in kernels)
    k1 = kernel_share(kernels, self_dev, 'lm_solve_kernel')
    kinds = dict(
        wall_ms=wall, device_busy_ms=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall),
        cdpn_forward_ms=ranges['cdpn forward'],
        amis_forward_without_k1_ms=ranges['amis forward'] - k1,
        k1_ms=k1, optimizer_ms=ranges['optimizer'],
        backward_and_rest_ms=busy - ranges['cdpn forward']
        - ranges['amis forward'] - ranges['optimizer'],
        cudnn_gemm_kernels_ms=kernel_share(kernels, self_dev,
                                           *CUDNN_GEMM_KEYS),
        kernel_launches=int(sum(e.count for e in kernels)))
    print_kinds('path j', kinds, kernels, self_dev, 8)
    return kinds


def path_train(torch, device, steps=10, warmup=2, bs=32, label='path j',
               network=None):
    """``sixdof.main.train_loop`` at ``SixDoFConfig.epropnp_basic()`` width
    (CDPN-34, 32 crops of 256x256, K1 on) on seeded synthetic batches,
    with its default prefetch: ``steps`` steps, the first ``warmup``
    untimed. ``network``: NetworkConfig fields on top (path t's
    ``bf16_backbone`` and ``remat``)."""
    import dataclasses
    import tempfile
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.sixdof import train as strain
    from epropnp_tpu_torch.sixdof.config import SixDoFConfig
    from epropnp_tpu_torch.utils.synthetic import SyntheticSixDoFDataset
    base = SixDoFConfig.epropnp_basic()
    cfg = dataclasses.replace(
        base, pnp=dataclasses.replace(base.pnp, use_pallas=True),
        train=dataclasses.replace(base.train, begin_epoch=0, end_epoch=1,
                                  train_batch_size=bs),
        network=dataclasses.replace(base.network, **(network or {})))
    t0 = time.perf_counter()
    data = SyntheticSixDoFDataset(steps * bs, 256, 64, seed=0)
    print(f'{label}: {steps * bs} synthetic samples made in '
          f'{time.perf_counter() - t0:.1f} s')
    stamps, metrics, step_peaks = [], [], []

    def on_step(epoch, i, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
        step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        state = smain.train_loop(cfg, data, save_dir, device=device,
                                 log_interval=steps, on_step=on_step)
        total = time.perf_counter() - t0
    peak = max(step_peaks + [torch.cuda.max_memory_allocated() / 2 ** 30])
    for i, m in enumerate(metrics):
        print(f'{label}: step {i}{" (warm-up)" if i < warmup else ""}: '
              + json.dumps({k: round(v, 6) for k, v in m.items()}))
    timed = steps - warmup
    ms = (stamps[-1] - stamps[warmup - 1]) / timed * 1e3
    skipped = int(sum(m['skipped'] for m in metrics))
    out = dict(network=network or {}, steps=steps, timed_steps=timed,
               ms_per_step=ms, samples_per_s=bs / ms * 1e3,
               skipped_steps=skipped,
               loop_s_with_build_and_checkpoint=total, peak_mem_gib=peak,
               peak_mem_step0_gib=step_peaks[0],
               peak_mem_timed_steps_gib=max(step_peaks[warmup:]))
    print(f'{label}: ' + json.dumps(out))
    assert len(metrics) == steps, 'train_loop: wrong number of steps'
    assert metrics[0]['skipped'] == 0, 'train_loop: first step skipped'
    assert all(np.isfinite(v) for m in metrics for v in m.values()), \
        'train_loop: non-finite loss'
    fresh, _, _ = smain.build_all(cfg, device=device)
    smain.init_state(cfg, fresh, seed=0)
    moved = [k for k, p in state.model.named_parameters()
             if not torch.equal(p, dict(fresh.named_parameters())[k])]
    print(f'{label}: {len(moved)} of {len(list(fresh.parameters()))} '
          'parameter tensors moved')
    assert moved, 'train_loop: the parameters did not change'
    # one more step, profiled (its launches are outside the counted run)
    step = strain.make_train_step(strain.build_epropnp(cfg), cfg,
                                  torch.tensor(LINEMOD_K, device=device))
    batch = smain.to_device(next(data.batches(bs, seed=9)), device)
    gen = torch.Generator(device=device).manual_seed(9)
    return dict(out, ms=ms, skipped=skipped,
                profile=lambda: profile_train_step(
                    torch, lambda: step(state, batch, gen)))


def path_train_bf16(torch, device, remat, f32):
    """Path t: path j's training with ``network.bf16_backbone`` (and
    ``network.remat``), printed beside path j's numbers (``f32``) from the
    same run."""
    label = f'path t{" remat" if remat else ""}'
    out = path_train(torch, device, TRAIN_STEPS, label=label,
                     network=dict(bf16_backbone=True, remat=remat))
    keys = ('ms_per_step', 'samples_per_s', 'peak_mem_gib',
            'peak_mem_step0_gib', 'peak_mem_timed_steps_gib')
    print(f'{label} beside path j (f32, same run): ' + json.dumps(
        {k: [out.get(k), (f32 or {}).get(k)] for k in keys}))
    out.pop('profile')
    return out


def path_fit_identity(torch, device):
    """The reduced ``fit_identity`` demo (8192 poses, batches of 256, 2
    epochs, the full EProPnP6DoF stack): the loss must fall."""
    from epropnp_tpu_torch.demo import fit_identity
    res = fit_identity.run(n_data=8192, batch_size=256, n_epoch=2,
                           device=device, verbose=False)
    losses = np.array(res['losses'])
    first, last = np.nanmean(losses[:8]), np.nanmean(losses[-8:])
    print('path k: fit_identity reduced ' + json.dumps(dict(
        steps=res['steps'], train_s=res['train_s'],
        ms_per_step=res['train_s'] / res['steps'] * 1e3,
        skipped=res['skipped'], loss_first8=float(first),
        loss_last8=float(last), mean_trans_err=res['mean_trans_err'],
        mean_orient_err=res['mean_orient_err'])))
    assert last < first, 'fit_identity: the loss did not fall'
    return res


# ------------------------------------------------------------ Det training

# K3's backward (phase m) against torch autograd through the twin, f32 on
# both sides: max|d| <= (2e-4 + 2e-5) max|ref| per gradient, the JAX DCN
# gradient rule (rtol 2e-4, atol 2e-5; tests/test_pallas_dcn.py:63) put
# relative to the largest entry.
DCN_BWD_REL = 2e-4 + 2e-5
DCN_BWD_SHAPES = [  # (n, h, w, c, cout, stride, what)
    (6, 42, 100, 256, 256, 1, 'backbone stage 3 (x22 per step)'),
    (6, 84, 200, 256, 256, 2, 'backbone stage 3 first block'),
    (6, 84, 200, 256, 256, 1, 'FCOS towers, level 0 (x2 per step)'),
]
# Path n: steps of det.main.train_loop at v1b, the last DET_TRAIN_TIMED
# timed; per step K2 with bounds twice (the Monte Carlo forward's init and
# the score solve), K3-f32 36 times (26 backbone DCNs, 2 towers x 5
# levels) and K1 twice in its training modes.
DET_TRAIN_STEPS, DET_TRAIN_TIMED = 6, 4
DET_STEP_LAUNCHES = {'K2-bounds': 2, 'K3-f32': 36, 'K1-train': 2}
# Path s (bf16 backbone and dense stage, packed towers): K3-bf16 26 times
# in the backbone and once per FCOS tower on the canvas; twice that with
# remat_dense, whose backward runs the dense forward again.
DET_BF16_K3_PER_STEP = 28
# nuScenes CAM_FRONT-like intrinsics after the sky crop (1600x900 ->
# 1600x672, 228 rows off the top)
NUSCENES_K_CROPPED = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 263.5],
                      [0.0, 0.0, 1.0]]


def phase_l(torch, device):
    """K2 with projection bounds (dof 4, N=128, 64 proposals x 16 points x
    3 iterations) against its twin and an f64 twin, at B=288 (one v1b
    training step's objects) and B=1536."""
    from epropnp_tpu_torch.ops.pnp import PerspectiveCamera, HuberPnPCost
    from epropnp_tpu_torch.ops.pnp import evaluate_pnp
    from epropnp_tpu_torch.ops.pnp import rslm_kernel as k2
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_bounded_pnp_problem
    rows = []
    for b in (288, 1536):
        p = make_bounded_pnp_problem(b, 128, 90, 4)
        t = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in p.items()}
        seeds = torch.randint(0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(b)
                              ).to(device)
        args = (t['x3d'], t['x2d'], t['w2d'],
                camera_to_fxfycxcy(t['cams']).contiguous(), t['delta'],
                seeds)
        kw = dict(bounds=t['bounds'], dof=4, num_points=16,
                  num_proposals=64, num_iter=3, z_min=0.1, score_points=128)
        run_k = lambda: k2.rslm_init_cuda(*args, **kw)  # noqa: E731
        run_t = lambda: k2.rslm_init_reference(*args, **kw)  # noqa: E731
        pk, ck = run_k()
        _, ct = run_t()
        _, c64 = k2.rslm_init_reference(
            *(a.double() for a in args[:5]), seeds,
            **dict(kw, bounds=t['bounds'].double()))
        camera = PerspectiveCamera(cam_mats=t['cams'], z_min=0.1,
                                   lb=t['bounds'][:, :2],
                                   ub=t['bounds'][:, 2:])
        ev = evaluate_pnp(t['x3d'], t['x2d'], t['w2d'], pk, camera,
                          HuberPnPCost(delta=t['delta']), out_cost=True).cost
        torch.cuda.synchronize()
        ck_n, ct_n, c64_n, ev_n = (a.cpu().numpy()
                                   for a in (ck, ct, c64, ev))
        assert torch.isfinite(pk).all() and np.isfinite(ck_n).all(), \
            'K2 with bounds non-finite'
        lo, hi = p['bounds'][:, None, :2], p['bounds'][:, None, 2:]
        past = ((p['x2d'] < lo) | (p['x2d'] > hi)).any(-1)
        row = dict(B=b, N=128, dof=4, points_past_bounds=float(past.mean()),
                   objects_past_bounds=float(past.any(-1).mean()),
                   per_object_agree=frac_close(ck_n, ct_n),
                   kernel_vs_f64_cost_agree=frac_close(ck_n, c64_n),
                   twin_f32_vs_f64_cost_agree=frac_close(ct_n, c64_n),
                   consistency=float(agree(ck_n, ev_n, K2_CONSIST_RTOL,
                                           0.0).mean()),
                   median_cost=float(np.median(ck_n)),
                   twin_median_cost=float(np.median(ct_n)),
                   max_abs_cost_err=float(np.abs(ck_n - ct_n).max()))
        row['ms'] = time_ms(torch, run_k, iters=10)
        row['device_ms'] = device_ms(torch, run_k, 'rslm_init_kernel')
        row['plain_ms'] = time_ms(torch, run_t, iters=3)
        flops = b * kw['num_proposals'] * (
            K1_POINT_FLOPS[4] * kw['num_points'] * (kw['num_iter'] + 1)
            + K2_SCORE_FLOPS * 128)
        row['bound_ms'], row['bound_by'] = bound_ms(
            flops, b * (28 * 128 + 4 * (4 + 4 + 1 + 1 + 4 + 1)))
        row['bound_share'] = row['bound_ms'] / row['ms']
        print('phase l: K2 with bounds ' + json.dumps(row))
        assert row['per_object_agree'] >= K1_MIN_FRAC or (
            row['kernel_vs_f64_cost_agree']
            >= row['twin_f32_vs_f64_cost_agree'] - 0.005), \
            f'K2 with bounds disagrees with its twin at B={b}'
        assert row['consistency'] == 1.0, \
            'K2 with bounds: cost is not the bounded cost of its pose'
        assert row['median_cost'] <= K2_MEDIAN_RATIO * row[
            'twin_median_cost'], 'K2 with bounds: init worse than 2x twin'
        rows.append(row)
    pooled = k2_bounds_pooled(torch, device)
    print('phase l: K2 with bounds, pooled over 40 problems '
          + json.dumps(pooled))
    assert pooled['kernel_vs_f64_cost_agree'] >= pooled[
        'twin_f32_vs_f64_cost_agree'] - 0.005, \
        'K2 with bounds: pooled, further from f64 than the f32 twin'
    main = rows[0]
    return dict(name='rslm_init with projection bounds (K2)', route='cuda',
                source='epropnp_tpu_torch/csrc/rslm_kernel.cu',
                replaces='epropnp_tpu/ops/pnp/pallas_rslm.py:817',
                max_abs_err=max(r['max_abs_cost_err'] for r in rows),
                ms=main['ms'], device_ms=main['device_ms'],
                plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=None)


def k2_bounds_pooled(torch, device):
    """Phase l's per-object shares pooled over 40 problems (B=288 and 1536,
    problem seeds 21-30, object seeds ``arange * 7919`` and drawn): which of
    two near-tied proposals wins is decided by f32 rounding, so one problem
    of 288 objects moves the shares by a few percent either way."""
    from epropnp_tpu_torch.ops.pnp import rslm_kernel as k2
    from epropnp_tpu_torch.ops.pnp.lm_kernel import camera_to_fxfycxcy
    from epropnp_tpu_torch.utils.synthetic import make_bounded_pnp_problem
    costs, spread = [], []
    for b in (288, 1536):
        for seed in range(21, 31):
            p = make_bounded_pnp_problem(b, 128, seed, 4)
            t = {k: torch.tensor(v, dtype=torch.float32, device=device)
                 for k, v in p.items()}
            for drawn in (False, True):
                seeds = (torch.randint(
                    0, 2 ** 31 - 1, (b,), dtype=torch.int32,
                    generator=torch.Generator().manual_seed(seed)) if drawn
                    else torch.arange(b, dtype=torch.int32) * 7919).to(device)
                args = (t['x3d'], t['x2d'], t['w2d'],
                        camera_to_fxfycxcy(t['cams']).contiguous(),
                        t['delta'], seeds)
                kw = dict(bounds=t['bounds'], dof=4, num_points=16,
                          num_proposals=64, num_iter=3, z_min=0.1,
                          score_points=128)
                ck = k2.rslm_init_cuda(*args, **kw)[1]
                ct = k2.rslm_init_reference(*args, **kw)[1]
                c64 = k2.rslm_init_reference(
                    *(a.double() for a in args[:5]), seeds,
                    **dict(kw, bounds=t['bounds'].double()))[1]
                c = [a.cpu().numpy() for a in (ck, ct, c64)]
                costs.append(c)
                if b == 288:
                    spread.append(frac_close(c[0], c[2])
                                  - frac_close(c[1], c[2]))
    ck, ct, c64 = (np.concatenate(c) for c in zip(*costs))
    return dict(objects=len(ck), per_object_agree=frac_close(ck, ct),
                kernel_vs_f64_cost_agree=frac_close(ck, c64),
                twin_f32_vs_f64_cost_agree=frac_close(ct, c64),
                b288_kernel_minus_twin_share_range=[min(spread),
                                                    max(spread)])


def phase_m(torch, device):
    """K3's gradient (the kernel's forward in ``DCNFunction``, the
    ``dcn_backward`` torch ops) against torch autograd through the twin,
    f32 and f64, at the Det training shapes (6 images of 672x1600)."""
    from epropnp_tpu_torch.ops import dcn_kernel as k3
    rows = []
    names = ('x', 'offset_mask', 'weight', 'bias')
    for i, (n, h, w, c, cout, stride, what) in enumerate(DCN_BWD_SHAPES):
        x, om, weight = dcn_problem(torch, device, n, h, w, c, cout, stride,
                                    70 + i)
        gen = torch.Generator(device=device).manual_seed(70 + i)
        bias = torch.randn((cout,), generator=gen, device=device) * 0.1
        ho, wo = k3.output_hw(h, w, stride)
        ct = torch.randn((n, ho, wo, cout), generator=gen, device=device)

        def grads(fn, dtype):
            leaves = [t.to(dtype).clone().requires_grad_()
                      for t in (x, om, weight, bias)]
            out = fn(*leaves, stride=stride)
            return torch.autograd.grad(out, leaves, ct.to(dtype))

        g_k = grads(k3.dcn_forward, torch.float32)
        g_32 = grads(k3.dcn_reference, torch.float32)
        g_64 = grads(k3.dcn_reference, torch.float64)
        torch.cuda.synchronize()
        row = dict(shape=[n, h, w, c, cout], stride=stride, what=what,
                   L=n * ho * wo)
        for name, a, b32, b64 in zip(names, g_k, g_32, g_64):
            scale = float(b32.abs().max())
            row[f'{name}_rel_err'] = float((a - b32).abs().max()) / scale
            row[f'{name}_rel_err_f64'] = float(
                (a.double() - b64).abs().max()) / float(b64.abs().max())
            row[f'{name}_twin_f32_rel_err_f64'] = float(
                (b32.double() - b64).abs().max()) / float(b64.abs().max())
            assert torch.isfinite(a).all(), f'K3 backward: {name} non-finite'
        del g_k, g_32, g_64
        w3 = k3.kernel_weight(weight)
        with torch.no_grad():
            row['forward_ms'] = time_ms(torch, lambda: k3.dcn_forward_cuda(
                x, om, w3, None, stride), iters=10)
            row['backward_ms'] = time_ms(torch, lambda: k3.dcn_backward(
                x, om, w3, ct, stride, 2.0), warmup=1, iters=5)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            k3.dcn_backward(x, om, w3, ct, stride, 2.0)
            torch.cuda.synchronize()
            row['backward_peak_extra_gib'] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 30
        length = n * ho * wo
        # the two products (d_s = ct W^T, d_W = s^T ct) and the corner
        # work (combine, <g, d_s>, scatter: ~24 operations per tap and
        # channel); each input read and each output written once
        flops = 4 * length * 9 * c * cout + 24 * length * 9 * c
        nbytes = 4 * (2 * n * h * w * c + 2 * length * 27
                      + 2 * 9 * c * cout + length * cout + cout)
        row['backward_bound_ms'], row['backward_bound_by'] = bound_ms(
            flops, nbytes)
        print('phase m: K3 backward ' + json.dumps(row) + f'; rule: '
              f'max|d| <= {DCN_BWD_REL:g} max|ref| (f32 autograd of the twin)')
        for name in names:
            assert row[f'{name}_rel_err'] <= DCN_BWD_REL, \
                f'K3 backward: {name} disagrees at {what}'
        rows.append(row)
        del x, om, weight, bias, ct
        torch.cuda.empty_cache()
    return rows + phase_m_variants(torch, device)


# Phase m's rows with a bf16 map and with a level table (n, h, w, c, cout,
# stride, map dtype, what; h None: the packed canvas of FCOS_LEVELS_672).
# The rule: against torch autograd of the twin in f32 on the same
# (bf16-rounded) inputs, within K3_VARIANT_REL max|ref| for a bf16 map
# (its gradients of the map and the offsets come back rounded to bf16),
# DCN_BWD_REL for the f32 level table.
DCN_BWD_VARIANTS = [
    (6, 42, 100, 256, 256, 1, 'bf16', 'backbone stage 3, bf16 map'),
    (6, 84, 200, 256, 256, 2, 'bf16',
     'backbone stage 3 first block, bf16 map'),
    (6, None, None, 256, 256, 1, 'f32',
     'FCOS towers, packed canvas, level table'),
    (6, None, None, 256, 256, 1, 'bf16',
     'FCOS towers, packed canvas, level table, bf16 map'),
]


def phase_m_variants(torch, device):
    """K3's gradient with a bf16 map (the bf16 backbone) and with a level
    table (the packed FCOS towers, f32 and bf16): ``dcn_forward`` under
    autograd (``DCNFunction``: the kernel's forward, ``dcn_backward``)
    against torch autograd of the twin in f32 on the same bf16-rounded
    inputs (and in f64); the backward's time, bound and extra peak."""
    from epropnp_tpu_torch.ops import dcn_kernel as k3
    from epropnp_tpu_torch.ops.level_pack import (
        pack_levels, plan_level_packing)
    rows = []
    names = ('x', 'offset_mask', 'weight', 'bias')
    for i, (n, h, w, c, cout, stride, dt, what) in enumerate(
            DCN_BWD_VARIANTS):
        levels = None
        if h is None:
            layout = plan_level_packing(FCOS_LEVELS_672)
            gen = torch.Generator(device=device).manual_seed(81 + i)
            canvas = pack_levels([torch.randn((n, lh, lw, c), generator=gen,
                                              device=device)
                                  for lh, lw in FCOS_LEVELS_672], layout)
            x, om, weight = dcn_problem(torch, device, n, None, None, c,
                                        cout, 1, 80 + i, x=canvas)
            del canvas
            levels = layout.regions()
            h, w = layout.canvas_hw
            length = n * sum(lh * lw for lh, lw in FCOS_LEVELS_672)
            out_shape = (length, cout)
        else:
            x, om, weight = dcn_problem(torch, device, n, h, w, c, cout,
                                        stride, 80 + i)
            ho, wo = k3.output_hw(h, w, stride)
            length = n * ho * wo
            out_shape = (n, ho, wo, cout)
        gen = torch.Generator(device=device).manual_seed(90 + i)
        bias = torch.randn((cout,), generator=gen, device=device) * 0.1
        ct = torch.randn(out_shape, generator=gen, device=device)
        if dt == 'bf16':  # what a bf16 dense stage feeds K3
            x, om, ct = x.bfloat16(), om.bfloat16(), ct.bfloat16()
            weight = weight.bfloat16().float()
        w3 = k3.kernel_weight(weight)

        def grads(fn, cast):
            leaves = [t.to(cast(t)).clone().requires_grad_()
                      for t in (x, om, w3, bias)]
            out = fn(*leaves, stride=stride, levels=levels)
            return torch.autograd.grad(out, leaves, ct.to(out.dtype))

        g_k = grads(k3.dcn_forward, lambda t: t.dtype)
        g_32 = grads(k3.dcn_reference, lambda t: torch.float32)
        g_64 = grads(k3.dcn_reference, lambda t: torch.float64)
        torch.cuda.synchronize()
        rel = K3_VARIANT_REL if dt == 'bf16' else DCN_BWD_REL
        row = dict(shape=[n, h, w, c, cout], stride=stride, map=dt,
                   levels=len(levels or [0]), what=what, L=length,
                   grad_dtypes=[str(g.dtype) for g in g_k])
        for name, a, b32, b64 in zip(names, g_k, g_32, g_64):
            scale = float(b32.abs().max())
            row[f'{name}_rel_err'] = float(
                (a.float() - b32).abs().max()) / scale
            row[f'{name}_rel_err_f64'] = float(
                (a.double() - b64).abs().max()) / float(b64.abs().max())
            assert torch.isfinite(a).all(), f'K3 backward: {name} non-finite'
        if levels is not None:  # nothing reaches the gaps
            gaps = layout.mask(device=device)[..., 0] == 0
            row['gap_grad_max'] = max(float(g_k[0][:, gaps].abs().max()),
                                      float(g_k[1][:, gaps].abs().max()))
            assert row['gap_grad_max'] == 0, 'gradient in the canvas gaps'
        del g_k, g_32, g_64
        with torch.no_grad():
            row['backward_ms'] = time_ms(torch, lambda: k3.dcn_backward(
                x, om, w3, ct, stride, 2.0, levels=levels), warmup=1,
                iters=5)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            k3.dcn_backward(x, om, w3, ct, stride, 2.0, levels=levels)
            torch.cuda.synchronize()
            row['backward_peak_extra_gib'] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 30
        # phase m's count: the two products and ~24 operations per tap and
        # channel of corner work; each input read and each output written
        # once, in its own dtype
        flops = 4 * length * 9 * c * cout + 24 * length * 9 * c
        nbytes = (2 * x.numel() * x.element_size()
                  + 2 * om.numel() * om.element_size()
                  + 2 * 9 * c * cout * 4 + ct.numel() * ct.element_size()
                  + cout * 4)
        row['backward_bound_ms'], row['backward_bound_by'] = bound_ms(
            flops, nbytes)
        print('phase m: K3 backward ' + json.dumps(row) + f'; rule: '
              f'max|d| <= {rel:g} max|ref| (f32 autograd of the twin on '
              'the same inputs)')
        for name in names:
            assert row[f'{name}_rel_err'] <= rel, \
                f'K3 backward: {name} disagrees at {what}'
        rows.append(row)
        del x, om, weight, bias, ct
        torch.cuda.empty_cache()
    return rows


def tiny_det_cfg():
    """``tests/test_det_train.py::tiny_cfg`` (ResNet-18, 32-wide head,
    64x64 images), K1 on; the model gets DCNv2 in its FCOS towers."""
    from epropnp_tpu_torch.det.config import (DetConfig, DetPnPConfig,
                                              DetTrainConfig)
    return DetConfig(
        num_classes=3, backbone_depth=18, embed_dims=32, num_heads=4,
        num_points=4, strides=(4, 8, 16, 32), output_stride=4,
        with_loss_regr=True, num_attrs=4,
        pnp=DetPnPConfig(mc_samples=16, num_iter=2, lm_num_iter=2,
                         rs_num_points=8, rs_num_proposals=4, rs_num_iter=1,
                         use_pallas=True),
        train=DetTrainConfig(num_obj_samples_per_img=4, roi_shape=(8, 8),
                             max_gt_per_img=4))


TINY_DET_OVERRIDES = dict(
    backbone_dcn_stages=(), dcn_on_last_conv=True,
    detector_cfg=dict(feat_channels=32, emb_channels=32, cls_branch=(32,),
                      centerness_branch=(16,), offset_branch=(32,),
                      emb_branch=(32,),
                      regress_ranges=((-1, 16), (16, 32), (32, 1e8))))


def det_step_snapshot(torch, cfg, model, batch, device):
    """One Det training step of ``model`` on ``device``
    (:func:`step_snapshot`)."""
    from epropnp_tpu_torch.det import main as dmain
    from epropnp_tpu_torch.det import train as dtrain
    state = dmain.init_state(cfg, model)
    tb = dmain.to_device(batch, device, next(model.parameters()).dtype)
    return step_snapshot(torch, model, lambda: dtrain.make_train_step(cfg)(
        state, tb, torch.Generator().manual_seed(0)))


def det_train_card_vs_cpu(torch, device):
    """The reduced Det step (``tiny_det_cfg``, DCN in the towers, 2 images
    of 64x64), card against CPU (:func:`card_vs_cpu`); K3 must run on the
    card."""
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.utils.synthetic import (DET_BATCH_FIELDS,
                                                   make_det_batch)
    cfg = tiny_det_cfg()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = api.build_detector(cfg, **TINY_DET_OVERRIDES)
    b = make_det_batch(5)
    batch = tuple(b[k] for k in DET_BATCH_FIELDS)
    k3_0 = dcn_kernel.launches
    out = card_vs_cpu(torch, device, model,
                      lambda m, dev, i: det_step_snapshot(
                          torch, cfg, m, batch, dev),
                      'path n: reduced Det step', det=True)
    out['k3_launches_on_card'] = dcn_kernel.launches - k3_0
    print(f'path n: reduced Det step: {out["k3_launches_on_card"]} K3 '
          'launches on the card')
    assert out['k3_launches_on_card'] > 0, \
        'reduced Det step: K3 not launched on the card'
    return out


def det_train_bf16_card_vs_cpu(torch, device, remat=False):
    """Path s's reduced step (``tiny_det_cfg`` with ``bf16_backbone``,
    ``bf16_dense``, ``level_packed_towers``, and ``remat_dense``), card
    against CPU in bf16, with the same weights in f64 and the options off
    as the yardstick (:func:`card_vs_cpu`); K3-bf16 must run on the card
    (the towers' DCNs on the packed canvas)."""
    import dataclasses
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.ops.deform_conv import DeformConv
    from epropnp_tpu_torch.utils.synthetic import (DET_BATCH_FIELDS,
                                                   make_det_batch)
    cfg = tiny_det_cfg()
    cfg_b = dataclasses.replace(cfg, bf16_backbone=True, bf16_dense=True,
                                level_packed_towers=True, remat_dense=remat)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = api.build_detector(cfg, **TINY_DET_OVERRIDES)
    model_b = api.build_detector(cfg_b, **TINY_DET_OVERRIDES)
    model_b.load_state_dict(model.state_dict())
    batches = [tuple(make_det_batch(5 + i)[k] for k in DET_BATCH_FIELDS)
               for i in range(TRAIN_BF16_BATCHES)]
    dcn = {f'{mn}.{pn}' for mn, mod in model.named_modules()
           if isinstance(mod, DeformConv) for pn, _ in mod.named_parameters()}
    assert dcn, 'the reduced Det model has no DCN'

    def group(name):
        if name in dcn:
            return 'dcn'
        if name.startswith('bbox_head.'):
            return ('bbox_head.detector' if name.startswith(
                'bbox_head.detector.') else 'bbox_head')
        return name.split('.')[0]
    label = f'path s{" remat" if remat else ""}: reduced bf16 Det step'
    k3_0 = dcn_kernel.launches_bf16
    out = card_vs_cpu(
        torch, device, model_b, lambda m, dev, i: det_step_snapshot(
            torch, cfg_b, m, batches[i], dev), label, det=True,
        yardstick=(model.double(), lambda m, dev, i: det_step_snapshot(
            torch, cfg, m, batches[i], dev)), group=group, zeroed='dcn',
        batches=len(batches))
    out['k3_bf16_launches_on_card'] = dcn_kernel.launches_bf16 - k3_0
    print(f'{label}: {out["k3_bf16_launches_on_card"]} K3-bf16 launches '
          f'on the card over {TRAIN_BF16_BATCHES} batches')
    assert out['k3_bf16_launches_on_card'] == \
        2 * (2 if remat else 1) * TRAIN_BF16_BATCHES, \
        f'{label}: K3-bf16 not launched once per tower (twice with remat)'
    return out


def profile_det_train_step(torch, fn):
    """One Det training step by kind: the dense forward (backbone, FPN,
    FCOS, key/value: cuDNN and K3), K3, the DCN backward (torch ops), K1,
    K2, the AMIS forward without K1 and K2, the optimizer; cuDNN/GEMM
    kernels over both passes; the device-idle share of the step's wall
    time."""
    from epropnp_tpu_torch.det.train import AdamW
    from epropnp_tpu_torch.models.detectors.epropnp_det import EProPnPDet
    from epropnp_tpu_torch.ops import dcn_kernel
    from epropnp_tpu_torch.ops.pnp.epropnp import EProPnPBase
    got = profile_step(torch, fn, {
        'dense forward': (EProPnPDet, 'det_dense'),
        'amis forward': (EProPnPBase, 'monte_carlo_forward'),
        'dcn backward': (dcn_kernel, 'dcn_backward'),
        'optimizer': (AdamW, 'step')}, 'path n')
    if got is None:
        return None
    wall, ranges, kernels, self_dev = got
    busy = sum(self_dev(e) for e in kernels)
    k1 = kernel_share(kernels, self_dev, 'lm_solve_kernel')
    k2 = kernel_share(kernels, self_dev, 'rslm_init_kernel')
    kinds = dict(
        wall_ms=wall, device_busy_ms=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall),
        dense_forward_ms=ranges['dense forward'],
        k3_ms=kernel_share(kernels, self_dev, 'dcn_forward'),
        dcn_backward_ms=ranges['dcn backward'], k1_ms=k1, k2_ms=k2,
        amis_forward_without_k1_k2_ms=ranges['amis forward'] - k1 - k2,
        optimizer_ms=ranges['optimizer'],
        cudnn_gemm_kernels_ms=kernel_share(kernels, self_dev,
                                           *CUDNN_GEMM_KEYS),
        kernel_launches=int(sum(e.count for e in kernels)))
    print_kinds('path n', kinds, kernels, self_dev, 10)
    return kinds


def det_train_batches(steps, n_img=6):
    """Seeded synthetic Det training batches at the v1b geometry: 6 images
    of 1600x672 (the sky-cropped nuScenes frame), 32 GT slots with 12
    boxes each, 10 classes, 9 attributes."""
    from epropnp_tpu_torch.utils.synthetic import (DET_BATCH_FIELDS,
                                                   make_det_batch)
    out = []
    for i in range(steps):
        b = make_det_batch(200 + i, n_img, 672, 1600, gmax=32, n_valid=12,
                           cam=NUSCENES_K_CROPPED, x_range=(-6.0, 6.0),
                           depth=(10.0, 40.0), num_classes=10, num_attrs=9)
        out.append(tuple(b[k] for k in DET_BATCH_FIELDS))
    return out


def path_det_train(torch, device, steps=DET_TRAIN_STEPS, label='path n',
                   options=None, launches=DET_STEP_LAUNCHES):
    """``det.main.train_loop`` at ``DetConfig.v1b()`` width with
    ``use_pallas`` (ResNet-101-DCN, FPN, FCOSEmbHead, DeformPnPHead, AMIS
    128 samples, RSLM 64x16x3, LM 10, AdamW) on seeded synthetic batches of
    6 images of 1600x672, f32 with TF32 off (``options``: DetConfig fields
    on top, as path s's bf16 and remat): ``steps`` steps, the last
    DET_TRAIN_TIMED timed; every step's launches are checked against
    ``launches``. The peak of step 0 (cuDNN's exhaustive search) and that
    of the timed steps are reported apart."""
    import dataclasses
    import tempfile
    from epropnp_tpu_torch.det import main as dmain
    from epropnp_tpu_torch.det import train as dtrain
    from epropnp_tpu_torch.det.config import DetConfig
    base = DetConfig.v1b()
    cfg = dataclasses.replace(
        base, pnp=dataclasses.replace(base.pnp, use_pallas=True),
        train=dataclasses.replace(base.train, epochs=1, batch_size=6),
        **(options or {}))
    t0 = time.perf_counter()
    batches = det_train_batches(steps)
    print(f'{label}: {steps} synthetic batches of 6 images made in '
          f'{time.perf_counter() - t0:.1f} s')
    stamps, metrics, per_step, peaks = [], [], [], []
    last = dict(launch_counts())
    warmup = steps - DET_TRAIN_TIMED

    def on_step(epoch, i, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
        now = launch_counts()
        per_step.append({k: now[k] - last[k] for k in now})
        last.update(now)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        state = dmain.train_loop(cfg, lambda epoch: iter(batches), steps,
                                 save_dir, log_interval=steps, device=device,
                                 on_step=on_step)
        total = time.perf_counter() - t0
    peak = max(peaks + [torch.cuda.max_memory_allocated() / 2 ** 30])
    for i, (m, c) in enumerate(zip(metrics, per_step)):
        print(f'{label}: step {i}{" (warm-up)" if i < warmup else ""}: '
              + json.dumps({k: round(v, 6) for k, v in m.items()})
              + ' launches ' + json.dumps({k: v for k, v in c.items() if v}))
    ms = (stamps[-1] - stamps[warmup - 1]) / DET_TRAIN_TIMED * 1e3
    skipped = int(sum(m['skipped'] for m in metrics))
    out = dict(options=options or {}, steps=steps,
               timed_steps=DET_TRAIN_TIMED, ms_per_step=ms,
               images_per_s=6 / ms * 1e3, skipped_steps=skipped,
               first_step_s=stamps[0] - t0,
               loop_s_with_build_and_checkpoint=total, peak_mem_gib=peak,
               peak_mem_step0_gib=peaks[0],
               peak_mem_timed_steps_gib=max(peaks[warmup:]),
               launches_per_step=per_step[-1])
    print(f'{label}: ' + json.dumps(out))
    assert len(metrics) == steps, 'train_loop: wrong number of steps'
    assert all(np.isfinite(v) for m in metrics for v in m.values()), \
        'Det train_loop: a non-finite loss or grad_norm'
    for i, c in enumerate(per_step):
        others = {k: v for k, v in c.items() if k not in launches and v}
        assert all(c[k] == v for k, v in launches.items()) \
            and not others, f'{label}: training step {i}: launches {c}'
    step = dtrain.make_train_step(cfg)
    batch = dmain.to_device(batches[0], device)
    gen = torch.Generator(device=device).manual_seed(9)
    return dict(out, ms=ms, skipped=skipped, peak_gib=peak,
                profile=lambda: profile_det_train_step(
                    torch, lambda: step(state, batch, gen)))


def path_det_train_bf16(torch, device, remat, f32):
    """Path s: path n's training with the JAX package's training options
    (``bf16_backbone``, ``bf16_dense``, ``level_packed_towers``, with
    ``remat_dense`` or without), printed beside path n's numbers (``f32``)
    from the same run."""
    options = dict(bf16_backbone=True, bf16_dense=True,
                   level_packed_towers=True, remat_dense=remat)
    launches = dict(DET_STEP_LAUNCHES, **{'K3-f32': 0})
    launches = {k: v for k, v in launches.items() if v}
    launches['K3-bf16'] = DET_BF16_K3_PER_STEP * (2 if remat else 1)
    label = f'path s{" remat" if remat else ""}'
    out = path_det_train(torch, device, label=label, options=options,
                         launches=launches)
    keys = ('ms_per_step', 'images_per_s', 'peak_mem_step0_gib',
            'peak_mem_timed_steps_gib', 'launches_per_step')
    print(f'{label} beside path n (f32, same run): ' + json.dumps(
        {k: [out.get(k), (f32 or {}).get(k)] for k in keys}))
    out.pop('profile')
    return out


# ----------------------------------------- serving from weights, evaluation

# Path o: a flip-TTA v1b request runs the dense stage twice (K3-f32 2 x 36)
# and one solve (K1: the RSLM proposals, then the refine of both branches'
# points at (1536, 256)); the Monte Carlo scoring of its problem runs the
# proposals (K1) and the main solve with its JtJ (K1 in a training mode).
TTA_LAUNCHES = {'K3-f32': 72, 'K1': 2}
MC_SCORE_LAUNCHES = {'K1': 1, 'K1-train': 1}
ORIENT_BINS = 128
# Path p: 96 crops in batches of 32; K1 launches a batch by init.
EVAL_CROPS, EVAL_BATCH = 96, 32
EVAL_K1_PER_BATCH = {'epnp_device': 1, 'rslm': 2}


def pack_msgpack(obj, out: bytearray):
    """Append ``obj`` to ``out`` in the msgpack subset that
    ``flax.serialization.to_bytes`` writes: maps with str keys, str, bin,
    lists, bools, ints, floats, and numpy arrays as ext type 1 holding
    ``(shape, dtype name, C-order bytes)``. (A writer for the smoke run
    alone: the port reads such files, ``utils.checkpoint``.)"""
    import struct
    if isinstance(obj, dict):
        out += struct.pack('>BI', 0xdf, len(obj))
        for k, v in obj.items():
            pack_msgpack(str(k), out)
            pack_msgpack(v, out)
    elif isinstance(obj, str):
        b = obj.encode()
        out += struct.pack('>BI', 0xdb, len(b)) + b
    elif isinstance(obj, bytes):
        out += struct.pack('>BI', 0xc6, len(obj)) + obj
    elif isinstance(obj, (list, tuple)):
        out += struct.pack('>BI', 0xdd, len(obj))
        for v in obj:
            pack_msgpack(v, out)
    elif isinstance(obj, (bool, np.bool_)):
        out += b'\xc3' if obj else b'\xc2'
    elif isinstance(obj, int):
        out += struct.pack('>Bq', 0xd3, obj)
    elif isinstance(obj, float):
        out += struct.pack('>Bd', 0xcb, obj)
    elif isinstance(obj, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(obj)
        body = bytearray()
        pack_msgpack([[int(d) for d in a.shape], a.dtype.name, a.tobytes()],
                     body)
        out += struct.pack('>BIb', 0xc9, len(body), 1) + body
    else:
        raise TypeError(f'pack_msgpack: {type(obj).__name__}')


def same_results(a, b) -> bool:
    """Two ``results_to_numpy`` per-image, per-class lists equal bit for
    bit (NaN where NaN)."""
    return len(a) == len(b) and all(
        len(x) == len(y) and all(
            u.shape == v.shape and np.array_equal(u, v, equal_nan=True)
            for u, v in zip(x, y)) for x, y in zip(a, b))


def results_gap(a, b) -> float:
    """The largest |a - b| over two ``results_to_numpy`` lists of the same
    layout (inf where their shapes differ)."""
    gap = 0.0
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            if u.shape != v.shape:
                return float('inf')
            if u.size:
                gap = max(gap, float(np.nanmax(np.abs(u - v))))
    return gap


def same_state(torch, model, sd) -> bool:
    """``model``'s parameters and BatchNorm statistics equal ``sd``'s bit
    for bit (``num_batches_tracked``, a counter that flax does not keep
    and eval mode does not read, apart)."""
    got = model.state_dict()
    keys = {k for k in sd if not k.endswith('num_batches_tracked')}
    differ = sorted(k for k in keys
                    if k not in got or not torch.equal(got[k].cpu(), sd[k]))
    if differ:
        print(f'state differs at {len(differ)} entries, e.g. {differ[:5]}')
    return not differ and keys <= set(got)


def path_det_checkpoint_tta(torch, device, num_requests=3):
    """Path o: Det serving from a checkpoint with flip TTA at v1b width.

    Phase g's seeded weights are written as an mmdet-named ``.pth`` and,
    through ``utils.convert.det_variables`` and :func:`pack_msgpack`, as a
    flax msgpack file; each is loaded by ``det.api.init_detector``. Phase
    g's request 1 through the msgpack model must equal phase g's model's
    bit for bit; through the ``.pth`` model (which ``init_detector`` builds
    at mmcv's modulation scale 1.0, the file having ``conv_offset`` keys),
    it must equal phase g's model with that scale. Then 3 TTA requests of
    6 frames (each K3 72 times, K1 twice), a profile by kind, a 320x800 TTA
    request card against CPU twins, and the Monte Carlo scoring with the
    yaw density on the last request's problem."""
    import tempfile
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.ops.deform_conv import DeformConv
    from epropnp_tpu_torch.utils.convert import det_variables
    t0 = time.perf_counter()
    cfg, model = build_det_model(torch, device, seed=0)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    imgs, ks = det_frames(101)  # phase g's request 1

    def plain(m):
        infer = dtest.make_inference_fn(m, cfg, min_fcos_score=0.0)
        return api.inference_detector(
            m, cfg, imgs, ks, infer_fn=infer,
            rng=torch.Generator().manual_seed(1))[1]

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, 'epropnp_det_v1b.pth')
        torch.save({'meta': {}, 'state_dict': sd}, pth)
        mp = os.path.join(tmp, 'epropnp_det_v1b.msgpack')
        buf = bytearray()
        pack_msgpack(det_variables({k: v.numpy() for k, v in sd.items()},
                                   cfg), buf)
        with open(mp, 'wb') as f:
            f.write(buf)
        sizes = (os.path.getsize(pth), os.path.getsize(mp))
        t1 = time.perf_counter()
        model_mp = api.init_detector(cfg, checkpoint=mp, device=device)
        t2 = time.perf_counter()
        model_pth = api.init_detector(cfg, checkpoint=pth, device=device)
        t3 = time.perf_counter()
    print(f'path o: checkpoints written ({sizes[0] / 2 ** 20:.1f} MiB .pth, '
          f'{sizes[1] / 2 ** 20:.1f} MiB msgpack); loaded in '
          f'{t2 - t1:.2f} s (msgpack) and {t3 - t2:.2f} s (.pth); setup '
          f'{t3 - t0:.1f} s')
    assert same_state(torch, model_mp, sd), 'msgpack: weights differ'
    assert same_state(torch, model_pth, sd), '.pth: weights differ'
    scales = {m.modulation_scale for m in model_pth.modules()
              if isinstance(m, DeformConv)}
    assert scales == {1.0}, f'.pth model: modulation scales {scales}'
    ref, got_mp = plain(model), plain(model_mp)
    repeat = plain(model)
    for mod in model.modules():
        if isinstance(mod, DeformConv):
            mod.modulation_scale = 1.0
    ref1, got_pth = plain(model), plain(model_pth)
    bit_mp, bit_pth = same_results(got_mp, ref), same_results(got_pth, ref1)
    print(f'path o: phase g request 1 from the msgpack checkpoint bit for '
          f'bit: {bit_mp} (max gap {results_gap(got_mp, ref):.3e}); from the '
          f'.pth (scale 1.0) against phase g\'s model at scale 1.0: '
          f'{bit_pth} (max gap {results_gap(got_pth, ref1):.3e}); phase g\'s '
          f'model repeated: {same_results(repeat, ref)}')
    assert bit_mp and bit_pth, 'checkpoint round trip: results differ'
    del model, model_pth

    infer = dtest.make_tta_inference_fn(model_mp, cfg, min_fcos_score=0.0)
    captured = {}
    problem_fn, pnp_fn = infer.pnp_problem, infer.pnp

    def record_problem(*a, **k):
        captured['problem'] = problem_fn(*a, **k)
        return captured['problem']

    def record_pnp(*a, **k):
        out = pnp_fn(*a, **k)
        captured['pose'] = out[0]
        return out

    infer.pnp_problem, infer.pnp = record_problem, record_pnp
    lat = []
    for req in range(num_requests + 1):  # request 0 warms up
        imgs, ks = det_frames(100 + req)
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        _, out3d = api.inference_detector(
            model_mp, cfg, imgs, ks, infer_fn=infer, tta=True,
            rng=torch.Generator().manual_seed(req))
        dt = time.perf_counter() - t0
        after = launch_counts()
        counts = {k: after[k] - before[k] for k in after
                  if after[k] != before[k]}
        live = np.concatenate([a for im in out3d for a in im], 0)
        print(f'path o: TTA request {req}{" (warm-up)" if not req else ""}: '
              f'6 frames, latency {dt * 1e3:.3f} ms, launches '
              f'{json.dumps(counts)}, live objects {len(live)}, '
              f'finite={bool(np.isfinite(live).all())}')
        assert counts == TTA_LAUNCHES, f'TTA request: launches {counts}'
        assert np.isfinite(live).all(), 'non-finite live box'
        if req:
            lat.append(dt)
    print('path o: latency per 6-frame TTA request (ms): '
          + json.dumps([round(v * 1e3, 3) for v in lat]))
    # the same request with the RSLM samples drawn on the card (above, as
    # in phase g, a CPU generator draws them on the host)
    on_card = []
    for req in (1, 2):
        imgs, ks = det_frames(100 + req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.inference_detector(
            model_mp, cfg, imgs, ks, infer_fn=infer, tta=True,
            rng=torch.Generator(device).manual_seed(req))
        on_card.append(round((time.perf_counter() - t0) * 1e3, 3))
    print('path o: TTA requests 1-2 with a generator on the card (ms): '
          + json.dumps(on_card))
    kernels, wall = profile_once(torch, lambda: api.inference_detector(
        model_mp, cfg, imgs, ks, infer_fn=infer, tta=True,
        rng=torch.Generator().manual_seed(0)), 'det tta serving', top=12)
    if kernels:
        share = lambda *keys: sum(  # noqa: E731
            k[1] for k in kernels if any(s in k[0].lower() for s in keys))
        busy = sum(k[1] for k in kernels)
        print('path o: TTA request by kind: ' + json.dumps(dict(
            wall_ms=wall, device_busy_ms=busy,
            device_idle_share=max(0.0, 1.0 - busy / wall),
            k3_ms=share('dcn_forward'),
            cudnn_conv_ms=share('cudnn', 'conv', 'fprop', 'implicit_gemm'),
            k1_ms=share('lm_solve'))))

    x3d, x2d, w2d, camera, cost_fun = captured['problem'][2:]
    score_3d = captured['problem'][1][1]
    pose_opt = captured['pose']
    print(f'path o: TTA problem: {tuple(x3d.shape[:2])} objects x points')
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    out = dtest.mc_score_and_orient_density(
        cfg, x3d, x2d, w2d, camera, cost_fun, pose_opt,
        rng=torch.Generator(device).manual_seed(0), mc_scoring_ratio=0.5,
        orient_bins=ORIENT_BINS, score_3d=score_3d)
    ol = out['orient_logprob'].cpu().numpy()
    dt = time.perf_counter() - t0
    after = launch_counts()
    counts = {k: after[k] - before[k] for k in after
              if after[k] != before[k]}
    ok = np.isfinite(pose_opt.cpu().numpy()).all(-1)
    integral = np.exp(ol[ok]).sum(1) * (2 * np.pi / ORIENT_BINS)
    score = out['score_3d'].cpu().numpy()
    print('path o: Monte Carlo scoring and yaw density: ' + json.dumps(dict(
        ms=dt * 1e3, launches=counts, objects=int(len(ol)),
        finite_poses=int(ok.sum()),
        density_finite=bool(np.isfinite(ol[ok]).all()),
        integral_min=float(integral.min()),
        integral_max=float(integral.max()),
        score_3d_range=[float(np.nanmin(score)), float(np.nanmax(score))])))
    assert counts == MC_SCORE_LAUNCHES, f'MC scoring: launches {counts}'
    assert ok.mean() >= 0.99 and np.isfinite(ol[ok]).all(), \
        'yaw density: non-finite'
    np.testing.assert_allclose(integral, 1.0, rtol=1e-3,
                               err_msg='yaw density does not integrate to 1')
    assert np.isfinite(score[ok]).all() and (score[ok] >= 0).all() and (
        score[ok] <= 1).all(), 'MC score_3d outside [0, 1]'
    profile_once(torch, lambda: dtest.mc_score_and_orient_density(
        cfg, x3d, x2d, w2d, camera, cost_fun, pose_opt,
        rng=torch.Generator(device).manual_seed(0), mc_scoring_ratio=0.5,
        orient_bins=ORIENT_BINS, score_3d=score_3d), 'mc scoring', top=8)

    rel, rel64, pose_close, pose_agree = uncounted(
        lambda: reduced_size_agreement(torch, model_mp, cfg, tta=True))
    print(f'path o: 320x800 TTA card vs CPU twins: dense max rel err '
          f'{rel:.3e} (rule {DET_DENSE_REL:g}; CPU f32 vs f64 {rel64:.3e}), '
          f'poses within 1e-3 {pose_close:.4f}, or of equal cost '
          f'{pose_agree:.4f}')
    assert rel <= DET_DENSE_REL, 'TTA dense outputs: card and CPU disagree'
    assert pose_agree >= 0.99, 'TTA poses: card and CPU twins disagree'
    return lat


class SyntheticCrops:
    """``n`` seeded LineMOD-like test crops (``sixdof.dataset.Sample``):
    normal-distributed 256x256 inputs, a random rotation, a translation
    0.6-1.2 m ahead, a 60-140 px box around the projected centre; three
    classes with their model points and diameters."""
    classes = ['ape', 'cat', 'driller']

    def __init__(self, n, inp_res=256, out_res=64, seed=0):
        from epropnp_tpu_torch.sixdof.dataset import Sample
        r = np.random.default_rng(seed)
        k = np.array(LINEMOD_K)
        self.extents = {c: r.uniform(0.03, 0.1, 3).astype(np.float32)
                        for c in self.classes}
        self.models = {c: r.uniform(-e, e, (500, 3))
                       for c, e in self.extents.items()}
        self.diameters = {c: float(2 * np.linalg.norm(e))
                          for c, e in self.extents.items()}
        self.samples = []
        for i in range(n):
            q = r.normal(size=4)
            q /= np.linalg.norm(q)
            w, x, y, z = q
            rot = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)]])
            t = np.array([r.uniform(-0.1, 0.1), r.uniform(-0.1, 0.1),
                          r.uniform(0.6, 1.2)])
            c = (k @ t)[:2] / t[2]
            wh = r.uniform(60, 140, 2)
            self.samples.append(Sample(
                obj=self.classes[i % 3], obj_id=1 + i % 3,
                inp=r.normal(size=(inp_res, inp_res, 3)).astype(np.float32),
                target_coor=np.zeros((out_res, out_res, 3), np.float32),
                mask=np.ones((out_res, out_res), np.float32),
                loss_msk=np.ones((out_res, out_res, 3), np.float32),
                trans_local=np.zeros(3, np.float32),
                pose=np.concatenate([rot, t[:, None]], 1).astype(np.float32),
                c_box=c.astype(np.float32), s_box=float(wh.max() * 1.5),
                box=np.array([c[0] - wh[0] / 2, c[1] - wh[1] / 2, wh[0],
                              wh[1]], np.float32)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def min_extents(self, cls):
        return self.extents[cls]


def sixdof_eval_setup(torch, device, setup):
    """Path p's data and checkpoint, made once into ``setup``: a full-width
    CDPN-34 on seeded weights (BatchNorm calibrated on one seeded batch)
    written with ``utils.checkpoint.save_checkpoint`` into a temporary
    directory, and :class:`SyntheticCrops`."""
    if setup:
        return setup
    import tempfile
    from epropnp_tpu_torch.models.cdpn import CDPN
    from epropnp_tpu_torch.sixdof import train as train_lib
    from epropnp_tpu_torch.sixdof.config import (
        DataIterConfig, PnPConfig, SixDoFConfig)
    from epropnp_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = SixDoFConfig(dataiter=DataIterConfig(inp_res=256, out_res=64),
                       pnp=PnPConfig(use_pallas=True))
    torch.manual_seed(1)
    model = CDPN(depth=34, feat_hw=(8, 8)).to(device)
    r = np.random.default_rng(1)
    calibrate_batchnorm(torch, model, torch.tensor(
        r.normal(size=(EVAL_BATCH, 256, 256, 3)), dtype=torch.float32,
        device=device))
    setup['tmp'] = tempfile.TemporaryDirectory()
    setup['path'] = save_checkpoint(
        os.path.join(setup['tmp'].name, 'cdpn34.pt'),
        train_lib.TrainState(model, train_lib.make_optimizer(cfg, model, 1)))
    setup['state_dict'] = {k: v.detach().cpu()
                           for k, v in model.state_dict().items()}
    setup['cfg'] = cfg
    t0 = time.perf_counter()
    setup['data'] = SyntheticCrops(EVAL_CROPS)
    print(f'path p: {EVAL_CROPS} synthetic crops made in '
          f'{time.perf_counter() - t0:.1f} s; checkpoint '
          f'{os.path.getsize(setup["path"]) / 2 ** 20:.1f} MiB')
    return setup


def timed_test_loop(torch, run):
    """``run()`` (a call that reaches ``sixdof.main.test_loop``) with every
    batch of its ``infer_poses`` timed: returns ``(run(), batches)``. A
    batch's wall runs from the end of the previous batch's ``infer_poses``
    (from the call for the first batch, which loads the checkpoint) to the
    end of its own, and its launches are the counts' growth over that
    span."""
    from epropnp_tpu_torch.sixdof import test as stest
    batches = []
    last = [launch_counts(), time.perf_counter()]
    infer_poses = stest.infer_poses

    def timed_infer_poses(*args, **kwargs):
        res = infer_poses(*args, **kwargs)
        torch.cuda.synchronize()
        now, t = launch_counts(), time.perf_counter()
        batches.append(dict(
            crops=int(res.pose_est.shape[0]), wall_ms=(t - last[1]) * 1e3,
            launches={k: now[k] - last[0][k] for k in now
                      if now[k] != last[0][k]},
            finite=bool(torch.isfinite(res.pose_est).all())))
        last[:] = [now, t]
        return res

    stest.infer_poses = timed_infer_poses
    try:
        return run(), batches
    finally:
        stest.infer_poses = infer_poses


def path_sixdof_eval(torch, device, init, setup):
    """Path p: ``sixdof.main.test_loop`` on the checkpoint of
    :func:`sixdof_eval_setup` over 96 crops in batches of 32 with ``init``;
    each batch must launch K1 ``EVAL_K1_PER_BATCH[init]`` times and nothing
    else. Prints each batch's wall and ``PoseEvaluator``'s metrics."""
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.sixdof.main import load_cdpn
    s = sixdof_eval_setup(torch, device, setup)
    ds = s['data']
    if init == 'epnp_device':
        loaded = load_cdpn(s['cfg'], s['path'], device=device)
        assert same_state(torch, loaded, s['state_dict']), \
            'CDPN checkpoint: weights differ'
        del loaded
        print("path p: init='epnp' (cv2.solvePnP on the host) is not driven "
              'here: this machine has no cv2')
    # the RSLM draws from a generator on the card, as a caller on the card
    # would (a CPU generator draws them on the host, PERF.md)
    metrics, batches = timed_test_loop(torch, lambda: smain.test_loop(
        s['cfg'], ds, s['path'], ds.models, ds.diameters, init=init,
        batch_size=EVAL_BATCH, device=device,
        rng=torch.Generator(device).manual_seed(0)))
    for i, b in enumerate(batches):
        print(f'path p ({init}): batch {i}: ' + json.dumps(b))
    print(f'path p ({init}): metrics ' + json.dumps(
        metrics, default=lambda a: np.asarray(a).tolist()))
    # the first batch's model outputs on the card through infer_poses on
    # the card and on the CPU (the twins), the same draws: phase c's rule
    from epropnp_tpu_torch.sixdof.dataset import collate
    model = load_cdpn(s['cfg'], s['path'], device=device)
    samples = ds.samples[:EVAL_BATCH]
    batch = collate(samples, {c: ds.min_extents(c) for c in ds.classes},
                    device)
    share = uncounted(lambda: twin_path_agreement(
        torch, model, batch, np.stack([x.box[2:] for x in samples]),
        torch.tensor(LINEMOD_K, device=device), s['cfg'], seed=0,
        init=init))
    print(f'path p ({init}): share of the first batch\'s {EVAL_BATCH} crops '
          f'whose pose on the card matches the CPU twins: {share:.4f}')
    assert share >= 0.9, f'{init}: card and CPU twins disagree'
    assert len(batches) == EVAL_CROPS // EVAL_BATCH, 'test_loop: batches'
    want = {'K1': EVAL_K1_PER_BATCH[init]}
    for b in batches:
        assert b['launches'] == want, f'{init} batch: launches {b}'
        assert b['finite'], f'{init} batch: non-finite pose'
    assert set(metrics) == {'pose', 'add', 'arp_2d'}
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for m in metrics.values() for per_cls in m.values()
               for v in per_cls.values()), \
        'non-finite metric'
    return [b['wall_ms'] for b in batches]


# ---------------------------------------------- Det on a dataset (path q)

# Path q: a nuScenes-format tree written from a seed (frames of
# det/synthetic.py at 1600x900 as uint8 .npy, six cameras a keyframe),
# DATASET_TRAIN_STEPS training steps of 6 frames through the training
# augmentations (the last DATASET_TRAIN_TIMED timed), then the 12 val
# frames served in batches of 6, plain and with flip TTA, and scored.
DATASET_KEYFRAMES = {'train': 4, 'val': 2}
DATASET_TRAIN_STEPS, DATASET_TRAIN_TIMED, DATASET_BATCH = 4, 2, 6
DATASET_EVAL_LAUNCHES = {False: {'K3-f32': 36, 'K1': 2}, True: TTA_LAUNCHES}
# the val ground truth fed back as detections must score mAP >= this
GT_MAP_FLOOR = 0.95
# nuScenes-like camera yaws about the ego's up axis (radians)
CAM_YAWS = {'CAM_FRONT': 0.0, 'CAM_FRONT_RIGHT': -0.96,
            'CAM_FRONT_LEFT': 0.96, 'CAM_BACK': np.pi,
            'CAM_BACK_LEFT': np.pi - 0.96, 'CAM_BACK_RIGHT': 0.96 - np.pi}


def write_det_tree(root, seed=0, im_hw=(900, 1600), keyframes=None,
                   num_obj=(4, 7), focal=1266.4):
    """A nuScenes-format tree under ``root``: per keyframe six camera
    frames rendered by ``det.synthetic.SyntheticDetSceneGenerator`` (RGB
    uint8 ``.npy`` under ``samples/<CAM>/``), and per split an info pickle
    in the converter's format (``tools/nuscenes_converter.py``): image
    path, intrinsics, sensor-to-ego and ego-to-global poses, and each
    object in the camera frame (category, 2D box, translation, size wlh,
    rotation, velocity, visibility, truncation, attribute, ann_token). The
    categories cycle through the ten nuScenes classes. Returns
    ``{split: pickle path}``."""
    import pickle
    from epropnp_tpu_torch.det import nuscenes_dataset as nd
    from epropnp_tpu_torch.det.synthetic import SyntheticDetSceneGenerator
    keyframes = keyframes or DATASET_KEYFRAMES
    gen = SyntheticDetSceneGenerator(
        im_hw=im_hw, num_classes=3, max_gt=num_obj[1], num_obj_range=num_obj,
        lidar_points=1, focal=focal, depth_range=(6.0, 20.0))
    r = np.random.default_rng(seed)
    # camera axes (x right, y down, z ahead) -> ego axes (x ahead, z up)
    cam_base = nd.quat_multiply(nd.quat_about_axis([0, 0, 1], -np.pi / 2),
                                nd.quat_about_axis([1, 0, 0], -np.pi / 2))
    kitti_q = nd.mat_to_quat(nd.KITTI2NUS_ROT.T.astype(np.float64))
    paths, n_obj = {}, 0
    for split, n_key in keyframes.items():
        infos = []
        for k in range(n_key):
            token = f'{split}-{k:03d}'
            e2g_q = nd.quat_about_axis([0, 0, 1], r.uniform(-np.pi, np.pi))
            e2g_t = [float(r.uniform(-500, 500)),
                     float(r.uniform(-500, 500)), 0.0]
            for cam_id, cam in enumerate(nd.CAMS):
                scene = gen.sample_scene(r)
                rel = os.path.join('samples', cam, f'{token}.npy')
                os.makedirs(os.path.join(root, 'samples', cam), exist_ok=True)
                np.save(os.path.join(root, rel),
                        np.round(scene.img * 255).astype(np.uint8))
                anns = []
                for g in np.flatnonzero(scene.gt_mask):
                    l, h, w, x, y, z, yaw = (
                        float(v) for v in scene.gt_bboxes_3d[g])
                    cat = nd.CLASSES[n_obj % len(nd.CLASSES)]
                    n_obj += 1
                    rot = nd.quat_multiply(
                        nd.quat_about_axis([0, 1, 0], yaw), kitti_q)
                    anns.append(dict(
                        category=cat,
                        bbox=[float(v) for v in scene.gt_bboxes[g]],
                        translation=[x, y, z], size=[w, l, h],
                        rotation=[float(v) for v in rot],
                        velocity=[0.0, 0.0], attribute=nd.CLS2ATTR[cat][0],
                        visibility=4, truncation=0.0,
                        ann_token=f'{token}-{cam_id}-{g}', num_pts=1))
                s2e_q = nd.quat_multiply(
                    nd.quat_about_axis([0, 0, 1], CAM_YAWS[cam]), cam_base)
                infos.append(dict(
                    img_path=rel, cam_id=cam_id, sample_token=token,
                    cam_intrinsic=gen.cam_k.astype(np.float64).tolist(),
                    sensor2ego_rotation=[float(v) for v in s2e_q],
                    sensor2ego_translation=[1.5, 0.0, 1.5],
                    ego2global_rotation=[float(v) for v in e2g_q],
                    ego2global_translation=e2g_t, annotations=anns,
                    version='v1.0-trainval'))
        paths[split] = os.path.join(root, f'infos_{split}.pkl')
        with open(paths[split], 'wb') as f:
            pickle.dump(infos, f)
    return paths


def kitti_annos(dataset):
    """The frames' annotations as KITTI annos (every object a 'Car', its
    2D box, dimensions [l, h, w], location, rotation_y and alpha; no
    occlusion or truncation), and the same boxes as detections of score
    1."""
    from epropnp_tpu_torch.tools.test_det import unfiltered
    full = unfiltered(dataset)
    gt, dt = [], []
    for info in dataset.data_infos:
        ann = full.parse_ann_info(info)
        b3d, n = ann['bboxes_3d'], len(ann['labels'])
        anno = dict(name=np.array(['Car'] * n),
                    bbox=np.asarray(ann['bboxes'], np.float32).reshape(n, 4),
                    dimensions=b3d[:, :3], location=b3d[:, 3:6],
                    rotation_y=b3d[:, 6],
                    alpha=b3d[:, 6] - np.arctan2(b3d[:, 3], b3d[:, 5]),
                    occluded=np.zeros(n), truncated=np.zeros(n))
        gt.append(anno)
        dt.append(dict(anno, score=np.ones(n, np.float32)))
    return gt, dt


def det_dataset_setup(torch, device, setup):
    """Path q's tree, written once into ``setup`` under ``build/``."""
    if setup:
        return setup
    root = os.path.join(REPO, 'build', 'chip_smoke_det_tree')
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    setup['paths'] = write_det_tree(root)
    setup['root'] = root
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)
    print(f'path q: nuScenes-format tree of '
          f'{sum(DATASET_KEYFRAMES.values()) * 6} frames of 1600x900 '
          f'written in {time.perf_counter() - t0:.1f} s '
          f'({size / 2 ** 20:.1f} MiB)')
    return setup


def dataset_cfg():
    """``DetConfig.v1b()`` with K1 on the path, one epoch, batch 6."""
    import dataclasses
    from epropnp_tpu_torch.det.config import DetConfig
    base = DetConfig.v1b()
    return dataclasses.replace(
        base, pnp=dataclasses.replace(base.pnp, use_pallas=True),
        train=dataclasses.replace(base.train, epochs=1,
                                  batch_size=DATASET_BATCH))


def path_det_dataset_train(torch, device, setup, prefetch=2):
    """Path q, training: ``tools.train_det.make_batch_iter`` on
    ``NuScenes3DDataset`` (the reference crop, training flips) into
    ``det.main.train_loop`` at v1b, batch 6, with the loop's default
    ``prefetch=2`` (the batches made on the producer thread) or, for the
    synchronous numbers of the same run, ``prefetch=0``:
    DATASET_TRAIN_STEPS steps, each launching K2 with bounds twice,
    K3-f32 36 times and K1 twice in its training modes, and nothing else;
    per step the wall time, images/s and the host's pipeline + collate
    time a batch (on the producer thread with the prefetch). The
    prefetch=2 run's ``latest.pt`` is the one the evaluation loads."""
    from epropnp_tpu_torch.det import main as dmain
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.tools import train_det
    setup = det_dataset_setup(torch, device, setup)
    cfg = dataset_cfg()
    dataset = NuScenes3DDataset(setup['paths']['train'],
                                img_prefix=setup['root'])
    steps = train_det.steps_per_epoch(dataset, cfg)
    assert steps == DATASET_TRAIN_STEPS, f'{steps} steps an epoch'
    batch_iter = train_det.make_batch_iter(dataset, cfg, setup['root'])
    host_ms, stamps, per_step, metrics = [], [], [], []
    last = dict(launch_counts())

    def timed_iter(epoch):
        it = batch_iter(epoch)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            host_ms.append((time.perf_counter() - t0) * 1e3)
            yield batch

    def on_step(epoch, i, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
        now = launch_counts()
        per_step.append({k: now[k] - last[k] for k in now})
        last.update(now)

    save_dir = os.path.join(setup['root'], f'run_prefetch{prefetch}')
    t0 = time.perf_counter()
    state = dmain.train_loop(cfg, timed_iter, steps, save_dir,
                             log_interval=steps, device=device,
                             on_step=on_step, prefetch=prefetch)
    total = time.perf_counter() - t0
    starts = [t0] + stamps[:-1]
    label = f'path q (prefetch={prefetch})'
    walls = []
    for i, (m, c) in enumerate(zip(metrics, per_step)):
        wall = stamps[i] - starts[i]
        walls.append(wall * 1e3)
        timed = i >= steps - DATASET_TRAIN_TIMED
        print(f'{label}: step {i}{"" if timed else " (warm-up)"}: wall '
              f'{wall * 1e3:.3f} ms, {DATASET_BATCH / wall:.3f} images/s, '
              f'host pipeline + collate {host_ms[i]:.3f} ms, '
              + json.dumps({k: round(v, 6) for k, v in m.items()})
              + ' launches ' + json.dumps({k: v for k, v in c.items() if v}))
    warm = steps - DATASET_TRAIN_TIMED
    ms = (stamps[-1] - stamps[warm - 1]) / DATASET_TRAIN_TIMED * 1e3
    out = dict(prefetch=prefetch, steps=steps,
               timed_steps=DATASET_TRAIN_TIMED, ms_per_step=ms,
               images_per_s=DATASET_BATCH / ms * 1e3,
               step_wall_ms_after_the_first=walls[1:],
               host_pipeline_collate_ms=host_ms,
               skipped_steps=int(sum(m['skipped'] for m in metrics)),
               loop_s_with_checkpoint=total)
    print(f'{label}: training ' + json.dumps(out))
    assert len(metrics) == steps, 'train_loop: wrong number of steps'
    # a step whose gradient is not finite is skipped by design (JAX's
    # rule, det.train.make_train_step); its losses must still be finite,
    # and some step must update the weights that latest.pt then holds
    assert all(np.isfinite(v) for m in metrics for k, v in m.items()
               if k != 'grad_norm'), 'path q: a non-finite loss'
    assert sum(m['skipped'] for m in metrics) < steps, \
        'path q: every step skipped'
    for i, c in enumerate(per_step):
        others = {k: v for k, v in c.items()
                  if k not in DET_STEP_LAUNCHES and v}
        assert all(c[k] == v for k, v in DET_STEP_LAUNCHES.items()) \
            and not others, f'path q: training step {i}: launches {c}'
    if prefetch:
        setup['checkpoint'] = os.path.join(save_dir, 'latest.pt')
        setup['trained'] = {k: v.detach().cpu()
                            for k, v in state.model.state_dict().items()}
    return dict(out, ms=ms, host_ms=host_ms)


def path_det_dataset_eval(torch, device, setup, tta):
    """Path q, evaluation: ``det.api.init_detector`` on the training run's
    ``latest.pt`` (its weights must equal the trained ones bit for bit),
    then ``tools.test_det.evaluate_dataset`` over the 12 val frames in
    batches of 6 with the RSLM samples drawn on the card; each batch must
    launch K3 36 times (72 with ``tta``) and K1 twice. Per batch the times
    of reading, the pipeline and the inference; then the fusion + eval
    time and the metrics, which must be finite, over the 2 sample tokens
    of ``results_nusc.json``."""
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.tools.test_det import evaluate_dataset
    from epropnp_tpu_torch.utils.timer import IterTimers
    label = 'TTA' if tta else 'plain'
    cfg = dataset_cfg()
    t0 = time.perf_counter()
    model = api.init_detector(cfg, checkpoint=setup['checkpoint'],
                              device=device)
    print(f'path q: init_detector on latest.pt in '
          f'{time.perf_counter() - t0:.2f} s')
    assert same_state(torch, model, setup['trained']), \
        'latest.pt: the loaded weights differ from the trained ones'
    dataset = NuScenes3DDataset(setup['paths']['val'],
                                img_prefix=setup['root'])
    timers = IterTimers(enabled=True)
    keys = ('read time', 'data time', 'model time', 'post-proc. time')
    seen = dict.fromkeys(keys, 0.0)
    last = dict(launch_counts())
    per_batch = []

    def on_batch(b):
        now = launch_counts()
        counts = {k: now[k] - last[k] for k in now if now[k] != last[k]}
        last.update(now)
        times = {}
        for k in keys:
            total = timers(k).total
            times[k] = (total - seen[k]) * 1e3
            seen[k] = total
        per_batch.append(counts)
        print(f'path q: {label} batch {b}: ' + json.dumps(dict(
            read_ms=times['read time'], pipeline_ms=times['data time'],
            inference_ms=times['model time'],
            post_proc_ms=times['post-proc. time'], launches=counts)))

    out_dir = os.path.join(setup['root'], f'eval_{label.lower()}')
    t0 = time.perf_counter()
    metrics = evaluate_dataset(
        model, cfg, dataset, setup['root'], out_dir,
        batch_size=DATASET_BATCH, tta=tta,
        rng=torch.Generator(device).manual_seed(0), timers=timers,
        on_batch=on_batch)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, 'results_nusc.json')) as f:
        tokens = len(json.load(f)['results'])
    summary = dict(nd_score=metrics['nd_score'], mean_ap=metrics['mean_ap'],
                   tp_errors=metrics['tp_errors'], sample_tokens=tokens,
                   fusion_eval_ms=timers('fusion + eval time').total * 1e3,
                   wall_s=wall)
    print(f'path q: {label} evaluation ' + json.dumps(summary))
    assert len(per_batch) == len(dataset) // DATASET_BATCH
    for b, counts in enumerate(per_batch):
        assert counts == DATASET_EVAL_LAUNCHES[tta], \
            f'{label} batch {b}: launches {counts}'
    assert tokens == DATASET_KEYFRAMES['val'], f'{tokens} sample tokens'
    values = [metrics['nd_score'], metrics['mean_ap'],
              *metrics['tp_errors'].values()]
    assert np.isfinite(values).all(), f'{label}: a metric is NaN'
    return summary


def path_det_metrics_check(torch, device, setup):
    """Path q, the metrics code: the val ground truth fed back as
    detections of score 1 through ``NuScenes3DDataset.evaluate`` (mAP at
    least GT_MAP_FLOOR), and ``kitti_eval`` on the same boxes as KITTI
    annos through the native ``boxes_iou_3d`` / ``rotated_iou_matrix``
    (every AP 100)."""
    from epropnp_tpu_torch.det.kitti_eval import kitti_eval
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.ops import iou3d
    from epropnp_tpu_torch.tools.test_det import ground_truth_results
    print('path q: iou3d library '
          + os.path.relpath(iou3d.load_library()._name, REPO))
    dataset = NuScenes3DDataset(setup['paths']['val'],
                                img_prefix=setup['root'])
    metrics = dataset.evaluate(ground_truth_results(dataset),
                               os.path.join(setup['root'], 'eval_gt'))
    gt, dt = kitti_annos(dataset)
    kitti = kitti_eval(gt, dt, classes=('Car',))
    print('path q: ground truth as detections: ' + json.dumps(dict(
        mean_ap=metrics['mean_ap'], nd_score=metrics['nd_score'],
        kitti_min_ap=min(kitti.values()), kitti=kitti,
        objects=int(sum(len(a['name']) for a in gt)))))
    assert metrics['mean_ap'] >= GT_MAP_FLOOR, \
        f'ground truth as detections: mAP {metrics["mean_ap"]}'
    assert min(kitti.values()) == 100.0, f'KITTI AP {kitti}'
    return dict(mean_ap=metrics['mean_ap'], kitti=kitti)

# ------------------------------------------- 6DoF on a dataset (path r)

# Path r: a LineMOD-format tree written from a seed by ``sixdof.synthetic``
# (class ape, 640x480 frames) and the 6DoF CLIs on it: LM_EPOCHS epochs of
# LM_FRAMES['train'] / LM_BATCH training steps at ``epropnp_basic``, the
# LM_FRAMES['test'] test frames in batches of LM_BATCH with each init,
# then the validation tool at LM_VALIDATE on a tree of its own.
LM_FRAMES, LM_BATCH, LM_EPOCHS = {'train': 192, 'test': 64}, 32, 2
LM_VALIDATE = dict(frames=64, test_frames=32, epochs=2, bs=16)


def write_models_dir(root, info, cls='ape'):
    """``models/models_info.txt`` and ``models/obj_01.ply`` (ascii; both
    in mm) of the generator's cuboid: the files ``tools.test_6dof``
    reads."""
    from epropnp_tpu_torch.sixdof import ref_constants as ref
    from epropnp_tpu_torch.sixdof.synthetic import cuboid_surface
    mdir = os.path.join(root, 'models')
    os.makedirs(mdir, exist_ok=True)
    i = info[cls]
    with open(os.path.join(mdir, 'models_info.txt'), 'w') as f:
        f.write(f'{ref.OBJ2IDX[cls]}: ' + ', '.join(
            f'{k}: {i[k] * 1e3:.3f}' for k in (
                'diameter', 'min_x', 'min_y', 'min_z', 'size_x', 'size_y',
                'size_z')) + '\n')
    ext = np.array([i['size_x'], i['size_y'], i['size_z']]) / 2.0
    pts = cuboid_surface(ext.astype(np.float32), pts_per_face=16) * 1e3
    with open(os.path.join(mdir, f'obj_{ref.OBJ2IDX[cls]:02d}.ply'),
              'w') as f:
        f.write('ply\nformat ascii 1.0\n'
                f'element vertex {len(pts)}\n'
                'property float x\nproperty float y\nproperty float z\n'
                'end_header\n')
        f.writelines(f'{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}\n' for p in pts)


def tree_mib(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs) / 2 ** 20


def lm_dataset_setup(setup):
    """Path r's tree, written once into ``setup`` under ``build/``."""
    if setup:
        return setup
    from epropnp_tpu_torch.sixdof import synthetic
    root = os.path.join(REPO, 'build', 'chip_smoke_lm_tree')
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    info = synthetic.generate_dataset(root, cls='ape',
                                      n_train=LM_FRAMES['train'],
                                      n_test=LM_FRAMES['test'], seed=0)
    write_models_dir(root, info)
    print(f'path r: LineMOD-format tree of {sum(LM_FRAMES.values())} frames '
          f'of 640x480 written in {time.perf_counter() - t0:.1f} s '
          f'({tree_mib(root):.1f} MiB)')
    setup.update(root=root, save=os.path.join(root, 'run'))
    return setup


def no_cv2(label):
    print(f'path r: cv2 imported after {label}: {"cv2" in sys.modules}')
    assert 'cv2' not in sys.modules, f'path r: cv2 imported ({label})'


def prefetch_stream_check(torch, device, n=12, shape=(32, 256, 256, 3)):
    """``parallel.prefetch.prefetch_to_device`` on the card: ``n`` host
    batches of path r's crop size, batch i filled with i, through a
    background producer; the consumer stream spins (``torch.cuda._sleep``)
    before it reads each batch and drops it at once, so a copy that the
    consumer did not wait for, or memory handed on while the consumer's
    work still reads it, shows as wrong entries."""
    from epropnp_tpu_torch.parallel.prefetch import (BackgroundIterator,
                                                     prefetch_to_device)

    def batches():
        for i in range(n):
            yield (np.full(shape, i, np.float32), np.full((shape[0],), i,
                                                          np.float32))
    wrong = []
    t0 = time.perf_counter()
    for i, (x, y) in enumerate(prefetch_to_device(
            BackgroundIterator(batches(), maxsize=3), depth=2,
            device=device)):
        torch.cuda._sleep(2_000_000)
        wrong.append((x != i).sum() + (y != i).sum())
        del x, y
    errors = int(torch.stack(wrong).sum())
    print(f'path r: prefetch_to_device stream check: {n} batches of '
          f'{np.prod(shape) * 4 / 2 ** 20:.1f} MiB in '
          f'{(time.perf_counter() - t0) * 1e3:.1f} ms, wrong entries '
          f'{errors}')
    assert errors == 0, 'prefetch_to_device: a batch was read wrong'


def host_pipeline_stages(root, n=LM_BATCH):
    """The 6DoF host pipeline of one training batch by stage, on this
    thread alone (no training beside it): ``LineMODDataset._load`` (PNG
    rgb and mask, ``.npy`` coordinates), ``denoise_coor``, the rest of
    ``build_sample`` (DZI crop, resizes, targets) and ``collate``, in
    ms."""
    from epropnp_tpu_torch.sixdof import dataset as sdataset
    from epropnp_tpu_torch.sixdof.config import SixDoFConfig
    cfg = SixDoFConfig.epropnp_basic()
    ds = sdataset.LineMODDataset(cfg, root, split='train', classes=['ape'])
    ms = dict.fromkeys(('read', 'denoise', 'crop', 'collate'), 0.0)
    samples = []
    for rec in ds.annot[:n]:
        t0 = time.perf_counter()
        rgb, coor, msk, pose, box = ds._load(rec)
        t1 = time.perf_counter()
        coor = sdataset.denoise_coor(coor)
        t2 = time.perf_counter()
        samples.append(sdataset.build_sample(
            cfg, 'ape', rgb, coor, msk, pose, box, ds.min_extents('ape'),
            rng=ds.rng, denoise=False))
        t3 = time.perf_counter()
        for k, dt in zip(('read', 'denoise', 'crop'),
                         (t1 - t0, t2 - t1, t3 - t2)):
            ms[k] += dt * 1e3
    t0 = time.perf_counter()
    sdataset.collate(samples, {'ape': ds.min_extents('ape')})
    ms['collate'] = (time.perf_counter() - t0) * 1e3
    print(f'path r: host pipeline of {n} frames by stage, one thread alone '
          f'(ms): ' + json.dumps(ms) + f', total {sum(ms.values()):.1f}')


def path_lm_train(torch, device, setup, j_ms):
    """Path r, training: ``tools.train_6dof.main`` at ``epropnp_basic``,
    LM_EPOCHS epochs of batch 32 over the tree, each step launching K1
    twice in its training modes and nothing else; per step the wall,
    samples/s and the host pipeline's time for the batch (read, denoise,
    crop, collate: measured on the producer thread).

    Two paces. From a ready batch: epoch 0's last ``prefetch`` steps (the
    loop's default, 2), whose batches the producer made while step 0
    built and warmed up, against path j's step (``j_ms``). Once no lead
    is left: each epoch starts its producer anew, and
    ``prefetch_to_device`` holds ``prefetch`` batches back, so epoch 1's
    step 0 waits for ``prefetch + 1`` batches, its steps 1 to ``n -
    prefetch - 1`` each wait for one more (the pace of a long epoch),
    and its last ``prefetch`` come ready."""
    from epropnp_tpu_torch.sixdof import dataset as sdataset
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.tools import train_6dof
    setup = lm_dataset_setup(setup)
    prefetch_stream_check(torch, device)
    host_ms, stamps, per_step, metrics = [], [], [], []
    last = dict(launch_counts())
    batches, train_loop = sdataset.LineMODDataset.batches, smain.train_loop
    prefetch = inspect.signature(train_loop).parameters['prefetch'].default

    def timed_batches(self, *args, **kwargs):  # runs on the producer thread
        it = batches(self, *args, **kwargs)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            host_ms.append((time.perf_counter() - t0) * 1e3)
            yield batch

    def on_step(epoch, i, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in m.items()})
        now = launch_counts()
        per_step.append({k: now[k] - last[k] for k in now})
        last.update(now)

    sdataset.LineMODDataset.batches = timed_batches
    smain.train_loop = lambda *a, **k: train_loop(*a, on_step=on_step, **k)
    t0 = time.perf_counter()
    try:
        train_6dof.main(['--exp', 'epropnp_basic', '--data', setup['root'],
                         '--save', setup['save'], '--epochs', str(LM_EPOCHS),
                         '--batch-size', str(LM_BATCH), '--device', 'cuda'])
    finally:
        sdataset.LineMODDataset.batches = batches
        smain.train_loop = train_loop
    total = time.perf_counter() - t0
    n = LM_FRAMES['train'] // LM_BATCH
    walls = np.diff([t0] + stamps) * 1e3
    ready = list(range(n - prefetch, n))
    steady = list(range(n + 1, 2 * n - prefetch))
    role = {0: 'build', n: 'refill'}
    role.update({i: 'ready' for i in ready})
    role.update({i: 'steady' for i in steady})
    role.update({i: 'drain' for i in range(2 * n - prefetch, 2 * n)})
    for i, (m, c) in enumerate(zip(metrics, per_step)):
        print(f'path r: epoch {i // n} step {i % n} ({role.get(i, "lead")}): '
              f'wall {walls[i]:.3f} ms, {LM_BATCH / walls[i] * 1e3:.3f} '
              f'samples/s, host pipeline {host_ms[i]:.3f} ms, '
              + json.dumps({k: round(v, 6) for k, v in m.items()})
              + ' launches ' + json.dumps({k: v for k, v in c.items() if v}))
    ready_ms = float(np.mean(walls[ready]))
    steady_ms = float(np.mean(walls[steady]))
    # steady step i waits for batch i + prefetch, the one it pulls through
    # the device prefetch before it receives batch i
    host = float(np.mean(np.asarray(host_ms)[np.add(steady, prefetch)]))
    print('path r: training ' + json.dumps(dict(
        epochs=LM_EPOCHS, steps_per_epoch=n, prefetch=prefetch,
        ready_steps=ready, ready_ms_per_step=ready_ms,
        ready_samples_per_s=LM_BATCH / ready_ms * 1e3,
        path_j_ms_per_step=j_ms,
        steady_steps=steady, steady_ms_per_step=steady_ms,
        steady_samples_per_s=LM_BATCH / steady_ms * 1e3,
        steady_producer_ms=host,
        # of a synchronous loop's host pipeline + step, the part the
        # producer thread ran while the card's step did
        steady_overlap_ms=host + ready_ms - steady_ms,
        host_pipeline_ms=host_ms,
        skipped_steps=int(sum(m['skipped'] for m in metrics)),
        cli_s_with_build_and_checkpoints=total)))
    assert len(metrics) == LM_EPOCHS * n, 'train_6dof: wrong number of steps'
    assert steady, 'path r: no step waits for the producer'
    assert all(np.isfinite(v) for m in metrics for k, v in m.items()
               if k != 'grad_norm'), 'path r: a non-finite loss'
    assert sum(m['skipped'] for m in metrics) < len(metrics), \
        'path r: every step skipped'
    for i, c in enumerate(per_step):
        assert {k: v for k, v in c.items() if v} == {'K1-train': 2}, \
            f'path r: training step {i}: launches {c}'
    setup['checkpoint'] = os.path.join(setup['save'], 'latest.pt')
    assert os.path.isfile(setup['checkpoint']), 'train_6dof: no latest.pt'
    host_pipeline_stages(setup['root'])
    no_cv2('training')
    return dict(ready_ms=ready_ms, steady_ms=steady_ms, host_ms=host_ms)


def path_lm_eval(torch, device, setup, init):
    """Path r, evaluation: ``tools.test_6dof.main`` on the training run's
    ``latest.pt`` over the LM_FRAMES['test'] test frames in batches of 32
    with ``init``: K1 ``EVAL_K1_PER_BATCH[init]`` times a batch and
    nothing else; each batch's wall and the metrics, which must be
    finite."""
    from epropnp_tpu_torch.tools import test_6dof
    setup = lm_dataset_setup(setup)
    metrics, batches = timed_test_loop(torch, lambda: test_6dof.main([
        '--exp', 'epropnp_basic', '--data', setup['root'], '--checkpoint',
        setup['checkpoint'], '--init', init, '--batch-size', str(LM_BATCH),
        '--device', 'cuda']))
    for i, b in enumerate(batches):
        print(f'path r ({init}): batch {i}: ' + json.dumps(b))
    print(f'path r ({init}): mean metrics ' + json.dumps(
        test_6dof.mean_metrics(metrics),
        default=lambda a: np.asarray(a).tolist()))
    assert len(batches) == LM_FRAMES['test'] // LM_BATCH, 'test_6dof: batches'
    for b in batches:
        assert b['launches'] == {'K1': EVAL_K1_PER_BATCH[init]}, \
            f'path r {init} batch: launches {b}'
    assert set(metrics) == {'pose', 'add', 'arp_2d'}
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for m in metrics.values() for per_cls in m.values()
               for v in per_cls.values()), 'path r: non-finite metric'
    no_cv2(f'evaluation ({init})')
    return [b['wall_ms'] for b in batches]


def path_lm_validate(torch, device):
    """Path r, validation: ``tools.validate_6dof_synthetic.main`` reduced
    to LM_VALIDATE with ``--init epnp_device`` and K1 on, on a tree of its
    own (removed afterwards); prints its JSON line."""
    from epropnp_tpu_torch.tools import validate_6dof_synthetic
    root = os.path.join(REPO, 'build', 'chip_smoke_lm_validate')
    shutil.rmtree(root, ignore_errors=True)
    v = LM_VALIDATE
    try:
        out = validate_6dof_synthetic.main([
            '--root', os.path.join(root, 'tree'), '--save-dir',
            os.path.join(root, 'run'), '--frames', str(v['frames']),
            '--test-frames', str(v['test_frames']), '--epochs',
            str(v['epochs']), '--bs', str(v['bs']), '--init', 'epnp_device',
            '--device', 'cuda'])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print('path r: validate ' + json.dumps(out))
    accs = [*out['add_untrained'].values(), *out['add_best'].values()]
    assert np.isfinite(accs).all(), 'validate: non-finite ADD'
    no_cv2('validation')
    return out


def lm_validate_launches():
    """K1 launches of path r's validation: two training-mode launches a
    step; one a test batch with ``epnp_device``, over the untrained model
    and each epoch's checkpoint."""
    v = LM_VALIDATE
    steps = v['frames'] // v['bs'] * v['epochs']
    evals = 1 + v['epochs']  # ckpt_interval max(1, epochs // 10) = 1
    return {'K1-train': 2 * steps,
            'K1': evals * -(-v['test_frames'] // v['bs'])}



# Paths u, v and w: data parallelism (``parallel.mesh``) on two ranks that
# share the one card over gloo (NCCL refuses two ranks on one device), each
# rank a process of this script (``--dp-rank``), and the world of one over
# NCCL in this process. Two ranks on one card are no data-parallel
# throughput: their all-reduces go through the host.
DP_RANKS, DP_MEMORY_FRACTION = 2, 0.45
# u: the 6DoF step at path j's width, 32 crops globally (16 a rank)
DP_SIXDOF_STEPS, DP_SIXDOF_TIMED, DP_SIXDOF_BATCH = 6, 4, 32
# v: the Det step at v1b, the published 6 images a rank (12 globally)
DP_DET_STEPS, DP_DET_TIMED, DP_DET_IMAGES = 4, 2, 6
# the world of one against plain runs: steps, and the rule's factor on
# the distance between two plain runs of the same seed
WORLD_OF_ONE_STEPS, WORLD_OF_ONE_FACTOR = 3, 2.0
# w: the rank's frames of each batch of 6 against per-shard runs (JAX's
# rule, tests/test_det_multidevice.py:39-80). The detector it serves is
# phase g's (``build_det_model``: not chaotic under f32 rounding, whereas
# path q's trained random R101 is, and two processes' cuDNN searches may
# pick other algorithms), its FCOS class logits spread by DP_EVAL_CLS_GAIN
# and shifted so that about DP_EVAL_CANDIDATES points an image pass the
# 0.04 score threshold on the val frames: a random head's scores sit at
# its prior, sigmoid(-4.59) x sigmoid(centerness), below it. The random
# poses of these candidates mostly project outside the frame, so few or
# none survive as boxes: the rule holds the inference function's outputs
# on every candidate slot (JAX's "valid slots"), not only the survivors.
DP_EVAL_RTOL = DP_EVAL_ATOL = 1e-4
DP_EVAL_CLS_GAIN, DP_EVAL_CANDIDATES = 100.0, 24


def state_digest(state) -> str:
    """sha256 of every tensor of ``state.state_dict()`` (parameters,
    BatchNorm statistics, the EMA normalisers, the step), in order."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for k, v in state.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


class RankRecorder:
    """A rank's record of a training loop: after every step the state's
    digest, the step's wall time (from the end of the previous step's
    record, so the digest is outside it), its launches and the memory
    peak. Nothing is added inside a step; :meth:`profiled_step` times
    one more step's all-reduces apart."""

    def __init__(self, torch):
        self.torch = torch
        self.state, self.digests, self.step_ms, self.metrics = None, [], [], []
        self.launches, self.peaks = [], []
        self.last = dict(launch_counts())
        self.resume = time.perf_counter()

    def capture(self, init_state):
        def call(*args, **kwargs):
            self.state = init_state(*args, **kwargs)
            return self.state
        return call

    def on_step(self, epoch, i, m):
        torch = self.torch
        torch.cuda.synchronize()
        done = time.perf_counter()
        self.step_ms.append((done - self.resume) * 1e3)
        self.metrics.append({k: float(v) for k, v in m.items()})
        now = launch_counts()
        self.launches.append({k: now[k] - self.last[k] for k in now
                              if now[k] != self.last[k]})
        self.last.update(now)
        self.peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        self.digests.append(state_digest(self.state))
        self.resume = time.perf_counter()

    def profiled_step(self, train_module, step):
        """One more step (``step()``, after the loop, outside its counts),
        with the card synchronised around the gradient and BatchNorm
        all-reduces (``train_module.mean_gradients`` / ``mean_buffers``)
        and a barrier before each: the step's wall, the all-reduces' time
        and the time the rank waited there for the other."""
        import torch.distributed as dist
        torch, spent = self.torch, {'allreduce_ms': 0.0, 'wait_ms': 0.0}

        def timed(real):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.barrier()
                t1 = time.perf_counter()
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
                spent['wait_ms'] += (t1 - t0) * 1e3
                spent['allreduce_ms'] += (time.perf_counter() - t1) * 1e3
                return out
            return call

        saved = {n: getattr(train_module, n)
                 for n in ('mean_gradients', 'mean_buffers')}
        for name, real in saved.items():
            setattr(train_module, name, timed(real))
        try:
            uncounted(lambda: torch.cuda.synchronize())
            t0 = time.perf_counter()
            uncounted(step)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            for name, real in saved.items():
                setattr(train_module, name, real)
        return dict(spent, step_ms=wall,
                    allreduce_share=spent['allreduce_ms'] / wall,
                    wait_share=spent['wait_ms'] / wall)

    def result(self, timed, profiled):
        from epropnp_tpu_torch.parallel import mesh
        import torch.distributed as dist
        return dict(rank=mesh.rank(), backend=dist.get_backend(),
                    digests=self.digests, step_ms=self.step_ms,
                    ms_per_step=float(np.mean(self.step_ms[-timed:])),
                    profiled=profiled, launches=self.launches,
                    peaks_gib=self.peaks, metrics=self.metrics)


def sixdof_dp_cfg(steps_batch=DP_SIXDOF_BATCH):
    import dataclasses
    from epropnp_tpu_torch.sixdof.config import SixDoFConfig
    base = SixDoFConfig.epropnp_basic()
    return dataclasses.replace(
        base, pnp=dataclasses.replace(base.pnp, use_pallas=True),
        train=dataclasses.replace(base.train, begin_epoch=0, end_epoch=1,
                                  train_batch_size=steps_batch))


def det_dp_cfg(images):
    import dataclasses
    from epropnp_tpu_torch.det.config import DetConfig
    base = DetConfig.v1b()
    return dataclasses.replace(
        base, pnp=dataclasses.replace(base.pnp, use_pallas=True),
        train=dataclasses.replace(base.train, epochs=1, batch_size=images))


def rank_sixdof_train(torch, args):
    """Path u on one rank: ``sixdof.main.train_loop(data_parallel=True)``
    on its 16 rows of path j's seeded synthetic batches of 32."""
    import tempfile
    from epropnp_tpu_torch.parallel import mesh
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.sixdof import train as strain
    from epropnp_tpu_torch.utils.synthetic import SyntheticSixDoFDataset
    cfg = sixdof_dp_cfg()
    data = SyntheticSixDoFDataset(DP_SIXDOF_STEPS * DP_SIXDOF_BATCH, 256,
                                  64, seed=0)
    rec = RankRecorder(torch)
    smain.init_state = rec.capture(smain.init_state)
    with tempfile.TemporaryDirectory() as save_dir:
        smain.train_loop(cfg, data, save_dir, data_parallel=True,
                         log_interval=DP_SIXDOF_STEPS, on_step=rec.on_step)
    device = next(rec.state.parameters()).device
    step = strain.make_train_step(
        strain.build_epropnp(cfg), cfg,
        torch.tensor(LINEMOD_K, device=device), data_parallel=True)
    batch = smain.to_device(mesh.take_rows(
        next(data.batches(DP_SIXDOF_BATCH, seed=9)),
        mesh.rank_rows(DP_SIXDOF_BATCH)), device)
    gen = torch.Generator(device=device).manual_seed(9)
    profiled = rec.profiled_step(
        strain, lambda: step(rec.state, batch, gen))
    return rec.result(DP_SIXDOF_TIMED, profiled)


def rank_det_train(torch, args):
    """Path v on one rank: ``det.main.train_loop(data_parallel=True)`` at
    v1b on its 6 rows of seeded synthetic batches of 12 images."""
    from epropnp_tpu_torch.det import main as dmain
    from epropnp_tpu_torch.det import train as dtrain
    from epropnp_tpu_torch.parallel.mesh import rank_rows, take_rows
    images = args['images']
    cfg = det_dp_cfg(DP_RANKS * images)
    batches = det_train_batches(DP_DET_STEPS, n_img=DP_RANKS * images)
    rec = RankRecorder(torch)
    dmain.init_state = rec.capture(dmain.init_state)
    dmain.train_loop(cfg, lambda epoch, rows: (take_rows(b, rows)
                                               for b in batches),
                     DP_DET_STEPS, args['save_dir'], data_parallel=True,
                     log_interval=DP_DET_STEPS, on_step=rec.on_step)
    device = next(rec.state.parameters()).device
    step = dtrain.make_train_step(cfg, data_parallel=True)
    batch = dmain.to_device(take_rows(
        batches[0], rank_rows(DP_RANKS * images)), device)
    gen = torch.Generator(device=device).manual_seed(9)
    profiled = rec.profiled_step(
        dtrain, lambda: step(rec.state, batch, gen))
    return dict(rec.result(DP_DET_TIMED, profiled), images=images)


class DetectionCapture:
    """While entered, every ``det.test`` inference call's ``DetResults``
    (numpy, all slots) and the top-k's candidate mask (``preds['valid']``:
    the slots above the FCOS score threshold), in call order."""

    def __init__(self):
        self.batches = []

    def __enter__(self):
        from epropnp_tpu_torch.det import test as dtest
        self.cls, self.real = dtest.DetInference, dtest.DetInference.detections
        real, batches = self.real, self.batches

        def detections(inference, preds, *args, **kwargs):
            out = real(inference, preds, *args, **kwargs)
            batches.append(dict(
                {k: v.detach().cpu().numpy() for k, v in out._asdict().items()
                 if v is not None},
                candidate=preds['valid'].detach().cpu().numpy()))
            return out
        self.cls.detections = detections
        return self

    def __exit__(self, *exc):
        self.cls.detections = self.real


def detections_gap(got, want):
    """The largest gap over tolerance between two captured runs, on the
    reference's candidate slots; inf where a mask, label or image index
    differs."""
    worst, slots = 0.0, 0
    if len(got) != len(want):
        return float('inf'), 0
    for g, w in zip(got, want):
        m = w['candidate']
        if not np.array_equal(g['candidate'], m):
            return float('inf'), slots
        for k in ('labels', 'img_inds', 'valid'):
            if not np.array_equal(g[k][m], w[k][m]):
                return float('inf'), slots
        for k in ('bbox_3d', 'bbox_2d', 'scores', 'scores_3d', 'velo',
                  'attr'):
            if k in w:
                a, b = g[k][m], w[k][m]
                worst = max(worst, float(np.max(
                    np.abs(a - b) / (DP_EVAL_ATOL + DP_EVAL_RTOL * np.abs(b)),
                    initial=0.0)))
        slots += int(m.sum())
    return worst, slots


def rank_det_eval(torch, args):
    """Path w on one rank: ``tools.test_det.main --data-parallel`` on path
    q's val frames, the rank's launches around it."""
    from epropnp_tpu_torch.tools import test_det
    import pickle
    for m, a in kernel_counters().values():
        setattr(m, a, 0)
    with DetectionCapture() as capture:
        metrics = test_det.main(args['argv'])
    torch.cuda.synchronize()
    from epropnp_tpu_torch.parallel import mesh
    raw = args['raw'].format(rank=mesh.rank())
    with open(raw, 'wb') as f:
        pickle.dump(capture.batches, f)
    return dict(rank=mesh.rank(), raw=raw, launches={
        k: v for k, v in launch_counts().items() if v},
        metrics=None if metrics is None else dict(
            nd_score=metrics['nd_score'], mean_ap=metrics['mean_ap']))


RANK_PATHS = {'u': rank_sixdof_train, 'v': rank_det_train,
              'w': rank_det_eval}


def dp_rank_main(name, args, out_path) -> int:
    """One rank of a data-parallel path (``--dp-rank``): the group comes
    from the environment the parent set; the kernels are the parent's
    build. Writes the path's result as JSON to ``out_path``."""
    import torch
    sys.path.insert(0, REPO)
    from epropnp_tpu_torch.utils.cuda_setup import configure_cuda
    configure_cuda()
    from epropnp_tpu_torch import kernels
    kernels.load_library()
    torch.cuda.set_device(int(os.environ['LOCAL_RANK'])
                          % torch.cuda.device_count())
    torch.cuda.set_per_process_memory_fraction(DP_MEMORY_FRACTION)
    for m, a in kernel_counters().values():
        setattr(m, a, 0)
    out = RANK_PATHS[name](torch, args)
    with open(out_path, 'w') as f:
        json.dump(out, f)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def dp_spawn(torch, name, args, timeout=600):
    """Run path ``name`` on DP_RANKS processes of this script (the
    ``torchrun`` environment set, one card shared) and return their
    results; prints each rank's lines that name the path, and fails with
    each rank's log tail if one fails."""
    import gc
    import socket
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(REPO, 'build', 'chip_smoke_dp')
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = str(s.getsockname()[1])
    procs = []
    for r in range(DP_RANKS):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_RANKS),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(DP_RANKS),
                   MASTER_ADDR='localhost', MASTER_PORT=port)
        log = open(os.path.join(out_dir, f'{name}_rank{r}.log'), 'w')
        res = os.path.join(out_dir, f'{name}_rank{r}.json')
        if os.path.exists(res):
            os.remove(res)
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--dp-rank', name,
             '--dp-args', json.dumps(args), '--dp-out', res], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log, res))
    deadline = time.perf_counter() + timeout
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results, failed = [], []
    for r, (p, log, res) in enumerate(procs):
        with open(log.name) as f:
            lines = f.read().splitlines()
        for line in lines:
            if 'data parallel:' in line:
                print(f'path {name} rank {r}: {line.strip()}')
        if p.returncode != 0 or not os.path.exists(res):
            failed.append(r)
            print(f'path {name} rank {r}: exit {p.returncode}; last lines:\n'
                  + '\n'.join(lines[-40:]), file=sys.stderr)
            continue
        with open(res) as f:
            results.append(json.load(f))
    assert not failed, f'path {name}: ranks {failed} failed'
    return results


def check_replicas(label, results, steps):
    """Every rank's digest after every step equal to rank 0's."""
    digests = [r['digests'] for r in results]
    assert all(len(d) == steps for d in digests), \
        f'{label}: steps {[len(d) for d in digests]}'
    for i in range(steps):
        assert len({d[i] for d in digests}) == 1, \
            f'{label}: the replicas differ after step {i}'
    print(f'{label}: the {len(results)} replicas are bit-identical after '
          f'each of the {steps} steps (state digests)')


def print_ranks(label, results, timed, per_rank_items):
    for r in results:
        for i, (ms, c) in enumerate(zip(r['step_ms'], r['launches'])):
            print(f'{label} rank {r["rank"]}: step {i}'
                  f'{"" if i >= len(r["step_ms"]) - timed else " (warm-up)"}'
                  f': {ms:.3f} ms, peak {r["peaks_gib"][i]:.2f} GiB, '
                  + json.dumps({k: round(v, 6)
                                for k, v in r['metrics'][i].items()})
                  + ' launches ' + json.dumps(c))
        print(f'{label} rank {r["rank"]}: ' + json.dumps(dict(
            backend=r['backend'], ms_per_step=r['ms_per_step'],
            items_per_s_per_rank=per_rank_items / r['ms_per_step'] * 1e3,
            profiled_step=r['profiled'],
            peak_step0_gib=r['peaks_gib'][0],
            peak_timed_gib=max(r['peaks_gib'][-timed:]))))


def rank_launch_totals(results):
    total = {}
    for r in results:
        for c in r['launches']:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    return total


def path_dp_sixdof(torch, device):
    """Path u: ``sixdof.main.train_loop(data_parallel=True)`` on 2 ranks
    over gloo on the one card at ``epropnp_basic`` width (CDPN-34, 32 crops
    of 256x256 globally, 16 a rank, AMIS 512 x 4, RMSprop, K1 on), 6
    steps on path j's seeded synthetic batches (the last 4 timed): the
    replicas bit-identical after every step; per rank the ms a step, the
    peaks, and from one more step (profiled) the share of the all-reduces
    and of the wait before them; each rank's step launching K1 twice in
    its training modes and nothing else."""
    results = dp_spawn(torch, 'u', {})
    label = 'path u'
    check_replicas(label, results, DP_SIXDOF_STEPS)
    print_ranks(label, results, DP_SIXDOF_TIMED,
                DP_SIXDOF_BATCH // DP_RANKS)
    for r in results:
        assert r['backend'] == 'gloo', r['backend']
        for i, c in enumerate(r['launches']):
            assert c == {'K1-train': TRAIN_K1_PER_STEP}, \
                f'{label} rank {r["rank"]} step {i}: launches {c}'
    return dict(rank_launches=rank_launch_totals(results),
                ms=float(np.mean([r['ms_per_step'] for r in results])))


def path_dp_det(torch, device):
    """Path v: ``det.main.train_loop(data_parallel=True)`` on 2 ranks over
    gloo at ``DetConfig.v1b()`` (f32, R101-DCN, 1600x672), 6 images a rank
    (12 globally), each rank's memory capped at DP_MEMORY_FRACTION of the
    card (cuDNN's exhaustive search then skips the algorithms whose
    workspace does not fit): 4 steps (the last 2 timed), the replicas
    bit-identical after every step, each rank's step launching K3-f32 36
    times, K2 with bounds twice and K1 twice in its training modes."""
    save_dir = os.path.join(REPO, 'build', 'chip_smoke_dp', 'v_run')
    results = dp_spawn(torch, 'v', dict(images=DP_DET_IMAGES,
                                        save_dir=save_dir))
    shutil.rmtree(save_dir, ignore_errors=True)
    label = 'path v'
    check_replicas(label, results, DP_DET_STEPS)
    print_ranks(label, results, DP_DET_TIMED, DP_DET_IMAGES)
    for r in results:
        for i, c in enumerate(r['launches']):
            assert c == DET_STEP_LAUNCHES, \
                f'{label} rank {r["rank"]} step {i}: launches {c}'
    return dict(rank_launches=rank_launch_totals(results),
                ms=float(np.mean([r['ms_per_step'] for r in results])))


def state_gap(a, b) -> float:
    """The largest ``max|a - b| / max|b|`` over the floating tensors of two
    state dicts."""
    gap = 0.0
    for k, v in b.items():
        if v.is_floating_point():
            scale = max(float(v.abs().max()), 1e-30) if v.numel() else 1.0
            gap = max(gap, float((a[k] - v).abs().max()) / scale
                      if v.numel() else 0.0)
    return gap


def path_world_of_one(torch, device, suite):
    """The world of one: in this process, ``train_loop(data_parallel=True)``
    in a group of one (``init_data_parallel`` without the torchrun
    environment: NCCL, every collective over one rank) for
    WORLD_OF_ONE_STEPS steps, against two plain runs of the same seed on
    the same batches. After every step the data-parallel state lies no
    further from the nearer plain run's than WORLD_OF_ONE_FACTOR times the
    two plain runs lie apart (bit-equal to one where they agree bit for
    bit): K3's backward and the 6DoF gathers' backward scatter by atomics,
    so two plain runs need not agree bit for bit, and the random models'
    steps amplify the difference from step to step."""
    import tempfile
    import torch.distributed as dist
    from epropnp_tpu_torch.det import main as dmain
    from epropnp_tpu_torch.parallel.mesh import take_rows
    from epropnp_tpu_torch.sixdof import main as smain
    from epropnp_tpu_torch.utils.synthetic import SyntheticSixDoFDataset
    label = f'path {suite} one'
    main = smain if suite == 'u' else dmain
    runs, backend = [], None
    real_init = main.init_state
    for dp in (False, False, True):
        held, steps = {}, []

        def init_state(*args, **kwargs):
            held['state'] = real_init(*args, **kwargs)
            return held['state']

        def on_step(epoch, i, m):
            steps.append({k: v.detach().cpu().clone() for k, v in
                          held['state'].state_dict().items()})

        main.init_state = init_state
        try:
            with tempfile.TemporaryDirectory() as save_dir:
                if suite == 'u':
                    data = SyntheticSixDoFDataset(
                        WORLD_OF_ONE_STEPS * DP_SIXDOF_BATCH, 256, 64,
                        seed=0)
                    smain.train_loop(
                        sixdof_dp_cfg(), data, save_dir, data_parallel=dp,
                        device=device, log_interval=WORLD_OF_ONE_STEPS,
                        on_step=on_step)
                else:
                    batches = det_train_batches(WORLD_OF_ONE_STEPS)
                    dmain.train_loop(
                        det_dp_cfg(6),
                        (lambda epoch, rows: (take_rows(b, rows)
                                              for b in batches)) if dp else
                        (lambda epoch: iter(batches)),
                        WORLD_OF_ONE_STEPS, save_dir, data_parallel=dp,
                        device=device, log_interval=WORLD_OF_ONE_STEPS,
                        on_step=on_step)
        finally:
            main.init_state = real_init
        if dp:
            backend = dist.get_backend()
            assert dist.get_world_size() == 1
            dist.destroy_process_group()
        runs.append(steps)
        held.clear()
    plain_gap = [state_gap(b, a) for a, b in zip(runs[0], runs[1])]
    dp_gap = [min(state_gap(c, a), state_gap(c, b))
              for a, b, c in zip(*runs)]
    out = dict(backend=backend, steps=WORLD_OF_ONE_STEPS,
               plain_vs_plain=plain_gap, data_parallel_vs_plain=dp_gap)
    print(f'{label}: by step ' + json.dumps(out))
    assert backend == 'nccl', backend
    assert len(dp_gap) == WORLD_OF_ONE_STEPS
    for i, (p, d) in enumerate(zip(plain_gap, dp_gap)):
        assert d <= WORLD_OF_ONE_FACTOR * p, \
            f'{label}: after step {i} the group of one lies {d} from the ' \
            f'plain runs (two plain runs {p})'
    return out


def dp_eval_checkpoint(torch, device, setup):
    """Path w's detector (see DP_EVAL_CLS_GAIN) written once as a port
    checkpoint (``DetTrainState``) beside path q's tree; the bias shift is
    found by bisection on the FCOS outputs of the first val batch. Its
    launches (the BatchNorm calibration, the first batch) are not the
    path's."""
    if 'dp_checkpoint' not in setup:
        setup['dp_checkpoint'] = uncounted(
            lambda: write_dp_eval_checkpoint(torch, device, setup))
    return setup['dp_checkpoint']


def write_dp_eval_checkpoint(torch, device, setup):
    from epropnp_tpu_torch.det import test as dtest
    from epropnp_tpu_torch.det import train as dtrain
    from epropnp_tpu_torch.det.api import inference_detector
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.det.pipelines import imread
    from epropnp_tpu_torch.utils.checkpoint import save_checkpoint
    cfg, model = build_det_model(torch, device, seed=0)
    conv = model.bbox_head.detector.conv_cls
    infos = NuScenes3DDataset(setup['paths']['val'],
                              img_prefix=setup['root']).data_infos
    infos = infos[:DATASET_BATCH]
    imgs = [imread(os.path.join(setup['root'], i['img_path']))
            for i in infos]
    fn = dtest.make_inference_fn(model, cfg)
    captured, dense = [], fn.dense
    fn.dense = lambda img: captured.append(dense(img)) or captured[-1]
    with torch.no_grad():
        conv.weight.mul_(DP_EVAL_CLS_GAIN)
        inference_detector(
            model, cfg, imgs, [i['cam_intrinsic'] for i in infos],
            infer_fn=fn, rng=torch.Generator(device).manual_seed(0))
        outs = captured[0][0]
        bs = len(imgs)
        cls = torch.cat([o.cls_score.reshape(bs, -1, o.cls_score.shape[-1])
                         for o in outs], 1).float()
        ctr = torch.sigmoid(torch.cat([o.centerness.reshape(bs, -1, 1)
                                       for o in outs], 1).float())
        lo, hi = -1e3, 1e3
        for _ in range(60):
            mid = (lo + hi) / 2
            n = float(((torch.sigmoid(cls + mid) * ctr) >= 0.04).sum()) / bs
            lo, hi = (mid, hi) if n < DP_EVAL_CANDIDATES else (lo, mid)
        conv.bias.add_(hi)
        top = torch.sort((torch.sigmoid(cls + hi) * ctr).reshape(bs, -1),
                         -1, descending=True)[0][:, :DP_EVAL_CANDIDATES + 1]
    gaps = (top[:, :-1] - top[:, 1:]).min(1)[0]
    print('path w: detector ' + json.dumps(dict(
        cls_gain=DP_EVAL_CLS_GAIN, cls_bias_shift=hi,
        candidates_per_image=DP_EVAL_CANDIDATES,
        smallest_score_gap_in_the_top=[float(g) for g in gaps])))
    path = os.path.join(setup['root'], 'dp_eval_detector.pt')
    save_checkpoint(path, dtrain.DetTrainState(
        model, dtrain.make_optimizer(cfg, model)))
    return path


def match_detections(got, want):
    """The largest gap over tolerance between two submissions' detections,
    matched per sample token and class in any order (rows of near-equal
    scores may swap); inf where one has a detection the other lacks.
    Returns ``(gap, matched)``."""
    def row(d):
        return np.array(d['translation'] + d['size'] + d['rotation']
                        + [d['detection_score']])
    worst, n = 0.0, 0
    if got.keys() != want.keys():
        return float('inf'), 0
    for token, dets in want.items():
        pool = [(d['detection_name'], row(d)) for d in got[token]]
        if len(pool) != len(dets):
            return float('inf'), n
        for d in dets:
            name, r = d['detection_name'], row(d)
            gaps = [float(np.max(np.abs(v - r) / (DP_EVAL_ATOL
                                                  + DP_EVAL_RTOL
                                                  * np.abs(r))))
                    if k == name else float('inf') for k, v in pool]
            j = int(np.argmin(gaps))
            worst = max(worst, gaps[j])
            pool.pop(j)
            n += 1
    return worst, n


def path_dp_det_eval(torch, device, setup, tta, q=None):
    """Path w: ``tools.test_det.main --data-parallel`` on 2 ranks (gloo,
    one card) over path q's 12 val frames in batches of 6 from path q's
    ``latest.pt`` (``DetConfig.v1b()``, as the CLI builds it), plain or
    with ``--tta``: each rank serves 3 frames of each batch, launching K3
    36 times a batch (72 with TTA), and rank 0 fuses and scores. The
    detector is phase g's weights with detections (:func:`dp_eval_checkpoint`)
    in the CLI's ``DetConfig.v1b()``. The detections equal, at rtol/atol
    1e-4, one single-process run per shard (rows 0-2 and 3-5 of each batch)
    with the same seed in this process (not counted); NDS and mAP beside
    the per-shard runs' and path q's (``q``, another model)."""
    from epropnp_tpu_torch.det import api
    from epropnp_tpu_torch.det.config import DetConfig
    from epropnp_tpu_torch.det.nuscenes_dataset import NuScenes3DDataset
    from epropnp_tpu_torch.tools.test_det import infer_dataset
    label = f'path w{" TTA" if tta else ""}'
    setup = det_dataset_setup(torch, device, setup)
    out_dir = os.path.join(setup['root'], f'dp_eval_{int(tta)}')
    checkpoint = dp_eval_checkpoint(torch, device, setup)
    argv = ['--config', 'v1b', '--checkpoint', checkpoint,
            '--ann', setup['paths']['val'], '--data', setup['root'],
            '--out', out_dir, '--batch-size', str(DATASET_BATCH),
            '--data-parallel'] + (['--tta'] if tta else [])
    raw = os.path.join(out_dir, 'detections_rank{rank}.pkl')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    results = dp_spawn(torch, 'w', dict(argv=argv, raw=raw))
    wall = time.perf_counter() - t0
    per_batch = {'K3-f32': 72 if tta else 36}
    n_batches = len(NuScenes3DDataset(setup['paths']['val'],
                                      img_prefix=setup['root'])) \
        // DATASET_BATCH
    for r in results:
        want = {k: v * n_batches for k, v in per_batch.items()}
        assert r['launches'] == want, \
            f'{label} rank {r["rank"]}: launches {r["launches"]}, {want}'
    metrics = next(r['metrics'] for r in results if r['rank'] == 0)

    def reference():
        cfg = DetConfig.v1b()
        model = api.init_detector(cfg, checkpoint=checkpoint, device=device)
        dataset = NuScenes3DDataset(setup['paths']['val'],
                                    img_prefix=setup['root'])
        shards, captured = [], []
        with torch.no_grad():
            for r in range(DP_RANKS):
                with DetectionCapture() as capture:
                    shards += infer_dataset(
                        model, cfg, dataset, setup['root'], DATASET_BATCH,
                        tta, rng=torch.Generator(device).manual_seed(0),
                        shard=(r, DP_RANKS))
                captured.append(capture.batches)
        shards.sort(key=lambda x: x[0])
        assert [f for f, _ in shards] == list(range(len(dataset)))
        return dataset.evaluate([x for _, x in shards],
                                out_dir + '_ref'), captured
    want, captured = uncounted(reference)
    import pickle
    slot_gap, slots = 0.0, 0
    for r in results:
        with open(r['raw'], 'rb') as f:
            gap, n = detections_gap(pickle.load(f), captured[r['rank']])
        slot_gap, slots = max(slot_gap, gap), slots + n
    with open(os.path.join(out_dir, 'results_nusc.json')) as f:
        got_det = json.load(f)['results']
    with open(os.path.join(out_dir + '_ref', 'results_nusc.json')) as f:
        want_det = json.load(f)['results']
    worst, n_det = match_detections(got_det, want_det)
    worst = max(worst, slot_gap)
    q = q or {}
    out = dict(ranks=DP_RANKS, wall_s_with_start=wall,
               nd_score=metrics['nd_score'], mean_ap=metrics['mean_ap'],
               per_shard_nd_score=want['nd_score'],
               per_shard_mean_ap=want['mean_ap'],
               path_q_nd_score=q.get('nd_score'),
               path_q_mean_ap=q.get('mean_ap'), candidate_slots=slots,
               fused_detections=n_det, worst_gap_over_tolerance=worst)
    print(f'{label}: ' + json.dumps(out))
    assert slots > 0, f'{label}: no candidate above the score threshold'
    assert worst <= 1.0, f'{label}: detections off the per-shard runs'
    return dict(out, rank_launches={
        k: sum(r['launches'].get(k, 0) for r in results)
        for k in per_batch})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--only', default=None,
                        help='comma-separated kernel phases to run alone '
                             '(a, a-groups, b, b+, e, e+, f, i, l, m, or a '
                             'card-vs-CPU step such as "s card vs CPU"); '
                             'the main run (paths c-w) is skipped')
    parser.add_argument('--paths', default=None,
                        help='comma-separated paths of the main run to run '
                             'alone (e.g. "u,u one,w"), without the kernel '
                             'phases; prints no ok line')
    parser.add_argument('--dp-rank', default=None, help=argparse.SUPPRESS)
    parser.add_argument('--dp-args', default='{}', help=argparse.SUPPRESS)
    parser.add_argument('--dp-out', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    only = args.only
    only = None if only is None else set(only.split(','))
    paths_only = None if args.paths is None else set(args.paths.split(','))
    if paths_only is not None:
        only = set()  # no kernel phase
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; nothing run',
              file=sys.stderr)
        return 2
    if args.dp_rank is not None:  # one rank of path u, v or w
        return dp_rank_main(args.dp_rank, json.loads(args.dp_args),
                            args.dp_out)
    sys.path.insert(0, REPO)
    # the CLIs' settings (TF32 off, cuDNN's exhaustive search), set before
    # the first convolution: the default f32 heuristics run several Det
    # convs as FFT tiling (phase g)
    from epropnp_tpu_torch.utils.cuda_setup import configure_cuda
    configure_cuda()
    device = torch.device('cuda', 0)
    t_run = time.perf_counter()

    from epropnp_tpu_torch import kernels
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load_library()
    print(f'build: {os.path.relpath(lib_path, REPO)} in '
          f'{time.perf_counter() - t0:.1f} s')
    with open(lib_path + '.log') as f:
        log = f.read()
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('ptxas: ' + line.strip())
    print(gpu_name_and_limit())

    failed, entries = [], {}
    for kernel, (key, count) in KERNEL_INSTANCES.items():
        spills = ptxas_spills(log, key)
        print(f'ptxas: {kernel} spill bytes per instance {json.dumps(spills)}')
        if len(spills) < count or any(spills.values()):
            failed.append(f'{kernel}: ptxas spills (or fewer than {count} '
                          'instances)')
    if any(r['err'] for r in k1k2_occupancy(kernels.load_library())):
        failed.append('K1/K2 occupancy query')
    # the kernels against their twins (a, b: K1, K2; b+: K2's legacy
    # layout; e, e+: K3's variants; f: K1 in the Det mode); these launches
    # are not the main run's
    for name, phase in (('a', phase_a), ('a-groups', phase_a_groups),
                        ('b', phase_b),
                        ('b+', phase_b_legacy), ('e', phase_e),
                        ('e+', phase_e_variants), ('f', phase_f),
                        ('i', phase_i), ('j card vs CPU', train_card_vs_cpu),
                        ('l', phase_l), ('m', phase_m),
                        ('n card vs CPU', det_train_card_vs_cpu),
                        ('s card vs CPU', det_train_bf16_card_vs_cpu),
                        ('s remat card vs CPU', lambda t, d:
                         det_train_bf16_card_vs_cpu(t, d, remat=True)),
                        ('t card vs CPU', train_bf16_card_vs_cpu),
                        ('t remat card vs CPU', lambda t, d:
                         train_bf16_card_vs_cpu(t, d, remat=True))):
        if (only is None and name in OPT_IN_PHASES) or (
                only is not None and name not in only):
            continue
        t0 = time.perf_counter()
        try:
            entries[name] = phase(torch, device)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        print(f'wall time of phase {name}: {time.perf_counter() - t0:.1f} s')
    if only is not None and paths_only is None:
        print(json.dumps({'kernels': [e for e in entries.values()
                                      if e is not None]}, default=str))
        if failed:
            print(f'chip_smoke: FAILED phases {failed}', file=sys.stderr)
        return 1 if failed else 0

    # the main run: each path a caller drives, its counters from 0 just
    # before it and read just after it
    paths = (('c', lambda: phase_c(torch, device)),
             ('c bf16', lambda: phase_c(torch, device, bf16_backbone=True,
                                        num_requests=1,
                                        f32_lat=results.get('c'))),
             ('d', lambda: phase_d(torch, device)),
             ('b+ entry', lambda: path_legacy_entry(torch, device)),
             ('g', lambda: phase_g(torch, device)),
             ('h', lambda: phase_h(torch, device)),
             ('h bf16 gather', lambda: phase_h_bf16(torch, device)),
             ('j', lambda: path_train(torch, device, TRAIN_STEPS)),
             ('k', lambda: path_fit_identity(torch, device)),
             ('n', lambda: path_det_train(torch, device)),
             ('s', lambda: path_det_train_bf16(torch, device, False,
                                               results.get('n'))),
             ('s remat', lambda: path_det_train_bf16(torch, device, True,
                                                     results.get('n'))),
             ('t', lambda: path_train_bf16(torch, device, False,
                                           results.get('j'))),
             ('t remat', lambda: path_train_bf16(torch, device, True,
                                                 results.get('j'))),
             ('o', lambda: path_det_checkpoint_tta(torch, device)),
             ('p epnp_device', lambda: path_sixdof_eval(
                 torch, device, 'epnp_device', eval_setup)),
             ('p rslm', lambda: path_sixdof_eval(torch, device, 'rslm',
                                                 eval_setup)),
             ('q train', lambda: path_det_dataset_train(torch, device,
                                                        q_setup)),
             ('q train sync', lambda: path_det_dataset_train(
                 torch, device, q_setup, prefetch=0)),
             ('q eval', lambda: path_det_dataset_eval(torch, device, q_setup,
                                                      tta=False)),
             ('q eval tta', lambda: path_det_dataset_eval(
                 torch, device, q_setup, tta=True)),
             ('q metrics', lambda: path_det_metrics_check(torch, device,
                                                          q_setup)),
             ('w', lambda: path_dp_det_eval(torch, device, q_setup, False,
                                            results.get('q eval'))),
             ('w tta', lambda: path_dp_det_eval(
                 torch, device, q_setup, True, results.get('q eval tta'))),
             ('r train', lambda: path_lm_train(
                 torch, device, r_setup, results.get('j', {}).get('ms'))),
             ('r eval epnp_device', lambda: path_lm_eval(
                 torch, device, r_setup, 'epnp_device')),
             ('r eval rslm', lambda: path_lm_eval(torch, device, r_setup,
                                                  'rslm')),
             ('r validate', lambda: path_lm_validate(torch, device)),
             ('u', lambda: path_dp_sixdof(torch, device)),
             ('u one', lambda: path_world_of_one(torch, device, 'u')),
             ('v', lambda: path_dp_det(torch, device)),
             ('v one', lambda: path_world_of_one(torch, device, 'v')))
    eval_setup, q_setup, r_setup = {}, {}, {}
    totals = dict.fromkeys(kernel_counters(), 0)
    results = {}
    for name, fn in paths:
        if paths_only is not None and name not in paths_only:
            continue
        t0 = time.perf_counter()
        try:
            counts = drive(torch, lambda: results.__setitem__(name, fn()))
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            failed.append(name)
            continue
        finally:
            print(f'wall time of path {name}: '
                  f'{time.perf_counter() - t0:.1f} s')
        print(f'launches in path {name}: {json.dumps(counts)}')
        for key, value in counts.items():
            totals[key] += value
        ranks = results[name].get('rank_launches') \
            if isinstance(results[name], dict) else None
        if ranks is not None:  # the launches of the path's rank processes
            print(f'launches of the ranks of path {name}: '
                  + json.dumps(ranks))
            for key, value in ranks.items():
                totals[key] += value
        if name == 'j':
            others = {k: v for k, v in counts.items()
                      if k != 'K1-train' and v}
            if counts['K1-train'] != TRAIN_K1_PER_STEP * TRAIN_STEPS \
                    or others:
                print(f'path j: K1 training-mode launches '
                      f'{counts["K1-train"]}, expected '
                      f'{TRAIN_K1_PER_STEP * TRAIN_STEPS}; other kernels '
                      f'{others}', file=sys.stderr)
                failed.append('j: K1 not launched twice per step')
        if name == 'n':
            expected = {k: v * DET_TRAIN_STEPS
                        for k, v in DET_STEP_LAUNCHES.items()}
            if {k: v for k, v in counts.items() if v} != expected:
                print(f'path n: launches {counts}, expected {expected}',
                      file=sys.stderr)
                failed.append('n: Det training launches')
        expected = {'q train': {k: v * DATASET_TRAIN_STEPS
                                for k, v in DET_STEP_LAUNCHES.items()},
                    'q train sync': {k: v * DATASET_TRAIN_STEPS
                                     for k, v in DET_STEP_LAUNCHES.items()},
                    't': {'K1-train': TRAIN_K1_PER_STEP * TRAIN_STEPS},
                    't remat': {'K1-train': TRAIN_K1_PER_STEP * TRAIN_STEPS},
                    's': {'K2-bounds': 2 * DET_TRAIN_STEPS,
                          'K3-bf16': DET_BF16_K3_PER_STEP * DET_TRAIN_STEPS,
                          'K1-train': 2 * DET_TRAIN_STEPS},
                    's remat': {'K2-bounds': 2 * DET_TRAIN_STEPS,
                                'K3-bf16': 2 * DET_BF16_K3_PER_STEP
                                * DET_TRAIN_STEPS,
                                'K1-train': 2 * DET_TRAIN_STEPS},
                    'q eval': {k: v * 2 for k, v in
                               DATASET_EVAL_LAUNCHES[False].items()},
                    'q eval tta': {k: v * 2 for k, v in
                                   DATASET_EVAL_LAUNCHES[True].items()},
                    'q metrics': {},
                    'r train': {'K1-train': 2 * LM_EPOCHS
                                * LM_FRAMES['train'] // LM_BATCH},
                    'r eval epnp_device': {'K1': LM_FRAMES['test']
                                           // LM_BATCH},
                    'r eval rslm': {'K1': 2 * LM_FRAMES['test'] // LM_BATCH},
                    'r validate': lm_validate_launches(),
                    # the ranks' own launches are checked in the paths
                    'u': {}, 'v': {}, 'w': {}, 'w tta': {},
                    'u one': {'K1-train': 3 * TRAIN_K1_PER_STEP
                              * WORLD_OF_ONE_STEPS},
                    'v one': {k: 3 * v * WORLD_OF_ONE_STEPS
                              for k, v in DET_STEP_LAUNCHES.items()},
                    }.get(name)
        if expected is not None \
                and {k: v for k, v in counts.items() if v} != expected:
            print(f'path {name}: launches {counts}, expected {expected}',
                  file=sys.stderr)
            failed.append(f'{name}: launches')
    if 'tmp' in eval_setup:
        eval_setup['tmp'].cleanup()
    for setup in (q_setup, r_setup):
        if 'root' in setup:
            shutil.rmtree(setup['root'], ignore_errors=True)
    for name in ('j', 'n'):
        if name in results:
            t0 = time.perf_counter()
            try:
                results[name]['profile']()
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                failed.append(f'{name} profile')
            print(f'wall time of the {name} profile: '
                  f'{time.perf_counter() - t0:.1f} s')
    print('launches on the main run: ' + json.dumps(totals))
    if paths_only is not None:
        if failed:
            print(f'chip_smoke: FAILED phases {failed}', file=sys.stderr)
        return 1 if failed else 0
    variants = entries.get('e+') or [None, None]
    rows = {'K1': entries.get('a'), 'K1-train': entries.get('i'),
            'K2': entries.get('b'), 'K2-bounds': entries.get('l'),
            'K2-legacy': entries.get('b+'), 'K3-f32': entries.get('e'),
            'K3-bf16': variants[0], 'K3-int8': variants[1]}
    for key, row in rows.items():
        if totals[key] == 0:
            failed.append(f'{key}: kernel not launched on the main run')
        if row is not None:
            row['launches'] = totals[key]
    present = [row for row in rows.values() if row is not None]
    print(f'wall time of the run: {time.perf_counter() - t_run:.1f} s')
    if present:
        print(json.dumps({'kernels': present}))
    if failed:
        print(f'chip_smoke: FAILED phases {failed}', file=sys.stderr)
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
