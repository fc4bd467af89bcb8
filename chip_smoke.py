#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpu3dsad_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

 1. device and build: the card's name and power limit (nvidia-smi), then
    nvcc builds the kernels from tpu3dsad_torch/csrc, one process per
    source, all at once, and where this run built them, each FPS kernel
    template's registers and spills from ptxas (a register tier must not
    spill); then one forward + backward of the config-#3 training step,
    recording the inputs of each of its kernel launches (and three_nn
    calls) for the phases below;
 2. the FPS kernel against its plain PyTorch version on the card, at the 5
    shapes of a served request and on the 5 recorded inputs of the
    training step and of the config-#4 eval batch, plus masked,
    all-masked and tied clouds, a grid repeated along N (ties across the
    CTAs' slices, B > 1), N not a multiple of C*T, slices wholly masked,
    forced plans that leave CTAs with no point (register and memory
    tiers), and B = 1 at N = 65536: picks must be exactly equal;
 3. the ball-query kernel (B3) against its plain version on the 7
    recorded inputs of a served request, of the training step and of the
    config-#4 eval batch (each launch compared 3 times: idx and cnt
    exactly equal); then the 7 request shapes on uniform clouds and the
    edge cases (ties, points at d2 == r2 and one ulp inside, centers at a
    tile box's faces +- r, masked tiles and an all-masked cloud, N % 32 !=
    0, K > N, empty and saturated balls, a spatially sorted cloud where
    most tiles skip) at every template instance of the scan, 3 times each;
 4. serving: SizeAdaptiveDetector(ModelConfig(num_classes=10)) with seeded
    random weights answers requests of 32 scenes x 20480 points through
    serving.build_inference_fn: one warm-up request, then the counted
    ones. Outputs must be finite and of the right shapes, the launch
    counters must show 5 FPS, 7 ball-query and 1 NMS-walk launches per
    request and no scatter, and one request rerun with the plain ops on
    the same CUDA tensors must give the same keep mask and launch nothing.
    Then the NMS walk kernel (csrc/nms.cu) against the plain loop on the
    walk's recorded inputs of phase 1 (a served request of 32 scenes, one
    raw scan served at B = 1 as the latency cell serves it, and the parse
    of the config-#4 eval batch), each launch compared 3 times: keep
    exactly equal;
 5. the scatter kernel (the gather/group backward, which sums each row
    in index order, whatever its length) on the 9 recorded launches of
    the training step (its own gradients and indices): bitwise equal to
    np.add.at in float32 on the host, the same bits in 3 launches, and
    exactly equal to the plain version on integer-valued gradients of
    each shape; then the same on heavy collisions (all of U on 8 rows),
    K zeros from masked centers, -1 / >= n indices and an odd width;
    beside each call, its longest row;
 6. training: train_detector.run_detector at config #3 (ModelConfig(), 18
    classes, 8 scenes x 40960 points, synthetic batches made on the card)
    for one epoch of 8 steps. Losses must be finite, the counters must show
    5 FPS, 7 ball-query and 9 scatter launches per step, parameters and BN
    statistics must have moved, the checkpoint must resume at step 8,
    the step's three_nn calls must pick the same indices under the
    training precision as in full fp32, and one step from one saved state
    and batch must give the same loss on the kernel path and the plain
    path and bitwise the same gradients (every kernel of the step gives
    its plain version's bits);
 7. the large-cloud FPS entry (B2, one thread-block cluster per cloud)
    against its plain version: on the cropped, bucketed config-#4 scene
    that phase 1's batch loading gave it (122880 raw points, 16384 picks;
    compared 3 times, since a missed memory fence shows as a rare wrong
    pick), N just above 65536, N = 786432 (the memory tier), a masked
    tail, an all-masked cloud and duplicated points (ties across the
    cluster's slices): picks exactly equal, and the B1 entry's on the
    same B = 1 input;
 8. the sorted ball query (B4: the Morton-code kernel, two torch sorts,
    then B3 on the permutations with the map-back in its epilogue) against
    the same glue around the plain version (sorted_views, plain, map_back),
    on the recorded SA1 inputs of configs #4, #5 and #3 and on masked junk
    and an all-masked cloud, 3 times each: idx and cnt exactly equal, the
    kernel's codes equal to the plain ones; counts equal to the exact
    tier's, the chosen set equal to it where a ball holds fewer than K
    points, and K distinct in-ball points where it is full;
 9. config #4 evaluation: eval_detector.run_eval (preset=outdoor,
    data.device_preproc=true, batch 8) over 12 val scenes of 122880 points
    with a checkpoint of seeded random weights, twice. First sweep: 12 B2
    launches (one per scene), 5 FPS, 7 ball-query and 1 NMS-walk launches
    per batch,
    2 batches (the second padded by scene_mask), finite metrics with
    0 <= mAP <= 1, the FPS caches written. Second sweep, with
    ops_fast_grouping=true ops_fast_mode=sorted: no B2 launch (cache
    hits), one sorted ball query per batch at SA1 beside 6 exact ones.
    One batch rerun with the plain ops gives the same keep in both modes;
10. host-fed training of config #3 from files: 64 train and 8 val
    ScanNet-format scenes of 50000 points (data/synthetic_indoor.py, seed
    0; the loader subsamples to 40960). Run A: run_detector with the
    per-scene loader, host augmentation, colour features, 3 vote
    candidates, batch 8, one epoch of 8 steps (Batcher, device_prefetch),
    then the val sweep inside training: 5 / 7 / 9 launches a step and
    5 / 7 / 1 (the NMS walk) an eval batch, finite losses and metrics,
    best.json and best/
    written; the best snapshot restored into a fresh model and evaluated
    again gives the logged metrics; a second run_detector resumes from
    ckpt_8.pt and not from best/ (planted at another step). Run B: the
    same root packed (pack_dataset), then data.name=packed with
    augmentation on the card and compact votes: the same counts. One Run-A
    batch through the kernel path and the plain path: the same loss and
    bitwise the same gradients;
11. config #4 training from files: 16 train and 4 val KITTI-format scenes
    of 122880 points (data/synthetic_outdoor.py, seed 1). Run A:
    run_detector at preset=outdoor with B2 in the loader
    (data.device_preproc) and host augmentation, batch 8, 4 epochs of 2
    steps, the val sweep after the last: B2 once per scene whose FPS cache
    it writes, 5 / 7 / 9 launches a step and 5 / 7 / 1 a sweep batch (the
    counts of a CPU trace of the same step), finite losses and metrics,
    parameters and BN statistics moved; every scene then cached, a second
    call resumes at step 8 with no launch. Run B: the same root with
    compact votes, density-biased proposal sampling and oriented NMS: no
    B2, the same counts and one oriented-IoU launch (its sweep's parse);
    its first host batch decoded on the card is bitwise run A's (points,
    vote targets and mask); oriented_bev_iou on the card (the kernel,
    csrc/iou.cu) on its sweep's decoded corners within 1e-4 of the host
    evaluator (4096 pairs, float64 corners); the kernel on the inputs of
    that sweep's oriented parse (8 x 256 class-shifted boxes, the KITTI
    cell's shape, each row in its box's frame), in 3 launches exactly 0
    where the footprints lie apart and within 1e-6 of the plain chain on
    pairs at least 0.1 m across.
    Then the kernel inputs of one step with FPS sampling and one with
    density sampling, recorded: B1 and B3 equal to plain in 3 launches
    each, B5 bitwise np.add.at; one step each with FPS sampling, density
    sampling and the lineage head (5 / 5 / 7 launches) on the kernel and
    the plain path: the same loss and bitwise the same gradients; B2 on a
    loader scene against plain.
12. k-step blocks (train.steps_per_call=4: on the card the first block
    runs eagerly, then one step is captured into a CUDA graph and each
    block replays it 4 times). (a) Config #3 with device synth: run_detector
    for 8 steps at k = 1 twice, which must be bitwise equal, then at k = 4
    (a warm-up block, then a replayed one), which must be bitwise equal to
    them: losses, parameters, BN statistics, Adam moments and count; the
    counters see 4 eager steps and the captured one (25 / 35 / 45). Then a
    block built apart: a warm-up block, the capture (one step's launches
    through the wrappers), then one replayed block under torch.profiler,
    which must show 5 FPS, 7 + 7 ball-query and 9 scatter kernels a
    replayed step and no wrapper call. (b) Phase 10's
    packed split (run B's options) for 2 epochs at k = 1 and k = 4 through
    the stacked host feed: the counts (k = 4: 5 steps through the
    wrappers), finite losses and sweep; then 3 stacked packed blocks
    (augmented on the card; each at another BN momentum, the rate halved
    after steps 4 and 8) through a block, bitwise 12 eager steps on the
    same slices.
13. config #1, the PointNet++ classifier (models/classifier.py). (a) The
    SSG model, 40 classes, seeded random weights, answers 20 clouds of
    1024 points one at a time in eval mode (fp32) after a warm-up: finite
    logits, 2 FPS and 2 ball-query launches a cloud and no scatter; one
    cloud's launches equal to the plain versions (FPS and ball-query
    indices) and its logits within rtol 1e-5, atol 1e-6 of the plain
    path's.
    (b) train_classifier.run_classifier trains MSG (40 classes, 16 x 1024
    points, synthetic clouds) for one epoch, cut from the reference's 100
    steps to 8, and its 8-batch val sweep: 2 / 6 / 3 launches a step and
    2 / 6 a val batch, finite losses, parameters and BN statistics moved,
    a second call resumes at step 8 with no launch; one step from the
    trained state on the kernel
    path and the plain path (dropout from one seed): the same loss and
    bitwise the same gradients. (c) The 2 + 6 + 3 launches of that step
    recorded (ball query at K = 16, 32, 128 and 32, 64, 128; the scatter
    323 channels wide, two channel slices): FPS equal in 3 launches, ball
    query in 3, the scatter bitwise np.add.at. (d) The shape
    benchmark: data/synthetic_shapes.py (64 + 16 meshes of each of 10
    families, seed 0), data/preproc_modelnet.py (4096 points a mesh), then
    run_classifier on r5's recipe (MSG, 512 points, batch 16, lr 1e-3, val
    after each epoch) for 4 epochs: the launches of 160 steps and 4
    sweeps, the val accuracy of each epoch, at least 0.9 after the last.
14. the exported serving program (serving.export_detector: torch.export
    of forward + decode + NMS with FPS and ball query as the custom ops
    of ops/library.py). Phase 4's server, config #5 at 32 x 20480,
    exported and loaded (the graph's op nodes 5 fps + 7 ball_query + 2
    fp32_cross + 1 greedy_suppress + 30 bn_relu), one warm-up request, then 5
    requests: the six outputs bitwise the eager program's, 5 FPS, 7
    ball-query and 1 NMS-walk launches a loaded request, no scatter. An
    export under ops_fast_grouping=true
    ops_fast_mode=sorted adds one morton_codes node and one sorted call a
    request, bitwise eager. Then phase 4's model as a checkpoint:
    serving.main ckpt= ... out= at train.batch_size=1, run= on raw scenes
    of 50000 (subsampled) and 12000 (padded) points, detection for
    detection the eager program on prepare_scene_batch's tensors, 5 + 7
    + 1 launches a scene; the same for a ScanNet colour model on 0-255
    colours (source_dataset=scannet: run= scales them by 1/256); then
    python -m tpu3dsad_torch.demo on the first checkpoint in its own
    process: its files, its scene the synthetic train_batch of
    default_rng(7), its detections the eager program's (classes equal,
    the floats within 1e-5).
15. from raw releases, through the port's own tools. (a) Raw files
    written here from a seed: 32 train + 8 val ScanNet scans of 60000
    vertices (binary PLY, aggregation, segments, axis alignment, the
    label TSV) and 8 + 2 KITTI scans of 120000 points (velodyne, labels,
    calib), converted by python -m tpu3dsad_torch.data.preproc_scannet
    (every scan subsampled to the 50000 cap) and preproc_kitti, each in
    its own process; data.validate passes on both. (b) A
    lineage checkpoint.tar for config #3's model in lineage mode (seeded
    tensors under the lineage's names and shapes) through python -m
    tpu3dsad_torch.utils.import_torch: nothing skipped, each placed
    tensor bitwise its source. (c) tpu3dsad_torch.train.main on the
    converted scans from the import (ops_impl=pallas, profile_dir,
    tb_dir): it resumes at step 1, 8 steps of 5 / 5 / 7 launches and 2
    sweeps of one batch (5 / 5 / 1), finite losses, a trace in profile_dir,
    an event file in tb_dir or, without tensorboard, the note on stderr;
    eval_detector.main on the result (0 <= mAP <= 1); serving.main
    export at B = 1 and run= on a converted val scene: 5 + 5 + 1 launches,
    the detections those of the plain ops. (c') train.steps_per_call=2
    from scratch with the first epoch profiled: the CUDA graph captured
    under an active profiler, finite losses. (d) tpu3dsad_torch.train.main
    at preset=outdoor on the converted KITTI scans with B2 in the loader,
    one step: B2 once per scene it caches, 5 / 7 / 9 launches. (e)
    ops.knn at [2, 16384, 16384], k = 16, past its slab limit: the
    indices of the direct path forced on the same inputs.
16. parallelism (tpu3dsad_torch/parallel) on this one card: ranks are
    processes started by parallel.launch.spawn, every one on cuda:0,
    joined by gloo on CUDA tensors, asked for by name (NCCL puts one rank
    on a card; compute runs on the card, the collectives go through the
    host). (a) Data parallelism: config #3, 8 x 40960 points split over
    2 ranks of 4 scenes, 3 steps in fp32, each step from the state before
    it of a world-1 run here on the same batches: the loss within rtol
    1e-5 (or 4 x the distance of world 1 with its scenes in reverse
    order, the same sums in another order, where FPS picks on the votes
    flip: both named), parameters within 2e-2, the train-mode gradients'
    relative L2 distance under 1e-2 (or 4 x that floor), the eval-mode
    gradients within the port's per-tensor bar, the ranks' states
    bitwise equal, 5 / 7 / 9 launches a rank a step; rank 0's first step
    recorded, its FPS and ball-query launches equal to plain and its
    scatters bitwise np.add.at. (b) The val
    sweep of 2 batches at world 2: every metric within rtol 1e-5 of world
    1's. (c) Context parallelism: config #4's model (preset=outdoor, its
    published widths, cp_stages=2) on one KITTI-style scene of 122880
    points with a masked tail, B = 1, 2 ranks: seed_inds, seed_xyz,
    proposal_xyz, raw_params and objectness_scores bitwise the unsharded
    forward (B1, B3); one collective a pick; rank 0's kernel launches
    equal to plain; launches a rank. (d)
    Hybrid DP x CP on a 2 x 2 mesh of 4 ranks: config #4's SA1 stage and
    a kNN at B = 2 x 122880, bitwise the unsharded ops. (e) The user's
    entry: python -m torch.distributed.run --standalone
    --nproc-per-node=1 -m tpu3dsad_torch.train, NCCL, 2 config-#3 steps
    from 16 ScanNet-format scenes: exit 0. A failing rank fails the
    phase.
17. data parallelism at train.steps_per_call=4: 2 ranks as in phase 16,
    config #3 at 8 x 40960 in fp32. On a data group of more than one rank
    a block runs its 4 steps eagerly (train_lib.DetectorTrainBlock.mode).
    (a) The card's synthetic feed: run_detector for 8 steps at k = 4 and
    at k = 1 from one seed on the same ranks, bitwise equal (losses,
    parameters, BN statistics, Adam moments, count); the block's mode
    printed by rank 0 alone ("eager (data group of 2 ranks)"); 20 / 28 /
    36 launches a block a rank; each run resumed from its ckpt_8.pt for 8
    more steps, bitwise equal again; rank 0 alone logs (steps 4, 8, 12,
    16) and writes ckpt_8.pt, ckpt_16.pt and train_meta.json. (b) The
    stacked host feed on phase 10's packed split with augmentation on the
    card: run_detector at k = 4 for 8 steps (finite losses, the counts);
    each rank's stacked blocks hold its rows on axis 1 of the global
    draw; 2 blocks through a block built apart, bitwise 8 eager DP steps
    on the same slices from the same state and generator (rank 0's first
    step recorded: FPS and ball query equal to plain, the scatters bitwise
    np.add.at). (c) World 1 at k = 4 on the synthetic feed from the same
    seed (the captured step, mode graph), and again for 8 steps with each
    batch's scenes reversed (the same sums in another order): step 1's
    loss within rtol 1e-5 of world 2's, or 4 x the reversed run's step-1
    distance; steps 2-8 printed beside world 2's and the reversed run's,
    each with its relative gap to world 1, with no bar.
18. recipe R1 of chip_recipes.py (the 18-class host-synthetic recipe of
    docs/experiments/r3_18cls_votefactor3.jsonl: 8 x 8192 points, 128
    proposals, lr 2e-3) for its first 50 epochs (400 steps) through
    run_detector at train.seed=2, the val sweep (4 batches) at epoch 49:
    5 / 7 / 9 launches a step and 5 / 7 / 1 a val batch, finite losses,
    printed at the reference log's steps beside its losses, and mAP@0.25
    at least 0.118, half the reference's 0.2352 at that epoch. Then one
    step of the trained model on a host batch, recorded: B1 and B3 equal
    to plain in 3 launches, B5 bitwise np.add.at.
19. 3DSSD (preset=3dssd, models/ssd3d.py). The feature-FPS kernel
    (csrc/ffps.cu) against its plain version on the card at the
    eval-3dssd-kitti-b16 cell's two launches (B = 16: 4096 x 67 -> 512,
    512 x 131 -> 256), on ragged clouds, a masked tail, CTA slices wholly
    masked, tied values, an all-masked cloud and the largest cloud 8 CTAs'
    shared memory holds at 67 values: picks exactly equal in 3 launches
    each. Then the model built by train_detector.build_detector with
    seeded weights, BatchNorm calibrated on a first batch, served through
    serving.build_inference_fn as the cell serves it (16 scans x 16384
    points of xyz + intensity): one warm-up request, then 3 counted ones
    from zeroed counters, 3 FPS (B1), 2 feature-FPS, 11 ball-query, 1
    oriented-IoU and 1 NMS-walk launches a request; finite outputs of the
    right shapes, at most 100 boxes kept a scan; one request rerun with
    the plain ops gives the same keep and classes and launches nothing.
20. eval-mode BatchNorm + ReLU (csrc/bn_relu.cu). A served request of each
    benchmark configuration at its cell's batch (sadet-sunrgbd-20k at 32
    and 1, sadet-scannet-40k at 8, sadet-kitti-16k at 8, 3DSSD at 16),
    seeded weights, BatchNorm calibrated: every layer's kernel output
    bitwise the plain chain on the same input, one launch a BatchNorm
    layer (30 and 41, BN_RELU_REQUEST) beside the request's other
    launches, and every output bitwise the same request with the plain
    chain in the kernel's place. Run it alone with python3 -c "import
    chip_smoke as c; c.phase_device(); c.phase_bn_relu()".
21. Group-Free 3D (preset=groupfree3d, models/groupfree.py). The box
    point-count kernel (csrc/box_points.cu) against its plain version on
    the card at the eval-groupfree-scannet-b16 cell's shape (16 rooms of
    50000 points padded to 51200, 768 boxes a room) and on the edge cases
    of BOX_POINTS_CASES (points exactly on each face, ragged and masked
    clouds, an all-masked cloud, no point, no box, one box, the largest
    cloud): counts exactly equal in 3 launches each. Then the model built
    by train_detector.build_detector, BatchNorm calibrated on a first
    batch, served through serving.build_inference_fn as the cell serves
    it (16 rooms x 51200 points): one warm-up request, then 3 counted
    ones from zeroed counters, 4 FPS (B1: the SA levels; KPS replaces the
    proposal FPS), 4 ball-query, 1 box-point and 1 NMS-walk launches a
    request (GROUPFREE_REQUEST); finite outputs of 768 boxes a room; one
    request rerun with the plain ops gives the same keep and classes and
    launches nothing; the 3 requests served again give every field
    bitwise (the cell holds each request of a checked batch to one
    reference serve). Run it alone with python3 -c "import chip_smoke as
    c; c.phase_device(); c.phase_groupfree()".

Phase 1 also records the inputs of every kernel launch of one served
request and of one config-#4 eval batch and its parse (after loading the
batch, which runs B2 once per scene), and the NMS walk's of one raw scan
served at B = 1, for phases 2, 3, 4 and 8.

Both sides of each comparison run on the same card; a differing pick is
printed, never hidden by a tolerance. Nothing here is timed but the
phases: the line before the last gives each phase's seconds, the last
names the device. Kernels alone are timed by profile_port.py, the
benchmark's cells by portbench/run.py, their spans by trace_cells.py.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_recipes
from tpu3dsad_torch import (
    eval_detector,
    ops,
    serving,
    train_classifier,
    train_detector,
    train_lib,
)
from tpu3dsad_torch import train as train_entry
from tpu3dsad_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    parse_cli,
)
from tpu3dsad_torch.data import (
    get_dataset,
    kitti,
    preproc_modelnet,
    synthetic_indoor,
    synthetic_outdoor,
    synthetic_shapes,
)
from tpu3dsad_torch.data.device_pipeline import (
    decode_compact_votes,
    synthetic_detection_batch,
)
from tpu3dsad_torch.data.packed import device_prefetch, pack_dataset
from tpu3dsad_torch.data.synthetic import classification_batch
from tpu3dsad_torch.data.synthetic_outdoor import write_dataset
from tpu3dsad_torch.data.validate import validate_root
from tpu3dsad_torch.eval.ap import box3d_iou_oriented
from tpu3dsad_torch.eval.parse import parse_predictions
from tpu3dsad_torch.models.classifier import MSG_SA1, MSG_SA2, build_classifier
from tpu3dsad_torch.models.detector import SizeAdaptiveDetector
from tpu3dsad_torch.ops import library
from tpu3dsad_torch.ops import sorted as sorted_bq
from tpu3dsad_torch.ops.boxes import oriented_bev_iou
from tpu3dsad_torch.ops.cuda import ball_query as cuda_bq
from tpu3dsad_torch.ops.cuda import bn_relu as cuda_bn_relu
from tpu3dsad_torch.ops.cuda import box_points as cuda_box_points
from tpu3dsad_torch.ops.cuda import build
from tpu3dsad_torch.ops.cuda import ffps as cuda_ffps
from tpu3dsad_torch.ops.cuda import fps as cuda_fps
from tpu3dsad_torch.ops.cuda import iou as cuda_iou
from tpu3dsad_torch.ops.cuda import nms as cuda_nms
from tpu3dsad_torch.ops.cuda import scatter as cuda_scatter
from tpu3dsad_torch.ops.plain import ball_query as plain_bq
from tpu3dsad_torch.ops.plain import bn_relu as plain_bn_relu
from tpu3dsad_torch.ops.plain import box_points as plain_box_points
from tpu3dsad_torch.ops.plain import feature_fps as plain_ffps
from tpu3dsad_torch.ops.plain import furthest_point_sample as plain_fps
from tpu3dsad_torch.ops.plain import greedy_suppress as plain_walk
from tpu3dsad_torch.ops.plain import oriented_bev_iou as plain_iou
from tpu3dsad_torch.ops.plain import knn as plain_knn
from tpu3dsad_torch.ops.plain import scatter_rows as plain_scatter
from tpu3dsad_torch.ops.plain.ball_query import radius_sq
from tpu3dsad_torch.parallel import (
    collectives,
    launch,
    make_mesh,
    point_sharded,
    shard_batch,
)
from tpu3dsad_torch.serving import build_inference_fn
from tpu3dsad_torch.train_detector import build_detector, run_detector
from tpu3dsad_torch.utils import import_torch

B, N = 32, 20480  # BASELINE config #5, as bench.py runs it
REQUESTS = 5
SCAN_POINTS = 50000  # a raw scan served at B = 1, as the latency cell does
# (name, N, npoint) of the 5 FPS calls of one request
FPS_SHAPES = [("sa1", N, 2048), ("sa2", 2048, 1024), ("sa3", 1024, 512),
              ("sa4", 512, 256), ("proposal", 1024, 256)]
# (name, N, M, radius, K) of the 7 ball-query calls of one request
BQ_SHAPES = [("sa1", N, 2048, 0.2, 64), ("sa2", 2048, 1024, 0.4, 32),
             ("sa3", 1024, 512, 0.8, 16), ("sa4", 512, 256, 1.2, 16),
             ("bank_0.15", 1024, 256, 0.15, 16),
             ("bank_0.3", 1024, 256, 0.3, 16),
             ("bank_0.6", 1024, 256, 0.6, 16)]
# config #3 training: 8 scenes x 40960 points, 8 steps (one epoch)
TRAIN_B, TRAIN_N, TRAIN_STEPS = 8, 40960, 8
# config #4 evaluation: KITTI-style scenes of 122880 raw points (BASELINE
# config #4 "~120k pts"), cropped and sampled to 16384 by B2, batch 8;
# 12 val scenes make two batches, the second half padding
EVAL_SCENES, EVAL_RAW_N, EVAL_B, EVAL_N = 12, 122880, 8, 16384
EVAL_ARGS = ["preset=outdoor", "data.device_preproc=true",
             f"train.batch_size={EVAL_B}"]
SORTED_ARGS = ["ops_fast_grouping=true", "ops_fast_mode=sorted"]
# config #3 from files: ScanNet-format scenes of 50000 raw points, which
# the loader subsamples to 40960; 64 train scenes make one epoch of 8
# steps, 8 val scenes one eval batch
HOSTFED_TRAIN, HOSTFED_VAL, HOSTFED_RAW = 64, 8, 50000
# config #4 training from files: KITTI-format scenes of 122880 raw points
# (seed 1), cropped and sampled to 16384 by B2 in the loader; 16 train
# scenes make 2 steps of 8 an epoch, 4 epochs; 4 val scenes one sweep
# batch, half padding
OUT_TRAIN, OUT_VAL, OUT_EPOCHS = 16, 4, 4
OUT_STEPS = OUT_TRAIN // TRAIN_B * OUT_EPOCHS
OUT_ARGS = ["preset=outdoor", "data.device_preproc=true", "data.augment=true",
            f"train.batch_size={TRAIN_B}", f"train.num_epochs={OUT_EPOCHS}",
            f"train.eval_every={OUT_EPOCHS}", "train.log_every=4"]
# B1 / B3 / B5 launches of one outdoor train step, as a CPU trace of the
# same step counts them (tests/test_torch_outdoor_train.py)
STEP4 = {"fps": dict(fps=5, ball_query=7, scatter=9),
         "density": dict(fps=5, ball_query=7, scatter=9),
         "lineage": dict(fps=5, ball_query=5, scatter=7)}
STEP4_ARGS = {"fps": [], "density": ["model.proposal_sampling=density"],
              "lineage": ["model.proposal_mode=lineage"]}
# 3DSSD (preset=3dssd) served as the eval-3dssd-kitti-b16 cell serves it:
# 16 scans of 16384 points of xyz + intensity a request
SSD3D_B, SSD3D_N, SSD3D_REQUESTS = 16, 16384, 3
# the kernel launches of one 3DSSD request: D-FPS at SA1, SA2 and SA3 (B1),
# F-FPS at SA2 and SA3, 3 ball queries a level and 2 in the candidate
# generation, one oriented IoU and one walk (tests/test_torch_smoke_checks
# .py counts the same ops on the CPU)
SSD3D_REQUEST = dict(fps=3, ffps=2, ball_query=11, iou=1, nms=1)
# eval-mode BatchNorm + ReLU launches (csrc/bn_relu.cu) of one served
# request: one a BatchNorm layer, 30 in the VoteNet detectors (SA1-4 3
# each, FP1-2 2 each, voting 2, the radius bank's 3 x 3, the box head 2),
# 41 in 3DSSD (tests/test_torch_bn_relu.py counts the op's calls on the CPU)
BN_RELU_REQUEST = {"sadet": 30, "ssd3d": 41}
# (benchmark configuration, scenes a request) of phase 20: the serving
# cells' requests (sweep, latency, KITTI, 3DSSD) and config #3's model at
# its batch
BN_RELU_SERVED = [("sadet-sunrgbd-20k", 32), ("sadet-sunrgbd-20k", 1),
                  ("sadet-scannet-40k", 8), ("sadet-kitti-16k", 8),
                  ("3dssd-kitti-car-16k", 16)]
# Group-Free 3D (preset=groupfree3d) served as the eval-groupfree-scannet-b16
# cell serves it: 16 rooms of 50000 points padded to 51200 a request
GROUPFREE_B, GROUPFREE_N, GROUPFREE_POINTS, GROUPFREE_REQUESTS = (
    16, 51200, 50000, 3)
# the kernel launches of one Group-Free request: FPS at SA1-SA4 (B1; KPS
# picks the candidates by a sort), their 4 ball queries, the parse's one
# point count and one walk (tests/test_torch_smoke_checks.py counts the
# same ops on the CPU)
GROUPFREE_REQUEST = dict(fps=4, ball_query=4, box_points=1, nms=1)
# (name, B, N, P, kind) of the point-count checks of phase 21: the cell's
# launch, then points on the faces, ragged and masked clouds, an
# all-masked cloud, no point, no box, one box, and the largest cloud
BOX_POINTS_CASES = [("cell", 16, 51200, 768, "rooms"),
                    ("faces", 2, 300, 5, "faces"),
                    ("ragged", 3, 1000, 37, "tail"),
                    ("unmasked", 2, 777, 33, "none"),
                    ("all-masked", 1, 64, 8, "all"),
                    ("no-points", 2, 0, 5, "none"),
                    ("no-boxes", 2, 100, 0, "tail"),
                    ("one-box", 1, 4097, 1, "none"),
                    ("largest", 16, 131072, 1024, "tail")]
# (name, B, N, D, npoint, kind) of the feature-FPS checks of phase 19: the
# cell's two launches, then ragged, masked and tied clouds and the largest
# cloud that 8 CTAs' shared memory holds at 67 values a point
FFPS_CASES = [("sa2", 16, 4096, 67, 512, "cell"),
              ("sa3", 16, 512, 131, 256, "cell"),
              ("ragged", 3, 1000, 5, 100, "normal"),
              ("tail-masked", 2, 777, 67, 200, "tail"),
              ("slice-masked", 4, 4096, 67, 512, "slices"),
              ("ties", 2, 600, 4, 300, "grid"),
              ("all-masked", 1, 64, 7, 8, "all"),
              ("largest", 1, 6768, 67, 64, "normal")]


def counts() -> dict:
    return {"fps": cuda_fps.launches, "fps_flat": cuda_fps.flat_launches,
            "ball_query": cuda_bq.launches, "sorted": sorted_bq.launches,
            "scatter": cuda_scatter.launches, "nms": cuda_nms.launches,
            "iou": cuda_iou.launches, "ffps": cuda_ffps.launches,
            "box_points": cuda_box_points.launches}


def reset_counts() -> None:
    cuda_fps.launches = cuda_fps.flat_launches = cuda_bq.launches = 0
    sorted_bq.launches = cuda_scatter.launches = cuda_nms.launches = 0
    cuda_iou.launches = cuda_ffps.launches = cuda_box_points.launches = 0


def launches(**given) -> dict:
    """A counts() dict with the given launches and 0 elsewhere."""
    return {k: given.pop(k, 0) for k in counts()} | given


def require_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Raise, showing the first differing entry, unless exactly equal.
    Returns the measured max absolute difference, 0 when it returns.
    Integer and bool tensors only: the comparison goes through int64,
    which would truncate floats (bits_differ compares those)."""
    if got.is_floating_point() or want.is_floating_point():
        raise TypeError(f"{name}: require_equal takes integer or bool "
                        f"tensors, not {got.dtype} and {want.dtype}")
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    diff = (got.long() - want.long()).abs()
    worst = diff.max().item() if diff.numel() else 0
    if worst != 0:
        at = tuple(torch.nonzero(diff)[0].tolist())
        raise AssertionError(
            f"{name}: kernel != plain at {at}: kernel {got[at].item()} plain "
            f"{want[at].item()} ({int((diff != 0).sum())} entries differ)")
    return worst


def cloud(gen, b, n, lo=-3.0, hi=3.0):
    return torch.empty(b, n, 3, device="cuda").uniform_(lo, hi, generator=gen)


def phase_device() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(build.describe())
    for line in build.ptxas_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    if build.ptxas_log:
        report = fps_templates(build.ptxas_log)
        for (name, points), (regs, spill) in sorted(report.items()):
            print(f"  {name}<{points}>: {regs} registers, {spill} spill bytes")
        spilled = {k: s for k, (_, s) in report.items()
                   if s and k[1] in cuda_fps.REGISTER_TIERS}
        want = {("fps_cluster_kernel", p)
                for p in (0, *cuda_fps.REGISTER_TIERS)}
        want.add(("fps_cluster_kernel_pruned", cuda_fps.PRUNED_POINTS))
        if set(report) != want or spilled:
            raise AssertionError(f"FPS templates {sorted(report)}, spill "
                                 f"bytes {spilled}")
    return card


def fps_templates(log: str) -> dict:
    """{(kernel, points a thread): (registers, spill store + load bytes)}
    of each instance of the FPS kernel templates (fps_cluster_kernel and
    B2's fps_cluster_kernel_pruned) in nvcc's -Xptxas=-v log."""
    report, key = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            found = re.search(r"(fps_cluster_kernel(?:_pruned)?)ILi(\d+)E",
                              line)
            key = (found[1], int(found[2])) if found else None
            if key is not None:
                report[key] = [0, 0]
        elif key is not None:
            if found := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", line):
                report[key][1] = int(found[1]) + int(found[2])
            elif found := re.search(r"Used (\d+) registers", line):
                report[key][0] = int(found[1])
    return {k: tuple(v) for k, v in report.items()}


@contextlib.contextmanager
def recording():
    """Record the inputs of every FPS, ball-query, scatter and NMS-walk
    launch and every three_nn call in the block, {kind: [(args, kwargs)]}
    with the tensors cloned; each call goes on to the kernel (or
    three_nn)."""
    calls = {"fps": [], "ball_query": [], "scatter": [], "three_nn": [],
             "nms": []}
    layouts = []  # whether each scatter's g came contiguous
    targets = [(cuda_fps, "furthest_point_sample", "fps"),
               (cuda_bq, "ball_query", "ball_query"),
               (cuda_scatter, "scatter_rows", "scatter"),
               (ops, "three_nn", "three_nn"),
               (cuda_nms, "greedy_suppress", "nms")]
    originals = [getattr(mod, attr) for mod, attr, _ in targets]

    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    for (mod, attr, kind), fn in zip(targets, originals):
        def record(*args, _fn=fn, _kind=kind, **kw):
            if _kind == "scatter":
                layouts.append(args[0].is_contiguous())
            calls[_kind].append(([clone(a) for a in args],
                                 {k: clone(v) for k, v in kw.items()}))
            return _fn(*args, **kw)
        setattr(mod, attr, record)
    try:
        yield calls
    finally:
        if layouts:
            print(f"  scatter g contiguous at {sum(layouts)} of "
                  f"{len(layouts)} calls (the kernel reads strided rows "
                  "without a copy)")
        for (mod, attr, _), fn in zip(targets, originals):
            setattr(mod, attr, fn)


def capture_train_step(gen) -> dict:
    """The kernel inputs of one config-#3 training step, recorded call by
    call: forward, loss and backward of the config-#3 detector (weights
    from train.seed) on one synthetic batch of 8 x 40960 points."""
    print("== recording the kernel inputs of one config-#3 training step")
    cfg = train_config(tempfile.mkdtemp(prefix="tpu3dsad_torch_ckpt_"))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, get_dataset(cfg).mean_sizes)
    batch = synthetic_detection_batch(gen, TRAIN_B, TRAIN_N, 18,
                                      vote_candidates=3)
    with recording() as calls:
        grads_of(model, cfg, model.state_dict(), batch,
                 train_lib.bn_momentum_at(cfg.train, 0))
    torch.backends.cuda.matmul.allow_tf32 = tf32  # serving runs as before
    found = {k: len(v) for k, v in calls.items()}
    print(f"  calls: {found}")
    if found != {"fps": 5, "ball_query": 7, "scatter": 9, "three_nn": 2,
                 "nms": 0}:
        raise AssertionError(f"one training step made {found} calls, not 5 "
                             "FPS, 7 ball query, 9 scatter and 2 three_nn")
    return calls


def capture_request() -> dict:
    """The kernel inputs of one served config-#5 request (the server of
    phase 4 on a request of its kind), recorded call by call, and under
    "nms_scan" the NMS walk's of one raw scan of SCAN_POINTS points served
    at B = 1, as the latency cell serves it."""
    print("== recording the kernel inputs of one config-#5 request")
    _, _, infer = build_server()
    (pts, mask), = make_requests(1, seed=REQUESTS + 1)
    with recording() as calls:
        infer(pts, mask)
    found = {k: len(v) for k, v in calls.items()}
    print(f"  calls: {found}")
    if (found["fps"], found["ball_query"], found["scatter"],
            found["nms"]) != (5, 7, 0, 1):
        raise AssertionError(f"one request made {found} calls, not 5 FPS, "
                             "7 ball query, 0 scatter and 1 NMS walk")
    raw = np.random.default_rng(1).uniform(
        -3, 3, (SCAN_POINTS, 3)).astype(np.float32)
    manifest = {"batch_size": 1, "num_points": N, "with_features": False}
    with recording() as scan:
        infer(*serving.prepare_scene_batch(raw, manifest))
    if len(scan["nms"]) != 1:
        raise AssertionError(f"one scan at B = 1 made {len(scan['nms'])} "
                             "NMS walks, not 1")
    calls["nms_scan"] = scan["nms"]
    # recorded under inference_mode: plain tensors for the phases below
    return {kind: [([a.clone() if torch.is_tensor(a) else a for a in args],
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in kw.items()}) for args, kw in found_calls]
            for kind, found_calls in calls.items()}


def eval_config(root: str, ckpt_dir: str, *extra: str) -> Config:
    """Config #4 evaluation through the CLI's own parser: preset=outdoor,
    FPS on the card, batch 8, the scenes under `root`."""
    return parse_cli([*EVAL_ARGS, f"data.root={root}",
                      f"train.ckpt_dir={ckpt_dir}", *extra])


def prepare_outdoor(work: Path) -> dict:
    """Two copies of one synthetic outdoor dataset (12 val and 2 train
    scenes of 122880 points; each side writes its own FPS caches) and a
    checkpoint of the outdoor detector with seeded random weights, saved
    by train_lib.save_checkpoint."""
    roots = {}
    for name in ("capture", "sweep"):
        roots[name] = str(work / name)
        write_dataset(roots[name], scenes=2, val_scenes=EVAL_SCENES,
                      num_points=EVAL_RAW_N, seed=0)
    ckpt = str(work / "ckpt")
    cfg = eval_config(roots["sweep"], ckpt)
    model = build_detector(cfg, kitti.KITTI_MEAN_SIZES)
    optimizer = train_lib.make_optimizer(cfg.train, 1, model.parameters())
    train_lib.save_checkpoint(ckpt, model, optimizer, 1)
    return {**roots, "ckpt": ckpt}


def capture_eval_batch(outdoor: dict) -> tuple[dict, dict]:
    """The kernel inputs of one config-#4 eval batch: loading the first
    val batch (crop, B2 FPS per scene, pad), recorded apart, then the eval
    step of the checkpointed outdoor detector on it."""
    print("== recording the kernel inputs of one config-#4 eval batch")
    cfg = eval_config(outdoor["capture"], outdoor["ckpt"])
    train_lib.apply_runtime_config(cfg)
    dataset = get_dataset(cfg)
    with recording() as loads:
        batch = next(dataset.val_batches(np.random.default_rng(0), EVAL_B))
    model = build_detector(cfg, dataset.mean_sizes)
    train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                 for_eval=True)
    step = train_lib.make_detector_eval_step(model, cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with recording() as calls:
        end_points, _ = step(batch)
        parse_predictions(end_points, model.mean_sizes,
                          cfg.model.num_heading_bins, cfg.eval)
    found = {k: len(v) for k, v in calls.items()}
    print(f"  loading: {len(loads['fps'])} FPS calls on one cloud each; "
          f"eval step and parse calls: {found}")
    if found != {"fps": 5, "ball_query": 7, "scatter": 0, "three_nn": 2,
                 "nms": 1}:
        raise AssertionError(f"one eval batch made {found} calls, not 5 FPS, "
                             "7 ball query, 0 scatter, 2 three_nn and 1 NMS "
                             "walk")
    return loads, calls


def phase_fps(gen, train_calls, eval_calls) -> None:
    print("== FPS kernel vs plain (exact picks)")
    names = [name for name, _, _ in FPS_SHAPES]
    cases = [("serve", name, cloud(gen, B, n), m, None)
             for name, n, m in FPS_SHAPES]
    cases += [(path, name, args[0], args[1], kw.get("mask"))
              for path, calls in (("train", train_calls), ("eval4", eval_calls))
              for name, (args, kw) in zip(names, calls["fps"])]
    for path, name, xyz, m, mask in cases:
        fps_case(path, name, xyz, m, mask)
    Plan = cuda_fps.Plan
    # masked tail, an all-masked cloud, exact distance ties on a grid (in
    # place, and a grid repeated along N so that ties straddle the slices of
    # the CTAs at B > 1), N not a multiple of C*T, slices wholly masked, and
    # B = 1 at N = 65536; forced plans put CTAs past N (no point at all) in
    # the register and the memory tier
    xyz = cloud(gen, 4, N)
    mask = torch.ones(4, N, dtype=torch.bool, device="cuda")
    mask[0, N // 3:] = False
    mask[1] = False
    mask[2, ::2] = False
    tied = torch.randint(-4, 5, (4, 4096, 3), device="cuda",
                         generator=gen).float()
    grid = torch.randint(-4, 5, (4, 1500, 3), device="cuda",
                         generator=gen).float().repeat(1, 20, 1).contiguous()
    holes = torch.ones(4, EVAL_N, dtype=torch.bool, device="cuda")
    holes[1, 2048:4096] = False  # slice 1 of 8 x 2048
    holes[2, EVAL_N - 2048:] = False  # the last slice
    holes[3, :2048] = False  # the first slice, index 0's
    small = cloud(gen, 2, 3000)
    cases = {"masked": (xyz, mask, 2048, None),
             "ties": (tied, None, 512, None),
             "ties across slices": (grid, None, 1024, None),
             "N=20001": (cloud(gen, 3, 20001), None, 2048, None),
             "masked slices": (cloud(gen, 4, EVAL_N), holes, 2048, None),
             "empty CTA": (small, None, 512, [Plan(4, 1024, 1)]),
             "empty CTAs": (small, None, 512, [Plan(8, 256, 2)]),
             "memory tier": (small, None, 512, [Plan(16, 32, 0)]),
             "memory tier, empty CTAs": (small[:, :40].contiguous(), None,
                                         40, [Plan(16, 32, 0)]),
             "B=1 N=65536": (cloud(gen, 1, 65536, -30.0, 30.0), None, 2048,
                             None)}
    for label, (x, mk, m, plans) in cases.items():
        require_equal(f"fps {label}", cuda_fps.fps_batched(x, m, mk, plans),
                      plain_fps(x, m, mask=mk))
        print(f"  {label} [{x.shape[0]},{x.shape[1]}]->{m}: equal")


def fps_case(path, name, xyz, m, mask, compares=1) -> None:
    """One recorded B1 call: `compares` launches, each exactly the plain
    version's picks."""
    b, n = xyz.shape[:2]
    want = plain_fps(xyz, m, mask=mask)
    for _ in range(compares):
        got = cuda_fps.furthest_point_sample(xyz, m, mask=mask)
        require_equal(f"fps {path} {name}", got, want)
    print(f"  {path} {name:9s} [{b},{n}]->{m}: equal in {compares} launches")


# the scan's template instances (centers a warp x loads), each at 4 warps
# a block, and a block of 3 warps: the edge cases run at every one
EDGE_PLANS = [cuda_bq.Plan(4, c, shared) for c in cuda_bq.CENTERS
              for shared in (False, True)] + [cuda_bq.Plan(3, 2, True)]
COMPARES = 3  # launches of each ball-query case compared with the plain


def check_bq(label, xyz, centers, r, k, mask, want, **kw):
    """COMPARES launches of the B3 kernel, each exactly equal to `want`
    (idx, cnt); returns the last."""
    for _ in range(COMPARES):
        got = cuda_bq.ball_query(xyz, centers, r, k, mask, **kw)
        require_equal(f"{label} idx", got[0], want[0])
        require_equal(f"{label} cnt", got[1], want[1])
    return got


def bq_edge_cases(gen) -> dict:
    """label -> (xyz, centers, mask, r, K): the edge cases of the scan."""
    xyz = cloud(gen, 4, 4096, -0.5, 0.5)
    mask = torch.rand(4, 4096, device="cuda", generator=gen) < 0.7
    mask[3] = False
    centers = torch.cat([xyz[:, :200], cloud(gen, 4, 56, 5.0, 6.0)], 1)
    ties = torch.randint(-4, 5, (4, 4096, 3), device="cuda",
                         generator=gen).float()
    # r = 0.5: d2 == r2 = 0.25 at (0.5, 0, 0); one ulp inside at (0, -in, 0)
    inside = float(np.nextafter(np.float32(0.5), np.float32(0)))
    edge = cloud(gen, 2, 4096, 2.0, 3.0)
    edge[:, 0:3000:3] = torch.tensor([0.5, 0.0, 0.0], device="cuda")
    edge[:, 1:3000:3] = torch.tensor([0.0, -inside, 0.0], device="cuda")
    # z-sorted: tiles banded in z; centers at each tile's top +- r
    banded = cloud(gen, 2, 4096)
    banded[..., 2] = banded[..., 2].sort(1).values
    tops = banded[:, cuda_bq.TILE - 1::cuda_bq.TILE, 2]
    steps = torch.tensor([-1.0005, -0.9995, 0.0, 0.9995, 1.0005],
                         device="cuda")
    faces = torch.zeros(2, 640, 3, device="cuda")
    faces[..., 2] = (tops.repeat(1, 5) + 0.1 * steps.repeat_interleave(128))
    holes = torch.rand(4, 4096, device="cuda", generator=gen) < 0.8
    holes[0, 64:1024] = False  # whole tiles masked
    holes[1, ::64] = False
    holes[2] = False  # an all-masked cloud
    ordered = cloud(gen, 4, 8192)
    ordered = torch.gather(ordered, 1, ordered[..., :1].argsort(1).expand(
        4, 8192, 3)).contiguous()
    ragged = cloud(gen, 3, 4001, -0.5, 0.5)
    tail = torch.ones(3, 4001, dtype=torch.bool, device="cuda")
    tail[:, 3990:] = False
    return {
        "masked+empty": (xyz, centers, mask, 0.1, 32),
        "saturated": (xyz, centers, None, 0.3, 64),
        "K>N": (xyz[:, :40].contiguous(), centers, None, 0.4, 64),
        "ties": (ties, ties[:, :256].contiguous(), None, 1.5, 32),
        "d2 == r2, one ulp inside": (
            edge, torch.zeros(2, 64, 3, device="cuda"), None, 0.5, 64),
        "tile faces +- r": (banded, faces, None, 0.1, 32),
        "masked tiles, all-masked cloud": (xyz, centers, holes, 0.1, 32),
        "N=4001": (ragged, ragged[:, :300].contiguous(), tail, 0.1, 32),
        "sorted cloud": (ordered, ordered[:, ::8].contiguous(), None, 0.2,
                         64),
    }


def phase_ball_query(gen, serve_calls, train_calls, eval_calls) -> None:
    print(f"== ball-query kernel (B3) vs plain (exact idx and cnt, "
          f"{COMPARES} launches each)")
    names = [name for name, *_ in BQ_SHAPES]
    cases = [(path, name, *args, kw.get("mask"))
             for path, calls in (("serve", serve_calls), ("train", train_calls),
                                 ("eval4", eval_calls))
             for name, (args, kw) in zip(names, calls["ball_query"])]
    for path, name, xyz, centers, r, k, mask in cases:
        bq_case(path, name, xyz, centers, r, k, mask)
    for name, n, m, r, k in BQ_SHAPES:  # uniform clouds, centers unordered
        xyz = cloud(gen, B, n)
        centers = xyz[:, :m].contiguous()
        check_bq(f"ball_query uniform {name}", xyz, centers, r, k, None,
                 plain_bq(xyz, centers, r, k))
    print(f"  the {len(BQ_SHAPES)} request shapes on uniform clouds: equal")
    for label, (x, c, mk, r, k) in bq_edge_cases(gen).items():
        want = plain_bq(x, c, r, k, mask=mk)
        for launch in EDGE_PLANS:
            check_bq(f"ball_query {label} ({launch})", x, c, r, k, mk, want,
                     launch=launch)
        print(f"  {label}: equal at {len(EDGE_PLANS)} launch shapes (cnt min "
              f"{want[1].min().item()} max {want[1].max().item()})")


def bq_case(path, name, xyz, centers, r, k, mask) -> None:
    """One recorded B3 call: COMPARES launches exactly equal to the plain
    version (idx and cnt)."""
    n, m = xyz.shape[1], centers.shape[1]
    _, gc = check_bq(f"ball_query {path} {name}", xyz, centers, r, k, mask,
                     plain_bq(xyz, centers, r, k, mask=mask))
    print(f"  {path} {name:9s} N={n} M={m} r={r:g} K={k}: equal in "
          f"{COMPARES} launches; mean cnt {gc.float().mean():.2f}")


def build_server():
    """(cfg, model, infer): the config #5 detector with seeded random
    weights on the card, behind serving.build_inference_fn."""
    cfg = Config(model=ModelConfig(num_classes=10))
    model = SizeAdaptiveDetector(cfg.model,
                                 generator=torch.Generator().manual_seed(0))
    return cfg, model, build_inference_fn(cfg, model, model.mean_sizes)


def make_requests(count: int, seed: int = 0) -> list:
    """`count` (points [B,N,3], mask [B,N]) batches on the card, uniform in
    a 6 m cube; scene 1 of each is a quarter padding."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(count):
        pts = rng.uniform(-3, 3, (B, N, 3)).astype(np.float32)
        mask = np.ones((B, N), bool)
        mask[1, N * 3 // 4:] = False  # a partly padded scene
        batches.append((torch.from_numpy(pts).cuda(),
                        torch.from_numpy(mask).cuda()))
    torch.cuda.synchronize()
    return batches


def phase_serve() -> None:
    print(f"== serving 1 warm-up + {REQUESTS} requests of {B} scenes x "
          f"{N} points")
    cfg, _, infer = build_server()
    warmup, *batches = make_requests(REQUESTS + 1, seed=0)
    infer(*warmup)
    reset_counts()
    outs = [infer(pts, mask) for pts, mask in batches]
    served = counts()
    print(f"  launches: {served}")
    if served != launches(fps=5 * REQUESTS, ball_query=7 * REQUESTS,
                          nms=REQUESTS):
        raise AssertionError(f"launch counts {served} != 5, 7, 1 (NMS) and "
                             "0 (scatter) per request")

    P = cfg.model.num_proposals
    shapes = {"center": (B, P, 3), "size": (B, P, 3), "heading": (B, P),
              "sem_cls": (B, P), "obj_prob": (B, P), "keep": (B, P)}
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape:
                raise AssertionError(f"{key}: {tuple(out[key].shape)}")
            if out[key].is_floating_point() and not out[key].isfinite().all():
                raise AssertionError(f"{key}: non-finite values")
    kept = [int(o["keep"].sum()) for o in outs]
    print(f"  outputs finite, shapes ok; boxes kept per request: {kept}")

    with ops.use_impl("plain"):
        plain = infer(*batches[0])
    if counts() != served:
        raise AssertionError("the plain rerun launched a kernel")
    require_equal("keep (kernel path vs plain path)", outs[0]["keep"],
                  plain["keep"])
    require_equal("sem_cls (kernel path vs plain path)", outs[0]["sem_cls"],
                  plain["sem_cls"])
    dc = (outs[0]["center"] - plain["center"]).abs().max().item()
    print(f"  plain-ops rerun of request 0: keep and sem_cls identical, "
          f"center max |diff| {dc:.3g}")


def phase_nms(serve_calls, eval_calls) -> None:
    """The NMS walk kernel on its recorded inputs (phase 1): COMPARES
    launches, each exactly the plain loop's keep on the same CUDA
    tensors: a request of B scenes, a scan at B = 1 and the config-#4
    parse."""
    print(f"== NMS walk kernel vs the plain loop (exact keep, {COMPARES} "
          "launches each)")
    cases = [(f"request of {B} scenes", serve_calls["nms"][0]),
             (f"scan of {SCAN_POINTS} points at B = 1",
              serve_calls["nms_scan"][0]),
             ("config-#4 parse", eval_calls["nms"][0])]
    for label, (args, kw) in cases:
        _, scores, valid, _ = args
        (b, k), kept = scores.shape, None
        want = plain_walk(*args, **kw)
        for _ in range(COMPARES):
            kept = cuda_nms.greedy_suppress(*args, **kw)
            require_equal(f"nms {label}", kept, want)
        print(f"  {label}: B = {b}, K = {k}, kept {int(kept.sum())} of "
              f"{int(valid.sum())} valid; equal in {COMPARES} launches")


def add_at(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The scatter on the host by np.add.at in float32, a sequential sum in
    index order: what the kernel must equal bit for bit."""
    B, _, C = g.shape
    g, idx = g.cpu().numpy(), idx.long().cpu().numpy()
    ok = (idx >= 0) & (idx < n)
    out = np.zeros((B * n, C), np.float32)
    np.add.at(out, (idx + np.arange(B)[:, None] * n)[ok], g[ok])
    return torch.from_numpy(out.reshape(B, n, C))


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> str | None:
    """Where two fp32 tensors differ in their bits, or None."""
    diff = a.view(torch.int32) != b.view(torch.int32)
    if not diff.any():
        return None
    at = tuple(torch.nonzero(diff)[0].tolist())
    return (f"at {at}: {a[at].item()!r} vs {b[at].item()!r} "
            f"({int(diff.sum())} entries differ)")


def longest_row(idx: torch.Tensor, n: int) -> int:
    """The most entries of one row of one cloud."""
    ok = (idx >= 0) & (idx < n)
    flat = (idx.long() + torch.arange(idx.shape[0], device=idx.device
                                      )[:, None] * n)[ok]
    return int(torch.bincount(flat, minlength=idx.shape[0] * n).max())


def check_scatter(name, g, idx, n, gen) -> int:
    """The kernel on integer-valued gradients of g's shape equal to the
    plain version (exact in any order); on g itself the same bits in 3
    launches, and bitwise np.add.at on the host. Returns the longest
    row."""
    whole = torch.randint(-64, 65, g.shape, device="cuda",
                          generator=gen).float()
    got = cuda_scatter.scatter_rows(whole, idx, n)
    if (at := bits_differ(got, plain_scatter(whole, idx, n))) is not None:
        raise AssertionError(f"scatter {name}: kernel != plain on integer g "
                             f"{at}")
    outs = [cuda_scatter.scatter_rows(g, idx, n) for _ in range(3)]
    for again in outs[1:]:
        if (at := bits_differ(again, outs[0])) is not None:
            raise AssertionError(f"scatter {name}: launches differ {at}")
    if (at := bits_differ(outs[0].cpu(), add_at(g, idx, n))) is not None:
        raise AssertionError(f"scatter {name}: kernel != np.add.at {at}")
    return longest_row(idx, n)


def scatter_case(path, g, idx, n, gen) -> None:
    """One recorded B5 call (check_scatter)."""
    _, U, C = g.shape
    name = f"{path} n={n} U={U} C={C}"
    longest = check_scatter(name, g, idx, n, gen)
    print(f"  {name:28s}: bitwise np.add.at, the same bits in 3 launches, "
          f"equal to plain on integer g; longest row {longest}")


def phase_scatter(gen, train_calls) -> None:
    print("== scatter kernel at the training step's launches: bitwise "
          "np.add.at and the same bits in 3 launches (integer g: equal to "
          "plain)")
    for args, _ in train_calls["scatter"]:
        scatter_case("train", *args, gen)
    # heavy collisions, masked centers' zeros, out-of-range indices, odd
    # widths
    zeros = torch.randint(0, 1024, (TRAIN_B, 8192), device="cuda",
                          generator=gen)
    zeros[:, 2048:6144] = 0
    cases = {"collisions": (torch.randint(0, 8, (TRAIN_B, 32768),
                                          device="cuda", generator=gen),
                            2048, 131),
             "row 0": (zeros, 1024, 259),
             "-1 and >= n": (torch.randint(-1, 70, (3, 5000), device="cuda",
                                           generator=gen), 64, 3),
             "C=47": (torch.randint(0, 300, (2, 4096), device="cuda",
                                    generator=gen), 300, 47)}
    for label, (idx, n, C) in cases.items():
        g = 8.0 * torch.randn(*idx.shape, C, device="cuda", generator=gen)
        longest = check_scatter(label, g, idx, n, gen)
        print(f"  {label}: equal on integer g; the same bits in 3 launches; "
              f"bitwise np.add.at; longest row {longest}")


def train_config(ckpt_dir: str) -> Config:
    """Config #3: the default ModelConfig (18 classes), 8 x 40960 points
    of synthetic scenes made on the card, one epoch of 8 steps, no
    evaluation."""
    return Config(
        model=ModelConfig(),
        data=DataConfig(name="synthetic", device_synth=True,
                        num_points=TRAIN_N),
        train=TrainConfig(batch_size=TRAIN_B, num_epochs=1, eval_every=2,
                          log_every=4, ckpt_dir=ckpt_dir))


def grads_of(model, cfg, state, batch, bn_m):
    """(loss, {name: grad}) of one forward + backward in train mode from
    `state`, restored first (the forward moves the BN running stats)."""
    model.load_state_dict(state)
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = train_lib.detector_loss(model, cfg, batch, bn_m)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def check_precision(nn_calls) -> None:
    """The training step's three_nn calls pick the same neighbours under
    the training precision (TF32 matmuls allowed) as in full fp32; a GEMM
    shows the flag is live."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    x = torch.randn(TRAIN_B * 1024, 256, device="cuda")
    w = torch.randn(256, 256, device="cuda")
    picks, prods = [], []
    for allow in (tf32, False):
        torch.backends.cuda.matmul.allow_tf32 = allow
        picks.append([ops.three_nn(*args, **kw)[1]
                      for args, kw in nn_calls])
        prods.append(x @ w)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in zip(*picks):
        require_equal("three_nn under the training precision vs fp32", got,
                      want)
    print(f"  three_nn picks equal with allow_tf32={tf32} and in fp32; a "
          f"[{TRAIN_B * 1024},256]x[256,256] GEMM differs by max "
          f"{(prods[0] - prods[1]).abs().max().item():.3g}")


def phase_train(gen, nn_calls) -> None:
    print(f"== training: run_detector, config #3, {TRAIN_B} x {TRAIN_N} "
          f"points, {TRAIN_STEPS} steps")
    ckpt = tempfile.mkdtemp(prefix="tpu3dsad_torch_ckpt_")
    cfg = train_config(ckpt)
    reset_counts()
    result = run_detector(cfg)
    trained = counts()
    print(f"  launches: {trained}")
    if trained != launches(fps=5 * TRAIN_STEPS, ball_query=7 * TRAIN_STEPS,
                           scatter=9 * TRAIN_STEPS):
        raise AssertionError(f"launch counts {trained} != 5, 7 and 9 per "
                             "step")
    losses = [h["loss"] for h in result.history]
    if result.step != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"steps {result.step}, losses {losses}")
    print(f"  losses {[round(x, 6) for x in losses]}")

    model = result.model
    fresh = build_detector(cfg, model.mean_sizes).state_dict()
    state = copy.deepcopy(model.state_dict())
    for kind in ("weight", "running_mean", "running_var"):
        if all(torch.equal(state[k], fresh[k]) for k in state
               if k.endswith(kind)):
            raise AssertionError(f"no {kind} moved in training")
    if not (Path(ckpt) / f"ckpt_{TRAIN_STEPS}.pt").exists():
        raise AssertionError(f"no checkpoint at step {TRAIN_STEPS}")
    again = run_detector(cfg)
    if (again.start_step, again.step) != (TRAIN_STEPS, TRAIN_STEPS) or any(
            not torch.equal(v, state[k])
            for k, v in again.model.state_dict().items()):
        raise AssertionError("the second call did not resume the checkpoint")
    print(f"  parameters and BN statistics moved; a second call resumed at "
          f"step {again.start_step} with the saved state")

    check_precision(nn_calls)

    batch = synthetic_detection_batch(gen, TRAIN_B, TRAIN_N, 18,
                                      vote_candidates=3)
    kernel_vs_plain("one step", model, cfg, state, batch)


def kernel_vs_plain(label: str, model, cfg, state, batch,
                    want: dict | None = None) -> None:
    """One train step's forward + backward from `state` on `batch`, on the
    kernel path and on the plain path, in fp32: every kernel on the path
    gives its plain version's bits (the scatter sums each row in index
    order, as index_put_ does on the card), so the loss and every gradient
    must be exactly equal; `want` launches (5 / 7 / 9) on the kernel path
    only."""
    want = want or launches(fps=5, ball_query=7, scatter=9)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    lk, gk = grads_of(model, cfg, state, batch, bn_m)
    one_step = counts()
    with ops.use_impl("plain"):
        lp, gp = grads_of(model, cfg, state, batch, bn_m)
    if counts() != one_step or one_step != want:
        raise AssertionError(f"{label}: launches {one_step} then {counts()}")
    if not torch.equal(lk, lp):
        raise AssertionError(f"{label} loss: kernel path {lk.item()!r} vs "
                             f"plain path {lp.item()!r}")
    for name, want in gp.items():
        if (at := bits_differ(gk[name], want)) is not None:
            raise AssertionError(f"{label} grad {name}: kernel path != "
                                 f"plain path {at}")
    print(f"  {label}, kernel path vs plain path: loss {lk.item():.6f} "
          f"equal; {len(gp)} gradients bitwise equal")


def phase_fps_flat(gen, scene_call) -> None:
    print("== large-cloud FPS kernel (B2, cluster) vs plain (exact picks)")
    (xyz, m), kw = scene_call
    n = 100000
    tail = torch.ones(1, n, dtype=torch.bool, device="cuda")
    tail[0, 90000:] = False
    tail[0, ::7] = False
    grid = torch.randint(-6, 7, (1, 8192, 3), device="cuda",
                         generator=gen).float()
    cases = [
        ("eval4 scene", xyz, m, kw.get("mask")),
        ("N=65537", cloud(gen, 1, 65537, -30.0, 30.0), 2048, None),
        ("N=786432", cloud(gen, 1, 786432, -30.0, 30.0), 64, None),
        ("masked tail", cloud(gen, 1, n, -30.0, 30.0), 1024, tail),
        ("all masked", cloud(gen, 1, 70000), 16,
         torch.zeros(1, 70000, dtype=torch.bool, device="cuda")),
        ("duplicates", grid.repeat(1, 10, 1).contiguous(), 1024, None),
    ]
    for label, x, m, mask in cases:
        want = plain_fps(x, m, mask=mask)
        # the scene three times: a missed fence shows as a rare wrong pick
        for _ in range(3 if label.startswith("eval4") else 1):
            got = cuda_fps.fps_flat(x, m, mask)
            require_equal(f"fps_flat {label}", got, want)
        require_equal(f"fps B1 at B=1 {label}",
                      cuda_fps.fps_batched(x, m, mask), want)
        print(f"  {label:12s} [1,{x.shape[1]}]->{m}: equal, and the B1 "
              "entry's")


def in_ball_check(label, xyz, centers, r, k, mask, idx, cnt, exact_idx,
                  exact_cnt) -> None:
    """The sorted tier against the exact one: equal counts; where a ball
    holds fewer than K points the same set; where it is full, K distinct
    valid points strictly inside."""
    require_equal(f"{label} cnt vs exact", cnt, exact_cnt)
    K = idx.shape[-1]
    slot = torch.arange(K, device=idx.device)
    live = slot < cnt[..., None]
    n = xyz.shape[1]
    few = cnt < K
    a = torch.where(live, idx, n).sort(-1).values
    b = torch.where(live, exact_idx, n).sort(-1).values
    if not torch.equal(a[few], b[few]):
        raise AssertionError(f"{label}: the sorted tier chose another set "
                             "than the exact tier in a ball of < K points")
    full = a[~few]
    if (full[:, 1:] == full[:, :-1]).any():
        raise AssertionError(f"{label}: a full ball repeats a point")
    B, M, _ = idx.shape
    pts = torch.gather(xyz, 1, idx.reshape(B, M * K, 1).long().expand(
        B, M * K, 3)).reshape(B, M, K, 3)
    d = pts - centers[:, :, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    ok = d2 < radius_sq(r)
    if mask is not None:
        ok &= torch.gather(mask.bool(), 1, idx.reshape(B, M * K).long()
                           ).reshape(B, M, K)
    if not ok[live].all():
        raise AssertionError(f"{label}: a chosen point is not in its ball")


def phase_sorted(gen, eval_calls, serve_sa1, train_sa1) -> None:
    print(f"== sorted ball query (B4: Morton-code kernel, torch sorts, B3 "
          f"with the map-back in its epilogue) vs glue + plain (exact idx and"
          f" cnt, {COMPARES} calls each)")
    junk = cloud(gen, 4, 8192)
    junk_mask = torch.rand(4, 8192, device="cuda", generator=gen) < 0.7
    junk[~junk_mask] = cloud(gen, 1, int((~junk_mask).sum()), -50.0, 50.0)[0]
    junk_mask[3] = False  # an all-masked cloud
    cases = [("config #4 SA1", *eval_calls["ball_query"][0][0],
              eval_calls["ball_query"][0][1].get("mask")),
             ("config #5 SA1", *serve_sa1[0], serve_sa1[1].get("mask")),
             ("config #3 SA1", *train_sa1[0], train_sa1[1].get("mask")),
             ("masked junk, an all-masked cloud", junk,
              junk[:, :1024].contiguous(), 0.3, 32, junk_mask)]
    for label, xyz, centers, r, k, mask in cases:
        n = xyz.shape[1]
        if not sorted_bq.applies(n, k):
            raise AssertionError(f"{label}: N={n} K={k} is below the gate")
        for got, want in zip(cuda_bq.morton_codes(xyz, centers, mask),
                             sorted_bq.z_keys(xyz, centers, mask)):
            require_equal(f"sorted {label} Morton codes", got, want)
        with ops.use_impl("plain"):
            want = sorted_bq.sorted_ball_query(xyz, centers, r, k, mask=mask)
        for _ in range(COMPARES):
            gi, gc = sorted_bq.sorted_ball_query(xyz, centers, r, k, mask=mask)
            require_equal(f"sorted {label} idx", gi, want[0])
            require_equal(f"sorted {label} cnt", gc, want[1])
        ei, ec = cuda_bq.ball_query(xyz, centers, r, k, mask=mask)
        in_ball_check(f"sorted {label}", xyz, centers, r, k, mask, gi, gc,
                      ei, ec)
        print(f"  {label} [{xyz.shape[0]},{n}] M={centers.shape[1]} r={r:g} "
              f"K={k}: equal; mean cnt {gc.float().mean():.2f}")


@contextlib.contextmanager
def sweep_calls():
    """Within the block, count the calls of kitti.device_fps (B2 in the
    loader) under "device_fps", and keep under "scenes" each batch's
    scene_mask count of the eval steps that
    train_lib.make_detector_eval_step builds (run_eval's and the val
    sweep's)."""
    seen = {"device_fps": 0, "scenes": []}
    device_fps, make_step = kitti.device_fps, train_lib.make_detector_eval_step

    def counted_fps(*a, **kw):
        seen["device_fps"] += 1
        return device_fps(*a, **kw)

    def counted_step(model, cfg, mesh=None):
        step = make_step(model, cfg, mesh)

        def run(batch):
            seen["scenes"].append(int(batch["scene_mask"].sum()))
            return step(batch)
        return run

    kitti.device_fps = counted_fps
    train_lib.make_detector_eval_step = counted_step
    try:
        yield seen
    finally:
        kitti.device_fps = device_fps
        train_lib.make_detector_eval_step = make_step


def plain_keep(cfg, label: str) -> None:
    """One val batch through the eval step and parse on the kernel path,
    then with the plain ops on the same CUDA tensors: the same keep."""
    dataset = get_dataset(cfg)
    batch = next(dataset.val_batches(np.random.default_rng(0), EVAL_B))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = build_detector(cfg, dataset.mean_sizes)
    train_lib.restore_checkpoint(cfg.train.ckpt_dir, model, None,
                                 for_eval=True)
    step = train_lib.make_detector_eval_step(model, cfg)
    keeps = []
    for impl in ("auto", "plain"):
        before = counts()
        with ops.use_impl(impl):
            ep, _ = step(batch)
            keeps.append(parse_predictions(
                ep, model.mean_sizes, cfg.model.num_heading_bins,
                cfg.eval)["keep"])
        walks = counts()["nms"] - before["nms"]
        if (counts() == before) != (impl == "plain") or \
                walks != (impl != "plain"):
            raise AssertionError(f"{label}: impl {impl} launched "
                                 f"{counts()} from {before}")
    require_equal(f"keep {label} (kernel path vs plain path)", *keeps)
    print(f"  {label}: one batch on the plain ops gives the same keep "
          f"({int(keeps[0].sum())} boxes kept)")


def phase_eval(outdoor: dict) -> None:
    print(f"== config #4 evaluation: run_eval over {EVAL_SCENES} scenes x "
          f"{EVAL_RAW_N} points, batch {EVAL_B}, twice")
    val = Path(outdoor["sweep"]) / "val"
    batches = -(-EVAL_SCENES // EVAL_B)
    for sweep, extra, want in (
            ("exact", [], launches(fps=5 * batches, fps_flat=EVAL_SCENES,
                                   ball_query=7 * batches, nms=batches)),
            ("sorted", SORTED_ARGS, launches(fps=5 * batches,
                                             ball_query=7 * batches,
                                             sorted=batches, nms=batches))):
        cfg = eval_config(outdoor["sweep"], outdoor["ckpt"], *extra)
        reset_counts()
        with sweep_calls() as t:
            out = eval_detector.run_eval(cfg)
        got = counts()
        print(f"  {sweep} sweep launches: {got}")
        if got != want:
            raise AssertionError(f"{sweep} sweep: launches {got} != {want}")
        if t["scenes"] != [EVAL_B, EVAL_SCENES - EVAL_B]:
            raise AssertionError(f"{sweep} sweep: batches of scenes "
                                 f"{t['scenes']}, not [8, 4] with padding")
        for thresh in cfg.eval.ap_iou_threshs:
            for key in (f"mAP@{thresh}", f"AR@{thresh}"):
                if not 0.0 <= out[key] <= 1.0:
                    raise AssertionError(f"{sweep} sweep: {key} {out[key]}")
        if out["ckpt_step"] != 1 or not np.isfinite(out["val_loss"]):
            raise AssertionError(f"{sweep} sweep: {out}")
        caches = sorted(val.glob(f"*_fpscache_{EVAL_N}.npy"))
        if len(caches) != EVAL_SCENES:
            raise AssertionError(f"{len(caches)} FPS caches written, not "
                                 f"{EVAL_SCENES}")
        print(f"  {sweep} sweep: mAP@0.25 {out['mAP@0.25']}, val_loss "
              f"{out['val_loss']}")
    for sweep, extra in (("exact", []), ("sorted", SORTED_ARGS)):
        cfg = eval_config(outdoor["sweep"], outdoor["ckpt"], *extra)
        train_lib.apply_runtime_config(cfg)
        plain_keep(cfg, sweep)
    train_lib.apply_runtime_config(Config())


def hostfed_config(root: str, ckpt_dir: str, *extra: str) -> Config:
    """Config #3 trained from files, through the CLI's own parser: the
    default model and data (18 classes, 40960 points, 3 vote candidates),
    batch 8, one epoch, the val sweep after it."""
    return parse_cli([f"data.root={root}", f"train.ckpt_dir={ckpt_dir}",
                      f"train.batch_size={TRAIN_B}", "train.num_epochs=1",
                      "train.eval_every=1", "train.log_every=4", *extra])


def run_hostfed(label: str, cfg, want: dict):
    """One run_detector of phase 10 with its counts from 0: the launches
    must be `want`; one eval record, finite; best.json and best/ written.
    Returns its result."""
    reset_counts()
    result = run_detector(cfg)
    got = counts()
    print(f"  {label} launches: {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")
    losses = [h["loss"] for h in result.history]
    if result.step != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: steps {result.step}, losses {losses}")
    (ev,) = result.evals
    thresholds = cfg.eval.ap_iou_threshs
    if not (np.isfinite(ev["val_loss"]) and all(
            0.0 <= ev[f"{k}@{t}"] <= 1.0 for t in thresholds
            for k in ("mAP", "AR"))):
        raise AssertionError(f"{label}: eval {ev}")
    ckpt = Path(cfg.train.ckpt_dir)
    best = json.loads((ckpt / "best.json").read_text())
    if best != {"metric": ev[f"mAP@{thresholds[0]}"], "step": TRAIN_STEPS} or \
            sorted(p.name for p in (ckpt / "best").iterdir()) != [
                f"ckpt_{TRAIN_STEPS}.pt"]:
        raise AssertionError(f"{label}: best.json {best}")
    print(f"  {label}: losses {[round(h['loss'], 6) for h in result.history]}"
          f"; val sweep ({HOSTFED_VAL} scenes, one batch) mAP@0.25 "
          f"{ev['mAP@0.25']}, val_loss {ev['val_loss']}")
    return result


def phase_hostfed(work: Path) -> None:
    """Phase 10 in `work`, whose packed split phase 12 trains on again."""
    print(f"== host-fed training, config #3 from {HOSTFED_TRAIN} + "
          f"{HOSTFED_VAL} ScanNet-format scenes of {HOSTFED_RAW} points, "
          f"{TRAIN_B} x {TRAIN_N} points a batch, {TRAIN_STEPS} steps + one "
          "val sweep, twice")
    hostfed_runs(work)


def hostfed_runs(work: Path) -> None:
    root, packed = str(work / "scannet"), str(work / "packed")
    synthetic_indoor.write_dataset(root, scenes=HOSTFED_TRAIN,
                                   val_scenes=HOSTFED_VAL,
                                   num_points=HOSTFED_RAW, seed=0)
    want = launches(fps=5 * TRAIN_STEPS + 5, ball_query=7 * TRAIN_STEPS + 7,
                    scatter=9 * TRAIN_STEPS, nms=1)

    # Run A: the per-scene loader, host augmentation, colour
    cfg_a = hostfed_config(root, str(work / "ckpt_a"), "data.use_color=true")
    dataset = get_dataset(cfg_a)
    a = run_hostfed("run A", cfg_a, want)
    model = a.model

    # the best snapshot, restored into a fresh model, evaluates to the
    # logged metrics (mAP, AR, per-class AP, val_loss); then, with another
    # best planted, a second call resumes from the newest checkpoint and
    # not from best/
    logged = {k: v for k, v in a.evals[0].items()
              if k not in ("epoch", "step", "seconds")}
    fresh = build_detector(cfg_a, dataset.mean_sizes)
    step = train_lib.restore_checkpoint(cfg_a.train.ckpt_dir, fresh, None,
                                        for_eval=True, use_best=True)
    again = train_detector.evaluate(
        cfg_a, fresh, dataset, train_lib.make_detector_eval_step(fresh, cfg_a),
        lambda ep: parse_predictions(
            ep, fresh.mean_sizes, cfg_a.model.num_heading_bins, cfg_a.eval))
    if step != TRAIN_STEPS or again != logged:
        raise AssertionError(f"use_best: step {step}, metrics {again} vs "
                             f"logged {logged}")
    optimizer = train_lib.make_optimizer(cfg_a.train, 1, fresh.parameters())
    train_lib.save_best_checkpoint(cfg_a.train.ckpt_dir, fresh, optimizer,
                                   999, 2.0)
    resumed = run_detector(cfg_a)
    state = model.state_dict()
    if (resumed.start_step, resumed.step) != (TRAIN_STEPS, TRAIN_STEPS) or any(
            not torch.equal(v, state[k])
            for k, v in resumed.model.state_dict().items()):
        raise AssertionError("the second call did not resume ckpt_8.pt")
    print(f"  restore_checkpoint(use_best=True) gave step {step}, and "
          f"evaluate() the logged metrics (mAP@0.25 {again['mAP@0.25']}, "
          f"val_loss {again['val_loss']}); with a best planted at step 999 "
          f"a second call resumed at step {resumed.start_step} with the "
          "trained state")

    batch = {k: torch.from_numpy(v).cuda() for k, v in
             dataset.train_batch(np.random.default_rng(3), TRAIN_B).items()}
    kernel_vs_plain("one run-A batch (colour)", model, cfg_a, state, batch)
    del model, fresh, resumed, state, batch, a

    # Run B: the same root packed, augmentation on the card, compact votes
    src = hostfed_config(root, str(work / "unused"), "data.use_color=true",
                         "data.augment=false", "data.compact_votes=true")
    packed_counts = pack_dataset(get_dataset(src), packed)
    cfg_b = hostfed_config(packed, str(work / "ckpt_b"), "data.name=packed",
                           "data.use_color=true", "data.device_augment=true",
                           "data.compact_votes=true")
    print(f"  run B: packed {packed_counts}")
    run_hostfed("run B", cfg_b, want)
    train_lib.apply_runtime_config(Config())


def outdoor_config(root: str, ckpt_dir: str, *extra: str) -> Config:
    """Config #4 trained from files, through the CLI's own parser:
    preset=outdoor, B2 in the loader, host augmentation, batch 8, 4 epochs
    of 2 steps, the val sweep after the last."""
    return parse_cli([*OUT_ARGS, f"data.root={root}",
                      f"train.ckpt_dir={ckpt_dir}", *extra])


def fps_caches(root: str) -> list:
    return sorted(Path(root).rglob(f"*_fpscache_{EVAL_N}.npy"))


def run_outdoor(label: str, cfg) -> tuple[object, dict]:
    """One run_detector of phase 11 with its counts from 0: B2 once per
    scene whose FPS cache it wrote, 5 / 7 / 9 launches a step (STEP4),
    5 and 7 (or 5 with the lineage head) a sweep batch; finite losses, one
    sweep of finite metrics. Returns (its result, its counts)."""
    root = cfg.data.root
    before = len(fps_caches(root))
    reset_counts()
    with sweep_calls() as t:
        result = run_detector(cfg)
    got = counts()
    written = len(fps_caches(root)) - before
    step = launches(**STEP4[cfg.model.proposal_sampling])
    want = {k: step[k] * OUT_STEPS for k in step}
    want["fps"] += step["fps"]  # the sweep's one batch
    want["ball_query"] += step["ball_query"]
    want["nms"] += 1
    want["iou"] += cfg.eval.use_oriented_nms  # the sweep's one parse
    want["fps_flat"] = written
    print(f"  {label} launches: {got}; FPS caches written {written}")
    if got != want or t["device_fps"] != written:
        raise AssertionError(f"{label}: launches {got} != {want} (B2 once per "
                             f"scene it cached; {t['device_fps']} device_fps)")
    losses = [h["loss"] for h in result.history]
    if result.step != OUT_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{label}: steps {result.step}, losses {losses}")
    (ev,) = result.evals
    if t["scenes"] != [OUT_VAL] or not (np.isfinite(ev["val_loss"]) and all(
            0.0 <= ev[f"{k}@{th}"] <= 1.0 for th in cfg.eval.ap_iou_threshs
            for k in ("mAP", "AR"))):
        raise AssertionError(f"{label}: sweep of {t['scenes']} scenes, {ev}")
    print(f"  {label}: losses {[round(x, 6) for x in losses]}; val sweep "
          f"({OUT_VAL} scenes, one batch) mAP@0.25 {ev['mAP@0.25']}, "
          f"val_loss {ev['val_loss']}")
    return result, got


def capture_outdoor_step(kind: str, cfg, batch) -> tuple[dict, object, dict]:
    """The kernel inputs of one config-#4 train step (forward, loss and
    backward of the outdoor detector, weights from train.seed) on `batch`,
    recorded call by call: (calls, model, its initial state)."""
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, kitti.KITTI_MEAN_SIZES)
    state = copy.deepcopy(model.state_dict())
    with recording() as calls:
        grads_of(model, cfg, state, batch,
                 train_lib.bn_momentum_at(cfg.train, 0))
    found = {k: len(v) for k, v in calls.items()}
    want = {**STEP4[kind], "three_nn": 2, "nms": 0}
    print(f"  {kind} step calls: {found}")
    if found != want:
        raise AssertionError(f"one outdoor {kind} step made {found} calls, "
                             f"not {want}")
    return calls, model, state


def check_step_calls(kind: str, cfg, calls) -> None:
    """Every recorded B1 / B3 / B5 call of a step against its plain
    version (B1 and B3 in 3 launches each, exactly; B5 bitwise
    np.add.at)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    path = f"train4 {kind}"
    fps_names = ["sa1", "sa2", "sa3", "sa4", "proposal"]
    bq_names = ["sa1", "sa2", "sa3", "sa4"] + (
        ["proposal"] if kind == "lineage"
        else [f"bank_{r:g}" for r in cfg.model.cluster_radius_bank])
    for name, (args, kw) in zip(fps_names, calls["fps"]):
        fps_case(path, name, args[0], args[1], kw.get("mask"), compares=3)
    for name, (args, kw) in zip(bq_names, calls["ball_query"]):
        bq_case(path, name, *args, kw.get("mask"))
    for args, _ in calls["scatter"]:
        scatter_case(path, *args, gen)


def loader_b2(root: str) -> None:
    """B2 on the cropped cloud of train scene 0, as the loader pads it:
    exactly the plain version's picks in 3 launches."""
    pc = np.load(sorted(Path(root, "train").glob("*_pc.npy"))[0])
    pc = pc[kitti.range_crop(pc)]
    n = pc.shape[0]
    budget = -(-n // 4096) * 4096  # kitti.device_fps's bucket
    xyz = torch.zeros(1, budget, 3, device="cuda")
    xyz[0, :n] = torch.from_numpy(np.ascontiguousarray(pc[:, :3])).cuda()
    mask = torch.zeros(1, budget, dtype=torch.bool, device="cuda")
    mask[0, :n] = True
    want = plain_fps(xyz, EVAL_N, mask=mask)
    for _ in range(3):
        require_equal("fps_flat train4 scene", cuda_fps.fps_flat(
            xyz, EVAL_N, mask), want)
    print(f"  B2 on train scene 0 ([1,{budget}], {n} cropped points) -> "
          f"{EVAL_N}: equal in 3 launches")


def oriented_iou_check(cfg, model) -> None:
    """oriented_bev_iou on the card (one launch of the kernel,
    csrc/iou.cu), on the decoded corners of one sweep batch (scene 0, 64
    proposals: 4096 pairs), within 1e-4 of the host evaluator's
    box3d_iou_oriented given the corners in float64. Given them in
    float32, as AP does, the evaluator's sequential clip loses boxes at
    the decoder's 1e-4 m size floor 50 m out (a box against itself scores
    0); the pairs where that moves it by 1e-4 or more are counted. The
    batch's parse (oriented NMS: one IoU launch) records the kernel's
    inputs for iou_case."""
    dataset = get_dataset(cfg)
    batch = next(dataset.val_batches(np.random.default_rng(0), TRAIN_B))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    ep, _ = train_lib.make_detector_eval_step(model, cfg)(batch)
    seen, kernel = [], cuda_iou.oriented_bev_iou

    def record(*args):
        seen.append([a.clone() for a in args])
        return kernel(*args)

    cuda_iou.oriented_bev_iou = record
    try:
        parsed = parse_predictions(
            ep, model.mean_sizes, cfg.model.num_heading_bins, cfg.eval)
    finally:
        cuda_iou.oriented_bev_iou = kernel
    if len(seen) != 1:
        raise AssertionError(f"the oriented parse made {len(seen)} IoU "
                             "launches, not 1")
    corners = parsed["corners"][0, :64]
    before = cuda_iou.launches
    got = oriented_bev_iou(corners[None], corners[None])[0].cpu().numpy()
    if cuda_iou.launches != before + 1:
        raise AssertionError("oriented_bev_iou on the card did not launch "
                             "the kernel once")
    c32 = corners.cpu().numpy()
    c64 = c32.astype(np.float64)
    size = parsed["size"][0, :64].cpu().numpy()
    worst, at, fp32_off = 0.0, (0, 0), 0
    for i in range(64):
        for j in range(64):
            d = abs(got[i, j] - box3d_iou_oriented(c64[i], c64[j]))
            if d >= worst:
                worst, at = d, (i, j)
            fp32_off += abs(box3d_iou_oriented(c32[i], c32[j])
                            - box3d_iou_oriented(c64[i], c64[j])) >= 1e-4
    i, j = at
    if not worst < 1e-4:
        raise AssertionError(
            f"oriented_bev_iou vs the host evaluator: max |diff| {worst} at "
            f"({i}, {j}): card {got[i, j]}, sizes {size[i].tolist()} / "
            f"{size[j].tolist()}")
    print(f"  oriented_bev_iou on the card vs eval/ap.py box3d_iou_oriented "
          f"(float64 corners) on 4096 pairs of decoded corners: max |diff| "
          f"{worst:.3g} ({int((got > 0).sum())} pairs overlap; "
          f"{int((size.min(-1) <= 1e-4).sum())} of 64 boxes at the 1e-4 m "
          f"size floor; the evaluator on float32 corners off by >= 1e-4 at "
          f"{fp32_off} pairs)")
    iou_case(*(a.clone() for a in seen[0]))


def footprint_pairs(a: torch.Tensor, b: torch.Tensor):
    """([B, K, L] footprints' bounds strictly apart (NaN bounds: not),
    [B, K, L] both footprints at least 0.1 m across) of corners a
    [B, K, 8, 3] and b [B, L, 8, 3]."""
    def bounds(c):
        top = c[..., :4, :2]
        lo, hi = top.amin(-2), top.amax(-2)  # [B, K, 2]
        finite = torch.isfinite(top).flatten(-2).all(-1)[..., None]
        side = (top[..., 1:3, :] - top[..., :2, :]).norm(dim=-1).amin(-1)
        return (torch.where(finite, lo, torch.nan),
                torch.where(finite, hi, torch.nan), side)

    lo_a, hi_a, side_a = bounds(a)
    lo_b, hi_b, side_b = bounds(b)
    apart = ((hi_a[:, :, None] < lo_b[:, None]) |
             (hi_b[:, None] < lo_a[:, :, None])).any(-1)
    wide = (side_a >= 0.1)[:, :, None] & (side_b >= 0.1)[:, None]
    return apart, wide


def iou_case(a: torch.Tensor, b: torch.Tensor) -> None:
    """The oriented IoU kernel on the inputs one oriented parse gave it
    (phase 11's sweep batch, class-shifted as nms_oriented shifts them and
    moved into each row box's frame: the eval-kitti-b8 cell's shape, 8 x
    256 one-row clouds of L = 256 boxes): COMPARES launches,
    each exactly 0 where the footprints lie apart and within 1e-6 of the
    plain chain on the pairs whose footprints are both at least 0.1 m
    across (the slivers listed)."""
    print(f"== oriented IoU kernel vs the plain chain ({COMPARES} launches)")
    (B, K), L = a.shape[:2], b.shape[1]
    want = plain_iou(a, b)
    apart, wide = footprint_pairs(a, b)
    for _ in range(COMPARES):
        got = cuda_iou.oriented_bev_iou(a, b)
        if got[apart].any():
            raise AssertionError("oriented IoU: a pair whose footprints lie "
                                 "apart reads other than 0")
        gap = (got - want).abs()
        worst = gap[wide].max().item() if wide.any() else 0.0
        if not worst <= 1e-6:
            raise AssertionError(f"oriented IoU: |kernel - plain| {worst} on "
                                 "pairs at least 0.1 m across")
    thin = ~wide & ~apart
    print(f"  B = {B}, K = {K}, L = {L}: bitwise the chain at "
          f"{int((got == want).sum())} of {got.numel()}; widest gap "
          f"{worst:.3g} on {int(wide.sum())} pairs at least 0.1 m across, "
          f"{gap[thin].max().item() if thin.any() else 0.0:.3g} on "
          f"{int(thin.sum())} slivers (not held)")


def phase_outdoor_train() -> None:
    print(f"== config #4 training from {OUT_TRAIN} + {OUT_VAL} KITTI-format "
          f"scenes of {EVAL_RAW_N} points, {TRAIN_B} x {EVAL_N} points a "
          f"batch, {OUT_STEPS} steps + one val sweep, twice")
    work = Path(tempfile.mkdtemp(prefix="tpu3dsad_torch_kitti_"))
    try:
        outdoor_runs(work)
    finally:
        train_lib.apply_runtime_config(Config())
        shutil.rmtree(work, ignore_errors=True)


def outdoor_runs(work: Path) -> None:
    root = str(work / "kitti")
    write_dataset(root, scenes=OUT_TRAIN, val_scenes=OUT_VAL,
                  num_points=EVAL_RAW_N, seed=1)

    # Run A: B2 in the loader on the first pass, host augmentation,
    # expanded votes, FPS proposal sampling, 3D NMS
    cfg_a = outdoor_config(root, str(work / "ckpt_a"))
    a, _ = run_outdoor("run A", cfg_a)
    model = a.model
    fresh = build_detector(cfg_a, kitti.KITTI_MEAN_SIZES).state_dict()
    state = copy.deepcopy(model.state_dict())
    for kind in ("weight", "running_mean", "running_var"):
        if all(torch.equal(state[k], fresh[k]) for k in state
               if k.endswith(kind)):
            raise AssertionError(f"run A: no {kind} moved in training")
    del fresh

    # the caches of the scenes run A's batches did not reach; from here on
    # no load runs B2
    dataset = get_dataset(cfg_a)
    reset_counts()
    for item in dataset.train_items + dataset.val_items:
        dataset._load_scene(*item, np.random.default_rng(0), False)
    filled = counts()["fps_flat"]
    if len(fps_caches(root)) != OUT_TRAIN + OUT_VAL:
        raise AssertionError(f"{len(fps_caches(root))} FPS caches")
    print(f"  {filled} scenes not loaded by run A cached")

    reset_counts()
    resumed = run_detector(cfg_a)
    if (resumed.start_step, resumed.step) != (OUT_STEPS, OUT_STEPS) or any(
            not torch.equal(v, state[k])
            for k, v in resumed.model.state_dict().items()) or \
            counts() != launches():
        raise AssertionError(f"run A did not resume at step {OUT_STEPS} "
                             f"without launches: {counts()}")
    print(f"  a second call resumed at step {resumed.start_step} with the "
          "trained state, no launch (no B2: every scene cached)")
    del resumed

    # Run B: compact votes, density-biased proposal sampling, oriented NMS
    cfg_b = outdoor_config(root, str(work / "ckpt_b"),
                           "data.compact_votes=true",
                           "model.proposal_sampling=density",
                           "eval.use_oriented_nms=true")
    first = [get_dataset(c).train_batch(np.random.default_rng(c.train.seed),
                                        TRAIN_B) for c in (cfg_a, cfg_b)]
    decoded = decode_compact_votes(
        {k: torch.from_numpy(v).cuda() for k, v in first[1].items()},
        cfg_b.data.vote_candidates)
    for key in ("points", "vote_targets", "vote_mask"):
        got, want = decoded[key].cpu(), torch.from_numpy(first[0][key])
        if got.dtype != want.dtype or (
                not torch.equal(got, want) if got.dtype == torch.bool
                else bits_differ(got, want) is not None):
            raise AssertionError(f"run B's first batch decoded: {key} differs"
                                 " from run A's")
    print("  run B's first host batch (int8 owners), decoded on the card: "
          "points, vote_targets and vote_mask bitwise run A's")
    b, b_counts = run_outdoor("run B", cfg_b)
    if b_counts["fps_flat"]:
        raise AssertionError("run B ran B2 on cached scenes")
    oriented_iou_check(cfg_b, b.model)
    del b, a, model, state

    # the kernel inputs of one step of each head and sampling, against
    # the plain versions
    batch = {k: torch.from_numpy(v).cuda() for k, v in first[0].items()}
    for kind in ("fps", "density", "lineage"):
        cfg = outdoor_config(root, str(work / "unused"), *STEP4_ARGS[kind])
        if kind != "lineage":
            calls, model, state = capture_outdoor_step(kind, cfg, batch)
            check_step_calls(kind, cfg, calls)
            del calls
        else:
            model = build_detector(cfg, kitti.KITTI_MEAN_SIZES)
            state = copy.deepcopy(model.state_dict())
        kernel_vs_plain(f"one outdoor {kind} step", model, cfg, state, batch,
                        launches(**STEP4[kind]))
        del model, state
    loader_b2(root)


# train.steps_per_call of phase 12
K_STEPS = 4
# the kernels of one replayed config-#3 step, by the names torch.profiler
# gives them, with the counter of their wrapper: 5 FPS (B1), 7 ball
# queries of two launches (B3's staging and scan) and 9 scatters (B5, in
# the backward)
REPLAY_KERNELS = {"fps_cluster_kernel": ("fps", 5),
                  "stage_kernel": ("ball_query", 7),
                  "ball_query_kernel": ("ball_query", 7),
                  "scatter_kernel": ("scatter", 9)}


def kernel_times(trace_events: list) -> list[tuple[str, float, int]]:
    """(name, device us, launches) of each kernel in a chrome trace, most
    time first."""
    acc: dict = {}
    for e in trace_events:
        if e.get("cat") == "kernel":
            us, n = acc.get(e["name"], (0.0, 0))
            acc[e["name"]] = (us + e["dur"], n + 1)
    return sorted(((k, us, n) for k, (us, n) in acc.items()),
                  key=lambda r: -r[1])


def traced(fn) -> tuple[object, list]:
    """(fn(), the chrome-trace events of a torch.profiler run of it, the
    card synchronised at its end)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return out, json.loads(path.read_text())["traceEvents"]


def k_config(ckpt_dir: str, k: int) -> Config:
    """Phase 6's config #3 run (device synth, 8 x 40960, 8 steps) at
    train.steps_per_call=k."""
    cfg = train_config(ckpt_dir)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_call=k))


def trained_state(losses, model, optimizer) -> dict:
    """What a k-step block must reproduce of k single steps: the losses,
    the model's parameters and BN statistics, the optimizer's moments and
    count."""
    return {"loss": torch.as_tensor(losses),
            **{f"model.{k}": v for k, v in model.state_dict().items()},
            **{f"mu.{i}": m for i, m in enumerate(optimizer.mu)},
            **{f"nu.{i}": v for i, v in enumerate(optimizer.nu)},
            "count": optimizer.count}


def require_bitwise(label: str, got: dict, want: dict) -> None:
    """Raise, naming every entry whose bits differ."""
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if differ or got.keys() != want.keys():
        raise AssertionError(f"{label}: {len(differ)} of {len(want)} "
                             f"entries differ, first {differ[:8]}")


def run_counted(cfg, want: dict, steps: int = TRAIN_STEPS):
    """run_detector(cfg) with its counts from 0, which must be `want`
    (finite losses, `steps` steps)."""
    reset_counts()
    result = run_detector(cfg)
    got = counts()
    if got != want:
        raise AssertionError(f"launches {got} != {want}")
    losses = [h["loss"] for h in result.history]
    if result.step != steps or not np.isfinite(losses).all():
        raise AssertionError(f"steps {result.step}, losses {losses}")
    return result


def replayed_synth_block(work: Path) -> None:
    """A config-#3 device-synth block built apart from run_detector, so the
    replay can be traced: a warm-up block, the capture, then one replayed
    block under torch.profiler. The wrappers' counters see the capture's
    launches and none of a replay's; the profiler counts the replayed
    kernels by name."""
    cfg = k_config(str(work / "apart"), K_STEPS)
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg)
    optimizer = train_lib.make_optimizer(cfg.train, TRAIN_STEPS,
                                         model.parameters())
    data_gen = torch.Generator(device="cuda").manual_seed(7)
    step_gen = torch.Generator(device="cuda").manual_seed(8)
    block = train_lib.make_detector_train_block(
        model, optimizer, cfg, K_STEPS, generators=(data_gen,),
        synth_fn=lambda: synthetic_detection_batch(
            data_gen, TRAIN_B, TRAIN_N, 18, vote_candidates=3))
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    block(None, step_gen, bn_m)["loss"].tolist()  # the warm-up block
    reset_counts()
    block(None, step_gen, bn_m)["loss"].tolist()  # the capture, a replay
    captured = counts()
    if captured != launches(fps=5, ball_query=7, scatter=9):
        raise AssertionError(f"the capture launched {captured}, not one "
                             "step's 5 / 7 / 9")
    _, events = traced(lambda: block(None, step_gen, bn_m)["loss"].tolist())
    if counts() != captured:
        raise AssertionError(f"replays went through the wrappers: "
                             f"{counts()}")
    by_name = {name: 0 for name in REPLAY_KERNELS}
    for name, _, n in kernel_times(events):
        for key in REPLAY_KERNELS:
            if re.search(rf"\b{key}\b", name):
                by_name[key] += n
    want = {k: n * K_STEPS for k, (_, n) in REPLAY_KERNELS.items()}
    if by_name != want:
        raise AssertionError(f"a replayed block ran {by_name}, not {want}")
    print(f"  replayed block (apart from run_detector): a replayed step's "
          f"kernels by name (torch.profiler, one block / {K_STEPS}): "
          + ", ".join(f"{k} {v // K_STEPS}" for k, v in by_name.items()))


def stacked_blocks(dataset, count: int) -> list:
    """`count` [k, B, ...] blocks of the dataset on the card, as the k-step
    host feed draws them (k x B scenes a draw)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(count):
        flat = dataset.train_batch(rng, K_STEPS * TRAIN_B)
        out.append({n: torch.from_numpy(
            v.reshape((K_STEPS, TRAIN_B) + v.shape[1:])).cuda()
            for n, v in flat.items()})
    return out


def graph_vs_eager_host(cfg) -> None:
    """Three stacked packed blocks (augmented on the card from the step's
    generator) through a block, which warms up, captures and replays, and
    the same 12 slices through single eager steps from the same weights
    and generator seed: bitwise the same losses, parameters, BN
    statistics, moments and count. Each block runs at another BN momentum
    (epochs 0, 20, 40) and the rate steps down after steps 4 and 8, so
    the replays must read both from the device."""
    dataset = get_dataset(cfg)
    blocks = stacked_blocks(dataset, 3)
    source = dataset.source_dataset
    train = dataclasses.replace(cfg.train, lr_decay_steps=(1, 2),
                                lr_decay_rates=(0.5, 0.5))
    bn_ms = [train_lib.bn_momentum_at(train, 20 * i) for i in range(3)]
    got = {}
    for graphed in (True, False):
        model = build_detector(cfg, dataset.mean_sizes)
        optimizer = train_lib.make_optimizer(train, K_STEPS,
                                             model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(9)
        if graphed:
            block = train_lib.make_detector_train_block(
                model, optimizer, cfg, K_STEPS, source)
            losses = torch.cat([block(b, gen, m)["loss"]
                                for b, m in zip(blocks, bn_ms)])
        else:
            step = train_lib.make_detector_steps(model, optimizer, cfg,
                                                 source)
            losses = torch.stack([
                step({n: v[i] for n, v in b.items()}, gen, m)["loss"]
                for b, m in zip(blocks, bn_ms) for i in range(K_STEPS)])
        got[graphed] = trained_state(losses, model, optimizer)
        del model, optimizer
    require_bitwise("packed blocks: graph vs eager steps", got[True],
                    got[False])
    print(f"  3 packed blocks (warm-up, capture + replay, replay; BN "
          f"momentum {bn_ms}, the rate halved after steps 4 and 8) bitwise "
          f"{3 * K_STEPS} eager steps on the same slices: losses, "
          f"{len(got[True]) - 2} tensors and the count")


def phase_train_k(hostfed_work: Path) -> None:
    print(f"== k-step blocks: run_detector, config #3, "
          f"train.steps_per_call={K_STEPS} (a CUDA graph of one step "
          f"replayed {K_STEPS} times a block) against 1, {TRAIN_B} x "
          f"{TRAIN_N} points, {TRAIN_STEPS} steps")
    step_counts = launches(fps=5 * TRAIN_STEPS, ball_query=7 * TRAIN_STEPS,
                           scatter=9 * TRAIN_STEPS)
    # at k: one eager warm-up block, then one step captured
    k_counts = launches(fps=5 * (K_STEPS + 1), ball_query=7 * (K_STEPS + 1),
                        scatter=9 * (K_STEPS + 1))
    work = Path(tempfile.mkdtemp(prefix="tpu3dsad_torch_k_"))
    try:
        # (a) device synth: two eager runs, then the block
        states = []
        for label, k in (("k=1", 1), ("k=1 again", 1), (f"k={K_STEPS}",
                                                         K_STEPS)):
            result = run_counted(k_config(str(work / label), k),
                                 step_counts if k == 1 else k_counts)
            states.append(trained_state(
                [h["loss"] for h in result.history], result.model,
                result.optimizer))
        require_bitwise("two eager runs", states[1], states[0])
        require_bitwise(f"k={K_STEPS} vs k=1", states[2], states[0])
        print(f"  device synth: losses {states[0]['loss'].tolist()}; two "
              f"eager runs bitwise equal, and k={K_STEPS} (a warm-up block, "
              "then a replayed one) bitwise equal to them: losses, "
              "parameters, BN statistics, moments, count")
        del states
        replayed_synth_block(work)

        # (b) the packed split of phase 10's run B through the stacked
        # feed, two epochs, so that at k the last two blocks only replay
        packed = str(hostfed_work / "packed")
        extra = ("data.name=packed", "data.use_color=true",
                 "data.device_augment=true", "data.compact_votes=true",
                 "train.num_epochs=2", "train.eval_every=2")
        steps = 2 * TRAIN_STEPS
        for k in (1, K_STEPS):
            cfg = hostfed_config(packed, str(work / f"packed_{k}"), *extra,
                                 f"train.steps_per_call={k}")
            ran = steps if k == 1 else K_STEPS + 1
            want = launches(fps=5 * ran + 5, ball_query=7 * ran + 7,
                            scatter=9 * ran, nms=1)
            result = run_counted(cfg, want, steps)
            (ev,) = result.evals
            if not np.isfinite(ev["val_loss"]):
                raise AssertionError(f"packed k={k}: eval {ev}")
            print(f"  packed k={k}: losses "
                  f"{[round(h['loss'], 4) for h in result.history]}")
        graph_vs_eager_host(cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    train_lib.apply_runtime_config(Config())


# config #1, the PointNet++ classifier (BASELINE config #1: ModelNet40, 40
# classes, 1024 points a cloud): (a) the SSG model answers CLS_REQUESTS
# clouds one at a time after a warm-up; (b) run_classifier trains MSG on
# synthetic clouds, CLS_B a step, for one epoch cut from the reference's
# 100 steps to CLS_STEPS, then its 8-batch val sweep
CLS_N, CLS_CLASSES, CLS_B, CLS_REQUESTS = 1024, 40, 16, 20
CLS_STEPS, CLS_VAL = 8, train_classifier.SYNTHETIC_VAL_BATCHES
# launches of one forward; an MSG training step adds SA2's three groupings'
# backward, scatters 323 channels wide (xyz + 64 + 128 + 128 features)
CLS_SERVE = dict(fps=2, ball_query=2)
CLS_FORWARD = dict(fps=2, ball_query=6)
CLS_STEP = dict(fps=2, ball_query=6, scatter=3)
# (d) the shape benchmark, r5's recipe
# (docs/experiments/r5_classifier10_shapes_cpu.jsonl): 64 + 16 meshes a
# family, sampled to 4096 points, MSG at 512 points, b = 16, lr 1e-3, val
# after each epoch; val acc >= 0.9 after the last (r5: 0.9625, 0.9875,
# 1.0, 1.0 over epochs 0-3)
SHAPES_TRAIN, SHAPES_TEST, SHAPES_EPOCHS, SHAPES_TARGET = 64, 16, 4, 0.9
SHAPES_ARGS = ["preset=classifier", "model.classifier_msg=true",
               "data.name=modelnet", "data.num_points=512",
               "train.batch_size=16", "train.lr=1e-3",
               f"train.num_epochs={SHAPES_EPOCHS}", "train.eval_every=1",
               "train.lr_decay_steps=(12,18,22)",
               "train.lr_decay_rates=(0.3,0.3,0.3)", "train.ckpt_every=5",
               "train.log_every=10"]


@contextlib.contextmanager
def synthetic_epoch(steps: int):
    """run_classifier's synthetic epoch cut to `steps` within the block."""
    full = train_classifier.SYNTHETIC_STEPS_PER_EPOCH
    train_classifier.SYNTHETIC_STEPS_PER_EPOCH = steps
    try:
        yield
    finally:
        train_classifier.SYNTHETIC_STEPS_PER_EPOCH = full


def cls_config(*args: str) -> Config:
    return parse_cli(["preset=classifier", f"data.num_points={CLS_N}",
                      f"model.num_classes={CLS_CLASSES}", *args])


def cls_clouds(count: int, batch: int, seed: int) -> list:
    """`count` classification batches of `batch` clouds of CLS_N points
    on the card (data/synthetic.py)."""
    rng = np.random.default_rng(seed)
    return [train_classifier.to_device(classification_batch(
        rng, batch, CLS_N, CLS_CLASSES), "cuda") for _ in range(count)]


def cls_grads_of(model, state, batch, bn_m, seed: int = 3):
    """(loss, {name: grad}) of one classifier forward + backward in train
    mode from `state`, dropout drawn from a card generator seeded alike on
    every call."""
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    model.train()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    loss, _ = train_lib.classifier_loss(model, batch, bn_m, gen)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def cls_serve() -> None:
    """(a) the SSG classifier answers B = 1 clouds in eval mode."""
    print(f"  (a) SSG, {CLS_CLASSES} classes, seeded random weights: "
          f"1 warm-up + {CLS_REQUESTS} clouds of {CLS_N} points, one at a "
          "time, fp32")
    torch.backends.cuda.matmul.allow_tf32 = False  # the package's default
    model = build_classifier(cls_config(), CLS_CLASSES)
    clouds = cls_clouds(CLS_REQUESTS + 1, 1, seed=11)
    with torch.inference_mode():
        model(clouds[0]["points"])
        reset_counts()
        outs = [model(c["points"]) for c in clouds[1:]]
        served = counts()
        want = launches(**{k: v * CLS_REQUESTS for k, v in CLS_SERVE.items()})
        if served != want:
            raise AssertionError(f"served {served}, not {want}")
        logits = torch.cat(outs)
        if logits.shape != (CLS_REQUESTS, CLS_CLASSES) or not (
                logits.isfinite().all()):
            raise AssertionError(f"logits {tuple(logits.shape)}, finite "
                                 f"{bool(logits.isfinite().all())}")
        with recording() as calls:
            kernel = model(clouds[1]["points"])
        with ops.use_impl("plain"):
            plain = model(clouds[1]["points"])
    # the same indices on the plain ops, and logits within rtol 1e-5,
    # atol 1e-6 (the same torch ops on the same indices)
    if not torch.allclose(kernel, plain, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"logits: kernel path vs plain path max |diff| "
                             f"{(kernel - plain).abs().max().item()}")
    for name, (args, kw) in zip(("sa1", "sa2"), calls["fps"]):
        fps_case("request", name, *args, kw.get("mask"))
    for name, (args, kw) in zip(("sa1", "sa2"), calls["ball_query"]):
        bq_case("request", name, *args, kw.get("mask"))
    print(f"  plain-ops rerun of cloud 1: FPS and ball-query indices equal, "
          f"logits max |diff| {(kernel - plain).abs().max().item():.3g}")


def cls_train(work: Path) -> None:
    """(b) MSG training through run_classifier, a resume, and one step on
    the kernel and the plain path; (c) the recorded launches of one step
    against their plain versions."""
    cfg = cls_config("model.classifier_msg=true", "data.name=synthetic",
                     f"train.batch_size={CLS_B}", "train.num_epochs=1",
                     "train.log_every=4", f"train.ckpt_dir={work}")
    print(f"  (b) run_classifier: MSG, {CLS_CLASSES} classes, {CLS_B} x "
          f"{CLS_N} points, one synthetic epoch cut to {CLS_STEPS} steps, "
          f"and {CLS_VAL} val batches")
    with synthetic_epoch(CLS_STEPS):
        reset_counts()
        result = train_classifier.run_classifier(cfg)
        trained = counts()
        reset_counts()
        again = train_classifier.run_classifier(cfg)
        resumed = counts()
    want = launches(**{k: CLS_STEP[k] * CLS_STEPS
                       + CLS_FORWARD.get(k, 0) * CLS_VAL for k in CLS_STEP})
    if trained != want:
        raise AssertionError(f"launches {trained} != {want}")
    losses = [h["loss"] for h in result.history]
    if result.step != CLS_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"steps {result.step}, losses {losses}")
    model = result.model
    state = copy.deepcopy(model.state_dict())
    fresh = build_classifier(cfg, CLS_CLASSES).state_dict()
    for kind in ("weight", "running_mean", "running_var"):
        if all(torch.equal(state[k], fresh[k]) for k in state
               if k.endswith(kind)):
            raise AssertionError(f"no {kind} moved in training")
    (ev,) = result.evals
    print(f"  launches {trained}; losses "
          f"{[round(x, 4) for x in losses]}; val acc "
          f"{ev['val_acc']:.4f} over {ev['n_scenes']} clouds")
    if ((again.start_step, again.step) != (CLS_STEPS, CLS_STEPS)
            or resumed != launches() or any(
                not torch.equal(v, state[k])
                for k, v in again.model.state_dict().items())):
        raise AssertionError("the second call did not resume the checkpoint")
    print(f"  parameters and BN statistics moved; a second call resumed at "
          f"step {again.start_step} with the saved state and no launch")

    batch = cls_clouds(1, CLS_B, seed=12)[0]
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    lk, gk = cls_grads_of(model, state, batch, bn_m)
    one = counts()
    with ops.use_impl("plain"):
        lp, gp = cls_grads_of(model, state, batch, bn_m)
    if one != launches(**CLS_STEP) or counts() != one:
        raise AssertionError(f"one MSG step: launches {one} then {counts()}")
    if not torch.equal(lk, lp):
        raise AssertionError(f"MSG step loss: kernel path {lk.item()!r} vs "
                             f"plain path {lp.item()!r}")
    for name, g in gp.items():
        if (at := bits_differ(gk[name], g)) is not None:
            raise AssertionError(f"MSG step grad {name}: kernel path != "
                                 f"plain path {at}")
    print(f"  one MSG step (dropout 0.5, one generator seed), kernel path "
          f"vs plain path: loss {lk.item():.6f} equal; {len(gp)} gradients "
          "bitwise equal")

    print("  (c) the launches of one MSG step, recorded, against their "
          "plain versions (exact; scatter bitwise np.add.at)")
    with recording() as calls:
        cls_grads_of(model, state, batch, bn_m)
    found = {k: len(v) for k, v in calls.items()}
    if found != {**CLS_STEP, "three_nn": 0, "nms": 0}:
        raise AssertionError(f"one MSG step made {found} calls")
    scales = [f"sa{lvl}.{s}" for lvl, sa in ((1, MSG_SA1), (2, MSG_SA2))
              for s in range(len(sa["radii"]))]
    for name, (args, kw) in zip(("sa1", "sa2"), calls["fps"]):
        fps_case("classify", name, *args, kw.get("mask"), compares=3)
    for name, (args, kw) in zip(scales, calls["ball_query"]):
        bq_case("classify", name, *args, kw.get("mask"))
    gen = torch.Generator(device="cuda").manual_seed(13)
    for args, _ in calls["scatter"]:
        scatter_case("classify", *args, gen)


def cls_shapes(work: Path) -> None:
    """(d) the shape benchmark end to end: synthetic_shapes, then
    preproc_modelnet, then run_classifier on r5's recipe."""
    print(f"  (d) the shape benchmark: {SHAPES_TRAIN} + {SHAPES_TEST} OFF "
          f"meshes of each of {len(synthetic_shapes.SHAPE_CLASSES)} families "
          f"(seed 0), sampled to 4096 points, then MSG at 512 points for "
          f"{SHAPES_EPOCHS} epochs")
    written = synthetic_shapes.generate(str(work / "off"), SHAPES_TRAIN,
                                        SHAPES_TEST, seed=0)
    converted = preproc_modelnet.export_all(str(work / "off"),
                                            str(work / "npy"),
                                            num_points=4096)
    print(f"  wrote {written}; converted {converted}")
    cfg = parse_cli([*SHAPES_ARGS, f"data.root={work / 'npy'}",
                     f"train.ckpt_dir={work / 'ckpt'}"])
    reset_counts()
    result = train_classifier.run_classifier(cfg)
    ran = counts()
    steps = SHAPES_TRAIN * len(synthetic_shapes.SHAPE_CLASSES) // 16
    val = -(-SHAPES_TEST * len(synthetic_shapes.SHAPE_CLASSES) // 16)
    want = launches(**{k: CLS_STEP[k] * steps * SHAPES_EPOCHS
                       + CLS_FORWARD.get(k, 0) * val * SHAPES_EPOCHS
                       for k in CLS_STEP})
    if ran != want:
        raise AssertionError(f"launches {ran} != {want}")
    curve = [round(e["val_acc"], 4) for e in result.evals]
    print(f"  launches {ran}; val acc by epoch {curve} (r5 on the CPU: "
          f"0.9625, 0.9875, 1.0, 1.0)")
    if len(curve) != SHAPES_EPOCHS or curve[-1] < SHAPES_TARGET:
        raise AssertionError(f"val acc {curve}: the last below "
                             f"{SHAPES_TARGET}")


def phase_classify(work: Path) -> None:
    print("== config #1, the classifier: serving, MSG training, its "
          "launches against plain, the shape benchmark")
    try:
        cls_serve()
        cls_train(work / "msg")
        cls_shapes(work / "shapes")
    finally:
        train_lib.apply_runtime_config(Config())


# phase 14: the exported serving program. Config #5's CLI export is B = 1
# (train.batch_size=1), as a scene at a time is served through run=; the
# colour model is ScanNet's (18 classes, its mean sizes), exported with
# source_dataset=scannet so run= scales 0-255 colours by 1/256
SERVE_ARGS = ["model.num_classes=10", "data.name=synthetic",
              f"data.num_points={N}", "train.batch_size=1"]
COLOUR_ARGS = ["data.name=scannet", "data.use_color=true",
               f"data.num_points={N}", "train.batch_size=1"]
CLI_SCENES = (50000, 12000)  # raw points: subsampled, padded
SERVED = dict(fps=5, ball_query=7, nms=1)  # launches a request
# custom-op nodes of the exported program: the kernels' and the fp32 cross
# terms of FP1 and FP2's three_nn
PROGRAM_OPS = {"fps": 5, "ball_query": 7, "fp32_cross": 2,
               "greedy_suppress": 1, "bn_relu": BN_RELU_REQUEST["sadet"]}


def graph_calls(path: str) -> dict:
    """{op: nodes} of the custom ops in the program saved at `path`."""
    calls = {}
    for node in serving.load(path).graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("tpu3dsad_torch"):
            name = target.split(".")[1]
            calls[name] = calls.get(name, 0) + 1
    return calls


def export_checked(cfg, model, path: str, want_calls: dict):
    """export_detector at B x N, loaded back; the program's custom-op
    nodes must be want_calls. Returns the loaded program."""
    manifest = serving.export_detector(cfg, model, model.mean_sizes, B, path)
    program = serving.load(path).module()
    calls = graph_calls(path)
    if calls != want_calls:
        raise AssertionError(f"exported graph's op nodes {calls} != "
                             f"{want_calls}")
    print(f"  exported {B} x {N}: {manifest['bytes']} bytes; nodes {calls}")
    return program


def serve_artifact(work: Path) -> SizeAdaptiveDetector:
    """(a) config #5 exported at B = 32 and loaded: bitwise the eager
    program on 5 requests, 5 + 7 launches a request; then one request of
    an export under the sorted tier. Returns the model."""
    cfg, model, infer = build_server()
    cfg = dataclasses.replace(cfg, data=DataConfig(name="synthetic",
                                                   num_points=N))
    warmup, *batches = make_requests(REQUESTS + 1, seed=14)
    program = export_checked(cfg, model, str(work / "serve.pt2"), PROGRAM_OPS)
    with torch.no_grad():
        program(*warmup)
    infer(*warmup)
    reset_counts()
    with torch.no_grad():
        loaded = [program(pts, mask) for pts, mask in batches]
    served = counts()
    if served != launches(**{k: v * REQUESTS for k, v in SERVED.items()}):
        raise AssertionError(f"loaded program's launches {served} != 5, 7, "
                             "1 (NMS) and 0 (scatter) a request")
    for (pts, mask), out in zip(batches, loaded):
        require_bitwise("loaded vs eager request", out, infer(pts, mask))
    kept = [int(o["keep"].sum()) for o in loaded]
    print(f"  {REQUESTS} requests: loaded bitwise eager (6 outputs), "
          f"launches {served}, kept {kept}")

    train_lib.apply_runtime_config(parse_cli(SORTED_ARGS))
    try:
        fast = export_checked(cfg, model, str(work / "sorted.pt2"),
                              {**PROGRAM_OPS, "morton_codes": 1})
        with torch.no_grad():
            fast(*warmup)
            reset_counts()
            out = fast(*batches[0])
        got = counts()
        want = infer(*batches[0])
    finally:
        train_lib.apply_runtime_config(Config())
    if got != launches(fps=5, ball_query=7, sorted=1, nms=1):
        raise AssertionError(f"sorted program's launches {got}")
    require_bitwise("sorted loaded vs eager request", out, want)
    print(f"  sorted tier (SA1): loaded bitwise eager, launches {got}")
    return model


def cli_output(argv: list) -> dict:
    """The last line serving.main prints, as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serving.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cli_round_trip(label: str, args: list, model, colours: bool,
                   work: Path) -> str:
    """(b) ckpt= ... out= on a checkpoint of `model`, then run= on each of
    CLI_SCENES: detection for detection the eager program on
    prepare_scene_batch's tensors, 5 + 7 launches a scene."""
    cfg = parse_cli(args)
    ckpt = str(work / f"ckpt_{label}")
    optimizer = train_lib.make_optimizer(cfg.train, 1, model.parameters())
    train_lib.save_checkpoint(ckpt, model, optimizer, 1)
    out = str(work / f"{label}.pt2")
    report = cli_output([f"ckpt={ckpt}", f"out={out}", *args])
    if (report["ckpt_step"], report["batch_size"], report["with_features"],
            report["platforms"]) != (1, 1, colours, ["cuda"]):
        raise AssertionError(f"{label} export report {report}")
    infer = build_inference_fn(cfg, model, model.mean_sizes,
                               with_features=colours)
    rng = np.random.default_rng(15)
    total = launches()
    found = []
    for points in CLI_SCENES:
        raw = rng.uniform(-3, 3, (points, 3))
        if colours:
            raw = np.concatenate([raw, rng.uniform(0, 255, (points, 3))], 1)
        scene = work / f"{label}_{points}.npy"
        np.save(scene, raw.astype(np.float32))
        reset_counts()
        dets = cli_output([f"run={out}", f"scene={scene}"])["detections"]
        got = counts()
        if got != launches(**SERVED):
            raise AssertionError(f"{label} run= launches {got}")
        total = {k: total[k] + got[k] for k in total}
        args_in = serving.prepare_scene_batch(
            np.load(scene), report)
        want = serving.detections(infer(*args_in))
        if dets != want:
            raise AssertionError(f"{label} run= on {points} points: "
                                 f"{len(dets)} detections != eager "
                                 f"{len(want)} (or their values differ)")
        found.append(len(dets))
    print(f"  CLI {label}: export ({report['bytes']} bytes, source "
          f"{report['source_dataset']!r}); run= on {CLI_SCENES} points: "
          f"{found} detections, each equal to the eager program's; launches "
          f"{total}")
    return ckpt


def demo_check(ckpt: str, model, work: Path) -> None:
    """(c) python -m tpu3dsad_torch.demo on config #5's checkpoint: its
    files, its scene (the synthetic train_batch of default_rng(7)), and its
    detections against the eager program on that scene, in this process
    (the same classes; the floats within 1e-5, another process)."""
    out = work / "demo"
    args = [f"train.ckpt_dir={ckpt}", *SERVE_ARGS]
    proc = subprocess.run([sys.executable, "-m", "tpu3dsad_torch.demo",
                           f"out={out}", *args], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"demo failed:\n{proc.stderr[-4000:]}")
    with open(out / "detections.json") as f:
        result = json.load(f)
    cfg = parse_cli(args)
    batch = get_dataset(cfg).train_batch(np.random.default_rng(7), 1)
    if not np.array_equal(np.load(out / "points.npy"), batch["points"][0]):
        raise AssertionError("demo scene != train_batch(default_rng(7), 1)")
    infer = build_inference_fn(cfg, model, model.mean_sizes)
    want = serving.detections(infer(
        torch.from_numpy(batch["points"]).cuda(),
        torch.from_numpy(batch["point_mask"]).cuda()))
    got = result["detections"]
    if result["ckpt_step"] != 1 or len(got) != len(want) or any(
            g["class"] != w["class"] for g, w in zip(got, want)):
        raise AssertionError(f"demo: step {result['ckpt_step']}, "
                             f"{len(got)} detections, eager {len(want)}")
    worst = max((abs(np.subtract(g[k], w[k])).max() for g, w in zip(got, want)
                 for k in ("center", "size", "heading", "score")),
                default=0.0)
    if worst > 1e-5:
        raise AssertionError(f"demo detections differ by {worst}")
    files = sorted(p.name for p in out.iterdir())
    need = {"detections.json", "points.npy", "points.ply", "gt_boxes.obj"}
    if got:
        need.add("pred_boxes.obj")
    if not need <= set(files):
        raise AssertionError(f"demo wrote {files}")
    print(f"  demo, in its own process: {len(got)} detections (max |diff| "
          f"{worst:.3g} against this process's), files {files}")


def phase_serve_export(work: Path) -> None:
    print(f"== the exported serving program: config #5 exported at {B} x "
          f"{N}, loaded, against the eager program; the export / run CLI "
          "and the demo")
    work.mkdir(parents=True)
    train_lib.apply_runtime_config(Config())  # the CLIs' matmul precision
    model = serve_artifact(work)
    (work / "scannet").mkdir()  # a ScanNet root for its mean sizes
    colour_cfg = parse_cli([*COLOUR_ARGS, f"data.root={work / 'scannet'}"])
    colour = build_detector(colour_cfg, get_dataset(colour_cfg).mean_sizes)
    ckpt = cli_round_trip("points", SERVE_ARGS, model, False, work)
    cli_round_trip("colour", [*COLOUR_ARGS, f"data.root={work / 'scannet'}"],
                   colour, True, work)
    demo_check(ckpt, model, work)


# phase 15: from a raw release to a trained, evaluated and served model
# through the port's own tools. ScanNet: RAW_SCANNET train + val raw scans
# of RAW_VERTS vertices, above the converter's 50000 cap so that every
# scene is subsampled; KITTI: RAW_KITTI train + val velodyne scans of
# RAW_KITTI_N points (config #4's ~120k). The raw files are written here
# from a seed, in the layouts the converters document.
RAW_SCANNET, RAW_VERTS = (32, 8), 60000
RAW_KITTI, RAW_KITTI_N = (8, 2), 120000
# raw category -> nyu40 id of each fixture object: six benchmark classes
# and one annotated instance outside the benchmark
RAW_OBJECTS = {"chair": 5, "table": 7, "bed": 4, "sofa": 6, "cabinet": 3,
               "bookshelf": 10, "wall": 1}
# the imported lineage detector on the converted ScanNet scenes (config
# #3's model and data, batch 8 x 40960 points): 4 steps an epoch
RAW_MODEL = ["model.name=detector", "data.name=scannet",
             "model.proposal_mode=lineage"]
RAW_EPOCHS = 2
RAW_STEPS = RAW_SCANNET[0] // TRAIN_B * RAW_EPOCHS
# the lineage head: one proposal grouping in place of the bank's three
LINEAGE_PARSED = dict(fps=5, ball_query=5, nms=1)  # a forward, its parse
LINEAGE_STEP = dict(fps=5, ball_query=5, scatter=7)
# k of the run that captures a step's CUDA graph under the profiler
RAW_K = 2
# ops.knn on the card above its 2^28-distance slab limit
KNN_B, KNN_N, KNN_K = 2, 16384, 16
# KITTI's camera extrinsics: cam x = -velo y, cam y = -velo z, cam z =
# velo x, and the sensor offset
KITTI_TR = np.array([[0.0, -1.0, 0.0, 0.00],
                     [0.0, 0.0, -1.0, -0.08],
                     [1.0, 0.0, 0.0, -0.27]])
# (type, (l, w, h)) of the KITTI fixture's objects; Van and DontCare are
# dropped by the converter
KITTI_OBJECTS = [("Car", (3.9, 1.6, 1.5)), ("Pedestrian", (0.8, 0.6, 1.8)),
                 ("Cyclist", (1.8, 0.6, 1.7)), ("Van", (5.0, 2.0, 2.2))]
REPO = Path(__file__).resolve().parent


def write_raw_scannet(root: Path, seed: int = 0) -> tuple[str, str]:
    """Raw ScanNet scans under root/scans (binary little-endian PLY with
    rgb, alpha and a face element; aggregation, over-segmentation and an
    axis-alignment meta) with the label TSV and the split lists. Each scan:
    len(RAW_OBJECTS) boxes of points, two segments each, over a floor of
    four unaggregated segments. Returns (scans, labels)."""
    rng = np.random.default_rng(seed)
    scans, names = root / "scans", list(RAW_OBJECTS)
    labels = root / "scannetv2-labels.combined.tsv"
    labels.parent.mkdir(parents=True, exist_ok=True)
    labels.write_text(
        "id\traw_category\tcategory\tnyu40id\tnyu40class\n" + "".join(
            f"{i}\t{n}\t{n}\t{nyu}\t{n}\n"
            for i, (n, nyu) in enumerate(RAW_OBJECTS.items())))
    vertex = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                       ("alpha", "u1")])
    per = RAW_VERTS * 2 // 3 // len(names)
    floor = RAW_VERTS - per * len(names)
    scenes = [f"scene{i:04d}_00" for i in range(sum(RAW_SCANNET))]
    for scene in scenes:
        centers = rng.uniform([-2.5, -2.5, 0.3], [2.5, 2.5, 1.0],
                              (len(names), 3))
        sizes = rng.uniform(0.4, 1.8, (len(names), 3))
        xyz = np.concatenate(
            [c + (rng.random((per, 3)) - 0.5) * s
             for c, s in zip(centers, sizes)]
            + [rng.uniform([-3, -3, 0], [3, 3, 0.02], (floor, 3))])
        table = np.zeros(RAW_VERTS, vertex)
        for i, axis in enumerate("xyz"):
            table[axis] = xyz[:, i]
        colour = np.repeat(rng.integers(0, 256, (len(names) + 1, 3)),
                           [per] * len(names) + [floor], axis=0)
        for i, chan in enumerate(("red", "green", "blue")):
            table[chan] = colour[:, i]
        table["alpha"] = 255
        segs = np.concatenate([
            np.repeat(np.arange(len(names)) * 2, per)
            + np.tile(np.arange(per) % 2, len(names)),
            1000 + np.arange(floor) % 4])
        angle = rng.uniform(-np.pi, np.pi)
        align = np.eye(4)
        align[:2, :2] = [[np.cos(angle), -np.sin(angle)],
                         [np.sin(angle), np.cos(angle)]]
        align[:3, 3] = rng.uniform(-1, 1, 3)
        d = scans / scene
        d.mkdir(parents=True)
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {RAW_VERTS}"]
        header += [f"property {'float' if n in 'xyz' else 'uchar'} {n}"
                   for n in vertex.names]
        header += ["element face 1", "property list uchar int vertex_indices",
                   "end_header"]
        with open(d / f"{scene}_vh_clean_2.ply", "wb") as f:
            f.write(("\n".join(header) + "\n").encode())
            f.write(table.tobytes())
            f.write(b"\x03" + np.arange(3, dtype="<i4").tobytes())
        (d / f"{scene}.aggregation.json").write_text(json.dumps({
            "segGroups": [{"id": o, "objectId": o, "label": name,
                           "segments": [2 * o, 2 * o + 1]}
                          for o, name in enumerate(names)]}))
        (d / f"{scene}_vh_clean_2.0.010000.segs.json").write_text(
            json.dumps({"segIndices": segs.tolist()}))
        (d / f"{scene}.txt").write_text(
            f"numVertices = {RAW_VERTS}\naxisAlignment = "
            + " ".join(f"{v:.6f}" for v in align.reshape(-1)) + "\n")
    (root / "train.txt").write_text(
        "\n".join(scenes[:RAW_SCANNET[0]]) + "\n")
    (root / "val.txt").write_text("\n".join(scenes[RAW_SCANNET[0]:]) + "\n")
    return str(scans), str(labels)


def write_raw_kitti(root: Path, seed: int = 0) -> str:
    """Raw KITTI object files under root/training: velodyne scans of
    RAW_KITTI_N points (a ground plane in the crop range, points in each
    box, a tenth outside the range), camera-frame labels of 8 objects (a
    DontCare line too) and calib with a slightly turned R0_rect; the split
    lists beside. Returns root."""
    rng = np.random.default_rng(seed)
    split = root / "training"
    for d in ("velodyne", "label_2", "calib"):
        (split / d).mkdir(parents=True)
    ids = [f"{i:06d}" for i in range(sum(RAW_KITTI))]
    for idx in ids:
        lines, parts = [], []
        r0 = np.eye(3)
        a = rng.normal(0.0, 0.01)
        r0[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        n_box = 8
        in_box = RAW_KITTI_N // 4 // n_box
        for o in range(n_box):
            typ, (length, w, h) = KITTI_OBJECTS[o % len(KITTI_OBJECTS)]
            center = np.array([rng.uniform(6, 60), rng.uniform(-25, 25),
                               -1.7 + h / 2])
            yaw = rng.uniform(-np.pi, np.pi)
            local = (rng.random((in_box, 3)) - 0.5) * [length, w, h]
            c, s = np.cos(yaw), np.sin(yaw)
            parts.append(local @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
                         + center)
            bottom = center - [0, 0, h / 2]
            rect = r0 @ (KITTI_TR[:, :3] @ bottom + KITTI_TR[:, 3])
            lines.append(f"{typ} 0.00 0 0.00 0 0 50 50 {h:.2f} {w:.2f} "
                         f"{length:.2f} {rect[0]:.2f} {rect[1]:.2f} "
                         f"{rect[2]:.2f} {-yaw - np.pi / 2:.2f}")
        lines.append("DontCare -1 -1 -10 0 0 50 50 -1 -1 -1 -1000 -1000 "
                     "-1000 -10")
        rest = RAW_KITTI_N - in_box * n_box
        outside = rest // 10
        parts.append(rng.uniform([0, -40, -1.75], [70.4, 40, -1.65],
                                 (rest - outside, 3)))
        parts.append(rng.uniform([-20, -60, -3], [90, 60, 3], (outside, 3)))
        xyz = np.concatenate(parts)
        pc = np.concatenate([xyz, rng.random((RAW_KITTI_N, 1))], 1)
        pc.astype(np.float32).tofile(split / "velodyne" / f"{idx}.bin")
        (split / "label_2" / f"{idx}.txt").write_text("\n".join(lines) + "\n")
        (split / "calib" / f"{idx}.txt").write_text(
            "".join(f"P{i}: " + " ".join(["0"] * 12) + "\n" for i in range(4))
            + "R0_rect: " + " ".join(f"{v:.9f}" for v in r0.reshape(-1))
            + "\nTr_velo_to_cam: "
            + " ".join(f"{v:.9f}" for v in KITTI_TR.reshape(-1)) + "\n")
    (root / "train.txt").write_text("\n".join(ids[:RAW_KITTI[0]]) + "\n")
    (root / "val.txt").write_text("\n".join(ids[RAW_KITTI[0]:]) + "\n")
    return str(root)


def lineage_names() -> dict:
    """{lineage name: (the port's key, trailing 1s of the lineage conv
    weight)} of the lineage-mode detector, as the lineage's VoteNet names
    its tensors (the proposal MLP's BatchNorms inside BNMomentum)."""
    names = {}

    def conv(src, dst, ones, bias):
        names[f"{src}.weight"] = (f"{dst}.weight", ones)
        if bias:
            names[f"{src}.bias"] = (f"{dst}.bias", 0)

    def bn(src, dst):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            names[f"{src}.{leaf}"] = (f"{dst}.{leaf}", 0)

    for src, dense, norm in import_torch._rules():
        conv(f"{src}.conv", dense, 2, False)
        bn(f"{src}.bn", norm)
    for j in range(2):
        conv(f"vgen.conv{j + 1}", f"voting.dense_{j}", 1, True)
        bn(f"vgen.bn{j + 1}", f"voting.bn_{j}")
    conv("vgen.conv3", "voting.out", 1, True)
    for j in range(3):
        src = f"pnet.vote_aggregation.mlp_module.layer{j}"
        conv(f"{src}.conv", f"proposal.sa_mlp.dense_{j}", 2, False)
        bn(f"{src}.bn.bn", f"proposal.sa_mlp.bn_{j}")
    for j in range(2):
        conv(f"pnet.conv{j + 1}", f"proposal.head_{j}", 1, True)
        bn(f"pnet.bn{j + 1}", f"proposal.head_bn_{j}")
    conv("pnet.conv3", "proposal.head_out", 1, True)
    return names


def write_lineage_checkpoint(cfg, path: Path, seed: int = 0) -> dict:
    """A lineage checkpoint.tar for the lineage-mode detector of cfg:
    seeded tensors under lineage_names() at the lineage's shapes (conv
    weights [out, in, 1(, 1)]), with each BatchNorm's num_batches_tracked.
    Returns {lineage name: tensor} of the weights."""
    template = build_detector(cfg, device="cpu").state_dict()
    names = lineage_names()
    if sorted(key for key, _ in names.values()) != sorted(template):
        raise AssertionError("the lineage names do not cover the detector")
    rng = np.random.default_rng(seed)
    weights = {}
    for name, (key, ones) in names.items():
        shape = tuple(template[key].shape)
        if name.endswith("running_var"):
            value = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("bn.weight", "bn1.weight", "bn2.weight")):
            value = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 2:  # a conv weight, by its fan-in
            value = rng.standard_normal(shape) / np.sqrt(shape[1])
        else:
            value = rng.normal(0.0, 0.1, shape)
        weights[name] = torch.from_numpy(
            value.astype(np.float32).reshape(shape + (1,) * ones))
    tracked = {n.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(7)
               for n in weights if n.endswith("running_var")}
    torch.save({"epoch": 7, "model_state_dict": {**weights, **tracked}},
               path)
    return weights


def run_module(module: str, args: list) -> dict:
    """python -m <module> <args> in its own process: the JSON of its last
    stdout line. Its exit code must be 0."""
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


class TeeStderr(io.StringIO):
    """stderr kept as it is written, and passed on."""

    def write(self, text):
        sys.__stderr__.write(text)
        return super().write(text)


def raw_convert(work: Path) -> dict:
    """(a) Both raw releases written and converted by the port's
    converters, each in its own process; both outputs validated."""
    scans, labels = write_raw_scannet(work / "raw_scannet")
    kitti_raw = write_raw_kitti(work / "raw_kitti")
    scannet_out, kitti_out = str(work / "scannet"), str(work / "kitti")
    raw = work / "raw_scannet"
    report = run_module("tpu3dsad_torch.data.preproc_scannet", [
        f"scans={scans}", f"labels={labels}", f"out={scannet_out}",
        f"train_list={raw / 'train.txt'}", f"val_list={raw / 'val.txt'}"])
    if report["written"] != {"train": RAW_SCANNET[0],
                             "val": RAW_SCANNET[1]}:
        raise AssertionError(f"preproc_scannet wrote {report}")
    raw = work / "raw_kitti"
    report = run_module("tpu3dsad_torch.data.preproc_kitti", [
        f"root={kitti_raw}", f"out={kitti_out}",
        f"train_list={raw / 'train.txt'}", f"val_list={raw / 'val.txt'}"])
    if report["written"] != {"train": RAW_KITTI[0], "val": RAW_KITTI[1]}:
        raise AssertionError(f"preproc_kitti wrote {report}")
    for name, root in (("scannet", scannet_out), ("kitti", kitti_out)):
        rep = validate_root(name, root)
        if rep.errors:
            raise AssertionError(f"validate {name}: {rep.errors[:5]}")
    vert = np.load(Path(scannet_out) / "train" / "scene0000_00_vert.npy")
    if vert.shape != (min(RAW_VERTS, 50000), 6):  # the converter's cap
        raise AssertionError(f"a converted scene is {vert.shape}")
    print(f"  converted {sum(RAW_SCANNET)} raw ScanNet scans of {RAW_VERTS} "
          f"vertices (preproc_scannet) and {sum(RAW_KITTI)} KITTI scans of "
          f"{RAW_KITTI_N} points (preproc_kitti); data.validate passes on "
          "both")
    return {"scannet": scannet_out, "kitti": kitti_out}


def raw_import(work: Path, root: str) -> str:
    """(b) A seeded lineage checkpoint.tar through the importer's own
    process: nothing skipped, and each placed tensor bitwise its source.
    Returns the checkpoint directory."""
    cfg = parse_cli([*RAW_MODEL, f"data.root={root}"])
    tar, out = work / "checkpoint.tar", work / "imported"
    weights = write_lineage_checkpoint(cfg, tar)
    report = run_module("tpu3dsad_torch.utils.import_torch", [
        f"ckpt={tar}", f"out={out}", *RAW_MODEL, f"data.root={root}"])
    if (report["skipped"], report["copied"], report["total_source_tensors"]
            ) != ([], len(weights), len(weights)):
        raise AssertionError(f"import report {report}")
    state = torch.load(out / "ckpt_1.pt", map_location="cpu",
                       weights_only=True)
    if state["step"] != 1:
        raise AssertionError(f"imported step {state['step']}")
    for name, (key, _) in lineage_names().items():
        placed = state["model"][key]
        if not torch.equal(placed, weights[name].reshape(placed.shape)):
            raise AssertionError(f"{name} -> {key} is not its source")
    print(f"  imported {report['copied']} lineage tensors (its own "
          "process), none skipped, each bitwise its source")
    return str(out)


def raw_train(work: Path, root: str, ckpt: str) -> None:
    """(c) The import fine-tuned through the train entry, in this process:
    RAW_EPOCHS epochs with a sweep after each, the first one profiled,
    TensorBoard asked for; then eval_detector.main on the result, and the
    export / run CLI on a converted val scene against the plain ops."""
    profile, tb = work / "profile", work / "tb"
    args = [*RAW_MODEL, f"data.root={root}", f"train.ckpt_dir={ckpt}",
            f"train.num_epochs={RAW_EPOCHS}", "train.eval_every=1",
            "train.log_every=4", f"train.profile_dir={profile}",
            f"train.tb_dir={tb}", "ops_impl=pallas"]
    reset_counts()
    err = TeeStderr()
    with sweep_calls() as t, contextlib.redirect_stderr(err):
        result = train_entry.main(args)
    got = counts()
    sweeps = len(t["scenes"])
    want = {k: LINEAGE_STEP.get(k, 0) * RAW_STEPS
            + LINEAGE_PARSED.get(k, 0) * sweeps for k in counts()}
    print(f"  train entry launches: {got} ({RAW_STEPS} steps, {sweeps} sweep "
          "batches)")
    losses = [h["loss"] for h in result.history]
    if (result.start_step, result.step) != (1, 1 + RAW_STEPS) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"steps {result.start_step} -> {result.step}, "
                             f"losses {losses}")
    if got != want or t["scenes"] != [RAW_SCANNET[1]] * RAW_EPOCHS:
        raise AssertionError(f"launches {got} != {want}; sweep batches of "
                             f"{t['scenes']} scenes")
    trace = profile / "trace.json"
    if not trace.is_file() or trace.stat().st_size == 0:
        raise AssertionError(f"no trace in {profile}")
    if importlib.util.find_spec("tensorboard") is None:
        if "tensorboard unavailable" not in err.getvalue():
            raise AssertionError("no note that tensorboard is missing")
        tb_text = "tensorboard does not import: the note on stderr"
    else:
        if not list(tb.glob("events.out.tfevents.*")):
            raise AssertionError(f"no TensorBoard event file in {tb}")
        tb_text = "an event file in tb_dir"
    for ev in result.evals:
        if not (np.isfinite(ev["val_loss"]) and 0 <= ev["mAP@0.25"] <= 1):
            raise AssertionError(f"sweep {ev}")
    print(f"  resumed at step {result.start_step}, trained to "
          f"{result.step}: losses {[round(x, 4) for x in losses]}; sweeps' "
          f"mAP@0.25 {[ev['mAP@0.25'] for ev in result.evals]}; trace "
          f"{trace.stat().st_size} bytes; {tb_text}")

    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluated = eval_detector.main([*RAW_MODEL, f"data.root={root}",
                                        f"train.ckpt_dir={ckpt}"])
    eval_counts = counts()
    if (evaluated["ckpt_step"] != result.step or eval_counts != launches(
            **LINEAGE_PARSED) or not 0 <= evaluated["mAP@0.25"] <= 1
            or not np.isfinite(evaluated["val_loss"])):
        raise AssertionError(f"eval_detector.main: {evaluated}, launches "
                             f"{eval_counts}")
    print(f"  eval_detector.main: ckpt_step {evaluated['ckpt_step']}, "
          f"mAP@0.25 {evaluated['mAP@0.25']}, val_loss "
          f"{evaluated['val_loss']}, launches {eval_counts}")

    program = str(work / "imported.pt2")
    report = cli_output([f"ckpt={ckpt}", f"out={program}", *RAW_MODEL,
                         f"data.root={root}", "train.batch_size=1"])
    scene = sorted(Path(root, "val").glob("*_vert.npy"))[0]
    reset_counts()
    dets = cli_output([f"run={program}", f"scene={scene}"])["detections"]
    serve_counts = counts()
    with ops.use_impl("plain"):
        plain = cli_output([f"run={program}", f"scene={scene}"])["detections"]
    if serve_counts != launches(**LINEAGE_PARSED) or dets != plain or \
            report["ckpt_step"] != result.step:
        raise AssertionError(f"served the import: launches {serve_counts}, "
                             f"{len(dets)} detections vs plain {len(plain)}, "
                             f"report {report}")
    print(f"  serving.main: exported step {report['ckpt_step']}; run= on "
          f"{scene.name}: {len(dets)} detections, equal to the plain ops'; "
          f"launches {serve_counts}")


def raw_capture_profiled(work: Path, root: str) -> None:
    """(c') train.steps_per_call=RAW_K from scratch with the profiler on:
    its first epoch holds the eager block and the captured step, so the
    CUDA graph is captured under an active profiler."""
    profile = work / "profile_k"
    args = [*RAW_MODEL, f"data.root={root}", f"train.ckpt_dir={work / 'k'}",
            "train.num_epochs=1", "train.eval_every=10",
            f"train.steps_per_call={RAW_K}", f"train.profile_dir={profile}"]
    reset_counts()
    result = train_entry.main(args)
    got = counts()
    steps = RAW_SCANNET[0] // TRAIN_B
    # the counters see the eager block and the captured step, not a replay
    want = launches(**{k: v * (RAW_K + 1) for k, v in LINEAGE_STEP.items()})
    losses = [h["loss"] for h in result.history]
    if result.step != steps or not np.isfinite(losses).all() or got != want \
            or not (profile / "trace.json").is_file():
        raise AssertionError(f"k={RAW_K} under the profiler: step "
                             f"{result.step}, losses {losses}, launches "
                             f"{got} != {want}")
    print(f"  train.steps_per_call={RAW_K} with the first epoch profiled: "
          f"the graph captured under the profiler; losses "
          f"{[round(x, 4) for x in losses]}, launches {got}, trace "
          f"{(profile / 'trace.json').stat().st_size} bytes")


def raw_outdoor(work: Path, root: str) -> None:
    """(d) Config #4 from the converted KITTI scenes through the train
    entry, one epoch of one step: B2 once per scene the loader caches."""
    args = ["preset=outdoor", f"data.root={root}", "data.device_preproc=true",
            "train.num_epochs=1", "train.log_every=1",
            f"train.ckpt_dir={work / 'outdoor'}"]
    reset_counts()
    with sweep_calls() as t:
        result = train_entry.main(args)
    got = counts()
    written = len(fps_caches(root))
    want = launches(**STEP4["fps"], fps_flat=written)
    losses = [h["loss"] for h in result.history]
    if got != want or t["device_fps"] != written or not written or \
            result.step != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"outdoor from raw: launches {got} != {want}, "
                             f"{t['device_fps']} device_fps, step "
                             f"{result.step}, losses {losses}")
    print(f"  config #4 from the converted scenes: loss {losses[0]:.6f}; B2 "
          f"once per scene cached ({written}); launches {got}")


def raw_knn(gen) -> None:
    """(e) ops.knn at [KNN_B, KNN_N, KNN_N], k = KNN_K, past the slab
    limit, against the direct path forced on the same inputs."""
    query, support = cloud(gen, KNN_B, KNN_N), cloud(gen, KNN_B, KNN_N)
    if KNN_B * KNN_N * KNN_N <= plain_knn._SLAB_LIMIT:
        raise AssertionError("the knn shape does not reach the slab scan")
    valid = torch.ones(KNN_B, KNN_N, dtype=torch.bool, device="cuda")
    d_scan, i_scan = ops.knn(query, support, KNN_K)
    d_dir, i_dir = plain_knn._knn_direct(query, support, KNN_K, valid)
    require_equal("knn idx: slab scan vs direct", i_scan, i_dir)
    err = (d_scan - d_dir).abs().max().item()
    print(f"  ops.knn [{KNN_B}, {KNN_N}, {KNN_N}] k = {KNN_K}: the slab scan "
          f"({-(-KNN_N // (plain_knn._SLAB_LIMIT // (KNN_B * KNN_N)))} slabs)"
          f" picks the direct path's indices, max |d2 diff| {err}")


def phase_from_raw(gen, work: Path) -> None:
    print(f"== from raw releases: {sum(RAW_SCANNET)} ScanNet scans and "
          f"{sum(RAW_KITTI)} KITTI scans converted, a lineage checkpoint "
          "imported, fine-tuned through the train entry, evaluated, served; "
          "config #4 from the converted scans; ops.knn")
    print("  importable here: " + ", ".join(
        f"{name} {importlib.util.find_spec(name) is not None}"
        for name in ("PIL", "tensorboard")) + " (preproc_sunrgbd needs PIL; "
          "it is checked by its CPU tests, not here)")
    work.mkdir(parents=True)
    try:
        data = raw_convert(work)
        ckpt = raw_import(work, data["scannet"])
        raw_train(work, data["scannet"], ckpt)
        raw_capture_profiled(work, data["scannet"])
        raw_outdoor(work, data["kitti"])
        raw_knn(gen)
    finally:
        train_lib.apply_runtime_config(Config())


# ------------------------------------------------ phase 16: parallelism

# ranks are processes spawned here (parallel.launch.spawn), every one on
# cuda:0, joined by gloo on CUDA tensors, asked for by name: NCCL puts one
# rank on a card. Data parallelism: config #3 at 8 x 40960 split over 2
# ranks, PAR_STEPS steps and a sweep of PAR_SWEEP batches, in fp32 (TF32
# products differ with the rows a GEMM holds). Context parallelism: config
# #4's model at its published widths on one scene of CP_N points with a
# masked tail, SA1 and SA2 point-sharded over 2 ranks. Hybrid: a 2 x 2
# mesh, config #4's SA1 stage and a kNN at B = 2 x CP_N.
PAR_BACKEND, PAR_WORLD, PAR_STEPS, PAR_SWEEP = "gloo", 2, 3, 2
PAR_DEVICE = "cuda"  # every rank's: cuda:0
PAR_FP32 = ["train.bf16_matmul=false"]
CP_N, CP_TAIL = 122880, 1000
CP_ARGS = ["preset=outdoor", "model.cp_stages=2", *PAR_FP32]
CP_KEYS = ("seed_inds", "seed_xyz", "proposal_xyz", "raw_params",
           "objectness_scores")
HYBRID_B, HYBRID_KNN_M, HYBRID_KNN_K = 2, 1024, 3
# the entry's run: 16 + 2 ScanNet-format scenes, 2 steps of 8
ENTRY_SCENES = (16, 2)


def par_config(ckpt_dir: str) -> Config:
    """Config #3 (train_config) in fp32, for the DP comparisons."""
    cfg = train_config(ckpt_dir)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, bf16_matmul=False))


def cp_model_config() -> Config:
    return parse_cli(CP_ARGS)


# The gradients of world 2 against world 1. With BatchNorm on its running
# statistics (test_dp.py's comparison), per tensor: max |a - b| <= 1e-4 x
# its max |grad| + 1e-6 x the model's largest |grad| (the port's bar for
# a train step, tests/test_torch_train.py). A train-mode step's gradients
# pass BatchNorm's batch statistics, whose backward cancels over every
# row (the rows' gradients sum to zero), so fp32 sums in another order
# move single entries far (15% of a tensor's max at config #3 on the
# card): there the whole gradient's relative L2 distance must stay under
# TRAIN_GRAD_L2, or 4 x the floor, the distance of world 1 with its scenes
# in reverse order (the same sums in another order), where that is more;
# a wrong sum or denominator (a factor of 2) breaks either.
EVAL_GRAD_BAR, TRAIN_GRAD_L2 = (1e-4, 1e-6), 1e-2


def picks_hook(model) -> dict:
    """{"picks": the last forward's proposal picks}, kept by a forward hook
    (the picks are FPS over the votes: where fp32 sums in another order
    move a vote, a pick can flip)."""
    seen = {}
    model.register_forward_hook(
        lambda m, args, out: seen.update(picks=host(out["proposal_inds"])))
    return seen


def l2_distance(got: dict, want: dict) -> float:
    """|got - want| / |want| over every gradient entry."""
    num = sum(float((got[k].float() - v.float()).square().sum())
              for k, v in want.items())
    den = sum(float(v.float().square().sum()) for v in want.values())
    return (num / den) ** 0.5


def grads_close(label: str, got: dict, want: dict, bar) -> tuple:
    """Raise unless every gradient tensor is within `bar` (RTOL, GTOL);
    returns (the worst share of the bar, the worst |a - b| over the
    tensor's max |grad| among tensors above 1% of the model's largest,
    the worst |a - b|)."""
    rtol, gtol = bar
    gmax = max(v.abs().max().item() for v in want.values())
    share = rel = worst = 0.0
    for k, v in want.items():
        err = (got[k].float() - v.float()).abs().max().item()
        vmax = v.abs().max().item()
        limit = rtol * vmax + gtol * gmax
        if err > limit:
            raise AssertionError(f"{label}: gradient {k} differs by {err:.3g}"
                                 f" > {limit:.3g}")
        share = max(share, err / limit if limit else 0.0)
        if vmax >= 1e-2 * gmax:
            rel = max(rel, err / vmax)
        worst = max(worst, err)
    return share, rel, worst


def eval_grads(model, cfg, batch, group=None) -> dict:
    """The gradients of the detection loss with BatchNorm on its running
    statistics (test_dp.py's comparison), summed over `group`."""
    model.eval()
    model.zero_grad(set_to_none=True)
    with collectives.data_parallel(group):
        loss, _ = train_lib.detector_loss(model, cfg, batch, 0.9)
        loss.backward()
    grads = [p.grad for p in model.parameters()]
    collectives.all_reduce_coalesced(grads, group)
    return {n: host(p.grad) for n, p in model.named_parameters()}


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy of t on the host (never an alias of a tensor the run goes on
    to change)."""
    return t.detach().to("cpu", copy=True)


def max_diff(got: dict, want: dict) -> float:
    return max((got[k].float() - v.float()).abs().max().item()
               for k, v in want.items())


def compare_recorded(label: str, calls: dict, gen) -> None:
    """The recorded FPS and ball-query launches equal to their plain
    versions, the scatter launches bitwise np.add.at (check_scatter)."""
    for args, kw in calls["fps"]:
        require_equal(f"{label} fps", cuda_fps.furthest_point_sample(
            *args, **kw), plain_fps(*args, **kw))
    for args, kw in calls["ball_query"]:
        got, want = cuda_bq.ball_query(*args, **kw), plain_bq(*args, **kw)
        require_equal(f"{label} ball query idx", got[0], want[0])
        require_equal(f"{label} ball query cnt", got[1], want[1])
    for args, kw in calls["scatter"]:
        check_scatter(label, *args, gen)
    print(f"  {label}: {len(calls['fps'])} FPS and "
          f"{len(calls['ball_query'])} ball-query launches equal to plain, "
          f"{len(calls['scatter'])} scatters bitwise np.add.at")


def dp_rank_steps(rank: int, mesh, work: Path) -> dict:
    """PAR_STEPS steps, each from the world-1 run's state before it, on
    this rank's rows of its batch: loss, launches, gradients, state."""
    cfg = par_config(str(work / "dp2"))
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device=PAR_DEVICE)
    optimizer = train_lib.make_optimizer(
        cfg.train, TRAIN_STEPS, model.parameters(), train_lib.data_axis(mesh))
    step = train_lib.make_detector_steps(model, optimizer, cfg)
    gen = torch.Generator(device=PAR_DEVICE).manual_seed(cfg.train.seed + 1)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    seen = picks_hook(model)
    out = []
    for i in range(PAR_STEPS):
        state = torch.load(work / f"state_{i}.pt", map_location=PAR_DEVICE)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        batch = shard_batch(torch.load(work / f"batch_{i}.pt",
                                       map_location=PAR_DEVICE), mesh)
        record = (recording() if rank == 0 and i == 0
                  else contextlib.nullcontext())
        torch.distributed.barrier()
        reset_counts()
        with record as calls:
            loss = step(batch, gen, bn_m)["loss"].item()
        out.append({"loss": loss, "counts": counts(),
                    "picks": seen["picks"],
                    "grads": {n: host(p.grad) for n, p in
                              model.named_parameters()},
                    "state": {k: host(v) for k, v in
                              model.state_dict().items()}})
        if calls is not None:
            compare_recorded(f"rank 0, DP step 1 ({TRAIN_B // PAR_WORLD} "
                             f"scenes)", calls, gen)
    model.load_state_dict(torch.load(work / "state_0.pt",
                                     map_location=PAR_DEVICE)["model"])
    batch = shard_batch(torch.load(work / "batch_0.pt",
                                   map_location=PAR_DEVICE), mesh)
    return {"steps": out,
            "eval_grads": eval_grads(model, cfg, batch,
                                     train_lib.data_axis(mesh))}


def dp_rank_sweep(mesh, work: Path) -> dict:
    cfg = par_config(str(work / "sweep2"))
    model = build_detector(cfg, device=PAR_DEVICE)
    model.load_state_dict(torch.load(work / "state_0.pt",
                                     map_location=PAR_DEVICE)["model"])
    eval_step = train_lib.make_detector_eval_step(model, cfg, mesh)

    def parse(end_points):
        return parse_predictions(end_points, model.mean_sizes,
                                 cfg.model.num_heading_bins, cfg.eval)

    reset_counts()
    metrics = train_detector.evaluate(cfg, model, get_dataset(cfg),
                                      eval_step, parse,
                                      num_batches=PAR_SWEEP, mesh=mesh)
    return {"metrics": metrics, "counts": counts()}


def cp_rank(rank: int, work: Path) -> dict:
    """The CP forward over a ('points',) mesh of the ranks: end points,
    launches, collectives; and the collectives of SA1's sharded FPS
    alone."""
    mesh = make_mesh((-1,), ("points",))
    cfg = cp_model_config()
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device=PAR_DEVICE)
    scene = torch.load(work / "cp_scene.pt", map_location=PAR_DEVICE)
    record = recording() if rank == 0 else contextlib.nullcontext()
    torch.distributed.barrier()
    reset_counts()
    calls0 = collectives.calls
    with record as calls, torch.no_grad():
        ep = model(scene["points"], mask=scene["mask"], cp_mesh=mesh)
    found = {"counts": counts(), "collectives": collectives.calls - calls0,
             "end_points": {k: ep[k].cpu() for k in CP_KEYS}}
    if calls is not None:
        compare_recorded("rank 0, CP forward", calls,
                         torch.Generator(device=PAR_DEVICE).manual_seed(3))
        found["sharded_level_bq"] = [tuple(a[0].shape) for a, _ in
                                     calls["ball_query"][:cfg.model.cp_stages]]
    npoint = cfg.model.sa_npoints[0]
    torch.distributed.barrier()
    calls0 = collectives.calls
    point_sharded.sharded_fps(scene["points"], npoint, mesh,
                              mask=scene["mask"])
    found["fps_collectives"] = collectives.calls - calls0
    return found


def par_rank(rank: int, world: int, work: str) -> dict:
    """Phase 16 (a)-(c) on one rank of PAR_WORLD."""
    work = Path(work)
    torch.cuda.set_device(0)
    mesh = make_mesh((-1,), ("data",))
    return {"dp": dp_rank_steps(rank, mesh, work),
            "sweep": dp_rank_sweep(mesh, work),
            "cp": cp_rank(rank, work)}


def hybrid_rank(rank: int, world: int, work: str) -> dict:
    """Phase 16 (d): config #4's SA1 stage and a kNN on a 2 x 2 mesh
    ('data', 'points'), this rank's rows."""
    torch.cuda.set_device(0)
    mesh = make_mesh((2, 2), ("data", "points"))
    cfg = cp_model_config()
    c = torch.load(Path(work) / "hybrid.pt", map_location=PAR_DEVICE)
    m = cfg.model
    torch.distributed.barrier()
    reset_counts()
    sa = point_sharded.sharded_sa_stage(
        c["xyz"], c["feats"], m.sa_npoints[0], m.sa_radii[0],
        m.sa_nsamples[0], mesh, mask=c["mask"], batch_axis="data")
    knn = point_sharded.sharded_knn(c["query"], c["xyz"], HYBRID_KNN_K, mesh,
                                    support_mask=c["mask"], batch_axis="data")
    return {"sa": [t.cpu() for t in sa], "knn": [t.cpu() for t in knn],
            "counts": counts(),
            "coords": (mesh.axis_index("data"), mesh.axis_index("points"))}


def dp_world_one(work: Path) -> dict:
    """The world-1 run the ranks are held to: PAR_STEPS steps of config #3
    (fp32) on batches made here, each step's starting state and batch
    saved for the ranks; then the sweep from the first state."""
    cfg = par_config(str(work / "dp1"))
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device=PAR_DEVICE)
    optimizer = train_lib.make_optimizer(cfg.train, TRAIN_STEPS,
                                         model.parameters())
    step = train_lib.make_detector_steps(model, optimizer, cfg)
    gen = torch.Generator(device=PAR_DEVICE).manual_seed(cfg.train.seed + 1)
    data_gen = torch.Generator(device=PAR_DEVICE).manual_seed(16)
    bn_m = train_lib.bn_momentum_at(cfg.train, 0)
    seen = picks_hook(model)
    steps = []
    for i in range(PAR_STEPS):
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict()},
                   work / f"state_{i}.pt")
        batch = synthetic_detection_batch(data_gen, TRAIN_B, TRAIN_N, 18,
                                          vote_candidates=3)
        torch.save(batch, work / f"batch_{i}.pt")
        loss = step(batch, gen, bn_m)["loss"].item()
        steps.append({"loss": loss, "picks": seen["picks"],
                      "grads": {n: p.grad.clone() for n, p in
                                model.named_parameters()},
                      "state": copy.deepcopy(model.state_dict())})
    floor = []
    for i, w in enumerate(steps):  # the same steps, scenes in reverse
        state = torch.load(work / f"state_{i}.pt")
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        batch = torch.load(work / f"batch_{i}.pt")
        loss = step({k: v.flip(0) for k, v in batch.items()}, gen,
                    bn_m)["loss"].item()
        floor.append({
            "grads": l2_distance({n: p.grad for n, p in
                                  model.named_parameters()}, w["grads"]),
            "loss": abs(loss - w["loss"]),
            "flips": int((seen["picks"].flip(0) != w["picks"]).sum())})
    model.load_state_dict(torch.load(work / "state_0.pt")["model"])
    grads = eval_grads(model, cfg, torch.load(work / "batch_0.pt"))
    eval_step = train_lib.make_detector_eval_step(model, cfg)

    def parse(end_points):
        return parse_predictions(end_points, model.mean_sizes,
                                 cfg.model.num_heading_bins, cfg.eval)

    sweep = train_detector.evaluate(cfg, model, get_dataset(cfg), eval_step,
                                    parse, num_batches=PAR_SWEEP)
    return {"steps": steps, "sweep": sweep, "eval_grads": grads,
            "floor": floor}


def cp_world_one(work: Path) -> dict:
    """One KITTI-style scene of CP_N points (a masked tail of CP_TAIL),
    saved for the ranks, and the unsharded forward on it (B1, B3)."""
    pc, _ = synthetic_outdoor.outdoor_scene(np.random.default_rng(4), CP_N)
    points = torch.from_numpy(pc[None, :, :3].copy()).to(PAR_DEVICE)
    mask = torch.ones(1, CP_N, dtype=torch.bool, device=PAR_DEVICE)
    mask[:, CP_N - CP_TAIL:] = False
    torch.save({"points": points, "mask": mask}, work / "cp_scene.pt")
    cfg = cp_model_config()
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg, device=PAR_DEVICE)
    reset_counts()
    with torch.no_grad():
        ep = model(points, mask=mask)
    return {"end_points": {k: ep[k] for k in CP_KEYS}, "counts": counts()}


def hybrid_world_one(work: Path) -> dict:
    """B = HYBRID_B scenes of CP_N points (masked tails) with one feature
    channel, saved for the ranks; the unsharded SA1 stage and kNN."""
    m = cp_model_config().model
    rng = np.random.default_rng(5)
    xyz = torch.from_numpy(np.stack([
        synthetic_outdoor.outdoor_scene(rng, CP_N)[0][:, :3]
        for _ in range(HYBRID_B)])).to(PAR_DEVICE)
    feats = torch.from_numpy(rng.standard_normal(
        (HYBRID_B, CP_N, 1)).astype(np.float32)).to(PAR_DEVICE)
    mask = torch.ones(HYBRID_B, CP_N, dtype=torch.bool, device=PAR_DEVICE)
    mask[0, CP_N - CP_TAIL:] = False
    mask[1, CP_N - 3 * CP_TAIL:] = False
    query = xyz[:, :HYBRID_KNN_M].contiguous()
    torch.save({"xyz": xyz, "feats": feats, "mask": mask, "query": query},
               work / "hybrid.pt")
    inds = ops.furthest_point_sample(xyz, m.sa_npoints[0], mask=mask)
    new_xyz = ops.gather(xyz, inds)
    grouped, _, gmask = ops.query_and_group(
        xyz, new_xyz, m.sa_radii[0], m.sa_nsamples[0], features=feats,
        mask=mask, normalize_xyz=True, exact=True)
    new_mask = mask.gather(1, inds.long())
    gmask = gmask & new_mask[:, :, None]
    knn = ops.knn(query, xyz, HYBRID_KNN_K, support_mask=mask)
    return {"sa": [new_xyz, grouped, inds, gmask, new_mask], "knn": knn}


def entry_run(work: Path) -> dict:
    """python -m torch.distributed.run --standalone --nproc-per-node=1 -m
    tpu3dsad_torch.train on config #3 from 16 + 2 ScanNet-format scenes
    (2 steps of 8), NCCL: exit 0, the rank's line, 2 logged steps and the
    checkpoint."""
    root, ckpt = work / "entry_scenes", work / "entry_ckpt"
    synthetic_indoor.write_dataset(str(root), scenes=ENTRY_SCENES[0],
                                   val_scenes=ENTRY_SCENES[1],
                                   num_points=HOSTFED_RAW)
    args = ["model.name=detector", "data.name=scannet", f"data.root={root}",
            f"train.batch_size={TRAIN_B}", "train.num_epochs=1",
            "train.eval_every=2", "train.log_every=1",
            f"train.ckpt_dir={ckpt}"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=1", "-m", "tpu3dsad_torch.train", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    joined = [line for line in proc.stderr.splitlines()
              if line.startswith("rank 0 of 1: backend nccl")]
    steps = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{") and "train/loss" in line]
    if (not joined or [s["step"] for s in steps] != [1, 2]
            or not np.isfinite([s["train/loss"] for s in steps]).all()
            or not (ckpt / "ckpt_2.pt").exists()):
        raise AssertionError(f"torchrun: joined {joined}, steps {steps}, "
                             f"checkpoint {list(ckpt.glob('*'))}")
    print(f"  (e) torchrun --standalone --nproc-per-node=1 -m "
          f"tpu3dsad_torch.train: '{joined[0]}', 2 steps, losses "
          f"{[s['train/loss'] for s in steps]}, ckpt_2.pt")


def phase_parallel(work: Path) -> None:
    print(f"== parallelism on one card: {PAR_WORLD} ranks (DP, config #3 "
          f"{TRAIN_B} x {TRAIN_N}; CP, config #4's model on {CP_N} points) "
          f"and 4 (hybrid 2 x 2), backend {PAR_BACKEND} on CUDA tensors "
          f"(asked for by name: NCCL takes one rank a card); then torchrun "
          f"with NCCL")
    work.mkdir(parents=True)
    try:
        parallel_runs(work)
    finally:
        train_lib.apply_runtime_config(Config())


def parallel_runs(work: Path) -> None:
    one = dp_world_one(work)
    cp_one = cp_world_one(work)
    hy_one = hybrid_world_one(work)
    ranks = launch.spawn(par_rank, PAR_WORLD, backend=PAR_BACKEND,
                         device=PAR_DEVICE, args=(str(work),))

    # (a) DP training
    print(f"  (a) DP: {PAR_STEPS} steps, each from world 1's state before "
          "it; ranks hold their rows of its batch")
    for i, w in enumerate(one["steps"]):
        for rank, r in enumerate(ranks):
            s = r["dp"]["steps"][i]
            if s["counts"] != launches(fps=5, ball_query=7, scatter=9):
                raise AssertionError(f"rank {rank} step {i + 1}: launches "
                                     f"{s['counts']} != 5 / 7 / 9")
            rows = slice(rank * s["picks"].shape[0],
                         (rank + 1) * s["picks"].shape[0])
            flips = int((s["picks"] != w["picks"][rows]).sum())
            floor = one["floor"][i]
            if abs(s["loss"] - w["loss"]) > max(1e-5 * abs(w["loss"]),
                                                4 * floor["loss"]):
                raise AssertionError(
                    f"rank {rank} step {i + 1}: loss {s['loss']} vs world 1 "
                    f"{w['loss']} ({flips} proposal picks flipped; world 1 "
                    f"reversed: {floor['loss']:.3g} apart, "
                    f"{floor['flips']} flipped)")
            dist = l2_distance(s["grads"], {k: v.cpu() for k, v in
                                            w["grads"].items()})
            if dist > max(TRAIN_GRAD_L2, 4 * floor["grads"]):
                raise AssertionError(f"rank {rank} step {i + 1}: gradients "
                                     f"{dist:.3g} apart (L2, relative; the "
                                     f"floor {floor['grads']:.3g})")
            pdiff = max_diff(s["state"], {k: v.cpu() for k, v in
                                          w["state"].items()})
            if pdiff >= 2e-2:
                raise AssertionError(f"rank {rank} step {i + 1}: parameters "
                                     f"differ by {pdiff}")
        if any(not torch.equal(v, ranks[1]["dp"]["steps"][i]["state"][k])
               for k, v in ranks[0]["dp"]["steps"][i]["state"].items()):
            raise AssertionError(f"step {i + 1}: the ranks' states differ")
        flips = [int((r["dp"]["steps"][i]["picks"] != w["picks"][
            rank * TRAIN_B // PAR_WORLD:(rank + 1) * TRAIN_B // PAR_WORLD]
        ).sum()) for rank, r in enumerate(ranks)]
        print(f"  step {i + 1}: loss world 1 {w['loss']:.6f}, world 2 "
              f"{ranks[0]['dp']['steps'][i]['loss']:.6f} (rel "
              f"{abs(ranks[0]['dp']['steps'][i]['loss'] / w['loss'] - 1):.3g}"
              f"), proposal picks flipped {sum(flips)} of "
              f"{w['picks'].numel()}; train-mode gradients {dist:.3g} apart "
              f"(L2, relative); world 1 with its scenes reversed: loss "
              f"{floor['loss'] / abs(w['loss']):.3g} apart (rel), "
              f"{floor['flips']} picks flipped, gradients "
              f"{floor['grads']:.3g}; parameters within {pdiff:.3g}; the "
              "ranks' states bitwise equal; 5 / 7 / 9 launches a rank")
    for rank, r in enumerate(ranks):
        share, rel, worst = grads_close(
            f"rank {rank} eval-mode gradients", r["dp"]["eval_grads"],
            one["eval_grads"], EVAL_GRAD_BAR)
    print(f"  gradients with BatchNorm on its running statistics (step 1's "
          f"state and batch): max |world 2 - world 1| {worst:.3g}, "
          f"{rel:.3g} of a tensor's max, {share:.3f} of the bar")

    # (b) the sweep
    for rank, r in enumerate(ranks):
        got = r["sweep"]["metrics"]
        for k, v in one["sweep"].items():
            pairs = (v.items() if isinstance(v, dict) else [(None, v)])
            for c, want in pairs:
                have = got[k] if c is None else got[k][c]
                if want is not None and not np.isclose(have, want,
                                                       rtol=1e-5, atol=0):
                    raise AssertionError(f"rank {rank} sweep {k}/{c}: "
                                         f"{have} vs {want}")
    flat = {k: v for k, v in one["sweep"].items() if not isinstance(v, dict)}
    print(f"  (b) DP sweep of {PAR_SWEEP} batches: metrics within rtol 1e-5 "
          f"of world 1's on both ranks, per class too ({flat}); launches "
          f"rank 0 {ranks[0]['sweep']['counts']}")

    # (c) CP
    for rank, r in enumerate(ranks):
        c = r["cp"]
        for k in CP_KEYS:
            if (at := bits_differ(c["end_points"][k].float(),
                                  cp_one["end_points"][k].float().cpu())):
                raise AssertionError(f"CP rank {rank} {k} != unsharded {at}")
        picks = sum(cp_model_config().model.sa_npoints[:2])
        if c["collectives"] != picks + 2 * 3 or \
                c["fps_collectives"] != cp_model_config().model.sa_npoints[0]:
            raise AssertionError(f"CP rank {rank}: {c['collectives']} "
                                 f"collectives in the forward, "
                                 f"{c['fps_collectives']} in SA1's FPS")
    c = ranks[0]["cp"]
    npoint = cp_model_config().model.sa_npoints[0]
    print(f"  (c) CP forward at {CP_N} points, cp_stages=2: {CP_KEYS} "
          f"bitwise the unsharded forward on both ranks; one collective a "
          f"pick ({c['fps_collectives']} for SA1's {npoint} picks, the seed "
          f"included); launches a rank {c['counts']}, 2 of the B3 ones at "
          f"the sharded levels, on each rank's shard "
          f"{c['sharded_level_bq']}; world 1 {cp_one['counts']} (SA1's FPS "
          f"at B = 1 is B2)")

    # (d) hybrid
    hybrid = launch.spawn(hybrid_rank, 4, backend=PAR_BACKEND,
                          device=PAR_DEVICE, args=(str(work),))
    for rank, r in enumerate(hybrid):
        d, _ = r["coords"]
        for name, got, want in (
                [(f"sa[{j}]", g, w) for j, (g, w) in
                 enumerate(zip(r["sa"], hy_one["sa"]))]
                + [(f"knn[{j}]", g, w) for j, (g, w) in
                   enumerate(zip(r["knn"], hy_one["knn"]))]):
            want = want[d:d + 1].cpu()
            if got.dtype.is_floating_point:
                at = bits_differ(got, want)
                if at:
                    raise AssertionError(f"hybrid rank {rank} {name}: {at}")
            else:
                require_equal(f"hybrid rank {rank} {name}", got, want)
    print(f"  (d) hybrid 2 x 2 at B = {HYBRID_B} x {CP_N}: the SA1 stage and "
          f"kNN (k = {HYBRID_KNN_K} of {HYBRID_KNN_M}) bitwise the unsharded "
          f"ops on every rank; launches a rank {hybrid[0]['counts']}")

    entry_run(work)


# -------------------------------------------- phase 17: DP k-step blocks

# train.steps_per_call of phase 17's runs. On a data group of more than
# one rank a block runs its k steps eagerly (train_lib.DetectorTrainBlock:
# gloo's collectives go through the host, and a capture across NCCL ranks
# needs a card a rank); at world 1 it is the captured step of phase 12.
# Ranks as in phase 16: PAR_WORLD processes on cuda:0, gloo on CUDA
# tensors, config #3 at 8 x 40960 in fp32.
DPK = 4
# no sweep in phase 17's runs; the packed run takes run B's options
DPK_ARGS = ("train.eval_every=10", *PAR_FP32)
DPK_PACKED = ("data.name=packed", "data.use_color=true",
              "data.device_augment=true", "data.compact_votes=true",
              *DPK_ARGS)


def dpk_config(ckpt_dir: str, k: int, epochs: int = 1) -> Config:
    """Phase 16's config #3 (par_config: device synth, 8 x 40960, fp32,
    8 steps an epoch) at train.steps_per_call=k, `epochs` epochs, no
    sweep."""
    cfg = par_config(ckpt_dir)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_call=k, num_epochs=epochs, eval_every=10))


def step_counts(steps: int) -> dict:
    """The launches of `steps` config-#3 train steps: 5 / 7 / 9 each."""
    return launches(fps=5 * steps, ball_query=7 * steps, scatter=9 * steps)


def dpk_run(cfg, steps: int) -> dict:
    """run_detector(cfg) on this rank with its counts from 0, which must
    show `steps` eager steps (5 / 7 / 9 each), and finite losses; its JSON
    rows (rank 0 alone prints them) and its lines on stderr. The ranks
    meet at its end, so that none reads a checkpoint before rank 0 has
    written it."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = run_detector(cfg)
    torch.cuda.synchronize()
    got = counts()
    torch.distributed.barrier()
    losses = [h["loss"] for h in result.history]
    if (got != step_counts(steps) or len(losses) != steps
            or not np.isfinite(losses).all()):
        raise AssertionError(f"{cfg.train.ckpt_dir}: launches {got}, "
                             f"losses {losses} (want {steps} steps)")
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    return {"result": result,
            "logged": [r["step"] for r in rows if "train/loss" in r],
            "block": [line for line in err.getvalue().splitlines()
                      if line.startswith("train block")]}


def run_state(run: dict) -> dict:
    r = run["result"]
    return trained_state([h["loss"] for h in r.history], r.model,
                         r.optimizer)


def dpk_synth(rank: int, work: Path) -> dict:
    """(a) The card's synthetic feed: run_detector for TRAIN_STEPS steps at
    k = DPK and at 1 from one seed, bitwise equal; each then resumed from
    its checkpoint for a second epoch, again bitwise equal."""
    runs, resumed = {}, {}
    for k in (DPK, 1):
        runs[k] = dpk_run(dpk_config(str(work / f"synth_{k}"), k),
                          TRAIN_STEPS)
    require_bitwise(f"rank {rank}: k={DPK} vs k=1 on the synthetic feed",
                    run_state(runs[DPK]), run_state(runs[1]))
    for k in (DPK, 1):
        resumed[k] = dpk_run(dpk_config(str(work / f"synth_{k}"), k, 2),
                             TRAIN_STEPS)
        start = resumed[k]["result"].start_step
        if start != TRAIN_STEPS:
            raise AssertionError(f"rank {rank}: k={k} resumed from {start}")
    require_bitwise(f"rank {rank}: k={DPK} vs k=1 resumed from ckpt_"
                    f"{TRAIN_STEPS}.pt", run_state(resumed[DPK]),
                    run_state(resumed[1]))
    return {"losses": [h["loss"] for h in runs[DPK]["result"].history],
            "logged": runs[DPK]["logged"] + resumed[DPK]["logged"],
            "block": runs[DPK]["block"],
            "ckpts": sorted(p.name for p in (work / f"synth_{DPK}").iterdir())}


def dpk_packed(rank: int, mesh, work: Path, packed: str) -> dict:
    """(b) The stacked host feed on phase 10's packed split: run_detector
    at k = DPK for one epoch; each rank's stacked blocks hold its rows on
    axis 1 of the global draw; 2 blocks through a block built apart,
    bitwise 2 x DPK eager DP steps on the same slices (rank 0 records the
    first step's kernel inputs)."""
    cfg = hostfed_config(packed, str(work / "packed_run"), *DPK_PACKED,
                         f"train.steps_per_call={DPK}")
    dpk_run(cfg, TRAIN_STEPS)

    dataset = get_dataset(cfg)
    rng = np.random.default_rng(5)
    draws = []
    for _ in range(2):
        flat = dataset.train_batch(rng, DPK * TRAIN_B)
        draws.append({n: v.reshape((DPK, TRAIN_B) + v.shape[1:])
                      for n, v in flat.items()})
    blocks = list(device_prefetch(iter(draws), "cuda", mesh=mesh,
                                  stacked=True))
    rows = slice(rank * TRAIN_B // PAR_WORLD,
                 (rank + 1) * TRAIN_B // PAR_WORLD)
    for i, (mine, whole) in enumerate(zip(blocks, draws)):
        for n, v in whole.items():
            if not np.array_equal(mine[n].cpu().numpy(), v[:, rows]):
                raise AssertionError(f"rank {rank} block {i} {n}: not its "
                                     "rows on axis 1 of the global draw")

    train = dataclasses.replace(cfg.train, lr_decay_steps=(1,),
                                lr_decay_rates=(0.5,))
    bn_ms = [train_lib.bn_momentum_at(train, 20 * i) for i in range(2)]
    source = dataset.source_dataset
    got, recorded = {}, None
    for blocked in (True, False):
        model = build_detector(cfg, dataset.mean_sizes)
        optimizer = train_lib.make_optimizer(train, DPK, model.parameters(),
                                             train_lib.data_axis(mesh))
        gen = torch.Generator(device="cuda").manual_seed(9)
        torch.cuda.synchronize()
        reset_counts()
        if blocked:
            block = train_lib.make_detector_train_block(
                model, optimizer, cfg, DPK, source)
            if block.mode != "eager":
                raise AssertionError(f"rank {rank}: block mode {block.mode}")
            losses = torch.cat([block(b, gen, m)["loss"]
                                for b, m in zip(blocks, bn_ms)])
        else:
            step = train_lib.make_detector_steps(model, optimizer, cfg,
                                                 source)
            losses = []
            for j, (b, m) in enumerate(zip(blocks, bn_ms)):
                for i in range(DPK):
                    record = (recording() if rank == 0 and i == j == 0
                              else contextlib.nullcontext())
                    with record as calls:
                        losses.append(step({n: v[i] for n, v in b.items()},
                                           gen, m)["loss"])
                    recorded = calls if calls is not None else recorded
            losses = torch.stack(losses)
        torch.cuda.synchronize()
        if counts() != step_counts(2 * DPK):
            raise AssertionError(f"rank {rank}: {counts()} launches for 2 "
                                 f"blocks ({'block' if blocked else 'eager'})")
        got[blocked] = trained_state(losses, model, optimizer)
        del model, optimizer
    require_bitwise(f"rank {rank}: 2 packed blocks vs {2 * DPK} eager DP "
                    "steps", got[True], got[False])
    if recorded is not None:
        compare_recorded("rank 0, DP k-block path, step 1 (packed, "
                         f"{TRAIN_B // PAR_WORLD} scenes)", recorded,
                         torch.Generator(device="cuda").manual_seed(3))
    return {"losses": got[True]["loss"].tolist(), "bn_ms": bn_ms}


def dpk_rank(rank: int, world: int, work: str, packed: str) -> dict:
    """Phase 17 (a) and (b) on one rank of PAR_WORLD."""
    work = Path(work)
    torch.cuda.set_device(0)
    mesh = make_mesh((-1,), ("data",))
    return {"synth": dpk_synth(rank, work),
            "packed": dpk_packed(rank, mesh, work, packed)}


@contextlib.contextmanager
def scenes_reversed():
    """run_detector's device-synth batches with their scenes in reverse
    order: the same sums in another order."""
    draw = train_detector.synthetic_detection_batch
    train_detector.synthetic_detection_batch = lambda *a, **kw: {
        n: v.flip(0) for n, v in draw(*a, **kw).items()}
    try:
        yield
    finally:
        train_detector.synthetic_detection_batch = draw


def world_one_run(cfg) -> dict:
    """run_detector(cfg) at world 1 and k = DPK: a warm-up block, the
    capture, then replayed blocks. The counters see the warm-up's steps
    and the captured one."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = run_detector(cfg)
    torch.cuda.synchronize()
    if counts() != step_counts(DPK + 1):
        raise AssertionError(f"{cfg.train.ckpt_dir}: launches {counts()}")
    mode = [line for line in err.getvalue().splitlines()
            if line.startswith("train block")]
    if mode != [f"train block: graph (one step captured, replayed {DPK} "
                "times a call)"]:
        raise AssertionError(f"world 1 block: {mode}")
    return {"losses": [h["loss"] for h in result.history],
            "mode": mode[0], "counts": counts()}


def dpk_world_one(work: Path) -> dict:
    """(c) World 1 at k = DPK on the synthetic feed from the same seed, 2
    epochs; then one epoch with each batch's scenes reversed, the witness
    of how far fp32 sums in another order alone take a run from world 1,
    step by step (its step 1 is phase 16's floor)."""
    one = world_one_run(dpk_config(str(work / "world1"), DPK, 2))
    with scenes_reversed():
        rev = world_one_run(dpk_config(str(work / "world1_reversed"), DPK))
    return one | {"reversed": rev["losses"]}


def phase_parallel_k(work: Path, packed: Path) -> None:
    print(f"== DP k-step blocks: run_detector at train.steps_per_call={DPK} "
          f"on {PAR_WORLD} ranks ({PAR_BACKEND} on CUDA tensors, every rank "
          f"on cuda:0), config #3 at {TRAIN_B} x {TRAIN_N} in fp32: eager "
          "blocks on the data group; world 1's captured block beside it")
    work.mkdir(parents=True)
    try:
        parallel_k_runs(work, packed)
    finally:
        train_lib.apply_runtime_config(Config())


def parallel_k_runs(work: Path, packed: Path) -> None:
    ranks = launch.spawn(dpk_rank, PAR_WORLD, backend=PAR_BACKEND,
                         device=PAR_DEVICE, args=(str(work), str(packed)))
    one = dpk_world_one(work)

    # (a) the card's synthetic feed
    lead = ranks[0]["synth"]
    if lead["block"] != [f"train block: eager (data group of {PAR_WORLD} "
                         "ranks)"] or ranks[1]["synth"]["block"]:
        raise AssertionError(f"block mode lines: rank 0 {lead['block']}, "
                             f"rank 1 {ranks[1]['synth']['block']}")
    if lead["logged"] != [4, 8, 12, 16] or ranks[1]["synth"]["logged"]:
        raise AssertionError(f"log rows: rank 0 {lead['logged']}, rank 1 "
                             f"{ranks[1]['synth']['logged']}")
    if lead["ckpts"] != ["ckpt_16.pt", "ckpt_8.pt", "train_meta.json"]:
        raise AssertionError(f"checkpoint directory: {lead['ckpts']}")
    if lead["losses"] != ranks[1]["synth"]["losses"]:
        raise AssertionError("the ranks' losses differ")
    print(f"  (a) synthetic feed, {TRAIN_STEPS} steps at k={DPK} and k=1 "
          f"on each rank: block mode eager on the data group (rank 0: "
          f"'{lead['block'][0]}'), {DPK * 5} / {DPK * 7} / {DPK * 9} "
          f"launches a block a rank; k={DPK} bitwise k=1 (losses, "
          "parameters, BN statistics, moments, count); each resumed from "
          f"ckpt_{TRAIN_STEPS}.pt for {TRAIN_STEPS} more steps, bitwise "
          f"again; rank 0 alone logged (steps {lead['logged']}) and wrote "
          f"{lead['ckpts']}")

    # (b) the stacked host feed
    for rank, r in enumerate(ranks):
        p = r["packed"]
        if not np.isfinite(p["losses"]).all():
            raise AssertionError(f"rank {rank}: packed losses {p['losses']}")
    p = ranks[0]["packed"]
    print(f"  (b) packed split (phase 10), stacked [{DPK}, {TRAIN_B}, ...] "
          f"blocks, augmentation on the card: run_detector {TRAIN_STEPS} "
          f"steps, {DPK * 5} / {DPK * 7} / {DPK * 9} launches a block a "
          "rank; each rank's blocks hold its rows on axis 1 of the global "
          f"draw; 2 blocks built apart (BN momentum {p['bn_ms']}, the rate "
          f"halved after step {DPK}) bitwise {2 * DPK} eager DP steps on "
          f"the same slices, losses {[round(v, 4) for v in p['losses']]}")

    # (c) world 1's captured block; step 1 held as phase 16 holds a step,
    # steps 2-8 beside world 1 with its scenes reversed, with no bar
    w1 = one["losses"][:TRAIN_STEPS]
    w2, rev = lead["losses"], one["reversed"]
    floor = abs(rev[0] - w1[0])
    if abs(w2[0] - w1[0]) > max(1e-5 * abs(w1[0]), 4 * floor):
        raise AssertionError(
            f"step 1: world 2 {w2[0]} vs world 1 {w1[0]} (world 1 with its "
            f"scenes reversed: {floor:.3g} apart)")
    gap2 = [abs(a / b - 1) for a, b in zip(w2, w1)]
    gap_rev = [abs(a / b - 1) for a, b in zip(rev, w1)]
    print(f"  (c) world 1 at k={DPK} ('{one['mode']}'; launches "
          f"{one['counts']}, the warm-up block and the capture): step 1 "
          f"loss {w1[0]:.6f} against world 2's {w2[0]:.6f} (rel "
          f"{gap2[0]:.3g}; the bar rtol 1e-5, or 4 x world 1's distance "
          f"with its scenes reversed, {floor / abs(w1[0]):.3g} rel); steps "
          f"1-{TRAIN_STEPS}, no bar after step 1: world 1 "
          f"{[round(v, 4) for v in w1]}, world 2 {[round(v, 4) for v in w2]}"
          f", world 1 with each batch's scenes reversed "
          f"{[round(v, 4) for v in rev]}; relative gap to world 1 by step: "
          f"world 2 {[float(f'{g:.3g}') for g in gap2]} (most {max(gap2):.3g}"
          f"), reversed {[float(f'{g:.3g}') for g in gap_rev]} (most "
          f"{max(gap_rev):.3g})")


# phase 18: recipe R1 of chip_recipes.py (the 18-class host-synthetic
# recipe of docs/experiments/r3_18cls_votefactor3.jsonl) for its first
# RECIPE_EPOCHS epochs through run_detector, at train.seed=RECIPE_SEED
# (chip_recipes.py's full runs have seeds 0 and 1), the eval at epoch 49.
# Its gate: finite losses and mAP@0.25 >= half the reference's 0.2352 there
RECIPE_EPOCHS, RECIPE_SEED, RECIPE_GATE = 50, 2, 0.118
RECIPE_VAL_BATCHES = 4  # the synthetic val set


def phase_recipe(work: Path) -> None:
    recipe = chip_recipes.RECIPES["R1"]
    steps = RECIPE_EPOCHS * recipe.steps_per_epoch
    print(f"== recipe R1 ({recipe.name}, {recipe.reference}): the first "
          f"{RECIPE_EPOCHS} epochs ({steps} steps) through run_detector at "
          f"train.seed={RECIPE_SEED}, the eval at epoch {RECIPE_EPOCHS - 1}")
    cfg = parse_cli([*chip_recipes.leg_argv(recipe, 0, "", str(work),
                                            RECIPE_SEED),
                     f"train.num_epochs={RECIPE_EPOCHS}"])
    reset_counts()
    result = run_detector(cfg)
    got = counts()
    want = launches(fps=5 * (steps + RECIPE_VAL_BATCHES),
                    ball_query=7 * (steps + RECIPE_VAL_BATCHES),
                    scatter=9 * steps, nms=RECIPE_VAL_BATCHES)
    print(f"  launches: {got}")
    if got != want:
        raise AssertionError(f"recipe R1: launches {got} != {want}")
    losses = [h["loss"] for h in result.history]
    if result.step != steps or not np.isfinite(losses).all():
        raise AssertionError(f"recipe R1: {result.step} steps, all losses "
                             f"finite: {np.isfinite(losses).all()}")
    (ev,) = result.evals
    reference = chip_recipes.read_jsonl(chip_recipes.REFERENCE_DIR
                                        / recipe.reference)
    ref_loss = {r["step"]: r["train/loss"] for r in reference
                if "train/loss" in r and r["step"] <= steps}
    ref_map = chip_recipes.evals_by_epoch(reference)[RECIPE_EPOCHS - 1]
    print("  train/loss at the reference's logged steps, port / reference: "
          + ", ".join(f"{s}: {losses[s - 1]:.4f} / {v:.4f}"
                      for s, v in sorted(ref_loss.items())))
    print(f"  epoch {ev['epoch']}: mAP@0.25 {ev['mAP@0.25']} against the "
          f"reference's {ref_map['eval/mAP@0.25']} (gate {RECIPE_GATE}), "
          f"mAP@0.5 {ev['mAP@0.5']} / {ref_map['eval/mAP@0.5']}, AR@0.25 "
          f"{ev['AR@0.25']} / {ref_map['eval/AR@0.25']}, val_loss "
          f"{ev['val_loss']} / {ref_map['eval/val_loss']}")
    if ev["epoch"] != RECIPE_EPOCHS - 1 or not ev["mAP@0.25"] >= RECIPE_GATE:
        raise AssertionError(f"recipe R1: eval {ev['epoch']} mAP@0.25 "
                             f"{ev['mAP@0.25']} < {RECIPE_GATE}")

    # one step of the trained model on a host batch, its launches recorded
    # and held to the plain versions (path recipe)
    dataset = get_dataset(cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in dataset.train_batch(
        np.random.default_rng(RECIPE_SEED), cfg.train.batch_size).items()}
    model = result.model
    with recording() as calls:
        grads_of(model, cfg, copy.deepcopy(model.state_dict()), batch,
                 train_lib.bn_momentum_at(cfg.train, RECIPE_EPOCHS))
    found = {k: len(v) for k, v in calls.items()}
    if found != {"fps": 5, "ball_query": 7, "scatter": 9, "three_nn": 2,
                 "nms": 0}:
        raise AssertionError(f"one recipe step made {found} calls")
    gen = torch.Generator(device="cuda").manual_seed(18)
    fps_names = ["sa1", "sa2", "sa3", "sa4", "proposal"]
    bq_names = ["sa1", "sa2", "sa3", "sa4"] + [
        f"bank_{r:g}" for r in cfg.model.cluster_radius_bank]
    for name, (args, kw) in zip(fps_names, calls["fps"]):
        fps_case("recipe", name, args[0], args[1], kw.get("mask"),
                 compares=3)
    for name, (args, kw) in zip(bq_names, calls["ball_query"]):
        bq_case("recipe", name, *args, kw.get("mask"))
    for args, _ in calls["scatter"]:
        scatter_case("recipe", *args, gen)


def ffps_input(kind: str, b: int, n: int, d: int, gen):
    """(points [b, n, d], mask [b, n] or None) of one feature-FPS case of
    FFPS_CASES on gen's device: "cell" xyz over 40 m and ReLU features, as
    an SA level's input; "normal" and the masked kinds standard normal
    values; "tail" the last 300 points of each cloud masked; "slices" every
    other 512-point block masked (whole CTA slices at SA2's plans); "grid"
    integers 0-2 (ties everywhere); "all" every point masked."""
    dev = gen.device
    if kind == "cell":
        xyz = torch.rand(b, n, 3, generator=gen, device=dev) * 40
        feats = torch.relu(torch.randn(b, n, d - 3, generator=gen,
                                       device=dev))
        return torch.cat([xyz, feats], -1), None
    if kind == "grid":
        x = torch.randint(0, 3, (b, n, d), generator=gen, device=dev).float()
    else:
        x = torch.randn(b, n, d, generator=gen, device=dev)
    at = torch.arange(n, device=dev)[None].expand(b, n)
    mask = {"tail": at < n - 300, "slices": (at // 512) % 2 == 0,
            "all": torch.zeros(b, n, dtype=torch.bool, device=dev)}.get(kind)
    return x, mask


def ssd3d_scans(seed: int):
    """(points [B,N,3], intensity [B,N,1], mask [B,N]) on the card: 3DSSD's
    request of SSD3D_B scans of SSD3D_N points over KITTI's front range
    (x 0-70 m, y +-40 m, z -3-1 m); scan 1 is a quarter padding."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -40, -3], [70, 40, 1],
                      (SSD3D_B, SSD3D_N, 3)).astype(np.float32)
    feats = rng.random((SSD3D_B, SSD3D_N, 1)).astype(np.float32)
    mask = np.ones((SSD3D_B, SSD3D_N), bool)
    mask[1, SSD3D_N * 3 // 4:] = False
    return tuple(torch.from_numpy(v).cuda() for v in (pts, feats, mask))


def phase_ssd3d() -> None:
    """Phase 19: the feature-FPS kernel against the plain op, then 3DSSD
    served as its cell serves it."""
    print(f"== feature FPS kernel (csrc/ffps.cu) vs the plain op (exact "
          f"picks, {COMPARES} launches each)")
    gen = torch.Generator(device="cuda").manual_seed(24)
    for name, b, n, d, m, kind in FFPS_CASES:
        x, mask = ffps_input(kind, b, n, d, gen)
        want = plain_ffps(x, m, mask)
        for _ in range(COMPARES):
            require_equal(f"ffps {name}", cuda_ffps.feature_fps(x, m, mask),
                          want)
        print(f"  {name:12s} [{b},{n},{d}]->{m}: launched "
              f"{tuple(cuda_ffps.last_plan)}, equal in {COMPARES} launches")

    print(f"== 3DSSD (preset=3dssd) serving 1 warm-up + {SSD3D_REQUESTS} "
          f"requests of {SSD3D_B} scans x {SSD3D_N} points")
    cfg = parse_cli(["preset=3dssd", f"train.batch_size={SSD3D_B}"])
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg)
    points, feats, mask = ssd3d_scans(0)
    with torch.no_grad():  # BatchNorm calibrated as the cell's set-up does
        model.train()
        model(points, feats, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = build_inference_fn(cfg, model, model.mean_sizes,
                               with_features=True)
    infer(points, mask, feats)
    batches = [ssd3d_scans(seed) for seed in range(1, SSD3D_REQUESTS + 1)]
    reset_counts()
    outs = [infer(p, k, f) for p, f, k in batches]
    served = counts()
    print(f"  launches: {served}")
    want = launches(**{k: v * SSD3D_REQUESTS
                       for k, v in SSD3D_REQUEST.items()})
    if served != want:
        raise AssertionError(f"3DSSD launches {served} != {want}")
    P = cfg.model.ssd3d_npoints[-1][0]
    limit = cfg.model.ssd3d_max_output
    for out in outs:
        for key, value in out.items():
            if value.shape[:2] != (SSD3D_B, P):
                raise AssertionError(f"{key}: {tuple(value.shape)}")
            if value.is_floating_point() and not value.isfinite().all():
                raise AssertionError(f"{key}: non-finite values")
        if (out["keep"].sum(1) > limit).any():
            raise AssertionError(f"more than {limit} boxes kept a scan")
    kept = [out["keep"].sum(1).tolist() for out in outs]
    print(f"  outputs finite, shapes ok; boxes kept a scan: {kept}")

    p, f, k = batches[0]
    with ops.use_impl("plain"):
        plain = infer(p, k, f)
    if counts() != served:
        raise AssertionError("the plain rerun launched a kernel")
    for key in ("keep", "sem_cls"):
        require_equal(f"3DSSD {key} (kernel path vs plain path)",
                      outs[0][key], plain[key])
    dc = (outs[0]["center"] - plain["center"]).abs().max().item()
    print(f"  plain-ops rerun of request 0: keep and sem_cls identical, "
          f"center max |diff| {dc:.3g}")


def cell_config(name: str) -> Config:
    """The port's Config of portbench/configs/<name>.json, as the
    benchmark's harness reads it."""
    from types import SimpleNamespace

    from portbench.harness import Context

    path = Path(__file__).resolve().parent / "portbench" / "configs"
    spec = json.loads((path / f"{name}.json").read_text())
    return Context.port_config(SimpleNamespace(config=spec))


def served_request(cfg, b: int, seed: int):
    """(infer, args): the model of cfg with seeded weights on the card,
    BatchNorm calibrated on its first batch as the cells' set-up does, and
    one request of b scenes of cfg.data.num_points points over KITTI's
    front range (the last eighth of scene 0 padding; 3DSSD's intensity)."""
    model = build_detector(cfg)
    n = cfg.data.num_points
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.tensor([0.0, -30.0, -3.0], device="cuda")
    span = torch.tensor([60.0, 60.0, 4.0], device="cuda")
    pts = torch.rand(b, n, 3, device="cuda", generator=gen) * span + lo
    mask = torch.ones(b, n, dtype=torch.bool, device="cuda")
    mask[0, n - n // 8:] = False
    feats = cfg.model.name == "ssd3d"
    extra = ((torch.rand(b, n, 1, device="cuda", generator=gen),)
             if feats else ())
    with torch.no_grad():
        model.train()
        model(pts, *extra, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = build_inference_fn(cfg, model, model.mean_sizes,
                               with_features=feats)
    return infer, (pts, mask, *extra)


def phase_bn_relu() -> None:
    """Phase 20: the BatchNorm + ReLU kernel against the plain chain on
    every layer of a served request of each configuration, the request's
    launches, and its outputs against the request with the chain in the
    kernel's place."""
    print("== eval-mode BatchNorm + ReLU kernel (csrc/bn_relu.cu) vs the "
          "plain chain, every layer of a served request (bitwise)")
    sound = library.bn_relu
    for name, b in BN_RELU_SERVED:
        cfg = cell_config(name)
        train_lib.apply_runtime_config(cfg)
        infer, args = served_request(cfg, b, seed=20)
        infer(*args)  # warm-up
        torch.cuda.synchronize()
        layers = []

        def checked(*a):
            y = sound(*a)
            where = bits_differ(y, plain_bn_relu(*a))
            if where:
                raise AssertionError(f"{name} B = {b}, layer {len(layers)} "
                                     f"{tuple(a[0].shape)}: kernel != "
                                     f"chain {where}")
            layers.append(a[0].numel())
            return y

        reset_counts()
        before = cuda_bn_relu.launches
        library.bn_relu = checked
        try:
            got = infer(*args)
        finally:
            library.bn_relu = sound
        served = {k: v for k, v in counts().items() if v}
        served["bn_relu"] = cuda_bn_relu.launches - before
        want = BN_RELU_REQUEST["ssd3d" if cfg.model.name == "ssd3d"
                               else "sadet"]
        if served["bn_relu"] != want or len(layers) != want:
            raise AssertionError(f"{name} B = {b}: {served['bn_relu']} "
                                 f"launches, {len(layers)} layers, not "
                                 f"{want}")
        library.bn_relu = plain_bn_relu
        try:
            chained = infer(*args)
        finally:
            library.bn_relu = sound
        if cuda_bn_relu.launches - before != want:
            raise AssertionError("the chain's rerun launched the kernel")
        for key, value in chained.items():
            if value.is_floating_point():
                where = bits_differ(got[key], value)
                if where:
                    raise AssertionError(f"{name} B = {b} {key}: {where}")
            else:
                require_equal(f"{name} B = {b} {key}", got[key], value)
        print(f"  {name} B = {b}: launches a request {served}; every "
              f"layer bitwise the chain ({sum(layers) / 1e6:.1f} M "
              f"activations); outputs bitwise the chain's request")
        del infer, args, got, chained
        torch.cuda.empty_cache()
    train_lib.apply_runtime_config(Config())


def box_points_input(kind: str, b: int, n: int, p: int, gen):
    """(points [b, n, 3], centers and sizes [b, p, 3], mask [b, n] or None)
    of one point-count case of BOX_POINTS_CASES on gen's device: "rooms"
    the cell's indoor rooms (the frozen generator's, 50000 points padded
    to n) with boxes over the room of up to 2 m; the other kinds points
    over [-3, 3) with boxes of -0.25 to 2.25 m (some empty by their
    negative size); "faces" the first six points of each cloud exactly on
    the six faces of its first box; "tail" the last quarter masked; "all"
    every point masked."""
    dev = gen.device
    if kind == "rooms":
        from portbench.traffic.indoor import indoor_scene, padded

        rng = np.random.default_rng(21)
        rooms = [padded(indoor_scene(rng, GROUPFREE_POINTS), n)
                 for _ in range(b)]
        pts = torch.from_numpy(np.stack([r[0] for r in rooms])).to(dev)
        mask = torch.from_numpy(np.stack([r[1] for r in rooms])).to(dev)
        centers = torch.rand(b, p, 3, generator=gen, device=dev) * 6 - 3
        sizes = torch.rand(b, p, 3, generator=gen, device=dev) * 2
        return pts, centers, sizes, mask
    pts = torch.rand(b, n, 3, generator=gen, device=dev) * 6 - 3
    centers = torch.rand(b, p, 3, generator=gen, device=dev) * 6 - 3
    sizes = torch.rand(b, p, 3, generator=gen, device=dev) * 2.5 - 0.25
    if kind == "faces":
        half = sizes[:, 0] * 0.5
        for i, (axis, sign) in enumerate([(0, 1), (0, -1), (1, 1), (1, -1),
                                          (2, 1), (2, -1)]):
            pts[:, i] = centers[:, 0]
            pts[:, i, axis] += sign * half[:, axis]
    at = torch.arange(n, device=dev)[None].expand(b, n)
    mask = {"tail": at < n * 3 // 4,
            "all": torch.zeros(b, n, dtype=torch.bool, device=dev)}.get(kind)
    return pts, centers, sizes, mask


def groupfree_rooms(seed: int):
    """(points [B,N,3], mask [B,N]) on the card: a request of the cell's
    rooms (GROUPFREE_POINTS points of the frozen generator, padded to
    GROUPFREE_N)."""
    from portbench.traffic.indoor import indoor_scene, padded

    rng = np.random.default_rng(seed)
    rooms = [padded(indoor_scene(rng, GROUPFREE_POINTS), GROUPFREE_N)
             for _ in range(GROUPFREE_B)]
    return (torch.from_numpy(np.stack([r[0] for r in rooms])).cuda(),
            torch.from_numpy(np.stack([r[1] for r in rooms])).cuda())


def phase_groupfree() -> None:
    """Phase 21: the point-count kernel against the plain op, then Group-Free
    3D served as its cell serves it."""
    print(f"== box point-count kernel (csrc/box_points.cu) vs the plain op "
          f"(exact counts, {COMPARES} launches each)")
    gen = torch.Generator(device="cuda").manual_seed(21)
    for name, b, n, p, kind in BOX_POINTS_CASES:
        pts, centers, sizes, mask = box_points_input(kind, b, n, p, gen)
        want = plain_box_points(pts, centers, sizes, mask)
        for _ in range(COMPARES):
            require_equal(f"box_points {name}", cuda_box_points.box_points(
                pts, centers, sizes, mask), want)
        print(f"  {name:10s} [{b},{n}] x {p}: equal in {COMPARES} launches, "
              f"{int(want.sum())} points in boxes")
        del pts, centers, sizes, mask, want
    torch.cuda.empty_cache()

    print(f"== Group-Free 3D (preset=groupfree3d) serving 1 warm-up + "
          f"{GROUPFREE_REQUESTS} requests of {GROUPFREE_B} rooms x "
          f"{GROUPFREE_N} points")
    cfg = parse_cli(["preset=groupfree3d",
                     f"train.batch_size={GROUPFREE_B}"])
    train_lib.apply_runtime_config(cfg)
    model = build_detector(cfg)
    points, mask = groupfree_rooms(0)
    with torch.no_grad():  # BatchNorm calibrated as the cell's set-up does
        model.train()
        model(points, mask=mask, bn_momentum=0.0)
        model.eval()
    infer = build_inference_fn(cfg, model, model.mean_sizes)
    infer(points, mask)
    batches = [groupfree_rooms(seed)
               for seed in range(1, GROUPFREE_REQUESTS + 1)]
    reset_counts()
    outs = [infer(p, k) for p, k in batches]
    served = counts()
    print(f"  launches: {served}")
    want = launches(**{k: v * GROUPFREE_REQUESTS
                       for k, v in GROUPFREE_REQUEST.items()})
    if served != want:
        raise AssertionError(f"Group-Free launches {served} != {want}")
    P = cfg.model.groupfree_stages * cfg.model.groupfree_candidates
    for out in outs:
        for key, value in out.items():
            if value.shape[:2] != (GROUPFREE_B, P):
                raise AssertionError(f"{key}: {tuple(value.shape)}")
            if value.is_floating_point() and not value.isfinite().all():
                raise AssertionError(f"{key}: non-finite values")
    kept = [out["keep"].sum(1).tolist() for out in outs]
    print(f"  outputs finite, shapes ok; boxes kept a room: {kept}")

    p, k = batches[0]
    with ops.use_impl("plain"):
        plain = infer(p, k)
    if counts() != served:
        raise AssertionError("the plain rerun launched a kernel")
    for key in ("keep", "sem_cls"):
        require_equal(f"Group-Free {key} (kernel path vs plain path)",
                      outs[0][key], plain[key])
    dc = (outs[0]["center"] - plain["center"]).abs().max().item()
    print(f"  plain-ops rerun of request 0: keep and sem_cls identical, "
          f"center max |diff| {dc:.3g}")

    again = [infer(p, k) for p, k in batches]
    for out, want in zip(again, outs):
        for key, value in want.items():
            where = (bits_differ(out[key], value)
                     if value.is_floating_point() else None)
            if where:
                raise AssertionError(f"served again, {key}: {where}")
            if not value.is_floating_point():
                require_equal(f"served again, {key}", out[key], value)
    print(f"  the {GROUPFREE_REQUESTS} requests served again: every field "
          f"bitwise the first serve's")
    train_lib.apply_runtime_config(Config())


def main() -> None:
    laps, t0 = {}, time.perf_counter()

    def lap(phase: str) -> None:
        """Record the seconds since the last phase ended."""
        laps[phase] = time.perf_counter() - t0 - sum(laps.values())

    phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    work = Path(tempfile.mkdtemp(prefix="tpu3dsad_torch_outdoor_"))
    try:
        outdoor = prepare_outdoor(work)
        train_calls = capture_train_step(gen)
        eval_loads, eval_calls = capture_eval_batch(outdoor)
        serve_calls = capture_request()
        lap("1")
        phase_fps(gen, train_calls, eval_calls)
        lap("2")
        phase_ball_query(gen, serve_calls, train_calls, eval_calls)
        lap("3")
        phase_serve()
        phase_nms(serve_calls, eval_calls)
        lap("4")
        phase_scatter(gen, train_calls)
        lap("5")
        nn_calls = train_calls["three_nn"]
        train_sa1 = train_calls["ball_query"][0]
        serve_sa1 = serve_calls["ball_query"][0]
        del serve_calls
        del train_calls  # keep the recorded tensors out of training's peak
        phase_train(gen, nn_calls)
        lap("6")
        phase_fps_flat(gen, eval_loads["fps"][0])
        lap("7")
        del eval_loads
        phase_sorted(gen, eval_calls, serve_sa1, train_sa1)
        lap("8")
        phase_eval(outdoor)
        lap("9")
        phase_hostfed(work / "hostfed")
        lap("10")
        phase_outdoor_train()
        lap("11")
        phase_train_k(work / "hostfed")
        lap("12")
        phase_classify(work / "classify")
        lap("13")
        phase_serve_export(work / "export")
        lap("14")
        phase_from_raw(gen, work / "raw")
        lap("15")
        phase_parallel(work / "parallel")
        lap("16")
        phase_parallel_k(work / "parallel_k", work / "hostfed" / "packed")
        lap("17")
        phase_recipe(work / "recipe")
        lap("18")
        phase_ssd3d()
        lap("19")
        phase_bn_relu()
        lap("20")
        phase_groupfree()
        lap("21")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    jax_side = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu3dsad")]
    if jax_side:
        raise AssertionError(f"the port imported JAX or its package: "
                             f"{jax_side}")
    print("seconds by phase (1: the build and the recordings): " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items())
          + f"; in all {time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
