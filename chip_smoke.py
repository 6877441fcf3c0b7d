#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile] [--probe]

Phases (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every hand-written kernel from ``minddet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it, with its time (CUDA events, warm L2), the plain
   version's time and the memory/compute bound (at the train batch the
   median of 5 windows of 10 calls): the sampler forward (K1f) at batch 16
   in f32 and bf16 and at batch 1 and the train batch 128 in bf16, with the
   share of its corners that took the global fallback and its shared
   memory per block, and its backward (K1b) in f32 and bf16, also at
   integer coordinates (spread 0, a DCN layer with zero offsets); the
   rotated-box intersection (K4) in f32 at the rotated NMS's (B, 900,
   5)^2, B = 1 and 8 (PointPillars), and (6 B, 1000, 5)^2, B = 1 and 4
   (CenterPoint's six tasks stacked), on boxes drawn like decoded
   candidates, at the train
   step's (8, 128, 5) proposals x (8, 64, 5) ground-truth slots (a quarter
   of them empty, zero-size), at the decode program's (1, 1000, 5)^2 on
   its own first candidates, on pairs ~70 m out that nearly touch, on one
   sample of 900 candidates from 5 tight clusters, and on exact cases,
   each with the share of pairs its separation test leaves to the clip, in
   all and per 64 x 64 block, and its time at every tile height; the
   bounded segment max (K5f) at (B, 120000, 32), B = 1 and 4 in f32 and
   B = 1 and 8 (the train step's) in bf16, on streams from the port's
   voxelizer, exactly, and on a clustered stream (pillars at the cap of
   20, x in {-0, 0, 1, 2}); the bilinear row gather (K3f) at (B, 16384,
   384) x 2490 sample points, B = 1 and 4, and x 640 points at B = 8 (the
   train step's), f32 and bf16, points off the map included, with
   ``F.grid_sample`` timed beside it, and K3f, K3dx and K3dcw at C = 3 (a
   480 x 640 RGB image warped to 512 x 512, channels padded to the vector
   width); the segment max's backward (K5b) at
   (B, 120000, 32), B = 1 and 8 in bf16 and B = 1 and 4 in f32, on uniform
   streams and on clustered ones (pillars filled to the cap of 20) with
   forced ties, exactly on segments of at most two rows, and at the main
   paths' shapes on a g that is the second half of a (B, N, 64) tensor
   (as the PFN's cat hands it), bit-equal to the same g contiguous, with
   the route's time and the share of tiles with no covered row; the row
   gather's
   backwards (K3dx with ``index_add_`` timed beside it, K3dcw) at
   (B, 16384, 384) x 640 sample points, B = 1 and 8, f32 and bf16, and at
   B = 8 on a heavy-duplicate stream (every point on one of four spots of
   one map row), K3dx's dx bit-equal between two calls; K1b with the share
   of its corners that took the global fallback and its shared memory per
   block, and also at bf16 C = 384 (any width, coordinate gradients
   repeating bit for bit); the flat sampler (K2f, K1f's kernel with one
   tap) at stage 1's (B, 128, 128, 64) with 147,456 position-major samples
   per image, B = 1 and 16 in f32 and bf16 at spread 0 and 1.5 and B = 128
   in bf16, with its fallback share and ``F.grid_sample`` timed beside it,
   and its backward (K2b, K1b's kernel with one tap) at B = 128
   in bf16 and B = 2 in f32, spread 0 and 1.5, with its fallback share and
   shared memory per block, both also at C = 3, 12, 20 and at coordinates
   of +-1e6 and +-3e9; a bf16 DCN layer with a bias, rounded once; and
   the row gather (K3f) at the R-CNN's ROIAlign shapes, batch 1 and 8, f32
   and bf16: each FPN level's (B, 128^2 / 64^2 / 32^2 / 16^2, 256) map
   at the box head's 512 rois x 196 points and the mask head's 100 x 784,
   rois drawn like proposals (zero-area and zero-padded ones included),
   with ``F.grid_sample`` timed beside it; K3f and its map gradient K3dx
   at the R-CNN train steps' shapes (256 rois x 196 and x 784 points per
   image, a fifth of them zero boxes at the origin, g only on each roi's
   own level), bf16, batch 1 and 8, with ``index_add_`` beside K3dx (dx
   bit-equal between calls); K3f at Mask R-CNN's GT-bitmap crop (B,
   128^2, 64) f32 x 256 x 3136 points, batch 1 and 8; K5f and K5b at a
   bf16 width of 18 (padded to 24) on the train batch's streams;
4. end to end in f32 (TF32 off): ``CenterNet`` predict on the card against
   the same model on the CPU (the plain path), stage by stage, with both
   sides' distances to the model in f64 on the CPU reported;
   b. the same for PointPillars predict from raw points at batch 1: heads,
      anchor mask, top-900 candidates, IoU matrix, kept lists;
   c. the same for two-stage CenterPoint ``predict_refined`` at batch 1:
      PFN rows, BEV map, every task's maps, top-1000 candidates per task,
      IoU matrix, kept lists, refined boxes and scores;
   d. the same as 4 for CenterNet with DCN in all four backbone stages;
   e. the same for Faster R-CNN ``predict`` (ResNet-50-FPN, 320x320) at
      batch 1, against the f32 CPU and an f64 CPU referee: C2-C5, P2-P6,
      the RPN's outputs, the proposals, the ROI features, the box head's
      outputs and the detections, each discrete choice (per-level top-k,
      RPN NMS, final top-k, final NMS) also on the CPU's own inputs;
   f. the same for Mask R-CNN, with the mask logits; both also read,
      ungated, the card's box head with its layers in f64
      (``box_head_f64_readings``);
   g. the same for YOLOv8-s ``predict`` (full width, 640x640, 80 classes)
      at batch 2, BN randomized: C3-C5, N3-N5, the DFL and
      class logits held to the f64 referee, the decode, top-1000 and
      class-aware NMS on the CPU's inputs, the card's own detections
      against the CPU's as sets; no kernel launches;
   h. the same for YOLOX-s ``predict`` (its score biases calibrated, as
      ``yolox_entry`` serves it): the offsets, objectness and class
      logits; no kernel launches;
   i. the same for YOLOv5-s ``predict``: each level's (B, H, W, 3, 85)
      head output; no kernel launches;
   j. the same for YOLOv3 ``predict`` (Darknet-53, 288x288 of its 416), BN
      statistics
      from the request's image: C3-C5 and each level's head output
      (strides 32, 16, 8); no kernel launches;
   k. the same for YOLOv4 (CSPDarknet53 at width 1.0, 352x352 of 512);
   l. the same for YOLOv7 (E-ELAN at width 0.5, 448x448 of 640);
   m. the same for SSD-300-MobileNetV2 (its class convs calibrated on the
      request, as ``ssd_entry`` serves it): the six maps, the class logits
      and box deltas, top-400, NMS;
   n. f32 DeepLabV3+ ``predict`` (ResNet-101 at output stride 16, batch 2
      at 321x321, cut from 513x513; the ASPP's rate-18 taps still reach
      real pixels), BN
      statistics from the request's image: C2, C5, the ASPP and decoder
      outputs, the out conv and the logits held to the f64 referee, the
      argmax equal to the referee's wherever its top-two margin clears the
      card's error; o. the same for DeepLabV3; p. for UNet (full width at
      256x256, cut from 512x512); no kernel launches;
5. end to end in f32 (TF32 off): one train step (384x384, batch 2) on the
   card against the same step on the CPU: loss, grad_norm, every
   parameter's gradient, the post-step parameters and BN statistics; and
   against the same step in f64 compute on the CPU (the referee), part by
   part;
   b. ``bilinear_sample_2d`` differentiated with respect to the map and
      the coordinates at the second stage's shape, card against CPU (K3f,
      K3dx and K3dcw launch once each);
   c. one f32 two-stage CenterPoint train step at batch 1, card against
      CPU, with the same step in f64 compute on the CPU as referee: the
      second stage on the same proposals, then the whole step's loss,
      parts, grad_norm, gradients and BN statistics; then one step of the
      single-stage model from the same weights (K5f and K5b once each),
      held to the referee the same way;
   d. one f32 train step of CenterNet with DCN in all four backbone stages
      (256x256, batch 2), the card held to the f64 referee, the f32 CPU
      reported;
   e. one f32 Faster R-CNN train step (ResNet-50-FPN at 256 x 256, batch
      2, 64 ROI samples, SGD) on the card against the f32 CPU and an f64
      CPU referee, both on the card's proposals and all three on the same
      draws: each discrete stage on the CPU's inputs (proposals, RPN
      targets, the ROI sample), the losses, every parameter's gradient, the
      BN statistics; from seeded weights with random BN, and again from
      the train entries' own (``seed_rcnn_for_training``);
   f. the same for Mask R-CNN, with its mask targets;
   g. one f32 PointPillars train step (KITTI car at full width, batch 2,
      AdamW 2e-4) on the card against the f32 CPU and an f64 CPU referee:
      the anchor mask, the targets on the CPU's inputs (labels equal but
      within 1e-6 of a threshold), the loss parts, grad_norm, every
      gradient (at most 2x the f32 CPU's distance from the referee plus
      1e-3) and the BN statistics; no kernel launches;
   h. one f32 YOLOv8-s train step (full width at 224x224, batch 2, the
      config's Nesterov SGD at lr 0.01 inside the NaN guard) held the same
      way, with the task-aligned assignment on the CPU's inputs; no kernel
      launches;
   i. the same for YOLOX-s (momentum 0.9), with SimOTA's assignment on the
      CPU's inputs; no kernel launches;
   j. the same for YOLOv5-s, with its target maps on the CPU's inputs
      exactly, also with a GT copied into a later slot (the last writer
      wins every slot both claim); no kernel launches;
   k. the same for YOLOv3 (its config's SGD: momentum 0.9, no Nesterov),
      with each GT's best anchor, the target maps and the ignore masks on
      the CPU's inputs exactly, also with a GT copied into a later slot;
   l. the same for YOLOv4 (width 1.0, SGD 0.949 without Nesterov) and
   m. YOLOv7 (width 0.5, Nesterov SGD 0.937), with YOLOv5's target maps;
   n. the same for SSD at 300x300 (SGD 0.9, decay 4e-5; a large GT added
      on each of maps 2-5, so every map has positives), with the labels,
      the matches and the mined negatives on the CPU's inputs exactly (the
      negatives also on cross entropies rounded to ties);
   o. one f32 DeepLabV3+ train step (ResNet-101 at 257x257, batch 2, SGD
      at 0.007) held to the f64 referee as 5k-5n hold theirs, by part
      (backbone, ASPP, the decoder's low_ and dec, out), then again in f64
      on the card; p. the same for DeepLabV3; q. for UNet (full width at
      128x128, Adam at 3e-4); no kernel launches;
6. the main paths, each with every kernel's launch count set to 0 just
   before and read just after:
   a. serving: the flagship predict (CenterNet-R18-DCNv2, 80 classes,
      512x512, bf16, top-100) answers requests at batch 1 and 16;
   b. training: the flagship train step (``train_entry``: f32 params, bf16
      compute, batch TRAIN_BATCH) takes 2 warm-up and 10 timed steps on one
      batch; the loss must stay finite and fall;
   c. PointPillars serving (``pointpillars_entry``: KITTI car, f32, 18,000
      points per cloud) answers 2 warm-up and 10 timed requests at batch 1
      and 8; K4 launches once per request and no other kernel launches;
   d. two-stage CenterPoint serving (``centerpoint_entry``: nuScenes
      pillars, f32, 120,000 points per cloud, heads calibrated so that the
      NMS has 1000 valid candidates per task) answers 2 warm-up and 10
      timed requests at batch 1 and 4; K5f, K4 and K3f launch once per
      request each, the sampler kernels never;
   e. two-stage CenterPoint training (``centerpoint_train_entry``: f32
      params, bf16 compute, batch 8, 120,000 points and up to 63 boxes per
      cloud) takes 2 warm-up and 10 timed steps on one batch; the loss must
      stay finite and fall; K5f, K5b, K3f, K3dx and K4 launch once per step
      each, K3dcw and the sampler kernels never; one more step under
      ``torch.profiler`` must copy no gradient of K5b's size in the
      segment max's or the cat's backward (K5b reads the cat's slice);
   f. serving CenterNet with DCN in all four backbone stages
      (``centernet_dcn4_entry``) as in a: K2f launches twice and K1f nine
      times per forward;
   g. training it (``centernet_dcn4_train_entry``) as in b: K2f and K2b
      launch twice, K1f and K1b nine times per step;
   h. Faster R-CNN serving (``faster_rcnn_entry``: ResNet-50-FPN, 80
      classes, 512x512, bf16, heads calibrated so that every request keeps
      detections) answers 2 warm-up and 10 timed requests at batch 1 and
      8; K3f launches 4 times per request (one ROIAlign per pyramid
      level), no other kernel;
   i. Mask R-CNN serving (``mask_rcnn_entry``) as in h: K3f launches 8
      times per request (the box and the mask ROIAligns);
   j. Faster R-CNN training (``faster_rcnn_train_entry``: ResNet-50-FPN, 80
      classes, 512x512, f32 params, bf16 compute, batch 8, 256 ROI
      samples, SGD 0.01) takes 2 warm-up and 10 timed steps on one batch
      (new sampling draws each step); every loss part stays finite; K3f
      and K3dx launch 4 times per step, nothing else; then one more step
      keeps K3dx's inputs (the sampled rois' corners and the real g on
      each level), and each of those calls is held against the plain
      version and timed beside ``index_add_`` (these are the K3dx row's
      R-CNN cases in the summary);
   k. Mask R-CNN training (``mask_rcnn_train_entry``) as in j: K3f
      launches 9 times per step (the GT crop too) and K3dx 8 times;
   l. PointPillars training (``pointpillars_train_entry``: KITTI car, f32
      params, bf16 compute, batch 32, 18,000 points and up to 23 cars per
      cloud, AdamW 2e-4) takes 2 warm-up and 10 timed steps on one batch;
      the loss must stay finite and fall; no kernel launches;
   m. single-stage CenterPoint training (``centerpoint_single_train_entry``,
      batch 8) as in e: K5f and K5b once per step, nothing else;
   n. the decode + rotated-NMS program (``decode_nms_entry``: one task
      head's 128 x 128 maps, top 1000, NMS 0.2, 83 kept, 20 chained
      iterations): one warm-up and 3 timed calls, K4 once per iteration and
      nothing else, the host clock and the NMS passes per iteration, and
      one profiled call for the device's busy time per iteration;
   o. YOLOv8-s serving (``yolov8_entry``: bf16, 640x640, top 1000, NMS
      0.7, 100 detections) answers 2 warm-up and 10 timed requests at
      batch 1 and 16; no kernel launches;
   p. YOLOv8-s training (``yolov8_train_entry``: f32 params, bf16 compute,
      batch 16, the config's SGD under its warm-up and the NaN guard) takes
      2 warm-up and 10 timed steps on one batch; every loss part finite and
      every step applied; no kernel launches;
   q. YOLOX-s serving (``yolox_entry``: bf16, 640x640, score biases
      calibrated, top 1000, NMS 0.65, 100 detections) as in o;
   r. YOLOX-s training (``yolox_train_entry``: its config's Nesterov SGD
      0.9 under the warm-up cosine) as in p;
   s. YOLOv5-s serving (``yolov5_entry``: bf16, 640x640, top 1000, NMS
      0.45 over score 0.05) as in o;
   t. YOLOv5-s training (``yolov5_train_entry``: SGD 0.937 under the
      warm-up cosine) as in p;
   u. YOLOv3 serving (``yolov3_entry``: bf16, 416x416, top 1000, NMS 0.45
      over 0.05) as in o, and v. its training (``yolov3_train_entry``:
      batch 16, SGD 0.9 under ``multi_epochs_decay``) as in p;
   w. / x. the same for YOLOv4 (512x512; SGD 0.949 under the warm-up
      cosine);
   y. / z. the same for YOLOv7 (640x640; Nesterov SGD 0.937);
   aa. / ab. the same for SSD-300-MobileNetV2 (``ssd_entry``: calibrated
      on its image, top 400; ``ssd_train_entry``: batch 32, SGD 0.9, decay
      4e-5); 6u-6ab are always profiled (the device's busy time and idle
      share per request and per step) and print their seconds.
   ac. DeepLabV3+ serving (``deeplabv3plus_entry``: ResNet-101 at output
      stride 16, 21 classes, 513x513, bf16, the per-pixel argmax) at batch
      1 and 16, and ad. its training (``deeplabv3plus_train_entry``: batch
      16, f32 params, bf16 compute, SGD 0.9 with decay 4e-5 under the
      polynomial decay from 0.007, the NaN guard): the loss must fall over
      the 12 steps;
   ae. / af. the same for DeepLabV3 (no decoder);
   ag. / ah. the same for UNet (``unet_entry``: widths 64-1024, 2 classes,
      512x512, batch 1 and 8; ``unet_train_entry``: batch 8, Adam under the
      warm-up cosine from 0); 6ac-6ah launch no hand-written kernel, are
      always profiled and print their seconds.
   ai. the config's CenterNet train step fed by the COCO data path
      (``centernet_coco_train_entry``: batch 16, Adam under
      ``multi_epochs_decay``, clip 35, the NaN guard; the affine route of
      ``coco_batches`` over 64 in-memory COCO-like images, four loader
      threads): 12 steps, each on the next batch, the warp kernel once and
      K1f and K1b nine times a step, losses finite; then the same step on
      one fixed batch, the copy of a raw batch to the card, the transform's
      device time (the warp apart, and beside it the same transform on the
      replaced K3f route) and the wait for the next batch, apart;
   aj. ``centernet_eval_entry``: ``centernet_evaluate`` on the 64 images
      (bf16 flagship, keep-res buckets of 128 on the 1024 canvas, batch 4,
      per-class soft-NMS on the card, the top-100 merge): the warp kernel
      once and K1f nine times per predict batch; ms per image split into
      load, copy, warp, predict, soft-NMS and the host's evaluator; the 12
      numbers;
   ak. the mosaic + mixup route of ``coco_batches`` at 640x640, batch 16
      (no model): the warp kernel four times a batch; ms per batch; the
      device half of one batch on the device (the mosaic apart, and beside
      it the replaced K3f route). 6ai-6ak print their seconds beside the
      card.
   al. the car config's own train step fed by the KITTI data path
      (``pointpillars_kitti_train_entry``: f32, batch 4, AdamW with decay
      1e-4 under ``exponential_decay``, the NaN guard; ``kitti_batches``
      over 64 in-memory frames: the GT database built from them, the
      sampler, the per-object noise, the global augmentation, four loader
      threads): three epochs of steps (48), each on the next batch, no
      kernel launch, losses finite, every step applied; epochs 2 and 3
      timed (the first's batches are made ahead), the wait for the
      loader's next batch apart; then the same step on one fixed batch and
      the copy of a raw batch to the card, apart;
   am. the same for the ped_cycle config (Cyclist, Pedestrian);
   an. ``kitti_evaluate`` (``pointpillars_kitti_eval_entry``: the car
      config's seeded f32 model over 256 in-memory frames, batch 4, score
      threshold 0.3, bbox / bev / 3d and AOS): K4 once per predict batch
      and once each for the bev and 3d overlaps; ms per frame split into
      load, copy, predict, annos, overlaps and the host's evaluator; the
      12 table numbers;
   ao. ped_cycle serving (``pointpillars_ped_cycle_entry``: 2 classes,
      grid 248 x 296, 293,632 anchors, f32) at batch 1 and 4 as 6c: K4 once
      per request.
   ap. PointPillars serving on padded voxels (``pointpillars_voxel_entry``:
      the reference's dense branch, ``voxelize_batch`` at 16000 x 32, the
      generic anchor mask, ``predict``; f32) at the car config, batch 1
      and 8, and the ped_cycle config, batch 1 and 4; beside it the car's
      stream entry at batch 1 and 8: K4 once per request, nothing else;
      ms per request, peak memory, and from ``torch.profiler`` the device's
      busy ms and idle share per request;
   aq. the PointPillars train step on padded voxels
      (``pointpillars_voxel_train_entry``: 6l's model, optimizer and batch
      32, ``loss_from_gt_padded``) as 6l, then 6l's stream step beside it,
      both profiled; no kernel launches;
   ar. single-stage CenterPoint serving on padded voxels
      (``centerpoint_voxel_entry``: ``configs/centerpoint_pp_nusc.yaml``,
      30000 x 20 voxels of 120,000-point clouds, heads calibrated as 6d's)
      at batch 1 and 4 as 6ap;
   as. its double-flip TTA (``centerpoint_tta_entry``: 4 B clouds as one
      voxel batch, the maps unflipped and merged) at batch 1 and 4 as 6ap.

Phase 4s is the padded voxel path in f32 card against CPU
(``check_voxel_path_f32``): ``voxelize_batch`` exactly, the padded PFN's
canvas, the generic anchor mask (and the grid mask from the same coords),
the heads and the detections of PointPillars' ``predict_from_points_padded``
(car config) and of CenterPoint's ``predict`` on voxels (nuScenes config),
the card's stream and padded canvases under the first-come drop order, and
the double-flip TTA on a cloud cut to ``TTA_CHECK_POINTS`` points; each
predict launches K4 once. Phase 5r (``check_voxel_train_f32``) is one f32
step of each model's voxel ``loss`` on the card, on the CPU and in f64 on
the CPU (the referee), held as 5g holds its step. K4's shapes on the padded
paths are phase 3's PointPillars and CenterPoint cases.

Phase 3 also holds the affine warp kernel (``bilinear_warp_affine_fwd``,
``csrc/bilinear_warp.cu``) at the COCO path's warps (``check_coco_warp``):
the train warp (16, 640^2, 3) to 512^2, the eval warp (4, 1024^2, 3) to
the (512, 768) and (768, 768) buckets, one of the mosaic's four warps (16,
640^2, 3) to 640^2, and Mask R-CNN's GT bitmaps (8, 160^2, 128) to 128^2:
against its plain version (``GATHER_TOL``), its difference from the route
it replaced (the corners, the pad, K3f, the slice) printed, expected 0;
the launch, the whole ``warp_images`` call and ``F.grid_sample`` timed
beside the replaced route's parts. Phase 3's K4 cases also take the
KITTI evaluator's overlap chunk, (256, 24, 5) x (256, 100, 5) camera-frame
BEV boxes (the bev and the 3d overlaps give K4 the same input) with
DontCare rows (location -1000, dimensions -1) and zero-padded rows
(``kitti_eval_chunk``), and the KITTI
evaluation's predict batch (4, 900, 5)^2. Phase 4r is the car config's f32
KITTI eval path card against CPU (``check_kitti_f32``): detections of 4
in-memory frames matched one to one by box, every metric's overlaps
within ``IOU_TOL`` and every AP / AOS entry within 1e-6 on the same annos.
Phase 4q is the f32 COCO path card against CPU
(``check_coco_f32``): ``centernet_evaluate`` on 8 in-memory images in two
buckets, the warped inputs, the raw top-100 scores, soft-NMS on the CPU's
inputs, the card's AP@[.5:.95] against the CPU's final detections as GT
(at least ``COCO_AP_FLOOR``), and the train transform on one raw batch.

The nuScenes path: phase 4t (``check_nuscenes_f32``) holds
``nuscenes_batches`` at one loader thread (the same raw batches twice),
``nuscenes_evaluate`` by the plain, TTA and refined routes (detections
matched by box, each side's table from its own detections with the same
oracle detections ranked first, within 1e-6; mAP and NDS inside (0, 1))
and the tracker and ``evaluate_tracking`` on them (the same tracks up to
their ids, the tables within 1e-6, AMOTA inside (0, 1)), card against CPU.
Phase 5s (``check_config_train_f32``) is the config's f32 train step on
one fed cloud on the card, on the CPU and in f64 on the CPU, held by
``_referee_checks`` (per part and per parameter) with the head's ReLU
inputs read on all three (``_relu_kinks``), and the one-cycle lr against
its formula. Phases 6at-6av time the config's step fed by
``nuscenes_batches`` (epochs 2 and 3 of CBGS, the wait apart, the
distribution and each epoch's mean; the same step on one fixed batch;
one more step under ``torch.profiler``, which must copy no gradient of
K5b's size in the segment max's or the cat's backward),
``nuscenes_evaluate``'s ms per frame by route and part, and
``nuscenes_tracking_evaluate``'s over a 40-keyframe scene.

The Waymo path, on ``configs/centerpoint_pp_waymo.yaml`` at +-76.8 m and
480 x 480 (``entry.waymo_config``): phase 3 holds K4 at its NMS's (B, 1000,
5)^2, B = 1, 2 and 4 (one task), and at one of ``evaluate_waymo``'s IoU
calls, K5f at (B, 160000, 32) f32, B = 1, 2 and 4, K5b at (4, 160000, 32)
f32 (and on the strided g) on the streams of Waymo-like frames, and K3f at
the refined route's (2, 120^2, 384) x 415 points (``check_waymo_kernels``).
Phase 4w (``check_waymo_f32``) holds ``waymo_batches`` at one loader thread
(the same raw batches twice), ``waymo_annos`` by the plain and refined
routes card against CPU (the same GT annos, detections matched by box) and
``evaluate_waymo`` with the range breakdowns on each side's own detections
with the same oracle detections ranked first (the tables within 1e-6, the
card's K4 launches as ``_waymo_iou_calls`` counts them). Phase 5t
(``check_config_train_f32`` on ``_waymo_step_inputs``) is the config's f32
step on one fed cloud held to the f64 CPU referee as 5s. Phases 6aw-6ay
serve the model at batch 1 and 4 (``centerpoint_waymo_entry``: K5f and K4
once a request), time the config's step fed by ``waymo_batches`` as 6at
(K5f and K5b once a step; a profiled step copies no gradient of K5b's
size) and ``waymo_evaluate``'s ms per frame by route and part (K4 once per
batch and per evaluator call).

The line before the last is the ``{"kernels": [...]}`` summary (a kernel's
``launches`` are those of the main paths only; K3dcw, which no entry point
reaches yet, has 0 there and phase 5b's count under its own key; every
number in it but ``bound_ms`` is measured in the run); the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. ``--json PATH`` also writes every measurement there;
``--profile`` also breaks the serving requests (every served model) and 3
train steps of each trained model (6l, 6m, 6p, 6r and 6t included) down
with ``torch.profiler`` (device kernels and host operators); ``--probe``
also compares the f32 CenterPoint train-mode forward layer by layer, on the
card and on the CPU, with the CPU's in f64.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# (H = W, C) of the nine DCN inputs at 512x512, each shape three times
DCN_SHAPES = ((64, 128), (32, 256), (16, 512))
DCN_CALLS_PER_SHAPE = 3
DCN_LAYERS = 9
BATCH = 16
TAPS = 9
SERVE_BATCHES = (1, 16)
SERVE_WARMUP = 2
SERVE_REQUESTS = 10
TRAIN_BATCH = 128
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
CHECK_BATCH = 2  # the f32 card-vs-CPU train step
OFFSET_GAIN = 0.25  # offset conv std * sqrt(fan_in), see randomize_for_check
HOST_AHEAD_CYCLES = 20_000_000  # ~10 ms of GPU clock, see _cuda_ms


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int, warmup: int = 2, windows: int = 1) -> float:
    """Device ms per call of ``fn``, its launches back to back: a busy wait
    on the stream lets the host queue every launch before the first start
    event, so a call shorter than its host-side cost (a ~30 us kernel) is
    not timed at the host's pace. With ``windows`` > 1, the median of that
    many windows of ``iters`` calls: one slow stretch of the card's clock
    then moves no reading."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


# how phase 3 times a kernel at the train batch (~0.2-6 ms a call): the
# median of 5 windows of 10 calls
TRAIN_TIMING = dict(iters=10, windows=5)


def _dcn_coords(b, h, w, k, spread, gen):
    """Tap-major (B, K, P) coordinates of a stride-1 3x3 DCN at (h, w):
    grid - 1 + tap + spread * N(0, 1); and a mask in [0, 1)."""
    iy = torch.arange(h, dtype=torch.float32).repeat_interleave(w)
    ix = torch.arange(w, dtype=torch.float32).repeat(h)
    taps = torch.arange(k)
    base_y = iy[None, :] - 1 + torch.div(taps, 3, rounding_mode="floor")[
        :, None].float()
    base_x = ix[None, :] - 1 + (taps % 3)[:, None].float()
    ys = base_y + spread * torch.randn(b, k, h * w, generator=gen)
    xs = base_x + spread * torch.randn(b, k, h * w, generator=gen)
    sc = torch.rand(b, k, h * w, generator=gen)
    return ys, xs, sc


def _touched_rows(x, ys, xs) -> int:
    """How many (image, texel) rows of x the samples' in-bounds corners
    touch."""
    b, h, w, _ = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    rows = 0
    for bi in range(b):
        touched = []
        for cy, cx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
            inb = (cy[bi] >= 0) & (cy[bi] < h) & (cx[bi] >= 0) & (cx[bi] < w)
            touched.append((cy[bi] * w + cx[bi])[inb].long())
        rows += int(torch.unique(torch.cat(touched)).numel())
    return rows


def _bound(nbytes: int, f32_ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = f32_ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _taps_bound(x, ys, xs):
    """(bound_ms, bound_by) of the taps sampler on these inputs: the output
    written once, the x rows these samples touch read once, the three
    coordinate arrays read once; 9 f32 operations per output value (4 FMAs
    and the scale)."""
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    elt = x.element_size()
    nbytes = (b * p * k * c * elt + _touched_rows(x, ys, xs) * c * elt
              + 3 * b * k * p * 4)
    return _bound(nbytes, 9 * b * p * k * c)


def _taps_bwd_bound(x, ys, xs):
    """(bound_ms, bound_by) of the sampler's backward on these inputs: g
    (B,P,K*C) read once, the x rows these samples touch read once, the
    three coordinate arrays read once; dx (B,H,W,C in x's type) and the
    three (B,K,P) f32 gradients written once; 16 f32 operations per g value
    (4 FMAs of the corner dots, 4 scaled adds into dx)."""
    b, h, w, c = x.shape
    k, p = ys.shape[1], ys.shape[2]
    elt = x.element_size()
    nbytes = (b * p * k * c * elt + _touched_rows(x, ys, xs) * c * elt
              + 3 * b * k * p * 4 + b * h * w * c * elt + 3 * b * k * p * 4)
    return _bound(nbytes, 16 * b * p * k * c)


def check_taps_kernel(dev, gen):
    """Phase 3: hat_sample_taps_fwd against its plain version, per case: at
    the three DCN shapes, B = 16 (serving) in f32 and bf16 at spread 1.5
    and 80, B = 1 (serving one image: a call too small for a window) and
    B = 128 (the train step's forward) in bf16 at spread 1.5.
    Each case reports the share of its corners on the map that took the
    kernel's global fallback (outside their tile's window) and the plan's
    shared memory per block."""
    from minddet_tpu_torch.ops import hat_sample as hs

    # B = 16 draws from the shared generator as before; batches 1 and 128
    # from generators of their own, so that the cases after them keep theirs
    tgen = torch.Generator().manual_seed(4)
    sgen = torch.Generator().manual_seed(5)

    def inputs():
        for h, c in DCN_SHAPES:
            x32 = torch.randn(BATCH, h, h, c, generator=gen).to(dev)
            for spread in (1.5, 80.0):
                coords = [t.to(dev) for t in
                          _dcn_coords(BATCH, h, h, TAPS, spread, gen)]
                for dtype in (torch.float32, torch.bfloat16):
                    yield (h, c, spread, x32.to(dtype), *coords)
            del x32
            for b, bgen in ((1, sgen), (TRAIN_BATCH, tgen)):
                x = torch.randn(b, h, h, c, generator=bgen).to(
                    dev, torch.bfloat16)
                yield (h, c, 1.5, x, *(t.to(dev) for t in _dcn_coords(
                    b, h, h, TAPS, 1.5, bgen)))

    cases = []
    for h, c, spread, x, ys, xs, sc in inputs():
        b, dtype = x.shape[0], x.dtype
        got = hs.hat_sample_2d_taps(x, ys, xs, sc)
        torch.cuda.synchronize()
        ref = hs.hat_sample_2d_taps_plain(x.float(), ys, xs, sc)
        err = (got.float() - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        if dtype == torch.float32:
            tol = "f32: abs <= 1e-5"
            ok = max_abs <= 1e-5
        else:  # within one bf16 ulp of the plain f32 result
            tol = "bf16: abs <= 1e-2 + 2**-7 * |plain f32|"
            ok = bool((err <= 1e-2 + 2 ** -7 * ref.abs()).all())
        del got, ref, err
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        hs._taps_cuda(x, ys, xs, sc, stats=stats)
        fallback, onmap = (int(v) for v in stats.tolist())
        plan = hs.taps_fwd_plan(b, h, h, c, TAPS, h * h, x.element_size(),
                                hs._sms(dev))
        ms = _cuda_ms(lambda: hs.hat_sample_2d_taps(x, ys, xs, sc),
                      **(TRAIN_TIMING if b == TRAIN_BATCH else dict(iters=20)))
        plain_ms = _cuda_ms(
            lambda: hs.hat_sample_2d_taps_plain(x, ys, xs, sc),
            iters=3, warmup=1)
        bound_ms, bound_by = _taps_bound(x, ys, xs)
        case = dict(shape=[b, h, h, c], taps=TAPS, spread=spread,
                    dtype=str(dtype).replace("torch.", ""),
                    max_abs_err=max_abs, max_rel_err=max_rel,
                    tolerance=tol, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, plan=plan,
                    fallback_share=fallback / max(onmap, 1))
        cases.append(case)
        print(f"  taps x{case['shape']} K={TAPS} spread={spread:4.1f}"
              f" {case['dtype']:8s} fallback="
              f"{case['fallback_share']:.4f} smem={plan['smem_bytes']} "
              f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
              f"kernel={ms * 1e3:8.1f}us plain={plain_ms * 1e3:9.1f}us "
              f"bound={bound_ms * 1e3:6.1f}us ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(
                f"hat_sample_taps_fwd disagrees with its plain "
                f"version ({tol}): {case}")
        del x, ys, xs, sc
    return cases


# K1b tolerances, err <= atol + rtol * |plain f32|, per output. The plain
# version gets the same g and x (bf16 ones widened exactly) and sums in f32:
# - dys, dxs, dscale: sums of 4*C f32 products, taken by warp shuffles and
#   atomics in another (and run-to-run varying) order;
# - dx f32: sums of up to 4*K scaled g values, in atomic order;
# - dx bf16: that f32 sum rounded once to bf16 (half an ulp, 2**-9
#   relative), with room for the f32 order flipping a rounding.
BWD_TOL = {"dys": (1e-4, 1e-5), "dxs": (1e-4, 1e-5), "dscale": (1e-4, 1e-5),
           "dx_float32": (1e-5, 1e-5), "dx_bfloat16": (1e-5, 2 ** -8)}
BWD_SPREADS = (0.0, 1.5, 80.0)
ODD_TAPS_SHAPE = (32, 384)  # (H = W, C) of K1b's any-width case


def check_taps_bwd_kernel(dev, gen):
    """Phase 3: hat_sample_taps_bwd against its plain version, per case.
    Spread 0 puts every sample on the integer grid (a DCN layer with
    zero-initialised offsets), where dys and dxs are forward differences
    and must not vanish."""
    from minddet_tpu_torch.ops import hat_sample as hs

    dgen = torch.Generator(device=dev).manual_seed(1)
    # B = 16 in f32 and bf16 at every spread; the train path's batch in
    # bf16 at spread 0 (its first step) and 1.5 (offsets that moved)
    grid = [(BATCH, spread, dtype) for spread in BWD_SPREADS
            for dtype in (torch.float32, torch.bfloat16)]
    grid += [(TRAIN_BATCH, spread, torch.bfloat16) for spread in (0.0, 1.5)]
    # and a width no shipped model has but the reference's taps path trains
    # (C % 128 == 0): 48 bf16 vectors per sample, not a power of two
    shapes = [(h, c, grid) for h, c in DCN_SHAPES] + [
        (ODD_TAPS_SHAPE[0], ODD_TAPS_SHAPE[1],
         [(BATCH, 1.5, torch.bfloat16)])]
    cases = []
    for h, c, grid in shapes:
        for b, spread, dtype in grid:
            x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
            g = torch.randn(b, h * h, TAPS * c, generator=dgen,
                            device=dev).to(dtype)
            ys, xs, sc = (t.to(dev) for t in
                          _dcn_coords(b, h, h, TAPS, spread, gen))
            got = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
            again = hs.hat_sample_2d_taps_bwd(g, x, ys, xs, sc)
            torch.cuda.synchronize()
            repeat = all(torch.equal(a, a2)
                         for a, a2 in zip(got[1:], again[1:]))
            del again
            # the corners added outside their block's dx window
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            hs._taps_bwd_cuda(g, x, ys, xs, sc, stats=stats)
            fallback, added = (int(v) for v in stats.tolist())
            plan = hs.taps_bwd_plan(b, h, h, c, TAPS, h * h)
            ref = hs.hat_sample_2d_taps_bwd_plain(g.float(), x.float(),
                                                  ys, xs, sc)
            errs = {}
            bad = [] if repeat else ["dys/dxs/dscale differ between runs"]
            for name, a, r in zip(("dx", "dys", "dxs", "dscale"), got,
                                  ref):
                key = f"dx_{str(dtype)[6:]}" if name == "dx" else name
                atol, rtol = BWD_TOL[key]
                err = (a.float() - r).abs()
                errs[name] = float(err.max())
                errs[f"{name}_max_abs"] = float(r.abs().max())
                if not bool((err <= atol + rtol * r.abs()).all()):
                    bad.append(f"{name} (atol {atol}, rtol {rtol})")
            if spread == 0.0 and min(errs["dys_max_abs"],
                                     errs["dxs_max_abs"]) == 0.0:
                bad.append("dys/dxs vanish at integer coordinates")
            del got, ref
            ms = _cuda_ms(lambda: hs.hat_sample_2d_taps_bwd(g, x, ys, xs,
                                                            sc),
                          **(dict(iters=20) if b == BATCH else TRAIN_TIMING))
            plain_ms = _cuda_ms(
                lambda: hs.hat_sample_2d_taps_bwd_plain(g, x, ys, xs, sc),
                iters=3, warmup=1)
            bound_ms, bound_by = _taps_bwd_bound(x, ys, xs)
            case = dict(shape=[b, h, h, c], taps=TAPS, spread=spread,
                        dtype=str(dtype).replace("torch.", ""),
                        max_abs_err=max(errs[n] for n in
                                        ("dx", "dys", "dxs", "dscale")),
                        errors=errs, tolerance=BWD_TOL, repeat=repeat,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, plan=plan,
                        fallback_share=fallback / max(added, 1))
            cases.append(case)
            print(f"  taps bwd x{case['shape']} spread={spread:4.1f} "
                  f"{case['dtype']:8s} fallback={case['fallback_share']:.4f}"
                  f" smem={plan['smem_bytes']} err dx={errs['dx']:.2e} "
                  f"dys={errs['dys']:.2e} dxs={errs['dxs']:.2e} "
                  f"dsc={errs['dscale']:.2e} (|dys|max "
                  f"{errs['dys_max_abs']:.1f}) kernel={ms * 1e3:8.1f}us "
                  f"plain={plain_ms * 1e3:9.1f}us "
                  f"bound={bound_ms * 1e3:6.1f}us ({bound_by})",
                  flush=True)
            if bad:
                raise AssertionError(
                    f"hat_sample_taps_bwd disagrees with its plain "
                    f"version: {', '.join(bad)}: {case}")
    return cases


# The flat sampler's path: stage 1 of ResNet-18 with DCN in all four stages
# at 512x512, a stride-1 3x3 DCN over the (B, 128, 128, 64) map, two layers
# per forward; its samples are position-major, (B, 128 * 128 * 9).
FLAT_SHAPE = (128, 64)  # (H = W, C)
FLAT_LAYERS = 2
FLAT_ODD = (32, (3, 12, 20))  # (H = W, widths) of the any-width cases
FAR = (1e6, -1e6, 3e9, -3e9)  # the reference pads with -1e6


def _flat_coords(b, h, w, spread, gen):
    """Position-major (B, P*K) coordinates and mask of a stride-1 3x3 DCN
    at (h, w), as ``ops/dcn.py``'s flat branch lays them out."""
    flat = lambda t: t.transpose(1, 2).reshape(b, -1).contiguous()
    return tuple(flat(t) for t in _dcn_coords(b, h, w, TAPS, spread, gen))


def _put_far(ys, xs):
    """The first len(FAR) samples of every image moved to FAR: in y for
    image 0, in x for the others. Returns the index of the moved ones."""
    far = torch.tensor(FAR, device=ys.device)
    ys[0, :len(FAR)] = far
    xs[1:, :len(FAR)] = far
    return slice(0, len(FAR))


def _flat_grid(main):
    """(B, H, C, spread, dtype, far) of the phase 3 cases: ``main`` at
    stage 1's shape, then the odd widths and far-away coordinates."""
    h, widths = FLAT_ODD
    odd = [(2, h, c, 1.5, dtype, False) for c in widths
           for dtype in (torch.float32, torch.bfloat16)]
    far = [(2, h, FLAT_SHAPE[1], 1.5, dtype, True)
           for dtype in (torch.float32, torch.bfloat16)]
    return main + odd + far


def check_flat_kernel(dev, gen):
    """Phase 3: hat_sample_flat_fwd (K2f) against its plain version: at
    stage 1's (B, 128, 128, 64) with 147,456 samples per image, B = 1 and
    16 (serving) in f32 and bf16 at spread 0 and 1.5, and B = 128 (the
    train step's forward) in bf16 at spread 1.5; C = 3, 12 and 20 on a
    32x32 map; samples at +-1e6 and +-3e9, which must give exactly 0.
    Each case reports the share of its corners on the map that took the
    kernel's global fallback and the plan's shared memory per block.
    ``F.grid_sample`` (zero padding, ``align_corners=True``) on the same
    points without the scale is timed beside the stage-1 cases, for
    information: the modulation would be a second call."""
    import torch.nn.functional as F

    from minddet_tpu_torch.ops import hat_sample as hs

    dgen = torch.Generator(device=dev).manual_seed(2)
    h0, c0 = FLAT_SHAPE
    main = [(b, h0, c0, spread, dtype, False) for b in (1, BATCH)
            for spread in (0.0, 1.5)
            for dtype in (torch.float32, torch.bfloat16)]
    main += [(TRAIN_BATCH, h0, c0, 1.5, torch.bfloat16, False)]
    cases = []
    for b, h, c, spread, dtype, far in _flat_grid(main):
        x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
        ys, xs, sc = (t.to(dev) for t in _flat_coords(b, h, h, spread, gen))
        moved = _put_far(ys, xs) if far else None
        got = hs.hat_sample_2d(x, ys, xs, sc)
        torch.cuda.synchronize()
        ref = hs.hat_sample_2d_plain(x.float(), ys, xs, sc)
        err = (got.float() - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        if dtype == torch.float32:
            tol = "f32: abs <= 1e-5"
            ok = max_abs <= 1e-5
        else:  # within one bf16 ulp of the plain f32 result
            tol = "bf16: abs <= 1e-2 + 2**-7 * |plain f32|"
            ok = bool((err <= 1e-2 + 2 ** -7 * ref.abs()).all())
        if far:
            ok = ok and bool((got[:, moved] == 0).all())
        del got, ref, err
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        hs._flat_cuda(x, ys, xs, sc, stats=stats)
        fallback, onmap = (int(v) for v in stats.tolist())
        name = str(dtype).replace("torch.", "")
        case = dict(shape=[b, h, h, c], samples=ys.shape[1], spread=spread,
                    dtype=name, far=far, max_abs_err=max_abs,
                    max_rel_err=max_rel, tolerance=tol,
                    plan=hs.flat_fwd_plan(b, h, h, c, ys.shape[1],
                                          x.element_size(), hs._sms(dev)),
                    fallback_share=fallback / max(onmap, 1))
        case["ms"] = _cuda_ms(lambda: hs.hat_sample_2d(x, ys, xs, sc),
                              **(TRAIN_TIMING if b == TRAIN_BATCH
                                 else dict(iters=20)))
        case["plain_ms"] = _cuda_ms(
            lambda: hs.hat_sample_2d_plain(x, ys, xs, sc), iters=3,
            warmup=1)
        case["bound_ms"], case["bound_by"] = _taps_bound(
            x, ys[:, None], xs[:, None])
        if h == h0 and not far:
            grid = torch.stack([xs / (h - 1) * 2 - 1, ys / (h - 1) * 2 - 1],
                               -1)[:, None].to(dtype)
            xn = x.permute(0, 3, 1, 2)
            case["grid_sample_ms"] = _cuda_ms(
                lambda: F.grid_sample(xn, grid, padding_mode="zeros",
                                      align_corners=True),
                iters=5 if b == TRAIN_BATCH else 20)
            del grid
        cases.append(case)
        print(f"  flat x{case['shape']} N={case['samples']} spread="
              f"{spread:3.1f} {name:8s}{' far' if far else ''} fallback="
              f"{case['fallback_share']:.4f} smem="
              f"{case['plan']['smem_bytes']} "
              f"max_abs={max_abs:.3e} kernel={case['ms'] * 1e3:8.1f}us "
              f"plain={case['plain_ms'] * 1e3:9.1f}us "
              f"bound={case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']})"
              + (f" grid_sample={case['grid_sample_ms'] * 1e3:.1f}us"
                 if "grid_sample_ms" in case else ""), flush=True)
        if not ok:
            raise AssertionError(f"hat_sample_flat_fwd disagrees with its "
                                 f"plain version ({tol}): {case}")
        del x, ys, xs, sc
    return cases


# K2b vs plain: dys, dxs, dscale as K1b's (BWD_TOL, against |plain|); dx as
# K3dx's, against the same sum over absolute values, sum |scale w g|: the
# f32 atomics add up to ~36 samples' terms per texel in any order, and in
# bf16 that sum is rounded once
FLAT_BWD_TOL = {"dys": BWD_TOL["dys"], "dxs": BWD_TOL["dxs"],
                "dscale": BWD_TOL["dscale"], "dx_float32": (1e-6, 1e-5),
                "dx_bfloat16": (1e-6, 2 ** -8)}


def check_flat_bwd_kernel(dev, gen):
    """Phase 3: hat_sample_flat_bwd (K2b) against its plain version: at
    stage 1's (B, 128, 128, 64), B = 128 in bf16 (the train step's) and B =
    2 in f32, at spread 0 (zero offsets: dys and dxs are forward
    differences and must not vanish) and 1.5; C = 3, 12 and 20 on a 32x32
    map; samples at +-1e6 and +-3e9 (no gradient). dys, dxs and dscale
    must repeat bit for bit from one call to the next. Each case reports
    the share of its corners that took the kernel's global fallback (on
    the map, outside their block's window) and the plan's shared memory
    per block."""
    from minddet_tpu_torch.ops import hat_sample as hs

    dgen = torch.Generator(device=dev).manual_seed(3)
    h0, c0 = FLAT_SHAPE
    main = [(TRAIN_BATCH, h0, c0, spread, torch.bfloat16, False)
            for spread in (0.0, 1.5)]
    main += [(CHECK_BATCH, h0, c0, spread, torch.float32, False)
             for spread in (0.0, 1.5)]
    cases = []
    for b, h, c, spread, dtype, far in _flat_grid(main):
        name = str(dtype).replace("torch.", "")
        x = torch.randn(b, h, h, c, generator=dgen, device=dev).to(dtype)
        ys, xs, sc = (t.to(dev) for t in _flat_coords(b, h, h, spread, gen))
        moved = _put_far(ys, xs) if far else None
        g = torch.randn(b, ys.shape[1], c, generator=dgen,
                        device=dev).to(dtype)
        got = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
        again = hs.hat_sample_2d_bwd(g, x, ys, xs, sc)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, a2) for a, a2 in zip(got[1:], again[1:]))
        del again
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        hs._flat_bwd_cuda(g, x, ys, xs, sc, stats=stats)
        fallback, added = (int(v) for v in stats.tolist())
        plan = hs.flat_bwd_plan(b, h, h, c, ys.shape[1])
        bad = [] if repeat else ["dys/dxs/dscale differ between runs"]
        ref = hs.hat_sample_2d_bwd_plain(g.float(), x.float(), ys, xs, sc)
        errs = {}
        for key, a, r in zip(("dx", "dys", "dxs", "dscale"), got, ref):
            err = (a.float() - r).abs()
            errs[key] = float(err.max())
            errs[f"{key}_max_abs"] = float(r.abs().max())
            if key == "dx":
                atol, rtol = FLAT_BWD_TOL[f"dx_{name}"]
                size = hs.hat_sample_2d_bwd_plain(g.float().abs(), x.float(),
                                                  ys, xs, sc.abs())[0]
                ok = a.dtype == dtype and bool(
                    (err <= atol + rtol * size).all())
                del size
            else:
                atol, rtol = FLAT_BWD_TOL[key]
                ok = bool((err <= atol + rtol * r.abs()).all())
                if far:
                    ok = ok and bool((a[:, moved] == 0).all())
            if not ok:
                bad.append(f"{key} (atol {atol}, rtol {rtol})")
            del err
        if spread == 0.0 and min(errs["dys_max_abs"],
                                 errs["dxs_max_abs"]) == 0.0:
            bad.append("dys/dxs vanish at integer coordinates")
        del got, ref
        case = dict(shape=[b, h, h, c], samples=ys.shape[1], spread=spread,
                    dtype=name, far=far,
                    max_abs_err=max(errs[k] for k in
                                    ("dx", "dys", "dxs", "dscale")),
                    errors=errs, tolerance=FLAT_BWD_TOL, repeat=repeat,
                    plan=plan, fallback_share=fallback / max(added, 1))
        case["ms"] = _cuda_ms(lambda: hs.hat_sample_2d_bwd(g, x, ys, xs, sc),
                              **(TRAIN_TIMING if b == TRAIN_BATCH
                                 else dict(iters=20)))
        case["plain_ms"] = _cuda_ms(
            lambda: hs.hat_sample_2d_bwd_plain(g, x, ys, xs, sc), iters=3,
            warmup=1)
        case["bound_ms"], case["bound_by"] = _taps_bwd_bound(
            x, ys[:, None], xs[:, None])
        cases.append(case)
        print(f"  flat bwd x{case['shape']} spread={spread:3.1f} {name:8s}"
              f"{' far' if far else ''} fallback="
              f"{case['fallback_share']:.4f} smem={plan['smem_bytes']} "
              f"err dx={errs['dx']:.2e} "
              f"dys={errs['dys']:.2e} dxs={errs['dxs']:.2e} "
              f"dsc={errs['dscale']:.2e} (|dys|max {errs['dys_max_abs']:.1f})"
              f" repeat={repeat} kernel={case['ms'] * 1e3:8.1f}us "
              f"plain={case['plain_ms'] * 1e3:9.1f}us "
              f"bound={case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']})",
              flush=True)
        if bad:
            raise AssertionError(f"hat_sample_flat_bwd disagrees with its "
                                 f"plain version: {', '.join(bad)}: {case}")
        del x, ys, xs, sc, g
    return cases


def check_dcn_bias_rounding(dev):
    """Phase 3: a bf16 DCN layer with a bias on the card (stage 1's shape,
    zero offsets, no mask: K2f, then the contraction) against the same
    layer as an f64 conv plus bias rounded once to bf16. The bias is added
    to the f32 accumulator and the sum rounded once, so outputs one rounding
    apart are as rare as f32 summation order makes them (< 2e-3); adding it
    after the bf16 matmul (two roundings) puts ~1 in 5 off."""
    import torch.nn.functional as F

    from minddet_tpu_torch.ops.dcn import deform_conv2d

    g = torch.Generator().manual_seed(7)
    h, c = FLAT_SHAPE
    x = torch.randn(1, h, h, c, generator=g).bfloat16()
    w = (torch.randn(3, 3, c, c, generator=g) / 24).bfloat16()
    bias = (3 * torch.randn(c, generator=g)).bfloat16()
    offs = torch.zeros(1, h, h, 9, 2)
    got = deform_conv2d(x.to(dev), offs.to(dev), None, w.to(dev),
                        bias.to(dev)).cpu()
    ref = (F.conv2d(x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1), bias.double(), padding=1)
           .permute(0, 2, 3, 1).bfloat16())
    off = float((got != ref).float().mean())
    worst = float((got.double() - ref.double()).abs().max())
    print(f"  DCN bf16 with bias vs f64 rounded once: {off:.2e} of the "
          f"outputs one rounding off (max {worst:.3e})", flush=True)
    if off >= 2e-3:
        raise AssertionError(f"DCN bias rounding: {off} of the outputs "
                             f"differ from the f64 sum rounded once")
    return dict(share_off=off, max_abs_err=worst)


# K4: f32 arithmetic and compare operations per pair, counted from
# csrc/rotated_iou.cu (selects and the integer slot tests not counted):
# 10 for B's pair-relative corners; per clip edge 2 (edge vector) + 8 x 5
# (sides) + 8 x 11 (2 inside tests, den, |den| test, t, ix, iy); the
# shoelace 8 x 4 + 2.
OPS_PER_PAIR = 10 + 4 * (2 + 8 * 5 + 8 * 11) + 8 * 4 + 2
# The least work for the same areas: a pair whose centres lie farther apart
# than the sum of the boxes' circumscribed radii is disjoint, settled at 0 by
# dx, dy, dx^2 + dy^2 (2), r_a + r_b, its square and the compare; only the
# other pairs need the clip. A radius is 4 operations per box.
SEP_OPS_PER_PAIR = 7
SEP_OPS_PER_BOX = 4
PP_CANDIDATES = 900  # nms_pre of the PointPillars predict
PP_BATCHES = (1, 8)
CP_CANDIDATES = 1000  # nms_pre of the CenterPoint predict, per task
CP_TASKS = 6
CP_NMS_POST = 83  # detections kept per task
CP_BATCHES = (1, 4)
TRAIN_CP_BATCH = 8  # the two-stage train step's (bench.py:bench_two_stage)
CP_PROPOSALS = 128  # num_proposals of the two-stage train step
# (samples, boxes) of K4's calls: one per PointPillars request, and one per
# CenterPoint request over its tasks stacked on the sample axis
IOU_SHAPES = tuple((b, PP_CANDIDATES) for b in PP_BATCHES) + tuple(
    (CP_TASKS * b, CP_CANDIDATES) for b in CP_BATCHES)
KITTI_EVAL_BATCH = 4  # kitti_evaluate's predict batch (ped_cycle serves 4)
# the exact cases of tests/test_rotated_iou.py:203-219
IOU_EXACT_BOXES = ((0.0, 0.0, 2.0, 4.0, 0.0),
                   (0.0, 0.0, 2.0, 4.0, math.pi / 2),
                   (10.0, 10.0, 2.0, 2.0, 0.3),
                   (0.0, 0.0, 1.0, 1.0, 0.0))
IOU_EXACT_AREAS = {(0, 0): 8.0, (1, 1): 8.0, (2, 2): 4.0, (3, 3): 1.0,
                   (0, 1): 4.0, (0, 2): 0.0, (0, 3): 1.0}
IOU_TOL = (1e-4, 1e-5)  # K4 vs plain: atol, rtol (sincos, FMA contraction)
DECODE_CANDIDATES = 1000  # the decode program's top-k (bench.py: NMS_PRE)


def candidate_boxes(b: int, n: int, gen) -> torch.Tensor:
    """(b, n, 5) BEV boxes drawn like a detector's decoded candidates over
    the KITTI range: clusters of anchor-sized cars (1.6 x 3.9, sizes
    jittered) around 60 centres per sample, so a box overlaps its cluster;
    yaws near 0 and +-pi/2 for a third, uniform for a third, and the rest
    near-duplicates of another box (centre and size jittered by 1e-3 to
    5e-2, yaw by 1e-3 or turned by pi); 5 % large boxes (4-10 m) that
    contain their neighbours and 5 % small ones (0.2-0.5 m)."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    clusters = torch.stack([u(0.0, 69.12, b, 60), u(-39.68, 39.68, b, 60)],
                           -1)
    which = torch.randint(0, 60, (b, n), generator=gen)
    centre = torch.gather(clusters, 1, which[..., None].expand(-1, -1, 2))
    centre = centre + 1.5 * torch.randn(b, n, 2, generator=gen)
    w = 1.6 * torch.exp(0.1 * torch.randn(b, n, generator=gen))
    l = 3.9 * torch.exp(0.1 * torch.randn(b, n, generator=gen))
    kind = torch.rand(b, n, generator=gen)
    big = kind < 0.05
    small = (kind >= 0.05) & (kind < 0.1)
    w = torch.where(big, u(4.0, 10.0, b, n), torch.where(
        small, u(0.2, 0.5, b, n), w))
    l = torch.where(big, u(4.0, 10.0, b, n), torch.where(
        small, u(0.2, 0.5, b, n), l))
    axis = (torch.randint(-1, 2, (b, n), generator=gen) * math.pi / 2
            + 0.05 * torch.randn(b, n, generator=gen))
    yaw = torch.where(torch.rand(b, n, generator=gen) < 0.5, axis,
                      u(-math.pi, math.pi, b, n))
    boxes = torch.stack([centre[..., 0], centre[..., 1], w, l, yaw], -1)
    # the last third: near-duplicates of boxes in the first two thirds
    m = n // 3
    src = torch.randint(0, n - m, (b, m), generator=gen)
    dup = torch.gather(boxes, 1, src[..., None].expand(-1, -1, 5)).clone()
    jitter = 10 ** u(-3.0, math.log10(5e-2), b, m, 1)
    dup[..., :4] += jitter * torch.randn(b, m, 4, generator=gen)
    dup[..., 2:4] = dup[..., 2:4].abs()
    turn = torch.rand(b, m, generator=gen) < 0.3
    dup[..., 4] += torch.where(turn, torch.full((b, m), math.pi),
                               1e-3 * torch.randn(b, m, generator=gen))
    boxes[:, n - m:] = dup
    return boxes.contiguous()


IOU_TILE = 64  # pairs per side of K4's block tile (csrc/rotated_iou.cu)


def _rotated_iou_bound(boxes: torch.Tensor, others: torch.Tensor = None):
    """K4's bound on (B, N, 5) boxes against ``others`` (B, M, 5; themselves
    when not given): the larger of the bytes (both box sets read, the f32
    areas written) and the operations of a separation test on every pair
    plus the clip on the pairs that need one: those the test does not
    reject (``ops/rotated_iou.py:separated``, the kernel's rule) whose boxes
    both have two nonzero edges. A pair with a zero edge needs no clip (the
    answer is A's area where B has one, else 0: a box's w * l, one
    operation a box, counted where such pairs occur). Returns (bound_ms,
    bound_by, share of pairs the kernel clips, share that need a clip,
    (mean, max) over ``IOU_TILE`` x ``IOU_TILE`` blocks of their share of
    pairs clipped)."""
    from minddet_tpu_torch.ops.rotated_iou import separated

    others = boxes if others is None else others
    b, n, _ = boxes.shape
    m = others.shape[1]
    clip = ~separated(boxes, others)
    edged = lambda t: (t[..., 2] != 0) & (t[..., 3] != 0)
    need = clip & edged(boxes)[..., :, None] & edged(others)[..., None, :]
    near = int(need.sum())
    areas = b * (n + m) * int(bool((clip & ~need).any()))
    tn, tm = -(-n // IOU_TILE), -(-m // IOU_TILE)
    tiles = torch.zeros(b, tn * IOU_TILE, tm * IOU_TILE, device=clip.device)
    tiles[:, :n, :m] = clip.float()
    pad = torch.zeros_like(tiles)
    pad[:, :n, :m] = 1.0
    per = (tiles.reshape(b, tn, IOU_TILE, tm, IOU_TILE).sum((2, 4))
           / pad.reshape(b, tn, IOU_TILE, tm, IOU_TILE).sum((2, 4)))
    per_block = (float(per.mean()), float(per.max()))
    pairs = b * n * m
    bound_ms, bound_by = _bound(4 * pairs + 4 * 5 * b * (n + m),
                                SEP_OPS_PER_PAIR * pairs
                                + SEP_OPS_PER_BOX * b * (n + m) + areas
                                + OPS_PER_PAIR * near)
    return (bound_ms, bound_by, int(clip.sum()) / pairs, near / pairs,
            per_block)


NEAR_PAIRS = 1000  # pairs of the near-touching case
DENSE_BOXES = 900  # one PointPillars sample of candidates ...
DENSE_CLUSTERS = 5  # ... from this many tight clusters


def near_touching_boxes(n: int, gen):
    """Two (1, n, 5) box sets whose pairs (i, i) nearly touch, all ~70 m
    from the sensor (x in [60, 70] m): a quarter with circumscribed circles
    0 to 1e-3 m apart and a corner of each pointing at the other, a quarter
    edge to edge along A's width with gaps from -1e-3 to 1e-3 m (the
    inside tolerance may leave a sliver), a quarter identical and a quarter
    contained (half size, centre moved by up to 0.2 m)."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           dtype=torch.float64)

    def car(k):
        return (1.6 * torch.exp(0.1 * torch.randn(k, generator=gen,
                                                  dtype=torch.float64)),
                3.9 * torch.exp(0.1 * torch.randn(k, generator=gen,
                                                  dtype=torch.float64)))

    q = n // 4
    w, l = car(n)
    a = torch.stack([u(60.0, 70.0, n), u(-10.0, 10.0, n), w, l,
                     u(-math.pi, math.pi, n)], -1)
    b = a.clone()
    # corner 0, (w / 2, l / 2) rotated by yaw, lies at angle yaw + atan2(l, w)
    phi = u(-math.pi, math.pi, q)
    gap = torch.cat([torch.zeros(1, dtype=torch.float64),
                     10 ** u(-7.0, -3.0, q - 1)])
    wb, lb = car(q)
    reach = 0.5 * (torch.hypot(w[:q], l[:q]) + torch.hypot(wb, lb)) + gap
    a[:q, 4] = phi - torch.atan2(l[:q], w[:q])
    b[:q] = torch.stack([a[:q, 0] + reach * torch.cos(phi),
                         a[:q, 1] + reach * torch.sin(phi), wb, lb,
                         phi + math.pi - torch.atan2(lb, wb)], -1)
    # edge to edge: B beside A along A's width axis, same yaw
    e = slice(q, 2 * q)
    wb, lb = car(q)
    step = 0.5 * (w[e] + wb) + u(-1e-3, 1e-3, q)
    b[e] = torch.stack([a[e, 0] + step * torch.cos(a[e, 4]),
                        a[e, 1] + step * torch.sin(a[e, 4]), wb, lb,
                        a[e, 4]], -1)
    # identical: b[2q:3q] = a[2q:3q] already; contained:
    c = slice(3 * q, n)
    b[c, 2:4] *= 0.5
    b[c, :2] += u(-0.2, 0.2, n - 3 * q, 2)
    return a.float()[None].contiguous(), b.float()[None].contiguous()


def clustered_candidates(n: int, clusters: int, gen) -> torch.Tensor:
    """(1, n, 5) car-sized candidates from ``clusters`` tight clusters over
    the KITTI range, as a detector puts many candidates on each object:
    centres N(cluster, 1 m), the cluster's heading +- 0.1 rad, a third
    turned by pi; a fifth of all pairs share a cluster and most of those
    overlap."""
    centres = torch.stack([20 + 40 * torch.rand(clusters, generator=gen),
                           -30 + 60 * torch.rand(clusters, generator=gen)],
                          -1)
    heading = math.pi * (2 * torch.rand(clusters, generator=gen) - 1)
    which = torch.arange(n) % clusters
    xy = centres[which] + torch.randn(n, 2, generator=gen)
    yaw = heading[which] + 0.1 * torch.randn(n, generator=gen) + math.pi * (
        torch.rand(n, generator=gen) < 1 / 3).float()
    w = 1.6 * torch.exp(0.1 * torch.randn(n, generator=gen))
    l = 3.9 * torch.exp(0.1 * torch.randn(n, generator=gen))
    return torch.stack([xy[:, 0], xy[:, 1], w, l, yaw], -1)[None].contiguous()


BEV5 = (0, 1, 3, 4, 8)  # x, y, w, l, yaw of a 9-number box
TRAIN_CP_GT = 64  # ground-truth slots per cloud of the train step


def train_step_box_pairs(b: int, pc_range, gen):
    """The K4 call of one two-stage train step: (b, 128, 5) proposals against
    (b, 64, 5) ground-truth slots. Half the slots are proposals moved by
    0.1 m (foreground) or 1 m and a little in size and yaw, a quarter are
    other boxes, and the rest are empty slots (all zeros), as a padded
    ground-truth array has them."""
    props = proposal_boxes(b, CP_PROPOSALS, pc_range, gen)
    gt = torch.zeros(b, TRAIN_CP_GT, 9)
    k = TRAIN_CP_GT // 2
    gt[:, :k] = props[:, 1:2 * k:2]  # odd slots: none of the zeroed tenths
    gt[:, 0:k:2, 0] += 0.1
    gt[:, 1:k:2, 0] += 1.0
    gt[:, :k, 3:5] *= 1.05
    gt[:, :k, 8] += 0.02
    gt[:, k:k + k // 2] = proposal_boxes(b, k // 2, pc_range, gen)
    return (props[..., BEV5].contiguous(), gt[..., BEV5].contiguous())


def decode_program_boxes() -> torch.Tensor:
    """The (1, 1000, 5) candidates of the decode program's first iteration
    (``entry.py:decode_candidates_bev`` on ``decode_nms_maps()``), on the
    CPU."""
    from minddet_tpu_torch.entry import (decode_candidates_bev,
                                         decode_nms_maps)

    maps = (torch.from_numpy(m) for m in decode_nms_maps())
    return decode_candidates_bev(*maps, DECODE_CANDIDATES)[1][None]


KITTI_EVAL_CHUNK = (256, 24, 100)  # (frames, GT slots, detection slots)
KITTI_CHUNK_CLASSES = ("Car", "Pedestrian", "Cyclist")


def kitti_eval_chunk(frames: int = KITTI_EVAL_CHUNK[0],
                     slots=KITTI_EVAL_CHUNK[1:], seed: int = 13,
                     metric: str = "bev"):
    """One chunk of the KITTI evaluator's overlap calls (``data/
    kitti_eval.py:calculate_overlaps``) as it pads it: the camera-frame
    labels of ``synthetic_kitti_records(frames)`` (``kitti_gt_anno``:
    DontCare rows at location -1000 with dimensions -1 included) in
    ``slots[0]`` slots, and per frame 1 to ``slots[1]`` detections in
    ``slots[1]`` slots (half jittered labels, heading within 0.2 rad, half
    anywhere 2-60 m ahead), zero-padded; the boxes of ``metric``: for
    "bev" [x, z, l, w, -ry], which is both the bev metric's layout and the
    BEV slice that ``rotated_iou_3d`` gives K4 for the 3d one; for "3d"
    the 7-wide camera boxes. Returns ((frames, slots[0], w), (frames,
    slots[1], w)) on the CPU."""
    from minddet_tpu_torch.data.kitti import kitti_gt_anno
    from minddet_tpu_torch.data.kitti_eval import _metric_boxes
    from minddet_tpu_torch.train.synthetic import synthetic_kitti_records

    slots_g, slots_d = slots
    rs = np.random.RandomState(seed)
    gt = [kitti_gt_anno(r) for r in synthetic_kitti_records(
        frames, seed=seed, classes=KITTI_CHUNK_CLASSES)]
    dt = []
    for g in gt:
        n = rs.randint(1, slots_d + 1)
        real = np.nonzero(g["name"] != "DontCare")[0]
        src = real[rs.randint(0, len(real), n)]
        loc = g["location"][src] + rs.uniform(-0.5, 0.5, (n, 3))
        far = rs.rand(n) < 0.5
        loc[far] = np.stack([rs.uniform(-30, 30, far.sum()),
                             np.full(far.sum(), 1.7),
                             rs.uniform(2, 60, far.sum())], -1)
        dt.append({"location": loc.astype(np.float32),
                   "dimensions": (g["dimensions"][src] * rs.uniform(
                       0.8, 1.2, (n, 3))).astype(np.float32),
                   "rotation_y": (g["rotation_y"][src] + rs.uniform(
                       -0.2, 0.2, n)).astype(np.float32)})
    out = []
    for annos, slots in ((gt, slots_g), (dt, slots_d)):
        boxes = [_metric_boxes(a, metric) for a in annos]
        pad = np.zeros((frames, slots, boxes[0].shape[1]), np.float32)
        for i, b in enumerate(boxes):
            pad[i, :len(b)] = b
        out.append(torch.from_numpy(pad))
    return tuple(out)


def check_rotated_iou_kernel(dev, gen, pc_range):
    """Phase 3: rotated_iou_intersect (K4) against its plain version at the
    rotated NMS's shapes (``IOU_SHAPES``: (B, 900, 5)^2 for PointPillars,
    (6 B, 1000, 5)^2 for CenterPoint), at the two-stage train step's
    (8, 128, 5) x (8, 64, 5) over ``pc_range`` (a quarter of the
    ground-truth slots empty: zero-size boxes), at the KITTI evaluation's
    predict batch (4, 900, 5)^2, at the KITTI evaluator's overlap chunk
    (256, 24, 5) x (256, 100, 5) of camera-frame BEV boxes, the bev and
    the 3d overlaps' one K4 input (``kitti_eval_chunk``: DontCare rows and
    zero-padded rows), at the
    decode program's (1, 1000, 5)^2 on its own candidates
    (``decode_program_boxes``), at ``nuscenes_evaluate``'s batch 2 (six
    tasks: (12, 1000, 5)^2), on pairs that nearly touch
    (``near_touching_boxes``), on one sample of candidates from a few tight
    clusters (``clustered_candidates``) and on the exact cases. Each case
    reports the share of pairs the separation test leaves to the clip, in
    all and per 64 x 64 block, the share that needs a clip (both boxes with
    two nonzero edges: the bound's), and the tile height its wrapper picks
    (``tile_rows``)."""
    from minddet_tpu_torch.ops import rotated_iou as ri

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    exact = torch.tensor(IOU_EXACT_BOXES, device=dev)
    got = ri.rotated_intersection_bev(exact, exact).cpu()
    torch.cuda.synchronize()
    for (i, j), area in IOU_EXACT_AREAS.items():
        if abs(float(got[i, j]) - area) > 1e-4:
            raise AssertionError(f"K4 exact case ({i}, {j}): {float(got[i, j])}"
                                 f" != {area}")
    print(f"  rotated_iou exact cases: {len(IOU_EXACT_AREAS)} areas within "
          f"1e-4", flush=True)
    cases = []
    train_pair = train_step_box_pairs(TRAIN_CP_BATCH, pc_range,
                                      torch.Generator().manual_seed(5))
    shapes = [("candidates", b, n) for b, n in IOU_SHAPES]
    shapes += [("train", TRAIN_CP_BATCH, CP_PROPOSALS),
               ("eval_candidates", KITTI_EVAL_BATCH, PP_CANDIDATES),
               ("kitti_eval", KITTI_EVAL_CHUNK[0], KITTI_EVAL_CHUNK[1]),
               ("decode_nms", 1, DECODE_CANDIDATES),
               ("near_touching", 1, NEAR_PAIRS),
               ("dense_clusters", 1, DENSE_BOXES),
               ("nusc_eval", CP_TASKS * NUSC_EVAL_BATCH, CP_CANDIDATES)]
    for kind, b, n in shapes:
        if kind == "train":
            boxes, others = (t.to(dev) for t in train_pair)
        elif kind == "eval_candidates":  # a generator of its own
            boxes = others = candidate_boxes(
                b, n, torch.Generator().manual_seed(14)).to(dev)
        elif kind == "kitti_eval":
            boxes, others = (t.to(dev) for t in kitti_eval_chunk())
        elif kind == "decode_nms":
            boxes = others = decode_program_boxes().to(dev)
        elif kind == "near_touching":
            boxes, others = (t.to(dev) for t in near_touching_boxes(
                n, torch.Generator().manual_seed(8)))
        elif kind == "dense_clusters":
            boxes = others = clustered_candidates(
                n, DENSE_CLUSTERS, torch.Generator().manual_seed(9)).to(dev)
        elif kind == "nusc_eval":  # a generator of its own
            boxes = others = candidate_boxes(
                b, n, torch.Generator().manual_seed(16)).to(dev)
        else:
            boxes = others = candidate_boxes(b, n, gen).to(dev)
        cases.append(_iou_case(kind, boxes, others, sms))
    return cases


def _iou_case(kind, boxes, others, sms):
    """One phase 3 case of K4 on (b, n, 5) x (b, m, 5) boxes on the card:
    against its plain version (``IOU_TOL``), timed beside it, with its
    bound, its clipped shares and its tile height."""
    from minddet_tpu_torch.ops import rotated_iou as ri

    atol, rtol = IOU_TOL
    b, n = boxes.shape[:2]
    got = ri.rotated_intersection_bev(boxes, others)
    torch.cuda.synchronize()
    ref = ri.rotated_intersection_bev_plain(boxes, others)
    err = (got - ref).abs()
    max_abs = float(err.max())
    ok = bool((err <= atol + rtol * ref.abs()).all())
    overlapping = float((ref > 0).float().mean())
    del got, ref, err
    ms = _cuda_ms(lambda: ri.rotated_intersection_bev(boxes, others),
                  iters=20)
    plain_ms = _cuda_ms(
        lambda: ri.rotated_intersection_bev_plain(boxes, others),
        iters=2, warmup=1)
    bound_ms, bound_by, clipped, needed, per_block = \
        _rotated_iou_bound(boxes, others)
    case = dict(kind=kind, shape=[b, n, 5],
                against=[b, others.shape[1], 5], dtype="float32",
                max_abs_err=max_abs,
                tolerance=f"abs <= {atol} + {rtol} * |plain|",
                overlapping_share=overlapping, clipped_share=clipped,
                clip_needed_share=needed,
                clipped_share_per_block=dict(mean=per_block[0],
                                             max=per_block[1]),
                tile_rows=ri.tile_rows(b, n, others.shape[1], sms),
                ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
    print(f"  rotated_iou {kind} ({b}, {n}, 5) x ({b}, "
          f"{others.shape[1]}, 5) max_abs={max_abs:.3e} "
          f"overlapping={overlapping:.4f} clipped={clipped:.4f} "
          f"needed={needed:.4f} "
          f"per block mean={per_block[0]:.4f} max={per_block[1]:.4f} "
          f"kernel={ms * 1e3:8.1f}us (rows {case['tile_rows']}) "
          f"plain={plain_ms * 1e3:9.1f}us "
          f"bound={bound_ms * 1e3:6.1f}us ({bound_by})", flush=True)
    if not ok:
        raise AssertionError(f"rotated_iou_intersect disagrees with its "
                             f"plain version: {case}")
    return case


PFN_HALF_WIDTH = 32  # the non-last PFN layer's units: K5f's channels
# a width the kernels' 16-byte vectors do not divide in bf16: the non-last
# layer of a 36-filter PFN; the wrappers pad it with zero channels to 24
ODD_PFN_WIDTH = 18


def _nusc_clouds(model, batch: int, seed: int, dev):
    """``batch`` synthetic nuScenes-sized clouds for ``model``, on ``dev``."""
    from minddet_tpu_torch.entry import (NUSC_CLOUD_POINTS,
                                         NUSC_POINT_FEATURES,
                                         synthetic_clouds)

    pts, mask = synthetic_clouds(batch, model.pc_range, NUSC_CLOUD_POINTS,
                                 seed=seed, num_features=NUSC_POINT_FEATURES)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)


def clustered_values(shape, dgen, dev, nan: bool = False) -> torch.Tensor:
    """f32 values drawn from {-0, 0, 1, 2} (and NaN where ``nan``): ties in
    every long segment, and zero maxima whose sign the order of the max
    decides."""
    vals = torch.tensor([-0.0, 0.0, 1.0, 2.0] + ([math.nan] if nan else []),
                        device=dev)
    return vals[torch.randint(0, len(vals), shape, generator=dgen,
                              device=dev)]


def seg_fwd_streams(dev, model, shapes=None, clouds=None, values=None):
    """K5f's phase 3 inputs, case by case: (b, dtype, c, sv, x), the
    streams the port's voxelizer makes of ``model``'s clouds
    (``clouds(model, batch, seed, dev)``; by default ``_nusc_clouds``'
    120,000 points: pillars over the point cap, more pillars than
    ``max_voxels``), at ``shapes`` (b, dtype, c): by default the serving
    batches and ``nuscenes_evaluate``'s batch 2 in f32 and the train step's
    batch 8 in bf16. x is N(0, 1), so the kernel's zeros outside the kept
    rows show, or ``values(shape, dgen, dev)`` in f32, cast to the case's
    type."""
    from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch

    shapes = shapes or ((1, torch.float32, PFN_HALF_WIDTH),
                        (CP_BATCHES[-1], torch.float32, PFN_HALF_WIDTH),
                        (1, torch.bfloat16, PFN_HALF_WIDTH),
                        (TRAIN_CP_BATCH, torch.bfloat16, PFN_HALF_WIDTH),
                        (TRAIN_CP_BATCH, torch.bfloat16, ODD_PFN_WIDTH),
                        (NUSC_EVAL_BATCH, torch.float32, PFN_HALF_WIDTH))
    clouds = clouds or _nusc_clouds
    values = values or (lambda shape, dgen, dev: torch.randn(
        shape, generator=dgen, device=dev))
    bound = model.max_points_per_voxel
    dgen = torch.Generator(device=dev).manual_seed(2)
    for b, dtype, c in shapes:
        points, mask = clouds(model, b, 2, dev)
        sv = voxelize_stream_batch(points, mask, model.voxel_size,
                                   model.pc_range, model.max_voxels, bound,
                                   model.voxel_drop_order)
        n = sv.first.shape[1]
        yield b, dtype, c, sv, values((b, n, c), dgen, dev).to(dtype)


def check_seg_max_kernel(dev, model, shapes=None, clouds=None, stream=None,
                         values=None):
    """Phase 3: seg_full_max (K5f) against its plain version, exactly, on
    ``seg_fwd_streams(dev, model, shapes, clouds, values)``. ``stream``
    names the clouds in each case."""
    from minddet_tpu_torch.ops import seg_max as sm

    bound = model.max_points_per_voxel
    cases = []
    for b, dtype, c, sv, x in seg_fwd_streams(dev, model, shapes, clouds,
                                              values):
        first, last = sv.first, sv.last
        n = first.shape[1]
        if not torch.equal(sm.seg_covered(first, last, bound), sv.keep):
            raise AssertionError("seg_covered is not the stream's keep mask")
        got = sm.seg_full_max_bounded(first, last, x, bound)
        torch.cuda.synchronize()
        ref = sm.seg_full_max_bounded_plain(first, last, x, bound)
        max_abs = float((got.float() - ref.float()).abs().max())
        ok = torch.equal(got, ref)
        kept = float(sv.keep.float().mean())
        del got, ref
        ms = _cuda_ms(lambda: sm.seg_full_max_bounded(first, last, x, bound),
                      iters=20)
        plain_ms = _cuda_ms(
            lambda: sm.seg_full_max_bounded_plain(first, last, x, bound),
            iters=3, warmup=1)
        bound_ms, bound_by = _seg_fwd_bound(x, sv.keep)
        case = dict(shape=[b, n, c], bound=bound,
                    dtype=str(dtype).replace("torch.", ""),
                    max_abs_err=max_abs, tolerance="exact", kept_share=kept,
                    pillars=sv.num_voxels.tolist(), ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
        if c != PFN_HALF_WIDTH:
            padded = sm.pad_channels(x[:, :1]).shape[-1]
            case["stream"] = f"C={c}, padded to {padded}"
        if stream:
            case["stream"] = stream
        cases.append(case)
        print(f"  seg_full_max x{case['shape']} {case['dtype']:8s} "
              f"{stream or ''} max_abs="
              f"{max_abs:.3e} kept rows {kept:.3f} kernel={ms * 1e3:8.1f}us "
              f"plain={plain_ms * 1e3:9.1f}us bound={bound_ms * 1e3:6.1f}us "
              f"({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"seg_full_max disagrees with its plain "
                                 f"version: {case}")
    return cases


def _seg_fwd_bound(x, keep):
    """(bound_ms, bound_by) of K5f on these inputs: x read once where its
    row is kept (the other rows' out is 0 and needs no read), out written
    once, the two flag planes read once; one max per kept value."""
    b, n, c = x.shape
    kept_values = int(keep.sum()) * c
    return _bound((kept_values + x.numel()) * x.element_size() + 2 * b * n,
                  kept_values)


def proposal_boxes(b: int, n: int, pc_range, gen) -> torch.Tensor:
    """(b, n, 9) boxes [x, y, z, w, l, h, vx, vy, yaw] like a request's
    stage-1 detections: centres uniform over the range widened by 5 m (so
    some sample points fall off the map), vehicle sizes, any yaw, and every
    tenth box all zeros (a dropped slot, which is sampled all the same)."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    boxes = torch.zeros(b, n, 9)
    boxes[..., 0] = u(pc_range[0] - 5.0, pc_range[3] + 5.0, b, n)
    boxes[..., 1] = u(pc_range[1] - 5.0, pc_range[4] + 5.0, b, n)
    boxes[..., 3] = 1.9 * torch.exp(0.2 * torch.randn(b, n, generator=gen))
    boxes[..., 4] = 4.5 * torch.exp(0.2 * torch.randn(b, n, generator=gen))
    boxes[..., 5] = 1.7
    boxes[..., 8] = u(-math.pi, math.pi, b, n)
    boxes[:, ::10] = 0.0
    return boxes


# K3f vs plain: f32 sums of four products, in another order (FMAs in the
# kernel); bf16 is that f32 sum rounded once (half an ulp, 2**-9 relative),
# with room for the order flipping a rounding
GATHER_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-5, 2 ** -8)}


def check_bilinear_kernel(dev, gen, model, batches=None):
    """Phase 3: bilinear_gather_fwd (K3f) against its plain version at the
    second stage's shapes: ``model``'s BEV map (B, 128 * 128, 384) and 5
    sample points for each of its 6 * 83 detection slots (2490 points) at
    the serving batches and ``nuscenes_evaluate``'s batch 2, and for each
    of the train step's 128 proposals (640 points) at its batch 8; with the
    time of ``F.grid_sample`` (bilinear, zero padding, align_corners) on
    the same map and points. ``batches`` (b, slots, generator) replace those
    shapes where given."""
    import torch.nn.functional as F

    from minddet_tpu_torch.models.heads.second_stage import bev_sample_points
    from minddet_tpu_torch.ops import bilinear as bl

    h = model.grid_ny // model.out_size_factor
    w = model.grid_nx // model.out_size_factor
    c = model.rpn.out_channels
    serve_slots = len(model.task_num_classes) * CP_NMS_POST
    cell_x = model.voxel_size[0] * model.out_size_factor
    cell_y = model.voxel_size[1] * model.out_size_factor
    cases = []
    train_gen = torch.Generator().manual_seed(6)
    batches = batches or tuple((b, serve_slots, gen) for b in CP_BATCHES) + (
        (TRAIN_CP_BATCH, CP_PROPOSALS, train_gen),
        (NUSC_EVAL_BATCH, serve_slots, torch.Generator().manual_seed(15)))
    for b, slots, rng in batches:
        bev32 = torch.randn(b, c, h, w, generator=rng).to(dev).contiguous(
            memory_format=torch.channels_last)
        boxes = proposal_boxes(b, slots, model.pc_range, rng).to(dev)
        pts = bev_sample_points(boxes).reshape(b, slots * 5, 2)
        fx = (pts[..., 0] - model.pc_range[0]) / cell_x
        fy = (pts[..., 1] - model.pc_range[1]) / cell_y
        ci, cw = bl.bilinear_corners(fy, fx, h, w)
        p = ci.shape[1]
        off_map = float((ci < 0).float().mean())
        touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                      for i in range(b))
        grid = torch.stack([2 * fx / (w - 1) - 1, 2 * fy / (h - 1) - 1],
                           -1)[:, None]
        for dtype in (torch.float32, torch.bfloat16):
            bev = bev32.to(dtype)
            x = bev.permute(0, 2, 3, 1).view(b, h * w, c)
            got = bl.bilinear_gather(x, ci, cw)
            torch.cuda.synchronize()
            ref = bl.bilinear_gather_plain(x.float(), ci, cw)
            err = (got.float() - ref).abs()
            max_abs = float(err.max())
            name = str(dtype).replace("torch.", "")
            atol, rtol = GATHER_TOL[name]
            ok = bool((err <= atol + rtol * ref.abs()).all())
            # the second stage's own call gives the same rows
            via_model = model.extractor(bev, boxes).reshape(b, p, c)
            ok_model = torch.equal(via_model, got)
            # grid_sample takes the grid in the map's type, so in bf16 it
            # samples at rounded coordinates: timed, not compared
            lib_err = None
            if dtype == torch.float32:
                lib = F.grid_sample(bev, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)
                lib_err = float((lib[:, :, 0].permute(0, 2, 1) - ref).abs()
                                .max())
                del lib
            del got, ref, err, via_model
            ms = _cuda_ms(lambda: bl.bilinear_gather(x, ci, cw), iters=50)
            plain_ms = _cuda_ms(lambda: bl.bilinear_gather_plain(x, ci, cw),
                                iters=5, warmup=1)
            g = grid.to(dtype)
            library_ms = _cuda_ms(
                lambda: F.grid_sample(bev, g, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True), iters=20)
            # out written once, the rows the corners touch read once, ci
            # and cw read once; 4 FMAs per output value
            elt = x.element_size()
            bound_ms, bound_by = _bound(
                b * p * c * elt + touched * c * elt + 2 * b * p * 4 * 4,
                8 * b * p * c)
            case = dict(shape=[b, h * w, c], points=p, dtype=name,
                        max_abs_err=max_abs,
                        tolerance=f"abs <= {atol} + {rtol} * |plain f32|",
                        off_map_corner_share=off_map, touched_rows=touched,
                        library_max_abs_err=lib_err, ms=ms,
                        plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            cases.append(case)
            print(f"  bilinear_gather x{case['shape']} P={p} {name:8s} "
                  f"max_abs={max_abs:.3e} off-map corners {off_map:.3f} "
                  f"kernel={ms * 1e3:7.1f}us plain={plain_ms * 1e3:8.1f}us "
                  f"grid_sample={library_ms * 1e3:7.1f}us (differs by "
                  f"{lib_err}) bound={bound_ms * 1e3:5.1f}us ({bound_by})",
                  flush=True)
            if not (ok and ok_model):
                raise AssertionError(
                    f"bilinear_gather_fwd disagrees with its plain version "
                    f"(kernel {ok}, through the extractor {ok_model}): "
                    f"{case}")
    return cases


def _clustered_clouds(model, batch: int, seed: int, dev):
    """``batch`` clouds of 120,000 points drawn around 4,000 pillar centres
    each (30 points per pillar on average, so most pillars pass the cap of
    20 points and have rows past their last kept row)."""
    import numpy as np

    from minddet_tpu_torch.entry import (NUSC_CLOUD_POINTS,
                                         NUSC_POINT_FEATURES)

    rs = np.random.RandomState(seed)
    x0, y0, z0, x1, y1, z1 = model.pc_range
    cells = rs.randint(0, model.grid_nx * model.grid_ny, (batch, 4000))
    pick = rs.randint(0, 4000, (batch, NUSC_CLOUD_POINTS))
    cell = np.take_along_axis(cells, pick, 1)
    inside = rs.uniform(0.05, 0.95, (batch, NUSC_CLOUD_POINTS, 2))
    pts = np.zeros((batch, NUSC_CLOUD_POINTS, NUSC_POINT_FEATURES), np.float32)
    pts[..., 0] = x0 + (cell % model.grid_nx + inside[..., 0]) \
        * model.voxel_size[0]
    pts[..., 1] = y0 + (cell // model.grid_nx + inside[..., 1]) \
        * model.voxel_size[1]
    pts[..., 2] = rs.uniform(z0, z1, (batch, NUSC_CLOUD_POINTS))
    pts[..., 3:] = rs.uniform(0, 0.45, (batch, NUSC_CLOUD_POINTS,
                                        NUSC_POINT_FEATURES - 3))
    return (torch.from_numpy(pts).to(dev),
            torch.ones(batch, NUSC_CLOUD_POINTS, dtype=torch.bool,
                       device=dev))


# K5b vs plain, err <= atol + rtol * |plain|. Both sum g in f32, the kernel
# row by row from the last kept row back, the plain version by shift levels:
# segments of one or two rows give the same bits; longer ones differ by f32
# rounding, and in bf16 that may flip the one rounding of the result
SEG_BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}


def seg_bwd_streams(dev, model, streams=None, clouds=None):
    """K5b's phase 3 inputs, case by case: (b, dtype, kind, c, sv, x, g).
    By default uniform clouds (the main path's; ~1.25 kept points per
    pillar, x ~ N(0, 1), no ties) and clustered clouds with x in {0, 1, 2}
    (pillars at the cap of 20 rows, ties in every segment), at batch 1,
    the train step's 8 and the nuScenes config's f32 batch 4; at each main
    path's shape also a g that is the second half of a (b, n, 2c) tensor,
    as the stream PFN's cat hands it to the backward ("strided g").
    ``clouds(model, batch, seed, dev)`` makes the clouds of the streams that
    are not clustered (``_nusc_clouds`` by default)."""
    from minddet_tpu_torch.ops.voxelize import voxelize_stream_batch

    streams = streams or (
        (1, torch.float32, "uniform", PFN_HALF_WIDTH),
        (1, torch.bfloat16, "uniform", PFN_HALF_WIDTH),
        (TRAIN_CP_BATCH, torch.bfloat16, "uniform", PFN_HALF_WIDTH),
        (1, torch.float32, "clustered, ties", PFN_HALF_WIDTH),
        (1, torch.bfloat16, "clustered, ties", PFN_HALF_WIDTH),
        (TRAIN_CP_BATCH, torch.bfloat16, f"uniform, C={ODD_PFN_WIDTH}",
         ODD_PFN_WIDTH),
        (NUSC_TRAIN_BATCH, torch.float32, "uniform", PFN_HALF_WIDTH),
        (TRAIN_CP_BATCH, torch.bfloat16, "uniform, strided g",
         PFN_HALF_WIDTH),
        (NUSC_TRAIN_BATCH, torch.float32, "uniform, strided g",
         PFN_HALF_WIDTH))
    bound = model.max_points_per_voxel
    dgen = torch.Generator(device=dev).manual_seed(3)
    for b, dtype, kind, c in streams:
        cloud_fn = (_clustered_clouds if kind.startswith("clustered")
                    else clouds or _nusc_clouds)
        points, mask = cloud_fn(model, b, 3, dev)
        sv = voxelize_stream_batch(points, mask, model.voxel_size,
                                   model.pc_range, model.max_voxels, bound,
                                   model.voxel_drop_order)
        n = sv.first.shape[1]
        shape = (b, n, c)
        if not kind.startswith("clustered"):
            x = torch.randn(shape, generator=dgen, device=dev).to(dtype)
        else:
            x = torch.randint(0, 3, shape, generator=dgen,
                              device=dev).to(dtype)
        if kind.endswith("strided g"):
            g = torch.randn((b, n, 2 * c), generator=dgen,
                            device=dev).to(dtype)[..., c:]
        else:
            g = torch.randn(shape, generator=dgen, device=dev).to(dtype)
        yield b, dtype, kind, c, sv, x, g


def check_seg_max_bwd_kernel(dev, model, streams=None, clouds=None):
    """Phase 3: seg_full_max_bwd (K5b) against its plain version on the
    streams of ``seg_bwd_streams``. Rows of segments with at most two kept
    rows, and rows that are not kept, must agree exactly; the others within
    ``SEG_BWD_TOL``. A strided g must give the bits of the same g made
    contiguous; its case times the kernel on the contiguous g (``ms``) and
    the route, the wrapper on g as the cat hands it (``route_ms``). Each
    case reports the share of the kernel's tiles with no covered row."""
    from minddet_tpu_torch.ops import seg_max as sm
    from minddet_tpu_torch.ops.voxelize import (_seg_bcast_bounded,
                                                _seg_sum_bounded)

    bound = model.max_points_per_voxel
    cases = []
    for b, dtype, kind, c, sv, x, g in seg_bwd_streams(dev, model, streams,
                                                       clouds):
        first, last = sv.first, sv.last
        n = first.shape[1]
        shape = (b, n, c)
        tile = sm.seg_max_bwd_plan(b, n, sm.pad_channels(x[:1, :1]).shape[-1],
                                   dtype, bound)["tile_rows"]
        m = sm.seg_full_max_bounded(first, last, x, bound)
        got = sm.seg_full_max_bounded_bwd(first, last, x, m, g, bound)
        torch.cuda.synchronize()
        ref = sm.seg_full_max_bounded_bwd_plain(first, last, x, m, g, bound)
        gc = g.contiguous()
        same_as_contiguous = True
        if not g.is_contiguous():
            same_as_contiguous = torch.equal(
                got, sm.seg_full_max_bounded_bwd(first, last, x, m, gc,
                                                 bound))
        rows = _seg_bcast_bounded(last, _seg_sum_bounded(
            first, sv.keep.float(), bound), bound)  # kept rows per segment
        short = ~sv.keep | (rows <= 2)
        err = (got.float() - ref.float()).abs()
        name = str(dtype).replace("torch.", "")
        atol, rtol = SEG_BWD_TOL[name]
        ok = (torch.equal(got[short], ref[short]) and same_as_contiguous
              and bool((err <= atol + rtol * ref.float().abs()).all()))
        tie = (x == m) & sv.keep[..., None]
        tied = tie & (_seg_bcast_bounded(last, _seg_sum_bounded(
            first, tie.float(), bound), bound) > 1)
        covered = torch.nn.functional.pad(
            sm.seg_covered(first, last, bound), (0, -n % tile))
        case = dict(shape=list(shape), bound=bound, dtype=name, stream=kind,
                    max_abs_err=float(err.max()),
                    tolerance=f"exact on segments of <= 2 rows, else abs <= "
                              f"{atol} + {rtol} * |plain|",
                    kept_share=float(sv.keep.float().mean()),
                    long_segment_row_share=float((~short).float().mean()),
                    tied_value_share=float(tied.float().mean()),
                    tile_rows=tile, empty_tile_share=float(
                        (~covered.view(b, -1, tile).any(-1)).float().mean()))
        del got, ref, err, rows, short, tie, tied, covered
        case["ms"] = _cuda_ms(lambda: sm.seg_full_max_bounded_bwd(
            first, last, x, m, gc, bound), iters=20)
        if not g.is_contiguous():
            case["route_ms"] = _cuda_ms(lambda: sm.seg_full_max_bounded_bwd(
                first, last, x, m, g, bound), iters=20)
        case["plain_ms"] = _cuda_ms(
            lambda: sm.seg_full_max_bounded_bwd_plain(first, last, x, m, gc,
                                                      bound),
            iters=3, warmup=1)
        # x and g read once where their row is kept (a row that is not kept
        # has dx 0; m is the max of x values read anyway), dx written once,
        # the two flag planes read once; an add and a compare per kept value
        kept_values = int(sv.keep.sum()) * c
        case["bound_ms"], case["bound_by"] = _bound(
            (2 * kept_values + x.numel()) * x.element_size() + 2 * b * n,
            2 * kept_values)
        cases.append(case)
        route = (f" route={case['route_ms'] * 1e3:8.1f}us"
                 if "route_ms" in case else "")
        print(f"  seg_full_max_bwd x{case['shape']} {name:8s} {kind:18s} "
              f"max_abs={case['max_abs_err']:.3e} rows in segments > 2: "
              f"{case['long_segment_row_share']:.3f} tied values: "
              f"{case['tied_value_share']:.3f} empty tiles: "
              f"{case['empty_tile_share']:.3f} kernel="
              f"{case['ms'] * 1e3:8.1f}us{route} plain="
              f"{case['plain_ms'] * 1e3:9.1f}us bound="
              f"{case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']})",
              flush=True)
        if not ok:
            raise AssertionError(f"seg_full_max_bwd disagrees with its plain "
                                 f"version (or a strided g with the same g "
                                 f"contiguous): {case}")
        del m, gc
    return cases


# K3dx and K3dcw vs plain: err <= atol + rtol * (the same sum over absolute
# values). dx sums up to ~25 weighted g rows per map row with f32 atomics,
# in an order that changes from run to run; in bf16 the f32 sum is rounded
# once (2**-9 relative), with room for the order flipping that rounding.
# dcw sums 384 f32 products per corner in another order than the plain
# version's.
GATHER_BWD_TOL = {"dx_float32": (1e-6, 1e-5), "dx_bfloat16": (1e-6, 2 ** -8),
                  "dcw": (1e-6, 1e-5)}


def _second_stage_inputs(model, b, gen, dev, slots=CP_PROPOSALS):
    """A random BEV map (B, C, H, W) of ``model`` in channels_last memory
    and the map coordinates (fy, fx) (B, 5 * slots) of ``proposal_boxes``'
    sample points."""
    from minddet_tpu_torch.models.heads.second_stage import bev_sample_points

    h = model.grid_ny // model.out_size_factor
    w = model.grid_nx // model.out_size_factor
    c = model.rpn.out_channels
    bev = torch.randn(b, c, h, w, generator=gen).to(dev).contiguous(
        memory_format=torch.channels_last)
    boxes = proposal_boxes(b, slots, model.pc_range, gen).to(dev)
    pts = bev_sample_points(boxes).reshape(b, slots * 5, 2)
    fx = (pts[..., 0] - model.pc_range[0]) / (
        model.voxel_size[0] * model.out_size_factor)
    fy = (pts[..., 1] - model.pc_range[1]) / (
        model.voxel_size[1] * model.out_size_factor)
    return bev, fy, fx


DUPLICATE_SPOTS = 4  # map positions of the heavy-duplicate stream


def _duplicate_points(fy, fx):
    """Every sample point on one of DUPLICATE_SPOTS positions two cells
    apart along one map row, off-grid: all 4 * P corners of an image land
    in two map rows, 2 * P of them in one bucket of K3dx's row tiles."""
    spot = torch.arange(fy.shape[1], device=fy.device) % DUPLICATE_SPOTS
    ys = torch.full_like(fy, 40.37)
    xs = 70.61 + 2.0 * spot.to(fx.dtype).expand_as(fx)
    return ys, xs.contiguous()


def check_bilinear_bwd_kernels(dev, gen, model):
    """Phase 3: bilinear_gather_bwd_dx (K3dx) and bilinear_gather_bwd_dcw
    (K3dcw) against their plain versions at the train step's shapes:
    ``model``'s BEV map (B, 128 * 128, 384) and 5 sample points for each of
    its 128 proposals (640 points, some off the map); with the time of
    ``index_add_`` into a zeroed f32 map beside K3dx."""
    from minddet_tpu_torch.ops import bilinear as bl

    dx_cases, dcw_cases = [], []
    for b, stream in ((1, "uniform"), (TRAIN_CP_BATCH, "uniform"),
                      (TRAIN_CP_BATCH, "duplicate")):
        bev32, fy, fx = _second_stage_inputs(model, b, gen, dev)
        _, c, h, w = bev32.shape
        hw = h * w
        if stream == "duplicate":
            fy, fx = _duplicate_points(fy, fx)
        ci, cw = bl.bilinear_corners(fy, fx, h, w)
        p = ci.shape[1]
        g32 = torch.randn(b, p, c, generator=gen).to(dev)
        touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                      for i in range(b))
        rows = (bl._clipped_rows(ci, hw) + torch.arange(
            b, device=dev)[:, None] * hw).reshape(-1)
        plan = bl.gather_bwd_dx_plan(b, hw, c, p)
        # hw is a whole number of row tiles here
        tile_of = rows[(ci >= 0).reshape(-1)] // plan["tile_rows"]
        common = dict(shape=[b, hw, c], points=p, stream=stream,
                      touched_rows=touched,
                      off_map_corner_share=float((ci < 0).float().mean()))
        dx_plan = dict(largest_bucket=int(torch.bincount(tile_of).max()),
                       sort_cap=plan["cap"], smem_bytes=plan["smem_bytes"])
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            x = bev32.to(dtype).permute(0, 2, 3, 1).view(b, hw, c)
            g = g32.to(dtype)
            elt = x.element_size()

            got = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
            again = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
            torch.cuda.synchronize()
            repeat = torch.equal(got, again)
            del again
            ref = bl.bilinear_gather_bwd_dx_plain(g.float(), ci, cw, hw)
            size = bl.bilinear_gather_bwd_dx_plain(g.float().abs(), ci,
                                                   cw.abs(), hw)
            err = (got.float() - ref).abs()
            atol, rtol = GATHER_BWD_TOL[f"dx_{name}"]
            ok = got.dtype == dtype and repeat and bool(
                (err <= atol + rtol * size).all())
            case = dict(common, **dx_plan, dtype=name,
                        max_abs_err=float(err.max()),
                        max_abs=float(ref.abs().max()), repeat=repeat,
                        tolerance=f"abs <= {atol} + {rtol} * sum |cw g|; "
                                  f"bit-equal between two calls")
            del got, ref, size, err
            case["ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dx(g, x, ci, cw), iters=20)
            case["plain_ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dx_plain(g, ci, cw, hw),
                iters=5, warmup=1)
            contrib = ((cw * (ci >= 0))[..., None]
                       * g.float()[:, :, None, :]).reshape(-1, c)
            case["library_ms"] = _cuda_ms(
                lambda: torch.zeros(b * hw, c, device=dev).index_add_(
                    0, rows, contrib), iters=20)
            del contrib
            # dx (the whole map, in x's type) written once, g read once, ci
            # and cw read once; 4 multiply-adds per g value
            case["bound_ms"], case["bound_by"] = _bound(
                b * hw * c * elt + b * p * c * elt + 2 * b * p * 4 * 4,
                8 * b * p * c)
            dx_cases.append(case)
            print(f"  bilinear_gather_bwd_dx x{case['shape']} P={p} {stream}"
                  f" {name:8s} max_abs={case['max_abs_err']:.3e} repeat="
                  f"{repeat} bucket<={case['largest_bucket']} (|dx| max "
                  f"{case['max_abs']:.1f}) kernel={case['ms'] * 1e3:7.1f}us "
                  f"plain={case['plain_ms'] * 1e3:8.1f}us index_add_="
                  f"{case['library_ms'] * 1e3:7.1f}us bound="
                  f"{case['bound_ms'] * 1e3:5.1f}us ({case['bound_by']})",
                  flush=True)
            if not ok:
                raise AssertionError(f"bilinear_gather_bwd_dx disagrees with "
                                     f"its plain version: {case}")

            got = bl.bilinear_gather_bwd_dcw(g, x, ci, cw)
            torch.cuda.synchronize()
            ref = bl.bilinear_gather_bwd_dcw_plain(g.float(), x.float(), ci)
            size = bl.bilinear_gather_bwd_dcw_plain(g.float().abs(),
                                                    x.float().abs(), ci)
            err = (got - ref).abs()
            atol, rtol = GATHER_BWD_TOL["dcw"]
            ok = (bool((err <= atol + rtol * size).all())
                  and bool((got[ci < 0] == 0).all()))
            case = dict(common, dtype=name, max_abs_err=float(err.max()),
                        max_abs=float(ref.abs().max()),
                        tolerance=f"abs <= {atol} + {rtol} * sum |g x|")
            del got, ref, size, err
            case["ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dcw(g, x, ci, cw), iters=50)
            case["plain_ms"] = _cuda_ms(
                lambda: bl.bilinear_gather_bwd_dcw_plain(g, x, ci), iters=5,
                warmup=1)
            # g read once, the rows of x the corners touch read once, ci
            # read and dcw written once; 4 multiply-adds per g value
            case["bound_ms"], case["bound_by"] = _bound(
                b * p * c * elt + touched * c * elt + 2 * b * p * 4 * 4,
                8 * b * p * c)
            dcw_cases.append(case)
            print(f"  bilinear_gather_bwd_dcw x{case['shape']} P={p} "
                  f"{stream} {name:8s} max_abs={case['max_abs_err']:.3e} (|dcw| max "
                  f"{case['max_abs']:.1f}) kernel={case['ms'] * 1e3:7.1f}us "
                  f"plain={case['plain_ms'] * 1e3:8.1f}us bound="
                  f"{case['bound_ms'] * 1e3:5.1f}us ({case['bound_by']})",
                  flush=True)
            if not ok:
                raise AssertionError(f"bilinear_gather_bwd_dcw disagrees "
                                     f"with its plain version: {case}")
    return dx_cases, dcw_cases


WARP_MAP = (480, 640, 3)  # a COCO image: the map of CenterNet's input warp
WARP_OUT = 512  # the warp's output side (512 x 512 sample points)


def check_bilinear_narrow(dev):
    """Phase 3: K3f, K3dx and K3dcw at C = 3, the width of CenterNet's input
    warp (``data/transforms.py:warp_images`` of the reference: a 480 x 640
    RGB image sampled at the 512 x 512 points of an output-to-input affine,
    scale 1.25, turned by 0.1 rad, some points off the image), in f32 and
    bf16. The wrappers pad the channels with zeros to 4 (f32) or 8 (bf16)
    and slice the result back to 3; held to the tolerances of the wide
    cases (``GATHER_TOL``, ``GATHER_BWD_TOL``). Returns the (K3f, K3dx,
    K3dcw) cases."""
    from minddet_tpu_torch.ops import bilinear as bl

    gen = torch.Generator().manual_seed(10)

    h, w, c = WARP_MAP
    oy, ox = torch.meshgrid(torch.arange(WARP_OUT, dtype=torch.float32),
                            torch.arange(WARP_OUT, dtype=torch.float32),
                            indexing="ij")
    scale, turn = max(h, w) / WARP_OUT, 0.1
    xs = scale * (math.cos(turn) * ox - math.sin(turn) * oy) + 20.3
    ys = scale * (math.sin(turn) * ox + math.cos(turn) * oy) - 30.7
    ci, cw = bl.bilinear_corners(ys.reshape(1, -1).to(dev),
                                 xs.reshape(1, -1).to(dev), h, w)
    p = ci.shape[1]
    touched = int(torch.unique(ci[ci >= 0]).numel())
    fwd, dxs, dcws = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        x = torch.rand(1, h * w, c, generator=gen).to(dev, dtype)
        g = torch.randn(1, p, c, generator=gen).to(dev, dtype)
        elt = x.element_size()
        common = dict(shape=[1, h * w, c], points=p, dtype=name,
                      stream="warp",
                      off_map_corner_share=float((ci < 0).float().mean()))
        runs = (
            ("bilinear_gather", fwd, lambda: bl.bilinear_gather(x, ci, cw),
             lambda: bl.bilinear_gather_plain(x.float(), ci, cw),
             lambda: bl.bilinear_gather_plain(x.float().abs(), ci, cw.abs()),
             GATHER_TOL[name],
             # out written, touched rows and the corners read once
             p * c * elt + touched * c * elt + 2 * p * 4 * 4),
            ("bilinear_gather_bwd_dx", dxs,
             lambda: bl.bilinear_gather_bwd_dx(g, x, ci, cw),
             lambda: bl.bilinear_gather_bwd_dx_plain(g.float(), ci, cw, h * w),
             lambda: bl.bilinear_gather_bwd_dx_plain(g.float().abs(), ci,
                                                     cw.abs(), h * w),
             GATHER_BWD_TOL[f"dx_{name}"],
             # dx written, g and the corners read once
             h * w * c * elt + p * c * elt + 2 * p * 4 * 4),
            ("bilinear_gather_bwd_dcw", dcws,
             lambda: bl.bilinear_gather_bwd_dcw(g, x, ci, cw),
             lambda: bl.bilinear_gather_bwd_dcw_plain(g.float(), x.float(),
                                                      ci),
             lambda: bl.bilinear_gather_bwd_dcw_plain(g.float().abs(),
                                                      x.float().abs(), ci),
             GATHER_BWD_TOL["dcw"],
             # g, the touched rows and ci read, dcw written once
             p * c * elt + touched * c * elt + 2 * p * 4 * 4))
        for label, out, kernel, plain, size, (atol, rtol), nbytes in runs:
            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (got.float() - ref).abs()
            terms = size()
            ok = (got.shape == ref.shape and got.is_contiguous()
                  and bool((err <= atol + rtol * terms).all()))
            # relative to the sum of absolute terms, where it is not 0
            case = dict(common, max_abs_err=float(err.max()),
                        max_rel_err=float((err / terms)[terms > 0].max()),
                        tolerance=f"abs <= {atol} + {rtol} * |terms|")
            del got, ref, err, terms
            case["ms"] = _cuda_ms(kernel, iters=20)
            case["plain_ms"] = _cuda_ms(plain, iters=5, warmup=1)
            # 4 multiply-adds per value of g or of the output
            case["bound_ms"], case["bound_by"] = _bound(nbytes, 8 * p * c)
            out.append(case)
            print(f"  {label} x{case['shape']} P={p} {name:8s} (padded to "
                  f"{bl.pad_channels(x[:, :1]).shape[-1]}) max_abs="
                  f"{case['max_abs_err']:.3e} max_rel="
                  f"{case['max_rel_err']:.3e} kernel={case['ms'] * 1e3:7.1f}"
                  f"us plain={case['plain_ms'] * 1e3:8.1f}us bound="
                  f"{case['bound_ms'] * 1e3:5.1f}us ({case['bound_by']})",
                  flush=True)
            if not ok:
                raise AssertionError(f"{label} at C = {c} disagrees with its "
                                     f"plain version: {case}")
    return fwd, dxs, dcws


# the R-CNN's ROIAlign (phases 3, 4e, 4f, 6h, 6i): a 512 x 512 request's
# FPN levels P2-P5, C = 256; the box head's 512 proposals x 7 x 7 bins and
# the mask head's 100 detections x 14 x 14, 2 x 2 samples a bin
RCNN_STRIDES = (4, 8, 16, 32)
RCNN_C = 256
RCNN_ROI_SETS = (("box", 512, (7, 7)), ("mask", 100, (14, 14)))
RCNN_BATCHES = (1, 8)


def rcnn_rois(b: int, r: int, gen, res: int = 512) -> torch.Tensor:
    """(b, r, 4) rois drawn like a 512 x 512 request's proposals: sizes
    log-uniform over 4-512 px, centres uniform, clipped to the image;
    every tenth roi a zero-padded slot and every tenth but one zero-area."""
    wh = torch.exp(math.log(4) + math.log(res / 4) * torch.rand(
        b, r, 2, generator=gen))
    xy = res * torch.rand(b, r, 2, generator=gen) - wh / 2
    rois = torch.cat([xy, xy + wh], -1).clamp(0, res)
    rois[:, ::10] = 0.0
    rois[:, 1::10, 2:] = rois[:, 1::10, :2]
    return rois


def check_rcnn_gather(dev):
    """Phase 3: bilinear_gather_fwd (K3f) at the R-CNN's ROIAlign shapes,
    batch 1 and 8, f32 and bf16: each FPN level's map (B, 128^2 / 64^2 /
    32^2 / 16^2, 256) sampled at the box head's 512 x 196 points per image
    and the mask head's 100 x 784, rois drawn like proposals
    (``rcnn_rois``), against the plain version (``GATHER_TOL``), with
    ``F.grid_sample`` (bilinear, zero padding, align_corners) timed beside
    it on the same map and points, and the byte bound from the rows the
    corners touch."""
    import torch.nn.functional as F

    from minddet_tpu_torch.ops import bilinear as bl
    from minddet_tpu_torch.ops import roi_align as ra

    gen = torch.Generator().manual_seed(11)
    cases = []
    for b in RCNN_BATCHES:
        for kind, r, size in RCNN_ROI_SETS:
            boxes = rcnn_rois(b, r, gen).to(dev)
            for stride in RCNN_STRIDES:
                side = 512 // stride
                ys, xs = ra.roi_sample_points(boxes / stride, size)
                ci, cw = bl.bilinear_corners(ys, xs, side, side)
                p = ci.shape[1]
                touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                              for i in range(b))
                grid = torch.stack([2 * xs / (side - 1) - 1,
                                    2 * ys / (side - 1) - 1], -1)[:, None]
                fmap32 = torch.randn(b, RCNN_C, side, side,
                                     generator=gen).to(dev).contiguous(
                                         memory_format=torch.channels_last)
                for dtype in (torch.float32, torch.bfloat16):
                    name = str(dtype).replace("torch.", "")
                    fmap = fmap32.to(dtype)
                    x = fmap.permute(0, 2, 3, 1).view(b, side * side, RCNN_C)
                    got = bl.bilinear_gather(x, ci, cw)
                    torch.cuda.synchronize()
                    ref = bl.bilinear_gather_plain(x.float(), ci, cw)
                    err = (got.float() - ref).abs()
                    atol, rtol = GATHER_TOL[name]
                    ok = bool((err <= atol + rtol * ref.abs()).all())
                    case = dict(shape=[b, side * side, RCNN_C], points=p,
                                dtype=name, stream=f"rcnn_{kind}",
                                stride=stride, max_abs_err=float(err.max()),
                                tolerance=f"abs <= {atol} + {rtol} * "
                                          f"|plain f32|",
                                off_map_corner_share=float(
                                    (ci < 0).float().mean()),
                                touched_rows=touched)
                    del got, ref, err
                    case["ms"] = _cuda_ms(
                        lambda: bl.bilinear_gather(x, ci, cw), iters=20)
                    case["plain_ms"] = _cuda_ms(
                        lambda: bl.bilinear_gather_plain(x, ci, cw), iters=3,
                        warmup=1)
                    g = grid.to(dtype)
                    case["library_ms"] = _cuda_ms(
                        lambda: F.grid_sample(fmap, g, mode="bilinear",
                                              padding_mode="zeros",
                                              align_corners=True), iters=20)
                    elt = x.element_size()
                    # out written once, the touched rows, ci and cw read
                    # once; 4 FMAs per output value
                    case["bound_ms"], case["bound_by"] = _bound(
                        b * p * RCNN_C * elt + touched * RCNN_C * elt
                        + 2 * b * p * 4 * 4, 8 * b * p * RCNN_C)
                    cases.append(case)
                    print(f"  bilinear_gather R-CNN {kind} P{int(math.log2(stride))}"
                          f" x{case['shape']} P={p} {name:8s} max_abs="
                          f"{case['max_abs_err']:.3e} kernel="
                          f"{case['ms'] * 1e3:7.1f}us plain="
                          f"{case['plain_ms'] * 1e3:8.1f}us grid_sample="
                          f"{case['library_ms'] * 1e3:7.1f}us bound="
                          f"{case['bound_ms'] * 1e3:5.1f}us "
                          f"({case['bound_by']})", flush=True)
                    if not ok:
                        raise AssertionError(
                            f"bilinear_gather_fwd at an R-CNN shape disagrees "
                            f"with its plain version: {case}")
                del fmap32, fmap, x, grid
    return cases


# the R-CNN train steps (phases 3, 5e, 5f, 6j, 6k): 256 sampled rois per
# image, a fifth of them zero boxes at the origin (the padded GT slots that
# the sampler appends to the proposals and takes as negatives); each roi's
# gradient reaches only its own level's gather (the one-hot select)
RCNN_TRAIN_BATCHES = (1, 8)
# K3dx's timed calls at these shapes (up to ~0.14 s a call at the harshest
# rois; the main path's own calls, ``main_path_k3dx``, take 20)
RCNN_TRAIN_GATHER_ITERS = 5
RCNN_TRAIN_ROIS = 256
RCNN_TRAIN_ROI_SETS = (("box", (7, 7)), ("mask", (14, 14)))
RCNN_MASK_SIZE = 28  # the mask targets' crop of the GT bitmaps
RCNN_BITMAP = (128, 64)  # (side, channels): image / 4, Mask R-CNN's G


def rcnn_train_rois(b: int, gen) -> torch.Tensor:
    """(b, 256, 4) rois like the ROI sampler's: ``rcnn_rois``, every fifth
    a zero box at the origin."""
    rois = rcnn_rois(b, RCNN_TRAIN_ROIS, gen)
    rois[:, 4::5] = 0.0
    return rois


def _k3dx_case(g, x, ci, cw, common, iters: int = 20):
    """K3dx on (g, x, ci, cw) against its plain version (``GATHER_BWD_TOL``,
    and dx bit-equal between two calls), timed (``iters`` calls) beside
    ``index_add_`` into a zeroed f32 map, with its largest row tile's
    bucket (the corners that one block sorts and sums) and the byte bound.
    Returns (case, ok)."""
    from minddet_tpu_torch.ops import bilinear as bl

    b, hw, c = x.shape
    p = ci.shape[1]
    dev, dtype = x.device, x.dtype
    name = str(dtype).replace("torch.", "")
    elt = x.element_size()
    rows = (bl._clipped_rows(ci, hw) + torch.arange(
        b, device=dev)[:, None] * hw).reshape(-1)
    plan = bl.gather_bwd_dx_plan(b, hw, c, p)
    tile_of = rows[(ci >= 0).reshape(-1)] // plan["tile_rows"]
    got = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
    again = bl.bilinear_gather_bwd_dx(g, x, ci, cw)
    torch.cuda.synchronize()
    repeat = torch.equal(got, again)
    del again
    ref = bl.bilinear_gather_bwd_dx_plain(g.float(), ci, cw, hw)
    terms = bl.bilinear_gather_bwd_dx_plain(g.float().abs(), ci, cw.abs(),
                                            hw)
    err = (got.float() - ref).abs()
    atol, rtol = GATHER_BWD_TOL[f"dx_{name}"]
    ok = got.dtype == dtype and repeat and bool(
        (err <= atol + rtol * terms).all())
    case = dict(common, dtype=name, max_abs_err=float(err.max()),
                max_abs=float(ref.abs().max()), repeat=repeat,
                largest_bucket=int(torch.bincount(tile_of).max()),
                sort_cap=plan["cap"], smem_bytes=plan["smem_bytes"],
                tolerance=f"abs <= {atol} + {rtol} * sum |cw g|; "
                          f"bit-equal between two calls")
    del got, ref, terms, err, tile_of
    case["ms"] = _cuda_ms(lambda: bl.bilinear_gather_bwd_dx(g, x, ci, cw),
                          iters=iters)
    case["plain_ms"] = _cuda_ms(
        lambda: bl.bilinear_gather_bwd_dx_plain(g, ci, cw, hw),
        iters=min(iters, 5), warmup=1)
    contrib = ((cw * (ci >= 0))[..., None]
               * g.float()[:, :, None, :]).reshape(-1, c)
    case["library_ms"] = _cuda_ms(
        lambda: torch.zeros(b * hw, c, device=dev).index_add_(0, rows,
                                                              contrib),
        iters=iters)
    del contrib, rows
    # dx (the whole map, in x's type) written once, g read once, ci and cw
    # read once; 4 multiply-adds per g value
    case["bound_ms"], case["bound_by"] = _bound(
        b * hw * c * elt + b * p * c * elt + 2 * b * p * 4 * 4, 8 * b * p * c)
    return case, ok


def check_rcnn_train_gather(dev):
    """Phase 3: K3f and K3dx at the R-CNN train steps' ROIAlign shapes,
    bf16, batch 1 and 8: each FPN level's map (B, 128^2 / 64^2 / 32^2 /
    16^2, 256) at 256 rois x 196 (box) and x 784 (mask) points per image
    (``rcnn_train_rois``), g random where the roi's level (``roi_levels``)
    is this one and 0 elsewhere, as the one-hot select's backward gives it.
    K3f against its plain version (``GATHER_TOL``), K3dx too
    (``GATHER_BWD_TOL``, and dx bit-equal between two calls), with
    ``index_add_`` into a zeroed f32 map timed beside K3dx, its largest row
    tile's bucket and the byte bounds, and ``F.grid_sample`` beside K3f.
    Returns (K3f cases, K3dx cases)."""
    import torch.nn.functional as F

    from minddet_tpu_torch.ops import bilinear as bl
    from minddet_tpu_torch.ops import roi_align as ra

    gen = torch.Generator().manual_seed(12)
    dtype, name = torch.bfloat16, "bfloat16"
    fwd_cases, dx_cases = [], []
    for b in RCNN_TRAIN_BATCHES:
        boxes = rcnn_train_rois(b, gen).to(dev)
        level = ra.roi_levels(boxes, len(RCNN_STRIDES))
        for kind, size in RCNN_TRAIN_ROI_SETS:
            for li, stride in enumerate(RCNN_STRIDES):
                side = 512 // stride
                hw = side * side
                ys, xs = ra.roi_sample_points(boxes / stride, size)
                ci, cw = bl.bilinear_corners(ys, xs, side, side)
                p = ci.shape[1]
                x = torch.randn(b, hw, RCNN_C, generator=gen).to(dev, dtype)
                on = (level == li).to(torch.float32)[:, :, None, None]
                g = (torch.randn(b, RCNN_TRAIN_ROIS, p // RCNN_TRAIN_ROIS,
                                 RCNN_C, generator=gen).to(dev) * on).reshape(
                                     b, p, RCNN_C).to(dtype)
                touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                              for i in range(b))
                common = dict(shape=[b, hw, RCNN_C], points=p, dtype=name,
                              stream=f"rcnn_train_{kind}", stride=stride,
                              touched_rows=touched,
                              rois_on_level=int((level == li).sum()),
                              off_map_corner_share=float(
                                  (ci < 0).float().mean()))
                elt = x.element_size()

                got = bl.bilinear_gather(x, ci, cw)
                torch.cuda.synchronize()
                ref = bl.bilinear_gather_plain(x.float(), ci, cw)
                err = (got.float() - ref).abs()
                atol, rtol = GATHER_TOL[name]
                ok = bool((err <= atol + rtol * ref.abs()).all())
                case = dict(common, max_abs_err=float(err.max()),
                            tolerance=f"abs <= {atol} + {rtol} * |plain f32|")
                del got, ref, err
                case["ms"] = _cuda_ms(lambda: bl.bilinear_gather(x, ci, cw),
                                      iters=20)
                case["plain_ms"] = _cuda_ms(
                    lambda: bl.bilinear_gather_plain(x, ci, cw), iters=3,
                    warmup=1)
                fmap = x.view(b, side, side, RCNN_C).permute(0, 3, 1, 2)
                grid = torch.stack([2 * xs / (side - 1) - 1,
                                    2 * ys / (side - 1) - 1], -1)[:, None]
                grid = grid.to(dtype)
                case["library_ms"] = _cuda_ms(
                    lambda: F.grid_sample(fmap, grid, mode="bilinear",
                                          padding_mode="zeros",
                                          align_corners=True), iters=20)
                del fmap, grid
                # out written once, the touched rows, ci and cw read once;
                # 4 FMAs per output value
                case["bound_ms"], case["bound_by"] = _bound(
                    b * p * RCNN_C * elt + touched * RCNN_C * elt
                    + 2 * b * p * 4 * 4, 8 * b * p * RCNN_C)
                fwd_cases.append(case)
                if not ok:
                    raise AssertionError(
                        f"bilinear_gather_fwd at an R-CNN train shape "
                        f"disagrees with its plain version: {case}")

                case, ok = _k3dx_case(g, x, ci, cw, common,
                                      RCNN_TRAIN_GATHER_ITERS)
                dx_cases.append(case)
                f = fwd_cases[-1]
                print(f"  R-CNN train {kind} P{int(math.log2(stride))} "
                      f"x{case['shape']} P={p} rois here "
                      f"{case['rois_on_level']}: K3f {f['ms'] * 1e3:7.1f}us "
                      f"(bound {f['bound_ms'] * 1e3:6.1f}); K3dx max_abs="
                      f"{case['max_abs_err']:.3e} repeat={case['repeat']} "
                      f"bucket<={case['largest_bucket']} kernel="
                      f"{case['ms'] * 1e3:8.1f}us plain="
                      f"{case['plain_ms'] * 1e3:8.1f}us index_add_="
                      f"{case['library_ms'] * 1e3:8.1f}us bound="
                      f"{case['bound_ms'] * 1e3:6.1f}us", flush=True)
                if not ok:
                    raise AssertionError(
                        f"bilinear_gather_bwd_dx at an R-CNN train shape "
                        f"disagrees with its plain version: {case}")
                del x, g, ci, cw
    return fwd_cases, dx_cases


def check_rcnn_mask_crop(dev):
    """Phase 3: K3f at Mask R-CNN's mask-target crop, f32: the GT bitmaps
    (B, 128^2, 64) of ``synthetic_rcnn_batch`` (ellipses, 0 / 1) sampled at
    256 rois x 56 x 56 points per image (28 x 28 bins, 2 x 2 samples) on
    the rois over the bitmaps' stride 4, batch 1 and 8, against the plain
    version (``GATHER_TOL``), with ``F.grid_sample`` timed beside it on the
    same map and points and the byte bound."""
    import torch.nn.functional as F

    from minddet_tpu_torch.entry import synthetic_rcnn_batch
    from minddet_tpu_torch.ops import bilinear as bl
    from minddet_tpu_torch.ops import roi_align as ra

    gen = torch.Generator().manual_seed(13)
    side, c = RCNN_BITMAP
    stride = 512 // side
    cases = []
    for b in RCNN_TRAIN_BATCHES:
        bitmaps = torch.from_numpy(
            synthetic_rcnn_batch(b, True)["gt_bitmaps"]).to(dev)
        boxes = rcnn_train_rois(b, gen).to(dev)
        ys, xs = ra.roi_sample_points(boxes / stride,
                                      (RCNN_MASK_SIZE, RCNN_MASK_SIZE))
        ci, cw = bl.bilinear_corners(ys, xs, side, side)
        p = ci.shape[1]
        x = bitmaps.view(b, side * side, c)
        touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                      for i in range(b))
        got = bl.bilinear_gather(x, ci, cw)
        torch.cuda.synchronize()
        ref = bl.bilinear_gather_plain(x, ci, cw)
        err = (got - ref).abs()
        atol, rtol = GATHER_TOL["float32"]
        ok = bool((err <= atol + rtol * ref.abs()).all())
        case = dict(shape=[b, side * side, c], points=p, dtype="float32",
                    stream="rcnn_gt_crop", stride=stride,
                    max_abs_err=float(err.max()),
                    tolerance=f"abs <= {atol} + {rtol} * |plain|",
                    output_bytes=got.numel() * 4, touched_rows=touched)
        del got, ref, err
        case["ms"] = _cuda_ms(lambda: bl.bilinear_gather(x, ci, cw), iters=10)
        case["plain_ms"] = _cuda_ms(lambda: bl.bilinear_gather_plain(
            x, ci, cw), iters=3, warmup=1)
        fmap = bitmaps.permute(0, 3, 1, 2)
        grid = torch.stack([2 * xs / (side - 1) - 1,
                            2 * ys / (side - 1) - 1], -1)[:, None]
        case["library_ms"] = _cuda_ms(
            lambda: F.grid_sample(fmap, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
            iters=10)
        # out written once, the touched rows, ci and cw read once; 4 FMAs
        # per output value
        case["bound_ms"], case["bound_by"] = _bound(
            b * p * c * 4 + touched * c * 4 + 2 * b * p * 4 * 4,
            8 * b * p * c)
        cases.append(case)
        print(f"  bilinear_gather R-CNN GT crop x{case['shape']} P={p} "
              f"float32 max_abs={case['max_abs_err']:.3e} output "
              f"{case['output_bytes'] / 1e9:.2f} GB kernel="
              f"{case['ms'] * 1e3:8.1f}us plain={case['plain_ms'] * 1e3:9.1f}"
              f"us grid_sample={case['library_ms'] * 1e3:8.1f}us bound="
              f"{case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']})",
              flush=True)
        if not ok:
            raise AssertionError(f"bilinear_gather_fwd at the GT crop "
                                 f"disagrees with its plain version: {case}")
        del bitmaps, x, ci, cw, fmap, grid
    return cases


@torch.no_grad()
def randomize_for_check(model, gen):
    """Random offset/mask convs and BN affines, then BN statistics from one
    pass over a random calibration image (momentum 1).

    The offset conv's std is 0.25/sqrt(fan_in): over the O(1) activations
    that calibrated BN gives, every DCN layer samples off the integer grid
    at offsets of a fraction of a pixel. With a gain near 1, each of the
    nine chained DCN layers turns a rounding difference in its input into
    an offset difference times the feature map's gradient, and f32 card-vs-
    CPU differences grow past any tight tolerance by the neck's end; the
    kernel itself is held to its plain version at 1.5 and 80 px offsets in
    phase 3.
    """
    from torch import nn

    from minddet_tpu_torch.entry import RES
    from minddet_tpu_torch.models.layers import ModulatedDeformConv

    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in model.modules():
        if isinstance(m, ModulatedDeformConv):
            wt = m.conv_offset.weight
            wt.copy_(torch.randn(wt.shape, generator=gen)
                     * (OFFSET_GAIN / math.sqrt(wt[0].numel())))
            m.conv_offset.bias.copy_(
                0.1 * torch.randn(m.conv_offset.bias.shape, generator=gen))
    for m in bns:
        m.weight.copy_(0.8 + 0.4 * torch.rand(m.num_features, generator=gen))
        m.bias.copy_(0.1 * torch.randn(m.num_features, generator=gen))
        m.momentum = 1.0
    dev = next(model.parameters()).device
    model.train()
    model(torch.randn(1, RES, RES, 3, generator=gen).to(dev))
    model.eval()
    for m in bns:
        m.momentum = 0.1
    return model


def _stage_outputs(model):
    """Forward hooks keeping the backbone's four outputs and the neck's in
    ``model.kept`` (a dict); returns the handles."""
    model.kept = {}

    def keep_backbone(module, args, out):
        for i, o in enumerate(out):
            model.kept[f"C{i + 2}"] = o.detach().float().cpu()

    def keep_neck(module, args, out):
        model.kept["neck"] = out.detach().float().cpu()

    return [model.backbone.register_forward_hook(keep_backbone),
            model.neck.register_forward_hook(keep_neck)]


STAGE_RTOL = 1e-3  # phase 4's intermediate outputs, see check_end_to_end_f32
# phase 4's heads: the card's largest distance from the f64 referee at most
# HEAD_REFEREE_K times the f32 CPU's plus HEAD_REFEREE_FLOOR times the
# head's largest value. Over 12 random models of each of phases 4 and 4d
# (`chip_smoke.py --seeds 12`) that ratio lay between 0.76 and 1.59, median
# 1.0, on an H100 (PERF.md section 6)
HEAD_REFEREE_K = 2.0
HEAD_REFEREE_FLOOR = 1e-6
# each end-to-end phase draws its model and inputs from a generator of its
# own, so that what it checks does not depend on the phases before it
PHASE_SEEDS = {"4": 40, "4d": 41, "4e": 42, "4f": 43, "4g": 44, "4h": 45,
               "4i": 46, "5": 50, "5b": 51, "5d": 52, "5e": 53, "5f": 54,
               "5g": 55, "5h": 56, "5i": 57, "5j": 58, "6a": 60, "6f": 61,
               "4j": 70, "4k": 71, "4l": 72, "4m": 73, "5k": 74, "5l": 75,
               "5m": 76, "5n": 77, "4n": 80, "4o": 81, "4p": 82, "5o": 83,
               "5p": 84, "5q": 85, "4q": 86, "4r": 87, "4s": 88, "5r": 89,
               "4t": 90, "5s": 91, "4w": 92, "5t": 93}


def _seeded(phase: str) -> torch.Generator:
    return torch.Generator().manual_seed(PHASE_SEEDS[phase])


def check_end_to_end_f32(dev, gen, dcn4: bool = False):
    """Phase 4 (4d with ``dcn4``: DCN in all four backbone stages): f32
    predict on the card vs the same model on the CPU, stage by stage (the
    backbone's four outputs, the neck's, the heads) and the detections.
    The stages are held to the f32 CPU (STAGE_RTOL of each one's largest
    value); the heads to the same model in f64 on the CPU (the referee):
    the card may lie at most HEAD_REFEREE_K times as far from it as the f32
    CPU does. Element by element, card and CPU differ by about the f32
    rounding of the chained DCN layers, each about as far from the referee
    as from the other (``wh`` ~1.3e-4 in phase 4d), so a fixed tolerance on
    that difference passes or fails with the random model."""
    r = end_to_end_f32_readings(dev, gen, dcn4)
    for name in r["stages"]:
        err, top = r[f"{name}_max_abs_err"], r[f"{name}_max_abs"]
        if err > STAGE_RTOL * top:
            raise AssertionError(f"f32 {name}: card vs CPU max abs err "
                                 f"{err}, over {STAGE_RTOL} of the largest "
                                 f"value {top}")
    for name in r["heads"]:
        card, host = r[f"{name}_card_vs_f64"], r[f"{name}_cpu_vs_f64"]
        limit = (HEAD_REFEREE_K * host
                 + HEAD_REFEREE_FLOOR * r[f"{name}_f64_max_abs"])
        if card > limit:
            raise AssertionError(f"f32 {name}: the card lies {card} from "
                                 f"the f64 referee, over {HEAD_REFEREE_K} x "
                                 f"the f32 CPU's {host} + "
                                 f"{HEAD_REFEREE_FLOOR} of the largest value")
    if r["det_shape"] != [1, 100, 6] or r["score_max_abs_err"] > 1e-4:
        raise AssertionError(f"f32 predict: card vs CPU scores max abs err "
                             f"{r['score_max_abs_err']} (atol 1e-4), shape "
                             f"{r['det_shape']}")
    return r


def end_to_end_f32_readings(dev, gen, dcn4):
    """Phase 4's measurements, with TF32 off: for every stage and head the
    card's and the f32 CPU's largest distance from each other and from the
    f64 referee, and ``ratio`` (card / CPU, from the referee); the
    detections' score error and class agreement; the launches."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _end_to_end_f32(dev, gen, dcn4)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _end_to_end_f32(dev, gen, dcn4):
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import RES, build_model

    cpu = randomize_for_check(
        build_model("cpu", dtype=torch.float32, dcn4=dcn4), gen)
    gpu = build_model(dev, dtype=torch.float32, dcn4=dcn4)
    gpu.load_state_dict(cpu.state_dict())
    referee = build_model("cpu", dtype=torch.float64, dcn4=dcn4)
    referee.load_state_dict(cpu.state_dict())
    image = torch.randn(1, RES, RES, 3, generator=gen)

    hooks = (_stage_outputs(gpu) + _stage_outputs(cpu)
             + _stage_outputs(referee))
    kernels.reset_launches()
    with torch.inference_mode():
        heads_gpu = gpu(image.to(dev))
        stages_gpu = dict(gpu.kept)
        det_gpu = gpu.predict(image.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = _sampler_launches(2, dcn4, train=False)
    if launches != want:
        raise AssertionError(f"f32 forward launched {launches} for 2 "
                             f"forwards (want {want})")
    with torch.inference_mode():
        heads_cpu = cpu(image)
        stages_cpu = dict(cpu.kept)
        det_cpu = cpu.predict(image)
        heads_ref = referee(image.double())
        stages_ref = dict(referee.kept)
    for hook in hooks:
        hook.remove()

    result = dict(stages=list(stages_ref), heads=list(heads_ref))
    for name, ref in list(stages_ref.items()) + list(heads_ref.items()):
        stage = name in stages_ref
        ref = ref.double()
        got = (stages_gpu[name] if stage else heads_gpu[name].cpu()).double()
        cpu_out = (stages_cpu[name] if stage else heads_cpu[name]).double()
        result[f"{name}_max_abs_err"] = float((got - cpu_out).abs().max())
        result[f"{name}_max_abs"] = float(cpu_out.abs().max())
        result[f"{name}_f64_max_abs"] = float(ref.abs().max())
        card = result[f"{name}_card_vs_f64"] = float((got - ref).abs().max())
        host = result[f"{name}_cpu_vs_f64"] = float(
            (cpu_out - ref).abs().max())
        result[f"{name}_ratio"] = card / host if host else math.inf
    result["score_max_abs_err"] = float(
        (det_gpu[..., 4].cpu() - det_cpu[..., 4]).abs().max())
    result["det_shape"] = list(det_gpu.shape)
    result["class_agreement"] = float(
        (det_gpu[..., 5].cpu() == det_cpu[..., 5]).float().mean())
    result["launches"] = launches
    print("  f32 card vs CPU (and each vs the f64 referee): "
          + " ".join(f"{k}={v:.3e}" for k, v in result.items()
                     if isinstance(v, float)), flush=True)
    return result


def referee_ratio_sweep(dev, seeds: int):
    """``--seeds N``: phases 4 and 4d's readings on N models each (seeds 0
    to N - 1), ungated: for each head the card's distance from the f64
    referee over the f32 CPU's, per model and at most. What
    HEAD_REFEREE_K is set from."""
    out = {}
    for dcn4 in (False, True):
        key = "4d" if dcn4 else "4"
        runs = []
        for seed in range(seeds):
            r = end_to_end_f32_readings(
                dev, torch.Generator().manual_seed(seed), dcn4)
            runs.append({f"{h}_{k}": r[f"{h}_{k}"] for h in r["heads"]
                         for k in ("ratio", "card_vs_f64", "cpu_vs_f64",
                                   "max_abs_err")})
        heads = [k[:-len("_ratio")] for k in runs[0] if k.endswith("_ratio")]
        out[key] = dict(runs=runs, max_ratio={
            h: max(run[f"{h}_ratio"] for run in runs) for h in heads})
        print(f"  phase {key} over {seeds} models: card / CPU distance from "
              f"the f64 referee, largest: " + " ".join(
                  f"{h}={v:.3f}" for h, v in out[key]["max_ratio"].items()),
              flush=True)
    return out


# f32 PointPillars predict, card vs CPU (phase 4b)
PP_HEAD_TOL = (1e-4, 1e-3)  # heads: atol, rtol, as phase 4
PP_TIE = 1e-5     # candidate scores this close may trade places
PP_NEAR = 1e-5    # IoUs this close to the NMS threshold may flip a keep
PP_BOX_TOL = (1e-3, 1e-5)  # decoded boxes (m, rad): atol, rtol; x = xt *
#   4.2 m + xa carries the heads' 1e-4; rtol * 70 m (the range's far end)
#   stays under atol
PP_IOU_TOL = 1e-4  # K4 on the CPU's candidates vs the plain version
PP_IOU_E2E_TOL = 1e-3  # IoUs of the card's vs the CPU's candidates
PP_DIR_TIE = 1e-3  # a heading may turn by pi where the dir logits tie
PP_BOX_CODE_STD = 0.15  # box head's std after calibrate_heads


@torch.no_grad()
def calibrate_heads(model, points, mask):
    """Scale the three 1x1 heads so that, on this cloud, the class logits
    have std 2, the box codes std PP_BOX_CODE_STD and the direction logits
    std 1 (the biases are zero). With flax's default initialisers and
    identity BN the RPN's activations shrink layer by layer and every score
    sits near 0.5, where card-vs-CPU rounding would reorder most of the top
    900. Small box codes keep the decoded boxes near the anchors' car size
    (the sizes are exp(code) times the anchor's)."""
    preds, _ = model(points, mask)
    for name, head, std in (("cls_preds", model.conv_cls, 2.0),
                            ("box_preds", model.conv_box, PP_BOX_CODE_STD),
                            ("dir_preds", model.conv_dir, 1.0)):
        head.weight.mul_(std / float(preds[name].std()))
    return model


def _candidate_checks(cand_g, cand_c, top_c, dir_c):
    """Candidates (one sample) of the card vs the CPU: sorted scores;
    anchors on one side only must tie with the CPU's last score; boxes of
    the common anchors (a heading turned by pi only where the CPU's dir
    logits tie). Returns (result, positions of the common anchors on the
    card, on the CPU, problems)."""
    bad = []
    sg, sc = cand_g["scores"][0].cpu(), cand_c["scores"][0]
    ig, ic = cand_g["anchor"][0].cpu(), cand_c["anchor"][0]
    r = dict(score_max_abs_err=float((sg - sc).abs().max()),
             candidates_reordered=int((ig != ic).sum()))
    if r["score_max_abs_err"] > PP_TIE:
        bad.append("candidate scores")
    one_side = sorted(set(ig.tolist()) ^ set(ic.tolist()))
    r["candidates_on_one_side"] = len(one_side)
    kth = float(sc[-1])
    if any(abs(float(top_c[a]) - kth) > PP_TIE for a in one_side):
        bad.append("a candidate on one side only that is no boundary tie")
    pos_g = {a: p for p, a in enumerate(ig.tolist())}
    pc = [p for p, a in enumerate(ic.tolist()) if a in pos_g]
    pg = [pos_g[int(ic[p])] for p in pc]
    bg = cand_g["boxes"][0].cpu()[pg]
    bc = cand_c["boxes"][0][pc]
    dyaw = torch.remainder(bg[:, 6] - bc[:, 6] + math.pi, 2 * math.pi) \
        - math.pi
    turned = dyaw.abs() > math.pi / 2
    gap = (dir_c[ic[pc], 0] - dir_c[ic[pc], 1]).abs()
    r["headings_turned"] = int(turned.sum())
    if bool((turned & (gap > PP_DIR_TIE)).any()):
        bad.append("a heading turned by pi where the dir logits do not tie")
    atol, rtol = PP_BOX_TOL
    err = (bg[:, :6] - bc[:, :6]).abs()
    yaw_err = torch.where(turned, torch.zeros_like(dyaw), dyaw.abs())
    r["box_max_abs_err"] = float(torch.cat([err.flatten(), yaw_err]).max())
    if not (bool((err <= atol + rtol * bc[:, :6].abs()).all())
            and bool((yaw_err <= atol).all())):
        bad.append("decoded boxes")
    return r, pg, pc, bad


def check_pointpillars_f32(dev):
    """Phase 4b: f32 PointPillars predict at batch 1 on the card against
    the same model on the CPU (TF32 off): the heads, the anchor mask, the
    top-900 candidates and their boxes, the IoU matrix (K4 on the CPU's
    candidates, and the card's own), and the kept lists where no candidate
    pair's IoU lies within PP_NEAR of the threshold or no pair's IoUs lie
    on two sides of it."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (CLOUD_POINTS, build_pointpillars,
                                         synthetic_clouds)
    from minddet_tpu_torch.ops import rotated_iou as ri
    from minddet_tpu_torch.ops.nms import rotated_nms

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = build_pointpillars("cpu")
    pts, mask = synthetic_clouds(1, cpu.pc_range, CLOUD_POINTS, seed=1)
    points, pmask = torch.from_numpy(pts), torch.from_numpy(mask)
    calibrate_heads(cpu, points, pmask)
    gpu = build_pointpillars(dev)
    gpu.load_state_dict(cpu.state_dict())
    kernels.reset_launches()
    with torch.inference_mode():
        preds_g, amask_g = gpu(points.to(dev), pmask.to(dev))
        det_g = gpu.predict_from_preds(preds_g, amask_g)
        cand_g = gpu.decode_candidates(preds_g, amask_g)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != {k.name: int(k is kernels.ROTATED_IOU)
                    for k in kernels.KERNELS}:
        raise AssertionError(f"f32 PointPillars predict launched {launches}"
                             " (want one rotated_iou_intersect)")
    with torch.inference_mode():
        preds_c, amask_c = cpu(points, pmask)
        det_c = cpu.predict_from_preds(preds_c, amask_c)
        cand_c = cpu.decode_candidates(preds_c, amask_c)

    result, bad = {}, []
    atol, rtol = PP_HEAD_TOL
    for name, ref in preds_c.items():
        got = preds_g[name].cpu()
        result[f"{name}_max_abs_err"] = float((got - ref).abs().max())
        result[f"{name}_std"] = float(ref.std())
        if not torch.allclose(got, ref, rtol=rtol, atol=atol):
            bad.append(f"head {name}")
    result["anchor_mask_share"] = float(amask_c.float().mean())
    if not torch.equal(amask_g.cpu(), amask_c):
        bad.append("anchor mask")
    top_c = torch.where(amask_c, torch.sigmoid(preds_c["cls_preds"]).max(
        -1).values, torch.zeros(()))[0]
    r, pg, pc, problems = _candidate_checks(cand_g, cand_c, top_c,
                                            preds_c["dir_preds"][0])
    result.update(r)
    bad += problems

    sc = cand_c["scores"][0]
    bev_c = cand_c["boxes"][0][:, [0, 1, 3, 4, 6]].contiguous()
    bev_g = cand_g["boxes"][0][:, [0, 1, 3, 4, 6]].contiguous()
    iou_c = ri.rotated_iou_bev(bev_c, bev_c)
    iou_k = ri.rotated_iou_bev(bev_c.to(dev), bev_c.to(dev)).cpu()
    iou_g = ri.rotated_iou_bev(bev_g, bev_g).cpu()
    result["iou_kernel_max_abs_err"] = float((iou_k - iou_c).abs().max())
    result["iou_e2e_max_abs_err"] = float(
        (iou_g[pg][:, pg] - iou_c[pc][:, pc]).abs().max())
    if result["iou_kernel_max_abs_err"] > PP_IOU_TOL:
        bad.append("IoU matrix of K4 on the CPU's candidates")
    if result["iou_e2e_max_abs_err"] > PP_IOU_E2E_TOL:
        bad.append("IoU matrix of the card's candidates")
    valid = sc > 0.09
    pair = torch.triu(valid[:, None] & valid[None, :], 1)
    near = int((pair & ((iou_c - 0.1).abs() < PP_NEAR)).sum())
    result.update(near_threshold_pairs=near, valid_candidates=int(
        valid.sum()), overlapping_pairs=int((pair & (iou_c > 0.1)).sum()),
        kept_cpu=int((det_c["labels"] >= 0).sum()),
        nms_passes_card=det_g["nms_passes"],
        nms_passes_cpu=det_c["nms_passes"])
    # The kept lists are compared where no pair's IoU is near the
    # threshold, and also wherever the two IoU matrices put every pair on
    # the same side of it (then the NMS decides the same by construction).
    # First the card's NMS on the CPU's candidates (only K4's rounding
    # differs), then the card's own predict.
    def same_side(a, b):
        return bool((((a > 0.1) == (b > 0.1)) | ~pair).all())

    idx_k, _, _ = rotated_nms(bev_c.to(dev)[None], sc.to(dev)[None], 0.1,
                              0.09, 300)
    idx_c, _, _ = rotated_nms(bev_c[None], sc[None], 0.1, 0.09, 300)
    compared = near == 0 or same_side(iou_k, iou_c)
    result["kept_same_inputs_compared"] = compared
    if compared and not torch.equal(idx_k.cpu(), idx_c):
        bad.append("kept lists of the card's NMS on the CPU's candidates")
    same = not (result["candidates_reordered"]
                or result["candidates_on_one_side"]
                or result["headings_turned"]) and (
        near == 0 or same_side(iou_g, iou_c))
    result["kept_end_to_end_compared"] = same
    if same and not (
            torch.equal(det_g["labels"].cpu(), det_c["labels"])
            and torch.allclose(det_g["scores"].cpu(), det_c["scores"],
                               rtol=0, atol=PP_TIE)
            and torch.allclose(det_g["boxes"].cpu(), det_c["boxes"],
                               rtol=PP_BOX_TOL[1], atol=PP_BOX_TOL[0])):
        bad.append("kept lists end to end")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    print("  f32 PointPillars card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 PointPillars predict, card vs CPU: {bad}:"
                             f" {result}")
    return result


# f32 two-stage CenterPoint predict, card vs CPU (phase 4c). The tolerances
# are phase 4b's; the PFN rows are two f32 matmuls and max/select
CP_PFN_TOL = (1e-5, 1e-5)
CP_SCORE_TOL = 2.5e-5  # sigmoid's slope (<= 1/4) times the heads' atol
CP_MATCHED_SHARE = 0.95  # of the CPU's detections found on the card
CP_REFINED_TOL = (2e-3, 1e-5)  # the refined box is exp(delta) x the size
CP_NMS_IOU = 0.2
CP_SCORE_THRESHOLD = 0.1
# std of each task's final maps after calibrate_centerpoint, per channel,
# and where their means go
CP_MAP_STD = {"hm": 2.0, "reg": 0.3, "height": 0.3, "dim": 0.15, "rot": 1.0,
              "vel": 0.5}
CP_DIM_MEAN = (math.log(1.9), math.log(4.5), math.log(1.7))  # a car, w l h
CP_REFINE_STD = {"score": 1.0, "box": 0.05}


@torch.no_grad()
def calibrate_centerpoint(model, points, mask):
    """Give the seeded two-stage CenterPoint heads that make a request do
    real work, on this cloud. With flax's default initialisers and identity
    BN every heatmap logit sits at the bias, -2.19: every score ~0.10, on
    the 0.1 threshold, where rounding would decide which candidates are
    valid. Each task's final convs are scaled and shifted per channel so
    that the heatmap logits have std 2 around -2.19 (the top 1000 peaks of
    each task all pass the threshold and the NMS has 1000 boxes to sort
    out), the sizes are a car's (exp(dim), std 0.15 in the log), and the
    other maps have the stds of ``CP_MAP_STD`` around 0; then the refine
    head's two outputs are scaled to ``CP_REFINE_STD`` over the kept
    detections, so that the second stage moves scores and boxes (a
    single-stage model has none)."""
    bev = model.bev_from_points_stream(points, mask)
    for t, pred in enumerate(model.head(bev)):
        task = getattr(model.head, f"task{t}")
        for name, std in CP_MAP_STD.items():
            out = getattr(task, f"{name}_out")
            v = pred[name].float()
            gain = std / v.std(dim=(0, 1, 2))
            centre = {"hm": task.init_bias,
                      "dim": torch.tensor(CP_DIM_MEAN, device=v.device)
                      }.get(name, 0.0)
            out.bias.copy_((out.bias - v.mean(dim=(0, 1, 2))) * gain + centre)
            out.weight.mul_(gain[:, None, None, None])
    if not hasattr(model, "refine"):  # the single-stage model
        return model
    det = model.head.predict(model.head(bev), model.pc_range,
                             model.voxel_size, model.out_size_factor)
    kept = det["labels"] >= 0
    slog, deltas = model.refine(model.extractor(bev, det["boxes"]))
    model.refine.score.weight.mul_(CP_REFINE_STD["score"] / slog[kept].std())
    model.refine.box.weight.mul_(CP_REFINE_STD["box"] / deltas[kept].std())
    return model


def _centerpoint_stages(model, points, mask):
    """``predict_refined`` stage by stage, through the model's own methods:
    the stream and the PFN's rows, the BEV map, the heads, per task the
    NMS's candidates and the flat (class-major) heatmap cells they came
    from, the stage-1 detections and the refined ones."""
    from minddet_tpu_torch.ops.decode import simple_topk
    from minddet_tpu_torch.ops.voxelize import scatter_stream_canvas

    sv, h = model.pillars_from_points(points, mask)
    canvas, _ = scatter_stream_canvas(h, sv, model.grid_ny, model.grid_nx)
    bev = model.rpn(canvas).contiguous(memory_format=torch.channels_last)
    preds = model.head(bev)
    geometry = (model.pc_range, model.voxel_size, model.out_size_factor)
    cands = model.head.candidates(preds, *geometry)
    cells = []
    for pred in preds:
        hm = torch.sigmoid(pred["hm"].float())
        _, pos, cls, _, _ = simple_topk(hm, CP_CANDIDATES)
        cells.append(cls.long() * (hm.shape[1] * hm.shape[2]) + pos)
    det = model.head.predict(preds, *geometry)
    return dict(sv=sv, h=h, bev=bev, preds=preds, cands=cands, cells=cells,
                det=det, refined=model.refine_detections(bev, det))


def _wrap(angle):
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def _cp_candidate_checks(task, cand_g, cand_c, cells_g, cells_c, hm_c):
    """One task's candidates (sample 0) of the card vs the CPU: sorted
    scores; cells on one side only must tie with the CPU's last score;
    boxes of the common cells. Returns (result, problems)."""
    bad = []
    sg, sc = cand_g["scores"][0].cpu(), cand_c["scores"][0]
    ig, ic = cells_g[0].cpu(), cells_c[0]
    r = dict(score_err=float((sg - sc).abs().max()),
             reordered=int((ig != ic).sum()))
    if r["score_err"] > CP_SCORE_TOL:
        bad.append(f"task {task}: candidate scores")
    one_side = sorted(set(ig.tolist()) ^ set(ic.tolist()))
    r["on_one_side"] = len(one_side)
    flat = torch.sigmoid(hm_c[0].float()).permute(2, 0, 1).reshape(-1)
    if any(abs(float(flat[a]) - float(sc[-1])) > CP_SCORE_TOL
           for a in one_side):
        bad.append(f"task {task}: a candidate on one side only that is no "
                   "boundary tie")
    pos_g = {a: p for p, a in enumerate(ig.tolist())}
    pc = [p for p, a in enumerate(ic.tolist()) if a in pos_g]
    pg = [pos_g[int(ic[p])] for p in pc]
    bg, bc = cand_g["boxes"][0].cpu()[pg], cand_c["boxes"][0][pc]
    atol, rtol = PP_BOX_TOL
    err = (bg[:, :8] - bc[:, :8]).abs()
    yaw_err = _wrap(bg[:, 8] - bc[:, 8]).abs()
    r["box_err"] = float(torch.cat([err.flatten(), yaw_err]).max())
    if not (bool((err <= atol + rtol * bc[:, :8].abs()).all())
            and bool((yaw_err <= atol).all())):
        bad.append(f"task {task}: decoded boxes")
    return r, bad


def _detections_agree(got, ref, box_tol, score_atol) -> bool:
    """Detections slot by slot: labels equal, scores and boxes (yaw modulo a
    turn) within tolerance."""
    bg, bc = got["boxes"].cpu(), ref["boxes"]
    atol, rtol = box_tol
    err = (bg[..., :8] - bc[..., :8]).abs()
    return (torch.equal(got["labels"].cpu(), ref["labels"])
            and torch.allclose(got["scores"].cpu(), ref["scores"], rtol=0,
                               atol=score_atol)
            and bool((err <= atol + rtol * bc[..., :8].abs()).all())
            and bool((_wrap(bg[..., 8] - bc[..., 8]).abs() <= atol).all()))


def _matched_share(got, ref, box_tol, score_atol) -> float:
    """The share of ``ref``'s kept detections that ``got`` holds too, in
    whatever slot of the same task: same label, centre, size and velocity
    within ``box_tol``, score within ``score_atol``."""
    atol, rtol = box_tol
    matched = total = 0
    for i in range(ref["labels"].shape[0]):
        for t in range(CP_TASKS):
            sl = slice(t * CP_NMS_POST, (t + 1) * CP_NMS_POST)
            lc, lg = ref["labels"][i, sl], got["labels"][i, sl].cpu()
            bc, bg = ref["boxes"][i, sl], got["boxes"][i, sl].cpu()
            sc, sg = ref["scores"][i, sl], got["scores"][i, sl].cpu()
            err = (bg[None, :, :8] - bc[:, None, :8]).abs()
            same = ((err <= atol + rtol * bc[:, None, :8].abs()).all(-1)
                    & (lg[None] == lc[:, None])
                    & ((sg[None] - sc[:, None]).abs() <= score_atol))
            matched += int((same.any(1) & (lc >= 0)).sum())
            total += int((lc >= 0).sum())
    return matched / max(total, 1)


def check_centerpoint_f32(dev, gpu):
    """Phase 4c: f32 two-stage CenterPoint ``predict_refined`` at batch 1 on
    the card against the same model on the CPU (TF32 off), stage by stage:
    the stream's flags and the PFN's rows at each pillar's last kept row
    (K5f on the card), the BEV map, every task's maps, per task the top-1000
    candidates and their boxes, the IoU matrix of the stacked tasks (K4 on
    the CPU's candidates, and the card's own), the kept lists of the card's
    NMS on the CPU's candidates, the card's second stage (K3f) on the CPU's
    detections, and the card's own kept lists and refined detections, slot
    by slot where its candidates came out in the CPU's order and always as
    sets (``CP_MATCHED_SHARE``); kept lists are compared where no pair's IoU
    lies within PP_NEAR of the threshold or no pair's IoUs lie on two sides
    of it. ``gpu`` is the model on the card; it is
    calibrated here."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import build_centerpoint
    from minddet_tpu_torch.ops import rotated_iou as ri
    from minddet_tpu_torch.ops.nms import rotated_nms

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    points, pmask = _nusc_clouds(gpu, 1, 1, "cpu")
    calibrate_centerpoint(gpu, points.to(dev), pmask.to(dev))
    cpu = build_centerpoint("cpu")
    cpu.load_state_dict(gpu.state_dict())
    kernels.reset_launches()
    with torch.inference_mode():
        g = _centerpoint_stages(gpu, points.to(dev), pmask.to(dev))
        served = gpu.predict_refined(points.to(dev), pmask.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != _centerpoint_launches(2):
        raise AssertionError(f"two f32 CenterPoint predicts launched "
                             f"{launches} (want two each of seg_full_max, "
                             f"rotated_iou_intersect, bilinear_gather_fwd)")
    t0 = time.perf_counter()
    with torch.inference_mode():
        c = _centerpoint_stages(cpu, points, pmask)
    cpu_s = time.perf_counter() - t0

    result, bad = dict(cpu_predict_s=cpu_s), []
    if not _detections_agree(served, {k: v.cpu() if torch.is_tensor(v) else v
                                      for k, v in g["refined"].items()},
                             (1e-5, 0.0), 1e-6):
        bad.append("predict_refined against its own stages on the card")
    last = c["sv"].last
    result["pillars"] = int(last.sum())
    result["kept_point_share"] = float(c["sv"].keep.float().mean())
    if not (torch.equal(g["sv"].last.cpu(), last)
            and torch.equal(g["sv"].keep.cpu(), c["sv"].keep)
            and torch.equal(g["sv"].first.cpu(), c["sv"].first)):
        bad.append("stream flags")
    rows_g, rows_c = g["h"].cpu()[last], c["h"][last]
    result["pfn_max_abs_err"] = float((rows_g - rows_c).abs().max())
    result["pfn_max_abs"] = float(rows_c.abs().max())
    if not torch.allclose(rows_g, rows_c, atol=CP_PFN_TOL[0],
                          rtol=CP_PFN_TOL[1]):
        bad.append("PFN rows at the last kept rows")
    atol, rtol = PP_HEAD_TOL
    bev_g = g["bev"].cpu()
    result["bev_max_abs_err"] = float((bev_g - c["bev"]).abs().max())
    result["bev_std"] = float(c["bev"].std())
    if not torch.allclose(bev_g, c["bev"], rtol=rtol, atol=atol):
        bad.append("BEV map")
    for name in CP_MAP_STD:
        errs = []
        for t, ref in enumerate(c["preds"]):
            got = g["preds"][t][name].cpu()
            errs.append(float((got - ref[name]).abs().max()))
            if not torch.allclose(got, ref[name], rtol=rtol, atol=atol):
                bad.append(f"task {t} map {name}")
        result[f"{name}_max_abs_err"] = max(errs)
    result["hm_std"] = float(c["preds"][0]["hm"].std())

    cand = dict(score_err=0.0, reordered=0, on_one_side=0, box_err=0.0)
    for t in range(len(c["cands"])):
        r, problems = _cp_candidate_checks(
            t, g["cands"][t], c["cands"][t], g["cells"][t], c["cells"][t],
            c["preds"][t]["hm"])
        bad += problems
        cand = {k: (max if isinstance(v, float) else sum)((v, r[k]))
                for k, v in cand.items()}
    result.update({f"candidates_{k}": v for k, v in cand.items()})

    def stacked(cands):
        return (torch.cat([x["boxes"][..., [0, 1, 3, 4, 8]] for x in cands])
                .contiguous(), torch.cat([x["scores"] for x in cands]))

    bev5_c, sc = stacked(c["cands"])
    bev5_g, _ = stacked(g["cands"])
    iou_c = ri.rotated_iou_bev(bev5_c, bev5_c)
    iou_k = ri.rotated_iou_bev(bev5_c.to(dev), bev5_c.to(dev)).cpu()
    iou_g = ri.rotated_iou_bev(bev5_g, bev5_g).cpu()
    result["iou_kernel_max_abs_err"] = float((iou_k - iou_c).abs().max())
    if result["iou_kernel_max_abs_err"] > PP_IOU_TOL:
        bad.append("IoU matrix of K4 on the CPU's candidates")
    valid = sc > CP_SCORE_THRESHOLD
    pair = torch.triu(valid[:, :, None] & valid[:, None, :], 1)
    near = int((pair & ((iou_c - CP_NMS_IOU).abs() < PP_NEAR)).sum())

    def same_side(a, b):
        return bool((((a > CP_NMS_IOU) == (b > CP_NMS_IOU)) | ~pair).all())

    kept_c = c["det"]["labels"] >= 0
    result.update(
        near_threshold_pairs=near, valid_candidates=int(valid.sum()),
        overlapping_pairs=int((pair & (iou_c > CP_NMS_IOU)).sum()),
        kept_cpu=int(kept_c.sum()), nms_passes_card=g["det"]["nms_passes"],
        nms_passes_cpu=c["det"]["nms_passes"])
    # Same inputs first, whatever order the card's own candidates took: the
    # card's NMS on the CPU's candidates (only K4's rounding differs), and
    # the card's second stage on its own BEV map at the CPU's detections
    # (K3f and the MLP).
    idx_k, _, _ = rotated_nms(bev5_c.to(dev), sc.to(dev), CP_NMS_IOU,
                              CP_SCORE_THRESHOLD, CP_NMS_POST)
    idx_c, _, _ = rotated_nms(bev5_c, sc, CP_NMS_IOU, CP_SCORE_THRESHOLD,
                              CP_NMS_POST)
    compared = near == 0 or same_side(iou_k, iou_c)
    result["kept_same_inputs_compared"] = compared
    if compared and not torch.equal(idx_k.cpu(), idx_c):
        bad.append("kept lists of the card's NMS on the CPU's candidates")
    ref = c["refined"]
    with torch.inference_mode():
        det_on_card = {k: v.to(dev) if torch.is_tensor(v) else v
                       for k, v in c["det"].items()}
        got = gpu.refine_detections(g["bev"], det_on_card)
    result["refined_score_max_abs_err"] = float(
        (got["scores"].cpu() - ref["scores"]).abs().max())
    result["refined_box_max_abs_err"] = float(
        (got["boxes"].cpu()[..., :8] - ref["boxes"][..., :8]).abs().max())
    result["rescored_by"] = float(
        (ref["scores"] - c["det"]["scores"]).abs()[kept_c].max())
    result["refined_by_m"] = float(
        (ref["boxes"] - c["det"]["boxes"]).abs()[kept_c].max())
    if not _detections_agree(got, ref, CP_REFINED_TOL, 1e-4):
        bad.append("the card's second stage on the CPU's detections")
    # then the card's own request, where its candidates came out in the
    # CPU's order and every IoU on the CPU's side of the threshold
    same = not (cand["reordered"] or cand["on_one_side"])
    if same:
        result["iou_e2e_max_abs_err"] = float((iou_g - iou_c).abs().max())
        if result["iou_e2e_max_abs_err"] > PP_IOU_E2E_TOL:
            bad.append("IoU matrix of the card's candidates")
    same = same and (near == 0 or same_side(iou_g, iou_c))
    result["kept_end_to_end_compared"] = same
    if same and not (
            _detections_agree(g["det"], c["det"], PP_BOX_TOL, CP_SCORE_TOL)
            and _detections_agree(g["refined"], ref, CP_REFINED_TOL, 1e-4)):
        bad.append("kept lists and refined detections end to end")
    # and in any case as sets: candidates that traded places move a kept
    # detection to a neighbouring slot, and change the kept set only where
    # the two overlap or straddle the 83rd place
    result["stage1_matched_share"] = _matched_share(
        g["det"], c["det"], PP_BOX_TOL, CP_SCORE_TOL)
    result["refined_matched_share"] = _matched_share(
        g["refined"], ref, CP_REFINED_TOL, 1e-4)
    if min(result["stage1_matched_share"],
           result["refined_matched_share"]) < CP_MATCHED_SHARE:
        bad.append("the card's own detections against the CPU's, as sets")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    print("  f32 CenterPoint card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 CenterPoint predict, card vs CPU: {bad}: "
                             f"{result}")
    return result


# f32 Faster R-CNN / Mask R-CNN predict, card vs CPU and the f64 referee
# (phases 4e and 4f)
RCNN_RPN_NMS_IOU = 0.7
RCNN_BOX_NMS_IOU = 0.5
RCNN_SCORE_THRESHOLD = 0.05
RCNN_TIE = 1e-5      # candidate scores this close may trade places
RCNN_BOX_TOL = (1e-3, 1e-5)  # boxes in px: atol, rtol (decode's exp)
RCNN_SCORE_TOL = 1e-5  # softmax scores from the same logits
RCNN_MATCHED_SHARE = 0.95  # of the CPU's detections found on the card
# a detection of the card's own request matches one of the CPU's where the
# label is the same, the boxes overlap by this IoU and the scores lie this
# close: end to end the proposals differ by up to ~1e-3 px and the box
# head's deltas, x 0.1 / 0.2 of rois up to 512 px, move the boxes by ~1e-2
# px, so the same-input tolerances do not apply
RCNN_PREDICT_CHECK_RES = 320  # 4e / 4f: the image's side (served at 512)
RCNN_E2E_IOU = 0.99
RCNN_E2E_SCORE_TOL = 1e-3


@torch.no_grad()
def randomize_bn(model, image, gen):
    """Random BN affines, then BN statistics from one pass over ``image``
    (momentum 1), as ``randomize_for_check`` does for CenterNet: with
    identity BN the seeded ResNet-50's activations grow block by block, and
    f32 rounding with them. Leaves ``model`` in eval mode."""
    from torch import nn

    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.weight.copy_(0.8 + 0.4 * torch.rand(m.num_features, generator=gen))
        m.bias.copy_(0.1 * torch.randn(m.num_features, generator=gen))
        m.momentum = 1.0
    model.train()
    model(image)
    model.eval()
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    return model


def _rcnn_stages(model, image, masks: bool = True):
    """``predict`` stage by stage through the model's own methods: C2-C5,
    P2-P6, the RPN's outputs, the NMS's candidates and the proposals, the
    box ROI features, the box head's outputs, the final NMS's candidates
    and the detections, and with the mask branch the mask logits at the
    detections."""
    from minddet_tpu_torch.models.detectors.faster_rcnn import BOX_ROI
    from minddet_tpu_torch.models.heads.roi_head import (box_candidates,
                                                         box_head_predict)
    from minddet_tpu_torch.models.heads.rpn_head import proposal_candidates

    x = image.to(model.dtype).permute(0, 3, 1, 2)
    feats = model.backbone(x)
    pyr = model.fpn(feats)
    logits, deltas = model.rpn(pyr)
    cand = proposal_candidates(logits, deltas, model.anchors,
                               model.level_sizes, model.image_hw,
                               model.rpn_pre_nms)
    props, _, rpn_passes = model.proposals(logits, deltas)
    roi = model.roi_features(pyr, props, BOX_ROI)
    cls, reg = model.box_head(roi.to(model.dtype))
    det = box_head_predict(cls, reg, props, model.image_hw)
    out = dict(pyramids=pyr, logits=logits, deltas=deltas, cand=cand,
               proposals=props, roi=roi, cls=cls, reg=reg,
               final_cand=box_candidates(cls, reg, props, model.image_hw,
                                         400),
               det=det, rpn_passes=rpn_passes)
    out.update({f"C{i + 2}": f for i, f in enumerate(feats)})
    out.update({f"P{i + 2}": p for i, p in enumerate(pyr)})
    if model.with_mask and masks:
        out["mask_logits"] = model.mask_logits(pyr, det["boxes"],
                                               det["labels"])
    return out


def _nhwc_cpu(t):
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).double().cpu()


def _near_iou_pairs(boxes, scores, threshold, classes=None,
                    min_score=RCNN_SCORE_THRESHOLD):
    """Pairs of valid candidates (sample 0) whose IoU lies within PP_NEAR
    of ``threshold`` (of one class and scored above ``min_score``, where
    classes are given): where the card's rounding may flip a
    suppression."""
    from minddet_tpu_torch.ops.box import pairwise_iou

    b, s = boxes[0].double().cpu(), scores[0].cpu()
    iou = pairwise_iou(b, b)
    ok = torch.isfinite(s) & (s > (min_score if classes is not
                                   None else float("-inf")))
    pair = torch.triu(ok[:, None] & ok[None, :], 1)
    if classes is not None:
        c = classes[0].cpu()
        pair &= c[:, None] == c[None, :]
    return int((pair & ((iou - threshold).abs() < PP_NEAR)).sum())


def _rcnn_matched_share(got, ref, end_to_end: bool = False) -> float:
    """The share of ``ref``'s kept detections (sample 0) that ``got`` holds
    too, in any slot: same label, box within RCNN_BOX_TOL and score within
    RCNN_SCORE_TOL; with ``end_to_end``, boxes overlapping by RCNN_E2E_IOU
    and scores within RCNN_E2E_SCORE_TOL."""
    from minddet_tpu_torch.ops.box import pairwise_iou

    atol, rtol = RCNN_BOX_TOL
    lc, lg = ref["labels"][0].cpu(), got["labels"][0].cpu()
    bc, bg = ref["boxes"][0].cpu().double(), got["boxes"][0].cpu().double()
    sc = ref["scores"][0].cpu().double()
    sg = got["scores"][0].cpu().double()
    if end_to_end:
        close = pairwise_iou(bc, bg) >= RCNN_E2E_IOU
        score_tol = RCNN_E2E_SCORE_TOL
    else:
        err = (bg[None] - bc[:, None]).abs()
        close = (err <= atol + rtol * bc[:, None].abs()).all(-1)
        score_tol = RCNN_SCORE_TOL
    same = (close & (lg[None] == lc[:, None])
            & ((sg[None] - sc[:, None]).abs() <= score_tol))
    kept = lc >= 0
    return int((same.any(1) & kept).sum()) / max(int(kept.sum()), 1)


def _same_detections(got, ref) -> bool:
    atol, rtol = RCNN_BOX_TOL
    bg, bc = got["boxes"].cpu().double(), ref["boxes"].cpu().double()
    return (torch.equal(got["labels"].cpu(), ref["labels"].cpu())
            and bool(((bg - bc).abs() <= atol + rtol * bc.abs()).all())
            and bool(((got["scores"].cpu() - ref["scores"].cpu()).abs()
                      <= RCNN_SCORE_TOL).all()))


# the box head's layers computed in f64 on the card, the rest in f32: an
# ungated reading of where the card's f32 box head leaves the f64 referee
BOX_HEAD_F64 = (("fc1_f64", ("fc1",)), ("fc1_fc2_f64", ("fc1", "fc2")),
                ("all_f64", ("fc1", "fc2", "cls", "reg")))


@torch.no_grad()
def box_head_f64_readings(head, feats, ref_cls, ref_reg, prefix=""):
    """``head`` (the card's f32 ``BoxHead``) on the ROI features ``feats``
    (B, R, 7, 7, C) with the layers of each ``BOX_HEAD_F64`` entry in f64
    and the others in f32 (TF32 off): each variant's largest distance from
    the f64 referee's class logits ``ref_cls`` and box deltas ``ref_reg``
    (on the CPU). Where the card's f32 head lies farther from the referee
    than the f32 CPU's, the variant whose distance falls to the CPU's names
    the layer whose sum makes the gap."""
    import torch.nn.functional as F

    dev = next(head.parameters()).device
    b, r = feats.shape[:2]
    out = {}
    for label, wide in BOX_HEAD_F64:
        def layer(name, h):
            lin = getattr(head, name)
            t = torch.float64 if name in wide else torch.float32
            return F.linear(h.to(t), lin.weight.to(t), lin.bias.to(t))

        h = feats.to(dev).reshape(b, r, -1)
        h = torch.relu(layer("fc1", h))
        h = torch.relu(layer("fc2", h))
        cls = layer("cls", h).double().cpu()
        reg = layer("reg", h).double().cpu().reshape(ref_reg.shape)
        out[f"{prefix}box_{label}_cls_card_vs_f64"] = float(
            (cls - ref_cls.double()).abs().max())
        out[f"{prefix}box_{label}_reg_card_vs_f64"] = float(
            (reg - ref_reg.double()).abs().max())
    return out


def check_rcnn_f32(dev, with_mask: bool, gen):
    """Phases 4e (Faster R-CNN) and 4f (Mask R-CNN): f32 ``predict`` at
    batch 1 and RCNN_PREDICT_CHECK_RES on the card against the same model
    on the CPU (TF32 off) and an f64 CPU referee, stage by stage. The
    seeded ResNet-50-FPN gets random BN (``randomize_bn``) and calibrated
    heads (``calibrate_rcnn``) on the CPU; the card and the referee load
    its state.

    - C2-C5 and P2-P6 card vs CPU within STAGE_RTOL of each one's largest
      value; the RPN's logits and deltas, and the box head's logits and
      deltas on the CPU's ROI features, held to the referee as phase 4
      holds its heads (the card at most HEAD_REFEREE_K times as far from
      it as the f32 CPU), and so are the mask logits at the CPU's
      detections;
    - where a discrete choice can flip (the per-level top-k, the RPN NMS,
      the final top-k, the final NMS), the card's stage on the CPU's own
      inputs: the proposals from the CPU's RPN outputs, the ROI features
      at the CPU's proposals (STAGE_RTOL), the detections from the CPU's
      head outputs and proposals, slot by slot where no candidate pair's
      IoU lies within PP_NEAR of its threshold, and no score ties the
      top-400's cut within RCNN_TIE; as sets otherwise (at least
      ``RCNN_MATCHED_SHARE`` of the CPU's found on the card within
      ``RCNN_BOX_TOL``);
    - the card's own proposals and detections against the CPU's as sets
      (``RCNN_MATCHED_SHARE`` at ``RCNN_E2E_IOU`` and
      ``RCNN_E2E_SCORE_TOL``; the f64 referee's detections read the same
      way beside them, ungated), and ``predict`` against its own stages.

    K3f launches four times per box ROIAlign and four per mask ROIAlign on
    the card, nothing else."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_rcnn_f32(dev, with_mask, gen)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _rcnn_predict_model(device, with_mask: bool, dtype):
    """``entry.build_faster_rcnn``'s model at RCNN_PREDICT_CHECK_RES."""
    from minddet_tpu_torch.entry import NUM_CLASSES, SEED
    from minddet_tpu_torch.models.detectors.faster_rcnn import FasterRCNN

    res = RCNN_PREDICT_CHECK_RES
    model = FasterRCNN(num_classes=NUM_CLASSES, depth=50,
                       image_hw=(res, res), rpn_pre_nms=1000,
                       rpn_post_nms=512, with_mask=with_mask, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(SEED))
    return model.eval().to(device=device, dtype=dtype,
                           memory_format=torch.channels_last)


def _check_rcnn_f32(dev, with_mask, gen):
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import calibrate_rcnn
    from minddet_tpu_torch.models.detectors.faster_rcnn import BOX_ROI
    from minddet_tpu_torch.models.heads.roi_head import box_head_predict

    res = RCNN_PREDICT_CHECK_RES
    image = torch.randn(1, res, res, 3, generator=gen)
    cpu = _rcnn_predict_model("cpu", with_mask, torch.float32)
    randomize_bn(cpu, torch.randn(1, res, res, 3, generator=gen), gen)
    calibrate_rcnn(cpu, image)
    gpu = _rcnn_predict_model(dev, with_mask, torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    referee = _rcnn_predict_model("cpu", with_mask, torch.float64)
    referee.load_state_dict(cpu.state_dict())
    rois_per_request = 2 if with_mask else 1

    kernels.reset_launches()
    with torch.inference_mode():
        g = _rcnn_stages(gpu, image.to(dev))
        served = gpu.predict(image.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = {k.name: 2 * 4 * rois_per_request * int(
        k is kernels.BILINEAR_GATHER_FWD) for k in kernels.KERNELS}
    if launches != want:
        raise AssertionError(f"two f32 R-CNN predicts launched {launches} "
                             f"(want {want})")
    t0 = time.perf_counter()
    with torch.inference_mode():
        c = _rcnn_stages(cpu, image)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        # the referee's stages after the RPN run on the CPU's inputs, so
        # that its discrete choices are the CPU's
        r = _rcnn_stages(referee, image, masks=False)
        r_cls, r_reg = referee.box_head(c["roi"].double())
        r_mask = (referee.mask_logits(r["pyramids"], c["det"]["boxes"],
                                      c["det"]["labels"])
                  if with_mask else None)
    ref_s = time.perf_counter() - t0

    result, bad = dict(cpu_predict_s=cpu_s, referee_s=ref_s), []
    if not (_same_detections(served, g["det"])
            and (not with_mask
                 or torch.equal(served["masks"],
                                torch.sigmoid(g["mask_logits"])))):
        bad.append("predict against its own stages on the card")
    for name in [f"C{i}" for i in range(2, 6)] + [f"P{i}" for i in
                                                     range(2, 7)]:
        got, host, ref = (_nhwc_cpu(g[name]), _nhwc_cpu(c[name]),
                          _nhwc_cpu(r[name]))
        err, top = float((got - host).abs().max()), float(host.abs().max())
        result[f"{name}_max_abs_err"] = err
        result[f"{name}_max_abs"] = top
        result[f"{name}_card_vs_f64"] = float((got - ref).abs().max())
        result[f"{name}_cpu_vs_f64"] = float((host - ref).abs().max())
        if err > STAGE_RTOL * top:
            bad.append(f"{name}: card vs CPU {err} over {STAGE_RTOL} of "
                       f"{top}")

    def refereed(name, got, host, ref):
        got, host, ref = got.double().cpu(), host.double().cpu(), ref.cpu()
        card = result[f"{name}_card_vs_f64"] = float((got - ref).abs().max())
        cpu_d = result[f"{name}_cpu_vs_f64"] = float((host - ref).abs().max())
        result[f"{name}_max_abs_err"] = float((got - host).abs().max())
        result[f"{name}_ratio"] = card / cpu_d if cpu_d else math.inf
        limit = (HEAD_REFEREE_K * cpu_d
                 + HEAD_REFEREE_FLOOR * float(ref.abs().max()))
        if card > limit:
            bad.append(f"{name}: the card lies {card} from the f64 referee, "
                       f"over {HEAD_REFEREE_K} x the f32 CPU's {cpu_d}")

    refereed("rpn_logits", g["logits"], c["logits"], r["logits"])
    refereed("rpn_deltas", g["deltas"], c["deltas"], r["deltas"])

    def as_detections(props):
        real = props.abs().sum(-1) > 0
        return dict(labels=real.long() - (~real).long(), boxes=props,
                    scores=torch.zeros_like(props[..., 0]))

    # the proposals from the CPU's RPN outputs
    cand_boxes, cand_scores = c["cand"]
    near = result["rpn_near_threshold_pairs"] = _near_iou_pairs(
        cand_boxes, cand_scores, RCNN_RPN_NMS_IOU)
    result["rpn_valid_candidates"] = int(torch.isfinite(cand_scores).sum())
    result["rpn_nms_passes_card"] = g["rpn_passes"]
    result["rpn_nms_passes_cpu"] = c["rpn_passes"]
    with torch.inference_mode():
        props_k, _, _ = gpu.proposals(c["logits"].to(dev),
                                      c["deltas"].to(dev))
    atol, rtol = RCNN_BOX_TOL
    pk, pc = props_k.cpu().double(), c["proposals"].double()
    same = bool(((pk - pc).abs() <= atol + rtol * pc.abs()).all())
    result["proposals_same_inputs_slot_by_slot"] = same
    result["proposals_same_inputs_max_abs_err"] = float((pk - pc).abs().max())
    result["proposals_same_inputs_matched_share"] = _rcnn_matched_share(
        as_detections(props_k), as_detections(c["proposals"]))
    if not same and (near == 0 or result[
            "proposals_same_inputs_matched_share"] < RCNN_MATCHED_SHARE):
        bad.append("proposals of the card on the CPU's RPN outputs")
    real = (c["proposals"].abs().sum(-1) > 0)
    result["proposals_real"] = int(real.sum())

    # the ROI features at the CPU's proposals, the box head on the CPU's
    with torch.inference_mode():
        roi_k = gpu.roi_features(g["pyramids"], c["proposals"].to(dev),
                                 BOX_ROI)
        cls_k, reg_k = gpu.box_head(c["roi"].to(dev))
    err = float((roi_k.cpu() - c["roi"]).abs().max())
    top = float(c["roi"].abs().max())
    result["roi_max_abs_err"], result["roi_max_abs"] = err, top
    if err > STAGE_RTOL * top:
        bad.append(f"ROI features at the CPU's proposals: {err} over "
                   f"{STAGE_RTOL} of {top}")
    refereed("cls_logits", cls_k, c["cls"], r_cls)
    refereed("box_deltas", reg_k, c["reg"], r_reg)
    result.update(box_head_f64_readings(gpu.box_head, c["roi"], r_cls, r_reg))

    # the detections from the CPU's head outputs and proposals
    fb, fs, fc = c["final_cand"]
    near_f = result["final_near_threshold_pairs"] = _near_iou_pairs(
        fb, fs, RCNN_BOX_NMS_IOU, fc)
    cls_all = torch.softmax(c["cls"], -1)[..., 1:].reshape(1, -1)
    cut = float(fs[0, -1])
    # scores that may trade places with the 400th, or cross the threshold
    result["final_cut_ties"] = (
        int(((cls_all - cut).abs() < RCNN_TIE).sum()) - 1
        + int(((fs - RCNN_SCORE_THRESHOLD).abs() < RCNN_TIE).sum()))
    with torch.inference_mode():
        det_k = box_head_predict(c["cls"].to(dev), c["reg"].to(dev),
                                 c["proposals"].to(dev), gpu.image_hw)
    same = _same_detections(det_k, c["det"])
    result["detections_same_inputs_slot_by_slot"] = same
    result["detections_same_inputs_matched_share"] = _rcnn_matched_share(
        det_k, c["det"])
    if not same and (near_f == 0 and result["final_cut_ties"] == 0
                     or result["detections_same_inputs_matched_share"]
                     < RCNN_MATCHED_SHARE):
        bad.append("detections of the card on the CPU's head outputs")
    kept = c["det"]["labels"] >= 0
    result["kept_cpu"] = int(kept.sum())
    result["final_nms_passes_cpu"] = c["det"]["nms_passes"]
    if not bool(kept.any()):
        bad.append("the CPU's request kept no detection")

    if with_mask:
        with torch.inference_mode():
            mask_k = gpu.mask_logits(
                g["pyramids"], c["det"]["boxes"].to(dev),
                c["det"]["labels"].to(dev))
            mask_c = cpu.mask_logits(c["pyramids"], c["det"]["boxes"],
                                     c["det"]["labels"])
        refereed("mask_logits", mask_k, mask_c, r_mask)

    # the card's own request, as sets
    result["proposals_matched_share"] = _rcnn_matched_share(
        as_detections(g["proposals"]), as_detections(c["proposals"]), True)
    result["detections_matched_share"] = _rcnn_matched_share(
        g["det"], c["det"], True)
    # the f64 referee's own request against the f32 CPU's, the same way
    result["referee_detections_matched_share"] = _rcnn_matched_share(
        r["det"], c["det"], True)
    result["kept_card"] = int((g["det"]["labels"] >= 0).sum())
    if result["proposals_matched_share"] < RCNN_MATCHED_SHARE:
        bad.append("the card's own proposals against the CPU's, as sets")
    if result["detections_matched_share"] < RCNN_MATCHED_SHARE:
        bad.append("the card's own detections against the CPU's, as sets")
    result["launches"] = launches
    print(f"  f32 {'Mask' if with_mask else 'Faster'} R-CNN card vs CPU: "
          + " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 R-CNN predict, card vs CPU: {bad}: "
                             f"{result}")
    return result


# f32 train step, card vs CPU. Both sides run the same arithmetic up to the
# order of f32 sums (cuDNN and cuBLAS against oneDNN, atomics in the
# sampler's backward). The backward also passes some 10**7 ReLU inputs and
# 2 * 9 * B * P sample coordinates per DCN layer; the few that lie within
# f32 rounding of a kink (ReLU at 0, floor at an integer) take the other
# branch on the other side and move every gradient upstream of them a
# little. The "probe" (the card's step on a rounding-sized change of the
# image) measures that sensitivity beside the card-vs-CPU errors. Adam's
# first step (~lr * sign(g)) then moves the parameters whose gradient is
# within that noise of 0 by up to 2 lr apart.
TRAIN_TOL = dict(loss_rtol=1e-4, grad_norm_rtol=1e-3, grad_rel_l2=5e-2,
                 stat_atol=1e-4, stat_rtol=1e-4, param_atol=2 * 5e-4 * 1.01,
                 param_moved_share=1e-2, param_moved_atol=1e-6)


CP_SERVE_KERNELS = ("seg_full_max", "rotated_iou_intersect",
                    "bilinear_gather_fwd")
CP_TRAIN_KERNELS = CP_SERVE_KERNELS + ("seg_full_max_bwd",
                                       "bilinear_gather_bwd_dx")


def _centerpoint_launches(n: int, launched=CP_SERVE_KERNELS):
    """Launch counts of n two-stage CenterPoint requests (n each of the
    segment max, the rotated-box intersection and the row gather) or, with
    ``CP_TRAIN_KERNELS``, train steps (also n of the segment max's backward
    and of the row gather's backward to the map); no other kernel."""
    from minddet_tpu_torch import kernels

    return {k.name: n if k.name in launched else 0 for k in kernels.KERNELS}


def _sampler_launches(n: int, dcn4: bool = False, train: bool = True):
    """Launch counts of n forwards (with ``train``, n train steps) of a
    CenterNet path: 9 of the taps sampler's kernels each and, with
    ``dcn4`` (DCN in all four backbone stages), 2 of the flat sampler's;
    no other kernel."""
    from minddet_tpu_torch import kernels

    per = {"hat_sample_taps_fwd": DCN_LAYERS, "hat_sample_taps_bwd":
           DCN_LAYERS * train}
    if dcn4:
        per.update(hat_sample_flat_fwd=FLAT_LAYERS,
                   hat_sample_flat_bwd=FLAT_LAYERS * train)
    return {k.name: n * per.get(k.name, 0) for k in kernels.KERNELS}


def _train_snapshot(state, metrics, dtype=torch.float32):
    model = state.model
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.detach().to(dtype).cpu()
               for n, p in model.named_parameters()},
        params={n: p.detach().to(dtype).cpu()
                for n, p in model.named_parameters()},
        stats={n: b.detach().to(dtype).cpu()
               for n, b in model.named_buffers() if "running" in n})


def _grad_rel_l2(a, b):
    """Per parameter, |grad_a - grad_b| / |grad_b| (L2). The neck's
    transposed-conv biases feed a train-mode BN that cancels them: their
    gradient is rounding noise around 0, so they are left out."""
    return {n: float((a["grads"][n] - v).norm() / v.norm().clamp_min(1e-30))
            for n, v in b["grads"].items()
            if not (n.startswith("neck.") and n.endswith("up.bias"))}


# The same steps held to a referee, as phase 5c does for CenterPoint: the
# step once more on the CPU in f64 compute (f64 parameters, the f32 values
# widened), from the same weights and batch. Parts are compared as one
# vector each (the neck's transposed-conv biases left out); the bounds are
# kink-sized, as CP_TRAIN_TOL's referee_* ones.
REFEREE_TOL = dict(loss_rtol=1e-4, grad_norm_rtol=1e-3, grad_rel_l2=3e-2,
                   stat_atol=1e-4, stat_rtol=1e-4,
                   param_atol=2 * 5e-4 * 1.01, param_moved_share=1e-2,
                   param_moved_atol=1e-6)
CENTERNET_PARTS = {
    "stage1": ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_"),
    "stages2_4": ("backbone.layer2_", "backbone.layer3_", "backbone.layer4_"),
    "neck": ("neck.",), "head": ("head.",)}
CHECK_RES = 384  # phase 5's image side (the train entry's 512 cut)
CHECK_RES_DCN4 = 256  # phase 5d's image side (the served model's 512 cut)


def _centernet_part_rel_l2(grads, ref, prefixes) -> float:
    names = [n for n in ref if n.startswith(prefixes)
             and not (n.startswith("neck.") and n.endswith("up.bias"))]
    return _rel_l2(torch.cat([grads[n].double().reshape(-1) for n in names]),
                   torch.cat([ref[n].double().reshape(-1) for n in names]))


def _state_checks(g, r, t, label, bad, result):
    """Post-step parameters and BN statistics of snapshot ``g`` against
    ``r``: at most ``param_moved_share`` of the elements more than
    ``param_moved_atol`` apart and none more than ``param_atol``; every
    statistic within ``stat_atol + stat_rtol * |r|``."""
    diffs = {n: (g["params"][n] - v).abs() for n, v in r["params"].items()}
    result[f"{label}param_max_abs_err"] = max(
        float(d.max()) for d in diffs.values())
    moved = sum(int((d > t["param_moved_atol"]).sum())
                for d in diffs.values())
    total = sum(d.numel() for d in diffs.values())
    result[f"{label}param_moved_share"] = moved / total
    if (result[f"{label}param_max_abs_err"] > t["param_atol"]
            or moved / total > t["param_moved_share"]):
        bad.append(f"{label}post-step params")
    stat_err = 0.0
    for n, v in r["stats"].items():
        e = (g["stats"][n] - v).abs()
        stat_err = max(stat_err, float(e.max()))
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"{label}BN statistic {n}")
    result[f"{label}stat_max_abs_err"] = stat_err


def check_train_step_f32(dev, gen, dcn4: bool = False, res: int = 512):
    """Phase 5 (5d with ``dcn4``: DCN in all four backbone stages): one f32
    train step on the card against the same step on the CPU (the plain
    path), at res x res and batch CHECK_BATCH, from the same weights
    (``randomize_for_check``) and batch, with the same step in f64 compute
    on the CPU as referee. Phase 5 holds the card to the f32 CPU
    (TRAIN_TOL) and to the referee (REFEREE_TOL); 5d to the referee, and
    reports the f32 CPU. Both report each f32 run's distance from the
    referee part by part (stem and stage 1, stages 2-4, neck, head)."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import (NUM_CLASSES, centernet_loss,
                                         build_model, synthetic_boxes)
    from minddet_tpu_torch.ops.targets import centernet_targets_batch
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = randomize_for_check(
        build_model("cpu", dtype=torch.float32, dcn4=dcn4), gen)
    models = {"gpu": build_model(dev, dtype=torch.float32, dcn4=dcn4),
              "cpu": cpu,
              "referee": build_model("cpu", dtype=torch.float64, dcn4=dcn4),
              "probe": build_model(dev, dtype=torch.float32, dcn4=dcn4)}
    for name in ("gpu", "referee", "probe"):
        models[name].load_state_dict(cpu.state_dict())
    boxes = synthetic_boxes(CHECK_BATCH, res=res)
    image = torch.randn(CHECK_BATCH, res, res, 3, generator=gen)
    step = make_train_step(centernet_loss)
    snaps, seconds = {}, {}
    # "probe" is the card's step on the image scaled by 1 + 1e-6: how far
    # f32 rounding-sized changes of the input move the gradients here
    for name in ("gpu", "cpu", "referee", "probe"):
        model = models[name]
        img = image * (1 + 1e-6) if name == "probe" else image
        d = next(model.parameters()).device
        b = {k: torch.from_numpy(v).to(d) for k, v in boxes.items()}
        targets = centernet_targets_batch(b["boxes"], b["classes"],
                                          b["mask"], res // 4, res // 4,
                                          NUM_CLASSES, 0.7)
        state = TrainState.create(model, adamw(5e-4, clip_global_norm=35.0))
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, {"image": img.to(d),
                                      "targets": targets})
        snaps[name] = _train_snapshot(state, metrics)
        seconds[name] = time.perf_counter() - t0
        print(f"  {name} step {seconds[name]:.1f} s, loss "
              f"{snaps[name]['metrics']['loss']:.6f}", flush=True)
        if d.type == "cuda":
            launches = {k.name: k.launches for k in kernels.KERNELS}
            if launches != _sampler_launches(1, dcn4):
                raise AssertionError(f"f32 train step launched {launches} "
                                     f"(want {_sampler_launches(1, dcn4)})")
        del state
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32

    g, c, r = snaps["gpu"], snaps["cpu"], snaps["referee"]
    result = {"res": res, "seconds": seconds, "tolerance": TRAIN_TOL,
              "referee_tolerance": REFEREE_TOL}
    bad = []
    rt = REFEREE_TOL
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        for name, snap in (("card", g), ("cpu", c)):
            result[f"{k}_{name}_vs_referee"] = abs(
                snap["metrics"][k] - r["metrics"][k]) / abs(r["metrics"][k])
        if result[f"{k}_card_vs_referee"] > rt["loss_rtol"]:
            bad.append(f"{k} against the referee")
    for name, snap in (("card", g), ("cpu", c)):
        result[f"grad_norm_{name}_vs_referee"] = abs(
            snap["metrics"]["grad_norm"] - r["metrics"]["grad_norm"]) / \
            r["metrics"]["grad_norm"]
    if result["grad_norm_card_vs_referee"] > rt["grad_norm_rtol"]:
        bad.append("grad_norm against the referee")
    for part, prefixes in CENTERNET_PARTS.items():
        for name, snap in (("card", g), ("cpu", c), ("probe",
                                                     snaps["probe"])):
            result[f"grad_{part}_{name}_vs_referee"] = \
                _centernet_part_rel_l2(snap["grads"], r["grads"], prefixes)
        if result[f"grad_{part}_card_vs_referee"] > rt["grad_rel_l2"]:
            bad.append(f"gradient of {part} against the referee")
    _state_checks(g, r, rt, "referee_", bad, result)

    t = TRAIN_TOL
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        err = abs(g["metrics"][k] - c["metrics"][k]) / abs(c["metrics"][k])
        result[f"{k}_rel_err"] = err
        if err > t["loss_rtol"] and not dcn4:
            bad.append(k)
    err = abs(g["metrics"]["grad_norm"] - c["metrics"]["grad_norm"]) / \
        c["metrics"]["grad_norm"]
    result["grad_norm"] = c["metrics"]["grad_norm"]
    result["grad_norm_rel_err"] = err
    if err > t["grad_norm_rtol"] and not dcn4:
        bad.append("grad_norm")
    rel = _grad_rel_l2(g, c)
    worst = max(rel, key=rel.get)
    result["grad_rel_l2_max"] = rel[worst]
    result["grad_rel_l2_worst"] = worst
    for part in ("head", "neck", "backbone"):
        result[f"grad_rel_l2_{part}_median"] = statistics.median(
            v for n, v in rel.items() if n.startswith(part + "."))
    probe_rel = _grad_rel_l2(snaps["probe"], g)
    for part in ("head", "neck", "backbone"):
        result[f"probe_grad_rel_l2_{part}_median"] = statistics.median(
            v for n, v in probe_rel.items() if n.startswith(part + "."))
    result["probe_grad_rel_l2_max"] = max(probe_rel.values())
    if rel[worst] > t["grad_rel_l2"] and not dcn4:
        bad.append(f"gradient of {worst}")
    _state_checks(g, c, t, "", bad if not dcn4 else [], result)
    print("  f32 train step card vs CPU and vs the f64 referee: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if "tolerance" not in k), flush=True)
    if bad:
        raise AssertionError(f"f32 train step: {bad} outside {t} / {rt}: "
                             f"{result}")
    return result


# bilinear_sample_2d's gradients, card vs CPU (phase 5b): out and dx as in
# phase 3; dys and dxs are sums of four dcw (each a 384-term f32 dot product
# of values ~N(0, 1), summed in another order) times weight derivatives <= 1
SAMPLE_GRAD_TOL = dict(out=(1e-5, 1e-5), dx=(1e-5, 1e-5), dys=(1e-3, 1e-4),
                       dxs=(1e-3, 1e-4))


def check_sample_grads_f32(dev, gen, model):
    """Phase 5b: ``bilinear_sample_2d`` differentiated with respect to the
    map, ``ys`` and ``xs`` on the card (K3f forward, K3dx and K3dcw backward,
    one launch each, counted from 0) against the CPU (the plain versions),
    f32, at the second stage's shape: ``model``'s BEV map at batch 2 and 640
    sample points per map, some off it."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.ops.bilinear import bilinear_sample_2d

    bev, fy, fx = _second_stage_inputs(model, 2, gen, "cpu")
    g = torch.randn(2, fy.shape[1], bev.shape[1], generator=gen)
    out = {}
    kernels.reset_launches()
    for name, d in (("gpu", dev), ("cpu", "cpu")):
        x = bev.to(d).permute(0, 2, 3, 1).requires_grad_()
        ys, xs = fy.to(d).requires_grad_(), fx.to(d).requires_grad_()
        y = bilinear_sample_2d(x, ys, xs)
        y.backward(g.to(d))
        out[name] = dict(out=y.detach().cpu(), dx=x.grad.cpu(),
                         dys=ys.grad.cpu(), dxs=xs.grad.cpu())
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = {k.name: int(k.name.startswith("bilinear_gather"))
            for k in kernels.KERNELS}
    result = dict(shape=list(bev.shape), points=fy.shape[1],
                  launches=launches, tolerance=SAMPLE_GRAD_TOL)
    bad = [] if launches == want else [f"launches {launches}"]
    for key, (atol, rtol) in SAMPLE_GRAD_TOL.items():
        a, r = out["gpu"][key], out["cpu"][key]
        result[f"{key}_max_abs_err"] = float((a - r).abs().max())
        result[f"{key}_max_abs"] = float(r.abs().max())
        if not torch.allclose(a, r, rtol=rtol, atol=atol):
            bad.append(key)
    if min(result["dys_max_abs"], result["dxs_max_abs"]) == 0.0:
        bad.append("the coordinates get no gradient")
    print("  bilinear_sample_2d gradients card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"bilinear_sample_2d gradients, card vs CPU: "
                             f"{bad}: {result}")
    return result


# f32 two-stage CenterPoint train step, card vs CPU (phase 5c); the
# reasons for the tolerances are TRAIN_TOL's. The second stage is first
# compared on the same proposals: two right f32 forwards may rank two of
# the 6 x 128 candidates the other way round, and then the sets of 128
# proposals, and everything computed from them, differ.
# The refine head sees 128 rows, 16 or so of them foreground, which carry
# the box loss: one of its 2 x 128 x 128 ReLU inputs within rounding of
# zero moves a foreground row's gradient, and through the row the BEV map's
# and the parameters', by a few percent. So on the same proposals the
# features' gradient is compared row by row (a share of the rows must agree
# to ``row_rel_l2``), and the summed gradients only to a kink-sized bound.
# The whole step's gradients differ more between card and CPU than
# CenterNet's (TRAIN_TOL), and not because both f32 runs are equally noisy:
# the same step runs once more on the CPU with f64 compute over the same f32
# parameters, on the card's proposals (the referee), and the card lies 4 to
# 4000 times closer to it than the f32 CPU does (measured on an H100 host:
# the CPU's train-mode BEV map is 1.6e-4 from the referee's, the card's
# 6e-6; on one BEV map both second stages agree with the referee to 6e-6;
# ``--probe`` shows the distance open at the RPN's first train-mode BN on
# the CPU, more with fewer threads, and grow through the 17 that follow).
# So the card is held to the referee (the ``referee_*`` bounds, kink-sized:
# one ReLU input within rounding of zero moves a part's gradient by up to a
# percent; a part's gradient is compared over its parameters together), and
# to the f32 CPU by the wider bounds that run's own distance from the
# referee asks for.
CP_TRAIN_TOL = dict(loss_rtol=1e-4, stage2_loss_rtol=5e-3,
                    grad_norm_rtol=2e-3, grad_rel_l2=0.15, stat_atol=1e-4,
                    stat_rtol=1e-4, row_rel_l2=5e-2, row_share=0.9,
                    stage2_grad_rel_l2=0.25, same_box_m=1e-2,
                    referee_loss_rtol=1e-4, referee_grad_norm_rtol=1e-3,
                    referee_row_rel_l2=1e-3, referee_grad_rel_l2=3e-2)
CP_CHECK_BATCH = 1
CP_CHECK_GT = 32
CP_PARTS = ("reader", "rpn", "head", "refine")


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _cancelled_bias(name: str) -> bool:
    """A conv bias that a train-mode BN cancels: its gradient is rounding
    noise around 0 (the head's shared conv and each branch's first conv)."""
    return name.endswith("_conv0.bias") or name.endswith("shared_conv.bias")


def _part_rel_l2(grads, ref, part: str) -> float:
    """Relative L2 distance of ``grads`` from ``ref`` over all parameters
    whose name starts with ``part`` taken as one vector (cancelled biases
    left out)."""
    names = [n for n in ref if n.startswith(part) and not _cancelled_bias(n)]
    return _rel_l2(torch.cat([grads[n].double().reshape(-1) for n in names]),
                   torch.cat([ref[n].double().reshape(-1) for n in names]))


def _stage2_on(model, boxes, batch):
    """The second stage's losses of ``model`` (train mode) on the proposals
    ``boxes``, with their gradients with respect to the sampled features
    (B, K, 5 C), the BEV map and the refine head's parameters, and the
    train-mode BEV map itself (f64, on the CPU)."""
    d = next(model.parameters()).device
    batch = {k: v.to(d) for k, v in batch.items()}
    with torch.no_grad():
        bev = model.bev_from_points_stream(batch["points"],
                                           batch["points_mask"])
    bev.requires_grad_()
    sampled = []

    def keep(module, args, out):
        out.retain_grad()
        sampled.append(out)

    hook = model.extractor.register_forward_hook(keep)
    model.zero_grad(set_to_none=True)
    parts = model.stage2_loss(bev, boxes.to(d), batch)
    hook.remove()
    (parts["stage2_score"] + parts["stage2_box"]).backward()
    grads = {"feats": sampled[0].grad.float().cpu(),
             "bev": bev.grad.float().cpu()}
    grads.update({f"refine.{n}": p.grad.float().cpu()
                  for n, p in model.refine.named_parameters()})
    model.zero_grad(set_to_none=True)
    return ({k: float(v.detach()) for k, v in parts.items()}, grads,
            bev.detach().double().cpu())


def _one_centerpoint_step(model, batch, forced=None):
    """One train step of ``model`` (AdamW 1e-3, clip 35) from its present
    weights; with ``forced`` the second stage is given those proposals
    instead of the ones the model decodes. Returns the step's snapshot, the
    proposals used (on the CPU), the kernels' launch counts and the
    seconds."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import model_gt_loss
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    d = next(model.parameters()).device
    decode, used = model.proposals, []

    def proposals(preds):
        used.append(decode(preds) if forced is None else forced.to(d))
        return used[-1]

    model.proposals = proposals
    state = TrainState.create(model, adamw(1e-3, clip_global_norm=35.0))
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = make_train_step(model_gt_loss)(
        state, {k: v.to(d) for k, v in batch.items()})
    snap = _train_snapshot(state, metrics)
    del model.proposals
    launches = {k.name: k.launches for k in kernels.KERNELS}
    return snap, used[0].cpu(), launches, time.perf_counter() - t0


def check_centerpoint_train_f32(dev, gpu):
    """Phase 5c: one f32 two-stage CenterPoint train step at batch
    CP_CHECK_BATCH on the card against the same step on the CPU (TF32 off),
    with the step in f64 compute on the CPU as referee.
    ``gpu`` is the serving model on the card; its heads are calibrated here
    in train mode (batch statistics), so that the proposals' scores spread.
    First the second stage alone on the same proposals (K3f, K4 and K3dx on
    the card): both losses, the BEV map's gradient and the refine head's;
    some ground-truth boxes are moved onto proposals so that there is
    foreground.
    Then the whole step from the same weights: the loss and every part,
    grad_norm, every parameter's gradient by relative L2 and the BN
    statistics after the step. The referee takes the card's proposals, and
    the card is held to it by the ``referee_*`` bounds; where the CPU's
    proposals are not the card's, the f32 CPU's step runs again on the
    card's and that run is compared. The card's and the f32 CPU's distances
    from the referee are reported part by part."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (build_centerpoint,
                                         synthetic_lidar_batch)
    from minddet_tpu_torch.models.detectors.centerpoint import (
        CenterPointTwoStage)

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        CP_CHECK_BATCH, gpu.pc_range, seed=4).items()}
    gpu.train()
    calibrate_centerpoint(gpu, batch["points"].to(dev),
                          batch["points_mask"].to(dev))
    # the proposals both second stages are given: the card's, from a forward
    # made before the weights and statistics are copied
    with torch.no_grad():
        boxes = gpu.proposals(gpu.head(gpu.bev_from_points_stream(
            batch["points"].to(dev), batch["points_mask"].to(dev)))).cpu()
    # random boxes overlap no proposal: the first CP_CHECK_GT ground-truth
    # boxes become copies of proposals, every other one 0.1 m off
    # (foreground) and the rest 1 m off (IoU 0.3 to 0.65, by the yaw), and
    # every coordinate a little off, because the L1 box loss has its kink
    # where a target equals the prediction it was decoded from
    k = CP_CHECK_GT
    gt = boxes[:, :k].clone()
    gt[:, ::2, 0] += 0.1
    gt[:, 1::2, 0] += 1.0
    gt[..., 1] += 0.07
    gt[..., 2] += 0.1
    gt[..., 3:6] *= 1.05
    gt[..., 6:8] += 0.1
    gt[..., 8] += 0.02
    batch["gt_boxes"][:, :k] = gt
    batch["gt_mask"][:, :k] = True
    cpu = build_centerpoint("cpu").train()
    cpu.load_state_dict(gpu.state_dict())
    referee = CenterPointTwoStage(dtype=torch.float64).to(
        memory_format=torch.channels_last).train()
    referee.load_state_dict(cpu.state_dict())

    t = CP_TRAIN_TOL
    result, bad = {"tolerance": t}, []

    def hold_to_referee(key, card, host, ref, part):
        """Report both f32 runs' distances from the referee over ``part``'s
        gradients and hold the card's to ``referee_grad_rel_l2``."""
        result[f"{key}_card_vs_referee"] = _part_rel_l2(card, ref, part)
        result[f"{key}_cpu_vs_referee"] = _part_rel_l2(host, ref, part)
        if result[f"{key}_card_vs_referee"] > t["referee_grad_rel_l2"]:
            bad.append(f"{key} against the referee")

    kernels.reset_launches()
    parts_g, grads_g, bev_g = _stage2_on(gpu, boxes, batch)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != _centerpoint_launches(
            1, CP_SERVE_KERNELS + ("bilinear_gather_bwd_dx",)):
        bad.append(f"the second stage launched {launches}")
    parts_c, grads_c, bev_c = _stage2_on(cpu, boxes, batch)
    parts_r, grads_r, bev_r = _stage2_on(referee, boxes, batch)
    # how far each f32 forward (train-mode BN) is from the f64 one
    result["bev_card_vs_referee"] = _rel_l2(bev_g, bev_r)
    result["bev_cpu_vs_referee"] = _rel_l2(bev_c, bev_r)
    del bev_g, bev_c, bev_r
    for k, v in parts_c.items():
        result[f"same_proposals_{k}"] = v
        result[f"same_proposals_{k}_rel_err"] = abs(parts_g[k] - v) / max(
            abs(v), 1e-30)
        result[f"same_proposals_{k}_cpu_vs_referee"] = abs(
            parts_r[k] - v) / max(abs(parts_r[k]), 1e-30)
        if result[f"same_proposals_{k}_rel_err"] > t["stage2_loss_rtol"]:
            bad.append(f"{k} on the same proposals")
    rows_g, rows_c = grads_g.pop("feats")[0], grads_c.pop("feats")[0]
    rows_r = grads_r.pop("feats")[0]
    row_err = (rows_g - rows_c).norm(dim=-1) / rows_c.norm(
        dim=-1).clamp_min(1e-30)
    result["same_proposals_rows_agreeing"] = float(
        (row_err <= t["row_rel_l2"]).float().mean())
    result["same_proposals_row_rel_l2_median"] = float(row_err.median())
    for name, rows in (("card", rows_g), ("cpu", rows_c)):
        err = (rows - rows_r).norm(dim=-1) / rows_r.norm(dim=-1).clamp_min(
            1e-30)
        result[f"same_proposals_row_rel_l2_median_{name}_vs_referee"] = float(
            err.median())
        result[f"same_proposals_rows_agreeing_{name}_vs_referee"] = float(
            (err <= t["referee_row_rel_l2"]).float().mean())
    if min(result["same_proposals_rows_agreeing"],
           result["same_proposals_rows_agreeing_card_vs_referee"]) < t[
               "row_share"]:
        bad.append("the features' gradient on the same proposals")
    rel = {n: _rel_l2(grads_g[n], v) for n, v in grads_c.items()}
    result["same_proposals_bev_grad_rel_l2"] = rel["bev"]
    worst = max(rel, key=rel.get)
    result["same_proposals_grad_rel_l2_max"] = rel[worst]
    result["same_proposals_grad_rel_l2_worst"] = worst
    if rel[worst] > t["stage2_grad_rel_l2"]:
        bad.append(f"gradient of {worst} on the same proposals")
    for part in ("bev", "refine"):
        hold_to_referee(f"same_proposals_{part}_grad", grads_g, grads_c,
                        grads_r, part)

    # the whole step, all three from the same weights and statistics (the
    # second stage's forwards above moved the running statistics)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu.load_state_dict(start)
    referee.load_state_dict(start)
    g, pg, launches, seconds = _one_centerpoint_step(gpu, batch)
    print(f"  card step {seconds:.1f} s, loss {g['metrics']['loss']:.6f}",
          flush=True)
    if launches != _centerpoint_launches(1, CP_TRAIN_KERNELS):
        bad.append(f"the train step launched {launches}")
    c, pc, _, seconds = _one_centerpoint_step(cpu, batch)
    print(f"  CPU step {seconds:.1f} s, loss {c['metrics']['loss']:.6f}",
          flush=True)
    r, _, _, seconds = _one_centerpoint_step(referee, batch, forced=pg)
    print(f"  CPU f64 step on the card's proposals {seconds:.1f} s, loss "
          f"{r['metrics']['loss']:.6f}", flush=True)
    # the same proposals, in whatever order: every CPU box has a card box
    # within ``same_box_m`` of it
    dist = (pg[:, :, None, :8] - pc[:, None, :, :8]).abs().amax(-1)
    same = bool((dist.amin(1) < t["same_box_m"]).all())
    result["proposals_same_set"] = same
    result["proposals_unmatched"] = int(
        (dist.amin(1) >= t["same_box_m"]).sum())
    result["proposals_worst_match"] = float(dist.amin(1).max())
    result["proposals_same_order"] = bool(
        ((pg - pc)[..., :8].abs() < t["same_box_m"]).all())
    if not same:
        cpu.load_state_dict(start)
        c, _, _, seconds = _one_centerpoint_step(cpu, batch, forced=pg)
        print(f"  CPU step on the card's proposals {seconds:.1f} s, loss "
              f"{c['metrics']['loss']:.6f}", flush=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32

    for k, v in c["metrics"].items():
        if k == "grad_norm":
            continue
        err = abs(g["metrics"][k] - v) / max(abs(v), 1e-30)
        result[f"{k}_rel_err"] = err
        stage2 = k.startswith("stage2") or k == "loss"
        if err > (t["stage2_loss_rtol"] if stage2 else t["loss_rtol"]):
            bad.append(k)
        for name, snap in (("card", g), ("cpu", c)):
            result[f"{k}_{name}_vs_referee"] = abs(
                snap["metrics"][k] - r["metrics"][k]) / max(
                    abs(r["metrics"][k]), 1e-30)
        if result[f"{k}_card_vs_referee"] > t["referee_loss_rtol"]:
            bad.append(f"{k} against the referee")
    result["loss"] = c["metrics"]["loss"]
    result["stage2_box"] = c["metrics"]["stage2_box"]
    result["grad_norm"] = c["metrics"]["grad_norm"]
    err = abs(g["metrics"]["grad_norm"] - result["grad_norm"]) / \
        result["grad_norm"]
    result["grad_norm_rel_err"] = err
    for name, snap in (("card", g), ("cpu", c)):
        result[f"grad_norm_{name}_vs_referee"] = abs(
            snap["metrics"]["grad_norm"] - r["metrics"]["grad_norm"]) / \
            r["metrics"]["grad_norm"]
    if err > t["grad_norm_rtol"]:
        bad.append("grad_norm")
    if result["grad_norm_card_vs_referee"] > t["referee_grad_norm_rtol"]:
        bad.append("grad_norm against the referee")
    rel = {n: _rel_l2(g["grads"][n], v) for n, v in c["grads"].items()
           if not _cancelled_bias(n)}
    for part in CP_PARTS:
        result[f"grad_rel_l2_{part}_max"] = max(
            v for n, v in rel.items() if n.startswith(part + "."))
        hold_to_referee(f"grad_{part}", g["grads"], c["grads"], r["grads"],
                        part + ".")
    worst = max(rel, key=rel.get)
    result["grad_rel_l2_worst"] = [
        f"{n} {v:.2e}" for n, v in sorted(rel.items(),
                                          key=lambda kv: -kv[1])[:6]]
    if rel[worst] > t["grad_rel_l2"]:
        bad.append(f"gradient of {worst}")
    stat_err = 0.0
    for n, v in c["stats"].items():
        e = (g["stats"][n] - v).abs()
        stat_err = max(stat_err, float(e.max()))
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"BN statistic {n}")
        e = (g["stats"][n] - r["stats"][n]).abs()
        if not bool((e <= t["stat_atol"] + t["stat_rtol"] * v.abs()).all()):
            bad.append(f"BN statistic {n} against the referee")
    result["stat_max_abs_err"] = stat_err
    _hold_single_stage_step(dev, start, batch, result, bad)
    print("  f32 CenterPoint train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 CenterPoint train step, card vs CPU: "
                             f"{bad} outside {t}: {result}")
    return result


def _hold_single_stage_step(dev, start, batch, result, bad):
    """Phase 5c's single-stage step: ``CenterPoint.loss_from_gt`` under the
    train step (AdamW 1e-3, clip 35) from the two-stage weights ``start``
    without the refine head, on the card, the f32 CPU and the f64 referee
    (TF32 off), on ``batch``. The card launches K5f and K5b once each and
    nothing else; its loss, parts and grad_norm, the reader's, the RPN's
    and the head's gradients and the BN statistics are held to the referee
    by ``CP_TRAIN_TOL``'s ``referee_*`` bounds (the statistics also to the
    f32 CPU); the CPU's distances are reported. Readings go into
    ``result`` under ``single_stage_``."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import model_gt_loss
    from minddet_tpu_torch.models.detectors.centerpoint import CenterPoint
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    t = CP_TRAIN_TOL
    weights = {k: v for k, v in start.items() if not k.startswith("refine.")}
    snaps = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, d, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("referee", "cpu", torch.float64)):
            model = CenterPoint(dtype=dtype).to(
                device=d, memory_format=torch.channels_last)
            model.load_state_dict(weights)
            state = TrainState.create(model,
                                      adamw(1e-3, clip_global_norm=35.0))
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, metrics = make_train_step(model_gt_loss)(
                state, {k: v.to(d) for k, v in batch.items()})
            snaps[name] = _train_snapshot(state, metrics)
            launches = {k.name: k.launches for k in kernels.KERNELS}
            print(f"  single-stage {name} step "
                  f"{time.perf_counter() - t0:.1f} s, loss "
                  f"{snaps[name]['metrics']['loss']:.6f}", flush=True)
            if name == "card" and launches != _centerpoint_launches(
                    1, ("seg_full_max", "seg_full_max_bwd")):
                bad.append(f"the single-stage train step launched "
                           f"{launches}")
            del state, model
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    g, c, r = snaps["card"], snaps["cpu"], snaps["referee"]
    pre = "single_stage_"
    for k, v in r["metrics"].items():
        for name, snap in (("card", g), ("cpu", c)):
            result[f"{pre}{k}_{name}_vs_referee"] = abs(
                snap["metrics"][k] - v) / max(abs(v), 1e-30)
        bound = t["referee_grad_norm_rtol" if k == "grad_norm"
                  else "referee_loss_rtol"]
        if result[f"{pre}{k}_card_vs_referee"] > bound:
            bad.append(f"{pre}{k} against the referee")
    for part in CP_PARTS[:3]:
        for name, snap in (("card", g), ("cpu", c)):
            result[f"{pre}grad_{part}_{name}_vs_referee"] = _part_rel_l2(
                snap["grads"], r["grads"], part + ".")
        if result[f"{pre}grad_{part}_card_vs_referee"] > t[
                "referee_grad_rel_l2"]:
            bad.append(f"{pre}gradient of {part} against the referee")
    stat_err = 0.0
    for n, v in r["stats"].items():
        for label, snap in (("", c), (" against the referee", r)):
            e = (g["stats"][n] - snap["stats"][n]).abs()
            stat_err = max(stat_err, float(e.max()))
            if not bool((e <= t["stat_atol"] + t["stat_rtol"]
                         * snap["stats"][n].abs()).all()):
                bad.append(f"{pre}BN statistic {n}{label}")
    result[f"{pre}stat_max_abs_err"] = stat_err


# f32 PointPillars train step, card vs CPU vs an f64 CPU referee (phase 5g):
# the KITTI car model at full width (496 x 432 grid, 107,136 anchors) at
# batch PP_CHECK_BATCH, seeded weights with BN off identity. The targets are
# first made on the card from the CPU's inputs (anchor mask, boxes): the
# labels may differ only for an anchor whose IoU (in f64) lies within
# ``near_threshold`` of 0.6, 0.45 or a box's best (the card's kernels
# contract multiply-adds into FMAs), the box targets of anchors both sides
# put in the foreground within ``target_atol``. The step's kinks (ReLU,
# smooth L1 at 1/9, the focal modulator) and its 20 train-mode BN layers
# (the PFN's over the pillars, the RPN's 19 on 248 x 216, 124 x 108 and
# 62 x 54 maps) make the f32 CPU itself a noisy judge (``CP_TRAIN_TOL``'s comment), so,
# as 5e / 5f, the card's gradients are held to the referee at most
# ``referee_k`` times as far from it as the f32 CPU's, plus a floor.
PP_CHECK_BATCH = 2
PP_TRAIN_TOL = dict(loss_rtol=1e-4, referee_loss_rtol=1e-4,
                    grad_norm_rtol=1e-3, referee_k=HEAD_REFEREE_K,
                    referee_grad_norm_floor=1e-4, referee_grad_floor=1e-3,
                    stat_atol=1e-4, stat_rtol=1e-4, target_atol=1e-5,
                    near_threshold=1e-6)
PP_PARTS = ("reader.", "rpn.", "conv_")


def _pp_check_model(dtype, dev=None):
    from minddet_tpu_torch.entry import SEED
    from minddet_tpu_torch.models.detectors.pointpillars import PointPillars

    model = PointPillars(dtype=dtype).init_weights(
        torch.Generator().manual_seed(SEED))
    return model.to(device=dev, memory_format=torch.channels_last)


@torch.no_grad()
def _pp_anchor_mask(model, batch):
    """The anchor mask of ``batch`` from an eval-mode forward (which moves
    no BN statistic)."""
    training = model.training
    _, occ = model.eval().canvas_from_points(batch["points"],
                                             batch["points_mask"])
    model.train(training)
    return model.area_mask(occ)


def _near_threshold_anchors(anchors, gt, gt_mask, eps):
    """(B, A) anchors whose nearest-BEV IoU (f64) with a real box lies
    within ``eps`` of 0.6, 0.45 or that box's best."""
    from minddet_tpu_torch.ops.box import pairwise_iou, rbbox_to_near_bbox

    bev = [0, 1, 3, 4, 6]
    iou = pairwise_iou(rbbox_to_near_bbox(anchors[:, bev].double()),
                       rbbox_to_near_bbox(gt[..., bev].double()))
    iou = torch.where(gt_mask[:, None], iou, -1.0)
    best = iou.amax(1, keepdim=True)
    near = (((iou - 0.6).abs() < eps) | ((iou - 0.45).abs() < eps)
            | (((iou - best).abs() < eps) & (iou > 0)))
    return near.any(-1)


def check_pointpillars_train_f32(dev):
    """Phase 5g: one f32 PointPillars train step (``PointPillars.
    loss_from_gt``, AdamW 2e-4) at full width, batch PP_CHECK_BATCH, on the
    card against the same step on the CPU (TF32 off) and in f64 compute on
    the CPU (the referee), from the same weights and batch
    (``synthetic_lidar_batch(box_dim=7)``, seed 5): the anchor mask card vs
    CPU exactly; the targets on the CPU's inputs (``PP_TRAIN_TOL``); the
    loss, its parts and grad_norm against both; every parameter's gradient
    and each part's (reader, RPN, heads) against the referee, at most
    ``referee_k`` times the f32 CPU's distance plus a floor; the BN
    statistics after the step against both. The card launches no
    hand-written kernel."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_pointpillars_train_f32(dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _check_pointpillars_train_f32(dev):
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import (CLOUD_POINTS, PP_TRAIN_LR,
                                         PP_TRAIN_MAX_GT, model_gt_loss,
                                         synthetic_lidar_batch)
    from minddet_tpu_torch.ops.anchors import assign_targets_batch
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    t = PP_TRAIN_TOL
    gen = _seeded("5g")
    cpu = _pp_check_model(torch.float32)
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "running_var"):
                m.weight.uniform_(0.6, 1.4, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu = _pp_check_model(torch.float32, dev)
    referee = _pp_check_model(torch.float64)
    for m in (gpu, referee):
        m.load_state_dict(start)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        PP_CHECK_BATCH, cpu.pc_range, CLOUD_POINTS, PP_TRAIN_MAX_GT,
        num_classes=1, seed=5, num_features=4, box_dim=7).items()}
    result, bad = {"tolerance": t}, []

    # the targets on the CPU's inputs
    amask = _pp_anchor_mask(cpu, batch)
    if not torch.equal(
            _pp_anchor_mask(gpu, {k: v.to(dev) for k, v in batch.items()})
            .cpu(), amask):
        bad.append("anchor mask")
    args = (cpu.anchors, batch["gt_boxes"], batch["gt_classes"],
            batch["gt_mask"], cpu.matched_threshold,
            cpu.unmatched_threshold, amask)
    tc = assign_targets_batch(*args)
    tg = {k: v.cpu() for k, v in assign_targets_batch(
        *(a.to(dev) for a in args)).items()}
    near = _near_threshold_anchors(cpu.anchors, batch["gt_boxes"],
                                   batch["gt_mask"], t["near_threshold"])
    differ = tg["labels"] != tc["labels"]
    result.update(anchor_mask_share=float(amask.float().mean()),
                  positives=int((tc["labels"] > 0).sum()),
                  ignored=int((tc["labels"] == -1).sum()),
                  labels_differ=int(differ.sum()),
                  anchors_near_threshold=int(near.sum()))
    if bool((differ & ~near).any()):
        bad.append("target labels on the same inputs")
    fg = (tg["labels"] > 0) & (tc["labels"] > 0)
    result["target_max_abs_err"] = float(
        (tg["bbox_targets"] - tc["bbox_targets"])[fg].abs().max())
    if result["target_max_abs_err"] > t["target_atol"]:
        bad.append("box targets on the same inputs")
    if not bool((tc["labels"] > 0).sum(1).min() > 0):
        bad.append("a cloud without positives")

    snaps = {}
    for name, model in (("card", gpu), ("cpu", cpu), ("referee", referee)):
        d = next(model.parameters()).device
        state = TrainState.create(model, adamw(PP_TRAIN_LR))
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = make_train_step(model_gt_loss)(
            state, {k: v.to(d) for k, v in batch.items()})
        snaps[name] = _train_snapshot(state, metrics)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        print(f"  {name} step {time.perf_counter() - t0:.1f} s, loss "
              f"{snaps[name]['metrics']['loss']:.6f}", flush=True)
        if name == "card" and any(launches.values()):
            bad.append(f"the train step launched {launches}")
        del state
    _referee_checks(snaps["card"], snaps["cpu"], snaps["referee"], t,
                    PP_PARTS, "", result, bad)
    print("  f32 PointPillars train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 PointPillars train step, card vs CPU: "
                             f"{bad} outside {t}: {result}")
    return result


# f32 R-CNN train step, card vs CPU vs an f64 CPU referee (phases 5e, 5f):
# ResNet-50-FPN, 80 classes, cut to 256 x 256, batch 2 and 64 ROI samples
# per image, so that the CPU's f32 and f64 steps take seconds. The RPN
# targets depend on the anchors, the GT and the draws only; the CPU and the
# referee take the card's proposals, so all three sample the same rois and
# every discrete choice of the loss is the same: what differs is f32
# rounding through the train-mode network and its kinks (ReLU, smooth L1).
# The losses and BN statistics take TRAIN_TOL's bounds. The f32 CPU itself
# lies 2.4-3.0e-2 (relative L2) from the referee on the backbone's gradient
# and up to 3.7e-2 on single parameters' (measured beside an H100 80GB HBM3
# at 700 W): the gradient passes 53 train-mode BN layers. So, as phases 4, 4d, 4e hold
# the heads, the card's gradients and grad_norm are held to the referee at
# most ``referee_k`` times as far from it as the f32 CPU, plus a floor.
RCNN_CHECK = dict(res=256, batch=2, roi_samples=64)
RCNN_TRAIN_TOL = dict(loss_rtol=1e-4, referee_loss_rtol=1e-4,
                      grad_norm_rtol=1e-3, referee_k=HEAD_REFEREE_K,
                      referee_grad_norm_floor=1e-4,
                      referee_grad_floor=1e-3, stat_atol=1e-4,
                      stat_rtol=1e-4)
RCNN_PARTS = ("backbone.", "fpn.", "rpn.", "box_head.", "mask_head.")
RCNN_CROP_TIE = 1e-5  # crops this close to 0.5 may take either side


def _rcnn_check_model(with_mask, dtype, dev=None):
    from minddet_tpu_torch.entry import MASK_STRIDE, NUM_CLASSES
    from minddet_tpu_torch.models.detectors.faster_rcnn import FasterRCNN

    res = RCNN_CHECK["res"]
    model = FasterRCNN(num_classes=NUM_CLASSES, depth=50,
                       image_hw=(res, res), rpn_pre_nms=1000,
                       rpn_post_nms=512,
                       roi_samples=RCNN_CHECK["roi_samples"],
                       with_mask=with_mask, mask_stride=MASK_STRIDE,
                       dtype=dtype)
    return model.to(device=dev, memory_format=torch.channels_last)


def _one_rcnn_step(model, batch, draws, forced=None):
    """One SGD train step of ``model`` (the R-CNN config's lr, momentum and
    weight decay) on ``batch`` and ``draws``; with ``forced`` the loss takes
    those proposals instead of its own. Returns the snapshot, the
    proposals used (on the CPU), the box head's input (on the CPU), the
    launch counts and the seconds."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.core.optim import sgd
    from minddet_tpu_torch.entry import (RCNN_LR, RCNN_MOMENTUM,
                                         RCNN_WEIGHT_DECAY, rcnn_loss)
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    d = next(model.parameters()).device
    make, used, feats = model.proposals, [], []

    def proposals(logits, deltas):
        out = make(logits, deltas) if forced is None else (forced.to(d),
                                                           None, 0)
        used.append(out[0])
        return out

    model.proposals = proposals
    hook = model.box_head.register_forward_pre_hook(
        lambda m, args: feats.append(args[0].detach().cpu()))
    state = TrainState.create(model, sgd(RCNN_LR, momentum=RCNN_MOMENTUM,
                                         weight_decay=RCNN_WEIGHT_DECAY))
    data = {k: v.to(d) for k, v in batch.items()}
    data["draws"] = {k: v.to(d) for k, v in draws.items()}
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = make_train_step(rcnn_loss)(state, data)
    snap = _train_snapshot(state, metrics)
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    hook.remove()
    del model.proposals
    return snap, used[0].cpu(), feats[0], launches, seconds


def rcnn_train_launches(with_mask: bool, steps: int = 1):
    """Launch counts of ``steps`` R-CNN train steps: the row gather 4 times
    per step (the box ROIAlign's levels), 9 with the masks (the mask
    ROIAlign's levels and the GT bitmaps' crop); its map gradient 4, or 8
    with the masks; nothing else (the rois are detached: no K3dcw)."""
    from minddet_tpu_torch import kernels

    per = {"bilinear_gather_fwd": 9 if with_mask else 4,
           "bilinear_gather_bwd_dx": 8 if with_mask else 4}
    return {k.name: steps * per.get(k.name, 0) for k in kernels.KERNELS}


def check_rcnn_train_f32(dev, with_mask: bool, gen):
    """Phases 5e (Faster R-CNN) and 5f (Mask R-CNN): one f32 train step
    (``RCNN_CHECK``: ResNet-50-FPN at 256 x 256, batch 2, 64 ROI samples,
    SGD) on the card against the same step on the CPU (TF32 off) and in
    f64 compute on the CPU (the referee), from the same weights (seeded,
    BN randomized by ``randomize_bn``), batch (``synthetic_rcnn_batch``
    at 256 x 256) and draws; the CPU and the referee take the card's
    proposals. The step is held once more from the train entries' own
    starting weights (``init_weights``, then ``seed_rcnn_for_training``,
    from the entries' seeds), its readings under ``entry_start_...``.

    - every discrete stage on the CPU's inputs (from the randomized BN):
      the card's proposals from the CPU's RPN outputs (slot by slot, or as
      sets where a candidate pair's IoU lies within PP_NEAR of 0.7), its
      RPN targets and ROI sample on the same inputs exactly (deltas within
      RCNN_BOX_TOL), with the masks its mask targets too (but where a crop
      lies within RCNN_CROP_TIE of 0.5);
    - the step: the loss and every part against the referee and the f32
      CPU; grad_norm, every parameter's gradient (relative L2) and each
      part's (backbone, FPN, RPN, box head, mask head) against the referee,
      at most ``referee_k`` times as far from it as the f32 CPU's (plus a
      floor), and grad_norm against the f32 CPU; the BN statistics after
      the step against both (``RCNN_TRAIN_TOL``);
    - ungated: the box head on the CPU's ROI features with its layers in
      f64 on the card (``box_head_f64_readings``).

    The card's step launches K3f 4 (9 with the masks) and K3dx 4 (8)
    times, nothing else."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_rcnn_train_f32(dev, with_mask, gen)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _referee_checks(g, c, r, t, parts, prefix, result, bad, kinked=()):
    """Hold one f32 train step's snapshot ``g`` (the card) to the f64
    referee's ``r``, with the f32 CPU's ``c`` as the measure of f32
    rounding (phases 5e, 5f, 5g; bounds ``t``): the loss and each part
    within ``referee_loss_rtol`` of the referee and ``loss_rtol`` of the
    CPU; grad_norm within ``grad_norm_rtol`` of the CPU; grad_norm, each
    part's gradient (the parameters named with a prefix in ``parts``, taken
    as one vector) and every parameter's at most ``referee_k`` times as far
    from the referee as the CPU's, plus a floor; the BN statistics within
    ``stat_atol + stat_rtol * |x|`` of both. Readings go into ``result``
    under ``prefix``, failed checks into ``bad``. Where ``grad_norm_rtol``
    is None grad_norm is held to the referee only. The floor of a part or
    parameter is ``referee_grad_floor``, or where ``t`` has
    ``part_floors`` the floor given for the first prefix of its name there.
    A parameter whose referee gradient is exactly 0 gets none on any side:
    it is counted apart and held to 0 on the card, and a part whose
    parameters all get none fails (its gradient is held by nothing). Where
    ``t`` has ``cancelled``, a parameter whose referee gradient lies under
    ``cancelled`` times the largest of all (but not at 0) is one whose
    gradient cancels (a BN bias seen only through a linear layer and a
    train-mode BN): its gradient is rounding noise on every side, so it is
    held under CANCELLED_NOISE times the largest gradient instead of to
    the referee. A parameter in ``kinked`` (one the caller found upstream
    of a ReLU that rounding flipped where the loss reaches it) that lies
    past the per-parameter bound is reported under
    ``params_past_the_bound_at_a_kink`` and held within
    ``t["kink_grad_rel_l2"]`` of the referee instead."""

    def beyond(card, host, floor):
        """The card farther from the referee than the f32 CPU allows."""
        return card > t["referee_k"] * host + floor

    def floor_of(name):
        return next((f for p, f in t.get("part_floors", {}).items()
                     if name.startswith(p)), t["referee_grad_floor"])

    largest = max(float(v.abs().max()) for v in r["grads"].values())
    zero = {n for n, v in r["grads"].items() if not bool(v.any())}
    result[f"{prefix}zero_grads"] = len(zero)
    if zero:
        result[f"{prefix}zero_grad_names"] = sorted(zero)[:6]
        if any(bool(g["grads"][n].any()) for n in zero):
            bad.append(f"{prefix}gradients on the card where the referee's "
                       f"are 0")
    noise = set() if t.get("cancelled") is None else {
        n for n, v in r["grads"].items()
        if float(v.abs().max()) < t["cancelled"] * largest} - zero
    if noise:
        card_noise = max(float(g["grads"][n].abs().max()) for n in noise)
        result[f"{prefix}cancelled_grads"] = len(noise)
        result[f"{prefix}cancelled_grad_max_card"] = card_noise / largest
        if card_noise > CANCELLED_NOISE * largest:
            bad.append(f"{prefix}cancelled gradients on the card")

    for k, v in r["metrics"].items():
        scale = max(abs(v), 1e-30)
        card = result[f"{prefix}{k}_card_vs_referee"] = abs(
            g["metrics"][k] - v) / scale
        cpu_d = result[f"{prefix}{k}_cpu_vs_referee"] = abs(
            c["metrics"][k] - v) / scale
        host = abs(g["metrics"][k] - c["metrics"][k]) / max(
            abs(c["metrics"][k]), 1e-30)
        result[f"{prefix}{k}_rel_err"] = host
        if k == "grad_norm":
            if beyond(card, cpu_d, t["referee_grad_norm_floor"]):
                bad.append(f"{prefix}grad_norm against the referee")
            if t["grad_norm_rtol"] is not None and host > t["grad_norm_rtol"]:
                bad.append(prefix + k)
            continue
        if card > t["referee_loss_rtol"]:
            bad.append(f"{prefix}{k} against the referee")
        if host > t["loss_rtol"]:
            bad.append(prefix + k)
    for part in parts:
        names = [n for n in r["grads"] if n.startswith(part)]
        if not names:
            continue
        key = prefix + "grad_" + part.rstrip("._")
        if all(n in zero for n in names):
            bad.append(f"{key}: the referee's gradient is 0 throughout")
            continue
        card = result[f"{key}_card_vs_referee"] = _part_rel_l2(
            g["grads"], r["grads"], part)
        cpu_d = result[f"{key}_cpu_vs_referee"] = _part_rel_l2(
            c["grads"], r["grads"], part)
        if beyond(card, cpu_d, floor_of(part)):
            bad.append(f"{key} against the referee")
    rel = {n: _rel_l2(g["grads"][n].double(), v.double())
           for n, v in r["grads"].items() if n not in noise | zero}
    rel_cpu = {n: _rel_l2(c["grads"][n].double(), v.double())
               for n, v in r["grads"].items() if n not in noise | zero}
    result[f"{prefix}grad_rel_l2_worst_card_vs_referee"] = [
        f"{n} {v:.2e} (CPU {rel_cpu[n]:.2e})"
        for n, v in sorted(rel.items(), key=lambda kv: -kv[1])[:6]]
    far = [n for n in rel if beyond(rel[n], rel_cpu[n], floor_of(n))]
    result[f"{prefix}params_beyond_the_referee_bound"] = len(far)
    at_kink = [n for n in far if n in kinked]
    if at_kink:
        result[f"{prefix}params_past_the_bound_at_a_kink"] = [
            f"{n} {rel[n]:.2e} (CPU {rel_cpu[n]:.2e})" for n in at_kink]
        bad += [f"{prefix}gradient of {n} at a kink" for n in at_kink
                if rel[n] > t["kink_grad_rel_l2"]]
        far = [n for n in far if n not in kinked]
    if far:
        bad.append(f"{prefix}gradients of {far[:6]} against the referee")
    stat_err = 0.0
    for n, v in r["stats"].items():
        for label, snap in (("", c), (" against the referee", r)):
            e = (g["stats"][n] - snap["stats"][n]).abs()
            stat_err = max(stat_err, float(e.max()))
            if not bool((e <= t["stat_atol"] + t["stat_rtol"]
                         * snap["stats"][n].abs()).all()):
                bad.append(f"{prefix}BN statistic {n}{label}")
    result[f"{prefix}stat_max_abs_err"] = stat_err
    result[f"{prefix}param_max_abs_err_card_vs_referee"] = max(
        float((g["params"][n] - v).abs().max())
        for n, v in r["params"].items())


def _hold_rcnn_train_step(gpu, cpu, referee, batch, draws, with_mask,
                          prefix, result, bad):
    """One SGD step of phase 5e / 5f: the card on its own proposals, the
    CPU and the referee on the card's, all three from the weights they
    hold; the readings go into ``result`` under ``prefix``, the checks
    that fail into ``bad`` (``RCNN_TRAIN_TOL``). Returns the box head's
    input on the CPU."""
    t = RCNN_TRAIN_TOL
    g, pg, _, launches, seconds = _one_rcnn_step(gpu, batch, draws)
    print(f"  card step {seconds:.1f} s, loss {g['metrics']['loss']:.6f}",
          flush=True)
    if launches != rcnn_train_launches(with_mask):
        bad.append(f"{prefix}the train step launched {launches}")
    result[f"{prefix}launches"] = launches
    c, _, feats, _, seconds = _one_rcnn_step(cpu, batch, draws, forced=pg)
    print(f"  CPU step on the card's proposals {seconds:.1f} s, loss "
          f"{c['metrics']['loss']:.6f}", flush=True)
    r, _, _, _, seconds = _one_rcnn_step(referee, batch, draws, forced=pg)
    print(f"  CPU f64 step on the card's proposals {seconds:.1f} s, loss "
          f"{r['metrics']['loss']:.6f}", flush=True)
    _referee_checks(g, c, r, t, RCNN_PARTS, prefix, result, bad)
    return feats


def _check_rcnn_train_f32(dev, with_mask, gen):
    import copy

    from minddet_tpu_torch.entry import (SEED, seed_rcnn_for_training,
                                         synthetic_rcnn_batch)
    from minddet_tpu_torch.models.heads.roi_head import (mask_targets,
                                                         sample_proposals)
    from minddet_tpu_torch.models.heads.rpn_head import proposal_candidates
    from minddet_tpu_torch.ops.anchors2d import rpn_targets
    from minddet_tpu_torch.ops.roi_align import roi_align

    res, b = RCNN_CHECK["res"], RCNN_CHECK["batch"]
    t = RCNN_TRAIN_TOL
    cpu = _rcnn_check_model(with_mask, torch.float32)
    cpu.init_weights(torch.Generator().manual_seed(SEED))
    randomize_bn(cpu, torch.rand(b, res, res, 3, generator=gen), gen)
    gpu = _rcnn_check_model(with_mask, torch.float32, dev)
    gpu.load_state_dict(cpu.state_dict())
    referee = _rcnn_check_model(with_mask, torch.float64)
    referee.load_state_dict(cpu.state_dict())
    heads = {k: copy.deepcopy(m.box_head)
             for k, m in (("card", gpu), ("cpu", cpu), ("ref", referee))}
    # the weights and statistics every step starts from (the train-mode
    # forward below moves the CPU's statistics)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_rcnn_batch(b, with_mask, res).items()}
    draws = cpu.sampling_draws(b, batch["gt_boxes"].shape[1], gen)
    result, bad = {"tolerance": t}, []

    # every discrete stage on the CPU's inputs
    cpu.train()
    gpu.train()
    with torch.no_grad():
        _, c_logits, c_deltas = cpu(batch["image"])
    c_props, _, _ = cpu.proposals(c_logits, c_deltas)
    with torch.inference_mode():
        g_props, _, _ = gpu.proposals(c_logits.to(dev), c_deltas.to(dev))
    cand_boxes, cand_scores = proposal_candidates(
        c_logits, c_deltas, cpu.anchors, cpu.level_sizes, cpu.image_hw,
        cpu.rpn_pre_nms)
    near = result["rpn_near_threshold_pairs"] = sum(
        _near_iou_pairs(cand_boxes[i:i + 1], cand_scores[i:i + 1],
                        RCNN_RPN_NMS_IOU) for i in range(b))
    atol, rtol = RCNN_BOX_TOL
    pk, pc = g_props.cpu().double(), c_props.double()
    same = bool(((pk - pc).abs() <= atol + rtol * pc.abs()).all())
    result["proposals_same_inputs_slot_by_slot"] = same

    def as_detections(props):
        real = props.abs().sum(-1) > 0
        return dict(labels=real.long() - (~real).long(), boxes=props,
                    scores=torch.zeros_like(props[..., 0]))

    result["proposals_same_inputs_matched_share"] = min(
        _rcnn_matched_share(as_detections(g_props[i:i + 1]),
                            as_detections(c_props[i:i + 1]))
        for i in range(b))
    if not same and (near == 0 or result[
            "proposals_same_inputs_matched_share"] < RCNN_MATCHED_SHARE):
        bad.append("proposals of the card on the CPU's RPN outputs")

    gt = {k: batch[k] for k in ("gt_boxes", "gt_classes", "gt_mask")}
    tc = rpn_targets(draws["rpn"][:, 0], draws["rpn"][:, 1], cpu.anchors,
                     gt["gt_boxes"], gt["gt_mask"])
    tg = rpn_targets(draws["rpn"][:, 0].to(dev), draws["rpn"][:, 1].to(dev),
                     gpu.anchors, gt["gt_boxes"].to(dev),
                     gt["gt_mask"].to(dev))
    for k in ("labels", "cls_weights", "reg_weights"):
        if not torch.equal(tg[k].cpu(), tc[k]):
            bad.append(f"RPN targets' {k} on the same inputs")
    result["rpn_positives"] = int(tc["reg_weights"].sum())
    result["rpn_sampled"] = int(tc["cls_weights"].sum())
    err = (tg["deltas"].cpu() - tc["deltas"]).abs()
    if not bool((err <= atol + rtol * tc["deltas"].abs()).all()):
        bad.append("RPN target deltas on the same inputs")
    roi = draws["roi"]
    sc = sample_proposals(roi[:, 0], roi[:, 1], roi[:, 2], c_props,
                          gt["gt_boxes"], gt["gt_classes"], gt["gt_mask"],
                          RCNN_CHECK["roi_samples"])
    roi_d = roi.to(dev)
    sg = sample_proposals(roi_d[:, 0], roi_d[:, 1], roi_d[:, 2],
                          c_props.to(dev), gt["gt_boxes"].to(dev),
                          gt["gt_classes"].to(dev), gt["gt_mask"].to(dev),
                          RCNN_CHECK["roi_samples"])
    for k in ("rois", "cls_target", "pos_mask", "valid_mask", "matched_gt"):
        if not torch.equal(sg[k].cpu(), sc[k]):
            bad.append(f"ROI sample's {k} on the same inputs")
    err = (sg["delta_target"].cpu() - sc["delta_target"]).abs()
    if not bool((err <= atol + rtol * sc["delta_target"].abs()).all()):
        bad.append("ROI sample's delta targets on the same inputs")
    result["roi_positives"] = int(sc["pos_mask"].sum())
    result["roi_zero_area"] = int(((sc["rois"][..., 2:] - sc["rois"][..., :2])
                                   .prod(-1) <= 0).sum())
    if with_mask:
        mc = mask_targets(batch["gt_bitmaps"], sc, stride=cpu.mask_stride)
        mg = mask_targets(batch["gt_bitmaps"].to(dev),
                          {k: v.to(dev) for k, v in sc.items()},
                          stride=cpu.mask_stride).cpu()
        crops = roi_align(batch["gt_bitmaps"], sc["rois"] / cpu.mask_stride,
                          (RCNN_MASK_SIZE, RCNN_MASK_SIZE), 2)
        crops = torch.gather(crops, -1, sc["matched_gt"][
            :, :, None, None, None].expand(*crops.shape[:-1], 1))[..., 0]
        tie = (crops - 0.5).abs() < RCNN_CROP_TIE
        result["mask_target_pixels"] = int(mc.sum())
        result["mask_target_flips"] = int((mg != mc).sum())
        result["mask_target_near_half"] = int(tie.sum())
        if bool(((mg != mc) & ~tie).any()):
            bad.append("mask targets on the same inputs")

    # the step from these weights, then from the train entries' own
    # starting weights (whose zero-scale residual BN gives the residual
    # branches no gradient at their first step, so it does not replace the
    # step above)
    entry = _rcnn_check_model(with_mask, torch.float32)
    entry.init_weights(torch.Generator().manual_seed(SEED))
    seed_rcnn_for_training(entry, torch.Generator().manual_seed(SEED + 2))
    box_inputs = {}
    for prefix, weights in (("", start), ("entry_start_", entry.state_dict())):
        for m in (gpu, cpu, referee):
            m.load_state_dict(weights)
        box_inputs[prefix] = _hold_rcnn_train_step(
            gpu, cpu, referee, batch, draws, with_mask, prefix, result, bad)
    feats = box_inputs[""]

    with torch.no_grad():
        r_cls, r_reg = heads["ref"](feats.double())
        c_cls, c_reg = heads["cpu"](feats)
        g_cls, g_reg = heads["card"](feats.to(dev))
    for name, got, host, ref in (("cls_logits", g_cls, c_cls, r_cls),
                                 ("box_deltas", g_reg, c_reg, r_reg)):
        card = float((got.double().cpu() - ref).abs().max())
        host_d = float((host.double() - ref).abs().max())
        result[f"{name}_card_vs_f64"], result[f"{name}_cpu_vs_f64"] = (
            card, host_d)
        result[f"{name}_ratio"] = card / host_d if host_d else math.inf
    result.update(box_head_f64_readings(heads["card"], feats, r_cls, r_reg))
    label = "Mask" if with_mask else "Faster"
    print(f"  f32 {label} R-CNN train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 {label} R-CNN train step, card vs CPU: "
                             f"{bad} outside {t}: {result}")
    return result


# f32 YOLO predict, card vs CPU vs an f64 CPU referee (phases 4g, 4h, 4i:
# YOLOv8-s, YOLOX-s, YOLOv5-s), at full width, batch YOLO_CHECK_BATCH at a
# cut side (``check_res``: 448 x 448 of YOLOv5-s's and YOLOv7's 640,
# YOLOv3's 288 of 416, YOLOv4's 352 of 512; YOLOv8-s and YOLOX-s at their
# 640, for which they build their anchor points, SSD at its 300), BN
# randomized (YOLOX's score
# biases calibrated, as its entry serves it). Every score of the seeded YOLOv8
# sits near sigmoid(-4.59) = 0.0101, just above the 0.01 threshold, and the
# seeded YOLOv5's and calibrated YOLOX's near 0.25, so the top-1000 cut and the
# NMS's order fall between scores ~1e-5 apart: f32 rounding of the card's own
# logits may move a box across either. So each discrete stage (the top-k, the
# threshold, the NMS keep, the padding) is held on the CPU's inputs, and the
# card's own request against the CPU's as sets, as phases
# 4e / 4f do.
YOLO_CHECK_BATCH = 2  # (the serving batches 1 and 16)
YOLO_TIE = 1e-6  # sorted candidate scores this close may trade places
YOLO_MATCHED_SHARE = 0.9  # of the CPU's detections found on the card
YOLO_MAPS = ("C3", "C4", "C5", "N3", "N4", "N5")


def yolo_models() -> dict:
    """The 2D detectors of phases 4g-4m, 5h-5n and 6o-6ab in their phases'
    order, each as a dict: its ``label``, its model class ``cls``, the
    ``build`` of its served model (device, dtype), its ``serve`` and
    ``train`` entries, the names of its head outputs (``heads``),
    predict's ``score`` threshold and ``nms`` IoU, the config's resolution
    (``res``) and the side of its phase-4 check (``check_res``), the
    feature ``maps`` held to the referee, the config's SGD
    (``momentum``, ``nesterov``, weight ``decay``) and ``train_batch``,
    the parameter groups (``parts``) and the side (``train_res``) of its
    phase-5 step, the serving model's ``width`` (None: the class's), the
    bounds of that step (``tol``), its ``phases`` (4, 5, 6 serving, 6
    train), whether phase 6 ``profile``s it whatever ``--profile`` says,
    and whether phase 5 also runs its step in f64 on the card
    (``f64_step``)."""
    from minddet_tpu_torch import entry
    from minddet_tpu_torch.models.detectors.ssd import SSD
    from minddet_tpu_torch.models.detectors.yolov3 import YOLOv3
    from minddet_tpu_torch.models.detectors.yolov4 import YOLOv4
    from minddet_tpu_torch.models.detectors.yolov5 import YOLOv5
    from minddet_tpu_torch.models.detectors.yolov7 import YOLOv7
    from minddet_tpu_torch.models.detectors.yolov8 import YOLOv8
    from minddet_tpu_torch.models.detectors.yolox import YOLOX

    common = dict(res=entry.YOLO_RES, check_res=448, maps=YOLO_MAPS,
                  nesterov=True,
                  decay=entry.YOLO_WEIGHT_DECAY,
                  train_batch=entry.YOLO_TRAIN_BATCH, parts=YOLO_PARTS,
                  train_res=YOLO_TRAIN_CHECK["res"], width=None,
                  tol=YOLO_TRAIN_TOL, profile=False, f64_step=False)
    # the rest of the 2D detector zoo: always profiled, the step also in
    # f64 on the card
    zoo = dict(common, tol=ZOO_TRAIN_TOL, profile=True, f64_step=True)
    anchor_heads = ("P3_out", "P4_out", "P5_out")
    return {
        "yolov8": dict(
            common, label="YOLOv8-s", cls=YOLOv8, heads=("dfl", "cls"),
            build=entry.build_yolov8, serve=entry.yolov8_entry,
            train=entry.yolov8_train_entry, momentum=entry.YOLO_MOMENTUM,
            score=0.01, nms=0.7, check_res=entry.YOLO_RES,
            phases=("4g", "5h", "6o", "6p")),
        "yolox": dict(
            common, label="YOLOX-s", cls=YOLOX, heads=("reg", "obj", "cls"),
            build=entry.build_yolox, serve=entry.yolox_entry,
            train=entry.yolox_train_entry, momentum=entry.YOLOX_MOMENTUM,
            score=0.01, nms=0.65, check_res=entry.YOLO_RES,
            phases=("4h", "5i", "6q", "6r")),
        "yolov5": dict(
            common, label="YOLOv5-s", cls=YOLOv5, heads=anchor_heads,
            build=entry.build_yolov5, serve=entry.yolov5_entry,
            train=entry.yolov5_train_entry, momentum=entry.YOLOV5_MOMENTUM,
            score=0.05, nms=0.45, phases=("4i", "5j", "6s", "6t")),
        "yolov3": dict(
            zoo, label="YOLOv3", cls=YOLOv3,
            heads=("P5_out", "P4_out", "P3_out"), build=entry.build_yolov3,
            serve=entry.yolov3_entry, train=entry.yolov3_train_entry,
            momentum=entry.YOLOV3_MOMENTUM, score=0.05, nms=0.45,
            res=entry.YOLOV3_RES, check_res=288, maps=("C3", "C4", "C5"),
            nesterov=False,
            parts=("backbone.", "h", "route"),
            phases=("4j", "5k", "6u", "6v")),
        "yolov4": dict(
            zoo, label="YOLOv4", cls=YOLOv4, heads=anchor_heads,
            build=entry.build_yolov4, serve=entry.yolov4_entry,
            train=entry.yolov4_train_entry, momentum=entry.YOLOV4_MOMENTUM,
            score=0.05, nms=0.45, res=entry.YOLOV4_RES, check_res=352,
            nesterov=False,
            width=entry.YOLOV4_WIDTH, phases=("4k", "5l", "6w", "6x")),
        "yolov7": dict(
            zoo, label="YOLOv7", cls=YOLOv7, heads=anchor_heads,
            build=entry.build_yolov7, serve=entry.yolov7_entry,
            train=entry.yolov7_train_entry, momentum=entry.YOLOV7_MOMENTUM,
            score=0.05, nms=0.45, width=entry.YOLOV7_WIDTH,
            phases=("4l", "5m", "6y", "6z")),
        "ssd": dict(
            zoo, label="SSD-300-MobileNetV2", cls=SSD, heads=("cls", "reg"),
            build=entry.build_ssd, serve=entry.ssd_entry,
            train=entry.ssd_train_entry, momentum=entry.SSD_MOMENTUM,
            score=0.05, nms=0.45, res=entry.SSD_RES, check_res=entry.SSD_RES,
            maps=("C4", "C5", "E0", "E1", "E2", "E3"), nesterov=False,
            decay=entry.SSD_WEIGHT_DECAY, train_batch=entry.SSD_TRAIN_BATCH,
            parts=("backbone.", "extra", "multibox"),
            train_res=entry.SSD_RES, tol=SSD_TRAIN_TOL,
            phases=("4m", "5n", "6aa", "6ab")),
    }


def _yolo_spec(kind: str) -> dict:
    return yolo_models()[kind]


def build_yolo(kind: str, dev, dtype):
    """The served YOLO model of ``kind`` in ``dtype`` on ``dev``, as its
    entry builds it (YOLOX calibrated)."""
    from minddet_tpu_torch import entry

    model = _yolo_spec(kind)["build"](dev, dtype)
    return entry.calibrate_yolox(model) if kind == "yolox" else model


def _yolo_stages(model, image, maps=("C3", "C4", "C5", "N3", "N4", "N5")):
    """``predict`` stage by stage through the model's own methods: the
    feature maps under ``maps`` (C3-C5 and N3-N5 where the model has a
    neck, YOLOv3's C3-C5, SSD's six), the head's outputs (YOLOv8's DFL and
    class logits, YOLOX's offsets, objectness and class logits, each
    level's map of an anchor YOLO, SSD's class logits and deltas) under
    ``head``, the top-k candidates and the detections."""
    feats = model.features(image)
    nested = isinstance(feats[0], (tuple, list))  # (backbone, neck)
    head_in = feats[1] if nested else feats
    outs = tuple(model.heads(head_in)) if hasattr(model, "heads") \
        else model.head(head_in)  # the levels or maps, or one head's
    cand = model.candidates(*outs)
    flat = [m for part in feats for m in part] if nested else list(feats)
    return dict(zip(maps, flat), head=outs, cand=cand,
                det=model.detections(cand))


def _sample(det, i):
    """Sample ``i`` of a batch of detections, as a batch of one."""
    return {k: v[i:i + 1] for k, v in det.items() if torch.is_tensor(v)}


def check_yolo_f32(dev, gen, kind: str = "yolov8"):
    """Phases 4g-4m: f32 ``predict`` of the 2D detector of ``kind``
    (``yolo_models``: YOLOv8-s, YOLOX-s, YOLOv5-s, YOLOv3, YOLOv4, YOLOv7,
    SSD-300) at full width, batch YOLO_CHECK_BATCH at its ``check_res``
    (cut from its config's resolution but YOLOv8-s's, YOLOX-s's and
    SSD's), on the card against the same model on the CPU (TF32 off) and
    an f64 CPU referee, stage by stage; BN randomized (``randomize_bn``,
    the statistics from the request's image but for YOLOv8's) on the CPU
    (SSD's class convs then calibrated on the image, ``calibrate_ssd``),
    the card and the referee load its state.

    - the feature maps and the head's outputs held to the referee as phase 4
      holds its heads (the card at most HEAD_REFEREE_K times as far from it
      as the f32 CPU, plus HEAD_REFEREE_FLOOR of the largest value), with
      the card-vs-CPU distances beside them;
    - the decode and the top-1000 on the CPU's head outputs: scores within
      RCNN_SCORE_TOL, the same anchors unless two sorted scores lie within
      YOLO_TIE, then boxes within RCNN_BOX_TOL and the same labels; the
      NMS and the padding on the CPU's candidates slot by slot unless a
      candidate pair's IoU lies within PP_NEAR of the NMS threshold or a
      score within YOLO_TIE of the score threshold, as sets otherwise (at
      least YOLO_MATCHED_SHARE of each image's CPU detections found on the
      card);
    - the card's own detections against the CPU's as sets (same label, IoU
      RCNN_E2E_IOU, score within RCNN_E2E_SCORE_TOL; YOLO_MATCHED_SHARE),
      the referee's read beside them, ungated; ``predict`` against its own
      stages.

    No hand-written kernel launches."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_yolo_f32(dev, gen, kind)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _check_yolo_f32(dev, gen, kind):
    from minddet_tpu_torch import entry, kernels

    spec = _yolo_spec(kind)
    score_threshold, nms_iou = spec["score"], spec["nms"]
    shape = (YOLO_CHECK_BATCH, spec["check_res"], spec["check_res"], 3)
    image = torch.rand(*shape, generator=gen)
    cpu = build_yolo(kind, "cpu", torch.float32)
    # the BN statistics come from the request's own image (but YOLOv8's):
    # from another uniform image the deep maps' tiny spread leaves their
    # logits at tens, the scores at 1 and the anchor boxes degenerate
    randomize_bn(cpu, image if kind != "yolov8"
                 else torch.rand(*shape, generator=gen), gen)
    if kind == "ssd":
        entry.calibrate_ssd(cpu, image)
    gpu = build_yolo(kind, dev, torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    referee = build_yolo(kind, "cpu", torch.float64)
    referee.load_state_dict(cpu.state_dict())

    kernels.reset_launches()
    with torch.inference_mode():
        g = _yolo_stages(gpu, image.to(dev), spec["maps"])
        served = gpu.predict(image.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if any(launches.values()):
        raise AssertionError(f"f32 {spec['label']} predict launched "
                             f"{launches}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        c = _yolo_stages(cpu, image, spec["maps"])
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        r = _yolo_stages(referee, image, spec["maps"])
    result, bad = dict(cpu_predict_s=cpu_s,
                       referee_s=time.perf_counter() - t0), []
    if not _same_detections(served, g["det"]):
        bad.append("predict against its own stages on the card")

    for d in (g, c, r):
        d.update(zip(spec["heads"], d["head"]))
    for name in spec["maps"] + spec["heads"]:
        got, host, ref = (_nhwc_cpu(g[name]), _nhwc_cpu(c[name]),
                          _nhwc_cpu(r[name]))
        card = result[f"{name}_card_vs_f64"] = float((got - ref).abs().max())
        cpu_d = result[f"{name}_cpu_vs_f64"] = float((host - ref).abs().max())
        result[f"{name}_max_abs_err"] = float((got - host).abs().max())
        result[f"{name}_ratio"] = card / cpu_d if cpu_d else math.inf
        limit = (HEAD_REFEREE_K * cpu_d
                 + HEAD_REFEREE_FLOOR * float(ref.abs().max()))
        if card > limit:
            bad.append(f"{name}: the card lies {card} from the f64 referee, "
                       f"over {HEAD_REFEREE_K} x the f32 CPU's {cpu_d}")

    # the decode and the top-k on the CPU's head outputs
    cc = c["cand"]
    with torch.inference_mode():
        ck = {k: v.cpu() for k, v in gpu.candidates(
            *(o.to(dev) for o in c["head"])).items()}
    gaps = cc["scores"][:, :-1] - cc["scores"][:, 1:]
    ties = result["topk_score_ties"] = int(((gaps > 0)
                                            & (gaps < YOLO_TIE)).sum())
    same_idx = result["topk_same_anchors"] = torch.equal(ck["index"],
                                                         cc["index"])
    result["topk_score_max_abs_err"] = float(
        (ck["scores"] - cc["scores"]).abs().max())
    if result["topk_score_max_abs_err"] > RCNN_SCORE_TOL:
        bad.append("top-k scores on the CPU's logits")
    if same_idx:
        atol, rtol = RCNN_BOX_TOL
        err = (ck["boxes"] - cc["boxes"]).abs()
        result["topk_box_max_abs_err"] = float(err.max())
        if not bool((err <= atol + rtol * cc["boxes"].abs()).all()):
            bad.append("decoded boxes on the CPU's logits")
        if not torch.equal(ck["labels"], cc["labels"]):
            bad.append("top-k labels on the CPU's logits")
    elif ties == 0:
        bad.append("top-k anchors on the CPU's logits (no score ties)")

    # the NMS and the padding on the CPU's candidates
    near = result["nms_near_threshold_pairs"] = sum(
        _near_iou_pairs(cc["boxes"][i:i + 1], cc["scores"][i:i + 1],
                        nms_iou, cc["labels"][i:i + 1], score_threshold)
        for i in range(YOLO_CHECK_BATCH))
    cut = result["score_threshold_ties"] = int(
        ((cc["scores"] - score_threshold).abs() < YOLO_TIE).sum())
    with torch.inference_mode():
        det_k = gpu.detections({k: v.to(dev) for k, v in cc.items()},
                               score_threshold, nms_iou)
    same = _same_detections(det_k, c["det"])
    result["detections_same_inputs_slot_by_slot"] = same
    result["detections_same_inputs_matched_share"] = min(
        _rcnn_matched_share(_sample(det_k, i), _sample(c["det"], i))
        for i in range(YOLO_CHECK_BATCH))
    if not same and (near == 0 and cut == 0
                     or result["detections_same_inputs_matched_share"]
                     < YOLO_MATCHED_SHARE):
        bad.append("detections of the card on the CPU's candidates")
    kept = c["det"]["labels"] >= 0
    result["kept_cpu"] = kept.sum(1).tolist()
    result["nms_passes_cpu"] = c["det"]["nms_passes"]
    result["nms_passes_card"] = g["det"]["nms_passes"]
    if not bool(kept.any(1).all()):
        bad.append("an image of the CPU's request kept no detection")

    # the card's own request, and the referee's, against the CPU's as sets
    for who, det in (("card", g["det"]), ("referee", r["det"])):
        result[f"{who}_detections_matched_share"] = min(
            _rcnn_matched_share(_sample(det, i), _sample(c["det"], i), True)
            for i in range(YOLO_CHECK_BATCH))
    result["kept_card"] = (g["det"]["labels"] >= 0).sum(1).tolist()
    if result["card_detections_matched_share"] < YOLO_MATCHED_SHARE:
        bad.append("the card's own detections against the CPU's, as sets")
    result["launches"] = launches
    print(f"  f32 {spec['label']} card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 {spec['label']} predict, card vs CPU: "
                             f"{bad}: {result}")
    return result


# f32 YOLO train steps, card vs CPU vs an f64 CPU referee (phases 5h, 5i,
# 5j: YOLOv8-s, YOLOX-s, YOLOv5-s): the full-width model at 224 x 224,
# batch 2 (the CPU's f32 step takes seconds), the reference's initialisers
# with BN randomized, on ``synthetic_detection_batch`` (seed 5); SGD as the
# config's (Nesterov, decay 5e-4, the NaN guard; momentum 0.937, YOLOX's
# 0.9) at a constant lr 0.01, since the warm-up's first step has lr 0. The
# network is smooth (SiLU) but for the SPPF's max pools; the assignment's
# discrete choices are held on the CPU's inputs, on a batch of their own
# (YOLO_ASSIGN_CHECK: more images and GTs, so more foreground): TAL's (a
# GT's top 10 anchors, each anchor's GT), where only an anchor with a
# metric within YOLO_TAL_NEAR (relative) of its GT's 10th, or of another
# GT's metric at the anchor, may be assigned otherwise; SimOTA's, where
# only an anchor whose cost lies within SIMOTA_NEAR of a GT's cut where
# the cut's two sides lie that close, or of another GT's cost at the
# anchor, or a candidate of a GT whose top-10 IoU sum lies within
# YOLO_TAL_NEAR of an integer that moves its k, may (``_simota_near``);
# and for both at most YOLO_MAX_DIFFER of the foreground (at least one
# anchor) may differ at all; YOLOv5's target maps exactly, also on the
# batch with GT 0 copied into a padded slot (a later writer on every slot
# GT 0 claims). The losses, gradients
# and BN statistics take PP_TRAIN_TOL's bounds (the gradients at most
# referee_k times as far from the referee as the f32 CPU's, plus a floor).
YOLO_TRAIN_CHECK = dict(res=224, batch=2)  # (cut from the configs)
YOLO_ASSIGN_CHECK = dict(batch=8, max_objs=48)
YOLO_MAX_DIFFER = 0.05
YOLO_TRAIN_TOL = dict(PP_TRAIN_TOL, soft_target_atol=1e-5)
YOLO_TAL_NEAR = 1e-5
# two SimOTA costs within SIMOTA_NEAR of the larger's size, plus
# SIMOTA_NEAR_ABS, may trade places: 4 f32 spacings at the cost's size (a
# non-strong candidate's 1e4 offset rounds to ~1e-3), plus ~20 at a strong
# candidate's cost of ~10 for the terms' own rounding
SIMOTA_NEAR = 2.0 ** -21
SIMOTA_NEAR_ABS = 2e-5
YOLO_PARTS = ("backbone.", "neck.", "head")
YOLO_CHECK_LR = 0.01
# 5k-5n: grad_norm held to the referee only (as 5d): the f32 CPU's
# grad_norm can lie farther from the referee than the card's (YOLOv3: 2.7e-3
# against 1.6e-4 on an H100, PERF.md section 6); the gradients that cancel
# left out of the ratios (SSD's projection BN biases feed a 1x1 conv and a
# train-mode BN); 5n's batch has GTs on every one of SSD's maps
# (``ssd_large_gts``), so every part gets a gradient
ZOO_TRAIN_TOL = dict(YOLO_TRAIN_TOL, grad_norm_rtol=None, cancelled=1e-9)
# SSD's ReLU6 network: units near a kink take the other branch on either
# side, and either f32 step's backbone gradient lies ~1e-2 from the
# referee, which one farther flipping with the draw (card 1.1e-2 / CPU
# 3.3e-3 on 5n's first batch, 5.6e-3 / 1.1e-2 with the class convs
# calibrated, on an H100, PERF.md section 6). The extra blocks are ReLU6
# too (card 2.5e-2 / CPU 6.2e-3 once 5n's batch reaches them), and they
# carry the largest gradients, so grad_norm moves with them (card 9.2e-3 /
# CPU 2.3e-3). So the backbone's and the extras' parameters take the
# kink-sized floor phase 5 holds the ReLU CenterNet's to (REFEREE_TOL's
# 3e-2), and so does grad_norm, whose distance the whole gradient's bounds
# (|a| - |b| <= |a - b|); the multibox heads (card 1.5e-5 from the referee)
# keep YOLO_TRAIN_TOL's floor of 1e-3. The same step in f64 on the card is
# held to the referee tightly (ZOO_F64_TOL)
SSD_TRAIN_TOL = dict(ZOO_TRAIN_TOL,
                     part_floors={"backbone.": REFEREE_TOL["grad_rel_l2"],
                                  "extra": REFEREE_TOL["grad_rel_l2"]},
                     referee_grad_norm_floor=REFEREE_TOL["grad_rel_l2"])
CANCELLED_NOISE = 1e-4  # a cancelled gradient's bound, x the largest
# the step in f64 on the card against the f64 referee (5k-5n): the loss,
# its parts and grad_norm (relative), every gradient but the cancelled ones
# (relative L2), the parameters and BN statistics after the step. The
# heads' outputs are cast to f32 on both sides, as the reference casts
# them, so the decode and the loss run in f32 and the step agrees to f32
# rounding from there on (1.2e-7 in the loss, 8.5e-8 in a gradient on an
# H100, PERF.md section 6), the BN statistics (before the heads) to f64's
ZOO_F64_TOL = dict(loss_rtol=1e-6, grad_rel_l2=1e-5, param_atol=1e-5,
                   stat_atol=1e-12, stat_rtol=1e-10)
def _yolo_check_model(kind, dtype, dev=None):
    from minddet_tpu_torch import entry

    spec = _yolo_spec(kind)
    res = spec["train_res"]
    if kind == "ssd":
        model = spec["cls"](num_classes=entry.NUM_CLASSES, image_size=res,
                            dtype=dtype)
    else:
        width = {} if spec["width"] is None else dict(
            width_mult=spec["width"])
        model = spec["cls"](num_classes=entry.NUM_CLASSES,
                            image_hw=(res, res), dtype=dtype, **width)
    model.init_weights(torch.Generator().manual_seed(entry.SEED))
    return model.to(device=dev, memory_format=torch.channels_last)


def _tal_near(metric, topk: int = 10):
    """(B, A) anchors where a GT's metric (B, G, A) lies within
    YOLO_TAL_NEAR (relative) of that GT's ``topk``-th largest, or of
    another GT's metric at the same anchor: where rounding may decide the
    assignment."""
    kth = metric.topk(topk, dim=2).values[..., -1:]
    near_k = ((metric - kth).abs() <= YOLO_TAL_NEAR * kth) & (metric > 0)
    m = metric.transpose(1, 2)  # (B, A, G)
    close = ((m[..., :, None] - m[..., None, :]).abs()
             <= YOLO_TAL_NEAR * m[..., :, None]) & (m[..., :, None] > 0)
    close &= ~torch.eye(m.shape[-1], dtype=torch.bool)
    return near_k.any(1) | close.flatten(2).any(-1)


def _simota_near(args, topk: int = 10):
    """(B, A) anchors where rounding may decide SimOTA's assignment on
    ``args`` (``simota_assign``'s), its terms taken in f64, "close" meaning
    within SIMOTA_NEAR_ABS + SIMOTA_NEAR x the cost: where a GT's k-th and
    (k + 1)-th cheapest costs lie close (k the truncated sum of its top-10
    candidate IoUs, clipped into [1, 10]), its candidates close to either;
    every candidate of a GT whose sum lies within YOLO_TAL_NEAR of an
    integer from 2 to 10 (where the truncation may give another k); an
    anchor that two GTs may take at close costs."""
    from minddet_tpu_torch.models.detectors.yolox import simota_cost

    def tol(c):
        return SIMOTA_NEAR_ABS + SIMOTA_NEAR * c.abs()

    cost, cand, iou = simota_cost(*(a.double() if a.is_floating_point()
                                    else a for a in args))
    cand &= args[-1][..., None]
    k_sum = torch.where(cand, iou, torch.zeros_like(iou)).topk(
        topk, dim=2).values.sum(2)
    dyn_k = k_sum.long().clamp(1, topk)
    ranked = cost.sort(dim=2).values
    kth = ranked.gather(2, (dyn_k - 1)[..., None])
    next_ = ranked.gather(2, dyn_k[..., None])
    fragile = (next_ - kth) <= tol(next_)
    near = fragile & (((cost - kth).abs() <= tol(kth))
                      | ((cost - next_).abs() <= tol(next_)))
    n = k_sum.round()
    near |= (((k_sum - n).abs() <= YOLO_TAL_NEAR) & (n >= 2)
             & (n <= topk))[..., None]
    near &= cand
    taken = (cost <= kth + tol(kth)) & cand
    c = torch.where(taken, cost, torch.full_like(cost, math.inf))
    two = c.topk(2, dim=1, largest=False).values  # (B, 2, A)
    close = (two[:, 1] - two[:, 0]) <= tol(two[:, 0])
    return near.any(1) | close


def _hold_yolo_assignment(kind, cpu, batch, dev, result, bad):
    """The model's assignment on the CPU's inputs (an eval-mode forward
    moves no BN statistic), card vs CPU, into ``result`` / ``bad``."""
    if kind in ("yolov5", "yolov4", "yolov7"):
        return _hold_yolov5_targets(cpu, batch, dev, result, bad)
    if kind == "yolov3":
        return _hold_yolov3_targets(cpu, batch, dev, result, bad)
    if kind == "ssd":
        return _hold_ssd_targets(cpu, batch, dev, result, bad)
    from minddet_tpu_torch.models.detectors.yolov8 import (align_metric,
                                                           dfl_decode,
                                                           tal_assign)
    from minddet_tpu_torch.models.detectors.yolox import (decode_yolox,
                                                          simota_assign)

    t = YOLO_TRAIN_TOL
    gt = (batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"])
    with torch.no_grad():
        outs = cpu.eval()(batch["image"])
        points, strides = cpu.grid("cpu")
        if kind == "yolov8":
            dfl, cls = outs
            args = (dfl_decode(dfl, points[None], strides[None]), cls,
                    points) + gt
            assign, soft = tal_assign, "soft_target"
            near = _tal_near(align_metric(*(
                a.double() if a.is_floating_point() else a for a in args))[0])
        else:
            reg, obj, cls = outs
            args = (decode_yolox(reg, points[None], strides[None]), obj, cls,
                    points, strides) + gt
            assign, soft = simota_assign, "matched_iou"
            near = _simota_near(args)
        tc = assign(*args)
        tg = {k: v.cpu() for k, v in assign(*(a.to(dev) for a in args))
              .items()}
    cpu.train()
    differ = (tg["fg"] != tc["fg"]) | (tc["fg"] & (tg["matched_gt"]
                                                   != tc["matched_gt"]))
    fg = int(tc["fg"].sum())
    result.update(foreground=fg, assignment_differs=int(differ.sum()),
                  anchors_near_a_tie=int(near.sum()),
                  foreground_near_a_tie=int((near & tc["fg"]).sum()))
    if bool((differ & ~near).any()) or \
            int(differ.sum()) > max(1, int(YOLO_MAX_DIFFER * fg)):
        bad.append("the assignment on the same inputs")
    both = tc["fg"] & ~differ
    result[f"{soft}_max_abs_err"] = float(
        (tg[soft] - tc[soft])[both].abs().max())
    if result[f"{soft}_max_abs_err"] > t["soft_target_atol"]:
        bad.append(f"{soft} on the same inputs")
    if not bool(tc["fg"].any(1).all()):
        bad.append("an image without foreground")


def _gt0_copied(batch):
    """The batch with GT 0 of each image copied into its first padded slot
    under another class (every slot GT 0 claims is claimed again,
    later)."""
    dup = {k: v.clone() for k, v in batch.items()}
    for b in range(dup["gt_mask"].shape[0]):
        free = int((~dup["gt_mask"][b]).nonzero()[0, 0])
        dup["gt_boxes"][b, free] = dup["gt_boxes"][b, 0]
        dup["gt_classes"][b, free] = (dup["gt_classes"][b, 0] + 1) % 80
        dup["gt_mask"][b, free] = True
    return dup


def _hold_yolov5_targets(cpu, batch, dev, result, bad):
    """``yolov5_assign`` at each level (YOLOv5's, YOLOv4's and YOLOv7's),
    card vs CPU, exactly: on the batch and on ``_gt0_copied``'s."""
    from minddet_tpu_torch.models.detectors.yolov5 import yolov5_assign

    dup = _gt0_copied(batch)
    res = YOLO_TRAIN_CHECK["res"]
    positives, overwritten = 0, 0
    for label, data in (("batch", batch), ("duplicate_slot_batch", dup)):
        gt = (data["gt_boxes"], data["gt_classes"], data["gt_mask"])
        for li, stride in enumerate(cpu.STRIDES):
            hw = (res // stride, res // stride)
            (wh,) = cpu.anchor_wh[li]("cpu")
            want = yolov5_assign(*gt, wh, stride, hw)
            got = yolov5_assign(*(a.to(dev) for a in gt), wh.to(dev), stride,
                                hw)
            for name, g, w in zip(("pos", "tbox", "tcls"), got, want):
                if not torch.equal(g.cpu(), w):
                    bad.append(f"{label} level {li} {name} on the same "
                               f"inputs")
            if label == "batch":
                positives += int(want[0].sum())
            else:
                copy = (data["gt_classes"][:, 0] + 1) % 80
                overwritten += int(((want[2] == copy[:, None].to(torch.int32))
                                    & (want[0] > 0)).sum())
    result.update(positives=positives, slots_of_the_later_copy=overwritten)
    if positives == 0 or overwritten == 0:
        bad.append("no positives, or no slot that the copy overwrote")


def _hold_yolov3_targets(cpu, batch, dev, result, bad):
    """YOLOv3's best anchor of each GT, its target maps and its ignore
    masks at each level, card vs CPU, exactly, the masks on the CPU's
    decoded boxes (an eval-mode forward moves no BN statistic): on the
    batch and on ``_gt0_copied``'s."""
    from minddet_tpu_torch.models.detectors.yolov3 import (IGNORE_IOU,
                                                           STRIDES,
                                                           best_anchor,
                                                           ignore_mask,
                                                           yolov3_targets)

    with torch.no_grad():
        outs = cpu.eval()(batch["image"])
        boxes = [cpu.decode_level(o, li)[0] for li, o in enumerate(outs)]
    cpu.train()
    (wh,) = cpu.all_anchor_wh("cpu")
    counts = dict(positives=0, ignored=0, slots_of_the_later_copy=0)
    for label, data in (("batch", batch),
                        ("duplicate_slot_batch", _gt0_copied(batch))):
        gt = (data["gt_boxes"], data["gt_classes"], data["gt_mask"])
        gt_d = tuple(a.to(dev) for a in gt)
        best = best_anchor(gt[0], wh)
        if not torch.equal(best_anchor(gt_d[0], wh.to(dev)).cpu(), best):
            bad.append(f"{label} best anchors on the same inputs")
        for li, out in enumerate(outs):
            _, h, w, na, _ = out.shape
            want = yolov3_targets(*gt, best, li, STRIDES[li], (h, w), na)
            got = yolov3_targets(*gt_d, best.to(dev), li, STRIDES[li],
                                 (h, w), na)
            for name, g, v in zip(("pos", "tbox", "tcls"), got, want):
                if not torch.equal(g.cpu(), v):
                    bad.append(f"{label} level {li} {name} on the same "
                               f"inputs")
            ign = ignore_mask(boxes[li], gt[0], gt[2], IGNORE_IOU)
            if not torch.equal(ignore_mask(boxes[li].to(dev), gt_d[0],
                                           gt_d[2], IGNORE_IOU).cpu(),
                               ign):
                bad.append(f"{label} level {li} ignore mask on the same "
                           f"inputs")
            if label == "batch":
                counts["positives"] += int(want[0].sum())
                counts["ignored"] += int(ign.sum())
            else:
                copy = (data["gt_classes"][:, 0] + 1) % 80
                counts["slots_of_the_later_copy"] += int(
                    ((want[2] == copy[:, None].to(torch.int32))
                     & (want[0] > 0)).sum())
    result.update(counts)
    if not all(counts.values()):
        bad.append("no positives, no ignored prediction, or no slot that "
                   "the copy overwrote")


SSD_CE_TIE_GRID = 64  # 5n also mines on cross entropies rounded to 1/64
SSD_LARGE_GT_MAPS = (2, 3, 4, 5)  # 5n adds a GT on each of these maps


def ssd_large_gts(data, feature_sizes, res, seed):
    """A ``synthetic_detection_batch`` ``data`` with one GT more per image
    for each of SSD's maps in SSD_LARGE_GT_MAPS: the map's square anchor
    at its scale (``ssd.py:MIN_SCALE`` to ``MAX_SCALE``), on a cell drawn
    from ``seed``, clipped to the image, with a drawn class. The synthetic
    GTs (5-30 % of the image) match on the first two maps only, so without
    these the extra blocks and the later multibox heads get no gradient."""
    import numpy as np

    from minddet_tpu_torch.models.detectors.ssd import MAX_SCALE, MIN_SCALE

    rng = np.random.RandomState(seed)
    b, m = data["gt_boxes"].shape[0], len(SSD_LARGE_GT_MAPS)
    boxes = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        for j, k in enumerate(SSD_LARGE_GT_MAPS):
            f = feature_sizes[k]
            side = (MIN_SCALE + (MAX_SCALE - MIN_SCALE) * k
                    / (len(feature_sizes) - 1)) * res
            c = (rng.randint(0, f, 2) + 0.5) * res / f
            boxes[i, j] = np.clip(np.concatenate([c - side / 2,
                                                  c + side / 2]), 0, res)
    classes = rng.randint(0, 80, (b, m)).astype(data["gt_classes"].dtype)
    return dict(data,
                gt_boxes=np.concatenate([data["gt_boxes"], boxes], 1),
                gt_classes=np.concatenate([data["gt_classes"], classes], 1),
                gt_mask=np.concatenate([data["gt_mask"],
                                        np.ones((b, m), bool)], 1))


def _hold_ssd_targets(cpu, batch, dev, result, bad):
    """SSD's labels, matches, class targets and box targets (1e-6
    relative: a log on either side), card vs CPU, on the same inputs, and
    the mined negatives on the CPU's cross entropies exactly, also with
    those rounded down to 1 / SSD_CE_TIE_GRID (runs of ties across the cut:
    the lower anchor first on both sides)."""
    from minddet_tpu_torch.models.detectors.ssd import (MATCH_IOU,
                                                        hard_negatives,
                                                        ssd_targets)
    from minddet_tpu_torch.ops.anchors2d import match_anchors

    with torch.no_grad():
        cls, _ = cpu.eval()(batch["image"])
    cpu.train()
    (anchors,) = cpu.anchor_boxes("cpu")
    gt = (batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"])
    gt_d = tuple(a.to(dev) for a in gt)
    want = ssd_targets(anchors, *gt)
    got = [t.cpu() for t in ssd_targets(anchors.to(dev), *gt_d)]
    for name, g, w in zip(("labels", "class targets"), got, want):
        if not torch.equal(g, w):
            bad.append(f"{name} on the same inputs")
    match = match_anchors(anchors, gt[0], gt[2], MATCH_IOU, MATCH_IOU)[1]
    match_g = match_anchors(anchors.to(dev), gt_d[0], gt_d[2], MATCH_IOU,
                            MATCH_IOU)[1]
    if not torch.equal(match_g.cpu(), match):
        bad.append("matches on the same inputs")
    err = (got[2] - want[2]).abs()
    result["box_target_max_abs_err"] = float(err.max())
    if not bool((err <= 1e-6 * want[2].abs() + 1e-6).all()):
        bad.append("box targets on the same inputs")
    labels = want[0]
    edges = [0]
    for count in cpu.anchors()[1]:
        edges.append(edges[-1] + count)
    result["positives_per_map"] = [
        int((labels[:, lo:hi] == 1).sum())
        for lo, hi in zip(edges[:-1], edges[1:])]
    if not all(result["positives_per_map"]):
        bad.append("a map with no positive anchor")
    n_pos = (labels == 1).float().sum(1, keepdim=True)
    ce = -torch.log_softmax(cls, -1).gather(-1, want[1][..., None])[..., 0]
    kept = {}
    for name, c in (("", ce), ("tied_", (ce * SSD_CE_TIE_GRID).floor()
                                / SSD_CE_TIE_GRID)):
        keep = hard_negatives(c, labels, n_pos)
        keep_g = hard_negatives(c.to(dev), labels.to(dev), n_pos.to(dev))
        if not torch.equal(keep_g.cpu(), keep):
            bad.append(f"{name}mined negatives on the same inputs")
        kept[name] = int(keep.sum())
    cut = (3 * n_pos).long().clamp(min=1)[:, 0]
    tied = (ce * SSD_CE_TIE_GRID).floor() / SSD_CE_TIE_GRID
    neg = torch.where(labels == 0, tied, torch.full_like(tied, -math.inf))
    ranked = neg.sort(dim=1, descending=True).values
    at_cut = ranked.gather(1, (cut - 1)[:, None])
    ties_at_cut = int(((neg == at_cut) & (labels == 0)).sum(1).max())
    result.update(positives=int(n_pos.sum()), mined_negatives=kept[""],
                  ties_at_the_cut_rounded=ties_at_cut)
    if int(n_pos.sum()) == 0 or ties_at_cut < 2:
        bad.append("no positives, or no tie across the mining's cut")


def _hold_f64_card_step(make_model, start, batch, tx, r, t, dev, result,
                        bad):
    """The same step in f64 on the card (5k-5n, 5o-5q), ``make_model()``'s
    f64 model on the card from the same weights, against the f64 referee's
    snapshot ``r``: far from every kink and tie that f32 rounding may move,
    the card's own math (convs, BN, the loss, its targets and mining, the
    optimizer) must give the referee's numbers, to ZOO_F64_TOL; the
    cancelled gradients (``t["cancelled"]``) left out. Where ``t`` has
    ``adam_resolved`` (an Adam step, ~lr sign(g) per element) the
    parameters are compared only where the referee's gradient exceeds that
    share of its tensor's largest: elsewhere the card's gradient error may
    turn the sign. The share of elements left out, the elements that moved
    farther than ``param_atol`` anywhere and the largest gradient ratio
    among them are reported."""
    from minddet_tpu_torch import entry
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    f = ZOO_F64_TOL
    model = make_model()
    model.load_state_dict(start)
    state = TrainState.create(model, tx)
    t0 = time.perf_counter()
    state, metrics = make_train_step(entry.model_loss)(
        state, {k: v.to(dev) for k, v in batch.items()})
    g = _train_snapshot(state, metrics, torch.float64)
    result["f64_card_step_s"] = time.perf_counter() - t0
    del state, model
    worst = max(abs(g["metrics"][k] - v) / max(abs(v), 1e-300)
                for k, v in r["metrics"].items())
    result["f64_card_metrics_max_rel_err"] = worst
    if worst > f["loss_rtol"]:
        bad.append("f64 card step: loss, parts or grad_norm")
    largest = max(float(v.abs().max()) for v in r["grads"].values())
    rel = {n: _rel_l2(g["grads"][n], v) for n, v in r["grads"].items()
           if float(v.abs().max()) >= t["cancelled"] * largest}
    result["f64_card_grad_rel_l2_max"] = max(rel.values())
    far = [n for n, v in rel.items() if v > f["grad_rel_l2"]]
    if far:
        bad.append(f"f64 card step: gradients of {far[:6]}")
    resolved = t.get("adam_resolved")
    left_out, flips, flip_ratio, count = 0, 0, 0.0, 0

    def moved(n, v):
        nonlocal left_out, flips, flip_ratio, count
        d = (g["params"][n] - v).abs()
        if resolved:
            grad = r["grads"][n].abs()
            ratio = grad / grad.max()
            far = d > f["param_atol"]
            count += d.numel()
            left_out += int((ratio <= resolved).sum())
            flips += int(far.sum())
            if far.any():
                flip_ratio = max(flip_ratio, float(ratio[far].max()))
            d = d[ratio > resolved]
        return float(d.max()) if d.numel() else 0.0

    param_err = max(moved(n, v) for n, v in r["params"].items())
    result["f64_card_param_max_abs_err"] = param_err
    if resolved:
        # the elements the cut leaves out, and the largest gradient ratio
        # of an element that moved farther than param_atol (a sign flip)
        result.update(f64_card_adam_left_out=left_out / count,
                      f64_card_adam_flips=flips,
                      f64_card_adam_flip_max_ratio=flip_ratio)
    if param_err > f["param_atol"]:
        bad.append("f64 card step: parameters after the step")
    for n, v in r["stats"].items():
        if not bool(((g["stats"][n] - v).abs()
                     <= f["stat_atol"] + f["stat_rtol"] * v.abs()).all()):
            bad.append(f"f64 card step: BN statistic {n}")
            break


def _check_trio(make, dev, gen):
    """The three models of a train check: ``make(torch.float32)`` on the
    CPU with BN affines and statistics drawn from ``gen``, the card's f32
    copy ``make(torch.float32, dev)`` and the f64 referee
    ``make(torch.float64)`` loaded with its state; returns (card, CPU,
    referee, that state)."""
    cpu = make(torch.float32)
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "running_var"):
                m.weight.uniform_(0.6, 1.4, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu, referee = make(torch.float32, dev), make(torch.float64)
    for m in (gpu, referee):
        m.load_state_dict(start)
    return gpu, cpu, referee, start


def _three_steps(gpu, cpu, referee, tx, batch, result, bad):
    """One step of ``tx`` on ``batch`` (the model's ``loss``) for the card's
    model, the CPU's and the f64 referee, each from the weights it holds;
    returns their snapshots (``_train_snapshot``) by side. The seconds go
    into ``result``; a hand-written kernel launched on the card or a step
    the NaN guard held back goes into ``bad``."""
    from minddet_tpu_torch import entry, kernels
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    snaps = {}
    for name, model in (("card", gpu), ("cpu", cpu), ("referee", referee)):
        d = next(model.parameters()).device
        state = TrainState.create(model, tx)
        before = next(model.parameters()).detach().clone()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = make_train_step(entry.model_loss)(
            state, {k: v.to(d) for k, v in batch.items()})
        snaps[name] = _train_snapshot(state, metrics, next(
            model.parameters()).dtype)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        seconds = result[f"{name}_step_s"] = time.perf_counter() - t0
        print(f"  {name} step {seconds:.1f} s, loss "
              f"{snaps[name]['metrics']['loss']:.6f}", flush=True)
        if name == "card" and any(launches.values()):
            bad.append(f"the train step launched {launches}")
        if torch.equal(next(model.parameters()).detach(), before):
            bad.append(f"{name}: the NaN guard held a finite step back")
        del state
    return snaps


def check_yolo_train_f32(dev, kind: str = "yolov8"):
    """Phases 5h-5n: one f32 train step of the 2D detector of ``kind``
    (its ``loss``, the config's SGD at YOLO_CHECK_LR) at full width, at
    YOLO_TRAIN_CHECK's size (SSD at its 300), on the card against the same
    step on
    the CPU (TF32 off) and in f64 compute on the CPU (the referee), from the
    same weights and batch: the assignment on the CPU's inputs, card vs CPU
    (``_hold_yolo_assignment``); the loss, its parts and grad_norm against
    both; every parameter's gradient and each part's (backbone, neck, head)
    against the referee, at most ``referee_k`` times the f32 CPU's distance
    plus a floor; the BN statistics after the step against both. No
    hand-written kernel launches, and the NaN guard lets every step
    through."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_yolo_train_f32(dev, kind)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _check_yolo_train_f32(dev, kind):
    from minddet_tpu_torch import entry
    from minddet_tpu_torch.core.optim import sgd, skip_nonfinite_updates
    from minddet_tpu_torch.train.synthetic import synthetic_detection_batch

    spec = _yolo_spec(kind)
    t, label = spec["tol"], spec["label"]
    res, b = spec["train_res"], YOLO_TRAIN_CHECK["batch"]
    gpu, cpu, referee, start = _check_trio(
        lambda dtype, d=None: _yolo_check_model(kind, dtype, d), dev,
        _seeded(spec["phases"][1]))

    def draw(n, max_objs=16):
        data = synthetic_detection_batch(n, (res, res), entry.NUM_CLASSES,
                                         max_objs, seed=5)
        if kind == "ssd":
            data = ssd_large_gts(data, cpu.feature_sizes(), res, seed=5)
        return {k: torch.from_numpy(v) for k, v in data.items()}

    batch = draw(b)
    result, bad = {"tolerance": t}, []
    assign_batch = draw(YOLO_ASSIGN_CHECK["batch"],
                        YOLO_ASSIGN_CHECK["max_objs"])
    _hold_yolo_assignment(kind, cpu, assign_batch, dev, result, bad)

    tx = skip_nonfinite_updates(sgd(
        YOLO_CHECK_LR, momentum=spec["momentum"], nesterov=spec["nesterov"],
        weight_decay=spec["decay"]))
    snaps = _three_steps(gpu, cpu, referee, tx, batch, result, bad)
    _referee_checks(snaps["card"], snaps["cpu"], snaps["referee"], t,
                    spec["parts"], "", result, bad)
    if spec["f64_step"]:
        _hold_f64_card_step(
            lambda: _yolo_check_model(kind, torch.float64, dev), start,
            batch, tx, snaps["referee"], t, dev, result, bad)
    print(f"  f32 {label} train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 {label} train step, card vs CPU: {bad} "
                             f"outside {t}: {result}")
    return result


# The segmentors (phases 4n-4p, 5o-5q, 6ac-6ah): DeepLabV3+, DeepLabV3
# (ResNet-101 dilated to output stride 16, 21 classes, 513 x 513) and UNet
# (widths 64-1024, 2 classes, 512 x 512). Their f32 predict checks take
# batch SEG_CHECK_BATCH at a cut side (``check_res``): DeepLab at 321 x 321
# (C5 21 wide, so the ASPP's rate-18 taps still reach real pixels from the
# map's edges), UNet at 256 x 256; the train checks at a smaller one
# (``train_res``): DeepLab 257 x 257 (C5 17 wide), UNet 128 x 128, where the
# f64 CPU step takes seconds. The configs' sides are served (6ac-6ah). BN
# statistics come from the request's own image (``randomize_bn``).
SEG_CHECK_BATCH = 2
SEG_CHECK_UNET_LR = 3e-4  # the check's Adam lr (the warm-up's first is 0)
# the train checks' bounds are ZOO_TRAIN_TOL's (grad_norm to the referee
# only, the step again in f64 on the card). Adam's first step moves a
# parameter by ~lr sign(g), so an element whose referee gradient is
# smaller than the card's error of it may move the other way: UNet's f64
# card step holds the parameters where the referee's gradient is above
# 1e-6 of its tensor's largest. The card's f64 gradients lie ~6e-8 (rel.
# L2) from the referee's, so a flip needs a ratio below ~1e-7; at a cut of
# 1e-4, 0.095 % of UNet's elements were left out and none of all of them
# flipped (H100, PERF.md section 6)
SEG_ADAM_TRAIN_TOL = dict(ZOO_TRAIN_TOL, adam_resolved=1e-6)


def seg_models() -> dict:
    """The segmentors of phases 4n-4p, 5o-5q and 6ac-6ah in their phases'
    order, each a dict: ``label``, the model class ``cls`` and its
    ``kwargs`` at the config's settings, the ``serve`` and ``train``
    entries, ``classes``, the config's ``res``, ``serve_batches`` and
    ``train_batch``, the sides of the f32 predict check (``check_res``)
    and train check (``train_res``), the maps held to the referee
    (``maps``: name -> (module, index into its output or None)), the
    parameter groups (``parts``), the check's optimizer (``tx``) and
    bounds (``tol``) and the ``phases``."""
    from minddet_tpu_torch import entry
    from minddet_tpu_torch.core.optim import adam, sgd
    from minddet_tpu_torch.models.segmentors import (DeepLabV3, DeepLabV3Plus,
                                                     UNet)

    deeplab = dict(
        kwargs=dict(num_classes=entry.DEEPLAB_CLASSES,
                    depth=entry.DEEPLAB_DEPTH),
        classes=entry.DEEPLAB_CLASSES, res=entry.DEEPLAB_RES,
        serve_batches=(1, 16), train_batch=entry.DEEPLAB_TRAIN_BATCH,
        check_res=321, train_res=257,
        maps={"C2": ("backbone", 0), "C5": ("backbone", 3),
              "aspp": ("aspp", None), "out": ("out", None)},
        parts=("backbone.", "aspp.", "low_", "dec", "out."),
        tol=ZOO_TRAIN_TOL,
        tx=lambda: sgd(entry.DEEPLAB_LR, momentum=entry.DEEPLAB_MOMENTUM,
                       weight_decay=entry.DEEPLAB_WEIGHT_DECAY))
    return {
        "deeplabv3plus": dict(
            deeplab, label="DeepLabV3+", cls=DeepLabV3Plus,
            serve=entry.deeplabv3plus_entry,
            train=entry.deeplabv3plus_train_entry,
            maps=dict(deeplab["maps"], dec1=("dec1_bn", None)),
            phases=("4n", "5o", "6ac", "6ad")),
        "deeplabv3": dict(
            deeplab, label="DeepLabV3", cls=DeepLabV3,
            serve=entry.deeplabv3_entry,
            train=entry.deeplabv3_train_entry,
            phases=("4o", "5p", "6ae", "6af")),
        "unet": dict(
            label="UNet", cls=UNet,
            kwargs=dict(num_classes=entry.UNET_CLASSES),
            serve=entry.unet_entry, train=entry.unet_train_entry,
            classes=entry.UNET_CLASSES, res=entry.UNET_RES,
            serve_batches=(1, 8), train_batch=entry.UNET_TRAIN_BATCH,
            check_res=256, train_res=128,
            maps={"down0": ("down0_bn1", None),
                  "bottom": ("bottom_bn1", None),
                  "dec3": ("dec3_bn1", None), "out": ("out", None)},
            parts=("down", "bottom", "up", "dec", "out."),
            tol=SEG_ADAM_TRAIN_TOL,
            tx=lambda: adam(SEG_CHECK_UNET_LR),
            phases=("4p", "5q", "6ag", "6ah")),
    }


def _seg_model(spec, dtype, dev=None):
    """The segmentor of ``spec`` seeded as its entries seed it, f32
    parameters unless ``dtype`` is f64, compute in ``dtype``, channels_last
    on ``dev``."""
    from minddet_tpu_torch import entry

    model = spec["cls"](dtype=dtype, **spec["kwargs"])
    model.init_weights(torch.Generator().manual_seed(entry.SEED))
    if dtype == torch.float64:
        model = model.double()
    return model.to(device=dev, memory_format=torch.channels_last)


def _seg_request(gen, batch: int, res: int) -> torch.Tensor:
    """A uint8 image drawn from ``gen``, normalized as the train path
    normalizes its records: (batch, res, res, 3) f32."""
    from minddet_tpu_torch.data.seg import seg_normalize

    raw = torch.randint(0, 256, (batch, res, res, 3), generator=gen)
    return torch.from_numpy(seg_normalize(raw.numpy()))


def _seg_stages(model, image, maps):
    """The forward's maps under ``maps`` (captured by forward hooks) and
    its logits."""
    out, hooks = {}, []
    for name, (path, index) in maps.items():
        def keep(m, a, o, name=name, index=index):
            out[name] = o if index is None else o[index]
        hooks.append(model.get_submodule(path).register_forward_hook(keep))
    try:
        out["logits"] = model(image)
    finally:
        for h in hooks:
            h.remove()
    return out


def check_seg_f32(dev, gen, kind: str):
    """Phases 4n-4p: f32 ``predict`` of the segmentor of ``kind``
    (``seg_models``) at batch SEG_CHECK_BATCH and its ``check_res``, on the
    card against the same model on the CPU (TF32 off) and an f64 CPU
    referee: the maps and the logits held to the referee as phase 4 holds
    its heads (the card at most HEAD_REFEREE_K times as far from it as the
    f32 CPU, plus HEAD_REFEREE_FLOOR of the largest value); of the pixels
    whose referee top-two margin exceeds twice the card's largest logit
    error, the share whose argmax (and whose ``predict``) on the card is
    the referee's must be 1; the share of all pixels where card and CPU
    agree is reported. BN randomized with statistics from the request's
    image. No hand-written kernel launches."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_seg_f32(dev, gen, kind)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _check_seg_f32(dev, gen, kind):
    from minddet_tpu_torch import kernels

    spec = seg_models()[kind]
    label = spec["label"]
    image = _seg_request(gen, SEG_CHECK_BATCH, spec["check_res"])
    cpu = randomize_bn(_seg_model(spec, torch.float32), image, gen)
    gpu = _seg_model(spec, torch.float32, dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    referee = _seg_model(spec, torch.float64).eval()
    referee.load_state_dict(cpu.state_dict())

    kernels.reset_launches()
    with torch.inference_mode():
        g = _seg_stages(gpu, image.to(dev), spec["maps"])
        served = gpu.predict(image.to(dev))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    result, bad = dict(launches=launches), []
    if any(launches.values()):
        bad.append(f"f32 {label} predict launched {launches}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        c = _seg_stages(cpu, image, spec["maps"])
    result["cpu_predict_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        r = _seg_stages(referee, image, spec["maps"])
    result["referee_s"] = time.perf_counter() - t0
    for name in list(spec["maps"]) + ["logits"]:
        got, host, ref = (_nhwc_cpu(d[name]) if name != "logits"
                          else d[name].double().cpu() for d in (g, c, r))
        card = result[f"{name}_card_vs_f64"] = float((got - ref).abs().max())
        cpu_d = result[f"{name}_cpu_vs_f64"] = float((host - ref).abs().max())
        result[f"{name}_max_abs_err"] = float((got - host).abs().max())
        result[f"{name}_ratio"] = card / cpu_d if cpu_d else math.inf
        limit = (HEAD_REFEREE_K * cpu_d
                 + HEAD_REFEREE_FLOOR * float(ref.abs().max()))
        if card > limit:
            bad.append(f"{name}: the card lies {card} from the f64 referee, "
                       f"over {HEAD_REFEREE_K} x the f32 CPU's {cpu_d}")
    logits = r["logits"].double().cpu()
    top2 = logits.topk(2, -1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * result["logits_card_vs_f64"]
    want = logits.argmax(-1)
    card_pred = g["logits"].argmax(-1).cpu()
    result["clear_pixel_share"] = float(clear.double().mean())
    result["argmax_agrees_share_clear"] = float(
        (card_pred == want)[clear].double().mean())
    result["predict_agrees_share_clear"] = float(
        (served.cpu() == want)[clear].double().mean())
    result["argmax_card_vs_cpu_share"] = float(
        (card_pred == c["logits"].argmax(-1)).double().mean())
    result["classes_predicted"] = int(want.unique().numel())
    if result["clear_pixel_share"] < 0.9:
        bad.append("fewer than 90 % of the pixels clear of a near tie")
    for key in ("argmax_agrees_share_clear", "predict_agrees_share_clear"):
        if result[key] != 1.0:
            bad.append(f"{key} {result[key]}")
    if served.shape != want.shape:
        bad.append(f"predict's shape {tuple(served.shape)}")
    print(f"  f32 {label} card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 {label} predict, card vs CPU: {bad}: "
                             f"{result}")
    return result


def check_seg_train_f32(dev, kind: str):
    """Phases 5o-5q: one f32 train step of the segmentor of ``kind``
    (``seg_models``: at full depth and width, at its ``train_res``, batch
    SEG_CHECK_BATCH; ``loss`` on the first
    ``synthetic_seg_batches`` batch; the config's optimizer inside the NaN
    guard: DeepLab's SGD at its first lr, UNet's Adam at
    SEG_CHECK_UNET_LR), BN randomized, on the card against the same step
    on the CPU (TF32 off) and in f64 compute on the CPU (the referee): the
    loss, ce and grad_norm (to the referee only), each part's gradient
    (DeepLab: backbone, ASPP, the decoder's ``low_`` and ``dec``, ``out``;
    UNet: down, bottom, up, dec, out) and every parameter's, the BN
    statistics, as ``_referee_checks`` holds them (a part whose referee
    gradient is 0 throughout fails); then the step in f64 on the card
    against the referee (``_hold_f64_card_step``). No hand-written kernel
    launches; the NaN guard lets every step through."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_seg_train_f32(dev, kind)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _check_seg_train_f32(dev, kind):
    from minddet_tpu_torch.core.optim import skip_nonfinite_updates
    from minddet_tpu_torch.train.synthetic import synthetic_seg_batches

    spec = seg_models()[kind]
    t, label, res = spec["tol"], spec["label"], spec["train_res"]
    gpu, cpu, referee, start = _check_trio(
        lambda dtype, d=None: _seg_model(spec, dtype, d), dev,
        _seeded(spec["phases"][1]))
    data = next(synthetic_seg_batches(SEG_CHECK_BATCH, (res, res),
                                      spec["classes"], seed=5))
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    tx = skip_nonfinite_updates(spec["tx"]())
    result, bad = {"tolerance": t}, []
    snaps = _three_steps(gpu, cpu, referee, tx, batch, result, bad)
    _referee_checks(snaps["card"], snaps["cpu"], snaps["referee"], t,
                    spec["parts"], "", result, bad)
    _hold_f64_card_step(
        lambda: _seg_model(spec, torch.float64, dev), start,
        batch, tx, snaps["referee"], t, dev, result, bad)
    print(f"  f32 {label} train step card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items() if k != "tolerance"), flush=True)
    if bad:
        raise AssertionError(f"f32 {label} train step, card vs CPU: {bad} "
                             f"outside {t}: {result}")
    return result


def probe_train_forward(dev):
    """``--probe``: the train-mode forward of the two-stage CenterPoint
    (reader and RPN, batch 1, seeded weights, TF32 off) layer by layer on
    the card, on the CPU in f32 with all threads and with one, each against
    the CPU in f64 compute (relative L2 of every leaf module's output, then
    of the BEV map). Shows where an f32 run leaves the f64 one."""
    from minddet_tpu_torch.entry import (build_centerpoint,
                                         synthetic_lidar_batch)
    from minddet_tpu_torch.models.detectors.centerpoint import (
        CenterPointTwoStage)

    def trace(model):
        d = next(model.parameters()).device
        outs, hooks = [], []
        for name, m in model.named_modules():
            if name.startswith(("reader", "rpn")) and not list(m.children()):
                hooks.append(m.register_forward_hook(
                    lambda mod, args, out, name=name: outs.append(
                        (name, out.detach().double().cpu()))))
        with torch.no_grad():
            bev = model.bev_from_points_stream(batch["points"].to(d),
                                               batch["points_mask"].to(d))
        for h in hooks:
            h.remove()
        return outs + [("bev", bev.double().cpu())]

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = build_centerpoint(dev).train()
    batch = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        CP_CHECK_BATCH, gpu.pc_range, seed=4).items()}
    cpu = build_centerpoint("cpu").train()
    cpu.load_state_dict(gpu.state_dict())
    referee = CenterPointTwoStage(dtype=torch.float64).to(
        memory_format=torch.channels_last).train()
    referee.load_state_dict(gpu.state_dict())
    ref, card, host = trace(referee), trace(gpu), trace(cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    host1 = trace(cpu)
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    rows = []
    for (name, r), (_, g), (_, c), (_, c1) in zip(ref, card, host, host1):
        rows.append(dict(layer=name, shape=list(r.shape),
                         card=_rel_l2(g, r), cpu=_rel_l2(c, r),
                         cpu_one_thread=_rel_l2(c1, r)))
        print(f"  {name:24s} card {rows[-1]['card']:.2e}  CPU ({threads} "
              f"threads) {rows[-1]['cpu']:.2e}  CPU (1 thread) "
              f"{rows[-1]['cpu_one_thread']:.2e}", flush=True)
    return dict(threads=threads, layers=rows)


def train_main_path(dev, dcn4: bool = False):
    """Phase 6b (6g with ``dcn4``), a CenterNet training main path:
    ``train_entry`` (``centernet_dcn4_train_entry``) at TRAIN_BATCH,
    TRAIN_WARMUP + TRAIN_STEPS steps on one batch, launch counts from 0."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import centernet_dcn4_train_entry, train_entry

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    make = centernet_dcn4_train_entry if dcn4 else train_entry
    step_fn, (state, batch) = make(device=dev, batch=TRAIN_BATCH)
    kernels.reset_launches()
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    mean_s = statistics.mean(times)
    out = dict(batch=TRAIN_BATCH, steps=steps, timed_steps=len(times),
               ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               img_per_s=TRAIN_BATCH / mean_s, max_memory_allocated=peak,
               losses=losses, grad_norm_last=float(metrics["grad_norm"]),
               launches=launches)
    print(f"  train bf16 batch {TRAIN_BATCH}: {mean_s * 1e3:.3f} ms/step "
          f"(p50 {out['ms_p50']:.3f}), {out['img_per_s']:.1f} img/s, peak "
          f"{peak / 2 ** 30:.2f} GiB allocated", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train loss not finite and falling: {losses}")
    want = _sampler_launches(steps, dcn4)
    if launches != want:
        raise AssertionError(f"{launches} in {steps} train steps (want "
                             f"{want})")
    print(f"  kernels: {launches} for {steps} steps == "
          f"{_sampler_launches(1, dcn4)} x steps: True", flush=True)
    return out, (step_fn, state, batch)


def k5b_gradient_copies(step) -> dict:
    """One train step (``step()``) under ``torch.profiler`` with shapes:
    the copies (``aten::copy_``) of a tensor of the size of the gradient
    that reaches the segment max's backward, made in that backward or the
    cat's, where a route that made the cat's gradient slice contiguous
    before K5b would make one; and K5b's kernel launches the trace shows.
    Raises if the trace holds no segment max backward, a copy or no K5b."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function:")
             and ("SegFullMax" in e.name or "CatBackward" in e.name)]
    g_shapes = [c.input_shapes[0] for e in nodes if "SegFullMax" in e.name
                for c in e.cpu_children if c.name == "_SegFullMaxBackward"
                and c.input_shapes]
    if not g_shapes:
        raise AssertionError("the profiled step ran no segment max backward")
    sizes = {math.prod(shape) for shape in g_shapes}

    def copies(e):
        return sum((c.name == "aten::copy_" and bool(c.input_shapes)
                    and math.prod(c.input_shapes[0]) in sizes) + copies(c)
                   for c in e.cpu_children)

    out = dict(g_shapes=[list(shape) for shape in g_shapes],
               g_copies=sum(copies(e) for e in nodes),
               k5b_kernels=sum(e.device_type == DeviceType.CUDA
                               and "seg_full_max_bwd" in e.name
                               for e in events))
    print(f"  profiled step: segment max backward of g {out['g_shapes']}, "
          f"{out['k5b_kernels']} K5b kernel(s), {out['g_copies']} copies of "
          f"g's size in the segment max's and the cat's backward", flush=True)
    if out["g_copies"] or out["k5b_kernels"] != len(g_shapes):
        raise AssertionError(f"K5b's route copies the cat's gradient or does "
                             f"not run K5b once a backward: {out}")
    return out


def lidar_train_main_path(dev, label, entry_fn, batch, launched):
    """A lidar model's training main path (6e, 6l, 6m): ``entry_fn`` at
    ``batch``, TRAIN_WARMUP + TRAIN_STEPS steps on one batch, launch counts
    from 0: each kernel named in ``launched`` once per step, no other. The
    loss must stay finite and fall. Reports ms per step (host clock around
    a synced step), clouds/s and the peak memory."""
    from minddet_tpu_torch import kernels

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, data) = entry_fn(device=dev, batch=batch)
    kernels.reset_launches()
    history, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    mean_s = statistics.mean(times)
    losses = [m["loss"] for m in history]
    out = dict(batch=batch, steps=steps, timed_steps=len(times),
               ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               clouds_per_s=batch / mean_s, max_memory_allocated=peak,
               losses=losses, first_step=history[0], last_step=history[-1],
               launches=launches)
    print(f"  {label} train bf16 batch {batch}: {mean_s * 1e3:.3f} ms/step "
          f"(p50 {out['ms_p50']:.3f}), {out['clouds_per_s']:.1f} clouds/s, "
          f"peak {peak / 2 ** 30:.2f} GiB allocated", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    print("  last step: " + " ".join(f"{k}={v:.4f}"
                                     for k, v in history[-1].items()),
          flush=True)
    finite = all(math.isfinite(v) for m in history for v in m.values())
    if not finite or not losses[-1] < losses[0]:
        raise AssertionError(f"{label} train loss not finite and falling: "
                             f"{history}")
    if launches != _centerpoint_launches(steps, launched):
        raise AssertionError(
            f"{launches} in {steps} {label} train steps (want one each of "
            f"{launched} per step and nothing else)")
    print(f"  kernels: {launches} for {steps} steps: one each of "
          f"{len(launched)} kernels per step: True", flush=True)
    return out, (step_fn, state, data)


def centerpoint_train_main_path(dev):
    """Phase 6e, the two-stage CenterPoint training main path:
    ``centerpoint_train_entry`` at TRAIN_CP_BATCH: K5f, K5b, K3f, K3dx and
    K4 once per step."""
    from minddet_tpu_torch.entry import centerpoint_train_entry

    return lidar_train_main_path(dev, "CenterPoint", centerpoint_train_entry,
                                 TRAIN_CP_BATCH, CP_TRAIN_KERNELS)


TRAIN_PP_BATCH = 32  # bench.py:bench_pointpillars_train: PP_BS default


def pointpillars_train_main_path(dev):
    """Phase 6l, the PointPillars training main path:
    ``pointpillars_train_entry`` at TRAIN_PP_BATCH; no hand-written kernel
    launches (a one-layer PFN, axis-aligned IoUs in the assignment)."""
    from minddet_tpu_torch.entry import pointpillars_train_entry

    return lidar_train_main_path(dev, "PointPillars",
                                 pointpillars_train_entry, TRAIN_PP_BATCH, ())


def centerpoint_single_train_main_path(dev):
    """Phase 6m, the single-stage CenterPoint training main path:
    ``centerpoint_single_train_entry`` at TRAIN_CP_BATCH: K5f and K5b once
    per step, nothing else."""
    from minddet_tpu_torch.entry import centerpoint_single_train_entry

    return lidar_train_main_path(dev, "single-stage CenterPoint",
                                 centerpoint_single_train_entry,
                                 TRAIN_CP_BATCH,
                                 ("seg_full_max", "seg_full_max_bwd"))


DECODE_CALLS = 3  # timed calls of the 20-iteration decode program


def decode_main_path(dev):
    """Phase 6n, the decode + rotated-NMS program (``decode_nms_entry``:
    ``bench.py:bench_decode_nms_p50``'s 128 x 128 maps, top 1000, 83 kept,
    20 chained iterations): one warm-up and DECODE_CALLS timed calls with
    launch counts from 0 (K4 once per iteration, nothing else), the host
    clock per iteration and the NMS's passes of every iteration; then one
    call under ``torch.profiler`` for the device's busy time per iteration.
    The NMS syncs the host once per pass, so the host clock is the
    program's latency and the busy time what the card spends."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import DECODE_ITERATIONS, decode_nms_entry

    program, maps = decode_nms_entry(device=dev)
    kernels.reset_launches()
    times, passes, sums = [], [], []
    for i in range(1 + DECODE_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, p = program(*maps)
        sums.append(float(acc))
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        passes.append(p)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    calls = 1 + DECODE_CALLS
    want = {k.name: calls * DECODE_ITERATIONS * int(k is kernels.ROTATED_IOU)
            for k in kernels.KERNELS}
    if launches != want:
        raise AssertionError(f"the decode program launched {launches} in "
                             f"{calls} calls of {DECODE_ITERATIONS} "
                             f"iterations (want one rotated_iou_intersect "
                             f"per iteration, nothing else)")
    if not (all(math.isfinite(v) for v in sums) and len(set(sums)) == 1
            and sums[0] > 0):
        raise AssertionError(f"the decode program's summed scores: {sums}")
    profiled = _profile(lambda: program(*maps), 1)
    per_iter = statistics.mean(times) * 1e3 / DECODE_ITERATIONS
    out = dict(iterations=DECODE_ITERATIONS, calls=calls,
               host_ms_per_iteration=per_iter,
               host_ms_per_iteration_calls=[
                   x * 1e3 / DECODE_ITERATIONS for x in times],
               device_busy_ms_per_iteration=profiled[
                   "device_busy_ms_per_call"] / DECODE_ITERATIONS,
               idle_share=profiled["idle_share"],
               kernel_launches_per_iteration=profiled[
                   "kernel_launches_per_call"] / DECODE_ITERATIONS,
               nms_passes=passes[-1], summed_score=sums[0],
               launches=launches, profile=profiled)
    print(f"  decode + rotated NMS: {per_iter:.3f} ms per iteration on the "
          f"host clock, device busy {out['device_busy_ms_per_iteration']:.3f}"
          f" ms per iteration (idle {out['idle_share']:.3f}, "
          f"{out['kernel_launches_per_iteration']:.0f} kernels), NMS passes "
          f"{passes[-1]}, summed score {sums[0]:.4f}", flush=True)
    print(f"  kernels: rotated_iou_intersect launches="
          f"{launches['rotated_iou_intersect']} iterations="
          f"{calls * DECODE_ITERATIONS}: True", flush=True)
    return out


def serve(programs):
    """Phases 6a and 6f, a CenterNet serving main path: bf16 predict
    requests at batch 1 and 16."""
    out = {}
    forwards = 0
    for b, (predict, (image,)) in programs.items():
        times = []
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = predict(image)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
            forwards += 1
        if det.shape != (b, 100, 6) or not bool(torch.isfinite(det).all()):
            raise AssertionError(f"predict at batch {b}: shape "
                                 f"{tuple(det.shape)}, finite "
                                 f"{bool(torch.isfinite(det).all())}")
        mean_s = statistics.mean(times)
        out[f"b{b}"] = dict(batch=b, requests=len(times),
                            ms_mean=mean_s * 1e3,
                            ms_p50=statistics.median(times) * 1e3,
                            img_per_s=b / mean_s, out_shape=list(det.shape))
        print(f"  predict bf16 batch {b:2d}: {mean_s * 1e3:8.3f} ms/request "
              f"(p50 {out[f'b{b}']['ms_p50']:.3f}), "
              f"{b / mean_s:8.1f} img/s, out {tuple(det.shape)} finite",
              flush=True)
    return out, forwards


def _check_pointpillars_detections(det, b):
    boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
    kept = (labels >= 0).sum(1)
    ok = (boxes.shape == (b, 300, 7) and bool(torch.isfinite(boxes).all())
          and bool((kept > 0).all())
          and bool(((scores > 0.09) == (labels >= 0)).all())
          and bool((boxes[..., 3:6] >= 0).all()))
    if not ok:
        raise AssertionError(f"PointPillars predict at batch {b}: boxes "
                             f"{tuple(boxes.shape)}, kept {kept.tolist()}"
                             f", finite {bool(torch.isfinite(boxes).all())}")


def _check_centerpoint_detections(det, b):
    """Detections of the calibrated nuScenes model (refined, or the first
    stage's): (b, 6 * 83) slots, every task's 83 filled (1000 valid
    candidates each), labels of the ten classes, scores in (0, 1] (refined:
    sqrt(stage 1 x quality)), positive sizes; dropped slots would be label
    -1 with zero score and box."""
    boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
    slots = CP_TASKS * CP_NMS_POST
    kept = labels >= 0
    ok = (boxes.shape == (b, slots, 9) and scores.shape == (b, slots)
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(scores).all())
          and bool((kept.sum(1) > CP_NMS_POST).all())
          and bool((labels <= 9).all())
          and bool(((scores > 0) == kept).all()) and bool((scores <= 1).all())
          and bool((boxes[..., 3:6][kept] > 0).all())
          and bool((boxes[~kept] == 0).all()))
    if not ok:
        raise AssertionError(f"CenterPoint predict_refined at batch {b}: "
                             f"boxes {tuple(boxes.shape)}, kept "
                             f"{kept.sum(1).tolist()}, finite "
                             f"{bool(torch.isfinite(boxes).all())}")


def serve_clouds(label, programs, dev, check):
    """Phases 6c and 6d, a lidar model's serving main path: f32 requests
    from raw points at each batch size, with the peak memory, the NMS's
    passes per request and the detections kept per cloud; ``check(det,
    batch)`` raises on a malformed answer."""
    out = {}
    predicts = 0
    for b, (predict, (points, mask)) in programs.items():
        times, passes = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = predict(points, mask)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
                passes.append(det["nms_passes"])
            predicts += 1
        check(det, b)
        mean_s = statistics.mean(times)
        out[f"b{b}"] = r = dict(
            batch=b, requests=len(times), ms_mean=mean_s * 1e3,
            ms_p50=statistics.median(times) * 1e3, clouds_per_s=b / mean_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            nms_passes=passes, kept=(det["labels"] >= 0).sum(1).tolist())
        print(f"  {label} f32 batch {b}: {mean_s * 1e3:8.3f} ms/request"
              f" (p50 {r['ms_p50']:.3f}), {r['clouds_per_s']:7.1f} clouds/s,"
              f" peak {r['max_memory_allocated'] / 2 ** 30:.2f} GiB, NMS "
              f"passes {passes}, kept {r['kept']}", flush=True)
    return out, predicts


def _check_rcnn_detections(det, b, with_mask):
    """An R-CNN request's answer: (b, 100) slots, every image keeps at
    least one detection, labels of the 80 classes where kept and -1 with a
    zero box and score elsewhere, scores above the 0.05 threshold, boxes
    finite inside the 512 x 512 image, masks (b, 100, 28, 28) in [0, 1]."""
    boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
    kept = labels >= 0
    ok = (boxes.shape == (b, 100, 4) and scores.shape == (b, 100)
          and bool(torch.isfinite(boxes).all())
          and bool((kept.sum(1) > 0).all()) and bool((labels < 80).all())
          and bool(((scores > RCNN_SCORE_THRESHOLD) == kept).all())
          and bool((boxes >= 0).all()) and bool((boxes <= 512).all())
          and bool((boxes[~kept] == 0).all()))
    if with_mask:
        m = det["masks"]
        ok = ok and (m.shape == (b, 100, 28, 28)
                     and bool(((m >= 0) & (m <= 1)).all()))
    if not ok:
        raise AssertionError(f"R-CNN predict at batch {b}: boxes "
                             f"{tuple(boxes.shape)}, kept "
                             f"{kept.sum(1).tolist()}, finite "
                             f"{bool(torch.isfinite(boxes).all())}")


def serve_rcnn(label, programs, dev, with_mask):
    """Phases 6h and 6i, an R-CNN serving main path: bf16 requests at each
    batch size, with the peak memory, the NMS's passes per request (the
    RPN's, the box head's) and the detections kept per image."""
    out = {}
    predicts = 0
    for b, (predict, (image,)) in programs.items():
        times, passes = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = predict(image)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
                passes.append(list(det["nms_passes"]))
            predicts += 1
        _check_rcnn_detections(det, b, with_mask)
        mean_s = statistics.mean(times)
        out[f"b{b}"] = r = dict(
            batch=b, requests=len(times), ms_mean=mean_s * 1e3,
            ms_p50=statistics.median(times) * 1e3, img_per_s=b / mean_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            nms_passes=passes, kept=(det["labels"] >= 0).sum(1).tolist())
        print(f"  {label} bf16 batch {b}: {mean_s * 1e3:8.3f} ms/request"
              f" (p50 {r['ms_p50']:.3f}), {r['img_per_s']:7.1f} img/s, peak"
              f" {r['max_memory_allocated'] / 2 ** 30:.2f} GiB, NMS passes"
              f" (RPN, box) {passes[-1]}, kept {r['kept']}", flush=True)
    return out, predicts


def rcnn_main_path(label, entry_fn, dev, with_mask, profile):
    """Phase 6h (Faster R-CNN) or 6i (Mask R-CNN): serving at batch 1 and
    8 with every kernel's count set to 0 just before: K3f launches exactly
    4 times per request (8 with the masks), no other kernel launches."""
    from minddet_tpu_torch import kernels

    programs = {b: entry_fn(device=dev, batch=b) for b in RCNN_BATCHES}
    kernels.reset_launches()
    serving, predicts = serve_rcnn(label, programs, dev, with_mask)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    per_request = 8 if with_mask else 4
    want = {k.name: per_request * predicts * int(
        k is kernels.BILINEAR_GATHER_FWD) for k in kernels.KERNELS}
    if launches != want:
        raise AssertionError(f"{label} serving launched {launches} for "
                             f"{predicts} requests (want {per_request} "
                             f"bilinear_gather_fwd each, nothing else)")
    print(f"  kernels: bilinear_gather_fwd launches="
          f"{launches['bilinear_gather_fwd']} requests={predicts} launches "
          f"== {per_request} x requests: True", flush=True)
    profiled = None
    if profile:
        print(f"profile: {label} serving", flush=True)
        profiled = profile_clouds(label, programs)
    return dict(serving=serving, launches=launches, requests=predicts,
                profile=profiled)


def main_path_k3dx(step_fn, state, batch):
    """K3dx on the main path's own inputs: one more train step with
    ``bilinear_gather_bwd_dx`` wrapped to keep each call's (g, x, ci, cw),
    that is the ROI sampler's rois on each FPN level and the real per-level
    g, then each call held against its plain version and timed beside
    ``index_add_`` (``_k3dx_case``). Returns the cases in call order, each
    with its roi set (box or mask), stride and the rois whose g is not
    0 on that level."""
    from minddet_tpu_torch.ops import bilinear as bl

    calls, launch = [], bl.bilinear_gather_bwd_dx

    def keep(g, x, ci, cw):
        calls.append((g, x, ci, cw))
        return launch(g, x, ci, cw)

    bl.bilinear_gather_bwd_dx = keep
    try:
        step_fn(state, batch)
    finally:
        bl.bilinear_gather_bwd_dx = launch
    cases = []
    for g, x, ci, cw in calls:
        b, hw, c = x.shape
        p = ci.shape[1]
        per_roi = p // RCNN_TRAIN_ROIS
        kind = {size[0] * size[1] * 4: k
                for k, size in RCNN_TRAIN_ROI_SETS}[per_roi]
        stride = 512 // math.isqrt(hw)
        common = dict(shape=[b, hw, c], points=p,
                      stream=f"rcnn_train_{kind}_main_path", stride=stride,
                      rois_on_level=int((g.view(b, RCNN_TRAIN_ROIS, per_roi,
                                                c) != 0).flatten(2).any(-1)
                                        .sum()),
                      off_map_corner_share=float((ci < 0).float().mean()))
        case, ok = _k3dx_case(g, x, ci, cw, common)
        cases.append(case)
        print(f"  main path K3dx {kind} P{int(math.log2(stride))} "
              f"x{case['shape']} rois here {case['rois_on_level']}: "
              f"max_abs={case['max_abs_err']:.3e} repeat={case['repeat']} "
              f"bucket<={case['largest_bucket']} kernel="
              f"{case['ms'] * 1e3:8.1f}us plain={case['plain_ms'] * 1e3:8.1f}"
              f"us index_add_={case['library_ms'] * 1e3:8.1f}us bound="
              f"{case['bound_ms'] * 1e3:6.1f}us", flush=True)
        if not ok:
            raise AssertionError(f"bilinear_gather_bwd_dx on the main "
                                 f"path's inputs disagrees with its plain "
                                 f"version: {case}")
    del calls
    return cases


def rcnn_train_main_path(label, entry_fn, dev, with_mask, profile):
    """Phase 6j (Faster R-CNN) or 6k (Mask R-CNN), an R-CNN training main
    path: the entry at its batch (8), TRAIN_WARMUP + TRAIN_STEPS steps on
    one batch (new sampling draws each step), launch counts from 0: K3f 4
    (9 with the masks) and K3dx 4 (8) per step, nothing else; every loss
    part finite. Reports ms per step, img/s, the peak memory and whether
    the loss fell."""
    from minddet_tpu_torch import kernels

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batch) = entry_fn(device=dev)
    b = batch["image"].shape[0]
    kernels.reset_launches()
    history, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    mean_s = statistics.mean(times)
    losses = [m["loss"] for m in history]
    out = dict(batch=b, steps=steps, timed_steps=len(times),
               ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3, img_per_s=b / mean_s,
               max_memory_allocated=peak, losses=losses,
               loss_fell=losses[-1] < losses[0], first_step=history[0],
               last_step=history[-1], launches=launches)
    print(f"  {label} train bf16 batch {b}: {mean_s * 1e3:.3f} ms/step (p50 "
          f"{out['ms_p50']:.3f}), {out['img_per_s']:.1f} img/s, peak "
          f"{peak / 2 ** 30:.2f} GiB allocated", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in losses)
          + f" (fell: {out['loss_fell']})", flush=True)
    print("  last step: " + " ".join(f"{k}={v:.4f}"
                                     for k, v in history[-1].items()),
          flush=True)
    if not all(math.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"{label} train loss not finite: {history}")
    want = rcnn_train_launches(with_mask, steps)
    if launches != want:
        raise AssertionError(f"{launches} in {steps} {label} train steps "
                             f"(want {want})")
    print(f"  kernels: {launches} for {steps} steps == "
          f"{rcnn_train_launches(with_mask)} x steps: True", flush=True)
    out["k3dx_cases"] = main_path_k3dx(step_fn, state, batch)
    if profile:
        print(f"profile: {label} bf16 train step", flush=True)
        out["profile"] = profile_train(f"{label} train batch {b}", step_fn,
                                       state, batch)
    return out


YOLO_SERVE_BATCHES = (1, 16)  # bench.py's batch 1; a throughput batch


def _check_yolo_detections(det, b, label, score_threshold):
    """A YOLO request's answer: (b, 100) slots, every image keeps at least
    one detection, labels of the 80 classes where kept and -1 with a zero
    box and score elsewhere, kept scores above ``score_threshold``, boxes
    finite."""
    boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
    kept = labels >= 0
    ok = (boxes.shape == (b, 100, 4) and scores.shape == (b, 100)
          and bool(torch.isfinite(boxes).all())
          and bool((kept.sum(1) > 0).all()) and bool((labels < 80).all())
          and bool(((scores > score_threshold) == kept).all())
          and bool((boxes[~kept] == 0).all()))
    if not ok:
        raise AssertionError(f"{label} predict at batch {b}: boxes "
                             f"{tuple(boxes.shape)}, kept "
                             f"{kept.sum(1).tolist()}, finite "
                             f"{bool(torch.isfinite(boxes).all())}")


def yolo_main_path(dev, profile, kind: str = "yolov8"):
    """Phases 6o, 6q, 6s, 6u, 6w, 6y and 6aa, 2D detector serving
    (``yolov8_entry``, ``yolox_entry``, ``yolov5_entry``, ``yolov3_entry``,
    ``yolov4_entry``, ``yolov7_entry``, ``ssd_entry``: bf16, the config's
    resolution, 80 classes) at each of YOLO_SERVE_BATCHES, SERVE_WARMUP +
    SERVE_REQUESTS requests each,
    with every kernel's count set to 0 just before: no hand-written kernel
    launches. Reports ms per request (host clock around a synced
    ``predict``), img/s, the peak memory, the NMS's passes and the
    detections kept; with ``profile`` the device's busy time, idle share
    and launches per request."""
    from minddet_tpu_torch import entry, kernels

    spec = _yolo_spec(kind)
    label = spec["label"]
    programs = {b: spec["serve"](device=dev, batch=b)
                for b in YOLO_SERVE_BATCHES}
    kernels.reset_launches()
    out, predicts = {}, 0
    for b, (predict, (image,)) in programs.items():
        times, passes = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = predict(image)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
                passes.append(det["nms_passes"])
            predicts += 1
        _check_yolo_detections(det, b, label, spec["score"])
        mean_s = statistics.mean(times)
        out[f"b{b}"] = r = dict(
            batch=b, requests=len(times), ms_mean=mean_s * 1e3,
            ms_p50=statistics.median(times) * 1e3, img_per_s=b / mean_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            nms_passes=passes, kept=(det["labels"] >= 0).sum(1).tolist())
        print(f"  {label} bf16 batch {b}: {mean_s * 1e3:8.3f} ms/request "
              f"(p50 {r['ms_p50']:.3f}), {r['img_per_s']:7.1f} img/s, peak "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB, NMS passes "
              f"{passes[-1]}, kept {r['kept'][:4]}", flush=True)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if any(launches.values()):
        raise AssertionError(f"{label} serving launched {launches} for "
                             f"{predicts} requests (want none)")
    print(f"  kernels: none launched in {predicts} requests: True",
          flush=True)
    profiled = None
    if profile:
        print(f"profile: {label} serving", flush=True)
        profiled = profile_clouds(label, programs)
    return dict(serving=out, launches=launches, requests=predicts,
                profile=profiled)


def train_main_path_of(dev, profile, spec, falling: bool = False):
    """The train main path of a model's ``spec`` (its ``label``, ``train``
    entry and ``train_batch``): phases 6p, 6r, 6t, 6v, 6x, 6z and 6ab
    (``yolo_models``: f32 params, bf16 compute, the config's batch, 16 or
    SSD's 32, and resolution, the config's SGD under its schedule and the
    NaN guard) and 6ad, 6af and 6ah (``seg_models``, with ``falling``),
    TRAIN_WARMUP + TRAIN_STEPS steps on one batch, launch counts from 0: no
    hand-written kernel launches; every loss part finite at every step and
    every step applied (the schedule's count advances by one each); with
    ``falling`` the last step's loss must lie under the first's (the YOLO
    warm-ups keep the lr small over these steps, so theirs is not expected
    to fall). Reports ms per step, img/s and the peak memory; with
    ``profile`` the device's busy time, idle share and launches per step.
    """
    from minddet_tpu_torch import kernels

    label, train_batch = spec["label"], spec["train_batch"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batch) = spec["train"](device=dev, batch=train_batch)
    kernels.reset_launches()
    history, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    mean_s = statistics.mean(times)
    group = state.optimizer.param_groups[0]
    out = dict(batch=train_batch, steps=steps, timed_steps=len(times),
               ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               img_per_s=train_batch / mean_s, max_memory_allocated=peak,
               losses=[m["loss"] for m in history], first_step=history[0],
               last_step=history[-1], schedule_count=int(group["count"]),
               lr_next=float(group["lr"]), launches=launches)
    print(f"  {label} train bf16 batch {train_batch}: "
          f"{mean_s * 1e3:.3f} ms/step (p50 {out['ms_p50']:.3f}), "
          f"{out['img_per_s']:.1f} img/s, peak {peak / 2 ** 30:.2f} GiB "
          f"allocated", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in out["losses"]),
          flush=True)
    print("  last step: " + " ".join(f"{k}={v:.4f}"
                                     for k, v in history[-1].items())
          + f", schedule count {out['schedule_count']}", flush=True)
    if not all(math.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"{label} train loss not finite: {history}")
    if out["schedule_count"] != steps:
        raise AssertionError(f"{steps} {label} steps applied "
                             f"{out['schedule_count']} updates")
    if falling and not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"{label} train loss did not fall: "
                             f"{out['losses']}")
    if any(launches.values()):
        raise AssertionError(f"{launches} in {steps} {label} train steps "
                             f"(want none)")
    print(f"  kernels: none launched in {steps} steps: True", flush=True)
    if profile:
        print(f"profile: {label} bf16 train step", flush=True)
        out["profile"] = profile_train(
            f"{label} train batch {train_batch}", step_fn, state, batch)
    return out


def seg_main_path(dev, kind: str):
    """Phases 6ac, 6ae and 6ag, segmentor serving (``deeplabv3plus_entry``,
    ``deeplabv3_entry``, ``unet_entry``: bf16, the config's resolution) at
    each of the spec's ``serve_batches``, SERVE_WARMUP + SERVE_REQUESTS
    requests each, with every kernel's count set to 0 just before: no
    hand-written kernel launches; each answer (batch, res, res) class ids
    in [0, classes). Reports ms per request (host clock around a synced
    ``predict``), img/s, the peak memory and the classes predicted, then
    the device's busy time, idle share and launches per request
    (``torch.profiler``)."""
    from minddet_tpu_torch import kernels

    spec = seg_models()[kind]
    label, res = spec["label"], spec["res"]
    programs = {b: spec["serve"](device=dev, batch=b)
                for b in spec["serve_batches"]}
    kernels.reset_launches()
    out, predicts = {}, 0
    for b, (predict, (image,)) in programs.items():
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(SERVE_WARMUP + SERVE_REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = predict(image)
            torch.cuda.synchronize()
            if i >= SERVE_WARMUP:
                times.append(time.perf_counter() - t0)
            predicts += 1
        if (pred.shape != (b, res, res) or int(pred.min()) < 0
                or int(pred.max()) >= spec["classes"]):
            raise AssertionError(f"{label} predict at batch {b}: "
                                 f"{tuple(pred.shape)}, classes "
                                 f"{pred.unique().tolist()}")
        mean_s = statistics.mean(times)
        out[f"b{b}"] = r = dict(
            batch=b, requests=len(times), ms_mean=mean_s * 1e3,
            ms_p50=statistics.median(times) * 1e3, img_per_s=b / mean_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            classes_predicted=int(pred.unique().numel()))
        print(f"  {label} bf16 batch {b}: {mean_s * 1e3:8.3f} ms/request "
              f"(p50 {r['ms_p50']:.3f}), {r['img_per_s']:7.1f} img/s, peak "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB, classes "
              f"predicted {r['classes_predicted']}", flush=True)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if any(launches.values()):
        raise AssertionError(f"{label} serving launched {launches} for "
                             f"{predicts} requests (want none)")
    print(f"  kernels: none launched in {predicts} requests: True",
          flush=True)
    print(f"profile: {label} serving", flush=True)
    return dict(serving=out, launches=launches, requests=predicts,
                profile=profile_clouds(label, programs))


# The COCO data and eval path: phase 3's warp cases, 4q, 6ai-6ak. The
# train warp maps a 640 x 640 canvas (CocoDetection's max_hw) to 512 x 512
# at batch 16; the eval warp a 1024 x 1024 canvas (centernet_evaluate's)
# to a keep-res bucket at batch 4: (512, 768) for a 480 x 640 image, and
# (768, 768) for a 640 x 640 one; the mosaic warps a 640 canvas to 640 x
# 640, four times a batch; Mask R-CNN's GT bitmaps (the canvas / 4, its
# 128 slots) go to 128 x 128 at its train batch 8
COCO_CANVAS = 640
COCO_EVAL_CANVAS = 1024
COCO_TRAIN_OUT = 512
COCO_TRAIN_BATCH = 16
COCO_EVAL_BATCH = 4
COCO_EVAL_BUCKETS = (((512, 768), (480, 640)), ((768, 768), (640, 640)))
MOSAIC_OUT = 640
BITMAP_STRIDE = 4
BITMAP_SLOTS = 128
MASK_TRAIN_BATCH = 8
# 4q: 8 in-memory images in two keep-res buckets, (512, 384) and (384,
# 512); the card's AP@[.5:.95] against the CPU's final detections as GT
COCO_CHECK_IMAGES = 8
COCO_CHECK_SIZES = ((500, 375), (375, 500))
COCO_AP_FLOOR = 0.98
COCO_SCORE_TOL = 1e-4  # raw top-100 scores, as phase 4
COCO_SOFT_NMS_TOL = 1e-5  # rescored scores: exp and products in f32
COCO_IMAGE_TOL = 1e-4  # the normalized train image: warp, colour, normalize
COCO_BOX_TOL = 1e-3  # train boxes (px)
COCO_WH_BIAS = 6.0  # 4q's wh head: boxes ~24 px, so GT boxes have an area
COCO_WH_GAIN = 0.1
COCO_TRAIN_STEPS = 12  # 6ai: TRAIN_WARMUP + TRAIN_STEPS steps of the data
MOSAIC_BATCHES = 12  # 6ak: 2 warm-up and 10 timed batches


def _warp_case(stream, x, aff, out_hw, card, note=""):
    """One phase 3 case of the warp kernel on an input warp: the canvases x
    (B, H, W, C) f32 under the affines ``aff`` (B, 2, 3) to ``out_hw``.
    Held to its plain version within ``GATHER_TOL`` (f32); its difference
    from the route it replaced (``affine_points``, ``bilinear_corners``,
    K3f) reported, expected 0. Timed with a warm L2: the launch (``ms``),
    the whole ``warp_images`` call, the plain version and
    ``F.grid_sample`` on the NCHW view (bilinear, zero padding,
    align_corners; its grid made outside the timing); and the replaced
    route's parts: ``bilinear_corners``, the zero pad of C to 4
    (``pad_channels``), the K3f launch on the padded map, the slice back
    (``unpad_channels``), and that route's whole call. The byte bound: the
    output written, the rows the corners touch read and 24 bytes of affine
    per image; the replaced route's also reads ci and cw (32 bytes a
    point)."""
    import torch.nn.functional as F

    from minddet_tpu_torch.data.transforms import warp_images
    from minddet_tpu_torch.ops import bilinear as bl

    b, h, w, c = x.shape
    flat = x.view(b, h * w, c)
    ys, xs = bl.affine_points(aff, out_hw)
    ci, cw = bl.bilinear_corners(ys, xs, h, w)
    p = ci.shape[1]
    got = bl.bilinear_warp_affine(x, aff, out_hw)
    old = bl.bilinear_gather(flat, ci, cw).view_as(got)
    torch.cuda.synchronize()
    ref = bl.bilinear_warp_affine_plain(x, aff, out_hw)
    terms = bl.bilinear_gather_plain(flat.abs(), ci, cw.abs()).view_as(ref)
    err = (got - ref).abs()
    atol, rtol = GATHER_TOL["float32"]
    ok = got.shape == ref.shape and bool((err <= atol + rtol * terms).all())
    max_abs = float(err.max())
    route_diff = float((got - old).abs().max())
    route_bits = torch.equal(got.view(torch.int32), old.view(torch.int32))
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1],
                       -1)[:, None]
    nchw = x.permute(0, 3, 1, 2)

    def library():
        return F.grid_sample(nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib_err = float((library()[:, :, 0].permute(0, 2, 1)
                     - ref.view(b, p, c)).abs().max())
    touched = sum(int(torch.unique(ci[i][ci[i] >= 0]).numel())
                  for i in range(b))
    off_map = float((ci < 0).float().mean())
    del got, old, ref, terms, err
    padded = bl.pad_channels(flat)
    out_padded = bl.bilinear_gather(padded, ci, cw)
    plan = bl.warp_affine_plan(b, h, w, c, *out_hw, x.dtype)
    case = dict(
        shape=[b, h, w, c], out_hw=list(out_hw), points=p, dtype="float32",
        stream=stream, max_abs_err=max_abs,
        tolerance=f"abs <= {atol} + {rtol} * |terms|",
        route_max_abs_diff=route_diff, route_same_bits=route_bits,
        off_map_corner_share=off_map,
        touched_rows=touched, library_max_abs_err=lib_err,
        plan={k: v for k, v in plan.items() if k != "tile"},
        ms=_cuda_ms(lambda: bl.bilinear_warp_affine(x, aff, out_hw),
                    iters=10),
        warp_ms=_cuda_ms(lambda: warp_images(x, aff, out_hw), iters=10),
        plain_ms=_cuda_ms(lambda: bl.bilinear_warp_affine_plain(
            x, aff, out_hw), iters=3, warmup=1),
        library_ms=_cuda_ms(library, iters=10),
        k3f_corners_ms=_cuda_ms(lambda: bl.bilinear_corners(ys, xs, h, w),
                                iters=10),
        k3f_pad_ms=_cuda_ms(lambda: bl.pad_channels(flat), iters=10),
        k3f_ms=_cuda_ms(lambda: bl.bilinear_gather(padded, ci, cw),
                        iters=10),
        k3f_slice_ms=_cuda_ms(lambda: bl.unpad_channels(out_padded, c),
                              iters=10),
        k3f_route_ms=_cuda_ms(lambda: bl.bilinear_sample_2d(
            x, *bl.affine_points(aff, out_hw)), iters=10))
    case["grid_sample_ms"] = case["library_ms"]
    case["bound_ms"], case["bound_by"] = _bound(
        b * p * c * 4 + touched * c * 4 + 24 * b, b * p * (28 + 8 * c))
    case["k3f_bound_ms"], _ = _bound(
        b * p * c * 4 + touched * c * 4 + 2 * b * p * 4 * 4, 8 * b * p * c)
    del padded, out_padded, ci, cw, ys, xs, grid
    print(f"  bilinear_warp_affine {stream} x{case['shape']} -> "
          f"{tuple(out_hw)}{note} max_abs={max_abs:.3e} off-map corners "
          f"{off_map:.3f}, {plan['route']} route: launch "
          f"{case['ms'] * 1e3:7.1f}us, "
          f"warp_images {case['warp_ms'] * 1e3:7.1f}us, bound "
          f"{case['bound_ms'] * 1e3:6.1f}us ({case['bound_by']}), "
          f"grid_sample {case['library_ms'] * 1e3:7.1f}us (differs by "
          f"{lib_err:.2e}), plain {case['plain_ms'] * 1e3:8.1f}us; the K3f "
          f"route {case['k3f_route_ms'] * 1e3:8.1f}us = corners "
          f"{case['k3f_corners_ms'] * 1e3:7.1f} + pad "
          f"{case['k3f_pad_ms'] * 1e3:6.1f} + K3f {case['k3f_ms'] * 1e3:6.1f}"
          f" + slice {case['k3f_slice_ms'] * 1e3:6.1f}us (bound "
          f"{case['k3f_bound_ms'] * 1e3:6.1f}us), differs from the kernel "
          f"by {route_diff:.2e} (same bits {route_bits}); {card}",
          flush=True)
    if not ok:
        raise AssertionError(f"bilinear_warp_affine_fwd disagrees with its "
                             f"plain version on the {stream} warp: {case}")
    return case


def _canvases(dev, hws, side, channels, gen):
    """(B, side, side, channels) f32 on ``dev``: uniform [0, 255) inside
    each image's (h, w), zero beyond it, as ``CocoDetection`` pads."""
    x = torch.zeros(len(hws), side, side, channels, device=dev)
    for i, (h, w) in enumerate(hws):
        x[i, :h, :w] = 255 * torch.rand(h, w, channels, generator=gen).to(dev)
    return x


def check_coco_warp(dev, card):
    """Phase 3: the warp kernel at the COCO path's warps
    (``data/transforms.py:warp_images``): the train warp (16, 640^2, 3) to
    512^2 under the train transform's random affines, on the in-memory
    set's image sizes; the eval warp (4, 1024^2, 3) to the (512, 768) and
    (768, 768) keep-res buckets (centred, never resized); one of the
    mosaic's four warps (16, 640^2, 3) to 640^2; and Mask R-CNN's GT
    bitmaps (8, 160^2, 128) to 128^2 under the image's affine with its
    translation / 4."""
    from minddet_tpu_torch.data.transforms import (draw_mosaic,
                                                   draw_train_affine,
                                                   train_affine_from_draws)
    from minddet_tpu_torch.train.synthetic import synthetic_coco_records

    gen = torch.Generator().manual_seed(12)
    cases = []
    hw = torch.stack([torch.from_numpy(r["hw"]) for r in
                      synthetic_coco_records(COCO_TRAIN_BATCH, seed=0)])
    aff, _ = train_affine_from_draws(
        hw.to(dev), (COCO_TRAIN_OUT,) * 2,
        draw_train_affine(gen, COCO_TRAIN_BATCH))
    x = _canvases(dev, hw.tolist(), COCO_CANVAS, 3, gen)
    cases.append(_warp_case("coco_train", x, aff, (COCO_TRAIN_OUT,) * 2,
                            card))
    # one mosaic quadrant's warp: the top left one, the whole source image
    # fit into [0, cx) x [0, cy)
    m = draw_mosaic(gen, COCO_TRAIN_BATCH)
    qw, qh = m["cx"] * MOSAIC_OUT, m["cy"] * MOSAIC_OUT
    maff = torch.zeros(COCO_TRAIN_BATCH, 2, 3)
    maff[:, 0, 0] = hw[:, 1].float() / qw
    maff[:, 1, 1] = hw[:, 0].float() / qh
    cases.append(_warp_case("coco_mosaic", x, maff.to(dev),
                            (MOSAIC_OUT,) * 2, card,
                            " (one of four a batch)"))
    del x
    for bucket, (h, w) in COCO_EVAL_BUCKETS:
        ih, iw = bucket
        eaff = torch.tensor([[1.0, 0.0, -(iw - w) / 2.0],
                             [0.0, 1.0, -(ih - h) / 2.0]]).expand(
            COCO_EVAL_BATCH, 2, 3).contiguous()
        x = _canvases(dev, [(h, w)] * COCO_EVAL_BATCH, COCO_EVAL_CANVAS, 3,
                      gen)
        cases.append(_warp_case(f"coco_eval_{ih}x{iw}", x, eaff.to(dev),
                                bucket, card, f" ({h} x {w} images)"))
        del x
    side = COCO_CANVAS // BITMAP_STRIDE
    bits = (torch.rand(MASK_TRAIN_BATCH, side, side, BITMAP_SLOTS,
                       generator=gen) < 0.05).float().to(dev)
    baff = aff[:MASK_TRAIN_BATCH].clone()
    baff[:, :, 2] /= BITMAP_STRIDE
    cases.append(_warp_case("gt_bitmaps", bits, baff,
                            (COCO_TRAIN_OUT // BITMAP_STRIDE,) * 2, card))
    del bits
    torch.cuda.empty_cache()
    return cases


def _coco_eval_capture(model, module):
    """Wrap ``model.predict`` and ``module``'s ``_soft_nms_per_class`` and
    ``evaluate_coco_detections`` to keep what they see: the warped inputs
    and raw detections per predict batch, each image's soft-NMS inputs and
    outputs, the scored predictions. Returns (kept, undo)."""
    kept = dict(warped=[], dets=[], nms=[], predictions=None)
    predict, nms, score = (model.predict, module._soft_nms_per_class,
                           module.evaluate_coco_detections)

    def keep_predict(image, *a, **k):
        out = predict(image, *a, **k)
        kept["warped"].append(image.detach().float().cpu())
        kept["dets"].append(out.detach().float().cpu())
        return out

    def keep_nms(*args, **kwargs):
        out = nms(*args, **kwargs)
        kept["nms"].append((args[:3], out))
        return out

    def keep_score(ds, predictions, *a, **k):
        kept["predictions"] = predictions
        return score(ds, predictions, *a, **k)

    model.predict = keep_predict
    module._soft_nms_per_class = keep_nms
    module.evaluate_coco_detections = keep_score

    def undo():
        del model.predict
        module._soft_nms_per_class = nms
        module.evaluate_coco_detections = score

    return kept, undo


def check_coco_f32(dev, gen):
    """Phase 4q, with TF32 off: see ``_check_coco_f32``."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_coco_f32(dev, gen)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _check_coco_f32(dev, gen):
    """Phase 4q: the f32 COCO path, card against CPU.

    ``centernet_evaluate`` on COCO_CHECK_IMAGES in-memory images (two
    keep-res buckets) runs on both sides with the same f32 flagship
    (``randomize_for_check``, then BN statistics from the first bucket's
    warped batch, which the evaluation feeds unnormalized, in [0, 255], as
    the reference does; the wh head set so every box has an area): the
    warped inputs within ``GATHER_TOL``; the raw top-100 scores within
    COCO_SCORE_TOL position by position, as phase 4 holds them, the class
    agreement reported; each image's per-class soft-NMS run on the card on
    the CPU's inputs, the same boxes and labels kept and the rescored
    scores within COCO_SOFT_NMS_TOL. Then the evaluator: with the CPU's
    final detections as each image's GT, the CPU's AP@[.5:.95] is 1 (by
    construction) and the card's must reach COCO_AP_FLOOR. Last, the train
    transform on one raw batch of 4 (640 canvas, the same draws): the
    image (warp, colour, normalize) within COCO_IMAGE_TOL and the boxes
    within COCO_BOX_TOL px."""
    import types

    import numpy as np

    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.coco import (CocoDetection,
                                             evaluate_coco_detections)
    from minddet_tpu_torch.data.loader import stack_collate
    from minddet_tpu_torch.data.transforms import warp_images
    from minddet_tpu_torch.entry import build_model
    from minddet_tpu_torch.train import evaluate as ev
    from minddet_tpu_torch.train.synthetic import (coco_device_batch,
                                                   draw_coco_batch,
                                                   synthetic_coco_records)

    records = synthetic_coco_records(COCO_CHECK_IMAGES, seed=4,
                                     sizes=COCO_CHECK_SIZES)
    ds = CocoDetection(records, max_hw=(COCO_EVAL_CANVAS,) * 2,
                       keep_raw=True)
    cpu = randomize_for_check(build_model("cpu", dtype=torch.float32), gen)
    h, w = records[0]["hw"]
    ih, iw = ev._keep_res_hw(int(h), int(w))
    first = [i for i in range(len(ds)) if tuple(records[i]["hw"]) == (h, w)]
    canvas = torch.from_numpy(np.stack([ds[i]["image"] for i in first]))
    aff = torch.tensor([[1.0, 0.0, -(iw - w) / 2.0],
                        [0.0, 1.0, -(ih - h) / 2.0]]).expand(len(first), 2, 3)
    with torch.no_grad():
        randomize_bn(cpu, warp_images(canvas, aff, (ih, iw)), gen)
        cpu.head.wh.out.weight.mul_(COCO_WH_GAIN)
        cpu.head.wh.out.bias.fill_(COCO_WH_BIAS)
    gpu = build_model(dev, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())

    sides = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        kept, undo = _coco_eval_capture(model, ev)
        try:
            kept["stats"] = ev.centernet_evaluate(model, ds)
        finally:
            undo()
        sides[name] = kept
    card, host = sides["card"], sides["cpu"]
    result = dict(images=len(ds), batches=len(host["warped"]),
                  buckets=sorted({tuple(t.shape[1:3]) for t in host["warped"]}))
    atol, rtol = GATHER_TOL["float32"]
    warp_err = max(float((g - c).abs().max())
                   for g, c in zip(card["warped"], host["warped"]))
    warp_ok = all(bool(((g - c).abs() <= atol + rtol * c.abs()).all())
                  for g, c in zip(card["warped"], host["warped"]))
    result["warp_max_abs_err"] = warp_err
    score_err, agree = 0.0, []
    for g, c in zip(card["dets"], host["dets"]):
        score_err = max(score_err, float((g[..., 4] - c[..., 4]).abs().max()))
        agree.append(float((g[..., 5] == c[..., 5]).float().mean()))
    result["score_max_abs_err"] = score_err
    result["class_agreement"] = min(agree)
    # soft-NMS on the card, on the CPU's own inputs
    nms_err, nms_same = 0.0, True
    for (boxes, scores, labels), want in host["nms"]:
        got = ev._soft_nms_per_class(boxes, scores, labels, 80, device=dev)
        same = (len(got[1]) == len(want[1])
                and np.array_equal(got[0], want[0])
                and np.array_equal(got[2], want[2]))
        nms_same &= same
        if same and len(want[1]):
            nms_err = max(nms_err, float(np.abs(got[1] - want[1]).max()))
    result.update(soft_nms_max_abs_err=nms_err, soft_nms_same_kept=nms_same,
                  soft_nms_images=len(host["nms"]))
    # the evaluator: the CPU's final detections as the GT
    gt = []
    for r in records:
        p = host["predictions"][int(r["image_id"])]
        gt.append({"image_id": r["image_id"], "hw": r["hw"],
                   "boxes": p["boxes"].astype(np.float32),
                   "labels": p["labels"].astype(np.int32),
                   "iscrowd": np.zeros(len(p["labels"]), np.int32)})
    gt_ds = types.SimpleNamespace(records=gt)
    result["gt_boxes"] = sum(len(r["boxes"]) for r in gt)
    result["cpu_stats_on_its_own"] = evaluate_coco_detections(
        gt_ds, host["predictions"], 80)
    result["card_stats"] = evaluate_coco_detections(
        gt_ds, card["predictions"], 80)
    cpu_ap = result["cpu_stats_on_its_own"]["AP"]
    card_ap = result["card_stats"]["AP"]
    # the train transform: one raw batch, the same draws
    train_ds = CocoDetection(records[:4])
    raw = stack_collate([train_ds[i] for i in range(4)])
    draws = draw_coco_batch(torch.Generator().manual_seed(5), 4)
    kernels.reset_launches()
    got = coco_device_batch(raw, draws, (COCO_TRAIN_OUT,) * 2, device=dev)
    torch.cuda.synchronize()
    transform_launches = kernels.BILINEAR_WARP_AFFINE_FWD.launches
    want = coco_device_batch(raw, draws, (COCO_TRAIN_OUT,) * 2,
                             device="cpu")
    result["train_image_max_abs_err"] = float(
        (got["image"].cpu() - want["image"]).abs().max())
    result["train_boxes_max_abs_err"] = float(
        (got["gt_boxes"].cpu() - want["gt_boxes"]).abs().max())
    result["train_transform_warp_launches"] = transform_launches
    print(f"  {result['images']} images in buckets {result['buckets']}: warp "
          f"max abs {warp_err:.3e}; raw top-100 scores max abs "
          f"{score_err:.3e}, classes agree {result['class_agreement']:.3f}; "
          f"soft-NMS on the CPU's inputs: same kept {nms_same}, scores max "
          f"abs {nms_err:.3e}; AP@[.5:.95] against the CPU's {result['gt_boxes']} "
          f"final detections as GT: CPU {cpu_ap:.6f}, card {card_ap:.6f} "
          f"(AP50 {result['card_stats']['AP50']:.6f}); train transform "
          f"image max abs {result['train_image_max_abs_err']:.3e}, boxes "
          f"{result['train_boxes_max_abs_err']:.3e} px, warp kernel "
          f"launches {transform_launches}", flush=True)
    bad = []
    if not warp_ok:
        bad.append(f"warped inputs over GATHER_TOL (max abs {warp_err})")
    if score_err > COCO_SCORE_TOL:
        bad.append(f"raw scores {score_err} > {COCO_SCORE_TOL}")
    if not nms_same or nms_err > COCO_SOFT_NMS_TOL:
        bad.append(f"soft-NMS: same kept {nms_same}, scores {nms_err} > "
                   f"{COCO_SOFT_NMS_TOL}")
    if abs(cpu_ap - 1.0) > 1e-12:
        bad.append(f"the CPU's AP on its own detections is {cpu_ap}, not 1")
    if card_ap < COCO_AP_FLOOR:
        bad.append(f"the card's AP {card_ap} < {COCO_AP_FLOOR}")
    if result["train_image_max_abs_err"] > COCO_IMAGE_TOL:
        bad.append(f"train image {result['train_image_max_abs_err']}")
    if result["train_boxes_max_abs_err"] > COCO_BOX_TOL:
        bad.append(f"train boxes {result['train_boxes_max_abs_err']}")
    if transform_launches != 1:
        bad.append(f"the train transform launched the warp kernel "
                   f"{transform_launches} times (want 1)")
    if bad:
        raise AssertionError("phase 4q: " + "; ".join(bad))
    return result


def coco_train_main_path(dev, card):
    """Phase 6ai: the config's train step fed by ``coco_batches``
    (``centernet_coco_train_entry``: batch 16, Adam under
    ``multi_epochs_decay``, clip 35, the NaN guard), COCO_TRAIN_STEPS
    steps, each on the next batch of the affine route, launch counts from
    0: the warp kernel once, K1f and K1b nine times a step, nothing else;
    every loss finite. Then apart: the same step on one fixed batch (what
    the data path adds), the host-to-device copy of a raw batch (its f32
    canvas 78.6 MB), the transform's device time split into the warp
    (``warp_images``) and the rest, beside the same transform with a
    gradient asked of the images (which takes the replaced route: the
    corners, the pad, K3f and the slice), and the host's wait for the
    loader's next raw batch. ms on the host clock around synced work."""
    import numpy as np

    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.coco import CocoDetection
    from minddet_tpu_torch.data.loader import stack_collate
    from minddet_tpu_torch.data.transforms import (
        centernet_train_transform_from_draws, train_affine_from_draws,
        warp_images)
    from minddet_tpu_torch.entry import centernet_coco_train_entry
    from minddet_tpu_torch.train.synthetic import (draw_coco_batch,
                                                   synthetic_coco_records)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batches) = centernet_coco_train_entry(
        device=dev, batch=COCO_TRAIN_BATCH)
    kernels.reset_launches()
    history, times = [], []
    for i in range(COCO_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    want = _sampler_launches(COCO_TRAIN_STEPS)
    want["bilinear_warp_affine_fwd"] = COCO_TRAIN_STEPS
    fixed = []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            fixed.append(time.perf_counter() - t0)
    # the data path's parts, on one raw batch of the same set
    ds = CocoDetection(synthetic_coco_records(COCO_TRAIN_BATCH, seed=0))
    t0 = time.perf_counter()
    raw = stack_collate([ds[i] for i in range(COCO_TRAIN_BATCH)])
    host_s = time.perf_counter() - t0
    copies = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_raw = {k: torch.from_numpy(np.asarray(raw[k])).to(dev)
                   for k in ("image", "hw", "boxes", "labels", "mask")}
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    draws = draw_coco_batch(torch.Generator().manual_seed(1),
                            COCO_TRAIN_BATCH)
    out_hw = (COCO_TRAIN_OUT,) * 2
    transform_ms = _cuda_ms(lambda: centernet_train_transform_from_draws(
        dev_raw["image"], dev_raw["hw"], dev_raw["boxes"], draws, out_hw),
        iters=5)
    images = dev_raw["image"].float() / 255.0
    affines, _ = train_affine_from_draws(dev_raw["hw"], out_hw,
                                         draws["affine"])
    warp_ms = _cuda_ms(lambda: warp_images(images, affines, out_hw),
                       iters=5)
    graded = dev_raw["image"].clone().requires_grad_()
    k3f_transform_ms = _cuda_ms(
        lambda: centernet_train_transform_from_draws(
            graded, dev_raw["hw"], dev_raw["boxes"], draws, out_hw), iters=5)
    del images, graded
    waits = []
    for _ in range(4):
        t0 = time.perf_counter()
        next(batches)
        torch.cuda.synchronize()
        waits.append(time.perf_counter() - t0)
    mean_s, fixed_s = statistics.mean(times), statistics.mean(fixed)
    out = dict(batch=COCO_TRAIN_BATCH, steps=COCO_TRAIN_STEPS,
               timed_steps=len(times), ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               img_per_s=COCO_TRAIN_BATCH / mean_s,
               fixed_batch_ms_per_step=fixed_s * 1e3,
               data_path_ms_per_step=(mean_s - fixed_s) * 1e3,
               h2d_copy_ms=statistics.median(copies) * 1e3,
               h2d_bytes=int(sum(np.asarray(raw[k]).nbytes for k in
                                 ("image", "hw", "boxes", "labels", "mask"))),
               transform_device_ms=transform_ms,
               transform_warp_ms=warp_ms,
               transform_k3f_route_ms=k3f_transform_ms,
               host_batch_ms_one_thread=host_s * 1e3,
               next_batch_ms=statistics.median(waits) * 1e3,
               max_memory_allocated=peak,
               losses=[m["loss"] for m in history], last_step=history[-1],
               launches=launches, card=card)
    print(f"  config step fed by coco_batches, batch {COCO_TRAIN_BATCH}: "
          f"{out['ms_per_step']:.3f} ms/step (p50 {out['ms_p50']:.3f}), "
          f"{out['img_per_s']:.1f} img/s; on one fixed batch "
          f"{out['fixed_batch_ms_per_step']:.3f} ms/step, so the data path "
          f"adds {out['data_path_ms_per_step']:.3f} ms; copy of a raw batch "
          f"({out['h2d_bytes'] / 1e6:.1f} MB) {out['h2d_copy_ms']:.3f} ms, "
          f"transform on the device {transform_ms:.3f} ms (the warp "
          f"{warp_ms:.3f}, the rest {transform_ms - warp_ms:.3f}; with the "
          f"replaced K3f route {k3f_transform_ms:.3f} ms), a raw batch on "
          f"one host thread {out['host_batch_ms_one_thread']:.1f} ms, the "
          f"next batch {out['next_batch_ms']:.3f} ms; peak "
          f"{peak / 2 ** 30:.2f} GiB allocated; {card}", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in out["losses"]),
          flush=True)
    if not all(math.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"the COCO-fed train step is not finite: "
                             f"{history}")
    if launches != want:
        raise AssertionError(f"{launches} in {COCO_TRAIN_STEPS} COCO-fed "
                             f"steps (want {want})")
    print(f"  kernels: {launches} for {COCO_TRAIN_STEPS} steps: one warp "
          f"kernel and nine each of K1f and K1b a step: True", flush=True)
    return out


def coco_eval_main_path(dev, card):
    """Phase 6aj: ``centernet_eval_entry`` (the bf16 flagship, 64
    in-memory images, keep-res buckets of 128 on the 1024 canvas, batch 4,
    soft-NMS, the top-100 merge), after one warm-up predict and warp at
    each bucket's shape, launch counts from 0: the warp kernel once and K1f
    nine times per predict batch, nothing else. Reports ms per image split into its
    parts (``centernet_evaluate``'s ``timings``) and the 12 numbers."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.transforms import warp_images
    from minddet_tpu_torch.entry import COCO_IMAGES, centernet_eval_entry
    from minddet_tpu_torch.train.evaluate import _keep_res_hw

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    evaluate_fn, (model, ds) = centernet_eval_entry(device=dev)
    groups = {}
    for i in range(len(ds)):
        h, w = ds.records[i]["hw"]
        key = _keep_res_hw(int(h), int(w))
        groups[key] = groups.get(key, 0) + 1
    batches = sum(-(-n // COCO_EVAL_BATCH) for n in groups.values())
    canvas = torch.zeros(COCO_EVAL_BATCH, COCO_EVAL_CANVAS, COCO_EVAL_CANVAS,
                         3, device=dev)
    eye = torch.eye(2, 3, device=dev).expand(COCO_EVAL_BATCH, 2, 3)
    for bucket in groups:
        model.predict(warp_images(canvas, eye, bucket))
    del canvas
    torch.cuda.synchronize()
    kernels.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    stats = evaluate_fn(model, ds, timings=timings)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = _sampler_launches(batches, train=False)
    want["bilinear_warp_affine_fwd"] = batches
    n = len(ds)
    out = dict(images=n, buckets={f"{h}x{w}": c for (h, w), c in
                                  sorted(groups.items())},
               predict_batches=batches, ms_per_image=wall / n * 1e3,
               part_ms_per_image={k: v / n * 1e3 for k, v in timings.items()},
               launches=launches, launches_per_image={
                   k: v / n for k, v in launches.items() if v},
               stats=stats,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               card=card)
    print(f"  centernet_evaluate, {n} images, buckets {out['buckets']}, "
          f"{batches} predict batches: {out['ms_per_image']:.3f} ms per "
          f"image = " + " + ".join(f"{k} {v:.3f}" for k, v in
                                   out["part_ms_per_image"].items())
          + "; launches per image " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["launches_per_image"].items())
          + f"; {card}", flush=True)
    print("  stats: " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()),
          flush=True)
    if len(stats) != 12 or not all(math.isfinite(v) and -1 <= v <= 1
                                   for v in stats.values()):
        raise AssertionError(f"the COCO stats are not 12 numbers in [-1, 1]:"
                             f" {stats}")
    if COCO_IMAGES != n or launches != want:
        raise AssertionError(f"{launches} for {batches} predict batches of "
                             f"{n} images (want {want})")
    print(f"  kernels: {launches} per {batches} batches: one warp kernel "
          f"and nine K1f a batch: True", flush=True)
    return out


def coco_mosaic_main_path(dev, card):
    """Phase 6ak: the mosaic route of ``coco_batches`` (no model) at 640 x
    640, batch 16, over the in-memory set through four loader threads:
    MOSAIC_BATCHES batches, launch counts from 0: the warp kernel four
    times a batch, nothing else; every image finite, boxes and masks 8 x
    128 slots. ms per batch on the host clock (the last 10, synced). Then
    the device half of one batch (mosaic, mixup, normalize on a raw batch
    already on the card) timed on the device, the mosaic apart, beside the
    same with a gradient asked of the images (the replaced route: four
    sets of corners, pads, K3f launches and slices)."""
    import numpy as np

    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.coco import CocoDetection
    from minddet_tpu_torch.data.loader import stack_collate
    from minddet_tpu_torch.data.transforms import (mixup_from_draws,
                                                   mosaic_from_draws,
                                                   normalize)
    from minddet_tpu_torch.entry import COCO_IMAGES, COCO_MAX_OBJS
    from minddet_tpu_torch.train.synthetic import (coco_batches,
                                                   draw_coco_batch,
                                                   synthetic_coco_records)

    torch.cuda.empty_cache()
    cfg = {"data": {"records": synthetic_coco_records(COCO_IMAGES, seed=0),
                    "max_objs": COCO_MAX_OBJS, "workers": 4}}
    batches = coco_batches(cfg, COCO_TRAIN_BATCH, (MOSAIC_OUT,) * 2,
                           aug="mosaic", device=dev)
    kernels.reset_launches()
    times, finite = [], True
    for i in range(MOSAIC_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(batches)
        finite &= bool(torch.isfinite(batch["image"]).all())
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    want = {k.name: 4 * MOSAIC_BATCHES
            * (k is kernels.BILINEAR_WARP_AFFINE_FWD)
            for k in kernels.KERNELS}
    slots = 8 * COCO_MAX_OBJS
    shapes = (tuple(batch["image"].shape), tuple(batch["gt_boxes"].shape))
    # the device half of one batch, on a raw batch already on the card
    ds = CocoDetection(cfg["data"]["records"][:COCO_TRAIN_BATCH])
    raw = stack_collate([ds[i] for i in range(COCO_TRAIN_BATCH)])
    raw = {k: torch.from_numpy(np.asarray(raw[k])).to(dev)
           for k in ("image", "hw", "boxes", "mask")}
    draws = draw_coco_batch(torch.Generator().manual_seed(1),
                            COCO_TRAIN_BATCH, "mosaic")
    out_hw = (MOSAIC_OUT,) * 2

    def mosaic(images):
        return mosaic_from_draws(images / 255.0, raw["hw"], raw["boxes"],
                                 raw["mask"], draws["mosaic"], out_hw)

    def device_half(images):
        m = mosaic(images)
        mx = mixup_from_draws(m["image"], m["boxes"], m["mask"],
                              draws["mixup"])
        return normalize(mx["image"])

    graded = raw["image"].clone().requires_grad_()
    device_ms = _cuda_ms(lambda: device_half(raw["image"]), iters=5)
    mosaic_ms = _cuda_ms(lambda: mosaic(raw["image"]), iters=5)
    k3f_device_ms = _cuda_ms(lambda: device_half(graded), iters=5)
    del raw, graded
    mean_s = statistics.mean(times)
    out = dict(batch=COCO_TRAIN_BATCH, batches=MOSAIC_BATCHES,
               ms_per_batch=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               img_per_s=COCO_TRAIN_BATCH / mean_s, launches=launches,
               device_ms_per_batch=device_ms, mosaic_device_ms=mosaic_ms,
               k3f_route_device_ms_per_batch=k3f_device_ms,
               valid_boxes=int(batch["gt_mask"].sum()), card=card)
    print(f"  mosaic + mixup route, batch {COCO_TRAIN_BATCH} at "
          f"{MOSAIC_OUT}^2: {out['ms_per_batch']:.3f} ms/batch (p50 "
          f"{out['ms_p50']:.3f}), {out['img_per_s']:.1f} img/s, "
          f"{out['valid_boxes']} valid boxes in the last batch; its device "
          f"half {device_ms:.3f} ms (the mosaic {mosaic_ms:.3f}; with the "
          f"replaced K3f route {k3f_device_ms:.3f} ms); {card}",
          flush=True)
    if not finite or shapes != ((COCO_TRAIN_BATCH, MOSAIC_OUT, MOSAIC_OUT,
                                 3), (COCO_TRAIN_BATCH, slots, 4)):
        raise AssertionError(f"mosaic batches: finite {finite}, shapes "
                             f"{shapes}")
    if launches != want:
        raise AssertionError(f"{launches} in {MOSAIC_BATCHES} mosaic batches "
                             f"(want four warp kernels a batch, nothing "
                             f"else)")
    print(f"  kernels: {launches} for {MOSAIC_BATCHES} batches: four warp "
          f"kernels a batch: True", flush=True)
    return out


# the KITTI data, train and eval paths (the car and ped_cycle configs)
KITTI_CHECK_FRAMES = 4  # 4r: frames predicted on the card and the CPU
KITTI_SCORE_THRESHOLD = 0.3  # kitti_evaluate's detections
KITTI_MATCH_TOL = (1e-3, 1e-4)  # 4r: box (m, rad) and score of a match
KITTI_MATCHED_SHARE = 0.95  # of the CPU's detections found on the card
KITTI_AP_TOL = 1e-6  # 4r: every table entry, card overlaps vs the CPU's
# 6al / 6am: fed steps over this many epochs of the loader, the first one
# untimed (its batches are made ahead while the step warms up)
KITTI_FED_EPOCHS = 3
KITTI_LOADER_BATCHES = 4  # 6al / 6am: the one-thread loader's batches
KITTI_SERVE_BATCHES = (1, 4)  # 6ao


def _kitti_jittered(gt, rs):
    """Detections made from the labels (DontCare left out): location
    +-0.3 m, sizes +-10 %, heading +-0.1 rad, image box +-4 px, alpha
    +-0.2, scores uniform in (0.3, 1): a table with entries above 0."""
    real = np.nonzero(gt["name"] != "DontCare")[0]
    n = len(real)
    return {"name": gt["name"][real].astype("U16"),
            "bbox": (gt["bbox"][real] + rs.uniform(-4, 4, (n, 4))).astype(
                np.float32),
            "location": (gt["location"][real] + rs.uniform(
                -0.3, 0.3, (n, 3))).astype(np.float32),
            "dimensions": (gt["dimensions"][real] * rs.uniform(
                0.9, 1.1, (n, 3))).astype(np.float32),
            "rotation_y": (gt["rotation_y"][real] + rs.uniform(
                -0.1, 0.1, n)).astype(np.float32),
            "alpha": (gt["alpha"][real] + rs.uniform(-0.2, 0.2, n)).astype(
                np.float32),
            "score": rs.uniform(0.3, 1.0, n).astype(np.float32),
            "occluded": np.zeros(n, np.int64),
            "truncated": np.zeros(n, np.float32)}


def _kitti_matched(got, ref):
    """Share of the CPU's detections above the threshold (boxes (n, 7),
    scores) that a card detection matches one to one by box (x, y, z, w,
    l, h within KITTI_MATCH_TOL[0], the heading modulo 2 pi) and score
    (KITTI_MATCH_TOL[1])."""
    gb, gs = got
    rb, rsc = ref
    used = np.zeros(len(gb), bool)
    hits = 0
    for b, sc in zip(rb, rsc):
        d = np.abs(gb[:, :6] - b[:6]).max(1) if len(gb) else np.zeros(0)
        dyaw = np.abs(np.remainder(gb[:, 6] - b[6] + np.pi, 2 * np.pi)
                      - np.pi) if len(gb) else np.zeros(0)
        ok = (~used & (np.maximum(d, dyaw) <= KITTI_MATCH_TOL[0])
              & (np.abs(gs - sc) <= KITTI_MATCH_TOL[1]))
        if ok.any():
            used[int(np.argmax(ok))] = True
            hits += 1
    return hits / max(len(rb), 1)


def check_kitti_f32(dev):
    """Phase 4r: the car config's KITTI eval path in f32 (TF32 off), card
    against CPU. ``predict_from_points`` on KITTI_CHECK_FRAMES frames of
    ``synthetic_kitti_records`` (through ``KittiDetection`` with the raw
    labels, batches of 4 as ``kitti_evaluate`` predicts them), heads
    calibrated on the first batch (``calibrate_heads``): the CPU's
    detections above the protocol's 0.3 matched one to one by box on the
    card (at least KITTI_MATCHED_SHARE). Then the evaluator on the same GT
    and detection annos (the CPU's detections and jittered copies of the
    labels, so that the table has entries): every metric's overlaps on the
    card (K4 for bev and 3d) within ``IOU_TOL`` of the CPU's plain ones,
    and every AP / AOS entry of ``get_official_eval_result`` within
    KITTI_AP_TOL. The host augmentations (``global_augment``,
    ``noise_per_object``, the sampler) are checked on the CPU only, by the
    CPU tests."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.kitti import (KittiDetection,
                                              detections_to_kitti_annos,
                                              kitti_gt_anno)
    from minddet_tpu_torch.data.kitti_eval import (calculate_overlaps,
                                                   get_official_eval_result)
    from minddet_tpu_torch.entry import build_pointpillars
    from minddet_tpu_torch.train.synthetic import synthetic_kitti_records

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ds = KittiDetection(synthetic_kitti_records(
            KITTI_CHECK_FRAMES, seed=PHASE_SEEDS["4r"]), keep_raw=True)
        exs = [ds[i] for i in range(KITTI_CHECK_FRAMES)]
        points = torch.from_numpy(np.stack([e["points"] for e in exs]))
        pmask = torch.from_numpy(np.stack([e["points_mask"] for e in exs]))
        cpu = build_pointpillars("cpu")
        calibrate_heads(cpu, points[:KITTI_EVAL_BATCH],
                        pmask[:KITTI_EVAL_BATCH])
        gpu = build_pointpillars(dev)
        gpu.load_state_dict(cpu.state_dict())
        kernels.reset_launches()
        det_g, det_c = [], []
        for s0 in range(0, KITTI_CHECK_FRAMES, KITTI_EVAL_BATCH):
            sl = slice(s0, s0 + KITTI_EVAL_BATCH)
            for model, out, where in ((gpu, det_g, dev), (cpu, det_c, "cpu")):
                d = model.predict_from_points(points[sl].to(where),
                                              pmask[sl].to(where))
                out += [{k: d[k][i].cpu().numpy() for k in
                         ("boxes", "scores", "labels")}
                        for i in range(d["boxes"].shape[0])]
        predict_launches = kernels.ROTATED_IOU.launches
        result, bad = {}, []
        shares, kept = [], []
        for g, c in zip(det_g, det_c):
            kg, kc = g["scores"] > KITTI_SCORE_THRESHOLD, \
                c["scores"] > KITTI_SCORE_THRESHOLD
            kept.append(int(kc.sum()))
            shares.append(_kitti_matched((g["boxes"][kg], g["scores"][kg]),
                                         (c["boxes"][kc], c["scores"][kc])))
        result.update(detections_cpu=kept, matched_share=min(shares),
                      predict_launches=predict_launches)
        if min(kept) == 0 or min(shares) < KITTI_MATCHED_SHARE:
            bad.append("detections")
        gt = [kitti_gt_anno(e) for e in exs]
        rs = np.random.RandomState(PHASE_SEEDS["4r"])
        dt = []
        for e, c, g in zip(exs, det_c, gt):
            k = c["scores"] > KITTI_SCORE_THRESHOLD
            a = detections_to_kitti_annos(
                c["boxes"][k], c["scores"][k], c["labels"][k], ("Car",),
                e["Trv2c_rect"], e["P2"], e["img_shape"])
            j = _kitti_jittered(g, rs)
            dt.append({key: np.concatenate([a[key], j[key]]) for key in a})
        atol, rtol = IOU_TOL
        for metric in ("bbox", "bev", "3d"):
            kernels.reset_launches()
            og = calculate_overlaps(gt, dt, metric, device=dev)
            launched = kernels.ROTATED_IOU.launches
            oc = calculate_overlaps(gt, dt, metric, device="cpu")
            err = max(float(np.abs(a - b).max()) for a, b in zip(og, oc)
                      if a.size)
            near = sum(int((np.abs(b - 0.7) < atol).sum()) for b in oc)
            result[f"{metric}_overlap_max_abs_err"] = err
            result[f"{metric}_near_0.7"] = near
            result[f"{metric}_k4_launches"] = launched
            if not all(np.allclose(a, b, rtol=rtol, atol=atol)
                       for a, b in zip(og, oc)):
                bad.append(f"{metric} overlaps")
            if launched != int(metric != "bbox"):
                bad.append(f"{metric}: {launched} K4 launches (want "
                           f"{int(metric != 'bbox')})")
        tg = get_official_eval_result(gt, dt, compute_aos=True, device=dev)
        tc = get_official_eval_result(gt, dt, compute_aos=True,
                                      device="cpu")
        diff = max(abs(a - b) for m in tc["Car"]
                   for a, b in zip(tg["Car"][m], tc["Car"][m]))
        result.update(table_card=tg["Car"], table_cpu=tc["Car"],
                      table_max_abs_diff=diff)
        if diff > KITTI_AP_TOL:
            bad.append("AP / AOS table")
        if max(tc["Car"]["3d"]) <= 0:
            bad.append("a table of zeros: the check tests nothing")
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    print("  f32 KITTI eval path card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 KITTI eval path, card vs CPU: {bad}: "
                             f"{result}")
    return result


def _loader_ms_per_batch(data, batch, workers, n):
    """The loader's own rate: a fresh ``kitti_batches`` over ``data`` at
    ``workers`` threads, its first ``n`` batches taken back to back from
    its start, less the GT database's build (timed apart on the same
    frames). Returns (ms per batch, ms of the database's build, the first
    batch)."""
    from minddet_tpu_torch.data.gt_sampler import build_gt_database
    from minddet_tpu_torch.data.kitti import KittiDetection
    from minddet_tpu_torch.entry import SEED
    from minddet_tpu_torch.train.synthetic import kitti_batches

    t0 = time.perf_counter()
    build_gt_database(KittiDetection(data["records"]), data["classes"])
    db_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = kitti_batches({"data": dict(data, workers=workers)}, batch,
                       seed=SEED)
    first = next(it)
    for _ in range(n - 1):
        next(it)
    total = time.perf_counter() - t0
    it.close()
    return (total - db_s) / n * 1e3, db_s * 1e3, first


def kitti_train_main_path(dev, card, config, label):
    """Phases 6al (the car config) and 6am (ped_cycle): the config's train
    step fed by ``kitti_batches`` (``pointpillars_kitti_train_entry``: f32,
    batch 4, AdamW with decay 1e-4 under ``exponential_decay``, the NaN
    guard; 64 in-memory frames, the GT database built from them, four
    loader threads), KITTI_FED_EPOCHS epochs of steps, each on the next
    batch, launch counts from 0: no kernel launches (a one-layer PFN,
    axis-aligned assignment IoUs); every loss finite and every step
    applied. The steps after the first epoch are timed, with the wait for
    each next batch (the loader, then the copy) apart: each epoch starts
    the loader's threads anew and they make its batches as fast as they
    can, so past the first epoch the fed rate is what a longer run sees,
    the loader's where it waits. Then apart: the same step on one fixed
    batch (what the data path adds), the copy of a raw batch to the card,
    and the loader's own rate (``_loader_ms_per_batch``: one epoch from a
    fresh ``kitti_batches`` at four threads, KITTI_LOADER_BATCHES batches
    at one). ms on the host clock around synced work."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (KITTI_BATCH_KEYS,
                                         KITTI_TRAIN_FRAMES, SEED,
                                         pointpillars_config,
                                         pointpillars_kitti_train_entry)
    from minddet_tpu_torch.train.synthetic import synthetic_kitti_records

    cfg = pointpillars_config(config)
    b = int(cfg["train"]["batch_size"])
    per_epoch = KITTI_TRAIN_FRAMES // b
    fed_steps = KITTI_FED_EPOCHS * per_epoch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batches) = pointpillars_kitti_train_entry(
        device=dev, config=config)
    kernels.reset_launches()
    history, times, waits, first_epoch = [], [], [], []
    for i in range(fed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i == 0:
            first_ms = (t1 - t0) * 1e3
        if i >= per_epoch:
            times.append(time.perf_counter() - t0)
            waits.append(t1 - t0)
        else:
            first_epoch.append(time.perf_counter() - t0)
    batches.close()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    fixed = []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            fixed.append(time.perf_counter() - t0)
    applied = int(state.optimizer.param_groups[0]["count"])
    data = dict(cfg["data"])
    data["records"] = synthetic_kitti_records(KITTI_TRAIN_FRAMES, seed=SEED,
                                              classes=data["classes"])
    loader_ms, db_ms, raw = _loader_ms_per_batch(
        data, b, int(data["workers"]), KITTI_TRAIN_FRAMES // b)
    loader_one_thread_ms, _, _ = _loader_ms_per_batch(data, b, 1,
                                                      KITTI_LOADER_BATCHES)
    copies = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        {k: torch.from_numpy(raw[k]).to(dev) for k in KITTI_BATCH_KEYS}
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    mean_s, fixed_s = statistics.mean(times), statistics.mean(fixed)
    wait_s = statistics.mean(waits)
    out = dict(config=str(config), classes=list(data["classes"]), batch=b,
               steps=fed_steps, epochs=KITTI_FED_EPOCHS,
               timed_steps=len(times), ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               clouds_per_s=b / mean_s, fixed_batch_ms_per_step=fixed_s * 1e3,
               data_path_ms_per_step=(mean_s - fixed_s) * 1e3,
               next_batch_ms=wait_s * 1e3,
               next_batch_ms_max=max(waits) * 1e3,
               wait_share=wait_s / mean_s,
               first_epoch_ms_per_step=statistics.mean(first_epoch) * 1e3,
               first_batch_ms=first_ms,
               h2d_copy_ms=statistics.median(copies) * 1e3,
               h2d_bytes=int(sum(raw[k].nbytes for k in KITTI_BATCH_KEYS)),
               gt_database_ms=db_ms, loader_ms_per_batch=loader_ms,
               loader_ms_per_batch_one_thread=loader_one_thread_ms,
               valid_boxes=int(batch["gt_mask"].sum()),
               steps_applied=applied, max_memory_allocated=peak,
               losses=[m["loss"] for m in history], last_step=history[-1],
               launches=launches, card=card)
    print(f"  {label} step fed by kitti_batches, batch {b}, epochs 2-"
          f"{KITTI_FED_EPOCHS} ({len(times)} steps): "
          f"{out['ms_per_step']:.3f} ms/step (p50 {out['ms_p50']:.3f}), "
          f"{out['clouds_per_s']:.1f} clouds/s, of it the wait for the next "
          f"batch {out['next_batch_ms']:.3f} ms (max "
          f"{out['next_batch_ms_max']:.3f}; {out['wait_share']:.0%} of the "
          f"step), the step itself {(mean_s - wait_s) * 1e3:.3f} ms while "
          f"the loader's threads work; the first epoch "
          f"{out['first_epoch_ms_per_step']:.3f} ms/step (the first batch, "
          f"with the GT database, {first_ms:.1f} ms); on one fixed batch "
          f"{out['fixed_batch_ms_per_step']:.3f} ms/step, so the data path "
          f"adds {out['data_path_ms_per_step']:.3f} ms; copy of a raw batch "
          f"({out['h2d_bytes'] / 1e6:.2f} MB) {out['h2d_copy_ms']:.3f} ms; "
          f"the loader alone {loader_ms:.1f} ms a batch at "
          f"{data['workers']} threads, {loader_one_thread_ms:.1f} at one "
          f"(the GT database {db_ms:.1f} ms apart); "
          f"{out['valid_boxes']} boxes in the last batch; peak "
          f"{peak / 2 ** 30:.2f} GiB; {card}", flush=True)
    print("  losses: " + " ".join(f"{v:.4f}" for v in out["losses"]),
          flush=True)
    if not all(math.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"{label}: the KITTI-fed step is not finite: "
                             f"{history}")
    if applied != fed_steps + TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"{label}: {applied} steps applied of "
                             f"{fed_steps + TRAIN_WARMUP + TRAIN_STEPS}")
    if any(launches.values()):
        raise AssertionError(f"{label}: {launches} in {fed_steps} steps "
                             f"(want no kernel launch)")
    print(f"  kernels: {launches}: none: True", flush=True)
    return out


def kitti_eval_main_path(dev, card):
    """Phase 6an: ``pointpillars_kitti_eval_entry`` (the car config's
    seeded f32 model, 256 in-memory frames: one whole chunk of the
    evaluator's overlaps) after one warm-up predict, launch counts from 0:
    K4 once per predict batch of 4 (the NMS) and once each for the bev and
    3d overlaps, nothing else. Reports ms per frame split into load, copy,
    predict, annos, overlaps (bbox, bev, 3d on the card) and the host's
    evaluator, and the 12 table numbers (near 0: seeded weights)."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (KITTI_EVAL_FRAMES,
                                         pointpillars_kitti_eval_entry)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    evaluate_fn, (model, ds) = pointpillars_kitti_eval_entry(device=dev)
    n = len(ds)
    pts = np.zeros((KITTI_EVAL_BATCH, ds.max_points, 4), np.float32)
    raw = ds.records[0]["points"][:ds.max_points]
    pts[:, :len(raw)] = raw
    model.predict_from_points(torch.from_numpy(pts).to(dev),
                              torch.ones(pts.shape[:2], dtype=torch.bool,
                                         device=dev))
    torch.cuda.synchronize()
    kernels.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    table = evaluate_fn(model, ds, timings=timings)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    batches = -(-n // KITTI_EVAL_BATCH)
    want = {k.name: (batches + 2) * (k is kernels.ROTATED_IOU)
            for k in kernels.KERNELS}
    numbers = [v for m in ("bbox", "bev", "3d", "aos")
               for v in table["Car"][m]]
    out = dict(frames=n, predict_batches=batches, ms_per_frame=wall / n * 1e3,
               part_ms_per_frame={k: v / n * 1e3
                                  for k, v in timings.items()},
               table=table, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               card=card)
    print(f"  kitti_evaluate, {n} frames, {batches} predict batches: "
          f"{out['ms_per_frame']:.3f} ms per frame = " + " + ".join(
              f"{k} {v:.3f}" for k, v in out["part_ms_per_frame"].items())
          + f"; {card}", flush=True)
    print("  Car AP (easy, moderate, hard): " + "; ".join(
        f"{m} " + " / ".join(f"{v:.4f}" for v in table["Car"][m])
        for m in ("bbox", "bev", "3d", "aos")), flush=True)
    if set(table) != {"Car"} or len(numbers) != 12 or not all(
            math.isfinite(v) and 0 <= v <= 100 for v in numbers):
        raise AssertionError(f"the KITTI table is not 12 numbers in [0, "
                             f"100]: {table}")
    if launches != want:
        raise AssertionError(f"{launches} for {batches} predict batches of "
                             f"{n} frames (want {want})")
    print(f"  kernels: {launches}: one K4 a predict batch and one each for "
          f"the bev and 3d overlaps: True", flush=True)
    return out

# The padded voxel path of both lidar families (phases 4s, 5r, 6ap-6as)
VOXEL_CANVAS_TOL = (1e-5, 1e-5)  # the padded PFN and scatter: atol, rtol
# stream vs padded canvas on the card: the pillar means are summed in
# another order (a bounded scan against a sum over the slots), so the
# cluster offsets of points ~70 m out differ by an ulp of 70 m (8e-6)
STREAM_PADDED_TOL = (1e-4, 1e-5)
TTA_CHECK_POINTS = 30000  # 4s's TTA: clouds cut from 120,000 points
PP_VOXEL_BATCHES = (1, 8)  # 6ap, car; ped_cycle at KITTI_SERVE_BATCHES
VOXEL_TRAIN_CP_TOL = dict(PP_TRAIN_TOL, cancelled=1e-9)


def _f32_checks(fn):
    """``fn(dev, *args)`` with TF32 off, the flags restored after."""
    def run(dev, *args):
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(dev, *args)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    run.__doc__ = fn.__doc__
    return run


@torch.inference_mode()
def _padded_canvas(model, vox):
    """Decoration, the padded PFN and the voxel scatter of ``model``."""
    from minddet_tpu_torch.models.readers.pillar_encoder import \
        scatter_voxel_canvas
    from minddet_tpu_torch.ops.voxelize import decorate_pillar_features

    feats = decorate_pillar_features(vox.voxels, vox.num_points, vox.coords,
                                     model.voxel_size, model.pc_range)
    return scatter_voxel_canvas(model.reader(feats, vox.num_points),
                                vox.coords, model.grid_ny, model.grid_nx)


def _same_voxels(vox_g, vox_c) -> bool:
    return all(torch.equal(getattr(vox_g, k).cpu(), getattr(vox_c, k))
               for k in vox_c._fields)


def _kept(det, i):
    """Sample ``i``'s kept detections on the CPU: (boxes, scores)."""
    keep = det["labels"][i].cpu() >= 0
    return (det["boxes"][i].cpu()[keep].numpy(),
            det["scores"][i].cpu()[keep].numpy())


def _one_k4(launches) -> bool:
    from minddet_tpu_torch import kernels

    return launches == {k.name: int(k is kernels.ROTATED_IOU)
                        for k in kernels.KERNELS}


@_f32_checks
def check_voxel_path_f32(dev):
    """Phase 4s: the padded voxel path in f32 (TF32 off), card against CPU,
    stage by stage. PointPillars at the car config, one cloud of 18,000
    points: ``voxelize_batch`` exactly (voxels, counts, coords), the
    canvas of the padded PFN and the voxel scatter (``VOXEL_CANVAS_TOL``),
    the generic anchor mask exactly (and equal to the grid mask from the
    same coords on the card), the heads on the voxels (``PP_HEAD_TOL``),
    and ``predict_from_points_padded`` (one K4 launch) with its detections
    matched one to one by box (``_kitti_matched``, at least
    ``CP_MATCHED_SHARE``); with the first-come drop order the card's
    stream canvas equals its padded one (``STREAM_PADDED_TOL``).
    CenterPoint at ``configs/centerpoint_pp_nusc.yaml`` (single stage,
    calibrated), one cloud of 120,000 points: the voxels exactly, every
    task's maps on the voxels (``PP_HEAD_TOL``), ``predict`` matched as
    sets (``_matched_share``); then ``predict_tta_double_flip`` on a cloud
    cut to ``TTA_CHECK_POINTS`` points (four clouds of voxels), its
    detections matched the same way, one K4 launch."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (CLOUD_POINTS, CP_CONFIG,
                                         NUSC_CLOUD_POINTS,
                                         NUSC_POINT_FEATURES,
                                         build_centerpoint,
                                         build_pointpillars,
                                         synthetic_clouds)
    from minddet_tpu_torch.ops.anchors import occupancy_from_coords

    result, bad = {}, []
    cpu = build_pointpillars("cpu")
    pts, mask = synthetic_clouds(1, cpu.pc_range, CLOUD_POINTS, seed=2)
    points, pmask = torch.from_numpy(pts), torch.from_numpy(mask)
    calibrate_heads(cpu, points, pmask)
    gpu = build_pointpillars(dev)
    gpu.load_state_dict(cpu.state_dict())
    pg, mg = points.to(dev), pmask.to(dev)
    vox_c, vox_g = cpu.voxelize(points, pmask), gpu.voxelize(pg, mg)
    result.update(pp_voxels=int(vox_c.num_voxels[0]),
                  pp_points_kept=int(vox_c.num_points.sum()))
    if not _same_voxels(vox_g, vox_c):
        bad.append("PointPillars voxels")
    vox_d = type(vox_c)(*(t.to(dev) for t in vox_c))
    canvas_c, canvas_g = _padded_canvas(cpu, vox_c), _padded_canvas(gpu,
                                                                     vox_d)
    err = (canvas_g.cpu() - canvas_c).abs()
    result["pp_canvas_max_abs_err"] = float(err.max())
    if not bool((err <= VOXEL_CANVAS_TOL[0] + VOXEL_CANVAS_TOL[1]
                 * canvas_c.abs()).all()):
        bad.append("PointPillars padded canvas")
    amask_c = cpu.anchor_mask_from_coords(vox_c.coords)
    amask_g = gpu.anchor_mask_from_coords(vox_d.coords)
    result["pp_anchor_mask_share"] = float(amask_c.float().mean())
    if not torch.equal(amask_g.cpu(), amask_c):
        bad.append("generic anchor mask")
    if not torch.equal(gpu.area_mask.from_coords(vox_d.coords), amask_g):
        bad.append("generic anchor mask against the grid mask")
    atol, rtol = PP_HEAD_TOL
    with torch.inference_mode():
        preds_c = cpu.forward_voxels(vox_c.voxels, vox_c.num_points,
                                     vox_c.coords)
        preds_g = gpu.forward_voxels(vox_d.voxels, vox_d.num_points,
                                     vox_d.coords)
    for name, ref in preds_c.items():
        got = preds_g[name].cpu()
        result[f"pp_{name}_max_abs_err"] = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=rtol, atol=atol):
            bad.append(f"PointPillars head {name}")
    kernels.reset_launches()
    det_g = gpu.predict_from_points_padded(pg, mg)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if not _one_k4(launches):
        bad.append(f"PointPillars padded predict launched {launches}")
    det_c = cpu.predict_from_points_padded(points, pmask)
    result["pp_kept_cpu"] = int((det_c["labels"] >= 0).sum())
    result["pp_matched_share"] = _kitti_matched(_kept(det_g, 0),
                                                _kept(det_c, 0))
    if result["pp_matched_share"] < CP_MATCHED_SHARE:
        bad.append("PointPillars padded detections, as sets")
    gpu.voxel_drop_order = "first_come"
    with torch.inference_mode():
        stream, occ = gpu.canvas_from_points(pg, mg)
    err = (stream - canvas_g).abs()
    result["stream_vs_padded_max_abs_err"] = float(err.max())
    if not (bool((err <= STREAM_PADDED_TOL[0] + STREAM_PADDED_TOL[1]
                  * canvas_g.abs()).all())
            and torch.equal(occ, occupancy_from_coords(
                vox_d.coords, gpu.grid_ny, gpu.grid_nx))):
        bad.append("stream and padded canvases under first_come")
    del cpu, gpu, canvas_c, canvas_g, stream

    cpu = build_centerpoint("cpu", CP_CONFIG)
    pts, mask = synthetic_clouds(1, cpu.pc_range, NUSC_CLOUD_POINTS, seed=3,
                                 num_features=NUSC_POINT_FEATURES)
    points, pmask = torch.from_numpy(pts), torch.from_numpy(mask)
    calibrate_centerpoint(cpu, points, pmask)
    gpu = build_centerpoint(dev, CP_CONFIG)
    gpu.load_state_dict(cpu.state_dict())
    pg, mg = points.to(dev), pmask.to(dev)
    vox_c, vox_g = cpu.voxelize(points, pmask), gpu.voxelize(pg, mg)
    result.update(cp_voxels=int(vox_c.num_voxels[0]),
                  cp_points_kept=int(vox_c.num_points.sum()))
    if not _same_voxels(vox_g, vox_c):
        bad.append("CenterPoint voxels")
    with torch.inference_mode():
        maps_c = cpu.forward_voxels(vox_c.voxels, vox_c.num_points,
                                    vox_c.coords)
        maps_g = gpu.forward_voxels(vox_g.voxels, vox_g.num_points,
                                    vox_g.coords)
    worst = 0.0
    for t, (pc, pgm) in enumerate(zip(maps_c, maps_g)):
        for name, ref in pc.items():
            got = pgm[name].float().cpu()
            worst = max(worst, float((got - ref.float()).abs().max()))
            if not torch.allclose(got, ref.float(), rtol=rtol, atol=atol):
                bad.append(f"CenterPoint task {t} {name}")
    result["cp_maps_max_abs_err"] = worst
    kernels.reset_launches()
    det_g = gpu.predict(vox_g.voxels, vox_g.num_points, vox_g.coords)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if not _one_k4(launches):
        bad.append(f"CenterPoint voxel predict launched {launches}")
    det_c = cpu.predict(vox_c.voxels, vox_c.num_points, vox_c.coords)
    result["cp_kept_cpu"] = int((det_c["labels"] >= 0).sum())
    result["cp_matched_share"] = _matched_share(det_g, det_c, PP_BOX_TOL,
                                                CP_SCORE_TOL)
    if result["cp_matched_share"] < CP_MATCHED_SHARE:
        bad.append("CenterPoint voxel detections, as sets")
    cut = slice(0, TTA_CHECK_POINTS)
    kernels.reset_launches()
    det_g = gpu.predict_tta_double_flip(pg[:, cut], mg[:, cut])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if not _one_k4(launches):
        bad.append(f"the TTA launched {launches}")
    det_c = cpu.predict_tta_double_flip(points[:, cut], pmask[:, cut])
    result["tta_kept_cpu"] = int((det_c["labels"] >= 0).sum())
    result["tta_matched_share"] = _matched_share(det_g, det_c, PP_BOX_TOL,
                                                 CP_SCORE_TOL)
    if result["tta_matched_share"] < CP_MATCHED_SHARE:
        bad.append("TTA detections, as sets")
    print("  f32 padded voxel path card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 padded voxel path, card vs CPU: {bad}: "
                             f"{result}")
    return result


def _voxel_train_snaps(models, batch, tx, label):
    """One train step of ``model_loss`` (the voxel ``loss``) for each of
    ``models`` {name: model} on ``batch``; the card's must launch no
    hand-written kernel. Returns (snapshots, problems)."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import model_loss
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    snaps, bad = {}, []
    for name, model in models.items():
        d = next(model.parameters()).device
        state = TrainState.create(model, tx())
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = make_train_step(model_loss)(state, {
            k: [t.to(d) for t in v] if isinstance(v, list) else v.to(d)
            for k, v in batch.items()})
        snaps[name] = _train_snapshot(state, metrics)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        print(f"  {label} {name} step {time.perf_counter() - t0:.1f} s, loss "
              f"{snaps[name]['metrics']['loss']:.6f}", flush=True)
        if name == "card" and any(launches.values()):
            bad.append(f"the {label} voxel train step launched {launches}")
        del state
    return snaps, bad


@_f32_checks
def check_voxel_train_f32(dev):
    """Phase 5r: the voxel ``loss`` of both models, one f32 train step on
    the card, on the CPU and in f64 compute on the CPU (the referee), from
    the same weights on the same voxels and targets (made on the CPU:
    ``voxelize`` and the generic anchor mask and assignment; the head's
    Gaussian targets), held as 5g holds its step (``_referee_checks``):
    PointPillars at the car config (``PP_TRAIN_TOL``, batch
    PP_CHECK_BATCH, BN off identity, AdamW 2e-4) and the single-stage
    CenterPoint of ``configs/centerpoint_pp_nusc.yaml``
    (``VOXEL_TRAIN_CP_TOL``: the head's conv biases that a train-mode BN
    cancels held as noise; batch CP_CHECK_BATCH, AdamW 1e-3 with clip 35).
    No hand-written kernel launches on either."""
    from minddet_tpu_torch.core.optim import adamw
    from minddet_tpu_torch.entry import (CLOUD_POINTS, PP_TRAIN_LR,
                                         PP_TRAIN_MAX_GT, SEED,
                                         synthetic_lidar_batch)
    from minddet_tpu_torch.models.detectors.centerpoint import CenterPoint
    from minddet_tpu_torch.ops.anchors import assign_targets_batch

    result, bad = {}, []
    gen = _seeded("5r")
    cpu = _pp_check_model(torch.float32)
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "running_var"):
                m.weight.uniform_(0.6, 1.4, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.6, 1.4, generator=gen)
    start = cpu.state_dict()
    models = {"card": _pp_check_model(torch.float32, dev), "cpu": cpu,
              "referee": _pp_check_model(torch.float64)}
    for m in (models["card"], models["referee"]):
        m.load_state_dict(start)
    raw = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        PP_CHECK_BATCH, cpu.pc_range, CLOUD_POINTS, PP_TRAIN_MAX_GT,
        num_classes=1, seed=6, num_features=4, box_dim=7).items()}
    vox = cpu.voxelize(raw["points"], raw["points_mask"])
    t = assign_targets_batch(
        cpu.anchors, raw["gt_boxes"], raw["gt_classes"], raw["gt_mask"],
        cpu.matched_threshold, cpu.unmatched_threshold,
        cpu.anchor_mask_from_coords(vox.coords))
    batch = {"voxels": vox.voxels, "num_points": vox.num_points,
             "coords": vox.coords, "anchors": cpu.anchors,
             "labels": t["labels"], "reg_targets": t["bbox_targets"]}
    result["pp_positives"] = int((t["labels"] > 0).sum())
    snaps, problems = _voxel_train_snaps(
        models, batch, lambda: adamw(PP_TRAIN_LR), "PointPillars")
    bad += problems
    _referee_checks(snaps["card"], snaps["cpu"], snaps["referee"],
                    PP_TRAIN_TOL, PP_PARTS, "pp_", result, bad)
    del models, snaps

    def cp_model(dtype, d=None):
        model = CenterPoint(dtype=dtype).init_weights(
            torch.Generator().manual_seed(SEED))
        return model.to(device=d, memory_format=torch.channels_last)

    cpu = cp_model(torch.float32)
    models = {"card": cp_model(torch.float32, dev), "cpu": cpu,
              "referee": cp_model(torch.float64)}
    raw = {k: torch.from_numpy(v) for k, v in synthetic_lidar_batch(
        CP_CHECK_BATCH, cpu.pc_range, seed=7).items()}
    vox = cpu.voxelize(raw["points"], raw["points_mask"])
    batch = {"voxels": vox.voxels, "num_points": vox.num_points,
             "coords": vox.coords, **cpu._stage1_example(raw)}
    snaps, problems = _voxel_train_snaps(
        models, batch, lambda: adamw(1e-3, clip_global_norm=35.0),
        "CenterPoint")
    bad += problems
    _referee_checks(snaps["card"], snaps["cpu"], snaps["referee"],
                    VOXEL_TRAIN_CP_TOL, ("reader.", "rpn.", "head."), "cp_",
                    result, bad)
    print("  f32 voxel loss steps card vs CPU and the referee: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 voxel loss steps: {bad}: {result}")
    return result


def voxel_serving_main_path(dev, label, programs, check, profile=True):
    """A padded (or stream) lidar serving main path, 6ap, 6ar, 6as:
    ``serve_clouds`` (ms per request, peak memory, NMS passes) with launch
    counts from 0, exactly one K4 per request and nothing else, then
    ``profile_clouds`` (device busy ms and idle share per request)."""
    from minddet_tpu_torch import kernels

    kernels.reset_launches()
    serving, predicts = serve_clouds(label, programs, dev, check)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    if launches != {k.name: predicts * int(k is kernels.ROTATED_IOU)
                    for k in kernels.KERNELS}:
        raise AssertionError(f"{label} launched {launches} for {predicts} "
                             f"requests (want one rotated_iou_intersect "
                             f"each, nothing else)")
    print(f"  kernels: rotated_iou_intersect launches="
          f"{launches['rotated_iou_intersect']} requests={predicts} "
          f"launches == requests: True", flush=True)
    return dict(serving=serving, requests=predicts, launches=launches,
                profile=profile_clouds(label, programs) if profile else None)


def pointpillars_voxel_main_path(dev):
    """Phase 6ap: ``pointpillars_voxel_entry`` (the dense branch: padded
    voxels, the generic anchor mask) at the car config, batch 1 and 8, and
    the ped_cycle config, batch 1 and 4; beside it the car's stream entry
    (``pointpillars_entry``) at batch 1 and 8."""
    from minddet_tpu_torch.entry import (PP_PED_CYCLE_CONFIG,
                                         pointpillars_entry,
                                         pointpillars_voxel_entry)

    out = {}
    for key, label, make, batches in (
            ("car", "PointPillars padded car", pointpillars_voxel_entry,
             PP_VOXEL_BATCHES),
            ("ped_cycle", "PointPillars padded ped_cycle",
             functools.partial(pointpillars_voxel_entry,
                               config=PP_PED_CYCLE_CONFIG),
             KITTI_SERVE_BATCHES),
            ("stream", "PointPillars stream car", pointpillars_entry,
             PP_VOXEL_BATCHES)):
        programs = {b: make(device=dev, batch=b) for b in batches}
        out[key] = voxel_serving_main_path(dev, label, programs,
                                           _check_pointpillars_detections)
        del programs
        torch.cuda.empty_cache()
    out["launches"] = {k: out["car"]["launches"][k]
                       + out["ped_cycle"]["launches"][k]
                       for k in out["car"]["launches"]}
    return out


def pointpillars_voxel_train_main_path(dev):
    """Phase 6aq: ``pointpillars_voxel_train_entry`` (the padded route of
    ``pointpillars_train_entry``'s step) at TRAIN_PP_BATCH, as 6l, then 6l
    itself beside it; both profiled (3 steps)."""
    from minddet_tpu_torch.entry import (pointpillars_train_entry,
                                         pointpillars_voxel_train_entry)

    out = {}
    for key, label, entry_fn in (
            ("padded", "PointPillars padded", pointpillars_voxel_train_entry),
            ("stream", "PointPillars stream", pointpillars_train_entry)):
        r, program = lidar_train_main_path(dev, label, entry_fn,
                                           TRAIN_PP_BATCH, ())
        r["profile"] = profile_train(f"{label} train batch {TRAIN_PP_BATCH}",
                                     *program)
        out[key] = r
        del program
        torch.cuda.empty_cache()
    return out


def centerpoint_voxel_main_path(dev, tta: bool):
    """Phase 6ar (``centerpoint_voxel_entry``: ``predict`` on voxels) or
    6as (``centerpoint_tta_entry``: double-flip TTA, 4 B clouds), the
    single-stage nuScenes model calibrated as 6d's, at batch 1 and 4."""
    from minddet_tpu_torch.entry import (centerpoint_tta_entry,
                                         centerpoint_voxel_entry)

    make = centerpoint_tta_entry if tta else centerpoint_voxel_entry
    programs = {b: make(device=dev, batch=b) for b in CP_BATCHES}
    for predict, clouds in programs.values():
        calibrate_centerpoint(predict.__self__, *clouds)
    return voxel_serving_main_path(
        dev, "CenterPoint TTA" if tta else "CenterPoint padded", programs,
        _check_centerpoint_detections)


def _profile(fn, calls: int):
    """``torch.profiler`` over ``calls`` warm calls of ``fn``: the device's
    busy time (union of kernel intervals) against the host clock of the
    window, the kernels with the most device time and the host's operators
    with the most self time, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels and copies, not the ranges that mark a host-side region on the
    # device's timeline (the optimizer's step)
    kevents = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kevents:
        raise RuntimeError("the profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kevents)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name = {}
    for e in kevents:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])[:10]
    return dict(calls=calls, wall_ms_per_call=wall_us / 1e3 / calls,
                device_busy_ms_per_call=busy / 1e3 / calls,
                idle_share=1 - busy / wall_us,
                kernel_launches_per_call=len(kevents) / calls,
                top_kernels=[dict(name=n, ms_per_call=t / 1e3 / calls,
                                  share_of_busy=t / busy) for n, t in top],
                top_host_ops=[dict(name=n, self_ms_per_call=t / 1e3 / calls,
                                   calls_per_call=c / calls)
                              for n, t, c in host])


def _print_profile(label: str, r) -> None:
    print(f"  profile {label}: wall {r['wall_ms_per_call']:.3f} ms/call "
          f"(profiled), device busy {r['device_busy_ms_per_call']:.3f} ms, "
          f"idle share {r['idle_share']:.3f}, "
          f"{r['kernel_launches_per_call']:.0f} kernels/call")
    for k in r["top_kernels"]:
        print(f"    {k['ms_per_call']:8.3f} ms {k['share_of_busy']:6.1%}"
              f"  {k['name'][:100]}")
    print("  host, self time per call:")
    for k in r["top_host_ops"]:
        print(f"    {k['self_ms_per_call']:8.3f} ms "
              f"{k['calls_per_call']:6.0f}x  {k['name'][:100]}")


def profile_serving(programs, requests: int = 3):
    """Where a request's time goes, per batch size."""
    result = {}
    for b, (predict, (image,)) in programs.items():
        result[f"b{b}"] = r = _profile(lambda: predict(image), requests)
        _print_profile(f"serving batch {b:2d}", r)
    return result


def profile_clouds(label, programs, requests: int = 3):
    """Where a lidar model's request's time goes, per batch size."""
    result = {}
    for b, (predict, args) in programs.items():
        result[f"b{b}"] = r = _profile(lambda: predict(*args), requests)
        _print_profile(f"{label} batch {b}", r)
    return result


def profile_train(label, step_fn, state, batch, steps: int = 3):
    """Where a train step's time goes."""
    r = _profile(lambda: step_fn(state, batch), steps)
    _print_profile(label, r)
    return r


# CenterPoint's nuScenes data, train, eval and tracking paths
# (configs/centerpoint_pp_nusc.yaml and its two-stage variant)
NUSC_EVAL_BATCH = 2      # nuscenes_evaluate's predict batch
NUSC_TRAIN_BATCH = 4     # the config's train batch
NUSC_CHECK_FRAMES = 2    # 4t: one evaluator batch a route, card and CPU
NUSC_CHECK_BATCHES = 2   # 4t: loader batches compared at one thread
NUSC_ORACLE_KEEP = 0.85  # 4t: the share of the GT the oracle detects ...
NUSC_ORACLE_FAR = 0.2    # ... and of its detections 1.5 m off the GT
NUSC_TABLE_TOL = 1e-6    # 4t: every entry of the two sides' tables
NUSC_STEP_CHECK_BATCH = 1  # 5s: one fed cloud (the config's batch 4 cut)
NUSC_STEP_CHECK_FRAMES = 4  # 5s: keyframes it is fed from
NUSC_FED_EPOCHS = 3      # 6at: epochs of fed steps, the first untimed
# 5s: a ReLU input whose sign the card and the referee set differently
# where the loss reaches it (a kink) is one rounding explains when the two
# inputs lie within KINK_BAND of the map's standard deviation of each other,
# or within HEAD_REFEREE_K times the f32 CPU's largest distance there
KINK_BAND = 1e-5
# 5s: the step held as 5r holds the same model's voxel step, a parameter
# past the per-parameter bound let through only where it lies upstream of
# such a kink, and then within CP_TRAIN_TOL's card-vs-CPU bound of the
# referee (``_referee_checks``' ``kinked``)
NUSC_STEP_TOL = dict(VOXEL_TRAIN_CP_TOL,
                     kink_grad_rel_l2=CP_TRAIN_TOL["grad_rel_l2"])
NUSC_ROUTE_KERNELS = {
    "plain": ("seg_full_max", "rotated_iou_intersect"),
    "tta": ("rotated_iou_intersect",),
    "refined": ("seg_full_max", "rotated_iou_intersect",
                "bilinear_gather_fwd")}


def _nusc_oracle(ex, rs):
    """Detections made from an example's GT (the evaluators' oracle):
    NUSC_ORACLE_KEEP of the boxes, centres +-0.3 m and NUSC_ORACLE_FAR of
    them 1.5 m farther (matches at 2 and 4 m only), sizes +-10 %,
    velocities +-0.3 m/s, headings +-0.1 rad, scores in [1, 2): ranked
    above every model detection, so the model's cannot take a GT that the
    oracle matches first."""
    gm = ex["gt_mask"]
    boxes = ex["gt_boxes"][gm].astype(np.float64)
    labels = ex["gt_classes"][gm].astype(np.int32) - 1
    keep = rs.rand(len(boxes)) < NUSC_ORACLE_KEEP
    boxes, labels = boxes[keep], labels[keep]
    n = len(boxes)
    boxes[:, :2] += rs.uniform(-0.3, 0.3, (n, 2))
    far = rs.rand(n) < NUSC_ORACLE_FAR
    ang = rs.uniform(-np.pi, np.pi, n)
    boxes[far, 0] += 1.5 * np.cos(ang[far])
    boxes[far, 1] += 1.5 * np.sin(ang[far])
    boxes[:, 3:6] *= rs.uniform(0.9, 1.1, (n, 3))
    boxes[:, 6:8] += rs.uniform(-0.3, 0.3, (n, 2))
    boxes[:, 8] += rs.uniform(-0.1, 0.1, n)
    return {"boxes": boxes.astype(np.float32),
            "scores": rs.uniform(1.0, 2.0, n).astype(np.float32),
            "labels": labels}


def _with_oracle(frames, oracle):
    """``nuscenes_detections``' frames with the oracle's detections
    appended to each."""
    return [(ex, {k: np.concatenate([det[k], o[k]]) for k in det})
            for (ex, det), o in zip(frames, oracle)]


def _nusc_pairs(got, ref, box_tol, score_atol):
    """One to one, the card detections (``got``: boxes, scores, labels of
    a frame) that match the CPU's (``ref``): same label, the first eight
    box numbers within ``box_tol`` (atol, rtol), score within
    ``score_atol``. Returns (card index or -1 for each CPU detection)."""
    atol, rtol = box_tol
    used = np.zeros(len(got["scores"]), bool)
    idx = np.full(len(ref["scores"]), -1)
    for i, (b, sc, lab) in enumerate(zip(ref["boxes"], ref["scores"],
                                         ref["labels"])):
        ok = (~used & (got["labels"] == lab)
              & (np.abs(got["boxes"][:, :8] - b[:8])
                 <= atol + rtol * np.abs(b[:8])).all(-1)
              & (np.abs(got["scores"] - sc) <= score_atol))
        if ok.any():
            idx[i] = int(np.argmax(ok))
            used[idx[i]] = True
    return idx


def _same_tracks(got, ref) -> bool:
    """The tracked scenes of two sides hold the same tracks: one relabelling
    maps the card's track ids onto the CPU's in every frame (the ids are
    numbered in each side's score order, which near-ties may swap)."""
    fwd, back = {}, {}
    for sg, sr in zip(got, ref, strict=True):
        for fg, fr in zip(sg, sr, strict=True):
            if len(fg["ids"]) != len(fr["ids"]):
                return False
            for a, b in zip(fg["ids"].tolist(), fr["ids"].tolist()):
                if fwd.setdefault(a, b) != b or back.setdefault(b, a) != a:
                    return False
    return True


def _table_diff(a, b) -> float:
    if set(a) != set(b):
        return float("inf")
    return max(abs(a[k] - b[k]) for k in a)


@_f32_checks
def check_nuscenes_f32(dev):
    """Phase 4t: CenterPoint's nuScenes path in f32 (TF32 off), card against
    CPU, on NUSC_CHECK_FRAMES keyframes of ``synthetic_nuscenes_records``
    (one scene, 120,000 of ~240,000 merged points each):

    - ``nuscenes_batches`` of the config's data section (CBGS, the GT
      database and sampler, the global augmentation) at one loader thread,
      twice: the same NUSC_CHECK_BATCHES raw batches;
    - ``nuscenes_detections`` (one evaluator batch of NUSC_EVAL_BATCH) by
      the plain, TTA and refined routes, models calibrated on the CPU
      (``calibrate_centerpoint``) and loaded on the card: the CPU's
      detections above the threshold matched one to one on the card
      (``_nusc_pairs``: at least CP_MATCHED_SHARE), the route's kernels
      launched once each;
    - the evaluators on each side's own matched detections with the same
      oracle's appended (``_nusc_oracle``): ``nuscenes_metrics`` and, on
      the plain route, ``tracking_scenes`` + ``evaluate_tracking``: every
      table entry within NUSC_TABLE_TOL, the same tracks up to their ids
      (``_same_tracks``), and mAP, NDS and AMOTA strictly between 0 and
      1."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.nuscenes import DETECTION_CLASSES
    from minddet_tpu_torch.data.nuscenes_track_eval import evaluate_tracking
    from minddet_tpu_torch.entry import (CP_CONFIG, CP_TWO_STAGE_CONFIG,
                                         NUSC_ROUTES, SEED, build_centerpoint,
                                         read_config)
    from minddet_tpu_torch.train.evaluate import (nuscenes_dataset,
                                                  nuscenes_detections,
                                                  nuscenes_metrics,
                                                  tracking_scenes)
    from minddet_tpu_torch.train.synthetic import (nuscenes_batches,
                                                   synthetic_nuscenes_records)

    result, bad = {}, []
    records = synthetic_nuscenes_records(NUSC_CHECK_FRAMES,
                                         seed=PHASE_SEEDS["4t"], scenes=1)
    data = dict(read_config(CP_CONFIG)["data"], records=records, workers=1)
    runs = []
    for _ in range(2):
        it = nuscenes_batches({"data": data}, NUSC_TRAIN_BATCH, seed=SEED)
        runs.append([next(it) for _ in range(NUSC_CHECK_BATCHES)])
        it.close()
    same = all(set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                        for k in a)
               for a, b in zip(*runs))
    result.update(batches_equal=same, batch_keys=sorted(runs[0][0]),
                  batch_boxes=int(runs[0][0]["gt_mask"].sum()))
    if not same or "gt_attrs" in runs[0][0] or "scene" in runs[0][0]:
        bad.append("nuscenes_batches at one thread")

    # a fresh dataset for each side: every example draws its subsample
    # from the dataset's generator, so each side sees the same points
    ds = nuscenes_dataset(records)
    exs = [ds[i] for i in range(len(ds))]
    # the heads calibrated on the first cloud
    points = torch.from_numpy(exs[0]["points"][None])
    pmask = torch.from_numpy(exs[0]["points_mask"][None])
    rs = np.random.RandomState(PHASE_SEEDS["4t"])
    oracle = [_nusc_oracle(e, rs) for e in exs]
    tol = {"plain": (PP_BOX_TOL, CP_SCORE_TOL),
           "tta": (PP_BOX_TOL, CP_SCORE_TOL),
           "refined": (CP_REFINED_TOL, 1e-4)}
    models = {}
    for route, flags in NUSC_ROUTES.items():
        config = CP_TWO_STAGE_CONFIG if route == "refined" else CP_CONFIG
        if config not in models:
            cpu = build_centerpoint("cpu", config)
            with torch.no_grad():
                calibrate_centerpoint(cpu, points, pmask)
            gpu = build_centerpoint(dev, config)
            gpu.load_state_dict(cpu.state_dict())
            models = {config: (cpu, gpu)}
        cpu, gpu = models[config]
        kernels.reset_launches()
        fg = nuscenes_detections(gpu, nuscenes_dataset(records), **flags)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        t0 = time.perf_counter()
        fc = nuscenes_detections(cpu, nuscenes_dataset(records), **flags)
        result[f"{route}_cpu_s"] = time.perf_counter() - t0
        if launches != _centerpoint_launches(1, NUSC_ROUTE_KERNELS[route]):
            bad.append(f"{route}: the card launched {launches}")
        pairs = [_nusc_pairs(g, c, *tol[route])
                 for (_, g), (_, c) in zip(fg, fc)]
        n_cpu = sum(len(p) for p in pairs)
        share = sum(int((p >= 0).sum()) for p in pairs) / max(n_cpu, 1)
        result[f"{route}_detections_cpu"] = n_cpu
        result[f"{route}_matched_share"] = share
        if share < CP_MATCHED_SHARE or n_cpu == 0:
            bad.append(f"{route}: detections as sets")
        # each side's own values of the matched detections, in the CPU's
        # order, and the same oracle
        own_g, own_c = [], []
        for (ex, g), (_, c), p in zip(fg, fc, pairs):
            m = p >= 0
            own_g.append((ex, {k: g[k][p[m]] for k in g}))
            own_c.append((ex, {k: c[k][m] for k in c}))
        own_g, own_c = _with_oracle(own_g, oracle), _with_oracle(own_c,
                                                                 oracle)
        tg, tc = nuscenes_metrics(own_g), nuscenes_metrics(own_c)
        result[f"{route}_table_max_abs_diff"] = _table_diff(tg, tc)
        result[f"{route}_mAP"], result[f"{route}_NDS"] = tc["mAP"], tc["NDS"]
        if result[f"{route}_table_max_abs_diff"] > NUSC_TABLE_TOL:
            bad.append(f"{route}: the detection tables")
        if not (0 < tc["mAP"] < 1 and 0 < tc["NDS"] < 1):
            bad.append(f"{route}: mAP / NDS at a bound")
        if route != "plain":
            continue
        sg, sc = tracking_scenes(own_g), tracking_scenes(own_c)
        same_tracks = _same_tracks(sg[1], sc[1])
        ag, ac = (evaluate_tracking(*sg, DETECTION_CLASSES),
                  evaluate_tracking(*sc, DETECTION_CLASSES))
        result.update(same_tracks=same_tracks,
                      tracking_table_max_abs_diff=_table_diff(ag, ac),
                      AMOTA=ac["AMOTA"], AMOTP=ac["AMOTP"], IDS=ac["IDS"])
        if not same_tracks:
            bad.append("tracks")
        if result["tracking_table_max_abs_diff"] > NUSC_TABLE_TOL:
            bad.append("the tracking tables")
        if not 0 < ac["AMOTA"] < 1:
            bad.append("AMOTA at a bound")
    del models
    print("  f32 nuScenes path card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 nuScenes path, card vs CPU: {bad}: "
                             f"{result}")
    return result


def _hook_head_relu_inputs(model):
    """Forward hooks on the CenterHead's BN layers whose output a ReLU
    takes (``shared_bn`` and each branch's ``*_bn{i}``): each stores that
    input z and, in the backward, dL/dz (0 where the ReLU is off), both
    in f64 on the CPU, under the BN's name. Returns (store, handles)."""
    store = {}

    def hook(name):
        def keep(_mod, _inp, out):
            store[name] = {"z": out.detach().double().cpu()}
            out.register_hook(lambda g: store[name].__setitem__(
                "g", g.detach().double().cpu()))
        return keep

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.head.named_modules()
               if n == "shared_bn"
               or re.fullmatch(r"task\d+\.\w+_bn\d+", n)]
    return store, handles


def _relu_kinks(relu, result, bad):
    """The head's ReLU inputs of 5s on the card and the referee
    (``_hook_head_relu_inputs``): an element where the loss reaches one
    side's ReLU and not the other's (dL/dz 0 on exactly one) is a flip.
    Rounding explains a flip when the card's z lies within the band of the
    referee's: KINK_BAND of the map's standard deviation, or HEAD_REFEREE_K
    times the f32 CPU's largest distance from the referee on that map (the
    signs differ, so the referee's |z| is smaller still); any other flip
    fails. Reports per map with flips their count, the largest |z_ref| /
    std and |z_card - z_ref| / std among them, the band, the flipped
    terms' share of |dL/dz| (L2, both sides') and the elements the loss
    reaches there (dL/dz nonzero on the referee), and over all maps the
    largest |z - z_ref| / std of the card and of the CPU and the map the
    loss reaches at the fewest elements (a loc branch: its object centres'
    neighbourhoods), where one flipped term weighs most. Returns
    the parameter names upstream of a rounding flip inside its branch (the
    branch's convs and BNs up to that ReLU; for ``shared_bn`` the shared
    conv and BN)."""
    kinked, worst, worst_cpu, flips, reached = set(), 0.0, 0.0, {}, {}
    for name, ref in relu["referee"].items():
        card = relu["card"][name]
        reached[name] = int((ref["g"] != 0).sum())
        std = float(ref["z"].std())
        gap = (card["z"] - ref["z"]).abs() / std
        cpu_gap = float((relu["cpu"][name]["z"] - ref["z"]).abs().max()) / std
        band = max(KINK_BAND, HEAD_REFEREE_K * cpu_gap)
        worst = max(worst, float(gap.max()))
        worst_cpu = max(worst_cpu, cpu_gap)
        flip = (card["g"] != 0) ^ (ref["g"] != 0)
        if not bool(flip.any()):
            continue
        share = float(torch.cat([card["g"][flip], ref["g"][flip]]).norm()
                      / ref["g"].norm().clamp_min(1e-300))
        flips[name] = dict(n=int(flip.sum()),
                           z_ref=float(ref["z"][flip].abs().max()) / std,
                           gap=float(gap[flip].max()), band=band,
                           share=share, reached=reached[name])
        if flips[name]["gap"] > band:
            bad.append(f"head.{name}: the ReLU flips where the card's input "
                       f"is {flips[name]['gap']:.2e} std from the referee's")
            continue
        m = re.fullmatch(r"(task\d+\.\w+)_bn(\d+)", name)
        stems = ([f"{m[1]}_{kind}{i}." for i in range(int(m[2]) + 1)
                  for kind in ("conv", "bn")] if m
                 else ["shared_conv.", "shared_bn."])
        kinked |= {f"head.{stem}{leaf}" for stem in stems
                   for leaf in ("weight", "bias")}
    result["relu_input_gap_max_std"] = worst
    result["relu_input_gap_max_std_cpu"] = worst_cpu
    fewest = min(reached, key=reached.get)
    result["relu_reached_fewest"] = f"{fewest} {reached[fewest]}"
    result["relu_flips"] = {n: f"{v['n']} of {v['reached']} reached, at "
                               f"|z_ref| <= {v['z_ref']:.2e} std, gap <= "
                               f"{v['gap']:.2e} std (band {v['band']:.2e}), "
                               f"{v['share']:.2e} of |dL/dz|"
                            for n, v in flips.items()}
    return kinked


def _config_step_inputs(cfg, records, batches):
    """(config, one fed raw batch, the model's arguments): ``batches``, the
    config's data path, over ``records`` at one loader thread, a batch of
    NUSC_STEP_CHECK_BATCH cloud."""
    from minddet_tpu_torch.entry import (CP_FIXED_KEYS, CP_MODEL_KEYS, SEED,
                                         _config_kwargs)

    data = dict(cfg["data"], workers=1, records=records)
    it = batches({"data": data}, NUSC_STEP_CHECK_BATCH, seed=SEED)
    raw = next(it)
    it.close()
    return cfg, raw, _config_kwargs(cfg["model"], CP_MODEL_KEYS, ("type",),
                                    CP_FIXED_KEYS, "CenterPoint")


def _nusc_step_inputs():
    """5s's ``_config_step_inputs``: ``configs/centerpoint_pp_nusc.yaml``,
    ``nuscenes_batches`` over NUSC_STEP_CHECK_FRAMES keyframes."""
    from minddet_tpu_torch.entry import CP_CONFIG, read_config
    from minddet_tpu_torch.train.synthetic import (nuscenes_batches,
                                                   synthetic_nuscenes_records)

    return _config_step_inputs(read_config(CP_CONFIG),
                               synthetic_nuscenes_records(
                                   NUSC_STEP_CHECK_FRAMES,
                                   seed=PHASE_SEEDS["5s"], scenes=1),
                               nuscenes_batches)


def _waymo_step_inputs():
    """5t's ``_config_step_inputs``: ``waymo_config()``, ``waymo_batches``
    over WAYMO_STEP_CHECK_FRAMES frames."""
    from minddet_tpu_torch.entry import waymo_config
    from minddet_tpu_torch.train.synthetic import (synthetic_waymo_records,
                                                   waymo_batches)

    return _config_step_inputs(waymo_config(), synthetic_waymo_records(
        WAYMO_STEP_CHECK_FRAMES, seed=PHASE_SEEDS["5t"]), waymo_batches)


@_f32_checks
def check_config_train_f32(dev, kind: str, inputs):
    """Phase 5s ("nuScenes") and 5t ("Waymo"): the config's train step
    (``nuscenes_optimizer``: AdamW with decay 0.01 and clip 35 under
    ``one_cycle(2e-3, 140000)`` or, for Waymo, ``one_cycle(3e-3, 280000)``,
    the NaN guard; ``loss_from_gt`` of the single-stage model) on one batch
    fed by its data path (``inputs``: ``_nusc_step_inputs`` or
    ``_waymo_step_inputs``), f32 on the card and the
    CPU and in f64 compute on the CPU (the referee), from the seeded
    weights, held as 5r holds the same model's voxel step
    (``_referee_checks`` at NUSC_STEP_TOL: the loss, its parts, grad_norm,
    the reader's, the RPN's and the head's gradients as parts and every
    parameter's gradient at most ``referee_k`` times as far from the
    referee as the f32 CPU's plus a floor, the BN statistics; a parameter
    past that bound passes only upstream of a ReLU that ``_relu_kinks``
    finds flipped by rounding, and is reported; K5f and K5b once each on
    the card); and the schedule's lr on the card at counts 0, 1, the
    peak's and the descent's equal to the plain one-cycle formula's to f32
    rounding (1e-6 relative)."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (KITTI_BATCH_KEYS, SEED,
                                         model_gt_loss, nuscenes_optimizer)
    from minddet_tpu_torch.models.detectors.centerpoint import CenterPoint
    from minddet_tpu_torch.train.loop import TrainState, make_train_step

    result, bad = {}, []
    cfg, raw, kwargs = inputs
    batch = {k: torch.from_numpy(raw[k]) for k in KITTI_BATCH_KEYS}
    result["boxes"] = int(raw["gt_mask"].sum())
    start = CenterPoint(**kwargs).init_weights(
        torch.Generator().manual_seed(SEED)).state_dict()
    snaps, relu = {}, {}
    for name, d, dtype in (("card", dev, torch.float32),
                           ("cpu", "cpu", torch.float32),
                           ("referee", "cpu", torch.float64)):
        model = CenterPoint(**kwargs, dtype=dtype).to(
            device=d, memory_format=torch.channels_last)
        model.load_state_dict(start)
        relu[name], hooks = _hook_head_relu_inputs(model)
        state = TrainState.create(model, nuscenes_optimizer(cfg))
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, metrics = make_train_step(model_gt_loss)(
            state, {k: v.to(d) for k, v in batch.items()})
        for h in hooks:
            h.remove()
        snaps[name] = _train_snapshot(state, metrics)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        print(f"  {kind} {name} step {time.perf_counter() - t0:.1f} s, "
              f"loss {snaps[name]['metrics']['loss']:.6f}", flush=True)
        if name == "card" and launches != _centerpoint_launches(
                1, ("seg_full_max", "seg_full_max_bwd")):
            bad.append(f"the {kind} train step launched {launches}")
        del state, model
    kinked = _relu_kinks(relu, result, bad)
    del relu
    _referee_checks(snaps["card"], snaps["cpu"], snaps["referee"],
                    NUSC_STEP_TOL, ("reader.", "rpn.", "head."), "", result,
                    bad, kinked=kinked)
    sched = nuscenes_optimizer(cfg).learning_rate
    lcfg = cfg["train"]["lr_schedule"]
    lr_max, total = float(lcfg["lr_max"]), int(lcfg["total_steps"])
    up = int(total * 0.4)
    low = lr_max / 10.0
    for count in (0, 1, up, total - up // 2):
        got = float(sched(torch.tensor(count, device=dev)))
        if count < up:
            want = low + (lr_max - low) * 0.5 * (
                1 - math.cos(math.pi * count / up))
        else:
            want = max(lr_max * 0.5 * (1 + math.cos(
                math.pi * (count - up) / (total - up))), low / 1e4)
        result[f"lr_{count}"] = got
        if abs(got - want) > 1e-6 * want:
            bad.append(f"one_cycle at {count}: {got} != {want}")
    print(f"  f32 {kind} train step card vs CPU and the referee: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 {kind} train step: {bad}: {result}")
    return result


def _nusc_fed_spec():
    """6at's (entry, frames, samples an epoch, batch):
    ``centerpoint_nusc_train_entry`` over NUSC_TRAIN_FRAMES keyframes,
    whose CBGS epoch it counts, at the config's batch."""
    from minddet_tpu_torch.data.nuscenes import NuScenesDetection
    from minddet_tpu_torch.entry import (CP_CONFIG, NUSC_TRAIN_FRAMES,
                                         NUSC_TRAIN_SCENES, SEED,
                                         centerpoint_nusc_train_entry,
                                         read_config)
    from minddet_tpu_torch.train.synthetic import synthetic_nuscenes_records

    samples = len(NuScenesDetection(synthetic_nuscenes_records(
        NUSC_TRAIN_FRAMES, seed=SEED, scenes=NUSC_TRAIN_SCENES), cbgs=True,
        seed=SEED))
    return (centerpoint_nusc_train_entry, NUSC_TRAIN_FRAMES, samples,
            int(read_config(CP_CONFIG)["train"]["batch_size"]))


def _waymo_fed_spec():
    """6ax's (entry, frames, samples an epoch, batch):
    ``centerpoint_waymo_train_entry`` over WAYMO_TRAIN_FRAMES frames, one
    sample each, at the config's batch."""
    from minddet_tpu_torch.entry import (WAYMO_TRAIN_FRAMES,
                                         centerpoint_waymo_train_entry)

    return (centerpoint_waymo_train_entry, WAYMO_TRAIN_FRAMES,
            WAYMO_TRAIN_FRAMES, _waymo_batch_sizes()[0])


def fed_train_main_path(dev, card, kind: str, spec):
    """Phases 6at ("nuScenes", ``_nusc_fed_spec``) and 6ax ("Waymo",
    ``_waymo_fed_spec``): the config's train step fed by its data path
    (``centerpoint_nusc_train_entry``, f32, the config's batch,
    AdamW with decay 0.01 and clip 35 under ``one_cycle``, the NaN guard;
    the in-memory keyframes, CBGS, the GT database built from them, the
    sampler, the augmentation, four loader threads; or
    ``centerpoint_waymo_train_entry``, the same over Waymo-like frames
    without CBGS), NUSC_FED_EPOCHS epochs of steps, each on the next batch,
    launch counts from 0: K5f and K5b once a step, nothing else; every loss
    finite and every step applied. The steps after the first epoch are
    timed with the wait for each next batch apart (the loader has no
    back-pressure: its first epoch runs ahead of the step): their mean,
    each timed epoch's mean, and the 10th, 50th and 90th percentiles and
    the largest of the whole step, of the wait and of the step without it;
    then the same step on one fixed batch (what the data path adds). ms on
    the host clock around synced work; peak memory."""
    from minddet_tpu_torch import kernels

    entry_fn, frames, samples, batch_size = spec
    per_epoch = samples // batch_size
    fed_steps = NUSC_FED_EPOCHS * per_epoch
    torch.zeros(1, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn, (state, batches) = entry_fn(device=dev)
    kernels.reset_launches()
    history, times, waits, first_epoch = [], [], [], []
    for i in range(fed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        if i >= per_epoch:
            times.append(time.perf_counter() - t0)
            waits.append(t1 - t0)
        else:
            first_epoch.append(time.perf_counter() - t0)
    batches.close()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    fixed = []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            fixed.append(time.perf_counter() - t0)
    applied = int(state.optimizer.param_groups[0]["count"])
    k5b_route = k5b_gradient_copies(lambda: step_fn(state, batch))
    mean_s, fixed_s = statistics.mean(times), statistics.mean(fixed)
    wait_s = statistics.mean(waits)

    def spread(xs):
        """p10, p50, p90 and the largest of ``xs`` (s), in ms."""
        q = statistics.quantiles(xs, n=10)
        return dict(p10=q[0] * 1e3, p50=q[4] * 1e3, p90=q[8] * 1e3,
                    max=max(xs) * 1e3)

    own = [t - w for t, w in zip(times, waits)]
    out = dict(batch=batch_size, frames=frames,
               steps_per_epoch=per_epoch, steps=fed_steps,
               timed_steps=len(times), ms_per_step=mean_s * 1e3,
               ms_p50=statistics.median(times) * 1e3,
               epoch_ms_per_step=[
                   statistics.mean(times[i:i + per_epoch]) * 1e3
                   for i in range(0, len(times), per_epoch)],
               step_ms=spread(times), wait_ms=spread(waits),
               step_without_wait_ms=spread(own),
               clouds_per_s=batch_size / mean_s,
               fixed_batch_ms_per_step=fixed_s * 1e3,
               data_path_ms_per_step=(mean_s - fixed_s) * 1e3,
               next_batch_ms=wait_s * 1e3,
               next_batch_ms_max=max(waits) * 1e3,
               wait_share=wait_s / mean_s,
               first_epoch_ms_per_step=statistics.mean(first_epoch) * 1e3,
               valid_boxes=int(batch["gt_mask"].sum()),
               steps_applied=applied, max_memory_allocated=peak,
               losses=[m["loss"] for m in history], launches=launches,
               k5b_route=k5b_route, card=card)
    dist = "; ".join(
        f"{k} " + " / ".join(f"{v:.1f}" for v in out[k].values())
        for k in ("step_ms", "wait_ms", "step_without_wait_ms"))
    print(f"  the {kind} config's step fed by its batches, batch "
          f"{batch_size}, epochs of {per_epoch} steps, epochs 2-"
          f"{NUSC_FED_EPOCHS} ({len(times)} steps): {out['ms_per_step']:.3f} "
          f"ms/step (by epoch " + " / ".join(
              f"{v:.3f}" for v in out["epoch_ms_per_step"]) + f"; p10 / p50 "
          f"/ p90 / max: {dist}), {out['clouds_per_s']:.1f} clouds/s, of it "
          f"the wait for the next batch {out['next_batch_ms']:.3f} ms (max "
          f"{out['next_batch_ms_max']:.3f}; {out['wait_share']:.0%}); the "
          f"first epoch {out['first_epoch_ms_per_step']:.3f} ms/step; on one "
          f"fixed batch {out['fixed_batch_ms_per_step']:.3f} ms/step, so the "
          f"data path adds {out['data_path_ms_per_step']:.3f} ms; "
          f"{out['valid_boxes']} boxes in the last batch; peak "
          f"{peak / 2 ** 30:.2f} GiB; {card}", flush=True)
    if batch["gt_mask"].shape[0] != batch_size:
        raise AssertionError(f"the {kind} batches hold "
                             f"{batch['gt_mask'].shape[0]} clouds, not the "
                             f"config's {batch_size}")
    if not all(math.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"the {kind}-fed step is not finite: "
                             f"{history}")
    if applied != fed_steps + TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"{applied} {kind} steps applied of "
                             f"{fed_steps + TRAIN_WARMUP + TRAIN_STEPS}")
    want = _centerpoint_launches(fed_steps, ("seg_full_max",
                                             "seg_full_max_bwd"))
    if launches != want:
        raise AssertionError(f"{launches} in {fed_steps} {kind} steps "
                             f"(want {want})")
    print(f"  kernels: {launches}: seg_full_max == seg_full_max_bwd == steps: "
          f"True", flush=True)
    return out


def _nusc_warm(model, ds, route):
    """Calibrate ``model`` on the dataset's first evaluator batch (as 6d's
    served model) and run the route once on it: the timed evaluation then
    starts warm. The batch comes from a fresh dataset of the same records
    (an example draws its subsample from its dataset's generator)."""
    from minddet_tpu_torch.entry import NUSC_ROUTES
    from minddet_tpu_torch.train.evaluate import (nuscenes_dataset,
                                                  nuscenes_route)

    dev = next(model.parameters()).device
    fresh = nuscenes_dataset(ds.records)
    exs = [fresh[i] for i in range(NUSC_EVAL_BATCH)]
    points = torch.from_numpy(np.stack([e["points"] for e in exs])).to(dev)
    pmask = torch.from_numpy(np.stack([e["points_mask"]
                                       for e in exs])).to(dev)
    with torch.no_grad():
        calibrate_centerpoint(model, points, pmask)
    nuscenes_route(model, **NUSC_ROUTES[route])(points, pmask)
    torch.cuda.synchronize()


def _per_frame(timings, frames):
    return {k: v / frames * 1e3 for k, v in timings.items()}


def nuscenes_eval_main_path(dev, card):
    """Phase 6au: ``centerpoint_nusc_eval_entry`` by each route (the plain
    single-stage model, its double-flip TTA, the two-stage model's
    ``predict_refined``): ``nuscenes_evaluate`` over the entry's
    NUSC_EVAL_FRAMES keyframes at the reference's protocol, the model
    calibrated and warmed on the first batch (``_nusc_warm``), launch
    counts from 0: the route's kernels once per batch, nothing else; ms per
    frame split into load, copy, predict and the host's evaluator; the
    metrics finite."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (NUSC_ROUTES,
                                         centerpoint_nusc_eval_entry)

    out, launches = {}, None
    for route in NUSC_ROUTES:
        evaluate_fn, (model, ds) = centerpoint_nusc_eval_entry(dev, route)
        _nusc_warm(model, ds, route)
        kernels.reset_launches()
        timings = {}
        t0 = time.perf_counter()
        stats = evaluate_fn(model, ds, timings=timings)
        wall = time.perf_counter() - t0
        got = {k.name: k.launches for k in kernels.KERNELS}
        batches = -(-len(ds) // NUSC_EVAL_BATCH)
        want = _centerpoint_launches(batches, NUSC_ROUTE_KERNELS[route])
        r = dict(frames=len(ds), batches=batches,
                 ms_per_frame=wall / len(ds) * 1e3,
                 parts_ms_per_frame=_per_frame(timings, len(ds)),
                 stats=stats, launches=got, card=card)
        out[route] = r
        print(f"  nuscenes_evaluate {route}: {r['ms_per_frame']:.3f} ms/frame"
              f" over {len(ds)} frames (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["parts_ms_per_frame"].items())
              + f"); mAP {stats['mAP']:.4f} NDS {stats['NDS']:.4f}; {card}",
              flush=True)
        if not all(math.isfinite(v) for v in stats.values()):
            raise AssertionError(f"nuscenes_evaluate {route}: {stats}")
        if got != want:
            raise AssertionError(f"nuscenes_evaluate {route} launched {got} "
                                 f"for {batches} batches (want {want})")
        launches = got if launches is None else {
            k: launches[k] + v for k, v in got.items()}
        del model, ds
        torch.cuda.empty_cache()
    out["launches"] = launches
    print(f"  kernels: {launches}: each route's once per batch: True",
          flush=True)
    return out


def nuscenes_tracking_main_path(dev, card):
    """Phase 6av: ``centerpoint_nusc_tracking_entry``:
    ``nuscenes_tracking_evaluate`` over one scene of NUSC_TRACK_FRAMES
    keyframes (a 20 s nuScenes scene), the model calibrated and warmed on
    the first batch, launch counts from 0: K5f and K4 once per batch,
    nothing else; ms per frame split into load, copy, predict, the tracker
    (with the moves to the global frame) and the tracking protocol; the
    detections a frame; the metrics finite."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import centerpoint_nusc_tracking_entry

    evaluate_fn, (model, ds) = centerpoint_nusc_tracking_entry(dev)
    _nusc_warm(model, ds, "plain")
    kernels.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    stats = evaluate_fn(model, ds, timings=timings)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    batches = -(-len(ds) // NUSC_EVAL_BATCH)
    want = _centerpoint_launches(batches, NUSC_ROUTE_KERNELS["plain"])
    out = dict(frames=len(ds), batches=batches,
               ms_per_frame=wall / len(ds) * 1e3,
               parts_ms_per_frame=_per_frame(timings, len(ds)),
               stats=stats, launches=launches, card=card)
    print(f"  nuscenes_tracking_evaluate: {out['ms_per_frame']:.3f} ms/frame "
          f"over {len(ds)} frames of one scene (" + ", ".join(
              f"{k} {v:.3f}" for k, v in out["parts_ms_per_frame"].items())
          + f"); AMOTA {stats['AMOTA']:.4f} AMOTP {stats['AMOTP']:.4f} IDS "
          f"{stats['IDS']}; {card}", flush=True)
    if not all(math.isfinite(v) for v in stats.values()):
        raise AssertionError(f"nuscenes_tracking_evaluate: {stats}")
    if launches != want:
        raise AssertionError(f"nuscenes_tracking_evaluate launched "
                             f"{launches} for {batches} batches (want "
                             f"{want})")
    print(f"  kernels: {launches}: seg_full_max == rotated_iou_intersect == "
          f"batches: True", flush=True)
    return out


# CenterPoint's Waymo data, train and eval paths (``entry.waymo_config``:
# configs/centerpoint_pp_waymo.yaml at +-76.8 m and 480 x 480)
WAYMO_SERVE_BATCHES = (1, 4)  # 6aw
WAYMO_NMS_POST = 83      # detections kept by the one task
WAYMO_CHECK_FRAMES = 4   # 4w: frames of one loader batch; the first two ...
WAYMO_CHECK_EVAL = 2     # ... one evaluator batch a route, card and CPU
WAYMO_CHECK_BATCHES = 2  # 4w: loader batches compared at one thread
WAYMO_ORACLE_KEEP = 0.85  # 4w: the share of the GT the oracle detects ...
WAYMO_ORACLE_FAR = 0.2   # ... and of its detections 1.5 m off (no match)
WAYMO_TABLE_TOL = 1e-6   # 4w: every entry of the two sides' tables
WAYMO_STEP_CHECK_FRAMES = 4  # 5t: frames the one fed cloud is drawn from
WAYMO_ROUTE_KERNELS = {
    "plain": ("seg_full_max", "rotated_iou_intersect"),
    "refined": ("seg_full_max", "rotated_iou_intersect",
                "bilinear_gather_fwd")}
_WAYMO_CLOUDS: dict = {}


def _waymo_batch_sizes():
    """(the Waymo config's train batch, ``waymo_evaluate``'s predict
    batch), read where they are set."""
    from minddet_tpu_torch.entry import waymo_config
    from minddet_tpu_torch.train.evaluate import WAYMO_EVAL_BATCH

    return int(waymo_config()["train"]["batch_size"]), WAYMO_EVAL_BATCH


def _waymo_clouds(model, batch: int, seed: int, dev):
    """``batch`` Waymo-like frames as the Waymo paths feed them
    (``entry.waymo_clouds``: 160,000 of 160,000-180,000 returns), on
    ``dev``; drawn once per batch size (``model`` and ``seed`` are
    ``_nusc_clouds``' arguments, which the frames do not depend on)."""
    from minddet_tpu_torch.entry import SEED, waymo_clouds

    if batch not in _WAYMO_CLOUDS:
        _WAYMO_CLOUDS[batch] = waymo_clouds(batch, "cpu", seed=SEED + 10
                                            + batch)
    return tuple(t.to(dev) for t in _WAYMO_CLOUDS[batch])


def waymo_candidate_boxes(b: int, n: int, gen) -> torch.Tensor:
    """(b, n, 5) BEV boxes drawn as ``candidate_boxes`` draws them, their
    centres moved from KITTI's range (x 0-69.12 m, y +-39.68 m) onto the
    Waymo model's +-76.8 m in both axes."""
    boxes = candidate_boxes(b, n, gen)
    boxes[..., 0] = (boxes[..., 0] - 34.56) * (76.8 / 34.56)
    boxes[..., 1] = boxes[..., 1] * (76.8 / 39.68)
    return boxes


def waymo_eval_frame_boxes(seed: int = 18):
    """One of ``evaluate_waymo``'s IoU calls: the BEV slices that
    ``rotated_iou_3d`` gives K4 for the vehicles of one
    ``synthetic_waymo_records`` frame, (1, WAYMO_NMS_POST, 5) detections
    (the plain route's kept slots: the GT moved by up to 0.3 m and turned
    by up to 0.1 rad, the rest vehicles anywhere within 75 m) against the
    (1, m, 5) GT, on the CPU."""
    from minddet_tpu_torch.train.synthetic import synthetic_waymo_records

    rec = synthetic_waymo_records(1, seed=seed)[0]
    gt = rec["gt_boxes"][rec["gt_classes"] == 1][:, [0, 1, 3, 4, 6]]
    rs = np.random.RandomState(seed)
    det = np.zeros((WAYMO_NMS_POST, 5), np.float32)
    k = min(len(gt), WAYMO_NMS_POST)
    det[:k] = gt[:k]
    det[:k, :2] += rs.uniform(-0.3, 0.3, (k, 2))
    det[:k, 4] += rs.uniform(-0.1, 0.1, k)
    rest = WAYMO_NMS_POST - k
    r, a = 75.0 * np.sqrt(rs.rand(rest)), rs.uniform(-np.pi, np.pi, rest)
    det[k:] = np.stack([r * np.cos(a), r * np.sin(a),
                        rs.uniform(1.8, 2.4, rest), rs.uniform(4.2, 5.4, rest),
                        rs.uniform(-np.pi, np.pi, rest)], -1)
    return torch.from_numpy(det)[None], torch.from_numpy(gt.copy())[None]


def check_waymo_kernels(dev):
    """Phase 3's cases at the Waymo paths' shapes, on the two-stage model
    of ``waymo_config(two_stage=True)`` (the plain model's geometry, 480 x
    480, one task): K4 at the serving NMS's (B, 1000, 5)^2, B = 1 and 4,
    and the evaluation's (2, 1000, 5)^2 on ``waymo_candidate_boxes``, and
    at one of the evaluator's IoU calls (``waymo_eval_frame_boxes``); K5f
    in f32 at (B, 160000, 32), B = 1, 2 and 4 (serving, the evaluation,
    the train step) and K5b at the train step's B = 4, also on the strided
    g the PFN's cat hands it, on the voxelizer's streams of Waymo-like
    frames (``_waymo_clouds``); K3f at the refined route's (2, 120 * 120,
    384) x 5 * 83 points, ``grid_sample`` beside it. Returns the cases by
    kernel name; every case's ``stream`` or ``kind`` names Waymo."""
    from minddet_tpu_torch.entry import build_centerpoint, waymo_config

    train_batch, eval_batch = _waymo_batch_sizes()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    model = build_centerpoint(dev, waymo_config(two_stage=True))
    iou = []
    for kind, b in [("waymo_serve", b) for b in WAYMO_SERVE_BATCHES] + [
            ("waymo_eval", eval_batch)]:
        boxes = waymo_candidate_boxes(b, CP_CANDIDATES, torch.Generator(
        ).manual_seed(20 + b)).to(dev)
        iou.append(_iou_case(kind, boxes, boxes, sms))
    dets, gts = (t.to(dev) for t in waymo_eval_frame_boxes())
    iou.append(_iou_case("waymo_eval_frame", dets, gts, sms))
    seg = check_seg_max_kernel(
        dev, model, tuple((b, torch.float32, PFN_HALF_WIDTH) for b in (
            1, eval_batch, train_batch)), _waymo_clouds, "waymo")
    seg_bwd = check_seg_max_bwd_kernel(
        dev, model, ((train_batch, torch.float32, "waymo",
                      PFN_HALF_WIDTH),
                     (train_batch, torch.float32, "waymo, strided g",
                      PFN_HALF_WIDTH)), _waymo_clouds)
    gather = check_bilinear_kernel(dev, None, model, (
        (eval_batch, WAYMO_NMS_POST, torch.Generator().manual_seed(19)),
    ))
    for c in gather:
        c["stream"] = "waymo refined"
    _WAYMO_CLOUDS.clear()
    del model
    torch.cuda.empty_cache()
    return {"rotated_iou_intersect": iou, "seg_full_max": seg,
            "seg_full_max_bwd": seg_bwd, "bilinear_gather_fwd": gather}


def _waymo_oracle(gt, rs):
    """Detections made from a frame's GT anno (the evaluator's oracle), in
    ``evaluate_waymo``'s layout: WAYMO_ORACLE_KEEP of the boxes, centres
    +-0.05 m and headings +-0.05 rad off (IoU ~0.9 and up: a match at every
    class's threshold), WAYMO_ORACLE_FAR of them 1.5 m off instead (below
    every threshold), scores in [1, 2): ranked above every model
    detection, so that the model's cannot take a GT that the oracle
    matches first."""
    keep = rs.rand(len(gt["boxes"])) < WAYMO_ORACLE_KEEP
    boxes = gt["boxes"][keep].astype(np.float64)
    n = len(boxes)
    boxes[:, :2] += rs.uniform(-0.05, 0.05, (n, 2))
    far = rs.rand(n) < WAYMO_ORACLE_FAR
    ang = rs.uniform(-np.pi, np.pi, n)
    boxes[far, 0] += 1.5 * np.cos(ang[far])
    boxes[far, 1] += 1.5 * np.sin(ang[far])
    boxes[:, 6] += rs.uniform(-0.05, 0.05, n)
    return {"boxes": boxes, "classes": gt["classes"][keep].astype(np.int64),
            "scores": rs.uniform(1.0, 2.0, n)}


def _waymo_iou_calls(gt_annos, dt_annos, breakdowns: bool) -> int:
    """The K4 launches ``evaluate_waymo`` makes on a card for these annos
    (1-based ids): one per class, range shard, level and frame where the
    shard holds both GT and detections of the class."""
    from minddet_tpu_torch.data.waymo_eval import RANGE_BUCKETS, _bev_range

    shards = [None] + (list(RANGE_BUCKETS) if breakdowns else [])
    calls = 0
    for cls in range(1, 4):
        for rng in shards:
            for g, d in zip(gt_annos, dt_annos):
                gb = g["boxes"][g["classes"] == cls]
                db = d["boxes"][d["classes"] == cls]
                if rng is not None:
                    gb = gb[(_bev_range(gb) >= rng[0])
                            & (_bev_range(gb) < rng[1])]
                    db = db[(_bev_range(db) >= rng[0])
                            & (_bev_range(db) < rng[1])]
                calls += 2 * int(len(gb) > 0 and len(db) > 0)
    return calls


def _as_labels(d):
    """A detection anno as ``_nusc_pairs`` reads it (labels for classes)."""
    return {"boxes": d["boxes"], "scores": d["scores"],
            "labels": d["classes"]}


@_f32_checks
def check_waymo_f32(dev):
    """Phase 4w: CenterPoint's Waymo path in f32 (TF32 off), card against
    CPU, on ``synthetic_waymo_records`` (the 160,000 points the dataset
    keeps of each frame):

    - ``waymo_batches`` of the config's data section (the GT database and
      sampler, the global augmentation) over WAYMO_CHECK_FRAMES frames at
      one loader thread, twice: the same WAYMO_CHECK_BATCHES raw batches
      (the host's; the card sees them as copies);
    - ``waymo_annos`` of the first WAYMO_CHECK_EVAL frames (one evaluator
      batch) by the plain and refined routes, models at ``waymo_config``
      calibrated on the CPU (``calibrate_centerpoint``) and loaded on the
      card: the same GT annos, the CPU's detections matched one to one on
      the card (``_nusc_pairs``: at least CP_MATCHED_SHARE), the route's
      kernels launched once each;
    - ``evaluate_waymo`` with the range breakdowns on each side's own
      matched detections with the same oracle's appended
      (``_waymo_oracle``), its IoUs on the card (K4 once per call that
      ``_waymo_iou_calls`` counts) and on the CPU: every table entry
      within WAYMO_TABLE_TOL, and the AP inside (0, 100)."""
    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.data.waymo_eval import evaluate_waymo
    from minddet_tpu_torch.entry import (SEED, WAYMO_ROUTES,
                                         build_centerpoint, waymo_config)
    from minddet_tpu_torch.train.evaluate import (WAYMO_EVAL_NAMES,
                                                  waymo_annos, waymo_dataset)
    from minddet_tpu_torch.train.synthetic import (synthetic_waymo_records,
                                                   waymo_batches)

    result, bad = {}, []
    train_batch, _ = _waymo_batch_sizes()
    records = synthetic_waymo_records(WAYMO_CHECK_FRAMES,
                                      seed=PHASE_SEEDS["4w"])
    data = dict(waymo_config()["data"], records=records, workers=1)
    runs = []
    for _ in range(2):
        it = waymo_batches({"data": data}, train_batch, seed=SEED)
        runs.append([next(it) for _ in range(WAYMO_CHECK_BATCHES)])
        it.close()
    same = all(set(a) == set(b) and all(np.array_equal(a[k], b[k])
                                        for k in a)
               for a, b in zip(*runs))
    result.update(batches_equal=same, batch_keys=sorted(runs[0][0]),
                  batch_boxes=int(runs[0][0]["gt_mask"].sum()))
    if not same or "gt_num_points" in runs[0][0]:
        bad.append("waymo_batches at one thread")

    records = records[:WAYMO_CHECK_EVAL]
    ds = waymo_dataset(records)
    exs = [ds[i] for i in range(len(ds))]
    points = torch.from_numpy(exs[0]["points"][None])
    pmask = torch.from_numpy(exs[0]["points_mask"][None])
    tol = {"plain": (PP_BOX_TOL, CP_SCORE_TOL),
           "refined": (CP_REFINED_TOL, 1e-4)}
    rs = np.random.RandomState(PHASE_SEEDS["4w"])
    oracle = None
    for route, flags in WAYMO_ROUTES.items():
        cpu = build_centerpoint("cpu", waymo_config(route == "refined"))
        with torch.no_grad():
            calibrate_centerpoint(cpu, points, pmask)
        gpu = build_centerpoint(dev, waymo_config(route == "refined"))
        gpu.load_state_dict(cpu.state_dict())
        kernels.reset_launches()
        gt_g, dt_g = waymo_annos(gpu, waymo_dataset(records), **flags)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        t0 = time.perf_counter()
        gt_c, dt_c = waymo_annos(cpu, waymo_dataset(records), **flags)
        result[f"{route}_cpu_s"] = time.perf_counter() - t0
        del cpu, gpu
        if launches != _centerpoint_launches(1, WAYMO_ROUTE_KERNELS[route]):
            bad.append(f"{route}: the card launched {launches}")
        if not all(all(np.array_equal(a[k], b[k]) for k in b)
                   for a, b in zip(gt_g, gt_c)):
            bad.append(f"{route}: the GT annos")
        pairs = [_nusc_pairs(_as_labels(g), _as_labels(c), *tol[route])
                 for g, c in zip(dt_g, dt_c)]
        n_cpu = sum(len(p) for p in pairs)
        share = sum(int((p >= 0).sum()) for p in pairs) / max(n_cpu, 1)
        result[f"{route}_detections_cpu"] = n_cpu
        result[f"{route}_matched_share"] = share
        if share < CP_MATCHED_SHARE or n_cpu == 0:
            bad.append(f"{route}: detections as sets")
        if oracle is None:
            oracle = [_waymo_oracle(g, rs) for g in gt_c]
        own_g, own_c = [], []
        for g, c, p, o in zip(dt_g, dt_c, pairs, oracle):
            m = p >= 0
            own_g.append({k: np.concatenate([g[k][p[m]], o[k]]) for k in o})
            own_c.append({k: np.concatenate([c[k][m], o[k]]) for k in o})
        kernels.reset_launches()
        tg = evaluate_waymo(gt_g, own_g, WAYMO_EVAL_NAMES, True, device=dev)
        calls = kernels.ROTATED_IOU.launches
        tc = evaluate_waymo(gt_c, own_c, WAYMO_EVAL_NAMES, True)
        want = _waymo_iou_calls(gt_g, own_g, True)
        result[f"{route}_evaluator_launches"] = calls
        if calls != want:
            bad.append(f"{route}: the evaluator launched K4 {calls} times "
                       f"(want {want})")
        diff = max(_table_diff(tg[k], tc[k]) for k in tc)
        result[f"{route}_table_max_abs_diff"] = diff
        result[f"{route}_AP_L1"] = {k: tc[k]["AP_L1"] for k in tc}
        if diff > WAYMO_TABLE_TOL:
            bad.append(f"{route}: the tables")
        if not all(0 < tc[k]["AP_L1"] < 100 for k in tc):
            bad.append(f"{route}: an AP at a bound")
    print("  f32 Waymo path card vs CPU: " + " ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
        for k, v in result.items()), flush=True)
    if bad:
        raise AssertionError(f"f32 Waymo path, card vs CPU: {bad}: "
                             f"{result}")
    return result


def _check_waymo_detections(det, b):
    """Detections of the calibrated Waymo model: (b, 83) slots, all filled
    (1000 valid candidates), labels of the three classes, scores in (0,
    1], positive sizes, zero velocities' slots finite."""
    boxes, scores, labels = det["boxes"], det["scores"], det["labels"]
    kept = labels >= 0
    ok = (boxes.shape == (b, WAYMO_NMS_POST, 9)
          and scores.shape == (b, WAYMO_NMS_POST)
          and bool(torch.isfinite(boxes).all())
          and bool(torch.isfinite(scores).all())
          and bool(kept.all()) and bool((labels <= 2).all())
          and bool((scores > 0).all()) and bool((scores <= 1).all())
          and bool((boxes[..., 3:6] > 0).all()))
    if not ok:
        raise AssertionError(f"Waymo CenterPoint predict at batch {b}: boxes "
                             f"{tuple(boxes.shape)}, kept "
                             f"{kept.sum(1).tolist()}, finite "
                             f"{bool(torch.isfinite(boxes).all())}")


def waymo_eval_main_path(dev, card):
    """Phase 6ay: ``centerpoint_waymo_eval_entry`` by each route (the plain
    model's ``predict_from_points``, the two-stage model's
    ``predict_refined``): ``waymo_evaluate`` over the entry's
    WAYMO_EVAL_FRAMES frames at the reference's protocol, the model
    calibrated and warmed on the first batch, launch counts from 0: the
    route's kernels once per batch and K4 once more per call of the
    evaluator's IoU (``_waymo_iou_calls`` on the annos it was given, read
    by a spy that passes the call on),
    nothing else; ms per frame split into load, copy, predict and the
    host's protocol (evaluate: the IoUs on the card and the matching); the
    table finite."""
    from unittest import mock

    from minddet_tpu_torch import kernels
    from minddet_tpu_torch.entry import (WAYMO_ROUTES,
                                         centerpoint_waymo_eval_entry)
    from minddet_tpu_torch.train import evaluate as ev
    from minddet_tpu_torch.train.evaluate import WAYMO_EVAL_BATCH

    out, launches = {}, None
    for route in WAYMO_ROUTES:
        evaluate_fn, (model, ds) = centerpoint_waymo_eval_entry(dev, route)
        fresh = ev.waymo_dataset(ds.records)
        exs = [fresh[i] for i in range(WAYMO_EVAL_BATCH)]
        points, pmask = (torch.from_numpy(np.stack([e[k] for e in exs])).to(
            dev) for k in ("points", "points_mask"))
        with torch.no_grad():
            calibrate_centerpoint(model, points, pmask)
        ev.nuscenes_route(model, refined=route == "refined")(points, pmask)
        torch.cuda.synchronize()
        kernels.reset_launches()
        timings = {}
        t0 = time.perf_counter()
        with mock.patch.object(ev, "evaluate_waymo",
                               wraps=ev.evaluate_waymo) as spy:
            table = evaluate_fn(model, ds, timings=timings)
        wall = time.perf_counter() - t0
        got = {k.name: k.launches for k in kernels.KERNELS}
        batches = -(-len(ds) // WAYMO_EVAL_BATCH)
        (gt_annos, dt_annos), _ = spy.call_args
        calls = _waymo_iou_calls(gt_annos, dt_annos, False)
        want = _centerpoint_launches(batches, WAYMO_ROUTE_KERNELS[route])
        want["rotated_iou_intersect"] += calls
        r = dict(frames=len(ds), batches=batches, evaluator_launches=calls,
                 ms_per_frame=wall / len(ds) * 1e3,
                 parts_ms_per_frame=_per_frame(timings, len(ds)),
                 detections_per_frame=statistics.mean(
                     len(d["scores"]) for d in dt_annos),
                 table=table, launches=got, card=card)
        out[route] = r
        print(f"  waymo_evaluate {route}: {r['ms_per_frame']:.3f} ms/frame "
              f"over {len(ds)} frames (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["parts_ms_per_frame"].items())
              + f"); {r['detections_per_frame']:.1f} detections a frame, "
              f"{calls} IoU calls of the evaluator; AP_L1 " + " / ".join(
                  f"{t['AP_L1']:.3f}" for t in table.values())
              + f"; {card}", flush=True)
        if not all(math.isfinite(v) for t in table.values()
                   for v in t.values()):
            raise AssertionError(f"waymo_evaluate {route}: {table}")
        if got != want:
            raise AssertionError(f"waymo_evaluate {route} launched {got} for "
                                 f"{batches} batches and {calls} evaluator "
                                 f"calls (want {want})")
        launches = got if launches is None else {
            k: launches[k] + v for k, v in got.items()}
        del model, ds
        torch.cuda.empty_cache()
    out["launches"] = launches
    print(f"  kernels: {launches}: each route's once per batch, K4 also once "
          f"per evaluator call: True", flush=True)
    return out


class PhaseClock:
    """Every phase's seconds on the host clock: ``start(name, text)`` ends
    the phase before it (its seconds printed beside the card and kept in
    ``seconds``) and prints the new phase's header with the seconds since
    ``t_start``; ``stop()`` ends the last."""

    def __init__(self, t_start: float):
        self.t_start, self.card = t_start, ""
        self.seconds: dict = {}
        self.name = self.t = None

    def start(self, name: str, text: str) -> None:
        self.stop()
        self.name, self.t = name, time.perf_counter()
        print(f"phase {name}: {text} [at {self.t - self.t_start:.1f} s]",
              flush=True)

    def stop(self) -> None:
        if self.name is None:
            return
        self.seconds[self.name] = time.perf_counter() - self.t
        print(f"  phase {self.name}: {self.seconds[self.name]:.1f} s on "
              f"{self.card}", flush=True)
        self.name = None


def _kernel_row(kernel, launches, main_cases, calls_per_shape, cases,
                library: bool = False):
    """One kernel's entry of the ``{"kernels": [...]}`` line: times and
    bounds summed over ``main_cases``, the kernel's calls in one pass of
    each main path that launches it (one request at the largest batch, one
    train step), and ``main_shapes`` with the same numbers case by case;
    ``library`` where the cases timed one PyTorch call beside the kernel."""
    from minddet_tpu_torch import kernels

    if not main_cases:
        raise AssertionError(f"{kernel.name}: no phase 3 case at a main "
                             f"path's shape")
    tot = lambda key: calls_per_shape * sum(c[key] for c in main_cases)
    keys = ("kind", "shape", "out_hw", "against", "points", "samples",
            "dtype", "spread", "tile_rows", "stream", "stride",
            "max_abs_err", "ms", "warp_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "grid_sample_ms",
            "k3f_route_ms", "route_max_abs_diff", "fallback_share",
            "repeat", "route_ms", "empty_tile_share")
    return dict(
        main_shapes=[{k: c[k] for k in keys if k in c} for c in main_cases],
        name=kernel.name, route="cuda",
        source=str(kernel.source.relative_to(kernels.CSRC.parent.parent)),
        replaces=kernel.replaces.split()[0], launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
        bound_by="bytes" if all(c["bound_by"] == "bytes"
                                for c in main_cases) else "operations",
        library_ms=tot("library_ms") if library else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--probe", action="store_true",
                    help="also compare the f32 CenterPoint train-mode "
                         "forward layer by layer, card and CPU, with the "
                         "CPU's in f64")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving requests of every "
                         "served model and 3 train steps of each trained "
                         "model (torch.profiler)")
    ap.add_argument("--seeds", type=int, default=0, metavar="N",
                    help="also read phases 4 and 4d on N random models "
                         "each, ungated: the card's and the f32 CPU's "
                         "distances from the f64 referee")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    from minddet_tpu_torch import kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    clock = PhaseClock(t_start)
    clock.start("1", "card")
    card = _card()
    clock.card = card
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}",
          flush=True)

    clock.start("2", "build")
    t0 = time.perf_counter()
    logs = kernels.build_all(kernels.KERNELS)
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  built {len(logs)} kernel(s) in {build_s:.1f} s", flush=True)

    clock.start("3", "kernels vs plain versions")
    cases = check_taps_kernel(dev, gen)
    bwd_cases = check_taps_bwd_kernel(dev, gen)
    flat_cases = check_flat_kernel(dev, gen)
    flat_bwd_cases = check_flat_bwd_kernel(dev, gen)
    bias_rounding = check_dcn_bias_rounding(dev)
    torch.cuda.empty_cache()
    from minddet_tpu_torch.entry import build_centerpoint

    centerpoint = build_centerpoint(dev)
    iou_cases = check_rotated_iou_kernel(dev, gen, centerpoint.pc_range)
    seg_cases = check_seg_max_kernel(dev, centerpoint)
    # pillars at the point cap, ties and signed zeros: no main path's shape
    seg_cases += check_seg_max_kernel(
        dev, centerpoint, ((1, torch.float32, PFN_HALF_WIDTH),),
        _clustered_clouds, "clustered, ties", clustered_values)
    gather_cases = check_bilinear_kernel(dev, gen, centerpoint)
    seg_bwd_cases = check_seg_max_bwd_kernel(dev, centerpoint)
    gather_dx_cases, gather_dcw_cases = check_bilinear_bwd_kernels(
        dev, gen, centerpoint)
    for got, more in zip((gather_cases, gather_dx_cases, gather_dcw_cases),
                         check_bilinear_narrow(dev)):
        got.extend(more)
    gather_cases.extend(check_rcnn_gather(dev))
    torch.cuda.empty_cache()
    rcnn_train_fwd, rcnn_train_dx = check_rcnn_train_gather(dev)
    gather_cases.extend(rcnn_train_fwd)
    gather_dx_cases.extend(rcnn_train_dx)
    gather_cases.extend(check_rcnn_mask_crop(dev))
    torch.cuda.empty_cache()
    warp_cases = check_coco_warp(dev, card)
    waymo_cases = check_waymo_kernels(dev)

    referee_ratios = None
    if args.seeds:
        print(f"seeds: phases 4 and 4d on {args.seeds} models each, "
              f"ungated", flush=True)
        referee_ratios = referee_ratio_sweep(dev, args.seeds)
    clock.start("4", "end to end, f32 predict, card vs CPU and the f64 "
                     "referee")
    e2e = check_end_to_end_f32(dev, _seeded("4"))
    clock.start("4b", "end to end, f32 PointPillars predict, card vs CPU")
    pp_f32 = check_pointpillars_f32(dev)
    clock.start("4c", "end to end, f32 two-stage CenterPoint predict, card vs "
                      "CPU")
    cp_f32 = check_centerpoint_f32(dev, centerpoint)
    clock.start("4d", "end to end, f32 predict with DCN in all four backbone "
                      "stages, card vs CPU and the f64 referee")
    e2e_dcn4 = check_end_to_end_f32(dev, _seeded("4d"), dcn4=True)
    clock.start("4e", "end to end, f32 Faster R-CNN predict, card vs CPU and "
                      "the f64 referee")
    rcnn_f32 = check_rcnn_f32(dev, False, _seeded("4e"))
    clock.start("4f", "end to end, f32 Mask R-CNN predict, card vs CPU and "
                      "the f64 referee")
    mask_rcnn_f32 = check_rcnn_f32(dev, True, _seeded("4f"))
    torch.cuda.empty_cache()
    yolo_f32 = {}
    for kind, spec in yolo_models().items():
        phase = spec["phases"][0]
        clock.start(phase, f"end to end, f32 {spec['label']} predict, card "
                           f"vs CPU and the f64 referee")
        yolo_f32[kind] = check_yolo_f32(dev, _seeded(phase), kind)
        torch.cuda.empty_cache()
    seg_f32 = {}
    for kind, spec in seg_models().items():
        phase = spec["phases"][0]
        clock.start(phase, f"end to end, f32 {spec['label']} predict, card "
                           f"vs CPU and the f64 referee")
        seg_f32[kind] = check_seg_f32(dev, _seeded(phase), kind)
        torch.cuda.empty_cache()
    clock.start("4q", "the f32 COCO eval and train data path, card vs CPU")
    coco_f32 = check_coco_f32(dev, _seeded("4q"))
    torch.cuda.empty_cache()
    clock.start("4r", "the f32 KITTI eval path (car config), card vs CPU")
    kitti_f32 = check_kitti_f32(dev)
    torch.cuda.empty_cache()
    clock.start("4s", "the f32 padded voxel path (PointPillars, CenterPoint, "
                      "the TTA), card vs CPU")
    voxel_f32 = check_voxel_path_f32(dev)
    torch.cuda.empty_cache()
    clock.start("4t", "the f32 nuScenes data, eval and tracking path "
                      "(plain, TTA, refined), card vs CPU")
    nusc_f32 = check_nuscenes_f32(dev)
    torch.cuda.empty_cache()
    clock.start("4w", "the f32 Waymo data and eval path (plain, refined), "
                      "card vs CPU")
    waymo_f32 = check_waymo_f32(dev)
    torch.cuda.empty_cache()

    clock.start("5", "end to end, f32 train step, card vs CPU and the f64 "
                     "referee")
    train_f32 = check_train_step_f32(dev, _seeded("5"), res=CHECK_RES)
    clock.start("5b", "bilinear_sample_2d gradients, card vs CPU")
    sample_grads = check_sample_grads_f32(dev, _seeded("5b"), centerpoint)
    clock.start("5c", "end to end, f32 two-stage CenterPoint train step, card "
                      "vs CPU")
    cp_train_f32 = check_centerpoint_train_f32(dev, centerpoint)
    del centerpoint
    clock.start("5d", f"end to end, f32 train step with DCN in all four "
                      f"backbone stages at {CHECK_RES_DCN4}x{CHECK_RES_DCN4}, "
                      f"card vs the f64 referee")
    train_f32_dcn4 = check_train_step_f32(dev, _seeded("5d"), dcn4=True,
                                          res=CHECK_RES_DCN4)
    torch.cuda.empty_cache()
    clock.start("5e", "end to end, f32 Faster R-CNN train step, card vs CPU "
                      "and the f64 referee")
    rcnn_train_f32 = check_rcnn_train_f32(dev, False, _seeded("5e"))
    clock.start("5f", "end to end, f32 Mask R-CNN train step, card vs CPU and "
                      "the f64 referee")
    mask_rcnn_train_f32 = check_rcnn_train_f32(dev, True, _seeded("5f"))
    torch.cuda.empty_cache()
    clock.start("5g", "end to end, f32 PointPillars train step, card vs CPU "
                      "and the f64 referee")
    pp_train_f32 = check_pointpillars_train_f32(dev)
    yolo_train_f32 = {}
    for kind, spec in yolo_models().items():
        phase = spec["phases"][1]
        clock.start(phase, f"end to end, f32 {spec['label']} train step, "
                           f"card vs CPU and the f64 referee")
        yolo_train_f32[kind] = check_yolo_train_f32(dev, kind)
        torch.cuda.empty_cache()
    seg_train_f32 = {}
    for kind, spec in seg_models().items():
        phase = spec["phases"][1]
        clock.start(phase, f"end to end, f32 {spec['label']} train step, "
                           f"card vs CPU and the f64 referee")
        seg_train_f32[kind] = check_seg_train_f32(dev, kind)
        torch.cuda.empty_cache()
    clock.start("5r", "end to end, f32 voxel loss steps of PointPillars and "
                      "CenterPoint, card vs CPU and the f64 referee")
    voxel_train_f32 = check_voxel_train_f32(dev)
    torch.cuda.empty_cache()
    clock.start("5s", "end to end, the nuScenes config's f32 train step on a "
                      "fed batch, card vs CPU and the f64 referee")
    nusc_train_f32 = check_config_train_f32(dev, "nuScenes",
                                            _nusc_step_inputs())
    torch.cuda.empty_cache()
    clock.start("5t", "end to end, the Waymo config's f32 train step on a fed "
                      "batch, card vs CPU and the f64 referee")
    waymo_train_f32 = check_config_train_f32(dev, "Waymo",
                                             _waymo_step_inputs())
    torch.cuda.empty_cache()
    forward_probe = None
    if args.probe:
        print("probe: f32 CenterPoint train-mode forward against f64, layer "
              "by layer", flush=True)
        forward_probe = probe_train_forward(dev)
    torch.cuda.empty_cache()

    clock.start("6a", "main path, bf16 serving")
    from minddet_tpu_torch.entry import entry

    programs = {b: entry(device=dev, batch=b) for b in SERVE_BATCHES}
    for predict, _ in programs.values():
        randomize_for_check(predict.__self__, _seeded("6a"))
    kernels.reset_launches()
    serving, forwards = serve(programs)
    serve_launches = {k.name: k.launches for k in kernels.KERNELS}
    taps = serve_launches["hat_sample_taps_fwd"]
    if serve_launches != _sampler_launches(forwards, train=False):
        raise AssertionError(f"serving launched {serve_launches} for "
                             f"{forwards} forwards (want 9 forward kernels "
                             f"each and no backward)")
    print(f"  kernels: hat_sample_taps_fwd launches={taps} forwards="
          f"{forwards} launches == 9 x forwards: True", flush=True)
    profiled = {}
    if args.profile:
        print("profile: bf16 serving", flush=True)
        profiled["serving"] = profile_serving(programs)
    del programs
    torch.cuda.empty_cache()

    clock.start("6b", f"main path, bf16 train step at batch {TRAIN_BATCH}")
    training, train_program = train_main_path(dev)
    if args.profile:
        print("profile: bf16 train step", flush=True)
        profiled["train"] = profile_train(f"train batch {TRAIN_BATCH}",
                                          *train_program)
    del train_program
    torch.cuda.empty_cache()

    clock.start("6f", "main path, bf16 serving with DCN in all four backbone "
                      "stages")
    from minddet_tpu_torch.entry import centernet_dcn4_entry

    programs = {b: centernet_dcn4_entry(device=dev, batch=b)
                for b in SERVE_BATCHES}
    for predict, _ in programs.values():
        randomize_for_check(predict.__self__, _seeded("6f"))
    kernels.reset_launches()
    serving_dcn4, forwards_dcn4 = serve(programs)
    serve_dcn4_launches = {k.name: k.launches for k in kernels.KERNELS}
    want = _sampler_launches(forwards_dcn4, dcn4=True, train=False)
    if serve_dcn4_launches != want:
        raise AssertionError(f"serving with DCN in four stages launched "
                             f"{serve_dcn4_launches} for {forwards_dcn4} "
                             f"forwards (want {want})")
    print(f"  kernels: {serve_dcn4_launches} forwards={forwards_dcn4}: "
          f"hat_sample_flat_fwd == 2 x forwards, hat_sample_taps_fwd == 9 x "
          f"forwards: True", flush=True)
    if args.profile:
        print("profile: bf16 serving with DCN in four stages", flush=True)
        profiled["serving_dcn4"] = profile_serving(programs)
    del programs
    torch.cuda.empty_cache()

    clock.start("6g", f"main path, bf16 train step with DCN in all four "
                      f"backbone stages at batch {TRAIN_BATCH}")
    training_dcn4, train_program = train_main_path(dev, dcn4=True)
    if args.profile:
        print("profile: bf16 train step with DCN in four stages", flush=True)
        profiled["train_dcn4"] = profile_train(
            f"train (DCN in four stages) batch {TRAIN_BATCH}", *train_program)
    del train_program
    torch.cuda.empty_cache()

    clock.start("6c", "main path, PointPillars f32 serving")
    from minddet_tpu_torch.entry import pointpillars_entry

    pp_programs = {b: pointpillars_entry(device=dev, batch=b)
                   for b in PP_BATCHES}
    kernels.reset_launches()
    pp_serving, predicts = serve_clouds("PointPillars", pp_programs, dev,
                                        _check_pointpillars_detections)
    pp_launches = {k.name: k.launches for k in kernels.KERNELS}
    if pp_launches != {k.name: predicts * int(k is kernels.ROTATED_IOU)
                       for k in kernels.KERNELS}:
        raise AssertionError(f"PointPillars serving launched {pp_launches} "
                             f"for {predicts} requests (want one "
                             f"rotated_iou_intersect each, nothing else)")
    print(f"  kernels: rotated_iou_intersect launches="
          f"{pp_launches['rotated_iou_intersect']} requests={predicts} "
          f"launches == requests: True", flush=True)
    if args.profile:
        print("profile: PointPillars serving", flush=True)
        profiled["pointpillars"] = profile_clouds("PointPillars",
                                                  pp_programs)
    del pp_programs
    torch.cuda.empty_cache()

    clock.start("6d", "main path, two-stage CenterPoint f32 serving")
    from minddet_tpu_torch.entry import centerpoint_entry

    cp_programs = {b: centerpoint_entry(device=dev, batch=b)
                   for b in CP_BATCHES}
    for predict, clouds in cp_programs.values():
        calibrate_centerpoint(predict.__self__, *clouds)
    kernels.reset_launches()
    cp_serving, cp_predicts = serve_clouds("CenterPoint", cp_programs, dev,
                                           _check_centerpoint_detections)
    cp_launches = {k.name: k.launches for k in kernels.KERNELS}
    if cp_launches != _centerpoint_launches(cp_predicts):
        raise AssertionError(f"CenterPoint serving launched {cp_launches} "
                             f"for {cp_predicts} requests (want one each of "
                             f"seg_full_max, rotated_iou_intersect and "
                             f"bilinear_gather_fwd per request, no sampler)")
    print(f"  kernels: {cp_launches} requests={cp_predicts} seg_full_max == "
          f"rotated_iou_intersect == bilinear_gather_fwd == requests: True",
          flush=True)
    if args.profile:
        print("profile: CenterPoint serving", flush=True)
        profiled["centerpoint"] = profile_clouds("CenterPoint", cp_programs)
    del cp_programs
    torch.cuda.empty_cache()

    clock.start("6e", f"main path, two-stage CenterPoint bf16 train step at "
                      f"batch {TRAIN_CP_BATCH}")
    cp_training, cp_train_program = centerpoint_train_main_path(dev)
    cp_training["k5b_route"] = k5b_gradient_copies(
        lambda: cp_train_program[0](*cp_train_program[1:]))
    if args.profile:
        print("profile: CenterPoint bf16 train step", flush=True)
        profiled["centerpoint_train"] = profile_train(
            f"CenterPoint train batch {TRAIN_CP_BATCH}", *cp_train_program)
    del cp_train_program
    torch.cuda.empty_cache()

    from minddet_tpu_torch.entry import faster_rcnn_entry, mask_rcnn_entry

    clock.start("6h", "main path, Faster R-CNN bf16 serving")
    rcnn = rcnn_main_path("Faster R-CNN", faster_rcnn_entry, dev, False,
                          args.profile)
    torch.cuda.empty_cache()
    clock.start("6i", "main path, Mask R-CNN bf16 serving")
    mask_rcnn = rcnn_main_path("Mask R-CNN", mask_rcnn_entry, dev, True,
                               args.profile)
    for key, r in (("faster_rcnn", rcnn), ("mask_rcnn", mask_rcnn)):
        if r["profile"] is not None:
            profiled[key] = r["profile"]
    torch.cuda.empty_cache()

    from minddet_tpu_torch.entry import (faster_rcnn_train_entry,
                                         mask_rcnn_train_entry)

    clock.start("6j", "main path, Faster R-CNN bf16 train step")
    rcnn_training = rcnn_train_main_path(
        "Faster R-CNN", faster_rcnn_train_entry, dev, False, args.profile)
    torch.cuda.empty_cache()
    clock.start("6k", "main path, Mask R-CNN bf16 train step")
    mask_rcnn_training = rcnn_train_main_path(
        "Mask R-CNN", mask_rcnn_train_entry, dev, True, args.profile)
    for key, r in (("faster_rcnn_train", rcnn_training),
                   ("mask_rcnn_train", mask_rcnn_training)):
        if "profile" in r:
            profiled[key] = r["profile"]
    torch.cuda.empty_cache()

    clock.start("6l", f"main path, PointPillars bf16 train step at batch "
                      f"{TRAIN_PP_BATCH}")
    pp_training, program = pointpillars_train_main_path(dev)
    if args.profile:
        print("profile: PointPillars bf16 train step", flush=True)
        profiled["pointpillars_train"] = profile_train(
            f"PointPillars train batch {TRAIN_PP_BATCH}", *program)
    del program
    torch.cuda.empty_cache()
    clock.start("6m", f"main path, single-stage CenterPoint bf16 train step "
                      f"at batch {TRAIN_CP_BATCH}")
    cp1_training, program = centerpoint_single_train_main_path(dev)
    if args.profile:
        print("profile: single-stage CenterPoint bf16 train step", flush=True)
        profiled["centerpoint_single_train"] = profile_train(
            f"single-stage CenterPoint train batch {TRAIN_CP_BATCH}",
            *program)
    del program
    torch.cuda.empty_cache()
    clock.start("6n", "main path, decode + rotated NMS, 20 chained iterations")
    decode = decode_main_path(dev)
    torch.cuda.empty_cache()
    yolo, yolo_training = {}, {}
    for kind, spec in yolo_models().items():
        _, _, serve_phase, train_phase = spec["phases"]
        profile = args.profile or spec["profile"]
        clock.start(serve_phase, f"main path, {spec['label']} bf16 serving")
        yolo[kind] = yolo_main_path(dev, profile, kind)
        if yolo[kind]["profile"] is not None:
            profiled[kind] = yolo[kind]["profile"]
        torch.cuda.empty_cache()
        clock.start(train_phase, f"main path, {spec['label']} bf16 train "
                                 f"step at batch {spec['train_batch']}")
        yolo_training[kind] = train_main_path_of(dev, profile, spec)
        if "profile" in yolo_training[kind]:
            profiled[f"{kind}_train"] = yolo_training[kind]["profile"]
        torch.cuda.empty_cache()
    seg, seg_training = {}, {}
    for kind, spec in seg_models().items():
        _, _, serve_phase, train_phase = spec["phases"]
        clock.start(serve_phase, f"main path, {spec['label']} bf16 serving")
        seg[kind] = seg_main_path(dev, kind)
        profiled[kind] = seg[kind]["profile"]
        torch.cuda.empty_cache()
        clock.start(train_phase, f"main path, {spec['label']} bf16 train "
                                 f"step at batch {spec['train_batch']}")
        seg_training[kind] = train_main_path_of(dev, True, spec, True)
        profiled[f"{kind}_train"] = seg_training[kind]["profile"]
        torch.cuda.empty_cache()
    clock.start("6ai", f"main path, the config's bf16 train step fed by "
                       f"coco_batches at batch {COCO_TRAIN_BATCH}")
    coco_training = coco_train_main_path(dev, card)
    torch.cuda.empty_cache()
    clock.start("6aj", "main path, centernet_evaluate on 64 images (bf16)")
    coco_eval = coco_eval_main_path(dev, card)
    torch.cuda.empty_cache()
    clock.start("6ak", f"main path, the mosaic route of coco_batches at batch "
                       f"{COCO_TRAIN_BATCH}")
    coco_mosaic = coco_mosaic_main_path(dev, card)
    torch.cuda.empty_cache()
    from minddet_tpu_torch.entry import (PP_CAR_CONFIG, PP_PED_CYCLE_CONFIG,
                                         pointpillars_ped_cycle_entry)

    clock.start("6al", "main path, the car config's f32 train step fed by "
                       "kitti_batches at batch 4")
    kitti_training = kitti_train_main_path(dev, card, PP_CAR_CONFIG, "car")
    torch.cuda.empty_cache()
    clock.start("6am", "main path, the ped_cycle config's f32 train step fed "
                       "by kitti_batches at batch 4")
    kitti_ped_training = kitti_train_main_path(dev, card, PP_PED_CYCLE_CONFIG,
                                               "ped_cycle")
    torch.cuda.empty_cache()
    clock.start("6an", "main path, kitti_evaluate on 256 frames (car, f32)")
    kitti_eval = kitti_eval_main_path(dev, card)
    torch.cuda.empty_cache()
    clock.start("6ao", "main path, PointPillars ped_cycle f32 serving")
    ped_programs = {b: pointpillars_ped_cycle_entry(device=dev, batch=b)
                    for b in KITTI_SERVE_BATCHES}
    kernels.reset_launches()
    ped_serving, ped_predicts = serve_clouds(
        "PointPillars ped_cycle", ped_programs, dev,
        _check_pointpillars_detections)
    ped_launches = {k.name: k.launches for k in kernels.KERNELS}
    if ped_launches != {k.name: ped_predicts * int(k is kernels.ROTATED_IOU)
                        for k in kernels.KERNELS}:
        raise AssertionError(f"ped_cycle serving launched {ped_launches} "
                             f"for {ped_predicts} requests (want one "
                             f"rotated_iou_intersect each, nothing else)")
    print(f"  kernels: rotated_iou_intersect launches="
          f"{ped_launches['rotated_iou_intersect']} requests={ped_predicts} "
          f"launches == requests: True", flush=True)
    del ped_programs
    torch.cuda.empty_cache()
    clock.start("6ap", "main path, PointPillars f32 serving on padded voxels "
                       "(car, ped_cycle), the stream entry beside it")
    pp_voxel = pointpillars_voxel_main_path(dev)
    torch.cuda.empty_cache()
    clock.start("6aq", f"main path, PointPillars bf16 train step on padded "
                       f"voxels at batch {TRAIN_PP_BATCH}, the stream step "
                       f"beside it")
    pp_voxel_training = pointpillars_voxel_train_main_path(dev)
    torch.cuda.empty_cache()
    clock.start("6ar", "main path, CenterPoint f32 serving on padded voxels")
    cp_voxel = centerpoint_voxel_main_path(dev, False)
    torch.cuda.empty_cache()
    clock.start("6as", "main path, CenterPoint f32 double-flip TTA serving")
    cp_tta = centerpoint_voxel_main_path(dev, True)
    torch.cuda.empty_cache()
    clock.start("6at", f"main path, the nuScenes config's f32 train step fed "
                       f"by nuscenes_batches at batch {NUSC_TRAIN_BATCH}")
    nusc_training = fed_train_main_path(dev, card, "nuScenes",
                                        _nusc_fed_spec())
    torch.cuda.empty_cache()
    clock.start("6au", "main path, nuscenes_evaluate by the plain, TTA and "
                       "refined routes (f32)")
    nusc_eval = nuscenes_eval_main_path(dev, card)
    torch.cuda.empty_cache()
    clock.start("6av", "main path, nuscenes_tracking_evaluate over one 20 s "
                       "scene (f32)")
    nusc_tracking = nuscenes_tracking_main_path(dev, card)
    torch.cuda.empty_cache()
    clock.start("6aw", "main path, CenterPoint Waymo f32 serving")
    from minddet_tpu_torch.entry import centerpoint_waymo_entry

    wm_programs = {b: centerpoint_waymo_entry(device=dev, batch=b)
                   for b in WAYMO_SERVE_BATCHES}
    for predict, clouds in wm_programs.values():
        calibrate_centerpoint(predict.__self__, *clouds)
    kernels.reset_launches()
    waymo_serving, wm_predicts = serve_clouds(
        "CenterPoint Waymo", wm_programs, dev, _check_waymo_detections)
    wm_launches = {k.name: k.launches for k in kernels.KERNELS}
    if wm_launches != _centerpoint_launches(wm_predicts,
                                            WAYMO_ROUTE_KERNELS["plain"]):
        raise AssertionError(f"Waymo serving launched {wm_launches} for "
                             f"{wm_predicts} requests (want one each of "
                             f"seg_full_max and rotated_iou_intersect per "
                             f"request, nothing else)")
    print(f"  kernels: {wm_launches} requests={wm_predicts} seg_full_max == "
          f"rotated_iou_intersect == requests: True", flush=True)
    del wm_programs
    torch.cuda.empty_cache()
    wm_train_batch, wm_eval_batch = _waymo_batch_sizes()
    clock.start("6ax", f"main path, the Waymo config's f32 train step fed by "
                       f"waymo_batches at batch {wm_train_batch}")
    waymo_training = fed_train_main_path(dev, card, "Waymo",
                                         _waymo_fed_spec())
    torch.cuda.empty_cache()
    clock.start("6ay", "main path, waymo_evaluate by the plain and refined "
                       "routes (f32)")
    waymo_eval = waymo_eval_main_path(dev, card)
    torch.cuda.empty_cache()

    # the summary rows: K1f is one bf16 batch-16 forward's nine calls (3 at
    # each DCN shape, the spread-1.5 cases) and one train step's nine at the
    # train batch; K1b one bf16 train step's nine calls at the train batch
    # (spread 1.5: offsets that moved)
    fwd_main = [c for c in cases
                if c["dtype"] == "bfloat16" and c["spread"] == 1.5
                and c["shape"][0] in (BATCH, TRAIN_BATCH)]
    bwd_main = [c for c in bwd_cases
                if c["shape"][0] == TRAIN_BATCH and c["spread"] == 1.5]
    train_launches = training["launches"]
    cp_train_launches = cp_training["launches"]
    # K3f's R-CNN calls: one bf16 batch-8 request of each model, four box
    # levels (Faster R-CNN), four box and four mask levels (Mask R-CNN)
    rcnn_case = lambda kind: [
        c for c in gather_cases if c.get("stream") == f"rcnn_{kind}"
        and c["dtype"] == "bfloat16" and c["shape"][0] == RCNN_BATCHES[-1]]
    # K3f's R-CNN train calls: one batch-8 step of each model, four box
    # levels (Faster R-CNN), four box and four mask levels and the f32 GT
    # crop (Mask R-CNN); K3dx's are the main paths' own calls, kept from one
    # step of each (main_path_k3dx)
    rcnn_train_case = lambda cs, kind: [
        c for c in cs if c.get("stream") == f"rcnn_{kind}"
        and c["shape"][0] == RCNN_TRAIN_BATCHES[-1]]
    # K5b, K3dx and K3dcw: one bf16 batch-8 CenterPoint train step's call
    train_case = lambda cs: [
        c for c in cs if c["dtype"] == "bfloat16"
        and c["shape"][0] == TRAIN_CP_BATCH and c.get("stream", "uniform")
        == "uniform"]
    train_dcn4_launches = training_dcn4["launches"]
    # K2f: one bf16 batch-16 forward's two calls and one train step's two
    # at batch 128 (spread 1.5); K2b: one train step's two at batch 128
    flat_fwd_main = [c for c in flat_cases
                     if c["dtype"] == "bfloat16" and c["spread"] == 1.5
                     and c["shape"][0] in (BATCH, TRAIN_BATCH)
                     and c["shape"][1:] == [FLAT_SHAPE[0]] * 2
                     + [FLAT_SHAPE[1]]]
    flat_bwd_main = [c for c in flat_bwd_cases
                     if c["shape"][0] == TRAIN_BATCH and c["spread"] == 1.5]
    # the Waymo paths' cases (phase 3): K4 at one batch-4 request's NMS and
    # one batch-2 evaluation predict's of each route, and one IoU call of
    # the evaluator per route; K5f at one batch-4 request's, one train
    # step's and one batch-2 predict's of each route; K5b at one train
    # step's; K3f at one refined batch-2 predict's
    waymo_iou = waymo_cases["rotated_iou_intersect"]
    waymo_seg = waymo_cases["seg_full_max"]
    waymo_seg_bwd = waymo_cases["seg_full_max_bwd"]
    waymo_gather = waymo_cases["bilinear_gather_fwd"]
    rows = [
        _kernel_row(kernels.HAT_SAMPLE_TAPS_FWD,
                    taps + train_launches["hat_sample_taps_fwd"]
                    + serve_dcn4_launches["hat_sample_taps_fwd"]
                    + train_dcn4_launches["hat_sample_taps_fwd"], fwd_main,
                    DCN_CALLS_PER_SHAPE, cases),
        _kernel_row(kernels.HAT_SAMPLE_TAPS_BWD,
                    train_launches["hat_sample_taps_bwd"]
                    + train_dcn4_launches["hat_sample_taps_bwd"], bwd_main,
                    DCN_CALLS_PER_SHAPE, bwd_cases),
        # K4: one batch-8 PointPillars request's call, one batch-4
        # CenterPoint request's, one CenterPoint train step's, one
        # iteration of the decode program's, one batch-4 ped_cycle
        # request's, and of the KITTI evaluation one predict batch's and the
        # bev and 3d overlaps' calls; the padded paths: one batch-8 car and
        # one batch-4 ped_cycle request's, one batch-4 CenterPoint voxel
        # request's and one batch-4 TTA request's (6ap's stream requests
        # are 6c's path); the nuScenes evaluations: one batch-2 predict's
        # of each route (6au) and of the tracking evaluation (6av)
        _kernel_row(kernels.ROTATED_IOU,
                    pp_launches["rotated_iou_intersect"]
                    + cp_launches["rotated_iou_intersect"]
                    + cp_train_launches["rotated_iou_intersect"]
                    + decode["launches"]["rotated_iou_intersect"]
                    + kitti_eval["launches"]["rotated_iou_intersect"]
                    + ped_launches["rotated_iou_intersect"]
                    + pp_voxel["launches"]["rotated_iou_intersect"]
                    + pp_voxel["stream"]["launches"]["rotated_iou_intersect"]
                    + cp_voxel["launches"]["rotated_iou_intersect"]
                    + cp_tta["launches"]["rotated_iou_intersect"]
                    + nusc_eval["launches"]["rotated_iou_intersect"]
                    + nusc_tracking["launches"]["rotated_iou_intersect"]
                    + wm_launches["rotated_iou_intersect"]
                    + waymo_eval["launches"]["rotated_iou_intersect"],
                    [c for c in iou_cases if c["kind"] in (
                        "candidates", "train") and c["shape"][:2] in (
                        [PP_BATCHES[-1], PP_CANDIDATES],
                        [CP_TASKS * CP_BATCHES[-1], CP_CANDIDATES],
                        [TRAIN_CP_BATCH, CP_PROPOSALS])
                     or c["kind"] == "decode_nms"]
                    + 2 * [c for c in iou_cases if c["kind"] in (
                        "eval_candidates", "kitti_eval")]
                    + [c for c in iou_cases if c["kind"] in (
                        "candidates", "eval_candidates") and c["shape"][:2]
                       in ([PP_BATCHES[-1], PP_CANDIDATES],
                           [KITTI_EVAL_BATCH, PP_CANDIDATES])]
                    + 2 * [c for c in iou_cases if c["kind"] == "candidates"
                           and c["shape"][:2] == [CP_TASKS * CP_BATCHES[-1],
                                                  CP_CANDIDATES]]
                    + 4 * [c for c in iou_cases if c["kind"] == "nusc_eval"]
                    + [c for c in waymo_iou if c["kind"] == "waymo_serve"
                       and c["shape"][0] == WAYMO_SERVE_BATCHES[-1]]
                    + 2 * [c for c in waymo_iou if c["kind"] in (
                        "waymo_eval", "waymo_eval_frame")],
                    1, iou_cases + waymo_iou),
        # K5f: one f32 batch-4 CenterPoint request's call, one bf16
        # batch-8 step's of each CenterPoint train path (two- and
        # single-stage), one f32 batch-4 step's of the nuScenes config's
        # (6at) and one f32 batch-2 predict's of each nuScenes evaluation
        # that runs the stream (6au plain and refined, 6av); K5b the three
        # train steps' calls
        _kernel_row(kernels.SEG_FULL_MAX, cp_launches["seg_full_max"]
                    + cp_train_launches["seg_full_max"]
                    + cp1_training["launches"]["seg_full_max"]
                    + nusc_training["launches"]["seg_full_max"]
                    + nusc_eval["launches"]["seg_full_max"]
                    + nusc_tracking["launches"]["seg_full_max"]
                    + wm_launches["seg_full_max"]
                    + waymo_training["launches"]["seg_full_max"]
                    + waymo_eval["launches"]["seg_full_max"],
                    2 * [c for c in seg_cases if c["dtype"] == "float32"
                         and c["shape"][0] == CP_BATCHES[-1]]
                    + 2 * train_case(seg_cases)
                    + 3 * [c for c in seg_cases if c["dtype"] == "float32"
                           and c["shape"][0] == NUSC_EVAL_BATCH]
                    + 2 * [c for c in waymo_seg
                           if c["shape"][0] == wm_train_batch]
                    + 2 * [c for c in waymo_seg
                           if c["shape"][0] == wm_eval_batch], 1,
                    seg_cases + waymo_seg),
        _kernel_row(kernels.SEG_FULL_MAX_BWD,
                    cp_train_launches["seg_full_max_bwd"]
                    + cp1_training["launches"]["seg_full_max_bwd"]
                    + nusc_training["launches"]["seg_full_max_bwd"]
                    + waymo_training["launches"]["seg_full_max_bwd"],
                    2 * train_case(seg_bwd_cases)
                    + [c for c in seg_bwd_cases if c["dtype"] == "float32"
                       and c["shape"][0] == NUSC_TRAIN_BATCH
                       and c["stream"] == "uniform"]
                    + [c for c in waymo_seg_bwd if c["stream"] == "waymo"],
                    1, seg_bwd_cases + waymo_seg_bwd),
        _kernel_row(kernels.BILINEAR_GATHER_FWD,
                    cp_launches["bilinear_gather_fwd"]
                    + cp_train_launches["bilinear_gather_fwd"]
                    + rcnn["launches"]["bilinear_gather_fwd"]
                    + mask_rcnn["launches"]["bilinear_gather_fwd"]
                    + rcnn_training["launches"]["bilinear_gather_fwd"]
                    + mask_rcnn_training["launches"]["bilinear_gather_fwd"]
                    + nusc_eval["launches"]["bilinear_gather_fwd"]
                    + waymo_eval["launches"]["bilinear_gather_fwd"],
                    [c for c in waymo_gather if c["dtype"] == "float32"]
                    + [c for c in gather_cases if c["dtype"] == "float32"
                     and c["shape"][0] in (CP_BATCHES[-1], NUSC_EVAL_BATCH)
                     and "stream" not in c]
                    + train_case(gather_cases) + rcnn_case("box")
                    + rcnn_case("box") + rcnn_case("mask")
                    + rcnn_train_case(gather_cases, "train_box")
                    + rcnn_train_case(gather_cases, "train_box")
                    + rcnn_train_case(gather_cases, "train_mask")
                    + rcnn_train_case(gather_cases, "gt_crop"), 1,
                    gather_cases + waymo_gather, library=True),
        _kernel_row(kernels.BILINEAR_GATHER_BWD_DX,
                    cp_train_launches["bilinear_gather_bwd_dx"]
                    + rcnn_training["launches"]["bilinear_gather_bwd_dx"]
                    + mask_rcnn_training["launches"][
                        "bilinear_gather_bwd_dx"],
                    train_case(gather_dx_cases)
                    + rcnn_training["k3dx_cases"]
                    + mask_rcnn_training["k3dx_cases"], 1,
                    gather_dx_cases + rcnn_training["k3dx_cases"]
                    + mask_rcnn_training["k3dx_cases"], library=True),
        # K3dcw: no entry point reaches it yet (the train step's proposals
        # are detached), so its count on the main paths is 0; phase 5b's
        # launch, through bilinear_sample_2d's gradient to the coordinates,
        # stands beside it under its own key
        dict(_kernel_row(kernels.BILINEAR_GATHER_BWD_DCW,
                         cp_train_launches["bilinear_gather_bwd_dcw"],
                         train_case(gather_dcw_cases), 1, gather_dcw_cases),
             launches_in_phase_5b=sample_grads["launches"][
                 "bilinear_gather_bwd_dcw"]),
        _kernel_row(kernels.HAT_SAMPLE_FLAT_FWD,
                    serve_dcn4_launches["hat_sample_flat_fwd"]
                    + train_dcn4_launches["hat_sample_flat_fwd"],
                    flat_fwd_main, FLAT_LAYERS, flat_cases),
        _kernel_row(kernels.HAT_SAMPLE_FLAT_BWD,
                    train_dcn4_launches["hat_sample_flat_bwd"],
                    flat_bwd_main, FLAT_LAYERS, flat_bwd_cases),
        # the warp kernel's COCO calls: one COCO-fed train step's warp, one
        # eval batch's at the (512, 768) bucket, one mosaic batch's four
        _kernel_row(kernels.BILINEAR_WARP_AFFINE_FWD,
                    coco_training["launches"]["bilinear_warp_affine_fwd"]
                    + coco_eval["launches"]["bilinear_warp_affine_fwd"]
                    + coco_mosaic["launches"]["bilinear_warp_affine_fwd"],
                    [c for c in warp_cases if c["stream"] in (
                        "coco_train", "coco_eval_512x768")]
                    + 4 * [c for c in warp_cases
                           if c["stream"] == "coco_mosaic"], 1,
                    warp_cases, library=True),
    ]
    clock.stop()
    wall_s = time.perf_counter() - t_start
    print("  phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in clock.seconds.items()}), flush=True)
    print(f"  chip_smoke wall time {wall_s:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           wall_s=wall_s, phase_seconds=clock.seconds,
                           taps_cases=cases,
                           taps_bwd_cases=bwd_cases, flat_cases=flat_cases,
                           flat_bwd_cases=flat_bwd_cases,
                           dcn_bias_rounding=bias_rounding,
                           end_to_end_f32_dcn4=e2e_dcn4,
                           train_step_f32_dcn4=train_f32_dcn4,
                           serving_dcn4=serving_dcn4,
                           serving_dcn4_launches=serve_dcn4_launches,
                           forwards_dcn4=forwards_dcn4,
                           training_dcn4=training_dcn4,
                           rotated_iou_cases=iou_cases,
                           seg_full_max_cases=seg_cases,
                           bilinear_gather_cases=gather_cases,
                           seg_full_max_bwd_cases=seg_bwd_cases,
                           bilinear_gather_bwd_dx_cases=gather_dx_cases,
                           bilinear_gather_bwd_dcw_cases=gather_dcw_cases,
                           sample_grads_f32=sample_grads,
                           centerpoint_train_f32=cp_train_f32,
                           centerpoint_forward_probe=forward_probe,
                           centerpoint_training=cp_training,
                           end_to_end_f32=e2e, pointpillars_f32=pp_f32,
                           referee_ratios=referee_ratios,
                           centerpoint_f32=cp_f32,
                           train_step_f32=train_f32, serving=serving,
                           serving_launches=serve_launches,
                           forwards=forwards, training=training,
                           pointpillars_serving=pp_serving,
                           pointpillars_launches=pp_launches,
                           centerpoint_serving=cp_serving,
                           centerpoint_launches=cp_launches,
                           faster_rcnn_f32=rcnn_f32,
                           mask_rcnn_f32=mask_rcnn_f32,
                           faster_rcnn=rcnn, mask_rcnn=mask_rcnn,
                           faster_rcnn_train_f32=rcnn_train_f32,
                           mask_rcnn_train_f32=mask_rcnn_train_f32,
                           faster_rcnn_training=rcnn_training,
                           mask_rcnn_training=mask_rcnn_training,
                           pointpillars_train_f32=pp_train_f32,
                           pointpillars_training=pp_training,
                           centerpoint_single_training=cp1_training,
                           decode_nms=decode,
                           yolo_f32=yolo_f32, yolo_train_f32=yolo_train_f32,
                           yolo=yolo, yolo_training=yolo_training,
                           seg_f32=seg_f32, seg_train_f32=seg_train_f32,
                           seg=seg, seg_training=seg_training,
                           coco_warp_cases=warp_cases, coco_f32=coco_f32,
                           coco_training=coco_training, coco_eval=coco_eval,
                           coco_mosaic=coco_mosaic,
                           kitti_f32=kitti_f32, kitti_training=kitti_training,
                           kitti_ped_cycle_training=kitti_ped_training,
                           kitti_eval=kitti_eval,
                           ped_cycle_serving=ped_serving,
                           ped_cycle_launches=ped_launches,
                           voxel_f32=voxel_f32,
                           voxel_train_f32=voxel_train_f32,
                           pointpillars_voxel=pp_voxel,
                           pointpillars_voxel_training=pp_voxel_training,
                           centerpoint_voxel=cp_voxel, centerpoint_tta=cp_tta,
                           nuscenes_f32=nusc_f32,
                           nuscenes_train_f32=nusc_train_f32,
                           nuscenes_training=nusc_training,
                           nuscenes_eval=nusc_eval,
                           nuscenes_tracking=nusc_tracking,
                           waymo_cases=waymo_cases, waymo_f32=waymo_f32,
                           waymo_train_f32=waymo_train_f32,
                           waymo_serving=waymo_serving,
                           waymo_serving_launches=wm_launches,
                           waymo_training=waymo_training,
                           waymo_eval=waymo_eval,
                           profile=profiled or None, kernels=rows), f,
                      indent=1)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
