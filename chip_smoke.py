#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ovmono3d_tpu_torch) on one NVIDIA GPU.

Drives the port's five paths, weights drawn from a seed: OVMono3D-LIFT
inference on oracle 2D boxes and a few training steps with the trunk
unfrozen (RPN, box head and cube head losses, SGD), both with the flagship
DINOv2 ViT-B/14 + SFP model at 896^2; OVMono3D-GEO inference on oracle 2D
boxes (SAM ViT-H at 1024^2, SAM's mask decoder, Depth-Pro at 1536^2 and the
box fit); and open-vocabulary OVMono3D-LIFT serving (GroundingDINO Swin-B +
BERT-base + deformable DETR on the 896^2 canvas, then the flagship cube
model on its boxes); and the W8A8 int8 serving option of the ViT trunks
(oracle LIFT, and GEO with the tanh-GELU epilogue too); open-vocabulary
streams, batch detection and the dataset CLIs. Besides, GEO in the
JAX GEO CLI's default configuration (Depth-Pro in f32); the Omni3D
evaluation of the flagship (oracle and learned 2D, AP2D / AP3D
with the exact 3D IoU on the card); and the entry points of the kernels no
model path reaches: the differentiable fused LayerNorm and the counterparts
of the JAX package's LayerNorm and attention-sweep probes; and the rest of
training: remat under each policy, gradient accumulation, and the train CLI
(frozen and unfrozen, resumed, --eval-only, in a one-process NCCL group);
and released-checkpoint loading: state dicts in the released key layouts at
full width, through the CLIs' --rcnn-ckpt, --gdino-ckpt and --vocab and the
GEO loaders, then served; and the other detector trunks (CLIP, MAE, MiDaS,
SAM, DLA, ResNet, DenseNet, MNASNet, ShuffleNetV2) at full width from their
released layouts, served and trained through --trunk-ckpt; and the SAM
ViT-B + SFP detector trained with its trunk unfrozen (kernel 7's lse
instance and the rel-pos backward, and the multi-tensor SGD update every
training path takes). Holds every CUDA kernel on those paths against its
plain PyTorch version.

    python3 chip_smoke.py          # needs one CUDA device and nvcc
    python3 chip_smoke.py --previous DIR   # kernels 7, 8, 10 and the
                                           # rel-pos backward also beside
                                           # the designs in DIR's sources
                                           # (those that differ)

Kernels: 1 = the inference flash-attention forward, 3 = the training
forward that also writes the row log-sum-exp, 4 = the attention backward,
7 = the decomposed rel-pos attention forward of SAM's encoder, 8 = the Swin
window attention forward of GroundingDINO's trunk, 10 = the int8 x int8 ->
int32 product of the W8A8 serving option (the trunks' qkv, proj, fc1, fc2);
1 f32 = kernel 1's f32 instance (f32 products on the FP32 pipes); the JAX
package's head-major kernels 2, 5 and 6 are 1, 3 and 4 on head-major
strides (the same wrappers); 9 = the fused row LayerNorm
(layer_norm_fused), 12 = the LayerNorm probe's variants v2 / v3 / v4 (the
same source's instances), 11 = the attention sweep's forward (8 instances:
block_q and block_k in {64, 128}, softmax in f32 or bf16); 7 lse = kernel
7's training instance, which also writes the row log-sum-exp, and the
rel-pos backward (csrc/relpos_flash_bwd.cu, the port's own: the JAX package
differentiates its XLA path there); sgd and finite = the multi-tensor SGD
update and the gradients' finiteness flag (csrc/multi_tensor_sgd.cu), which
every training step on the card takes.

Phases, one line each (more for the build's resource report and the
profiles' tables):
  device  the card, its power limit, TF32 as PyTorch starts (the entry
          points that place a model on the card turn it off)
  build   nvcc builds (or loads) of the kernel libraries, in parallel;
          the wgmma + TMA designs' instances (the bf16 D = 64 forward's
          flash_fwd_sm90_kernel<false / true>, the backward's
          flash_bwd_sm90_kernel<true / false>, its dk/dv and dq kernels,
          the sweep's eight sweep_fwd_sm90_kernel<block_k, consumers,
          f32 softmax>, the rel-pos forward's relpos_fwd_sm90_kernel<64
          / 80, false / true> (inference / lse), the window forward's
          window_fwd_sm90_kernel<false / true> and the rel-pos backward's
          relpos_bwd_dkdv_kernel<D> and relpos_bwd_dq_kernel<D> (D 64,
          80)): registers, spill stores and stack frame from the -Xptxas
          -v log (no spills, no stack frame), ptxas's C7513 lines
          printed, and their HGMMA and UTMALDG instructions in
          cuobjdump's SASS (both above 0); the int8 product's three
          int8_gemm_sm90_kernel<mode>: the same, with IGMMA (s8 wgmma)
          for HGMMA; the f32 instance's two flash_fwd_f32_kernel<D> and
          the int8 path's two quantize_rows_kernel<T>: no spills, no
          stack frame
  kernel  kernel 1 vs attention_ref, kernel 3 vs attention_lse_ref and
          kernel 4 vs attention_bwd_ref at the trunk, Depth-Pro's B=1 and
          35-crop shapes, a small ragged shape, the 128-row tile's edges
          (N = 64, 128, 129), N = 8192, and on head-major views the JAX
          tests' [2, 150, 3, 32] (the D = 32 instances) and the trunk (max
          / mean abs error, absolute and relative to the output); kernels
          1 and 3 at the probe's four shapes (probes/flash_fwd.py: the
          trunk, an eval batch of 8,
          Depth-Pro's patches, N = 8192): the kernel and SDPA in turns, each
          by CUDA events and by the profiler's device time; kernel 4's stats
          pass (delta, lse2) vs attention_bwd_stats_ref at every shape
          above; kernel 4 at its probe's four shapes (probes/flash_bwd.py:
          the trunk, the B=8 train step, N = 8192, a ragged one): held to
          attention_bwd_ref under the relative limits, then the kernel and
          SDPA's backward in turns by events and by the device time of
          every device op of a call; then at the trunk
          shape each kernel's time, its plain version's,
          F.scaled_dot_product_attention's forward or backward on the same
          views (a yardstick the port never calls) and the card's bound for
          the work; kernel 7 vs rel_pos_attention_ref at
          SAM-H global and windowed, SAM-B global and a small ragged grid
          (rel-pos tables ~N(0, 0.1^2)), then through probes/relpos.py at
          SAM-H's global and windowed shapes: the kernel, its earlier design
          (with --previous; its device time must be above the new one's,
          or, where every kernel of DIR's library is one of the shipped
          one's instruction for instruction, within RELPOS_SAME_NOISE of
          it) and SDPA with the [B, H, N, N] bias built from qrh/qrw inside
          the timed call (a yardstick the port never calls) in turns, by events
          and by the profiler's device time, the plain version's time and
          the bound; kernel 8 vs
          window_attention_ref at Swin-B's four stage shapes at 896^2, with
          the shifted blocks' region ids and without (bias ~N(0, 1)), at the
          windows of maps smaller than the window (N = 121, 64, 49, 16, 1)
          and N = 144 with a bias of std 30 (one-hot softmax) and random
          ids, and at N = 196 (the mma.sync instance), then through
          probes/window.py at all four stages, shifted and unshifted: the
          wgmma design, its earlier design (with --previous; its device time
          must be above the new one's) and SDPA with the [BW, H, N, N] bias
          and mask built inside the timed call (below the new one's at
          stages 0 and 2) in turns, by events and by the profiler's device
          time, the plain version's time and the bound; kernel 10 at every
          product shape of the int8 paths
          (INT8_SHAPES), a ragged one and two K tails: the int32
          accumulator equal to int8_mm_ref, the bf16
          dequantized product within 1 bf16 ulp of dequantize_ref
          (activations ~N(0, 1) bf16, weights ~N(0, 0.02^2), quantized),
          and the activation's quantization kernel equal to quantize_int8;
          then through probes/int8_gemm.py at LIFT's four products, SAM-H's
          fc1 and Depth-Pro's patch qkv: the product, the quantization
          kernel, the earlier design (with --previous; its device time must
          be above the new one's), torch._int_mm alone and with the same
          epilogue, and bf16 F.linear (yardsticks the port never calls) in
          turns, by events and by device time, with the plain version's
          time and the bounds; kernel 1's f32 instance vs f32 attention_ref at
          Depth-Pro's shapes, a ragged one and [2, 150, 3, 32] on
          head-major views (within F32_MAX_REL of max |ref|), its time at
          the 35 crops beside the plain version's, SDPA f32's and the bound
          (on the FP32 pipes' 67 TFLOP/s), then through
          probes/flash_fwd_f32.py at those shapes (packed) and the f32
          trunk: its time and SDPA f32's in turns, by events and by the
          profiler's device time, and its error again
  slice   3 warm-up + 10 timed requests (B=1, 64 oracle boxes, as bench.py
          builds them): launches per forward, finite [1, 64, ...]
          detections, img/s, p50, peak memory; then the same model with
          attention_ref swapped in: its times and its deviation
  profile torch.profiler over 5 requests of the kernel path: device time
          and device ops per image, the device's idle share against the
          slice's p50, and device time by PyTorch op
  sensitivity  how far bf16 rounding inside attention moves corners3d,
          with the pose bias at its zero init and at the identity: kernel
          vs attention_ref, and attention_ref vs the same math with f32
          probabilities; then the trunk's last_feat with cuBLAS's bf16
          reduced-precision reductions on and off, against bf16 noise (the
          kernel vs attention_ref), printed; TF32 off after build_model, and
          the RPN conv in f32 within 1e-5 of float64 (with cuDNN's TF32
          printed beside)
  train   the flagship with the trunk unfrozen, default SGD solver, on a
          synthetic batch of 8 images (16 GT slots each, 3D boxes in front
          of the camera, 2D boxes their projected cuboids): 2 warm-up + 5
          timed steps (ms/step, img/s, peak memory, kernel 3 and 4
          launches per step, finite losses, no skip, every trunk
          parameter moved); a profile of 2 steps (device time by op, idle
          share); then one B=1 loss and gradient from the same state with
          the kernels and with attention_ref, all on the kernel run's
          proposals (how many the plain run's own would change is
          printed): total loss within 1e-2; every trunk gradient, the
          plain run's fed the kernel run's gradient at the trunk output,
          within 5e-2 of the plain one's norm, each with its margin; the
          gradients from each run's own heads, and attention_ref in f32
          against bf16, printed beside
  geo     SAM ViT-H (bf16, rel-pos tables ~N(0, 0.1^2)), SAM's decoder
          (f32) and Depth-Pro (bf16, LayerScales 0.1, depth-head bias 0.5)
          from seed 0 serve 704x512 images with 8 oracle boxes each (2 under
          the 0.30 threshold): 2 warm-up + 5 timed images (img/s, p50, ms
          per image in each stage, peak memory, 32 kernel-7 and 72 kernel-1
          launches per image); the same models with rel_pos_attention_ref
          and attention_ref: SAM embedding, mask logits and canonical
          inverse depth (as it is, and less the head bias) within
          GEO_MAX_REL / GEO_MEAN_REL of the plain run, a guard of the model
          (the kernel checks are the kernel phase's), fitted boxes printed
          side by side unchecked; a profile of 3
          images; the synthetic GEO self-check on the card (PASS)
  geo_f32 the JAX GEO CLI's default: build_geo_models("vit_h",
          depth_bf16=False), weights as the geo phase: 2 warm-up + 3 timed
          images (img/s, p50, stages, peak memory, 72 f32 kernel-1 and 32
          kernel-7 launches an image, no other attention kernel), a profile
          of 2; one image's inverse depth against f32 attention_ref in every
          Depth-Pro block (within GEO_F32_REL) and, printed, against a bf16
          Depth-Pro holding the same weights
  ovlift  OVMono3DLift at full width from seed 0 (GroundingDINO SwinB, the
          flagship cube model; OVLIFT_SETS below says which weights are
          moved off their init and why), a tokenizer whose vocabulary holds
          the words of the 50 categories of configs/category_meta50.json,
          serving 640x480 random images (532x709 content on the 896^2
          canvas) with those 50 categories as the prompt: 2 warm-up + 5
          timed images (img/s, p50, device ms per stage span, peak memory,
          24 kernel-8 and 12 kernel-1 launches per image, finite [300, ...]
          detections with valid classes < 50); one image's detection and
          lift run with the host synchronisation check on (none allowed);
          one image with window_attention_ref in every Swin block: Swin's
          s1/s2/s3 within OVLIFT_MAX_REL / OVLIFT_MEAN_REL of the plain run
          (a guard of the model), with plain bf16 vs f32 probabilities
          printed beside, and pred_logits, pred_boxes and the lifted corners
          printed unchecked (top-900 selection and NMS flip on rounding); a
          profile of 3 images, with --previous also with kernel 8's earlier
          design in every Swin block and then the shipped one again
  stream  on the ovlift phase's pipeline: predict_stream (chunk 8, each
          chunk one batch; the first chunk eager, the second captured into
          CUDA graphs, the rest replayed) over the 16 640x480 images
          STREAM_PASSES times and per-image predict (results copied to the
          host) over them once: img/s, the stream's chunk counters (eager,
          captured, replayed), the stream's
          per-image latency, 24 kernel-8 and 12 kernel-1 launches a chunk in
          the stream and an image in predict and no other attention kernel,
          finite [300, ...] detections, the boxes' deviation and the
          slots whose validity changes (the stream rounds its canvas to
          uint8); one chunk of each profiled in turns (device ms an image,
          idle share against each one's wall time an image); the stream
          under the card's synchronisation check (at most one a chunk); 3
          images at resize scale 1 in chunks of 2 held within STREAM_TOL to
          run_batch of the same requests (a batch rounds otherwise than one
          image); the same for detect_2d_stream on a detector-only pipeline
          (the same GroundingDINO, the longest side to DETECT_SIDE) against
          _detect_batch; BATCH_N canvases
          through detect_open_vocabulary_batch over BATCH_N + 1 entries of
          the device (per-image detection within STREAM_TOL) and in one
          batch (timed; each image's Swin features within OVLIFT_MAX_REL /
          OVLIFT_MEAN_REL of the image alone, detections printed
          unchecked); then the dataset CLIs under build/stream_phase:
          eval.oracle2d --synthetic (its JSONs through merge_oracle2d),
          geo.cli --config-file --eval on tests/fixtures/tiny_omni3d.py's
          set (SAM ViT-B, f32 Depth-Pro: 12 kernel-7 and 72 f32 kernel-1
          launches an image, ms by stage) and geo.eval_cli printing the same
          AP table, eval.cli --dump-predictions (the flagship) and
          eval.predictions on the dump (the same AP2D and AP3D, to 1e-6)
  quant   the W8A8 int8 serving option: the flagship with quant="int8"
          (seed 0, weights as the slice phase) serves bench.py's request
          (OVMONO3D_QUANT=int8): 3 warm-up + 10 timed (img/s, p50, peak
          memory, 48 kernel-10, 48 quantization and 12 kernel-1 launches
          per request), a
          profile of 5; its trunk's last_feat against the same weights with
          quant="none" within the JAX package's limits (relative Frobenius <
          QUANT_REL, cosine > QUANT_COS; corners3d printed unchecked); then
          GEO with quant="int8" and gelu="tanh" in SAM ViT-H's and
          Depth-Pro's trunks (tools/bench_geo_models.py --quant int8 --gelu
          tanh; weights as the geo phase): 2 warm-up + 3 timed images (img/s,
          p50, ms per stage, peak memory, 416 kernel-10 and 416
          quantization launches per image),
          a profile of 2, and one image against the bf16 + erf trunks of the
          same weights: SAM embedding and inverse depth within GEO_QUANT_REL
          / GEO_QUANT_COS (int8 + erf, mask logits and boxes printed beside)
  ln      kernel 9 vs layer_norm_ref at LN_SHAPES (the probe's trunk at B=1
          and 8, Depth-Pro's patches, SAM-H, a Swin stage-0 map, ragged
          rows) for bf16 and f32 in and out (LN_TOL), its autograd
          Function's gradients vs the plain autograd, its time at B=8 and
          B=1 beside the plain version's, F.layer_norm's (a yardstick the
          port never calls) and the byte bound, no bf16 output more than
          one ulp off; kernel 12's v2 / v3 / v4 vs their plain versions
          (none more than one ulp off) and the control, v4's instance
          apart from v2's plain version; then the paths, each with the
          counts at 0:
          layer_norm_fused forward + backward at B=8 (one launch), and the
          probe counterpart (ovmono3d_tpu_torch.probes.layernorm) at
          [8, 4097, 768]: v0-v4 times, max|err| vs v0, bound, F.layer_norm
  sweep   kernel 11: each instance vs attn_sweep_ref at its block_k on
          peaked rows at a small ragged shape (the limit of
          probes.attn_sweep.error), two controls that must fail it (the
          bf16 softmax against the f32 plain version, the mean of v), the
          instances that differ only in block_q bit-identical, then the
          probe counterpart (ovmono3d_tpu_torch.probes.attn_sweep) at
          [1, 4097, 12, 64] with the counts at 0: each instance's time and
          SDPA's in turns by events and by the profiler's device time,
          error on peaked rows, the block_q identity, the bound
  eval    the flagship (seed 0, as the slice phase) on the eval CLI's two
          generated datasets (EVAL_IMAGES records each, random 640x480
          images made on the host) at batch EVAL_BATCH through
          eval.cli.evaluate_dataset and the helper with its 3D IoU on the
          card, oracle 2D then learned 2D: img/s, p50 of a batch, data vs
          compute time, 12 kernel-1 launches a batch, finite predictions,
          AP2D / AP3D per dataset and overall (AP2D 100 on the GT oracle),
          a profile of one batch; one batch with attention_ref: oracle 3D
          fields within 2e-2 of their scale, learned: proposals,
          detections that change and the shared ones' 3D fields printed,
          the kernel run's 2D detections lifted by both runs within 2e-2
          (the batch of the route evaluate_dataset takes); GT as the
          prediction gives AP2D = AP3D = 100
          on the card; pairwise_iou3d on the card within EVAL_IOU_ATOL of
          the CPU
  remat   the flagship unfrozen at 896^2, B=REMAT_B, 16 GT slots, SGD,
          under no remat and the policies full, dots and dots_attn
          (models/vit.py): each one's p50 ms/step of REMAT_TIMED after
          REMAT_WARMUP, device ms of one profiled step, peak memory and
          kernel-3 / kernel-4 launches a step (12 / 12 with none and
          dots_attn, 24 / 12 with full and dots: checked); one step's trunk
          gradients under each policy against no remat's on the same batch
          and draws (bit-identity printed; else held to TRAIN_GRAD_REL);
          B=REMAT_B_FULL (the default solver.ims_per_batch) under dots_attn
          for one step after one warm-up (running out of memory fails): ms
          and peak memory; under dots_attn, grad_accum_steps=REMAT_ACCUM
          micro-steps of REMAT_B against one REMAT_B_FULL step on the same
          images and draws (one batch four times, so every micro-batch
          normalizes its losses alike), and on REMAT_ACCUM distinct
          micro-batches against one plain update on the mean of their
          gradients taken alone: each parameter's update within
          TRAIN_GRAD_REL both times; the distinct micro-batches against
          one step on their images printed unchecked
  traincli  ovmono3d_tpu_torch.train.cli in-process with the shipped
          configs/OVMono3D_dinov2_SFP.yaml (trunk frozen), --synthetic,
          B=TRAINCLI_B, under build/traincli: 16 steps with --profile,
          test.eval_period=16, vis_period=8, solver.checkpoint_period=8
          (12 kernel-1 launches a step and an eval batch, no kernel 3 or 4,
          none skipped, finite in-train AP2D / AP3D, metrics.jsonl, the TB
          events read back with the port's reader, the panels' PNGs at steps
          8 and 16, the profiler trace); --resume to step 20 (4 steps ran:
          48 kernel-1 launches); --eval-only on model_final.pt (finite AP);
          4 steps with the trunk unfrozen (12 kernel-3 and 12 kernel-4
          launches a step); with cuDNN's deterministic algorithms, 4 steps
          without a group and 4 in a one-process NCCL group (MASTER_ADDR / MASTER_PORT /
          RANK / WORLD_SIZE set here): the parameters bit for bit equal;
          the CLI's loop body
          (next batch, page-locked upload, step) timed over
          TRAINCLI_RATE_STEPS steps (img/s) and profiled over 2 (idle share)
  release released-checkpoint loading at full width, from seeded state dicts
          in the released key layouts (utils/release_states.py; the weights
          the other phases move, moved likewise), each model's bytes, the
          host-side conversion time and the load time printed beside the
          card's name and power limit: the flagship's ovmono3d_lift.pth
          (detectron2 keys, priors) written under build/release_phase and
          evaluated by eval.cli --synthetic --rcnn-ckpt, oracle and learned
          2D (12 kernel-1 launches a batch, AP2D 100 on the GT oracle);
          every parameter of the model equal to its converted array bit for
          bit, its priors the file's; bench.py's request served on it (12
          kernel-1 launches a request, finite detections, kernel vs plain
          within the slice phase's limit) and kernel 1 at its first and last
          block's inputs held to attention_ref; GroundingDINO SwinB in the
          original layout ({'model': ...}, 'module.' prefixes) and a
          vocab.txt of the 50 names' words through eval.oracle2d
          --synthetic --gdino-ckpt --vocab (24 kernel-8 launches a chunk,
          its JSONs through merge_oracle2d, every parameter equal to its
          converted array); one OVMono3DLift.predict with both files loaded
          (24 kernel-8 and 12 kernel-1 launches), kernel 8 at a shifted and
          the last Swin block's inputs held to window_attention_ref, then
          the ovlift phase's comparison on it; SAM ViT-H and f32 Depth-Pro
          converted in memory through load_sam_params and
          load_depth_params (every parameter equal), one GEO request (32
          kernel-7 and 72 f32 kernel-1 launches), kernel 7 at a windowed
          and a global block's inputs held to rel_pos_attention_ref, then
          the geo phase's comparison on it
  trunks  the other detector trunks at full width and 1024^2: CLIP, MAE,
          MiDaS and SAM ViT-B + SFP from their shipped configs, DLA-34,
          ResNet-50, DenseNet-121, MNASNet 1.0 and ShuffleNetV2 + FPN over
          p2-p6 with detectron2's anchors; each trunk's released layout
          (utils/release_states.py) through load_cnn_trunk (every parameter
          and BatchNorm buffer equal to its converted array), bench.py's
          request served 1 + 3 times (finite detections; 12, 12, 24 and 12
          kernel-1 / kernel-7 launches a request for the ViTs, none for the
          CNNs), p50 and device ms a request beside the card's name and
          power limit, kernel vs plain attention on one request within the
          slice phase's limit, and kernel 1 (CLIP, MAE: [1, 4097, 12, 64];
          MiDaS: [1, 4097, 16, 64]) or kernel 7 (SAM-B: [25, 196, 12, 64]
          windowed, [1, 4096, 12, 64] global) at the first and last block's
          inputs held to its plain version and timed beside it, SDPA and the
          bound; then 2 train-CLI steps of the frozen DLA-34 detector with
          --trunk-ckpt: every trunk parameter and BatchNorm buffer still the
          file's, bit for bit
  samtrain  SAM ViT-B + SFP (configs/OVMono3D_sam_SFP.yaml) trained with
          the trunk unfrozen: kernel 7's lse instance (out, lse) and the
          rel-pos backward (dq, dk, dv, dqrh, dqrw) against
          rel_pos_attention_lse_ref / rel_pos_attention_bwd_ref at SAM-B's
          global blocks (B=2), its windowed blocks of 8 images and SAM-H's
          global blocks (D = 80), two backward launches bit-identical;
          then probes/relpos_bwd.py at the step's global and windowed
          blocks (B=8), a global block of one image and SAM-H's: each
          within its limit of the plain version (one image at a time) and
          timed by events and by the profiler's device time (the
          backward's three kernels apart) beside the plain versions, SDPA
          with the bias as a float mask (forward; forward + backward, a
          yardstick the port never calls) and the bound; with --previous,
          the backward built from DIR's relpos_flash_bwd.cu (where its
          machine code differs) timed in turns with it, within the same
          limit, and its device time above the shipped one's at every
          shape; then the
          detector from seed 0 (rel-pos tables ~N(0, 0.1^2)) at 1024^2,
          B=8, 16 GT slots, SGD: 2 warm-up + 3 timed steps (finite
          losses, none skipped, every trunk parameter
          moved, the tables among them; 12 lse-instance and 12 backward
          launches a step and no other attention kernel), p50, device ms
          and idle share of a step, peak memory, the card's name and power
          limit; one update and one flag launch of the multi-tensor SGD
          a timed step; one B=1 loss and trunk gradient with the kernels
          against rel_pos_attention_ref (bf16 and f32) as the train phase
          compares them (TRAIN_LOSS_REL, TRAIN_GRAD_REL); 2 steps of the
          train CLI on the shipped SAM config with
          model.backbone.freeze=false, --synthetic (12 + 12 attention and
          1 + 1 optimizer launches a step); last, the multi-tensor SGD
          update and flag at the step's 237 leaves (121.17 M) and the
          DINOv2 detector's 48 (probes/optim.py): parameters and trace bit
          for bit with the per-leaf update over three steps (one on views
          at an odd offset of one buffer) and a skipped one, the flag as
          the per-leaf flag on clean gradients and on a NaN and an inf;
          timed beside the per-leaf update and flag, PyTorch's _fused_sgd_
          and AMP flag, and the bound
  demo    python -m ovmono3d_tpu_torch.demo in-process on 3 seeded 640x480
          PNGs at the shipped flagship config (weights moved off the init
          as in the ovlift phase), labels "chair,table,lamp": the panels'
          shapes, 12 kernel-1 and 24 kernel-8 launches an image, predict's
          p50, device ms an image and the host's drawing ms, one panel with
          every valid slot, Swin's features and the lift on one set of
          boxes against the plain attention within the ovlift limits; then
          eval.cli --synthetic --vis-dir --vis-period 1: a [2H, 3W] panel
          for each of the 32 images, 12 kernel-1 launches a batch
  tp      kernels 1, 3 and 4 at the tensor-parallel shard shape [1, 4097,
          6, 64] (views of a half-width qkv) against their plain versions
          and timed beside the 12-head shape, with SDPA's forward or
          backward on the same views; 2 train steps of the unfrozen
          flagship at B=2 as data x model = 1 x 1 in a one-process NCCL
          group against no group, bit for bit (two runs without a group as
          the control); the dry run's entry point (parallel/dryrun.py,
          --device cuda) on the shipped flagship file with the trunk
          unfrozen, data x model = 1 x 1 in a spawned process on the card
          (a finite loss, no skip); a run across cards waits for more than
          one card
  native  the g++ build of the native batch resize, one OpenMP runtime in
          the process, 8 640x480 images through build_test_iterator on the
          native route and on the torch resize in turns (geometry equal,
          pixels within 2e-2), ms per batch of each
Then a JSON line of the kernels (kernels 1, 3 and 4 at the trunk shape also
with device_ms and library_device_ms: the device times of the kernel and of
SDPA, and with shard_ms, shard_plain_ms and
shard_library_ms: their times, their plain versions' and SDPA's at the
tensor-parallel shard shape; kernel 7 at SAM-H global, kernel
7's lse instance at SAM-B's global blocks of the B=8 train step with
device_ms and library_device_ms, the rel-pos backward there, kernel
8 at stage 0 shifted and kernel
10 at LIFT fc1 with
device_ms, previous_device_ms (the design in --previous DIR, null without
it) and library_device_ms; kernel 10's quantization in its own entry with
device_ms; kernel 1's f32 instance and kernel 11's instances with device_ms
and library_device_ms, the f32 instance also device_ms_by_shape), the
card's name and power limit, and last
{"ok": true, "device": {...}}. Any failure raises before that line and the
exit code is not 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from ovmono3d_tpu_torch.config import (  # noqa: E402
    Config,
    SolverConfig,
    flagship_config,
    load_config,
)
from ovmono3d_tpu_torch.data.build import (  # noqa: E402
    build_test_iterator,
    write_png,
)
from ovmono3d_tpu_torch.data.datasets import merge_oracle2d  # noqa: E402
from ovmono3d_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_datasets,
    synthetic_records,
)
from ovmono3d_tpu_torch.eval import cli as eval_cli  # noqa: E402
from ovmono3d_tpu_torch.eval import oracle2d, predictions  # noqa: E402
from ovmono3d_tpu_torch.evaluation.helper import (  # noqa: E402
    Omni3DEvaluationHelper,
)
from ovmono3d_tpu_torch.geo import cli as geo  # noqa: E402
from ovmono3d_tpu_torch.geo import eval_cli as geo_eval_cli  # noqa: E402
from ovmono3d_tpu_torch.models.gdino.inference import (  # noqa: E402
    build_text_inputs,
    postprocess_grounding,
)
from ovmono3d_tpu_torch.models import rcnn3d  # noqa: E402
from ovmono3d_tpu_torch.models.depth import DepthPro  # noqa: E402
from ovmono3d_tpu_torch.models.gdino.tokenizer import (  # noqa: E402
    BertTokenizer,
)
from ovmono3d_tpu_torch.models.ovmono3d import (  # noqa: E402
    OVMono3DLift,
    default_focal_K,
)
from ovmono3d_tpu_torch.models.backbones import SAM_ARCHS  # noqa: E402
from ovmono3d_tpu_torch.models.dla import DLA_PRESETS  # noqa: E402
from ovmono3d_tpu_torch.models.rcnn3d import build_model  # noqa: E402
from ovmono3d_tpu_torch.models.vit import GELUS, Mlp  # noqa: E402
from ovmono3d_tpu_torch.models.vit import remat_context  # noqa: E402
from ovmono3d_tpu_torch.ops.boxes import uniform_draws  # noqa: E402
from ovmono3d_tpu_torch.ops import attention  # noqa: E402
from ovmono3d_tpu_torch.ops import attn_sweep  # noqa: E402
from ovmono3d_tpu_torch.ops import iou3d  # noqa: E402
from ovmono3d_tpu_torch.ops import layernorm  # noqa: E402
from ovmono3d_tpu_torch.ops import optim_kernels  # noqa: E402
from ovmono3d_tpu_torch.ops import quant  # noqa: E402
from ovmono3d_tpu_torch.probes import attn_sweep as sweep_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import flash_bwd as bwd_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import flash_fwd as fwd_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import flash_fwd_f32 as f32_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import int8_gemm as int8_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import relpos as relpos_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import relpos_bwd as relpos_bwd_probe  # noqa
from ovmono3d_tpu_torch.probes import window as window_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import card as card_name  # noqa: E402
from ovmono3d_tpu_torch.probes import (  # noqa: E402
    bf16_ulp_diff, device_ms, time_ms)
from ovmono3d_tpu_torch.probes import layernorm as ln_probe  # noqa: E402
from ovmono3d_tpu_torch.probes import optim as optim_probe  # noqa: E402
from ovmono3d_tpu_torch.parallel import mesh  # noqa: E402
from ovmono3d_tpu_torch.parallel import serve as serve_batch  # noqa: E402
from ovmono3d_tpu_torch.parallel.tensor_parallel import apply_tp  # noqa: E402
from ovmono3d_tpu_torch.parallel.train_step import (  # noqa: E402
    create_train_state,
    make_train_step,
)
from ovmono3d_tpu_torch.structures import (  # noqa: E402
    Detections,
    GroundTruth,
)
from ovmono3d_tpu_torch.train.optim import (  # noqa: E402
    Optimizer, with_grad_accum)
from ovmono3d_tpu_torch.utils import cuda_build  # noqa: E402
from ovmono3d_tpu_torch.utils import flax_bridge  # noqa: E402
from ovmono3d_tpu_torch.utils import geometry as geom  # noqa: E402
from ovmono3d_tpu_torch.utils import release_states  # noqa: E402
from ovmono3d_tpu_torch.utils.gdino_convert import (  # noqa: E402
    convert_groundingdino,
)
from ovmono3d_tpu_torch.utils.lift_convert import (  # noqa: E402
    convert_ovmono3d_lift,
    extract_priors,
)
from ovmono3d_tpu_torch.utils.load import (  # noqa: E402
    load_depth_params,
    load_sam_params,
)
from ovmono3d_tpu_torch.utils.sam_convert import (  # noqa: E402
    convert_sam_encoder,
    convert_sam_segmenter,
)
from ovmono3d_tpu_torch.utils.depth_convert import (  # noqa: E402
    convert_depth_pro,
)
from ovmono3d_tpu_torch.utils.cnn_convert import (  # noqa: E402
    convert_trunk,
    load_cnn_trunk,
)

# The redesigned kernels: (source, kernel template, instances, SASS
# instructions that show the design) of the bf16 D = 64 forward (kernels 1
# and 3) and backward (4: the dk/dv and dq instances), the attention
# sweep (11, eight instances), the rel-pos forward (7, D 64 and 80, the
# inference and the lse instance of each), the window forward (8) and the
# rel-pos backward's dk/dv and dq kernels (D 64 and 80), on wgmma and TMA
# loads; the int8 product (10: raw, bf16 and f32) on s8 wgmma (IGMMA) and
# TMA loads; and kernel 1's f32 instance (FFMA; D 32 and 64) and the int8
# path's quantization (bf16 and f32 inputs).
SASS_OPS = ("HGMMA", "UTMALDG")
DESIGNS = (("flash_attn_fwd.cu", "flash_fwd_sm90_kernel", 2, SASS_OPS),
           ("flash_attn_bwd.cu", "flash_bwd_sm90_kernel", 2, SASS_OPS),
           ("attn_sweep_fwd.cu", "sweep_fwd_sm90_kernel", 8, SASS_OPS),
           ("relpos_flash_fwd.cu", "relpos_fwd_sm90_kernel", 4, SASS_OPS),
           ("window_attn_fwd.cu", "window_fwd_sm90_kernel", 2, SASS_OPS),
           ("relpos_flash_bwd.cu", "relpos_bwd_dkdv_kernel", 2, SASS_OPS),
           ("relpos_flash_bwd.cu", "relpos_bwd_dq_kernel", 2, SASS_OPS),
           ("int8_gemm.cu", "int8_gemm_sm90_kernel", 3,
            ("IGMMA", "UTMALDG")),
           ("flash_attn_fwd.cu", "flash_fwd_f32_kernel", 2, ()),
           ("int8_gemm.cu", "quantize_rows_kernel", 2, ()))
# The JSON entries of kernels 1, 3 and 4 carry, besides every kernel's
# keys, the profiler's device times of the kernel and of SDPA
# (fwd_probe.rows, bwd_probe.rows).
DESIGN_KEYS = ("device_ms", "library_device_ms")
FWD_KEYS = ("ms", "library_ms", "bound_ms", "bound_by") + DESIGN_KEYS
# The JSON entries of kernel 1's f32 instance and of kernel 11 carry the
# profiler's device times of the kernel and of SDPA (f32_probe.rows,
# sweep_probe.rows); the f32 entry also each f32 shape's.
F32_KEYS = ("device_ms", "library_device_ms", "device_ms_by_shape")
SWEEP_KEYS = ("device_ms", "library_device_ms")
# The JSON entries of kernels 7, 8 and 10 and of the rel-pos backward carry
# the profiler's device times of the kernel, of its earlier design (built
# from the copy of the sources that --previous names; null without it) and
# of the library call (relpos_probe.rows, window_probe.rows,
# int8_probe.rows, relpos_bwd_probe.rows).
PREVIOUS_KEYS = ("device_ms", "previous_device_ms", "library_device_ms")
# Kernels 1, 3 and 4: (B, N, H, D). The LIFT trunk; Depth-Pro's image and
# FOV encoders (B=1) and its patch encoder (the 35 pyramid crops in one
# batch); a small ragged case; the 128-row tile's edges: one partial tile,
# one full tile, one row past a tile; a long sequence; the JAX package's
# test shape (3 heads of 32: the D = 32 instances); the trunk again.
KERNEL_SHAPES = {"trunk": (1, 4097, 12, 64), "depth_pro": (1, 577, 16, 64),
                 "depth_pro_patches": (35, 577, 16, 64),
                 "ragged": (2, 77, 12, 64), "n64": (2, 64, 12, 64),
                 "n128": (2, 128, 12, 64), "n129": (2, 129, 12, 64),
                 "n8192": (1, 8192, 12, 64), "small": (2, 150, 3, 32),
                 "trunk_head_major": (1, 4097, 12, 64)}
# Shapes of KERNEL_SHAPES and F32_SHAPES whose q, k, v and do are views of
# head-major storage ([B, H, N, D] a tensor), the layout the JAX package's
# kernels 2, 5 and 6 take: the port runs those on kernels 1, 3 and 4.
HEAD_MAJOR = ("small", "trunk_head_major")
# Kernel 7: (B, grid, H, D). SAM ViT-H global and windowed blocks at 1024^2
# (a 64x64 grid; 14x14 windows of the grid padded to 70, 25 per image), SAM
# ViT-B's global blocks, a small ragged grid.
RELPOS_SHAPES = {"sam_h_global": (1, (64, 64), 16, 80),
                 "sam_h_window": (25, (14, 14), 16, 80),
                 "sam_b_global": (1, (64, 64), 12, 64),
                 "ragged": (2, (6, 10), 12, 64)}
REL_POS_STD = 0.1     # about a trained SAM table's scale
# Kernel 7's inference instance and the same machine code built from
# --previous DIR, timed in turns: their device times agree within this.
RELPOS_SAME_NOISE = 0.05
# The f32 instance of kernel 1: Depth-Pro's B=1 encoders and 35-crop patch
# encoder in f32 (the JAX GEO CLI's default), a small ragged case, the JAX
# package's test shape (the f32 instance at D = 32).
F32_SHAPES = {"depth_pro": (1, 577, 16, 64),
              "depth_pro_patches": (35, 577, 16, 64),
              "ragged": (2, 77, 12, 64), "small": (2, 150, 3, 32)}
# f32 kernels against f32 attention_ref: exact products on both sides,
# summed in another order.
F32_MAX_REL = 2e-5
# H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor-core rates,
# f32 on the FP32 pipes (no tensor cores) and HBM3.
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
MAX_ERR, MEAN_ERR = 2e-2, 2e-3
# Relative limits beside the absolute ones: at N=4097 the outputs are ~0.02,
# where 2e-2 absolute would pass an error of several percent.
MAX_REL, MEAN_REL = 5e-2, 1e-2
WARMUP, TIMED, PLAIN_TIMED = 3, 10, 3
S, N_BOXES = 896, 64
TRAIN_B, TRAIN_GT, TRAIN_WARMUP, TRAIN_TIMED = 8, 16, 2, 5
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-2, 5e-2
# The remat phase: the unfrozen flagship at B=REMAT_B under each policy
# (None: no remat), B=REMAT_B_FULL (the default solver.ims_per_batch) under
# dots_attn, and REMAT_ACCUM micro-steps of REMAT_B against one
# REMAT_B_FULL step.
REMAT_B, REMAT_B_FULL, REMAT_ACCUM = 8, 32, 4
REMAT_WARMUP, REMAT_TIMED = 2, 3
REMAT_POLICIES = (None, "full", "dots", "dots_attn")
# The traincli phase: the train CLI's batch, its first run's steps, the
# resumed run's end, and the steps its loop body is timed over.
TRAINCLI_B, TRAINCLI_ITERS, TRAINCLI_RESUMED = 8, 16, 20
TRAINCLI_RATE_STEPS = 5
GEO_H, GEO_W, GEO_BOXES, GEO_WARMUP, GEO_TIMED = 512, 704, 8, 2, 5
GEO_MAX_REL, GEO_MEAN_REL = 1e-1, 2e-2
GEO_F32_WARMUP, GEO_F32_TIMED = 2, 3
# f32 Depth-Pro's inverse depth, f32 kernel 1 against f32 attention_ref.
GEO_F32_REL = 1e-4
GEO_DEPTH_BIAS = 0.5   # the depth head's output bias in the geo phase
# Kernel 8: (BW, N, H) of Swin-B's four stages at 896^2 (patch grid 224,
# window 12: 19^2, 10^2, 5^2 and 3^2 windows, D = 32); the windows of maps
# smaller than the window (w^2 tokens) and a full one, 4 of each, with a
# bias of std 30.
WINDOW_SHAPES = window_probe.STAGES
WINDOW_SMALL_TOKENS, WINDOW_SMALL_BIAS_STD = (144, 121, 64, 49, 16, 1), 30.0
OV_H, OV_W, OV_WARMUP, OV_TIMED = 480, 640, 2, 5
# The stream phase: predict_stream's chunk and the OV_H x OV_W images it and
# per-image predict serve; sizes at resize scale 1 under the flagship's rule
# (shortest edge 532, longest at most 896) and under the detector-only
# pipeline's (longest side to DETECT_SIDE, build_2d_only's default canvas),
# where the stream is held to batched serving of the same requests within
# STREAM_TOL; the batch detection's N.
STREAM_CHUNK, STREAM_IMAGES, STREAM_TOL = 8, 16, 1e-5
# The timed stream's passes over its images: 8 chunks, 6 of them replayed.
STREAM_PASSES = 4
STREAM_SCALE1 = ((532, 709), (532, 896), (700, 532))
DETECT_SIDE = 800
DETECT_SCALE1 = ((600, 800), (800, 576), (800, 800))
BATCH_N = 5
# Kernel 10: (rows R, K, M) of every product of the int8 serving paths, per
# image: the LIFT trunk (DINOv2 ViT-B/14 at 896^2, 4097 tokens), SAM ViT-H at
# 1024^2 (4096 tokens in global blocks, 25 windows of 196 in windowed ones),
# Depth-Pro's ViT-L/16 patch encoder (35 crops of 577 tokens) and its image
# and FOV encoders (577); a small ragged case and two K tails.
INT8_SHAPES = {
    "lift_qkv": (4097, 768, 2304), "lift_proj": (4097, 768, 768),
    "lift_fc1": (4097, 768, 3072), "lift_fc2": (4097, 3072, 768),
    "sam_h_global_qkv": (4096, 1280, 3840),
    "sam_h_window_qkv": (4900, 1280, 3840),
    "sam_h_global_proj": (4096, 1280, 1280),
    "sam_h_window_proj": (4900, 1280, 1280),
    "sam_h_fc1": (4096, 1280, 5120), "sam_h_fc2": (4096, 5120, 1280),
    "dp_patch_qkv": (20195, 1024, 3072), "dp_patch_proj": (20195, 1024, 1024),
    "dp_patch_fc1": (20195, 1024, 4096), "dp_patch_fc2": (20195, 4096, 1024),
    "dp_image_qkv": (577, 1024, 3072), "dp_image_proj": (577, 1024, 1024),
    "dp_image_fc1": (577, 1024, 4096), "dp_image_fc2": (577, 4096, 1024),
    "ragged": (77, 64, 200),
    # K tails: a partial 128-byte k stage, R = 4097, M no multiple of a tile
    "tail_k96": (4097, 96, 328), "tail_k160": (4097, 160, 200),
}
# Kernel-10 launches per image: 4 products in each block of the trunks.
LIFT_INT8_LAUNCHES, GEO_INT8_LAUNCHES = 12 * 4, 32 * 4 + 3 * 24 * 4
# The int8 trunk against the bf16 one on the same weights: the JAX package's
# own limits (tests/test_quant.py), relative Frobenius error and cosine.
QUANT_REL, QUANT_COS = 5e-2, 0.999
QUANT_WARMUP, QUANT_TIMED = 3, 10
GEO_QUANT_WARMUP, GEO_QUANT_TIMED = 2, 3
# int8 + tanh GEO against the bf16 + erf trunks of the same weights, a guard
# of the models: twice the largest deviation of the first run on the card
# (SAM embedding 2.98e-2 relative, cosine 1 - 4.45e-4; PERF.md, Findings).
GEO_QUANT_REL, GEO_QUANT_COS = 6e-2, 0.999
OVLIFT_MAX_REL, OVLIFT_MEAN_REL = 1e-1, 2e-2
CATEGORY_META = Path(__file__).resolve().parent / "configs" / \
    "category_meta50.json"
# Kernel 9: (shape) of its checks: the TPU probe's trunk at B=1 and B=8,
# Depth-Pro's patch batch (ViT-L), SAM ViT-H, a Swin-B stage-0 map at 896^2
# (C = 128) and a ragged row count; every (input, output) dtype pair, each
# held to layer_norm_ref within LN_TOL of its output dtype (atol, rtol: the
# JAX tests' own, tests/test_layernorm.py).
LN_SHAPES = {"trunk_b1": (1, 4097, 768), "trunk_b8": (8, 4097, 768),
             "depth_pro_patches": (35, 577, 1024), "sam_h": (1, 4096, 1280),
             "swin_stage0": (1, 224, 224, 128), "ragged": (3, 77, 256)}
LN_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
             (torch.float32, torch.float32), (torch.float32, torch.bfloat16))
LN_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-6, 1e-6)}
# Kernel 11 against attn_sweep_ref at its block_k, on peaked rows
# (sweep_probe.checked_inputs) at a small ragged shape and at the probe's:
# the limit is sweep_probe.error's (at most ULP_SHARE of the elements more
# than one bf16 ulp apart, none more than ATOL); two controls must fail it.
SWEEP_SMALL = (2, 333, 4, 64)
# The eval phase: the flagship on the two generated datasets of the eval
# CLI's --synthetic (EVAL_IMAGES records each, random 640x480 images), batch
# EVAL_BATCH, oracle 2D and learned 2D; 3D IoU on the card against the CPU
# within EVAL_IOU_ATOL (f32 on both, other sum orders and FMA contraction).
EVAL_IMAGES, EVAL_BATCH = 32, 8
EVAL_IOU_ATOL = 1e-4
# Weights the ovlift phase moves off the flax init, and why: the deformable
# offset and weight kernels start at zero (every sample on its reference
# point: the bilinear path unchecked); the Swin bias tables at std 0.02
# (kernel 8's bias path unseen under bf16 rounding); the fusion layer scales
# at 1e-4 (the image-text fusion adds nothing); the box heads' last kernels
# at zero (boxes are the proposals, the queries carry no position).
OVLIFT_SETS = {"sampling_offsets / attention_weights kernels": 0.1,
               "Swin rel_pos_bias tables": 1.0,
               "fusion gamma_v / gamma_l": 0.1,
               "box heads' last kernels": 0.01}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs an NVIDIA GPU")
    card = card_name()
    # TF32 stays as PyTorch starts it: the entry points that place a model
    # on the card turn it off (utils.device.disable_tf32).
    say("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
                  f"torch {torch.__version__} cuda {torch.version.cuda}; "
                  f"TF32 at start: matmul "
                  f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                  f"{torch.backends.cudnn.allow_tf32}")
    return card


def sass_functions(lib: Path) -> dict:
    """{kernel function (mangled): its SASS lines} in `lib`, from the
    cuobjdump beside nvcc."""
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def machine_code(lib: Path) -> list:
    """The instructions of each kernel function in `lib`, one string a
    function, sorted: the functions' names are left out, as the names of an
    anonymous namespace differ from one source file to another."""
    return sorted("\n".join(line for line in lines
                            if re.match(r"\s*/\*", line))
                  for lines in sass_functions(lib).values())


def sass_counts(lib: Path, ops=SASS_OPS) -> dict:
    """{kernel function (mangled): {op: instructions}} in `lib`'s SASS."""
    return {fn: {op: sum(len(re.findall(rf"\b{op}\b", line))
                         for line in lines) for op in ops}
            for fn, lines in sass_functions(lib).items()}


def template_args(mangled: str, design: str) -> str:
    """The integer and bool template arguments of `design` in a mangled
    name, as "<64, 1, true>" ("" if none)."""
    m = re.search(rf"{design}I((?:L[bi]\d+E)+)E", mangled)
    if not m:
        return ""
    args = [("true" if val == "1" else "false") if kind == "b" else val
            for kind, val in re.findall(r"L([bi])(\d+)E", m[1])]
    return f"<{', '.join(args)}>"


def check_design(lib: Path, design: str, instances: int, ops=SASS_OPS
                 ) -> None:
    """The instances of a redesigned kernel (`design`, a kernel template's
    name): their registers, spill stores and stack frame from the
    -Xptxas -v log and, for `ops` (wgmma + TMA designs: HGMMA and
    UTMALDG), their count of those instructions in the SASS. Every count
    must be above 0, and no instance may spill or keep an array in local
    memory. ptxas's C7513 warnings (wgmma serialised) are printed."""
    text = lib.with_name(lib.name + ".log").read_text()
    log = text.splitlines()
    found = 0
    for i, line in enumerate(log):
        if "Compiling entry" in line and design in line:
            following = []
            for x in log[i + 1:i + 6]:
                if "Compiling entry" in x:
                    break
                following.append(x.strip())
            report = " ".join(following)
            spills = re.search(r"(\d+) bytes spill stores", report)
            stack = re.search(r"(\d+) bytes stack frame", report)
            regs = re.search(r"Used (\d+) registers", report)
            name = design + template_args(line, design)
            say("build", f"{name}: {regs[1] if regs else '?'} registers, "
                         f"{spills[1] if spills else '?'} bytes spill "
                         f"stores, {stack[1] if stack else '?'} bytes stack "
                         f"frame")
            check(spills is not None and spills[1] == "0",
                  f"{name} spills no registers")
            check(stack is not None and stack[1] == "0",
                  f"{name} keeps no array in local memory")
            found += 1
    check(found == instances, f"the -Xptxas -v log reports {instances} "
                              f"{design} instances (found {found})")
    for line in log:
        if "C7513" in line:
            say("build", f"{lib.stem.rsplit('_', 1)[0][3:]}: {line.strip()}")
    if not ops:
        return
    counts = {fn: c for fn, c in sass_counts(lib, ops).items()
              if design in fn}
    check(len(counts) == instances,
          f"the SASS holds {instances} {design} instances")
    for fn, c in counts.items():
        say("build", f"{design}{template_args(fn, design)}: "
                     + ", ".join(f"{c[op]} {op}" for op in ops))
        check(all(c[op] > 0 for op in ops),
              f"{fn} runs on wgmma (HGMMA) and TMA (UTMALDG)")


def build_phase() -> None:
    t0 = time.perf_counter()
    sources = (attention.KERNEL_SOURCES + quant.KERNEL_SOURCES
               + layernorm.KERNEL_SOURCES + attn_sweep.KERNEL_SOURCES
               + optim_kernels.KERNEL_SOURCES)
    built = cuda_build.build(sources)                  # one nvcc each, at once
    libs = list(built.values())
    for mod in (attention, quant, layernorm, attn_sweep, optim_kernels):
        mod.build_kernels()
    say("build", f"{', '.join(lib.name for lib in libs)} ready in "
                 f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        log = lib.with_name(lib.name + ".log")
        if log.is_file() and lib.name.startswith("liblayernorm"):
            # 76 instances: their largest register count and any spill.
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = sorted(set(re.findall(r"(\d+) bytes spill stores",
                                           text)) - {"0"})
            say("build", f"layernorm_fwd: {len(regs)} instances of "
                         f"ln_fwd_kernel, at most {max(regs)} registers, "
                         f"spill stores {spills or 'none'} bytes")
        elif log.is_file():
            for line in log.read_text().splitlines():
                m = re.search(r"((flash|relpos|window|int8|sweep|quantize)"
                              r"_[a-z0-9_]+_kernel)"
                              r"(IL([bi])(\d+)E)?", line)
                if "Compiling entry" in line and m:
                    flag = "" if m[4] is None else (
                        f"<{m[5]}>" if m[4] == "i"
                        else "<true>" if m[5] == "1" else "<false>")
                    say("build", f"{lib.stem.rsplit('_', 1)[0][3:]}: "
                                 f"{m[1]}{flag}")
                elif "registers" in line or "spill" in line:
                    say("build", "  " + line.strip())
    for source, design, instances, ops in DESIGNS:
        check_design(built[source], design, instances, ops)


def qkv_views(b, n, h, d, seed, dtype=torch.bfloat16, head_major=False):
    """q, k, v [B, N, H, D] ~ N(0, 1): views of the qkv projection's packed
    [B, N, 3, H, D] output, or with `head_major` of [B, 3, H, N, D]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if head_major:
        qkv = torch.randn(b, 3, h, n, d, device="cuda", generator=g,
                          dtype=dtype)
        return qkv.transpose(2, 3).unbind(1)
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=g,
                      dtype=dtype)
    return qkv.view(b, n, 3, h, d).unbind(2)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                absolute: bool = False) -> float:
    """Hold `got` to `want` under the relative limits (and, for kernel 1's
    bf16 outputs, the absolute ones too); returns the max abs error."""
    got, want = got.float(), want.float()
    err, ref = (got - want).abs(), want.abs()
    mx, mean = err.max().item(), err.mean().item()
    ref_mx, ref_mean = ref.max().item(), ref.mean().item()
    say("kernel", f"{name}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e}; "
                  f"max/mean |ref| {ref_mx:.3e} / {ref_mean:.3e}")
    check(bool(torch.isfinite(got).all()), f"{name}: finite output")
    if absolute:
        check(mx <= MAX_ERR and mean <= MEAN_ERR,
              f"{name}: error within {MAX_ERR} max / {MEAN_ERR} mean")
    check(mx <= MAX_REL * ref_mx and mean <= MEAN_REL * ref_mean,
          f"{name}: error within {MAX_REL} of max |ref| and {MEAN_REL} "
          f"of mean |ref|")
    return mx


def bound_ms(b: int, n: int, h: int, d: int, kind: str,
             dtype=torch.bfloat16) -> tuple[float, str]:
    """The least time the card could take for attention's work at [B, N, H,
    D]: the larger of the compute time (4 B H N^2 D flops forward, 10
    B H N^2 D backward: the JAX kernels' cost estimates; bf16 at the
    tensor-core peak, f32 at the FP32 pipes' peak, the f32 instance's
    basis) and the memory time (each input read once, each output written
    once)."""
    elems = b * n * h * d
    size = torch.tensor([], dtype=dtype).element_size()
    if kind == "bwd":
        flops = 10 * b * h * n * n * d
        nbytes = 8 * elems * size + 2 * b * h * n * 4   # q k v o do dq dk dv; lse, delta
    else:
        flops = 4 * b * h * n * n * d
        nbytes = 4 * elems * size + (b * h * n * 4 if kind == "lse" else 0)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_views(q, k, v):
    """The same strided views in SDPA's [B, H, N, D] layout (no copy)."""
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def sdpa_bwd_ms(q, k, v, do) -> float:
    """SDPA's backward alone: one forward with autograd, then the timed
    gradient calls reuse its graph."""
    with torch.enable_grad():
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(*sdpa_views(qg, kg, vg))
        do_t = do.transpose(1, 2)
        return time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do_t, retain_graph=True))


def check_f32(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold an f32 kernel's output to the f32 plain version within
    F32_MAX_REL of max |ref|; returns the max abs error."""
    err, ref = (got - want).abs(), want.abs()
    mx, ref_mx = err.max().item(), ref.max().item()
    say("kernel", f"{name}: max_abs_err {mx:.3e} mean_abs_err "
                  f"{err.mean().item():.3e}; max |ref| {ref_mx:.3e} "
                  f"(limit {F32_MAX_REL} of it, margin "
                  f"{F32_MAX_REL * ref_mx / max(mx, 1e-30):.1f}x)")
    check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
          f"{name}: finite f32 output")
    check(mx <= F32_MAX_REL * ref_mx,
          f"{name}: error within {F32_MAX_REL} of max |ref|")
    return mx


def kernel_phase() -> dict:
    """Kernels 1, 3 and 4 against their plain versions at KERNEL_SHAPES
    (on head-major views at HEAD_MAJOR), then their times at the trunk
    shape. Launches made here are not the main path's: the paths reset the
    counts before they run."""
    worst = {"fwd": 0.0, "lse": 0.0, "bwd": 0.0}
    for i, (name, shape) in enumerate(KERNEL_SHAPES.items()):
        q, k, v = qkv_views(*shape, seed=i, head_major=name in HEAD_MAJOR)
        do = qkv_views(*shape, seed=100 + i, head_major=name in HEAD_MAJOR)[0]
        with torch.no_grad():
            got = attention.flash_attention_packed(q, k, v)
            worst["fwd"] = max(worst["fwd"], check_close(
                f"k1 {name} {shape} out", got,
                attention.attention_ref(q, k, v), absolute=True))
            o, lse = attention.flash_attention_packed_lse(q, k, v)
            want_o, want_lse = attention.attention_lse_ref(q, k, v)
            worst["lse"] = max(worst["lse"],
                               check_close(f"k3 {name} out", o, want_o),
                               check_close(f"k3 {name} lse", lse, want_lse))
            grad = attention.flash_attention_packed_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            want = attention.attention_bwd_ref(q, k, v, o, lse, do)
            for g, w, gname in zip(grad.unbind(2), want, ("dq", "dk", "dv")):
                worst["bwd"] = max(worst["bwd"], check_close(
                    f"k4 {name} {gname}", g, w))
            # Kernel 4's stats pass alone against its plain version: delta
            # summed in another order, lse2 the same f32 product.
            stats = attention._bwd_stats(o, do, lse)
            want_stats = attention.attention_bwd_stats_ref(
                o, do, lse, n_pad=stats.shape[-1])
            check_close(f"k4 {name} stats delta", stats[0], want_stats[0])
            check(torch.allclose(stats[1], want_stats[1], rtol=1e-6,
                                 atol=0), f"k4 {name}: lse2 and its +inf "
                                          f"padding equal the plain version")
            del grad, want, want_o, want_lse, stats, want_stats
    # Kernels 1 and 3 at fwd_probe.SHAPES: the kernel and SDPA in turns, by
    # events and by device time.
    fwd_rows = fwd_probe.rows()
    for name, by_kind in fwd_rows.items():
        for kind, r in by_kind.items():
            say("kernel", fwd_probe.describe(name, kind, r))
        check(by_kind["fwd"]["max_abs_err"] <= MAX_ERR,
              f"k1/k3 {name}: out within {MAX_ERR} of the plain version")
    # Kernel 4 at bwd_probe.SHAPES: the same, against attention_bwd_ref.
    bwd_rows = bwd_probe.rows()
    for name, r in bwd_rows.items():
        say("kernel", bwd_probe.describe(name, r))
        check(r["max_rel"] <= MAX_REL and r["mean_rel"] <= MEAN_REL,
              f"k4 {name}: within {MAX_REL} of max |ref| and {MEAN_REL} of "
              f"mean |ref|")
    b, n, h, d = KERNEL_SHAPES["trunk"]
    q, k, v = qkv_views(b, n, h, d, seed=0)
    do = qkv_views(b, n, h, d, seed=100)[0]
    out = {kind: {key: val for key, val in fwd_rows["trunk"][kind].items()
                  if key in FWD_KEYS} for kind in ("fwd", "lse")}
    with torch.no_grad():
        o, lse = attention.flash_attention_packed_lse(q, k, v)
        out["fwd"]["plain_ms"] = time_ms(
            lambda: attention.attention_ref(q, k, v))
        out["lse"]["plain_ms"] = time_ms(
            lambda: attention.attention_lse_ref(q, k, v))
        bwd_ms = time_ms(
            lambda: attention.flash_attention_packed_bwd(q, k, v, o, lse, do))
        bwd_plain = time_ms(
            lambda: attention.attention_bwd_ref(q, k, v, o, lse, do), reps=5)
    out["bwd"] = {"ms": bwd_ms, "plain_ms": bwd_plain,
                  "library_ms": sdpa_bwd_ms(q, k, v, do),
                  **{key: bwd_rows["trunk"][key] for key in DESIGN_KEYS}}
    for kind in ("fwd", "lse", "bwd"):
        out[kind]["max_abs_err"] = worst[kind]
        out[kind]["bound_ms"], out[kind]["bound_by"] = bound_ms(b, n, h, d,
                                                                kind)
        say("kernel", f"trunk {KERNEL_SHAPES['trunk']} {kind}, median of "
                      f"timed calls: kernel {out[kind]['ms']:.4f} ms, plain "
                      f"{out[kind]['plain_ms']:.4f} ms, SDPA "
                      f"{out[kind]['library_ms']:.4f} ms, bound "
                      f"{out[kind]['bound_ms']:.4f} ms "
                      f"({out[kind]['bound_by']})")
    return out


def timing(name: str, fwd, plain, library, bound: tuple[float, str]
           ) -> dict:
    """ms of the kernel call, its plain version and the library yardstick,
    with the bound beside them, printed on one line."""
    out = {"ms": time_ms(fwd), "plain_ms": time_ms(plain, reps=20),
           "library_ms": time_ms(library), "bound_ms": bound[0],
           "bound_by": bound[1]}
    say("kernel", f"{name}, median of timed calls: kernel {out['ms']:.4f} "
                  f"ms, plain {out['plain_ms']:.4f} ms, SDPA "
                  f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
                  f"ms ({out['bound_by']})")
    return out


def f32_kernel_phase() -> dict:
    """Kernel 1's f32 instance at F32_SHAPES (on head-major views at
    HEAD_MAJOR) against f32 attention_ref, its time at Depth-Pro's 35-crop
    shape beside the plain version's, SDPA's on the same views (a yardstick
    the port never calls) and the bound; then by the profiler's device time
    beside SDPA's at F32_SHAPES and the f32 trunk (f32_probe.rows). Returns
    the JSON entry's numbers."""
    worst = 0.0
    with torch.no_grad():
        for i, (name, shape) in enumerate(F32_SHAPES.items()):
            q, k, v = qkv_views(*shape, seed=200 + i, dtype=torch.float32,
                                head_major=name in HEAD_MAJOR)
            worst = max(worst, check_f32(
                f"k1 f32 {name} {shape}",
                attention.flash_attention_packed(q, k, v),
                attention.attention_ref(q, k, v)))
        b, n, h, d = F32_SHAPES["depth_pro_patches"]
        q, k, v = qkv_views(b, n, h, d, seed=201, dtype=torch.float32)
        out = timing(
            f"k1 f32 depth_pro_patches {(b, n, h, d)}",
            lambda: attention.flash_attention_packed(q, k, v),
            lambda: attention.attention_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(*sdpa_views(q, k, v)),
            bound_ms(b, n, h, d, "fwd", torch.float32))
        # By the profiler's device time, in turns with SDPA's f32 forward,
        # at every f32 shape and the f32 trunk.
        f32_rows = f32_probe.rows({**F32_SHAPES,
                                   "trunk": KERNEL_SHAPES["trunk"]})
        for name, r in f32_rows.items():
            say("kernel", "k1 f32 " + f32_probe.describe(name, r))
            check(r["max_rel"] <= F32_MAX_REL,
                  f"k1 f32 {name}: within {F32_MAX_REL} of max |ref|")
        out.update(
            max_abs_err=worst,
            device_ms=f32_rows["depth_pro_patches"]["device_ms"],
            library_device_ms=f32_rows["depth_pro_patches"][
                "library_device_ms"],
            device_ms_by_shape={
                name: {key: r[key] for key in (
                    "shape", "device_ms", "library_device_ms", "bound_ms")}
                for name, r in f32_rows.items()})
    return {"fwd_f32": out}


def kernel_sources(csrc: Path, source: str) -> dict:
    """{file name: bytes, or None where missing} of `source` in the
    directory `csrc` and of every header it includes from there, followed
    through the headers' own includes."""
    out: dict = {}
    todo = [source]
    while todo:
        name = todo.pop()
        if name in out:
            continue
        path = csrc / name
        out[name] = path.read_bytes() if path.is_file() else None
        if out[name] is not None:
            todo += [m.decode() for m in
                     re.findall(rb'#include "([^"]+)"', out[name])]
    return out


def earlier_design(previous: str | None, source: str) -> str | None:
    """`previous` when the library built from that directory's copy of
    `source` (with the headers it includes from there) holds other machine
    code than the shipped one: a kernel's earlier design, timed beside it.
    Where the sources are the shipped ones, or differ only where no kernel
    of `source` changes (a header gaining functions it does not call),
    there is no earlier design to compare, and that kernel is timed alone."""
    if previous is None:
        return None
    if (kernel_sources(Path(previous), source)
            == kernel_sources(cuda_build.CSRC, source)):
        say("kernel", f"{source} and its headers in {previous} are the "
                      f"shipped ones: no earlier design to time beside it")
        return None
    libs = [cuda_build.build([source], csrc)[source]
            for csrc in (Path(previous), cuda_build.CSRC)]
    if machine_code(libs[0]) == machine_code(libs[1]):
        say("kernel", f"{source} in {previous} differs from the shipped one "
                      f"(or a header it includes does) but builds to the same "
                      f"SASS: no earlier design to time beside it")
        return None
    return previous


def relpos_kernel_phase(previous: str | None) -> dict:
    """Kernel 7 against rel_pos_attention_ref at the four shapes, then
    through probes/relpos.py at SAM-H's global and windowed shapes: the
    kernel, its earlier design (with --previous) and SDPA with the bias in
    turns, by events and by the profiler's device time, with the bound; the
    new design's device time below the earlier one's at both. Returns the
    global shape's numbers (the JSON line's) with the worst error over all
    shapes."""
    worst = 0.0
    with torch.no_grad():
        for i, (name, (b, grid, h, d)) in enumerate(RELPOS_SHAPES.items()):
            q, k, v, rh, rw, qrh, qrw = relpos_probe.inputs(b, grid, h, d, i)
            got = attention.rel_pos_flash_attention(q, k, v, qrh, qrw, grid)
            torch.cuda.synchronize()
            bias = (qrh[..., :, None] + qrw[..., None, :]).float()
            worst = max(worst, check_close(
                f"k7 {name} {(b, grid, h, d)} out (bias std "
                f"{bias.std().item():.3f})", got,
                attention.rel_pos_attention_ref(q, k, v, rh, rw, grid),
                absolute=True))
            del got, bias
    previous = earlier_design(previous, "relpos_flash_fwd.cu")
    # Whether every kernel of the earlier library is one of the shipped
    # library's, instruction for instruction: the inference instances
    # unchanged beside new ones (the lse instances). Then the two are timed
    # as the same machine code, and their device times must agree within
    # RELPOS_SAME_NOISE instead of the new one being below.
    same = previous is not None and set(machine_code(cuda_build.build(
        ["relpos_flash_fwd.cu"], Path(previous))["relpos_flash_fwd.cu"])) <= \
        set(machine_code(cuda_build.build(["relpos_flash_fwd.cu"])[
            "relpos_flash_fwd.cu"]))
    if same:
        say("kernel", f"k7: every kernel of {previous}'s relpos_flash_fwd.cu "
                      f"is one of the shipped library's, instruction for "
                      f"instruction (the inference instances unchanged)")
    rows = relpos_probe.rows(previous=previous)
    for name, r in rows.items():
        say("kernel", "k7 " + relpos_probe.describe(name, r))
        check(r["ok"], f"k7 {name}: within the probe's limits of the plain "
                       f"version")
        if previous is not None and same:
            ratio = r["device_ms"] / r["previous_device_ms"]
            say("kernel", f"k7 {name}: shipped / earlier device time "
                          f"{ratio:.4f} (the same machine code)")
            check(r["previous_ok"] and abs(ratio - 1) <= RELPOS_SAME_NOISE,
                  f"k7 {name}: the earlier library within the limits and "
                  f"the same code's device times within "
                  f"{RELPOS_SAME_NOISE:.0%} of each other")
        elif previous is not None:
            check(r["previous_ok"]
                  and r["device_ms"] < r["previous_device_ms"],
                  f"k7 {name}: the earlier design within the limits and the "
                  f"wgmma design's device time below it")
    out = dict(rows["sam_h_global"])
    out.setdefault("previous_device_ms", None)
    return {**out, "max_abs_err": worst}


def window_kernel_phase(previous: str | None) -> dict:
    """Kernel 8 against window_attention_ref at Swin-B's stage shapes, with
    and without region ids; at the windows of a map smaller than Swin's
    (N = w^2 < 144) and at N = 144 with a bias of std 30 (one-hot rows), with
    random ids; and past 144 tokens (the mma.sync instance). Then through
    probes/window.py at all four stages, shifted and unshifted: the kernel,
    its earlier design (with --previous) and SDPA with the bias and mask in
    turns, by events and by the profiler's device time, with the bound; the
    new design's device time below the earlier one's everywhere and below
    SDPA's at stages 0 and 2. Returns stage 0's shifted numbers (the JSON
    line's) with the worst error over all cases."""
    worst = 0.0
    cases = [(name, shape, shifted, 1.0)
             for name, shape in WINDOW_SHAPES.items()
             for shifted in (True, False)]
    cases += [(f"small_map_n{n}", (4, n, 4), True, WINDOW_SMALL_BIAS_STD)
              for n in WINDOW_SMALL_TOKENS]
    cases += [("n196", (4, 196, 4), True, 1.0),
              ("n196", (4, 196, 4), False, 1.0)]
    with torch.no_grad():
        for i, (name, (bw, n, h), shifted, std) in enumerate(cases):
            small = name.startswith("small_map")
            q, k, v, bias, ids = window_probe.inputs(
                bw, n, h, i, shifted and not small and n == 144, std)
            if small or n != 144:
                g = torch.Generator(device="cuda").manual_seed(3000 + i)
                ids = (torch.randint(0, 3, (bw // 2, n), device="cuda",
                                     generator=g, dtype=torch.int32)
                       if shifted else None)
            got = attention.window_flash_attention(q, k, v, bias, ids)
            torch.cuda.synchronize()
            # A one-hot softmax returns single entries of v (up to ~5),
            # where a bf16 ulp exceeds the absolute limit: relative only.
            worst = max(worst, check_close(
                f"k8 {name} {(bw, n, h, 32)} ids={ids is not None} "
                f"{attention.window_kernel_instance(n)} out (bias std "
                f"{std})", got,
                attention.window_attention_ref(q, k, v, bias, ids),
                absolute=not small))
            del got
    previous = earlier_design(previous, "window_attn_fwd.cu")
    rows = window_probe.rows(previous=previous)
    for name, r in rows.items():
        say("kernel", "k8 " + window_probe.describe(name, r))
        check(r["ok"], f"k8 {name}: within the probe's limits of the plain "
                       f"version")
        if previous is not None:
            check(r["previous_ok"]
                  and r["device_ms"] < r["previous_device_ms"],
                  f"k8 {name}: the earlier design within the limits and the "
                  f"wgmma design's device time below it")
        if name.startswith(("stage0", "stage2")):
            check(r["device_ms"] < r["library_device_ms"],
                  f"k8 {name}: device time below SDPA with the bias and "
                  f"mask")
    out = dict(rows["stage0_shifted"])
    out.setdefault("previous_device_ms", None)
    return {**out, "max_abs_err": worst}


def int8_kernel_phase(previous: str | None) -> dict:
    """Kernel 10 against its plain version at every INT8_SHAPES shape: the
    int32 accumulator exact (torch.equal with
    int8_mm_ref) and the bf16 dequantized product within 1 bf16 ulp of
    dequantize_ref; the activation's quantization kernel equal to
    quantize_int8. Then probes/int8_gemm.py at its shapes (LIFT's four
    products, SAM-H's fc1, Depth-Pro's patch qkv): the product, the
    quantization kernel, the earlier design (with --previous),
    torch._int_mm alone and with the same epilogue in torch ops, and bf16
    F.linear (yardsticks the port never calls) in turns, by events and by
    the profiler's device time, with the bounds; the new design's device
    time below the earlier one's at every shape. Returns LIFT fc1's numbers
    for the product and the quantization (the JSON line's) with the worst
    error over all shapes."""
    worst, worst_ulp = 0.0, 0
    with torch.no_grad():
        for i, (name, (r, k, m)) in enumerate(INT8_SHAPES.items()):
            op = int8_probe.operands(r, k, m, seed=i)
            c = int8_probe.check(op)
            torch.cuda.synchronize()
            say("kernel", f"k10 {name} [{r}, {k}] x [{m}, {k}]: raw equal "
                          f"{c['raw_equal']}, dequant max {c['ulps']} bf16 "
                          f"ulp (max_abs_err {c['max_abs_err']:.3e}); "
                          f"quantization equal {c['quant_equal']}")
            check(c["raw_equal"] and c["ulps"] <= 1,
                  f"k10 {name}: raw equal to int8_mm_ref, dequant within 1 "
                  f"bf16 ulp")
            worst = max(worst, c["max_abs_err"])
            worst_ulp = max(worst_ulp, c["ulps"])
            check(c["quant_equal"], f"k10 {name}: the quantization kernel "
                                    f"equal to quantize_int8")
            del op
    previous = earlier_design(previous, "int8_gemm.cu")
    rows = int8_probe.rows(previous=previous)
    for name, r in rows.items():
        say("kernel", "k10 " + int8_probe.describe(name, r))
        check(r["raw_equal"] and r["ulps"] <= 1 and r["quant_equal"],
              f"k10 {name}: the probe's checks")
        if previous is not None:
            check(r["previous_ulps"] <= 1
                  and r["device_ms"] < r["previous_device_ms"],
                  f"k10 {name}: the earlier design within 1 ulp and the "
                  f"wgmma design's device time below it")
    r = rows["lift_fc1"]
    gemm = {key: r.get(key) for key in (
        "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
        "previous_device_ms", "bound_ms", "bound_by")}
    quantize = {"ms": r["quant_ms"], "device_ms": r["quant_device_ms"],
                "plain_ms": r["quant_plain_ms"], "library_ms": None,
                "bound_ms": r["quant_bound_ms"], "bound_by": "bytes",
                "max_abs_err": 0.0}
    return {**gemm, "max_abs_err": worst, "max_ulps": worst_ulp,
            "quantize": quantize}


def bench_inputs(side: int = S):
    """bench.py's request: B=1, 64 oracle boxes, K with f=1000 at side^2
    (896^2 by default)."""
    dev = "cuda"
    K = torch.tensor([[[1000.0, 0, side / 2], [0, 1000.0, side / 2],
                       [0, 0, 1]]], device=dev)
    boxes = (torch.tensor([50.0, 50.0, 400.0, 400.0], device=dev)
             + torch.arange(N_BOXES, device=dev, dtype=torch.float32)[:, None]
             )[None]
    return dict(
        K=K,
        im_hw=torch.full((1, 2), side, dtype=torch.int32, device=dev),
        im_scale_ratio=torch.ones(1, device=dev),
        oracle_boxes=boxes,
        oracle_classes=torch.zeros(1, N_BOXES, dtype=torch.int32, device=dev),
        oracle_scores=torch.full((1, N_BOXES), 0.9, device=dev),
        oracle_valid=torch.ones(1, N_BOXES, dtype=torch.bool, device=dev),
    )


def serve(model, images, inputs):
    """One request per image; returns (detections, latencies in s)."""
    dets, lats = [], []
    for img in images:
        t0 = time.perf_counter()
        det = model(img, **inputs)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
        dets.append(det)
    return dets, lats


def check_detections(det) -> None:
    for name, x in det.items():
        check(tuple(x.shape[:2]) == (1, N_BOXES),
              f"{name} shape {tuple(x.shape)} starts [1, {N_BOXES}]")
        check(bool(torch.isfinite(x.float()).all()), f"{name} finite")


def rate(lats) -> str:
    return (f"{len(lats) / sum(lats):.3f} img/s, p50 "
            f"{statistics.median(lats) * 1e3:.3f} ms over {len(lats)}")


IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def lift_model(cfg):
    """The serving model of `cfg` from seed 0 in eval mode, its LayerScales
    at 0.1 and its pose bias at the identity's 6D vector.

    Trained LayerScales are orders of magnitude above the 1e-5 init; at
    1e-5 every block's output falls below bf16's resolution in the residual
    stream, and a kernel-vs-plain comparison would see no difference
    whatever the kernel computed. At its zero init the 6D outputs are ~1e-3
    and Gram-Schmidt turns bf16 rounding anywhere upstream into
    percent-level rotation changes, which would drown the comparison."""
    model = build_model(cfg, device="cuda", seed=0).eval()
    with torch.no_grad():
        for blk in model.backbone.vit.blocks():
            blk.ls1.gamma.fill_(0.1)
            blk.ls2.gamma.fill_(0.1)
        model.cube_head.pose.bias.copy_(torch.tensor(IDENTITY_6D))
    return model


def slice_phase():
    """Returns the model, its images and request inputs, the kernel's
    launches in the timed run and that run's p50 in ms."""
    t0 = time.perf_counter()
    model = lift_model(flagship_config(S))
    n_blocks = len(model.backbone.vit.blocks())
    say("slice", f"flagship model (896^2, 50 classes, seed 0) built in "
                 f"{time.perf_counter() - t0:.1f} s")
    inputs = bench_inputs()
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(WARMUP + TIMED, 1, S, S, 3, device="cuda",
                        generator=g) * 255.0
    with torch.inference_mode():
        serve(model, images[:WARMUP], inputs)
        torch.cuda.reset_peak_memory_stats()
        attention.flash_attention_packed.launches = 0
        dets, lats = serve(model, images[WARMUP:], inputs)
        launches = attention.flash_attention_packed.launches
        peak = torch.cuda.max_memory_allocated()
        check(launches == n_blocks * TIMED,
              f"{launches} kernel launches for {TIMED} forwards of "
              f"{n_blocks} blocks")
        for det in dets:
            check_detections(det)
        say("slice", f"kernel path: {rate(lats)}; {launches // TIMED} "
                     f"launches per forward; peak memory {peak} bytes")

        set_attention(model, attention.attention_ref)
        torch.cuda.reset_peak_memory_stats()
        plain, plain_lats = serve(
            model, images[WARMUP - 1:WARMUP + PLAIN_TIMED], inputs)
        check(attention.flash_attention_packed.launches == launches,
              "the plain run launched no kernel")
        peak_plain = torch.cuda.max_memory_allocated()
        check_detections(plain[1])
        say("slice", f"plain path: {rate(plain_lats[1:])}; peak memory "
                     f"{peak_plain} bytes")
        devs = {}
        for field in ("center_cam", "dimensions", "corners3d"):
            a, b = getattr(dets[0], field), getattr(plain[1], field)
            devs[field] = ((a - b).abs().max().item(), b.abs().max().item())
        say("slice", "kernel vs plain, same image: max abs deviation " + ", ".join(
            f"{f} {d:.3e} (scale {s:.3e})" for f, (d, s) in devs.items()))
    set_attention(model, attention.dot_product_attention)
    # Both paths round to bf16 at different points in every block (the
    # kernel's bf16 probabilities are unnormalized); 2e-2 of each field's
    # scale.
    for field, (dev, scale) in devs.items():
        check(dev <= 2e-2 * scale + 1e-4,
              f"{field}: kernel vs plain deviation {dev} within 2e-2 of "
              f"scale {scale}")
    return model, images, inputs, launches, statistics.median(lats) * 1e3


def set_attention(model, fn) -> None:
    """Route every trunk block's attention through `fn(q, k, v)`, or the
    port's dispatcher when fn is attention.dot_product_attention."""
    packed = (fn if fn is attention.dot_product_attention
              else lambda qkv: fn(*qkv.unbind(2)))
    for blk in model.backbone.vit.blocks():
        blk.attn.attn_fn = packed


def profile_phase(model, images, inputs, p50_ms: float) -> None:
    """torch.profiler over serving requests of the kernel path."""
    with torch.inference_mode():
        serve(model, images[:1], inputs)
        device_profile("profile", lambda: serve(model, images, inputs),
                       len(images), p50_ms, per="image", repeat=1)


def device_profile(phase: str, run, n: int, p50_ms: float,
                   per: str = "step", repeat: int | None = None) -> float:
    """torch.profiler over `run` (one call covers n items, or n calls of
    one item each when repeat is None). Device time is summed over the
    device's own events; each is put under the aten op that launched it, or
    under its own name when no aten op did (the ctypes-launched kernels).
    Returns the device's busy ms per item."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n if repeat is None else repeat):
            run()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    by_op = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op = e
        while op is not None and not op.name.startswith("aten::"):
            op = op.cpu_parent
        key = e.name if op is None else op.name
        for kern in e.kernels:
            by_op[key] = by_op.get(key, 0.0) + kern.duration
            by_name[kern.name] = by_name.get(kern.name, 0.0) - kern.duration
    for name, us in by_name.items():      # launched by no aten op
        if us > 0.5:
            by_op[name] = by_op.get(name, 0.0) + us
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / n
    check(busy > 0, "the profiler saw device time")
    say(phase, f"{n} {per}s profiled: device busy {busy:.3f} ms per {per}, "
               f"{len(device) / n:.0f} device ops per {per}; against the "
               f"p50 of {p50_ms:.3f} ms the device idles "
               f"{max(0.0, 1 - busy / p50_ms):.1%}")
    for key, us in sorted(by_op.items(), key=lambda kv: -kv[1])[:12]:
        ms = us / 1e3 / n
        say(phase, f"  {ms:8.3f} ms/{per} {ms / busy:6.1%}  {key[:90]}")
    return busy


def attention_f32_probs(q, k, v):
    """attention_ref with the probabilities and the PV product kept in f32."""
    return attention.attention_ref(q.float(), k.float(), v.float()).to(q.dtype)


def sensitivity_phase(model, image, inputs) -> None:
    """How far bf16 rounding inside attention moves corners3d, with the pose
    bias at its zero init and at the identity's 6D vector."""
    bias = model.cube_head.pose.bias
    for label, value in (("zero init", (0.0,) * 6), ("identity", IDENTITY_6D)):
        with torch.no_grad():
            bias.copy_(torch.tensor(value))
        out = {}
        with torch.inference_mode():
            for name, fn in (("kernel", attention.dot_product_attention),
                             ("plain", attention.attention_ref),
                             ("f32_probs", attention_f32_probs)):
                set_attention(model, fn)
                out[name] = model(image, **inputs).corners3d.float()
        scale = out["plain"].abs().max().item()
        rel = {pair: (out[pair[0]] - out[pair[1]]).abs().max().item() / scale
               for pair in (("kernel", "plain"), ("plain", "f32_probs"))}
        say("sensitivity", f"pose bias {label}: corners3d max abs deviation, "
                           f"of its scale {scale:.3e}: kernel vs plain "
                           f"{rel['kernel', 'plain']:.2%}, plain vs f32 "
                           f"probabilities {rel['plain', 'f32_probs']:.2%}")
    set_attention(model, attention.dot_product_attention)
    reduced_precision_reduction(model, image, inputs)
    tf32_conv_error(model)


def tf32_conv_error(model) -> None:
    """The RPN head's f32 conv against a float64 conv: with the flags as
    build_model left them (TF32 off) within 1e-5 relative; with cuDNN's
    TF32 (PyTorch's default) printed beside."""
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "build_model turned TF32 off")
    conv = model.rpn_head.conv
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, conv.in_channels, 112, 112, device="cuda", generator=g)
    errs = {}
    with torch.no_grad():
        want = F.conv2d(x.double(), conv.weight.double(),
                        conv.bias.double(), padding=1)
        try:
            for name, tf32 in (("off", False), ("on", True)):
                torch.backends.cudnn.allow_tf32 = tf32
                got = conv(x).double()
                errs[name] = ((got - want).norm() / want.norm()).item()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    say("sensitivity", f"RPN conv {tuple(x.shape)} f32 vs float64, "
                       f"||diff|| / ||ref||: TF32 off (as build_model sets "
                       f"it) {errs['off']:.3e} (limit 1e-5), cuDNN TF32 on "
                       f"{errs['on']:.3e}")
    check(errs["off"] <= 1e-5, "f32 conv within 1e-5 of float64")


def reduced_precision_reduction(model, image, inputs) -> None:
    """How far cuBLAS's reduced-precision reductions in bf16 products
    (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    True by default; the JAX package accumulates in f32) move the trunk's
    last_feat, against bf16 noise: the same trunk with attention_ref in
    place of the kernel. Printed, not checked; the flag is left as it
    was."""
    feats = {}
    name = ""
    hook = model.backbone.vit.register_forward_hook(
        lambda mod, args, out: feats.__setitem__(name, out["last_feat"]))
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        with torch.inference_mode():
            for name, reduced, fn in (
                    ("on", True, attention.dot_product_attention),
                    ("off", False, attention.dot_product_attention),
                    ("plain", True, attention.attention_ref)):
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = reduced
                set_attention(model, fn)
                model(image, **inputs)
    finally:
        hook.remove()
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
        set_attention(model, attention.dot_product_attention)
    rel, cos = rel_cos(feats["off"], feats["on"])
    noise, noise_cos = rel_cos(feats["plain"], feats["on"])
    say("sensitivity", f"bf16 reduced-precision reduction on vs off: "
                       f"last_feat {tuple(feats['on'].shape)} ||diff|| / "
                       f"||ref|| {rel:.3e}, cosine {cos:.6f}, bit-identical "
                       f"{torch.equal(feats['on'], feats['off'])}; bf16 "
                       f"noise (kernel vs attention_ref, flag on) {noise:.3e}"
                       f", cosine {noise_cos:.6f}")


def synthetic_batch(b: int, m: int, seed: int, size: int = S,
                    dev: str = "cuda") -> dict:
    """A self-consistent training batch from a seeded generator on `dev`:
    3D boxes in front of the camera (f = 1000 px at 896^2), random yaw,
    their 2D boxes the projected cuboids, 8..m valid GT slots of m per
    image."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=dev)

    f = 1000.0 * size / S
    K = torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]],
                     device=dev).expand(b, 3, 3).contiguous()
    center = torch.stack([uni(-2, 2, b, m), uni(-1, 1, b, m),
                          uni(5, 20, b, m)], -1)
    dims = uni(0.4, 2.5, b, m, 3)                        # w, h, l
    yaw = uni(-math.pi, math.pi, b, m)
    c, s_ = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    poses = torch.stack([c, zero, s_, zero, one, zero, -s_, zero, c],
                        -1).reshape(b, m, 3, 3)
    corners = geom.cuboid_corners(torch.cat([center, dims], -1), poses)
    uvz = geom.project_points(K[:, None], corners)          # [b, m, 8, 3]
    uv = uvz[..., :2].clamp(0.0, size - 1.0)
    boxes = torch.cat([uv.amin(-2), uv.amax(-2)], -1)
    ctr = geom.project_points(K[:, None], center[..., None, :])[..., 0, :2]
    n_valid = torch.randint(min(8, m), m + 1, (b, 1), generator=g, device=dev)
    return {
        "image": uni(0, 255, b, size, size, 3), "K": K,
        "im_hw": torch.full((b, 2), size, dtype=torch.int32, device=dev),
        "im_scale_ratio": torch.ones(b, device=dev),
        "gt_boxes": boxes,
        "gt_classes": torch.randint(0, 50, (b, m), generator=g, device=dev),
        "gt_boxes3d": torch.cat([ctr, center[..., 2:], dims, center], -1),
        "gt_poses": poses,
        "gt_valid": torch.arange(m, device=dev)[None] < n_valid,
    }


def check_losses(metrics: dict, what: str) -> None:
    for name, v in metrics.items():
        check(bool(torch.isfinite(v).all()), f"{what}: {name} finite")


def train_model():
    """The flagship's config with the trunk unfrozen, and its model from
    seed 0 with the LayerScales at 0.1 as `lift_model` sets them, so
    attention shows in the loss and in every trunk gradient."""
    cfg = flagship_config(S)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, freeze=False))
    model = build_model(cfg, device="cuda", seed=0)
    with torch.no_grad():
        for blk in model.backbone.vit.blocks():
            blk.ls1.gamma.fill_(0.1)
            blk.ls2.gamma.fill_(0.1)
    return cfg, model


def train_phase() -> dict:
    """Train steps of the flagship with the trunk unfrozen; returns the
    launches of kernels 3 and 4 in the timed steps."""
    t0 = time.perf_counter()
    cfg, model = train_model()
    blocks = model.backbone.vit.blocks()
    opt = Optimizer(SolverConfig(), model)
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, cfg.stabilize)
    batch = synthetic_batch(TRAIN_B, TRAIN_GT, seed=1)
    trunk0 = {n: p.detach().clone()
              for n, p in model.backbone.vit.named_parameters()}
    say("train", f"flagship unfrozen (896^2, B={TRAIN_B}, {TRAIN_GT} GT "
                 f"slots, SGD lr {opt.lr('default').item():.3e} "
                 f"at step 0) built in {time.perf_counter() - t0:.1f} s; "
                 f"{sum(p.numel() for p in opt.params)} trainable parameters")
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, batch)
        check_losses(metrics, "warm-up step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    lats = []
    for _ in range(TRAIN_TIMED):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t1)
        check_losses(metrics, "timed step")
    launches = {"lse": attention.flash_attention_packed_lse.launches,
                "bwd": attention.flash_attention_packed_bwd.launches,
                "fwd": attention.flash_attention_packed.launches}
    peak = torch.cuda.max_memory_allocated()
    n_blocks = len(blocks)
    check(launches["lse"] == launches["bwd"] == n_blocks * TRAIN_TIMED,
          f"kernel 3/4 launches {launches} for {TRAIN_TIMED} steps of "
          f"{n_blocks} blocks")
    check(launches["fwd"] == 0, "the train steps launched no inference "
                                "kernel")
    check(int(state.skipped) == 0, f"{int(state.skipped)} steps skipped")
    moved = [n for n, p in model.backbone.vit.named_parameters()
             if not torch.equal(p.detach(), trunk0[n])]
    check(len(moved) == len(trunk0),
          f"{len(trunk0) - len(moved)} trunk parameters did not move")
    p50 = statistics.median(lats)
    say("train", f"{TRAIN_TIMED} timed steps: "
                 f"{sum(lats) / len(lats) * 1e3:.3f} ms/step mean, p50 "
                 f"{p50 * 1e3:.3f} ms, {TRAIN_B * len(lats) / sum(lats):.3f} "
                 f"img/s (all images over all the steps' time); peak memory "
                 f"{peak} bytes; per step {launches['lse'] // TRAIN_TIMED} "
                 f"kernel-3 and {launches['bwd'] // TRAIN_TIMED} kernel-4 "
                 f"launches; total loss {float(metrics['total_loss']):.4f}; "
                 + ", ".join(f"{k} {float(v):.4f}" for k, v in metrics.items()
                             if k not in ("total_loss", "skipped")))
    device_profile("train", lambda: step(state, batch), 2, p50 * 1e3)
    compare_train_step(model, batch)
    return launches


def _unmatched(a: torch.Tensor, valid_a: torch.Tensor, b: torch.Tensor,
               valid_b: torch.Tensor) -> int:
    """How many valid boxes of a [1, n, 4] have no valid box of b within
    1 px in every coordinate: proposals that one run picked and the other
    did not (the same anchor moved by rounding stays well within 1 px)."""
    d = (a[0, :, None] - b[0, None]).abs().amax(-1)
    d = torch.where(valid_b[0][None], d, torch.full_like(d, math.inf))
    return int(((d.amin(-1) > 1.0) & valid_a[0]).sum())


def batch_gt(batch: dict) -> GroundTruth:
    return GroundTruth(boxes=batch["gt_boxes"], classes=batch["gt_classes"],
                       boxes3d=batch["gt_boxes3d"], poses=batch["gt_poses"],
                       valid=batch["gt_valid"])


def sampling_draws(model, batch: dict, seed: int) -> dict:
    """compute_losses' sampling uniforms for `batch`, from a seeded
    generator, so two runs sample the same anchors and proposals."""
    dev = batch["image"].device
    b, size = batch["image"].shape[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    n_anchors = sum(len(model.cfg.anchors.aspect_ratios) * (size // st) ** 2
                    for st in model.feature_strides)
    n_props = model.cfg.rpn.post_nms_topk_train + batch["gt_boxes"].shape[1]
    return {"anchor": uniform_draws((b, 2, n_anchors), g, dev),
            "proposal": uniform_draws((b, 2, n_props), g, dev)}


def set_sam_attention(model, fn) -> None:
    """Route every SAM block's rel-pos attention through fn(qkv, Rh, Rw,
    grid)."""
    for blk in model.backbone.vit.blocks():
        blk.attn.attn_fn = fn


def compare_train_step(model, batch, phase: str = "train",
                       set_attn=set_attention, attn: dict | None = None,
                       bwd_launches=lambda: (
                           attention.flash_attention_packed_bwd.launches)
                       ) -> None:
    """One B=1 loss and gradient from the same state, with the kernels and
    with attention_ref in every block, and the same sampling draws. `attn`
    gives each run's attention ({"kernel", "plain", "plain_f32"}, set
    through `set_attn`; the flagship's by default) and `bwd_launches` the
    backward kernel's count, which the kernel run must raise by one a block
    and the plain runs leave.

    Attention's bf16 rounding differs between the two paths, and the RPN's
    proposals are discrete decisions (top-k, NMS at IoU 0.7) that a small
    change of its outputs flips; a different proposal changes the sampled
    boxes and with them the ROI losses. So every run is given the kernel
    run's proposals: the plain run also makes its own, and the line reports
    how far its RPN outputs moved and how many of its proposals and sampled
    boxes differ.

    The heads after the trunk run no kernel, but their losses (corner L1,
    chamfer minima, ReLUs) turn tiny differences of the trunk's output into
    different gradients at that output: attention_ref in f32 moves the
    trunk's gradients as far from attention_ref in bf16 as the kernels do,
    and by how much changes with the state the steps before left, which
    differs slightly between runs (some backward ops accumulate in a
    nondeterministic order on the card). So the checked trunk gradients
    start from one upstream gradient: the plain run's trunk backward is fed
    the kernel run's gradient at the trunk's output, and what differs is the
    trunk's own forward and backward, where the kernels are. The gradients
    from each run's own heads are printed beside, unchecked, with
    attention_ref in f32 against bf16 as their yardstick."""
    one = {k: v[:1] for k, v in batch.items()}
    gt = batch_gt(one)
    draws = sampling_draws(model, one, seed=2)

    rpn_proposals, sample_proposals = (rcnn3d.rpn_proposals,
                                       rcnn3d.sample_proposals)
    seen: dict = {}

    def replay_proposals(logits, deltas, *args):
        own = rpn_proposals(logits, deltas, *args)
        if "kernel" not in seen:
            seen["kernel"] = (logits, deltas, own)
            return own
        k_logits, k_deltas, kept = seen["kernel"]
        if "own" not in seen:                 # the first plain run's
            seen["own"] = own
            seen["rpn"] = ((logits - k_logits).abs().max().item(),
                           (deltas - k_deltas).abs().max().item(),
                           _unmatched(own[0], own[2], kept[0], kept[2]),
                           int(own[2].sum()))
        return kept

    def sample_both(prop_boxes, prop_valid, *args, **kw):
        out = sample_proposals(prop_boxes, prop_valid, *args, **kw)
        if "own" in seen and "sampled" not in seen:
            own_boxes, _, own_valid = seen["own"]
            p = own_boxes.shape[1]
            mine = sample_proposals(
                torch.cat([own_boxes, prop_boxes[:, p:]], 1),
                torch.cat([own_valid, prop_valid[:, p:]], 1), *args, **kw)
            seen["sampled"] = (
                _unmatched(mine["boxes"], mine["valid"], out["boxes"],
                           out["valid"]),
                int(out["valid"].sum()), int(mine["fg"].sum()),
                int(out["fg"].sum()))
        return out

    upstream: dict = {}

    def at_trunk_output(module, args, out):
        feat = out["last_feat"]
        if "grad" not in upstream:            # the kernel run's
            feat.register_hook(
                lambda grad: upstream.__setitem__("grad", grad.clone()))
        elif upstream["share"]:
            feat.register_hook(lambda grad: upstream["grad"])

    vit = model.backbone.vit
    trunk = dict(vit.named_parameters())
    n_blocks = len(vit.blocks())
    attn = attn or {"kernel": attention.dot_product_attention,
                    "plain": attention.attention_ref,
                    "plain_f32": attention_f32_probs}
    runs = (("kernel", attn["kernel"], False),
            ("plain", attn["plain"], False),
            ("plain_f32", attn["plain_f32"], False),
            ("plain_shared", attn["plain"], True),
            ("plain_f32_shared", attn["plain_f32"], True))
    out = {}
    rcnn3d.rpn_proposals, rcnn3d.sample_proposals = (replay_proposals,
                                                     sample_both)
    hook = vit.register_forward_hook(at_trunk_output)
    try:
        for name, fn, share in runs:
            set_attn(model, fn)
            upstream["share"] = share
            reset_attention_counts()
            torch.cuda.reset_peak_memory_stats()
            losses = model.compute_losses(one["image"], one["K"],
                                          one["im_hw"], one["im_scale_ratio"],
                                          gt, draws=draws)
            total = sum(losses.values())
            grads = torch.autograd.grad(total, list(trunk.values()))
            total = total.detach()
            torch.cuda.synchronize()
            launched = bwd_launches()
            check(launched == (n_blocks if name == "kernel" else 0),
                  f"{name} run: {launched} backward-kernel launches")
            out[name] = (total.item(), dict(zip(trunk, grads)),
                         torch.cuda.max_memory_allocated(),
                         {k: v.item() for k, v in losses.items()})
            del losses, total, grads
    finally:
        hook.remove()
        rcnn3d.rpn_proposals, rcnn3d.sample_proposals = (rpn_proposals,
                                                         sample_proposals)
        set_attn(model, attn["kernel"])
    (lk, gk, mem_k, parts_k), (lp, gp, mem_p, parts_p) = (out["kernel"],
                                                          out["plain"])
    d_logit, d_delta, props_diff, props_n = seen["rpn"]
    samp_diff, samp_n, fg_own, fg_kept = seen["sampled"]
    say(phase, f"B=1 plain run vs kernel run, before the replay: RPN "
                 f"logits max |diff| {d_logit:.3e}, deltas {d_delta:.3e}; "
                 f"{props_diff} of its {props_n} valid proposals and "
                 f"{samp_diff} of its {samp_n} sampled boxes have no match "
                 f"within 1 px in the kernel run's (foreground {fg_own} vs "
                 f"{fg_kept}); every run uses the kernel run's proposals")
    loss_rel = abs(lk - lp) / abs(lp)
    say(phase, f"B=1 kernel vs plain: total loss {lk:.6f} vs {lp:.6f} "
                 f"(rel {loss_rel:.3e}, limit {TRAIN_LOSS_REL}, margin "
                 f"{TRAIN_LOSS_REL / max(loss_rel, 1e-30):.1f}x); "
                 + ", ".join(f"{k} {parts_k[k]:.5f}/{parts_p[k]:.5f}"
                             for k in parts_k)
                 + f"; peak memory kernel {mem_k} B, plain {mem_p} B, plain "
                 f"in f32 {out['plain_f32'][2]} B")

    def rel(a: str, b: str) -> dict:
        ga, gb = out[a][1], out[b][1]
        return {n: ((ga[n] - gb[n]).norm() / gb[n].norm()).item() for n in gb}

    def summary(r: dict) -> str:
        worst = sorted(r.items(), key=lambda kv: -kv[1])[:3]
        return (f"median {statistics.median(r.values()):.3e}, worst "
                + ", ".join(f"{n} {v:.3e}" for n, v in worst))

    say(phase, "B=1 trunk gradient ||g_a - g_b|| / ||g_b||, each run's own "
                 "heads (not checked): kernel vs plain "
                 + summary(rel("kernel", "plain")) + "; plain vs plain in "
                 "f32 " + summary(rel("plain", "plain_f32")))
    checked = rel("kernel", "plain_shared")
    worst = max(checked.values())
    say(phase, "B=1 trunk gradient from the kernel run's gradient at the "
                 "trunk output: kernel vs plain " + summary(checked)
                 + f" (limit {TRAIN_GRAD_REL}, margin "
                 f"{TRAIN_GRAD_REL / max(worst, 1e-30):.2f}x); plain vs plain "
                 "in f32 " + summary(rel("plain_shared", "plain_f32_shared")))
    check(loss_rel <= TRAIN_LOSS_REL,
          f"total loss within {TRAIN_LOSS_REL} relative")
    check(worst <= TRAIN_GRAD_REL,
          f"every trunk gradient within {TRAIN_GRAD_REL} relative")


def geo_requests(n: int, seed: int):
    """n synthetic GEO requests: a 704x512 uint8 image, K (f = 600 px) and
    GEO_BOXES oracle boxes, two of them under the 0.30 threshold."""
    g = torch.Generator().manual_seed(seed)
    K = [[600.0, 0.0, GEO_W / 2], [0.0, 600.0, GEO_H / 2], [0.0, 0.0, 1.0]]
    out = []
    for _ in range(n):
        image = torch.randint(0, 256, (GEO_H, GEO_W, 3), generator=g,
                              dtype=torch.uint8).numpy()
        xy = torch.rand(GEO_BOXES, 2, generator=g) * torch.tensor(
            [GEO_W * 0.7, GEO_H * 0.7])
        wh = (0.1 + 0.2 * torch.rand(GEO_BOXES, 2, generator=g)
              ) * torch.tensor([GEO_W, GEO_H])
        scores = [0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.2, 0.1]
        dets = [{"bbox2d": torch.cat([xy[i], xy[i] + wh[i]]).tolist(),
                 "score": scores[i], "category_id": i}
                for i in range(GEO_BOXES)]
        out.append((image, K, dets))
    return out


def _relpos_plain(qkv, rh, rw, grid):
    return attention.rel_pos_attention_ref(*qkv.unbind(2), rh, rw, grid)


def _relpos_f32(qkv, rh, rw, grid):
    """rel_pos_attention_ref with q, k, v, the probabilities and PV in f32."""
    return attention.rel_pos_attention_ref(*qkv.float().unbind(2), rh, rw,
                                           grid).to(qkv.dtype)


# (SAM blocks' attention, Depth-Pro blocks' attention) of each GEO run.
GEO_ATTENTION = {
    "kernel": (attention.rel_pos_attention, attention.dot_product_attention),
    "plain": (_relpos_plain, lambda qkv: attention.attention_ref(
        *qkv.unbind(2))),
    "plain_f32": (_relpos_f32, lambda qkv: attention_f32_probs(
        *qkv.unbind(2))),
}


def set_geo_attention(models, run: str) -> None:
    relpos, attn = GEO_ATTENTION[run]
    for blk in models.sam_encoder.blocks():
        blk.attn.attn_fn = relpos
    for vit in models.depth.trunks():
        for blk in vit.blocks():
            blk.attn.attn_fn = attn


def serve_geo(models, requests):
    preds, lats = [], []
    for image, K, dets in requests:
        t0 = time.perf_counter()
        preds.append(geo.predict_image(models, image, K, dets))
        lats.append(time.perf_counter() - t0)     # ends in a host copy
    return preds, lats


def geo_phase() -> dict:
    """OVMono3D-GEO inference at the reference's sizes; returns the
    launches of kernels 1 and 7 in the timed images."""
    t0 = time.perf_counter()
    models = geo.build_geo_models("vit_h", depth_bf16=True, device="cuda",
                                  seed=0)
    geo_weights(models)
    n_params = sum(p.numel() for m in (models.sam_encoder, models.segmenter,
                                       models.depth) for p in m.parameters())
    say("geo", f"SAM ViT-H (1024^2), SAM decoder and Depth-Pro (1536^2, "
               f"bf16), seed 0, {n_params} parameters, built in "
               f"{time.perf_counter() - t0:.1f} s")
    requests = geo_requests(GEO_WARMUP + GEO_TIMED, seed=2)
    serve_geo(models, requests[:GEO_WARMUP])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.flash_attention_packed.launches = 0
    attention.rel_pos_flash_attention.launches = 0
    preds, lats = serve_geo(models, requests[GEO_WARMUP:])
    launches = {"fwd": attention.flash_attention_packed.launches,
                "relpos": attention.rel_pos_flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    check(launches["relpos"] == 32 * GEO_TIMED,
          f"{launches['relpos']} kernel-7 launches for {GEO_TIMED} images "
          "(32 SAM blocks each)")
    check(launches["fwd"] == 72 * GEO_TIMED,
          f"{launches['fwd']} kernel-1 launches for {GEO_TIMED} images (24 "
          "blocks of 3 Depth-Pro encoders each)")
    check_geo_preds(preds)
    p50 = statistics.median(lats) * 1e3
    stages = geo_stages(models, requests[GEO_WARMUP:])
    say("geo", f"{GEO_TIMED} images of {GEO_W}x{GEO_H}, {GEO_BOXES} oracle "
               f"boxes: {rate(lats)}; per image "
               f"{launches['relpos'] // GEO_TIMED} kernel-7 and "
               f"{launches['fwd'] // GEO_TIMED} kernel-1 launches; "
               f"{sum(map(len, preds)) / GEO_TIMED:.1f} boxes; peak memory "
               f"{peak} bytes; device ms per image by stage span: "
               + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    compare_geo(models, requests[GEO_WARMUP])
    with torch.inference_mode():
        device_profile("geo", lambda: serve_geo(
            models, requests[GEO_WARMUP:GEO_WARMUP + 3]), 3, p50,
            per="image", repeat=1)
    ok, err_c, err_d, _ = geo.synthetic_check("cuda")
    say("geo", f"synthetic self-check on the card: max center err "
               f"{err_c:.4f} m (< 0.1), max dims err {err_d:.4f} m (< 0.15): "
               f"{'PASS' if ok else 'FAIL'}")
    check(ok, "GEO synthetic self-check")
    return launches


def geo_weights(models) -> None:
    """Flax starts the rel-pos tables at zero, where kernel 7's bias path
    would go unchecked; Depth-Pro's LayerScales as in the slice phase; the
    depth head's bias so its final ReLU passes most pixels and the
    inverse-depth comparison reads values, not zeros."""
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for blk in models.sam_encoder.blocks():
            blk.attn.rel_pos_h.normal_(0.0, REL_POS_STD, generator=g)
            blk.attn.rel_pos_w.normal_(0.0, REL_POS_STD, generator=g)
        for vit in models.depth.trunks():
            for blk in vit.blocks():
                blk.ls1.gamma.fill_(0.1)
                blk.ls2.gamma.fill_(0.1)
        models.depth.head_out.bias.fill_(GEO_DEPTH_BIAS)


def check_geo_preds(preds) -> None:
    check(0 < sum(map(len, preds)), "some box fitted")
    for pred in preds:
        check(len(pred) <= GEO_BOXES - 2, f"{len(pred)} boxes for "
              f"{GEO_BOXES - 2} above the threshold")
        for box in pred:
            check(all(math.isfinite(x) for x in box["center_cam"]
                      + box["dimensions"] + sum(box["pose"], [])),
                  "finite boxes")


def geo_stages(models, requests) -> dict:
    """Device ms per image in each stage's span (the stream's time between
    its events, with no wait between stages), averaged over `requests`."""
    stages: dict = {}
    for image, K, dets in requests:
        trace: dict = {}
        geo.predict_image(models, image, K, dets, trace=trace)
        for k, ms in trace["ms"].items():
            stages[k] = stages.get(k, 0.0) + ms / len(requests)
    return stages


def compare_geo(models, request) -> None:
    """One image with the kernels and with the plain attention in every
    block: the SAM embedding, the mask logits and the canonical inverse
    depth held to the plain run; the inverse depth also less the head's
    bias, so its limits read what the trunks and the decoder add.

    These limits guard the model, not the kernels: bf16 attention alone
    (the plain run against the same math with f32 probabilities, printed
    beside, unchecked) moves a 32-block random-weight SAM about as far as
    the kernel does, so a small kernel fault would hide under it. The
    kernels are held to their plain versions at this path's shapes in the
    kernel phase. The fitted boxes are printed unchecked too (a
    random-weight mask's extremes flip with single pixels)."""
    runs = {}
    for name in GEO_ATTENTION:
        set_geo_attention(models, name)
        trace: dict = {}
        preds = geo.predict_image(models, *request, trace=trace)
        runs[name] = (preds, trace)
    set_geo_attention(models, "kernel")

    def deviation(a: str, b: str, key: str,
                  offset: float) -> tuple[float, float]:
        x, y = runs[a][1][key].float(), runs[b][1][key].float()
        d, ref = (x - y).abs(), (y - offset).abs()
        return (d.max().item() / ref.max().item(),
                d.mean().item() / ref.mean().item())

    failed = []
    for key, offset in (("embed", 0.0), ("mask_logits", 0.0),
                        ("canonical_inverse_depth", 0.0),
                        ("canonical_inverse_depth", GEO_DEPTH_BIAS)):
        mx, mean = deviation("kernel", "plain", key, offset)
        f32_mx, f32_mean = deviation("plain", "plain_f32", key, offset)
        ref = runs["plain"][1][key]
        name = f"{key} less {offset}" if offset else key
        say("geo", f"kernel vs plain {name} {tuple(ref.shape)}: max |diff| / "
                   f"max |ref| {mx:.3e} (limit {GEO_MAX_REL}), mean |diff| / "
                   f"mean |ref| {mean:.3e} (limit {GEO_MEAN_REL}); plain vs "
                   f"f32 probabilities {f32_mx:.3e} / {f32_mean:.3e}; > "
                   f"{offset} in {(ref > offset).float().mean().item():.1%}")
        if not (mx <= GEO_MAX_REL and mean <= GEO_MEAN_REL):
            failed.append(name)
    say("geo", "plain run stages (device ms per span): " + ", ".join(
        f"{k} {v:.3f}" for k, v in runs["plain"][1]["ms"].items()))
    for a, b in zip(runs["kernel"][0], runs["plain"][0]):
        say("geo", f"  box {a['category_id']}: center kernel "
                   f"{[round(x, 3) for x in a['center_cam']]} plain "
                   f"{[round(x, 3) for x in b['center_cam']]}; dims kernel "
                   f"{[round(x, 3) for x in a['dimensions']]} plain "
                   f"{[round(x, 3) for x in b['dimensions']]}")
    check(not failed, f"GEO kernel vs plain within limits: {failed} not")


ATTENTION_WRAPPERS = (
    attention.flash_attention_packed, attention.flash_attention_packed_lse,
    attention.flash_attention_packed_bwd)


def attention_counts() -> dict:
    """Every ViT attention wrapper's launches, f32 instances apart."""
    out = {}
    for fn in ATTENTION_WRAPPERS:
        out[fn.__name__] = fn.launches
        if hasattr(fn, "launches_f32"):
            out[fn.__name__ + "_f32"] = fn.launches_f32
    return out


REL_POS_WRAPPERS = (attention.rel_pos_flash_attention,
                    attention.rel_pos_flash_attention_lse,
                    attention.rel_pos_flash_attention_bwd)


def reset_attention_counts() -> None:
    for fn in ATTENTION_WRAPPERS + REL_POS_WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "launches_f32"):
            fn.launches_f32 = 0


def geo_f32_phase() -> dict:
    """The JAX GEO CLI's default configuration: Depth-Pro in f32
    (build_geo_models(depth_bf16=False)), SAM ViT-H in bf16, at the
    reference's sizes; returns the launches of kernel 1's f32 instance and
    of kernel 7 in the timed images."""
    t0 = time.perf_counter()
    models = geo.build_geo_models("vit_h", depth_bf16=False, device="cuda",
                                  seed=0)
    geo_weights(models)
    check(models.depth.dtype == torch.float32, "an f32 Depth-Pro")
    say("geo_f32", f"SAM ViT-H (bf16), SAM decoder and Depth-Pro (f32), seed "
                   f"0, weights as the geo phase, built in "
                   f"{time.perf_counter() - t0:.1f} s")
    requests = geo_requests(GEO_F32_WARMUP + GEO_F32_TIMED, seed=2)
    serve_geo(models, requests[:GEO_F32_WARMUP])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    preds, lats = serve_geo(models, requests[GEO_F32_WARMUP:])
    counts = attention_counts()
    relpos = attention.rel_pos_flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    n = GEO_F32_TIMED
    f32 = counts["flash_attention_packed_f32"]
    check(f32 == 72 * n, f"{f32} f32 kernel-1 launches for {n} images (24 "
                         "blocks of 3 Depth-Pro encoders each)")
    check(relpos == 32 * n, f"{relpos} kernel-7 launches for {n} images")
    check(sum(counts.values()) == f32,
          f"no other attention kernel launched: {counts}")
    check_geo_preds(preds)
    p50 = statistics.median(lats) * 1e3
    stages = geo_stages(models, requests[GEO_F32_WARMUP:])
    say("geo_f32", f"{n} images of {GEO_W}x{GEO_H}, {GEO_BOXES} oracle "
                   f"boxes: {rate(lats)}; per image {f32 // n} f32 kernel-1 "
                   f"and {relpos // n} kernel-7 launches; "
                   f"{sum(map(len, preds)) / n:.1f} boxes; peak memory "
                   f"{peak} bytes; device ms per image by stage span: "
                   + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    device_profile("geo_f32", lambda: serve_geo(
        models, requests[GEO_F32_WARMUP:GEO_F32_WARMUP + 2]), 2, p50,
        per="image", repeat=1)
    compare_geo_f32(models, requests[GEO_F32_WARMUP])
    return {"fwd_f32": f32, "relpos": relpos}


def compare_geo_f32(models, request) -> None:
    """One image's canonical inverse depth with f32 kernel 1 against the
    same models with f32 attention_ref in every Depth-Pro block (within
    GEO_F32_REL, relative Frobenius); and, printed unchecked, against a
    bf16 Depth-Pro holding the same weights (what --depth-bf16 changes)."""
    key = "canonical_inverse_depth"
    blocks = [blk for vit in models.depth.trunks() for blk in vit.blocks()]
    traces = {}
    try:
        for name, fn in (("kernel", attention.dot_product_attention),
                         ("plain", lambda qkv: attention.attention_ref(
                             *qkv.unbind(2)))):
            for blk in blocks:
                blk.attn.attn_fn = fn
            traces[name] = {}
            geo.predict_image(models, *request, trace=traces[name])
    finally:
        for blk in blocks:
            blk.attn.attn_fn = attention.dot_product_attention
    f32_depth = models.depth
    models.depth = DepthPro(dtype=torch.bfloat16, device="cuda").eval()
    try:
        models.depth.load_state_dict(f32_depth.state_dict())
        traces["bf16"] = {}
        geo.predict_image(models, *request, trace=traces["bf16"])
    finally:
        models.depth = f32_depth
    got = traces["kernel"][key]
    check(got.dtype == torch.float32, "f32 inverse depth")
    line = []
    for offset in (0.0, GEO_DEPTH_BIAS):
        rel, _ = rel_cos(got - offset, traces["plain"][key] - offset)
        rel_b, cos_b = rel_cos(traces["bf16"][key] - offset, got - offset)
        line.append((offset, rel, rel_b, cos_b))
        say("geo_f32", f"{key} {tuple(got.shape)}"
                       + (f" less {offset}" if offset else "")
                       + f": f32 kernel vs f32 attention_ref ||diff|| / "
                         f"||ref|| {rel:.3e}"
                       + (f" (limit {GEO_F32_REL}, margin "
                          f"{GEO_F32_REL / max(rel, 1e-30):.1f}x)"
                          if not offset else " (unchecked)")
                       + f"; bf16 Depth-Pro vs f32, same weights (unchecked): "
                         f"{rel_b:.3e}, cosine {cos_b:.6f}")
    check(line[0][1] <= GEO_F32_REL,
          f"f32 inverse depth within {GEO_F32_REL} of attention_ref's")


def trunk_loss_and_grads(model, batch, draws):
    """compute_losses on `batch` with fixed draws: the total loss and the
    trunk parameters' gradients."""
    losses = model.compute_losses(batch["image"], batch["K"], batch["im_hw"],
                                  batch["im_scale_ratio"], batch_gt(batch),
                                  draws=draws)
    total = sum(losses.values())
    trunk = dict(model.backbone.vit.named_parameters())
    grads = torch.autograd.grad(total, list(trunk.values()))
    return total.detach(), dict(zip(trunk, grads))


def category_tokenizer() -> tuple[list[str], BertTokenizer]:
    """The 50 category names and a tokenizer whose vocabulary holds their
    words (the released bert-base-uncased vocab.txt is not in the
    repository): the special tokens at their BERT ids, each word at an id
    from 2000 up."""
    names = json.loads(CATEGORY_META.read_text())["thing_classes"]
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
             ".": 1012, "?": 1029}
    probe = BertTokenizer(vocab)
    for word in sorted({w for name in names for w in probe._basic(name)}):
        vocab.setdefault(word, 2000 + len(vocab))
    return names, BertTokenizer(vocab)


def ovlift_weights(pipe: OVMono3DLift) -> None:
    """Move the weights OVLIFT_SETS names off their init (seeded), and the
    cube model's LayerScales and pose bias as in the slice phase."""
    g = torch.Generator(device="cuda").manual_seed(3)
    gd = pipe.gdino
    n_enc, n_dec = gd.enc_layers, gd.dec_layers
    with torch.no_grad():
        for layer in ([getattr(gd, f"img_enc{i}") for i in range(n_enc)]
                      + [getattr(gd, f"dec{i}") for i in range(n_dec)]):
            std = OVLIFT_SETS["sampling_offsets / attention_weights kernels"]
            layer.sampling_offsets.weight.normal_(0.0, std, generator=g)
            layer.attention_weights.weight.normal_(0.0, std, generator=g)
        for blk in gd.backbone.blocks().values():
            blk.attn.rel_pos_bias.normal_(
                0.0, OVLIFT_SETS["Swin rel_pos_bias tables"], generator=g)
        for i in range(n_enc):
            fusion = getattr(gd, f"fusion{i}")
            fusion.gamma_v.fill_(OVLIFT_SETS["fusion gamma_v / gamma_l"])
            fusion.gamma_l.fill_(OVLIFT_SETS["fusion gamma_v / gamma_l"])
        for head in (gd.enc_bbox_head, gd.ref_point_head, gd.bbox_head):
            getattr(head, f"l{head.layers - 1}").weight.normal_(
                0.0, OVLIFT_SETS["box heads' last kernels"], generator=g)
        for blk in pipe.rcnn.backbone.vit.blocks():
            blk.ls1.gamma.fill_(0.1)
            blk.ls2.gamma.fill_(0.1)
        pipe.rcnn.cube_head.pose.bias.copy_(torch.tensor(IDENTITY_6D))


def ov_requests(n: int, seed: int):
    """n random 640x480 uint8 images."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (OV_H, OV_W, 3), generator=g,
                          dtype=torch.uint8).numpy() for _ in range(n)]


def serve_ov(pipe, images, K, names):
    dets, lats = [], []
    for image in images:
        t0 = time.perf_counter()
        det = pipe.predict(image, K, names)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
        dets.append(det)
    return dets, lats


def check_ov_detections(det, n_classes: int) -> None:
    for name, x in det.items():
        check(x.shape[0] == 300, f"{name} shape {tuple(x.shape)} starts [300]")
        check(bool(torch.isfinite(x.float()).all()), f"{name} finite")
    check(bool((det.classes[det.valid] < n_classes).all()),
          "valid classes inside the prompt")


def set_window_attention(pipe, fn) -> None:
    for blk in pipe.gdino.backbone.blocks().values():
        blk.attn.attn_fn = fn


def _window_plain(qkv, bias, ids):
    return attention.window_attention_ref(*qkv.unbind(2), bias, ids)


def _window_f32(qkv, bias, ids):
    """window_attention_ref with q, k, v, the probabilities and PV in
    f32."""
    return attention.window_attention_ref(*qkv.float().unbind(2), bias,
                                          ids).to(qkv.dtype)


def ovlift_phase(previous: str | None) -> tuple:
    """Open-vocabulary OVMono3D-LIFT serving at full width; returns the
    launches of kernels 8 and 1 in the timed images, the pipeline and the
    prompt's names (the stream phase serves with them). With --previous, the
    profile of the same images is taken again with the earlier design of
    kernel 8 (from DIR's window_attn_fwd.cu) in every Swin block, then with
    the shipped one once more."""
    t0 = time.perf_counter()
    names, tok = category_tokenizer()
    pipe = OVMono3DLift.build(Config(model=flagship_config(S)), tok,
                              device="cuda", seed=0)
    ovlift_weights(pipe)
    n_params = sum(p.numel() for m in (pipe.gdino, pipe.rcnn)
                   for p in m.parameters())
    say("ovlift", f"GroundingDINO SwinB + flagship cube model (896^2, seed "
                  f"0), {n_params} parameters, built in "
                  f"{time.perf_counter() - t0:.1f} s; moved off the init: "
                  + ", ".join(f"{k} {v}" for k, v in OVLIFT_SETS.items()))
    K = default_focal_K(OV_H, OV_W)
    images = ov_requests(OV_WARMUP + OV_TIMED, seed=4)
    req = pipe.prepare(images[0], K, names)
    check(tuple(req["text"]["input_ids"].shape) == (1, 128),
          f"the prompt's bucket {tuple(req['text']['input_ids'].shape)}")
    serve_ov(pipe, images[:OV_WARMUP], K, names)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.window_flash_attention.launches = 0
    attention.flash_attention_packed.launches = 0
    dets, lats = serve_ov(pipe, images[OV_WARMUP:], K, names)
    launches = {"window": attention.window_flash_attention.launches,
                "fwd": attention.flash_attention_packed.launches}
    peak = torch.cuda.max_memory_allocated()
    check(launches["window"] == 24 * OV_TIMED,
          f"{launches['window']} kernel-8 launches for {OV_TIMED} images "
          "(24 Swin blocks each)")
    check(launches["fwd"] == 12 * OV_TIMED,
          f"{launches['fwd']} kernel-1 launches for {OV_TIMED} images (12 "
          "DINOv2 blocks each)")
    for det in dets:
        check_ov_detections(det, len(names))
    p50 = statistics.median(lats) * 1e3
    stages: dict = {}
    for image in images[OV_WARMUP:]:
        trace: dict = {}
        pipe.predict(image, K, names, trace=trace)
        for k, ms in trace["ms"].items():
            stages[k] = stages.get(k, 0.0) + ms / OV_TIMED
    n_valid = sum(int(d.valid.sum()) for d in dets) / OV_TIMED
    say("ovlift", f"{OV_TIMED} images of {OV_W}x{OV_H} ({len(names)} "
                  f"categories, a {req['text']['input_ids'].shape[1]}-token "
                  f"prompt): {rate(lats)}; per image "
                  f"{launches['window'] // OV_TIMED} kernel-8 and "
                  f"{launches['fwd'] // OV_TIMED} kernel-1 launches; "
                  f"{n_valid:.1f} valid of 300 slots; peak memory {peak} "
                  "bytes; device ms per image by stage span: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    profiled = images[OV_WARMUP:OV_WARMUP + 3]
    with torch.inference_mode():
        busy = device_profile("ovlift", lambda: serve_ov(
            pipe, profiled, K, names), 3, p50, per="image", repeat=1)
    previous = earlier_design(previous, "window_attn_fwd.cu")
    if previous is not None:
        prev = window_probe.previous_window(previous)
        busy = [busy]
        for fn in (lambda qkv, bias, ids: prev(*qkv.unbind(2), bias, ids),
                   attention.window_attention):
            set_window_attention(pipe, fn)
            with torch.inference_mode():
                serve_ov(pipe, profiled[:1], K, names)
                busy.append(device_profile("ovlift", lambda: serve_ov(
                    pipe, profiled, K, names), 3, p50, per="image",
                    repeat=1))
        say("ovlift", f"device ms per image with kernel 8, its earlier "
                      f"design, kernel 8 again: {busy[0]:.3f}, {busy[1]:.3f}, "
                      f"{busy[2]:.3f}")
    gdino_breakdown(pipe, images[OV_WARMUP], K, names)
    check_no_sync(pipe, images[OV_WARMUP], K, names)
    compare_ovlift(pipe, images[OV_WARMUP], K, names)
    return launches, pipe, names


def gdino_breakdown(pipe, image, K, names) -> None:
    """Synchronised ms of GroundingDINO's parts on one prepared request:
    BERT with the text projection, the Swin trunk, and the whole forward
    (the rest is the enhancer, the query selection and the decoder)."""
    req = pipe.prepare(image, K, names)
    text = req["text"]
    tensor = pipe._gdino_normalize(req["canvas"][None], req["hw"])
    gd = pipe.gdino
    parts = {
        "text encoder": lambda: gd.encode_text(
            text["input_ids"], text["text_mask"], text["text_self_mask"],
            text["position_ids"]),
        "swin": lambda: gd.backbone(tensor, gd.backbone.rel_biases()),
        "whole forward": lambda: gd(tensor, text["input_ids"],
                                    text["text_mask"], text["text_self_mask"],
                                    text["position_ids"]),
    }
    with torch.inference_mode():
        ms = {k: time_ms(fn, reps=3, warmup=1) for k, fn in parts.items()}
    say("ovlift", "GroundingDINO parts, CUDA-event medians: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items()))


def check_no_sync(pipe, image, K, names) -> None:
    """Detection, postprocess and lift of a prepared request with the
    card's synchronisation check on: any host synchronisation between them
    (a copy from pageable memory, .item(), a data-dependent shape) warns,
    and the phase fails on one."""
    import warnings

    req = pipe.prepare(image, K, names)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            det = pipe.run(req)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    say("ovlift", f"prepared request's detection + lift: {len(syncs)} host "
                  f"synchronisations ({int(det.valid.sum())} valid)"
                  + (f"; first: {syncs[0][:200]}" if syncs else ""))
    check(not syncs, "no host synchronisation between detection and lift")


def compare_ovlift(pipe, image, K, names) -> None:
    """One image with kernel 8 and with window_attention_ref in every Swin
    block: Swin's s1/s2/s3 held to the plain run within OVLIFT_MAX_REL /
    OVLIFT_MEAN_REL (a guard of the model: bf16 attention alone, plain vs
    f32 probabilities printed beside, moves them about as far; the kernel
    phase holds the kernel to its plain version at these shapes); then
    pred_logits, pred_boxes and the lifted corners printed unchecked, since
    top-900 selection and NMS flip on rounding."""
    runs = {}
    req = pipe.prepare(image, K, names)
    tensor = pipe._gdino_normalize(req["canvas"][None], req["hw"])
    for name, fn in (("kernel", attention.window_attention),
                     ("plain", _window_plain), ("plain_f32", _window_f32)):
        set_window_attention(pipe, fn)
        with torch.inference_mode():
            feats = pipe.gdino.backbone(tensor,
                                        pipe.gdino.backbone.rel_biases())
        trace: dict = {}
        det = pipe.predict(image, K, names, trace=trace)
        runs[name] = (feats, trace, det)
    set_window_attention(pipe, attention.window_attention)

    def deviation(a, b, key):
        x, y = runs[a][0][key].float(), runs[b][0][key].float()
        d = (x - y).abs()
        return (d.max().item() / y.abs().max().item(),
                d.mean().item() / y.abs().mean().item())

    failed = []
    for key in ("s1", "s2", "s3"):
        mx, mean = deviation("kernel", "plain", key)
        f32_mx, f32_mean = deviation("plain", "plain_f32", key)
        say("ovlift", f"kernel vs plain Swin {key} "
                      f"{tuple(runs['plain'][0][key].shape)}: max |diff| / "
                      f"max |ref| {mx:.3e} (limit {OVLIFT_MAX_REL}), mean "
                      f"|diff| / mean |ref| {mean:.3e} (limit "
                      f"{OVLIFT_MEAN_REL}); plain vs f32 probabilities "
                      f"{f32_mx:.3e} / {f32_mean:.3e}")
        if not (mx <= OVLIFT_MAX_REL and mean <= OVLIFT_MEAN_REL):
            failed.append(key)
    k_tr, p_tr = runs["kernel"][1], runs["plain"][1]
    k_det, p_det = runs["kernel"][2], runs["plain"][2]
    live = p_tr["pred_logits"] > -1e8               # not the masked tokens
    d_logit = (k_tr["pred_logits"] - p_tr["pred_logits"])[live].abs().max()
    d_box = (k_tr["pred_boxes"] - p_tr["pred_boxes"]).abs().max()
    d_corner = (k_det.corners3d - p_det.corners3d).abs().max()
    same_cls = int((k_det.classes == p_det.classes).sum())
    say("ovlift", f"kernel vs plain, unchecked: pred_logits max |diff| "
                  f"{d_logit.item():.3e} (scale "
                  f"{p_tr['pred_logits'][live].abs().max().item():.3e}), "
                  f"pred_boxes {d_box.item():.3e}; valid slots "
                  f"{int(k_det.valid.sum())} vs {int(p_det.valid.sum())}, "
                  f"same class in {same_cls} of 300; corners3d max |diff| "
                  f"{d_corner.item():.3e} (scale "
                  f"{p_det.corners3d.abs().max().item():.3e}); plain run "
                  "stages (device ms per span): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in p_tr["ms"].items()))
    check(not failed, f"Swin kernel vs plain within limits: {failed} not")


def path_counts() -> dict:
    """The launches of the kernels the stream phase's paths run."""
    return {"window": attention.window_flash_attention.launches,
            "relpos": attention.rel_pos_flash_attention.launches,
            "relpos_lse": attention.rel_pos_flash_attention_lse.launches,
            "relpos_bwd": attention.rel_pos_flash_attention_bwd.launches,
            **attention_counts()}


def reset_path_counts() -> None:
    reset_attention_counts()
    attention.window_flash_attention.launches = 0


def check_path_counts(path: str, want: dict, phase: str = "stream"
                      ) -> dict:
    """Every counter of path_counts() at `want`'s value (0 where it names
    none); returns the counts."""
    got = path_counts()
    say(phase, f"{path}: launches " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v))
    for key, n in got.items():
        check(n == want.get(key, 0),
              f"{path}: {n} launches of {key}, {want.get(key, 0)} expected")
    return got


def random_images(shapes, seed: int) -> list[np.ndarray]:
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (h, w, 3), generator=g,
                          dtype=torch.uint8).numpy() for h, w in shapes]


def max_field_diff(a, b) -> float:
    """Largest |a - b| over every field of two Detections (or dicts) in
    host memory; inf when their valid slots differ."""
    a, b = dict(a.items()), dict(b.items())
    if not np.array_equal(np.asarray(a["valid"]), np.asarray(b["valid"])):
        return math.inf
    return max(float(np.abs(np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)).max())
               for k in a)


def stream_vs_per_image(name, got: list, want: list) -> None:
    """Held within STREAM_TOL, image by image (a stream at scale 1, where
    its uint8 canvas holds the image's own pixels, against the same batches
    served from the images' own canvases; or a batch of one image a
    forward against each image alone)."""
    diffs = [max_field_diff(g, w) for g, w in zip(got, want)]
    valid = sum(int(np.asarray(dict(g.items())["valid"]).sum()) for g in got)
    say("stream", f"{name} vs per-image: max |diff| over every "
                  f"field {max(diffs):.3e} (limit {STREAM_TOL}), {valid} "
                  "valid slots")
    check(len(got) == len(want) and max(diffs) <= STREAM_TOL,
          f"{name} equals per-image serving")


def box_deviation(got: list, want: list) -> tuple[float, int]:
    """Max |box diff| over slots valid in both, and the slots whose valid
    flag differs, between two lists of detections."""
    dev, changed = 0.0, 0
    for g, w in zip(got, want):
        g, w = dict(g.items()), dict(w.items())
        gv, wv = np.asarray(g["valid"]), np.asarray(w["valid"])
        both = gv & wv
        if both.any():
            dev = max(dev, float(np.abs(np.asarray(g["boxes"])[both]
                                        - np.asarray(w["boxes"])[both]).max()))
        changed += int((gv != wv).sum())
    return dev, changed


def stream_phase(pipe: OVMono3DLift, names: list[str]) -> dict:
    """The serving and dataset paths built on the ovlift phase's pipeline
    (its weights, tokenizer and 50 names); returns their launches of
    kernels 1 (bf16 and f32), 7 and 8, each path's read with the counts at
    0 just before it."""
    t_phase = time.perf_counter()
    dev = pipe.device
    totals = {"fwd": 0, "window": 0, "relpos": 0, "fwd_f32": 0}

    def add(counts):
        totals["fwd"] += counts["flash_attention_packed"]
        totals["fwd_f32"] += counts["flash_attention_packed_f32"]
        totals["window"] += counts["window"]
        totals["relpos"] += counts["relpos"]

    K = default_focal_K(OV_H, OV_W)
    images = ov_requests(STREAM_IMAGES, seed=6)
    items = [(image, K) for image in images]
    chunk = STREAM_CHUNK
    list(pipe.predict_stream(iter(items[:chunk]), names, chunk=chunk))
    torch.cuda.synchronize()
    # predict_stream: the images' in-times as the stream takes them.
    t_in: list[float] = []

    def taken():
        for item in items * STREAM_PASSES:
            t_in.append(time.perf_counter())
            yield item

    reset_path_counts()
    counted = serve_batch.lift_stream_chunks
    counted.eager = counted.captured = counted.replayed = 0
    stream, lat, t_out = [], [], []
    t0 = time.perf_counter()
    for i, det in enumerate(pipe.predict_stream(taken(), names, chunk=chunk)):
        t_out.append(time.perf_counter())
        lat.append(t_out[-1] - t_in[i])
        stream.append(det)
    stream_s = time.perf_counter() - t0
    n = len(images)
    chunks = -(-n // chunk)                  # a pass's
    total = chunks * STREAM_PASSES
    add(check_path_counts("predict_stream", {
        "window": 24 * total, "flash_attention_packed": 12 * total}))
    check((counted.eager, counted.captured, counted.replayed)
          == (1, 1, total - 2),
          f"predict_stream's chunks: {counted.eager} eager, "
          f"{counted.captured} captured, {counted.replayed} replayed; 1, 1 "
          f"and {total - 2} expected")
    for det in stream:
        check_ov_detections(det, len(names))
    # The later passes replay graphs on the first pass's images (its first
    # chunk eager, its second captured): the same Detections bit for bit.
    replay_diff = max(max_field_diff(d, stream[i % n])
                      for i, d in enumerate(stream))
    check(replay_diff == 0, f"predict_stream's later passes against its "
                            f"first: max |diff| {replay_diff}")
    stream_rate = len(stream) / stream_s
    # Images emitted after the second chunk's, over their time: every
    # chunk among them is replayed.
    replay_rate = ((len(stream) - 2 * chunk)
                   / (t_out[-1] - t_out[2 * chunk - 1]))
    stream = stream[:n]
    reset_path_counts()
    per_image, plats = [], []
    t0 = time.perf_counter()
    for image in images:
        t1 = time.perf_counter()
        det = pipe.predict(image, K, names)
        per_image.append(Detections(**{k: v.cpu() for k, v in det.items()}))
        plats.append(time.perf_counter() - t1)
    predict_s = time.perf_counter() - t0
    check_path_counts("per-image predict", {
        "window": 24 * n, "flash_attention_packed": 12 * n})
    box_dev, changed = box_deviation(stream, per_image)
    say("stream", f"predict_stream (chunk {chunk}) over {n} images of "
                  f"{OV_W}x{OV_H}, {STREAM_PASSES} times: {stream_rate:.3f} "
                  f"img/s ({total} chunks: {counted.eager} eager, "
                  f"{counted.captured} captured, {counted.replayed} "
                  f"replayed), {replay_rate:.3f} img/s over the replayed "
                  f"chunks, equal to the first pass bit for bit; per-image "
                  f"latency in the stream p50 "
                  f"{statistics.median(lat) * 1e3:.3f} ms (max "
                  f"{max(lat) * 1e3:.3f}); per-image predict over the same "
                  f"images: {n / predict_s:.3f} img/s, p50 "
                  f"{statistics.median(plats) * 1e3:.3f} ms; 24 kernel-8 "
                  "and 12 kernel-1 launches a chunk in the stream and an "
                  "image in predict; stream vs "
                  f"predict at scale "
                  f"{pipe._gdino_content_geometry(OV_H, OV_W)[2]:.4f} (the "
                  f"stream's canvas rounded to uint8): boxes max |diff| "
                  f"{box_dev:.3e} px over slots valid in both, {changed} "
                  "slots "
                  f"changed validity of {n * stream[0].valid.shape[0]}")
    # One chunk of each profiled, in turns (stream, predict, predict,
    # stream): a profile of this run has once read every kernel 0.37x as
    # long as the others did.
    runs = {"stream": (lambda: list(pipe.predict_stream(
                iter(items[:chunk]), names, chunk=chunk)), 1 / replay_rate),
            "predict": (lambda: [pipe.predict(image, K, names).valid.cpu()
                                 for image in images[:chunk]], predict_s / n)}
    busy: dict = {"stream": [], "predict": []}
    with torch.inference_mode():
        for key in ("stream", "predict", "predict", "stream"):
            fn, wall = runs[key]
            busy[key].append(device_profile("stream", fn, chunk, wall * 1e3,
                                            per="image", repeat=1))
    def idle(b: float, key: str) -> str:
        return f"{b:.3f} ({max(0.0, 1 - b / (runs[key][1] * 1e3)):.1%})"

    say("stream", "device ms per image and idle share against each one's "
                  "wall time per image, in turns: " + "; ".join(
                      f"{key} " + ", ".join(idle(b, key) for b in busy[key])
                      for key in busy))
    stream_syncs(pipe.predict_stream(iter(items), names, chunk=chunk),
                 n // chunk, "predict_stream")
    scale1 = [(image, default_focal_K(*image.shape[:2]))
              for image in random_images(STREAM_SCALE1, 7)]
    served = []
    for at in range(0, len(scale1), 2):
        reqs = [pipe.prepare(i, k_, names) for i, k_ in scale1[at:at + 2]]
        canvases = torch.stack([r["canvas"] for r in reqs])
        hw = torch.cat([r["hw"] for r in reqs])
        det = pipe.run_batch(
            canvases, hw, torch.cat([r["ratio"] for r in reqs]),
            torch.cat([r["K"] for r in reqs]), reqs[0]["text"],
            pipe._gdino_normalize(canvases, hw))
        served += [Detections(**{k: v[j].cpu() for k, v in det.items()})
                   for j in range(len(reqs))]
    stream_vs_per_image(
        "predict_stream (chunk 2) at scale 1, against run_batch",
        list(pipe.predict_stream(iter(scale1), names, chunk=2)), served)

    # detect_2d_stream on a detector-only pipeline (build_2d_only's form,
    # the ovlift phase's GroundingDINO).
    pipe2d = OVMono3DLift(None, None, pipe.gdino, pipe.tokenizer,
                          gdino_size=DETECT_SIDE)
    list(pipe2d.detect_2d_stream(iter(images[:chunk]), names, chunk=chunk))
    torch.cuda.synchronize()
    reset_path_counts()
    t0 = time.perf_counter()
    dets = list(pipe2d.detect_2d_stream(iter(images), names, chunk=chunk))
    detect_s = time.perf_counter() - t0
    add(check_path_counts("detect_2d_stream", {"window": 24 * chunks}))
    t0 = time.perf_counter()
    want = [pipe2d.detect_2d(image, names) for image in images]
    detect_1_s = time.perf_counter() - t0
    box_dev, changed = box_deviation(dets, want)
    slots = min(pipe2d.detect_topk, pipe.gdino.num_queries)
    check(all(d["boxes"].shape == (slots, 4) and np.isfinite(d["boxes"]).all()
              for d in dets), f"detect_2d_stream: finite [{slots}, 4] boxes")
    say("stream", f"detect_2d_stream over {n} images on the {DETECT_SIDE}^2 "
                  f"canvas: {n / detect_s:.3f} img/s; per-image detect_2d "
                  f"{n / detect_1_s:.3f} img/s; boxes max |diff| "
                  f"{box_dev:.3e} "
                  f"px, {changed} slots changed validity")
    stream_syncs(pipe2d.detect_2d_stream(iter(images), names, chunk=chunk),
                 n // chunk, "detect_2d_stream")
    scale1 = random_images(DETECT_SCALE1, 8)
    text2d = pipe2d._text_device_inputs(names)
    served = []
    with torch.inference_mode():
        for at in range(0, len(scale1), 2):
            det = pipe2d._detect_batch(torch.cat([
                pipe2d._prep_gdino_image(image)[0]
                for image in scale1[at:at + 2]]), text2d)
            served += [{k: v[j].cpu().numpy() for k, v in det.items()}
                       for j in range(det["valid"].shape[0])]
    stream_vs_per_image(
        "detect_2d_stream (chunk 2) at scale 1, against _detect_batch",
        list(pipe2d.detect_2d_stream(iter(scale1), names, chunk=2)), served)

    # detect_open_vocabulary_batch, N = BATCH_N: over BATCH_N + 1 entries
    # of the device (one image a forward, one zero image of padding) it is
    # per-image detection exactly; over [device] one batch of BATCH_N, whose
    # products round otherwise than B = 1's (held by Swin's features: the
    # top-900 selection and NMS of random weights flip on rounding).
    canvases = torch.cat([pipe2d._prep_gdino_image(image)[0]
                          for image in images[:BATCH_N]]).cpu()
    text = build_text_inputs(pipe.tokenizer, names,
                             max_len=pipe.gdino.max_text_len)
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in text.items()}
    ones = []
    with torch.inference_mode():
        for i in range(BATCH_N):
            out = pipe.gdino(canvases[i:i + 1].to(dev), t["input_ids"],
                             t["text_mask"], t["text_self_mask"],
                             t["position_ids"])
            ones.append(dict(zip(("boxes", "scores", "classes", "valid"), (
                x.cpu().numpy() for x in postprocess_grounding(
                    out["pred_logits"][0], out["pred_boxes"][0],
                    t["span_matrix"], t["span_valid"], (DETECT_SIDE,) * 2,
                    topk=100)))))
    reset_path_counts()
    split = serve_batch.detect_open_vocabulary_batch(
        pipe.gdino, canvases, pipe.tokenizer, names, [dev] * (BATCH_N + 1))
    add(check_path_counts(f"detect_open_vocabulary_batch over {BATCH_N + 1} "
                          "devices", {"window": 24 * (BATCH_N + 1)}))
    stream_vs_per_image(
        f"detect_open_vocabulary_batch over [{dev}] x {BATCH_N + 1}",
        [{k: v[i] for k, v in split.items()} for i in range(BATCH_N)], ones)
    run = serve_batch.make_gdino_serving_fn(pipe.gdino, [dev])
    serve_batch.detect_open_vocabulary_batch(
        pipe.gdino, canvases, pipe.tokenizer, names, [dev], run=run)
    reset_path_counts()
    t0 = time.perf_counter()
    batch = serve_batch.detect_open_vocabulary_batch(
        pipe.gdino, canvases, pipe.tokenizer, names, [dev], run=run)
    batch_s = time.perf_counter() - t0
    add(check_path_counts("detect_open_vocabulary_batch", {"window": 24}))
    box_dev, changed = box_deviation(
        [{k: v[i] for k, v in batch.items()} for i in range(BATCH_N)], ones)
    gd = pipe.gdino
    with torch.inference_mode():
        x = canvases.to(dev)
        feats = gd.backbone(x, gd.backbone.rel_biases())
        worst = {}
        for i in range(BATCH_N):
            one = gd.backbone(x[i:i + 1], gd.backbone.rel_biases())
            for key, f in one.items():
                d = (feats[key][i:i + 1].float() - f.float()).abs()
                worst[key] = max(worst.get(key, (0.0, 0.0)), (
                    d.max().item() / f.float().abs().max().item(),
                    d.mean().item() / f.float().abs().mean().item()))
    say("stream", f"detect_open_vocabulary_batch over [{dev}], one batch of "
                  f"{BATCH_N}: {batch_s * 1e3:.3f} ms "
                  f"({BATCH_N / batch_s:.3f} img/s); Swin's features against each image alone, max / "
                  "mean |diff| relative: " + ", ".join(
                      f"{k} {mx:.3e} / {mn:.3e}" for k, (mx, mn) in
                      worst.items())
                  + f" (limits {OVLIFT_MAX_REL} / {OVLIFT_MEAN_REL}); "
                  f"unchecked: boxes max |diff| {box_dev:.3e} px over slots "
                  f"valid in both, {changed} slots changed validity")
    check(all(mx <= OVLIFT_MAX_REL and mn <= OVLIFT_MEAN_REL
              for mx, mn in worst.values()),
          "the batch's Swin features match each image's alone")

    # The dataset CLIs on the card, over files under build/.
    work = Path(__file__).resolve().parent / "build" / "stream_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    reset_path_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        paths = oracle2d.main(["--synthetic", "--device", str(dev),
                               "--output-dir", str(work / "oracle2d")])
    # Two synthetic sets of 4 images, each one chunk of detect_2d_stream.
    add(check_path_counts("eval.oracle2d --synthetic", {"window": 24 * 2}))
    for name, seed in (("synthetic_a", 7), ("synthetic_b", 11)):
        dets = json.loads(paths[name].read_text())
        recs = merge_oracle2d(synthetic_records(4, Config().model.num_classes,
                                                seed=seed), paths[name])
        check(sum(len(r["oracle2d"]) for r in recs) == len(dets) > 0,
              f"{name}'s {len(dets)} detections round-trip through "
              "merge_oracle2d")
    say("stream", f"eval.oracle2d --synthetic: 8 images in "
                  f"{time.perf_counter() - t0:.1f} s (the build included); "
                  + printed.getvalue().strip().replace("\n", "; "))
    data = tiny_omni3d(work / "tiny_omni3d")
    config = str(Path(__file__).resolve().parent / "configs"
                 / "OVMono3D_dinov2_SFP.yaml")
    overrides = [f"datasets.data_root={data['root']}",
                 "datasets.category_names=chair,cup"]
    geo_argv = ["--config-file", config, "--device", str(dev),
                "--output-dir", str(work / "geo"),
                *overrides, "datasets.test_novel=TinyDS_test",
                "datasets.oracle2d_files.target_aware.novel.TinyDS_test="
                f"{data['oracle']}"]
    reset_path_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        res = geo.main(geo_argv + ["--eval"])["TinyDS_test"]
    geo_s = time.perf_counter() - t0
    m = res["images"]
    add(check_path_counts("geo.cli --config-file --eval", {
        "relpos": 12 * m, "flash_attention_packed_f32": 72 * m}))
    table = printed.getvalue()
    table = table[table.index("== OVMono3D-GEO =="):]
    with contextlib.redirect_stdout(io.StringIO()) as again:
        res_again = geo_eval_cli.main(geo_argv)["TinyDS_test"]
    check(m == 4 and table in again.getvalue()
          and same_result(res_again["eval"], res["eval"]),
          "geo.eval_cli (--eval-only) prints the same AP table")
    say("stream", f"geo.cli --config-file --eval (SAM vit_b, f32 "
                  f"Depth-Pro) over {m} images of the tiny Omni3D set in "
                  f"{geo_s:.1f} s (the build included); ms an image by "
                  "stage: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                        res["stage_ms"].items())
                  + f"; 12 kernel-7 and 72 f32 kernel-1 launches an image; "
                  f"AP3D {res['eval']['overall']['AP3D']:.4f}, AP2D "
                  f"{res['eval']['overall']['AP2D']:.4f}; --eval-only "
                  "printed the same table")
    reset_path_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = eval_cli.main([
            "--config-file", config, "--device", str(dev), "--batch-size", "4",
            "--dump-predictions", str(work / "preds"), *overrides,
            "model.num_classes=2", "datasets.test_base=TinyDS_test",
            "test.cat_mode=base", "test.oracle2d=true",
            "datasets.oracle2d_files.target_aware.base.TinyDS_test="
            f"{data['oracle']}"])
        offline = predictions.main([
            "--predictions", str(work / "preds_TinyDS_test.json"),
            "--dataset-json", str(data["root"] / "Omni3D"
                                  / "TinyDS_test.json"),
            "--categories", "chair,cup", "--device", str(dev)])
    add(check_path_counts("eval.cli --dump-predictions",
                          {"flash_attention_packed": 12}))
    want = summary["datasets"]["TinyDS_test"]
    got = offline["overall"]
    say("stream", f"eval.cli (the flagship, 4 images) then "
                  f"eval.predictions on its dump: AP2D {got['AP2D']:.4f} / "
                  f"{want['AP2D']:.4f}, AP3D {got['AP3D']:.4f} / "
                  f"{want['AP3D']:.4f}")
    check(all(abs(got[k] - want[k]) <= 1e-6 for k in ("AP2D", "AP3D")),
          "eval.predictions gives eval.cli's AP (to 1e-6)")
    shutil.rmtree(work, ignore_errors=True)
    say("stream", f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return totals


def same_result(a, b) -> bool:
    """Two evaluation results equal, NaN equal to NaN."""
    return (json.dumps(a, sort_keys=True, default=float)
            == json.dumps(b, sort_keys=True, default=float))


def stream_syncs(stream, n_chunks: int, what: str) -> None:
    """Consume `stream` with the card's synchronisation check on: at most
    one host synchronisation a chunk (its read-back) may warn."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            n = len(list(stream))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    say("stream", f"{what} over {n} images in {n_chunks} chunks: "
                  f"{len(syncs)} host synchronisations"
                  + (f"; first: {syncs[0][:200]}" if syncs else ""))
    check(len(syncs) <= n_chunks,
          f"{what}: no host synchronisation but one a chunk")


def tiny_omni3d(root: Path) -> dict:
    """tests/fixtures/tiny_omni3d.py's dataset under `root`. The fixture
    writes its images with cv2.imwrite (BGR in), which the card's machine
    lacks: the port's PNG writer stands in for that one call."""
    spec = importlib.util.spec_from_file_location(
        "tiny_omni3d", Path(__file__).resolve().parent / "tests" / "fixtures"
        / "tiny_omni3d.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = types.SimpleNamespace(
        imwrite=lambda path, bgr: write_png(path, bgr[..., ::-1]) or True)
    try:
        return fixture.build_dataset(root)
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def set_serving(module, quant_mode: str, gelu: str) -> None:
    """Put every trunk product of `module` in `quant_mode` and every trunk
    MLP on `gelu`, keeping the weights, so two settings compare on the same
    weights."""
    for mod in module.modules():
        if isinstance(mod, quant.QDense):
            mod.quant = quant_mode
        elif isinstance(mod, Mlp):
            mod.approximate = GELUS[gelu]


def reset_counts() -> None:
    reset_attention_counts()
    quant.int8_gemm.launches = 0
    quant.quantize_rows.launches = 0


def rel_cos(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """||a - b|| / ||b|| and the cosine of a and b, in f32."""
    a, b = a.float().flatten(), b.float().flatten()
    return ((a - b).norm() / b.norm()).item(), (
        (a @ b) / (a.norm() * b.norm())).item()


def quant_phase() -> dict:
    """The W8A8 int8 serving option at full width: oracle LIFT as bench.py
    builds it with OVMONO3D_QUANT=int8, then GEO with int8 and tanh-GELU
    trunks as tools/bench_geo_models.py --quant int8 --gelu tanh builds
    them. Returns the launches of kernels 10, 1 and 7 and of the
    quantization in the timed runs."""
    t0 = time.perf_counter()
    cfg = flagship_config(S)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, quant="int8"))
    model = lift_model(cfg)
    say("quant", f"flagship model, quant=int8 (896^2, seed 0) built in "
                 f"{time.perf_counter() - t0:.1f} s")
    inputs = bench_inputs()
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(QUANT_WARMUP + QUANT_TIMED, 1, S, S, 3,
                        device="cuda", generator=g) * 255.0
    with torch.inference_mode():
        serve(model, images[:QUANT_WARMUP], inputs)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        dets, lats = serve(model, images[QUANT_WARMUP:], inputs)
        out = {"int8": quant.int8_gemm.launches,
               "quant": quant.quantize_rows.launches,
               "fwd": attention.flash_attention_packed.launches}
        peak = torch.cuda.max_memory_allocated()
    check(out["int8"] == LIFT_INT8_LAUNCHES * QUANT_TIMED
          and out["quant"] == out["int8"],
          f"{out['int8']} kernel-10 launches and {out['quant']} of the "
          f"quantization for {QUANT_TIMED} LIFT requests "
          f"({LIFT_INT8_LAUNCHES} each)")
    check(out["fwd"] == 12 * QUANT_TIMED,
          f"{out['fwd']} kernel-1 launches for {QUANT_TIMED} LIFT requests")
    for det in dets:
        check_detections(det)
    p50 = statistics.median(lats) * 1e3
    say("quant", f"int8 LIFT, {QUANT_TIMED} requests (B=1, {N_BOXES} oracle "
                 f"boxes): {rate(lats)}; per request "
                 f"{out['int8'] // QUANT_TIMED} kernel-10 and "
                 f"{out['fwd'] // QUANT_TIMED} kernel-1 launches; peak memory "
                 f"{peak} bytes")
    with torch.inference_mode():
        device_profile("quant", lambda: serve(
            model, images[QUANT_WARMUP:QUANT_WARMUP + 5], inputs), 5, p50,
            per="image", repeat=1)
    compare_quant_lift(model, images[QUANT_WARMUP], inputs)
    del model, images, dets
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    models = geo.build_geo_models("vit_h", depth_bf16=True, device="cuda",
                                  seed=0, quant="int8", gelu="tanh")
    geo_weights(models)
    say("quant", f"GEO models, quant=int8 and gelu=tanh in SAM ViT-H and "
                 f"Depth-Pro's trunks (seed 0, weights as the geo phase), "
                 f"built in {time.perf_counter() - t0:.1f} s")
    requests = geo_requests(GEO_QUANT_WARMUP + GEO_QUANT_TIMED, seed=2)
    serve_geo(models, requests[:GEO_QUANT_WARMUP])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    preds, lats = serve_geo(models, requests[GEO_QUANT_WARMUP:])
    geo_out = {"int8": quant.int8_gemm.launches,
               "quant": quant.quantize_rows.launches,
               "fwd": attention.flash_attention_packed.launches,
               "relpos": attention.rel_pos_flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    n = GEO_QUANT_TIMED
    check(geo_out["int8"] == GEO_INT8_LAUNCHES * n
          and geo_out["quant"] == geo_out["int8"],
          f"{geo_out['int8']} kernel-10 launches and {geo_out['quant']} of "
          f"the quantization for {n} GEO images ({GEO_INT8_LAUNCHES} each)")
    check(geo_out["fwd"] == 72 * n and geo_out["relpos"] == 32 * n,
          f"kernel-1 / kernel-7 launches {geo_out['fwd']} / "
          f"{geo_out['relpos']} for {n} GEO images")
    check_geo_preds(preds)
    p50 = statistics.median(lats) * 1e3
    stages = geo_stages(models, requests[GEO_QUANT_WARMUP:])
    say("quant", f"int8 + tanh GEO, {n} images of {GEO_W}x{GEO_H}, "
                 f"{GEO_BOXES} oracle boxes: {rate(lats)}; per image "
                 f"{geo_out['int8'] // n} kernel-10, {geo_out['relpos'] // n} "
                 f"kernel-7 and {geo_out['fwd'] // n} kernel-1 launches; "
                 f"{sum(map(len, preds)) / n:.1f} boxes; peak memory {peak} "
                 "bytes; device ms per image by stage span: "
                 + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    with torch.inference_mode():
        device_profile("quant", lambda: serve_geo(
            models, requests[GEO_QUANT_WARMUP:GEO_QUANT_WARMUP + 2]), 2, p50,
            per="image", repeat=1)
    compare_quant_geo(models, requests[GEO_QUANT_WARMUP])
    return {k: out.get(k, 0) + geo_out[k] for k in geo_out}


def compare_quant_lift(model, image, inputs) -> None:
    """One request with quant=int8 and with quant="none" on the same
    weights: the trunk's last_feat held to the JAX package's own limits for
    W8A8 against bf16 (a guard of the model: the kernel is held to its plain
    version in the kernel phase); corners3d printed beside, unchecked."""
    feats = []
    hook = model.backbone.vit.register_forward_hook(
        lambda mod, args, out: feats.append(out["last_feat"]))
    dets = {}
    try:
        with torch.inference_mode():
            for mode in ("int8", "none"):
                set_serving(model, mode, "erf")
                dets[mode] = model(image, **inputs)
    finally:
        hook.remove()
        set_serving(model, "int8", "erf")
    rel, cos = rel_cos(feats[0], feats[1])
    d_corner = (dets["int8"].corners3d - dets["none"].corners3d).abs().max()
    say("quant", f"int8 vs bf16 trunk, same weights: last_feat "
                 f"{tuple(feats[1].shape)} ||diff|| / ||bf16|| {rel:.3e} "
                 f"(limit {QUANT_REL}, margin {QUANT_REL / max(rel, 1e-30):.1f}"
                 f"x), cosine {cos:.6f} (limit {QUANT_COS}, margin "
                 f"{(1 - QUANT_COS) / max(1 - cos, 1e-30):.1f}x); unchecked: "
                 f"corners3d max |diff| {d_corner.item():.3e} (scale "
                 f"{dets['none'].corners3d.abs().max().item():.3e})")
    check(rel < QUANT_REL and cos > QUANT_COS,
          "int8 trunk within the JAX package's limits of the bf16 trunk")


def compare_quant_geo(models, request) -> None:
    """One image with int8 + tanh trunks and with the bf16 + erf trunks of
    the same weights (and, printed beside, int8 + erf): the SAM embedding
    and the canonical inverse depth (as it is, and less the head's bias)
    held to GEO_QUANT_REL / GEO_QUANT_COS, a guard of the models; mask
    logits and fitted boxes printed unchecked."""
    runs = {}
    try:
        for name, mode, gelu in (("int8_tanh", "int8", "tanh"),
                                 ("int8_erf", "int8", "erf"),
                                 ("bf16_erf", "none", "erf")):
            for m in (models.sam_encoder, models.depth):
                set_serving(m, mode, gelu)
            trace: dict = {}
            preds = geo.predict_image(models, *request, trace=trace)
            runs[name] = (preds, trace)
    finally:
        for m in (models.sam_encoder, models.depth):
            set_serving(m, "int8", "tanh")
    failed = []
    for key, offset in (("embed", 0.0), ("canonical_inverse_depth", 0.0),
                        ("canonical_inverse_depth", GEO_DEPTH_BIAS),
                        ("mask_logits", 0.0)):
        ref = runs["bf16_erf"][1][key] - offset
        rel, cos = rel_cos(runs["int8_tanh"][1][key] - offset, ref)
        rel_e, cos_e = rel_cos(runs["int8_erf"][1][key] - offset, ref)
        name = f"{key} less {offset}" if offset else key
        checked = key != "mask_logits"
        say("quant", f"GEO int8 + tanh vs bf16 + erf, {name} "
                     f"{tuple(ref.shape)}: ||diff|| / ||ref|| {rel:.3e}, "
                     f"cosine {cos:.6f}"
                     + (f" (limits {GEO_QUANT_REL} / {GEO_QUANT_COS}, "
                        f"margins {GEO_QUANT_REL / max(rel, 1e-30):.1f}x / "
                        f"{(1 - GEO_QUANT_COS) / max(1 - cos, 1e-30):.1f}x)"
                        if checked else " (unchecked)")
                     + f"; int8 + erf vs bf16 + erf {rel_e:.3e} / "
                       f"{cos_e:.6f}")
        if checked and not (rel < GEO_QUANT_REL and cos > GEO_QUANT_COS):
            failed.append(name)
    for a, b in zip(runs["int8_tanh"][0], runs["bf16_erf"][0]):
        say("quant", f"  box {a['category_id']}: center int8 "
                     f"{[round(x, 3) for x in a['center_cam']]} bf16 "
                     f"{[round(x, 3) for x in b['center_cam']]}; dims int8 "
                     f"{[round(x, 3) for x in a['dimensions']]} bf16 "
                     f"{[round(x, 3) for x in b['dimensions']]}")
    check(not failed, f"GEO int8 + tanh vs bf16 + erf within limits: "
                      f"{failed} not")


def ln_inputs(shape, dtype, seed):
    """x ~ N(0.8, 1.7^2) (the TPU probe's residual-stream input), scale ~
    U(0.5, 1.5), bias ~ N(0, 0.1^2), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") * 1.7 + 0.8).to(dtype)
    return (x, torch.rand(c, generator=g, device="cuda") + 0.5,
            torch.randn(c, generator=g, device="cuda") * 0.1)


def ln_kernel_phase() -> dict:
    """Kernel 9 against layer_norm_ref at LN_SHAPES in every dtype pair, its
    autograd Function's gradients against the plain version's, and its
    times at the trunk; kernel 12 (the probe's v2, v3, v4) against their
    plain versions at the probe's [8, 4097, 768]. Launches made here are
    not a path's: the paths reset the counts."""
    worst = 0.0
    for i, (name, shape) in enumerate(LN_SHAPES.items()):
        for in_dt, out_dt in LN_DTYPES:
            x, scale, bias = ln_inputs(shape, in_dt, seed=i)
            got = layernorm.layer_norm_fused(x, scale, bias, 1e-6, out_dt)
            torch.cuda.synchronize()
            want = layernorm.layer_norm_ref(x, scale, bias, 1e-6, out_dt)
            atol, rtol = LN_TOL[out_dt]
            err = (got.float() - want.float()).abs()
            excess = (err - rtol * want.float().abs()).max().item()
            mx = err.max().item()
            tag = (f"k9 {name} {tuple(shape)} {str(in_dt)[6:]}->"
                   f"{str(out_dt)[6:]}")
            ulps = ""
            if out_dt == torch.bfloat16:
                n_diff, n_beyond = bf16_ulp_diff(got, want)
                ulps = (f"; {n_diff} of {got.numel()} elements differ, "
                        f"{n_beyond} by more than one bf16 ulp")
                check(n_beyond == 0, f"{tag}: no element more than one bf16 "
                                     "ulp from the plain version")
            say("ln", f"{tag}: max_abs_err {mx:.3e} (limit {atol} + {rtol} "
                      f"|ref|, margin {atol - excess:.3e}){ulps}")
            check(got.dtype == out_dt and bool(torch.isfinite(got).all()),
                  f"{tag}: finite {out_dt} output")
            check(excess <= atol, f"{tag}: within {atol} + {rtol} |ref|")
            if out_dt == in_dt:
                worst = max(worst, mx)
            del x, got, want, err
    # The Function's backward is the plain math's: with a loss linear in
    # the output both gradients take the same upstream gradient.
    x, scale, bias = ln_inputs((3, 577, 1024), torch.float32, seed=20)
    w = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(21))
    grads = []
    for fn in (layernorm.layer_norm_fused, layernorm.layer_norm_ref):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        (fn(*leaves, 1e-6, torch.float32) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for gname, a, b in zip(("x", "scale", "bias"), *grads):
        d = (a - b).abs().max().item()
        say("ln", f"k9 backward d{gname}: max abs diff {d:.3e} against the "
                  f"plain autograd (max |grad| {b.abs().max().item():.3e})")
        check(d <= 1e-5 * max(1.0, b.abs().max().item()),
              f"k9 backward d{gname} within 1e-5 of the plain autograd")
    out = {}
    for name in ("trunk_b8", "trunk_b1"):
        x, scale, bias = ln_inputs(LN_SHAPES[name], torch.bfloat16, seed=0)
        lib = ln_probe.library(x, scale, bias)
        fused = lambda: layernorm.layer_norm_fused(  # noqa: E731
            x, scale, bias, 1e-6, torch.bfloat16)
        t = {"ms": time_ms(fused),
             "device_ms": device_ms(fused, "ln_fwd_kernel"),
             "library_device_ms": device_ms(lib, "layer_norm"),
             "plain_ms": time_ms(lambda: layernorm.layer_norm_ref(
                 x, scale, bias, 1e-6, torch.bfloat16)),
             "library_ms": time_ms(lib),
             "bound_ms": ln_probe.bound_ms(x, torch.bfloat16),
             "bound_by": "bytes"}
        say("ln", f"k9 {name} {LN_SHAPES[name]} bf16->bf16, median of timed "
                  f"calls: kernel {t['ms']:.4f} ms (device "
                  f"{t['device_ms']:.4f} ms by the profiler), plain "
                  f"{t['plain_ms']:.4f} ms, F.layer_norm (bf16 weights) "
                  f"{t['library_ms']:.4f} ms (device "
                  f"{t['library_device_ms']:.4f} ms), bound "
                  f"{t['bound_ms']:.4f} ms (bytes)")
        out[name] = t
    out = {"k9": {**out["trunk_b8"], "max_abs_err": worst}}
    # Kernel 12's instances at the probe's shape, before the probe's path:
    # each within 2e-2 + 2e-2 |ref| of its own plain version with no element
    # more than one bf16 ulp from it (the two differ in the order of the f32
    # sums and in rsqrtf alone); and the control, v4's instance against v2's
    # plain version, apart in at least 10x as many elements and 0.1% of
    # them (v4's bf16 squares). v3 differs from v2 by at most an f32 ulp of
    # its statistics, which bf16 outputs cannot show apart from the sum order.
    x, scale, bias = ln_probe.inputs(8)
    plain_v2 = layernorm.ln_probe_ref(x, scale, bias, "v2")
    counts = {}
    for variant in ("v2", "v3", "v4"):
        got = getattr(layernorm, f"ln_probe_{variant}")(x, scale, bias)
        torch.cuda.synchronize()
        want = layernorm.ln_probe_ref(x, scale, bias, variant)
        err = (got.float() - want.float()).abs()
        excess = (err - 2e-2 * want.float().abs()).max().item()
        n_diff, n_beyond = bf16_ulp_diff(got, want)
        counts[variant] = (n_diff, bf16_ulp_diff(got, plain_v2)[0])
        say("ln", f"k12 {variant} [8, 4097, 768]: max_abs_err "
                  f"{err.max().item():.3e} against its plain version "
                  f"(limit 2e-2 + 2e-2 |ref|); {n_diff} of {got.numel()} "
                  f"elements differ from it, {n_beyond} by more than one "
                  f"bf16 ulp; {counts[variant][1]} differ from v2's plain "
                  "version")
        check(excess <= 2e-2, f"k12 {variant} within 2e-2 + 2e-2 |ref|")
        check(n_beyond == 0, f"k12 {variant}: no element more than one bf16 "
                             "ulp from its plain version")
    n_own, n_v2 = counts["v4"]
    check(n_v2 >= max(10 * n_own, 1e-3 * x.numel()),
          f"control: k12 v4's instance differs from v2's plain version in "
          f"{n_v2} elements, at least 10x the {n_own} against its own and "
          "0.1% of them")
    return out


def ln_paths() -> dict:
    """The entry points of kernels 9 and 12, each with the counts at 0
    before it and read after: layer_norm_fused forward and backward at the
    trunk's B=8 (the differentiable op), then the probe's run at
    [8, 4097, 768]. Returns their kernel entries' numbers."""
    x, scale, bias = ln_inputs(LN_SHAPES["trunk_b8"], torch.bfloat16, seed=0)
    layernorm.layernorm_fwd.launches = dict.fromkeys(layernorm.MODES, 0)
    x.requires_grad_()
    y = layernorm.layer_norm_fused(x, scale, bias)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    k9 = layernorm.layernorm_fwd.launches["f32_stats"]
    check(k9 == 1 and bool(torch.isfinite(x.grad).all()),
          f"layer_norm_fused launched kernel 9 once ({k9}), finite gradient")
    layernorm.layernorm_fwd.launches = dict.fromkeys(layernorm.MODES, 0)
    rows = ln_probe.rows(8)
    launches = dict(layernorm.layernorm_fwd.launches)
    say("ln", f"probe path: launches {launches}")
    out = {"k9_launches": k9}
    for r in rows:
        device = (f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r
                  else "")
        own = ("" if "n_diff" not in r else
               f" ({r['n_diff']} elements differ from its plain version, "
               f"{r['n_beyond_ulp']} by more than one bf16 ulp; "
               f"{r['n_diff_v2']} from v2's)")
        say("ln", f"probe {r['name']:<16} {r['ms']:.4f} ms{device}, max|err| "
                  f"vs v0 {r['err_v0']:.3e}{own}, bound {r['bound_ms']:.4f} "
                  f"ms, F.layer_norm {r['library_ms']:.4f} ms")
        if "variant" in r:
            mode = layernorm.PROBE_MODES[r["variant"]]
            check(launches[mode] > 0, f"probe {r['variant']} launched {mode}")
            check(r["n_beyond_ulp"] == 0, f"probe {r['variant']}: no element "
                                          "more than one bf16 ulp off")
            out[f"k12_{r['variant']}"] = {
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms", "max_abs_err")},
                "bound_by": "bytes", "launches": launches[mode]}
    return out


def sweep_kernel_phase() -> dict:
    """Kernel 11: every instance against attn_sweep_ref on peaked rows at a
    small ragged shape, and two controls that must fail the same limit (the
    bf16-softmax instance against the f32-softmax plain version; the mean
    of v, what uniform weights give), the instances that differ only in
    block_q bit-identical; then the probe's path at [1, 4097, 12, 64] with
    the counts at 0: each instance's time by events and by the profiler's
    device time in turns with SDPA's, its error against the plain version
    at its block_k (and the block_q identity again), and the bound."""
    lim = (f"at most {sweep_probe.ULP_SHARE} of the elements more than one "
           f"bf16 ulp and none more than {sweep_probe.ATOL} apart")
    q, k, v = sweep_probe.checked_inputs(SWEEP_SMALL, seed=30)
    outs = {}
    for bq, bk, f32 in attn_sweep.INSTANCES:
        got = outs[(bq, bk, f32)] = attn_sweep.attn_sweep(q, k, v, bq, bk, f32)
        torch.cuda.synchronize()
        e = sweep_probe.error(got, attn_sweep.attn_sweep_ref(q, k, v, bk, f32))
        say("sweep", f"k11 bq{bq} bk{bk} f32={f32} at {SWEEP_SMALL}: "
                     f"max_abs_err {e['max_abs_err']:.3e}, "
                     f"{e['share_beyond_ulp']:.3e} of the elements > 1 ulp")
        check(e["ok"], f"k11 bq{bq} bk{bk} f32={f32} at {SWEEP_SMALL} "
                       f"within {lim}")
    got = attn_sweep.attn_sweep(q, k, v, 64, 64, False)
    controls = {
        "the bf16-softmax instance against the f32-softmax plain version":
            (got, attn_sweep.attn_sweep_ref(q, k, v, 64, True)),
        "the mean of v (uniform weights) against the plain version":
            (v.float().mean(1, keepdim=True).expand_as(v).bfloat16(),
             attn_sweep.attn_sweep_ref(q, k, v, 64, True))}
    for what, (a, b) in controls.items():
        e = sweep_probe.error(a, b)
        say("sweep", f"control, {what}: max_abs_err {e['max_abs_err']:.3e}, "
                     f"{e['share_beyond_ulp']:.3e} of the elements > 1 ulp")
        check(not e["ok"], f"control {what} fails {lim}")
    for (bk, f32), same in sweep_probe.block_q_identical(outs).items():
        say("sweep", f"k11 bk{bk} f32={f32} at {SWEEP_SMALL}: block_q 64 and "
                     f"128 bit-identical: {same}")
        check(same, f"k11 bk{bk} f32={f32}: outputs bit-identical across "
                    f"block_q")
    attn_sweep.attn_sweep.launches = dict.fromkeys(attn_sweep.INSTANCES, 0)
    rows = sweep_probe.rows()
    launches = dict(attn_sweep.attn_sweep.launches)
    out = {}
    for r in rows:
        inst = (r["block_q"], r["block_k"], r["softmax_f32"])
        name = (f"bq{inst[0]} bk{inst[1]} "
                f"{'f32' if inst[2] else 'bf16'} softmax")
        say("sweep", f"k11 {name} {list(sweep_probe.SHAPE)}: {r['ms']:.4f} "
                     f"ms events / {r['device_ms']:.4f} ms device, bound "
                     f"{r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA "
                     f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f} "
                     f"ms, plain {r['plain_ms']:.4f} ms, max_abs_err "
                     f"{r['max_abs_err']:.3e} on peaked rows "
                     f"({r['share_beyond_ulp']:.3e} > 1 ulp), bit-identical "
                     f"across block_q {r['block_q_identical']}; "
                     f"{launches[inst]} launches")
        check(r["ok"], f"k11 {name} within {lim}")
        check(r["block_q_identical"],
              f"k11 {name}: bit-identical across block_q on peaked rows")
        check(launches[inst] > 0, f"k11 {name} launched on the probe path")
        out[inst] = {**{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "max_abs_err", "device_ms",
                                          "library_device_ms")},
                     "launches": launches[inst]}
    return out


class CheckedHelper(Omni3DEvaluationHelper):
    """The evaluation helper, holding every prediction it is given finite."""

    def add_image(self, dataset, gt, pred, eval_prox=False):
        for key, x in pred.items():
            check(bool(np.isfinite(np.asarray(x, np.float64)).all()),
                  f"eval {dataset}: {key} finite")
        self.n_dets = getattr(self, "n_dets", 0) + len(pred["classes"])
        super().add_image(dataset, gt, pred, eval_prox)


def random_image_loader(seed: int):
    """A record's image: uniform uint8 noise of its size from (seed,
    image_id), made on the host as a decoder would."""
    def load(rec):
        rng = np.random.default_rng((seed, rec["image_id"]))
        return rng.integers(0, 256, (rec["height"], rec["width"], 3),
                            dtype=np.uint8)
    return load


def eval_phase() -> int:
    """The Omni3D evaluation path: the flagship (seed 0, as lift_model) on
    the eval CLI's two generated datasets, through eval_cli.evaluate_dataset
    and the helper with its 3D IoU on the card, in oracle and learned-2D
    mode; GT as the prediction; the card's 3D IoU against the CPU's; kernel
    against attention_ref on one batch of each mode. Returns kernel 1's
    launches in the two timed runs."""
    cfg = dataclasses.replace(Config(), model=flagship_config(S))
    model = lift_model(cfg.model)
    n_blocks = len(model.backbone.vit.blocks())
    names = json.loads(CATEGORY_META.read_text())["thing_classes"]
    run = eval_cli.make_run_fn(model)
    total = 0
    for mode, oracle in (("oracle", True), ("learned", False)):
        data, novel = synthetic_datasets(50, names, num=EVAL_IMAGES,
                                         oracle=oracle)
        loaders = {name: random_image_loader(i)
                   for i, name in enumerate(data)}
        first = next(iter(data))
        eval_cli.evaluate_dataset(      # warm-up, not counted
            cfg, model, data[first][:EVAL_BATCH], loaders[first], EVAL_BATCH,
            Omni3DEvaluationHelper(50, names, device="cuda"), "warmup",
            run=run)
        helper = CheckedHelper(50, names, novel_categories=novel,
                               device="cuda")
        reset_attention_counts()
        t0 = time.perf_counter()
        stats = [eval_cli.evaluate_dataset(cfg, model, recs, loaders[name],
                                           EVAL_BATCH, helper, name, run=run)
                 for name, recs in data.items()]
        wall = time.perf_counter() - t0
        launches = attention.flash_attention_packed.launches
        n_img = sum(st["images"] for st in stats)
        batch_ms = [ms for st in stats for ms in st["batch_ms"]]
        check(launches == n_blocks * len(batch_ms),
              f"eval {mode}: {launches} kernel-1 launches for "
              f"{len(batch_ms)} batches of {n_blocks} blocks")
        total += launches
        summary = helper.summarize_all()
        say("eval", f"{mode}: {n_img} images in {wall:.3f} s, "
                    f"{n_img / wall:.3f} img/s; p50 of a batch of "
                    f"{EVAL_BATCH} {statistics.median(batch_ms):.3f} ms "
                    f"(upload + model + download); data "
                    f"{sum(st['data_s'] for st in stats):.3f} s against "
                    f"compute {sum(st['compute_s'] for st in stats):.3f} s; "
                    f"{launches} kernel-1 launches; "
                    f"{helper.n_dets} detections")
        for name, res in [*summary["datasets"].items(),
                          ("overall", summary["overall"])]:
            say("eval", f"{mode} {name}: AP2D {res['AP2D']:.4f} AP3D "
                        f"{res['AP3D']:.4f} AP3D@15 {res['AP3D@15']:.4f} "
                        f"AP3D@25 {res['AP3D@25']:.4f}")
            check(all(math.isfinite(res[k]) for k in ("AP2D", "AP3D")),
                  f"eval {mode} {name}: finite AP")
            if oracle:
                check(abs(res["AP2D"] - 100.0) < 1e-6,
                      f"eval {mode} {name}: GT-oracle boxes give AP2D 100")
        batch = next(iter(build_test_iterator(
            cfg, data[first][:EVAL_BATCH], EVAL_BATCH, loaders[first],
            max_oracle=max(64, cfg.test.detections_per_image))))[1]
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        with torch.inference_mode():
            device_profile("eval", lambda: run(batch), 1,
                           statistics.median(batch_ms), per="batch")
        if oracle:
            compare_eval_oracle(model, run, batch)
        else:
            compare_eval_learned(model, run, batch)
    gt_as_prediction(names)
    iou3d_card_vs_cpu(names)
    set_attention(model, attention.dot_product_attention)
    return total


def _det_fields(det, keys=("classes", "valid", "boxes", "corners3d",
                           "center_cam", "dimensions")):
    return {k: getattr(det, k) for k in keys}


def compare_eval_oracle(model, run, batch) -> None:
    """One batch of the oracle mode with attention_ref in every block: the
    3D fields of the valid slots within 2e-2 of their scale (the slice
    phase's limits)."""
    with torch.inference_mode():
        kern = _det_fields(run(batch))
        set_attention(model, attention.attention_ref)
        plain = _det_fields(run(batch))
        set_attention(model, attention.dot_product_attention)
    valid = plain["valid"]
    for field in ("center_cam", "dimensions", "corners3d"):
        a, b = kern[field][valid], plain[field][valid]
        dev, scale = (a - b).abs().max().item(), b.abs().max().item()
        say("eval", f"oracle, kernel vs attention_ref on {valid.sum().item()} "
                    f"boxes: {field} max abs deviation {dev:.3e} (scale "
                    f"{scale:.3e})")
        check(dev <= 2e-2 * scale + 1e-4,
              f"eval oracle {field} within 2e-2 of its scale")


def _matches(a_boxes, a_cls, b_boxes, b_cls, tol: float) -> list:
    """Greedy (i, j) pairs of rows of a and b with one class and boxes
    within `tol` pixels (each b row used once)."""
    if not len(a_boxes) or not len(b_boxes):
        return []
    close = ((a_boxes[:, None] - b_boxes[None]).abs().amax(-1) <= tol) \
        & (a_cls[:, None] == b_cls[None])
    pairs, used = [], set()
    for i, row in enumerate(close.cpu().tolist()):
        j = next((j for j, ok in enumerate(row) if ok and j not in used),
                 None)
        if j is not None:
            pairs.append((i, j))
            used.add(j)
    return pairs


def compare_eval_learned(model, run, batch) -> None:
    """One batch of the learned mode (the pixels evaluate_dataset maps)
    with the kernels and with attention_ref. Printed: how many of each
    image's proposals have no proposal of the other run within 0.01 px and
    within 0.5 px, how far the rest move, how many detections change (no
    detection of the same class within 0.5 px), and the 3D fields of the
    detections both runs share (kernel and plain attention move the RPN's
    deltas by ~1e-3, which the anchors scale to fractions of a pixel;
    near-tied proposals swap, and a sub-pixel move of a box moves a seeded
    depth near 0 by its own size). Checked: detections are shared, and the
    kernel run's 2D detections lifted by each run (the cube model on one
    set of boxes, as compare_demo_lift) give 3D fields within 2e-2 of
    their scale on the valid slots (compare_eval_oracle's limit)."""
    rpn = model.cfg.rpn
    hw = batch["im_hw"].float()
    out = {}
    with torch.inference_mode():
        for name, fn in (("kernel", attention.dot_product_attention),
                         ("plain", attention.attention_ref)):
            set_attention(model, fn)
            feats = model.features(batch["image"])
            logits, deltas, anchors, sizes = model._rpn_forward(feats)
            props = rcnn3d.rpn_proposals(
                logits, deltas, anchors, sizes, hw, rpn.pre_nms_topk_test,
                rpn.post_nms_topk_test, rpn.nms_thresh, rpn.min_box_size)
            if name == "kernel":
                det2d = dict(zip(("oracle_boxes", "oracle_scores",
                                  "oracle_classes", "oracle_valid"),
                                 model._detect_2d(feats, batch["im_hw"])))
            out[name] = (props, _det_fields(run(batch)),
                         _det_fields(run({**batch, **det2d})))
        set_attention(model, attention.dot_product_attention)
    (kp, kd, kl), (pp, pd, pl) = out["kernel"], out["plain"]
    changed_d, n_p, n_d, devs = 0, 0, 0, {}
    nearest = []      # each proposal's distance to the plain run's nearest
    for i in range(batch["image"].shape[0]):
        a_p, b_p = kp[0][i][kp[2][i]], pp[0][i][pp[2][i]]
        n_p += len(a_p)
        if len(a_p) and len(b_p):
            nearest.append((a_p[:, None] - b_p[None]).abs().amax(-1)
                           .amin(1))
        else:
            nearest.append(torch.full((len(a_p),), math.inf,
                                      device=a_p.device))
        a = {k: v[i][kd["valid"][i]] for k, v in kd.items()}
        b = {k: v[i][pd["valid"][i]] for k, v in pd.items()}
        pairs = _matches(a["boxes"], a["classes"], b["boxes"], b["classes"],
                         0.5)
        n_d += len(a["classes"])
        changed_d += len(a["classes"]) - len(pairs)
        for field in ("center_cam", "dimensions", "corners3d"):
            if pairs:
                x = a[field][[p for p, _ in pairs]]
                y = b[field][[q for _, q in pairs]]
                d, s = devs.get(field, (0.0, 0.0))
                devs[field] = (max(d, (x - y).abs().max().item()),
                               max(s, y.abs().max().item()))
    nearest = torch.cat(nearest)
    moved = nearest[nearest <= 0.5]
    if not len(moved):
        moved = torch.zeros(1)
    say("eval", f"learned, kernel vs attention_ref on {batch['image'].shape[0]}"
                f" images: of {n_p} proposals {int((nearest > 1e-2).sum())} "
                f"have no proposal of the plain run within 0.01 px and "
                f"{int((nearest > 0.5).sum())} none within 0.5 px (the "
                f"others move by at most {moved.max().item():.3f} px, median "
                f"{moved.median().item():.3f}); {changed_d} of {n_d} "
                f"detections change (class + box); on the shared ones "
                + ", ".join(f"{f} max abs deviation {d:.3e} (scale {s:.3e})"
                            for f, (d, s) in devs.items()))
    check(n_d > 0 and changed_d < n_d, "eval learned: shared detections")
    valid = det2d["oracle_valid"]
    check(torch.equal(kl["valid"], valid) and torch.equal(pl["valid"], valid)
          and bool(valid.any()), "eval learned: the lifted slots are valid")
    for field in ("center_cam", "dimensions", "corners3d"):
        x, y = kl[field][valid], pl[field][valid]
        dev, scale = (x - y).abs().max().item(), y.abs().max().item()
        say("eval", f"learned, the kernel run's {valid.sum().item()} 2D "
                    f"detections lifted with the kernel and with "
                    f"attention_ref: {field} max abs deviation {dev:.3e} "
                    f"(scale {scale:.3e})")
        check(dev <= 2e-2 * scale + 1e-4,
              f"eval learned {field} of one set of 2D detections within "
              f"2e-2 of its scale")


def gt_as_prediction(names) -> None:
    """GT as the prediction of every record of both generated datasets:
    AP2D = AP3D = 100 through the helper with its 3D IoU on the card."""
    data, _ = synthetic_datasets(50, names, num=EVAL_IMAGES)
    helper = Omni3DEvaluationHelper(50, names, device="cuda")
    for name, recs in data.items():
        for rec in recs:
            gt = eval_cli._record_gt(rec)
            helper.add_image(name, gt, {**gt,
                                        "scores": np.ones(len(gt["classes"]))})
    res = helper.summarize_all()["overall"]
    say("eval", f"GT as the prediction: AP2D {res['AP2D']:.4f} AP3D "
                f"{res['AP3D']:.4f}")
    check(abs(res["AP2D"] - 100.0) < 1e-6 and abs(res["AP3D"] - 100.0) < 1e-6,
          "GT as the prediction gives AP2D = AP3D = 100 on the card")


def iou3d_card_vs_cpu(names) -> None:
    """pairwise_iou3d on the card against the same call on the CPU: the GT
    cuboids of a generated dataset against themselves turned and shifted,
    and its time at that size."""
    data, _ = synthetic_datasets(50, names, num=EVAL_IMAGES)
    corners = np.concatenate([eval_cli._record_gt(r)["corners3d"]
                              for r in data["synthetic_a"]])
    a = torch.from_numpy(corners)
    c, s = math.cos(0.3), math.sin(0.3)
    rot = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    center = a.mean(1, keepdim=True)
    b = (a - center) @ rot.T + center + torch.tensor([0.1, 0.0, 0.2])
    cpu = iou3d.pairwise_iou3d(a, b)[1]
    ac, bc = a.cuda(), b.cuda()
    card = iou3d.pairwise_iou3d(ac, bc)[1]
    err = (card.cpu() - cpu).abs().max().item()
    ms = time_ms(lambda: iou3d.pairwise_iou3d(ac, bc), reps=5)
    say("eval", f"pairwise_iou3d {tuple(cpu.shape)} pairs: card vs CPU max "
                f"abs diff {err:.3e} (limit {EVAL_IOU_ATOL}); "
                f"{(cpu > 0).sum().item()} overlapping pairs; {ms:.3f} ms on "
                f"the card")
    check(err <= EVAL_IOU_ATOL, f"3D IoU on the card within {EVAL_IOU_ATOL} "
                                f"of the CPU")


def set_remat(model, policy: str | None) -> None:
    """Checkpoint the trunk's blocks under `policy` (None: no remat), as
    BackboneConfig.remat / remat_policy build it."""
    vit = model.backbone.vit
    vit.remat = policy is not None
    vit.remat_context = remat_context(policy or "dots_attn")


def updates(model, init: dict) -> dict:
    return {n: p.detach() - init[n] for n, p in model.named_parameters()}


def worst_rel(got: dict, want: dict) -> tuple[str, float]:
    """The entry whose ||got - want|| / ||want|| is largest."""
    rel = {n: float((got[n].float() - w.float()).norm()
                    / w.float().norm().clamp(min=1e-30))
           for n, w in want.items()}
    name = max(rel, key=rel.get)
    return name, rel[name]


def tile(batch: dict, k: int) -> dict:
    """`batch` (and its draws) repeated k times along the batch."""
    return {key: ({d: v.repeat(k, *[1] * (v.dim() - 1)) for d, v in val.items()}
                  if key == "draws" else
                  val.repeat(k, *[1] * (val.dim() - 1)))
            for key, val in batch.items()}


def micro(batch: dict, i: int, n: int) -> dict:
    """The i-th of n micro-batches of `batch` (and of its draws)."""
    s = slice(i * n, (i + 1) * n)
    return {key: ({d: v[s] for d, v in val.items()} if key == "draws"
                  else val[s]) for key, val in batch.items()}


def one_update(model, init: dict, batch: dict, k: int) -> dict:
    """From `init`, k SGD micro-steps of `with_grad_accum` over k equal
    slices of `batch` (one plain step for k = 1); the parameters' update."""
    model.load_state_dict(init)
    opt = with_grad_accum(Optimizer(SolverConfig(), model), k)
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, model.cfg.stabilize)
    n = batch["image"].shape[0] // k
    for i in range(k):
        state, metrics = step(state, micro(batch, i, n))
        check_losses(metrics, f"k={k} micro-step {i}")
    check(int(opt.count) == 1 and int(state.skipped) == 0,
          f"one update from {k} micro-steps, none skipped")
    return updates(model, init)


def mean_gradient_update(model, init: dict, batch: dict, k: int) -> dict:
    """From `init`, one plain SGD update on the mean of the gradients of k
    equal slices of `batch`, each computed alone: what k micro-steps of
    `with_grad_accum` must give. The parameters' update."""
    model.load_state_dict(init)
    opt = Optimizer(SolverConfig(), model)
    n = batch["image"].shape[0] // k
    total = [torch.zeros_like(p) for p in opt.params]
    for i in range(k):
        mb = micro(batch, i, n)
        losses = model.compute_losses(mb["image"], mb["K"], mb["im_hw"],
                                      mb["im_scale_ratio"], batch_gt(mb),
                                      draws=mb["draws"])
        check_losses(losses, f"micro-batch {i} alone")
        grads = torch.autograd.grad(sum(losses.values()), opt.params,
                                    allow_unused=True)
        for t, g in zip(total, grads):
            if g is not None:
                t.add_(g)
    with torch.no_grad():
        opt.step([t / k for t in total])
    check(int(opt.count) == 1, "one plain update")
    return updates(model, init)


def remat_phase() -> dict:
    """The flagship unfrozen at 896^2, B=REMAT_B, under no remat and each
    remat policy; B=REMAT_B_FULL under dots_attn; gradient accumulation
    against one step of the whole batch. Returns the kernel 3 and 4
    launches of the timed steps."""
    t0 = time.perf_counter()
    _, model = train_model()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params0 = {n: init[n] for n, _ in model.named_parameters()}
    n_blocks = len(model.backbone.vit.blocks())
    batch = synthetic_batch(REMAT_B, TRAIN_GT, seed=1)
    draws = sampling_draws(model, batch, seed=4)
    say("remat", f"flagship unfrozen built in {time.perf_counter() - t0:.1f}"
                 f" s; B={REMAT_B}, {TRAIN_GT} GT slots, SGD")
    launches = {"lse": 0, "bwd": 0, "fwd": 0}
    grads = {}
    for policy in REMAT_POLICIES:
        name = policy or "none"
        set_remat(model, policy)
        model.load_state_dict(init)
        _, grads[name] = trunk_loss_and_grads(model, batch, draws)
        opt = Optimizer(SolverConfig(), model)
        state = create_train_state(model, opt, seed=0)
        step = make_train_step(model, opt, model.cfg.stabilize)
        for _ in range(REMAT_WARMUP):
            state, metrics = step(state, batch)
            check_losses(metrics, f"{name} warm-up step")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_attention_counts()
        lats = []
        for _ in range(REMAT_TIMED):
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t1)
            check_losses(metrics, f"{name} timed step")
        lse = attention.flash_attention_packed_lse.launches
        bwd = attention.flash_attention_packed_bwd.launches
        launches["lse"] += lse
        launches["bwd"] += bwd
        launches["fwd"] += attention.flash_attention_packed.launches
        peak = torch.cuda.max_memory_allocated()
        check(int(state.skipped) == 0, f"{name}: no step skipped")
        per_step = (lse // REMAT_TIMED, bwd // REMAT_TIMED)
        want = (n_blocks * (2 if policy in ("full", "dots") else 1), n_blocks)
        check(per_step == want and lse % REMAT_TIMED == 0,
              f"{name}: kernel 3 / 4 launches a step {per_step}, want {want}")
        p50 = statistics.median(lats) * 1e3
        busy = device_profile("remat", lambda: step(state, batch), 1, p50)
        say("remat", f"policy {name}: p50 {p50:.3f} ms/step of "
                     f"{REMAT_TIMED} (after {REMAT_WARMUP} warm-up), device "
                     f"{busy:.3f} ms a step, peak memory {peak} bytes "
                     f"({peak / 2**30:.2f} GiB), {per_step[0]} kernel-3 and "
                     f"{per_step[1]} kernel-4 launches a step")
    for name in ("full", "dots", "dots_attn"):
        same = all(torch.equal(grads[name][n], g)
                   for n, g in grads["none"].items())
        worst, rel = worst_rel(grads[name], grads["none"])
        say("remat", f"trunk gradients under {name} against no remat, same "
                     f"batch and draws: bit-identical {same}; largest "
                     f"relative difference {rel:.3e} ({worst}; limit "
                     f"{TRAIN_GRAD_REL})")
        check(same or rel <= TRAIN_GRAD_REL,
              f"{name}: trunk gradients within {TRAIN_GRAD_REL}")
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    # The config's batch under dots_attn: running out of memory fails.
    big = synthetic_batch(REMAT_B_FULL, TRAIN_GT, seed=2)
    set_remat(model, "dots_attn")
    model.load_state_dict(init)
    opt = Optimizer(SolverConfig(), model)
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, model.cfg.stabilize)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    try:
        for _ in range(2):                     # one warm-up, one timed
            t1 = time.perf_counter()
            state, metrics = step(state, big)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
    except torch.cuda.OutOfMemoryError as err:
        check(False, f"B={REMAT_B_FULL} fits under dots_attn: {err}")
    check_losses(metrics, f"B={REMAT_B_FULL} step")
    say("remat", f"B={REMAT_B_FULL} under dots_attn: {ms[1]:.3f} ms for one "
                 f"step after one warm-up ({ms[0]:.3f}), "
                 f"{REMAT_B_FULL * 1e3 / ms[1]:.3f} img/s, peak memory "
                 f"{torch.cuda.max_memory_allocated()} bytes")
    del state, step, opt

    # Accumulation under dots_attn. On REMAT_ACCUM distinct micro-batches
    # of REMAT_B: the accumulated update against one plain update on the
    # mean of their gradients, each taken alone (optax.MultiSteps' update;
    # a micro-step dropped or counted twice is off by a quarter of the
    # update). Against one step of their REMAT_B_FULL images, on the same
    # images and draws: each micro-batch normalizes its losses by its own
    # counts, so the two are the same update when every micro-batch's
    # counts are equal, which the checked batch (one B=REMAT_B batch four
    # times) makes so; the distinct images' difference is printed.
    base = dict(batch, draws=draws)
    acc = one_update(model, init, tile(base, REMAT_ACCUM), REMAT_ACCUM)
    whole = one_update(model, init, tile(base, REMAT_ACCUM), 1)
    worst, rel = worst_rel(acc, whole)
    say("remat", f"grad_accum_steps={REMAT_ACCUM} x B={REMAT_B} against one "
                 f"B={REMAT_B_FULL} step (the same {REMAT_B} images and "
                 f"draws four times, under dots_attn): largest relative "
                 f"difference of a parameter's update {rel:.3e} ({worst}; "
                 f"limit {TRAIN_GRAD_REL})")
    check(rel <= TRAIN_GRAD_REL, "accumulated update within the limit")
    other = dict(big, draws=sampling_draws(model, big, seed=5))
    acc = one_update(model, init, other, REMAT_ACCUM)
    mean = mean_gradient_update(model, init, other, REMAT_ACCUM)
    worst, rel = worst_rel(acc, mean)
    say("remat", f"grad_accum_steps={REMAT_ACCUM} on {REMAT_ACCUM} distinct "
                 f"micro-batches of {REMAT_B} against one update on the mean "
                 f"of their gradients: largest relative difference of a "
                 f"parameter's update {rel:.3e} ({worst}; limit "
                 f"{TRAIN_GRAD_REL})")
    check(rel <= TRAIN_GRAD_REL,
          "accumulated update on distinct micro-batches within the limit")
    whole = one_update(model, init, other, 1)
    worst, rel = worst_rel(acc, whole)
    say("remat", f"the same against one B={REMAT_B_FULL} step on their "
                 f"images (each micro-batch its own loss normalizers; "
                 f"printed, unchecked): largest relative difference "
                 f"{rel:.3e} ({worst})")
    set_remat(model, None)
    return launches


def cli_rate(run, steps: int) -> None:
    """img/s of the train CLI's own step and data path (the iterator, the
    page-locked upload, the step) over `steps` steps after 2 warm-up, and
    its device idle share in one profile of 2 steps."""
    data = run.make_data_iter()
    state = run.state
    for _ in range(2):
        state, _ = run.step_fn(state, next(data))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        state, metrics = run.step_fn(state, next(data))
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t1) / steps
    check_losses(metrics, "train CLI step")
    say("traincli", f"{steps} steps of the CLI's loop body (next batch, "
                    f"upload, step; synchronised at the end): "
                    f"{per_step * 1e3:.3f} ms a step, "
                    f"{run.batch_size / per_step:.3f} img/s")

    def two():
        nonlocal state
        for _ in range(2):
            state, _ = run.step_fn(state, next(data))

    device_profile("traincli", two, 2, per_step * 1e3, repeat=1)
    run.close()


def differing(a: Path, b: Path) -> list[str]:
    """The model tensors of a/model_final.pt and b/model_final.pt that are
    not bit-identical."""
    ma = torch.load(a / "model_final.pt", weights_only=True)["model"]
    mb = torch.load(b / "model_final.pt", weights_only=True)["model"]
    return [n for n, v in ma.items() if not torch.equal(v, mb[n])]


def traincli_phase() -> dict:
    """python -m ovmono3d_tpu_torch.train.cli in-process with the shipped
    flagship config (trunk frozen) on --synthetic data, resumed, evaluated
    with --eval-only, unfrozen, and under a one-process NCCL group; returns
    the attention launches of its runs."""
    from ovmono3d_tpu_torch.train import cli as train_cli
    from ovmono3d_tpu_torch.train import tb_writer

    root = Path(__file__).resolve().parent
    out = root / "build" / "traincli"
    shutil.rmtree(out, ignore_errors=True)
    # The shipped config names Objectron's 9 categories for its 50-class
    # head; the generated records use all 50, so the evaluations name them
    # by number.
    config = root / "configs" / "OVMono3D_dinov2_SFP.yaml"
    base = ["--config-file", str(config), "--synthetic", "--batch-size",
            str(TRAINCLI_B)]
    names = "datasets.category_names=[]"
    launches = {"fwd": 0, "lse": 0, "bwd": 0}

    def run_cli(argv: list[str], what: str):
        reset_attention_counts()
        t1 = time.perf_counter()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        counts = attention_counts()
        for key, wrapper in (("fwd", "flash_attention_packed"),
                             ("lse", "flash_attention_packed_lse"),
                             ("bwd", "flash_attention_packed_bwd")):
            launches[key] += counts[wrapper]
        say("traincli", f"{what}: {time.perf_counter() - t1:.1f} s; kernel "
                        f"1 / 3 / 4 launches "
                        f"{counts['flash_attention_packed']} / "
                        f"{counts['flash_attention_packed_lse']} / "
                        f"{counts['flash_attention_packed_bwd']}")
        return res, counts

    main_out = out / "frozen"
    opts = [f"output_dir={main_out}", "test.eval_period=16", "vis_period=8",
            "solver.checkpoint_period=8", names]
    res, counts = run_cli([*base, "--max-iter", str(TRAINCLI_ITERS),
                           "--profile", *opts], "16 steps, frozen trunk")
    eval_batches = -(-16 // TRAINCLI_B)          # 16 generated records
    want = 12 * (TRAINCLI_ITERS + eval_batches)
    check(counts["flash_attention_packed"] == want,
          f"12 kernel-1 launches a step and an eval batch ({want})")
    check(counts["flash_attention_packed_lse"] == 0
          and counts["flash_attention_packed_bwd"] == 0,
          "no kernel 3 or 4 with the trunk frozen")
    check(res["step"] == TRAINCLI_ITERS and res["skipped"] == 0,
          f"{TRAINCLI_ITERS} steps, none skipped: {res['step']}, "
          f"{res['skipped']}")
    (ev,) = res["evals"]
    check(all(math.isfinite(ev[k]) for k in ("AP2D", "AP3D")),
          "finite in-train AP2D and AP3D")
    say("traincli", f"in-train eval at step 16: AP2D {ev['AP2D']:.2f}, "
                    f"AP3D {ev['AP3D']:.2f}")
    lines = (main_out / "metrics.jsonl").read_text().splitlines()
    (events,) = list((main_out / "tb").glob("events.out.tfevents.*"))
    scalars = tb_writer.read_events(events)
    images = tb_writer.read_image_events(events)
    check(bool(lines) and bool(scalars), "metrics.jsonl and TB scalars")
    check([s for s, _ in images] == [8, 16], f"TB images at steps 8 and 16: "
                                            f"{[s for s, _ in images]}")
    for s in (8, 16):
        check((main_out / "vis" / f"train_{s:07d}.png").exists(),
              f"vis PNG of step {s}")
    trace = main_out / "profile" / "trace_10-15.json"
    check(trace.exists(), "the profiler trace of steps 11-15")
    say("traincli", f"metrics.jsonl {len(lines)} lines, TB {len(scalars)} "
                    f"scalar and {len(images)} image events, vis PNGs, "
                    f"trace {trace.stat().st_size} bytes")

    res, counts = run_cli([*base, "--max-iter", str(TRAINCLI_RESUMED),
                           "--resume", *opts], "--resume to 20")
    ran = TRAINCLI_RESUMED - TRAINCLI_ITERS
    check(res["step"] == TRAINCLI_RESUMED
          and counts["flash_attention_packed"] == 12 * ran,
          f"the resumed run started at step {TRAINCLI_ITERS} "
          f"({counts['flash_attention_packed']} kernel-1 launches)")
    reset_attention_counts()
    summary = train_cli.main(["--eval-only", *base, "--checkpoint",
                              str(main_out / "model_final.pt"), *opts])
    launches["fwd"] += attention.flash_attention_packed.launches
    overall = summary["overall"]
    check(all(math.isfinite(overall[k]) for k in ("AP2D", "AP3D")),
          "--eval-only: finite AP2D and AP3D")
    say("traincli", f"--eval-only on model_final.pt: AP2D "
                    f"{overall['AP2D']:.2f}, AP3D {overall['AP3D']:.2f}")

    res, counts = run_cli(
        [*base, "--max-iter", "4", f"output_dir={out / 'unfrozen'}",
         "model.backbone.freeze=false", "test.eval_period=0", "vis_period=0",
         names],
        "4 steps, trunk unfrozen")
    check(counts["flash_attention_packed_lse"] == 48
          and counts["flash_attention_packed_bwd"] == 48
          and counts["flash_attention_packed"] == 0,
          "12 kernel-3 and 12 kernel-4 launches a step, no kernel 1")

    # A one-process NCCL group against no group: bit for bit. cuDNN's
    # default weight-gradient algorithms do not repeat from run to run (the
    # pyramid's convolution parameters differed between two runs without a
    # group), so the pair takes its deterministic ones.
    plain = [*base, "--max-iter", "4", "--no-tensorboard",
             "test.eval_period=0", "vis_period=0", names]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.backends.cudnn.deterministic = True
    try:
        run_cli([*plain, f"output_dir={out / 'alone'}"], "4 steps, no group")
        with mock.patch.dict(os.environ, MASTER_ADDR="localhost",
                             MASTER_PORT=str(port), RANK="0",
                             WORLD_SIZE="1", LOCAL_RANK="0"):
            res, _ = run_cli([*plain, f"output_dir={out / 'group'}"],
                             "4 steps in a one-process NCCL group")
            check(res["world_size"] == 1
                  and torch.distributed.get_backend() == "nccl",
                  "the run joined an NCCL group")
    finally:
        torch.backends.cudnn.deterministic = False
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    differ = differing(out / "alone", out / "group")
    say("traincli", f"parameters after 4 steps, NCCL group of one against no "
                    f"group (deterministic cuDNN): {len(differ)} tensors "
                    f"differ {differ[:3]}")
    check(not differ, "the NCCL group's run equals the run without a group")

    run = train_cli.build_run(train_cli.parse_args(
        [*plain, f"output_dir={out / 'rate'}"]))
    reset_attention_counts()
    cli_rate(run, TRAINCLI_RATE_STEPS)
    launches["fwd"] += attention.flash_attention_packed.launches
    return launches


# The release phase: state dicts in the released checkpoints' key layouts at
# full width (utils/release_states.py, from seeds), written where the CLIs
# read them. Moved off the generator's draws, as the other phases move the
# seeded init: the LIFT LayerScales (0.1) and pose bias (the identity's 6D
# vector), as lift_model; GroundingDINO's weights that OVLIFT_SETS names;
# Depth-Pro's LayerScales (0.1) and depth-head bias (GEO_DEPTH_BIAS), as
# geo_weights (SAM's rel-pos tables are drawn at REL_POS_STD already).
RELEASE_DIR = Path(__file__).resolve().parent / "build" / "release_phase"
RELEASE_TIMED = 3


def release_lift_state(cfg) -> dict:
    state = release_states.lift_state(cfg, seed=0)
    for key, arr in state.items():
        if key.endswith(("ls1.gamma", "ls2.gamma")):
            arr[:] = 0.1
    state["roi_heads.cube_head.bbox_3D_pose.bias"][:] = IDENTITY_6D
    return state


def release_gdino_state() -> dict:
    """GroundingDINO SwinB in the original layout; drawn in place, so the
    decoder's shared bbox_embed copies stay one array."""
    state = release_states.gdino_state(seed=1)
    rng = np.random.default_rng(3)

    def draw(arr, std):
        arr[...] = std * rng.standard_normal(arr.shape, dtype=np.float32)

    for key, arr in state.items():
        if key.endswith(("sampling_offsets.weight",
                         "attention_weights.weight")):
            draw(arr, OVLIFT_SETS[
                "sampling_offsets / attention_weights kernels"])
        elif key.endswith("relative_position_bias_table"):
            draw(arr, OVLIFT_SETS["Swin rel_pos_bias tables"])
        elif key.endswith(("gamma_v", "gamma_l")):
            arr[:] = OVLIFT_SETS["fusion gamma_v / gamma_l"]
    for key in ("bbox_embed.0.layers.2.weight",
                "transformer.enc_out_bbox_embed.layers.2.weight",
                "transformer.decoder.ref_point_head.layers.1.weight"):
        draw(state[key], OVLIFT_SETS["box heads' last kernels"])
    return state


def release_depth_state() -> dict:
    state = release_states.depth_pro_state(seed=4)
    for key, arr in state.items():
        if key.endswith(("layer_scale1.lambda1", "layer_scale2.lambda1")):
            arr[:] = 0.1
    state["head.layers.4.bias"][:] = GEO_DEPTH_BIAS
    return state


def state_bytes(state: dict) -> int:
    """Bytes of a state dict, each array once (shared copies once)."""
    return sum({id(v): v.nbytes for v in state.values()}.values())


def loaded_exactly(module, tree: dict, what: str, keep=()) -> int:
    """Every parameter and buffer (the BatchNorms' statistics) of `module`
    equals its array of the converted tree in the torch layout, bit for
    bit; returns the tensors compared."""
    params = {**dict(module.named_parameters()),
              **dict(module.named_buffers())}
    arrays = flax_bridge.torch_arrays(module, tree, keep)
    bad = [name for name, arr in arrays.items() if not torch.equal(
        params[name].detach(), torch.from_numpy(
            np.ascontiguousarray(arr)).to(params[name].device))]
    check(not bad and len(arrays) == len(params) - len(tuple(keep)),
          f"{what}: every parameter equals its converted array "
          f"({len(bad)} differ: {bad[:3]})")
    return len(arrays)


def spied(attn, run) -> tuple:
    """The arguments of `attn.attn_fn`'s first call during run(), cloned."""
    seen, fn = [], attn.attn_fn

    def spy(*args):
        if not seen:
            seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return fn(*args)

    attn.attn_fn = spy
    try:
        run()
    finally:
        attn.attn_fn = fn
    check(bool(seen), "the spied block ran")
    return seen[0]


def release_phase() -> dict:
    """Released-checkpoint loading at full width: LIFT through eval.cli
    --rcnn-ckpt and bench.py's request on the loaded model;
    open-vocabulary through eval.oracle2d --gdino-ckpt --vocab and one
    OVMono3DLift.predict with both files loaded; GEO with SAM ViT-H and f32
    Depth-Pro loaded in memory through the loaders. Every parameter is
    held to its converted array, kernels 1, 8 and 7 to their plain versions
    on the loaded weights. Returns the paths' launches by kernel."""
    t_phase = time.perf_counter()
    card = card_name()
    shutil.rmtree(RELEASE_DIR, ignore_errors=True)
    RELEASE_DIR.mkdir(parents=True)
    totals = {"fwd": 0, "window": 0, "relpos": 0, "fwd_f32": 0}

    def add(counts: dict) -> None:
        totals["fwd"] += counts["flash_attention_packed"]
        totals["window"] += counts["window"]
        totals["relpos"] += counts["relpos"]
        totals["fwd_f32"] += counts["flash_attention_packed_f32"]

    def report(model: str, nbytes: int, make_s: float, convert_s: float,
               load_s: float, how: str) -> None:
        say("release", f"{model}: {nbytes} bytes; made in {make_s:.2f} s; "
                       f"host-side conversion {convert_s:.2f} s; {how} "
                       f"{load_s:.2f} s; card {card}")

    # -- LIFT: the flagship through eval.cli --rcnn-ckpt -------------------
    cfg = Config()
    check(cfg.model == flagship_config(S),
          "eval.cli's default model is the flagship")
    t0 = time.perf_counter()
    state = release_lift_state(cfg.model)
    make_s = time.perf_counter() - t0
    lift_path = RELEASE_DIR / "ovmono3d_lift.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()},
                "iteration": 0}, lift_path)
    t0 = time.perf_counter()
    tree = convert_ovmono3d_lift(state, depth=cfg.model.backbone.depth)
    convert_s = time.perf_counter() - t0
    built = []
    build = eval_cli.build_model
    eval_cli.build_model = lambda *a, **k: built.append(build(*a, **k)) or \
        built[-1]
    cli_s = {}
    try:
        for mode, extra in (("oracle", []), ("learned",
                                             ["test.oracle2d=false"])):
            reset_path_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                summary = eval_cli.main([
                    "--synthetic", "--rcnn-ckpt", str(lift_path),
                    "--batch-size", str(EVAL_BATCH), *extra])
            torch.cuda.synchronize()
            cli_s[mode] = time.perf_counter() - t0
            # Two generated datasets of 16 records: 4 batches, one
            # kernel-1 launch a block each.
            add(check_path_counts(
                f"eval.cli --synthetic --rcnn-ckpt ({mode} 2D)",
                {"flash_attention_packed": len(built[-1].backbone.vit.blocks())
                 * 2 * 16 // EVAL_BATCH},
                "release"))
            for name, res in summary["datasets"].items():
                check(all(math.isfinite(res[k]) for k in ("AP2D", "AP3D")),
                      f"{mode} {name}: finite AP")
                if mode == "oracle":
                    check(res["AP2D"] == 100.0,
                          f"{name}: AP2D 100 on the GT oracle")
            say("release", f"eval.cli --synthetic --rcnn-ckpt, {mode} 2D: "
                           f"{cli_s[mode]:.1f} s (the file read, converted "
                           "and loaded included); " + ", ".join(
                               f"{n} AP2D {r['AP2D']:.3f} AP3D "
                               f"{r['AP3D']:.3f}" for n, r in
                               summary["datasets"].items()))
    finally:
        eval_cli.build_model = build
    model = built[-1].eval()
    del built
    blocks = model.backbone.vit.blocks()
    n = loaded_exactly(model, tree, "LIFT")
    for key, want in extract_priors(state).items():
        check(torch.equal(model.priors[key].cpu(), torch.from_numpy(want)),
              f"the model's priors[{key!r}] are the file's")
    report("OVMono3D-LIFT (flagship)", lift_path.stat().st_size, make_s,
           convert_s, cli_s["oracle"], "eval.cli read + convert + load + "
           "evaluate")
    say("release", f"LIFT: {n} parameters equal their converted arrays bit "
                   "for bit; the priors are the file's")
    del state, tree
    inputs = bench_inputs()
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(1 + RELEASE_TIMED, 1, S, S, 3, device="cuda",
                        generator=g) * 255.0
    with torch.inference_mode():
        serve(model, images[:1], inputs)
        reset_path_counts()
        dets, lats = serve(model, images[1:], inputs)
        add(check_path_counts(
            f"bench.py's request x {RELEASE_TIMED} on the loaded model",
            {"flash_attention_packed": len(blocks) * RELEASE_TIMED},
            "release"))
        for det in dets:
            check_detections(det)
        set_attention(model, attention.attention_ref)
        plain, _ = serve(model, images[1:2], inputs)
        set_attention(model, attention.dot_product_attention)
    for field in ("center_cam", "dimensions", "corners3d"):
        a, b = getattr(dets[0], field), getattr(plain[0], field)
        dev, scale = (a - b).abs().max().item(), b.abs().max().item()
        say("release", f"LIFT kernel vs plain {field}: max |diff| {dev:.3e} "
                       f"(scale {scale:.3e}, limit 2e-2 of it)")
        check(dev <= 2e-2 * scale + 1e-4, f"loaded LIFT {field}: kernel vs "
              "plain within the slice phase's limit")
    for i in (0, len(blocks) - 1):
        with torch.inference_mode():
            (qkv,) = spied(blocks[i].attn, lambda: serve(
                model, images[1:2], inputs))
            q, k, v = qkv.unbind(2)
            check_close(f"release k1 LIFT block {i} {tuple(q.shape)}",
                        attention.flash_attention_packed(q, k, v),
                        attention.attention_ref(q, k, v), absolute=True)
    say("release", f"LIFT serving the loaded flagship: {rate(lats)}")

    # -- open vocabulary: eval.oracle2d --gdino-ckpt --vocab ---------------
    names, tok = category_tokenizer()
    vocab_path = RELEASE_DIR / "vocab.txt"
    by_id = {i: w for w, i in tok.vocab.items()}
    vocab_path.write_text("".join(
        by_id.get(i, f"[unused{i}]") + "\n"
        for i in range(max(by_id) + 1)))
    read = BertTokenizer(vocab_path).vocab
    check(all(read[w] == i for w, i in tok.vocab.items()),
          "vocab.txt gives each word the category tokenizer's id")
    t0 = time.perf_counter()
    state = release_gdino_state()
    make_s = time.perf_counter() - t0
    gd_path = RELEASE_DIR / "groundingdino_swinb_cogcoor.pth"
    # The original release: {'model': ...} with DDP's 'module.' prefixes.
    torch.save({"model": {"module." + k: torch.from_numpy(v)
                          for k, v in state.items()}}, gd_path)
    t0 = time.perf_counter()
    tree = convert_groundingdino(state)
    convert_s = time.perf_counter() - t0
    nbytes = gd_path.stat().st_size
    del state
    captured = {}
    load_gdino = oracle2d.load_gdino_params

    def capture(gdino, path):
        captured["gdino"] = gdino
        load_gdino(gdino, path)

    oracle2d.load_gdino_params = capture
    try:
        reset_path_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            paths = oracle2d.main([
                "--synthetic", "--gdino-ckpt", str(gd_path), "--vocab",
                str(vocab_path), "--output-dir",
                str(RELEASE_DIR / "oracle2d"),
                "datasets.category_names=" + ",".join(names)])
        torch.cuda.synchronize()
        cli_gd_s = time.perf_counter() - t0
    finally:
        oracle2d.load_gdino_params = load_gdino
    gdino = captured["gdino"]
    swin = gdino.backbone.blocks()
    # Two synthetic sets of 4 images, each one chunk of detect_2d_stream.
    add(check_path_counts("eval.oracle2d --synthetic --gdino-ckpt --vocab",
                          {"window": len(swin) * 2}, "release"))
    n_dets = 0
    for name, seed in (("synthetic_a", 7), ("synthetic_b", 11)):
        dets = json.loads(paths[name].read_text())
        recs = merge_oracle2d(synthetic_records(4, len(names), seed=seed),
                              paths[name])
        check(sum(len(r["oracle2d"]) for r in recs) == len(dets),
              f"{name}'s detections round-trip through merge_oracle2d")
        n_dets += len(dets)
    n = loaded_exactly(gdino, tree, "GroundingDINO")
    del tree
    report("GroundingDINO SwinB", nbytes, make_s, convert_s, cli_gd_s,
           "eval.oracle2d read + convert + load + 8 images")
    say("release", f"GroundingDINO: {n} parameters equal their converted "
                   f"arrays bit for bit; {n_dets} detections over 8 "
                   "images; " + printed.getvalue().strip().replace("\n",
                                                                  "; "))
    pipe = OVMono3DLift(cfg, model, gdino, BertTokenizer(vocab_path),
                        gdino_size=S, gdino_min_size=cfg.input.min_size_test,
                        gdino_max_size=cfg.input.max_size_test)
    K = default_focal_K(OV_H, OV_W)
    images = ov_requests(2, seed=5)
    serve_ov(pipe, images[:1], K, names)
    reset_path_counts()
    dets, lats = serve_ov(pipe, images[1:], K, names)
    add(check_path_counts("OVMono3DLift.predict with both files loaded",
                          {"window": len(swin),
                           "flash_attention_packed": len(blocks)},
                          "release"))
    check_ov_detections(dets[0], len(names))
    say("release", f"open-vocabulary request on the loaded models: "
                   f"{rate(lats)}; {int(dets[0].valid.sum())} valid of "
                   f"{len(dets[0].valid)}")
    # The first shifted block (region ids) and the last (the smallest map).
    shifted = next(b for b in swin if b.endswith("_block1"))
    for bname in (shifted, list(swin)[-1]):
        with torch.inference_mode():
            qkv, bias, ids = spied(swin[bname].attn, lambda: pipe.predict(
                images[1], K, names))
            q, k, v = qkv.unbind(2)
            check_close(f"release k8 Swin {bname} {tuple(q.shape)} ids "
                        f"{ids is not None}",
                        attention.window_flash_attention(q, k, v, bias, ids),
                        attention.window_attention_ref(q, k, v, bias, ids))
    compare_ovlift(pipe, images[1], K, names)
    del pipe, gdino, model, captured
    gc.collect()
    torch.cuda.empty_cache()

    # -- GEO: SAM ViT-H and f32 Depth-Pro through the loaders --------------
    models = geo.build_geo_models("vit_h", depth_bf16=False, device="cuda",
                                  seed=0)
    check(models.depth.dtype == torch.float32, "an f32 Depth-Pro")
    sam_blocks = models.sam_encoder.blocks()
    depth_blocks = sum(len(vit.blocks()) for vit in models.depth.trunks())
    for what, make, load, trees in (
            ("SAM ViT-H (encoder and segmenter)",
             lambda: release_states.sam_state(seed=2),
             lambda st: load_sam_params(models.sam_encoder, models.segmenter,
                                        st, depth=len(sam_blocks)),
             lambda st: ((models.sam_encoder,
                          convert_sam_encoder(st, len(sam_blocks))),
                         (models.segmenter, convert_sam_segmenter(st)))),
            ("Depth-Pro (f32)", release_depth_state,
             lambda st: load_depth_params(models.depth, st),
             lambda st: ((models.depth, convert_depth_pro(st)),))):
        t0 = time.perf_counter()
        state = make()
        make_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load(state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs = trees(state)
        convert_s = time.perf_counter() - t0
        n = sum(loaded_exactly(m, t, what) for m, t in pairs)
        report(what, state_bytes(state), make_s, convert_s, load_s,
               "in memory through the loader (convert + copy to the card)")
        say("release", f"{what}: {n} parameters equal their converted "
                       "arrays bit for bit")
        del state, pairs
    requests = geo_requests(2, seed=6)
    serve_geo(models, requests[:1])
    torch.cuda.synchronize()
    reset_path_counts()
    preds, lats = serve_geo(models, requests[1:])
    add(check_path_counts("one GEO request on the loaded models",
                          {"relpos": len(sam_blocks),
                           "flash_attention_packed_f32": depth_blocks},
                          "release"))
    check_geo_preds(preds)
    say("release", f"GEO request on the loaded models: {rate(lats)}; "
                   f"{len(preds[0])} boxes")
    first_global = next(i for i, b in enumerate(sam_blocks) if not b.window)
    for i in (0, first_global):
        with torch.inference_mode():
            qkv, rh, rw, grid = spied(sam_blocks[i].attn, lambda: geo.
                                      predict_image(models, *requests[1]))
            q, k, v = qkv.unbind(2)
            qrh, qrw = attention.rel_pos_factors(q, rh, rw, grid)
            check_close(f"release k7 SAM block {i} {tuple(q.shape)} grid "
                        f"{grid}",
                        attention.rel_pos_flash_attention(q, k, v, qrh, qrw,
                                                          grid),
                        attention.rel_pos_attention_ref(q, k, v, rh, rw,
                                                        grid))
    compare_geo(models, requests[1])
    del models
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(RELEASE_DIR, ignore_errors=True)
    say("release", f"phase done in {time.perf_counter() - t_phase:.1f} s; "
                   f"card {card}")
    return totals


# The trunks phase: the detector trunks besides the flagship's DINOv2, each
# at the shipped foundation configs' 1024^2 square pad and full width.
TRUNKS_VIT = ("clip", "mae", "midas", "sam")
TRUNKS_CNN = ("dla34", "resnet50", "densenet121", "mnasnet1_0",
              "shufflenet_v2")
TRUNK_SIDE, TRUNK_TIMED = 1024, 3
# detectron2's FPN anchor sizes, one a level p2-p6.
CNN_LEVELS = ("p2", "p3", "p4", "p5", "p6")
CNN_ANCHORS = ((32.0,), (64.0,), (128.0,), (256.0,), (512.0,))
TRUNK_DIR = Path(__file__).resolve().parent / "build" / "trunks_phase"
CONFIGS = Path(__file__).resolve().parent / "configs"


def trunk_config(name: str):
    """The shipped config of a foundation ViT trunk
    (configs/OVMono3D_<name>_SFP.yaml); for a CNN, the same Omni3D surface
    (the CLIP config: 1024^2, 50 classes) with the trunk over p2-p6 and
    detectron2's FPN anchors, as the JAX package's tests build it."""
    if name in TRUNKS_VIT:
        return load_config(CONFIGS / f"OVMono3D_{name}_SFP.yaml").model
    m = load_config(CONFIGS / "OVMono3D_clip_SFP.yaml").model
    return dataclasses.replace(
        m, backbone=dataclasses.replace(m.backbone, name=name),
        anchors=dataclasses.replace(m.anchors, sizes=CNN_ANCHORS),
        rpn=dataclasses.replace(m.rpn, in_features=CNN_LEVELS),
        roi_box=dataclasses.replace(m.roi_box, in_features=CNN_LEVELS))


def trunk_release_state(name: str, seed: int) -> dict:
    """The trunk's released layout at full width (utils/release_states.py):
    open_clip ViT-B/16, HF ViTMAE base, MiDaS DPT_Large, segment-anything
    vit_b, the DLA-34 model zoo, torchvision ResNet-50 / DenseNet-121 /
    MNASNet 1.0 / ShuffleNetV2 x1.0."""
    make = {"clip": release_states.clip_visual_state,
            "mae": release_states.mae_state,
            "midas": release_states.midas_state,
            "sam": lambda seed: release_states.sam_state(
                **SAM_ARCHS["vit_b"], seed=seed),
            "dla34": lambda seed: release_states.dla_state(
                **DLA_PRESETS["dla34"], seed=seed),
            "resnet50": release_states.resnet_state,
            "densenet121": release_states.densenet_state,
            "mnasnet1_0": release_states.mnasnet_state,
            "shufflenet_v2": release_states.shufflenet_state}[name]
    return make(seed=seed)


def set_trunk_attention(model, plain: bool) -> None:
    """Every trunk block's attention through its plain version
    (attention_ref, rel_pos_attention_ref) or back through the port's
    dispatchers."""
    for blk in model.backbone.vit.blocks():
        if blk.attn.use_rel_pos:
            blk.attn.attn_fn = (_relpos_plain if plain
                                else attention.rel_pos_attention)
        else:
            blk.attn.attn_fn = ((lambda qkv: attention.attention_ref(
                *qkv.unbind(2))) if plain else attention.dot_product_attention)


def device_busy_ms(run, n: int) -> float:
    """The device's busy time per call of `run` over n calls, from the
    profiler's device events (no table printed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / n
    check(busy > 0, "the profiler saw device time")
    return busy


def trunk_kernel_rows(name: str, model, run) -> dict:
    """Kernel 1 (kernel 7 for SAM) against its plain version on the first
    and the last block's inputs of one request (run), each held to the
    kernel phase's limits; at each shape the kernel's events and device
    time, its plain version's time, the library call's (SDPA, with the
    rel-pos bias built in the call for SAM) and the bound. Returns
    {shape: row}."""
    blocks = model.backbone.vit.blocks()
    rows = {}
    for i in (0, len(blocks) - 1):
        with torch.inference_mode():
            args = spied(blocks[i].attn, run)
            q, k, v = args[0].unbind(2)
            b, n, h, d = q.shape
            if blocks[i].attn.use_rel_pos:
                rh, rw, grid = args[1:]
                qrh, qrw = attention.rel_pos_factors(q, rh, rw, grid)
                kernel, match = (lambda: attention.rel_pos_flash_attention(
                    q, k, v, qrh, qrw, grid)), relpos_probe.KERNEL
                plain = lambda: attention.rel_pos_attention_ref(  # noqa: E731
                    q, k, v, rh, rw, grid)
                library = lambda: relpos_probe.sdpa_with_bias(  # noqa: E731
                    q, k, v, qrh, qrw)
                bound = relpos_probe.bound_ms(b, grid, h, d)
                kind = "k7"
            else:
                kernel, match = (lambda: attention.flash_attention_packed(
                    q, k, v)), fwd_probe.KERNEL
                plain = lambda: attention.attention_ref(q, k, v)  # noqa: E731
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    *sdpa_views(q, k, v))
                bound = bound_ms(b, n, h, d, "fwd")
                kind = "k1"
            shape = (b, n, h, d)
            err = check_close(f"trunks {kind} {name} block {i} {shape}",
                              kernel(), plain(), absolute=True)
            key = f"{kind} {shape}"
            if key in rows:
                rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
                continue
            row = {"kind": kind, "shape": shape, "max_abs_err": err,
                   "ms": time_ms(kernel), "device_ms": device_ms(kernel, match),
                   "plain_ms": time_ms(plain, reps=5),
                   "library_ms": time_ms(library), "bound_ms": bound[0],
                   "bound_by": bound[1]}
        rows[key] = row
        say("trunks", f"{name} {kind} {shape}: kernel {row['ms']:.4f} ms "
                      f"(device {row['device_ms']:.4f}), plain "
                      f"{row['plain_ms']:.4f} ms, library "
                      f"{row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def trunks_phase() -> dict:
    """The CLIP, MAE, MiDaS and SAM ViT + SFP detectors and the DLA-34,
    ResNet-50, DenseNet-121, MNASNet 1.0 and ShuffleNetV2 + FPN detectors at
    full width and 1024^2: each built from its config and seed 0, its
    released-layout trunk loaded through load_cnn_trunk (every parameter and
    buffer equal to its converted array), bench.py's oracle request served
    1 + 3 times (finite detections, the attention launches a request: one
    kernel 1 or kernel 7 a block, none for a CNN), p50 and device ms a
    request, the kernel path against the plain attention on one request
    (the slice phase's limits), and the kernels against their plain
    versions on the first and last blocks' inputs; then 2 train-CLI steps
    of the frozen DLA-34 detector with --trunk-ckpt, after which every
    trunk parameter and BatchNorm buffer still equals the file's. Returns
    the paths' launches by kernel."""
    t_phase = time.perf_counter()
    card = card_name()
    totals = {"fwd": 0, "relpos": 0}
    inputs = bench_inputs(TRUNK_SIDE)
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(1 + TRUNK_TIMED, 1, TRUNK_SIDE, TRUNK_SIDE, 3,
                        device="cuda", generator=g) * 255.0
    kernel_rows = {}
    for i, name in enumerate(TRUNKS_VIT + TRUNKS_CNN):
        t0 = time.perf_counter()
        model = build_model(trunk_config(name), device="cuda", seed=0).eval()
        with torch.no_grad():
            model.cube_head.pose.bias.copy_(torch.tensor(IDENTITY_6D))
        state = trunk_release_state(name, seed=30 + i)
        load_cnn_trunk(model, state, name)
        attr, tree = convert_trunk(state, name)
        n = loaded_exactly(getattr(model.backbone, attr), tree, f"{name} trunk")
        del state, tree
        build_s = time.perf_counter() - t0
        vit = name in TRUNKS_VIT
        n_blocks = len(model.backbone.vit.blocks()) if vit else 0
        per = ({} if not vit else {"relpos": n_blocks} if name == "sam"
               else {"flash_attention_packed": n_blocks})
        with torch.inference_mode():
            serve(model, images[:1], inputs)
            reset_path_counts()
            dets, lats = serve(model, images[1:], inputs)
            counts = check_path_counts(
                f"{name}: bench.py's request x {TRUNK_TIMED}",
                {k: v * TRUNK_TIMED for k, v in per.items()}, "trunks")
            totals["fwd"] += counts["flash_attention_packed"]
            totals["relpos"] += counts["relpos"]
            for det in dets:
                check_detections(det)
            busy = device_busy_ms(lambda: serve(model, images[1:2], inputs),
                                  TRUNK_TIMED)
        p50 = statistics.median(lats) * 1e3
        say("trunks", f"{name}: {n} trunk tensors equal their converted "
                      f"arrays; built and loaded in {build_s:.1f} s; p50 "
                      f"{p50:.3f} ms, device {busy:.3f} ms a request "
                      f"({1 - busy / p50:.1%} idle); launches a request: "
                      + (", ".join(f"{k} {v}" for k, v in per.items())
                         or "none (no attention kernel on a CNN path)")
                      + f"; card {card}")
        if vit:
            with torch.inference_mode():
                set_trunk_attention(model, plain=True)
                plain, _ = serve(model, images[1:2], inputs)
                set_trunk_attention(model, plain=False)
            for field in ("center_cam", "dimensions", "corners3d"):
                a, b = getattr(dets[0], field), getattr(plain[0], field)
                dev, scale = (a - b).abs().max().item(), b.abs().max().item()
                say("trunks", f"{name} kernel vs plain {field}: max |diff| "
                              f"{dev:.3e} (scale {scale:.3e}, limit 2e-2 of "
                              "it)")
                check(dev <= 2e-2 * scale + 1e-4, f"{name} {field}: kernel "
                      "vs plain within the slice phase's limit")
            for key, row in trunk_kernel_rows(
                    name, model, lambda: serve(model, images[1:2],
                                               inputs)).items():
                if key in kernel_rows:      # a shape two trunks share
                    kept = kernel_rows[key]
                    kept["max_abs_err"] = max(kept["max_abs_err"],
                                              row["max_abs_err"])
                    kept["trunks"].append(name)
                else:
                    kernel_rows[key] = {**row, "trunks": [name]}
        del model, dets
        gc.collect()
        torch.cuda.empty_cache()

    # -- 2 train-CLI steps of the frozen DLA-34 detector, --trunk-ckpt ------
    from ovmono3d_tpu_torch.train import cli as train_cli

    shutil.rmtree(TRUNK_DIR, ignore_errors=True)
    TRUNK_DIR.mkdir(parents=True)
    state = trunk_release_state("dla34", seed=40)
    path = TRUNK_DIR / "dla34.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    built = []
    build = train_cli.build_model
    train_cli.build_model = lambda *a, **k: built.append(build(*a, **k)) or \
        built[-1]
    try:
        reset_path_counts()
        t0 = time.perf_counter()
        res = train_cli.main([
            "--config-file", str(CONFIGS / "OVMono3D_clip_SFP.yaml"),
            "--synthetic", "--batch-size", "2", "--max-iter", "2",
            "--trunk-ckpt", str(path), "datasets.category_names=[]",
            "model.backbone.name=dla34",
            "model.rpn.in_features=[p2,p3,p4,p5,p6]",
            "model.roi_box.in_features=[p2,p3,p4,p5,p6]",
            "model.anchors.sizes=[[32],[64],[128],[256],[512]]",
            "test.eval_period=0", f"output_dir={TRUNK_DIR / 'out'}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        train_cli.build_model = build
    check(res["step"] == 2, "the train CLI took its 2 steps")
    check_path_counts("train.cli, DLA-34 frozen, 2 steps", {}, "trunks")
    model = built[-1]
    check(not any(p.requires_grad for p in model.backbone.dla.parameters()),
          "the DLA-34 trunk is frozen")
    n = loaded_exactly(model.backbone.dla, convert_trunk(state, "dla34")[1],
                       "DLA-34 after 2 frozen train-CLI steps")
    n_bufs = len(dict(model.backbone.dla.named_buffers()))
    say("trunks", f"train.cli --trunk-ckpt, DLA-34 frozen: 2 steps in "
                  f"{cli_s:.1f} s (the build and the file's load included); "
                  f"all {n} trunk tensors, {n_bufs} BatchNorm buffers among "
                  "them, equal the file's bit for bit")
    del model, built, state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRUNK_DIR, ignore_errors=True)
    say("trunks", "kernel rows at the trunks' shapes: " + json.dumps(
        list(kernel_rows.values())))
    say("trunks", f"phase done in {time.perf_counter() - t_phase:.1f} s; "
                  f"card {card}")
    return totals


# The samtrain phase: the SAM ViT-B + SFP detector trained with its trunk
# unfrozen. SAMTRAIN_CHECK: (B, grid, H, D) at which kernel 7's lse instance
# and the rel-pos backward are held to their plain versions under the kernel
# phase's limits: SAM ViT-B's global blocks at B=2 (the plain backward's [B,
# H, N, N] f32 tensors bound the batch), its windowed blocks at 8 images (200
# windows of 14 x 14) and SAM-H's global blocks (D = 80). They are timed at
# probes/relpos_bwd.py's shapes; its first, a global block of the B=8 step,
# is the kernels' JSON row.
SAMTRAIN_CHECK = {"sam_b_global_b2": (2, (64, 64), 12, 64),
                  "sam_b_window_b8": (200, (14, 14), 12, 64),
                  "sam_h_global_b1": (1, (64, 64), 16, 80)}
SAMTRAIN_B, SAMTRAIN_GT, SAMTRAIN_WARMUP, SAMTRAIN_TIMED = 8, 16, 2, 3
SAMTRAIN_CLI_STEPS = 2
SAMTRAIN_DIR = Path(__file__).resolve().parent / "build" / "samtrain_phase"


def relpos_train_kernels(previous: str | None) -> dict:
    """Kernel 7's lse instance and the rel-pos backward against their plain
    versions at SAMTRAIN_CHECK (out, lse, dq, dk, dv, dqrh, dqrw) and two
    backward launches bit-identical at each; then probes/relpos_bwd.py's
    rows (each within its limit, and timed beside the plain versions, SDPA
    with the bias as a float mask and the bound; with `previous`, beside the
    backward built from that directory's relpos_flash_bwd.cu, whose device
    time must be above the shipped one's at every shape). Returns the JSON
    rows {"relpos_lse", "relpos_bwd"} at the probe's first shape, with the
    worst errors over the checked shapes."""
    worst = {"lse": 0.0, "bwd": 0.0}
    with torch.no_grad():
        for i, (name, (b, grid, h, d)) in enumerate(SAMTRAIN_CHECK.items()):
            q, k, v, _, _, qrh, qrw = relpos_probe.inputs(b, grid, h, d,
                                                          seed=40 + i)
            do = qkv_views(b, q.shape[1], h, d, seed=140 + i)[0]
            out, lse = attention.rel_pos_flash_attention_lse(q, k, v, qrh,
                                                             qrw, grid)
            grads = attention.rel_pos_flash_attention_bwd(
                q, k, v, out, lse, do, qrh, qrw, grid)
            again = attention.rel_pos_flash_attention_bwd(
                q, k, v, out, lse, do, qrh, qrw, grid)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(grads, again))
            say("samtrain", f"{name} {(b, grid, h, d)}: two backward launches "
                            f"bit-identical: {same}")
            check(same, f"{name}: the backward is deterministic")
            del again
            want_out, want_lse = attention.rel_pos_attention_lse_ref(
                q, k, v, qrh, qrw, grid)
            worst["lse"] = max(worst["lse"], check_close(
                f"k7 lse {name} out", out, want_out, absolute=True),
                check_close(f"k7 lse {name} lse", lse, want_lse))
            del want_out, want_lse
            want = attention.rel_pos_attention_bwd_ref(
                q, k, v, out, lse, do, qrh, qrw, grid)
            got = (*grads[0].unbind(2), grads[1], grads[2])
            for g_name, g_got, g_want in zip(
                    ("dq", "dk", "dv", "dqrh", "dqrw"), got, want):
                worst["bwd"] = max(worst["bwd"], check_close(
                    f"relpos bwd {name} {g_name}", g_got, g_want))
            del grads, got, want
            torch.cuda.empty_cache()
    for line in relpos_bwd_probe.build_report(
            "relpos_flash_bwd.cu", relpos_bwd_probe.BUILD_KERNELS):
        say("samtrain", f"build: {line}")
    previous = earlier_design(previous, "relpos_flash_bwd.cu")
    rows = relpos_bwd_probe.rows(previous=previous)
    for name, r in rows.items():
        for kind in ("lse", "bwd"):
            say("samtrain", relpos_bwd_probe.describe(name, kind, r[kind]))
            check(r[kind]["ok"], f"{name} {kind}: within the probe's limit "
                                 f"of the plain version")
        if previous is not None:
            b = r["bwd"]
            check(b["previous_rel"] <= relpos_bwd_probe.LIMIT
                  and b["device_ms"] < b["previous_device_ms"],
                  f"{name}: the earlier backward within the limit and the "
                  f"shipped one's device time below it ({b['device_ms']:.4f} "
                  f"against {b['previous_device_ms']:.4f} ms)")
    first = rows[next(iter(relpos_bwd_probe.SHAPES))]
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by")
    out = {f"relpos_{kind}": {**{key: first[kind][key] for key in keys},
                              "max_abs_err": worst[kind]}
           for kind in ("lse", "bwd")}
    out["relpos_bwd"]["previous_device_ms"] = first["bwd"].get(
        "previous_device_ms")
    return out


def optim_kernel_rows() -> dict:
    """probes/optim.py at SAM ViT-B's trainable leaves and the DINOv2
    detector's: the multi-tensor update and flag held to the per-leaf ones
    (bit for bit, the probe raises otherwise), one launch a call, and each
    kernel's device time below the per-leaf device time it replaces.
    Returns the JSON rows {"sgd", "finite"} at SAM's leaves, with DINOv2's
    device ms beside them."""
    rows = {}
    for name in optim_probe.SETS:
        lines, r = optim_probe.measure(name, repeats=2)
        for line in lines:
            say("samtrain", f"optim {line.strip()}")
        for kind in ("sgd", "finite"):
            check(r[kind]["launches_a_call"] == 1
                  and r[kind]["device_ms"] < r[kind]["plain_device_ms"],
                  f"optim {name} {kind}: one launch a call "
                  f"({r[kind]['launches_a_call']}) and device time "
                  f"{r[kind]['device_ms']:.4f} ms below the per-leaf "
                  f"{r[kind]['plain_device_ms']:.4f} ms")
        rows[name] = r
        torch.cuda.empty_cache()
    out = rows["sam"]
    for kind in ("sgd", "finite"):
        out[kind]["dinov2_device_ms"] = rows["dinov2"][kind]["device_ms"]
        out[kind]["dinov2_bound_ms"] = rows["dinov2"][kind]["bound_ms"]
    return out


def optim_counts() -> dict:
    return {"sgd": optim_kernels.sgd_update.launches,
            "finite": optim_kernels.all_finite.launches}


def reset_optim_counts() -> None:
    optim_kernels.sgd_update.launches = 0
    optim_kernels.all_finite.launches = 0


def samtrain_model():
    """The shipped SAM ViT-B + SFP config with the trunk unfrozen, its model
    from seed 0 with the rel-pos tables ~N(0, REL_POS_STD^2) (zero at
    init, where the kernels' bias path and the tables' gradient would go
    unseen, as geo_weights says)."""
    cfg = load_config(CONFIGS / "OVMono3D_sam_SFP.yaml",
                      overrides=["model.backbone.freeze=false"])
    model = build_model(cfg.model, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for blk in model.backbone.vit.blocks():
            blk.attn.rel_pos_h.normal_(0.0, REL_POS_STD, generator=g)
            blk.attn.rel_pos_w.normal_(0.0, REL_POS_STD, generator=g)
    return cfg, model


def samtrain_phase(previous: str | None) -> tuple[dict, dict]:
    """The SAM ViT-B + SFP detector (configs/OVMono3D_sam_SFP.yaml) trained
    with its trunk unfrozen at 1024^2: the training kernels against their
    plain versions and timed, the backward beside `previous`'s design where
    one is given (relpos_train_kernels); SAMTRAIN_WARMUP +
    SAMTRAIN_TIMED SGD steps at B=SAMTRAIN_B with SAMTRAIN_GT GT
    slots (finite losses, none skipped, every trunk parameter moved, the
    rel-pos tables among them; 12 lse-instance and 12 backward launches a
    step and no other attention kernel), p50 ms, device ms and idle share
    of a step and peak memory beside the card's name and power limit; one
    B=1 loss and trunk gradient against the plain rel-pos attention
    (compare_train_step's limits); then SAMTRAIN_CLI_STEPS steps of the
    train CLI on the shipped SAM config, unfrozen, --synthetic. Returns
    the main path's launches and the kernels' JSON rows."""
    t_phase = time.perf_counter()
    card = card_name()
    rows = relpos_train_kernels(previous)
    cfg, model = samtrain_model()
    vit = model.backbone.vit
    n_blocks = len(vit.blocks())
    check(all(blk.attn.use_rel_pos for blk in vit.blocks()),
          "every SAM block is a rel-pos block")
    opt = Optimizer(SolverConfig(), model)
    check(opt.kernel is not None and len(opt.kernel.runs) == 1,
          "the SAM step's optimizer takes the multi-tensor update in one "
          "launch")
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, cfg.model.stabilize)
    batch = synthetic_batch(SAMTRAIN_B, SAMTRAIN_GT, seed=11,
                            size=TRUNK_SIDE)
    trunk0 = {n: p.detach().clone() for n, p in vit.named_parameters()}
    for _ in range(SAMTRAIN_WARMUP):
        state, metrics = step(state, batch)
        check_losses(metrics, "samtrain warm-up step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_path_counts()
    reset_optim_counts()
    lats = []
    for _ in range(SAMTRAIN_TIMED):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t1)
        check_losses(metrics, "samtrain timed step")
    peak = torch.cuda.max_memory_allocated()
    per_step = {"relpos_lse": n_blocks, "relpos_bwd": n_blocks}
    counts = check_path_counts(
        f"{SAMTRAIN_TIMED} SAM-B train steps",
        {k: v * SAMTRAIN_TIMED for k, v in per_step.items()},
        "samtrain")
    launches = {k: counts[k] for k in per_step}
    optim = optim_counts()
    check(optim == {"sgd": SAMTRAIN_TIMED, "finite": SAMTRAIN_TIMED},
          f"{SAMTRAIN_TIMED} SAM-B train steps: one multi-tensor update and "
          f"one flag launch a step, got {optim}")
    launches.update(optim)
    check(int(state.skipped) == 0, f"{int(state.skipped)} steps skipped")
    moved = [n for n, p in vit.named_parameters()
             if not torch.equal(p.detach(), trunk0[n])]
    tables = [n for n in trunk0 if n.endswith(("rel_pos_h", "rel_pos_w"))]
    check(len(moved) == len(trunk0) and set(tables) <= set(moved),
          f"{len(trunk0) - len(moved)} trunk parameters did not move")
    p50 = statistics.median(lats) * 1e3
    say("samtrain", f"SAM ViT-B + SFP unfrozen, 1024^2, B={SAMTRAIN_B}, "
                    f"{SAMTRAIN_GT} GT slots, SGD: {SAMTRAIN_TIMED} "
                    f"timed steps p50 {p50:.3f} ms "
                    f"({SAMTRAIN_B * 1e3 / p50:.3f} img/s); peak memory "
                    f"{peak} bytes; per step "
                    f"{launches['relpos_lse'] // SAMTRAIN_TIMED} "
                    f"lse-instance and "
                    f"{launches['relpos_bwd'] // SAMTRAIN_TIMED} "
                    f"backward launches, {optim['sgd'] // SAMTRAIN_TIMED} "
                    f"update and {optim['finite'] // SAMTRAIN_TIMED} flag "
                    f"launches; all {len(moved)} trunk tensors "
                    f"moved ({len(tables)} rel-pos tables); total loss "
                    f"{float(metrics['total_loss']):.4f}; card {card}")
    busy = device_profile("samtrain", lambda: step(state, batch), 2, p50)
    say("samtrain", f"a step: p50 {p50:.3f} ms, device {busy:.3f} ms, idle "
                    f"{max(0.0, 1 - busy / p50):.1%}, peak {peak} bytes; "
                    f"card {card}")
    del state
    compare_train_step(
        model, batch, phase="samtrain", set_attn=set_sam_attention,
        attn={"kernel": attention.rel_pos_attention, "plain": _relpos_plain,
              "plain_f32": _relpos_f32},
        bwd_launches=lambda: attention.rel_pos_flash_attention_bwd.launches)
    del model, opt, step, batch, trunk0
    gc.collect()
    torch.cuda.empty_cache()

    # -- the train CLI on the shipped SAM config, trunk unfrozen ----------
    from ovmono3d_tpu_torch.train import cli as train_cli

    shutil.rmtree(SAMTRAIN_DIR, ignore_errors=True)
    reset_path_counts()
    reset_optim_counts()
    t0 = time.perf_counter()
    res = train_cli.main([
        "--config-file", str(CONFIGS / "OVMono3D_sam_SFP.yaml"),
        "--synthetic", "--batch-size", str(TRAINCLI_B), "--max-iter",
        str(SAMTRAIN_CLI_STEPS), "model.backbone.freeze=false",
        "datasets.category_names=[]", "test.eval_period=0",
        f"output_dir={SAMTRAIN_DIR}"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    check(res["step"] == SAMTRAIN_CLI_STEPS and res["skipped"] == 0,
          f"the train CLI took its {SAMTRAIN_CLI_STEPS} steps, none "
          f"skipped: {res['step']}, {res['skipped']}")
    counts = check_path_counts(
        f"train.cli, SAM-B unfrozen, {SAMTRAIN_CLI_STEPS} steps",
        {k: v * SAMTRAIN_CLI_STEPS for k, v in per_step.items()}, "samtrain")
    optim = optim_counts()
    check(optim == {"sgd": SAMTRAIN_CLI_STEPS, "finite": SAMTRAIN_CLI_STEPS},
          f"train.cli, SAM-B unfrozen: one multi-tensor update and one flag "
          f"launch a step, got {optim}")
    counts.update(optim)
    for k in launches:
        launches[k] += counts[k]
    say("samtrain", f"train.cli --config-file OVMono3D_sam_SFP.yaml "
                    f"model.backbone.freeze=false: {SAMTRAIN_CLI_STEPS} steps "
                    f"at B={TRAINCLI_B} in {cli_s:.1f} s (the build "
                    "included)")
    shutil.rmtree(SAMTRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(optim_kernel_rows())
    say("samtrain", f"phase done in {time.perf_counter() - t_phase:.1f} s; "
                    f"card {card}")
    return launches, rows


# The demo phase: DEMO_IMAGES seeded OV_H x OV_W PNGs through
# `python -m ovmono3d_tpu_torch.demo` in-process at the shipped flagship
# config, with DEMO_LABELS as the prompt.
DEMO_DIR = Path(__file__).resolve().parent / "build" / "demo_phase"
DEMO_IMAGES, DEMO_LABELS = 3, "chair,table,lamp"
# The tp phase: kernels 1, 3 and 4 at the trunk's shard shape under a model
# group of two (6 of its 12 heads a rank, views of a half-width qkv), and
# TP_STEPS train steps at B = TP_B under a one-process NCCL group of data x
# model = 1 x 1 against the same steps without a group.
TP_SHAPE = (1, 4097, 6, 64)
TP_B, TP_STEPS = 2, 2
SHARD_KEYS = ("shard_ms", "shard_plain_ms", "shard_library_ms")
# The optimizer kernels' extra JSON keys (probes/optim.py's rows).
OPTIM_KEYS = ("device_ms", "burst_ms", "plain_device_ms", "library_device_ms",
              "library_burst_ms", "library_differ", "dinov2_device_ms",
              "dinov2_bound_ms")
# The native phase: NATIVE_B images of NATIVE_HW a batch, NATIVE_REPS
# batches timed per route.
NATIVE_B, NATIVE_HW, NATIVE_REPS = 8, (480, 640), 3
NATIVE_ATOL = 2e-2      # tests/test_torch_native.py's


def demo_phase() -> dict:
    """The open-vocabulary demo at full width through its entry point, the
    weights moved off the init as the ovlift phase moves them; the panels'
    shapes, kernels 1 and 8 counted (12 and 24 an image), one image's Swin
    features and lifted cuboids against the plain attention within the
    ovlift phase's limits, the timing; then eval.cli --synthetic with
    --vis-dir --vis-period 1 and its panels. Returns the launches of both
    paths."""
    from ovmono3d_tpu_torch import demo
    from ovmono3d_tpu_torch.data.build import read_png

    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    folder = DEMO_DIR / "images"
    folder.mkdir(parents=True)
    for i, image in enumerate(ov_requests(DEMO_IMAGES, seed=21)):
        write_png(folder / f"img{i}.png", image)
    built = []
    build = demo.build_pipeline

    def seeded(*args, **kw):
        pipe = build(*args, **kw)
        ovlift_weights(pipe)
        built.append(pipe)
        return pipe

    argv = ["--input-folder", str(folder), "--labels", DEMO_LABELS,
            "--config-file", str(CONFIGS / "OVMono3D_dinov2_SFP.yaml"),
            "--output-dir", str(DEMO_DIR / "panels")]
    torch.cuda.synchronize()
    reset_path_counts()
    t0 = time.perf_counter()
    demo.build_pipeline = seeded
    try:
        served = demo.main(argv)
    finally:
        demo.build_pipeline = build
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = check_path_counts(
        "python -m ovmono3d_tpu_torch.demo",
        {"window": 24 * DEMO_IMAGES,
         "flash_attention_packed": 12 * DEMO_IMAGES}, phase="demo")
    launches = {"window": counts["window"],
                "fwd": counts["flash_attention_packed"]}
    check(len(served) == DEMO_IMAGES, f"{len(served)} images served")
    for s in served:
        panel = read_png(s["panel"])
        check(panel.shape == (OV_H, OV_W + OV_H, 3),
              f"{Path(s['panel']).name}: panel {panel.shape}")
        check(bool((panel != 0).any()), "the panel is drawn")
    pipe, names = built[0], DEMO_LABELS.split(",")
    image = read_png(folder / "img0.png")
    K = default_focal_K(OV_H, OV_W)
    p50 = statistics.median(s["predict_ms"] for s in served)
    with torch.inference_mode():
        busy = device_profile("demo", lambda: pipe.predict(image, K, names),
                              DEMO_IMAGES, p50, per="image")
    say("demo", f"{DEMO_IMAGES} images of {OV_W}x{OV_H} with {names} "
                f"(the shipped flagship config, weights from its seed moved "
                f"off the init as in the ovlift phase), {wall:.1f} s with "
                f"the build: "
                f"predict ms per image (host clock, to the copy back) "
                + ", ".join(f"{s['predict_ms']:.3f}" for s in served)
                + f" (p50 {p50:.3f}); device busy {busy:.3f} ms per image; "
                  f"drawing ms per image on the host "
                + ", ".join(f"{s['draw_ms']:.3f}" for s in served)
                + "; detections at 0.2: "
                + ", ".join(str(s["detections"]) for s in served))
    # Seeded weights score few slots past the CLI's threshold: one panel
    # with every valid slot drawn times the drawing at its heaviest.
    panel, det, ms = demo.demo_image(pipe, image, names, K, threshold=0.0)
    check(panel.shape == (OV_H, OV_W + OV_H, 3), "the full panel's shape")
    say("demo", f"every valid slot drawn ({int(det['valid'].sum())}): "
                f"{ms['draw_ms']:.3f} ms on the host; scores of the valid "
                f"slots: max {det['scores'][det['valid']].max():.4f}, median "
                f"{np.median(det['scores'][det['valid']]):.4f}")
    compare_ovlift(pipe, image, K, names)
    compare_demo_lift(pipe, image, K, names)
    launches["fwd"] += demo_vis_dir()
    return launches


def compare_demo_lift(pipe, image, K, names) -> None:
    """The cube model on one set of 2D detections with kernel 1 and with
    attention_ref in every trunk block: the valid slots' corners and
    scores within the ovlift phase's limits (a guard of the model, as
    there)."""
    det2d = pipe.detect_2d(image, names)
    runs = {}
    for label, fn in (("kernel", attention.dot_product_attention),
                      ("plain", attention.attention_ref)):
        set_attention(pipe.rcnn, fn)
        runs[label] = pipe.lift_3d(image, K, det2d)
    set_attention(pipe.rcnn, attention.dot_product_attention)
    valid = runs["plain"].valid
    check(torch.equal(runs["kernel"].valid, valid) and bool(valid.any()),
          "the same valid slots")
    for field in ("corners3d", "scores"):
        got = getattr(runs["kernel"], field)[valid].float()
        want = getattr(runs["plain"], field)[valid].float()
        d = (got - want).abs()
        mx = d.max().item() / want.abs().max().item()
        mean = d.mean().item() / want.abs().mean().item()
        say("demo", f"lift on {int(valid.sum())} boxes, kernel 1 vs plain "
                    f"{field}: max |diff| / max |ref| {mx:.3e} (limit "
                    f"{OVLIFT_MAX_REL}), mean |diff| / mean |ref| {mean:.3e} "
                    f"(limit {OVLIFT_MEAN_REL})")
        check(mx <= OVLIFT_MAX_REL and mean <= OVLIFT_MEAN_REL,
              f"demo lift {field}: kernel 1 within the limits")


def demo_vis_dir() -> int:
    """eval.cli --synthetic --vis-dir --vis-period 1 (the flagship at its
    defaults, weights from the seed): a pred-vs-GT panel for every image,
    each [2H, 3W, 3] with the GT columns drawn; returns its kernel-1
    launches (12 a batch)."""
    from ovmono3d_tpu_torch.data.build import read_png

    vis = DEMO_DIR / "vis"
    reset_path_counts()
    t0 = time.perf_counter()
    eval_cli.main(["--synthetic", "--batch-size", "8", "--vis-dir", str(vis),
                   "--vis-period", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    data, _ = synthetic_datasets(50, [str(i) for i in range(50)])
    n_images = sum(len(r) for r in data.values())
    n_batches = sum(-(-len(r) // 8) for r in data.values())
    counts = check_path_counts(
        "eval.cli --synthetic --vis-dir --vis-period 1",
        {"flash_attention_packed": 12 * n_batches}, phase="demo")
    files = sorted(vis.glob("*.png"))
    check(len(files) == n_images, f"{len(files)} panels for {n_images} "
                                  "images")
    for name, recs in data.items():
        for i, rec in enumerate(recs):
            panel = read_png(vis / f"{name}_p0_{i:06d}.png")
            h, w = rec["height"], rec["width"]
            check(panel.shape == (2 * h, 3 * w, 3),
                  f"{name} {i}: panel {panel.shape}")
            check(bool((panel[:h, :w] != 255).any()), "the GT is drawn")
    say("demo", f"eval.cli --vis-dir: {len(files)} panels of "
                f"{n_images} images in {wall:.1f} s (model, evaluation, "
                "drawing and PNG encoding)")
    return counts["flash_attention_packed"]


def tp_steps(cfg, model, batch, groups) -> dict:
    """TP_STEPS train steps (sampling seed 1); the parameters after them."""
    opt = Optimizer(SolverConfig(), model)
    state = create_train_state(model, opt, seed=1)
    step = make_train_step(model, opt, cfg.stabilize, groups)
    for _ in range(TP_STEPS):
        state, metrics = step(state, batch)
        check_losses(metrics, "tp step")
    check(int(state.skipped) == 0, "no step skipped")
    torch.cuda.synchronize()
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def tp_phase(k: dict) -> dict:
    """Kernels 1, 3 and 4 at TP_SHAPE against their plain versions, and
    their times beside the 12-head ones (added to `k`'s rows); then the
    flagship's train step (trunk unfrozen) in a one-process NCCL group as
    data x model = 1 x 1 against no group, bit for bit (cuDNN's
    deterministic algorithms in both, and a repeat of the run without a
    group as the control). Returns the kernel-3 and kernel-4 launches of
    the grouped run."""
    b, n, h, d = TP_SHAPE
    q, kk, v = qkv_views(b, n, h, d, seed=31)
    do = qkv_views(b, n, h, d, seed=32)[0]
    check(q.stride(1) == 3 * h * d,
          f"views of a half-width qkv (row stride {q.stride(1)})")
    with torch.no_grad():
        err = {"fwd": check_close(
            f"k1 shard {TP_SHAPE} out", attention.flash_attention_packed(
                q, kk, v), attention.attention_ref(q, kk, v), absolute=True)}
        o, lse = attention.flash_attention_packed_lse(q, kk, v)
        want_o, want_lse = attention.attention_lse_ref(q, kk, v)
        err["lse"] = max(check_close("k3 shard out", o, want_o),
                         check_close("k3 shard lse", lse, want_lse))
        grad = attention.flash_attention_packed_bwd(q, kk, v, o, lse, do)
        want = attention.attention_bwd_ref(q, kk, v, o, lse, do)
        err["bwd"] = max(check_close(f"k4 shard {g}", x, w) for x, w, g in
                         zip(grad.unbind(2), want, ("dq", "dk", "dv")))
        del grad, want
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            *sdpa_views(q, kk, v))
        calls = {
            "fwd": (lambda: attention.flash_attention_packed(q, kk, v),
                    lambda: attention.attention_ref(q, kk, v), sdpa_fwd),
            "lse": (lambda: attention.flash_attention_packed_lse(q, kk, v),
                    lambda: attention.attention_lse_ref(q, kk, v), sdpa_fwd),
            "bwd": (lambda: attention.flash_attention_packed_bwd(
                        q, kk, v, o, lse, do),
                    lambda: attention.attention_bwd_ref(
                        q, kk, v, o, lse, do), None)}
        for kind, (fn, plain, library) in calls.items():
            ms, plain_ms = time_ms(fn), time_ms(plain, reps=5)
            # SDPA's forward (kernels 1 and 3) or its backward alone
            # (kernel 4), on the same views: a yardstick the port never
            # calls.
            library_ms = (sdpa_bwd_ms(q, kk, v, do) if library is None
                          else time_ms(library))
            bound = bound_ms(b, n, h, d, kind)
            k[kind]["max_abs_err"] = max(k[kind]["max_abs_err"], err[kind])
            k[kind]["shard_ms"], k[kind]["shard_plain_ms"] = ms, plain_ms
            k[kind]["shard_library_ms"] = library_ms
            say("tp", f"{kind} at {TP_SHAPE}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, SDPA "
                      f"{'backward ' if library is None else ''}"
                      f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]}); at {KERNEL_SHAPES['trunk']} the "
                      f"kernel {k[kind]['ms']:.4f} ms")

    batch = synthetic_batch(TP_B, TRAIN_GT, seed=9)
    torch.backends.cudnn.deterministic = True
    try:
        alone = [tp_steps(*train_model(), batch, None) for _ in range(2)]
        control = [n for n in alone[0]
                   if not torch.equal(alone[0][n], alone[1][n])]
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        mesh.init_multihost(f"localhost:{port}", 1, 0, device="cuda")
        groups = mesh.make_groups(1, 1)
        cfg, model = train_model()
        check(not apply_tp(model, groups.model),
              "a model group of one shards nothing")
        reset_attention_counts()
        grouped = tp_steps(cfg, model, batch, groups)
        launches = {"lse": attention.flash_attention_packed_lse.launches,
                    "bwd": attention.flash_attention_packed_bwd.launches}
        check(torch.distributed.get_backend() == "nccl", "an NCCL group")
    finally:
        torch.backends.cudnn.deterministic = False
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    n_blocks = len(model.backbone.vit.blocks())
    check(launches["lse"] == launches["bwd"] == n_blocks * TP_STEPS,
          f"kernel 3/4 launches {launches} for {TP_STEPS} steps")
    differ = [n for n in alone[0] if not torch.equal(alone[0][n], grouped[n])]
    say("tp", f"{TP_STEPS} train steps of the unfrozen flagship at B={TP_B}: "
              f"two runs without a group differ in {len(control)} tensors "
              f"{control[:3]}; data x model = 1 x 1 in a one-process NCCL "
              f"group against no group: {len(differ)} of {len(grouped)} "
              f"tensors differ {differ[:3]}. A run across cards waits for a "
              f"machine with more than one (this one has "
              f"{torch.cuda.device_count()})")
    check(not control, "two runs without a group are equal (the control)")
    check(not differ, "data x model = 1 x 1 equals no group, bit for bit")
    tp_dryrun()
    return launches


def tp_dryrun() -> None:
    """python -m ovmono3d_tpu_torch.parallel.dryrun --device cuda --data 1
    --model 1 on the shipped flagship file with the trunk unfrozen: its
    process spawned on this card, NCCL, one train step."""
    from ovmono3d_tpu_torch.parallel import dryrun

    config = Path(__file__).resolve().parent / "configs" / \
        "OVMono3D_dinov2_SFP.yaml"
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        m = dryrun.main(["--device", "cuda", "--data", "1", "--model", "1",
                         "--config-file", str(config),
                         "model.backbone.freeze=false"])
    say("tp", f"dryrun in {time.perf_counter() - t0:.1f} s (the process's "
              f"start and kernel builds included): {out.getvalue().strip()}")
    check(math.isfinite(m["total_loss"]) and m["skipped"] == 0,
          "the dry run's step on the card: a finite loss, no skip")


def native_phase() -> None:
    """The g++ build of the native batch resize, the OpenMP runtime in the
    process, and NATIVE_B-image batches through build_test_iterator on the
    native route and on the per-image torch resize: equal geometry, pixels
    within NATIVE_ATOL, the ms per batch of each."""
    from ovmono3d_tpu_torch.data import native

    t0 = time.perf_counter()
    lib = native.build()
    native.load()
    # The runtimes of SONAME libgomp.so.1 (other packages may load their
    # own renamed copies, libgomp-<hash>.so.1, for themselves).
    maps = Path("/proc/self/maps").read_text()
    gomp = sorted({line.split()[-1] for line in maps.splitlines()
                   if Path(line.split()[-1]).name.startswith("libgomp.so.1")})
    say("native", f"{lib.name} ({' '.join(native.CXX_FLAGS)} -c, linked "
                  f"to {native.libgomp()}) ready in "
                  f"{time.perf_counter() - t0:.2f} s; OpenMP runtime in the "
                  f"process: {gomp}; {os.cpu_count()} cores, "
                  f"native_worthwhile {native.native_worthwhile()}")
    check(len(gomp) == 1, "one OpenMP runtime")
    check(native.native_worthwhile(), "the native route is taken here")
    cfg = Config(model=flagship_config(S))
    h, w = NATIVE_HW
    images = ov_requests(NATIVE_B, seed=41)
    records = [{"file_name": f"{i}.png", "height": h, "width": w,
                "image_id": i, "K": default_focal_K(h, w).tolist()}
               for i in range(NATIVE_B)]

    def batch(use_native: bool) -> dict:
        it = build_test_iterator(cfg, records, NATIVE_B,
                                 lambda r: images[r["image_id"]],
                                 use_native=use_native)
        return next(it)[1]

    fast, slow = batch(True), batch(False)
    for key in fast:
        if key == "image":
            err = float(np.abs(fast[key] - slow[key]).max())
            check(err <= NATIVE_ATOL, f"native pixels within {NATIVE_ATOL} "
                                      f"of the torch resize ({err:.3e})")
        elif key != "im_scale_ratio":
            check(np.array_equal(fast[key], slow[key]), f"{key} equal")
    ms = {}
    for label, use in (("native", True), ("torch", False), ("native", True),
                       ("torch", False)):
        t = []
        for _ in range(NATIVE_REPS):
            t1 = time.perf_counter()
            batch(use)
            t.append((time.perf_counter() - t1) * 1e3)
        ms.setdefault(label, []).extend(t)
    say("native", f"build_test_iterator, {NATIVE_B} images of {w}x{h} to "
                  f"the {S}^2 canvas, ms per batch (median of "
                  f"{2 * NATIVE_REPS}, in turns): native "
                  f"{statistics.median(ms['native']):.2f}, torch per image "
                  f"{statistics.median(ms['torch']):.2f}; pixels within "
                  f"{err:.3e} of each other")


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--previous", metavar="DIR",
        help="a directory holding the earlier relpos_flash_fwd.cu, "
             "window_attn_fwd.cu, int8_gemm.cu and relpos_flash_bwd.cu (and "
             "their headers), for instance the parent commit's "
             "ovmono3d_tpu_torch/csrc unpacked outside the tree: kernels 7, "
             "8 and 10 and the rel-pos backward are timed beside them (each "
             "whose copy there differs from the shipped source)")
    args = parser.parse_args()
    t_start = time.perf_counter()
    card = device_phase()
    build_phase()
    k = kernel_phase()
    k["relpos"] = relpos_kernel_phase(args.previous)
    k["window"] = window_kernel_phase(args.previous)
    k["int8"] = int8_kernel_phase(args.previous)
    k["quant"] = k["int8"].pop("quantize")
    k.update(f32_kernel_phase())
    k.update(ln_kernel_phase())
    ln = ln_paths()
    sweep = sweep_kernel_phase()
    model, images, inputs, launches, p50_ms = slice_phase()
    profile_phase(model, images[WARMUP:WARMUP + 5], inputs, p50_ms)
    sensitivity_phase(model, images[WARMUP], inputs)
    del model, images, inputs
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    geo_launches = geo_phase()
    gc.collect()
    torch.cuda.empty_cache()
    f32_launches = geo_f32_phase()
    gc.collect()
    torch.cuda.empty_cache()
    ov_launches, pipe, names = ovlift_phase(args.previous)
    st_launches = stream_phase(pipe, names)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    q_launches = quant_phase()
    gc.collect()
    torch.cuda.empty_cache()
    eval_launches = eval_phase()
    gc.collect()
    torch.cuda.empty_cache()
    remat_launches = remat_phase()
    gc.collect()
    torch.cuda.empty_cache()
    cli_launches = traincli_phase()
    gc.collect()
    torch.cuda.empty_cache()
    rel_launches = release_phase()
    gc.collect()
    torch.cuda.empty_cache()
    trunk_launches = trunks_phase()
    gc.collect()
    torch.cuda.empty_cache()
    sam_launches, sam_rows = samtrain_phase(args.previous)
    k.update(sam_rows)
    gc.collect()
    torch.cuda.empty_cache()
    demo_launches = demo_phase()
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = tp_phase(k)
    gc.collect()
    torch.cuda.empty_cache()
    native_phase()
    launches = {"fwd": launches + geo_launches["fwd"] + ov_launches["fwd"]
                + q_launches["fwd"] + eval_launches + st_launches["fwd"]
                + remat_launches["fwd"] + cli_launches["fwd"]
                + rel_launches["fwd"] + trunk_launches["fwd"]
                + demo_launches["fwd"],
                "lse": train_launches["lse"] + remat_launches["lse"]
                + cli_launches["lse"] + tp_launches["lse"],
                "bwd": train_launches["bwd"] + remat_launches["bwd"]
                + cli_launches["bwd"] + tp_launches["bwd"],
                "relpos": geo_launches["relpos"] + q_launches["relpos"]
                + f32_launches["relpos"] + st_launches["relpos"]
                + rel_launches["relpos"] + trunk_launches["relpos"],
                "window": ov_launches["window"] + st_launches["window"]
                + rel_launches["window"] + demo_launches["window"],
                **sam_launches,
                "int8": q_launches["int8"], "quant": q_launches["quant"],
                "fwd_f32": f32_launches["fwd_f32"] + st_launches["fwd_f32"]
                + rel_launches["fwd_f32"],
                "k9": ln["k9_launches"]}
    src = "ovmono3d_tpu_torch/csrc/"
    meta = {
        "fwd": ("flash_attn_fwd_bf16", src + "flash_attn_fwd.cu",
                "ovmono3d_tpu/ops/attention.py:238"),
        "lse": ("flash_attn_fwd_bf16+lse", src + "flash_attn_fwd.cu",
                "ovmono3d_tpu/ops/attention.py:559"),
        "bwd": ("flash_attn_bwd_bf16", src + "flash_attn_bwd.cu",
                "ovmono3d_tpu/ops/attention.py:691"),
        "relpos": ("relpos_flash_fwd_bf16", src + "relpos_flash_fwd.cu",
                   "ovmono3d_tpu/ops/attention.py:277"),
        "relpos_lse": ("relpos_flash_fwd_lse_bf16 (kernel 7's lse "
                       "instance, training)", src + "relpos_flash_fwd.cu",
                       "ovmono3d_tpu/ops/attention.py:277"),
        "relpos_bwd": ("relpos_flash_bwd_bf16 (the port's own: the JAX "
                       "package differentiates its XLA path in _rpa_bwd)",
                       src + "relpos_flash_bwd.cu",
                       "ovmono3d_tpu/models/vit.py:205"),
        "window": ("window_attn_fwd_bf16 (window_fwd_sm90_kernel<masked> "
                   "for N <= 144; the mma.sync window_fwd_kernel past 144)",
                   src + "window_attn_fwd.cu",
                   "ovmono3d_tpu/ops/attention.py:1474"),
        "int8": ("int8_gemm_s8", src + "int8_gemm.cu",
                 "tools/probe_int8_pallas.py:38"),
        "quant": ("int8_quantize_rows (kernel 10's activation)",
                  src + "int8_gemm.cu", "ovmono3d_tpu/ops/quant.py:55"),
        "fwd_f32": ("flash_attn_fwd_f32", src + "flash_attn_fwd.cu",
                    "ovmono3d_tpu/ops/attention.py:238"),
    }
    meta["sgd"] = ("sgd_kernel (multi_tensor_sgd, Optimizer.step on the "
                   "card)", src + "multi_tensor_sgd.cu",
                   "ovmono3d_tpu/train/optim.py:77")
    meta["finite"] = ("finite_kernel (multi_tensor_all_finite, the train "
                      "step's skip flag)", src + "multi_tensor_sgd.cu",
                      "ovmono3d_tpu/parallel/train_step.py:104")
    meta["k9"] = ("layernorm_fwd kF32Stats (layer_norm_fused)",
                  src + "layernorm_fwd.cu", "ovmono3d_tpu/ops/layernorm.py:28")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for kind, (name, source, replaces) in meta.items():
        design = (DESIGN_KEYS + SHARD_KEYS if kind in ("fwd", "lse", "bwd")
                  else F32_KEYS if kind == "fwd_f32"
                  else PREVIOUS_KEYS
                  if kind in ("relpos", "window", "int8", "relpos_bwd")
                  else ("device_ms", "library_device_ms")
                  if kind == "relpos_lse"
                  else ("device_ms",) if kind == "quant"
                  else OPTIM_KEYS if kind in ("sgd", "finite") else ())
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kind],
                        **{key: k[kind][key] for key in keys + design}})
    probe_lines = {"v2": ("kF32Stats", 53), "v3": ("kRecipMean", 84),
                   "v4": ("kBf16Squares", 124)}
    for variant, (inst, line) in probe_lines.items():
        r = ln[f"k12_{variant}"]
        kernels.append({"name": f"layernorm_fwd {inst} (probe {variant})",
                        "route": "cuda", "source": src + "layernorm_fwd.cu",
                        "replaces": f"tools/probe_layernorm.py:{line}",
                        "launches": r["launches"],
                        **{key: r[key] for key in keys}})
    for (bq, bk, f32), r in sweep.items():
        kernels.append({"name": f"attn_sweep_fwd_bf16<{bq}, {bk}, "
                                f"{'f32' if f32 else 'bf16'} softmax>",
                        "route": "cuda", "source": src + "attn_sweep_fwd.cu",
                        "replaces": "tools/profile_attn_sweep.py:15",
                        "launches": r["launches"],
                        **{key: r[key] for key in keys + SWEEP_KEYS}})
    print(json.dumps({"kernels": kernels}), flush=True)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
