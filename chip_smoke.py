#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tmrnet_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits nonzero:
1. the card: `nvidia-smi` name and power limit;
2. the build: every CUDA kernel of the port's paths, from the sources in
   tmrnet_torch/csrc, one nvcc per source in parallel;
3. each kernel against its plain PyTorch version at its path's shapes, with
   times of the kernel, the plain version and one PyTorch library call or
   chain for the same function (for nl_attention and time_conv, kernels of
   a few to tens of microseconds, and for the int8 kernels per gate shape,
   also the card's own time, `device_ms`: launches captured in a CUDA graph
   and replayed, beside `ms`, back-to-back eager calls, which at that size
   time the host's launch path): the bf16
   kernels (nl_attention, time_conv, fused_bottleneck,
   fused_bottleneck_tiled, the last two also with their device ms per
   stage) against the plain version in f32 (TF32 off) on
   the same inputs, max |kernel - plain| / max |plain|
   <= 2e-2; the two bottleneck kernels per ResNet-50 stage at N = 320
   frames, with the achieved TFLOP/s and the kernel / cuDNN-chain ratio
   beside the bound (their JSON records carry these per-stage numbers
   under "stages"); the int8 kernels (int8_matmul, int8_conv3x3) at the
   int8 gate's shapes (B = 128 frames) and a square 8192^3 product, bit for
   bit; int8_matmul's record carries per product its plan, device ms,
   eager ms, TOP/s, bound and torch._int_mm under "shapes" (its device_ms
   sums the chain's 8), int8_conv3x3's per stage its plan, device ms,
   TOP/s, bound, torch._int_mm on a prebuilt im2col and a bf16 cuDNN
   conv3x3 under "stages"; the bf16 kernels again at the shapes the
   engines, the daemon and `test` give them (head B = 2,582 / 44,000 / 16
   / 4 / 64, bottlenecks N = 16 / 4 / 2,048 / 400 / 640); and time_conv
   at B = 139,811, W = 30, C = 512,
   one row past one launch's 32-bit limit: 2 launches, the rows at the
   split and 256 seeded others against the plain version (time_conv's f32
   kernel is checked in 4q, after the paths); (d) time_conv's
   column slices (tensor parallelism over M = 2 and 4 ranks: weights (k,
   512, 512 / M), the output channels from c0) at B = 8 and 2,582, W = 30:
   each M's slices side by side equal to the whole call bit for bit, the
   last slice against the plain version's slice, with its device ms,
   bound and a cuDNN chain for the same slice under the time_conv
   record's "slices";
4. the block slice: full-width TMRNet (ResNet-50, BN folded, hidden 512,
   window 30, 7 classes, bf16) with seeded random weights through the
   weight bridge, a 4096x512 bf16 bank on the card, and ClipInference
   answering 3 requests of 32 uint8 clips of 10 224x224 frames; launch
   counts must be 12 fused_bottleneck, 1 time_conv and 1 nl_attention per
   forward; the first 2 clips rerun on the CPU in f32 through the plain ops
   must match the card's softmax within 2e-2 and agree on the argmax, one
   of them at least decided (fc_c's seeded weights scaled by
   SERVE_LOGIT_SCALE in 4, 4b, 4c, 4d and 4h, as in 4e);
4b. the tiled slice: the same model, weights, bank and requests through
   ClipInference(fused_kernel="tiled"); 10 fused_bottleneck_tiled, 2
   fused_bottleneck, 1 time_conv and 1 nl_attention launches per forward;
   the same CPU check on the first 2 clips, and its softmax within 2e-2 of
   the block slice's on all 96 clips;
4c. the video slice: VideoInference at the same width (device_normalize,
   10-frame clips, window 30) with two seeded weight sets, the TMR model
   and the LFB extractor; run_video on one 1,500-frame uint8 224x224 video
   (block path) and run_corpus over videos of 1,500, 1,100 and 9 frames
   (tiled path; the 9-frame video gives empty outputs), launch counts from
   the chunk plan (the identity blocks' kernels per trunk chunk x 2
   trunks, time_conv and nl_attention per head call); the corpus's first
   video against run_video within 2e-2 and the argmax rule of the clip
   slices; bank_features against the extractor run clip-wise on the card
   at 64 positions (0, 1 and the last among them) within 2e-2 of max
   |feature|; ClipInference over those positions, reading a bank built by
   build_lfb_video, against run_video within 2e-2; a 14-frame video on the
   card against the engine in f32 on the CPU within 2e-2; frames/s of
   run_video and run_corpus and the auto trunk chunk;
4d. the stream slice: StreamingInference, 16 streams x 48 steps of uint8
   224x224 frames, stream 3 inactive at steps 20-24, stream 5 reset at step
   30; 24 fused_bottleneck, 1 time_conv and 1 nl_attention launches every
   step; inactive slots frozen bit for bit; every stream's valid outputs
   against run_video over the frames it took (split at the reset) within
   2e-2; step p50 and p99 ms after 4 warm-up steps and stream-frames/s;
4e. the serving slice: the same width (BN folded at load, device_normalize,
   test crop 1) with two seeded weight sets written as reference-format
   .pth files by the port's export and read back only through its import,
   and 6 packed videos of 40 uint8 250x250 frames (`<file>.npy#<t>`).
   Part A: serve_loop with probabilities over a JsonlTcpServer in a thread,
   4 slots, two clients, 34 ticks: joins at different ticks, an end and a
   new stream in its slot, a stream frozen 3 ticks, a join that finds no
   free slot, a client that disconnects with a frame pending; every row
   and error row as planned, each stream life against run_video over the
   frames it took within 2e-2 and the argmax rule (fc_c's seeded weights
   scaled by SERVE_LOGIT_SCALE, so that the classes spread and the rule
   decides rows), 24 fused_bottleneck,
   1 time_conv and 1 nl_attention launches on every tick (the warm-up's
   too) and none in a slot reset; latency_ms and step_ms p50/p95. Part B:
   `python -m tmrnet_torch serve --listen 127.0.0.1:0 --state-dir ...` as
   a subprocess, 2 streams for 12 ticks, SIGTERM (exit 0, state.npz
   left), a restart and 8 more ticks whose rows go on from frame 12 and
   equal an uninterrupted in-process run within 1e-6 (same card, code and
   dtype: a ring restored wrong shows); seconds to ready;
4f. the test slice: `python -m tmrnet_torch manifest`, `build-lfb`
   (clip and video engines) and `test` (clip engine over the clip bank,
   `--lfb`; video; corpus) through `tmrnet_torch.cli.main` in this
   process, at the width of 4e (`--set model.folded=true`), over 4 packed
   videos of 300, 200, 45 and 9 uint8 250x250 frames with phase
   annotations (518 clip positions; each frame its phase's colour under a
   quarter of noise) and two seeded reference `.pth`;
   exact launch counts per command (the clip engines 12 fused_bottleneck a
   batch of 40 or 64 clips, `test`'s also 1 time_conv and 1 nl_attention;
   the video engines by the chunk plan); the two banks within 2e-2 of max
   |feature|; the three engines' softmax within 2e-2 of each other and the
   argmax rule; each engine's predictions over two classes at least and
   its softmax varying across rows by more than 2e-2; 8 clips of the
   clip engine against the CPU in f32;
   build_lfb(fused_kernel="tiled") against the block build; each clip
   accuracy equal to the mean of preds == labels; then `python -m
   tmrnet_torch test` as a subprocess, equal to the in-process corpus
   run; clips/s of `test` and frames/s of `build-lfb` per engine, and the
   loader's share (host clock around each next() of ClipLoader);
4g. the training slice (`run_train_slice`): a train step of each stage on
   the card against the CPU, 20 steps that learn, the training commands
   with exact launch counts, preemption and resume (4j (e)'s run under
   train.async_checkpoint beside it; both subprocess pairs in threads
   while the train steps' CPU references run), step times; each part's
   seconds;
4j. the ResNeSt and training-options slice (`run_options_slice`), over
   4g's directory: (a) a ResNeSt-50 train step of each stage on the card
   against the CPU as 4g's, the bf16 aggregates by ResNeSt's own limits
   (`train/step_check.py::AGG_LIMITS`); (b) `train-bank`, `build-lfb
   --ckpt`, `train-tmr --stage1-ckpt` and `test --ckpt --extractor-ckpt`
   with `--set model.backbone=resnest50` over 4g's split, no #3 or #4
   launch and #1 / #2 as 4g reckons them, `test` against the best
   checkpoint's val pass re-run; (c) ResNeSt-50's train step at
   TRAIN_BATCH clips, p50 ms, frames/s, peak memory; (d) remat on
   ResNet-50: an f32 step with train.remat against without (deltas within
   STEP_F32_TOL, statistics within 1e-6), then the bf16 step at
   TRAIN_BATCH both ways, ms and peak memory; (e) async checkpoints: how
   long save() blocks, sync and async, and 4g D's SIGTERM and resume of
   `train-tmr` under train.async_checkpoint; (f) the native preprocess:
   the first train batch through the C++ library against numpy (1e-6),
   and a `train-bank` epoch each way with host normalization; (g) on
   4g's checkpoints, `test`, `stream` and `serve` with `--extractor-ckpt`
   equal to `--extractor-torch-ckpt` on its exported `.pth`, and `serve
   --ckpt` to `serve --torch-ckpt` within 1e-6 (2 streams, 12 ticks);
4h. the ResNeSt slice: the full-width folded ResNeSt-50 TMRNet (stem 32,
   radix 2, bf16) with seeded weights through the weight bridge; (a) the
   clip slice of phase 4 through ClipInference, 0 fused_bottleneck, 0
   fused_bottleneck_tiled, 1 time_conv and 1 nl_attention launches a
   forward (its blocks have no identity 3x3 conv for the fused kernels),
   the first 2 clips against the CPU in f32; (b) run_video on a
   1,500-frame video (1 + 1 launches) with its copy / trunks / head
   split, the peak memory of one trunk chunk at the auto plan (2,048
   frames at 224x224) within MEMORY_SHARE of what the card can allocate,
   bank_features against the extractor clip-wise at 64 positions, and
   the stream slice of 4d on this trunk (1 + 1 launches a step); (c) the
   weights exported as reference `.pth` in the resnest package's naming,
   then `manifest`, `build-lfb` (clip) and `test` (clip, corpus) with
   `--set model.backbone=resnest50 --set model.folded=true` in this
   process over 4f's videos, exact launch counts, each softmax against
   the engine built in memory from the unexported weights and the two
   engines against each other; then `python -m tmrnet_torch serve` from
   the same `.pth`, 2 streams for 12 ticks, its rows against serve_loop
   in this process within 1e-6; frames/s, stream p50 / p99 and peak
   memory beside the card;
4i. the scoring slice, over the directories 4f, 4g and 4h leave: (a)
   `stream --max-streams 2` through `tmrnet_torch.cli.main` over 4f's
   videos and `.pth` files, 24 fused_bottleneck, 1 time_conv and 1
   nl_attention launches on every step and none in a slot reset, the
   steps of the slot plan (300), its JSONL rows in the plan's order and
   each valid row's softmax (recorded from the engine) within 2e-2 of
   4f's `test --engine video` with the argmax rule, two predicted classes
   at least and a softmax that varies across rows, stream-frames/s and
   step p50 / p99 (the frames over the first step's start to the last
   step's end); (b) `export` of that test's `.npz` and of the stream's
   `.jsonl`, `evaluate --fps 1 --json-out` of each, equal per-video
   accuracies where the predictions agree (the whole reports where they
   all do); (c) `parity` from 4f's `.pth` files, exact launches of its
   bank build (12 fused_bottleneck a batch of 40 clips) and inference (12
   / 1 / 1 a batch of 64), its predictions against `test --engine clip
   --set memory.compat_cross_video=true` over its bank within 1e-6, its
   JSON equal to `evaluate` of its export; (d) the same with `--preset
   tmr-resnest50` from 4h's ResNeSt `.pth` (0 / 0 / 1 / 1 launches a
   batch), its clips normalized on the host as the preset says, and again
   with `--set data.device_normalize=true`, the uint8 path of 4f and 4h,
   the two softmaxes within 2e-2 with the argmax rule; (e) `export-ckpt` of 4g's stage-2 checkpoint, then `test
   --torch-ckpt` on the `.pth` bit for bit against `test --ckpt`; the
   commands' seconds beside the card;
4k. the multi-process slice (`run_multi_slice`), over 4f's and 4g's
   directories, in ~90 s: (a) `python -m tmrnet_torch train-tmr` for 1
   epoch over 4g's split as rank 0 of a world of 1 (RANK=0 WORLD_SIZE=1
   LOCAL_RANK=0, MASTER_ADDR and MASTER_PORT, `--set mesh.multihost=true`)
   beside the same command without it, both with cuDNN's deterministic
   algorithms: the backend NCCL and the final weights bit for bit equal;
   (b) two ranks sharing the card over gloo (NCCL refuses two ranks on one
   device), each with 4 of a global batch of 8 uint8 224x224 clips of 10
   frames, ResNet-50, hidden 512, window 30, 2 SGD steps (lr 1e-3) of
   head tmr in bf16 (the main path's dtype; 4q (b) holds tmr in f32) and
   of head nl_only in f32, against the same steps in this process over
   the whole batch by `train/step_check.py`'s limits (`multi_train`), each rank's
   launches, the steps' ms and the host gathers' ms; (c) `test --engine
   corpus` and `build-lfb --engine video` over 4f's videos and `.pth`
   files as two ranks sharing the card over gloo under mesh.multihost:
   the predictions equal 4f's exactly, the softmax and the bank within
   2e-2; the launches of every rank, as path "multi";
4l. the artifact slice (`run_artifact_slice`): (a) the clip step exported
   through `torch.export` at the width of phase 4 (`eval/saved.py::
   export_inference`, uint8 wire, batch 32), saved, loaded back and held
   against ClipInference's eager model on phase 4's requests and windows
   within 2e-2 with the argmax rule (0 expected), 12 fused_bottleneck, 1
   time_conv and 1 nl_attention launches a call, the export's seconds,
   the artifact's bytes, both paths' p50 ms a call; the tiled export's
   call, 10 fused_bottleneck_tiled and 2 fused_bottleneck launches; (b)
   `python -m tmrnet_torch export-model --stream` as a subprocess from
   4e's `.pth` (the same seed, folded, 4 slots), then `serve --artifact`
   and `serve --torch-ckpt` through `tmrnet_torch.cli.main`, 2 streams
   for 14 ticks: the same rows and launches, probabilities within 2e-2
   and the argmax rule, each command's seconds to ready; (c)
   `export-model --stream --slots 2` from 4f's `.pth`, then `stream --artifact` over 4f's videos against `stream
   --torch-ckpt --max-streams 2`: the same rows and launches (24 / 1 / 1
   a step), every step's softmax within 2e-2 with the argmax rule, both
   step p50s; (d) `doctor --smoke --artifact --lfb --checkpoint` through
   `tmrnet_torch.cli.main` over (a)'s artifact, 4f's bank and 4g's
   checkpoint: exit 0, no FAIL line; (e) the host's µs a call of each
   `torch.ops.tmrnet` op against its direct `*_cuda` launch at the stream
   step's shapes;
4m. the synth slice (`run_synth_slice`), in its own directory: (a)
   `synth --train 2 --val 1 --test 1 --hw 250 --seed 0` through
   `tmrnet_torch.cli.main` in this process, its JSON line's `videos`,
   `ambiguous_phases` and `frame_only_ceiling`, and its packs and
   annotations byte-equal to `write_synthetic_dataset` called again; (b)
   `manifest --stride 1` a split, then `stats --no-resize --population`
   and `stats --no-resize` over the train pickle, each within 1e-6 of
   numpy's own statistics of those frames; (c) `pack` of the train/val
   pickle into another directory, its `.npy` files byte-equal to synth's,
   the same ids, labels and splits; (d) the learning-efficacy study
   (`python -m tmrnet_torch.experimental.efficacy_study --full-scale`:
   ResNet-50, 224² crops, hidden 512, bf16; `model.folded=true` on `test`
   and `build-lfb`, `data.use_flip=false`) in this process over (a)'s
   data, one epoch a stage, head tmr: exact launches per command (the
   stage-1 `test` 12 fused_bottleneck a batch of 64 clips, `build-lfb`
   12 a video, `train-tmr` 1 time_conv and 1 nl_attention a train step
   and a val batch, the tmr `test` the corpus engine's), rows with JAX's
   keys, accuracies in [0, 1], finite val losses and each arm's protocol
   table; no accuracy gate;
4n. the reference slice (`run_reference_slice`), in its own directory:
   (a) `python -m tmrnet_torch migrate --cmd '...'` for a command line of
   each of the 17 reference scripts `migrate` knows, as subprocesses
   started together: each exits 0 and every command it prints parses
   through the port's parser with its --set keys resolved; (b) `synth` at
   4m's sizes, then the port's translation of
   `train_singlenet_phase_1fc.py -t 160 -e 1 --sgdadjust 0` and
   `train_non-local_mutiConv_resnet.py -t 160 -e 1 --LFB_l 30` (train-bank,
   build-lfb, train-tmr at full width) through `tmrnet_torch.cli.main`,
   the placeholders replaced by synth's pickles, `data.use_flip=false`,
   `model.folded=true` on build-lfb: finite losses, launches by 4m's
   rules (12 fused_bottleneck a trunk chunk of a video, 1 time_conv and 1
   nl_attention a train step); (c) `prepare` and `train-bank --videos`
   where no decoder imports exit naming imageio+pyav and cv2 and write
   nothing; then one epoch of `train_stage1`, the clip-engine bank
   (folded) and one epoch of `train_stage2` over a `VideoClipDataset`
   whose reader serves (b)'s frames from memory: finite losses, the first
   batch on the card the host's [0, 1] clips cast to bf16, launches (12
   fused_bottleneck a bank batch, 1 time_conv and 1 nl_attention a step
   and a val batch), the bank's first 8 rows within 2e-2 of the CPU's f32
   build;
4o. the mesh slice (`run_mesh_slice`), after 4l, over 4g's directory:
   (a) two ranks sharing card 0 over gloo as a 1 x 2 grid (`--multi-rank`
   with `--multi-mp 2`: tensor parallelism, each rank holding its slices
   of the layers JAX's rules shard), 2 SGD steps (lr 1e-3) at full width
   (ResNet-50, hidden 512, window 30, 7 classes) over 8 uint8 224x224
   clips of 10 frames, head tmr in bf16 and stage1 in f32, against the
   same steps in this process over the whole batch by 4k (b)'s limits
   (`train/step_check.py`), the whole deltas (each rank's slices
   gathered) bit-equal across the ranks, each slice of step 1 against
   the one-process slice (f32: within TENSOR_LIMIT), 1 time_conv (its
   256-column slice) and 1 nl_attention launch a tmr step on each rank,
   the ms a step (the one-process tmr steps are 4k (b)'s); (b) then the
   same two ranks run `train-tmr` for one epoch over 4g's split through
   `tmrnet_torch.cli.main` as that grid (`--set mesh.multihost=true --set
   mesh.model_parallel=2`): each rank's mesh line and launches (1
   time_conv and 1 nl_attention a step and a val batch), finite losses,
   a checkpoint of whole tensors, then `test --ckpt` on it in this
   process; (c) the sequence-parallel
   video pass, `VideoInference(devices=[cuda:0, cuda:0])` (one card a
   shard where the host has two): run_video on 4c's 1,500-frame video,
   bank_features at 64 of its positions and run_corpus over 4c's videos
   on the tiled path, each within 2e-2 of the one-device engine with 4c's
   argmax rule, the bottleneck launches by card as the chunk plan gives
   them (`build.LAUNCHES_BY_DEVICE`), and frames/s of both engines. The
   `kernels` line counts its launches under path "mesh". `python3
   chip_smoke.py --mesh-only WORLD MP BACKEND` runs (a) alone as a
   (WORLD / MP) x MP grid, one card a rank where the host has them (2 x 2
   over NCCL on four cards), and (c) over 2 cards (card 0 twice on one)
   and over 4 where there are;
4p. the shard slice (`run_shard_slice`), after 4o, over 4f's directory,
   the shards of one process over `sp_devices` (card 0 twice on a
   one-card host): (a) `ClipInference(devices=)` on phase 4's model,
   bank and 3 requests of 32 clips on the block and the tiled path,
   against the one-device engine within 2e-2 and 4's argmax rule, per
   shard forward 12 fused_bottleneck (block; tiled 10
   fused_bottleneck_tiled and 2 fused_bottleneck), 1 time_conv and 1
   nl_attention on its card (`build.LAUNCHES_BY_DEVICE`), clips/s of
   both engines; (b) `build_lfb(engine="clip", devices=)` over 4f's
   manifest and extractor (folded, batches of 40), within 2e-2 of max
   |feature| of 4f's clip bank, 12 fused_bottleneck a shard of each
   batch; (c) `StreamingInference(devices=)`, 16 streams in two groups x
   24 steps, stream 3 inactive at steps 10-12 (frozen bit for bit),
   stream 5 reset at step 15, every valid row within 2e-2 of the
   one-device engine with the argmax rule, each step 24
   fused_bottleneck, 1 time_conv and 1 nl_attention a group on its card,
   step p50 / p99 ms of both; (d) `experimental/headlevel_multiscale.py`'s
   HeadOnly (tmr) at hidden 512, window 40, bf16 over 512 seeded rows:
   the first forward within 2e-2 of f32 on the CPU, 20 Adam steps of 128
   rows with finite losses, 1 time_conv and 1 nl_attention a forward;
   (e) `tmrnet_torch.entry.entry()`: fn(*args) gives finite (2, 7)
   logits with 1 time_conv and 1 nl_attention. The `kernels` line counts
   its launches under path "shard". `python3 chip_smoke.py --shard-only`
   runs (a)-(c) over every visible card ((b) over a 4f directory of its
   own), and where there are N >= 2, `test --engine clip` and `stream`
   through `tmrnet_torch.cli.main` with `--set mesh.data_parallel=N`
   against the same commands on one card;
4q. the f32 slice (`run_f32_slice`), after 4p, over 4f's directory and
   4g A's CPU step: (a) csrc/time_conv_f32.cu (f32 FFMA, no TF32) at W =
   30, C = 512 and B = 16, 2,582 and 44,000, and over the last 256
   output columns at B = 2,582 (its two slices side by side equal to the
   whole call bit for bit), against `time_conv_plain` in f32 (TF32 off)
   within 1e-5 of max |plain|, with eager ms (at B = 16 also the card's
   own), the plain version's, the FFMA bound and the cuDNN chain's (three
   conv1d and the maxes, TF32 off); the kernel's record on the `kernels`
   line as `time_conv_f32`; (b) 4g A's full-width tmr step (ResNet-50
   224x224, hidden 512, window 30, 8 clips) at
   model.compute_dtype=float32 on the card against 4g A's f32 step on the
   CPU by `train/step_check.py`'s f32 limits, 1 time_conv_f32 and 1
   nl_attention launch; (c) `test --engine clip` over 4f's directory at
   model.compute_dtype=float32, unfolded, through `tmrnet_torch.cli.main`:
   1 time_conv_f32 and 1 nl_attention a batch of 64 clips and no
   bottleneck kernel, the softmax within 2e-2 of 4f's bf16 clip engine
   with the argmax rule and at 8 rows within 1e-3 of the engine in f32 on
   the CPU; then `stream --max-streams 2` at f32 over the same videos:
   the slot plan's 300 steps, 1 time_conv_f32 and 1 nl_attention a step;
   its launches count under path "f32";
4r. the folded f32 trunk (`run_folded_f32_slice`), after 4q: (a)
   csrc/fused_bottleneck_f32.cu (f32 FFMA, no TF32; clusters of CTAs that
   share each weight chunk by TMA multicast and y1's halo by DSMEM)
   through both wrappers, fused_bottleneck_f32 and
   fused_bottleneck_tiled_f32, at ResNet-50's identity stages (the tiled
   one at C < 2048) at N = 7 and 320 within 1e-5 of max
   |plain|, with eager and device ms, the plain version's, the cuDNN f32
   chain's and the FFMA bound, and each plan's cut (cluster size, CTA
   tile, span, real-row share, the weights' modelled GB from L2); (b) the
   folded f32 trunk on both paths against the unfolded one on cuDNN within
   1e-4 of max |feature|, and a clip forward on both paths against the
   engine in f32 on the CPU; (c) `test --engine clip` at f32, folded,
   against 4q (c)'s unfolded run; its launches count under path
   "f32_folded";
5. the int8 gate (tmrnet_torch.experimental.int8_gate) at B = 128 over the
   four stages: the int8 bottleneck chain through the kernels equal to the
   same chain through the plain versions, 2 int8_matmul and 1 int8_conv3x3
   launches per chain, and the gate's rows (bf16 ms, int8 ms, rates,
   speedups);
6. a JSON line of every phase's ok and seconds and the phases that
   failed (a phase that raises is recorded as failed and the next one
   runs), a JSON line of per-kernel numbers, the card's name and power
   limit, and last the line {"ok": true, "device": {...}}; where a phase
   failed, no such line, the failed phases named on stderr and exit 1.

It needs a CUDA card and the rest of the repository beside it.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

CLIPS, SEQ, IMG, WINDOW, BANK_ROWS, HIDDEN, CLASSES = 32, 10, 224, 30, 4096, 512, 7
REQUESTS = 3
TOL = 2e-2
# Published H100 SXM peaks (dense): bf16 and int8 tensor cores, f32 outside
# them, HBM.
PEAK_BF16, PEAK_I8, PEAK_F32, HBM_BYTES_S = 989e12, 1979e12, 67e12, 3.35e12
# ResNet-50 stride-1 identity blocks per stage at 224x224: (H, C, P, count).
STAGES = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
          (7, 2048, 512, 2))
TILED_MAX_C = 2048      # wider identity blocks stay on fused_bottleneck
GATE_BATCH = 128        # frames per int8 gate stage
# Videos of the video slice: a short Cholec80 test video at 1 fps, another,
# and one shorter than a clip; streams and steps of the stream slice.
VIDEO_LENGTHS = (1500, 1100, 9)
STREAMS, STREAM_STEPS = 16, 48
SQUARE = 8192           # the square int8 product
# The serving slice: packed videos and their frames; how long a daemon may
# take to print {"ready": true}; its slots (the N and B its kernels see);
# the factor on fc_c's seeded weights (random weights leave the 7-class
# softmax near uniform); a resumed daemon against an uninterrupted run.
SERVE_VIDEOS, SERVE_FRAMES, SERVE_READY_TIMEOUT = 6, 40, 300
SERVE_SLOTS, SERVE_LOGIT_SCALE, RESUME_TOL = 4, 4.0, 1e-6
ROOT_TMP = os.path.join(ROOT, "build")
# The test slice (4f): packed videos of 250x250 frames (291 + 191 + 36 + 0
# = 518 clip positions), the clips a batch of the clip engines (the
# defaults of data.batch_clips and eval.batch_clips), and how long
# `python -m tmrnet_torch test` may take as a subprocess.
TEST_LENGTHS = (300, 200, 45, 9)
LFB_BATCH, TEST_BATCH = 40, 64
# A colour a phase for the test videos' frames (write_test_videos), and
# the frames of each in the video that calibrates 4f's logits.
PHASE_COLOURS = ((220, 40, 40), (40, 200, 60), (40, 60, 220), (230, 220, 50),
                 (40, 210, 220), (210, 50, 210), (20, 20, 20))
CALIB_FRAMES = 20
TEST_TIMEOUT = 600
# Phase 4g, the training slice: clips of a train step (A, B) and of the
# benchmark (E, data.batch_clips), the Adam steps of B, the warm-up and
# timed steps of E, the workflow's epochs (C), how long a training
# subprocess may take (D); the card-vs-CPU step's limits (A: the bf16
# step's loss, the f32 step's loss and statistics, the aggregates of the
# bf16 step's deltas); the best checkpoint's val loss against its val pass
# re-run (C). The aggregates' limits are `train/step_check.py::AGG_LIMITS`,
# per backbone, from full-width CPU readings (`--step-reading`).
TRAIN_CLIPS, LEARN_STEPS, TRAIN_BATCH = 8, 20, 40
BENCH_WARMUP, BENCH_STEPS = 3, 10
BANK_EPOCHS, TMR_EPOCHS, TRAIN_TIMEOUT = 1, 2, 600
STEP_LOSS_TOL, STEP_F32_TOL, VAL_LOSS_TOL = 2e-2, 1e-3, 1e-5


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=10, warmup=2):
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


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(torch, name, got, want, limit=TOL):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = err / scale if scale > 0 else err
    ok = bool(np.isfinite(rel)) and rel <= limit
    print(f"  {name}: max_abs_err {err:.4g}, /max|ref| {rel:.4g} "
          f"(limit {limit}) {'ok' if ok else 'FAIL'}")
    return err, ok


def print_head(rec):
    print(f"    device {rec['device_ms']:.5f} ms, eager {rec['ms']:.5f} ms, "
          f"plain {rec['plain_ms']:.5f} ms, library {rec['library_ms']:.5f} "
          f"ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")


def check_kernels(torch, seed):
    """Phase 3: each kernel against its plain version; returns records."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.fused_bottleneck import (
        fused_bottleneck_cuda, fused_bottleneck_plain)
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        fused_bottleneck_tiled_cuda)
    from tmrnet_torch.experimental.kernel_timing import graph_ms
    from tmrnet_torch.ops.nl_attention import nl_attention_cuda, nl_attention_plain
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = lambda shape, s=1.0: torch.randn(shape, generator=gen, device=dev) * s
    bf = lambda shape, s=1.0: f32(shape, s).to(torch.bfloat16)
    records, all_ok = [], True

    # 1. nl_attention: q (B, F), k/v (B, W, F), W = 30.
    q = bf((CLIPS, HIDDEN))
    k = bf((CLIPS, WINDOW, HIDDEN))
    v = bf((CLIPS, WINDOW, HIDDEN))
    err, ok = compare(torch, "nl_attention", nl_attention_cuda(q, k, v),
                      nl_attention_plain(q.float(), k.float(), v.float()))
    all_ok &= ok
    scale = (1.0 / HIDDEN) ** 0.5
    lib = lambda: torch.einsum(
        "bw,bwf->bf", torch.softmax(
            torch.einsum("bf,bwf->bw", q, k).float() * scale, -1).to(q.dtype), v)
    qf, kf, vf = q.float(), k.float(), v.float()
    b_ms, b_by = bound(4 * CLIPS * WINDOW * HIDDEN,
                       2 * (CLIPS * HIDDEN * 2 + 2 * CLIPS * WINDOW * HIDDEN),
                       PEAK_F32)
    records.append(dict(
        name="nl_attention", route="cuda",
        source="tmrnet_torch/csrc/nl_attention.cu",
        replaces="tmrnet_tpu/ops/nl_attention.py:39", max_abs_err=err,
        ms=time_ms(torch, lambda: nl_attention_cuda(q, k, v), 50),
        device_ms=graph_ms(torch, lambda: nl_attention_cuda(q, k, v)),
        plain_ms=time_ms(torch, lambda: nl_attention_plain(qf, kf, vf), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, lib, 50)))
    print_head(records[-1])

    # 2. time_conv: x (B, W, C), weights (k, C, C).
    c = HIDDEN
    x = bf((CLIPS, WINDOW, c))
    ws = []
    for ksz in (3, 5, 7):
        ws += [bf((ksz, c, c), (1.0 / (ksz * c)) ** 0.5), f32((c,), 0.02)]
    wsf = [t.float() for t in ws]
    err, ok = compare(torch, "time_conv", time_conv_cuda(x, *ws),
                      time_conv_plain(x.float(), *wsf))
    all_ok &= ok
    wt = [(ws[2 * i].permute(2, 1, 0).contiguous(), ws[2 * i + 1].to(x.dtype))
          for i in range(3)]

    def tc_lib():
        xt = x.transpose(1, 2)
        out = torch.maximum(xt, F.pad(xt, (1, 0))[:, :, :-1])
        for (w_, b_), ksz in zip(wt, (3, 5, 7)):
            out = torch.maximum(out, F.conv1d(xt, w_, b_, padding=ksz // 2))
        return out.transpose(1, 2)

    m = CLIPS * WINDOW
    b_ms, b_by = bound(2 * m * c * c * 15,
                       2 * (2 * m * c + 15 * c * c) + 4 * 3 * c, PEAK_BF16)
    records.append(dict(
        name="time_conv", route="cuda", source="tmrnet_torch/csrc/time_conv.cu",
        replaces="tmrnet_tpu/ops/time_conv.py:76", max_abs_err=err,
        ms=time_ms(torch, lambda: time_conv_cuda(x, *ws), 20),
        device_ms=graph_ms(torch, lambda: time_conv_cuda(x, *ws)),
        plain_ms=time_ms(torch, lambda: time_conv_plain(x.float(), *wsf), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, tc_lib, 20)))
    print_head(records[-1])

    # 3 and 4. fused_bottleneck at each stage, and fused_bottleneck_tiled at
    # the stages the tiled path gives it (C < 2048), on the same inputs,
    # N = B*T frames; per-forward numbers weight each stage by its count of
    # identity blocks.
    n = CLIPS * SEQ
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "flops", "bytes")
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("block", "tiled")}
    max_err = dict(block=0.0, tiled=0.0)
    stages = dict(block=[], tiled=[])
    for h, cc, p, count in STAGES:
        xs = torch.relu(bf((n, h, h, cc)))
        w1 = bf((cc, p), (2.0 / cc) ** 0.5)
        w2 = bf((3, 3, p, p), (2.0 / (9 * p)) ** 0.5)
        w3 = bf((p, cc), 0.25 * (2.0 / p) ** 0.5)
        b1, b2, b3 = (f32((s,), 0.05) for s in (p, p, cc))
        args = (xs, w1, b1, w2, b2, w3, b3)
        argsf = tuple(t.float() for t in args)
        want = fused_bottleneck_plain(*argsf)
        kernels = {"block": fused_bottleneck_cuda}
        if cc < TILED_MAX_C:
            kernels["tiled"] = fused_bottleneck_tiled_cuda
        for path, kernel in kernels.items():
            err, ok = compare(torch, f"{kernel.__name__[:-5]} {h}x{h}x{cc} P={p}",
                              kernel(*args), want)
            all_ok &= ok
            max_err[path] = max(max_err[path], err)
        del want
        # cuDNN chain on the same NHWC data (channels_last views).
        xc = xs.permute(0, 3, 1, 2)
        cw1 = w1.t().reshape(p, cc, 1, 1).contiguous(memory_format=torch.channels_last)
        cw2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cw3 = w3.t().reshape(cc, p, 1, 1).contiguous(memory_format=torch.channels_last)
        cb = [t.to(torch.bfloat16) for t in (b1, b2, b3)]

        def chain():
            y = torch.relu(F.conv2d(xc, cw1, cb[0]))
            y = torch.relu(F.conv2d(y, cw2, cb[1], padding=1))
            return torch.relu(F.conv2d(y, cw3, cb[2]) + xc)

        plain = time_ms(torch, lambda: fused_bottleneck_plain(*argsf), 3, 1)
        library = time_ms(torch, chain, 5, 1)
        flops = 2.0 * n * h * h * (cc * p + 9 * p * p + p * cc)
        nbytes = 2.0 * (2 * n * h * h * cc + 2 * cc * p + 9 * p * p) + 4 * (2 * p + cc)
        b_ms = bound(flops, nbytes, PEAK_BF16)[0]
        for path, kernel in kernels.items():
            ms = time_ms(torch, lambda: kernel(*args), 5, 1)
            device = graph_ms(torch, lambda: kernel(*args), 5, 3)
            tflops = flops / ms / 1e9
            print(f"    {path} stage {h}x{h}: kernel {ms:.4f} ms, device "
                  f"{device:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain:.4f} "
                  f"ms, cuDNN chain {library:.4f} ms (kernel / cuDNN "
                  f"{ms / library:.3f}), bound {b_ms:.4f} ms, x{count} per "
                  f"forward")
            stages[path].append(dict(
                stage=f"{h}x{h}x{cc} P={p}", per_forward=count, ms=ms,
                device_ms=device, tflops=tflops, library_ms=library,
                bound_ms=b_ms))
            for key, val in (("ms", ms), ("device_ms", device),
                             ("plain_ms", plain), ("library_ms", library),
                             ("flops", flops), ("bytes", nbytes)):
                tot[path][key] += count * val
        del xs, args, argsf, xc
    for path, name, source, replaces in (
            ("block", "fused_bottleneck", "tmrnet_torch/csrc/fused_bottleneck.cu",
             "tmrnet_tpu/experimental/fused_bottleneck.py:58"),
            ("tiled", "fused_bottleneck_tiled",
             "tmrnet_torch/csrc/fused_bottleneck_tiled.cu",
             "tmrnet_tpu/experimental/fused_bottleneck_tiled.py:123")):
        t = tot[path]
        b_ms, b_by = bound(t["flops"], t["bytes"], PEAK_BF16)
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max_err[path], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
            device_ms=t["device_ms"], stages=stages[path]))
    torch.cuda.empty_cache()
    return records, all_ok


def check_engine_shapes(torch, seed, records):
    """Phase 3, the engines' shapes: the bf16 kernels against their plain
    versions (f32) at the shapes the video, stream, serving and test
    slices give them -- the head kernels at the corpus's head call (the
    clip positions of the slice's videos that share a bucket), at a head
    group of 8 videos of 5,500 clips (44,000 rows), at a stream step (16
    rows), at a daemon's tick (SERVE_SLOTS rows) and at a `test` clip batch
    (TEST_BATCH rows); the bottleneck kernels at each stage at a stream step
    (16 frames), a daemon's tick (SERVE_SLOTS frames), a full auto trunk
    chunk (2,048 frames at 224x224), a clip batch of the LFB build
    (LFB_BATCH x 10 frames) and of `test` (TEST_BATCH x 10). Each record's
    max_abs_err becomes the largest over its shapes; the errors and eager
    ms per shape go under "engine_shapes"."""
    from tmrnet_torch.experimental.fused_bottleneck import (
        fused_bottleneck_cuda, fused_bottleneck_plain)
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        fused_bottleneck_tiled_cuda)
    from tmrnet_torch.ops.nl_attention import nl_attention_cuda, nl_attention_plain
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    bf = lambda shape, s=1.0: (torch.randn(shape, generator=gen, device=dev)
                               * s).to(torch.bfloat16)
    by_name = {r["name"]: r for r in records}
    all_ok = True

    def check(name, shape, kernel, plain, args):
        nonlocal all_ok
        err, ok = compare(torch, f"{name} {shape}", kernel(*args),
                          plain(*(t.float() for t in args)))
        all_ok &= ok
        ms = time_ms(torch, lambda: kernel(*args), 5, 1)
        rec = by_name[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec.setdefault("engine_shapes", []).append(
            dict(shape=shape, max_abs_err=err, ms=ms))
        print(f"    eager {ms:.4f} ms")

    corpus_rows = sum(n - SEQ + 1 for n in VIDEO_LENGTHS[:2])
    for b in (corpus_rows, 8 * 5500, STREAMS, SERVE_SLOTS, TEST_BATCH,
              TRAIN_BATCH):
        check("nl_attention", f"B={b}", nl_attention_cuda, nl_attention_plain,
              (bf((b, HIDDEN)), bf((b, WINDOW, HIDDEN)),
               bf((b, WINDOW, HIDDEN))))
        ws = []
        for ksz in (3, 5, 7):
            ws += [bf((ksz, HIDDEN, HIDDEN), (1.0 / (ksz * HIDDEN)) ** 0.5),
                   bf((HIDDEN,), 0.02).float()]
        check("time_conv", f"B={b}", time_conv_cuda, time_conv_plain,
              (bf((b, WINDOW, HIDDEN)), *ws))
    for n in (STREAMS, SERVE_SLOTS, 2048, LFB_BATCH * SEQ, TEST_BATCH * SEQ):
        for h, cc, p, _ in STAGES:
            args = (torch.relu(bf((n, h, h, cc))), bf((cc, p), (2.0 / cc) ** 0.5),
                    bf((p,), 0.05).float(),
                    bf((3, 3, p, p), (2.0 / (9 * p)) ** 0.5),
                    bf((p,), 0.05).float(),
                    bf((p, cc), 0.25 * (2.0 / p) ** 0.5), bf((cc,), 0.05).float())
            kernels = [("fused_bottleneck", fused_bottleneck_cuda)]
            if cc < TILED_MAX_C:
                kernels.append(("fused_bottleneck_tiled",
                                fused_bottleneck_tiled_cuda))
            for name, kernel in kernels:
                check(name, f"N={n} {h}x{h}x{cc} P={p}", kernel,
                      fused_bottleneck_plain, args)
            del args
            torch.cuda.empty_cache()
    return all_ok


# Phase 3 (d): time_conv's column slices, M = 2 and 4 ranks a model group,
# at the TP train step's batch and the video engine's.
SLICE_MS, SLICE_BATCHES = (2, 4), (8, 2582)


def check_time_conv_slices(torch, seed, records):
    """Phase 3 (d): time_conv over the output columns [c0, c0 + C / M) of
    a (k, 512, 512) layer, the last slice of each M, at B = 8 and 2,582,
    W = 30, against `time_conv_plain`'s slice (TOL of max |plain|), with
    the card's time, the bound of the slice's own work and a cuDNN chain
    for the same slice (conv1d per branch, then the max), recorded under
    the time_conv record's "slices"; and every M slices side by side equal
    to the whole-width call bit for bit. Returns ok."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.kernel_timing import graph_ms
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    c = HIDDEN
    ws = []
    for ksz in (3, 5, 7):
        ws += [(torch.randn((ksz, c, c), generator=gen, device=dev)
                * (1.0 / (ksz * c)) ** 0.5).to(torch.bfloat16),
               torch.randn((c,), generator=gen, device=dev) * 0.02]
    rec = next(r for r in records if r["name"] == "time_conv")
    rec["slices"], ok = [], True
    cut = lambda t, c0, n: (t[..., c0:c0 + n] if t.dim() == 3
                            else t[c0:c0 + n]).contiguous()
    for b in SLICE_BATCHES:
        x = torch.randn((b, WINDOW, c), generator=gen, device=dev).to(
            torch.bfloat16)
        whole = time_conv_cuda(x, *ws)
        for m in SLICE_MS:
            cout = c // m
            parts = [time_conv_cuda(x, *(cut(t, j * cout, cout) for t in ws),
                                    c0=j * cout) for j in range(m)]
            same = torch.equal(torch.cat(parts, dim=-1), whole)
            print(f"  time_conv B={b}: its {m} slices side by side equal the "
                  f"whole call bit for bit: {same} {'ok' if same else 'FAIL'}")
            ok &= same
            c0 = c - cout
            sl = [cut(t, c0, cout) for t in ws]
            got = parts[-1]
            err, good = compare(torch, f"time_conv slice B={b} M={m} "
                                f"({cout} columns from {c0})", got,
                                time_conv_plain(x.float(),
                                                *(t.float() for t in sl),
                                                c0=c0))
            ok &= good and tuple(got.shape) == (b, WINDOW, cout)
            xt = x.transpose(1, 2)
            xs = xt[:, c0:]
            wt = [(sl[2 * i].permute(2, 1, 0).contiguous(),
                   sl[2 * i + 1].to(x.dtype)) for i in range(3)]

            def chain():
                out = torch.maximum(xs, F.pad(xs, (1, 0))[:, :, :-1])
                for (w_, b_), ksz in zip(wt, (3, 5, 7)):
                    out = torch.maximum(out, F.conv1d(xt, w_, b_,
                                                      padding=ksz // 2))
                return out.transpose(1, 2)

            rows = b * WINDOW
            b_ms, b_by = bound(2 * rows * c * cout * 15,
                               2 * (rows * c + rows * cout + 15 * c * cout)
                               + 4 * 3 * cout, PEAK_BF16)
            rec["slices"].append(dict(
                batch=b, model_parallel=m, cout=cout, c0=c0, max_abs_err=err,
                ms=time_ms(torch, lambda: time_conv_cuda(x, *sl, c0=c0), 10),
                device_ms=graph_ms(torch, lambda: time_conv_cuda(
                    x, *sl, c0=c0)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, chain, 10)))
            r = rec["slices"][-1]
            print(f"    device {r['device_ms']:.5f} ms, eager {r['ms']:.5f} "
                  f"ms, cuDNN chain {r['library_ms']:.5f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        del x
    return ok


def check_time_conv_split(torch, seed, records):
    """Phase 3, the split: time_conv at B = 139,811, W = 30, C = 512 (~4.3
    GB of bf16), one row past one launch's 32-bit limit. It must launch
    twice; the rows at the split and 256 seeded others against the plain
    version in f32. Goes under time_conv's "engine_shapes", with its eager
    ms and launches."""
    from tmrnet_torch.kernels.build import LAUNCHES
    from tmrnet_torch.ops.time_conv import (
        time_conv_cuda, time_conv_max_rows, time_conv_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    limit = time_conv_max_rows(WINDOW, HIDDEN)
    b = limit + 1
    x = torch.randn((b, WINDOW, HIDDEN), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    ws = []
    for ksz in (3, 5, 7):
        ws += [(torch.randn((ksz, HIDDEN, HIDDEN), generator=gen, device=dev)
                * (1.0 / (ksz * HIDDEN)) ** 0.5).to(torch.bfloat16),
               torch.randn((HIDDEN,), generator=gen, device=dev) * 0.02]
    before = LAUNCHES["time_conv"]
    out = time_conv_cuda(x, *ws)
    launches = LAUNCHES["time_conv"] - before
    rows = torch.cat([torch.arange(limit - 2, b, device=dev),
                      torch.randint(0, b, (256,), generator=gen, device=dev)])
    err, ok = compare(torch, f"time_conv B={b} (split at {limit}), "
                      f"{len(rows)} rows", out[rows],
                      time_conv_plain(x[rows].float(), *(t.float() for t in ws)))
    del out
    ms = time_ms(torch, lambda: time_conv_cuda(x, *ws), 3, 1)
    ok_n = launches == 2
    print(f"    launches {launches} (want 2) {'ok' if ok_n else 'FAIL'}, "
          f"eager {ms:.4f} ms")
    rec = {r["name"]: r for r in records}["time_conv"]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["engine_shapes"].append(dict(shape=f"B={b}", max_abs_err=err, ms=ms,
                                     launches=launches))
    del x
    torch.cuda.empty_cache()
    return ok and ok_n


def int_mm_ms(torch, a, b, scale, iters):
    """The library yardstick of the int8 kernels: one torch._int_mm call
    (cuBLASLt int8) and the same f32 epilogue; None where it refuses the
    shapes."""
    try:
        return time_ms(torch, lambda: torch._int_mm(a, b).float() * scale,
                       iters, 1)
    except RuntimeError as exc:
        print(f"    torch._int_mm refused {tuple(a.shape)} @ {tuple(b.shape)}: "
              f"{str(exc).splitlines()[0]}")
        return None


def check_int8_kernels(torch, seed):
    """Phase 3, int8: int8_matmul and int8_conv3x3 against their plain
    versions, bit for bit, at the int8 gate's shapes (B = 128 frames per
    stage) and for int8_matmul also a square 8192^3 product. Each record
    sums one bottleneck chain per stage: two 1x1 products (C -> P, P -> C)
    and one 3x3 conv (P -> P), f32 output; int8_matmul's also its numbers
    per product (the gate's P -> P "mm" row and the square one beside the
    chain's) and int8_conv3x3's per stage, with the card's own time
    (CUDA-graph replays, the weight's prepared copy made before the
    capture)."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.kernel_timing import graph_ms
    from tmrnet_torch.experimental.int8_gate import STAGES as GATE_STAGES
    from tmrnet_torch.experimental.quant_conv import (
        im2col3x3, int8_conv3x3_cuda, int8_conv3x3_plain, plan_int8_conv3x3)
    from tmrnet_torch.ops.quant import (
        int8_matmul_cuda, int8_matmul_plain, plan_int8_matmul)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                      device=dev, dtype=torch.int8)
    scales = lambda n: (torch.rand((), generator=gen, device=dev) * 0.1,
                        torch.rand((n,), generator=gen, device=dev) * 0.01)
    all_ok = True
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops=0.0, bytes=0.0)
           for k in ("mm", "conv")}
    library_ok = dict(mm=True, conv=True)
    max_err = dict(mm=0.0, conv=0.0)
    mm_shapes, conv_stages = [], []

    def exact(name, got, want):
        same = bool(torch.equal(got, want))
        diff = (got - want).abs().max().item()
        print(f"  {name}: bit-exact {same} (max_abs_err {diff:.4g}) "
              f"{'ok' if same else 'FAIL'}")
        return same, diff

    def matmul(name, m, k, n, chain, iters=10):
        nonlocal all_ok
        a, b = i8(m, k), i8(k, n)
        a_s, b_s = scales(n)
        ok, err = exact(f"int8_matmul {name} {m}x{k}x{n}",
                        int8_matmul_cuda(a, b, a_s, b_s),
                        int8_matmul_plain(a, b, a_s, b_s))
        all_ok &= ok
        max_err["mm"] = max(max_err["mm"], err)
        kernel = lambda: int8_matmul_cuda(a, b, a_s, b_s)
        ms = time_ms(torch, kernel, iters, 2)
        device = graph_ms(torch, kernel)
        plain = time_ms(torch, lambda: int8_matmul_plain(a, b, a_s, b_s), 3, 1)
        library = int_mm_ms(torch, a, b, a_s * b_s, iters)
        ops, nbytes = 2.0 * m * k * n, m * k + k * n + 4.0 * m * n
        b_ms, b_by = bound(ops, nbytes, PEAK_I8)
        plan = plan_int8_matmul(m, k, n)
        lib_s = "n/a" if library is None else f"{library:.4f}"
        print(f"    kernel device {device:.5f} ms ({ops / device / 1e9:.1f} "
              f"TOP/s), eager {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch._int_mm {lib_s} ms, bound {b_ms:.5f} ms ({b_by}), plan "
              f"{plan}")
        mm_shapes.append(dict(
            shape=name, mkn=[m, k, n], chain=chain,
            plan=[plan.bm, plan.bn, plan.nstage], device_ms=device, ms=ms,
            tops=ops / device / 1e9, bound_ms=b_ms, bound_by=b_by,
            library_ms=library, plain_ms=plain))
        if chain:
            for key, val in (("ms", ms), ("plain_ms", plain), ("ops", ops),
                             ("bytes", nbytes)):
                tot["mm"][key] += val
            library_ok["mm"] &= library is not None
            tot["mm"]["library_ms"] += library or 0.0

    for stage, h, c, p in GATE_STAGES:
        m = GATE_BATCH * h * h
        matmul(f"{stage} C->P", m, c, p, True)
        matmul(f"{stage} P->C", m, p, c, True)
        matmul(f"{stage} P->P", m, p, p, False)     # the gate's mm row
        # the 3x3 conv, P -> P
        x, w = i8(GATE_BATCH, h, h, p), i8(3, 3, p, p)
        x_s, w_s = scales(p)
        ok, err = exact(f"int8_conv3x3 {GATE_BATCH}x{h}x{h}x{p}",
                        int8_conv3x3_cuda(x, w, x_s, w_s),
                        int8_conv3x3_plain(x, w, x_s, w_s))
        all_ok &= ok
        max_err["conv"] = max(max_err["conv"], err)
        conv = lambda: int8_conv3x3_cuda(x, w, x_s, w_s)
        ms = time_ms(torch, conv, 10, 2)
        device = graph_ms(torch, conv)
        plain = time_ms(torch, lambda: int8_conv3x3_plain(x, w, x_s, w_s), 3, 1)
        col, w2d = im2col3x3(x), w.reshape(9 * p, p)
        library = int_mm_ms(torch, col, w2d, x_s * w_s, 10)
        del col
        xc = (x.float() * 0.05).to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wc = (w.float() * 0.005).to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cudnn = time_ms(torch, lambda: F.conv2d(xc, wc, padding=1), 10, 2)
        ops = 2.0 * m * 9 * p * p
        nbytes = m * p + 9.0 * p * p + 4.0 * m * p
        lib_s = "n/a" if library is None else f"{library:.4f}"
        b_ms, b_by = bound(ops, nbytes, PEAK_I8)
        plan = plan_int8_conv3x3(GATE_BATCH, h, h, p, p)
        print(f"    kernel device {device:.5f} ms ({ops / device / 1e9:.1f} "
              f"TOP/s), eager {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch._int_mm on an int8 im2col {lib_s} ms, bf16 cuDNN "
              f"conv3x3 {cudnn:.4f} ms, bound {b_ms:.5f} ms ({b_by}), plan "
              f"{plan}")
        conv_stages.append(dict(
            stage=f"{GATE_BATCH}x{h}x{h}x{p} P={p}",
            plan=[plan.bm, plan.bn, plan.nstage], device_ms=device, ms=ms,
            tops=ops / device / 1e9, bound_ms=b_ms, bound_by=b_by,
            library_ms=library, cudnn_bf16_ms=cudnn, plain_ms=plain))
        for key, val in (("ms", ms), ("plain_ms", plain), ("ops", ops),
                         ("bytes", nbytes)):
            tot["conv"][key] += val
        library_ok["conv"] &= library is not None
        tot["conv"]["library_ms"] += library or 0.0
        del x, xc
    matmul("square", SQUARE, SQUARE, SQUARE, False, iters=5)
    torch.cuda.empty_cache()

    records = []
    for key, name, source, replaces in (
            ("mm", "int8_matmul", "tmrnet_torch/csrc/int8_matmul.cu",
             "tmrnet_tpu/ops/quant.py:66"),
            ("conv", "int8_conv3x3", "tmrnet_torch/csrc/int8_conv3x3.cu",
             "tmrnet_tpu/experimental/quant_conv.py:47")):
        t = tot[key]
        b_ms, b_by = bound(t["ops"], t["bytes"], PEAK_I8)
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max_err[key], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b_ms, bound_by=b_by,
            library_ms=t["library_ms"] if library_ok[key] else None))
    records[0].update(device_ms=sum(r["device_ms"] for r in mm_shapes
                                    if r["chain"]), shapes=mm_shapes)
    records[1].update(device_ms=sum(st["device_ms"] for st in conv_stages),
                      stages=conv_stages)
    return records, all_ok


def scale_logits(state):
    """`state` with fc_c's weights scaled by SERVE_LOGIT_SCALE where it has
    them: random weights leave the 7-class softmax near uniform, and the
    argmax rule decides no row."""
    for key in ("fc_c.weight", "fc_c.bias"):
        if key in state:
            state[key] = state[key] * SERVE_LOGIT_SCALE
    return state


def slice_setup(torch, seed, backbone="resnet50"):
    """The slices' model config (`backbone` at full width), folded seeded
    weights, bank on the card and 1 + REQUESTS host requests (the first is
    the warm-up)."""
    from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
    from tmrnet_torch.memory.lfb import FeatureBank
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    cfg = ModelConfig(backbone=backbone, head="tmr", hidden_dim=HIDDEN,
                      num_classes=CLASSES, compute_dtype="bfloat16", folded=True)
    unfolded = dataclasses.replace(cfg, compute_dtype="float32", folded=False)
    state = fold_variables(scale_logits(from_jax_variables(random_variables(
        unfolded, seed))))
    ecfg = ExperimentConfig(data=DataConfig(device_normalize=True), model=cfg,
                            memory=MemoryConfig(window=WINDOW))

    rng = np.random.default_rng(seed + 1)
    bank_np = rng.standard_normal((BANK_ROWS, HIDDEN), dtype=np.float32)
    first_rows = np.repeat(np.arange(0, BANK_ROWS, 1024), 1024).astype(np.int32)
    bank = FeatureBank(torch.from_numpy(bank_np).to("cuda", torch.bfloat16),
                       torch.from_numpy(first_rows).cuda())
    requests = []
    for _ in range(REQUESTS + 1):
        clips = rng.integers(0, 256, (CLIPS, SEQ, IMG, IMG, 3), dtype=np.uint8)
        rows = rng.integers(0, BANK_ROWS, CLIPS)
        requests.append((clips, rng.integers(0, CLASSES, CLIPS), rows, 0))
    return dict(ecfg=ecfg, state=state, bank=bank, first_rows=first_rows,
                requests=requests)


def run_slice(torch, setup, card, fused_kernel, want_per_forward, tag=None):
    """Phase 4 / 4b / 4h (a): full-width clip inference on the card through
    the `fused_kernel` path, launch counts, and the first 2 clips against
    an f32 CPU run of the same path. Returns (counts, frames/s, scores,
    ok)."""
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.memory.lfb import FeatureBank

    ecfg, state, bank = setup["ecfg"], setup["state"], setup["bank"]
    first_rows, requests = setup["first_rows"], setup["requests"]
    tag = tag or f"{fused_kernel} slice"
    engine = ClipInference(ecfg, state, bank, device="cuda",
                           fused_kernel=fused_kernel)
    engine.run_batches(requests[:1], first_rows)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = engine.run_batches(requests[1:], first_rows)
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    frames = REQUESTS * CLIPS * SEQ
    print(f"{tag}: {frames} frames in {dt:.4f} s = {frames / dt:.1f} frames/s "
          f"on {card}")
    want = {k: v * REQUESTS for k, v in want_per_forward.items()}
    print(f"{tag}: launches {counts} over {REQUESTS} forwards "
          f"(want {want})")
    ok = counts == want
    scores = res.scores
    ok &= scores.shape == (REQUESTS * CLIPS, CLASSES) and bool(np.isfinite(scores).all())

    # The first 2 clips of the first timed request on the CPU, in f32.
    cpu_cfg = ecfg.replace(model=dataclasses.replace(
        ecfg.model, compute_dtype="float32"))
    cpu_bank = FeatureBank(bank.features.float().cpu(), bank.first_rows.cpu())
    cpu_engine = ClipInference(cpu_cfg, state, cpu_bank, device="cpu",
                               fused_kernel=fused_kernel)
    clips, labels, rows, _ = requests[1]
    ref = cpu_engine.run_batches([(clips[:2], labels[:2], rows[:2], 0)],
                                 first_rows)
    err = float(np.abs(scores[:2] - ref.scores).max())
    top2 = np.sort(ref.scores, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    # A clip whose two best classes lie within twice the tolerance may
    # legitimately swap between bf16 and f32; every other argmax must agree.
    decided = margin > 2 * TOL
    agree = (bool((res.preds[:2] == ref.preds)[decided].all())
             and int(decided.sum()) >= 1)
    print(f"{tag}: card vs CPU f32 probs max_abs_err {err:.4g} (limit {TOL}), "
          f"argmax card {res.preds[:2].tolist()} cpu {ref.preds.tolist()} "
          f"(top-2 margins {margin.round(4).tolist()}, want >= 1 decided) "
          f"{'ok' if err <= TOL and agree else 'FAIL'}")
    ok &= err <= TOL and agree
    del engine
    torch.cuda.empty_cache()
    return counts, frames / dt, scores, ok


def engine_setup(seed, backbone="resnet50"):
    """The engines' config (the slices' model with `backbone`,
    device_normalize, 10-frame clips, window 30) and two independently
    seeded folded weight sets: the TMR model (head tmr) and the extractor
    (head lfb)."""
    from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.fold_bn import fold_variables

    cfg = ModelConfig(backbone=backbone, head="tmr", hidden_dim=HIDDEN,
                      num_classes=CLASSES, compute_dtype="bfloat16", folded=True)
    ecfg = ExperimentConfig(data=DataConfig(device_normalize=True,
                                            sequence_length=SEQ),
                            model=cfg, memory=MemoryConfig(window=WINDOW))
    weights = [fold_variables(scale_logits(from_jax_variables(
        random_variables(dataclasses.replace(
            cfg, head=head, compute_dtype="float32", folded=False),
            seed + k))))
        for k, head in ((0, "tmr"), (100, "lfb"))]
    return ecfg, weights


def argmax_agrees(name, preds, want_preds, want_probs, tol=TOL,
                  min_decided=0):
    """The slices' argmax rule: where the reference's two best classes lie
    more than twice the tolerance apart, the argmax must agree; and it must
    decide at least `min_decided` rows. Prints the top-2 margins."""
    top2 = np.sort(want_probs, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    decided = margin > 2 * tol
    agree = bool((preds == want_preds)[decided].all())
    agree &= int(decided.sum()) >= min_decided
    print(f"  {name}: argmax agrees on {int(decided.sum())} decided of "
          f"{len(preds)} (want >= {min_decided}; top-2 margin median "
          f"{float(np.median(margin)):.4g}, max {float(margin.max()):.4g}) "
          f"{'ok' if agree else 'FAIL'}")
    return agree


def probs_close(name, got, want, tol=TOL):
    """The slices' probability check: max |got - want| within tol."""
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {name}: max_abs_err {err:.4g} (limit {tol}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def varies(name, preds, probs):
    """Predictions that follow the frames: at least two predicted classes,
    and a softmax whose rows differ by more than TOL somewhere."""
    classes = np.unique(preds)
    spread = float(np.ptp(np.asarray(probs), axis=0).max())
    ok = len(classes) >= 2 and spread > TOL
    print(f"  {name}: predicted classes {classes.tolist()} (want >= 2), "
          f"softmax spread across rows {spread:.4g} (want > {TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def video_counts(trunk_chunks, head_calls, fused_kernel):
    """Launches of a video-engine call: the identity blocks' kernels per
    trunk chunk of each of the two trunks, #1 and #2 per head call."""
    per_trunk = ({"fused_bottleneck": 12} if fused_kernel == "block" else
                 {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2})
    want = {k: v * 2 * trunk_chunks for k, v in per_trunk.items()}
    want.update(time_conv=head_calls, nl_attention=head_calls)
    return want


def corpus_head_calls(lengths):
    """corpus_heads' head calls over videos of `lengths`: one per group of
    up to 8 videos with a clip that share a length bucket."""
    from tmrnet_torch.eval.infer import VideoInference

    groups = {}
    for n in lengths:
        if n >= SEQ:
            b = VideoInference.bucket_frames(n)
            groups[b] = groups.get(b, 0) + 1
    return sum(-(-g // 8) for g in groups.values())


def run_video_slice(torch, seed, card):
    """Phase 4c: whole videos at full width. run_video on one 1,500-frame
    video (block path) and run_corpus over videos of 1,500, 1,100 and 9
    frames (tiled path), launch counts from the chunk plan; the corpus's
    first video against run_video; bank_features against the extractor run
    clip-wise at 64 positions; ClipInference over a bank built by
    build_lfb_video against run_video at those positions; a 14-frame video
    against the engine in f32 on the CPU. Returns (counts by path, the
    block engine, ok)."""
    from tmrnet_torch.eval.infer import ClipInference, VideoInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.train.loop import build_lfb_video

    ecfg, weights = engine_setup(seed)
    rng = np.random.default_rng(seed + 3)
    lengths = VIDEO_LENGTHS
    videos = [rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
              for n in lengths]
    block = VideoInference(ecfg, *weights, fused_kernel="block")
    tiled = VideoInference(ecfg, *weights, fused_kernel="tiled")
    for engine in (block, tiled):                 # warm-up, not counted
        engine.run_corpus([videos[0][:64], videos[2]], chunk=64)
    torch.cuda.synchronize()
    counts, ok = {}, True

    chunk = block.trunk_chunk(lengths[0], (IMG, IMG))
    reset_launches()
    t0 = time.perf_counter()
    preds, probs = block.run_video(videos[0])
    dt = time.perf_counter() - t0
    counts["video"] = dict(LAUNCHES)
    want = video_counts(-(-lengths[0] // chunk), 1, "block")
    ok_n = counts["video"] == want
    print(f"video slice: run_video {lengths[0]} frames in {dt:.4f} s = "
          f"{lengths[0] / dt:.1f} frames/s, trunk chunk {chunk} (auto) on "
          f"{card}; launches {counts['video']} (want {want}) "
          f"{'ok' if ok_n else 'FAIL'}")
    k = lengths[0] - SEQ + 1
    ok &= ok_n and probs.shape == (k, CLASSES) and bool(np.isfinite(probs).all())
    # Where run_video's time goes (outside the counted run): the frames'
    # copy to the card, both trunks, both LSTMs and the head.
    t0 = time.perf_counter()
    staged = torch.from_numpy(videos[0]).to(block.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe, ft = block.corpus_features([staged])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    block.corpus_heads(fe, ft, [lengths[0]])
    t3 = time.perf_counter()
    print(f"video slice: run_video split: copy to the card "
          f"{(t1 - t0) * 1e3:.1f} ms, both trunks {(t2 - t1) * 1e3:.1f} ms, "
          f"LSTMs + head + copy back {(t3 - t2) * 1e3:.1f} ms")
    del staged, fe, ft

    total = sum(lengths)
    corpus_chunk = min(2048, total)               # run_corpus's own cut
    blocks = -(-total // corpus_chunk)
    per_block = -(-corpus_chunk // tiled.trunk_chunk(corpus_chunk, (IMG, IMG)))
    head_calls = corpus_head_calls(lengths)
    reset_launches()
    t0 = time.perf_counter()
    corpus = tiled.run_corpus(videos, chunk=corpus_chunk)
    dt = time.perf_counter() - t0
    counts["corpus"] = dict(LAUNCHES)
    want = video_counts(blocks * per_block, head_calls, "tiled")
    ok_n = counts["corpus"] == want
    print(f"video slice: run_corpus {lengths} ({total} frames, {blocks} "
          f"blocks of {corpus_chunk}) in {dt:.4f} s = {total / dt:.1f} "
          f"frames/s on {card}; launches {counts['corpus']} (want {want}) "
          f"{'ok' if ok_n else 'FAIL'}")
    ok &= ok_n
    short = corpus[2][0].shape == (0,) and corpus[2][1].shape == (0, CLASSES)
    print(f"  the {lengths[2]}-frame video gives empty outputs "
          f"{'ok' if short else 'FAIL'}")
    ok &= short and all(c[1].shape == (n - SEQ + 1, CLASSES)
                        for c, n in zip(corpus[:2], lengths))
    ok &= probs_close("run_corpus (tiled) vs run_video (block), video 0 probs",
                corpus[0][1], probs)
    ok &= argmax_agrees("run_corpus vs run_video", corpus[0][0], preds, probs,
                        min_decided=1)

    positions = np.unique(np.concatenate([[0, 1, k - 1], rng.choice(
        np.arange(2, k - 1), min(61, k - 3), replace=False)]))
    clips = np.stack([videos[0][p:p + SEQ] for p in positions])
    feats = block.bank_features(videos[0])
    with torch.inference_mode():
        clipwise = block.extractor(block.prep(
            torch.from_numpy(clips).to(block.device)))
    ok &= compare(torch, f"bank_features vs LFBExtractor clip-wise at "
                  f"{len(positions)} positions",
                  feats[torch.from_numpy(positions).to(block.device)],
                  clipwise)[1]
    bank = build_lfb_video(ecfg, weights[1], videos[:1], fused_kernel="block")
    clip_engine = ClipInference(ecfg, weights[0], bank, fused_kernel="block")
    res = clip_engine.run_batches(
        [(clips, np.zeros(len(positions)), positions, 0)], bank.first_rows)
    ok &= probs_close("ClipInference over build_lfb_video's bank vs run_video",
                res.scores, probs[positions])
    ok &= argmax_agrees("ClipInference vs run_video", res.preds,
                        preds[positions], probs[positions], min_decided=1)

    cpu_cfg = ecfg.replace(model=dataclasses.replace(ecfg.model,
                                                     compute_dtype="float32"))
    cpu = VideoInference(cpu_cfg, *weights, device="cpu")
    p_cpu, pr_cpu = cpu.run_video(videos[0][:14])
    p_card, pr_card = block.run_video(videos[0][:14])
    ok &= probs_close("14-frame video, card vs CPU f32", pr_card, pr_cpu)
    ok &= argmax_agrees("card vs CPU f32", p_card, p_cpu, pr_cpu,
                        min_decided=1)
    del tiled, clip_engine, bank, videos
    torch.cuda.empty_cache()
    return counts, block, ok


def run_stream_slice(torch, seed, card, video_engine, backbone="resnet50",
                     per_step=None, tag="stream slice"):
    """Phase 4d / 4h (b): 16 streams, 48 steps of uint8 224x224 frames
    through `backbone`; stream 3 inactive at steps 20-24, stream 5 reset
    at step 30. Each stream's valid outputs against run_video over the
    frames it took (split at the reset), inactive slots frozen bit for
    bit, launches per step (`per_step`, default the ResNet path's); step
    p50 / p99 ms and stream-frames/s. Returns (counts, ok)."""
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    streams, steps, warm = STREAMS, STREAM_STEPS, 4
    inactive, reset = (3, range(20, 25)), (5, 30)
    ecfg, weights = engine_setup(seed, backbone)
    frames = np.random.default_rng(seed + 4).integers(
        0, 256, (steps, streams, IMG, IMG, 3), dtype=np.uint8)
    engine = StreamingInference(ecfg, *weights, fused_kernel="block")
    state = engine.init_state(streams)
    lives = [[[]] for _ in range(streams)]        # frames taken, per life
    outs = [[[]] for _ in range(streams)]         # valid probs, per life
    per_step = per_step or {"fused_bottleneck": 24, "time_conv": 1,
                            "nl_attention": 1}
    ok, times, taken = True, [], 0
    torch.cuda.synchronize()
    reset_launches()
    for t in range(steps):
        if t == reset[1]:
            state = engine.reset_streams(state, np.arange(streams) == reset[0])
            lives[reset[0]].append([])
            outs[reset[0]].append([])
        active = np.ones(streams, bool)
        if t in inactive[1]:
            active[inactive[0]] = False
        before = dict(LAUNCHES)
        old = state
        t0 = time.perf_counter()
        state, preds, probs, valid = engine.step(
            state, frames[t], None if active.all() else active)
        probs, valid = probs.cpu().numpy(), valid.cpu().numpy()
        dt = time.perf_counter() - t0
        if t >= warm:
            times.append(dt)
            taken += int(active.sum())
        step_counts = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()}
        ok &= step_counts == per_step
        for s in np.flatnonzero(~active):
            ok &= not valid[s] and all(bool(torch.equal(a[s], b[s])) for a, b in (
                (state.ext_ring, old.ext_ring), (state.tmr_ring, old.tmr_ring),
                (state.bank_ring, old.bank_ring), (state.count, old.count)))
        for s in np.flatnonzero(active):
            lives[s][-1].append(frames[t, s])
            ok &= bool(valid[s]) == (len(lives[s][-1]) >= SEQ)
            if valid[s]:
                outs[s][-1].append(probs[s])
    counts = dict(LAUNCHES)
    want = {k: v * steps for k, v in per_step.items()}
    ok &= counts == want
    ms = np.array(times) * 1e3
    print(f"{tag}: {streams} streams x {steps} steps, launches {counts} "
          f"(want {want}, each step {per_step}); inactive slots frozen; "
          f"{'ok' if ok else 'FAIL'}")
    print(f"{tag}: step p50 {np.percentile(ms, 50):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms over {len(ms)} steps after {warm} "
          f"warm-up, {taken / sum(times):.1f} stream-frames/s on {card}")
    flat = [(np.stack(f), o) for s in range(streams)
            for f, o in zip(lives[s], outs[s])]
    offline = video_engine.run_videos([f for f, _ in flat])
    for (f, o), (_, want_probs) in zip(flat, offline):
        ok &= len(o) == len(want_probs) == len(f) - SEQ + 1
    ok &= probs_close(f"{len(flat)} stream lives vs run_video on the frames each "
                f"took", np.concatenate([np.stack(o) for _, o in flat if o]),
                np.concatenate([w for _, w in offline]))
    del engine, state, frames
    torch.cuda.empty_cache()
    return counts, ok


class Client:
    """One JSONL connection to a serving daemon."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.f = self.sock.makefile("r")

    def send(self, *objs):
        self.sock.sendall("".join(json.dumps(o) + "\n" for o in objs).encode())

    def recv(self):
        line = self.f.readline()
        if not line:
            raise RuntimeError("connection closed while expecting a row")
        return json.loads(line)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:             # the daemon closed it first
            pass
        self.f.close()
        self.sock.close()


def full_width_config(folded=True, backbone="resnet50"):
    """The full-width config of phases 4e, 4f and 4h: ResNet-50 (or
    `backbone`), hidden 512, window 30, 7 classes, bf16, device_normalize,
    test crop 1, 10-frame clips; BN folded at load where `folded`."""
    from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig

    model = ModelConfig(backbone=backbone, head="tmr", hidden_dim=HIDDEN,
                        num_classes=CLASSES, compute_dtype="bfloat16",
                        folded=folded)
    return ExperimentConfig(
        data=DataConfig(device_normalize=True, test_crop_type=1,
                        sequence_length=SEQ),
        model=model, memory=MemoryConfig(window=WINDOW))


def reference_states(seed, cfg, calibrate=False):
    """Two seeded unfolded weight sets of `cfg.model`: the TMR model (head
    tmr, fc_c scaled by SERVE_LOGIT_SCALE, so that the 7-class softmax
    spreads, and under `calibrate` its bias shifted by `calibrate_phases`)
    and the extractor (head lfb), by head."""
    from tmrnet_torch.models.convert import from_jax_variables, random_variables

    states = {}
    for k, head in ((200, "tmr"), (300, "lfb")):
        states[head] = scale_logits(from_jax_variables(random_variables(
            dataclasses.replace(cfg.model, head=head, compute_dtype="float32",
                                folded=False), seed + k)))
    if calibrate:
        calibrate_phases(cfg, states, seed)
    return states


def calibrate_phases(cfg, states, seed):
    """Shift fc_c's bias of the TMR weights in `states`, in place, so that
    every class has the same mean log-softmax over a calibration video:
    CALIB_FRAMES frames of each of PHASE_COLOURS under a quarter of noise
    (another seed than the test videos'), through VideoInference on the
    card (bf16, folded). Seeded weights give every clip the same argmax
    otherwise: the frames move the softmax (by ~0.1) less than the
    classes' fixed offsets."""
    import torch

    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.models.fold_bn import fold_variables

    rng = np.random.default_rng(seed + 9)
    colours = np.asarray(PHASE_COLOURS, np.float32)
    phases = np.repeat(np.arange(len(PHASE_COLOURS)), CALIB_FRAMES)
    noise = rng.integers(0, 256, (len(phases), IMG, IMG, 3), dtype=np.uint8)
    video = (0.75 * colours[phases][:, None, None, :]
             + 0.25 * noise).astype(np.uint8)
    engine = VideoInference(
        cfg.replace(model=dataclasses.replace(cfg.model, folded=True)),
        fold_variables(states["tmr"]), fold_variables(states["lfb"]))
    _, probs = engine.run_video(video)
    shift = np.log(np.maximum(probs, 1e-30)).mean(axis=0)
    states["tmr"]["fc_c.bias"] = (states["tmr"]["fc_c.bias"]
                                  - torch.from_numpy(shift.astype(np.float32)))
    del engine


def write_reference_weights(seed, tmp, cfg, calibrate=False):
    """`reference_states` written as reference `.pth` files by the port's
    export, and the config JSON. Returns their paths."""
    import torch

    from tmrnet_torch.models.torch_import import export_reference_checkpoint

    paths = {}
    for head, state in reference_states(seed, cfg, calibrate).items():
        paths[head] = os.path.join(tmp, f"{head}.pth")
        torch.save(export_reference_checkpoint(state, head,
                                               cfg.model.stage_sizes),
                   paths[head])
    paths["config"] = os.path.join(tmp, "cfg.json")
    with open(paths["config"], "w") as f:
        f.write(cfg.to_json())
    return paths


def serve_setup(seed, tmp):
    """Phase 4e's config, its two seeded weight sets written as reference
    `.pth` files (`write_reference_weights`), the config JSON, and
    SERVE_VIDEOS packed videos of SERVE_FRAMES 250x250 uint8 frames."""
    cfg = full_width_config()
    paths = write_reference_weights(seed, tmp, cfg)
    rng = np.random.default_rng(seed + 7)
    videos = []
    for i in range(SERVE_VIDEOS):
        videos.append(rng.integers(0, 256, (SERVE_FRAMES, 250, 250, 3),
                                   dtype=np.uint8))
        np.save(os.path.join(tmp, f"v{i}.npy"), videos[-1])
    return cfg, paths, videos


def serve_engines(cfg, paths):
    """StreamingInference and VideoInference on the card from the `.pth`
    files, read back only through the port's import and folded, as
    `python -m tmrnet_torch serve` does."""
    from tmrnet_torch import cli
    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.models.fold_bn import fold_variables

    state = cli.restore_state(cfg, "tmr", paths["tmr"])
    ext = cli.extractor_state(cfg, state, paths["lfb"])
    state, ext = fold_variables(state), fold_variables(ext)
    return (StreamingInference(cfg, state, ext, fused_kernel="block"),
            VideoInference(cfg, state, ext, fused_kernel="block"))


# Phase 4e, part A: stream -> (client, video, ticks it sends a frame in).
# A ends at tick 14 and E takes its slot; B sends nothing at ticks 8-10; E
# first finds the 4 slots full (tick 4); client 2 disconnects at tick 20
# with C's frame pending, and F takes a freed slot.
SERVE_TICKS = 34
SERVE_PLAN = {
    "A": (1, 0, range(0, 14)),
    "B": (1, 1, [t for t in range(2, SERVE_TICKS) if t not in (8, 9, 10)]),
    "C": (2, 2, range(0, 20)),
    "D": (2, 3, range(3, 20)),
    "E": (1, 4, range(14, SERVE_TICKS)),
    "F": (1, 5, range(20, SERVE_TICKS)),
}
SERVE_DISCONNECT, SERVE_FULL, SERVE_END = 20, 4, 14


def serve_part_a(torch, cfg, tmp, videos, engine, video_engine):
    """Phase 4e, part A: serve_loop (probabilities on) over a
    JsonlTcpServer in a thread, SERVE_SLOTS slots, two clients, the plan
    above. Each
    tick client 2 sends its frames and a probe ({"id": "sync", "end":
    true}) whose error row says its lines were taken; client 1 then sends
    its lines and the step. Checks every row against the plan (frame
    numbers continue over a frozen stream), the error rows, each stream
    life's probabilities against run_video over the frames it took, and
    24 + 1 + 1 launches on every tick (the warm-up's too), none in a slot
    reset. Returns (counts, summary, ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.data.transforms import EvalTransform
    from tmrnet_torch.eval.serve import serve_loop
    from tmrnet_torch.eval.serve_net import JsonlTcpServer
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    ticks, resets = [], []
    step, reset = engine.step, engine.reset_streams

    def counted(fn, log):
        def call(*a, **kw):
            before = dict(LAUNCHES)
            out = fn(*a, **kw)
            log.append({k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                        if v != before.get(k, 0)})
            return out
        return call

    engine.step, engine.reset_streams = counted(step, ticks), counted(reset, resets)
    server = JsonlTcpServer("127.0.0.1", 0)
    res = {}

    def go():
        res["summary"] = serve_loop(
            engine, SERVE_SLOTS, server.lines(), server, cli.frame_loader(cfg),
            emit_probs=True, warmup_shape=(224, 224, 3),
            warmup_dtype=np.uint8)

    torch.cuda.synchronize()
    reset_launches()
    th = threading.Thread(target=go, name="serve-loop")
    th.start()
    ok, errors, sent, rows = True, [], {k: 0 for k in SERVE_PLAN}, {}
    clients = {1: Client(server.port), 2: Client(server.port)}

    def frame(sid):
        client, video, _ = SERVE_PLAN[sid]
        path = os.path.join(tmp, f"v{video}.npy#{sent[sid]}")
        sent[sid] += 1
        return {"id": sid, "image": path}

    def expect_error(c, sid, text):
        nonlocal ok
        row = c.recv()
        errors.append(row)
        good = row == {"id": sid, "error": text}
        ok &= good
        if not good:
            print(f"  unexpected row {row}, want error {text!r} for {sid}")
        return row

    def take(c, sids):
        nonlocal ok
        for sid in sorted(sids):
            row = c.recv()
            t = len(rows.setdefault(sid, []))
            want = {"id": sid, "frame": t, "valid": t >= SEQ - 1}
            good = {k: row.get(k) for k in want} == want and \
                (row["pred"] is None) == (not want["valid"])
            if not good:
                print(f"  unexpected row {row}, want {want}")
            ok &= good
            rows[sid].append(row)

    try:
        for t in range(SERVE_TICKS):
            live = {c: [s for s, (cl, _, ts) in SERVE_PLAN.items()
                        if cl == c and t in ts] for c in (1, 2)}
            if t < SERVE_DISCONNECT:
                clients[2].send(*[frame(s) for s in live[2]],
                                {"id": "sync", "end": True})
                expect_error(clients[2], "sync", "unknown stream")
            elif t == SERVE_DISCONNECT:
                clients[2].send(frame("C"))          # left pending
                clients[2].close()
                deadline = time.monotonic() + 60
                while True:                          # the disconnect lands
                    clients[1].send({"id": "C", "end": True})
                    row = clients[1].recv()
                    errors.append(row)
                    if row == {"id": "C", "error": "unknown stream"}:
                        break
                    ok &= row == {"id": "C",
                                  "error": "stream owned by another client"}
                    if time.monotonic() > deadline:
                        raise RuntimeError("the disconnect never landed")
                    time.sleep(0.02)
            c1 = []
            if t == SERVE_FULL:
                c1.append({"id": "E", "image": "unused"})
            if t == SERVE_END:
                c1.append({"id": "A", "end": True})
            clients[1].send(*c1, *[frame(s) for s in live[1]], {"step": True})
            if t == SERVE_FULL:
                expect_error(clients[1], "E", "no free slot")
            take(clients[1], live[1])
            if t < SERVE_DISCONNECT:
                take(clients[2], live[2])
    finally:
        server.stop()
        th.join(timeout=120)
        clients[1].close()
        engine.step, engine.reset_streams = step, reset
    counts = dict(LAUNCHES)
    summary = res["summary"]
    per_tick = {"fused_bottleneck": 24, "time_conv": 1, "nl_attention": 1}
    ok_n = (len(ticks) == SERVE_TICKS + 1 and all(c == per_tick for c in ticks)
            and len(resets) > 0 and all(not c for c in resets))
    n_rows = sum(len(r) for r in rows.values())
    print(f"serve slice A: {SERVE_TICKS} ticks + warm-up, {n_rows} rows, "
          f"{len(errors)} error rows ({sum('sync' == e['id'] for e in errors)} "
          f"probes, the rest provoked); launches {counts} ({len(ticks)} steps "
          f"each {per_tick}, {len(resets)} slot resets with none) "
          f"{'ok' if ok and ok_n else 'FAIL'}")
    ok &= ok_n and summary["rows"] == n_rows and summary["ticks"] == SERVE_TICKS
    ok &= sorted(rows) == sorted(SERVE_PLAN) and all(
        len(rows[s]) == len(SERVE_PLAN[s][2]) for s in SERVE_PLAN)
    # each life against run_video over the frames it took, cropped as served
    crop = EvalTransform(normalize=False)
    lives = [crop(videos[SERVE_PLAN[s][1]][:len(rows[s])]) for s in sorted(rows)]
    offline = video_engine.run_videos(lives)
    got = np.concatenate([[r["probs"] for r in rows[s] if r["valid"]]
                          for s in sorted(rows)])
    preds = np.concatenate([[r["pred"] for r in rows[s] if r["valid"]]
                            for s in sorted(rows)])
    want_p = np.concatenate([p for p, _ in offline])
    want = np.concatenate([w for _, w in offline])
    ok &= probs_close(f"{len(lives)} served lives vs run_video", got, want)
    ok &= argmax_agrees("served lives vs run_video", preds, want_p, want,
                        min_decided=1)
    print(f"serve slice A: latency_ms {summary['latency_ms']}, step_ms "
          f"{summary['step_ms']}")
    return counts, summary, ok


def serve_daemon(cmd, ticks, frame):
    """`cmd` (a `serve --listen 127.0.0.1:0` daemon) as a subprocess:
    once it prints {"ready": true}, streams P and Q send `frame(sid, t)`
    and a step at each of `ticks`, then SIGTERM. Returns (the rows, its
    exit code, seconds to ready)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()

    def read():
        for line in proc.stderr:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    port, startup, rows = None, None, []
    try:
        while startup is None:
            line = lines.get(timeout=SERVE_READY_TIMEOUT)
            if line is None:
                raise RuntimeError(f"the daemon exited before it was "
                                   f"ready: {proc.wait()}")
            if line.startswith("{"):
                obj = json.loads(line)
                port = obj.get("listening", {}).get("port", port)
                if obj.get("ready"):
                    startup = time.perf_counter() - t0
            else:
                print(f"  daemon: {line.rstrip()}")
        c = Client(port)
        for t in ticks:
            c.send(frame("P", t), frame("Q", t), {"step": True})
            rows += [c.recv(), c.recv()]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        c.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rows, rc, startup


def serve_part_b(cfg, paths, tmp, engine):
    """Phase 4e, part B: `python -m tmrnet_torch serve` as a subprocess,
    2 streams for 12 ticks over TCP, SIGTERM (exit 0, state.npz left), a
    restart on the same state directory and 8 more ticks. The rows go on
    from frame 12 and equal an uninterrupted in-process run within
    RESUME_TOL. Returns
    (startup seconds to ready, ok)."""
    import io

    from tmrnet_torch import cli
    from tmrnet_torch.eval.serve import serve_loop

    state_dir = os.path.join(tmp, "state")
    cmd = [sys.executable, "-m", "tmrnet_torch", "serve",
           "--torch-ckpt", paths["tmr"], "--extractor-torch-ckpt",
           paths["lfb"], "--config", paths["config"], "--slots", str(SERVE_SLOTS),
           "--listen", "127.0.0.1:0", "--state-dir", state_dir,
           "--checkpoint-every", "4", "--probs"]
    frame = lambda sid, t: {"id": sid, "image": os.path.join(
        tmp, f"v{'PQ'.index(sid)}.npy#{t}")}

    rows1, rc1, start1 = serve_daemon(cmd, range(12), frame)
    saved = os.path.exists(os.path.join(state_dir, "state.npz"))
    rows2, rc2, start2 = serve_daemon(cmd, range(12, 20), frame)
    print(f"serve slice B: daemon exit codes {rc1}, {rc2} (want 0), "
          f"state.npz left {saved}; startup to ready {start1:.2f} s and "
          f"{start2:.2f} s (restart)")
    ok = rc1 == 0 and rc2 == 0 and saved
    text = "".join(json.dumps(o) + "\n" for t in range(20) for o in
                   (frame("P", t), frame("Q", t), {"step": True}))
    out = io.StringIO()
    serve_loop(engine, SERVE_SLOTS, io.StringIO(text), out, cli.frame_loader(cfg),
               emit_probs=True)
    want = [json.loads(l) for l in out.getvalue().splitlines()]
    got = rows1 + rows2
    same = [{k: r.get(k) for k in ("id", "frame", "valid")} for r in got] == \
        [{k: r[k] for k in ("id", "frame", "valid")} for r in want]
    print(f"  resumed rows continue at frame "
          f"{[r.get('frame') for r in rows2[:2]]}, ids/frames/valid equal to "
          f"an uninterrupted run {'ok' if same else 'FAIL'}")
    ok &= same and len(got) == len(want) == 40
    if ok:
        valid = [(g, w) for g, w in zip(got, want) if w["valid"]]
        ok &= probs_close("daemon (restarted) vs in-process rows",
                          [g["probs"] for g, _ in valid],
                          np.array([w["probs"] for _, w in valid]),
                          RESUME_TOL)
        ok &= argmax_agrees("daemon vs in-process", np.array(
            [g["pred"] for g, _ in valid]), np.array(
            [w["pred"] for _, w in valid]), np.array(
            [w["probs"] for _, w in valid]), RESUME_TOL, min_decided=1)
    return (start1, start2), ok


def run_serve_slice(torch, seed, card):
    """Phase 4e: the serving slice at full width (parts A and B). Returns
    (counts of part A, ok)."""
    os.makedirs(ROOT_TMP, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="serve-", dir=ROOT_TMP) as tmp:
        t0 = time.perf_counter()
        cfg, paths, videos = serve_setup(seed, tmp)
        engine, video_engine = serve_engines(cfg, paths)
        print(f"serve slice: weights written and read back as reference "
              f".pth ({os.path.getsize(paths['tmr']) / 1e6:.1f} + "
              f"{os.path.getsize(paths['lfb']) / 1e6:.1f} MB), "
              f"{SERVE_VIDEOS} packed videos, engines built in "
              f"{time.perf_counter() - t0:.2f} s")
        counts, summary, ok_a = serve_part_a(torch, cfg, tmp, videos, engine,
                                             video_engine)
        del video_engine
        torch.cuda.empty_cache()
        _, ok_b = serve_part_b(cfg, paths, tmp, engine)
        print(f"serve slice: on {card} {'ok' if ok_a and ok_b else 'FAIL'}")
        del engine
        torch.cuda.empty_cache()
    return counts, ok_a and ok_b


class LoaderClock:
    """Host clock around every next() of `ClipLoader.epoch` while inside:
    the time the consumer is blocked on the loader."""

    def __enter__(self):
        from tmrnet_torch.data.pipeline import ClipLoader

        self.seconds, self.batches = 0.0, 0
        self.orig = orig = ClipLoader.epoch

        def epoch(loader, e=0):
            it = orig(loader, e)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    finally:
                        self.seconds += time.perf_counter() - t0
                    self.batches += 1
                    yield batch
            finally:
                it.close()

        ClipLoader.epoch = epoch
        return self

    def __exit__(self, *exc):
        from tmrnet_torch.data.pipeline import ClipLoader

        ClipLoader.epoch = self.orig


def write_test_videos(seed, tmp):
    """Phase 4f's frames: TEST_LENGTHS packed uint8 250x250 videos under
    tmp/frames and their phase annotations (`<video>-phase.txt`, a row
    every 25 source frames, the phase changing every 40) under tmp/ann.
    A frame is its phase's colour of PHASE_COLOURS with a quarter of
    seeded noise over it, so that what a model sees follows the phase."""
    from tmrnet_torch.config import CHOLEC80_PHASES

    rng = np.random.default_rng(seed + 8)
    os.makedirs(os.path.join(tmp, "frames"))
    os.makedirs(os.path.join(tmp, "ann"))
    colours = np.asarray(PHASE_COLOURS, np.float32)
    for v, n in enumerate(TEST_LENGTHS):
        vid = f"video{v + 1:02d}"
        phases = (np.arange(n) // 40 + v) % 7
        noise = rng.integers(0, 256, (n, 250, 250, 3), dtype=np.uint8)
        frames = 0.75 * colours[phases][:, None, None, :] + 0.25 * noise
        np.save(os.path.join(tmp, "frames", f"{vid}.npy"),
                frames.astype(np.uint8))
        with open(os.path.join(tmp, "ann", f"{vid}-phase.txt"), "w") as f:
            f.write("Frame\tPhase\n")
            for k in range(n):
                f.write(f"{25 * k}\t{CHOLEC80_PHASES[phases[k]]}\n")


def run_cli(argv):
    """`tmrnet_torch.cli.main(argv)` in this process, its stdout captured
    and echoed; returns (stdout lines, launches by kernel, seconds)."""
    import contextlib
    import io

    import torch

    from tmrnet_torch import cli
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"    {line}")
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    return lines, dict(LAUNCHES), dt


def phase_dir(prefix, kept=None):
    """A phase's scratch directory under build/: removed when the phase
    ends, or, where `kept` (a dict) is given, made under kept["root"],
    recorded as kept[prefix] and left for phase 4i."""
    if kept is None:
        return tempfile.TemporaryDirectory(prefix=prefix + "-", dir=ROOT_TMP)
    kept[prefix] = tempfile.mkdtemp(prefix=prefix + "-", dir=kept["root"])
    return contextlib.nullcontext(kept[prefix])


def run_test_slice(torch, seed, card, kept=None):
    """Phase 4f: `manifest`, `build-lfb` (clip and video engines) and
    `test` (clip engine over the clip bank, video and corpus engines)
    through `tmrnet_torch.cli.main` at full width (BN folded by --set),
    then `python -m tmrnet_torch test` as a subprocess. Checks the launch
    counts, the banks against each other, the engines' softmax against
    each other, 8 clips against the CPU in f32, the tiled build against
    the block build and each accuracy against the predictions; prints
    clips/s, frames/s and the loader's share. Returns (counts by path,
    ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.eval.infer import ClipInference, plan_trunk_chunk
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.memory.lfb import load_bank
    from tmrnet_torch.models.resnet import ResNet
    from tmrnet_torch.train.loop import build_lfb

    os.makedirs(ROOT_TMP, exist_ok=True)
    counts, ok = {}, True
    clips = sum(max(0, n - SEQ + 1) for n in TEST_LENGTHS)
    with_clips = [n for n in TEST_LENGTHS if n >= SEQ]
    # The video engines' trunk chunk, as plan_trunk_chunk gives it now.
    free, _ = torch.cuda.mem_get_info()
    chunk = plan_trunk_chunk(
        ResNet((3, 4, 6, 3), 64).activation_elements(IMG, IMG), 2,
        free + torch.cuda.memory_reserved() - torch.cuda.memory_allocated())
    corpus_heads = corpus_head_calls(TEST_LENGTHS)
    corpus_chunk = min(4096, sum(TEST_LENGTHS))
    want = {
        "lfb-clip": {"fused_bottleneck": 12 * -(-clips // LFB_BATCH)},
        "lfb-video": {"fused_bottleneck": 12 * sum(-(-n // chunk)
                                                   for n in with_clips)},
        "test-clip": {k: v * -(-clips // TEST_BATCH) for k, v in
                      {"fused_bottleneck": 12, "time_conv": 1,
                       "nl_attention": 1}.items()},
        "test-video": video_counts(sum(-(-n // chunk) for n in TEST_LENGTHS),
                                   len(with_clips), "block"),
        "test-corpus": video_counts(
            -(-sum(TEST_LENGTHS) // corpus_chunk) * -(-corpus_chunk // chunk),
            corpus_heads, "block"),
        "lfb-tiled": {k: v * sum(-(-n // chunk) for n in with_clips)
                      for k, v in (("fused_bottleneck_tiled", 10),
                                   ("fused_bottleneck", 2))},
    }
    with phase_dir("test", kept) as tmp:
        t0 = time.perf_counter()
        cfg = full_width_config(folded=False)
        paths = write_reference_weights(seed + 1000, tmp, cfg,
                                        calibrate=True)
        write_test_videos(seed, tmp)
        print(f"test slice: {len(TEST_LENGTHS)} packed videos of "
              f"{TEST_LENGTHS} 250x250 frames ({clips} clip positions) and "
              f"two reference .pth written in {time.perf_counter() - t0:.2f} "
              f"s; trunk chunk {chunk}")
        m = os.path.join(tmp, "m.pkl")
        common = ["--config", paths["config"], "--set", "model.folded=true",
                  "--manifest", m]
        out = lambda name: os.path.join(tmp, name)
        run_cli(["manifest", "--config", paths["config"], "--frames",
                 out("frames"), "--annotations", out("ann"), "--out", m])

        rates = {}
        for engine, frames in (("clip", SEQ * clips), ("video", clips)):
            with LoaderClock() as clock:
                _, counts[f"lfb-{engine}"], dt = run_cli(
                    ["build-lfb", *common, "--torch-ckpt", paths["lfb"],
                     "--engine", engine, "--out", out(f"bank_{engine}.npz")])
            share = f", loader share {clock.seconds / dt:.4f} " \
                f"({clock.seconds:.3f} s over {clock.batches} batches)" \
                if clock.batches else ""
            rates[f"build-lfb {engine}"] = frames / dt
            print(f"test slice: build-lfb --engine {engine}: {frames} frames "
                  f"in {dt:.3f} s = {frames / dt:.1f} frames/s{share} on "
                  f"{card}")
        summaries, scores, preds = {}, {}, {}
        for engine in ("clip", "video", "corpus"):
            extra = (["--lfb", out("bank_clip.npz")] if engine == "clip"
                     else [])
            with LoaderClock() as clock:
                lines, counts[f"test-{engine}"], dt = run_cli(
                    ["test", *common, "--torch-ckpt", paths["tmr"],
                     "--extractor-torch-ckpt", paths["lfb"], "--engine",
                     engine, *extra, "--out", out(f"{engine}.npz")])
            summaries[engine] = json.loads(lines[-1])
            with np.load(out(f"{engine}.npz")) as z:
                scores[engine], preds[engine] = z["scores"], z["preds"]
            share = f", loader share {clock.seconds / dt:.4f} " \
                f"({clock.seconds:.3f} s over {clock.batches} batches)" \
                if clock.batches else ""
            rates[f"test {engine}"] = clips / dt
            print(f"test slice: test --engine {engine}: {clips} clips in "
                  f"{dt:.3f} s = {clips / dt:.1f} clips/s{share} on {card}")
        for path, got in counts.items():
            good = got == want[path]
            print(f"  {path}: launches {got} (want {want[path]}) "
                  f"{'ok' if good else 'FAIL'}")
            ok &= good

        banks = {e: load_bank(out(f"bank_{e}.npz")) for e in ("clip", "video")}
        ok &= compare(torch, "bank, video engine vs clip engine",
                      banks["video"].features, banks["clip"].features)[1]
        labels = cli.clip_labels(cli.load_manifest(m), SEQ)
        for engine in scores:
            good = (scores[engine].shape == (clips, CLASSES)
                    and bool(np.isfinite(scores[engine]).all())
                    and summaries[engine]["num_clips"] == clips
                    and summaries[engine]["clip_accuracy"]
                    == float((preds[engine] == labels).mean()))
            print(f"  {engine}: clip accuracy "
                  f"{summaries[engine]['clip_accuracy']:.4f} equal to the "
                  f"mean of preds == labels {'ok' if good else 'FAIL'}")
            ok &= good and varies(f"test {engine}", preds[engine],
                                  scores[engine])
        for a, b in (("video", "clip"), ("corpus", "clip"),
                     ("corpus", "video")):
            ok &= probs_close(f"test {a} vs {b} softmax", scores[a], scores[b])
            ok &= argmax_agrees(f"test {a} vs {b}", preds[a], preds[b],
                                scores[b], min_decided=1)

        # 8 clips of the clip engine in f32 on the CPU, over the same bank
        cpu_cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="float32", folded=True))
        state, = cli.folded_weights(cpu_cfg, cli.restore_state(
            cfg, "tmr", paths["tmr"]))
        ds = cli.dataset(cfg, cli.load_manifest(m))
        # 8 rows: the first two, the last, each video's first and the row
        # before it, and the second video's second
        starts = np.cumsum([0] + [n - SEQ + 1 for n in with_clips])[1:-1]
        rows = np.array(sorted({0, 1, clips - 1, starts[0] + 1, *starts,
                                *(starts - 1)}))
        batch = np.stack([ds.get_clip(int(r))[0] for r in rows])
        cpu = ClipInference(cpu_cfg, state, load_bank(
            out("bank_clip.npz"), device="cpu"), device="cpu").run_batches(
            [(batch, labels[rows], rows, 0)], ds.first_rows)
        ok &= probs_close(f"test clip engine vs CPU f32 at rows "
                          f"{rows.tolist()}", scores["clip"][rows], cpu.scores)
        ok &= argmax_agrees("clip engine vs CPU f32", preds["clip"][rows],
                            cpu.preds, cpu.scores)
        del state

        # the tiled build against the block build (video engine)
        fold_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                         folded=True))
        ext, = cli.folded_weights(fold_cfg, cli.extractor_state(
            cfg, cli.restore_state(cfg, "lfb", paths["lfb"]), None))
        torch.cuda.synchronize()
        reset_launches()
        tiled = build_lfb(fold_cfg, ext, ds, cache_path=out("tiled.npz"),
                          force=True, engine="video", fused_kernel="tiled")
        counts["lfb-tiled"] = dict(LAUNCHES)
        good = counts["lfb-tiled"] == want["lfb-tiled"]
        print(f"  lfb-tiled: launches {counts['lfb-tiled']} (want "
              f"{want['lfb-tiled']}) {'ok' if good else 'FAIL'}")
        ok &= good and compare(torch, "bank, tiled vs block (video engine)",
                               tiled.features, banks["video"].features)[1]
        del tiled, ext, banks

        # the entry point, as a user runs it
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tmrnet_torch", "test", *common,
             "--torch-ckpt", paths["tmr"], "--extractor-torch-ckpt",
             paths["lfb"], "--out", out("sub.npz"), "--ref-pickle",
             out("sub.pkl")], cwd=ROOT, capture_output=True, text=True,
            timeout=TEST_TIMEOUT)
        dt = time.perf_counter() - t0
        good = proc.returncode == 0
        if good:
            summary = json.loads(proc.stdout.strip().splitlines()[-1])
            with np.load(out("sub.npz")) as z:
                good = (np.array_equal(z["preds"], preds["corpus"])
                        and summary == dict(summaries["corpus"],
                                            out=out("sub.npz"))
                        and os.path.exists(out("sub.pkl.score.pkl")))
                err = float(np.abs(z["scores"] - scores["corpus"]).max())
            good &= err <= RESUME_TOL
            print(f"  python -m tmrnet_torch test (corpus, the default) as a "
                  f"subprocess: exit 0 in {dt:.2f} s, predictions equal to "
                  f"the in-process run, softmax max_abs_err {err:.3g} "
                  f"(limit {RESUME_TOL}) {'ok' if good else 'FAIL'}")
        else:
            print(f"  python -m tmrnet_torch test exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]} FAIL")
        ok &= good
    print(f"test slice: rates {json.dumps(rates)} on {card} "
          f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return counts, ok


def train_model_config(head, device, dtype=None, backbone="resnet50",
                       remat=False):
    """The full-width model of the training slice: ResNet-50 (or
    `backbone`), bf16 on the card, f32 on the CPU unless `dtype` says
    otherwise, unfolded, dropout 0, each bottleneck recomputed in the
    backward pass under `remat`."""
    from tmrnet_torch.config import ModelConfig

    return ModelConfig(backbone=backbone, head=head, hidden_dim=HIDDEN,
                       num_classes=CLASSES, folded=False, remat=remat,
                       compute_dtype=dtype or ("bfloat16" if device == "cuda"
                                               else "float32"),
                       dropout_stage1=0.0, dropout_head=0.0, dropout_nl=0.0)


def train_state(torch, head, weights, device, optimizer="sgd", lr=0.05,
                dtype=None, **model):
    """A TrainState of the full-width model (`train_model_config`'s
    `model` keywords) on `device` from `weights`, and its train step
    (uint8 clips prepared on the device)."""
    from tmrnet_torch.config import DataConfig, TrainConfig
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.device import resolve_device
    from tmrnet_torch.models.tmrnet import build_model
    from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

    cfg = train_model_config(head, device, dtype, **model)
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    model.load_state_dict(weights)
    state = TrainState(model, make_optimizer(
        TrainConfig(optimizer=optimizer, lr=lr, momentum=0.9,
                    weight_decay=5e-4), model, slow_modules_for_head(head)))
    make = make_stage1_steps if head == "stage1" else make_stage2_steps
    step, _ = make(prep=DevicePrep(DataConfig(device_normalize=True),
                                   cfg.compute_dtype, device))
    return state, step


def train_batch(torch, seed, clips):
    """`clips` uint8 224x224 clips of SEQ frames, a WINDOW-row memory per
    clip and labels, on the CPU, from a seed."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (clips, SEQ, IMG, IMG, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.standard_normal((clips, WINDOW, HIDDEN),
                                                 dtype=np.float32)),
            torch.from_numpy(rng.integers(0, CLASSES, clips)))


def one_step(torch, head, weights, batch, device, dtype=None, **model):
    """One SGD step (momentum 0.9, weight decay 5e-4) of `head` on
    `device` (`train_model_config`'s `model` keywords): (loss, parameter
    deltas, running statistics, launches)."""
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    state, step = train_state(torch, head, weights, device, dtype=dtype,
                              **model)
    before = {k: v.detach().clone() for k, v in
              state.model.named_parameters()}
    clips, memory, labels = (t.to(device) for t in batch)
    args = (clips,) if head == "stage1" else (clips, memory)
    if device == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    m = step(state, *args, labels, torch.Generator(device=device)
             .manual_seed(0))
    loss = float(m["loss"])
    counts = dict(LAUNCHES)
    deltas = {k: (v.detach() - before[k]).float().cpu()
              for k, v in state.model.named_parameters()}
    stats = {k: v.float().cpu() for k, v in state.model.state_dict().items()
             if "running" in k}
    del state, before
    return loss, deltas, stats, counts


def check_step_vs_cpu(torch, seed, card, backbone="resnet50", refs=None):
    """Phase 4g A (4j a with backbone resnest50): one SGD step of the
    full-width model on TRAIN_CLIPS uint8 clips on the card against the
    same step in f32 on the CPU through the plain versions
    (`train/step_check.py` says how deltas are compared). In bf16 (heads
    tmr and stage1), beside the same step in bf16 on the CPU: the loss
    within STEP_LOSS_TOL relative, the running statistics within TOL of
    max |cpu|, one time_conv and one nl_attention launch in the stage-2
    step and none in stage 1 (so none in a backward), the backbone's and
    the head's and LSTM's deltas laid end to end within the backbone's
    `step_check.AGG_LIMITS`, and each tensor that the CPU's bf16 step
    resolves within 5e-2 or twice that step's distance. In f32 (heads
    stage1 and, on ResNet-50, nl_only; the f32 tmr step is 4q (b)): the
    loss and the running statistics within STEP_F32_TOL, each
    tensor's delta within 5e-2 (cosine 0.95 for the backbone), the
    nl_attention kernel launched once in nl_only's step. The tmr step's
    weights, clips and CPU f32 step go into `refs` (ResNet-50), for 4q (b)
    to hold the card's f32 tmr step against.
    On ResNeSt-50 each bf16 statistic lands within TOL or within twice the
    CPU bf16 step's error there (at the split attention's fc1 the batch
    mean is ~30x its spread, and bf16 rounding moves the batch variance),
    and the f32 check leaves the split attention's fc1 biases to the
    aggregates (`step_check.rounding_only`: each feeds a train-mode
    BatchNorm, so its gradient is zero but for rounding), printing their
    distances. Returns (the card stage-2 bf16 step's launches, ok)."""
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.train.step_check import (AGG_LIMITS, TENSOR_LIMIT,
                                               aggregate, distance,
                                               rounding_only, verdicts,
                                               worst_by_group)

    limits = AGG_LIMITS[backbone]
    heads = (("tmr", "stage1", "nl_only") if backbone == "resnet50"
             else ("tmr", "stage1"))
    tag = "" if backbone == "resnet50" else f"{backbone} "
    ok, counts = True, {}
    batch = train_batch(torch, seed + 20, TRAIN_CLIPS)
    stat_errs = lambda got, want: {
        k: float((got[k] - w).abs().max() / max(float(w.abs().max()), 1e-12))
        for k, w in want.items()}
    stat_err = lambda got, want: max(stat_errs(got, want).values())
    # ResNeSt's bf16 statistics are judged against how far the CPU's own
    # bf16 step lands, as the deltas are
    resolve = backbone != "resnet50"
    for head in heads:
        weights = from_jax_variables(random_variables(
            train_model_config(head, "cpu", backbone=backbone), seed + 21))
        t0 = time.perf_counter()
        cpu = one_step(torch, head, weights, batch, "cpu", backbone=backbone)
        print(f"train step {tag}{head}: CPU f32 step "
              f"{time.perf_counter() - t0:.1f} s, loss {cpu[0]:.6g}")
        if refs is not None and head == "tmr" and backbone == "resnet50":
            refs["tmr_cpu_f32"] = (weights, batch, cpu)
        if head != "nl_only":
            t0 = time.perf_counter()
            ref = one_step(torch, head, weights, batch, "cpu", "bfloat16",
                           backbone=backbone)
            t1 = time.perf_counter()
            gpu = one_step(torch, head, weights, batch, "cuda",
                           backbone=backbone)
            torch.cuda.empty_cache()
            if head == "tmr":
                counts = gpu[3]
            rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
            agg, agg_ref = aggregate(gpu[1], cpu[1]), aggregate(ref[1], cpu[1])
            judged = verdicts(gpu[1], ref[1], cpu[1])
            tally = {v: 0 for v in ("limit", "bf16", "unresolved", "FAIL")}
            for k, (v, d, r) in judged.items():
                tally[v] += 1
                if v == "FAIL":
                    print(f"    {k}: card {d:.5g}, cpu bf16 {r:.5g} FAIL")
            unresolved = [k for k, (v, _, _) in judged.items()
                          if v == "unresolved"]
            errs, errs_ref = stat_errs(gpu[2], cpu[2]), stat_errs(ref[2],
                                                                  cpu[2])
            sterr = max(errs.values())
            stats_ok = (all(e <= TOL or e <= 2 * errs_ref[k]
                            for k, e in errs.items()) if resolve
                        else sterr <= TOL)
            worst = max(errs, key=errs.get)
            want = {"time_conv": 1, "nl_attention": 1} if head == "tmr" else {}
            good = (rel <= STEP_LOSS_TOL and stats_ok and gpu[3] == want
                    and tally["FAIL"] == 0
                    and all(agg[g] <= limits[g] for g in agg))
            rule = (f"each within {TOL} or twice the cpu bf16 step's"
                    if resolve else f"limit {TOL}")
            print(f"  {head} bf16: loss card {gpu[0]:.6g} cpu bf16 "
                  f"{ref[0]:.6g}, card rel {rel:.3g} (limit {STEP_LOSS_TOL});"
                  f" running stats worst /max|cpu| {sterr:.4g} at {worst} "
                  f"(cpu bf16 there {errs_ref[worst]:.4g}, its worst "
                  f"{max(errs_ref.values()):.4g}; {rule}); launches "
                  f"{gpu[3]} (want {want}: the forward launches each once, "
                  f"the backward none) (CPU bf16 step {t1 - t0:.1f} s)")
            print(f"  {head} bf16: aggregates card "
                  f"{json.dumps(agg)} cpu bf16 {json.dumps(agg_ref)} "
                  f"(1 - cosine of the backbone's deltas, relative error of "
                  f"the head's and LSTM's; limits "
                  f"{json.dumps(limits)})")
            print(f"  {head} bf16: {len(judged)} parameter deltas {tally} "
                  f"(within 5e-2, within twice the cpu bf16 step's "
                  f"distance, not resolved by the cpu bf16 step, failed); "
                  f"unresolved outside the backbone "
                  f"{[k for k in unresolved if not k.startswith('backbone.')]} "
                  f"{'ok' if good else 'FAIL'}")
            ok &= good
        if head != "tmr":
            g32 = one_step(torch, head, weights, batch, "cuda", "float32",
                           backbone=backbone)
            torch.cuda.empty_cache()
            rel = abs(g32[0] - cpu[0]) / abs(cpu[0])
            dist = {k: distance(k, g32[1][k], w) for k, w in cpu[1].items()}
            sterr = stat_err(g32[2], cpu[2])
            want = {"nl_attention": 1} if head == "nl_only" else {}
            # a bias that feeds a train-mode BatchNorm has no gradient
            # but rounding: the aggregates hold it, not its own distance
            held = {k: d for k, d in dist.items() if not rounding_only(k)}
            rounding = {k: round(d, 4) for k, d in dist.items()
                        if rounding_only(k)}
            good = (rel <= STEP_F32_TOL and sterr <= STEP_F32_TOL
                    and all(d <= TENSOR_LIMIT for d in held.values())
                    and g32[3] == want)
            print(f"  {head} f32: loss card {g32[0]:.8g} rel {rel:.3g}, "
                  f"running stats {sterr:.4g} (limit {STEP_F32_TOL} each); "
                  f"{len(held)} deltas, worst {worst_by_group(held)} "
                  f"(limit {TENSOR_LIMIT} each), {len(rounding)} biases "
                  f"before a train-mode BatchNorm apart {rounding}; "
                  f"aggregates "
                  f"{json.dumps(aggregate(g32[1], cpu[1]))}; launches "
                  f"{g32[3]} (want {want}) {'ok' if good else 'FAIL'}")
            ok &= good
    print(f"train step {tag}vs CPU on {card} {'ok' if ok else 'FAIL'}")
    return counts, ok


def step_reading(torch, seed, backbone):
    """The CPU reading behind `train/step_check.py::AGG_LIMITS`: phase 4g
    A's stage-2 and stage-1 steps (the same seeds and clips) of the
    full-width `backbone` in bf16 against f32, both on the CPU through the
    plain versions; one JSON line a head with the aggregates of the bf16
    step's deltas and both steps' seconds."""
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.train.step_check import aggregate

    batch = train_batch(torch, seed + 20, TRAIN_CLIPS)
    for head in ("tmr", "stage1"):
        weights = from_jax_variables(random_variables(
            train_model_config(head, "cpu", backbone=backbone), seed + 21))
        t0 = time.perf_counter()
        f32 = one_step(torch, head, weights, batch, "cpu", backbone=backbone)
        t1 = time.perf_counter()
        bf16 = one_step(torch, head, weights, batch, "cpu", "bfloat16",
                        backbone=backbone)
        t2 = time.perf_counter()
        print(json.dumps({"step_reading": backbone, "head": head,
                          "aggregates": aggregate(bf16[1], f32[1]),
                          "loss_f32": f32[0], "loss_bf16": bf16[0],
                          "f32_s": t1 - t0, "bf16_s": t2 - t1,
                          "threads": torch.get_num_threads()}), flush=True)


def check_learns(torch, seed, card):
    """Phase 4g B: LEARN_STEPS Adam steps of the full-width stage-2 model
    on one repeated batch of TRAIN_CLIPS clips; the last loss must be below
    half the first. Returns (launches, ok)."""
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.models.convert import from_jax_variables, random_variables

    weights = from_jax_variables(random_variables(
        train_model_config("tmr", "cpu"), seed + 22))
    state, step = train_state(torch, "tmr", weights, "cuda", "adam", 1e-3)
    clips, memory, labels = (t.cuda() for t in train_batch(
        torch, seed + 23, TRAIN_CLIPS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    reset_launches()
    losses = [float(step(state, clips, memory, labels, gen)["loss"])
              for _ in range(LEARN_STEPS)]
    counts = dict(LAUNCHES)
    want = {"time_conv": LEARN_STEPS, "nl_attention": LEARN_STEPS}
    ok = counts == want and losses[-1] < 0.5 * losses[0] and all(
        np.isfinite(losses))
    print(f"train learns: {LEARN_STEPS} Adam steps on one batch of "
          f"{TRAIN_CLIPS} clips, loss {losses[0]:.4g} -> {losses[-1]:.4g} "
          f"(want below half the first); launches {counts} (want {want}) "
          f"on {card} {'ok' if ok else 'FAIL'}")
    del state
    torch.cuda.empty_cache()
    return counts, ok


def bench_steps(torch, seed, card, heads=("stage1", "tmr"), **model):
    """Phase 4g E (4j c and d with `train_model_config`'s `model`
    keywords): the train step of each stage at TRAIN_BATCH clips
    (TRAIN_BATCH * SEQ frames of 224x224, bf16) on a batch already on the
    card: p50 ms after BENCH_WARMUP steps, frames/s and peak memory.
    Returns (the stage-2 timed steps' launches, numbers by head, ok)."""
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.models.convert import from_jax_variables, random_variables

    ok, numbers, counts = True, {}, {}
    tag = " ".join(["train bench"] + [f"{k}={v}" for k, v in model.items()])
    batch = [t.cuda() for t in train_batch(torch, seed + 24, TRAIN_BATCH)]
    for head in heads:
        weights = from_jax_variables(random_variables(
            train_model_config(head, "cpu", **model), seed + 25))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step = train_state(torch, head, weights, "cuda", lr=1e-4,
                                  **model)
        args = (batch[0],) if head == "stage1" else tuple(batch[:2])
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(BENCH_WARMUP):
            step(state, *args, batch[2], gen)
        torch.cuda.synchronize()
        reset_launches()
        times, losses = [], []
        for _ in range(BENCH_STEPS):
            t0 = time.perf_counter()
            m = step(state, *args, batch[2], gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        if head == "tmr":
            counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        p50 = float(np.median(times))
        frames = TRAIN_BATCH * SEQ
        numbers[head] = dict(step_ms_p50=p50, step_ms_min=min(times),
                             step_ms_max=max(times),
                             frames_per_s=frames / p50 * 1e3,
                             peak_gib=peak)
        good = all(np.isfinite(losses))
        print(f"{tag} {head}: {TRAIN_BATCH} clips ({frames} frames "
              f"224x224 bf16) step p50 {p50:.2f} ms (min {min(times):.2f}, "
              f"max {max(times):.2f}, {BENCH_STEPS} steps after "
              f"{BENCH_WARMUP}) = {frames / p50 * 1e3:.1f} frames/s, peak "
              f"max_memory_allocated {peak:.2f} GiB on {card} "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        del state, step
    want = ({"time_conv": BENCH_STEPS, "nl_attention": BENCH_STEPS}
            if "tmr" in heads else {})
    good = counts == want
    print(f"{tag}: stage-2 launches {counts} (want {want}) "
          f"{'ok' if good else 'FAIL'}")
    torch.cuda.empty_cache()
    return counts, numbers, ok and good


class Laps:
    """Seconds of a phase's parts: each call closes the part since the
    last."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), {}

    def __call__(self, name):
        now = time.perf_counter()
        self.parts[name] = round(now - self.t, 1)
        self.t = now

    def report(self):
        return json.dumps(self.parts)


# 4j (e)'s flag: train-tmr's checkpoints written by a thread
ASYNC_SET = ("--set", "train.async_checkpoint=true")


def write_train_config(tmp):
    """The workflow's config JSON: phase 4f's width, unfolded, crop and
    flip only (the card's machine has no cv2 for the rotation and the
    hue), data.batch_clips clips a batch, log lines every 2 steps."""
    from tmrnet_torch.config import TrainConfig

    cfg = full_width_config(folded=False)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, use_flip=False,
                                 batch_clips=TRAIN_BATCH),
        train=TrainConfig(log_every=2))
    path = os.path.join(tmp, "train_cfg.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def preemption_run(torch, tmp, argv, card, name="pre"):
    """Phase 4g D (4j e): `python -m tmrnet_torch train-tmr` (argv) as a
    subprocess, SIGTERM in epoch 1 after its first log line, then the same
    command again, checkpoints under tmp/ck_<name>. Returns ok."""
    import threading

    ck = os.path.join(tmp, f"ck_{name}")
    cmd = [sys.executable, "-u", "-m", "tmrnet_torch", "train-tmr", *argv,
           "--set", f"train.checkpoint_dir={ck}", "--log-dir",
           os.path.join(tmp, f"log_{name}")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines, sent = [], {"at": None}
    timer = threading.Timer(TRAIN_TIMEOUT, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            # epoch 0's summary line, then a train/loss line of epoch 1
            done0 = any(x.startswith("[step 0] epoch/train_loss")
                        for x in lines)
            if (sent["at"] is None and done0
                    and "train/loss" in line):
                proc.send_signal(signal.SIGTERM)
                sent["at"] = line.strip()
        rc = proc.wait()
        err = proc.stderr.read()
    finally:
        timer.cancel()
    t1 = time.perf_counter()
    meta = latest_metrics(ck)
    good1 = (rc == 0 and sent["at"] is not None
             and meta.get("preempted") is True and meta.get("epoch") == 0)
    print(f"  train-tmr subprocess ({name}): SIGTERM after {sent['at']!r}, exit {rc} "
          f"in {t1 - t0:.1f} s, replay checkpoint {meta} "
          f"{'ok' if good1 else 'FAIL'}")
    if rc != 0:
        print(err[-2000:])
    proc2 = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=TRAIN_TIMEOUT)
    t2 = time.perf_counter()
    epochs = [int(x.split("]")[0].split()[1]) for x in
              proc2.stdout.splitlines() if "epoch/train_loss" in x]
    last = latest_metrics(ck)
    good2 = (proc2.returncode == 0 and epochs == list(range(1, TMR_EPOCHS))
             and last.get("epoch") == TMR_EPOCHS - 1
             and not last.get("preempted"))
    print(f"  train-tmr rerun ({name}): exit {proc2.returncode} in {t2 - t1:.1f} s, "
          f"epochs {epochs} (want {list(range(1, TMR_EPOCHS))}: the "
          f"interrupted epoch on), last checkpoint {last} on {card} "
          f"{'ok' if good2 else 'FAIL'}")
    if proc2.returncode != 0:
        print(proc2.stderr[-2000:])
    return good1 and good2


def latest_metrics(ck):
    """The metrics of a checkpoint dir's latest step."""
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    m = CheckpointManager(ck)
    return m.metadata(m.latest_step()).get("metrics", {})


def val_pass(torch, cfg_path, manifests, bank_path, ck, sets=()):
    """The trainer's val pass (`train/loop.py::_run_epoch_eval`: the
    unfolded model, the stage-2 eval step with the train split's class
    weights, the memory gather) over the val manifest on the card, with a
    checkpoint directory's weights, the config JSON with the `--set`
    overrides `sets`: (mean loss, accuracy, preds, f32 probs)."""
    from tmrnet_torch import cli
    from tmrnet_torch.config import ExperimentConfig, apply_override
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.data.pipeline import ClipLoader
    from tmrnet_torch.device import resolve_device
    from tmrnet_torch.eval.infer import load_weights
    from tmrnet_torch.memory.lfb import load_bank
    from tmrnet_torch.train import loop
    from tmrnet_torch.train.losses import balanced_class_weights
    from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.train.steps import make_stage2_steps

    with open(cfg_path) as f:
        cfg = ExperimentConfig.from_json(f.read())
    for o in sets:
        cfg = apply_override(cfg, o)
    dev, d = resolve_device("cuda"), cfg.data
    model = load_weights(dataclasses.replace(cfg.model, head="tmr"),
                         cli.checkpoint_weights(ck), dev, "block")
    state = TrainState(model, make_optimizer(cfg.train, model,
                                             slow_modules_for_head("tmr")))
    weights = (balanced_class_weights(cli.load_manifest(
        manifests["train"]).flat_labels(), cfg.model.num_classes)
        if cfg.train.class_weighting else None)
    _, eval_step = make_stage2_steps(
        weights, "sum", label_smoothing=cfg.train.label_smoothing,
        prep=DevicePrep(d, cfg.model.compute_dtype, dev)
        if d.device_normalize else None)
    probs = []

    def recording(*args):
        m = eval_step(*args)
        probs.append(m["probs"])
        return m

    ds = cli.dataset(cfg, cli.load_manifest(manifests["val"], "val"))
    loader = ClipLoader(ds, d.batch_clips, shuffle=False,
                        num_workers=d.num_workers, prefetch=d.prefetch,
                        use_processes=d.use_process_workers)
    memory_fn = loop._make_memory_fn(cfg, ds, load_bank(bank_path, device=dev),
                                     cfg.memory.window)
    loss, acc, preds, _, _ = loop._run_epoch_eval(recording, state, loader,
                                                  dev, memory_fn)
    # only the last batch is padded: its repeats are the rows past preds
    return loss, acc, preds, torch.cat(probs)[:len(preds)].cpu().numpy()


def train_split():
    """4g's split of 4f's videos: (videos of TEST_LENGTHS by split, clips
    by split, train steps an epoch (drop_remainder), val batches)."""
    split = {"train": (0, 1), "val": (2, 3)}
    clips = {s: sum(max(0, TEST_LENGTHS[v] - SEQ + 1) for v in vs)
             for s, vs in split.items()}
    return (split, clips, clips["train"] // TRAIN_BATCH,
            -(-clips["val"] // TRAIN_BATCH))


def run_train_slice(torch, seed, card, kept=None, refs=None):
    """Phase 4g: the training slice. A: a stage-2 and a stage-1 step on the
    card against the CPU; B: the head learns; C: `manifest` (train and val
    splits of 4f's videos), `train-bank`, `build-lfb --ckpt` (both splits,
    folded, clip engine), `train-tmr --stage1-ckpt` and `test --ckpt`
    through `tmrnet_torch.cli.main`, exact launch counts per command, the
    best checkpoint's val_acc against the trainer's val pass re-run on its
    weights, and `test`'s softmax and argmax against that pass's; D:
    preemption and resume of `train-tmr` as a subprocess, and where
    `refs` is given 4j (e)'s under train.async_checkpoint beside it (its
    verdict left in `refs` for 4j); E: train step times, frames/s and peak
    memory per stage. C runs first; D's subprocesses then run in threads
    while A's CPU steps run here (nothing of A is timed), and B and E
    after both. Prints each part's seconds. Returns (counts by path,
    numbers, ok)."""
    counts, numbers, laps = {}, {}, Laps()
    ok = True
    os.makedirs(ROOT_TMP, exist_ok=True)
    split, clips, steps, val_batches = train_split()
    want = {
        "train-bank": {},
        "lfb-ckpt": {"fused_bottleneck": 12 * sum(
            -(-c // LFB_BATCH) for c in clips.values())},
        "train-tmr": {k: TMR_EPOCHS * (steps + val_batches)
                      for k in ("time_conv", "nl_attention")},
        "test-ckpt": {k: v * -(-clips["val"] // TEST_BATCH) for k, v in
                      {"fused_bottleneck": 12, "time_conv": 1,
                       "nl_attention": 1}.items()},
    }
    seconds = {}
    with phase_dir("train", kept) as tmp:
        write_test_videos(seed, tmp)
        out = lambda name: os.path.join(tmp, name)
        for s, vs in split.items():
            os.makedirs(out(f"frames_{s}"))
            for v in vs:
                os.rename(out(f"frames/video{v + 1:02d}.npy"),
                          out(f"frames_{s}/video{v + 1:02d}.npy"))
        cfg_path = write_train_config(tmp)
        c = ["--config", cfg_path]
        for s in split:
            run_cli(["manifest", *c, "--frames", out(f"frames_{s}"),
                     "--annotations", out("ann"), "--out", out(f"{s}.pkl")])
        manifests = ["--train-manifest", out("train.pkl"), "--val-manifest",
                     out("val.pkl")]
        _, counts["train-bank"], seconds["train-bank"] = run_cli(
            ["train-bank", *c, *manifests, "--log-dir", out("log1"),
             "--set", f"train.epochs={BANK_EPOCHS}",
             "--set", f"train.checkpoint_dir={out('ck1')}"])
        lfb = {}
        for s in split:
            _, lfb[s], seconds[f"build-lfb {s}"] = run_cli(
                ["build-lfb", *c, "--set", "model.folded=true", "--manifest",
                 out(f"{s}.pkl"), "--ckpt", out("ck1"), "--engine", "clip",
                 "--out", out(f"bank_{s}.npz")])
        counts["lfb-ckpt"] = {k: lfb["train"].get(k, 0) + lfb["val"].get(k, 0)
                              for k in set(lfb["train"]) | set(lfb["val"])}
        tmr_args = [*c, *manifests, "--lfb", out("bank_train.npz"),
                    "--val-lfb", out("bank_val.npz"), "--stage1-ckpt",
                    out("ck1"), "--set", f"train.epochs={TMR_EPOCHS}"]
        _, counts["train-tmr"], seconds["train-tmr"] = run_cli(
            ["train-tmr", *tmr_args, "--log-dir", out("log2"),
             "--set", f"train.checkpoint_dir={out('ck2')}"])
        lines, counts["test-ckpt"], seconds["test"] = run_cli(
            ["test", *c, "--set", "model.folded=true", "--manifest",
             out("val.pkl"), "--ckpt", out("ck2"), "--lfb",
             out("bank_val.npz"), "--out", out("preds.npz")])
        for path, got in counts.items():
            if path in want:
                good = got == want[path]
                print(f"  {path}: launches {got} (want {want[path]}) "
                      f"{'ok' if good else 'FAIL'}")
                ok &= good
        from tmrnet_torch import cli

        labels = cli.clip_labels(cli.load_manifest(out("val.pkl")), SEQ)
        with np.load(out("preds.npz")) as z:
            preds, scores = z["preds"], z["scores"]
        with open(out("ck2/best.json")) as f:
            best = json.load(f)["metrics"]
        acc = float((preds == labels).mean())
        v_loss, v_acc, v_preds, v_probs = val_pass(
            torch, cfg_path, {s: out(f"{s}.pkl") for s in split},
            out("bank_val.npz"), out("ck2"))
        loss_err = abs(v_loss - best["val_loss"])
        good = (v_acc == best["val_acc"]
                and loss_err <= VAL_LOSS_TOL * abs(best["val_loss"])
                and preds.shape == (clips["val"],)
                and bool(np.isfinite(scores).all())
                and json.loads(lines[-1])["clip_accuracy"] == acc)
        print(f"  best train-tmr checkpoint (epoch {best['epoch']}): val_loss "
              f"{best['val_loss']:.8g} val_acc {best['val_acc']:.6f}, the "
              f"trainer's val pass re-run on its weights {v_loss:.8g} "
              f"(|diff| {loss_err:.3g}, limit {VAL_LOSS_TOL} relative) "
              f"{v_acc:.6f}; "
              f"test --ckpt on the val split mean of "
              f"preds == labels {acc:.6f} over {len(preds)} clips "
              f"{'ok' if good else 'FAIL'}")
        good &= probs_close("test --ckpt (folded) vs the best checkpoint's "
                            "val pass (unfolded) softmax", scores, v_probs)
        good &= argmax_agrees("test --ckpt vs the best checkpoint's val pass",
                              preds, v_preds, v_probs,
                              min_decided=1)
        ok &= good
        numbers["commands_s"] = seconds
        print(f"train slice: commands' seconds {json.dumps(seconds)} "
              f"(train-bank {BANK_EPOCHS} epoch, train-tmr {TMR_EPOCHS}, "
              f"{clips['train']} train and {clips['val']} val clips) on "
              f"{card}")
        laps("C")
        runs = [lambda: preemption_run(torch, tmp, tmr_args, card)]
        if refs is not None:
            runs.append(lambda: preemption_run(
                torch, tmp, [*tmr_args, *ASYNC_SET], card, name="async"))
        with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
            futures = [pool.submit(r) for r in runs]
            try:
                counts["train-step"], good = check_step_vs_cpu(
                    torch, seed, card, refs=refs)
                ok &= good
                laps("A")
            finally:
                done = [f.result() for f in futures]
        ok &= done[0]
        if refs is not None:
            refs["async_preemption"] = done[1]
        laps("D (beside A)" if refs is None
             else "D with 4j (e)'s async run (beside A)")
    counts["train-learn"], good = check_learns(torch, seed, card)
    ok &= good
    laps("B")
    counts["train-bench"], numbers["steps"], good = bench_steps(torch, seed,
                                                                card)
    ok &= good
    laps("E")
    print(f"train slice: {json.dumps(numbers)}; seconds {laps.report()} on "
          f"{card} {'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return counts, numbers, ok


# Phase 4j, the ResNeSt and training-options slice: the running
# statistics of a remat step against the plain step (of max |stat|), the
# save() calls timed each way, the daemon's ticks over the checkpoint
# flags, and the seed offsets of its weights and batches.
REMAT_STAT_TOL, SAVE_REPEATS, FLAG_TICKS = 1e-6, 3, 12


def check_remat(torch, seed, card):
    """Phase 4j (d): one f32 stage-1 step of the full-width ResNet-50 with
    train.remat (each bottleneck recomputed in the backward pass) against
    the same step without it on the card, every delta within STEP_F32_TOL
    (1 - cosine for the backbone, relative error for the rest) and the
    running statistics within REMAT_STAT_TOL of max |stat|; then the bf16
    step at TRAIN_BATCH clips both ways: p50 ms and peak memory. Returns
    (launches, numbers, ok)."""
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.train.step_check import distance, worst_by_group

    weights = from_jax_variables(random_variables(
        train_model_config("stage1", "cpu"), seed + 26))
    batch = train_batch(torch, seed + 27, TRAIN_CLIPS)
    plain = one_step(torch, "stage1", weights, batch, "cuda", "float32")
    remat = one_step(torch, "stage1", weights, batch, "cuda", "float32",
                     remat=True)
    torch.cuda.empty_cache()
    dist = {k: distance(k, remat[1][k], w) for k, w in plain[1].items()}
    stat = max(float((remat[2][k] - w).abs().max())
               / max(float(w.abs().max()), 1e-12) for k, w in plain[2].items())
    ok = (all(d <= STEP_F32_TOL for d in dist.values())
          and stat <= REMAT_STAT_TOL and remat[3] == plain[3] == {}
          and abs(remat[0] - plain[0]) <= STEP_F32_TOL * abs(plain[0]))
    print(f"remat: f32 stage-1 step with train.remat against without on "
          f"{card}: loss {remat[0]:.8g} / {plain[0]:.8g}; {len(dist)} "
          f"deltas, worst {worst_by_group(dist)} (limit {STEP_F32_TOL} "
          f"each); running stats worst {stat:.3g} of max |stat| (limit "
          f"{REMAT_STAT_TOL}); launches {remat[3]} / {plain[3]} (want {{}}) "
          f"{'ok' if ok else 'FAIL'}")
    numbers = {}
    for remat_on in (False, True):
        _, got, good = bench_steps(torch, seed, card, heads=("stage1",),
                                   remat=remat_on)
        numbers["remat" if remat_on else "plain"] = got["stage1"]
        ok &= good
    a, b = numbers["plain"], numbers["remat"]
    print(f"remat: bf16 stage-1 step at {TRAIN_BATCH} clips p50 "
          f"{a['step_ms_p50']:.2f} -> {b['step_ms_p50']:.2f} ms "
          f"({b['step_ms_p50'] / a['step_ms_p50']:.3f}x), peak "
          f"{a['peak_gib']:.2f} -> {b['peak_gib']:.2f} GiB on {card}")
    return {}, numbers, ok


def save_blocking(torch, seed, card, tmp):
    """Phase 4j (e), the in-process part: how long `CheckpointManager.save`
    blocks the trainer, sync against async (train.async_checkpoint), on a
    full-width stage-2 train state after one step on the card (weights,
    statistics and SGD momentum): SAVE_REPEATS saves each way, and the
    async wait() after each; the last async step's file equal to the sync
    one's, tensor for tensor. Returns (numbers, ok)."""
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    weights = from_jax_variables(random_variables(
        train_model_config("tmr", "cpu"), seed + 28))
    state, step = train_state(torch, "tmr", weights, "cuda")
    clips, memory, labels = (t.cuda() for t in train_batch(torch, seed + 29,
                                                             2))
    step(state, clips, memory, labels,
         torch.Generator(device="cuda").manual_seed(0))
    ms = {"sync": [], "async": [], "async_wait": []}
    managers = {}
    for mode in ("sync", "async"):
        ck = managers[mode] = CheckpointManager(
            os.path.join(tmp, f"save_{mode}"), keep=2,
            use_async=mode == "async")
        for i in range(SAVE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(state, i + 1)
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            ms[mode].append((t1 - t0) * 1e3)
            if mode == "async":
                ms["async_wait"].append((t2 - t1) * 1e3)
    a = CheckpointManager._load(managers["sync"]._step_dir(SAVE_REPEATS))
    b = CheckpointManager._load(managers["async"]._step_dir(SAVE_REPEATS))
    flat = lambda tree, pre="": (
        [x for k, v in sorted(tree.items()) for x in flat(v, f"{pre}{k}.")]
        if isinstance(tree, dict) else [(pre, tree)])
    fa, fb = flat(a["variables"]), flat(b["variables"])
    same = ([k for k, _ in fa] == [k for k, _ in fb]
            and all(np.array_equal(x, y) for (_, x), (_, y) in zip(fa, fb)))
    nbytes = sum(x.nbytes for _, x in fa)
    numbers = {k: float(np.median(v)) for k, v in ms.items()}
    numbers["weights_mib"] = nbytes / 2**20
    print(f"async checkpoints: save() blocks p50 {numbers['sync']:.1f} ms "
          f"sync, {numbers['async']:.1f} ms async (its write then "
          f"{numbers['async_wait']:.1f} ms in the background), "
          f"{SAVE_REPEATS} saves each of a full-width stage-2 state "
          f"({nbytes / 2**20:.1f} MiB of weights and statistics, and the "
          f"momentum); the async file equal to the sync one {same} on "
          f"{card} {'ok' if same else 'FAIL'}")
    del state, step
    torch.cuda.empty_cache()
    return numbers, same


def check_native(torch, tmp, card, cfg_path, manifests):
    """Phase 4j (f): the native preprocess on the card's host. The first
    train batch of `cli.train_dataset` under data.device_normalize=false
    through the C++ library against numpy's (within 1e-6), then one
    `train-bank` epoch each way with the frames/s of its train steps.
    Returns (launches, numbers, ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.config import ExperimentConfig, apply_override
    from tmrnet_torch.data.pipeline import ClipLoader

    with open(cfg_path) as f:
        cfg = apply_override(ExperimentConfig.from_json(f.read()),
                             "data.device_normalize=false")
    d = cfg.data
    first = {}
    for native in (True, False):
        c = apply_override(cfg, f"data.use_native_preproc={native}")
        ds = cli.train_dataset(c, cli.load_manifest(manifests[1]))
        loader = ClipLoader(ds, d.batch_clips, shuffle=True,
                            num_workers=d.num_workers, prefetch=d.prefetch,
                            seed=c.train.seed, drop_remainder=True)
        it = loader.epoch(0)
        first[native] = next(it)[0]
        it.close()
    err = float(np.abs(first[True] - first[False]).max())
    ok = (first[True].dtype == np.float32
          and first[True].shape == (TRAIN_BATCH, SEQ, IMG, IMG, 3)
          and err <= 1e-6)
    print(f"native preprocess: the first train batch {first[True].shape} "
          f"{first[True].dtype}, C++ against numpy max_abs_err {err:.3g} "
          f"(limit 1e-6) {'ok' if ok else 'FAIL'}")
    numbers, counts = {}, {}
    for native in (True, False):
        name = "native" if native else "numpy"
        lines, counts[name], secs = run_cli(
            ["train-bank", "--config", cfg_path, *manifests,
             "--set", "data.device_normalize=false",
             "--set", f"data.use_native_preproc={str(native).lower()}",
             "--set", "train.epochs=1",
             "--set", f"train.checkpoint_dir={os.path.join(tmp, f'ck_{name}')}",
             "--log-dir", os.path.join(tmp, f"log_{name}")])
        fps = [float(x.split("train/fps=")[1].split()[0]) for x in lines
               if "train/fps=" in x]
        numbers[name] = {"train_frames_per_s": fps[-1] if fps else None,
                         "command_s": secs}
        ok &= bool(fps) and counts[name] == {}
    print(f"native preprocess: train-bank epoch (host normalization) train "
          f"frames/s {json.dumps(numbers)} on {card}")
    return counts, numbers, ok


def serve_rows(argv):
    """`serve --input` through `run_cli`, its SIGTERM / SIGINT handlers
    put back after: (rows, launches, seconds)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM,
                                                     signal.SIGINT)}
    try:
        lines, counts, secs = run_cli(argv)
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    return [json.loads(x) for x in lines], counts, secs


def check_checkpoint_flags(torch, tmp, card, cfg_path):
    """Phase 4j (g), on 4g's ResNet-50 checkpoints (ck1 stage 1, ck2
    stage 2), folded: `test`, `stream` and `serve` with `--extractor-ckpt
    ck1` against the same commands with `--extractor-torch-ckpt` on its
    `export-ckpt` `.pth`, bit for bit and launch for launch; `serve --ckpt
    ck2` against `serve --torch-ckpt` on its `.pth`, 2 streams for
    FLAG_TICKS ticks, within RESUME_TOL. Returns (launches, seconds,
    ok)."""
    out = lambda name: os.path.join(tmp, name)
    c = ["--config", cfg_path, "--set", "model.folded=true"]
    run_cli(["export-ckpt", "--config", cfg_path, "--set", "model.head=stage1",
             "--ckpt", out("ck1"), "--out", out("ck1_stage1.pth")])
    run_cli(["export-ckpt", "--config", cfg_path, "--ckpt", out("ck2"),
             "--out", out("ck2_tmr.pth")])
    flags = {"ckpt": ["--extractor-ckpt", out("ck1")],
             "pth": ["--extractor-torch-ckpt", out("ck1_stage1.pth")]}
    ok, counts, seconds, got = True, {}, {}, {}
    for kind, flag in flags.items():
        _, counts[f"flags-test-{kind}"], seconds[f"test {kind}"] = run_cli(
            ["test", *c, "--manifest", out("val.pkl"), "--ckpt", out("ck2"),
             *flag, "--out", out(f"flags_{kind}.npz")])
        with np.load(out(f"flags_{kind}.npz")) as z:
            got[kind] = z["scores"]
    same = (np.array_equal(got["ckpt"], got["pth"])
            and counts["flags-test-ckpt"] == counts["flags-test-pth"])
    print(f"  test --extractor-ckpt vs --extractor-torch-ckpt: "
          f"{got['ckpt'].shape[0]} clips bit for bit, launches "
          f"{counts['flags-test-ckpt']} both {'ok' if same else 'FAIL'}")
    ok &= same
    for kind, flag in flags.items():
        _, counts[f"flags-stream-{kind}"], seconds[f"stream {kind}"] = (
            run_cli(["stream", *c, "--manifest", out("val.pkl"), "--ckpt",
                     out("ck2"), *flag, "--max-streams", "2", "--out",
                     out(f"flags_{kind}.jsonl")]))
        with open(out(f"flags_{kind}.jsonl")) as f:
            got[kind] = f.read()
    same = (got["ckpt"] == got["pth"]
            and counts["flags-stream-ckpt"] == counts["flags-stream-pth"])
    print(f"  stream --extractor-ckpt vs --extractor-torch-ckpt: "
          f"{len(got['ckpt'].splitlines())} rows equal, launches "
          f"{counts['flags-stream-ckpt']} both {'ok' if same else 'FAIL'}")
    ok &= same
    with open(out("flag_events.jsonl"), "w") as f:
        for t in range(FLAG_TICKS):
            for sid, path in (("a", "frames_val/video03.npy"),
                              ("b", "frames_train/video01.npy")):
                f.write(json.dumps({"id": sid,
                                    "image": f"{out(path)}#{t}"}) + "\n")
            f.write(json.dumps({"step": True}) + "\n")
    serve = ["serve", *c, "--input", out("flag_events.jsonl"), "--slots",
             "2", "--probs"]
    rows = {}
    for name, argv in (
            ("ckpt", ["--ckpt", out("ck2"), *flags["ckpt"]]),
            ("pth", ["--ckpt", out("ck2"), *flags["pth"]]),
            ("model-ckpt", ["--ckpt", out("ck2")]),
            ("model-pth", ["--torch-ckpt", out("ck2_tmr.pth")])):
        rows[name], counts[f"flags-serve-{name}"], seconds[f"serve {name}"] = (
            serve_rows(serve + argv))
    same = (rows["ckpt"] == rows["pth"]
            and counts["flags-serve-ckpt"] == counts["flags-serve-pth"])
    print(f"  serve --extractor-ckpt vs --extractor-torch-ckpt: "
          f"{len(rows['ckpt'])} rows equal, launches "
          f"{counts['flags-serve-ckpt']} both {'ok' if same else 'FAIL'}")
    ok &= same
    a, b = rows["model-ckpt"], rows["model-pth"]
    key = lambda r: (r.get("id"), r.get("frame"), r.get("valid"))
    err = max((abs(x - y) for ra, rb in zip(a, b) if "probs" in ra
               for x, y in zip(ra["probs"], rb["probs"])), default=np.inf)
    good = (len(a) == len(b) == 2 * FLAG_TICKS
            and [key(r) for r in a] == [key(r) for r in b]
            and sum(bool(r.get("valid")) for r in a) > 0
            and err <= RESUME_TOL
            and counts["flags-serve-model-ckpt"]
            == counts["flags-serve-model-pth"])
    print(f"  serve --ckpt vs --torch-ckpt: {len(a)} rows over 2 streams x "
          f"{FLAG_TICKS} ticks, probs max_abs_err {err:.3g} (limit "
          f"{RESUME_TOL}), launches {counts['flags-serve-model-ckpt']} both "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    print(f"checkpoint flags: commands' seconds {json.dumps(seconds)} on "
          f"{card}")
    return counts, seconds, ok


def resnest_workflow(torch, tmp, card, cfg_path, manifests):
    """Phase 4j (b): the two stages with `--set model.backbone=resnest50`
    over 4g's split: `train-bank`, `build-lfb --ckpt` (both splits,
    folded through fold_resnest, clip engine), `train-tmr --stage1-ckpt`
    and `test --ckpt --extractor-ckpt` (clip engine, the bank built from
    the stage-1 checkpoint), exact launch counts (no #3 or #4), the best
    checkpoint's val metrics against the trainer's val pass re-run, and
    `test`'s softmax against that pass's. Returns (launches, seconds,
    ok)."""
    from tmrnet_torch import cli

    out = lambda name: os.path.join(tmp, name)
    split, clips, steps, val_batches = train_split()
    rs = ["--config", cfg_path, "--set", "model.backbone=resnest50"]
    want = {
        "resnest-train-bank": {},
        "resnest-lfb-ckpt": {},
        "resnest-train-tmr": {k: TMR_EPOCHS * (steps + val_batches)
                              for k in ("time_conv", "nl_attention")},
        "resnest-test-ckpt": {k: -(-clips["val"] // TEST_BATCH)
                              for k in ("time_conv", "nl_attention")},
    }
    counts, seconds = {}, {}
    _, counts["resnest-train-bank"], seconds["train-bank"] = run_cli(
        ["train-bank", *rs, *manifests, "--log-dir", out("rlog1"),
         "--set", f"train.epochs={BANK_EPOCHS}",
         "--set", f"train.checkpoint_dir={out('rck1')}"])
    lfb = {}
    for s in split:
        _, lfb[s], seconds[f"build-lfb {s}"] = run_cli(
            ["build-lfb", *rs, "--set", "model.folded=true", "--manifest",
             out(f"{s}.pkl"), "--ckpt", out("rck1"), "--engine", "clip",
             "--out", out(f"rbank_{s}.npz")])
    counts["resnest-lfb-ckpt"] = {k: lfb["train"].get(k, 0)
                                  + lfb["val"].get(k, 0)
                                  for k in set(lfb["train"]) | set(lfb["val"])}
    _, counts["resnest-train-tmr"], seconds["train-tmr"] = run_cli(
        ["train-tmr", *rs, *manifests, "--lfb", out("rbank_train.npz"),
         "--val-lfb", out("rbank_val.npz"), "--stage1-ckpt", out("rck1"),
         "--set", f"train.epochs={TMR_EPOCHS}", "--log-dir", out("rlog2"),
         "--set", f"train.checkpoint_dir={out('rck2')}"])
    lines, counts["resnest-test-ckpt"], seconds["test"] = run_cli(
        ["test", *rs, "--set", "model.folded=true", "--manifest",
         out("val.pkl"), "--ckpt", out("rck2"), "--extractor-ckpt",
         out("rck1"), "--engine", "clip", "--lfb", out("rbank_test.npz"),
         "--out", out("rpreds.npz")])
    ok = True
    for path, got in counts.items():
        good = got == want[path]
        print(f"  {path}: launches {got} (want {want[path]}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    labels = cli.clip_labels(cli.load_manifest(out("val.pkl")), SEQ)
    with np.load(out("rpreds.npz")) as z:
        preds, scores = z["preds"], z["scores"]
    with open(out("rck2/best.json")) as f:
        best = json.load(f)["metrics"]
    v_loss, v_acc, v_preds, v_probs = val_pass(
        torch, cfg_path, {s: out(f"{s}.pkl") for s in split},
        out("rbank_val.npz"), out("rck2"), sets=("model.backbone=resnest50",))
    loss_err = abs(v_loss - best["val_loss"])
    good = (v_acc == best["val_acc"]
            and loss_err <= VAL_LOSS_TOL * abs(best["val_loss"])
            and preds.shape == (clips["val"],)
            and bool(np.isfinite(scores).all())
            and json.loads(lines[-1])["clip_accuracy"]
            == float((preds == labels).mean()))
    print(f"  best resnest train-tmr checkpoint (epoch {best['epoch']}): "
          f"val_loss {best['val_loss']:.8g} val_acc {best['val_acc']:.6f}, "
          f"its val pass re-run {v_loss:.8g} (|diff| {loss_err:.3g}, limit "
          f"{VAL_LOSS_TOL} relative) {v_acc:.6f} "
          f"{'ok' if good else 'FAIL'}")
    good &= probs_close("resnest test --ckpt --extractor-ckpt (folded) vs "
                        "the val pass (unfolded) softmax", scores, v_probs)
    good &= argmax_agrees("resnest test --ckpt vs the val pass", preds,
                          v_preds, v_probs, min_decided=1)
    print(f"resnest workflow: commands' seconds {json.dumps(seconds)} "
          f"(train-bank {BANK_EPOCHS} epoch, train-tmr {TMR_EPOCHS}, "
          f"{clips['train']} train and {clips['val']} val clips) on {card}")
    return counts, seconds, ok and good


def run_options_slice(torch, seed, card, tmp, refs=None):
    """Phase 4j: the ResNeSt and training-options slice, over 4g's
    directory `tmp`. (a) a ResNeSt-50 train step of each stage on the card
    against the CPU; (b) the two-stage workflow on ResNeSt-50; (c)
    ResNeSt-50's train step at TRAIN_BATCH clips; (d) remat on
    ResNet-50; (e) async checkpoints: save()'s blocking time and 4g D's
    preemption and resume under train.async_checkpoint; (f) the native
    preprocess; (g) the checkpoint flags on 4g's checkpoints. (e)'s
    preemption ran beside 4g D's where `refs` holds its verdict. Prints
    each part's seconds. Returns (counts by path, numbers, ok)."""
    t0, laps = time.perf_counter(), Laps()
    counts, numbers = {}, {}
    counts["resnest-train-step"], ok = check_step_vs_cpu(torch, seed, card,
                                                         "resnest50")
    laps("a")
    cfg_path = os.path.join(tmp, "train_cfg.json")
    manifests = ["--train-manifest", os.path.join(tmp, "train.pkl"),
                 "--val-manifest", os.path.join(tmp, "val.pkl")]
    got, numbers["resnest_commands_s"], good = resnest_workflow(
        torch, tmp, card, cfg_path, manifests)
    counts.update(got)
    ok &= good
    laps("b")
    counts["resnest-train-bench"], numbers["resnest_steps"], good = (
        bench_steps(torch, seed, card, backbone="resnest50"))
    ok &= good
    laps("c")
    counts["remat"], numbers["remat"], good = check_remat(torch, seed, card)
    ok &= good
    laps("d")
    numbers["save_ms"], good = save_blocking(torch, seed, card, tmp)
    ok &= good
    if refs is not None and "async_preemption" in refs:
        good = refs.pop("async_preemption")
        print(f"  train-tmr under train.async_checkpoint: preempted and "
              f"resumed beside 4g D (above) {'ok' if good else 'FAIL'}")
    else:
        tmr_args = ["--config", cfg_path, *manifests, "--lfb",
                    os.path.join(tmp, "bank_train.npz"), "--val-lfb",
                    os.path.join(tmp, "bank_val.npz"), "--stage1-ckpt",
                    os.path.join(tmp, "ck1"), "--set",
                    f"train.epochs={TMR_EPOCHS}", *ASYNC_SET]
        good = preemption_run(torch, tmp, tmr_args, card, name="async")
    ok &= good
    laps("e")
    got, numbers["native"], good = check_native(torch, tmp, card, cfg_path,
                                                manifests)
    counts.update({f"train-bank-{k}": v for k, v in got.items()})
    ok &= good
    laps("f")
    got, numbers["flags_s"], good = check_checkpoint_flags(torch, tmp, card,
                                                           cfg_path)
    counts.update(got)
    ok &= good
    laps("g")
    print(f"options slice: {json.dumps(numbers)}; seconds {laps.report()}; "
          f"in {time.perf_counter() - t0:.1f} s on {card} "
          f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return counts, numbers, ok


# Phase 4h, the ResNeSt slice: the launches of a ResNeSt forward, step or
# head call (its blocks have no identity 3x3 conv for #3 or #4 to compute),
# the daemon's ticks, and the seed offset of its reference `.pth`.
RESNEST_LAUNCHES = {"time_conv": 1, "nl_attention": 1}
RESNEST_SERVE_TICKS, RESNEST_SEED = 12, 1400


def run_resnest_video(torch, seed, card):
    """Phase 4h (b), the video part: run_video on one 1,500-frame video of
    the full-width folded ResNeSt-50 (one #1 and one #2 launch, none of
    #3 or #4), the peak memory of a trunk chunk at the auto plan against
    MEMORY_SHARE of what the card can allocate, and bank_features against
    the extractor run clip-wise at 64 positions. Returns (counts, the
    engine, numbers, ok)."""
    from tmrnet_torch.eval.infer import MEMORY_SHARE, VideoInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    ecfg, weights = engine_setup(seed, "resnest50")
    n = VIDEO_LENGTHS[0]
    video = np.random.default_rng(seed + 3).integers(
        0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    engine = VideoInference(ecfg, *weights)
    engine.run_video(video[:64])                  # warm-up, not counted
    torch.cuda.synchronize()
    chunk = engine.trunk_chunk(n, (IMG, IMG))
    reset_launches()
    t0 = time.perf_counter()
    preds, probs = engine.run_video(video)
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    ok = (counts == RESNEST_LAUNCHES and probs.shape == (n - SEQ + 1, CLASSES)
          and bool(np.isfinite(probs).all()))
    print(f"resnest video: run_video {n} frames in {dt:.4f} s = "
          f"{n / dt:.1f} frames/s, trunk chunk {chunk} (auto) on {card}; "
          f"launches {counts} (want {RESNEST_LAUNCHES}) "
          f"{'ok' if ok else 'FAIL'}")
    # Where run_video's time goes (outside the counted run), as in 4c.
    t0 = time.perf_counter()
    staged = torch.from_numpy(video).to(engine.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe, ft = engine.corpus_features([staged])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    engine.corpus_heads(fe, ft, [n])
    t3 = time.perf_counter()
    print(f"resnest video: run_video split: copy to the card "
          f"{(t1 - t0) * 1e3:.1f} ms, both trunks {(t2 - t1) * 1e3:.1f} ms, "
          f"LSTMs + head + copy back {(t3 - t2) * 1e3:.1f} ms")
    del staged, fe, ft

    # One trunk chunk at the auto plan: the plan's frames (the video, then
    # its start again) through the TMR trunk, peak over what was allocated
    free, _ = torch.cuda.mem_get_info()
    available = (free + torch.cuda.memory_reserved()
                 - torch.cuda.memory_allocated())
    frames = torch.from_numpy(np.resize(video, (chunk, IMG, IMG, 3))).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        feats = engine.model.backbone(engine.prep(frames))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    good = bool(torch.isfinite(feats).all()) and peak <= MEMORY_SHARE * available
    print(f"resnest video: a {chunk}-frame trunk chunk peaks at "
          f"{peak / 2**30:.3f} GiB over its input (limit MEMORY_SHARE "
          f"{MEMORY_SHARE} x {available / 2**30:.3f} GiB allocatable) on "
          f"{card} {'ok' if good else 'FAIL'}")
    ok &= good
    del frames, feats

    k = n - SEQ + 1
    rng = np.random.default_rng(seed + 5)
    positions = np.unique(np.concatenate([[0, 1, k - 1], rng.choice(
        np.arange(2, k - 1), min(61, k - 3), replace=False)]))
    clips = np.stack([video[p:p + SEQ] for p in positions])
    bank = engine.bank_features(video)
    with torch.inference_mode():
        clipwise = engine.extractor(engine.prep(
            torch.from_numpy(clips).to(engine.device)))
    ok &= compare(torch, f"resnest bank_features vs LFBExtractor clip-wise at "
                  f"{len(positions)} positions",
                  bank[torch.from_numpy(positions).to(engine.device)],
                  clipwise)[1]
    del bank, clipwise
    torch.cuda.empty_cache()
    return counts, engine, {"frames_s": n / dt, "chunk": chunk,
                            "peak_gib": peak / 2**30}, ok


def run_resnest_reference(torch, seed, card, kept=None):
    """Phase 4h (c): seeded ResNeSt weights exported as reference `.pth`
    in the resnest package's naming, then `manifest`, `build-lfb` (clip)
    and `test` (clip over that bank, corpus) with `--set
    model.backbone=resnest50 --set model.folded=true` through
    `tmrnet_torch.cli.main` over phase 4f's packed videos: exact launch
    counts, each softmax against the same engine built in memory from the
    unexported weights, the two engines against each other; then `python
    -m tmrnet_torch serve` from the same `.pth`, 2 streams for
    RESNEST_SERVE_TICKS ticks, its rows against an in-process serve_loop
    within RESUME_TOL. Returns (counts by path, ok)."""
    import io

    from tmrnet_torch import cli
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.eval.serve import serve_loop
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.models.fold_bn import fold_variables
    from tmrnet_torch.train.loop import build_lfb

    clips = sum(max(0, n - SEQ + 1) for n in TEST_LENGTHS)
    heads = corpus_head_calls(TEST_LENGTHS)
    per = lambda calls: {k: v * calls for k, v in RESNEST_LAUNCHES.items()}
    want = {"resnest-lfb-clip": {},
            "resnest-test-clip": per(-(-clips // TEST_BATCH)),
            "resnest-test-corpus": per(heads)}
    counts, ok = {}, True
    os.makedirs(ROOT_TMP, exist_ok=True)
    with phase_dir("resnest", kept) as tmp:
        # the config JSON holds ResNet-50; the commands' --set picks ResNeSt
        cfg = full_width_config(folded=False, backbone="resnest50")
        paths = write_reference_weights(seed + RESNEST_SEED, tmp, cfg)
        with open(paths["config"], "w") as f:
            f.write(full_width_config(folded=False).to_json())
        sd = torch.load(paths["tmr"], weights_only=True)
        named = all(k in sd for k in (
            "share.conv1.0.weight", "share.conv1.6.weight", "share.bn1.weight",
            "share.layer1.0.conv2.fc1.weight", "share.layer2.0.downsample.1.weight"))
        print(f"resnest reference: .pth in the resnest package's naming "
              f"({len(sd)} keys, {os.path.getsize(paths['tmr']) / 1e6:.1f} MB) "
              f"{'ok' if named else 'FAIL'}")
        ok &= named
        del sd
        write_test_videos(seed, tmp)
        out = lambda name: os.path.join(tmp, name)
        m = out("m.pkl")
        common = ["--config", paths["config"], "--set",
                  "model.backbone=resnest50", "--set", "model.folded=true"]
        run_cli(["manifest", "--config", paths["config"], "--frames",
                 out("frames"), "--annotations", out("ann"), "--out", m])
        _, counts["resnest-lfb-clip"], dt = run_cli(
            ["build-lfb", *common, "--manifest", m, "--torch-ckpt",
             paths["lfb"], "--engine", "clip", "--out", out("bank.npz")])
        print(f"resnest reference: build-lfb --engine clip {SEQ * clips} "
              f"frames in {dt:.3f} s = {SEQ * clips / dt:.1f} frames/s on {card}")
        scores, preds = {}, {}
        for engine in ("clip", "corpus"):
            extra = ["--lfb", out("bank.npz")] if engine == "clip" else []
            _, counts[f"resnest-test-{engine}"], dt = run_cli(
                ["test", *common, "--manifest", m, "--torch-ckpt",
                 paths["tmr"], "--extractor-torch-ckpt", paths["lfb"],
                 "--engine", engine, *extra, "--out", out(f"{engine}.npz")])
            with np.load(out(f"{engine}.npz")) as z:
                scores[engine], preds[engine] = z["scores"], z["preds"]
            print(f"resnest reference: test --engine {engine}: {clips} clips "
                  f"in {dt:.3f} s = {clips / dt:.1f} clips/s on {card}")
        for path, got in counts.items():
            good = got == want[path]
            print(f"  {path}: launches {got} (want {want[path]}) "
                  f"{'ok' if good else 'FAIL'}")
            ok &= good
        ok &= all(scores[e].shape == (clips, CLASSES)
                  and bool(np.isfinite(scores[e]).all()) for e in scores)

        # the same engines in memory, from the weights before their export
        fcfg = cfg.replace(model=dataclasses.replace(cfg.model, folded=True))
        states = reference_states(seed + RESNEST_SEED, cfg)
        state = fold_variables(states["tmr"])
        ext = fold_variables({k: v for k, v in states["lfb"].items()
                              if k.startswith(("backbone.", "encoder."))})
        manifest = cli.load_manifest(m)
        ds = cli.dataset(fcfg, manifest)
        bank = build_lfb(fcfg, ext, ds, cache_path=out("mem.npz"), force=True)
        mem = {"clip": ClipInference(fcfg, state, bank).run(ds).scores}
        ccfg = fcfg.replace(eval=dataclasses.replace(fcfg.eval, corpus=True))
        mem["corpus"] = np.concatenate([r[1] for r in cli._video_engine_results(
            ccfg, state, ext, manifest, "cuda")])
        del bank
        for engine in scores:
            ok &= probs_close(f"resnest test --engine {engine} vs the engine "
                              f"in memory", scores[engine], mem[engine])
        ok &= probs_close("resnest test corpus vs clip", scores["corpus"],
                          scores["clip"])
        ok &= argmax_agrees("resnest test corpus vs clip", preds["corpus"],
                            preds["clip"], scores["clip"], min_decided=1)

        # the daemon from the same .pth, against serve_loop in this process
        video = lambda sid: out(f"frames/video0{'PQ'.index(sid) + 1}.npy")
        frame = lambda sid, t: {"id": sid, "image": f"{video(sid)}#{t}"}
        ticks = range(RESNEST_SERVE_TICKS)
        cmd = [sys.executable, "-m", "tmrnet_torch", "serve", "--torch-ckpt",
               paths["tmr"], "--extractor-torch-ckpt", paths["lfb"], *common,
               "--slots", "2", "--listen", "127.0.0.1:0", "--probs"]
        rows, rc, ready = serve_daemon(cmd, ticks, frame)
        engine = StreamingInference(fcfg, state, ext)
        text = "".join(json.dumps(o) + "\n" for t in ticks for o in
                       (frame("P", t), frame("Q", t), {"step": True}))
        sink = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        serve_loop(engine, 2, io.StringIO(text), sink, cli.frame_loader(fcfg),
                   emit_probs=True)
        counts["resnest-serve"] = dict(LAUNCHES)
        good = counts["resnest-serve"] == per(len(ticks))
        print(f"  resnest-serve (in process): launches "
              f"{counts['resnest-serve']} over {len(ticks)} ticks (want "
              f"{per(len(ticks))}) {'ok' if good else 'FAIL'}")
        ok &= good
        inproc = [json.loads(line) for line in sink.getvalue().splitlines()]
        valid = [(g, w) for g, w in zip(rows, inproc) if w["valid"]]
        good = (rc == 0 and len(rows) == len(inproc) == 2 * len(ticks)
                and [{k: r.get(k) for k in ("id", "frame", "valid")}
                     for r in rows]
                == [{k: r[k] for k in ("id", "frame", "valid")} for r in inproc]
                and len(valid) == 2 * (len(ticks) - SEQ + 1))
        print(f"resnest reference: serve daemon exit {rc}, ready after "
              f"{ready:.2f} s, {len(rows)} rows with ids/frames/valid as in "
              f"process {'ok' if good else 'FAIL'}")
        ok &= good and probs_close(
            "resnest daemon vs in-process rows", [g["probs"] for g, _ in valid],
            np.array([w["probs"] for _, w in valid]), RESUME_TOL)
        del engine, state, ext, states
    torch.cuda.empty_cache()
    return counts, ok


def run_resnest_slice(torch, seed, card, kept=None):
    """Phase 4h: the ResNeSt-50 slice at full width. (a) the clip slice of
    phase 4 through ClipInference; (b) run_video with its trunk chunk's
    peak memory and bank_features (`run_resnest_video`), then the stream
    slice of phase 4d, each stream against run_video; (c) the reference
    `.pth`, `test` and `serve` (`run_resnest_reference`). Returns (counts
    by path, ok)."""
    t0 = time.perf_counter()
    setup = slice_setup(torch, seed, "resnest50")
    counts = {}
    counts["resnest-clip"], rate, _, ok = run_slice(
        torch, setup, card, "block", RESNEST_LAUNCHES, tag="resnest clip slice")
    del setup
    torch.cuda.empty_cache()
    counts["resnest-video"], engine, video, ok_v = run_resnest_video(
        torch, seed, card)
    counts["resnest-stream"], ok_s = run_stream_slice(
        torch, seed, card, engine, "resnest50", RESNEST_LAUNCHES,
        "resnest stream slice")
    del engine
    torch.cuda.empty_cache()
    test_counts, ok_r = run_resnest_reference(torch, seed, card, kept)
    counts.update(test_counts)
    fused = {k: sum(c.get(k, 0) for c in counts.values())
             for k in ("fused_bottleneck", "fused_bottleneck_tiled")}
    print(f"resnest slice: fused-bottleneck launches over its "
          f"{len(counts)} paths {fused} (want 0 each) "
          f"{'ok' if not any(fused.values()) else 'FAIL'}")
    ok &= ok_v and ok_s and ok_r and not any(fused.values())
    print(f"resnest slice: clip {rate:.1f} frames/s, run_video "
          f"{video['frames_s']:.1f} frames/s, a {video['chunk']}-frame trunk "
          f"chunk {video['peak_gib']:.3f} GiB peak, in "
          f"{time.perf_counter() - t0:.1f} s on {card} "
          f"{'ok' if ok else 'FAIL'}")
    return counts, ok


# Phase 4i, the scoring slice: `stream`'s slots, the launches of a stream
# step, and the launches of a clip-engine batch of the bank build and of
# inference on the ResNet and the ResNeSt trunk.
SCORE_SLOTS = 2
STEP_LAUNCHES = {"fused_bottleneck": 24, "time_conv": 1, "nl_attention": 1}
LFB_BATCH_LAUNCHES = {"fused_bottleneck": 12}
TEST_BATCH_LAUNCHES = {"fused_bottleneck": 12, "time_conv": 1,
                       "nl_attention": 1}


def slot_schedule(lengths, slots):
    """`stream`'s slot plan: for every step, the (slot, video, frame) of
    each occupied slot; a finished video's slot takes the next video."""
    pending = list(range(len(lengths)))[::-1]
    video = [pending.pop() if pending else -1 for _ in range(slots)]
    t = [0] * slots
    steps = []
    while any(v >= 0 for v in video):
        steps.append([(i, v, t[i]) for i, v in enumerate(video) if v >= 0])
        for i, v in enumerate(video):
            if v >= 0:
                t[i] += 1
                if t[i] >= lengths[v]:
                    video[i], t[i] = (pending.pop() if pending else -1), 0
    return steps


class StreamCalls:
    """While inside, the `step` and `reset_streams` of `cls` (default
    StreamingInference) record the launches of every call and, for a step,
    its start and end (to a synchronize after it) on the host's clock and
    its probabilities, kept on the card and copied to the host on
    leaving."""

    def __init__(self, torch, cls=None):
        from tmrnet_torch.eval.stream import StreamingInference

        self.torch = torch
        self.cls = cls or StreamingInference

    def __enter__(self):
        from tmrnet_torch.kernels.build import LAUNCHES

        self.steps, self.resets = [], []
        self.orig = (self.cls.step, self.cls.reset_streams)

        def recorded(fn, calls, is_step):
            def call(engine, *args, **kw):
                before = dict(LAUNCHES)
                t0 = time.perf_counter()
                out = fn(engine, *args, **kw)
                self.torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launched = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                            if v != before.get(k, 0)}
                calls.append((launched, dt,
                              out[2].detach().clone() if is_step else None,
                              t0, t0 + dt))
                return out
            return call

        self.cls.step = recorded(self.orig[0], self.steps, True)
        self.cls.reset_streams = recorded(self.orig[1], self.resets, False)
        return self

    def __exit__(self, *exc):
        self.cls.step, self.cls.reset_streams = self.orig
        self.steps = [(launched, dt, probs.float().cpu().numpy(), t0, t1)
                      for launched, dt, probs, t0, t1 in self.steps]


def split_launches(counts, part):
    """counts less part, the kernels that remain."""
    return {k: v - part.get(k, 0) for k, v in counts.items()
            if v - part.get(k, 0)}


def times(calls, per):
    return {k: v * calls for k, v in per.items()}


def score_stream(torch, card, tmp, out):
    """Phase 4i (a) and (b): `stream --max-streams SCORE_SLOTS` over phase
    4f's videos against its `test --engine video`, then `export` and
    `evaluate` of both. Returns (counts by path, numbers, ok)."""
    from tmrnet_torch import cli

    clips = sum(max(0, n - SEQ + 1) for n in TEST_LENGTHS)
    plan = slot_schedule(TEST_LENGTHS, SCORE_SLOTS)
    m = os.path.join(tmp, "m.pkl")
    common = ["--config", os.path.join(tmp, "cfg.json"), "--set",
              "model.folded=true", "--manifest", m]
    with StreamCalls(torch) as calls:
        lines, launched, dt = run_cli(
            ["stream", *common, "--torch-ckpt", os.path.join(tmp, "tmr.pth"),
             "--extractor-torch-ckpt", os.path.join(tmp, "lfb.pth"),
             "--max-streams", str(SCORE_SLOTS), "--out", out("stream.jsonl")])
    counts = {"stream_cli": launched}
    summary = json.loads(lines[-1])
    steps_ok = sum(c[0] == STEP_LAUNCHES for c in calls.steps)
    resets_ok = sum(not c[0] for c in calls.resets)
    # a reset after every step in which a video ends
    want_resets = sum(any(t == TEST_LENGTHS[v] - 1 for _, v, t in occupied)
                      for occupied in plan)
    ok = (len(calls.steps) == len(plan) == summary["steps"]
          and steps_ok == len(plan) and resets_ok == len(calls.resets)
          and len(calls.resets) == want_resets
          and launched == times(len(plan), STEP_LAUNCHES)
          and summary["predictions"] == clips
          and summary["slots"] == SCORE_SLOTS)
    print(f"  stream: {len(calls.steps)} steps (the slot plan of "
          f"{SCORE_SLOTS} slots over {TEST_LENGTHS}: {len(plan)}), "
          f"{steps_ok} with launches {STEP_LAUNCHES}, {len(calls.resets)} "
          f"slot resets, {resets_ok} with none; launches {launched}; "
          f"summary {summary} {'ok' if ok else 'FAIL'}")

    # the rows: in the plan's order, valid from each video's frame SEQ-1;
    # the recorded softmax of each valid row in bank-row order
    with open(out("stream.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    manifest = cli.load_manifest(m)
    ids = [v.video_id for v in manifest.videos]
    starts = np.cumsum([0] + [max(0, n - SEQ + 1) for n in TEST_LENGTHS])
    probs = np.full((clips, CLASSES), np.nan, np.float32)
    preds = np.full(clips, -1)
    order_ok, k = True, 0
    for step, occupied in enumerate(plan):
        for slot, v, t in occupied:
            r = rows[k]
            k += 1
            valid = t >= SEQ - 1
            order_ok &= (r["video"] == ids[v] and r["frame"] == t
                         and r["valid"] == valid
                         and (r["pred"] is None) != valid)
            if valid:
                probs[starts[v] + t - SEQ + 1] = calls.steps[step][2][slot]
                preds[starts[v] + t - SEQ + 1] = r["pred"]
    order_ok &= k == len(rows) and bool(np.isfinite(probs).all())
    with np.load(out("video.npz")) as z:
        video_preds, video_scores = z["preds"], z["scores"]
    order_ok &= bool((probs.argmax(-1) == preds).all())
    print(f"  stream rows: {len(rows)} in the plan's order, valid from "
          f"frame {SEQ - 1}, every valid row's pred the argmax of its "
          f"step's softmax {'ok' if order_ok else 'FAIL'}")
    ok &= order_ok
    ok &= probs_close("stream vs test --engine video softmax", probs,
                      video_scores)
    ok &= argmax_agrees("stream vs test --engine video", preds, video_preds,
                        video_scores, min_decided=1)
    ok &= varies("stream", preds, probs)
    # throughput from the first step's start to the last step's end: the
    # steps, the slot resets, the lazy decode and the rows between them,
    # without the command's set-up (weights, BN folding, engine)
    step_ms = np.array([c[1] for c in calls.steps]) * 1e3
    steps_s = calls.steps[-1][4] - calls.steps[0][3]
    numbers = {"stream_frames_s": sum(TEST_LENGTHS) / steps_s,
               "stream_steps_s": steps_s,
               "stream_s": dt,
               "step_ms_p50": float(np.percentile(step_ms, 50)),
               "step_ms_p99": float(np.percentile(step_ms, 99))}
    print(f"score slice: stream {sum(TEST_LENGTHS)} frames in "
          f"{steps_s:.3f} s from the first step to the last = "
          f"{numbers['stream_frames_s']:.1f} stream-frames/s (the command "
          f"{dt:.3f} s), step p50 {numbers['step_ms_p50']:.3f} ms p99 "
          f"{numbers['step_ms_p99']:.3f} ms ({SCORE_SLOTS} slots) on {card}")

    # export and evaluate of the video engine's and the stream's predictions
    reports = {}
    for name, preds_path in (("test", out("video.npz")),
                             ("stream", out("stream.jsonl"))):
        root = out(f"export_{name}")
        run_cli(["export", "--config", os.path.join(tmp, "cfg.json"),
                 "--manifest", m, "--preds", preds_path, "--pred-dir",
                 os.path.join(root, "phase"), "--gt-dir",
                 os.path.join(root, "gt-phase")])
        _, _, numbers[f"evaluate_{name}_s"] = run_cli(
            ["evaluate", "--pred-dir", os.path.join(root, "phase"),
             "--gt-dir", os.path.join(root, "gt-phase"), "--fps", "1",
             "--json-out", os.path.join(root, "report.json")])
        with open(os.path.join(root, "report.json")) as f:
            reports[name] = json.load(f)
    same = [bool(np.array_equal(preds[starts[v]:starts[v + 1]],
                                video_preds[starts[v]:starts[v + 1]]))
            for v in range(len(TEST_LENGTHS))]
    acc = [reports[n]["accuracy_per_video"] for n in ("test", "stream")]
    good = (all(acc[0][v] == acc[1][v] for v in range(len(same)) if same[v])
            and reports["test"]["videos"] == reports["stream"]["videos"] == ids)
    if all(same):
        good &= json.dumps(reports["test"]) == json.dumps(reports["stream"])
    print(f"  evaluate --fps 1 of the exports of test --engine video and "
          f"stream: predictions equal on videos {same}, their accuracies "
          f"equal there{', the reports equal' if all(same) else ''}; mean "
          f"jaccard {reports['test']['mean_jaccard']:.4f} / "
          f"{reports['stream']['mean_jaccard']:.4f}, mean accuracy "
          f"{reports['test']['mean_accuracy']:.4f} / "
          f"{reports['stream']['mean_accuracy']:.4f} "
          f"{'ok' if good else 'FAIL'}")
    return counts, numbers, ok and good


class CountedBuild:
    """While inside, build_lfb records the launches it makes."""

    def __enter__(self):
        from tmrnet_torch.kernels.build import LAUNCHES
        from tmrnet_torch.train import loop

        self.launched, self.orig = {}, loop.build_lfb

        def build(*args, **kw):
            before = dict(LAUNCHES)
            bank = self.orig(*args, **kw)
            self.launched = split_launches(dict(LAUNCHES), before)
            return bank

        loop.build_lfb = build
        return self

    def __exit__(self, *exc):
        from tmrnet_torch.train import loop

        loop.build_lfb = self.orig


def score_parity(torch, card, tmp, out, tag, argv, per_lfb_batch,
                 per_test_batch):
    """`parity` (argv) through `tmrnet_torch.cli.main` with its workdir in
    out(tag): launches of the bank build and of inference, each exact per
    clip-engine batch; its JSON against `evaluate` of its export. Returns
    (launches, seconds, ok)."""
    clips = sum(max(0, n - SEQ + 1) for n in TEST_LENGTHS)
    work = out(tag)
    with CountedBuild() as build:
        lines, launched, dt = run_cli(
            ["parity", *argv, "--workdir", work, "--json-out",
             os.path.join(work, "report.json")])
    lfb, infer = build.launched, split_launches(launched, build.launched)
    want_lfb = times(-(-clips // LFB_BATCH), per_lfb_batch)
    want_infer = times(-(-clips // TEST_BATCH), per_test_batch)
    ok = lfb == want_lfb and infer == want_infer
    print(f"  {tag}: bank build launches {lfb} (want {want_lfb}), inference "
          f"{infer} (want {want_infer}) {'ok' if ok else 'FAIL'}")
    _, _, eval_s = run_cli(
        ["evaluate", "--pred-dir", os.path.join(work, "phase"), "--gt-dir",
         os.path.join(work, "gt-phase"), "--json-out",
         os.path.join(work, "evaluate.json")])
    with open(os.path.join(work, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(work, "evaluate.json")) as f:
        evaluated = json.load(f)
    with np.load(os.path.join(work, "predictions.npz")) as z:
        scores = z["scores"]
    good = (json.dumps({k: evaluated[k] for k in report if k in evaluated})
            == json.dumps({k: v for k, v in report.items()
                           if k != "clip_accuracy"})
            and scores.shape == (clips, CLASSES)
            and bool(np.isfinite(scores).all())
            and any("Mean jaccard" in line for line in lines))
    print(f"  {tag}: JSON equal to evaluate of its export, mean jaccard "
          f"{report['mean_jaccard']:.4f}, clip accuracy "
          f"{report['clip_accuracy']:.4f}; parity {dt:.3f} s, evaluate "
          f"{eval_s:.3f} s on {card} {'ok' if good else 'FAIL'}")
    return launched, dt, ok and good


def run_score_slice(torch, seed, card, kept):
    """Phase 4i: the scoring commands at full width over the directories
    phases 4f, 4g and 4h left in `kept`. (a) `stream --max-streams 2` over
    4f's videos: 24 / 1 / 1 launches on every step and none in a slot
    reset, the steps of the slot plan, its rows against 4f's `test
    --engine video`; (b) `export` and `evaluate --fps 1` of both; (c)
    `parity` from 4f's `.pth` files, exact launches of the bank build and
    inference, its predictions against `test --engine clip --set
    memory.compat_cross_video=true` over its bank, its JSON against
    `evaluate`; (d) `parity --preset tmr-resnest50` from 4h's ResNeSt
    `.pth`, against the same with data.device_normalize=true; (e) `export-ckpt` of 4g's stage-2 checkpoint, then `test
    --torch-ckpt` on it bit for bit against `test --ckpt`. Returns
    (counts by path, numbers, ok)."""
    t0 = time.perf_counter()
    tmp, rtmp, ttmp = kept["test"], kept["resnest"], kept["train"]
    out = lambda name: os.path.join(tmp, name)
    counts, numbers, ok = score_stream(torch, card, tmp, out)
    counts_p = {}

    # (c) parity from 4f's .pth, against the clip engine over its bank
    common = ["--config", out("cfg.json"), "--set", "model.folded=true",
              "--manifest", out("m.pkl")]
    weights = ["--torch-ckpt", out("tmr.pth"), "--extractor-torch-ckpt",
               out("lfb.pth")]
    counts_p["parity"], numbers["parity_s"], good = score_parity(
        torch, card, tmp, out, "parity", common + weights, LFB_BATCH_LAUNCHES,
        TEST_BATCH_LAUNCHES)
    ok &= good
    _, counts_p["test-compat"], _ = run_cli(
        ["test", *common, *weights, "--engine", "clip", "--set",
         "memory.compat_cross_video=true", "--lfb", out("parity/lfb.npz"),
         "--out", out("compat.npz")])
    with np.load(out("compat.npz")) as z, \
            np.load(out("parity/predictions.npz")) as w:
        err = float(np.abs(z["scores"] - w["scores"]).max())
        good = (np.array_equal(z["preds"], w["preds"])
                and np.array_equal(z["rows"], w["rows"]) and err <= RESUME_TOL)
    print(f"  parity vs test --engine clip --set memory.compat_cross_video="
          f"true over its bank: predictions equal, softmax max_abs_err "
          f"{err:.3g} (limit {RESUME_TOL}) {'ok' if good else 'FAIL'}")
    ok &= good

    # (d) parity on the ResNeSt trunk, from the preset, which normalizes
    # on the host (data.device_normalize=false); held against the same
    # parity on the uint8 path that normalizes on the card, as 4f and 4h
    # run, bank included
    rout = lambda n: os.path.join(rtmp, n)
    resnest = ["--preset", "tmr-resnest50", "--set", "model.folded=true",
               "--manifest", rout("m.pkl"), "--torch-ckpt", rout("tmr.pth"),
               "--extractor-torch-ckpt", rout("lfb.pth")]
    counts_p["parity-resnest"], numbers["parity_resnest_s"], good = \
        score_parity(torch, card, rtmp, rout, "parity-resnest", resnest, {},
                     RESNEST_LAUNCHES)
    ok &= good
    counts_p["parity-resnest-u8"], numbers["parity_resnest_u8_s"], good = \
        score_parity(torch, card, rtmp, rout, "parity-resnest-u8",
                     resnest + ["--set", "data.device_normalize=true"], {},
                     RESNEST_LAUNCHES)
    ok &= good
    with np.load(rout("parity-resnest/predictions.npz")) as z, \
            np.load(rout("parity-resnest-u8/predictions.npz")) as w:
        good = bool(np.array_equal(z["rows"], w["rows"]))
        print(f"  parity-resnest vs parity-resnest-u8: rows equal "
              f"{'ok' if good else 'FAIL'}")
        good &= probs_close("parity-resnest (host normalize) vs "
                            "parity-resnest-u8 (card normalize) softmax",
                            z["scores"], w["scores"])
        good &= argmax_agrees("parity-resnest vs parity-resnest-u8",
                              z["preds"], w["preds"], w["scores"],
                              min_decided=1)
    ok &= good

    # (e) export-ckpt of 4g's stage-2 checkpoint, and test from the .pth
    tout = lambda name: os.path.join(ttmp, name)
    c = ["--config", tout("train_cfg.json")]
    lines, _, numbers["export_ckpt_s"] = run_cli(
        ["export-ckpt", *c, "--ckpt", tout("ck2"), "--out", tout("ck2.pth")])
    scores = {}
    for name, w in (("ckpt", ["--ckpt", tout("ck2")]),
                    ("pth", ["--torch-ckpt", tout("ck2.pth")])):
        _, counts_p[f"test-{name}-export"], _ = run_cli(
            ["test", *c, "--set", "model.folded=true", "--manifest",
             tout("val.pkl"), *w, "--lfb", tout("bank_val.npz"), "--out",
             tout(f"{name}.npz")])
        with np.load(tout(f"{name}.npz")) as z:
            scores[name] = (z["preds"], z["scores"])
    good = (lines[-1].startswith("wrote ")
            and np.array_equal(scores["pth"][0], scores["ckpt"][0])
            and np.array_equal(scores["pth"][1], scores["ckpt"][1])
            and counts_p["test-pth-export"] == counts_p["test-ckpt-export"])
    print(f"  export-ckpt of the stage-2 checkpoint ({lines[-1]}) in "
          f"{numbers['export_ckpt_s']:.3f} s, test --torch-ckpt on it vs "
          f"test --ckpt: {len(scores['pth'][0])} clips bit for bit "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    counts.update(counts_p)
    print(f"score slice: {json.dumps(numbers)} in "
          f"{time.perf_counter() - t0:.1f} s on {card} "
          f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return counts, numbers, ok


# Phase 4k, the multi-process slice: the global batch of (b) and its
# steps, the heads and dtypes of (b) (the TMR head in bf16, the main
# path's dtype, and head nl_only in f32; 4q (b) holds the TMR head's step
# in f32), how long a rank may take, and the determinism (a)'s two runs
# share.
MULTI_CLIPS, MULTI_STEPS, MULTI_LR, MULTI_TIMEOUT = 8, 2, 1e-3, 300
# 4k (a)'s epochs (one checkpoint an epoch; the whole script's time)
NCCL_EPOCHS = 1
MULTI_HEADS = (("tmr", "bfloat16"), ("nl_only", "float32"))
DETERMINISTIC = ("import runpy, sys, torch; "
                 "torch.backends.cudnn.deterministic = True; "
                 "torch.backends.cudnn.benchmark = False; "
                 "sys.argv = ['tmrnet_torch'] + sys.argv[1:]; "
                 "runpy.run_module('tmrnet_torch', run_name='__main__')")
# A rank of (c): a gloo group shared with the other rank on one card, then
# the command, then its launches on stderr.
CLI_RANK = ("import json, sys; "
            "from tmrnet_torch.parallel.mesh import initialize_multihost; "
            "initialize_multihost(sys.argv[1], 2, int(sys.argv[2]), "
            "device='cuda:0', backend='gloo'); "
            "from tmrnet_torch import cli; "
            "from tmrnet_torch.kernels.build import LAUNCHES; "
            "rc = cli.main(sys.argv[3:]); "
            "print(json.dumps({'launches': dict(LAUNCHES)}), file=sys.stderr); "
            "sys.exit(rc)")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def add_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def json_lines(text, key):
    """The JSON objects among text's lines that have `key`."""
    out = []
    for ln in text.splitlines():
        try:
            d = json.loads(ln) if ln.startswith("{") else None
        except ValueError:
            d = None
        if isinstance(d, dict) and key in d:
            out.append(d)
    return out


def run_ranks(cmds, timeout=MULTI_TIMEOUT, env=None):
    """Start every command at once; (returncodes, stdouts, stderrs)."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([p.returncode for p in procs], [o for o, _ in outs],
            [e for _, e in outs])


def multi_nccl(torch, card, tmp):
    """Phase 4k (a): `python -m tmrnet_torch train-tmr` over 4g's directory
    for NCCL_EPOCHS epochs as rank 0 of a world of 1 under torchrun's
    variables and mesh.multihost, beside the same command without it, both
    with cuDNN's deterministic algorithms; the backend must be NCCL and
    the final weights equal bit for bit. Returns ok."""
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    out = lambda name: os.path.join(tmp, name)
    argv = ["train-tmr", "--config", out("train_cfg.json"),
            "--train-manifest", out("train.pkl"), "--val-manifest",
            out("val.pkl"), "--lfb", out("bank_train.npz"), "--val-lfb",
            out("bank_val.npz"), "--stage1-ckpt", out("ck1"), "--set",
            f"train.epochs={NCCL_EPOCHS}"]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    cmd = lambda name, extra: [
        sys.executable, "-c", DETERMINISTIC, *argv, *extra, "--set",
        f"train.checkpoint_dir={out('ck_' + name)}", "--log-dir",
        out("log_" + name)]
    t0 = time.perf_counter()
    rcs, outs, errs = run_ranks(
        [cmd("nccl", ["--set", "mesh.multihost=true"]), cmd("plain", [])],
        env=env)
    dt = time.perf_counter() - t0
    ok = rcs == [0, 0]
    mesh = (json_lines(errs[0], "mesh") or [{"mesh": {}}])[-1]["mesh"]
    ok &= mesh.get("backend") == "nccl" and mesh.get("world") == 1
    same, steps = False, None
    if ok:
        a, b = CheckpointManager(out("ck_nccl")), CheckpointManager(
            out("ck_plain"))
        steps = (a.all_steps(), b.all_steps())
        va = CheckpointManager._load(a._step_dir(a.latest_step()))
        vb = CheckpointManager._load(b._step_dir(b.latest_step()))
        flat = lambda t, p="": ([(p, t)] if not isinstance(t, dict) else
                                [x for k in sorted(t)
                                 for x in flat(t[k], f"{p}/{k}")])
        la, lb = flat(va["variables"]), flat(vb["variables"])
        same = (steps[0] == steps[1] and [k for k, _ in la]
                == [k for k, _ in lb]
                and all(np.array_equal(x, y) for (_, x), (_, y)
                        in zip(la, lb)))
        ok &= same
    print(f"  (a) train-tmr, {NCCL_EPOCHS} epochs, as one rank "
          f"(RANK=0 WORLD_SIZE=1 LOCAL_RANK=0, mesh.multihost) beside the "
          f"same command without it, at once, in {dt:.1f} s: exits {rcs}, "
          f"mesh {mesh} (want backend nccl), checkpoint steps {steps}, "
          f"final weights bit for bit equal: {same} "
          f"{'ok' if ok else 'FAIL'}")
    if rcs != [0, 0]:
        for e in errs:
            print(e[-2000:])
    return ok


def multi_steps(torch, seed, head, dtype, mesh=None):
    """MULTI_STEPS SGD steps of the full-width model (`train_model_config`,
    dropout 0) with head `head` (stage 1 or 2) in `dtype` on the card,
    over global batches of MULTI_CLIPS clips (the rows of this rank's data
    index under `mesh`, the model's slices under its model axis): (the
    losses summed over the data ranks, the whole parameters' deltas from
    the start after each step, the running statistics, launches, each
    step's ms, under `mesh` the ms of one all-reduce of gradient-sized
    tensors, as the state makes it once a step, and the shapes of the
    parameters this rank holds a slice of)."""
    from tmrnet_torch.config import DataConfig, TrainConfig
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.models.tmrnet import build_model
    from tmrnet_torch.parallel.mesh import all_reduce_host, process_local_bounds
    from tmrnet_torch.parallel.tensor import shard_model_, shard_of
    from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

    device = torch.device("cuda", 0) if mesh is None else mesh.device
    cfg = train_model_config(head, "cuda", dtype)
    model = build_model(cfg, device=device)
    model.load_state_dict(from_jax_variables(random_variables(
        train_model_config(head, "cpu"), seed + 21)))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    shard_model_(model, mesh)
    state = TrainState(model, make_optimizer(
        TrainConfig(optimizer="sgd", lr=MULTI_LR, momentum=0.9,
                    weight_decay=5e-4), model, slow_modules_for_head(head)),
        mesh=mesh)
    stage1 = head == "stage1"
    step, _ = (make_stage1_steps if stage1 else make_stage2_steps)(
        prep=DevicePrep(DataConfig(device_normalize=True), cfg.compute_dtype,
                        device), mesh=mesh)
    lo, hi = ((0, MULTI_CLIPS) if mesh is None else
              process_local_bounds(MULTI_CLIPS, mesh.data_index, mesh.dp))
    losses, ms, deltas = [], [], []
    torch.cuda.synchronize(device)
    reset_launches()
    for i in range(MULTI_STEPS):
        clips, memory, labels = (t[lo:hi].to(device) for t in train_batch(
            torch, seed + 60 + i, MULTI_CLIPS))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m = step(state, *((clips,) if stage1 else (clips, memory)), labels,
                 torch.Generator(device=device).manual_seed(i))
        loss = np.asarray([float(m["loss"])])
        ms.append((time.perf_counter() - t0) * 1e3)
        if mesh is not None:
            loss = all_reduce_host(loss, mesh, data_only=True)
        losses.append(float(loss[0]))
        whole = state.whole_state()[0]
        deltas.append({k: (whole[k].detach() - v).float().cpu()
                       for k, v in before.items()})
    counts = dict(LAUNCHES)
    stats = {k: v.float().cpu() for k, v in state.whole_state()[0].items()
             if "running" in k}
    sliced = {k: list(p.shape) for k, p in model.named_parameters()
              if shard_of(p) is not None}
    reduce_ms = None
    if mesh is not None:
        from tmrnet_torch.parallel.mesh import all_reduce_sum_

        grads = [p.detach().clone() for p in state.params]
        all_reduce_sum_(grads, mesh)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(3):
            all_reduce_sum_(grads, mesh)
        torch.cuda.synchronize(device)
        reduce_ms = (time.perf_counter() - t0) / 3 * 1e3
    del state, model, before
    torch.cuda.empty_cache()
    return losses, deltas, stats, counts, ms, reduce_ms, sliced


def multi_rank(torch, seed, rank, port, out_dir, world=2, backend="gloo",
               mp=1, cli_argv=None):
    """Phase 4k (b) (4o (a) where mp > 1), one rank of `world` on card
    rank % cards (all of them on card 0 on a one-card machine) over
    `backend`, as a (world / mp) x mp grid: the steps of each of
    MULTI_HEADS (MESH_HEADS) on its rows; each saves what they leave and
    prints its losses, launches, step ms and its sliced parameters'
    shapes, and (4k) how long host gathers of a 518 x 512 bank and of (4,
    291, 7) softmax rows take. cli_argv (4o (b)): then a command through
    `tmrnet_torch.cli.main` on this rank's card, in the group the steps
    used, with its exit code, launches and seconds in the report."""
    from tmrnet_torch.config import MeshConfig
    from tmrnet_torch.parallel.mesh import (all_gather_host,
                                            initialize_multihost, make_mesh,
                                            shutdown)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = initialize_multihost(
        f"127.0.0.1:{port}", world, rank,
        device=f"cuda:{rank % torch.cuda.device_count()}", backend=backend,
        timeout=MULTI_TIMEOUT)
    mesh = make_mesh(MeshConfig(model_parallel=mp), dev)
    report = {"multi_rank": rank, "backend": mesh.backend,
              "index": [mesh.data_index, mesh.model_index], "heads": {}}
    for head, dtype in (MESH_HEADS if mp > 1 else MULTI_HEADS):
        losses, deltas, stats, counts, ms, reduce_ms, sliced = multi_steps(
            torch, seed, head, dtype, mesh)
        torch.save({"deltas": deltas, "stats": stats},
                   os.path.join(out_dir, f"rank{rank}_{head}.pt"))
        report["heads"][head] = {"losses": losses, "launches": counts,
                                 "step_ms": ms, "grad_reduce_ms": reduce_ms,
                                 "sliced": sliced}
    if cli_argv:
        from tmrnet_torch import cli
        from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(cli_argv + ["--device", str(dev)])
        report["cli"] = {"rc": rc, "launches": dict(LAUNCHES),
                         "seconds": time.perf_counter() - t0}
    if mp > 1:
        print(json.dumps(report), flush=True)
        shutdown()
        return 0
    gathers = {}
    for name, shape in (("bank 518x512", (518, 512)),
                        ("probs 4x291x7", (4, 291, 7))):
        a = np.zeros(shape, np.float32)
        all_gather_host(a, mesh)
        t0 = time.perf_counter()
        for _ in range(5):
            all_gather_host(a, mesh)
        gathers[name] = (time.perf_counter() - t0) / 5 * 1e3
    report["gather_ms"] = gathers
    print(json.dumps(report), flush=True)
    shutdown()
    return 0


def multi_train(torch, seed, card, tmp, world=2, backend="gloo", mp=1,
                cli_argv=None, refs=None):
    """Phase 4k (b): `world` ranks over `backend` (by default two sharing
    the card over gloo: NCCL refuses two ranks on one device; with
    `--multi-only` one card a rank over NCCL) take MULTI_STEPS steps of
    the full-width model (ResNet-50 224x224, hidden 512, window 30) at a
    global batch of MULTI_CLIPS clips of SEQ frames, split over them,
    against the same steps in this process over the whole batch: TMR in
    bf16 (the main path's dtype) by the losses within STEP_LOSS_TOL, the statistics
    within TOL and the first step's aggregates within
    `step_check.AGG_LIMITS`; nl_only in f32 by `step_check`'s f32 limits:
    the losses and statistics within STEP_F32_TOL and each delta of the
    first step within TENSOR_LIMIT. The second step's deltas are printed,
    not held: it starts from weights that differ by rounding, and it
    amplifies that (on the CPU at 32x32, weights perturbed by 1e-7
    relative move its head's deltas by 0.107, against 3.5e-5 after the
    first step). The two ranks' deltas equal; the launches of each rank.
    With mp > 1 (phase 4o (a)) the ranks form a (world / mp) x mp grid and
    take MESH_HEADS' steps, their whole deltas (each rank's slices
    gathered) held by the same rules, and bit-equal across the ranks:
    every replicated parameter's and every slice's; cli_argv: a command
    each rank then runs (4o (b)), whose reports and `mesh` lines land in
    the numbers. refs: the one-process steps by (seed, head, dtype), read
    and filled (4o (a) reuses 4k (b)'s tmr steps). Returns (launches of
    all ranks, numbers, ok)."""
    from tmrnet_torch.train.step_check import (AGG_LIMITS, TENSOR_LIMIT,
                                               aggregate, distance,
                                               rounding_only, worst_by_group)

    port = free_port()
    tag = "(a)" if mp > 1 else "(b)"
    heads = MESH_HEADS if mp > 1 else MULTI_HEADS
    t0 = time.perf_counter()
    rcs, outs, errs = run_ranks([
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--multi-rank", str(r), "--multi-port", str(port), "--multi-dir",
         tmp, "--multi-world", str(world), "--multi-backend", backend,
         "--multi-mp", str(mp)]
        + (["--multi-cli", json.dumps(cli_argv)] if cli_argv else [])
        for r in range(world)])
    dt = time.perf_counter() - t0
    if any(rcs):
        for e in errs:
            print(e[-3000:])
        print(f"  {tag} {world} ranks over {backend} exited {rcs} FAIL")
        return {}, {}, False
    reports = [json_lines(o, "multi_rank")[-1] for o in outs]
    ok, counts, numbers = True, {}, {"ranks_s": dt}
    if mp > 1:
        numbers["index"] = [r["index"] for r in reports]
    if cli_argv:
        numbers["cli"] = [r["cli"] for r in reports]
        numbers["mesh_lines"] = [json_lines(e, "mesh")[-1]["mesh"]
                                 for e in errs]
    refs = {} if refs is None else refs
    for head, dtype in heads:
        t1 = time.perf_counter()
        reused = (seed, head, dtype) in refs
        if not reused:
            refs[(seed, head, dtype)] = multi_steps(torch, seed, head, dtype)
        want = refs[(seed, head, dtype)]
        w_losses, w_deltas, w_stats, w_counts, w_ms = want[:5]
        got = [torch.load(os.path.join(tmp, f"rank{r}_{head}.pt"))
               for r in range(world)]
        same = all(torch.equal(a[k], b[k]) for other in got[1:] for a, b in
                   zip(got[0]["deltas"], other["deltas"]) for k in a)
        losses = reports[0]["heads"][head]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))
        st = max(float((got[0]["stats"][k] - w).abs().max()
                       / max(float(w.abs().max()), 1e-12))
                 for k, w in w_stats.items())
        want_launch = ({"time_conv": MULTI_STEPS, "nl_attention": MULTI_STEPS}
                       if head == "tmr" else {} if head == "stage1"
                       else {"nl_attention": MULTI_STEPS})
        launches = [r["heads"][head]["launches"] for r in reports]
        counts = add_counts(counts, *launches)
        aggs = [aggregate(g, w) for g, w in zip(got[0]["deltas"], w_deltas)]
        dists = [{k: distance(k, g[k], w) for k, w in ws.items()
                  if not rounding_only(k)}
                 for g, ws in zip(got[0]["deltas"], w_deltas)]
        worst = [worst_by_group(d) for d in dists]
        # each slice of a sliced parameter (from its rank) against the
        # same slice of the one-process step's delta
        slices = {}
        for k, shape in (reports[0]["heads"][head].get("sliced") or {}).items():
            d = next(i for i, (a, b) in enumerate(zip(shape, w_deltas[0][k]
                                                      .shape)) if a != b)
            n = shape[d]
            for j in range(mp):
                slices[f"{k}[{j}]"] = distance(
                    k, got[0]["deltas"][0][k].narrow(d, j * n, n),
                    w_deltas[0][k].narrow(d, j * n, n))
        if slices:
            print(f"  {tag} {head}: step 1's delta of each rank's slice vs "
                  f"the one-process slice {json.dumps(slices)}")
        if dtype == "float32":
            good_slices = all(v <= TENSOR_LIMIT for v in slices.values())
        else:
            good_slices = all(np.isfinite(v) for v in slices.values())
        if dtype == "float32":
            good = (rel <= STEP_F32_TOL and st <= STEP_F32_TOL
                    and all(d <= TENSOR_LIMIT for d in dists[0].values()))
            rule = (f"losses and statistics within {STEP_F32_TOL}, each "
                    f"delta of step 1 within {TENSOR_LIMIT}")
        else:
            limits = AGG_LIMITS["resnet50"]
            good = (rel <= STEP_LOSS_TOL and st <= TOL
                    and all(aggs[0][g] <= limits[g] for g in aggs[0]))
            rule = (f"losses within {STEP_LOSS_TOL}, statistics within {TOL}, "
                    f"step 1's aggregates within {json.dumps(limits)}")
        good &= same and good_slices and all(c == want_launch
                                             for c in launches)
        ms = [r["heads"][head]["step_ms"] for r in reports]
        reduce_ms = [r["heads"][head]["grad_reduce_ms"] for r in reports]
        numbers[head] = {"rank_step_ms": ms, "one_process_step_ms": w_ms,
                         "grad_reduce_ms": reduce_ms, "aggregates": aggs}
        if mp > 1:
            numbers[head]["sliced"] = [r["heads"][head]["sliced"]
                                       for r in reports]
            print(f"  {tag} {head}: each rank's sliced parameters "
                  f"{numbers[head]['sliced']}")
        print(f"  {tag} {head} {dtype}, {world} ranks as a "
              f"{world // mp} x {mp} grid, {MULTI_CLIPS // (world // mp)} "
              f"clips a data rank, over {backend} against one process x "
              f"{MULTI_CLIPS}: "
              f"losses {losses} vs {w_losses} (rel {rel:.3g}), running "
              f"stats /max {st:.3g}, aggregates by step {json.dumps(aggs)}, "
              f"worst tensors by step {worst}; {rule}; "
              f"the ranks' deltas equal: {same}; launches per rank "
              f"{launches} (want {want_launch}); step ms per rank {ms} (of "
              f"which one all-reduce of the gradients, ms {reduce_ms}), one "
              f"process {w_ms} (its steps "
              f"{'those of 4k (b)' if reused else f'{time.perf_counter() - t1:.1f} s'}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    if mp > 1:
        print(f"  {tag} ranks' run {dt:.1f} s on {card}")
        return counts, numbers, ok
    numbers["gather_ms"] = [r["gather_ms"] for r in reports]
    print(f"  (b) host gathers over the CPU group, ms per call per rank "
          f"{numbers['gather_ms']}; ranks' run {dt:.1f} s on {card}")
    return counts, numbers, ok


def multi_eval(torch, card, tdir, tmp):
    """Phase 4k (c): `test --engine corpus` and `build-lfb --engine video`
    over 4f's videos and `.pth` files, as two ranks sharing the card over
    gloo under mesh.multihost: the predictions equal 4f's one-process
    `test --engine corpus` exactly, its softmax and 4f's video-engine bank
    within TOL; rank 0 alone reports. Returns (launches of both ranks,
    seconds, ok)."""
    src = lambda name: os.path.join(tdir, name)
    common = ["--config", src("cfg.json"), "--set", "model.folded=true",
              "--manifest", src("m.pkl"), "--set", "mesh.multihost=true"]
    jobs = {
        "test": ["test", *common, "--torch-ckpt", src("tmr.pth"),
                 "--extractor-torch-ckpt", src("lfb.pth"), "--engine",
                 "corpus", "--out", os.path.join(tmp, "corpus_mh.npz")],
        "build-lfb": ["build-lfb", *common, "--torch-ckpt", src("lfb.pth"),
                      "--engine", "video", "--out",
                      os.path.join(tmp, "bank_mh.npz")],
    }
    ok, counts, seconds = True, {}, {}
    for name, argv in jobs.items():
        port = free_port()
        t0 = time.perf_counter()
        rcs, outs, errs = run_ranks([
            [sys.executable, "-c", CLI_RANK, f"127.0.0.1:{port}", str(r),
             *argv] for r in range(2)])
        seconds[name] = time.perf_counter() - t0
        good = rcs == [0, 0]
        if good:
            launches = [json_lines(e, "launches")[-1]["launches"]
                        for e in errs]
            counts = add_counts(counts, *launches)
            reports = [bool(o.strip()) for o in outs]
            good = reports == [True, False]
            print(f"  (c) {name} over 2 ranks: exits {rcs}, launches per rank "
                  f"{launches}, rank 0 alone reports: {good}, "
                  f"{seconds[name]:.1f} s")
        else:
            for e in errs:
                print(e[-3000:])
        ok &= good
    if ok:
        with np.load(os.path.join(tmp, "corpus_mh.npz")) as z, \
                np.load(src("corpus.npz")) as w:
            same = np.array_equal(z["preds"], w["preds"])
            print(f"  (c) test --engine corpus over 2 ranks: predictions "
                  f"equal 4f's one-process run: {same} "
                  f"({int((z['preds'] != w['preds']).sum())} of "
                  f"{len(w['preds'])} differ) {'ok' if same else 'FAIL'}")
            ok &= same and probs_close(
                "test --engine corpus over 2 ranks vs 4f softmax",
                z["scores"], w["scores"])
            ok &= np.array_equal(z["rows"], w["rows"])
        with np.load(os.path.join(tmp, "bank_mh.npz")) as z, \
                np.load(src("bank_video.npz")) as w:
            ok &= np.array_equal(z["first_rows"], w["first_rows"])
            ok &= compare(torch, "build-lfb --engine video over 2 ranks vs "
                          "4f's bank", torch.from_numpy(z["features"]),
                          torch.from_numpy(w["features"]))[1]
    return counts, seconds, ok


def run_multi_slice(torch, seed, card, kept, refs=None):
    """Phase 4k: the multi-process slice, over the directories 4f and 4g
    leave in `kept`: (a) `multi_nccl`, (b) `multi_train` (its one-process
    steps kept in `refs`), (c) `multi_eval`. Returns (counts by path,
    numbers, ok)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ok = multi_nccl(torch, card, kept["train"])
    with phase_dir("multi") as tmp:
        train_counts, numbers, ok_b = multi_train(torch, seed, card, tmp,
                                                  refs=refs)
        eval_counts, numbers["commands_s"], ok_c = multi_eval(
            torch, card, kept["test"], tmp)
    ok &= ok_b and ok_c
    counts = add_counts(train_counts, eval_counts)
    good = counts.get("time_conv", 0) > 0 and counts.get("nl_attention", 0) > 0
    numbers["seconds"] = time.perf_counter() - t0
    print(f"multi slice: launches over every rank {counts}, "
          f"{numbers['seconds']:.1f} s on {card} "
          f"{'ok' if ok and good else 'FAIL'}")
    return {"multi": counts}, numbers, ok and good


# Phase 4o, the mesh slice: the heads of (a) and their dtypes (tmr in
# bf16, the main path's dtype; stage 1 in f32 holds each tensor); the model
# axis of (a) and (b); the sequence-parallel shards of (c); the frames of
# bank_features' positions in (c).
MESH_HEADS = (("tmr", "bfloat16"), ("stage1", "float32"))
MESH_MP, MESH_SHARDS, MESH_POSITIONS = 2, 2, 64


def workflow_argv(tdir, tmp):
    """Phase 4o (b)'s command: `train-tmr` for one epoch over 4g's split
    (the directory `tdir`) as the grid, under mesh.multihost with a model
    axis of MESH_MP, its checkpoints under tmp/ck_tp."""
    src = lambda name: os.path.join(tdir, name)
    return ["train-tmr", "--config", src("train_cfg.json"),
            "--train-manifest", src("train.pkl"), "--val-manifest",
            src("val.pkl"), "--lfb", src("bank_train.npz"), "--val-lfb",
            src("bank_val.npz"), "--stage1-ckpt", src("ck1"), "--set",
            "train.epochs=1", "--set",
            f"train.checkpoint_dir={os.path.join(tmp, 'ck_tp')}",
            "--log-dir", os.path.join(tmp, "log_tp"), "--set",
            "mesh.multihost=true", "--set", f"mesh.model_parallel={MESH_MP}"]


def mesh_workflow(torch, card, tdir, tmp, ranks):
    """Phase 4o (b): `workflow_argv`'s `train-tmr`, which (a)'s two ranks
    ran after their steps through `tmrnet_torch.cli.main` in the 1 x 2
    grid they share the card in (`ranks`: (a)'s numbers, with each rank's
    report and `mesh` line), then `test --ckpt` in this process on its
    checkpoint: both exit 0, each rank's mesh line names its model index,
    each rank launches 1 time_conv and 1 nl_attention a train step and a
    val batch, the epoch's losses are finite, and the checkpoint holds
    whole tensors (the one-process model's shapes), which `test` reads.
    Returns (launches, seconds, ok)."""
    from tmrnet_torch.config import ExperimentConfig
    from tmrnet_torch.models.convert import from_jax_variables
    from tmrnet_torch.models.tmrnet import state_shapes
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    src = lambda name: os.path.join(tdir, name)
    ck = os.path.join(tmp, "ck_tp")
    _, _, steps, val_batches = train_split()
    want = {"time_conv": steps + val_batches,
            "nl_attention": steps + val_batches}
    reports, meshes = ranks.get("cli"), ranks.get("mesh_lines")
    if not reports:
        print("  (b) train-tmr over the grid: no rank report FAIL")
        return {}, {}, False
    rcs = [r["rc"] for r in reports]
    launches = [r["launches"] for r in reports]
    seconds = {"train-tmr": [r["seconds"] for r in reports]}
    counts = add_counts(*launches)
    good = (rcs == [0] * MESH_MP
            and [m["model_index"] for m in meshes] == list(range(MESH_MP))
            and all(c == want for c in launches))
    metrics = latest_metrics(ck)
    finite = all(np.isfinite(metrics.get(k, np.nan))
                 for k in ("val_loss", "val_acc", "train_acc"))
    saved = CheckpointManager._load(CheckpointManager(ck)._step_dir(
        CheckpointManager(ck).latest_step()))
    got = {k: tuple(v.shape) for k, v in
           from_jax_variables(saved["variables"]).items()}
    with open(src("train_cfg.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    shapes = state_shapes(dataclasses.replace(cfg.model, head="tmr"))
    drop = lambda d: {k: v for k, v in d.items()
                      if not k.endswith("num_batches_tracked")}
    whole = drop(got) == drop(shapes)
    print(f"  (b) train-tmr, 1 epoch over a 1 x {MESH_MP} grid of gloo "
          f"ranks on one card (the ranks of (a)), seconds per rank "
          f"{seconds['train-tmr']}: exits {rcs}, mesh lines {meshes}, "
          f"launches per rank {launches} (want {want}), latest metrics "
          f"{metrics} (finite: {finite}), checkpoint of whole tensors: "
          f"{whole} {'ok' if good and finite and whole else 'FAIL'}")
    ok = good and finite and whole
    lines, test_counts, seconds["test"] = run_cli(
        ["test", "--config", src("train_cfg.json"), "--set",
         "model.folded=true", "--manifest", src("val.pkl"), "--ckpt", ck,
         "--lfb", src("bank_val.npz"), "--out",
         os.path.join(tmp, "preds_tp.npz")])
    acc = json.loads(lines[-1])["clip_accuracy"]
    good = bool(np.isfinite(acc)) and test_counts.get("time_conv", 0) > 0
    print(f"  (b) one-process test --ckpt on the grid's checkpoint: clip "
          f"accuracy {acc}, launches {test_counts}, {seconds['test']:.1f} s "
          f"{'ok' if good else 'FAIL'}")
    return add_counts(counts, test_counts), seconds, ok and good


def sp_want(engine, blocks, fused_kernel, even_only):
    """The bottleneck launches by (kernel, card) of the trunks over frame
    blocks of `blocks` frames in the sequence-parallel pass: each trunk
    chunk of a block cut into the shards (a block that does not divide
    whole on the first card, where even_only), each shard's identity
    blocks on its card, for both trunks."""
    per_trunk = ({"fused_bottleneck": 12} if fused_kernel == "block" else
                 {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2})
    want = {}
    first = engine.shards[0][0].index
    for b in blocks:
        step = engine.trunk_chunk(b, (IMG, IMG))
        for i in range(0, b, step):
            n = min(step, b - i)
            if even_only and b % len(engine.shards):
                parts = [(first, n)]
            else:
                sizes = [len(a) for a in np.array_split(np.arange(n),
                                                        len(engine.shards))]
                parts = [(d.index, m) for (d, _, _), m in
                         zip(engine.shards, sizes) if m]
            for dev, _ in parts:
                for k, v in per_trunk.items():
                    want[(k, dev)] = want.get((k, dev), 0) + 2 * v
    return want


def mesh_sp(torch, seed, card, devices):
    """Phase 4o (c): the sequence-parallel pass at full width over
    `devices`, against the one-device engine in this call: run_video on
    4c's 1,500-frame video (block path), bank_features at 64 of its
    positions, and run_corpus over 4c's videos (tiled path), each within
    TOL with 4c's argmax rule, the bottleneck launches by card as the
    chunk plan gives them, and frames/s of both engines, each timed call
    after one uncounted call of the same shapes (a card's first call of a
    shape picks its cuDNN algorithms). Returns (launches by kernel,
    numbers, ok)."""
    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.kernels.build import (LAUNCHES, LAUNCHES_BY_DEVICE,
                                            reset_launches)

    ecfg, weights = engine_setup(seed)
    rng = np.random.default_rng(seed + 3)
    lengths = VIDEO_LENGTHS
    videos = [rng.integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
              for n in lengths]
    ok, counts, numbers = True, {}, {"devices": [str(d) for d in devices]}
    engines = {}
    for kernel in ("block", "tiled"):
        engines[kernel] = (
            VideoInference(ecfg, *weights, fused_kernel=kernel),
            VideoInference(ecfg, *weights, fused_kernel=kernel,
                           devices=devices))
        for e in engines[kernel]:               # warm-up, not counted
            e.run_corpus([videos[0][:64], videos[2]], chunk=64)
    torch.cuda.synchronize()

    def timed(fn):
        for d in set(devices):
            torch.cuda.synchronize(d)
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        for d in set(devices):
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0, dict(LAUNCHES), {
            f"{k}@cuda:{d}": v for (k, d), v in LAUNCHES_BY_DEVICE.items()
            if k.startswith("fused_bottleneck")}

    one, sp = engines["block"]
    for e in (one, sp):                 # the timed call's shapes, uncounted
        e.run_video(videos[0])
    (w_preds, w_probs), w_dt, _, _ = timed(lambda: one.run_video(videos[0]))
    (preds, probs), dt, got, by_dev = timed(lambda: sp.run_video(videos[0]))
    counts = add_counts(counts, got)
    want = {f"{k}@cuda:{d}": v for (k, d), v in
            sp_want(sp, [lengths[0]], "block", False).items()}
    good = (by_dev == want and got.get("time_conv") == 1
            and got.get("nl_attention") == 1)
    numbers["run_video"] = {"frames_s": lengths[0] / dt,
                            "one_device_frames_s": lengths[0] / w_dt,
                            "trunk_chunk": sp.trunk_chunk(lengths[0],
                                                          (IMG, IMG))}
    print(f"  (c) run_video {lengths[0]} frames over {numbers['devices']}: "
          f"{lengths[0] / dt:.1f} frames/s (one device "
          f"{lengths[0] / w_dt:.1f}), trunk chunk "
          f"{numbers['run_video']['trunk_chunk']}; bottleneck launches by "
          f"card {by_dev} (want {want}), {got} "
          f"{'ok' if good else 'FAIL'}")
    ok &= probs_close("SP run_video vs one device", probs, w_probs) and good
    ok &= argmax_agrees("SP run_video vs one device", preds, w_preds,
                        w_probs, min_decided=1)

    k = lengths[0] - SEQ + 1
    positions = torch.from_numpy(np.unique(np.concatenate(
        [[0, 1, k - 1], rng.choice(np.arange(2, k - 1),
                                   min(MESH_POSITIONS - 3, k - 3),
                                   replace=False)])))
    feats, _, _, _ = timed(lambda: sp.bank_features(videos[0]))
    w_feats = one.bank_features(videos[0])
    ok &= compare(torch, f"SP bank_features vs one device at "
                  f"{len(positions)} positions",
                  feats[positions.to(feats.device)],
                  w_feats[positions.to(w_feats.device)])[1]

    one, sp = engines["tiled"]
    total = sum(lengths)
    chunk = min(2048, total)
    blocks = [chunk] * -(-total // chunk)
    for e in (one, sp):
        e.run_corpus(videos, chunk=chunk)
    w_corpus, w_dt, _, _ = timed(lambda: one.run_corpus(videos, chunk=chunk))
    corpus, dt, got, by_dev = timed(lambda: sp.run_corpus(videos,
                                                          chunk=chunk))
    counts = add_counts(counts, got)
    want = {f"{k}@cuda:{d}": v for (k, d), v in
            sp_want(sp, blocks, "tiled", True).items()}
    good = by_dev == want
    numbers["run_corpus"] = {"frames_s": total / dt,
                             "one_device_frames_s": total / w_dt}
    print(f"  (c) run_corpus {lengths} in blocks of {chunk} over "
          f"{numbers['devices']}: {total / dt:.1f} frames/s (one device "
          f"{total / w_dt:.1f}); bottleneck launches by card {by_dev} "
          f"(want {want}) {'ok' if good else 'FAIL'}")
    ok &= good
    for i, n in enumerate(lengths):
        if n < SEQ:
            ok &= corpus[i][1].shape == (0, CLASSES)
            continue
        ok &= probs_close(f"SP run_corpus vs one device, video {i}",
                          corpus[i][1], w_corpus[i][1])
        ok &= argmax_agrees(f"SP run_corpus vs one device, video {i}",
                            corpus[i][0], w_corpus[i][0], w_corpus[i][1],
                            min_decided=1)
    del engines, videos
    torch.cuda.empty_cache()
    return counts, numbers, ok


def sp_devices(torch, shards=MESH_SHARDS):
    """The SP pass's devices: one card a shard where the host has them,
    else card 0 for every shard."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i if n >= shards else 0)
            for i in range(shards)]


def run_mesh_slice(torch, seed, card, kept, refs=None):
    """Phase 4o: the mesh slice, over 4g's directory: (a) a 1 x 2 grid's
    train steps (`multi_train` with a model axis of 2; the one-process tmr
    steps those of 4k (b) where `refs` holds them), whose ranks then run
    (b)'s command, checked by `mesh_workflow`, (c) `mesh_sp`. Returns
    (counts by path, numbers, ok)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    numbers = {}
    with phase_dir("mesh") as tmp:
        train_counts, numbers["steps"], ok = multi_train(
            torch, seed, card, tmp, world=MESH_MP, mp=MESH_MP,
            cli_argv=workflow_argv(kept["train"], tmp), refs=refs)
        flow_counts, numbers["workflow_s"], ok_b = mesh_workflow(
            torch, card, kept["train"], tmp, numbers["steps"])
    sp_counts, numbers["sp"], ok_c = mesh_sp(torch, seed, card,
                                             sp_devices(torch))
    ok &= ok_b and ok_c
    counts = add_counts(train_counts, flow_counts, sp_counts)
    good = all(counts.get(k, 0) > 0 for k in (
        "time_conv", "nl_attention", "fused_bottleneck",
        "fused_bottleneck_tiled"))
    numbers["seconds"] = time.perf_counter() - t0
    print(f"mesh slice: launches over every rank and card {counts}, "
          f"{numbers['seconds']:.1f} s on {card} "
          f"{'ok' if ok and good else 'FAIL'}")
    return {"mesh": counts}, numbers, ok and good


# Phase 4p: the shards of one process (`devices=`). (c)'s streams and
# steps, with 4d's inactive stream and reset stream at steps that a run of
# SHARD_STEPS holds; (d)'s rows, batch and Adam steps of HeadOnly at the
# multi-scale task's window; the per-shard launches of a clip forward on
# each fused path.
SHARD_STEPS, SHARD_INACTIVE, SHARD_RESET = 24, (3, range(10, 13)), (5, 15)
HEAD_ROWS, HEAD_BATCH, HEAD_STEPS, HEAD_WINDOW = 512, 128, 20, 40
SHARD_FORWARD = {
    "block": {"fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1},
    "tiled": {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2,
              "time_conv": 1, "nl_attention": 1}}


def by_card():
    """The launches since the last reset by (kernel, card), as
    "kernel@cuda:i"."""
    from tmrnet_torch.kernels.build import LAUNCHES_BY_DEVICE

    return {f"{k}@cuda:{d}": v for (k, d), v in LAUNCHES_BY_DEVICE.items()}


def per_card(devices, per_shard, times=1):
    """The launches by card of `times` calls that run `per_shard` on each
    of `devices` (a repeated card adds up)."""
    want = {}
    for d in devices:
        for k, v in per_shard.items():
            key = f"{k}@cuda:{d.index}"
            want[key] = want.get(key, 0) + v * times
    return want


def sync_all(torch, devices):
    for d in set(devices):
        torch.cuda.synchronize(d)


def shard_clip(torch, seed, card, devices):
    """Phase 4p (a): ClipInference(devices=) on phase 4's requests on the
    block and the tiled path against the one-device engine in this call
    (within TOL, 4's argmax rule), the launches by card (each shard's
    forward on its card), clips/s of both engines after a warm-up request
    (the mean of two timed passes each, in the order one device, shards,
    shards, one device). Returns (launches by kernel, numbers, ok)."""
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    setup = slice_setup(torch, seed)
    ecfg, state, bank = setup["ecfg"], setup["state"], setup["bank"]
    firsts, requests = setup["first_rows"], setup["requests"]
    ok, counts, numbers = True, {}, {}
    for kernel, per_shard in SHARD_FORWARD.items():
        engines = [ClipInference(ecfg, state, bank, fused_kernel=kernel),
                   ClipInference(ecfg, state, bank, fused_kernel=kernel,
                                 devices=devices)]
        for e in engines:
            e.run_batches(requests[:1], firsts)     # warm-up, not counted
        res, rates = [None, None], [[], []]
        for i in (0, 1, 1, 0):
            sync_all(torch, devices)
            reset_launches()
            t0 = time.perf_counter()
            res[i] = engines[i].run_batches(requests[1:], firsts)
            sync_all(torch, devices)
            rates[i].append(REQUESTS * CLIPS / (time.perf_counter() - t0))
            if i == 1:
                got, cards = dict(LAUNCHES), by_card()
        passes, rates = rates, [float(np.mean(r)) for r in rates]
        want = per_card(devices, per_shard, REQUESTS)
        good = cards == want
        counts = add_counts(counts, got)
        numbers[kernel] = {"clips_s": rates[1], "one_device_clips_s": rates[0],
                           "passes_clips_s": passes}
        print(f"  (a) {kernel} path over {[str(d) for d in devices]}: "
              f"{rates[1]:.1f} clips/s (one device {rates[0]:.1f}) on "
              f"{card}; launches by card {cards} (want {want}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        ok &= probs_close(f"(a) {kernel} sharded vs one device",
                          res[1].scores, res[0].scores)
        ok &= argmax_agrees(f"(a) {kernel} sharded vs one device",
                            res[1].preds, res[0].preds, res[0].scores,
                            min_decided=1)
        del engines
    del setup, bank
    torch.cuda.empty_cache()
    return counts, numbers, ok


def shard_bank(torch, card, devices, tdir, want_path):
    """Phase 4p (b): build_lfb(engine="clip", devices=) over 4f's manifest
    and extractor `.pth` (folded, data.batch_clips of LFB_BATCH) against
    the clip bank at `want_path` within TOL of max |feature|; 12
    fused_bottleneck a shard of each batch on its card (a batch that does
    not divide, whole on the first). Returns (launches, frames/s, ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.config import ExperimentConfig, apply_override
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.memory.lfb import load_bank
    from tmrnet_torch.train.loop import build_lfb

    src = lambda name: os.path.join(tdir, name)
    with open(src("cfg.json")) as f:
        cfg = apply_override(ExperimentConfig.from_json(f.read()),
                             "model.folded=true")
    state = cli.restore_state(cfg, "lfb", src("lfb.pth"))
    extractor, = cli.folded_weights(cfg, cli.extractor_state(cfg, state))
    ds = cli.dataset(cfg, cli.load_manifest(src("m.pkl")))
    clips = ds.num_clips
    sync_all(torch, devices)
    reset_launches()
    t0 = time.perf_counter()
    bank = build_lfb(cfg, extractor, ds, cache_path=None, force=True,
                     devices=devices)
    sync_all(torch, devices)
    dt = time.perf_counter() - t0
    batches = -(-clips // cfg.data.batch_clips)
    shards = (devices if cfg.data.batch_clips % len(devices) == 0
              else devices[:1])
    want = per_card(shards, {"fused_bottleneck": 12}, batches)
    cards = by_card()
    good = cards == want
    print(f"  (b) build_lfb(engine='clip') over {[str(d) for d in devices]}: "
          f"{clips} clips in {dt:.3f} s = {SEQ * clips / dt:.1f} frames/s on "
          f"{card}; launches by card {cards} (want {want}) "
          f"{'ok' if good else 'FAIL'}")
    ref = load_bank(want_path)
    ok = good and bool(torch.equal(bank.first_rows.cpu(),
                                   ref.first_rows.cpu().to(
                                       bank.first_rows.dtype)))
    ok &= compare(torch, "(b) sharded clip bank vs the one-device build",
                  bank.features, ref.features)[1]
    del bank, ref
    torch.cuda.empty_cache()
    return dict(LAUNCHES), SEQ * clips / dt, ok


def shard_stream(torch, seed, card, devices):
    """Phase 4p (c): StreamingInference(devices=), STREAMS slots in
    len(devices) groups over SHARD_STEPS steps of uint8 224x224 frames,
    4d's inactive stream (frozen bit for bit) and reset stream, against
    the one-device engine step for step (every valid row within TOL, 4's
    argmax rule over them all); each step 24 fused_bottleneck, 1 time_conv
    and 1 nl_attention a group on its card; step p50 / p99 ms of both
    engines after 4 warm-up steps. Returns (launches, numbers, ok)."""
    from tmrnet_torch.eval.stream import StreamingInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    ecfg, weights = engine_setup(seed)
    frames = np.random.default_rng(seed + 4).integers(
        0, 256, (SHARD_STEPS, STREAMS, IMG, IMG, 3), dtype=np.uint8)
    engines = [StreamingInference(ecfg, *weights),
               StreamingInference(ecfg, *weights, devices=devices)]
    states = [e.init_state(STREAMS) for e in engines]
    per_step = {"fused_bottleneck": 24, "time_conv": 1, "nl_attention": 1}
    want_step = per_card(devices, per_step)
    ok, times, got_p, want_p, counts = True, [[], []], [], [], {}
    for t in range(SHARD_STEPS):
        if t == SHARD_RESET[1]:
            mask = np.arange(STREAMS) == SHARD_RESET[0]
            states = [e.reset_streams(s, mask)
                      for e, s in zip(engines, states)]
        active = np.ones(STREAMS, bool)
        if t in SHARD_INACTIVE[1]:
            active[SHARD_INACTIVE[0]] = False
        act = None if active.all() else active
        old = [x[SHARD_INACTIVE[0]].clone() for x in (
            states[1].ext_ring, states[1].tmr_ring, states[1].bank_ring,
            states[1].count)]
        outs = []
        for i, e in enumerate(engines):
            sync_all(torch, devices)
            reset_launches()
            t0 = time.perf_counter()
            states[i], preds, probs, valid = e.step(states[i], frames[t], act)
            probs, valid = probs.cpu().numpy(), valid.cpu().numpy()
            if t >= 4:
                times[i].append(time.perf_counter() - t0)
            outs.append((preds.cpu().numpy(), probs, valid))
            if i == 1:
                good = by_card() == want_step
                counts = add_counts(counts, dict(LAUNCHES))
                if not good:
                    print(f"  (c) step {t}: launches by card {by_card()} "
                          f"(want {want_step}) FAIL")
                ok &= good
        ok &= bool(np.array_equal(outs[0][2], outs[1][2]))
        keep = outs[0][2]
        got_p.append(outs[1][1][keep])
        want_p.append(outs[0][1][keep])
        if act is not None:
            ok &= not outs[1][2][SHARD_INACTIVE[0]] and all(
                bool(torch.equal(x[SHARD_INACTIVE[0]], o)) for x, o in zip(
                    (states[1].ext_ring, states[1].tmr_ring,
                     states[1].bank_ring, states[1].count), old))
    got_p, want_p = np.concatenate(got_p), np.concatenate(want_p)
    ms = [np.array(t) * 1e3 for t in times]
    numbers = {"p50_ms": float(np.percentile(ms[1], 50)),
               "p99_ms": float(np.percentile(ms[1], 99)),
               "one_device_p50_ms": float(np.percentile(ms[0], 50)),
               "one_device_p99_ms": float(np.percentile(ms[0], 99))}
    print(f"  (c) {STREAMS} streams x {SHARD_STEPS} steps in "
          f"{len(devices)} groups over {[str(d) for d in devices]}: step "
          f"p50 {numbers['p50_ms']:.3f} ms, p99 {numbers['p99_ms']:.3f} "
          f"(one device {numbers['one_device_p50_ms']:.3f} / "
          f"{numbers['one_device_p99_ms']:.3f}) on {card}; each step "
          f"{want_step}; inactive slot frozen {'ok' if ok else 'FAIL'}")
    ok &= probs_close(f"(c) {len(got_p)} valid stream rows vs one device",
                      got_p, want_p)
    ok &= argmax_agrees("(c) stream rows vs one device",
                        got_p.argmax(-1), want_p.argmax(-1), want_p,
                        min_decided=1)
    del engines, states, frames
    torch.cuda.empty_cache()
    return counts, numbers, ok


def shard_head(torch, seed, card):
    """Phase 4p (d): experimental/headlevel_multiscale.py's HeadOnly (head
    tmr) at hidden 512, window 40, bf16 on the card over HEAD_ROWS seeded
    rows: the first forward within TOL of the same weights in f32 on the
    CPU (plain versions), then HEAD_STEPS Adam steps of HEAD_BATCH rows
    with finite losses; 1 time_conv and 1 nl_attention a forward. Returns
    (launches, ms a step, ok)."""
    from tmrnet_torch.experimental.headlevel_multiscale import (
        HeadOnly, adam_step, init_head)
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    rng = np.random.default_rng(seed + 12)
    st = rng.standard_normal((HEAD_ROWS, HIDDEN), dtype=np.float32)
    lt = rng.standard_normal((HEAD_ROWS, HEAD_WINDOW, HIDDEN),
                             dtype=np.float32)
    y = rng.integers(0, 2, HEAD_ROWS)
    cpu = init_head(HIDDEN, True, seed, "cpu")
    model = HeadOnly(HIDDEN, True, compute_dtype="bfloat16").cuda()
    model.load_state_dict(cpu.state_dict())
    dev = lambda a: torch.from_numpy(a).cuda()
    st_d, lt_d, y_d = dev(st), dev(lt), dev(y)
    reset_launches()
    with torch.no_grad():
        got = model(st_d[:HEAD_BATCH], lt_d[:HEAD_BATCH]).float().cpu()
        want = cpu(torch.from_numpy(st[:HEAD_BATCH]),
                   torch.from_numpy(lt[:HEAD_BATCH]))
    ok = dict(LAUNCHES) == {"time_conv": 1, "nl_attention": 1}
    ok &= compare(torch, "(d) HeadOnly bf16 card vs f32 CPU logits", got,
                  want)[1]
    step = adam_step(model)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HEAD_STEPS):
        idx = dev(rng.integers(0, HEAD_ROWS, HEAD_BATCH))
        losses.append(step(st_d[idx], lt_d[idx], y_d[idx]))
    losses = torch.stack(losses).cpu().numpy()
    dt = (time.perf_counter() - t0) / HEAD_STEPS
    counts = dict(LAUNCHES)
    want = {"time_conv": 1 + HEAD_STEPS, "nl_attention": 1 + HEAD_STEPS}
    good = counts == want and bool(np.isfinite(losses).all())
    print(f"  (d) HeadOnly {HEAD_STEPS} Adam steps of {HEAD_BATCH} rows: "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, {dt * 1e3:.3f} ms a "
          f"step on {card}; launches {counts} (want {want}) "
          f"{'ok' if good else 'FAIL'}")
    return counts, dt * 1e3, ok and good


def shard_entry(torch, card):
    """Phase 4p (e): `tmrnet_torch.entry.entry()` on the card: fn(*args)
    gives finite logits (2, 7) with 1 time_conv and 1 nl_attention
    (the trunk is not folded). Returns (launches, ms, ok)."""
    from tmrnet_torch.entry import entry
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    fn, args = entry()
    fn(*args)                                   # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits = fn(*args)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    counts = dict(LAUNCHES)
    ok = (counts == {"time_conv": 1, "nl_attention": 1}
          and tuple(logits.shape) == (2, 7)
          and bool(torch.isfinite(logits).all()))
    print(f"  (e) entry(): logits {tuple(logits.shape)} "
          f"{logits.dtype}, {dt:.3f} ms a call on {card}, launches {counts} "
          f"{'ok' if ok else 'FAIL'}")
    del fn, args
    torch.cuda.empty_cache()
    return counts, dt, ok


def run_shard_slice(torch, seed, card, kept):
    """Phase 4p: the shards of one process over `sp_devices` (card 0
    twice on a one-card host): (a) `shard_clip`, (b) `shard_bank` over
    4f's directory, (c) `shard_stream`, (d) `shard_head`, (e)
    `shard_entry`. Returns (counts by path, numbers, ok)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    devices = sp_devices(torch)
    numbers = {"devices": [str(d) for d in devices]}
    c_a, numbers["clip"], ok = shard_clip(torch, seed, card, devices)
    c_b, numbers["bank_frames_s"], ok_b = shard_bank(
        torch, card, devices, kept["test"],
        os.path.join(kept["test"], "bank_clip.npz"))
    c_c, numbers["stream"], ok_c = shard_stream(torch, seed, card, devices)
    c_d, numbers["head_step_ms"], ok_d = shard_head(torch, seed, card)
    c_e, numbers["entry_ms"], ok_e = shard_entry(torch, card)
    ok &= ok_b and ok_c and ok_d and ok_e
    counts = add_counts(c_a, c_b, c_c, c_d, c_e)
    numbers["seconds"] = time.perf_counter() - t0
    print(f"shard slice: {json.dumps(numbers)}; launches {counts} on {card} "
          f"{'ok' if ok else 'FAIL'}")
    return {"shard": counts}, numbers, ok


def shard_commands(card, tdir, tmp, n):
    """`--shard-only` on a host of n >= 2 cards: `test --engine clip` over
    4f's clip bank and `stream --max-streams 4` through
    `tmrnet_torch.cli.main` with --set mesh.data_parallel=n against the
    same commands on one card: the clip engine's softmax within TOL and
    the argmax rule; the stream's rows the same videos, frames and valid
    flags, its predictions held by the argmax rule to the one-card
    stream's, the margins from the one-card clip engine's softmax (the
    rows carry none); each command's seconds. Returns (launches,
    seconds, ok)."""
    src = lambda name: os.path.join(tdir, name)
    common = ["--config", src("cfg.json"), "--set", "model.folded=true",
              "--manifest", src("m.pkl"), "--torch-ckpt", src("tmr.pth"),
              "--extractor-torch-ckpt", src("lfb.pth")]
    mesh = ["--set", f"mesh.data_parallel={n}"]
    ok, counts, seconds, out = True, {}, {}, {}
    for name, extra in (("one", []), ("shards", mesh)):
        o = lambda f: os.path.join(tmp, f"{name}_{f}")
        _, c, seconds[f"test {name}"] = run_cli(
            ["test", *common, "--engine", "clip", "--lfb",
             src("bank_clip.npz"), "--out", o("clip.npz"), *extra])
        _, c2, seconds[f"stream {name}"] = run_cli(
            ["stream", *common, "--max-streams", "4", "--out",
             o("s.jsonl"), *extra])
        counts = add_counts(counts, c, c2)
        with np.load(o("clip.npz")) as z:
            out[name] = (z["preds"], z["scores"])
        with open(o("s.jsonl")) as f:
            out[name + "_rows"] = f.read()
    ok &= probs_close(f"test --engine clip over {n} cards vs one",
                      out["shards"][1], out["one"][1])
    ok &= argmax_agrees(f"test --engine clip over {n} cards vs one",
                        out["shards"][0], out["one"][0], out["one"][1])
    rows = [[json.loads(r) for r in out[k].splitlines()]
            for k in ("one_rows", "shards_rows")]
    key = lambda r: (r["video"], r["frame"], r["valid"])
    same = [key(a) for a in rows[0]] == [key(b) for b in rows[1]]
    print(f"  stream over {n} cards vs one: the same videos, frames and "
          f"valid flags {same}; seconds {json.dumps(seconds)} on {card} "
          f"{'ok' if same else 'FAIL'}")
    from tmrnet_torch.cli import load_manifest, stream_predictions

    manifest = load_manifest(os.path.join(tdir, "m.pkl"))
    preds = [stream_predictions(os.path.join(tmp, f"{name}_s.jsonl"),
                                manifest) for name in ("one", "shards")]
    ok &= same and argmax_agrees(
        f"stream over {n} cards vs one (margins of the clip engine)",
        preds[1], preds[0], out["one"][1])
    return counts, seconds, ok


def shard_only(torch, seed):
    """`--shard-only`: phase 4p (a)-(c) over every visible card (card 0
    twice on a one-card host), (b) over a 4f directory this run writes
    (its one-card clip bank from `build-lfb`), then, over two cards or
    more, `shard_commands`; a JSON line of the numbers, the card's line.
    Returns the exit code."""
    from tmrnet_torch.kernels.build import build_all

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(ROOT_TMP, exist_ok=True)
    build_all()
    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n)] if n >= 2
               else [torch.device("cuda", 0)] * 2)
    numbers = {"devices": [str(d) for d in devices]}
    counts, numbers["clip"], ok = shard_clip(torch, seed, card, devices)
    with phase_dir("shard") as tmp:
        cfg = full_width_config(folded=False)
        paths = write_reference_weights(seed + 1000, tmp, cfg, calibrate=True)
        write_test_videos(seed, tmp)
        m = os.path.join(tmp, "m.pkl")
        run_cli(["manifest", "--config", paths["config"], "--frames",
                 os.path.join(tmp, "frames"), "--annotations",
                 os.path.join(tmp, "ann"), "--out", m])
        run_cli(["build-lfb", "--config", paths["config"], "--set",
                 "model.folded=true", "--manifest", m, "--torch-ckpt",
                 paths["lfb"], "--engine", "clip", "--out",
                 os.path.join(tmp, "bank_clip.npz")])
        c_b, numbers["bank_frames_s"], ok_b = shard_bank(
            torch, card, devices, tmp, os.path.join(tmp, "bank_clip.npz"))
        c_c, numbers["stream"], ok_c = shard_stream(torch, seed, card,
                                                    devices)
        c_x, ok_x = {}, True
        if n >= 2:
            c_x, numbers["commands_s"], ok_x = shard_commands(
                card, tmp, tmp, n)
    ok &= ok_b and ok_c and ok_x
    counts = add_counts(counts, c_b, c_c, c_x)
    print(json.dumps({"shard_only": len(devices), "launches": counts,
                      "numbers": numbers, "ok": ok}))
    print(card)
    return 0 if ok else 1


# Phase 4l: the calls of each path timed in (a), the host-cost calls of
# each op in (e) (a synchronize every OP_SYNC, outside the timed part),
# and the ticks of the two daemons in (b); the launches of one clip
# artifact call on each fused path.
ARTIFACT_CALLS, OP_CALLS, OP_SYNC, ARTIFACT_TICKS = 10, 1000, 50, 14
CLIP_LAUNCHES = {"fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1}
TILED_LAUNCHES = {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2,
                  "time_conv": 1, "nl_attention": 1}


def p50_ms(torch, fn, calls=ARTIFACT_CALLS):
    """The median of `calls` host-clock times of fn() to a synchronize."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def artifact_clip(torch, seed, card, tmp):
    """Phase 4l (a): the clip step exported at full width on the card
    (ResNet-50 folded, bf16, head tmr, uint8 wire, batch CLIPS, window 30,
    hidden 512), saved and loaded back, against ClipInference's eager
    model on the phase-4 requests and their windows; launches per call;
    the export's seconds, the artifact's bytes, both paths' p50 ms a call;
    then the tiled export, whose call launches #4. Returns (counts by
    path, numbers, the artifact's path, ok)."""
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.eval.saved import (export_inference, load_artifact,
                                         save_artifact)
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    setup = slice_setup(torch, seed)
    ecfg, state, bank = setup["ecfg"], setup["state"], setup["bank"]
    t0 = time.perf_counter()
    program, meta = export_inference(ecfg, state, CLIPS, "cuda")
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, "clip.pt2")
    nbytes = save_artifact(path, program, meta)
    # what the program holds: its constants' bytes by dtype, whether the
    # sources of the prepared copies stayed, and its layout-copy nodes
    held = list(program.constants.items()) + list(program.state_dict.items())
    by_dtype = {}
    for _, t in held:
        key = str(t.dtype).replace("torch.", "")
        by_dtype[key] = by_dtype.get(key, 0) + t.numel() * t.element_size()
    sources = [k for k, _ in held if k in (
        "model.time_conv.conv_k7.weight",
        "model.backbone.layer4_1.conv2.weight")]
    nodes = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    print(f"artifact clip: {len(held)} constants, MB by dtype "
          f"{ {k: round(v / 1e6, 2) for k, v in by_dtype.items()} }, "
          f"prepared copies' sources held {sources}; {len(nodes)} op nodes, "
          f"{sum('permute' in x for x in nodes)} permute, "
          f"{sum('_to_copy' in x or 'aten.to' in x for x in nodes)} casts")
    del program
    t0 = time.perf_counter()
    art = load_artifact(path)
    load_s = time.perf_counter() - t0
    engine = ClipInference(ecfg, state, bank, device="cuda")
    calls = [(torch.from_numpy(clips).cuda(), torch.from_numpy(
        engine.window_rows(rows, setup["first_rows"])).cuda())
        for clips, _, rows, _ in setup["requests"]]
    memory = lambda idx: bank.features[idx].float()
    torch.cuda.synchronize()
    reset_launches()
    got = [art(clips, memory(idx)) for clips, idx in calls]
    torch.cuda.synchronize()
    counts = {"artifact-clip": dict(LAUNCHES)}
    want = {k: v * len(calls) for k, v in CLIP_LAUNCHES.items()}
    ok = counts["artifact-clip"] == want
    print(f"artifact clip: exported in {export_s:.2f} s, {nbytes / 1e6:.1f} "
          f"MB, loaded in {load_s:.2f} s; launches {counts['artifact-clip']} "
          f"over {len(calls)} calls (want {want}) {'ok' if ok else 'FAIL'}")
    eager = [engine.infer(clips, idx) for clips, idx in calls]
    preds = torch.cat([p for p, _ in got]).cpu().numpy()
    probs = torch.cat([p for _, p in got]).cpu().numpy()
    want_preds = torch.cat([p for p, _ in eager]).cpu().numpy()
    want_probs = torch.cat([p for _, p in eager]).cpu().numpy()
    diff = float(np.abs(probs - want_probs).max())
    ok &= probs_close("clip artifact vs ClipInference (eager)", probs,
                      want_probs)
    ok &= argmax_agrees("clip artifact vs ClipInference (eager)", preds,
                        want_preds, want_probs, min_decided=1)
    clips, idx = calls[0]
    numbers = {"export_s": export_s, "bytes": nbytes, "load_s": load_s,
               "max_abs_diff": diff,
               "artifact_ms_p50": p50_ms(torch, lambda: art(clips,
                                                            memory(idx))),
               "eager_ms_p50": p50_ms(torch, lambda: engine.infer(clips,
                                                                  idx))}
    print(f"artifact clip: max |artifact - eager| {diff:.4g} (0 expected), "
          f"p50 a call of {CLIPS} clips: artifact "
          f"{numbers['artifact_ms_p50']:.3f} ms, eager "
          f"{numbers['eager_ms_p50']:.3f} ms on {card}")
    del art, engine
    t0 = time.perf_counter()
    program, _ = export_inference(ecfg, state, CLIPS, "cuda",
                                  fused_kernel="tiled")
    numbers["tiled_export_s"] = time.perf_counter() - t0
    tiled = program.module()
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        _, tiled_probs = tiled(clips, memory(idx))
    torch.cuda.synchronize()
    counts["artifact-tiled"] = dict(LAUNCHES)
    ok_t = counts["artifact-tiled"] == TILED_LAUNCHES
    print(f"artifact tiled: exported in {numbers['tiled_export_s']:.2f} s; "
          f"launches {counts['artifact-tiled']} a call (want "
          f"{TILED_LAUNCHES}) {'ok' if ok_t else 'FAIL'}")
    ok &= ok_t and probs_close("tiled artifact vs the block artifact",
                               tiled_probs.cpu().numpy(), probs[:CLIPS])
    del program, tiled, setup, calls
    torch.cuda.empty_cache()
    return counts, numbers, path, ok


class ReadyClock(io.StringIO):
    """stderr of an in-process `serve`: the seconds from its creation to
    the daemon's {"ready": true} line."""

    def __init__(self):
        super().__init__()
        self.t0, self.ready = time.perf_counter(), None

    def write(self, text):
        if self.ready is None and '"ready": true' in text:
            self.ready = time.perf_counter() - self.t0
        return super().write(text)


def artifact_serve(seed, card, tmp):
    """Phase 4l (b): `python -m tmrnet_torch export-model --stream` as a
    subprocess from phase 4e's reference `.pth` (the same seed) with
    model.folded=true and 4e's slot count, then `serve --artifact` and
    `serve --torch-ckpt` in this process over the same ticks
    (`serve_rows`: streams P and Q for ARTIFACT_TICKS ticks): the rows
    equal, the probabilities within TOL with the argmax rule, the same
    launches (STEP_LAUNCHES a tick and the warm-up's); each daemon's
    seconds from its command's start to ready. Returns (counts by path,
    numbers, ok)."""
    cfg, paths, _ = serve_setup(seed, tmp)
    art = os.path.join(tmp, "stream.pt2")
    cmd = [sys.executable, "-m", "tmrnet_torch", "export-model", "--config",
           paths["config"], "--set", "model.folded=true", "--torch-ckpt",
           paths["tmr"], "--extractor-torch-ckpt", paths["lfb"], "--stream",
           "--slots", str(SERVE_SLOTS), "--out", art]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=TEST_TIMEOUT)
    numbers = {"export_model_s": time.perf_counter() - t0}
    line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    print(f"  export-model --stream (subprocess): exit {out.returncode} in "
          f"{numbers['export_model_s']:.2f} s: {line}")
    if out.returncode != 0:
        print(out.stderr[-4000:])
        return {}, numbers, False
    numbers["stream_bytes"] = json.loads(line)["bytes"]
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for t in range(ARTIFACT_TICKS):
            for sid, v in (("P", 0), ("Q", 1)):
                f.write(json.dumps({"id": sid, "image": os.path.join(
                    tmp, f"v{v}.npy#{t}")}) + "\n")
            f.write(json.dumps({"step": True}) + "\n")
    rows, counts, ok = {}, {}, True
    for name, extra in (("artifact", ["--artifact", art]),
                        ("torch-ckpt", ["--config", paths["config"],
                                        "--torch-ckpt", paths["tmr"],
                                        "--extractor-torch-ckpt",
                                        paths["lfb"], "--slots",
                                        str(SERVE_SLOTS)])):
        with contextlib.redirect_stderr(ReadyClock()) as clock:
            rows[name], counts[f"artifact-serve-{name}"], _ = serve_rows(
                ["serve", *extra, "--input", events, "--probs"])
        numbers[f"{name}_ready_s"] = clock.ready
        ok &= clock.ready is not None
    got, want = rows["artifact"], rows["torch-ckpt"]
    key = lambda r: {k: r.get(k) for k in ("id", "frame", "valid")}
    same = [key(r) for r in got] == [key(r) for r in want]
    ticks = times(ARTIFACT_TICKS + 1, STEP_LAUNCHES)    # and the warm-up
    launched = counts["artifact-serve-artifact"]
    ok &= (same and len(got) == 2 * ARTIFACT_TICKS and launched == ticks
           and counts["artifact-serve-torch-ckpt"] == ticks)
    print(f"artifact serve: {len(got)} rows each, ids/frames/valid equal "
          f"{same}, launches {launched} (torch-ckpt "
          f"{counts['artifact-serve-torch-ckpt']}, want {ticks}); command "
          f"start to ready: serve --artifact {numbers['artifact_ready_s']} "
          f"s, serve --torch-ckpt {numbers['torch-ckpt_ready_s']} s on "
          f"{card}")
    valid = [(g, w) for g, w in zip(got, want) if w["valid"]]
    if ok and valid:
        g_probs = np.array([g["probs"] for g, _ in valid], np.float32)
        w_probs = np.array([w["probs"] for _, w in valid], np.float32)
        numbers["max_abs_diff"] = float(np.abs(g_probs - w_probs).max())
        ok &= probs_close("serve --artifact vs serve --torch-ckpt", g_probs,
                          w_probs)
        ok &= argmax_agrees("serve --artifact vs serve --torch-ckpt",
                            np.array([g["pred"] for g, _ in valid]),
                            np.array([w["pred"] for _, w in valid]), w_probs,
                            min_decided=1)
    return ({"artifact-serve": launched}, numbers,
            ok and bool(valid))


def artifact_stream_cli(torch, card, tmp, test_dir):
    """Phase 4l (c): `export-model --stream --slots SCORE_SLOTS` from phase
    4f's `.pth` (folded), then `stream --artifact` over 4f's packed videos
    against `stream --torch-ckpt --max-streams SCORE_SLOTS`, both through
    `tmrnet_torch.cli.main` here: the same rows, every step's softmax
    within TOL with the argmax rule, the same launches (STEP_LAUNCHES a
    step); both paths' step p50. Returns (counts by path, numbers, ok)."""
    from tmrnet_torch.eval.saved import ArtifactStreamEngine

    src = lambda name: os.path.join(test_dir, name)
    art, outs = os.path.join(tmp, "stream_cli.pt2"), {}
    weights = ["--torch-ckpt", src("tmr.pth"), "--extractor-torch-ckpt",
               src("lfb.pth")]
    common = ["--config", src("cfg.json"), "--set", "model.folded=true"]
    _, counts_export, export_s = run_cli(
        ["export-model", *common, *weights, "--stream", "--slots",
         str(SCORE_SLOTS), "--out", art])
    runs = {}
    for name, cls, extra in (
            ("artifact", ArtifactStreamEngine, ["--artifact", art]),
            ("torch-ckpt", None, [*weights, "--max-streams",
                                  str(SCORE_SLOTS)])):
        outs[name] = os.path.join(tmp, f"stream_{name}.jsonl")
        with StreamCalls(torch, cls) as calls:
            lines, launched, dt = run_cli(["stream", *common, "--manifest",
                                           src("m.pkl"), *extra, "--out",
                                           outs[name]])
        with open(outs[name]) as f:
            rows = [json.loads(line) for line in f]
        runs[name] = (rows, launched, calls, json.loads(lines[-1]))
    rows, launched, calls, summary = runs["artifact"]
    w_rows, w_launched, w_calls, w_summary = runs["torch-ckpt"]
    key = lambda r: (r["video"], r["frame"], r["valid"])
    same = [key(r) for r in rows] == [key(r) for r in w_rows]
    steps_ok = all(c[0] == STEP_LAUNCHES for c in calls.steps)
    ok = (same and launched == w_launched and steps_ok
          and len(calls.steps) == len(w_calls.steps) == summary["steps"]
          and summary["predictions"] == w_summary["predictions"])
    print(f"artifact stream: export-model --stream in {export_s:.2f} s; "
          f"stream --artifact {len(rows)} rows, {len(calls.steps)} steps, "
          f"launches {launched} (torch-ckpt {w_launched}, each step "
          f"{STEP_LAUNCHES}: {steps_ok}), rows' video/frame/valid equal "
          f"{same} {'ok' if ok else 'FAIL'}")
    # every step's softmax, every slot's (a valid row's pred is its argmax)
    probs = np.concatenate([c[2] for c in calls.steps])
    w_probs = np.concatenate([c[2] for c in w_calls.steps])
    ok &= probs_close("stream --artifact vs --torch-ckpt, every step's "
                      "softmax", probs, w_probs)
    ok &= argmax_agrees("stream --artifact vs --torch-ckpt, every step",
                        probs.argmax(-1), w_probs.argmax(-1), w_probs,
                        min_decided=1)
    step_ms = lambda c: float(np.percentile([x[1] for x in c.steps], 50)) * 1e3
    numbers = {"export_s": export_s, "max_abs_diff": float(
        np.abs(probs - w_probs).max()), "artifact_step_ms_p50":
        step_ms(calls), "eager_step_ms_p50": step_ms(w_calls)}
    print(f"artifact stream: step p50 ({SCORE_SLOTS} slots) artifact "
          f"{numbers['artifact_step_ms_p50']:.3f} ms, eager "
          f"{numbers['eager_step_ms_p50']:.3f} ms; max |diff| "
          f"{numbers['max_abs_diff']:.4g} on {card}")
    return ({"artifact-export": counts_export, "artifact-stream": launched},
            numbers, ok)


def artifact_doctor(card, clip_art, test_dir, train_dir):
    """Phase 4l (d): `doctor --smoke --artifact --lfb --checkpoint` through
    `tmrnet_torch.cli.main` here, over (a)'s artifact, 4f's clip bank and
    4g's stage-2 checkpoint: exit 0, no FAIL line."""
    lines, _, dt = run_cli(["doctor", "--smoke", "--artifact", clip_art,
                            "--lfb", os.path.join(test_dir, "bank_clip.npz"),
                            "--checkpoint", os.path.join(train_dir, "ck2")])
    fails = [x for x in lines if x.startswith("[FAIL]")]
    ok = not fails and lines[-1].startswith("doctor: ")
    print(f"artifact doctor: exit 0 in {dt:.2f} s, {len(fails)} FAIL lines "
          f"on {card} {'ok' if ok else 'FAIL'}")
    return ok


def op_costs(torch, seed, card):
    """Phase 4l (e): the host's cost of a call of each op against its
    direct `*_cuda` launch at the stream step's shapes (head B = STREAMS,
    bottlenecks N = STREAMS at stage 1), OP_CALLS calls each in turns (op,
    direct, direct, op), median µs from the call to its return."""
    from tmrnet_torch.experimental.fused_bottleneck import (
        fused_bottleneck, fused_bottleneck_cuda)
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        fused_bottleneck_tiled, fused_bottleneck_tiled_cuda)
    from tmrnet_torch.ops.nl_attention import (nl_attention_cuda,
                                               nl_attention_op)
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_op

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape, dtype=torch.bfloat16: torch.randn(
        *shape, generator=gen, device="cuda").to(dtype)
    f32 = torch.float32
    head = [rand(STREAMS, HIDDEN), rand(STREAMS, WINDOW, HIDDEN),
            rand(STREAMS, WINDOW, HIDDEN)]
    conv = [rand(STREAMS, WINDOW, HIDDEN)] + [
        t for k in (3, 5, 7) for t in (rand(k, HIDDEN, HIDDEN) * 0.02,
                                       rand(HIDDEN, dtype=f32))]
    h, c, p, _ = STAGES[0]
    block = [rand(STREAMS, h, h, c), rand(c, p) * 0.05, rand(p, dtype=f32),
             rand(3, 3, p, p) * 0.05, rand(p, dtype=f32), rand(p, c) * 0.05,
             rand(c, dtype=f32)]
    cases = (("nl_attention", nl_attention_op, nl_attention_cuda, head),
             ("time_conv", time_conv_op, time_conv_cuda, conv),
             ("fused_bottleneck", fused_bottleneck, fused_bottleneck_cuda,
              block),
             ("fused_bottleneck_tiled", fused_bottleneck_tiled,
              fused_bottleneck_tiled_cuda, block))

    def host_us(fn, args):
        times = []
        for i in range(OP_CALLS // 2):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
            if i % OP_SYNC == OP_SYNC - 1:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return times

    numbers = {}
    with torch.inference_mode():
        for name, op, direct, args in cases:
            op(*args), direct(*args)
            t = {"op": [], "direct": []}
            for kind in ("op", "direct", "direct", "op"):
                t[kind] += host_us(op if kind == "op" else direct, args)
            numbers[name] = {k: float(np.median(v)) * 1e6
                             for k, v in t.items()}
            numbers[name]["added_us"] = (numbers[name]["op"]
                                         - numbers[name]["direct"])
            print(f"  {name}: host µs a call, torch.ops.tmrnet "
                  f"{numbers[name]['op']:.2f}, direct *_cuda "
                  f"{numbers[name]['direct']:.2f} (median of {OP_CALLS} "
                  f"each)")
    print(f"op costs: on {card}")
    del head, conv, block
    torch.cuda.empty_cache()
    return numbers


def run_artifact_slice(torch, seed, card, kept):
    """Phase 4l: the deployable artifacts on the card. (a) `artifact_clip`,
    (b) `artifact_serve`, (c) `artifact_stream_cli`, (d)
    `artifact_doctor`, (e) `op_costs`. Returns (counts by path, numbers,
    ok)."""
    t0 = time.perf_counter()
    numbers = {}
    with phase_dir("artifact") as tmp:
        counts, numbers["clip"], clip_art, ok = artifact_clip(torch, seed,
                                                              card, tmp)
        serve_counts, numbers["serve"], ok_b = artifact_serve(seed, card,
                                                              tmp)
        counts.update(serve_counts)
        stream_counts, numbers["stream"], ok_c = artifact_stream_cli(
            torch, card, tmp, kept["test"])
        counts.update(stream_counts)
        ok_d = artifact_doctor(card, clip_art, kept["test"], kept["train"])
    numbers["ops_us"] = op_costs(torch, seed, card)
    ok = ok and ok_b and ok_c and ok_d
    numbers["seconds"] = time.perf_counter() - t0
    print(f"artifact slice: {json.dumps(numbers)} in "
          f"{numbers['seconds']:.1f} s on {card} {'ok' if ok else 'FAIL'}")
    return counts, numbers, ok


# Phase 4m, the synth slice: `synth`'s videos a split, frame side and
# seed; the efficacy study's flags (the full width on the card); the
# study's clips a batch (its data.batch_clips) and epochs a stage.
SYNTH_SPLITS = {"train": 2, "val": 1, "test": 1}
SYNTH_HW, SYNTH_SEED, SYNTH_BATCH, SYNTH_EPOCHS = 250, 0, 16, 1
SYNTH_STUDY = ["--full-scale"]
STATS_TOL = 1e-6


def synth_want(torch, lengths):
    """The launches of each command of the study at full width, by the
    rules of 4f and 4g: `train-bank` none (unfolded); the stage-1 `test`
    12 fused_bottleneck a batch of 64 clips (the clip engine, folded);
    `build-lfb` 12 a trunk chunk of each video with a clip (the video
    engine, folded); `train-tmr` 1 time_conv and 1 nl_attention a train
    step (whole batches of SYNTH_BATCH) and a val batch; the tmr `test`
    the corpus engine's. `lengths`: frames of each video by split."""
    from tmrnet_torch.eval.infer import plan_trunk_chunk
    from tmrnet_torch.models.resnet import ResNet

    free, _ = torch.cuda.mem_get_info()
    chunk = plan_trunk_chunk(
        ResNet((3, 4, 6, 3), 64).activation_elements(IMG, IMG), 2,
        free + torch.cuda.memory_reserved() - torch.cuda.memory_allocated())
    clips = {s: sum(max(0, n - SEQ + 1) for n in ns)
             for s, ns in lengths.items()}
    steps = clips["train"] // SYNTH_BATCH
    val_batches = -(-clips["val"] // SYNTH_BATCH)
    test = lengths["test"]
    corpus_chunk = min(4096, sum(test))
    return {
        "train-bank": {},
        "test:stage1": {"fused_bottleneck": 12 * -(-clips["test"]
                                                  // TEST_BATCH)},
        **{f"build-lfb:{s}": {"fused_bottleneck": 12 * sum(
            -(-n // chunk) for n in lengths[s] if n >= SEQ)}
           for s in ("train", "val")},
        "train-tmr": {k: SYNTH_EPOCHS * (steps + val_batches)
                      for k in ("time_conv", "nl_attention")},
        "test:tmr": video_counts(
            -(-sum(test) // corpus_chunk) * -(-corpus_chunk // chunk),
            corpus_head_calls(test), "block"),
    }


@contextlib.contextmanager
def counted_study(torch, study, record):
    """While inside, the study's `run_cli` records each command's
    launches: (command[:head or split], launches) into `record`."""
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    orig = study.run_cli

    def run(argv, device="cuda", clock=None):
        argv = [str(a) for a in argv]
        key = argv[0]
        if key == "test":
            key += ":" + next(a.split("=", 1)[1] for a in argv
                              if a.startswith("model.head="))
        elif key == "build-lfb":
            key += ":" + os.path.basename(
                argv[argv.index("--manifest") + 1])[: -len(".pkl")]
        torch.cuda.synchronize()
        reset_launches()
        out = orig(argv, device, clock)
        torch.cuda.synchronize()
        record.append((key, {k: v for k, v in LAUNCHES.items() if v}))
        return out

    study.run_cli = run
    try:
        yield
    finally:
        study.run_cli = orig


def synth_files(root):
    """{relative path: bytes} of the `.npy` and `.txt` files under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith((".npy", ".txt")):
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def numpy_stats(files, per_image):
    """numpy's own channel mean and std, in [0, 1], of the frames of the
    packed videos `files`: per image averaged, or of all pixels pooled."""
    means, stds, n = [], [], 0
    s, ss = np.zeros(3), np.zeros(3)
    for f in files:
        x = np.load(f)
        x = x.reshape(len(x), -1, 3) / 255.0
        if per_image:
            means.append(x.mean(axis=1))
            stds.append(x.std(axis=1))
        else:
            n += x.shape[0] * x.shape[1]
            s += x.sum(axis=(0, 1))
            ss += (x * x).sum(axis=(0, 1))
    if per_image:
        return (np.concatenate(means).mean(axis=0),
                np.concatenate(stds).mean(axis=0))
    mean = s / n
    return mean, np.sqrt(ss / n - mean * mean)


def synth_host(tmp):
    """4m (a)-(c): `synth`, `manifest --stride 1` a split, `stats` both
    ways and `pack` of the train/val pickle, through `tmrnet_torch.cli.
    main` in this process, against `write_synthetic_dataset` called again,
    numpy's own statistics and synth's files. Returns (lengths by split,
    seconds, ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.data.manifests import (load_pickle_manifest,
                                             save_pickle_manifest)
    from tmrnet_torch.data.synthetic import (frame_only_ceiling,
                                             write_synthetic_dataset)

    seconds, ok = {}, True
    ds = os.path.join(tmp, "ds")
    lines, _, seconds["synth"] = run_cli(
        ["synth", "--out-dir", ds, *[x for s, n in SYNTH_SPLITS.items()
                                      for x in (f"--{s}", str(n))],
         "--hw", str(SYNTH_HW), "--seed", str(SYNTH_SEED)])
    line = json.loads(lines[-1])
    want = {"videos": sum(SYNTH_SPLITS.values()),
            "ambiguous_phases": [1, 3, 4, 6],
            "frame_only_ceiling": round(frame_only_ceiling(7, SEQ,
                                                           (15, 25)), 4)}
    t0 = time.perf_counter()
    write_synthetic_dataset(os.path.join(tmp, "again"), SYNTH_SPLITS,
                            seed=SYNTH_SEED, hw=SYNTH_HW)
    seconds["write again"] = time.perf_counter() - t0
    files = synth_files(ds)
    good = ({k: line[k] for k in want} == want
            and files == synth_files(os.path.join(tmp, "again"))
            and len([f for f in files if f.endswith(".npy")])
            == want["videos"])
    print(f"  (a) synth: {json.dumps({k: line[k] for k in want})} (want "
          f"{json.dumps(want)}), {len(files)} files byte-equal to "
          f"write_synthetic_dataset called again "
          f"{'ok' if good else 'FAIL'}")
    ok &= good

    lengths = {}
    for s in SYNTH_SPLITS:
        run_cli(["manifest", "--frames", f"{ds}/frames-{s}", "--annotations",
                 f"{ds}/annotations", "--stride", "1", "--out",
                 f"{ds}/{s}.pkl"])
        lengths[s] = load_pickle_manifest(f"{ds}/{s}.pkl")[0].video_lengths
    train_files = sorted(os.path.join(ds, "frames-train", f)
                         for f in os.listdir(os.path.join(ds, "frames-train")))
    for flag, per_image in (("--population", False), (None, True)):
        lines, _, dt = run_cli(["stats", "--manifest", f"{ds}/train.pkl",
                                "--no-resize", *([flag] if flag else [])])
        got = json.loads(lines[-1])
        mean, std = numpy_stats(train_files, per_image)
        err = max(float(np.abs(np.asarray(got["mean"]) - mean).max()),
                  float(np.abs(np.asarray(got["std"]) - std).max()))
        good = (got["frames"] == sum(lengths["train"])
                and err <= STATS_TOL)
        name = "population" if flag else "per image"
        seconds[f"stats {name}"] = dt
        print(f"  (b) stats --no-resize ({name}) over {got['frames']} "
              f"frames against numpy's: max |diff| {err:.3g} (limit "
              f"{STATS_TOL}) {'ok' if good else 'FAIL'}")
        ok &= good

    train, _ = load_pickle_manifest(f"{ds}/train.pkl")
    val, _ = load_pickle_manifest(f"{ds}/val.pkl")
    save_pickle_manifest(f"{ds}/trainval.pkl", train, val)
    _, _, seconds["pack"] = run_cli(
        ["pack", "--manifest", f"{ds}/trainval.pkl", "--out-dir",
         os.path.join(tmp, "packed"), "--manifest-out",
         os.path.join(tmp, "packed.pkl")])
    packed = synth_files(os.path.join(tmp, "packed"))
    orig = {os.path.basename(k): v for k, v in files.items()
            if k.startswith(("frames-train", "frames-val"))}
    got = load_pickle_manifest(os.path.join(tmp, "packed.pkl"))
    good = packed == orig and len(packed) == len(train.videos) + len(
        val.videos)
    for m, src in zip(got, (train, val)):
        good &= ([v.video_id for v in m.videos]
                 == [v.video_id for v in src.videos]
                 and np.array_equal(m.flat_labels(), src.flat_labels())
                 and all(p.startswith(os.path.join(tmp, "packed"))
                         for p in m.flat_paths()))
    print(f"  (c) pack of the train/val pickle: {len(packed)} .npy files "
          f"byte-equal to synth's, the same ids, labels and splits "
          f"{'ok' if good else 'FAIL'}")
    return lengths, seconds, ok and good


def synth_study(torch, work, lengths):
    """4m (d): the efficacy study in this process over (a)'s data (its
    manifests found, so it writes none), one epoch a stage, head tmr:
    each command's launches against `synth_want`, JAX's row keys, finite
    losses, accuracies in [0, 1] and each arm's protocol table. Returns
    (launches summed, each command's launches, seconds, ok)."""
    from tmrnet_torch.experimental import efficacy_study as study

    want = synth_want(torch, lengths)
    record = []
    argv = ["--work", work, *SYNTH_STUDY, "--seeds", "0",
            "--epochs1", str(SYNTH_EPOCHS), "--epochs2", str(SYNTH_EPOCHS),
            "--heads", "tmr", *[x for s, n in SYNTH_SPLITS.items()
                                for x in (f"--{s}-videos", str(n))]]
    out = io.StringIO()
    t0 = time.perf_counter()
    with counted_study(torch, study, record), contextlib.redirect_stdout(out):
        rc = study.main(argv)
    dt = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"    {line}")
    head = json.loads(lines[0])["study"]
    rows = [json.loads(x) for x in lines[1:3]]
    clock = json.loads(lines[3])["seconds"]
    keys = {"arm", "seed", "clip_accuracy", "protocol_accuracy",
            "protocol_jaccard"}
    good = (rc == 0 and [r["arm"] for r in rows] == ["stage1", "tmr"]
            and all(set(r) == keys and 0 <= r["clip_accuracy"] <= 1
                    and 0 <= r["protocol_accuracy"] <= 100
                    and 0 <= r["protocol_jaccard"] <= 100 for r in rows))
    for arm, ck in (("stage1", "ckpt-stage1-s0"), ("tmr", "ckpt-tmr-s0")):
        with open(os.path.join(work, ck, "best.json")) as f:
            best = json.load(f)["metrics"]
        with open(os.path.join(work, f"protocol-{arm}-s0.json")) as f:
            rep = json.load(f)
        good &= (np.isfinite(best["val_loss"]) and 0 <= best["val_acc"] <= 1
                 and len(rep["jaccard_per_phase"]) == CLASSES
                 and rep["mean_accuracy"] == [r for r in rows if r["arm"]
                                              == arm][0]["protocol_accuracy"])
        print(f"  (d) {arm}: val_loss {best['val_loss']:.6g}, val_acc "
              f"{best['val_acc']:.4f}, protocol accuracy "
              f"{rep['mean_accuracy']:.2f} / Jaccard {rep['mean_jaccard']:.2f}"
              f" over {rep['videos']}")
    print(f"  (d) the study ({json.dumps(head)}): rows with JAX's keys, "
          f"accuracies in [0, 1], finite losses, protocol tables "
          f"{'ok' if good else 'FAIL'} in {dt:.1f} s")
    counts, total = {}, {}
    for key, got in record:
        counts.setdefault(key, {})
        for k, v in got.items():
            counts[key][k] = counts[key].get(k, 0) + v
            total[k] = total.get(k, 0) + v
    for key, w in want.items():
        g = counts.get(key, {})
        print(f"  {key}: launches {g} (want {w}) "
              f"{'ok' if g == w else 'FAIL'}")
        good &= g == w
    rest = {k: v for k, v in counts.items() if k not in want and v}
    if rest:
        print(f"  launches outside the study's model commands {rest} FAIL")
        good = False
    return total, counts, clock, good


def run_synth_slice(torch, seed, card):
    """Phase 4m: synthetic data and the learning-efficacy study at full
    width. (a)-(c) `synth_host`, (d) `synth_study`. Returns (counts by
    path, numbers, ok)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    numbers = {}
    with phase_dir("synth") as tmp:
        lengths, numbers["host_s"], ok = synth_host(tmp)
        total, numbers["launches"], numbers["study_s"], ok_d = synth_study(
            torch, os.path.join(tmp, "ds"), lengths)
    numbers["seconds"] = time.perf_counter() - t0
    good = all(total.get(k, 0) > 0 for k in ("fused_bottleneck", "time_conv",
                                             "nl_attention"))
    print(f"synth slice: {json.dumps(numbers)} ({sum(map(len, lengths.values()))} "
          f"videos of {lengths} frames) on {card} "
          f"{'ok' if ok and ok_d and good else 'FAIL'}")
    torch.cuda.empty_cache()
    return {"synth": total}, numbers, ok and ok_d and good


# Phase 4n, the reference command lines and video-direct datasets: one
# reference command a script that `migrate` knows (a), how long each
# `python -m tmrnet_torch migrate` may take; the two training commands
# (b) translates and runs; the bank rows (c) holds against the CPU.
MIGRATE_CASES = (
    "python train_singlenet_phase_1fc.py -t 160 -e 1 --sgdadjust 0",
    "python train_memorybank.py --csv_train tr.csv --csv_valid va.csv "
    "--train_bs 100 --epochs 5",
    "python test-new-ds.py --mount_point /videos -t 90",
    "python train_non-local_mutiConv_resnet.py -t 160 -e 1 --LFB_l 30",
    "python train_non-local_mutiConv_resnest.py --LFB_l 40 -g 1",
    "python train_only_non-local_pretrained.py --LFB_l 40",
    "python test-resnet.py --mount_point /videos -t 90",
    "python test_singlenet_phase_non-local_pretrained_2fc_copy.py -n m.pth "
    "-t 1600 -c 3",
    "python test_singlenet_phase_non-local_pretrained_2fc_copy_mutiConv6_3"
    ".py --csv t.csv --model m.pth --lfb_model lfb.pth",
    "python test_singlenet_phase_non-local_pretrained_2fc_copy_mutiConv6"
    "_resnest.py -n r.pth",
    "python export_phase_copy.py -n preds.pkl",
    "python update_get_paths_labels.py --data /d --test_label t.pkl",
    "python get_paths_labels.py",
    "python meanStd.py",
    "python video2frame_cutmargin.py",
    "octave Main.m",
    "octave Main_m2cai.m",
)
STAGE1_REF, STAGE2_REF = MIGRATE_CASES[0], MIGRATE_CASES[3]
MIGRATE_TIMEOUT, VIDEO_ROWS = 120, 8
# (c)'s learning rates a stage and gradient clip: docs/QUALITY.md's
# full-scale recipe (the losses are sums over the batch; at 0.01 the
# second stage's loss went to NaN on the card).
VIDEO_LR1, VIDEO_LR2, VIDEO_CLIP = 0.003, 0.001, 5.0
# Arguments appended to every command of (b) that takes them (a CPU
# rehearsal adds --device cpu and a tiny model here).
REF_EXTRA = []


def migrate_card():
    """4n (a): `python -m tmrnet_torch migrate --cmd '...'` for each of
    MIGRATE_CASES, as subprocesses started together: each exits 0 and
    every command it prints parses through the port's parser with
    resolvable --set keys. Returns (commands parsed, ok)."""
    import importlib.util
    import shlex

    from tmrnet_torch import cli

    procs = [subprocess.Popen(
        [sys.executable, "-m", "tmrnet_torch", "migrate", "--cmd", case],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for case in MIGRATE_CASES]
    ok, parsed = True, 0
    try:
        for case, p in zip(MIGRATE_CASES, procs):
            out, err = p.communicate(timeout=MIGRATE_TIMEOUT)
            cmds = [x for x in out.splitlines() if x and not x.startswith("#")]
            good = p.returncode == 0 and bool(cmds)
            for cmd in cmds:
                tokens = shlex.split(cmd)
                try:
                    args = cli.build_parser().parse_args(tokens[3:])
                    if (getattr(args, "set", None)
                            or getattr(args, "preset", None)):
                        cli.load_config(args)
                    good &= tokens[:3] == ["python", "-m", "tmrnet_torch"]
                    parsed += 1
                except (Exception, SystemExit) as e:
                    print(f"    {cmd}: {e!r}")
                    good = False
            if not good:
                print(f"  (a) migrate --cmd {case!r}: rc {p.returncode} "
                      f"{err.strip()[-300:]} FAIL")
            ok &= good
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    jax_here = importlib.util.find_spec("jax") is not None
    print(f"  (a) migrate over {len(MIGRATE_CASES)} reference scripts as "
          f"subprocesses: {parsed} commands parsed by the port's parser "
          f"with their --set keys resolved (JAX importable here: "
          f"{jax_here}) {'ok' if ok else 'FAIL'}")
    return parsed, ok


def reference_workflow(torch, tmp):
    """4n (b): `synth` at 4m's sizes, `manifest` a split, then the port's
    translation of STAGE1_REF (train-bank) and STAGE2_REF (build-lfb,
    train-tmr) run through `tmrnet_torch.cli.main` in this process, the
    placeholders replaced by synth's train/val pickle, the stage-1
    checkpoint and the bank, with data.use_flip=false and, on build-lfb,
    model.folded=true; outputs under `tmp`. Launches by 4m's rules
    (`synth_want`). Returns (lengths by split, launches by command,
    seconds by command, ok)."""
    import shlex

    from tmrnet_torch.data.manifests import (load_pickle_manifest,
                                             save_pickle_manifest)
    from tmrnet_torch.migrate import STAGE1_CKPT, translate

    ds = os.path.join(tmp, "ds")
    out = lambda name: os.path.join(tmp, name)
    seconds, counts = {}, {}
    _, _, seconds["synth"] = run_cli(
        ["synth", "--out-dir", ds, *[x for s, n in SYNTH_SPLITS.items()
                                      for x in (f"--{s}", str(n))],
         "--hw", str(SYNTH_HW), "--seed", str(SYNTH_SEED)])
    lengths, splits = {}, {}
    for s in SYNTH_SPLITS:
        run_cli(["manifest", "--frames", f"{ds}/frames-{s}", "--annotations",
                 f"{ds}/annotations", "--stride", "1", "--out",
                 f"{ds}/{s}.pkl"])
        splits[s] = load_pickle_manifest(f"{ds}/{s}.pkl")[0]
        lengths[s] = splits[s].video_lengths
    save_pickle_manifest(out("trainval.pkl"), splits["train"], splits["val"])
    subs = {"train_val_paths_labels.pkl": out("trainval.pkl"),
            STAGE1_CKPT: out("ck1"), "./LFB/lfb.npz": out("bank.npz")}
    cmds = (translate(shlex.split(STAGE1_REF))["commands"]
            + translate(shlex.split(STAGE2_REF))["commands"])
    ok = [shlex.split(c)[3] for c in cmds] == ["train-bank", "build-lfb",
                                               "train-tmr"]
    for i, cmd in enumerate(cmds):
        argv = [subs.get(t, t) for t in shlex.split(cmd)[3:]]
        name = argv[0]
        argv += ["--set", "data.use_flip=false", *REF_EXTRA]
        if name == "build-lfb":
            argv += ["--set", "model.folded=true"]
        else:
            argv += ["--set", f"train.checkpoint_dir={out(f'ck{i + 1}')}",
                     "--log-dir", out(f"log{i + 1}")]
        print(f"  (b) {' '.join(shlex.quote(a) for a in argv)}")
        lines, counts[name], seconds[name] = run_cli(argv)
        if name != "build-lfb":
            with open(out(f"ck{i + 1}/best.json")) as f:
                best = json.load(f)["metrics"]
            good = (np.isfinite(best["val_loss"]) and lines
                    and lines[-1].startswith("best epoch"))
            print(f"  (b) {name}: {lines[-1] if lines else ''}, val_loss "
                  f"{best['val_loss']:.6g} {'ok' if good else 'FAIL'}")
            ok &= bool(good)
    full = synth_want(torch, lengths)
    train_clips = sum(max(0, n - SEQ + 1) for n in lengths["train"])
    want = {"train-bank": {}, "build-lfb": full["build-lfb:train"],
            "train-tmr": {k: SYNTH_EPOCHS * (train_clips // SYNTH_BATCH)
                          for k in ("time_conv", "nl_attention")}}
    for name, w in want.items():
        g = {k: v for k, v in counts.get(name, {}).items() if v}
        print(f"  (b) {name}: launches {g} (want {w}) "
              f"{'ok' if g == w else 'FAIL'}")
        ok &= g == w
    return lengths, counts, seconds, ok


def frame_reader_class():
    """A `VideoClipReader` that serves videos held in memory (the card's
    machine has no decoder): each clip the frames a decoder would give,
    centre-cropped to `side` where given."""
    from tmrnet_torch.data.video import VideoClipReader

    class FrameReader(VideoClipReader):
        def __init__(self, videos, seq_len, side=None):
            super().__init__([f"memory:{i}" for i in range(len(videos))],
                             [len(v) for v in videos], seq_len, stride=1,
                             error_policy="raise")
            self.videos, self.side = videos, side

        def read_clip(self, clip_index):
            v, start = self.locate(clip_index)
            clip = self.videos[v][start:start + self.seq_len]
            if self.side:
                h, w = clip.shape[1:3]
                y, x = (h - self.side) // 2, (w - self.side) // 2
                clip = clip[:, y:y + self.side, x:x + self.side]
            return np.ascontiguousarray(clip)

    return FrameReader


@contextlib.contextmanager
def without_decoders():
    """While inside, cv2, pyav and imageio fail to import (they already do
    on a host without them)."""
    names = ("cv2", "av", "imageio", "imageio.v3")
    saved = {n: sys.modules.get(n, "absent") for n in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n, m in saved.items():
            if m == "absent":
                del sys.modules[n]
            else:
                sys.modules[n] = m


def decoder_refusals(tmp):
    """4n (c), the refusals: `prepare --pack` and `train-bank --videos`
    through `tmrnet_torch.cli.main` where no decoder imports exit naming
    imageio+pyav and cv2, and write nothing. Returns ok."""
    from tmrnet_torch import cli
    from tmrnet_torch.data.video import available_decoders

    found = available_decoders()
    vids = os.path.join(tmp, "videos")
    os.makedirs(vids)
    open(os.path.join(vids, "video01.mp4"), "wb").close()
    writes = [os.path.join(tmp, n) for n in ("prepared", "ck", "log")]
    ok = True
    for argv in (["prepare", "--videos", vids, "--out", writes[0], "--pack"],
                 ["train-bank", "--videos", vids, "--annotations", vids,
                  "--set", f"train.checkpoint_dir={writes[1]}", "--log-dir",
                  writes[2], *REF_EXTRA]):
        with without_decoders():
            try:
                cli.main(argv)
                msg = "exited 0"
            except SystemExit as e:
                msg = str(e)
        good = ("imageio+pyav" in msg and "cv2" in msg
                and not any(os.path.exists(p) for p in writes))
        print(f"  (c) {argv[0]} without a decoder (decoders here: {found}): "
              f"{msg[:100]!r}..., nothing written {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def video_direct_epochs(torch, tmp, lengths, device="cuda"):
    """4n (c): `VideoClipDataset` over FrameReader (b)'s synth videos:
    `train_stage1` one epoch (VideoTrainTransform: crop scale 1 on 224²
    centre crops where cv2 is missing, so no resize runs), the bank of the
    train and val videos by `build_lfb(engine="clip")` with the folded
    extractor (VideoEvalTransform: 224² centre crops of the 250² frames),
    `train_stage2` one epoch over it; full width, bf16. Checks finite
    losses, the first train batch on the card equal to the host's [0, 1]
    clips cast to bf16, the launches by (b)'s rules, and the bank's first
    VIDEO_ROWS rows within TOL of the same rows built on the CPU in f32.
    Returns (launches summed, seconds by step, ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.config import (DataConfig, ExperimentConfig,
                                     MemoryConfig, TrainConfig)
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.data.manifests import load_pickle_manifest
    from tmrnet_torch.data.packed import split_packed_path
    from tmrnet_torch.data.pipeline import ClipLoader, VideoClipDataset
    from tmrnet_torch.data.transforms import (VideoEvalTransform,
                                              VideoTrainTransform)
    from tmrnet_torch.data.video import available_decoders
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.train.loop import build_lfb, train_stage1, train_stage2

    FrameReader = frame_reader_class()
    videos, labels = {}, {}
    for s in ("train", "val"):
        m = load_pickle_manifest(os.path.join(tmp, "ds", f"{s}.pkl"))[0]
        videos[s] = [np.load(split_packed_path(v.frame_paths[0])[0])
                     for v in m.videos]
        labels[s] = [np.asarray(v.labels, np.int64) for v in m.videos]
    side = videos["train"][0].shape[1]
    resize = "cv2" in available_decoders()
    scale = (0.2, 1.0) if resize else (1.0, 1.0)
    train_ds = {s: VideoClipDataset(
        FrameReader(videos[s], SEQ, None if resize else IMG), labels[s],
        transform=VideoTrainTransform(IMG, scale=scale)) for s in videos}
    eval_ds = {s: VideoClipDataset(FrameReader(videos[s], SEQ), labels[s],
                                   transform=VideoEvalTransform(IMG))
               for s in videos}
    model = train_model_config("stage1", device)
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=SEQ, crop_size=IMG, resize=side,
                        batch_clips=SYNTH_BATCH, device_normalize=True,
                        use_flip=False, num_workers=4),
        model=model, memory=MemoryConfig(window=WINDOW),
        train=TrainConfig(epochs=1, lr=VIDEO_LR1, grad_clip=VIDEO_CLIP,
                          log_every=1000,
                          checkpoint_dir=os.path.join(tmp, "vck1")))
    clips = {s: ds.num_clips for s, ds in train_ds.items()}
    steps, val_batches = (clips["train"] // SYNTH_BATCH,
                          -(-clips["val"] // SYNTH_BATCH))
    want = {"train_stage1": {},
            "build_lfb": {"fused_bottleneck": 12 * sum(
                -(-n // SYNTH_BATCH) for n in clips.values())},
            "train_stage2": {"time_conv": steps + val_batches,
                             "nl_attention": steps + val_batches}}
    counts, seconds, total, ok = {}, {}, {}, True

    def counted(name, fn):
        if device == "cuda":
            torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counts[name] = {k: v for k, v in LAUNCHES.items() if v}
        return out

    first = []
    orig = DevicePrep.__call__

    def recording(self, frames):
        out = orig(self, frames)
        if not first:
            first.append((frames.detach().clone(), out.detach().clone()))
        return out

    DevicePrep.__call__ = recording
    try:
        state, hist1 = counted("train_stage1", lambda: train_stage1(
            cfg, train_ds["train"], eval_ds["val"], device=device))
    finally:
        DevicePrep.__call__ = orig
    host = next(iter(ClipLoader(train_ds["train"], SYNTH_BATCH, shuffle=True,
                                num_workers=1, seed=cfg.train.seed,
                                drop_remainder=True).epoch(0)))[0]
    sent, prepared = first[0]
    want_in = torch.from_numpy(host).to(prepared.device)
    cdt = prepared.dtype
    good = (host.dtype == np.float32 and 0 <= host.min()
            and host.max() <= 1 and torch.equal(sent, want_in)
            and torch.equal(prepared, want_in.to(cdt)))
    print(f"  (c) the first train batch on {prepared.device}: the host's "
          f"{tuple(host.shape)} float32 clips in [{host.min():.3f}, "
          f"{host.max():.3f}] cast to {cdt}, not normalized again "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    sd = state.model.state_dict()
    extractor = cli.extractor_state(cfg, sd)
    del state, sd
    folded = cfg.replace(model=dataclasses.replace(model, head="lfb",
                                                   folded=True))
    ext_folded, = cli.folded_weights(folded, extractor)
    banks = counted("build_lfb", lambda: {s: build_lfb(
        folded, ext_folded, eval_ds[s], force=True, engine="clip",
        cache_path=os.path.join(tmp, f"vbank_{s}.npz"), device=device)
        for s in eval_ds})
    cfg2 = cfg.replace(
        model=dataclasses.replace(model, head="tmr"),
        train=dataclasses.replace(cfg.train, lr=VIDEO_LR2,
                                  checkpoint_dir=os.path.join(tmp, "vck2")))
    init = cli.init_with(cfg2, "tmr", extractor)
    _, hist2 = counted("train_stage2", lambda: train_stage2(
        cfg2, train_ds["train"], banks["train"], eval_ds["val"],
        banks["val"], init_state_dict=init, device=device))
    for name, hist in (("train_stage1", hist1), ("train_stage2", hist2)):
        h = hist[-1]
        good = len(hist) == 1 and all(np.isfinite([h.train_loss,
                                                   h.val_loss]))
        print(f"  (c) {name}: one epoch, train_loss {h.train_loss:.6g}, "
              f"val_loss {h.val_loss:.6g}, val_acc {h.val_acc:.4f} "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    for name, w in want.items():
        g = counts[name]
        print(f"  (c) {name}: launches {g} (want {w}) "
              f"{'ok' if g == w else 'FAIL'}")
        ok &= g == w
        for k, v in g.items():
            total[k] = total.get(k, 0) + v

    # the first VIDEO_ROWS rows of the train bank against the CPU in f32
    n = SEQ + VIDEO_ROWS - 1
    ds8 = VideoClipDataset(FrameReader([videos["train"][0][:n]], SEQ),
                           [labels["train"][0][:n]],
                           transform=VideoEvalTransform(IMG))
    cpu_cfg = cfg.replace(
        model=dataclasses.replace(model, head="lfb", compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, batch_clips=VIDEO_ROWS))
    t0 = time.perf_counter()
    cpu = build_lfb(cpu_cfg, {k: v.float().cpu() for k, v in
                              extractor.items()}, ds8, force=True,
                    engine="clip", device="cpu",
                    cache_path=os.path.join(tmp, "vbank_cpu.npz"))
    seconds["cpu rows"] = time.perf_counter() - t0
    got = banks["train"].features[:VIDEO_ROWS].float().cpu()
    err = float((got - cpu.features).abs().max())
    good = (cpu.num_rows == VIDEO_ROWS and bool(torch.isfinite(got).all())
            and err <= TOL)
    print(f"  (c) the bank's first {VIDEO_ROWS} rows (folded, "
          f"{model.compute_dtype}, on {device}) against the CPU's f32 "
          f"unfolded build: max |diff| {err:.4g} (limit {TOL}) "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    return total, seconds, ok


def run_reference_slice(torch, seed, card, device="cuda"):
    """Phase 4n: the reference command lines and video-direct datasets.
    (a) `migrate_card`, (b) `reference_workflow`, (c) `decoder_refusals`
    and `video_direct_epochs`. Returns (counts by path, numbers, ok)."""
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = {}
    with phase_dir("reference") as tmp:
        t = time.perf_counter()
        numbers["migrate_commands"], ok = migrate_card()
        numbers["migrate_s"] = time.perf_counter() - t
        lengths, counts_b, numbers["commands_s"], ok_b = reference_workflow(
            torch, tmp)
        ok &= ok_b
        ok &= decoder_refusals(tmp)
        counts_c, numbers["video_direct_s"], ok_c = video_direct_epochs(
            torch, tmp, lengths, device)
        ok &= ok_c
    total_b = {}
    for got in counts_b.values():
        for k, v in got.items():
            total_b[k] = total_b.get(k, 0) + v
    numbers["seconds"] = time.perf_counter() - t0
    good = all(total_b.get(k, 0) > 0 and counts_c.get(k, 0) > 0
               for k in ("fused_bottleneck", "time_conv", "nl_attention"))
    print(f"reference slice: {json.dumps(numbers)} ({lengths} frames) on "
          f"{card} {'ok' if ok and good else 'FAIL'}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return ({"reference": total_b, "videodirect": counts_c}, numbers,
            ok and good)


# Phase 4q, the f32 slice: the f32 time_conv kernel's limit (of max
# |plain|: the same f32 products summed in another order), the batches of
# (a) (a train step's 16 rows, the corpus's head call, a head group of 8
# videos of 5,500 clips), its column slice (B and M ranks), and (c)'s
# limit of the card's f32 softmax from the CPU's f32 (cuDNN and oneDNN
# sum the trunk's convolutions in other orders).
F32_REL = 1e-5
F32_BATCHES = (16, 2582, 44000)
F32_SLICE = (2582, 2)
F32_CPU_TOL = 1e-3


def f32_time_conv_args(torch, gen, b):
    """x (b, WINDOW, HIDDEN) and the weights of a layer, f32 on the card."""
    dev = torch.device("cuda")
    x = torch.randn((b, WINDOW, HIDDEN), generator=gen, device=dev)
    ws = []
    for ksz in (3, 5, 7):
        ws += [torch.randn((ksz, HIDDEN, HIDDEN), generator=gen, device=dev)
               * (1.0 / (ksz * HIDDEN)) ** 0.5,
               torch.randn((HIDDEN,), generator=gen, device=dev) * 0.02]
    return x, ws


def check_time_conv_f32(torch, seed, card):
    """Phase 4q (a): csrc/time_conv_f32.cu at W = 30, C = 512 and each B of
    F32_BATCHES, and over the last 512 / M output columns at F32_SLICE,
    against `time_conv_plain` in f32 (TF32 off) within F32_REL of max
    |plain|: the eager ms of the kernel, the plain version and the cuDNN
    chain (three conv1d and the maxes in f32, TF32 off), the FFMA bound
    (operations over 67 TFLOP/s, or bytes: x, the weights and the output
    once), and at B = 16 the card's own time (CUDA-graph replays). The
    record (B = 16) goes on the kernels line; the other B under
    "engine_shapes", the slice under "slices". Returns (record, ok)."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.kernel_timing import graph_ms
    from tmrnet_torch.ops.time_conv import time_conv_cuda, time_conv_plain

    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    c, ok, rows = HIDDEN, True, []
    cut = lambda t, c0, n: (t[..., c0:c0 + n] if t.dim() == 3
                            else t[c0:c0 + n]).contiguous()

    def measure(b, x, ws, c0=0):
        nonlocal ok
        cout = ws[0].shape[2]
        err, good = compare(torch, f"time_conv_f32 B={b}"
                            + (f" ({cout} columns from {c0})" if c0 else ""),
                            time_conv_cuda(x, *ws, c0=c0),
                            time_conv_plain(x, *ws, c0=c0), F32_REL)
        ok &= good
        xt = x.transpose(1, 2)
        xs = xt[:, c0:c0 + cout]
        wt = [(ws[2 * i].permute(2, 1, 0).contiguous(), ws[2 * i + 1])
              for i in range(3)]

        def chain():
            out = torch.maximum(xs, F.pad(xs, (1, 0))[:, :, :-1])
            for (w_, b_), ksz in zip(wt, (3, 5, 7)):
                out = torch.maximum(out, F.conv1d(xt, w_, b_,
                                                  padding=ksz // 2))
            return out.transpose(1, 2)

        m = b * WINDOW
        iters = 3 if b > 10000 else 10
        b_ms, b_by = bound(2 * m * c * cout * 15,
                           4 * (m * c + m * cout + 15 * c * cout + 3 * cout),
                           PEAK_F32)
        row = dict(shape=f"B={b}", max_abs_err=err,
                   ms=time_ms(torch, lambda: time_conv_cuda(x, *ws, c0=c0),
                              iters, 1),
                   plain_ms=time_ms(torch, lambda: time_conv_plain(
                       x, *ws, c0=c0), iters, 1),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=time_ms(torch, chain, iters, 1))
        if b <= 16:
            row["device_ms"] = graph_ms(torch, lambda: time_conv_cuda(x, *ws))
        print(f"    eager {row['ms']:.4f} ms"
              + (f", device {row['device_ms']:.5f} ms" if b <= 16 else "")
              + f", plain {row['plain_ms']:.4f} ms, cuDNN chain "
              f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / row['ms']:.3f} of it)")
        return row

    for b in F32_BATCHES:
        x, ws = f32_time_conv_args(torch, gen, b)
        rows.append(measure(b, x, ws))
        del x, ws
        torch.cuda.empty_cache()
    b, m = F32_SLICE
    x, ws = f32_time_conv_args(torch, gen, b)
    cout = c // m
    sl = [cut(t, c - cout, cout) for t in ws]
    whole = time_conv_cuda(x, *ws)
    parts = [time_conv_cuda(x, *(cut(t, j * cout, cout) for t in ws),
                            c0=j * cout) for j in range(m)]
    same = torch.equal(torch.cat(parts, dim=-1), whole)
    print(f"  time_conv_f32 B={b}: its {m} slices side by side equal the "
          f"whole call bit for bit: {same} {'ok' if same else 'FAIL'}")
    ok &= same
    sliced = dict(measure(b, x, sl, c - cout), model_parallel=m, cout=cout,
                  c0=c - cout)
    del x, ws, sl, whole, parts
    torch.cuda.empty_cache()
    head, *shapes = rows
    rec = dict(name="time_conv_f32", route="cuda",
               source="tmrnet_torch/csrc/time_conv_f32.cu",
               replaces="tmrnet_tpu/ops/time_conv.py:76",
               **{k: v for k, v in head.items() if k != "shape"},
               engine_shapes=shapes, slices=[sliced])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in rows + [sliced])
    print(f"time_conv_f32 vs plain on {card} {'ok' if ok else 'FAIL'}")
    return rec, ok


def f32_tmr_step(torch, seed, card, refs):
    """Phase 4q (b): 4g A's tmr step (its weights and TRAIN_CLIPS clips)
    in f32 on the card against the same step in f32 on the CPU (4g A's,
    kept in `refs`, else run here) by `train/step_check.py`'s f32 limits:
    the loss and the running statistics within STEP_F32_TOL, each delta
    within TENSOR_LIMIT (a bias before a train-mode BatchNorm left to the
    aggregates); one time_conv_f32 and one nl_attention launch. Returns
    (launches, ok)."""
    from tmrnet_torch.models.convert import from_jax_variables, random_variables
    from tmrnet_torch.train.step_check import (TENSOR_LIMIT, aggregate,
                                               distance, rounding_only,
                                               worst_by_group)

    if "tmr_cpu_f32" not in refs:
        weights = from_jax_variables(random_variables(
            train_model_config("tmr", "cpu"), seed + 21))
        batch = train_batch(torch, seed + 20, TRAIN_CLIPS)
        refs["tmr_cpu_f32"] = (weights, batch, one_step(
            torch, "tmr", weights, batch, "cpu"))
    weights, batch, cpu = refs["tmr_cpu_f32"]
    t0 = time.perf_counter()
    g32 = one_step(torch, "tmr", weights, batch, "cuda", "float32")
    dt = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rel = abs(g32[0] - cpu[0]) / abs(cpu[0])
    dist = {k: distance(k, g32[1][k], w) for k, w in cpu[1].items()}
    held = {k: d for k, d in dist.items() if not rounding_only(k)}
    sterr = max(float((g32[2][k] - w).abs().max())
                / max(float(w.abs().max()), 1e-12) for k, w in cpu[2].items())
    want = {"time_conv_f32": 1, "nl_attention": 1}
    ok = (rel <= STEP_F32_TOL and sterr <= STEP_F32_TOL
          and all(d <= TENSOR_LIMIT for d in held.values())
          and g32[3] == want)
    print(f"f32 tmr step ({TRAIN_CLIPS} clips, ResNet-50 224x224, hidden "
          f"{HIDDEN}, window {WINDOW}) on the card vs the CPU: loss "
          f"{g32[0]:.8g} / {cpu[0]:.8g} rel {rel:.3g}, running stats "
          f"{sterr:.4g} (limit {STEP_F32_TOL} each); {len(held)} deltas, "
          f"worst {worst_by_group(held)} (limit {TENSOR_LIMIT} each); "
          f"aggregates {json.dumps(aggregate(g32[1], cpu[1]))}; launches "
          f"{g32[3]} (want {want}); {dt:.1f} s on {card} "
          f"{'ok' if ok else 'FAIL'}")
    return g32[3], ok


def f32_test(torch, seed, card, tdir):
    """Phase 4q (c): `test --engine clip` over 4f's directory (its
    config, `.pth` files, manifest and clip bank) at
    model.compute_dtype=float32, unfolded, through `tmrnet_torch.cli.main`:
    launches (1 time_conv_f32 and 1 nl_attention a batch of TEST_BATCH
    clips, no bottleneck kernel), the softmax within TOL of 4f's bf16 clip
    engine with the argmax rule, and at 8 rows within F32_CPU_TOL of the
    same engine in f32 on the CPU over the same bank; clips/s. Then
    `stream --max-streams SCORE_SLOTS` at f32 over the same videos: the
    slot plan's steps and predictions, 1 time_conv_f32 and 1 nl_attention
    a step; steps/s. Returns (launches, numbers, ok)."""
    from tmrnet_torch import cli
    from tmrnet_torch.config import ExperimentConfig
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.memory.lfb import load_bank

    out = lambda name: os.path.join(tdir, name)
    clips = sum(max(0, n - SEQ + 1) for n in TEST_LENGTHS)
    f32 = ["--set", "model.compute_dtype=float32", "--set",
           "model.folded=false"]
    lines, counts, dt = run_cli(
        ["test", "--config", out("cfg.json"), *f32, "--manifest", out("m.pkl"),
         "--torch-ckpt", out("tmr.pth"), "--extractor-torch-ckpt",
         out("lfb.pth"), "--engine", "clip", "--lfb", out("bank_clip.npz"),
         "--out", out("clip_f32.npz")])
    batches = -(-clips // TEST_BATCH)
    want = {"time_conv_f32": batches, "nl_attention": batches}
    ok = counts == want
    print(f"  test --engine clip at f32: launches {counts} (want {want}) "
          f"{'ok' if ok else 'FAIL'}")
    with np.load(out("clip_f32.npz")) as z:
        scores, preds = z["scores"], z["preds"]
    with np.load(out("clip.npz")) as z:
        bf_scores, bf_preds = z["scores"], z["preds"]
    summary = json.loads(lines[-1])
    labels = cli.clip_labels(cli.load_manifest(out("m.pkl")), SEQ)
    good = (scores.shape == (clips, CLASSES)
            and bool(np.isfinite(scores).all())
            and summary["clip_accuracy"] == float((preds == labels).mean()))
    print(f"  test --engine clip at f32: clip accuracy "
          f"{summary['clip_accuracy']:.4f} (bf16 "
          f"{float((bf_preds == labels).mean()):.4f}) "
          f"{'ok' if good else 'FAIL'}")
    ok &= good and probs_close("test clip f32 vs bf16 softmax", scores,
                               bf_scores)
    ok &= argmax_agrees("test clip f32 vs bf16", preds, bf_preds, bf_scores,
                        min_decided=1)
    with open(out("cfg.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="float32", folded=False))
    state = cli.restore_state(cfg, "tmr", out("tmr.pth"))
    ds = cli.dataset(cfg, cli.load_manifest(out("m.pkl")))
    rows = np.random.default_rng(seed + 41).choice(clips, 8, replace=False)
    batch = np.stack([ds.get_clip(int(r))[0] for r in rows])
    cpu = ClipInference(cfg, state, load_bank(out("bank_clip.npz"),
                                              device="cpu"),
                        device="cpu").run_batches(
        [(batch, labels[rows], rows, 0)], ds.first_rows)
    ok &= probs_close(f"test clip f32 vs the CPU's f32 at rows "
                      f"{sorted(rows.tolist())}", scores[rows], cpu.scores,
                      F32_CPU_TOL)
    ok &= argmax_agrees("test clip f32 vs the CPU's f32", preds[rows],
                        cpu.preds, cpu.scores, F32_CPU_TOL)
    # the stream engine at f32: one time_conv_f32 and one nl_attention a
    # step of the slot plan, none in a slot reset
    steps = len(slot_schedule(TEST_LENGTHS, SCORE_SLOTS))
    lines, streamed, sdt = run_cli(
        ["stream", "--config", out("cfg.json"), *f32, "--manifest",
         out("m.pkl"), "--torch-ckpt", out("tmr.pth"),
         "--extractor-torch-ckpt", out("lfb.pth"), "--max-streams",
         str(SCORE_SLOTS), "--out", out("stream_f32.jsonl")])
    swant = {"time_conv_f32": steps, "nl_attention": steps}
    summary = json.loads(lines[-1])
    good = (streamed == swant and summary["steps"] == steps
            and summary["predictions"] == clips)
    print(f"  stream --max-streams {SCORE_SLOTS} at f32: {summary['steps']} "
          f"steps (want {steps}), {summary['predictions']} predictions "
          f"(want {clips}); launches {streamed} (want {swant}) "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    return (add_counts(counts, streamed),
            {"test_clip_f32_clips_s": clips / dt,
             "stream_f32_steps_s": steps / sdt}, ok)


def run_f32_slice(torch, seed, card, kept, refs, records):
    """Phase 4q: (a) the f32 time_conv kernel, its record appended to
    `records`, (b) the f32 tmr train step, (c) `test --engine clip` at
    f32. Returns (counts by path, numbers, ok); its launches go under path
    "f32"."""
    t0 = time.perf_counter()
    rec, ok = check_time_conv_f32(torch, seed, card)
    records.append(rec)
    step, good = f32_tmr_step(torch, seed, card, refs)
    ok &= good
    test, numbers, good = f32_test(torch, seed, card, kept["test"])
    ok &= good
    print(f"f32 slice: {json.dumps(numbers)} in "
          f"{time.perf_counter() - t0:.1f} s on {card} "
          f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return {"f32": add_counts(step, test)}, numbers, ok


# Phase 4r: the folded f32 trunk. The odd N the kernels are also checked
# at, the frames of the trunk-feature check, and the features' limit (of
# max |feature|) against the unfolded f32 trunk on cuDNN; the launches of
# one folded f32 forward by path.
F32_ODD_N, F32_TRUNK_FRAMES, F32_FEATURE_TOL = 7, 16, 1e-4
F32_FORWARD = {"block": {"fused_bottleneck_f32": 12},
               "tiled": {"fused_bottleneck_tiled_f32": 10,
                         "fused_bottleneck_f32": 2}}


def check_bottleneck_f32(torch, seed, card, records):
    """Phase 4r (a): csrc/fused_bottleneck_f32.cu through
    `fused_bottleneck_cuda` at ResNet-50's four identity stages and
    through `fused_bottleneck_tiled_cuda` at those the tiled path gives it
    (C < 2048), each at N = CLIPS * SEQ and at
    F32_ODD_N, against `fused_bottleneck_plain` in f32 (TF32 off) within
    F32_REL of max |plain|; at N = CLIPS * SEQ the eager ms of each, its
    device ms (CUDA-graph replays), the plain version's and the cuDNN f32
    chain's (TF32 off) eager ms, and the FFMA bound (operations over 67
    TFLOP/s, or bytes: x, the weights and the output once), beside the
    plan's cut over the card's active clusters (`card_clusters`, printed):
    cluster size, CTA tile, span, real-row share and the weights' modelled
    GB from L2. Per-forward numbers weight each stage by
    its identity blocks. Appends the two records to `records`; returns
    (None, ok)."""
    import torch.nn.functional as F

    from tmrnet_torch.experimental.fused_bottleneck import (
        card_clusters, fused_bottleneck_cuda, fused_bottleneck_plain,
        plan_bottleneck_f32)
    from tmrnet_torch.experimental.fused_bottleneck_tiled import (
        fused_bottleneck_tiled_cuda, plan_bottleneck_tiled_f32)
    from tmrnet_torch.experimental.kernel_timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    f32 = lambda shape, s=1.0: torch.randn(shape, generator=gen,
                                           device="cuda") * s
    n, ok = CLIPS * SEQ, True
    kernels = {"block": fused_bottleneck_cuda,
               "tiled": fused_bottleneck_tiled_cuda}
    plans = {"block": plan_bottleneck_f32, "tiled": plan_bottleneck_tiled_f32}
    active = card_clusters(torch.cuda.current_device())
    print(f"    active clusters on the card (size, clusters): {active}")
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "flops", "bytes")
    tot = {k: dict.fromkeys(keys, 0.0) for k in kernels}
    max_err = dict.fromkeys(kernels, 0.0)
    stages = {k: [] for k in kernels}
    for h, cc, p, count in STAGES:
        paths = [k for k in kernels if k == "block" or cc < TILED_MAX_C]
        for frames in (F32_ODD_N, n):
            xs = torch.relu(f32((frames, h, h, cc)))
            w1 = f32((cc, p), (2.0 / cc) ** 0.5)
            w2 = f32((3, 3, p, p), (2.0 / (9 * p)) ** 0.5)
            w3 = f32((p, cc), 0.25 * (2.0 / p) ** 0.5)
            b1, b2, b3 = (f32((s,), 0.05) for s in (p, p, cc))
            args = (xs, w1, b1, w2, b2, w3, b3)
            want = fused_bottleneck_plain(*args)
            for path in paths:
                err, good = compare(
                    torch, f"{kernels[path].__name__[:-5]} f32 N={frames} "
                    f"{h}x{h}x{cc} P={p}", kernels[path](*args), want,
                    F32_REL)
                ok &= good
                max_err[path] = max(max_err[path], err)
            del want
        # the cuDNN chain on the same NHWC data (channels_last views), f32
        xc = xs.permute(0, 3, 1, 2)
        cw1 = w1.t().reshape(p, cc, 1, 1).contiguous(
            memory_format=torch.channels_last)
        cw2 = w2.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cw3 = w3.t().reshape(cc, p, 1, 1).contiguous(
            memory_format=torch.channels_last)

        def chain():
            y = torch.relu(F.conv2d(xc, cw1, b1))
            y = torch.relu(F.conv2d(y, cw2, b2, padding=1))
            return torch.relu(F.conv2d(y, cw3, b3) + xc)

        plain = time_ms(torch, lambda: fused_bottleneck_plain(*args), 2, 1)
        library = time_ms(torch, chain, 3, 1)
        flops = 2.0 * n * h * h * (cc * p + 9 * p * p + p * cc)
        nbytes = 4.0 * (2 * n * h * h * cc + 2 * cc * p + 9 * p * p
                        + 2 * p + cc)
        b_ms = bound(flops, nbytes, PEAK_F32)[0]
        for path in paths:
            ms = time_ms(torch, lambda: kernels[path](*args), 3, 1)
            device = graph_ms(torch, lambda: kernels[path](*args), 3, 2)
            plan = plans[path](n, h, h, cc, p, active)
            cut = dict(cluster=plan.cs, tile=[plan.bm, plan.bn],
                       span=plan.span, nstage=plan.nstage,
                       real_share=plan.real_share,
                       weight_gb=plan.weight_bytes / 1e9, waves=plan.waves)
            print(f"    {path} f32 stage {h}x{h}: kernel {ms:.4f} ms, device "
                  f"{device:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
                  f"{plain:.4f} ms, cuDNN f32 chain {library:.4f} ms (kernel "
                  f"/ cuDNN {ms / library:.3f}), bound {b_ms:.4f} ms "
                  f"({b_ms / ms:.3f} of it), x{count} per forward; cut "
                  f"{json.dumps(cut)}")
            stages[path].append(dict(
                stage=f"{h}x{h}x{cc} P={p}", per_forward=count, ms=ms,
                device_ms=device, tflops=flops / ms / 1e9, plain_ms=plain,
                library_ms=library, bound_ms=b_ms, **cut))
            for key, val in (("ms", ms), ("device_ms", device),
                             ("plain_ms", plain), ("library_ms", library),
                             ("flops", flops), ("bytes", nbytes)):
                tot[path][key] += count * val
        del xs, args, xc
        torch.cuda.empty_cache()
    for path, name, source, replaces in (
            ("block", "fused_bottleneck_f32",
             "tmrnet_torch/csrc/fused_bottleneck_f32.cu",
             "tmrnet_tpu/experimental/fused_bottleneck.py:58"),
            ("tiled", "fused_bottleneck_tiled_f32",
             "tmrnet_torch/csrc/fused_bottleneck_f32.cu",
             "tmrnet_tpu/experimental/fused_bottleneck_tiled.py:123")):
        t = tot[path]
        b_ms, b_by = bound(t["flops"], t["bytes"], PEAK_F32)
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=max_err[path], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
            device_ms=t["device_ms"], stages=stages[path]))
        print(f"  {name}: {t['ms']:.3f} ms a forward (device "
              f"{t['device_ms']:.3f} ms), bound {b_ms:.3f} ms ({b_by}), "
              f"plain {t['plain_ms']:.3f} ms, cuDNN f32 chain "
              f"{t['library_ms']:.3f} ms")
    print(f"f32 bottleneck kernels vs plain on {card} "
          f"{'ok' if ok else 'FAIL'}")
    return None, ok


def f32_clip_forward(torch, seed, card):
    """Phase 4r (b): a full-width TMRNet at model.compute_dtype=float32,
    BN folded, on the card. The trunk alone on F32_TRUNK_FRAMES frames, on
    both fused_kernel paths, against the unfolded f32 trunk on cuDNN (TF32
    off) within F32_FEATURE_TOL of max |feature|; then one clip forward
    (CLIPS clips of SEQ frames, after a warm-up) through ClipInference on
    each path: launches (F32_FORWARD, one time_conv_f32 and one
    nl_attention; no bf16 bottleneck), and the softmax of the first 2
    clips within F32_CPU_TOL of the same engine in f32 on the CPU, with the
    argmax rule. Returns (launches, frames/s by path, ok)."""
    from tmrnet_torch.config import (DataConfig, ExperimentConfig,
                                     MemoryConfig, ModelConfig)
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches
    from tmrnet_torch.memory.lfb import FeatureBank
    from tmrnet_torch.models.convert import (from_jax_variables,
                                             random_variables)
    from tmrnet_torch.models.fold_bn import fold_variables
    from tmrnet_torch.models.tmrnet import build_model

    cfg = ModelConfig(backbone="resnet50", head="tmr", hidden_dim=HIDDEN,
                      num_classes=CLASSES, compute_dtype="float32",
                      folded=True)
    unfolded_cfg = dataclasses.replace(cfg, folded=False)
    raw = scale_logits(from_jax_variables(random_variables(unfolded_cfg,
                                                           seed + 51)))
    state = fold_variables(raw)
    rng = np.random.default_rng(seed + 52)
    frames = torch.from_numpy(rng.standard_normal(
        (F32_TRUNK_FRAMES, IMG, IMG, 3), dtype=np.float32)).cuda()
    ref = build_model(unfolded_cfg, fused_kernel="block")
    ref.load_state_dict(raw, strict=True)
    with torch.no_grad():
        want = ref.backbone(frames)
    del ref
    counts, rates, ok = {}, {}, True
    for path in ("block", "tiled"):
        model = build_model(cfg, fused_kernel=path)
        model.load_state_dict(state, strict=True)
        reset_launches()
        with torch.no_grad():
            got = model.backbone(frames)
        torch.cuda.synchronize()
        trunk = dict(LAUNCHES)
        good = trunk == F32_FORWARD[path] and got.dtype == torch.float32
        print(f"  folded f32 trunk ({path}): {F32_TRUNK_FRAMES} frames, "
              f"launches {trunk} (want {F32_FORWARD[path]}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        ok &= compare(torch, f"folded f32 trunk ({path}) vs unfolded f32 "
                      f"on cuDNN, features", got, want, F32_FEATURE_TOL)[1]
        del model, got
    ecfg = ExperimentConfig(data=DataConfig(device_normalize=True), model=cfg,
                            memory=MemoryConfig(window=WINDOW))
    bank_np = rng.standard_normal((BANK_ROWS, HIDDEN), dtype=np.float32)
    first_rows = np.repeat(np.arange(0, BANK_ROWS, 1024),
                           1024).astype(np.int32)
    bank = FeatureBank(torch.from_numpy(bank_np).cuda(),
                       torch.from_numpy(first_rows).cuda())
    request = (rng.integers(0, 256, (CLIPS, SEQ, IMG, IMG, 3), dtype=np.uint8),
               rng.integers(0, CLASSES, CLIPS),
               rng.integers(0, BANK_ROWS, CLIPS), 0)
    clips, labels, rows, _ = request
    cpu = ClipInference(ecfg, state, FeatureBank(torch.from_numpy(bank_np),
                                                 torch.from_numpy(first_rows)),
                        device="cpu").run_batches(
        [(clips[:2], labels[:2], rows[:2], 0)], first_rows)
    for path in ("block", "tiled"):
        engine = ClipInference(ecfg, state, bank, device="cuda",
                               fused_kernel=path)
        engine.run_batches([request], first_rows)   # warm-up, not counted
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = engine.run_batches([request], first_rows)
        dt = time.perf_counter() - t0
        counts = add_counts(counts, dict(LAUNCHES))
        want = {**F32_FORWARD[path], "time_conv_f32": 1, "nl_attention": 1}
        good = (dict(LAUNCHES) == want
                and res.scores.shape == (CLIPS, CLASSES)
                and bool(np.isfinite(res.scores).all()))
        rates[path] = CLIPS * SEQ / dt
        print(f"  folded f32 clip forward ({path}): {CLIPS * SEQ} frames in "
              f"{dt:.4f} s = {rates[path]:.1f} frames/s; launches "
              f"{dict(LAUNCHES)} (want {want}) {'ok' if good else 'FAIL'}")
        ok &= good
        ok &= probs_close(f"folded f32 clip forward ({path}) vs the CPU's "
                          f"f32 at 2 clips", res.scores[:2], cpu.scores,
                          F32_CPU_TOL)
        ok &= argmax_agrees(f"folded f32 clip forward ({path}) vs the CPU's "
                            f"f32", res.preds[:2], cpu.preds, cpu.scores,
                            F32_CPU_TOL, min_decided=1)
        del engine
    del bank
    torch.cuda.empty_cache()
    return counts, rates, ok


def f32_folded_test(torch, card, tdir):
    """Phase 4r (c): `test --engine clip` over 4f's directory at
    model.compute_dtype=float32 with model.folded=true, through
    `tmrnet_torch.cli.main`: launches (12 fused_bottleneck_f32, one
    time_conv_f32 and one nl_attention a batch of TEST_BATCH clips), and
    the softmax within F32_CPU_TOL of 4q (c)'s unfolded f32 run over the
    same bank, with the argmax rule. Returns (launches, clips/s, ok)."""
    out = lambda name: os.path.join(tdir, name)
    clips = sum(max(0, n - SEQ + 1) for n in TEST_LENGTHS)
    lines, counts, dt = run_cli(
        ["test", "--config", out("cfg.json"), "--set",
         "model.compute_dtype=float32", "--set", "model.folded=true",
         "--manifest", out("m.pkl"), "--torch-ckpt", out("tmr.pth"),
         "--extractor-torch-ckpt", out("lfb.pth"), "--engine", "clip",
         "--lfb", out("bank_clip.npz"), "--out", out("clip_f32_folded.npz")])
    batches = -(-clips // TEST_BATCH)
    want = {"fused_bottleneck_f32": 12 * batches,
            "time_conv_f32": batches, "nl_attention": batches}
    ok = counts == want
    print(f"  test --engine clip at f32, folded: launches {counts} (want "
          f"{want}) {'ok' if ok else 'FAIL'}")
    with np.load(out("clip_f32_folded.npz")) as z:
        scores, preds = z["scores"], z["preds"]
    with np.load(out("clip_f32.npz")) as z:
        f32_scores, f32_preds = z["scores"], z["preds"]
    ok &= scores.shape == (clips, CLASSES) and bool(np.isfinite(scores).all())
    ok &= probs_close("test clip f32 folded vs unfolded softmax", scores,
                      f32_scores, F32_CPU_TOL)
    ok &= argmax_agrees("test clip f32 folded vs unfolded", preds, f32_preds,
                        f32_scores, F32_CPU_TOL, min_decided=1)
    return counts, clips / dt, ok


def run_folded_f32_slice(torch, seed, card, kept, records):
    """Phase 4r: (a) the f32 bottleneck kernels, their records appended to
    `records`, (b) the folded f32 trunk and clip forward on both paths,
    (c) `test --engine clip` at f32, folded. Returns (counts by path,
    numbers, ok); its launches go under path "f32_folded"."""
    t0 = time.perf_counter()
    _, ok = check_bottleneck_f32(torch, seed, card, records)
    forward, rates, good = f32_clip_forward(torch, seed, card)
    ok &= good
    test, clips_s, good = f32_folded_test(torch, card, kept["test"])
    ok &= good
    numbers = {"clip_f32_folded_frames_s": rates,
               "test_clip_f32_folded_clips_s": clips_s}
    print(f"folded f32 slice: {json.dumps(numbers)} in "
          f"{time.perf_counter() - t0:.1f} s on {card} "
          f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return {"f32_folded": add_counts(forward, test)}, numbers, ok


def run_gate(torch, seed, card):
    """Phase 5: the int8 gate at B = 128 over the four stages: the int8
    bottleneck chain through the kernels against the same chain through the
    plain versions (bit for bit), launch counts, and the gate's rows."""
    from tmrnet_torch.experimental import int8_gate
    from tmrnet_torch.kernels.build import LAUNCHES, reset_launches

    dev = torch.device("cuda")
    inputs = [int8_gate.make_inputs(st, GATE_BATCH, dev, seed)
              for st in int8_gate.STAGES]
    reset_launches()
    outs = [int8_gate.bottleneck_int8(*int8_gate.int8_chain_args(d))
            for d in inputs]
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    chains = len(int8_gate.STAGES)
    want = {"int8_matmul": 2 * chains, "int8_conv3x3": chains}
    ok = counts == want
    print(f"gate: launches {counts} over {chains} chains (want {want}) "
          f"{'ok' if ok else 'FAIL'}")
    for st, d, out in zip(int8_gate.STAGES, inputs, outs):
        plain = int8_gate.bottleneck_int8(*int8_gate.int8_chain_args(d),
                                          plain=True)
        same = bool(torch.equal(out, plain))
        nonzero = int(torch.count_nonzero(out))
        print(f"gate: {st[0]} int8 chain kernels vs plain bit-exact {same}, "
              f"{nonzero} of {out.numel()} outputs nonzero "
              f"{'ok' if same and nonzero else 'FAIL'}")
        ok &= same and nonzero > 0
    del inputs, outs
    torch.cuda.empty_cache()
    for st in int8_gate.STAGES:
        row = int8_gate.measure_stage(st, GATE_BATCH, iters=10, seed=seed)
        print("gate row: " + json.dumps(row))
    print(f"gate: on {card}")
    return counts, ok


class Phases:
    """Each phase's ok and seconds, in order, and the seconds since the
    card was found. A phase is a callable whose result ends in its ok; one
    that raises is printed with its traceback, recorded as failed, and
    gives None, and the script goes on (a phase that needs its result
    fails in turn)."""

    def __init__(self):
        self.rows, self.t0 = {}, time.perf_counter()

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            result = fn()
            ok = bool(result[-1])
        except (Exception, SystemExit):
            import traceback

            traceback.print_exc()
            print(f"chip_smoke: phase {name} raised", file=sys.stderr)
            result, ok = None, False
        self.rows[name] = {"ok": ok,
                           "seconds": round(time.perf_counter() - t0, 3)}
        return result

    @property
    def ok(self):
        return all(r["ok"] for r in self.rows.values())

    def failed(self):
        return [n for n, r in self.rows.items() if not r["ok"]]

    def report(self):
        print(json.dumps({"phases": self.rows, "failed": self.failed(),
                          "seconds": round(time.perf_counter() - self.t0,
                                           3)}))


def mesh_only(torch, seed, world, mp, backend):
    """`--mesh-only WORLD MP BACKEND`: phase 4o (a) as a (WORLD / MP) x MP
    grid over BACKEND, one card a rank where the host has them, and (c)
    over 2 cards (card 0 twice on a one-card host) and over 4 where it has
    them; one JSON line of the numbers,
    the card's line. Returns the exit code."""
    from tmrnet_torch.kernels.build import build_all

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(ROOT_TMP, exist_ok=True)
    build_all()
    world, mp = int(world), int(mp)
    with phase_dir("mesh") as tmp:
        counts, numbers, ok = multi_train(torch, seed, card, tmp, world,
                                          backend, mp)
    sp = {}
    for n in (2, 4):
        if n == 2 or torch.cuda.device_count() >= n:
            c, sp[n], good = mesh_sp(torch, seed, card, sp_devices(torch, n))
            counts = add_counts(counts, c)
            ok &= good
    print(json.dumps({"mesh_only": [world, mp, backend], "launches": counts,
                      "numbers": numbers, "sp": sp, "ok": ok}))
    print(card)
    return 0 if ok else 1


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--step-reading", metavar="BACKBONE",
                        help="only print the CPU reading of the bf16 train "
                             "step against the f32 one at full width "
                             "(train/step_check.py::AGG_LIMITS), then exit")
    for flag in ("--multi-rank", "--multi-port"):
        parser.add_argument(flag, type=int, help=argparse.SUPPRESS)
    parser.add_argument("--multi-dir", help=argparse.SUPPRESS)
    parser.add_argument("--multi-world", type=int, default=2,
                        help=argparse.SUPPRESS)
    parser.add_argument("--multi-backend", default="gloo",
                        help=argparse.SUPPRESS)
    parser.add_argument("--multi-mp", type=int, default=1,
                        help=argparse.SUPPRESS)
    parser.add_argument("--multi-cli", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-only", nargs=3,
                        metavar=("WORLD", "MP", "BACKEND"),
                        help="only phase 4o (a) over WORLD ranks as a "
                             "(WORLD / MP) x MP grid, one card a rank where "
                             "there are enough, over BACKEND (nccl or gloo), "
                             "and (c) over 2 cards (card 0 twice on one) "
                             "and 4 where there are, then exit")
    parser.add_argument("--shard-only", action="store_true",
                        help="only phase 4p (a)-(c) over every visible card "
                             "(card 0 twice on one), then `test --engine "
                             "clip` and `stream` under mesh.data_parallel=N "
                             "where there are N >= 2, then exit")
    parser.add_argument("--multi-only", nargs=2, metavar=("WORLD", "BACKEND"),
                        help="only phase 4k (b) over WORLD ranks, one card a "
                             "rank where there are enough, over BACKEND "
                             "(nccl or gloo), then exit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.step_reading:
        step_reading(torch, args.seed, args.step_reading)
        return 0
    if args.multi_rank is not None:     # a rank of phase 4k (b)
        return multi_rank(torch, args.seed, args.multi_rank, args.multi_port,
                          args.multi_dir, args.multi_world,
                          args.multi_backend, args.multi_mp,
                          json.loads(args.multi_cli) if args.multi_cli
                          else None)
    if args.multi_only:
        card = card_line()
        world, backend = int(args.multi_only[0]), args.multi_only[1]
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        os.makedirs(ROOT_TMP, exist_ok=True)
        with phase_dir("multi") as tmp:
            counts, numbers, ok = multi_train(torch, args.seed, card, tmp,
                                              world, backend)
        print(json.dumps({"multi_only": [world, backend], "launches": counts,
                          "numbers": numbers, "ok": ok}))
        print(card)
        return 0 if ok else 1
    if args.mesh_only:
        return mesh_only(torch, args.seed, *args.mesh_only)
    if args.shard_only:
        return shard_only(torch, args.seed)
    from tmrnet_torch.kernels.build import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(f"card: {card}")
    phases = Phases()
    seed = args.seed
    phases.run("2 build", lambda: (build_all(), True))

    print("kernels vs plain versions (bf16 kernel, f32 plain):")

    def kernels():
        records, ok = check_kernels(torch, seed)
        print("kernels vs plain versions at the engines' shapes:")
        ok &= check_engine_shapes(torch, seed, records)
        ok &= check_time_conv_split(torch, seed, records)
        print("time_conv's column slices (tensor parallelism):")
        ok &= check_time_conv_slices(torch, seed, records)
        print("int8 kernels vs plain versions (bit for bit):")
        int8_records, ok8 = check_int8_kernels(torch, seed)
        return records + int8_records, ok and ok8

    checked = phases.run("3 kernels", kernels)
    if not phases.ok:
        phases.report()
        print(f"chip_smoke: failed phases: {', '.join(phases.failed())} (a "
              f"kernel did not build or disagrees with its plain version)",
              file=sys.stderr)
        return 1
    records = checked[0]
    by_path = {}
    setup = phases.run("4 setup", lambda: (slice_setup(torch, seed), True))
    block = phases.run("4 block", lambda: run_slice(
        torch, setup[0], card, "block",
        {"fused_bottleneck": 12, "time_conv": 1, "nl_attention": 1}))
    tiled = phases.run("4b tiled", lambda: run_slice(
        torch, setup[0], card, "tiled",
        {"fused_bottleneck_tiled": 10, "fused_bottleneck": 2, "time_conv": 1,
         "nl_attention": 1}))

    def paths():
        diff = float(np.abs(tiled[2] - block[2]).max())
        ok = bool(diff <= TOL)
        print(f"tiled slice vs block slice: probs max_abs_diff {diff:.4g} "
              f"over {len(tiled[2])} clips (limit {TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        return ok,

    phases.run("4b tiled vs block", paths)
    for name, res in (("block", block), ("tiled", tiled)):
        if res:
            by_path[name] = res[0]
    del setup, block, tiled
    torch.cuda.empty_cache()
    video = phases.run("4c video", lambda: run_video_slice(torch, seed, card))
    if video:
        by_path.update(video[0])
    stream = phases.run("4d stream", lambda: run_stream_slice(
        torch, seed, card, video[1]))
    by_path["stream"] = stream[0] if stream else {}
    del video
    torch.cuda.empty_cache()
    serve = phases.run("4e serve", lambda: run_serve_slice(torch, seed, card))
    by_path["serve"] = serve[0] if serve else {}
    os.makedirs(ROOT_TMP, exist_ok=True)
    # 4k (b)'s one-process steps, for 4o (a); 4g A's CPU f32 tmr step, for
    # 4q (b); 4j (e)'s preemption verdict, run beside 4g D
    refs = {}
    with tempfile.TemporaryDirectory(prefix="kept-", dir=ROOT_TMP) as root:
        kept = {"root": root}       # 4f, 4g and 4h's directories, for 4i, 4k
        for name, fn in (
                ("4f test", lambda: run_test_slice(torch, seed, card, kept)),
                ("4g train", lambda: run_train_slice(torch, seed, card,
                                                     kept, refs)),
                ("4j options", lambda: run_options_slice(
                    torch, seed, card, kept["train"], refs)),
                ("4h resnest", lambda: run_resnest_slice(torch, seed, card,
                                                         kept)),
                ("4i score", lambda: run_score_slice(torch, seed, card,
                                                     kept)),
                ("4k multi", lambda: run_multi_slice(torch, seed, card,
                                                     kept, refs)),
                ("4l artifact", lambda: run_artifact_slice(torch, seed, card,
                                                           kept)),
                ("4o mesh", lambda: run_mesh_slice(torch, seed, card,
                                                   kept, refs)),
                ("4p shard", lambda: run_shard_slice(torch, seed, card,
                                                     kept)),
                ("4q f32", lambda: run_f32_slice(torch, seed, card, kept,
                                                 refs, records)),
                ("4r f32 folded", lambda: run_folded_f32_slice(
                    torch, seed, card, kept, records))):
            res = phases.run(name, fn)
            if res:
                by_path.update(res[0])
    synth = phases.run("4m synth", lambda: run_synth_slice(torch, seed, card))
    if synth:
        by_path.update(synth[0])
    ref = phases.run("4n reference", lambda: run_reference_slice(
        torch, seed, card))
    if ref:
        by_path.update(ref[0])
    gate = phases.run("5 gate", lambda: run_gate(torch, seed, card))
    by_path["gate"] = gate[0] if gate else {}

    def launches():
        ok = True
        for rec in records:
            rec["launches_by_path"] = {p: c[rec["name"]]
                                       for p, c in by_path.items()
                                       if rec["name"] in c}
            rec["launches"] = sum(rec["launches_by_path"].values())
            if rec["launches"] == 0:
                print(f"{rec['name']}: no launch on any path FAIL")
                ok = False
        return ok,

    phases.run("6 launches", launches)
    phases.report()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "stages", "shapes", "engine_shapes",
            "slices")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))
    print(card)
    if not phases.ok:
        print(f"chip_smoke: failed phases: {', '.join(phases.failed())}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
